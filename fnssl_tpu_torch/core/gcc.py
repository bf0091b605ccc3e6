"""GCC-PHAT and the SRP-PHAT map (port of ``fnssl_tpu/core/gcc.py``;
parity: FN-SSL/Module.py:649-742), the classical baselines of the
reference's ``wDNN=False`` path.

The cross-spectrum of all N×N signal pairs is one broadcast complex
product; the SRP map's lag table is built with numpy once and the map is
one gather a pair.
"""
from __future__ import annotations

import numpy as np
import torch


def gcc(x: torch.Tensor, *, tau_max: int | None = None,
        phat: bool = False) -> torch.Tensor:
    """Generalized cross-correlation of N signals.

    Args:
      x: (..., N, K) time-domain frames.
    Returns:
      (..., N, N, 2*tau_max+1) float32 GCC, lags ordered
      [0..tau_max, -tau_max..-1] as in the reference.
    """
    k = x.shape[-1]
    tmax = k // 2 if tau_max is None else tau_max
    xf = torch.fft.rfft(x, dim=-1)
    if phat:
        xf = xf / (xf.abs() + 1e-12)
    # X_n * conj(X_m) for all pairs (n, m): the reference's convention
    cross = xf[..., :, None, :] * torch.conj(xf[..., None, :, :])
    g = torch.fft.irfft(cross, n=k, dim=-1)
    return torch.cat([g[..., :tmax + 1], g[..., -tmax:]],
                     dim=-1).to(torch.float32)


class SRPMap:
    """Steered-response-power map from GCCs over a (theta, phi) grid.

    The per-direction lag table is computed on the host (numpy) once, as
    in the JAX package; a call gathers every pair's lags and sums them.
    """

    def __init__(self, n: int, k: int, res_theta: int, res_phi: int,
                 rn: np.ndarray, fs: float, c: float = 343.0,
                 normalize: bool = True, theta_max: float = np.pi / 2):
        self.n, self.k = n, k
        self.res_theta, self.res_phi = res_theta, res_phi
        self.normalize = normalize

        theta = np.linspace(0, theta_max, res_theta)
        phi = np.linspace(-np.pi, np.pi, res_phi + 1)[:-1]
        r = np.stack([np.outer(np.sin(theta), np.cos(phi)),
                      np.outer(np.sin(theta), np.sin(phi)),
                      np.tile(np.cos(theta), [res_phi, 1]).T], axis=2)
        # IMTDF[i,j,kk,l] = r . (rn[l]-rn[kk]) / c
        diff = rn[None, :, :] - rn[:, None, :]  # (N, N, 3)
        imtdf = np.einsum("ijd,kld->ijkl", r, diff) / c

        tau = np.concatenate(
            [np.arange(0, k // 2 + 1), np.arange(-k // 2 + 1, 0)]) / float(fs)
        tau0 = np.argmin(
            np.abs(imtdf[..., None] - tau[None, None, None, None, :]),
            axis=-1).astype(np.int64)
        tau0[tau0 > k // 2] -= k
        tau0 = tau0.transpose(2, 3, 0, 1)  # (N, N, resTheta, resPhi)
        tau0 = np.where(tau0 < 0, tau0 + (2 * (k // 2) + 1), tau0)
        self._tau0 = torch.as_tensor(tau0)

    def __call__(self, gccs: torch.Tensor) -> torch.Tensor:
        """gccs: (..., N, N, L) → maps (..., resTheta, resPhi)."""
        tau0 = self._tau0.to(gccs.device)
        maps = torch.zeros(gccs.shape[:-3] + (self.res_theta, self.res_phi),
                           dtype=gccs.dtype, device=gccs.device)
        for n in range(self.n):
            for m in range(self.n):
                maps = maps + gccs[..., n, m, :][..., tau0[n, m]]
        if self.normalize:
            mean = maps.mean(dim=(-2, -1), keepdim=True)
            maps = maps - mean + 1e-12
            maps = maps / maps.amax(dim=(-2, -1), keepdim=True)
        return maps
