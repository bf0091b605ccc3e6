"""Training-target assembly (port of ``fnssl_tpu/physics/targets.py``):
vectorised replacements for the reference's python-loop target
plumbing —

  * FN-SSL single-source masking (Lightning/main.py:237-259);
  * IPDnet's Bessel non-source fill, the nb×nt×ns loop at
    runIPDnetOn.py:279-283, as one ``torch.where``;
  * the direct-path VAD (runIPDnetOn.py:224-235);
  * IPDnet2's log-energy VAD of a RealMAN recording (host numpy).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import jn

from fnssl_tpu_torch.core.pairs import pair_indices


def ipd_complex_to_ri(ipd: torch.Tensor, fre_used) -> torch.Tensor:
    """(nb, nt, nf, P, ns) complex → (nb, nt, 2nf_used, P, ns) float32:
    the used bins' real then imaginary parts along the frequency axis."""
    sel = ipd[:, :, fre_used]
    return torch.cat([sel.real, sel.imag], dim=2).float()


def vad_mask_and_sum(ipd_ri: torch.Tensor, vad: torch.Tensor,
                     threshold: float = 0.0) -> torch.Tensor:
    """FN-SSL target: binarise the VAD, gate each source's IPD, sum over
    sources.

    Args:
      ipd_ri: (nb, nt, 2nf, P, ns) real/imag targets.
      vad: (nb, nt, ns) soft VAD.
    Returns:
      (nb, nt, 2nf, P).
    """
    gate = (vad > threshold).to(ipd_ri.dtype)
    return (ipd_ri * gate[:, :, None, None, :]).sum(dim=-1)


def bessel_nonsource_target(mic_pos: np.ndarray, fre_used,
                            nf: int = 257, fre_max: float = 8000.0,
                            speed: float = 340.0, order: int = 0,
                            ch_mode: str = "M") -> np.ndarray:
    """Silent-frame target: spherical diffuse coherence J0(2πf·d/c), on
    the host.

    Parity: IPDnet/runIPDnetOn.py:209-221 (its speed=340 and the zero
    imaginary half included). Pair distances follow ``ch_mode`` ('M':
    from mic 0; 'MM': all pairs).

    Returns:
      (2·nf_used, P) float32.
    """
    mic_pos = np.asarray(mic_pos, np.float64)
    first, second = pair_indices(mic_pos.shape[0], ch_mode)
    dist = np.linalg.norm(mic_pos[second] - mic_pos[first], axis=1)
    omega = 2.0 * np.pi * np.linspace(0.0, fre_max, nf) / speed
    omega = omega[fre_used]
    rows = []
    for d in dist:
        bes = jn(order, omega * d)
        rows.append(np.concatenate([bes, np.zeros_like(bes)]))
    return np.stack(rows, axis=0).T.astype(np.float32)  # (2nf_used, P)


def vad_gate_with_nonsource(ipd_ri: torch.Tensor, vad: torch.Tensor,
                            nonsource: torch.Tensor,
                            threshold: float = 0.001) -> torch.Tensor:
    """IPDnet multi-track target: each track's IPD where its VAD is above
    ``threshold``, the Bessel non-source target elsewhere.

    Args:
      ipd_ri: (nb, nt, 2nf, P, ns); vad: (nb, nt, ns);
      nonsource: (2nf, P).
    Returns:
      (nb, nt, 2nf, P, ns).
    """
    active = (vad > threshold)[:, :, None, None, :]
    return torch.where(active, ipd_ri,
                       nonsource.to(ipd_ri.dtype)[None, None, :, :, None])


def dp_vad(dp_stft: torch.Tensor, mix_stft: torch.Tensor,
           pool: int = 12) -> torch.Tensor:
    """Frame VAD from the direct-path / mixture magnitude ratio at mic 0.

    Args:
      dp_stft: (nb, nf, nt, nch, ns) direct-path STFT per source.
      mix_stft: (nb, nf, nt, nch) mixture STFT.
    Returns:
      (nb, nt//pool, ns) soft VAD, average-pooled 12× like the reference.
    """
    ratio = dp_stft[:, :, :, 0].abs() / mix_stft[:, :, :, 0:1].abs()
    vad = ratio.mean(dim=1)                      # (nb, nt, ns)
    nb, nt, ns = vad.shape
    t2 = nt // pool
    return vad[:, : t2 * pool].reshape(nb, t2, pool, ns).mean(dim=2)


def energy_vad(signal: np.ndarray, fs: int = 16000, win_s: float = 0.1,
               threshold: float = -2.5) -> np.ndarray:
    """Log-FFT-energy VAD over 0.1 s windows (RealMAN recordings).

    Parity: IPDnet2/RecordData.py:41-55. Host-side numpy (data pipeline).
    """
    win = int(fs * win_s)
    nwin = len(signal) // win
    x = signal[: nwin * win].reshape(nwin, win)
    spec = np.fft.fft(x, axis=1)[:, : win // 2]  # reference keeps fft half
    energy = np.log10(np.sum(np.abs(spec) ** 2, axis=1) + 1e-10)
    return (energy >= threshold).astype(np.float32)
