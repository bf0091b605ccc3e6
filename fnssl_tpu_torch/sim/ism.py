"""Image-source room-impulse-response engine (host side, vectorized numpy).

Replaces gpuRIR's CUDA ISM for the data-generation pipeline
(FN-SSL/Dataset.py:141-201). The numpy path is fully vectorized over
(trajectory points × mics × images); a C++/OpenMP drop-in with the same
signature handles production-scale generation (see sim/native).

Geometry: Allen & Berkley images. Per dimension, image index (p, q) with
p∈{0,1}, q∈[-O..O] sits at (1-2p)·s + 2qL with amplitude
β0^|q-p| · β1^|q|. Fractional delays are linearly interpolated.

Port of ``fnssl_tpu/sim/ism.py``, the same numpy code.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve


def _dim_images(order: int):
    """(p, q) grids for one dimension → (n_img,) arrays."""
    q = np.arange(-order, order + 1)
    p = np.array([0, 1])
    pp, qq = np.meshgrid(p, q, indexing="ij")
    return pp.ravel(), qq.ravel()


def simulate_rir(room_sz, beta, src_pos, mic_pos, nb_img, tmax: float,
                 fs: float, c: float = 343.0,
                 prefer_native: bool = True) -> np.ndarray:
    """RIRs from each source position to each mic.

    Dispatches to the C++/OpenMP engine (sim/native) when built —
    identical math, parallel over trajectory points; the vectorized
    numpy path below is the always-available fallback.

    Args:
      room_sz: (3,), beta: (6,) wall reflection coeffs,
      src_pos: (npts, 3), mic_pos: (nch, 3),
      nb_img: per-dim image order (from `t2n`), tmax: RIR length in s.

    Returns:
      (npts, nch, ceil(tmax*fs)) float32.
    """
    if prefer_native:
        from fnssl_tpu_torch.sim import native
        if native.native_available():
            return native.simulate_rir_native(room_sz, beta, src_pos,
                                              mic_pos, nb_img, tmax, fs, c)
    L = np.asarray(room_sz, np.float64)
    beta = np.asarray(beta, np.float64)
    src = np.atleast_2d(np.asarray(src_pos, np.float64))
    mic = np.atleast_2d(np.asarray(mic_pos, np.float64))
    npts, nch = src.shape[0], mic.shape[0]
    nsamp = int(np.ceil(tmax * fs))

    pos_d, amp_d = [], []
    for d in range(3):
        p, q = _dim_images(max(int(nb_img[d]), 0))
        # image coordinate per source: (n_img_d, npts)
        pos = (1 - 2 * p)[:, None] * src[None, :, d] + 2 * q[:, None] * L[d]
        amp = (beta[2 * d] ** np.abs(q - p)) * (beta[2 * d + 1] ** np.abs(q))
        pos_d.append(pos)
        amp_d.append(amp)

    rir = np.zeros((npts, nch, nsamp + 1), np.float64)
    nx, ny, nz = (len(a) for a in amp_d)
    # combine y,z dims into one flattened image table, loop x lightly
    # (keeps peak memory at nx chunks of (ny*nz, npts, nch))
    ay = amp_d[1][:, None] * amp_d[2][None, :]          # (ny, nz)
    py = pos_d[1][:, None, :]                            # (ny, 1, npts)
    pz = pos_d[2][None, :, :]                            # (1, nz, npts)
    for ix in range(nx):
        ax = amp_d[0][ix]
        if ax == 0.0:
            continue  # fully absorbed (e.g. direct-path-only beta=0 runs)
        dx = pos_d[0][ix][None, None, :, None] - mic[None, None, None, :, 0]
        dy = py[:, :, :, None] - mic[None, None, None, :, 1]
        dz = pz[:, :, :, None] - mic[None, None, None, :, 2]
        dist = np.sqrt(dx * dx + dy * dy + dz * dz)      # (ny,nz,npts,nch)
        amp = (ax * ay)[:, :, None, None] / (4.0 * np.pi * dist)
        tsamp = dist * (fs / c)
        i0 = np.floor(tsamp).astype(np.int64)
        w = tsamp - i0
        valid = i0 < nsamp
        i0c = np.where(valid, i0, nsamp - 1)
        flat_idx = np.broadcast_to(
            np.arange(npts)[None, None, :, None] * nch
            + np.arange(nch)[None, None, None, :], dist.shape)
        rirf = rir.reshape(npts * nch, nsamp + 1)
        np.add.at(rirf, (flat_idx[valid], i0c[valid]),
                  (amp * (1 - w))[valid])
        np.add.at(rirf, (flat_idx[valid], i0c[valid] + 1),
                  (amp * w)[valid])
    return rir[:, :, :nsamp].astype(np.float32)


def simulate_trajectory(signal: np.ndarray, rirs: np.ndarray,
                        timestamps: np.ndarray, fs: float) -> np.ndarray:
    """Convolve a signal with a piecewise-constant time-varying RIR.

    gpuRIR.simulateTrajectory semantics: the samples in
    [timestamps[i], timestamps[i+1]) are convolved with rirs[i] and
    overlap-added.

    Args:
      signal: (nsamples,), rirs: (npts, nch, L), timestamps: (npts,) s.
    Returns:
      (nsamples + L - 1, nch) float32.
    """
    nsamples = len(signal)
    npts, nch, lr = rirs.shape
    starts = np.round(np.asarray(timestamps) * fs).astype(np.int64)
    out = np.zeros((nsamples + lr - 1, nch), np.float64)
    for i in range(npts):
        s0 = int(starts[i])
        s1 = int(starts[i + 1]) if i + 1 < npts else nsamples
        if s1 <= s0:
            continue
        seg = signal[s0:s1]
        conv = fftconvolve(seg[None, :], rirs[i], axes=-1)  # (nch, len+L-1)
        out[s0: s0 + conv.shape[-1]] += conv.T
    return out.astype(np.float32)
