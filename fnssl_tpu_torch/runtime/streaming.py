"""Real-time chunked localization runtime (port of
``fnssl_tpu/runtime/streaming.py``).

Every stage carries explicit streaming state —

  sample ring buffer → STFT frames → streaming forgetting-norm →
  model chunk step (LSTM carries) → DOA decode

so chunked output equals the one-shot pipeline. Audio can be pushed in
pieces of any size; the model step fires whenever a full frame-chunk (12
frames for FN-SSL and IPDnet, 5 for IPDnet2) is buffered.

Placement: the front-end runs on the ``device`` the localizer is given,
and the model step on the model's device. Serving passes the CPU for the
front-end (a chain of tiny ops), so the card sees one model step per
chunk and the features go up once per chunk.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from fnssl_tpu_torch.core.norm import forgetting_norm_streaming, init_state
from fnssl_tpu_torch.core.pairs import num_pairs, pair_rebatch
from fnssl_tpu_torch.core.stft import stft
from fnssl_tpu_torch.utils.device import resolve_device


class StreamingLocalizer:
    """Push-based streaming front-end that runs the model step (batch 1).

    Args:
      model_step: fn(feats (1·P, C, nf_used, k)) → output chunk; built by
        ``make_fnssl_stream_step`` or any callable carrying its own state.
      nch: microphone count.
      ch_mode: 'M'/'MM' pair features, or 'none' (all channels).
      frames_per_step: model chunk size (12 for FN-SSL, 5 for IPDnet2).
      center: the STFT convention of IPDnet2 (torch.stft center=True): the
        one-shot reflect pad of nfft//2 at the signal start becomes a
        one-time prefix built from the first nfft//2+1 samples; frames are
        then cut as with center=False. (The one-shot end pad has no live
        counterpart: those tail frames fire once real audio fills them.)
      device: where the front-end runs; None is the first CUDA device.
    """

    def __init__(self, model_step: Callable, nch: int, *,
                 ch_mode: str = "MM", win_len: int = 512, hop: int = 256,
                 nfft: int = 512, sample_length: int = 298,
                 frames_per_step: int = 12, eps: float = 1e-6,
                 center: bool = False, device=None):
        self.model_step = model_step
        self.device = resolve_device(device)
        self.nch = nch
        self.ch_mode = ch_mode
        self.win_len, self.hop, self.nfft = win_len, hop, nfft
        self.sample_length = sample_length
        self.frames_per_step = frames_per_step
        self.eps = eps
        self._need_prefix = bool(center)
        rows = num_pairs(nch, ch_mode) if ch_mode != "none" else 1
        self._norm_state = init_state(rows, self.device)
        self._samples = np.zeros((0, nch), np.float32)
        self._frames = None          # (rows, 2, nf, nt) complex buffer
        self.processed_s = 0.0
        self.compute_s = 0.0

    def _frame_chunk(self) -> torch.Tensor | None:
        """Consume buffered samples into STFT frames (exact one-shot
        framing: frames advance by hop, each sees win_len samples)."""
        if self._need_prefix:
            pad = self.nfft // 2
            if self._samples.shape[0] < pad + 1:
                return None
            prefix = self._samples[pad:0:-1]         # np.pad mode="reflect"
            self._samples = np.concatenate([prefix, self._samples], axis=0)
            self._need_prefix = False
        n = self._samples.shape[0]
        if n < self.win_len:
            return None
        nt = (n - self.win_len) // self.hop + 1
        sig = torch.as_tensor(self._samples[None], device=self.device)
        spec = stft(sig, win_len=self.win_len,
                    win_shift_ratio=self.hop / self.win_len,
                    nfft=self.nfft, center=False)     # (1, nf, nt, nch)
        self._samples = self._samples[nt * self.hop:]
        spec = spec.permute(0, 3, 1, 2)               # (1, nch, nf, nt)
        if self.ch_mode != "none":
            spec = pair_rebatch(spec, ch_mode=self.ch_mode)
        return spec

    def push(self, chunk: np.ndarray) -> list:
        """Feed (nsample, nch) audio; returns the model outputs fired."""
        t0 = time.perf_counter()
        self._samples = np.concatenate(
            [self._samples, np.asarray(chunk, np.float32)], axis=0)
        self.processed_s += chunk.shape[0] / 16000.0
        spec = self._frame_chunk()
        if spec is not None:
            self._frames = (spec if self._frames is None else
                            torch.cat([self._frames, spec], dim=-1))
        outputs = []
        k = self.frames_per_step
        while self._frames is not None and self._frames.shape[-1] >= k:
            frames, self._frames = (self._frames[..., :k],
                                    self._frames[..., k:])
            mean, self._norm_state = forgetting_norm_streaming(
                frames.abs(), self._norm_state,
                sample_length=self.sample_length)
            denom = mean + self.eps
            feats = torch.cat([frames.real / denom, frames.imag / denom],
                              dim=1)
            out = self.model_step(feats[:, :, 1: self.nfft // 2 + 1, :])
            # wait for the device so that rtf counts the real compute time
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            outputs.append(out)
        self.compute_s += time.perf_counter() - t0
        return outputs

    @property
    def rtf(self) -> float:
        """Real-time factor: compute time / audio time (<1 ⇒ real-time)."""
        return self.compute_s / max(self.processed_s, 1e-9)


def make_fnssl_stream_step(model, nf: int = 256):
    """Stateful FN-SSL chunk step for StreamingLocalizer: one ``FNSSL``
    chunk forward on the model's device, carrying the narrow-band LSTM
    states. Features are moved to the model's device once per chunk."""
    from fnssl_tpu_torch.models.fnssl import init_fnssl_state

    state = {"s": None}

    def step(feats: torch.Tensor) -> torch.Tensor:
        feats = feats.to(model.device)
        if state["s"] is None:
            state["s"] = init_fnssl_state(feats.shape[0], nf, model.cfg,
                                          model.device)
        with torch.inference_mode():
            out, state["s"] = model(feats, state=state["s"],
                                    return_state=True)
        return out

    return step


def make_ipdnet_stream_step(model, nf: int = 256):
    """Stateful IPDnet chunk step for StreamingLocalizer: one online
    ``IPDnet`` chunk forward on the model's device, carrying the
    narrow-band LSTM states and the causal-conv tails (chunks of a
    multiple of 12 frames give the one-shot output)."""
    from fnssl_tpu_torch.models.ipdnet import init_ipdnet_state

    state = {"s": None}

    def step(feats: torch.Tensor) -> torch.Tensor:
        feats = feats.to(model.device)
        if state["s"] is None:
            state["s"] = init_ipdnet_state(feats.shape[0], nf, model.cfg,
                                           model.device)
        with torch.inference_mode():
            out, state["s"] = model(feats, state=state["s"],
                                    return_state=True)
        return out

    return step


def make_spatialnet_stream_step(model):
    """Stateful IPDnet2 chunk step for StreamingLocalizer: one
    ``SpatialNet`` chunk forward on the model's device (5 frames, 100 ms
    at hop 320), carrying the encoder's conv tail and both Mamba states of
    every layer (chunks of a multiple of 5 frames give the one-shot
    output)."""
    from fnssl_tpu_torch.models.spatialnet import init_spatialnet_state

    state = {"s": None}

    def step(feats: torch.Tensor) -> torch.Tensor:
        feats = feats.to(model.device)
        if state["s"] is None:
            state["s"] = init_spatialnet_state(feats.shape[0], model.cfg,
                                               model.device)
        with torch.inference_mode():
            out, state["s"] = model(feats, state=state["s"],
                                    return_state=True)
        return out

    return step
