"""End-to-end prediction → DOA → metrics wrapper (port of ``PredDOA`` and
``predgt2doa_cls`` from ``fnssl_tpu/eval/pred_doa.py``; the IPDnet
``PredDOAMultiTrack`` and ``ipd_baseline`` wait for their ports)."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fnssl_tpu_torch.core.pairs import pair_unbatch
from fnssl_tpu_torch.eval.decode import (
    idl_decode, pd_decode, template_ri, time_pool_ipd)
from fnssl_tpu_torch.eval.metrics import (
    get_metric_multiple, get_metric_single)
from fnssl_tpu_torch.physics.dpipd import DPIPD
from fnssl_tpu_torch.utils.device import resolve_device


class PredDOA:
    """DOA decoding + metrics for the 2-mic FN-SSL model.

    The decode grid is the reference's: the full (res_the × res_phi)
    far-field template cropped to the single ele=π/2 row and the half
    azimuth plane, re-labelled 0..π over 37 points. ``method_mode`` is
    'IDL' (iterative detection & localization) or 'PD' (peak detection).
    ``device=None`` is the first CUDA device.
    """

    def __init__(self, method_mode: str = "IDL",
                 source_num_mode: str = "kNum", max_num_sources: int = 1,
                 res_the: int = 37, res_phi: int = 73, fs: int = 16000,
                 nfft: int = 512, ch_mode: str = "MM",
                 mic_location=((-0.04, 0.0, 0.0), (0.04, 0.0, 0.0)),
                 speed: float = 340.0, device=None):
        if method_mode not in ("IDL", "PD"):
            raise ValueError(f"unknown method_mode {method_mode!r}")
        device = resolve_device(device)
        self.method_mode = method_mode
        self.source_num_mode = source_num_mode
        self.max_num_sources = max_num_sources
        self.fre_used = slice(1, nfft // 2 + 1)
        dpipd = DPIPD(ndoa_candidate=[res_the, res_phi],
                      mic_location=np.asarray(mic_location),
                      nf=nfft // 2 + 1, fre_max=fs / 2, ch_mode=ch_mode,
                      speed=speed)
        tmpl = template_ri(dpipd.template, self.fre_used)
        nele, nazi = tmpl.shape[:2]
        # crop: middle elevation row, half azimuth plane (redefined 0..π)
        self.template = torch.as_tensor(
            tmpl[(nele - 1) // 2: (nele - 1) // 2 + 1, (nazi - 1) // 2:],
            device=device)
        self.ele_candidate = torch.tensor([np.pi / 2], dtype=torch.float32,
                                          device=device)
        self.azi_candidate = torch.as_tensor(np.linspace(0.0, np.pi, 37),
                                             dtype=torch.float32,
                                             device=device)

    def predgt2doa(self, pred_ipd, gt_batch=None, time_pool_size=None):
        """(nb·P, nt, 2nf) model output → pred dict {'doa', 'vad_sources',
        'spatial_spectrum'} (radians), on the decoder's device."""
        p = self.template.shape[-1]
        pred_ipd = torch.as_tensor(pred_ipd).to(self.template.device)
        nb = pred_ipd.shape[0] // p
        ipd = pair_unbatch(pred_ipd, nb).permute(0, 2, 3, 1)  # (nb,nt,2nf,P)
        if time_pool_size:
            ipd = time_pool_ipd(ipd, time_pool_size)
        decode = idl_decode if self.method_mode == "IDL" else pd_decode
        res = decode(ipd, self.template, self.ele_candidate,
                     self.azi_candidate,
                     max_num_sources=self.max_num_sources,
                     source_num_mode=self.source_num_mode)
        pred = {"doa": res.doa, "vad_sources": res.vad,
                "spatial_spectrum": res.spatial_spectrum}
        return pred, gt_batch

    def evaluate(self, pred, gt, ae_mode: Sequence[str] = ("azi",),
                 ae_th: float = 5.0, use_vad: bool = True,
                 vad_th=(2 / 3, 2 / 3), source_mode: str = "single"):
        """Metrics in degrees (Lightning/Module.py:748-773 defaults), on
        the host."""
        doa_gt = np.degrees(_host(gt["doa"]).astype(np.float64))
        doa_est = np.degrees(_host(pred["doa"]).astype(np.float64))
        fn = (get_metric_single if source_mode == "single"
              else get_metric_multiple)
        return fn(doa_gt, _host(gt["vad_sources"]), doa_est,
                  _host(pred["vad_sources"]), ae_mode=ae_mode,
                  ae_th=ae_th, use_vad=use_vad, vad_th=vad_th)

    def __call__(self, pred_batch, gt_batch, **metric_kw):
        pred, gt = self.predgt2doa(pred_batch, gt_batch)
        return self.evaluate(pred, gt, **metric_kw)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def predgt2doa_cls(pred_logits, gt_batch=None):
    """Classification-head decode (Learner.py:489-505): argmax class =
    azimuth in degrees; unit VAD. Returns DOA in *radians* like the
    regression path so ``PredDOA.evaluate`` treats both identically."""
    cls = torch.argmax(torch.as_tensor(pred_logits), dim=-1)   # (nb, nt)
    azi = torch.deg2rad(cls.to(torch.float32))
    ele = torch.full_like(azi, np.pi / 2)
    doa = torch.stack([ele, azi], dim=2)[..., None]           # (nb,nt,2,1)
    vad = torch.ones(cls.shape + (1,), dtype=torch.float32,
                     device=cls.device)
    return {"doa": doa, "vad_sources": vad}, gt_batch
