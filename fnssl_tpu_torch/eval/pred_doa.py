"""Model output → DOA (port of ``PredDOA.__init__`` and ``predgt2doa``
from ``fnssl_tpu/eval/pred_doa.py``; ``evaluate`` waits for the metrics
port)."""
from __future__ import annotations

import numpy as np
import torch

from fnssl_tpu_torch.core.pairs import pair_unbatch
from fnssl_tpu_torch.eval.decode import idl_decode, template_ri, time_pool_ipd
from fnssl_tpu_torch.physics.dpipd import DPIPD
from fnssl_tpu_torch.utils.device import resolve_device


class PredDOA:
    """DOA decoding for the 2-mic FN-SSL model.

    The decode grid is the reference's: the full (res_the × res_phi)
    far-field template cropped to the single ele=π/2 row and the half
    azimuth plane, re-labelled 0..π over 37 points. Only the IDL method
    is ported. ``device=None`` is the first CUDA device.
    """

    def __init__(self, method_mode: str = "IDL",
                 source_num_mode: str = "kNum", max_num_sources: int = 1,
                 res_the: int = 37, res_phi: int = 73, fs: int = 16000,
                 nfft: int = 512, ch_mode: str = "MM",
                 mic_location=((-0.04, 0.0, 0.0), (0.04, 0.0, 0.0)),
                 speed: float = 340.0, device=None):
        if method_mode != "IDL":
            raise NotImplementedError(
                f"method_mode {method_mode!r} is not ported yet")
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
        res = idl_decode(ipd, self.template, self.ele_candidate,
                         self.azi_candidate,
                         max_num_sources=self.max_num_sources,
                         source_num_mode=self.source_num_mode)
        pred = {"doa": res.doa, "vad_sources": res.vad,
                "spatial_spectrum": res.spatial_spectrum}
        return pred, gt_batch
