"""Decoding and metrics (port of ``fnssl_tpu/eval``), under the JAX
package's names."""
from fnssl_tpu_torch.eval.decode import (
    DecodeResult, spatial_spectrum, idl_decode, pd_decode, mse_decode,
    time_pool_ipd, template_ri, track_associate)
from fnssl_tpu_torch.eval.metrics import (
    angular_error, get_metric_single, get_metric_multiple)
from fnssl_tpu_torch.eval.pred_doa import (
    PredDOA, PredDOAMultiTrack, predgt2doa_cls, ipd_baseline)
from fnssl_tpu_torch.eval.vis import vis_doa, locata_plot
