"""Audio I/O, logging, FLOPs and profiling (port of ``fnssl_tpu/utils``),
under the JAX package's names; ``utils.device`` is the port's own."""
from fnssl_tpu_torch.utils.audio_io import read_audio, write_audio
from fnssl_tpu_torch.utils.logging import (
    MetricLogger, EmaLoss, set_seed, detect_infnan, tag_and_log_git_status)
from fnssl_tpu_torch.utils.flops import (
    cost_analysis, count_params, flops_forward_backward, write_flops)
from fnssl_tpu_torch.utils.profiling import trace, time_fn, summarize
