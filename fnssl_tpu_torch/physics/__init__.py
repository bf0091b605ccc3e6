"""DP-IPD templates and training targets (port of
``fnssl_tpu/physics``), under the JAX package's names."""
from fnssl_tpu_torch.physics.dpipd import DPIPD, DPIPD2
from fnssl_tpu_torch.physics.targets import (
    ipd_complex_to_ri, vad_mask_and_sum, bessel_nonsource_target,
    vad_gate_with_nonsource, dp_vad, energy_vad)
