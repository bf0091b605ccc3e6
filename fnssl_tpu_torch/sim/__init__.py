"""Room simulation on the host (port of ``fnssl_tpu/sim``): Sabine helpers
and the image-source engine, C++/OpenMP when it builds, numpy otherwise."""
from fnssl_tpu_torch.sim.sabine import (
    beta_sabine_estimation, att2t_sabine_estimator, t2n)
from fnssl_tpu_torch.sim.ism import simulate_rir, simulate_trajectory
