"""The fused selective-scan kernels on the card: K3 (ssm_scan.cu's
forward) and K4 (its backward) against their plain versions
(``selective_scan_fwd_plain``, ``selective_scan_bwd_plain``) at every scan
shape of IPDnet2's paths: training (nb=16 × 4 s: B=256, L=201 at layer 0
and 40 after it, d=192), the forward cell (L 200), the serve chunk step
(B=16, L=5 and 1), the 16-slot tick (B=256, L=5 and 1), one data-parallel
rank (B=128) and one 2 × 2 mesh rank (B=64) at L 201 and 40; and edge
cases (L 0/1/2/7, ragged B, d 13, 32, 40 and 200: d's last slice
ragged, also over several of K4's 8-step segments: L 17, 33 and 201),
float32 and bfloat16 inputs, nonzero h0 and dh_last, one channel
whose dt + dt_bias passes the softplus threshold; K4's outputs the same
bits run to run at the ragged shapes; the exact launch counts
of a SpatialNet chunk step (16 K3, no K4) and of an IPDnet2 train step (16
K3 and 16 K4).

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where there is no CUDA device; the file imports only torch and the
port, so that it runs on the card's machine without JAX:

  python -m pytest tests/test_torch_ipdnet2_cuda.py -m cuda --noconftest

Tolerances (``TOL``): float32 outputs within 1e-5 relative + 1e-4
absolute (the kernel fuses each step's multiply-adds, takes the 16 states'
and d's sums in another order, and the plain version rounds exp(Δ·A) and
Δ·x·B to float32 tensors; the state decays, so the difference does not
grow with L); the gradients summed over batch and time (d(A), d(D),
d(dt_bias); up to 51,456 terms of either sign) within 1e-5 of their
largest magnitude; bfloat16 gradients within 1e-2 relative (one bf16
rounding of float32 values that differ in their last bits).
"""
import math

import numpy as np
import pytest
import torch

from fnssl_tpu_torch.kernels import ssm_cuda

OUTPUTS = ("y", "h_last")
GRADS = ("dx", "d(dt)", "d(dt_bias)", "d(A)", "d(B)", "d(C)", "d(D)",
         "d(h0)")
SUMMED = ("d(dt_bias)", "d(A)", "d(D)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def inputs(batch, steps, dim, dtype, device, seed):
    """The fused scan's inputs as IPDnet2's init gives them: dt_bias the
    inverse softplus of a dt in [1e-3, 0.1] (channel 0 at 25, past the
    threshold), A = -(1..16), D = 1; x, dt, B, C normal (dt at 0.5)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    u = torch.rand(dim, generator=gen, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt_bias[0] = 25.0
    a = -torch.arange(1, 17, dtype=torch.float32,
                      device=device).expand(dim, 16).contiguous()
    return {"x": randn(batch, steps, dim).to(dtype),
            "dt": randn(batch, steps, dim, scale=0.5).to(dtype),
            "dt_bias": dt_bias, "a": a,
            "bm": randn(batch, steps, 16).to(dtype),
            "c": randn(batch, steps, 16).to(dtype),
            "d_skip": torch.ones(dim, device=device),
            "h0": randn(batch, dim, 16, scale=0.5),
            "dy": randn(batch, steps, dim),
            "dh_last": randn(batch, dim, 16, scale=0.5)}


ARGS = ("x", "dt", "dt_bias", "a", "bm", "c", "d_skip", "h0")


def close(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if what in SUMMED:
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (what, err)
        return
    tol = (dict(rtol=1e-2, atol=1e-2) if got.dtype == torch.bfloat16
           else dict(rtol=1e-5, atol=1e-4))
    torch.testing.assert_close(got, want, msg=what, **tol)


# (B, L, d): every scan shape of the IPDnet2 paths, and edge cases
SHAPES = [(256, 201, 192), (256, 40, 192), (256, 200, 192), (16, 5, 192),
          (16, 1, 192), (256, 5, 192), (256, 1, 192), (128, 201, 192),
          (128, 40, 192), (64, 201, 192), (64, 40, 192), (3, 0, 192),
          (3, 1, 32), (13, 2, 32), (5, 7, 192), (1, 9, 32), (2, 17, 40),
          (3, 5, 13), (300, 3, 200), (2, 17, 13), (3, 33, 40),
          (4, 201, 13)]
# d's last slice ragged over several of K4's checkpoint segments
RAGGED = [(2, 17, 13), (2, 17, 40), (3, 33, 40), (4, 201, 13),
          (64, 201, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_and_k4_match_their_plain_versions(cuda, shape, dtype):
    batch, steps, dim = shape
    x = inputs(batch, steps, dim, dtype, cuda, seed=batch + steps + dim)
    args = [x[k] for k in ARGS]
    before = (ssm_cuda.launches_ssm_fwd.value,
              ssm_cuda.launches_ssm_bwd.value)
    fwd = ssm_cuda.selective_scan_fwd(*args)
    grads = ssm_cuda.selective_scan_bwd(*args, x["dy"], x["dh_last"])
    torch.cuda.synchronize()
    launched = 0 if steps == 0 else 1
    assert (ssm_cuda.launches_ssm_fwd.value,
            ssm_cuda.launches_ssm_bwd.value) == (before[0] + launched,
                                                 before[1] + launched)
    want = ssm_cuda.selective_scan_fwd_plain(*args)
    for name, g, w in zip(OUTPUTS, fwd, want):
        assert g.dtype == torch.float32, name
        close(g, w, name)
    want = ssm_cuda.selective_scan_bwd_plain(*args, x["dy"], x["dh_last"])
    for name, g, w in zip(GRADS, grads, want):
        close(g, w, name)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = inputs(2, 3, 32, torch.float32, cuda, seed=0)
    args = [x[k] for k in ARGS]
    with pytest.raises(ValueError, match="d_state"):
        ssm_cuda.selective_scan_fwd(
            *args[:3], x["a"][:, :8].contiguous(),
            x["bm"][..., :8].contiguous(), x["c"][..., :8].contiguous(),
            x["d_skip"], x["h0"][..., :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_cuda.selective_scan_fwd(
            x["x"].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
    with pytest.raises(RuntimeError, match="SSMScan"):
        ssm_cuda.selective_scan_fwd(x["x"].requires_grad_(), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RAGGED)
def test_k4_gives_the_same_bits_run_to_run(cuda, shape):
    """K4 writes its partials without atomics and each thread reads back
    only its own checkpoints, so five launches on the same inputs give
    the same bits, also where the spare threads of a ragged last slice
    walk the last channel."""
    x = inputs(*shape, torch.float32, cuda, seed=sum(shape))
    args = [x[k] for k in ARGS] + [x["dy"], x["dh_last"]]
    first = ssm_cuda.selective_scan_bwd(*args)
    for _ in range(4):
        for name, g, w in zip(GRADS, ssm_cuda.selective_scan_bwd(*args),
                              first):
            assert torch.equal(g, w), name


@pytest.mark.cuda
def test_launches_of_a_chunk_step_and_a_train_step(cuda):
    """A streamed 5-frame chunk launches K3 16 times (8 layers × 2 Mamba
    blocks) and K4 none; a train step of make_ipdnet2_task (nb 1 × 1 s),
    16 K3 and 16 K4."""
    from fnssl_tpu_torch.models.spatialnet import (SpatialNet,
                                                   init_spatialnet_state)
    from fnssl_tpu_torch.train import step as tstep
    from fnssl_tpu_torch.train.tasks import make_ipdnet2_task

    model = SpatialNet(device=cuda,
                       generator=torch.Generator().manual_seed(0))
    counters = (ssm_cuda.launches_ssm_fwd, ssm_cuda.launches_ssm_bwd)
    state = init_spatialnet_state(1, model.cfg, cuda)
    feats = torch.randn(1, 10, 256, 5, device=cuda)
    for c in counters:
        c.reset()
    with torch.inference_mode():
        out, state = model(feats, state=state, return_state=True)
    torch.cuda.synchronize()
    assert [c.value for c in counters] == [16, 0]
    assert out.shape == (1, 1, 512, 4, 2) and torch.isfinite(out).all()

    task = make_ipdnet2_task(device=cuda)
    rng = np.random.default_rng(0)
    batch = {"mic_sig": rng.standard_normal((1, 16000, 5)).astype(
                 np.float32),
             "azi_deg": rng.uniform(0, 360, (1, 10, 2)).astype(np.float32),
             "distance": np.full((1, 10, 2), 1.5, np.float32),
             "vad": np.ones((1, 10, 2), np.float32),
             "mic_pos": task.dpipd.mic_location[None].astype(np.float32)}
    tx = tstep.make_optimizer("adamw", 5e-4, 0.975, 1, grad_clip=5.0)
    st = tstep.init_train_state(model, tx)
    for c in counters:
        c.reset()
    st, loss = tstep.make_train_step(task.loss_fn, tx)(st, batch)
    torch.cuda.synchronize()
    assert [c.value for c in counters] == [16, 16]
    assert math.isfinite(float(loss))
