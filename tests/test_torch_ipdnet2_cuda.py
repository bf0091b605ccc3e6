"""The selective-scan kernels on the card: K3 (ssm_scan.cu's forward) and
K4 (its backward) against their plain versions at IPDnet2's training
shapes (nb=16 × 4 s: B=256, L=201 at layer 0 and 40 after it, d=192), its
serve chunk step (B=16, L=5 and 1), and edge cases (L 0/1/2/7, ragged B,
d 32), float32 and bfloat16 inputs; the exact launch counts of a
SpatialNet chunk step (16 K3, no K4) and of an IPDnet2 train step (16 K3
and 16 K4).

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where there is no CUDA device; the file imports only torch and the
port, so that it runs on the card's machine without JAX:

  python -m pytest tests/test_torch_ipdnet2_cuda.py -m cuda --noconftest

Tolerances: float32 outputs (y, h_last, d(h0), and d(da), d(dbx), d(c) of
float32 inputs) within 1e-5 relative + 1e-4 absolute (the kernel fuses
each step's multiply-add and sums the 16 states in another order; the
state decays, so the difference does not grow with L); bfloat16 gradients
within 1e-2 relative (one bf16 rounding of float32 values that differ in
their last bits may land one bf16 step apart).
"""
import math

import numpy as np
import pytest
import torch

from fnssl_tpu_torch.kernels import ssm_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def inputs(batch, steps, dim, dtype, device, seed):
    """da = exp(delta · a) with a = -(1..16) and delta in [1e-3, 0.1] (the
    range of IPDnet2's dt init); the rest normal."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    delta = torch.rand(batch, steps, dim, 1, generator=gen,
                       device=device) * 0.099 + 0.001
    a = -torch.arange(1, 17, dtype=torch.float32, device=device)
    return {"da": torch.exp(delta * a).to(dtype),
            "dbx": randn(batch, steps, dim, 16, scale=0.1).to(dtype),
            "c": randn(batch, steps, 16).to(dtype),
            "h0": randn(batch, dim, 16, scale=0.5),
            "dy": randn(batch, steps, dim),
            "dh_last": randn(batch, dim, 16, scale=0.5)}


def close(got, want, what):
    tol = (dict(rtol=1e-2, atol=1e-2) if got.dtype == torch.bfloat16
           else dict(rtol=1e-5, atol=1e-4))
    torch.testing.assert_close(got, want, msg=what, **tol)


# (B, L, d): training layer 0 and layers 1-7 at nb=16, the serve chunk
# step (5 frames, 1 after the time mean), and edge cases
SHAPES = [(256, 201, 192), (256, 40, 192), (16, 5, 192), (16, 1, 192),
          (3, 0, 192), (3, 1, 32), (13, 2, 32), (5, 7, 192), (1, 9, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_and_k4_match_their_plain_versions(cuda, shape, dtype):
    batch, steps, dim = shape
    x = inputs(batch, steps, dim, dtype, cuda, seed=batch + steps + dim)
    before = (ssm_cuda.launches_ssm_fwd.value,
              ssm_cuda.launches_ssm_bwd.value)
    y, h = ssm_cuda.ssm_scan_fwd(x["da"], x["dbx"], x["c"], x["h0"])
    grads = ssm_cuda.ssm_scan_bwd(x["da"], x["dbx"], x["c"], x["h0"],
                                  x["dy"], x["dh_last"])
    torch.cuda.synchronize()
    launched = 0 if steps == 0 else 1
    assert (ssm_cuda.launches_ssm_fwd.value,
            ssm_cuda.launches_ssm_bwd.value) == (before[0] + launched,
                                                 before[1] + launched)
    want_y, want_h = ssm_cuda.ssm_scan_fwd_plain(x["da"], x["dbx"], x["c"],
                                                 x["h0"])
    assert y.dtype == h.dtype == torch.float32
    close(y, want_y, "y")
    close(h, want_h, "h_last")
    want = ssm_cuda.ssm_scan_bwd_plain(x["da"], x["dbx"], x["c"], x["h0"],
                                       x["dy"], x["dh_last"])
    for name, g, w in zip(("d(da)", "d(dbx)", "d(c)", "d(h0)"), grads,
                          want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        close(g, w, name)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = inputs(2, 3, 32, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError, match="d_state"):
        ssm_cuda.ssm_scan_fwd(x["da"][..., :8].contiguous(),
                              x["dbx"][..., :8].contiguous(),
                              x["c"][..., :8].contiguous(),
                              x["h0"][..., :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_cuda.ssm_scan_fwd(x["da"].transpose(0, 1).contiguous()
                              .transpose(0, 1), x["dbx"], x["c"], x["h0"])
    big = inputs(2, 3, 200, torch.float32, cuda, seed=1)
    with pytest.raises(ValueError, match="multiple of 8 up to 192"):
        ssm_cuda.ssm_scan_bwd(big["da"], big["dbx"], big["c"], big["h0"],
                              big["dy"], big["dh_last"])
    with pytest.raises(RuntimeError, match="SSMScan"):
        ssm_cuda.ssm_scan_fwd(x["da"].requires_grad_(), x["dbx"], x["c"],
                              x["h0"])


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
