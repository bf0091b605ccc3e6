"""The serving paths on the card: the custom ops of ``kernels/ops.py``, the
slot pool's CUDA graphs and the exported artifacts, each running K1
(``lstm_cluster.cu``) and K3 (``ssm_scan.cu``).

- each custom op against its plain version and against the direct wrapper
  (``lstm_cuda.lstm_fwd``/``lstm_fwd_bidir``,
  ``ssm_cuda.selective_scan_fwd``),
  one launch a call;
- a captured tier of the slot pool against the same tier run eagerly on
  the card, at tiers 1 and 4 (outputs and the pool state after the tick),
  the replays' kernels read from a device trace (a replay calls no
  wrapper, so no launch counter moves);
- an artifact exported for cuda running K1 (FN-SSL) and K3 (IPDnet2), shown
  by the launch counters, against its module.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where there is no CUDA device; the file imports only torch and the
port, so that it runs on the card's machine without JAX:

  python -m pytest tests/test_torch_serving_cuda.py -m cuda --noconftest

Tolerances: an op against the wrapper it calls: equal; against the plain
version as tests/test_torch_kernels_cuda.py (1e-4: the kernel's float32
sums in another order); a graph replay against the eager tier: 1e-6, equal
but for float32 rounding (the same kernels on the same inputs; cuBLAS may
split a product otherwise under capture); an artifact against its module:
1e-5.
"""
import numpy as np
import pytest
import torch

from fnssl_tpu_torch.kernels import lstm_cuda, ops, ssm_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device=gen.device) * scale


def lstm_inputs(cuda, t, b, h, ndir=None, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    lead = () if ndir is None else (ndir,)
    return (randn(gen, *lead, t, b, 4 * h),
            randn(gen, *lead, h, 4 * h, scale=h ** -0.5),
            randn(gen, *lead, b, h, scale=0.5),
            randn(gen, *lead, b, h, scale=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h", [(12, 256, 256), (12, 4096, 256),
                                   (12, 256, 128)])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_op_matches_wrapper_and_plain(cuda, t, b, h, reverse):
    """ops.lstm_fwd at the narrow-band serve shapes (one stream and the
    16-slot tier of FN-SSL; IPDnet's one stream)."""
    args = lstm_inputs(cuda, t, b, h, seed=t + b + h)
    before = lstm_cuda.launches.value
    got = ops.lstm_fwd(*args, reverse=reverse)
    assert lstm_cuda.launches.value == before + 1
    direct = lstm_cuda.lstm_fwd(*args, reverse=reverse)
    plain = lstm_cuda.lstm_fwd_plain(*args, reverse=reverse)
    for g, d, p in zip(got, direct, plain):
        torch.testing.assert_close(g, d, rtol=0, atol=0)
        torch.testing.assert_close(g, p, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,h", [(256, 12, 128), (256, 192, 128),
                                   (256, 12, 64), (256, 192, 64)])
def test_lstm_bidir_op_matches_wrapper_and_plain(cuda, t, b, h):
    """ops.lstm_fwd_bidir at the full-band serve shapes (FN-SSL's and
    IPDnet's, one stream and the 16-slot tier)."""
    args = lstm_inputs(cuda, t, b, h, ndir=2, seed=b + h)
    before = lstm_cuda.launches.value
    got = ops.lstm_fwd_bidir(*args)
    assert lstm_cuda.launches.value == before + 1
    direct = lstm_cuda.lstm_fwd_bidir(*args)
    plain = lstm_cuda.lstm_fwd_bidir_plain(*args)
    for g, d, p in zip(got, direct, plain):
        torch.testing.assert_close(g, d, rtol=0, atol=0)
        torch.testing.assert_close(g, p, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,steps", [(16, 5), (16, 1), (256, 5),
                                         (256, 1)])
def test_ssm_op_matches_wrapper_and_plain(cuda, batch, steps):
    """ops.selective_scan_fwd at IPDnet2's serve shapes (one stream: B 16;
    the 16-slot tier: B 256; L 5 at layer 0, 1 after it)."""
    gen = torch.Generator(device=cuda).manual_seed(batch + steps)
    dim = 192
    a = -torch.arange(1, 17, dtype=torch.float32,
                      device=cuda).expand(dim, 16).contiguous()
    args = (randn(gen, batch, steps, dim), randn(gen, batch, steps, dim,
                                                 scale=0.5),
            torch.full((dim,), -4.0, device=cuda), a,
            randn(gen, batch, steps, 16), randn(gen, batch, steps, 16),
            torch.ones(dim, device=cuda),
            randn(gen, batch, dim, 16, scale=0.5))
    before = ssm_cuda.launches_ssm_fwd.value
    got = ops.selective_scan_fwd(*args)
    assert ssm_cuda.launches_ssm_fwd.value == before + 1
    direct = ssm_cuda.selective_scan_fwd(*args)
    plain = ssm_cuda.selective_scan_fwd_plain(*args)
    for g, d, p in zip(got, direct, plain):
        torch.testing.assert_close(g, d, rtol=0, atol=0)
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-4)


def fnssl_stepper(cuda, seed=0):
    from fnssl_tpu_torch.models.fnssl import FNSSL
    from fnssl_tpu_torch.runtime.export import _resolve
    from fnssl_tpu_torch.runtime.slots import SlotBatchedStepper

    model = FNSSL(device=cuda,
                  generator=torch.Generator().manual_seed(seed)).eval()
    apply_fn, init_state = _resolve("fnssl", model)
    return SlotBatchedStepper(apply_fn, model, init_state, slots=16)


@pytest.mark.cuda
@pytest.mark.parametrize("active", [1, 3])
def test_captured_tier_equals_eager_tier(cuda, active):
    """Tier 1 (one stream) and tier 4 (three streams and a padded row) of
    a 16-slot FN-SSL pool at full width: two ticks through the CUDA graph
    against the same tier function run eagerly on the card from the same
    state. The capture launches K1 through the wrappers (its eager
    warm-up and the capture itself, 6 each); a replay launches none
    through them, and the device trace shows 6 K1 kernels a replay."""
    from torch.profiler import ProfilerActivity, profile

    graph, eager = fnssl_stepper(cuda), fnssl_stepper(cuda)
    rng = np.random.default_rng(active)
    ids = np.asarray([5, 0, 9][:active])
    tier = 1 if active == 1 else 4
    pad = [i for i in range(16) if i not in ids][:tier - active]
    full = np.concatenate([ids, pad]).astype(np.int64)
    before = lstm_cuda.launches.value
    graph._tier(tier, (tier, 4, 256, 12))
    assert lstm_cuda.launches.value - before == 6 * 2
    traced = 0
    for tick in range(2):
        feats = rng.standard_normal((active, 4, 256, 12)).astype(np.float32)
        reset = np.full(active, tick == 0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a trace may lose its first records: spin kernels go first,
            # and one of them must be kept
            for _ in range(256):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            got = graph.step_slots(ids, feats, reset)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any("spin_kernel" in n for n in names)
        traced += sum("lstm_cluster_kernel" in n for n in names)
        padded = np.concatenate([feats, np.zeros(
            (tier - active, 4, 256, 12), np.float32)])
        want = eager._run_tier(
            tier, torch.as_tensor(padded, device=cuda),
            torch.as_tensor(full, device=cuda),
            torch.as_tensor(np.concatenate([reset, np.zeros(
                tier - active, bool)]), device=cuda),
            torch.arange(tier, device=cuda) < active)
        torch.testing.assert_close(got, want[:active].cpu(), rtol=1e-6,
                                   atol=1e-6)
    for g, e in zip(graph._state, eager._state):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-6)
    assert graph.replays[tier] == 2
    assert traced == 6 * 2
    # the capture's warm-up and capture, and 2 eager ticks, 6 K1 each
    assert lstm_cuda.launches.value - before == 6 * (2 + 2)


@pytest.mark.cuda
def test_cuda_artifacts_run_the_kernels(cuda, tmp_path):
    """A stream artifact of FN-SSL and a forward artifact of IPDnet2,
    exported for cuda at full width: the program runs 6 K1 launches a
    chunk step and 16 K3 launches a forward, and agrees with its module."""
    from fnssl_tpu_torch.models.fnssl import FNSSL
    from fnssl_tpu_torch.models.spatialnet import SpatialNet
    from fnssl_tpu_torch.runtime.export import export_model, load_artifact

    gen = torch.Generator().manual_seed(3)
    fn = FNSSL(device=cuda, generator=gen).eval()
    feats = torch.randn(1, 4, 256, 24, generator=gen)
    export_model("fnssl", fn, feats[..., :12].numpy(),
                 str(tmp_path / "fn"), mode="stream", platforms=["cuda"])
    art = load_artifact(str(tmp_path / "fn"), cuda)
    before = lstm_cuda.launches.value
    out = torch.cat([art(feats[..., :12]), art(feats[..., 12:])], dim=1)
    assert lstm_cuda.launches.value - before == 12
    with torch.no_grad():
        want = fn(feats.to(cuda))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)

    sn = SpatialNet(device=cuda, generator=gen).eval()
    x = torch.randn(1, 10, 256, 20, generator=gen)
    export_model("ipdnet2", sn, x.numpy(), str(tmp_path / "sn"),
                 platforms=["cuda"])
    art = load_artifact(str(tmp_path / "sn"), cuda)
    before = ssm_cuda.launches_ssm_fwd.value
    out = art(x)
    assert ssm_cuda.launches_ssm_fwd.value - before == 16
    with torch.no_grad():
        torch.testing.assert_close(out, sn(x.to(cuda)), rtol=1e-5,
                                   atol=1e-5)
