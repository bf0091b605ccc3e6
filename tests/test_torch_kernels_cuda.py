"""The Hopper LSTM kernels (kernels/csrc/lstm_cluster.cu for H up to 256,
kernels/csrc/lstm_fwd.cu above) against their plain version, on the card.
A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where there is no CUDA device. The file imports only torch and the
port, so that it runs on a machine without JAX (``--noconftest`` skips
tests/conftest.py, which imports JAX):

  python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

Tolerances: fp32 ys/hT/cT within 1e-4 (another order of the h@W_hh sum);
bf16 xg: ys within 2e-2 (bf16 output rounding), hT/cT within 1e-4.
"""
import pytest
import torch

from fnssl_tpu_torch.kernels import lstm_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def inputs(lead, t_steps, b, h, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    tdt = getattr(torch, dtype)
    xg = torch.randn(*lead, t_steps, b, 4 * h, generator=g).to(device, tdt)
    w = (torch.randn(*lead, h, 4 * h, generator=g) / h ** 0.5).to(device,
                                                                  tdt)
    h0 = torch.randn(*lead, b, h, generator=g).to(device) * 0.5
    c0 = torch.randn(*lead, b, h, generator=g).to(device) * 0.5
    return xg, w, h0, c0


def assert_close(got, want, dtype, what):
    torch.cuda.synchronize()
    tol = {"ys": 1e-4 if dtype == "float32" else 2e-2, "hT": 1e-4,
           "cT": 1e-4}
    assert got[0].dtype == want[0].dtype
    for name, g, w in zip(("ys", "hT", "cT"), got, want):
        assert g.shape == w.shape, (what, name)
        err = (g.float() - w.float()).abs().max().item() if g.numel() else 0
        assert err <= tol[name], (what, name, err)


def check_one(args, dtype, reverse, plan=None, counter=lstm_cuda.launches):
    before = counter.value
    got = lstm_cuda.lstm_fwd(*args, reverse=reverse, plan=plan)
    assert counter.value == before + 1
    want = lstm_cuda.lstm_fwd_plain(*args, reverse=reverse)
    assert_close(got, want, dtype, ("lstm_fwd", reverse, plan))


def check_bidir(args, dtype, plan=None):
    before = lstm_cuda.launches.value
    got = lstm_cuda.lstm_fwd_bidir(*args, plan=plan)
    assert lstm_cuda.launches.value == before + 1
    want = lstm_cuda.lstm_fwd_bidir_plain(*args)
    assert_close(got, want, dtype, ("lstm_fwd_bidir", plan))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(256, 12, 128), (12, 256, 256),
                                   (7, 11, 64), (1, 11, 64), (2, 3, 32)])
def test_kernel_matches_plain_on_card(cuda, dtype, reverse, shape):
    """One direction through lstm_fwd (the cluster kernel at these H)."""
    t_steps, b, h = shape
    check_one(inputs((), t_steps, b, h, dtype, cuda), dtype, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 12, 128), (12, 256, 256),
                                   (256, 298, 128), (298, 256, 256)])
def test_bidir_matches_plain_on_card(cuda, dtype, shape):
    """Both directions in one launch, at the main path's shapes."""
    t_steps, b, h = shape
    check_bidir(inputs((2,), t_steps, b, h, dtype, cuda), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 64, 128, 256])
def test_cluster_kernel_edge_cases(cuda, dtype, hidden):
    """Ragged B, short T (T = 0 returns h0, c0), both entry points, both
    directions, nonzero h0 and c0."""
    seed = 0
    for b in (1, 11, 13, 17):
        for t_steps in (0, 1, 2, 7):
            seed += 1
            args = inputs((2,), t_steps, b, hidden, dtype, cuda, seed)
            check_bidir(args, dtype)
            for reverse in (False, True):
                check_one(tuple(a[1] for a in args), dtype, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [128, 256])
def test_every_plan_matches_plain(cuda, dtype, hidden):
    """Every (N, Bt) that fits at FN-SSL's widths gives the same answer."""
    itemsize = 4 if dtype == "float32" else 2
    args = inputs((2,), 9, 19, hidden, dtype, cuda)
    tried = 0
    for n in (1, 2, 4, 8):
        for bt in (8, 16):
            for ks in (hidden // 16, hidden // 8):
                try:
                    plan = lstm_cuda.cluster_plan(hidden, itemsize, 19, n=n,
                                                  bt=bt, ks=ks)
                except ValueError:
                    continue                 # does not fit
                tried += 1
                check_bidir(args, dtype, plan)
    assert tried >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_kernel_above_256(cuda, dtype):
    """H > 256 runs lstm_fwd.cu, one launch per direction."""
    args = inputs((2,), 5, 13, 512, dtype, cuda)
    for reverse in (False, True):
        check_one(tuple(a[0] for a in args), dtype, reverse,
                  counter=lstm_cuda.launches_v2)
    before = (lstm_cuda.launches.value, lstm_cuda.launches_v2.value)
    got = lstm_cuda.lstm_fwd_bidir(*args)
    assert (lstm_cuda.launches.value,
            lstm_cuda.launches_v2.value) == (before[0], before[1] + 2)
    assert_close(got, lstm_cuda.lstm_fwd_bidir_plain(*args), dtype, "v2")


@pytest.mark.cuda
def test_unsupported_hidden_raises(cuda):
    """H not a multiple of 32 is refused on the card, never run elsewhere;
    so is a plan that does not fit."""
    before = (lstm_cuda.launches.value, lstm_cuda.launches_v2.value)
    args = inputs((2,), 3, 4, 40, "float32", cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        lstm_cuda.lstm_fwd_bidir(*args)
    with pytest.raises(ValueError, match="multiple of 32"):
        lstm_cuda.lstm_fwd(*(a[0] for a in args))
    args = inputs((2,), 3, 4, 256, "float32", cuda)
    with pytest.raises(RuntimeError, match="lstm_cluster launch failed"):
        lstm_cuda.lstm_fwd_bidir(*args, plan=(1, 8, 16))   # 1 MB slice
    assert (lstm_cuda.launches.value, lstm_cuda.launches_v2.value) == before


@pytest.mark.cuda
def test_kernel_refuses_grad(cuda):
    xg = torch.zeros(2, 3, 128, device=cuda, requires_grad=True)
    w = torch.zeros(32, 128, device=cuda)
    s = torch.zeros(3, 32, device=cuda)
    with pytest.raises(RuntimeError, match="backward"):
        lstm_cuda.lstm_fwd(xg, w, s, s)
