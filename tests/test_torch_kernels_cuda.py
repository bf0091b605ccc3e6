"""The Hopper LSTM kernels (kernels/csrc/lstm_cluster.cu for H up to 256,
kernels/csrc/lstm_fwd.cu above, and the backward kernels/csrc/
lstm_bwd_cluster.cu and its earlier design kernels/csrc/lstm_bwd.cu)
against their plain version, on the card; the autograd Function and one
train step on the card.
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


# K2, the backward recurrence (kernels/csrc/lstm_bwd_cluster.cu, which
# lstm_bwd and lstm_bwd_bidir launch, and the earlier lstm_bwd.cu).
# Tolerance: fp32 and bf16 dgates, dh0 and dc0 within 1e-4 of the plain
# version (the same float32 arithmetic on the same bf16 values, summed in
# another order).
BWD_TOL = 1e-4


def bwd_inputs(lead, t_steps, b, h, dtype, device, seed=0):
    """g (.., T, B, 4H) float32, w_hh (.., 4H, H) and dys (.., T, B, H) in
    dtype, c0, dhT, dcT (.., B, H) float32, all nonzero."""
    gen = torch.Generator().manual_seed(seed)
    tdt = getattr(torch, dtype)
    g = torch.randn(*lead, t_steps, b, 4 * h, generator=gen).to(device)
    w = (torch.randn(*lead, 4 * h, h, generator=gen) / h ** 0.5).to(device,
                                                                   tdt)
    c0, dh_t, dc_t = (torch.randn(*lead, b, h, generator=gen).to(device)
                      * 0.5 for _ in range(3))
    dys = torch.randn(*lead, t_steps, b, h, generator=gen).to(device, tdt)
    return g, w, c0, dys, dh_t, dc_t


def check_bwd(fn, plain, args, what, counter=lstm_cuda.launches_bwd_cluster,
              plan=None, **kw):
    before = counter.value
    got = fn(args[0].clone(), *args[1:], **kw, **({"plan": plan} if plan
                                                   else {}))
    assert counter.value == before + 1
    want = plain(args[0].clone(), *args[1:], **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dgates", "dh0", "dc0"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = (g - w).abs().max().item() if g.numel() else 0.0
        assert err <= BWD_TOL, (what, name, err)


def earlier_bwd(g, w_hh, c0, dys, dh_t, dc_t, reverse=False):
    """lstm_bwd.cu, the earlier K2, on one direction or (g 4-D) both."""
    ndir = 2 if g.dim() == 4 else None
    dims, dh_t, dc_t = lstm_cuda._check_bwd(g, w_hh, c0, dys, dh_t, dc_t,
                                            ndir=ndir)
    return lstm_cuda._launch_bwd("lstm_bwd", g, w_hh, c0, dys, dh_t, dc_t,
                                 dims, ndir or 1, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 64, 128, 256])
def test_bwd_kernel_matches_plain(cuda, dtype, hidden):
    """lstm_bwd_cluster.cu through both entry points, both walk orders,
    ragged B, short T."""
    seed = 0
    for b in (1, 11, 13, 17):
        for t_steps in (1, 2, 7):
            seed += 1
            args = bwd_inputs((2,), t_steps, b, hidden, dtype, cuda, seed)
            check_bwd(lstm_cuda.lstm_bwd_bidir,
                      lstm_cuda.lstm_bwd_bidir_plain, args, (b, t_steps))
            for reverse in (False, True):
                check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                          tuple(a[int(reverse)] for a in args),
                          (b, t_steps, reverse), reverse=reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 128, 256])
def test_earlier_bwd_kernel_matches_plain(cuda, dtype, hidden):
    """lstm_bwd.cu, both directions in one launch and one reversed walk."""
    for seed, (b, t_steps) in enumerate(((1, 1), (13, 2), (17, 7))):
        args = bwd_inputs((2,), t_steps, b, hidden, dtype, cuda, seed)
        check_bwd(earlier_bwd, lstm_cuda.lstm_bwd_bidir_plain, args,
                  (b, t_steps), counter=lstm_cuda.launches_bwd)
        check_bwd(earlier_bwd, lstm_cuda.lstm_bwd_plain,
                  tuple(a[1] for a in args), (b, t_steps, True),
                  counter=lstm_cuda.launches_bwd, reverse=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_bwd_every_plan_matches_plain(cuda, dtype, hidden):
    """Every (N, Bt, KS, UPT) that lstm_bwd_cluster.cu takes gives the
    same answer, through both entry points."""
    itemsize = 4 if dtype == "float32" else 2
    args = bwd_inputs((2,), 9, 19, hidden, dtype, cuda)
    bt = lstm_cuda.BWD_TILE
    plans = [(n, bt, ks, upt) for n in lstm_cuda.CLUSTER_SIZES
             for ks in (hidden // 16, hidden // 8)
             for upt in lstm_cuda.BWD_UPTS
             if lstm_cuda.bwd_cluster_fits(hidden, itemsize, n, bt, ks, upt)]
    assert plans
    for plan in plans:
        check_bwd(lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain,
                  args, plan, plan=plan)
        check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                  tuple(a[1] for a in args), (plan, True), plan=plan,
                  reverse=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 16 * 298, 128, 2),
                                   (298, 16 * 256, 256, 1)])
def test_bwd_kernel_at_training_shapes(cuda, shape):
    """FN-SSL's two training shapes at nb=16, fp32: a BiLSTM over
    frequency (one launch) and an LSTM over time."""
    t_steps, b, h, ndir = shape
    args = bwd_inputs((ndir,), t_steps, b, h, "float32", cuda)
    if ndir == 2:
        check_bwd(lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain,
                  args, shape)
    else:
        check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                  tuple(a[0] for a in args), shape)


@pytest.mark.cuda
def test_bwd_plan_that_does_not_fit_is_refused(cuda):
    """A plan lstm_bwd_cluster.cu does not take raises, never runs another
    way, and counts no launch."""
    args = bwd_inputs((2,), 3, 4, 256, "float32", cuda)
    before = (lstm_cuda.launches_bwd.value,
              lstm_cuda.launches_bwd_cluster.value)
    with pytest.raises(RuntimeError, match="lstm_bwd_cluster launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, plan=(4, 8, 16, 1))  # 1024 threads
    with pytest.raises(RuntimeError, match="lstm_bwd_cluster launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, plan=(8, 16, 16, 1))  # 16-row tiles
    with pytest.raises(RuntimeError, match="lstm_bwd_cluster launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, plan=(4, 8, 16, 2))  # 352 KB fp32
    assert (lstm_cuda.launches_bwd.value,
            lstm_cuda.launches_bwd_cluster.value) == before


def lstm_case(device, bidirectional, seed=0, t_steps=6, b=5, i=7, h=32):
    from fnssl_tpu_torch.models.lstm import LSTMState

    gen = torch.Generator().manual_seed(seed)
    ndir = 2 if bidirectional else 1
    names = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]
    shapes = [(4 * h, i), (4 * h, h), (4 * h,), (4 * h,)]
    params = {n + s: (torch.randn(shape, generator=gen) * 0.3).to(device)
              .requires_grad_()
              for s in ["", "_reverse"][:ndir] for n, shape in zip(names,
                                                                   shapes)}
    x, h0, c0 = (torch.randn(shape, generator=gen).to(device).requires_grad_()
                 for shape in ((b, t_steps, i), (ndir, b, h), (ndir, b, h)))
    wy = torch.randn(b, t_steps, ndir * h, generator=gen).to(device)
    return params, x, LSTMState(h0, c0), wy


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_function_on_card_matches_cpu(cuda, bidirectional):
    """models.lstm's autograd Function: K1 + K2 on the card against the
    plain versions on the CPU, values and every gradient within 1e-4."""
    from fnssl_tpu_torch.models.lstm import lstm

    results = []
    for device in (cuda, torch.device("cpu")):
        params, x, state, wy = lstm_case(device, bidirectional)
        before = (lstm_cuda.launches.value,
                  lstm_cuda.launches_bwd_cluster.value)
        out, st = lstm(params, x, state, bidirectional)
        ((out * wy).sum() + st.h.sum() + (st.c * 0.5).sum()).backward()
        after = (lstm_cuda.launches.value,
                 lstm_cuda.launches_bwd_cluster.value)
        assert after == ((before[0] + 1, before[1] + 1) if device.type
                         == "cuda" else before)
        results.append([out, st.h, st.c, x.grad, state.h.grad, state.c.grad]
                       + [p.grad for p in params.values()])
    for got, want in zip(*results):
        assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_train_step_launch_counts(cuda):
    """One train step of FN-SSL (hidden 64: full-band H 32, narrow-band H
    64) launches K1 and K2 (lstm_bwd_cluster.cu) 6 times each: 3 fused
    full-band BiLSTMs and 3 narrow-band LSTMs."""
    from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
    from fnssl_tpu_torch.train import step, tasks

    cfg = FNSSLConfig(hidden_size=64)
    model = FNSSL(cfg, device=cuda,
                  generator=torch.Generator().manual_seed(0))
    tx = step.make_optimizer("adam", 1e-3, 0.8988, 1)
    state = step.init_train_state(model, tx)
    train = step.make_train_step(tasks.make_fnssl_task(cfg).loss_fn, tx)
    batch = tasks.synthetic_fnssl_batch(nb=1, t_s=0.4, seed=1)
    counters = (lstm_cuda.launches, lstm_cuda.launches_v2,
                lstm_cuda.launches_bwd, lstm_cuda.launches_bwd_cluster)
    before = [c.value for c in counters]
    state, loss = train(state, batch,
                        torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert [c.value - b for c, b in zip(counters, before)] == [6, 0, 0, 6]
    assert state.step == 1 and torch.isfinite(loss)


@pytest.mark.cuda
def test_backward_above_256_is_refused(cuda):
    """The CUDA backward serves H up to 256; a gradient through a wider
    LSTM raises instead of running elsewhere."""
    from fnssl_tpu_torch.models.lstm import LSTM

    layer = LSTM(4, 512, device=cuda)
    out, _ = layer(torch.randn(2, 3, 4, device=cuda))
    before = (lstm_cuda.launches_bwd.value,
              lstm_cuda.launches_bwd_cluster.value)
    with pytest.raises(ValueError, match="up to 256"):
        out.sum().backward()
    assert (lstm_cuda.launches_bwd.value,
            lstm_cuda.launches_bwd_cluster.value) == before
