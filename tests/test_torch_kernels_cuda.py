"""The Hopper LSTM kernels (kernels/csrc/lstm_cluster.cu for H up to 256,
kernels/csrc/lstm_wave.cu for large batches at H 256, kernels/csrc/
lstm_wide.cu above H 256, and the backward kernels/csrc/
lstm_bwd_cluster.cu, for large batches kernels/csrc/lstm_bwd_wave.cu, and
above H 256 kernels/csrc/lstm_bwd_wide.cu) against their plain version, on
the card; widths that are not a multiple of 32, padded; the autograd
Function and one train step on the card.
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
    """H > 256 at small B (chip_smoke's V2_CASE) runs lstm_wide.cu, one
    launch for one direction or both."""
    args = inputs((2,), 5, 13, 512, dtype, cuda)
    for reverse in (False, True):
        check_one(tuple(a[0] for a in args), dtype, reverse,
                  counter=lstm_cuda.launches_wide)
    before = (lstm_cuda.launches.value, lstm_cuda.launches_wide.value)
    got = lstm_cuda.lstm_fwd_bidir(*args)
    assert (lstm_cuda.launches.value,
            lstm_cuda.launches_wide.value) == (before[0], before[1] + 1)
    assert_close(got, lstm_cuda.lstm_fwd_bidir_plain(*args), dtype, "wide")


@pytest.mark.cuda
def test_unsupported_hidden_raises(cuda):
    """H not a multiple of 32 (48) runs through the kernels padded to 64
    and equals the plain version; H above 1024 is refused on the card,
    never run elsewhere; so is a plan that does not fit."""
    args = inputs((2,), 7, 13, 48, "float32", cuda, 3)
    check_bidir(args, "float32")
    for reverse in (False, True):
        check_one(tuple(a[int(reverse)] for a in args), "float32", reverse)
    bwd = bwd_inputs((2,), 7, 13, 48, "float32", cuda, 3)
    check_bwd(lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain, bwd,
              "H 48", route=None)
    check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
              tuple(a[1] for a in bwd), "H 48 reverse", route=None,
              reverse=True)
    before = (lstm_cuda.launches.value, lstm_cuda.launches_wide.value)
    args = inputs((2,), 3, 4, 1056, "float32", cuda)
    with pytest.raises(ValueError, match="up to 1024"):
        lstm_cuda.lstm_fwd_bidir(*args)
    with pytest.raises(ValueError, match="up to 1024"):
        lstm_cuda.lstm_fwd(*(a[0] for a in args))
    args = inputs((2,), 3, 4, 256, "float32", cuda)
    with pytest.raises(RuntimeError, match="lstm_cluster launch failed"):
        lstm_cuda.lstm_fwd_bidir(*args, plan=(1, 8, 16))   # 1 MB slice
    assert (lstm_cuda.launches.value, lstm_cuda.launches_wide.value) == before


@pytest.mark.cuda
def test_kernel_refuses_grad(cuda):
    xg = torch.zeros(2, 3, 128, device=cuda, requires_grad=True)
    w = torch.zeros(32, 128, device=cuda)
    s = torch.zeros(3, 32, device=cuda)
    with pytest.raises(RuntimeError, match="backward"):
        lstm_cuda.lstm_fwd(xg, w, s, s)


# K1's large-batch kernel, kernels/csrc/lstm_wave.cu: fwd_route gives it
# FN-SSL's narrow band (H 256) from WAVE_MIN_ROWS rows (B x directions) up.
# The same tolerances as the cluster kernel's.


def check_wave(args, dtype, reverse=None, plan=None, route=None):
    """lstm_fwd (one direction, `reverse` given) or lstm_fwd_bidir (args
    stacked for 2) on lstm_wave.cu: one launch of it, none of
    lstm_cluster.cu, and the plain version's answer."""
    before = (lstm_cuda.launches.value, lstm_cuda.launches_wave.value)
    if reverse is None:
        got = lstm_cuda.lstm_fwd_bidir(*args, plan=plan, route=route)
        want = lstm_cuda.lstm_fwd_bidir_plain(*args)
    else:
        got = lstm_cuda.lstm_fwd(*args, reverse=reverse, plan=plan,
                                 route=route)
        want = lstm_cuda.lstm_fwd_plain(*args, reverse=reverse)
    assert (lstm_cuda.launches.value,
            lstm_cuda.launches_wave.value) == (before[0], before[1] + 1)
    assert_close(got, want, dtype, ("lstm_wave", reverse, plan))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(298, 4096, 256), (12, 4096, 256),
                                   (298, 2048, 256)])
def test_wave_kernel_at_the_rule_shapes(cuda, dtype, shape):
    """FN-SSL's narrow band in training, in the 16-slot tick and in a DP
    rank's step: the rule's route, both walks and both directions in one
    launch, nonzero h0 and c0."""
    t_steps, b, h = shape
    args = inputs((2,), t_steps, b, h, dtype, cuda)
    for reverse in (False, True):
        check_wave(tuple(a[int(reverse)] for a in args), dtype, reverse)
    check_wave(args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 64, 128, 256])
def test_wave_kernel_edge_cases(cuda, dtype, hidden):
    """lstm_wave.cu by name: ragged B (1, 13, 300: no tile's multiple),
    short T (T = 0 returns h0, c0), both entry points and walks."""
    seed = 100
    for b in (1, 13, 300):
        for t_steps in (0, 1, 2, 7):
            seed += 1
            args = inputs((2,), t_steps, b, hidden, dtype, cuda, seed)
            check_wave(args, dtype, route="wave")
            for reverse in (False, True):
                check_wave(tuple(a[1] for a in args), dtype, reverse,
                           route="wave")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wave_threshold_both_sides(cuda, dtype):
    """Ragged B just under and over each threshold: lstm_cluster.cu below,
    lstm_wave.cu from it up."""
    itemsize = 4 if dtype == "float32" else 2
    for (hidden, size), least in lstm_cuda.WAVE_MIN_ROWS.items():
        if size != itemsize:
            continue
        below = inputs((), 7, least - 3, hidden, dtype, cuda, 7)
        for reverse in (False, True):
            check_one(below, dtype, reverse)
            check_wave(inputs((), 7, least + 3, hidden, dtype, cuda, 8),
                       dtype, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [128, 256])
def test_wave_every_plan_matches_plain(cuda, dtype, hidden):
    """Every plan lstm_wave.cu is built for gives the same answer."""
    itemsize = 4 if dtype == "float32" else 2
    args = inputs((2,), 9, 77, hidden, dtype, cuda)
    plans = [p for p in lstm_cuda.WAVE_ROWS
             if lstm_cuda.wave_fits(hidden, itemsize, p)]
    assert plans
    for plan in plans:
        check_wave(args, dtype, plan=plan, route="wave")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 16 * 298, 128, 2),
                                   (256, 16 * 298 - 13, 128, 2),
                                   (280, 16 * 256, 128, 1),
                                   (9, 77, 128, 2)])
def test_wave128_tile_matches_plain(cuda, dtype, shape):
    """lstm_wave.cu's H = 128 tile (37 rows, 128 threads) at FN-SSL's full
    band in training, a ragged B under it, IPDnet's narrow band and a
    small ragged B: both entry points and walks."""
    t_steps, b, h, ndir = shape
    plan = lstm_cuda.WAVE128_ROWS[0]
    args = inputs((2,), t_steps, b, h, dtype, cuda, 9)
    if ndir == 2:
        check_wave(args, dtype, plan=plan, route="wave")
    for reverse in (False, True):
        check_wave(tuple(a[int(reverse)] for a in args), dtype, reverse,
                   plan=plan, route="wave")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wave128_tile_gives_the_same_bits_run_to_run(cuda, dtype):
    """No atomics, no order that changes: the same inputs give the same ys,
    hT and cT bits on every launch of the H = 128 tile."""
    args = inputs((2,), 11, 4099, 128, dtype, cuda, 7)
    outs = [lstm_cuda.lstm_fwd_bidir(*args, route="wave",
                                     plan=lstm_cuda.WAVE128_ROWS[0])
            for _ in range(3)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_wave_custom_op_in_a_cuda_graph(cuda):
    """The custom op (kernels/ops.py) at the 16-slot tick's narrow band,
    captured in a CUDA graph after one eager call: a replay with new
    inputs in the static buffers equals the plain version and moves no
    launch counter (the kernel allocates nothing and never
    synchronises)."""
    from fnssl_tpu_torch.kernels import ops

    static = list(inputs((), 12, 4096, 256, "float32", cuda, 3))
    ops.lstm_fwd(*static)                       # eager: attributes set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.lstm_fwd(*static)                   # warm-up on the stream
        with torch.cuda.graph(graph, stream=stream):
            outs = ops.lstm_fwd(*static)
    torch.cuda.current_stream().wait_stream(stream)
    fresh = inputs((), 12, 4096, 256, "float32", cuda, 4)
    for buf, new in zip(static, fresh):
        buf.copy_(new)
    before = (lstm_cuda.launches.value, lstm_cuda.launches_wave.value)
    graph.replay()
    torch.cuda.synchronize()
    assert (lstm_cuda.launches.value,
            lstm_cuda.launches_wave.value) == before
    assert_close(outs, lstm_cuda.lstm_fwd_plain(*fresh), "float32",
                 "graph replay")


# K2, the backward recurrence (kernels/csrc/lstm_bwd_cluster.cu and
# kernels/csrc/lstm_bwd_wave.cu, which lstm_bwd and lstm_bwd_bidir launch as
# bwd_route gives them or as route= names them).
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
              plan=None, route="cluster", **kw):
    before = counter.value
    got = fn(args[0].clone(), *args[1:], route=route, plan=plan, **kw)
    assert counter.value == before + 1
    want = plain(args[0].clone(), *args[1:], **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dgates", "dh0", "dc0"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = (g - w).abs().max().item() if g.numel() else 0.0
        assert err <= BWD_TOL, (what, name, err)


def check_bwd_wave(args, what, plan=None):
    """lstm_bwd_wave.cu through both entry points: both directions in one
    launch, and each direction alone with its own walk."""
    kw = {"counter": lstm_cuda.launches_bwd_wave, "plan": plan,
          "route": "wave"}
    check_bwd(lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain, args,
              what, **kw)
    for reverse in (False, True):
        check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                  tuple(a[int(reverse)] for a in args), (what, reverse),
                  reverse=reverse, **kw)


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
@pytest.mark.parametrize("hidden", [32, 64, 128, 256])
def test_bwd_wave_kernel_edge_cases(cuda, dtype, hidden):
    """lstm_bwd_wave.cu at ragged B (and one row past its largest tile at
    this width), short T, both entry points, both walks, nonzero
    c0/dhT/dcT."""
    seed = 100
    past = lstm_cuda.bwd_wave_tile(
        hidden, max(lstm_cuda.bwd_wave_plans(hidden, 4))) + 1
    for b in (1, 11, 13, 17, past):
        for t_steps in (1, 2, 7):
            seed += 1
            check_bwd_wave(bwd_inputs((2,), t_steps, b, hidden, dtype,
                                      cuda, seed), (b, t_steps))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 64, 128, 256])
def test_bwd_wave_every_plan_matches_plain(cuda, dtype, hidden):
    """Every plan lstm_bwd_wave.cu takes gives the same answer, at a ragged
    B of several tiles: 4 rows a thread (5 with a bfloat16 dy too), and at
    H = 128 every tile of its own kernel (10 to 40 rows)."""
    itemsize = 4 if dtype == "float32" else 2
    args = bwd_inputs((2,), 9, 77, hidden, dtype, cuda, 3)
    plans = lstm_cuda.bwd_wave_plans(hidden, itemsize)
    assert plans == (lstm_cuda.BWD_WAVE128_TILES if hidden == 128 else
                     (4,) if dtype == "float32" else (4, 5))
    for plan in plans:
        check_bwd_wave(args, plan, plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 16 * 298, 128, 2),
                                   (298, 16 * 256, 256, 1),
                                   (298, 8 * 256, 256, 1)])
def test_bwd_wave_kernel_at_training_shapes(cuda, dtype, shape):
    """lstm_bwd_wave.cu at FN-SSL's training shapes (nb=16) and a DP rank's
    narrow band (nb=8), forced onto it where the rule keeps a shape on
    lstm_bwd_cluster.cu."""
    t_steps, b, h, ndir = shape
    args = bwd_inputs((ndir,), t_steps, b, h, dtype, cuda, 5)
    kw = {"counter": lstm_cuda.launches_bwd_wave, "route": "wave"}
    if ndir == 2:
        check_bwd(lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain,
                  args, shape, **kw)
    else:
        check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                  tuple(a[0] for a in args), shape, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_wave_gives_the_same_bits_run_to_run(cuda, dtype):
    """No atomics: the same inputs give the same dgates, dh0 and dc0 bits
    on every launch, at a ragged B of several tiles."""
    args = bwd_inputs((2,), 11, 4099, 256, dtype, cuda, 7)
    outs = [lstm_cuda.lstm_bwd_bidir(args[0].clone(), *args[1:],
                                     route="wave") for _ in range(3)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 16 * 298, 128, 2),
                                   (256, 16 * 298 - 13, 128, 2),
                                   (280, 16 * 256, 128, 1)])
def test_bwd_wave128_tile_at_its_shapes(cuda, dtype, shape):
    """lstm_bwd_wave.cu's H = 128 tiles at the plan's tile for FN-SSL's full
    band in training (38 rows), a ragged B under it and IPDnet's narrow
    band (16 rows)."""
    t_steps, b, h, ndir = shape
    args = bwd_inputs((ndir,), t_steps, b, h, dtype, cuda, 6)
    plan = lstm_cuda.bwd_wave_plan(h, 4, b, ndir)
    assert plan in lstm_cuda.BWD_WAVE128_TILES
    kw = {"counter": lstm_cuda.launches_bwd_wave, "route": "wave",
          "plan": plan}
    if ndir == 2:
        check_bwd(lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain,
                  args, shape, **kw)
    else:
        check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                  tuple(a[0] for a in args), shape, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_wave128_gives_the_same_bits_run_to_run(cuda, dtype):
    """No atomics: the same inputs give the same dgates, dh0 and dc0 bits
    on every launch of the H = 128 tile, at a ragged B of several tiles."""
    args = bwd_inputs((2,), 11, 4099, 128, dtype, cuda, 7)
    outs = [lstm_cuda.lstm_bwd_bidir(args[0].clone(), *args[1:],
                                     route="wave", plan=38)
            for _ in range(3)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            assert torch.equal(got, want)


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
    """FN-SSL's two training shapes at nb=16, fp32, on the kernel bwd_route
    gives each: a BiLSTM over frequency (one launch) and an LSTM over
    time."""
    t_steps, b, h, ndir = shape
    args = bwd_inputs((ndir,), t_steps, b, h, "float32", cuda)
    route = lstm_cuda.bwd_route(t_steps, b, h, ndir, 4)
    counter = lstm_cuda.BWD_COUNTERS[lstm_cuda.BWD_SOURCES[route]]
    kw = {"counter": counter, "route": None}
    if ndir == 2:
        check_bwd(lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain,
                  args, shape, **kw)
    else:
        check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                  tuple(a[0] for a in args), shape, **kw)


@pytest.mark.cuda
def test_bwd_plan_that_does_not_fit_is_refused(cuda):
    """A plan lstm_bwd_cluster.cu does not take raises, never runs another
    way, and counts no launch."""
    args = bwd_inputs((2,), 3, 4, 256, "float32", cuda)
    before = (lstm_cuda.launches_bwd_wave.value,
              lstm_cuda.launches_bwd_cluster.value)
    with pytest.raises(RuntimeError, match="lstm_bwd_cluster launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, plan=(4, 8, 16, 1))  # 1024 threads
    with pytest.raises(RuntimeError, match="lstm_bwd_cluster launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, plan=(8, 16, 16, 1))  # 16-row tiles
    with pytest.raises(RuntimeError, match="lstm_bwd_cluster launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, plan=(4, 8, 16, 2))  # 352 KB fp32
    with pytest.raises(RuntimeError, match="lstm_bwd_wave launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, route="wave", plan=8)  # not built
    with pytest.raises(RuntimeError, match="lstm_bwd_wave launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, route="wave", plan=5)  # fp32 dy
    args = bwd_inputs((2,), 3, 4, 128, "float32", cuda)
    with pytest.raises(RuntimeError, match="lstm_bwd_wave launch failed"):
        # H = 128 takes its own tiles only
        lstm_cuda.lstm_bwd_bidir(*args, route="wave", plan=4)
    assert (lstm_cuda.launches_bwd_wave.value,
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
    counters = (lstm_cuda.launches, lstm_cuda.launches_wide,
                lstm_cuda.launches_bwd_wave, lstm_cuda.launches_bwd_cluster)
    before = [c.value for c in counters]
    state, loss = train(state, batch,
                        torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert [c.value - b for c, b in zip(counters, before)] == [6, 0, 0, 6]
    assert state.step == 1 and torch.isfinite(loss)


@pytest.mark.cuda
def test_backward_above_256_is_refused(cuda):
    """The CUDA backward serves H up to 1024 (lstm_bwd_wide.cu above 256);
    a wider one raises instead of running elsewhere, through both entry
    points and through an LSTM layer, whose forward refuses it first."""
    from fnssl_tpu_torch.models.lstm import LSTM

    counters = (lstm_cuda.launches_bwd_wave, lstm_cuda.launches_bwd_cluster,
                lstm_cuda.launches_bwd_wide, lstm_cuda.launches_wide)
    before = [c.value for c in counters]
    args = bwd_inputs((2,), 3, 4, 1056, "float32", cuda)
    with pytest.raises(ValueError, match="up to 1024"):
        lstm_cuda.lstm_bwd_bidir(*args)
    with pytest.raises(ValueError, match="up to 1024"):
        lstm_cuda.lstm_bwd(*(a[0] for a in args))
    layer = LSTM(4, 1056, device=cuda)
    with pytest.raises(ValueError, match="up to 1024"):
        layer(torch.randn(2, 3, 4, device=cuda))
    assert [c.value for c in counters] == before


# K2 above H = 256: kernels/csrc/lstm_bwd_wide.cu, which bwd_route gives
# every H from 288 to 1024. Tolerance: BWD_TOL, as lstm_bwd_wave.cu's.


def check_bwd_wide(args, what, plan=None, route="wide"):
    """lstm_bwd_wide.cu through both entry points: both directions in one
    launch, and each direction alone with its own walk."""
    kw = {"counter": lstm_cuda.launches_bwd_wide, "plan": plan,
          "route": route}
    check_bwd(lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain, args,
              what, **kw)
    for reverse in (False, True):
        check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                  tuple(a[int(reverse)] for a in args), (what, reverse),
                  reverse=reverse, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_wide_kernel_at_the_path_shape(cuda, dtype):
    """FN-SSL's narrow band at hidden_size 512 in training (298, 4096,
    512), on the kernel bwd_route gives it, with its rule's plan."""
    args = bwd_inputs((1,), 298, 4096, 512, dtype, cuda, 5)
    assert lstm_cuda.bwd_route(298, 4096, 512, 1, 4) == "wide"
    check_bwd(lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
              tuple(a[0] for a in args), "train narrow band H 512",
              counter=lstm_cuda.launches_bwd_wide, route=None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [288, 384, 512, 768, 1024])
def test_bwd_wide_kernel_edge_cases(cuda, dtype, hidden):
    """lstm_bwd_wide.cu at ragged B (and one row past its largest tile at
    this width), short T, both entry points, both walks, nonzero
    c0/dhT/dcT; at H 768 and 1024 a lane owns two columns."""
    seed = 200 + hidden
    past = lstm_cuda.bwd_wide_tile(max(lstm_cuda.bwd_wide_plans(hidden))) + 1
    for b in (1, 11, 13, 17, past):
        for t_steps in (1, 2, 7):
            seed += 1
            check_bwd_wide(bwd_inputs((2,), t_steps, b, hidden, dtype, cuda,
                                      seed), (hidden, b, t_steps), route=None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [288, 512, 544, 1024])
def test_bwd_wide_every_plan_matches_plain(cuda, dtype, hidden):
    """Every plan lstm_bwd_wide.cu takes gives the same answer, at a ragged
    B of several tiles (544: 17 columns, the last warp's second one past
    H)."""
    args = bwd_inputs((2,), 9, 77, hidden, dtype, cuda, 3)
    plans = lstm_cuda.bwd_wide_plans(hidden)
    assert plans == ((4, 2, 1) if hidden <= 512 else (2, 1))
    for plan in plans:
        check_bwd_wide(args, (hidden, plan), plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [512, 1024])
def test_bwd_wide_every_plan_at_the_edges(cuda, dtype, hidden):
    """Every plan at the edge B (1, 13, one row short of its tile and one
    past it) and T (1, 2), through both entry points and both walks: the
    masked rows of the stage and of dc in shared memory."""
    seed = 300 + hidden
    for plan in lstm_cuda.bwd_wide_plans(hidden):
        tile = lstm_cuda.bwd_wide_tile(plan)
        for b in sorted({1, 13, tile - 1, tile + 1}):
            for t_steps in (1, 2):
                seed += 1
                check_bwd_wide(bwd_inputs((2,), t_steps, b, hidden, dtype,
                                          cuda, seed),
                               (hidden, plan, b, t_steps), plan=plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [512, 1024])
def test_bwd_wide_gives_the_same_bits_run_to_run(cuda, dtype, hidden):
    """No atomics: the same inputs give the same dgates, dh0 and dc0 bits
    on every launch, at a ragged B of several tiles, with every plan."""
    args = bwd_inputs((2,), 11, 4099 if hidden == 512 else 517, hidden,
                      dtype, cuda, 7)
    for plan in lstm_cuda.bwd_wide_plans(hidden):
        outs = [lstm_cuda.lstm_bwd_bidir(args[0].clone(), *args[1:],
                                         plan=plan) for _ in range(3)]
        torch.cuda.synchronize()
        for out in outs[1:]:
            for got, want in zip(out, outs[0]):
                assert torch.equal(got, want), plan


@pytest.mark.cuda
def test_bwd_wide_refuses_what_it_does_not_take(cuda):
    """A plan lstm_bwd_wide.cu is not built for raises, and so does a route
    of another source above H = 256 or of this one below; none runs
    another way or counts a launch."""
    counters = (lstm_cuda.launches_bwd_wave, lstm_cuda.launches_bwd_cluster,
                lstm_cuda.launches_bwd_wide)
    before = [c.value for c in counters]
    args = bwd_inputs((2,), 3, 4, 768, "float32", cuda)
    with pytest.raises(RuntimeError, match="lstm_bwd_wide launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, plan=4)       # two columns a lane
    with pytest.raises(RuntimeError, match="lstm_bwd_wide launch failed"):
        lstm_cuda.lstm_bwd_bidir(*args, plan=3)
    for route in ("wave", "cluster"):
        with pytest.raises(ValueError, match="no route"):
            lstm_cuda.lstm_bwd_bidir(*args, route=route)
    args = bwd_inputs((2,), 3, 4, 256, "float32", cuda)
    with pytest.raises(ValueError, match="no route"):
        lstm_cuda.lstm_bwd_bidir(*args, route="wide")
    assert [c.value for c in counters] == before


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [48, 512])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_wide_and_padded_lstm_function_on_card_matches_cpu(cuda, hidden,
                                                          bidirectional):
    """models.lstm's autograd Function at H 512 (K1 on lstm_wide.cu, K2 on
    lstm_bwd_wide.cu) and at H 48 (both padded to 64, on the cluster
    kernels) against the plain versions on the CPU, values and every
    gradient within 1e-4 of their largest magnitude (at least 1e-4)."""
    from fnssl_tpu_torch.models.lstm import lstm

    ndir = 2 if bidirectional else 1
    want_launches = ({"launches_wide": 1, "launches_bwd_wide": 1}
                     if hidden == 512 else
                     {"launches": 1, "launches_bwd_cluster": 1})
    counters = ("launches", "launches_wide", "launches_bwd_cluster",
                "launches_bwd_wave", "launches_bwd_wide")
    results = []
    for device in (cuda, torch.device("cpu")):
        params, x, state, wy = lstm_case(device, bidirectional, seed=1,
                                         h=hidden)
        before = {c: getattr(lstm_cuda, c).value for c in counters}
        out, st = lstm(params, x, state, bidirectional)
        ((out * wy).sum() + st.h.sum() + (st.c * 0.5).sum()).backward()
        moved = {c: getattr(lstm_cuda, c).value - before[c]
                 for c in counters}
        assert {c: n for c, n in moved.items() if n} == (
            want_launches if device.type == "cuda" else {})
        results.append([out, st.h, st.c, x.grad, state.h.grad, state.c.grad]
                       + [p.grad for p in params.values()])
    for got, want in zip(*results):
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_train_step_launch_counts_at_hidden_512(cuda):
    """One train step of FN-SSL at hidden_size 512 (full-band H 256 both
    directions, narrow-band H 512; nb 1 x 0.4 s): 3 K1 on lstm_cluster.cu
    and 3 on lstm_wide.cu, 3 K2 on lstm_bwd_cluster.cu and 3 on
    lstm_bwd_wide.cu."""
    from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
    from fnssl_tpu_torch.train import step, tasks

    cfg = FNSSLConfig(hidden_size=512)
    model = FNSSL(cfg, device=cuda,
                  generator=torch.Generator().manual_seed(0))
    tx = step.make_optimizer("adam", 1e-3, 0.8988, 1)
    state = step.init_train_state(model, tx)
    train = step.make_train_step(tasks.make_fnssl_task(cfg).loss_fn, tx)
    batch = tasks.synthetic_fnssl_batch(nb=1, t_s=0.4, seed=1)
    counters = (lstm_cuda.launches, lstm_cuda.launches_wide,
                lstm_cuda.launches_bwd_wave, lstm_cuda.launches_bwd_cluster,
                lstm_cuda.launches_bwd_wide)
    before = [c.value for c in counters]
    state, loss = train(state, batch,
                        torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert [c.value - b for c, b in zip(counters, before)] == [3, 3, 0, 3, 3]
    assert state.step == 1 and torch.isfinite(loss)


# K1 above H = 256: kernels/csrc/lstm_wide.cu, which fwd_route gives every H
# from 288 to 1024. The same tolerances as the cluster kernel's.


def check_wide(args, dtype, reverse=None, plan=None, route=None):
    """lstm_fwd (one direction, `reverse` given) or lstm_fwd_bidir (args
    stacked for 2) on lstm_wide.cu: one launch of it, none of another K1
    kernel, and the plain version's answer; returns the largest |kernel -
    plain| of ys."""
    counters = (lstm_cuda.launches, lstm_cuda.launches_wave,
                lstm_cuda.launches_wide)
    before = [c.value for c in counters]
    if reverse is None:
        got = lstm_cuda.lstm_fwd_bidir(*args, plan=plan, route=route)
        want = lstm_cuda.lstm_fwd_bidir_plain(*args)
    else:
        got = lstm_cuda.lstm_fwd(*args, reverse=reverse, plan=plan,
                                 route=route)
        want = lstm_cuda.lstm_fwd_plain(*args, reverse=reverse)
    assert [c.value - b for c, b in zip(counters, before)] == [0, 0, 1]
    assert_close(got, want, dtype, ("lstm_wide", reverse, plan))
    diff = (got[0].float() - want[0].float()).abs()
    return diff.max().item() if diff.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(298, 16 * 256, 512, 1),
                                   (298, 2048, 512, 2), (124, 256, 512, 1)])
def test_wide_kernel_at_the_path_shapes(cuda, dtype, shape):
    """FN-SSL's narrow band at hidden_size 512 in training (298, 4096,
    512), its parity step's (124, 256, 512) and two directions of 2048
    rows, on the kernel fwd_route gives them with its rule's plan; both
    walks one direction a launch."""
    t_steps, b, h, ndir = shape
    assert lstm_cuda.fwd_route(t_steps, b, h, ndir, 4) == "wide"
    args = inputs((2,), t_steps, b, h, dtype, cuda, 11)
    if ndir == 2:
        err = check_wide(args, dtype)
    else:
        err = max(check_wide(tuple(a[int(r)] for a in args), dtype, r)
                  for r in (False, True))
    print(f"lstm_wide {shape} {dtype}: max |kernel - plain| of ys {err:.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [288, 512, 800, 1024])
def test_wide_kernel_edge_cases(cuda, dtype, hidden):
    """lstm_wide.cu through the rule at ragged B (1, 13, and one row past
    its largest tile at this width), short T (T = 0 returns h0, c0), both
    entry points and walks; at 288 and 800 the last pass of 256 units is
    partly past H."""
    seed = 300 + hidden
    past = max(r for r in lstm_cuda.WIDE_ROWS
               if lstm_cuda.wide_fits(hidden, r)) + 1
    for b in (1, 13, past):
        for t_steps in (0, 1, 2, 7):
            seed += 1
            args = inputs((2,), t_steps, b, hidden, dtype, cuda, seed)
            check_wide(args, dtype)
            for reverse in (False, True):
                check_wide(tuple(a[1] for a in args), dtype, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [288, 512, 800, 1024])
def test_wide_every_plan_matches_plain(cuda, dtype, hidden):
    """Every tile lstm_wide.cu takes at this H gives the same answer, at a
    ragged B of several tiles, both directions in one launch and one."""
    args = inputs((2,), 9, 77, hidden, dtype, cuda, 5)
    plans = [r for r in lstm_cuda.WIDE_ROWS if lstm_cuda.wide_fits(hidden, r)]
    assert plans == ([32, 16, 8, 4] if hidden <= 544 else [16, 8, 4])
    for plan in plans:
        check_wide(args, dtype, plan=plan, route="wide")
        check_wide(tuple(a[1] for a in args), dtype, True, plan=plan,
                   route="wide")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_gives_the_same_bits_run_to_run(cuda, dtype):
    """No atomics, no order that changes: the same inputs give the same ys,
    hT and cT bits on every launch, at a ragged B of several tiles."""
    args = inputs((2,), 11, 4099, 512, dtype, cuda, 7)
    outs = [lstm_cuda.lstm_fwd_bidir(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for got, want in zip(out, outs[0]):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_wide_refuses_what_it_does_not_take(cuda):
    """A tile lstm_wide.cu is not built for, or whose shared memory does
    not fit (32 rows at H 1024), raises; so does a route of another
    source above H = 256 or of this one below; none runs another way or
    counts a launch."""
    counters = (lstm_cuda.launches, lstm_cuda.launches_wave,
                lstm_cuda.launches_wide)
    before = [c.value for c in counters]
    args = inputs((2,), 3, 4, 1024, "float32", cuda)
    for plan in (32, 12):
        with pytest.raises(RuntimeError, match="lstm_wide launch failed"):
            lstm_cuda.lstm_fwd_bidir(*args, plan=plan)
    for route in ("wave", "cluster"):
        with pytest.raises(ValueError, match="no route"):
            lstm_cuda.lstm_fwd_bidir(*args, route=route)
    args = inputs((2,), 3, 4, 256, "float32", cuda)
    with pytest.raises(ValueError, match="no route"):
        lstm_cuda.lstm_fwd_bidir(*args, route="wide")
    assert [c.value for c in counters] == before
