"""Port LSTM (fnssl_tpu_torch.models.lstm + kernels.lstm_cuda) against
fnssl_tpu on the CPU, where the wrapper runs the kernel's plain version:
JAX ``lstm``, the Pallas kernel in interpret mode, and ``torch.nn.LSTM``.

Tolerance: float32 rtol 1e-5 / atol 1e-6 (the same recurrence, summed in
another order); bf16 xg outputs within one bf16 rounding (atol 1e-2).
tests/test_torch_kernels_cuda.py holds the Hopper kernel itself against
the plain version on the card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.kernels.lstm_pallas import _lstm_pallas_fwd
from fnssl_tpu.models.lstm import LSTMState as JState
from fnssl_tpu.models.lstm import lstm as jlstm
from fnssl_tpu_torch.kernels import lstm_cuda
from fnssl_tpu_torch.models.lstm import LSTM, LSTMState, lstm

RTOL, ATOL = 1e-5, 1e-6


def weights(rng, i, h, bidirectional):
    names = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]
    shapes = [(4 * h, i), (4 * h, h), (4 * h,), (4 * h,)]
    out = {}
    for suffix in [""] + (["_reverse"] if bidirectional else []):
        for n, s in zip(names, shapes):
            out[n + suffix] = (rng.standard_normal(s) * 0.3).astype(
                np.float32)
    return out


def to_t(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def to_j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("t_steps", [1, 2, 7])
@pytest.mark.parametrize("batch", [4, 11])
def test_lstm_matches_jax(rng, bidirectional, t_steps, batch):
    """Ragged B, short T, nonzero h0/c0, both directions."""
    i, h = 5, 8
    ndir = 2 if bidirectional else 1
    w = weights(rng, i, h, bidirectional)
    x = rng.standard_normal((batch, t_steps, i)).astype(np.float32)
    h0 = rng.standard_normal((ndir, batch, h)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((ndir, batch, h)).astype(np.float32) * 0.5
    got, gs = lstm(to_t(w), torch.as_tensor(x),
                   LSTMState(torch.as_tensor(h0), torch.as_tensor(c0)),
                   bidirectional)
    want, ws = jlstm(to_j(w), jnp.asarray(x),
                     JState(jnp.asarray(h0), jnp.asarray(c0)),
                     bidirectional)
    close(got.numpy(), want)
    close(gs.h.numpy(), ws.h)
    close(gs.c.numpy(), ws.c)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_recurrence_matches_pallas_interpret(rng, reverse, dtype):
    """lstm_fwd (plain on the CPU) against the TPU kernel run in
    interpret mode, on the same xg (T, B, 4H)."""
    t_steps, b, h = 7, 11, 8
    xg = rng.standard_normal((t_steps, b, 4 * h)).astype(np.float32)
    w_hh_t = (rng.standard_normal((h, 4 * h)) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((b, h)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((b, h)).astype(np.float32) * 0.5
    tdt = getattr(torch, dtype)
    xg_t = torch.as_tensor(xg).to(tdt)
    w_t = torch.as_tensor(w_hh_t).to(tdt)
    before = lstm_cuda.launches.value
    ys, h_t, c_t = lstm_cuda.lstm_fwd(xg_t, w_t, torch.as_tensor(h0),
                                      torch.as_tensor(c0), reverse=reverse)
    assert lstm_cuda.launches.value == before     # plain version: no launch
    assert ys.dtype == tdt and h_t.dtype == torch.float32
    # feed JAX the same (rounded) inputs
    jx = jnp.asarray(xg_t.float().numpy()).astype(dtype)
    jw = jnp.asarray(w_t.float().numpy()).astype(dtype)
    wys, wh, wc = _lstm_pallas_fwd(jx, jw, jnp.asarray(h0), jnp.asarray(c0),
                                   reverse=reverse, block_b=8,
                                   interpret=True)
    atol = ATOL if dtype == "float32" else 1e-2
    close(ys.float().numpy(), np.asarray(wys.astype(jnp.float32)),
          atol=atol)
    close(h_t.numpy(), wh, atol=ATOL if dtype == "float32" else 1e-5)
    close(c_t.numpy(), wc, atol=ATOL if dtype == "float32" else 1e-5)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_module_matches_torch_nn_lstm(rng, bidirectional):
    i, h, b, t = 6, 16, 5, 9
    mod = LSTM(i, h, bidirectional, device="cpu",
               generator=torch.Generator().manual_seed(0))
    ref = torch.nn.LSTM(i, h, batch_first=True, bidirectional=bidirectional)
    ref.load_state_dict(mod.state_dict(), strict=True)
    x = torch.as_tensor(rng.standard_normal((b, t, i)).astype(np.float32))
    with torch.no_grad():
        got, st = mod(x)
        want, (wh, wc) = ref(x)
    close(got.numpy(), want.numpy())
    close(st.h.numpy(), wh.numpy())
    close(st.c.numpy(), wc.numpy())


def test_lstm_chunked_matches_one_shot(rng):
    w = to_t(weights(rng, 5, 8, False))
    x = torch.as_tensor(rng.standard_normal((3, 20, 5)).astype(np.float32))
    one, one_s = lstm(w, x)
    state, parts = None, []
    for lo, hi in ((0, 12), (12, 13), (13, 20)):
        y, state = lstm(w, x[:, lo:hi], state)
        parts.append(y)
    close(torch.cat(parts, 1).numpy(), one.numpy())
    close(state.h.numpy(), one_s.h.numpy())


def test_lstm_module_seeded_init_and_names():
    def make():
        return LSTM(4, 32, True, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    a, b = make(), make()
    assert sorted(a.state_dict()) == sorted(
        torch.nn.LSTM(4, 32, bidirectional=True).state_dict())
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
        assert v.abs().max() <= 1 / np.sqrt(32)


def test_lstm_fwd_checks_its_inputs():
    xg = torch.zeros(3, 2, 32)
    w = torch.zeros(8, 32)
    s = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd(torch.zeros(3, 2, 30), w, s, s)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_fwd(xg.double(), w.double(), s, s)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_fwd(xg, w.bfloat16(), s, s)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd(xg, w, torch.zeros(3, 8), s)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd(xg, w, s, s.double())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t_steps", [0, 1, 2, 7])
def test_bidir_plain_is_two_directions(rng, dtype, t_steps):
    """lstm_fwd_bidir (plain on the CPU) is lstm_fwd_plain forward on
    direction 0 and backward on direction 1, exactly; no launch."""
    b, h = 11, 8
    tdt = getattr(torch, dtype)
    xg = torch.as_tensor(rng.standard_normal((2, t_steps, b, 4 * h)),
                         dtype=torch.float32).to(tdt)
    w = torch.as_tensor(rng.standard_normal((2, h, 4 * h)) * 0.3,
                        dtype=torch.float32).to(tdt)
    h0 = torch.as_tensor(rng.standard_normal((2, b, h)) * 0.5,
                         dtype=torch.float32)
    c0 = torch.as_tensor(rng.standard_normal((2, b, h)) * 0.5,
                         dtype=torch.float32)
    before = (lstm_cuda.launches.value, lstm_cuda.launches_wide.value)
    got = lstm_cuda.lstm_fwd_bidir(xg, w, h0, c0)
    assert (lstm_cuda.launches.value, lstm_cuda.launches_wide.value) == before
    fwd = lstm_cuda.lstm_fwd_plain(xg[0], w[0], h0[0], c0[0])
    bwd = lstm_cuda.lstm_fwd_plain(xg[1], w[1], h0[1], c0[1], reverse=True)
    assert got[0].shape == (2, t_steps, b, h) and got[0].dtype == tdt
    for g, f, r in zip(got, fwd, bwd):
        assert torch.equal(g[0], f) and torch.equal(g[1], r)


def test_bidirectional_lstm_makes_one_recurrence_call(rng, monkeypatch):
    """A BiLSTM runs both directions through one lstm_fwd_bidir call (one
    launch on the card) and never through lstm_fwd; a one-direction LSTM
    makes one lstm_fwd call."""
    # the package's ``lstm`` is the function, as in JAX
    lstm_mod = importlib.import_module("fnssl_tpu_torch.models.lstm")

    calls = []

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls.append((name, tuple(args[0].shape)))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(lstm_mod, "lstm_fwd",
                        counted("lstm_fwd", lstm_mod.lstm_fwd))
    monkeypatch.setattr(lstm_mod, "lstm_fwd_bidir",
                        counted("lstm_fwd_bidir", lstm_mod.lstm_fwd_bidir))
    x = torch.as_tensor(rng.standard_normal((3, 7, 5)).astype(np.float32))
    lstm(to_t(weights(rng, 5, 8, True)), x, bidirectional=True)
    assert calls == [("lstm_fwd_bidir", (2, 7, 3, 32))]
    calls.clear()
    lstm(to_t(weights(rng, 5, 8, False)), x)
    assert calls == [("lstm_fwd", (7, 3, 32))]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hidden", range(32, 257, 32))
def test_cluster_plan_fits(hidden, itemsize):
    """Every H the cluster kernel takes has a plan within 227 KB of shared
    memory, <= 512 threads and a portable cluster (N <= 8), at any B."""
    for batch, ndir in ((1, 1), (12, 2), (256, 1), (298, 2), (4096, 1),
                        (4480, 2), (13440, 2)):
        n, bt, ks = lstm_cuda.cluster_plan(hidden, itemsize, batch, ndir)
        units = hidden // n
        assert n in (1, 2, 4, 8) and bt in (8, 16)
        assert hidden % n == 0 and hidden % (4 * ks) == 0
        assert ks * units <= (512 if bt == 8 else 256) and 2 * ks >= bt
        assert lstm_cuda.cluster_smem(hidden, itemsize, n, bt,
                                      ks) <= 227 * 1024


@pytest.mark.parametrize("itemsize", [4, 2])
def test_cluster_plan_takes_its_cluster_by_the_grids_tiles(itemsize):
    """At most as many 8-row tiles (all directions) as SMs: the largest
    cluster that keeps 16 units a CTA (the serve shapes of FN-SSL and
    IPDnet); more: the smallest from N = 2 that fits (the training
    shapes), N = 8 at H = 256 where nothing smaller fits. The k-split is
    H/16, or H/8 where H/16 leaves fewer than 128 threads a CTA."""
    plan = lstm_cuda.cluster_plan
    for h, b, ndir in ((128, 12, 2), (256, 256, 1), (128, 256, 1),
                       (128, 298, 2), (128, 8 * 66, 2)):
        assert plan(h, itemsize, b, ndir) == (8, 8, h // 16)
    assert plan(64, itemsize, 12, 2) == (4, 8, 8)
    for h, b, ndir in ((128, 16 * 298, 2), (64, 16 * 280, 2),
                       (128, 16 * 256, 1), (64, 16 * 256, 2),
                       (64, 48 * 280, 2), (128, 8 * 66 + 1, 2)):
        assert plan(h, itemsize, b, ndir) == (2, 8, h // 16)
    assert plan(256, itemsize, 16 * 256, 1) == (8, 8, 16)


def test_cluster_plan_examples_and_refusals():
    """The two plans worked out by hand for FN-SSL's LSTMs fit as stated
    (208 KB), and H the cluster kernel does not take is refused."""
    assert lstm_cuda.cluster_smem(128, 4, 4, 16, 16) == 208 * 1024
    assert lstm_cuda.cluster_smem(256, 4, 8, 8, 16) == 208 * 1024
    for hidden in (16, 48, 288, 512):
        with pytest.raises(ValueError):
            lstm_cuda.cluster_plan(hidden, 4, 12)
    with pytest.raises(ValueError):
        lstm_cuda.cluster_plan(128, 4, 12, n=3)
    with pytest.raises(ValueError):
        lstm_cuda.cluster_plan(256, 4, 12, n=1)   # W_hh slice: 1 MB


def test_lstm_fwd_bidir_checks_its_inputs():
    xg = torch.zeros(2, 3, 2, 32)
    w = torch.zeros(2, 8, 32)
    s = torch.zeros(2, 2, 8)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd_bidir(xg[0], w[0], s[0], s[0])
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd_bidir(torch.zeros(3, 3, 2, 32), w, s, s)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd_bidir(xg, w[:1], s, s)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_fwd_bidir(xg, w.bfloat16(), s, s)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_fwd_bidir(xg, w, s[:1], s)
