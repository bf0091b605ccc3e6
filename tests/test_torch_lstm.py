"""Port LSTM (fnssl_tpu_torch.models.lstm + kernels.lstm_cuda) against
fnssl_tpu on the CPU, where the wrapper runs the kernel's plain version:
JAX ``lstm``, the Pallas kernel in interpret mode, and ``torch.nn.LSTM``.

Tolerance: float32 rtol 1e-5 / atol 1e-6 (the same recurrence, summed in
another order); bf16 xg outputs within one bf16 rounding (atol 1e-2).
tests/test_torch_kernels_cuda.py holds the Hopper kernel itself against
the plain version on the card.
"""
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
