"""Gradients of the port's LSTM (models.lstm: LSTMRecurrence, whose
backward recomputes the gates and runs K2's plain version on the CPU)
against ``jax.grad`` through fnssl_tpu's LSTM, whose custom VJP is
``_lstm_backward``. Inputs from a numpy seed; cotangents on ys, hT and cT.

Tolerance: rtol 2e-4 / atol 2e-5, the JAX package's own for its
hand-written backward (tests/test_kernels.py:103).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.kernels.lstm_pallas import lstm_fused_scan
from fnssl_tpu.models.lstm import LSTMState as JState
from fnssl_tpu.models.lstm import lstm as jlstm
from fnssl_tpu_torch.kernels import lstm_cuda
from fnssl_tpu_torch.models.lstm import LSTMRecurrence, LSTMState, lstm

RTOL, ATOL = 2e-4, 2e-5
NAMES = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]


def weights(rng, i, h, bidirectional):
    shapes = [(4 * h, i), (4 * h, h), (4 * h,), (4 * h,)]
    return {n + s: (rng.standard_normal(shape) * 0.3).astype(np.float32)
            for s in [""] + (["_reverse"] if bidirectional else [])
            for n, shape in zip(NAMES, shapes)}


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("t_steps,batch", [(1, 3), (7, 11)])
def test_lstm_grads_match_jax(bidirectional, t_steps, batch):
    """d(loss)/d(every weight, x, h0, c0), loss weighting ys, hT, cT."""
    rng = np.random.default_rng(t_steps + 10 * bidirectional)
    i, h = 5, 8
    ndir = 2 if bidirectional else 1
    w = weights(rng, i, h, bidirectional)
    x = rng.standard_normal((batch, t_steps, i)).astype(np.float32)
    h0, c0, wh, wc = (rng.standard_normal((ndir, batch, h)).astype(
        np.float32) * 0.5 for _ in range(4))
    wy = rng.standard_normal((batch, t_steps, ndir * h)).astype(np.float32)

    def jloss(p, x_, h0_, c0_):
        out, st = jlstm(p, x_, JState(h0_, c0_), bidirectional)
        return ((out * wy).sum() + (st.h * wh).sum() + (st.c * wc).sum())

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        jnp.asarray(h0), jnp.asarray(c0))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    tx, th0, tc0 = (torch.tensor(a, requires_grad=True) for a in (x, h0, c0))
    out, st = lstm(tp, tx, LSTMState(th0, tc0), bidirectional)
    loss = ((out * torch.as_tensor(wy)).sum()
            + (st.h * torch.as_tensor(wh)).sum()
            + (st.c * torch.as_tensor(wc)).sum())
    loss.backward()
    for k in w:
        close(tp[k].grad.numpy(), jgrads[0][k])
    for got, want in zip((tx, th0, tc0), jgrads[1:]):
        close(got.grad.numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
def test_one_direction_both_walks_match_lstm_fused_scan(reverse):
    """LSTMRecurrence with ndir 1 against ``lstm_fused_scan`` with the
    same walk, nonzero h0/c0, cotangents on ys, hT and cT: the walk's
    index shift (h_prev = ys[t+1] when reversed) is where a backward
    goes wrong."""
    rng = np.random.default_rng(3 + reverse)
    b, t, i, h = 6, 9, 5, 8
    arrs = [rng.standard_normal((b, t, i)),
            rng.standard_normal((4 * h, i)) * 0.3,
            rng.standard_normal((4 * h, h)) * 0.3,
            rng.standard_normal(4 * h) * 0.1,
            rng.standard_normal((b, h)) * 0.5,
            rng.standard_normal((b, h)) * 0.5]
    arrs = [a.astype(np.float32) for a in arrs]
    wy = rng.standard_normal((b, t, h)).astype(np.float32)
    wh, wc = (rng.standard_normal((b, h)).astype(np.float32)
              for _ in range(2))

    def jloss(*a):
        ys, h_t, c_t = lstm_fused_scan(*a, reverse)
        return (ys * wy).sum() + (h_t * wh).sum() + (c_t * wc).sum()

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrs))

    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    x, w_ih, w_hh, bias, h0, c0 = ts
    ys, h_t, c_t = LSTMRecurrence.apply(x, w_ih[None], w_hh[None],
                                        bias[None], h0[None], c0[None],
                                        reverse)
    loss = ((ys[0].transpose(0, 1) * torch.as_tensor(wy)).sum()
            + (h_t[0] * torch.as_tensor(wh)).sum()
            + (c_t[0] * torch.as_tensor(wc)).sum())
    loss.backward()
    for got, want in zip(ts, jgrads):
        close(got.grad.numpy(), want)


def test_bf16_x_with_f32_carries():
    """bf16 x and weights with float32 h0/c0 (the bf16 policy's narrow-band
    state): no error, dx in bf16, dh0/dc0 in float32, all finite
    (the JAX regression is tests/test_kernels.py:106-136)."""
    rng = np.random.default_rng(5)
    b, t, i, h = 8, 4, 8, 32
    w = {k: torch.tensor(v, dtype=torch.bfloat16, requires_grad=True)
         for k, v in weights(rng, i, h, False).items()}
    x = torch.tensor(rng.standard_normal((b, t, i)), dtype=torch.bfloat16,
                     requires_grad=True)
    h0 = torch.zeros(1, b, h, requires_grad=True)
    c0 = torch.zeros(1, b, h, requires_grad=True)
    out, st = lstm(w, x, LSTMState(h0, c0))
    assert out.dtype == torch.bfloat16 and st.h.dtype == torch.float32
    (out.float().sum() + st.h.sum()).backward()
    assert x.grad.dtype == torch.bfloat16
    assert h0.grad.dtype == c0.grad.dtype == torch.float32
    assert w["weight_hh_l0"].grad.dtype == torch.bfloat16
    for g in (x.grad, h0.grad, c0.grad, w["weight_ih_l0"].grad):
        assert torch.isfinite(g.float()).all()


def test_bwd_wrappers_take_none_carries_and_write_in_place():
    """lstm_bwd / lstm_bwd_bidir on CPU tensors: dhT, dcT None mean zeros,
    dgates are written over g, and the bidirectional call equals two
    one-direction calls with walks forward and reversed."""
    gen = torch.Generator().manual_seed(0)
    t, b, h = 5, 3, 32
    g = torch.randn(2, t, b, 4 * h, generator=gen)
    w = torch.randn(2, 4 * h, h, generator=gen) / h ** 0.5
    c0 = torch.randn(2, b, h, generator=gen)
    dys = torch.randn(2, t, b, h, generator=gen)
    zeros = torch.zeros(2, b, h)
    want = [lstm_cuda.lstm_bwd(g[d].clone(), w[d], c0[d], dys[d], zeros[d],
                               zeros[d], reverse=bool(d)) for d in range(2)]
    g2 = g.clone()
    out, dh0, dc0 = lstm_cuda.lstm_bwd_bidir(g2, w, c0, dys)
    assert out is g2 and not torch.equal(g2, g)
    for d in range(2):
        torch.testing.assert_close(g2[d], want[d][0], rtol=0, atol=0)
        torch.testing.assert_close(dh0[d], want[d][1], rtol=0, atol=0)
        torch.testing.assert_close(dc0[d], want[d][2], rtol=0, atol=0)
