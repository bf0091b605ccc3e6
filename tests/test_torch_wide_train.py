"""Train steps at the shapes this port's kernels take since the last
shape limits fell, against fnssl_tpu on the CPU: FN-SSL at
``hidden_size=512`` (narrow-band LSTMs of H 512, whose backward runs on
lstm_bwd_wide.cu on the card, and full-band BiLSTMs of H 256) and
IPDnet2 with ``attention="mamba(32,4)"`` and ``"mamba(24,4)"`` (the fused
scan at d_state 32, and at 24, which the card runs padded to 32). The
same weights (JAX's init → numpy → state dict, or the port's → numpy →
JAX pytree) and the same numpy batch, dropout off.

Small sizes: FN-SSL nb 1 × 0.4 s (24 frames, 2 output frames) at the
published width but hidden_size; SpatialNet at 2 layers, hidden 16, a
3-mic subset, nb 2 × 0.5 s.

Tolerances: the loss within 1e-5 relative; every gradient within 1e-4 of
its largest magnitude (float32 sums in another order; at hidden 512 the
narrow band sums 512 units a gate); FN-SSL's parameters after two Adam
steps within 1e-5 (lr 1e-3), IPDnet2's after two AdamW steps within 1e-4
(lr 5e-4), as tests/test_torch_train.py and
tests/test_torch_ipdnet2_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.spatialnet as js
import fnssl_tpu_torch.models.spatialnet as ts
from fnssl_tpu.data.arrays import audiowu_high_array_geometry
from fnssl_tpu.models.fnssl import FNSSLConfig as JConfig
from fnssl_tpu.models.fnssl import init_fnssl_params
from fnssl_tpu.train import step as jstep
from fnssl_tpu.train import tasks as jtasks
from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
from fnssl_tpu_torch.train import step as tstep
from fnssl_tpu_torch.train import tasks as ttasks
from fnssl_tpu_torch.train.convert import nested_to_flat, params_to_state_dict
from tests.test_torch_threads import torch_threads  # noqa: F401

WIDE = 512


def close_to_largest(got, want, what, tol=1e-4):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} of largest {scale:.3e}"


def test_fnssl_at_hidden_512_trains_as_jax():
    """Loss and every gradient against ``jax.value_and_grad`` of JAX's
    task, then two Adam steps through both packages' make_train_step."""
    params = jax.tree.map(np.asarray, init_fnssl_params(
        jax.random.PRNGKey(0), JConfig(hidden_size=WIDE)))
    b = ttasks.synthetic_fnssl_batch(nb=1, t_s=0.4, seed=1)
    jtask = jtasks.make_fnssl_task(JConfig(hidden_size=WIDE))
    model = FNSSL(FNSSLConfig(hidden_size=WIDE), device="cpu")
    model.load_state_dict(params_to_state_dict(params), strict=True)
    assert model.state_dict()["block_1.narrLstm.weight_hh_l0"].shape == (
        4 * WIDE, WIDE)
    task = ttasks.make_fnssl_task(FNSSLConfig(hidden_size=WIDE),
                                  device="cpu")

    jloss, jgrads = jax.value_and_grad(jtask.loss_fn)(
        jax.tree.map(jnp.asarray, params), b, None)
    loss = task.loss_fn(model, b)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    want = nested_to_flat(jax.tree.map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        close_to_largest(p.grad.numpy(), want[k], k)

    model.zero_grad(set_to_none=True)
    jtx = jstep.make_optimizer("adam", 1e-3, 0.8988, 1)
    jstate = jstep.init_train_state(jax.tree.map(jnp.asarray, params), jtx)
    jfn = jstep.make_train_step(jtask.loss_fn, jtx, donate=False)
    tx = tstep.make_optimizer("adam", 1e-3, 0.8988, 1)
    state = tstep.init_train_state(model, tx)
    fn = tstep.make_train_step(task.loss_fn, tx)
    for _ in range(2):
        jstate, jloss = jfn(jstate, b, None)
        state, loss = fn(state, b)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = nested_to_flat(jax.tree.map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


SMALL = dict(dim_input=6, dim_output=8, num_layers=2, dim_hidden=16)
NB, T_S = 2, 0.5
MICS = audiowu_high_array_geometry()[[0, 1, 3]]


def jax_params(model):
    """The port model's weights as a JAX parameter pytree."""
    tree = {}
    for name, v in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy().copy()
    return tree


def ipdnet2_batch(seed):
    rng = np.random.default_rng(seed)
    nt2 = int(T_S * 10)
    return {"mic_sig": rng.standard_normal((NB, int(T_S * 16000), 3))
            .astype(np.float32),
            "azi_deg": rng.integers(0, 360, (NB, nt2, 2)).astype(
                np.float32),
            "distance": rng.uniform(0.5, 3.0, (NB, nt2, 2)).astype(
                np.float32),
            "vad": (rng.uniform(0, 1, (NB, nt2, 2)) > 0.4).astype(
                np.float32),
            "mic_pos": (MICS[None] + rng.normal(0, 0.005, (NB, 3, 3))
                        ).astype(np.float32)}


@pytest.mark.parametrize("attention", ["mamba(32,4)", "mamba(24,4)"])
def test_ipdnet2_at_other_d_state_trains_as_jax(attention):
    """make_ipdnet2_task at d_state 32 and 24: loss and every gradient
    against ``jax.value_and_grad``, then two AdamW steps (clip 5) through
    both packages' make_train_step."""
    cfg = dict(SMALL, attention=attention)
    jt = jtasks.make_ipdnet2_task(js.SpatialNetConfig(**cfg),
                                  mic_location=MICS)
    tt = ttasks.make_ipdnet2_task(ts.SpatialNetConfig(**cfg),
                                  mic_location=MICS, device="cpu")
    model = ts.SpatialNet(ts.SpatialNetConfig(**cfg), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    n = int(attention[6:8])
    assert model.state_dict()["layers.0.mhsa.A_log"].shape[-1] == n
    params = jax_params(model)
    b = ipdnet2_batch(n)

    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(params, b, None)
    loss = tt.loss_fn(model, b)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    want = params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        close_to_largest(p.grad.numpy(), want[k].numpy(), k)

    model.zero_grad(set_to_none=True)
    jtx = jstep.make_optimizer("adamw", 5e-4, 0.975, 1, grad_clip=5.0)
    jstate = jstep.init_train_state(params, jtx)
    jfn = jstep.make_train_step(jt.loss_fn, jtx, donate=False)
    ttx = tstep.make_optimizer("adamw", 5e-4, 0.975, 1, grad_clip=5.0)
    state = tstep.init_train_state(model, ttx)
    fn = tstep.make_train_step(tt.loss_fn, ttx)
    for _ in range(2):
        jstate, jloss = jfn(jstate, b, None)
        state, loss = fn(state, b)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
