"""The port's IPDnet training (fnssl_tpu_torch: train.preprocess'
make_ipdnet_preprocess, train.tasks' three IPDnet tasks, through
train.step) against fnssl_tpu on the CPU: the preprocesses, then two
Adam steps (lr 5e-4) of each task from the same weights and batch.

Small sizes: hidden 32, nb 2 × 0.5 s (30 frames, 2 output frames), 2
tracks with VAD drawn so that both the gated IPD and the Bessel fill are
taken; the variable-array task at nch 3 (P = 3 pairs, so that the pair
mean matters).

Tolerances: features and targets atol 1e-5 (as the FN-SSL preprocess);
losses 1e-5 relative; parameters after two Adam steps atol 1e-4, a tenth
of an Adam step's reach (2 steps × lr 5e-4): each step moves a parameter
by ~lr·sign(g), and a gradient within float32 rounding of zero may take
either sign (measured 2.5e-6 to 1.5e-5).
"""

import jax
import numpy as np
import pytest
import torch

import fnssl_tpu.models.ipdnet as jm
import fnssl_tpu_torch.models.ipdnet as tm
from fnssl_tpu.train import step as jstep
from fnssl_tpu.train import tasks as jtasks
from fnssl_tpu_torch.train import step as tstep
from fnssl_tpu_torch.train import tasks as ttasks
from fnssl_tpu_torch.train.convert import params_to_state_dict
from tests.test_torch_threads import torch_threads  # noqa: F401


HIDDEN, NB, T_S = 32, 2, 0.5
MICS_3 = np.array([[-0.06, 0.0, 0.0], [0.0, 0.0, 0.0], [0.06, 0.0, 0.0]])


def jax_params(model):
    """The port model's weights as a JAX parameter pytree (nested dicts
    of numpy arrays by the state-dict names; JAX's own init is held
    against the port in test_torch_ipdnet.py)."""
    tree = {}
    for name, v in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy().copy()
    return tree


def make(which):
    """(JAX task, port task, JAX params, port model with those weights,
    channels)."""
    gen = torch.Generator().manual_seed(0)
    if which == "variable_ipdnet":
        jt = jtasks.make_variable_ipdnet_task(
            jm.VariableIPDnetConfig(hidden_size=HIDDEN), mic_location=MICS_3)
        tt = ttasks.make_variable_ipdnet_task(
            tm.VariableIPDnetConfig(hidden_size=HIDDEN), mic_location=MICS_3,
            device="cpu")
        model = tm.VariableIPDnet(tt.cfg, device="cpu", generator=gen)
        nch = 3
    else:
        online = which == "ipdnet"
        jmake = (jtasks.make_ipdnet_task if online
                 else jtasks.make_ipdnet_offline_task)
        tmake = (ttasks.make_ipdnet_task if online
                 else ttasks.make_ipdnet_offline_task)
        jt = jmake(jm.IPDnetConfig(hidden_size=HIDDEN, is_online=online))
        tt = tmake(tm.IPDnetConfig(hidden_size=HIDDEN, is_online=online),
                   device="cpu")
        model, nch = tm.IPDnet(tt.cfg, device="cpu", generator=gen), 2
    return jt, tt, jax_params(model), model, nch


def batch(nch, seed):
    rng = np.random.default_rng(seed)
    nsample = int(T_S * 16000)
    nt2 = ((nsample - 512) // 256 + 1) // 12
    return {"mic_sig": rng.standard_normal((NB, nsample, nch)).astype(
                np.float32),
            "doa": np.stack([rng.uniform(0, np.pi, (NB, nt2, 2)),
                             rng.uniform(-np.pi, np.pi, (NB, nt2, 2))],
                            axis=2).astype(np.float32),
            "vad": (rng.uniform(0, 1, (NB, nt2, 2)) > 0.4).astype(
                np.float32) * rng.uniform(0, 1, (NB, nt2, 2)).astype(
                np.float32)}


TASKS = ["ipdnet", "ipdnet_offline", "variable_ipdnet"]


@pytest.fixture(scope="module", params=TASKS)
def case(request):
    return (request.param, *make(request.param))


def test_preprocess_matches_jax(case):
    """Features (all channels for the fixed array, online or offline
    norm; 'MM' pairs for the variable one) and per-track targets with the
    Bessel non-source fill."""
    which, jt, tt, _, _, nch = case
    b = batch(nch, 1)
    jf, jg = jt.preprocess(b["mic_sig"], b["doa"], b["vad"])
    tf, tg = tt.preprocess(*(torch.as_tensor(b[k])
                             for k in ("mic_sig", "doa", "vad")))
    rows = NB * 3 if which == "variable_ipdnet" else NB
    assert tf.shape == jf.shape == (rows, 4 if rows == NB * 3 else 2 * nch,
                                    256, 30)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-5)
    assert tg["ipd"].shape == jg["ipd"].shape
    np.testing.assert_allclose(tg["ipd"].numpy(), np.asarray(jg["ipd"]),
                               rtol=0, atol=1e-5)
    gated = (b["vad"] > 0.001)
    assert 0 < gated.mean() < 1          # both branches of the gate taken


def test_two_adam_steps_match_jax(case):
    which, jt, tt, params, model, nch = case
    b = batch(nch, 2)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    jtx = jstep.make_optimizer("adam", 5e-4, 0.975, 1)
    jstate = jstep.init_train_state(params, jtx)
    jfn = jstep.make_train_step(jt.loss_fn, jtx, donate=False)
    ttx = tstep.make_optimizer("adam", 5e-4, 0.975, 1)
    state = tstep.init_train_state(model, ttx)
    fn = tstep.make_train_step(tt.loss_fn, ttx)
    for _ in range(2):
        jstate, jloss = jfn(jstate, b, None)
        state, loss = fn(state, b)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = params_to_state_dict(jax.tree.map(np.asarray, jstate.params))
    moved = 0.0
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
        moved = max(moved, (v - start[k]).abs().max().item())
    assert moved > 5e-4                  # the steps did move the weights
