"""The port's training step (fnssl_tpu_torch.train: step, tasks,
precision) against fnssl_tpu's on the CPU, with the same weights (JAX
params → numpy → state dict) and the same numpy batch, dropout off
(generator None, as JAX's rng None). Small size: hidden 32, nb 1, 0.4 s
of audio (24 frames, 2 output frames).

Tolerances: fp32 loss within 1e-5 relative and parameters within 1e-5
after two Adam steps; optimizer updates within 1e-6; the bf16 policy's
loss within 1e-4 relative of JAX's bf16 task (the two frameworks round
bf16 at other places, e.g. in the products' accumulation; measured
1.4e-6 to 8.9e-6 over four seeds, against 6e-6 to 7e-5 between bf16 and
fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fnssl_tpu.models.fnssl import FNSSLConfig as JConfig
from fnssl_tpu.models.fnssl import init_fnssl_params
from fnssl_tpu.train import step as jstep
from fnssl_tpu.train import tasks as jtasks
from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
from fnssl_tpu_torch.train import step as tstep
from fnssl_tpu_torch.train import tasks as ttasks
from fnssl_tpu_torch.train.convert import nested_to_flat, params_to_state_dict
from tests.test_torch_threads import torch_threads  # noqa: F401


HIDDEN = 32


def jax_params(seed=0):
    return jax.tree.map(np.asarray, init_fnssl_params(
        jax.random.PRNGKey(seed), JConfig(hidden_size=HIDDEN)))


def port_model(params):
    model = FNSSL(FNSSLConfig(hidden_size=HIDDEN), device="cpu")
    model.load_state_dict(params_to_state_dict(params), strict=True)
    return model


def batch(seed=1):
    return ttasks.synthetic_fnssl_batch(nb=1, t_s=0.4, seed=seed)


def test_exponential_epoch_schedule_matches_jax():
    mine = tstep.exponential_epoch_schedule(1e-3, 0.8988, 4)
    ref = jstep.exponential_epoch_schedule(1e-3, 0.8988, 4)
    for count in range(13):
        assert mine(count) == pytest.approx(float(ref(count)), rel=1e-6)
    # the LambdaLR of a train state follows it, one step per update
    state = tstep.init_train_state(
        torch.nn.Linear(2, 2), tstep.make_optimizer("adam", 1e-3, 0.8988,
                                                    4))
    for count in range(13):
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
            mine(count), rel=1e-12)
        state.optimizer.step()
        state.scheduler.step()


@pytest.mark.parametrize("kind,clip,scale", [
    ("adam", None, 1.0), ("adamw", None, 1.0), ("adam", 1.0, 5.0),
    ("adam", 100.0, 1.0)])
def test_optimizer_update_matches_optax(kind, clip, scale):
    """Two updates of make_optimizer's choice through make_train_step,
    with a loss whose gradient is a fixed numpy draw, against optax."""
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    tx = jstep.make_optimizer(kind, 1e-2, 0.5, 1, grad_clip=clip)
    opt_state = tx.init(params)
    want = params
    for g in grads:
        upd, opt_state = tx.update(g, opt_state, want)
        want = optax.apply_updates(want, upd)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()})
    spec = tstep.make_optimizer(kind, 1e-2, 0.5, 1, grad_clip=clip)
    state = tstep.init_train_state(module, spec)

    def loss_fn(mod, g, generator):
        return sum((mod[k] * torch.as_tensor(v)).sum() for k, v in g.items())

    step = tstep.make_train_step(loss_fn, spec)
    for g in grads:
        state, _ = step(state, g)
    assert state.step == 2
    for k in params:
        np.testing.assert_allclose(module[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=1e-6)


def test_synthetic_batch_equals_jax():
    mine = ttasks.synthetic_fnssl_batch(nb=2, t_s=0.7, seed=3)
    ref = jtasks.synthetic_fnssl_batch(nb=2, t_s=0.7, seed=3)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(mine[k], ref[k])


def test_two_train_steps_match_jax():
    params = jax_params()
    b = batch()
    jtx = jstep.make_optimizer("adam", 1e-3, 0.8988, 1)
    jstate = jstep.init_train_state(jax.tree.map(jnp.asarray, params), jtx)
    jfn = jstep.make_train_step(
        jtasks.make_fnssl_task(JConfig(hidden_size=HIDDEN)).loss_fn, jtx,
        donate=False)
    model = port_model(params)
    tx = tstep.make_optimizer("adam", 1e-3, 0.8988, 1)
    state = tstep.init_train_state(model, tx)
    fn = tstep.make_train_step(
        ttasks.make_fnssl_task(FNSSLConfig(hidden_size=HIDDEN),
                               device="cpu").loss_fn, tx)
    for _ in range(2):
        jstate, jloss = jfn(jstate, b, None)
        state, loss = fn(state, b)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = nested_to_flat(jax.tree.map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5)


def grads(task, model, b, generator=None):
    model.zero_grad(set_to_none=True)
    loss = task.loss_fn(model, b, generator)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


def test_remat_gives_the_same_grads():
    model = port_model(jax_params(2))
    b = batch(4)
    cfg = FNSSLConfig(hidden_size=HIDDEN)
    loss, want = grads(ttasks.make_fnssl_task(cfg, device="cpu"), model, b)
    loss_r, got = grads(ttasks.make_fnssl_task(cfg, remat=True,
                                               device="cpu"), model, b)
    assert float(loss_r) == float(loss)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-7)


def test_remat_with_dropout_redraws_the_forward_masks():
    """With a generator, the recomputation draws the forward's dropout
    masks again: the grads equal those without remat from the same
    generator state."""
    model = port_model(jax_params(3))
    b = batch(5)
    cfg = FNSSLConfig(hidden_size=HIDDEN)
    model.train()
    loss, want = grads(ttasks.make_fnssl_task(cfg, device="cpu"), model, b,
                       torch.Generator().manual_seed(11))
    loss_r, got = grads(ttasks.make_fnssl_task(cfg, remat=True,
                                               device="cpu"), model, b,
                        torch.Generator().manual_seed(11))
    assert float(loss_r) == float(loss)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-7)


def test_bf16_policy_loss_matches_jax_bf16_task():
    params = jax_params(5)
    b = batch(6)
    want = jtasks.make_fnssl_task(JConfig(hidden_size=HIDDEN),
                                  precision="bf16").loss_fn(
        jax.tree.map(jnp.asarray, params), b, None)
    model = port_model(params)
    task = ttasks.make_fnssl_task(FNSSLConfig(hidden_size=HIDDEN),
                                  precision="bf16", device="cpu")
    loss, g = grads(task, model, b)
    fp32 = ttasks.make_fnssl_task(FNSSLConfig(hidden_size=HIDDEN),
                                  device="cpu").loss_fn(model, b).detach()
    assert loss.dtype == torch.float32 and float(loss) != float(fp32)
    assert float(loss) == pytest.approx(float(want), rel=1e-4)
    # gradients reach the fp32 masters through the cast
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in g.values())


def test_eval_step_matches_jax_and_takes_no_grad():
    params = jax_params(6)
    b = batch(7)
    want = jstep.make_eval_step(jtasks.make_fnssl_task(
        JConfig(hidden_size=HIDDEN)).loss_fn)(
        jax.tree.map(jnp.asarray, params), b)
    model = port_model(params)
    loss = tstep.make_eval_step(ttasks.make_fnssl_task(
        FNSSLConfig(hidden_size=HIDDEN), device="cpu").loss_fn)(model, b)
    assert not loss.requires_grad and not model.training
    assert float(loss) == pytest.approx(float(want), rel=1e-5)


def test_doa_head_task_matches_jax():
    """The is_doa task (azimuth CE on integer-degree classes). Its head
    takes 2·nf = 2·hidden inputs, so this one runs at the full width."""
    jcfg = JConfig(is_doa=True)
    params = jax.tree.map(np.asarray, init_fnssl_params(
        jax.random.PRNGKey(8), jcfg))
    b = batch(9)
    want = jtasks.make_fnssl_task(jcfg).loss_fn(
        jax.tree.map(jnp.asarray, params), b, None)
    model = FNSSL(FNSSLConfig(is_doa=True), device="cpu")
    model.load_state_dict(params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = ttasks.make_fnssl_task(model.cfg, device="cpu").loss_fn(model,
                                                                      b)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
