"""The port's IPDnet2 training (fnssl_tpu_torch: train.tasks'
make_ipdnet2_task through train.step, AdamW with a global-norm clip of 5)
against fnssl_tpu on the CPU: the preprocess (STFT center=True, hop 320,
forgetting norm L=249; near-field DP-IPD targets with the Bessel fill),
the loss and every gradient against ``jax.grad``, then two AdamW steps
from the same weights and batch.

Small sizes: SpatialNet at 2 layers, hidden 16 (256 bins, the task's
STFT), a 3-mic subset of the Westlake array, nb 2 × 0.5 s (26 frames, 5
output frames, 5 labels at 10 Hz), 2 tracks with VAD drawn so that both
the gated IPD and the Bessel fill are taken, per-batch mic positions.

Tolerances: features and targets atol 1e-5; the loss 1e-5 relative;
each gradient within 1e-4 of its largest magnitude (float32 sums in
another order through 2 × 26 + 2 × 5 scan steps; measured ≤ 2e-6);
parameters after two AdamW steps atol 1e-4, a tenth of two steps' reach
(each moves a parameter by ~lr·sign(g), lr 5e-4), as the IPDnet tasks.
The bf16 policy's loss within 2e-2 relative of JAX's (bf16 rounds at
other places in the two frameworks).
"""
import jax
import numpy as np
import pytest
import torch

import fnssl_tpu.models.spatialnet as js
import fnssl_tpu_torch.models.spatialnet as ts
from fnssl_tpu.data.arrays import audiowu_high_array_geometry
from fnssl_tpu.train import step as jstep
from fnssl_tpu.train import tasks as jtasks
from fnssl_tpu_torch.train import step as tstep
from fnssl_tpu_torch.train import tasks as ttasks
from fnssl_tpu_torch.train.convert import params_to_state_dict

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


@pytest.fixture(scope="module")
def tasks():
    jt = jtasks.make_ipdnet2_task(js.SpatialNetConfig(**SMALL),
                                  mic_location=MICS)
    tt = ttasks.make_ipdnet2_task(ts.SpatialNetConfig(**SMALL),
                                  mic_location=MICS, device="cpu")
    return jt, tt


def make_model():
    model = ts.SpatialNet(ts.SpatialNetConfig(**SMALL), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    return model, jax_params(model)


def batch(seed):
    rng = np.random.default_rng(seed)
    nsample = int(T_S * 16000)
    nt2 = int(T_S * 10)
    return {"mic_sig": rng.standard_normal((NB, nsample, 3)).astype(
                np.float32),
            "azi_deg": rng.integers(0, 360, (NB, nt2, 2)).astype(
                np.float32),
            "distance": rng.uniform(0.5, 3.0, (NB, nt2, 2)).astype(
                np.float32),
            "vad": (rng.uniform(0, 1, (NB, nt2, 2)) > 0.4).astype(
                np.float32),
            "mic_pos": (MICS[None] + rng.normal(0, 0.005, (NB, 3, 3))
                        ).astype(np.float32)}


KEYS = ("mic_sig", "azi_deg", "distance", "vad", "mic_pos")


def test_preprocess_matches_jax(tasks):
    jt, tt = tasks
    b = batch(1)
    jf, jg = jt.preprocess(*(b[k] for k in KEYS))
    tf, tg = tt.preprocess(*(torch.as_tensor(b[k]) for k in KEYS))
    assert tf.shape == jf.shape == (NB, 6, 256, 26)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=1e-5)
    assert tg["ipd"].shape == jg["ipd"].shape == (NB, 5, 512, 2, 2)
    np.testing.assert_allclose(tg["ipd"].numpy(), np.asarray(jg["ipd"]),
                               rtol=0, atol=1e-5)
    assert 0 < b["vad"].mean() < 1       # both branches of the gate taken


def test_loss_and_every_gradient_match_jax(tasks):
    jt, tt = tasks
    model, params = make_model()
    b = batch(2)
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(params, b, None)
    loss = tt.loss_fn(model, b)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    want = params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        scale = max(float(want[k].abs().max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_two_adamw_steps_with_clip_match_jax(tasks):
    jt, tt = tasks
    model, params = make_model()
    b = batch(3)
    start = {k: v.clone() for k, v in model.state_dict().items()}
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
    moved = 0.0
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
        moved = max(moved, (v - start[k]).abs().max().item())
    assert moved > 5e-4                  # the steps did move the weights


def test_bf16_policy_loss_matches_jax(monkeypatch):
    """Under the bf16 policy the Mamba blocks take bf16 inputs but run
    their fused scan on float32 x, dt, B, C and parameters (the carried
    conv tail is float32, so JAX promotes the conv output, as the port
    does); the loss agrees with JAX's bf16 loss."""
    import fnssl_tpu_torch.models.mamba as tmamba

    jt = jtasks.make_ipdnet2_task(js.SpatialNetConfig(**SMALL),
                                  mic_location=MICS, precision="bf16")
    tt = ttasks.make_ipdnet2_task(ts.SpatialNetConfig(**SMALL),
                                  mic_location=MICS, precision="bf16",
                                  device="cpu")
    model, params = make_model()
    b = batch(4)
    seen = []

    def spy(*args):
        seen.append(tuple(t.dtype for t in args))
        return scan(*args)

    scan = tmamba.selective_scan_fwd
    monkeypatch.setattr(tmamba, "selective_scan_fwd", spy)
    loss = tt.loss_fn(model, b)
    assert len(seen) == 4 and set(seen) == {(torch.float32,) * 8}
    assert float(loss.detach()) == pytest.approx(
        float(jt.loss_fn(params, b, None)), rel=2e-2)
