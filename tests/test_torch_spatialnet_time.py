"""The port's SpatialNet with its MHSA and retention time modules
(``attention="mhsa(…)"`` / ``"ret(…)"``, each followed by T-ConvFFN)
against fnssl_tpu on the CPU: the one-shot forward, chunk-by-chunk
streaming with every state, and one IPDnet2 train step through
``make_ipdnet2_task(cfg)``, on the same numpy inputs and weights
(``params_to_state_dict``, strict loads).

Small sizes: 2 layers, hidden 16, 2 heads; 32 bins for the model alone,
the task's 256 for the train step (3 Westlake mics, nb 2 × 0.5 s).

Tolerances: forward and streaming 1e-4; the loss 1e-6 relative; every
gradient within 1e-4 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.spatialnet as js
import fnssl_tpu_torch.models.spatialnet as ts
from fnssl_tpu.data.arrays import audiowu_high_array_geometry
from fnssl_tpu.train import tasks as jtasks
from fnssl_tpu_torch.runtime.export import _resolve
from fnssl_tpu_torch.runtime.slots import _slot_axes
from fnssl_tpu_torch.train import tasks as ttasks
from fnssl_tpu_torch.train.convert import params_to_state_dict
from tests.test_torch_threads import torch_threads  # noqa: F401


SMALL = dict(dim_input=6, dim_output=8, num_layers=2, num_freqs=32,
             dim_hidden=16, num_heads=2, recurrent_chunk_size=4)
KINDS = [("mhsa(6)", False, True), ("mhsa(6)", "ALiBi", True),
         ("ret(2)", False, True), ("ret(2)", True, True),
         ("ret(2)", True, False)]
ATOL = 1e-4


def leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda a: isinstance(a,
                                                              torch.Tensor))


def pair(attention, rope, chunkwise, seed=0, **kw):
    cfg = dict(SMALL, attention=attention, rope=rope,
               chunkwise_recurrent=chunkwise, **kw)
    jcfg = js.SpatialNetConfig(**cfg)
    params = js.init_spatialnet_params(jax.random.PRNGKey(seed), jcfg)
    model = ts.SpatialNet(ts.SpatialNetConfig(**cfg), device="cpu")
    model.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, params, model.eval()


@pytest.mark.parametrize("attention,rope,chunkwise", KINDS)
def test_forward_matches_jax(attention, rope, chunkwise):
    """40 frames: 8 after the time compression, so the later layers take
    their own mask."""
    jcfg, params, model = pair(attention, rope, chunkwise, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 6, 32, 40)).astype(
        np.float32)
    want = js.spatialnet_apply(params, jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    assert got.shape == want.shape == (2, 8, 64, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("attention,rope,chunkwise", KINDS[:4])
def test_streaming_matches_jax_streaming(attention, rope, chunkwise):
    """Chunks of 5 frames over 30: each chunk's output and every state
    leaf against JAX's streaming."""
    jcfg, params, model = pair(attention, rope, chunkwise, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 6, 32, 30)).astype(
        np.float32)
    jstate = js.init_spatialnet_state(2, jcfg)
    tstate = ts.init_spatialnet_state(2, model.cfg, "cpu")
    assert len(leaves(tstate)) == len(jax.tree.leaves(jstate))
    with torch.no_grad():
        for lo in range(0, 30, 5):
            chunk = x[..., lo:lo + 5]
            want, jstate = js.spatialnet_apply(
                params, jnp.asarray(chunk), cfg=jcfg, state=jstate,
                return_state=True)
            got, tstate = model(torch.as_tensor(chunk), state=tstate,
                                return_state=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL)
    for g, w in zip(leaves(tstate), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("attention,rope", [("mhsa(6)", False),
                                            ("ret(2)", True)])
def test_serving_paths_refuse_time_modules_other_than_mamba(attention,
                                                            rope):
    """The slot pool and export take every time module now (the name is
    the old refusal's): ``_resolve`` gives an apply function and, for the
    pool, an init whose every leaf grows with nb (the positions and the
    running scale one a row of the nb·F time-module batch); export's
    leaves are JAX's. A chunk step from either init gives the same
    output."""
    _, _, model = pair(attention, rope, True)
    apply_fn, init_state = _resolve("ipdnet2", model)
    f = model.cfg.num_freqs // model.cfg.fre_compression_ratio
    pooled = leaves(init_state(2))
    shared = leaves(_resolve("ipdnet2", model, per_row=False)[1](2))
    assert _slot_axes(init_state) == [0] * len(pooled)
    per_layer = 3 if attention.startswith("mhsa") else 4
    assert len(pooled) == len(shared) == 1 + 2 * per_layer
    for a, b in zip(pooled, shared):
        assert a.dtype == b.dtype
        if b.ndim < 2:                 # pos () or scale (heads,)
            assert a.shape == (2 * f,) + b.shape
        else:
            assert a.shape == b.shape
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2, 6, 32, 5)).astype(np.float32))
    with torch.no_grad():
        got, _ = apply_fn(model, x, state=init_state(2), return_state=True)
        want = model(x, state=ts.init_spatialnet_state(2, model.cfg, "cpu"),
                     return_state=True)[0]
    assert torch.equal(got, want)


MICS = audiowu_high_array_geometry()[[0, 1, 3]]
TASK = dict(dim_input=6, dim_output=8, num_layers=2, dim_hidden=16,
            num_heads=2, recurrent_chunk_size=4)


def batch(seed, nb=2, t_s=0.5):
    rng = np.random.default_rng(seed)
    nt2 = int(t_s * 10)
    return {"mic_sig": rng.standard_normal((nb, int(t_s * 16000), 3)
                                           ).astype(np.float32),
            "azi_deg": rng.integers(0, 360, (nb, nt2, 2)).astype(
                np.float32),
            "distance": rng.uniform(0.5, 3.0, (nb, nt2, 2)).astype(
                np.float32),
            "vad": (rng.uniform(0, 1, (nb, nt2, 2)) > 0.4).astype(
                np.float32),
            "mic_pos": (MICS[None] + rng.normal(0, 0.005, (nb, 3, 3))
                        ).astype(np.float32)}


@pytest.mark.parametrize("attention,rope", [("mhsa(6)", "ALiBi"),
                                            ("ret(2)", True)])
def test_train_step_loss_and_gradients_match_jax(attention, rope):
    """``make_ipdnet2_task(cfg)`` trains the config unchanged: its loss
    and every gradient against ``jax.value_and_grad`` of JAX's task."""
    cfg = dict(TASK, attention=attention, rope=rope)
    jcfg = js.SpatialNetConfig(**cfg)
    params = js.init_spatialnet_params(jax.random.PRNGKey(5), jcfg)
    jt = jtasks.make_ipdnet2_task(jcfg, mic_location=MICS)
    tt = ttasks.make_ipdnet2_task(ts.SpatialNetConfig(**cfg),
                                  mic_location=MICS, device="cpu")
    model = ts.SpatialNet(tt.cfg, device="cpu")
    model.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    b = batch(6)
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(params, b, None)
    loss = tt.loss_fn(model, b)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    loss.backward()
    want = params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        scale = max(float(want[k].abs().max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
