"""Serving IPDnet2 with its MHSA and retention time modules on the CPU,
against fnssl_tpu: the port's forward and stream artifacts against JAX's
``export_model``/``load_artifact``, the port's slot pool against JAX's
dedicated streams, and the per-row state the pool keeps.

JAX's own pool carries MHSA's and retention's positions and retention's
running scale as leaves shared by every slot (shape () and (heads,)) and
restarts them each tick (``fnssl_tpu/runtime/slots.py:64-65, 172-176``),
so a slot there drifts from its stream after the first chunk. The port
keeps them one a row (``init_spatialnet_state(per_row=True)``) and is held
here to JAX's dedicated streams, what the pool promises.

Small sizes: 2 layers, hidden 16, 2 heads, 32 bins (two rows a slot in
the time modules, after the 16x frequency compression), 5-frame chunks.
Tolerances: 1e-4, the tolerance at which tests/test_torch_spatialnet_time
holds the port's stream step to JAX's; init leaves and the per-row step
against the shared one exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.spatialnet as js
import fnssl_tpu_torch.models.spatialnet as ts
from fnssl_tpu.runtime import export as jexport
from fnssl_tpu_torch.runtime.export import (_resolve, export_model,
                                            load_artifact)
from fnssl_tpu_torch.runtime.slots import SlotBatchedStepper, _slot_axes
from fnssl_tpu_torch.train.convert import params_to_state_dict
from tests.test_torch_threads import torch_threads  # noqa: F401

SMALL = dict(dim_input=6, dim_output=8, num_layers=2, num_freqs=32,
             dim_hidden=16, num_heads=2, recurrent_chunk_size=4)
KINDS = [("mhsa(6)", False), ("mhsa(6)", "ALiBi"), ("ret(2)", False),
         ("ret(2)", True)]
CHUNK, ATOL = 5, 1e-4


def leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda a: isinstance(a,
                                                              torch.Tensor))


def pair(attention, rope, seed=0):
    cfg = dict(SMALL, attention=attention, rope=rope)
    jcfg = js.SpatialNetConfig(**cfg)
    params = js.init_spatialnet_params(jax.random.PRNGKey(seed), jcfg)
    model = ts.SpatialNet(ts.SpatialNetConfig(**cfg), device="cpu")
    model.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, params, model.eval()


def feats(seed, nb, nt):
    return np.random.default_rng(seed).standard_normal(
        (nb, SMALL["dim_input"], SMALL["num_freqs"], nt)).astype(np.float32)


@pytest.mark.parametrize("attention,rope", KINDS)
@pytest.mark.parametrize("mode", ["forward", "stream"])
def test_artifacts_match_jax_artifacts(tmp_path, attention, rope, mode):
    """Both packages export the same weights; the port's CPU program and
    JAX's, each loaded without model code, agree chunk by chunk over 20
    frames (forward: once over them), and a stream artifact's initial
    state equals JAX's leaf for leaf in shape, dtype and value."""
    jcfg, params, model = pair(attention, rope, seed=1)
    x = feats(2, 2, 20)
    example = x if mode == "forward" else x[..., :CHUNK]
    jexport.export_model("ipdnet2", params, example, str(tmp_path / "jax"),
                         mode=mode, platforms=["cpu"], cfg=jcfg)
    meta = export_model("ipdnet2", model, example, str(tmp_path / "port"),
                        mode=mode, platforms=["cpu"])
    want = jexport.load_artifact(str(tmp_path / "jax"))
    got = load_artifact(str(tmp_path / "port"), "cpu")
    if mode == "forward":
        np.testing.assert_allclose(got(x).numpy(), np.asarray(want(x)),
                                   rtol=0, atol=ATOL)
        return
    init = torch.load(tmp_path / "port" / "init_state.pt", weights_only=True)
    jinit = jax.tree.leaves(want._init_state)
    assert meta["state_leaves"] == len(init) == len(jinit)
    for a, b in zip(init, jinit):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype) == \
            f"torch.{b.dtype}"
        np.testing.assert_array_equal(a.numpy(), b)
    for lo in range(0, 20, CHUNK):
        chunk = x[..., lo:lo + CHUNK]
        np.testing.assert_allclose(got(chunk).numpy(),
                                   np.asarray(want(chunk)), rtol=0,
                                   atol=ATOL, err_msg=f"chunk at {lo}")


# (ids, reset) a tick on a 4-slot pool, and the stream each id carries:
# streams join on different ticks (a reset), slot 1 idles on tick 3 while
# others step, and its stream ends after tick 4, the slot then leased
# again by a new stream (reset on tick 5)
TICKS = [([1], [True]), ([1, 3], [False, True]),
         ([3, 0, 1], [False, True, False]), ([0, 3], [False, False]),
         ([1, 0, 3, 2], [False, False, False, True]),
         ([1, 2], [True, False]), ([2, 3, 1, 0], [False] * 4)]
STREAM_OF = [{1: "a"}, {1: "a", 3: "b"}, {3: "b", 0: "c", 1: "a"},
             {0: "c", 3: "b"}, {1: "a", 0: "c", 3: "b", 2: "d"},
             {1: "e", 2: "d"}, {2: "d", 3: "b", 1: "e", 0: "c"}]


@pytest.mark.parametrize("attention,rope", KINDS)
def test_pool_ticks_match_jax_dedicated_streams(attention, rope):
    """The port's 4-slot pool (``_resolve``'s per-row init) under staggered
    joins, an idle slot and a re-leased slot: each tick's output for each
    stream against that stream's next chunk step in JAX
    (``spatialnet_apply`` with its own state)."""
    jcfg, params, model = pair(attention, rope, seed=3)
    apply_fn, init_state = _resolve("ipdnet2", model)
    pool = SlotBatchedStepper(apply_fn, model, init_state, slots=4)
    assert pool.tier_sizes == [1, 4]
    jstates, rng = {}, np.random.default_rng(4)
    for (ids, reset), streams in zip(TICKS, STREAM_OF):
        x = feats(int(rng.integers(1 << 30)), len(ids), CHUNK)
        got = pool.step_slots(np.asarray(ids), x, np.asarray(reset))
        for k, slot in enumerate(ids):
            name = streams[slot]
            st = jstates.get(name, js.init_spatialnet_state(1, jcfg))
            want, jstates[name] = js.spatialnet_apply(
                params, jnp.asarray(x[k:k + 1]), cfg=jcfg, state=st,
                return_state=True)
            np.testing.assert_allclose(
                got[k:k + 1].numpy(), np.asarray(want), rtol=0, atol=ATOL,
                err_msg=f"stream {name} in slot {slot}")
    assert pool.replays == {1: 1, 4: 6}


@pytest.mark.parametrize("attention,rope", KINDS)
def test_per_row_step_equals_shared_step(attention, rope):
    """With every row at one position, the per-row state's chunk steps
    give the shared state's bits, output and leaves, over 6 chunks."""
    _, _, model = pair(attention, rope, seed=5)
    x = torch.as_tensor(feats(6, 2, 30))
    shared = ts.init_spatialnet_state(2, model.cfg, "cpu")
    rows = ts.init_spatialnet_state(2, model.cfg, "cpu", per_row=True)
    with torch.no_grad():
        for lo in range(0, 30, CHUNK):
            a, shared = model(x[..., lo:lo + CHUNK], state=shared,
                              return_state=True)
            b, rows = model(x[..., lo:lo + CHUNK], state=rows,
                            return_state=True)
            assert torch.equal(a, b)
    for s, r in zip(leaves(shared), leaves(rows)):
        assert torch.equal(s.expand_as(r) if s.ndim < r.ndim else s, r)


@pytest.mark.parametrize("attention", ["mhsa(6)", "ret(2)"])
def test_slot_axes_refuse_a_shared_leaf(attention):
    """JAX's state, whose positions (and retention's scale) do not grow
    with nb, cannot back a pool: the stepper refuses it at construction."""
    _, _, model = pair(attention, False)
    apply_fn, shared = _resolve("ipdnet2", model, per_row=False)
    with pytest.raises(ValueError, match="does not scale with nb"):
        _slot_axes(shared)
    with pytest.raises(ValueError, match="does not scale with nb"):
        SlotBatchedStepper(apply_fn, model, shared, slots=4)
