"""The port's slot-batched streaming pool (runtime/slots.py) on the CPU,
where each tier runs its function eagerly (on the card the same function
is one CUDA graph a tier: tests/test_torch_serving_cuda.py).

The ports of tests/test_slots.py's seven cases (concurrent streams through
the pool equal dedicated per-stream steps, across interleaved rates and
slot reuse; the tiers; the feature-upload dtype), the same check for
IPDnet and IPDnet2 (whose state leaves have their slots on other axes
than FN-SSL's), one mixed-occupancy run held against JAX's
``SlotBatchedStepper`` itself on the same weights, and `cli serve
--slots`'s wiring (tests/test_server.py:174).

Small sizes: FN-SSL and IPDnet at hidden 32, IPDnet2 at 2 layers of
hidden 16; 16 frequencies for the pool's own cases. Tolerances: 1e-5
relative (+1e-6 absolute) for model outputs (float32 recurrences summed
in another order); the toy model's running sums within 1e-6 relative.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import fnssl_tpu.models.fnssl as jfm
from fnssl_tpu.runtime.slots import SlotBatchedStepper as JSlotBatchedStepper
from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig, \
    init_fnssl_state
from fnssl_tpu_torch.runtime.slots import (BatchedStreamPool,
                                           SlotBatchedStepper, _slot_axes)
from fnssl_tpu_torch.train.convert import params_to_state_dict

HIDDEN, NF = 32, 16
RTOL, ATOL = 1e-5, 1e-6


def fnssl_family(model):
    def apply_fn(m, x, state=None, return_state=False):
        return m(x, state=state, return_state=return_state)

    def init_state(nb):
        return init_fnssl_state(nb, NF, model.cfg, "cpu")

    return apply_fn, init_state


@pytest.fixture(scope="module")
def pool_setup():
    model = FNSSL(FNSSLConfig(hidden_size=HIDDEN), device="cpu",
                  generator=torch.Generator().manual_seed(0)).eval()
    apply_fn, init_state = fnssl_family(model)
    pool = BatchedStreamPool(apply_fn, model, init_state,
                             feats_shape=(1, 4, NF, 12), slots=3)
    yield model, apply_fn, init_state, pool
    pool.close()


def reference_stream(apply_fn, params, init_state, chunks):
    state = init_state(1)
    outs = []
    with torch.no_grad():
        for c in chunks:
            o, state = apply_fn(params, torch.as_tensor(c), state=state,
                                return_state=True)
            outs.append(o.numpy())
    return outs


def chunks_of(rng, n, shape=(1, 4, NF, 12)):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def run_threads(pool, streams):
    results = [[] for _ in streams]

    def run(i):
        s = pool.session()
        try:
            for c in streams[i]:
                results[i].append(np.asarray(s(c)))
        finally:
            s.close()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return results


def test_pool_matches_dedicated_streams(pool_setup):
    model, apply_fn, init_state, pool = pool_setup
    rng = np.random.default_rng(0)
    streams = [chunks_of(rng, 3) for _ in range(2)]
    results = run_threads(pool, streams)
    for i, chunks in enumerate(streams):
        want = reference_stream(apply_fn, model, init_state, chunks)
        for got, w in zip(results[i], want):
            close(got, w)


def test_pool_slot_reuse_resets_state(pool_setup):
    """Release + re-lease a slot: the new stream starts from fresh state,
    not the previous lease's carry."""
    model, apply_fn, init_state, pool = pool_setup
    c1, c2 = chunks_of(np.random.default_rng(1), 2)
    s = pool.session()
    s(c1)
    s(c1)                             # advance the state, then release
    s.close()
    s2 = pool.session()
    got = np.asarray(s2(c2))
    s2.close()
    close(got, reference_stream(apply_fn, model, init_state, [c2])[0])


def test_pool_idle_slots_keep_state(pool_setup):
    """A slow stream's state does not advance while other streams tick."""
    model, apply_fn, init_state, pool = pool_setup
    rng = np.random.default_rng(2)
    slow, fast = chunks_of(rng, 2), chunks_of(rng, 3)
    ss, sf = pool.session(), pool.session()
    got = [np.asarray(ss(slow[0]))]
    for c in fast:                    # the slow stream idles across these
        sf(c)
    got.append(np.asarray(ss(slow[1])))
    ss.close()
    sf.close()
    for g, w in zip(got, reference_stream(apply_fn, model, init_state,
                                          slow)):
        close(g, w)


def toy_model():
    """Tiny stateful chunk model: state (nb, 2) running sum; the output
    depends on both feats and the carried state, so any gather/scatter/
    reset mix-up between slots shows exactly."""
    def apply_fn(p, x, state=None, return_state=False):
        upd = x.reshape(x.shape[0], -1)[:, :2]
        new = state + upd
        out = new * p["w"]
        return (out, new) if return_state else out

    return apply_fn, {"w": 3.0}, lambda nb: torch.zeros((nb, 2))


def test_tiered_programs_single_stream_runs_smallest_tier():
    """One active connection on a 16-slot pool runs the 1-slot tier, and
    results stay exact across slot counts."""
    apply_fn, params, init_state = toy_model()
    pool = BatchedStreamPool(apply_fn, params, init_state,
                             feats_shape=(1, 4), slots=16)
    try:
        assert pool.stepper.tier_sizes == [1, 4, 16]
        chunks = chunks_of(np.random.default_rng(3), 4, (1, 4))
        s = pool.session()
        got = [np.asarray(s(c)) for c in chunks]
        s.close()
        assert set(pool.stepper._tiers) == {1}, "padded past tier 1"
        assert pool.stepper.replays == {1: 4, 4: 0, 16: 0}
    finally:
        pool.close()
    run = np.zeros((1, 2), np.float32)
    for g, c in zip(got, chunks):
        run = run + c.reshape(1, -1)[:, :2]
        np.testing.assert_allclose(g, run * 3.0, rtol=1e-6)


def test_tiered_programs_mixed_occupancy_exact():
    """Streams joining and leaving cross tier boundaries (1 → 4 → 1 on a
    16-slot pool); every stream's running state stays exact through the
    gather/scatter round trips and padded-row carries."""
    apply_fn, params, init_state = toy_model()
    pool = BatchedStreamPool(apply_fn, params, init_state,
                             feats_shape=(1, 4), slots=16,
                             batch_window_s=0.01)
    rng = np.random.default_rng(4)
    chunks = [chunks_of(rng, 5, (1, 4)) for _ in range(6)]
    try:
        first = run_threads(pool, chunks[:1])       # alone: tier 1
        rest = run_threads(pool, chunks[1:])        # 5 join: tier >= 4
    finally:
        pool.close()
    for i, got in enumerate(first + rest):
        run_sum = np.zeros((1, 2), np.float32)
        for g, c in zip(got, chunks[i]):
            run_sum = run_sum + c.reshape(1, -1)[:, :2]
            np.testing.assert_allclose(g, run_sum * 3.0, rtol=1e-6,
                                       err_msg=f"stream {i}")
    assert 1 in pool.stepper._tiers and len(pool.stepper._tiers) >= 2


def test_pool_exhaustion_raises(pool_setup):
    *_, pool = pool_setup
    leases = [pool.session() for _ in range(3)]
    with pytest.raises(RuntimeError, match="slots leased"):
        pool.session()
    for s in leases:
        s.close()


def test_feat_upload_dtype_follows_params():
    """bfloat16 weights upload the features as bfloat16 (half the bytes a
    tick; a bf16 model casts its inputs anyway); float32 and non-tensor
    (Python scalar) weights keep float32 features."""
    apply_fn, params, init_state = toy_model()
    st = SlotBatchedStepper(apply_fn, params, init_state, slots=2)
    assert st._feat_dtype == torch.float32          # Python-scalar params
    st = SlotBatchedStepper(apply_fn, {"w": torch.tensor(3.0)}, init_state,
                            slots=2)
    assert st._feat_dtype == torch.float32
    bf = {"w": torch.tensor(3.0, dtype=torch.bfloat16)}
    st = SlotBatchedStepper(apply_fn, bf, init_state, slots=2)
    assert st._feat_dtype == torch.bfloat16
    out = st.step_slots(np.arange(1), np.ones((1, 4), np.float32),
                        np.zeros(1, bool))
    np.testing.assert_allclose(out.float().numpy(), [[3.0, 3.0]], rtol=1e-2)


def test_slot_axes_of_each_model():
    """The slot axis of every state leaf: FN-SSL's (1, nb·nf, H) LSTM
    states on axis 1; IPDnet's LSTM states on 1 and its conv tails on 0;
    IPDnet2's encoder tail (nb·F, …) and Mamba states (nb·F/r, …) on 0,
    and its MHSA and retention states in the per-row form; a leaf that
    does not scale is refused."""
    from fnssl_tpu_torch.models.ipdnet import IPDnetConfig, \
        init_ipdnet_state
    from fnssl_tpu_torch.models.spatialnet import SpatialNetConfig, \
        init_spatialnet_state

    cfg = FNSSLConfig(hidden_size=HIDDEN)
    assert _slot_axes(lambda nb: init_fnssl_state(nb, NF, cfg, "cpu")) \
        == [1] * 6
    icfg = IPDnetConfig(hidden_size=HIDDEN)
    assert _slot_axes(lambda nb: init_ipdnet_state(nb, NF, icfg, "cpu")) \
        == [1, 1, 1, 1, 0, 0, 0]
    scfg = SpatialNetConfig(num_layers=2, dim_hidden=16)
    assert _slot_axes(lambda nb: init_spatialnet_state(nb, scfg, "cpu")) \
        == [0] * 9
    # MHSA (tail, pos) and retention (kv, scale, pos), each with the
    # T-ConvFFN tail: the pool's per-row leaves all on axis 0; JAX's
    # shared positions and scale are refused
    for attention, n in (("mhsa(6)", 7), ("ret(2)", 9)):
        tcfg = scfg._replace(attention=attention)
        assert _slot_axes(lambda nb: init_spatialnet_state(
            nb, tcfg, "cpu", per_row=True)) == [0] * n
        with pytest.raises(ValueError, match="does not scale with nb"):
            _slot_axes(lambda nb: init_spatialnet_state(nb, tcfg, "cpu"))
    with pytest.raises(ValueError, match="does not scale"):
        _slot_axes(lambda nb: torch.zeros(nb, nb))


@pytest.mark.parametrize("name", ["ipdnet", "ipdnet2"])
def test_pool_matches_dedicated_streams_per_model(name):
    """IPDnet's and IPDnet2's pools (states with slots on axis 0 and on
    rows of 256 and 16), through ``runtime.export._resolve``: three
    concurrent streams through a 4-slot pool equal dedicated streams."""
    from fnssl_tpu_torch.models.ipdnet import IPDnet, IPDnetConfig
    from fnssl_tpu_torch.models.spatialnet import SpatialNet, \
        SpatialNetConfig
    from fnssl_tpu_torch.runtime.export import _resolve

    gen = torch.Generator().manual_seed(1)
    if name == "ipdnet":
        model = IPDnet(IPDnetConfig(hidden_size=HIDDEN), device="cpu",
                       generator=gen)
        shape = (1, 4, 256, 12)
    else:
        model = SpatialNet(SpatialNetConfig(num_layers=2, dim_hidden=16),
                           device="cpu", generator=gen)
        shape = (1, 10, 256, 5)
    model.eval()
    apply_fn, init_state = _resolve(name, model)
    pool = BatchedStreamPool(apply_fn, model, init_state, feats_shape=shape,
                             slots=4)
    rng = np.random.default_rng(5)
    streams = [chunks_of(rng, 2, shape) for _ in range(3)]
    try:
        results = run_threads(pool.warmup(), streams)
    finally:
        pool.close()
    for got, chunks in zip(results, streams):
        for g, w in zip(got, reference_stream(apply_fn, model, init_state,
                                              chunks)):
            close(g, w)


def test_mixed_occupancy_matches_jax_stepper():
    """One tick sequence of mixed occupancy (1, 3, 2, 4 active slots, with
    resets, idle slots and a re-leased slot) through the port's stepper and
    JAX's ``SlotBatchedStepper`` on the same FN-SSL weights: every tick's
    outputs agree."""
    jcfg = jfm.FNSSLConfig(hidden_size=HIDDEN)
    params = jax.jit(jfm.init_fnssl_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    model = FNSSL(FNSSLConfig(hidden_size=HIDDEN), device="cpu")
    model.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    model.eval()
    apply_fn, init_state = fnssl_family(model)

    def japply(p, x, state=None, return_state=False):
        return jfm.fnssl_apply(p, x, cfg=jcfg, state=state,
                               return_state=return_state)

    port = SlotBatchedStepper(apply_fn, model, init_state, slots=4)
    jax_st = JSlotBatchedStepper(
        japply, params, lambda nb: jfm.init_fnssl_state(nb, NF, jcfg), 4)
    rng = np.random.default_rng(6)
    ticks = [([2], [True]), ([2, 0, 3], [False, True, True]),
             ([3, 1], [False, True]), ([0, 1, 2, 3], [False, False, True,
                                                      False])]
    for ids, reset in ticks:
        feats = rng.standard_normal((len(ids), 4, NF, 12)).astype(
            np.float32)
        got = port.step_slots(np.asarray(ids), feats, np.asarray(reset))
        want = jax_st.step_slots(np.asarray(ids, np.int32), feats,
                                 np.asarray(reset))
        close(got, want)
    assert port.replays == {1: 1, 4: 3}


def test_cli_serve_slot_batched(tmp_path, monkeypatch):
    """`cli serve --slots 2`: sessions lease slots of one pool; outputs
    equal the unbatched path and a closed session frees its slot."""
    import fnssl_tpu_torch.models.fnssl as tfm
    from fnssl_tpu_torch.cli.main import build_parser, build_server
    from fnssl_tpu_torch.runtime.slots import _SlotSession

    orig = tfm.FNSSLConfig
    monkeypatch.setattr(tfm, "FNSSLConfig", lambda **kw: orig(
        **{"hidden_size": HIDDEN, **kw}))
    sig = np.random.default_rng(5).standard_normal(
        (8000, 2)).astype(np.float32) * 0.1

    def serve(*extra):
        return build_server(build_parser().parse_args(
            ["serve", "--model", "fnssl", "--platform", "cpu", "--port", "0",
             "--log-dir", str(tmp_path), *extra]))

    server, info = serve("--slots", "2")
    try:
        assert info["slots"] == 2 and server.pool.stepper.tier_sizes == [1, 2]
        loc, _ = server.session_factory()
        assert isinstance(loc.model_step, _SlotSession)
        outs = [o.numpy() for o in loc.push(sig)]
        loc.model_step.close()
        assert len(server.pool._free) == 2
    finally:
        server._sock.close()
        server.pool.close()
    server, _ = serve()                               # unbatched reference
    try:
        loc, _ = server.session_factory()
        want = [o.numpy() for o in loc.push(sig)]
    finally:
        server._sock.close()
    assert len(outs) == len(want) >= 1
    for g, w in zip(outs, want):
        close(g, w)
    with pytest.raises(SystemExit, match="--slots serves from a checkpoint"):
        serve("--slots", "2", "--artifact", str(tmp_path))
