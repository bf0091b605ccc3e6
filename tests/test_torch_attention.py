"""The port's MHSA time module, causal masks and T-ConvFFN
(fnssl_tpu_torch.models.attention, spatialnet.get_causal_mask) against
fnssl_tpu on the CPU: the same numpy inputs, the JAX weights carried over
with ``params_to_state_dict`` (strict loads).

Tolerances: masks exact; the MHSA forward, its streaming against JAX's
streaming and T-ConvFFN 1e-5; the port's streaming against its one-shot
forward 2e-4, JAX's own tolerance (tests/test_spatialnet_attention.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.attention as ja
import fnssl_tpu.models.spatialnet as js
import fnssl_tpu_torch.models.attention as ta
import fnssl_tpu_torch.models.spatialnet as ts
from fnssl_tpu_torch.train.convert import params_to_state_dict

ATOL = 1e-5


def port(module, params):
    module.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    return module.eval()


def mhsa_pair(alibi, seed=0, scope=6, e=16, heads=2):
    jcfg = ja.MHSAConfig(e, heads, scope, alibi)
    params = ja.init_mhsa_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = ta.MHSAConfig(e, heads, scope, alibi)
    return jcfg, params, port(ta.MHSA(tcfg, device="cpu"), params)


def test_alibi_slopes_and_causal_mask_are_exact():
    np.testing.assert_array_equal(ta.alibi_slopes(4), ja.alibi_slopes(4))
    for alibi in (False, True):
        np.testing.assert_array_equal(
            ta.causal_mask(13, 5, 3, alibi=alibi),
            ja.causal_mask(13, 5, 3, alibi=alibi))


@pytest.mark.parametrize("attention,rope,chunkwise", [
    ("mhsa(6)", False, True), ("mhsa(6)", "ALiBi", True),
    ("ret(2)", False, True), ("ret(2)", True, True), ("ret(2)", True, False),
    ("mamba", False, True)])
def test_get_causal_mask_is_exact(attention, rope, chunkwise):
    kw = dict(attention=attention, rope=rope, dim_hidden=16,
              chunkwise_recurrent=chunkwise, recurrent_chunk_size=4)
    want = js.get_causal_mask(js.SpatialNetConfig(**kw), 11)
    got = ts.get_causal_mask(ts.SpatialNetConfig(**kw), 11)
    if want is None:
        assert got is None
        return
    want_leaves = jax.tree.leaves(want)
    got_leaves = jax.tree.leaves(
        got, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("alibi", [False, True])
def test_mhsa_forward_matches_jax(alibi):
    jcfg, params, module = mhsa_pair(alibi)
    x = np.random.default_rng(1).standard_normal((3, 17, 16)).astype(
        np.float32)
    mask = ja.causal_mask(17, 6, 2, alibi=alibi)
    want = ja.mhsa_apply(params, jnp.asarray(x), jnp.asarray(mask), jcfg)
    with torch.no_grad():
        got = module(torch.as_tensor(x), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("alibi", [False, True])
def test_mhsa_streaming_matches_jax_and_oneshot(alibi):
    """Chunks of 4 over 20 frames (a scope of 6 reaches back across
    chunks): state by state against JAX's streaming (1e-5), and the whole
    against the port's one-shot forward (2e-4)."""
    jcfg, params, module = mhsa_pair(alibi, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 20, 16)).astype(
        np.float32)
    jstate = ja.init_mhsa_state(2, jcfg)
    tstate = ta.init_mhsa_state(2, module.cfg, "cpu")
    outs = []
    with torch.no_grad():
        for lo in range(0, 20, 4):
            chunk = x[:, lo:lo + 4]
            jout, jstate = ja.mhsa_apply_streaming(params, jnp.asarray(chunk),
                                                   jcfg, jstate)
            tout, tstate = module(torch.as_tensor(chunk), state=tstate)
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(tstate.tail.numpy(),
                                       np.asarray(jstate.tail), rtol=0,
                                       atol=ATOL)
            assert int(tstate.pos) == int(jstate.pos)
            outs.append(tout)
        oneshot = module(torch.as_tensor(x),
                         torch.as_tensor(ta.causal_mask(20, 6, 2, alibi)))
    torch.testing.assert_close(torch.cat(outs, 1), oneshot, rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("stream", [False, True])
def test_tconvffn_matches_jax(stream):
    """One-shot, and chunk by chunk with the carried conv tail (1e-5)."""
    jcfg = ja.TConvFFNConfig(16, 3, 8, 2)
    params = ja.init_tconvffn_params(jax.random.PRNGKey(5), jcfg)
    module = port(ta.TConvFFN(ta.TConvFFNConfig(16, 3, 8, 2), device="cpu"),
                  params)
    x = np.random.default_rng(6).standard_normal((2, 12, 16)).astype(
        np.float32)
    with torch.no_grad():
        if not stream:
            want = ja.tconvffn_apply(params, jnp.asarray(x), jcfg)
            got = module(torch.as_tensor(x))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL)
            return
        jstate = ja.init_tconvffn_state(2, jcfg)
        tstate = ta.init_tconvffn_state(2, module.cfg)
        for lo in range(0, 12, 3):
            chunk = x[:, lo:lo + 3]
            want, jstate = ja.tconvffn_apply(params, jnp.asarray(chunk), jcfg,
                                             state=jstate)
            got, tstate = module(torch.as_tensor(chunk), tstate)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                                       rtol=0, atol=ATOL)
