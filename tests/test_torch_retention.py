"""The port's multi-scale retention (fnssl_tpu_torch.models.retention)
against fnssl_tpu on the CPU: the relative-position tables, the rotary
shift and each of the three modes on the same numpy inputs and the same
weights (``params_to_state_dict``, strict loads).

Tolerances: tables and theta_shift 1e-6; each mode against JAX 1e-5; the
three modes against each other at the JAX test's own tolerances
(tests/test_retention_mamba.py: rtol 0.05, atol 0.02, the chunkwise
mode's cross-chunk rescaling).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.retention as jr
import fnssl_tpu_torch.models.retention as tr
from fnssl_tpu_torch.train.convert import params_to_state_dict

ATOL = 1e-5


def leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda a: isinstance(a,
                                                              torch.Tensor))


def ret_pair(seed=0, e=24, heads=4, **kw):
    jcfg = jr.RetentionConfig(e, heads, **kw)
    params = jr.init_retention_params(jax.random.PRNGKey(seed), jcfg)
    module = tr.Retention(tr.RetentionConfig(e, heads, **kw), device="cpu")
    module.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    return jcfg, params, module.eval()


@pytest.mark.parametrize("mode", [
    {}, {"chunkwise_recurrent": True}, {"activate_recurrent": True}])
@pytest.mark.parametrize("decay", [None, 3, False])
def test_relpos_tables_match_jax(mode, decay):
    want = jr.RetNetRelPos(24, 4, 5, decay=decay)(13, **mode)
    got = tr.RetNetRelPos(24, 4, 5, decay=decay)(13, **mode)
    assert len(leaves(got)) == len(jax.tree.leaves(want))
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("table", ["matrix", "vector"])
def test_theta_shift_matches_jax(table):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 9, 6)).astype(np.float32)
    shape = (9, 6) if table == "matrix" else (6,)
    sin, cos = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
    want = jr.theta_shift(jnp.asarray(x), jnp.asarray(sin), jnp.asarray(cos))
    got = tr.theta_shift(*(torch.as_tensor(a) for a in (x, sin, cos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("cfg_kw", [{}, {"share_qk": True},
                                    {"look_ahead": 2}])
def test_parallel_and_chunkwise_match_jax(rope, cfg_kw):
    """21 frames (not a multiple of the chunk of 8: the padding path); the
    parallel mode's tables cover the look-ahead's extra frames."""
    jcfg, params, module = ret_pair(seed=2, **cfg_kw)
    slen = 21 + jcfg.look_ahead
    pos_j, pos_t = jr.RetNetRelPos(24, 4, 8), tr.RetNetRelPos(24, 4, 8)
    x = np.random.default_rng(3).standard_normal((2, 21, 24)).astype(
        np.float32)
    with torch.no_grad():
        for fn, kw in (("retention_parallel", {}),
                       ("retention_chunkwise",
                        {"chunkwise_recurrent": True})):
            want = getattr(jr, fn)(params, jnp.asarray(x),
                                   pos_j(slen, **kw), jcfg, rope=rope)
            got = getattr(tr, fn)(module, torch.as_tensor(x),
                                  pos_t(slen, **kw), rope=rope)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL, err_msg=fn)


@pytest.mark.parametrize("rope", [False, True])
def test_recurrent_steps_match_jax(rope):
    """12 single-frame steps carrying the rescaled kv state."""
    jcfg, params, module = ret_pair(seed=4)
    pos_j, pos_t = jr.RetNetRelPos(24, 4, 8), tr.RetNetRelPos(24, 4, 8)
    x = np.random.default_rng(5).standard_normal((2, 12, 24)).astype(
        np.float32)
    jstate = tstate = None
    with torch.no_grad():
        for t in range(12):
            want, jstate = jr.retention_recurrent_step(
                params, jnp.asarray(x[:, t:t + 1]),
                pos_j(t + 1, activate_recurrent=True), jcfg, jstate,
                rope=rope)
            got, tstate = tr.retention_recurrent_step(
                module, torch.as_tensor(x[:, t:t + 1]),
                pos_t(t + 1, activate_recurrent=True), tstate, rope=rope)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL)
            for k in ("prev_key_value", "scale"):
                np.testing.assert_allclose(tstate[k].numpy(),
                                           np.asarray(jstate[k]), rtol=0,
                                           atol=ATOL)


def test_three_mode_equivalence():
    """parallel == chunkwise == per-step recurrent in the port
    (tests/test_retention_mamba.py:66's check, retention.py:303-326)."""
    _, _, module = ret_pair(seed=2)
    pos = tr.RetNetRelPos(24, 4, recurrent_chunk_size=10)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 30, 24)).astype(np.float32))
    with torch.no_grad():
        y_par = tr.retention_parallel(module, x, pos(30))
        y_chunk = tr.retention_chunkwise(
            module, x, pos(30, chunkwise_recurrent=True))
        state, ys = None, []
        for t in range(30):
            y, state = tr.retention_recurrent_step(
                module, x[:, t:t + 1], pos(t + 1, activate_recurrent=True),
                state)
            ys.append(y)
    torch.testing.assert_close(y_chunk, y_par, rtol=0.05, atol=0.02)
    torch.testing.assert_close(torch.cat(ys, 1), y_par, rtol=0.05,
                               atol=0.02)
