"""The port's smaller modules against fnssl_tpu on the CPU: the norm zoo,
grouped linears and non-linear factory (models.norms), the chunked
inference reshapes (data.segments), the track association and IPDnet2's
MSE decode (eval.decode), and Mamba's ``use_associative`` option
(models.mamba), which the port runs on its default path. The same numpy inputs and weights go through both.

Tolerances: norms, linears, the MSE decode and Mamba 1e-5; segments and
track association exact (grid points and reorderings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.data.segments as jseg
import fnssl_tpu.eval.decode as jdecode
import fnssl_tpu.models.mamba as jmamba
import fnssl_tpu.models.norms as jn
import fnssl_tpu_torch.data.segments as tseg
import fnssl_tpu_torch.eval.decode as tdecode
import fnssl_tpu_torch.models.mamba as tmamba
import fnssl_tpu_torch.models.norms as tn
from fnssl_tpu_torch.train.convert import params_to_state_dict
from tests.test_torch_threads import torch_threads  # noqa: F401


ATOL = 1e-5


def as_torch(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def affine(rng, dim, seq_last=False):
    shape = (dim, 1) if seq_last else (dim,)
    return {"weight": rng.uniform(0.5, 1.5, shape).astype(np.float32),
            "bias": rng.standard_normal(shape).astype(np.float32)}


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("norm_type,seq_last", [
    ("LN", False), ("LN", True), ("GBN", False), ("GBN", True),
    ("GBNShare", False), ("BN", False), ("BN", True), ("GN", True),
    ("GN", False), ("gLN", False)])
def test_new_norm_matches_jax(norm_type, seq_last):
    """Each factory's init and apply, with random affine parameters of
    the init's shapes."""
    rng = np.random.default_rng(0)
    jinit, japply = jn.new_norm(norm_type, 8, seq_last, group_size=3,
                                num_groups=2)
    tinit, tapply = tn.new_norm(norm_type, 8, seq_last, group_size=3,
                                num_groups=2)
    jp, tp = jinit(), tinit()
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    p = {k: rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
         for k, v in jp.items()}
    shape = (6, 8, 5) if seq_last else (6, 5, 8)
    if norm_type == "gLN":
        shape = (6, 5, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    close(tapply(as_torch(p), torch.as_tensor(x)),
          japply(p, jnp.asarray(x)))


def test_norm_functions_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 6, 8)).astype(np.float32)
    p, pl = affine(rng, 8), affine(rng, 6, seq_last=True)
    tx = torch.as_tensor(x)
    close(tn.layer_norm(as_torch(p), tx), jn.layer_norm(p, x))
    close(tn.layer_norm(as_torch(pl), tx, seq_last=True),
          jn.layer_norm(pl, x, seq_last=True))
    close(tn.global_layer_norm(as_torch(p), tx),
          jn.global_layer_norm(p, x))
    close(tn.batch_norm_1d(as_torch(p), tx, seq_last=False),
          jn.batch_norm_1d(p, x, seq_last=False))
    x4 = rng.standard_normal((2, 8, 3, 5)).astype(np.float32)
    close(tn.group_norm(as_torch(p), torch.as_tensor(x4), 4),
          jn.group_norm(p, x4, 4))
    close(tn.group_batch_norm(as_torch(p), tx, 2, seq_last=False,
                              share_along_sequence_dim=True),
          jn.group_batch_norm(p, x, 2, seq_last=False,
                              share_along_sequence_dim=True))


@pytest.mark.parametrize("kind", ["linear_group", "linear_group_shared",
                                  "conv1d_group"])
@pytest.mark.parametrize("bias", [True, False])
def test_grouped_linears_match_jax(kind, bias):
    """JAX's init carried over; the port's own init has the same shapes
    and bounds."""
    rng = np.random.default_rng(2)
    args = (6, 5, 3) + ((3,) if kind == "conv1d_group" else ())
    p = getattr(jn, f"init_{kind}")(jax.random.PRNGKey(0), *args,
                                    bias=bias)
    own = getattr(tn, f"init_{kind}")(*args, bias=bias,
                                      generator=torch.Generator())
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(np.shape(v)) for k, v in p.items()}
    for k in p:
        bound = float(np.abs(np.asarray(p[k])).max())
        assert float(own[k].abs().max()) <= bound * 1.5
    shape = (2, 7, 3, 6) if kind == "conv1d_group" else (2, 4, 3, 6)
    x = rng.standard_normal(shape).astype(np.float32)
    close(getattr(tn, kind)(as_torch(p), torch.as_tensor(x)),
          getattr(jn, kind)(p, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["prelu", "silu", "sigmoid", "relu",
                                  "leakyrelu", "elu"])
@pytest.mark.parametrize("seq_last", [False, True])
def test_new_non_linear_matches_jax(name, seq_last):
    jinit, japply = jn.new_non_linear(name, 8, seq_last)
    tinit, tapply = tn.new_non_linear(name, 8, seq_last)
    jp, tp = jinit(), tinit()
    assert sorted(jp) == sorted(tp)
    x = np.random.default_rng(3).standard_normal(
        (2, 8, 5) if seq_last else (2, 5, 8)).astype(np.float32)
    close(tapply(tp, torch.as_tensor(x)), japply(jp, jnp.asarray(x)))
    with pytest.raises(ValueError):
        tn.new_non_linear("tanhh", 8, seq_last)


@pytest.mark.parametrize("nt", [24, 30])
def test_segments_are_exact(nt):
    x = np.random.default_rng(4).standard_normal((2, 3, 4, nt)).astype(
        np.float32)
    jx, jnt = jseg.pad_segments(jnp.asarray(x), 8)
    tx, tnt = tseg.pad_segments(torch.as_tensor(x), 8)
    assert tnt == jnt == nt
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    js_, jo = jseg.split_segments(jnp.asarray(x), 8)
    ts_, to = tseg.split_segments(torch.as_tensor(x), 8)
    assert to == jo
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    y = np.random.default_rng(5).standard_normal(
        (ts_.shape[0], 3, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tseg.merge_segments(torch.as_tensor(y), 2, 10).numpy(),
        np.asarray(jseg.merge_segments(jnp.asarray(y), 2, 10)))


@pytest.mark.parametrize("ns", [2, 3])
@pytest.mark.parametrize("grid", [False, True])
def test_track_associate_is_exact(ns, grid):
    """Random DOAs, and DOAs on a coarse grid (exact cost ties, broken as
    JAX breaks them)."""
    doa = np.random.default_rng(6).uniform(0, 2 * np.pi, (3, 30, 2, ns))
    if grid:
        doa = np.round(doa * 2) / 2
    doa = doa.astype(np.float32)
    np.testing.assert_array_equal(
        tdecode.track_associate(torch.as_tensor(doa)).numpy(),
        np.asarray(jdecode.track_associate(jnp.asarray(doa))))


@pytest.mark.parametrize("mode,ns", [("unkNum", 1), ("unkNum", 2),
                                     ("kNum", 2)])
def test_mse_decode_matches_jax(mode, ns):
    rng = np.random.default_rng(7)
    ipd = rng.uniform(-1, 1, (2, 6, 8, 2)).astype(np.float32)
    tmpl = rng.uniform(-1, 1, (1, 12, 8, 2)).astype(np.float32)
    cand = (np.array([np.pi / 2], np.float32),
            np.linspace(0, np.pi, 12).astype(np.float32))
    want = jdecode.mse_decode(ipd, tmpl, *cand, max_num_sources=ns,
                              source_num_mode=mode)
    got = tdecode.mse_decode(torch.as_tensor(ipd), torch.as_tensor(tmpl),
                             *(torch.as_tensor(c) for c in cand),
                             max_num_sources=ns, source_num_mode=mode)
    np.testing.assert_array_equal(got.doa.numpy(), np.asarray(want.doa))
    for g, w in ((got.vad, want.vad),
                 (got.spatial_spectrum, want.spatial_spectrum)):
        close(g, w)


@pytest.mark.parametrize("steps", [1, 9, 32])
def test_mamba_associative_matches_jax_and_sequential(steps):
    cfg = jmamba.MambaConfig(16, d_state=8)
    params = jmamba.init_mamba_params(jax.random.PRNGKey(8), cfg)
    model = tmamba.Mamba(tmamba.MambaConfig(16, d_state=8), device="cpu")
    model.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    u = np.random.default_rng(9).standard_normal((3, steps, 16)).astype(
        np.float32)
    want = jmamba.mamba_apply(params, jnp.asarray(u), cfg,
                              use_associative=True)
    with torch.no_grad():
        got = tmamba.mamba_apply(model, torch.as_tensor(u),
                                 use_associative=True)
        seq = tmamba.mamba_apply(model, torch.as_tensor(u))
    close(got, want)
    torch.testing.assert_close(got, seq, rtol=0, atol=ATOL)
