"""The fused selective scan at other d_state than 16, on the CPU (no card,
no nvcc).

``ssm_scan.cu`` is built for n = 8, 16, 32 and 64 (n / 4 lanes a channel,
512 / n channels a block); any other n up to 64 runs on the card padded to
the next of them (``padded_state``; ``selective_scan_fwd_padded``,
``selective_scan_bwd_padded``: zero columns in A, B, C, h0 and dh_last),
above 64 the card raises. Here: the wrapper's sizing against the source's,
and the padding, run through the plain versions that the card's kernels
are held against, against JAX's chain (``_ssm_inputs``, ``ssm_scan``,
+ D·x, ``jax.vjp`` for the gradients) at n = 24 (padded to 32): the
padding is exact. The kernels themselves are checked on the card
(tests/test_torch_ipdnet2_cuda.py, chip_smoke.py phase 17).

Small sizes: d_model 16 (d_inner 32, dt_rank 1), B 2, L 1 and 9, nonzero
h0 and dh_last, one channel's dt_proj bias at 25 (past the softplus
threshold). Tolerances as tests/test_torch_selective_scan.py: the forward
within 1e-5 relative + 1e-6 absolute of JAX; every gradient within 1e-5
of its largest magnitude; the padded plain versions against the unpadded
ones within 1e-6 relative to the largest value.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.mamba as jmamba
from fnssl_tpu_torch.kernels import cuda_build
from fnssl_tpu_torch.kernels import ssm_cuda as S

D_MODEL, BATCH = 16, 2


def test_padded_state_and_slices():
    assert [S.padded_state(n) for n in (1, 8, 9, 16, 17, 24, 32, 33, 64)] \
        == [8, 8, 16, 16, 32, 32, 32, 64, 64]
    with pytest.raises(ValueError, match="d_state=72"):
        S.padded_state(72)
    assert [S.slice_channels(n) for n in S.D_STATES] == [64, 32, 16, 8]


def test_the_source_is_built_for_the_wrappers_states():
    """ssm_scan.cu instantiates both kernels for each n of D_STATES, in both
    dtypes, with the block's threads and K4's segment the wrapper sizes its
    partials and checkpoints by."""
    src = (cuda_build.CSRC / "ssm_scan.cu").read_text()
    assert ("return d_state == 8 || d_state == 16 || d_state == 32 || "
            "d_state == 64;" in src)
    for n in S.D_STATES:
        for dtype in ("float", "__nv_bfloat16"):
            assert re.search(rf"launch<{n}, {dtype}>", src), (n, dtype)
    assert f"kThreads = {S.THREADS};" in src
    assert f"kGroup = {S.SEGMENT};" in src
    assert "static constexpr int kCh = kThreads / kTpc;" in src
    assert "static constexpr int kTpc = kN / kQ;" in src
    assert "constexpr int kQ = 4;" in src


def params_and_inputs(seed, steps, n):
    rng = np.random.default_rng(seed)
    cfg = jmamba.MambaConfig(D_MODEL, d_state=n)
    di, dr = cfg.d_inner, cfg.dt_rank
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), di))
    bias = dt + np.log(-np.expm1(-dt))
    bias[0] = 25.0
    arrays = {"x_proj": rng.uniform(-1, 1, (dr + 2 * n, di)) / np.sqrt(di),
              "dt_proj": rng.uniform(-1, 1, (di, dr)) / np.sqrt(dr),
              "dt_bias": bias,
              "A_log": np.log(np.tile(np.arange(1, n + 1), (di, 1))),
              "D": np.ones(di),
              "x": rng.standard_normal((BATCH, steps, di)),
              "h0": rng.standard_normal((BATCH, di, n)),
              "dy": rng.standard_normal((BATCH, steps, di)),
              "dh_last": rng.standard_normal((BATCH, di, n))}
    return cfg, {k: v.astype(np.float32) for k, v in arrays.items()}


def jax_chain_and_vjp(cfg, args, cotangents):
    """JAX's chain x → y = ssm_scan(_ssm_inputs(x)) + D·x, h_last, and
    ``jax.vjp`` of it at `cotangents`."""
    def chain(x, x_proj, dt_proj, dt_bias, a_log, d_skip, h0):
        params = {"x_proj": {"weight": x_proj},
                  "dt_proj": {"weight": dt_proj, "bias": dt_bias},
                  "A_log": a_log}
        da, dbx, c = jmamba._ssm_inputs(params, x, cfg)
        ys, h_last = jmamba.ssm_scan(jnp.swapaxes(da, 0, 1),
                                     jnp.swapaxes(dbx, 0, 1),
                                     jnp.swapaxes(c, 0, 1), h0)
        return jnp.swapaxes(ys, 0, 1) + d_skip * x, h_last

    out, vjp = jax.vjp(chain, *args)
    return out, vjp(cotangents)


def close_to_largest(got, want, what, tol=1e-5):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} of largest {scale:.3e}"


def fused_args(cfg, arr):
    """The fused scan's inputs from the chain's: x_proj and dt_proj's
    products, A = -exp(A_log)."""
    dr, n = cfg.dt_rank, cfg.d_state
    x = torch.as_tensor(arr["x"])
    delta, bm, c = torch.split(x @ torch.as_tensor(arr["x_proj"]).T,
                               [dr, n, n], dim=-1)
    dt = delta @ torch.as_tensor(arr["dt_proj"]).T
    a = -torch.exp(torch.as_tensor(arr["A_log"]))
    return (x, dt, torch.as_tensor(arr["dt_bias"]), a, bm.contiguous(),
            c.contiguous(), torch.as_tensor(arr["D"]),
            torch.as_tensor(arr["h0"])), delta


@pytest.mark.parametrize("steps", [1, 9])
def test_padded_scan_at_n24_matches_jax(steps):
    """The scan at n = 24 as the card runs it, padded to 32, through the
    plain versions: y and h_last against JAX's chain; every gradient,
    carried back through x_proj, dt_proj and A = -exp(A_log) by hand,
    against ``jax.vjp`` of it."""
    cfg, arr = params_and_inputs(24 + steps, steps, 24)
    (jy, jh), jgrads = jax_chain_and_vjp(
        cfg, tuple(jnp.asarray(arr[k]) for k in (
            "x", "x_proj", "dt_proj", "dt_bias", "A_log", "D", "h0")),
        (jnp.asarray(arr["dy"]), jnp.asarray(arr["dh_last"])))
    args, delta = fused_args(cfg, arr)
    assert S.padded_state(24) == 32
    y, h = S.selective_scan_fwd_padded(S.selective_scan_fwd_plain, *args)
    assert h.shape == (BATCH, cfg.d_inner, 24) and h.is_contiguous()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)

    grads = S.selective_scan_bwd_padded(
        S.selective_scan_bwd_plain, *args, torch.as_tensor(arr["dy"]),
        torch.as_tensor(arr["dh_last"]))
    for g, t in zip(grads, args):
        assert g.shape == t.shape and g.is_contiguous()
    gx, gdt, gbias, ga, gbm, gc, gd, gh0 = (g.double().numpy()
                                            for g in grads)
    wx, wdt = arr["x_proj"], arr["dt_proj"]
    g_dbl = np.concatenate([gdt @ wdt, gbm, gc], axis=-1)
    mine = {"x": gx + g_dbl @ wx,
            "x_proj": np.einsum("blk,bli->ki", g_dbl, arr["x"]),
            "dt_proj": np.einsum("bld,blr->dr", gdt, delta.numpy()),
            "dt_bias": gbias, "A_log": ga * args[3].numpy(), "D": gd,
            "h0": gh0}
    for (name, got), want in zip(mine.items(), jgrads):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        close_to_largest(got, want, name)


@pytest.mark.parametrize("n", [5, 24, 40])
def test_padding_equals_the_unpadded_plain_versions(n):
    """The padded plain forward and backward against the plain versions
    at n itself (n = 5, 24 and 40 padded to 8, 32 and 64)."""
    cfg, arr = params_and_inputs(n, 9, n)
    args, _ = fused_args(cfg, arr)
    extra = (torch.as_tensor(arr["dy"]), torch.as_tensor(arr["dh_last"]))
    pairs = zip(
        S.selective_scan_fwd_padded(S.selective_scan_fwd_plain, *args)
        + S.selective_scan_bwd_padded(S.selective_scan_bwd_plain, *args,
                                      *extra),
        S.selective_scan_fwd_plain(*args)
        + S.selective_scan_bwd_plain(*args, *extra))
    for i, (got, want) in enumerate(pairs):
        assert got.shape == want.shape, i
        close_to_largest(got.numpy(), want.numpy(), i, tol=1e-6)


def test_cpu_tensors_take_the_plain_version_at_any_state():
    """On the CPU the wrappers run the plain versions at n itself (24, and
    72, which the card refuses) and move no counter."""
    counters = (S.launches_ssm_fwd, S.launches_ssm_bwd)
    before = [c.value for c in counters]
    for n in (24, 72):
        cfg, arr = params_and_inputs(n, 3, n)
        args, _ = fused_args(cfg, arr)
        extra = (torch.as_tensor(arr["dy"]), torch.as_tensor(arr["dh_last"]))
        for got, want in zip(
                S.selective_scan_fwd(*args)
                + S.selective_scan_bwd(*args, *extra),
                S.selective_scan_fwd_plain(*args)
                + S.selective_scan_bwd_plain(*args, *extra)):
            assert torch.equal(got, want)
    assert [c.value for c in counters] == before
