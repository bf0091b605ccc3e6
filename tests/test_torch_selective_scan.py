"""The port's fused selective scan (kernels.ssm_cuda's
``selective_scan_fwd_plain`` / ``selective_scan_bwd_plain``, which K3 and
K4 compute on the card, and models.mamba's ``SSMScan`` over them) against
fnssl_tpu on the CPU: JAX's ``_ssm_inputs``, then ``ssm_scan``, then + D·x,
with ``jax.vjp`` for the gradients (one jitted program a length, so that
JAX compiles once and not op by op). Parameters and inputs come from
numpy seeds.

Small sizes: d_model 16 (d_inner 32, dt_rank 1, d_state 16), B 2, L 0, 1
and 7, nonzero h0 and dh_last, one channel's dt_proj bias at 25 so that
dt + bias passes the softplus threshold (20; JAX's softplus has none, and
the two differ there by under 2e-9).

Tolerances: the forward within 1e-5 relative + 1e-6 absolute of JAX in
float32; every gradient within 1e-5 of its largest magnitude (float32 sums
of 16 states and of the batch in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.mamba as jmamba
import fnssl_tpu_torch.models.mamba as tmamba
from fnssl_tpu_torch.kernels import ssm_cuda

D_MODEL, BATCH = 16, 2


CFG = jmamba.MambaConfig(D_MODEL)


def params_and_inputs(seed, steps):
    """The scan's Mamba parameters as JAX's ``init_mamba_params`` draws
    them (x_proj, dt_proj weights uniform in ±1/sqrt(fan_in); dt_proj's
    bias the inverse softplus of a dt log-uniform in [1e-3, 0.1], 25 on
    channel 0; A_log = log(1..16); D = 1) and x (B, L, d_inner), h0, dy,
    dh_last, all float32 numpy from `seed`."""
    rng = np.random.default_rng(seed)
    di, n, dr = CFG.d_inner, CFG.d_state, CFG.dt_rank
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
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def jax_chain(x, x_proj, dt_proj, dt_bias, a_log, d_skip, h0):
    """x → y = ssm_scan(_ssm_inputs(x)) + D·x and h_last, as JAX's
    ``mamba_step`` computes them between the conv and the gate."""
    params = {"x_proj": {"weight": x_proj},
              "dt_proj": {"weight": dt_proj, "bias": dt_bias},
              "A_log": a_log}
    da, dbx, c = jmamba._ssm_inputs(params, x, CFG)
    ys, h_last = jmamba.ssm_scan(jnp.swapaxes(da, 0, 1),
                                 jnp.swapaxes(dbx, 0, 1),
                                 jnp.swapaxes(c, 0, 1), h0)
    return jnp.swapaxes(ys, 0, 1) + d_skip * x, h_last


@jax.jit
def jax_chain_and_vjp(args, cotangents):
    """JAX's chain and ``jax.vjp`` of it at `cotangents`, one program."""
    out, vjp = jax.vjp(jax_chain, *args)
    return out, vjp(cotangents)


def close_to_largest(got, want, what):
    if not want.size:
        return
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-5 * scale, f"{what}: {err:.3e} of largest {scale:.3e}"


@pytest.mark.parametrize("steps", [0, 1, 7])
def test_fused_plain_scan_matches_jax(steps):
    """selective_scan_fwd_plain against JAX's chain; selective_scan_bwd_plain,
    carried back through the x_proj and dt_proj products and A = -exp(A_log)
    by hand, against ``jax.vjp`` of it: every gradient."""
    arr = params_and_inputs(steps + 1, steps)
    wx, wdt = arr["x_proj"], arr["dt_proj"]
    (jy, jh), jgrads = jax_chain_and_vjp(
        tuple(jnp.asarray(arr[k]) for k in ("x", "x_proj", "dt_proj",
                                            "dt_bias", "A_log", "D", "h0")),
        (jnp.asarray(arr["dy"]), jnp.asarray(arr["dh_last"])))
    jgrads = [np.asarray(g) for g in jgrads]

    dr, n = CFG.dt_rank, CFG.d_state
    x = torch.as_tensor(arr["x"])
    x_dbl = x @ torch.as_tensor(wx).T
    delta, bm, c = torch.split(x_dbl, [dr, n, n], dim=-1)
    dt = delta @ torch.as_tensor(wdt).T
    a = -torch.exp(torch.as_tensor(arr["A_log"]))
    args = (x, dt, torch.as_tensor(arr["dt_bias"]), a, bm.contiguous(),
            c.contiguous(), torch.as_tensor(arr["D"]),
            torch.as_tensor(arr["h0"]))
    y, h = ssm_cuda.selective_scan_fwd_plain(*args)
    assert y.shape == (BATCH, steps, CFG.d_inner)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)

    gx, gdt, gbias, ga, gbm, gc, gd, gh0 = (
        g.double().numpy() for g in ssm_cuda.selective_scan_bwd_plain(
            *args, torch.as_tensor(arr["dy"]),
            torch.as_tensor(arr["dh_last"])))
    g_delta = gdt @ wdt                                  # (B, L, dr)
    g_dbl = np.concatenate([g_delta, gbm, gc], axis=-1)
    mine = {"x": gx + g_dbl @ wx,
            "x_proj": np.einsum("blk,bli->ki", g_dbl, arr["x"]),
            "dt_proj": np.einsum("bld,blr->dr", gdt, delta.numpy()),
            "dt_bias": gbias, "A_log": ga * a.numpy(), "D": gd,
            "h0": gh0}
    for (name, got), want in zip(mine.items(), jgrads):
        assert got.shape == want.shape, name
        close_to_largest(got, want, name)


@pytest.mark.parametrize("steps", [0, 1, 7, 17])
def test_plain_backward_is_autograd_of_plain_forward(steps):
    """The explicit reverse loop equals torch autograd through
    ``selective_scan_fwd_plain`` (which builds exp(Δ·A) and Δ·x·B), every
    gradient within 1e-5 of its largest; a dt above the softplus
    threshold included; L 17 spans three of K4's 8-step segments."""
    rng = np.random.default_rng(10 + steps)
    shapes = {"x": (2, steps, 8), "dt": (2, steps, 8), "dt_bias": (8,),
              "a": (8, 16), "bm": (2, steps, 16), "c": (2, steps, 16),
              "d": (8,), "h0": (2, 8, 16)}
    arr = {k: rng.standard_normal(v).astype(np.float32)
           for k, v in shapes.items()}
    arr["a"] = -np.exp(arr["a"])
    arr["dt_bias"][0] = 25.0
    ins = [torch.tensor(arr[k], requires_grad=True) for k in shapes]
    y, h = ssm_cuda.selective_scan_fwd_plain(*ins)
    dy = torch.as_tensor(rng.standard_normal(y.shape).astype(np.float32))
    dh = torch.as_tensor(rng.standard_normal(h.shape).astype(np.float32))
    torch.autograd.backward((y, h), (dy, dh))
    got = ssm_cuda.selective_scan_bwd_plain(*(t.detach() for t in ins), dy,
                                            dh)
    for name, t, g in zip(shapes, ins, got):
        assert g.shape == t.shape and g.dtype == torch.float32, name
        want = (t.grad if t.grad is not None else torch.zeros_like(t))
        close_to_largest(g.numpy(), want.numpy(), name)


def test_mamba_train_step_saves_no_state_sized_tensor(monkeypatch):
    """A Mamba train step (forward, loss, backward) through ``mamba_step``
    saves no tensor of B·L·d·n elements for its backward; the same block
    over the plain forward under autograd (the (da, dbx) chain) does."""
    b, steps = 2, 7
    model = tmamba.Mamba(tmamba.MambaConfig(D_MODEL), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    cfg = model.cfg
    big = b * steps * cfg.d_inner * cfg.d_state
    u = torch.randn(b, steps, D_MODEL,
                    generator=torch.Generator().manual_seed(1))

    def saved_sizes(fn):
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn()
        out.square().mean().backward()
        return sizes

    state = tmamba.init_mamba_state(b, cfg)
    sizes = saved_sizes(lambda: tmamba.mamba_step(model, u, state)[0])
    assert sizes and max(sizes) < big, (max(sizes), big)
    assert all(p.grad is not None for p in model.parameters())

    monkeypatch.setattr(tmamba, "ssm_scan",
                        lambda *a: ssm_cuda.selective_scan_fwd_plain(*a))
    unfused = saved_sizes(lambda: tmamba.mamba_step(model, u, state)[0])
    assert max(unfused) >= big
