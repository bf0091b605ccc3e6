"""The port's IPDnet2 model path (fnssl_tpu_torch: kernels.ssm_cuda's plain
scans, (da, dbx) and fused, models.mamba, models.spatialnet, physics.dpipd's DPIPD2,
physics.targets' energy_vad, data.arrays' Westlake array and
runtime.streaming's center=True front end with make_spatialnet_stream_step)
against fnssl_tpu on the CPU. Inputs come from numpy seeds; the JAX weights
are carried across with ``params_to_state_dict`` and load strictly.

Small sizes: SpatialNet at 2 layers, hidden 16, 32 bins, 3 mics, nb 2;
Mamba at d_model 16 (d_inner 32); scans at B 2, d 8, L 0/1/7.

Tolerances: the scan and its gradients atol 2e-6 (float32 sums of up to
16 states in another order; measured ~2e-6 at values ~10); Mamba and
SpatialNet outputs and states atol 1e-5 (measured ~5e-7); targets 1e-5;
the streamed front end and model atol 1e-5 against the one-shot.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.mamba as jmamba
import fnssl_tpu.models.spatialnet as js
import fnssl_tpu_torch.models.mamba as tmamba
import fnssl_tpu_torch.models.spatialnet as ts
from fnssl_tpu.data import arrays as jarrays
from fnssl_tpu.physics import dpipd as jdpipd
from fnssl_tpu.physics import targets as jtargets
from fnssl_tpu.runtime import streaming as jstreaming
from fnssl_tpu.train.preprocess import stft_features as jstft_features
from fnssl_tpu_torch.data import arrays as tarrays
from fnssl_tpu_torch.kernels import ssm_cuda
from fnssl_tpu_torch.physics import dpipd as tdpipd
from fnssl_tpu_torch.physics import targets as ttargets
from fnssl_tpu_torch.runtime import streaming as tstreaming
from fnssl_tpu_torch.runtime.export import _resolve
from fnssl_tpu_torch.train.convert import params_to_state_dict
from fnssl_tpu_torch.train.preprocess import stft_features

SMALL = dict(dim_input=6, dim_output=8, num_layers=2, num_freqs=32,
             dim_hidden=16)
ATOL = 1e-5


def port(model, params):
    model.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    return model.eval()


def leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda a: isinstance(a,
                                                              torch.Tensor))


def scan_inputs(seed, batch, steps, dim, n=16):
    rng = np.random.default_rng(seed)
    return {"da": rng.uniform(0.5, 1.0, (batch, steps, dim, n)),
            "dbx": rng.standard_normal((batch, steps, dim, n)),
            "c": rng.standard_normal((batch, steps, n)),
            "h0": rng.standard_normal((batch, dim, n)),
            "dy": rng.standard_normal((batch, steps, dim)),
            "dh_last": rng.standard_normal((batch, dim, n))}


def time_major(a):
    return jnp.swapaxes(jnp.asarray(a, jnp.float32), 0, 1)


@pytest.mark.parametrize("steps", [0, 1, 7])
def test_plain_ssm_scan_matches_jax(steps):
    """y and h_last against JAX's ``ssm_scan``; every gradient against
    ``jax.vjp(_ssm_scan_ref)``, with nonzero h0 and dh_last."""
    x = {k: v.astype(np.float32) for k, v in
         scan_inputs(steps, 2, steps, 8).items()}
    (ys, h_last), vjp = jax.vjp(
        jmamba._ssm_scan_ref, time_major(x["da"]), time_major(x["dbx"]),
        time_major(x["c"]), jnp.asarray(x["h0"]))
    jys = jmamba.ssm_scan(time_major(x["da"]), time_major(x["dbx"]),
                          time_major(x["c"]), jnp.asarray(x["h0"]))[0]
    np.testing.assert_array_equal(np.asarray(jys), np.asarray(ys))
    grads = vjp((time_major(x["dy"]), jnp.asarray(x["dh_last"])))
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    y, h = ssm_cuda.ssm_scan_fwd_plain(t["da"], t["dbx"], t["c"], t["h0"])
    assert y.shape == (2, steps, 8)
    np.testing.assert_allclose(y.numpy(), np.swapaxes(np.asarray(ys), 0, 1),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_last), rtol=0,
                               atol=2e-6)
    got = ssm_cuda.ssm_scan_bwd_plain(t["da"], t["dbx"], t["c"], t["h0"],
                                      t["dy"], t["dh_last"])
    for name, g, want in zip(("da", "dbx", "c", "h0"), got, grads):
        want = np.asarray(want)
        if name != "h0":
            want = np.swapaxes(want, 0, 1)
        assert g.shape == want.shape, name
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=2e-6,
                                   err_msg=name)


def test_ssm_scan_autograd_is_the_plain_backward():
    """``SSMScan`` (the fused scan) gives, through torch autograd, the
    plain fused backward's gradients of every input, and bfloat16 x, dt,
    B, C give float32 y and state, with bf16 gradients of those inputs and
    float32 ones of the parameters, as JAX's promotion."""
    rng = np.random.default_rng(3)
    shapes = {"x": (2, 5, 8), "dt": (2, 5, 8), "dt_bias": (8,),
              "a": (8, 16), "bm": (2, 5, 16), "c": (2, 5, 16), "d": (8,),
              "h0": (2, 8, 16)}
    x = {k: rng.standard_normal(v) for k, v in shapes.items()}
    x["a"] = -np.exp(x["a"])
    dy, dh = rng.standard_normal((2, 5, 8)), rng.standard_normal((2, 8, 16))
    for dtype in (torch.float32, torch.bfloat16):
        t = {k: torch.tensor(v, dtype=torch.float32) for k, v in x.items()}
        ins = [t[k].to(dtype if k in ("x", "dt", "bm", "c") else
                       torch.float32).requires_grad_() for k in shapes]
        y, h = tmamba.SSMScan.apply(*ins)
        assert y.dtype == h.dtype == torch.float32
        gy, gh = (torch.tensor(v, dtype=torch.float32) for v in (dy, dh))
        (y * gy).sum().add_((h * gh).sum()).backward()
        want = ssm_cuda.selective_scan_bwd_plain(
            *(i.detach() for i in ins), gy, gh)
        for i, w in zip(ins, want):
            assert i.grad.dtype == i.dtype == w.dtype
            torch.testing.assert_close(i.grad, w, rtol=0, atol=0)


@pytest.fixture(scope="module")
def mamba():
    cfg = jmamba.MambaConfig(16)
    params = jmamba.init_mamba_params(jax.random.PRNGKey(3), cfg)
    model = port(tmamba.Mamba(tmamba.MambaConfig(16), device="cpu"),
                 params)
    return cfg, params, model


def test_mamba_apply_and_step_match_jax(mamba):
    cfg, params, model = mamba
    rng = np.random.default_rng(4)
    u = rng.standard_normal((3, 9, 16)).astype(np.float32)
    with torch.no_grad():
        got = tmamba.mamba_apply(model, torch.as_tensor(u))
    want = jmamba.mamba_apply(params, jnp.asarray(u), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    conv = rng.standard_normal((3, 32, 3)).astype(np.float32)
    ssm = rng.standard_normal((3, 32, 16)).astype(np.float32)
    jout, jst = jmamba.mamba_step(params, jnp.asarray(u), cfg,
                                  jmamba.MambaState(jnp.asarray(conv),
                                                    jnp.asarray(ssm)))
    with torch.no_grad():
        out, st = tmamba.mamba_step(model, torch.as_tensor(u),
                                    tmamba.MambaState(torch.as_tensor(conv),
                                                      torch.as_tensor(ssm)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    # the log-depth path: the same function as the sequential one
    with torch.no_grad():
        assoc = tmamba.mamba_apply(model, torch.as_tensor(u),
                                   use_associative=True)
    np.testing.assert_allclose(assoc.numpy(), got.numpy(), rtol=0,
                               atol=ATOL)


def test_mamba_init_follows_mamba_ssm_rules():
    """The port's own init (a torch generator): A_log = log(1..n), D = 1,
    dt_proj's bias the inverse softplus of a dt in [1e-3, 0.1], weights
    within their bounds."""
    m = tmamba.Mamba(tmamba.MambaConfig(96), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert m.A_log.shape == (192, 16)
    torch.testing.assert_close(m.A_log[5], torch.log(torch.arange(1., 17.)))
    assert (m.D == 1).all()
    dt = torch.nn.functional.softplus(m.dt_proj.bias)
    assert 1e-3 - 1e-6 <= dt.min() and dt.max() <= 0.1 + 1e-6
    assert m.in_proj.weight.abs().max() <= 96 ** -0.5
    assert m.dt_proj.weight.abs().max() <= 6 ** -0.5


@pytest.fixture(scope="module")
def spatialnet():
    jcfg = js.SpatialNetConfig(**SMALL)
    params = jax.jit(js.init_spatialnet_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    model = port(ts.SpatialNet(ts.SpatialNetConfig(**SMALL), device="cpu"),
                 params)
    return jcfg, params, model


def test_spatialnet_oneshot_matches_jax(spatialnet):
    """nt 21 (not a multiple of 5: the time mean drops a frame)."""
    jcfg, params, model = spatialnet
    x = np.random.default_rng(5).standard_normal((2, 6, 32, 21)).astype(
        np.float32)
    want = np.asarray(js.spatialnet_apply(params, jnp.asarray(x), cfg=jcfg))
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    assert got.shape == want.shape == (2, 4, 64, 2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_spatialnet_streamed_matches_jax_state(spatialnet):
    """Chunks of 10 frames from the zero state: each chunk's output and
    every state leaf (encoder tail, both Mamba states a layer) equal
    JAX's, and the streamed output equals the one-shot."""
    jcfg, params, model = spatialnet
    x = np.random.default_rng(6).standard_normal((2, 6, 32, 20)).astype(
        np.float32)
    jst = js.init_spatialnet_state(2, jcfg)
    st = ts.init_spatialnet_state(2, model.cfg, "cpu")
    assert len(leaves(st)) == len(jax.tree.leaves(jst)) == 9
    outs = []
    for t0 in range(0, 20, 10):
        chunk = x[..., t0: t0 + 10]
        jout, jst = js.spatialnet_apply(params, jnp.asarray(chunk),
                                        cfg=jcfg, state=jst,
                                        return_state=True)
        with torch.no_grad():
            out, st = model(torch.as_tensor(chunk), state=st,
                            return_state=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=ATOL)
        for a, b in zip(leaves(st), jax.tree.leaves(jst)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATOL)
        outs.append(out)
    with torch.no_grad():
        oneshot = model(torch.as_tensor(x))
    torch.testing.assert_close(torch.cat(outs, 1), oneshot, rtol=0,
                               atol=ATOL)


def test_config_properties_match_jax_and_unported_kinds_say_so():
    """Every time module's config properties equal JAX's, and serving and
    export take every kind (the name is the old refusal's): ``_resolve``
    gives an apply function and a per-row init for MHSA and retention."""
    for attention in ("mamba", "mamba(8,3)", "mhsa(20)", "ret(3)"):
        tcfg = ts.SpatialNetConfig(attention=attention, rope="ALiBi")
        jcfg = js.SpatialNetConfig(attention=attention, rope="ALiBi")
        for prop in ("time_kind", "attn_scope", "ret_factor"):
            assert getattr(tcfg, prop) == getattr(jcfg, prop)
        for prop in ("mamba_cfg", "mhsa_cfg", "ret_cfg", "tconv_cfg"):
            assert tuple(getattr(tcfg, prop)) == tuple(getattr(jcfg, prop))
        if tcfg.time_kind != "mamba":
            # the model builds, and serving and export take it: an apply
            # function and the pool's per-row init, every leaf growing
            # with nb
            model = ts.SpatialNet(tcfg._replace(**SMALL), device="cpu")
            apply_fn, init_state = _resolve("ipdnet2", model)
            assert callable(apply_fn)
            assert all(a.shape[0] == 2 * b.shape[0] for a, b in zip(
                init_state(2).time[0][0], init_state(1).time[0][0]))
    assert ts.SpatialNetConfig().ret_cfg.key_dim == 24


def test_westlake_array_and_dpipd2_match_jax():
    """The 32-mic Westlake array; DPIPD2's far-field template and its
    near-field targets from a per-batch topology (and from the
    constructor's)."""
    np.testing.assert_array_equal(tarrays.audiowu_high_array_geometry(),
                                  jarrays.audiowu_high_array_geometry())
    mics = jarrays.audiowu_high_array_geometry()[[0, 1, 3, 5, 7]]
    kw = dict(ndoa_candidate=[1, 180], mic_location=mics, nf=257,
              fre_max=8000.0, ch_mode="M", speed=340.0)
    jd, td = jdpipd.DPIPD2(**kw), tdpipd.DPIPD2(**kw)
    np.testing.assert_array_equal(td.template, jd.template)
    rng = np.random.default_rng(7)
    doa = np.stack([np.full((2, 6, 2), np.pi / 2),
                    rng.uniform(-np.pi, np.pi, (2, 6, 2))],
                   axis=2).astype(np.float32)
    dist = rng.uniform(0.5, 3.0, (2, 6, 2)).astype(np.float32)
    pos = (mics[None] + rng.normal(0, 0.01, (2, 5, 3))).astype(np.float32)
    for topo in (pos, None):
        want = np.asarray(jd.targets(jnp.asarray(doa), jnp.asarray(dist),
                                     None if topo is None
                                     else jnp.asarray(topo)))
        got = td.targets(torch.as_tensor(doa), torch.as_tensor(dist),
                         None if topo is None else torch.as_tensor(topo))
        assert got.shape == want.shape == (2, 6, 257, 4, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_energy_vad_matches_jax():
    rng = np.random.default_rng(8)
    gain = np.repeat(rng.uniform(0, 0.01, 21) * (rng.uniform(0, 1, 21)
                                                  > 0.5), 1600)
    sig = rng.standard_normal(16000 * 2 + 700) * gain[: 16000 * 2 + 700]
    got = ttargets.energy_vad(sig)
    np.testing.assert_array_equal(got, jtargets.energy_vad(sig))
    assert 0 < got.mean() < 1 and got.shape == (20,)


def test_streaming_center_true_matches_jax():
    """``StreamingLocalizer(center=True)`` (hop 320, L=249, all channels,
    5-frame steps, 100 ms pushes) with make_spatialnet_stream_step, at 256
    bins (1 layer, hidden 16): each fired chunk equals JAX's, and the
    streamed output equals the one-shot pipeline's frames (all but the
    one-shot's end-pad frame)."""
    kw = dict(SMALL, num_freqs=256, num_layers=1)
    jcfg = js.SpatialNetConfig(**kw)
    params = jax.jit(js.init_spatialnet_params, static_argnums=1)(
        jax.random.PRNGKey(2), jcfg)
    model = port(ts.SpatialNet(ts.SpatialNetConfig(**kw), device="cpu"),
                 params)
    sig = np.random.default_rng(9).standard_normal((16000, 3)).astype(
        np.float32)
    front = dict(ch_mode="none", hop=320, center=True, sample_length=249,
                 frames_per_step=5)
    jloc = jstreaming.StreamingLocalizer(
        jstreaming.make_spatialnet_stream_step(params, jcfg), nch=3,
        **front)
    tloc = tstreaming.StreamingLocalizer(
        tstreaming.make_spatialnet_stream_step(model), nch=3, device="cpu",
        **front)
    jouts, touts = [], []
    for start in range(0, 16000, 1600):
        jouts += jloc.push(sig[start: start + 1600])
        touts += tloc.push(sig[start: start + 1600])
    assert len(touts) == len(jouts) == 10
    streamed = torch.cat(touts, dim=1)
    np.testing.assert_allclose(
        streamed.numpy(),
        np.concatenate([np.asarray(o) for o in jouts], axis=1), rtol=0,
        atol=ATOL)
    feats = stft_features(torch.as_tensor(sig[None]), ch_mode="none",
                          win_shift_ratio=0.625, center=True,
                          sample_length=249)
    jfeats = jstft_features(jnp.asarray(sig[None]), ch_mode="none",
                            win_shift_ratio=0.625, center=True,
                            sample_length=249)
    assert feats.shape == jfeats.shape == (1, 6, 256, 51)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0,
                               atol=ATOL)
    with torch.no_grad():
        oneshot = model(feats)
    assert oneshot.shape[1] == streamed.shape[1] == 10
    torch.testing.assert_close(streamed, oneshot, rtol=0, atol=ATOL)
