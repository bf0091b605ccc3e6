"""The port's IPDnet family (fnssl_tpu_torch: models.ipdnet, models.layers'
conv2d/prelu, physics.targets, train.losses' PIT, eval.pred_doa's
PredDOAMultiTrack, runtime.streaming's make_ipdnet_stream_step and the
IPDnet stage config of data.simu) against fnssl_tpu on the CPU. Inputs
come from numpy seeds; the JAX weights are carried across with
``params_to_state_dict`` and load strictly.

Small sizes: hidden 32, nf 16; nt 48 for streaming and 24/60 offline with
``n_seg=24``, so that the chunked inference pads and folds segments.

Tolerances: model outputs atol 1e-5 (float32 recurrences summed in
another order; measured ~3e-8); targets 1e-6; the PIT loss 1e-6 relative
and its gradient atol 1e-7; decoded grid indices equal, VAD scores and
metrics within 1e-5; simulated scenes bit-identical.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.ipdnet as jm
import fnssl_tpu_torch.models.ipdnet as tm
from fnssl_tpu.eval.pred_doa import PredDOAMultiTrack as JPredDOAMultiTrack
from fnssl_tpu.models import layers as jlayers
from fnssl_tpu.physics import targets as jtargets
from fnssl_tpu.runtime import streaming as jstreaming
from fnssl_tpu.train import losses as jlosses
from fnssl_tpu_torch.eval.pred_doa import PredDOAMultiTrack
from fnssl_tpu_torch.models import layers as tlayers
from fnssl_tpu_torch.physics import targets as ttargets
from fnssl_tpu_torch.runtime import streaming as tstreaming
from fnssl_tpu_torch.train import losses as tlosses
from fnssl_tpu_torch.train.convert import params_to_state_dict
from fnssl_tpu_torch.train.preprocess import stft_features

HIDDEN, NF = 32, 16
ATOL = 1e-5
DUALCH = np.array([[-0.04, 0.0, 0.0], [0.04, 0.0, 0.0]])
MICS_3 = np.array([[-0.05, 0.0, 0.0], [0.0, 0.0, 0.0], [0.06, 0.01, 0.0]])


def port(cls, cfg, params):
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    return model.eval()


def jax_init(init, seed, cfg):
    """JAX's init of ``cfg`` from ``seed``, compiled as one program (the
    eager draws compile one program each)."""
    return jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


@pytest.fixture(scope="module")
def online():
    cfg = jm.IPDnetConfig(hidden_size=HIDDEN)
    params = jax_init(jm.init_ipdnet_params, 1, cfg)
    return cfg, params, port(tm.IPDnet, tm.IPDnetConfig(hidden_size=HIDDEN),
                             params)


def jax_params(model):
    """The port model's weights as a JAX parameter pytree (nested dicts
    of numpy arrays by the state-dict names)."""
    tree = {}
    for name, v in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy()
    return tree


@pytest.fixture(scope="module")
def offline():
    """Weights drawn by the port (JAX's init is held by the online and
    variable fixtures) and carried to JAX."""
    kw = dict(hidden_size=HIDDEN, is_online=False, n_seg=24)
    model = tm.IPDnet(tm.IPDnetConfig(**kw), device="cpu",
                      generator=torch.Generator().manual_seed(2)).eval()
    return jm.IPDnetConfig(**kw), jax_params(model), model


def test_conv2d_and_prelu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 7, 9)).astype(np.float32)
    params = {"weight": rng.standard_normal((6, 5, 3, 3)).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    for pad in (((1, 1), (0, 0)), ((1, 0), (0, 2))):
        want = np.asarray(jlayers.conv2d(params, x, padding=pad))
        got = tlayers.conv2d(torch.from_numpy(x),
                             torch.from_numpy(params["weight"]),
                             torch.from_numpy(params["bias"]), padding=pad)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    a = {"weight": jnp.asarray([0.3], jnp.float32)}
    np.testing.assert_array_equal(
        tlayers.prelu(torch.from_numpy(x), torch.tensor([0.3])).numpy(),
        np.asarray(jlayers.prelu(a, x)))
    conv = tlayers.Conv2d(5, 6, (3, 3), bias=False, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert conv.bias is None and conv.weight.abs().max() <= 1 / 45 ** 0.5
    assert tlayers.PReLU(device="cpu").weight.tolist() == [0.25]


def test_state_dict_names_are_the_jax_param_paths(online, offline):
    for cfg, params, model in (online, offline):
        want = params_to_state_dict(jax.tree.map(np.asarray, params))
        assert sorted(model.state_dict()) == sorted(want)
        for k, v in model.state_dict().items():
            assert v.shape == want[k].shape, k


@pytest.mark.parametrize("nb,nt", [(1, 48), (2, 60)])
def test_ipdnet_online_matches_jax(online, nb, nt):
    cfg, params, model = online
    x = np.random.default_rng(nt).standard_normal(
        (nb, 4, NF, nt)).astype(np.float32)
    want = np.asarray(jm.ipdnet_apply(params, x, cfg=cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape == (nb, nt // 12, 2 * NF, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nt,chunked", [(24, False), (60, False),
                                        (24, True), (60, True)])
def test_ipdnet_offline_and_chunked_match_jax(offline, nt, chunked):
    """nb 2; at nt 60 the chunked inference pads to 72 and folds 3
    segments of 24 frames into the batch, then stitches them back."""
    cfg, params, model = offline
    x = np.random.default_rng(nt + chunked).standard_normal(
        (2, 4, NF, nt)).astype(np.float32)
    want = np.asarray(jm.ipdnet_apply(params, x, cfg=cfg,
                                      offline_inference=chunked))
    with torch.no_grad():
        got = model(torch.from_numpy(x), offline_inference=chunked)
    assert got.shape == want.shape == (2, nt // 12, 2 * NF, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_ipdnet_streamed_state_matches_jax_and_one_shot(online):
    """Chunks of 12 frames with the carried state: the same outputs and
    states as JAX's, and the one-shot output."""
    cfg, params, model = online
    x = np.random.default_rng(3).standard_normal(
        (2, 4, NF, 48)).astype(np.float32)
    with torch.no_grad():
        one_shot = model(torch.from_numpy(x))
    jstate = jm.init_ipdnet_state(2, NF, cfg)
    tstate = tm.init_ipdnet_state(2, NF, model.cfg)
    outs = []
    for k in range(0, 48, 12):
        chunk = x[..., k: k + 12]
        want, jstate = jm.ipdnet_apply(params, chunk, cfg=cfg, state=jstate,
                                       return_state=True)
        with torch.no_grad():
            got, tstate = model(torch.from_numpy(chunk), state=tstate,
                                return_state=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        outs.append(got)
    for w, g in zip(jax.tree.leaves(jstate), jax.tree.leaves(tstate)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    torch.testing.assert_close(torch.cat(outs, dim=1), one_shot, rtol=0,
                               atol=ATOL)


def test_ipdnet_stream_step_matches_jax_through_the_localizer(online):
    """make_ipdnet_stream_step under StreamingLocalizer (all channels,
    forgetting norm L=280), audio pushed in uneven blocks, against JAX's
    and against the one-shot forward of the same features."""
    cfg, params, model = online
    sig = np.random.default_rng(4).standard_normal(
        (512 + 256 * 23, 2)).astype(np.float32) * 0.1
    jloc = jstreaming.StreamingLocalizer(
        jstreaming.make_ipdnet_stream_step(params, cfg, nf=256), nch=2,
        ch_mode="none", sample_length=280)
    big = port(tm.IPDnet, model.cfg, params)
    tloc = tstreaming.StreamingLocalizer(
        tstreaming.make_ipdnet_stream_step(big), nch=2, ch_mode="none",
        sample_length=280, device="cpu")
    want, got = [], []
    for start in range(0, sig.shape[0], 1000):
        want += [np.asarray(o) for o in jloc.push(sig[start: start + 1000])]
        got += tloc.push(sig[start: start + 1000])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    feats = stft_features(torch.from_numpy(sig[None]), ch_mode="none",
                          sample_length=280)
    with torch.no_grad():
        one_shot = big(feats)
    torch.testing.assert_close(torch.cat(got, dim=1), one_shot, rtol=0,
                               atol=ATOL)


@pytest.fixture(scope="module")
def variable():
    """Weights drawn by the port and carried to JAX (JAX's init loads
    strictly into VariableIPDnet in test_torch_ckpt_bridge.py)."""
    model = tm.VariableIPDnet(tm.VariableIPDnetConfig(hidden_size=HIDDEN),
                              device="cpu",
                              generator=torch.Generator().manual_seed(5))
    return (jm.VariableIPDnetConfig(hidden_size=HIDDEN), jax_params(model),
            model.eval())


def test_variable_ipdnet_matches_jax_batched_and_per_utterance(variable):
    """nch 3 (P = 3 'MM' pairs), 2 utterances stacked nb-major: equal to
    JAX's, and each utterance alone gives its own rows (the pair means
    never mix utterances)."""
    cfg, params, model = variable
    x = np.random.default_rng(6).standard_normal(
        (6, 4, NF, 24)).astype(np.float32)
    want = np.asarray(jm.variable_ipdnet_apply(params, x, cfg=cfg, npair=3))
    with torch.no_grad():
        got = model(torch.from_numpy(x), npair=3)
        alone = [model(torch.from_numpy(x[3 * b: 3 * b + 3]))
                 for b in range(2)]
    assert got.shape == want.shape == (2, 2, 2 * NF, 3, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    torch.testing.assert_close(torch.cat(alone), got, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mics,ch_mode", [(DUALCH, "M"), (MICS_3, "M"),
                                          (MICS_3, "MM")])
def test_bessel_nonsource_target_matches_jax(mics, ch_mode):
    kw = dict(fre_used=slice(1, 257), nf=257, fre_max=8000.0, speed=340.0,
              ch_mode=ch_mode)
    want = jtargets.bessel_nonsource_target(mics, **kw)
    got = ttargets.bessel_nonsource_target(mics, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_vad_gate_with_nonsource_and_dp_vad_match_jax():
    rng = np.random.default_rng(7)
    ipd = rng.standard_normal((2, 5, 8, 3, 2)).astype(np.float32)
    vad = rng.uniform(0, 0.003, (2, 5, 2)).astype(np.float32)
    nons = rng.standard_normal((8, 3)).astype(np.float32)
    want = np.asarray(jtargets.vad_gate_with_nonsource(ipd, vad, nons))
    got = ttargets.vad_gate_with_nonsource(
        torch.from_numpy(ipd), torch.from_numpy(vad), torch.from_numpy(nons))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (vad > 0.001).mean() < 1

    def cplx(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    dp, mix = cplx(2, 9, 30, 2, 2), cplx(2, 9, 30, 2)
    want = np.asarray(jtargets.dp_vad(dp, mix))
    got = ttargets.dp_vad(torch.from_numpy(dp), torch.from_numpy(mix))
    assert got.shape == want.shape == (2, 2, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ns", [2, 3])
def test_pit_loss_gradient_and_permutation_match_jax(ns):
    rng = np.random.default_rng(8 + ns)
    pred = rng.standard_normal((2, 6, 8, 3, ns)).astype(np.float32)
    gt = rng.standard_normal((2, 6, 8, 3, ns)).astype(np.float32)
    want = float(jlosses.pit_mse_loss(pred, gt))
    want_grad = np.asarray(jax.grad(jlosses.pit_mse_loss)(
        jnp.asarray(pred), jnp.asarray(gt)))
    tp = torch.from_numpy(pred).requires_grad_()
    loss = tlosses.pit_mse_loss(tp, torch.from_numpy(gt))
    loss.backward()
    assert loss.item() == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), want_grad, rtol=0, atol=1e-7)
    perm = tlosses.pit_permutation(torch.from_numpy(pred),
                                   torch.from_numpy(gt))
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jlosses.pit_permutation(pred, gt)))
    # a target that is a per-frame permutation of pred: loss 0, and the
    # permutation found is the one applied
    table = list(itertools.permutations(range(ns)))
    idx = rng.integers(0, len(table), (2, 6))
    perm_gt = np.stack([[pred[b, t][..., list(table[idx[b, t]])]
                         for t in range(6)] for b in range(2)])
    assert float(tlosses.pit_mse_loss(torch.from_numpy(pred),
                                      torch.from_numpy(perm_gt))) == 0.0
    found = tlosses.pit_permutation(torch.from_numpy(pred),
                                    torch.from_numpy(perm_gt))
    np.testing.assert_array_equal(found.numpy(), idx)


@pytest.mark.parametrize("scale_norm", [None, "utterance"])
@pytest.mark.parametrize("mics,ch_mode", [(DUALCH, "M"), (MICS_3, "MM")])
def test_pred_doa_multitrack_matches_jax(tmp_path, mics, ch_mode,
                                         scale_norm):
    """Per-track IDL decode on the azimuth grid: equal grid indices, VAD
    scores and metrics within 1e-5, and the same npy dumps. Each track of
    pred is a grid template at a random azimuth, scaled by 0.2-1.2 (so
    that about half the frames pass the 0.5 VAD gate), plus noise; the
    ground truth is the decoded DOA in half the frames."""
    rng = np.random.default_rng(9)
    kw = dict(max_track=2, ch_mode=ch_mode, scale_norm=scale_norm)
    jdec = JPredDOAMultiTrack(mics, save_dir=str(tmp_path / "jax"), **kw)
    tdec = PredDOAMultiTrack(mics, save_dir=str(tmp_path / "port"),
                             device="cpu", **kw)
    tmpl = tdec.template.numpy()[0]                  # (180, 512, P)
    pick = tmpl[rng.integers(0, 180, (2, 7, 2))]     # (2, 7, 2, 512, P)
    amp = rng.uniform(0.2, 1.2, (2, 7, 2, 1, 1))
    pred = np.moveaxis(pick * amp, 2, -1) + 0.1 * rng.standard_normal(
        (2, 7) + tmpl.shape[1:] + (2,))
    pred = pred.astype(np.float32)
    want, _ = jdec.pred2doa(pred)
    got, _ = tdec.pred2doa(pred)
    np.testing.assert_array_equal(got["doa"].numpy(),
                                  np.asarray(want["doa"]))
    np.testing.assert_allclose(got["vad_sources"].numpy(),
                               np.asarray(want["vad_sources"]), rtol=0,
                               atol=1e-5)
    doa_gt = np.asarray(want["doa"]).copy()
    doa_gt[:, ::2] = rng.uniform(0, np.pi, doa_gt[:, ::2].shape)
    gt = {"doa": doa_gt.astype(np.float32),
          "vad_sources": (rng.uniform(0, 1, (2, 7, 2)) > 0.3).astype(
              np.float32)}
    want_m = jdec.evaluate(want, gt, idx=0)
    got_m = tdec.evaluate(got, gt, idx=0)
    assert sorted(got_m) == sorted(want_m)
    for k in want_m:
        assert got_m[k] == pytest.approx(want_m[k], abs=1e-5), k
    assert 0 < want_m["ACC"] < 1
    for name in ("doagt", "doaest", "vadgt", "vadest"):
        np.testing.assert_allclose(
            np.load(tmp_path / "port" / f"0_{name}.npy"),
            np.load(tmp_path / "jax" / f"0_{name}.npy"), rtol=0, atol=1e-5)


def test_ipdnet_trajectory_dataset_scenes_equal_jax():
    """The IPDnet stage config at its stage seed (dev: 102), 1 or 2
    sources: the same scene parameters and the same simulated signals,
    direct-path signals kept, bit for bit (native engine on both
    sides)."""
    import fnssl_tpu.data as jdata
    import fnssl_tpu.sim.native as jnative
    import fnssl_tpu_torch.data as tdata
    import fnssl_tpu_torch.sim.native as tnative

    assert jnative.native_available() and tnative.native_available()
    kw = dict(stage="dev", T=0.5, nb_points=4)
    jds = jdata.make_ipdnet_trajectory_dataset(**kw)
    tds = tdata.make_ipdnet_trajectory_dataset(**kw)
    sources = set()
    for i in range(4):
        js, ts = jds.get_random_scene(i), tds.get_random_scene(i)
        np.random.seed(i)
        jmic = js.simulate(keep_dp_signals=True)
        np.random.seed(i)
        tmic = ts.simulate(keep_dp_signals=True)
        np.testing.assert_array_equal(tmic, jmic)
        assert sorted(vars(ts)) == sorted(vars(js))
        for key in ("DOA", "traj_pts", "dp_mic_signals_sources",
                    "source_signal", "noise_signal", "mic_vad_sources"):
            np.testing.assert_array_equal(getattr(ts, key),
                                          getattr(js, key))
        assert (ts.SNR, ts.T60) == (js.SNR, js.T60) and 0 <= ts.SNR <= 15
        sources.add(ts.traj_pts.shape[-1])
        assert ts.dp_mic_signals_sources.shape[1:] == (
            2, ts.traj_pts.shape[-1])
    assert sources == {1, 2}
