"""The port's inference entry points against fnssl_tpu on the CPU: ``cli
predict`` (``ipd_baseline`` and the four models), ``cli stream`` and the
stream head that ``cli serve`` shares, ``serve --model fnssl_doa``.

The same numpy inputs and the same weights (JAX's init, carried across
with ``params_to_state_dict`` and written as the log dir's
``best_model.tar``) go through JAX's ``stft_features`` → ``*_apply`` →
decode chain (predict) or its ``StreamingLocalizer`` with the
``make_*_stream_step``s (stream), and through the port's CLI.

Small sizes: FN-SSL and IPDnet at hidden 32, IPDnet2 at 2 layers of hidden
16 (both packages' configs patched, as the other CLI test files do);
``fnssl_doa`` at its published width (its head needs hidden = nf = 256).
0.5 s of audio: 2 output frames of FN-SSL/IPDnet, 5 of IPDnet2.

Tolerances: model outputs within 1e-5 relative (+1e-6 absolute): float32
recurrences summed in another order; decoded grid indices (DOAs) equal
except at exact ties of the spatial spectrum (1e-5), VAD scores within
1e-5.
"""
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

import fnssl_tpu.models.fnssl as jfm
import fnssl_tpu.models.ipdnet as jim
import fnssl_tpu.models.spatialnet as jsm
import fnssl_tpu_torch.models.fnssl as tfm
import fnssl_tpu_torch.models.ipdnet as tim
import fnssl_tpu_torch.models.spatialnet as tsm
import fnssl_tpu_torch.train.tasks as ttasks
from fnssl_tpu.eval.pred_doa import PredDOA as JPredDOA
from fnssl_tpu.eval.pred_doa import PredDOAMultiTrack as JPredDOAMultiTrack
from fnssl_tpu.eval.pred_doa import ipd_baseline as jipd_baseline
from fnssl_tpu.eval.pred_doa import predgt2doa_cls as jpredgt2doa_cls
from fnssl_tpu.runtime import streaming as jstreaming
from fnssl_tpu.train.preprocess import stft_features as jstft_features
from fnssl_tpu_torch.cli.main import (_stream_session_factory, build_parser,
                                      build_server, main)
from fnssl_tpu_torch.eval.pred_doa import PredDOA, ipd_baseline
from fnssl_tpu_torch.train.convert import params_to_state_dict, \
    save_torch_tar
from fnssl_tpu_torch.utils.audio_io import write_audio
from tests.test_torch_threads import torch_threads  # noqa: F401


jcli = importlib.import_module("fnssl_tpu.cli.main")
FS = 16000
SMALL_SPATIAL = {"num_layers": 2, "dim_hidden": 16}
RTOL, ATOL = 1e-5, 1e-6
NCH = {"ipdnet2": 5}


@pytest.fixture(autouse=True)
def small_configs(monkeypatch):
    """Both packages' configs at the small sizes (fnssl_doa's head keeps
    the published width)."""
    for mod in (jfm, tfm):
        orig = mod.FNSSLConfig
        monkeypatch.setattr(mod, "FNSSLConfig", lambda _o=orig, **kw: _o(
            **{**({} if kw.get("is_doa") else {"hidden_size": 32}), **kw}))
    for mod in (jim, tim, ttasks):
        orig = mod.IPDnetConfig
        monkeypatch.setattr(mod, "IPDnetConfig", lambda _o=orig, **kw: _o(
            **{"hidden_size": 32, **kw}))
    for mod in (jsm, tsm, ttasks):
        orig = mod.SpatialNetConfig
        monkeypatch.setattr(mod, "SpatialNetConfig", lambda _o=orig, **kw: _o(
            **{**SMALL_SPATIAL, **kw}))


def audio(seed, nch=2, seconds=0.5):
    """Noise with a 2-sample inter-mic delay and a little independent
    noise on each mic."""
    rng = np.random.default_rng(seed)
    n = int(seconds * FS)
    src = rng.standard_normal(n + 2 * nch).astype(np.float32) * 0.1
    sig = np.stack([src[2 * (nch - k): 2 * (nch - k) + n]
                    for k in range(nch)], axis=1)
    return sig + rng.standard_normal(sig.shape).astype(np.float32) * 0.01


def jax_params(name, seed=3):
    """JAX's task for ``name`` (its config) and its init from ``seed``,
    compiled as one program."""
    task = jcli._make_task(name)
    init = {"ipdnet": jim.init_ipdnet_params,
            "ipdnet2": jsm.init_spatialnet_params}.get(
                name, jfm.init_fnssl_params)
    params = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed),
                                             task.cfg)
    return task, params


def log_dir_with(path, params):
    """A log dir whose best_model.tar holds the JAX weights."""
    os.makedirs(path, exist_ok=True)
    save_torch_tar(os.path.join(path, "best_model.tar"),
                   {k: torch.as_tensor(v) for k, v in params_to_state_dict(
                       jax.tree.map(np.asarray, params)).items()})
    return str(path)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def same_doa(got, want, spectra=None):
    """Decoded DOAs (degrees) equal, except where the spatial spectrum
    (frames, grid) has an exact tie at its top."""
    got, want = np.asarray(got), np.asarray(want)
    bad = ~np.isclose(got, want, atol=1e-3)
    if bad.any():
        assert spectra is not None, (got, want)
        frames = np.unique(np.nonzero(bad)[1])
        for t in frames:
            top2 = np.sort(np.asarray(spectra)[0, t].ravel())[-2:]
            assert top2[1] - top2[0] <= 1e-5, (t, got[:, t], want[:, t])


def test_ipd_baseline_matches_jax(tmp_path, capsys):
    """The model-free baseline: JAX's ipd_baseline and the port's on the
    host, and `cli predict --model ipd_baseline`'s dumps."""
    sig = audio(1)
    want = jipd_baseline(sig[None], JPredDOA())
    got = ipd_baseline(sig[None], PredDOA(device="cpu"))
    close(got["spatial_spectrum"], want["spatial_spectrum"])
    same_doa(np.degrees(got["doa"].numpy()), np.degrees(want["doa"]),
             want["spatial_spectrum"])
    np.testing.assert_array_equal(got["vad_sources"].numpy(),
                                  np.asarray(want["vad_sources"]))
    write_audio(str(tmp_path / "a.wav"), sig, FS)
    main(["predict", "--model", "ipd_baseline", "--wav",
          str(tmp_path / "a.wav"), "--out", str(tmp_path / "p")])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["frames"] == 2 and info["tracks"] == 1
    np.testing.assert_allclose(np.load(tmp_path / "p" / "doa_est.npy"),
                               np.degrees(got["doa"].numpy()))


def jax_predict(name, task, params, sig):
    """JAX's predict chain (fnssl_tpu/cli/main.py:cmd_predict)."""
    x = sig[None]
    if name == "ipdnet":
        pred = jim.ipdnet_apply(params, jstft_features(
            x, ch_mode="none", sample_length=280), cfg=task.cfg)
        return pred, JPredDOAMultiTrack(task.dpipd.mic_location,
                                        max_track=2).pred2doa(pred)[0]
    if name == "ipdnet2":
        pred = jsm.spatialnet_apply(params, jstft_features(
            x, ch_mode="none", win_shift_ratio=0.625, center=True,
            sample_length=249), cfg=task.cfg)
        return pred, JPredDOAMultiTrack(task.dpipd.mic_location,
                                        max_track=2).pred2doa(
                                            np.asarray(pred))[0]
    pred = jfm.fnssl_apply(params, jstft_features(x, ch_mode="MM"),
                           cfg=task.cfg)
    if name == "fnssl_doa":
        return pred, jpredgt2doa_cls(np.asarray(pred))[0]
    return pred, JPredDOA().predgt2doa(pred)[0]


@pytest.mark.parametrize("name", ["fnssl", "ipdnet", "ipdnet2"])
def test_cli_predict_matches_jax(name, tmp_path, capsys):
    """`cli predict --platform cpu` on the checkpoint's weights: the dumped
    DOA and VAD equal JAX's predict chain on the same wav."""
    task, params = jax_params(name)
    sig = audio(2, NCH.get(name, 2))
    write_audio(str(tmp_path / "a.wav"), sig, FS)
    log = log_dir_with(tmp_path / "run", params)
    main(["predict", "--model", name, "--wav", str(tmp_path / "a.wav"),
          "--log-dir", log, "--out", str(tmp_path / "p"),
          "--platform", "cpu"])
    out = capsys.readouterr().out
    assert "no checkpoint" not in out
    info = json.loads(out.strip().splitlines()[-1])
    _, want = jax_predict(name, task, params, sig)
    doa = np.load(tmp_path / "p" / "doa_est.npy")
    assert info["frames"] == doa.shape[1] == (5 if name == "ipdnet2" else 2)
    same_doa(doa, np.degrees(np.asarray(want["doa"])))
    close(np.load(tmp_path / "p" / "vad_est.npy"), want["vad_sources"])


def test_predict_fnssl_doa_matches_jax():
    """The port's one-shot predict (front-end, forward, decode) of
    fnssl_doa at its published width: the raw output and the argmax
    class equal JAX's."""
    from fnssl_tpu_torch.cli.main import _task_for, predict

    task, params = jax_params("fnssl_doa")
    sig = audio(4)
    pred, want = jax_predict("fnssl_doa", task, params, sig)
    model = tfm.FNSSL(tfm.FNSSLConfig(is_doa=True), device="cpu")
    model.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    got, dec = predict("fnssl_doa", model.eval(), _task_for(
        "fnssl_doa", "cpu"), sig, "cpu")
    close(got, pred)
    np.testing.assert_array_equal(dec["doa"].numpy(),
                                  np.asarray(want["doa"]))


def jax_stream(name, task, params, sig, block):
    """JAX's stream loop: its StreamingLocalizer around its stream step."""
    if name == "ipdnet2":
        step = jstreaming.make_spatialnet_stream_step(params, task.cfg)
        front = dict(ch_mode="none", hop=320, center=True, sample_length=249,
                     frames_per_step=5)
    elif name == "ipdnet":
        step = jstreaming.make_ipdnet_stream_step(params, task.cfg)
        front = dict(ch_mode="none", sample_length=280)
    else:
        step = jstreaming.make_fnssl_stream_step(params, task.cfg)
        front = dict(ch_mode="MM")
    loc = jstreaming.StreamingLocalizer(step, nch=sig.shape[1], **front)
    return [np.asarray(out) for start in range(0, sig.shape[0], block)
            for out in loc.push(sig[start: start + block])]


def jax_decode(name, task, out):
    if name == "fnssl":
        return JPredDOA().predgt2doa(out)[0]
    return JPredDOAMultiTrack(task.dpipd.mic_location,
                              max_track=2).pred2doa(out)[0]


@pytest.mark.parametrize("name", ["fnssl", "ipdnet", "ipdnet2"])
def test_cli_stream_matches_jax(name, tmp_path, capsys):
    """`cli stream --chunk-ms 100` on the checkpoint's best weights: each
    fired chunk's output (through the stream head's session) and the
    dumped DOA/VAD equal JAX's chunked stream steps."""
    from fnssl_tpu_torch.cli.main import _task_for, load_model

    task, params = jax_params(name)
    sig = audio(5, NCH.get(name, 2))
    write_audio(str(tmp_path / "a.wav"), sig, FS)
    log = log_dir_with(tmp_path / "run", params)
    main(["stream", "--model", name, "--wav", str(tmp_path / "a.wav"),
          "--chunk-ms", "100", "--log-dir", log, "--out",
          str(tmp_path / "s"), "--platform", "cpu"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_stream(name, task, params, sig, 1600)
    assert info["out_frames"] == len(want) * want[0].shape[1]
    assert info["rtf"] > 0
    decs = [jax_decode(name, task, w) for w in want]
    doa = np.load(tmp_path / "s" / "doa_est.npy")
    same_doa(doa[None], np.degrees(np.concatenate(
        [np.asarray(d["doa"])[0] for d in decs]))[None])
    close(np.load(tmp_path / "s" / "vad_est.npy"), np.concatenate(
        [np.asarray(d["vad_sources"])[0] for d in decs]))
    # the raw outputs, through the session the stream head builds
    ptask = _task_for(name, "cpu")
    module = load_model(name, log, 0, "cpu", cfg=ptask.cfg)
    make_loc, _ = _stream_session_factory(
        name, ptask, module, None, sig.shape[1], 5 if name == "ipdnet2"
        else 12)
    loc = make_loc()
    got = [out for start in range(0, sig.shape[0], 1600)
           for out in loc.push(sig[start: start + 1600])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)


def test_serve_fnssl_doa_matches_jax(tmp_path, capsys):
    """`serve --model fnssl_doa` builds FNSSLConfig(is_doa=True), loads the
    checkpoint strictly and decodes the classification head: each chunk's
    180 logits and its argmax azimuth equal JAX's stream session
    (fnssl_tpu/cli/main.py:_stream_session_factory)."""
    task, params = jax_params("fnssl_doa", seed=6)
    log = log_dir_with(tmp_path / "run", params)
    server, info = build_server(build_parser().parse_args(
        ["serve", "--model", "fnssl_doa", "--platform", "cpu", "--port", "0",
         "--log-dir", log]))
    try:
        assert "no checkpoint" not in capsys.readouterr().out
        assert info["serving"] == "fnssl_doa"
        loc, decode = server.session_factory()
        sig = audio(7)
        outs = loc.push(sig)
    finally:
        server._sock.close()
    jmake, jdecode = jcli._stream_session_factory(
        "fnssl_doa", task, params, None, 2, 12)
    want = jmake().push(sig)
    assert len(outs) == len(want) == 2
    for got, w in zip(outs, want):
        assert tuple(got.shape) == (1, 1, 180)
        close(got, w)
        np.testing.assert_array_equal(decode(got)["doa"].numpy(),
                                      np.asarray(jdecode(w)["doa"]))


@pytest.mark.parametrize("name", ["ipdnet_offline", "variable_ipdnet"])
def test_stream_refuses_non_causal_models(name):
    with pytest.raises(SystemExit, match="is not causal"):
        main(["stream", "--model", name, "--wav", "x.wav", "--platform",
              "cpu"])
