"""The port's LOCATA path (fnssl_tpu_torch.data.locata and ``cli locata``)
against fnssl_tpu on the CPU, on a synthetic recording in the LOCATA
directory and file format (the fixture of tests/test_locata.py: 15
channels of 48 kHz audio, tab-separated pose, time and VAD streams).

Tolerances: the reader's signals, DOAs and VADs 1e-6; ``locata --model
ipd_baseline`` JAX's summary (1e-6) and npy dumps (exact DOA grid
points); ``locata --model fnssl`` on a JAX checkpoint (hidden 32, the patch of
tests/test_torch_cli.py's cross-package check; carried over by
tools/jax_ckpt_to_tar.py) JAX's metrics within 1e-5.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from fnssl_tpu.data import Segmenting as JSegmenting
from fnssl_tpu.data.locata import LocataDataset as JLocata
from fnssl_tpu.utils.audio_io import write_audio
from fnssl_tpu_torch.cli.main import main
from fnssl_tpu_torch.data import LocataDataset, Segmenting
from tests.test_torch_threads import torch_threads  # noqa: F401


def _write_tsv(path, cols: dict):
    keys = list(cols)
    with open(path, "w") as f:
        f.write("\t".join(keys) + "\n")
        for i in range(len(cols[keys[0]])):
            f.write("\t".join(str(cols[k][i]) for k in keys) + "\n")


@pytest.fixture(scope="module")
def locata_dir(tmp_path_factory):
    """task3/recording1/dicit: a static array at the origin (identity
    rotation), one static source 2 m away at 45° azimuth, leading silence
    to strip, a VAD active over the first half."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("locata")
    fs48, dur = 48000, 2.0
    n48 = int(fs48 * dur)
    d = root / "task3" / "recording1" / "dicit"
    os.makedirs(d)
    npts = 5
    ts = np.linspace(0, dur, npts)
    sig = rng.standard_normal((n48, 15)).astype(np.float32) * 0.5
    sig[: 1000] = 0.0
    write_audio(str(d / "audio_array_dicit.wav"), sig, fs48)
    pose = {"year": [2026] * npts, "hour": [10] * npts,
            "minute": [0] * npts, "second": list(ts),
            "x": [0.0] * npts, "y": [0.0] * npts, "z": [0.0] * npts,
            "ref_vec_x": [1.0] * npts, "ref_vec_y": [0.0] * npts,
            "ref_vec_z": [0.0] * npts}
    for i in range(3):
        for j in range(3):
            pose[f"rotation_{i + 1}{j + 1}"] = [float(i == j)] * npts
    _write_tsv(d / "position_array_dicit.txt", pose)
    _write_tsv(d / "required_time.txt",
               {"hour": [10] * npts, "minute": [0] * npts,
                "second": list(ts)})
    write_audio(str(d / "audio_source_talker1.wav"),
                rng.standard_normal(n48).astype(np.float32), fs48)
    pos = np.array([2 * np.cos(np.pi / 4), 2 * np.sin(np.pi / 4), 0.0])
    _write_tsv(d / "position_source_talker1.txt",
               {"x": [pos[0]] * npts, "y": [pos[1]] * npts,
                "z": [pos[2]] * npts})
    _write_tsv(d / "VAD_dicit_talker1.txt",
               {"VAD": [1] * (n48 // 2) + [0] * (n48 - n48 // 2)})
    return str(root)


@pytest.mark.parametrize("scene", [False, True])
def test_reader_matches_jax(locata_dir, scene):
    """Segmented items (signals, window DOAs, window VADs), and the raw
    acoustic scene (per-sample DOA, VAD, trajectory, mic positions)."""
    kw = dict(array="dicit", fs=16000, tasks=(3,), dev=True,
              return_acoustic_scene=scene)
    want_mic, want = JLocata(locata_dir, **kw, transforms=None if scene
                             else [JSegmenting()])[0]
    got_mic, got = LocataDataset(locata_dir, **kw, transforms=None if scene
                                 else [Segmenting()])[0]
    np.testing.assert_allclose(got_mic, want_mic, rtol=0, atol=1e-6)
    if scene:
        for k in ("DOA", "mic_vad_sources", "mic_vad", "trajectory",
                  "mic_pos", "t", "timestamps", "source_signal"):
            np.testing.assert_allclose(np.asarray(getattr(got, k), float),
                                       np.asarray(getattr(want, k), float),
                                       rtol=0, atol=1e-6, err_msg=k)
        return
    assert sorted(got) == sorted(want) == ["doa", "vad_sources"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # the static source at 45° azimuth, 90° elevation in the array frame
    np.testing.assert_allclose(np.degrees(got["doa"][:, :, 0]),
                               [[90.0, 45.0]] * len(got["doa"]), atol=0.5)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_both(capsys, jargv, targv, out):
    """JAX's `cli locata` into out/jax, the port's into out/port; their
    last lines."""
    from fnssl_tpu.cli.main import main as jmain

    capsys.readouterr()
    jmain(["locata", *jargv, "--out", f"{out}/jax/"])
    want = last_json(capsys)
    main(["locata", *targv, "--out", f"{out}/port/"])
    return last_json(capsys), want


def same_dumps(out, n):
    for i in range(n):
        for f in ("gt", "est", "vadgt"):
            got = np.load(f"{out}/port/{i}_{f}.npy")
            want = np.load(f"{out}/jax/{i}_{f}.npy")
            assert got.shape == want.shape, f
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=f)


def test_cli_locata_ipd_baseline_matches_jax(locata_dir, tmp_path, capsys):
    """The model-free baseline: JAX's summary and dumps, and the plot."""
    argv = ["--model", "ipd_baseline", "--locata-dir", locata_dir,
            "--tasks", "3"]
    got, want = run_both(capsys, argv, argv + ["--plot"], tmp_path)
    assert sorted(got) == sorted(want) and want["recordings"] == 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    same_dumps(tmp_path, 1)
    assert (tmp_path / "port" / "locata_fig.jpg").stat().st_size > 0


def test_cli_locata_fnssl_on_jax_weights_matches_jax(
        locata_dir, tmp_path, capsys, monkeypatch):
    """A JAX fit's checkpoint (written by fnssl_tpu's CheckpointManager, as
    its Learner does): JAX's `locata --model fnssl` restores it; the port's
    reads it as the best_model.tar that tools/jax_ckpt_to_tar.py writes
    (weights through params_to_state_dict's names, a template from another
    seed): JAX's metrics within 1e-5 and the same dumps."""
    import importlib.util
    from pathlib import Path

    import jax

    import fnssl_tpu.models.fnssl as jfnssl
    import fnssl_tpu_torch.models.fnssl as tfnssl
    from fnssl_tpu.train.checkpoint import CheckpointManager
    from fnssl_tpu.train.step import init_train_state, make_optimizer

    for mod in (jfnssl, tfnssl):
        orig = mod.FNSSLConfig
        monkeypatch.setattr(mod, "FNSSLConfig",
                            lambda _o=orig, **kw: _o(hidden_size=32, **kw))
    # TensorBoard's writer imports TensorFlow (~18 s) in JAX's Learner
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    log_dir = str(tmp_path / "jax_fit")
    params = jfnssl.init_fnssl_params(jax.random.PRNGKey(4),
                                      jfnssl.FNSSLConfig())
    mgr = CheckpointManager(os.path.join(log_dir, "ckpt"))
    mgr.save(0, init_train_state(params, make_optimizer("adam")), 0.5)
    mgr.close()
    tool = Path(__file__).resolve().parents[1] / "tools" / "jax_ckpt_to_tar.py"
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_tar", tool)
    bridge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bridge)
    common = ["--model", "fnssl", "--locata-dir", locata_dir, "--tasks",
              "3", "--platform", "cpu", "--log-dir", log_dir]
    from fnssl_tpu.cli.main import main as jmain

    capsys.readouterr()
    jmain(["locata", *common, "--seed", "2", "--out",
           f"{tmp_path}/jax/"])
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out
    want = json.loads(out.strip().splitlines()[-1])
    bridge.main(["--log-dir", log_dir, "--seed", "2"])
    main(["locata", *common, "--seed", "9", "--out", f"{tmp_path}/port/"])
    out = capsys.readouterr().out
    assert "fresh params" not in out
    got = json.loads(out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want) and got["recordings"] == 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, k
    same_dumps(tmp_path, 1)


@pytest.mark.parametrize("argv,message", [
    (["--model", "ipdnet"], "locata: model 'ipdnet' not wired"),
    (["--model", "fnssl_doa"], "locata: model 'fnssl_doa' not wired")])
def test_cli_locata_refuses_models_it_does_not_wire(argv, message):
    with pytest.raises(SystemExit, match=message):
        main(["locata", "--locata-dir", "none", *argv])


def test_locata_models_run_on_the_card_unless_asked(locata_dir, tmp_path):
    """FN-SSL needs the card (or --platform cpu); the baseline runs on the
    host with no model."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["locata", "--model", "fnssl", "--locata-dir", locata_dir,
              "--log-dir", str(tmp_path), "--out", str(tmp_path / "o")])
