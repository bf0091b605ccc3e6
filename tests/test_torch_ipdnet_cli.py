"""The port's IPDnet CLI on the CPU (``--platform cpu``), in-process:
``simulate --preset ipdnet``, ``fit``/``test`` of ``ipdnet`` and
``variable_ipdnet``, ``test`` of ``ipdnet_offline``, ``serve --model
ipdnet`` over TCP, and the port's ``test`` against fnssl_tpu's on the same
weights.

Both packages' ``IPDnetConfig``/``VariableIPDnetConfig`` are patched to
hidden size 32 and a 24-frame offline segment: at full width the CPU's
plain LSTM walks thousands of steps a batch, and the width does not
change what is checked (full width is the card's job, in chip_smoke.py).
Scenes of 0.5 s (30 frames, 2 output frames); the ipdnet corpus mixes 1-
and 2-source scenes, the variable_ipdnet one has 1 source a scene (its
labels are not padded to 2 tracks, as in the JAX CLI). The git/pip
provenance dump of both CLIs (``git.out``, held in test_torch_cli.py) is
written without running git and pip here.

Tolerances: a test loss equals the valid loss of the epoch it restored
(1e-6 relative, the same weights and the same eval); against JAX, the
loss 1e-5 relative and ACC/MAE/MDR/FAR/RMSE 1e-5; served DOAs equal to the
direct pipeline's at the 3 decimals the wire carries.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import fnssl_tpu.models.ipdnet as jm
import fnssl_tpu.utils.logging as jlogging
import fnssl_tpu_torch.models.ipdnet as tm
import fnssl_tpu_torch.train.tasks as ttasks
import fnssl_tpu_torch.utils.logging as tlogging
from fnssl_tpu_torch.cli.main import _batches, build_parser, build_server, \
    main
from tests.test_torch_threads import torch_threads  # noqa: F401


HIDDEN, NSEG = 32, 24


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """ipdnet corpora of 0.5 s scenes (stage seeds): 'mixed' (1 or 2
    sources, train wav+pickle, dev compact) and 'single' (1 source), with
    both packages' IPDnet configs at hidden 32."""
    d = tmp_path_factory.mktemp("torch_ipdnet_cli")
    old = os.getcwd()
    os.chdir(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        for logging in (jlogging, tlogging):
            mp.setattr(logging, "tag_and_log_git_status",
                       lambda path, note="": open(path, "w").write(note))
        for mod in (jm, tm, ttasks):
            for name in ("IPDnetConfig", "VariableIPDnetConfig"):
                orig = getattr(mod, name)
                extra = {"n_seg": NSEG} if name == "IPDnetConfig" else {}
                mp.setattr(mod, name, lambda _o=orig, _e=extra, **kw: _o(
                    **{"hidden_size": HIDDEN, **_e, **kw}))
        for corpus, ns in (("mixed", "2"), ("single", "1")):
            for stage, num, extra in (("train", 3, []),
                                      ("dev", 2, ["--compact"])):
                main(["simulate", "--preset", "ipdnet", "--stage", stage,
                      "--out", f"{corpus}/{stage}", "--num", str(num),
                      "--T", "0.5", "--nb-points", "4", "--num-source", ns,
                      *extra])
        yield d
    os.chdir(old)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def corpus(model):
    return "single" if model == "variable_ipdnet" else "mixed"


def test_simulate_ipdnet_preset_mixes_source_counts(workdir):
    """The stage seed, 1 or 2 sources a scene; batches pad every item's
    labels to 2 tracks before stacking, so the targets' ns axis is 2."""
    from fnssl_tpu_torch.data import FixTrajectoryDataset

    ds = FixTrajectoryDataset("mixed/train", return_acoustic_scene=True)
    counts = [ds[i][1].traj_pts.shape[-1] for i in range(len(ds))]
    assert set(counts) == {1, 2}
    (b,) = list(_batches("mixed/train", 3, 0, 2, False, workers=0,
                         pad_tracks=2))
    assert b["doa"].shape[-1] == b["vad"].shape[-1] == 2
    for i, n in enumerate(counts):
        assert (b["vad"][i, :, n:] == 0).all()


@pytest.mark.parametrize("model", ["ipdnet", "variable_ipdnet"])
def test_ipdnet_cli_lifecycle(workdir, capsys, model):
    """fit 1 epoch → test: the restored test loss equals the final valid
    loss; ACC and MAE finite. (``ipdnet_offline``'s test runs in
    test_offline_test_scores_the_chunked_inference; its fit and test on
    the card, in chip_smoke.py.)"""
    data, log_dir = corpus(model), f"runs/{model}"
    capsys.readouterr()
    main(["fit", "--model", model, "--train-dir", f"{data}/train",
          "--valid-dir", f"{data}/dev", "--bz", "2", "--epochs", "1",
          "--platform", "cpu", "--log-dir", log_dir])
    fit = last_json(capsys)
    assert np.isfinite(fit["final_train"]) and fit["best_epoch"] == 0
    assert os.path.exists(f"{log_dir}/best_model.tar")
    main(["test", "--model", model, "--data-dir", f"{data}/dev", "--bz",
          "2", "--platform", "cpu", "--log-dir", log_dir])
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out
    test = json.loads(out.strip().splitlines()[-1])
    assert test["loss"] == pytest.approx(fit["final_valid"], rel=1e-6)
    assert np.isfinite(test["ACC"]) and np.isfinite(test["MAE"])


def jax_params_as_tar(model, seed, log_dir):
    """JAX's fresh params from ``seed`` for ``model`` (as its CLI makes
    them), written as ``<log_dir>/best_model.tar``."""
    import jax

    from fnssl_tpu.train.convert import save_torch_tar

    cfg = jm.IPDnetConfig(is_online=model == "ipdnet")
    params = jm.init_ipdnet_params(jax.random.PRNGKey(seed), cfg)
    os.makedirs(log_dir, exist_ok=True)
    save_torch_tar(f"{log_dir}/best_model.tar", params)
    return cfg, params


def test_port_test_best_gives_jax_cli_test(workdir, capsys, monkeypatch,
                                           tmp_path):
    """JAX's ``cli test --model ipdnet`` on fresh params from --seed, and
    the port's ``test --best`` on the same params: the same loss and
    metrics."""
    from fnssl_tpu.cli.main import main as jmain

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    capsys.readouterr()
    jmain(["test", "--model", "ipdnet", "--data-dir", "mixed/dev", "--bz",
           "2", "--seed", "4", "--platform", "cpu", "--log-dir",
           "runs/jax_ipdnet"])
    want = last_json(capsys)
    jax_params_as_tar("ipdnet", 4, "runs/from_jax")
    main(["test", "--model", "ipdnet", "--data-dir", "mixed/dev", "--bz",
          "2", "--seed", "9", "--best", "--platform", "cpu", "--log-dir",
          "runs/from_jax"])
    got = last_json(capsys)
    assert sorted(got) == sorted(want)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_offline_test_scores_the_chunked_inference(workdir, capsys):
    """The port's ``test --model ipdnet_offline`` against JAX's
    ``ipdnet_apply(..., offline_inference=True)`` (30 frames padded to
    48, 2 segments of 24) decoded by JAX's PredDOAMultiTrack on the same
    batch and params. (JAX's own ``cli test`` omits offline_inference;
    the loss, the task's on the whole input, is held to JAX's in
    test_torch_ipdnet_train.py.)"""
    from fnssl_tpu.eval.pred_doa import PredDOAMultiTrack
    from fnssl_tpu.train.tasks import make_ipdnet_offline_task

    cfg, params = jax_params_as_tar("ipdnet_offline", 5, "runs/off_jax")
    assert cfg.n_seg == NSEG
    (batch,) = list(_batches("mixed/dev", 2, 0, 2, False, workers=0,
                             pad_tracks=2))
    task = make_ipdnet_offline_task()
    feats, _ = task.preprocess(batch["mic_sig"], batch["doa"], batch["vad"])
    pred = jm.ipdnet_apply(params, feats, cfg=task.cfg,
                           offline_inference=True)
    want = PredDOAMultiTrack(task.dpipd.mic_location, max_track=2)(
        pred, {"doa": batch["doa"], "vad_sources": batch["vad"]},
        vad_th=(0.001, 0.5))
    capsys.readouterr()
    main(["test", "--model", "ipdnet_offline", "--data-dir", "mixed/dev",
          "--bz", "2", "--best", "--platform", "cpu", "--log-dir",
          "runs/off_jax"])
    got = last_json(capsys)
    assert sorted(got) == sorted(want) + ["loss"]
    assert np.isfinite(got["loss"])
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_serve_ipdnet_over_tcp_on_the_cpu(workdir, capsys):
    """One TCP connection of 1 s of 2-channel audio: a line per 12-frame
    chunk step and eof; each line's DOA and VAD (2 tracks) equal the
    same pipeline run directly."""
    from fnssl_tpu_torch.runtime.server import stream_client

    args = build_parser().parse_args(
        ["serve", "--model", "ipdnet", "--platform", "cpu", "--port", "0",
         "--seed", "3", "--log-dir", "runs/none"])
    server, info = build_server(args)
    assert "no checkpoint" in capsys.readouterr().out
    assert info["serving"] == "ipdnet" and info["model_device"] == "cpu"
    sig = np.random.default_rng(0).standard_normal(
        (16000, 2)).astype(np.float32) * 0.1
    server.start()
    try:
        msgs = stream_client("127.0.0.1", server.port, sig, block=1500)
    finally:
        server.shutdown()
    n = ((16000 - 512) // 256 + 1) // 12
    assert msgs[-1] == {"eof": True, "outputs": n} and len(msgs) == n + 1
    loc, decode = server.session_factory()
    outs = loc.push(sig)
    assert len(outs) == n and tuple(outs[0].shape) == (1, 1, 512, 1, 2)
    for msg, out in zip(msgs[:-1], outs):
        res = decode(out)
        doa = np.degrees(res["doa"].numpy())[0, 0]
        np.testing.assert_allclose(msg["doa_deg"], np.round(doa, 3),
                                   atol=1e-3)
        np.testing.assert_allclose(msg["vad"], np.round(
            res["vad_sources"].numpy()[0, 0], 4), atol=1e-4)
    assert torch.isfinite(outs[-1]).all()


@pytest.mark.parametrize("model", ["ipdnet_offline", "variable_ipdnet"])
def test_serve_refuses_the_offline_variants(model):
    with pytest.raises(SystemExit, match="is not causal"):
        main(["serve", "--model", model, "--platform", "cpu", "--port",
              "0"])
