"""The port's data-parallel CLI on the CPU (gloo): ``fit --spawn 2``,
``fit --use-mesh`` (a world of one), ``test --num-processes 2`` and the
refusals.

FN-SSL at full width on a corpus of 4 train and 2 dev scenes of 0.5 s,
bz 1 a rank. The spawned ranks run with one torch thread each. The dev
split holds 2 scenes, which 2 ranks × bz 1 divide, so the wrap-padding of
the data-parallel eval schedule repeats nothing and its mean is the
plain fit's. Histories of the two ranks are equal bit for bit; the
world-of-one fit equals the plain fit within 1e-6; a test loss equals the
restored epoch's valid loss within 1e-6.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fnssl_tpu_torch.cli.main import load_model, main
from fnssl_tpu_torch.parallel import distributed
from tests.test_torch_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """4 train scenes (wav+pickle) and 2 dev scenes (compact npz); the
    spawned ranks take one torch thread each."""
    d = tmp_path_factory.mktemp("torch_cli_dp")
    old = os.getcwd()
    os.chdir(d)
    with pytest.MonkeyPatch.context() as mp:
        # TensorBoard's writer imports TensorFlow here (~18 s); the
        # Learner's metrics.jsonl is what these tests read
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setenv("OMP_NUM_THREADS", "1")
        main(["simulate", "--out", "data/train", "--num", "4", "--T", "0.5",
              "--nb-points", "4", "--seed", "1"])
        main(["simulate", "--out", "data/dev", "--num", "2", "--T", "0.5",
              "--nb-points", "4", "--seed", "77", "--compact"])
        yield d
    os.chdir(old)


def fit_argv(log_dir, *extra):
    return ["fit", "--model", "fnssl", "--train-dir", "data/train",
            "--valid-dir", "data/dev", "--bz", "1", "--platform", "cpu",
            "--log-dir", log_dir, *extra]


def history(log_dir):
    """(train losses, valid losses) by epoch from metrics.jsonl."""
    out = {"train/loss": {}, "valid/loss": {}}
    for line in open(Path(log_dir) / "metrics.jsonl"):
        rec = json.loads(line)
        if rec["tag"] in out:
            out[rec["tag"]][rec["step"]] = rec["value"]
    return [[d[e] for e in sorted(d)] for d in out.values()]


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def spawned(workdir):
    """`fit --spawn 2` for one epoch: rank 0's last line and the log dir."""
    log_dir = "runs/spawn"
    proc = subprocess.run(
        [sys.executable, "-m", "fnssl_tpu_torch.cli",
         *fit_argv(log_dir, "--epochs", "1", "--spawn", "2")],
        env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return last_json(proc.stdout), Path(log_dir)


def test_spawn_two_ranks_agree_and_write_once(spawned):
    rank0, log_dir = spawned
    rank1 = last_json((log_dir / "rank1.spawn.log").read_text())
    assert rank0 == rank1 and rank0["best_epoch"] == 0
    assert np.isfinite(rank0["final_train"]) and np.isfinite(
        rank0["final_valid"])
    assert history(log_dir) == history(log_dir / "rank1")
    assert history(log_dir)[1] == [rank0["final_valid"]]
    # rank 0 alone writes the run's files; rank 1 logs in its subdir
    assert (log_dir / "config.json").exists()
    assert sorted(os.listdir(log_dir / "rank1")) == ["metrics.jsonl"]
    assert sorted(os.listdir(log_dir / "ckpt")) == ["epoch_0.tar",
                                                    "index.json"]
    payload = torch.load(log_dir / "ckpt" / "epoch_0.tar",
                         weights_only=False)
    assert not any(k.startswith("module.") for k in payload["model"])


def test_spawned_checkpoints_load_in_test_and_serve(spawned, capsys):
    rank0, log_dir = spawned
    capsys.readouterr()
    main(["test", "--data-dir", "data/dev", "--bz", "1", "--platform",
          "cpu", "--log-dir", str(log_dir)])
    out = last_json(capsys.readouterr().out)
    assert out["loss"] == pytest.approx(rank0["final_valid"], rel=1e-6)
    # serve's loader reads best_model.tar strictly
    model = load_model("fnssl", str(log_dir), 2, "cpu")
    saved = torch.load(log_dir / "ckpt" / "epoch_0.tar",
                       weights_only=False)["model"]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)


def test_spawned_world_resumes(spawned):
    rank0, log_dir = spawned
    proc = subprocess.run(
        [sys.executable, "-m", "fnssl_tpu_torch.cli",
         *fit_argv(str(log_dir), "--epochs", "2", "--spawn", "2",
                   "--resume")],
        env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from epoch 0" in proc.stdout
    log1 = (log_dir / "rank1.spawn.log").read_text()
    assert "resumed from epoch 0" in log1
    assert last_json(proc.stdout) == last_json(log1)
    train, valid = history(log_dir)
    assert len(train) == len(valid) == 2 and valid[0] == rank0["final_valid"]
    assert history(log_dir) == history(log_dir / "rank1")
    assert sorted(os.listdir(log_dir / "ckpt")) == [
        "epoch_0.tar", "epoch_1.tar", "index.json"]


def test_use_mesh_equals_the_plain_fit(workdir, capsys):
    """A world of one in this process (gloo, DDP, the padded eval
    schedule) reproduces the plain fit."""
    main(fit_argv("runs/plain", "--epochs", "2"))
    plain = last_json(capsys.readouterr().out)
    main(fit_argv("runs/mesh", "--epochs", "2", "--use-mesh"))
    mesh = last_json(capsys.readouterr().out)
    assert not torch.distributed.is_initialized()    # the CLI left it
    for a, b in zip(history("runs/plain"), history("runs/mesh")):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    assert mesh["best_epoch"] == plain["best_epoch"]


def test_test_ranks_share_the_world_loss(spawned, tmp_path, capsys):
    """`test --num-processes 2`: rank 0 here, rank 1 in a subprocess, at a
    file store; each rank scores its share and both print the world's
    loss, the single-process test's."""
    _, log_dir = spawned
    capsys.readouterr()
    main(["test", "--data-dir", "data/dev", "--bz", "1", "--platform",
          "cpu", "--log-dir", str(log_dir)])
    single = last_json(capsys.readouterr().out)
    world = ["test", "--data-dir", "data/dev", "--bz", "1", "--platform",
             "cpu", "--log-dir", str(log_dir), "--num-processes", "2",
             "--coordinator", f"file://{tmp_path}/store"]
    rank1 = subprocess.Popen(
        [sys.executable, "-m", "fnssl_tpu_torch.cli", *world,
         "--process-id", "1"], env={**os.environ, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        main(world + ["--process-id", "0"])
        out1, err1 = rank1.communicate(timeout=300)
    finally:
        if rank1.poll() is None:
            rank1.kill()
            rank1.wait()
    assert rank1.returncode == 0, err1[-3000:]
    rank0 = last_json(capsys.readouterr().out)
    assert rank0["loss"] == last_json(out1)["loss"]
    assert rank0["loss"] == pytest.approx(single["loss"], rel=1e-6)


@pytest.fixture
def one_card(monkeypatch):
    """A host that reports one CUDA card (nothing is launched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_a_cuda_world_larger_than_the_cards_is_refused(workdir, one_card):
    with pytest.raises(RuntimeError, match="NCCL does not allow two ranks"):
        distributed.initialize("127.0.0.1:9", 2, 0)
    argv = ["fit", "--model", "fnssl", "--train-dir", "data/train",
            "--valid-dir", "data/dev", "--log-dir", "runs/refused"]
    with pytest.raises(RuntimeError, match="NCCL does not allow two ranks"):
        main(argv + ["--num-processes", "2", "--process-id", "0",
                     "--coordinator", "127.0.0.1:9"])
    with pytest.raises(SystemExit, match="one card a rank"):
        main(argv + ["--spawn", "2"])
    assert not os.path.exists("runs/refused")
    assert not torch.distributed.is_initialized()


def test_use_mesh_refuses_a_bz_the_cards_do_not_split(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(SystemExit, match="pass a multiple of 3"):
        main(["fit", "--model", "fnssl", "--train-dir", "data/train",
              "--valid-dir", "data/dev", "--log-dir", "runs/refused",
              "--use-mesh", "--bz", "16"])
    assert not os.path.exists("runs/refused")
