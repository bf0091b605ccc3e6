"""The port's ``cli simulate``/``fit``/``test`` on the CPU (``--platform
cpu``), in-process, and against fnssl_tpu's CLI.

The lifecycle tests run FN-SSL at full width (``FNSSLConfig()``) on 0.5 s
scenes. The cross-package check patches both CLIs' ``FNSSLConfig`` to
hidden size 32: it compiles the JAX model, which takes ~20 s at full
width on the CPU, and the width does not change what it checks (the
port's ``test --best`` reads JAX's weights and gives JAX's loss and
metrics).
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fnssl_tpu_torch.cli.main import (_apply_yaml_defaults, _batches,
                                      build_parser, main)
from tests.test_torch_threads import torch_threads  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A directory with 3 train scenes (wav+pickle) and 2 dev scenes
    (compact npz), so that fit and test read both formats."""
    d = tmp_path_factory.mktemp("torch_cli")
    old = os.getcwd()
    os.chdir(d)
    with pytest.MonkeyPatch.context() as mp:
        # TensorBoard's writer imports TensorFlow here (~18 s); the
        # Learner's metrics.jsonl is what these tests read
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        main(["simulate", "--out", "data/train", "--num", "3", "--T", "0.5",
              "--nb-points", "4", "--seed", "1"])
        main(["simulate", "--out", "data/dev", "--num", "2", "--T", "0.5",
              "--nb-points", "4", "--seed", "77", "--compact"])
        yield d
    os.chdir(old)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def fit(log_dir, *extra, model="fnssl"):
    main(["fit", "--model", model, "--train-dir", "data/train",
          "--valid-dir", "data/dev", "--bz", "1", "--platform", "cpu",
          "--log-dir", log_dir, *extra])


def run_test(data_dir, log_dir, *extra, model="fnssl"):
    main(["test", "--model", model, "--data-dir", data_dir, "--bz", "1",
          "--platform", "cpu", "--log-dir", log_dir, *extra])


def test_simulate_says_which_engine_ran(workdir, capsys):
    main(["simulate", "--out", "data/one", "--num", "1", "--T", "0.5",
          "--nb-points", "4", "--seed", "3"])
    out = last_json(capsys)
    assert out["scenes"] == 1 and out["ism_engine"] == "native C++/OpenMP"
    assert out["threads"] >= 1 and out["seconds"] > 0
    assert sorted(os.listdir("data/one")) == ["0.npz", "0.wav"]


@pytest.mark.parametrize("model", ["fnssl", "fnssl_doa"])
def test_cli_lifecycle(workdir, capsys, model):
    """simulate → fit → test: the restored test loss equals the final
    valid loss (the same weights, bit for bit, and the same eval)."""
    log_dir = f"runs/{model}"
    capsys.readouterr()
    fit(log_dir, "--epochs", "1", model=model)
    result = last_json(capsys)
    assert np.isfinite(result["final_valid"])
    assert np.isfinite(result["final_train"]) and result["best_epoch"] == 0
    for f in ("ckpt/epoch_0.tar", "ckpt/index.json", "config.json",
              "git.out", "best_model.tar", "metrics.jsonl"):
        assert os.path.exists(f"{log_dir}/{f}"), f

    run_test("data/dev", log_dir, model=model)
    metrics = last_json(capsys)
    assert abs(metrics["loss"] - result["final_valid"]) < 1e-6  # restored
    assert np.isfinite(metrics["ACC"]) and np.isfinite(metrics["MAE"])
    tags = [json.loads(line)["tag"]
            for line in open(f"{log_dir}/metrics.jsonl")]
    for tag in ("train/loss", "train/epoch_s", "train/steps",
                "train/loader_wait_s", "train/first_batch_wait_s",
                "valid/loss", "test/loss",
                "test/ACC"):
        assert tag in tags, tag


def test_cli_fit_wires_epoch_length_into_schedule(workdir, monkeypatch):
    """The γ^epoch lr decay steps at epoch boundaries: cmd_fit passes the
    dataset's steps per epoch (3 scenes, bz 1) and the task's lr/γ."""
    import fnssl_tpu_torch.train.learner as learner_mod

    captured = {}
    real_init = learner_mod.Learner.__init__

    def spy_init(self, *a, **kw):
        captured.update(kw)
        real_init(self, *a, **kw)

    monkeypatch.setattr(learner_mod.Learner, "__init__", spy_init)
    monkeypatch.setattr(learner_mod.Learner, "fit",
                        lambda self, *a, **kw: {"train": [0.0],
                                                "valid": [0.0]})
    fit("runs/spe", "--epochs", "1")
    assert captured["steps_per_epoch"] == 3
    assert (captured["lr"], captured["lr_gamma"]) == (1e-3, 0.8988)
    sched = learner_mod.make_optimizer("adam", 1e-3, 0.8988, 3).schedule
    assert [sched(c) for c in (0, 2, 3, 6)] == [1e-3, 1e-3, 1e-3 * 0.8988,
                                                1e-3 * 0.8988 ** 2]


def test_eval_never_drops_samples(workdir):
    """Eval keeps the ragged last batch; train keeps the fixed-shape
    drop_last contract (3 scenes, bz 2)."""
    dyn = list(_batches("data/train", 2, 0, 2, False, workers=0))
    assert [b["mic_sig"].shape[0] for b in dyn] == [2, 1]
    train = list(_batches("data/train", 2, 0, 2, True, workers=0))
    assert [b["mic_sig"].shape[0] for b in train] == [2]


def test_resume_continues_and_best_takes_the_lowest_valid_loss(
        workdir, capsys):
    fit("runs/r", "--epochs", "2", "--train-size", "1")
    first = last_json(capsys)
    fit("runs/r", "--epochs", "3", "--resume", "--train-size", "1")
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out
    assert "epoch 2: train" in out and "epoch 0: train" not in out
    index = json.load(open("runs/r/ckpt/index.json"))
    assert sorted(index) == ["0", "1", "2"]
    best = min(sorted(index, key=int), key=lambda e: index[e])
    # best_epoch ranks every kept epoch, those of the first run too
    assert json.loads(out.strip().splitlines()[-1])["best_epoch"] == int(best)
    run_test("data/dev", "runs/r", "--best")
    out = capsys.readouterr().out
    assert f"resumed from epoch {best}" in out
    assert abs(json.loads(out.strip().splitlines()[-1])["loss"]
               - index[best]) < 1e-6
    assert abs(index["1"] - first["final_valid"]) < 1e-6
    blob = torch.load("runs/r/best_model.tar", weights_only=False)
    assert blob["epoch"] == int(best)


def test_best_epoch_names_a_validated_epoch_with_valid_every(workdir,
                                                             capsys):
    """With --valid-every 2 over 3 epochs, epochs 1 and 2 are validated;
    best_epoch names the one of them with the lower valid loss (not its
    position among the validated epochs)."""
    fit("runs/ve", "--epochs", "3", "--valid-every", "2", "--train-size", "1")
    out = capsys.readouterr().out
    epochs = [line for line in out.splitlines() if line.startswith("epoch ")]
    assert ["valid" in line for line in epochs] == [False, True, True]
    index = json.load(open("runs/ve/ckpt/index.json"))
    assert sorted(index) == ["1", "2"]
    best = min(sorted(index, key=int), key=lambda e: index[e])
    assert json.loads(out.strip().splitlines()[-1])["best_epoch"] == int(best)


def test_checkpoints_keep_the_top_k_and_the_last(tmp_path):
    from fnssl_tpu_torch.train.checkpoint import CheckpointManager
    from fnssl_tpu_torch.train.step import init_train_state, make_optimizer

    module = torch.nn.Linear(3, 2)
    state = init_train_state(module, make_optimizer("adam"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_top_k=2,
                            best_path=str(tmp_path / "best.tar"))
    losses = [0.5, float("nan"), 0.2, 0.9, 0.3, 0.8]
    for epoch, loss in enumerate(losses):
        with torch.no_grad():
            module.weight.fill_(epoch)
        mgr.save(epoch, state, loss)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "epoch_2.tar", "epoch_4.tar", "epoch_5.tar", "index.json"]
    assert mgr.best_epoch() == 2 and mgr.latest_epoch() == 5
    restored, epoch = CheckpointManager(str(tmp_path / "ckpt")).restore(
        state, 4)
    assert epoch == 4 and (restored.module.weight == 4).all()
    best = torch.load(tmp_path / "best.tar", weights_only=False)
    assert best["epoch"] == 2 and (best["model"]["weight"] == 2).all()
    # a NaN never ranks best, even as the only loss
    mgr = CheckpointManager(str(tmp_path / "nan"), keep_top_k=1)
    mgr.save(0, state, float("nan"))
    mgr.save(1, state, 7.0)
    assert mgr.best_epoch() == 1


def test_port_test_best_gives_jax_loss_and_metrics(workdir, capsys,
                                                   monkeypatch, tmp_path):
    """JAX's ``cli test`` on fresh params from --seed, and the port's
    ``cli test --best`` on the same params written as best_model.tar by
    fnssl_tpu.train.convert.save_torch_tar: the same loss (1e-5 relative)
    and the same metrics (1e-6)."""
    import jax

    import fnssl_tpu.models.fnssl as jfnssl
    import fnssl_tpu_torch.models.fnssl as tfnssl
    from fnssl_tpu.cli.main import main as jmain
    from fnssl_tpu.train.convert import save_torch_tar

    for mod in (jfnssl, tfnssl):
        orig = mod.FNSSLConfig
        monkeypatch.setattr(mod, "FNSSLConfig",
                            lambda _o=orig, **kw: _o(hidden_size=32, **kw))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    capsys.readouterr()
    jmain(["test", "--model", "fnssl", "--data-dir", "data/dev",
               "--bz", "2", "--seed", "4", "--platform", "cpu",
               "--log-dir", "runs/jax_fresh"])
    want = last_json(capsys)

    params = jfnssl.init_fnssl_params(jax.random.PRNGKey(4),
                                      jfnssl.FNSSLConfig())
    os.makedirs("runs/from_jax", exist_ok=True)
    save_torch_tar("runs/from_jax/best_model.tar", params)
    run_test("data/dev", "runs/from_jax", "--best", "--seed", "9", "--bz", "2")
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out
    got = json.loads(out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want) == ["ACC", "MAE", "loss"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    for k in ("ACC", "MAE"):
        assert abs(got[k] - want[k]) <= 1e-6, k


def small_fnssl(monkeypatch):
    """The port's FNSSLConfig at hidden 32 for the fit below."""
    import fnssl_tpu_torch.models.fnssl as tfnssl

    orig = tfnssl.FNSSLConfig
    monkeypatch.setattr(tfnssl, "FNSSLConfig",
                        lambda _o=orig, **kw: _o(hidden_size=32, **kw))


def test_fit_profile_traces_the_first_epochs_then_continues(
        workdir, capsys, monkeypatch):
    """``--profile 1 --epochs 2``: a torch.profiler trace of epoch 0 in
    <log-dir>/profile/trace.json (Chrome format, the model's LSTM and
    matmul ops in it), then epoch 1 outside the trace."""
    small_fnssl(monkeypatch)
    capsys.readouterr()
    fit("runs/profile", "--epochs", "2", "--profile", "1")
    result = last_json(capsys)
    assert np.isfinite(result["final_train"])
    trace = json.load(open("runs/profile/profile/trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
    epochs = [json.loads(line)["step"]
              for line in open("runs/profile/metrics.jsonl")
              if json.loads(line)["tag"] == "train/loss"]
    assert epochs == [0, 1]


def test_fit_debug_nans_runs_under_anomaly_mode(workdir, capsys,
                                                monkeypatch):
    """``--debug-nans``: every train epoch runs with autograd's anomaly
    detection on; the mode is off again after the fit; losses finite."""
    import fnssl_tpu_torch.train.learner as learner_mod

    small_fnssl(monkeypatch)
    seen = []
    real = learner_mod.Learner.train_epoch

    def spy(self, batches):
        seen.append(torch.is_anomaly_enabled())
        return real(self, batches)

    monkeypatch.setattr(learner_mod.Learner, "train_epoch", spy)
    capsys.readouterr()
    fit("runs/nans", "--epochs", "1", "--debug-nans")
    result = last_json(capsys)
    assert np.isfinite(result["final_train"])
    assert np.isfinite(result["final_valid"])
    assert seen == [True] and not torch.is_anomaly_enabled()
    fit("runs/no_nans", "--epochs", "1")
    assert seen == [True, False]


def test_config_yaml_sets_defaults_and_flags_win(workdir):
    ap = build_parser()
    args = ap.parse_args(["fit", "--config", str(ROOT / "configs" /
                                                 "fnssl.yaml"),
                          "--train-dir", "a", "--valid-dir", "b",
                          "--epochs", "1"])
    args = _apply_yaml_defaults(ap, args)
    assert (args.model, args.bz, args.precision, args.epochs) == (
        "fnssl", 16, "bf16", 1)
    assert args.early_stop_patience == 10 and args.workers == 2


@pytest.mark.parametrize("argv,match", [
    (["fit", "--rss-restart-gb", "10"], "TPU-client fault"),
    (["fit", "--stall-restart-s", "900"], "TPU-client fault"),
    (["fit", "--spawn", "2", "--num-processes", "2"],
     "--spawn launches the world itself"),
    (["fit", "--num-processes", "2", "--coordinator", "h:1"],
     "needs --coordinator and --process-id"),
    (["fit", "--coordinator", "h:1", "--num-processes", "2",
      "--process-id", "2"], "--process-id 2 is outside"),
    (["fit", "--num-processes", "2"], "needs --coordinator and --process-id"),
    (["test", "--num-processes", "2", "--process-id", "0", "--coordinator",
      "h"], "HOST:PORT"),
    (["fit", "--model", "ipdnet2"], "ipdnet2 trains on RealMAN"),
    (["fit", "--model", "ipdnet2", "--realman-csv", "t.csv"],
     "pass --realman-csv and --realman-noise"),
    (["fit", "--model", "ipd_baseline"], "model-free"),
    (["test", "--model", "ipdnet2"], "ipdnet2 tests on RealMAN"),
    (["test", "--model", "ipdnet2", "--best"], "pass --realman-csv"),
])
def test_cli_unported_options_say_so(workdir, argv, match):
    dirs = {"fit": ["--train-dir", "data/train", "--valid-dir", "data/dev",
                    "--platform", "cpu", "--log-dir", "runs/no"],
            "test": ["--data-dir", "data/dev", "--platform", "cpu",
                     "--log-dir", "runs/no"],
            "simulate": ["--out", "data/no", "--num", "1"]}[argv[0]]
    with pytest.raises(SystemExit, match=match):
        main(argv + dirs)
    assert not os.path.exists("runs/no") and not os.path.exists("data/no")
