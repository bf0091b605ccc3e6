"""Rules of the PyTorch/CUDA port: fnssl_tpu_torch imports neither JAX
nor fnssl_tpu, and its entry points, asked for the default device where
there is no CUDA, raise instead of running on the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import json, pkgutil, importlib, sys
import fnssl_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    fnssl_tpu_torch.__path__, "fnssl_tpu_torch.")
    if not m.name.endswith("__main__"))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "fnssl_tpu."))
             or m == "fnssl_tpu")
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_fnssl_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert "fnssl_tpu_torch.kernels.lstm_cuda" in out["modules"]
    assert "fnssl_tpu_torch.runtime.server" in out["modules"]
    for name in ("data.simu", "data.loader", "sim.native", "eval.metrics",
                 "train.learner", "train.checkpoint", "parallel",
                 "models.ipdnet", "eval.pred_doa", "physics.targets",
                 "train.tasks", "runtime.streaming", "models.mamba",
                 "models.spatialnet", "kernels.ssm_cuda", "data.realman",
                 "kernels.ops", "runtime.slots", "runtime.export",
                 "models.attention", "models.retention", "models.norms",
                 "data.locata", "data.segments", "eval.vis",
                 "utils.profiling", "parallel.mesh", "parallel.distributed",
                 "core.gcc", "core.convs", "core.complexops",
                 "utils.flops"):
        assert f"fnssl_tpu_torch.{name}" in out["modules"]
    assert len(out["modules"]) >= 69


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_by_default(no_cuda, tmp_path):
    from fnssl_tpu_torch.cli.main import main
    from fnssl_tpu_torch.eval.pred_doa import PredDOA, PredDOAMultiTrack
    from fnssl_tpu_torch.models.fnssl import FNSSL
    from fnssl_tpu_torch.models.ipdnet import IPDnet, VariableIPDnet
    from fnssl_tpu_torch.data.loader import prefetch_to_device
    from fnssl_tpu_torch.models.lstm import LSTM
    from fnssl_tpu_torch.models.spatialnet import SpatialNet
    from fnssl_tpu_torch.runtime.streaming import StreamingLocalizer
    from fnssl_tpu_torch.train.tasks import (DUALCH_MIC_LOCATION,
                                             make_ipdnet2_task,
                                             make_ipdnet_task)

    for make in (FNSSL, lambda: LSTM(4, 32), PredDOA,
                 lambda: StreamingLocalizer(lambda f: f, nch=2), IPDnet,
                 VariableIPDnet, make_ipdnet_task,
                 lambda: PredDOAMultiTrack(DUALCH_MIC_LOCATION), SpatialNet,
                 make_ipdnet2_task, lambda: prefetch_to_device([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for model in ("fnssl", "fnssl_doa", "ipdnet", "ipdnet2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["serve", "--model", model, "--port", "0", "--log-dir",
                  str(tmp_path)])
    for argv in (["predict", "--wav", "x.wav"], ["stream", "--wav", "x.wav"],
                 ["export", "--out", str(tmp_path / "art")],
                 ["serve", "--slots", "2", "--port", "0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--log-dir", str(tmp_path)])
    assert not (tmp_path / "art").exists()


def test_training_entry_points_refuse_the_cpu_by_default(no_cuda, tmp_path):
    """Learner, ``cli fit`` and ``cli test`` without ``--platform cpu``
    raise where there is no card, before they write anything."""
    from fnssl_tpu_torch.cli.main import main
    from fnssl_tpu_torch.train.learner import Learner

    log_dir = str(tmp_path / "runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Learner(lambda module, batch, generator: 0.0,
                torch.nn.Linear(2, 2), log_dir=log_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["fit", "--train-dir", str(tmp_path), "--valid-dir",
              str(tmp_path), "--log-dir", log_dir])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["test", "--data-dir", str(tmp_path), "--log-dir", log_dir])
    realman = ["--realman-csv", "t.csv", "--realman-noise", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["fit", "--model", "ipdnet2", "--train-dir", str(tmp_path),
              "--valid-dir", str(tmp_path), "--log-dir", log_dir] + realman)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["test", "--model", "ipdnet2", "--data-dir", str(tmp_path),
              "--log-dir", log_dir] + realman)
    assert not (tmp_path / "runs").exists()


def test_cpu_is_taken_only_when_asked(no_cuda):
    from fnssl_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device()


def test_kernel_sources_ship_with_the_package():
    from fnssl_tpu_torch.kernels import cuda_build

    src = cuda_build.CSRC / "lstm_fwd.cu"
    assert src.exists()
    text = src.read_text()
    assert 'extern "C" int lstm_fwd(' in text
    assert "lstm_pallas.py:_lstm_kernel" in text
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
    assert cuda_build.library_path("lstm_fwd").parent == cuda_build.BUILD_DIR


def test_cluster_kernel_source_ships_with_the_package():
    from fnssl_tpu_torch.kernels import cuda_build

    text = (cuda_build.CSRC / "lstm_cluster.cu").read_text()
    assert 'extern "C" int lstm_cluster(' in text
    assert "lstm_pallas.py:_lstm_kernel" in text
    assert "cudaLaunchAttributeClusterDimension" in text
    assert (cuda_build.library_path("lstm_cluster").parent
            == cuda_build.BUILD_DIR)


def test_ssm_kernel_source_ships_with_the_package():
    from fnssl_tpu_torch.kernels import cuda_build, ssm_cuda

    text = (cuda_build.CSRC / "ssm_scan.cu").read_text()
    for name in ("selective_scan_fwd", "selective_scan_bwd"):
        assert f'extern "C" int {name}(' in text
        assert name in ssm_cuda._ARGTYPES
    assert "fnssl_tpu/models/mamba.py: ssm_scan" in text
    assert (cuda_build.library_path("ssm_scan").parent
            == cuda_build.BUILD_DIR)


def test_ssm_wrappers_take_the_plain_version_on_the_cpu_only():
    """CPU tensors run the plain scan without moving a launch counter;
    inputs the kernels do not take raise."""
    from fnssl_tpu_torch.kernels import ssm_cuda

    gen = torch.Generator().manual_seed(0)
    x, dt = torch.randn(2, 3, 8, generator=gen), torch.randn(2, 3, 8)
    bias, a = torch.randn(8), -torch.rand(8, 16, generator=gen)
    bm, c = torch.randn(2, 3, 16, generator=gen), torch.randn(2, 3, 16)
    d_skip, h0 = torch.ones(8), torch.randn(2, 8, 16, generator=gen)
    args = (x, dt, bias, a, bm, c, d_skip, h0)
    before = (ssm_cuda.launches_ssm_fwd.value,
              ssm_cuda.launches_ssm_bwd.value)
    y, h = ssm_cuda.selective_scan_fwd(*args)
    ssm_cuda.selective_scan_bwd(*args, torch.ones_like(y), h)
    assert (ssm_cuda.launches_ssm_fwd.value,
            ssm_cuda.launches_ssm_bwd.value) == before
    assert y.shape == (2, 3, 8) and h.shape == (2, 8, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssm_cuda.selective_scan_fwd(x.double(), dt.double(), bias, a,
                                    bm.double(), c.double(), d_skip, h0)
    with pytest.raises(ValueError, match="c must be"):
        ssm_cuda.selective_scan_fwd(x, dt, bias, a, bm, c[:, :2], d_skip, h0)
