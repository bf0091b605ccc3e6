"""The port's serving artifacts (runtime/export.py) on the CPU: the ports of
tests/test_export.py's cases on CPU programs, each artifact's output held
against its direct module, and a check that loading an artifact imports
no model code.

Small sizes: FN-SSL and IPDnet at hidden 32, IPDnet2 at 2 layers of hidden
16, VariableIPDnet at hidden 32. Tolerances: an artifact against its own
module within 1e-6 (the same ops on the same weights; measured equal);
a stream artifact run chunk by chunk against the one-shot forward within
1e-5 relative (+1e-6): float32 recurrences summed in other chunkings.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
from fnssl_tpu_torch.models.ipdnet import (IPDnet, IPDnetConfig,
                                           VariableIPDnet,
                                           VariableIPDnetConfig)
from fnssl_tpu_torch.models.spatialnet import SpatialNet, SpatialNetConfig
from fnssl_tpu_torch.runtime.export import export_model, load_artifact
from tests.test_torch_threads import torch_threads  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
HIDDEN = 32


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def fnssl():
    return FNSSL(FNSSLConfig(hidden_size=HIDDEN), device="cpu",
                 generator=gen()).eval()


def feats_of(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def direct(module, feats, **kw):
    with torch.no_grad():
        return module(torch.as_tensor(feats), **kw)


def test_init_state_roundtrip(tmp_path):
    """A stream artifact keeps its initial state as a flat list of tensors
    with one storage each (the models build several leaves from one zeros
    tensor), read back without model code; the manifest names the input
    and the platforms."""
    model = fnssl()
    meta = export_model("fnssl", model, feats_of(0, (1, 4, 256, 12)),
                        str(tmp_path / "art"), mode="stream")
    assert meta["mode"] == "stream" and meta["platforms"] == ["cpu"]
    assert meta["input_shape"] == [1, 4, 256, 12]
    assert meta["input_dtype"] == "float32" and meta["state_leaves"] == 6
    leaves = torch.load(tmp_path / "art" / "init_state.pt",
                        weights_only=True)
    assert len(leaves) == 6
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == 6
    assert all(tuple(t.shape) == (1, 256, HIDDEN) and not t.any()
               for t in leaves)
    on_disk = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert on_disk == meta


def test_forward_artifact_matches_direct_apply(tmp_path):
    model = fnssl()
    feats = feats_of(1, (2, 4, 256, 24))
    meta = export_model("fnssl", model, feats, str(tmp_path / "art"))
    m = load_artifact(str(tmp_path / "art"), "cpu")
    torch.testing.assert_close(m(feats), direct(model, feats), rtol=1e-6,
                               atol=1e-6)
    assert meta["mode"] == "forward"
    for f in ("model.cpu.pt2", "meta.json"):
        assert os.path.exists(tmp_path / "art" / f)


def stream_model(name):
    if name == "fnssl":
        return fnssl(), (1, 4, 256, 24), 12
    if name == "ipdnet":
        return IPDnet(IPDnetConfig(hidden_size=HIDDEN), device="cpu",
                      generator=gen()).eval(), (1, 4, 256, 24), 12
    return SpatialNet(SpatialNetConfig(num_layers=2, dim_hidden=16),
                      device="cpu", generator=gen()).eval(), \
        (1, 10, 256, 10), 5


@pytest.mark.parametrize("name", ["fnssl", "ipdnet", "ipdnet2"])
def test_stream_artifact_chunked_equals_oneshot(tmp_path, name):
    """The exported chunk step carries its state: two chunks reproduce the
    one-shot forward (the streaming ≡ offline invariant, across
    serialization); ``reset`` restarts the stream; ``clone`` is an
    independent stream over the same program."""
    model, shape, chunk = stream_model(name)
    feats = feats_of(2, shape)
    export_model(name, model, feats[..., :chunk], str(tmp_path / "art"),
                 mode="stream")
    m = load_artifact(str(tmp_path / "art"), "cpu")
    first = m(feats[..., :chunk])
    o = torch.cat([first, m(feats[..., chunk:])], dim=1)
    torch.testing.assert_close(o, direct(model, feats), rtol=1e-5,
                               atol=1e-6)
    m.reset()
    torch.testing.assert_close(m(feats[..., :chunk]), first, rtol=0, atol=0)
    fresh = m.clone()
    torch.testing.assert_close(fresh(feats[..., :chunk]), first, rtol=0,
                               atol=0)


def test_variable_ipdnet_forward_export(tmp_path):
    """The variable-array model exports forward-only (pairs on the batch
    axis); stream mode is a clean error for the stateless variants."""
    model = VariableIPDnet(VariableIPDnetConfig(hidden_size=HIDDEN),
                           device="cpu", generator=gen()).eval()
    feats = feats_of(3, (3, 4, 256, 12))
    export_model("variable_ipdnet", model, feats, str(tmp_path / "art"))
    m = load_artifact(str(tmp_path / "art"), "cpu")
    torch.testing.assert_close(m(feats), direct(model, feats), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="no causal streaming"):
        export_model("variable_ipdnet", model, feats,
                     str(tmp_path / "art2"), mode="stream")


def test_export_platforms(tmp_path, monkeypatch):
    """``platforms`` takes cpu and cuda, one program each; tpu is refused,
    and a cuda program needs the card; a loader asks for a platform the
    artifact holds."""
    model = fnssl()
    feats = feats_of(4, (1, 4, 256, 12))
    with pytest.raises(ValueError, match="platform 'tpu'"):
        export_model("fnssl", model, feats, str(tmp_path / "a"),
                     platforms=["cpu", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model("fnssl", model, feats, str(tmp_path / "a"),
                     platforms=["cpu", "cuda"])
    meta = export_model("fnssl", model, feats, str(tmp_path / "a"),
                        platforms=["cpu"])
    assert meta["platforms"] == ["cpu"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifact(str(tmp_path / "a"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="not cuda"):
        load_artifact(str(tmp_path / "a"), "cuda")


LOAD_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from fnssl_tpu_torch.runtime.export import load_artifact
m = load_artifact({art!r}, "cpu")
out = m(torch.zeros(1, 4, 256, 12))
bad = sorted(k for k in sys.modules if k.startswith("fnssl_tpu_torch.models")
             or k == "jax" or k.startswith("fnssl_tpu."))
print(json.dumps({{"bad": bad, "shape": list(out.shape)}}))
"""


def test_load_artifact_needs_no_model_code(tmp_path):
    """A fresh process loads and runs a stream artifact with only
    ``runtime.export`` and the custom ops imported: no
    ``fnssl_tpu_torch.models`` module, no JAX."""
    export_model("fnssl", fnssl(), feats_of(5, (1, 4, 256, 12)),
                 str(tmp_path / "art"), mode="stream")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_ONLY.format(root=str(ROOT),
                                                art=str(tmp_path / "art"))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "shape": [1, 1, 512]}


def test_cli_export_after_fit(tmp_path, monkeypatch, capsys):
    """`cli export` takes the fit's checkpoint and writes a loadable
    artifact whose outputs equal the checkpoint's model; `stream
    --artifact` gives the same DOA track as `stream` from the checkpoint
    (no model code runs in the artifact's case)."""
    import sys as _sys

    import fnssl_tpu_torch.models.fnssl as tfm
    from fnssl_tpu_torch.cli.main import load_model, main
    from fnssl_tpu_torch.utils import logging as tlogging

    orig = tfm.FNSSLConfig
    monkeypatch.setattr(tfm, "FNSSLConfig", lambda **kw: orig(
        **{"hidden_size": HIDDEN, **kw}))
    monkeypatch.setitem(_sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(tlogging, "tag_and_log_git_status",
                        lambda path, note="": open(path, "w").write(note))
    monkeypatch.chdir(tmp_path)
    main(["simulate", "--out", "data/train", "--num", "2", "--T", "0.5",
          "--nb-points", "4", "--seed", "3"])
    main(["fit", "--model", "fnssl", "--train-dir", "data/train",
          "--valid-dir", "data/train", "--epochs", "1", "--bz", "1",
          "--log-dir", "runs/e", "--platform", "cpu", "--workers", "0"])
    capsys.readouterr()
    main(["export", "--model", "fnssl", "--log-dir", "runs/e", "--out",
          "art", "--mode", "stream", "--platform", "cpu"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["epoch"] == 1 and info["mode"] == "stream"
    assert info["platforms"] == ["cpu"]

    m = load_artifact("art", "cpu")
    feats = feats_of(1, (1, 4, 256, 12))
    model = load_model("fnssl", "runs/e", 0, "cpu", best=False)
    torch.testing.assert_close(m(feats), direct(model, feats), rtol=1e-6,
                               atol=1e-6)

    main(["stream", "--model", "fnssl", "--wav", "data/train/0.wav",
          "--log-dir", "runs/e", "--out", "st_ckpt", "--platform", "cpu"])
    capsys.readouterr()
    main(["stream", "--wav", "data/train/0.wav", "--artifact", "art",
          "--out", "st_art", "--platform", "cpu"])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["out_frames"] >= 1
    np.testing.assert_allclose(np.load("st_art/doa_est.npy"),
                               np.load("st_ckpt/doa_est.npy"), atol=1e-3)
    with pytest.raises(SystemExit, match="--mode stream"):
        main(["export", "--model", "fnssl", "--log-dir", "runs/e", "--out",
              "fwd", "--platform", "cpu"])
        main(["stream", "--wav", "data/train/0.wav", "--artifact", "fwd",
              "--platform", "cpu"])
    with pytest.raises(SystemExit, match="multiple of the model chunk"):
        main(["export", "--model", "fnssl", "--log-dir", "runs/e", "--out",
              "bad", "--mode", "stream", "--export-t", "10", "--platform",
              "cpu"])
