"""The port's FN-SSL data path against fnssl_tpu's, on the CPU.

Scenes come from both packages' ``generate`` with the same seed, in the
wav+pickle and the compact npz formats. The image-source engine is
pinned alike on both sides (numpy against numpy, and the port's C++
engine, built from its own copy of ism.cpp, against the JAX package's,
built from the same source), since the two engines round differently.
Small scenes: 0.5 s, 4 trajectory points.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fnssl_tpu.data as jdata
import fnssl_tpu.sim.native as jnative
from fnssl_tpu.parallel import host_local_slice as j_host_local_slice
import fnssl_tpu_torch.data as tdata
import fnssl_tpu_torch.sim.native as tnative
from fnssl_tpu_torch.parallel import host_local_slice

ROOT = Path(__file__).resolve().parents[1]
T_S, NB_POINTS, NUM = 0.5, 4, 3


def simulate(pkg, out, seed, compact):
    ds = pkg.make_fnssl_trajectory_dataset(T=T_S, nb_points=NB_POINTS,
                                           seed=seed)
    pkg.generate(str(out), NUM, dataset=ds, compact=compact)
    return out


@pytest.fixture(scope="module", params=["native", "numpy"])
def scenes(request, tmp_path_factory):
    """Both packages' scenes from seed 1, in both formats, under one
    engine."""
    engine = request.param
    if engine == "native":
        assert jnative.native_available() and tnative.native_available()
        yield from _scenes(tmp_path_factory, engine)
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "native_available", lambda: False)
        mp.setattr(tnative, "native_available", lambda: False)
        yield from _scenes(tmp_path_factory, engine)


def _scenes(tmp_path_factory, engine):
    root = tmp_path_factory.mktemp(engine)
    yield {(pkg, fmt): simulate(mod, root / f"{pkg}_{fmt}", 1,
                                fmt == "compact")
           for pkg, mod in (("jax", jdata), ("port", tdata))
           for fmt in ("wav", "compact")}


def test_native_engine_is_built_from_the_ports_source():
    lib = tnative.library_path("ism")
    assert lib.parent == ROOT / "fnssl_tpu_torch" / "_build"
    assert (tnative.SRC_DIR / "ism.cpp").read_bytes() == (
        ROOT / "fnssl_tpu" / "sim" / "native" / "ism.cpp").read_bytes() \
        .replace(b"fnssl_tpu/sim/ism.py", b"fnssl_tpu_torch/sim/ism.py")
    assert tnative.native_available() and lib.exists()


def test_native_build_takes_cxx_when_gxx_lacks_openmp(tmp_path, monkeypatch):
    """A g++ first on PATH that fails -fopenmp (no libgomp.spec): the
    library is built by c++, and when every compiler fails, build_error
    holds each one's message and the numpy engine is taken."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("g++", "c++"):
        (bin_dir / name).write_text(
            "#!/bin/sh\necho \"g++-real: fatal error: cannot read spec "
            "file 'libgomp.spec'\" >&2\nexit 1\n")
        (bin_dir / name).chmod(0o755)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setattr(tnative, "_errors", {})
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    (bin_dir / "c++").unlink()
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    assert tnative.native_available() and tnative.build_error("ism") is None
    assert tnative.library_path("ism").parent == tmp_path / "build"

    (bin_dir / "c++").write_text((bin_dir / "g++").read_text())
    (bin_dir / "c++").chmod(0o755)
    monkeypatch.setattr(tnative, "_libs", {})
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build2")
    assert not tnative.native_available()
    err = tnative.build_error("ism")
    assert err.count("libgomp.spec") == 2 and "'c++'" in err


def test_generate_writes_the_jax_scenes(scenes):
    jdir, tdir = scenes["jax", "wav"], scenes["port", "wav"]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for i in range(NUM):
        jmic, jscene = jdata.load_file(jdata.AcousticScene.empty(),
                                       f"{jdir}/{i}.wav", f"{jdir}/{i}.npz")
        tmic, tscene = tdata.load_file(tdata.AcousticScene.empty(),
                                       f"{tdir}/{i}.wav", f"{tdir}/{i}.npz")
        np.testing.assert_allclose(tmic, jmic, rtol=0, atol=1e-6)
        assert sorted(vars(tscene)) == sorted(vars(jscene))
        for key in ("DOA", "mic_vad_sources", "mic_vad", "traj_pts",
                    "room_sz", "beta", "mic_pos", "source_signal",
                    "noise_signal"):
            np.testing.assert_array_equal(getattr(tscene, key),
                                          getattr(jscene, key), key)
        assert (tscene.T60, tscene.SNR) == (jscene.T60, jscene.SNR)
        assert type(tscene.array_setup).__module__ == \
            "fnssl_tpu_torch.data.arrays"


def test_generate_compact_writes_the_jax_scenes(scenes):
    jdir, tdir = scenes["jax", "compact"], scenes["port", "compact"]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with np.load(jdir / name) as j, np.load(tdir / name) as t:
            assert sorted(j.files) == sorted(t.files)
            np.testing.assert_array_equal(t["mic_i16"], j["mic_i16"])
            np.testing.assert_allclose(t["scale"], j["scale"], rtol=1e-6)
            for key in ("doa_w", "vad_w", "fs"):
                np.testing.assert_array_equal(t[key], j[key])


def batches(pkg, slice_fn, data_dir, bz, epoch, shuffle, workers):
    ds = pkg.FixTrajectoryDataset(str(data_dir),
                                  transforms=[pkg.Segmenting()])
    sched = slice_fn(len(ds), epoch, seed=2, shuffle=shuffle)
    return list(pkg.DataLoader(lambda e: ds[e[0]], sched, bz,
                               pkg.collate_segmented, num_workers=workers,
                               drop_last=shuffle))


@pytest.mark.parametrize("fmt", ["wav", "compact"])
def test_loader_yields_the_jax_batches(scenes, fmt):
    data_dir = scenes["jax", fmt]
    for epoch, shuffle, bz in ((0, True, 2), (1, True, 1), (0, False, 2)):
        want = batches(jdata, j_host_local_slice, data_dir, bz, epoch,
                       shuffle, 0)
        got = batches(tdata, host_local_slice, data_dir, bz, epoch,
                      shuffle, 2)
        assert len(got) == len(want) == (NUM // bz if shuffle
                                         else -(-NUM // bz))
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["doa", "mic_sig", "vad"]
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], k)


def test_host_local_slice_matches_jax():
    for epoch in (0, 3):
        for shuffle in (True, False):
            assert host_local_slice(7, epoch, seed=5, shuffle=shuffle) == \
                j_host_local_slice(7, epoch, seed=5, shuffle=shuffle,
                                   process_index=0, process_count=1)


def test_jax_reads_a_port_written_directory(scenes):
    for fmt in ("wav", "compact"):
        port_dir, jax_dir = scenes["port", fmt], scenes["jax", fmt]
        from_port = batches(jdata, j_host_local_slice, port_dir, 2, 0,
                            False, 0)
        from_jax = batches(jdata, j_host_local_slice, jax_dir, 2, 0,
                           False, 0)
        for g, w in zip(from_port, from_jax, strict=True):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6)


UNPICKLE = """
import json, sys
from fnssl_tpu_torch.data.scene import AcousticScene, load_file
mic, scene = load_file(AcousticScene.empty(), sys.argv[1], sys.argv[2])
bad = sorted(m for m in sys.modules if m in ("jax", "fnssl_tpu")
             or m.startswith(("jax.", "jaxlib", "fnssl_tpu.")))
print(json.dumps({"bad": bad, "shape": list(mic.shape),
                  "array_setup": type(scene.array_setup).__module__,
                  "mic_scale": type(scene.array_setup.mic_scale).__module__}))
"""


def test_unpickler_reads_jax_scenes_without_importing_jax(scenes):
    jdir = scenes["jax", "wav"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", UNPICKLE,
                           f"{jdir}/0.wav", f"{jdir}/0.npz"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["shape"] == [int(T_S * 16000), 2]
    assert out["array_setup"] == "fnssl_tpu_torch.data.arrays"
    assert out["mic_scale"] == "fnssl_tpu_torch.data.params"


def test_unpickler_refuses_other_jax_classes(tmp_path):
    """A class of fnssl_tpu that is not a scene class is refused, not
    imported."""
    path = tmp_path / "x.npz"
    path.write_bytes(b"cfnssl_tpu.train.step\nTrainState\n.")  # protocol 0
    with pytest.raises(pickle.UnpicklingError, match="unknown scene class"):
        tdata.load_file(tdata.AcousticScene.empty(), None, str(path))


def test_prefetch_to_device_passes_batches_through_on_the_cpu():
    batches_ = [{"mic_sig": np.full((2, 3), i, np.float32),
                 "doa": np.zeros((2, 1, 2, 1), np.float32)} for i in range(5)]
    got = list(tdata.prefetch_to_device(iter(batches_), size=2,
                                        device="cpu"))
    assert len(got) == 5 and all(g is w for g, w in zip(got, batches_))


def test_prefetch_to_device_defaults_to_the_card(monkeypatch):
    """``device=None`` is the first CUDA device, as for every entry point:
    where there is none it raises at the call, and takes no batch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    taken = []

    def batches_():
        taken.append(1)
        yield {"mic_sig": np.zeros((2, 3), np.float32)}

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.prefetch_to_device(batches_(), size=2)
    assert taken == []


@pytest.mark.cuda
def test_prefetch_to_device_lands_every_batch_on_the_card():
    """Each batch, read on the compute stream while the copies of the next
    ones run on the side stream, equals its host batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    host = [{"mic_sig": rng.standard_normal((16, 76640, 2), np.float32)}
            for _ in range(6)]
    sums = []
    for b in tdata.prefetch_to_device(iter(host), size=2, device="cuda"):
        x = b["mic_sig"]
        for _ in range(20):                 # keep the compute stream busy
            x = x * 1.0
        sums.append(x.double().sum())
    for s, h in zip(sums, host):
        assert abs(s.item() - h["mic_sig"].astype(np.float64).sum()) < 1e-3
