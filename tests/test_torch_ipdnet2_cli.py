"""The port's IPDnet2 data path and CLI on the CPU (``--platform cpu``),
in-process: ``data.realman.RealData`` item for item against fnssl_tpu's on
a corpus in the RealMAN layout (per-channel wavs, a dp_speech tree, the
10 Hz CSV streams of moving sources, recorded noise; the layout of
tests/test_realman.py, written with the port's own ``write_audio``); then
``fit``/``test``/``test --best`` and ``serve --model ipdnet2`` over TCP,
and the port's ``test --best`` against fnssl_tpu's ``cli test`` on the
same weights.

Both packages' ``SpatialNetConfig`` are patched to 2 layers at hidden 16:
the CPU runs the plain scan step by step, and the width does not change
what is checked (full width is the card's job, in chip_smoke.py). The
reader crops 4 s (201 frames, 40 labels) from 6 s recordings. The
git/pip provenance dump of both CLIs is written without running git and
pip here.

Tolerances: RealData items bit-identical; a test loss equals the valid
loss of the epoch it restored (1e-6 relative, the same items, seed and
weights); against JAX, the loss 1e-5 relative and the metrics 1e-5;
served DOAs equal to the direct pipeline's at the 3 decimals the wire
carries.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import fnssl_tpu.models.spatialnet as js
import fnssl_tpu.utils.logging as jlogging
import fnssl_tpu_torch.models.spatialnet as ts
import fnssl_tpu_torch.train.tasks as ttasks
import fnssl_tpu_torch.utils.logging as tlogging
from fnssl_tpu.data.realman import RealData as JRealData
from fnssl_tpu_torch.cli.main import build_parser, build_server, main
from fnssl_tpu_torch.data.realman import RealData, collate_realman
from fnssl_tpu_torch.utils.audio_io import write_audio
from tests.test_torch_threads import torch_threads  # noqa: F401


FS, NCH = 16000, 9
SMALL = {"dim_hidden": 16, "num_layers": 2}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A RealMAN-layout corpus of 3 recordings of 6 s (one static source,
    two moving ones with 60-value streams) and 5 s of 9-channel noise;
    both packages' SpatialNetConfig at 2 layers, hidden 16."""
    d = tmp_path_factory.mktemp("torch_ipdnet2_cli")
    rng = np.random.default_rng(0)
    for sub in ("ma_speech", "dp_speech", "noise"):
        os.makedirs(d / sub)
    rows = ["filename,angle(°),distance"]
    for rec in range(3):
        base = rng.standard_normal(6 * FS).astype(np.float32) * 0.3
        for ch in range(NCH):
            write_audio(str(d / "ma_speech" / f"rec{rec}_CH{ch}.wav"),
                        base * (1 + 0.01 * ch), FS)
        write_audio(str(d / "dp_speech" / f"rec{rec}.wav"), base, FS)
        if rec == 0:
            rows.append(f"rec{rec}.wav,37.0,1.5")
        else:
            angs = ",".join(str(30 + i + rec) for i in range(60))
            diss = ",".join(f"{1.0 + 0.01 * i:.2f}" for i in range(60))
            rows.append(f'rec{rec}.wav,"{angs}","{diss}"')
    (d / "targets.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    nz = rng.standard_normal(5 * FS).astype(np.float32) * 0.1
    for ch in range(NCH):
        write_audio(str(d / "noise" / f"amb_CH{ch}.wav"), nz * (1 - 0.02 * ch),
                    FS)
    old = os.getcwd()
    os.chdir(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        for logging in (jlogging, tlogging):
            mp.setattr(logging, "tag_and_log_git_status",
                       lambda path, note="": open(path, "w").write(note))
        for mod in (js, ts, ttasks):
            orig = mod.SpatialNetConfig
            mp.setattr(mod, "SpatialNetConfig",
                       lambda _o=orig, **kw: _o(**{**SMALL, **kw}))
        yield d
    os.chdir(old)


MA = "ma_speech" + os.sep
REALMAN = ["--realman-csv", "targets.csv", "--realman-noise", "noise",
           "--realman-ext", "wav"]


@pytest.mark.parametrize("max_source", [1, 2])
def test_realdata_items_equal_jax(workdir, max_source, tmp_path):
    """Every item of several per-item seeds (the 2-source reader draws
    the second recording and an overlap mode), uncached and through the
    decoded-sample cache, bit for bit; the CSV streams of moving
    sources."""
    kw = dict(use_mic_id=[0, 1, 3, 5, 7], max_source=max_source,
              ext="wav")
    jds = JRealData(MA, ["targets.csv"], "noise", **kw)
    for cache in (None, str(tmp_path / "cache")):
        tds = RealData(MA, ["targets.csv"], "noise", cache_dir=cache, **kw)
        assert tds.data_paths == jds.data_paths and len(tds) == 3
        for item in [(i, s) for i in range(3) for s in (5, 17, 123)]:
            got, want = tds[item], jds[item]
            assert len(got) == len(want) == 5
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    sig, targets, vad, topo, dist = tds[(1, 5)]
    assert sig.shape == (4 * FS, 5) and topo.shape == (5, 3)
    if max_source == 1:               # the crop of a moving source's streams
        assert (np.diff(targets[:, 0]) == 1).all()
        np.testing.assert_allclose(np.diff(dist[:, 0]), 0.01, atol=1e-6)
        _, targets, _, _, dist = tds[(0, 5)]
        assert (targets == 37).all() and (dist == 1.5).all()
    batch = collate_realman([tds[(i, 3)] for i in range(3)])
    assert batch["azi_deg"].shape == (3, 40, max_source)
    assert batch["mic_pos"].shape == (3, 5, 3)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_ipdnet2_cli_lifecycle(workdir, capsys):
    """fit 2 epochs → test → test --best: each test loss equals the valid
    loss of the epoch it restored (the same items, seed and weights);
    ACC and MAE finite."""
    capsys.readouterr()
    main(["fit", "--model", "ipdnet2", "--train-dir", MA, "--valid-dir",
          MA, "--bz", "2", "--epochs", "2", "--platform", "cpu",
          "--log-dir", "runs/ipdnet2", *REALMAN])
    fit = last_json(capsys)
    assert np.isfinite(fit["final_train"])
    assert os.path.exists("runs/ipdnet2/best_model.tar")
    valid = [json.loads(line) for line in open("runs/ipdnet2/metrics.jsonl")]
    valid = [v["value"] for v in sorted(valid, key=lambda v: v["step"])
             if v["tag"] == "valid/loss"]
    assert len(valid) == 2
    for extra, want in (([], valid[-1]), (["--best"], min(valid))):
        main(["test", "--model", "ipdnet2", "--data-dir", MA, "--bz", "2",
              "--platform", "cpu", "--log-dir", "runs/ipdnet2", *extra,
              *REALMAN])
        test = last_json(capsys)
        assert test["loss"] == pytest.approx(want, rel=1e-6)
        assert np.isfinite(test["ACC"]) and np.isfinite(test["MAE"])


def test_port_test_best_gives_jax_cli_test(workdir, capsys, monkeypatch,
                                           tmp_path):
    """JAX's ``cli test --model ipdnet2`` on fresh params from --seed, and
    the port's ``test --best`` on the same params: the same loss and
    metrics. (The seed also draws the items' mixing, so both run seed
    4.)"""
    import jax

    from fnssl_tpu.cli.main import main as jmain
    from fnssl_tpu.train.convert import save_torch_tar

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    capsys.readouterr()
    jmain(["test", "--model", "ipdnet2", "--data-dir", MA, "--bz", "2",
           "--seed", "4", "--platform", "cpu", "--log-dir", "runs/jax2",
           *REALMAN])
    want = last_json(capsys)
    cfg = js.SpatialNetConfig(dim_input=10, dim_output=16)
    params = js.init_spatialnet_params(jax.random.PRNGKey(4), cfg)
    os.makedirs("runs/from_jax2", exist_ok=True)
    save_torch_tar("runs/from_jax2/best_model.tar", params)
    main(["test", "--model", "ipdnet2", "--data-dir", MA, "--bz", "2",
          "--seed", "4", "--best", "--platform", "cpu", "--log-dir",
          "runs/from_jax2", *REALMAN])
    got = last_json(capsys)
    assert sorted(got) == sorted(want)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_serve_ipdnet2_over_tcp_on_the_cpu(workdir, capsys):
    """One TCP connection of 1 s of 5-channel audio: a line per 5-frame
    chunk step and eof; each line's DOA and VAD (2 tracks) equal the
    same pipeline run directly."""
    from fnssl_tpu_torch.runtime.server import stream_client

    args = build_parser().parse_args(
        ["serve", "--model", "ipdnet2", "--platform", "cpu", "--port", "0",
         "--seed", "3", "--log-dir", "runs/none"])
    server, info = build_server(args)
    assert "no checkpoint" in capsys.readouterr().out
    assert info["serving"] == "ipdnet2" and info["nch"] == 5
    sig = np.random.default_rng(1).standard_normal(
        (FS, 5)).astype(np.float32) * 0.1
    server.start()
    try:
        msgs = stream_client("127.0.0.1", server.port, sig, block=1500)
    finally:
        server.shutdown()
    n = ((FS + 256 - 512) // 320 + 1) // 5    # the reflect prefix: 256
    assert msgs[-1] == {"eof": True, "outputs": n} and len(msgs) == n + 1
    loc, decode = server.session_factory()
    outs = loc.push(sig)
    assert len(outs) == n and tuple(outs[0].shape) == (1, 1, 512, 4, 2)
    for msg, out in zip(msgs[:-1], outs):
        res = decode(out)
        doa = np.degrees(res["doa"].numpy())[0, 0]
        np.testing.assert_allclose(msg["doa_deg"], np.round(doa, 3),
                                   atol=1e-3)
        np.testing.assert_allclose(msg["vad"], np.round(
            res["vad_sources"].numpy()[0, 0], 4), atol=1e-4)
    assert torch.isfinite(outs[-1]).all()
