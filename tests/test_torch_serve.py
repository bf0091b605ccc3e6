"""Port serving path (fnssl_tpu_torch.runtime + cli serve) on the CPU:
streaming ≡ one-shot, streaming ≡ fnssl_tpu's StreamingLocalizer with
the same weights, a TCP round trip, the wrong-nch rejection and the CLI
wiring. Small model: hidden 32, nfft 64 (nf 32). Tolerance: FN-SSL
outputs atol 1e-4, decoded DOAs equal."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.models.fnssl import FNSSLConfig as JConfig
from fnssl_tpu.models.fnssl import fnssl_apply, init_fnssl_params
from fnssl_tpu.runtime.streaming import StreamingLocalizer as JLocalizer
from fnssl_tpu.runtime.streaming import make_fnssl_stream_step as j_step
from fnssl_tpu_torch.cli.main import build_parser, build_server
from fnssl_tpu_torch.eval.pred_doa import PredDOA
from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
from fnssl_tpu_torch.runtime.server import LocalizationServer, stream_client
from fnssl_tpu_torch.runtime.streaming import (StreamingLocalizer,
                                               make_fnssl_stream_step)
from fnssl_tpu_torch.train.convert import params_to_state_dict, save_torch_tar
from fnssl_tpu_torch.train.preprocess import stft_features
from tests.test_torch_threads import torch_threads  # noqa: F401


ATOL = 1e-4
SMALL = dict(win_len=64, hop=32, nfft=64)


@pytest.fixture(scope="module")
def small():
    jcfg = JConfig(hidden_size=32)
    params = jax.tree.map(np.asarray,
                          init_fnssl_params(jax.random.PRNGKey(1), jcfg))
    model = FNSSL(FNSSLConfig(hidden_size=32), device="cpu").eval()
    model.load_state_dict(params_to_state_dict(params), strict=True)
    decoder = PredDOA(nfft=64, device="cpu")

    def decode(chunk):
        return decoder.predgt2doa(chunk)[0]

    def factory():
        loc = StreamingLocalizer(make_fnssl_stream_step(model, nf=32),
                                 nch=2, device="cpu", **SMALL)
        return loc, decode

    return params, jcfg, model, factory, decode


def audio(seed, n):
    return (np.random.default_rng(seed).standard_normal((n, 2)) * 0.1
            ).astype(np.float32)


def push_all(loc, sig, block):
    outs = []
    for start in range(0, sig.shape[0], block):
        outs.extend(loc.push(sig[start: start + block]))
    return outs


def test_streaming_matches_one_shot(small):
    _, _, model, factory, _ = small
    sig = audio(0, 32 * 40 + 64)                 # 41 frames → 3 chunks
    loc, _ = factory()
    outs = push_all(loc, sig, 700)
    assert len(outs) == 3 and loc.rtf > 0
    feats = stft_features(torch.as_tensor(sig[None]), win_len=64, nfft=64)
    with torch.no_grad():
        one = model(feats[..., :36])
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), one.numpy(),
                               rtol=0, atol=ATOL)


def test_streaming_matches_jax_streaming(small):
    params, jcfg, _, factory, _ = small
    sig = audio(1, 32 * 50)
    loc, _ = factory()
    got = push_all(loc, sig, 1000)
    jloc = JLocalizer(j_step(params, jcfg, nf=32), nch=2, **SMALL)
    want = push_all(jloc, sig, 1000)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    # one-shot JAX on the same frames, as a second witness
    feats = stft_features(torch.as_tensor(sig[None]), win_len=64, nfft=64)
    one = fnssl_apply(params, jnp.asarray(feats[..., :48].numpy()), cfg=jcfg)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(),
                               np.asarray(one), rtol=0, atol=ATOL)


def test_server_roundtrip_matches_direct(small):
    _, _, _, factory, decode = small
    sig = audio(2, 32 * 60)
    server = LocalizationServer(factory).start()
    try:
        msgs = stream_client("127.0.0.1", server.port, sig, block=500)
        again = stream_client("127.0.0.1", server.port, sig, block=500)
    finally:
        server.shutdown()
    assert msgs[-1] == {"eof": True, "outputs": len(msgs) - 1}
    assert len(msgs) - 1 == 4 and again == msgs   # state resets per stream
    loc, _ = factory()
    want = []
    for out in push_all(loc, sig, 500):
        want.extend(np.degrees(decode(out)["doa"].numpy())[0])
    for msg, w in zip(msgs[:-1], want):
        np.testing.assert_allclose(msg["doa_deg"], np.round(w, 3),
                                   atol=1e-3)


def test_server_rejects_wrong_channel_count(small):
    _, _, _, factory, _ = small
    server = LocalizationServer(factory).start()
    try:
        msgs = stream_client("127.0.0.1", server.port,
                             np.zeros((4000, 3), np.float32))
    finally:
        server.shutdown()
    assert "error" in msgs[-1] and "nch" in msgs[-1]["error"]


def serve_args(tmp_path, *extra):
    return build_parser().parse_args(
        ["serve", "--model", "fnssl", "--platform", "cpu", "--port", "0",
         "--log-dir", str(tmp_path), *extra])


def first_output(server):
    loc, decode = server.session_factory()
    outs = loc.push(audio(3, 4000))
    assert len(outs) == 1 and tuple(outs[0].shape) == (1, 1, 512)
    doa = decode(outs[0])["doa"]
    assert torch.isfinite(doa).all()
    return outs[0]


def test_cli_serve_wiring(tmp_path, capsys):
    """Full-width FN-SSL on --platform cpu: fresh weights from --seed with
    the warning, then the same weights read from best_model.tar."""
    server, info = build_server(serve_args(tmp_path, "--seed", "5"))
    try:
        assert "no checkpoint found" in capsys.readouterr().out
        assert info["serving"] == "fnssl" and info["port"] > 0
        assert info["model_device"] == "cpu" and info["nch"] == 2
        fresh = first_output(server)
    finally:
        server._sock.close()
    model = FNSSL(device="cpu",
                  generator=torch.Generator().manual_seed(5))
    save_torch_tar(str(tmp_path / "best_model.tar"), model.state_dict())
    server, _ = build_server(serve_args(tmp_path, "--seed", "9"))
    try:
        assert "no checkpoint" not in capsys.readouterr().out
        torch.testing.assert_close(first_output(server), fresh, rtol=0,
                                   atol=0)
    finally:
        server._sock.close()


@pytest.mark.parametrize("argv,message", [
    (["locata", "--model", "ipdnet2", "--locata-dir", "x"], "not wired"),
    (["predict", "--model", "variable_ipdnet", "--wav", "x.wav"],
     "not wired")])
def test_cli_unported_paths_say_so(argv, message):
    """locata and predict refuse the models JAX's commands do not wire,
    with JAX's message."""
    from fnssl_tpu_torch.cli.main import main

    with pytest.raises(SystemExit, match=message):
        main(argv)


def test_cli_announces_placement(tmp_path, monkeypatch, capsys):
    from fnssl_tpu_torch.cli.main import main

    monkeypatch.setattr(LocalizationServer, "serve_forever",
                        lambda self: self._sock.close())
    main(["serve", "--platform", "cpu", "--port", "0", "--log-dir",
          str(tmp_path)])
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["frontend_device"] == info["decode_device"] == "cpu"
