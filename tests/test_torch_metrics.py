"""The port's decode and metrics against fnssl_tpu's, on the CPU.

Seeded random predictions (model outputs in [-1, 1], ground truths in
radians) go through both packages. Decoded DOAs are grid points, so they
must be equal; spectra and scores agree within 1e-6 (the float32 matrix
products sum in another order). The random spectra hold no exact ties,
so argmax and peak order agree; at an exact tie both take the lower grid
index.
"""
import numpy as np
import pytest
import torch

import fnssl_tpu.eval.decode as jdecode
import fnssl_tpu.eval.metrics as jmetrics
from fnssl_tpu.eval.pred_doa import PredDOA as JPredDOA
from fnssl_tpu.eval.pred_doa import predgt2doa_cls as j_predgt2doa_cls
import fnssl_tpu_torch.eval.decode as tdecode
import fnssl_tpu_torch.eval.metrics as tmetrics
from fnssl_tpu_torch.eval.pred_doa import PredDOA, predgt2doa_cls

NB, NT = 3, 24


def gt(rng, ns=1):
    doa = np.stack([np.full((NB, NT, ns), np.pi / 2),
                    rng.uniform(0, np.pi, (NB, NT, ns))], axis=2)
    return {"doa": doa.astype(np.float32),
            "vad_sources": rng.uniform(0, 1, (NB, NT, ns)).astype(
                np.float32)}


def close_dicts(got, want, tol=1e-6):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("ae_mode", [("azi",), ("azi", "ele", "aziele")])
@pytest.mark.parametrize("use_vad", [True, False])
def test_get_metric_single_matches_jax(ae_mode, use_vad):
    rng = np.random.default_rng(1)
    g, e = gt(rng), gt(rng)
    args = (np.degrees(g["doa"]), g["vad_sources"], np.degrees(e["doa"]),
            e["vad_sources"])
    kw = dict(ae_mode=ae_mode, ae_th=30.0, use_vad=use_vad)
    close_dicts(tmetrics.get_metric_single(*args, **kw),
                jmetrics.get_metric_single(*args, **kw), 0)


@pytest.mark.parametrize("use_vad", [True, False])
def test_get_metric_multiple_matches_jax(use_vad):
    rng = np.random.default_rng(2)
    g, e = gt(rng, ns=2), gt(rng, ns=3)
    args = (np.degrees(g["doa"]), g["vad_sources"], np.degrees(e["doa"]),
            e["vad_sources"])
    kw = dict(ae_mode=("azi", "aziele"), ae_th=20.0, vad_th=(0.3, 0.4),
              use_vad=use_vad)
    close_dicts(tmetrics.get_metric_multiple(*args, **kw),
                jmetrics.get_metric_multiple(*args, **kw), 0)


def test_angular_error_matches_jax():
    rng = np.random.default_rng(3)
    est, ref = rng.uniform(-200, 200, (2, 2, 50))
    for mode in ("azi", "ele", "aziele"):
        np.testing.assert_array_equal(tmetrics.angular_error(est, ref, mode),
                                      jmetrics.angular_error(est, ref, mode))


@pytest.mark.parametrize("mode", ["kNum", "unkNum"])
@pytest.mark.parametrize("ns", [1, 2, 3])
def test_pd_decode_matches_jax(mode, ns):
    rng = np.random.default_rng(4)
    ipd = rng.uniform(-1, 1, (NB, NT, 512, 1)).astype(np.float32)
    tmpl = rng.uniform(-1, 1, (3, 9, 512, 1)).astype(np.float32)
    ele = np.linspace(0, np.pi, 3).astype(np.float32)
    azi = np.linspace(-np.pi, np.pi, 9).astype(np.float32)
    want = jdecode.pd_decode(ipd, tmpl, ele, azi, max_num_sources=ns,
                             source_num_mode=mode)
    got = tdecode.pd_decode(*(torch.from_numpy(a) for a in
                              (ipd, tmpl, ele, azi)),
                            max_num_sources=ns, source_num_mode=mode)
    np.testing.assert_array_equal(got.doa.numpy(), np.asarray(want.doa))
    np.testing.assert_allclose(got.vad.numpy(), np.asarray(want.vad),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.spatial_spectrum.numpy(),
                               np.asarray(want.spatial_spectrum),
                               rtol=0, atol=1e-6)


def test_pd_decode_fills_missing_peaks_as_jax():
    """A flat spectrum has no strict peak: every slot falls back to a
    non-peak cell, in the order JAX's top_k gives."""
    ipd = np.zeros((1, 2, 4, 1), np.float32)
    tmpl = np.ones((2, 5, 4, 1), np.float32)
    cand = (np.arange(2, dtype=np.float32), np.arange(5, dtype=np.float32))
    want = jdecode.pd_decode(ipd, tmpl, *cand, max_num_sources=3)
    got = tdecode.pd_decode(torch.from_numpy(ipd), torch.from_numpy(tmpl),
                            *(torch.from_numpy(c) for c in cand),
                            max_num_sources=3)
    np.testing.assert_array_equal(got.doa.numpy(), np.asarray(want.doa))
    np.testing.assert_array_equal(got.vad.numpy(), np.asarray(want.vad))


@pytest.mark.parametrize("decode", ["idl", "pd"])
def test_tracking_is_not_ported_yet(decode):
    """``track=True`` (once refused) reassociates the decoded tracks frame
    to frame: JAX's DOAs exactly, its scores within 1e-6."""
    rng = np.random.default_rng(8)
    ipd = rng.uniform(-1, 1, (NB, NT, 8, 1)).astype(np.float32)
    tmpl = rng.uniform(-1, 1, (3, 9, 8, 1)).astype(np.float32)
    cand = (np.linspace(0, np.pi, 3).astype(np.float32),
            np.linspace(0, 2 * np.pi, 9).astype(np.float32))
    want = getattr(jdecode, f"{decode}_decode")(
        ipd, tmpl, *cand, max_num_sources=3, track=True)
    got = getattr(tdecode, f"{decode}_decode")(
        torch.from_numpy(ipd), torch.from_numpy(tmpl),
        *(torch.from_numpy(c) for c in cand), max_num_sources=3, track=True)
    np.testing.assert_array_equal(got.doa.numpy(), np.asarray(want.doa))
    np.testing.assert_allclose(got.vad.numpy(), np.asarray(want.vad),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("method,ns,source_mode", [
    ("IDL", 1, "single"), ("IDL", 2, "multiple"), ("PD", 1, "single"),
    ("PD", 2, "multiple")])
def test_pred_doa_evaluate_matches_jax(method, ns, source_mode):
    """PredDOA.__call__ (decode + evaluate) on FN-SSL-shaped output."""
    rng = np.random.default_rng(5)
    pred = rng.uniform(-1, 1, (NB, NT, 512)).astype(np.float32)
    g = gt(rng)
    kw = dict(method_mode=method, max_num_sources=ns,
              source_num_mode="unkNum" if ns > 1 else "kNum")
    mkw = dict(ae_th=10.0, source_mode=source_mode,
               vad_th=(0.5, 0.2 if ns > 1 else 2 / 3))
    want = JPredDOA(**kw)(pred, g, **mkw)
    tpd = PredDOA(device="cpu", **kw)
    close_dicts(tpd(torch.from_numpy(pred), g, **mkw), want)
    jp = JPredDOA(**kw).predgt2doa(pred)[0]
    tp = tpd.predgt2doa(torch.from_numpy(pred))[0]
    np.testing.assert_array_equal(tp["doa"].numpy(), np.asarray(jp["doa"]))


def test_pred_doa_evaluate_takes_tensors_on_the_decoder_device():
    rng = np.random.default_rng(6)
    g, e = gt(rng), gt(rng)
    want = JPredDOA().evaluate(e, g)
    got = PredDOA(device="cpu").evaluate(
        {k: torch.from_numpy(v) for k, v in e.items()},
        {k: torch.from_numpy(v) for k, v in g.items()})
    close_dicts(got, want, 0)


def test_predgt2doa_cls_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((NB, NT, 180)).astype(np.float32)
    want, _ = j_predgt2doa_cls(logits)
    got, _ = predgt2doa_cls(torch.from_numpy(logits))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    g = gt(rng)
    close_dicts(PredDOA(device="cpu").evaluate(got, g),
                JPredDOA().evaluate(want, g))
