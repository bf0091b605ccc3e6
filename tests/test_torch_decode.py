"""Port decode (DPIPD template, template_ri, idl_decode, PredDOA) against
fnssl_tpu on the CPU. The spatial spectrum agrees to atol 1e-5 and the
decoded grid indices are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.eval.decode import idl_decode as j_idl
from fnssl_tpu.eval.decode import spatial_spectrum as j_ss
from fnssl_tpu.eval.decode import template_ri as j_template_ri
from fnssl_tpu.eval.decode import time_pool_ipd as j_pool
from fnssl_tpu.eval.pred_doa import PredDOA as JPredDOA
from fnssl_tpu.physics.dpipd import DPIPD as JDPIPD
from fnssl_tpu_torch.eval.decode import (idl_decode, spatial_spectrum,
                                         template_ri, time_pool_ipd)
from fnssl_tpu_torch.eval.pred_doa import PredDOA
from fnssl_tpu_torch.physics.dpipd import DPIPD

MICS = np.array([[-0.04, 0.0, 0.0], [0.04, 0.0, 0.0], [0.0, 0.05, 0.01]])


@pytest.mark.parametrize("ch_mode,speed", [("M", 343.0), ("MM", 340.0)])
def test_dpipd_template_equals_jax(ch_mode, speed):
    got = DPIPD([7, 13], MICS, nf=33, fre_max=8000.0, ch_mode=ch_mode,
                speed=speed)
    want = JDPIPD([7, 13], MICS, nf=33, fre_max=8000.0, ch_mode=ch_mode,
                  speed=speed)
    assert got.template.dtype == np.complex64
    np.testing.assert_array_equal(got.template, want.template)
    for a, b in zip(got.doa_candidate, want.doa_candidate):
        np.testing.assert_array_equal(a, b)
    sel = slice(1, 33)
    np.testing.assert_array_equal(template_ri(got.template, sel),
                                  j_template_ri(want.template, sel))


def grid():
    t = template_ri(DPIPD([5, 19], MICS[:2], nf=33, ch_mode="MM").template,
                    slice(1, 33))
    ele = np.linspace(0, np.pi, 5).astype(np.float32)
    azi = np.linspace(-np.pi, np.pi, 19).astype(np.float32)
    return t, ele, azi


def mixture(rng, t, ns, nb=2, nt=6):
    """IPDs built from ns grid templates plus noise, so the argmax is
    unambiguous."""
    flat = t.reshape(-1, *t.shape[2:])
    picks = rng.integers(0, flat.shape[0], size=(nb, nt, ns))
    ipd = flat[picks].sum(axis=2) * rng.uniform(0.6, 1.0, (nb, nt, 1, 1))
    return (ipd + 0.05 * rng.standard_normal(ipd.shape)).astype(np.float32)


@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("mode", ["kNum", "unkNum"])
def test_idl_decode_matches_jax(rng, ns, mode):
    t, ele, azi = grid()
    ipd = mixture(rng, t, ns)
    got = idl_decode(torch.as_tensor(ipd), torch.as_tensor(t),
                     torch.as_tensor(ele), torch.as_tensor(azi),
                     max_num_sources=ns, source_num_mode=mode)
    want = j_idl(jnp.asarray(ipd), jnp.asarray(t), jnp.asarray(ele),
                 jnp.asarray(azi), max_num_sources=ns, source_num_mode=mode)
    np.testing.assert_array_equal(got.doa.numpy(), np.asarray(want.doa))
    np.testing.assert_allclose(got.vad.numpy(), np.asarray(want.vad),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.spatial_spectrum.numpy(),
                               np.asarray(want.spatial_spectrum), atol=1e-5)
    np.testing.assert_allclose(
        spatial_spectrum(torch.as_tensor(ipd), torch.as_tensor(t)).numpy(),
        np.asarray(j_ss(jnp.asarray(ipd), jnp.asarray(t))), atol=1e-5)


def test_time_pool_ipd_matches_jax(rng):
    ipd = rng.standard_normal((2, 26, 8, 1)).astype(np.float32)
    np.testing.assert_allclose(
        time_pool_ipd(torch.as_tensor(ipd), 12).numpy(),
        np.asarray(j_pool(jnp.asarray(ipd), 12)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pool", [None, 2])
def test_pred_doa_matches_jax(rng, pool):
    """PredDOA's cropped template (speed 340) and predgt2doa agree, on
    model-shaped output (nb·P, nt, 2nf) at nfft 64."""
    got_dec = PredDOA(nfft=64, device="cpu")
    want_dec = JPredDOA(nfft=64)
    np.testing.assert_array_equal(got_dec.template.numpy(),
                                  np.asarray(want_dec.template))
    tmpl = got_dec.template.numpy()                  # (1, 37, 64, 1)
    picks = rng.integers(0, 37, size=(3, 4))
    pred = tmpl[0][picks][..., 0] + 0.05 * rng.standard_normal(
        (3, 4, 64))
    pred = pred.astype(np.float32)
    got, _ = got_dec.predgt2doa(torch.as_tensor(pred), time_pool_size=pool)
    want, _ = want_dec.predgt2doa(pred, time_pool_size=pool)
    for k in ("doa", "vad_sources"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["spatial_spectrum"].numpy(),
                               np.asarray(want["spatial_spectrum"]),
                               atol=1e-5)
