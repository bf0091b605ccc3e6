"""DP-IPD targets, target assembly, the FN-SSL preprocess and the losses
of the port (fnssl_tpu_torch: physics.dpipd, physics.targets,
train.preprocess, train.losses) against fnssl_tpu on the CPU, inputs
from a numpy seed.

Tolerances: targets and features atol 1e-5 (float32 phases of up to
2π·8 kHz·0.24 ms, summed in another order); losses within 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.physics.dpipd import DPIPD as JDPIPD
from fnssl_tpu.physics import targets as jtargets
from fnssl_tpu.train import losses as jlosses
from fnssl_tpu.train.preprocess import make_fnssl_preprocess as j_prep
from fnssl_tpu_torch.physics.dpipd import DPIPD
from fnssl_tpu_torch.physics import targets as ttargets
from fnssl_tpu_torch.train import losses as tlosses
from fnssl_tpu_torch.train.preprocess import make_fnssl_preprocess
from fnssl_tpu_torch.train.tasks import (DUALCH_MIC_LOCATION,
                                         synthetic_fnssl_batch)

ATOL = 1e-5
MICS_4 = np.array([[-0.05, 0.0, 0.0], [0.05, 0.0, 0.0], [0.0, 0.04, 0.0],
                   [0.0, -0.04, 0.01]])


def doas(rng, nb, nt, ns):
    return np.stack([rng.uniform(0, np.pi, (nb, nt, ns)),
                     rng.uniform(-np.pi, np.pi, (nb, nt, ns))],
                    axis=2).astype(np.float32)


@pytest.mark.parametrize("mics,ch_mode", [(DUALCH_MIC_LOCATION, "MM"),
                                          (MICS_4, "M"), (MICS_4, "MM")])
def test_dpipd_targets_match_jax(mics, ch_mode):
    kw = dict(ndoa_candidate=[37, 73], mic_location=mics, nf=257,
              fre_max=8000.0, ch_mode=ch_mode, speed=340.0)
    doa = doas(np.random.default_rng(0), 2, 5, 3)
    want = np.asarray(JDPIPD(**kw).targets(jnp.asarray(doa)))
    mine = DPIPD(**kw)
    got = mine.targets(torch.as_tensor(doa))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the template and the targets share one sign convention: a DOA on
    # the grid gives the template's column
    grid = np.zeros((1, 1, 2, 1), np.float32)
    grid[0, 0, :, 0] = [mine.doa_candidate[0][9], mine.doa_candidate[1][50]]
    np.testing.assert_allclose(
        mine.targets(torch.as_tensor(grid))[0, 0, :, :, 0].numpy(),
        mine.template[9, 50], rtol=0, atol=ATOL)
    # the tables are made once per device
    assert mine.tables("cpu")[0] is mine.tables(torch.device("cpu"))[0]


def test_ipd_ri_and_vad_mask_and_sum_match_jax():
    rng = np.random.default_rng(1)
    shape = (2, 4, 9, 3, 2)
    ipd = (rng.standard_normal(shape)
           + 1j * rng.standard_normal(shape)).astype(np.complex64)
    vad = rng.uniform(0, 1, (2, 4, 2)).astype(np.float32)
    vad[0, 1] = 0.0
    fre_used = slice(1, 9)
    want = np.asarray(jtargets.ipd_complex_to_ri(jnp.asarray(ipd), fre_used))
    got = ttargets.ipd_complex_to_ri(torch.as_tensor(ipd), fre_used)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 16, 3, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    for thr in (0.0, 0.5):
        w = np.asarray(jtargets.vad_mask_and_sum(jnp.asarray(want),
                                                 jnp.asarray(vad), thr))
        g = ttargets.vad_mask_and_sum(got, torch.as_tensor(vad), thr)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)


def test_fnssl_preprocess_matches_jax():
    """Features and gt['ipd'] of make_fnssl_preprocess on the same batch,
    with a partly silent VAD."""
    kw = dict(ndoa_candidate=[37, 73], mic_location=DUALCH_MIC_LOCATION,
              nf=257, fre_max=8000.0, ch_mode="MM", speed=340.0)
    b = synthetic_fnssl_batch(nb=2, t_s=0.6, seed=2)
    b["doa"][..., 0, :] = np.random.default_rng(3).uniform(
        0.2, 3.0, b["doa"][..., 0, :].shape)
    b["vad"][1, 1] = 0.0
    jf, jgt = j_prep(JDPIPD(**kw), ch_mode="MM")(
        *(jnp.asarray(b[k]) for k in ("mic_sig", "doa", "vad")))
    tf, tgt = make_fnssl_preprocess(DPIPD(**kw), ch_mode="MM")(
        *(torch.as_tensor(b[k]) for k in ("mic_sig", "doa", "vad")))
    assert tuple(tf.shape) == jf.shape == (2, 4, 256, 36)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                               atol=ATOL)
    assert tuple(tgt["ipd"].shape) == jgt["ipd"].shape == (2, 3, 512, 1)
    np.testing.assert_allclose(tgt["ipd"].numpy(), np.asarray(jgt["ipd"]),
                               rtol=0, atol=ATOL)
    assert not tgt["ipd"][1, 1].any()
    assert tgt["doa"] is not None and tgt["vad_sources"].shape == (2, 3, 1)


def test_mse_ipd_loss_matches_jax():
    rng = np.random.default_rng(4)
    nb, p, nt, f = 2, 3, 5, 8
    pred = rng.standard_normal((nb * p, nt, f)).astype(np.float32)
    gt = rng.standard_normal((nb, nt, f, p)).astype(np.float32)
    want = float(jlosses.mse_ipd_loss(jnp.asarray(pred), jnp.asarray(gt),
                                      nb=nb))
    got = tlosses.mse_ipd_loss(torch.as_tensor(pred), torch.as_tensor(gt),
                               nb=nb)
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_ce_doa_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 3, 180)).astype(np.float32) * 3
    labels = rng.integers(0, 180, (2, 3)).astype(np.int32)
    want = float(jlosses.ce_doa_loss(jnp.asarray(logits),
                                     jnp.asarray(labels)))
    got = tlosses.ce_doa_loss(torch.as_tensor(logits),
                              torch.as_tensor(labels))
    assert float(got) == pytest.approx(want, rel=1e-6)
