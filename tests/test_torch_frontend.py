"""Port front-end (fnssl_tpu_torch.core + stft_features) against
fnssl_tpu on the CPU: the same numpy-seeded inputs through both.

Tolerance: float32, |port - jax| <= 1e-5 * max|jax| (the two FFT and
scan implementations sum in different orders)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.train.preprocess import stft_features as j_stft_features
from fnssl_tpu_torch.core import norm as tnorm
from fnssl_tpu_torch.core import pairs as tpairs
from fnssl_tpu_torch.train.preprocess import stft_features

# both packages' core re-exports functions under its modules' names
jnorm = importlib.import_module("fnssl_tpu.core.norm")
jpairs = importlib.import_module("fnssl_tpu.core.pairs")
jstft = importlib.import_module("fnssl_tpu.core.stft")
tstft = importlib.import_module("fnssl_tpu_torch.core.stft")

REL = 1e-5


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


def signal(seed, nb=2, ns=1000, nch=3):
    return np.random.default_rng(seed).standard_normal(
        (nb, ns, nch)).astype(np.float32)


def test_hann_window_and_num_frames():
    np.testing.assert_array_equal(tstft.hann_window(64).numpy(),
                                  np.asarray(jstft.hann_window(64)))
    torch.testing.assert_close(tstft.hann_window(64),
                               torch.hann_window(64, periodic=True))
    for ns in (64, 100, 1000):
        for center in (False, True):
            assert (tstft.num_frames(ns, 64, 0.5, center)
                    == jstft.num_frames(ns, 64, 0.5, center))


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("nfft", [64, 128])
def test_stft_matches_jax(center, nfft):
    x = signal(0)
    got = tstft.stft(torch.as_tensor(x), win_len=64, nfft=nfft,
                     center=center)
    want = jstft.stft(jnp.asarray(x), win_len=64, nfft=nfft, center=center)
    assert got.dtype == torch.complex64
    close(got.numpy().real, np.asarray(want).real)
    close(got.numpy().imag, np.asarray(want).imag)


@pytest.mark.parametrize("ch_mode", ["M", "MM"])
def test_pairs_match_jax(ch_mode):
    for nch in (2, 3, 4):
        for a, b in zip(tpairs.pair_indices(nch, ch_mode),
                        jpairs.pair_indices(nch, ch_mode)):
            np.testing.assert_array_equal(a, b)
        assert (tpairs.num_pairs(nch, ch_mode)
                == jpairs.num_pairs(nch, ch_mode))
    data = np.random.default_rng(1).standard_normal(
        (2, 4, 5, 6)).astype(np.float32)
    got = tpairs.pair_rebatch(torch.as_tensor(data), ch_mode)
    want = jpairs.pair_rebatch(jnp.asarray(data), ch_mode=ch_mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpairs.pair_unbatch(got, 2).numpy(),
        np.asarray(jpairs.pair_unbatch(want, nb=2)))


def mag(seed, nt=31):
    return np.abs(np.random.default_rng(seed).standard_normal(
        (3, 2, 32, nt))).astype(np.float32)


def test_forgetting_norm_matches_jax():
    m = mag(2)
    got = tnorm.forgetting_norm(torch.as_tensor(m), sample_length=24)
    want = jnorm.forgetting_norm(jnp.asarray(m), sample_length=24)
    close(got.numpy(), np.asarray(want))
    close(tnorm.offline_norm(torch.as_tensor(m)).numpy(),
          np.asarray(jnorm.offline_norm(jnp.asarray(m))))


def test_forgetting_norm_start_up_quirk():
    """alp is -1 at frame 0 (mu_0 = 2·mean) and 0 at frame 1 (mu_1 =
    mean_1): a sequential loop written from the reference agrees."""
    m = mag(3, nt=9)
    got = tnorm.forgetting_norm(torch.as_tensor(m), sample_length=5)
    frame_mean = m.reshape(3, -1, 9).mean(axis=1)
    alpha = 4 / 6
    mu = np.zeros(3, np.float64)
    want = []
    for i in range(9):
        alp = min((i - 1) / (i + 1), alpha)
        mu = alp * mu + (1 - alp) * frame_mean[:, i]
        want.append(mu)
    close(got.numpy()[:, 0, 0], np.stack(want, axis=1))
    np.testing.assert_allclose(got.numpy()[:, 0, 0, 0],
                               2 * frame_mean[:, 0], rtol=1e-6)


def test_forgetting_norm_chunked_matches_one_shot_and_jax():
    """Chunks of 12 + 12 + 7 frames carry the state: equal to one shot,
    and to the JAX streaming carry."""
    m = mag(4)
    one = tnorm.forgetting_norm(torch.as_tensor(m), sample_length=24)
    state = tnorm.init_state(3)
    jstate = jnorm.init_state(3)
    parts = []
    for lo, hi in ((0, 12), (12, 24), (24, 31)):
        out, state = tnorm.forgetting_norm_streaming(
            torch.as_tensor(m[..., lo:hi]), state, sample_length=24)
        _, jstate = jnorm.forgetting_norm_streaming(
            jnp.asarray(m[..., lo:hi]), jstate, sample_length=24)
        parts.append(out)
        close(state.mu.numpy(), np.asarray(jstate.mu))
        assert state.frame0 == int(jstate.frame0)
    close(torch.cat(parts, dim=-1).numpy(), one.numpy())


@pytest.mark.parametrize("norm", ["online", "offline", "none"])
def test_stft_features_match_jax(norm):
    x = signal(5, nb=2, ns=64 * 20, nch=2)
    got = stft_features(torch.as_tensor(x), win_len=64, nfft=64,
                        norm=norm, sample_length=24)
    want = j_stft_features(jnp.asarray(x), win_len=64, nfft=64, norm=norm,
                           sample_length=24)
    assert tuple(got.shape) == (2, 4, 32, 39)
    close(got.numpy(), np.asarray(want))
