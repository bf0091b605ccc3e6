"""The port's last library modules against fnssl_tpu on the CPU: complex
helpers, GCC-PHAT and the SRP map, spherical padding and the causal
convolution blocks, the inverse STFT, coordinates (all within 1e-5, on
inputs drawn from a numpy seed), Lightning checkpoints (exact), parameter
counts (exact), the FLOPs of a Linear and of an LSTM against hand counts,
and the package-level names of every JAX subpackage.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.core import complexops as jc
from fnssl_tpu.core import convs as jconvs
from fnssl_tpu.core import coords as jcoords
from fnssl_tpu.core.gcc import SRPMap as JSRPMap
from fnssl_tpu.core.gcc import gcc as jax_gcc
from fnssl_tpu.core.stft import istft as jax_istft
from fnssl_tpu.core.stft import stft as jax_stft
from fnssl_tpu.models.fnssl import FNSSLConfig as JConfig
from fnssl_tpu.models.fnssl import init_fnssl_params
from fnssl_tpu.train import convert as jconvert
from fnssl_tpu.utils import flops as jflops
from fnssl_tpu_torch.core import (
    SRPMap, caus_cnn_block, caus_conv1d, caus_conv2d, caus_conv3d,
    cart2sph, complex_cart2polar, complex_conjugate_multiplication,
    complex_multiplication, gcc, istft, spheric_pad, sph2cart)
from fnssl_tpu_torch.core.convs import batch_norm_2d
from fnssl_tpu_torch.models import FNSSL, FNSSLConfig, LSTM
from fnssl_tpu_torch.train.convert import (flat_to_nested,
                                           load_lightning_ckpt,
                                           nested_to_flat,
                                           params_to_state_dict)
from fnssl_tpu_torch.utils.flops import (count_params,
                                         flops_forward_backward,
                                         write_flops)

TOL = 1e-5


def close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_complexops_match_jax():
    x, y = draw((4, 5, 2), 0), draw((4, 5, 2), 1)
    for mine, ref in ((complex_multiplication, jc.complex_multiplication),
                      (complex_conjugate_multiplication,
                       jc.complex_conjugate_multiplication)):
        close(mine(torch.as_tensor(x), torch.as_tensor(y)),
              ref(jnp.asarray(x), jnp.asarray(y)))
    close(complex_cart2polar(torch.as_tensor(x)),
          jc.complex_cart2polar(jnp.asarray(x)))


@pytest.mark.parametrize("tau_max,phat", [(None, False), (20, True),
                                          (7, False)])
def test_gcc_matches_jax(tau_max, phat):
    x = draw((2, 3, 64), 2)
    got = gcc(torch.as_tensor(x), tau_max=tau_max, phat=phat)
    want = jax_gcc(jnp.asarray(x), tau_max=tau_max, phat=phat)
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want)


def test_srp_map_matches_jax():
    rn = np.random.default_rng(3).uniform(-0.1, 0.1, (3, 3))
    args = dict(n=3, k=64, res_theta=5, res_phi=8, rn=rn, fs=16000)
    mine, ref = SRPMap(**args), JSRPMap(**args)
    np.testing.assert_array_equal(mine._tau0.numpy(), np.asarray(ref._tau0))
    g = np.asarray(jax_gcc(jnp.asarray(draw((2, 3, 64), 4)), phat=True))
    close(mine(torch.as_tensor(g)), ref(jnp.asarray(g)))
    args["normalize"] = False
    close(SRPMap(**args)(torch.as_tensor(g)), JSRPMap(**args)(
        jnp.asarray(g)))


@pytest.mark.parametrize("pad", [(2, 2, 1, 1), (1, 2, 1, 2, 1, 1),
                                 (0, 3, 2, 0)])
def test_spheric_pad_matches_jax(pad):
    x = draw((2, 3, 5, 6, 8), 5)
    got = spheric_pad(torch.as_tensor(x), pad)
    want = jconvs.spheric_pad(jnp.asarray(x), pad)
    assert got.shape == want.shape
    close(got, want, atol=0)


def conv_params(out_c, in_c, kernel, seed):
    return {"weight": draw((out_c, in_c) + kernel, seed) * 0.3,
            "bias": draw((out_c,), seed + 1)}


def both(params):
    """(JAX pytree, the port's state dict) of numpy parameters."""
    return (jax.tree.map(jnp.asarray, params),
            params_to_state_dict(params))


def tp_sub(state, prefix):
    return {k[len(prefix) + 1:]: v for k, v in state.items()
            if k.startswith(prefix + ".")}


def test_causal_convs_match_jax():
    jp, tp = both(conv_params(4, 3, (5,), 6))
    x = draw((2, 3, 20), 8)
    close(caus_conv1d(tp, torch.as_tensor(x), dilation=2),
          jconvs.caus_conv1d(jp, jnp.asarray(x), dilation=2))
    jp, tp = both(conv_params(4, 3, (3, 5), 9))
    x = draw((2, 3, 12, 9), 11)
    close(caus_conv2d(tp, torch.as_tensor(x)),
          jconvs.caus_conv2d(jp, jnp.asarray(x)))
    jp, tp = both(conv_params(3, 2, (3, 3, 3), 12))
    x = draw((1, 2, 8, 6, 7), 14)
    close(caus_conv3d(tp, torch.as_tensor(x)),
          jconvs.caus_conv3d(jp, jnp.asarray(x)))


@pytest.mark.parametrize("downsample", [False, True])
def test_caus_cnn_block_and_batch_norm_match_jax(downsample):
    cin, cout = 3, (5 if downsample else 3)
    params = {"conv1": conv_params(cout, cin, (3, 3), 15),
              "bn1": {"weight": draw((cout,), 17), "bias": draw((cout,), 18)},
              "conv2": conv_params(cout, cout, (3, 3), 19),
              "bn2": {"weight": draw((cout,), 21), "bias": draw((cout,), 22)}}
    if downsample:
        params["downsample"] = conv_params(cout, cin, (1, 1), 23)
    jp, tp = both(params)
    y = draw((2, cout, 6, 9), 24)
    close(batch_norm_2d(tp_sub(tp, "bn1"), torch.as_tensor(y)),
          jconvs.batch_norm_2d(jp["bn1"], jnp.asarray(y)))
    x = draw((2, cin, 6, 9), 25)
    got = caus_cnn_block(tp, torch.as_tensor(x))
    want = jconvs.caus_cnn_block(jp, jnp.asarray(x))
    assert got.shape == want.shape
    close(got, want)


def test_istft_matches_jax():
    sig = draw((2, 8192, 2), 26)
    spec = jax_stft(jnp.asarray(sig), center=True)
    got = istft(torch.as_tensor(np.asarray(spec)))
    want = jax_istft(spec)
    assert got.shape == want.shape == (2, 8192, 2)
    close(got, want)
    # and it inverts the STFT away from the edges
    close(got[0, 256:-256], sig[0, 256:-256], atol=1e-3)


def test_coords_match_jax():
    pts = draw((50, 3), 27)
    for include_r in (False, True):
        got = cart2sph(torch.as_tensor(pts), include_r=include_r)
        close(got, jcoords.cart2sph(jnp.asarray(pts), include_r=include_r))
        close(sph2cart(got), jcoords.sph2cart(jcoords.cart2sph(
            jnp.asarray(pts), include_r=include_r)))


def test_load_lightning_ckpt_matches_jax(tmp_path):
    """A Lightning checkpoint of FN-SSL's weights under 'arch.' (and one
    key outside it): the port's state dict equals JAX's pytree, loads into
    FNSSL strictly and keeps epoch and global_step."""
    model = FNSSL(FNSSLConfig(hidden_size=32), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    sd = {f"arch.{k}": v for k, v in model.state_dict().items()}
    path = tmp_path / "last.ckpt"
    torch.save({"state_dict": {**sd, "loss_scale": torch.ones(1)},
                "epoch": 7, "global_step": 420, "optimizer_states": []},
               path)
    state, meta = load_lightning_ckpt(str(path))
    params, jmeta = jconvert.load_lightning_ckpt(str(path))
    assert meta == jmeta == {"epoch": 7, "global_step": 420}
    want = nested_to_flat(jax.tree.map(np.asarray, params))
    assert sorted(state) == sorted(want)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    state.pop("loss_scale")
    fresh = FNSSL(FNSSLConfig(hidden_size=32), device="cpu")
    fresh.load_state_dict(state, strict=True)
    nested = flat_to_nested(sd, strip_prefix="arch.")
    np.testing.assert_array_equal(
        nested["block_1"]["fullLstm"]["weight_hh_l0"],
        model.state_dict()["block_1.fullLstm.weight_hh_l0"].numpy())


def test_count_params_equals_jax():
    cfg = dict(hidden_size=32)
    jparams = init_fnssl_params(jax.random.PRNGKey(0), JConfig(**cfg))
    model = FNSSL(FNSSLConfig(**cfg), device="cpu")
    assert count_params(model) == jflops.count_params(jparams)
    assert count_params(model.state_dict()) == count_params(model)
    assert count_params(params_to_state_dict(
        jax.tree.map(np.asarray, jparams))) == count_params(model)


class Out(torch.nn.Module):
    """The LSTM's outputs alone (the FLOP counter's loss squares them)."""

    def __init__(self, lstm):
        super().__init__()
        self.lstm = lstm

    def forward(self, x):
        return self.lstm(x)[0]


def test_flops_of_a_linear_and_an_lstm_against_hand_counts(tmp_path):
    b, i, o = 6, 10, 7
    stats = flops_forward_backward(torch.nn.Linear(i, o), torch.randn(b, i))
    # x @ Wᵀ forward; the weight's gradient backward (the input takes none)
    assert stats["flops_forward"] == 2 * b * i * o
    assert stats["flops_backward"] == 2 * b * i * o
    assert stats["params"] == i * o + o
    t, b, i, h = 5, 3, 4, 8
    for ndir in (1, 2):
        lstm = LSTM(i, h, bidirectional=ndir == 2, device="cpu")
        stats = flops_forward_backward(Out(lstm), torch.randn(b, t, i))
        # the input projection and the recurrence's h @ W_hhᵀ a direction
        assert stats["flops_forward"] == ndir * 2 * t * b * 4 * h * (i + h)
        assert stats["flops_backward"] > stats["flops_forward"]
    written = write_flops(Out(lstm), torch.randn(b, t, i), str(tmp_path),
                          num_chns=4)
    text = (tmp_path / "FLOPs.yaml").read_text().splitlines()
    assert text == [f"{k}: {written[k]!r}" for k in sorted(written)]
    assert {"flops_forward", "flops_backward", "params", "fs",
            "audio_time_len", "num_chns"} <= set(written)


def test_stft_and_lstm_are_the_packages_functions():
    """JAX's package-level ``core.stft`` and ``models.lstm`` are functions;
    the port's are the same functions, and their modules stay importable
    by full path."""
    from fnssl_tpu_torch.core import stft
    from fnssl_tpu_torch.models import lstm

    stft_mod = importlib.import_module("fnssl_tpu_torch.core.stft")
    lstm_mod = importlib.import_module("fnssl_tpu_torch.models.lstm")
    assert stft is stft_mod.stft and lstm is lstm_mod.lstm
    x = torch.as_tensor(draw((1, 2048, 2), 28))
    torch.testing.assert_close(stft(x), torch.as_tensor(np.array(
        jax_stft(x.numpy()))), rtol=1e-5, atol=1e-5)
    model = LSTM(4, 8, device="cpu")
    y = torch.as_tensor(draw((2, 3, 4), 29))
    got, _ = lstm(dict(model.named_parameters()), y)
    torch.testing.assert_close(got, model(y)[0], rtol=0, atol=0)


@pytest.mark.parametrize("sub", ["core", "models", "train", "eval", "utils",
                                 "physics", "runtime", "parallel"])
def test_package_names_of_every_jax_subpackage(sub):
    """Each JAX package-level name is the port's too, or its counterpart
    is named in the port's docstring (functional names with no torch
    meaning, and the 2-D mesh the port leaves out)."""
    jax_mod = importlib.import_module(f"fnssl_tpu.{sub}")
    port = importlib.import_module(f"fnssl_tpu_torch.{sub}")
    names = [n for n in vars(jax_mod) if not n.startswith("_")
             and not isinstance(getattr(jax_mod, n), type(jax_mod))]
    missing = [n for n in names if not hasattr(port, n)]
    for n in missing:
        assert f"``{n}``" in port.__doc__, (sub, n)
    assert len(missing) <= len(names) // 2
