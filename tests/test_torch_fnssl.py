"""Port FN-SSL (fnssl_tpu_torch.models.fnssl) against fnssl_tpu's
``fnssl_apply`` on the CPU, with the same weights carried across
(JAX params → numpy → ``params_to_state_dict``). Small size: hidden 32,
nf 32, nt ≤ 36. Tolerance: atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.models.fnssl import FNSSLConfig as JConfig
from fnssl_tpu.models.fnssl import FNSSLState as JState
from fnssl_tpu.models.fnssl import fnssl_apply, init_fnssl_params
from fnssl_tpu.models.fnssl import init_fnssl_state as j_init_state
from fnssl_tpu.models.lstm import LSTMState as JLState
from fnssl_tpu.train.convert import save_torch_tar
from fnssl_tpu_torch.models.fnssl import (FNSSL, FNSSLConfig, FNSSLState,
                                          init_fnssl_state)
from fnssl_tpu_torch.models.lstm import LSTMState
from fnssl_tpu_torch.train.convert import (load_torch_tar, nested_to_flat,
                                           params_to_state_dict,
                                           save_torch_tar as t_save_tar)

ATOL = 1e-4
NF = 32


def pair(is_online=True, is_doa=False, seed=0):
    jcfg = JConfig(hidden_size=32, is_online=is_online, is_doa=is_doa)
    params = jax.tree.map(np.asarray,
                          init_fnssl_params(jax.random.PRNGKey(seed), jcfg))
    model = FNSSL(FNSSLConfig(hidden_size=32, is_online=is_online,
                              is_doa=is_doa), device="cpu").eval()
    model.load_state_dict(params_to_state_dict(params), strict=True)
    return params, jcfg, model


def feats(seed, nb=2, nt=36):
    return np.random.default_rng(seed).standard_normal(
        (nb, 4, NF, nt)).astype(np.float32)


@pytest.mark.parametrize("is_online,is_doa", [(True, False), (False, False),
                                              (True, True)])
def test_fnssl_matches_jax(is_online, is_doa):
    params, jcfg, model = pair(is_online, is_doa)
    x = feats(1)
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    want = np.asarray(fnssl_apply(params, jnp.asarray(x), cfg=jcfg))
    assert got.shape == want.shape == ((2, 3, 180) if is_doa
                                       else (2, 3, 2 * NF))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fnssl_streaming_state_matches_one_shot_and_jax():
    """3 chunks of 12 frames carrying FNSSLState equal one shot, and the
    carried states equal JAX's ``return_state=True`` carries."""
    params, jcfg, model = pair()
    x = feats(2)
    with torch.no_grad():
        one = model(torch.as_tensor(x)).numpy()
        state = init_fnssl_state(2, NF, model.cfg, "cpu")
    jstate = j_init_state(2, NF, jcfg)
    parts = []
    for k in range(3):
        chunk = x[..., 12 * k: 12 * (k + 1)]
        with torch.no_grad():
            out, state = model(torch.as_tensor(chunk), state=state,
                               return_state=True)
        jout, jstate = fnssl_apply(params, jnp.asarray(chunk), cfg=jcfg,
                                   state=jstate, return_state=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=ATOL)
        for s, js in zip(state.narr, jstate.narr):
            assert tuple(s.h.shape) == (1, 2 * NF, 32)
            np.testing.assert_allclose(s.h.numpy(), np.asarray(js.h),
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(s.c.numpy(), np.asarray(js.c),
                                       rtol=0, atol=ATOL)
        parts.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(parts, axis=1), one, rtol=0,
                               atol=ATOL)


def test_fnssl_state_continues_from_a_jax_state():
    """A JAX carry handed to the port (numpy) continues identically."""
    params, jcfg, model = pair()
    x = feats(3, nb=1, nt=24)
    _, jstate = fnssl_apply(params, jnp.asarray(x[..., :12]), cfg=jcfg,
                            state=j_init_state(1, NF, jcfg),
                            return_state=True)
    want = fnssl_apply(params, jnp.asarray(x[..., 12:]), cfg=jcfg,
                       state=jstate)
    state = FNSSLState(narr=tuple(
        LSTMState(torch.as_tensor(np.array(s.h)),
                  torch.as_tensor(np.array(s.c))) for s in jstate.narr))
    with torch.no_grad():
        got = model(torch.as_tensor(x[..., 12:]), state=state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert isinstance(jstate, JState) and isinstance(jstate.narr[0], JLState)


def test_state_dict_names_equal_jax_param_paths():
    params, _, model = pair(is_online=False, is_doa=True)
    flat = nested_to_flat(params)
    assert sorted(model.state_dict()) == sorted(flat)
    assert "block_1.narrLstm.weight_ih_l0_reverse" in flat
    assert tuple(model.block_1.narrLstm.weight_ih_l0.shape) == (64, 36)


def test_jax_tar_loads_strictly_into_the_port(tmp_path):
    """A .tar written by fnssl_tpu's save_torch_tar loads strictly, and a
    .tar written by the port reads back equal."""
    params, jcfg, _ = pair(seed=4)
    path = str(tmp_path / "best_model.tar")
    save_torch_tar(path, params, epoch=3, max_score=0.5)
    state, meta = load_torch_tar(path)
    assert meta == {"epoch": 3, "max_score": 0.5}
    model = FNSSL(FNSSLConfig(hidden_size=32), device="cpu").eval()
    model.load_state_dict(state, strict=True)
    x = feats(5, nb=1, nt=12)
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(fnssl_apply(params, jnp.asarray(x), cfg=jcfg)),
        rtol=0, atol=ATOL)
    path2 = str(tmp_path / "port.tar")
    t_save_tar(path2, model.state_dict(), epoch=1)
    state2, meta2 = load_torch_tar(path2)
    assert meta2["epoch"] == 1
    for k, v in model.state_dict().items():
        assert torch.equal(state2[k], v)


def test_seeded_init_is_reproducible_and_pooled_head_truncates():
    def make():
        return FNSSL(FNSSLConfig(hidden_size=32), device="cpu",
                     generator=torch.Generator().manual_seed(7)).eval()
    a, b = make(), make()
    x = torch.as_tensor(feats(6, nb=1, nt=30))       # 30 % 12 frames drop
    with torch.no_grad():
        ya, yb = a(x), b(x)
    assert torch.equal(ya, yb) and tuple(ya.shape) == (1, 2, 2 * NF)
    assert torch.isfinite(ya).all() and ya.abs().max() <= 1.0
