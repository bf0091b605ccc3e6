"""tools/jax_ckpt_to_tar.py: the orbax checkpoints of a JAX fit become the
``best_model.tar`` that the port's ``cli serve`` loads.

The checkpoints are written by fnssl_tpu's own CheckpointManager, as its
Learner does (the train state of two epochs of seeded full-width params,
no fit): the tool must take the best epoch by validation loss, not the
last, bit for bit.
"""
import importlib.util
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fnssl_tpu.models.fnssl import FNSSLConfig as JConfig
from fnssl_tpu.models.fnssl import init_fnssl_params
from fnssl_tpu.train.checkpoint import CheckpointManager
from fnssl_tpu.train.convert import nested_to_flat
from fnssl_tpu.train.step import init_train_state, make_optimizer
from fnssl_tpu_torch.cli.main import load_model
from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
from fnssl_tpu_torch.train.convert import load_torch_tar

TOOL = Path(__file__).resolve().parents[1] / "tools" / "jax_ckpt_to_tar.py"


def load_tool():
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_tar", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bridge_writes_the_best_epoch_and_serve_loads_it(tmp_path, capsys):
    cfg = JConfig()
    best = init_fnssl_params(jax.random.PRNGKey(7), cfg)
    last = init_fnssl_params(jax.random.PRNGKey(8), cfg)
    log_dir = str(tmp_path)
    state = init_train_state(best, make_optimizer("adam"))
    mgr = CheckpointManager(os.path.join(log_dir, "ckpt"))
    mgr.save(0, state, 0.25)
    mgr.save(1, state._replace(params=last), 0.5)
    mgr.close()

    # without the file, serve's loader warns and takes fresh params
    capsys.readouterr()
    load_model("fnssl", log_dir, 2, "cpu")
    assert "using fresh params" in capsys.readouterr().out

    path = load_tool().main(["--log-dir", log_dir, "--seed", "2"])
    assert path == os.path.join(log_dir, "best_model.tar")
    state, meta = load_torch_tar(path)
    assert meta["epoch"] == 0
    want = nested_to_flat(best)
    assert sorted(state) == sorted(want)
    for name, value in want.items():
        got = state[name].numpy()
        assert got.dtype == value.dtype and got.shape == value.shape
        assert np.array_equal(got.view(np.uint32), value.view(np.uint32)), \
            name
    FNSSL(FNSSLConfig(), device="cpu").load_state_dict(state, strict=True)

    capsys.readouterr()
    model = load_model("fnssl", log_dir, 2, "cpu")
    assert "fresh params" not in capsys.readouterr().out
    assert not model.training
    for name, value in model.state_dict().items():
        assert torch.equal(value, state[name]), name


@pytest.mark.parametrize("model", ["ipdnet", "ipdnet_offline",
                                   "variable_ipdnet"])
def test_bridge_takes_the_ipdnet_models(tmp_path, model):
    """A JAX IPDnet fit's checkpoints (the train state of its published
    config) become a best_model.tar that the port's model loads strictly,
    bit for bit; ``ipdnet``'s through ``cli serve``'s loader."""
    import fnssl_tpu.models.ipdnet as jm
    import fnssl_tpu_torch.models.ipdnet as tm
    if model == "variable_ipdnet":
        init, cfg = jm.init_variable_ipdnet_params, jm.VariableIPDnetConfig()
        port = tm.VariableIPDnet(tm.VariableIPDnetConfig(), device="cpu")
    else:
        kw = dict(is_online=model == "ipdnet")
        init, cfg = jm.init_ipdnet_params, jm.IPDnetConfig(**kw)
        port = tm.IPDnet(tm.IPDnetConfig(**kw), device="cpu")
    jinit = jax.jit(init, static_argnums=1)
    best, last = (jinit(jax.random.PRNGKey(k), cfg) for k in (3, 4))
    state = init_train_state(best, make_optimizer("adam"))
    mgr = CheckpointManager(os.path.join(tmp_path, "ckpt"))
    mgr.save(0, state._replace(params=last), 0.5)
    mgr.save(1, state, 0.25)
    mgr.close()

    path = load_tool().main(["--log-dir", str(tmp_path), "--model", model])
    sd, meta = load_torch_tar(path)
    assert meta["epoch"] == 1
    port.load_state_dict(sd, strict=True)
    for name, value in nested_to_flat(best).items():
        assert np.array_equal(sd[name].numpy().view(np.uint32),
                              value.view(np.uint32)), name
    if model == "ipdnet":
        served = load_model("ipdnet", str(tmp_path), 2, "cpu")
        for name, value in served.state_dict().items():
            assert torch.equal(value, sd[name]), name


def test_bridge_takes_ipdnet2(tmp_path, monkeypatch):
    """A JAX IPDnet2 fit's checkpoints (the train state under AdamW with a
    clip of 5, as its ``cli fit``) become a best_model.tar that ``cli
    serve``'s loader takes strictly, bit for bit. Both packages'
    ``SpatialNetConfig`` at 2 layers, hidden 16: the tool builds its
    template from eager JAX draws, one compile each."""
    import fnssl_tpu.models.spatialnet as js
    import fnssl_tpu_torch.models.spatialnet as ts
    import fnssl_tpu_torch.train.tasks as ttasks

    for mod in (js, ts, ttasks):
        monkeypatch.setattr(mod, "SpatialNetConfig", lambda _o=getattr(
            mod, "SpatialNetConfig"), **kw: _o(**{"num_layers": 2,
                                                  "dim_hidden": 16, **kw}))
    cfg = js.SpatialNetConfig(dim_input=10, dim_output=16)
    jinit = jax.jit(js.init_spatialnet_params, static_argnums=1)
    best, last = (jinit(jax.random.PRNGKey(k), cfg) for k in (3, 4))
    state = init_train_state(best, make_optimizer("adamw", grad_clip=5.0))
    mgr = CheckpointManager(os.path.join(tmp_path, "ckpt"))
    mgr.save(0, state._replace(params=last), 0.5)
    mgr.save(1, state, 0.25)
    mgr.close()

    path = load_tool().main(["--log-dir", str(tmp_path), "--model",
                             "ipdnet2"])
    sd, meta = load_torch_tar(path)
    assert meta["epoch"] == 1
    for name, value in nested_to_flat(best).items():
        assert np.array_equal(sd[name].numpy().view(np.uint32),
                              value.view(np.uint32)), name
    served = load_model("ipdnet2", str(tmp_path), 2, "cpu")
    assert sorted(served.state_dict()) == sorted(sd)
    for name, value in served.state_dict().items():
        assert torch.equal(value, sd[name]), name
