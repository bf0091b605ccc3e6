"""The port's data parallelism (fnssl_tpu_torch.parallel and the
Learner's DDP path) against a single process and against fnssl_tpu's
device mesh, on the CPU.

A 2-process gloo world (tests/torch_dp_worker.py, a file store, one
torch thread a rank) checks rank gating, the broadcast and both
barriers, and takes two DP train steps of FN-SSL (hidden 32, Adam), of a
small IPDnet2 (2 layers, hidden 16, AdamW with a clip of 5) and of the
other models the CLI trains (fnssl_doa at hidden 256, the bin count its
head needs, and ipdnet, ipdnet_offline and variable_ipdnet at hidden 32,
all with Adam: DDP raises at their second step if a parameter got no
gradient), dropout off, each rank on its half of a
2-scene global batch. Those steps are held against the port's single-process step on the global batch: the
world-mean loss of each step within 1e-6 relative, the first step's
averaged gradients within 1e-5 of the model's largest gradient magnitude
(float32 sums over ~1e4 positions split in two and in another order;
measured up to 1.5e-6, IPDnet2's encoder bias with one torch thread), and
the parameters after both steps within lr/100. Adam's step
lr·m/(√v + ε) turns the rounding of a gradient near ε into a change of
up to lr·Δg/(4ε), so the parameters are held to a fraction of one step's
reach (measured on this host: 2.8e-7 for FN-SSL, 1.1e-6 of its largest
parameter magnitude, and 7.8e-7 for IPDnet2). And against JAX's step on a
2-device CPU mesh (``make_mesh`` + ``shard_batch``): the loss within 1e-5
relative and the parameters within 2.1·lr, the port's train-parity
tolerances (Adam's first steps move a parameter by about lr·sign(g), so a
gradient within its rounding of 0 may step the other way).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import fnssl_tpu.models.spatialnet as js
from fnssl_tpu.models.fnssl import FNSSLConfig as JConfig
from fnssl_tpu.parallel import host_local_slice as jax_host_local_slice
from fnssl_tpu.parallel import make_mesh, replicate_params
from fnssl_tpu.parallel import shard_batch as jax_shard_batch
from fnssl_tpu.train import step as jstep
from fnssl_tpu.train import tasks as jtasks
from fnssl_tpu_torch.parallel import (
    broadcast_from_primary, coordination_barrier, data_parallel,
    host_local_slice, initialize, is_primary, shard_batch, shutdown,
    sync_global_devices, unwrap)
from fnssl_tpu_torch.train import step as S
from tests import torch_dp_worker as W
from tests.test_torch_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
LR = {"fnssl": 1e-3, "fnssl_doa": 1e-3, "ipdnet": 5e-4,
      "ipdnet_offline": 5e-4, "variable_ipdnet": 5e-4, "ipdnet2": 5e-4}


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("num_items", [0, 4, 7, 10, 13])
def test_host_local_slice_equals_jax_for_every_rank(num_items, shuffle):
    for size in range(1, 5):
        for rank in range(size):
            for epoch in (0, 3):
                kw = dict(seed=5, process_index=rank, process_count=size,
                          shuffle=shuffle)
                assert (host_local_slice(num_items, epoch, **kw)
                        == jax_host_local_slice(num_items, epoch, **kw))


def test_host_local_slice_defaults_to_one_rank_without_a_world():
    assert host_local_slice(9, 2, seed=4) == jax_host_local_slice(
        9, 2, seed=4, process_index=0, process_count=1)


def test_shard_batch_takes_the_mesh_rows_of_each_rank():
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    got = [shard_batch(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([g["a"] for g in got]),
                                  batch["a"])
    assert got[1]["b"].tolist() == [2, 3]
    # the rows of device r of JAX's batch sharding
    mesh = make_mesh(jax.devices()[:3])
    placed = jax_shard_batch({"a": batch["a"]}, mesh)
    for shard in placed["a"].addressable_shards:
        r = shard.device.id
        np.testing.assert_array_equal(np.asarray(shard.data), got[r]["a"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, 0, 4)


def test_helpers_are_identities_without_a_world():
    tree = {"x": torch.ones(2), "y": [np.zeros(3), 4]}
    assert broadcast_from_primary(tree) is tree
    assert is_primary()
    sync_global_devices()
    coordination_barrier("none", timeout_s=1)
    assert initialize(num_processes=1) is None
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_wraps_and_unwraps():
    assert initialize(use_mesh=True, platform="cpu") == torch.device("cpu")
    try:
        model = torch.nn.Linear(3, 2)
        wrapped = data_parallel(model)
        assert unwrap(wrapped) is model and unwrap(model) is model
        assert list(wrapped.state_dict()) == ["module.weight", "module.bias"]
        assert is_primary()
    finally:
        shutdown()
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' reports and arrays."""
    tmp = tmp_path_factory.mktemp("torch_dp")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dp_worker.py"),
         str(rank), str(WORLD), str(tmp / "store"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(WORLD)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    return ([json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)],
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)])


def test_rank_gating_broadcast_and_barriers(world):
    reports, _ = world
    assert [r["primary"] for r in reports] == [True, False]
    for r in reports:
        assert r["broadcast"] == [[7.0] * 3, [1, 1], [0.5]]
        assert r["fnssl_state_keys"][0].startswith("module.")
    idx = [i for r in reports for i, _ in r["sched"]]
    assert sorted(idx) == list(range(10))
    assert [[tuple(e) for e in r["sched"]] for r in reports] == [
        jax_host_local_slice(10, 0, seed=2, process_index=k,
                             process_count=WORLD) for k in range(WORLD)]


def test_ranks_hold_the_same_replica(world):
    _, arrays = world
    assert sorted(arrays[0]) == sorted(arrays[1])
    for k in arrays[0]:
        np.testing.assert_array_equal(arrays[0][k], arrays[1][k], err_msg=k)


def single_process(name):
    """(losses, the first step's gradients, parameters) of the same steps
    in one process on the global batch."""
    _, model, loss_fn, tx, batch = next(c for c in W.cases()
                                        if c[0] == name)
    state = S.init_train_state(model, tx)
    step = S.make_train_step(loss_fn, tx)
    losses = []
    for k in range(W.STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if k == 0:
            grads = {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}
    return losses, grads, {k: v.numpy()
                           for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", list(LR))
def test_dp_step_equals_the_single_process_step(world, name):
    _, arrays = world
    losses, grads, params = single_process(name)
    np.testing.assert_allclose(arrays[0][f"{name}/loss"], losses, rtol=1e-6,
                               atol=0)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    for k, want in grads.items():
        np.testing.assert_allclose(arrays[0][f"{name}/grad/{k}"], want,
                                   rtol=0, atol=1e-5 * scale, err_msg=k)
    start, moved = start_weights(name), 0.0
    for k, want in params.items():
        got = arrays[0][f"{name}/{k}"]
        np.testing.assert_allclose(got, want, rtol=0, atol=LR[name] / 100,
                                   err_msg=k)
        moved = max(moved, float(np.abs(got - start[k]).max()))
    assert moved > LR[name]                # the steps moved the weights


def start_weights(name):
    """The weights every rank starts from."""
    model = next(c for c in W.cases() if c[0] == name)[1]
    return {k: v.numpy() for k, v in model.state_dict().items()}


def jax_tree(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(v)
    return tree


@pytest.mark.parametrize("name", ["fnssl", "ipdnet2"])
def test_dp_step_matches_jax_on_a_two_device_mesh(world, name):
    _, arrays = world
    _, _, _, _, batch = next(c for c in W.cases() if c[0] == name)
    if name == "fnssl":
        task = jtasks.make_fnssl_task(JConfig(hidden_size=W.HIDDEN))
        tx = jstep.make_optimizer("adam", 1e-3, 0.8988, 1)
    else:
        task = jtasks.make_ipdnet2_task(js.SpatialNetConfig(**W.I2_SMALL),
                                        mic_location=W.MICS)
        tx = jstep.make_optimizer("adamw", 5e-4, 0.975, 1, grad_clip=5.0)
    step = jstep.make_train_step(task.loss_fn, tx, donate=False)
    mesh = make_mesh(jax.devices()[:WORLD])
    with mesh:
        state = replicate_params(
            jstep.init_train_state(jax_tree(start_weights(name)), tx), mesh)
        losses = []
        for _ in range(W.STEPS):
            state, loss = step(state, jax_shard_batch(batch, mesh), None)
            losses.append(float(jax.device_get(loss)))
        params = jax.tree.map(np.asarray, jax.device_get(state.params))
    np.testing.assert_allclose(arrays[0][f"{name}/loss"], losses, rtol=1e-5,
                               atol=0)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v

    walk(params, "")
    assert set(flat) == set(start_weights(name))
    for k, want in flat.items():
        np.testing.assert_allclose(arrays[0][f"{name}/{k}"], want, rtol=0,
                                   atol=2.1 * LR[name], err_msg=k)
