"""The port's frequency parallelism (fnssl_tpu_torch.parallel's
make_mesh_2d, freq_sharded_input and parallel/freq.py's collectives,
``SpatialNet(freq_mesh=...)``, ``make_ipdnet2_task(feats_sharding=...)``
and ``make_train_step(..., mesh=...)``) against fnssl_tpu on the CPU.

One 4-process gloo world (tests/torch_fp_worker.py, a file store, one
torch thread a rank) runs every case on the same seeded numpy inputs and
JAX-initialised weights, which this process runs through fnssl_tpu
unsharded and, for the forward and gradient cases, on JAX's own
``make_mesh_2d`` over the host devices, as tests/test_freq_parallel.py
does:

  * the forward on a 2 x 2 mesh at that file's CFG (32 bins: after the
    compression a shard holds one band, so the grouped convs' halo of 2
    reaches past the neighbour or to the global edge), with Mamba and
    with MHSA time modules, within JAX's 2e-5;
  * the forward and the gradient of mean(out²) on a 1 x 4 mesh (the pool
    of 8 straddles shards: the rest runs replicated, JAX's 1 x 8 case)
    and that gradient on 2 x 2, within JAX's 5e-5;
  * the complete IPDnet2 AdamW step (clip 5) on 2 x 2 at JAX's
    test_freq_sharded_ipdnet2_full_train_step configuration: the loss
    within 1e-5, the first step's gradients (before the clip) within
    JAX's gradient tolerance (5e-5 + 5e-5 relative; the port's plain
    task reads up to 2.2e-6 from JAX's gradients here, 2.2e-5 of their
    largest, in the encoder's weight), the parameters within JAX's
    5e-5 / 5e-6 where JAX's gradient is at least 1e-6 and within the
    port's train-parity 2.1·lr elsewhere: AdamW's first step moves a
    parameter by about lr·g/(|g| + 1e-8), so a gradient within its
    rounding of 0 may step the other way (the port's plain task lands
    2.07e-4 from JAX on an encoder weight whose JAX gradient is -9.2e-9).
    Against the port's single process the loss is held within 1e-6
    relative, the gradients within 1e-5 of their largest magnitude and
    every parameter within 5e-5 / 5e-6. AdamW is almost blind to a
    constant factor of the gradient, so the gradients are held
    themselves.

In this process: a world of one equals the plain task bit for bit, with
and without a process group; the mesh refuses a world of another size;
the halo's plan and JAX's input blocks are checked for every rank.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnssl_tpu.models.spatialnet as js
from fnssl_tpu.parallel import freq_sharded_input as jax_freq_sharded_input
from fnssl_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from fnssl_tpu.train import step as jstep
from fnssl_tpu.train import tasks as jtasks
from fnssl_tpu_torch.models.spatialnet import SpatialNet, SpatialNetConfig
from fnssl_tpu_torch.parallel import (Mesh2D, freq_sharded_input,
                                      initialize, make_mesh_2d, shutdown)
from fnssl_tpu_torch.parallel.freq import _halo_plan
from fnssl_tpu_torch.train import step as S
from fnssl_tpu_torch.train import tasks as TK
from fnssl_tpu_torch.train.convert import nested_to_flat
from tests import torch_fp_worker as W
from tests.test_torch_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
NB = 2
JCFG = js.SpatialNetConfig(**W.CFG)
JMHSA = js.SpatialNetConfig(**W.MHSA)
JTRAIN = js.SpatialNetConfig(**W.TRAIN)


def train_batch():
    """test_freq_sharded_ipdnet2_full_train_step's batch."""
    rng = np.random.default_rng(0)
    nb, ns = NB, 2
    return {
        "mic_sig": rng.standard_normal((nb, 8000, 3)).astype(np.float32),
        "azi_deg": rng.uniform(0, 180, (nb, 5, ns)).astype(np.float32),
        "distance": np.full((nb, 5, ns), 1.5, np.float32),
        "vad": np.ones((nb, 5, ns), np.float32),
        "mic_pos": np.tile(W.MIC[None], (nb, 1, 1)).astype(np.float32)}


@pytest.fixture(scope="module")
def inputs():
    """The JAX weights of each configuration, the network input and the
    train batch."""
    params = {"net": js.init_spatialnet_params(jax.random.PRNGKey(0), JCFG),
              "mhsa": js.init_spatialnet_params(jax.random.PRNGKey(1),
                                                JMHSA),
              "train": js.init_spatialnet_params(jax.random.PRNGKey(3),
                                                 JTRAIN)}
    x = np.random.default_rng(0).standard_normal(
        (NB, JCFG.dim_input, JCFG.num_freqs, 10)).astype(np.float32)
    return params, x, train_batch()


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    """The 4-rank world, started: (its processes, their output dir). JAX's
    references are computed while it runs (``refs`` before ``world``)."""
    params, x, batch = inputs
    tmp = tmp_path_factory.mktemp("torch_fp")
    arrays = {"x": x, **{f"batch/{k}": v for k, v in batch.items()}}
    for key, tree in params.items():
        arrays.update({f"{key}/{k}": v for k, v in nested_to_flat(
            jax.tree.map(np.asarray, tree)).items()})
    np.savez(tmp / "in.npz", **arrays)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_fp_worker.py"),
         str(rank), str(WORLD), str(tmp / "store"), str(tmp / "in.npz"),
         str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(WORLD)]
    try:
        yield procs, tmp
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def world(launched):
    """Every rank's outputs and freq traffic."""
    procs, tmp = launched
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)])


def rows(shape, rank):
    """The global batch rows of ``rank`` on an (n_data, n_freq) mesh."""
    n_data, n_freq = shape
    d = rank // n_freq
    return slice(d * NB // n_data, (d + 1) * NB // n_data)


def jax_sharded(shape, fn, *args):
    """``fn(*args)`` with args[-1] frequency-sharded on JAX's own mesh."""
    mesh = jax_make_mesh_2d(*shape)
    xs = jax_freq_sharded_input(mesh, args[-1])
    with mesh:
        return fn(*args[:-1], xs)


def flat(tree):
    return nested_to_flat(jax.tree.map(np.asarray, tree))


def case_of(name):
    return next(c for c in W.NET_CASES if c[0] == name)


FORWARD_CASES = ("fwd_2x2", "mhsa_2x2", "net_1x4")
GRADIENT_CASES = ("net_1x4", "grad_2x2")


def jax_train(params, batch):
    """(loss, gradients of the loss, parameters after one AdamW step) of
    JAX's unsharded task (tests/test_freq_parallel.py holds its 2-D mesh
    to it)."""
    task = jtasks.make_ipdnet2_task(cfg=JTRAIN, mic_location=W.MIC)
    tx = jstep.make_optimizer("adamw", W.LR, 0.975, 1, grad_clip=5.0)
    step = jstep.make_train_step(task.loss_fn, tx, donate=False)
    grads = jax.grad(task.loss_fn)(params, batch, None)
    state, loss = step(jstep.init_train_state(params, tx), batch, None)
    return float(loss), flat(grads), flat(state.params)


@pytest.fixture(scope="module")
def refs(launched, inputs):
    """fnssl_tpu's results, computed while the world runs: each forward
    case unsharded and on JAX's mesh, each gradient case's gradient of
    mean(out²) likewise, and the train step (``jax_train``)."""
    params, x, batch = inputs
    out = {"forward": {}, "gradient": {}}
    for case in FORWARD_CASES:
        _, cfg, key, _, shape, _ = case_of(case)
        jcfg = js.SpatialNetConfig(**cfg)

        def apply(p, xx, jcfg=jcfg):
            return js.spatialnet_apply(p, xx, cfg=jcfg)

        out["forward"][case] = (
            np.asarray(apply(params[key], jnp.asarray(x))),
            np.asarray(jax_sharded(shape, apply, params[key], x)))

    def loss(p, xx):
        return jnp.mean(js.spatialnet_apply(p, xx, cfg=JCFG) ** 2)

    for case in GRADIENT_CASES:
        _, _, key, _, shape, _ = case_of(case)
        out["gradient"][case] = (
            flat(jax.grad(loss)(params[key], jnp.asarray(x))),
            flat(jax_sharded(shape, jax.grad(loss), params[key], x)))
    out["train"] = jax_train(params["train"], batch)
    return out


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_sharded_forward_matches_jax(refs, world, case):
    shape = case_of(case)[4]
    ref, sharded = refs["forward"][case]
    np.testing.assert_allclose(sharded, ref, rtol=2e-5, atol=2e-5)
    outs, _ = world
    for rank in range(WORLD):
        got = outs[rank][f"{case}/out"]
        np.testing.assert_allclose(got, ref[rows(shape, rank)], rtol=2e-5,
                                   atol=2e-5, err_msg=f"rank {rank}")


@pytest.mark.parametrize("case", GRADIENT_CASES)
def test_sharded_gradient_matches_jax(refs, world, case):
    ref, sharded = refs["gradient"][case]
    outs, _ = world
    for name, want in ref.items():
        np.testing.assert_allclose(sharded[name], want, rtol=5e-5, atol=5e-5)
        for rank in range(WORLD):
            np.testing.assert_allclose(
                outs[rank][f"{case}/grad/{name}"], want, rtol=5e-5,
                atol=5e-5, err_msg=f"{name} rank {rank}")


def test_ipdnet2_train_step_matches_jax(refs, world):
    outs, _ = world
    loss, grads, after = refs["train"]
    for rank in range(WORLD):
        got = outs[rank]
        np.testing.assert_allclose(got["train_2x2/loss"], loss, rtol=1e-5,
                                   atol=0)
        for name, want in grads.items():
            np.testing.assert_allclose(
                got[f"train_2x2/grad/{name}"], want, rtol=5e-5, atol=5e-5,
                err_msg=f"{name} rank {rank}")
        for name, want in after.items():
            have = got[f"train_2x2/param/{name}"]
            np.testing.assert_allclose(have, want, rtol=0, atol=2.1 * W.LR,
                                       err_msg=f"{name} rank {rank}")
            firm = np.abs(grads[name]) >= 1e-6
            np.testing.assert_allclose(have[firm], want[firm], rtol=5e-5,
                                       atol=5e-6,
                                       err_msg=f"{name} rank {rank}")


def test_ipdnet2_train_step_equals_the_single_process_step(world, inputs):
    """The sharded step against the port's plain task on the whole batch
    in this process: the loss within 1e-6 relative, the first step's
    gradients within 1e-5 of their largest magnitude, the parameters
    within JAX's 5e-5 / 5e-6."""
    params, _, batch = inputs
    task = TK.make_ipdnet2_task(SpatialNetConfig(**W.TRAIN),
                                mic_location=W.MIC, device="cpu")
    state = {k: torch.tensor(v) for k, v in flat(params["train"]).items()}
    model = SpatialNet(task.cfg, device="cpu")
    model.load_state_dict(state)
    task.loss_fn(model, batch).backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    model = SpatialNet(task.cfg, device="cpu")
    model.load_state_dict(state)
    tx = S.make_optimizer("adamw", W.LR, 0.975, 1, grad_clip=5.0)
    _, loss = S.make_train_step(task.loss_fn, tx)(
        S.init_train_state(model, tx), batch)
    scale = max(float(np.abs(g).max()) for g in grads.values())
    outs, _ = world
    for rank in range(WORLD):
        got = outs[rank]
        np.testing.assert_allclose(got["train_2x2/loss"], float(loss),
                                   rtol=1e-6, atol=0)
        for name, want in grads.items():
            np.testing.assert_allclose(
                got[f"train_2x2/grad/{name}"], want, rtol=0,
                atol=1e-5 * scale, err_msg=f"{name} rank {rank}")
        for name, want in model.state_dict().items():
            np.testing.assert_allclose(
                got[f"train_2x2/param/{name}"], want.numpy(), rtol=5e-5,
                atol=5e-6, err_msg=f"{name} rank {rank}")


def test_ranks_of_a_freq_group_agree(world):
    """Every freq rank of a data index returns the same whole output, and
    every rank holds the same averaged gradients and parameters."""
    outs, traffic = world
    for case, _, _, _, (n_data, n_freq), _ in W.NET_CASES:
        for rank in range(WORLD):
            first = rank // n_freq * n_freq
            np.testing.assert_array_equal(outs[rank][f"{case}/out"],
                                          outs[first][f"{case}/out"])
    for k, v in outs[0].items():
        if "/grad/" in k or "/param/" in k or k.endswith("/loss"):
            for rank in range(1, WORLD):
                np.testing.assert_array_equal(outs[rank][k], v, err_msg=k)
    # every rank moved the same bytes; the 1 x 4 case gathers sooner
    for t in traffic:
        assert t == traffic[0]
        assert all(v["bytes"] > 0 and v["calls"] > 0 for v in t.values())


@pytest.mark.parametrize("size", [2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("left,right", [(2, 2), (1, 3), (0, 1)])
def test_halo_plan_pads_each_shard_with_its_neighbours(size, n, left, right):
    """Each shard's halo, built from every shard's edges by the plan,
    equals the global axis zero-padded and cut at the shard."""
    axis = np.arange(1, size * n + 1, dtype=np.float64)
    padded = np.concatenate([np.zeros(left), axis, np.zeros(right)])
    for index in range(size):
        zl, li, ri, zr, head, tail = _halo_plan(index, size, n, left, right)
        edges = np.concatenate([np.concatenate(
            [s[:head], s[n - tail:]]) for s in axis.reshape(size, n)])
        got = np.concatenate([np.zeros(zl), edges[li],
                              axis[index * n:(index + 1) * n], edges[ri],
                              np.zeros(zr)])
        np.testing.assert_array_equal(
            got, padded[index * n:index * n + left + n + right])


def test_freq_sharded_input_is_the_block_jax_places(inputs):
    _, x, _ = inputs
    x = np.concatenate([x, x + 1])                  # 4 rows
    mesh = jax_make_mesh_2d(2, 2)
    placed = jax_freq_sharded_input(mesh, x)
    devices = list(np.asarray(mesh.devices).reshape(-1))
    for shard in placed.addressable_shards:
        d, f = divmod(devices.index(shard.device), 2)
        got = freq_sharded_input(
            Mesh2D(("data", "freq"), 2, 2, d, f), torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not split"):
        freq_sharded_input(Mesh2D(("data", "freq"), 3, 1, 0, 0),
                           torch.from_numpy(x))


def one_step(batch, mesh=None):
    """(loss, first gradients, parameters) of one AdamW step of the small
    IPDnet2 task, sharded over ``mesh`` or plain."""
    task = TK.make_ipdnet2_task(SpatialNetConfig(**W.TRAIN),
                                mic_location=W.MIC, feats_sharding=mesh,
                                device="cpu")
    model = SpatialNet(task.cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    tx = S.make_optimizer("adamw", W.LR, 0.975, 1, grad_clip=5.0)
    step = S.make_train_step(task.loss_fn, tx, mesh=mesh)
    state, loss = step(S.init_train_state(model, tx), batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss), grads, {k: v.clone() for k, v in
                                state.module.state_dict().items()}


def test_a_world_of_one_equals_the_plain_task():
    """A 1 x 1 mesh, without a process group and in a gloo world of one
    (where the gradients pass an all-reduce), gives the plain step's
    loss, gradients and parameters bit for bit."""
    batch = train_batch()
    loss, grads, params = one_step(batch)
    results = [one_step(batch, make_mesh_2d(1, 1))]
    initialize(use_mesh=True, platform="cpu")
    try:
        mesh = make_mesh_2d(1, 1)
        assert mesh.freq_group is not None and mesh.data_group is not None
        results.append(one_step(batch, mesh))
    finally:
        shutdown()
    for got_loss, got_grads, got_params in results:
        assert got_loss == loss
        for k, g in grads.items():
            assert torch.equal(got_grads[k], g), k
        for k, p in params.items():
            assert torch.equal(got_params[k], p), k


def test_the_mesh_refuses_a_world_of_another_size():
    with pytest.raises(ValueError, match="needs a world of 4"):
        make_mesh_2d(2, 2)
    initialize(use_mesh=True, platform="cpu")
    try:
        with pytest.raises(ValueError, match="needs a world of 2"):
            make_mesh_2d(1, 2)
        assert make_mesh_2d(1, 1).size == 1
    finally:
        shutdown()
    with pytest.raises(TypeError, match="2-D mesh"):
        TK.make_ipdnet2_task(feats_sharding="freq", device="cpu")


def test_a_sharded_forward_refuses_state_and_wrong_widths():
    model = SpatialNet(SpatialNetConfig(**W.CFG), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    mesh = Mesh2D(("data", "freq"), 1, 2, 0, 0)
    x = torch.zeros(1, 4, 16, 10)
    with pytest.raises(ValueError, match="streaming state"):
        model(x, return_state=True, freq_mesh=mesh)
    with pytest.raises(ValueError, match="do not make"):
        model(torch.zeros(1, 4, 8, 10), freq_mesh=mesh)
