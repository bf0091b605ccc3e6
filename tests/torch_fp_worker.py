"""One rank of a 4-process gloo world of the port's frequency parallelism
(spawned by tests/test_torch_freq_parallel.py). Imports only
fnssl_tpu_torch.

It joins the world through a file store and runs every case on its
block of the same global inputs and weights, which the test writes to
IN.npz: SpatialNet's forward on a 2 x 2 mesh (Mamba and MHSA time
modules), the forward and the gradient of mean(out²) on a 1 x 4 mesh
(the pool of 8 straddles shards) and that gradient on 2 x 2, and one
IPDnet2 AdamW step (clip 5) on 2 x 2 with the first step's gradients.
Gradients are averaged over the world, as ``make_train_step(...,
mesh=mesh)`` does. It writes its outputs to ``OUT/rank<R>.npz`` and the
bytes its freq collectives moved to ``OUT/rank<R>.json``.

Usage: python torch_fp_worker.py RANK WORLD STORE_FILE IN_NPZ OUT_DIR
"""
import json
import os
import sys

import numpy as np
import torch

from fnssl_tpu_torch.models.spatialnet import SpatialNet, SpatialNetConfig
from fnssl_tpu_torch.parallel import (freq_sharded_input, initialize,
                                      make_mesh_2d, shard_batch, shutdown)
from fnssl_tpu_torch.parallel.distributed import all_reduce_sum
from fnssl_tpu_torch.parallel.freq import (TRAFFIC, average_gradients,
                                           reset_traffic)
from fnssl_tpu_torch.train import step as S
from fnssl_tpu_torch.train import tasks as TK

# tests/test_freq_parallel.py's CFG: 32 bins, so that a 2 x 2 mesh's shard
# holds one band after the compression (a halo wider than the shard) and
# a 1 x 4 mesh's pool of 8 straddles shards
CFG = dict(dim_input=4, dim_output=8, num_layers=2, num_freqs=32,
           dim_hidden=32, dim_squeeze=4, fre_compression_ratio=16)
MHSA = dict(CFG, attention="mhsa(251)")
# test_freq_sharded_ipdnet2_full_train_step's configuration
TRAIN = dict(dim_input=6, dim_output=8, num_layers=2, dim_squeeze=4,
             num_freqs=256, dim_hidden=16, conv_groups=8, d_state=4,
             mamba_conv=4)
MIC = np.array([[0.0, 0.0, 0.0], [0.03, 0.0, 0.0], [0.0, 0.03, 0.0]])
LR = 5e-4
# (case, config, weights key, input key, mesh shape, gradient)
NET_CASES = (("fwd_2x2", CFG, "net", "x", (2, 2), False),
             ("mhsa_2x2", MHSA, "mhsa", "x", (2, 2), False),
             ("net_1x4", CFG, "net", "x", (1, 4), True),
             ("grad_2x2", CFG, "net", "x", (2, 2), True))


def load(model, arrays, key):
    state = {k[len(key) + 1:]: torch.from_numpy(v) for k, v in arrays.items()
             if k.startswith(key + "/")}
    model.load_state_dict(state, strict=True)
    return model


def net_case(arrays, cfg, key, x, shape, grad):
    """This rank's output of the sharded forward (its data rows, whole
    along frequency) and, with ``grad``, every parameter's gradient of
    mean(out²) averaged over the world."""
    mesh = make_mesh_2d(*shape)
    model = load(SpatialNet(SpatialNetConfig(**cfg), device="cpu"), arrays,
                 key)
    xs = freq_sharded_input(mesh, torch.from_numpy(arrays[x]))
    out = model(xs, freq_mesh=mesh)
    res = {"out": out.detach().numpy()}
    if grad:
        (out ** 2).mean().backward()
        average_gradients(model.parameters())
        res.update({f"grad/{n}": p.grad.numpy()
                    for n, p in model.named_parameters()})
    return res


def train_case(arrays, size):
    """The world-mean loss of one AdamW step (clip 5) of the 2 x 2
    sharded task, the world-averaged gradients of its loss before the
    clip, and the parameters after the step."""
    mesh = make_mesh_2d(2, 2)
    task = TK.make_ipdnet2_task(SpatialNetConfig(**TRAIN), mic_location=MIC,
                                feats_sharding=mesh, device="cpu")
    batch = {k[6:]: v for k, v in arrays.items() if k.startswith("batch/")}
    local = shard_batch(batch, mesh=mesh)
    model = load(SpatialNet(task.cfg, device="cpu"), arrays, "train")
    task.loss_fn(model, local).backward()
    average_gradients(model.parameters())
    res = {f"grad/{n}": p.grad.numpy().copy()
           for n, p in model.named_parameters()}
    model = load(SpatialNet(task.cfg, device="cpu"), arrays, "train")
    tx = S.make_optimizer("adamw", LR, 0.975, 1, grad_clip=5.0)
    step = S.make_train_step(task.loss_fn, tx, mesh=mesh)
    _, loss = step(S.init_train_state(model, tx), local)
    res["loss"] = np.asarray(float(all_reduce_sum(loss[None])[0]) / size)
    res.update({f"param/{k}": v.numpy()
                for k, v in model.state_dict().items()})
    return res


def main():
    rank, size = int(sys.argv[1]), int(sys.argv[2])
    store, inputs, out = sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    initialize(f"file://{store}", size, rank, platform="cpu",
               timeout_s=300)
    arrays = dict(np.load(inputs))
    result, traffic = {}, {}
    for name, cfg, key, x, shape, grad in NET_CASES:
        reset_traffic()
        for k, v in net_case(arrays, cfg, key, x, shape, grad).items():
            result[f"{name}/{k}"] = v
        traffic[name] = dict(TRAFFIC)
    reset_traffic()
    for k, v in train_case(arrays, size).items():
        result[f"train_2x2/{k}"] = v
    traffic["train_2x2"] = dict(TRAFFIC)
    shutdown()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **result)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(traffic, f)


if __name__ == "__main__":
    main()
