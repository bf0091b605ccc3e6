"""One rank of a 2-process gloo world of the port (spawned by
tests/test_torch_parallel.py). Imports only fnssl_tpu_torch.

It joins the world through a file store, checks rank gating, the
broadcast and both barriers, records its default ``host_local_slice``
schedule, then takes two data-parallel train steps of every model the
CLI trains, dropout off, on its rows of a global batch that every rank
draws from the same seed: FN-SSL (hidden 32, Adam), fnssl_doa (hidden
256, the bin count its head needs; Adam), the three IPDnet tasks (hidden 32, Adam; the variable array at 3 mics) and a
small IPDnet2 (AdamW, clip 5). It writes its
world-mean losses and the parameters after the steps to
``OUT/rank<R>.npz`` and the rest to ``OUT/rank<R>.json``.

Usage: python torch_dp_worker.py RANK WORLD STORE_FILE OUT_DIR
"""
import json
import os
import sys

import numpy as np
import torch

from fnssl_tpu_torch.data.arrays import audiowu_high_array_geometry
from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
from fnssl_tpu_torch.models.ipdnet import (
    IPDnet, IPDnetConfig, VariableIPDnet, VariableIPDnetConfig)
from fnssl_tpu_torch.models.spatialnet import SpatialNet, SpatialNetConfig
from fnssl_tpu_torch.parallel import (
    broadcast_from_primary, coordination_barrier, data_parallel,
    host_local_slice, initialize, is_primary, shard_batch, shutdown,
    sync_global_devices, unwrap)
from fnssl_tpu_torch.parallel.distributed import all_reduce_sum
from fnssl_tpu_torch.train import step as S
from fnssl_tpu_torch.train import tasks as TK

HIDDEN = 32
I2_SMALL = dict(dim_input=6, dim_output=8, num_layers=2, dim_hidden=16)
MICS = audiowu_high_array_geometry()[[0, 1, 3]]
MICS_3 = np.array([[-0.06, 0.0, 0.0], [0.0, 0.0, 0.0], [0.06, 0.0, 0.0]])
STEPS = 2


def ipdnet2_batch(nb, seed, t_s=0.5):
    """nb scenes of 3-channel noise with 2 tracks (test_torch_ipdnet2_train's
    batch)."""
    rng = np.random.default_rng(seed)
    nsample, nt2 = int(t_s * 16000), int(t_s * 10)
    return {"mic_sig": rng.standard_normal((nb, nsample, 3)).astype(
                np.float32),
            "azi_deg": rng.integers(0, 360, (nb, nt2, 2)).astype(
                np.float32),
            "distance": rng.uniform(0.5, 3.0, (nb, nt2, 2)).astype(
                np.float32),
            "vad": (rng.uniform(0, 1, (nb, nt2, 2)) > 0.4).astype(
                np.float32),
            "mic_pos": (MICS[None] + rng.normal(0, 0.005, (nb, 3, 3))
                        ).astype(np.float32)}


def ipdnet_batch(nb, nch, seed, t_s=0.5):
    """nb scenes of nch-channel noise with 2 tracks and a soft VAD
    (test_torch_ipdnet_train's batch)."""
    rng = np.random.default_rng(seed)
    nsample = int(t_s * 16000)
    nt2 = ((nsample - 512) // 256 + 1) // 12
    return {"mic_sig": rng.standard_normal((nb, nsample, nch)).astype(
                np.float32),
            "doa": np.stack([rng.uniform(0, np.pi, (nb, nt2, 2)),
                             rng.uniform(-np.pi, np.pi, (nb, nt2, 2))],
                            axis=2).astype(np.float32),
            "vad": (rng.uniform(0, 1, (nb, nt2, 2)) > 0.4).astype(
                np.float32) * rng.uniform(0, 1, (nb, nt2, 2)).astype(
                np.float32)}


def cases():
    """(name, model, loss_fn, optimizer spec, global batch) of each DP
    step; every rank builds the same weights from seed 0."""
    gen = torch.Generator().manual_seed(0)
    cfg = FNSSLConfig(hidden_size=HIDDEN)
    yield ("fnssl", FNSSL(cfg, device="cpu", generator=gen),
           TK.make_fnssl_task(cfg, device="cpu").loss_fn,
           S.make_optimizer("adam", 1e-3, 0.8988, 1),
           TK.synthetic_fnssl_batch(nb=2, t_s=0.4, seed=1))
    task = TK.make_ipdnet2_task(SpatialNetConfig(**I2_SMALL),
                                mic_location=MICS, device="cpu")
    yield ("ipdnet2", SpatialNet(task.cfg, device="cpu", generator=gen),
           task.loss_fn,
           S.make_optimizer("adamw", 5e-4, 0.975, 1, grad_clip=5.0),
           ipdnet2_batch(2, seed=3))
    # fnssl_doa's head reads the 2·nf IPD features as 2·hidden, so its
    # hidden size is the bin count (256), as in the reference
    cfg = FNSSLConfig(is_doa=True)
    yield ("fnssl_doa", FNSSL(cfg, device="cpu", generator=gen),
           TK.make_fnssl_task(cfg, device="cpu").loss_fn,
           S.make_optimizer("adam", 1e-3, 0.8988, 1),
           TK.synthetic_fnssl_batch(nb=2, t_s=0.4, seed=4))
    for name, make, online in (
            ("ipdnet", TK.make_ipdnet_task, True),
            ("ipdnet_offline", TK.make_ipdnet_offline_task, False)):
        cfg = IPDnetConfig(hidden_size=HIDDEN, is_online=online)
        yield (name, IPDnet(cfg, device="cpu", generator=gen),
               make(cfg, device="cpu").loss_fn,
               S.make_optimizer("adam", 5e-4, 0.975, 1),
               ipdnet_batch(2, 2, seed=5))
    cfg = VariableIPDnetConfig(hidden_size=HIDDEN)
    yield ("variable_ipdnet", VariableIPDnet(cfg, device="cpu",
                                             generator=gen),
           TK.make_variable_ipdnet_task(cfg, mic_location=MICS_3,
                                        device="cpu").loss_fn,
           S.make_optimizer("adam", 5e-4, 0.975, 1),
           ipdnet_batch(2, 3, seed=6))


def main():
    rank, size = int(sys.argv[1]), int(sys.argv[2])
    store, out = sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    initialize(f"file://{store}", size, rank, platform="cpu",
               timeout_s=300)
    report = {"primary": is_primary()}
    got = broadcast_from_primary(
        {"t": torch.full((3,), float(rank + 7)),
         "a": np.full((2,), rank + 1, np.int64), "n": [rank + 0.5]})
    report["broadcast"] = [got["t"].tolist(), got["a"].tolist(), got["n"]]
    sync_global_devices()
    coordination_barrier("worker", timeout_s=120)
    report["sched"] = host_local_slice(10, epoch=0, seed=2)
    arrays = {}
    for name, model, loss_fn, tx, batch in cases():
        state = S.init_train_state(data_parallel(model), tx)
        step = S.make_train_step(loss_fn, tx)
        local = shard_batch(batch)
        losses = []
        for k in range(STEPS):
            state, loss = step(state, local)
            losses.append(float(all_reduce_sum(loss[None])[0] / size))
            if k == 0:      # the first step's gradients and parameters
                for n, p in unwrap(state.module).named_parameters():
                    arrays[f"{name}/grad/{n}"] = p.grad.numpy().copy()
                    arrays[f"{name}/step1/{n}"] = p.detach().numpy().copy()
        arrays[f"{name}/loss"] = np.asarray(losses)
        for k, v in unwrap(state.module).state_dict().items():
            arrays[f"{name}/{k}"] = v.numpy()
        report[f"{name}_state_keys"] = sorted(state.module.state_dict())[:1]
    coordination_barrier("done", timeout_s=120)
    shutdown()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
