#!/usr/bin/env python3
"""Write the best checkpoint of a JAX fit as the reference ``.tar`` that
the PyTorch port's ``cli serve`` loads.

  python tools/jax_ckpt_to_tar.py --log-dir D [--model fnssl] [--seed N]

``--model`` is one of fnssl, fnssl_doa, ipdnet, ipdnet_offline,
variable_ipdnet (whose ``cli fit`` checkpoints plain Adam) and ipdnet2
(AdamW with a global-norm clip of 5; the task's mic subset from
``--mic-ids``, 0,1,3,5,7 by default, as ``cli fit``).

fnssl_tpu's ``cli fit`` keeps orbax checkpoints under ``D/ckpt`` (the
top-k epochs by validation loss, and the last), and its ``serve``
restores the best of them. fnssl_tpu_torch's ``serve`` reads
``D/best_model.tar`` and cannot read orbax without JAX. This tool builds
the train state that ``cli fit`` checkpointed (the task's parameters
from ``--seed`` and the model's optimizer, as ``_restore_learner`` does), restores the best epoch by validation loss
into it (as ``serve`` does with ``best=True``), and writes its
parameters to
``D/best_model.tar`` with ``fnssl_tpu.train.convert.save_torch_tar``;
``epoch`` in the file is the restored epoch. Unlike a Learner, it writes
no logs into D. It imports JAX and fnssl_tpu, so it runs where the JAX
package does; the port does not.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", required=True,
                    help="the log dir of the JAX fit (checkpoints in "
                         "<log-dir>/ckpt); best_model.tar is written there")
    ap.add_argument("--model", default="fnssl",
                    choices=["fnssl", "fnssl_doa", "ipdnet", "ipdnet_offline",
                             "variable_ipdnet", "ipdnet2"])
    ap.add_argument("--mic-ids", default="0,1,3,5,7",
                    help="the RealMAN mic subset of an ipdnet2 fit")
    ap.add_argument("--seed", type=int, default=2,
                    help="seed of the template the checkpoint is restored "
                         "into, as for `cli fit`; the values come from the "
                         "checkpoint")
    args = ap.parse_args(argv)

    from fnssl_tpu.cli.main import _init_params, _make_task
    from fnssl_tpu.train.checkpoint import CheckpointManager
    from fnssl_tpu.train.convert import save_torch_tar
    from fnssl_tpu.train.step import (TrainState, init_train_state,
                                      make_optimizer)

    ckpt_dir = os.path.join(args.log_dir, "ckpt")
    if not os.path.isdir(ckpt_dir):
        raise SystemExit(f"jax_ckpt_to_tar: no checkpoint under {ckpt_dir}")
    task = _make_task(args.model, args)
    tx = (make_optimizer("adamw", grad_clip=5.0) if args.model == "ipdnet2"
          else make_optimizer("adam"))
    template = init_train_state(_init_params(args.model, task, args.seed),
                                tx)
    mgr = CheckpointManager(ckpt_dir)
    try:
        epoch = mgr.best_epoch()
        restored, _ = mgr.restore(template, epoch=epoch)
    finally:
        mgr.close()
    if restored is None:
        raise SystemExit(f"jax_ckpt_to_tar: no checkpoint under {ckpt_dir}")
    params = TrainState(*restored).params
    path = os.path.join(args.log_dir, "best_model.tar")
    save_torch_tar(path, params, epoch=int(epoch))
    print(f"wrote {path} (epoch {epoch})")
    return path


if __name__ == "__main__":
    main()
