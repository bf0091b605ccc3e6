"""Command-line entry point of the port (mirrors ``fnssl_tpu/cli/main.py``).

Only ``serve --model fnssl`` is ported:

  python -m fnssl_tpu_torch.cli serve --model fnssl --log-dir runs/fnssl \
      --port 7316

serves FN-SSL over TCP (runtime/server.py's wire protocol) with the model
on the first CUDA device, or on the CPU with ``--platform cpu``. Weights
come from ``<log-dir>/best_model.tar`` (the reference ``.tar`` format)
when it exists, else from ``--seed``. A JAX fit leaves orbax checkpoints
instead; ``tools/jax_ckpt_to_tar.py --log-dir <log-dir>`` writes its
best epoch as that file. Every other subcommand and model exits with
"not ported yet".
"""
from __future__ import annotations

import argparse
import json
import os

import torch

MODELS = ["fnssl", "fnssl_doa", "ipdnet", "ipdnet_offline",
          "variable_ipdnet", "ipdnet2", "ipd_baseline"]
NOT_PORTED = ["simulate", "fit", "test", "predict", "stream", "export",
              "locata"]


def build_parser():
    ap = argparse.ArgumentParser("fnssl_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="TCP streaming-localization service: "
                       "raw PCM in, per-block DOA/VAD JSON out (one "
                       "independent model stream per connection)")
    p.add_argument("--model", default="fnssl", choices=MODELS)
    p.add_argument("--log-dir", default="runs/default",
                   help="weights from <log-dir>/best_model.tar if present")
    p.add_argument("--seed", type=int, default=2,
                   help="seed of the fresh weights when there is no "
                        "checkpoint")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7316)
    p.add_argument("--nch", type=int, default=None,
                   help="channels per connection (default 2 for fnssl)")
    p.add_argument("--platform", default="default",
                   choices=["default", "cpu"],
                   help="default = the first CUDA device (an error where "
                        "there is none); cpu = run the model on the CPU")
    for name in NOT_PORTED:
        sub.add_parser(name, help="not ported yet")
    return ap


def load_fnssl(log_dir: str, seed: int, device):
    """FN-SSL (``FNSSLConfig()``) in eval mode on ``device``: weights from
    ``<log_dir>/best_model.tar`` when it exists, else fresh from ``seed``
    with a warning."""
    from fnssl_tpu_torch.models.fnssl import FNSSL, FNSSLConfig
    from fnssl_tpu_torch.train.convert import load_torch_tar

    model = FNSSL(FNSSLConfig(), device=device,
                  generator=torch.Generator().manual_seed(seed))
    ckpt = os.path.join(log_dir, "best_model.tar")
    if os.path.exists(ckpt):
        state, _ = load_torch_tar(ckpt)
        model.load_state_dict(state, strict=True)
    else:
        print("warning: no checkpoint found; using fresh params")
    return model.eval()


def build_server(args):
    """The LocalizationServer that ``serve`` runs, and its announcement.

    Placement: the model runs on the card (or the CPU with ``--platform
    cpu``); the per-chunk front-end and the DOA decode run on the CPU, so
    the card sees one model step per chunk.
    """
    from fnssl_tpu_torch.eval.pred_doa import PredDOA
    from fnssl_tpu_torch.runtime.server import LocalizationServer
    from fnssl_tpu_torch.runtime.streaming import (
        StreamingLocalizer, make_fnssl_stream_step)
    from fnssl_tpu_torch.utils.device import resolve_device

    if args.model != "fnssl":
        raise SystemExit(f"serve --model {args.model}: not ported yet")
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    model = load_fnssl(args.log_dir, args.seed, device)

    nch = args.nch or 2
    host = torch.device("cpu")
    decoder = PredDOA(device=host)

    def decode(chunk):
        return decoder.predgt2doa(chunk)[0]

    def session_factory():
        loc = StreamingLocalizer(make_fnssl_stream_step(model), nch=nch,
                                 ch_mode="MM", frames_per_step=12,
                                 device=host)
        return loc, decode

    server = LocalizationServer(session_factory, host=args.host,
                                port=args.port)
    info = {"serving": args.model, "host": args.host, "port": server.port,
            "nch": nch, "model_device": str(device),
            "frontend_device": str(host), "decode_device": str(host)}
    return server, info


def cmd_serve(args):
    server, info = build_server(args)
    print(json.dumps(info), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def main(argv=None):
    ap = build_parser()
    args, rest = ap.parse_known_args(argv)
    if args.cmd != "serve":
        raise SystemExit(f"{args.cmd}: not ported yet")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    cmd_serve(args)


if __name__ == "__main__":
    main()
