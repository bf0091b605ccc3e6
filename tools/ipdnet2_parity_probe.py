#!/usr/bin/env python3
"""Why the IPDnet2 parity step (chip_smoke.py phase 19) takes the card's
PReLU gates: where a train step's gradients are sensitive.

  python3 tools/ipdnet2_parity_probe.py [--seed N]

On the CPU, one fp32 step of ``make_ipdnet2_task`` at nb=2 × 4 s
(chip_smoke.py's bench batch and weights): the output of each module
named below is multiplied by (1 + 1e-7·noise) in turn, and the change of
``layers.0.full.weight``'s gradient is printed relative to its largest
value. A perturbation of a LayerNorm's output moves the grouped convs'
outputs within rounding of 0 across the PReLU's kink (slope 1 → 0.25);
a multiplicative perturbation of the conv output itself keeps its sign.

Where a CUDA device is present, it then compares the card's step with
the CPU's without the gates (every gradient's max |card − CPU| over its
largest value), once with the scan kernels K3/K4 and once with their
plain versions on the card, to show what the kernels add.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

PROBED = ("encoder", "layers.0.fconv1.0", "layers.0.fconv1.1",
          "layers.0.norm_full", "layers.0.full", "layers.0.fconv2.0",
          "layers.0.fconv2.1", "layers.1.norm_mhsa", "decoder")


def grads(seed, device, perturb=None):
    """Every parameter's gradient of one loss on `device` (float64 on the
    host); `perturb` names a module whose output is scaled by 1 + 1e-7
    noise."""
    import chip_smoke as C
    from fnssl_tpu_torch.train import tasks as TK

    state, _, batch = C.ipdnet2_setup(seed, C.I2_PARITY_NB, device)
    model = state.module.train()
    handle = None
    if perturb is not None:
        gen = torch.Generator().manual_seed(1)

        def hook(mod, args, out):
            noise = torch.randn(out.shape, generator=gen).to(out.device)
            return out * (1 + 1e-7 * noise)

        handle = dict(model.named_modules())[perturb].register_forward_hook(
            hook)
    TK.make_ipdnet2_task(device=device).loss_fn(model, batch).backward()
    if handle is not None:
        handle.remove()
    return {n: p.grad.detach().cpu().double()
            for n, p in model.named_parameters()}


def rel(a, b, name):
    return ((a[name] - b[name]).abs().max() / b[name].abs().max()).item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)
    cpu = torch.device("cpu")
    base = grads(args.seed, cpu)
    print("CPU, layers.0.full.weight's gradient change over its largest "
          "value, for a 1e-7 relative perturbation of:")
    for name in PROBED:
        moved = rel(grads(args.seed, cpu, name), base,
                    "layers.0.full.weight")
        print(f"  {name:22s} {moved:.2e}")
    if not torch.cuda.is_available():
        return
    import fnssl_tpu_torch.models.mamba as M
    from fnssl_tpu_torch.kernels import ssm_cuda as S

    card = torch.device("cuda", 0)
    for label in ("K3/K4", "plain scans"):
        if label == "plain scans":
            M.selective_scan_fwd = S.selective_scan_fwd_plain
            M.selective_scan_bwd = S.selective_scan_bwd_plain
        got = grads(args.seed, card)
        worst = sorted(((rel(got, base, n), n) for n in base),
                       reverse=True)[:3]
        print(f"card vs CPU without the gates, {label} on the card: "
              + ", ".join(f"{n} {v:.2e}" for v, n in worst))


if __name__ == "__main__":
    main()
