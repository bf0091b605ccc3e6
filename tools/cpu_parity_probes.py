"""Two CPU measurements behind ROADMAP Queue 3 (JAX and the port on the
CPU; run from the repo root with JAX_PLATFORMS=cpu).

  python tools/cpu_parity_probes.py jax-pool
      JAX's own SlotBatchedStepper against JAX's dedicated streams on the
      4-slot schedule of tests/test_torch_time_serving.py: the max |diff|
      of each tick, for MHSA, retention and Mamba SpatialNets (JAX's pool
      restarts the state leaves that do not grow with nb).

  python tools/cpu_parity_probes.py d-state-grad [--attention mamba(24,4)]
      [--threads N] [--no-mkldnn] [--after-file]
      The gradient check of tests/test_torch_wide_train.py's IPDnet2 case
      under this process's settings: for encoder.weight and for the worst
      parameter, the max |port - JAX| beside the allowed 1e-4 x largest.
      Vary the BLAS code path with the environment (MKL_ENABLE_INSTRUCTIONS,
      ONEDNN_MAX_CPU_ISA, XLA_FLAGS=--xla_cpu_max_isa=...); --after-file
      first runs the file's earlier tests in this process, as one xdist
      worker does.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def jax_pool():
    import fnssl_tpu.models.spatialnet as js
    import tests.test_torch_time_serving as T
    from fnssl_tpu.runtime.slots import SlotBatchedStepper

    for att, rope in [("mhsa(6)", False), ("mhsa(6)", "ALiBi"),
                      ("ret(2)", False), ("ret(2)", True), ("mamba", False)]:
        cfg = js.SpatialNetConfig(**dict(T.SMALL, attention=att, rope=rope))
        params = js.init_spatialnet_params(jax.random.PRNGKey(3), cfg)

        def apply(p, x, state=None, return_state=False, cfg=cfg):
            return js.spatialnet_apply(p, x, cfg=cfg, state=state,
                                       return_state=return_state)

        pool = SlotBatchedStepper(
            apply, params, lambda nb, cfg=cfg: js.init_spatialnet_state(
                nb, cfg), 4)
        states, rng, errs = {}, np.random.default_rng(4), []
        for (ids, reset), streams in zip(T.TICKS, T.STREAM_OF):
            x = T.feats(int(rng.integers(1 << 30)), len(ids), T.CHUNK)
            got = np.asarray(pool.step_slots(np.asarray(ids, np.int32), x,
                                             np.asarray(reset)))
            err = 0.0
            for k, slot in enumerate(ids):
                name = streams[slot]
                st = states.get(name, js.init_spatialnet_state(1, cfg))
                want, states[name] = apply(params, jnp.asarray(x[k:k + 1]),
                                           state=st, return_state=True)
                err = max(err, float(np.abs(got[k:k + 1]
                                            - np.asarray(want)).max()))
            errs.append(err)
        print(f"{att} rope={rope}: max|diff| a tick "
              + " ".join(f"{e:.3g}" for e in errs), flush=True)


def d_state_grad(attention, threads, mkldnn, after_file):
    import fnssl_tpu.models.spatialnet as js
    import fnssl_tpu_torch.models.spatialnet as ts
    import tests.test_torch_wide_train as W
    from fnssl_tpu.train import tasks as jtasks
    from fnssl_tpu_torch.train import tasks as ttasks
    from fnssl_tpu_torch.train.convert import params_to_state_dict

    if threads:
        torch.set_num_threads(threads)
    torch.backends.mkldnn.enabled = mkldnn
    if after_file:
        W.test_fnssl_at_hidden_512_trains_as_jax()
        W.test_ipdnet2_at_other_d_state_trains_as_jax("mamba(32,4)")
    cfg = dict(W.SMALL, attention=attention)
    jt = jtasks.make_ipdnet2_task(js.SpatialNetConfig(**cfg),
                                  mic_location=W.MICS)
    tt = ttasks.make_ipdnet2_task(ts.SpatialNetConfig(**cfg),
                                  mic_location=W.MICS, device="cpu")
    model = ts.SpatialNet(ts.SpatialNetConfig(**cfg), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    params = W.jax_params(model)
    b = W.ipdnet2_batch(int(attention[6:8]))
    _, jgrads = jax.value_and_grad(jt.loss_fn)(params, b, None)
    tt.loss_fn(model, b).backward()
    want = params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    rows = {}
    for k, p in model.named_parameters():
        w = want[k].numpy()
        rows[k] = (float(np.abs(p.grad.numpy() - w).max()),
                   1e-4 * max(float(np.abs(w).max()), 1e-12))
    worst = max(rows, key=lambda k: rows[k][0] / rows[k][1])
    print(json.dumps({"threads": torch.get_num_threads(), "mkldnn": mkldnn,
                      "encoder.weight [err, allowed]": rows["encoder.weight"],
                      "worst": worst, "worst [err, allowed]": rows[worst]}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("jax-pool", "d-state-grad"))
    ap.add_argument("--attention", default="mamba(24,4)")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--no-mkldnn", action="store_true")
    ap.add_argument("--after-file", action="store_true")
    args = ap.parse_args()
    if args.probe == "jax-pool":
        jax_pool()
    else:
        d_state_grad(args.attention, args.threads, not args.no_mkldnn,
                     args.after_file)


if __name__ == "__main__":
    main()
