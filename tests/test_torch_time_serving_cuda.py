"""The slot pool of IPDnet2 with its MHSA and retention time modules on the
card: each tier captured as one CUDA graph (the streaming steps build
their masks and rotary tables on the device, so the capture holds no
host copy), its replays against the same tier run eagerly.

A CUDA graph has no CPU mode, so every test here is marked ``cuda`` and
skips where there is no CUDA device; the file imports only torch and the
port, so that it runs on the card's machine without JAX:

  python -m pytest tests/test_torch_time_serving_cuda.py -m cuda --noconftest

Tolerance: a graph replay against the eager tier 1e-6, as
tests/test_torch_serving_cuda.py (the same ops on the same inputs; cuBLAS
may split a product otherwise under capture).
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def stepper(cuda, attention, rope, seed=0):
    from fnssl_tpu_torch.models.spatialnet import SpatialNet, \
        SpatialNetConfig
    from fnssl_tpu_torch.runtime.export import _resolve
    from fnssl_tpu_torch.runtime.slots import SlotBatchedStepper

    model = SpatialNet(SpatialNetConfig(attention=attention, rope=rope),
                       device=cuda,
                       generator=torch.Generator().manual_seed(seed)).eval()
    apply_fn, init_state = _resolve("ipdnet2", model)
    return SlotBatchedStepper(apply_fn, model, init_state, slots=16)


@pytest.mark.cuda
@pytest.mark.parametrize("attention,rope", [("mhsa(251)", "ALiBi"),
                                            ("ret(2)", True)])
@pytest.mark.parametrize("active", [1, 3])
def test_time_module_tiers_capture_and_replay_as_eager(cuda, attention,
                                                       rope, active):
    """Tier 1 (one stream) and tier 4 (three streams and a padded row) of
    a 16-slot pool at full width: three ticks (a join, then two carried
    chunks, so the positions differ from the fresh state's) through the
    graph against the same tier function run eagerly on the card from the
    same state; outputs and the whole pool state."""
    graph = stepper(cuda, attention, rope)
    eager = stepper(cuda, attention, rope)
    rng = np.random.default_rng(active)
    ids = np.asarray([5, 0, 9][:active])
    tier = 1 if active == 1 else 4
    pad = [i for i in range(16) if i not in ids][:tier - active]
    full = np.concatenate([ids, pad]).astype(np.int64)
    assert graph._tier(tier, (tier, 10, 256, 5)) is not None
    for tick in range(3):
        feats = rng.standard_normal((active, 10, 256, 5)).astype(np.float32)
        reset = np.full(active, tick == 0)
        got = graph.step_slots(ids, feats, reset)
        padded = np.concatenate([feats, np.zeros(
            (tier - active, 10, 256, 5), np.float32)])
        want = eager._run_tier(
            tier, torch.as_tensor(padded, device=cuda),
            torch.as_tensor(full, device=cuda),
            torch.as_tensor(np.concatenate([reset, np.zeros(
                tier - active, bool)]), device=cuda),
            torch.arange(tier, device=cuda) < active)
        torch.testing.assert_close(got, want[:active].cpu(), rtol=1e-6,
                                   atol=1e-6)
    for g, e in zip(graph._state, eager._state):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-6)
    assert graph.replays[tier] == 3
