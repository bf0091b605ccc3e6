"""IPDnet2's MHSA and retention time modules on the card: a SpatialNet
with ``attention="mhsa(251)"`` (plain and ALiBi) and ``"ret(2)"`` (rope
off and on) at the published width (8 layers, hidden 96, 256 bins, 5
mics), its forward and chunk-by-chunk stream on cuda:0 against the same
weights on the CPU, and no launch of the port's kernels on these paths
(MHSA and retention are plain matrix products).

Marked ``cuda``: skips where there is no CUDA device. The file imports
only torch and the port, so that it runs on the card's machine:

  python -m pytest tests/test_torch_spatialnet_time_cuda.py -m cuda \\
      --noconftest

Tolerances: the card against the CPU 1e-3 (the serve phases' bound:
float32 products summed in another order over 8 layers).
"""
import pytest
import torch

from fnssl_tpu_torch.kernels import lstm_cuda, ssm_cuda
from fnssl_tpu_torch.models.spatialnet import (SpatialNet, SpatialNetConfig,
                                               init_spatialnet_state)

KINDS = [("mhsa(251)", False), ("mhsa(251)", "ALiBi"), ("ret(2)", False),
         ("ret(2)", True)]
COUNTERS = (lstm_cuda.launches, lstm_cuda.launches_wide,
            lstm_cuda.launches_bwd_wave, lstm_cuda.launches_bwd_cluster,
            ssm_cuda.launches_ssm_fwd, ssm_cuda.launches_ssm_bwd)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def models(attention, rope, device):
    cfg = SpatialNetConfig(attention=attention, rope=rope)
    host = SpatialNet(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0)).eval()
    card = SpatialNet(cfg, device=device).eval()
    card.load_state_dict(host.state_dict())
    return host, card


@pytest.mark.cuda
@pytest.mark.parametrize("attention,rope", KINDS)
def test_forward_and_stream_on_the_card_match_the_cpu(cuda, attention,
                                                      rope):
    host, card = models(attention, rope, cuda)
    x = torch.randn(1, 10, 256, 40, generator=torch.Generator()
                    .manual_seed(1))
    for c in COUNTERS:
        c.reset()
    with torch.no_grad():
        want = host(x)
        got = card(x.to(cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
        hs = init_spatialnet_state(1, host.cfg, "cpu")
        cs = init_spatialnet_state(1, card.cfg, cuda)
        for lo in range(0, 40, 5):
            hw, hs = host(x[..., lo:lo + 5], state=hs, return_state=True)
            cw, cs = card(x[..., lo:lo + 5].to(cuda), state=cs,
                          return_state=True)
            torch.testing.assert_close(cw.cpu(), hw, rtol=0, atol=1e-3)
    assert [c.value for c in COUNTERS] == [0] * len(COUNTERS)
