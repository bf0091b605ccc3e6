"""The Hopper LSTM kernel (kernels/csrc/lstm_fwd.cu) against its plain
version, on the card. A CUDA kernel has no CPU mode, so every test here is
marked ``cuda`` and skips where there is no CUDA device. The file imports
only torch and the port, so that it runs on a machine without JAX
(``--noconftest`` skips tests/conftest.py, which imports JAX):

  python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest
"""
import pytest
import torch

from fnssl_tpu_torch.kernels import lstm_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(256, 12, 128), (12, 256, 256),
                                   (7, 11, 64), (1, 11, 64), (2, 3, 32)])
def test_kernel_matches_plain_on_card(cuda, dtype, reverse, shape):
    """fp32: ys/hT/cT within 1e-4 (another order of the h@W_hh sum);
    bf16 xg: ys within 2e-2 (bf16 output rounding)."""
    t_steps, b, h = shape
    g = torch.Generator().manual_seed(0)
    tdt = getattr(torch, dtype)
    xg = torch.randn(t_steps, b, 4 * h, generator=g).to(cuda, tdt)
    w = (torch.randn(h, 4 * h, generator=g) / h ** 0.5).to(cuda, tdt)
    h0 = torch.randn(b, h, generator=g).to(cuda) * 0.5
    c0 = torch.randn(b, h, generator=g).to(cuda) * 0.5
    before = lstm_cuda.launches.value
    ys, h_t, c_t = lstm_cuda.lstm_fwd(xg, w, h0, c0, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.launches.value == before + 1
    rys, rh, rc = lstm_cuda.lstm_fwd_plain(xg, w, h0, c0, reverse=reverse)
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (ys.float() - rys.float()).abs().max().item() <= tol
    assert (h_t - rh).abs().max().item() <= max(tol / 2, 1e-4)
    assert (c_t - rc).abs().max().item() <= max(tol / 2, 1e-4)


@pytest.mark.cuda
def test_kernel_refuses_grad(cuda):
    xg = torch.zeros(2, 3, 128, device=cuda, requires_grad=True)
    w = torch.zeros(32, 128, device=cuda)
    s = torch.zeros(3, 32, device=cuda)
    with pytest.raises(RuntimeError, match="backward"):
        lstm_cuda.lstm_fwd(xg, w, s, s)
