"""The LSTM kernels at IPDnet's shapes, and IPDnet's train step and
streaming chunk on the card: K1 (kernels/csrc/lstm_cluster.cu) and K2
(kernels/csrc/lstm_bwd_cluster.cu) against their plain versions at H=64
(the full-band BiLSTM, and the offline narrow-band BiLSTM) and H=128 (the
online narrow-band LSTM) with IPDnet's training B, and the exact launch
counts of an IPDnet train step and of a serve chunk step.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where there is no CUDA device; the file imports only torch and the
port, so that it runs on the card's machine without JAX:

  python -m pytest tests/test_torch_ipdnet_cuda.py -m cuda --noconftest

Tolerances as tests/test_torch_kernels_cuda.py: K1 fp32 ys/hT/cT within
1e-4, bf16 ys within 2e-2 and hT/cT within 1e-4; K2 dgates/dh0/dc0 within
1e-4.
"""
import pytest
import torch

from fnssl_tpu_torch.kernels import lstm_cuda

COUNTERS = (lstm_cuda.launches, lstm_cuda.launches_wide,
            lstm_cuda.launches_bwd_wave, lstm_cuda.launches_bwd_cluster)
BWD_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def randn(gen, *shape, scale=1.0, dtype=torch.float32, device):
    return (torch.randn(*shape, generator=gen, device=device) * scale).to(
        dtype)


# (T, B, H, ndir): IPDnet training at nb=16 x 4.5 s (280 frames, 256
# bins): full-band BiLSTM (B = 16*280), online narrow-band LSTM (B =
# 16*256), offline narrow-band BiLSTM; and the serve chunk step
SHAPES = [(256, 16 * 280, 64, 2), (280, 16 * 256, 128, 1),
          (280, 16 * 256, 64, 2), (256, 12, 64, 2), (12, 256, 128, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_at_ipdnet_shapes(cuda, shape, dtype):
    t_steps, b, h, ndir = shape
    gen = torch.Generator(device=cuda).manual_seed(h + b)
    args = (randn(gen, ndir, t_steps, b, 4 * h, dtype=dtype, device=cuda),
            randn(gen, ndir, h, 4 * h, scale=h ** -0.5, dtype=dtype,
                  device=cuda),
            randn(gen, ndir, b, h, scale=0.5, device=cuda),
            randn(gen, ndir, b, h, scale=0.5, device=cuda))
    # one launch of the kernel fwd_route gives the shape (lstm_wave.cu at
    # the narrow band in bf16, lstm_cluster.cu elsewhere)
    counter = {"cluster": lstm_cuda.launches,
               "wave": lstm_cuda.launches_wave}[lstm_cuda.fwd_route(
                   t_steps, b, h, ndir, dtype.itemsize)]
    before = counter.value
    if ndir == 2:
        got = lstm_cuda.lstm_fwd_bidir(*args)
        want = lstm_cuda.lstm_fwd_bidir_plain(*args)
    else:
        one = tuple(a[0] for a in args)
        got = lstm_cuda.lstm_fwd(*one)
        want = lstm_cuda.lstm_fwd_plain(*one)
    assert counter.value == before + 1
    torch.cuda.synchronize()
    tol = {"ys": 1e-4 if dtype == torch.float32 else 2e-2, "hT": 1e-4,
           "cT": 1e-4}
    for name, g, w in zip(("ys", "hT", "cT"), got, want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol[name], (shape, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_k2_at_ipdnet_training_shapes(cuda, shape, dtype):
    t_steps, b, h, ndir = shape
    gen = torch.Generator(device=cuda).manual_seed(h + b + 1)
    args = (randn(gen, ndir, t_steps, b, 4 * h, device=cuda),
            randn(gen, ndir, 4 * h, h, scale=h ** -0.5, dtype=dtype,
                  device=cuda),
            randn(gen, ndir, b, h, scale=0.5, device=cuda),
            randn(gen, ndir, t_steps, b, h, dtype=dtype, device=cuda),
            randn(gen, ndir, b, h, scale=0.5, device=cuda),
            randn(gen, ndir, b, h, scale=0.5, device=cuda))
    if ndir == 1:
        args = tuple(a[0] for a in args)
    fn, plain = ((lstm_cuda.lstm_bwd_bidir, lstm_cuda.lstm_bwd_bidir_plain)
                 if ndir == 2 else (lstm_cuda.lstm_bwd,
                                    lstm_cuda.lstm_bwd_plain))
    before = lstm_cuda.launches_bwd_cluster.value
    got = fn(args[0].clone(), *args[1:])
    assert lstm_cuda.launches_bwd_cluster.value == before + 1
    want = plain(args[0].clone(), *args[1:])
    torch.cuda.synchronize()
    for name, g, w in zip(("dgates", "dh0", "dc0"), got, want):
        err = (g - w).abs().max().item()
        assert err <= BWD_TOL, (shape, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["ipdnet", "ipdnet_offline",
                                   "variable_ipdnet"])
def test_ipdnet_train_step_launch_counts(cuda, which):
    """One train step of each IPDnet task (published widths, nb 1 x 0.5
    s) launches K1 and K2 (lstm_bwd_cluster.cu) 4 times each: per block
    one fused full-band BiLSTM and one narrow-band LSTM or BiLSTM."""
    import numpy as np

    from fnssl_tpu_torch.models.ipdnet import IPDnet, VariableIPDnet
    from fnssl_tpu_torch.train import step, tasks

    make = {"ipdnet": tasks.make_ipdnet_task,
            "ipdnet_offline": tasks.make_ipdnet_offline_task,
            "variable_ipdnet": tasks.make_variable_ipdnet_task}[which]
    task = make(device=cuda)
    cls = VariableIPDnet if which == "variable_ipdnet" else IPDnet
    model = cls(task.cfg, device=cuda,
                generator=torch.Generator().manual_seed(0))
    tx = step.make_optimizer("adam", 5e-4, 0.975, 1)
    state = step.init_train_state(model, tx)
    train = step.make_train_step(task.loss_fn, tx)
    rng = np.random.default_rng(1)
    batch = {"mic_sig": rng.standard_normal((1, 8000, 2)).astype(np.float32),
             "doa": rng.uniform(0, np.pi, (1, 2, 2, 2)).astype(np.float32),
             "vad": np.ones((1, 2, 2), np.float32)}
    before = [c.value for c in COUNTERS]
    state, loss = train(state, batch,
                        torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert [c.value - b for c, b in zip(COUNTERS, before)] == [4, 0, 0, 4]
    assert state.step == 1 and torch.isfinite(loss)


@pytest.mark.cuda
def test_ipdnet_stream_chunk_launches_four_k1(cuda):
    """A serve chunk step (12 frames) of the published IPDnet launches K1
    4 times and no backward, and equals the CPU's plain versions."""
    from fnssl_tpu_torch.models.ipdnet import IPDnet
    from fnssl_tpu_torch.runtime.streaming import make_ipdnet_stream_step

    feats = torch.randn(1, 4, 256, 12, generator=torch.Generator()
                        .manual_seed(2))
    outs = []
    for device in (cuda, torch.device("cpu")):
        model = IPDnet(device=device,
                       generator=torch.Generator().manual_seed(3)).eval()
        step = make_ipdnet_stream_step(model)
        before = [c.value for c in COUNTERS]
        outs.append([step(feats).cpu() for _ in range(2)])
        launched = [c.value - b for c, b in zip(COUNTERS, before)]
        assert launched == ([8, 0, 0, 0] if device.type == "cuda"
                            else [0] * 4)
    for g, w in zip(*outs):
        assert (g - w).abs().max().item() <= 1e-3
