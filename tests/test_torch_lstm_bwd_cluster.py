"""K2's cluster kernel (kernels/csrc/lstm_bwd_cluster.cu) on the CPU: its
plan, the sizing it shares with the source, and the wrappers' routing.

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py,
marked ``cuda``); here ``bwd_cluster_fits`` must accept exactly the plans
whose threads and shared memory fit one CTA, ``bwd_cluster_plan`` must
follow its rule, and CPU tensors must take the plain version without
moving any launch counter.
"""
import re

import pytest
import torch

from fnssl_tpu_torch.kernels import cuda_build, lstm_cuda

SMEM_LIMIT = 232_448          # bytes of shared memory one CTA may use
BARRIERS = 16                 # of them, the two mbarriers


def fits(hidden, itemsize, n, bt, ks, upt):
    """The source's sizing, written out: the W_hh column slice, two dgates
    buffers and the KS partial sums; <= 512 threads of UPT (1 or 2) units
    each; a k-slice of 8 or 16 units; tiles of 8 rows; at most 2 (row,
    unit) pairs a thread."""
    units = hidden // n
    smem = (4 * hidden * units * itemsize + 2 * bt * 4 * hidden * 4
            + ks * bt * units * 4)
    threads = ks * units / upt
    return (threads <= 512 and threads == int(threads)
            and smem + BARRIERS <= SMEM_LIMIT and hidden // ks in (8, 16)
            and hidden % ks == 0 and upt in (1, 2) and bt == 8
            and bt * units <= 2 * threads)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hidden", range(32, 257, 32))
def test_bwd_cluster_plan_accepts_exactly_the_plans_that_fit(hidden,
                                                             itemsize):
    accepted = 0
    for n in (1, 2, 4, 8):
        for bt in (8, 16):
            for ks in (hidden // 32, hidden // 16, hidden // 8,
                       hidden // 4):
                for upt in (1, 2, 4, 8):
                    plan = (n, bt, ks, upt)
                    want = fits(hidden, itemsize, *plan)
                    assert lstm_cuda.bwd_cluster_fits(hidden, itemsize,
                                                      *plan) == want, plan
                    accepted += want
    assert accepted >= 1
    default = lstm_cuda.bwd_cluster_plan(hidden, itemsize)
    assert fits(hidden, itemsize, *default)
    # a cluster of 1 only with two units a thread and two CTAs an SM
    assert default[0] >= 2 or (default[3] == 2 and lstm_cuda._ctas_per_sm(
        lstm_cuda.bwd_cluster_smem(hidden, itemsize, *default[:3])) >= 2)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_bwd_cluster_default_plan_at_the_training_shapes(itemsize):
    """The default at FN-SSL's full-band (H 128) and narrow-band (H 256)
    LSTMs: two units a thread, the smallest cluster of at least 2 that
    fits, and the k-split that puts the most CTAs on an SM (the one with
    the more threads on a tie); at IPDnet's H 64 a cluster of 1, two CTAs
    an SM (three in bfloat16); the worked example of 212,992 B (N=8, Bt=8,
    KS=H/16)."""
    want = {4: ((2, 8, 16, 2), (8, 8, 32, 2)),
            2: ((2, 8, 8, 2), (4, 8, 16, 2))}[itemsize]
    assert lstm_cuda.bwd_cluster_plan(128, itemsize) == want[0]
    assert lstm_cuda.bwd_cluster_plan(256, itemsize) == want[1]
    assert lstm_cuda.bwd_cluster_plan(64, itemsize) == (1, 8, 8, 2)
    assert lstm_cuda._ctas_per_sm(lstm_cuda.bwd_cluster_smem(
        64, itemsize, 1, 8, 8)) == {4: 2, 2: 3}[itemsize]
    # H=32 has too few k-slices for 2 units a thread
    assert lstm_cuda.bwd_cluster_plan(32, itemsize) == (2, 8, 4, 1)
    assert lstm_cuda.bwd_cluster_smem(256, 4, 8, 8, 16) == 212_992
    assert not lstm_cuda.bwd_cluster_fits(256, 4, 8, 16, 16, 1)
    assert not lstm_cuda.bwd_cluster_fits(256, 2, 8, 16, 16, 1)  # Bt=16
    assert lstm_cuda.bwd_cluster_fits(256, 2, 8, 8, 16, 1)


def test_bwd_cluster_plan_counts_ctas_an_sm():
    """The k-split is chosen by how many CTAs share an SM's 228 KB (1 KB
    of it reserved a CTA): at H=128, N=2, KS=8 fits two CTAs an SM in
    bfloat16 and KS=16 one; in float32 both fit one, and KS=16 wins."""
    smem = lstm_cuda.bwd_cluster_smem
    assert lstm_cuda._ctas_per_sm(smem(128, 2, 2, 8, 8)) == 2
    assert lstm_cuda._ctas_per_sm(smem(128, 2, 2, 8, 16)) == 1
    assert lstm_cuda._ctas_per_sm(smem(128, 4, 2, 8, 8)) == 1
    assert lstm_cuda._ctas_per_sm(smem(128, 4, 2, 8, 16)) == 1
    assert lstm_cuda._ctas_per_sm(lstm_cuda.SMEM_BYTES) == 1
    assert lstm_cuda.SM_SMEM_BYTES == 228 * 1024


def test_bwd_cluster_plan_refusals():
    for hidden in (16, 48, 288, 512):
        with pytest.raises(ValueError, match="multiple of 32"):
            lstm_cuda.bwd_cluster_plan(hidden, 4)


def test_the_source_sizes_a_cta_as_the_plan_does():
    """smem_bytes and the limits in the source carry the same formula and
    numbers as bwd_cluster_smem / bwd_cluster_fits."""
    text = (cuda_build.CSRC / "lstm_bwd_cluster.cu").read_text()
    assert 'extern "C" int lstm_bwd_cluster(' in text
    assert "lstm_pallas.py:" in text and "_lstm_backward" in text
    assert "cudaLaunchAttributeClusterDimension" in text
    assert "cudaOccupancyMaxActiveClusters" in text
    body = re.search(r"size_t smem_bytes\([^)]*\) \{(.*?)\n\}", text,
                     re.S).group(1)
    assert "ks) * tile * units * sizeof(float)" in body
    assert "2) * tile * 4 * hidden * sizeof(float)" in body
    assert "4) * hidden * units * itemsize" in body
    assert "kMaxSmem = 232448" in text and "kBarrierSmem = 16" in text
    assert "kMaxThreads = 512" in text and "kMaxPairs = 2" in text
    assert f"kTile = {lstm_cuda.BWD_TILE}" in text
    assert lstm_cuda.SMEM_BYTES == SMEM_LIMIT - BARRIERS
    assert (cuda_build.library_path("lstm_bwd_cluster").parent
            == cuda_build.BUILD_DIR)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    gen = torch.Generator().manual_seed(0)
    t, b, h = 4, 3, 32
    g = torch.randn(2, t, b, 4 * h, generator=gen)
    w = torch.randn(2, 4 * h, h, generator=gen) / h ** 0.5
    c0, dh_t, dc_t = (torch.randn(2, b, h, generator=gen) for _ in range(3))
    dys = torch.randn(2, t, b, h, generator=gen)
    counters = (lstm_cuda.launches, lstm_cuda.launches_wide,
                lstm_cuda.launches_bwd_wave, lstm_cuda.launches_bwd_cluster)
    before = [c.value for c in counters]
    got = lstm_cuda.lstm_bwd_bidir(g.clone(), w, c0, dys, dh_t, dc_t,
                                   plan=(8, 8, 4, 1))
    want = lstm_cuda.lstm_bwd_bidir_plain(g.clone(), w, c0, dys, dh_t, dc_t)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    got = lstm_cuda.lstm_bwd(g[1].clone(), w[1], c0[1], dys[1], dh_t[1],
                             dc_t[1], reverse=True)
    want = lstm_cuda.lstm_bwd_plain(g[1].clone(), w[1], c0[1], dys[1],
                                    dh_t[1], dc_t[1], reverse=True)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert [c.value for c in counters] == before
