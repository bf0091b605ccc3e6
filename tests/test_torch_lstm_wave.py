"""K1's routes and lstm_wave.cu's plans, on the CPU (no card, no nvcc).

``fwd_route`` chooses K1's kernel by shape; ``wave_plan`` sizes
lstm_wave.cu's tiles. Both are plain arithmetic, checked here at every
shape ``chip_smoke.py`` runs K1 at; what the kernel computes is checked on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py phases 3 and 5).
"""
import pytest
import torch

from fnssl_tpu_torch.kernels import lstm_cuda as L

# (what, T, B, H, ndir, itemsize, route): K1's calls on the paths chip_smoke
# drives, FNSSLConfig() (full band H 128 both directions, narrow band H 256)
# and IPDnetConfig() (H 64 and 128)
PATH_SHAPES = [
    ("serve full band", 256, 12, 128, 2, 4, "cluster"),
    ("serve narrow band", 12, 256, 256, 1, 4, "cluster"),
    ("one-shot narrow band", 298, 256, 256, 1, 4, "cluster"),
    ("train full band", 256, 16 * 298, 128, 2, 4, "cluster"),
    ("train narrow band", 298, 16 * 256, 256, 1, 4, "wave"),
    ("train narrow band bf16", 298, 16 * 256, 256, 1, 2, "wave"),
    ("parity step narrow band", 298, 2 * 256, 256, 1, 4, "cluster"),
    ("eval batch narrow band", 298, 8 * 256, 256, 1, 4, "wave"),
    ("DP rank narrow band", 298, 8 * 256, 256, 1, 4, "wave"),
    ("DP rank full band", 256, 8 * 298, 128, 2, 4, "cluster"),
    ("16-slot tick full band", 256, 16 * 12, 128, 2, 4, "cluster"),
    ("16-slot tick narrow band", 12, 16 * 256, 256, 1, 4, "wave"),
    ("1-slot tick narrow band", 12, 256, 256, 1, 4, "cluster"),
    ("LOCATA full band", 256, 1242, 128, 2, 4, "cluster"),
    ("LOCATA narrow band", 1242, 256, 256, 1, 4, "cluster"),
    ("IPDnet train full band", 256, 16 * 280, 64, 2, 4, "cluster"),
    ("IPDnet train narrow band", 280, 16 * 256, 128, 1, 4, "cluster"),
    ("IPDnet 16-slot narrow band", 12, 16 * 256, 128, 1, 4, "cluster"),
    ("variable IPDnet narrow band", 280, 8 * 6 * 256, 128, 1, 4, "cluster"),
    ("H above 256", 5, 13, 512, 1, 4, "v2"),
]


@pytest.mark.parametrize("what,t,b,h,ndir,itemsize,route", PATH_SHAPES,
                         ids=[s[0] for s in PATH_SHAPES])
def test_fwd_route_on_every_path(what, t, b, h, ndir, itemsize, route):
    assert L.fwd_route(t, b, h, ndir, itemsize) == route


@pytest.mark.parametrize("key", sorted(L.WAVE_MIN_ROWS))
def test_fwd_route_threshold(key):
    """lstm_wave.cu from WAVE_MIN_ROWS rows (B x directions) up, at every
    T; lstm_cluster.cu below."""
    hidden, itemsize = key
    least = L.WAVE_MIN_ROWS[key]
    for t in (1, 12, 298):
        assert L.fwd_route(t, least - 1, hidden, 1, itemsize) == "cluster"
        assert L.fwd_route(t, least, hidden, 1, itemsize) == "wave"
        assert L.fwd_route(t, -(-least // 2), hidden, 2, itemsize) == "wave"
        assert L.fwd_route(t, least // 2 - 1, hidden, 2,
                           itemsize) == "cluster"


def test_fwd_route_keeps_unmeasured_widths_on_the_cluster_kernel():
    """No threshold at H 32, 64, 128: the sweep covered H 128 and 256 and
    the rule takes only what it measured (PERF.md)."""
    assert {h for h, _ in L.WAVE_MIN_ROWS} == {256}
    for h in (32, 64, 128):
        assert L.fwd_route(298, 1 << 16, h, 2, 4) == "cluster"


def test_wave_smem_and_occupancy_arithmetic():
    """The source's sizing: h (H x (tile + 4)) and c (tile x H) float32 and
    one step's xg (tile x 4H); CTAs an SM from the registers' budget and
    the 228 KB of shared memory less 1 KB a CTA."""
    assert L.wave_tile(256, 32) == 32 and L.wave_tile(128, 32) == 64
    assert L.wave_tile(64, 8) == 32 and L.wave_tile(32, 16) == 128
    assert L.wave_smem(256, 4, 32) == 256 * 36 * 4 + 32 * 256 * 4 \
        + 32 * 1024 * 4 == 200_704
    assert L.wave_smem(256, 2, 32) == 200_704 - 32 * 1024 * 2
    assert L.wave_ctas_per_sm(256, 4, 32) == 1       # 128 accumulators
    assert L.wave_ctas_per_sm(256, 4, 16) == 2       # 64
    assert L.wave_ctas_per_sm(256, 4, 8) == 3        # 32
    # every width's tile of 32 rows a thread holds 192-196 KiB: 1 CTA an SM
    for h in (32, 64, 128, 256):
        assert L.wave_fits(h, 4, 32)
        assert 192 * 1024 < L.wave_smem(h, 4, L.wave_tile(h, 32)) \
            <= L.SMEM_BYTES


@pytest.mark.parametrize("hidden,itemsize,rows", [
    (96, 4, 32),            # H must divide 256 (the row groups of a CTA)
    (288, 4, 32),           # H above 256
    (256, 4, 24),           # rows the source is not built for
    (16, 4, 8),             # H not a multiple of 32
])
def test_wave_fits_refuses(hidden, itemsize, rows):
    assert not L.wave_fits(hidden, itemsize, rows)


def test_wave_plan_refuses_a_width_it_does_not_take():
    with pytest.raises(ValueError, match="no plan fits"):
        L.wave_plan(96, 4, 4096)


@pytest.mark.parametrize("batch,ndir,rows", [
    (4096, 1, 32),          # 128 CTAs: one wave, 32 rows an SM
    (4100, 1, 32),          # 129 CTAs of 32 rows: still one wave
    (2048, 1, 16),          # 128 CTAs of 16 rows beat 64 of 32
    (1024, 1, 8),           # 128 CTAs of 8 rows
    (4768, 2, 16),          # 596 tiles of 16, 2 an SM: 80 rows on the
])                          # busiest SM (96 at 32, 80 at 8: a tie)
def test_wave_plan_fills_the_sms(batch, ndir, rows):
    """At H 256 in float32 the plan puts the fewest rows on the busiest SM,
    the larger tile on a tie."""
    assert L.wave_plan(256, 4, batch, ndir) == rows


def test_cpu_tensors_take_the_plain_version_whatever_the_route():
    gen = torch.Generator().manual_seed(0)
    t, b, h = 5, 7, 32
    xg = torch.randn(2, t, b, 4 * h, generator=gen)
    w = torch.randn(2, h, 4 * h, generator=gen) / h ** 0.5
    h0, c0 = (torch.randn(2, b, h, generator=gen) * 0.5 for _ in range(2))
    counters = (L.launches, L.launches_wave, L.launches_v2)
    before = [c.value for c in counters]
    for route, plan in ((None, None), ("wave", 32), ("wave", None),
                        ("cluster", None), ("v2", None)):
        got = L.lstm_fwd_bidir(xg, w, h0, c0, route=route, plan=plan)
        for x, y in zip(got, L.lstm_fwd_bidir_plain(xg, w, h0, c0)):
            assert torch.equal(x, y)
        got = L.lstm_fwd(xg[1], w[1], h0[1], c0[1], reverse=True,
                         route=route, plan=plan)
        want = L.lstm_fwd_plain(xg[1], w[1], h0[1], c0[1], reverse=True)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert [c.value for c in counters] == before
