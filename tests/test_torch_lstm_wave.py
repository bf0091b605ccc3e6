"""K1's routes and lstm_wave.cu's and lstm_wide.cu's plans, on the CPU (no
card, no nvcc).

``fwd_route`` chooses K1's kernel by shape; ``wave_plan`` sizes
lstm_wave.cu's tiles and ``wide_plan`` lstm_wide.cu's (H above 256). They
are plain arithmetic, checked here at every
shape ``chip_smoke.py`` runs K1 at; what the kernel computes is checked on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py phases 3 and 5).
Here ``lstm_fwd_bidir_plain``, which the wrappers run for CPU tensors and
the card's kernels are held against, is held against JAX's
``lstm_fused_scan`` at a ragged tile edge.

Tolerance: rtol 2e-4 / atol 2e-5, as tests/test_torch_lstm_bwd_wave.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.kernels.lstm_pallas import lstm_fused_scan

from fnssl_tpu_torch.kernels import cuda_build
from fnssl_tpu_torch.kernels import lstm_cuda as L

# (what, T, B, H, ndir, itemsize, route): K1's calls on the paths chip_smoke
# drives, FNSSLConfig() (full band H 128 both directions, narrow band H 256),
# FNSSLConfig(hidden_size=512) (full band H 256 both directions, narrow band
# H 512) and IPDnetConfig() (H 64 and 128)
PATH_SHAPES = [
    ("serve full band", 256, 12, 128, 2, 4, "cluster"),
    ("serve narrow band", 12, 256, 256, 1, 4, "cluster"),
    ("one-shot narrow band", 298, 256, 256, 1, 4, "cluster"),
    ("train full band", 256, 16 * 298, 128, 2, 4, "wave"),
    ("train full band bf16", 256, 16 * 298, 128, 2, 2, "wave"),
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
    ("IPDnet train narrow band bf16", 280, 16 * 256, 128, 1, 2, "wave"),
    ("IPDnet 16-slot narrow band", 12, 16 * 256, 128, 1, 4, "cluster"),
    ("variable IPDnet narrow band", 280, 8 * 6 * 256, 128, 1, 4, "wave"),
    ("H above 256", 5, 13, 512, 1, 4, "wide"),
    ("hidden 512 train narrow band", 298, 16 * 256, 512, 1, 4, "wide"),
    ("hidden 512 train narrow band bf16", 298, 16 * 256, 512, 1, 2, "wide"),
    ("hidden 512 train full band", 256, 16 * 298, 256, 2, 4, "wave"),
    ("hidden 512 parity step narrow band", 124, 256, 512, 1, 4, "wide"),
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
    """No threshold at H 32 and 64: the sweep covered H 128 and 256 and
    the rule takes only what it measured (PERF.md)."""
    assert {h for h, _ in L.WAVE_MIN_ROWS} == {128, 256}
    for h in (32, 64):
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
    counters = (L.launches, L.launches_wave, L.launches_wide)
    before = [c.value for c in counters]
    for route, plan in ((None, None), ("wave", 32), ("wave", None),
                        ("cluster", None), ("wide", 16)):
        got = L.lstm_fwd_bidir(xg, w, h0, c0, route=route, plan=plan)
        for x, y in zip(got, L.lstm_fwd_bidir_plain(xg, w, h0, c0)):
            assert torch.equal(x, y)
        got = L.lstm_fwd(xg[1], w[1], h0[1], c0[1], reverse=True,
                         route=route, plan=plan)
        want = L.lstm_fwd_plain(xg[1], w[1], h0[1], c0[1], reverse=True)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert [c.value for c in counters] == before


@pytest.mark.parametrize("itemsize", [4, 2])
def test_wave_plan_spreads_the_full_band_at_h128(itemsize):
    """FN-SSL's full band in training (B 4768, both directions: 9536 rows,
    72.2 an SM if spread evenly) takes the H = 128 tile of 37 rows, 2 CTAs
    an SM: 258 CTAs in one wave, 74 rows on the busiest SM, where the
    256-thread tiles put 80 to 128."""
    rows = L.wave_plan(128, itemsize, 4768, 2)
    tile = L.wave_tile(128, rows)
    per_sm = L.wave_ctas_per_sm(128, itemsize, rows)
    assert (rows, tile, per_sm) == (37, 37, 2)
    assert L._busiest(tile, -(-4768 // tile) * 2, per_sm) == 74 <= 76
    for r in L.WAVE_ROWS:
        t = L.wave_tile(128, r)
        assert L._busiest(t, -(-4768 // t) * 2,
                          L.wave_ctas_per_sm(128, itemsize, r)) >= 80


def test_wave128_tiles_fit_the_source():
    """The H = 128 tile's sizing as the source builds it: 128 threads, 37
    rows, two h buffers (128 x (R rounded up to 4, + 4)) and c (R x 128)
    float32 in shared memory, whatever xg's dtype; 2 CTAs an SM
    (__launch_bounds__(128, 2): 4R accumulators a thread within its 256
    registers); only at H = 128."""
    src = (cuda_build.CSRC / "lstm_wave.cu").read_text()
    assert f"kThreads128 = {L.WAVE128_THREADS};" in src
    assert f"kRows128 = {L.WAVE128_ROWS[0]};" in src
    assert "__launch_bounds__(kThreads128, 2)" in src
    assert "(rows + 3) / 4 * 4 + kPad" in src
    assert ("(2 * static_cast<size_t>(128) * pitch128(rows) +\n"
            "          static_cast<size_t>(rows) * 128) * 4") in src
    assert L.WAVE128_ROWS == (37,)
    rows = 37
    assert L.wave_fits(128, 4, rows) and L.wave_fits(128, 2, rows)
    assert L.wave128_smem(rows) == (2 * 128 * 44 + rows * 128) * 4 == 64_000
    for itemsize in (4, 2):
        assert L.wave_ctas_per_sm(128, itemsize, rows) == 2
    assert 2 * (L.wave128_smem(rows) + L.CTA_RESERVED_SMEM) \
        <= L.SM_SMEM_BYTES
    assert 4 * rows < 65536 // (L.WAVE128_THREADS * 2)
    assert not L.wave_fits(256, 4, rows) and not L.wave_fits(64, 4, rows)
    assert not L.wave_fits(128, 4, 24)


@pytest.mark.parametrize("hidden", [32, 128, 256])
def test_plain_bidir_forward_at_a_ragged_tile_edge_matches_jax(hidden):
    """lstm_fwd_bidir_plain at B = 38 (one row past the H = 128 tile of 37
    rows), T = 7, against JAX's ``lstm_fused_scan`` forward and reversed on
    the same numpy-seeded weights: ys, hT and cT of both directions."""
    rng = np.random.default_rng(hidden)
    b, t, i, h = 38, 7, 16, hidden
    f32 = np.float32
    x = rng.standard_normal((b, t, i)).astype(f32)
    w_ih, w_hh = ((rng.standard_normal((2, 4 * h, n)) * n ** -0.5)
                  .astype(f32) for n in (i, h))
    bias = (rng.standard_normal((2, 4 * h)) * 0.1).astype(f32)
    h0, c0 = ((rng.standard_normal((2, b, h)) * 0.5).astype(f32)
              for _ in range(2))
    xg = np.stack([np.swapaxes(x @ w_ih[d].T + bias[d], 0, 1)
                   for d in range(2)])                      # (2, T, B, 4H)
    got = L.lstm_fwd_bidir_plain(
        torch.as_tensor(xg), torch.as_tensor(np.swapaxes(w_hh, 1, 2).copy()),
        torch.as_tensor(h0), torch.as_tensor(c0))
    for d in range(2):
        ys, h_t, c_t = (np.asarray(a) for a in lstm_fused_scan(
            *(jnp.asarray(a) for a in (x, w_ih[d], w_hh[d], bias[d], h0[d],
                                       c0[d])), bool(d)))
        for g, want in ((got[0][d].transpose(0, 1), ys), (got[1][d], h_t),
                        (got[2][d], c_t)):
            np.testing.assert_allclose(g.numpy(), want, rtol=2e-4,
                                       atol=2e-5)


# lstm_wide.cu, K1 above H = 256: every multiple of 32 from 288 to 1024
WIDE_WIDTHS = list(range(288, 1025, 32))


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("hidden", WIDE_WIDTHS)
def test_wide_fits_plan_and_occupancy_at_every_width(hidden, itemsize):
    """At every width above 256 fwd_route gives lstm_wide.cu in both
    dtypes, at every B; the tiles that fit hold their two h buffers and c
    within a CTA's shared memory (32 rows up to H = 544, 16 to 1024); the
    plan is one of them and its CTAs fit an SM's registers and shared
    memory together."""
    fits = [r for r in L.WIDE_ROWS if L.wide_fits(hidden, r)]
    assert fits == ([32, 16, 8, 4] if hidden <= 544 else [16, 8, 4])
    for r in L.WIDE_ROWS:
        smem = L.wide_smem(hidden, r)
        assert smem == (2 * hidden * (r + 4) + r * hidden) * 4
        assert (r in fits) == (smem <= L.SMEM_BYTES)
    for r in fits:
        per_sm = L.wide_ctas_per_sm(hidden, r)
        assert 1 <= per_sm <= (1 if r == 32 else 2 if r == 16 else 3)
        assert per_sm * (L.wide_smem(hidden, r) + L.CTA_RESERVED_SMEM) \
            <= L.SM_SMEM_BYTES
    for b in (1, 13, 256, 4096):
        for ndir in (1, 2):
            assert L.fwd_route(298, b, hidden, ndir, itemsize) == "wide"
            assert L.wide_plan(hidden, b, ndir) in fits


@pytest.mark.parametrize("itemsize", [4, 2])
def test_wide_plan_at_the_path_shape_is_one_wave(itemsize):
    """FN-SSL's narrow band at hidden_size 512 in training (298, 4096,
    512) takes tiles of 32 rows: 128 CTAs, one an SM, one wave, 32 rows on
    the busiest SM (31.03 if spread evenly); every other tile ties on
    rows and would read W_hh for fewer rows a CTA."""
    assert L.fwd_route(298, 16 * 256, 512, 1, itemsize) == "wide"
    rows = L.wide_plan(512, 16 * 256, 1)
    per_sm = L.wide_ctas_per_sm(512, rows)
    ctas = -(-4096 // rows)
    assert (rows, ctas, per_sm) == (32, 128, 1) and ctas <= L.SMS
    assert L._busiest(rows, ctas, per_sm) == 32
    for r in (16, 8, 4):
        assert L._busiest(r, -(-4096 // r), L.wide_ctas_per_sm(512, r)) \
            >= 32


@pytest.mark.parametrize("hidden,batch,ndir,rows", [
    (512, 2048, 1, 16),     # 128 CTAs of 16 rows beat 64 of 32
    (512, 256, 1, 4),       # the parity step: 64 CTAs of 4 rows
    (512, 13, 1, 4),        # 4 CTAs of 4 rows
    (768, 4096, 1, 16),     # 256 CTAs of 16, 2 waves: 32 rows
    (1024, 4096, 2, 16),    # 512 of 16, 4 waves: 64 rows
])
def test_wide_plan_fills_the_sms(hidden, batch, ndir, rows):
    assert L.wide_plan(hidden, batch, ndir) == rows


@pytest.mark.parametrize("hidden,rows", [
    (256, 32),              # H up to 256: lstm_wave.cu's
    (1056, 16),             # above 1024
    (528, 32),              # not a multiple of 32
    (512, 12),              # rows the source is not built for
    (576, 32),              # 32 rows' shared memory above H = 544
])
def test_wide_fits_refuses(hidden, rows):
    assert not L.wide_fits(hidden, rows)


def test_wide_tiles_fit_the_source():
    """lstm_wide.cu's sizing as the source builds it: 256 threads, H from
    288 to 1024, tiles of 32/16/8/4 rows with 1/2/3/3 CTAs an SM by the
    registers' budget, two h buffers and c in shared memory."""
    src = (cuda_build.CSRC / "lstm_wide.cu").read_text()
    assert f"kThreads = {L.WIDE_THREADS};" in src
    assert f"kPad = {L.WAVE_PAD};" in src
    assert "kMinHidden = 288;" in src and "kMaxHidden = 1024;" in src
    assert f"kMaxSmem = {L.SMEM_BYTES};" in src
    assert "rows <= 8 ? 3 : rows <= 16 ? 2 : 1" in src
    assert ("(2 * static_cast<size_t>(hidden) * (rows + kPad) +\n"
            "          static_cast<size_t>(rows) * hidden) * 4") in src
    for r in L.WIDE_ROWS:
        assert f"case {r}:" in src or f"launch<T_in, {r}, HC>" in src
    assert L.MAX_HIDDEN == 1024


@pytest.mark.parametrize("lead", [(), (2,)])
def test_wide_weights_interleave_each_units_gates(lead):
    """lstm_wide.cu reads W_hh^T as (..., H, H, 4): w4[k, j, g] is
    W_hh^T[k, g H + j], each unit's four gate columns side by side."""
    h = 288
    w = torch.randn(*lead, h, 4 * h, generator=torch.Generator()
                    .manual_seed(h))
    w4 = L.wide_weights(w)
    assert w4.shape == (*lead, h, h, 4) and w4.is_contiguous()
    for g in range(4):
        assert torch.equal(w4[..., g], w[..., g * h:(g + 1) * h])
