"""K2's routes and lstm_bwd_wave.cu's plans, on the CPU (no card, no nvcc).

``bwd_route`` chooses K2's kernel by shape; ``bwd_wave_plan`` sizes
lstm_bwd_wave.cu's tiles. Both are plain arithmetic, checked here at every
K2 call ``chip_smoke.py`` drives; what the kernel computes is checked on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py phases 6 and 9).
Here ``lstm_bwd_plain``, which the wrappers run for CPU tensors and the
card's kernels are held against, is held against JAX's ``_lstm_backward``
at a ragged tile edge.

Tolerance: rtol 2e-4 / atol 2e-5, as tests/test_torch_lstm_grad.py (the
JAX package's own for its hand-written backward).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnssl_tpu.kernels.lstm_pallas import _lstm_backward, lstm_fused_scan
from fnssl_tpu_torch.kernels import cuda_build
from fnssl_tpu_torch.kernels import lstm_cuda as L

RTOL, ATOL = 2e-4, 2e-5

# (what, T, B, H, ndir, itemsize, route): K2's calls on the paths chip_smoke
# drives, FNSSLConfig() (full band H 128 both directions, narrow band H
# 256) and IPDnetConfig() (H 64 and 128); K2 runs only in training
PATH_SHAPES = [
    ("train full band", 256, 16 * 298, 128, 2, 4, "wave"),
    ("train full band bf16", 256, 16 * 298, 128, 2, 2, "wave"),
    ("train narrow band", 298, 16 * 256, 256, 1, 4, "wave"),
    ("train narrow band bf16", 298, 16 * 256, 256, 1, 2, "wave"),
    ("parity step full band", 256, 2 * 298, 128, 2, 4, "cluster"),
    ("parity step narrow band", 298, 2 * 256, 256, 1, 4, "cluster"),
    ("DP rank full band", 256, 8 * 298, 128, 2, 4, "wave"),
    ("DP rank full band bf16", 256, 8 * 298, 128, 2, 2, "cluster"),
    ("DP rank narrow band", 298, 8 * 256, 256, 1, 4, "wave"),
    ("IPDnet train full band", 256, 16 * 280, 64, 2, 4, "cluster"),
    ("IPDnet train narrow band", 280, 16 * 256, 128, 1, 4, "cluster"),
    ("IPDnet train narrow band bf16", 280, 16 * 256, 128, 1, 2, "cluster"),
    ("IPDnet offline narrow band", 280, 16 * 256, 64, 2, 4, "cluster"),
    ("variable IPDnet full band", 256, 8 * 6 * 280, 64, 2, 4, "cluster"),
    ("variable IPDnet narrow band", 280, 8 * 6 * 256, 128, 1, 4, "wave"),
    ("variable IPDnet narrow band bf16", 280, 8 * 6 * 256, 128, 1, 2,
     "wave"),
]


@pytest.mark.parametrize("what,t,b,h,ndir,itemsize,route", PATH_SHAPES,
                         ids=[s[0] for s in PATH_SHAPES])
def test_bwd_route_on_every_path(what, t, b, h, ndir, itemsize, route):
    assert L.bwd_route(t, b, h, ndir, itemsize) == route


@pytest.mark.parametrize("key", sorted(L.BWD_WAVE_MIN_ROWS))
def test_bwd_route_threshold(key):
    """lstm_bwd_wave.cu from BWD_WAVE_MIN_ROWS rows (B x directions) up,
    at every T; lstm_bwd_cluster.cu below."""
    hidden, itemsize = key
    least = L.BWD_WAVE_MIN_ROWS[key]
    for t in (1, 12, 298):
        assert L.bwd_route(t, least - 1, hidden, 1, itemsize) == "cluster"
        assert L.bwd_route(t, least, hidden, 1, itemsize) == "wave"
        assert L.bwd_route(t, -(-least // 2), hidden, 2, itemsize) == "wave"
        assert L.bwd_route(t, least // 2 - 1, hidden, 2,
                           itemsize) == "cluster"
        assert L.bwd_wave_fits(hidden, itemsize, L.bwd_wave_plan(
            hidden, itemsize, least))


def test_bwd_route_keeps_unmeasured_widths_on_the_cluster_kernel():
    """No threshold at H 32 and 64: the sweep covered H 128 and 256, and
    the rule takes only what it measured (PERF.md)."""
    assert {h for h, _ in L.BWD_WAVE_MIN_ROWS} == {128, 256}
    for h in (32, 64):
        assert L.bwd_route(298, 1 << 16, h, 2, 4) == "cluster"


def test_bwd_wave_smem_and_occupancy_arithmetic():
    """The source's sizing: dgates / G (tile x (4H + 4)) and c_{t-1} (tile
    x H) float32 and dy_t (tile x H in ys's dtype); CTAs an SM from the
    registers' budget and the 228 KB of shared memory less 1 KB a CTA."""
    assert L.bwd_wave_tile(256, 4) == 16 and L.bwd_wave_tile(128, 38) == 38
    assert L.bwd_wave_tile(64, 2) == 32 and L.bwd_wave_tile(32, 4) == 128
    assert L.bwd_wave_smem(256, 4, 16) == 16 * 1028 * 4 + 16 * 256 * 4 \
        + 16 * 256 * 4 == 98_560
    assert L.bwd_wave_smem(256, 2, 16) == 98_560 - 16 * 256 * 2
    assert L.bwd_wave_ctas_per_sm(256, 4, 4) == 2     # registers and smem
    assert L.bwd_wave_ctas_per_sm(256, 2, 4) == 2     # registers
    # 20-row tiles: two CTAs an SM with a bfloat16 dy (110.3 KiB), one with
    # a float32 dy (120.3 KiB), which the source is not built for
    assert L.bwd_wave_tile(256, 5) == 20
    assert L.bwd_wave_smem(256, 2, 20) == 20 * 1028 * 4 + 20 * 256 * 6 \
        == 112_960
    assert L.bwd_wave_ctas_per_sm(256, 2, 5) == 2
    assert L._ctas_per_sm(L.bwd_wave_smem(256, 4, 20)) == 1
    # every width's tile of 4 rows a thread holds 96-98 KiB: 2 CTAs an SM
    # (H = 128 takes its own tiles only)
    for h in (32, 64, 256):
        assert L.bwd_wave_fits(h, 4, 4)
        smem = L.bwd_wave_smem(h, 4, L.bwd_wave_tile(h, 4))
        assert 96 * 1024 < smem <= L.SMEM_BYTES
        assert 2 * (smem + 16 + L.CTA_RESERVED_SMEM) <= L.SM_SMEM_BYTES
    src = (cuda_build.CSRC / "lstm_bwd_wave.cu").read_text()
    body = re.search(r"constexpr size_t smem_bytes\((.*?)\n}", src,
                     re.S).group(1)
    assert "(tile) * (4 * hidden + kPad) * 4" in body
    assert "(tile) * hidden * 4" in body
    assert "(tile) * hidden * itemsize" in body
    assert f"kThreads = {L.BWD_WAVE_THREADS};" in src
    assert f"kUnits = {L.BWD_WAVE_UNITS};" in src
    assert f"kPad = {L.BWD_WAVE_PAD};" in src
    assert "kMaxSmem = 232448" in src and "kBarrierSmem = 16" in src
    assert "__launch_bounds__(kThreads, 2)" in src      # 2 CTAs an SM
    assert f"kRows = {L.BWD_WAVE_ROWS[0]};" in src
    assert f"kRowsWide = {L.BWD_WAVE_ROWS[1]};" in src
    assert "rows == kRows || (rows == kRowsWide && is_bf16)" in src
    assert (cuda_build.library_path("lstm_bwd_wave").parent
            == cuda_build.BUILD_DIR)


@pytest.mark.parametrize("hidden,itemsize,rows", [
    (96, 4, 4),             # 1024/H row groups: H must divide 1024
    (288, 4, 4),            # H above 256
    (256, 4, 8),            # rows the source is not built for
    (256, 4, 2),
    (256, 4, 5),            # 5 rows with a float32 dy: one CTA an SM
    (16, 4, 4),             # H not a multiple of 32
    (128, 4, 4),            # H = 128 takes its own tiles only
    (128, 2, 5),
])
def test_bwd_wave_fits_refuses(hidden, itemsize, rows):
    assert not L.bwd_wave_fits(hidden, itemsize, rows)


def test_bwd_wave_plan_refuses_a_width_it_does_not_take():
    with pytest.raises(ValueError, match="no plan fits"):
        L.bwd_wave_plan(96, 4, 4096)


@pytest.mark.parametrize("batch,ndir,itemsize,rows", [
    (4096, 1, 4, 4),        # 256 CTAs of 16 rows, 2 an SM: one wave
    (4096, 1, 2, 4),        # 32 rows on the busiest SM against 40 at 5
    (2048, 1, 2, 4),
    (4768, 1, 4, 4),        # a float32 dy takes 4 rows only
    (4768, 1, 2, 5),        # 239 CTAs of 20 in one wave: 40 rows, not 48
    (4768, 2, 2, 4),        # 80 rows either way: 4 rows on a tie
    (13, 2, 2, 4),
])
def test_bwd_wave_plan_fills_the_sms(batch, ndir, itemsize, rows):
    """At H 256 the plan puts the fewest rows on the busiest SM, 4 rows a
    thread on a tie (``_busiest`` counts each wave of the grid)."""
    assert L.bwd_wave_plan(256, itemsize, batch, ndir) == rows
    assert L._busiest(16, 256, 2) == 32           # one wave, 2 tiles an SM
    assert L._busiest(16, 298, 2) == 48           # B = 4768: 34 tiles more
    assert L._busiest(20, 239, 2) == 40


def bwd_args(gen, t, b, h):
    g = torch.randn(2, t, b, 4 * h, generator=gen)
    w = torch.randn(2, 4 * h, h, generator=gen) / h ** 0.5
    c0, dh_t, dc_t = (torch.randn(2, b, h, generator=gen) for _ in range(3))
    dys = torch.randn(2, t, b, h, generator=gen)
    return g, w, c0, dys, dh_t, dc_t


def test_cpu_tensors_take_the_plain_version_whatever_the_route():
    gen = torch.Generator().manual_seed(0)
    g, w, c0, dys, dh_t, dc_t = bwd_args(gen, 5, 7, 32)
    counters = (L.launches_bwd_cluster, L.launches_bwd_wave)
    before = [c.value for c in counters]
    want2 = L.lstm_bwd_bidir_plain(g.clone(), w, c0, dys, dh_t, dc_t)
    want1 = L.lstm_bwd_plain(g[1].clone(), w[1], c0[1], dys[1], dh_t[1],
                             dc_t[1], reverse=True)
    for route, plan in ((None, None), ("wave", 4), ("wave", None),
                        ("cluster", None), ("cluster", (2, 8, 4, 1))):
        got = L.lstm_bwd_bidir(g.clone(), w, c0, dys, dh_t, dc_t,
                               route=route, plan=plan)
        for x, y in zip(got, want2):
            assert torch.equal(x, y)
        got = L.lstm_bwd(g[1].clone(), w[1], c0[1], dys[1], dh_t[1],
                         dc_t[1], reverse=True, route=route, plan=plan)
        for x, y in zip(got, want1):
            assert torch.equal(x, y)
    assert [c.value for c in counters] == before


@pytest.mark.parametrize("hidden", [32, 128, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_backward_at_a_ragged_tile_edge_matches_jax(hidden, reverse):
    """lstm_bwd_plain at B = 33 (one row past lstm_bwd_wave.cu's tiles of
    16 and 32 rows, inside H = 128's of 38), T = 7, against JAX's
    ``_lstm_backward`` on the same
    numpy-seeded forward: dh0, dc0, and dgates through the weight sums and
    dx they make (dx = dgates @ W_ih, db, dW_hh)."""
    rng = np.random.default_rng(hidden + reverse)
    b, t, i, h = 33, 7, 16, hidden
    f32 = np.float32
    x = rng.standard_normal((b, t, i)).astype(f32)
    w_ih = (rng.standard_normal((4 * h, i)) * 0.3).astype(f32)
    w_hh = (rng.standard_normal((4 * h, h)) * h ** -0.5).astype(f32)
    bias = (rng.standard_normal(4 * h) * 0.1).astype(f32)
    h0, c0 = ((rng.standard_normal((b, h)) * 0.5).astype(f32)
              for _ in range(2))
    dys = rng.standard_normal((b, t, h)).astype(f32)
    dh_t, dc_t = (rng.standard_normal((b, h)).astype(f32) for _ in range(2))

    ja = [jnp.asarray(a) for a in (x, w_ih, w_hh, bias, h0, c0)]
    ys = np.array(lstm_fused_scan(*ja, reverse)[0])         # (B, T, H)
    dx, _, d_whh, db, dh0, dc0 = (np.asarray(a) for a in _lstm_backward(
        reverse, (*ja, jnp.asarray(ys)),
        (jnp.asarray(dys), jnp.asarray(dh_t), jnp.asarray(dc_t))))

    ys_t = torch.as_tensor(ys).transpose(0, 1)               # (T, B, H)
    h_prev = torch.empty_like(ys_t)
    if reverse:
        h_prev[:-1], h_prev[-1] = ys_t[1:], torch.as_tensor(h0)
    else:
        h_prev[1:], h_prev[0] = ys_t[:-1], torch.as_tensor(h0)
    tw_ih, tw_hh = torch.as_tensor(w_ih), torch.as_tensor(w_hh)
    g = (torch.as_tensor(x).transpose(0, 1) @ tw_ih.T
         + torch.as_tensor(bias) + h_prev @ tw_hh.T).contiguous()
    dgates, tdh0, tdc0 = L.lstm_bwd_plain(
        g, tw_hh, torch.as_tensor(c0),
        torch.as_tensor(dys).transpose(0, 1).contiguous(),
        torch.as_tensor(dh_t), torch.as_tensor(dc_t), reverse=reverse)
    for got, want in (
            (tdh0, dh0), (tdc0, dc0),
            ((dgates @ tw_ih).transpose(0, 1), dx),
            (dgates.sum(dim=(0, 1)), db),
            (torch.einsum("tbg,tbh->gh", dgates, h_prev), d_whh)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_bwd_wave_plan_spreads_the_full_band_at_h128(itemsize):
    """FN-SSL's full band in training (B 4768, both directions: 9536 rows,
    72.2 an SM if spread evenly) takes the H = 128 tile of 38 rows, 2 CTAs
    an SM in either dtype: 252 CTAs in one wave, 76 rows on the busiest
    SM, where the tiles of 4 rows a thread put 96."""
    tile = L.bwd_wave_plan(128, itemsize, 4768, 2)
    per_sm = L.bwd_wave_ctas_per_sm(128, itemsize, tile)
    assert (tile, L.bwd_wave_tile(128, tile), per_sm) == (38, 38, 2)
    assert L._busiest(tile, -(-4768 // tile) * 2, per_sm) == 76
    assert L._busiest(32, -(-4768 // 32) * 2, 2) == 96


@pytest.mark.parametrize("batch,ndir,tile", [
    (4768, 2, 38),          # FN-SSL's full band: one wave of R = 5
    (4096, 1, 16),          # IPDnet's narrow band: one wave of R = 2
    (12288, 1, 24),         # VariableIPDnet's: two waves of R = 3
    (2384, 2, 20),          # a DP rank's full band: one wave of R = 3
    (1242, 2, 10),          # LOCATA's full band
])
def test_bwd_wave_plan_at_h128_weighs_waves_by_rows_a_thread(batch, ndir,
                                                             tile):
    """At H = 128 the tile of the least (waves x (1.8 + R)), as measured:
    more CTAs of fewer rows where that saves a wave."""
    for itemsize in (4, 2):
        assert L.bwd_wave_plan(128, itemsize, batch, ndir) == tile


def test_bwd_wave128_tiles_fit_the_source():
    """The H = 128 tiles as the source builds them: 8 row groups of R =
    ceil(tile / 8) rows (R 2 to 5), the last slot in (tile - 8 (R - 1)) / 2
    of the 4 warp-rows; dgates (tile x (4H + 4)) float32 alone in shared
    memory, two CTAs an SM for every tile (__launch_bounds__(256, 2): 12 R
    carries a thread, acc, dc and c_t, within its 128 registers); only at
    H = 128."""
    src = (cuda_build.CSRC / "lstm_bwd_wave.cu").read_text()
    assert f"kRowGroups128 = {L.BWD_WAVE128_GROUPS};" in src
    assert ("return static_cast<size_t>(tile) * (4 * 128 + kPad) * 4;"
            in src)
    assert "rows >= 10 && rows <= 40 && rows % 2 == 0" in src
    assert sorted(L.BWD_WAVE128_TILES) == list(range(10, 41, 2))
    for tile in L.BWD_WAVE128_TILES:
        r = -(-tile // 8)
        assert 2 <= r <= 5 and 1 <= (tile - 8 * (r - 1)) // 2 <= 4
        assert L.bwd_wave128_smem(tile) == tile * 516 * 4
        for itemsize in (4, 2):
            assert L.bwd_wave_fits(128, itemsize, tile)
            assert L.bwd_wave_ctas_per_sm(128, itemsize, tile) == 2
        assert 12 * r < 65536 // (256 * 2)
        assert not L.bwd_wave_fits(256, 4, tile)
    assert not L.bwd_wave_fits(128, 4, 42) and not L.bwd_wave_fits(128, 4, 9)
    # the plans each width takes: H = 128 its tiles only
    assert L.bwd_wave_plans(128, 4) == L.bwd_wave_plans(128, 2) \
        == L.BWD_WAVE128_TILES
    assert L.bwd_wave_plans(256, 4) == (4,)
    assert L.bwd_wave_plans(256, 2) == (4, 5)
