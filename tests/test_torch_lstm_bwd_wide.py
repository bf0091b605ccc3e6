"""K2 above H = 256 (lstm_bwd_wide.cu) and LSTM widths that are not a
multiple of 32, on the CPU (no card, no nvcc).

``bwd_route`` gives every H from 288 to 1024 to lstm_bwd_wide.cu, and
``bwd_wide_plan`` sizes its tiles: plain arithmetic, checked here at the
shapes of FN-SSL at hidden_size 512 and against the source's own sizing.
What the kernel computes is checked on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phases 6 and 9).

The padding that runs an LSTM of H units at ``padded_hidden(H)`` on the
card (``lstm_fwd_padded``, ``lstm_bwd_padded``) is held here, through the
plain versions the card's kernels are held against, against JAX's
``lstm_fused_scan`` and ``_lstm_backward`` at H = 48 (padded to 64):
the padding is exact.

Tolerance: rtol 2e-4 / atol 2e-5, as tests/test_torch_lstm_grad.py (the
JAX package's own for its hand-written backward); the padded plain
versions against the unpadded ones within 1e-6 (the same float32
arithmetic, sums of W_hh's zero rows added).
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

# (what, T, B, H, ndir, itemsize, route): K2's calls of FN-SSL at
# FNSSLConfig(hidden_size=512) (full band H 256 both directions, narrow band
# H 512), the shapes chip_smoke drives: training at nb 16, the parity step
# at nb 2
WIDE_SHAPES = [
    ("train narrow band H 512", 298, 16 * 256, 512, 1, 4, "wide"),
    ("train narrow band H 512 bf16", 298, 16 * 256, 512, 1, 2, "wide"),
    ("train full band H 256", 256, 16 * 298, 256, 2, 4, "wave"),
    ("train full band H 256 bf16", 256, 16 * 298, 256, 2, 2, "wave"),
    ("parity step narrow band H 512", 298, 2 * 256, 512, 1, 4, "wide"),
    ("parity step full band H 256", 256, 2 * 298, 256, 2, 4, "cluster"),
]


@pytest.mark.parametrize("what,t,b,h,ndir,itemsize,route", WIDE_SHAPES,
                         ids=[s[0] for s in WIDE_SHAPES])
def test_bwd_route_at_hidden_512(what, t, b, h, ndir, itemsize, route):
    assert L.bwd_route(t, b, h, ndir, itemsize) == route


@pytest.mark.parametrize("hidden", range(288, 1025, 32))
def test_bwd_route_gives_every_width_above_256_to_the_wide_kernel(hidden):
    """Every B and direction count gets lstm_bwd_wide.cu and a plan that
    fits: the fewest rows on the busiest SM (one CTA an SM, each wave in
    turn), on a tie the most rows a thread; 16-row tiles up to H = 512 and
    8-row ones above at FN-SSL's B = 4096."""
    plans = L.bwd_wide_plans(hidden)
    for b in (1, 13, 77, 256, 2048, 4096, 4768):
        for ndir in (1, 2):
            assert L.bwd_route(298, b, hidden, ndir, 4) == "wide"
            plan = L.bwd_wide_plan(hidden, b, ndir)
            assert plan in plans and L.bwd_wide_fits(hidden, plan)
            busiest = {p: L._busiest(L.bwd_wide_tile(p), -(
                -b // L.bwd_wide_tile(p)) * ndir, 1) for p in plans}
            assert busiest[plan] == min(busiest.values())
            assert plan == max(p for p in plans
                               if busiest[p] == busiest[plan])
    assert L.bwd_wide_tile(L.bwd_wide_plan(hidden, 4096, 1)) == (
        16 if hidden <= 512 else 8)


@pytest.mark.parametrize("batch,ndir,hidden,plan,busiest", [
    (4096, 1, 512, 4, 32),     # 256 tiles of 16 in two waves (31.03 even)
    (512, 1, 512, 1, 4),       # the parity step: 128 tiles of 4, one wave
    (4096, 1, 1024, 2, 32),    # 512 tiles of 8
    (4096, 1, 288, 4, 32),
    (13, 2, 768, 1, 4),        # 8 tiles of 4 rows, not 4 of 8
])
def test_bwd_wide_plan_fills_the_sms(batch, ndir, hidden, plan, busiest):
    """The plan puts the fewest rows on the busiest SM (one CTA an SM,
    each wave of the grid in turn), the most rows a thread on a tie."""
    assert L.bwd_wide_plan(hidden, batch, ndir) == plan
    tile = L.bwd_wide_tile(plan)
    assert L._busiest(tile, -(-batch // tile) * ndir, 1) == busiest


def test_bwd_wide_layout_and_smem_arithmetic():
    """Columns of 32 units a lane, threads a CTA and shared memory (dgates,
    tile x (4H + 4), and dc, tile x (H + 4), float32) at the widths the
    source takes."""
    assert [L.bwd_wide_columns(h) for h in (288, 512, 544, 1024)] == \
        [1, 1, 2, 2]
    assert [L.bwd_wide_threads(h) for h in (288, 384, 512, 544, 768, 1024)] \
        == [288, 384, 512, 288, 384, 512]
    assert L.bwd_wide_smem(512, 16) == 16 * (2052 + 516) * 4 == 164_352
    assert L.bwd_wide_smem(1024, 8) == 8 * (4100 + 1028) * 4 == 164_096
    # a 32-row tile's dgates alone would not fit a CTA at H = 512
    assert 32 * 2052 * 4 > L.SMEM_BYTES
    for h in range(288, 1025, 32):
        plans = L.bwd_wide_plans(h)
        assert plans == ((4, 2, 1) if h <= 512 else (2, 1))
        assert L.bwd_wide_threads(h) <= L.BWD_WIDE_MAX_THREADS
        for p in plans:
            assert L.bwd_wide_smem(h, L.bwd_wide_tile(p)) <= L.SMEM_BYTES


@pytest.mark.parametrize("hidden,plan", [
    (256, 4),               # H = 256 and below: the other two sources
    (128, 2),
    (1056, 2),              # above 1024
    (300, 2),               # not a multiple of 32 (the wrapper pads it)
    (768, 4),               # two columns a lane: 2 or 1 rows only
    (512, 3),               # rows the source is not built for
])
def test_bwd_wide_fits_refuses(hidden, plan):
    assert not L.bwd_wide_fits(hidden, plan)


def test_bwd_wide_plan_refuses_a_width_it_does_not_take():
    for hidden in (256, 1056):
        with pytest.raises(ValueError, match="no plan fits"):
            L.bwd_wide_plan(hidden, 4096)


def test_the_source_sizes_a_cta_as_the_plan_does():
    """The source's layout, shared memory and limits carry the same
    numbers as bwd_wide_columns / bwd_wide_smem / bwd_wide_fits."""
    src = (cuda_build.CSRC / "lstm_bwd_wide.cu").read_text()
    assert 'extern "C" int lstm_bwd_wide(' in src
    assert "lstm_pallas.py:" in src and "_lstm_backward" in src
    body = re.search(r"constexpr size_t smem_bytes\((.*?)\n}", src,
                     re.S).group(1)
    assert "(tile) * (4 * hidden + kPad + hidden + kPad) * 4" in body
    # W_hh register blocks of 8 k's at the 16-row tile, 4 below
    assert "constexpr int block_k(int r) { return r == 4 ? 8 : 4; }" in src
    assert "constexpr int KB = block_k(R);" in src
    assert f"kGroups = {L.BWD_WIDE_GROUPS};" in src
    assert f"kPad = {L.BWD_WAVE_PAD};" in src
    assert f"kMaxThreads = {L.BWD_WIDE_MAX_THREADS};" in src
    assert "kMinHidden = 288;" in src
    assert f"kMaxHidden = {L.BWD_MAX_HIDDEN};" in src
    assert "kMaxSmem = 232448" in src
    assert "return hidden / 32 <= 16 ? 1 : 2;" in src     # the columns
    assert "__launch_bounds__(kMaxThreads, 1)" in src    # one CTA an SM
    assert ("rows == 1 || rows == 2 || (rows == 4 && columns(hidden) == 1)"
            in src)
    assert L.BWD_WIDE_ROWS == {1: (4, 2, 1), 2: (2, 1)}
    assert (cuda_build.library_path("lstm_bwd_wide").parent
            == cuda_build.BUILD_DIR)
    assert L.BWD_SOURCES["wide"] == "lstm_bwd_wide"
    assert L.BWD_COUNTERS["lstm_bwd_wide"] is L.launches_bwd_wide


def bwd_args(gen, t, b, h, lead=(2,)):
    g = torch.randn(*lead, t, b, 4 * h, generator=gen)
    w = torch.randn(*lead, 4 * h, h, generator=gen) / h ** 0.5
    c0, dh_t, dc_t = (torch.randn(*lead, b, h, generator=gen)
                      for _ in range(3))
    dys = torch.randn(*lead, t, b, h, generator=gen)
    return g, w, c0, dys, dh_t, dc_t


@pytest.mark.parametrize("hidden", [48, 520])
def test_cpu_tensors_take_the_plain_version_whatever_the_width(hidden):
    """CPU tensors run the plain versions unpadded at any H (48; 520, past
    512 and not a multiple of 32), route or plan, and move no counter."""
    gen = torch.Generator().manual_seed(hidden)
    args = bwd_args(gen, 3, 5, hidden)
    counters = (L.launches_bwd_cluster, L.launches_bwd_wave,
                L.launches_bwd_wide, L.launches, L.launches_wide)
    before = [c.value for c in counters]
    want = L.lstm_bwd_bidir_plain(args[0].clone(), *args[1:])
    for route, plan in ((None, None), ("wide", 2), ("wave", None)):
        got = L.lstm_bwd_bidir(args[0].clone(), *args[1:], route=route,
                               plan=plan)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    xg = torch.randn(2, 3, 5, 4 * hidden, generator=gen)
    w_t = torch.randn(2, hidden, 4 * hidden, generator=gen) / 8
    h0 = torch.randn(2, 5, hidden, generator=gen)
    got = L.lstm_fwd_bidir(xg, w_t, h0, h0)
    for x, y in zip(got, L.lstm_fwd_bidir_plain(xg, w_t, h0, h0)):
        assert torch.equal(x, y)
    assert [c.value for c in counters] == before


@pytest.mark.parametrize("hidden", [48, 8, 300])
def test_padding_helpers_equal_the_unpadded_plain_versions(hidden):
    """The padded plain forward and backward, both entry points and both
    walks, against the plain versions at H itself, within 1e-6; g holds the
    H units' dgates after the padded backward."""
    gen = torch.Generator().manual_seed(hidden)
    xg = torch.randn(2, 5, 7, 4 * hidden, generator=gen)
    w_t = torch.randn(2, hidden, 4 * hidden, generator=gen) / hidden ** 0.5
    h0, c0 = (torch.randn(2, 7, hidden, generator=gen) for _ in range(2))
    pairs = [(L.lstm_fwd_padded(L.lstm_fwd_bidir_plain, xg, w_t, h0, c0),
              L.lstm_fwd_bidir_plain(xg, w_t, h0, c0))]
    for d in range(2):
        pairs.append((L.lstm_fwd_padded(L.lstm_fwd_plain, xg[d], w_t[d],
                                        h0[d], c0[d], reverse=bool(d)),
                      L.lstm_fwd_plain(xg[d], w_t[d], h0[d], c0[d],
                                       reverse=bool(d))))
    args = bwd_args(gen, 5, 7, hidden)
    pairs.append((L.lstm_bwd_padded(L.lstm_bwd_bidir_plain,
                                    args[0].clone(), *args[1:]),
                  L.lstm_bwd_bidir_plain(args[0].clone(), *args[1:])))
    pairs.append((L.lstm_bwd_padded(L.lstm_bwd_plain, args[0][1].clone(),
                                    *(a[1] for a in args[1:4]),
                                    reverse=True),
                  L.lstm_bwd_plain(args[0][1].clone(),
                                   *(a[1] for a in args[1:4]),
                                   reverse=True)))
    for got, want in pairs:
        for x, y in zip(got, want):
            assert x.shape == y.shape and x.is_contiguous()
            assert (x - y).abs().max().item() <= 1e-6
    assert L.padded_hidden(hidden) == -(-hidden // 32) * 32


@pytest.mark.parametrize("reverse", [False, True])
def test_padded_lstm_at_h48_matches_jax(reverse):
    """An LSTM of H = 48 run as the card runs it, padded to 64
    (lstm_fwd_padded, lstm_bwd_padded over the plain versions), against
    JAX's lstm_fused_scan and _lstm_backward on the same numpy-seeded
    inputs: ys, hT, cT, dh0, dc0, and dgates through dx, db and dW_hh."""
    rng = np.random.default_rng(48 + reverse)
    b, t, i, h = 13, 7, 16, 48
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
    jys, jh, jc = (np.asarray(a) for a in lstm_fused_scan(*ja, reverse))
    dx, _, d_whh, db, dh0, dc0 = (np.asarray(a) for a in _lstm_backward(
        reverse, (*ja, jnp.asarray(jys)),
        (jnp.asarray(dys), jnp.asarray(dh_t), jnp.asarray(dc_t))))

    tx, tw_ih, tw_hh = (torch.as_tensor(a) for a in (x, w_ih, w_hh))
    xg = (tx.transpose(0, 1) @ tw_ih.T + torch.as_tensor(bias)).contiguous()
    ys, h_t, c_t = L.lstm_fwd_padded(
        L.lstm_fwd_plain, xg, tw_hh.T.contiguous(), torch.as_tensor(h0),
        torch.as_tensor(c0), reverse=reverse)
    for got, want in ((ys.transpose(0, 1), jys), (h_t, jh), (c_t, jc)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    ys_t = torch.as_tensor(jys).transpose(0, 1)               # (T, B, H)
    h_prev = torch.empty_like(ys_t)
    if reverse:
        h_prev[:-1], h_prev[-1] = ys_t[1:], torch.as_tensor(h0)
    else:
        h_prev[1:], h_prev[0] = ys_t[:-1], torch.as_tensor(h0)
    g = (xg + h_prev @ tw_hh.T).contiguous()
    dgates, tdh0, tdc0 = L.lstm_bwd_padded(
        L.lstm_bwd_plain, g, tw_hh, torch.as_tensor(c0),
        torch.as_tensor(dys).transpose(0, 1).contiguous(),
        torch.as_tensor(dh_t), torch.as_tensor(dc_t), reverse=reverse)
    assert dgates is g and dgates.shape == (t, b, 4 * h)
    for got, want in (
            (tdh0, dh0), (tdc0, dc0),
            ((dgates @ tw_ih).transpose(0, 1), dx),
            (dgates.sum(dim=(0, 1)), db),
            (torch.einsum("tbg,tbh->gh", dgates, h_prev), d_whh)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("walk", ["forward", "reverse", "both"])
@pytest.mark.parametrize("hidden", [288, 512, 1024])
def test_wide_backward_matches_jax(hidden, walk):
    """K2 at widths lstm_bwd_wide.cu takes (288, FN-SSL's 512, the largest,
    1024), through the entry points the LSTM layer calls (``lstm_bwd`` for
    one walk, ``lstm_bwd_bidir`` for both; the plain version on the CPU,
    which the card's kernel is held against), against JAX's
    ``_lstm_backward`` on the same numpy-seeded inputs at a B of 13, no
    multiple of a tile: dh0, dc0, and dgates through dx, db and dW_hh."""
    rng = np.random.default_rng(hidden + len(walk))
    b, t, i = 13, 3, 16
    f32 = np.float32
    dirs = (False, True) if walk == "both" else (walk == "reverse",)
    tg, tw, tc0, tdy, tdh, tdc, want = [], [], [], [], [], [], []
    for reverse in dirs:
        x = rng.standard_normal((b, t, i)).astype(f32)
        w_ih = (rng.standard_normal((4 * hidden, i)) * 0.3).astype(f32)
        w_hh = (rng.standard_normal((4 * hidden, hidden))
                * hidden ** -0.5).astype(f32)
        bias = (rng.standard_normal(4 * hidden) * 0.1).astype(f32)
        h0, c0 = ((rng.standard_normal((b, hidden)) * 0.5).astype(f32)
                  for _ in range(2))
        dys = rng.standard_normal((b, t, hidden)).astype(f32)
        dh_t, dc_t = (rng.standard_normal((b, hidden)).astype(f32)
                      for _ in range(2))
        ja = [jnp.asarray(a) for a in (x, w_ih, w_hh, bias, h0, c0)]
        jys = np.asarray(lstm_fused_scan(*ja, reverse)[0])
        dx, _, d_whh, db, dh0, dc0 = (np.asarray(a) for a in _lstm_backward(
            reverse, (*ja, jnp.asarray(jys)),
            (jnp.asarray(dys), jnp.asarray(dh_t), jnp.asarray(dc_t))))
        ys_t = torch.as_tensor(jys).transpose(0, 1)             # (T, B, H)
        h_prev = torch.empty_like(ys_t)
        if reverse:
            h_prev[:-1], h_prev[-1] = ys_t[1:], torch.as_tensor(h0)
        else:
            h_prev[1:], h_prev[0] = ys_t[:-1], torch.as_tensor(h0)
        tx, tw_ih, tw_hh = (torch.as_tensor(a) for a in (x, w_ih, w_hh))
        xg = tx.transpose(0, 1) @ tw_ih.T + torch.as_tensor(bias)
        tg.append(xg + h_prev @ tw_hh.T)
        tw.append(tw_hh)
        tc0.append(torch.as_tensor(c0))
        tdy.append(torch.as_tensor(dys).transpose(0, 1))
        tdh.append(torch.as_tensor(dh_t))
        tdc.append(torch.as_tensor(dc_t))
        want.append((tw_ih, h_prev, dx, d_whh, db, dh0, dc0))
    if walk == "both":
        got = L.lstm_bwd_bidir(*(torch.stack(a).contiguous() for a in (
            tg, tw, tc0, tdy, tdh, tdc)))
        got = [tuple(o[d] for o in got) for d in range(2)]
    else:
        got = [L.lstm_bwd(*(a[0].contiguous() for a in (
            tg, tw, tc0, tdy, tdh, tdc)), reverse=dirs[0])]
    for (dgates, tdh0, tdc0), (tw_ih, h_prev, dx, d_whh, db, dh0, dc0) in \
            zip(got, want):
        assert dgates.shape == (t, b, 4 * hidden)
        for got_, want_ in (
                (tdh0, dh0), (tdc0, dc0),
                ((dgates @ tw_ih).transpose(0, 1), dx),
                (dgates.sum(dim=(0, 1)), db),
                (torch.einsum("tbg,tbh->gh", dgates, h_prev), d_whh)):
            np.testing.assert_allclose(got_.numpy(), want_, rtol=RTOL,
                                       atol=ATOL)
