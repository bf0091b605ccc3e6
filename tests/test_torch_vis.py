"""The port's visualizations (fnssl_tpu_torch.eval.vis: vis_doa,
locata_plot), the three cases of tests/test_vis.py.

Parity targets: visDOA (FN-SSL/Module.py:319-373) and locata_plot
(FN-SSL/utils.py:166-187). These verify the figures are actually
produced with the expected structure (panel count, scatter series,
axis limits) and that the file artifact exists.
"""
import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")

from fnssl_tpu_torch.eval.vis import locata_plot, vis_doa  # noqa: E402


def _fake_track(nt=20, ns=2, seed=0):
    rng = np.random.default_rng(seed)
    doa = rng.uniform(0, 180, (nt, 2, ns))
    vad = rng.uniform(0, 1, (nt, ns))
    return doa.astype(np.float32), vad.astype(np.float32)


def test_vis_doa_draws_three_series_and_limits():
    doa_gt, vad_gt = _fake_track(seed=0)
    doa_est, vad_est = _fake_track(seed=1)
    ts = np.arange(20) * 0.256
    plt = vis_doa(doa_gt, vad_gt, doa_est, vad_est, (2 / 3, 0.5), ts)
    ax = plt.gca()
    # per-source GT-silence + GT scatters, plus per-track EST scatters
    assert len(ax.collections) == 2 * 2 + 2
    assert ax.get_ylim() == (0.0, 180.0)
    labels = [h.get_label() for h in ax.get_legend().legend_handles]
    assert labels == ["GT_silence", "GT", "EST"]
    plt.close("all")


def test_vis_doa_vad_gating_hides_estimates():
    """Estimates below the est-VAD threshold are moved to doa_invalid
    (off the 0-180 axis), i.e. gated out of view."""
    nt = 8
    doa_gt = np.full((nt, 2, 1), 90.0, np.float32)
    doa_est = np.full((nt, 2, 1), 45.0, np.float32)
    vad_gt = np.ones((nt, 1), np.float32)
    vad_est = np.zeros((nt, 1), np.float32)      # all below threshold
    plt = vis_doa(doa_gt, vad_gt, doa_est, vad_est, (2 / 3, 0.5),
                  np.arange(nt), doa_invalid=200.0)
    est_series = plt.gca().collections[-1]
    ys = est_series.get_offsets()[:, 1]
    assert np.all(ys == 200.0)                   # every point gated
    plt.close("all")


def test_locata_plot_panels_and_file(tmp_path):
    n_tasks = 4
    res = str(tmp_path) + "/"
    for k in range(n_tasks):
        doa, vad = _fake_track(nt=12, ns=1, seed=k)
        np.save(f"{res}{k}_gt.npy", doa[None])
        np.save(f"{res}{k}_est.npy", doa[None] + 3.0)
        np.save(f"{res}{k}_vadgt.npy", vad[None])
    plt = locata_plot(res, res, n_tasks=n_tasks)
    fig = plt.gcf()
    assert len(fig.axes) == n_tasks              # one panel per task
    for ax in fig.axes:
        assert len(ax.collections) == 2          # GT + EST series
        assert ax.get_ylim() == (0.0, 180.0)
    out = tmp_path / "locata_fig.jpg"
    assert out.exists() and out.stat().st_size > 0
    plt.close("all")
