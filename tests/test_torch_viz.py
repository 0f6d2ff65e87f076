"""The port's plotting and visualization (pdmpc_torch/eval/plotting.py,
visualization.py) on the CPU: the API of tests/test_eval_viz.py, each
figure written to a file, and on the same records the same drawing as
pdmpc_tpu's (the lines and patches of a frame, the numbers a plot
returns, the pgf table byte for byte)."""

import functools
import os

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import pdmpc_torch.config as tc
from pdmpc_torch import visualization as tviz
from pdmpc_torch.eval import plotting as tplot
from pdmpc_torch.experiment import run_experiment
from pdmpc_torch.hlc import run_with_plant

# One intra-op thread per process, as the other port files.
torch.set_num_threads(1)


def circle2(**kw):
    return tc.Config(scenario_type=tc.ScenarioType.circle, amount=2,
                     **{"T_end": 2.0, "beam_width": 96, **kw})


@functools.cache
def result():
    return run_experiment(circle2(), device="cpu")


@functools.cache
def host_result():
    """Host-driven loop result: has per-step measure/plan/apply spans."""
    return run_with_plant(circle2(T_end=1.0, beam_width=64), device="cpu")


def drawn(ax):
    """What an axes shows: its lines' data and its patches' vertices."""
    return ([np.asarray(line.get_xydata()) for line in ax.get_lines()],
            [np.asarray(p.get_xy()) for p in ax.patches], ax.get_title())


def assert_same_drawing(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


def test_frame_matches_reference(tmp_path):
    import pdmpc_tpu.visualization as jviz

    res = result()
    p = tviz.PlotterOffline(res)
    path = p.export_frame(3, str(tmp_path / "frame.png"))
    assert os.path.getsize(path) > 5000
    fig, ax = plt.subplots()
    jviz.plot_step(ax, res.infos, 3)
    assert_same_drawing(drawn(p.ax), drawn(ax))
    plt.close(fig)
    plt.close(p.fig)


def test_export_frame_with_road_and_video(tmp_path):
    from pdmpc_torch.scenarios.road import get_road_data

    res = run_experiment(tc.Config(amount=2, T_end=1.0, beam_width=64),
                         device="cpu")
    p = tviz.PlotterOffline(res, road=get_road_data())
    assert os.path.getsize(p.export_frame(
        2, str(tmp_path / "road.png"))) > 10000
    assert os.path.getsize(p.export_video(
        str(tmp_path / "run.gif"), fps=5)) > 1000
    plt.close(p.fig)


def test_computation_time_per_vehicle(tmp_path):
    path = str(tmp_path / "ct.png")
    tplot.plot_computation_time_per_vehicle(result(), path=path)
    assert os.path.getsize(path) > 1000


def test_computation_time_over_vehicle_number(tmp_path):
    from pdmpc_tpu.eval import plotting as jplot

    n, med, mx = tplot.plot_computation_time_over_vehicle_number(
        [result(), host_result()], path=str(tmp_path / "box.png"))
    assert list(n) == [2, 2]
    assert (mx >= med).all() and (med > 0).all()
    for got, want in zip((n, med, mx),
                         jplot.plot_computation_time_over_vehicle_number(
                             [result(), host_result()])):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tplot.data_time_experiment(host_result()),
        jplot.data_time_experiment(host_result()))


def test_computation_time_for_step(tmp_path):
    ax = tplot.plot_computation_time_for_step(
        host_result(), 3, path=str(tmp_path / "gantt.png"))
    labels = [t.get_text() for t in ax.get_yticklabels()]
    assert labels == ["measure", "plan", "apply"]
    assert os.path.getsize(str(tmp_path / "gantt.png")) > 1000


def test_for_step_requires_spans():
    # run_experiment's results carry no per-step spans
    with pytest.raises(ValueError, match="run_with_plant"):
        tplot.plot_computation_time_for_step(result(), 0)


def test_series_plot_med_max(tmp_path):
    ax = tplot.series_plot_med_max(
        [5, 10, 15], [[1.0, 2.0], [1.5, 2.5], [2.0, 3.0]],
        [[2.0, 4.0], [3.0, 5.0], [4.0, 6.0]],
        ["coloring", "fca"], path=str(tmp_path / "mm.png"))
    assert [t.get_text() for t in ax.get_legend().get_texts()] == [
        "max coloring", "med coloring", "max fca", "med fca"]


def test_plot_mpa_family(tmp_path):
    from pdmpc_torch.models.mpa import build_mpa

    mpa = build_mpa(circle2())
    tplot.plot_mpa(mpa, path=str(tmp_path / "mpa.png"))
    tplot.plot_mpa_over_time(mpa, path=str(tmp_path / "mpa_t.png"))
    tplot.plot_mpa_local_reachable_sets(mpa, trim=0,
                                        path=str(tmp_path / "mpa_rs.png"))
    for f in ("mpa.png", "mpa_t.png", "mpa_rs.png"):
        assert os.path.getsize(str(tmp_path / f)) > 1000
    plt.close("all")


def test_snapshots_and_partitioned_graph(tmp_path):
    from pdmpc_tpu.eval import plotting as jplot

    tplot.plot_experiment_snapshots(result(), [0, 3, 6, 9],
                                    path=str(tmp_path / "snap.png"))
    assert os.path.getsize(str(tmp_path / "snap.png")) > 5000
    ax = tplot.plot_partitioned_graph(result(), 0,
                                      path=str(tmp_path / "graph.png"))
    assert os.path.getsize(str(tmp_path / "graph.png")) > 1000
    assert_same_drawing(drawn(ax), drawn(jplot.plot_partitioned_graph(
        result(), 0)))
    plt.close("all")


def test_matrix_to_pgf_array(tmp_path):
    from pdmpc_tpu.eval import plotting as jplot

    m = np.random.default_rng(0).normal(size=(3, 2))
    path = tplot.matrix_to_pgf_array(m, str(tmp_path / "m.dat"),
                                     column_names=["a", "b"])
    j_path = jplot.matrix_to_pgf_array(m, str(tmp_path / "j.dat"),
                                       column_names=["a", "b"])
    with open(path) as f, open(j_path) as g:
        content = f.read()
        assert content == g.read()
    assert content.splitlines()[0] == "a b"


def test_plotter_online_draws_each_step_and_aborts():
    plotter = tviz.PlotterOnline()
    seen = []

    def hook(k, info):
        seen.append(k)
        if k == 2:
            plotter.stop_requested = True  # the ESC hotkey's effect
        return plotter(k, info)

    res = run_with_plant(circle2(T_end=1.0, beam_width=64), on_step=hook,
                         device="cpu")
    assert seen == [0, 1, 2]
    assert res.n_steps == 3  # the loop ended after the hook returned True
    assert "[k=2]" in plotter.ax.get_title()
    plotter.close()


def test_hotkey_toggles():
    plotter = tviz.PlotterOnline()

    class _Ev:
        def __init__(self, key):
            self.key = key

    assert plotter.show_couplings
    plotter._on_key(_Ev("c"))
    assert not plotter.show_couplings
    plotter._on_key(_Ev("p"))
    assert not plotter.show_predictions
    plotter._on_key(_Ev(" "))
    assert plotter.paused
    plotter._on_key(_Ev("escape"))
    assert plotter.stop_requested
    plotter.close()


def test_export_fig_presets(tmp_path):
    fig, _ = plt.subplots()
    tviz.export_fig(fig, str(tmp_path / "p.png"), preset="presentation")
    assert tuple(fig.get_size_inches()) == (8.0, 5.0)
    assert os.path.getsize(str(tmp_path / "p.png")) > 1000
    plt.close(fig)
