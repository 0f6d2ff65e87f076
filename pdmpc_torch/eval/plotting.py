"""Evaluation plotting — the eval/3-plotting capability.

Torch twin of pdmpc_tpu/eval/plotting.py (numpy and matplotlib).
Reference: eval/3-plotting/ (plot_computation_time_for_step.m,
plot_computation_time_per_vehicle.m,
plot_computation_time_over_vehicle_number.m,
series_plot_med_max.m, plot_mpa.m, plot_mpa_over_time.m,
plot_mpa_local_reachable_sets.m, plot_experiment_snapshots.m,
plot_partitioned_graph.m) and eval/eval_phd/matrix_to_pgf_array.m.

The timing plots: the reference measures per-vehicle per-phase wall
clocks because each vehicle runs its own HLC process; here the whole
fleet's step is one program, so the honest per-step signal is the
host-loop phase spans (measure / plan / apply from
utils.timing.ControllerTiming) and the per-vehicle signal is the recorded
computation-level schedule (StepInfo.levels) and search effort
(StepInfo.n_expanded). Functions keep the reference names and plot the
equivalent quantity, documented per function. ``data_time_experiment``
(here as in pdmpc_tpu) lives in ``eval.processing``, which needs no
matplotlib: the card's hosts have none.
"""

from __future__ import annotations

import os

import matplotlib

# Headless default WITHOUT clobbering an interactive backend: a process-wide
# ``matplotlib.use("Agg")`` at import time would silently disable
# visualization.PlotterOnline's live window when eval plotting is imported
# first. Only force Agg when no display is available anyway.
if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
    matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np

from pdmpc_torch.eval.processing import data_time_experiment
from pdmpc_torch.visualization import VEHICLE_COLORS, export_fig, plot_step

# phase order of the host-driven loop (hlc.run_with_plant), mirroring the
# reference's field_names list in plot_computation_time_for_step.m:27-36
PHASE_NAMES = ("measure", "plan", "apply")


def plot_computation_time_for_step(result, k, ax=None, path=None):
    """Gantt chart of one step's controller phases.

    Reference: plot_computation_time_for_step.m:1-80 draws one horizontal
    span per (vehicle, phase) relative to the latest measure start. With
    one step program there is one span per phase; vehicles are represented
    by the computation-level schedule annotated on the plan span (the
    reference sorts its rows by weakly-connected coupling groups for the
    same purpose).
    """
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(6, 2.4), dpi=110)
    else:
        fig = ax.figure

    t = result.timings or {}
    spans = {}
    for name in PHASE_NAMES:
        if name in t:
            arr = np.asarray(t[name], dtype=float)
            if k < arr.shape[1] and np.isfinite(arr[0, k]):
                spans[name] = (arr[0, k], arr[1, k])
    if not spans:
        raise ValueError(
            "result has no per-step phase spans; run it through "
            "hlc.run_with_plant (the host-driven loop) to record them"
        )
    t0 = min(s for s, _ in spans.values())
    for i, (name, (start, dur)) in enumerate(spans.items()):
        ax.barh(i, dur * 1e3, left=(start - t0) * 1e3, height=0.6,
                color=VEHICLE_COLORS[i % len(VEHICLE_COLORS)])
    ax.set_yticks(range(len(spans)))
    ax.set_yticklabels(list(spans))
    ax.set_xlabel("t [ms]")

    levels = np.asarray(result.infos.levels)[k]
    ax.set_title(
        f"step {k}: {int(levels.max())} computation level(s), "
        f"levels={levels.tolist()}",
        fontsize=8,
    )
    if path is not None:
        export_fig(fig, path)
    return ax


def plot_computation_time_per_vehicle(result, path=None, ax=None):
    """Bar chart of computation time over time steps.

    Reference: plot_computation_time_per_vehicle.m:1-26 (bar of the
    per-step time matrix; x = time step, y = seconds).
    """
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(6, 3), dpi=110)
    else:
        fig = ax.figure
    times = data_time_experiment(result)
    ax.bar(np.arange(1, len(times) + 1), times, color=VEHICLE_COLORS[0])
    ax.set_xlabel("Time step")
    ax.set_ylabel("Computation Time [s]")
    if path is not None:
        export_fig(fig, path)
    return ax


def plot_computation_time_over_vehicle_number(results, path=None, ax=None):
    """Boxplot of step times grouped by fleet size, log y-scale.

    Reference: plot_computation_time_over_vehicle_number.m:1-50 (boxchart
    per experiment at x = n_vehicles, YScale log, ms).
    Returns (n_vehicles, time_med, time_max) like the reference computes.
    """
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(5, 3.5), dpi=110)
    else:
        fig = ax.figure

    n_vehicles, med, mx, data, positions = [], [], [], [], []
    for r in results:
        times = data_time_experiment(r) * 1e3
        n_vehicles.append(r.options.amount)
        med.append(float(np.median(times)))
        mx.append(float(np.max(times)))
        data.append(times)
        positions.append(r.options.amount)
    ax.boxplot(data, positions=positions, widths=0.8)
    ax.set_yscale("log")
    ax.set_xlabel("Number of Vehicles")
    ax.set_ylabel("Computation Time [ms]")
    if path is not None:
        export_fig(fig, path)
    return np.array(n_vehicles), np.array(med), np.array(mx)


def series_plot_med_max(n_vehicles, median_value, maximum_value,
                        approach_names, ylabel="T [ms]", path=None, ax=None):
    """Grouped med/max bars per approach over fleet sizes.

    Reference: series_plot_med_max.m:1-60 (max bars behind med bars, legend
    "med <name>" / "max <name>").
    """
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(5.5, 3.5), dpi=110)
    else:
        fig = ax.figure
    n_vehicles = np.asarray(n_vehicles, dtype=float)
    median_value = np.atleast_2d(np.asarray(median_value, dtype=float).T).T
    maximum_value = np.atleast_2d(np.asarray(maximum_value, dtype=float).T).T
    n_app = median_value.shape[1]
    width = 0.8 / max(n_app, 1)
    for a in range(n_app):
        offs = (a - (n_app - 1) / 2) * width
        color = VEHICLE_COLORS[a % len(VEHICLE_COLORS)]
        ax.bar(n_vehicles + offs, maximum_value[:, a], width=width,
               color=color, alpha=0.35,
               label=f"max {approach_names[a]}")
        ax.bar(n_vehicles + offs, median_value[:, a], width=width,
               color=color, label=f"med {approach_names[a]}")
    ax.set_xlabel("Number of Vehicles")
    ax.set_ylabel(ylabel)
    ax.legend(ncol=2, fontsize=7, loc="upper left")
    if path is not None:
        export_fig(fig, path)
    return ax


def plot_mpa(mpa, k=0, with_labels=True, path=None, ax=None):
    """Draw the motion-primitive automaton: trim nodes + maneuver edges.

    Reference: plot_mpa.m:1-22 / MotionPrimitiveAutomaton.plot — trims laid
    out in (steering angle [deg], speed [m/s]) space, directed edges for
    the transitions allowed at step ``k`` of the horizon.
    """
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(4.5, 3.5), dpi=110)
    else:
        fig = ax.figure
    steer = np.degrees(np.asarray(mpa.trim_steering))
    speed = np.asarray(mpa.trim_speed)
    trans = np.asarray(mpa.transition[min(k, mpa.transition.shape[0] - 1)])
    n = len(speed)
    for i in range(n):
        for j in range(n):
            if not trans[i, j] or i == j:
                continue
            ax.annotate(
                "", xy=(steer[j], speed[j]), xytext=(steer[i], speed[i]),
                arrowprops=dict(arrowstyle="-|>", color="#888888", lw=0.7,
                                shrinkA=8, shrinkB=8),
            )
    ax.scatter(steer, speed, s=180, zorder=3, facecolor="white",
               edgecolor=VEHICLE_COLORS[0], lw=1.4)
    if with_labels:
        for i in range(n):
            ax.annotate(str(i + 1), (steer[i], speed[i]), ha="center",
                        va="center", fontsize=7, zorder=4)
    ax.set_xlabel("Steering Angle [deg]")
    ax.set_ylabel("Speed [m/s]")
    if path is not None:
        export_fig(fig, path)
    return ax


def plot_mpa_over_time(mpa, path=None):
    """One automaton panel per horizon step (time-varying transitions).

    Reference: plot_mpa_over_time.m — shows how recursive feasibility
    prunes transitions toward the end of the horizon.
    """
    hp = mpa.transition.shape[0]
    cols = min(hp, 4)
    rows = (hp + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 2.6 * rows),
                             dpi=110, squeeze=False)
    for k in range(hp):
        ax = axes[k // cols][k % cols]
        plot_mpa(mpa, k=k, with_labels=False, ax=ax)
        ax.set_title(f"step {k + 1}", fontsize=8)
    for k in range(hp, rows * cols):
        axes[k // cols][k % cols].axis("off")
    fig.tight_layout()
    if path is not None:
        export_fig(fig, path, preset="presentation")
    return fig


def plot_mpa_local_reachable_sets(mpa, trim=0, path=None, ax=None):
    """Per-horizon-step local reachable polygons for one start trim.

    Reference: plot_mpa_local_reachable_sets.m (offline reachability of
    MotionPrimitiveAutomaton, vehicle frame).
    """
    from matplotlib.patches import Polygon as MplPolygon

    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(4.5, 3.5), dpi=110)
    else:
        fig = ax.figure
    sets = np.asarray(mpa.local_reachable_sets_conv)[trim]  # [Hp, K, 2]
    for k in range(sets.shape[0]):
        ax.add_patch(MplPolygon(
            sets[k], closed=True, facecolor=VEHICLE_COLORS[k % len(
                VEHICLE_COLORS)], alpha=0.25,
            edgecolor=VEHICLE_COLORS[k % len(VEHICLE_COLORS)], lw=0.8,
        ))
    ax.autoscale_view()
    ax.relim()
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(f"local reachable sets, start trim {trim + 1}", fontsize=9)
    if path is not None:
        export_fig(fig, path)
    return ax


def plot_experiment_snapshots(result, step_indices, road=None,
                              n_figure_cols=2, path=None, **plot_kw):
    """Tiled grid of scenario frames at the given steps.

    Reference: plot_experiment_snapshots.m:1-70 (tiledlayout of
    PlotterOffline frames with lanelets).
    """
    n = len(step_indices)
    rows = (n + n_figure_cols - 1) // n_figure_cols
    fig, axes = plt.subplots(rows, n_figure_cols,
                             figsize=(4.0 * n_figure_cols, 3.6 * rows),
                             dpi=110, squeeze=False)
    for i, k in enumerate(step_indices):
        ax = axes[i // n_figure_cols][i % n_figure_cols]
        plot_step(ax, result.infos, k, road=road, **plot_kw)
    for i in range(n, rows * n_figure_cols):
        axes[i // n_figure_cols][i % n_figure_cols].axis("off")
    fig.tight_layout()
    if path is not None:
        export_fig(fig, path, preset="presentation")
    return fig


def plot_partitioned_graph(result, k, path=None, ax=None):
    """Coupling graph at step ``k``, colored by computation level, with
    sequential (solid) vs parallel (dashed) edges.

    Reference: plot_partitioned_graph.m (directed coupling digraph colored
    by group).
    """
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(4.5, 4.0), dpi=110)
    else:
        fig = ax.figure
    adjacency = np.asarray(result.infos.adjacency)[k]
    sequential = np.asarray(result.infos.directed_sequential)[k]
    levels = np.asarray(result.infos.levels)[k]
    poses = np.asarray(result.infos.poses)[k, :, 0]  # [N, 3]
    n = adjacency.shape[0]
    for i in range(n):
        for j in range(i + 1, n):
            if not adjacency[i, j]:
                continue
            style = "-" if (sequential[i, j] or sequential[j, i]) else "--"
            ax.plot([poses[i, 0], poses[j, 0]], [poses[i, 1], poses[j, 1]],
                    style, color="#777777", lw=0.9, zorder=1)
    for v in range(n):
        color = VEHICLE_COLORS[(int(levels[v]) - 1) % len(VEHICLE_COLORS)]
        ax.scatter(poses[v, 0], poses[v, 1], s=160, zorder=2,
                   facecolor=color, edgecolor="k", lw=0.6)
        ax.annotate(str(v + 1), (poses[v, 0], poses[v, 1]), ha="center",
                    va="center", fontsize=7, color="white", zorder=3)
    ax.set_aspect("equal")
    ax.set_title(f"coupling graph, step {k} "
                 f"({int(levels.max())} levels)", fontsize=9)
    if path is not None:
        export_fig(fig, path)
    return ax


def matrix_to_pgf_array(matrix, path, column_names=None) -> str:
    """Write a matrix as a pgfplots-readable whitespace table.

    Reference: eval/eval_phd/matrix_to_pgf_array.m (the pgf export format
    used by the dissertation plots).
    """
    matrix = np.atleast_2d(np.asarray(matrix, dtype=float))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        if column_names is not None:
            f.write(" ".join(str(c) for c in column_names) + "\n")
        for row in matrix:
            f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
    return path
