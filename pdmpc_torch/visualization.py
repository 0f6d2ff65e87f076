"""Visualization: offline replay + scenario/result plotting.

Torch twin of pdmpc_tpu/visualization.py (numpy and matplotlib).
Reference: visualization/Plotter.m (vehicles, trajectories, couplings,
lanelets, hotkeys), PlotterOnline.m (live loop fed by the /plotting topic),
PlotterOffline.m (replay of a saved ExperimentResult), plus
eval/3-plotting's export functions (export_fig / export_video presets).

The online plotter's ROS topic becomes the ``on_step`` observer hook of
the host-driven loop (hlc.run_with_plant); offline replay and exports are
matplotlib (headless-safe: importing this module selects the Agg
backend).
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
from matplotlib.patches import Polygon as MplPolygon

from pdmpc_torch.models.bicycle import VEHICLE_LENGTH, VEHICLE_WIDTH

# RWTH colors used by the reference's plots (visualization/rwth_color_*.m)
VEHICLE_COLORS = [
    "#00549F", "#CC071E", "#57AB27", "#F6A800", "#006165",
    "#A11035", "#BDCD00", "#612158", "#0098A1", "#E30066",
]


def _vehicle_rectangle(x, y, yaw, length=VEHICLE_LENGTH, width=VEHICLE_WIDTH):
    c, s = np.cos(yaw), np.sin(yaw)
    hx, hy = length / 2, width / 2
    local = np.array([[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]])
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([x, y])


def plot_lanelets(ax, road, color="#B8B8B8", lw=0.6):
    """Draw lanelet boundaries. Reference: visualization/plot_lanelets.m."""
    for ll in road.lanelets:
        ax.plot(ll.left[:, 0], ll.left[:, 1], color=color, lw=lw, zorder=1)
        ax.plot(ll.right[:, 0], ll.right[:, 1], color=color, lw=lw, zorder=1)


def plot_step(ax, infos, k, road=None, plot_limits=None,
              show_couplings=True, show_reachable=False,
              show_predictions=True):
    """Draw one time step (the Plotter.m per-frame content)."""
    poses = np.asarray(infos.poses)[k]        # [N, Hp, 3]
    n = poses.shape[0]

    ax.clear()
    ax.set_aspect("equal")
    if road is not None:
        plot_lanelets(ax, road)
    if plot_limits is not None:
        ax.set_xlim(*plot_limits[0])
        ax.set_ylim(*plot_limits[1])

    adjacency = np.asarray(infos.adjacency)[k]
    sequential = np.asarray(infos.directed_sequential)[k]
    for v in range(n):
        color = VEHICLE_COLORS[v % len(VEHICLE_COLORS)]
        x, y, yaw = poses[v, 0]
        rect = _vehicle_rectangle(x, y, yaw)
        ax.add_patch(
            MplPolygon(rect, closed=True, facecolor=color, edgecolor="k",
                       lw=0.5, zorder=3)
        )
        ax.annotate(str(v + 1), (x, y), fontsize=7, ha="center",
                    va="center", color="white", zorder=4)
        if show_predictions:
            ax.plot(poses[v, :, 0], poses[v, :, 1], color=color, lw=1.0,
                    alpha=0.8, zorder=2)

    if show_couplings:
        # coupling lines (visualization/plot_coupling_lines.m): solid =
        # sequential, dashed = parallel
        for i in range(n):
            for j in range(i + 1, n):
                if not adjacency[i, j]:
                    continue
                style = "-" if (sequential[i, j] or sequential[j, i]) else "--"
                ax.plot(
                    [poses[i, 0, 0], poses[j, 0, 0]],
                    [poses[i, 0, 1], poses[j, 0, 1]],
                    style, color="#555555", lw=0.8, zorder=2,
                )

    fallbacks = np.asarray(infos.needs_fallback)[k]
    title = f"step {k}"
    if fallbacks.any():
        title += f"  (fallbacks: {np.nonzero(fallbacks)[0] + 1})"
    ax.set_title(title, fontsize=9)


class PlotterOffline:
    """Replay of a saved ExperimentResult.

    Reference: visualization/PlotterOffline.m (step/playback controls; here:
    frame export + video export, the headless-capable subset).
    """

    def __init__(self, result, road=None, plot_limits=None):
        self.result = result
        self.road = road
        if plot_limits is None and road is not None:
            plot_limits = np.array([[0.0, 4.5], [0.0, 4.0]])
        self.plot_limits = plot_limits
        self.fig, self.ax = plt.subplots(figsize=(6, 5.5), dpi=110)

    @property
    def n_steps(self) -> int:
        return np.asarray(self.result.infos.poses).shape[0]

    def draw(self, k: int, **kw):
        plot_step(self.ax, self.result.infos, k, road=self.road,
                  plot_limits=self.plot_limits, **kw)

    def export_frame(self, k: int, path: str, **kw) -> str:
        """Reference: eval/3-plotting/export_frame.m."""
        self.draw(k, **kw)
        self.fig.savefig(path, bbox_inches="tight")
        return path

    def export_video(self, path: str, fps: int = 5, **kw) -> str:
        """Reference: eval/3-plotting/export_video.m (mp4/gif writer)."""
        from matplotlib.animation import FuncAnimation, PillowWriter

        anim = FuncAnimation(
            self.fig,
            lambda k: self.draw(k, **kw),
            frames=self.n_steps,
            interval=1000 // fps,
        )
        anim.save(path, writer=PillowWriter(fps=fps))
        return path


class PlotterOnline:
    """Live plotting loop fed by the control loop's ``on_step`` hook.

    Reference: visualization/PlotterOnline.m:86-100 (plotting loop fed by
    the /plotting DDS topic) + Plotter.m hotkeys. The DDS
    topic becomes the ``on_step(k, info)`` observer of
    ``hlc.run_with_plant``; pass an instance directly as ``on_step``.

    Hotkeys (active when a windowed matplotlib backend is in use, mirroring
    Plotter.m's key_pressed_callback):
      space  pause / resume the experiment loop
      c      toggle coupling lines
      p      toggle prediction trajectories
      escape / q  request experiment abort (the hook returns True and
                  run_with_plant stops, like the reference's ESC hotkey)

    Headless (Agg) use is safe: draws go to the in-memory canvas and no
    key events ever fire.
    """

    def __init__(self, road=None, plot_limits=None, pause_s: float = 0.001):
        if plot_limits is None and road is not None:
            plot_limits = np.array([[0.0, 4.5], [0.0, 4.0]])
        self.road = road
        self.plot_limits = plot_limits
        self.pause_s = pause_s
        self.show_couplings = True
        self.show_predictions = True
        self.paused = False
        self.stop_requested = False
        self.fig, self.ax = plt.subplots(figsize=(6, 5.5), dpi=110)
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self._interactive = matplotlib.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps", "template",
        )
        if self._interactive:
            plt.ion()
            self.fig.show()

    def _on_key(self, event) -> None:
        if event.key == " ":
            self.paused = not self.paused
        elif event.key == "c":
            self.show_couplings = not self.show_couplings
        elif event.key == "p":
            self.show_predictions = not self.show_predictions
        elif event.key in ("escape", "q"):
            self.stop_requested = True

    def __call__(self, k: int, info) -> bool:
        """on_step hook: draw step ``k``; returns True to abort the loop."""
        stacked = type(info)(*[np.asarray(x)[None] for x in info])
        plot_step(self.ax, stacked, 0, road=self.road,
                  plot_limits=self.plot_limits,
                  show_couplings=self.show_couplings,
                  show_predictions=self.show_predictions)
        self.ax.set_title(self.ax.get_title() + f"  [k={k}]", fontsize=9)
        if self._interactive:
            self.fig.canvas.draw_idle()
            plt.pause(self.pause_s)
            while self.paused and not self.stop_requested:
                plt.pause(0.05)
        else:
            self.fig.canvas.draw()
        return self.stop_requested

    def close(self) -> None:
        plt.close(self.fig)


def export_fig(fig, path: str, preset: str = "paper") -> str:
    """Size/style presets. Reference: eval/3-plotting/ExportFigConfig.m."""
    sizes = {
        "paper": (4.2, 3.2),
        "presentation": (8.0, 5.0),
        "video": (12.8, 7.2),
    }
    fig.set_size_inches(*sizes.get(preset, sizes["paper"]))
    fig.savefig(path, bbox_inches="tight", dpi=220)
    return path
