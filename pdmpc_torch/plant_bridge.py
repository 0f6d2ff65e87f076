"""Loopback plant bridge: drive the host loop from a separate plant process.

Torch twin of pdmpc_tpu/plant_bridge.py (numpy only). The reference's
CpmLab plant is driven by the lab middleware over DDS (plant/
CpmLab.m:230-284): an external process publishes vehicle states and
consumes the stamped VehicleCommandTrajectory messages the controller
writes. This module provides that integration without lab hardware: a
plant-server process holds the vehicle states and exchanges
newline-delimited JSON messages over a local TCP socket with the
controller process's :class:`pdmpc_torch.plant.ExternalPlant` callbacks.

Protocol (one JSON object per line, client-initiated request/response):

- ``{"type": "measure"}`` -> measurement arrays + the server-clock receive
  timestamp (``t_recv``).
- ``{"type": "command", "commands": [...]}`` -> the server applies the
  newest buffered trajectory point of each vehicle (perfect execution of
  the commanded trajectory, like plant/Simulation.m:86-117 but across a
  process boundary: position, heading, speed and steering angle, so the
  next measurement is the planned state exactly) and acks with its
  ``t_recv``.
- ``{"type": "end"}`` -> the server replies with its per-step command
  receive times and exits.

The server can run with an artificial clock offset (``clock_offset_s``) so
the cross-process timing normalization (eval/2-processing/
normalize_timing_results.m:28-60 -> :func:`pdmpc_torch.eval.processing.
normalize_timing_results`) runs on genuinely skewed clocks, as in the
20-NUC deployment.

Server entry point::

    python -m pdmpc_torch.plant_bridge --spec spec.json

where ``spec.json`` holds ``start_poses`` [N, 3], optional
``start_speeds`` [N], and optional ``clock_offset_s``. The server binds an
ephemeral port on 127.0.0.1 and prints ``PORT <n>`` on stdout;
:func:`launch_server` starts it and reads that line under a timeout.
"""

from __future__ import annotations

import json
import os
import select
import socket
import subprocess
import sys
import time

import numpy as np

from pdmpc_torch.plant import PlantMeasurement


class PlantServer:
    """Plant-side state holder (runs in the external process)."""

    def __init__(self, start_poses, start_speeds=None,
                 clock_offset_s: float = 0.0):
        self.poses = np.asarray(start_poses, dtype=float).copy()
        n = self.poses.shape[0]
        self.speeds = (
            np.zeros(n) if start_speeds is None
            else np.asarray(start_speeds, dtype=float).copy()
        )
        self.steering = np.zeros(n)
        self.clock_offset_s = clock_offset_s
        self.command_recv_times: list[float] = []

    def _now(self) -> float:
        return time.time() + self.clock_offset_s

    def handle(self, msg: dict) -> dict:
        if msg["type"] == "measure":
            return {
                "type": "measurement",
                "x": self.poses[:, 0].tolist(),
                "y": self.poses[:, 1].tolist(),
                "yaw": self.poses[:, 2].tolist(),
                "speed": self.speeds.tolist(),
                "steering": self.steering.tolist(),
                "t_recv": self._now(),
            }
        if msg["type"] == "command":
            t = self._now()
            self.command_recv_times.append(t)
            for cmd in msg["commands"]:
                v = cmd["vehicle"]
                # perfect execution of the newest appended trajectory
                # point (the controller's first predicted pose,
                # ExternalPlant.apply / CpmLab.m:252-269)
                p = cmd["points"][-1]
                self.poses[v] = (p["px"], p["py"], p["yaw"])
                self.speeds[v] = float(np.hypot(p["vx"], p["vy"]))
                self.steering[v] = p["steering"]
            return {"type": "ack", "t_recv": t}
        if msg["type"] == "end":
            return {
                "type": "bye",
                "command_recv_times": self.command_recv_times,
                "clock_offset_s": self.clock_offset_s,
            }
        return {"type": "error", "detail": f"unknown type {msg['type']!r}"}


def serve(spec: dict, sock: socket.socket) -> None:
    """Accept one controller connection and serve until end or EOF."""
    server = PlantServer(
        start_poses=spec["start_poses"],
        start_speeds=spec.get("start_speeds"),
        clock_offset_s=float(spec.get("clock_offset_s", 0.0)),
    )
    conn, _ = sock.accept()
    with conn, conn.makefile("rw", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            reply = server.handle(json.loads(line))
            f.write(json.dumps(reply) + "\n")
            f.flush()
            if reply["type"] == "bye":
                break


class PlantBridgeClient:
    """Controller-side socket client providing ExternalPlant callbacks;
    every socket operation times out after ``timeout_s``."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._f = self._sock.makefile("rw", encoding="utf-8")
        #: controller-clock posix time of each command send (the
        #: "(nearly) simultaneous event" used for clock alignment)
        self.command_send_times: list[float] = []

    def _rpc(self, msg: dict) -> dict:
        self._f.write(json.dumps(msg) + "\n")
        self._f.flush()
        line = self._f.readline()
        if not line:
            raise ConnectionError("plant server closed the connection")
        return json.loads(line)

    def measure_fn(self) -> PlantMeasurement:
        m = self._rpc({"type": "measure"})
        return PlantMeasurement(
            x=np.asarray(m["x"]),
            y=np.asarray(m["y"]),
            yaw=np.asarray(m["yaw"]),
            speed=np.asarray(m["speed"]),
            steering=np.asarray(m["steering"]),
        )

    def command_fn(self, commands: list[dict]) -> None:
        self.command_send_times.append(time.time())
        self._rpc({"type": "command", "commands": commands})

    def finish(self) -> dict:
        """End the session; returns the server's timing record."""
        try:
            return self._rpc({"type": "end"})
        finally:
            self._f.close()
            self._sock.close()


def launch_server(spec_path: str, timeout_s: float = 60.0):
    """Start ``python -m pdmpc_torch.plant_bridge --spec spec_path`` and
    wait up to ``timeout_s`` for its ``PORT <n>`` line. Returns (process,
    port); the caller ends the process. A server that does not report a
    port in time is killed and raises."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pdmpc_torch.plant_bridge", "--spec",
         spec_path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    line = proc.stdout.readline().strip() if ready else ""
    if not line.startswith("PORT "):
        proc.kill()
        _, err = proc.communicate(timeout=timeout_s)
        raise RuntimeError(f"plant server did not report a port within "
                           f"{timeout_s} s: {line!r} (stderr: {err[-500:]})")
    return proc, int(line.split()[1])


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--spec", required=True,
                        help="JSON file: start_poses, start_speeds, "
                             "clock_offset_s")
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args()

    with open(args.spec) as f:
        spec = json.load(f)

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((args.host, 0))
        sock.listen(1)
        print(f"PORT {sock.getsockname()[1]}", flush=True)
        serve(spec, sock)


if __name__ == "__main__":
    main()
