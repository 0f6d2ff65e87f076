"""Kinematic bicycle model and fixed-step integration.

Reference: hlc/model/differential_equations/BicycleModel.m:26-54 (Rajamani
formulation, 5 states: x, y, yaw, speed, steering; 2 inputs: steering
derivative, acceleration) and hlc/model/differential_equations/VehicleModel.m.

The reference integrates maneuvers with MATLAB ``ode45`` at RelTol 1e-8
(generate_maneuver.m:19-23). Maneuvers here are integrated offline with a
classical RK4 at sub-tick resolution, which matches ode45 far below the
framework's geometric tolerances; all online computation uses only the
precomputed maneuver tensors.
"""

from __future__ import annotations

import numpy as np

# CPM-lab vehicle geometry. Reference: scenarios/Vehicle.m:10-13.
VEHICLE_LENGTH = 0.22
VEHICLE_WIDTH = 0.1
LF = 0.1
LR = 0.1


def bicycle_ode(x: np.ndarray, u: np.ndarray, lf: float = LF,
                lr: float = LR) -> np.ndarray:
    """dx/dt of the kinematic bicycle. Reference: BicycleModel.m:26-54."""
    total_length = lf + lr
    ratio = lr / total_length
    psi, v_center, delta = x[2], x[3], x[4]
    steering_derivative, acceleration = u[0], u[1]
    beta = np.arctan(ratio * np.tan(delta))
    return np.array(
        [
            v_center * np.cos(psi + beta),
            v_center * np.sin(psi + beta),
            v_center / total_length * np.tan(delta) * np.cos(beta),
            acceleration,
            steering_derivative,
        ]
    )


# Identified muCar parameter vector (MuCar.m:5; vehicle paper
# https://doi.org/10.1016/j.ifacol.2020.12.1821)
MUCAR_P = np.array(
    [1.004582, -0.142938, 0.195236, 3.560576, -2.190728, -9.726828,
     2.515565, 1.321199, 0.032208, -0.012863]
)


def mucar_ode(x: np.ndarray, u: np.ndarray,
              p: np.ndarray = MUCAR_P) -> np.ndarray:
    """dx/dt of the identified CPM-lab muCar model.

    Reference: hlc/model/differential_equations/MuCar.m:26-35. 4 states
    (x, y, yaw, v), 2 inputs (motor command f, reference steering
    delta_ref). Defined for lab deployment parity; the MPA integrates the
    bicycle model like the reference does (MotionPrimitiveAutomaton.m).
    """
    yaw, v = x[2], x[3]
    f, delta_ref = u[0], u[1]
    delta = delta_ref + p[7]
    speed = p[0] * v * (1.0 + p[1] * delta**2)
    return np.array(
        [
            speed * np.cos(yaw + p[2] * delta + p[8]),
            speed * np.sin(yaw + p[2] * delta + p[8]),
            p[3] * v * delta,
            p[4] * v + p[5] * np.sign(f) * np.abs(f) ** p[6],
        ]
    )


def mucar_input_from_trim(speed: float, steering: float,
                          p: np.ndarray = MUCAR_P) -> np.ndarray:
    """Steady-state input (f, delta_ref) holding a trim.

    Reference: MuCar.compute_input_from_trim (MuCar.m:37-42), transcribed
    as-is (f = sign(v) * nthroot(p5/p6 * v, p7)); the steering line there
    references an undefined variable — the intended ``trim_in.steering``
    is used here.
    """
    f = np.sign(speed) * np.abs(p[4] / p[5] * speed) ** (1.0 / p[6])
    delta_ref = steering - p[7]
    return np.array([f, delta_ref])


def integrate_rk4(x0: np.ndarray, u: np.ndarray, duration: float,
                  n_points: int, substeps: int = 16) -> np.ndarray:
    """Integrate the bicycle ODE over ``duration`` with constant input ``u``.

    Returns states at ``n_points`` equally spaced times (including t=0),
    like the reference's ode45 call over ``linspace(0, dt, tick_per_step+1)``
    (generate_maneuver.m:19-23).
    """
    out = np.empty((n_points, x0.shape[0]))
    out[0] = x0
    x = x0.astype(np.float64).copy()
    h = duration / ((n_points - 1) * substeps)
    for i in range(1, n_points):
        for _ in range(substeps):
            k1 = bicycle_ode(x, u)
            k2 = bicycle_ode(x + 0.5 * h * k1, u)
            k3 = bicycle_ode(x + 0.5 * h * k2, u)
            k4 = bicycle_ode(x + h * k3, u)
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        out[i] = x
    return out
