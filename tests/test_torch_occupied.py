"""The step's vehicle rectangles equal the reference's bit for bit.

XLA:CPU fuses the rotation of the reference's ``_occupied_area`` in the
step (the stand-still areas, the standstill family) as in its HDV apply:
x = fma(c, lx, -(s * ly)) + px, y = fma(s, lx, c * ly) + py
(``python -m tests.test_torch_numerics`` maps it). The port computes the
rectangles in that form (``controller._occupied_area``). On random poses,
with XLA's own cosines and sines fed to both, the port's rectangles equal
the reference's, where the rotation with each product rounded (the
port's form before) parts from them. With each package's own cosines and
sines, the coordinates left apart are those of poses whose cosine or sine
differs between XLA:CPU's vectorized f32 and torch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch import controller as ctl
from pdmpc_tpu import controller as jctl

torch.set_num_threads(1)

N_POSES = 2000          # 16,000 coordinates


def poses(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 4.5, (N_POSES, 2)),
                           rng.uniform(-np.pi, np.pi, (N_POSES, 1))],
                          axis=-1).astype(np.float32)


def reference(p, offset):
    return np.asarray(jax.jit(jax.vmap(
        lambda q: jctl._occupied_area(q, offset)))(p))


def xla_cos_sin(p):
    return (torch.as_tensor(np.array(jax.jit(f)(p[:, 2])))
            for f in (jnp.cos, jnp.sin))


@pytest.mark.parametrize("offset", [0.01, 0.0])
def test_fused_rotation_equals_reference(offset):
    p = poses()
    want = reference(p, offset)
    c, s = xla_cos_sin(p)
    pt = torch.as_tensor(p)
    got = ctl._rotated_rectangle(pt, c, s, offset).numpy()
    assert got.shape == want.shape == (N_POSES, 4, 2)
    np.testing.assert_array_equal(got, want)

    # the fault the fused form repairs: each product rounded
    hx = (ctl.VEHICLE_LENGTH + 2 * offset) / 2.0
    hy = (ctl.VEHICLE_WIDTH + 2 * offset) / 2.0
    lx = torch.tensor([-hx, hx, hx, -hx])
    ly = torch.tensor([-hy, -hy, hy, hy])
    cc, ss = c[:, None], s[:, None]
    rounded = torch.stack([cc * lx - ss * ly + pt[:, 0:1],
                           ss * lx + cc * ly + pt[:, 1:2]], dim=-1).numpy()
    n_rounded = int((rounded != want).sum())
    print(f"offset {offset}: rounded products part in {n_rounded} of "
          f"{want.size} coordinates, the fused form in 0")
    assert n_rounded > 0


@pytest.mark.parametrize("offset", [0.01, 0.0])
def test_own_cos_sin_part_only_where_they_differ(offset):
    p = poses(1)
    want = reference(p, offset)
    got = ctl._occupied_area(torch.as_tensor(p), offset).numpy()
    c, s = xla_cos_sin(p)
    yaw = torch.as_tensor(p[:, 2])
    differs = ((torch.cos(yaw) != c) | (torch.sin(yaw) != s)).numpy()
    apart = (got != want).any(axis=(1, 2))
    print(f"offset {offset}: {int((got != want).sum())} of {want.size} "
          f"coordinates apart, at {int(apart.sum())} poses; cos or sin "
          f"differs at {int(differs.sum())} poses")
    assert not (apart & ~differs).any()
