"""Where XLA:CPU fuses a multiply-add, the port fuses the same product.

The CPU goldens come from jitted JAX on XLA:CPU, which contracts some
``a * b + c`` into one fused multiply-add. For each such expression of
the planner, every placement of the fusion is evaluated exactly (product
exact in float64, the sum rounded to odd and then once to float32) and
compared with the jitted JAX expression on random float32 inputs shaped
as in the planner. The port's own placement (``geometry.fma``, which is
``torch.addcmul``) must match XLA everywhere; a rounded or other fused
placement does not.

    python -m tests.test_torch_numerics

prints the counts at 10^5 inputs an expression, and beside them the
places where no placement can match: XLA:CPU's vectorized f32 square
root, cosine and sine against torch's.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch.ops.geometry import fma

# One intra-op thread per process (see tests/test_torch_system.py).
torch.set_num_threads(1)

F32 = np.float32


def fma_exact(a, b, c):
    """float32 ``a * b + c`` rounded once: the product is exact in
    float64, and the float64 sum is rounded to odd (two-sum error term)
    before its rounding to float32, which avoids double rounding."""
    p = a.astype(np.float64) * b
    c = np.asarray(c, dtype=np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64)
    fix = (err != 0) & (bits % 2 == 0)
    bits = np.where(fix, bits + np.where((err > 0) == (s > 0), 1, -1), bits)
    return bits.view(np.float64).astype(F32)


def rounded(x):
    return np.asarray(x, dtype=np.float64).astype(F32)


def port_fma(a, b, c):
    return fma(*(torch.as_tensor(np.ascontiguousarray(x)) for x in
                 np.broadcast_arrays(a, b, c))).numpy()


def expressions(n, seed=0):
    """name -> (XLA output, {placement: float32 values}); the port's
    placement is listed first."""
    rng = np.random.default_rng(seed)
    b_, k = max(n // 1000, 1), 1000
    c = rng.uniform(-1, 1, (b_, 1)).astype(F32)
    s = rng.uniform(-1, 1, (b_, 1)).astype(F32)
    dx = rng.normal(0, 0.2, (b_, k)).astype(F32)
    dy = rng.normal(0, 0.2, (b_, k)).astype(F32)
    x0 = rng.uniform(0, 4.5, (b_, 1)).astype(F32)
    cb, sb, xb = (np.broadcast_to(v, dx.shape) for v in (c, s, x0))

    def plus_x(v):
        return rounded(v.astype(np.float64) + xb)

    out = {}
    jx, jy = jax.jit(lambda c, s, dx, dy, x: (c * dx - s * dy + x,
                                              s * dx + c * dy + x))(
        c, s, dx, dy, x0)
    sdy, cdx = rounded(sb.astype(np.float64) * dy), rounded(cb * dx.astype(
        np.float64))
    out["child x = c*dx - s*dy + x"] = (jx, {
        "port: fma(c, dx, -(s*dy)) + x": plus_x(port_fma(c, dx, -sdy)),
        "fma(-s, dy, c*dx) + x": plus_x(fma_exact(-sb, dy, cdx)),
        "rounded": plus_x(rounded(cdx.astype(np.float64) - sdy)),
    })
    sdx, cdy = rounded(sb.astype(np.float64) * dx), rounded(cb * dy.astype(
        np.float64))
    out["child y = s*dx + c*dy + y"] = (jy, {
        "port: fma(s, dx, c*dy) + y": plus_x(port_fma(s, dx, cdy)),
        "fma(c, dy, s*dx) + y": plus_x(fma_exact(cb, dy, sdx)),
        "rounded": plus_x(rounded(sdx.astype(np.float64) + cdy)),
    })

    g = rng.uniform(0, 3, (b_, 1)).astype(F32)
    pos = rng.uniform(0, 4, (b_, k, 2)).astype(F32)
    ref = rng.uniform(0, 4, (2,)).astype(F32)
    jg = jax.jit(lambda g, p, r: g + jnp.sum((p - r) ** 2, axis=-1))(
        g, pos, ref)
    d = pos - ref
    ex, ey = d[..., 0], d[..., 1]
    xx, yy = rounded(ex.astype(np.float64) * ex), rounded(
        ey.astype(np.float64) * ey)
    gb = np.broadcast_to(g, ex.shape).astype(np.float64)
    out["cost g + sum((p - ref)**2)"] = (jg, {
        "port: g + fma(dy, dy, dx*dx)": rounded(gb + port_fma(ey, ey, xx)),
        "g + fma(dx, dx, dy*dy)": rounded(gb + fma_exact(ex, ex, yy)),
        "rounded": rounded(gb + rounded(xx.astype(np.float64) + yy)),
    })

    # SAT projection of vertices [C, V] on axes [C, K] (the d = 2 einsum)
    m = max(n // 80, 1)
    axes = rng.normal(size=(m, 5, 2)).astype(F32)
    verts = rng.uniform(0, 4, (m, 16, 2)).astype(F32)
    jp = jax.jit(lambda a, v: jnp.einsum(
        "...kd,...vd->...kv", a, v, precision=jax.lax.Precision.HIGHEST))(
        axes, verts)
    ax, ay = axes[..., :, None, 0], axes[..., :, None, 1]
    px, py = verts[..., None, :, 0], verts[..., None, :, 1]
    axx = rounded(ax.astype(np.float64) * px)
    ayy = rounded(ay.astype(np.float64) * py)
    out["SAT projection einsum"] = (jp, {
        "port: fma(ay, y, ax*x)": port_fma(ay, py, axx),
        "fma(ax, x, ay*y)": fma_exact(*np.broadcast_arrays(ax, px, ayy)),
        "rounded": rounded(axx.astype(np.float64) + ayy),
    })

    # the sampled search's rollout policy: the step cost of every trim of a
    # rollout's fan [R, n], scaled by the temperature into logits
    # (ops/search.py plan_trajectory_sampled, :725-728), and the drawn
    # trim's cost added to the rollout's g (:741)
    fan = rng.uniform(0, 4, (m, 12, 2)).astype(F32)
    ref2 = rng.uniform(0, 4, (2,)).astype(F32)
    temperature = 0.01
    jl = jax.jit(lambda f, r: -((f[..., 0] - r[0]) ** 2
                                + (f[..., 1] - r[1]) ** 2) / temperature)(
        fan, ref2)
    gm = rng.uniform(0, 3, (m,)).astype(F32)
    child = rng.integers(0, 12, m)
    jgm = jax.jit(lambda g, f, r, c: g + (
        (f[..., 0] - r[0]) ** 2 + (f[..., 1] - r[1]) ** 2)[
            jnp.arange(f.shape[0]), c])(gm, fan, ref2, child)
    e = fan - ref2
    ex2, ey2 = e[..., 0], e[..., 1]
    xx2 = rounded(ex2.astype(np.float64) * ex2)
    yy2 = rounded(ey2.astype(np.float64) * ey2)
    d2 = {"port: fma(ex, ex, ey*ey)": port_fma(ex2, ex2, yy2),
          "fma(ey, ey, ex*ex)": fma_exact(ey2, ey2, xx2),
          "rounded": rounded(xx2.astype(np.float64) + yy2)}
    inv_t = F32(1) / F32(temperature)
    out["rollout logits -sum((fan - ref)**2) / T"] = (jl, {
        "port: -fma(ex, ex, ey*ey) * f32(1/T)": -d2[
            "port: fma(ex, ex, ey*ey)"] * inv_t,
        "-fma(ex, ex, ey*ey) / T": rounded(-d2[
            "port: fma(ex, ex, ey*ey)"].astype(np.float64)
            / F32(temperature)),
        "-fma(ey, ey, ex*ex) * f32(1/T)": -d2["fma(ey, ey, ex*ex)"] * inv_t,
        "-rounded * f32(1/T)": -d2["rounded"] * inv_t,
    })
    rows = np.arange(m)
    out["rollout cost g + fan_d2[child]"] = (jgm, {
        p: rounded(gm.astype(np.float64) + v[rows, child])
        for p, v in d2.items()})

    # FCA's SAT (geometry._sat_half): a rectangle's 4 axes on 4 vertices
    # by a Precision.HIGHEST matmul, vmapped over the rectangle pairs
    rect_axes = rng.normal(size=(m, 4, 2)).astype(F32)
    rects = rng.uniform(0, 4, (m, 4, 2)).astype(F32)
    jm = jax.jit(jax.vmap(lambda a, v: jnp.matmul(
        a, v.T, precision=jax.lax.Precision.HIGHEST)))(rect_axes, rects)
    ax, ay = rect_axes[..., :, None, 0], rect_axes[..., :, None, 1]
    px, py = rects[..., None, :, 0], rects[..., None, :, 1]
    axx = rounded(ax.astype(np.float64) * px)
    ayy = rounded(ay.astype(np.float64) * py)
    out["FCA SAT projection matmul"] = (jm, {
        "port: fma(ay, y, ax*x)": port_fma(*np.broadcast_arrays(ay, py, axx)),
        "fma(ax, x, ay*y)": fma_exact(*np.broadcast_arrays(ax, px, ayy)),
        "rounded": rounded(axx.astype(np.float64) + ayy),
    })
    return out


def ulp_sources(n, seed=0):
    """Mismatches of XLA:CPU's vectorized sqrt, cos and sin against
    torch's on n float32 inputs (no placement can repair these)."""
    rng = np.random.default_rng(seed)
    counts = {}
    x = rng.uniform(0, 20, n).astype(F32)
    counts["sqrt"] = int((np.asarray(jax.jit(jnp.sqrt)(x))
                          != torch.sqrt(torch.as_tensor(x)).numpy()).sum())
    a = rng.uniform(-3.2, 3.2, n).astype(F32)
    for name in ("cos", "sin"):
        want = np.asarray(jax.jit(getattr(jnp, name))(a))
        got = getattr(torch, name)(torch.as_tensor(a)).numpy()
        counts[name] = int((want != got).sum())
    return counts


@pytest.fixture(scope="module")
def forms():
    return expressions(20_000)


@pytest.mark.parametrize("name", ["child x = c*dx - s*dy + x",
                                  "child y = s*dx + c*dy + y",
                                  "cost g + sum((p - ref)**2)",
                                  "SAT projection einsum",
                                  "FCA SAT projection matmul",
                                  "rollout logits -sum((fan - ref)**2) / T",
                                  "rollout cost g + fan_d2[child]"])
def test_port_placement_matches_xla(forms, name):
    want, placements = forms[name]
    want = np.asarray(want)
    counts = {p: int((v != want).sum()) for p, v in placements.items()}
    port = next(p for p in counts if p.startswith("port:"))
    assert counts[port] == 0, counts
    # the input tells the placements apart
    assert all(v > 0 for p, v in counts.items() if p != port), counts


def test_fma_rounds_once():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 4099)).astype(F32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.normal(0, 1e-7, 4099))
         ).astype(F32)                                  # near cancellation
    c[::3] = rng.normal(size=c[::3].shape).astype(F32)
    np.testing.assert_array_equal(port_fma(a, b, c), fma_exact(a, b, c))


def main() -> int:
    for name, (want, placements) in expressions(100_000).items():
        want = np.asarray(want)
        print(json.dumps({"expression": name, "inputs": want.size,
                          "mismatches": {p: int((v != want).sum())
                                         for p, v in placements.items()}}))
    print(json.dumps({"xla_vs_torch_mismatches_of_200000":
                      ulp_sources(200_000)}))
    return 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())
