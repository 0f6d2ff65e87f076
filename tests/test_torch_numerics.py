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

XLA fuses by context: each expression is jitted alone and returns only
its result, and a step index that the reference's layer scan carries is
traced here too (the centralized heuristic's sum of squares, with a
constant step, fuses its squares; under the scan it rounds them).
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
    out.update(centralized_expressions(rng, m))
    out.update(hdv_expressions(rng, m))
    out.update(occupied_expressions(rng, m))
    return out


def add(a, b):
    return rounded(np.asarray(a, dtype=np.float64) + b)


def mul(a, b):
    return rounded(np.asarray(a, dtype=np.float64) * b)


def rotated_placements(c, s, px, py, x0, port_name):
    """x = c * px - s * py + x0 in its placements, the port's (fused on
    the c term) first."""
    sp, cp = mul(s, py), mul(c, px)
    return {
        port_name: add(port_fma(c, px, -sp), x0),
        "fma(-s, py, c*px) + x": add(fma_exact(*np.broadcast_arrays(
            -s, py, cp)), x0),
        "rounded": add(add(cp, -sp), x0),
    }


def square_sums(order, terms, fused=True):
    """Sums of squares of ``terms[name]`` in ``order``, one accumulator:
    each square fused in, ``acc = fma(z, z, acc)``, or rounded and
    added."""
    acc = None
    for name in order:
        z = terms[name]
        acc = (mul(z, z) if acc is None else fma_exact(z, z, acc) if fused
               else add(acc, mul(z, z)))
    return acc


def centralized_expressions(rng, m):
    """The joint search's new multiply-adds and sums
    (ops/search_centralized.py :105-125, :245-246) on [B, T, N] shapes."""
    out = {}
    b_, t_, n_, hp, k = max(m // 40, 1), 40, 3, 6, 1
    c = rng.uniform(-1, 1, (b_, 1, n_)).astype(F32)
    s = rng.uniform(-1, 1, (b_, 1, n_)).astype(F32)
    mdx = rng.normal(0, 0.2, (b_, t_, n_)).astype(F32)
    mdy = rng.normal(0, 0.2, (b_, t_, n_)).astype(F32)
    px = rng.uniform(0, 4.5, (b_, 1, n_)).astype(F32)
    ref = rng.uniform(0, 4, (n_, hp, 2)).astype(F32)
    g = rng.uniform(0, 3, (b_,)).astype(F32)
    d_max = np.cumsum(rng.uniform(0, 0.2, (n_, hp)), axis=-1).astype(F32)
    future = np.arange(hp) > k

    # one jitted function an expression, each returning only its own
    # result: what else a program returns moves XLA's fusion (a returned
    # ``short`` is rounded before the sum of squares reads it)
    jcx = np.asarray(jax.jit(lambda c, s, mdx, mdy, px: c * mdx - s * mdy
                             + px)(c, s, mdx, mdy, px))
    jcy = jcx[..., ::-1].copy()

    def step_cost(g, x, y, ref):
        dxr = x - ref[None, None, :, k, 0]
        dyr = y - ref[None, None, :, k, 1]
        return g[:, None] + jnp.sum(dxr ** 2 + dyr ** 2, axis=-1)

    def distance(x, y, ref):
        return jnp.sqrt((x[..., None] - ref[None, None, :, :, 0]) ** 2
                        + (y[..., None] - ref[None, None, :, :, 1]) ** 2)

    def heuristic(x, y, ref, d_max, k):
        # the step index is traced, as in the reference's layer scan (a
        # constant one folds the mask and fuses the squares instead)
        fut = jnp.arange(hp) > k
        short = jnp.maximum(0.0, distance(x, y, ref) - d_max[None, None])
        return jnp.sum(jnp.where(fut[None, None, None], short ** 2, 0.0),
                       axis=(-1, -2))

    jg = np.asarray(jax.jit(step_cost)(g, jcx, jcy, ref))
    jdist = np.asarray(jax.jit(distance)(jcx, jcy, ref))
    jh = np.asarray(jax.jit(heuristic)(jcx, jcy, ref, d_max, k))
    jshort = np.maximum(rounded(jdist.astype(np.float64) - d_max), F32(0))
    out["centralized child x = c*mdx - s*mdy + x"] = (jcx, rotated_placements(
        c, s, mdx, mdy, px, "port: fma(c, mdx, -(s*mdy)) + x"))

    dxr = jcx - ref[None, None, :, k, 0]
    dyr = jcy - ref[None, None, :, k, 1]
    terms = {f"{a}{i}": z[..., i] for i in range(n_)
             for a, z in (("dx", dxr), ("dy", dyr))}
    gb = g[:, None]
    out["centralized step cost g + sum_v((x-rx)**2 + (y-ry)**2)"] = (jg, {
        "port: g + acc, acc = fma(dx, dx, fma(dy, dy, acc))": add(
            gb, square_sums([f"{a}{i}" for i in range(n_)
                             for a in ("dy", "dx")], terms)),
        "g + sum_v fma(dy, dy, dx*dx)": add(gb, add(add(*(
            fma_exact(terms[f"dy{i}"], terms[f"dy{i}"],
                      mul(terms[f"dx{i}"], terms[f"dx{i}"]))
            for i in range(2))), fma_exact(terms["dy2"], terms["dy2"],
                                           mul(terms["dx2"], terms["dx2"])))),
        "g + acc, dx before dy": add(gb, square_sums(
            [f"{a}{i}" for i in range(n_) for a in ("dx", "dy")], terms)),
    })

    ex = jcx[..., None] - ref[:, :, 0]
    ey = jcy[..., None] - ref[:, :, 1]
    out["centralized heuristic sqrt((x-rx)**2 + (y-ry)**2)"] = (jdist, {
        "port: sqrt(fma(ex, ex, ey*ey))": np.sqrt(port_fma(ex, ex,
                                                           mul(ey, ey))),
        "sqrt(fma(ey, ey, ex*ex))": np.sqrt(fma_exact(ey, ey, mul(ex, ex))),
        "rounded": np.sqrt(add(mul(ex, ex), mul(ey, ey))),
    })
    shorts = {(i, j): jshort[..., i, j] for i in range(n_)
              for j in range(hp)}
    fut = [j for j in range(hp) if future[j]]
    by_vehicle = [(i, j) for i in range(n_) for j in fut]
    out["centralized heuristic sum over (N, Hp) of short**2"] = (jh, {
        "port: rounded squares, vehicle by vehicle, step by step":
            square_sums(by_vehicle, shorts, fused=False),
        "rounded squares, step by step": square_sums(
            [(i, j) for j in fut for i in range(n_)], shorts, fused=False),
        "fused, vehicle by vehicle": square_sums(by_vehicle, shorts),
    })

    # the backtracked path's swept areas [Hp, N, VA]
    cps = rng.uniform(-1, 1, (m, n_, 1)).astype(F32)
    sps = rng.uniform(-1, 1, (m, n_, 1)).astype(F32)
    ax = rng.normal(0, 0.2, (m, n_, 4)).astype(F32)
    ay = rng.normal(0, 0.1, (m, n_, 4)).astype(F32)
    ppx = rng.uniform(0, 4.5, (m, n_, 1)).astype(F32)
    jsx = np.asarray(jax.jit(lambda c, s, ax, ay, p: c * ax - s * ay + p)(
        cps, sps, ax, ay, ppx))
    out["centralized backtracked shape x = c*ax - s*ay + x"] = (
        jsx, rotated_placements(cps, sps, ax, ay, ppx,
                                "port: fma(c, ax, -(s*ay)) + x"))
    return out


def hdv_expressions(rng, m):
    """The HDV step's new multiply-adds: the shapes of the HDV apply
    (``_occupied_area`` of the reference poses) and the heading test of
    the directional coupling (is_hdv_behind.m). Each placement reads
    XLA's own cosines and sines, so only the placement is compared."""
    from pdmpc_tpu import controller as jctl

    out = {}
    poses = np.concatenate([rng.uniform(0, 4.5, (m, 2)),
                            rng.uniform(-np.pi, np.pi, (m, 1))],
                           axis=-1).astype(F32)
    js = np.asarray(jax.jit(jax.vmap(lambda p: jctl._occupied_area(
        p, 0.03)))(poses))                                  # [m, 4, 2]
    jcos, jsin = (np.asarray(jax.jit(f)(poses[:, 2]))[:, None]
                  for f in (jnp.cos, jnp.sin))
    local = np.asarray(jctl.geo.transformed_rectangle(
        0.0, 0.0, 0.0, jctl.VEHICLE_LENGTH + 0.06,
        jctl.VEHICLE_WIDTH + 0.06))                         # [4, 2]
    lx, ly = local[None, :, 0], local[None, :, 1]
    out["HDV shape x = c*lx - s*ly + x"] = (js[..., 0], rotated_placements(
        jcos, jsin, lx, ly, poses[:, 0:1], "port: fma(c, lx, -(s*ly)) + x"))

    n = max(int(m ** 0.5), 2)
    pg = poses[:n]
    jscal = np.asarray(jax.jit(lambda p: jnp.sum(
        jnp.stack([jnp.cos(p[:, 2]), jnp.sin(p[:, 2])], -1)[None]
        * (p[None, :, :2] - p[:, None, :2]), axis=-1))(pg))
    vec = pg[None, :, :2] - pg[:, None, :2]
    hx, hy = (np.broadcast_to(h[None, :n, 0], vec.shape[:2])
              for h in (jcos, jsin))
    vx, vy = vec[..., 0], vec[..., 1]
    out["HDV behind heading . (hdv - cav)"] = (jscal, {
        "port: fma(hy, vy, hx*vx)": port_fma(hy, vy, mul(hx, vx)),
        "fma(hx, vx, hy*vy)": fma_exact(hx, vx, mul(hy, vy)),
        "rounded": add(mul(hx, vx), mul(hy, vy)),
    })
    return out


def occupied_expressions(rng, m):
    """The step's vehicle rectangles: ``_occupied_area`` of the poses with
    the configuration's offset and without, vmapped as the reference's
    step computes them (its stand-still areas and successor family). Each
    placement reads XLA's own cosines and sines."""
    from pdmpc_tpu import controller as jctl

    out = {}
    poses = np.concatenate([rng.uniform(0, 4.5, (m, 2)),
                            rng.uniform(-np.pi, np.pi, (m, 1))],
                           axis=-1).astype(F32)
    c, s = (np.asarray(jax.jit(f)(poses[:, 2]))[:, None]
            for f in (jnp.cos, jnp.sin))
    for offset in (0.01, 0.0):
        js = np.asarray(jax.jit(jax.vmap(lambda p, o=offset: jctl.
                                         _occupied_area(p, o)))(poses))
        local = np.asarray(jctl.geo.transformed_rectangle(
            0.0, 0.0, 0.0, jctl.VEHICLE_LENGTH + 2 * offset,
            jctl.VEHICLE_WIDTH + 2 * offset))
        lx, ly = local[None, :, 0], local[None, :, 1]
        out[f"occupied x = c*lx - s*ly + x, offset {offset}"] = (
            js[..., 0], rotated_placements(
                c, s, lx, ly, poses[:, 0:1],
                "port: fma(c, lx, -(s*ly)) + x"))
        cl, sl = mul(c, ly), mul(s, lx)
        out[f"occupied y = s*lx + c*ly + y, offset {offset}"] = (
            js[..., 1], {
                "port: fma(s, lx, c*ly) + y": add(port_fma(s, lx, cl),
                                                  poses[:, 1:2]),
                "fma(c, ly, s*lx) + y": add(fma_exact(*np.broadcast_arrays(
                    c, ly, sl)), poses[:, 1:2]),
                "rounded": add(add(sl, cl), poses[:, 1:2]),
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


# the centralized search's and the HDV step's expressions
CENTRALIZED_AND_HDV = [
    "centralized child x = c*mdx - s*mdy + x",
    "centralized step cost g + sum_v((x-rx)**2 + (y-ry)**2)",
    "centralized heuristic sqrt((x-rx)**2 + (y-ry)**2)",
    "centralized heuristic sum over (N, Hp) of short**2",
    "centralized backtracked shape x = c*ax - s*ay + x",
    "HDV shape x = c*lx - s*ly + x",
    "HDV behind heading . (hdv - cav)",
]
# the step's vehicle rectangles (the stand-still areas and family)
OCCUPIED = [f"occupied {c}, offset {o}" for o in (0.01, 0.0)
            for c in ("x = c*lx - s*ly + x", "y = s*lx + c*ly + y")]


@pytest.fixture(scope="module")
def forms():
    return expressions(20_000)


@pytest.mark.parametrize("name", ["child x = c*dx - s*dy + x",
                                  "child y = s*dx + c*dy + y",
                                  "cost g + sum((p - ref)**2)",
                                  "SAT projection einsum",
                                  "FCA SAT projection matmul",
                                  "rollout logits -sum((fan - ref)**2) / T",
                                  "rollout cost g + fan_d2[child]",
                                  *CENTRALIZED_AND_HDV, *OCCUPIED])
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
