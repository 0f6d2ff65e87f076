"""The rest of the geometry API of pdmpc_torch.ops.geometry (SAT, the
InterX test, the sorted-vertex intersection area, bounding boxes, masked
areas, corridor bounds with ``k_dirs``) against pdmpc_tpu.ops.geometry on
the same float32 inputs, made with numpy from a seed. The JAX functions
run as tests/test_geometry.py runs them: eagerly on one object, or
vmapped and jitted on a batch.

Tolerance: masks and bounding boxes exactly; areas within rtol 1e-6 and
atol 1e-7 m² (the angle sort's atan2 and the shoelace sum may round a
last bit differently, which can swap two points whose angles nearly tie
and moves the area only in its last bits); corridor bounds within rtol
and atol 1e-6 (tests/test_torch_geometry.py's tolerance for the same
support fit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch.ops import geometry as tgeo
from pdmpc_tpu.ops import geometry as jgeo

# One intra-op thread per process (see tests/test_torch_geometry.py).
torch.set_num_threads(1)

AREA_RTOL, AREA_ATOL = 1e-6, 1e-7


def t(a):
    return torch.tensor(np.asarray(a))


def square(cx, cy, half=1.0):
    return np.array([[cx - half, cy - half], [cx + half, cy - half],
                     [cx + half, cy + half], [cx - half, cy + half]],
                    dtype=np.float32)


def padded(poly, n=4):
    return np.concatenate([poly, np.repeat(poly[-1:], n, axis=0)])


def f32(a):
    return np.asarray(a, dtype=np.float32)


TRI_APART = f32([[2.5, 0.0], [4.0, 1.5], [4.0, 0.0]])
TRI_CROSS = f32([[0.5, 0.0], [4.0, 1.5], [4.0, 0.0]])

# tests/test_geometry.py's TestSat cases, plus exact touches
SAT_CASES = {
    "overlapping": (square(0, 0), square(1, 1)),
    "disjoint": (square(0, 0), square(5, 5)),
    "contained": (square(0, 0, 3.0), square(0, 0, 0.5)),
    "diagonal_apart": (square(0, 0), TRI_APART),
    "diagonal_cross": (square(0, 0), TRI_CROSS),
    "padded_apart": (padded(square(0, 0)), padded(square(5, 5))),
    "padded_self": (padded(square(0, 0)), padded(square(0, 0))),
    "edge_touch": (square(0, 0), square(2, 0)),
    "corner_touch": (square(0, 0), square(2, 2)),
}


@pytest.mark.parametrize("case", sorted(SAT_CASES))
def test_sat_collide_cases(case):
    a, b = SAT_CASES[case]
    want = bool(jgeo.sat_collide(jnp.asarray(a), jnp.asarray(b)))
    assert bool(tgeo.sat_collide(t(a), t(b))) == want
    assert bool(tgeo.sat_collide(t(b), t(a))) == want


def test_sat_collide_pairwise_case():
    polys = np.stack([square(0, 0), square(1, 0), square(10, 10)])
    want = np.asarray(jgeo.sat_collide_pairwise(polys, polys))
    got = tgeo.sat_collide_pairwise(t(polys), t(polys)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.array([[1, 1, 0], [1, 1, 0], [0, 0, 1]], dtype=bool))


def grid_polys(rng, n):
    """[n, 6, 2] convex polygons with integer vertices on a 6 x 6 grid:
    axis-aligned boxes and right triangles with 45-degree hypotenuses,
    padded by repeating the last vertex, so that many pairs touch exactly
    along an edge or at a corner."""
    out = np.zeros((n, 6, 2), dtype=np.float32)
    for i in range(n):
        x0, y0 = rng.integers(0, 5, 2)
        w = rng.integers(1, 3)
        if i % 2:
            h = rng.integers(1, 3)
            poly = [[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]]
        else:
            poly = [[x0, y0], [x0 + w, y0], [x0, y0 + w]]
        out[i] = padded(f32(poly), 6 - len(poly))
    return out


def random_convex(rng, n, n_pts=24, k_dirs=8, spread=1.5):
    """[n, k_dirs, 2] convex polygons: the supports of random point clouds
    in k_dirs directions (TestIntersectionAreaClip's construction)."""
    ang = np.linspace(0, 2 * np.pi, k_dirs, endpoint=False)
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    clouds = rng.uniform(-spread, spread, size=(n, n_pts, 2))
    idx = np.argmax(clouds @ dirs.T, axis=1)                 # [n, k_dirs]
    return f32(np.take_along_axis(clouds, idx[..., None], axis=1))


@pytest.mark.parametrize("inputs", ["grid", "random"])
def test_sat_collide_pairwise_batch(inputs):
    rng = np.random.default_rng(11)
    if inputs == "grid":
        a, b = grid_polys(rng, 48), grid_polys(rng, 40)
    else:
        a = random_convex(rng, 48)
        b = random_convex(rng, 40) + f32(rng.uniform(-2.5, 2.5, (40, 1, 2)))
    want = np.asarray(jax.jit(jgeo.sat_collide_pairwise)(a, b))
    got = tgeo.sat_collide_pairwise(t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size
    if inputs == "grid":
        # exact touches among the hits: x extents that meet end to end
        touch = a[:, :, 0].max(1)[:, None] == b[:, :, 0].min(1)[None]
        assert (touch & want).any()


SEGMENT_CASES = {
    "crossing": (f32([[0, 0], [2, 2]]), f32([[0, 2], [2, 0]]), None),
    "parallel_disjoint": (f32([[0, 0], [2, 0]]), f32([[0, 1], [2, 1]]),
                          None),
    "masked": (f32([[0, 0], [2, 2], [0, 2]]), f32([[0.2, 1.8], [1.8, 0.2]]),
               np.array([False, True])),
    "unmasked": (f32([[0, 0], [2, 2], [0, 2]]),
                 f32([[0.2, 1.8], [1.8, 0.2]]), None),
    "end_touch": (f32([[0, 0], [1, 1]]), f32([[1, 1], [3, 0]]), None),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segments_intersect_any_cases(case):
    a, b, mask_a = SEGMENT_CASES[case]
    want = bool(jgeo.segments_intersect_any(
        jnp.asarray(a), jnp.asarray(b),
        mask_a=None if mask_a is None else jnp.asarray(mask_a)))
    got = tgeo.segments_intersect_any(
        t(a), t(b), mask_a=None if mask_a is None else t(mask_a))
    assert bool(got) == want


def test_segments_intersect_any_batch():
    rng = np.random.default_rng(12)
    n = 256
    a = f32(rng.uniform(0, 4, (n, 7, 2)))
    b = f32(rng.uniform(0, 4, (n, 5, 2)))
    b[::4, 1] = a[::4, 2]                       # a shared vertex
    mask_a = rng.random((n, 6)) < 0.4
    mask_b = rng.random((n, 4)) < 0.6
    want = np.asarray(jax.vmap(jgeo.segments_intersect_any)(
        a, b, mask_a, mask_b))
    got = tgeo.segments_intersect_any(t(a), t(b), t(mask_a),
                                      t(mask_b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < n
    want = np.asarray(jax.vmap(jgeo.segments_intersect_any)(a, b))
    np.testing.assert_array_equal(
        tgeo.segments_intersect_any(t(a), t(b)).numpy(), want)


# TestIntersectionArea's and TestIntersectionAreaClip's cases
AREA_CASES = {
    "half_overlap": (square(0, 0), square(1, 0)),
    "disjoint": (square(0, 0), square(5, 5)),
    "contained": (square(0, 0, 2.0), square(0, 0, 0.5)),
    "sliver": (square(0, 0), square(1.999, 0)),
    "identical": (square(0.3, -0.2, 1.7), square(0.3, -0.2, 1.7)),
    "padded": (padded(square(0, 0)), square(1, 0)),
    "edge_touch": (square(0, 0), square(2, 0)),
}


@pytest.mark.parametrize("case", sorted(AREA_CASES))
def test_convex_intersection_area_cases(case):
    a, b = AREA_CASES[case]
    want = float(jgeo.convex_intersection_area(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = float(tgeo.convex_intersection_area(t(a), t(b)))
    assert got == pytest.approx(want, rel=AREA_RTOL, abs=AREA_ATOL)


def test_cases_match_sorted_version():
    """TestIntersectionAreaClip's check in the port: the clip area agrees
    with the sorted-vertex area on its four cases (atol 1e-4, as
    there)."""
    for name in ("half_overlap", "disjoint", "contained", "sliver"):
        a, b = (t(x) for x in AREA_CASES[name])
        assert float(tgeo.convex_intersection_area_clip(a, b)) == \
            pytest.approx(float(tgeo.convex_intersection_area(a, b)),
                          abs=1e-4)


def test_convex_intersection_area_random_pairs():
    """TestIntersectionAreaClip.test_random_convex_pairs' inputs, the
    reference vmapped and run op by op, as TestIntersectionArea runs it:
    the port rounds each product as the reference's expression reads
    (``_segment_intersection``'s numerators and its point ``p1 + t*r``).
    Jitted, XLA:CPU fuses some of those multiply-adds, which moves a
    sliver's area by up to 2e-6 m² (the port's coupling uses the clip
    area, whose fused products are mapped)."""
    rng = np.random.default_rng(42)
    k = 256
    area = jax.vmap(jgeo.convex_intersection_area)
    a = random_convex(rng, k)
    b = random_convex(rng, k) + f32(rng.uniform(-1, 1, size=(k, 1, 2)))
    want = np.asarray(area(a, b))
    got = tgeo.convex_intersection_area(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=AREA_RTOL, atol=AREA_ATOL)
    clip = tgeo.convex_intersection_area_clip(t(a), t(b)).numpy()
    np.testing.assert_allclose(clip, got, atol=2e-4)
    # and pairs shifted further apart: partly disjoint
    b = b + f32(rng.uniform(-3, 3, size=(k, 1, 2)))
    want = np.asarray(area(a, b))
    got = tgeo.convex_intersection_area(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=AREA_RTOL, atol=AREA_ATOL)
    assert (want == 0).any() and (want > 0.1).any()


def test_polygon_bbox_and_overlap():
    rng = np.random.default_rng(13)
    polys = np.concatenate([grid_polys(rng, 32),
                            f32(rng.uniform(0, 6, (32, 6, 2)))])
    want = jax.vmap(jgeo.polygon_bbox)(polys)
    got = tgeo.polygon_bbox(t(polys))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pair = jax.vmap(jax.vmap(jgeo.bboxes_overlap, in_axes=(None, 0)),
                    in_axes=(0, None))
    want_o = np.asarray(pair(tuple(want), tuple(want)))
    got_o = tgeo.bboxes_overlap(tuple(x[:, None] for x in got),
                                tuple(x[None] for x in got)).numpy()
    np.testing.assert_array_equal(got_o, want_o)
    assert 0 < want_o.sum() < want_o.size
    # inclusive on touch
    one, two = tgeo.polygon_bbox(t(square(0, 0))), tgeo.polygon_bbox(
        t(square(2, 2)))
    assert bool(tgeo.bboxes_overlap(one, two))
    assert bool(jgeo.bboxes_overlap(jgeo.polygon_bbox(square(0, 0)),
                                    jgeo.polygon_bbox(square(2, 2))))


def test_polygon_area_with_mask():
    """Arbitrary padding: 3 to 10 valid vertices of a convex polygon, then
    arbitrary points, which the mask marks invalid."""
    rng = np.random.default_rng(14)
    polys = random_convex(rng, 128, k_dirs=10)
    mask = np.arange(10) < rng.integers(3, 11, size=(128, 1))
    polys = np.where(mask[..., None], polys,
                     f32(rng.uniform(-9, 9, polys.shape)))
    want = np.asarray(jax.vmap(jgeo.polygon_area)(polys, mask))
    got = tgeo.polygon_area(t(polys), t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=AREA_RTOL, atol=AREA_ATOL)
    # masking changes areas (the arbitrary points are dropped)
    assert not np.allclose(want, np.asarray(jax.vmap(jgeo.polygon_area)(
        polys)))
    # one polygon, no batch dims
    assert float(tgeo.polygon_area(t(polys[5]), t(mask[5]))) == \
        pytest.approx(float(want[5]), rel=AREA_RTOL, abs=AREA_ATOL)


@pytest.mark.parametrize("k_dirs", [None, 8, 24])
def test_bound_convex_to_corridor_k_dirs(k_dirs):
    """A corridor of two rings (a strip and a box, padded) and its
    boundary segments; polygons crossing it, inside it and away from it
    (an empty intersection, which keeps the polygon, refitted to
    ``k_dirs`` vertices)."""
    rng = np.random.default_rng(15)
    strip = padded(f32([[0, 0], [6, 0], [6, 1], [0, 1], [0, 0]]), 3)
    box = padded(f32([[2, 1], [3, 1], [3, 3], [2, 3], [2, 1]]), 3)
    rings = np.stack([strip, box])                           # [2, 8, 2]
    segs = np.stack([np.stack([r[:4], r[1:5]], axis=1) for r in rings]
                    ).reshape(-1, 2, 2)                      # [8, 2, 2]
    seg_mask = np.ones(8, dtype=bool)
    polys = random_convex(rng, 24, k_dirs=16, spread=0.8) + f32(
        rng.uniform([0, -0.5], [6, 3.5], (24, 1, 2)))
    polys[-2:] += f32([20, 20])                              # away
    want = np.asarray(jax.vmap(lambda p: jgeo.bound_convex_to_corridor(
        p, rings, segs, seg_mask, k_dirs=k_dirs))(polys))
    got = tgeo.bound_convex_to_corridor(t(polys), t(rings), t(segs),
                                        t(seg_mask), k_dirs=k_dirs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got.shape == (24, k_dirs or 16, 2)
    # the corridor clips some polygons; the ones away keep their own shape
    bounded = np.asarray(jax.vmap(jgeo.outer_poly_approx, in_axes=(
        0, None, None))(polys, np.ones(16, dtype=bool), k_dirs or 16))
    assert not np.allclose(want[:-2], bounded[:-2], atol=1e-3)
    if k_dirs is not None:
        np.testing.assert_allclose(want[-2:], bounded[-2:], atol=1e-5)


def test_corridor_card_limit_covers_cos_sin_ulps(monkeypatch):
    """chip_smoke.py phase 20a holds the card's corridor bounds to the
    CPU's within ``CORRIDOR_ATOL``. Of the support fit's ops only cos and
    sin are not correctly rounded on both devices; with each of their
    results moved by up to 2 ulps (20 seeded draws), phase 20a's bounds
    stay within that limit of the exact ones."""
    import chip_smoke as cs

    inp = cs.geometry_inputs()
    args = (t(f32(inp["blobs"])), t(f32(inp["rings"])), t(f32(inp["segs"])),
            torch.ones(inp["segs"].shape[0], dtype=torch.bool))
    want = tgeo.bound_convex_to_corridor(*args, k_dirs=24)
    cos, sin = torch.cos, torch.sin
    worst = 0.0
    for draw in range(20):
        gen = torch.Generator().manual_seed(draw)

        def off(fn):
            def moved(x):
                y = fn(x)
                steps = torch.randint(-2, 3, y.shape, generator=gen)
                for _ in range(2):
                    y = torch.where(steps != 0, torch.nextafter(
                        y, steps.sign() * torch.tensor(np.inf)), y)
                    steps = steps - steps.sign()
                return y
            return moved

        monkeypatch.setattr(torch, "cos", off(cos))
        monkeypatch.setattr(torch, "sin", off(sin))
        got = tgeo.bound_convex_to_corridor(*args, k_dirs=24)
        monkeypatch.undo()
        worst = max(worst, float((got - want).abs().max()))
    assert 0.0 < worst <= cs.CORRIDOR_ATOL
