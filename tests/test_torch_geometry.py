"""pdmpc_torch.ops.geometry against pdmpc_tpu.ops.geometry on the same
float32 inputs (made with numpy from a seed).

Tolerance: floats within rtol 1e-6 and atol 1e-6 (a few f32 ulps at map
scale: the two packages may round cos/sin and the 2-wide support
contraction differently); booleans and the coupling decision
``area > 1e-3`` (controller.COUPLING_AREA_THRESHOLD) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch.ops import geometry as tgeo
from pdmpc_tpu.ops import geometry as jgeo

# One intra-op thread per process: the suite runs in several pytest
# workers at once, and a full torch thread pool in each of them
# oversubscribes the cores (a file that takes seconds alone then takes
# minutes).
torch.set_num_threads(1)

RTOL = ATOL = 1e-6
THRESHOLD = 1e-3


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def tensor(a):
    return torch.tensor(np.asarray(a))


def tangent_polys(rng, k, n_pts=24, k_dirs=16, spread=1.5):
    """[k, k_dirs, 2] f32 outer approximations of random point clouds —
    the shape of the reachable sets the coupling compares."""
    clouds = rng.uniform(-spread, spread, size=(k, n_pts, 2)).astype(
        np.float32)
    mask = jnp.ones((k, n_pts), dtype=bool)
    return np.array(jax.vmap(
        lambda p, m: jgeo.outer_poly_approx(p, m, k_dirs))(clouds, mask))


def square(cx, cy, half=1.0):
    return np.array([[cx - half, cy - half], [cx + half, cy - half],
                     [cx + half, cy + half], [cx - half, cy + half]],
                    dtype=np.float32)


def test_transforms():
    rng = np.random.default_rng(0)
    poly = rng.uniform(-1, 1, size=(64, 6, 2)).astype(np.float32)
    pose = rng.uniform([0, 0, -np.pi], [4.5, 4, np.pi],
                       size=(64, 3)).astype(np.float32)
    want = jax.vmap(jgeo.transform_polygon)(poly, pose[:, 0], pose[:, 1],
                                            pose[:, 2])
    got = tgeo.transform_polygon(tensor(poly), *tensor(pose).unbind(-1))
    close(got, want)
    want = jax.vmap(lambda p: jgeo.transformed_rectangle(
        p[0], p[1], p[2], 0.24, 0.12))(pose)
    got = tgeo.transformed_rectangle(*tensor(pose).unbind(-1), 0.24, 0.12)
    close(got, want)
    want = jgeo.rot_translate(pose[:, 2], pose[:, 0], pose[:, 1],
                              poly[:, 0, 0], poly[:, 0, 1])
    got = tgeo.rot_translate(*(tensor(x) for x in (
        pose[:, 2], pose[:, 0], pose[:, 1], poly[:, 0, 0], poly[:, 0, 1])))
    for g, w in zip(got, want):
        close(g, w)


def test_polygon_area_and_orientation():
    rng = np.random.default_rng(1)
    polys = tangent_polys(rng, 128)
    polys[::2] = polys[::2, ::-1]                       # clockwise half
    close(tgeo.polygon_area(tensor(polys)), jax.vmap(jgeo.polygon_area)(
        polys))
    close(tgeo._ccw(tensor(polys)), jax.vmap(jgeo._ccw)(polys))


def test_point_tests():
    rng = np.random.default_rng(2)
    polys = tangent_polys(rng, 64)
    pts = rng.uniform(-2, 2, size=(64, 32, 2)).astype(np.float32)
    want = jax.vmap(jax.vmap(jgeo.point_in_convex, in_axes=(0, None)))(
        pts, polys)
    got = tgeo.point_in_convex(tensor(pts), tensor(polys)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.vmap(jax.vmap(jgeo.point_in_ring, in_axes=(0, None)))(
        pts, polys)
    got = tgeo.point_in_ring(tensor(pts), tensor(polys)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_outer_poly_approx():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(32, 50, 2)).astype(np.float32)
    mask = rng.random((32, 50)) < 0.7
    want = jax.vmap(lambda p, m: jgeo.outer_poly_approx(p, m, 16))(pts, mask)
    close(tgeo.outer_poly_approx(tensor(pts), tensor(mask), 16), want)


def test_segment_intersection():
    rng = np.random.default_rng(4)
    p = rng.uniform(-1, 1, size=(4, 256, 2)).astype(np.float32)
    want_v, want_p = jax.vmap(jgeo._segment_intersection)(*p)
    got_v, got_p = tgeo._segment_intersection(*tensor(p))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    v = np.asarray(want_v)
    close(got_p[torch.tensor(v)], np.asarray(want_p)[v])


def coupling_pairs():
    """2048 random tangent-polygon pairs, plus touching and contained."""
    rng = np.random.default_rng(5)
    a = tangent_polys(rng, 2048)
    b = tangent_polys(rng, 2048) + rng.uniform(
        -2.5, 2.5, size=(2048, 1, 2)).astype(np.float32)
    pad = lambda p: np.concatenate(  # noqa: E731
        [p, np.repeat(p[-1:], 12, axis=0)])
    extra_a = [square(0, 0), square(0, 0), square(0, 0, 2.0), square(0, 0),
               square(0.3, -0.2, 1.7)]
    extra_b = [square(2, 0), square(2, 2), square(0, 0, 0.5),
               square(1.999, 0), square(0.3, -0.2, 1.7)]
    a = np.concatenate([a, np.stack([pad(x) for x in extra_a])])
    b = np.concatenate([b, np.stack([pad(x) for x in extra_b])])
    # contained reachable-set pairs: a shrunk copy inside each of 64 sets
    inner = a[:64] * np.float32(0.5)
    return (np.concatenate([a, a[:64]]).astype(np.float32),
            np.concatenate([b, inner]).astype(np.float32))


def test_coupling_area_and_decision():
    a, b = coupling_pairs()
    want = np.asarray(jax.jit(jax.vmap(jgeo.convex_intersection_area_clip))(
        a, b))
    got = tgeo.convex_intersection_area_clip(tensor(a), tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got > THRESHOLD, want > THRESHOLD)
    # the set holds both decisions, touching pairs among the uncoupled
    assert (want > THRESHOLD).any() and (want <= THRESHOLD).any()


@pytest.fixture(scope="module")
def road_inputs():
    """Reachable sets at the cr3 start poses and the drivable corridor of
    each vehicle's first eight loop lanelets (real map geometry)."""
    from pdmpc_tpu.config import Config
    from pdmpc_tpu.experiment import create_scenario
    from pdmpc_tpu.models.mpa import build_mpa

    cfg = Config(amount=3, T_end=4.0, beam_width=64).validate()
    mpa = build_mpa(cfg)
    sc = create_scenario(cfg, mpa)
    mpa_t = mpa.to_tensors_for(cfg)
    sc_t = sc.to_tensors()
    ids = np.array([list(dict.fromkeys(x))[:8] for x in sc.lanelet_indices])
    road = sc_t.road
    pose = np.asarray(sc_t.start_poses)
    rs = np.asarray(jax.vmap(lambda p, t: jgeo.transform_polygon(
        mpa_t.local_reachable_sets[t], p[0], p[1], p[2]))(
        sc_t.start_poses, sc_t.start_trims))           # [N, Hp, K, 2]
    return dict(
        rs=rs, pose=pose,
        rings=np.asarray(road.corridor_rings)[ids],
        segs=np.asarray(road.boundary_segments)[ids].reshape(3, -1, 2, 2),
        mask=np.asarray(road.boundary_seg_mask)[ids].reshape(3, -1),
        paths=np.asarray(sc_t.reference_paths),
        cumlen=np.asarray(sc_t.path_cumlen),
        is_loop=np.asarray(sc_t.is_loop),
    )


def test_bound_convex_to_corridor(road_inputs):
    r = road_inputs
    want = jax.vmap(lambda rs_hp, rings, segs, mask: jax.vmap(
        lambda p: jgeo.bound_convex_to_corridor(p, rings, segs, mask))(rs_hp))(
        r["rs"], r["rings"], r["segs"], r["mask"])
    got = tgeo.bound_convex_to_corridor(
        tensor(r["rs"]), tensor(r["rings"])[:, None],
        tensor(r["segs"])[:, None], tensor(r["mask"])[:, None])
    close(got, want)
    # the corridor really clips: some bounded set differs from its input
    assert not np.allclose(np.asarray(want), r["rs"])


def test_path_sampling(road_inputs):
    r = road_inputs
    rng = np.random.default_rng(6)
    pts = (r["pose"][:, :2] + rng.normal(0, 0.05, size=(3, 2))).astype(
        np.float32)
    want = jax.vmap(jgeo.project_to_polyline)(pts, r["paths"], r["cumlen"])
    got = tgeo.project_to_polyline(tensor(pts), tensor(r["paths"]),
                                   tensor(r["cumlen"]))
    close(got[0], want[0])
    close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    total = r["cumlen"][:, -1:]
    arcs = (rng.uniform(-0.2, 1.5, size=(3, 6)) * total).astype(np.float32)
    for loop in (r["is_loop"], np.zeros(3, dtype=bool)):
        want_p, want_i = jax.vmap(
            lambda p, a, c, l: jgeo.sample_path_at_arclength(
                p, a, c, l, return_indices=True))(
            r["paths"], arcs, r["cumlen"], loop)
        got_p, got_i = tgeo.sample_path_at_arclength(
            tensor(r["paths"]), tensor(arcs), tensor(r["cumlen"]),
            tensor(loop))
        close(got_p, want_p)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    close(tgeo.path_cumlen(tensor(r["paths"])),
          jax.vmap(jgeo.path_cumlen)(r["paths"]))


def test_path_sampling_past_the_end_of_two_point_paths():
    """The circle scenario's reference paths are two-point segments
    through the center; by T_end the vehicles run past their end, and
    projection and sampling take the non-loop branch there."""
    from pdmpc_tpu.config import Config, ScenarioType
    from pdmpc_tpu.experiment import create_scenario
    from pdmpc_tpu.models.mpa import build_mpa

    cfg = Config(scenario_type=ScenarioType.circle, amount=5,
                 T_end=8.0).validate()
    sc_t = create_scenario(cfg, build_mpa(cfg)).to_tensors()
    paths = np.asarray(sc_t.reference_paths)
    cumlen = np.asarray(sc_t.path_cumlen)
    is_loop = np.asarray(sc_t.is_loop)
    assert paths.shape[1] == 2 and not is_loop.any()
    rng = np.random.default_rng(7)
    total = cumlen[:, -1:]
    # before the start, along the path, at its end and well past it
    arcs = (np.concatenate([rng.uniform(-0.2, 1.0, size=(5, 4)),
                            np.ones((5, 1)),
                            rng.uniform(1.0, 1.6, size=(5, 5))], axis=1)
            * total).astype(np.float32)
    want_p, want_i = jax.vmap(
        lambda p, a, c, l: jgeo.sample_path_at_arclength(
            p, a, c, l, return_indices=True))(paths, arcs, cumlen, is_loop)
    got_p, got_i = tgeo.sample_path_at_arclength(
        tensor(paths), tensor(arcs), tensor(cumlen), tensor(is_loop))
    close(got_p, want_p)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # positions beyond the end of the path project onto its last point
    pts = (paths[:, -1] + (paths[:, -1] - paths[:, 0]) * 0.3
           + rng.normal(0, 0.05, size=(5, 2))).astype(np.float32)
    want = jax.vmap(jgeo.project_to_polyline)(pts, paths, cumlen)
    got = tgeo.project_to_polyline(tensor(pts), tensor(paths),
                                   tensor(cumlen))
    close(got[0], want[0])
    close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
