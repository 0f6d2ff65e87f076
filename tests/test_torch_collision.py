"""pdmpc_torch.ops.collision against the reference's collision checks.

- The bundles equal pdmpc_tpu's (``precompute_outline`` /
  ``precompute_segments``) field for field, exactly.
- The plain versions (what the port runs on the CPU, and what the CUDA
  kernels are held to bit for bit on the card) are bit-equal to the XLA
  functions the CPU goldens were made with:
  ``candidate_outline_collisions`` and ``candidate_boundary_violations``.
- They are also held against the Pallas kernels in interpret mode
  (``outline_hits_pre`` / ``boundary_hits_pre``). Those compute the
  numerator in another form (b1 x s - a1 x s) and skip tiles by bounding
  box; the masks are compared and every disagreement is counted. On the
  inputs below there is none, so the test asserts equality; a
  disagreement would show as a failure with its count, not be hidden.
- The SAT check (convex path): ``sat_hits_plain`` and the
  reference-layout ``candidate_collisions`` are bit-equal to the XLA
  ``candidate_collisions`` on convex lattice inputs with exact touches,
  and equal to ``candidate_collisions_pallas`` (interpret mode, axes not
  normalized) on random convex polygons, which do not touch. The SAT
  bundle's vertices and mask equal the Pallas bundle's; its normalized
  axes and extents equal an exact float64 evaluation of the XLA form.

Inputs: maneuver areas of the real MPA on the trim lattice (candidates
of one beam node share their start-rectangle edges exactly, and some
obstacles ARE candidate polygons or share one candidate edge), random
polygons, and polygons padded to 16 vertices by repeating the last one
(degenerate edges, zero SAT axes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch.ops import collision as tc
from pdmpc_torch.ops import search as tsearch
from pdmpc_tpu.ops import pallas_collision as pk
from pdmpc_tpu.ops import search as jsearch
from tests.test_torch_numerics import fma_exact

# One intra-op thread per process: the suite runs in several pytest
# workers at once, and a full torch thread pool in each of them
# oversubscribes the cores (a file that takes seconds alone then takes
# minutes).
torch.set_num_threads(1)

VO = 16


def pad16(poly):
    return np.concatenate([poly, np.repeat(poly[-1:], VO - len(poly), 0)])


@pytest.fixture(scope="module")
def lattice():
    """Candidate swept areas [C, 6, 2] of the cr3 MPA at a few beam poses,
    obstacles [NO, 16, 2] and segments [S, 2, 2] with exact touches."""
    from pdmpc_tpu.config import Config
    from pdmpc_tpu.models.mpa import build_mpa

    cfg = Config(amount=3, T_end=4.0, beam_width=64).validate()
    mpa = build_mpa(cfg)
    rng = np.random.default_rng(0)
    ii, jj = np.nonzero(mpa.adjacency)
    base = mpa.area_nc[ii, jj]                         # [E, 6, 2] f64
    cands = []
    # three beam poses close together (touching lattices) and one far away
    for x, y, yaw in ((1.0, 1.0, 0.3), (1.05, 1.02, 0.3), (1.1, 0.95, -0.4),
                      (3.0, 2.5, 1.0)):
        c, s = np.cos(yaw), np.sin(yaw)
        cands.append(np.stack([c * base[..., 0] - s * base[..., 1] + x,
                               s * base[..., 0] + c * base[..., 1] + y], -1))
    cands = np.concatenate(cands).astype(np.float32)    # [C, 6, 2]
    c = len(cands)
    obs = [pad16(cands[i]) for i in rng.choice(c // 4, 6, replace=False)]
    for _ in range(10):
        n_v = rng.integers(3, 9)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n_v))
        r = rng.uniform(0.05, 0.2)
        center = rng.uniform(0.8, 1.3, 2)
        obs.append(pad16(center + r * np.stack([np.cos(ang), np.sin(ang)],
                                               -1)))
    obs = np.stack(obs).astype(np.float32)             # [16, 16, 2]
    obs_mask = rng.random(len(obs)) < 0.7
    obs_mask[:3] = True
    segs = rng.uniform(0.7, 1.4, size=(60, 1, 2)) + rng.normal(
        0, 0.1, size=(60, 2, 2))
    for s_i in range(0, 60, 3):                        # candidate edges
        poly = cands[rng.integers(c // 2)]
        k = rng.integers(6)
        segs[s_i] = [poly[k], poly[(k + 1) % 6]]
    segs[::7, 1] = segs[::7, 0]                        # degenerate segments
    seg_mask = rng.random(60) < 0.8
    return cands, obs, obs_mask, segs.astype(np.float32), seg_mask


def vertex_major(cands):
    t = torch.as_tensor(cands).permute(1, 2, 0)        # [6, 2, C]
    return t[None, :, 0].contiguous(), t[None, :, 1].contiguous()


def test_outline_bundle_equals_reference(lattice):
    _, obs, obs_mask, _, _ = lattice
    polys = np.stack([obs, obs[::-1]])                 # leading batch dim
    mask = np.stack([obs_mask, ~obs_mask])
    want = pk.precompute_outline(jnp.asarray(polys), jnp.asarray(mask))
    got = tc.precompute_outline(torch.as_tensor(polys),
                                torch.as_tensor(mask))
    for f in tc.OutlinePre._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_segment_bundle_equals_reference(lattice):
    *_, segs, seg_mask = lattice
    want = pk.precompute_segments(jnp.asarray(segs), jnp.asarray(seg_mask))
    got = tc.precompute_segments(torch.as_tensor(segs),
                                 torch.as_tensor(seg_mask))
    for f in tc.SegmentsPre._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("masked", ["some", "none", "all"])
def test_outline_plain_bit_equal_to_xla_and_pallas(lattice, masked):
    cands, obs, obs_mask, _, _ = lattice
    mask = {"some": obs_mask, "none": np.zeros_like(obs_mask),
            "all": np.ones_like(obs_mask)}[masked]
    xla = np.asarray(jsearch.candidate_outline_collisions(
        jnp.asarray(cands), jnp.asarray(obs), jnp.asarray(mask)))
    pre = tc.precompute_outline(torch.as_tensor(obs)[None],
                                torch.as_tensor(mask)[None])
    plain = tc.outline_hits_plain(*vertex_major(cands), pre)[0].numpy()
    np.testing.assert_array_equal(plain, xla)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        tc.outline_hits(*vertex_major(cands), pre)[0].numpy(), plain)
    jpre = pk.precompute_outline(jnp.asarray(obs), jnp.asarray(mask))
    pallas = np.asarray(pk.outline_hits_pre(
        jnp.asarray(cands[..., 0].T), jnp.asarray(cands[..., 1].T), jpre,
        interpret=True))
    disagree = int((pallas != plain).sum())
    assert disagree == 0, f"{disagree} candidates differ from the Pallas form"
    if masked == "some":
        assert 0 < plain.sum() < len(plain)            # non-trivial input


@pytest.mark.parametrize("masked", ["some", "all"])
def test_boundary_plain_bit_equal_to_xla_and_pallas(lattice, masked):
    cands, *_, segs, seg_mask = lattice
    mask = seg_mask if masked == "some" else np.ones_like(seg_mask)
    xla = np.asarray(jsearch.candidate_boundary_violations(
        jnp.asarray(cands), jnp.asarray(segs), jnp.asarray(mask)))
    pre = tc.precompute_segments(torch.as_tensor(segs)[None],
                                 torch.as_tensor(mask)[None])
    plain = tc.boundary_hits_plain(*vertex_major(cands), pre)[0].numpy()
    np.testing.assert_array_equal(plain, xla)
    np.testing.assert_array_equal(
        tc.boundary_hits(*vertex_major(cands), pre)[0].numpy(), plain)
    # the reference's Pallas boundary kernel, run in interpret mode
    jpre = pk.precompute_segments(jnp.asarray(segs), jnp.asarray(mask))
    pallas = np.asarray(pk.boundary_hits_pre(
        jnp.asarray(cands[..., 0].T), jnp.asarray(cands[..., 1].T), jpre,
        interpret=True))
    disagree = int((pallas != plain).sum())
    assert disagree == 0, f"{disagree} candidates differ from the Pallas form"
    assert 0 < plain.sum() < len(plain)


def test_reference_layout_entries(lattice):
    """search.candidate_*: the reference-layout entries of the port."""
    cands, obs, obs_mask, segs, seg_mask = lattice
    got = tsearch.candidate_outline_collisions(
        torch.as_tensor(cands), torch.as_tensor(obs),
        torch.as_tensor(obs_mask))
    want = jsearch.candidate_outline_collisions(
        jnp.asarray(cands), jnp.asarray(obs), jnp.asarray(obs_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tsearch.candidate_boundary_violations(
        torch.as_tensor(cands), torch.as_tensor(segs),
        torch.as_tensor(seg_mask))
    want = jsearch.candidate_boundary_violations(
        jnp.asarray(cands), jnp.asarray(segs), jnp.asarray(seg_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    segs_t, m_t = tsearch.polys_to_edge_segments(
        torch.as_tensor(obs), torch.as_tensor(obs_mask))
    segs_j, m_j = jsearch.polys_to_edge_segments(
        jnp.asarray(obs), jnp.asarray(obs_mask))
    np.testing.assert_array_equal(segs_t.numpy(), np.asarray(segs_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_predicate_matches_reference():
    rng = np.random.default_rng(1)
    d, a, b = rng.normal(size=(3, 4096)).astype(np.float32)
    a[::4] = d[::4] * np.float32(1.0 + 1e-4)            # on the band edge
    b[1::4] = -d[1::4] * np.float32(1e-4)
    d[::9] = 0.0
    want = jsearch._segment_cross_predicate(
        jnp.asarray(d), jnp.asarray(a), jnp.asarray(b))
    got = tc.segment_cross_predicate(*(torch.as_tensor(x) for x in (d, a, b)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def convex_lattice():
    """Convex candidate areas [C, 5, 2] of the circle MPA (straight
    maneuvers have 4 vertices and a repeat) at a few beam poses, convex
    obstacles [NO, 16, 2] padded by repeating their last vertex: some ARE
    candidates, some share exactly one candidate edge (an exact touch),
    some are random; plus a mask with some obstacles off."""
    from pdmpc_tpu.config import Config, ScenarioType
    from pdmpc_tpu.models.mpa import build_mpa

    cfg = Config(scenario_type=ScenarioType.circle, amount=3,
                 T_end=2.0).validate()
    mpa = build_mpa(cfg)
    rng = np.random.default_rng(2)
    ii, jj = np.nonzero(mpa.adjacency)
    base = mpa.area_conv[ii, jj]                       # [E, 5, 2] f64
    cands = []
    for x, y, yaw in ((1.0, 1.0, 0.0), (1.3, 1.0, 0.0), (1.1, 1.35, 1.2),
                      (3.0, 2.5, 2.0), (4.0, 0.5, 0.7)):
        c, s = np.cos(yaw), np.sin(yaw)
        cands.append(np.stack([c * base[..., 0] - s * base[..., 1] + x,
                               s * base[..., 0] + c * base[..., 1] + y], -1))
    cands = np.concatenate(cands).astype(np.float32)    # [C, 5, 2]
    c = len(cands)
    obs = [pad16(cands[i]) for i in rng.choice(c // 5, 5, replace=False)]
    for i in rng.choice(4 * c // 5, 8, replace=False):  # edge-sharing boxes
        poly = cands[i]
        k = int(rng.integers(4))
        a, b = poly[k].astype(np.float64), poly[k + 1].astype(np.float64)
        normal = np.array([b[1] - a[1], a[0] - b[0]])
        normal *= 0.3 / max(np.linalg.norm(normal), 1e-9)
        if np.dot(normal, a - poly.mean(0)) < 0:
            normal = -normal
        box = np.array([a, a + normal, b + normal, b], dtype=np.float32)
        box[0], box[3] = poly[k], poly[k + 1]          # exact shared edge
        obs.append(pad16(box))
    for _ in range(8):
        n_v = rng.integers(3, 9)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n_v))
        center = rng.uniform(0.9, 1.6, 2)
        obs.append(pad16(center + rng.uniform(0.05, 0.2) * np.stack(
            [np.cos(ang), np.sin(ang)], -1)))
    obs = np.stack(obs).astype(np.float32)             # [21, 16, 2]
    obs_mask = rng.random(len(obs)) < 0.6
    obs_mask[5:8] = True
    return cands, obs, obs_mask


def test_obstacle_bundle(convex_lattice):
    """Vertices and mask equal pdmpc_tpu's bundle field for field; the
    normalized axes and extents (the Pallas bundle's are not normalized)
    equal an exact float64 evaluation of the XLA form."""
    _, obs, obs_mask = convex_lattice
    polys = np.stack([obs, obs[::-1]])                 # leading batch dim
    mask = np.stack([obs_mask, ~obs_mask])
    want = pk.precompute_obstacles(jnp.asarray(polys), jnp.asarray(mask))
    got = tc.precompute_obstacles(torch.as_tensor(polys),
                                  torch.as_tensor(mask))
    for f in ("ox", "oy", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    ox, oy = np.asarray(want.ox), np.asarray(want.oy)
    ax, ay = np.asarray(want.oax), np.asarray(want.oay)  # unnormalized
    norm = np.maximum(np.sqrt(fma_exact(ay, ay, ax * ax).astype(np.float64))
                      .astype(np.float32), np.float32(1e-9))
    nax, nay = ax / norm, ay / norm
    np.testing.assert_array_equal(got.oax.numpy(), nax)
    np.testing.assert_array_equal(got.oay.numpy(), nay)
    proj = fma_exact(nay[..., None], oy[..., None, :],
                 nax[..., None] * ox[..., None, :])
    np.testing.assert_array_equal(got.omn.numpy(), proj.min(-1))
    np.testing.assert_array_equal(got.omx.numpy(), proj.max(-1))


def test_sat_separates_batch_matches_reference(convex_lattice):
    cands, obs, _ = convex_lattice
    a = cands[:, None]                                 # [C, 1, 5, 2]
    b = obs[None]                                      # [1, NO, 16, 2]
    want = np.asarray(jsearch._sat_separates_batch(jnp.asarray(a),
                                                   jnp.asarray(b)))
    got = tsearch._sat_separates_batch(torch.as_tensor(a),
                                       torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("masked", ["some", "none", "all"])
def test_sat_plain_bit_equal_to_xla(convex_lattice, masked):
    cands, obs, obs_mask = convex_lattice
    mask = {"some": obs_mask, "none": np.zeros_like(obs_mask),
            "all": np.ones_like(obs_mask)}[masked]
    xla = np.asarray(jsearch.candidate_collisions(
        jnp.asarray(cands), jnp.asarray(obs), jnp.asarray(mask)))
    pre = tc.precompute_obstacles(torch.as_tensor(obs)[None],
                                  torch.as_tensor(mask)[None])
    plain = tc.sat_hits_plain(*vertex_major(cands), pre)[0].numpy()
    np.testing.assert_array_equal(plain, xla)
    # the CPU wrapper is the plain version, and the reference-layout entry
    # goes through it
    np.testing.assert_array_equal(
        tc.sat_hits(*vertex_major(cands), pre)[0].numpy(), plain)
    np.testing.assert_array_equal(tsearch.candidate_collisions(
        torch.as_tensor(cands), torch.as_tensor(obs),
        torch.as_tensor(mask)).numpy(), plain)
    if masked == "none":
        assert not plain.any()
    else:
        assert 0 < plain.sum() < len(plain)            # non-trivial input


def rand_convex(rng, n, v, scale=1.0):
    """Random convex polygons as tests/test_pallas_collision.py draws
    them: sorted angles on a circle."""
    centers = rng.uniform(-3, 3, size=(n, 1, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, size=(n, v)), axis=1)
    r = rng.uniform(0.2, 0.6, size=(n, 1)) * scale
    return (centers + np.stack([r * np.cos(ang), r * np.sin(ang)], axis=-1)
            ).astype(np.float32)


@pytest.mark.parametrize("va", [5, 16])
def test_sat_plain_matches_pallas_on_random_convex(va):
    """The Pallas kernel (interpret mode) drops axis normalization; on
    random convex polygons, which do not touch, both forms agree."""
    rng = np.random.default_rng(64 + va)
    man = rand_convex(rng, 256, va)
    obs = rand_convex(rng, 11, 16, 1.5)
    mask = rng.random(11) < 0.7
    pallas = np.asarray(pk.candidate_collisions_pallas(
        jnp.asarray(man), jnp.asarray(obs), jnp.asarray(mask),
        interpret=True))
    pre = tc.precompute_obstacles(torch.as_tensor(obs)[None],
                                  torch.as_tensor(mask)[None])
    plain = tc.sat_hits_plain(*vertex_major(man), pre)[0].numpy()
    disagree = int((pallas != plain).sum())
    assert disagree == 0, f"{disagree} candidates differ from the Pallas form"
    assert 0 < plain.sum() < len(plain)


def test_wrappers_check_inputs(lattice):
    cands, obs, obs_mask, _, _ = lattice
    pre = tc.precompute_outline(torch.as_tensor(obs)[None],
                                torch.as_tensor(obs_mask)[None])
    cx, cy = vertex_major(cands)
    with pytest.raises(TypeError):
        tc.outline_hits(cx.double(), cy.double(), pre)
    with pytest.raises(ValueError):
        tc.outline_hits(cx[0], cy[0], pre)


# ---------------------------------------------------------------------------
# Lattice forms: one search layer's candidates built from the area table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def road_layer():
    """One search layer of the cr3 road MPA (its non-convex area tables and
    transitions) for 2 vehicles x 8 parent nodes, from a numpy seed:
    parents close together (neighbouring lattices touch), some obstacles
    ARE candidate polygons, some boundary segments ARE candidate edges of
    the no-offset and large-offset areas, plus random polygons and
    segments and degenerate ones; c, s given as f32 numbers to both
    sides."""
    from pdmpc_tpu.config import Config
    from pdmpc_tpu.models.mpa import build_mpa

    cfg = Config(amount=3, T_end=4.0, beam_width=64).validate()
    mpa = {k: np.asarray(v) for k, v in
           build_mpa(cfg).to_tensors_for(cfg)._asdict().items()}
    rng = np.random.default_rng(3)
    v, b = 2, 8
    n = mpa["area"].shape[0]
    trim = rng.integers(0, n, size=(v, b))
    pose = np.concatenate([rng.uniform(0.5, 2.5, (v, b, 2)),
                           rng.uniform(-0.5, 0.5, (v, b, 1))],
                          -1).astype(np.float32)
    c, s = np.cos(pose[..., 2:]), np.sin(pose[..., 2:])
    valid = rng.random((v, b)) < 0.8
    cand, no_off, large = (
        np.asarray(_xla_polys(mpa[k], trim, pose, c, s))
        for k in ("area", "area_no_offset", "area_large_offset"))
    obs = np.zeros((v, 12, VO, 2), np.float32)
    segs = rng.uniform(0.5, 2.5, (v, 40, 1, 2)) + rng.normal(
        0, 0.1, (v, 40, 2, 2))
    for i in range(v):
        for o, c_i in enumerate(rng.choice(b * n, 2, replace=False)):
            obs[i, o] = pad16(cand[i, c_i])
        for o in range(2, 12):
            n_v = rng.integers(3, 9)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n_v))
            obs[i, o] = pad16(rng.uniform(0.5, 2.5, 2) + rng.uniform(
                0.05, 0.15) * np.stack([np.cos(ang), np.sin(ang)], -1))
        for k in range(0, 40, 4):                       # candidate edges
            poly = (no_off if k % 2 else large)[i, rng.integers(b * n)]
            e = rng.integers(poly.shape[0])
            segs[i, k] = [poly[e], poly[(e + 1) % poly.shape[0]]]
    segs[:, 1::7, 1] = segs[:, 1::7, 0]                 # degenerate
    obs_mask = rng.random((v, 12)) < 0.7
    obs_mask[:, 0] = True
    seg_mask = rng.random((v, 40)) < 0.8
    return dict(mpa=mpa, trim=trim, pose=pose, c=c, s=s, valid=valid,
                obs=obs, obs_mask=obs_mask, segs=segs.astype(np.float32),
                seg_mask=seg_mask)


def _world(table, trim, pose, c, s):
    """[B*n, VA, 2] candidates of one vehicle's layer as pdmpc_tpu's XLA
    search path builds them (ops/search.py plan_trajectory,
    use_pallas=False); c, s [B, 1]."""
    n, _, va, _ = table.shape
    areas = table[trim]                                 # [B, n, VA, 2]
    ax = (c[:, :, None] * areas[..., 0]
          - s[:, :, None] * areas[..., 1] + pose[:, 0:1, None])
    ay = (s[:, :, None] * areas[..., 0]
          + c[:, :, None] * areas[..., 1] + pose[:, 1:2, None])
    return jnp.stack([ax, ay], axis=-1).reshape(trim.shape[0] * n, va, 2)


@jax.jit
def _xla_polys(table, trim, pose, c, s):
    """[V, B*n, VA, 2]: ``_world`` for each vehicle, jitted (XLA:CPU
    contracts its multiply-adds there, as in the search)."""
    return jax.vmap(_world, in_axes=(None, 0, 0, 0, 0))(table, trim, pose,
                                                         c, s)


@jax.jit
def _xla_feasible(area, bnd_table, trim, pose, c, s, valid, allowed, obs,
                  obs_mask, segs, seg_mask):
    """valid & allowed & ~(outline | boundary) for each vehicle, with the
    candidates built as pdmpc_tpu's XLA search path builds them
    (ops/search.py plan_trajectory, use_pallas=False)."""
    def one(trim, pose, c, s, valid, allowed, obs, obs_mask, segs,
            seg_mask):
        shape = allowed.shape
        collide = jsearch.candidate_outline_collisions(
            _world(area, trim, pose, c, s), obs, obs_mask).reshape(shape)
        crosses = jsearch.candidate_boundary_violations(
            _world(bnd_table, trim, pose, c, s), segs,
            seg_mask).reshape(shape)
        return valid[:, None] & allowed & ~(collide | crosses)

    return jax.vmap(one)(trim, pose, c, s, valid, allowed, obs, obs_mask,
                         segs, seg_mask)


def _port_layer(d, k):
    """The port's lattice, live mask and bundles of layer ``k``."""
    t = torch.tensor
    mpa = d["mpa"]
    hp = mpa["transition"].shape[0]
    trim = t(d["trim"])
    lat = tc.Lattice(t(mpa["area"]), trim, t(d["pose"]), t(d["c"]),
                     t(d["s"]))
    bnd = t(mpa["area_large_offset" if k == hp - 1 else "area_no_offset"])
    live = t(d["valid"])[..., None] & t(mpa["transition"][k])[trim]
    return (lat, lat._replace(table=bnd), live,
            tc.precompute_outline(t(d["obs"]), t(d["obs_mask"])),
            tc.precompute_segments(t(d["segs"]), t(d["seg_mask"])))


@pytest.mark.parametrize("layer", ["first", "last"])
def test_lattice_plain_bit_equal_to_xla(road_layer, layer):
    """The lattice forms chained as the search chains them (outline result
    as the boundary kernel's live mask) equal the XLA path's feasibility
    mask bit for bit; at the last layer the boundary check takes the
    large-offset areas. The candidates their plain versions build equal
    the XLA path's bit for bit."""
    d = road_layer
    hp = d["mpa"]["transition"].shape[0]
    k = 0 if layer == "first" else hp - 1
    lat, bnd_lat, live, out_pre, seg_pre = _port_layer(d, k)
    for lat_ in (lat, bnd_lat):
        cx, cy = tc.candidate_polys(*lat_)
        np.testing.assert_array_equal(
            torch.stack([cx, cy], -1).permute(0, 2, 1, 3).numpy(),
            np.asarray(_xla_polys(*(x.numpy() for x in lat_))))
    feasible = tc.outline_hits_lattice(lat, live, out_pre)
    np.testing.assert_array_equal(
        feasible.numpy(), tc.outline_hits_lattice_plain(lat, live, out_pre))
    got = tc.boundary_hits_lattice(bnd_lat, feasible, seg_pre)
    np.testing.assert_array_equal(
        got.numpy(), tc.boundary_hits_lattice_plain(bnd_lat, feasible,
                                                    seg_pre))
    mpa = d["mpa"]
    want = _xla_feasible(
        mpa["area"], mpa["area_large_offset" if k == hp - 1
                         else "area_no_offset"],
        d["trim"], d["pose"], d["c"], d["s"], d["valid"],
        mpa["transition"][k][d["trim"]], d["obs"], d["obs_mask"], d["segs"],
        d["seg_mask"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # non-trivial: each check rules out live candidates, some survive
    assert 0 < int(feasible.sum()) < int(live.sum())
    assert 0 < int(got.sum()) < int(feasible.sum())


@pytest.fixture(scope="module")
def circle_layer():
    """One search layer of the circle MPA (its convex area table and
    transitions) for 2 vehicles x 8 parent nodes, from a numpy seed:
    parents close together (neighbouring lattices touch); among the
    obstacles candidate polygons themselves (exact touches), boxes that
    share one candidate edge exactly (as chip_smoke.sat_inputs draws them)
    and random convex polygons, all padded to 16 vertices by repeating the
    last one, some of them masked."""
    from pdmpc_tpu.config import Config, ScenarioType
    from pdmpc_tpu.models.mpa import build_mpa

    cfg = Config(scenario_type=ScenarioType.circle, amount=3,
                 T_end=2.0).validate()
    mpa = {k: np.asarray(v) for k, v in
           build_mpa(cfg).to_tensors_for(cfg)._asdict().items()}
    rng = np.random.default_rng(5)
    v, b, n_obs = 2, 8, 14
    n = mpa["area"].shape[0]
    trim = rng.integers(0, n, size=(v, b))
    pose = np.concatenate([rng.uniform(0.5, 2.0, (v, b, 2)),
                           rng.uniform(-np.pi, np.pi, (v, b, 1))],
                          -1).astype(np.float32)
    c, s = np.cos(pose[..., 2:]), np.sin(pose[..., 2:])
    valid = rng.random((v, b)) < 0.8
    cand = np.asarray(_xla_polys(mpa["area"], trim, pose, c, s))
    obs = np.zeros((v, n_obs, VO, 2), np.float32)
    for i in range(v):
        picks = rng.choice(b * n, 6, replace=False)
        for o in range(2):
            obs[i, o] = pad16(cand[i, picks[o]])
        for o in range(2, 6):                          # edge-sharing boxes
            poly = cand[i, picks[o]]
            e = int(rng.integers(3))                   # a real edge
            a, b_ = poly[e].astype(np.float64), poly[e + 1].astype(np.float64)
            normal = np.array([b_[1] - a[1], a[0] - b_[0]])
            normal *= 0.1 / max(np.linalg.norm(normal), 1e-9)
            if np.dot(normal, a - poly.mean(0)) < 0:
                normal = -normal
            box = np.array([a, a + normal, b_ + normal, b_], np.float32)
            box[0], box[3] = poly[e], poly[e + 1]      # exact shared edge
            obs[i, o] = pad16(box)
        for o in range(6, n_obs):
            n_v = rng.integers(3, 9)
            ang = np.sort(rng.uniform(0, 2 * np.pi, n_v))
            obs[i, o] = pad16(rng.uniform(0.5, 2.0, 2) + rng.uniform(
                0.03, 0.1) * np.stack([np.cos(ang), np.sin(ang)], -1))
    obs_mask = rng.random((v, n_obs)) < 0.7
    obs_mask[:, 0] = True
    return dict(mpa=mpa, trim=trim, pose=pose, c=c, s=s, valid=valid,
                obs=obs, obs_mask=obs_mask)


@jax.jit
def _xla_sat_feasible(area, trim, pose, c, s, valid, allowed, obs,
                      obs_mask):
    """valid & allowed & ~candidate_collisions for each vehicle, with the
    candidates built as pdmpc_tpu's XLA search path builds them."""
    def one(trim, pose, c, s, valid, allowed, obs, obs_mask):
        collide = jsearch.candidate_collisions(
            _world(area, trim, pose, c, s), obs, obs_mask
        ).reshape(allowed.shape)
        return valid[:, None] & allowed & ~collide

    return jax.vmap(one)(trim, pose, c, s, valid, allowed, obs, obs_mask)


def _circle_port_layer(d, k):
    """The port's lattice, live mask and SAT bundle of layer ``k``."""
    t = torch.tensor
    trim = t(d["trim"])
    lat = tc.Lattice(t(d["mpa"]["area"]), trim, t(d["pose"]), t(d["c"]),
                     t(d["s"]))
    live = t(d["valid"])[..., None] & t(d["mpa"]["transition"][k])[trim]
    return lat, live, tc.precompute_obstacles(t(d["obs"]), t(d["obs_mask"]))


@pytest.mark.parametrize("layer", ["first", "last"])
def test_sat_lattice_bit_equal_to_xla(circle_layer, layer):
    """The SAT lattice form and its plain version equal the XLA path's
    ``valid & allowed & ~candidate_collisions`` bit for bit, on candidates
    that touch obstacles exactly."""
    d = circle_layer
    mpa = d["mpa"]
    k = 0 if layer == "first" else mpa["transition"].shape[0] - 1
    lat, live, pre = _circle_port_layer(d, k)
    got = tc.sat_hits_lattice(lat, live, pre)
    np.testing.assert_array_equal(
        got.numpy(), tc.sat_hits_lattice_plain(lat, live, pre).numpy())
    want = _xla_sat_feasible(
        mpa["area"], d["trim"], d["pose"], d["c"], d["s"], d["valid"],
        mpa["transition"][k][d["trim"]], d["obs"], d["obs_mask"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # non-trivial: the check rules out live candidates, some survive
    assert 0 < int(got.sum()) < int(live.sum())


KERNELS = ("outline_hits", "boundary_hits", "sat_hits")


def _kernel_layer(request, kernel, k):
    """Lattice, live mask and bundle of ``kernel``'s check at layer ``k``:
    the road layer for the crossing kernels (the boundary check on its
    boundary areas), the circle layer for SAT."""
    if kernel == "sat_hits":
        return _circle_port_layer(request.getfixturevalue("circle_layer"), k)
    lat, bnd_lat, live, out_pre, seg_pre = _port_layer(
        request.getfixturevalue("road_layer"), k)
    if kernel == "boundary_hits":
        return bnd_lat, live, seg_pre
    return lat, live, out_pre


@pytest.mark.parametrize("live_dtype", [torch.bool, torch.uint8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_lattice_forms_take_a_live_mask(request, kernel, live_dtype):
    """Candidates that are not live come out False; live ones equal ~hit
    of the (cx, cy) form on the same candidates; the (cx, cy) form with a
    live mask returns the same feasibility."""
    lat, _, pre = _kernel_layer(request, kernel, 1)
    rng = np.random.default_rng(4)
    v, b = lat.trim.shape
    n = lat.table.shape[0]
    live = torch.as_tensor(rng.random((v, b, n)) < 0.5)
    cx, cy = tc.candidate_polys(*lat)
    hit = getattr(tc, kernel)(cx, cy, pre).reshape(v, b, n)
    assert 0 < int((hit & live).sum()) < int(live.sum())
    got = getattr(tc, kernel + "_lattice")(lat, live.to(live_dtype), pre)
    assert got.dtype == torch.bool and got.shape == (v, b, n)
    assert not got[~live].any()
    assert torch.equal(got[live], ~hit[live])
    flat = getattr(tc, kernel)(cx, cy, pre,
                               live.reshape(v, -1).to(live_dtype))
    assert torch.equal(flat, got.reshape(v, -1))


@pytest.mark.parametrize("kernel", KERNELS)
def test_lattice_wrappers_check_inputs(request, kernel):
    lat, live, pre = _kernel_layer(request, kernel, 0)
    fn = getattr(tc, kernel + "_lattice")
    for bad in (dict(live=live[:, :-1]),                # shapes
                dict(live=live.float()),                # dtypes
                dict(lat=lat._replace(trim=lat.trim.int())),
                dict(lat=lat._replace(table=lat.table[:, :5])),
                dict(lat=lat._replace(c=lat.c.double())),
                dict(lat=lat._replace(pose=lat.pose[..., :2])),
                dict(live=live.to("meta")),             # mixed devices
                # one device, but not CUDA: no plain fallback
                dict(lat=tc.Lattice(*(x.to("meta") for x in lat)),
                     live=live.to("meta"))):
        args = dict(lat=lat, live=live, pre=pre) | bad
        with pytest.raises(ValueError):
            fn(**args)
    cx, cy = tc.candidate_polys(*lat)
    fn = getattr(tc, kernel)
    with pytest.raises(ValueError):
        fn(cx, cy, pre, live)                           # live not [V, C]
    with pytest.raises(ValueError):
        fn(cx, cy, pre, live.reshape(2, -1).float())
    with pytest.raises(ValueError):
        fn(cx.to("meta"), cy.to("meta"), pre)


# chip_smoke.py phase 13's oversize bundles and the main paths' largest
# stages: (kernel, obstacles or segments, entries staged, stage plan at the
# wrappers' budgets: entries a round, bytes, rounds at most)
STAGE_PLANS = [
    ("outline_hits", 256, 4096, (3072, 49152, 2)),
    ("outline_hits", 1024, 16384, (3072, 49152, 6)),
    ("outline_hits", 192, 3072, (3072, 49152, 1)),     # mixed-64
    ("outline_hits", 64, 1024, (1024, 16384, 1)),      # phase 2
    ("boundary_hits", 4096, 4096, (3072, 49152, 2)),
    ("boundary_hits", 16384, 16384, (3072, 49152, 6)),
    ("boundary_hits", 192, 192, (192, 3072, 1)),       # phase 2
    ("sat_hits", 128, 128, (124, 49104, 2)),           # circle-40
    ("sat_hits", 640, 640, (124, 49104, 6)),
    ("sat_hits", 32, 32, (32, 12672, 1)),              # phase 2
]


@pytest.mark.parametrize("kernel,count,entries,want", STAGE_PLANS)
def test_stage_plan(kernel, count, entries, want):
    """The wrappers stage a bundle in rounds of as many segments (16 B
    each) or SAT obstacles of 16 vertices (396 B each) as the 48 KB budget
    holds; the plan is host arithmetic, and each wrapper's bundle check
    hands the kernel that plan's entries a round."""
    entry = (tc.sat_stage_bytes(16) if kernel == "sat_hits"
             else tc.SEG_STAGE_BYTES)
    plan = tc.stage_plan(entries, entry)
    assert tc.stage_plan(entries, entry, tc.STAGE_BYTES) == plan
    assert tuple(plan) == want
    if kernel == "outline_hits":
        pre = tc.precompute_outline(torch.zeros((1, count, 16, 2)),
                                    torch.ones((1, count), dtype=torch.bool))
        cap = tc._outline_ptrs(pre, 1, -1)[3]
    elif kernel == "boundary_hits":
        pre = tc.precompute_segments(torch.zeros((1, count, 2, 2)),
                                     torch.ones((1, count), dtype=torch.bool))
        cap = tc._segment_ptrs(pre, 1, -1)[2]
    else:
        pre = tc.precompute_obstacles(torch.zeros((1, count, 16, 2)),
                                      torch.ones((1, count), dtype=torch.bool))
        cap = tc._obstacle_ptrs(pre, 1, -1)[3]
    assert cap == plan.cap
    # a larger budget takes fewer rounds, never more; out of range raises
    wider = tc.stage_plan(entries, entry, tc.MAX_STAGE_BYTES)
    assert wider.rounds <= plan.rounds and wider.bytes <= tc.MAX_STAGE_BYTES
    with pytest.raises(ValueError):
        tc.stage_plan(entries, entry, tc.MAX_STAGE_BYTES + 1)
    with pytest.raises(ValueError):
        tc.stage_plan(entries, entry, entry - 1)
