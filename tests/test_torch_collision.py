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

Inputs: maneuver areas of the real MPA on the trim lattice (candidates
of one beam node share their start-rectangle edges exactly, and some
obstacles ARE candidate polygons), random polygons, and polygons padded
to 16 vertices by repeating the last one (degenerate edges).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdmpc_torch.ops import collision as tc
from pdmpc_torch.ops import search as tsearch
from pdmpc_tpu.ops import pallas_collision as pk
from pdmpc_tpu.ops import search as jsearch

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


def test_wrappers_check_inputs(lattice):
    cands, obs, obs_mask, _, _ = lattice
    pre = tc.precompute_outline(torch.as_tensor(obs)[None],
                                torch.as_tensor(obs_mask)[None])
    cx, cy = vertex_major(cands)
    with pytest.raises(TypeError):
        tc.outline_hits(cx.double(), cy.double(), pre)
    with pytest.raises(ValueError):
        tc.outline_hits(cx[0], cy[0], pre)
