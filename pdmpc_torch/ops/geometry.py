"""Batched polygon geometry on tensors.

Torch twin of pdmpc_tpu/ops/geometry.py. Where the JAX functions are
written for one object and vmapped by callers, these take leading batch
dims directly (one object is the case of no batch dims). Conventions are
the reference's: a polygon is ``[..., V, 2]`` float32, padded by
repeating its last valid vertex; repeated vertices make zero-length
edges that every function here treats as inert.

Arithmetic is written op by op in the reference's order, and every 2-wide
contraction (the reference's ``Precision.HIGHEST`` matmuls) is spelled out
as ``x * a + y * b``: no TF32, so CPU and CUDA runs round the same way and
discrete decisions (coupling, corridor membership) follow the reference.
Where the reference's XLA:CPU code contracts a product into a fused
multiply-add in the search (poses, costs, SAT projections) and in the
distance weights, the port calls :func:`fma` at that place instead
(tests/test_torch_numerics.py finds the placements).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-9
_FUSED_DEVICES: set[str] = set()


def _check_fused(device: torch.device) -> None:
    """Raise unless ``torch.addcmul`` rounds once on ``device``: with
    a = b = 1 + 2**-12 and c = -1, the fused result is 2**-11 + 2**-24 and
    the twice-rounded one 2**-11 (1031 elements: vector body and tail)."""
    a = torch.full((1031,), 1.0 + 2.0 ** -12, device=device)
    got = torch.addcmul(torch.full_like(a, -1.0), a, a)
    if not bool((got == 2.0 ** -11 + 2.0 ** -24).all()):
        raise RuntimeError(f"torch.addcmul is not a fused multiply-add on "
                           f"{device}; the port's numerics need one")
    _FUSED_DEVICES.add(str(device))


def fma(a, b, c):
    """``a * b + c`` rounded once (f32), as XLA:CPU's contracted
    multiply-adds: ``torch.addcmul``, checked once per device to be
    fused."""
    if str(c.device) not in _FUSED_DEVICES:
        _check_fused(c.device)
    return torch.addcmul(c, a, b)


def _roll_prev(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.roll(x, -1, axis=dim)``: element i holds x[i + 1] (cyclic)."""
    return torch.roll(x, -1, dims=dim)


def rot_translate(dyaw, dx, dy, xs, ys):
    """Rotate by dyaw then translate by (dx, dy). Reference: translate_global.m."""
    c, s = torch.cos(dyaw), torch.sin(dyaw)
    return c * xs - s * ys + dx, s * xs + c * ys + dy


def transform_polygon(poly, x, y, yaw):
    """Rigid transform of polygons ``[..., V, 2]`` by poses ``x, y, yaw``
    whose shape is the polygons' leading batch shape."""
    c = torch.cos(yaw)[..., None]
    s = torch.sin(yaw)[..., None]
    px, py = poly[..., 0], poly[..., 1]
    return torch.stack(
        [c * px - s * py + x[..., None], s * px + c * py + y[..., None]],
        dim=-1,
    )


def transformed_rectangle(x, y, yaw, length: float, width: float):
    """Rectangles [..., 4, 2] centered at (x, y) rotated by yaw (CCW)."""
    hx, hy = length / 2.0, width / 2.0
    local = torch.tensor(
        [[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]], dtype=torch.float32,
        device=x.device,
    )
    return transform_polygon(local.expand(*x.shape, 4, 2), x, y, yaw)


def polygon_area(poly, mask=None):
    """Shoelace area of polygons [..., V, 2] (pad-by-repeat vertices add
    0). ``mask`` [..., V] marks the valid vertices of an arbitrary
    padding: each invalid one is replaced by the last valid vertex."""
    if mask is not None:
        idx = torch.arange(poly.shape[-2], device=poly.device)
        last = torch.argmax(torch.where(mask, idx, -1), dim=-1)
        last_pt = torch.gather(
            poly, -2, last[..., None, None].expand(*last.shape, 1, 2))
        poly = torch.where(mask[..., None], poly, last_pt)
    x, y = poly[..., 0], poly[..., 1]
    xn, yn = _roll_prev(x, -1), _roll_prev(y, -1)
    return 0.5 * torch.abs(torch.sum(x * yn - xn * y, dim=-1))


def point_in_convex(p, poly):
    """True where points ``p`` [..., 2] lie inside convex polygons
    ``poly`` [..., V, 2] (orientation-agnostic, boundary tolerance 1e-6)."""
    edges = _roll_prev(poly, -2) - poly
    rel = p[..., None, :] - poly
    cross = edges[..., 0] * rel[..., 1] - edges[..., 1] * rel[..., 0]
    tol = 1e-6
    return (torch.all(cross >= -tol, dim=-1)
            | torch.all(cross <= tol, dim=-1))


def _segment_intersection(p1, p2, q1, q2):
    """Intersections of segments p1-p2 and q1-q2 (broadcast batch dims).

    Returns (valid, point). Degenerate zero-length segments are invalid.
    """
    r = p2 - p1
    s = q2 - q1
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q1 - p1
    par = torch.abs(denom) < _EPS
    safe = torch.where(par, torch.ones_like(denom), denom)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    valid = ~par & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    return valid, p1 + t[..., None] * r


def sat_axes(x, y, dim: int):
    """Normalized edge normals (XLA form) of polygons whose vertex
    coordinates ``x, y`` run along ``dim``: edge i -> i+1 (cyclic) gives
    (-ey, ex) / max(|.|, 1e-9)."""
    ax = -(torch.roll(y, -1, dims=dim) - y)
    ay = torch.roll(x, -1, dims=dim) - x
    norm = torch.clamp_min(torch.sqrt(fma(ay, ay, ax * ax)), 1e-9)
    return ax / norm, ay / norm


def sat_project(ax, ay, x, y):
    """Projection of vertices (x, y) on axes (ax, ay), as XLA:CPU
    evaluates the reference's d = 2 contractions (its einsum and its
    matmul alike): fma(ay, y, ax * x)."""
    return fma(ay, y, ax * x)


def sat_separated(a, b):
    """[...] True where convex polygons a [..., VA, 2] and b [..., VB, 2]
    (broadcastable batch dims) are separated by an edge normal of either
    (intersect_sat.m): on an axis, ``min(pa) - max(pb) > 0`` or ``min(pb)
    - max(pa) > 0``. Zero axes (repeated vertices) never separate. The
    one SAT expression of the package's torch ops, in the XLA form that
    the SAT kernel mirrors (``sat_axes``, ``sat_project``)."""

    def separated_on(axes):
        ax, ay = axes[0][..., :, None], axes[1][..., :, None]
        pa = sat_project(ax, ay, a[..., None, :, 0], a[..., None, :, 1])
        pb = sat_project(ax, ay, b[..., None, :, 0], b[..., None, :, 1])
        d1 = pa.amin(dim=-1) - pb.amax(dim=-1)
        d2 = pb.amin(dim=-1) - pa.amax(dim=-1)
        return ((d1 > 0) | (d2 > 0)).any(dim=-1)

    return (separated_on(sat_axes(a[..., 0], a[..., 1], -1))
            | separated_on(sat_axes(b[..., 0], b[..., 1], -1)))


def sat_collide(a, b):
    """True where convex polygons a [..., VA, 2] and b [..., VB, 2]
    overlap; touching counts (the separation test is strict).
    Reference: intersect_sat.m."""
    return ~sat_separated(a, b)


def sat_collide_pairwise(a, b):
    """[..., NA, NB] ``sat_collide`` of every polygon of a [..., NA, VA, 2]
    with every polygon of b [..., NB, VB, 2]."""
    return sat_collide(a[..., :, None, :, :], b[..., None, :, :, :])


def segments_intersect_any(path_a, path_b, mask_a=None, mask_b=None):
    """True where a segment of polyline ``path_a`` [..., NA, 2] meets one
    of ``path_b`` [..., NB, 2]; ``mask_a`` [..., NA - 1] and ``mask_b``
    [..., NB - 1] mark the valid segments. The InterX test
    (hlc/optimizer/graph_search/InterX.m)."""
    valid, _ = _segment_intersection(
        path_a[..., :-1, None, :], path_a[..., 1:, None, :],
        path_b[..., None, :-1, :], path_b[..., None, 1:, :])
    if mask_b is not None:
        valid = valid & mask_b[..., None, :]
    hits = valid.any(dim=-1)
    if mask_a is not None:
        hits = hits & mask_a
    return hits.any(dim=-1)


def convex_intersection_area(a, b):
    """Intersection area of convex polygons a [..., VA, 2], b [..., VB, 2]
    by the sorted-vertex construction (polyshape ``intersect`` + ``area``,
    ReachableSetCoupler.m:39-45): the vertices of a inside b, of b inside
    a and every edge crossing, sorted stably by angle about their centroid
    (invalid ones last) and measured by the shoelace formula. The
    coupling uses ``convex_intersection_area_clip``."""
    va, vb = a.shape[-2], b.shape[-2]
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a, b = a.expand(*lead, va, 2), b.expand(*lead, vb, 2)
    in_b = point_in_convex(a, b[..., None, :, :])              # [..., VA]
    in_a = point_in_convex(b, a[..., None, :, :])              # [..., VB]
    xvalid, xpts = _segment_intersection(
        a[..., :, None, :], _roll_prev(a, -2)[..., :, None, :],
        b[..., None, :, :], _roll_prev(b, -2)[..., None, :, :])  # [VA, VB]
    pts = torch.cat([a, b, xpts.reshape(*lead, va * vb, 2)], dim=-2)
    valid = torch.cat([in_b, in_a, xvalid.reshape(*lead, va * vb)], dim=-1)
    n_valid = valid.sum(dim=-1)
    centroid = (torch.sum(pts * valid[..., None].to(pts.dtype), dim=-2)
                / torch.clamp_min(n_valid, 1)[..., None])
    ang = torch.atan2(pts[..., 1] - centroid[..., 1:2],
                      pts[..., 0] - centroid[..., 0:1])
    ang = torch.where(valid, ang, torch.full_like(ang, math.inf))
    order = torch.sort(ang, dim=-1, stable=True).indices
    ring = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))
    keep = torch.gather(valid, -1, order)
    ring = torch.where(keep[..., None], ring, ring[..., :1, :])
    area = polygon_area(ring)
    return torch.where(n_valid >= 3, area, torch.zeros_like(area))


def _ccw(poly):
    """Canonicalize polygons [..., V, 2] to CCW (reverse if clockwise)."""
    x, y = poly[..., 0], poly[..., 1]
    signed = torch.sum(x * _roll_prev(y, -1) - _roll_prev(x, -1) * y, dim=-1)
    return torch.where((signed >= 0.0)[..., None, None], poly,
                       torch.flip(poly, dims=[-2]))


def _edge_portions_integral(a, b, strict: bool):
    """∮ x dy over the portions of CCW polygon ``a``'s edges inside CCW
    convex polygon ``b`` (both [..., V, 2]); see the reference docstring
    (pdmpc_tpu/ops/geometry.py) for the ``strict`` boundary rule."""
    p1 = a
    d = _roll_prev(a, -2) - a                              # [..., VA, 2]
    eb = _roll_prev(b, -2) - b                             # [..., VB, 2]
    nx, ny = -eb[..., 1], eb[..., 0]                       # inward normals
    len_clip = torch.abs(nx) + torch.abs(ny)
    deg_clip = len_clip < torch.clamp_min(
        1e-5 * torch.amax(len_clip, dim=-1, keepdim=True), _EPS
    )
    nxe, nye = nx[..., None, :], ny[..., None, :]          # [..., 1, VB]
    num = (nxe * (p1[..., :, 0, None] - b[..., None, :, 0])
           + nye * (p1[..., :, 1, None] - b[..., None, :, 1]))  # [VA, VB]
    den = nxe * d[..., :, 0, None] + nye * d[..., :, 1, None]
    par = torch.abs(den) < _EPS
    tcross = -num / torch.where(par, torch.ones_like(den), den)
    inert = par | deg_clip[..., None, :]
    zero = torch.zeros_like(tcross)
    lo = torch.where((den > 0) & ~inert, tcross, zero)
    hi = torch.where((den < 0) & ~inert, tcross, zero + 1.0)
    outside = num < -0.0
    if strict:
        same_dir = (d[..., :, 0, None] * eb[..., None, :, 0]
                    + d[..., :, 1, None] * eb[..., None, :, 1]) > 0.0
        outside = outside | ((num <= 0.0) & same_dir)
    empty = torch.any(par & ~deg_clip[..., None, :] & outside, dim=-1)
    t0 = torch.clamp(torch.amax(lo, dim=-1), 0.0, 1.0)
    t1 = torch.clamp(torch.amin(hi, dim=-1), 0.0, 1.0)
    keep = (t1 > t0) & ~empty
    contrib = d[..., 1] * (p1[..., 0] * (t1 - t0)
                           + d[..., 0] * 0.5 * (t1 * t1 - t0 * t0))
    return torch.sum(torch.where(keep, contrib, torch.zeros_like(contrib)),
                     dim=-1)


def convex_intersection_area_clip(a, b):
    """Intersection area of convex polygons a [..., VA, 2], b [..., VB, 2]
    by Green's theorem over clipped edges (sort- and gather-free).
    Reference: ReachableSetCoupler.m:39-45 (the coupling overlap)."""
    a = _ccw(a)
    b = _ccw(b)
    area = (_edge_portions_integral(a, b, strict=False)
            + _edge_portions_integral(b, a, strict=True))
    cap = torch.minimum(polygon_area(a), polygon_area(b))
    return torch.minimum(torch.clamp_min(area, 0.0), cap)


def point_in_ring(p, ring):
    """Crossing-number point-in-polygon for (possibly non-convex) rings.

    ``p`` [..., 2]; ``ring`` [..., R, 2] closed and padded by repeating the
    last vertex (zero-length edges never cross the ray). Returns [...].
    """
    a = ring
    b = _roll_prev(ring, -2)
    py = p[..., None, 1]
    cond = (a[..., 1] > py) != (b[..., 1] > py)
    dy = b[..., 1] - a[..., 1]
    t = (py - a[..., 1]) / torch.where(torch.abs(dy) < _EPS,
                                       torch.ones_like(dy), dy)
    x_cross = a[..., 0] + t * (b[..., 0] - a[..., 0])
    crossings = torch.sum(cond & (p[..., None, 0] < x_cross), dim=-1)
    return (crossings % 2) == 1


def outer_poly_approx(points, mask, k_dirs: int):
    """Conservative convex outer approximation with ``k_dirs`` vertices:
    support of the valid points [..., M, 2] (mask [..., M]) in ``k_dirs``
    evenly spaced directions, intersected tangent half-planes. Returns
    [..., k_dirs, 2]."""
    theta = (2.0 * math.pi
             * torch.arange(k_dirs, dtype=torch.float32,
                            device=points.device) / k_dirs)
    cx, cy = torch.cos(theta), torch.sin(theta)                 # [K]
    proj = (points[..., 0, None] * cx + points[..., 1, None] * cy)  # [M, K]
    proj = torch.where(mask[..., None], proj,
                       torch.full_like(proj, -math.inf))
    h = torch.amax(proj, dim=-2)                                # [..., K]
    d1x, d1y = cx, cy
    d2x, d2y = _roll_prev(cx, 0), _roll_prev(cy, 0)
    h1, h2 = h, _roll_prev(h, -1)
    det = d1x * d2y - d1y * d2x
    x = (h1 * d2y - h2 * d1y) / det
    y = (d1x * h2 - d2x * h1) / det
    return torch.stack([x, y], dim=-1)


def bound_convex_to_corridor(poly, rings, segs, seg_mask,
                             k_dirs: int | None = None):
    """Clip convex polygons to their corridors (union of boundary rings).

    Reference: bound_reachable_sets.m:1-50 plus the convhull of
    HighLevelController.m:252-257, as in pdmpc_tpu. The candidate vertices
    of ``poly ∩ corridor`` — polygon vertices inside the corridor, ring
    vertices inside the polygon, polygon-edge x boundary-segment
    intersections — are support-fitted to a ``k_dirs``-vertex outer
    approximation (default: K, the polygon's own count); an empty
    intersection keeps the polygon (fitted to ``k_dirs`` vertices where
    that differs from K).

    poly: [B..., K, 2]; rings: [B..., M, R, 2]; segs: [B..., S, 2, 2];
    seg_mask: [B..., S]. The batch dims of ``poly`` may carry extra leading
    dims over those of the corridor (e.g. [N, Hp] polygons against [N]
    corridors, with the corridor tensors given a broadcast dim).
    Returns [B..., k_dirs or K, 2].
    """
    k = poly.shape[-2] if k_dirs is None else k_dirs
    # polygon vertices inside any ring: [B..., K]
    in_corridor = torch.any(
        point_in_ring(poly[..., :, None, :], rings[..., None, :, :, :]),
        dim=-1,
    )
    ring_pts = rings.reshape(*rings.shape[:-3], -1, 2)     # [B..., M*R, 2]
    ring_in = point_in_convex(ring_pts, poly[..., None, :, :])
    e1, e2 = poly, _roll_prev(poly, -2)
    xvalid, xpts = _segment_intersection(
        e1[..., :, None, :], e2[..., :, None, :],
        segs[..., None, :, 0, :], segs[..., None, :, 1, :],
    )                                                      # [B..., K, S]
    xvalid = xvalid & seg_mask[..., None, :]
    lead = poly.shape[:-2]
    pts = torch.cat([
        poly,
        ring_pts.expand(*lead, *ring_pts.shape[-2:]),
        xpts.reshape(*lead, -1, 2),
    ], dim=-2)
    valid = torch.cat([
        in_corridor,
        ring_in,
        xvalid.reshape(*lead, -1),
    ], dim=-1)
    enough = torch.sum(valid, dim=-1) >= 3
    safe_valid = valid | ~enough[..., None]
    bounded = outer_poly_approx(pts, safe_valid, k)
    original = poly if k == poly.shape[-2] else outer_poly_approx(
        poly, torch.ones(poly.shape[:-1], dtype=torch.bool,
                         device=poly.device), k)
    return torch.where(enough[..., None, None], bounded, original)


def polygon_bbox(poly):
    """Axis-aligned bounding boxes of polygons [..., V, 2]: (xmin, xmax,
    ymin, ymax), each [...]."""
    x, y = poly[..., 0], poly[..., 1]
    return x.amin(dim=-1), x.amax(dim=-1), y.amin(dim=-1), y.amax(dim=-1)


def bboxes_overlap(b1, b2):
    """Whether boxes ``(xmin, xmax, ymin, ymax)`` overlap, inclusive on
    touch as the SAT test (ReachableSetCoupler.m:34's prefilter)."""
    return ~((b1[0] > b2[1]) | (b1[2] > b2[3]) | (b1[1] < b2[0])
             | (b1[3] < b2[2]))


# ---------------------------------------------------------------------------
# Reference-path arc-length machinery (sample_reference_trajectory.m)
# ---------------------------------------------------------------------------


def path_cumlen(path):
    """Cumulative arc length [..., P] of polylines [..., P, 2]."""
    d = path[..., 1:, :] - path[..., :-1, :]
    seg = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    zero = torch.zeros_like(seg[..., :1])
    return torch.cat([zero, torch.cumsum(seg, dim=-1)], dim=-1)


def project_to_polyline(p, path, cumlen):
    """Project points ``p`` [N, 2] onto polylines ``path`` [N, P, 2].

    Returns (arc_position [N], closest_point [N, 2], segment_index [N]).
    """
    a = path[:, :-1]
    ab = path[:, 1:] - a
    ab_len2 = ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1]
    ap = p[:, None, :] - a
    t = (ap[..., 0] * ab[..., 0] + ap[..., 1] * ab[..., 1]) / torch.clamp_min(
        ab_len2, _EPS
    )
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    e = proj - p[:, None, :]
    d2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]
    i = torch.argmin(d2, dim=-1)                           # first minimum
    rows = torch.arange(p.shape[0], device=p.device)
    arc = cumlen[rows, i] + t[rows, i] * torch.sqrt(
        torch.clamp_min(ab_len2[rows, i], 0.0)
    )
    return arc, proj[rows, i], i


def _py_mod(x, m):
    """``jnp.mod``: C fmod, shifted into the divisor's sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def sample_path_at_arclength(path, arcs, cumlen, is_loop):
    """Points on polylines ``path`` [N, P, 2] at arc positions ``arcs``
    [N, H], plus the segment index of each sample. Loops wrap modulo the
    total length (sample_reference_trajectory.m:40)."""
    total = cumlen[:, -1:]
    s = torch.where(is_loop[:, None], _py_mod(arcs, total),
                    torch.minimum(torch.clamp_min(arcs, 0.0), total))
    idx = torch.searchsorted(cumlen.contiguous(), s.contiguous(),
                             right=True) - 1
    idx = torch.clamp(idx, 0, path.shape[1] - 2)
    seg_start = cumlen.gather(1, idx)
    seg_len = torch.clamp_min(cumlen.gather(1, idx + 1) - seg_start, _EPS)
    t = (s - seg_start) / seg_len
    rows = torch.arange(path.shape[0], device=path.device)[:, None]
    p0 = path[rows, idx]
    points = p0 + t[..., None] * (path[rows, idx + 1] - p0)
    return points, idx
