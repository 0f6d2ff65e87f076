// Native A* trim-lattice planner — the framework's C++ search core.
//
// Role parity with the reference's only native component, the C++ MEX
// binary-heap priority queue driving MATLAB's A*
// (hlc/optimizer/graph_search/priority_queue_interface_mex.cpp +
// GraphSearch.m): here the whole search runs natively — heap-ordered
// best-first expansion over the motion-primitive lattice with lazy exact
// edge evaluation (SAT polygon collision) on pop, goal test at depth Hp,
// and the expand_node cost model (g = squared distance to reference,
// admissible h with max-travel slack, expand_node.m:61-73).
//
// Used from Python via ctypes (pdmpc_torch/native/__init__.py, a copy of
// pdmpc_tpu/native/astar.cpp) as the host-side reference planner and as a
// fast test oracle for the beam search. Built at first use with plain
// g++ -O3 -shared into pdmpc_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Node {
  double x, y, yaw;
  double g;
  int trim;
  int depth;
  int parent;
};

struct HeapEntry {
  double f;
  std::int64_t order;  // FIFO tie-break like the MATLAB heap's push order
  int node;
  bool operator>(const HeapEntry& o) const {
    if (f != o.f) return f > o.f;
    return order > o.order;
  }
};

// Separating-axis test for convex polygons given as interleaved xy pairs.
// Degenerate (repeated-vertex) edges yield zero axes which never separate
// — matching intersect_sat.m semantics.
bool sat_separated_one_direction(const double* a, int va, const double* b,
                                 int vb) {
  for (int i = 0; i < va; ++i) {
    const int j = (i + 1) % va;
    const double ex = a[2 * j] - a[2 * i];
    const double ey = a[2 * j + 1] - a[2 * i + 1];
    double ax = -ey, ay = ex;
    const double norm = std::sqrt(ax * ax + ay * ay);
    if (norm < 1e-12) continue;
    ax /= norm;
    ay /= norm;
    double min_a = 1e300, max_a = -1e300;
    for (int v = 0; v < va; ++v) {
      const double p = ax * a[2 * v] + ay * a[2 * v + 1];
      min_a = std::min(min_a, p);
      max_a = std::max(max_a, p);
    }
    double min_b = 1e300, max_b = -1e300;
    for (int v = 0; v < vb; ++v) {
      const double p = ax * b[2 * v] + ay * b[2 * v + 1];
      min_b = std::min(min_b, p);
      max_b = std::max(max_b, p);
    }
    if (min_a - max_b > 0.0 || min_b - max_a > 0.0) return true;
  }
  return false;
}

bool sat_collide(const double* a, int va, const double* b, int vb) {
  return !(sat_separated_one_direction(a, va, b, vb) ||
           sat_separated_one_direction(b, vb, a, va));
}

// Robust segment-crossing predicate — mirror of
// ops/search._segment_cross_predicate (SEG_CROSS_TOL parameter band),
// keep in lockstep with the Python/Pallas implementations.
constexpr double kSegCrossTol = 1e-4;

bool segments_cross(double ax1, double ay1, double ax2, double ay2,
                    double bx1, double by1, double bx2, double by2) {
  const double rx = ax2 - ax1, ry = ay2 - ay1;
  const double sx = bx2 - bx1, sy = by2 - by1;
  const double qpx = bx1 - ax1, qpy = by1 - ay1;
  const double d = rx * sy - ry * sx;
  const double a_num = qpx * sy - qpy * sx;
  const double b_num = qpx * ry - qpy * rx;
  const double ad = std::abs(d);
  const double t_lim = kSegCrossTol * d * d;
  const double m_lim = ad * (1.0 + kSegCrossTol);
  return ad >= 1e-9 && a_num * d >= -t_lim && std::abs(a_num) <= m_lim &&
         b_num * d >= -t_lim && std::abs(b_num) <= m_lim;
}

// Non-convex InterX-equivalent collision: closed outlines intersect
// (ops/search.candidate_outline_collisions semantics).
bool outline_collide(const double* a, int va, const double* b, int vb) {
  for (int i = 0; i < va; ++i) {
    const int i2 = (i + 1) % va;
    for (int j = 0; j < vb; ++j) {
      const int j2 = (j + 1) % vb;
      if (segments_cross(a[2 * i], a[2 * i + 1], a[2 * i2], a[2 * i2 + 1],
                         b[2 * j], b[2 * j + 1], b[2 * j2],
                         b[2 * j2 + 1]))
        return true;
    }
  }
  return false;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 when the search is exhausted (no feasible leaf).
// Road-path constraints (GraphSearch.m:111-196 full set): `non_convex`
// switches the obstacle test from SAT to outline crossing; `bnd`
// ([n_bnd, 2, 2], pre-filtered to active segments, n_bnd = 0 to disable)
// adds the lanelet-boundary constraint checked on the without-offset
// swept area (`areas_bnd_no`), large-offset at the final step
// (`areas_bnd_lg`) — shapes_for_boundary_check, GraphSearch.m:166-174.
int astar_plan(
    int n_trims, int hp,
    const std::uint8_t* transition,  // [hp, n, n]
    const double* dx,                // [n, n]
    const double* dy,                // [n, n]
    const double* dyaw,              // [n, n]
    const double* areas,             // [n, n, va, 2] swept areas (offset)
    int va,
    double x0, double y0, double yaw0, int trim0,
    const double* ref,   // [hp, 2]
    const double* vref,  // [hp]
    double dt,
    const double* obs,            // [n_obs, hp, vo, 2]
    const std::uint8_t* obs_mask, // [n_obs, hp]
    int n_obs, int vo,
    int non_convex,
    const double* bnd,            // [n_bnd, 2, 2] active boundary segments
    int n_bnd,
    const double* areas_bnd_no,   // [n, n, va, 2] without-offset areas
    const double* areas_bnd_lg,   // [n, n, va, 2] large-offset areas
    int* out_trims,      // [hp]
    double* out_poses,   // [hp, 3]
    double* out_cost,
    int* out_n_expanded) {
  std::vector<Node> nodes;
  nodes.reserve(4096);
  nodes.push_back({x0, y0, yaw0, 0.0, trim0, 0, -1});

  std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                      std::greater<HeapEntry>>
      pq;
  std::int64_t order = 0;
  pq.push({0.0, order++, 0});

  std::vector<double> shape(2 * va);
  int n_expanded = 0;

  while (!pq.empty()) {
    const int cur = pq.top().node;
    pq.pop();
    const Node node = nodes[cur];

    // lazy exact edge evaluation (eval_edge_exact capability)
    if (node.parent >= 0) {
      const Node& par = nodes[node.parent];
      const double c = std::cos(par.yaw), s = std::sin(par.yaw);
      const std::size_t edge_off =
          ((static_cast<std::size_t>(par.trim) * n_trims + node.trim) * va) *
          2;
      const double* area = areas + edge_off;
      for (int v = 0; v < va; ++v) {
        shape[2 * v] = c * area[2 * v] - s * area[2 * v + 1] + par.x;
        shape[2 * v + 1] = s * area[2 * v] + c * area[2 * v + 1] + par.y;
      }
      const int k = node.depth - 1;  // 0-based prediction step of the edge
      bool hit = false;
      for (int o = 0; o < n_obs && !hit; ++o) {
        if (!obs_mask[o * hp + k]) continue;
        const double* poly = obs +
            ((static_cast<std::size_t>(o) * hp + k) * vo) * 2;
        hit = non_convex ? outline_collide(shape.data(), va, poly, vo)
                         : sat_collide(shape.data(), va, poly, vo);
      }
      if (!hit && n_bnd > 0) {
        const double* bnd_area =
            (k == hp - 1 ? areas_bnd_lg : areas_bnd_no) + edge_off;
        for (int v = 0; v < va; ++v) {
          shape[2 * v] =
              c * bnd_area[2 * v] - s * bnd_area[2 * v + 1] + par.x;
          shape[2 * v + 1] =
              s * bnd_area[2 * v] + c * bnd_area[2 * v + 1] + par.y;
        }
        for (int b = 0; b < n_bnd && !hit; ++b) {
          const double* sg = bnd + 4 * static_cast<std::size_t>(b);
          for (int v = 0; v < va && !hit; ++v) {
            const int v2 = (v + 1) % va;
            hit = segments_cross(shape[2 * v], shape[2 * v + 1],
                                 shape[2 * v2], shape[2 * v2 + 1], sg[0],
                                 sg[1], sg[2], sg[3]);
          }
        }
      }
      if (hit) continue;
    }

    if (node.depth == hp) {
      // goal: backtrack
      int id = cur;
      while (nodes[id].parent >= 0) {
        const Node& nd = nodes[id];
        out_trims[nd.depth - 1] = nd.trim;
        out_poses[(nd.depth - 1) * 3 + 0] = nd.x;
        out_poses[(nd.depth - 1) * 3 + 1] = nd.y;
        out_poses[(nd.depth - 1) * 3 + 2] = nd.yaw;
        id = nodes[id].parent;
      }
      *out_cost = node.g;
      *out_n_expanded = n_expanded;
      return 0;
    }

    // expansion (expand_node capability)
    ++n_expanded;
    const int k = node.depth;
    const double c = std::cos(node.yaw), s = std::sin(node.yaw);
    const std::uint8_t* trans_row =
        transition + (static_cast<std::size_t>(k) * n_trims + node.trim) *
        n_trims;
    for (int j = 0; j < n_trims; ++j) {
      if (!trans_row[j]) continue;
      const std::size_t m = static_cast<std::size_t>(node.trim) * n_trims + j;
      const double nx = c * dx[m] - s * dy[m] + node.x;
      const double ny = s * dx[m] + c * dy[m] + node.y;
      const double nyaw = node.yaw + dyaw[m];

      const double rx = nx - ref[2 * k], ry = ny - ref[2 * k + 1];
      const double g = node.g + rx * rx + ry * ry;

      double h = 0.0, d_max = 0.0;
      for (int t = k + 1; t < hp; ++t) {
        d_max += dt * vref[t];
        const double ddx = nx - ref[2 * t], ddy = ny - ref[2 * t + 1];
        const double dist = std::sqrt(ddx * ddx + ddy * ddy);
        const double short_by = std::max(0.0, dist - d_max);
        h += short_by * short_by;
      }

      nodes.push_back({nx, ny, nyaw, g, j, node.depth + 1, cur});
      pq.push({g + h, order++, static_cast<int>(nodes.size()) - 1});
    }
  }

  *out_cost = 1e300;
  *out_n_expanded = n_expanded;
  return 1;  // exhausted
}

}  // extern "C"
