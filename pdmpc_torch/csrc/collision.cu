// Collision masks of the beam search for Hopper (sm_90a), bound to Python
// with ctypes (pdmpc_torch/ops/collision.py builds and loads this file).
//
// outline_hits  replaces pdmpc_tpu/ops/pallas_collision.py::_outline_kernel
//               (reached through outline_hits_pre);
// boundary_hits replaces pdmpc_tpu/ops/pallas_collision.py::_boundary_kernel
//               (reached through boundary_hits_pre);
// sat_hits      replaces pdmpc_tpu/ops/pallas_collision.py::_sat_kernel
//               (reached through sat_hits_pre).
//
// The first two decide, per candidate polygon, whether any of its edges
// crosses any active segment (an obstacle edge or a lanelet-boundary
// segment), with the tolerant division-free predicate of
// pdmpc_tpu/ops/search.py (_segment_cross_predicate, SEG_CROSS_TOL =
// 1e-4) in its XLA form:
//   r = a2 - a1, s = b2 - b1, qp = b1 - a1,
//   d = r x s, A = qp x s, B = qp x r.
// (The Pallas kernels build A as b1 x s - a1 x s; the CPU goldens were made
// with the XLA form, so this source follows it.) Build with -fmad=false:
// every product is rounded on its own, as in the plain PyTorch versions, so
// kernel and plain version agree bit for bit.
//
// Each kernel has two entry forms that share one scan (hits_kernel for the
// crossing kernels, sat_hits_kernel for SAT), over two candidate sources:
// - the (cx, cy) form reads candidate vertices [V, VA, C] from memory;
// - the lattice form builds search layer candidates in registers: candidate
//   b * n + j of vehicle v is the area table[trim[v, b], j] placed at the
//   parent pose with x = fma(c, tx, -(s * ty)) + px and
//   y = fma(s, tx, c * ty) + py, the rounding of the plain version
//   (geometry.fma, i.e. torch.addcmul).
// Given a live mask, a kernel writes live & ~hit (the feasibility mask of
// the search) and scans no candidate that is not live; without one it
// writes the hit mask.
//
// What bounds the crossing kernels on an H100: operations (candidate edges
// x active segments, ~25 f32 operations a pair), not the few hundred KB of
// inputs.
// Design: a resident block (grid sized to the SMs) compacts its vehicle's
// active segments (masked obstacles and degenerate padded edges dropped:
// both can never cross) into shared memory, in index order by warp
// ballots, then walks candidates with a grid-stride loop. The stage holds
// at most `cap` segments (the host sizes it to its shared-memory budget).
// A bundle that fits runs hits_kernel, staged once; a larger one runs
// hits_rounds_kernel, staged in rounds, each round scanning the
// candidates the earlier ones left undecided and ORing its hits in. A
// mask is an OR over segments, so rounds change no result. A warp takes one
// candidate: every lane holds the candidate's polygon in registers, lane l
// tests staged segments l, l + 32, ... against all its edges, and the warp
// leaves at its first hit by a vote after each round (every lane runs the
// same number of rounds). No bounding-box
// culling: it is not exact inside the tolerance band.
//
// sat_hits decides, per candidate convex polygon, whether it overlaps an
// active convex obstacle, i.e. no edge normal of either polygon separates
// them. It follows the XLA form of pdmpc_tpu/ops/search.py
// (_sat_separates_batch), not the Pallas kernel's unnormalized axes:
//   axis = (-ey, ex) / max(sqrt(fma(ay, ay, ax * ax)), 1e-9),
//   projection = fma(ay, y, ax * x),
//   separated on an axis iff min(pa) - max(pb) > 0 or min(pb) - max(pa) > 0,
// each multiply-add fused with __fmaf_rn, the square root and the division
// rounded to nearest (pdmpc_torch/ops/collision.py says why).
//
// What bounds it on an H100: bytes, by the count of the least work (a
// separated pair needs a single axis, so a typical mask needs fewer
// operations than reading its inputs once takes, ~0.2 us); in fact
// latency, since a candidate meets its 10 to 30 active obstacles one after
// another and a search layer has few live candidates. The design: resident
// blocks stage the vehicle's active obstacles, `cap` at most a round (as
// the crossing scan does), in index order by warp ballots (a half warp an
// obstacle), as structure of arrays with the
// obstacle slot fastest (lane l reads slot l: no bank conflicts); the stage
// drops exactly what cannot change a result, i.e. vertices equal to their
// predecessor (the padding up to VO repeats the last one; they leave every
// extent as it is) and zero axes (they never separate), and nothing else
// (the wrap-around axis of a padded obstacle, last repeat -> vertex 0, sits
// at index VO - 1 and is kept; no bounding-box culling: not exact on
// touching polygons). Eight lanes take one candidate, four candidates a
// warp: every lane builds the candidate's vertices in registers, lane i <
// VA computes its axis i and extents and the group exchanges them by
// shuffles; lane l tests staged obstacles l, l + 8, ..., each on the
// obstacle's axes first (VA projections an axis, its own extents come from
// the bundle), then on the candidate's (an obstacle's distinct vertices an
// axis), leaving at the first separating axis; the group votes after each
// round and leaves at its first overlap (every lane runs the same number
// of rounds).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVa = 8;
// Lanes a candidate in the crossing scan: one warp. Of 4, 8, 16 and 32
// lanes, 32 was the fastest for both crossing kernels on the H100, all
// live and with a live mask (PERF.md, Findings).
constexpr int kLanes = 32;
static_assert(kLanes == 32, "the scan gives each candidate one warp");
constexpr float kTol = 1e-4f;
constexpr float kOnePlusTol = 1.0001f;

struct __align__(16) Seg {
  float b1x, b1y, sx, sy;
};

__device__ __forceinline__ bool crosses(float rx, float ry, float qpx,
                                        float qpy, float sx, float sy) {
  const float d = rx * sy - ry * sx;
  const float a_num = qpx * sy - qpy * sx;
  const float b_num = qpx * ry - qpy * rx;
  const float ad = fabsf(d);
  const float t_lim = kTol * d * d;
  const float m_lim = ad * kOnePlusTol;
  return (ad >= 1e-9f) && (a_num * d >= -t_lim) && (fabsf(a_num) <= m_lim) &&
         (b_num * d >= -t_lim) && (fabsf(b_num) <= m_lim);
}

// ---- where the segments come from ----------------------------------------

// Obstacle outlines [V, NO, VO]: edge k -> k+1 (cyclic) where edge_ok.
struct OutlineSegs {
  const float* ox;
  const float* oy;
  const int32_t* edge_ok;
  int n_obs, vo;

  __host__ __device__ int size() const { return n_obs * vo; }
  __device__ bool get(int v, int e, Seg& s) const {
    const size_t base = (size_t)v * n_obs * vo;
    if (edge_ok[base + e] == 0) return false;
    const int o = e / vo;
    const int k = e - o * vo;
    const int k1 = (k + 1 == vo) ? 0 : k + 1;
    s.b1x = ox[base + e];
    s.b1y = oy[base + e];
    s.sx = ox[base + (size_t)o * vo + k1] - s.b1x;
    s.sy = oy[base + (size_t)o * vo + k1] - s.b1y;
    return true;
  }
};

// Boundary segments: packed [V, 8, S_pad] rows sx, sy, b1x, b1y, ...;
// mask [V, S_pad].
struct BoundarySegs {
  const float* packed;
  const int32_t* mask;
  int s_pad;

  __host__ __device__ int size() const { return s_pad; }
  __device__ bool get(int v, int e, Seg& s) const {
    if (mask[(size_t)v * s_pad + e] == 0) return false;
    const float* p = packed + (size_t)v * 8 * s_pad;
    s.sx = p[e];
    s.sy = p[s_pad + e];
    s.b1x = p[2 * s_pad + e];
    s.b1y = p[3 * s_pad + e];
    return true;
  }
};

// ---- where the candidates come from --------------------------------------

// Vertex-major candidates cx, cy [V, VA, C].
struct PolyCands {
  const float* cx;
  const float* cy;
  int va, c_total;

  __device__ void get(int v, int c, float* ax, float* ay) const {
    const size_t base = (size_t)v * va * c_total + c;
#pragma unroll
    for (int i = 0; i < kMaxVa; ++i) {
      if (i < va) {
        ax[i] = cx[base + (size_t)i * c_total];
        ay[i] = cy[base + (size_t)i * c_total];
      }
    }
  }
};

// One search layer's lattice: table [n, n, VA, 2]; trim [V, B] i64, pose
// [V, B, 3] (last stride 1) and cos, sin [V, B] of the parent yaw, each
// with its own strides in elements.
struct LatticeCands {
  const float* table;
  const int64_t* trim;
  const float* pose;
  const float* cos_yaw;
  const float* sin_yaw;
  long long trim_sv, trim_sb, pose_sv, pose_sb, cs_sv, cs_sb;
  int n, va;

  __device__ void get(int v, int c, float* ax, float* ay) const {
    const int b = c / n;
    const int j = c - b * n;
    const int64_t t = trim[v * trim_sv + b * trim_sb];
    const float* area = table + ((size_t)t * n + j) * va * 2;
    const float* p = pose + v * pose_sv + b * pose_sb;
    const float cv = cos_yaw[v * cs_sv + b * cs_sb];
    const float sv = sin_yaw[v * cs_sv + b * cs_sb];
    const float px = p[0], py = p[1];
#pragma unroll
    for (int i = 0; i < kMaxVa; ++i) {
      if (i < va) {
        const float tx = __ldg(area + 2 * i), ty = __ldg(area + 2 * i + 1);
        ax[i] = __fadd_rn(__fmaf_rn(cv, tx, -__fmul_rn(sv, ty)), px);
        ay[i] = __fadd_rn(__fmaf_rn(sv, tx, __fmul_rn(cv, ty)), py);
      }
    }
  }
};

// ---- the scan --------------------------------------------------------------

// One warp scans candidate c of vehicle v against the n_segs staged
// segments: every lane holds the candidate's polygon in registers, lane l
// tests segments l, l + 32, ... against all its edges, and the warp leaves
// at its first hit by a vote after each round. Lane 0 writes the result
// to out_c: in the first stage round live ? !hit : hit, in a later one
// only a hit.
template <class Cands>
__device__ void scan_candidate(const Cands& cands, int v, int c,
                               const Seg* staged, int n_segs, int lane,
                               bool first, const uint8_t* live,
                               uint8_t* out_c) {
  float ax[kMaxVa], ay[kMaxVa], rx[kMaxVa], ry[kMaxVa];
  cands.get(v, c, ax, ay);
  const int va = cands.va;
#pragma unroll
  for (int i = 0; i < kMaxVa; ++i) {
    if (i < va) {
      const int i1 = (i + 1) % kMaxVa;
      const bool wrap = i + 1 >= va;
      rx[i] = (wrap ? ax[0] : ax[i1]) - ax[i];
      ry[i] = (wrap ? ay[0] : ay[i1]) - ay[i];
    }
  }
  const int rounds = (n_segs + kLanes - 1) / kLanes;
  bool hit = false;
  for (int r = 0; r < rounds; ++r) {
    const int e = r * kLanes + lane;
    bool h = false;
    if (e < n_segs) {
      const Seg s = staged[e];
#pragma unroll
      for (int i = 0; i < kMaxVa; ++i) {
        if (i < va) {
          h |= crosses(rx[i], ry[i], s.b1x - ax[i], s.b1y - ay[i], s.sx,
                       s.sy);
        }
      }
    }
    if (__any_sync(0xffffffffu, h)) {
      hit = true;
      break;
    }
  }
  if (lane == 0 && (first || hit)) *out_c = (live != nullptr) ? !hit : hit;
}

// Whether candidate `c` is left to scan in a stage round: in the first,
// every live candidate (one that is not gets out = 0 here); in a later
// one, those an earlier round found no hit for, as it wrote them to out.
__device__ __forceinline__ bool undecided(const uint8_t* live, uint8_t* out,
                                          size_t at, bool first, bool lead) {
  if (first) {
    if (live == nullptr || live[at] != 0) return true;
    if (lead) out[at] = 0;
    return false;
  }
  return out[at] == (live != nullptr ? 1 : 0);
}

// The stage rounds' common part: compact the next (at most `cap`) entries
// `o` >= cursor of [0, n) for which `ok(o)` holds, in index order, by
// `keep(slot, o)`; returns how many were kept and moves `cursor` past
// them. `resume` and `warp_count` are the block's shared scratch. Every
// thread of the block calls it.
template <class Ok, class Keep>
__device__ int stage_round(int n, int cap, int& cursor, int* warp_count,
                           int* resume, Ok ok_at, Keep keep) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) *resume = n;
  int seen = 0;
  int base = cursor;
  for (; base < n && seen < cap; base += kThreads) {
    const int o = base + threadIdx.x;
    const bool ok = o < n && ok_at(o);
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = warp_count[w];
      before += (w < warp) ? cnt : 0;
      total += cnt;
    }
    const int slot = seen + before + __popc(m & ((1u << lane) - 1u));
    if (ok) {
      if (slot < cap) {
        keep(slot, o);
      } else if (slot == cap) {
        *resume = o;  // the first entry of the next round
      }
    }
    seen += total;
    __syncthreads();
  }
  cursor = seen > cap ? *resume : base;
  return seen < cap ? seen : cap;
}

// The crossing scan of a bundle past one stage: grid (blocks, V),
// kThreads threads, dynamic shared memory for `cap` staged segments, the
// bundle staged in rounds. live, out as for hits_kernel.
template <class Segs, class Cands>
__global__ void __launch_bounds__(kThreads)
    hits_rounds_kernel(Segs segs, Cands cands, const uint8_t* live,
                       uint8_t* out, int c_total, int cap) {
  extern __shared__ Seg staged[];
  __shared__ int warp_count[kWarps];
  __shared__ int resume;
  const int v = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_edges = segs.size();
  constexpr int kGroups = kThreads / kLanes;
  const size_t row = (size_t)v * c_total;
  int cursor = 0;
  for (int round = 0; round == 0 || cursor < n_edges; ++round) {
    const bool first = round == 0;
    // stage the vehicle's next active segments in index order
    Seg s;
    const int n_segs = stage_round(
        n_edges, cap, cursor, warp_count, &resume,
        [&](int e) { return segs.get(v, e, s); },
        [&](int slot, int) { staged[slot] = s; });

    // a warp a candidate, grid-stride over candidates
    for (int c = blockIdx.x * kGroups + warp; c < c_total;
         c += gridDim.x * kGroups) {
      if (!undecided(live, out, row + c, first, lane == 0)) continue;
      scan_candidate(cands, v, c, staged, n_segs, lane, first, live,
                     out + row + c);
    }
    __syncthreads();  // the scan reads the stage the next round refills
  }
}

// The crossing scan of a bundle that fits one stage: grid (blocks, V),
// kThreads threads, dynamic shared memory for segs.size() staged
// segments. live may be null (every candidate live, out = hit); else out
// = live & ~hit. live and out may be one buffer. (hits_rounds_kernel
// does the same in stage rounds, for any bundle, but compiles to a slower
// scan: PERF.md, Findings, PR 6.)
template <class Segs, class Cands>
__global__ void __launch_bounds__(kThreads)
    hits_kernel(Segs segs, Cands cands, const uint8_t* live, uint8_t* out,
                int c_total) {
  extern __shared__ Seg staged[];
  __shared__ int warp_count[kWarps];
  const int v = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // stage the vehicle's active segments in index order
  int n_segs = 0;
  const int n_edges = segs.size();
  for (int base = 0; base < n_edges; base += kThreads) {
    const int e = base + threadIdx.x;
    Seg s;
    const bool ok = e < n_edges && segs.get(v, e, s);
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = warp_count[w];
      before += (w < warp) ? cnt : 0;
      total += cnt;
    }
    if (ok) staged[n_segs + before + __popc(m & ((1u << lane) - 1u))] = s;
    n_segs += total;
    __syncthreads();
  }

  // a warp a candidate, grid-stride over candidates
  constexpr int kGroups = kThreads / kLanes;
  const int rounds = (n_segs + kLanes - 1) / kLanes;
  const size_t row = (size_t)v * c_total;
  for (int c = blockIdx.x * kGroups + warp; c < c_total;
       c += gridDim.x * kGroups) {
    if (live != nullptr && live[row + c] == 0) {
      if (lane == 0) out[row + c] = 0;
      continue;
    }
    float ax[kMaxVa], ay[kMaxVa], rx[kMaxVa], ry[kMaxVa];
    cands.get(v, c, ax, ay);
    const int va = cands.va;
#pragma unroll
    for (int i = 0; i < kMaxVa; ++i) {
      if (i < va) {
        const int i1 = (i + 1) % kMaxVa;
        const bool wrap = i + 1 >= va;
        rx[i] = (wrap ? ax[0] : ax[i1]) - ax[i];
        ry[i] = (wrap ? ay[0] : ay[i1]) - ay[i];
      }
    }
    bool hit = false;
    for (int r = 0; r < rounds; ++r) {
      const int e = r * kLanes + lane;
      bool h = false;
      if (e < n_segs) {
        const Seg s = staged[e];
#pragma unroll
        for (int i = 0; i < kMaxVa; ++i) {
          if (i < va) {
            h |= crosses(rx[i], ry[i], s.b1x - ax[i], s.b1y - ay[i], s.sx,
                         s.sy);
          }
        }
      }
      if (__any_sync(0xffffffffu, h)) {
        hit = true;
        break;
      }
    }
    if (lane == 0) out[row + c] = (live != nullptr) ? !hit : hit;
  }
}

int sm_count(int dev) {
  static int count[16] = {0};
  if (dev < 0 || dev >= 16) dev = 0;
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return count[dev];
}

// Dynamic shared memory a block may take without opting in: 48 KB less
// the kernels' static shared memory (the warp counters and the round's
// resume index, under 1 KB).
constexpr size_t kSmemWithoutOptIn = 47 * 1024;

// Raise `kernel`'s limit of dynamic shared memory on device `dev` to at
// least `smem` bytes (sm_90 allows 227 KB a block). A stage past 47 KB
// (the 64-vehicle mixed fleet's 3,072 segments are 48 KB) does not launch
// without it.
// The limit only grows, so a launch of a larger stage seen before keeps
// working. Called with blocks_per_sm's lock held.
void allow_smem(const void* kernel, int dev, size_t smem) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
  };
  constexpr int kEntries = 16;
  static Entry limits[kEntries];
  static int n_limits = 0;
  int i = 0;
  while (i < n_limits && !(limits[i].kernel == kernel && limits[i].dev == dev))
    ++i;
  if (i < n_limits && limits[i].smem >= smem) return;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (i < n_limits) {
    limits[i].smem = smem;
  } else if (n_limits < kEntries) {
    limits[n_limits++] = Entry{kernel, dev, smem};
  }
}

// Blocks of `kernel` resident on one SM of device `dev` with `smem` bytes
// of stage each, cached per (kernel, device, stage size): a search stages
// a handful of sizes. A stage past kSmemWithoutOptIn first raises the
// kernel's limit.
int blocks_per_sm(const void* kernel, int dev, size_t smem) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int blocks;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int n_cached = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_cached; ++i) {
    if (cache[i].kernel == kernel && cache[i].dev == dev &&
        cache[i].smem == smem) {
      return cache[i].blocks;
    }
  }
  if (smem > kSmemWithoutOptIn) allow_smem(kernel, dev, smem);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                smem);
  if (blocks < 1) blocks = 1;
  if (n_cached < kEntries) {
    cache[n_cached++] = Entry{kernel, dev, smem, blocks};
  }
  return blocks;
}

// Grid (blocks, V) of a kernel that takes `groups` candidates a block at a
// time: the blocks that stay resident on the card at this stage size, split
// over the V vehicles, or fewer when the candidates need fewer.
dim3 resident_grid(const void* kernel, size_t smem, int groups, int v,
                   int c_total) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int need = (c_total + groups - 1) / groups;
  int resident = sm_count(dev) * blocks_per_sm(kernel, dev, smem) / v;
  if (resident < 1) resident = 1;
  return dim3(need < resident ? need : resident, v);
}

// Launch the crossing scan on a resident grid: hits_kernel when the
// bundle fits one stage of `cap` segments, hits_rounds_kernel otherwise.
template <class Segs, class Cands>
int launch(const Segs& segs, const Cands& cands, const uint8_t* live,
           uint8_t* out, int v, int c_total, int cap, void* stream) {
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (cap >= segs.size()) {
    const size_t smem = (size_t)segs.size() * sizeof(Seg);
    const dim3 grid = resident_grid((const void*)hits_kernel<Segs, Cands>,
                                    smem, kThreads / kLanes, v, c_total);
    hits_kernel<Segs, Cands><<<grid, kThreads, smem,
                               (cudaStream_t)stream>>>(segs, cands, live,
                                                       out, c_total);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)cap * sizeof(Seg);
  const dim3 grid =
      resident_grid((const void*)hits_rounds_kernel<Segs, Cands>, smem,
                    kThreads / kLanes, v, c_total);
  hits_rounds_kernel<Segs, Cands>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(segs, cands, live, out,
                                                       c_total, cap);
  return (int)cudaGetLastError();
}

LatticeCands lattice(const float* table, int n, int va, const int64_t* trim,
                     long long trim_sv, long long trim_sb, const float* pose,
                     long long pose_sv, long long pose_sb,
                     const float* cos_yaw, const float* sin_yaw,
                     long long cs_sv, long long cs_sb) {
  return LatticeCands{table,   trim,    pose,    cos_yaw, sin_yaw, trim_sv,
                      trim_sb, pose_sv, pose_sb, cs_sv,   cs_sb,   n,
                      va};
}

__device__ __forceinline__ float project(float ax, float ay, float x,
                                         float y) {
  return __fmaf_rn(ay, y, __fmul_rn(ax, x));
}

// Lanes a candidate in the SAT scan. Of 8, 16 and 32 lanes, 8 was the
// fastest on the H100, all live, with a live mask and in the lattice form
// (PERF.md, Findings): the candidate's own axes and the votes are shared
// by four candidates a warp, and the 10 to 30 active obstacles of a
// vehicle take a few rounds of 8.
constexpr int kSatLanes = 8;
static_assert(kSatLanes == 8 || kSatLanes == 16 || kSatLanes == 32,
              "a power of two that divides a warp");
static_assert(kSatLanes >= kMaxVa, "a lane for each candidate axis");
// Most vertices an obstacle of the SAT bundle has: a half warp stages one.
constexpr int kSatMaxVo = 16;

// SAT obstacle bundle: ox, oy, oax, oay, omn, omx [V, NO, VO] f32 (vertex
// k, the normalized normal of edge k -> k+1 and the obstacle's own extents
// on it); mask [V, NO] i32.
struct SatObstacles {
  const float* ox;
  const float* oy;
  const float* oax;
  const float* oay;
  const float* omn;
  const float* omx;
  const int32_t* mask;
  int n_obs, vo;

  // Bytes of a block's stage of `cap` obstacles: six fields of cap x VO
  // floats, then the vertex count, axis count and index of each.
  __host__ __device__ size_t stage_bytes(int cap) const {
    return (size_t)cap * (6 * vo * sizeof(float) + 3 * sizeof(int));
  }
};

// Grid (blocks, V), kThreads threads, obs.stage_bytes(cap) of dynamic
// shared memory: `cap` obstacles a stage round. live may be null (every
// candidate live, out = hit); else out = live & ~hit. live and out may be
// one buffer.
template <class Cands>
__global__ void __launch_bounds__(kThreads)
    sat_hits_kernel(SatObstacles obs, Cands cands, const uint8_t* live,
                    uint8_t* out, int c_total, int cap) {
  // stage: field[k * cap + slot], slot fastest, for k < the slot's count
  extern __shared__ float stage[];
  __shared__ int warp_count[kWarps];
  __shared__ int resume;
  const int n_obs = obs.n_obs;
  const int vo = obs.vo;
  float* svx = stage;
  float* svy = svx + cap * vo;
  float* sax = svy + cap * vo;
  float* say = sax + cap * vo;
  float* smn = say + cap * vo;
  float* smx = smn + cap * vo;
  int* n_verts = reinterpret_cast<int*>(smx + cap * vo);
  int* n_axes = n_verts + cap;
  int* ids = n_axes + cap;
  const int v = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  constexpr int kGroups = kThreads / kSatLanes;
  const int g_lane = threadIdx.x % kSatLanes;
  const unsigned group_mask = (0xffffffffu >> (32 - kSatLanes))
                              << (lane - g_lane);
  const int va = cands.va;
  const size_t row = (size_t)v * c_total;
  int cursor = 0;
  for (int round = 0; round == 0 || cursor < n_obs; ++round) {
    const bool first = round == 0;
    // the vehicle's next active obstacles, in index order
    const int n_act = stage_round(
        n_obs, cap, cursor, warp_count, &resume,
        [&](int o) { return obs.mask[(size_t)v * n_obs + o] > 0; },
        [&](int slot, int o) { ids[slot] = o; });

    // their data, a half warp an obstacle (lane k: vertex k and axis k),
    // without repeated vertices and zero axes
    const int k = lane & 15;
    const int half = lane & 16;
    for (int a0 = 2 * warp; a0 < n_act; a0 += 2 * kWarps) {
      const int a = a0 + (half >> 4);
      const bool in = a < n_act && k < vo;
      float x = 0.0f, y = 0.0f, ax = 0.0f, ay = 0.0f, mn = 0.0f, mx = 0.0f;
      if (in) {
        const size_t at = ((size_t)v * n_obs + ids[a]) * vo + k;
        x = obs.ox[at];
        y = obs.oy[at];
        ax = obs.oax[at];
        ay = obs.oay[at];
        mn = obs.omn[at];
        mx = obs.omx[at];
      }
      const float x_prev = __shfl_up_sync(0xffffffffu, x, 1, 16);
      const float y_prev = __shfl_up_sync(0xffffffffu, y, 1, 16);
      const bool vertex = in && (k == 0 || x != x_prev || y != y_prev);
      const bool axis = in && (ax != 0.0f || ay != 0.0f);
      const unsigned below = (1u << k) - 1u;
      const unsigned vs =
          (__ballot_sync(0xffffffffu, vertex) >> half) & 0xffffu;
      const unsigned as =
          (__ballot_sync(0xffffffffu, axis) >> half) & 0xffffu;
      if (vertex) {
        const int at = __popc(vs & below) * cap + a;
        svx[at] = x;
        svy[at] = y;
      }
      if (axis) {
        const int at = __popc(as & below) * cap + a;
        sax[at] = ax;
        say[at] = ay;
        smn[at] = mn;
        smx[at] = mx;
      }
      if (k == 0 && a < n_act) {
        n_verts[a] = __popc(vs);
        n_axes[a] = __popc(as);
      }
    }
    __syncthreads();

    // kSatLanes lanes (a group) a candidate, grid-stride over candidates
    const int rounds = (n_act + kSatLanes - 1) / kSatLanes;
    for (int c = blockIdx.x * kGroups + threadIdx.x / kSatLanes; c < c_total;
         c += gridDim.x * kGroups) {
      if (!undecided(live, out, row + c, first, g_lane == 0)) continue;
      float px[kMaxVa], py[kMaxVa], nax[kMaxVa], nay[kMaxVa], cmn[kMaxVa],
          cmx[kMaxVa];
      cands.get(v, c, px, py);
      // the candidate's normalized axes and extents: lane i < VA of the
      // group computes axis i (edge i -> i + 1), then every lane takes all
      // of them by shuffles
      float x0 = px[0], y0 = py[0], x1 = px[0], y1 = py[0];
#pragma unroll
      for (int i = 0; i < kMaxVa; ++i) {
        const int i1 = (i + 1) % kMaxVa;
        const bool wrap = i + 1 >= va;
        if (i == g_lane) {
          x0 = px[i];
          y0 = py[i];
          x1 = wrap ? px[0] : px[i1];
          y1 = wrap ? py[0] : py[i1];
        }
      }
      {
        const float ax = -(y1 - y0);
        const float ay = x1 - x0;
        const float norm =
            fmaxf(__fsqrt_rn(__fmaf_rn(ay, ay, __fmul_rn(ax, ax))), 1e-9f);
        const float my_ax = __fdiv_rn(ax, norm);
        const float my_ay = __fdiv_rn(ay, norm);
        float my_mn = INFINITY, my_mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kMaxVa; ++w) {
          if (w < va) {
            const float p = project(my_ax, my_ay, px[w], py[w]);
            my_mn = fminf(my_mn, p);
            my_mx = fmaxf(my_mx, p);
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxVa; ++i) {
          if (i < va) {
            nax[i] = __shfl_sync(group_mask, my_ax, i, kSatLanes);
            nay[i] = __shfl_sync(group_mask, my_ay, i, kSatLanes);
            cmn[i] = __shfl_sync(group_mask, my_mn, i, kSatLanes);
            cmx[i] = __shfl_sync(group_mask, my_mx, i, kSatLanes);
          }
        }
      }
      bool hit = false;
      for (int r = 0; r < rounds; ++r) {
        const int a = r * kSatLanes + g_lane;
        bool sep = true;
        if (a < n_act) {
          // candidate vertices on the obstacle's axes
          sep = false;
          const int na = n_axes[a];
          for (int j = 0; j < na && !sep; ++j) {
            const float ax = sax[j * cap + a], ay = say[j * cap + a];
            float mn = INFINITY, mx = -INFINITY;
#pragma unroll
            for (int w = 0; w < kMaxVa; ++w) {
              if (w < va) {
                const float p = project(ax, ay, px[w], py[w]);
                mn = fminf(mn, p);
                mx = fmaxf(mx, p);
              }
            }
            sep = (mn - smx[j * cap + a] > 0.0f) ||
                  (smn[j * cap + a] - mx > 0.0f);
          }
          // obstacle vertices on the candidate's axes
          const int nv = n_verts[a];
#pragma unroll
          for (int i = 0; i < kMaxVa; ++i) {
            if (sep || i >= va || (nax[i] == 0.0f && nay[i] == 0.0f)) continue;
            float mn = INFINITY, mx = -INFINITY;
            for (int w = 0; w < nv; ++w) {
              const float p =
                  project(nax[i], nay[i], svx[w * cap + a], svy[w * cap + a]);
              mn = fminf(mn, p);
              mx = fmaxf(mx, p);
            }
            sep = (cmn[i] - mx > 0.0f) || (mn - cmx[i] > 0.0f);
          }
        }
        if (__any_sync(group_mask, !sep)) {
          hit = true;
          break;
        }
      }
      if (g_lane == 0 && (first || hit)) {
        out[row + c] = (live != nullptr) ? !hit : hit;
      }
    }
    __syncthreads();  // the scan reads the stage the next round refills
  }
}

// Launch sat_hits_kernel<Cands> on a resident grid, staging `cap`
// obstacles a round.
template <class Cands>
int launch_sat(const SatObstacles& obs, const Cands& cands,
               const uint8_t* live, uint8_t* out, int v, int c_total,
               int cap, void* stream) {
  if (cap < 1 || obs.vo > kSatMaxVo) return (int)cudaErrorInvalidValue;
  const size_t smem = obs.stage_bytes(cap);
  const dim3 grid = resident_grid((const void*)sat_hits_kernel<Cands>, smem,
                                  kThreads / kSatLanes, v, c_total);
  sat_hits_kernel<Cands><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      obs, cands, live, out, c_total, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Common tail of every entry: live [V, C] u8 or null; out [V, C] u8; cap,
// the entries a stage round holds (segments for the crossing kernels,
// obstacles for SAT; pdmpc_torch/ops/collision.py stage_plan sizes it to
// the shared-memory budget). Each returns the cudaError_t of the launch.

// cx, cy: [V, VA, C] f32; ox, oy: [V, NO, VO] f32; edge_ok: [V, NO, VO] i32.
int outline_hits(const float* cx, const float* cy, const float* ox,
                 const float* oy, const int32_t* edge_ok,
                 const uint8_t* live, uint8_t* out, int v, int va, int c,
                 int n_obs, int vo, int cap, void* stream) {
  return launch(OutlineSegs{ox, oy, edge_ok, n_obs, vo},
                PolyCands{cx, cy, va, c}, live, out, v, c, cap, stream);
}

// The lattice form: C = B * n candidates built from table [n, n, VA, 2],
// trim [V, B] i64, pose [V, B, 3] and cos, sin [V, B] (strides in
// elements); obstacles as above.
int outline_hits_lattice(const float* table, int n, int va,
                         const int64_t* trim, long long trim_sv,
                         long long trim_sb, const float* pose,
                         long long pose_sv, long long pose_sb,
                         const float* cos_yaw, const float* sin_yaw,
                         long long cs_sv, long long cs_sb, const float* ox,
                         const float* oy, const int32_t* edge_ok,
                         const uint8_t* live, uint8_t* out, int v, int b,
                         int n_obs, int vo, int cap, void* stream) {
  return launch(OutlineSegs{ox, oy, edge_ok, n_obs, vo},
                lattice(table, n, va, trim, trim_sv, trim_sb, pose, pose_sv,
                        pose_sb, cos_yaw, sin_yaw, cs_sv, cs_sb),
                live, out, v, b * n, cap, stream);
}

// cx, cy: [V, VA, C] f32; packed: [V, 8, S_pad] f32; mask: [V, S_pad] i32.
int boundary_hits(const float* cx, const float* cy, const float* packed,
                  const int32_t* mask, const uint8_t* live, uint8_t* out,
                  int v, int va, int c, int s_pad, int cap, void* stream) {
  return launch(BoundarySegs{packed, mask, s_pad},
                PolyCands{cx, cy, va, c}, live, out, v, c, cap, stream);
}

// The lattice form of boundary_hits; arguments as outline_hits_lattice.
int boundary_hits_lattice(const float* table, int n, int va,
                          const int64_t* trim, long long trim_sv,
                          long long trim_sb, const float* pose,
                          long long pose_sv, long long pose_sb,
                          const float* cos_yaw, const float* sin_yaw,
                          long long cs_sv, long long cs_sb,
                          const float* packed, const int32_t* mask,
                          const uint8_t* live, uint8_t* out, int v, int b,
                          int s_pad, int cap, void* stream) {
  return launch(BoundarySegs{packed, mask, s_pad},
                lattice(table, n, va, trim, trim_sv, trim_sb, pose, pose_sv,
                        pose_sb, cos_yaw, sin_yaw, cs_sv, cs_sb),
                live, out, v, b * n, cap, stream);
}

// cx, cy: [V, VA, C] f32; ox, oy, oax, oay, omn, omx: [V, NO, VO] f32
// with VO <= 16; mask: [V, NO] i32; live, out as above.
int sat_hits(const float* cx, const float* cy, const float* ox,
             const float* oy, const float* oax, const float* oay,
             const float* omn, const float* omx, const int32_t* mask,
             const uint8_t* live, uint8_t* out, int v, int va, int c,
             int n_obs, int vo, int cap, void* stream) {
  return launch_sat(
      SatObstacles{ox, oy, oax, oay, omn, omx, mask, n_obs, vo},
      PolyCands{cx, cy, va, c}, live, out, v, c, cap, stream);
}

// The lattice form of sat_hits; lattice arguments as outline_hits_lattice,
// obstacles as sat_hits.
int sat_hits_lattice(const float* table, int n, int va, const int64_t* trim,
                     long long trim_sv, long long trim_sb, const float* pose,
                     long long pose_sv, long long pose_sb,
                     const float* cos_yaw, const float* sin_yaw,
                     long long cs_sv, long long cs_sb, const float* ox,
                     const float* oy, const float* oax, const float* oay,
                     const float* omn, const float* omx,
                     const int32_t* mask, const uint8_t* live, uint8_t* out,
                     int v, int b, int n_obs, int vo, int cap,
                     void* stream) {
  return launch_sat(
      SatObstacles{ox, oy, oax, oay, omn, omx, mask, n_obs, vo},
      lattice(table, n, va, trim, trim_sv, trim_sb, pose, pose_sv, pose_sb,
              cos_yaw, sin_yaw, cs_sv, cs_sb),
      live, out, v, b * n, cap, stream);
}

}  // extern "C"
