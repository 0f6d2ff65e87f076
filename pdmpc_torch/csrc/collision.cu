// Collision masks of the beam search for Hopper (sm_90a), bound to Python
// with ctypes (pdmpc_torch/ops/collision.py builds and loads this file).
//
// outline_hits  replaces pdmpc_tpu/ops/pallas_collision.py::_outline_kernel
//               (reached through outline_hits_pre);
// boundary_hits replaces pdmpc_tpu/ops/pallas_collision.py::_boundary_kernel
//               (reached through boundary_hits_pre).
//
// Both compute, per candidate polygon, whether any of its edges crosses any
// active segment (an obstacle edge or a lanelet-boundary segment), with the
// tolerant division-free predicate of pdmpc_tpu/ops/search.py
// (_segment_cross_predicate, SEG_CROSS_TOL = 1e-4) in its XLA form:
//   r = a2 - a1, s = b2 - b1, qp = b1 - a1,
//   d = r x s, A = qp x s, B = qp x r.
// (The Pallas kernels build A as b1 x s - a1 x s; the CPU goldens were made
// with the XLA form, so this source follows it.) Build with -fmad=false:
// every product is rounded on its own, as in the plain PyTorch versions, so
// kernel and plain version agree bit for bit.
//
// Design: grid (candidate blocks, vehicles); one thread per candidate holds
// its polygon in registers. The block first compacts its vehicle's active
// segments (masked obstacles and degenerate padded edges dropped: both can
// never cross) into shared memory, then every thread scans them and stops
// at its first hit. The work is bounded by operations (candidate edges x
// active segments), not by the few hundred KB of inputs.
//
// sat_hits replaces pdmpc_tpu/ops/pallas_collision.py::_sat_kernel (reached
// through sat_hits_pre): per candidate convex polygon, whether it overlaps
// an active convex obstacle, i.e. no edge normal of either polygon separates
// them. It follows the XLA form of pdmpc_tpu/ops/search.py
// (_sat_separates_batch), not the Pallas kernel's unnormalized axes:
//   axis = (-ey, ex) / max(sqrt(fma(ay, ay, ax * ax)), 1e-9),
//   projection = fma(ay, y, ax * x),
//   separated on an axis iff min(pa) - max(pb) > 0 or min(pb) - max(pa) > 0,
// each multiply-add fused with __fmaf_rn, the square root and the division
// rounded to nearest (pdmpc_torch/ops/collision.py says why). Same design:
// the candidate's vertices, normalized axes and own extents in registers;
// the vehicle's active obstacles (vertices, normalized axes and own-axis
// extents from the bundle) compacted into shared memory; per obstacle the
// candidate's axes first, then the obstacle's, leaving at the first
// separating axis, and the candidate leaves at its first overlap. Zero axes
// (repeated vertices) project everything to 0 and never separate: skipped.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVa = 8;
constexpr float kTol = 1e-4f;
constexpr float kOnePlusTol = 1.0001f;

struct Seg {
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

// Scan the staged segments for candidate `c` of vehicle `v`.
__device__ __forceinline__ void scan_candidate(
    const float* __restrict__ cx, const float* __restrict__ cy,
    uint8_t* __restrict__ out, const Seg* segs, int n_segs, int v, int va,
    int c_total, int c) {
  if (c >= c_total) return;
  float ax[kMaxVa], ay[kMaxVa];
  const size_t base = (size_t)v * va * c_total + c;
#pragma unroll
  for (int i = 0; i < kMaxVa; ++i) {
    if (i < va) {
      ax[i] = cx[base + (size_t)i * c_total];
      ay[i] = cy[base + (size_t)i * c_total];
    }
  }
  bool hit = false;
  for (int i = 0; i < va && !hit; ++i) {
    const int j = (i + 1 == va) ? 0 : i + 1;
    const float rx = ax[j] - ax[i];
    const float ry = ay[j] - ay[i];
    for (int e = 0; e < n_segs; ++e) {
      const Seg s = segs[e];
      if (crosses(rx, ry, s.b1x - ax[i], s.b1y - ay[i], s.sx, s.sy)) {
        hit = true;
        break;
      }
    }
  }
  out[(size_t)v * c_total + c] = hit ? 1 : 0;
}

__global__ void outline_hits_kernel(const float* __restrict__ cx,
                                    const float* __restrict__ cy,
                                    const float* __restrict__ ox,
                                    const float* __restrict__ oy,
                                    const int32_t* __restrict__ edge_ok,
                                    uint8_t* __restrict__ out, int va,
                                    int c_total, int n_obs, int vo) {
  extern __shared__ Seg segs[];
  __shared__ int n_segs;
  const int v = blockIdx.y;
  if (threadIdx.x == 0) n_segs = 0;
  __syncthreads();
  const int n_edges = n_obs * vo;
  const size_t obase = (size_t)v * n_edges;
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) {
    if (edge_ok[obase + e] == 0) continue;
    const int o = e / vo;
    const int k = e - o * vo;
    const int k1 = (k + 1 == vo) ? 0 : k + 1;
    const float b1x = ox[obase + e], b1y = oy[obase + e];
    Seg s;
    s.b1x = b1x;
    s.b1y = b1y;
    s.sx = ox[obase + (size_t)o * vo + k1] - b1x;
    s.sy = oy[obase + (size_t)o * vo + k1] - b1y;
    segs[atomicAdd(&n_segs, 1)] = s;
  }
  __syncthreads();
  scan_candidate(cx, cy, out, segs, n_segs, v, va, c_total,
                 blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void boundary_hits_kernel(const float* __restrict__ cx,
                                     const float* __restrict__ cy,
                                     const float* __restrict__ packed,
                                     const int32_t* __restrict__ mask,
                                     uint8_t* __restrict__ out, int va,
                                     int c_total, int s_pad) {
  extern __shared__ Seg segs[];
  __shared__ int n_segs;
  const int v = blockIdx.y;
  if (threadIdx.x == 0) n_segs = 0;
  __syncthreads();
  const float* p = packed + (size_t)v * 8 * s_pad;  // rows sx, sy, b1x, b1y
  for (int e = threadIdx.x; e < s_pad; e += blockDim.x) {
    if (mask[(size_t)v * s_pad + e] == 0) continue;
    Seg s;
    s.sx = p[e];
    s.sy = p[s_pad + e];
    s.b1x = p[2 * s_pad + e];
    s.b1y = p[3 * s_pad + e];
    segs[atomicAdd(&n_segs, 1)] = s;
  }
  __syncthreads();
  scan_candidate(cx, cy, out, segs, n_segs, v, va, c_total,
                 blockIdx.x * blockDim.x + threadIdx.x);
}

__device__ __forceinline__ float project(float ax, float ay, float x,
                                         float y) {
  return __fmaf_rn(ay, y, __fmul_rn(ax, x));
}

// Stage rows per active obstacle in shared memory: x, y, ax, ay, mn, mx,
// each `vo` floats.
constexpr int kSatRows = 6;

__global__ void sat_hits_kernel(
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oax, const float* __restrict__ oay,
    const float* __restrict__ omn, const float* __restrict__ omx,
    const int32_t* __restrict__ mask, uint8_t* __restrict__ out, int va,
    int c_total, int n_obs, int vo) {
  extern __shared__ float stage[];  // [n_active][kSatRows][vo], then ids
  int* active_ids = reinterpret_cast<int*>(stage + n_obs * kSatRows * vo);
  __shared__ int n_active;
  const int v = blockIdx.y;
  if (threadIdx.x == 0) n_active = 0;
  __syncthreads();
  for (int o = threadIdx.x; o < n_obs; o += blockDim.x) {
    if (mask[(size_t)v * n_obs + o] > 0) {
      active_ids[atomicAdd(&n_active, 1)] = o;
    }
  }
  __syncthreads();
  const int n_act = n_active;
  const float* fields[kSatRows] = {ox, oy, oax, oay, omn, omx};
  for (int e = threadIdx.x; e < n_act * kSatRows * vo; e += blockDim.x) {
    const int a = e / (kSatRows * vo);
    const int r = (e / vo) % kSatRows;
    const int k = e % vo;
    stage[e] = fields[r][((size_t)v * n_obs + active_ids[a]) * vo + k];
  }
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c_total) return;
  float px[kMaxVa], py[kMaxVa], nax[kMaxVa], nay[kMaxVa], cmn[kMaxVa],
      cmx[kMaxVa];
  const size_t base = (size_t)v * va * c_total + c;
#pragma unroll
  for (int i = 0; i < kMaxVa; ++i) {
    if (i < va) {
      px[i] = cx[base + (size_t)i * c_total];
      py[i] = cy[base + (size_t)i * c_total];
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxVa; ++i) {
    if (i < va) {
      const int j = (i + 1 == va) ? 0 : i + 1;
      const float ax = -(py[j] - py[i]);
      const float ay = px[j] - px[i];
      const float norm =
          fmaxf(__fsqrt_rn(__fmaf_rn(ay, ay, __fmul_rn(ax, ax))), 1e-9f);
      nax[i] = __fdiv_rn(ax, norm);
      nay[i] = __fdiv_rn(ay, norm);
      float mn = INFINITY, mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kMaxVa; ++w) {
        if (w < va) {
          const float p = project(nax[i], nay[i], px[w], py[w]);
          mn = fminf(mn, p);
          mx = fmaxf(mx, p);
        }
      }
      cmn[i] = mn;
      cmx[i] = mx;
    }
  }

  bool hit = false;
  for (int a = 0; a < n_act && !hit; ++a) {
    const float* sx = stage + a * kSatRows * vo;
    const float* sy = sx + vo;
    const float* sax = sy + vo;
    const float* say = sax + vo;
    const float* smn = say + vo;
    const float* smx = smn + vo;
    bool sep = false;
    // obstacle vertices on the candidate's axes
#pragma unroll
    for (int i = 0; i < kMaxVa; ++i) {
      if (sep || i >= va || (nax[i] == 0.0f && nay[i] == 0.0f)) continue;
      float mn = INFINITY, mx = -INFINITY;
      for (int w = 0; w < vo; ++w) {
        const float p = project(nax[i], nay[i], sx[w], sy[w]);
        mn = fminf(mn, p);
        mx = fmaxf(mx, p);
      }
      sep = (cmn[i] - mx > 0.0f) || (mn - cmx[i] > 0.0f);
    }
    // candidate vertices on the obstacle's axes
    for (int k = 0; k < vo && !sep; ++k) {
      const float ax = sax[k], ay = say[k];
      if (ax == 0.0f && ay == 0.0f) continue;
      float mn = INFINITY, mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kMaxVa; ++w) {
        if (w < va) {
          const float p = project(ax, ay, px[w], py[w]);
          mn = fminf(mn, p);
          mx = fmaxf(mx, p);
        }
      }
      sep = (mn - smx[k] > 0.0f) || (smn[k] - mx > 0.0f);
    }
    hit = !sep;
  }
  out[(size_t)v * c_total + c] = hit ? 1 : 0;
}

}  // namespace

extern "C" {

// cx, cy: [V, VA, C] f32; ox, oy: [V, NO, VO] f32; edge_ok: [V, NO, VO] i32;
// out: [V, C] u8. Returns the cudaError_t of the launch.
int outline_hits(const float* cx, const float* cy, const float* ox,
                 const float* oy, const int32_t* edge_ok, uint8_t* out, int v,
                 int va, int c, int n_obs, int vo, void* stream) {
  const dim3 grid((c + kThreads - 1) / kThreads, v);
  const size_t smem = (size_t)n_obs * vo * sizeof(Seg);
  outline_hits_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, ox, oy, edge_ok, out, va, c, n_obs, vo);
  return (int)cudaGetLastError();
}

// cx, cy: [V, VA, C] f32; packed: [V, 8, S_pad] f32; mask: [V, S_pad] i32;
// out: [V, C] u8. Returns the cudaError_t of the launch.
int boundary_hits(const float* cx, const float* cy, const float* packed,
                  const int32_t* mask, uint8_t* out, int v, int va, int c,
                  int s_pad, void* stream) {
  const dim3 grid((c + kThreads - 1) / kThreads, v);
  const size_t smem = (size_t)s_pad * sizeof(Seg);
  boundary_hits_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, packed, mask, out, va, c, s_pad);
  return (int)cudaGetLastError();
}

// cx, cy: [V, VA, C] f32; ox, oy, oax, oay, omn, omx: [V, NO, VO] f32;
// mask: [V, NO] i32; out: [V, C] u8. Returns the cudaError_t of the launch.
int sat_hits(const float* cx, const float* cy, const float* ox,
             const float* oy, const float* oax, const float* oay,
             const float* omn, const float* omx, const int32_t* mask,
             uint8_t* out, int v, int va, int c, int n_obs, int vo,
             void* stream) {
  const dim3 grid((c + kThreads - 1) / kThreads, v);
  const size_t smem = (size_t)n_obs * (kSatRows * vo * sizeof(float) +
                                       sizeof(int));
  sat_hits_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, ox, oy, oax, oay, omn, omx, mask, out, va, c, n_obs, vo);
  return (int)cudaGetLastError();
}

}  // extern "C"
