// What the two kernel libraries of the fused RK4 step share: the thread
// block and tile, the stencils in the plain version's op order, the
// fixed-order block reduction, the stage regions, the step's parameters
// and the window struct of the C interface.
//   fused_rk4.cu       one RK4 step a launch (`rk4_step_tiled`) and the
//                      owner pass (`select_owner_kernel`);
//   fused_rk4_multi.cu two or four RK4 steps a launch (`rk4_steps_tiled`),
//                      the Pallas kernel's `steps_per_call` with its ghost
//                      band, on the whole grid or on slabs.
// Both are compiled with -fmad=false, so every a*b+c rounds twice, as in
// the plain PyTorch version and the JAX kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // threads along y, the contiguous axis
constexpr int BY = 8;   // threads along x
constexpr int CYL_CHUNK = 64;  // cylinders staged in shared memory at a time
constexpr int HALO = 4;  // cells one RK4 step consumes on each side; a slab's halo columns
constexpr float TWO_PI = 6.28318530717958647692f;

// A block's tile in both step kernels: two of a thread's row slots by the
// columns one warp spans less a one-step halo on each side.
constexpr int TX = 2 * BY;         // tile rows (x), 16
constexpr int TY = BX - 2 * HALO;  // tile columns (y), 24

// First derivative along an axis: one-sided forward where `first`, backward
// where `last`, central elsewhere (pallas_fd.py:59-86). `p` is the cell's
// flat index, `stride` the flat distance of one step along the axis.
template <typename G>
__device__ __forceinline__ float d_edge(const G& g, bool first, bool last, int p, int stride,
                                        float inv2d) {
  float d;
  if (first) {
    d = -3.0f * g(p) + 4.0f * g(p + stride) - g(p + 2 * stride);
  } else if (last) {
    d = 3.0f * g(p) - 4.0f * g(p - stride) + g(p - 2 * stride);
  } else {
    d = g(p + stride) - g(p - stride);
  }
  return d * inv2d;
}

// K5's split of a tap value: hi = bf16(v), lo = bf16(v - hi), as floats.
struct Split {
  float hi, lo;
};

__device__ __forceinline__ Split split_bf16(float v) {
  const float hi = __bfloat162float(__float2bfloat16_rn(v));
  return Split{hi, __bfloat162float(__float2bfloat16_rn(v - hi))};
}

// First derivative along an axis as K5 takes d/dx: `d_edge`'s stencil on
// the hi parts of the taps and on their lo parts, (d_hi + d_lo) * inv2d
// (pallas_fd.py:300-310).
template <typename G>
__device__ __forceinline__ float d_split(const G& g, bool first, bool last, int p, int stride,
                                         float inv2d) {
  float d_hi, d_lo;
  if (first) {
    const Split a = split_bf16(g(p)), b = split_bf16(g(p + stride)),
                c = split_bf16(g(p + 2 * stride));
    d_hi = -3.0f * a.hi + 4.0f * b.hi - c.hi;
    d_lo = -3.0f * a.lo + 4.0f * b.lo - c.lo;
  } else if (last) {
    const Split a = split_bf16(g(p)), b = split_bf16(g(p - stride)),
                c = split_bf16(g(p - 2 * stride));
    d_hi = 3.0f * a.hi - 4.0f * b.hi + c.hi;
    d_lo = 3.0f * a.lo - 4.0f * b.lo + c.lo;
  } else {
    const Split up = split_bf16(g(p + stride)), um = split_bf16(g(p - stride));
    d_hi = up.hi - um.hi;
    d_lo = up.lo - um.lo;
  }
  return (d_hi + d_lo) * inv2d;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  // fixed-order reduction: warp shuffle, then warp 0 sums the warp totals
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int tid = threadIdx.y * BX + threadIdx.x;
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (tid == 0) {
    for (int k = 0; k < BX * BY / 32; ++k) s += red[k];
  }
  __syncthreads();
  return s;
}

// Rows or columns [lo, hi] of the whole grid.
struct Span {
  int lo, hi;
  __device__ __forceinline__ bool has(int k) const { return k >= lo && k <= hi; }
};

// The whole grid is w == n with col0 == 0. Any other (w, col0) is the
// first of `slabs` consecutive slabs with h halo columns on each side, each
// of ny = w - 2 h >= 2 h owned columns, all in the domain (a slab never has
// col0 == 0: col0 = start - h and the start is 0 or at least 2 h). Returns
// false for anything else.
inline bool valid_extent(int n, int w, int col0, int slabs, int h) {
  if (n < 3) return false;
  if (w == n && col0 == 0) return true;
  const long ny = (long)w - 2 * h;
  return h >= HALO && ny >= 2 * h && col0 + h >= 0 && col0 + h + slabs * ny <= n;
}

// Where the next stage's outputs are valid, given where its input is: one
// cell in from each side, except a side on the domain's edge, where the
// one-sided stencil reads inward only.
__device__ __forceinline__ Span shrink(Span s, int n) {
  return Span{s.lo == 0 ? 0 : s.lo + 1, s.hi == n - 1 ? s.hi : s.hi - 1};
}

// The step's parameters that do not change within a window.
struct StepParams {
  int n;
  int w;     // a slab's local columns, ny + 2 H for its halo H (SLAB only)
  int col0;  // slab 0's global column of local column 0 (SLAB only)
  float inv2d;
  float c0;
  float freq;
  float half;   // dt / 2: the k2 and k3 stage-input coefficient and time offset
  float full;   // dt
  float sixth;  // dt / 6
  float ti, tf;  // the design lerp's window
  // the general mode's: the (8, n_cyl) lerp endpoints (one table a
  // candidate, or one for all slabs), and the coordinate
  // x_min + i * spacing of row or column i
  const float* cyl;
  int n_cyl;
  float x_min, spacing;
  int shape_stride;  // floats between two candidates' source shapes: 0 shared, n * n each
  float sub[4];  // float32(st * dt): sub-step st of a call starts at t + sub[st]
};

// The right-hand side of one stack (6 channels) at region cell l, from the
// stage input in shared memory, [U, Vx, Vy] in `nb` (read at the stencil's
// neighbours) and [Psix, Psiy, Omega] in `pw` (read at l alone), each
// channel C floats on, a region row W floats on, in the plain version's op
// order: `stack_rhs` (pallas_fd.py:315) with K5's split d/dx if XM, else
// the exact one, and the exact d/dy.
template <bool XM, int W, int C>
__device__ __forceinline__ void stack_rhs_tiled(const float* nb, const float* pw,
                                                const float* s_f, float sn, float b, int l,
                                                bool x_first, bool x_last, bool y_first,
                                                bool y_last, float sx, float sy, float bc,
                                                float inv2d, float* k) {
  auto uf = [&](int q) { return nb[q] + s_f[q] * sn; };  // U + f
  auto vx = [&](int q) { return nb[C + q]; };
  auto vy = [&](int q) { return nb[2 * C + q]; };
  const float Vxx = XM ? d_split(vx, x_first, x_last, l, W, inv2d)
                       : d_edge(vx, x_first, x_last, l, W, inv2d);
  const float Vyy = d_edge(vy, y_first, y_last, l, 1, inv2d);
  const float Ux = XM ? d_split(uf, x_first, x_last, l, W, inv2d)
                      : d_edge(uf, x_first, x_last, l, W, inv2d);
  const float Uy = d_edge(uf, y_first, y_last, l, 1, inv2d);
  const float U = nb[l];
  const float Px = pw[l];
  const float Py = pw[C + l];
  const float Om = pw[2 * C + l];
  k[0] = bc * (b * (Vxx + Vyy) + Px + Py - (sx + sy) * U - Om);
  k[1] = Ux - sx * vx(l);
  k[2] = Uy - sy * vy(l);
  k[3] = b * sx * Vyy;
  k[4] = b * sy * Vxx;
  k[5] = sx * sy * U;
}

}  // namespace

// What `fused_rk4_step_tiled` and `fused_rk4_steps_tiled` take that is
// fixed for a window: built once by the caller, so that a launch marshals
// four pointers and a time. The layout is that of `_TiledWindow` in
// ops/fused_rk4.py.
struct TiledWindow {
  const float* shape;  // (n, n) shared by the candidates, (batch, n, n) one a candidate
                       // (shape_stride n * n), or (batch, n, w) a slab each
  const float* prof;   // (n)
  const float* owner;  // (batch, 5, n, w) of the radii-only mode; null: the general mode
  const float* cyl;    // (batch, 8, n_cyl) of the general mode, or (8, n_cyl) for all slabs
  void* stream;
  int batch;  // candidates on the whole grid, or slabs
  int n;
  int w;     // n on the whole grid, or a slab's local columns
  int col0;  // 0 on the whole grid, or the first slab's global column of local column 0
  int xm;    // 1: K5's split d/dx; 0: the exact one (K1, K2, K3)
  int n_cyl;
  int shape_stride;  // on the whole grid, floats between two candidates' source shapes:
                     // 0 for one shared, n * n for one a candidate
  int spc;           // RK4 steps a launch: 1 (`fused_rk4_step_tiled`), 2 or 4
                     // (`fused_rk4_steps_tiled`)
  float inv2d, c0, freq, half, full, sixth, ti, tf, x_min, spacing;
  float sub[4];  // float32(st * dt) for st < spc
};
