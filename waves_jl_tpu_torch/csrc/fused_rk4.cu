// Fused RK4 step of the 12-channel split-field PML acoustic system, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel built by `make_fused_acoustic_step`
// (waves_jl_tpu/ops/pallas_fd.py:88, `pl.pallas_call` at :432) in its
// single-device modes:
//   K1, general (`radii_only=False`): every stage lerps all cylinders and
//       rasterises the wavespeed, summing where cylinders overlap and using
//       c0 where none covers a cell (`rasterize`, :227).
//   K2, radii-only (`radii_only=True`): `select_owner` (:247) picks each
//       cell's owning cylinder once per window into five per-cell fields
//       [d2, r1, dr, c1, dc]; each stage then does one compare
//       (`rasterize_fast`, :271).
//
// What bounds it on the card: bytes. One RK4 step must at least read and
// write the 12 x n x n float32 state; at 700^2 that is 2 x 23.52 MB =
// 47.0 MB, 14.0 us at 3.35 TB/s. The arithmetic, about 2e8 float32
// operations a step at 700^2 (`step_flops` in ops/fused_rk4.py), takes
// about 3 us at 67 TFLOP/s.
//
// What this simple design does about it: one launch per RK4 stage and one
// thread per cell. A thread forms the stage input u + a*k_prev at its cell
// and at the +-1 neighbours (+-2 at the edges) that the stencils read, and
// writes all 12 channels of the stage's right-hand side. Stages 1-3 write
// k1..k3 to device memory; stage 4 forms k4 in registers and writes
// u + dt/6 (k1 + 2k2 + 2k3 + k4) with the per-block energy partials. That
// moves about 14 state-sized arrays a step instead of 2 (the neighbour
// reads mostly hit L1/L2), so the kernel runs several times above its
// bound. Fusing the four stages behind shared-memory halos is later work.
//
// K3, candidate-batched (`batch=K`, :121-127, :162-170, :403-406, :431,
// :450-456), in both rasterisation modes: K independent states advance
// through the same time step in one launch. blockIdx.z is the candidate;
// it offsets the state, k1..k3, out, cylinder, owner and energy-partial
// pointers, while the source shape and the PML profile are shared. A
// launch with one candidate is K1 or K2, so each candidate's state is bit
// for bit what K1 or K2 computes for it alone. The TPU kernel's padded
// layout and DMA semaphores have no counterpart here: a 350^2 grid is only
// 11 x 44 = 484 blocks against 132 SMs, and 16 candidates make 7,744.
// Its bound is K times a step's: at 350^2 and K = 16 the states in and out
// are 16 x 2 x 5.88 MB = 188.2 MB, 56.2 us at 3.35 TB/s.
//
// Numerics: the library is compiled with -fmad=false, so every a*b+c
// rounds twice, as in the plain PyTorch version and the JAX kernel. The op
// order follows `stack_rhs` (:315) and the closed-form combine (:371-374).
// Energy partials are reduced in a fixed order, so runs are deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // threads along y, the contiguous axis
constexpr int BY = 8;   // threads along x
constexpr int MAX_CYL = 64;
constexpr float TWO_PI = 6.28318530717958647692f;

struct Geometry {
  int n;
  float spacing;
  float inv2d;  // 1 / (2 spacing)
  float x_min;
  float c0;
  float freq;
};

// Value of the stage input u + a * kp at flat index q (MODE 0: u itself).
template <int MODE>
struct StageInput {
  const float* __restrict__ u;
  const float* __restrict__ kp;
  float a;
  __device__ __forceinline__ float operator()(int q) const {
    if (MODE == 0) return __ldg(u + q);
    return __ldg(u + q) + a * __ldg(kp + q);
  }
};

// Edge-aware first derivative along an axis: central in the interior,
// one-sided at index 0 and n-1 (pallas_fd.py:59-86). `p` is the cell's
// flat index, `stride` the flat distance of one step along the axis.
template <typename G>
__device__ __forceinline__ float d_edge(const G& g, int i, int n, int p, int stride,
                                        float inv2d) {
  float d;
  if (i == 0) {
    d = -3.0f * g(p) + 4.0f * g(p + stride) - g(p + 2 * stride);
  } else if (i == n - 1) {
    d = 3.0f * g(p) - 4.0f * g(p - stride) + g(p - 2 * stride);
  } else {
    d = g(p + stride) - g(p - stride);
  }
  return d * inv2d;
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

// MODE 0: k1 = rhs(u).  MODE 1: out = rhs(u + a*kp).
// MODE 2: k4 = rhs(u + a*kp) with kp = k3; out = u + sixth*(k1+2k2+2k3+k4),
//         and partials[block] = [sum u_tot^2, sum u_inc^2, sum (u_tot-u_inc)^2].
// Candidate blockIdx.z reads and writes its own (12, n, n) state slices,
// (8, n_cyl) cylinders, (5, n, n) owner fields and partial rows.
template <int MODE, bool RADII>
__global__ void __launch_bounds__(BX * BY)
rk4_stage(const float* __restrict__ u, const float* __restrict__ kp, float a,
          const float* __restrict__ k1, const float* __restrict__ k2, float sixth,
          float* __restrict__ out, float* __restrict__ partials,
          const float* __restrict__ shape, const float* __restrict__ prof,
          const float* __restrict__ cyl, int n_cyl, const float* __restrict__ owner,
          Geometry g, float ts, float ti, float tf) {
  __shared__ float s_cyl[8 * MAX_CYL];
  __shared__ float red[BX * BY / 32];
  const int n = g.n;
  const int nn = n * n;
  const size_t cand = blockIdx.z;
  const size_t so = cand * 12 * (size_t)nn;
  u += so;
  out += so;
  if (MODE > 0) kp += so;
  if (MODE == 2) {
    k1 += so;
    k2 += so;
  }
  if (RADII) {
    owner += cand * 5 * (size_t)nn;
  } else {
    cyl += cand * 8 * (size_t)n_cyl;
    for (int k = threadIdx.y * BX + threadIdx.x; k < 8 * n_cyl; k += BX * BY) s_cyl[k] = cyl[k];
    __syncthreads();
  }
  const int j = blockIdx.x * BX + threadIdx.x;  // y index
  const int i = blockIdx.y * BY + threadIdx.y;  // x index
  float e_tot = 0.0f, e_inc = 0.0f, e_sc = 0.0f;

  if (i < n && j < n) {
    const int p = i * n + j;
    const StageInput<MODE> v{u, kp, a};

    const float span = tf - ti;
    const float denom = span > 0.0f ? span : 1.0f;
    const float w = (fminf(fmaxf(ts, ti), tf) - ti) / denom;
    const float sn = sinf(TWO_PI * ts * g.freq);

    float c;
    if (RADII) {
      const float r = __ldg(owner + nn + p) + w * __ldg(owner + 2 * nn + p);
      const bool m = __ldg(owner + p) < r * r;
      c = m ? __ldg(owner + 3 * nn + p) + w * __ldg(owner + 4 * nn + p) : g.c0;
    } else {
      const float x = g.x_min + (float)i * g.spacing;
      const float y = g.x_min + (float)j * g.spacing;
      float csum = 0.0f, inside = 0.0f;
      for (int q = 0; q < n_cyl; ++q) {
        const float* cq = s_cyl + q;  // rows [p1x, p1y, r1, c1, p2x, p2y, r2, c2]
        const float px = cq[0] + w * (cq[4 * n_cyl] - cq[0]);
        const float py = cq[n_cyl] + w * (cq[5 * n_cyl] - cq[n_cyl]);
        const float rq = cq[2 * n_cyl] + w * (cq[6 * n_cyl] - cq[2 * n_cyl]);
        const float ccq = cq[3 * n_cyl] + w * (cq[7 * n_cyl] - cq[3 * n_cyl]);
        const float ddx = x - px;
        const float ddy = y - py;
        const float d2 = ddx * ddx + ddy * ddy;
        if (d2 < rq * rq) {
          csum = csum + ccq;
          inside = inside + 1.0f;
        }
      }
      c = inside == 0.0f ? g.c0 : csum;
    }

    const float sx = __ldg(prof + i);
    const float sy = __ldg(prof + j);
    const float bc = (i > 0 && i < n - 1 && j > 0 && j < n - 1) ? 1.0f : 0.0f;

#pragma unroll
    for (int stack = 0; stack < 2; ++stack) {
      const int o = 6 * stack * nn;
      const float b = stack == 0 ? c * c : g.c0 * g.c0;
      auto uf = [&](int q) { return v(o + q) + __ldg(shape + q) * sn; };  // U + f
      auto vx = [&](int q) { return v(o + nn + q); };
      auto vy = [&](int q) { return v(o + 2 * nn + q); };
      const float Vxx = d_edge(vx, i, n, p, n, g.inv2d);
      const float Vyy = d_edge(vy, j, n, p, 1, g.inv2d);
      const float Ux = d_edge(uf, i, n, p, n, g.inv2d);
      const float Uy = d_edge(uf, j, n, p, 1, g.inv2d);
      const float U = v(o + p);
      const float Px = v(o + 3 * nn + p);
      const float Py = v(o + 4 * nn + p);
      const float Om = v(o + 5 * nn + p);
      float k[6];
      k[0] = bc * (b * (Vxx + Vyy) + Px + Py - (sx + sy) * U - Om);
      k[1] = Ux - sx * vx(p);
      k[2] = Uy - sy * vy(p);
      k[3] = b * sx * Vyy;
      k[4] = b * sy * Vxx;
      k[5] = sx * sy * U;
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        const int q = o + ch * nn + p;
        if (MODE < 2) {
          out[q] = k[ch];
        } else {
          const float un = __ldg(u + q) +
                           sixth * (__ldg(k1 + q) + 2.0f * __ldg(k2 + q) + 2.0f * __ldg(kp + q) + k[ch]);
          out[q] = un;
          if (ch == 0) {
            if (stack == 0) e_tot = un; else e_inc = un;
          }
        }
      }
    }
    if (MODE == 2) {
      const float sc = e_tot - e_inc;
      e_sc = sc * sc;
      e_tot = e_tot * e_tot;
      e_inc = e_inc * e_inc;
    }
  }

  if (MODE == 2) {
    const float s_tot = block_sum(e_tot, red);
    const float s_inc = block_sum(e_inc, red);
    const float s_sc = block_sum(e_sc, red);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      const size_t blocks = (size_t)gridDim.x * gridDim.y;
      float* dst = partials + 3 * (cand * blocks + blockIdx.y * gridDim.x + blockIdx.x);
      dst[0] = s_tot;
      dst[1] = s_inc;
      dst[2] = s_sc;
    }
  }
}

// Owner fields of the radii-only mode, once per window: for each cell the
// cylinder with the smallest gap d2 - rmax^2 (first in order on ties), as
// owner[0..4] = [d2, r1, r2 - r1, c1, c2 - c1]. Exact when the circles at
// their largest radii are disjoint and positions and speeds are fixed.
// Candidate blockIdx.z has its own radii, so its own rmax, gaps and owner.
__global__ void __launch_bounds__(BX * BY)
select_owner_kernel(const float* __restrict__ cyl, int n_cyl, float* __restrict__ owner,
                    Geometry g) {
  __shared__ float s_cyl[8 * MAX_CYL];
  cyl += (size_t)blockIdx.z * 8 * n_cyl;
  owner += (size_t)blockIdx.z * 5 * g.n * g.n;
  for (int k = threadIdx.y * BX + threadIdx.x; k < 8 * n_cyl; k += BX * BY) s_cyl[k] = cyl[k];
  __syncthreads();
  const int n = g.n;
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  if (i >= n || j >= n) return;
  const float x = g.x_min + (float)i * g.spacing;
  const float y = g.x_min + (float)j * g.spacing;
  float best = 1e30f, d2o = 1e30f, r1 = 0.0f, dr = 0.0f, c1 = 0.0f, dc = 0.0f;
  for (int q = 0; q < n_cyl; ++q) {
    const float* cq = s_cyl + q;
    const float ddx = x - cq[0];
    const float ddy = y - cq[n_cyl];
    const float d2 = ddx * ddx + ddy * ddy;
    const float rmax = fmaxf(cq[2 * n_cyl], cq[6 * n_cyl]);
    const float gap = d2 - rmax * rmax;
    if (gap < best) {
      best = gap;
      d2o = d2;
      r1 = cq[2 * n_cyl];
      dr = cq[6 * n_cyl] - cq[2 * n_cyl];
      c1 = cq[3 * n_cyl];
      dc = cq[7 * n_cyl] - cq[3 * n_cyl];
    }
  }
  const int nn = n * n;
  const int p = i * n + j;
  owner[p] = d2o;
  owner[nn + p] = r1;
  owner[2 * nn + p] = dr;
  owner[3 * nn + p] = c1;
  owner[4 * nn + p] = dc;
}

dim3 grid_for(int n, int batch) {
  return dim3((n + BX - 1) / BX, (n + BY - 1) / BY, batch);
}

}  // namespace

extern "C" {

// Number of energy-partial rows (blocks) a final stage writes for an n x n
// grid, per candidate.
int fused_rk4_blocks(int n) {
  const dim3 gr = grid_for(n, 1);
  return (int)(gr.x * gr.y);
}

// One RK4 stage for `batch` candidates (K3; K1 or K2 of a single state
// when batch is 1). `mode` 0, 1 or 2 as for `rk4_stage`, `radii` selects the owner test.
// u, kp, k1, k2 and out are (batch, 12, n, n), cyl (batch, 8, n_cyl), owner
// (batch, 5, n, n), partials (batch, fused_rk4_blocks(n), 3); shape (n, n)
// and prof (n) are shared. Returns the cudaError_t of the launch.
int fused_rk4_stage(int batch, int mode, int radii, const float* u, const float* kp, float a,
                    const float* k1, const float* k2, float sixth, float* out, float* partials,
                    const float* shape, const float* prof, const float* cyl, int n_cyl,
                    const float* owner, int n, float spacing, float inv2d, float x_min, float c0,
                    float freq, float ts, float ti, float tf, void* stream) {
  if (n < 3 || n_cyl < 0 || n_cyl > MAX_CYL || mode < 0 || mode > 2 || batch < 1 ||
      batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{n, spacing, inv2d, x_min, c0, freq};
  const dim3 block(BX, BY);
  const dim3 gr = grid_for(n, batch);
  cudaStream_t s = (cudaStream_t)stream;
#define WAVES_LAUNCH(M, R)                                                               \
  rk4_stage<M, R><<<gr, block, 0, s>>>(u, kp, a, k1, k2, sixth, out, partials, shape, \
                                       prof, cyl, n_cyl, owner, g, ts, ti, tf)
  if (radii) {
    if (mode == 0) WAVES_LAUNCH(0, true);
    else if (mode == 1) WAVES_LAUNCH(1, true);
    else WAVES_LAUNCH(2, true);
  } else {
    if (mode == 0) WAVES_LAUNCH(0, false);
    else if (mode == 1) WAVES_LAUNCH(1, false);
    else WAVES_LAUNCH(2, false);
  }
#undef WAVES_LAUNCH
  return (int)cudaGetLastError();
}

// Owner fields (batch, 5, n, n) of `batch` candidates' cylinders
// (batch, 8, n_cyl); batch 1 for a single state.
int select_owner(int batch, const float* cyl, int n_cyl, float* owner, int n, float spacing,
                 float x_min, void* stream) {
  if (n < 3 || n_cyl < 0 || n_cyl > MAX_CYL || batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{n, spacing, 0.0f, x_min, 0.0f, 0.0f};
  select_owner_kernel<<<grid_for(n, batch), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      cyl, n_cyl, owner, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
