// Two or four RK4 steps of the 12-channel split-field PML acoustic system in
// one launch, for Hopper (sm_90a): the temporal blocking of the Pallas TPU
// kernel built by `make_fused_acoustic_step` (waves_jl_tpu/ops/pallas_fd.py:88,
// `pl.pallas_call` at :432), its `steps_per_call` (:98) with the ghost band
// (:105) the steps consume, asserted at :156-157. The kernel's sub-step loop
// (:359-386) runs sub-step st from ts0 = t + float32(st * dt) (:362) and
// writes one row of energy partials a sub-step (:383-386). The JAX package
// takes two steps a call on every whole-grid fused path whose frame segments
// are even (waves_jl_tpu/physics/fused.py:101-104, :170), and four with a
// 16-cell band in its probe (scripts_tpu/kernel_probe.py:98-102).
//
// `rk4_steps_tiled<XM, GENERAL, SPC, SLAB>` takes every mode of the
// one-step kernel (fused_rk4.cu): the split d/dx (XM, K5) or the exact one
// (K1-K4), the owner test on the (5, n, w) owner fields (K2, K5, the
// radii-only re-rank) or the general rasterisation (K1, K5 general), for one
// state or K candidates on the whole grid (blockIdx.z, each with its own
// cylinders and owner fields, the source shape shared or one a candidate),
// or on S consecutive column slabs of a y-sharded grid (SLAB, K4 and K4-XM;
// blockIdx.z the slab). The JAX package's sharded rollout pins one step a
// call (waves_jl_tpu/parallel/fused_domain.py:53-58), but its kernel's
// factory takes the slabs at SPC steps a call with `ny_local` owned columns
// and `y_ghost >= HALO * SPC` halo columns (:129-133, :156-157), columns
// indexed globally through `scalars[3]` (:195-204).
//
// The slab mode (SLAB). A slab of ny owned columns has H = 4 SPC halo
// columns on each side, w = ny + 2 H local columns (191 at 700^2 in 4
// shards at SPC 2, 207 at SPC 4); slab z's local column j is global column
// col0 + z ny + j, with its own state, source shape (n, w) and owner fields
// (5, n, w), the cylinders and the (n) profile shared. The tiles cover the
// owned columns alone, ceil(ny / TY) tile columns a slab, and a tile never
// crosses a slab's owned range. A tile's region, the tile and its band of H
// cells a side, lies inside its slab: its columns are the tile's +-H, and
// the extra column before a one-cell tile on the domain's last column lies
// inside too, since that tile is never a slab's first (it needs ny > TY).
// So the halo columns carry the neighbours' owned columns SPC steps deep,
// and the band's shrinking leaves the owned columns valid after the last
// sub-step, as the Pallas kernel's ghost columns do. The one-sided y
// stencils (`_dy_edge_aware`, :75-85), the Dirichlet mask, the y
// coordinate, the PML profile, the stage regions' shrinking and the general
// mode's cull are taken at global columns, so an owned cell is bit for bit
// the whole grid's. Each sub-step's energy partials cover the tile cells,
// which are owned (`owned`, :351-357). The kernel writes the slab's halo
// columns 0 (the blocks of the first and last tile column), as the one-step
// slab kernel does: the exchange refreshes the interior halos before the
// next launch, and the halos outside the domain stay 0. SLAB is a template
// flag, as in the one-step kernel, so the whole-grid instances keep their
// registers and spills; it doubles the instances to sixteen.
//
// What bounds it on the card: bytes, as the one-step kernel. A call must read
// and write the 12 x n x n state once for SPC steps: at 700^2, 47.0 MB in and
// out, 14.0 us at 3.35 TB/s, so 7.0 (SPC 2) or 3.5 (SPC 4) us a step, where
// the one-step kernel's bound is 14.0 us a step. The arithmetic, about 2e8
// float32 operations a step at 700^2, takes about 3 us a step at 67 TFLOP/s,
// so at SPC 4 the two bounds meet. On slabs a call reads and writes each
// slab's w columns, halos included: at 700^2 in 4 shards, 4 x 2 x 12 x 700
// x 191 x 4 B = 51.3 MB at SPC 2 (15.3 us, 7.7 a step) and 55.6 MB at SPC
// 4 (207 columns).
//   What the design does about it. Block (bx, by, z) owns the same
// TX x TY = 16 x 24 tile as the one-step kernel and loads, once a stack, its
// region: the tile with a band of H = 4 SPC cells on each side (one more row
// or column before a one-cell tile on the domain's last row or column, whose
// one-sided stencil reaches five cells), RH x RW = 32 x 40 cells at SPC 2 and
// 48 x 56 at SPC 4, 0 outside the domain. The SPC steps of four stages then
// run in shared memory on regions that shrink by one cell a side a stage,
// except on a side at the domain's edge: after sub-step st the state is valid
// on the region less 4 (st + 1) cells a side, which still holds the tile
// after the last. The last stage of the last sub-step computes the tile
// alone and writes it; the last stage of an earlier one writes the new state
// over the stage's start state in shared memory (each cell by the thread that
// reads it there), where the next sub-step starts. The thread layout is the
// region's cells in order, cell l = tid + 256 a for slot a < SLOTS (5 at SPC
// 2, 11 at SPC 4), so a warp reads consecutive cells; each slot keeps its
// k1 + 2 k2 + 2 k3 in registers, since every cell of a sub-step's valid span
// needs the closed-form combine, not only the tile's. The stage buffers are
// the one-step kernel's: the state of the stack in work, the stage input,
// the second buffer of U, Vx and Vy, the source shape and the wavespeed at a
// sub-step's three stage times (recomputed each sub-step of stack 0 from the
// owner fields, or by the general rasterisation with the one-step kernel's
// per-block cull against the region's box), 19 planes of the region, plus
// stack 0's new U at the tile cells for each sub-step (for sc) and a block
// reduction's eight floats: 100,480 bytes at SPC 2 (two blocks an SM, so
// the registers are capped at 128) and 210,560 at SPC 4 (one block). The two
// stacks (tot with c^2, inc with c0^2) are independent, so each runs all SPC
// sub-steps in turn through the same buffers. A sub-step's energy partials
// are reduced at its end, stack 0's u_tot^2 and stack 1's u_inc^2 and sc^2,
// one row a block and sub-step in a fixed order.
//   What it costs: the band is recomputed. At SPC 2 an interior block's
// stages compute 30 x 38, 28 x 36, 26 x 34 and 24 x 32 cells (rows x
// columns) in the first sub-step and 22 x 30, 20 x 28, 18 x 26 and the
// 16 x 24 tile in the second, against the tile alone a stage
// (`band_work_share` in ops/fused_rk4.py counts it for a grid).
//
// Numerics: -fmad=false, each cell in the plain version's op order
// (`stack_rhs`, :315, and the closed-form combine, :371-374), the one-sided
// stencils at the domain's edges, and sub-step st at t + float32(st * dt)
// with its stage times float32(ts0 + dt / 2) and float32(ts0 + dt), as the
// JAX kernel forms them. So the state after a launch is bit for bit SPC
// launches of the one-step kernel at those times, and the plain version's
// SPC chained steps; the energy partials are summed in another order.

#include "fused_rk4_common.cuh"

namespace {

constexpr int NT = BX * BY;  // threads a block

// The region, thread slots and shared memory of `rk4_steps_tiled<.., SPC>`.
template <int SPC>
struct Band {
  static constexpr int H = HALO * SPC;   // the ghost band: cells SPC steps consume a side
  static constexpr int RH = TX + 2 * H;  // region rows
  static constexpr int RW = TY + 2 * H;  // region columns
  static constexpr int RC = RH * RW;     // region cells
  static constexpr int SLOTS = (RC + NT - 1) / NT;  // region cells a thread works
  static constexpr int TC = TX * TY;     // tile cells
  static constexpr int SMEM = (19 * RC + SPC * TC + 32) * (int)sizeof(float);
  static constexpr int MIN_BLOCKS = SPC == 2 ? 2 : 1;  // resident blocks an SM
};
static_assert(Band<2>::SMEM == 100480 && Band<4>::SMEM == 210560, "see the note at the top");
static_assert(Band<4>::SMEM <= 232448, "a block's shared memory fits Hopper's 227 KB");

// The general mode's wavespeed at a sub-step's three stage times (lerp
// weights lw) on this thread's region cells, into s_c (c0 outside the loaded
// rows and columns), in the plain version's op order (`rasterize`,
// pallas_fd.py:227), as the one-step kernel's `fill_general` does: a chunk of
// CYL_CHUNK cylinders lerped once, one a thread, into s_cyl ([px, py, r^2, c]
// a stage time) with a bit a stage time in s_hit where its box
// [p - |r|, p + |r|], widened by one spacing, meets the region's on both
// axes; then every thread tests its cells against the set bits alone, the
// same cylinders in order for the whole block. Every thread calls it.
template <int SPC>
__device__ __forceinline__ void fill_general_band(float* s_c, float* s_cyl, int* s_hit,
                                                  const float* __restrict__ cyl,
                                                  const StepParams& g, const float (&lw)[3],
                                                  int r0, int c0g, Span load_r, Span load_c) {
  using B = Band<SPC>;
  const float sp = g.spacing;
  const float bx0 = g.x_min + (float)r0 * sp, bx1 = g.x_min + (float)(r0 + B::RH - 1) * sp;
  const float by0 = g.x_min + (float)c0g * sp, by1 = g.x_min + (float)(c0g + B::RW - 1) * sp;
  const int tid = threadIdx.y * BX + threadIdx.x;
  float csum[B::SLOTS][3];
  int covered[B::SLOTS];  // bit m: a cylinder covers the slot's cell at stage time m
#pragma unroll
  for (int a = 0; a < B::SLOTS; ++a) {
    csum[a][0] = csum[a][1] = csum[a][2] = 0.0f;
    covered[a] = 0;
  }
  const int nc = g.n_cyl;
  for (int q0 = 0; q0 < nc; q0 += CYL_CHUNK) {
    const int cnt = min(CYL_CHUNK, nc - q0);
    __syncthreads();  // no thread still reads the previous chunk, or s_cyl's earlier use
    if (tid < cnt) {
      const float* cq = cyl + q0 + tid;  // rows [p1x, p1y, r1, c1, p2x, p2y, r2, c2]
      const float p1x = __ldg(cq), p1y = __ldg(cq + nc), r1 = __ldg(cq + 2 * nc),
                  c1 = __ldg(cq + 3 * nc), p2x = __ldg(cq + 4 * nc), p2y = __ldg(cq + 5 * nc),
                  r2 = __ldg(cq + 6 * nc), c2 = __ldg(cq + 7 * nc);
      int hit = 0;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float px = p1x + lw[m] * (p2x - p1x);
        const float py = p1y + lw[m] * (p2y - p1y);
        const float r = r1 + lw[m] * (r2 - r1);
        float* dst = s_cyl + 4 * m * CYL_CHUNK + tid;
        dst[0] = px;
        dst[CYL_CHUNK] = py;
        dst[2 * CYL_CHUNK] = r * r;
        dst[3 * CYL_CHUNK] = c1 + lw[m] * (c2 - c1);
        const float reach = fabsf(r) + sp;
        if (px - reach <= bx1 && px + reach >= bx0 && py - reach <= by1 && py + reach >= by0) {
          hit |= 1 << m;
        }
      }
      s_hit[tid] = hit;
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < cnt; ++q) {
      const int hit = s_hit[q];
      if (hit == 0) continue;  // culled at every stage time, for the whole block
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        if (((hit >> m) & 1) == 0) continue;
        const float* cq = s_cyl + 4 * m * CYL_CHUNK + q;
        const float px = cq[0], py = cq[CYL_CHUNK], rr = cq[2 * CYL_CHUNK],
                    c = cq[3 * CYL_CHUNK];
#pragma unroll
        for (int a = 0; a < B::SLOTS; ++a) {
          const int l = tid + NT * a;
          if (l >= B::RC) continue;
          const float ddx = g.x_min + (float)(r0 + l / B::RW) * sp - px;
          const float ddy = g.x_min + (float)(c0g + l % B::RW) * sp - py;
          if (ddx * ddx + ddy * ddy < rr) {
            csum[a][m] = csum[a][m] + c;
            covered[a] |= 1 << m;
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < B::SLOTS; ++a) {
    const int l = tid + NT * a;
    if (l >= B::RC) continue;
    const bool in = load_r.has(r0 + l / B::RW) && load_c.has(c0g + l % B::RW);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      s_c[m * B::RC + l] = (in && ((covered[a] >> m) & 1) != 0) ? csum[a][m] : g.c0;
    }
  }
}

// SPC whole RK4 steps from time t for `gridDim.z` candidates on the whole
// grid, or `gridDim.z` consecutive slabs if SLAB (see the note at the top):
// K5's split d/dx if XM, else the exact one; the general rasterisation of
// the (8, n_cyl) cylinders `g.cyl` if GENERAL, else the owner test on the
// (5, n, w) fields `owner`. Block (bx, by, z) owns the TX x TY tile of
// candidate or slab z from global row by TX and from global column bx TY
// past z's first owned column; its region, Band<SPC>::RH x RW cells from global (r0, c0g), lies in
// dynamic shared memory, Band<SPC>::SMEM bytes:
//   s_u  [6][RC]  the stack's state at the sub-step's start, 0 outside the domain
//   s_v  [6][RC]  the stage input u + a k of that stack
//   s_w  [3][RC]  the other buffer of the stage input's U, Vx and Vy
//   s_f  [RC]     the source shape
//   s_c  [3][RC]  the wavespeed at the sub-step's k1, k2/k3 and k4 times
//   s_ut [SPC][TC] stack 0's new U at the tile cells after each sub-step
//   s_red [32]    a block reduction's warp totals
// (the general mode stages its cylinders in s_v before each sub-step of
// stack 0). The stage buffers alternate as in the one-step kernel, so one
// barrier a stage parts its writes from the next stage's reads. partials is
// (SPC, gridDim.z, blocks, 3): sub-step st's row of block b of candidate z
// at (st, z, b).
template <bool XM, bool GENERAL, int SPC, bool SLAB>
__global__ void __launch_bounds__(NT, Band<SPC>::MIN_BLOCKS)
rk4_steps_tiled(const float* __restrict__ u, float* __restrict__ out,
                float* __restrict__ partials, const float* __restrict__ shape,
                const float* __restrict__ prof, const float* __restrict__ owner, StepParams g,
                float t) {
  using B = Band<SPC>;
  constexpr int RW = B::RW, RC = B::RC;
  extern __shared__ float smem[];
  float* s_u = smem;
  float* s_v = s_u + 6 * RC;
  float* s_w = s_v + 6 * RC;
  float* s_f = s_w + 3 * RC;
  float* s_c = s_f + RC;
  float* s_ut = s_c + 3 * RC;
  float* s_red = s_ut + SPC * B::TC;
  const int n = g.n;
  const int w = SLAB ? g.w : n;          // local columns
  const int ny = SLAB ? w - 2 * B::H : n;  // owned columns
  const size_t nn = (size_t)n * w;
  // z: the candidate on the whole grid (its own cylinders, the source shape
  // shared or its own), or the slab (its own columns and source shape, the
  // cylinders shared)
  const size_t cand = blockIdx.z;
  const int col0 = SLAB ? g.col0 + (int)cand * ny : 0;  // global column of local column 0
  u += cand * 12 * nn;
  out += cand * 12 * nn;
  shape += cand * (SLAB ? nn : (size_t)g.shape_stride);
  if constexpr (!GENERAL) owner += cand * 5 * nn;
  const int tid = threadIdx.y * BX + threadIdx.x;

  const int own0 = col0 + (SLAB ? B::H : 0);  // global column of the first owned column
  const int ti0 = blockIdx.y * TX, tj0 = own0 + blockIdx.x * TY;
  const Span tile_r{ti0, min(ti0 + TX, n) - 1};
  const Span tile_c{tj0, min(tj0 + TY, own0 + ny) - 1};
  const int r0 = ti0 - B::H - (ti0 == n - 1 ? 1 : 0);  // global row of region row 0
  const int c0g = tj0 - B::H - (tj0 == n - 1 ? 1 : 0);  // global column of region column 0
  const Span load_r{max(r0, 0), min(tile_r.hi + B::H, n - 1)};
  const Span load_c{max(c0g, 0), min(tile_c.hi + B::H, n - 1)};
  const float span = g.tf - g.ti;
  const float denom = span > 0.0f ? span : 1.0f;
  const size_t blocks = (size_t)gridDim.x * gridDim.y;
  const size_t row = cand * blocks + blockIdx.y * gridDim.x + blockIdx.x;

  // the source shape, once
#pragma unroll
  for (int a = 0; a < B::SLOTS; ++a) {
    const int l = tid + NT * a;
    if (l >= RC) continue;
    const int gi = r0 + l / RW, gj = c0g + l % RW;
    const bool in = load_r.has(gi) && load_c.has(gj);
    s_f[l] = in ? __ldg(shape + gi * w + gj - col0) : 0.0f;
  }

#pragma unroll 1
  for (int stack = 0; stack < 2; ++stack) {
    __syncthreads();  // the previous stack no longer reads s_u or s_v
#pragma unroll
    for (int a = 0; a < B::SLOTS; ++a) {
      const int l = tid + NT * a;
      if (l >= RC) continue;
      const int gi = r0 + l / RW, gj = c0g + l % RW;
      const bool in = load_r.has(gi) && load_c.has(gj);
      const float* src = u + (size_t)6 * stack * nn + (in ? gi * w + gj - col0 : 0);
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) s_u[ch * RC + l] = in ? __ldg(src + ch * nn) : 0.0f;
    }
    Span vr = load_r, vc = load_c;
#pragma unroll 1
    for (int st = 0; st < SPC; ++st) {
      // the sub-step's stage times (`stage_times` from t + float32(st dt)),
      // their lerp weights and source phases
      float sub = g.sub[0];
#pragma unroll
      for (int k = 1; k < SPC; ++k) {
        if (st == k) sub = g.sub[k];
      }
      const float t0 = t + sub;
      const float ts3[3] = {t0, t0 + g.half, t0 + g.full};
      float lw[3], sn[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        lw[m] = (fminf(fmaxf(ts3[m], g.ti), g.tf) - g.ti) / denom;
        sn[m] = sinf(TWO_PI * ts3[m] * g.freq);
      }
      if (stack == 0) {  // stack 1 takes c0 everywhere
        if constexpr (GENERAL) {
          // the cylinders' chunk in s_v, free until the sub-step's first stage
          fill_general_band<SPC>(s_c, s_v, reinterpret_cast<int*>(s_v + 12 * CYL_CHUNK),
                                 g.cyl + (SLAB ? 0 : cand * 8 * (size_t)g.n_cyl), g, lw, r0,
                                 c0g, load_r, load_c);
        } else {
#pragma unroll
          for (int a = 0; a < B::SLOTS; ++a) {
            const int l = tid + NT * a;
            if (l >= RC) continue;
            const int gi = r0 + l / RW, gj = c0g + l % RW;
            const bool in = load_r.has(gi) && load_c.has(gj);
            const int q = in ? gi * w + gj - col0 : 0;
            const float d2 = in ? __ldg(owner + q) : 0.0f;
            const float r1 = in ? __ldg(owner + nn + q) : 0.0f;
            const float dr = in ? __ldg(owner + 2 * nn + q) : 0.0f;
            const float c1 = in ? __ldg(owner + 3 * nn + q) : 0.0f;
            const float dc = in ? __ldg(owner + 4 * nn + q) : 0.0f;
#pragma unroll
            for (int m = 0; m < 3; ++m) {
              const float r = r1 + lw[m] * dr;
              s_c[m * RC + l] = (in && d2 < r * r) ? c1 + lw[m] * dc : g.c0;
            }
          }
        }
      }
      __syncthreads();  // s_u, s_f and s_c are in place

      float acc[B::SLOTS][6];
      float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;  // this thread's u_tot^2, or u_inc^2 and sc^2
      // the stages stay rolled: unrolled, with the slots, they took nvcc over
      // two minutes for the eight instances
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {
        vr = shrink(vr, n);
        vc = shrink(vc, n);
        const float* nb = s == 0 ? s_u : (s == 2 ? s_w : s_v);  // this stage's U, Vx, Vy
        const float* pw = s == 0 ? s_u + 3 * RC : s_v + 3 * RC;
        float* next = s == 1 ? s_w : s_v;  // the next stage's U, Vx, Vy
        const int m = s == 0 ? 0 : (s == 3 ? 2 : 1);  // which stage time
        const float snm = s == 0 ? sn[0] : (s == 3 ? sn[2] : sn[1]);  // its source phase
        const bool final_stage = s == 3 && st == SPC - 1;
#pragma unroll
        for (int a = 0; a < B::SLOTS; ++a) {
          const int l = tid + NT * a;
          if (l >= RC) continue;
          const int gi = r0 + l / RW, gj = c0g + l % RW;
          const bool tile = tile_r.has(gi) && tile_c.has(gj);
          // the last stage of the last sub-step computes the tile alone
          if (final_stage ? !tile : !(vr.has(gi) && vc.has(gj))) continue;
          const float c = s_c[m * RC + l];
          const float b = stack == 0 ? c * c : g.c0 * g.c0;
          const float bc = (gi > 0 && gi < n - 1 && gj > 0 && gj < n - 1) ? 1.0f : 0.0f;
          float k[6];
          stack_rhs_tiled<XM, RW, RC>(nb, pw, s_f, snm, b, l, gi == 0, gi == n - 1, gj == 0,
                                      gj == n - 1, __ldg(prof + gi), __ldg(prof + gj), bc,
                                      g.inv2d, k);
          if (s < 3) {
            const float coef = s == 2 ? g.full : g.half;
#pragma unroll
            for (int ch = 0; ch < 6; ++ch) {
              acc[a][ch] = s == 0 ? k[ch] : acc[a][ch] + 2.0f * k[ch];
              const float v = s_u[ch * RC + l] + coef * k[ch];
              if (ch < 3) {
                next[ch * RC + l] = v;
              } else {
                s_v[ch * RC + l] = v;  // read at this cell alone, by this thread
              }
            }
          } else {
            // u + dt/6 (k1 + 2 k2 + 2 k3 + k4), left to right as the closed form
            float un = 0.0f;
#pragma unroll
            for (int ch = 0; ch < 6; ++ch) {
              const float v = s_u[ch * RC + l] + g.sixth * (acc[a][ch] + k[ch]);
              if (final_stage) {
                out[(size_t)(6 * stack + ch) * nn + gi * w + gj - col0] = v;
              } else {
                s_u[ch * RC + l] = v;  // the next sub-step's start, read here by this thread alone
              }
              if (ch == 0) un = v;
            }
            if (tile) {
              float* ut = s_ut + st * B::TC + (gi - ti0) * TY + (gj - tj0);
              if (stack == 0) {
                *ut = un;
                e0 += un * un;
              } else {
                const float sc = *ut - un;  // written by this thread in stack 0
                e1 += un * un;
                e2 += sc * sc;
              }
            }
          }
        }
        __syncthreads();  // the next stage (or sub-step) reads what this one wrote
      }
      // this sub-step's energy partials, one row a block
      float* dst = partials + 3 * ((size_t)st * gridDim.z * blocks + row);
      if (stack == 0) {
        const float s_tot = block_sum(e0, s_red);
        if (tid == 0) dst[0] = s_tot;
      } else {
        const float s_inc = block_sum(e1, s_red);
        const float s_sc = block_sum(e2, s_red);
        if (tid == 0) {
          dst[1] = s_inc;
          dst[2] = s_sc;
        }
      }
    }
  }

  // a slab's halo columns are written 0: the left ones by the first tile
  // column's blocks, the right ones by the last's
  if constexpr (SLAB) {
    constexpr int HC = TX * B::H;  // a side's halo cells of a tile row band
#pragma unroll 1
    for (int c = tid; c < 2 * HC; c += NT) {
      const bool right = c >= HC;
      const int gi = ti0 + (c % HC) / B::H;
      const int lj = (right ? B::H + ny : 0) + c % B::H;
      if ((right ? blockIdx.x != gridDim.x - 1 : blockIdx.x != 0) || !tile_r.has(gi)) continue;
#pragma unroll
      for (int ch = 0; ch < 12; ++ch) out[ch * nn + (size_t)gi * w + lj] = 0.0f;
    }
  }
}

// The grid of n rows and ny owned columns (n on the whole grid) a candidate
// or slab.
dim3 steps_grid(int n, int ny, int batch) {
  return dim3((ny + TY - 1) / TY, (n + TX - 1) / TX, batch);
}

// Lets `rk4_steps_tiled<XM, GENERAL, SPC, SLAB>` take Band<SPC>::SMEM bytes
// of dynamic shared memory on the current device, once a device.
template <bool XM, bool GENERAL, int SPC, bool SLAB>
cudaError_t configure_steps() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(rk4_steps_tiled<XM, GENERAL, SPC, SLAB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Band<SPC>::SMEM);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <bool XM, bool GENERAL, int SPC, bool SLAB>
int steps_occupancy() {
  int blocks = 0;
  cudaError_t e = configure_steps<XM, GENERAL, SPC, SLAB>();
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, rk4_steps_tiled<XM, GENERAL, SPC, SLAB>, NT, Band<SPC>::SMEM);
  }
  return e == cudaSuccess ? blocks : -(int)e;
}

template <bool XM, bool GENERAL, int SPC, bool SLAB>
int steps_tiled(const TiledWindow* w, const float* u, float* out, float* partials, float t) {
  const cudaError_t e = configure_steps<XM, GENERAL, SPC, SLAB>();
  if (e != cudaSuccess) return (int)e;
  StepParams p{w->n,   w->w,     w->col0,  w->inv2d, w->c0,    w->freq,    w->half,
               w->full, w->sixth, w->ti,    w->tf,    w->cyl,   w->n_cyl,   w->x_min,
               w->spacing, w->shape_stride};
  for (int k = 0; k < 4; ++k) p.sub[k] = w->sub[k];
  const int ny = SLAB ? w->w - 2 * Band<SPC>::H : w->n;
  rk4_steps_tiled<XM, GENERAL, SPC, SLAB>
      <<<steps_grid(w->n, ny, w->batch), dim3(BX, BY), Band<SPC>::SMEM,
         (cudaStream_t)w->stream>>>(u, out, partials, w->shape, w->prof, w->owner, p, t);
  return (int)cudaGetLastError();
}

template <int SPC, bool SLAB>
int steps_instance(const TiledWindow* w, const float* u, float* out, float* partials, float t) {
  if (w->owner == nullptr) {
    return w->xm ? steps_tiled<true, true, SPC, SLAB>(w, u, out, partials, t)
                 : steps_tiled<false, true, SPC, SLAB>(w, u, out, partials, t);
  }
  return w->xm ? steps_tiled<true, false, SPC, SLAB>(w, u, out, partials, t)
               : steps_tiled<false, false, SPC, SLAB>(w, u, out, partials, t);
}

template <int SPC, bool SLAB>
int steps_occupancy_instance(int xm, int general) {
  if (general) {
    return xm ? steps_occupancy<true, true, SPC, SLAB>()
              : steps_occupancy<false, true, SPC, SLAB>();
  }
  return xm ? steps_occupancy<true, false, SPC, SLAB>()
            : steps_occupancy<false, false, SPC, SLAB>();
}

template <int SPC>
int steps_launch(const TiledWindow* w, const float* u, float* out, float* partials, float t) {
  return w->w == w->n && w->col0 == 0 ? steps_instance<SPC, false>(w, u, out, partials, t)
                                      : steps_instance<SPC, true>(w, u, out, partials, t);
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block of the SPC-step kernel, in bytes; 0 for
// an SPC it does not take.
int fused_rk4_steps_smem(int spc) {
  return spc == 2 ? Band<2>::SMEM : (spc == 4 ? Band<4>::SMEM : 0);
}

// Blocks of the SPC-step instance (xm 1: split d/dx, 0: exact; general 1:
// the general rasterisation, 0: the owner test; slab 1: on slabs, 0: on the
// whole grid) resident on one SM of the current device, as the occupancy
// calculator gives it for the instance's registers and shared memory;
// negative on an error.
int fused_rk4_steps_occupancy(int xm, int general, int spc, int slab) {
  if (spc == 2) {
    return slab ? steps_occupancy_instance<2, true>(xm, general)
                : steps_occupancy_instance<2, false>(xm, general);
  }
  if (spc == 4) {
    return slab ? steps_occupancy_instance<4, true>(xm, general)
                : steps_occupancy_instance<4, false>(xm, general);
  }
  return -(int)cudaErrorInvalidValue;
}

// w->spc (2 or 4) whole RK4 steps in one launch from start time t, sub-step
// st from t + w->sub[st]: the exact d/dx for w->xm 0 (K1-K4) or the split
// one for w->xm 1 (K5, batched K5, K4-XM); radii-only on w->owner's fields,
// or general on w->cyl's n_cyl cylinders where w->owner is null. On the
// whole grid (w->w == n, w->col0 == 0) of w->batch candidates: u and out
// (batch, 12, n, n), partials (spc, batch, blocks, 3) with blocks
// `fused_rk4_step_blocks(n, n)` of fused_rk4.cu (the same tiles), the
// source shape (n, n) shared (w->shape_stride 0) or (batch, n, n) (n * n).
// On w->batch consecutive slabs of w->w local columns from w->col0 with
// 4 spc halo columns a side: u and out (batch, 12, n, w), their halo
// columns written 0, the source shape (batch, n, w), partials (spc, batch,
// fused_rk4_step_blocks(n, w - 8 spc), 3). Returns the cudaError_t of the
// launch.
int fused_rk4_steps_tiled(const TiledWindow* w, const float* u, float* out, float* partials,
                          float t) {
  if (w == nullptr || (w->spc != 2 && w->spc != 4) || w->batch < 1 || w->batch > 65535 ||
      !valid_extent(w->n, w->w, w->col0, w->batch, HALO * w->spc) || w->xm < 0 || w->xm > 1 ||
      w->n_cyl < 0 ||
      (w->shape_stride != 0 && !(w->shape_stride == w->n * w->n && w->w == w->n &&
                                 w->col0 == 0)) ||
      (w->owner == nullptr && w->n_cyl > 0 && w->cyl == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return w->spc == 2 ? steps_launch<2>(w, u, out, partials, t)
                     : steps_launch<4>(w, u, out, partials, t);
}

}  // extern "C"
