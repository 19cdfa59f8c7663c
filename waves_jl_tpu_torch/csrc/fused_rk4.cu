// Fused RK4 step of the 12-channel split-field PML acoustic system, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel built by `make_fused_acoustic_step`
// (waves_jl_tpu/ops/pallas_fd.py:88, `pl.pallas_call` at :432) in every
// mode, each in one launch a RK4 step (`rk4_step_tiled<XM, GENERAL,
// SLAB>`, below):
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
// K3, candidate-batched (`batch=K`, :121-127, :162-170, :403-406, :431,
// :450-456), in both rasterisation modes: K independent states advance
// through the same time step in one launch. blockIdx.z is the candidate;
// it offsets the state, out, cylinder, owner and energy-partial pointers,
// and the source shape's where each candidate has its own (`shape_stride`:
// the batched episodes of datagen; the re-rank's candidates share one),
// while the PML profile is shared. A launch with one
// candidate is K1 or K2, so each candidate's state is bit for bit what K1
// or K2 computes for it alone. The TPU kernel's padded layout and DMA
// semaphores have no counterpart here: a 350^2 grid is only 15 x 22 = 330
// blocks against 132 SMs, and 16 candidates make 5,280. Its bound is K
// times a step's: at 350^2 and K = 16 the states in and out are
// 16 x 2 x 5.88 MB = 188.2 MB, 56.2 us at 3.35 TB/s.
//
// K4, y-sharded (`ny_local`, `y_ghost`, :129-133, :152, :195-204, :351,
// :391), driven by `waves_jl_tpu/parallel/fused_domain.py`: the same step
// on column slabs (12, n, w) of the global n x n grid, w = ny + 2 HALO for
// ny owned columns, all of a card's slabs in one launch. blockIdx.z is the
// slab: slab z's local column j is global column col0 + z ny + j, and it
// has its own state, source shape (n, w) and owner fields (5, n, w), where
// the cylinders and the (n) profile are shared. It is the SLAB template
// flag of `rk4_step_tiled`: the whole-grid instances keep the registers
// and spills they had without it (the geometry as runtime values cost the
// exact radii-only instance 4 more bytes of spill, 8 to 12, in ptxas), and
// SLAB false folds the slab's arithmetic away. The tiles cover each
// slab's owned columns, local [HALO, HALO + ny), ceil(ny / TY) tile
// columns a slab, and a tile never crosses a slab's owned range. A tile's
// region (the tile and HALO cells a side) lies inside its slab: its
// columns are the tile's +-HALO, and the fifth column before a one-cell
// tile on the domain's last column lies inside too, since that tile is
// never a slab's first when ny >= 2 HALO. The one-sided y stencils, the
// Dirichlet mask, the y coordinate, the PML profile, the stage regions'
// shrinking and the general mode's cull are taken at global columns, as
// on the whole grid, so an owned cell of a slab is bit for bit the whole
// grid's. The kernel writes the slab's halo columns 0 (the blocks of the
// first and last tile column): the exchange refreshes the interior halos
// before the next step, and the halos outside the domain stay 0. The
// energy partials cover the owned cells. Its bound is
// the slabs' bytes: at 700^2 and 4 slabs the states in and out are
// 4 x 2 x 12 x 700 x 183 x 4 B = 49.2 MB, 14.7 us at 3.35 TB/s.
//
// K5, `x_matmul` (:278-310), the JAX package's default on every fused path
// but the sharded one (physics/fused.py:79, :154, :225): d/dx as the
// banded (rows, rows) stencil matrix D times the tile on the MXU, in two
// bf16 passes with float32 sums, (D bf16(v) + D bf16(v - bf16(v))) / (2 dx).
// It is the XM template flag, in both rasterisations, on the whole grid,
// batched or on slabs (K4-XM). Each tap of Vx and of U + f is formed in
// float32 as before and split into hi = bf16(v) and lo = bf16(v - hi),
// both rounded to nearest even; the stencil of `d_edge` runs on the hi
// values and on the lo values in the same tap order, and the two sums are
// added and scaled. D's entries are small integers and hi and lo are bf16,
// so every product of the TPU's dot is exact and adding D's zeros is
// exact: a central row rounds once, as the tap difference does. The
// one-sided rows 0 and n-1 sum three taps in d_edge's order, which may
// differ from the dot's by an ulp, as on the MXU (:281-283). d/dy stays
// exact, as in JAX (:325-329). A slab cuts columns, not rows, so a slab
// cell's x-taps are the whole-grid cell's, and an owned cell of K4-XM is
// bit for bit K5's (waves_jl_tpu/parallel/fused_domain.py:37 with
// `x_matmul=True`). What bounds it is what bounds K1-K4, bytes: the split
// adds 4 conversions and a subtract a tap, about 1e8 operations a step at
// 700^2, under 2 us at 67 TFLOP/s. The TPU put the product on the MXU
// because its vector unit set the pace there; a row of D has two nonzeros,
// so a tensor-core product would do 8x the multiply-adds for no byte
// saved, and this form needs no shared-memory reshuffle.
//
// One launch per RK4 step (`rk4_step_tiled<XM, GENERAL, SLAB>`): the exact
// d/dx (XM false) or the split one (XM true), the owner test (GENERAL
// false: K2, K3, K5, batched K5, and the slabs' radii-only mode) or the
// general rasterisation (GENERAL true: K1, K3 general, K5 general, batched
// K5 general, and the slabs' general mode), on the whole grid (SLAB false)
// or on slabs (SLAB true), in the form the Pallas kernel
// has: all four stages of a step on a tile held in fast memory with HALO
// ghost cells (:343-377). K5 and batched K5 are the main paths' modes:
// every env window, datagen episode and controller's window (K5 at 700^2)
// and the hybrid's re-rank (batched K5 at 16 x 350^2). K2 and K3 are the
// accuracy mode, `x_matmul=False`: the exact simulator window and the
// exact re-rank. The general instances serve every design space where the
// owner test is not exact: moving cylinders, the free field, radii whose
// circles overlap.
//   What bounds it: bytes. A step must read the state (and the owner
// fields) and write the state: at 700^2, 23.5 (+ 9.8) + 23.5 MB, 14 (17)
// us at 3.35 TB/s; at 16 x 350^2, 94 + 39 + 94 MB, 68 us. A launch a stage
// with k1..k3 kept in device memory moves about 14 state-sized arrays a
// step, 10-12x the bound, and at 16 x 350^2 the 94 MB states overflow the
// 50 MB L2, so that traffic goes to HBM.
//   What the design does about it. Block (bx, by, z) owns a TX x TY =
// 16 x 24 tile of candidate or slab z and loads once, into shared memory,
// its region: the tile with HALO = 4 cells on each side (24 x 32, one warp
// wide), 0 outside the domain. The four stages then run inside the block
// on regions that shrink by one cell a side a stage (k1 on the tile + 3,
// k2 + 2, k3 + 1, k4 on the tile), except on a side at the domain's edge,
// whose one-sided stencil reads inward only; a one-cell tile on the last
// row or column takes one more cell of halo, as its stencil reaches five
// cells inward. Each thread works one column and three rows of the region,
// two of them the tile's. It computes a cell's k and at once writes the
// next stage's input u + a k: U, Vx and Vy, which the stencils read at the
// neighbours, into the other of two buffers, and Psix, Psiy and Omega,
// read at the cell alone, in place; so one barrier a stage suffices and
// no k outlives its cell. The tile cells' k1 + 2 k2 + 2 k3 + k4
// accumulates in registers, left to right as the closed form rounds it.
// The two stacks (tot with c^2, inc with c0^2) run one after the other
// through the same buffers, stack 0's new U kept in registers for sc.
// Shared memory: the stack's state and stage input, the second buffer of
// U, Vx and Vy, the source shape and the wavespeed at the three stage
// times, 19 x 768 floats = 58,368 bytes a block of 256 threads, above the
// 48 KB a kernel gets unasked (`configure_tiled`, an attribute each
// instance sets for itself, once a device). ptxas (-v, sm_90a), on the
// whole grid, radii-only: both instances at 80 registers, the cap for three blocks an SM
// (`TILED_MIN_BLOCKS`), the split one with 12 bytes spilled, the exact one
// with 8 (it drops the split's conversions, not enough to fit unspilled);
// the general ones at 80 with 12 bytes spilled each (the cylinder loop
// kept rolled; filling the three stage times in turn spills 8 and 16
// instead). Three blocks fit the shared memory too (3 x (58,368 + 1,024 reserved)
// bytes of 228 KB), 24 warps an SM, so `TILED_MIN_BLOCKS` stays 3 for
// all. A cap for four blocks (64 registers) spills more, and both stacks
// at once (104 KB, two blocks an SM, half the barriers) or k held in
// registers across a second barrier a stage measured slower on the card:
// the kernel is bound by the latency of its shared-memory reads and
// barriers more than by bytes, so resident warps count most. HBM sees the
// state and owner fields once (halo re-reads hit L2) and the state
// written once; the stages redo 1.35x the tile's cells. Each cell runs the
// plain version's op order, so the state is bit for bit the plain
// version's; the energy partials, one row a block, are summed in another
// order.
//   The general rasterisation (`rasterize`, :227) fills the wavespeed at
// the three stage times before the stacks, where the radii-only one reads
// the owner fields: each cylinder lerped to the time's weight, summed in
// order where it covers a cell, c0 where none does. Most tiles meet no
// cylinder (the triple ring's 18 lie in 13 x 13 of the 30 x 30 domain), so
// the block culls, as the Pallas kernel does per row block (:218-225) but
// on both axes: the first threads of the block lerp a chunk of cylinders
// once, one cylinder each, into shared memory, with a bit for each stage
// time whose box [p - |r|, p + |r|], widened by one spacing on both axes,
// meets the region's; every thread then tests its cells against the
// cylinders whose bit is set, the same for the whole block. A cylinder
// that covers a cell has |x - px| < |r| and |y - py| < |r| up to a
// rounding far below a spacing, so no covering cylinder is skipped, and a
// skipped one adds 0 to the plain version's sum: the cull keeps the state
// bit for bit. A block that meets no box fills c0 alone.
//
// Cylinders: the general mode and the owner pass stream the (8, n_cyl)
// table through shared memory in chunks of CYL_CHUNK, in order, so sums
// and ties do not depend on the chunking and there is no cap on n_cyl
// (the step stages each chunk in its stage-input buffer, free until the
// first stage). Every thread of a block reaches each chunk's barriers;
// threads outside the grid skip only the arithmetic.
//
// Two or four steps a launch, the Pallas kernel's `steps_per_call` (:98,
// :359-386), are `rk4_steps_tiled` in fused_rk4_multi.cu, on the whole grid
// and on slabs with a 4 SPC-column halo (`y_ghost >= HALO * steps_per_call`,
// :156-157). What the two share is in fused_rk4_common.cuh.
//
// Numerics: the library is compiled with -fmad=false, so every a*b+c
// rounds twice, as in the plain PyTorch version and the JAX kernel. The op
// order follows `stack_rhs` (:315) and the closed-form combine (:371-374).
// Energy partials are reduced in a fixed order, so runs are deterministic.

#include "fused_rk4_common.cuh"

namespace {

// `rk4_step_tiled`: a block's tile, its region (the tile and HALO cells
// on each side) and the region's shared-memory footprint.
constexpr int SH = TX + 2 * HALO;  // region rows, 24
constexpr int SW = TY + 2 * HALO;  // region columns, 32
constexpr int SC = SH * SW;        // region cells, 768
constexpr int TILED_SMEM = 19 * SC * (int)sizeof(float);  // 58,368 bytes; see the kernel
constexpr int TILED_MIN_BLOCKS = 3;  // resident blocks an SM the registers must allow
static_assert(SH == 3 * BY, "a thread works three region rows");
static_assert(SW == BX, "a warp spans the region's columns");

// `select_owner_kernel`: a block of OWN_BX x OWN_BY threads owns a tile of
// OWN_TR rows and OWN_TC columns, a thread OWN_CELLS columns of one row,
// OWN_BX apart.
constexpr int OWN_CELLS = 4;
constexpr int OWN_BX = 16;    // threads along y, the contiguous axis
constexpr int OWN_BY = 16;    // threads along x
constexpr int OWN_TR = OWN_BY;              // tile rows, 16
constexpr int OWN_TC = OWN_BX * OWN_CELLS;  // tile columns, 64
static_assert(CYL_CHUNK == 64 && OWN_BX * OWN_BY >= CYL_CHUNK,
              "two whole warps stage a chunk and ballot its cull bits");

// The owner pass's grid: n rows of w local columns, coordinates
// x_min + index * spacing at the global index. On the whole grid (slabs
// false) blockIdx.z is the candidate, with its own (8, n_cyl) cylinders,
// and local column j is global column col0 + j (col0 0); on slabs,
// blockIdx.z is slab z, whose local column j is global column
// col0 + z (w - 2 halo) + j, and the cylinders are shared. `halo` is the
// slabs' halo columns a side: HALO for the one-step kernel's slabs, 4 SPC
// for those `rk4_steps_tiled` takes SPC steps a launch.
struct Geometry {
  int n;
  int w;
  int col0;
  int halo;
  float spacing;
  float x_min;
  bool slabs;
};

// Owner fields of the radii-only mode, once per window (`select_owner`,
// pallas_fd.py:247): owner[0..4] = [d2, r1, r2 - r1, c1, c2 - c1] of each
// cell's owner, from global coordinates. A cell's candidates are the
// cylinders whose box [p - rmax, p + rmax], widened by one spacing on both
// axes, holds it; its owner is the one with the smallest gap d2 - rmax^2
// (first in order on ties), and a cell that no box holds gets the sentinel
// [1e30, 0, 0, 0, 0], which no stage's test d2 < r^2 passes. Exact when
// the circles at their largest radii are disjoint and positions and speeds
// are fixed: a cylinder covers a cell at some weight only if its gap there
// is negative, so inside its box, where it is the unique owner.
//   What bounds it: bytes. It writes five float planes, 5 x 4 n w bytes a
// candidate or slab (9.8 MB at 700^2, 2.9 us at 3.35 TB/s), and reads the
// cylinder table alone.
//   What the design does about it. Block (bx, by, z) owns the OWN_TR x
// OWN_TC = 16 x 64 tile of candidate or slab z from row by OWN_TR and local
// column bx OWN_TC; its thread (tx, ty) works row ty and columns tx,
// tx + 16, tx + 32 and tx + 48 of the tile, so each store of a half-warp
// writes 16 consecutive floats of a row, whatever the row's alignment. (A
// float4 of four consecutive columns a thread measured 3-5% faster on an
// H100 at 700^2, whose rows are 16-byte aligned, and 25-29% slower on the
// 183-column slabs, where three rows in four are not.) Cull per tile, as
// the Pallas kernel culls per row block (`intersects`, :217-225): the first
// two warps read a chunk of CYL_CHUNK cylinders once, one cylinder a
// thread, into shared memory, with its box, and ballot a bit for each
// cylinder whose box meets the tile's; every thread then visits the set
// bits in order and, for each, tests its row and columns against the box,
// so a cell's candidates do not depend on how the grid is cut into tiles.
// At 700^2, 405 of the 484 tiles meet no box of the triple ring's
// cylinders at their largest radii and only store the sentinel. The chunks
// stream in order, so ties and n_cyl > 64 behave as with one table; every
// thread reaches each chunk's barriers.
__global__ void __launch_bounds__(OWN_BX * OWN_BY)
select_owner_kernel(const float* __restrict__ cyl, int n_cyl, float* __restrict__ owner,
                    Geometry g) {
  // a chunk's cylinders: [px, py, rmax^2, x_lo, x_hi, y_lo, y_hi, r1, r2 - r1, c1, c2 - c1]
  __shared__ float s_cyl[11][CYL_CHUNK];
  __shared__ unsigned s_hit[CYL_CHUNK / 32];
  const int n = g.n;
  const int w = g.w;
  const size_t z = blockIdx.z;
  const int col0 = g.slabs ? g.col0 + (int)z * (w - 2 * g.halo) : g.col0;
  if (!g.slabs) cyl += z * 8 * (size_t)n_cyl;
  owner += z * 5 * (size_t)n * w;
  const float sp = g.spacing;
  const int i0 = blockIdx.y * OWN_TR, j0 = blockIdx.x * OWN_TC;
  // the tile's box: its first and last row's x, first and last column's y
  const float tx0 = g.x_min + (float)i0 * sp;
  const float tx1 = g.x_min + (float)(min(i0 + OWN_TR, n) - 1) * sp;
  const float ty0 = g.x_min + (float)(col0 + j0) * sp;
  const float ty1 = g.x_min + (float)(col0 + min(j0 + OWN_TC, w) - 1) * sp;
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  const float x = g.x_min + (float)i * sp;
  float y[OWN_CELLS];
#pragma unroll
  for (int c = 0; c < OWN_CELLS; ++c) y[c] = g.x_min + (float)(col0 + j + OWN_BX * c) * sp;
  float best[OWN_CELLS], f[5][OWN_CELLS];  // f: [d2, r1, dr, c1, dc] of the owner so far
#pragma unroll
  for (int c = 0; c < OWN_CELLS; ++c) {
    best[c] = 1e30f;
    f[0][c] = 1e30f;
    f[1][c] = f[2][c] = f[3][c] = f[4][c] = 0.0f;
  }
  const int tid = threadIdx.y * OWN_BX + threadIdx.x;
  for (int q0 = 0; q0 < n_cyl; q0 += CYL_CHUNK) {
    const int cnt = min(CYL_CHUNK, n_cyl - q0);
    __syncthreads();  // no thread still reads the previous chunk
    if (tid < CYL_CHUNK) {
      bool hit = false;
      if (tid < cnt) {
        const float* cq = cyl + q0 + tid;  // rows [p1x, p1y, r1, c1, p2x, p2y, r2, c2]
        const float px = __ldg(cq), py = __ldg(cq + n_cyl), r1 = __ldg(cq + 2 * n_cyl),
                    c1 = __ldg(cq + 3 * n_cyl), r2 = __ldg(cq + 6 * n_cyl),
                    c2 = __ldg(cq + 7 * n_cyl);
        const float rmax = fmaxf(r1, r2);
        const float reach = rmax + sp;
        const float box[4] = {px - reach, px + reach, py - reach, py + reach};
        hit = box[0] <= tx1 && box[1] >= tx0 && box[2] <= ty1 && box[3] >= ty0;
        const float v[11] = {px, py, rmax * rmax, box[0], box[1], box[2], box[3],
                             r1, r2 - r1, c1, c2 - c1};
#pragma unroll
        for (int k = 0; k < 11; ++k) s_cyl[k][tid] = v[k];
      }
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      if ((tid & 31) == 0) s_hit[tid >> 5] = bits;
    }
    __syncthreads();
    unsigned long long hits = ((unsigned long long)s_hit[1] << 32) | s_hit[0];
    while (hits != 0) {  // the same cylinders, in order, for the whole block
      const int q = __ffsll((long long)hits) - 1;
      hits &= hits - 1;
      if (!(s_cyl[3][q] <= x && x <= s_cyl[4][q])) continue;  // the row is outside its box
      const float ddx = x - s_cyl[0][q];
      const float ddx2 = ddx * ddx;
#pragma unroll
      for (int c = 0; c < OWN_CELLS; ++c) {
        if (!(s_cyl[5][q] <= y[c] && y[c] <= s_cyl[6][q])) continue;
        const float ddy = y[c] - s_cyl[1][q];
        const float d2 = ddx2 + ddy * ddy;
        const float gap = d2 - s_cyl[2][q];
        if (gap < best[c]) {
          best[c] = gap;
          f[0][c] = d2;
          f[1][c] = s_cyl[7][q];
          f[2][c] = s_cyl[8][q];
          f[3][c] = s_cyl[9][q];
          f[4][c] = s_cyl[10][q];
        }
      }
    }
  }
  if (i >= n) return;
  const size_t nn = (size_t)n * w;
  float* dst = owner + (size_t)i * w + j;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
#pragma unroll
    for (int c = 0; c < OWN_CELLS; ++c) {
      if (j + OWN_BX * c < w) dst[p * nn + OWN_BX * c] = f[p][c];
    }
  }
}

// ---------------------------------------------------------------------------
// One launch per RK4 step (`rk4_step_tiled`)
// ---------------------------------------------------------------------------

// The general mode's wavespeed at the three stage times (lerp weights lw)
// on this thread's region cells, rows r0 + rows[a] of column gj, into
// s_c (c0 outside the loaded rows load_r and columns), in the plain
// version's op order (`rasterize`,
// pallas_fd.py:227): each cylinder lerped to the weight, its speed summed
// in order where d2 < r^2, c0 where no cylinder covers the cell. A chunk
// of CYL_CHUNK cylinders is lerped once, one cylinder a thread, into s_cyl
// ([px, py, r^2, c] a stage time), with a bit a stage time in s_hit: its
// box [p - |r|, p + |r|], widened by one spacing, meets the region's on
// both axes (the cull, see the note at the top). The block then tests
// only those, each thread the same ones. Every thread calls it. Inlined:
// as a call (`__noinline__`) the general instances spill nothing but take
// a 120-byte stack frame, and measured about 7% slower on the card.
__device__ __forceinline__ void fill_general(float* s_c, float* s_cyl, int* s_hit,
                                             const float* __restrict__ cyl, const StepParams& g,
                                             const float (&lw)[3], int r0, int c0g,
                                             const int (&rows)[3], bool col_in, Span load_r,
                                             int gj) {
  const float sp = g.spacing;
  const float bx0 = g.x_min + (float)r0 * sp, bx1 = g.x_min + (float)(r0 + SH - 1) * sp;
  const float by0 = g.x_min + (float)c0g * sp, by1 = g.x_min + (float)(c0g + SW - 1) * sp;
  const float y = g.x_min + (float)gj * sp;
  float x[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) x[a] = g.x_min + (float)(r0 + rows[a]) * sp;
  float csum[3][3] = {};  // [row slot][stage time]
  int covered = 0;        // bit 3 a + m: a cylinder covers row slot a at time m
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int nc = g.n_cyl;
  for (int q0 = 0; q0 < nc; q0 += CYL_CHUNK) {
    const int cnt = min(CYL_CHUNK, nc - q0);
    __syncthreads();  // no thread still reads the previous chunk
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
        const float ddy = y - cq[CYL_CHUNK];
        const float ddy2 = ddy * ddy;
        const float rr = cq[2 * CYL_CHUNK];
        const float c = cq[3 * CYL_CHUNK];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float ddx = x[a] - cq[0];
          if (ddx * ddx + ddy2 < rr) {
            csum[a][m] = csum[a][m] + c;
            covered |= 1 << (3 * a + m);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const bool cov = col_in && load_r.has(r0 + rows[a]) && ((covered >> (3 * a + m)) & 1) != 0;
      s_c[m * SC + rows[a] * SW + threadIdx.x] = cov ? csum[a][m] : g.c0;
    }
  }
}

// One whole RK4 step for `gridDim.z` candidates on the whole grid, or
// `gridDim.z` consecutive slabs if SLAB (see the note at the top): K5's split d/dx
// if XM, else the exact one; the general rasterisation of the (8, n_cyl)
// cylinders `g.cyl` if GENERAL, else the owner test on the (5, n, w)
// fields `owner`.
// Block (bx, by, z) owns the TX x TY tile of candidate or slab z from
// global row by * TX and from global column bx * TY past z's first owned
// column. Its region, the tile with HALO cells on every side (one more row
// or column above or left of a one-cell tile on the domain's last row or
// column, whose one-sided stencil reaches five cells), lies in shared
// memory as SH x SW cells from global (r0, c0g); thread (tx, ty) works
// region column tx and rows HALO + ty, HALO + BY + ty (the tile's rows,
// slots 0 and 1) and ty or 2 BY + ty (the halo rows, slot 2). Dynamic
// shared memory, TILED_SMEM bytes:
//   s_u [6][SC]  the state of the stack in work, 0 outside the region
//   s_v [6][SC]  the stage input u + a k of that stack
//   s_w [3][SC]  the other buffer of the stage input's U, Vx and Vy
//   s_f [SC]     the source shape
//   s_c [3][SC]  the wavespeed at the k1, k2/k3 and k4 times
// (the general mode stages its cylinders in s_v before the first stage).
// A stage reads U, Vx and Vy at the stencil's neighbours from one buffer
// and writes the next stage's into the other (k2's and k4's inputs into
// s_v, k3's into s_w), so one barrier a stage parts its writes from the
// next stage's reads; Psix, Psiy and Omega, read at the cell alone by the
// thread that writes them, stay in s_v. The two stacks (tot with c^2, inc
// with c0^2) run one after the other through the same buffers; stack 0's
// new U stays in registers for sc.
template <bool XM, bool GENERAL, bool SLAB>
__global__ void __launch_bounds__(BX * BY, TILED_MIN_BLOCKS)
rk4_step_tiled(const float* __restrict__ u, float* __restrict__ out,
               float* __restrict__ partials, const float* __restrict__ shape,
               const float* __restrict__ prof, const float* __restrict__ owner, StepParams g,
               float t) {
  extern __shared__ float smem[];
  float* s_u = smem;
  float* s_v = s_u + 6 * SC;
  float* s_w = s_v + 6 * SC;
  float* s_f = s_w + 3 * SC;
  float* s_c = s_f + SC;
  const int n = g.n;
  const int w = SLAB ? g.w : n;
  const int nn = n * w;
  const int ghost = SLAB ? HALO : 0;  // halo columns a side
  const int ny = w - 2 * ghost;       // owned columns
  // z: the candidate on the whole grid (its own cylinders, the source shape
  // shared or its own), or the slab (its own columns and source shape, the
  // cylinders shared)
  const size_t cand = blockIdx.z;
  const int col0 = SLAB ? g.col0 + (int)cand * ny : 0;  // global column of local column 0
  u += cand * 12 * (size_t)nn;
  out += cand * 12 * (size_t)nn;
  shape += cand * (size_t)(SLAB ? nn : g.shape_stride);
  if constexpr (!GENERAL) owner += cand * 5 * (size_t)nn;
  const int tx = threadIdx.x, ty = threadIdx.y;

  const int own0 = col0 + ghost;  // global column of the first owned column
  const int ti0 = blockIdx.y * TX, tj0 = own0 + blockIdx.x * TY;
  const Span tile_r{ti0, min(ti0 + TX, n) - 1};
  const Span tile_c{tj0, min(tj0 + TY, own0 + ny) - 1};
  const int r0 = ti0 - HALO - (ti0 == n - 1 ? 1 : 0);  // global row of region row 0
  const int c0g = tj0 - HALO - (tj0 == n - 1 ? 1 : 0);  // global column of region column 0
  const Span load_r{max(r0, 0), min(tile_r.hi + HALO, n - 1)};
  const Span load_c{max(c0g, 0), min(tile_c.hi + HALO, n - 1)};
  const int rows[3] = {HALO + ty, HALO + BY + ty, ty < HALO ? ty : 2 * BY + ty};
  const int gj = c0g + tx;
  const int lj = gj - col0;  // local column
  const bool col_in = load_c.has(gj);

  // the stage times (`stage_times`), their lerp weights and source phases
  const float t0 = t, th = t0 + g.half, t1 = t0 + g.full;
  const float ts3[3] = {t0, th, t1};
  const float span = g.tf - g.ti;
  const float denom = span > 0.0f ? span : 1.0f;
  float lw[3], sn[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    lw[m] = (fminf(fmaxf(ts3[m], g.ti), g.tf) - g.ti) / denom;
    sn[m] = sinf(TWO_PI * ts3[m] * g.freq);
  }

  // load once: the source shape and the wavespeed at the three times
  float sx[3];
  const float sy = __ldg(prof + min(max(gj, 0), n - 1));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int gi = r0 + rows[a];
    const int l = rows[a] * SW + tx;
    const bool in = col_in && load_r.has(gi);
    const int q = in ? gi * w + lj : 0;
    sx[a] = __ldg(prof + min(max(gi, 0), n - 1));
    s_f[l] = in ? __ldg(shape + q) : 0.0f;
    if constexpr (!GENERAL) {
      const float d2 = in ? __ldg(owner + q) : 0.0f;
      const float r1 = in ? __ldg(owner + nn + q) : 0.0f;
      const float dr = in ? __ldg(owner + 2 * nn + q) : 0.0f;
      const float c1 = in ? __ldg(owner + 3 * nn + q) : 0.0f;
      const float dc = in ? __ldg(owner + 4 * nn + q) : 0.0f;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float r = r1 + lw[m] * dr;
        s_c[m * SC + l] = (in && d2 < r * r) ? c1 + lw[m] * dc : g.c0;
      }
    }
  }
  if constexpr (GENERAL) {
    // the cylinders' chunk in s_v, free until stack 0's first stage
    fill_general(s_c, s_v, reinterpret_cast<int*>(s_v + 12 * CYL_CHUNK),
                 g.cyl + (SLAB ? 0 : cand * 8 * (size_t)g.n_cyl), g, lw, r0, c0g, rows, col_in,
                 load_r, gj);
  }

  float u_tot[2] = {0.0f, 0.0f};  // stack 0's new U at the tile cells
  float e_tot = 0.0f, e_inc = 0.0f, e_sc = 0.0f;
#pragma unroll 1
  for (int stack = 0; stack < 2; ++stack) {
    __syncthreads();  // the previous stack no longer reads s_u or s_v
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int gi = r0 + rows[a];
      const int l = rows[a] * SW + tx;
      const bool in = col_in && load_r.has(gi);
      const float* src = u + (size_t)6 * stack * nn + (in ? gi * w + lj : 0);
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) s_u[ch * SC + l] = in ? __ldg(src + ch * nn) : 0.0f;
    }
    __syncthreads();

    float acc[2][6];
    Span vr = load_r, vc = load_c;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      vr = shrink(vr, n);
      vc = shrink(vc, n);
      const float* nb = s == 0 ? s_u : (s == 2 ? s_w : s_v);  // this stage's U, Vx, Vy
      const float* pw = s == 0 ? s_u + 3 * SC : s_v + 3 * SC;
      float* next = s == 1 ? s_w : s_v;  // the next stage's U, Vx, Vy
      const int m = s == 0 ? 0 : (s == 3 ? 2 : 1);  // which stage time
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int gi = r0 + rows[a];
        const bool tile = a < 2 && tile_r.has(gi) && tile_c.has(gj);
        // the last stage computes the tile alone (slots 0 and 1)
        if (s == 3 ? !tile : !(vr.has(gi) && vc.has(gj))) continue;
        const int l = rows[a] * SW + tx;
        const float c = s_c[m * SC + l];
        const float b = stack == 0 ? c * c : g.c0 * g.c0;
        const float bc = (gi > 0 && gi < n - 1 && gj > 0 && gj < n - 1) ? 1.0f : 0.0f;
        float k[6];
        stack_rhs_tiled<XM, SW, SC>(nb, pw, s_f, sn[m], b, l, gi == 0, gi == n - 1, gj == 0,
                            gj == n - 1, sx[a], sy, bc, g.inv2d, k);
        if (s < 3) {
          const float coef = s == 2 ? g.full : g.half;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) {
            if (a < 2 && tile) acc[a][ch] = s == 0 ? k[ch] : acc[a][ch] + 2.0f * k[ch];
            const float v = s_u[ch * SC + l] + coef * k[ch];
            if (ch < 3) {
              next[ch * SC + l] = v;
            } else {
              s_v[ch * SC + l] = v;  // read at this cell alone, by this thread
            }
          }
        } else if (a < 2) {
          // u + dt/6 (k1 + 2 k2 + 2 k3 + k4), left to right as the closed form
          float* dst = out + (size_t)6 * stack * nn + gi * w + lj;
          float un = 0.0f;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) {
            const float v = s_u[ch * SC + l] + g.sixth * (acc[a][ch] + k[ch]);
            dst[ch * nn] = v;
            if (ch == 0) un = v;
          }
          if (stack == 0) {
            u_tot[a] = un;
          } else {
            const float sc = u_tot[a] - un;
            e_tot += u_tot[a] * u_tot[a];
            e_inc += un * un;
            e_sc += sc * sc;
          }
        }
      }
      if (s < 3) __syncthreads();  // the next stage reads what this one wrote
    }
  }

  // a slab's halo columns are written 0: the left ones by the first tile
  // column's blocks, the right ones by the last's
  if constexpr (SLAB) {
    if ((blockIdx.x == 0 && lj < HALO) ||
        (blockIdx.x == gridDim.x - 1 && lj >= HALO + ny && lj < w)) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int gi = r0 + rows[a];
        if (!tile_r.has(gi)) continue;
        float* dst = out + gi * w + lj;
#pragma unroll
        for (int ch = 0; ch < 12; ++ch) dst[ch * nn] = 0.0f;
      }
    }
  }

  // s_c is free: stack 1 does not read it
  const float s_tot = block_sum(e_tot, s_c);
  const float s_inc = block_sum(e_inc, s_c);
  const float s_sc = block_sum(e_sc, s_c);
  if (tx == 0 && ty == 0) {
    const size_t blocks = (size_t)gridDim.x * gridDim.y;
    float* dst = partials + 3 * (cand * blocks + blockIdx.y * gridDim.x + blockIdx.x);
    dst[0] = s_tot;
    dst[1] = s_inc;
    dst[2] = s_sc;
  }
}

// The owner pass's grid for n rows and w local columns a candidate or slab.
dim3 owner_grid(int n, int w, int batch) {
  return dim3((w + OWN_TC - 1) / OWN_TC, (n + OWN_TR - 1) / OWN_TR, batch);
}

// The step's grid for n rows and ny owned columns a candidate or slab.
dim3 tiled_grid(int n, int ny, int batch) {
  return dim3((ny + TY - 1) / TY, (n + TX - 1) / TX, batch);
}

// Lets `rk4_step_tiled<XM, GENERAL, SLAB>` take TILED_SMEM bytes of dynamic
// shared memory, more than the 48 KB a kernel gets unasked, on the current
// device, once a device. The attribute is an instance's own, and so is its
// cache.
template <bool XM, bool GENERAL, bool SLAB>
cudaError_t configure_tiled() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(rk4_step_tiled<XM, GENERAL, SLAB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, TILED_SMEM);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <bool XM, bool GENERAL, bool SLAB>
int step_occupancy() {
  int blocks = 0;
  cudaError_t e = configure_tiled<XM, GENERAL, SLAB>();
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, rk4_step_tiled<XM, GENERAL, SLAB>, BX * BY, TILED_SMEM);
  }
  return e == cudaSuccess ? blocks : -(int)e;
}

template <bool XM, bool GENERAL, bool SLAB>
int step_tiled(const TiledWindow* w, const float* u, float* out, float* partials, float t) {
  const cudaError_t e = configure_tiled<XM, GENERAL, SLAB>();
  if (e != cudaSuccess) return (int)e;
  const StepParams p{w->n,     w->w,  w->col0, w->inv2d, w->c0,    w->freq,  w->half, w->full,
                     w->sixth, w->ti, w->tf,  w->cyl,   w->n_cyl, w->x_min, w->spacing,
                     w->shape_stride};
  const int ny = SLAB ? w->w - 2 * HALO : w->n;
  rk4_step_tiled<XM, GENERAL, SLAB><<<tiled_grid(w->n, ny, w->batch), dim3(BX, BY), TILED_SMEM,
                                      (cudaStream_t)w->stream>>>(u, out, partials, w->shape,
                                                                 w->prof, w->owner, p, t);
  return (int)cudaGetLastError();
}

template <bool SLAB>
int step_instance(const TiledWindow* w, const float* u, float* out, float* partials, float t) {
  if (w->owner == nullptr) {
    return w->xm ? step_tiled<true, true, SLAB>(w, u, out, partials, t)
                 : step_tiled<false, true, SLAB>(w, u, out, partials, t);
  }
  return w->xm ? step_tiled<true, false, SLAB>(w, u, out, partials, t)
               : step_tiled<false, false, SLAB>(w, u, out, partials, t);
}

template <bool SLAB>
int occupancy_instance(int xm, int general) {
  if (general) {
    return xm ? step_occupancy<true, true, SLAB>() : step_occupancy<false, true, SLAB>();
  }
  return xm ? step_occupancy<true, false, SLAB>() : step_occupancy<false, false, SLAB>();
}

}  // namespace

extern "C" {

// Energy-partial rows (blocks) of one candidate's or slab's step on n rows
// and ny owned columns (n x n on the whole grid).
int fused_rk4_step_blocks(int n, int ny) {
  const dim3 gr = tiled_grid(n, ny, 1);
  return (int)(gr.x * gr.y);
}

// Dynamic shared memory of a block of the step, in bytes.
int fused_rk4_step_smem() { return TILED_SMEM; }

// Blocks of the step's instance (xm 1: split d/dx, 0: exact; general 1:
// the general rasterisation, 0: the owner test; slab 1: on slabs, 0: on
// the whole grid) resident on one SM of the current device, as the
// occupancy calculator gives it for the instance's registers and shared
// memory; negative on an error.
int fused_rk4_step_occupancy(int xm, int general, int slab) {
  return slab ? occupancy_instance<true>(xm, general) : occupancy_instance<false>(xm, general);
}

// One whole RK4 step in one launch, with the exact d/dx for w->xm 0 (K1,
// K2, K3, K4) or the split one for w->xm 1 (K5, batched K5, K4-XM);
// radii-only on w->owner's fields, or general on w->cyl's n_cyl cylinders
// where w->owner is null (a null w->cyl only with no cylinder). On the
// whole grid (w->w == n, w->col0 == 0) of w->batch candidates: u and out
// (batch, 12, n, n), partials (batch, fused_rk4_step_blocks(n, n), 3), the
// source shape (n, n) shared (w->shape_stride 0) or (batch, n, n) (n * n). On
// w->batch consecutive slabs of w->w local columns from w->col0: u and out
// (batch, 12, n, w), their halo columns written 0, partials
// (batch, fused_rk4_step_blocks(n, w - 8), 3). t is the step's start time.
// Returns the cudaError_t of the launch.
int fused_rk4_step_tiled(const TiledWindow* w, const float* u, float* out, float* partials,
                         float t) {
  if (w == nullptr || w->spc != 1 || w->batch < 1 || w->batch > 65535 ||
      !valid_extent(w->n, w->w, w->col0, w->batch, HALO) || w->xm < 0 || w->xm > 1 || w->n_cyl < 0 ||
      (w->shape_stride != 0 && !(w->shape_stride == w->n * w->n && w->w == w->n &&
                                 w->col0 == 0)) ||
      (w->owner == nullptr && w->n_cyl > 0 && w->cyl == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool whole = w->w == w->n && w->col0 == 0;
  return whole ? step_instance<false>(w, u, out, partials, t)
               : step_instance<true>(w, u, out, partials, t);
}

// Owner fields (batch, 5, n, w) in one launch: on the whole grid (w == n,
// col0 == 0) of `batch` candidates' cylinders (batch, 8, n_cyl); on any
// other (w, col0), of the (8, n_cyl) cylinders on `batch` consecutive
// slabs of w local columns from col0 with `halo` halo columns a side, as
// `fused_rk4_step_tiled` (halo HALO) and `fused_rk4_steps_tiled` (halo
// 4 spc) take them, slab z's local column j at global column
// col0 + z (w - 2 halo) + j.
int select_owner(int batch, const float* cyl, int n_cyl, float* owner, int n, int w, int col0,
                 int halo, float spacing, float x_min, void* stream) {
  if (batch < 1 || batch > 65535 || !valid_extent(n, w, col0, batch, halo) || n_cyl < 0 ||
      (n_cyl > 0 && cyl == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool whole = w == n && col0 == 0;
  select_owner_kernel<<<owner_grid(n, w, batch), dim3(OWN_BX, OWN_BY), 0,
                        (cudaStream_t)stream>>>(cyl, n_cyl, owner,
                                                Geometry{n, w, col0, halo, spacing, x_min, !whole});
  return (int)cudaGetLastError();
}

}  // extern "C"
