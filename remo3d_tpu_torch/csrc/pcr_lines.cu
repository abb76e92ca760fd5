// Factored PCR tridiagonal line apply (K3), x = T^{-1} b, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels pcr_apply_pallas / line_rz_apply_pallas
// (remo3d_tpu/ops/pallas_lines2d.py:116) and line_apply3_pallas
// (remo3d_tpu/ops/pallas_lines3d.py:74), both at commit 9fd23cb^: the line
// solves of the 2D multigrid smoother (line_rz, every level) and of the 3D ADI
// sweep (z-p-r-p-z). What they computed is the JAX package's plain
// remo3d_tpu/ops/lines.py:111 pcr_apply, and the port's plain version is
// remo3d_tpu_torch/ops/lines.py pcr_apply. Per reduction level k, s = 2^k:
//
//   x(i) <- x(i) + alpha_k(i) x(i - s) + beta_k(i) x(i + s)   (terms outside the line dropped)
//
// and at the end x(i) * dinv(i). Each product and each sum is rounded on its
// own (__fmul_rn / __fadd_rn, no FMA), in the plain version's order.
//
// Layout: F (B, 2L+1, grid) holds alpha_0, beta_0, ..., alpha_{L-1},
// beta_{L-1}, dinv; b and x are (B, S, grid). The grid is viewed as (outer, n,
// inner) with the lines along n at stride inner, so one kernel serves the 2D
// r lines (inner 1) and z lines (inner NR) and the 3D z (inner NP*NR), p
// (inner NR) and r (inner 1) lines.
//
// Bound: device-memory bytes. The least traffic is b read and x written once
// per solve plus, once per batch, the coefficients the function reads: on a
// line of n nodes, level k (s = 2^k < n) reads alpha_k at i >= s and beta_k at
// i < n - s, then dinv at every node, n (2L + 1) - 2 (2^L - 1) values a line
// (kernels/pcr_lines.py least_work); the 4 flops per level, node and solve
// stay far below the compute rate.
//
// Design. A block holds a tile of lines of one batch for ALL S solves in
// shared memory, twice (the level being read, the level being written),
// through every level, and writes x once: the per-level intermediate never
// reaches device memory. The tile plan (lines per tile, cluster, nodes per
// block, stages, shared memory) is computed by the wrapper (kernels/pcr_lines.py
// tile_plan, a cost model of waves and occupancy fitted to chip_smoke.py
// --tune) and only checked here (check_plan): a plan this kernel cannot run
// is refused with cudaErrorInvalidValue, never replaced.
//
// - Coefficients are streamed ahead of the levels. Each level's alpha_k and
//   beta_k (after the last level, dinv) are copied into a ring of `stages`
//   shared-memory slots with cp.async, one commit group per level, issued
//   `stages - 1` levels ahead; where every level fits beside x (stages > L)
//   all of them are issued at once with b. A level waits for its own group
//   (cp.async.wait_group) and then meets the one barrier per level, which
//   also frees the slot of the level before for the next copy: a level waits
//   on shared memory, not on a device-memory round trip of its own.
//   A tile whose lines are whole runs of memory (r lines; p lines with all of
//   inner in the tile) stages each plane as one run, placed at its address
//   modulo 16 bytes (slab_stage.cuh: 16-byte cp.async body, element-wise
//   head and tail; TMA tensor maps need 16-byte strides, which these grids
//   do not have), at the start of a level. Strided rows are copied element
//   by element, only the coefficients the level reads, node by node inside
//   the level loop that walks the same nodes (one walk instead of two: the z
//   lines 10% faster). The two kinds are two instantiations (RUN), so the
//   run tiles carry none of the rows' registers.
// - Strided lines (z) take rows of at least 32 bytes (8 float32 or 4 float64
//   lines along inner), and each line is split over the C = 2, 4 or 8 blocks
//   of a thread-block cluster (launched with cudaLaunchKernelEx), every C-th
//   node in each block: block c holds nodes c, c + C, c + 2C, ... (at most
//   `seg`) of every line of the tile. At a level with s < C a node's
//   neighbours i -+ s lie in blocks c -+ s (mod C), in the same or the next
//   row, read from their shared memory (distributed shared memory,
//   cluster.map_shared_rank, one mapping per level); from s = C on they lie
//   s / C rows away in the block's own. So only the first log2(C) levels
//   read remotely, and only they and the level after them need a cluster
//   barrier (the others a block barrier); after that no block reads
//   another's shared memory, and a block may exit. (Contiguous segments per
//   block, tried first, read remotely on every level at or above a segment
//   and were about a quarter slower.)
// - A thread walks over the block's nodes kThreads apart (neighbouring
//   threads on neighbouring addresses), kUnroll at a time; its nodes' rows,
//   columns and line positions are advanced by additions (Walk), not
//   recomputed by division at every level.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, float32
// (chip_smoke.py phase 30, --probe, --tune): 68 registers (clustered), 56
// (runs), no spill, two or three blocks of 75-108 KB per SM at the main
// shapes. 2D finest z lines (74, 5, 761x161: clusters of 8, 14-line tiles)
// 1.09 ms against a bound of 0.307 ms (28%; 1.44 ms before this design), r
// lines 0.52 ms against 0.258 ms (50%; 0.74); 3D (8, 5, 193x17x49) z
// (clusters of 2, 17 lines) 0.126, p 0.065, r 0.074 ms against 0.037, 0.027,
// 0.031 ms (30%, 41%, 43%; 0.171, 0.087, 0.116). The probe builds say what is left:
// without any coefficient about a quarter less (their copies, loads and
// bytes: the coefficients are 42-65% of the bytes), without the level
// barriers 0-5% less; the level loop is bound by its integer work (over
// half of the kernel's instructions, cuobjdump -sass) at two blocks per SM: more
// solves' loads in flight at once, 384 or 512 threads, or one or four
// nodes at a time were all slower.
//
// A term outside the line is dropped, not multiplied by zero, so a solve that
// holds Inf or NaN spreads it only where the plain version does.
//
// The step epilogue (STEP, entry points pcr_lines_step_*): the 3D ADI sweep's
// damped update z + w T^{-1} res in the same launch. The kernel writes
// base + scale (x dinv), or scale (x dinv) without base, each product and sum
// rounded on its own in that order (the sweep's torch ops z + w * y, with the
// float64 w rounded once to T). After the barrier before the dinv step, each
// thread copies base of its own nodes (cp.async) into the x buffer that the
// last level read, which no thread reads any more, and reads only those
// copies back: it reads base at the addresses it then writes, so x may alias
// base (the sweep updates z in place), across a cluster too. The launch
// without the epilogue is its own instantiation, with the code above.
// Measured (chip_smoke.py phase 30, float32, the 3D benchmark cells' chunks
// (8, 5, 257x25x65) and (8, 5, 193x17x49)): the launch 8-19% slower than
// without the epilogue, the sweep's step 1.3-1.6x faster than K3 followed by
// the projection's copy, the multiply and the add.
//
// Probe builds (chip_smoke.py --probe), wrong results on purpose:
// -DREMO3D_K3_PROBE=1 loads no coefficient (constants in their place),
// -DREMO3D_K3_PROBE=2 drops the barrier between levels (the barriers after
// the first staging and before the dinv step stay, so no block exits while a
// partner reads it).

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "slab_stage.cuh"

#ifndef REMO3D_K3_PROBE
#define REMO3D_K3_PROBE 0
#endif

// A probe build's kernels carry names of their own: several builds are
// loaded into one process (chip_smoke.py --probe), and two libraries whose
// cluster kernels shared a name crashed that process on the card.
#define REMO3D_K3_CAT_(a, b) a##b
#define REMO3D_K3_CAT(a, b) REMO3D_K3_CAT_(a, b)

namespace {
namespace REMO3D_K3_CAT(build, REMO3D_K3_PROBE) {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// Nodes a thread takes at once: their shared-memory loads are in flight
// together (2 measured faster than 4 at every main-path shape; 8 spills).
constexpr int kUnroll = 2;
// Resident blocks per SM the registers must allow (kernels/pcr_lines.py
// BLOCKS_PER_SM): at most 85 registers a thread.
constexpr int kMinBlocks = 3;
constexpr int kMaxCluster = 8;  // the portable cluster size

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The lines of a launch.
struct Lines {
  int S, outer, n, inner;
  int L;   // levels run: those of F's with s = 2^k < n (the others change nothing)
  int LF;  // levels of F: dinv is its plane 2 LF
};

// The tile plan, in kernels/pcr_lines.py PLAN_FIELDS order.
struct Plan {
  int TO;       // lines of a tile along outer
  int TI;       // lines of a tile along inner (at most; tiles split inner evenly)
  int tiles_o;  // tiles along outer (split evenly)
  int tiles_i;  // tiles along inner (split evenly)
  int cluster;  // blocks per tile (a power of two), each holding every cluster-th node
  int seg;      // nodes of a line per block, at most
  int stages;   // coefficient slots; more than L: every level staged at once
  int smem;     // dynamic shared memory per block (bytes)
};

template <typename T>
__host__ __device__ inline long long x_cap(const Plan& p) {  // elements of one solve's buffer
  constexpr int V = slab::vec_elems<T>();
  const long long nodes = static_cast<long long>(p.TO) * p.seg * p.TI;
  return (nodes + V - 1) / V * V;
}

template <typename T>
__host__ __device__ inline long long c_cap(const Plan& p) {  // one coefficient plane, + room for the shift
  constexpr int V = slab::vec_elems<T>();
  const long long nodes = static_cast<long long>(p.TO) * p.seg * p.TI;
  return (nodes + 2 * V - 2) / V * V;
}

__host__ __device__ inline int planes(const Lines& s, const Plan& p) {
  return p.stages > s.L ? 2 * s.L + 1 : 2 * p.stages;
}

template <typename T>
long long plan_smem(const Lines& s, const Plan& p) {
  return static_cast<long long>(sizeof(T)) *
         (2LL * s.S * x_cap<T>(p) + static_cast<long long>(planes(s, p)) * c_cap<T>(p));
}

// A thread's walk over the block's nodes q = tid, tid + kThreads, ...: R =
// q / wi (row of the tile), j = q % wi (column), i the position on the line.
struct Walk {
  int R, j, i;
};

struct Stride {
  int dR, dJ, wi;  // kThreads = dR wi + dJ
  int dI, cI, n;   // i advances by dI, and cI more where j wraps; modulo n (whole lines)
};

__device__ __forceinline__ void advance(Walk& w, const Stride& d) {
  w.j += d.dJ;
  const bool c = w.j >= d.wi;
  if (c) w.j -= d.wi;
  w.R += d.dR + c;
  w.i += d.dI + (c ? d.cI : 0);
  if (w.i >= d.n) w.i -= d.n;
}

// Wait until at most `pending` of this thread's newest cp.async groups are in
// flight (at most 7 kept: waiting more is still correct).
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: slab::cp_async_wait_group<0>(); break;
    case 1: slab::cp_async_wait_group<1>(); break;
    case 2: slab::cp_async_wait_group<2>(); break;
    case 3: slab::cp_async_wait_group<3>(); break;
    case 4: slab::cp_async_wait_group<4>(); break;
    case 5: slab::cp_async_wait_group<5>(); break;
    case 6: slab::cp_async_wait_group<6>(); break;
    default: slab::cp_async_wait_group<7>(); break;
  }
}

// The step epilogue's arguments: base (B, S, grid), nullptr for none, and
// the scale.
template <typename T>
struct Step {
  const T* base;
  T scale;
};

// RUN: the tile is whole lines with all of inner, one run of each plane (no
// cluster); else rows of the tile's lines along inner, split over the
// cluster's blocks (a cluster launch, of one block where the plan has none).
// STEP: x = e.base + e.scale (x dinv) (the step epilogue, above); else x dinv.
template <typename T, bool RUN, bool STEP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pcr_lines_kernel(const T* __restrict__ F, const T* __restrict__ b, T* __restrict__ x,
                 const Lines s, const Plan p, const Step<T> e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  constexpr bool CLUSTERED = !RUN;
  const int C = CLUSTERED ? p.cluster : 1;
  int rank = 0;
  unsigned int tile = blockIdx.x;
  if constexpr (CLUSTERED) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    tile /= p.cluster;
  }
  const int ti = static_cast<int>(tile % p.tiles_i);
  tile /= p.tiles_i;
  const int to = static_cast<int>(tile % p.tiles_o);
  const int batch = static_cast<int>(tile / p.tiles_o);
  const int o0 = static_cast<int>(static_cast<long long>(to) * s.outer / p.tiles_o);
  const int o1 = static_cast<int>(static_cast<long long>(to + 1) * s.outer / p.tiles_o);
  const int j0 = static_cast<int>(static_cast<long long>(ti) * s.inner / p.tiles_i);
  const int wi = static_cast<int>(static_cast<long long>(ti + 1) * s.inner / p.tiles_i) - j0;
  // This block holds the nodes i = rank + C r (r = 0 .. rows - 1) of each line.
  const int rows = rank < s.n ? (s.n - rank + C - 1) / C : 0;
  const int nodes = (o1 - o0) * rows * wi;  // node q: row q / wi, column q % wi
  constexpr bool run = RUN;

  // Indices into shared memory and offsets inside a plane are 32-bit
  // (check_plan keeps both below INT_MAX): the kernel is bound by its
  // integer work, and 64-bit ones cost 3-5% at the main shapes.
  const int xcap = static_cast<int>(x_cap<T>(p)), ccap = static_cast<int>(c_cap<T>(p));
  T* cur = reinterpret_cast<T*>(smem_raw);  // [S][xcap], the level being read
  T* nxt = cur + s.S * xcap;                // [S][xcap], the level being written
  T* coef = nxt + s.S * xcap;               // planes(s, p) slots of ccap

  const long long N = static_cast<long long>(s.outer) * s.n * s.inner;  // nodes of a plane
  const int base = (o0 * s.n + rank) * s.inner + j0;  // node 0 in a plane
  const int rstride = C * s.inner;                      // between the block's rows
  const T* Fb = F + static_cast<long long>(batch) * (2 * s.LF + 1) * N;
  const T* bb = b + static_cast<long long>(batch) * s.S * N;
  T* xb = x + static_cast<long long>(batch) * s.S * N;

  Stride d;
  d.wi = wi;
  d.dR = kThreads / wi;
  d.dJ = kThreads - d.dR * wi;
  d.n = s.n;
  d.dI = run ? d.dR % s.n : d.dR * C;
  d.cI = run ? 1 : C;
  Walk w0;
  w0.R = tid / wi;
  w0.j = tid - w0.R * wi;
  w0.i = run ? w0.R % s.n : w0.R * C + rank;
  auto offset = [&](int q, const Walk& w) -> int {  // of node q from a plane's start
    return run ? base + q : base + w.R * rstride + w.j;
  };

  // Copies of load k (k < L: alpha_k, beta_k; k == L: dinv) into its slot.
  auto stage_coef = [&](int k) {
#if REMO3D_K3_PROBE != 1
    const int slot = 2 * (k % p.stages);
    const int step = 1 << (k < s.L ? k : 0);
    for (int h = 0; h < (k < s.L ? 2 : 1); ++h) {
      const T* src = Fb + static_cast<long long>(k < s.L ? 2 * k + h : 2 * s.LF) * N;
      T* dst = coef + (slot + h) * ccap;
      if (run) {
        dst += slab::shift(src, static_cast<unsigned int>(base));
        slab::stage_run(dst, src + base, nodes, tid, kThreads);
      } else {
        Walk w = w0;
        for (int q = tid; q < nodes; q += kThreads, advance(w, d)) {
          const bool need = k == s.L || (h == 0 ? w.i >= step : w.i + step < s.n);
          if (need) slab::cp_async<sizeof(T)>(dst + q, src + offset(q, w));
        }
      }
    }
#endif
  };
  // Where in its slot plane (h) of load k has node 0 (the run's shift).
  auto slot_of = [&](int k, int h) -> const T* {
    const T* slot = coef + (2 * (k % p.stages) + h) * ccap;
    if (run) {
      const T* src = Fb + static_cast<long long>(k < s.L ? 2 * k + h : 2 * s.LF) * N;
      slot += slab::shift(src, static_cast<unsigned int>(base));
    }
    return slot;
  };
  // The barrier before level k (k == L: before the dinv step). Level k reads
  // other blocks' shared memory while s = 2^k < C; a cluster barrier makes
  // their level k-1 visible, and the one after the last such level keeps
  // their next writes (and their exit) behind every read of it.
  auto level_sync = [&](int k) {
    if constexpr (CLUSTERED) {
      if (k == 0 || (1 << (k - 1)) < C) {
        cg::this_cluster().sync();
        return;
      }
    }
    __syncthreads();
  };

  // b, then the first loads: group 0 is b with load 0, one group per load after.
  for (int g = 0; g < s.S; ++g) {
    Walk w = w0;
    for (int q = tid; q < nodes; q += kThreads, advance(w, d)) {
      slab::cp_async<sizeof(T)>(cur + g * xcap + q, bb + g * N + offset(q, w));
    }
  }
  const bool all = p.stages > s.L;
  int issued = 0;
  for (const int ahead = all ? s.L + 1 : p.stages; issued < ahead; ++issued) {
    stage_coef(issued);
    slab::cp_async_commit();
  }

  for (int k = 0; k < s.L; ++k) {
    cp_async_wait_pending(issued - k - 1);
#if REMO3D_K3_PROBE == 2
    if (k == 0) level_sync(k);
#else
    level_sync(k);  // load k visible; level k-1 written (in every block); slot of k-1 free
#endif
    // Load k + stages - 1 into the slot of level k - 1: a run at once here;
    // rows node by node in this level's loop, beside the node's other work
    // (one walk over the nodes instead of two: the z lines 10% faster).
    const bool ahead = !all && k >= 1 && issued <= s.L;
    if (run && ahead) {
      stage_coef(issued++);
      slab::cp_async_commit();
    }
    T* const na = coef + (2 * (issued % p.stages)) * ccap;
    const T* const ga = Fb + static_cast<long long>(issued < s.L ? 2 * issued : 2 * s.LF) * N;
    const int nstep = 1 << (issued < s.L ? issued : 0);
    const int step = 1 << k;
    const T* ca = slot_of(k, 0);
    const T* cb = slot_of(k, 1);
    // x(i - s) and x(i + s) of node q are xlo[q] and xhi[q]: s / C rows away
    // in this block, or (s < C) the same or the next row of the block that
    // holds i -+ s.
    const T* xlo = cur - (step / C) * wi;
    const T* xhi = cur + (step / C) * wi;
    if constexpr (CLUSTERED) {
      if (step < C) {
        xlo = cg::this_cluster().map_shared_rank(cur, (rank - step) & (C - 1)) -
              (rank < step ? wi : 0);
        xhi = cg::this_cluster().map_shared_rank(cur, (rank + step) & (C - 1)) +
              (rank + step >= C ? wi : 0);
      }
    }
    Walk w = w0;
    for (int q0 = tid; q0 < nodes; q0 += kUnroll * kThreads) {
      T a[kUnroll], c[kUnroll];
      bool ok[kUnroll], lo[kUnroll], hi[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * kThreads;
        ok[u] = q < nodes;
        lo[u] = ok[u] && w.i >= step;
        hi[u] = ok[u] && w.i + step < s.n;
#if REMO3D_K3_PROBE == 1
        a[u] = lo[u] ? T(0.25) : T(0);
        c[u] = hi[u] ? T(0.25) : T(0);
#else
        a[u] = lo[u] ? ca[q] : T(0);
        c[u] = hi[u] ? cb[q] : T(0);
        if (!run && ahead && ok[u]) {  // the next load's coefficients of this node
          const int off = offset(q, w);
          if (issued == s.L || w.i >= nstep) slab::cp_async<sizeof(T)>(na + q, ga + off);
          if (issued < s.L && w.i + nstep < s.n) {
            slab::cp_async<sizeof(T)>(na + ccap + q, ga + N + off);
          }
        }
#endif
        advance(w, d);
      }
      for (int g = 0; g < s.S; ++g) {
        // The 3 kUnroll values of this solve first, then the kUnroll sums: the
        // shared-memory loads are in flight together.
        const int go = g * xcap + q0;
        T x0[kUnroll], xm[kUnroll], xp[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          x0[u] = ok[u] ? cur[go + u * kThreads] : T(0);
          xm[u] = lo[u] ? xlo[go + u * kThreads] : T(0);
          xp[u] = hi[u] ? xhi[go + u * kThreads] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          T v = x0[u];
          if (lo[u]) v = add_rn(v, mul_rn(a[u], xm[u]));
          if (hi[u]) v = add_rn(v, mul_rn(c[u], xp[u]));
          if (ok[u]) nxt[go + u * kThreads] = v;
        }
      }
    }
    if (!run && ahead) {
      slab::cp_async_commit();
      ++issued;
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
  }

  // dinv. After this barrier no block reads another's shared memory, so a
  // block may finish and exit.
  cp_async_wait_pending(0);
  level_sync(s.L);
  // The step's base, this thread's nodes, into the buffer the last level read
  // (a prefetch of it into L2 at the kernel's start measured 2-5% slower).
  const bool has_base = STEP && e.base != nullptr;
  if (has_base) {
    const T* eb = e.base + static_cast<long long>(batch) * s.S * N;
    Walk w = w0;
    for (int q = tid; q < nodes; q += kThreads, advance(w, d)) {
      const int off = offset(q, w);
      for (int g = 0; g < s.S; ++g) slab::cp_async<sizeof(T)>(nxt + g * xcap + q, eb + g * N + off);
    }
    slab::cp_async_commit();
    slab::cp_async_wait_group<0>();
  }
  const T* cd = slot_of(s.L, 0);
  Walk w = w0;
  for (int q0 = tid; q0 < nodes; q0 += kUnroll * kThreads) {
    T dv[kUnroll];
    int off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kThreads;
#if REMO3D_K3_PROBE == 1
      dv[u] = T(1);
#else
      dv[u] = q < nodes ? cd[q] : T(0);
#endif
      off[u] = offset(q, w);
      advance(w, d);
    }
    for (int g = 0; g < s.S; ++g) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = q0 + u * kThreads < nodes ? cur[g * xcap + q0 + u * kThreads] : T(0);
      }
      if constexpr (STEP) {
        T z[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          z[u] = has_base && q0 + u * kThreads < nodes ? nxt[g * xcap + q0 + u * kThreads] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (q0 + u * kThreads < nodes) {
            const T y = mul_rn(e.scale, mul_rn(v[u], dv[u]));
            xb[g * N + off[u]] = has_base ? add_rn(z[u], y) : y;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (q0 + u * kThreads < nodes) xb[g * N + off[u]] = mul_rn(v[u], dv[u]);
        }
      }
    }
  }
}

int levels_run(int n, int LF) {
  int L = 0;
  while (L < LF && L < 31 && (1LL << L) < n) ++L;
  return L;
}

// Whether this kernel can run the plan on these lines (never a repair).
template <typename T>
bool check_plan(int B, const Lines& s, const Plan& p) {
  if (p.TO < 1 || p.TI < 1 || p.TO > s.outer || p.TI > s.inner) return false;
  if (p.tiles_o < 1 || p.tiles_o > s.outer || p.tiles_i < 1 || p.tiles_i > s.inner) return false;
  // Even split: every tile at most TO x TI lines.
  if (static_cast<long long>(p.TO) * p.tiles_o < s.outer ||
      static_cast<long long>(p.TI) * p.tiles_i < s.inner) {
    return false;
  }
  if (p.tiles_i > 1 && p.TO != 1) return false;  // a tile of part of inner spans one outer line
  if (p.cluster < 1 || p.cluster > kMaxCluster || (p.cluster & (p.cluster - 1)) != 0) return false;
  if (p.cluster > 1 && p.TO != 1) return false;
  if (p.seg < 1 || p.seg > s.n || static_cast<long long>(p.seg) * p.cluster < s.n) return false;
  if (p.cluster == 1 && p.seg != s.n) return false;
  if (p.stages < 1 || (p.stages < 2 && p.stages <= s.L)) return false;
  const long long smem = plan_smem<T>(s, p);
  if (smem != p.smem || smem > static_cast<long long>(slab::kMaxSmemBytes)) return false;
  // Shared-memory indices and offsets inside a plane are int.
  if (2LL * s.S * x_cap<T>(p) + planes(s, p) * c_cap<T>(p) > INT_MAX) return false;
  if (static_cast<long long>(s.outer) * s.n * s.inner > INT_MAX) return false;
  const long long blocks = static_cast<long long>(B) * p.tiles_o * p.tiles_i * p.cluster;
  return blocks <= INT_MAX;
}

// A tile of whole lines with all of inner, unclustered: one run of each plane.
bool whole_runs(const Plan& p) { return p.cluster == 1 && p.tiles_i == 1; }

bool read_args(int B, int S, int outer, int n, int inner, int LF, const int* plan, Lines& s,
               Plan& p) {
  if (B <= 0 || S <= 0 || outer <= 0 || n <= 0 || inner <= 0 || LF <= 0 || LF > 31 ||
      plan == nullptr) {
    return false;
  }
  s = Lines{S, outer, n, inner, levels_run(n, LF), LF};
  p = Plan{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7]};
  return true;
}

template <typename T, bool STEP>
int launch(const void* F, const void* b, void* x, const Step<T> e, int B, int S, int outer,
           int n, int inner, int LF, const int* plan, void* stream) {
  Lines s;
  Plan p;
  if (!read_args(B, S, outer, n, inner, LF, plan, s, p) || !check_plan<T>(B, s, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks = static_cast<unsigned int>(B) * p.tiles_o * p.tiles_i * p.cluster;
  const T* Fp = static_cast<const T*>(F);
  const T* bp = static_cast<const T*>(b);
  T* xp = static_cast<T*>(x);
  if (whole_runs(p)) {
    cudaError_t err = slab::allow_smem(pcr_lines_kernel<T, true, STEP>, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    pcr_lines_kernel<T, true, STEP>
        <<<blocks, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(Fp, bp, xp, s, p, e);
    return static_cast<int>(cudaGetLastError());
  }
  // Rows: a cluster launch, of one block where the plan has no cluster.
  cudaError_t err = slab::allow_smem(pcr_lines_kernel<T, false, STEP>, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pcr_lines_kernel<T, false, STEP>, Fp, bp, xp, s, p, e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool STEP>
int info(int B, int S, int outer, int n, int inner, int LF, const int* plan, int* out) {
  Lines s;
  Plan p;
  if (!read_args(B, S, outer, n, inner, LF, plan, s, p) || !check_plan<T>(B, s, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  slab::Tile st;
  st.TZ = p.TO * p.TI;  // lines per tile
  st.G = S;
  st.smem = static_cast<size_t>(p.smem);
  return whole_runs(p) ? slab::kernel_info(pcr_lines_kernel<T, true, STEP>, kThreads, st, out)
                       : slab::kernel_info(pcr_lines_kernel<T, false, STEP>, kThreads, st, out);
}

}  // namespace REMO3D_K3_CAT(build, REMO3D_K3_PROBE)
}  // namespace

using REMO3D_K3_CAT(build, REMO3D_K3_PROBE)::launch;
using REMO3D_K3_CAT(build, REMO3D_K3_PROBE)::info;
using REMO3D_K3_CAT(build, REMO3D_K3_PROBE)::Step;

// plan: the 8 ints of kernels/pcr_lines.py PLAN_FIELDS, checked, never replaced.
extern "C" int pcr_lines_f32(const void* F, const void* b, void* x, int B, int S, int outer,
                             int n, int inner, int L, const int* plan, void* stream) {
  return launch<float, false>(F, b, x, {nullptr, 0.0f}, B, S, outer, n, inner, L, plan, stream);
}

extern "C" int pcr_lines_f64(const void* F, const void* b, void* x, int B, int S, int outer,
                             int n, int inner, int L, const int* plan, void* stream) {
  return launch<double, false>(F, b, x, {nullptr, 0.0}, B, S, outer, n, inner, L, plan, stream);
}

// The step epilogue: x = base + scale T^{-1} b (base may be x itself, or
// null: x = scale T^{-1} b); scale is rounded to the solve's type once.
extern "C" int pcr_lines_step_f32(const void* F, const void* b, void* x, const void* base,
                                  double scale, int B, int S, int outer, int n, int inner, int L,
                                  const int* plan, void* stream) {
  const Step<float> e{static_cast<const float*>(base), static_cast<float>(scale)};
  return launch<float, true>(F, b, x, e, B, S, outer, n, inner, L, plan, stream);
}

extern "C" int pcr_lines_step_f64(const void* F, const void* b, void* x, const void* base,
                                  double scale, int B, int S, int outer, int n, int inner, int L,
                                  const int* plan, void* stream) {
  const Step<double> e{static_cast<const double*>(base), scale};
  return launch<double, true>(F, b, x, e, B, S, outer, n, inner, L, plan, stream);
}

// What a launch of B batches of S solves on lines (outer, n, inner) with L
// levels and this plan would use (slab::kernel_info; its tile height is the
// lines per tile), without the step epilogue and with it.
extern "C" int pcr_lines_info_f32(int B, int S, int outer, int n, int inner, int L,
                                  const int* plan, int* out) {
  return info<float, false>(B, S, outer, n, inner, L, plan, out);
}

extern "C" int pcr_lines_info_f64(int B, int S, int outer, int n, int inner, int L,
                                  const int* plan, int* out) {
  return info<double, false>(B, S, outer, n, inner, L, plan, out);
}

extern "C" int pcr_lines_step_info_f32(int B, int S, int outer, int n, int inner, int L,
                                       const int* plan, int* out) {
  return info<float, true>(B, S, outer, n, inner, L, plan, out);
}

extern "C" int pcr_lines_step_info_f64(int B, int S, int outer, int n, int inner, int L,
                                       const int* plan, int* out) {
  return info<double, true>(B, S, outer, n, inner, L, plan, out);
}
