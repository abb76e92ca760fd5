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
// Design. A block owns a tile of whole lines of one batch: TO adjacent values
// of outer times TI adjacent values of inner (all of inner where it is narrow,
// so the tile is one contiguous run; else TI adjacent lines, whose rows are
// contiguous runs of TI), and holds the tile of ALL S solves in shared memory,
// twice (the level being read, the level being written), through every
// level. A thread walks over the tile's nodes, kThreads apart (neighbouring
// threads on neighbouring addresses), kUnroll nodes at a time; per level it
// loads those nodes' alpha and beta once, together, and applies them to the S
// solves, reading the neighbours at +-s from shared memory. One __syncthreads
// between levels separates reading a level from writing the next. b is read
// and x written once, the coefficients once per tile and level: the per-level
// intermediate never reaches device memory. A launch whose one line of S
// solves does not fit in 227 KB, twice, is refused. Simple first: no
// cp.async, no TMA.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, float32
// (chip_smoke.py phase 30): 64 registers, no spill, three or four blocks per
// SM. 2D finest z lines (74, 5, 761x161) 1.44 ms against a bound of 0.307 ms
// (21%; a tile is 2 lines wide: a 761-node line of 5 solves takes 30 KB
// twice), r lines 0.74 ms against 0.258 ms (35%); 3D (8, 5, 193x17x49) z
// 0.170, p 0.086, r 0.116 ms against 0.037, 0.027, 0.031 ms (22-31%).
// float64 moves twice the bytes in 1.0-1.8x the time: what holds the kernel
// is not the bytes but each level's wait for its coefficients and its
// barrier, with 24-32 warps per SM. Loading the next level's coefficients
// during the current one is the next step.
//
// A term outside the line is dropped, not multiplied by zero, so a solve that
// holds Inf or NaN spreads it only where the plain version does.

#include <climits>

#include <cuda_runtime.h>

#include "slab_stage.cuh"

namespace {

constexpr int kThreads = 256;
// Nodes a thread takes at once: their loads are issued together, so a thread
// waits for device memory once per kUnroll nodes, not once per node.
constexpr int kUnroll = 4;
// Automatic tile: as many lines as fit in kAutoSmemBytes (three blocks per SM),
// at least one line, and no more than leaves kTargetBlocks blocks to the
// launch (about 2.6 waves of three blocks on the 132 SMs of an H100), so that
// a launch of few solves (the power iterations' one vector) fills the card.
constexpr size_t kAutoSmemBytes = 74 * 1024;
constexpr long long kTargetBlocks = 1024;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

struct Tile {
  int TO;         // lines of a tile along outer
  int TI;         // lines of a tile along inner
  int tiles_o;    // tiles along outer
  int tiles_i;    // tiles along inner
  size_t smem;    // dynamic shared memory of a block
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
pcr_lines_kernel(const T* __restrict__ F, const T* __restrict__ b, T* __restrict__ x, int S,
                 int outer, int n, int inner, int L, int TO, int TI, int tiles_o,
                 int tiles_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned int bid = blockIdx.x;
  const int ti = static_cast<int>(bid % tiles_i);
  bid /= tiles_i;
  const int to = static_cast<int>(bid % tiles_o);
  const int batch = static_cast<int>(bid / tiles_o);

  const int o0 = to * TO;
  const int j0 = ti * TI;
  const int wi = min(TI, inner - j0);            // lines of this tile along inner
  const int nodes = min(TO, outer - o0) * n * wi;  // node q: row r = q / wi, column q - r * wi
  const int cap = TO * n * TI;                   // nodes of a full tile: one solve's buffer
  T* cur = reinterpret_cast<T*>(smem_raw);       // [S][cap], the level being read
  T* nxt = cur + static_cast<size_t>(S) * cap;   // [S][cap], the level being written

  const long long N = static_cast<long long>(outer) * n * inner;  // nodes of a plane
  const long long base = static_cast<long long>(o0) * n * inner + j0;
  const T* Fb = F + static_cast<long long>(batch) * (2 * L + 1) * N;
  const T* bb = b + static_cast<long long>(batch) * S * N;
  T* xb = x + static_cast<long long>(batch) * S * N;

  // b: the S * nodes values of the tile, kUnroll loads in flight per thread.
  const int values = S * nodes;
  for (int t0 = threadIdx.x; t0 < values; t0 += kUnroll * kThreads) {
    T v[kUnroll];
    int dst[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kThreads;
      dst[u] = -1;
      if (t < values) {
        const int g = t / nodes;
        const int q = t - g * nodes;
        const int r = q / wi;
        v[u] = __ldg(bb + g * N + base + static_cast<long long>(r) * inner + (q - r * wi));
        dst[u] = g * cap + q;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (dst[u] >= 0) cur[dst[u]] = v[u];
    }
  }
  __syncthreads();

  int step = 1;
  for (int k = 0; k < L && step < n; ++k, step *= 2) {  // a level with s >= n changes nothing
    const T* alpha = Fb + 2LL * k * N;
    const T* beta = alpha + N;
    const int dq = step * wi;  // s lines of the tile's rows apart
    for (int q0 = threadIdx.x; q0 < nodes; q0 += kUnroll * kThreads) {
      T a[kUnroll], c[kUnroll];
      bool lo[kUnroll], hi[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // the coefficients of kUnroll nodes, loaded together
        const int q = q0 + u * kThreads;
        const int r = q / wi;
        const int i = r % n;
        const long long off = base + static_cast<long long>(r) * inner + (q - r * wi);
        lo[u] = q < nodes && i >= step;
        hi[u] = q < nodes && i + step < n;
        a[u] = lo[u] ? __ldg(alpha + off) : T(0);
        c[u] = hi[u] ? __ldg(beta + off) : T(0);
      }
      for (int g = 0; g < S; ++g) {
        // The 3 kUnroll values of this solve first, then the kUnroll sums: the
        // shared-memory loads are in flight together (the compiler cannot move
        // a load of cur above a store to nxt, which may alias it).
        const T* xg = cur + g * cap;
        T x0[kUnroll], xm[kUnroll], xp[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + u * kThreads;
          x0[u] = q < nodes ? xg[q] : T(0);
          xm[u] = lo[u] ? xg[q - dq] : T(0);
          xp[u] = hi[u] ? xg[q + dq] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + u * kThreads;
          T v = x0[u];
          if (lo[u]) v = add_rn(v, mul_rn(a[u], xm[u]));
          if (hi[u]) v = add_rn(v, mul_rn(c[u], xp[u]));
          if (q < nodes) nxt[g * cap + q] = v;
        }
      }
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }

  const T* dinv = Fb + 2LL * L * N;
  for (int q0 = threadIdx.x; q0 < nodes; q0 += kUnroll * kThreads) {
    T d[kUnroll];
    long long off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kThreads;
      const int r = q / wi;
      off[u] = base + static_cast<long long>(r) * inner + (q - r * wi);
      d[u] = q < nodes ? __ldg(dinv + off[u]) : T(0);
    }
    for (int g = 0; g < S; ++g) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * kThreads;
        v[u] = q < nodes ? cur[g * cap + q] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u * kThreads < nodes) xb[g * N + off[u]] = mul_rn(v[u], d[u]);
      }
    }
  }
}

// false if one line of the S solves does not fit in a block's shared memory.
template <typename T>
bool choose_tile(int B, int S, int outer, int n, int inner, Tile& t) {
  auto bytes = [=](long long lines) {
    return 2 * sizeof(T) * static_cast<size_t>(S) * static_cast<size_t>(lines) * n;
  };
  if (bytes(1) > slab::kMaxSmemBytes) return false;
  long long lines = static_cast<long long>(kAutoSmemBytes / bytes(1));
  const long long spread =
      (static_cast<long long>(B) * outer * inner + kTargetBlocks - 1) / kTargetBlocks;
  if (lines > spread) lines = spread;
  if (lines < 1) lines = 1;
  int TO = 1, TI = 1;
  if (inner == 1) {
    TO = static_cast<int>(lines < outer ? lines : outer);
  } else if (lines >= inner) {
    TI = inner;
    const long long to = lines / inner;
    TO = static_cast<int>(to < outer ? to : outer);
  } else {
    TI = static_cast<int>(lines);
  }
  // Even tiles: the fewest tiles of at most TO / TI lines, each as wide as needed.
  t.tiles_o = (outer + TO - 1) / TO;
  t.TO = (outer + t.tiles_o - 1) / t.tiles_o;
  t.tiles_i = (inner + TI - 1) / TI;
  t.TI = (inner + t.tiles_i - 1) / t.tiles_i;
  t.smem = bytes(static_cast<long long>(t.TO) * t.TI);
  return true;
}

template <typename T>
int launch(const void* F, const void* b, void* x, int B, int S, int outer, int n, int inner,
           int L, void* stream) {
  if (B <= 0 || S <= 0 || outer <= 0 || n <= 0 || inner <= 0 || L <= 0 || L > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tile t;
  if (!choose_tile<T>(B, S, outer, n, inner, t)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * t.tiles_o * t.tiles_i;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = slab::allow_smem(pcr_lines_kernel<T>, t.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pcr_lines_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, t.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(b), static_cast<T*>(x), S, outer, n, inner,
      L, t.TO, t.TI, t.tiles_o, t.tiles_i);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(int B, int S, int outer, int n, int inner, int* out) {
  Tile t;
  if (B <= 0 || S <= 0 || outer <= 0 || n <= 0 || inner <= 0 ||
      !choose_tile<T>(B, S, outer, n, inner, t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  slab::Tile st;
  st.TZ = t.TO * t.TI;  // lines per tile
  st.G = S;
  st.smem = t.smem;
  return slab::kernel_info(pcr_lines_kernel<T>, kThreads, st, out);
}

}  // namespace

extern "C" int pcr_lines_f32(const void* F, const void* b, void* x, int B, int S, int outer,
                             int n, int inner, int L, void* stream) {
  return launch<float>(F, b, x, B, S, outer, n, inner, L, stream);
}

extern "C" int pcr_lines_f64(const void* F, const void* b, void* x, int B, int S, int outer,
                             int n, int inner, int L, void* stream) {
  return launch<double>(F, b, x, B, S, outer, n, inner, L, stream);
}

// What a launch of B batches of S solves on lines (outer, n, inner) would use
// (slab::kernel_info; its tile height is the lines per tile).
extern "C" int pcr_lines_info_f32(int B, int S, int outer, int n, int inner, int* out) {
  return info<float>(B, S, outer, n, inner, out);
}

extern "C" int pcr_lines_info_f64(int B, int S, int outer, int n, int inner, int* out) {
  return info<double>(B, S, outer, n, inner, out);
}
