// Symmetric half-storage 9-point stencil apply, y = A u, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel remo3d_tpu/ops/pallas_stencil2d.py
// (stencil_apply_pallas_2d, body _kernel2d): the CG matvec and the multigrid
// operator on the two finest levels of the 2D axisymmetric solve.
//
// Storage: C_half (B, 5, NZ, NR) holds the row sum R of the operator and the
// four positive offsets d = (0,1), (1,-1), (1,0), (1,1) (remo3d_tpu_torch.
// kernels.stencil2d.half_planes_2d); u and y are (B, S, NZ, NR). The FEM
// stencil is symmetric, C_d(n) == C_{-d}(n+d), so each offset plane serves two
// couplings. Gather form in differences, no atomics:
//
//   y(n) = R(n) u(n) + sum_d [ C_d(n) (u(n+d) - u(n)) + C_d(n-d) (u(n-d) - u(n)) ]
//
// with every coupling present only where its neighbour lies inside the grid.
// It is the diagonal form C0 u(n) + sum_d [C_d(n) u(n+d) + C_d(n-d) u(n-d)]
// with C0 = R - (the couplings), but rounds at eps |C_d| |u(n+d) - u(n)|
// instead of eps |C0| |u|: R vanishes away from the Dirichlet nodes and u is
// smooth, so the diagonal form cancels most of each row (kernels/stencil2d.py).
//
// Bound: device-memory bytes. Three flops per 4-byte coefficient or solution
// value; the least traffic is the 5 coefficient planes once per batch plus u
// read and y written once per solve, about 4*N*B*(5 + 2S) bytes per apply for
// N = NZ*NR in float32 (twice that in float64).
//
// Design (the 2D case of stencil3d.cu's). A block owns a tile of TZ whole rows
// of one batch. Rows are contiguous, so the u it needs for one solve (rows
// z0-1 .. z0+TZ) is one contiguous run; the block stages that run for ALL S
// solves of the batch in shared memory with cp.async (slab_stage.cuh says how
// the unaligned start is handled), zero-filling the halo row that lies outside
// the grid and a small margin around the tile. Then each thread walks over the
// tile's nodes, 256 apart: it loads the node's 9 coefficients (the row sum,
// C_d(n) and the mirrored C_d(n-d), zero where the neighbour is outside the
// grid) into registers once and loops over the S solves, reading the 9 values
// of u from shared memory. The coefficient planes leave device memory once per
// batch (the mirrored ones are the neighbours' own values, in L1), u once per
// tile that needs it ((TZ+2)/TZ times, the halo rows from L2); the node loop
// divides nothing and has no barrier and no mask. Copy and arithmetic overlap
// across the blocks that share an SM. Where S tiles do not fit in 227 KB the
// solves are taken in groups of G < S.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, at
// (B, S, NZ, NR) = (96, 5, 761, 161) in float32 (chip_smoke.py phases 2-3):
// 63 registers, no spill, TZ = 12 with 45,360 B of shared memory and four
// resident blocks per SM, 0.301 ms per apply against a bound of 0.211 ms (the
// diagonal form took 0.290 ms).
//
// The masked terms multiply a zero coefficient with whatever finite value the
// tile holds at that offset, so a solve whose u holds Inf or NaN comes out NaN
// where the plain version would keep some nodes finite. Solves never mix.

#include <cuda_runtime.h>

#include "slab_stage.cuh"

namespace {

constexpr int kThreads = 256;
// Automatic tile height: the largest TZ up to kAutoMaxTZ whose shared memory
// stays below kAutoSmemBytes, so that four blocks share an SM. Measured at
// (96, 5, 761, 161) float32 on an H100 (chip_smoke.py --tune): TZ = 8 and 12
// with four resident blocks are the fastest, 16-20 (three blocks) 5% slower,
// 24-32 (two blocks) 20% slower.
constexpr int kAutoMaxTZ = 12;
constexpr size_t kAutoSmemBytes = 55 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
stencil2d_half_kernel(const T* __restrict__ C, const T* __restrict__ u,
                      T* __restrict__ y, int S, int NZ, int NR, int TZ, int G, int stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ubuf = reinterpret_cast<T*>(smem_raw);  // [G][stride]: rows z0-1 .. z0+TZ per solve

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int z0 = blockIdx.x * TZ;
  const int N = NZ * NR;
  const int rows = min(TZ, NZ - z0);
  // Staged rows lz = 0 .. TZ+1 stand for z = z0-1+lz; those inside the grid:
  const int lz_lo = z0 == 0 ? 1 : 0;
  const int lz_hi = min(TZ + 1, NZ - z0);
  // A corner node reads one element beyond its rows.
  const int margin = slab::margin_elems<T>(1);
  const T* Cb = C + static_cast<long long>(b) * 5 * N;
  // Element offset of row lz = 0 of solve 0 of this batch, modulo 2^32.
  const unsigned int first0 = static_cast<unsigned int>(b * S) * static_cast<unsigned int>(N) +
                              static_cast<unsigned int>((z0 - 1) * NR);

  // Steps of the node loop, so that it divides nothing.
  const int dq = kThreads / NR;
  const int dm = kThreads - dq * NR;

  const int dzs[4] = {0, 1, 1, 1};
  const int drs[4] = {1, -1, 0, 1};

  for (int s0 = 0; s0 < S; s0 += G) {
    const int Gc = min(G, S - s0);
    if (s0 > 0) __syncthreads();  // the previous group's buffers are read no more

    for (int g = 0; g < Gc; ++g) {
      const unsigned int first = first0 + static_cast<unsigned int>(s0 + g) * N;
      T* buf = ubuf + g * stride;
      T* ub = buf + margin + slab::shift(u, first);  // row lz = 0
      const T* src = u + (static_cast<long long>(b) * S + s0 + g) * N +
                     static_cast<long long>(z0 - 1) * NR;
      T* filled_end = ub + (lz_hi + 1) * NR;
      slab::zero_run(buf, static_cast<int>(ub + lz_lo * NR - buf), tid, kThreads);
      slab::zero_run(filled_end, static_cast<int>(buf + stride - filled_end), tid, kThreads);
      slab::stage_run(ub + lz_lo * NR, src + lz_lo * NR, (lz_hi - lz_lo + 1) * NR, tid,
                      kThreads);
    }
    slab::cp_async_commit();
    slab::cp_async_wait_group<0>();
    __syncthreads();

    int lz = tid / NR;
    int r = tid - lz * NR;
    while (lz < rows) {
      const int z = z0 + lz;
      const int n = z * NR + r;
      const T c0 = __ldg(Cb + n);
      T cp[4];
      T cm[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dz = dzs[k], dr = drs[k];
        const int off = dz * NR + dr;
        const T* ck = Cb + static_cast<long long>(k + 1) * N;
        const bool up = (z + dz < NZ) && (r + dr >= 0) && (r + dr < NR);
        const bool dn = (z - dz >= 0) && (r - dr >= 0) && (r - dr < NR);
        cp[k] = up ? __ldg(ck + n) : T(0);
        cm[k] = dn ? __ldg(ck + n - off) : T(0);
      }

      for (int g = 0; g < Gc; ++g) {
        const unsigned int first = first0 + static_cast<unsigned int>(s0 + g) * N;
        const T* un =
            ubuf + g * stride + margin + slab::shift(u, first) + (lz + 1) * NR + r;
        const T u0 = un[0];
        T acc = c0 * u0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int off = dzs[k] * NR + drs[k];
          acc += cp[k] * (un[off] - u0);
          acc += cm[k] * (un[-off] - u0);
        }
        y[(static_cast<long long>(b) * S + s0 + g) * N + n] = acc;
      }

      lz += dq;
      r += dm;
      if (r >= NR) { r -= NR; ++lz; }
    }
  }
}

template <typename T>
int stride_of(int tz, int NR) {
  return slab::buffer_stride<T>(tz, NR, slab::margin_elems<T>(1));
}

// false if one solve's three rows do not fit in a block's shared memory.
template <typename T>
bool choose_tile(int S, int NR, int tile_rows, slab::Tile& t) {
  auto bytes = [=](int tz, int g) {
    return sizeof(T) * static_cast<size_t>(g) * stride_of<T>(tz, NR);
  };
  return slab::choose_tile(S, tile_rows, kAutoMaxTZ, kAutoSmemBytes, bytes, t);
}

template <typename T>
int launch(const void* C, const void* u, void* y, int B, int S, int NZ, int NR,
           int tile_rows, void* stream) {
  if (B <= 0 || S <= 0 || NZ <= 0 || NR <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(NZ) * NR >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  slab::Tile t;
  if (!choose_tile<T>(S, NR, tile_rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = slab::allow_smem(stencil2d_half_kernel<T>, t.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((NZ + t.TZ - 1) / t.TZ, B);
  stencil2d_half_kernel<T><<<grid, kThreads, t.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(C), static_cast<const T*>(u), static_cast<T*>(y), S, NZ, NR, t.TZ,
      t.G, stride_of<T>(t.TZ, NR));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(int S, int NR, int tile_rows, int* out) {
  slab::Tile t;
  if (S <= 0 || NR <= 0 || !choose_tile<T>(S, NR, tile_rows, t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return slab::kernel_info(stencil2d_half_kernel<T>, kThreads, t, out);
}

}  // namespace

extern "C" int stencil2d_half_f32(const void* C, const void* u, void* y, int B, int S,
                                  int NZ, int NR, int tile_rows, void* stream) {
  return launch<float>(C, u, y, B, S, NZ, NR, tile_rows, stream);
}

extern "C" int stencil2d_half_f64(const void* C, const void* u, void* y, int B, int S,
                                  int NZ, int NR, int tile_rows, void* stream) {
  return launch<double>(C, u, y, B, S, NZ, NR, tile_rows, stream);
}

// What a launch with S solves on rows of NR nodes and this tile_rows would use
// (slab::kernel_info).
extern "C" int stencil2d_half_info_f32(int S, int NR, int tile_rows, int* out) {
  return info<float>(S, NR, tile_rows, out);
}

extern "C" int stencil2d_half_info_f64(int S, int NR, int tile_rows, int* out) {
  return info<double>(S, NR, tile_rows, out);
}
