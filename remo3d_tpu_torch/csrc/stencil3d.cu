// Symmetric half-storage 27-point stencil apply, y = A u or y = P A P u, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel remo3d_tpu/ops/pallas_stencil.py
// (stencil3d_apply_pallas, body _kernel): the operator of the 3D dipping-layer
// solve, applied once per CG iteration as the matvec and four more times inside
// every damped z-p-r-p-z ADI preconditioner sweep.
//
// Storage: C_half (B, 14, NZ, NP, NR) holds the diagonal and the 13
// lexicographically positive offsets d = (dz, dp, dr) > (0, 0, 0)
// (remo3d_tpu_torch.kernels.stencil3d.half_planes_3d); u and y are
// (B, S, NZ, NP, NR). The FEM stencil is symmetric, C_d(n) == C_{-d}(n+d), so
// each offset plane serves two couplings. Gather form, no atomics:
//
//   y(n) = C0(n) u(n) + sum_d [ C_d(n) u(n+d) + C_d(n-d) u(n-d) ]
//
// with every term present only where its neighbour lies inside the grid. The
// order of the sum (diagonal, then per offset the direct and the mirrored
// coupling) is the plain version's. With `pole` the kernel computes P A P u,
// where P (remo3d_tpu_torch.ops.stencil3d.pole_project) replaces the r = 0
// entries of every (z, :) ring by their mean over the NP azimuth copies: the
// tie that wraps the operator in the pole-tied CG.
//
// Bound: device-memory bytes. About two flops per value moved; the least
// traffic is the 14 coefficient planes once per batch plus u read and y written
// once per solve, 4*N*B*(14 + 2S) bytes per apply for N = NZ*NP*NR in float32
// (twice that in float64).
//
// Design. A block owns a slab of TZ whole (NP, NR) planes of one batch. Because
// the tile is whole planes, the u it needs for one solve (planes z0-1 .. z0+TZ)
// is one contiguous run of device memory; the block stages that run for ALL S
// solves of the batch in shared memory with cp.async (slab_stage.cuh says how
// the unaligned start is handled), zero-filling the halo plane that lies
// outside the grid and a margin of one ring before and after the slab. Then
// each thread walks over the slab's nodes, 256 apart:
// it loads the node's 27 coefficients (the diagonal, C_d(n) and the mirrored
// C_d(n-d), zero where the neighbour is outside the grid) into registers once
// and loops over the S solves, reading all 27 values of u from shared memory
// at offsets that are the same for every node. So the coefficient planes leave
// device memory once per batch, every u value leaves it once per slab that
// needs it ((TZ+2)/TZ times, the halo from L2), and the inner loop has no
// global load, no mask and no barrier.
//
// Why all S solves at once and not a double buffer over S: a slab of TZ = 4
// planes of 17 x 49 has 13 nodes per thread, and 13 x 27 coefficients do not
// fit in registers. Coefficients can only stay in registers across the S loop
// if the node loop is outside it, and that needs every solve's slab resident.
// Copy and arithmetic overlap across the 2-3 blocks that share an SM. Where S
// slabs do not fit in 227 KB (large planes in float64), the solves are taken in
// groups of G < S, and the coefficients are read once per group.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, at
// (B, S, NZ, NP, NR) = (8, 5, 193, 17, 49) in float32 (chip_smoke.py --tune and
// --probe): 80 registers, no spill, TZ = 2 with 69,480 B of shared memory and
// three resident blocks per SM, 0.088 ms per apply against a bound of 0.037 ms;
// TZ = 1 and 3 are within 3% of it, TZ = 4 (two blocks) 14% slower. The probe
// builds say where the time goes: without the 13 mirrored coefficient loads
// 0.063 ms, without any coefficient load 0.050 ms, with all loads but without
// the sum over shared memory 0.080 ms. So the 27 global loads per node, the 9
// mirrored ones of the plane below most of all (they miss L1 and come from L2
// as unaligned 128-byte requests), set the time, not the arithmetic.
//
// The masked terms multiply a zero coefficient with whatever finite value the
// slab holds at that offset (another node's u, or the zero-filled halo); a
// solve whose u holds Inf or NaN comes out NaN where the plain version would
// keep some nodes finite. Solves never mix: each has its own buffer.
//
// The pole tie works on the staged data: after the slabs have arrived, one
// thread per (solve, plane) replaces the r = 0 entries in shared memory by
// their mean (halo planes too, so u in device memory is not modified); the
// r = 0 outputs go to a small shared array instead of y, are averaged per
// (solve, plane) after the node loop and stored to all NP copies. The means
// are sequential sums over NP, not torch.mean's order.

#include <cuda_runtime.h>

#include "slab_stage.cuh"

// Probe builds (chip_smoke.py --probe) answer what the kernel's time is spent
// on; their results are wrong on purpose. 0: the kernel. 1: the 13 mirrored
// coefficients are not loaded (the direct ones stand in). 2: no coefficient is
// loaded at all (constants). 3: coefficients are loaded, but the 27-term sum
// over shared memory is replaced by one term.
#ifndef REMO3D_K2_PROBE
#define REMO3D_K2_PROBE 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kOffsets = 13;
// Automatic tile height: the largest TZ up to kAutoMaxTZ whose shared memory
// stays below kAutoSmemBytes, so that three blocks share an SM.
constexpr int kAutoMaxTZ = 4;
constexpr size_t kAutoSmemBytes = 74 * 1024;

// Positive offset k of the half planes 1..13 (lexicographic): (0,0,1),
// (0,1,-1), (0,1,0), (0,1,1), then (1,dp,dr) for dp, dr in -1..1. Called with
// unrolled k, so it folds to constants.
__device__ __forceinline__ void offset_of(int k, int& dz, int& dp, int& dr) {
  if (k == 0) {
    dz = 0; dp = 0; dr = 1;
  } else if (k < 4) {
    dz = 0; dp = 1; dr = k - 2;
  } else {
    dz = 1; dp = (k - 4) / 3 - 1; dr = (k - 4) % 3 - 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
stencil3d_half_kernel(const T* __restrict__ C, const T* __restrict__ u,
                      T* __restrict__ y, int S, int NZ, int NP, int NR, int TZ, int G,
                      int stride, int pole) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ubuf = reinterpret_cast<T*>(smem_raw);  // [G][stride]: planes z0-1 .. z0+TZ per solve
  T* ybuf = ubuf + G * stride;               // [G][TZ][NP]: r = 0 outputs (pole only)

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int z0 = blockIdx.x * TZ;
  const int P = NP * NR;
  const int N = NZ * P;
  const int rows = min(TZ, NZ - z0);
  // Staged planes lz = 0 .. TZ+1 stand for z = z0-1+lz; those inside the grid:
  const int lz_lo = z0 == 0 ? 1 : 0;
  const int lz_hi = min(TZ + 1, NZ - z0);
  // A corner node reads up to one ring and one station beyond its planes.
  const int margin = slab::margin_elems<T>(NR + 1);
  const T* Cb = C + static_cast<long long>(b) * 14 * N;
  // Element offset of plane lz = 0 of solve 0 of this batch, modulo 2^32.
  const unsigned int first0 = static_cast<unsigned int>(b * S) * static_cast<unsigned int>(N) +
                              static_cast<unsigned int>((z0 - 1) * P);

  // Steps of the node loop, so that it divides nothing: 256 nodes further is
  // dq planes, dp_step rings and dr_step stations further.
  const int dq = kThreads / P;
  const int dm = kThreads - dq * P;
  const int dp_step = dm / NR;
  const int dr_step = dm - dp_step * NR;

  for (int s0 = 0; s0 < S; s0 += G) {
    const int Gc = min(G, S - s0);
    if (s0 > 0) __syncthreads();  // the previous group's buffers are read no more

    for (int g = 0; g < Gc; ++g) {
      const unsigned int first = first0 + static_cast<unsigned int>(s0 + g) * N;
      T* buf = ubuf + g * stride;
      T* ub = buf + margin + slab::shift(u, first);  // plane lz = 0
      const T* src = u + (static_cast<long long>(b) * S + s0 + g) * N +
                     static_cast<long long>(z0 - 1) * P;
      T* filled_end = ub + (lz_hi + 1) * P;
      slab::zero_run(buf, static_cast<int>(ub + lz_lo * P - buf), tid, kThreads);
      slab::zero_run(filled_end, static_cast<int>(buf + stride - filled_end), tid, kThreads);
      slab::stage_run(ub + lz_lo * P, src + lz_lo * P, (lz_hi - lz_lo + 1) * P, tid, kThreads);
    }
    slab::cp_async_commit();
    slab::cp_async_wait_group<0>();
    __syncthreads();

    if (pole) {
      for (int item = tid; item < Gc * (TZ + 2); item += kThreads) {
        const int g = item / (TZ + 2);
        const int lz = item - g * (TZ + 2);
        const unsigned int first = first0 + static_cast<unsigned int>(s0 + g) * N;
        T* ring = ubuf + g * stride + margin + slab::shift(u, first) + lz * P;
        T sum = T(0);
        for (int p = 0; p < NP; ++p) sum += ring[p * NR];
        const T mean = sum / static_cast<T>(NP);
        for (int p = 0; p < NP; ++p) ring[p * NR] = mean;
      }
      __syncthreads();
    }

    // (lz, p, r) of this thread's first node; rem = p * NR + r.
    int lz = tid / P;
    int rem = tid - lz * P;
    int p = rem / NR;
    int r = rem - p * NR;
    while (lz < rows) {
      const int z = z0 + lz;
      const int n = z * P + rem;
      const T c0 = REMO3D_K2_PROBE == 2 ? T(2) : __ldg(Cb + n);
      T cp[kOffsets];
      T cm[kOffsets];
#pragma unroll
      for (int k = 0; k < kOffsets; ++k) {
        int dz, dp, dr;
        offset_of(k, dz, dp, dr);
        const int off = dz * P + dp * NR + dr;
        const T* ck = Cb + static_cast<long long>(k + 1) * N;
        const bool up = (z + dz < NZ) && (p + dp >= 0) && (p + dp < NP) && (r + dr >= 0) &&
                        (r + dr < NR);
        const bool dn = (z - dz >= 0) && (p - dp >= 0) && (p - dp < NP) && (r - dr >= 0) &&
                        (r - dr < NR);
        if (REMO3D_K2_PROBE == 2) {
          cp[k] = up ? T(0.5) : T(0);
          cm[k] = dn ? T(0.25) : T(0);
        } else {
          cp[k] = up ? __ldg(ck + n) : T(0);
          cm[k] = !dn ? T(0) : REMO3D_K2_PROBE == 1 ? cp[k] : __ldg(ck + n - off);
        }
      }

      const bool tied = pole && r == 0;
      for (int g = 0; g < Gc; ++g) {
        const unsigned int first = first0 + static_cast<unsigned int>(s0 + g) * N;
        const T* un =
            ubuf + g * stride + margin + slab::shift(u, first) + (lz + 1) * P + rem;
        T acc = c0 * un[0];
#pragma unroll
        for (int k = 0; k < kOffsets; ++k) {
          int dz, dp, dr;
          offset_of(k, dz, dp, dr);
          const int off = dz * P + dp * NR + dr;
          if (REMO3D_K2_PROBE == 3) {
            acc += cp[k] + cm[k];
          } else {
            acc += cp[k] * un[off];
            acc += cm[k] * un[-off];
          }
        }
        if (tied) {
          ybuf[(g * TZ + lz) * NP + p] = acc;
        } else {
          y[(static_cast<long long>(b) * S + s0 + g) * N + n] = acc;
        }
      }

      lz += dq;
      p += dp_step;
      r += dr_step;
      if (r >= NR) { r -= NR; ++p; }
      rem = p * NR + r;
      if (rem >= P) { rem -= P; p -= NP; ++lz; }
    }

    if (pole) {
      __syncthreads();
      for (int item = tid; item < Gc * rows; item += kThreads) {
        const int g = item / rows;
        const int lz = item - g * rows;
        const T* yb = ybuf + (g * TZ + lz) * NP;
        T sum = T(0);
        for (int p = 0; p < NP; ++p) sum += yb[p];
        const T mean = sum / static_cast<T>(NP);
        T* ring = y + (static_cast<long long>(b) * S + s0 + g) * N +
                  static_cast<long long>(z0 + lz) * P;
        for (int p = 0; p < NP; ++p) ring[p * NR] = mean;
      }
    }
  }
}

template <typename T>
int stride_of(int tz, int NP, int NR) {
  return slab::buffer_stride<T>(tz, NP * NR, slab::margin_elems<T>(NR + 1));
}

// false if one solve's three planes do not fit in a block's shared memory.
template <typename T>
bool choose_tile(int S, int NP, int NR, int tile_rows, slab::Tile& t) {
  auto bytes = [=](int tz, int g) {
    return sizeof(T) * static_cast<size_t>(g) * (stride_of<T>(tz, NP, NR) + tz * NP);
  };
  return slab::choose_tile(S, tile_rows, kAutoMaxTZ, kAutoSmemBytes, bytes, t);
}

template <typename T>
int launch(const void* C, const void* u, void* y, int B, int S, int NZ, int NP, int NR,
           int pole, int tile_rows, void* stream) {
  if (B <= 0 || S <= 0 || NZ <= 0 || NP <= 0 || NR <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long N = static_cast<long long>(NZ) * NP * NR;
  if (N * 14 * B >= (1LL << 31) || N * S * B >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  slab::Tile t;
  if (!choose_tile<T>(S, NP, NR, tile_rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = slab::allow_smem(stencil3d_half_kernel<T>, t.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((NZ + t.TZ - 1) / t.TZ, B);
  stencil3d_half_kernel<T><<<grid, kThreads, t.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(C), static_cast<const T*>(u), static_cast<T*>(y), S, NZ, NP, NR,
      t.TZ, t.G, stride_of<T>(t.TZ, NP, NR), pole);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(int S, int NP, int NR, int tile_rows, int* out) {
  slab::Tile t;
  if (S <= 0 || NP <= 0 || NR <= 0 || !choose_tile<T>(S, NP, NR, tile_rows, t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return slab::kernel_info(stencil3d_half_kernel<T>, kThreads, t, out);
}

}  // namespace

extern "C" int stencil3d_half_f32(const void* C, const void* u, void* y, int B, int S,
                                  int NZ, int NP, int NR, int pole, int tile_rows,
                                  void* stream) {
  return launch<float>(C, u, y, B, S, NZ, NP, NR, pole, tile_rows, stream);
}

extern "C" int stencil3d_half_f64(const void* C, const void* u, void* y, int B, int S,
                                  int NZ, int NP, int NR, int pole, int tile_rows,
                                  void* stream) {
  return launch<double>(C, u, y, B, S, NZ, NP, NR, pole, tile_rows, stream);
}

// What a launch with S solves on (NP, NR) planes and this tile_rows would use
// (slab::kernel_info).
extern "C" int stencil3d_half_info_f32(int S, int NP, int NR, int tile_rows, int* out) {
  return info<float>(S, NP, NR, tile_rows, out);
}

extern "C" int stencil3d_half_info_f64(int S, int NP, int NR, int tile_rows, int* out) {
  return info<double>(S, NP, NR, tile_rows, out);
}
