// Symmetric half-storage 27-point stencil apply, y = A u, for Hopper (sm_90a).
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
// coupling) is the plain version's.
//
// Bound: device-memory bytes. About two flops per value moved; the least
// traffic is the 14 coefficient planes once per batch plus u read and y written
// once per solve, 4*N*B*(14 + 2S) bytes per apply for N = NZ*NP*NR in float32
// (twice that in float64).
//
// Design: one thread per (batch, node), nodes flattened with NR fastest so a
// warp reads consecutive addresses. Each thread loads its 27 coefficients once
// (the diagonal, C_d(n) and the mirrored C_d(n-d)) into registers, then loops
// over the S solves of its batch: the coefficient planes come from device
// memory once per batch, not once per solve, which is what the Pallas grid's
// solve-innermost order achieved with a VMEM-resident block. The 26 neighbour
// reads of u hit the rows that adjacent threads and blocks read (L1/L2). No
// shared memory, so any grid size fits in both dtypes; no padding; every index
// stays below 2^31 (the wrapper checks B*S*N and B*14*N).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOffsets = 13;

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
__global__ void __launch_bounds__(kThreads)
stencil3d_half_kernel(const T* __restrict__ C, const T* __restrict__ u,
                      T* __restrict__ y, int S, int NZ, int NP, int NR) {
  const int N = NZ * NP * NR;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const int plane_pr = NP * NR;
  const int z = n / plane_pr;
  const int rem = n - z * plane_pr;
  const int p = rem / NR;
  const int r = rem - p * NR;

  const T* Cb = C + static_cast<long long>(b) * 14 * N;
  const T c0 = __ldg(Cb + n);
  T cp[kOffsets];
  T cm[kOffsets];
  int off[kOffsets];
  unsigned int plus_ok = 0u, minus_ok = 0u;
#pragma unroll
  for (int k = 0; k < kOffsets; ++k) {
    int dz, dp, dr;
    offset_of(k, dz, dp, dr);
    off[k] = dz * plane_pr + dp * NR + dr;
    const T* ck = Cb + static_cast<long long>(k + 1) * N;
    const bool up = (z + dz < NZ) && (p + dp >= 0) && (p + dp < NP) && (r + dr >= 0) &&
                    (r + dr < NR);
    const bool dn = (z - dz >= 0) && (p - dp >= 0) && (p - dp < NP) && (r - dr >= 0) &&
                    (r - dr < NR);
    cp[k] = up ? __ldg(ck + n) : T(0);
    cm[k] = dn ? __ldg(ck + n - off[k]) : T(0);
    plus_ok |= (up ? 1u : 0u) << k;
    minus_ok |= (dn ? 1u : 0u) << k;
  }

  for (int s = 0; s < S; ++s) {
    const long long base = (static_cast<long long>(b) * S + s) * N;
    const T* us = u + base;
    T acc = c0 * __ldg(us + n);
#pragma unroll
    for (int k = 0; k < kOffsets; ++k) {
      if (plus_ok & (1u << k)) acc += cp[k] * __ldg(us + n + off[k]);
      if (minus_ok & (1u << k)) acc += cm[k] * __ldg(us + n - off[k]);
    }
    y[base + n] = acc;
  }
}

template <typename T>
int launch(const void* C, const void* u, void* y, int B, int S, int NZ, int NP, int NR,
           void* stream) {
  if (B <= 0 || S <= 0 || NZ <= 0 || NP <= 0 || NR <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long N = static_cast<long long>(NZ) * NP * NR;
  if (N * 14 * B >= (1LL << 31) || N * S * B >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned int>((N + kThreads - 1) / kThreads), B);
  stencil3d_half_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(C), static_cast<const T*>(u), static_cast<T*>(y), S, NZ, NP, NR);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil3d_half_f32(const void* C, const void* u, void* y, int B, int S,
                                  int NZ, int NP, int NR, void* stream) {
  return launch<float>(C, u, y, B, S, NZ, NP, NR, stream);
}

extern "C" int stencil3d_half_f64(const void* C, const void* u, void* y, int B, int S,
                                  int NZ, int NP, int NR, void* stream) {
  return launch<double>(C, u, y, B, S, NZ, NP, NR, stream);
}
