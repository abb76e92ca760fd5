// Symmetric half-storage 9-point stencil apply, y = A u, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel remo3d_tpu/ops/pallas_stencil2d.py
// (stencil_apply_pallas_2d, body _kernel2d): the CG matvec and the multigrid
// operator on the two finest levels of the 2D axisymmetric solve.
//
// Storage: C_half (B, 5, NZ, NR) holds the diagonal and the four positive
// offsets d = (0,1), (1,-1), (1,0), (1,1) (remo3d_tpu_torch.kernels.stencil2d.
// half_planes_2d); u and y are (B, S, NZ, NR). The FEM stencil is symmetric,
// C_d(n) == C_{-d}(n+d), so each offset plane serves two couplings. Gather form,
// no atomics:
//
//   y(n) = C0(n) u(n) + sum_d [ C_d(n) u(n+d) + C_d(n-d) u(n-d) ]
//
// with every term present only where its neighbour lies inside the grid.
//
// Bound: device-memory bytes. Two flops per 4-byte coefficient or solution
// value; the least traffic is the 5 coefficient planes once per batch plus u
// read and y written once per solve, about 4*N*B*(5 + 2S) bytes per apply for
// N = NZ*NR in float32 (twice that in float64).
//
// Design: one block per (batch, z-tile of TZ rows). It stages the tile's 5
// coefficient rows plus one halo row above (the mirrored terms of the dz = 1
// offsets read C_d at row z-1) in shared memory once, then loops over the S
// solves of the batch. So the coefficients are read from device memory once per
// batch rather than S times, the Hopper analogue of the Pallas grid whose
// coefficient block stays resident across the inner solve axis. u is read
// through the read-only cache; its three rows per output row are reused from
// L1/L2. There is no lane padding and no roll: each thread masks its own edges.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 8;
// Leave headroom under the 227 KB a block may opt into.
constexpr size_t kMaxSmemBytes = 200 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil2d_half_kernel(const T* __restrict__ C, const T* __restrict__ u,
                      T* __restrict__ y, int S, int NZ, int NR, int TZ) {
  extern __shared__ unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // [5][TZ + 1][NR], row 0 = halo z0-1

  const int b = blockIdx.y;
  const int z0 = blockIdx.x * TZ;
  const int rows = min(TZ, NZ - z0);
  const long long plane = static_cast<long long>(NZ) * NR;
  const T* Cb = C + static_cast<long long>(b) * 5 * plane;

  // Stage coefficient rows z0-1 .. z0+rows-1 (halo row is zero above the grid).
  const int tile = (rows + 1) * NR;
  for (int k = 0; k < 5; ++k) {
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int lz = i / NR;
      const int r = i - lz * NR;
      const int z = z0 - 1 + lz;
      cs[(k * (TZ + 1) + lz) * NR + r] =
          (z >= 0) ? __ldg(Cb + k * plane + static_cast<long long>(z) * NR + r) : T(0);
    }
  }
  __syncthreads();

  const int dzs[4] = {0, 1, 1, 1};
  const int drs[4] = {1, -1, 0, 1};
  const int outs = rows * NR;
  for (int s = 0; s < S; ++s) {
    const long long base = (static_cast<long long>(b) * S + s) * plane;
    const T* us = u + base;
    T* ys = y + base;
    for (int i = threadIdx.x; i < outs; i += blockDim.x) {
      const int lz = i / NR;
      const int r = i - lz * NR;
      const int z = z0 + lz;
      T acc = cs[(lz + 1) * NR + r] * __ldg(us + static_cast<long long>(z) * NR + r);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dz = dzs[k];
        const int dr = drs[k];
        const T* ck = cs + (k + 1) * (TZ + 1) * NR;
        // Direct coupling: C_d(n) u(n+d).
        const int zp = z + dz, rp = r + dr;
        if (zp < NZ && rp >= 0 && rp < NR) {
          acc += ck[(lz + 1) * NR + r] * __ldg(us + static_cast<long long>(zp) * NR + rp);
        }
        // Mirrored coupling: C_d(n-d) u(n-d).
        const int zm = z - dz, rm = r - dr;
        if (zm >= 0 && rm >= 0 && rm < NR) {
          acc += ck[(lz + 1 - dz) * NR + rm] * __ldg(us + static_cast<long long>(zm) * NR + rm);
        }
      }
      ys[static_cast<long long>(z) * NR + r] = acc;
    }
  }
}

template <typename T>
int launch(const void* C, const void* u, void* y, int B, int S, int NZ, int NR,
           void* stream) {
  if (B <= 0 || S <= 0 || NZ <= 0 || NR <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int TZ = kMaxTileRows < NZ ? kMaxTileRows : NZ;
  size_t smem = sizeof(T) * 5 * static_cast<size_t>(TZ + 1) * NR;
  while (smem > kMaxSmemBytes && TZ > 1) {
    --TZ;
    smem = sizeof(T) * 5 * static_cast<size_t>(TZ + 1) * NR;
  }
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stencil2d_half_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((NZ + TZ - 1) / TZ, B);
  stencil2d_half_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(C), static_cast<const T*>(u), static_cast<T*>(y), S, NZ, NR, TZ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stencil2d_half_f32(const void* C, const void* u, void* y, int B, int S,
                                  int NZ, int NR, void* stream) {
  return launch<float>(C, u, y, B, S, NZ, NR, stream);
}

extern "C" int stencil2d_half_f64(const void* C, const void* u, void* y, int B, int S,
                                  int NZ, int NR, void* stream) {
  return launch<double>(C, u, y, B, S, NZ, NR, stream);
}
