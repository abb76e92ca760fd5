// Staging of a contiguous run of device memory in shared memory with cp.async,
// shared by the two stencil kernels (stencil2d.cu, stencil3d.cu).
//
// Both kernels give a block a slab of whole rows (2D) or whole planes (3D), so
// the u it needs for one solve, halo included, is ONE contiguous run. Its
// start is in general not 16-byte aligned (a solve is NZ*NR or NZ*NP*NR
// elements, e.g. 761*161*4 B = 4 mod 16), which rules out cp.async.bulk (the
// 1D TMA copy needs 16-byte aligned addresses and sizes). Copying the aligned
// superset instead would read up to 12 bytes before or after the tensor. So
// the run is placed in its shared-memory buffer at the same offset modulo 16
// bytes as it has in device memory (shift()), and copied as element-wise
// cp.async for the few elements up to the first 16-byte boundary and after
// the last one, and 16-byte cp.async.cg for everything between.

#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_runtime.h>

namespace slab {

// The most dynamic shared memory a block may opt into on sm_90 (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst_smem, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst_smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

// Close the group of the copies this thread has started since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's newest groups are still in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Elements by which the slab of a solve is displaced inside its 16-byte
// aligned buffer, so that buffer + shift + i and base + first + i agree modulo
// 16 bytes for every i. `first` is the element offset of the slab's first
// (halo) row from `base`, taken modulo 2^32 (only its low bits matter; it may
// stand for a negative offset when the halo row lies above the grid).
template <typename T>
__device__ __forceinline__ int shift(const T* base, unsigned int first) {
  const unsigned int base_elems =
      static_cast<unsigned int>(reinterpret_cast<uintptr_t>(base) / sizeof(T));
  return static_cast<int>((base_elems + first) & (vec_elems<T>() - 1));
}

// Start the copy of src[0, count) to dst[0, count); dst (shared) and src
// (device memory) agree modulo 16 bytes. All `nthreads` threads call it.
template <typename T>
__device__ __forceinline__ void stage_run(T* dst, const T* src, int count, int tid,
                                          int nthreads) {
  constexpr int V = vec_elems<T>();
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const int head = min(count, (V - mis) & (V - 1));
  const int nvec = (count - head) / V;
  const int tail = count - head - nvec * V;
  for (int i = tid; i < nvec; i += nthreads) {
    cp_async<16>(dst + head + i * V, src + head + i * V);
  }
  if (tid < head + tail) {  // at most 2 (V - 1) elements
    const int e = tid < head ? tid : nvec * V + tid;
    cp_async<sizeof(T)>(dst + e, src + e);
  }
}

template <typename T>
__device__ __forceinline__ void zero_run(T* dst, int count, int tid, int nthreads) {
  for (int i = tid; i < count; i += nthreads) dst[i] = T(0);
}

// A masked term of the stencil still reads u at its offset (times a zero
// coefficient), so a buffer carries a zero-filled margin before and after the
// slab: `reach` is the largest offset of the stencil in elements.
template <typename T>
__host__ __device__ inline int margin_elems(int reach) {
  constexpr int V = vec_elems<T>();
  return (reach + V - 1) / V * V;
}

// Elements between the buffers of two solves: the two margins, (tile_rows + 2)
// rows of `width` and room for the shift, rounded up so every buffer starts
// 16-byte aligned.
template <typename T>
__host__ __device__ inline int buffer_stride(int tile_rows, int width, int margin) {
  constexpr int V = vec_elems<T>();
  return ((tile_rows + 2) * width + 2 * margin + 2 * V - 2) / V * V;
}

// ---- host side: the tile a launch uses, and what the built kernel needs ----

struct Tile {
  int TZ;       // rows (2D) or planes (3D) of a block's slab
  int G;        // solves staged at once (S unless they do not fit)
  size_t smem;  // dynamic shared memory of a block
};

// Tile height and solves per group. `bytes(tz, g)` is the shared memory a
// block needs. G is S, or the most solves whose one-row slabs fit in a block's
// shared memory. TZ is `tile_rows` if positive (a tuning sweep's choice, cut
// to what fits), else the largest height up to `auto_max_tz` that needs at most
// `auto_bytes`. False if one solve's one-row slab does not fit.
template <typename BytesFn>
inline bool choose_tile(int S, int tile_rows, int auto_max_tz, size_t auto_bytes,
                        BytesFn bytes, Tile& t) {
  int G = S;
  while (G > 1 && bytes(1, G) > kMaxSmemBytes) --G;
  if (bytes(1, G) > kMaxSmemBytes) return false;
  int TZ = 1;
  if (tile_rows > 0) {
    TZ = tile_rows < 4096 ? tile_rows : 4096;
    while (TZ > 1 && bytes(TZ, G) > kMaxSmemBytes) --TZ;
  } else {
    for (int tz = 2; tz <= auto_max_tz; ++tz) {
      if (bytes(tz, G) <= auto_bytes) TZ = tz;
    }
  }
  t.TZ = TZ;
  t.G = G;
  t.smem = bytes(TZ, G);
  return true;
}

// Above 48 KB a kernel must opt into its dynamic shared memory. The attribute
// is set once per device, kernel and size (the largest asked so far), so a
// launch whose size is already allowed makes no runtime call but the launch
// itself: cudaFuncSetAttribute is no stream operation and is not recorded
// into a CUDA graph, and a launch captured into one (ops/cg.py) repeats a
// size its eager warm-up launch has set.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> allowed;
  std::lock_guard<std::mutex> lock(mu);
  size_t& done = allowed[{device, reinterpret_cast<const void*>(kernel)}];
  if (smem <= done) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) done = smem;
  return err;
}

// out[0..5]: registers per thread, local (spill) bytes per thread, dynamic
// shared memory per block, TZ, solves per group G, resident blocks per SM.
template <typename Kernel>
inline int kernel_info(Kernel kernel, int threads, const Tile& t, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(kernel, t.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, t.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(t.smem);
  out[3] = t.TZ;
  out[4] = t.G;
  out[5] = blocks;
  return 0;
}

}  // namespace slab
