// Helpers shared by the port's flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the rule that chooses between their tensor-core and scalar
// kernels, conversions between the storage type (float or bf16) and the f32
// the kernels compute in, two- and four-element loads and stores, cp.async
// copies into shared memory, a clustered launch, and the rules by which the
// scalar kernels size their tiles and clusters.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace odh_flash {

constexpr float NEG_INF = -1e30f;  // masked scores, as in the reference

// The one rule by which the forward and the backward choose their kernels,
// by (dtype, d) alone (dtype 0 = float32, 1 = bfloat16): 1 = the tensor-core
// kernels (bf16, d 64 or 128), 0 = the scalar ones (f32 at d 16/32/64/128,
// bf16 at d 16 or 32: the tensor cores have no f32 product, and TF32 would
// break the f32 gates), -1 = unsupported. attention._on_tensor_cores
// mirrors it in Python.
inline int kernel_choice(int dtype, int d) {
  const bool known_d = d == 16 || d == 32 || d == 64 || d == 128;
  if (!known_d || (dtype != 0 && dtype != 1)) return -1;
  return (dtype == 1 && (d == 64 || d == 128)) ? 1 : 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp astype
}

// x rounded to T and back: the rounding point of an `astype(T)` in the
// reference before a product that accumulates in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// four consecutive values (16 bytes of f32, 8 of bf16; the address aligned
// to that) as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// N (2 or 4) consecutive values as f32, and their store from f32
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = load4(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = load2(p);
    out[0] = x.x; out[1] = x.y;
  }
}
template <int N, typename T>
__device__ __forceinline__ void store_n(T* p, const float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 2) store2(p + i, x[i], x[i + 1]);
}

// ---- cp.async: copies from device memory into shared memory that run
// while the threads compute; committed in groups and waited for ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// W bytes (16 or 4) from src to dst; with `valid` false nothing is read and
// dst is zero-filled
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? W : 0;
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// every copy this thread started has landed (its own; a barrier makes them
// visible to the block)
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Starts the copy of rows [row0, row0 + ROWS) of a (seq, d) slice (row
// stride `row_stride` elements, last dim contiguous) into a tile of row
// stride `dst_stride` elements; rows at or past n_rows are zero. 16-byte
// copies where `vec16` (base and strides multiples of 16 bytes), else
// 4-byte ones (base and strides multiples of 4 bytes).
template <typename T, int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void async_rows(T* dst, int dst_stride, const T* src,
                                           int64_t row_stride, int row0, int n_rows, bool vec16) {
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  const int64_t src_row = row_stride * (int64_t)sizeof(T);
  const int dst_row = dst_stride * (int)sizeof(T);
  if (vec16) {
    constexpr int PER_ROW = D * (int)sizeof(T) / 16;
    for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NTHREADS) {
      const int row = idx / PER_ROW, c = (idx % PER_ROW) * 16;
      const bool ok = row0 + row < n_rows;
      cp_async<16>(d + row * dst_row + c, ok ? s + (row0 + row) * src_row + c : s, ok);
    }
  } else {
    constexpr int PER_ROW = D * (int)sizeof(T) / 4;
    for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NTHREADS) {
      const int row = idx / PER_ROW, c = (idx % PER_ROW) * 4;
      const bool ok = row0 + row < n_rows;
      cp_async<4>(d + row * dst_row + c, ok ? s + (row0 + row) * src_row + c : s, ok);
    }
  }
}

// Host side: whether a (b, s, heads, d) view can be copied 16 (or 4) bytes
// at a time: its base address and its three outer strides (elements)
// multiples of that many bytes.
inline bool aligned_to(const void* p, const int64_t* strides, int elem, int bytes) {
  if (reinterpret_cast<uintptr_t>(p) % bytes) return false;
  for (int i = 0; i < 3; ++i)
    if ((strides[i] * elem) % bytes) return false;
  return true;
}

// Launches `kernel` on `grid` x `threads` with `smem` bytes of dynamic
// shared memory, in clusters of `cluster` blocks along x (1: each block its
// own), and returns the launch's error
template <typename... KArgs, typename... Args>
cudaError_t launch_clustered(void (*kernel)(KArgs...), dim3 grid, int threads, int smem,
                             int cluster, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  return sms;
}

// Rows per block of the scalar forward (q rows) and dk/dv (k rows)
// kernels, and blocks per cluster. The tile: 64, else 32, where that tile's
// grid (`groups` = batch * heads row blocks of each tile of rows), split
// over 2-block clusters, gives at least three quarters of the SMs a block;
// else 16. The larger tile gives each thread a larger block of products
// (more FMAs per shared-memory load), the smaller one more blocks.
// attention._scalar_tile mirrors it in Python.
inline int scalar_tile(int rows, int64_t groups) {
  const int64_t sms = sm_count();
  if (8 * groups * ((rows + 63) / 64) >= 3 * sms) return 64;
  if (8 * groups * ((rows + 31) / 32) >= 3 * sms) return 32;
  return 16;
}

// The split: the blocks of a cluster share the `inner` tiles of one row
// tile (key tiles in the forward, q tiles in dk/dv); it doubles, up to
// `max_split`, while the grid still leaves SMs idle and the longest row
// block has two inner tiles for each block. attention.scalar_splits
// reports what it chose.
inline int scalar_split(int rows, int64_t groups, int tile, int64_t inner, int max_split) {
  const int64_t blocks = groups * ((rows + tile - 1) / tile);
  const int sms = sm_count();
  int split = 1;
  while (split < max_split && blocks * split < sms && inner >= 2 * split) split *= 2;
  return split;
}

}  // namespace odh_flash
