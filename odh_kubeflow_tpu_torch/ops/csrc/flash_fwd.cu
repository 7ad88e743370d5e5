// Flash-attention forward for Hopper (sm_90a), plain C interface loaded with
// ctypes by odh_kubeflow_tpu_torch/ops/attention.py.
//
// Replaces the TPU kernel odh_kubeflow_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_forward_kernel, pallas_call at :409). Same arithmetic:
// scores scaled by d**-0.5 * log2(e) and exponentiated with exp2, an online
// softmax carry (m, l, acc) in f32, p rounded to the input dtype before the
// P.V product, out = acc / max(l, 1e-30), optional lse = m*ln2 + ln(max(l,
// 1e-30)) in f32 laid out (b, h, sq). Masked scores are -1e30, as in the
// reference, so a row's first key tile (key 0 is always visible) gives every
// carry a finite max.
//
// Layout: q (b, sq, h, d), k/v (b, sk, hk, d), read in place through their
// strides (last dim contiguous); head j reads kv head j / (h / hk), so K/V
// are never expanded. o is contiguous (b, sq, h, d) in q's dtype.
//
// Design (a simple kernel that is right; mma.sync/wgmma, TMA and warp
// specialisation are later work): one 256-thread block per (batch*head,
// 64-row q tile); four threads per query row, each owning 16 of a key
// tile's 64 score columns and d/4 of the output columns. The q tile and
// each 64-row K/V tile are staged in shared memory with rows padded so the
// per-row reads of a warp hit distinct banks; the per-row softmax state
// lives in registers and is reduced across the row's four threads with
// warp shuffles. Causal key tiles wholly above the diagonal are never
// loaded, and q tiles run longest-first so the causal triangle's heavy
// blocks start early.
//
// What bounds it on this card: at serving shapes (d = 128) the work is
// 4*b*h*sq*sk*d/2 flops against ~(2*sk + 2*sq)*d bytes per head, so an
// ideal kernel is bound by tensor-core operations. This one does its dot
// products in scalar f32 FMAs fed from shared memory (two loads per FMA),
// so shared-memory bandwidth bounds it well below that; PERF.md holds the
// measured gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per shared-memory tile
constexpr int LANES = 4;      // threads per query row
constexpr int THREADS = BQ * LANES;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp astype
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

template <typename T, int D>
constexpr size_t smem_bytes() {
  // q and k tiles padded to D + 2 elements per row, v unpadded, p in f32
  return (size_t)(BQ + BK) * (D + 2) * sizeof(T) + (size_t)BK * D * sizeof(T) +
         (size_t)BQ * (BK + 1) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int h, int hk, int sq, int sk,
                 int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                 int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                 int64_t vsh, int causal, float scale_log2) {
  constexpr int QS = D + 2;          // padded row stride of the q/k tiles
  constexpr int PS = BK + 1;         // padded row stride of the p tile
  constexpr int CPT = BK / LANES;    // score columns per thread
  constexpr int OPT = D / LANES;     // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * QS;
  T* Vs = Ks + BK * QS;
  float* Ps = reinterpret_cast<float*>(Vs + BK * D);

  const int tid = threadIdx.x;
  const int r = tid / LANES;
  const int t = tid % LANES;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hi = bh % h;
  const int kvh = hi / (h / hk);
  const T* qb = q + b * qsb + hi * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int row = idx / D, col = idx % D;
    const int qp = q0 + row;
    Qs[row * QS + col] = qp < sq ? qb[qp * qss + col] : from_f<T>(0.f);
  }

  const int q_pos = q0 + r;
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  float m = NEG_INF;
  float l = 0.f;
  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
  const T* qr = Qs + r * QS;
  float* pr = Ps + r * PS;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the previous K/V tile
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int row = idx / D, col = idx % D;
      const int kp = k0 + row;
      // rows past sk are zero: their p is 0, and 0 * garbage could be NaN
      Ks[row * QS + col] = kp < sk ? kb[kp * kss + col] : from_f<T>(0.f);
      Vs[row * D + col] = kp < sk ? vb[kp * vss + col] : from_f<T>(0.f);
    }
    __syncthreads();

    // the tile needs elementwise masking only on the ragged tail and where
    // it straddles the causal diagonal
    const bool masked = (k0 + BK > sk) || (causal && k0 + BK - 1 > q0);
    float s[CPT];
    float row_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = t + LANES * j;
      const T* kr = Ks + c * QS;
      float dot = 0.f;
#pragma unroll 8
      for (int i = 0; i < D; i += 2) {
        const float2 a = load2(qr + i);
        const float2 w = load2(kr + i);
        dot = fmaf(a.x, w.x, dot);
        dot = fmaf(a.y, w.y, dot);
      }
      float sv = dot * scale_log2;  // log2-domain score
      const int kp = k0 + c;
      if (masked && (kp >= sk || (causal && kp > q_pos))) sv = NEG_INF;
      s[j] = sv;
      row_max = fmaxf(row_max, sv);
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m, row_max);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = exp2f(s[j] - m_new);
      psum += p;  // l sums the f32 p; acc takes p in the input dtype
      pr[t + LANES * j] = to_f(from_f<T>(p));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's four threads share one warp

#pragma unroll
    for (int i = 0; i < OPT; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const T* vr = Vs + c * D + 2 * t;
#pragma unroll
      for (int i = 0; i < OPT / 2; ++i) {
        const float2 w = load2(vr + 2 * LANES * i);
        acc[2 * i] = fmaf(p, w.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(p, w.y, acc[2 * i + 1]);
      }
    }
  }

  if (q_pos < sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + ((int64_t)(b * sq + q_pos) * h + hi) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < OPT / 2; ++i)
      store2(orow + 2 * LANES * i, acc[2 * i] / denom, acc[2 * i + 1] / denom);
    if (lse != nullptr && t == 0)
      lse[(int64_t)bh * sq + q_pos] = m * LN2 + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int h, int hk,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   int causal, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, hk, sq, sk, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], causal,
      scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, float* lse, int b, int sq, int sk, int h,
                       int hk, const int64_t* qs, const int64_t* ks,
                       const int64_t* vs, int causal, float scale_log2,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch, seq,
// head) for each of q/k/v; the last dim must be contiguous. lse may be null.
// Returns the launch's cudaError_t (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int odh_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int dtype, int b, int sq,
                             int sk, int h, int hk, int d, const int64_t* qs,
                             const int64_t* ks, const int64_t* vs, int causal,
                             float scale_log2, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(d, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* odh_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
