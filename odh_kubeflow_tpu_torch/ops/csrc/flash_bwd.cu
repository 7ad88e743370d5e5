// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// with a plain C interface loaded with ctypes by
// odh_kubeflow_tpu_torch/ops/attention.py.
//
// Replaces the TPU kernels odh_kubeflow_tpu/ops/attention.py::
// _flash_bwd_dq_kernel (pallas_call at :639) and _flash_bwd_dkv_kernel
// (pallas_call at :665), launched by _flash_backward. Same arithmetic (the
// FlashAttention-2 recompute, _recompute_p_ds):
//   s  = q.k^T * (d**-0.5 * log2 e)          f32 accumulate; masked -1e30
//   p  = exp2(s - lse * log2 e)               f32, not rounded
//   dp = dO.v^T                               f32 accumulate
//   ds = p * (dp - delta) * d**-0.5
//   dq += ds.K    with ds rounded to K's dtype first
//   dV += p^T.dO  with p rounded to dO's dtype first
//   dK += ds^T.Q  with ds rounded to Q's dtype first
// Every accumulator is f32 and each output is rounded once, when written.
// delta = rowsum(dO * O) - g_lse is computed by the caller (as the reference
// does outside its pallas_calls). The causal mask is top-left aligned
// (q_pos >= k_pos).
//
// Layout: q/dO (b, sq, h, d), k/v (b, sk, hk, d), read in place through
// their strides (last dim contiguous); lse and delta f32 (b, h, sq)
// contiguous; head j reads kv head j / (h / hk). dq is written contiguous
// (b, sq, h, d) in q's dtype, dk/dv contiguous (b, sk, hk, d) in k's.
//
// Design (a simple kernel that is right; mma.sync/wgmma, TMA and warp
// specialisation are later work). Both kernels use 256-thread blocks, four
// threads per tile row, 64-row tiles in shared memory with rows padded so a
// warp's per-row reads hit distinct banks, and scalar f32 FMAs.
// - dq: one block per (batch*head, 64 q rows). The q and dO tiles and each
//   row's lse and delta are staged once; the block loops over 64-row K/V
//   tiles, stopping at the diagonal under the causal mask. A row's four
//   threads compute its 64 ds values, round them, and share them through a
//   shared-memory row; dq stays in f32 registers and is written once.
// - dk/dv: one block per (batch*kv_head, 64 k rows). The K/V tile stays
//   resident; the block loops over the GQA group's heads and, for each, over
//   64-row q tiles, starting at the diagonal under the causal mask. dk and
//   dv of a k row stay in f32 registers across the whole group, so the
//   group sum is taken in f32 inside the block (no atomics: gradients are
//   deterministic run to run).
//
// What bounds it on this card: at training shapes (d = 128, s = 2048) the
// pair does ~14*b*h*d*pairs flops against ~(4*sq*h + 4*sk*hk)*d bytes, so an
// ideal kernel is bound by tensor-core operations. These do their products
// in scalar f32 FMAs fed from shared memory, so shared-memory bandwidth and
// the FMA rate bound them far below that; PERF.md holds the measured gap.

#include "flash_common.cuh"

namespace {

using namespace odh_flash;

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // k rows per tile
constexpr int LANES = 4;  // threads per tile row
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(BQ * LANES == THREADS && BK * LANES == THREADS, "one row per four threads");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int b, sq, sk, h, hk;
  int64_t qs[3], ks[3], vs[3], os[3];  // (batch, seq, head) strides, elements
  int causal;
  float scale_log2;  // d**-0.5 * log2(e)
  float scale;       // d**-0.5
};

// rows [row0, row0 + ROWS) of a (seq, d) slice into a tile of row stride
// D + 2; rows at or past n_rows are zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t row_stride,
                                          int row0, int n_rows) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int row = idx / D, col = idx % D;
    const int p = row0 + row;
    dst[row * (D + 2) + col] = p < n_rows ? src[(int64_t)p * row_stride + col] : from_f<T>(0.f);
  }
}

template <typename T, int D>
__device__ __forceinline__ float dot(const T* a, const T* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < D; i += 2) {
    const float2 x = load2(a + i);
    const float2 y = load2(b + i);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles; the ds tile in f32 with rows padded to BK + 1
  return (size_t)(2 * BQ + 2 * BK) * (D + 2) * sizeof(T) + (size_t)BQ * (BK + 1) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Args a) {
  constexpr int S = D + 2;
  constexpr int PS = BK + 1;
  constexpr int CPT = BK / LANES;  // score columns per thread
  constexpr int OPT = D / LANES;   // dq columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + BQ * S;
  T* Ks = Os + BQ * S;
  T* Vs = Ks + BK * S;
  float* DSs = reinterpret_cast<float*>(Vs + BK * S);

  const int tid = threadIdx.x;
  const int r = tid / LANES;
  const int t = tid % LANES;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // causal: longest rows first
  const int bh = blockIdx.y;
  const int b = bh / a.h;
  const int hi = bh % a.h;
  const int kvh = hi / (a.h / a.hk);
  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hi * a.qs[2];
  const T* ob = static_cast<const T*>(a.dout) + b * a.os[0] + hi * a.os[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  load_tile<T, D, BQ>(Qs, qb, a.qs[1], q0, a.sq);
  load_tile<T, D, BQ>(Os, ob, a.os[1], q0, a.sq);
  const int q_pos = q0 + r;
  // rows past sq see q = dO = 0 and lse = delta = 0, so their ds is 0
  const bool row_in = q_pos < a.sq;
  const float lse2 = row_in ? a.lse[(int64_t)bh * a.sq + q_pos] * LOG2E : 0.f;
  const float dlt = row_in ? a.delta[(int64_t)bh * a.sq + q_pos] : 0.f;

  const int q_last = min(q0 + BQ, a.sq) - 1;
  const int k_end = a.causal ? min(a.sk, q_last + 1) : a.sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.f;
  const T* qr = Qs + r * S;
  const T* orow = Os + r * S;
  float* dsr = DSs + r * PS;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the previous K/V tile
    load_tile<T, D, BK>(Ks, kb, a.ks[1], k0, a.sk);
    load_tile<T, D, BK>(Vs, vb, a.vs[1], k0, a.sk);
    __syncthreads();

    const bool masked = (k0 + BK > a.sk) || (a.causal && k0 + BK - 1 > q0);
#pragma unroll 4
    for (int j = 0; j < CPT; ++j) {
      const int c = t + LANES * j;
      float s = dot<T, D>(qr, Ks + c * S) * a.scale_log2;
      const int kp = k0 + c;
      if (masked && (kp >= a.sk || (a.causal && kp > q_pos))) s = NEG_INF;
      const float p = exp2f(s - lse2);
      const float dp = dot<T, D>(orow, Vs + c * S);
      dsr[c] = round_to<T>(p * (dp - dlt) * a.scale);
    }
    __syncwarp();  // a row's four threads share one warp

    for (int c = 0; c < BK; ++c) {
      const float ds = dsr[c];
      const T* kr = Ks + c * S + 2 * t;
#pragma unroll
      for (int i = 0; i < OPT / 2; ++i) {
        const float2 w = load2(kr + 2 * LANES * i);
        acc[2 * i] = fmaf(ds, w.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(ds, w.y, acc[2 * i + 1]);
      }
    }
  }

  if (row_in) {
    T* out = static_cast<T*>(a.dq) + ((int64_t)(b * a.sq + q_pos) * a.h + hi) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < OPT / 2; ++i) store2(out + 2 * LANES * i, acc[2 * i], acc[2 * i + 1]);
  }
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles; the p and ds tiles in f32 with rows padded to
  // BQ + 1; a q tile's lse * log2(e) and delta
  return (size_t)(2 * BK + 2 * BQ) * (D + 2) * sizeof(T) +
         (size_t)2 * BK * (BQ + 1) * sizeof(float) + (size_t)2 * BQ * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Args a) {
  constexpr int S = D + 2;
  constexpr int PS = BQ + 1;
  constexpr int RPT = BQ / LANES;  // q rows per thread
  constexpr int OPT = D / LANES;   // dk/dv columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * S;
  T* Qs = Vs + BK * S;
  T* Os = Qs + BQ * S;
  float* Ps = reinterpret_cast<float*>(Os + BQ * S);
  float* DSs = Ps + BK * PS;
  float* Ls = DSs + BK * PS;
  float* Dl = Ls + BQ;

  const int tid = threadIdx.x;
  const int c = tid / LANES;  // this thread's k row in the tile
  const int t = tid % LANES;
  const int k0 = blockIdx.x * BK;  // causal: the first k rows have the most q rows
  const int bkv = blockIdx.y;
  const int b = bkv / a.hk;
  const int kvh = bkv % a.hk;
  const int group = a.h / a.hk;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  load_tile<T, D, BK>(Ks, kb, a.ks[1], k0, a.sk);
  load_tile<T, D, BK>(Vs, vb, a.vs[1], k0, a.sk);
  const int k_pos = k0 + c;
  // q rows below k0 see none of this tile under the causal mask
  const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;

  float dk[OPT], dv[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) dk[i] = dv[i] = 0.f;
  const T* kr = Ks + c * S;
  const T* vr = Vs + c * S;
  float* pr = Ps + c * PS;
  float* dsr = DSs + c * PS;

  for (int gi = 0; gi < group; ++gi) {
    const int hi = kvh * group + gi;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hi * a.qs[2];
    const T* ob = static_cast<const T*>(a.dout) + b * a.os[0] + hi * a.os[2];
    const int64_t stat0 = (int64_t)(b * a.h + hi) * a.sq;
    for (int q0 = q_begin; q0 < a.sq; q0 += BQ) {
      __syncthreads();  // every thread is done with the previous q tile
      load_tile<T, D, BQ>(Qs, qb, a.qs[1], q0, a.sq);
      load_tile<T, D, BQ>(Os, ob, a.os[1], q0, a.sq);
      if (tid < BQ) {
        const int qp = q0 + tid;
        Ls[tid] = qp < a.sq ? a.lse[stat0 + qp] * LOG2E : 0.f;
        Dl[tid] = qp < a.sq ? a.delta[stat0 + qp] : 0.f;
      }
      __syncthreads();

      const bool masked = (q0 + BQ > a.sq) || (k0 + BK > a.sk) || (a.causal && k0 + BK - 1 > q0);
#pragma unroll 4
      for (int j = 0; j < RPT; ++j) {
        const int r = t + LANES * j;
        const int qp = q0 + r;
        float s = dot<T, D>(Qs + r * S, kr) * a.scale_log2;
        if (masked && (qp >= a.sq || k_pos >= a.sk || (a.causal && k_pos > qp))) s = NEG_INF;
        const float p = exp2f(s - Ls[r]);
        const float dp = dot<T, D>(Os + r * S, vr);
        pr[r] = round_to<T>(p);
        dsr[r] = round_to<T>(p * (dp - Dl[r]) * a.scale);
      }
      __syncwarp();  // a k row's four threads share one warp

      for (int r = 0; r < BQ; ++r) {
        const float p = pr[r];
        const float ds = dsr[r];
        const T* orow = Os + r * S + 2 * t;
        const T* qrow = Qs + r * S + 2 * t;
#pragma unroll
        for (int i = 0; i < OPT / 2; ++i) {
          const float2 o = load2(orow + 2 * LANES * i);
          const float2 q = load2(qrow + 2 * LANES * i);
          dv[2 * i] = fmaf(p, o.x, dv[2 * i]);
          dv[2 * i + 1] = fmaf(p, o.y, dv[2 * i + 1]);
          dk[2 * i] = fmaf(ds, q.x, dk[2 * i]);
          dk[2 * i + 1] = fmaf(ds, q.y, dk[2 * i + 1]);
        }
      }
    }
  }

  if (k_pos < a.sk) {
    const int64_t row = ((int64_t)(b * a.sk + k_pos) * a.hk + kvh) * D + 2 * t;
    T* dkr = static_cast<T*>(a.dk) + row;
    T* dvr = static_cast<T*>(a.dv) + row;
#pragma unroll
    for (int i = 0; i < OPT / 2; ++i) {
      store2(dkr + 2 * LANES * i, dk[2 * i], dk[2 * i + 1]);
      store2(dvr + 2 * LANES * i, dv[2 * i], dv[2 * i + 1]);
    }
  }
}

template <typename T, int D>
struct LaunchDq {
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    constexpr size_t smem = dq_smem_bytes<T, D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.sq + BQ - 1) / BQ, a.b * a.h);
    flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct LaunchDkv {
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    constexpr size_t smem = dkv_smem_bytes<T, D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.sk + BK - 1) / BK, a.b * a.hk);
    flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

template <template <typename, int> class Launch, typename T>
cudaError_t dispatch_d(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return Launch<T, 16>::run(a, stream);
    case 32: return Launch<T, 32>::run(a, stream);
    case 64: return Launch<T, 64>::run(a, stream);
    case 128: return Launch<T, 128>::run(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int> class Launch>
int dispatch(int dtype, int d, const Args& a, void* stream) {
  if (a.b <= 0 || a.sq <= 0 || a.sk <= 0 || a.h <= 0 || a.hk <= 0 || a.h % a.hk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<Launch, float>(d, a, st);
  if (dtype == 1) return (int)dispatch_d<Launch, __nv_bfloat16>(d, a, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, int b, int sq, int sk,
               int h, int hk, const int64_t* qs, const int64_t* ks,
               const int64_t* vs, const int64_t* os, int causal,
               float scale_log2, float scale) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.b = b; a.sq = sq; a.sk = sk; a.h = h; a.hk = hk;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = qs[i]; a.ks[i] = ks[i]; a.vs[i] = vs[i]; a.os[i] = os[i];
  }
  a.causal = causal; a.scale_log2 = scale_log2; a.scale = scale;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch, seq,
// head) for each of q/k/v/dO; the last dim must be contiguous. Each returns
// the launch's cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int odh_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int dtype, int b,
                                int sq, int sk, int h, int hk, int d,
                                const int64_t* qs, const int64_t* ks,
                                const int64_t* vs, const int64_t* os,
                                int causal, float scale_log2, float scale,
                                void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, b, sq, sk, h, hk, qs, ks, vs, os,
                     causal, scale_log2, scale);
  a.dq = dq;
  return dispatch<LaunchDq>(dtype, d, a, stream);
}

extern "C" int odh_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int dtype, int b, int sq, int sk, int h,
                                 int hk, int d, const int64_t* qs,
                                 const int64_t* ks, const int64_t* vs,
                                 const int64_t* os, int causal,
                                 float scale_log2, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, b, sq, sk, h, hk, qs, ks, vs, os,
                     causal, scale_log2, scale);
  a.dk = dk;
  a.dv = dv;
  return dispatch<LaunchDkv>(dtype, d, a, stream);
}

extern "C" const char* odh_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
