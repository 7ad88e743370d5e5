// Flash-attention backward for Hopper (sm_90a): dq and dk/dv kernels with a
// plain C interface loaded with ctypes by
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
// Two kernels for each of dq and dk/dv, chosen by (dtype, d) alone by the
// rule the forward follows too (odh_flash::kernel_choice, flash_common.cuh).
// Neither pair uses atomics: dq and dk/dv are separate kernels, each owning
// its outputs, so gradients are the same from run to run. (A dk/dv kernel
// that also summed dq would do 10*d flops per visible (q, k) pair against the
// pair's 14*d, but needs f32 atomics, whose order changes from run to run, or
// a second pass.)
//
// * The tensor-core kernels, bf16 at d 64 and 128 (the flagship model's d
//   is 128). What bounds them on this card: at the training shape (b8 s2048
//   h8 d128, causal) dq does 6*d flops per visible pair and dk/dv 8*d
//   against a few hundred MB, so both are bound by tensor-core operations
//   (0.1043 and 0.1390 ms at 989 TFLOP/s). The scalar kernels below reached
//   ~1% of that, fed from shared memory at two loads per FMA. These run
//   every product on wgmma, as flash_fwd_wgmma_kernel does:
//   - a producer warp brings the block's resident tiles once and streams the
//     others by TMA (tensor maps over the strided (b, s, heads, d) views,
//     128-byte swizzle, rows past the sequence zero-filled) through a
//     two-stage ring tracked by mbarriers (full: the bytes landed; empty:
//     every consumer warp is done); it is a whole warpgroup that gives its
//     registers to the two consumer warpgroups (setmaxnreg 24 / 240);
//   - flash_bwd_dkv_wgmma_kernel works in the transposed frame: one block
//     per (batch*kv_head, 128 k rows), each consumer warpgroup owning 64 k
//     rows as wgmma's M. K and V stay resident; the ring streams 64-row Q
//     and dO tiles with that tile's lse*log2(e) and delta, which the
//     producer warp stages in shared memory, looping over the GQA group's
//     heads inside the block so the group sum stays in f32 registers. S^T =
//     K.Q^T and dP^T = V.dO^T by wgmma SS (both operands K-major); P^T and
//     dS^T on the accumulator fragment (lse and delta indexed by its
//     columns), rounded to bf16 and packed in registers as the A operand of
//     dV += P^T.dO and dK += dS^T.Q by wgmma RS, dO and Q read MN-major from
//     the same tiles. Under the causal mask the q loop starts at the
//     diagonal tile;
//   - flash_bwd_dq_wgmma_kernel works in the forward's frame: one block per
//     (batch*head, 128 q rows), longest rows first, K and V streamed in
//     64-row tiles up to the diagonal. Q and dO come once by TMA and each
//     consumer thread keeps its rows of them as wgmma A fragments in
//     registers, so S = Q.K^T and dP = dO.V^T run as wgmma RS with only K
//     and V read from shared memory (with both operands there, an m64n64k16
//     reads 4 KB for 131k flops: at the tensor cores' rate, all that shared
//     memory delivers). S and dP are two commit groups: P is computed while
//     dP is on the tensor cores. dS in registers is the A operand of dq +=
//     dS.K by wgmma RS, K read MN-major from the tile S read K-major. The k
//     tile is 64 rows, not the forward's 128: dq's accumulator, S, dP, dS's
//     fragment and the Q and dO fragments (64 + 32 + 32 + 16 + 64 registers
//     a thread at d 128) fill the 240 a consumer thread has, and ptxas
//     answers a wgmma kernel short of registers by serialising its wgmmas;
//   - dq's register fragments and its overlap of P with dP were each timed
//     on an H100 against the kernel without them and kept because they were
//     faster. Not kept: a three-stage ring and staging dk/dv's stats before
//     the ring's empty barrier (no faster), computing P^T while dP^T is on
//     the tensor cores in dk/dv (no faster), issuing a tile's products before
//     the last tile's dq or dV/dK product had finished (slower; in dk/dv
//     ptxas serialised the wgmmas, C7512), K or V of dk/dv as register
//     fragments (spills and C7512: dK's and dV's accumulators leave no room),
//     and the two warpgroups taking turns to issue (too little gain to keep);
//   - the mask is applied only on tiles that straddle the causal diagonal
//     or a ragged tail; dq, dk and dv are written once, from registers.
//
// * The scalar kernels (the port's first backward kernels), f32 at every d
//   and bf16 at d 16 and 32: the tensor cores have no f32 product, and TF32
//   would break the f32 gates (1e-5 against the plain version, the f32
//   gradient check of the train step). 256-thread blocks, four threads per
//   tile row, 64-row tiles in shared memory with rows padded so a warp's
//   per-row reads hit distinct banks, scalar f32 FMAs; bound by shared-memory
//   bandwidth.
//   - dq: one block per (batch*head, 64 q rows). The q and dO tiles and each
//     row's lse and delta are staged once; the block loops over 64-row K/V
//     tiles, stopping at the diagonal under the causal mask. A row's four
//     threads compute its 64 ds values, round them, and share them through a
//     shared-memory row; dq stays in f32 registers and is written once.
//   - dk/dv: one block per (batch*kv_head, 64 k rows). The K/V tile stays
//     resident; the block loops over the GQA group's heads and, for each, over
//     64-row q tiles, starting at the diagonal under the causal mask. dk and
//     dv of a k row stay in f32 registers across the whole group.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace odh_flash;

constexpr float LOG2E = 1.4426950408889634f;

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

bool valid(const Args& a) {
  return a.b > 0 && a.sq > 0 && a.sk > 0 && a.h > 0 && a.hk > 0 && a.h % a.hk == 0;
}

// ---- the scalar kernels: f32 at every d, bf16 at d 16 and 32 ---------------

namespace scalar {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // k rows per tile
constexpr int LANES = 4;  // threads per tile row
constexpr int THREADS = 256;

static_assert(BQ * LANES == THREADS && BK * LANES == THREADS, "one row per four threads");

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
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_scalar_kernel(const Args a) {
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
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_scalar_kernel(const Args a) {
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
        flash_bwd_dq_scalar_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.sq + BQ - 1) / BQ, a.b * a.h);
    flash_bwd_dq_scalar_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct LaunchDkv {
  static cudaError_t run(const Args& a, cudaStream_t stream) {
    constexpr size_t smem = dkv_smem_bytes<T, D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_scalar_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.sk + BK - 1) / BK, a.b * a.hk);
    flash_bwd_dkv_scalar_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
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
cudaError_t dispatch(int dtype, int d, const Args& a, cudaStream_t stream) {
  if (dtype == 0) return dispatch_d<Launch, float>(d, a, stream);
  if (dtype == 1) return dispatch_d<Launch, __nv_bfloat16>(d, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace scalar

// ---- the tensor-core kernels: bf16 at d 64 and 128 --------------------------

namespace wg {

using namespace odh_hopper;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 2;            // depth of the streamed ring
constexpr int NWG = 2;               // consumer warpgroups per block
constexpr int ROWS = 64 * NWG;       // resident rows per block: k rows (dk/dv), q rows (dq)
constexpr int BT = 64;               // rows per streamed tile: q rows (dk/dv), k rows (dq)
constexpr int THREADS = 128 * NWG + 128;  // the consumers, then the producer warpgroup

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "the tensor-core kernels take d 64 or 128");
  static constexpr int PANELS = D / PANEL;
  static constexpr int RES_BYTES = ROWS * D * 2;   // one resident tile
  static constexpr int T_BYTES = BT * D * 2;       // one streamed tile
  // 1024 bytes of slack to align the tiles to the swizzle atom, then two
  // resident tiles, two rings of streamed tiles, the ring's stats (dk/dv
  // only: lse*log2(e) and delta of each q tile), and the barriers (res_full,
  // then full and empty for each stage)
  static constexpr int STATS_BYTES = STAGES * 2 * BT * 4;
  static constexpr int SMEM =
      ATOM + 2 * RES_BYTES + 2 * STAGES * T_BYTES + STATS_BYTES + (1 + 2 * STAGES) * 8;
};

// K-major k steps of S = A.B^T over d: step kk reads columns 16kk..16kk+15,
// 32 bytes into panel kk / 4; `a_rows` and `b_rows` are the row counts of
// the two tiles (the panel strides)
template <int D>
__device__ __forceinline__ void mma_ss(float (&acc)[32], const unsigned char* a, int a_rows,
                                       const unsigned char* b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, col = (kk % 4) * 32;
    wgmma_m64n64k16_ss<0>(acc, desc_sw128(a + p * a_rows * ROW + col, 16, ATOM),
                          desc_sw128(b + p * b_rows * ROW + col, 16, ATOM), kk > 0);
  }
}

// acc (64 x D) += A (64 x 64, bf16 fragments in registers) . B, where B is a
// streamed 64-row tile read MN-major: k step kk is its rows 16kk..16kk+15,
// n runs across the d panels
template <int D>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2], const uint32_t (&a)[BT / 16][4],
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_rs<D, 1>(acc, a[kk], desc_sw128(b + kk * 2 * ATOM, BT * ROW, ATOM), 1);
}

// S (64 x 64) = A . B^T with A in registers (k step kk: d columns
// 16kk..16kk+15) and B a streamed 64-row tile read K-major
template <int D>
__device__ __forceinline__ void mma_rs_k(float (&acc)[32], const uint32_t (&a)[D / 16][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, col = (kk % 4) * 32;
    wgmma_m64n64k16_rs<0>(acc, a[kk], desc_sw128(b + p * BT * ROW + col, 16, ATOM), kk > 0);
  }
}

// A fragments (k steps over d) of 64 rows of a resident tile as TMA wrote
// it (ROWS rows, 128-byte swizzle: the 16-byte chunk c of row r lies at
// chunk c ^ (r % 8)); `row` is this thread's first row in the tile
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const unsigned char* tile,
                                             int row, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row + 8 * (r % 2);
      const int col = 16 * kk + 2 * (lane % 4) + 8 * (r / 2);
      const int byte = (col % PANEL) * 2;
      const unsigned char* at = tile + (col / PANEL) * ROWS * ROW + rr * ROW +
                                ((((byte >> 4) ^ (rr & 7)) << 4) | (byte & 15));
      a[kk][r] = *reinterpret_cast<const uint32_t*>(at);
    }
}

// 32 f32 of an accumulator fragment (64 x 64) as bf16 A fragments
__device__ __forceinline__ void pack_a(uint32_t (&a)[BT / 16][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);  // this warp is done with the stage
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int h, int hk, int sq, int sk, int causal,
                           float scale_log2, float scale) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((ATOM - (smem_u32(smem_raw) & (ATOM - 1))) & (ATOM - 1));
  unsigned char* Ks = smem;                      // panel p of row r: p * ROWS * ROW + r * ROW
  unsigned char* Vs = Ks + C::RES_BYTES;
  unsigned char* Qs = Vs + C::RES_BYTES;         // stage s, panel p: s * T_BYTES + p * BT * ROW
  unsigned char* Os = Qs + STAGES * C::T_BYTES;  // dO, laid out as Q
  float* stats = reinterpret_cast<float*>(Os + STAGES * C::T_BYTES);  // stage s: lse2[BT], delta[BT]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + STAGES * 2 * BT);
  uint64_t* full = kv_full + 1;    // a Q/dO tile landed and its stats are staged
  uint64_t* empty = full + STAGES;  // every consumer warp is done with the stage

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * ROWS;  // causal: the first k rows have the most q rows
  const int bkv = blockIdx.y;
  const int b = bkv / hk;
  const int kvh = bkv % hk;
  const int group = h / hk;
  // q tiles wholly below k0 see none of this block's keys under the causal mask
  const int n_q = (sq + BT - 1) / BT;
  const int q_begin = causal ? min(k0 / BT, n_q) : 0;
  const int per_head = n_q - q_begin;
  const int n_iter = group * per_head;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);         // one arrival per producer lane
      mbar_init(&empty[s], 4 * NWG);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * NWG) {
    // the producer: its first warp stages the stats, one thread of it starts
    // every load; the other warps leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid < 128 * NWG + 32 && n_iter > 0) {
      const int lane = tid % 32;
      if (lane == 0) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&to);
        mbar_expect_tx(kv_full, 2 * C::RES_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_4d(Ks + p * ROWS * ROW, &tk, kv_full, p * PANEL, kvh, k0, b);
          tma_load_4d(Vs + p * ROWS * ROW, &tv, kv_full, p * PANEL, kvh, k0, b);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int hi = kvh * group + it / per_head;
        const int q0 = (q_begin + it % per_head) * BT;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        // rows past sq get finite stats (their scores are masked)
        float* stage = stats + s * 2 * BT;
        const int64_t stat0 = ((int64_t)b * h + hi) * sq;
        for (int r = lane; r < BT; r += 32) {
          const int qp = q0 + r;
          stage[r] = qp < sq ? lse[stat0 + qp] * LOG2E : 0.f;
          stage[BT + r] = qp < sq ? delta[stat0 + qp] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * C::T_BYTES);  // lane 0's arrival, after its stores
#pragma unroll
          for (int p = 0; p < C::PANELS; ++p) {
            tma_load_4d(Qs + s * C::T_BYTES + p * BT * ROW, &tq, &full[s], p * PANEL, hi, q0, b);
            tma_load_4d(Os + s * C::T_BYTES + p * BT * ROW, &to, &full[s], p * PANEL, hi, q0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");

  // a consumer warpgroup: 64 k rows; this thread holds rows r0 and r0 + 8 of
  // the S^T fragment and of dK and dV
  const int wgi = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wk0 = k0 + 64 * wgi;
  const int r0 = wk0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);  // this thread's first column in each 8-column group
  const unsigned char* Kw = Ks + 64 * wgi * ROW;
  const unsigned char* Vw = Vs + 64 * wgi * ROW;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float st[32];      // S^T of this q tile, then its P^T in f32
  float dpt[32];     // dP^T, then dS^T in f32
  uint32_t pa[BT / 16][4], da[BT / 16][4];  // P^T and dS^T in bf16: A operands

  if (n_iter > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int q0 = (q_begin + it % per_head) * BT;
    const unsigned char* Qt = Qs + s * C::T_BYTES;
    const unsigned char* Ot = Os + s * C::T_BYTES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    wgmma_fence();
    mma_ss<D>(st, Kw, ROWS, Qt, BT);
    mma_ss<D>(dpt, Vw, ROWS, Ot, BT);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(st);
    wgmma_fence_regs(dpt);

    const float* ls = stats + s * 2 * BT;
    const float* dl = ls + BT;
    const bool masked = (q0 + BT > sq) || (wk0 + 64 > sk) || (causal && wk0 + 63 > q0);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float x = st[i] * scale_log2;
        if (masked) {
          const int col = q0 + 8 * j + cq + (e & 1);
          const int row = (e & 2) ? r1 : r0;
          if (col >= sq || row >= sk || (causal && row > col)) x = NEG_INF;
        }
        const float p = ex2_approx(x - ((e & 1) ? l2.y : l2.x));
        st[i] = p;
        dpt[i] = p * (dpt[i] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
    }
    pack_a(pa, st);
    pack_a(da, dpt);
    wgmma_fence();
    mma_rs<D>(dva, pa, Ot);
    mma_rs<D>(dka, da, Qt);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(dva);
    wgmma_fence_regs(dka);
    release(&empty[s], lane);
  }

  // contiguous (b, sk, hk, d), rows past sk not written
  const int64_t row0 = ((int64_t)b * sk + r0) * hk + kvh;
  const int64_t row1 = ((int64_t)b * sk + r1) * hk + kvh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + cq;
    if (r0 < sk) {
      store2(dk + row0 * D + c, dka[4 * j], dka[4 * j + 1]);
      store2(dv + row0 * D + c, dva[4 * j], dva[4 * j + 1]);
    }
    if (r1 < sk) {
      store2(dk + row1 * D + c, dka[4 * j + 2], dka[4 * j + 3]);
      store2(dv + row1 * D + c, dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int h, int hk,
                          int sq, int sk, int causal, float scale_log2, float scale) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((ATOM - (smem_u32(smem_raw) & (ATOM - 1))) & (ATOM - 1));
  unsigned char* Qs = smem;                      // panel p of row r: p * ROWS * ROW + r * ROW
  unsigned char* Os = Qs + C::RES_BYTES;         // dO, laid out as Q
  unsigned char* Ks = Os + C::RES_BYTES;         // stage s, panel p: s * T_BYTES + p * BT * ROW
  unsigned char* Vs = Ks + STAGES * C::T_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::T_BYTES);
  uint64_t* full = q_full + 1;     // a K/V tile landed
  uint64_t* empty = full + STAGES;  // every consumer warp is done with it

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // longest-first
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hi = bh % h;
  const int kvh = hi / (h / hk);
  const int q_last = min(q0 + ROWS, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + BT - 1) / BT;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * NWG) {
    // the producer: one thread starts every load, then leaves
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * NWG) {
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(q_full, 2 * C::RES_BYTES);
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p) {
        tma_load_4d(Qs + p * ROWS * ROW, &tq, q_full, p * PANEL, hi, q0, b);
        tma_load_4d(Os + p * ROWS * ROW, &to, q_full, p * PANEL, hi, q0, b);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::T_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p) {
          tma_load_4d(Ks + s * C::T_BYTES + p * BT * ROW, &tk, &full[s], p * PANEL, kvh, kt * BT, b);
          tma_load_4d(Vs + s * C::T_BYTES + p * BT * ROW, &tv, &full[s], p * PANEL, kvh, kt * BT, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");

  // a consumer warpgroup: 64 q rows; this thread holds rows r0 and r0 + 8
  const int wgi = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wq0 = q0 + 64 * wgi;
  const int r0 = wq0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  // rows past sq see q = dO = 0 and lse = delta = 0, so their ds is 0
  const int64_t stat0 = (int64_t)bh * sq;
  const float l0 = r0 < sq ? lse[stat0 + r0] * LOG2E : 0.f;
  const float l1 = r1 < sq ? lse[stat0 + r1] * LOG2E : 0.f;
  const float d0 = r0 < sq ? delta[stat0 + r0] : 0.f;
  const float d1 = r1 < sq ? delta[stat0 + r1] : 0.f;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32];                 // S of this k tile, then its P in f32
  float dp[32];                 // dP, then dS in f32
  uint32_t da[BT / 16][4];      // dS in bf16: dq's A operand
  uint32_t qa[D / 16][4], oa[D / 16][4];  // this warpgroup's Q and dO rows: A operands

  mbar_wait(q_full, 0);
  load_a_frags<D>(qa, Qs, 64 * wgi + 16 * warp + lane / 4, lane);
  load_a_frags<D>(oa, Os, 64 * wgi + 16 * warp + lane / 4, lane);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % STAGES;
    const int k0 = kt * BT;
    const unsigned char* Kt = Ks + s * C::T_BYTES;
    const unsigned char* Vt = Vs + s * C::T_BYTES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    // S and dP in two groups: P is computed while dP is on the tensor cores
    wgmma_fence();
    mma_rs_k<D>(sc, qa, Kt);
    wgmma_commit();
    mma_rs_k<D>(dp, oa, Vt);
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_regs(sc);

    const bool masked = (k0 + BT > sk) || (causal && k0 + BT - 1 > wq0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (masked) {
        const int col = k0 + 8 * (i / 4) + cq + (i & 1);
        const int row = (i & 2) ? r1 : r0;
        if (col >= sk || (causal && col > row)) x = NEG_INF;
      }
      sc[i] = ex2_approx(x - ((i & 2) ? l1 : l0));
    }
    wgmma_wait<0>();
    wgmma_fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - ((i & 2) ? d1 : d0)) * scale;
    pack_a(da, dp);
    wgmma_fence();
    mma_rs<D>(acc, da, Kt);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    release(&empty[s], lane);
  }

  bf16* o0 = dq + (((int64_t)b * sq + r0) * h + hi) * D + cq;
  bf16* o1 = dq + (((int64_t)b * sq + r1) * h + hi) * D + cq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < sq) store2(o0 + 8 * j, acc[4 * j], acc[4 * j + 1]);
    if (r1 < sq) store2(o1 + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

struct Maps {
  CUtensorMap q, k, v, o;
};

// tensor maps for a launch: q and dO in boxes of `q_rows`, k and v of `k_rows`
cudaError_t make_maps(Maps* m, const Args& a, int d, int q_rows, int k_rows) {
  cudaError_t err = make_map(&m->q, a.q, d, a.h, a.sq, a.b, a.qs, q_rows);
  if (err == cudaSuccess) err = make_map(&m->o, a.dout, d, a.h, a.sq, a.b, a.os, q_rows);
  if (err == cudaSuccess) err = make_map(&m->k, a.k, d, a.hk, a.sk, a.b, a.ks, k_rows);
  if (err == cudaSuccess) err = make_map(&m->v, a.v, d, a.hk, a.sk, a.b, a.vs, k_rows);
  return err;
}

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, a, D, ROWS, BT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + ROWS - 1) / ROWS, a.b * a.h);
  flash_bwd_dq_wgmma_kernel<D><<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
      m.q, m.k, m.v, m.o, a.lse, a.delta, static_cast<bf16*>(a.dq), a.h, a.hk, a.sq, a.sk,
      a.causal, a.scale_log2, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  Maps m;
  cudaError_t err = make_maps(&m, a, D, BT, ROWS);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sk + ROWS - 1) / ROWS, a.b * a.hk);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
      m.q, m.k, m.v, m.o, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.h, a.hk, a.sq, a.sk, a.causal, a.scale_log2, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dq(int d, const Args& a, cudaStream_t stream) {
  if (d == 64) return launch_dq<64>(a, stream);
  if (d == 128) return launch_dq<128>(a, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_dkv(int d, const Args& a, cudaStream_t stream) {
  if (d == 64) return launch_dkv<64>(a, stream);
  if (d == 128) return launch_dkv<128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wg

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

// The dq and dk/dv kernels a launch runs (odh_flash::kernel_choice: 1 = the
// tensor-core pair, 0 = the scalar pair, -1 = unsupported);
// attention._bwd_kernel_for mirrors it in Python.
extern "C" int odh_flash_bwd_kernel(int dtype, int d) { return odh_flash::kernel_choice(dtype, d); }

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch, seq,
// head) for each of q/k/v/dO; the last dim must be contiguous. For the
// tensor-core kernels the base addresses must be 16-byte aligned and every
// stride a multiple of 16 bytes (TMA's rule). Each returns the launch's
// cudaError_t (0 on success); the launch is asynchronous on `stream`. A
// failed launch is returned, never retried on the other kernel.
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
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (odh_flash_bwd_kernel(dtype, d)) {
    case 1: return (int)wg::dispatch_dq(d, a, st);
    case 0: return (int)scalar::dispatch<scalar::LaunchDq>(dtype, d, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (odh_flash_bwd_kernel(dtype, d)) {
    case 1: return (int)wg::dispatch_dkv(d, a, st);
    case 0: return (int)scalar::dispatch<scalar::LaunchDkv>(dtype, d, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* odh_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
