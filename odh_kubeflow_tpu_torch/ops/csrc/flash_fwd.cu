// Flash-attention forward for Hopper (sm_90a), plain C interface loaded with
// ctypes by odh_kubeflow_tpu_torch/ops/attention.py.
//
// Replaces the TPU kernel odh_kubeflow_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_forward_kernel, pallas_call at :409). Same arithmetic:
// scores scaled by d**-0.5 * log2(e) after the product, in f32, and
// exponentiated with exp2, an online softmax carry (m, l, acc) in f32, p
// rounded to the input dtype before the P.V product, out = acc / max(l,
// 1e-30), optional lse = m*ln2 + ln(max(l, 1e-30)) in f32 laid out (b, h, sq).
// Masked scores are -1e30, as in the reference, so a row's first key tile
// (key 0 is always visible) gives every carry a finite max.
//
// Layout: q (b, sq, h, d), k/v (b, sk, hk, d), read in place through their
// strides (last dim contiguous); head j reads kv head j / (h / hk), so K/V
// are never expanded. o is contiguous (b, sq, h, d) in q's dtype. Causal key
// tiles wholly above the diagonal are never loaded, and q tiles run
// longest-first so the causal triangle's heavy blocks start early (the
// card's counterpart of the reference's balanced grid, _balanced_qk).
//
// Two kernels; odh_flash_fwd_kernel(dtype, d) below is the one place that
// chooses between them, by (dtype, d) alone:
//
// * flash_fwd_wgmma_kernel, bf16 at d 64 and 128 (the flagship model's d is
//   128). What bounds it on this card: at the training shape (b8 s2048 h8
//   d128, causal) the work is 68.75 GFLOP against 134.7 MB, so an ideal
//   kernel is bound by tensor-core operations (0.0695 ms at 989 TFLOP/s);
//   the scalar kernel below reached ~1% of that, fed from shared memory at
//   two loads per FMA. This one runs both products on the tensor cores:
//   - a producer (one thread of it starts every load) brings Q once and each
//     K and V tile by TMA (tensor maps built on the host over the strided
//     (b, s, heads, d) views, 128-byte swizzle, rows past the sequence
//     zero-filled) into two-stage K and V rings in shared memory, tracked by
//     mbarriers (full: the bytes landed; empty: every consumer warp is done),
//     so copies overlap compute and no thread spends registers on addresses;
//   - one or two consumer warpgroups of 64 q rows each (two, sharing every
//     K/V tile, when the grid of 128-row tiles fills the card; one for short
//     prompts). S = Q.K^T by wgmma m64n128k16 with both operands in shared
//     memory (d/16 k steps); the online softmax runs on the f32 accumulator
//     fragment in registers (row max and sum across a quad by shuffles, exp2
//     on the special-function unit); p, rounded to bf16 in registers, is the
//     A operand of O += P.V by wgmma RS with V read transposed from shared
//     memory: P never leaves registers;
//   - the softmax is as costly as the products here (each element's exp2
//     against 2*d multiply-adds), so it is hidden behind them twice: each
//     warpgroup starts S of tile j together with P.V of tile j-1 and runs
//     the softmax of tile j while that P.V is on the tensor cores; and two
//     warpgroups take turns to start their products (named barriers), so
//     one's softmax runs under the other's products. With two consumers the
//     producer is a whole warpgroup that gives its registers to them
//     (setmaxnreg 24 / 240): the two accumulators and P fit without
//     spilling, which ptxas otherwise answered by serialising the wgmmas;
//   - the mask is applied only on tiles that straddle the causal diagonal
//     or the ragged tail; out and lse are written straight from registers.
//   Each of these was timed on an H100 against the kernel without it and
//   kept because it was faster; a three-stage ring was not.
//
// * flash_fwd_scalar_kernel (the port's first forward kernel), f32 at every
//   d and bf16 at d 16 and 32. The tensor cores have no f32 product, and
//   TF32 would break the f32 gates (1e-4 against the plain version, the f32
//   greedy parity of the demo model with generate()). One 256-thread block
//   per (batch*head, 64 q rows), four threads per query row doing scalar
//   f32 FMAs fed from shared memory: bound by shared-memory bandwidth.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace odh_flash;

constexpr float LN2 = 0.6931471805599453f;

// ---- the scalar kernel: f32 at every d, bf16 at d 16 and 32 -----------------

namespace scalar {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per shared-memory tile
constexpr int LANES = 4;      // threads per query row
constexpr int THREADS = BQ * LANES;

template <typename T, int D>
constexpr size_t smem_bytes() {
  // q and k tiles padded to D + 2 elements per row, v unpadded, p in f32
  return (size_t)(BQ + BK) * (D + 2) * sizeof(T) + (size_t)BK * D * sizeof(T) +
         (size_t)BQ * (BK + 1) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
      pr[t + LANES * j] = round_to<T>(p);
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
      flash_fwd_scalar_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  flash_fwd_scalar_kernel<T, D><<<grid, THREADS, smem, stream>>>(
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

}  // namespace scalar

// ---- the tensor-core kernel: bf16 at d 64 and 128 ---------------------------

namespace wg {

using namespace odh_hopper;
using bf16 = __nv_bfloat16;

constexpr int BK = 128;       // key rows per K/V tile: the n of S's wgmma (m64n128k16)
constexpr int STAGES = 2;     // depth of each of the K and V rings
constexpr int PANEL = 64;     // bf16 columns per 128-byte swizzle panel
constexpr int ROW = 128;      // bytes per panel row
constexpr int ATOM = 1024;    // bytes per 8-row swizzle atom

template <int D, int NWG>
struct Cfg {
  static_assert(D == 64 || D == 128, "the tensor-core kernel takes d 64 or 128");
  static_assert(BK % (64 * NWG) == 0,
                "each K/V tile must start at or before every warpgroup's first row");
  static constexpr int BQ = 64 * NWG;              // q rows per block
  // consumer warpgroups, then the producer: with two consumers a whole
  // warpgroup, whose registers they take over (setmaxnreg); else one warp
  static constexpr int PRODUCER = NWG == 2 ? 128 : 32;
  static constexpr int THREADS = 128 * NWG + PRODUCER;
  static constexpr int PANELS = D / PANEL;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or one V tile
  // 1024 bytes of slack to align the tiles to the swizzle atom, then Q, the
  // K ring, the V ring, and the barriers (q_full, then full and empty for
  // each stage of each ring)
  static constexpr int SMEM = ATOM + Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 4 * STAGES) * 8;
};

// The online softmax of one tile on the S accumulator fragment (rows r0 and
// r0 + 8 of this thread): scale after the product, mask where the tile
// straddles the diagonal or the tail, new max, alpha (the rescale owed to
// acc), p in f32 in place of the scores, l updated with the f32 p.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float& m0, float& m1, float& l0,
                                               float& l1, float& al0, float& al1, int k0, int sk,
                                               int r0, int cq, bool masked, int causal,
                                               float scale_log2) {
  const int r1 = r0 + 8;
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = sc[i] * scale_log2;
    if (masked) {
      const int col = k0 + 8 * (i / 4) + cq + (i & 1);
      const int row = (i & 2) ? r1 : r0;
      if (col >= sk || (causal && col > row)) x = NEG_INF;
    }
    sc[i] = x;
    if (i & 2) mx1 = fmaxf(mx1, x);
    else mx0 = fmaxf(mx0, x);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = ex2_approx(m0 - mn0);
  al1 = ex2_approx(m1 - mn1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float p = ex2_approx(sc[i] - ((i & 2) ? mn1 : mn0));
    if (i & 2) ps1 += p;
    else ps0 += p;
    sc[i] = p;
  }
  ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
  ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
  ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
  ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
  l0 = l0 * al0 + ps0;
  l1 = l1 * al1 + ps1;
  m0 = mn0;
  m1 = mn1;
}

template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                       float* __restrict__ lse, int h, int hk, int sq, int sk, int causal,
                       float scale_log2) {
  using C = Cfg<D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((ATOM - (smem_u32(smem_raw) & (ATOM - 1))) & (ATOM - 1));
  unsigned char* Qs = smem;                        // panel p of row r: p * BQ * ROW + r * ROW
  unsigned char* Ks = Qs + C::Q_BYTES;             // stage s, panel p: s * KV_BYTES + p * BK * ROW
  unsigned char* Vs = Ks + STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;       // a K tile landed
  uint64_t* k_empty = k_full + STAGES; // every consumer warp is done with it
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;  // longest-first
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hi = bh % h;
  const int kvh = hi / (h / hk);
  const int q_last = min(q0 + C::BQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * NWG);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * NWG) {
    // the producer: one thread starts every load, then leaves
    if constexpr (C::PRODUCER == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * NWG) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p)
        tma_load_4d(Qs + p * C::BQ * ROW, &tq, q_full, p * PANEL, hi, q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        const uint32_t reuse = ((kt / STAGES) - 1) & 1;  // the phase that freed the stage
        // K first: the consumers need K of a tile one step before its V
        if (kt >= STAGES) mbar_wait(&k_empty[s], reuse);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_4d(Ks + s * C::KV_BYTES + p * BK * ROW, &tk, &k_full[s], p * PANEL, kvh,
                      kt * BK, b);
        if (kt >= STAGES) mbar_wait(&v_empty[s], reuse);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_4d(Vs + s * C::KV_BYTES + p * BK * ROW, &tv, &v_full[s], p * PANEL, kvh,
                      kt * BK, b);
      }
    }
    return;
  }
  if constexpr (C::PRODUCER == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");

  // a consumer warpgroup: 64 q rows; this thread holds rows r0 and r0 + 8
  const int wgi = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wq0 = q0 + 64 * wgi;
  const int r0 = wq0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const int cq = 2 * (lane % 4);  // this thread's first column in each 8-column group
  const unsigned char* Qw = Qs + 64 * wgi * ROW;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];              // S of this step's tile, then its p in f32
  uint32_t pa[BK / 16][4];       // p of the previous tile in bf16: P.V's A operand
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float al0 = 1.f, al1 = 1.f;    // rescale of acc owed before the next P.V

  // S = Q.K^T: both operands K-major in shared memory; k step kk reads
  // columns 16kk..16kk+15, 32 bytes into panel kk / 4
  auto mma_s = [&](int s) {
    const unsigned char* Kt = Ks + s * C::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, col = (kk % 4) * 32;
      wgmma_m64n128k16_ss<0>(sc, desc_sw128(Qw + p * C::BQ * ROW + col, 16, ATOM),
                             desc_sw128(Kt + p * BK * ROW + col, 16, ATOM), kk > 0);
    }
    wgmma_commit();
    wgmma_fence_regs(sc);
  };
  // O = alpha * O + P.V: V is the k x n operand read transposed (MN-major):
  // k step kk is rows 16kk..16kk+15, n runs across the d panels
  auto mma_pv = [&](int s) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;
    const unsigned char* Vt = Vs + s * C::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1>(acc, pa[kk], desc_sw128(Vt + kk * 2 * ATOM, BK * ROW, ATOM), 1);
    wgmma_commit();
    wgmma_fence_regs(acc);
  };
  auto softmax = [&](int kt) {
    const int k0 = kt * BK;
    const bool masked = (k0 + BK > sk) || (causal && k0 + BK - 1 > wq0);
    online_softmax(sc, m0, m1, l0, l1, al0, al1, k0, sk, r0, cq, masked, causal, scale_log2);
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);  // this warp is done with the stage
  };
  // With two warpgroups each starts its products only in its turn (named
  // barriers 1 and 2), so one's products run while the other does its
  // softmax; the last hand-over of the second warpgroup has no taker
  constexpr int PAIR = 2 * 128;
  auto my_turn = [&]() {
    if (NWG == 2) named_bar_sync(1 + wgi, PAIR);
  };
  auto your_turn = [&](bool last) {
    if (NWG == 2 && !(last && wgi == 1)) named_bar_arrive(1 + (wgi ^ 1), PAIR);
  };
  if (NWG == 2 && wgi == 1) named_bar_arrive(1, PAIR);  // warpgroup 0 first

  // tile 0: its S and softmax
  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  my_turn();
  mma_s(0);
  your_turn(false);
  wgmma_wait<0>();
  wgmma_fence_regs(sc);
  release(&k_empty[0]);
  softmax(0);
  pack_p();
  // step kt: S of tile kt and P.V of tile kt-1 go to the tensor cores
  // together; the softmax of tile kt runs while that P.V does
  for (int kt = 1; kt < n_tiles; ++kt) {
    const int s = kt % STAGES;
    const int sp = (kt - 1) % STAGES;
    mbar_wait(&k_full[s], (kt / STAGES) & 1);
    mbar_wait(&v_full[sp], ((kt - 1) / STAGES) & 1);
    my_turn();
    mma_s(s);
    mma_pv(sp);
    your_turn(false);
    wgmma_wait<1>();
    wgmma_fence_regs(sc);
    release(&k_empty[s]);
    softmax(kt);
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    release(&v_empty[sp]);
    pack_p();  // the previous P.V has finished reading pa
  }
  // the last tile's P.V
  {
    const int sp = (n_tiles - 1) % STAGES;
    mbar_wait(&v_full[sp], ((n_tiles - 1) / STAGES) & 1);
    my_turn();
    mma_pv(sp);
    your_turn(true);
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    release(&v_empty[sp]);
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* o0 = o + (((int64_t)b * sq + r0) * h + hi) * D + cq;
  bf16* o1 = o + (((int64_t)b * sq + r1) * h + hi) * D + cq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < sq) store2(o0 + 8 * j, acc[4 * j] / d0, acc[4 * j + 1] / d0);
    if (r1 < sq) store2(o1 + 8 * j, acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
  if (lse != nullptr && lane % 4 == 0) {
    if (r0 < sq) lse[(int64_t)bh * sq + r0] = m0 * LN2 + logf(d0);
    if (r1 < sq) lse[(int64_t)bh * sq + r1] = m1 * LN2 + logf(d1);
  }
}

// cuTensorMapEncodeTiled is not in the runtime library; its address comes
// from the runtime's entry-point query, so the library links no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A tensor map over a (b, seq, heads, d) bf16 view with element strides
// st = (batch, seq, head), last dim contiguous: boxes of 64 columns x 1 head
// x `rows` rows, 128-byte swizzle, rows past `seq` read as zeros
cudaError_t make_map(CUtensorMap* map, const void* base, int d, int heads, int seq, int batch,
                     const int64_t* st, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  for (cuuint64_t x : strides)
    if (x % 16 != 0 || x >= (1ull << 40)) return cudaErrorInvalidValue;
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
                   int sk, int h, int hk, const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   int causal, float scale_log2, cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, D, h, sq, b, qs, C::BQ);
  if (err == cudaSuccess) err = make_map(&mk, k, D, hk, sk, b, ks, BK);
  if (err == cudaSuccess) err = make_map(&mv, v, D, hk, sk, b, vs, BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, NWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, b * h);
  flash_fwd_wgmma_kernel<D, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, h, hk, sq, sk, causal, scale_log2);
  return cudaGetLastError();
}

// q rows per block: two warpgroups (128 rows) when the grid of 128-row
// tiles covers every SM at least once, one (64 rows) for shorter work such
// as a serving prefill (b1 s128 h8 is 8 blocks of 128 rows on 132 SMs)
int tile_q(int b, int sq, int h) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  return (int64_t)((sq + 127) / 128) * b * h >= sms ? 128 : 64;
}

cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                     int b, int sq, int sk, int h, int hk, const int64_t* qs, const int64_t* ks,
                     const int64_t* vs, int causal, float scale_log2, cudaStream_t stream) {
  const bool two = tile_q(b, sq, h) == 128;
  if (d == 64)
    return two ? launch<64, 2>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, stream)
               : launch<64, 1>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, stream);
  if (d == 128)
    return two ? launch<128, 2>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, stream)
               : launch<128, 1>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, stream);
  return cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

// The one place the forward kernel is chosen, by (dtype, d) alone (0 =
// float32, 1 = bfloat16): 1 = the tensor-core kernel (bf16, d 64 or 128),
// 0 = the scalar kernel (f32 at d 16/32/64/128, bf16 at d 16 or 32), -1 =
// unsupported. attention._fwd_kernel_for mirrors it in Python.
extern "C" int odh_flash_fwd_kernel(int dtype, int d) {
  const bool known_d = d == 16 || d == 32 || d == 64 || d == 128;
  if (!known_d || (dtype != 0 && dtype != 1)) return -1;
  return (dtype == 1 && (d == 64 || d == 128)) ? 1 : 0;
}

// q rows per block of the kernel odh_flash_fwd would launch for this call
extern "C" int odh_flash_fwd_tile_q(int dtype, int d, int b, int sq, int h) {
  return odh_flash_fwd_kernel(dtype, d) == 1 ? wg::tile_q(b, sq, h) : scalar::BQ;
}

// Strides are in elements, (batch, seq, head) for each of q/k/v; the last
// dim must be contiguous. For the tensor-core kernel the base addresses must
// be 16-byte aligned and every stride a multiple of 16 bytes (TMA's rule).
// lse may be null. Returns the launch's cudaError_t (0 on success); the
// launch is asynchronous on `stream`. A failed launch is returned, never
// retried on the other kernel.
extern "C" int odh_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int dtype, int b, int sq,
                             int sk, int h, int hk, int d, const int64_t* qs,
                             const int64_t* ks, const int64_t* vs, int causal,
                             float scale_log2, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (odh_flash_fwd_kernel(dtype, d)) {
    case 1:
      return (int)wg::dispatch(d, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, st);
    case 0:
      if (dtype == 0)
        return (int)scalar::dispatch_d<float>(d, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, st);
      return (int)scalar::dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* odh_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
