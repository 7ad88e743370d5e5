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
// Two kernels, chosen by (dtype, d) alone by the rule the backward follows
// too (odh_flash::kernel_choice, flash_common.cuh):
//
// * flash_fwd_wgmma_kernel, bf16 at d 64 and 128 (the flagship model's d is
//   128). What bounds it on this card: at the training shape (b8 s2048 h8
//   d128, causal) the work is 68.75 GFLOP against 134.7 MB, so an ideal
//   kernel is bound by tensor-core operations (0.0695 ms at 989 TFLOP/s);
//   a scalar kernel fed from shared memory at two loads per FMA reached ~1%
//   of that. This one runs both products on the tensor cores:
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
// * flash_fwd_scalar_kernel, f32 at every d and bf16 at d 16 and 32 (the
//   f32 demo model's d 16, the f32 gradient check's d 128). Every product is
//   an f32 FMA on the CUDA cores, with no TF32 of any kind: the tensor cores
//   have no f32 product, and TF32 (one pass, ~3 decimal digits, or split
//   into three passes) would break the f32 gates (1e-4 against the plain
//   version, the gradient check, the demo model's exact greedy parity with
//   generate()) or take away the reason the (dtype, d) rule gives.
//   What bounds it on this card: the f32 FMA rate (67 TFLOP/s), and ahead
//   of it shared memory, which hands an SM 32 f32 values a clock against
//   its 128 FMAs, and at the main-path shapes (b1 s128 and s512, h8) the
//   number of blocks: the kernel this one replaced did one FMA per shared
//   load, in one dependent chain per score, on 16 blocks at b1 s128 h8
//   (0.061 ms). So:
//   - register tiles: a thread owns RQ q rows x CK keys of each S tile and
//     reads Q and K rows (row-major, padded 16 bytes against bank
//     conflicts) four d at a time, RQ + CK loads for 4*RQ*CK independent
//     FMAs; for P.V its rows x runs of 4 (2 at d 16) of O's columns, P read
//     four keys at a time and V rows as float4. P goes through shared
//     memory in f32 (rounded to the input dtype), only within its warp;
//   - a grid that fills the card: 64 q rows a block (4 x 4 a thread, 128
//     threads, 32-key tiles), else 32 or 16 (2 x 4 or 1 x 4, 256 threads,
//     64-key tiles) where the larger tile's grid, split over clusters, gives
//     fewer than three quarters of the SMs a block (odh_flash::scalar_tile);
//     and where the grid still leaves SMs idle, clusters of 2 or 4 blocks
//     share one q tile, each taking every 2nd or 4th key tile, and merge
//     their (m, l, acc) through distributed shared memory (each block
//     finishes a share of the rows), so b1 s128 h8 runs 128 blocks and the
//     gradient check's s512 256 (odh_flash::scalar_split);
//   - async copies: K/V tiles come through a two-stage cp.async ring, 16
//     bytes a copy where q, k and v allow it (base and strides multiples of
//     16 bytes), else 4; the next tile's copies run under this tile's
//     products. Longest q tiles first; the mask only on tiles that straddle
//     the diagonal or the ragged tail.
//   ptxas (CUDA 12.8): 64-row tiles 168 registers at f32 d128, 128-144 at
//   d64, 96 at d32, 80 at d16, 96-124 in bf16; 16- and 32-row tiles 64-88,
//   spilling 16-20 bytes at f32 d128 (32-row tiles), d64 (32-row, unsplit)
//   and d16 (16-row, unsplit). Timed on an H100 against this design, one variant at a time in
//   a single run (a probe built from switches in this source, not kept),
//   and not kept, each slower at b1 s128 or s512 h8 d128: 8 lanes a row at
//   16- and 32-row tiles; 32 lanes; two rows a thread at 16-row tiles (64
//   threads); 32-key tiles beside 16 or 32 q rows; 64-key tiles beside 64;
//   the tile chosen by the unsplit grid alone (16 rows at s512); no
//   clusters; clusters of at most 2 blocks (slower at s512).

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace odh_flash;

constexpr float LN2 = 0.6931471805599453f;

// ---- the scalar kernel: f32 at every d, bf16 at d 16 and 32 -----------------

namespace scalar {

// A block's geometry: BQ q rows, BK keys per K/V tile; RQ q rows a thread
// owns, LANES threads along a row (its key columns, then O's d columns); KS
// blocks in a cluster share the q rows and split the key tiles
template <typename T, int D, int BQ, int BK, int RQ, int LANES, int KS>
struct Cfg {
  static_assert(BQ % RQ == 0 && BK % LANES == 0 && BK % 4 == 0 && D % (2 * LANES) == 0 &&
                    LANES <= 32 && (KS == 1 || KS == 2 || KS == 4),
                "tile shapes");
  static constexpr int ROW_GROUPS = BQ / RQ;     // threads along the q rows
  static constexpr int THREADS = ROW_GROUPS * LANES;
  static constexpr int CK = BK / LANES;          // key columns a thread owns
  static constexpr int VEC = D / LANES >= 4 ? 4 : 2;  // O columns per contiguous run of a thread
  static constexpr int NV = D / (LANES * VEC);   // runs per O row of a thread
  static constexpr int QS = D + 16 / (int)sizeof(T);  // Q and K row stride: 16 bytes of pad
  static constexpr int PS = BK + 8;              // P row stride (f32): a warp's rows on distinct banks
  static constexpr int Q_BYTES = BQ * QS * (int)sizeof(T);
  static constexpr int K_BYTES = BK * QS * (int)sizeof(T);  // one stage of the K ring
  static constexpr int V_BYTES = BK * D * (int)sizeof(T);   // one stage of the V ring
  static constexpr int SMEM = Q_BYTES + 2 * (K_BYTES + V_BYTES) + BQ * PS * 4;
  // the cluster's exchange at the end (m, l and acc of every row, f32)
  // reuses the K/V ring
  static_assert(BQ * (D + 2) * 4 <= 2 * (K_BYTES + V_BYTES), "exchange fits in the ring");
};

// One cluster of KS blocks per (batch*head, BQ q rows); block r of the
// cluster takes key tiles r, r + KS, ... Row group g owns the RQ q rows g,
// g + ROW_GROUPS, ... and its lane the CK key columns lane, lane + LANES,
// ... of each key tile; a row's lanes reduce its max and sum by shuffles.
// See the file's header.
template <typename T, int D, int BQ, int BK, int RQ, int LANES, int KS>
__global__ void __launch_bounds__(Cfg<T, D, BQ, BK, RQ, LANES, KS>::THREADS)
flash_fwd_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int h, int hk, int sq, int sk,
                        int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                        int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                        int64_t vsh, int causal, float scale_log2, int vec16) {
  using C = Cfg<T, D, BQ, BK, RQ, LANES, KS>;
  constexpr int ROW_GROUPS = C::ROW_GROUPS, THREADS = C::THREADS;
  constexpr int CK = C::CK, VEC = C::VEC, NV = C::NV, QS = C::QS, PS = C::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + C::Q_BYTES);                    // stage s at s * BK * QS
  T* Vs = reinterpret_cast<T*>(smem + C::Q_BYTES + 2 * C::K_BYTES);   // stage s at s * BK * D
  float* Ps = reinterpret_cast<float*>(smem + C::Q_BYTES + 2 * (C::K_BYTES + C::V_BYTES));

  const int tid = threadIdx.x;
  const int rg = tid / LANES;
  const int lane = tid % LANES;
  const int rank = KS == 1 ? 0 : (int)blockIdx.x % KS;   // this block's place in its cluster
  const int q0 = (gridDim.x / KS - 1 - blockIdx.x / KS) * BQ;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hi = bh % h;
  const int kvh = hi / (h / hk);
  const T* qb = q + b * qsb + hi * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int n_mine = (n_tiles - rank + KS - 1) / KS;   // key tiles rank, rank + KS, ...

  // Q rides in the first copy group with this block's first K/V tile; rows
  // past the sequence are zero, so their p is finite and 0 * garbage never
  // happens
  auto load_kv = [&](int i) {
    const int s = i & 1, k0 = (rank + KS * i) * BK;
    async_rows<T, D, BK, THREADS>(Ks + s * BK * QS, QS, kb, kss, k0, sk, vec16);
    async_rows<T, D, BK, THREADS>(Vs + s * BK * D, D, vb, vss, k0, sk, vec16);
    cp_async_commit();
  };
  if (n_mine > 0) {
    async_rows<T, D, BQ, THREADS>(Qs, QS, qb, qss, q0, sq, vec16);
    load_kv(0);
  }

  float m[RQ], l[RQ], acc[RQ][NV * VEC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV * VEC; ++e) acc[i][e] = 0.f;
  }

  for (int it = 0; it < n_mine; ++it) {
    cp_async_wait_all();
    __syncthreads();  // this tile is visible, and every thread is done with the last one
    if (it + 1 < n_mine) load_kv(it + 1);  // lands while this tile is computed
    const T* Kt = Ks + (it & 1) * BK * QS;
    const T* Vt = Vs + (it & 1) * BK * D;
    const int k0 = (rank + KS * it) * BK;

    // S = Q.K^T: RQ x CK independent sums, four d at a time: RQ + CK
    // shared loads of four values for 4 * RQ * CK FMAs
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qa[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qa[i] = load4(Qs + (rg + ROW_GROUPS * i) * QS + d0);
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float4 kk = load4(Kt + (lane + LANES * j) * QS + d0);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          s[i][j] = fmaf(qa[i].x, kk.x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kk.y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kk.z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kk.w, s[i][j]);
        }
      }
    }

    // the online softmax of each row; the tile needs elementwise masking
    // only on the ragged tail and where it straddles the causal diagonal
    const bool masked = (k0 + BK > sk) || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q0 + rg + ROW_GROUPS * i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float x = s[i][j] * scale_log2;  // log2-domain score
        const int kp = k0 + lane + LANES * j;
        if (masked && (kp >= sk || (causal && kp > q_pos))) x = NEG_INF;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int w = 1; w < LANES; w *= 2)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, w));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        psum += p;  // l sums the f32 p; acc takes p in the input dtype
        Ps[(rg + ROW_GROUPS * i) * PS + lane + LANES * j] = round_to<T>(p);
      }
#pragma unroll
      for (int w = 1; w < LANES; w *= 2) psum += __shfl_xor_sync(0xffffffffu, psum, w);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NV * VEC; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();  // a row group's P rows are written and read by its own warp

    // O += P.V: this thread's rows x its runs of O's columns, four keys at a
    // time from its P rows (RQ loads) and the four V rows (NV loads each)
#pragma unroll 2
    for (int c0 = 0; c0 < BK; c0 += 4) {
      float4 pa[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (rg + ROW_GROUPS * i) * PS + c0);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const T* vr = Vt + (c0 + cc) * D + VEC * lane;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float w[VEC];
          load_n<VEC>(vr + LANES * VEC * n, w);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][n * VEC + e] = fmaf(p, w[e], acc[i][n * VEC + e]);
          }
        }
      }
    }
  }

  // A cluster merges its blocks' carries through distributed shared memory:
  // each block puts (m, l, acc) of every row in its own ring, and block r
  // finishes the rows r, r + KS, ... with M = max m, L = sum l * 2^(m - M)
  // and acc = sum acc * 2^(m - M), summed in block order
  if constexpr (KS > 1) {
    float* X = reinterpret_cast<float*>(smem + C::Q_BYTES);  // row r: m, l, then D of acc
    __syncthreads();  // every thread is done with the ring
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float* xr = X + (rg + ROW_GROUPS * i) * (D + 2);
      if (lane == 0) {
        xr[0] = m[i];
        xr[1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e) xr[2 + VEC * lane + LANES * VEC * n + e] = acc[i][n * VEC + e];
    }
    cooperative_groups::this_cluster().sync();  // every block's carries are visible to the cluster
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = rg + ROW_GROUPS * i;
      if (row % KS != rank) continue;
      const float* xs[KS];
#pragma unroll
      for (int r = 0; r < KS; ++r)
        xs[r] = cooperative_groups::this_cluster().map_shared_rank(X, r) + row * (D + 2);
      float mm = NEG_INF;
#pragma unroll
      for (int r = 0; r < KS; ++r) mm = fmaxf(mm, xs[r][0]);
      float ll = 0.f, f[KS];
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        f[r] = exp2f(xs[r][0] - mm);
        ll += xs[r][1] * f[r];
      }
      m[i] = mm;
      l[i] = ll;
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float a = 0.f;
#pragma unroll
          for (int r = 0; r < KS; ++r) a += xs[r][2 + VEC * lane + LANES * VEC * n + e] * f[r];
          acc[i][n * VEC + e] = a;
        }
    }
    cooperative_groups::this_cluster().sync();  // no block leaves while another reads it
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = rg + ROW_GROUPS * i;
    const int q_pos = q0 + row;
    if (q_pos >= sq || row % KS != rank) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((int64_t)(b * sq + q_pos) * h + hi) * D + VEC * lane;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      float x[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = acc[i][n * VEC + e] / denom;
      store_n<VEC>(orow + LANES * VEC * n, x);
    }
    if (lse != nullptr && lane == 0) lse[(int64_t)bh * sq + q_pos] = m[i] * LN2 + logf(denom);
  }
}

// keys per K/V tile: 32 beside 64 q rows (four rows by four keys a thread),
// else 64
constexpr int key_tile(int bq) { return bq == 64 ? 32 : 64; }

template <typename T, int D, int BQ, int KS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int sk, int h, int hk,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   int causal, float scale_log2, int vec16, cudaStream_t stream) {
  // 64 q rows: 16 row groups of 4 rows x 8 lanes; 32 and 16 rows: row
  // groups of 2 or 1 rows x 16 lanes (8 at d 16), so short work still
  // has 256 threads a block
  constexpr int BK = key_tile(BQ);
  constexpr int LANES = BQ == 64 || D == 16 ? 8 : 16;
  constexpr int RQ = BQ / 16;
  using C = Cfg<T, D, BQ, BK, RQ, LANES, KS>;
  auto kernel = flash_fwd_scalar_kernel<T, D, BQ, BK, RQ, LANES, KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ * KS, b * h);
  return launch_clustered(kernel, grid, C::THREADS, C::SMEM, KS, stream,
                          static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v), static_cast<T*>(o), lse, h, hk, sq, sk,
                          qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], causal,
                          scale_log2, vec16);
}

// q rows per block and blocks per cluster (the key tiles of the longest
// rows split between them): the grid's size decides (odh_flash::scalar_tile
// and scalar_split)
int tile_q(int b, int sq, int h) { return scalar_tile(sq, (int64_t)b * h); }

int key_split(int b, int sq, int sk, int h, int causal) {
  const int tile = tile_q(b, sq, h);
  const int keys = causal ? min(sk, sq) : sk;
  return scalar_split(sq, (int64_t)b * h, tile, (keys + key_tile(tile) - 1) / key_tile(tile), 4);
}

template <typename T, int D>
cudaError_t launch_tile(int tile, int split, const void* q, const void* k, const void* v, void* o,
                        float* lse, int b, int sq, int sk, int h, int hk, const int64_t* qs,
                        const int64_t* ks, const int64_t* vs, int causal, float scale_log2,
                        int vec16, cudaStream_t stream) {
#define ODH_LAUNCH(BQ, KS) \
  launch<T, D, BQ, KS>(q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, vec16, stream)
  if (split == 4) {
    switch (tile) {
      case 64: return ODH_LAUNCH(64, 4);
      case 32: return ODH_LAUNCH(32, 4);
      default: return ODH_LAUNCH(16, 4);
    }
  }
  if (split == 2) {
    switch (tile) {
      case 64: return ODH_LAUNCH(64, 2);
      case 32: return ODH_LAUNCH(32, 2);
      default: return ODH_LAUNCH(16, 2);
    }
  }
  switch (tile) {
    case 64: return ODH_LAUNCH(64, 1);
    case 32: return ODH_LAUNCH(32, 1);
    default: return ODH_LAUNCH(16, 1);
  }
#undef ODH_LAUNCH
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, float* lse, int b, int sq, int sk, int h,
                       int hk, const int64_t* qs, const int64_t* ks,
                       const int64_t* vs, int causal, float scale_log2,
                       cudaStream_t stream) {
  constexpr int E = sizeof(T);
  // every view 4-byte aligned (the wrapper copies one that is not), and
  // 16-byte copies where all three allow them
  if (!aligned_to(q, qs, E, 4) || !aligned_to(k, ks, E, 4) || !aligned_to(v, vs, E, 4))
    return cudaErrorMisalignedAddress;
  const int vec16 = aligned_to(q, qs, E, 16) && aligned_to(k, ks, E, 16) && aligned_to(v, vs, E, 16);
  const int tile = tile_q(b, sq, h);
  const int split = key_split(b, sq, sk, h, causal);
  if (d == 16) return launch_tile<T, 16>(tile, split, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, vec16, stream);
  if (d == 32) return launch_tile<T, 32>(tile, split, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, vec16, stream);
  if constexpr (E == 4) {  // bf16 at d 64 and 128 is the tensor-core kernel's
    if (d == 64) return launch_tile<T, 64>(tile, split, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, vec16, stream);
    if (d == 128) return launch_tile<T, 128>(tile, split, q, k, v, o, lse, b, sq, sk, h, hk, qs, ks, vs, causal, scale_log2, vec16, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace scalar

// ---- the tensor-core kernel: bf16 at d 64 and 128 ---------------------------

namespace wg {

using namespace odh_hopper;
using bf16 = __nv_bfloat16;

constexpr int BK = 128;       // key rows per K/V tile: the n of S's wgmma (m64n128k16)
constexpr int STAGES = 2;     // depth of each of the K and V rings

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
  return (int64_t)((sq + 127) / 128) * b * h >= sm_count() ? 128 : 64;
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

// The forward kernel a launch runs (odh_flash::kernel_choice: 1 = the
// tensor-core kernel, 0 = the scalar one, -1 = unsupported);
// attention._fwd_kernel_for mirrors it in Python.
extern "C" int odh_flash_fwd_kernel(int dtype, int d) { return odh_flash::kernel_choice(dtype, d); }

// q rows per block of the kernel odh_flash_fwd would launch for this call
extern "C" int odh_flash_fwd_tile_q(int dtype, int d, int b, int sq, int h) {
  return odh_flash_fwd_kernel(dtype, d) == 1 ? wg::tile_q(b, sq, h) : scalar::tile_q(b, sq, h);
}

// blocks per cluster of the kernel odh_flash_fwd would launch for this call
// (the scalar kernel's key split; the tensor-core kernel takes no clusters)
extern "C" int odh_flash_fwd_key_split(int dtype, int d, int b, int sq, int sk, int h, int causal) {
  return odh_flash_fwd_kernel(dtype, d) == 1 ? 1 : scalar::key_split(b, sq, sk, h, causal);
}

// Strides are in elements, (batch, seq, head) for each of q/k/v; the last
// dim must be contiguous. For the tensor-core kernel the base addresses must
// be 16-byte aligned and every stride a multiple of 16 bytes (TMA's rule);
// for the scalar kernel, which copies with cp.async, multiples of 4 bytes
// (16-byte copies where all three views allow them). lse may be null. Returns the launch's cudaError_t (0 on success); the
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
