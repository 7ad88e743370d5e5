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
// * The scalar kernels, f32 at every d and bf16 at d 16 and 32 (the f32
//   gradient check's d 128). Every product is an f32 FMA on the CUDA cores,
//   with no TF32 of any kind: the tensor cores have no f32 product, and TF32
//   (one pass, ~3 decimal digits, or split into three passes) would break
//   the f32 gates (1e-5 against the plain version, the gradient check of
//   the train step) or take away the reason the (dtype, d) rule gives.
//   - dq (flash_bwd_dq_scalar_kernel), in the forward's frame. What bounds
//     it on this card: the f32 FMA rate (6*d flops per visible pair: 0.0120
//     ms at b1 s512 h8 d128), and ahead of it shared memory and the number
//     of blocks, as for dk/dv below; the kernel this one replaced did one FMA
//     per shared load on 64 blocks (0.365 ms). So:
//     . register tiles: one block per (batch*head, BQ q rows), 16 row groups
//       of 16 lanes (8 at d 16); Q and dO rows stay resident (rows padded 16
//       bytes), each row's lse*log2(e) and delta in registers; a thread owns
//       BQ/16 q rows x 4 keys (8 at d 16) of S and dP in each 64-key tile,
//       read four d at a time, 2 * (rows + keys) loads for 8 * rows * keys
//       FMAs; dS, rounded to K's dtype, goes to shared memory (f32) only
//       within the warp; then the thread owns its q rows x runs of 4 (2 at d
//       16 and 32) of dq's columns, in f32 registers, with dS read four keys
//       at a time and K rows as float4; dq is rounded once, when written;
//     . a grid that fills the card: the q tile by the forward's rule
//       (odh_flash::scalar_tile: 64, else 32, else 16), and where the grid
//       still leaves SMs idle, clusters of 2 blocks share one q tile, each
//       taking every other key tile, and add their dq through distributed
//       shared memory in block order (no atomics, no rescale: the lse is
//       given), each block writing a share of the rows; b1 s512 h8 runs 128
//       blocks of 64 rows;
//     . async copies: K/V tiles stream through a two-stage cp.async ring
//       (16-byte copies where q, k, v and dO allow, else 4); the next tile's
//       copies run under this tile's products. Longest q tiles first; the
//       mask only on tiles that straddle the diagonal or a ragged tail.
//     At f32 d128 a 64-row block holds 218 KB of shared memory (Q and dO,
//     the K/V ring, dS), so it needs a whole SM. ptxas (CUDA 12.8): 64-row
//     tiles 204 registers at f32 d128, 125-128 at d64, 130-166 at d32, 220
//     at d16, 128-168 in bf16; 32- and 16-row tiles 48-116; 8-40 bytes
//     spilled in five of the 36 (one the 64-row f32 d32 tile in clusters).
//     Timed on an H100 80GB HBM3 (700 W) at b1 s512 h8 d128 f32 causal by
//     tools/scalar_dq_variants.py, in turns in one run: clusters of at most
//     2 blocks 0.0577 and 0.0581 ms (kept); of at most 4, 0.0670 and 0.0667
//     ms (256 blocks of a whole SM each: two waves on 132 SMs); 32-key tiles
//     with 8 lanes (4 x 4 a thread, 128 threads) 0.0661 ms with at most 2
//     blocks a cluster, 0.0742 with at most 4.
//   - dk/dv (flash_bwd_dkv_scalar_kernel), in the transposed frame. What
//     bounds it on this card: the f32 FMA rate (8*d flops per visible pair:
//     0.0161 ms at b1 s512 h8 d128), and ahead of it shared memory (32 f32
//     values a clock per SM against 128 FMAs) and the number of blocks; the
//     kernel this one replaced did one FMA per shared load on 64 blocks
//     (0.389 ms). So:
//     . register tiles: one block per (batch*kv_head, BKR k rows), 16 row
//       groups of 8 lanes (16 beside 64 k rows at d >= 32); a thread owns
//       BKR/16 k rows x BQT/lanes q columns of S^T and dP^T, read from K
//       and V (resident) and Q and dO (streamed)
//       four d at a time, 2 * (rows + columns) loads for 8 * rows * columns
//       FMAs; P^T and dS^T, rounded, go to shared memory (f32) only within
//       the warp; then it owns its k rows x runs of 4 (2 at d 16) of dK's
//       and dV's columns, in f32 registers across the whole GQA group, with
//       P^T and dS^T read four q rows at a time and Q and dO rows as float4;
//     . a grid that fills the card: BKR = 64 k rows (4 x 2 a thread at d
//       128, where the q tile is 32 rows), else 32 or 16, by the same rule
//       as the forward (odh_flash::scalar_tile), and where the grid still
//       leaves SMs idle, clusters of 2 blocks share one k tile, each taking
//       every other streamed q tile, and add their dK and dV through
//       distributed shared memory in block order (no atomics: the same
//       result every run), so b1 s512 hk8 runs 128 blocks of 64 rows;
//     . async copies: Q and dO tiles, with their lse and delta, stream
//       through a two-stage cp.async ring over the GQA group's heads and
//       the q tiles from the diagonal on (16-byte copies where q, k, v and
//       dO allow, else 4); the next tile's copies run under this tile's
//       products. The mask only on tiles that straddle the diagonal or a
//       ragged tail.
//     ptxas (CUDA 12.8): 64-row tiles 183-197 registers at f32 d128, 168-174
//     at f32 d 64 and 32, 230-234 at f32 d16, 128-167 in bf16; 32-row tiles
//     96-198, 16-row 72-114; 8-32 bytes spilled in six of the 36. Timed on an H100 against this design, one
//     variant at a time in a single run (a probe built from switches in
//     this source, not kept), and not kept, each slower at b1 s512 h8 d128:
//     16-row k tiles by the grid of unsplit tiles alone (one k row a thread,
//     or two on 64 threads); 32-row tiles with or without clusters, with
//     32- or 64-row q tiles; 64-row tiles without clusters, or with 8 lanes
//     a k row, or with 16-row q tiles at d 128 (two blocks an SM); 16 lanes
//     beside 16 or 32 k rows; clusters of 4 blocks (faster at b2 s1024 GQA
//     8/2 d64, slower on the main path's shape, where a 64-row block needs
//     a whole SM).

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

// A dq block's geometry: BQ q rows (resident, with their dO rows), BK keys
// per streamed K/V tile; RQ q rows a thread owns, LANES threads along a q
// row (its key columns of S and dP, then its runs of dq's d columns); KS
// blocks in a cluster share the q rows and split the key tiles
template <typename T, int D, int BQ, int BK, int RQ, int LANES, int KS>
struct DqCfg {
  static_assert(BQ % RQ == 0 && BK % LANES == 0 && BK % 4 == 0 && D % (2 * LANES) == 0 &&
                    LANES <= 32 && (KS == 1 || KS == 2 || KS == 4),
                "tile shapes");
  static constexpr int ROW_GROUPS = BQ / RQ;     // threads along the q rows
  static constexpr int THREADS = ROW_GROUPS * LANES;
  static constexpr int CK = BK / LANES;          // key columns a thread owns
  static constexpr int VEC = D / LANES >= 4 ? 4 : 2;  // dq columns per contiguous run of a thread
  static constexpr int NV = D / (LANES * VEC);   // runs per dq row of a thread
  static constexpr int RS = D + 16 / (int)sizeof(T);  // row stride of every tile: 16 bytes of pad
  // dS row stride (f32): the row groups of a warp LANES banks apart
  static constexpr int PS = BK + LANES;
  static constexpr int RES_BYTES = BQ * RS * (int)sizeof(T);   // Q or dO, resident
  static constexpr int TILE_BYTES = BK * RS * (int)sizeof(T);  // one stage of the K or V ring
  static constexpr int SMEM = 2 * RES_BYTES + 4 * TILE_BYTES + BQ * PS * 4;
  static_assert(SMEM <= 232448, "a block's shared memory");
  // the cluster's exchange at the end (dq of every row, f32) reuses the Q
  // and dO tiles and the ring
  static_assert(BQ * D * 4 <= 2 * RES_BYTES + 4 * TILE_BYTES, "exchange fits");
};

// One cluster of KS blocks per (batch*head, BQ q rows); block r of the
// cluster takes key tiles r, r + KS, ... up to the diagonal. Row group g
// owns the RQ q rows g, g + ROW_GROUPS, ... and its lane the CK key
// columns lane, lane + LANES, ... of each key tile (S and dP), then the
// runs of dq's d columns lane*VEC, lane*VEC + LANES*VEC, ...; Q and dO stay
// resident while K/V tiles stream through a two-stage cp.async ring. See
// the file's header.
template <typename T, int D, int BQ, int BK, int RQ, int LANES, int KS>
__global__ void __launch_bounds__(DqCfg<T, D, BQ, BK, RQ, LANES, KS>::THREADS)
flash_bwd_dq_scalar_kernel(const Args a, int vec16) {
  using C = DqCfg<T, D, BQ, BK, RQ, LANES, KS>;
  constexpr int ROW_GROUPS = C::ROW_GROUPS, DQ_THREADS = C::THREADS;
  constexpr int CK = C::CK, VEC = C::VEC, NV = C::NV, RS = C::RS, PS = C::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = reinterpret_cast<T*>(smem + C::RES_BYTES);
  T* Ks = reinterpret_cast<T*>(smem + 2 * C::RES_BYTES);                     // stage s at s * BK * RS
  T* Vs = reinterpret_cast<T*>(smem + 2 * C::RES_BYTES + 2 * C::TILE_BYTES);  // the same
  float* DSs = reinterpret_cast<float*>(smem + 2 * C::RES_BYTES + 4 * C::TILE_BYTES);

  const int tid = threadIdx.x;
  const int rg = tid / LANES;
  const int lane = tid % LANES;
  const int rank = KS == 1 ? 0 : (int)blockIdx.x % KS;   // this block's place in its cluster
  const int q0 = (gridDim.x / KS - 1 - blockIdx.x / KS) * BQ;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / a.h;
  const int hi = bh % a.h;
  const int kvh = hi / (a.h / a.hk);
  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hi * a.qs[2];
  const T* ob = static_cast<const T*>(a.dout) + b * a.os[0] + hi * a.os[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  const int q_last = min(q0 + BQ, a.sq) - 1;
  const int k_end = a.causal ? min(a.sk, q_last + 1) : a.sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int n_mine = (n_tiles - rank + KS - 1) / KS;   // key tiles rank, rank + KS, ...

  // Q and dO ride in the first copy group with this block's first K/V
  // tile; rows past the sequences are zero
  auto load_kv = [&](int i) {
    const int s = i & 1, k0 = (rank + KS * i) * BK;
    async_rows<T, D, BK, DQ_THREADS>(Ks + s * BK * RS, RS, kb, a.ks[1], k0, a.sk, vec16);
    async_rows<T, D, BK, DQ_THREADS>(Vs + s * BK * RS, RS, vb, a.vs[1], k0, a.sk, vec16);
    cp_async_commit();
  };
  if (n_mine > 0) {
    async_rows<T, D, BQ, DQ_THREADS>(Qs, RS, qb, a.qs[1], q0, a.sq, vec16);
    async_rows<T, D, BQ, DQ_THREADS>(Os, RS, ob, a.os[1], q0, a.sq, vec16);
    load_kv(0);
  }

  // each row's lse*log2(e) and delta; rows past sq see q = dO = 0 and
  // lse = delta = 0, so their ds is 0
  float lse2[RQ], dlt[RQ], acc[RQ][NV * VEC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q_pos = q0 + rg + ROW_GROUPS * i;
    const int64_t at = (int64_t)bh * a.sq + q_pos;
    lse2[i] = q_pos < a.sq ? a.lse[at] * LOG2E : 0.f;
    dlt[i] = q_pos < a.sq ? a.delta[at] : 0.f;
#pragma unroll
    for (int e = 0; e < NV * VEC; ++e) acc[i][e] = 0.f;
  }

  for (int it = 0; it < n_mine; ++it) {
    cp_async_wait_all();
    __syncthreads();  // this tile is visible, and every thread is done with the last one
    if (it + 1 < n_mine) load_kv(it + 1);  // lands while this tile is computed
    const T* Kt = Ks + (it & 1) * BK * RS;
    const T* Vt = Vs + (it & 1) * BK * RS;
    const int k0 = (rank + KS * it) * BK;

    // S = Q.K^T and dP = dO.V^T: 2 x RQ x CK independent sums, four d at a
    // time: 2 * (RQ + CK) shared loads of four values for 8 * RQ * CK FMAs
    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qa[RQ], oa[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qa[i] = load4(Qs + (rg + ROW_GROUPS * i) * RS + d0);
        oa[i] = load4(Os + (rg + ROW_GROUPS * i) * RS + d0);
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float4 kk = load4(Kt + (lane + LANES * j) * RS + d0);
        const float4 vv = load4(Vt + (lane + LANES * j) * RS + d0);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          s[i][j] = fmaf(qa[i].x, kk.x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kk.y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kk.z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kk.w, s[i][j]);
          dp[i][j] = fmaf(oa[i].x, vv.x, dp[i][j]);
          dp[i][j] = fmaf(oa[i].y, vv.y, dp[i][j]);
          dp[i][j] = fmaf(oa[i].z, vv.z, dp[i][j]);
          dp[i][j] = fmaf(oa[i].w, vv.w, dp[i][j]);
        }
      }
    }

    // p and ds of each (q, k) pair, ds rounded into dS; the tile needs
    // elementwise masking only on a ragged tail or the diagonal
    const bool masked = (k0 + BK > a.sk) || (a.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = rg + ROW_GROUPS * i;
      const int q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = lane + LANES * j;
        const int kp = k0 + c;
        float x = s[i][j] * a.scale_log2;
        if (masked && (kp >= a.sk || (a.causal && kp > q_pos))) x = NEG_INF;
        const float p = exp2f(x - lse2[i]);
        DSs[r * PS + c] = round_to<T>(p * (dp[i][j] - dlt[i]) * a.scale);
      }
    }
    __syncwarp();  // a row group's dS rows are written and read by its own warp

    // dq += dS.K: this thread's rows x its runs of d, four keys at a time
    // from its dS rows (RQ loads) and the four K rows (NV loads each)
#pragma unroll 2
    for (int c0 = 0; c0 < BK; c0 += 4) {
      float4 da[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        da[i] = *reinterpret_cast<const float4*>(DSs + (rg + ROW_GROUPS * i) * PS + c0);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const T* kr = Kt + (c0 + cc) * RS + VEC * lane;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float w[VEC];
          load_n<VEC>(kr + LANES * VEC * n, w);
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float ds = cc == 0 ? da[i].x : cc == 1 ? da[i].y : cc == 2 ? da[i].z : da[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][n * VEC + e] = fmaf(ds, w[e], acc[i][n * VEC + e]);
          }
        }
      }
    }
  }

  // A cluster sums its blocks' dq through distributed shared memory: each
  // block puts its sums where its tiles and ring were, and block r
  // finishes the rows r, r + KS, ..., adding the blocks' sums in block
  // order (the same order on every run). dq is a plain sum over key tiles:
  // the lse is given, so nothing is rescaled
  if constexpr (KS > 1) {
    float* X = reinterpret_cast<float*>(smem);  // dq of row r at r * D
    __syncthreads();  // every thread is done with the tiles and the ring
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float* xr = X + (rg + ROW_GROUPS * i) * D + VEC * lane;
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e) xr[LANES * VEC * n + e] = acc[i][n * VEC + e];
    }
    cooperative_groups::this_cluster().sync();  // every block's sums are visible to the cluster
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = rg + ROW_GROUPS * i;
      if (row % KS != rank) continue;
      const float* xs[KS];
#pragma unroll
      for (int r = 0; r < KS; ++r)
        xs[r] = cooperative_groups::this_cluster().map_shared_rank(X, r) + row * D + VEC * lane;
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float sum = 0.f;
#pragma unroll
          for (int r = 0; r < KS; ++r) sum += xs[r][LANES * VEC * n + e];
          acc[i][n * VEC + e] = sum;
        }
    }
    cooperative_groups::this_cluster().sync();  // no block leaves while another reads it
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = rg + ROW_GROUPS * i;
    const int q_pos = q0 + row;
    if (q_pos >= a.sq || row % KS != rank) continue;
    T* out = static_cast<T*>(a.dq) + ((int64_t)(b * a.sq + q_pos) * a.h + hi) * D + VEC * lane;
#pragma unroll
    for (int n = 0; n < NV; ++n) store_n<VEC>(out + LANES * VEC * n, &acc[i][n * VEC]);
  }
}

// A block's geometry: BKR k rows, BQT q rows per streamed tile; RK k rows a
// thread owns, QLANES threads along a k row (its q columns, then dK's and
// dV's d columns); KS blocks in a cluster share the k rows and split the q
// tiles
template <typename T, int D, int BKR, int BQT, int RK, int QLANES, int KS>
struct DkvCfg {
  static_assert(BKR % RK == 0 && BQT % QLANES == 0 && BQT % 4 == 0 && D % (2 * QLANES) == 0 &&
                    QLANES <= 32 && (KS == 1 || KS == 2),
                "tile shapes");
  static constexpr int ROW_GROUPS = BKR / RK;    // threads along the k rows
  static constexpr int THREADS = ROW_GROUPS * QLANES;
  static constexpr int CQ = BQT / QLANES;        // q columns a thread owns
  static constexpr int VEC = D / QLANES >= 4 ? 4 : 2;  // dK/dV columns per contiguous run of a thread
  static constexpr int NV = D / (QLANES * VEC);  // runs per dK/dV row of a thread
  static constexpr int RS = D + 16 / (int)sizeof(T);  // row stride of every tile: 16 bytes of pad
  static constexpr int PS = BQT + 8;             // P^T and dS^T row stride (f32)
  static constexpr int RES_BYTES = BKR * RS * (int)sizeof(T);   // K or V, resident
  static constexpr int TILE_BYTES = BQT * RS * (int)sizeof(T);  // one stage of the Q or dO ring
  static constexpr int SMEM = 2 * RES_BYTES + 4 * TILE_BYTES + 2 * BKR * PS * 4 + 4 * BQT * 4;
  // the cluster's exchange at the end (dK and dV of every row, f32) reuses
  // the K/V tiles and the Q/dO ring
  static_assert(2 * BKR * D * 4 <= 2 * RES_BYTES + 4 * TILE_BYTES, "exchange fits");
};

// One block per (batch*kv_head, BKR k rows), 128 threads: 16 row groups of
// 8 lanes, one warp holding 4 row groups. Row group g owns the RK k rows g,
// g + 16, ... and its lane the CQ q columns lane, lane + 8, ... of each
// streamed q tile (S^T and dP^T), then the runs of dK's and dV's d columns
// lane*VEC, lane*VEC + 8*VEC, ...; K and V stay resident while Q and dO
// tiles of BQT rows, with their lse and delta, stream through a two-stage
// cp.async ring over the GQA group's heads. See the file's header.
template <typename T, int D, int BKR, int BQT, int RK, int QLANES, int KS>
__global__ void __launch_bounds__(DkvCfg<T, D, BKR, BQT, RK, QLANES, KS>::THREADS)
flash_bwd_dkv_scalar_kernel(const Args a, int vec16) {
  using C = DkvCfg<T, D, BKR, BQT, RK, QLANES, KS>;
  constexpr int ROW_GROUPS = C::ROW_GROUPS, DKV_THREADS = C::THREADS;
  constexpr int CQ = C::CQ, VEC = C::VEC, NV = C::NV, RS = C::RS, PS = C::PS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + C::RES_BYTES);
  T* Qs = reinterpret_cast<T*>(smem + 2 * C::RES_BYTES);                     // stage s at s * BQT * RS
  T* Os = reinterpret_cast<T*>(smem + 2 * C::RES_BYTES + 2 * C::TILE_BYTES);  // the same
  float* Ps = reinterpret_cast<float*>(smem + 2 * C::RES_BYTES + 4 * C::TILE_BYTES);
  float* DSs = Ps + BKR * PS;
  float* Ls = DSs + BKR * PS;  // stage s at s * BQT: a q tile's lse
  float* Dl = Ls + 2 * BQT;    // and its delta

  const int tid = threadIdx.x;
  const int rg = tid / QLANES;
  const int lane = tid % QLANES;
  const int rank = KS == 1 ? 0 : (int)blockIdx.x % KS;  // this block's place in its cluster
  const int k0 = blockIdx.x / KS * BKR;  // causal: the first k rows have the most q rows
  const int bkv = blockIdx.y;
  const int b = bkv / a.hk;
  const int kvh = bkv % a.hk;
  const int group = a.h / a.hk;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];
  // q rows below the block's tile see none of it under the causal mask
  const int q_begin = a.causal ? (k0 / BQT) * BQT : 0;
  const int n_qt = max(0, (a.sq - q_begin + BQT - 1) / BQT);
  const int total = group * n_qt;  // every q tile of every head of the group
  const int n_mine = (total - rank + KS - 1) / KS;  // this block streams tiles rank, rank + KS, ...

  auto load_q = [&](int i) {
    const int s = i & 1, t = rank + KS * i;
    const int hi = kvh * group + t / n_qt;
    const int q0 = q_begin + (t % n_qt) * BQT;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hi * a.qs[2];
    const T* ob = static_cast<const T*>(a.dout) + b * a.os[0] + hi * a.os[2];
    async_rows<T, D, BQT, DKV_THREADS>(Qs + s * BQT * RS, RS, qb, a.qs[1], q0, a.sq, vec16);
    async_rows<T, D, BQT, DKV_THREADS>(Os + s * BQT * RS, RS, ob, a.os[1], q0, a.sq, vec16);
    const int64_t stat0 = (int64_t)(b * a.h + hi) * a.sq;
    for (int i = tid; i < 2 * BQT; i += DKV_THREADS) {
      const int r = i % BQT;
      const bool ok = q0 + r < a.sq;
      const float* src = (i < BQT ? a.lse : a.delta) + stat0;
      cp_async<4>((i < BQT ? Ls : Dl) + s * BQT + r, ok ? src + q0 + r : src, ok);
    }
    cp_async_commit();
  };
  // K and V ride in the first copy group with the first q tile; rows past
  // the sequences are zero, and so are lse and delta past sq
  if (n_mine > 0) {
    async_rows<T, D, BKR, DKV_THREADS>(Ks, RS, kb, a.ks[1], k0, a.sk, vec16);
    async_rows<T, D, BKR, DKV_THREADS>(Vs, RS, vb, a.vs[1], k0, a.sk, vec16);
    load_q(0);
  }

  float dk[RK][NV * VEC], dv[RK][NV * VEC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int e = 0; e < NV * VEC; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int it = 0; it < n_mine; ++it) {
    cp_async_wait_all();
    __syncthreads();  // this tile is visible, and every thread is done with the last one
    if (it + 1 < n_mine) load_q(it + 1);  // lands while this tile is computed
    const int st = it & 1, t = rank + KS * it;
    const int q0 = q_begin + (t % n_qt) * BQT;
    const T* Qt = Qs + st * BQT * RS;
    const T* Ot = Os + st * BQT * RS;

    // S^T = K.Q^T and dP^T = V.dO^T: 2 x RK x CQ independent sums, four d
    // at a time: 2 * (RK + CQ) shared loads of four values for
    // 8 * RK * CQ FMAs
    float s[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 ka[RK], va[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        ka[i] = load4(Ks + (rg + ROW_GROUPS * i) * RS + d0);
        va[i] = load4(Vs + (rg + ROW_GROUPS * i) * RS + d0);
      }
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        const float4 qq = load4(Qt + (lane + QLANES * j) * RS + d0);
        const float4 oo = load4(Ot + (lane + QLANES * j) * RS + d0);
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          s[i][j] = fmaf(ka[i].x, qq.x, s[i][j]);
          s[i][j] = fmaf(ka[i].y, qq.y, s[i][j]);
          s[i][j] = fmaf(ka[i].z, qq.z, s[i][j]);
          s[i][j] = fmaf(ka[i].w, qq.w, s[i][j]);
          dp[i][j] = fmaf(va[i].x, oo.x, dp[i][j]);
          dp[i][j] = fmaf(va[i].y, oo.y, dp[i][j]);
          dp[i][j] = fmaf(va[i].z, oo.z, dp[i][j]);
          dp[i][j] = fmaf(va[i].w, oo.w, dp[i][j]);
        }
      }
    }

    // p and ds of each (k, q) pair, rounded into P^T and dS^T; the tile
    // needs elementwise masking only on a ragged tail or the diagonal
    const bool masked = (q0 + BQT > a.sq) || (k0 + BKR > a.sk) || (a.causal && k0 + BKR - 1 > q0);
#pragma unroll
    for (int j = 0; j < CQ; ++j) {
      const int c = lane + QLANES * j;
      const int qp = q0 + c;
      const float lse2 = Ls[st * BQT + c] * LOG2E;
      const float dlt = Dl[st * BQT + c];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int r = rg + ROW_GROUPS * i;
        const int kp = k0 + r;
        float x = s[i][j] * a.scale_log2;
        if (masked && (qp >= a.sq || kp >= a.sk || (a.causal && kp > qp))) x = NEG_INF;
        const float p = exp2f(x - lse2);
        Ps[r * PS + c] = round_to<T>(p);
        DSs[r * PS + c] = round_to<T>(p * (dp[i][j] - dlt) * a.scale);
      }
    }
    __syncwarp();  // a row group's P^T and dS^T rows are written and read by its own warp

    // dV += P^T.dO and dK += dS^T.Q: this thread's k rows x its runs of d,
    // four q rows at a time
#pragma unroll 2
    for (int c0 = 0; c0 < BQT; c0 += 4) {
      float4 pa[RK], da[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pa[i] = *reinterpret_cast<const float4*>(Ps + (rg + ROW_GROUPS * i) * PS + c0);
        da[i] = *reinterpret_cast<const float4*>(DSs + (rg + ROW_GROUPS * i) * PS + c0);
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const T* orow = Ot + (c0 + cc) * RS + VEC * lane;
        const T* qrow = Qt + (c0 + cc) * RS + VEC * lane;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float ov[VEC], qv[VEC];
          load_n<VEC>(orow + QLANES * VEC * n, ov);
          load_n<VEC>(qrow + QLANES * VEC * n, qv);
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
            const float ds = cc == 0 ? da[i].x : cc == 1 ? da[i].y : cc == 2 ? da[i].z : da[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              dv[i][n * VEC + e] = fmaf(p, ov[e], dv[i][n * VEC + e]);
              dk[i][n * VEC + e] = fmaf(ds, qv[e], dk[i][n * VEC + e]);
            }
          }
        }
      }
    }
  }

  // A cluster sums its blocks' dK and dV through distributed shared memory:
  // each block puts its sums where its K, V and ring were, and block r
  // finishes the rows r, r + KS, ..., adding the blocks' sums in block
  // order (the same order on every run)
  if constexpr (KS > 1) {
    float* X = reinterpret_cast<float*>(smem);  // dK rows, then dV rows
    __syncthreads();  // every thread is done with K, V and the ring
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      float* xk = X + (rg + ROW_GROUPS * i) * D + VEC * lane;
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          xk[QLANES * VEC * n + e] = dk[i][n * VEC + e];
          xk[BKR * D + QLANES * VEC * n + e] = dv[i][n * VEC + e];
        }
    }
    cooperative_groups::this_cluster().sync();  // every block's sums are visible to the cluster
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int row = rg + ROW_GROUPS * i;
      if (row % KS != rank) continue;
      const float* xs[KS];
#pragma unroll
      for (int r = 0; r < KS; ++r)
        xs[r] = cooperative_groups::this_cluster().map_shared_rank(X, r) + row * D + VEC * lane;
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float sk_ = 0.f, sv_ = 0.f;
#pragma unroll
          for (int r = 0; r < KS; ++r) {
            sk_ += xs[r][QLANES * VEC * n + e];
            sv_ += xs[r][BKR * D + QLANES * VEC * n + e];
          }
          dk[i][n * VEC + e] = sk_;
          dv[i][n * VEC + e] = sv_;
        }
    }
    cooperative_groups::this_cluster().sync();  // no block leaves while another reads it
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int row = rg + ROW_GROUPS * i;
    const int kp = k0 + row;
    if (kp >= a.sk || row % KS != rank) continue;
    const int64_t at = ((int64_t)(b * a.sk + kp) * a.hk + kvh) * D + VEC * lane;
    T* dkr = static_cast<T*>(a.dk) + at;
    T* dvr = static_cast<T*>(a.dv) + at;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      store_n<VEC>(dkr + QLANES * VEC * n, &dk[i][n * VEC]);
      store_n<VEC>(dvr + QLANES * VEC * n, &dv[i][n * VEC]);
    }
  }
}

// Whether the scalar kernels may copy q, k, v and dO 16 bytes at a time
// (*vec16), else 4; every view must be 4-byte aligned (the wrapper copies
// one that is not)
template <typename T>
bool copy_width(const Args& a, int* vec16) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int64_t* strides[4] = {a.qs, a.ks, a.vs, a.os};
  *vec16 = 1;
  for (int i = 0; i < 4; ++i) {
    if (!aligned_to(ptrs[i], strides[i], sizeof(T), 4)) return false;
    *vec16 = *vec16 && aligned_to(ptrs[i], strides[i], sizeof(T), 16);
  }
  return true;
}

// dq's key tile: 64 keys, 4 of them a thread (8 at d 16)
constexpr int DQ_BK = 64;
// dq's largest cluster (2 or 4): see the file's header for the times that
// chose it
constexpr int DQ_MAX_SPLIT = 2;

// q rows per dq block and blocks per cluster (the key tiles of the
// longest rows split between them): the grid's size decides, by the
// forward's rule (odh_flash::scalar_tile and scalar_split)
int dq_tile_q(int b, int sq, int h) { return scalar_tile(sq, (int64_t)b * h); }

int dq_k_split(int b, int sq, int sk, int h, int causal) {
  const int keys = causal ? min(sk, sq) : sk;
  return scalar_split(sq, (int64_t)b * h, dq_tile_q(b, sq, h), (keys + DQ_BK - 1) / DQ_BK,
                      DQ_MAX_SPLIT);
}

template <typename T, int D>
struct LaunchDq {
  template <int BQ, int KS>
  static cudaError_t go(const Args& a, int vec16, cudaStream_t stream) {
    // 16 row groups of BQ / 16 q rows x 16 lanes (256 threads), or 8 lanes
    // at d 16
    constexpr int LANES = D == 16 ? 8 : 16;
    constexpr int RQ = BQ / 16;
    using C = DqCfg<T, D, BQ, DQ_BK, RQ, LANES, KS>;
    auto kernel = flash_bwd_dq_scalar_kernel<T, D, BQ, DQ_BK, RQ, LANES, KS>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.sq + BQ - 1) / BQ * KS, a.b * a.h);
    return launch_clustered(kernel, grid, C::THREADS, C::SMEM, KS, stream, a, vec16);
  }

  template <int KS>
  static cudaError_t tiled(int tile, const Args& a, int vec16, cudaStream_t stream) {
    switch (tile) {
      case 64: return go<64, KS>(a, vec16, stream);
      case 32: return go<32, KS>(a, vec16, stream);
      default: return go<16, KS>(a, vec16, stream);
    }
  }

  static cudaError_t run(const Args& a, cudaStream_t stream) {
    int vec16;
    if (!copy_width<T>(a, &vec16)) return cudaErrorMisalignedAddress;
    const int tile = dq_tile_q(a.b, a.sq, a.h);
    const int split = dq_k_split(a.b, a.sq, a.sk, a.h, a.causal);
    if constexpr (DQ_MAX_SPLIT >= 4)
      if (split == 4) return tiled<4>(tile, a, vec16, stream);
    if (split == 2) return tiled<2>(tile, a, vec16, stream);
    return tiled<1>(tile, a, vec16, stream);
  }
};

// q rows per streamed tile: 32 at d 128, where two stages of 64-row f32 Q
// and dO tiles beside 64 resident K/V rows would pass the 227 KB a block
// may hold, else 64
constexpr int q_tile(int d) { return d == 128 ? 32 : 64; }

// k rows per block and blocks per cluster (the streamed q tiles of the
// first k rows split between them): the grid's size decides
// (odh_flash::scalar_tile and scalar_split)
int tile_k(int b, int sk, int hk) { return scalar_tile(sk, (int64_t)b * hk); }

int q_split(int b, int sq, int sk, int hk, int group, int d) {
  const int tile = tile_k(b, sk, hk);
  return scalar_split(sk, (int64_t)b * hk, tile, (int64_t)group * ((sq + q_tile(d) - 1) / q_tile(d)), 2);
}

template <typename T, int D>
struct LaunchDkv {
  template <int BKR, int KS>
  static cudaError_t go(const Args& a, int vec16, cudaStream_t stream) {
    // 16 row groups of BKR / 16 k rows x 8 lanes, or 16 lanes (256
    // threads) beside 64 k rows at d 32 and up
    constexpr int BQT = q_tile(D);
    constexpr int QLANES = BKR == 64 && D >= 32 ? 16 : 8;
    constexpr int RK = BKR / 16;
    using C = DkvCfg<T, D, BKR, BQT, RK, QLANES, KS>;
    auto kernel = flash_bwd_dkv_scalar_kernel<T, D, BKR, BQT, RK, QLANES, KS>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.sk + BKR - 1) / BKR * KS, a.b * a.hk);
    return launch_clustered(kernel, grid, C::THREADS, C::SMEM, KS, stream, a, vec16);
  }

  static cudaError_t run(const Args& a, cudaStream_t stream) {
    int vec16;
    if (!copy_width<T>(a, &vec16)) return cudaErrorMisalignedAddress;
    const int tile = tile_k(a.b, a.sk, a.hk);
    const int split = q_split(a.b, a.sq, a.sk, a.hk, a.h / a.hk, D);
    if (split == 2) {
      switch (tile) {
        case 64: return go<64, 2>(a, vec16, stream);
        case 32: return go<32, 2>(a, vec16, stream);
        default: return go<16, 2>(a, vec16, stream);
      }
    }
    switch (tile) {
      case 64: return go<64, 1>(a, vec16, stream);
      case 32: return go<32, 1>(a, vec16, stream);
      default: return go<16, 1>(a, vec16, stream);
    }
  }
};

template <template <typename, int> class Launch, typename T>
cudaError_t dispatch_d(int d, const Args& a, cudaStream_t stream) {
  if (d == 16) return Launch<T, 16>::run(a, stream);
  if (d == 32) return Launch<T, 32>::run(a, stream);
  if constexpr (sizeof(T) == 4) {  // bf16 at d 64 and 128 is the tensor-core pair's
    if (d == 64) return Launch<T, 64>::run(a, stream);
    if (d == 128) return Launch<T, 128>::run(a, stream);
  }
  return cudaErrorInvalidValue;
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

// k rows per block of the dk/dv kernel odh_flash_bwd_dkv would launch for
// this call; attention.bwd_dkv_launch_plan reports it
extern "C" int odh_flash_bwd_dkv_tile_k(int dtype, int d, int b, int sk, int hk) {
  return odh_flash_bwd_kernel(dtype, d) == 1 ? wg::ROWS : scalar::tile_k(b, sk, hk);
}

// blocks per cluster of the dk/dv kernel odh_flash_bwd_dkv would launch
// (the scalar kernel's q split; the tensor-core kernel takes no clusters)
extern "C" int odh_flash_bwd_dkv_q_split(int dtype, int d, int b, int sq, int sk, int h, int hk) {
  if (hk <= 0 || h % hk) return -1;
  return odh_flash_bwd_kernel(dtype, d) == 1 ? 1 : scalar::q_split(b, sq, sk, hk, h / hk, d);
}

// q rows per block of the dq kernel odh_flash_bwd_dq would launch for this
// call; attention.bwd_dq_launch_plan reports it
extern "C" int odh_flash_bwd_dq_tile_q(int dtype, int d, int b, int sq, int h) {
  return odh_flash_bwd_kernel(dtype, d) == 1 ? wg::ROWS : scalar::dq_tile_q(b, sq, h);
}

// blocks per cluster of the dq kernel odh_flash_bwd_dq would launch (the
// scalar kernel's key split; the tensor-core kernel takes no clusters)
extern "C" int odh_flash_bwd_dq_k_split(int dtype, int d, int b, int sq, int sk, int h, int causal) {
  return odh_flash_bwd_kernel(dtype, d) == 1 ? 1 : scalar::dq_k_split(b, sq, sk, h, causal);
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch, seq,
// head) for each of q/k/v/dO; the last dim must be contiguous. For the
// tensor-core kernels the base addresses must be 16-byte aligned and every
// stride a multiple of 16 bytes (TMA's rule); for the scalar kernels, which
// copy with cp.async, multiples of 4 bytes (16-byte copies where all four
// views allow them). Each returns the launch's cudaError_t (0 on
// success); the launch is asynchronous on `stream`. A failed launch is
// returned, never retried on the other kernel.
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
