// Flash attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by ops/flash_attention.py).  Two kernels:
//
// - K2 (dq) replaces pytorch_distributed_tpu/ops/flash_attention.py
//   `_bwd_dq_kernel` (launched by `_bwd_pallas`): dq = sum over kv of ds . k;
// - K3 (dk, dv) replaces `_bwd_dkv_kernel`: dv = sum over q of p^T . dO and
//   dk = sum over q of ds^T . q.
//
// Both recompute, per (q, kv) tile pair, what `_recompute_p_ds` recomputes:
// s = q.k^T * scale, p = exp(s - lse), dp = dO.v^T, ds = p * (dp - delta) *
// scale, with lse [B, H, L] f32 saved by the forward kernel (K1) and
// delta = rowsum(dO * O) [B, H, L] f32 computed by the caller in plain
// PyTorch, as the JAX package computes it outside its kernels too.  Same
// constants as K1: scale 1/sqrt(D), masked pairs get p = 0 (the JAX
// package's exp(-1e30 - lse)).
//
// Each kernel has two instantiations by dtype:
// - bf16, the training path (`flash_bwd_dq_mma_kernel`,
//   `flash_bwd_dkv_mma_kernel`): the products of a tile pair run on the
//   tensor cores as warpgroup wgmma (m64nNk16 bf16, f32 accumulation) on
//   bf16 tiles in shared memory that 16-byte cp.async copies fill one tile
//   ahead of use;
// - f32 (`flash_bwd_dq_f32_kernel`, `flash_bwd_dkv_f32_kernel`): the same
//   loops on the f32 CUDA cores, for checks that must exclude the tensor
//   cores' roundings.
//
// What differs from the TPU kernels, by design:
// - The TPU carries dq (and dk, dv) in VMEM scratch across a sequential grid
//   axis.  CTAs on the card run in parallel in no order, so each CTA owns
//   its accumulator in registers and loops over the other axis itself.
//   K2: one CTA per (b*h, 64-row q tile), looping over the kv tiles; under
//   causal masking it stops at the diagonal tile (the TPU's `_causal_run`
//   `pl.when`).  K3: one CTA per (b*h, 64-key kv tile), looping over the q
//   tiles from the diagonal tile to the end.  The heaviest CTAs launch
//   first (K2: the last q tiles; K3: the first kv tiles).
// - The two-pass split is kept on purpose.  The single-pass FlashAttention-2
//   backward (one CTA per kv tile computing dk, dv and adding its share of
//   dq into device memory with atomics) saves recomputing s and dp once,
//   but its f32 atomic adds land in a different order on every run, so dq
//   would not be reproducible bit for bit, and it needs a zeroed f32 dq
//   scratch plus a cast pass.  Two passes are deterministic, need no
//   scratch, and each CTA writes its own output tile once.
// - q, k, v and dO are read in place through their strides (v arrives as a
//   strided view of the fused qkv projection); dq, dk and dv are written
//   contiguous [B, L, H, D] in the input dtype.  The bf16 kernels copy 16
//   bytes at a time, so the wrapper requires 16-byte aligned base pointers
//   and (b, l, h) strides and raises otherwise.
// - Ragged last tiles: rows past L load as zeros, their lse and delta as 0,
//   and every pair with a row or a key past L, or a key after its query
//   under causal masking, gets p = 0 and ds = 0 by predicate, not through
//   exp of a masked score, so no inf can meet a 0.
//
// Bound at the training path's shape (B=4, L=4096, H=16, D=64, causal,
// bf16; 5.37e8 causal pairs): K2 does 6*D FLOP per pair (s, dp, dq),
// 2.06e11 FLOP, 0.208 ms at the card's 989 TFLOP/s bf16 tensor-core peak;
// K3 does 8*D (s, dp, dv, dk), 2.75e11 FLOP, 0.278 ms.  Each reads q, k, v,
// dO, lse and delta and writes its outputs once: 170 MB (K2) and 203 MB
// (K3), about 0.05-0.06 ms at 3.35 TB/s.  Both are compute-bound, so the
// bf16 design is about the tensor cores:
// - One warpgroup (4 warps, 128 threads) per CTA owns the 64 rows of the
//   resident tile (q rows in K2, keys in K3), wgmma's M.  The first two
//   products of a tile pair (s and dp; transposed in K3) read both operands
//   from shared memory through descriptors and leave their f32 results in
//   accumulator registers, where p and ds are computed in place.  Two
//   adjacent 8-column accumulator blocks are one 16-deep A fragment, so p
//   and ds, rounded to bf16, are the register A operand of the second
//   products, whose B (k in K2; q and dO in K3) is read transposed
//   (MN-major) from the same shared tile.  Rounding P and dS to bf16 is what
//   FlashAttention-2/3 and PyTorch's own attention backward do; the plain
//   version keeps them f32, and the card's tolerance for bf16 covers the
//   difference.
// - Tiles are bf16 in blocks of 64 columns, rows of 128 bytes whose 16-byte
//   chunks are permuted by XOR with the row index mod 8: the 128-byte
//   swizzle the descriptors name, so wgmma reads them without bank
//   conflicts, K-major or MN-major.  The resident tiles stay in shared
//   memory for the whole loop.
// - The streamed tiles (k and v in K2; q, dO, lse and delta in K3) go
//   through a ring of two stages: the copy of tile i+1 is issued before
//   the products of tile i, and the CTA waits for it only at the next tile.
//   The copies are generic-proxy writes, so each thread fences them to the
//   async proxy that wgmma reads through before the CTA barrier.  cp.async
//   rather than TMA keeps the launch a plain C call: TMA would need a tensor
//   map per strided view and call (cuTensorMapEncodeTiled).
//
// The Hopper helpers (swizzled tiles, cp.async, wgmma wrappers, A-fragment
// conversion) live in hopper_mma.cuh, shared with K1.

#include "hopper_mma.cuh"

namespace {

struct Strides {
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, g_sb, g_sl, g_sh;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int NT = WG_THREADS;  // threads per CTA: one warpgroup
constexpr int BM = WG_ROWS;     // resident rows per CTA: wgmma's M, 16 per warp

// Rows of the streamed tile.  K3 at D=128 holds two 64 x 128 f32
// accumulators (128 registers a thread), so it streams 32 q rows at a time.
template <int D, bool DKV>
struct Stream {
  static constexpr int BN = (DKV && D == 128) ? 32 : 64;
};

// K2, bf16.  Shared: q and dO tiles [BM x D] resident, then two stages of
// (k, v) tiles [BN x D].
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int L, int causal, float scale,
                        Strides st) {
  constexpr int BN = Stream<D, false>::BN;
  constexpr uint32_t TX = BM * D * 2, TU = BN * D * 2;  // tile bytes
  extern __shared__ unsigned char smem[];
  const uint32_t sQ = aligned_smem(smem), sG = sQ + TX, sKV = sG + TX;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;

  int n_kv = (L + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + BM - 1) / BN + 1);  // stop at the diagonal tile

  load_tile<D, BM>(sQ, q + b * st.q_sb + h * st.q_sh, st.q_sl, q0, L);
  load_tile<D, BM>(sG, dout + b * st.g_sb + h * st.g_sh, st.g_sl, q0, L);
  load_tile<D, BN>(sKV, kb, st.k_sl, 0, L);
  load_tile<D, BN>(sKV + TU, vb, st.v_sl, 0, L);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  int qpos[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + 16 * w + (lane >> 2) + 8 * i;
    lse2[i] = qpos[i] < L ? lse[(int64_t)bh * L + qpos[i]] * LOG2E : 0.f;
    dlt[i] = qpos[i] < L ? delta[(int64_t)bh * L + qpos[i]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    if (kt + 1 < n_kv) {  // the next (k, v) tile into the other stage
      const uint32_t nxt = sKV + ((kt + 1) & 1) * 2 * TU;
      load_tile<D, BN>(nxt, kb, st.k_sl, (kt + 1) * BN, L);
      load_tile<D, BN>(nxt + TU, vb, st.v_sl, (kt + 1) * BN, L);
    }
    cp_async_commit();
    cp_async_wait_1();  // this tile's group has landed
    __syncthreads();

    const uint32_t sK = sKV + (kt & 1) * 2 * TU, sV = sK + TU;
    const int k0 = kt * BN;
    float s[BN / 8][4], dp[BN / 8][4];
    mma_xut<D, BN>(s, sQ, sK);
    mma_xut<D, BN>(dp, sG, sV);
    wg_wait_all();
    reg_fence<BN / 8>(s);
    reg_fence<BN / 8>(dp);
    const bool edge = k0 + BN > L || q0 + BM > L || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const bool live = !edge || (qpos[i] < L && kpos < L && !(causal && kpos > qpos[i]));
        const float p = exp2f(fmaf(s[j][e], sl2, -lse2[i]));
        s[j][e] = live ? p * (dp[j][e] - dlt[i]) * scale : 0.f;  // ds
      }
    }
    uint32_t dsa[BN / 16][4];
    to_a_frags<BN>(dsa, s);
    reg_fence<D / 8>(acc);
    mma_pu<D, BN>(acc, dsa, sK);
    wg_wait_all();
    reg_fence<D / 8>(acc);
    __syncthreads();  // every warp is done with this stage before it refills
  }
  store_acc<D>(dq, acc, qpos, b, h, H, L, lane);
}

// K3, bf16.  Computed transposed (s^T = k . q^T, dp^T = v . dO^T), so that
// p^T and ds^T come out in the A-operand layout of dv += p^T . dO and
// dk += ds^T . q.  Shared: k and v tiles [BM x D] resident, two stages of
// (q, dO) tiles [BN x D], then two stages of the q tile's lse and delta.
template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int L,
                         int causal, float scale, Strides st) {
  constexpr int BN = Stream<D, true>::BN;
  constexpr uint32_t TX = BM * D * 2, TU = BN * D * 2;
  extern __shared__ unsigned char smem[];
  const uint32_t sK = aligned_smem(smem), sV = sK + TX, sQG = sV + TX, sLD = sQG + 4 * TU;
  const unsigned char* lds = smem + (sLD - smem_u32(smem));  // lse, delta

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* gb = dout + b * st.g_sb + h * st.g_sh;
  const float* lb = lse + (int64_t)bh * L;
  const float* db = delta + (int64_t)bh * L;

  // The q tile qt into stage `stg`: q, dO, then lse and delta, 4 bytes a
  // copy (zero past L).
  auto load_q_tile = [&](int qt, int stg) {
    const uint32_t base = sQG + stg * 2 * TU;
    const int q0 = qt * BN;
    load_tile<D, BN>(base, qb, st.q_sl, q0, L);
    load_tile<D, BN>(base + TU, gb, st.g_sl, q0, L);
    for (int i = threadIdx.x; i < 2 * BN; i += NT) {
      const int row = q0 + (i % BN);
      const bool in = row < L;
      cp_async4(sLD + stg * 2 * BN * 4 + 4 * i, (i < BN ? lb : db) + (in ? row : 0), in ? 4 : 0);
    }
  };

  load_tile<D, BM>(sK, k + b * st.k_sb + h * st.k_sh, st.k_sl, k0, L);
  load_tile<D, BM>(sV, v + b * st.v_sb + h * st.v_sh, st.v_sl, k0, L);
  const int n_q = (L + BN - 1) / BN;
  const int qt0 = causal ? k0 / BN : 0;  // q tiles before k0 see none of these keys
  load_q_tile(qt0, 0);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kpos[i] = k0 + 16 * w + (lane >> 2) + 8 * i;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int stg = (qt - qt0) & 1;
    if (qt + 1 < n_q) load_q_tile(qt + 1, stg ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const uint32_t sQ = sQG + stg * 2 * TU, sG = sQ + TU;
    const float* sL = reinterpret_cast<const float*>(lds + stg * 2 * BN * 4);
    const float* sD = sL + BN;
    const int q0 = qt * BN;
    float s[BN / 8][4], dp[BN / 8][4];
    mma_xut<D, BN>(s, sK, sQ);
    mma_xut<D, BN>(dp, sV, sG);
    wg_wait_all();
    reg_fence<BN / 8>(s);
    reg_fence<BN / 8>(dp);
    const bool edge = q0 + BN > L || k0 + BM > L || (causal && k0 + BM - 1 > q0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int qc = 8 * j + 2 * (lane & 3);
      const float2 lq = *reinterpret_cast<const float2*>(sL + qc);
      const float2 dq_ = *reinterpret_cast<const float2*>(sD + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qpos = q0 + qc + (e & 1);
        const bool live = !edge || (qpos < L && kpos[i] < L && !(causal && kpos[i] > qpos));
        const float l2 = (e & 1 ? lq.y : lq.x) * LOG2E;
        const float p = live ? exp2f(fmaf(s[j][e], sl2, -l2)) : 0.f;
        s[j][e] = p;
        dp[j][e] = live ? p * (dp[j][e] - (e & 1 ? dq_.y : dq_.x)) * scale : 0.f;  // ds
      }
    }
    uint32_t pa[BN / 16][4], dsa[BN / 16][4];
    to_a_frags<BN>(pa, s);
    to_a_frags<BN>(dsa, dp);
    reg_fence<D / 8>(acc_v);
    reg_fence<D / 8>(acc_k);
    mma_pu<D, BN>(acc_v, pa, sG);
    mma_pu<D, BN>(acc_k, dsa, sQ);
    wg_wait_all();
    reg_fence<D / 8>(acc_v);
    reg_fence<D / 8>(acc_k);
    __syncthreads();  // every warp is done with this stage before it refills
  }
  store_acc<D>(dk, acc_k, kpos, b, h, H, L, lane);
  store_acc<D>(dv, acc_v, kpos, b, h, H, L, lane);
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int B, int H,
                          int L, int causal, const Strides& st, cudaStream_t stream) {
  constexpr size_t smem = 2 * (size_t)BM * D * 2 + 4 * (size_t)Stream<D, false>::BN * D * 2
                          + 1024;
  cudaError_t err = opt_in_smem(flash_bwd_dq_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BM - 1) / BM);
  flash_bwd_dq_mma_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, L, causal,
      1.0f / sqrtf((float)D), st);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int B,
                           int H, int L, int causal, const Strides& st, cudaStream_t stream) {
  constexpr int BN = Stream<D, true>::BN;
  constexpr size_t smem = 2 * (size_t)BM * D * 2 + 4 * (size_t)BN * D * 2 + 4 * BN * 4 + 1024;
  cudaError_t err = opt_in_smem(flash_bwd_dkv_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BM - 1) / BM);
  flash_bwd_dkv_mma_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, L, causal, 1.0f / sqrtf((float)D), st);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
static_assert(BQ == BK, "load_tile_f32 fills q and kv tiles of one height; the "
                        "causal start tile of K3 assumes equal tiles");

// Per head dim: RT rows of a 64 x 64 score tile per thread, 8 threads per
// row group, so 64 / RT row groups.  At D=128 two 64 x D accumulators per
// thread (K3) would need 128 registers at RT=4, so D=128 takes RT=2 and
// twice the threads.  Shared tiles are padded: row stride D+1 puts the 8
// lanes that read 8 rows of one column on 8 banks; the P/dS row stride
// BK + 8/RT puts the 4 row groups of a warp 8 banks apart.
template <int D>
struct Cfg {
  static constexpr int RT = D == 64 ? 4 : 2;
  static constexpr int NT = BQ / RT * 8;
  static constexpr int S = D + 1;
  static constexpr int PS = BK + 8 / RT;
  static constexpr int DC = D / 8;  // accumulator columns per thread
};

// Rows [row0, row0 + 64) of one (b, h) slice into a shared tile with row
// stride D + 1.  Rows at or past L are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              int64_t stride_l, int row0, int L) {
  constexpr int S = Cfg<D>::S, NT = Cfg<D>::NT;
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * S + c] = row < L ? src[(int64_t)row * stride_l + c] : 0.f;
  }
}

// acc[i][j] = sum_d A[row i of the thread][d] * Bm[tc + 8j][d]: one RT x 8
// microtile of A . Bm^T over shared tiles of row stride D + 1.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[Cfg<D>::RT][8],
                                         const float* A, const float* Bm,
                                         int tr, int tc) {
  constexpr int RT = Cfg<D>::RT, S = Cfg<D>::S;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[RT], b[8];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = A[(tr * RT + i) * S + d];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = Bm[(tc + 8 * j) * S + d];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_kk P[row i of the thread][kk] * M[kk][tc + 8c]: the
// thread's RT x D/8 share of P . M, P of row stride PS, M of row stride D+1.
template <int D>
__device__ __forceinline__ void tile_accum(float (&acc)[Cfg<D>::RT][Cfg<D>::DC],
                                           const float* P, const float* M,
                                           int tr, int tc) {
  constexpr int RT = Cfg<D>::RT, S = Cfg<D>::S, PS = Cfg<D>::PS, DC = Cfg<D>::DC;
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float p[RT], m[DC];
#pragma unroll
    for (int i = 0; i < RT; ++i) p[i] = P[(tr * RT + i) * PS + kk];
#pragma unroll
    for (int c = 0; c < DC; ++c) m[c] = M[kk * S + tc + 8 * c];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], m[c], acc[i][c]);
  }
}

// The thread's RT rows of a contiguous [B, L, H, D] output, rows past L
// skipped.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           float (&acc)[Cfg<D>::RT][Cfg<D>::DC],
                                           int b, int h, int H, int L, int row0,
                                           int tr, int tc) {
  constexpr int RT = Cfg<D>::RT, DC = Cfg<D>::DC;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + tr * RT + i;
    if (row >= L) continue;
    float* orow = out + (((int64_t)b * L + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tc + 8 * c] = acc[i][c];
  }
}

// K2, f32.  Thread (tr, tc) owns query rows tr*RT .. tr*RT+RT-1 of the
// tile, score columns tc + 8j, and dq columns tc + 8c.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int L, int causal, float scale,
                        Strides st) {
  constexpr int RT = Cfg<D>::RT, S = Cfg<D>::S, PS = Cfg<D>::PS, DC = Cfg<D>::DC;
  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;
  float* sG = sQ + BQ * S;   // dO
  float* sK = sG + BQ * S;
  float* sV = sK + BK * S;
  float* sDS = sV + BK * S;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;

  load_tile_f32<D>(sQ, q + b * st.q_sb + h * st.q_sh, st.q_sl, q0, L);
  load_tile_f32<D>(sG, dout + b * st.g_sb + h * st.g_sh, st.g_sl, q0, L);
  const float* kbase = k + b * st.k_sb + h * st.k_sh;
  const float* vbase = v + b * st.v_sb + h * st.v_sh;

  float row_lse[RT], row_dlt[RT], acc[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + tr * RT + i;
    row_lse[i] = row < L ? lse[(int64_t)bh * L + row] : 0.f;
    row_dlt[i] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (L + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);  // stop at the diagonal tile

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile_f32<D>(sK, kbase, st.k_sl, k0, L);
    load_tile_f32<D>(sV, vbase, st.v_sl, k0, L);
    __syncthreads();

    float s[RT][8], dp[RT][8];
    tile_dot<D>(s, sQ, sK, tr, tc);
    tile_dot<D>(dp, sG, sV, tr, tc);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + tr * RT + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tc + 8 * j;
        const bool live = qpos < L && kpos < L && !(causal && kpos > qpos);
        const float p = live ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        sDS[(tr * RT + i) * PS + tc + 8 * j] = live ? p * (dp[i][j] - row_dlt[i]) * scale : 0.f;
      }
    }
    __syncwarp();  // a row group's dS rows are written and read by its own warp
    tile_accum<D>(acc, sDS, sK, tr, tc);
  }
  store_rows<D>(dq, acc, b, h, H, L, q0, tr, tc);
}

// K3, f32.  Thread (tr, tc) owns key rows tr*RT .. tr*RT+RT-1 of the kv
// tile, query columns tc + 8j of the transposed score tile, and dk, dv
// columns tc + 8c.  The tile is computed transposed (s^T = k . q^T) so that
// the rows of P^T and dS^T a thread accumulates from are written by its own
// warp, as in K1.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int L,
                         int causal, float scale, Strides st) {
  constexpr int RT = Cfg<D>::RT, S = Cfg<D>::S, PS = Cfg<D>::PS, DC = Cfg<D>::DC;
  constexpr int NT = Cfg<D>::NT;
  extern __shared__ float smem_f32[];
  float* sK = smem_f32;
  float* sV = sK + BK * S;
  float* sQ = sV + BK * S;
  float* sG = sQ + BQ * S;   // dO
  float* sPT = sG + BQ * S;  // P^T  [key][query]
  float* sDST = sPT + BK * PS;  // dS^T [key][query]
  float* sL = sDST + BK * PS;   // lse of the q tile's rows
  float* sD = sL + BQ;          // delta of the q tile's rows

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;

  load_tile_f32<D>(sK, k + b * st.k_sb + h * st.k_sh, st.k_sl, k0, L);
  load_tile_f32<D>(sV, v + b * st.v_sb + h * st.v_sh, st.v_sl, k0, L);
  const float* qbase = q + b * st.q_sb + h * st.q_sh;
  const float* gbase = dout + b * st.g_sb + h * st.g_sh;

  float acc_k[RT][DC], acc_v[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_q = (L + BQ - 1) / BQ;
  // Under causal masking the q tiles before this kv tile see none of its keys.
  for (int qt = causal ? k0 / BQ : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous q-side tiles
    load_tile_f32<D>(sQ, qbase, st.q_sl, q0, L);
    load_tile_f32<D>(sG, gbase, st.g_sl, q0, L);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int row = q0 + i;
      sL[i] = row < L ? lse[(int64_t)bh * L + row] : 0.f;
      sD[i] = row < L ? delta[(int64_t)bh * L + row] : 0.f;
    }
    __syncthreads();

    float st_[RT][8], dpt[RT][8];
    tile_dot<D>(st_, sK, sQ, tr, tc);
    tile_dot<D>(dpt, sV, sG, tr, tc);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int kpos = k0 + tr * RT + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = tc + 8 * j;
        const int qpos = q0 + qc;
        const bool live = qpos < L && kpos < L && !(causal && kpos > qpos);
        const float p = live ? expf(st_[i][j] * scale - sL[qc]) : 0.f;
        sPT[(tr * RT + i) * PS + qc] = p;
        sDST[(tr * RT + i) * PS + qc] = live ? p * (dpt[i][j] - sD[qc]) * scale : 0.f;
      }
    }
    __syncwarp();  // a row group's P^T, dS^T rows are written and read by its own warp
    tile_accum<D>(acc_v, sPT, sG, tr, tc);
    tile_accum<D>(acc_k, sDST, sQ, tr, tc);
  }
  store_rows<D>(dk, acc_k, b, h, H, L, k0, tr, tc);
  store_rows<D>(dv, acc_v, b, h, H, L, k0, tr, tc);
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int B, int H,
                          int L, int causal, const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * C::S + (size_t)BQ * C::PS);
  cudaError_t err = opt_in_smem(flash_bwd_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BQ - 1) / BQ);
  flash_bwd_dq_f32_kernel<D><<<grid, C::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, L, causal, 1.0f / sqrtf((float)D), st);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int B,
                           int H, int L, int causal, const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * C::S
                                           + (size_t)2 * BK * C::PS + 2 * BQ);
  cudaError_t err = opt_in_smem(flash_bwd_dkv_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BK - 1) / BK);
  flash_bwd_dkv_f32_kernel<D><<<grid, C::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, L, causal,
      1.0f / sqrtf((float)D), st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: [B, L, H, D] with unit stride on D and element strides
// (b, l, h) given per tensor (bf16: 16-byte aligned pointers and strides);
// lse, delta: contiguous [B, H, L] f32; dq, dk, dv: contiguous [B, L, H, D]
// in the input dtype.  dtype: 0 = float32, 1 = bfloat16.  Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int ptd_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int B, int H, int L, int D, int dtype, int causal,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long g_sb, long long g_sl, long long g_sh, void* stream) {
  const Strides st{q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, g_sb, g_sl, g_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dq_f32<64>(q, k, v, dout, lse, delta, dq, B, H, L, causal, st, s);
  if (dtype == 0 && D == 128) return launch_dq_f32<128>(q, k, v, dout, lse, delta, dq, B, H, L, causal, st, s);
  if (dtype == 1 && D == 64) return launch_dq_mma<64>(q, k, v, dout, lse, delta, dq, B, H, L, causal, st, s);
  if (dtype == 1 && D == 128) return launch_dq_mma<128>(q, k, v, dout, lse, delta, dq, B, H, L, causal, st, s);
  return cudaErrorInvalidValue;
}

extern "C" int ptd_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int B, int H, int L, int D, int dtype, int causal,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long g_sb, long long g_sl, long long g_sh, void* stream) {
  const Strides st{q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, g_sb, g_sl, g_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, causal, st, s);
  if (dtype == 0 && D == 128) return launch_dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, B, H, L, causal, st, s);
  if (dtype == 1 && D == 64) return launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, causal, st, s);
  if (dtype == 1 && D == 128) return launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, B, H, L, causal, st, s);
  return cudaErrorInvalidValue;
}
