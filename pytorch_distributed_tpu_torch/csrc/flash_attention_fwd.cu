// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by ops/flash_attention.py).
//
// Replaces the TPU kernel pytorch_distributed_tpu/ops/flash_attention.py
// `_fwd_kernel` (launched by `_flash_fwd`): causal or full attention over
// q, k, v [B, L, H, D] with an online softmax (f32 running max, running sum
// and accumulator), writing O in the input dtype and lse = m + log(l) in f32.
// Same constants: scale 1/sqrt(D), mask value -1e30, l clamped at 1e-30.
//
// Two instantiations by dtype:
// - bf16, the serving and training path (`flash_fwd_mma_kernel`): both
//   products on the tensor cores as warpgroup wgmma (m64nNk16 bf16, f32
//   accumulation), with the tiles and helpers K2/K3 use (hopper_mma.cuh);
// - f32 (`flash_fwd_f32_kernel`): the same loop on the f32 CUDA cores, for
//   checks that must exclude the tensor cores' roundings.
//
// What differs from the TPU kernel, by design:
// - The TPU walks the kv blocks as a sequential grid axis and carries the
//   running statistics in VMEM scratch from one grid step to the next.  Here
//   one CTA owns one (b*h, q tile) and loops over the kv tiles itself; under
//   causal masking the loop stops at the diagonal tile, which replaces the
//   TPU's `pl.when` block skip.  CTAs of the heaviest q tiles are launched
//   first (blockIdx.y runs from the last tile down) so the causal triangle
//   does not leave a tail of long CTAs at the end.
// - q, k, v are read in place through their strides (no [B*H, L, D]
//   transpose), so the q/k/v views of the fused qkv projection go in as
//   they are.  lse is written as [B, H, L] f32, not lane-broadcast.
// - The last tile may be ragged: rows past L load as zeros, keys past L are
//   masked like causal ones, and rows past L are not stored.  Every row sees
//   key 0 in its first tile, so its running max is finite before any masked
//   score reaches the exponential.
//
// Bound at the serving path's shape (B=4, L=4096, H=16, D=64, causal, bf16):
// the causal pairs need 4*D*L*(L+1)/2*B*H = 1.37e11 FLOP, 0.139 ms at the
// card's 989 TFLOP/s bf16 tensor-core peak; q, k, v and O are 134 MB, 0.040
// ms at 3.35 TB/s.  The work is compute-bound, so the bf16 design is about
// the tensor cores:
// - Two consumer warpgroups per CTA, 64 query rows each (wgmma's M), so a
//   CTA covers 128 rows and every k, v tile it loads serves both: half the
//   k/v traffic per row of one warpgroup per CTA.  Each warpgroup loads its
//   q tile once into register A fragments (ldmatrix from the swizzled
//   tile), so s = q.k^T reads only k from shared memory.
// - s = q.k^T is a register-A wgmma with k K-major in 128-byte-swizzled
//   shared memory, leaving s in f32 accumulator registers.  The online
//   softmax runs there: f32 running max and sum per row (a row's 8-column
//   blocks sit in the 4 lanes of a quad, so the row max reduces with 2
//   shuffles), exp2 with scale*log2(e) folded in, l summed from the f32 p.
//   Masks are applied only on the diagonal and ragged tiles, in a branch of
//   their own: predicated on every tile, their index arithmetic was a large
//   share of the instructions the softmax issues.
//   p is then rounded to bf16 into register A fragments (two adjacent
//   8-column accumulator blocks are one 16-deep A fragment) and o += p.v is
//   a register-A wgmma with v read MN-major (transposed).  Rounding p to
//   bf16 is what FlashAttention-2/3 and PyTorch's own attention do; the
//   plain version keeps p f32, and the card's bf16 tolerance covers it.
// - The products overlap the softmax, as in FlashAttention-3: tile t's s
//   is issued, then tile t-1's correction and p.v; the softmax of tile t
//   runs while p.v is in flight.  p of the previous tile waits in its bf16
//   fragments, so one set of s registers suffices.  Writing s's zeros
//   before a wgmma while another is in flight made ptxas serialise them
//   (C7515); the first 16-deep step of s overwrites instead (scale-d 0).
// - k and v go through rings of two stages each, filled by 16-byte
//   cp.async one tile ahead of their use (k_{t+1} and v_t while tile t's
//   products run), one CTA barrier a tile.  Under causal masking the
//   warpgroup whose rows all precede a tile skips its products (a fully
//   masked tile changes nothing once the running max is finite) but still
//   takes part in the CTA's barriers.
// - Rounding and order are fixed, with no atomics: reruns give the same
//   bits.
// Registers (-Xptxas -v, nvcc 12.8): 127 at D=64, held to two CTAs of 256
// threads per SM; 202 at D=128, one CTA per SM; no spills.  34% of the
// operations bound at the path shape on an H100 (PERF.md).
// The f32 instantiation: 4x8 register microtiles of S and 4x(D/8) of O per
// thread over conflict-free padded shared tiles, on the f32 FMA units.

#include "hopper_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// Tile shape per head dim: NWG consumer warpgroups of 64 query rows, kv
// tiles of BN keys, and the CTAs per SM the registers are held to.
template <int D>
struct Fwd {
  static constexpr int NWG = 2;
  static constexpr int BN = 64;  // mma_qk_rs is written for 64-key tiles
  static constexpr int MIN_CTAS = D == 64 ? 2 : 1;
  static constexpr int NTH = NWG * WG_THREADS;
  static constexpr int BQ = NWG * WG_ROWS;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The warpgroup's q tile [64 x D] (swizzled, in shared memory) as register
// A fragments, one per 16-deep step: each warp's 16 rows, loaded once.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 16][4], uint32_t sQ) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int r = 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qa[kk], sQ + swz<WG_ROWS>(r, 2 * kk + (lane >> 4)));
}

// s[64 x 64] = Q . K^T with Q from registers and the kv tile K-major in
// shared memory; issued and committed.
template <int D>
__device__ __forceinline__ void mma_qk_rs(float (&s)[8][4], const uint32_t (&qa)[D / 16][4],
                                          uint32_t sK) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_kmajor_n64(s, qa[kk], gmma_desc(sK + (kk >> 2) * (64 * 128) + (kk & 3) * 32, 16, 1024),
                        kk > 0);
  wg_commit();
}

template <int D>
__global__ void __launch_bounds__(Fwd<D>::NTH, Fwd<D>::MIN_CTAS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int L, int causal, float scale,
                     int64_t q_sb, int64_t q_sl, int64_t q_sh,
                     int64_t k_sb, int64_t k_sl, int64_t k_sh,
                     int64_t v_sb, int64_t v_sl, int64_t v_sh) {
  using C = Fwd<D>;
  constexpr int BN = C::BN, NTH = C::NTH;
  constexpr uint32_t TQ = WG_ROWS * D * 2, TU = BN * D * 2;  // tile bytes
  extern __shared__ unsigned char smem[];
  // q tiles, then two stages of k tiles, then two of v tiles.
  const uint32_t sQ = aligned_smem(smem), sK = sQ + C::NWG * TQ, sV = sK + 2 * TU;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;  // warp in its warpgroup
  const int r0 = q0 + wg * WG_ROWS;  // the warpgroup's first query row
  const uint32_t sQw = sQ + wg * TQ;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  int n_kv = (L + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (q0 + C::BQ - 1) / BN + 1);  // stop at the diagonal tile
  // The warpgroup's own last tile: past it every key follows every row.
  const int last = causal ? min(n_kv - 1, (r0 + WG_ROWS - 1) / BN) : n_kv - 1;

  auto sk = [&](int t) { return sK + (t & 1) * TU; };  // tile t's k stage
  auto sv = [&](int t) { return sV + (t & 1) * TU; };  // tile t's v stage
#pragma unroll
  for (int g = 0; g < C::NWG; ++g)
    load_tile<D, WG_ROWS, NTH>(sQ + g * TQ, q + b * q_sb + h * q_sh, q_sl, q0 + g * WG_ROWS, L);
  load_tile<D, BN, NTH>(sk(0), kb, k_sl, 0, L);
  cp_async_commit();
  // k of tile t+1 and v of tile t, copied while tile t's s and tile t-1's
  // p . v run: k one tile ahead of its use, v two.
  auto load_next = [&](int t) {
    if (t + 1 < n_kv) load_tile<D, BN, NTH>(sk(t + 1), kb, k_sl, (t + 1) * BN, L);
    load_tile<D, BN, NTH>(sv(t), vb, v_sl, t * BN, L);
    cp_async_commit();
  };

  const float sl2 = scale * LOG2E;
  int qpos[2];
  float m[2], l[2], corr[2];  // running max of the unscaled scores; this thread's share of the sum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = r0 + 16 * w + (lane >> 2) + 8 * i;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float acc[D / 8][4], s[BN / 8][4];
  uint32_t pa[BN / 16][4];  // p of the previous tile, bf16 A fragments
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // Online softmax of tile t's s in place (s becomes p in f32): the running
  // max and this thread's share of the running sum move on, and corr is the
  // factor the accumulator must take before p . v_t is added.
  auto softmax = [&](int t) {
    const int k0 = t * BN;
    const bool edge = k0 + BN > L || (causal && k0 + BN - 1 > r0);
    if (edge) {  // the diagonal and the ragged last tile only
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          if (kpos >= L || (causal && kpos > qpos[e >> 1])) s[j][e] = NEG_INF;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float mb[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = ex2((m[i] - mx[i]) * sl2);
      m[i] = mx[i];
      mb[i] = mx[i] * sl2;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[j][e], sl2, -mb[e >> 1]));
        s[j][e] = p;
        ls[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + ls[i];
  };
  // o = o * corr + p . v_t, with p the previous tile's fragments.
  auto rescale_pv = [&](int t) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    mma_pu<D, BN>(acc, pa, sv(t));
  };

  // Tile 0 for every warpgroup: key 0 is in every row's first tile.
  cp_async_wait_0();
  __syncthreads();
  load_next(0);
  uint32_t qa[D / 16][4];  // q as register A fragments, loaded once
  load_q_frags<D>(qa, sQw);
  mma_qk_rs<D>(s, qa, sk(0));
  wg_wait_all();
  reg_fence<BN / 8>(s);
  softmax(0);
  to_a_frags<BN>(pa, s);

  // Tile t: s = q . k_t^T goes to the tensor cores first; while it runs the
  // accumulator takes tile t-1's correction and p . v_{t-1} is issued; the
  // softmax of tile t then runs while p . v_{t-1} is in flight.  The copies
  // of k_{t+1} and v_t go meanwhile into the stages of k_{t-1} and v_{t-2},
  // whose products every warpgroup has waited for before the barrier.
  for (int t = 1; t < n_kv; ++t) {
    cp_async_wait_0();  // k_t and v_{t-1} have landed (this thread's copies)
    __syncthreads();    // everyone's copies
    load_next(t);
    if (t <= last) {  // uniform across the warpgroup
      mma_qk_rs<D>(s, qa, sk(t));
      rescale_pv(t - 1);
      wg_wait_1();  // s has landed; p . v_{t-1} may still run
      reg_fence<BN / 8>(s);
      softmax(t);
      wg_wait_all();
      reg_fence<D / 8>(acc);
      to_a_frags<BN>(pa, s);
    } else if (t == last + 1) {  // the warpgroup's last p . v, before its stage is reused
      rescale_pv(last);
      wg_wait_all();
      reg_fence<D / 8>(acc);
    }
  }
  cp_async_wait_0();  // v of the last tile
  __syncthreads();
  if (last == n_kv - 1) {
    rescale_pv(last);
    wg_wait_all();
    reg_fence<D / 8>(acc);
  }

  float safe_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    safe_l[i] = fmaxf(l[i], 1e-30f);
    if ((lane & 3) == 0 && qpos[i] < L)
      lse[(int64_t)bh * L + qpos[i]] = m[i] * scale + logf(safe_l[i]);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] /= safe_l[e >> 1];
  store_acc<D>(o, acc, qpos, b, h, H, L, lane);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int H, int L, int causal, const long long* st,
                       cudaStream_t stream) {
  using C = Fwd<D>;
  constexpr size_t smem = (size_t)C::NWG * WG_ROWS * D * 2 + 4 * (size_t)C::BN * D * 2 + 1024;
  cudaError_t err = opt_in_smem(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + C::BQ - 1) / C::BQ);
  flash_fwd_mma_kernel<D><<<grid, C::NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, L, causal, 1.0f / sqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per kv tile
constexpr int NT = 128;         // threads per CTA: 16 row groups x 8 lanes
constexpr int PS = BK + 2;      // row stride of the P tile: 4 groups x 8 lanes on distinct banks
static_assert(BQ == BK, "load_tile_f32 fills q and kv tiles of one height");

// Rows [row0, row0 + 64) of one (b, h) slice into a shared f32 tile with row
// stride D + 1 (the +1 puts the 8 lanes that read 8 different rows of one
// column on 8 different banks).  Rows at or past L are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              int64_t stride_l, int row0, int L) {
  constexpr int S = D + 1;
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * S + c] = row < L ? src[(int64_t)row * stride_l + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int L, int causal, float scale,
                     int64_t q_sb, int64_t q_sl, int64_t q_sh,
                     int64_t k_sb, int64_t k_sl, int64_t k_sh,
                     int64_t v_sb, int64_t v_sl, int64_t v_sh) {
  constexpr int S = D + 1;
  constexpr int DC = D / 8;     // output columns per thread
  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;
  float* sK = sQ + BQ * S;
  float* sV = sK + BK * S;
  float* sP = sV + BK * S;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // Thread (tr, tc) owns query rows tr*4 .. tr*4+3 of the tile, score
  // columns tc + 8j and output columns tc + 8c.  The 8 lanes of one row
  // group sit in one warp, so row max and row sum reduce with 3 shuffles.
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;

  load_tile_f32<D>(sQ, q + b * q_sb + h * q_sh, q_sl, q0, L);
  const float* kbase = k + b * k_sb + h * k_sh;
  const float* vbase = v + b * v_sb + h * v_sh;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (L + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);  // stop at the diagonal tile

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K, V tiles
    load_tile_f32<D>(sK, kbase, k_sl, k0, L);
    load_tile_f32<D>(sV, vbase, v_sl, k0, L);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(tr * 4 + i) * S + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = sK[(tc + 8 * j) * S + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tc + 8 * j;
        float x = s[i][j] * scale;
        if (kpos >= L || (causal && kpos > qpos)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(tr * 4 + i) * PS + tc + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row group's P rows are written and read by its own warp

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(tr * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * S + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  const int64_t o_sl = (int64_t)H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= L) continue;
    const float safe_l = fmaxf(l[i], 1e-30f);
    float* orow = o + ((int64_t)b * L + row) * o_sl + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tc + 8 * c] = acc[i][c] / safe_l;
    if (tc == 0) lse[(int64_t)bh * L + row] = m[i] + logf(safe_l);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int H, int L, int causal, const long long* st,
                       cudaStream_t stream) {
  constexpr int S = D + 1;
  constexpr size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * S + (size_t)BQ * PS);
  cudaError_t err = opt_in_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BQ - 1) / BQ);
  flash_fwd_f32_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), H, L, causal, 1.0f / sqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, L, H, D] with unit stride on D and element strides
// (b, l, h) given per tensor (bf16: 16-byte aligned pointers and strides);
// o: contiguous [B, L, H, D] in the input dtype; lse: contiguous [B, H, L]
// f32.  dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ptd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int L, int D, int dtype, int causal,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_f32<64>(q, k, v, o, lse, B, H, L, causal, st, s);
  if (dtype == 0 && D == 128) return launch_f32<128>(q, k, v, o, lse, B, H, L, causal, st, s);
  if (dtype == 1 && D == 64) return launch_mma<64>(q, k, v, o, lse, B, H, L, causal, st, s);
  if (dtype == 1 && D == 128) return launch_mma<128>(q, k, v, o, lse, B, H, L, causal, st, s);
  return cudaErrorInvalidValue;
}
