// Flash attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by ops/flash_attention.py).  Two kernels:
//
// - K2 `flash_bwd_dq_kernel` replaces pytorch_distributed_tpu/ops/
//   flash_attention.py `_bwd_dq_kernel` (launched by `_bwd_pallas`):
//   dq = sum over kv of ds . k;
// - K3 `flash_bwd_dkv_kernel` replaces `_bwd_dkv_kernel`:
//   dv = sum over q of p^T . dO and dk = sum over q of ds^T . q.
//
// Both recompute, per (q, kv) tile pair, what `_recompute_p_ds` recomputes:
// s = q.k^T * scale, p = exp(s - lse), dp = dO.v^T, ds = p * (dp - delta) *
// scale, with lse [B, H, L] f32 saved by the forward kernel (K1) and
// delta = rowsum(dO * O) [B, H, L] f32 computed by the caller in plain
// PyTorch, as the JAX package computes it outside its kernels too.  Same
// constants as K1: scale 1/sqrt(D), masked pairs get p = 0 (the JAX
// package's exp(-1e30 - lse)).
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
//   contiguous [B, L, H, D] in the input dtype.
// - Ragged last tiles: rows past L load as zeros, their lse and delta are
//   not read (0 is used), and every pair with a row or a key past L, or a
//   key after its query under causal masking, gets p = 0 and ds = 0 by
//   predicate, not through exp of a masked score, so no inf can meet a 0.
//
// Bound at the training path's shape (B=4, L=4096, H=16, D=64, causal,
// bf16; 5.37e8 causal pairs): K2 does 6*D FLOP per pair (s, dp, dq),
// 2.06e11 FLOP, 0.208 ms at the card's 989 TFLOP/s bf16 tensor-core peak;
// K3 does 8*D (s, dp, dv, dk), 2.75e11 FLOP, 0.278 ms.  Each reads q, k, v,
// dO, lse and delta and writes its outputs once: 170 MB (K2) and 203 MB
// (K3), about 0.05-0.06 ms at 3.35 TB/s.  Both are compute-bound.  As in
// K1, each tile loaded into shared memory is reused by 64 rows and s, p, dp
// and ds never leave the SM; this first version computes on the CUDA cores
// in f32 (register microtiles of RT rows x 8 columns per thread), so its
// ceiling is the f32 FMA rate.  wgmma with TMA-fed tiles comes next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
static_assert(BQ == BK, "load_tile fills q and kv tiles of one height; the "
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of one (b, h) slice into a shared f32 tile with
// row stride D + 1.  Rows at or past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t stride_l, int row0, int L) {
  constexpr int S = Cfg<D>::S, NT = Cfg<D>::NT;
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * S + c] = row < L ? to_f32(src[(int64_t)row * stride_l + c]) : 0.f;
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
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           float (&acc)[Cfg<D>::RT][Cfg<D>::DC],
                                           int b, int h, int H, int L, int row0,
                                           int tr, int tc) {
  constexpr int RT = Cfg<D>::RT, DC = Cfg<D>::DC;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + tr * RT + i;
    if (row >= L) continue;
    T* orow = out + (((int64_t)b * L + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tc + 8 * c] = from_f32<T>(acc[i][c]);
  }
}

struct Strides {
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, g_sb, g_sl, g_sh;
};

// K2.  Thread (tr, tc) owns query rows tr*RT .. tr*RT+RT-1 of the tile,
// score columns tc + 8j, and dq columns tc + 8c.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int L, int causal, float scale,
                    Strides st) {
  constexpr int RT = Cfg<D>::RT, S = Cfg<D>::S, PS = Cfg<D>::PS, DC = Cfg<D>::DC;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BQ * S;   // dO
  float* sK = sG + BQ * S;
  float* sV = sK + BK * S;
  float* sDS = sV + BK * S;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;

  load_tile<T, D>(sQ, q + b * st.q_sb + h * st.q_sh, st.q_sl, q0, L);
  load_tile<T, D>(sG, dout + b * st.g_sb + h * st.g_sh, st.g_sl, q0, L);
  const T* kbase = k + b * st.k_sb + h * st.k_sh;
  const T* vbase = v + b * st.v_sb + h * st.v_sh;

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
    load_tile<T, D>(sK, kbase, st.k_sl, k0, L);
    load_tile<T, D>(sV, vbase, st.v_sl, k0, L);
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
  store_rows<T, D>(dq, acc, b, h, H, L, q0, tr, tc);
}

// K3.  Thread (tr, tc) owns key rows tr*RT .. tr*RT+RT-1 of the kv tile,
// query columns tc + 8j of the transposed score tile, and dk, dv columns
// tc + 8c.  The tile is computed transposed (s^T = k . q^T) so that the
// rows of P^T and dS^T a thread accumulates from are written by its own
// warp, as in K1.
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int L,
                     int causal, float scale, Strides st) {
  constexpr int RT = Cfg<D>::RT, S = Cfg<D>::S, PS = Cfg<D>::PS, DC = Cfg<D>::DC;
  constexpr int NT = Cfg<D>::NT;
  extern __shared__ float smem[];
  float* sK = smem;
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

  load_tile<T, D>(sK, k + b * st.k_sb + h * st.k_sh, st.k_sl, k0, L);
  load_tile<T, D>(sV, v + b * st.v_sb + h * st.v_sh, st.v_sl, k0, L);
  const T* qbase = q + b * st.q_sb + h * st.q_sh;
  const T* gbase = dout + b * st.g_sb + h * st.g_sh;

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
    load_tile<T, D>(sQ, qbase, st.q_sl, q0, L);
    load_tile<T, D>(sG, gbase, st.g_sl, q0, L);
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
  store_rows<T, D>(dk, acc_k, b, h, H, L, k0, tr, tc);
  store_rows<T, D>(dv, acc_v, b, h, H, L, k0, tr, tc);
}

// Above 48 KB a CTA gets dynamic shared memory only after this opt-in; a
// launch without it is refused and shows only in cudaGetLastError.
template <typename K>
cudaError_t opt_in_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H,
                      int L, int causal, const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * C::S + (size_t)BQ * C::PS);
  cudaError_t err = opt_in_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, C::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, L, causal,
      1.0f / sqrtf((float)D), st);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B,
                       int H, int L, int causal, const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * C::S
                                           + (size_t)2 * BK * C::PS + 2 * BQ);
  cudaError_t err = opt_in_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, C::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      H, L, causal, 1.0f / sqrtf((float)D), st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: [B, L, H, D] with unit stride on D and element strides
// (b, l, h) given per tensor; lse, delta: contiguous [B, H, L] f32; dq, dk,
// dv: contiguous [B, L, H, D] in the input dtype.  dtype: 0 = float32,
// 1 = bfloat16.  Each returns the cudaError_t of its launch (0 on success).
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
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, H, L, causal, st, s);
  if (dtype == 0 && D == 128) return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, H, L, causal, st, s);
  if (dtype == 1 && D == 64) return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, H, L, causal, st, s);
  if (dtype == 1 && D == 128) return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, B, H, L, causal, st, s);
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
  if (dtype == 0 && D == 64) return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, causal, st, s);
  if (dtype == 0 && D == 128) return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, L, causal, st, s);
  if (dtype == 1 && D == 64) return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, L, causal, st, s);
  if (dtype == 1 && D == 128) return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, L, causal, st, s);
  return cudaErrorInvalidValue;
}
