// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded through ctypes by ops/flash_attention.py).
//
// Replaces the TPU kernel pytorch_distributed_tpu/ops/flash_attention.py
// `_fwd_kernel` (launched by `_flash_fwd`): causal or full attention over
// q, k, v [B, L, H, D] with an online softmax (f32 running max, running sum
// and accumulator), writing O in the input dtype and lse = m + log(l) in f32.
// Same constants: scale 1/sqrt(D), mask value -1e30, l clamped at 1e-30.
//
// What differs from the TPU kernel, by design:
// - The TPU walks the kv blocks as a sequential grid axis and carries the
//   running statistics in VMEM scratch from one grid step to the next.  Here
//   one CTA owns one (b*h, 64-row q tile) and loops over the 64-row kv tiles
//   itself; under causal masking the loop stops at the diagonal tile, which
//   replaces the TPU's `pl.when` block skip.  CTAs of the heaviest q tiles
//   are launched first (blockIdx.y runs from the last tile down) so the
//   causal triangle does not leave a tail of long CTAs at the end.
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
// ms at 3.35 TB/s.  The work is compute-bound, and the design keeps it so:
// each k/v tile is read from device memory once per q tile and reused from
// shared memory by 64 query rows, and S and P never leave the SM.  This
// first version computes on the CUDA cores in f32 (4x8 register microtiles
// of S and 4x(D/8) of O per thread, conflict-free padded shared tiles), so
// its ceiling is the f32 FMA rate, not the tensor-core rate: moving the two
// products onto wgmma with TMA-fed tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per kv tile
constexpr int NT = 128;         // threads per CTA: 16 row groups x 8 lanes
constexpr int PS = BK + 2;      // row stride of the P tile: 4 groups x 8 lanes on distinct banks
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "load_tile fills q and kv tiles of one height");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of one (b, h) slice into a shared f32 tile with row
// stride D + 1 (the +1 puts the 8 lanes that read 8 different rows of one
// column on 8 different banks).  Rows at or past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t stride_l, int row0, int L) {
  constexpr int S = D + 1;
  for (int i = threadIdx.x; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * S + c] = row < L ? to_f32(src[(int64_t)row * stride_l + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int L, int causal, float scale,
                 int64_t q_sb, int64_t q_sl, int64_t q_sh,
                 int64_t k_sb, int64_t k_sl, int64_t k_sh,
                 int64_t v_sb, int64_t v_sl, int64_t v_sh) {
  constexpr int S = D + 1;
  constexpr int DC = D / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
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

  load_tile<T, D>(sQ, q + b * q_sb + h * q_sh, q_sl, q0, L);
  const T* kbase = k + b * k_sb + h * k_sh;
  const T* vbase = v + b * v_sb + h * v_sh;

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
    load_tile<T, D>(sK, kbase, k_sl, k0, L);
    load_tile<T, D>(sV, vbase, v_sl, k0, L);
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
    T* orow = o + ((int64_t)b * L + row) * o_sl + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tc + 8 * c] = from_f32<T>(acc[i][c] / safe_l);
    if (tc == 0) lse[(int64_t)bh * L + row] = m[i] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int L, int causal,
                   const long long* st, cudaStream_t stream) {
  constexpr int S = D + 1;
  constexpr size_t smem = sizeof(float) * ((size_t)(BQ + 2 * BK) * S + (size_t)BQ * PS);
  // Above 48 KB a CTA gets dynamic shared memory only after this opt-in; a
  // launch without it is refused and shows only in cudaGetLastError.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (L + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, L, causal, 1.0f / sqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, L, H, D] with unit stride on D and element strides
// (b, l, h) given per tensor; o: contiguous [B, L, H, D] in the input dtype;
// lse: contiguous [B, H, L] f32.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ptd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int L, int D, int dtype, int causal,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, void* stream) {
  const long long st[9] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(q, k, v, o, lse, B, H, L, causal, st, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(q, k, v, o, lse, B, H, L, causal, st, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, L, causal, st, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, L, causal, st, s);
  return cudaErrorInvalidValue;
}
