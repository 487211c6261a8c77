// Fused conv -> BatchNorm(+ReLU) backward for Hopper (sm_90a), CUDA C++ with
// a plain C interface (loaded through ctypes by ops/fused_conv_bn.py).  One
// entry point serves both TPU kernels it replaces:
//
// - K4 (ks = 1): pytorch_distributed_tpu/ops/fused_conv_bn.py `_bwd_kernel`
//   (driven by `_fused_dgrad_wgrad`), the 1x1 stride-1 conv;
// - K5 (ks = 3): `_bwd3_kernel` (driven by `_fused_dgrad_wgrad_3x3`), the
//   3x3 stride-1 SAME conv.
//
// What both compute, from the conv's input a [M, Ci], its output y [M, Co],
// the gradient at the BN(+ReLU) output dout [M, Co] (M = N*H*W pixels, NHWC
// rows) and the per-channel vectors vec = [s; t; u; v] f32 [4, Co] that
// `bn_bwd_vectors` reduces beforehand:
//
//   dof = relu ? (s*y + v > 0 ? dout : 0) : dout        (the ReLU mask)
//   dy  = (s*dof + t*y + u) rounded to the input dtype  (BN's input grad)
//   da[p]      = sum over taps k, co of dy[p - off_k][co] * W[k][co][ci]
//   dW[k][co][ci] = sum over pixels p of dy[p][co] * a[p + off_k][ci]   (f32)
//
// with off_k the tap's shift inside the image (none for 1x1) and dy and a
// zero outside the image, as the JAX kernel zero-pads dy and a.  dy is
// rounded to the input dtype before either product, as `_bwd_kernel` casts
// it (`.astype(cdt)`), so bf16 results see the same dy as the JAX side.
//
// What differs from the TPU kernels, by design:
// - The TPU kernels hold a whole M-tile (K4) or a whole image plane (K5) in
//   VMEM and do both products off it, carrying the f32 dW accumulator
//   across a sequential grid.  Here a CTA has at most 227 KB of shared
//   memory (W alone is up to 2 MB bf16) and CTAs run in no order, so each
//   product is its own kernel: dgrad tiles (pixels, Ci) and loops over
//   (taps, Co); wgrad tiles (Co, Ci) per tap and loops over a slice of the
//   pixels.  dy is recomputed from (y, dout, vec) in the prologue of every
//   chunk each product loads, and never written to device memory: that is
//   the fold.
// - dW is reduced across the grid in two deterministic passes: each of
//   `splits` pixel slices writes an f32 partial [taps, Co, Ci] to scratch
//   the wrapper allocates, and a second kernel sums the partials in slice
//   order.  No atomics, so dW is the same bit for bit on every run (the
//   precedent of the flash backward kernels).  The wrapper picks the split
//   count so that about 4 CTAs per SM are in flight on 132 SMs, with at
//   least 256 pixels per slice; at ResNet-50 b256 the scratch stays under
//   13 MB.
// - K5 does not tile whole planes (a 56x56x64 bf16 plane is 401 KB per
//   tensor).  It is an implicit GEMM over 64-pixel tiles of the flattened
//   (n, h, w) order: each tap's source pixel is computed per row, and a
//   source outside the image (or past M) is predicated to zero.  Computing
//   dy there from y = dout = 0 would give dy = u != 0; the predicate gives
//   the JAX kernel's zero-padded dy.  The 1-pixel halo is read from device
//   memory (through L2) by the tiles that need it.
// - Ragged edges: pixel rows past M and channels past Ci or Co load as zero
//   and are not written, so they contribute nothing (the JAX wrapper pads
//   rows with zeros for the same effect).
// - Weights: the wrapper passes W as a contiguous [taps, Co, Ci] tensor in
//   the input dtype.  For 1x1 that is PyTorch's OIHW weight [Co, Ci, 1, 1]
//   itself after the cast; for 3x3 the wrapper permutes OIHW to
//   [kh, kw, Co, Ci] (2.4 M elements at most in ResNet-50).  dW comes out
//   as f32 [taps, Co, Ci], which the wrapper views (1x1) or permutes (3x3)
//   back to OIHW.
//
// Bound.  At the largest ResNet-50 b256 bf16 K4 shape (M = 802,816 pixels,
// Ci = 256, Co = 64) the fold must read y, dout (M*Co each) and a (M*Ci) and
// write da (M*Ci): 1.03 GB, 0.31 ms at 3.35 TB/s, against 4*M*Ci*Co =
// 5.3e10 FLOP, 0.053 ms at 989 TFLOP/s bf16.  K4 is byte-bound at most
// ResNet-50 shapes, K5 (9x the FLOP per byte) operation-bound.  This first
// version computes on the CUDA cores in f32: 64x64 output tiles, 256
// threads with 4x4 register microtiles, 16-deep chunks staged in shared
// memory, bf16 inputs widened to f32 on load (a product of two bf16 values
// is exact in f32, so this is the tensor cores' bf16 x bf16 -> f32
// arithmetic in another summation order).  Its ceiling is the f32 FMA rate,
// far from either bound; wgmma with TMA-fed tiles is the next step.
// Registers (-Xptxas -v, nvcc 12.8, as chip_smoke.py prints them): 64 for
// dgrad, 80 for wgrad, 32 for sum_splits, in every dtype and kernel size;
// 8704 bytes of static shared memory; no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;         // output tile rows
constexpr int TN = 64;         // output tile columns
constexpr int TK = 16;         // reduction chunk
constexpr int NT = 256;        // threads per CTA: 16 x 16, 4 x 4 outputs each
constexpr int SROW = TN + 4;   // padded shared row

static_assert(TM == TN && TM == 4 * 16 && NT == 16 * 16 && TK * TN == 4 * NT,
              "each thread owns a 4x4 microtile and stages 4 elements per chunk");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Pixel geometry of the flattened (n, h, w) rows.  For 1x1 the wrapper
// passes H = W = 1: every shift is zero and only m < M matters.
struct Geo {
  int M, H, W;
};

// Row of pixel m shifted by (dh, dw) inside its own image, or -1 when m is
// past M or the shifted pixel falls outside the image.
__device__ __forceinline__ int shifted(int m, int dh, int dw, const Geo& g) {
  if (m >= g.M) return -1;
  const int q = m % g.W;
  const int p = (m / g.W) % g.H;
  const int pp = p + dh, qq = q + dw;
  if (pp < 0 || pp >= g.H || qq < 0 || qq >= g.W) return -1;
  return m + dh * g.W + dw;
}

// dy at element `off` (channel c) of y/dout, rounded to T.  The operations
// are rounded one by one, in the plain version's order, so that no fused
// multiply-add moves a bf16 rounding boundary.
template <typename T>
__device__ __forceinline__ float dy_elem(const T* __restrict__ y, const T* __restrict__ dout,
                                         const float* __restrict__ vec, int Co, int64_t off,
                                         int c, int relu) {
  const float yf = to_f32(y[off]);
  float dof = to_f32(dout[off]);
  const float s = vec[c];
  if (relu && !(__fadd_rn(__fmul_rn(yf, s), vec[3 * Co + c]) > 0.f)) dof = 0.f;
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dof, s), __fmul_rn(yf, vec[Co + c])),
                            vec[2 * Co + c]);
  return to_f32(from_f32<T>(d));
}

// acc[i][j] += sum_k As[k][ty + 16 i] * Bs[k][tx + 16 j] over one chunk.
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4], const float (*As)[SROW],
                                          const float (*Bs)[SROW], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < TK; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dgrad: one CTA per (64 pixels, 64 input channels); loops over taps and
// 16-channel chunks of Co.  dy of a tap is read at the pixel the tap maps
// onto this one: (h + 1 - kh, w + 1 - kw) for 3x3.
template <typename T, int KS>
__global__ void __launch_bounds__(NT)
dgrad_kernel(const T* __restrict__ y, const T* __restrict__ dout, const float* __restrict__ vec,
             const T* __restrict__ wt, T* __restrict__ da, Geo g, int Ci, int Co, int relu) {
  __shared__ float As[TK][SROW];  // dy, [co][pixel]
  __shared__ float Bs[TK][SROW];  // W, [co][ci]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * TM, c0 = blockIdx.y * TN;
  const int ar = tid / 4, ak = (tid % 4) * 4;    // stages dy of pixel m0 + ar, 4 channels
  const int bk = tid / 16, bc = (tid % 16) * 4;  // stages W row bk, 4 input channels
  float acc[4][4] = {};
  for (int tap = 0; tap < KS * KS; ++tap) {
    const int src = shifted(m0 + ar, KS / 2 - tap / KS, KS / 2 - tap % KS, g);
    const T* wtap = wt + (int64_t)tap * Co * Ci;
    for (int k0 = 0; k0 < Co; k0 += TK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = k0 + ak + e;
        As[ak + e][ar] = (src >= 0 && co < Co)
                             ? dy_elem(y, dout, vec, Co, (int64_t)src * Co + co, co, relu)
                             : 0.f;
        const int kr = k0 + bk, ci = c0 + bc + e;
        Bs[bk][bc + e] = (kr < Co && ci < Ci) ? to_f32(wtap[(int64_t)kr * Ci + ci]) : 0.f;
      }
      __syncthreads();
      mma_chunk(acc, As, Bs, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = c0 + tx + 16 * j;
      if (ci < Ci) da[(int64_t)m * Ci + ci] = from_f32<T>(acc[i][j]);
    }
  }
}

// wgrad: one CTA per (64 output channels, 64 input channels, tap, pixel
// slice); loops over the slice's pixels 16 at a time.  a of a tap is read
// at (h + kh - 1, w + kw - 1) for 3x3.  Writes the slice's f32 partial
// [tap][co][ci] at out + slice * taps * Co * Ci.
template <typename T, int KS>
__global__ void __launch_bounds__(NT)
wgrad_kernel(const T* __restrict__ y, const T* __restrict__ dout, const float* __restrict__ vec,
             const T* __restrict__ a, float* __restrict__ out, Geo g, int Ci, int Co, int relu,
             int rows_per_split) {
  __shared__ float As[TK][SROW];  // dy, [pixel][co]
  __shared__ float Bs[TK][SROW];  // shifted a, [pixel][ci]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_ci = (Ci + TN - 1) / TN;
  const int ci0 = (blockIdx.x % n_ci) * TN, co0 = (blockIdx.x / n_ci) * TM;
  const int tap = blockIdx.y;
  const int dh = tap / KS - KS / 2, dw = tap % KS - KS / 2;
  const int mb = blockIdx.z * rows_per_split;
  const int me = min(g.M, mb + rows_per_split);
  const int lk = tid / 16, lc = (tid % 16) * 4;  // stages pixel row lk, 4 channels
  float acc[4][4] = {};
  for (int r0 = mb; r0 < me; r0 += TK) {
    const int m = r0 + lk;
    const bool live = m < me;
    const int src = live ? shifted(m, dh, dw, g) : -1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = co0 + lc + e;
      As[lk][lc + e] =
          (live && co < Co) ? dy_elem(y, dout, vec, Co, (int64_t)m * Co + co, co, relu) : 0.f;
      const int ci = ci0 + lc + e;
      Bs[lk][lc + e] = (src >= 0 && ci < Ci) ? to_f32(a[(int64_t)src * Ci + ci]) : 0.f;
    }
    __syncthreads();
    mma_chunk(acc, As, Bs, ty, tx);
    __syncthreads();
  }
  float* o = out + ((int64_t)blockIdx.z * KS * KS + tap) * Co * Ci;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    if (co >= Co) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + tx + 16 * j;
      if (ci < Ci) o[(int64_t)co * Ci + ci] = acc[i][j];
    }
  }
}

// dW = the partials summed in slice order (the second, deterministic pass).
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int64_t size, int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < size;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(int64_t)k * size + i];
    out[i] = s;
  }
}

template <typename T, int KS>
cudaError_t launch(const void* y, const void* dout, const void* a, const void* wt,
                   const void* vec, void* da, void* dw, void* scratch, Geo g, int Ci, int Co,
                   int relu, int splits, int rows_per_split, cudaStream_t stream) {
  const T* yp = static_cast<const T*>(y);
  const T* gp = static_cast<const T*>(dout);
  const float* vp = static_cast<const float*>(vec);
  const dim3 dgrid((g.M + TM - 1) / TM, (Ci + TN - 1) / TN);
  dgrad_kernel<T, KS><<<dgrid, NT, 0, stream>>>(yp, gp, vp, static_cast<const T*>(wt),
                                                static_cast<T*>(da), g, Ci, Co, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* part = splits > 1 ? static_cast<float*>(scratch) : static_cast<float*>(dw);
  const dim3 wgrid(((Ci + TN - 1) / TN) * ((Co + TM - 1) / TM), KS * KS, splits);
  wgrad_kernel<T, KS><<<wgrid, NT, 0, stream>>>(yp, gp, vp, static_cast<const T*>(a), part, g,
                                                Ci, Co, relu, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t size = (int64_t)KS * KS * Co * Ci;
  const int blocks = (int)((size + 255) / 256 < 4096 ? (size + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(part, static_cast<float*>(dw), size, splits);
  return cudaGetLastError();
}

}  // namespace

// y, dout: contiguous [M, Co] and a: contiguous [M, Ci] in the input dtype,
// M = N * H * W NHWC pixel rows (ks = 1: pass H = W = 1 and N = M); wt:
// contiguous [ks * ks, Co, Ci] in the input dtype; vec: contiguous [4, Co]
// f32 (s, t, u, v); da: contiguous [M, Ci] in the input dtype; dw:
// contiguous [ks * ks, Co, Ci] f32; scratch: f32 [splits, ks * ks, Co, Ci]
// when splits > 1 (unused otherwise).  splits * rows_per_split must cover M
// and splits must be at most 65535.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int ptd_fused_conv_bn_bwd(const void* y, const void* dout, const void* a,
                                     const void* wt, const void* vec, void* da, void* dw,
                                     void* scratch, int N, int H, int W, int Ci, int Co, int ks,
                                     int dtype, int relu, int splits, int rows_per_split,
                                     void* stream) {
  const long long M = (long long)N * H * W;
  if (M <= 0 || M > 0x7fffffffLL || Ci <= 0 || Co <= 0 || splits < 1 || splits > 65535 ||
      (long long)splits * rows_per_split < M)
    return cudaErrorInvalidValue;
  const Geo g{(int)M, H, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && ks == 1)
    return launch<float, 1>(y, dout, a, wt, vec, da, dw, scratch, g, Ci, Co, relu, splits, rows_per_split, s);
  if (dtype == 0 && ks == 3)
    return launch<float, 3>(y, dout, a, wt, vec, da, dw, scratch, g, Ci, Co, relu, splits, rows_per_split, s);
  if (dtype == 1 && ks == 1)
    return launch<__nv_bfloat16, 1>(y, dout, a, wt, vec, da, dw, scratch, g, Ci, Co, relu, splits, rows_per_split, s);
  if (dtype == 1 && ks == 3)
    return launch<__nv_bfloat16, 3>(y, dout, a, wt, vec, da, dw, scratch, g, Ci, Co, relu, splits, rows_per_split, s);
  return cudaErrorInvalidValue;
}
