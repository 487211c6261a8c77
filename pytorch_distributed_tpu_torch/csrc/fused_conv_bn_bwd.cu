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
//   (taps, Co); wgrad tiles (Co, Ci) (per tap, or all taps in the bf16 3x3
//   kernel) and loops over a slice of the pixels.  dy is recomputed from
//   (y, dout, vec) for every chunk each product loads, and never written
//   to device memory: that is the fold.  So the two kernels read y and dout
//   once each: 1.2x the bound's bytes at 256->64, 1.8x at 64->256 (below).
// - dW is reduced across the grid in two deterministic passes: each of
//   `splits` pixel slices writes an f32 partial [taps, Co, Ci] to scratch
//   the wrapper allocates, and a second kernel sums the partials in slice
//   order.  No atomics, so dW is the same bit for bit on every run (the
//   precedent of the flash backward kernels).  The wrapper picks the split
//   count from the wgrad grid that `ptd_fused_conv_bn_wgrad_tiles` reports
//   (CTAs per slice and pixel chunk): for the CUDA-core wgrad about 4 CTAs
//   per SM in flight on 132 SMs, with at least 256 pixels per slice; for
//   the bf16 tensor-core wgrads (one CTA per SM) about two full waves.  At
//   ResNet-50 b256 the scratch stays under 40 MB.
// - K5 does not tile whole planes (a 56x56x64 bf16 plane is 401 KB per
//   tensor).  It is an implicit GEMM over pixel tiles of the flattened
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
// 5.3e10 FLOP, 0.053 ms at 989 TFLOP/s bf16.  Every ResNet-50 K4 launch does
// those 5.3e10 FLOP (1.05e11 at 1024->512); the 33 launches of a b256 step
// are bound by bytes down to stage 3 and by operations at stage 4, 4.81 ms
// in all (chip_smoke.py's bound).  K5 (9x the FLOP per byte) is
// operation-bound.
//
// Three designs, by instantiation:
// - f32 (K4 and K5): the CUDA cores, 64x64 output tiles, 256 threads with
//   4x4 register microtiles, 16-deep chunks staged in shared memory.  Its
//   ceiling is the f32 FMA rate; it serves the f32 checks.  Registers
//   (-Xptxas -v, nvcc 12.8): 64 for dgrad, 80 for wgrad, 32 for sum_splits;
//   8704 bytes of static shared memory.
// - bf16 K4 (`dgrad1_mma_kernel`, `wgrad1_mma_kernel`): the tensor cores
//   through warpgroup wgmma (m64nNk16, f32 accumulate, N = 64, 128 or 256
//   by the channel count), both operands read by 128-byte-swizzle
//   descriptors: a 1x1 conv has no halo, so every operand is a plain tile.
//   dgrad (da = dy . W): A the dy tile, K-major; B the W tile, MN-major;
//   persistent CTAs of 2 warpgroups walk (128-pixel tile, 64-channel chunk
//   of Co) items through a 3-stage cp.async ring that runs across tile
//   boundaries, and each tile's da leaves through shared memory in 16-byte
//   rows.  wgrad (dW^T = a^T . dy over pixel slices): A the a tile, B the dy
//   tile, both MN-major; a CTA of 2 warpgroups holds a 128 (ci) x N (co)
//   tile over 64-pixel chunks in a 2- or 3-stage ring.  Both form dy in
//   place of the y tile, which costs more than the products: a thread keeps
//   its 8 channels' (s, t, u, v) in registers and converts its rows with
//   their loads in flight together.  Channel tiles that share pixels are
//   adjacent in launch order, so that repeated reads of y, dout and a come
//   from L2.  Registers: 109-110 / 150 / 244-252 for dgrad and 109-111 /
//   149-153 / 202-208 for wgrad at N = 64 / 128 / 256, no spills.  On an
//   H100, 59% of the byte bound at 256->64 and 30% at 64->256, where dy is
//   formed twice and y and dout read twice; 9.5-15% at stages 3-4, where dy
//   is formed once per 256 input channels (dgrad) or 128 (wgrad): the
//   conversion's instructions, not the bytes or the products, bound them
//   (PERF.md).
// - bf16 K5 (`dgrad3_mma_kernel`, `wgrad3_mma_kernel`): the tensor cores,
//   through warpgroup wgmma (m64nNk16, f32 accumulate) with the A operand
//   in registers.  A tap's shifted operand is the halo tile shifted by the
//   tap's offset, row by row, with each out-of-image row (above, below, or
//   across the left or right edge into the neighbouring image row)
//   replaced by a row of zeros.  wgmma's shared-memory descriptors read
//   8-row swizzle atoms at one stride, so such a view cannot be one; but
//   ldmatrix takes an address per row, so it loads the view into register
//   A fragments at no cost, and the other operand, a plain tile, is read
//   by a descriptor.  dgrad's A is the shifted dy halo and its B the tap's
//   W tile (MN-major); wgrad computes dW^T, A the shifted a halo (loaded
//   transposed) and B the chunk's dy tile (MN-major).  dgrad computes dy
//   once per 64-channel chunk for its 128 pixels and their halo and reads
//   the 9 taps from it; W streams through a ring of tap tiles copied two
//   steps ahead.  wgrad keeps all 9 taps of a 64 x 64 (ci, co) tile in one
//   CTA (3 warpgroups), so dy and a are read once per 128-pixel chunk for
//   all taps.  The halo is the contiguous rows from W + 1 before a tile to
//   W + 1 after it while wgrad's ring of three such halos fits (W <= 106,
//   every ResNet-50 plane); wider planes stage only the three bands of 130
//   rows the taps touch (from W + 1 before, 1 before and W - 1 after the
//   tile), a footprint independent of W, with two stages of a in wgrad (a
//   third does not fit), so every plane the slot rule folds runs (up to
//   2656 pixels wide at h = 1).  Fragments are written, and loops close,
//   only with no wgmma in flight: ptxas serialises every wgmma otherwise
//   (C7513, C7515).  See the kernels for their layouts.  Registers: 80
//   (dgrad, 64 channels a CTA), 128 (128 channels), 168 (wgrad); the
//   banded wgrad spills 16 bytes, the banded element-wise dgrad 64.  On an
//   H100, 19% of the bound at 56x56x64, 22% at 28x28x128 and 14x14x256 and
//   17% at 7x7x512, slower than dy + cuDNN at 7x7x512 (PERF.md): the dy
//   prologues and the copies are not hidden behind the products.
//
// Products of bf16 values are exact in f32 and summed in f32, and dy is
// formed with the plain version's roundings, so the bf16 kernels differ
// from the plain version in summation order only.

#include "hopper_mma.cuh"

namespace {

constexpr int TM = 64;         // output tile rows
constexpr int TN = 64;         // output tile columns
constexpr int TK = 16;         // reduction chunk
constexpr int NT = 256;        // threads per CTA: 16 x 16, 4 x 4 outputs each
constexpr int SROW = TN + 4;   // padded shared row

static_assert(TM == TN && TM == 4 * 16 && NT == 16 * 16 && TK * TN == 4 * NT,
              "each thread owns a 4x4 microtile and stages 4 elements per chunk");

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

// dy at element `off` (channel c) of f32 y/dout.  The operations are rounded
// one by one, in the plain version's order: no fused multiply-add.
__device__ __forceinline__ float dy_elem(const float* __restrict__ y,
                                         const float* __restrict__ dout,
                                         const float* __restrict__ vec, int Co, int64_t off,
                                         int c, int relu) {
  const float yf = y[off];
  float dof = dout[off];
  const float s = vec[c];
  if (relu && !(__fadd_rn(__fmul_rn(yf, s), vec[3 * Co + c]) > 0.f)) dof = 0.f;
  return __fadd_rn(__fadd_rn(__fmul_rn(dof, s), __fmul_rn(yf, vec[Co + c])), vec[2 * Co + c]);
}

// The same dy from f32 y and dout and the channel's (s, t, u, v), before
// its rounding: the tensor-core kernels' form, on values already loaded.
__device__ __forceinline__ float dy_val(float yf, float dof, float s, float t, float u, float v,
                                        int relu) {
  if (relu && !(__fadd_rn(__fmul_rn(yf, s), v) > 0.f)) dof = 0.f;
  return __fadd_rn(__fadd_rn(__fmul_rn(dof, s), __fmul_rn(yf, t)), u);
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
template <int KS>
__global__ void __launch_bounds__(NT)
dgrad_kernel(const float* __restrict__ y, const float* __restrict__ dout,
             const float* __restrict__ vec, const float* __restrict__ wt, float* __restrict__ da,
             Geo g, int Ci, int Co, int relu) {
  __shared__ float As[TK][SROW];  // dy, [co][pixel]
  __shared__ float Bs[TK][SROW];  // W, [co][ci]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * TM, c0 = blockIdx.y * TN;
  const int ar = tid / 4, ak = (tid % 4) * 4;    // stages dy of pixel m0 + ar, 4 channels
  const int bk = tid / 16, bc = (tid % 16) * 4;  // stages W row bk, 4 input channels
  float acc[4][4] = {};
  for (int tap = 0; tap < KS * KS; ++tap) {
    const int src = shifted(m0 + ar, KS / 2 - tap / KS, KS / 2 - tap % KS, g);
    const float* wtap = wt + (int64_t)tap * Co * Ci;
    for (int k0 = 0; k0 < Co; k0 += TK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = k0 + ak + e;
        As[ak + e][ar] = (src >= 0 && co < Co)
                             ? dy_elem(y, dout, vec, Co, (int64_t)src * Co + co, co, relu)
                             : 0.f;
        const int kr = k0 + bk, ci = c0 + bc + e;
        Bs[bk][bc + e] = (kr < Co && ci < Ci) ? wtap[(int64_t)kr * Ci + ci] : 0.f;
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
      if (ci < Ci) da[(int64_t)m * Ci + ci] = acc[i][j];
    }
  }
}

// wgrad: one CTA per (64 output channels, 64 input channels, tap, pixel
// slice); loops over the slice's pixels 16 at a time.  a of a tap is read
// at (h + kh - 1, w + kw - 1) for 3x3.  Writes the slice's f32 partial
// [tap][co][ci] at out + slice * taps * Co * Ci.
template <int KS>
__global__ void __launch_bounds__(NT)
wgrad_kernel(const float* __restrict__ y, const float* __restrict__ dout,
             const float* __restrict__ vec, const float* __restrict__ a, float* __restrict__ out,
             Geo g, int Ci, int Co, int relu, int rows_per_split) {
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
      Bs[lk][lc + e] = (src >= 0 && ci < Ci) ? a[(int64_t)src * Ci + ci] : 0.f;
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

cudaError_t sum_splits(const float* part, float* dw, int64_t size, int splits,
                       cudaStream_t stream) {
  const int blocks = (int)((size + 255) / 256 < 4096 ? (size + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(part, dw, size, splits);
  return cudaGetLastError();
}

// f32 K4 (KS = 1) and K5 (KS = 3): the CUDA-core kernels.
template <int KS>
cudaError_t launch_f32(const void* y, const void* dout, const void* a, const void* wt,
                       const void* vec, void* da, void* dw, void* scratch, Geo g, int Ci, int Co,
                       int relu, int splits, int rows_per_split, cudaStream_t stream) {
  const float* yp = static_cast<const float*>(y);
  const float* gp = static_cast<const float*>(dout);
  const float* vp = static_cast<const float*>(vec);
  const dim3 dgrid((g.M + TM - 1) / TM, (Ci + TN - 1) / TN);
  dgrad_kernel<KS><<<dgrid, NT, 0, stream>>>(yp, gp, vp, static_cast<const float*>(wt),
                                             static_cast<float*>(da), g, Ci, Co, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* part = splits > 1 ? static_cast<float*>(scratch) : static_cast<float*>(dw);
  const dim3 wgrid(((Ci + TN - 1) / TN) * ((Co + TM - 1) / TM), KS * KS, splits);
  wgrad_kernel<KS><<<wgrid, NT, 0, stream>>>(yp, gp, vp, static_cast<const float*>(a), part, g,
                                             Ci, Co, relu, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, static_cast<float*>(dw), (int64_t)KS * KS * Co * Ci, splits, stream);
}

// ---------------------------------------------------------------------------
// K5, bf16: tensor cores (wgmma, register A fragments through ldmatrix)
// ---------------------------------------------------------------------------
//
// Tiles are 64 channels wide (128-byte rows of bf16) with their 16-byte
// chunks permuted by XOR with the row index mod 8: wgmma's 128-byte
// swizzle where a tile starts 1024-byte aligned, and the 8 rows one
// ldmatrix reads sit on distinct banks.  A tap's shifted operand is a view
// of a halo tile: each lane of an ldmatrix names its own row, and a row
// whose source pixel falls outside the image (above, below, or across the
// left or right edge into the neighbouring image row) names a row of zeros.

constexpr int TC_ROW = 128;                // bytes of one tile row
constexpr int TAP_BYTES = 64 * TC_ROW;     // a 64 x 64 bf16 tile
constexpr int DW_G = 2;                    // dgrad: warpgroups per CTA
constexpr int DW_TM = 64 * DW_G;           // dgrad: pixels per CTA, 64 per warpgroup
constexpr int DG_WS = 4;                   // dgrad: slots of the ring of W tap tiles
constexpr int WG_NT = 3 * 128;            // wgrad: a warpgroup per kernel row
constexpr int WG_SC = 128;                 // wgrad: pixels per chunk
constexpr int WG_ST = 3;                   // wgrad: stages of the ring of chunks
constexpr int WG_YB = WG_SC * TC_ROW;      // wgrad: bytes of a chunk's y (or dout) tile
constexpr int BAND_ROWS = WG_SC + 2;       // wide planes: rows of one halo band
constexpr int BAND_BYTES = BAND_ROWS * TC_ROW;
constexpr size_t MAX_SMEM = 232448;        // a CTA's shared memory on sm_90

__device__ __forceinline__ uint32_t rsw(int r, int c) {
  return r * TC_ROW + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]));
}

// Orders this thread's shared-memory writes before later reads by wgmma,
// which go through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v));
}

__device__ __forceinline__ void ld_shared_v4(uint32_t (&v)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(addr));
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// dy of pixels [p0, p0 + rows) and channels [co0, co0 + 64) into a tile,
// zero for pixels outside [p_lo, p_hi) and channels past Co.  sv holds the
// chunk's (s, t, u, v) as [4][64] f32.  V: Co % 8 == 0 and 16-byte aligned
// rows, read 8 channels at a time; the loop is unrolled so that several
// items' loads are in flight at once.
template <bool V, int NTH>
__device__ __forceinline__ void fill_dy(uint32_t dst, const bf16* __restrict__ y,
                                        const bf16* __restrict__ dout, const float* sv, int Co,
                                        int co0, int p0, int rows, int p_lo, int p_hi,
                                        int relu) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * 8; i += NTH) {
    const int r = i >> 3, cc = 8 * (i & 7), p = p0 + r;
    float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (p >= p_lo && p < p_hi) {
      const int64_t off = (int64_t)p * Co + co0 + cc;
      if constexpr (V) {
        if (co0 + cc < Co) {
          const uint4 yv = __ldg(reinterpret_cast<const uint4*>(y + off));
          const uint4 gv = __ldg(reinterpret_cast<const uint4*>(dout + off));
          const uint32_t* yw = reinterpret_cast<const uint32_t*>(&yv);
          const uint32_t* gw = reinterpret_cast<const uint32_t*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 yf = bf16x2_to_float2(yw[e]), gf = bf16x2_to_float2(gw[e]);
            const int c = cc + 2 * e;
            d[2 * e] = dy_val(yf.x, gf.x, sv[c], sv[64 + c], sv[128 + c], sv[192 + c], relu);
            d[2 * e + 1] =
                dy_val(yf.y, gf.y, sv[c + 1], sv[65 + c], sv[129 + c], sv[193 + c], relu);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (co0 + cc + e < Co)
            d[e] = dy_val(__bfloat162float(y[off + e]), __bfloat162float(dout[off + e]),
                          sv[cc + e], sv[64 + cc + e], sv[128 + cc + e], sv[192 + cc + e], relu);
      }
    }
    const uint32_t w[4] = {pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]), pack_bf16(d[4], d[5]),
                           pack_bf16(d[6], d[7])};
    st_shared_v4(dst + rsw(r, i & 7), w);
  }
}

// dy in place: rows [0, rows) of tile sy hold y and of tile sg dout for
// pixels p0 + r and the chunk's 64 channels; each 16-byte chunk of sy
// becomes dy, zero for pixels outside [p_lo, p_hi).  Channels past Co hold
// y = dout = 0 and (s, t, u, v) = 0 in sv, so their dy is 0 as well.
template <int NTH>
__device__ __forceinline__ void convert_dy(uint32_t sy, uint32_t sg, const float* sv, int p0,
                                           int rows, int p_lo, int p_hi, int relu) {
  for (int i = threadIdx.x; i < rows * 8; i += NTH) {
    const int r = i >> 3, cc = 8 * (i & 7), p = p0 + r;
    const uint32_t off = rsw(r, i & 7);
    uint32_t d[4] = {0u, 0u, 0u, 0u};
    if (p >= p_lo && p < p_hi) {
      uint32_t yv[4], gv[4];
      ld_shared_v4(yv, sy + off);
      ld_shared_v4(gv, sg + off);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 yf = bf16x2_to_float2(yv[e]), gf = bf16x2_to_float2(gv[e]);
        const int c = cc + 2 * e;
        d[e] = pack_bf16(
            dy_val(yf.x, gf.x, sv[c], sv[64 + c], sv[128 + c], sv[192 + c], relu),
            dy_val(yf.y, gf.y, sv[c + 1], sv[65 + c], sv[129 + c], sv[193 + c], relu));
      }
    }
    st_shared_v4(sy + off, d);
  }
}

// Rows [0, rows) of a tile from a row-major bf16 matrix: row r is src row
// row0 + r (zero when that is outside [0, n_rows)), columns [col0, col0 +
// 64) of n_cols (zero past n_cols).  V: cp.async 16 bytes at a time (the
// caller commits); otherwise element by element, visible after the next
// barrier.
template <bool V, int NTH>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* __restrict__ src, int row0,
                                          int rows, int n_rows, int n_cols, int col0) {
  for (int i = threadIdx.x; i < rows * 8; i += NTH) {
    const int r = i >> 3, c = i & 7, row = row0 + r, col = col0 + 8 * c;
    const bool in = row >= 0 && row < n_rows;
    if constexpr (V) {
      const bool ok = in && col < n_cols;
      cp_async16(dst + rsw(r, c), ok ? src + (int64_t)row * n_cols + col : src, ok ? 16 : 0);
    } else {
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = in && col + e < n_cols
                   ? __bfloat162float(src[(int64_t)row * n_cols + col + e]) : 0.f;
      const uint32_t w[4] = {pack_bf16(d[0], d[1]), pack_bf16(d[2], d[3]),
                             pack_bf16(d[4], d[5]), pack_bf16(d[6], d[7])};
      st_shared_v4(dst + rsw(r, c), w);
    }
  }
}

// The channel chunk's (s, t, u, v) into sv [4][64], zero past Co.
template <int NTH>
__device__ __forceinline__ void load_vec(float* sv, const float* __restrict__ vec, int Co,
                                         int co0) {
  for (int i = threadIdx.x; i < 256; i += NTH) {
    const int c = co0 + (i & 63);
    sv[i] = c < Co ? vec[(i >> 6) * Co + c] : 0.f;
  }
}

// dgrad on wgmma: one CTA per (DW_TM pixels, 64 * NB input channels),
// DW_G warpgroups, warpgroup g owning 64 of the pixels and all 64 * NB
// channels in f32 accumulators.  Per 64-channel chunk of Co, dy is computed
// once for the tile and its halo into shared memory: the contiguous rows
// [m0 - W - 1, m0 + DW_TM + W + 1), or where BAND (wide planes) only the
// three bands of BAND_ROWS rows the taps touch, from m0 - W - 1, m0 - 1 and
// m0 + W - 1, so that the footprint does not grow with W.  Each tap's A
// operand is that halo shifted by the tap's offset,
// loaded into register fragments by ldmatrix (a row per lane, so an
// out-of-image row names the zero row); its B operand is the tap's W
// [64 co x 64 NB ci] tile, read MN-major by the wgmma descriptor.  The W
// tiles of the (chunk, tap) steps stream through a ring of 4 slots, copied
// two steps ahead; a step's products run while the copies of a later step
// are issued.
template <bool V, int NB, bool BAND>
__global__ void __launch_bounds__(128 * DW_G, NB == 1 ? 3 : V ? 2 : 1)
dgrad3_mma_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                  const float* __restrict__ vec, const bf16* __restrict__ wt,
                  bf16* __restrict__ da, Geo g, int Ci, int Co, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = 128 * DW_G;
  constexpr uint32_t SLOT = NB * TAP_BYTES;      // one step's W: NB blocks [co][64 ci]
  const int HR = BAND ? 3 * BAND_ROWS : DW_TM + 2 * g.W + 2;
  const uint32_t sW = aligned_smem(smem);        // the ring of W slots
  const uint32_t sZ = sW + DG_WS * SLOT;         // a row of zeros
  float* sv = reinterpret_cast<float*>(smem + (sZ + TC_ROW - smem_u32(smem)));
  const uint32_t sH = sZ + TC_ROW + 1024;        // dy of the halo [HR][co]
  const int m0 = blockIdx.x * DW_TM, c0 = blockIdx.y * 64 * NB, h0 = m0 - (g.W + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_steps = (Co + 63) / 64 * 9;
  if (tid < 8) {
    const uint32_t z[4] = {0u, 0u, 0u, 0u};
    st_shared_v4(sZ + 16 * tid, z);
  }
  auto load_w = [&](int s) {  // step s = 9 * chunk + tap
    if (s < n_steps)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        load_rows<V, NT>(sW + (s % DG_WS) * SLOT + n * TAP_BYTES,
                         wt + (int64_t)(s % 9) * Co * Ci, (s / 9) * 64, 64, Co, Ci, c0 + 64 * n);
    cp_async_commit();
  };
  load_w(0);
  load_w(1);

  // This lane's A row (ldmatrix address) in the warp's 16 pixels: tile
  // row, and the pixel's image row and column (-2H when past M, so that
  // every shift falls outside).
  const int mr = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int pq = (m0 + mr) % g.W;
  const int pr = m0 + mr < g.M ? ((m0 + mr) / g.W) % g.H : -2 * g.H;

  float acc[NB * 8][4];
#pragma unroll
  for (int j = 0; j < NB * 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // Step s = 9 * chunk + tap.  At a chunk's first tap, the halo's dy for
  // that chunk of 64 output channels.  A step waits for its W tile, loads
  // its fragments and issues its four 16-deep products, which run while the
  // copies of step s + 2 are issued; it waits for them before the next
  // step.  No product is in flight where fragments are written or across
  // the loop's back edge: ptxas serialises every wgmma otherwise (C7513,
  // C7515).
  for (int s = 0; s < n_steps; ++s) {
    const int tap = s % 9;
    if (tap == 0) {
      const int co0 = s / 9 * 64;
      __syncthreads();  // every warp has read the previous chunk's halo and vectors
      load_vec<NT>(sv, vec, Co, co0);
      __syncthreads();
      if constexpr (BAND) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          fill_dy<V, NT>(sH + b * BAND_BYTES, y, dout, sv, Co, co0, m0 + (b - 1) * g.W - 1,
                         BAND_ROWS, 0, g.M, relu);
      } else {
        fill_dy<V, NT>(sH, y, dout, sv, Co, co0, h0, HR, 0, g.M, relu);
      }
    }
    cp_async_wait_1();  // this step's W tile has landed (this thread's copies)
    __syncthreads();    // everyone's copies; at tap 0 the halo is written
    // dgrad reads dy at (h + 1 - kh, w + 1 - kw) for tap (kh, kw).
    const int dh = 1 - tap / 3, dw = 1 - tap % 3;
    const bool ok = pr + dh >= 0 && pr + dh < g.H && pq + dw >= 0 && pq + dw < g.W;
    // The row in the halo, or in band dh + 1 (whose rows are swizzled by
    // their index inside the band).
    const int hr = BAND ? mr + 1 + dw : mr + g.W + 1 + dh * g.W + dw;
    const uint32_t arow = ok ? sH + (BAND ? (dh + 1) * BAND_BYTES : 0) + hr * TC_ROW : sZ;
    const int ax = ok ? (hr & 7) : 0;
    uint32_t fa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4(fa[kk], arow + (((2 * kk + (lane >> 4)) ^ ax) << 4));
    const uint32_t sWt = sW + (s % DG_WS) * SLOT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<64 * NB>(acc, fa[kk], gmma_desc(sWt + kk * 16 * TC_ROW, TAP_BYTES, 1024));
    wg_commit();
    load_w(s + 2);  // into the slot of step s - 2, which every warpgroup is done with
    wg_wait_all();
  }
  reg_fence<NB * 8>(acc);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + 16 * warp + (lane >> 2) + 8 * hh;
    if (m >= g.M) continue;
    bf16* row = da + (int64_t)m * Ci;
#pragma unroll
    for (int j = 0; j < NB * 8; ++j) {
      const int ci = c0 + 8 * j + 2 * (lane & 3);
      const float lo = acc[j][2 * hh], hi = acc[j][2 * hh + 1];
      if constexpr (V) {
        if (ci < Ci) *reinterpret_cast<uint32_t*>(row + ci) = pack_bf16(lo, hi);
      } else {
        if (ci < Ci) row[ci] = __float2bfloat16(lo);
        if (ci + 1 < Ci) row[ci + 1] = __float2bfloat16(hi);
      }
    }
  }
}

// wgrad on wgmma: one CTA per (64 output channels, 64 input channels, pixel
// slice), three warpgroups, warpgroup kh owning the three taps of kernel
// row kh.  It computes dW^T: M = 64 input channels (16 per warp), N = 64
// output channels, K = pixels.  Per 128-pixel chunk, y and dout are copied
// into shared memory and turned into dy there (the B operand of every tap,
// read MN-major by the descriptor), and a is copied once with its halo:
// the contiguous rows [r0 - W - 1, r0 + 128 + W + 1), or where BAND (wide
// planes) the three bands of BAND_ROWS rows from r0 - W - 1, r0 - 1 and
// r0 + W - 1, one per kernel row.  Each tap's A operand is the halo shifted
// by the tap's offset, loaded transposed into register fragments by
// ldmatrix (a row per lane, so an out-of-image row names the zero row).  y
// and dout go through a ring of 3 stages, a through A_ST: chunk ch + 2's y
// and dout, and chunk ch + A_ST - 1's a, are copied, and dy of chunk ch + 1
// computed, between the products of chunk ch.  The contiguous halo keeps 3
// stages of a; the bands, 2 (3 would not fit).  Writes the slice's f32
// partial [tap][co][ci] at out + slice * 9 * Co * Ci.
template <bool V, bool BAND>
__global__ void __launch_bounds__(WG_NT, 1)
wgrad3_mma_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                  const float* __restrict__ vec, const bf16* __restrict__ a,
                  float* __restrict__ out, Geo g, int Ci, int Co, int relu,
                  int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int A_ST = BAND ? 2 : WG_ST;
  const int HA = BAND ? 3 * BAND_ROWS : WG_SC + 2 * g.W + 2;
  // Stage st: dy (from y) at sDy + st * WG_YB (1024-aligned, for the
  // descriptor), dout at sG + st * WG_YB; a stage ast: the a halo at sA +
  // ast * HA rows.
  const uint32_t sDy = aligned_smem(smem);
  const uint32_t sG = sDy + WG_ST * WG_YB;
  const uint32_t sA = sG + WG_ST * WG_YB;
  const uint32_t sZ = sA + A_ST * HA * TC_ROW;      // a row of zeros
  float* sv = reinterpret_cast<float*>(smem + (sZ + TC_ROW - smem_u32(smem)));
  const int n_ci = (Ci + 63) / 64;
  const int ci0 = (blockIdx.x % n_ci) * 64, co0 = (blockIdx.x / n_ci) * 64;
  const int mb = blockIdx.y * rows_per_split, me = min(g.M, mb + rows_per_split);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int kh = w >> 2, wq = w & 3;
  const int dh = kh - 1;  // wgrad reads a at (h + kh - 1, w + kw - 1) for tap (kh, kw)
  const int n_ch = me > mb ? (me - mb + WG_SC - 1) / WG_SC : 0;
  if (tid < 8) {
    const uint32_t z[4] = {0u, 0u, 0u, 0u};
    st_shared_v4(sZ + 16 * tid, z);
  }
  auto load_ydo = [&](int ch) {
    const int st = ch % WG_ST, r0 = mb + ch * WG_SC;
    load_rows<V, WG_NT>(sDy + st * WG_YB, y, r0, WG_SC, g.M, Co, co0);
    load_rows<V, WG_NT>(sG + st * WG_YB, dout, r0, WG_SC, g.M, Co, co0);
  };
  auto load_a = [&](int ch) {
    const uint32_t dst = sA + ch % A_ST * HA * TC_ROW;
    const int r0 = mb + ch * WG_SC;
    if constexpr (BAND) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        load_rows<V, WG_NT>(dst + b * BAND_BYTES, a, r0 + (b - 1) * g.W - 1, BAND_ROWS, g.M, Ci,
                            ci0);
    } else {
      load_rows<V, WG_NT>(dst, a, r0 - (g.W + 1), HA, g.M, Ci, ci0);
    }
  };
  load_vec<WG_NT>(sv, vec, Co, co0);
  if (n_ch > 0) {
    load_ydo(0);
    load_a(0);
  }
  cp_async_commit();
  if (n_ch > 1) {
    load_ydo(1);
    if (A_ST > 2) load_a(1);
  }
  cp_async_commit();
  cp_async_wait_1();
  __syncthreads();
  if (n_ch > 0) convert_dy<WG_NT>(sDy, sG, sv, mb, WG_SC, mb, me, relu);
  fence_async_smem();

  float acc[3][8][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[t][j][0] = acc[t][j][1] = acc[t][j][2] = acc[t][j][3] = 0.f;

  for (int ch = 0; ch < n_ch; ++ch) {
    const int r0 = mb + ch * WG_SC, st = ch % WG_ST;
    const uint32_t dyb = sDy + st * WG_YB, ab = sA + ch % A_ST * HA * TC_ROW;
    cp_async_wait_0();  // chunk ch + 1 has landed (this thread's copies)
    // Everyone's copies of chunk ch + 1 (and chunk ch's a) have landed, dy
    // of chunk ch is written, and every warpgroup is done with chunk ch - 1.
    __syncthreads();
    if (ch + 2 < n_ch) load_ydo(ch + 2);  // into the stage of chunk ch - 1
    if (ch + A_ST - 1 < n_ch) load_a(ch + A_ST - 1);
    cp_async_commit();
    const int nst = (ch + 1) % WG_ST;
    // The image row and column of this lane's A row (a pixel) in each
    // 16-deep step: one division a chunk, then steps of 16 pixels.
    const int p_0 = r0 + (lane & 7) + ((lane >> 4) & 1) * 8;
    int pq = p_0 % g.W, pr = (p_0 / g.W) % g.H;
    // Two 16-deep steps a group: their fragments are loaded with no product
    // in flight, then their six products are issued, and dy of the next
    // chunk is computed, 32 rows a group, while they run.  No product is in
    // flight where fragments are written or across the loop's back edge:
    // ptxas serialises every wgmma otherwise (C7513, C7515).
    uint32_t fa[2][3][4];
#pragma unroll
    for (int kk2 = 0; kk2 < WG_SC / 32; ++kk2) {
      if (kk2 > 0) wg_wait_all();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 2 * kk2 + h;
        if (kk > 0) {
          pq += 16;
          while (pq >= g.W) {
            pq -= g.W;
            pr = pr + 1 == g.H ? 0 : pr + 1;
          }
        }
        const int br = 16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8;
        const bool row_ok = r0 + br < g.M && pr + dh >= 0 && pr + dh < g.H;
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const int dw = t - 1;
          const bool ok = row_ok && pq + dw >= 0 && pq + dw < g.W;
          // The row in the halo, or in band kh (swizzled by its index there).
          const int hr = BAND ? br + 1 + dw : br + g.W + 1 + dh * g.W + dw;
          const uint32_t base = ok ? ab + (BAND ? kh * BAND_BYTES : 0) + hr * TC_ROW : sZ;
          const int x = ok ? (hr & 7) : 0;
          ldsm_x4_t(fa[h][t], base + (((2 * wq + ((lane >> 3) & 1)) ^ x) << 4));
        }
      }
      wg_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < 3; ++t)
          wgmma_rs_n64(acc[t], fa[h][t],
                       gmma_desc(dyb + (2 * kk2 + h) * 16 * TC_ROW, WG_YB, 1024));
      wg_commit();
      if (ch + 1 < n_ch)
        convert_dy<WG_NT>(sDy + nst * WG_YB + kk2 * 32 * TC_ROW,
                          sG + nst * WG_YB + kk2 * 32 * TC_ROW, sv, r0 + WG_SC + 32 * kk2, 32,
                          mb, me, relu);
    }
    wg_wait_all();
    fence_async_smem();  // dy of the next chunk, for the descriptor reads
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) reg_fence<8>(acc[t]);

#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float* o = out + ((int64_t)blockIdx.y * 9 + kh * 3 + t) * Co * Ci;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ci = ci0 + 16 * wq + (lane >> 2) + 8 * hh;
      if (ci >= Ci) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + 8 * j + 2 * (lane & 3);
        if (co < Co) o[(int64_t)co * Ci + ci] = acc[t][j][2 * hh];
        if (co + 1 < Co) o[(int64_t)(co + 1) * Ci + ci] = acc[t][j][2 * hh + 1];
      }
    }
  }
}

// Shared memory of the bf16 3x3 kernels: 1024 bytes to align the tiles,
// the tiles, a zero row and 1024 bytes of (s, t, u, v).
size_t dgrad3_smem(const Geo& g, int nb, bool band) {
  const size_t halo = band ? 3 * BAND_ROWS : DW_TM + 2 * g.W + 2;
  return 1024 + DG_WS * nb * TAP_BYTES + TC_ROW + 1024 + halo * TC_ROW;
}

size_t wgrad3_smem(const Geo& g, bool band) {
  const size_t a_stages = band ? 2 : WG_ST, halo = band ? 3 * BAND_ROWS : WG_SC + 2 * g.W + 2;
  return 1024 + WG_ST * 2 * WG_YB + a_stages * halo * TC_ROW + TC_ROW + 1024;
}

// The bands where wgrad's ring of three contiguous halos would not fit
// (W > 106): no plane in ResNet-50 at 224 x 224, whose widest is 56.  The
// contiguous halo stays where it fits: on an H100 the banded kernels are
// 1.23-1.40x slower at ResNet-50's four planes (more dy rows formed, two
// stages of a), tools/k5_halo_layouts.py.
bool k5_banded(const Geo& g) { return wgrad3_smem(g, false) > MAX_SMEM; }

template <bool V, int NB, bool BAND>
cudaError_t launch_dgrad3(const bf16* y, const bf16* dout, const float* vec, const bf16* wt,
                          bf16* da, Geo g, int Ci, int Co, int relu, cudaStream_t stream) {
  const size_t dsm = dgrad3_smem(g, NB, BAND);
  cudaError_t err = opt_in_smem(dgrad3_mma_kernel<V, NB, BAND>, dsm);
  if (err != cudaSuccess) return err;
  const dim3 dgrid((g.M + DW_TM - 1) / DW_TM, (Ci + 64 * NB - 1) / (64 * NB));
  dgrad3_mma_kernel<V, NB, BAND><<<dgrid, 128 * DW_G, dsm, stream>>>(y, dout, vec, wt, da, g,
                                                                   Ci, Co, relu);
  return cudaGetLastError();
}

template <bool V, bool BAND>
cudaError_t launch_bf16_3x3_mma(const bf16* y, const bf16* dout, const bf16* a, const bf16* wt,
                                const float* vec, bf16* da, float* dw, float* scratch, Geo g,
                                int Ci, int Co, int relu, int splits, int rows_per_split,
                                cudaStream_t stream) {
  // 128 input channels a CTA where there are more than 64: dy is then
  // recomputed, and W read, half as often per product.
  cudaError_t err =
      Ci > 64 ? launch_dgrad3<V, 2, BAND>(y, dout, vec, wt, da, g, Ci, Co, relu, stream)
              : launch_dgrad3<V, 1, BAND>(y, dout, vec, wt, da, g, Ci, Co, relu, stream);
  if (err != cudaSuccess) return err;
  const size_t wsm = wgrad3_smem(g, BAND);
  err = opt_in_smem(wgrad3_mma_kernel<V, BAND>, wsm);
  if (err != cudaSuccess) return err;
  float* part = splits > 1 ? scratch : dw;
  const dim3 wgrid(((Ci + 63) / 64) * ((Co + 63) / 64), splits);
  wgrad3_mma_kernel<V, BAND><<<wgrid, WG_NT, wsm, stream>>>(y, dout, vec, a, part, g, Ci, Co,
                                                           relu, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, dw, (int64_t)9 * Co * Ci, splits, stream);
}

// ---------------------------------------------------------------------------
// K4, bf16: tensor cores (wgmma, both operands by descriptor)
// ---------------------------------------------------------------------------
//
// A 1x1 conv has no halo, so every operand is a plain tile and both operands
// of both products are read by wgmma descriptors from 128-byte-swizzled
// tiles in 64-channel blocks, filled by 16-byte cp.async.  Two kernels, each
// reading y and dout once (dy is recomputed in shared memory, never
// written): dgrad (da = dy . W) and wgrad (dW^T = a^T . dy over pixel
// slices, then the deterministic split sum).  Where a product has several
// channel tiles, the CTAs that share pixels are adjacent in launch order, so
// that all but the first read of y, dout or a come from L2.

constexpr int K4_NT = 256;    // two warpgroups a CTA
constexpr int K4_DM = 128;    // dgrad: pixels a tile, 64 per warpgroup
constexpr int K4_DST = 3;     // dgrad: stages of the ring of items
constexpr int K4_WP = 64;     // wgrad: pixels a chunk
constexpr int K4_WCI = 128;   // wgrad: input channels a CTA, 64 per warpgroup

// The N width of a product: 64, 128 or 256 channels, the fewest 64-channel
// blocks that cover c, at most 4 (128 accumulators a thread).
int k4_width(int c) { return c <= 64 ? 64 : c <= 128 ? 128 : 256; }

// dgrad stage: y and dout [128 px][64 co], W [64 co][TN ci].
template <int TN>
__host__ __device__ constexpr uint32_t k4_dgrad_stage() {
  return 2 * K4_DM * TC_ROW + TN / 64 * TAP_BYTES;
}
// wgrad stage: a [64 px][128 ci], y and dout [64 px][TN co]; 2 stages at
// TN = 256 (80 KB each), 3 below.
template <int TN>
__host__ __device__ constexpr uint32_t k4_wgrad_stage() {
  return (2 + 2 * (TN / 64)) * K4_WP * TC_ROW;
}
template <int TN>
__host__ __device__ constexpr int k4_wgrad_stages() { return TN == 256 ? 2 : 3; }

// dy in place, as convert_dy, for the 1x1 kernels, where forming dy costs
// more than the products: a thread keeps one 8-channel group's (s, t, u,
// v) in registers (sv is 16-byte aligned, [4][64] f32) and converts its
// ROWS / (NTH / 8) rows, unrolled, so that their loads are in flight
// together.
template <int NTH, int ROWS>
__device__ __forceinline__ void convert_dy_rows(uint32_t sy, uint32_t sg, const float* sv,
                                                int p0, int p_lo, int p_hi, int relu) {
  static_assert(NTH % 8 == 0 && ROWS % (NTH / 8) == 0, "every thread converts as many rows");
  const int c = threadIdx.x & 7;
  float s[8], t[8], u[8], v[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 s4 = reinterpret_cast<const float4*>(sv)[2 * c + h];
    const float4 t4 = reinterpret_cast<const float4*>(sv + 64)[2 * c + h];
    const float4 u4 = reinterpret_cast<const float4*>(sv + 128)[2 * c + h];
    const float4 v4 = reinterpret_cast<const float4*>(sv + 192)[2 * c + h];
    s[4 * h] = s4.x, s[4 * h + 1] = s4.y, s[4 * h + 2] = s4.z, s[4 * h + 3] = s4.w;
    t[4 * h] = t4.x, t[4 * h + 1] = t4.y, t[4 * h + 2] = t4.z, t[4 * h + 3] = t4.w;
    u[4 * h] = u4.x, u[4 * h + 1] = u4.y, u[4 * h + 2] = u4.z, u[4 * h + 3] = u4.w;
    v[4 * h] = v4.x, v[4 * h + 1] = v4.y, v[4 * h + 2] = v4.z, v[4 * h + 3] = v4.w;
  }
#pragma unroll
  for (int k = 0; k < ROWS / (NTH / 8); ++k) {
    const int r = (threadIdx.x >> 3) + k * (NTH / 8), p = p0 + r;
    const uint32_t off = rsw(r, c);
    uint32_t d[4] = {0u, 0u, 0u, 0u};
    if (p >= p_lo && p < p_hi) {
      uint32_t yv[4], gv[4];
      ld_shared_v4(yv, sy + off);
      ld_shared_v4(gv, sg + off);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 yf = bf16x2_to_float2(yv[e]), gf = bf16x2_to_float2(gv[e]);
        d[e] = pack_bf16(dy_val(yf.x, gf.x, s[2 * e], t[2 * e], u[2 * e], v[2 * e], relu),
                         dy_val(yf.y, gf.y, s[2 * e + 1], t[2 * e + 1], u[2 * e + 1],
                                v[2 * e + 1], relu));
      }
    }
    st_shared_v4(sy + off, d);
  }
}

// dgrad on wgmma: persistent CTAs of two warpgroups walk over tiles of (128
// pixels, TN input channels), tile t = blockIdx.x + j * gridDim.x, with the
// channel tiles of one pixel tile adjacent.  A tile sums over 64-channel
// chunks of Co; a CTA's (tile, chunk) items stream through a ring of
// K4_DST stages, each holding the item's y and dout [128 px][64 co], W [64
// co][TN ci] and (s, t, u, v), copied two items ahead across tile
// boundaries, so that the next tile's copies run under this tile's products
// and stores.  Per item, y becomes dy in place (zero past M), the A operand
// (K-major); W is the B operand (MN-major); warpgroup g owns pixels [64 g,
// 64 g + 64) of the tile.  The products run with no other work in flight:
// the kernel is bound by its copies, which stay two items ahead.
template <bool V, int TN>
__global__ void __launch_bounds__(K4_NT, 1)
dgrad1_mma_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                  const float* __restrict__ vec, const bf16* __restrict__ wt,
                  bf16* __restrict__ da, int M, int Ci, int Co, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = TN / 64;
  constexpr uint32_t YB = K4_DM * TC_ROW;  // y or dout of an item
  constexpr uint32_t STAGE = k4_dgrad_stage<TN>();
  const uint32_t s0 = aligned_smem(smem);
  // (s, t, u, v) of stage st at sv0 + 256 * st, [4][64] f32.
  float* sv0 = reinterpret_cast<float*>(smem + (s0 + K4_DST * STAGE - smem_u32(smem)));
  const int n_n = (Ci + TN - 1) / TN, n_k = (Co + 63) / 64;
  const int n_tiles = (M + K4_DM - 1) / K4_DM * n_n;
  const int n_items =
      ((int)blockIdx.x < n_tiles ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0) *
      n_k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;

  auto load_item = [&](int i) {
    if (i < n_items) {
      const int t = blockIdx.x + i / n_k * gridDim.x, k = i % n_k;
      const int m0 = t / n_n * K4_DM, c0 = t % n_n * TN;
      const uint32_t st = s0 + i % K4_DST * STAGE;
      load_rows<V, K4_NT>(st, y, m0, K4_DM, M, Co, 64 * k);
      load_rows<V, K4_NT>(st + YB, dout, m0, K4_DM, M, Co, 64 * k);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        load_rows<V, K4_NT>(st + 2 * YB + b * TAP_BYTES, wt, 64 * k, 64, Co, Ci, c0 + 64 * b);
      const int c = 64 * k + (tid & 63);  // one of the 256 vector entries a thread
      cp_async4(smem_u32(sv0 + i % K4_DST * 256 + tid), c < Co ? vec + (tid >> 6) * Co + c : vec,
                c < Co ? 4 : 0);
    }
    cp_async_commit();
  };
  load_item(0);
  load_item(1);

  float acc[TN / 8][4];
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n_items; ++i) {
    const int t = blockIdx.x + i / n_k * gridDim.x, k = i % n_k;
    const int m0 = t / n_n * K4_DM, c0 = t % n_n * TN;
    const uint32_t st = s0 + i % K4_DST * STAGE;
    cp_async_wait_1();  // item i has landed (this thread's copies)
    __syncthreads();    // everyone's; every warpgroup is done with item i - 1
    load_item(i + 2);   // into the stage of item i - 1
    convert_dy_rows<K4_NT, K4_DM>(st, st + YB, sv0 + i % K4_DST * 256, m0, 0, M, relu);
    fence_async_smem();  // dy, and the element-wise copies, for the descriptor reads
    __syncthreads();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tr<TN, 0, 1>(acc, gmma_desc(st + wg * 64 * TC_ROW + kk * 32, 16, 1024),
                            gmma_desc(st + 2 * YB + kk * 16 * TC_ROW, TAP_BYTES, 1024),
                            k > 0 || kk > 0);
    wg_commit();
    wg_wait_all();
    if (k == n_k - 1) {
      // The tile's da, rounded to bf16, through this item's stage (which
      // it fits: TN / 8 16-byte chunks a row, chunk j of row r at j ^ (r
      // mod 8)), so that each row leaves in 16-byte stores, a warp writing
      // whole rows.
      reg_fence<TN / 8>(acc);
      __syncthreads();  // both warpgroups' products have read the stage
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + (lane >> 2) + 8 * hh;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
          st_shared_u32(st + r * (TN * 2) + ((j ^ (r & 7)) << 4) + 4 * (lane & 3),
                        pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]));
      }
      __syncthreads();
#pragma unroll
      for (int it = 0; it < K4_DM * TN / 8 / K4_NT; ++it) {
        const int q = tid + it * K4_NT, r = q / (TN / 8), j = q % (TN / 8);
        const int m = m0 + r, ci = c0 + 8 * j;
        uint32_t v[4];
        ld_shared_v4(v, st + r * (TN * 2) + ((j ^ (r & 7)) << 4));
        if (m >= M) continue;
        bf16* dst = da + (int64_t)m * Ci + ci;
        if constexpr (V) {
          if (ci < Ci) *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        } else {
          const bf16* e = reinterpret_cast<const bf16*>(v);
          for (int x = 0; x < 8 && ci + x < Ci; ++x) dst[x] = e[x];
        }
      }
    }
  }
}

// wgrad on wgmma: one CTA per (128 input channels, TN output channels, pixel
// slice), two warpgroups, warpgroup g owning input channels [64 g, 64 g +
// 64).  It computes dW^T over the slice's 64-pixel chunks: A = a^T, read
// MN-major from the chunk's a tile [64 px][128 ci]; B = dy, read MN-major
// from the chunk's dy tile [64 px][TN co].  Chunks stream through a ring of
// k4_wgrad_stages<TN>() stages, copied one or two chunks ahead; per chunk, y
// becomes dy in place (zero past the slice), then the four 16-deep products
// run.  Writes the slice's f32 partial [co][ci] at out + slice * Co * Ci.
template <bool V, int TN>
__global__ void __launch_bounds__(K4_NT, 1)
wgrad1_mma_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                  const float* __restrict__ vec, const bf16* __restrict__ a,
                  float* __restrict__ out, int M, int Ci, int Co, int relu,
                  int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = TN / 64, ST = k4_wgrad_stages<TN>();
  constexpr uint32_t BLK = K4_WP * TC_ROW;  // one 64-channel block of a chunk
  constexpr uint32_t STAGE = k4_wgrad_stage<TN>();
  const uint32_t s0 = aligned_smem(smem);  // stage st: a [2 blocks], y [NB], dout [NB]
  float* sv = reinterpret_cast<float*>(smem + (s0 + ST * STAGE - smem_u32(smem)));  // [NB][4][64]
  const int n_ci = (Ci + K4_WCI - 1) / K4_WCI;
  const int ci0 = blockIdx.x % n_ci * K4_WCI, co0 = blockIdx.x / n_ci * TN;
  const int mb = blockIdx.y * rows_per_split, me = min(M, mb + rows_per_split);
  const int n_ch = me > mb ? (me - mb + K4_WP - 1) / K4_WP : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  for (int i = tid; i < NB * 256; i += K4_NT) {
    const int c = co0 + 64 * (i >> 8) + (i & 63);
    sv[i] = c < Co ? vec[((i >> 6) & 3) * Co + c] : 0.f;
  }
  auto load_chunk = [&](int ch) {
    if (ch < n_ch) {
      const uint32_t st = s0 + ch % ST * STAGE;
      const int r0 = mb + ch * K4_WP;
      load_rows<V, K4_NT>(st, a, r0, K4_WP, M, Ci, ci0);
      load_rows<V, K4_NT>(st + BLK, a, r0, K4_WP, M, Ci, ci0 + 64);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        load_rows<V, K4_NT>(st + (2 + b) * BLK, y, r0, K4_WP, M, Co, co0 + 64 * b);
        load_rows<V, K4_NT>(st + (2 + NB + b) * BLK, dout, r0, K4_WP, M, Co, co0 + 64 * b);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < ST - 1; ++ch) load_chunk(ch);

  float acc[TN / 8][4];
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int ch = 0; ch < n_ch; ++ch) {
    const uint32_t st = s0 + ch % ST * STAGE;
    if constexpr (ST == 2) cp_async_wait_0(); else cp_async_wait_1();  // chunk ch landed
    __syncthreads();  // everyone's copies; every warpgroup is done with chunk ch - 1
    load_chunk(ch + ST - 1);  // into the stage of chunk ch - 1
#pragma unroll
    for (int b = 0; b < NB; ++b)
      convert_dy_rows<K4_NT, K4_WP>(st + (2 + b) * BLK, st + (2 + NB + b) * BLK, sv + 256 * b,
                                    mb + ch * K4_WP, mb, me, relu);
    fence_async_smem();
    __syncthreads();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tr<TN, 1, 1>(acc, gmma_desc(st + wg * BLK + kk * 16 * TC_ROW, BLK, 1024),
                            gmma_desc(st + 2 * BLK + kk * 16 * TC_ROW, BLK, 1024), 1);
    wg_commit();
    wg_wait_all();
  }
  reg_fence<TN / 8>(acc);

  float* o = out + (int64_t)blockIdx.y * Co * Ci;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ci = ci0 + 16 * warp + (lane >> 2) + 8 * hh;
    if (ci >= Ci) continue;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * (lane & 3);
      if (co < Co) o[(int64_t)co * Ci + ci] = acc[j][2 * hh];
      if (co + 1 < Co) o[(int64_t)(co + 1) * Ci + ci] = acc[j][2 * hh + 1];
    }
  }
}

template <bool V, int TN>
cudaError_t launch_dgrad1(const bf16* y, const bf16* dout, const float* vec, const bf16* wt,
                          bf16* da, int M, int Ci, int Co, int relu, cudaStream_t stream) {
  const size_t dsm = 1024 + K4_DST * (k4_dgrad_stage<TN>() + 1024);
  cudaError_t err = opt_in_smem(dgrad1_mma_kernel<V, TN>, dsm);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dgrad1_mma_kernel<V, TN>,
                                                           K4_NT, dsm)) != cudaSuccess)
    return err;
  if (per_sm < 1) per_sm = 1;
  const int64_t tiles = (int64_t)((M + K4_DM - 1) / K4_DM) * ((Ci + TN - 1) / TN);
  const int grid = (int)(tiles < (int64_t)sms * per_sm ? tiles : (int64_t)sms * per_sm);
  dgrad1_mma_kernel<V, TN><<<grid, K4_NT, dsm, stream>>>(y, dout, vec, wt, da, M, Ci, Co, relu);
  return cudaGetLastError();
}

template <bool V, int TN>
cudaError_t launch_wgrad1(const bf16* y, const bf16* dout, const float* vec, const bf16* a,
                          float* part, int M, int Ci, int Co, int relu, int splits,
                          int rows_per_split, cudaStream_t stream) {
  const size_t wsm = 1024 + k4_wgrad_stages<TN>() * k4_wgrad_stage<TN>() + TN / 64 * 1024;
  cudaError_t err = opt_in_smem(wgrad1_mma_kernel<V, TN>, wsm);
  if (err != cudaSuccess) return err;
  const dim3 wgrid(((Ci + K4_WCI - 1) / K4_WCI) * ((Co + TN - 1) / TN), splits);
  wgrad1_mma_kernel<V, TN><<<wgrid, K4_NT, wsm, stream>>>(y, dout, vec, a, part, M, Ci, Co,
                                                         relu, rows_per_split);
  return cudaGetLastError();
}

template <bool V>
cudaError_t launch_bf16_1x1_mma(const bf16* y, const bf16* dout, const bf16* a, const bf16* wt,
                                const float* vec, bf16* da, float* dw, float* scratch, int M,
                                int Ci, int Co, int relu, int splits, int rows_per_split,
                                cudaStream_t stream) {
  const int dn = k4_width(Ci), wn = k4_width(Co);
  cudaError_t err =
      dn == 64    ? launch_dgrad1<V, 64>(y, dout, vec, wt, da, M, Ci, Co, relu, stream)
      : dn == 128 ? launch_dgrad1<V, 128>(y, dout, vec, wt, da, M, Ci, Co, relu, stream)
                  : launch_dgrad1<V, 256>(y, dout, vec, wt, da, M, Ci, Co, relu, stream);
  if (err != cudaSuccess) return err;
  float* part = splits > 1 ? scratch : dw;
  err = wn == 64    ? launch_wgrad1<V, 64>(y, dout, vec, a, part, M, Ci, Co, relu, splits,
                                           rows_per_split, stream)
        : wn == 128 ? launch_wgrad1<V, 128>(y, dout, vec, a, part, M, Ci, Co, relu, splits,
                                            rows_per_split, stream)
                    : launch_wgrad1<V, 256>(y, dout, vec, a, part, M, Ci, Co, relu, splits,
                                            rows_per_split, stream);
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(part, dw, (int64_t)Co * Ci, splits, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// bf16 K4 and K5: the tensor-core kernels, 16 bytes at a time where every
// channel count is a multiple of 8 and every pointer 16-byte aligned,
// element by element otherwise.  K5 takes planes of any width: halo bands
// above 106 pixels.
cudaError_t launch_bf16(const void* y, const void* dout, const void* a, const void* wt,
                        const void* vec, void* da, void* dw, void* scratch, Geo g, int Ci,
                        int Co, int ks, int relu, int splits, int rows_per_split,
                        cudaStream_t stream) {
  const bool v = Ci % 8 == 0 && Co % 8 == 0 && aligned16(y) && aligned16(dout) &&
                 aligned16(a) && aligned16(wt) && aligned16(da) && aligned16(dw) &&
                 aligned16(scratch);
  const bf16 *yp = static_cast<const bf16*>(y), *gp = static_cast<const bf16*>(dout),
             *ap = static_cast<const bf16*>(a), *wp = static_cast<const bf16*>(wt);
  const float* vp = static_cast<const float*>(vec);
  bf16* dap = static_cast<bf16*>(da);
  float *dwp = static_cast<float*>(dw), *sp = static_cast<float*>(scratch);
  if (ks == 1) {
    auto run = v ? launch_bf16_1x1_mma<true> : launch_bf16_1x1_mma<false>;
    return run(yp, gp, ap, wp, vp, dap, dwp, sp, g.M, Ci, Co, relu, splits, rows_per_split,
               stream);
  }
  const bool band = k5_banded(g);
  auto run = v ? (band ? launch_bf16_3x3_mma<true, true> : launch_bf16_3x3_mma<true, false>)
               : (band ? launch_bf16_3x3_mma<false, true> : launch_bf16_3x3_mma<false, false>);
  return run(yp, gp, ap, wp, vp, dap, dwp, sp, g, Ci, Co, relu, splits, rows_per_split, stream);
}

}  // namespace

// The wgrad grid that (Ci, Co, ks, dtype) selects: returns its CTAs per
// pixel slice and writes the pixel chunk (a slice's rows must be a multiple
// of it) to *chunk.  The wrapper sizes its pixel split, and the split
// scratch, from these, so the tiles are decided here alone.
extern "C" int ptd_fused_conv_bn_wgrad_tiles(int Ci, int Co, int ks, int dtype, int* chunk) {
  if (dtype == 0) {
    *chunk = TK;
    return ((Ci + TN - 1) / TN) * ((Co + TM - 1) / TM) * ks * ks;
  }
  if (ks == 3) {
    *chunk = WG_SC;
    return ((Ci + 63) / 64) * ((Co + 63) / 64);
  }
  const int tn = k4_width(Co);
  *chunk = K4_WP;
  return ((Ci + K4_WCI - 1) / K4_WCI) * ((Co + tn - 1) / tn);
}

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
    return launch_f32<1>(y, dout, a, wt, vec, da, dw, scratch, g, Ci, Co, relu, splits, rows_per_split, s);
  if (dtype == 0 && ks == 3)
    return launch_f32<3>(y, dout, a, wt, vec, da, dw, scratch, g, Ci, Co, relu, splits, rows_per_split, s);
  if (dtype == 1 && (ks == 1 || ks == 3))
    return launch_bf16(y, dout, a, wt, vec, da, dw, scratch, g, Ci, Co, ks, relu, splits, rows_per_split, s);
  return cudaErrorInvalidValue;
}
