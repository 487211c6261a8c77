// Native host-side data plane of the PyTorch port: a copy of
// pytorch_distributed_tpu/data/native/ptd_data.cpp (the batch normalize and
// the batch JPEG decode + crop + resize keep its entry points, ABI and
// semantics, bit for bit) plus what the port needs because it does not use
// PIL: a whole-image JPEG decode that decodes as PIL does, a WebP decode,
// PIL's antialiased bilinear resample (Image.resize(..., BILINEAR)) and
// PNG's row unfiltering.  libjpeg and libwebp are compiled against the
// jpeg62 and libwebp.so.7 headers vendored under include/ and linked to
// whichever copy of those libraries the host has (binding.py).
//
// The JAX package's notes on the batch functions: the reference's
// input-pipeline native layer is CUDA streams + GPU-side normalize inside
// apex's data_prefetcher (reference apex_distributed.py:115-169); the
// byte-level per-sample work (uint8 -> float normalize, horizontal flip,
// NHWC batch assembly) is the host hot loop, done here in C++ with the GIL
// released, multithreaded, writing straight into the caller's buffer.
//
// Exposed via ctypes; see binding.py, which builds this file with g++ at
// first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Normalize + optional horizontal flip for one contiguous uint8 NHWC batch.
//   in:    [n, h, w, 3] uint8
//   out:   [n, h, w, 3] float32, out = (in/255 - mean[c]) / std[c]
//   flip:  [n] uint8, nonzero => mirror horizontally
// n_threads <= 0 picks hardware_concurrency.
void ptd_normalize_batch(const uint8_t* in, float* out, int64_t n, int64_t h,
                         int64_t w, const float* mean, const float* stddev,
                         const uint8_t* flip, int n_threads) {
  // Precompute the 256-entry lookup table per channel: (v/255 - mean)/std.
  float lut[3][256];
  for (int c = 0; c < 3; ++c) {
    const float inv = 1.0f / stddev[c];
    for (int v = 0; v < 256; ++v) {
      lut[c][v] = (static_cast<float>(v) * (1.0f / 255.0f) - mean[c]) * inv;
    }
  }
  const int64_t row = w * 3;
  const int64_t img = h * row;

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* src = in + i * img;
      float* dst = out + i * img;
      const bool f = flip != nullptr && flip[i] != 0;
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* srow = src + y * row;
        float* drow = dst + y * row;
        if (!f) {
          for (int64_t x = 0; x < row; x += 3) {
            drow[x] = lut[0][srow[x]];
            drow[x + 1] = lut[1][srow[x + 1]];
            drow[x + 2] = lut[2][srow[x + 2]];
          }
        } else {
          for (int64_t x = 0; x < w; ++x) {
            const uint8_t* sp = srow + (w - 1 - x) * 3;
            float* dp = drow + x * 3;
            dp[0] = lut[0][sp[0]];
            dp[1] = lut[1][sp[1]];
            dp[2] = lut[2][sp[2]];
          }
        }
      }
    }
  };

  int threads = n_threads > 0
                    ? n_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  if (threads <= 1 || n <= 1) {
    work(0, n);
    return;
  }
  if (threads > n) threads = static_cast<int>(n);
  std::vector<std::thread> pool;
  const int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG decode + crop + bilinear resize (the expensive half of the input
// pipeline the round-1 build left in Python/PIL).  libjpeg(-turbo) with DCT
// scaling: when the crop region is still larger than the output, decoding at
// 1/2, 1/4 or 1/8 DCT scale skips most of the IDCT work before the bilinear
// pass — the standard fast-loader trick.
// ---------------------------------------------------------------------------

#ifndef PTD_NO_JPEG

#include <csetjmp>
#include <cmath>
#include <cstdio>
#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Bilinear sample of src (sh x sw x 3, u8) region [y0,y0+ch) x [x0,x0+cw)
// into dst (oh x ow x 3).
void bilinear_crop_resize(const uint8_t* src, int sw, int sh, float x0,
                          float y0, float cw, float ch, uint8_t* dst, int ow,
                          int oh) {
  const float sx = cw / ow;
  const float sy = ch / oh;
  for (int oy = 0; oy < oh; ++oy) {
    float fy = y0 + (oy + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = static_cast<float>(sh - 1);
    const int y_lo = static_cast<int>(fy);
    const int y_hi = y_lo + 1 < sh ? y_lo + 1 : sh - 1;
    const float wy = fy - y_lo;
    const uint8_t* r0 = src + static_cast<int64_t>(y_lo) * sw * 3;
    const uint8_t* r1 = src + static_cast<int64_t>(y_hi) * sw * 3;
    uint8_t* drow = dst + static_cast<int64_t>(oy) * ow * 3;
    for (int ox = 0; ox < ow; ++ox) {
      float fx = x0 + (ox + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = static_cast<float>(sw - 1);
      const int x_lo = static_cast<int>(fx);
      const int x_hi = x_lo + 1 < sw ? x_lo + 1 : sw - 1;
      const float wx = fx - x_lo;
      const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const float w10 = wy * (1 - wx), w11 = wy * wx;
      for (int c = 0; c < 3; ++c) {
        const float v = w00 * r0[x_lo * 3 + c] + w01 * r0[x_hi * 3 + c] +
                        w10 * r1[x_lo * 3 + c] + w11 * r1[x_hi * 3 + c];
        drow[ox * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Decode one JPEG; returns 0 on success.  Output crop+resize semantics:
//   params != null (train): single-attempt RandomResizedCrop — params =
//     (area_frac, log_ratio, u, v); crop size from the ORIGINAL dims, then
//     clamped; position from (u, v).
//   params == null (eval): resize shorter side to `resize_short`, center
//     crop (out_w, out_h).
int decode_one(const uint8_t* blob, int64_t len, const float* params,
               int out_w, int out_h, int resize_short, uint8_t* out,
               std::vector<uint8_t>& scratch) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  const int W = static_cast<int>(cinfo.image_width);
  const int H = static_cast<int>(cinfo.image_height);

  // Crop box in original coordinates.
  float cw, ch, cx0, cy0;
  if (params != nullptr) {
    const float area_frac = params[0];
    const float ratio = std::exp(params[1]);
    const float target_area = area_frac * W * H;
    cw = std::sqrt(target_area * ratio);
    ch = std::sqrt(target_area / ratio);
    if (cw > W) cw = static_cast<float>(W);
    if (ch > H) ch = static_cast<float>(H);
    if (cw < 1) cw = 1;
    if (ch < 1) ch = 1;
    cx0 = params[2] * (W - cw);
    cy0 = params[3] * (H - ch);
  } else {
    // eval: emulate Resize(short)+CenterCrop(out) as one crop+resize: the
    // crop is the centered region that maps onto out under short-side scale.
    const float scale = static_cast<float>(resize_short) /
                        (W < H ? W : H);
    cw = out_w / scale;
    ch = out_h / scale;
    if (cw > W) cw = static_cast<float>(W);
    if (ch > H) ch = static_cast<float>(H);
    cx0 = (W - cw) * 0.5f;
    cy0 = (H - ch) * 0.5f;
  }

  // DCT scale: decode at 1/k while the scaled crop still covers the output.
  int denom = 1;
  while (denom < 8 && cw / (denom * 2) >= out_w && ch / (denom * 2) >= out_h)
    denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = static_cast<unsigned>(denom);
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_IFAST;
  jpeg_start_decompress(&cinfo);
  const int sw = static_cast<int>(cinfo.output_width);
  const int sh = static_cast<int>(cinfo.output_height);
  scratch.resize(static_cast<size_t>(sw) * sh * 3);
  JSAMPROW rows[1];
  while (cinfo.output_scanline < cinfo.output_height) {
    rows[0] = scratch.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Map the crop box into the scaled image's coordinates.
  const float fx = static_cast<float>(sw) / W;
  const float fy = static_cast<float>(sh) / H;
  bilinear_crop_resize(scratch.data(), sw, sh, cx0 * fx, cy0 * fy, cw * fx,
                       ch * fy, out, out_w, out_h);
  return 0;
}

}  // namespace

extern "C" {

// Batch JPEG decode+crop+resize into a caller-provided [n, out_h, out_w, 3]
// uint8 buffer.  blobs = concatenated JPEG bytes, offsets = n+1 boundaries.
// params: [n, 4] train crop draws, or null for eval semantics.
// failed: optional [n] u8 flags, set to 1 for slots that failed to decode
// (those slots are zeroed).  Returns the failure count.
int ptd_decode_crop_resize_batch(const uint8_t* blobs, const int64_t* offsets,
                                 int64_t n, const float* params, int out_h,
                                 int out_w, int resize_short, uint8_t* out,
                                 uint8_t* failed, int n_threads) {
  const int64_t img_bytes = static_cast<int64_t>(out_h) * out_w * 3;
  std::vector<int> failures_per_thread;
  auto work = [&](int64_t lo, int64_t hi, int* failures) {
    std::vector<uint8_t> scratch;
    for (int64_t i = lo; i < hi; ++i) {
      uint8_t* dst = out + i * img_bytes;
      const float* p = params != nullptr ? params + i * 4 : nullptr;
      const int64_t len = offsets[i + 1] - offsets[i];
      const bool ok =
          len > 0 && decode_one(blobs + offsets[i], len, p, out_w, out_h,
                                resize_short, dst, scratch) == 0;
      if (failed != nullptr) failed[i] = ok ? 0 : 1;
      if (!ok) {
        std::memset(dst, 0, static_cast<size_t>(img_bytes));
        ++*failures;
      }
    }
  };
  int threads = n_threads > 0
                    ? n_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  if (threads > n) threads = static_cast<int>(n);
  if (threads <= 1) {
    int failures = 0;
    work(0, n, &failures);
    return failures;
  }
  failures_per_thread.assign(threads, 0);
  std::vector<std::thread> pool;
  const int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(work, lo, hi, &failures_per_thread[t]);
  }
  for (auto& th : pool) th.join();
  int failures = 0;
  for (int f : failures_per_thread) failures += f;
  return failures;
}

}  // extern "C"

namespace {

// PIL's CMYK -> RGB (libImaging/Convert.c cmyk2rgb), MULDIV255 rounding.
inline uint8_t cmyk_channel(int v, int nk) {
  const int tmp = v * nk + 128;
  const int r = nk - (((tmp >> 8) + tmp) >> 8);
  return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

// Read the header of one JPEG; 0 on success.
int read_header(jpeg_decompress_struct* cinfo, const uint8_t* blob,
                int64_t len) {
  jpeg_create_decompress(cinfo);
  jpeg_mem_src(cinfo, const_cast<uint8_t*>(blob),
               static_cast<unsigned long>(len));
  return jpeg_read_header(cinfo, TRUE) == JPEG_HEADER_OK ? 0 : 1;
}

}  // namespace

extern "C" {

// Width, height and component count of one JPEG into info[0..2]; returns 0
// on success, 1 if the header does not parse.
int ptd_jpeg_header(const uint8_t* blob, int64_t len, int32_t* info) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  const int rc = read_header(&cinfo, blob, len);
  info[0] = static_cast<int32_t>(cinfo.image_width);
  info[1] = static_cast<int32_t>(cinfo.image_height);
  info[2] = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return rc;
}

// Decode one whole JPEG into out [h, w, 3] uint8 RGB the way PIL's
// Image.open(...).convert("RGB") does: scale 1, JDCT_ISLOW, fancy
// upsampling; gray is replicated to RGB; 4-component (CMYK, YCCK) files are
// read as inverted CMYK (PIL's "CMYK;I" rawmode: it assumes Adobe's
// convention for every 4-component JPEG) and converted as PIL's cmyk2rgb.
// Returns 0 on success, 1 on a decode error, 2 if the size differs from
// (w, h), 3 for a component count other than 1, 3 or 4.
int ptd_decode_jpeg_rgb(const uint8_t* blob, int64_t len, uint8_t* out,
                        int64_t w, int64_t h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  if (read_header(&cinfo, blob, len) != 0) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  if (static_cast<int64_t>(cinfo.image_width) != w ||
      static_cast<int64_t>(cinfo.image_height) != h) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const int comps = cinfo.num_components;
  if (comps == 1) {
    cinfo.out_color_space = JCS_GRAYSCALE;
  } else if (comps == 3) {
    cinfo.out_color_space = JCS_RGB;
  } else if (comps == 4) {
    cinfo.out_color_space = JCS_CMYK;
  } else {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  cinfo.dct_method = JDCT_ISLOW;
  cinfo.do_fancy_upsampling = TRUE;
  jpeg_start_decompress(&cinfo);
  const int oc = cinfo.output_components;
  row.resize(static_cast<size_t>(w) * oc);
  JSAMPROW rows[1];
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out + static_cast<int64_t>(cinfo.output_scanline) * w * 3;
    if (oc == 3) {
      rows[0] = dst;
      jpeg_read_scanlines(&cinfo, rows, 1);
      continue;
    }
    rows[0] = row.data();
    jpeg_read_scanlines(&cinfo, rows, 1);
    if (oc == 1) {
      for (int64_t x = 0; x < w; ++x)
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[x];
    } else {
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* p = &row[4 * x];
        const int nk = p[3];  // 255 - (255 - k): the inverted K, un-inverted
        for (int c = 0; c < 3; ++c)
          dst[3 * x + c] = cmyk_channel(255 - p[c], nk);
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"


#else  // PTD_NO_JPEG: platform without libjpeg; decode reports unavailable.

extern "C" int ptd_decode_crop_resize_batch(const uint8_t*, const int64_t*,
                                            int64_t, const float*, int, int,
                                            int, uint8_t*, uint8_t*, int) {
  return -1;
}

extern "C" int ptd_jpeg_header(const uint8_t*, int64_t, int32_t*) { return -1; }

extern "C" int ptd_decode_jpeg_rgb(const uint8_t*, int64_t, uint8_t*, int64_t,
                                   int64_t) {
  return -1;
}

#endif  // PTD_NO_JPEG

// ---------------------------------------------------------------------------
// WebP (libwebp's simple decoding API, the ABI of libwebp.so.7): the header
// fields and one still image decoded to RGBA, as the WebPAnimDecoder PIL
// reads files through writes a single frame (MODE_RGBA, not premultiplied).
// Animated files reach here one frame at a time: binding.py cuts the first
// frame out of its container.
// ---------------------------------------------------------------------------

#ifndef PTD_NO_WEBP

#include <webp/decode.h>

extern "C" {

// Width, height, has-alpha and has-animation of one WebP into info[0..3];
// returns 0 on success, 1 if the bitstream does not parse.
int ptd_webp_info(const uint8_t* blob, int64_t len, int32_t* info) {
  WebPBitstreamFeatures f;
  if (WebPGetFeatures(blob, static_cast<size_t>(len), &f) != VP8_STATUS_OK) return 1;
  info[0] = f.width;
  info[1] = f.height;
  info[2] = f.has_alpha;
  info[3] = f.has_animation;
  return 0;
}

// Decode one still WebP into out [h, w, 4] uint8 RGBA; 0 on success, 1 on a
// decode error.
int ptd_decode_webp_rgba(const uint8_t* blob, int64_t len, uint8_t* out,
                         int64_t w, int64_t h) {
  const size_t size = static_cast<size_t>(w * h * 4);
  return WebPDecodeRGBAInto(blob, static_cast<size_t>(len), out, size,
                            static_cast<int>(w * 4)) == nullptr ? 1 : 0;
}

}  // extern "C"

#else  // PTD_NO_WEBP: platform without libwebp; decode reports unavailable.

extern "C" int ptd_webp_info(const uint8_t*, int64_t, int32_t*) { return -1; }

extern "C" int ptd_decode_webp_rgba(const uint8_t*, int64_t, uint8_t*, int64_t,
                                    int64_t) {
  return -1;
}

#endif  // PTD_NO_WEBP

// ---------------------------------------------------------------------------
// PIL's Image.resize(size, BILINEAR), bit for bit (libImaging/Resample.c):
// a separable, antialiased resample whose filter support grows with the
// downscale factor; coefficients normalised in double, rounded to 22-bit
// fixed point, a horizontal pass into uint8 over the rows the vertical pass
// reads, then a vertical pass, each rounding by adding half and clipping.
// ---------------------------------------------------------------------------

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// precompute_coeffs + normalize_coeffs_8bpc: for each output index, the
// first input index, the tap count and ksize fixed-point weights.
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> k(static_cast<size_t>(ksize));
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    double ww = 0.0;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      const double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      const double v = ww != 0.0 ? k[x] / ww : k[x];
      kk[static_cast<size_t>(xx) * ksize + x] = static_cast<int32_t>(
          v < 0 ? -0.5 + v * (1 << kPrecisionBits)
                : 0.5 + v * (1 << kPrecisionBits));
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

}  // namespace

extern "C" {

// in [in_h, in_w, c] uint8 -> out [out_h, out_w, c] uint8, c <= 4.
void ptd_resize_bilinear(const uint8_t* in, int64_t in_h, int64_t in_w,
                         int64_t c, uint8_t* out, int64_t out_h,
                         int64_t out_w) {
  const int iw = static_cast<int>(in_w), ih = static_cast<int>(in_h);
  const int ow = static_cast<int>(out_w), oh = static_cast<int>(out_h);
  const bool need_h = ow != iw;
  const bool need_v = oh != ih;
  if (!need_h && !need_v) {
    std::memcpy(out, in, static_cast<size_t>(in_h * in_w * c));
    return;
  }
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  const int ksh = precompute_coeffs(iw, ow, bh, kh);
  const int ksv = precompute_coeffs(ih, oh, bv, kv);
  // The horizontal pass covers only the rows the vertical one reads.
  const int y_first = bv[0];
  const int y_last = bv[oh * 2 - 2] + bv[oh * 2 - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int src_w = iw, row0 = 0;
  if (need_h) {
    const int rows = y_last - y_first;
    uint8_t* dst = need_v ? nullptr : out;
    if (need_v) {
      tmp.resize(static_cast<size_t>(rows) * ow * c);
      dst = tmp.data();
    }
    for (int yy = 0; yy < (need_v ? rows : oh); ++yy) {
      const uint8_t* srow = in + (static_cast<int64_t>(yy) + (need_v ? y_first : 0)) * iw * c;
      uint8_t* drow = dst + static_cast<int64_t>(yy) * ow * c;
      for (int xx = 0; xx < ow; ++xx) {
        const int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = &kh[static_cast<size_t>(xx) * ksh];
        for (int64_t ch = 0; ch < c; ++ch) {
          int ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; ++x) ss += srow[(x + xmin) * c + ch] * k[x];
          drow[xx * c + ch] = clip8(ss);
        }
      }
    }
    if (!need_v) return;
    src = tmp.data();
    src_w = ow;
    row0 = y_first;
  }
  for (int yy = 0; yy < oh; ++yy) {
    const int ymin = bv[yy * 2] - row0, ymax = bv[yy * 2 + 1];
    const int32_t* k = &kv[static_cast<size_t>(yy) * ksv];
    uint8_t* drow = out + static_cast<int64_t>(yy) * src_w * c;
    for (int64_t xc = 0; xc < src_w * c; ++xc) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y)
        ss += src[(static_cast<int64_t>(y) + ymin) * src_w * c + xc] * k[y];
      drow[xc] = clip8(ss);
    }
  }
}

// PNG row unfiltering (filter types 0-4: None, Sub, Up, Average, Paeth).
// in: height rows of 1 filter byte + rowbytes; out: height * rowbytes.  bpp
// is the byte distance to the corresponding byte of the pixel to the left
// (1 for bit depths under 8).  Returns 0, or 1 + the row index of an unknown
// filter type.
int ptd_png_unfilter(const uint8_t* in, uint8_t* out, int64_t height,
                     int64_t rowbytes, int bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = in + y * (rowbytes + 1);
    const int ft = src[0];
    ++src;
    uint8_t* cur = out + y * rowbytes;
    const uint8_t* prev = y > 0 ? cur - rowbytes : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, src, static_cast<size_t>(rowbytes));
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int cc = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - cc;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > cc ? p - cc : cc - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : cc);
          cur[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return static_cast<int>(y) + 1;
    }
  }
  return 0;
}

// GIF's variable-length LZW (the image data of one frame, its sub-blocks
// already joined): decodes at most npix indices into out and returns how
// many it wrote, or -1 for a code that names no table entry.  Codes grow
// from min_code_size + 1 bits to 12; a full table stops growing until the
// next clear code, as the GIF89a decoders do.
int64_t ptd_gif_lzw(const uint8_t* in, int64_t len, int min_code_size,
                    uint8_t* out, int64_t npix) {
  if (min_code_size < 1 || min_code_size > 11) return -1;
  const int clear = 1 << min_code_size, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), stack(4097);
  for (int i = 0; i < clear; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = static_cast<uint8_t>(i);
  }
  int size = min_code_size + 1, next = eoi + 1, prev = -1;
  uint32_t bits = 0;
  int nbits = 0;
  int64_t pos = 0, n = 0;
  while (n < npix) {
    while (nbits < size && pos < len) {
      bits |= static_cast<uint32_t>(in[pos++]) << nbits;
      nbits += 8;
    }
    if (nbits < size) break;
    const int code = static_cast<int>(bits & ((1u << size) - 1));
    bits >>= size;
    nbits -= size;
    if (code == clear) {
      size = min_code_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int cur = code;
    uint8_t first;
    if (prev < 0) {
      if (code >= clear) return -1;
      out[n++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    int sp = 0;
    if (code >= next) {  // KwKwK: the code being defined by this very step
      if (code > next) return -1;
      cur = prev;
    }
    for (int c = cur; c != 0xFFFF; c = prefix[c]) stack[sp++] = suffix[c];
    first = stack[sp - 1];
    if (code >= next) {
      // The new entry is prev + its own first byte.
      std::memmove(&stack[1], &stack[0], static_cast<size_t>(sp));
      stack[0] = first;
      ++sp;
    }
    while (sp > 0 && n < npix) out[n++] = stack[--sp];
    if (next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = first;
      ++next;
      if (next == (1 << size) && size < 12) ++size;
    }
    prev = code;
  }
  return n;
}

}  // extern "C"

extern "C" int ptd_data_abi_version() { return 3; }
