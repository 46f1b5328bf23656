// Native data-loader hot path: JPEG decode + bilinear staging resize.
//
// TPU-native replacement for the reference's native data dependencies —
// jpeg4py/libturbojpeg decode (detection_dataset.py:3,23) and OpenCV resize
// (functional/img.py:8-17).  A thread pool decodes a batch of files and
// writes directly into one preallocated uint8 [B, H, W, 3] staging buffer,
// so python sees a single zero-copy numpy array ready for device upload.
//
// Exposed as C symbols for ctypes (no pybind11 in this image).

#include <cstddef>
#include <cstdio>
#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to RGB (or, when want_ycbcr, to interleaved YCbCr —
// skipping libjpeg's color conversion; grayscale sources then come out as
// one channel, reported via *channels).  Returns malloc'd buffer (caller
// frees).  When target dims (tw, th) are positive, decodes at the smallest
// libjpeg DCT scale (num/8) whose output still covers the target in both
// dims — the IDCT then does most of the downsampling work (large speedup,
// proper low-pass). orig_w/orig_h receive the ORIGINAL dims (for box
// rescaling); width/height receive the decoded dims.
uint8_t* decode_jpeg(const char* path, int* width, int* height,
                     int tw, int th, int* orig_w, int* orig_h,
                     int want_ycbcr = 0, int* channels = nullptr) {
  FILE* file = std::fopen(path, "rb");
  if (!file) return nullptr;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  // volatile: modified after setjmp and read in the longjmp error path —
  // without it the error path could free an indeterminate pointer
  uint8_t* volatile buffer = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(file);
    std::free(buffer);
    return nullptr;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, file);
  jpeg_read_header(&cinfo, TRUE);
  int ncomp = 3;
  if (want_ycbcr) {
    // YCbCr passthrough: no color conversion (JPEG stores YCbCr);
    // grayscale sources decode as a bare luma plane
    if (cinfo.jpeg_color_space == JCS_GRAYSCALE) {
      cinfo.out_color_space = JCS_GRAYSCALE;
      ncomp = 1;
    } else if (cinfo.jpeg_color_space == JCS_YCbCr) {
      cinfo.out_color_space = JCS_YCbCr;
    } else {  // CMYK etc. — caller falls back to the RGB path
      jpeg_destroy_decompress(&cinfo);
      std::fclose(file);
      return nullptr;
    }
  } else {
    cinfo.out_color_space = JCS_RGB;
  }
  if (channels) *channels = ncomp;
  // IFAST IDCT: ~1 LSB quality difference, measurably faster scalar path;
  // the staging resize low-passes the result anyway
  cinfo.dct_method = JDCT_IFAST;
  if (tw > 0 && th > 0) {
    // classic libjpeg (v62 ABI) supports only 1/1, 1/2, 1/4, 1/8 —
    // pick the largest denominator whose output still covers the target
    int denom = 1;
    for (int d = 8; d >= 1; d /= 2) {
      const long sw = (cinfo.image_width + d - 1) / d;
      const long sh = (cinfo.image_height + d - 1) / d;
      if (sw >= tw && sh >= th) { denom = d; break; }
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);

  if (orig_w) *orig_w = cinfo.image_width;
  if (orig_h) *orig_h = cinfo.image_height;
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  const size_t stride = static_cast<size_t>(*width) * ncomp;
  buffer = static_cast<uint8_t*>(std::malloc(stride * *height));

  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buffer + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(file);
  return buffer;
}

// Bilinear resize RGB uint8 (same sampling convention as cv2.resize /
// data/transforms.py sample_view: src = (dst + 0.5) * scale - 0.5).
// Fixed-point 8.8 with per-column offsets/weights hoisted out of the row
// loop (the scalar per-pixel float version dominated staging time on
// single-core hosts; agrees with the float path within 1 LSB).
void resize_bilinear(const uint8_t* src, int sw, int sh,
                     uint8_t* dst, int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  std::vector<int> x0(dw), x1(dw), wx1(dw);
  for (int x = 0; x < dw; ++x) {
    const float fx = (x + 0.5f) * sx - 0.5f;
    const int xi = static_cast<int>(std::floor(fx));
    wx1[x] = static_cast<int>((fx - xi) * 256.0f + 0.5f);
    x0[x] = std::clamp(xi, 0, sw - 1) * 3;
    x1[x] = std::clamp(xi + 1, 0, sw - 1) * 3;
  }
  for (int y = 0; y < dh; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    const int yi = static_cast<int>(std::floor(fy));
    const int wy1 = static_cast<int>((fy - yi) * 256.0f + 0.5f);
    const int wy0 = 256 - wy1;
    const uint8_t* r0 =
        src + static_cast<size_t>(std::clamp(yi, 0, sh - 1)) * sw * 3;
    const uint8_t* r1 =
        src + static_cast<size_t>(std::clamp(yi + 1, 0, sh - 1)) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int w1 = wx1[x];
      const int w0 = 256 - w1;
      const uint8_t* p00 = r0 + x0[x];
      const uint8_t* p01 = r0 + x1[x];
      const uint8_t* p10 = r1 + x0[x];
      const uint8_t* p11 = r1 + x1[x];
      for (int c = 0; c < 3; ++c) {
        const int top = p00[c] * w0 + p01[c] * w1;  // 8.8
        const int bot = p10[c] * w0 + p11[c] * w1;
        out[x * 3 + c] =
            static_cast<uint8_t>((top * wy0 + bot * wy1 + (1 << 15)) >> 16);
      }
    }
  }
}

// Bilinear resize of ONE channel of an interleaved image into a contiguous
// plane (same sampling convention as resize_bilinear above).
void resize_bilinear_plane(const uint8_t* src, int sw, int sh, int nch,
                           int ch, uint8_t* dst, int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  std::vector<int> x0(dw), x1(dw), wx1(dw);
  for (int x = 0; x < dw; ++x) {
    const float fx = (x + 0.5f) * sx - 0.5f;
    const int xi = static_cast<int>(std::floor(fx));
    wx1[x] = static_cast<int>((fx - xi) * 256.0f + 0.5f);
    x0[x] = std::clamp(xi, 0, sw - 1) * nch + ch;
    x1[x] = std::clamp(xi + 1, 0, sw - 1) * nch + ch;
  }
  for (int y = 0; y < dh; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    const int yi = static_cast<int>(std::floor(fy));
    const int wy1 = static_cast<int>((fy - yi) * 256.0f + 0.5f);
    const int wy0 = 256 - wy1;
    const uint8_t* r0 =
        src + static_cast<size_t>(std::clamp(yi, 0, sh - 1)) * sw * nch;
    const uint8_t* r1 =
        src + static_cast<size_t>(std::clamp(yi + 1, 0, sh - 1)) * sw * nch;
    uint8_t* out = dst + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; ++x) {
      const int w1 = wx1[x];
      const int w0 = 256 - w1;
      const int top = r0[x0[x]] * w0 + r0[x1[x]] * w1;  // 8.8
      const int bot = r1[x0[x]] * w0 + r1[x1[x]] * w1;
      out[x] = static_cast<uint8_t>((top * wy0 + bot * wy1 + (1 << 15)) >> 16);
    }
  }
}

}  // namespace

extern "C" {

// Decode `count` JPEG files, resize each to (dw, dh), write into
// out[b, dh, dw, 3].  orig_sizes[b*2+{0,1}] receives the ORIGINAL
// (width, height) — box rescaling needs the source frame.  When
// fast_scale != 0, the IDCT decodes directly at the smallest covering
// DCT scale (see decode_jpeg).  Returns the number of successfully decoded
// images; failures leave the slot zeroed with orig_sizes = 0 (python falls
// back for those).
int decode_batch(const char** paths, int count,
                 uint8_t* out, int dw, int dh,
                 int* orig_sizes, int num_threads, int fast_scale) {
  std::atomic<int> next(0);
  std::atomic<int> ok(0);
  const size_t slot = static_cast<size_t>(dw) * dh * 3;
  const int tw = fast_scale ? dw : 0;
  const int th = fast_scale ? dh : 0;

  auto worker = [&]() {
    while (true) {
      int b = next.fetch_add(1);
      if (b >= count) break;
      int w = 0, h = 0, ow = 0, oh = 0;
      uint8_t* img = decode_jpeg(paths[b], &w, &h, tw, th, &ow, &oh);
      if (!img) {
        std::memset(out + slot * b, 0, slot);
        orig_sizes[b * 2] = 0;
        orig_sizes[b * 2 + 1] = 0;
        continue;
      }
      orig_sizes[b * 2] = ow;
      orig_sizes[b * 2 + 1] = oh;
      if (w == dw && h == dh) {
        std::memcpy(out + slot * b, img, slot);
      } else {
        resize_bilinear(img, w, h, out + slot * b, dw, dh);
      }
      std::free(img);
      ok.fetch_add(1);
    }
  };

  int threads = std::max(1, std::min(num_threads, count));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int i = 0; i < threads; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return ok.load();
}

// Decode `count` JPEG files into planar YUV420 staging slots of
// out[b, dh*dw + 2*(dh/2)*(dw/2)] — Y at (dh, dw) then Cb, Cr at
// (dh/2, dw/2).  Ships 1.5 bytes/pixel to the device (vs RGB's 3); the
// device pipeline reconstructs RGB (data/transforms.yuv420_to_rgb) with a
// fused chroma upsample + BT.601 matrix.  Decoding requests interleaved
// YCbCr from libjpeg — the RGB color-conversion pass is skipped entirely
// and the chroma planes resize at quarter area, so host decode is CHEAPER
// than the RGB path too.  Grayscale JPEGs fill Cb=Cr=128.  dw/dh must be
// even (returns -1 otherwise).  Same failure contract as decode_batch.
int decode_batch_yuv420(const char** paths, int count,
                        uint8_t* out, int dw, int dh,
                        int* orig_sizes, int num_threads, int fast_scale) {
  if ((dw | dh) & 1) return -1;
  std::atomic<int> next(0);
  std::atomic<int> ok(0);
  const int cw = dw / 2, chh = dh / 2;
  const size_t y_size = static_cast<size_t>(dw) * dh;
  const size_t c_size = static_cast<size_t>(cw) * chh;
  const size_t slot = y_size + 2 * c_size;
  const int tw = fast_scale ? dw : 0;
  const int th = fast_scale ? dh : 0;

  auto worker = [&]() {
    while (true) {
      int b = next.fetch_add(1);
      if (b >= count) break;
      int w = 0, h = 0, ow = 0, oh = 0, nch = 0;
      uint8_t* img = decode_jpeg(paths[b], &w, &h, tw, th, &ow, &oh,
                                 /*want_ycbcr=*/1, &nch);
      if (!img) {
        std::memset(out + slot * b, 0, slot);
        orig_sizes[b * 2] = 0;
        orig_sizes[b * 2 + 1] = 0;
        continue;
      }
      orig_sizes[b * 2] = ow;
      orig_sizes[b * 2 + 1] = oh;
      uint8_t* y_dst = out + slot * b;
      uint8_t* cb_dst = y_dst + y_size;
      uint8_t* cr_dst = cb_dst + c_size;
      resize_bilinear_plane(img, w, h, nch, 0, y_dst, dw, dh);
      if (nch == 1) {  // grayscale: neutral chroma
        std::memset(cb_dst, 128, c_size);
        std::memset(cr_dst, 128, c_size);
      } else {
        // chroma: resize to the FULL staging grid first, then 2x2
        // box-average — identical semantics to the python fallback
        // (rgb_to_yuv420: subsample OF THE STAGED image).  Resizing
        // straight to the half grid would decimate with a 2-tap filter
        // and alias on large downscales.
        std::vector<uint8_t> full(y_size);
        for (int c = 1; c <= 2; ++c) {
          resize_bilinear_plane(img, w, h, nch, c, full.data(), dw, dh);
          uint8_t* dst = (c == 1) ? cb_dst : cr_dst;
          for (int yy = 0; yy < chh; ++yy) {
            const uint8_t* r0 = full.data() + static_cast<size_t>(2 * yy) * dw;
            const uint8_t* r1 = r0 + dw;
            for (int xx = 0; xx < cw; ++xx) {
              dst[static_cast<size_t>(yy) * cw + xx] = static_cast<uint8_t>(
                  (r0[2 * xx] + r0[2 * xx + 1] + r1[2 * xx] + r1[2 * xx + 1] +
                   2) >> 2);
            }
          }
        }
      }
      std::free(img);
      ok.fetch_add(1);
    }
  };

  int threads = std::max(1, std::min(num_threads, count));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int i = 0; i < threads; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return ok.load();
}

// Single-image decode into a caller buffer of capacity cap bytes (RGB).
// Returns 0 on success.
int decode_single(const char* path, uint8_t* out, long cap,
                  int* width, int* height) {
  int w = 0, h = 0;
  uint8_t* img = decode_jpeg(path, &w, &h, 0, 0, nullptr, nullptr);
  if (!img) return -1;
  long need = static_cast<long>(w) * h * 3;
  if (need > cap) {
    std::free(img);
    return -2;
  }
  std::memcpy(out, img, need);
  *width = w;
  *height = h;
  std::free(img);
  return 0;
}

}  // extern "C"
