// The input pipeline's native hot path: thread-pooled JPEG/PNG decode with
// the dataset transforms fused in (resize / center crop / the D2C crop),
// writing uint8 NHWC batches straight into a caller-provided buffer, and a
// thread-pooled PNG writer for the FID dumps.
//
// The port's own copy of the JAX package's decoder, with the same C ABI and
// the same transforms. The transforms follow the reference's torchvision
// chain (data.py:149-186):
//   center_crop: resize the smaller edge to size (bilinear), center crop
//   d2c:         the 128x128 window at (cx=89, cy=121), then resize
//   else:        a direct resize to (size, size)
// JPEG goes through libjpeg where its headers are found (the JAX package's
// and PIL's decoder: the same bytes as both), else through nvJPEG from the
// CUDA toolkit (built with -DIDL_NVJPEG; the decode runs on the card and
// comes back as host bytes before the same transforms). PNG is read and
// written with zlib on either build. A slot that cannot be decoded
// faithfully (a CMYK or YCCK JPEG, a truncated stream, an unreadable file)
// is zero-filled and marked failed; the caller retries it or raises.
//
// C ABI for ctypes; built by infodiffusion_tpu_torch/data/native.py.

#include <cstddef>  // jpeglib.h needs size_t and FILE first
#include <cstdio>

#if defined(IDL_NVJPEG)
#include <cuda_runtime_api.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif
#include <zlib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

// ---------------------------------------------------------------- JPEG

// Whether the stream runs from SOI through its scans to EOI: every marker
// segment fits, and each scan's entropy-coded data ends at a marker. A
// truncated file ends inside a segment or a scan. (In entropy-coded data
// 0xFF is followed only by a stuffed 0x00, a restart marker or fill.)
bool jpeg_complete(const uint8_t* buf, size_t len) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return false;
  size_t pos = 2;
  while (pos < len) {
    if (buf[pos] != 0xFF) return false;
    while (pos < len && buf[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= len) return false;
    const uint8_t m = buf[pos++];
    if (m == 0xD9) return true;                            // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;   // no length
    if (pos + 2 > len) return false;
    const size_t seg = (size_t(buf[pos]) << 8) | buf[pos + 1];
    if (seg < 2 || pos + seg > len) return false;
    pos += seg;
    if (m != 0xDA) continue;  // not SOS
    for (;;) {  // the scan's entropy-coded data, up to the next marker
      if (pos + 1 >= len) return false;
      if (buf[pos] != 0xFF) {
        ++pos;
        continue;
      }
      const uint8_t n = buf[pos + 1];
      if (n == 0x00 || (n >= 0xD0 && n <= 0xD7)) {
        pos += 2;
      } else if (n == 0xFF) {
        ++pos;
      } else {
        break;  // a marker: back to the segment walk
      }
    }
  }
  return false;
}

// libjpeg's output stage for decoded planes (jdsample.c, jdcolor.c): the
// "fancy" (triangle) chroma upsampling and the fixed-point YCbCr -> RGB
// tables. A decoder that returns raw planes (nvJPEG) goes through these,
// so its RGB differs from libjpeg's only by the inverse DCT.

// chroma [hc][wc] upsampled 2x across (h2v1) or 2x both ways (h2v2) to
// [2 hc or hc][2 wc]; edge rows and columns replicated, as libjpeg's
// context rows are
[[maybe_unused]] void fancy_upsample(const uint8_t* in, int wc, int hc,
                                     bool v2, uint8_t* out) {
  const int wo = 2 * wc;
  const int ho = v2 ? 2 * hc : hc;
  for (int r = 0; r < ho; ++r) {
    const int i = v2 ? r / 2 : r;
    const uint8_t* row = in + size_t(i) * wc;
    uint8_t* o = out + size_t(r) * wo;
    if (wc <= 2) {  // libjpeg upsamples by replication here
      for (int x = 0; x < wo; ++x) o[x] = row[x / 2];
      continue;
    }
    if (!v2) {  // h2v1_fancy_upsample
      o[0] = row[0];
      o[1] = uint8_t((row[0] * 3 + row[1] + 2) >> 2);
      for (int x = 1; x < wc - 1; ++x) {
        const int v = row[x] * 3;
        o[2 * x] = uint8_t((v + row[x - 1] + 1) >> 2);
        o[2 * x + 1] = uint8_t((v + row[x + 1] + 2) >> 2);
      }
      o[wo - 2] = uint8_t((row[wc - 1] * 3 + row[wc - 2] + 1) >> 2);
      o[wo - 1] = row[wc - 1];
      continue;
    }
    // h2v2_fancy_upsample: the nearer row 3/4, the farther 1/4
    const int j = (r % 2 == 0) ? (i > 0 ? i - 1 : 0) : (i + 1 < hc ? i + 1 : i);
    const uint8_t* far = in + size_t(j) * wc;
    auto colsum = [&](int x) { return row[x] * 3 + far[x]; };
    int last = colsum(0), cur = colsum(0), next = colsum(1);
    o[0] = uint8_t((cur * 4 + 8) >> 4);
    o[1] = uint8_t((cur * 3 + next + 7) >> 4);
    for (int x = 1; x < wc - 1; ++x) {
      last = cur;
      cur = next;
      next = colsum(x + 1);
      o[2 * x] = uint8_t((cur * 3 + last + 8) >> 4);
      o[2 * x + 1] = uint8_t((cur * 3 + next + 7) >> 4);
    }
    last = cur;
    cur = next;
    o[wo - 2] = uint8_t((cur * 3 + last + 8) >> 4);
    o[wo - 1] = uint8_t((cur * 4 + 7) >> 4);
  }
}

// Y, Cb, Cr planes (full size, row strides ys / cs) -> RGB [h][w][3]
[[maybe_unused]] void ycc_to_rgb(const uint8_t* y, size_t ys,
                                 const uint8_t* cb, const uint8_t* cr,
                                 size_t cs, int w, int h, uint8_t* rgb) {
  constexpr int kBits = 16;
  constexpr int64_t kHalf = int64_t(1) << (kBits - 1);
  auto fix = [](double v) { return int64_t(v * (1 << kBits) + 0.5); };
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static const bool built = [&] {
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kBits);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    return true;
  }();
  (void)built;
  auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (int r = 0; r < h; ++r) {
    const uint8_t* yr = y + size_t(r) * ys;
    const uint8_t* br = cb + size_t(r) * cs;
    const uint8_t* rr = cr + size_t(r) * cs;
    uint8_t* o = rgb + size_t(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int Y = yr[x], B = br[x], R = rr[x];
      o[3 * x] = clamp(Y + cr_r[R]);
      o[3 * x + 1] = clamp(Y + int((cb_g[B] + cr_g[R]) >> kBits));
      o[3 * x + 2] = clamp(Y + cb_b[B]);
    }
  }
}

#if defined(IDL_NVJPEG)

// nvJPEG (the CUDA toolkit's decoder) where libjpeg is absent: the entropy
// decode and the inverse DCT run in nvJPEG (its hybrid back end: Huffman on
// the host, the transform on the card) into planes in device memory, which
// come back to the host for libjpeg's upsampling and colour conversion
// above, then the same transforms. Subsamplings other than 4:4:4, 4:2:2,
// 4:2:0 and grey take nvJPEG's own RGB conversion. One decoder (state,
// stream, buffer) a pool thread, on one shared handle.
struct JpegDecoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t dev_bytes = 0;
  std::vector<uint8_t> planes, up;  // host planes, upsampled chroma

  explicit JpegDecoder(nvjpegHandle_t h) : handle(h) {
    if (!h || nvjpegJpegStateCreate(h, &state) != NVJPEG_STATUS_SUCCESS ||
        cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
            cudaSuccess) {
      handle = nullptr;
    }
  }
  ~JpegDecoder() {
    if (dev) cudaFree(dev);
    if (stream) cudaStreamDestroy(stream);
    if (state) nvjpegJpegStateDestroy(state);
  }
  JpegDecoder(const JpegDecoder&) = delete;
  JpegDecoder& operator=(const JpegDecoder&) = delete;

  bool reserve(size_t bytes) {
    if (bytes <= dev_bytes) return true;
    if (dev) cudaFree(dev);
    dev = nullptr;
    dev_bytes = 0;
    if (cudaMalloc(reinterpret_cast<void**>(&dev), bytes) != cudaSuccess)
      return false;
    dev_bytes = bytes;
    return true;
  }

  // decode into `outputs` planes of the given sizes, packed one after the
  // other in `dev`, and copy them to `planes`
  bool run(const uint8_t* buf, size_t len, nvjpegOutputFormat_t fmt,
           const size_t* pitch, const int* rows, int n) {
    size_t total = 0;
    for (int c = 0; c < n; ++c) total += pitch[c] * rows[c];
    if (!reserve(total)) return false;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    size_t off = 0;
    for (int c = 0; c < n; ++c) {
      img.channel[c] = dev + off;
      img.pitch[c] = pitch[c];
      off += pitch[c] * rows[c];
    }
    planes.resize(total);
    return nvjpegDecode(handle, state, buf, len, fmt, &img, stream) ==
               NVJPEG_STATUS_SUCCESS &&
           cudaMemcpyAsync(planes.data(), dev, total, cudaMemcpyDeviceToHost,
                           stream) == cudaSuccess &&
           cudaStreamSynchronize(stream) == cudaSuccess;
  }

  bool decode(const uint8_t* buf, size_t len, Image* out) {
    if (!handle) return false;
    int comps = 0;
    nvjpegChromaSubsampling_t css;
    int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
    if (nvjpegGetImageInfo(handle, buf, len, &comps, &css, ws, hs) !=
        NVJPEG_STATUS_SUCCESS) {
      return false;
    }
    // a CMYK or YCCK stream (four components): failed, as libjpeg's RGB
    // conversion fails it
    if (comps != 1 && comps != 3) return false;
    const int w = ws[0], h = hs[0];
    out->w = w;
    out->h = h;
    out->rgb.resize(size_t(w) * h * 3);
    if (comps == 1) {  // grey: Y replicated, as libjpeg's RGB output
      const size_t pitch[1] = {size_t(w)};
      if (!run(buf, len, NVJPEG_OUTPUT_Y, pitch, hs, 1)) return false;
      for (size_t i = 0; i < size_t(w) * h; ++i)
        std::memset(&out->rgb[3 * i], planes[i], 3);
      return true;
    }
    const bool h2 = css == NVJPEG_CSS_422 || css == NVJPEG_CSS_420;
    const bool v2 = css == NVJPEG_CSS_420;
    if (css != NVJPEG_CSS_444 && !h2) {
      const size_t pitch[1] = {size_t(w) * 3};
      if (!run(buf, len, NVJPEG_OUTPUT_RGBI, pitch, hs, 1)) return false;
      std::memcpy(out->rgb.data(), planes.data(), out->rgb.size());
      return true;
    }
    const size_t pitch[3] = {size_t(ws[0]), size_t(ws[1]), size_t(ws[2])};
    if (!run(buf, len, NVJPEG_OUTPUT_YUV, pitch, hs, 3)) return false;
    const uint8_t* y = planes.data();
    const uint8_t* cb = y + pitch[0] * hs[0];
    const uint8_t* cr = cb + pitch[1] * hs[1];
    if (!h2) {
      ycc_to_rgb(y, pitch[0], cb, cr, pitch[1], w, h, out->rgb.data());
      return true;
    }
    // upsampled chroma rows are 2 wc wide; the image takes the first w
    // columns and h rows of them
    const int wc = ws[1], hc = hs[1];
    if (2 * wc < w || (v2 ? 2 * hc : hc) < h) return false;
    const size_t plane = size_t(2 * wc) * (v2 ? 2 * hc : hc);
    up.resize(2 * plane);
    fancy_upsample(cb, wc, hc, v2, up.data());
    fancy_upsample(cr, wc, hc, v2, up.data() + plane);
    ycc_to_rgb(y, pitch[0], up.data(), up.data() + plane, size_t(2 * wc), w,
               h, out->rgb.data());
    return true;
  }
};

struct JpegLibrary {
  nvjpegHandle_t handle = nullptr;
  JpegLibrary() {
    if (nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS) handle = nullptr;
  }
  ~JpegLibrary() {
    if (handle) nvjpegDestroy(handle);
  }
  std::unique_ptr<JpegDecoder> decoder() {
    return std::unique_ptr<JpegDecoder>(new JpegDecoder(handle));
  }
};

#else

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// libjpeg (the JAX package's decoder, PIL's too): a decoder holds nothing
struct JpegDecoder {
  bool decode(const uint8_t* buf, size_t len, Image* out) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.jpeg_color_space == JCS_CMYK ||
        cinfo.jpeg_color_space == JCS_YCCK) {
      // JCS_RGB conversion from CMYK is a fatal libjpeg error: fail the
      // slot, which the Python side retries through PIL (which converts)
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    out->w = cinfo.output_width;
    out->h = cinfo.output_height;
    out->rgb.resize(size_t(out->w) * out->h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* row =
          out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    // libjpeg reports truncated streams as WARNINGS (it inserts a fake
    // EOI and fills with garbage) — error_exit never fires. Treat any
    // corrupt-data warning as a failed decode like PIL does.
    bool clean = cinfo.err->num_warnings == 0;
    jpeg_destroy_decompress(&cinfo);
    return clean;
  }
};

struct JpegLibrary {
  std::unique_ptr<JpegDecoder> decoder() {
    return std::unique_ptr<JpegDecoder>(new JpegDecoder());
  }
};

#endif

// ----------------------------------------------------------------- PNG
//
// PNG through zlib: 8-bit, non-interlaced files of every colour type
// (grey, RGB, palette, grey + alpha, RGBA), read as PIL's convert('RGB')
// reads them: grey replicated, a palette looked up, alpha dropped (not
// composited). Any other file (16-bit, interlaced, a bad CRC, a palette
// index out of range) fails its slot.

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

// undo the row filters in place: rows [h][1 + stride], bpp bytes a pixel
bool png_unfilter(uint8_t* rows, size_t h, size_t stride, size_t bpp) {
  const uint8_t* prev = nullptr;
  for (size_t y = 0; y < h; ++y) {
    uint8_t* row = rows + y * (stride + 1);
    const uint8_t kind = row[0];
    uint8_t* cur = row + 1;
    for (size_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return false;
      }
      cur[i] = uint8_t(cur[i] + pred);
    }
    prev = cur;
  }
  return true;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  if (len < 8 || std::memcmp(buf, kPngSignature, 8) != 0) return false;
  uint32_t w = 0, h = 0;
  int ctype = -1;
  std::vector<uint8_t> idat, palette;
  bool ended = false;
  for (size_t pos = 8; pos + 12 <= len && !ended;) {
    const uint32_t n = be32(buf + pos);
    if (n > len - pos - 12) return false;
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (uint32_t(crc32(crc32(0, nullptr, 0), type, n + 4)) != be32(data + n))
      return false;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (n != 13) return false;
      w = be32(data);
      h = be32(data + 4);
      ctype = data[9];
      // 8 bits, deflate, filter method 0, no interlace
      if (data[8] != 8 || data[10] != 0 || data[11] != 0 || data[12] != 0)
        return false;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      palette.assign(data, data + n);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + n);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      ended = true;
    }
    pos += size_t(n) + 12;
  }
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  if (!ended || w == 0 || h == 0 || ctype < 0 || ctype > 6 ||
      kChannels[ctype] == 0 || (ctype == 3 && palette.empty()) ||
      size_t(w) * h > (size_t(1) << 28)) {
    return false;
  }
  const size_t bpp = kChannels[ctype];
  const size_t stride = size_t(w) * bpp;
  std::vector<uint8_t> rows(size_t(h) * (stride + 1));
  uLongf got = rows.size();
  if (uncompress(rows.data(), &got, idat.data(), idat.size()) != Z_OK ||
      got != rows.size() || !png_unfilter(rows.data(), h, stride, bpp)) {
    return false;
  }
  out->w = int(w);
  out->h = int(h);
  out->rgb.resize(size_t(w) * h * 3);
  const size_t entries = palette.size() / 3;
  for (size_t y = 0; y < h; ++y) {
    const uint8_t* src = rows.data() + y * (stride + 1) + 1;
    uint8_t* dst = out->rgb.data() + y * size_t(w) * 3;
    for (size_t x = 0; x < w; ++x, src += bpp, dst += 3) {
      if (ctype == 3) {
        if (src[0] >= entries) return false;
        std::memcpy(dst, palette.data() + size_t(src[0]) * 3, 3);
      } else if (bpp >= 3) {
        std::memcpy(dst, src, 3);
      } else {
        dst[0] = dst[1] = dst[2] = src[0];
      }
    }
  }
  return true;
}

// one PNG: 8-bit grey (c == 1) or RGB (c == 3), filter 0 on every row,
// zlib's default level
bool write_png(const char* path, const uint8_t* px, int h, int w, int c) {
  const size_t stride = size_t(w) * c;
  std::vector<uint8_t> rows(size_t(h) * (stride + 1), 0);
  for (int y = 0; y < h; ++y)
    std::memcpy(rows.data() + size_t(y) * (stride + 1) + 1,
                px + size_t(y) * stride, stride);
  uLongf zlen = compressBound(rows.size());
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, rows.data(), rows.size(),
                Z_DEFAULT_COMPRESSION) != Z_OK) {
    return false;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  auto chunk = [f](const char* type, const uint8_t* data, size_t n) {
    uint8_t head[8] = {uint8_t(n >> 24), uint8_t(n >> 16), uint8_t(n >> 8),
                       uint8_t(n), uint8_t(type[0]), uint8_t(type[1]),
                       uint8_t(type[2]), uint8_t(type[3])};
    uLong crc = crc32(crc32(0, nullptr, 0), head + 4, 4);
    if (n) crc = crc32(crc, data, uInt(n));
    uint8_t tail[4] = {uint8_t(crc >> 24), uint8_t(crc >> 16),
                       uint8_t(crc >> 8), uint8_t(crc)};
    return std::fwrite(head, 1, 8, f) == 8 &&
           (n == 0 || std::fwrite(data, 1, n, f) == n) &&
           std::fwrite(tail, 1, 4, f) == 4;
  };
  const uint8_t ihdr[13] = {
      uint8_t(w >> 24), uint8_t(w >> 16), uint8_t(w >> 8), uint8_t(w),
      uint8_t(h >> 24), uint8_t(h >> 16), uint8_t(h >> 8), uint8_t(h),
      8, uint8_t(c == 3 ? 2 : 0), 0, 0, 0};
  const bool ok = std::fwrite(kPngSignature, 1, 8, f) == 8 &&
                  chunk("IHDR", ihdr, 13) && chunk("IDAT", z.data(), zlen) &&
                  chunk("IEND", nullptr, 0);
  return std::fclose(f) == 0 && ok;
}

bool decode_any(JpegDecoder& jpeg, const std::string& path, Image* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n > 0 ? size_t(n) : 0);
  size_t got = buf.empty() ? 0 : std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got < 8) return false;
  if (buf[0] == 0x89 && buf[1] == 0x50) return decode_png(buf.data(), got, out);
  // anything else is taken for a JPEG; a stream that stops early fails
  return jpeg_complete(buf.data(), got) && jpeg.decode(buf.data(), got, out);
}

// ------------------------------------------------------------- resample

// Antialiased bilinear (triangle-filter) resampling, PIL-compatible:
// filter support scales with the downscale ratio, separable two-pass.
// This matches torchvision's default Resize semantics (antialias on),
// which the reference's transform chains rely on (data.py:124,157-162).

struct FilterTaps {
  std::vector<int> start;       // first source index per output coord
  std::vector<int> count;       // taps per output coord
  std::vector<float> weights;   // flattened [out][count]
  int max_count = 0;
};

FilterTaps build_taps(int src_n, int dst_n) {
  FilterTaps t;
  double scale = double(src_n) / dst_n;
  double support = scale < 1.0 ? 1.0 : scale;  // triangle radius
  t.start.resize(dst_n);
  t.count.resize(dst_n);
  std::vector<std::vector<float>> rows(dst_n);
  for (int o = 0; o < dst_n; ++o) {
    double center = (o + 0.5) * scale;
    int lo = int(std::floor(center - support));
    int hi = int(std::ceil(center + support));
    if (lo < 0) lo = 0;
    if (hi > src_n) hi = src_n;
    double norm = 0.0;
    std::vector<float> w;
    for (int i = lo; i < hi; ++i) {
      double d = (i + 0.5 - center) / (scale < 1.0 ? 1.0 : scale);
      double v = d < 0 ? 1.0 + d : 1.0 - d;  // triangle
      if (v < 0) v = 0;
      w.push_back(float(v));
      norm += v;
    }
    if (norm <= 0) {  // degenerate: nearest
      lo = int(center);
      if (lo >= src_n) lo = src_n - 1;
      hi = lo + 1;
      w.assign(1, 1.0f);
      norm = 1.0;
    }
    for (auto& v : w) v = float(v / norm);
    t.start[o] = lo;
    t.count[o] = int(w.size());
    if (t.count[o] > t.max_count) t.max_count = t.count[o];
    rows[o] = std::move(w);
  }
  for (auto& r : rows)
    t.weights.insert(t.weights.end(), r.begin(), r.end());
  return t;
}

void resize_bilinear(const Image& src, int dw, int dh, uint8_t* dst) {
  FilterTaps tx = build_taps(src.w, dw);
  FilterTaps ty = build_taps(src.h, dh);
  // horizontal pass: [src.h, dw, 3] float
  std::vector<float> mid(size_t(src.h) * dw * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* row = src.rgb.data() + size_t(y) * src.w * 3;
    float* mrow = mid.data() + size_t(y) * dw * 3;
    const float* wbase = tx.weights.data();
    size_t woff = 0;
    for (int x = 0; x < dw; ++x) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      int s = tx.start[x], c = tx.count[x];
      for (int k = 0; k < c; ++k) {
        float w = wbase[woff + k];
        const uint8_t* p = row + size_t(s + k) * 3;
        acc0 += w * p[0];
        acc1 += w * p[1];
        acc2 += w * p[2];
      }
      woff += c;
      mrow[x * 3 + 0] = acc0;
      mrow[x * 3 + 1] = acc1;
      mrow[x * 3 + 2] = acc2;
    }
  }
  // vertical pass
  size_t woff = 0;
  for (int y = 0; y < dh; ++y) {
    int s = ty.start[y], c = ty.count[y];
    uint8_t* drow = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < c; ++k) {
        float w = ty.weights[woff + k];
        const float* p = mid.data() + (size_t(s + k) * dw + x) * 3;
        acc0 += w * p[0];
        acc1 += w * p[1];
        acc2 += w * p[2];
      }
      drow[x * 3 + 0] = uint8_t(acc0 < 0 ? 0 : (acc0 > 255 ? 255 : acc0 + 0.5f));
      drow[x * 3 + 1] = uint8_t(acc1 < 0 ? 0 : (acc1 > 255 ? 255 : acc1 + 0.5f));
      drow[x * 3 + 2] = uint8_t(acc2 < 0 ? 0 : (acc2 > 255 ? 255 : acc2 + 0.5f));
    }
    woff += c;
  }
}

// crop the (x0, y0, w, h) window into dst (w*h*3, zero-padded outside
// the source bounds) — writing straight into the caller's buffer so the
// center-crop hot path (CelebA, ~200k images/epoch) skips a copy
void crop_into(const Image& src, int x0, int y0, int w, int h,
               uint8_t* dst) {
  std::memset(dst, 0, size_t(w) * h * 3);
  for (int y = 0; y < h; ++y) {
    int sy = y0 + y;
    if (sy < 0 || sy >= src.h) continue;
    int xs = x0 < 0 ? -x0 : 0;
    int xe = (x0 + w > src.w) ? src.w - x0 : w;
    if (xe <= xs) continue;
    std::memcpy(dst + (size_t(y) * w + xs) * 3,
                src.rgb.data() + (size_t(sy) * src.w + x0 + xs) * 3,
                size_t(xe - xs) * 3);
  }
}

void crop(const Image& src, int x0, int y0, int w, int h, Image* out) {
  out->w = w;
  out->h = h;
  out->rgb.resize(size_t(w) * h * 3);
  crop_into(src, x0, y0, w, h, out->rgb.data());
}

struct Loader {
  std::vector<std::string> paths;
  int size;
  int center_crop;
  int d2c;
  int threads;
  JpegLibrary jpeg;
  std::vector<std::unique_ptr<JpegDecoder>> decoders;  // one a pool thread
};

bool transform_one(const Loader& L, JpegDecoder& jpeg,
                   const std::string& path, uint8_t* out) {
  Image img;
  if (!decode_any(jpeg, path, &img)) return false;
  const int S = L.size;
  if (L.d2c) {
    // D2C 128px window at (cx=89, cy=121) (reference: data.py:24-32)
    Image c;
    crop(img, 89 - 64, 121 - 64, 128, 128, &c);
    resize_bilinear(c, S, S, out);
  } else if (L.center_crop) {
    // double + nearbyint (round-half-even) to match the PIL fallback's
    // Python round() exactly at .5 scale boundaries (datasets.py:121)
    double scale = double(S) / (img.w < img.h ? img.w : img.h);
    int nw = int(std::nearbyint(img.w * scale));
    int nh = int(std::nearbyint(img.h * scale));
    std::vector<uint8_t> tmp(size_t(nw) * nh * 3);
    resize_bilinear(img, nw, nh, tmp.data());
    Image r;
    r.w = nw;
    r.h = nh;
    r.rgb = std::move(tmp);
    crop_into(r, (nw - S) / 2, (nh - S) / 2, S, S, out);
  } else {
    resize_bilinear(img, S, S, out);
  }
  return true;
}

}  // namespace

extern "C" {

void* idl_create(const char** paths, int n, int size, int center_crop,
                 int d2c, int threads) {
  auto* L = new Loader;
  L->paths.reserve(n);
  for (int i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->size = size;
  L->center_crop = center_crop;
  L->d2c = d2c;
  L->threads = threads > 0 ? threads : int(std::thread::hardware_concurrency());
  if (L->threads < 1) L->threads = 1;
  for (int t = 0; t < L->threads; ++t)
    L->decoders.push_back(L->jpeg.decoder());
  return L;
}

void idl_destroy(void* h) { delete static_cast<Loader*>(h); }

// decode batch of dataset indices into out [b, size, size, 3] uint8;
// returns number of failures. Failed slots are zero-filled and marked
// 1 in the caller's `failed` mask (length b, may be NULL) so the
// Python side can retry exactly those files through PIL (which handles
// color spaces the RGB conversion rejects, e.g. CMYK) or raise.
int idl_decode_batch(void* h, const int* idx, int b, uint8_t* out,
                     uint8_t* failed) {
  auto* L = static_cast<Loader*>(h);
  const size_t stride = size_t(L->size) * L->size * 3;
  if (failed) std::memset(failed, 0, size_t(b));
  std::atomic<int> next(0), fails(0);
  int nthreads = L->threads < b ? L->threads : b;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&, t]() {
      for (int i = next.fetch_add(1); i < b; i = next.fetch_add(1)) {
        uint8_t* dst = out + stride * i;
        int j = idx[i];
        if (j < 0 || j >= int(L->paths.size()) ||
            !transform_one(*L, *L->decoders[t], L->paths[j], dst)) {
          std::memset(dst, 0, stride);
          if (failed) failed[i] = 1;
          fails.fetch_add(1);
        }
      }
    });
  }
  for (auto& th : ts) th.join();
  return fails.load();
}

}  // extern "C"

// ------------------------------------------------------------ PNG writer
//
// Thread-pooled batch PNG writer for eval_fid's 10k-image dumps
// (the reference writes one PIL PNG at a time, run.py:289-295).

extern "C" {

// data: [b, h, w, c] uint8 (c == 1 or 3); returns number of failures
int idl_write_png_batch(const char** paths, const uint8_t* data, int b,
                        int h, int w, int c, int threads) {
  if (c != 1 && c != 3) return b;
  const size_t stride = size_t(h) * w * c;
  std::atomic<int> next(0), fails(0);
  int nthreads = threads > 0 ? threads
                             : int(std::thread::hardware_concurrency());
  if (nthreads > b) nthreads = b;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < b; i = next.fetch_add(1)) {
        if (!write_png(paths[i], data + stride * i, h, w, c))
          fails.fetch_add(1);
      }
    });
  }
  for (auto& th : ts) th.join();
  return fails.load();
}

}  // extern "C"
