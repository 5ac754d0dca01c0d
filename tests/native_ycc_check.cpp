// Check of image_loader.cpp's output stage for decoders that return raw
// planes (the nvJPEG build): libjpeg decodes each file twice, once to RGB
// and once to its raw Y, Cb, Cr planes (raw_data_out); fancy_upsample and
// ycc_to_rgb applied to the planes must give libjpeg's RGB bit for bit.
// Built and run by tests/test_torch_native.py:
//   g++ -std=c++17 native_ycc_check.cpp -ljpeg -lz -pthread
//   ./a.out file.jpg ...   (exit status: the number of files that differ)

#include "../infodiffusion_tpu_torch/native/image_loader.cpp"

#include <fstream>
#include <iterator>

namespace {

// the raw planes, each [rows][downsampled width]
struct Planes {
  std::vector<std::vector<uint8_t>> p;
  std::vector<int> w, h;
  int h_samp = 1, v_samp = 1;
};

bool read_planes(const std::vector<uint8_t>& buf, Planes* out) {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf.data(), buf.size());
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components != 3) return false;
  cinfo.raw_data_out = TRUE;
  cinfo.out_color_space = JCS_YCbCr;
  jpeg_start_decompress(&cinfo);
  std::vector<std::vector<uint8_t>> padded(3);
  std::vector<int> stride(3);
  for (int c = 0; c < 3; ++c) {
    const jpeg_component_info& ci = cinfo.comp_info[c];
    stride[c] = ci.width_in_blocks * DCTSIZE;
    padded[c].resize(size_t(stride[c]) *
                     (ci.height_in_blocks + 2 * ci.v_samp_factor) * DCTSIZE);
    out->w.push_back(ci.downsampled_width);
    out->h.push_back(ci.downsampled_height);
  }
  out->h_samp = cinfo.comp_info[0].h_samp_factor;
  out->v_samp = cinfo.comp_info[0].v_samp_factor;
  const int group = cinfo.max_v_samp_factor * DCTSIZE;
  for (int row = 0; cinfo.output_scanline < cinfo.output_height;
       row += group) {
    std::vector<JSAMPROW> rows[3];
    JSAMPARRAY arrays[3];
    for (int c = 0; c < 3; ++c) {
      const int v = cinfo.comp_info[c].v_samp_factor;
      const int first = row / cinfo.max_v_samp_factor * v;
      for (int r = 0; r < v * DCTSIZE; ++r)
        rows[c].push_back(padded[c].data() + size_t(first + r) * stride[c]);
      arrays[c] = rows[c].data();
    }
    jpeg_read_raw_data(&cinfo, arrays, group);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  for (int c = 0; c < 3; ++c) {
    out->p.emplace_back(size_t(out->w[c]) * out->h[c]);
    for (int r = 0; r < out->h[c]; ++r)
      std::memcpy(&out->p[c][size_t(r) * out->w[c]],
                  &padded[c][size_t(r) * stride[c]], out->w[c]);
  }
  return true;
}

int check(const char* path) {
  std::ifstream f(path, std::ios::binary);
  std::vector<uint8_t> buf((std::istreambuf_iterator<char>(f)), {});
  Image want;
  JpegDecoder decoder;
  Planes planes;
  if (!decoder.decode(buf.data(), buf.size(), &want) ||
      !read_planes(buf, &planes)) {
    std::printf("%s: not decoded\n", path);
    return 1;
  }
  const int w = want.w, h = want.h;
  std::vector<uint8_t> got(size_t(w) * h * 3);
  if (planes.h_samp == 1 && planes.v_samp == 1) {
    ycc_to_rgb(planes.p[0].data(), planes.w[0], planes.p[1].data(),
               planes.p[2].data(), planes.w[1], w, h, got.data());
  } else {
    const bool v2 = planes.v_samp == 2;
    const int wc = planes.w[1], hc = planes.h[1];
    const size_t plane = size_t(2 * wc) * (v2 ? 2 * hc : hc);
    std::vector<uint8_t> up(2 * plane);
    fancy_upsample(planes.p[1].data(), wc, hc, v2, up.data());
    fancy_upsample(planes.p[2].data(), wc, hc, v2, up.data() + plane);
    ycc_to_rgb(planes.p[0].data(), planes.w[0], up.data(), up.data() + plane,
               size_t(2 * wc), w, h, got.data());
  }
  size_t differ = 0;
  for (size_t i = 0; i < got.size(); ++i) differ += got[i] != want.rgb[i];
  std::printf("%s %dx%d sampling %dx%d: %zu of %zu values differ\n", path, w,
              h, planes.h_samp, planes.v_samp, differ, got.size());
  return differ != 0;
}

}  // namespace

int main(int argc, char** argv) {
  int bad = 0;
  for (int i = 1; i < argc; ++i) bad += check(argv[i]);
  return bad;
}
