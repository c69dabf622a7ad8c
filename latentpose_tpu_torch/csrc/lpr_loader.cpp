// lpr_loader — image decode + crop + resize batch loader on the host (the
// port's copy of native/lpr_loader.cpp, with a decoder that builds where
// libjpeg and libpng are absent, and the segmentation mask's crop).
//
// The input pipeline's hot loop (JPEG/PNG decode, the dataset's blur-faded
// padded crop, resize to the model resolution, float conversion) runs in a
// C++ thread pool, called from Python through ctypes (which releases the
// GIL).  Built with g++ by latentpose_tpu_torch/data/native_loader.py.
//
// Decoders:
//   PNG  — this file: zlib's inflate, the five row filters, Adam7, every
//          colour type; as libpng with png_set_expand, png_set_strip_16,
//          png_set_strip_alpha and png_set_gray_to_rgb (8-bit RGB out).
//   JPEG — libjpeg when its headers exist (-DLPR_WITH_LIBJPEG, -ljpeg),
//          else nvJPEG's host API (-DLPR_WITH_NVJPEG, -lnvjpeg -lcudart),
//          one decoder state, stream and device buffer per pool thread.
//
// API (extern "C"):
//   void* lpr_create(int num_threads);
//   void  lpr_destroy(void* pool);
//   const char* lpr_jpeg_decoder();     // "libjpeg" or "nvjpeg"
//   int   lpr_load_batch(pool, paths, n, crops /* n x (t, l, b, r) or NULL */,
//                        target_h, target_w, float* out /* n*th*tw*3 */);
//   int   lpr_load_cropped_batch(pool, paths, n, bboxes /* n x (l, t, r, b) */,
//                                has_bbox, out_size, float* out /* n*S*S*3 */);
//   int   lpr_load_segm_batch(pool, paths, n, bboxes, has_bbox, out_size,
//                             float* out /* n*S*S */);
//   int   lpr_crop_segm(mask /* h*w uint8 */, h, w, bbox, has_bbox, out_size,
//                       float* out /* S*S */);
//   int   lpr_load_cropped_batch_u8, lpr_load_segm_batch_u8,
//         lpr_crop_segm_u8(... unsigned char* out);  // the uint8 wire:
//         the float entries' results as uint8(v * 255 + 0.5)
//   int   lpr_decode(path, unsigned char* out /* or NULL */, size_t cap,
//                    int* h, int* w);  // one image at its own size, RGB u8
//   int   lpr_crop_boxes_u8(pool, imgs /* n*h*w*3 uint8 RGB */, n, h, w,
//                           boxes /* n x (t, l, b, r) pixels */, cubic /* n */,
//                           out_size, unsigned char* out /* n*S*S*3 */);
//         // the cropper's and drive --crop's blur-faded padded crop of
//         // frames in memory, INTER_CUBIC / INTER_AREA to S², uint8 out
// Each batch entry returns the number of images that failed to load (their
// slots are zeroed).

#include <zlib.h>

#if defined(LPR_WITH_LIBJPEG)
#include <cstdio>
#include <jpeglib.h>
#elif defined(LPR_WITH_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#error "define LPR_WITH_LIBJPEG or LPR_WITH_NVJPEG"
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<unsigned char> rgb;  // H*W*3
  int w = 0, h = 0;
};

bool read_file(const char* path, std::vector<unsigned char>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long size = ok ? ftell(f) : -1;
  ok = ok && size > 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(size_t(size));
    ok = fread(buf->data(), 1, buf->size(), f) == buf->size();
  }
  fclose(f);
  return ok;
}

// ---------- JPEG ----------
//
// Both decoders hand over the decoded samples before colour conversion (the
// Y plane, and Cb and Cr at their own, subsampled, sizes); planes_to_rgb
// then upsamples and converts them as libjpeg does by default ("fancy"
// upsampling, jdsample.c; ycc_rgb_convert's tables, jdcolor.c), so the two
// decoders differ only by their inverse DCTs.  A JPEG whose planes this
// does not cover (CMYK, 4:4:0, 4:1:1, ...) takes the decoder's own RGB.

struct Planes {
  int w = 0, h = 0, ncomp = 0;         // image size; 1 (grey) or 3 (YCbCr)
  int pw[3] = {0, 0, 0}, ph[3] = {0, 0, 0};
  std::vector<unsigned char> p[3];     // pw x ph each
};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One chroma plane upsampled 2x across (h2v1) or 2x both ways (h2v2) by
// libjpeg's triangular filter (by replication where the plane is at most 2
// wide, as libjpeg does); rows beyond the edges repeat the edge row.
std::vector<unsigned char> upsample(const std::vector<unsigned char>& in,
                                    int pw, int ph, bool twice_down) {
  const int ow = 2 * pw, oh = twice_down ? 2 * ph : ph;
  std::vector<unsigned char> out(size_t(ow) * oh);
  std::vector<int> sum(pw);
  for (int oy = 0; oy < oh; ++oy) {
    const int r = twice_down ? oy / 2 : oy;
    const unsigned char* near = &in[size_t(r) * pw];
    unsigned char* o = &out[size_t(oy) * ow];
    if (pw <= 2) {
      for (int c = 0; c < ow; ++c) o[c] = near[c / 2];
    } else if (twice_down) {
      const int other = clampi(oy % 2 ? r + 1 : r - 1, 0, ph - 1);
      const unsigned char* far = &in[size_t(other) * pw];
      for (int c = 0; c < pw; ++c) sum[c] = near[c] * 3 + far[c];
      for (int c = 0; c < pw; ++c) {
        o[2 * c] = (unsigned char)(
            c == 0 ? (sum[c] * 4 + 8) >> 4 : (sum[c] * 3 + sum[c - 1] + 8) >> 4);
        o[2 * c + 1] = (unsigned char)(
            c == pw - 1 ? (sum[c] * 4 + 7) >> 4
                        : (sum[c] * 3 + sum[c + 1] + 7) >> 4);
      }
    } else {
      for (int c = 0; c < pw; ++c) {
        o[2 * c] = (unsigned char)(
            c == 0 ? near[c] : (near[c] * 3 + near[c - 1] + 1) >> 2);
        o[2 * c + 1] = (unsigned char)(
            c == pw - 1 ? near[c] : (near[c] * 3 + near[c + 1] + 2) >> 2);
      }
    }
  }
  return out;
}

bool planes_to_rgb(const Planes& pl, Image* img) {
  img->w = pl.w;
  img->h = pl.h;
  img->rgb.resize(size_t(pl.w) * pl.h * 3);
  if (pl.ncomp == 1) {
    for (size_t i = 0; i < size_t(pl.w) * pl.h; ++i) {
      const unsigned char y = pl.p[0][(i / pl.w) * pl.pw[0] + i % pl.w];
      img->rgb[3 * i] = img->rgb[3 * i + 1] = img->rgb[3 * i + 2] = y;
    }
    return true;
  }
  // each chroma plane at full size: as it is, or upsampled 2x across (4:2:2)
  // or 2x both ways (4:2:0)
  std::vector<unsigned char> chroma[2];
  int cw[2];
  for (int k = 0; k < 2; ++k) {
    const int c = k + 1;
    const bool across = pl.pw[c] == (pl.w + 1) / 2 && pl.pw[c] < pl.w;
    const bool down = pl.ph[c] == (pl.h + 1) / 2 && pl.ph[c] < pl.h;
    if (!across && pl.pw[c] == pl.w && pl.ph[c] == pl.h) {
      chroma[k] = pl.p[c];
      cw[k] = pl.w;
    } else if (across && (down || pl.ph[c] == pl.h)) {
      chroma[k] = upsample(pl.p[c], pl.pw[c], pl.ph[c], down);
      cw[k] = 2 * pl.pw[c];
    } else {
      return false;
    }
  }
  // jdcolor.c's tables: 16 fractional bits, rounded
  const long kHalf = 1L << 15;
  auto fix = [](double x) { return long(x * 65536.0 + 0.5); };
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const long x = i - 128;
    cr_r[i] = int((fix(1.40200) * x + kHalf) >> 16);
    cb_b[i] = int((fix(1.77200) * x + kHalf) >> 16);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  for (int y = 0; y < pl.h; ++y) {
    for (int x = 0; x < pl.w; ++x) {
      const int luma = pl.p[0][size_t(y) * pl.pw[0] + x];
      const int cb = chroma[0][size_t(y) * cw[0] + x];
      const int cr = chroma[1][size_t(y) * cw[1] + x];
      unsigned char* o = &img->rgb[(size_t(y) * pl.w + x) * 3];
      o[0] = (unsigned char)clampi(luma + cr_r[cr], 0, 255);
      o[1] = (unsigned char)clampi(
          luma + int((cb_g[cb] + cr_g[cr]) >> 16), 0, 255);
      o[2] = (unsigned char)clampi(luma + cb_b[cb], 0, 255);
    }
  }
  return true;
}

#if defined(LPR_WITH_LIBJPEG)

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode to planes (raw_data_out: libjpeg's IDCT output, before upsampling
// and colour conversion) where the JPEG is YCbCr or grey, else to RGB.
bool decode_jpeg(const unsigned char* data, size_t len, Image* img) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  // declared before setjmp, so that a longjmp skips no destructor
  Planes pl;
  std::vector<std::vector<JSAMPROW>> rows(3);
  std::vector<std::vector<unsigned char>> full(3);
  std::vector<int> stride(3), per_call(3);
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  // grey, or YCbCr with chroma at 4:4:4, 4:2:2 or 4:2:0
  const jpeg_component_info* ci = cinfo.comp_info;
  const bool raw =
      (cinfo.jpeg_color_space == JCS_GRAYSCALE && cinfo.num_components == 1) ||
      (cinfo.jpeg_color_space == JCS_YCbCr && cinfo.num_components == 3 &&
       ci[1].h_samp_factor == 1 && ci[1].v_samp_factor == 1 &&
       ci[2].h_samp_factor == 1 && ci[2].v_samp_factor == 1 &&
       (ci[0].h_samp_factor == 1 || ci[0].h_samp_factor == 2) &&
       ci[0].v_samp_factor <= ci[0].h_samp_factor);
  if (!raw) {
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    img->w = cinfo.output_width;
    img->h = cinfo.output_height;
    img->rgb.resize(size_t(img->w) * img->h * 3);
    const int stride = img->w * 3;
    while (cinfo.output_scanline < cinfo.output_height) {
      unsigned char* row =
          img->rgb.data() + size_t(cinfo.output_scanline) * stride;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  cinfo.raw_data_out = TRUE;
  cinfo.out_color_space = cinfo.jpeg_color_space;
  jpeg_start_decompress(&cinfo);
  pl.w = cinfo.output_width;
  pl.h = cinfo.output_height;
  pl.ncomp = cinfo.num_components;
  // each component's IDCT output, whole blocks, one iMCU row per call
  for (int c = 0; c < pl.ncomp; ++c) {
    const jpeg_component_info& ci = cinfo.comp_info[c];
    stride[c] = ci.width_in_blocks * DCTSIZE;
    per_call[c] = ci.v_samp_factor * DCTSIZE;
    full[c].resize(size_t(stride[c]) * per_call[c] *
                   (cinfo.total_iMCU_rows + 1));
    rows[c].resize(per_call[c]);
    pl.pw[c] = ci.downsampled_width;
    pl.ph[c] = ci.downsampled_height;
  }
  JSAMPARRAY arrays[3];
  for (int imcu = 0; cinfo.output_scanline < cinfo.output_height; ++imcu) {
    for (int c = 0; c < pl.ncomp; ++c) {
      for (int r = 0; r < per_call[c]; ++r)
        rows[c][r] = &full[c][(size_t(imcu) * per_call[c] + r) * stride[c]];
      arrays[c] = rows[c].data();
    }
    jpeg_read_raw_data(&cinfo, arrays, cinfo.max_v_samp_factor * DCTSIZE);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  for (int c = 0; c < pl.ncomp; ++c) {
    pl.p[c].resize(size_t(pl.pw[c]) * pl.ph[c]);
    for (int y = 0; y < pl.ph[c]; ++y)
      std::memcpy(&pl.p[c][size_t(y) * pl.pw[c]],
                  &full[c][size_t(y) * stride[c]], pl.pw[c]);
  }
  return planes_to_rgb(pl, img);
}

const char* kJpegDecoder = "libjpeg";

#else  // LPR_WITH_NVJPEG

nvjpegHandle_t nvjpeg_handle() {
  static nvjpegHandle_t handle = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    if (nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS) handle = nullptr;
  });
  return handle;
}

// One decoder state, stream and device output buffer per pool thread (the
// handle is thread-safe, a state is not); freed when the pool's threads end.
struct NvjpegThread {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t cap = 0;
  ~NvjpegThread() {
    if (dev) cudaFree(dev);
    if (state) nvjpegJpegStateDestroy(state);
    if (stream) cudaStreamDestroy(stream);
  }
};

// Decode on the card: to planes (NVJPEG_OUTPUT_Y / _YUV, the IDCT output)
// for grey, 4:4:4, 4:2:2 and 4:2:0 (``planes``), else to nvJPEG's own RGB.
bool decode_jpeg_nvjpeg(const unsigned char* data, size_t len, Image* img,
                        bool planes) {
  nvjpegHandle_t handle = nvjpeg_handle();
  if (!handle) return false;
  thread_local NvjpegThread t;
  if (!t.stream &&
      cudaStreamCreateWithFlags(&t.stream, cudaStreamNonBlocking) !=
          cudaSuccess) {
    t.stream = nullptr;
    return false;
  }
  if (!t.state &&
      nvjpegJpegStateCreate(handle, &t.state) != NVJPEG_STATUS_SUCCESS) {
    t.state = nullptr;
    return false;
  }
  int ncomp = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(handle, data, len, &ncomp, &subsampling, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return false;
  Planes pl;
  pl.w = widths[0];
  pl.h = heights[0];
  const bool grey = subsampling == NVJPEG_CSS_GRAY;
  const bool ycc = ncomp == 3 && (subsampling == NVJPEG_CSS_444 ||
                                  subsampling == NVJPEG_CSS_422 ||
                                  subsampling == NVJPEG_CSS_420);
  pl.ncomp = !planes ? 0 : (grey ? 1 : (ycc ? 3 : 0));
  size_t sizes[3] = {0, 0, 0}, need = 0;
  if (pl.ncomp) {
    for (int c = 0; c < pl.ncomp; ++c) {
      pl.pw[c] = widths[c];
      pl.ph[c] = heights[c];
      sizes[c] = size_t(widths[c]) * heights[c];
      need += sizes[c];
    }
  } else {
    need = size_t(pl.w) * pl.h * 3;
  }
  if (need > t.cap) {
    if (t.dev) cudaFree(t.dev);
    t.dev = nullptr;
    t.cap = 0;
    if (cudaMalloc(&t.dev, need) != cudaSuccess) {
      t.dev = nullptr;
      return false;
    }
    t.cap = need;
  }
  nvjpegImage_t out;
  std::memset(&out, 0, sizeof(out));
  nvjpegOutputFormat_t format = NVJPEG_OUTPUT_RGBI;
  if (pl.ncomp) {
    size_t offset = 0;
    for (int c = 0; c < pl.ncomp; ++c) {
      out.channel[c] = t.dev + offset;
      out.pitch[c] = size_t(pl.pw[c]);
      offset += sizes[c];
    }
    format = grey ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
  } else {
    out.channel[0] = t.dev;
    out.pitch[0] = size_t(pl.w) * 3;
  }
  if (nvjpegDecode(handle, t.state, data, len, format, &out, t.stream) !=
      NVJPEG_STATUS_SUCCESS)
    return false;
  std::vector<unsigned char> host(need);
  if (cudaMemcpyAsync(host.data(), t.dev, need, cudaMemcpyDeviceToHost,
                      t.stream) != cudaSuccess ||
      cudaStreamSynchronize(t.stream) != cudaSuccess)
    return false;
  if (!pl.ncomp) {
    img->w = pl.w;
    img->h = pl.h;
    img->rgb = std::move(host);
    return true;
  }
  size_t offset = 0;
  for (int c = 0; c < pl.ncomp; ++c) {
    pl.p[c].assign(host.begin() + offset, host.begin() + offset + sizes[c]);
    offset += sizes[c];
  }
  return planes_to_rgb(pl, img);
}

bool decode_jpeg(const unsigned char* data, size_t len, Image* img) {
  return decode_jpeg_nvjpeg(data, len, img, true) ||
         decode_jpeg_nvjpeg(data, len, img, false);
}

const char* kJpegDecoder = "nvjpeg";

#endif

// ---------- PNG ----------

inline uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters of one (sub)image of `rows` rows, in place; each row
// is a filter byte then `rowbytes` bytes.
bool unfilter(unsigned char* data, int rows, size_t rowbytes, int bpp) {
  std::vector<unsigned char> zero(rowbytes, 0);
  const unsigned char* prev = zero.data();
  for (int y = 0; y < rows; ++y) {
    unsigned char* row = data + size_t(y) * (rowbytes + 1);
    unsigned char* cur = row + 1;
    switch (row[0]) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < rowbytes; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) cur[i] += prev[i];
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i)
          cur[i] += (int(i >= size_t(bpp) ? cur[i - bpp] : 0) + prev[i]) >> 1;
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
          cur[i] += paeth(a, prev[i], c);
        }
        break;
      default:
        return false;
    }
    prev = cur;
  }
  return true;
}

bool decode_png(const unsigned char* data, size_t len, Image* img) {
  static const unsigned char kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || std::memcmp(data, kSig, 8) != 0) return false;
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = -1, interlace = 0;
  std::vector<unsigned char> idat, plte;
  for (size_t pos = 8; pos + 12 <= len;) {
    const uint32_t n = be32(data + pos);
    if (n > len - pos - 12) return false;
    const unsigned char* type = data + pos + 4;
    const unsigned char* body = data + pos + 8;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (n < 13 || body[10] != 0 || body[11] != 0) return false;
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
    } else if (!std::memcmp(type, "PLTE", 4)) {
      plte.assign(body, body + n);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + n);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + size_t(n);
  }
  int channels;
  switch (ctype) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return false;
  }
  const bool low = depth == 1 || depth == 2 || depth == 4;
  if (!(depth == 8 || depth == 16 || (low && (ctype == 0 || ctype == 3))) ||
      interlace > 1 || w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24) ||
      (ctype == 3 && plte.empty()))
    return false;
  const int bits = channels * depth;
  const int bpp = std::max(1, bits / 8);

  // (x0, y0, dx, dy) of each pass: the whole image, or Adam7's seven
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                   {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                   {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kAdam7 : kWhole;
  const int num_passes = interlace ? 7 : 1;
  size_t raw_size = 0;
  for (int p = 0; p < num_passes; ++p) {
    size_t pw = (w - passes[p][0] + passes[p][2] - 1) / passes[p][2];
    size_t ph = (h - passes[p][1] + passes[p][3] - 1) / passes[p][3];
    if (passes[p][0] >= int(w)) pw = 0;
    if (passes[p][1] >= int(h)) ph = 0;
    if (pw && ph) raw_size += ph * (1 + (pw * bits + 7) / 8);
  }
  std::vector<unsigned char> raw(raw_size);
  uLongf got = raw_size;
  if (uncompress(raw.data(), &got, idat.data(), idat.size()) != Z_OK ||
      got != raw_size)
    return false;

  img->w = int(w);
  img->h = int(h);
  img->rgb.assign(size_t(w) * h * 3, 0);
  const int maxv = (1 << depth) - 1;
  unsigned char* pass_data = raw.data();
  for (int p = 0; p < num_passes; ++p) {
    const int x0 = passes[p][0], y0 = passes[p][1];
    const int dx = passes[p][2], dy = passes[p][3];
    if (x0 >= int(w) || y0 >= int(h)) continue;
    const int pw = (int(w) - x0 + dx - 1) / dx;
    const int ph = (int(h) - y0 + dy - 1) / dy;
    const size_t rowbytes = (size_t(pw) * bits + 7) / 8;
    if (!unfilter(pass_data, ph, rowbytes, bpp)) return false;
    for (int py = 0; py < ph; ++py) {
      const unsigned char* cur = pass_data + size_t(py) * (rowbytes + 1) + 1;
      const size_t y = size_t(y0) + size_t(py) * dy;
      for (int px = 0; px < pw; ++px) {
        // 8-bit samples: the high byte of a 16-bit one (png_set_strip_16)
        auto sample = [&](int ci) -> int {
          if (depth == 8) return cur[size_t(px) * channels + ci];
          if (depth == 16) return cur[(size_t(px) * channels + ci) * 2];
          const size_t bit = size_t(px) * depth;
          return (cur[bit >> 3] >> (8 - depth - int(bit & 7))) & maxv;
        };
        unsigned char* o =
            &img->rgb[(y * w + size_t(x0) + size_t(px) * dx) * 3];
        if (ctype == 3) {
          const size_t idx = size_t(sample(0)) * 3;
          if (idx + 2 < plte.size()) {
            o[0] = plte[idx];
            o[1] = plte[idx + 1];
            o[2] = plte[idx + 2];
          }
        } else if (ctype == 0 || ctype == 4) {
          int g = sample(0);
          if (low) g = g * 255 / maxv;  // png_set_expand's scaling
          o[0] = o[1] = o[2] = (unsigned char)g;
        } else {  // 2, 6: RGB, alpha dropped
          o[0] = (unsigned char)sample(0);
          o[1] = (unsigned char)sample(1);
          o[2] = (unsigned char)sample(2);
        }
      }
    }
    pass_data += size_t(ph) * (rowbytes + 1);
  }
  return true;
}

bool decode_file(const char* path, Image* img) {
  std::vector<unsigned char> buf;
  if (!read_file(path, &buf) || buf.size() < 2) return false;
  bool ok = false;
  if (buf[0] == 0xFF && buf[1] == 0xD8) {
    ok = decode_jpeg(buf.data(), buf.size(), img);
  } else if (buf[0] == 0x89 && buf[1] == 'P') {
    ok = decode_png(buf.data(), buf.size(), img);
  }
  return ok && img->w > 0 && img->h > 0;
}

// ---------- crop + bilinear resize to float32 ----------

void crop_resize_to_float(const Image& img, int ct, int cl, int cb, int cr,
                          int th, int tw, float* out) {
  if (cb <= ct || cr <= cl) {  // no/invalid crop -> whole image
    ct = 0; cl = 0; cb = img.h; cr = img.w;
  }
  const float sy = float(cb - ct) / th;
  const float sx = float(cr - cl) / tw;
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < th; ++y) {
    // align_corners=false pixel centers
    float fy = ct + (y + 0.5f) * sy - 0.5f;
    int y0 = int(fy >= 0 ? fy : fy - 1);  // floor
    float wy = fy - y0;
    int y0c = clampi(y0, 0, img.h - 1), y1c = clampi(y0 + 1, 0, img.h - 1);
    for (int x = 0; x < tw; ++x) {
      float fx = cl + (x + 0.5f) * sx - 0.5f;
      int x0 = int(fx >= 0 ? fx : fx - 1);
      float wx = fx - x0;
      int x0c = clampi(x0, 0, img.w - 1), x1c = clampi(x0 + 1, 0, img.w - 1);
      const unsigned char* p00 = &img.rgb[(size_t(y0c) * img.w + x0c) * 3];
      const unsigned char* p01 = &img.rgb[(size_t(y0c) * img.w + x1c) * 3];
      const unsigned char* p10 = &img.rgb[(size_t(y1c) * img.w + x0c) * 3];
      const unsigned char* p11 = &img.rgb[(size_t(y1c) * img.w + x1c) * 3];
      float* o = out + (size_t(y) * tw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        o[c] = (top * (1 - wy) + bot * wy) * inv255;
      }
    }
  }
}

// ---------- blur-faded padded crop (dataset-parity path) ----------
//
// Port of data/common/crop.py crop_with_padding + the dataset's
// integer-bbox math and resize choice
// (voxceleb2_segmentation_nolandmarks.py:111-125,191-204): reflect101
// padding, Gaussian blur-fade toward pad borders (sigma = 0.016*H, cv2
// kernel formula), fade to the per-channel median, INTER_AREA / INTER_CUBIC
// resize; for a segmentation mask replicate/zero padding, the fade to 0 on
// the side pads and cv2's INTER_LINEAR.

inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

// round-half-to-even, like np.rint / cvRound
inline float rint_f(float v) { return std::nearbyintf(v); }

// cv2's Gaussian kernel for 8-bit input: ksize = cvRound(sigma*3*2 + 1) | 1
std::vector<float> gaussian_kernel(float sigma) {
  int ksize = int(rint_f(sigma * 6.0f + 1.0f)) | 1;
  if (ksize < 1) ksize = 1;
  int c = ksize / 2;
  std::vector<float> kern(ksize);
  double sum = 0.0;
  for (int i = 0; i < ksize; ++i) {
    double d = i - c;
    kern[i] = float(std::exp(-d * d / (2.0 * sigma * sigma)));
    sum += kern[i];
  }
  for (int i = 0; i < ksize; ++i) kern[i] = float(kern[i] / sum);
  return kern;
}

// separable Gaussian blur of an h x w x C float image, reflect101 borders
// (cv2 BORDER_DEFAULT)
template <int C>
void gaussian_blur_f32(std::vector<float>& img, int h, int w, float sigma) {
  const std::vector<float> kern = gaussian_kernel(sigma);
  const int ksize = int(kern.size()), c = ksize / 2;
  std::vector<float> tmp(img.size());
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float acc[C] = {};
      for (int k = 0; k < ksize; ++k) {
        const float* p = &img[(size_t(y) * w + reflect101(x + k - c, w)) * C];
        for (int ch = 0; ch < C; ++ch) acc[ch] += kern[k] * p[ch];
      }
      for (int ch = 0; ch < C; ++ch) tmp[(size_t(y) * w + x) * C + ch] = acc[ch];
    }
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float acc[C] = {};
      for (int k = 0; k < ksize; ++k) {
        const float* p = &tmp[(size_t(reflect101(y + k - c, h)) * w + x) * C];
        for (int ch = 0; ch < C; ++ch) acc[ch] += kern[k] * p[ch];
      }
      for (int ch = 0; ch < C; ++ch) img[(size_t(y) * w + x) * C + ch] = acc[ch];
    }
  }
}

float channel_median(const std::vector<float>& img, int n_pixels, int ch) {
  std::vector<float> vals(n_pixels);
  for (int i = 0; i < n_pixels; ++i) vals[i] = img[size_t(i) * 3 + ch];
  size_t mid = vals.size() / 2;
  std::nth_element(vals.begin(), vals.begin() + mid, vals.end());
  float hi = vals[mid];
  if (vals.size() % 2 == 1) return hi;
  float lo = *std::max_element(vals.begin(), vals.begin() + mid);
  return 0.5f * (lo + hi);  // np.median: mean of the two middles
}

// The pad geometry of a crop [t, b) x [l, r) of an H x W image.
struct Pads {
  int t_in, b_in, l_in, r_in;  // the crop's part inside the image
  int pt, pb, pl, pr;          // pad widths
  bool any() const { return pt || pb || pl || pr; }
};

Pads pads_of(int H, int W, int t, int l, int b, int r) {
  Pads p;
  p.t_in = t > 0 ? t : 0;
  p.b_in = b < H ? b : H;
  p.l_in = l > 0 ? l : 0;
  p.r_in = r < W ? r : W;
  p.pt = p.t_in - t;
  p.pb = b - p.b_in;
  p.pl = p.l_in - l;
  p.pr = r - p.r_in;
  return p;
}

// crop.py _edge_distance_mask at (y, x): (mask, horizontal mask), 1 at the
// outer pad edge, 0 at the image border, negative inside
inline void edge_masks(const Pads& p, int h, int w, int y, int x, float* mask,
                       float* horiz) {
  const float inf = 1e30f;
  float near_t = p.pt ? float(y) / p.pt : inf;
  float near_b = p.pb ? float(h - 1 - y) / p.pb : inf;
  float near_l = p.pl ? float(x) / p.pl : inf;
  float near_r = p.pr ? float(w - 1 - x) / p.pr : inf;
  float vert = 1.0f - (near_t < near_b ? near_t : near_b);
  *horiz = 1.0f - (near_l < near_r ? near_l : near_r);
  *mask = *horiz > vert ? *horiz : vert;
}

inline float clip01(float v) { return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v); }

// crop image[t:b, l:r] (out-of-bounds allowed) -> u8 buffer (b-t, r-l, 3)
void crop_padded_u8(const Image& img, int off_y, int off_x, int H, int W,
                    int t, int l, int b, int r,
                    std::vector<unsigned char>* out_u8) {
  const int h = b - t, w = r - l;
  const Pads p = pads_of(H, W, t, l, b, r);
  const int ch = p.b_in - p.t_in, cw = p.r_in - p.l_in;  // interior dims

  out_u8->assign(size_t(h) * w * 3, 0);
  for (int y = 0; y < h; ++y) {
    int ys = reflect101(y - p.pt, ch) + p.t_in + off_y;
    for (int x = 0; x < w; ++x) {
      int xs = reflect101(x - p.pl, cw) + p.l_in + off_x;
      const unsigned char* src = &img.rgb[(size_t(ys) * img.w + xs) * 3];
      unsigned char* o = &(*out_u8)[(size_t(y) * w + x) * 3];
      o[0] = src[0]; o[1] = src[1]; o[2] = src[2];
    }
  }
  if (!p.any()) return;

  std::vector<float> out_f(size_t(h) * w * 3);
  for (size_t i = 0; i < out_f.size(); ++i)
    out_f[i] = (*out_u8)[i] * (1.0f / 255.0f);
  std::vector<float> blur_f = out_f;
  gaussian_blur_f32<3>(blur_f, h, w, h * 0.016f);

  float med[3] = {channel_median(out_f, h * w, 0),
                  channel_median(out_f, h * w, 1),
                  channel_median(out_f, h * w, 2)};
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float mask, horiz;
      edge_masks(p, h, w, y, x, &mask, &horiz);
      float wblur = clip01(mask * 3.0f + 1.0f);
      float wfade = clip01(mask);
      float* o = &out_f[(size_t(y) * w + x) * 3];
      const float* bl = &blur_f[(size_t(y) * w + x) * 3];
      for (int cidx = 0; cidx < 3; ++cidx) {
        float v = o[cidx] + (bl[cidx] - o[cidx]) * wblur;
        v = v + (med[cidx] - v) * wfade;
        v = rint_f(v * 255.0f);
        (*out_u8)[(size_t(y) * w + x) * 3 + cidx] =
            (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

// cv2 INTER_AREA downscale (exact fractional box average), f32 math
void resize_area(const std::vector<unsigned char>& src, int sh, int sw,
                 int th, int tw, float* out) {
  const double sy = double(sh) / th, sx = double(sw) / tw;
  for (int y = 0; y < th; ++y) {
    double fy0 = y * sy, fy1 = (y + 1) * sy;
    int iy0 = int(fy0), iy1 = int(std::ceil(fy1));
    if (iy1 > sh) iy1 = sh;
    for (int x = 0; x < tw; ++x) {
      double fx0 = x * sx, fx1 = (x + 1) * sx;
      int ix0 = int(fx0), ix1 = int(std::ceil(fx1));
      if (ix1 > sw) ix1 = sw;
      double acc[3] = {0, 0, 0}, warea = 0;
      for (int yy = iy0; yy < iy1; ++yy) {
        double wy = 1.0;
        if (yy < fy0) wy -= fy0 - yy;
        if (yy + 1 > fy1) wy -= yy + 1 - fy1;
        for (int xx = ix0; xx < ix1; ++xx) {
          double wx = 1.0;
          if (xx < fx0) wx -= fx0 - xx;
          if (xx + 1 > fx1) wx -= xx + 1 - fx1;
          double wgt = wy * wx;
          const unsigned char* p = &src[(size_t(yy) * sw + xx) * 3];
          acc[0] += wgt * p[0];
          acc[1] += wgt * p[1];
          acc[2] += wgt * p[2];
          warea += wgt;
        }
      }
      float* o = out + (size_t(y) * tw + x) * 3;
      for (int cidx = 0; cidx < 3; ++cidx)
        o[cidx] = float(acc[cidx] / warea) * (1.0f / 255.0f);
    }
  }
}

inline float cubic_w(float d) {  // cv2 bicubic, a = -0.75
  const float a = -0.75f;
  d = d < 0 ? -d : d;
  if (d <= 1.0f) return ((a + 2.0f) * d - (a + 3.0f)) * d * d + 1.0f;
  if (d < 2.0f) return ((a * d - 5.0f * a) * d + 8.0f * a) * d - 4.0f * a;
  return 0.0f;
}

void resize_cubic(const std::vector<unsigned char>& src, int sh, int sw,
                  int th, int tw, float* out) {
  const float sy = float(sh) / th, sx = float(sw) / tw;
  for (int y = 0; y < th; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(std::floor(fy));
    float dy = fy - y0;
    for (int x = 0; x < tw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = int(std::floor(fx));
      float dx = fx - x0;
      float acc[3] = {0, 0, 0};
      for (int ky = -1; ky <= 2; ++ky) {
        int ys = clampi(y0 + ky, 0, sh - 1);
        float wy = cubic_w(ky - dy);
        for (int kx = -1; kx <= 2; ++kx) {
          int xs = clampi(x0 + kx, 0, sw - 1);
          float wgt = wy * cubic_w(kx - dx);
          const unsigned char* p = &src[(size_t(ys) * sw + xs) * 3];
          acc[0] += wgt * p[0];
          acc[1] += wgt * p[1];
          acc[2] += wgt * p[2];
        }
      }
      float* o = out + (size_t(y) * tw + x) * 3;
      for (int cidx = 0; cidx < 3; ++cidx) {
        float v = acc[cidx] * (1.0f / 255.0f);
        o[cidx] = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
      }
    }
  }
}

// The dataset's integer crop box (crop.py bbox_to_integer_coords: all four
// coords scaled by the FULL image height — before the border strip;
// VoxCeleb2.1 frames are square, reproduced as-is — floor/ceil, re-squared,
// +1), shifted by -off for the 1px strip
// (voxceleb2_segmentation_nolandmarks.py:115-119).  bbox: (l, t, r, b).
void integer_box(const double* bbox, int img_h, int off, int* t, int* l,
                 int* b, int* r) {
  *t = int(std::floor(bbox[1] * img_h)) - off;
  *l = int(std::floor(bbox[0] * img_h)) - off;
  *r = int(std::ceil(bbox[2] * img_h)) - off;
  *b = int(std::ceil(bbox[3] * img_h)) - off;
  *b += (*r - *l) - (*b - *t);
  *b += 1;
  *r += 1;
}

// Decoded image -> dataset crop -> out_size^2 x 3 floats in [0, 1].
void crop_image(const Image& img, const double* bbox, bool has_bbox,
                int out_size, float* dst) {
  const int off = has_bbox ? 1 : 0;
  int t, l, b, r;
  integer_box(bbox, img.h, off, &t, &l, &b, &r);
  std::vector<unsigned char> cropped;
  crop_padded_u8(img, off, off, img.h - 2 * off, img.w - 2 * off, t, l, b, r,
                 &cropped);
  const int ch = b - t, cw = r - l;
  if (out_size > ch)
    resize_cubic(cropped, ch, cw, out_size, out_size, dst);
  else
    resize_area(cropped, ch, cw, out_size, out_size, dst);
}

// ---------- segmentation mask ----------

// cv2.resize(INTER_LINEAR) of an 8-bit single-channel image in cv2's fixed
// point: 11-bit coefficients, the horizontal pass in ints, the vertical one
// as its SIMD path computes it ((b0*(S0>>4))>>16 + (b1*(S1>>4))>>16 + 2)>>2.
// The output is u8 / 255.
void resize_linear_u8(const std::vector<unsigned char>& src, int sh, int sw,
                      int th, int tw, float* out) {
  const int kScale = 1 << 11;
  auto coefs = [&](int n_dst, int n_src, std::vector<int>* ofs,
                   std::vector<int>* alpha, bool clamp_tail) {
    const double scale = double(n_src) / n_dst;
    ofs->resize(n_dst);
    alpha->resize(2 * size_t(n_dst));
    for (int d = 0; d < n_dst; ++d) {
      float f = float((d + 0.5) * scale - 0.5);
      int s = int(std::floor(f));
      f -= s;
      if (s < 0) {
        f = 0.0f;
        s = 0;
      }
      if (clamp_tail && s >= n_src - 1) {
        f = 0.0f;
        s = n_src - 1;
      }
      (*ofs)[d] = s;
      (*alpha)[2 * d] = int(std::lrint((1.0f - f) * kScale));
      (*alpha)[2 * d + 1] = int(std::lrint(f * kScale));
    }
  };
  std::vector<int> xofs, xalpha, yofs, yalpha;
  coefs(tw, sw, &xofs, &xalpha, true);
  coefs(th, sh, &yofs, &yalpha, false);
  std::vector<int> rows(size_t(sh) * tw);  // horizontal pass of every row
  for (int y = 0; y < sh; ++y) {
    const unsigned char* s = &src[size_t(y) * sw];
    for (int x = 0; x < tw; ++x) {
      int sx = xofs[x];
      int sx1 = sx + 1 < sw ? sx + 1 : sx;
      rows[size_t(y) * tw + x] =
          s[sx] * xalpha[2 * x] + s[sx1] * xalpha[2 * x + 1];
    }
  }
  for (int y = 0; y < th; ++y) {
    const int* s0 = &rows[size_t(clampi(yofs[y], 0, sh - 1)) * tw];
    const int* s1 = &rows[size_t(clampi(yofs[y] + 1, 0, sh - 1)) * tw];
    const int b0 = yalpha[2 * y], b1 = yalpha[2 * y + 1];
    for (int x = 0; x < tw; ++x) {
      int v = ((b0 * (s0[x] >> 4)) >> 16) + ((b1 * (s1[x] >> 4)) >> 16);
      v = (v + 2) >> 2;
      out[size_t(y) * tw + x] = float(clampi(v, 0, 255)) * (1.0f / 255.0f);
    }
  }
}

// crop.py crop_with_padding(segmentation=True) of an H0 x W0 mask, then
// cv2.resize to out_size^2: replicate on the sides and bottom, zeros on top;
// the blurred pads (blur rounded to u8, as cv2.GaussianBlur returns it)
// faded to 0 along the side pads only.
void crop_segm(const unsigned char* src, int H0, int W0, const double* bbox,
               bool has_bbox, int out_size, float* dst) {
  const int off = has_bbox ? 1 : 0;
  const int H = H0 - 2 * off, W = W0 - 2 * off;
  int t, l, b, r;
  integer_box(bbox, H0, off, &t, &l, &b, &r);
  const int h = b - t, w = r - l;
  const Pads p = pads_of(H, W, t, l, b, r);
  const int ch = p.b_in - p.t_in, cw = p.r_in - p.l_in;
  std::vector<unsigned char> out(size_t(h) * w, 0);
  for (int y = p.pt; y < h; ++y) {
    const int ys = std::min(y - p.pt, ch - 1) + p.t_in + off;
    for (int x = 0; x < w; ++x) {
      const int xs = clampi(x - p.pl, 0, cw - 1) + p.l_in + off;
      out[size_t(y) * w + x] = src[size_t(ys) * W0 + xs];
    }
  }
  if (p.any()) {
    std::vector<float> blur(out.begin(), out.end());
    gaussian_blur_f32<1>(blur, h, w, h * 0.016f);
    for (size_t i = 0; i < out.size(); ++i) {
      const int y = int(i / w), x = int(i % w);
      float mask, horiz;
      edge_masks(p, h, w, y, x, &mask, &horiz);
      float v = out[i] * (1.0f / 255.0f);
      const float bl = clampi(int(rint_f(blur[i])), 0, 255) * (1.0f / 255.0f);
      v += (bl - v) * clip01(mask * 3.0f + 1.0f);
      v += (0.0f - v) * clip01(horiz);
      v = rint_f(v * 255.0f);
      out[i] = (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  resize_linear_u8(out, h, w, out_size, out_size, dst);
}

// The wire's quantization of values in [0, 1]: uint8(v * 255 + 0.5), in
// f32 and clamped, as native/lpr_loader.cpp's lpr_load_cropped_batch_u8.
void quantize_u8(const float* src, size_t n, unsigned char* dst) {
  for (size_t j = 0; j < n; ++j) {
    const float v = src[j] * 255.0f + 0.5f;
    dst[j] = (unsigned char)(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
  }
}

// ---------- thread pool ----------

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { Run(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
      }
      job();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

// Run load(i) for i in [0, n) on the pool and wait; load returns false for
// an image that failed.  Returns the number of failures.
int run_batch(void* pool_ptr, int n, const std::function<bool(int)>& load) {
  Pool* pool = static_cast<Pool*>(pool_ptr);
  std::atomic<int> failures{0};
  std::atomic<int> remaining{n};
  std::mutex done_mu;
  std::condition_variable done_cv;
  for (int i = 0; i < n; ++i) {
    pool->Submit([&, i] {
      if (!load(i)) failures.fetch_add(1);
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return failures.load();
}

}  // namespace

extern "C" {

void* lpr_create(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  return new Pool(num_threads);
}

void lpr_destroy(void* pool) { delete static_cast<Pool*>(pool); }

const char* lpr_jpeg_decoder() { return kJpegDecoder; }

int lpr_load_batch(void* pool, const char** paths, int n, const int* crops,
                   int target_h, int target_w, float* out) {
  const size_t stride = size_t(target_h) * target_w * 3;
  return run_batch(pool, n, [&](int i) {
    Image img;
    float* dst = out + stride * i;
    if (!decode_file(paths[i], &img)) {
      std::memset(dst, 0, stride * sizeof(float));
      return false;
    }
    int ct = 0, cl = 0, cb = 0, cr = 0;
    if (crops) {
      ct = crops[i * 4 + 0];
      cl = crops[i * 4 + 1];
      cb = crops[i * 4 + 2];
      cr = crops[i * 4 + 3];
    }
    crop_resize_to_float(img, ct, cl, cb, cr, target_h, target_w, dst);
    return true;
  });
}

// Dataset-parity loader: decode -> (optional 1px VoxCeleb2.1 border strip)
// -> integer crop box -> blur-faded reflect101-padded crop -> INTER_AREA /
// INTER_CUBIC resize.  bboxes: n*4 (l, t, r, b) in [0,1] doubles (floor/ceil
// boundaries are precision-sensitive); has_bbox: n flags (0 -> identity
// box, no border strip).  out: n * out_size^2 * 3 float RGB in [0, 1].
int lpr_load_cropped_batch(void* pool, const char** paths, int n,
                           const double* bboxes,
                           const unsigned char* has_bbox, int out_size,
                           float* out) {
  const size_t stride = size_t(out_size) * out_size * 3;
  return run_batch(pool, n, [&](int i) {
    Image img;
    float* dst = out + stride * i;
    if (!decode_file(paths[i], &img)) {
      std::memset(dst, 0, stride * sizeof(float));
      return false;
    }
    crop_image(img, bboxes + 4 * i, has_bbox[i] != 0, out_size, dst);
    return true;
  });
}

// Segmentation masks: decode -> channel 1 (G) -> the mask's crop and
// INTER_LINEAR resize (crop_segm).  out: n * out_size^2 floats in [0, 1].
int lpr_load_segm_batch(void* pool, const char** paths, int n,
                        const double* bboxes, const unsigned char* has_bbox,
                        int out_size, float* out) {
  const size_t stride = size_t(out_size) * out_size;
  return run_batch(pool, n, [&](int i) {
    Image img;
    float* dst = out + stride * i;
    if (!decode_file(paths[i], &img)) {
      std::memset(dst, 0, stride * sizeof(float));
      return false;
    }
    std::vector<unsigned char> green(size_t(img.w) * img.h);
    for (size_t j = 0; j < green.size(); ++j) green[j] = img.rgb[j * 3 + 1];
    crop_segm(green.data(), img.h, img.w, bboxes + 4 * i, has_bbox[i] != 0,
              out_size, dst);
    return true;
  });
}

// The same crop of a mask given as an h x w uint8 array (the `.png.npy`
// masks).  out: out_size^2 floats in [0, 1].
int lpr_crop_segm(const unsigned char* mask, int h, int w, const double* bbox,
                  int has_bbox, int out_size, float* out) {
  crop_segm(mask, h, w, bbox, has_bbox != 0, out_size, out);
  return 0;
}

// The uint8 wire (--transfer_dtype uint8): each entry runs its float
// entry's pipeline on the loader thread and writes uint8(v * 255 + 0.5),
// clamped to [0, 255] (latentpose_tpu/runners/loop.py quantize_batch_u8),
// so a batch crosses to the device as bytes with no pass on the host.
int lpr_load_cropped_batch_u8(void* pool, const char** paths, int n,
                              const double* bboxes,
                              const unsigned char* has_bbox, int out_size,
                              unsigned char* out) {
  const size_t stride = size_t(out_size) * out_size * 3;
  return run_batch(pool, n, [&](int i) {
    Image img;
    unsigned char* dst = out + stride * i;
    if (!decode_file(paths[i], &img)) {
      std::memset(dst, 0, stride);
      return false;
    }
    std::vector<float> tmp(stride);
    crop_image(img, bboxes + 4 * i, has_bbox[i] != 0, out_size, tmp.data());
    quantize_u8(tmp.data(), stride, dst);
    return true;
  });
}

int lpr_load_segm_batch_u8(void* pool, const char** paths, int n,
                           const double* bboxes, const unsigned char* has_bbox,
                           int out_size, unsigned char* out) {
  const size_t stride = size_t(out_size) * out_size;
  return run_batch(pool, n, [&](int i) {
    Image img;
    unsigned char* dst = out + stride * i;
    if (!decode_file(paths[i], &img)) {
      std::memset(dst, 0, stride);
      return false;
    }
    std::vector<unsigned char> green(size_t(img.w) * img.h);
    for (size_t j = 0; j < green.size(); ++j) green[j] = img.rgb[j * 3 + 1];
    std::vector<float> tmp(stride);
    crop_segm(green.data(), img.h, img.w, bboxes + 4 * i, has_bbox[i] != 0,
              out_size, tmp.data());
    quantize_u8(tmp.data(), stride, dst);
    return true;
  });
}

int lpr_crop_segm_u8(const unsigned char* mask, int h, int w,
                     const double* bbox, int has_bbox, int out_size,
                     unsigned char* out) {
  std::vector<float> tmp(size_t(out_size) * out_size);
  crop_segm(mask, h, w, bbox, has_bbox != 0, out_size, tmp.data());
  quantize_u8(tmp.data(), tmp.size(), out);
  return 0;
}

// Frames in memory (n x h x w x 3 uint8 RGB): each one's integer box
// [t, b) x [l, r) (out-of-bounds allowed) through the blur-faded reflect101
// padded crop, then INTER_CUBIC (cubic[i] != 0) or INTER_AREA to
// out_size^2, rounded to uint8 as cv2.resize rounds (half to even).  The
// face cropper's and drive --crop's path (latentpose_tpu/preprocess/
// croppers.py, latentpose_tpu/cli/drive.py inline_crop_frames).
int lpr_crop_boxes_u8(void* pool, const unsigned char* imgs, int n, int h,
                      int w, const int* boxes, const unsigned char* cubic,
                      int out_size, unsigned char* out) {
  const size_t in_stride = size_t(h) * w * 3;
  const size_t stride = size_t(out_size) * out_size * 3;
  return run_batch(pool, n, [&](int i) {
    Image img;
    img.h = h;
    img.w = w;
    img.rgb.assign(imgs + in_stride * i, imgs + in_stride * (i + 1));
    const int* box = boxes + 4 * i;
    const int t = box[0], l = box[1], b = box[2], r = box[3];
    unsigned char* dst = out + stride * i;
    if (b <= t || r <= l) {
      std::memset(dst, 0, stride);
      return false;
    }
    std::vector<unsigned char> cropped;
    crop_padded_u8(img, 0, 0, h, w, t, l, b, r, &cropped);
    std::vector<float> tmp(stride);
    if (cubic[i])
      resize_cubic(cropped, b - t, r - l, out_size, out_size, tmp.data());
    else
      resize_area(cropped, b - t, r - l, out_size, out_size, tmp.data());
    for (size_t j = 0; j < stride; ++j) {
      const float v = rint_f(tmp[j] * 255.0f);
      dst[j] = (unsigned char)(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
    }
    return true;
  });
}

// One image at its own size: its h and w, and (when `out` holds cap >=
// h*w*3 bytes) its RGB bytes.  Returns 0, or -1 if it does not decode.
int lpr_decode(const char* path, unsigned char* out, size_t cap, int* h,
               int* w) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  *h = img.h;
  *w = img.w;
  if (out && cap >= img.rgb.size())
    std::memcpy(out, img.rgb.data(), img.rgb.size());
  return 0;
}

}  // extern "C"
