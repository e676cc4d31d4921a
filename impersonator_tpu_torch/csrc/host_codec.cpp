// Image codec of impersonator_tpu_torch: JPEG / PNG decode, bilinear
// resize to S x S (float [-1, 1] or uint8), an order-keeping threaded
// prefetch ring, and a JPEG encoder (quality q, 4:2:0 chroma).
//
// Port of csrc/dataloader.cpp (the JAX package's native loader), plus the
// encoder and PNG reader that cv2.imencode / cv2.imread gave the JAX
// CLIs. One source, two builds, chosen by the caller's device type
// (impersonator_tpu_torch/data/native.py):
//   -DCODEC_LIBJPEG  libjpeg decode and encode on the host (device "cpu");
//   -DCODEC_NVJPEG   nvJPEG decode and encode on the card (device "cuda"):
//                    the card decodes the Y / Cb / Cr planes; they come
//                    back to the host for libjpeg's chroma upsampling and
//                    colour conversion (below) and the resize, so both
//                    builds share all arithmetic but the IDCT.
// PNG is decoded here with zlib (inflate + the five row filters) in both
// builds; it needs no libpng.
//
// C ABI (bound with ctypes; every call releases the GIL):
//   int   codec_init(int device)              // nvJPEG: the card's ordinal
//   const char* codec_last_error()            // this thread's last error
//   int   codec_image_info(buf, len, int* w, int* h)
//   int   codec_decode(buf, len, uint8_t* out)                // w*h*3 RGB
//   void  codec_resize_u8(img, w, h, s, uint8_t* out)
//   int   codec_decode_resize_u8(path, s, uint8_t* out)
//   int   codec_decode_resize(path, s, float* out)
//   void* loader_create(threads, capacity, image_size, int u8)
//   int   loader_submit(void*, path, long tag)
//   int   loader_next(void*, float* out, long* tag)      // blocking, FIFO
//   int   loader_next_u8(void*, uint8_t* out, long* tag)
//   void  loader_destroy(void*)
//   long  codec_encode_jpeg(rgb, w, h, quality, stream, uint8_t** out)
//         (libjpeg: rgb in host memory; nvJPEG: rgb in device memory,
//          encoded on the given CUDA stream)
//   void  codec_free(uint8_t*)

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#if defined(CODEC_LIBJPEG)
#include <csetjmp>
#include <jpeglib.h>
#elif defined(CODEC_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#error "build with -DCODEC_LIBJPEG or -DCODEC_NVJPEG"
#endif

namespace {

thread_local std::string g_err;

bool fail(const std::string& msg) {
  g_err = msg;
  return false;
}

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> data;  // HWC, RGB
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return fail(std::string("cannot open ") + path);
  fseek(fp, 0, SEEK_END);
  long n = ftell(fp);
  rewind(fp);
  out->resize(n > 0 ? size_t(n) : 0);
  size_t got = n > 0 ? fread(out->data(), 1, size_t(n), fp) : 0;
  fclose(fp);
  if (n <= 0 || got != size_t(n)) return fail(std::string("cannot read ") + path);
  return true;
}

// ---------------------------------------------------------------------------
// PNG (zlib)
// ---------------------------------------------------------------------------

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngHeader {
  int w = 0, h = 0, depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat, palette;
};

bool png_parse(const uint8_t* buf, size_t len, PngHeader* hd, bool want_data) {
  if (len < 8 || memcmp(buf, kPngSig, 8)) return fail("not a PNG");
  size_t pos = 8;
  bool seen_ihdr = false;
  while (pos + 12 <= len) {
    uint32_t n = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (n > len - pos - 12) return fail("truncated PNG chunk");
    if (!memcmp(type, "IHDR", 4)) {
      if (n < 13) return fail("bad PNG IHDR");
      hd->w = int(be32(data));
      hd->h = int(be32(data + 4));
      hd->depth = data[8];
      hd->color = data[9];
      hd->interlace = data[12];
      seen_ihdr = true;
      if (!want_data) return true;
    } else if (!memcmp(type, "PLTE", 4)) {
      hd->palette.assign(data, data + n);
    } else if (!memcmp(type, "IDAT", 4)) {
      hd->idat.insert(hd->idat.end(), data, data + n);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + size_t(n);
  }
  if (!seen_ihdr) return fail("PNG without IHDR");
  return true;
}

int png_channels(int color) {
  switch (color) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
  }
  return 0;
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

// RGB8 as libpng gives it with strip_16, strip_alpha, palette_to_rgb,
// expand_gray_1_2_4_to_8 and gray_to_rgb (the JAX loader's settings).
bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  PngHeader hd;
  if (!png_parse(buf, len, &hd, true)) return false;
  const int ch = png_channels(hd.color);
  const int d = hd.depth;
  if (!ch || !(d == 1 || d == 2 || d == 4 || d == 8 || d == 16) ||
      hd.w <= 0 || hd.h <= 0)
    return fail("unsupported PNG format");
  if (hd.interlace) return fail("interlaced PNG is not supported");
  if (hd.color == 3 && hd.palette.size() < 3) return fail("PNG palette missing");
  const size_t row_bytes = (size_t(hd.w) * ch * d + 7) / 8;
  const size_t bpp = std::max<size_t>(1, size_t(ch) * d / 8);
  std::vector<uint8_t> raw(size_t(hd.h) * (row_bytes + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, hd.idat.data(), hd.idat.size()) != Z_OK ||
      raw_len != raw.size())
    return fail("PNG image data does not inflate to its size");
  std::vector<uint8_t> prev(row_bytes, 0), cur(row_bytes);
  out->w = hd.w;
  out->h = hd.h;
  out->data.resize(size_t(hd.w) * hd.h * 3);
  const int maxv = (1 << d) - 1;
  for (int y = 0; y < hd.h; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (row_bytes + 1);
    const uint8_t filter = src[0];
    ++src;
    for (size_t i = 0; i < row_bytes; ++i) {
      int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i];
      int c = i >= bpp ? prev[i - bpp] : 0;
      int x = src[i];
      switch (filter) {
        case 0: break;
        case 1: x += a; break;
        case 2: x += b; break;
        case 3: x += (a + b) >> 1; break;
        case 4: x += paeth(a, b, c); break;
        default: return fail("bad PNG row filter");
      }
      cur[i] = uint8_t(x);
    }
    uint8_t* dst = out->data.data() + size_t(y) * hd.w * 3;
    for (int x = 0; x < hd.w; ++x) {
      uint8_t rgb[3];
      auto sample = [&](int k) -> int {  // sample k of pixel x, 8 bits
        if (d == 16) return cur[(size_t(x) * ch + k) * 2];  // strip_16
        if (d == 8) return cur[size_t(x) * ch + k];
        size_t bit = (size_t(x) * ch + k) * d;
        return (cur[bit / 8] >> (8 - d - bit % 8)) & maxv;
      };
      if (hd.color == 3) {
        int idx = sample(0);
        if (size_t(idx) * 3 + 2 >= hd.palette.size())
          return fail("PNG palette index out of range");
        memcpy(rgb, &hd.palette[size_t(idx) * 3], 3);
      } else if (hd.color == 0 || hd.color == 4) {
        int g = sample(0);
        if (d < 8) g = g * 255 / maxv;
        rgb[0] = rgb[1] = rgb[2] = uint8_t(g);
      } else {
        for (int k = 0; k < 3; ++k) rgb[k] = uint8_t(sample(k));
      }
      memcpy(dst + size_t(x) * 3, rgb, 3);
    }
    std::swap(prev, cur);
  }
  return true;
}

// ---------------------------------------------------------------------------
// JPEG: libjpeg on the host
// ---------------------------------------------------------------------------

#if defined(CODEC_LIBJPEG)

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  char msg[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, msg);
  g_err = std::string("libjpeg: ") + msg;
  longjmp(err->jb, 1);
}

bool jpeg_info(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// jpeg_set_defaults samples Y 2x2 against Cb / Cr 1x1: 4:2:0, baseline,
// standard Huffman tables, as cv2.imencode(".jpg") writes by default.
long encode_jpeg(const uint8_t* rgb, int w, int h, int quality, void*,
                 uint8_t** out) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  unsigned char* mem = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    free(mem);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + size_t(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = mem;  // malloc'd by libjpeg; codec_free releases it
  return long(size);
}

bool backend_init(int) { return true; }

// ---------------------------------------------------------------------------
// JPEG: nvJPEG on the card
// ---------------------------------------------------------------------------

#elif defined(CODEC_NVJPEG)

nvjpegHandle_t g_handle = nullptr;
int g_device = 0;
std::once_flag g_once;
std::string g_init_err;

#define NVJ(call, what)                                                    \
  do {                                                                     \
    nvjpegStatus_t st_ = (call);                                           \
    if (st_ != NVJPEG_STATUS_SUCCESS)                                      \
      return fail(std::string("nvJPEG ") + what + " failed, status " +     \
                  std::to_string(int(st_)));                               \
  } while (0)
#define CUDA(call, what)                                                   \
  do {                                                                     \
    cudaError_t e_ = (call);                                               \
    if (e_ != cudaSuccess)                                                 \
      return fail(std::string("CUDA ") + what + ": " +                     \
                  cudaGetErrorString(e_));                                 \
  } while (0)

bool backend_init(int device) {
  std::call_once(g_once, [device] {
    g_device = device;
    if (cudaSetDevice(device) != cudaSuccess) {
      g_init_err = "cudaSetDevice failed";
      return;
    }
    if (nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS) {
      g_init_err = "nvjpegCreateSimple failed";
      g_handle = nullptr;
    }
  });
  if (!g_handle) return fail(g_init_err.empty() ? "nvJPEG not initialised" : g_init_err);
  return true;
}

// nvJPEG's states may not be used by two threads at once, and creating
// one costs milliseconds (a stream, device buffers), so a call leases a
// context from a process-wide pool and returns it: a fresh thread (an
// HTTP handler, a ring worker) reuses an idle context. Contexts live as
// long as the process. The stream does not synchronise with PyTorch's
// legacy default stream, so a decode in the ring never waits for the
// model's kernels.
struct NvCtx {
  bool ok = false;
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  uint8_t* dbuf = nullptr;
  size_t dbuf_size = 0;
};

std::mutex g_pool_mu;
std::vector<NvCtx*> g_pool;  // idle contexts

struct CtxLease {
  NvCtx* c = nullptr;
  CtxLease() {
    std::lock_guard<std::mutex> lk(g_pool_mu);
    if (!g_pool.empty()) {
      c = g_pool.back();
      g_pool.pop_back();
    } else {
      c = new NvCtx();
    }
  }
  ~CtxLease() {
    std::lock_guard<std::mutex> lk(g_pool_mu);
    g_pool.push_back(c);
  }
};

bool ctx_ready(NvCtx& c) {
  if (!g_handle) return fail("codec_init was not called");
  if (c.ok) return true;
  CUDA(cudaSetDevice(g_device), "set device");
  if (!c.stream)
    CUDA(cudaStreamCreateWithFlags(&c.stream, cudaStreamNonBlocking),
         "stream create");
  if (!c.dec) NVJ(nvjpegJpegStateCreate(g_handle, &c.dec), "decoder state create");
  if (!c.enc)
    NVJ(nvjpegEncoderStateCreate(g_handle, &c.enc, c.stream),
        "encoder state create");
  if (!c.params)
    NVJ(nvjpegEncoderParamsCreate(g_handle, &c.params, c.stream),
        "encoder params create");
  c.ok = true;
  return true;
}

bool jpeg_info(const uint8_t* buf, size_t len, int* w, int* h) {
  if (!g_handle) return fail("codec_init was not called");
  int nc = 0;
  nvjpegChromaSubsampling_t css;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  NVJ(nvjpegGetImageInfo(g_handle, buf, len, &nc, &css, ws, hs), "image info");
  *w = ws[0];
  *h = hs[0];
  return true;
}

// libjpeg's fancy upsampling of one chroma plane (jdsample.c: h2v1 and
// h2v2, the triangle filter; the rows above the first and below the last
// repeat the edge row, as libjpeg's context rows do) to w x h.
bool upsample_plane(const uint8_t* in, int dw, int dh, int hs, int vs,
                    int w, int h, uint8_t* out) {
  if (hs == 1 && vs == 1) {
    for (int y = 0; y < h; ++y) memcpy(out + size_t(y) * w, in + size_t(y) * dw, w);
    return true;
  }
  if (hs != 2 || (vs != 1 && vs != 2) || dw < 2)
    return fail("chroma subsampling not supported on the nvJPEG path");
  std::vector<uint8_t> row(size_t(dw) * 2);
  for (int oy = 0; oy < h; ++oy) {
    const int r = vs == 2 ? oy / 2 : oy;
    const uint8_t* in0 = in + size_t(std::min(r, dh - 1)) * dw;
    uint8_t* o = row.data();
    if (vs == 1) {  // h2v1_fancy_upsample
      int v = in0[0];
      *o++ = uint8_t(v);
      *o++ = uint8_t((v * 3 + in0[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        v = in0[c] * 3;
        *o++ = uint8_t((v + in0[c - 1] + 1) >> 2);
        *o++ = uint8_t((v + in0[c + 1] + 2) >> 2);
      }
      v = in0[dw - 1];
      *o++ = uint8_t((v * 3 + in0[dw - 2] + 1) >> 2);
      *o++ = uint8_t(v);
    } else {  // h2v2_fancy_upsample
      const int r1 = (oy % 2 == 0) ? std::max(r - 1, 0) : std::min(r + 1, dh - 1);
      const uint8_t* in1 = in + size_t(std::min(r1, dh - 1)) * dw;
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      *o++ = uint8_t((this_sum * 4 + 8) >> 4);
      *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int c = 2; c < dw; ++c) {
        next_sum = in0[c] * 3 + in1[c];
        *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = uint8_t((this_sum * 4 + 7) >> 4);
    }
    memcpy(out + size_t(oy) * w, row.data(), w);
  }
  return true;
}

// libjpeg's YCbCr -> RGB (jdcolor.c: 16-bit fixed point, rounded tables)
struct YccTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  YccTables() {
    const long one_half = 1L << 15;
    auto fix = [](double x) { return long(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const long x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// nvJPEG decodes the planes (the IDCT) on the card; the chroma upsampling
// and colour conversion are libjpeg's, on the host, so the two builds
// agree up to the IDCT's rounding.
bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  CtxLease lease;
  NvCtx& ctx = *lease.c;
  if (!ctx_ready(ctx)) return false;
  int nc = 0;
  nvjpegChromaSubsampling_t css;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  NVJ(nvjpegGetImageInfo(g_handle, buf, len, &nc, &css, ws, hs), "image info");
  const int w = ws[0], h = hs[0];
  const int planes = css == NVJPEG_CSS_GRAY ? 1 : 3;
  size_t off[3] = {0, 0, 0}, total = 0;
  for (int c = 0; c < planes; ++c) {
    off[c] = total;
    total += size_t(ws[c]) * hs[c];
  }
  if (total > ctx.dbuf_size) {
    if (ctx.dbuf) cudaFree(ctx.dbuf);
    ctx.dbuf = nullptr;
    ctx.dbuf_size = 0;
    CUDA(cudaMalloc(&ctx.dbuf, total), "malloc");
    ctx.dbuf_size = total;
  }
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  for (int c = 0; c < planes; ++c) {
    img.channel[c] = ctx.dbuf + off[c];
    img.pitch[c] = size_t(ws[c]);
  }
  NVJ(nvjpegDecode(g_handle, ctx.dec, buf, len,
                   planes == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &img,
                   ctx.stream),
      "decode");
  std::vector<uint8_t> host(total);
  CUDA(cudaMemcpyAsync(host.data(), ctx.dbuf, total, cudaMemcpyDeviceToHost,
                       ctx.stream),
       "copy to host");
  CUDA(cudaStreamSynchronize(ctx.stream), "decode sync");
  out->w = w;
  out->h = h;
  out->data.resize(size_t(w) * h * 3);
  const uint8_t* yp = host.data();
  if (planes == 1) {
    for (size_t i = 0; i < size_t(w) * h; ++i)
      out->data[i * 3] = out->data[i * 3 + 1] = out->data[i * 3 + 2] = yp[i];
    return true;
  }
  const int hsf = (ws[1] * 2 <= w + 1 && ws[1] < w) ? 2 : 1;
  const int vsf = (hs[1] * 2 <= h + 1 && hs[1] < h) ? 2 : 1;
  std::vector<uint8_t> cb(size_t(w) * h), cr(size_t(w) * h);
  if (!upsample_plane(host.data() + off[1], ws[1], hs[1], hsf, vsf, w, h,
                      cb.data()) ||
      !upsample_plane(host.data() + off[2], ws[2], hs[2], hsf, vsf, w, h,
                      cr.data()))
    return false;
  static const YccTables t;
  for (size_t i = 0; i < size_t(w) * h; ++i) {
    const int y = yp[i], b = cb[i], r = cr[i];
    uint8_t* o = &out->data[i * 3];
    o[0] = clamp255(y + t.cr_r[r]);
    o[1] = clamp255(y + int((t.cb_g[b] + t.cr_g[r]) >> 16));
    o[2] = clamp255(y + t.cb_b[b]);
  }
  return true;
}

bool encode_jpeg_impl(const uint8_t* rgb, int w, int h, int quality,
                      cudaStream_t stream, std::vector<uint8_t>* out) {
  CtxLease lease;
  NvCtx& ctx = *lease.c;
  if (!ctx_ready(ctx)) return false;
  NVJ(nvjpegEncoderParamsSetQuality(ctx.params, quality, stream), "quality");
  NVJ(nvjpegEncoderParamsSetSamplingFactors(ctx.params, NVJPEG_CSS_420,
                                            stream),
      "sampling factors");
  NVJ(nvjpegEncoderParamsSetOptimizedHuffman(ctx.params, 0, stream),
      "huffman");
  nvjpegImage_t src;
  memset(&src, 0, sizeof(src));
  src.channel[0] = const_cast<uint8_t*>(rgb);
  src.pitch[0] = size_t(w) * 3;
  NVJ(nvjpegEncodeImage(g_handle, ctx.enc, ctx.params, &src,
                        NVJPEG_INPUT_RGBI, w, h, stream),
      "encode");
  size_t len = 0;
  NVJ(nvjpegEncodeRetrieveBitstream(g_handle, ctx.enc, nullptr, &len, stream),
      "bitstream size");
  CUDA(cudaStreamSynchronize(stream), "encode sync");
  out->resize(len);
  NVJ(nvjpegEncodeRetrieveBitstream(g_handle, ctx.enc, out->data(), &len,
                                    stream),
      "bitstream");
  CUDA(cudaStreamSynchronize(stream), "bitstream sync");
  out->resize(len);
  return true;
}

long encode_jpeg(const uint8_t* rgb, int w, int h, int quality, void* stream,
                 uint8_t** out) {
  std::vector<uint8_t> buf;
  if (!encode_jpeg_impl(rgb, w, h, quality, static_cast<cudaStream_t>(stream),
                        &buf))
    return -1;
  *out = static_cast<uint8_t*>(malloc(buf.size()));
  if (!*out) return -1;
  memcpy(*out, buf.data(), buf.size());
  return long(buf.size());
}

#endif

bool is_jpeg(const uint8_t* buf, size_t len) {
  return len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8;
}

bool image_info(const uint8_t* buf, size_t len, int* w, int* h) {
  if (is_jpeg(buf, len)) return jpeg_info(buf, len, w, h);
  PngHeader hd;
  if (!png_parse(buf, len, &hd, false)) return false;
  *w = hd.w;
  *h = hd.h;
  return true;
}

bool decode_buffer(const uint8_t* buf, size_t len, Image* out) {
  if (is_jpeg(buf, len)) return decode_jpeg(buf, len, out);
  return decode_png(buf, len, out);
}

bool decode_file(const char* path, Image* out) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return false;
  if (!decode_buffer(bytes.data(), bytes.size(), out)) {
    g_err = std::string(path) + ": " + g_err;
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// resize (dataloader.cpp:147-200, the same float arithmetic)
// ---------------------------------------------------------------------------

// bilinear resize to SxS with half-pixel centres (cv2.resize's
// align_corners=False convention), then normalise to [-1, 1]
void resize_normalize(const uint8_t* data, int w, int h, int s, float* out) {
  const float sx = float(w) / s;
  const float sy = float(h) / s;
  for (int y = 0; y < s; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(fy < 0 ? 0 : fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float ty = fy - y0;
    if (ty < 0) ty = 0;
    for (int x = 0; x < s; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = int(fx < 0 ? 0 : fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float tx = fx - x0;
      if (tx < 0) tx = 0;
      const uint8_t* p00 = &data[(size_t(y0) * w + x0) * 3];
      const uint8_t* p01 = &data[(size_t(y0) * w + x1) * 3];
      const uint8_t* p10 = &data[(size_t(y1) * w + x0) * 3];
      const uint8_t* p11 = &data[(size_t(y1) * w + x1) * 3];
      float* dst = out + (size_t(y) * s + x) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        float top = p00[ch] * (1 - tx) + p01[ch] * tx;
        float bot = p10[ch] * (1 - tx) + p11[ch] * tx;
        float v = (top * (1 - ty) + bot * ty) / 255.0f;
        dst[ch] = v * 2.0f - 1.0f;
      }
    }
  }
}

// bilinear resize to SxS, rounded to uint8 RGB (no normalisation)
void resize_u8(const uint8_t* data, int w, int h, int s, uint8_t* out) {
  const float sx = float(w) / s;
  const float sy = float(h) / s;
  for (int y = 0; y < s; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(fy < 0 ? 0 : fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float ty = fy - y0;
    if (ty < 0) ty = 0;
    for (int x = 0; x < s; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = int(fx < 0 ? 0 : fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float tx = fx - x0;
      if (tx < 0) tx = 0;
      const uint8_t* p00 = &data[(size_t(y0) * w + x0) * 3];
      const uint8_t* p01 = &data[(size_t(y0) * w + x1) * 3];
      const uint8_t* p10 = &data[(size_t(y1) * w + x0) * 3];
      const uint8_t* p11 = &data[(size_t(y1) * w + x1) * 3];
      uint8_t* dst = out + (size_t(y) * s + x) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        float top = p00[ch] * (1 - tx) + p01[ch] * tx;
        float bot = p10[ch] * (1 - tx) + p11[ch] * tx;
        float v = top * (1 - ty) + bot * ty + 0.5f;
        dst[ch] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// prefetching loader (dataloader.cpp:206-345)
// ---------------------------------------------------------------------------

struct Job {
  uint64_t seq;
  std::string path;
  long tag;
};

struct Result {
  long tag = 0;
  bool ok = false;
  std::string err;
  std::vector<float> pixels;       // float mode
  std::vector<uint8_t> pixels_u8;  // u8 mode
};

struct Loader {
  int image_size = 0;
  bool u8 = false;
  size_t capacity = 64;
  std::vector<std::thread> workers;

  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  std::deque<Job> jobs;
  std::map<uint64_t, Result> done;  // ordered by sequence
  uint64_t next_submit = 0;
  uint64_t next_emit = 0;
  bool shutdown = false;

  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return shutdown || !jobs.empty(); });
        if (shutdown && jobs.empty()) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      Result res;
      res.tag = job.tag;
      Image img;
      res.ok = decode_file(job.path.c_str(), &img);
      if (res.ok) {
        const size_t n = size_t(image_size) * image_size * 3;
        if (u8) {
          res.pixels_u8.resize(n);
          resize_u8(img.data.data(), img.w, img.h, image_size,
                    res.pixels_u8.data());
        } else {
          res.pixels.resize(n);
          resize_normalize(img.data.data(), img.w, img.h, image_size,
                           res.pixels.data());
        }
      } else {
        res.err = g_err;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done.emplace(job.seq, std::move(res));
      }
      cv_done.notify_all();
    }
  }
};

int pop_next(Loader* l, Result* res, long* tag) {
  {
    std::unique_lock<std::mutex> lk(l->mu);
    if (l->next_emit >= l->next_submit) return -2;  // nothing pending
    uint64_t want = l->next_emit;
    l->cv_done.wait(lk, [&] { return l->done.count(want) > 0; });
    *res = std::move(l->done[want]);
    l->done.erase(want);
    l->next_emit++;
  }
  l->cv_done.notify_all();
  if (tag) *tag = res->tag;
  if (!res->ok) {
    g_err = res->err;
    return -1;
  }
  return 0;
}

}  // namespace

extern "C" {

int codec_init(int device) { return backend_init(device) ? 0 : -1; }

const char* codec_last_error() { return g_err.c_str(); }

int codec_image_info(const uint8_t* buf, long len, int* w, int* h) {
  return image_info(buf, size_t(len), w, h) ? 0 : -1;
}

int codec_decode(const uint8_t* buf, long len, uint8_t* out) {
  Image img;
  if (!decode_buffer(buf, size_t(len), &img)) return -1;
  memcpy(out, img.data.data(), img.data.size());
  return 0;
}

void codec_resize_u8(const uint8_t* img, int w, int h, int s, uint8_t* out) {
  resize_u8(img, w, h, s, out);
}

int codec_decode_resize_u8(const char* path, int s, uint8_t* out) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  resize_u8(img.data.data(), img.w, img.h, s, out);
  return 0;
}

int codec_decode_resize(const char* path, int s, float* out) {
  Image img;
  if (!decode_file(path, &img)) return -1;
  resize_normalize(img.data.data(), img.w, img.h, s, out);
  return 0;
}

void* loader_create(int threads, int capacity, int image_size, int u8) {
  auto* l = new Loader();
  l->image_size = image_size;
  l->u8 = u8 != 0;
  l->capacity = capacity > 0 ? size_t(capacity) : 64;
  int n = threads > 0 ? threads : 2;
  for (int i = 0; i < n; ++i) l->workers.emplace_back([l] { l->worker(); });
  return l;
}

int loader_submit(void* handle, const char* path, long tag) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::unique_lock<std::mutex> lk(l->mu);
    // bound memory: don't run unboundedly ahead of the consumer
    l->cv_done.wait(lk, [&] {
      return l->shutdown || (l->next_submit - l->next_emit) < l->capacity;
    });
    if (l->shutdown) return -1;
    l->jobs.push_back(Job{l->next_submit++, path, tag});
  }
  l->cv_job.notify_one();
  return 0;
}

int loader_next(void* handle, float* out, long* tag) {
  auto* l = static_cast<Loader*>(handle);
  if (l->u8) return -3;  // mode mismatch: created with u8=1
  Result res;
  int rc = pop_next(l, &res, tag);
  if (rc != 0) return rc;
  memcpy(out, res.pixels.data(), res.pixels.size() * sizeof(float));
  return 0;
}

int loader_next_u8(void* handle, uint8_t* out, long* tag) {
  auto* l = static_cast<Loader*>(handle);
  if (!l->u8) return -3;  // mode mismatch: created with u8=0
  Result res;
  int rc = pop_next(l, &res, tag);
  if (rc != 0) return rc;
  memcpy(out, res.pixels_u8.data(), res.pixels_u8.size());
  return 0;
}

void loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->shutdown = true;
  }
  l->cv_job.notify_all();
  l->cv_done.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

long codec_encode_jpeg(const uint8_t* rgb, int w, int h, int quality,
                       void* stream, uint8_t** out) {
  return encode_jpeg(rgb, w, h, quality, stream, out);
}

void codec_free(uint8_t* p) { free(p); }

}  // extern "C"
