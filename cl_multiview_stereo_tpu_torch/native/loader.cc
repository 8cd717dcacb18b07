// Native multi-view image loader.
//
// The reference's host runtime is C++ (OpenCV imread + Mat->array copies,
// clMVDE/file_handler.cpp:6-57, driven by a sequential per-view loop at
// pipeline.cpp:76-95).  This is its TPU-framework equivalent: a small C++
// library that decodes a whole camera array (PNG/JPEG) into one dense
// (V, H, W, 3) RGB8 buffer with a thread pool, so host-side IO never
// serializes behind Python.  Exposed via a plain C ABI for ctypes.
//
// Build: see build.py (g++ -O2 -shared -fPIC loader.cc -lpng -ljpeg -lz).

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

#include <csetjmp>

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool is_png(const unsigned char* sig) { return png_sig_cmp(sig, 0, 8) == 0; }

// Decode one PNG into rgb (h*w*3); returns 0 on success.
int decode_png(FILE* f, unsigned char* out, int want_h, int want_w) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -1;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if ((int)w != want_w || (int)h != want_h) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  // Normalize to 8-bit RGB.
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int decode_jpeg(FILE* f, unsigned char* out, int want_h, int want_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  rewind(f);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != want_w || (int)cinfo.output_height != want_h) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + (size_t)cinfo.output_scanline * want_w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_one(const char* path, unsigned char* out, int h, int w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  unsigned char sig[8];
  if (fread(sig, 1, 8, f) != 8) {
    fclose(f);
    return -11;
  }
  int rc;
  if (is_png(sig)) {
    rc = decode_png(f, out, h, w);
  } else {
    rc = decode_jpeg(f, out, h, w);
  }
  fclose(f);
  return rc;
}

}  // namespace

extern "C" {

// Probe image dimensions without decoding. Returns 0 on success.
int mvs_probe(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  unsigned char sig[8];
  if (fread(sig, 1, 8, f) != 8) {
    fclose(f);
    return -11;
  }
  int rc = 0;
  if (is_png(sig)) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(f);
      return -2;
    }
    png_init_io(png, f);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);
    *w = (int)png_get_image_width(png, info);
    *h = (int)png_get_image_height(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
  } else {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jmp)) {
      jpeg_destroy_decompress(&cinfo);
      fclose(f);
      return -2;
    }
    jpeg_create_decompress(&cinfo);
    rewind(f);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    *w = (int)cinfo.image_width;
    *h = (int)cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
  }
  fclose(f);
  return rc;
}

// Decode n images into out (n, h, w, 3) RGB8 with a thread pool.
// Returns 0 on success, or (100 + first failing index) on error.
int mvs_load_batch(const char** paths, int n, unsigned char* out, int h, int w,
                   int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(-1);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() >= 0) return;
      unsigned char* dst = out + (size_t)i * h * w * 3;
      if (decode_one(paths[i], dst, h, w) != 0) {
        int expect = -1;
        failed.compare_exchange_strong(expect, i);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = threads < n ? threads : n;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  int bad = failed.load();
  return bad >= 0 ? 100 + bad : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Scene prefetcher: a background pipeline executor that decodes whole camera
// arrays ahead of consumption, so host-side IO overlaps accelerator compute.
// The reference runtime loads images synchronously up front on the main
// thread (clMVDE/pipeline.cpp:12 + file_handler.cpp:30-57); this is its
// TPU-framework equivalent for multi-scene streaming workloads.
// ---------------------------------------------------------------------------

namespace {

struct ReadyScene {
  int idx;
  int rc;  // 0 ok, else (100 + failing image index)
  std::vector<unsigned char> buf;
};

int decode_scene(const std::vector<std::string>& paths, unsigned char* out,
                 int h, int w, int threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(-1);
  int n = (int)paths.size();
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() >= 0) return;
      unsigned char* dst = out + (size_t)i * h * w * 3;
      if (decode_one(paths[i].c_str(), dst, h, w) != 0) {
        int expect = -1;
        failed.compare_exchange_strong(expect, i);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = threads < n ? threads : n;
  if (nt < 1) nt = 1;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  int bad = failed.load();
  return bad >= 0 ? 100 + bad : 0;
}

struct Prefetcher {
  std::vector<std::vector<std::string>> scenes;
  int h = 0, w = 0, threads = 1, depth = 2;
  std::mutex mu;
  std::condition_variable cv_prod, cv_cons;
  std::deque<ReadyScene> ready;
  int produced = 0;
  bool stop = false;
  std::thread producer;

  void run() {
    for (int s = 0; s < (int)scenes.size(); ++s) {
      ReadyScene r;
      r.idx = s;
      r.buf.resize((size_t)scenes[s].size() * h * w * 3);
      r.rc = decode_scene(scenes[s], r.buf.data(), h, w, threads);
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_prod.wait(lk, [&] { return stop || (int)ready.size() < depth; });
        if (stop) return;
        ready.push_back(std::move(r));
        ++produced;
      }
      cv_cons.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// Create a prefetcher over n_scenes scenes; scene s spans paths
// [offsets[s], offsets[s+1]) in the flat path list.  queue_depth scenes are
// decoded ahead.  All images must be h x w.
void* mvs_prefetcher_create(const char** paths, const int* offsets,
                            int n_scenes, int h, int w, int queue_depth,
                            int threads) {
  auto* p = new Prefetcher();
  p->h = h;
  p->w = w;
  p->threads = threads < 1 ? 1 : threads;
  p->depth = queue_depth < 1 ? 1 : queue_depth;
  p->scenes.resize(n_scenes);
  for (int s = 0; s < n_scenes; ++s)
    for (int i = offsets[s]; i < offsets[s + 1]; ++i)
      p->scenes[s].emplace_back(paths[i]);
  p->producer = std::thread([p] { p->run(); });
  return p;
}

// Blocks until the next scene (in order) is decoded, copies it into out
// ((V, h, w, 3) RGB8).  Returns the scene index, -1 when all scenes are
// consumed, or -(100 + image index) - 1 on decode failure.
int mvs_prefetcher_next(void* handle, unsigned char* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  ReadyScene r;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->ready.empty() && p->produced >= (int)p->scenes.size()) return -1;
    p->cv_cons.wait(lk, [&] { return !p->ready.empty(); });
    r = std::move(p->ready.front());
    p->ready.pop_front();
  }
  p->cv_prod.notify_one();
  if (r.rc != 0) return -r.rc - 1;
  std::memcpy(out, r.buf.data(), r.buf.size());
  return r.idx;
}

void mvs_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_prod.notify_all();
  if (p->producer.joinable()) p->producer.join();
  delete p;
}

}  // extern "C"
