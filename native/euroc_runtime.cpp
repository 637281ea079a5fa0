// Native runtime for the VIO engine: EuRoC dataset IO.
//
// The reference engine's driver does CSV parsing and PNG decoding on the
// main thread between filter updates (apps/run_euroc_single_thread.cpp:
// 151-238, cv::imread at :194).  Feeding an accelerator needs the host loop to be
// far off the critical path, so this library provides:
//   * a fast IMU/camera CSV parser (no iostream overhead),
//   * libpng grayscale decoding,
//   * a multi-threaded prefetching decode stream with a bounded in-order
//     queue, so image batches are ready before the device asks for them.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (msckf_stereo_c/io/native.py).

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- CSV ----

// Parse one EuRoC csv line: int64 timestamp followed by `ncols` doubles
// (IMU) or a filename (camera index). Returns false on comment/blank lines.
bool parse_imu_line(const char* line, int64_t* t, double* vals, int ncols) {
  if (!line[0] || line[0] == '#') return false;
  char* end = nullptr;
  int64_t ts = strtoll(line, &end, 10);
  if (end == line) return false;
  *t = ts;
  for (int i = 0; i < ncols; ++i) {
    if (*end != ',') return false;
    ++end;
    char* e2 = nullptr;
    vals[i] = strtod(end, &e2);
    if (e2 == end) return false;
    end = e2;
  }
  return true;
}

struct PngReadCtx {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadCtx* ctx = static_cast<PngReadCtx*>(png_get_io_ptr(png));
  if (ctx->pos + n > ctx->size) {
    png_error(png, "read past end");
  }
  memcpy(out, ctx->data + ctx->pos, n);
  ctx->pos += n;
}

// Decode an 8-bit grayscale PNG from memory into out (must hold w*h).
// Returns 0 on success; fills *w/*h.
int decode_png_gray(const uint8_t* buf, size_t size, uint8_t* out, int* w,
                    int* h, int max_w, int max_h) {
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
  PngReadCtx ctx{buf, size, 0};
  png_set_read_fn(png, &ctx, png_mem_read);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (static_cast<int>(width) > max_w || static_cast<int>(height) > max_h) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  // Normalize to 8-bit gray.
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_PALETTE ||
      color == PNG_COLOR_TYPE_RGB_ALPHA)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<png_bytep> rows(height);
  for (png_uint_32 y = 0; y < height; ++y) rows[y] = out + y * width;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  return 0;
}

int decode_png_file(const char* path, uint8_t* out, int* w, int* h, int max_w,
                    int max_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return -11;
  }
  fclose(f);
  return decode_png_gray(buf.data(), buf.size(), out, w, h, max_w, max_h);
}

// ------------------------------------------------------------ prefetch ----

struct Stream {
  std::vector<std::string> files;
  int width = 0, height = 0;
  int depth = 0;  // queue depth (frames decoded ahead)
  std::atomic<int> next_to_claim{0};
  int next_to_emit = 0;

  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::map<int, std::vector<uint8_t>> ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> errors{0};

  void worker() {
    const size_t frame = static_cast<size_t>(width) * height;
    while (!stop.load()) {
      int idx = next_to_claim.fetch_add(1);
      if (idx >= static_cast<int>(files.size())) return;
      std::vector<uint8_t> img(frame);
      int w = 0, h = 0;
      int rc = decode_png_file(files[idx].c_str(), img.data(), &w, &h, width,
                               height);
      if (rc != 0 || w != width || h != height) {
        errors.fetch_add(1);
        img.assign(frame, 0);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() ||
               idx < next_to_emit + depth;  // bounded look-ahead
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(img));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// IMU csv: writes up to max_n rows of (t_ns, gx, gy, gz, ax, ay, az).
// Returns the number of rows parsed, or negative on error.
int mr_load_imu_csv(const char* path, int64_t* t_ns, double* gyro, double* acc,
                    int max_n) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[512];
  int n = 0;
  double vals[6];
  while (n < max_n && fgets(line, sizeof line, f)) {
    int64_t ts;
    if (!parse_imu_line(line, &ts, vals, 6)) continue;
    t_ns[n] = ts;
    gyro[3 * n + 0] = vals[0];
    gyro[3 * n + 1] = vals[1];
    gyro[3 * n + 2] = vals[2];
    acc[3 * n + 0] = vals[3];
    acc[3 * n + 1] = vals[4];
    acc[3 * n + 2] = vals[5];
    ++n;
  }
  fclose(f);
  return n;
}

// Camera csv: timestamps only (filenames are "<t>.png" by convention but we
// return the raw names too, '\0'-joined into names_buf of names_cap bytes).
int mr_load_cam_csv(const char* path, int64_t* t_ns, char* names_buf,
                    int names_cap, int max_n) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char line[512];
  int n = 0;
  int off = 0;
  while (n < max_n && fgets(line, sizeof line, f)) {
    if (!line[0] || line[0] == '#') continue;
    char* end = nullptr;
    int64_t ts = strtoll(line, &end, 10);
    if (end == line || *end != ',') continue;
    ++end;
    // Trim trailing whitespace/newline.
    char* e = end + strlen(end);
    while (e > end && (e[-1] == '\n' || e[-1] == '\r' || e[-1] == ' ')) --e;
    int len = static_cast<int>(e - end);
    if (off + len + 1 > names_cap) break;
    memcpy(names_buf + off, end, len);
    names_buf[off + len] = '\0';
    off += len + 1;
    t_ns[n] = ts;
    ++n;
  }
  fclose(f);
  return n;
}

// Single-image decode.
int mr_decode_png(const char* path, uint8_t* out, int max_w, int max_h,
                  int* w, int* h) {
  return decode_png_file(path, out, w, h, max_w, max_h);
}

// Prefetching stream: files is a '\0'-joined list of n paths.
void* mr_stream_open(const char* files, int n, int width, int height,
                     int queue_depth, int n_threads) {
  Stream* s = new Stream();
  const char* p = files;
  for (int i = 0; i < n; ++i) {
    s->files.emplace_back(p);
    p += s->files.back().size() + 1;
  }
  s->width = width;
  s->height = height;
  s->depth = queue_depth > 0 ? queue_depth : 32;
  int threads = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < threads; ++i)
    s->workers.emplace_back([s] { s->worker(); });
  return s;
}

// Fill out with the next `count` frames (row-major, uint8). Returns the
// number of frames written (0 at end of stream).
int mr_stream_next(void* handle, uint8_t* out, int count) {
  Stream* s = static_cast<Stream*>(handle);
  const size_t frame = static_cast<size_t>(s->width) * s->height;
  int written = 0;
  std::unique_lock<std::mutex> lk(s->mu);
  while (written < count &&
         s->next_to_emit < static_cast<int>(s->files.size())) {
    s->cv_ready.wait(lk, [&] { return s->ready.count(s->next_to_emit) > 0; });
    auto it = s->ready.find(s->next_to_emit);
    memcpy(out + static_cast<size_t>(written) * frame, it->second.data(),
           frame);
    s->ready.erase(it);
    ++s->next_to_emit;
    ++written;
    s->cv_space.notify_all();
  }
  return written;
}

int mr_stream_errors(void* handle) {
  return static_cast<Stream*>(handle)->errors.load();
}

void mr_stream_close(void* handle) {
  Stream* s = static_cast<Stream*>(handle);
  s->stop.store(true);
  s->cv_space.notify_all();
  s->cv_ready.notify_all();
  for (auto& t : s->workers) t.join();
  delete s;
}

}  // extern "C"
