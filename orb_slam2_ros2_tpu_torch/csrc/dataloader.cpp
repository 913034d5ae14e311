// Native dataset feeder: multithreaded PNG decode with in-order prefetch.
//
// Role: the reference's example drivers decode images on the caller's thread
// with OpenCV (reference: example/Stereo/KittiStereo.cc:28-37).  Feeding a
// TPU tracker at >100 fps needs decode off the critical path: this library
// runs a small worker pool that decodes frames ahead of the consumer into a
// bounded in-order ring, exposed to Python via a minimal ctypes C API.
//
// API (all thread-safe from a single consumer thread):
//   void* dl_create(const char** paths, int n_paths, int n_threads, int depth);
//   int   dl_next(void* h, float* out, int capacity);   // blocking; returns h*w or -1
//   void  dl_dims(void* h, int* height, int* width);    // dims of frame 0
//   void  dl_destroy(void* h);
//   int   dl_decode_one(const char* path, float* out, int capacity,
//                       int* height, int* width);       // synchronous helper
//
// Grayscale conversion: 8/16-bit gray, gray+alpha, RGB(A) and palette inputs
// all land as float32 luma (Rec.601 for colour), matching the tracker's
// expected [0, 255] range.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> data;
  int h = 0, w = 0;
  bool ready = false;
};

bool decode_png_gray(const char* path, std::vector<float>& out, int& h, int& w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  const int channels = png_get_channels(png, info);
  std::vector<png_byte> row(static_cast<size_t>(w) * channels);
  out.resize(static_cast<size_t>(h) * w);
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out.data() + static_cast<size_t>(y) * w;
    if (channels == 1) {
      for (int x = 0; x < w; ++x) dst[x] = static_cast<float>(row[x]);
    } else {  // RGB: Rec.601 luma
      for (int x = 0; x < w; ++x) {
        const png_byte* p = &row[static_cast<size_t>(x) * channels];
        dst[x] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

struct Loader {
  std::vector<std::string> paths;
  std::vector<Frame> ring;
  int depth;
  std::atomic<int> next_job{0};
  int next_out = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  Loader(const char** p, int n, int n_threads, int d) : depth(d) {
    paths.reserve(n);
    for (int i = 0; i < n; ++i) paths.emplace_back(p[i]);
    ring.resize(depth);
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { work(); });
  }

  void work() {
    while (!stop.load()) {
      int job = next_job.fetch_add(1);
      if (job >= static_cast<int>(paths.size())) return;
      Frame f;
      if (!decode_png_gray(paths[job].c_str(), f.data, f.h, f.w)) {
        f.h = f.w = 0;  // decode failure → empty frame, consumer sees -1
      }
      std::unique_lock<std::mutex> lk(mu);
      // wait until the ring slot for this job is free (in-order bounded queue)
      cv_space.wait(lk, [&] { return stop.load() || job - next_out < depth; });
      if (stop.load()) return;
      Frame& slot = ring[job % depth];
      slot = std::move(f);
      slot.ready = true;
      cv_ready.notify_all();
    }
  }

  int next(float* out, int capacity) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_out >= static_cast<int>(paths.size())) return -2;  // exhausted
    Frame& slot = ring[next_out % depth];
    cv_ready.wait(lk, [&] { return slot.ready; });
    int n = slot.h * slot.w;
    if (n <= 0 || n > capacity) {
      slot.ready = false;
      ++next_out;
      cv_space.notify_all();
      return n <= 0 ? -1 : -3;  // decode failure / caller buffer too small
    }
    std::memcpy(out, slot.data.data(), static_cast<size_t>(n) * sizeof(float));
    slot.ready = false;
    ++next_out;
    cv_space.notify_all();
    return n;
  }

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* dl_create(const char** paths, int n_paths, int n_threads, int depth) {
  if (n_paths <= 0 || n_threads <= 0 || depth <= 0) return nullptr;
  return new Loader(paths, n_paths, n_threads, depth);
}

int dl_next(void* h, float* out, int capacity) {
  return static_cast<Loader*>(h)->next(out, capacity);
}

void dl_destroy(void* h) { delete static_cast<Loader*>(h); }

int dl_decode_one(const char* path, float* out, int capacity, int* height, int* width) {
  std::vector<float> buf;
  int hh = 0, ww = 0;
  if (!decode_png_gray(path, buf, hh, ww)) return -1;
  *height = hh;
  *width = ww;
  const int n = hh * ww;
  if (n > capacity) return -3;
  std::memcpy(out, buf.data(), static_cast<size_t>(n) * sizeof(float));
  return n;
}

}  // extern "C"
