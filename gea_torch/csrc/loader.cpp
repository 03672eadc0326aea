// Native data loader for gea (TPU-native equivalent of the reference's
// DataLoader worker processes — the one place the reference's runtime
// leans on native code, via torch's C++ DataLoader machinery; here it is
// a standalone C++ library bound over ctypes).
//
// Pipeline per image: libjpeg decode (with DCT-domain 1/2^k prescaling
// capped so the crop region keeps >= out_size pixels), center crop of
// crop_size pixels AT NATIVE RESOLUTION (the reference's
// CenterCrop(crop_size) -> Resize order — field of view is exactly
// crop_size source pixels), bilinear box-resize of the crop to an
// out_size x out_size RGB square. A worker thread pool
// fills a ring of pre-allocated batch buffers (double buffering, depth
// GEA_RING) so the Python side always finds a ready batch: decode
// overlaps both host->device transfer and device compute.
//
// Build: g++ -O2 -shared -fPIC loader.cpp -ljpeg -lpthread -o _gealoader.so
// (driven by gea/data/native_build.py, cached by source mtime).

#include <cstddef>
#include <cstdio>  // must precede jpeglib.h (it uses FILE without including it)

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kRing = 4;

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to RGB. DCT-domain prescale shrinks the decode only
// while the centered crop region (crop_size native px, or the full short
// side if smaller) still spans >= out_size decoded pixels, so the final
// out_size square loses no detail. Returns native dims in (w0, h0) and
// decoded dims in (w, h); false on any decode error.
bool decode_jpeg(const char* path, int crop_size, int out_size,
                 std::vector<uint8_t>& pixels, int& w0, int& h0, int& w,
                 int& h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  w0 = cinfo.image_width;
  h0 = cinfo.image_height;
  // DCT-domain downscale: largest denominator that keeps the crop region
  // >= out_size decoded pixels — decodes up to 64x fewer pixels.
  int short_side = w0 < h0 ? w0 : h0;
  int cs = crop_size > 0 && crop_size < short_side ? crop_size : short_side;
  int denom = 1;
  while (denom < 8 && cs / (denom * 2) >= out_size) denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  pixels.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear resize (RGB u8) of a fractional source box (bx, by, bw, bh)
// inside (w, h) to (nw, nh) — crop and resize in one pass.
void resize_bilinear(const uint8_t* src, int w, int h, float bx, float by,
                     float bw, float bh, uint8_t* dst, int nw, int nh) {
  const float sx = bw / nw;
  const float sy = bh / nh;
  for (int y = 0; y < nh; ++y) {
    float fy = by + (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < nw; ++x) {
      float fx = bx + (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(static_cast<size_t>(y0) * w + x0) * 3 + c];
        float v01 = src[(static_cast<size_t>(y0) * w + x1) * 3 + c];
        float v10 = src[(static_cast<size_t>(y1) * w + x0) * 3 + c];
        float v11 = src[(static_cast<size_t>(y1) * w + x1) * 3 + c];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(static_cast<size_t>(y) * nw + x) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Full per-image op: decode -> center-crop crop_size px at native
// resolution -> resize the crop to out_size x out_size (one bilinear
// box-resize pass). Writes out_size*out_size*3 bytes.
bool decode_square(const char* path, int crop_size, int out_size,
                   uint8_t* out) {
  std::vector<uint8_t> pix;
  int w0 = 0, h0 = 0, w = 0, h = 0;
  if (!decode_jpeg(path, crop_size, out_size, pix, w0, h0, w, h))
    return false;
  int short_side = w0 < h0 ? w0 : h0;
  float cs = static_cast<float>(
      crop_size > 0 && crop_size < short_side ? crop_size : short_side);
  float sx = static_cast<float>(w) / w0;
  float sy = static_cast<float>(h) / h0;
  float bx = (w0 - cs) / 2 * sx;
  float by = (h0 - cs) / 2 * sy;
  if (w == w0 && h == h0) {
    // No DCT prescale: integer center crop for exact parity with the PIL
    // reference path (pipeline._decode: int(round(...)), Python rounds
    // half to even — nearbyint under the default FE_TONEAREST matches).
    // A fractional origin here would bilinearly blur every image whose
    // crop margin is odd.
    bx = std::nearbyintf((w0 - cs) / 2);
    by = std::nearbyintf((h0 - cs) / 2);
  }
  resize_bilinear(pix.data(), w, h, bx, by,
                  cs * sx, cs * sy, out, out_size, out_size);
  return true;
}

struct BatchBuffer {
  std::vector<uint8_t> data;
  long generation = 0;   // which batch index currently owns this buffer
  int remaining = 0;     // slots still to fill
  bool ready = false;
};

struct Loader {
  std::vector<std::string> paths;
  int batch;
  int crop_size;
  int out_size;
  size_t image_bytes;
  std::mt19937_64 rng;

  std::mutex mu;
  std::condition_variable cv_worker;
  std::condition_variable cv_consumer;
  std::vector<BatchBuffer> ring;
  std::vector<size_t> order;
  size_t order_pos = 0;
  long next_ticket = 0;   // global image slot counter
  long consume_gen = 0;   // next batch index the consumer takes
  bool stopping = false;
  std::vector<std::thread> workers;

  Loader(std::vector<std::string> p, int b, int c, int s, int nworkers,
         uint64_t seed, int64_t start_batch)
      : paths(std::move(p)), batch(b), crop_size(c), out_size(s),
        image_bytes(static_cast<size_t>(s) * s * 3), rng(seed) {
    ring.resize(kRing);
    for (int i = 0; i < kRing; ++i) {
      ring[i].data.resize(image_bytes * batch);
      ring[i].generation = i;
      ring[i].remaining = batch;
    }
    order.resize(paths.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::shuffle(order.begin(), order.end(), rng);
    // Deterministic mid-stream restart: advance the shuffle cursor past
    // the first start_batch batches without decoding them (the Python
    // backends' batches(start_batch=N) contract, pipeline.py). Must
    // replay the exact consumption rule of next_path_locked — one path
    // per image, reshuffle at exhaustion (batches may straddle epochs).
    int64_t skip = start_batch * batch;
    while (skip > 0) {
      int64_t left_in_epoch = static_cast<int64_t>(order.size() - order_pos);
      if (skip <= left_in_epoch) {
        order_pos += skip;
        break;
      }
      skip -= left_in_epoch;
      std::shuffle(order.begin(), order.end(), rng);
      order_pos = 0;
    }
    for (int i = 0; i < nworkers; ++i)
      workers.emplace_back([this] { worker_loop(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_worker.notify_all();
    cv_consumer.notify_all();
    for (auto& t : workers) t.join();
  }

  std::string next_path_locked() {
    if (order_pos >= order.size()) {
      std::shuffle(order.begin(), order.end(), rng);
      order_pos = 0;
    }
    return paths[order[order_pos++]];
  }

  void worker_loop() {
    for (;;) {
      long ticket;
      std::string path;
      BatchBuffer* buf;
      long gen;
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stopping) return;
        ticket = next_ticket++;
        gen = ticket / batch;
        slot = static_cast<int>(ticket % batch);
        buf = &ring[gen % kRing];
        // Assign the path at ticket issuance (same critical section), so
        // batch composition is a deterministic function of (seed, ticket)
        // — assigning after the wait would order paths by worker wake-up,
        // which varies run to run and would break deterministic resume.
        path = next_path_locked();
        // Wait until the consumer has freed this buffer for `gen`.
        cv_worker.wait(lk, [&] { return stopping || buf->generation == gen; });
        if (stopping) return;
      }
      uint8_t* dst = buf->data.data() + image_bytes * slot;
      int attempts = 0;
      while (!decode_square(path.c_str(), crop_size, out_size, dst)) {
        std::lock_guard<std::mutex> lk(mu);
        if (stopping) return;
        path = next_path_locked();
        if (++attempts > 32) {
          // Give up: zero-fill the slot so the batch still completes,
          // but say so — the interchangeable PIL backend fails fast on
          // the same input, and silent black images corrupt training.
          std::fprintf(stderr,
                       "[gea native loader] WARNING: %d consecutive decode "
                       "failures (last: %s); zero-filling one batch slot\n",
                       attempts, path.c_str());
          std::memset(dst, 0, image_bytes);
          break;
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (--buf->remaining == 0) {
          buf->ready = true;
          cv_consumer.notify_all();
        }
      }
    }
  }

  bool next(uint8_t* out) {
    std::unique_lock<std::mutex> lk(mu);
    long gen = consume_gen++;
    BatchBuffer* buf = &ring[gen % kRing];
    cv_consumer.wait(lk, [&] {
      return stopping || (buf->generation == gen && buf->ready);
    });
    if (stopping) return false;
    std::memcpy(out, buf->data.data(), image_bytes * batch);
    buf->generation = gen + kRing;
    buf->remaining = batch;
    buf->ready = false;
    cv_worker.notify_all();
    return true;
  }
};

}  // namespace

extern "C" {

int gea_decode_square(const char* path, int crop_size, int out_size,
                      uint8_t* out) {
  return decode_square(path, crop_size, out_size, out) ? 0 : 1;
}

void* gea_loader_create(const char** paths, int n_paths, int batch,
                        int crop_size, int out_size, int workers,
                        uint64_t seed, int64_t start_batch) {
  if (n_paths <= 0 || batch <= 0 || out_size <= 0 || start_batch < 0)
    return nullptr;
  std::vector<std::string> p(paths, paths + n_paths);
  if (workers < 1) workers = 1;
  return new Loader(std::move(p), batch, crop_size, out_size, workers, seed,
                    start_batch);
}

int gea_loader_next(void* handle, uint8_t* out) {
  return static_cast<Loader*>(handle)->next(out) ? 0 : 1;
}

void gea_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
