// A register-tiled fp32 product core on the CUDA cores (sm_90a), shared by
// the fp32 instances of the seed segment's forward (seed.cu) and backward
// (seed_bwd.cu). Plain FFMA throughout: no TF32, so the fp32 instances keep
// fp32 arithmetic.
//
// A block of kThreads threads computes a kBM x kBN tile of
// D[m][n] = sum_k X(m, k) Y(k, n) in k-steps of kBK:
//
// * Both operands sit in shared memory k-major, [k][m] and [k][n], each
//   k-row padded to kLd floats. Each thread owns 8 x 8 outputs, rows
//   4 ty .. 4 ty + 3 and 64 + 4 ty .. 64 + 4 ty + 3, columns likewise from
//   tx, and reads them as 2 float4 of X and 2 float4 of Y a k: each shared
//   word feeds 8 FMAs. A warp is 4 ty x 8 tx, so a float4 load of X is 4
//   distinct words (a broadcast) and one of Y 128 contiguous bytes.
// * The caller's `load(slot, step)` brings k-step `step` of both operands
//   into a ring slot with cp.async: an operand whose rows (m or n) are
//   contiguous in memory comes in 16-byte pieces (`rows_*`), one whose k
//   is contiguous in 4-byte pieces written transposed (`cols_*`). The ring
//   is kStages deep, so the copies of later k-steps overlap the FMAs. A
//   piece outside the operand reads nothing and lands as zeros, so gathers
//   (a tap's shifted window of an image, the border) and the ragged edges
//   of M, N and K cost no branch in the product.
// * The convolutions' K is taps x channels; a tile's rows are one pixel
//   position of many images (the callers order rows pixel-major), so a tap
//   that lands outside the image for every row of the tile is skipped
//   whole (`TapWalk`), not summed as zeros.
// * kThreads = 256 threads at kBlocksPerSM = 2 blocks an SM (at most 128
//   registers a thread).
//
// What bounds it: FFMA issue. Per k a thread issues 64 FFMA and 4 LDS.128;
// the copies are kRowCopies (16-byte) or kColCopies (4-byte) instructions
// an operand a k-step. Taking the copies out made a pass about a quarter
// faster, and X in 16-byte pieces laid out [m][k] (4 k a float4 read) cost
// more registers than it saved (`scripts/torch_f32_variants.py`).

#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace gea {
namespace sg {

constexpr int kBM = 128, kBN = 128, kBK = 32;  // block tile and k-step
constexpr int kThreads = 256;                   // 16 x 16 threads of 8 x 8 outputs
constexpr int kStages = 2;                      // ring depth
constexpr int kBlocksPerSM = 2;                 // resident blocks an SM (launch bounds)
constexpr int kLd = kBM + 4;                    // floats a k-row of a tile in shared memory
constexpr int kTile = kBK * kLd;                // floats of one operand's tile
constexpr int kStage = 2 * kTile;               // X, then Y
constexpr int kRingBytes = kStages * kStage * 4;
static_assert(kBM == kBN, "one k-row stride for both operands");

// 4 bytes global -> shared, asynchronously (through L1: a transposed
// operand's neighbouring threads read neighbouring words); zero-filled
// where !ok, when nothing is read.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok ? 16 : 0);
}

// The pieces this thread copies a k-step of one operand. An operand whose
// rows (m or n) are contiguous: kRowCopies pieces of 4 consecutive rows,
// at k-row `rows_k(q)` and row `rows_mn()`. One whose k is contiguous:
// kColCopies single values, at k-row `cols_k()` and row `cols_mn(q)`.
constexpr int kRowCopies = kBK * kBM / 4 / kThreads;
constexpr int kColCopies = kBK * kBM / kThreads;
static_assert(kBM / 4 == 32 && kThreads % kBK == 0 && kRowCopies >= 1 && kColCopies <= 32,
              "copy assignment");
__device__ __forceinline__ int rows_k(int q) { return (int)threadIdx.x / 32 + (kThreads / 32) * q; }
__device__ __forceinline__ int rows_mn() { return 4 * ((int)threadIdx.x % 32); }
__device__ __forceinline__ int cols_k() { return (int)threadIdx.x % kBK; }
__device__ __forceinline__ int cols_mn(int q) {
  return (int)threadIdx.x / kBK + (kThreads / kBK) * q;
}

// This thread's outputs: ty picks rows, tx columns.
__device__ __forceinline__ int thread_ty() {
  return ((int)threadIdx.x >> 6) * 4 + (((int)threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int thread_tx() {
  return (((int)threadIdx.x >> 5) & 1) * 8 + ((int)threadIdx.x & 7);
}
// Local row of output row i (0..7) of the thread, local column of column
// group h (0, 1: 4 columns each).
__device__ __forceinline__ int out_row(int i) { return (i >> 2) * 64 + 4 * thread_ty() + (i & 3); }
__device__ __forceinline__ int out_col(int h) { return h * 64 + 4 * thread_tx(); }

__device__ __forceinline__ void tile_product(const float* xs, const float* ys, int ty, int tx,
                                             float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * kLd + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(xs + kk * kLd + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(ys + kk * kLd + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(ys + kk * kLd + 64 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc = the tile's sum over `steps` k-steps; `ring` holds kRingBytes of
// shared memory, `load(float* slot, int step)` copies k-step `step` of X
// to slot[0, kTile) and of Y to slot[kTile, kStage). Every thread of the
// block calls it. Each thread sums its k in order, so a tile's result
// depends on its inputs alone.
template <class Load>
__device__ __forceinline__ void mainloop(float* ring, int steps, const Load& load,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ty = thread_ty(), tx = thread_tx();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(ring + s * kStage, s);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step t landed for every thread; slot (t - 1) % kStages is free
    const int next = t + kStages - 1;
    if (next < steps) load(ring + (next % kStages) * kStage, next);
    cp_async_commit();
    const float* xs = ring + (t % kStages) * kStage;
    tile_product(xs, xs + kTile, ty, tx, acc);
  }
  cp_async_wait<0>();
}

// The taps a convolution's tile sums: its K is taps x `channels`, and it
// walks only the taps with at least one row of the tile inside the image,
// in order, each tap's `per_tap` k-steps of kBK channels. The list lives
// in shared memory (kWalkInts ints), made once a tile: `tap_walk_set`
// after every thread has or-ed its rows' taps into the mask word, between
// two barriers.
constexpr int kWalkInts = 18;  // the mask, the count, up to 16 taps
struct TapWalk {
  const int* list;  // count, then the taps
  int per_tap;
  __device__ __forceinline__ int steps() const { return list[0] * per_tap; }
  // (tap, first channel) of k-step `step`.
  __device__ __forceinline__ void at(int step, int& tap, int& c) const {
    const int i = step / per_tap;
    tap = list[1 + i];
    c = (step - i * per_tap) * kBK;
  }
};
// walk[0] is the mask the threads or-ed into; thread 0 writes the list
// after it (walk[1] the count, walk[2..] the taps).
__device__ __forceinline__ void tap_walk_set(int* walk) {
  if (threadIdx.x == 0) {
    const unsigned mask = (unsigned)walk[0];
    int n = 0;
    for (int t = 0; t < 16; ++t)
      if ((mask >> t) & 1) walk[2 + n++] = t;
    walk[1] = n;
  }
}
__device__ __forceinline__ TapWalk tap_walk(const int* walk, int channels) {
  return TapWalk{walk + 1, (channels + kBK - 1) / kBK};
}

}  // namespace sg
}  // namespace gea
