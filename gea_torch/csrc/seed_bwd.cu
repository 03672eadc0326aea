// The backward of the generator's seed segment (seed.cu):
//
//     pre = z @ Wp + bp          s = pre - trans (per channel c0)
//     h   = T(where(s < 0, slope * s, s) + trans)       reshaped (s0, s0, c0)
//     out = T(conv_transpose2d(h, Wc, stride 2, padding 1) + bc)
//
// For the cotangent g of out (in out's type), with T() rounding to z's type
// (fp32 or bf16) and every sum in fp32:
//
//     dbc         = sum_{n,y,x} g
//     dWc[kh, kw] = sum_{n,i,j} h[n,i,j]^T g[n, 2i-1+kh, 2j-1+kw]   (16 taps; outside rows 0)
//     dh          = T(sum_{kh,kw} g[n, 2i-1+kh, 2j-1+kw] @ Wc[kh,kw]^T)
//     ds          = T(where(s < 0, slope * dh, dh))
//     dslope      = sum where(s < 0, dh * s, 0)     dtrans = sum dh * (1 - fprime)
//     dbp = sum_n ds      dwp = z^T ds      dz = ds @ Wp^T
//
// This is gea/ops/pallas/seed.py::_bwd (jnp inside the custom_vjp of the
// pl.pallas_call in _forward), with the roundings of the port's plain
// version (gea_torch/ops/seed.py::fused_seed_backward_plain). The forward's
// transposed conv is not recomputed: no gradient needs its output.
//
// Bound on the H100: operations. At the G-LIS step's shape (256 codes, code
// 256, s0 5, c0 512, c1 256) one call is 58.7 GFLOP of bf16 products (the
// projection 1.7, dz 1.7, dwp 1.7, the conv's data and weight gradients
// 26.8 each), 59.4 us on the bf16 tensor cores (the projection's 1.7 run
// in fp64, below, whose tensor cores peak at 67 TFLOP/s).
//
// The projection is computed again exactly, in both types
// (seed_bwd_recompute: fp64 products and sums on the fp64 tensor cores,
// mma.sync m8n8k4, pre rounded once to fp32, then + bp, - trans in fp32):
// the TPReLU's branch (s < 0) decides where dh passes at the slope, and a
// sum in another order than the plain version's could land an s near 0 on
// the other side, moving a column of dwp by up to a tenth of its largest
// value. The plain versions compute pre the same way, so the two decide
// every branch alike. Its epilogue writes s in fp32 and, when dWc is asked
// for, h.
//
// bf16 design of the rest: three passes of one kernel template
// (seed_bwd_tc), each a sum of products on the tensor cores, wgmma with
// both operands read from shared memory, fed by TMA into a 3-deep ring (one
// thread issues, an mbarrier a slot), 128 x 128 output tiles, fp32
// accumulators:
//
//  D. The conv's data gradient dh: rows are the s0*s0 pixels of as many
//     whole images as fill 128 rows, columns c0, K = 16 taps x c1. For a
//     tap the A box is g at the tap's stride-2 positions: a 5-d tensor map
//     of g, (px and channel, w/2, py, h/2, image), read at the tap's parity
//     and shift, so TMA gathers the window and zero-fills the border. B is
//     Wc[kh, kw] read K-major from the HWIO weights in place.
//  Z. dz = ds @ Wp^T, both K-major; K = s0*s0*c0 split into fixed chunks
//     (the output has too few tiles to fill the card), fp32 partials.
//  W. A^T B over a list of (A plane, B plane) pairs, both N-major, K the
//     batch: dwp (z, ds) and dWc (one tap a block, over the tap's pixel
//     pairs (h[:, i, j], g[:, 2i-1+kh, 2j-1+kw]), each a 3-d map
//     (channels, pixels, batch) read one pixel plane a box).
//
// Between D and the rest, seed_bwd_act reads dh and s once, writes ds and
// per-chunk partial sums of ds (dbp), dh * s (dslope) and dh * (1 -
// fprime) (dtrans); seed_bwd_colsum takes partial column sums of g (dbc);
// seed_bwd_reduce sums every set of partials in a fixed order. There are no
// atomics: the gradients are the same bit for bit from run to run.
//
// The fp32 instance (TF32 would lose the fp32 tolerance) runs D, Z and W
// as simple tiled products on the CUDA cores (seed_bwd_f32: 64 x 64 tiles,
// 4 x 4 outputs a thread) with the same epilogues, and the same
// recompute, act, colsum and reduce kernels, so the same fixed-order sums.
//
// Only what is asked for is computed: dz alone (a frozen G) needs the
// recompute, D, act, Z and the reduce; no dWc skips h, no dbc the column
// sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

#include "wgmma.cuh"

namespace {

using gea::bf16;

enum Pass { kRecompute = 0, kData = 1, kDz = 2, kWeight = 3 };

struct Args {
  int batch, code, s0, c0, c1, proj;  // proj = s0 * s0 * c0
  int per;                            // D (bf16): whole images a block
  int k_chunk;                        // Z: k-steps of 64 a split
  int w_rows, w_cols, w_taps, w_bf16;  // W: output (taps or 1, rows, cols); w_taps 0 for dwp
  const void *z, *wp, *wc, *g;         // read by the fp32 passes (bf16: tensor maps)
  const float *bp, *slope, *trans;
  float* s;      // (batch, proj) fp32
  void* h;       // (batch, proj) in z's type, or null
  void* dh;      // (batch, proj)
  const void* ds;
  float* dz_part;  // (splits, batch, code)
  void* w_out;     // dwp (code, proj) or dWc (16, c0, c1)
  const void *a_src, *b_src;  // W, fp32: A(m, (pos, n)) = a_src[n * a_ld + plane_a * a_ps + m]
  long long a_ld, a_ps, b_ld, b_ps;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The pixels (i, j) of h whose tap (kh, kw) lands inside the output: i in
// [i0, i0 + ni), j in [j0, j0 + nj).
struct TapPositions {
  int i0, ni, j0, nj;
};
__host__ __device__ inline TapPositions tap_positions(int s0, int tap) {
  const int kh = tap >> 2, kw = tap & 3;
  return {kh == 0, s0 - (kh == 0) - (kh == 3), kw == 0, s0 - (kw == 0) - (kw == 3)};
}
// Position `pos` of the tap: the pixel plane of h (i * s0 + j) and of g
// ((2i - 1 + kh) * 2s0 + 2j - 1 + kw).
__device__ __forceinline__ void tap_planes(int s0, int tap, int pos, int& pa, int& pb) {
  const TapPositions t = tap_positions(s0, tap);
  const int i = t.i0 + pos / t.nj, j = t.j0 + pos % t.nj;
  pa = i * s0 + j;
  pb = (2 * i - 1 + (tap >> 2)) * 2 * s0 + 2 * j - 1 + (tap & 3);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// Stores v0 at p[0] and, where `both`, v1 at p[1]: one 8- or 4-byte store
// where the pair is aligned (always in bf16, whose bounds are multiples of
// 8), else two.
__device__ __forceinline__ void store2(float* p, float v0, float v1, bool both) {
  if (both && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (both) p[1] = v1;
  }
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1, bool both) {
  if (both && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (both) p[1] = __float2bfloat16_rn(v1);
  }
}

// Two neighbouring output elements of a pass, (row, col) and (row, col + 1)
// of its product (col even), `z` the block's split (Z) or tap (W).
template <int PASS, typename T>
__device__ __forceinline__ void epilogue(const Args& p, int row, int col, float v0, float v1,
                                         int z) {
  if (PASS == kRecompute) {
    if (row >= p.batch || col >= p.proj) return;
    const size_t o = (size_t)row * p.proj + col;
    const bool both = col + 1 < p.proj;
    float s[2], h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = (col + e) % p.c0;
      const float t = __ldg(p.trans + c), a = __ldg(p.slope + c);
      s[e] = __fsub_rn(__fadd_rn(e ? v1 : v0, __ldg(p.bp + col + (both ? e : 0))), t);
      h[e] = __fadd_rn(__fadd_rn(fmaxf(s[e], 0.f), __fmul_rn(a, fminf(s[e], 0.f))), t);
    }
    store2(p.s + o, s[0], s[1], both);
    if (p.h != nullptr) store2(static_cast<T*>(p.h) + o, h[0], h[1], both);
  } else if (PASS == kData) {
    if (row >= p.batch * p.s0 * p.s0 || col >= p.c0) return;
    store2(static_cast<T*>(p.dh) + (size_t)row * p.c0 + col, v0, v1, col + 1 < p.c0);
  } else if (PASS == kDz) {
    if (row >= p.batch || col >= p.code) return;
    store2(p.dz_part + ((size_t)z * p.batch + row) * p.code + col, v0, v1, col + 1 < p.code);
  } else {
    if (row >= p.w_rows || col >= p.w_cols) return;
    const size_t o = ((size_t)z * p.w_rows + row) * p.w_cols + col;
    const bool both = col + 1 < p.w_cols;
    if (p.w_bf16)
      store2(static_cast<bf16*>(p.w_out) + o, v0, v1, both);
    else
      store2(static_cast<float*>(p.w_out) + o, v0, v1, both);
  }
}

// ------------------------------------------------------------ the projection, exact

__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

constexpr int kRM = 64, kRN = 64, kRK = 32;  // block tile, k-step

// pre = z @ Wp in fp64 (products of bf16 or fp32 values are exact there),
// rounded once to fp32, then the kRecompute epilogue. 4 warps, 32 x 32
// outputs each as 4 x 4 m8n8 tiles. Fragments (g = lane / 4, t = lane % 4):
// A a0 (row g, k t), B b0 (k t, column g), D (row g, columns 2t, 2t + 1).
// Each thread loads 16-byte runs of z's rows (k) and Wp's rows (columns):
// code and s0 * s0 * c0 are multiples of 16 bytes' worth of T.
template <typename T>
__global__ void __launch_bounds__(128) seed_bwd_recompute(const Args p) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte load
  __shared__ double as[kRK][kRM + 4], bs[kRK][kRN + 4];
  const T* z = static_cast<const T*>(p.z);
  const T* wp = static_cast<const T*>(p.wp);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * kRM, n0 = blockIdx.y * kRN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  double acc[4][4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  for (int k0 = 0; k0 < p.code; k0 += kRK) {
    for (int e = tid; e < kRK * kRM / V; e += 128) {  // z: row mm, k run kk .. kk + V
      const int kk = (e % (kRK / V)) * V, mm = e / (kRK / V), m = m0 + mm, k = k0 + kk;
      alignas(16) T v[V];
      if (m < p.batch && k < p.code)
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(z + (size_t)m * p.code + k);
      else
        *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int q = 0; q < V; ++q) as[kk + q][mm] = (double)to_float(v[q]);
    }
    for (int e = tid; e < kRK * kRN / V; e += 128) {  // Wp: row kk, column run nn .. nn + V
      const int nn = (e % (kRN / V)) * V, kk = e / (kRN / V), n = n0 + nn, k = k0 + kk;
      alignas(16) T v[V];
      if (n < p.proj && k < p.code)
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(wp + (size_t)k * p.proj + n);
      else
        *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int q = 0; q < V; ++q) bs[kk][nn + q] = (double)to_float(v[q]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRK; kk += 4) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk + t][wm + 8 * i + g];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk + t][wn + 8 * j + g];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epilogue<kRecompute, T>(p, m0 + wm + 8 * i + g, n0 + wn + 8 * j + 2 * t,
                              __double2float_rn(acc[i][j][0]), __double2float_rn(acc[i][j][1]),
                              0);
}

// ------------------------------------------------------------ bf16, TMA + wgmma

constexpr int kNWG = 2;                     // warpgroups a block
constexpr int kThreadsTC = 128 * kNWG;
constexpr int kBM = 64 * kNWG, kBN = 128;   // output tile
constexpr int kTile = 128 * 128;            // bytes of the A or B tile of a k-step (64 k)
constexpr int kBox = 64 * 128;              // one 64 x 64 box
constexpr int kStage = 2 * kTile;
constexpr int kStages = 3;
constexpr int kSmemTC = kStages * kStage + 8 * kStages + 1024;  // + alignment to 1 KB

// One pass: D[row][col] = sum over the block's k-steps of A . B (see the top
// of this file for each pass's operands and maps).
template <int PASS>
__global__ void __launch_bounds__(kThreadsTC)
seed_bwd_tc(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const Args p) {
  // W reads both operands N-major (M and N contiguous), D and Z K-major.
  constexpr int MN = PASS == kWeight;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStage);
  const int tid = threadIdx.x, wg = tid / 128;
  const int area = p.s0 * p.s0;
  const int m0 = blockIdx.x * (PASS == kData ? p.per : kBM);  // first image (D) or row
  const int n0 = blockIdx.y * kBN;
  int kt0 = 0, kt1 = 0, nkc = 1;
  if (PASS == kData) {
    nkc = cdiv(p.c1, 64);
    kt1 = 16 * nkc;
  } else if (PASS == kDz) {
    kt0 = blockIdx.z * p.k_chunk;
    kt1 = min(kt0 + p.k_chunk, cdiv(p.proj, 64));
  } else {
    nkc = cdiv(p.batch, 64);
    const TapPositions t = tap_positions(p.s0, blockIdx.z);
    kt1 = (p.w_taps ? t.ni * t.nj : 1) * nkc;
  }
  // TMA counts a box's bytes whole, zero-filled parts included.
  const uint32_t a_bytes = PASS == kData ? p.per * area * 128 : kTile;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) gea::mbar_init(&full[s], 1);
    gea::mbar_init_fence();
  }
  __syncthreads();

  auto issue = [&](int kt) {
    const int slot = (kt - kt0) % kStages;
    unsigned char* sa = base + slot * kStage;
    unsigned char* sb = sa + kTile;
    uint64_t* bar = &full[slot];
    gea::mbar_expect_tx(bar, a_bytes + kTile);
    if (PASS == kData) {
      // g as (2 c1, s0, 2, s0, batch) box {64, s0, 1, s0, per} at the tap's
      // parity (px, py) and shift (dj, di); Wc (c1, c0, 16) box {64, 128, 1}.
      const int tap = kt / nkc, k0 = (kt - tap * nkc) * 64;
      const int kh = tap >> 2, kw = tap & 3, py = (kh + 1) & 1, px = (kw + 1) & 1;
      gea::tma_load_5d(sa, &map_a, px * p.c1 + k0, (kw - 1 - px) / 2, py, (kh - 1 - py) / 2, m0,
                       bar);
      gea::tma_load_3d(sb, &map_b, k0, n0, tap, bar);
    } else if (PASS == kDz) {  // ds (proj, batch) box {64, 128}; Wp (proj, code) box {64, 128}
      gea::tma_load_2d(sa, &map_a, kt * 64, m0, bar);
      gea::tma_load_2d(sb, &map_b, kt * 64, n0, bar);
    } else {  // (columns, planes, batch) boxes {64, 1, 64}
      const int pos = kt / nkc, k0 = (kt - pos * nkc) * 64;
      int pa = 0, pb = 0;
      if (p.w_taps) tap_planes(p.s0, blockIdx.z, pos, pa, pb);
#pragma unroll
      for (int w = 0; w < kNWG; ++w) gea::tma_load_3d(sa + w * kBox, &map_a, m0 + 64 * w, pa, k0, bar);
      gea::tma_load_3d(sb, &map_b, n0, pb, k0, bar);
      gea::tma_load_3d(sb + kBox, &map_b, n0 + 64, pb, k0, bar);
    }
  };
  if (tid == 0)
    for (int kt = kt0; kt < kt0 + kStages - 1 && kt < kt1; ++kt) issue(kt);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int it = kt - kt0, slot = it % kStages;
    if (it > 0) __syncthreads();  // every warpgroup retired its wgmma on slot (it - 1) % kStages
    if (tid == 0 && kt + kStages - 1 < kt1) issue(kt + kStages - 1);
    gea::mbar_wait(&full[slot], (it / kStages) & 1);
    // This warpgroup's 64 rows of A: rows 64 wg.. (K-major) or box wg (N-major).
    const unsigned char* sa = base + slot * kStage + wg * kBox;
    const unsigned char* sb = base + slot * kStage + kTile;
#pragma unroll
    for (int i = 0; i < 64; ++i) gea::reg_fence(acc[i]);
    gea::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t da = MN ? gea::wgmma_desc_sw128(sa + s * 2048, kBox, 1024)
                             : gea::wgmma_desc_sw128(sa + s * 32, 0, 1024);
      const uint64_t db = MN ? gea::wgmma_desc_sw128(sb + s * 2048, kBox, 1024)
                             : gea::wgmma_desc_sw128(sb + s * 32, 0, 1024);
      gea::wgmma_m64n128k16_ss<MN, MN>(acc, da, db);
    }
    gea::wgmma_commit();
    gea::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) gea::reg_fence(acc[i]);
  }

  // D fragment: acc[4j + 2h + e] at row 64 wg + 16 warp + g + 8h, column 8j + 2t + e.
  const int warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * wg + 16 * warp + g + 8 * h;
    const int row = PASS == kData ? (r < p.per * area ? m0 * area + r : INT_MAX) : m0 + r;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      epilogue<PASS, bf16>(p, row, n0 + 8 * j + 2 * t4, acc[4 * j + 2 * h],
                           acc[4 * j + 2 * h + 1], blockIdx.z);
  }
}

// ------------------------------------------------------------ fp32, CUDA cores

constexpr int kFT = 64, kFK = 16;  // output tile, k-step

template <int PASS>
__device__ __forceinline__ float a_f32(const Args& p, int m, int k) {
  if (PASS == kData) {
    const int tap = k / p.c1, c = k - tap * p.c1, area = p.s0 * p.s0, side = 2 * p.s0;
    const int img = m / area, rem = m - img * area, i = rem / p.s0, j = rem - i * p.s0;
    const int y = 2 * i - 1 + (tap >> 2), x = 2 * j - 1 + (tap & 3);
    if ((unsigned)y >= (unsigned)side || (unsigned)x >= (unsigned)side) return 0.f;
    return static_cast<const float*>(p.g)[(((size_t)img * side + y) * side + x) * p.c1 + c];
  }
  if (PASS == kDz) return static_cast<const float*>(p.ds)[(size_t)m * p.proj + k];
  const int pos = k / p.batch, n = k - pos * p.batch;
  int pa = 0, pb = 0;
  if (p.w_taps) tap_planes(p.s0, blockIdx.z, pos, pa, pb);
  return static_cast<const float*>(p.a_src)[n * p.a_ld + pa * p.a_ps + m];
}

template <int PASS>
__device__ __forceinline__ float b_f32(const Args& p, int k, int n) {
  const float* wp = static_cast<const float*>(p.wp);
  if (PASS == kData) {
    const int tap = k / p.c1, c = k - tap * p.c1;
    return static_cast<const float*>(p.wc)[((size_t)tap * p.c0 + n) * p.c1 + c];
  }
  if (PASS == kDz) return wp[(size_t)n * p.proj + k];
  const int pos = k / p.batch, b = k - pos * p.batch;
  int pa = 0, pb = 0;
  if (p.w_taps) tap_planes(p.s0, blockIdx.z, pos, pa, pb);
  return static_cast<const float*>(p.b_src)[b * p.b_ld + pb * p.b_ps + n];
}

template <int PASS>
__global__ void __launch_bounds__(256) seed_bwd_f32(const Args p) {
  __shared__ float as[kFK][kFT + 4], bs[kFK][kFT + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kFT, n0 = blockIdx.y * kFT;
  int rows, cols, k0 = 0, k1;
  if (PASS == kData) {
    rows = p.batch * p.s0 * p.s0, cols = p.c0, k1 = 16 * p.c1;
  } else if (PASS == kDz) {
    rows = p.batch, cols = p.code;
    k0 = blockIdx.z * p.k_chunk * 64;
    k1 = min(k0 + p.k_chunk * 64, p.proj);
  } else {
    const TapPositions t = tap_positions(p.s0, blockIdx.z);
    rows = p.w_rows, cols = p.w_cols, k1 = (p.w_taps ? t.ni * t.nj : 1) * p.batch;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kb = k0; kb < k1; kb += kFK) {
    for (int e = tid; e < kFK * kFT; e += 256) {
      const int kk = e % kFK, mm = e / kFK, k = kb + kk, m = m0 + mm;
      as[kk][mm] = k < k1 && m < rows ? a_f32<PASS>(p, m, k) : 0.f;
    }
    for (int e = tid; e < kFK * kFT; e += 256) {
      const int nn = e % kFT, kk = e / kFT, k = kb + kk, n = n0 + nn;
      bs[kk][nn] = k < k1 && n < cols ? b_f32<PASS>(p, k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      epilogue<PASS, float>(p, m0 + ty * 4 + i, n0 + tx * 4 + j, acc[i][j], acc[i][j + 1],
                            blockIdx.z);
}

// ------------------------------------------------------------ sums, both types

// ds from dh and s, and partial sums over `rows` codes a chunk (blockIdx.y)
// of ds (dbp), where(s < 0, dh * s) (dslope) and dh * (1 - fprime) (dtrans),
// one column of (batch, proj) a thread.
template <typename T>
__global__ void __launch_bounds__(256)
seed_bwd_act(const T* __restrict__ dh, const float* __restrict__ s, const float* __restrict__ slope,
             T* __restrict__ ds, float* __restrict__ part, int batch, int proj, int c0, int rows,
             int sums) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= proj) return;
  const int r0 = blockIdx.y * rows, r1 = min(batch, r0 + rows);
  const float a = __ldg(slope + col % c0), q = __fsub_rn(1.f, a);  // 1 - fprime where s < 0
  float sum_ds = 0.f, sum_slope = 0.f, sum_trans = 0.f;
  for (int n = r0; n < r1; ++n) {
    const size_t o = (size_t)n * proj + col;
    const float d = to_float(dh[o]), sv = s[o];
    const bool neg = sv < 0.f;
    const T v = from_float<T>(neg ? __fmul_rn(a, d) : d);
    ds[o] = v;
    sum_ds = __fadd_rn(sum_ds, to_float(v));
    if (neg) {
      sum_slope = __fadd_rn(sum_slope, __fmul_rn(d, sv));
      sum_trans = __fadd_rn(sum_trans, __fmul_rn(d, q));
    }
  }
  if (sums) {
    const size_t stride = (size_t)gridDim.y * proj, o = (size_t)blockIdx.y * proj + col;
    part[o] = sum_ds;
    part[stride + o] = sum_slope;
    part[2 * stride + o] = sum_trans;
  }
}

// Partial column sums of g (rows_total, cols), `rows` rows a chunk (blockIdx.y).
template <typename T>
__global__ void __launch_bounds__(256)
seed_bwd_colsum(const T* __restrict__ g, float* __restrict__ part, int rows_total, int cols,
                int rows) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= cols) return;
  const int r0 = blockIdx.y * rows, r1 = min(rows_total, r0 + rows);
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) acc = __fadd_rn(acc, to_float(g[(size_t)r * cols + col]));
  part[(size_t)blockIdx.y * cols + col] = acc;
}

// dst[c] = sum_{r < R} sum_{q < Q} src[(r Q + q) C + c], in that order; one
// set of partials a blockIdx.y.
struct Sum {
  const float* src;
  void* dst;
  int r, q, c, bf16;
};
struct Sums {
  Sum s[5];
};

__global__ void __launch_bounds__(256) seed_bwd_reduce(const Sums sums) {
  // 32 columns a block; the 8 warps take every 8th term, then warp 0 adds
  // their 8 sums in order.
  __shared__ float part[8][33];
  const Sum t = sums.s[blockIdx.y];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = blockIdx.x * 32 + lane;
  const int terms = t.r * t.q;
  float acc = 0.f;
  if (c < t.c)
    for (int i = w; i < terms; i += 8) acc = __fadd_rn(acc, t.src[(size_t)i * t.c + c]);
  part[w][lane] = acc;
  __syncthreads();
  if (w != 0 || c >= t.c) return;
  for (int k = 1; k < 8; ++k) acc = __fadd_rn(acc, part[k][lane]);
  if (t.bf16)
    static_cast<bf16*>(t.dst)[c] = __float2bfloat16_rn(acc);
  else
    static_cast<float*>(t.dst)[c] = acc;
}

// ------------------------------------------------------------ host

template <int PASS>
int launch_tc(const CUtensorMap& a, const CUtensorMap& b, const Args& p, dim3 grid,
              cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(seed_bwd_tc<PASS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemTC);
  if (err != cudaSuccess) return (int)err;
  seed_bwd_tc<PASS><<<grid, kThreadsTC, kSmemTC, st>>>(a, b, p);
  return (int)cudaGetLastError();
}

template <int PASS>
int launch_f32(const Args& p, dim3 grid, cudaStream_t st) {
  seed_bwd_f32<PASS><<<grid, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

typedef unsigned long long u64;
typedef cuuint64_t D;
typedef cuuint32_t B;

#define GEA_TRY(x)              \
  do {                          \
    const int rc_ = (x);        \
    if (rc_ != 0) return rc_;   \
  } while (0)

template <typename T>
int launch_sums(const Args& p, const u64* ptr, int need, int out_bf16, int splits, int act_rows,
                int colsum_rows, cudaStream_t st) {
  const int area = p.s0 * p.s0;
  const int chunks = cdiv(p.batch, act_rows);
  float* part_act = reinterpret_cast<float*>(ptr[12]);
  float* part_bc = reinterpret_cast<float*>(ptr[13]);
  Sums sums{};
  int n = 0;
  if (need & 1)
    sums.s[n++] = {p.dz_part, reinterpret_cast<void*>(ptr[14]), splits, 1, p.batch * p.code,
                   out_bf16 & 1};
  const size_t stride = (size_t)chunks * p.proj;
  if (need & 4) sums.s[n++] = {part_act, reinterpret_cast<void*>(ptr[16]), chunks, 1, p.proj, 0};
  if (need & 8)
    sums.s[n++] = {part_act + stride, reinterpret_cast<void*>(ptr[17]), chunks, area, p.c0, 0};
  if (need & 16)
    sums.s[n++] = {part_act + 2 * stride, reinterpret_cast<void*>(ptr[18]), chunks, area, p.c0, 0};
  if (need & 64) {
    const int rows_total = p.batch * 4 * area, gchunks = cdiv(rows_total, colsum_rows);
    seed_bwd_colsum<T><<<dim3(cdiv(p.c1, 256), gchunks), 256, 0, st>>>(
        static_cast<const T*>(p.g), part_bc, rows_total, p.c1, colsum_rows);
    GEA_TRY((int)cudaGetLastError());
    sums.s[n++] = {part_bc, reinterpret_cast<void*>(ptr[20]), gchunks, 1, p.c1, 0};
  }
  if (n == 0) return 0;
  int widest = 0;
  for (int i = 0; i < n; ++i) widest = sums.s[i].c > widest ? sums.s[i].c : widest;
  seed_bwd_reduce<<<dim3(cdiv(widest, 32), n), 256, 0, st>>>(sums);
  return (int)cudaGetLastError();
}

int backward(const u64* ptr, const int* dim, cudaStream_t st) {
  Args p{};
  p.batch = dim[0], p.code = dim[1], p.s0 = dim[2], p.c0 = dim[3], p.c1 = dim[4];
  const int is_bf16 = dim[5], need = dim[6], out_bf16 = dim[7];
  p.k_chunk = dim[8];
  const int act_rows = dim[9], colsum_rows = dim[10], splits = dim[11];
  const int s0 = p.s0, area = s0 * s0;
  p.proj = area * p.c0;
  p.z = reinterpret_cast<const void*>(ptr[0]);
  p.wp = reinterpret_cast<const void*>(ptr[1]);
  p.bp = reinterpret_cast<const float*>(ptr[2]);
  p.slope = reinterpret_cast<const float*>(ptr[3]);
  p.trans = reinterpret_cast<const float*>(ptr[4]);
  p.wc = reinterpret_cast<const void*>(ptr[5]);
  p.g = reinterpret_cast<const void*>(ptr[6]);
  p.s = reinterpret_cast<float*>(ptr[7]);
  p.dh = reinterpret_cast<void*>(ptr[9]);
  p.ds = reinterpret_cast<const void*>(ptr[10]);
  p.dz_part = reinterpret_cast<float*>(ptr[11]);
  const bool need_dh = need & 31, need_dwc = need & 32;
  p.h = need_dwc ? reinterpret_cast<void*>(ptr[8]) : nullptr;
  p.per = kBM / area;
  const int batch = p.batch, code = p.code, c0 = p.c0, c1 = p.c1, proj = p.proj;

  // Tensor maps of the bf16 passes: dims innermost first, byte strides of
  // the outer dims.
  CUtensorMap ma, mb;
  const int e = 2;
  auto make_map = [](CUtensorMap* m, const void* ptr_, int rank, std::initializer_list<D> dims,
                 std::initializer_list<D> strides, std::initializer_list<B> box) {
    return gea::tensor_map_bf16(m, ptr_, rank, dims.begin(), strides.begin(), box.begin());
  };
  if (is_bf16 && gea::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;

  if (need_dh || need_dwc) {  // the projection, exact
    const dim3 grid(cdiv(batch, kRM), cdiv(proj, kRN));
    if (is_bf16)
      seed_bwd_recompute<bf16><<<grid, 128, 0, st>>>(p);
    else
      seed_bwd_recompute<float><<<grid, 128, 0, st>>>(p);
    GEA_TRY((int)cudaGetLastError());
  }
  if (need_dh) {  // D, then ds and its sums
    if (is_bf16) {
      if (!make_map(&ma, p.g, 5, {(D)2 * c1, (D)s0, 2, (D)s0, (D)batch},
               {(D)2 * c1 * e, (D)2 * s0 * c1 * e, (D)4 * s0 * c1 * e, (D)4 * area * c1 * e},
               {64, (B)s0, 1, (B)s0, (B)p.per}) ||
          !make_map(&mb, p.wc, 3, {(D)c1, (D)c0, 16}, {(D)c1 * e, (D)c0 * c1 * e}, {64, kBN, 1}))
        return (int)cudaErrorInvalidValue;
      GEA_TRY(launch_tc<kData>(ma, mb, p, dim3(cdiv(batch, p.per), cdiv(c0, kBN)), st));
    } else {
      GEA_TRY(launch_f32<kData>(p, dim3(cdiv(batch * area, kFT), cdiv(c0, kFT)), st));
    }
    const dim3 grid(cdiv(proj, 256), cdiv(batch, act_rows));
    const int sums = (need & 28) != 0;
    float* part_act = reinterpret_cast<float*>(ptr[12]);
    if (is_bf16)
      seed_bwd_act<bf16><<<grid, 256, 0, st>>>(static_cast<const bf16*>(p.dh), p.s, p.slope,
                                               static_cast<bf16*>(const_cast<void*>(p.ds)),
                                               part_act, batch, proj, c0, act_rows, sums);
    else
      seed_bwd_act<float><<<grid, 256, 0, st>>>(static_cast<const float*>(p.dh), p.s, p.slope,
                                                static_cast<float*>(const_cast<void*>(p.ds)),
                                                part_act, batch, proj, c0, act_rows, sums);
    GEA_TRY((int)cudaGetLastError());
  }
  if (need & 1) {  // Z
    if (is_bf16) {
      if (!make_map(&ma, p.ds, 2, {(D)proj, (D)batch}, {(D)proj * e}, {64, kBM}) ||
          !make_map(&mb, p.wp, 2, {(D)proj, (D)code}, {(D)proj * e}, {64, kBN}))
        return (int)cudaErrorInvalidValue;
      GEA_TRY(launch_tc<kDz>(ma, mb, p, dim3(cdiv(batch, kBM), cdiv(code, kBN), splits), st));
    } else {
      GEA_TRY(launch_f32<kDz>(p, dim3(cdiv(batch, kFT), cdiv(code, kFT), splits), st));
    }
  }
  if (need & 2) {  // W: dwp = z^T ds
    Args w = p;
    w.w_rows = code, w.w_cols = proj, w.w_taps = 0, w.w_bf16 = (out_bf16 >> 1) & 1;
    w.w_out = reinterpret_cast<void*>(ptr[15]);
    w.a_src = p.z, w.a_ld = code, w.a_ps = 0, w.b_src = p.ds, w.b_ld = proj, w.b_ps = 0;
    if (is_bf16) {
      if (!make_map(&ma, p.z, 3, {(D)code, 1, (D)batch}, {(D)code * e, (D)code * e},
                    {64, 1, 64}) ||
          !make_map(&mb, p.ds, 3, {(D)proj, 1, (D)batch}, {(D)proj * e, (D)proj * e},
                    {64, 1, 64}))
        return (int)cudaErrorInvalidValue;
      GEA_TRY(launch_tc<kWeight>(ma, mb, w, dim3(cdiv(code, kBM), cdiv(proj, kBN), 1), st));
    } else {
      GEA_TRY(launch_f32<kWeight>(w, dim3(cdiv(code, kFT), cdiv(proj, kFT), 1), st));
    }
  }
  if (need_dwc) {  // W: dWc[tap] = sum over the tap's pixel pairs of h^T g
    Args w = p;
    w.w_rows = c0, w.w_cols = c1, w.w_taps = 16, w.w_bf16 = (out_bf16 >> 5) & 1;
    w.w_out = reinterpret_cast<void*>(ptr[19]);
    w.a_src = p.h, w.a_ld = proj, w.a_ps = c0, w.b_src = p.g, w.b_ld = 4 * area * c1,
    w.b_ps = c1;
    if (is_bf16) {
      if (!make_map(&ma, p.h, 3, {(D)c0, (D)area, (D)batch}, {(D)c0 * e, (D)proj * e},
                    {64, 1, 64}) ||
          !make_map(&mb, p.g, 3, {(D)c1, (D)4 * area, (D)batch}, {(D)c1 * e, (D)4 * area * c1 * e},
                    {64, 1, 64}))
        return (int)cudaErrorInvalidValue;
      GEA_TRY(launch_tc<kWeight>(ma, mb, w, dim3(cdiv(c0, kBM), cdiv(c1, kBN), 16), st));
    } else {
      GEA_TRY(launch_f32<kWeight>(w, dim3(cdiv(c0, kFT), cdiv(c1, kFT), 16), st));
    }
  }
  return is_bf16 ? launch_sums<bf16>(p, ptr, need, out_bf16, splits, act_rows, colsum_rows, st)
                 : launch_sums<float>(p, ptr, need, out_bf16, splits, act_rows, colsum_rows, st);
}

}  // namespace

// ptr: z, wp, bp, slope, trans, wc, g (inputs; z, wp, wc and g in the
// computing type, bp, slope and trans fp32), then the wrapper's scratch
// s (fp32), h, dh, ds, the dz partials, the act partials (3, chunks, proj)
// and the dbc partials, then the outputs dz, dwp, dbp, dslope, dtrans, dWc
// and dbc (dbp, dslope, dtrans and dbc fp32). dim: batch, code, s0, c0, c1,
// is_bf16, need (bit i for gradient i, in that order), bf16 outputs (bits
// 0, 1, 5 for dz, dwp, dWc), k-steps of 64 a dz split, codes an act chunk,
// rows of g a column-sum chunk, dz splits.
extern "C" int gea_seed_backward(const unsigned long long* ptr, const int* dim, void* stream) {
  return backward(ptr, dim, static_cast<cudaStream_t>(stream));
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
