// The generator's seed segment:
//
//     h   = T(tprelu(z @ Wp + bp))            reshaped (s0, s0, c0), channels fastest
//     out = T(conv_transpose2d(h, Wc, stride 2, padding 1) + bc)     NHWC
//
// where T() rounds to z's type (fp32 or bf16) and the products accumulate
// in fp32. Replaces gea/ops/pallas/seed.py::fused_seed (the pl.pallas_call
// in _forward); it does not include up1's activation, which follows it.
//
// The transposed conv is computed by output parity (du, dv): with Wc read
// at the flipped taps,
//
//     out[2i+du, 2j+dv] = sum_{a,b in {0,1}} h[i+du+a-1, j+dv+b-1] @ Wc[3-du-2a, 3-dv-2b]
//
// (h is zero outside 0..s0-1), so each of the 4 output phases is a sum of
// 4 dense (c0 -> c1) taps.
//
// Bound on the H100: operations. At the flagship shape (256 codes, code
// 256, s0 5, c0 512, c1 256) one call is 1.7 GFLOP of projection and
// 21.7 GFLOP of transposed conv (the (output pixel, tap) pairs that read
// inside the map, (4 s0 - 2)^2 an image), 23.7 us on the bf16 tensor
// cores.
//
// bf16 design: two launches of one kernel template (seed_tap_gemm), each a
// sum of products on the tensor cores (wgmma, fp32 accumulation), fed by
// TMA:
//
//  A. The projection: rows = codes, columns = s0*s0*c0, one tap. The
//     epilogue adds bp, applies the TPReLU in fp32 (channel = column % c0),
//     rounds to bf16 and writes the seed map (N, s0, s0, c0) NHWC into a
//     scratch buffer that the wrapper allocates. At the flagship the map is
//     6.6 MB and stays in the 50 MB L2 for pass B, as the TPU kernel kept
//     it in VMEM.
//  B. The transposed conv, one output parity a block (grid z): rows = the
//     s0*s0 pixels of as many whole images as fill 256 rows (10 at s0 = 5),
//     columns = 128 output channels, 4 taps. The block copies its images'
//     map rows once a k-step and each tap reads its shifted window of them
//     (the A operand is gathered row by row with ldmatrix), so the map
//     crosses L2 once per parity and channel tile, not once per tap. Wc is
//     read at the flipped taps through a (c1, c0, 16 taps) view, so no
//     flipped copy is made. The epilogue adds bc, rounds to bf16, stages the
//     tile in shared memory and stores 16-byte runs of output channels at
//     out[n, 2i+du, 2j+dv, :].
//
// What held earlier versions back, measured on the card: 16-byte cp.async
// copies capped the operand rate (the pass took as long with the products
// removed), and a per-element parameter load in the projection's epilogue
// cost more than its product. TMA boxes of 128-byte rows, and parameters
// loaded once per column pair, removed both.
//
// fp32 design (the port's exact mode; TF32 would lose the fp32 tolerance):
// the same two passes on the CUDA cores, each a launch of the register-
// tiled fp32 product core of sgemm_f32.cuh (128 x 128 tiles, 8 x 8 outputs
// a thread, operands brought in by cp.async into a ring, 2 blocks an SM):
//
//  A. seed_f32_project: rows = codes, columns = s0*s0*c0, K = code; the
//     epilogue adds bp, applies the TPReLU and writes the fp32 seed map
//     transposed, (s0*s0*c0, batch rounded up to a multiple of 4): 13.1 MB
//     at the flagship, held in L2 for pass B.
//  B. seed_f32_conv, one output parity a y-slice of the grid: rows = the
//     map's pixels, pixel-major in the parity's order (`parity_pixel`: the
//     pixels with 4 taps inside the map first; a tile is one or two pixel
//     positions of many images), columns = c1, K = 4 taps x c0. The
//     blocks start row tile by row tile, so every parity's costliest
//     tiles run first and the cheap border tiles fill the last wave
//     (400 tiles on 264 block slots at the flagship). Each tap gathers its
//     shifted window of the map, 4 images of a pixel in one 16-byte piece
//     of the transposed map (a table of each piece's source pixel a tap,
//     made once a tile), and reads Wc at the flipped tap in place; a tap
//     outside the image for every row of the tile is skipped, so the
//     border's zeros (a fifth of the taps at s0 = 5) cost nothing.
//
// So Wp and Wc cross L2 once per tile row and column, not once per pair of
// codes as in the one-launch kernel this replaces (128 blocks of 2 codes,
// 203 KB of shared memory each at s0 = 5, one resident a SM: 2.30 ms at
// config 5's shape against a 0.67 ms bound). Bound: operations, 23.4 GFLOP
// at the flagship (the conv's pairs inside the map), 0.350 ms at 67
// TFLOP/s of fp32 FFMA. s0 is a runtime argument (4..7); the grids come
// from the host's plan (ForwardPlan.dims).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_f32.cuh"
#include "wgmma.cuh"

namespace {

using gea::bf16;

__device__ __forceinline__ float tprelu(float s_in, float a, float t) {
  const float s = __fsub_rn(s_in, t);
  return __fadd_rn(__fadd_rn(fmaxf(s, 0.f), __fmul_rn(a, fminf(s, 0.f))), t);
}

// ------------------------------------------------------------ bf16, TMA + wgmma

// One pass of the seed segment as a sum over TAPS products on the tensor
// cores: D[r][n] = sum_t X[src_t(r)][:] . W_t[:, n], rows r of the block
// (wgmma's M, 64 per warpgroup), columns n0 .. n0 + NB (wgmma's N), over K
// in steps of 64.
//
// * X, row-major (rows, K), comes in one TMA box of kRows rows x 64
//   channels a step, 128-byte rows with the 128-byte swizzle. Each lane
//   gathers its A rows with ldmatrix, one shared-memory address a tap, so a
//   tap's shifted window costs nothing and a row outside the image reads a
//   zero row.
// * W_t, row-major (K, N), comes in NB / 64 TMA boxes of 64 k-rows x 64
//   columns a tap, with the 128-byte swizzle: MN-major, read by wgmma with
//   the transpose bit (next 8 k-rows 1 KB on, next 64 columns one box on).
// * One thread issues a step's copies into a STAGES-deep ring; an mbarrier
//   a slot says when they landed. The four 16-deep wgmma groups of a step
//   alternate between two sets of A registers.
template <int NWG, int STAGES, int TAPS>
struct TapGemm {
  static constexpr int kNB = 128;  // wgmma_m64n128k16_rs
  static constexpr int kThreads = 128 * NWG, kRows = 64 * NWG, kBK = 64, kTaps = TAPS;
  static constexpr int kXBytes = kRows * 128;
  static constexpr int kWBox = 64 * 128;
  static constexpr int kWBytes = (kNB / 64) * kWBox;
  static constexpr int kStage = kXBytes + TAPS * kWBytes;
  static constexpr int kStages = STAGES;
  static constexpr int kLdC = kNB + 8;
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kOut = kRows * kLdC * 2;
  static constexpr int kBar = kRing > kOut ? kRing : kOut;  // byte offset of the barriers
  static constexpr int kZero = kBar + 16 * STAGES;          // 16 bytes of zeros
  static constexpr int kSmemBytes = kZero + 16 + 1024;      // + alignment of the base to 1 KB
  static constexpr int kLbo = kWBox, kSbo = 1024;
};

// kProj: z (batch, code) x Wp -> TPReLU -> seed map. Otherwise: seed map x
// Wc taps of parity blockIdx.z -> + bias -> out interleaved.
template <typename Cfg, bool kProj>
__global__ void __launch_bounds__(Cfg::kThreads)
seed_tap_gemm(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
              const float* __restrict__ bias, const float* __restrict__ slope,
              const float* __restrict__ trans, bf16* __restrict__ out, int batch, int s0, int kdim,
              int ncols, int c0) {
  constexpr int NB = Cfg::kNB, TAPS = Cfg::kTaps, S = Cfg::kStages, T = Cfg::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Cfg::kBar);
  unsigned char* zero = base + Cfg::kZero;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int du = blockIdx.z >> 1, dv = blockIdx.z & 1;
  const int n0 = blockIdx.y * NB;
  const int area = s0 * s0;
  // Rows of the block: codes (kProj) or whole images of one parity.
  const int per = kProj ? Cfg::kRows : Cfg::kRows / area;
  const int first = blockIdx.x * per;  // first code or image
  const int rows = kProj ? min(per, batch - first) : min(per, batch - first) * area;
  const int x_row0 = kProj ? first : first * area;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) gea::mbar_init(&full[s], 1);
    gea::mbar_init_fence();
  }
  if (tid == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0, 0, 0, 0);

  // This lane's A row for each tap: its byte offset in an X slot and its
  // swizzle phase, or -1 for the zero row.
  const int r = 64 * wg + 16 * warp + (lane & 15), ch = lane >> 4;
  int x_row[TAPS], x_sw[TAPS];
  {
    const int rem = r % area, i = rem / s0, j = rem - (rem / s0) * s0;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const int di = kProj ? 0 : du + (t >> 1) - 1, dj = kProj ? 0 : dv + (t & 1) - 1;
      const bool ok = r < rows && (unsigned)(i + di) < (unsigned)s0 && (unsigned)(j + dj) < (unsigned)s0;
      const int src = r + di * s0 + dj;
      x_row[t] = ok ? src * 128 : -1;
      x_sw[t] = src & 7;
    }
  }
  const uint32_t zero_addr = gea::smem_u32(zero);
  const int k_tiles = (kdim + Cfg::kBK - 1) / Cfg::kBK;
  auto issue = [&](int kt) {
    unsigned char* st = base + (kt % S) * Cfg::kStage;
    gea::mbar_expect_tx(&full[kt % S], Cfg::kStage);
    gea::tma_load_2d(st, &map_x, kt * Cfg::kBK, x_row0, &full[kt % S]);
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      // Wp, or Wc[3 - du - 2a][3 - dv - 2b] as tap (kh * 4 + kw) of the 3-d view.
      const int tap = kProj ? 0 : (3 - du - 2 * (t >> 1)) * 4 + (3 - dv - 2 * (t & 1));
#pragma unroll
      for (int b = 0; b < NB / 64; ++b)
        gea::tma_load_3d(st + Cfg::kXBytes + t * Cfg::kWBytes + b * Cfg::kWBox, &map_w,
                         n0 + 64 * b, kt * Cfg::kBK, tap, &full[kt % S]);
    }
  };
  __syncthreads();  // barriers initialised, zero row written
  if (tid == 0)
    for (int kt = 0; kt < S - 1 && kt < k_tiles; ++kt) issue(kt);

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt > 0) __syncthreads();  // every warpgroup retired its wgmma on slot (kt - 1) % S
    if (tid == 0 && kt + S - 1 < k_tiles) issue(kt + S - 1);
    gea::mbar_wait(&full[kt % S], (kt / S) & 1);
    const unsigned char* st = base + (kt % S) * Cfg::kStage;
    const uint32_t x_addr = gea::smem_u32(st);
    uint32_t a[2][TAPS][4];
#pragma unroll
    for (int s = 0; s < Cfg::kBK / 16; ++s) {
      if (s >= 2) gea::wgmma_wait<1>();  // the group that read a[s & 1] has retired
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
        gea::ldmatrix_x4(a[s & 1][t], x_row[t] >= 0
                                          ? x_addr + x_row[t] + (((2 * s + ch) ^ x_sw[t]) << 4)
                                          : zero_addr);
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) gea::reg_fence(acc[i]);
      gea::wgmma_fence();
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
        gea::wgmma_m64n128k16_rs(
            acc, a[s & 1][t],
            gea::wgmma_desc_sw128(st + Cfg::kXBytes + t * Cfg::kWBytes + s * 2048, Cfg::kLbo,
                                  Cfg::kSbo));
      gea::wgmma_commit();
    }
    gea::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) gea::reg_fence(acc[i]);
  }
  __syncthreads();  // the ring is free for the staged output

  // D fragment: d[4j + e] at row 16 warp + g + 8 (e >> 1), column 8j + 2t + (e & 1).
  bf16* cs = reinterpret_cast<bf16*>(base);
  const int g = lane / 4, t4 = lane % 4;
  const int row = 64 * wg + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    const bool ok = col < ncols;
    const float b0 = ok ? __ldg(bias + col) : 0.f, b1 = ok ? __ldg(bias + col + 1) : 0.f;
    float v[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[2 * h] = __fadd_rn(acc[4 * j + 2 * h], b0);
      v[2 * h + 1] = __fadd_rn(acc[4 * j + 2 * h + 1], b1);
    }
    if (kProj) {
      const int c = ok ? col % c0 : 0;  // c0 is even: col and col + 1 are one channel pair
      const float a0 = __ldg(slope + c), a1 = __ldg(slope + c + 1);
      const float t0 = __ldg(trans + c), t1 = __ldg(trans + c + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[2 * h] = tprelu(v[2 * h], a0, t0);
        v[2 * h + 1] = tprelu(v[2 * h + 1], a1, t1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(cs + (row + 8 * h) * Cfg::kLdC + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
  }
  __syncthreads();
  const int side = 2 * s0;
  for (int q = tid; q < rows * (NB / 8); q += T) {
    const int rr = q / (NB / 8), c8 = q % (NB / 8);
    const int col = n0 + c8 * 8;
    if (col >= ncols) continue;
    size_t o;
    if (kProj) {
      o = (size_t)(first + rr) * ncols + col;
    } else {
      const int gi = rr / area, rem = rr - gi * area;
      const int i = rem / s0, j = rem - i * s0;
      o = (((size_t)(first + gi) * side + 2 * i + du) * side + 2 * j + dv) * ncols + col;
    }
    *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(cs + rr * Cfg::kLdC + c8 * 8);
  }
}

using ProjCfg = TapGemm<4, 4, 1>;
using ConvCfg = TapGemm<4, 2, 4>;

// A packed bf16 tensor of `rank` dims (innermost first) in boxes of `box`,
// 128-byte swizzle; reads past an edge land as zeros.
bool tensor_map(CUtensorMap* m, const void* p, int rank, const cuuint64_t* dims,
                const cuuint32_t* box) {
  cuuint64_t strides[2];
  cuuint64_t stride = 2;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  return gea::tensor_map_bf16(m, p, rank, dims, strides, box);
}

int launch_bf16(const void* z, const void* wp, const void* bp, const void* slope,
                const void* trans, const void* wc, const void* bc, void* map, void* out,
                int batch, int code, int s0, int c0, int c1, cudaStream_t stream) {
  using A = ProjCfg;
  using B = ConvCfg;
  if (gea::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int proj = s0 * s0 * c0;
  const cuuint64_t xa_dims[2] = {(cuuint64_t)code, (cuuint64_t)batch};
  const cuuint64_t wa_dims[3] = {(cuuint64_t)proj, (cuuint64_t)code, 1};
  const cuuint64_t xb_dims[2] = {(cuuint64_t)c0, (cuuint64_t)batch * s0 * s0};
  const cuuint64_t wb_dims[3] = {(cuuint64_t)c1, (cuuint64_t)c0, 16};
  const cuuint32_t xa_box[2] = {64, A::kRows}, xb_box[2] = {64, B::kRows}, w_box[3] = {64, 64, 1};
  CUtensorMap xa, wa, xb, wb;
  if (!tensor_map(&xa, z, 2, xa_dims, xa_box) || !tensor_map(&wa, wp, 3, wa_dims, w_box) ||
      !tensor_map(&xb, map, 2, xb_dims, xb_box) || !tensor_map(&wb, wc, 3, wb_dims, w_box))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(seed_tap_gemm<A, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, A::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(seed_tap_gemm<B, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_a((batch + A::kRows - 1) / A::kRows, (proj + A::kNB - 1) / A::kNB, 1);
  seed_tap_gemm<A, true><<<grid_a, A::kThreads, A::kSmemBytes, stream>>>(
      xa, wa, static_cast<const float*>(bp), static_cast<const float*>(slope),
      static_cast<const float*>(trans), static_cast<bf16*>(map), batch, s0, code, proj, c0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per = B::kRows / (s0 * s0);
  const dim3 grid_b((batch + per - 1) / per, (c1 + B::kNB - 1) / B::kNB, 4);
  seed_tap_gemm<B, false><<<grid_b, B::kThreads, B::kSmemBytes, stream>>>(
      xb, wb, static_cast<const float*>(bc), nullptr, nullptr, static_cast<bf16*>(out), batch,
      s0, c0, c1, c0);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32, CUDA cores

// Both passes are sgemm_f32.cuh's product core: 128 x 128 tiles, 8 x 8
// outputs a thread, a cp.async ring. The seed map passes between them
// transposed, (s0*s0*c0, batch_p) with the batch padded to batch_p, a
// multiple of 4, so that pass B's rows, pixel-major, come 4 images to a
// 16-byte piece.
struct F32Args {
  const float *z, *wp, *bp, *slope, *trans, *wc, *bc;
  float *map, *out;
  int batch, batch_p, code, s0, c0, c1, proj;
};

constexpr int kPieces = gea::sg::kBM / 4;   // 16-byte pieces of 4 rows a tile column
constexpr int kConvTable = 4 * kPieces;     // ints: a piece's map pixel a tap
constexpr int kConvSmem = gea::sg::kRingBytes + 4 * (kConvTable + gea::sg::kWalkInts);

// Pass A: map^T = tprelu(z @ Wp + bp)^T, (proj, batch_p) fp32. X = z, its
// k contiguous (4-byte copies); Y = Wp, its columns contiguous (16-byte).
// The rows past the batch read zeros (their map columns are never used).
// Grid (column tiles, row tiles).
__global__ void __launch_bounds__(gea::sg::kThreads, gea::sg::kBlocksPerSM)
seed_f32_project(const F32Args p) {
  namespace sg = gea::sg;
  extern __shared__ __align__(16) float ring[];
  const int n0 = blockIdx.x * sg::kBN, m0 = blockIdx.y * sg::kBM;
  const int xk = sg::cols_k(), yn = n0 + sg::rows_mn();
  unsigned rows_ok = 0;
#pragma unroll
  for (int q = 0; q < sg::kColCopies; ++q)
    rows_ok |= (unsigned)(m0 + sg::cols_mn(q) < p.batch) << q;
  const float* zrow = p.z + (size_t)(m0 + sg::cols_mn(0)) * p.code + xk;
  auto load = [&](float* st, int step) {
    const int k0 = step * sg::kBK;
    const bool kx = k0 + xk < p.code;
#pragma unroll
    for (int q = 0; q < sg::kColCopies; ++q) {
      const size_t dm = sg::cols_mn(q) - sg::cols_mn(0);
      const bool ok = kx && ((rows_ok >> q) & 1);
      sg::cp4(st + xk * sg::kLd + sg::cols_mn(q), ok ? zrow + dm * p.code + k0 : p.z, ok);
    }
#pragma unroll
    for (int q = 0; q < sg::kRowCopies; ++q) {
      const int k = k0 + sg::rows_k(q);
      const bool ok = k < p.code && yn < p.proj;
      sg::cp16(st + sg::kTile + sg::rows_k(q) * sg::kLd + sg::rows_mn(),
               ok ? p.wp + (size_t)k * p.proj + yn : p.wp, ok);
    }
  };
  float acc[8][8];
  sg::mainloop(ring, (p.code + sg::kBK - 1) / sg::kBK, load, acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = n0 + sg::out_col(h);  // proj and c0 are multiples of 4: 4 channels of a pixel
    if (col >= p.proj) continue;
    const int c = col % p.c0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float b = __ldg(p.bp + col + e), a = __ldg(p.slope + c + e);
      const float t = __ldg(p.trans + c + e);
#pragma unroll
      for (int g = 0; g < 2; ++g) {  // rows 4 ty .. 4 ty + 3 of each half: 4 images a store
        const int row = m0 + sg::out_row(4 * g);
        if (row >= p.batch_p) continue;
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = tprelu(__fadd_rn(acc[4 * g + r][4 * h + e], b), a, t);
        *reinterpret_cast<float4*>(p.map + (size_t)(col + e) * p.batch_p + row) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// The pixel at position q of output parity (du, dv)'s order: first the
// (s0-1)^2 pixels whose 4 taps all read inside the map, then the s0-1 of
// the edge column with 2, the s0-1 of the edge row with 2, the corner
// with 1. For du = 0 the edge row is i = 0 (tap a = 0 reads row -1), for
// du = 1 it is i = s0-1; likewise the column.
__device__ __forceinline__ void parity_pixel(int q, int du, int dv, int s0, int& i, int& j) {
  const int e = s0 - 1;
  int a, b;
  if (q < e * e) {
    a = q / e, b = q - a * e;
  } else if (q < e * e + e) {
    a = q - e * e, b = e;
  } else {
    a = e, b = q < e * e + 2 * e ? q - e * e - e : e;
  }
  i = a + 1 - du, j = b + 1 - dv;
  i = i == s0 ? 0 : i, j = j == s0 ? 0 : j;
}

// Pass B, output parity (du, dv) = blockIdx.y: row m = q * batch_p + n is
// image n (n >= batch: a padding row, skipped) at the parity's q-th pixel
// (i, j) (`parity_pixel`), columns c1, K = 4 taps x c0. X = the map at the
// tap's shifted pixel (i + du + a - 1, j + dv + b - 1), zero outside the
// image: in the transposed map 4 rows are 16 contiguous bytes. A table of
// each piece's map pixel a tap, and the taps with a row inside the image
// (`TapWalk`), are made once a tile. Y = Wc[3 - du - 2a, 3 - dv - 2b] in
// place, its output channels contiguous. Grid (column tiles, 4, row
// tiles): the blocks start in order of their row tile, so the tiles of
// every parity with 4 taps run first and those with fewer fill the tail.
__global__ void __launch_bounds__(gea::sg::kThreads, gea::sg::kBlocksPerSM)
seed_f32_conv(const F32Args p) {
  namespace sg = gea::sg;
  extern __shared__ __align__(16) float ring[];
  int* table = reinterpret_cast<int*>(ring + sg::kStages * sg::kStage);  // [tap][piece]
  int* walk = table + kConvTable;
  const int n0 = blockIdx.x * sg::kBN, m0 = blockIdx.z * sg::kBM;
  const int du = blockIdx.y >> 1, dv = blockIdx.y & 1;
  const int s0 = p.s0, rows = p.batch_p * s0 * s0;
  if (threadIdx.x == 0) walk[0] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < kConvTable; e += sg::kThreads) {
    const int t = e / kPieces, m = m0 + 4 * (e % kPieces);
    int off = -1;
    if (m < rows) {
      const int q = m / p.batch_p, n = m - q * p.batch_p;
      int i, j;
      parity_pixel(q, du, dv, s0, i, j);
      const int ii = i + du + (t >> 1) - 1, jj = j + dv + (t & 1) - 1;
      if ((unsigned)ii < (unsigned)s0 && (unsigned)jj < (unsigned)s0) {
        off = (ii * s0 + jj) * p.c0;
        if (n < p.batch) atomicOr(walk, 1 << t);
      }
    }
    table[e] = off;
  }
  __syncthreads();
  sg::tap_walk_set(walk);
  __syncthreads();
  const sg::TapWalk taps = sg::tap_walk(walk, p.c0);
  const int mn = sg::rows_mn(), yn = n0 + mn;
  const int n_piece = m0 + mn < rows ? (m0 + mn) % p.batch_p : 0;  // the piece's first image
  auto load = [&](float* st, int step) {
    int t, c;
    taps.at(step, t, c);
    const int off = table[t * kPieces + mn / 4];
    const int tap = (3 - du - 2 * (t >> 1)) * 4 + (3 - dv - 2 * (t & 1));
#pragma unroll
    for (int q = 0; q < sg::kRowCopies; ++q) {
      const int k = c + sg::rows_k(q);
      const bool okx = k < p.c0 && off >= 0;
      sg::cp16(st + sg::rows_k(q) * sg::kLd + mn,
               okx ? p.map + (size_t)(off + k) * p.batch_p + n_piece : p.map, okx);
      const bool oky = k < p.c0 && yn < p.c1;
      sg::cp16(st + sg::kTile + sg::rows_k(q) * sg::kLd + mn,
               oky ? p.wc + ((size_t)tap * p.c0 + k) * p.c1 + yn : p.wc, oky);
    }
  };
  float acc[8][8];
  sg::mainloop(ring, taps.steps(), load, acc);
  const int side = 2 * s0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + sg::out_row(i);
    if (m >= rows) continue;
    const int q = m / p.batch_p, n = m - q * p.batch_p;
    if (n >= p.batch) continue;
    int pi, pj;
    parity_pixel(q, du, dv, s0, pi, pj);
    float* o = p.out + (((size_t)n * side + 2 * pi + du) * side + 2 * pj + dv) * p.c1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + sg::out_col(h);  // c1 is a multiple of 4
      if (col >= p.c1) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(acc[i][4 * h + e], __ldg(p.bc + col + e));
      *reinterpret_cast<float4*>(o + col) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The grids, shared bytes and padded batch come from the host's plan
// (gea_torch/ops/seed.py::ForwardPlan.dims): batch_p, then for pass A and
// pass B the grid (x, y, z) and the shared bytes, which must be the
// kernels' own.
int launch_f32(const void* z, const void* wp, const void* bp, const void* slope,
               const void* trans, const void* wc, const void* bc, void* map, void* out,
               int batch, int code, int s0, int c0, int c1, const int* plan,
               cudaStream_t stream) {
  namespace sg = gea::sg;
  if (plan == nullptr || plan[4] != sg::kRingBytes || plan[8] != kConvSmem)
    return (int)cudaErrorInvalidValue;
  F32Args p{static_cast<const float*>(z), static_cast<const float*>(wp),
            static_cast<const float*>(bp), static_cast<const float*>(slope),
            static_cast<const float*>(trans), static_cast<const float*>(wc),
            static_cast<const float*>(bc), static_cast<float*>(map), static_cast<float*>(out),
            batch, plan[0], code, s0, c0, c1, s0 * s0 * c0};
  cudaError_t err = cudaFuncSetAttribute(seed_f32_project,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sg::kRingBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(seed_f32_conv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kConvSmem);
  if (err != cudaSuccess) return (int)err;
  seed_f32_project<<<dim3(plan[1], plan[2], plan[3]), sg::kThreads, sg::kRingBytes,
                     stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seed_f32_conv<<<dim3(plan[5], plan[6], plan[7]), sg::kThreads, kConvSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// z (N, code); wp (code, s0*s0*c0); wc (4, 4, c0, c1) HWIO, not flipped; bp,
// slope, trans, bc fp32; out (N, 2s0, 2s0, c1). `map` is the seed map
// scratch: bf16 (N, s0, s0, c0); fp32 transposed, (s0*s0*c0, N rounded up
// to a multiple of 4). `plan`: the fp32 plan (`launch_f32`); unread in bf16.
extern "C" int gea_seed_forward(const void* z, const void* wp, const void* bp,
                                const void* slope, const void* trans, const void* wc,
                                const void* bc, void* map, void* out, int batch, int code,
                                int s0, int c0, int c1, int is_bf16, const int* plan,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s0 < 4 || s0 > 7) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_bf16(z, wp, bp, slope, trans, wc, bc, map, out, batch, code, s0, c0, c1, s);
  return launch_f32(z, wp, bp, slope, trans, wc, bc, map, out, batch, code, s0, c0, c1, plan, s);
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
