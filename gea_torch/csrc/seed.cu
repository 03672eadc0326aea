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
// 26.8 GFLOP of transposed conv, 28.8 us on the bf16 tensor cores.
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
// The fp32 instance stays on the CUDA cores (TF32 would lose the fp32
// tolerance): one block of kThreads threads per kCodes codes computes the
// projection and TPReLU into a zero-bordered map in shared memory, then
// each thread owns one (phase, output channel) item and keeps its
// kCodes * s0 * s0 outputs in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first, packed) in boxes of `box`,
// 128-byte swizzle; reads past an edge land as zeros.
bool tensor_map(CUtensorMap* m, const void* p, int rank, const cuuint64_t* dims,
                const cuuint32_t* box) {
  cuuint64_t strides[2];
  cuuint64_t stride = 2;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t one[3] = {1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims,
                        strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* z, const void* wp, const void* bp, const void* slope,
                const void* trans, const void* wc, const void* bc, void* map, void* out,
                int batch, int code, int s0, int c0, int c1, cudaStream_t stream) {
  using A = ProjCfg;
  using B = ConvCfg;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
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

constexpr int kCodes = 2;
constexpr int kThreads = 512;

template <int S0>
__global__ void __launch_bounds__(kThreads)
seed_kernel_f32(const float* __restrict__ z, const float* __restrict__ wp,
                const float* __restrict__ bp, const float* __restrict__ slope,
                const float* __restrict__ trans, const float* __restrict__ wc,
                const float* __restrict__ bc, float* __restrict__ out, int batch, int code,
                int c0, int c1) {
  constexpr int P = S0 + 2;  // side of the zero-bordered map
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* zs = reinterpret_cast<float*>(smem_raw);  // [kCodes][code]
  float* hp = zs + kCodes * code;                  // [kCodes][P][P][c0]
  const int n0 = blockIdx.x * kCodes;

  for (int i = threadIdx.x; i < kCodes * code; i += blockDim.x) {
    const int n = i / code;
    zs[i] = (n0 + n < batch) ? z[(size_t)n0 * code + i] : 0.f;
  }
  for (int i = threadIdx.x; i < kCodes * P * P * c0; i += blockDim.x) hp[i] = 0.f;
  __syncthreads();

  // Projection + TPReLU into the interior of hp.
  const int proj = S0 * S0 * c0;
  for (int p = threadIdx.x; p < proj; p += blockDim.x) {
    float acc[kCodes];
#pragma unroll
    for (int n = 0; n < kCodes; ++n) acc[n] = 0.f;
    for (int k = 0; k < code; ++k) {
      const float w = wp[(size_t)k * proj + p];
#pragma unroll
      for (int n = 0; n < kCodes; ++n) acc[n] = fmaf(zs[n * code + k], w, acc[n]);
    }
    const int c = p % c0;
    const int ij = p / c0;
    const int i = ij / S0, j = ij - (ij / S0) * S0;
    const float bpp = bp[p], a = slope[c], t = trans[c];
#pragma unroll
    for (int n = 0; n < kCodes; ++n)
      hp[((n * P + i + 1) * P + j + 1) * c0 + c] = tprelu(__fadd_rn(acc[n], bpp), a, t);
  }
  __syncthreads();

  // Transposed conv: one (phase, output channel) item per thread at a time.
  const int side = 2 * S0;
  for (int item = threadIdx.x; item < 4 * c1; item += blockDim.x) {
    const int phase = item / c1;
    const int co = item - phase * c1;
    const int du = phase >> 1, dv = phase & 1;
    float acc[kCodes][S0][S0];
#pragma unroll
    for (int n = 0; n < kCodes; ++n)
#pragma unroll
      for (int i = 0; i < S0; ++i)
#pragma unroll
        for (int j = 0; j < S0; ++j) acc[n][i][j] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int a = tap >> 1, b = tap & 1;
      const int oi = du + a, oj = dv + b;
      const float* wt = wc + (size_t)((3 - du - 2 * a) * 4 + (3 - dv - 2 * b)) * c0 * c1 + co;
      for (int ci = 0; ci < c0; ci += 4) {
        const float w0 = wt[(size_t)(ci + 0) * c1];
        const float w1 = wt[(size_t)(ci + 1) * c1];
        const float w2 = wt[(size_t)(ci + 2) * c1];
        const float w3 = wt[(size_t)(ci + 3) * c1];
#pragma unroll
        for (int n = 0; n < kCodes; ++n)
#pragma unroll
          for (int i = 0; i < S0; ++i)
#pragma unroll
            for (int j = 0; j < S0; ++j) {
              const float4 h =
                  *reinterpret_cast<const float4*>(&hp[((n * P + i + oi) * P + j + oj) * c0 + ci]);
              float v = acc[n][i][j];
              v = fmaf(h.x, w0, v);
              v = fmaf(h.y, w1, v);
              v = fmaf(h.z, w2, v);
              v = fmaf(h.w, w3, v);
              acc[n][i][j] = v;
            }
      }
    }
    const float bias = bc[co];
#pragma unroll
    for (int n = 0; n < kCodes; ++n) {
      if (n0 + n >= batch) break;
#pragma unroll
      for (int i = 0; i < S0; ++i)
#pragma unroll
        for (int j = 0; j < S0; ++j) {
          const size_t o = (((size_t)(n0 + n) * side + 2 * i + du) * side + 2 * j + dv) * c1 + co;
          out[o] = __fadd_rn(acc[n][i][j], bias);
        }
    }
  }
}

template <int S0>
int launch_f32(const void* z, const void* wp, const void* bp, const void* slope,
               const void* trans, const void* wc, const void* bc, void* out, int batch,
               int code, int c0, int c1, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kCodes * (code + (S0 + 2) * (S0 + 2) * c0);
  cudaError_t err = cudaFuncSetAttribute(
      seed_kernel_f32<S0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + kCodes - 1) / kCodes);
  seed_kernel_f32<S0><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(wp),
      static_cast<const float*>(bp), static_cast<const float*>(slope),
      static_cast<const float*>(trans), static_cast<const float*>(wc),
      static_cast<const float*>(bc), static_cast<float*>(out), batch, code, c0, c1);
  return (int)cudaGetLastError();
}

}  // namespace

// z (N, code); wp (code, s0*s0*c0); wc (4, 4, c0, c1) HWIO, not flipped; bp,
// slope, trans, bc fp32; out (N, 2s0, 2s0, c1). `map` is the bf16 scratch
// (N, s0, s0, c0) of the bf16 path (unused in fp32).
extern "C" int gea_seed_forward(const void* z, const void* wp, const void* bp,
                                const void* slope, const void* trans, const void* wc,
                                const void* bc, void* map, void* out, int batch, int code,
                                int s0, int c0, int c1, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(z, wp, bp, slope, trans, wc, bc, map, out, batch, code, s0, c0, c1, s);
  switch (s0) {
    case 4: return launch_f32<4>(z, wp, bp, slope, trans, wc, bc, out, batch, code, c0, c1, s);
    case 5: return launch_f32<5>(z, wp, bp, slope, trans, wc, bc, out, batch, code, c0, c1, s);
    case 6: return launch_f32<6>(z, wp, bp, slope, trans, wc, bc, out, batch, code, c0, c1, s);
    case 7: return launch_f32<7>(z, wp, bp, slope, trans, wc, bc, out, batch, code, c0, c1, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
