// The backward of one LIS link (lis.cu):
//
//     pre = z @ W1 + b1        s = pre - trans        neg = s < 0
//     h   = where(neg, slope * s, s) + trans
//     out = z + T(T(h) @ W2 + b2)
//
// For the cotangent g of out (in z's type), every sum in fp32 unless said:
//
//     dh  = g @ W2^T           fprime = where(neg, slope, 1)     dh_pre = dh * fprime
//     dz  = T(g + T(dh_pre) @ W1^T)      dW1 = z^T T(dh_pre)     db1 = sum_rows dh_pre
//     dW2 = T(h)^T g           db2 = sum_rows g
//     dslope = sum_rows where(neg, dh * s, 0)     dtrans = sum_rows dh * (1 - fprime)
//
// with T() rounding to z's type (fp32 or bf16). This is
// gea/ops/pallas/lis.py::_bwd (jnp inside the custom_vjp of the
// pl.pallas_call at :89), with the rounding points of the port's plain
// version (gea_torch/ops/lis.py::lis_residual_mlp_backward_plain): pre
// exact (fp64 products and sums, rounded once to fp32, then + b1 and -
// trans in fp32), h and dh_pre rounded to z's type before the products that
// take them, dW1 and dW2 written in their weights' type or fp32.
//
// Bound on the H100: launch latency. At the flagship shape (B = 64,
// C = H = 256) one call is 10 B C H = 42 MFLOP and moves about 0.6 MB, well
// under a microsecond either way; the eager version it replaces ran about
// 20 kernels. So the design is one launch that keeps every intermediate
// in shared memory. Inside it, what a block moves (its copies in, the
// exchange, its stores out) bounds it more than its arithmetic: the few
// SMs of one cluster each fill and drain at a small share of the card's
// rate, so the slices are spread over a cluster of 16 and every transfer
// is made of whole 16-byte pieces.
//
// The exact pre: the TPReLU's derivative jumps at s = 0, and an s within
// rounding of 0 that lands on the other side than in the plain version
// moves a whole column of dW1 (one of B terms by z (1 - slope) dh). Both
// compute pre the same way: products of bf16 or fp32 values are exact in
// fp64, and the fp64 sum rounds to the same fp32 value whatever its order
// (but for ties once in about 2^21 elements). Here it runs on the fp64
// tensor cores (mma.sync m16n8k16), 4.2 M FMAs a link.
//
// Design: one thread block cluster of kCluster = 16 blocks of 8 warps (16
// is above the portable cluster size of 8; the launch allows it). Block r
// owns hidden columns [r wh, +wh) and output columns [r wo, +wo) (H / 16
// and C / 16 rounded up to 16) and walks the batch in chunks of `rows` (64,
// or 32 or 16 where the widths need the room) rows:
//
//  1. copies in: each of the chunk's z and g rows once for the whole
//     cluster, by the block r = row mod 16, into every block's shared memory
//     (bulk copies multicast to the cluster, completing on each block's
//     mbarriers); and by cp.async, once, W1[:, hidden slice] with the bias,
//     slope and trans of the slice, W2[hidden slice, :] and W1[output
//     slice, :], in three groups;
//  2. s = pre + b1 - trans for (rows, hidden slice) in 16 x 8 tiles, pre on
//     the fp64 tensor cores as soon as z and W1's slice have landed; then,
//     once g has, in 16 x 16 tiles, dh on the bf16 ones, h, dh_pre, T(h)
//     and T(dh_pre) into shared memory and the column sums of dh_pre, dh s
//     and dh (1 - fprime), per tile across the warp by shuffles, then over
//     the tiles in order;
//  3. the block's T(dh_pre) slice goes to every block's full rows, one bulk
//     copy a block (distributed shared memory, completing on their
//     mbarriers), while
//  4. dW1[:, hidden slice] = z^T T(dh_pre) and dW2[hidden slice, :] =
//     T(h)^T g run, K = the chunk's rows, and db2 = the column sums of g;
//  5. once every slice has landed, dz[:, output slice] = g + T(dh_pre) @
//     W1[output slice, :]^T. Each output tile of 4 and 5 goes out through a
//     staging tile in 16-byte stores;
//
// so every sum a block takes is over its own rows and columns. Across
// chunks the weight gradients add up in a fixed order in an fp32 scratch
// (`carry`, only where the batch spans more than one chunk) and the column
// sums in shared memory. There are no atomics: the gradients are the same
// bit for bit from run to run. bf16 products are mma.sync m16n8k16 with
// fp32 accumulation; the fp32 instance runs them on the CUDA cores (TF32
// would lose the fp32 tolerance) with each thread computing the same
// elements, and the same exact pre. Only what `need` asks for is computed:
// dz alone (a frozen link) skips the weight products, h and the sums.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using gea::bf16;
namespace cg = cooperative_groups;

constexpr int kCluster = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;
constexpr int kStageBytes = 16 * (16 * 4 + 16);  // a warp's staging tile (store_tile), fp32 at most

enum Need { kDz = 1, kDw1 = 2, kDb1 = 4, kDslope = 8, kDtrans = 16, kDw2 = 32, kDb2 = 64 };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Args {
  const void *z, *w1, *w2, *g;  // in the computing type
  const float *b1, *slope, *trans;
  void *dz, *dw1, *dw2;  // dz in the computing type; dW1, dW2 in bf16 or fp32 (w1_f32, w2_f32)
  float *db1, *dslope, *dtrans, *db2;
  float* carry;  // (C H + H C) fp32 sums of dW1, dW2 over the chunks so far, or null
  int batch, code, hidden, rows, need, w1_f32, w2_f32;
};

// Shared memory of one block: offsets in elements of the computing type,
// rows padded by 8 elements (16 bytes in bf16), then (in bytes) the fp32
// vectors, the warps' staging tiles and the mbarriers.
struct Layout {
  int kz, wh, wo, hf, ld_z, ld_h, ld_f;
  int zs, gs, w1s, w2s, w1r, hs, ps, fs;
  int vec, stg, bar, bytes;  // byte offsets of the fp32 vectors, staging tiles, mbarriers
  __host__ __device__ Layout(int code, int hidden, int rows, int esize) {
    kz = round_up(code, 16);
    wh = round_up(cdiv(hidden, kCluster), 16);
    wo = round_up(cdiv(code, kCluster), 16);
    hf = kCluster * wh;
    ld_z = kz + 8;
    ld_h = wh + 8;
    ld_f = hf + 8;
    zs = 0;                    // z chunk       (rows, kz)
    gs = zs + rows * ld_z;     // g chunk       (rows, kz)
    w1s = gs + rows * ld_z;    // W1[:, slice]  (kz, wh)
    w2s = w1s + kz * ld_h;     // W2[slice, :]  (wh, kz)
    w1r = w2s + wh * ld_z;     // W1[out slice, :] (wo, hf)
    hs = w1r + wo * ld_f;      // T(h) slice    (rows, wh)
    ps = hs + rows * ld_h;     // T(dh_pre) slice (rows, wh), copied to every block
    fs = ps + rows * ld_h;     // T(dh_pre) full rows, each block's slice apart (16, rows, wh)
    vec = round_up((fs + kCluster * rows * ld_h) * esize, 16);
    // b1, slope, trans of the slice; the running sums of db1, dslope,
    // dtrans and db2; the per-tile column sums of a chunk; s of the chunk;
    // then each warp's staging tile.
    stg = round_up(vec + 4 * (6 * wh + wo + rows / 16 * 3 * wh + rows * wh), 16);
    bar = stg + kWarps * kStageBytes;  // the mbarriers of the copies of z, g, the slices
    bytes = bar + 24;
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// Two neighbouring elements (p 4-byte aligned in bf16).
__device__ __forceinline__ void store2(float* p, float v0, float v1) { p[0] = v0, p[1] = v1; }
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Rows [0, nr) x columns [0, nc) of a row-major source (row stride ld_src)
// into shared memory (row stride ld) in 16-byte pieces; pieces at row >=
// rows or column >= cols are zero-filled (`base` is then the address given).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, size_t ld_src, int nr, int nc,
                                      int rows, int cols, const void* base) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = nc / V;
  for (int q = threadIdx.x; q < nr * per_row; q += kThreads) {
    const int r = q / per_row, c = (q % per_row) * V;
    const bool ok = r < rows && c < cols;
    gea::cp_async16(dst + r * ld + c, ok ? static_cast<const void*>(src + r * ld_src + c) : base,
                    ok ? 16 : 0);
  }
}

// ------------------------------------------------------------ 16 x 16 tile products
//
// acc[nt][e] (e < 2: row g, e >= 2: row g + 8; column nt * 8 + 2t + e % 2)
// += sum over k < k_end of A(m, k) B(k, n), with A K-contiguous (a[m * lda +
// k]) or M-contiguous (a[k * lda + m]) and B K-contiguous (b[n * ldb + k])
// or N-contiguous (b[k * ldb + n]). The layout of mma.m16n8k16's C
// fragment (mma.cuh); g = lane / 4, t = lane % 4.

template <bool AK, bool BK>
__device__ __forceinline__ void tile16(float (&acc)[2][4], const bf16* a, int lda, const bf16* b,
                                       int ldb, int k_end) {
  const int l = threadIdx.x % 32, j = l >> 3;
  // Each lane's row address: A's fragment a0..a3 and B's (b0, b1) of both
  // n8 tiles, from ldmatrix.x4 (.trans where the operand is stored the
  // other way round).
  const bf16* pa = AK ? a + (l & 15) * lda + (l >> 4) * 8
                      : a + ((l & 7) + (j >> 1) * 8) * lda + (j & 1) * 8;
  const bf16* pb = BK ? b + ((l & 7) + (j >> 1) * 8) * ldb + (j & 1) * 8
                      : b + ((l & 7) + (j & 1) * 8) * ldb + (j >> 1) * 8;
  auto step = [&](float (&d)[2][4], int k) {
    uint32_t af[4], bfr[4];
    if (AK)
      gea::ldmatrix_x4(af, pa + k);
    else
      gea::ldmatrix_x4_trans(af, pa + (size_t)k * lda);
    if (BK)
      gea::ldmatrix_x4(bfr, pb + k);
    else
      gea::ldmatrix_x4_trans(bfr, pb + (size_t)k * ldb);
    gea::mma_bf16(d[0], af, bfr[0], bfr[1]);
    gea::mma_bf16(d[1], af, bfr[2], bfr[3]);
  };
  // Two independent accumulator chains (even and odd k-steps), added at
  // the end: the chains' latency, not the tensor cores, bounds a warp.
  float odd[2][4] = {};
  for (int k = 0; k < k_end; k += 32) {
    step(acc, k);
    if (k + 16 < k_end) step(odd, k + 16);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], odd[nt][e]);
}

template <bool AK, bool BK>
__device__ __forceinline__ void tile16(float (&acc)[2][4], const float* a, int lda, const float* b,
                                       int ldb, int k_end) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  for (int k = 0; k < k_end; ++k) {
    const float a0 = AK ? a[g * lda + k] : a[k * lda + g];
    const float a1 = AK ? a[(g + 8) * lda + k] : a[k * lda + g + 8];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t + e;
        const float bv = BK ? b[n * ldb + k] : b[k * ldb + n];
        acc[nt][e] = fmaf(a0, bv, acc[nt][e]);
        acc[nt][2 + e] = fmaf(a1, bv, acc[nt][2 + e]);
      }
  }
}

// D (16 x 8) += A (16 x 16) B (16 x 8) in fp64 on the tensor cores (sm_90).
// Fragments (g = lane / 4, t = lane % 4): a[2i] (row g, k t + 4i), a[2i + 1]
// (row g + 8, k t + 4i), b[i] (k t + 4i, column g), d as mma.m16n8k16's C.
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Four adjacent elements, as doubles (exact).
__device__ __forceinline__ void load4(double (&v)[4], const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void load4(double (&v)[4], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

// pre[half][e] = the exact sum over k < k_end of A(m, k) B(k, n), A
// K-contiguous (z rows), B N-contiguous (W1 columns), for the thread's
// elements of a 16 x 8 tile: row g + 8 half, column 2t + e. One fp64
// m16n8k16 product a block of 16 k, in which lane t's fragment slots t +
// 4i hold k = k0 + 4t + i (any order of the k within the block gives the
// same sum): its four A values of a row are adjacent, one vector load.
// Even and odd blocks feed two accumulator chains. Products of bf16 or
// fp32 values are exact in fp64, and the fp64 sum of C of them rounds to
// the same fp32 value in any order but for ties.
template <typename T>
__device__ __forceinline__ void tile8_exact(double (&pre)[2][2], const T* a, int lda, const T* b,
                                            int ldb, int k_end) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  double acc[2][4] = {};
  const T *a0p = a + g * lda + 4 * t, *a1p = a0p + 8 * lda, *bp = b + 4 * t * ldb + g;
  auto step = [&](double(&d)[4], int k0) {
    double a0[4], a1[4], af[8], bv[4];
    load4(a0, a0p + k0);
    load4(a1, a1p + k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      af[2 * i] = a0[i];
      af[2 * i + 1] = a1[i];
      bv[i] = to_float(bp[(k0 + i) * ldb]);
    }
    dmma16(d, af, bv);
  };
  for (int k0 = 0; k0 < k_end; k0 += 32) {
    step(acc[0], k0);
    if (k0 + 16 < k_end) step(acc[1], k0 + 16);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 2; ++e) pre[half][e] = acc[0][2 * half + e] + acc[1][2 * half + e];
}

// A 16 x 16 tile of an output, the thread's elements in tile16's layout,
// through the warp's staging tile in shared memory (16 rows of 16 elements
// and 16 bytes) to rows < nr and columns < nc of dst (row stride ld), in
// 16-byte stores of whole rows: a warp writes the tile in one or two
// stores, not eight of scattered 4-byte pieces. nc is a multiple of 16
// bytes' worth of O.
template <typename O>
__device__ __forceinline__ void store_tile(unsigned char* stage, const float (&v)[2][4], O* dst,
                                           size_t ld, int nr, int nc) {
  constexpr int V = 16 / sizeof(O), LD = 16 + V;
  O* s = reinterpret_cast<O*>(stage);
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      store2(s + (g + 8 * half) * LD + nt * 8 + 2 * t, v[nt][2 * half], v[nt][2 * half + 1]);
  __syncwarp();
#pragma unroll
  for (int q = l; q < 16 * (16 / V); q += 32) {
    const int r = q / (16 / V), c = (q % (16 / V)) * V;
    if (r < nr && c < nc)
      *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(s + r * LD + c);
  }
  __syncwarp();
}

// A weight gradient's 16 x 16 tile at (m0, n0) of out (row stride ld; nr x
// nc of it inside): the chunk's sums, added to those of the chunks before
// it (in order) and kept in `carry` until the last chunk, which writes the
// tile in the weight's type.
__device__ __forceinline__ void put_weight(unsigned char* stage, float (&v)[2][4], void* out,
                                           int is_f32, float* carry, size_t m0, int n0,
                                           size_t ld, int nr, int nc, int chunk, int chunks) {
  if (chunks > 1) {
    const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g + 8 * half, c = nt * 8 + 2 * t;
        if (r >= nr || c >= nc) continue;
        float* cp = carry + (m0 + r) * ld + n0 + c;
        float &v0 = v[nt][2 * half], &v1 = v[nt][2 * half + 1];
        if (chunk > 0) v0 = __fadd_rn(cp[0], v0), v1 = __fadd_rn(cp[1], v1);
        if (chunk + 1 < chunks) cp[0] = v0, cp[1] = v1;
      }
    if (chunk + 1 < chunks) return;
  }
  const size_t o = m0 * ld + n0;
  if (is_f32)
    store_tile(stage, v, static_cast<float*>(out) + o, ld, nr, nc);
  else
    store_tile(stage, v, static_cast<bf16*>(out) + o, ld, nr, nc);
}

// `bytes` from global src to dst in the shared memory of every block of the
// cluster (the same offset in each), completing on each block's `bar`.
__device__ __forceinline__ void bulk_to_cluster(void* dst, const void* src, uint32_t bytes,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(gea::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(gea::smem_u32(bar)), "h"((uint16_t)((1u << kCluster) - 1))
      : "memory");
}

// `bytes` of this block's shared memory at src into block `rank`'s at dst
// (an offset in this block's), completing on that block's `bar`.
__device__ __forceinline__ void bulk_to_block(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar, int rank) {
  uint32_t rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(gea::smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(gea::smem_u32(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(rdst), "r"(gea::smem_u32(src)), "r"(bytes), "r"(rbar)
      : "memory");
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
lis_bwd_kernel(const Args p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Layout L(p.code, p.hidden, p.rows, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T *zs = smem + L.zs, *gs = smem + L.gs, *w1s = smem + L.w1s, *w2s = smem + L.w2s;
  T *w1r = smem + L.w1r, *hs = smem + L.hs, *ps = smem + L.ps, *fs = smem + L.fs;
  float* b1s = reinterpret_cast<float*>(smem_raw + L.vec);
  float *as = b1s + L.wh, *ts = as + L.wh, *sums = ts + L.wh, *sum_b2 = sums + 3 * L.wh;
  float* part = sum_b2 + L.wo;  // [rows / 16][3][wh]
  float* ss = part + p.rows / 16 * 3 * L.wh;  // s = pre + b1 - trans, [rows][wh]
  const T *z = static_cast<const T*>(p.z), *g = static_cast<const T*>(p.g);
  const T *w1 = static_cast<const T*>(p.w1), *w2 = static_cast<const T*>(p.w2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, lg = lane / 4, lt = lane % 4;
  unsigned char* stg = smem_raw + L.stg + warp * kStageBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L.bar);  // z's, g's, the slices
  const int h0 = rank * L.wh, o0 = rank * L.wo;
  const int code = p.code, hidden = p.hidden, rows = p.rows;
  const bool need_pre = p.need & (kDz | kDw1 | kDb1 | kDslope | kDtrans | kDw2);
  const bool need_dh = p.need & (kDz | kDw1 | kDb1 | kDslope | kDtrans);
  const bool need_sums = p.need & (kDb1 | kDslope | kDtrans);
  const bool need_dhp = p.need & (kDz | kDw1), need_h = p.need & kDw2, need_dz = p.need & kDz;
  const int chunks = cdiv(p.batch, rows);
  if (threadIdx.x == 0) {
    gea::mbar_init(bar, 1);
    gea::mbar_init(bar + 1, 1);
    gea::mbar_init(bar + 2, 1);
    gea::mbar_init_fence();
  }
  // Every block's mbarriers are set before any copy lands in it: arrive
  // here, wait just before the first copies are issued.
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");

  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int r0 = chunk * rows, nrows = min(rows, p.batch - r0);
    // z and g: every block reads all their rows, so each row is copied once
    // for the cluster (the rows r = rank mod 16 by this block) into every
    // block, completing on the blocks' mbarriers; rows beyond the batch and
    // columns beyond code are zeroed here. W1's and W2's slices and the
    // vectors, and W1's output rows, in three cp.async groups; the last
    // lands while pre and dh run.
    if (chunk > 0) cluster.sync();  // every block has read the chunk before's rows
    if (need_pre && chunk == 0) {
      stage(w1s, L.ld_h, w1 + h0, hidden, L.kz, L.wh, code, hidden - h0, w1);
      stage(b1s, 0, p.b1 + h0, 0, 1, L.wh, 1, hidden - h0, p.b1);
      stage(as, 0, p.slope + h0, 0, 1, L.wh, 1, hidden - h0, p.slope);
      stage(ts, 0, p.trans + h0, 0, 1, L.wh, 1, hidden - h0, p.trans);
    }
    gea::cp_async_commit();
    if (chunk == 0 && need_dh)
      stage(w2s, L.ld_z, w2 + (size_t)h0 * code, code, L.wh, L.kz, hidden - h0, code, w2);
    gea::cp_async_commit();
    if (chunk == 0 && need_dz)
      stage(w1r, L.ld_f, w1 + (size_t)o0 * hidden, hidden, L.wo, L.hf, code - o0, hidden, w1);
    gea::cp_async_commit();
    constexpr int V = 16 / sizeof(T);
    if (nrows < rows || code < L.kz)
      for (int q = threadIdx.x; q < rows * (L.kz / V); q += kThreads) {
        const int r = q / (L.kz / V), c = (q % (L.kz / V)) * V;
        if (r < nrows && c < code) continue;
        if (need_pre) *reinterpret_cast<uint4*>(zs + r * L.ld_z + c) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(gs + r * L.ld_z + c) = make_uint4(0, 0, 0, 0);
      }
    if (chunk == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (warp == 0) {
      const uint32_t row_bytes = code * sizeof(T);
      if (lane == 0) {
        if (need_pre) gea::mbar_expect_tx(bar, nrows * row_bytes);
        gea::mbar_expect_tx(bar + 1, nrows * row_bytes);
        if (need_dz) gea::mbar_expect_tx(bar + 2, kCluster * rows * L.ld_h * sizeof(T));
      }
      for (int r = rank + kCluster * lane; r < nrows; r += kCluster * 32) {
        if (need_pre) bulk_to_cluster(zs + r * L.ld_z, z + (size_t)(r0 + r) * code, row_bytes, bar);
        bulk_to_cluster(gs + r * L.ld_z, g + (size_t)(r0 + r) * code, row_bytes, bar + 1);
      }
    }
    gea::cp_async_wait<2>();
    if (need_pre) gea::mbar_wait(bar, chunk & 1);
    __syncthreads();

    // 2. s on the fp64 tensor cores (16 x 8 tiles, so that every warp has
    // one) while g and W2 land, then dh, a 16 x 16 tile of (rows, hidden
    // slice) a warp at a time.
    const int row_tiles = rows / 16, slice_tiles = L.wh / 16;
    if (need_pre)
      for (int tile = warp; tile < row_tiles * 2 * slice_tiles; tile += kWarps) {
        const int m0 = (tile / (2 * slice_tiles)) * 16, n0 = (tile % (2 * slice_tiles)) * 8;
        double pre[2][2];
        tile8_exact(pre, zs + m0 * L.ld_z, L.ld_z, w1s + n0, L.ld_h, L.kz);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + 2 * lt + e;
            ss[(m0 + lg + 8 * half) * L.wh + c] =
                __fsub_rn(__fadd_rn(__double2float_rn(pre[half][e]), b1s[c]), ts[c]);
          }
      }
    gea::cp_async_wait<1>();
    gea::mbar_wait(bar + 1, chunk & 1);
    __syncthreads();
    if (need_pre) {
      for (int tile = warp; tile < row_tiles * slice_tiles; tile += kWarps) {
        const int m0 = (tile / slice_tiles) * 16, n0 = (tile % slice_tiles) * 16;
        float dh[2][4] = {};
        if (need_dh)
          tile16<true, true>(dh, gs + m0 * L.ld_z, L.ld_z, w2s + n0 * L.ld_z, L.ld_z, L.kz);
        float col[3][2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + nt * 8 + 2 * lt + e;
            const bool col_ok = h0 + c < hidden;
            const float av = as[c], tv = ts[c];
            col[0][nt][e] = col[1][nt][e] = col[2][nt][e] = 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int m = m0 + lg + 8 * half;
              const bool ok = col_ok && r0 + m < p.batch;
              const float s = ss[m * L.wh + c];
              const bool neg = s < 0.f;
              if (need_h)
                hs[m * L.ld_h + c] = from_float<T>(ok ? __fadd_rn(neg ? __fmul_rn(av, s) : s, tv)
                                                      : 0.f);
              if (!need_dh) continue;
              const float d = dh[nt][2 * half + e], fp = neg ? av : 1.f;
              const float dp = __fmul_rn(d, fp);
              if (need_dhp) ps[m * L.ld_h + c] = from_float<T>(ok ? dp : 0.f);
              if (ok) {
                col[0][nt][e] = __fadd_rn(col[0][nt][e], dp);
                col[1][nt][e] = __fadd_rn(col[1][nt][e], neg ? __fmul_rn(d, s) : 0.f);
                col[2][nt][e] = __fadd_rn(col[2][nt][e], __fmul_rn(d, __fsub_rn(1.f, fp)));
              }
            }
          }
        if (need_sums) {  // over the tile's 16 rows: lanes of one t, in a fixed order
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float v = col[q][nt][e];
#pragma unroll
                for (int off = 4; off < 32; off *= 2)
                  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
                if (lg == 0) part[((m0 / 16) * 3 + q) * L.wh + n0 + nt * 8 + 2 * lt + e] = v;
              }
        }
      }
    }
    // The T(dh_pre) slice is read next by the copy engine (another proxy).
    if (need_dz) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    gea::cp_async_wait<0>();
    __syncthreads();
    // 3. dz, first half: the copy engine copies the block's T(dh_pre) slice
    // into every block's full rows (one bulk copy a block, distributed
    // shared memory), completing on their mbarriers, while the weight
    // products run.
    if (need_dz && threadIdx.x < kCluster)  // a destination a thread
      bulk_to_block(fs + rank * rows * L.ld_h, ps, rows * L.ld_h * sizeof(T), bar + 2, threadIdx.x);
    // The chunk's bookkeeping on the warps that take no dz tile: warps 2-3
    // the column sums (the chunk's tiles in order, after the chunks before
    // it), warp 1 db2 (below); warps 4-7 take dz's tiles.
    if (need_sums && (warp == 2 || warp == 3))
      for (int q = threadIdx.x - 64; q < 3 * L.wh; q += 64) {
        float v = chunk > 0 ? sums[q] : 0.f;
        for (int rt = 0; rt < row_tiles; ++rt)
          v = __fadd_rn(v, part[(rt * 3 + q / L.wh) * L.wh + q % L.wh]);
        sums[q] = v;
      }

    // 4. dW1[:, hidden slice] = z^T T(dh_pre), dW2[hidden slice, :] = T(h)^T g.
    const int code_tiles = L.kz / 16;
    if (p.need & kDw1)
      for (int tile = warp; tile < code_tiles * slice_tiles; tile += kWarps) {
        const int m0 = (tile / slice_tiles) * 16, n0 = (tile % slice_tiles) * 16;
        if (m0 >= code || h0 + n0 >= hidden) continue;
        float acc[2][4] = {};
        tile16<false, false>(acc, zs + m0, L.ld_z, ps + n0, L.ld_h, rows);
        put_weight(stg, acc, p.dw1, p.w1_f32, p.carry, m0, h0 + n0, hidden, min(16, code - m0),
                   min(16, hidden - h0 - n0), chunk, chunks);
      }
    if (p.need & kDw2)
      for (int tile = warp; tile < slice_tiles * code_tiles; tile += kWarps) {
        const int m0 = (tile / code_tiles) * 16, n0 = (tile % code_tiles) * 16;
        if (h0 + m0 >= hidden || n0 >= code) continue;
        float acc[2][4] = {};
        tile16<false, false>(acc, hs + m0, L.ld_h, gs + n0, L.ld_z, rows);
        put_weight(stg, acc, p.dw2, p.w2_f32, p.carry ? p.carry + (size_t)code * hidden : nullptr,
                   h0 + m0, n0, code, min(16, hidden - h0 - m0), min(16, code - n0), chunk,
                   chunks);
      }
    if ((p.need & kDb2) && warp == 1)
      for (int c = lane; c < L.wo; c += 32) {
        float v = chunk > 0 ? sum_b2[c] : 0.f;
        if (o0 + c < code)
          for (int r = 0; r < nrows; ++r) v = __fadd_rn(v, to_float(gs[r * L.ld_z + o0 + c]));
        sum_b2[c] = v;
      }
    // 3. dz, second half: once every block's slice is in this block's full
    // rows, dz[:, output slice] = g + full rows @ W1[output slice, :]^T, K
    // walked a slice at a time (two accumulator chains).
    if (need_dz) {
      gea::mbar_wait(bar + 2, chunk & 1);
      const int out_tiles = L.wo / 16;
      for (int tile = kWarps - 1 - warp; tile < row_tiles * out_tiles; tile += kWarps) {
        const int m0 = (tile / out_tiles) * 16, n0 = (tile % out_tiles) * 16;
        if (o0 + n0 >= code || r0 + m0 >= p.batch) continue;
        float acc[2][4] = {}, odd[2][4] = {};
        const T* b = w1r + n0 * L.ld_f;
        for (int kb = 0; kb < kCluster; kb += 2) {
          tile16<true, true>(acc, fs + (kb * rows + m0) * L.ld_h, L.ld_h, b + kb * L.wh, L.ld_f,
                             L.wh);
          tile16<true, true>(odd, fs + ((kb + 1) * rows + m0) * L.ld_h, L.ld_h,
                             b + (kb + 1) * L.wh, L.ld_f, L.wh);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], odd[nt][e]);
        const int nc = min(16, code - o0 - n0);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = nt * 8 + 2 * lt;
            if (c >= nc) continue;
            const T* gr = gs + (m0 + lg + 8 * half) * L.ld_z + o0 + n0 + c;
            acc[nt][2 * half] = __fadd_rn(to_float(gr[0]), acc[nt][2 * half]);
            acc[nt][2 * half + 1] = __fadd_rn(to_float(gr[1]), acc[nt][2 * half + 1]);
          }
        store_tile(stg, acc, static_cast<T*>(p.dz) + (size_t)(r0 + m0) * code + o0 + n0, code,
                   min(16, p.batch - r0 - m0), nc);
      }
    }

    __syncthreads();  // the chunk's buffers are read: the next chunk may load
  }

  const float* src[4] = {sums, sums + L.wh, sums + 2 * L.wh, sum_b2};
  float* dst[4] = {p.db1, p.dslope, p.dtrans, p.db2};
  const int bit[4] = {kDb1, kDslope, kDtrans, kDb2};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int base = i < 3 ? h0 : o0, width = i < 3 ? L.wh : L.wo, end = i < 3 ? hidden : code;
    if (p.need & bit[i])
      for (int c = threadIdx.x; c < width && base + c < end; c += kThreads)
        dst[i][base + c] = src[i][c];
  }
  // No block leaves before every copy into it and out of it has landed.
  cluster.sync();
}

template <typename T>
int launch(const Args& p, cudaStream_t stream) {
  const int bytes = Layout(p.code, p.hidden, p.rows, sizeof(T)).bytes;
  cudaError_t err = cudaFuncSetAttribute(lis_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)  // a cluster of 16 is above the portable 8
    err = cudaFuncSetAttribute(lis_bwd_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  lis_bwd_kernel<T><<<kCluster, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of a batch chunk for these widths (64, else 32 or 16: as many as
// fit in shared memory), or 0 if not even 16 fit.
extern "C" int gea_lis_backward_rows(int code, int hidden, int is_bf16) {
  for (int rows = 64; rows >= 16; rows /= 2)
    if (Layout(code, hidden, rows, is_bf16 ? 2 : 4).bytes <= kSmemLimit) return rows;
  return 0;
}

// ptr: z, w1, b1, slope, trans, w2, g (z, w1, w2 and g in the computing
// type, the vectors fp32), then the outputs dz, dw1, db1, dslope, dtrans,
// dw2, db2 (the vectors fp32) and the fp32 carry of (C H + H C) elements
// (used only when the batch spans more than one chunk). dim: batch, code,
// hidden, is_bf16, need (bit i for gradient i, in that order), rows of a
// chunk (gea_lis_backward_rows), dW1 in fp32, dW2 in fp32.
extern "C" int gea_lis_backward(const unsigned long long* ptr, const int* dim, void* stream) {
  Args p{};
  p.z = reinterpret_cast<const void*>(ptr[0]);
  p.w1 = reinterpret_cast<const void*>(ptr[1]);
  p.b1 = reinterpret_cast<const float*>(ptr[2]);
  p.slope = reinterpret_cast<const float*>(ptr[3]);
  p.trans = reinterpret_cast<const float*>(ptr[4]);
  p.w2 = reinterpret_cast<const void*>(ptr[5]);
  p.g = reinterpret_cast<const void*>(ptr[6]);
  p.dz = reinterpret_cast<void*>(ptr[7]);
  p.dw1 = reinterpret_cast<void*>(ptr[8]);
  p.db1 = reinterpret_cast<float*>(ptr[9]);
  p.dslope = reinterpret_cast<float*>(ptr[10]);
  p.dtrans = reinterpret_cast<float*>(ptr[11]);
  p.dw2 = reinterpret_cast<void*>(ptr[12]);
  p.db2 = reinterpret_cast<float*>(ptr[13]);
  p.batch = dim[0], p.code = dim[1], p.hidden = dim[2];
  const int is_bf16 = dim[3];
  p.need = dim[4], p.rows = dim[5], p.w1_f32 = dim[6], p.w2_f32 = dim[7];
  p.carry = p.batch > p.rows ? reinterpret_cast<float*>(ptr[14]) : nullptr;
  if (p.rows < 16 || p.rows % 16 || p.batch <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(p, st) : launch<float>(p, st);
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
