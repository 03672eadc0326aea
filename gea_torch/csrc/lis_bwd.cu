// The backward of a chain of LIS links (lis.cu), z_{j+1} = link_j(z_j):
//
//     pre = z @ W1 + b1        s = pre - trans        neg = s < 0
//     h   = where(neg, slope * s, s) + trans
//     out = z + T(T(h) @ W2 + b2)
//
// For the cotangents g_j of the outputs z_{j+1} (in z's type), walked from
// the last link down, every sum in fp32 unless said:
//
//     G   = g_j (last link) or T(g_j + dz_{j+1})    the link's total cotangent
//     dh  = G @ W2^T           fprime = where(neg, slope, 1)     dh_pre = dh * fprime
//     dz  = T(G + T(dh_pre) @ W1^T)      dW1 = z^T T(dh_pre)     db1 = sum_rows dh_pre
//     dW2 = T(h)^T G           db2 = sum_rows G
//     dslope = sum_rows where(neg, dh * s, 0)     dtrans = sum_rows dh * (1 - fprime)
//
// with T() rounding to z's type (fp32 or bf16). This is
// gea/ops/pallas/lis.py::_bwd (jnp inside the custom_vjp of the
// pl.pallas_call at :89) link by link, with the rounding points of the
// port's plain version (gea_torch/ops/lis.py::lis_chain_backward_plain,
// which composes lis_residual_mlp_backward_plain): pre exact (fp64
// products and sums, rounded once to fp32, then + b1 and - trans in fp32),
// h and dh_pre rounded to z's type before the products that take them, G
// rounded as the autograd engine rounds the sum of a link's two
// cotangents, dW1 and dW2 written in their weights' type or fp32. One link
// is a chain of one (`lis_residual_mlp_backward`).
//
// Bound on the H100: latency. At the flagship shape (3 links, B = 64, C =
// H = 256) a chain is 3 x 10 B C H = 126 MFLOP and moves about 1.8 MB,
// under a microsecond either way. What costs time is the serial path:
// per link, dh = G W2^T -> dh_pre -> dz -> the next link's G, each step
// needing the whole row of the one before. Everything else hangs off it.
//
// Design: one launch walks every link (a second, `lis_chain_reduce`, adds
// the weight partials in a fixed order). Rows are independent all the way
// down the dz chain, so the batch is cut into row groups of 16 rows, each
// walked by its own thread block cluster of `cluster` (16 or 8) blocks with
// no wait across clusters. Block q of a cluster owns hidden columns [q wh,
// +wh) and output columns [q wo, +wo). First, off the serial path, every
// link's exact pre, s and T(h) for its slice (fp64 mma.sync m16n8k16 from
// the saved z and W1[:, slice]), the links at once over the warps. Then
// per link, from the last down, for its 16 rows:
//
//  A. dh for its hidden slice (G's full rows against W2[slice, :]), its
//     k-steps cut over the 8 warps, the parts added in order by every
//     thread, an element each, with dh_pre and T(dh_pre);
//  -  the T(dh_pre) slices exchanged (stores into every block's shared
//     memory, an arrival on the cluster barrier); while the others arrive,
//     dW2's partial for the slice (T(h)^T G over the 16 rows) and the
//     column sums of db1, dslope and dtrans, into the row group's slots;
//  B. dz for its output slice (T(dh_pre)'s full rows against W1[out slice,
//     :]), cut and added the same way, then the link below's G slice,
//     T(g + T(dz)), or the first link's dz, out;
//  -  the G slices exchanged; meanwhile dW1's partial for the slice (z^T
//     T(dh_pre) over the 16 rows), the link below's db2 over the slice,
//     and the next operands copied in.
//
// The operands sit in a ring of `depth` slots in shared memory, in the
// order they are used: every link's P item (z, W1[:, slice], the vectors),
// then their W items (z, W2[slice, :], W1[out slice, :], the g slice, the
// vectors). One warp copies an item in by bulk copies, a row each, that
// complete on the slot's mbarrier, as soon as its slot is free. The serial
// products add their k-steps in an order that depends on K alone, not on
// the cluster, so every plan gives the same bits. Every partial goes to a
// fixed slot sized on the host (gea_torch.ops.lis.backward_plan); the
// reduce adds the row groups' slots in order. There are no atomics: two
// calls agree bit for bit. bf16 products are mma.sync m16n8k16 with fp32
// accumulation; the fp32 instance runs the same structure on the CUDA
// cores (TF32 would lose the fp32 tolerance), with the same exact pre. Only
// what `need` asks for is computed: a frozen chain (dz alone) runs no
// weight products, no sums and no reduce.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

// The helpers below are inlined; a build may set LIS_INLINE (to
// __noinline__, say) to weigh the code's size against its calls.
#ifndef LIS_INLINE
#define LIS_INLINE __forceinline__
#endif

namespace {

using gea::bf16;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // rows of a row group
constexpr int kMaxLinks = 8;
constexpr int kGrads = 6;       // dW1, db1, dslope, dtrans, dW2, db2: the slotted gradients
constexpr int kSmemLimit = 232448 - 1024;  // dynamic shared memory: a block's less the links
constexpr int kStageBytes = 16 * (16 * 4 + 16);  // a warp's staging tile (store_tile), fp32 at most
constexpr int kSplits = 8;  // warps a serial product's k-steps are cut over

enum Need { kDz = 1, kDw1 = 2, kDb1 = 4, kDslope = 8, kDtrans = 16, kDw2 = 32, kDb2 = 64 };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int align16(int x) { return round_up(x, 16); }
__host__ __device__ inline int align128(int x) { return round_up(x, 128); }

struct Link {
  const void *z, *w1, *w2, *g;  // z, W1, W2 and the cotangent of the output, in the computing type
  const float *b1, *slope, *trans;
  long long slot[kGrads];  // fp32 offsets into `part` of each gradient's slots, or -1
  int need;                // bit i for gradient i: dz, dW1, db1, dslope, dtrans, dW2, db2
};
static_assert(sizeof(Link) * kMaxLinks <= 1024 && sizeof(Link) % 8 == 0, "the links' copy");

// A build with -DLIS_TRACE records the SM clock (clock64) of block 0 of
// each cluster at the phase boundaries, kTraceSlots a row group, into a
// buffer passed after the slots (scripts/torch_lis_backward_trace.py):
// the start, the first operands landed, the prologue's end, then per
// link walked (5 each): its operands landed, A done, the T(dh_pre)
// exchange done, B done, the G exchange done; in the last three slots,
// within the prologue: the first P items landed, their pre done, the
// next copies issued.
constexpr int kTraceSlots = 3 + 5 * kMaxLinks;

struct Args {
  CUtensorMap w1map[kMaxLinks];  // each link's W1 (C rows of H), in boxes of (wh, w1_box_rows)
  Link link[kMaxLinks];
  void* dz;     // the first link's dz, in the computing type
  float* part;  // the slots: (groups, C H) for dW1 and dW2, (groups, H) or (groups, C) for the sums
  int links, first, batch, code, hidden, cluster, depth;
#ifdef LIS_TRACE
  long long* trace;
#endif
};

// Shared memory of one block, byte offsets. Rows padded by 8 elements (16
// bytes in bf16), so that the 8 rows an ldmatrix reads fall in distinct
// bank groups. A ring slot holds a P item (z rows, W1[:, slice], vectors)
// or a W item (z rows, W2[slice, :], W1[out slice, :], g slice, vectors);
// s and T(h) are kept for every link. gea_torch/ops/lis.py::chain_smem_bytes
// computes the same sizes.
constexpr int kBars = 8;  // mbarriers: the ring's slots (4 at most) and the first G's
struct Layout {
  int wh, wo, kz, kh, ld_z, ld_h, ld_o, ld_f, box_rows, w1c_rows;
  int p_w1c, p_vec, w_w2, w_w1r, w_g, w_vec, slot;
  int gbuf, dfull, gst, dst, hs, ss, dhs, red, stg, bar, bytes;
  __host__ __device__ Layout(int code, int hidden, int links, int cluster, int depth, int e) {
    kz = round_up(code, 16);
    wh = round_up(cdiv(hidden, cluster), 16);
    wo = round_up(cdiv(code, cluster), 16);
    kh = cluster * wh;
    // z, W2 and W1's rows dense, as they lie in device memory (one bulk
    // copy a tile where the widths are whole tiles); the exchanged and
    // computed tiles padded by 8 elements.
    ld_z = kz, ld_h = wh + 8, ld_o = wo + 8, ld_f = kh;
    box_rows = kz < 256 ? kz : 256;  // W1[:, slice] by TMA boxes of (wh, box_rows), dense
    w1c_rows = round_up(kz, box_rows);
    const int zb = align16(kRows * ld_z * e), vb = align16(3 * wh * 4);
    p_w1c = align128(zb);
    p_vec = p_w1c + align16(w1c_rows * wh * e);
    const int pb = p_vec + vb;
    w_w2 = zb;
    w_w1r = w_w2 + align16(wh * ld_z * e);
    w_g = w_w1r + align16(wo * ld_f * e);
    w_vec = w_g + align16(kRows * ld_o * e);
    const int wb = w_vec + vb;
    slot = align128(pb > wb ? pb : wb);
    gbuf = depth * slot;  // G's full rows of two links (parity), the slices apart
    dfull = gbuf + 2 * align16(cluster * kRows * ld_o * e);  // T(dh_pre)'s full rows, likewise
    gst = dfull + align16(cluster * kRows * ld_h * e);   // this block's G slice
    dst = gst + align16(kRows * ld_o * e);               // this block's T(dh_pre) slice
    hs = dst + align16(kRows * ld_h * e);                // T(h) of each link
    ss = hs + links * align16(kRows * ld_h * e);         // s of each link, fp32
    dhs = ss + links * align16(kRows * wh * 4);  // dh of the slice, fp32, for the sums
    red = dhs + align16(kRows * wh * 4);         // the split products' partial tiles, fp32
    stg = red + kSplits * (wh > wo ? wh : wo) / 16 * 1024;  // the warps' staging tiles
    bar = stg + kWarps * kStageBytes;
    bytes = bar + kBars * 8;
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

// ------------------------------------------------------------ 16 x 16 tile products
//
// acc[nt][e] (e < 2: row g, e >= 2: row g + 8; column nt * 8 + 2t + e % 2):
// the layout of mma.m16n8k16's C fragment (mma.cuh); g = lane / 4, t =
// lane % 4.

// acc += A^T B over a row group's 16 rows (K = 16), A and B row-major with
// the tile at column 0 of each: a weight gradient's 16 x 16 tile. One pair
// of mma.sync m16n8k16 from ldmatrix.trans fragments (bf16); the CUDA cores
// in fp32.
__device__ LIS_INLINE void weight_tile16(float (&acc)[2][4], const bf16* a, int lda, const bf16* b,
                                         int ldb) {
  const int l = threadIdx.x % 32, j = l >> 3;
  uint32_t af[4], bfr[4];
  gea::ldmatrix_x4_trans(af, a + ((l & 7) + (j >> 1) * 8) * lda + (j & 1) * 8);
  gea::ldmatrix_x4_trans(bfr, b + ((l & 7) + (j & 1) * 8) * ldb + (j >> 1) * 8);
  gea::mma_bf16(acc[0], af, bfr[0], bfr[1]);
  gea::mma_bf16(acc[1], af, bfr[2], bfr[3]);
}

__device__ LIS_INLINE void weight_tile16(float (&acc)[2][4], const float* a, int lda,
                                         const float* b, int ldb) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  for (int k = 0; k < kRows; ++k) {
    const float a0 = a[k * lda + g], a1 = a[k * lda + g + 8];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bv = b[k * ldb + nt * 8 + 2 * t + e];
        acc[nt][e] = fmaf(a0, bv, acc[nt][e]);
        acc[nt][2 + e] = fmaf(a1, bv, acc[nt][2 + e]);
      }
  }
}

// acc = the sum of A (16 x 16 s1) B over the k-steps [s0, s1) of 16, for A
// K-contiguous and cut into slices of w columns (slice i at a + i *
// slice_stride: the slices the blocks of a cluster exchange) and B
// K-contiguous (b[n * ldb + k]). bf16: the even and the odd k-steps feed
// two chains, added at the end; fp32: one chain. Either way the order of the
// sum depends on the steps alone, not on the slicing, so every cluster
// size gives the same bits.
__device__ LIS_INLINE void tile16_steps(float (&acc)[2][4], const bf16* a, int lda, int w,
                                             int slice_stride, const bf16* b, int ldb, int s0,
                                             int s1) {
  const int l = threadIdx.x % 32, j = l >> 3;
  int col = 16 * s0 % w;
  const bf16* pa = a + 16 * s0 / w * slice_stride + col + (l & 15) * lda + (l >> 4) * 8;
  const bf16* pb = b + ((l & 7) + (j >> 1) * 8) * ldb + (j & 1) * 8 + 16 * s0;
  auto step = [&](float (&d)[2][4]) {
    uint32_t af[4], bfr[4];
    gea::ldmatrix_x4(af, pa);
    gea::ldmatrix_x4(bfr, pb);
    gea::mma_bf16(d[0], af, bfr[0], bfr[1]);
    gea::mma_bf16(d[1], af, bfr[2], bfr[3]);
    pb += 16, pa += 16, col += 16;
    if (col == w) pa += slice_stride - w, col = 0;
  };
  float odd[2][4] = {};
  for (int st = s0; st < s1; ++st) {
    if (st & 1)
      step(odd);
    else
      step(acc);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], odd[nt][e]);
}

__device__ LIS_INLINE void tile16_steps(float (&acc)[2][4], const float* a, int lda, int w,
                                             int slice_stride, const float* b, int ldb, int s0,
                                             int s1) {
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  int col = 16 * s0 % w;
  const float* pa = a + 16 * s0 / w * slice_stride + col + g * lda;
  const float* pb = b + 2 * t * ldb;
  for (int k = 16 * s0; k < 16 * s1; ++k) {
    const float a0 = pa[0], a1 = pa[8 * lda];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bv = pb[(nt * 8 + e) * ldb + k];
        acc[nt][e] = fmaf(a0, bv, acc[nt][e]);
        acc[nt][2 + e] = fmaf(a1, bv, acc[nt][2 + e]);
      }
    ++pa;
    if (++col == w) pa += slice_stride - w, col = 0;
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
__device__ LIS_INLINE void tile8_exact(double (&pre)[2][2], const T* a, int lda, const T* b,
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
__device__ LIS_INLINE void store_tile(unsigned char* stage, const float (&v)[2][4], O* dst,
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


// `bytes` (a multiple of 16) of this block's shared memory at src into dst
// (an address in this block's) of each of the cluster's `blocks` blocks.
template <typename T>
__device__ LIS_INLINE void push(cg::cluster_group& cluster, T* dst, const T* src, int bytes,
                                     int blocks) {
  const int n = bytes / 16;
  for (int i = threadIdx.x; i < blocks * n; i += kThreads) {
    uint4* r = reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, i / n));
    r[i % n] = reinterpret_cast<const uint4*>(src)[i % n];
  }
}

// The serial products are cut into kSplits ranges of k-steps, a warp each,
// whose partial tiles every thread then adds, an element each, in order:
// the sum's order depends on K alone.
__device__ __forceinline__ int split_steps(int steps) { return steps < kSplits ? steps : kSplits; }

// A warp's accumulator tile into its slot of `red` ([slot][element][lane],
// so that each store of an element runs over 32 consecutive words).
__device__ LIS_INLINE void put_partial(float* red, int slot, const float (&v)[2][4]) {
  float* r = red + slot * 256 + threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[(nt * 4 + e) * 32] = v[nt][e];
}

// `bytes` (a multiple of 16) from global src into this block's shared
// memory at dst by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(gea::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(gea::smem_u32(bar))
      : "memory");
}

// Rows [r0, r1) x columns [c0, c1) of dst (row stride ld) set to zero in
// 16-byte pieces by the 32 lanes of a warp (c0, c1 whole pieces).
template <typename T>
__device__ void zero_rect(T* dst, int ld, int r0, int r1, int c0, int c1, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int per = (c1 - c0) / V;
  if (per <= 0 || r1 <= r0) return;
  for (int i = lane; i < (r1 - r0) * per; i += 32)
    *reinterpret_cast<uint4*>(dst + (r0 + i / per) * ld + c0 + (i % per) * V) =
        make_uint4(0, 0, 0, 0);
}

// Rows [0, nr) x columns [0, nc) of a row-major source (row stride ld_src)
// into shared memory (row stride ld) in 16-byte cp.async pieces by the lanes
// of a warp; pieces at row >= rows or column >= cols are zero-filled. For
// tiles of short rows, where a bulk copy a row would keep the copy engine
// busy for little.
template <typename T>
__device__ void warp_stage(T* dst, int ld, const T* src, size_t ld_src, int nr, int nc, int rows,
                           int cols, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int per = nc / V;
  for (int i = lane; i < nr * per; i += 32) {
    const int r = i / per, c = (i % per) * V;
    const bool ok = r < rows && c < cols;
    gea::cp_async16(dst + r * ld + c, ok ? static_cast<const void*>(src + r * ld_src + c) : src,
                    ok ? 16 : 0);
  }
}

// An arrival on `bar` once this thread's cp.async copies so far have landed
// (counted among the arrivals the barrier was set up for).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(gea::smem_u32(bar))
               : "memory");
}

// Rows [0, rows) x columns [0, cols) of a row-major source (row stride
// ld_src) into the shared tile dst (row stride ld, nr x nc), one bulk copy a
// row by the lanes of a warp, completing on `bar` (`copy`); or, first, the
// rest of the tile zeroed (not `copy`). Returns the bytes the copies move.
template <typename T>
__device__ uint32_t tile_load(T* dst, int ld, const T* src, size_t ld_src, int nr, int nc,
                              int rows, int cols, uint64_t* bar, int lane, bool copy) {
  rows = rows < 0 ? 0 : rows < nr ? rows : nr;
  cols = cols < 0 ? 0 : cols < nc ? cols : nc;
  if (cols == 0) rows = 0;
  if (!copy) {
    zero_rect(dst, ld, rows, nr, 0, nc, lane);
    zero_rect(dst, ld, 0, rows, cols, nc, lane);
  } else if (cols == ld && (size_t)cols == ld_src) {  // contiguous both sides: one copy
    if (lane == 0 && rows > 0) bulk_load(dst, src, rows * cols * sizeof(T), bar);
  } else {
    for (int r = lane; r < rows; r += 32)
      bulk_load(dst + r * ld, src + r * ld_src, cols * sizeof(T), bar);
  }
  return rows * cols * sizeof(T);
}

// Item k of the ring into its slot, by the lanes of one warp: the ring's
// items in the order they are used, the P item of every link walked from
// the last down, then their W items; item k sits in slot k % depth and
// completes on that slot's mbarrier (the first kBars - 1): rows of 16
// bytes' multiples by bulk copies, in two passes (the zeros and the bytes,
// then, the arrival of lane 0 made with those bytes, the copies), the tiles
// of short rows by cp.async, each lane arriving when its pieces land (33
// arrivals). The slot's last reads (generic) come before these writes. Not
// inlined: it runs a few times a call, by one warp, and its code would
// otherwise sit at every call site.
template <typename T>
__device__ __noinline__ void issue_item(unsigned char* smem, const Link* links,
                                        const CUtensorMap* w1maps, int k, int nlinks, int first,
                                        int code, int hidden, int CL, int depth, int r0, int nrows,
                                        int q, int lane) {
  const Layout L(code, hidden, nlinks, CL, depth, sizeof(T));
  const int top = nlinks - 1, walked = top - first + 1, wh = L.wh, wo = L.wo;
  const int h0 = q * wh, o0 = q * wo;
  const bool is_w = k >= walked;
  const int j = top - (is_w ? k - walked : k);
  const Link& lk = links[j];
  unsigned char* s = smem + (k % depth) * L.slot;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar) + k % depth;
  const T *z = static_cast<const T*>(lk.z), *w1 = static_cast<const T*>(lk.w1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  uint32_t bytes = 0;
  for (int copy = 0; copy < 2; ++copy) {
    if (copy) {
      __syncwarp();
      if (lane == 0) gea::mbar_expect_tx(bar, bytes);
      __syncwarp();
    }
    bytes = tile_load(reinterpret_cast<T*>(s), L.ld_z, z + (size_t)r0 * code, code, kRows, L.kz,
                      nrows, code, bar, lane, copy);
    float* vec = reinterpret_cast<float*>(s + (is_w ? L.w_vec : L.p_vec));
    for (int i = 0; i < 3; ++i)
      bytes += tile_load(vec + i * wh, wh, (i == 0 ? lk.b1 : i == 1 ? lk.slope : lk.trans) + h0, 0,
                         1, wh, 1, hidden - h0, bar, lane, copy);
    if (!is_w) {  // W1[:, slice] whole, by TMA boxes (zeros outside W1)
      for (int y = 0; y < L.kz; y += L.box_rows) {
        if (copy && lane == 0)
          gea::tma_load_2d(s + L.p_w1c + (size_t)y * wh * sizeof(T), w1maps + j, h0, y, bar);
        bytes += L.box_rows * wh * sizeof(T);
      }
    }
    if (is_w) {
      const T* w2 = static_cast<const T*>(lk.w2);
      bytes += tile_load(reinterpret_cast<T*>(s + L.w_w2), L.ld_z, w2 + (size_t)h0 * code, code,
                         wh, L.kz, hidden - h0, code, bar, lane, copy);
      if (lk.need & kDz)
        bytes += tile_load(reinterpret_cast<T*>(s + L.w_w1r), L.ld_f, w1 + (size_t)o0 * hidden,
                           hidden, wo, L.kh, code - o0, hidden, bar, lane, copy);
    }
  }
  // The tile of short rows by cp.async: the g slice (W).
  if (is_w && j > first) {
    const T* g = static_cast<const T*>(links[j - 1].g);
    warp_stage(reinterpret_cast<T*>(s + L.w_g), L.ld_o, g + (size_t)r0 * code + o0, code, kRows,
               wo, nrows, code - o0, lane);
  }
  cp_async_arrive(bar);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) lis_chain_kernel(const __grid_constant__ Args p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = p.cluster, q = (int)cluster.block_rank(), grp = blockIdx.x / CL;
  const Layout L(p.code, p.hidden, p.links, CL, p.depth, sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  T* dfull = reinterpret_cast<T*>(smem + L.dfull);
  T* gst = reinterpret_cast<T*>(smem + L.gst);
  T* dst = reinterpret_cast<T*>(smem + L.dst);
  float* dhs = reinterpret_cast<float*>(smem + L.dhs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);  // the slots', then the first G's
  const int code = p.code, hidden = p.hidden, wh = L.wh, wo = L.wo;
  const int r0 = grp * kRows, nrows = min(kRows, p.batch - r0), h0 = q * wh, o0 = q * wo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* stg = smem + L.stg + warp * kStageBytes;
  const int top = p.links - 1, first = p.first, walked = top - first + 1, items = 2 * walked;
  const size_t wsize = (size_t)code * hidden;
  const int hs_bytes = align16(kRows * L.ld_h * (int)sizeof(T)), ss_bytes = align16(kRows * wh * 4);
  const int gbuf_elems = CL * kRows * L.ld_o;
  auto gbuf = [&](int j) { return reinterpret_cast<T*>(smem + L.gbuf) + (j & 1) * gbuf_elems; };
  auto ss_of = [&](int j) { return reinterpret_cast<float*>(smem + L.ss + j * ss_bytes); };
  auto hs_of = [&](int j) { return reinterpret_cast<T*>(smem + L.hs + j * hs_bytes); };
#ifdef LIS_TRACE
  auto mark = [&](int i) {
    if (threadIdx.x == 0 && q == 0) p.trace[grp * kTraceSlots + i] = clock64();
  };
#else
  auto mark = [](int) {};
#endif
  mark(0);
  // The links' descriptors in shared memory: read there, a link index that
  // varies at run time costs a shared load, not one of the parameter space.
  __shared__ Link links[kMaxLinks];
  for (int i = threadIdx.x; i < (int)(sizeof(links) / 8); i += kThreads)
    reinterpret_cast<long long*>(links)[i] = reinterpret_cast<const long long*>(p.link)[i];
  if (threadIdx.x == 0) {
    for (int b = 0; b < kBars; ++b) gea::mbar_init(bars + b, b < kBars - 1 ? 33 : 32);
    gea::mbar_init_fence();
  }
  __syncthreads();

  // The exchanges: each block stores its slice into every block's shared
  // memory, arrives on the cluster barrier, goes on with work off the
  // serial path and waits before it reads what the others stored. Every
  // block of the cluster runs before another writes into it: the first
  // arrival here, its wait before the first stores (or at the end).
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  bool joined = false;
  auto join = [&]() {
    if (!joined) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    joined = true;
  };
  auto arrive_all = [] { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); };
  auto wait_all = [] { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); };

  // The ring (`issue_item`): the last warp copies item k in once item k -
  // depth is done with.
  auto slot = [&](int k) { return smem + (k % p.depth) * L.slot; };
  auto issue = [&](int k) {
    if (warp == kWarps - 1)
      issue_item<T>(smem, links, p.w1map, k, p.links, first, code, hidden, CL, p.depth, r0, nrows,
                    q, lane);
  };
  int next = 0, freed = -1;  // items issued; the last item done with (they free in order)
  auto refill = [&]() {
    while (next < items && next <= freed + p.depth) issue(next++);
  };
  auto wait_item = [&](int k) { gea::mbar_wait(bars + k % p.depth, (k / p.depth) & 1); };

  // The last link's G = g: this block's slice into gst (cp.async, on the
  // last mbarrier), then into every block's full rows (an exchange) while
  // the prologue runs; the first items.
  if (warp == kWarps - 1) {
    warp_stage(gst, L.ld_o, static_cast<const T*>(links[top].g) + (size_t)r0 * code + o0, code,
               kRows, wo, nrows, code - o0, lane);
    cp_async_arrive(bars + kBars - 1);
  }
  refill();
  gea::mbar_wait(bars + kBars - 1, 0);
  join();
  push(cluster, gbuf(top) + q * kRows * L.ld_o, gst, kRows * L.ld_o * (int)sizeof(T), CL);
  arrive_all();
  mark(1);

  // Prologue: every link's s and T(h) (pre exact on the fp64 tensor cores,
  // rounded once) from its P item, as many links at once as the ring holds
  // beside the last link's W item; the last link's db2 over this slice.
  const int batch = max(1, min(walked, p.depth - 1));
  for (int k0 = 0; k0 < walked; k0 += batch) {
    const int k1 = min(walked, k0 + batch);
    for (int k = k0; k < k1; ++k) wait_item(k);
    if (k0 == 0) mark(kTraceSlots - 3);
    const int tiles = wh / 8;
    for (int u = warp; u < (k1 - k0) * tiles; u += kWarps) {
      const int k = k0 + u / tiles, j = top - k, n0 = (u % tiles) * 8;
      const unsigned char* s = slot(k);
      const float* vec = reinterpret_cast<const float*>(s + L.p_vec);
      double pre[2][2];
      tile8_exact(pre, reinterpret_cast<const T*>(s), L.ld_z,
                  reinterpret_cast<const T*>(s + L.p_w1c) + n0, wh, L.kz);
      float* ss = ss_of(j);
      T* hs = hs_of(j);
      const bool need_h = links[j].need & kDw2;
      const int lg = lane / 4, lt = lane % 4;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 2 * lt + e, m = lg + 8 * half;
          const float sv =
              __fsub_rn(__fadd_rn(__double2float_rn(pre[half][e]), vec[c]), vec[2 * wh + c]);
          ss[m * wh + c] = sv;
          if (need_h) {
            const bool ok = h0 + c < hidden && m < nrows;
            hs[m * L.ld_h + c] = from_float<T>(
                ok ? __fadd_rn(sv < 0.f ? __fmul_rn(vec[wh + c], sv) : sv, vec[2 * wh + c]) : 0.f);
          }
        }
    }
    if (k0 == 0 && (links[top].need & kDb2))
      for (int c = threadIdx.x; c < wo && o0 + c < code; c += kThreads) {
        float v = 0.f;
        for (int m = 0; m < nrows; ++m) v = __fadd_rn(v, to_float(gst[m * L.ld_o + c]));
        p.part[links[top].slot[5] + (size_t)grp * code + o0 + c] = v;
      }
    __syncthreads();
    if (k0 == 0) mark(kTraceSlots - 2);
    freed = k1 - 1;
    refill();
  }
  mark(kTraceSlots - 1);
  wait_all();  // the last link's G in every block
  mark(2);

  const int dh_steps = L.kz / 16, dz_steps = round_up(hidden, 16) / 16;
  const int dh_split = split_steps(dh_steps), dz_split = split_steps(dz_steps);
  const int code_tiles = L.kz / 16;
  for (int j = top; j >= first; --j) {
    const Link& lk = links[j];
    const int need = lk.need;
    const bool need_dh = need & (kDz | kDw1 | kDb1 | kDslope | kDtrans);
    const bool need_sums = need & (kDb1 | kDslope | kDtrans), need_dz = need & kDz;
    const int kw = walked + top - j;
    wait_item(kw);
    const int mk = 3 + 5 * (top - j);
    mark(mk);
    const unsigned char* ws = slot(kw);
    const T* zs = reinterpret_cast<const T*>(ws);
    const T* w2s = reinterpret_cast<const T*>(ws + L.w_w2);
    const T* w1r = reinterpret_cast<const T*>(ws + L.w_w1r);
    const T* gsl = reinterpret_cast<const T*>(ws + L.w_g);
    const float* vec = reinterpret_cast<const float*>(ws + L.w_vec);
    const float* ss = ss_of(j);
    const T* hs = hs_of(j);
    const T* g_full = gbuf(j);

    // A. dh = G W2[slice, :]^T, its k-steps cut over the warps; then every
    // thread adds up an element's parts, in order, and takes dh_pre and
    // T(dh_pre) (the sums come later, off the serial path).
    const int n_dh = need_dh ? wh / 16 : 0;
    for (int u = warp; u < n_dh * dh_split; u += kWarps) {
      const int t = u / dh_split, i = u % dh_split;
      float acc[2][4] = {};
      tile16_steps(acc, g_full, L.ld_o, wo, kRows * L.ld_o, w2s + t * 16 * L.ld_z, L.ld_z,
                   i * dh_steps / dh_split, (i + 1) * dh_steps / dh_split);
      put_partial(red, u, acc);
    }
    __syncthreads();
    for (int x = threadIdx.x; x < n_dh * 256; x += kThreads) {
      const int t = x / 256, e = x % 256 / 32, ln = x % 32;
      const float* r = red + t * dh_split * 256 + e * 32 + ln;
      float d = r[0];
      for (int i = 1; i < dh_split; ++i) d = __fadd_rn(d, r[i * 256]);
      const int m = ln / 4 + 8 * (e % 4 / 2), c = t * 16 + e / 4 * 8 + 2 * (ln % 4) + e % 2;
      const bool ok = h0 + c < hidden && m < nrows;
      const float s = ss[m * wh + c], fp = s < 0.f ? vec[wh + c] : 1.f;
      dst[m * L.ld_h + c] = from_float<T>(ok ? __fmul_rn(d, fp) : 0.f);
      dhs[m * wh + c] = ok ? d : 0.f;
    }
    __syncthreads();
    mark(mk + 1);
    if (need_dz) {  // this block's T(dh_pre) slice into every block's full rows
      join();
      push(cluster, dfull + q * kRows * L.ld_h, dst, kRows * L.ld_h * (int)sizeof(T), CL);
      arrive_all();
    }
    // Off the serial path while the exchange completes: dW2's partial for
    // the slice (T(h)^T G over the 16 rows), and the slice's column sums of
    // dh_pre, dh s (where s < 0) and dh (1 - fprime), row by row.
    const int n_dw2 = (need & kDw2) ? (wh / 16) * code_tiles : 0;
    for (int u = warp; u < n_dw2; u += kWarps) {
      const int m0 = (u / code_tiles) * 16, n0 = (u % code_tiles) * 16;
      if (h0 + m0 >= hidden || n0 >= code) continue;
      const int b = n0 / wo;
      float acc[2][4] = {};
      weight_tile16(acc, hs + m0, L.ld_h, g_full + b * kRows * L.ld_o + (n0 - b * wo), L.ld_o);
      store_tile(stg, acc, p.part + lk.slot[4] + grp * wsize + (size_t)(h0 + m0) * code + n0,
                 code, min(16, hidden - h0 - m0), min(16, code - n0));
    }
    if (need_sums) {  // four rows a thread, then the four parts in order
      for (int x = threadIdx.x; x < 4 * wh; x += kThreads) {
        const int c = x % wh, m0 = x / wh * 4;
        const float av = vec[wh + c];
        float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int m = m0; m < m0 + 4; ++m) {
          const float d = dhs[m * wh + c], sv = ss[m * wh + c];
          const bool neg = sv < 0.f;
          const float fp = neg ? av : 1.f;
          v[0] = __fadd_rn(v[0], __fmul_rn(d, fp));
          v[1] = __fadd_rn(v[1], neg ? __fmul_rn(d, sv) : 0.f);
          v[2] = __fadd_rn(v[2], __fmul_rn(d, __fsub_rn(1.f, fp)));
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) red[(k * 4 + m0 / 4) * wh + c] = v[k];
      }
      __syncthreads();
      for (int x = threadIdx.x; x < 3 * wh; x += kThreads) {
        const int k = x / wh, c = x % wh;
        if (h0 + c >= hidden || !(need & (kDb1 << k))) continue;
        const float* r = red + k * 4 * wh + c;
        p.part[lk.slot[1 + k] + (size_t)grp * hidden + h0 + c] =
            __fadd_rn(__fadd_rn(__fadd_rn(r[0], r[wh]), r[2 * wh]), r[3 * wh]);
      }
      __syncthreads();  // the parts read before B's products reuse the buffer
    }
    if (need_dz) wait_all();
    mark(mk + 2);

    // B. dz = G + T(dh_pre) W1[out slice, :]^T, its k-steps cut over the
    // warps; then every thread adds up an element's parts and forms the
    // link before's G, T(g + T(dz)), in place of this link's slice, or
    // writes the first link's dz.
    const int n_dz = need_dz ? wo / 16 : 0;
    for (int u = warp; u < n_dz * dz_split; u += kWarps) {
      const int t = u / dz_split, i = u % dz_split;
      float acc[2][4] = {};
      tile16_steps(acc, dfull, L.ld_h, wh, kRows * L.ld_h, w1r + t * 16 * L.ld_f, L.ld_f,
                   i * dz_steps / dz_split, (i + 1) * dz_steps / dz_split);
      put_partial(red, u, acc);
    }
    __syncthreads();
    for (int x = threadIdx.x; x < n_dz * 256; x += kThreads) {
      const int t = x / 256, e = x % 256 / 32, ln = x % 32;
      const float* r = red + t * dz_split * 256 + e * 32 + ln;
      float a = r[0];
      for (int i = 1; i < dz_split; ++i) a = __fadd_rn(a, r[i * 256]);
      const int m = ln / 4 + 8 * (e % 4 / 2), col = t * 16 + e / 4 * 8 + 2 * (ln % 4) + e % 2;
      const bool ok = o0 + col < code && m < nrows;
      const float dz = to_float(from_float<T>(__fadd_rn(to_float(gst[m * L.ld_o + col]), a)));
      if (j > first)
        gst[m * L.ld_o + col] = from_float<T>(
            ok ? __fadd_rn(to_float(gsl[m * L.ld_o + col]), dz) : 0.f);
      else if (ok)
        static_cast<T*>(p.dz)[(size_t)(r0 + m) * code + o0 + col] = from_float<T>(dz);
    }
    __syncthreads();
    mark(mk + 3);
    if (j > first) {  // this block's G slice into every block's full rows of the link before
      join();
      push(cluster, gbuf(j - 1) + q * kRows * L.ld_o, gst, kRows * L.ld_o * (int)sizeof(T), CL);
      arrive_all();
    }
    // Off the serial path while the exchange completes: dW1's partial for
    // the slice (z^T T(dh_pre) over the 16 rows), the link before's db2
    // over this slice; then the ring's next items into link j's slot.
    const int n_dw1 = (need & kDw1) ? code_tiles * (wh / 16) : 0;
    for (int u = warp; u < n_dw1; u += kWarps) {
      const int m0 = (u / (wh / 16)) * 16, n0 = (u % (wh / 16)) * 16;
      if (m0 >= code || h0 + n0 >= hidden) continue;
      float acc[2][4] = {};
      weight_tile16(acc, zs + m0, L.ld_z, dst + n0, L.ld_h);
      store_tile(stg, acc, p.part + lk.slot[0] + grp * wsize + (size_t)m0 * hidden + h0 + n0,
                 hidden, min(16, code - m0), min(16, hidden - h0 - n0));
    }
    if (j > first && (links[j - 1].need & kDb2))
      for (int c = threadIdx.x; c < wo && o0 + c < code; c += kThreads) {
        float v = 0.f;
        for (int m = 0; m < nrows; ++m) v = __fadd_rn(v, to_float(gst[m * L.ld_o + c]));
        p.part[links[j - 1].slot[5] + (size_t)grp * code + o0 + c] = v;
      }
    __syncthreads();
    freed = kw;
    refill();
    if (j > first) wait_all();
    mark(mk + 4);
  }
  // The reduce (launched after this grid, programmatically dependent) may
  // start: its blocks wait for this grid's end before they read.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  join();
}

// The fixed-order sums of the row groups' slots: job y adds the `groups`
// slots of `count` floats at part + src (one after another) and writes the
// sum in bf16 or fp32.
struct Job {
  long long src;
  void* dst;
  int count, to_bf16;
};
struct ReduceArgs {
  Job job[kMaxLinks * kGrads];
  const float* part;
  int groups;
};

__global__ void __launch_bounds__(256) lis_chain_reduce(const __grid_constant__ ReduceArgs a) {
  // Launched while the chain kernel runs: wait for its end (and its writes).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const Job& jb = a.job[blockIdx.y];
  const int stride = gridDim.x * blockDim.x * 4;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4; i < jb.count; i += stride) {
    const float* s = a.part + jb.src + i;
    float4 v = *reinterpret_cast<const float4*>(s);
    for (int r = 1; r < a.groups; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(s + (size_t)r * jb.count);
      v.x = __fadd_rn(v.x, u.x), v.y = __fadd_rn(v.y, u.y);
      v.z = __fadd_rn(v.z, u.z), v.w = __fadd_rn(v.w, u.w);
    }
    if (jb.to_bf16) {
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(jb.dst) + i);
      d[0] = __floats2bfloat162_rn(v.x, v.y);
      d[1] = __floats2bfloat162_rn(v.z, v.w);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(jb.dst) + i) = v;
    }
  }
}

template <typename T>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(lis_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess)  // a cluster of 16 is above the portable 8
    err = cudaFuncSetAttribute(lis_chain_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T>
cudaLaunchConfig_t chain_config(int clusters, int cluster, int smem, cudaStream_t st,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A link's W1 (code rows of hidden) for TMA: boxes of wh columns by
// box_rows rows, dense in shared memory; reads outside W1 land as zeros.
bool w1_map(CUtensorMap* m, const void* w1, int code, int hidden, int wh, int box_rows,
            int esize) {
  const cuuint64_t dims[2] = {(cuuint64_t)hidden, (cuuint64_t)code};
  const cuuint64_t strides[1] = {(cuuint64_t)hidden * esize};
  const cuuint32_t box[2] = {(cuuint32_t)wh, (cuuint32_t)box_rows}, one[2] = {1, 1};
  gea::EncodeTiled fn = gea::encode_tiled();
  return fn != nullptr &&
         fn(m, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<void*>(w1), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const Args& p, const ReduceArgs& r, int groups, int reduce_blocks, int jobs,
           cudaStream_t st) {
  const int bytes = Layout(p.code, p.hidden, p.links, p.cluster, p.depth, sizeof(T)).bytes;
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes<T>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = chain_config<T>(groups, p.cluster, bytes, st, attr);
  err = cudaLaunchKernelEx(&cfg, lis_chain_kernel<T>, p);
  if (err != cudaSuccess) return (int)err;
  if (jobs > 0) {  // launched as the chain kernel's programmatic dependent: no launch gap
    cudaLaunchConfig_t rc = {};
    rc.gridDim = dim3(reduce_blocks, jobs);
    rc.blockDim = dim3(256);
    rc.stream = st;
    cudaLaunchAttribute ra[1];
    ra[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    ra[0].val.programmaticStreamSerializationAllowed = 1;
    rc.attrs = ra;
    rc.numAttrs = 1;
    err = cudaLaunchKernelEx(&rc, lis_chain_reduce, r);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of a block for these widths, links, cluster and ring
// depth (esize: bytes of the computing type, 2 bf16 or 4 fp32).
extern "C" int gea_lis_chain_smem_bytes(int code, int hidden, int links, int cluster, int depth,
                                        int esize) {
  return Layout(code, hidden, links, cluster, depth, esize).bytes;
}

// Clusters of `cluster` blocks of the chain kernel that the card holds at
// once, each block taking the most shared memory a block may have (one
// block an SM); negative: the CUDA error.
extern "C" int gea_lis_chain_max_clusters(int cluster, int is_bf16) {
  cudaError_t err = is_bf16 ? set_attributes<bf16>() : set_attributes<float>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  int n = 0;
  if (is_bf16) {
    const cudaLaunchConfig_t cfg = chain_config<bf16>(1, cluster, kSmemLimit, 0, attr);
    err = cudaOccupancyMaxActiveClusters(&n, lis_chain_kernel<bf16>, &cfg);
  } else {
    const cudaLaunchConfig_t cfg = chain_config<float>(1, cluster, kSmemLimit, 0, attr);
    err = cudaOccupancyMaxActiveClusters(&n, lis_chain_kernel<float>, &cfg);
  }
  return err == cudaSuccess ? n : -(int)err;
}

// ptr: per link (z, w1, b1, slope, trans, w2, g): z, w1, w2 and g in the
// computing type, the vectors fp32; then per link the outputs of the six
// slotted gradients (dW1, db1, dslope, dtrans, dW2, db2: dW1 and dW2 in
// bf16 or fp32, the vectors fp32; 0 where not asked for); then the first
// link's dz and the fp32 slots. dim: links, first (the lowest link asked
// anything of), batch, code, hidden, is_bf16, cluster, ring depth, row
// groups, reduce blocks; then per link its need (bit i for gradient i: dz,
// dW1, db1, dslope, dtrans, dW2, db2), dW1 in fp32, dW2 in fp32 and the
// six gradients' slot offsets (fp32 elements into the slots, -1 where
// unused). The host plan is gea_torch/ops/lis.py::backward_plan.
extern "C" int gea_lis_chain_backward(const unsigned long long* ptr, const long long* dim,
                                      void* stream) {
  Args p{};
  ReduceArgs r{};
  p.links = (int)dim[0], p.first = (int)dim[1], p.batch = (int)dim[2];
  p.code = (int)dim[3], p.hidden = (int)dim[4];
  const int is_bf16 = (int)dim[5];
  p.cluster = (int)dim[6], p.depth = (int)dim[7];
  const int groups = (int)dim[8], reduce_blocks = (int)dim[9];
  if (p.links < 1 || p.links > kMaxLinks || p.first < 0 || p.first >= p.links || p.batch <= 0 ||
      groups != cdiv(p.batch, kRows) || (p.cluster != 8 && p.cluster != 16) || p.depth < 1 ||
      p.depth > kBars - 1)
    return (int)cudaErrorInvalidValue;
  const int n = p.links;
  const unsigned long long* out = ptr + 7 * n;
  p.dz = reinterpret_cast<void*>(ptr[13 * n]);
  p.part = reinterpret_cast<float*>(ptr[13 * n + 1]);
#ifdef LIS_TRACE
  p.trace = reinterpret_cast<long long*>(ptr[13 * n + 2]);
#endif
  r.part = p.part;
  r.groups = groups;
  int jobs = 0;
  for (int j = 0; j < n; ++j) {
    Link& lk = p.link[j];
    const unsigned long long* in = ptr + 7 * j;
    lk.z = reinterpret_cast<const void*>(in[0]);
    lk.w1 = reinterpret_cast<const void*>(in[1]);
    lk.b1 = reinterpret_cast<const float*>(in[2]);
    lk.slope = reinterpret_cast<const float*>(in[3]);
    lk.trans = reinterpret_cast<const float*>(in[4]);
    lk.w2 = reinterpret_cast<const void*>(in[5]);
    lk.g = reinterpret_cast<const void*>(in[6]);
    const long long* d = dim + 10 + 9 * j;
    lk.need = (int)d[0];
    for (int k = 0; k < kGrads; ++k) {
      lk.slot[k] = d[3 + k];
      if (d[3 + k] < 0) continue;
      const bool weight = k == 0 || k == 4;
      Job& jb = r.job[jobs++];
      jb.src = d[3 + k];
      jb.dst = reinterpret_cast<void*>(out[kGrads * j + k]);
      jb.count = weight ? p.code * p.hidden : k == 5 ? p.code : p.hidden;
      jb.to_bf16 = weight && !d[k == 0 ? 1 : 2];
    }
  }
  const int esize = is_bf16 ? 2 : 4;
  const Layout L(p.code, p.hidden, n, p.cluster, p.depth, esize);
  for (int j = 0; j < n; ++j)
    if (!w1_map(&p.w1map[j], p.link[j].w1, p.code, p.hidden, L.wh, L.box_rows, esize))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(p, r, groups, reduce_blocks, jobs, st)
                 : launch<float>(p, r, groups, reduce_blocks, jobs, st);
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
