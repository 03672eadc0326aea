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
// A call is at most four launches, each only where a gradient asked for
// needs it (gea_torch/ops/seed.py::backward_plan sizes them on the host):
//
//  1. seed_bwd_project: the projection, exact (fp64 products and sums,
//     pre rounded once to fp32, then + bp, - trans in fp32), writing s
//     (fp32) and, when dWc is asked for, h. The TPReLU's branch (s < 0)
//     decides where dh passes at the slope, and a sum in another order
//     than the plain version's could land an s near 0 on the other side,
//     moving a column of dwp by up to a tenth of its largest value; the
//     plain versions compute pre the same way, so the two decide every
//     branch alike. 64 x 64 tiles, 4 warps of 32 x 32, fp64 mma.sync
//     m16n8k16 on the fp64 tensor cores; z and Wp arrive as they are
//     (bf16 or fp32) by cp.async into a 3-deep ring of k-steps of 64, and
//     each value becomes a double at fragment load (bf16: ldmatrix, then a
//     shift), so the copies overlap the products and shared memory holds
//     2-byte values. Blocks past the tiles take partial column sums of g
//     (dbc) in fixed chunks of rows.
//  2. seed_bwd_gemm<D>: the conv's data gradient dh, with the ds step in
//     its epilogue. Rows are the s0*s0 pixels of as many whole images as
//     fill 128 rows, columns c0, K = 16 taps x c1. For a tap the A box is g
//     at the tap's stride-2 positions: a 5-d tensor map of g, (px and
//     channel, w/2, py, h/2, image), read at the tap's parity and shift, so
//     TMA gathers the window and zero-fills the border. B is Wc[kh, kw]
//     read K-major from the HWIO weights in place. The epilogue rounds dh to
//     z's type from the fp32 accumulator, reads s, writes ds = T(where(s <
//     0, slope * dh, dh)), and each warp writes its column sums of dh * s
//     and dh * (1 - fprime) over its 16 rows (negative branch) into a slot
//     of its own: dh never reaches memory.
//  3. seed_bwd_gemm<W>: dz, dwp and dWc in one launch, over a list of
//     items: dz = ds @ Wp^T (both K-major) in K chunks, fp32 partials a
//     chunk; dwp = z^T ds (both N-major, K the batch); dWc[tap] = sum over
//     the tap's pixel pairs (h[:, i, j], g[:, 2i-1+kh, 2j-1+kw]) of A^T B,
//     each a 3-d map (channels, pixels, batch) read one pixel plane a box,
//     its K split into wc_chunks fixed chunks (fp32 partials) where the
//     taps' tiles alone would not fill the card. Items are listed by cost,
//     the longest first (the centre taps' dWc, then the edges', the
//     corners', the dz chunks, dwp), and dealt to the blocks in a snake
//     order (block b takes items b, 2G - 1 - b, 2G + b, ...).
//  4. seed_bwd_reduce: every set of partials summed in a fixed order (dz
//     over its chunks, dbp over the batch from ds, dslope and dtrans over
//     the D warps' slots, dWc over its chunks, dbc over g's row chunks),
//     and cast to the gradients' types.
//
// bf16 design of the two tensor-core passes: persistent and warp
// specialised. One block a SM (G = min(SMs, items) blocks) walks a fixed
// list of 128 x 128 output tiles; warpgroup 0's first thread is the
// producer and keeps TMA loads in flight on a ring of four 32 KB stages,
// an mbarrier a slot for full and one for empty; warpgroups 1 and
// 2 are the consumers (setmaxnreg: 232 registers a thread against the
// producer's 40), 64 rows each, wgmma m64n128k16 with both operands read
// from shared memory and fp32 accumulators, each warp releasing a slot as
// soon as the product that read it has retired. So the next tile's loads
// run during a tile's epilogue. The epilogues stage the output tile in
// shared memory with the 128-byte swizzle and write it by TMA stores; D's
// tile of s arrives by TMA beside the operands.
//
// There are no atomics: every partial has a slot of its own, written once,
// and the reduce adds them in a fixed order, so the gradients are the same
// bit for bit from run to run.
//
// The fp32 instance (TF32 would lose the fp32 tolerance) shares launches 1
// and 4 and runs D, dz, dwp and dWc as simple tiled products on the CUDA
// cores (seed_bwd_f32: 64 x 64 tiles, 4 x 4 outputs a thread) with the same
// epilogues (D's ds step and slots too), dWc unsplit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "wgmma.cuh"

namespace {

using gea::bf16;

enum Pass { kData = 1, kDz = 2, kWeight = 3 };
enum Item { kItemD = 0, kItemZ = 1, kItemP = 2, kItemC = 3 };  // D; W: dz, dwp, dWc

struct Args {
  int batch, code, s0, c0, c1, proj, area;
  int per;                         // D (bf16): whole images a tile
  int nkb, nkc;                    // k-steps of 64 over the batch, over c1
  int z_chunk, z_steps, splits;    // dz: k-steps a chunk, k-steps in all, chunks
  int wc_chunks;                   // dWc (bf16): K chunks a tap
  int n_wc, n_z, n_wp;             // W (bf16): items of each kind
  int d_tiles_n, d_items;          // D: column tiles, tiles in all
  int sums, act_slots;             // D: write dslope and dtrans partials; slots
  int dwp_bf16, dwc_bf16;          // output types
  int r_tiles_n, r_tiles, colsum_rows;  // projection tiles (columns, all); dbc rows a chunk
  int w_rows, w_cols, w_taps, w_bf16;   // fp32 W: output (taps or 1, rows, cols)
  const void *z, *wp, *wc, *g;
  const float *bp, *slope, *trans;
  float* s;           // (batch, proj) fp32
  void* h;            // (batch, proj) in z's type, or null
  void* ds;           // (batch, proj) in z's type
  float* dz_part;     // (splits, batch, code)
  float* part_act;    // (2, act_slots, c0): dslope, dtrans
  float* part_bc;     // (gchunks, c1)
  float* wc_part;     // (wc_chunks, 16, c0, c1) where wc_chunks > 1
  void *dwp, *dwc;    // outputs
  void* w_out;        // fp32 W
  const void *a_src, *b_src;  // fp32 W: A(m, (pos, n)) = a_src[n * a_ld + plane_a * a_ps + m]
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
// The taps by cost, the centre four (s0 x s0 pixel pairs) first, then the
// eight edges (s0 x (s0 - 1)), then the corners: nibble r is the r-th tap.
constexpr unsigned long long kTapsByCost = 0xFC30EDB87421A965ull;
__device__ __forceinline__ int tap_by_cost(int r) { return (int)((kTapsByCost >> (4 * r)) & 15); }

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
__device__ __forceinline__ void store2(void* p, bool is_bf16, size_t o, float v0, float v1,
                                       bool both) {
  if (is_bf16)
    store2(static_cast<bf16*>(p) + o, v0, v1, both);
  else
    store2(static_cast<float*>(p) + o, v0, v1, both);
}

// The ds step for one element of D's output: dh (the fp32 sum) rounded to
// T, ds = T(where(s < 0, a dh, dh)) written at ds[o], and where s < 0 the
// terms dh * s and dh * (1 - a) added to the thread's sums.
template <typename T>
__device__ __forceinline__ void ds_step(const Args& p, size_t o, float acc, float sv, float a,
                                        float& sum_slope, float& sum_trans) {
  const float d = to_float(from_float<T>(acc));
  const bool neg = sv < 0.f;
  static_cast<T*>(p.ds)[o] = from_float<T>(neg ? __fmul_rn(a, d) : d);
  if (neg) {
    sum_slope = __fadd_rn(sum_slope, __fmul_rn(d, sv));
    sum_trans = __fadd_rn(sum_trans, __fmul_rn(d, __fsub_rn(1.f, a)));
  }
}

// ------------------------------------------------------------ 1. the projection, exact

// D (16 x 8) += A (16 x 16) B (16 x 8) in fp64 on the tensor cores (sm_90).
// Fragments (g = lane / 4, t = lane % 4): a[2i] (row g, k slot i of lane
// t), a[2i + 1] (row g + 8, slot i), b[i] (slot i, column g), d as
// mma.m16n8k16's C. Any assignment of the 16 k to the 4 x 4 (t, i) slots
// gives the same product, as long as A and B use the same one; here slot i
// of lane t holds k = {2t, 2t + 1, 2t + 8, 2t + 9}[i], which is where
// ldmatrix puts the bf16 values of mma.m16n8k16's own fragments.
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// The two bf16 values of a 32-bit register as doubles (exact): low half
// first.
__device__ __forceinline__ void bf2_to_d(uint32_t v, double& lo, double& hi) {
  lo = (double)__uint_as_float(v << 16);
  hi = (double)__uint_as_float(v & 0xffff0000u);
}

constexpr int kRM = 64, kRN = 64, kRK = 64, kRStages = 3;  // tile, k-step, ring depth
constexpr int kRJ = kRN / 16;  // n8 tiles a warp (2 x 2 warps of 32 x kRN / 2)

// Shared-memory ring of the projection: z's rows (k contiguous) and Wp's
// rows (columns contiguous), each row padded by 16 bytes, so the 8 rows an
// ldmatrix matrix reads fall in distinct 16-byte bank groups.
template <typename T>
struct RTile {
  static constexpr int pad = 16 / sizeof(T);
  static constexpr int lda = kRK + pad, ldb = kRN + pad;
  static constexpr int a_elems = kRM * lda, b_elems = kRK * ldb;
  static constexpr int stage = a_elems + b_elems;  // elements
  static constexpr int smem = kRStages * stage * (int)sizeof(T);
};

template <typename T>
__device__ __forceinline__ void project_load(const Args& p, T* as, T* bs, int m0, int n0, int k0) {
  constexpr int V = 16 / sizeof(T);
  const T* z = static_cast<const T*>(p.z);
  const T* wp = static_cast<const T*>(p.wp);
  for (int e = threadIdx.x; e < kRM * kRK / V; e += 128) {
    const int r = e / (kRK / V), c = (e % (kRK / V)) * V, m = m0 + r, k = k0 + c;
    const bool ok = m < p.batch && k < p.code;
    gea::cp_async16(as + r * RTile<T>::lda + c, ok ? z + (size_t)m * p.code + k : z, ok ? 16 : 0);
  }
  for (int e = threadIdx.x; e < kRK * kRN / V; e += 128) {
    const int r = e / (kRN / V), c = (e % (kRN / V)) * V, k = k0 + r, n = n0 + c;
    const bool ok = k < p.code && n < p.proj;
    gea::cp_async16(bs + r * RTile<T>::ldb + c, ok ? wp + (size_t)k * p.proj + n : wp,
                    ok ? 16 : 0);
  }
}

// A fragments (rows r0 .. r0 + 15, k kk .. kk + 15) and the B fragments of
// two n8 tiles (columns c .. c + 15), as doubles.
__device__ __forceinline__ void frag_a(double (&af)[8], const bf16* as, int r0, int kk) {
  const int lane = threadIdx.x % 32;
  uint32_t a[4];
  gea::ldmatrix_x4(a, as + (r0 + (lane & 15)) * RTile<bf16>::lda + kk + (lane >> 4) * 8);
  bf2_to_d(a[0], af[0], af[2]);
  bf2_to_d(a[1], af[1], af[3]);
  bf2_to_d(a[2], af[4], af[6]);
  bf2_to_d(a[3], af[5], af[7]);
}
__device__ __forceinline__ void frag_a(double (&af)[8], const float* as, int r0, int kk) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* row = as + (r0 + g + 8 * h) * RTile<float>::lda + kk + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(row);
    const float2 hi = *reinterpret_cast<const float2*>(row + 8);
    af[h] = lo.x, af[2 + h] = lo.y, af[4 + h] = hi.x, af[6 + h] = hi.y;
  }
}
__device__ __forceinline__ void frag_b(double (&b0)[4], double (&b1)[4], const bf16* bs, int kk,
                                       int c) {
  const int lane = threadIdx.x % 32, mm = lane >> 3;
  uint32_t b[4];
  gea::ldmatrix_x4_trans(b, bs + (kk + (lane & 7) + (mm & 1) * 8) * RTile<bf16>::ldb + c +
                                (mm >> 1) * 8);
  bf2_to_d(b[0], b0[0], b0[1]);
  bf2_to_d(b[1], b0[2], b0[3]);
  bf2_to_d(b[2], b1[0], b1[1]);
  bf2_to_d(b[3], b1[2], b1[3]);
}
__device__ __forceinline__ void frag_b(double (&b0)[4], double (&b1)[4], const float* bs, int kk,
                                       int c) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ks[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* row = bs + (kk + ks[i]) * RTile<float>::ldb + c + g;
    b0[i] = row[0];
    b1[i] = row[8];
  }
}

// Blocks [0, r_tiles): pre = z @ Wp in fp64 (products of bf16 or fp32
// values are exact there), rounded once to fp32, + bp, - trans: s, and h.
// Blocks past them: partial column sums of g (dbc), 128 columns and
// colsum_rows rows a block.
template <typename T>
__global__ void __launch_bounds__(128) seed_bwd_project(const Args p) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= p.r_tiles) {
    const int q = blockIdx.x - p.r_tiles, nx = cdiv(p.c1, 128);
    const int col = (q % nx) * 128 + tid, chunk = q / nx;
    if (col >= p.c1) return;
    const int rows_total = p.batch * 4 * p.area;
    const int r0 = chunk * p.colsum_rows, r1 = min(rows_total, r0 + p.colsum_rows);
    const T* g = static_cast<const T*>(p.g);
    float acc = 0.f;
    for (int r = r0; r < r1; ++r) acc = __fadd_rn(acc, to_float(g[(size_t)r * p.c1 + col]));
    p.part_bc[(size_t)chunk * p.c1 + col] = acc;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = (blockIdx.x / p.r_tiles_n) * kRM, n0 = (blockIdx.x % p.r_tiles_n) * kRN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (kRN / 2);
  const int ksteps = cdiv(p.code, kRK);
  double acc[2][kRJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kRJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  auto slot_a = [&](int s) { return ring + s * RTile<T>::stage; };
  auto slot_b = [&](int s) { return ring + s * RTile<T>::stage + RTile<T>::a_elems; };
#pragma unroll
  for (int s = 0; s < kRStages - 1; ++s) {
    if (s < ksteps) project_load(p, slot_a(s), slot_b(s), m0, n0, s * kRK);
    gea::cp_async_commit();
  }
  for (int kt = 0; kt < ksteps; ++kt) {
    gea::cp_async_wait<kRStages - 2>();
    __syncthreads();  // step kt landed for every thread; slot (kt - 1) % S is free
    const int next = kt + kRStages - 1;
    if (next < ksteps)
      project_load(p, slot_a(next % kRStages), slot_b(next % kRStages), m0, n0, next * kRK);
    gea::cp_async_commit();
    const T* as = slot_a(kt % kRStages);
    const T* bs = slot_b(kt % kRStages);
#pragma unroll
    for (int kk = 0; kk < kRK; kk += 16) {
      double af[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i) frag_a(af[i], as, wm + 16 * i, kk);
#pragma unroll
      for (int jp = 0; jp < kRJ / 2; ++jp) {
        double b0[4], b1[4];
        frag_b(b0, b1, bs, kk, wn + 16 * jp);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dmma16(acc[i][2 * jp], af[i], b0);
          dmma16(acc[i][2 * jp + 1], af[i], b1);
        }
      }
    }
  }
  gea::cp_async_wait<0>();

  // s = (fp32(pre) + bp) - trans, h = T(tprelu(s) + trans); columns in
  // pairs (proj is even).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kRJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm + 16 * i + g + 8 * hh, col = n0 + wn + 8 * j + 2 * t;
        if (row >= p.batch || col >= p.proj) continue;
        const size_t o = (size_t)row * p.proj + col;
        float s[2], h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = (col + e) % p.c0;
          const float tr = __ldg(p.trans + c), a = __ldg(p.slope + c);
          s[e] = __fsub_rn(__fadd_rn(__double2float_rn(acc[i][j][2 * hh + e]),
                                     __ldg(p.bp + col + e)), tr);
          h[e] = __fadd_rn(__fadd_rn(fmaxf(s[e], 0.f), __fmul_rn(a, fminf(s[e], 0.f))), tr);
        }
        store2(p.s + o, s[0], s[1], true);
        if (p.h != nullptr) store2(static_cast<T*>(p.h) + o, h[0], h[1], true);
      }
}

// ------------------------------------------------------------ 2, 3. bf16, TMA + wgmma

constexpr int kBM = 128, kBN = 128;         // output tile (two consumer warpgroups of 64 rows)
constexpr int kTile = 128 * 128;            // bytes of the A or B tile of a k-step (64 k)
constexpr int kBox = 64 * 128;              // one 64 x 64 box
constexpr int kStage = 2 * kTile;
constexpr int kStages = 4;
constexpr int kThreadsWS = 384;             // producer warpgroup + two consumer warpgroups
constexpr int kChunk = kBM * 128;           // a tile's 128-byte column chunk: 128 rows x 128 B
// Shared memory after the ring: the output tile staged for its TMA store
// (D: ds in bf16; W: up to fp32), and D's tile of s (fp32), each as
// 128-byte column chunks with the 128-byte swizzle; then the barriers.
template <int KIND>
struct WSmem {
  static constexpr int staging = KIND == kData ? 2 * kChunk : 4 * kChunk;
  static constexpr int s_tile = KIND == kData ? 4 * kChunk : 0;
  static constexpr int bars = kStages * kStage + staging + s_tile;
  static constexpr int bytes = bars + 8 * (2 * kStages + 2) + 1024;  // + alignment to 1 KB
};

// The tensor maps of a pass. D: g (5-d) and Wc (the operands), s (loaded
// for the epilogue), ds (stored). W: ds and Wp (dz), z and ds (dwp), h and
// g (dWc), then the stores: dz's partials, dwp, dWc (or its partials).
struct Maps {
  CUtensorMap m[9];
};

struct Work {
  int kind, m0, n0, tap, k0, k1, slot;
};

// D's item i: image group (slot) and column tile, every k-step.
__device__ __forceinline__ Work d_item(const Args& p, int i) {
  const int m = i / p.d_tiles_n;
  return {kItemD, m * p.per, (i % p.d_tiles_n) * kBN, 0, 0, 16 * p.nkc, m};
}

// W's item i: dWc tiles and chunks (taps by cost), dz tiles and chunks,
// dwp tiles. gea_torch/ops/seed.py::BackwardPlan.w_item lists the same.
__device__ __forceinline__ Work w_item(const Args& p, int i) {
  if (i < p.n_wc) {
    const int ncol = cdiv(p.c1, kBN), per_tap = cdiv(p.c0, kBM) * ncol * p.wc_chunks;
    const int tap = tap_by_cost(i / per_tap), q = i % per_tap;
    const int tile = q / p.wc_chunks, chunk = q % p.wc_chunks;
    const TapPositions t = tap_positions(p.s0, tap);
    const int k = t.ni * t.nj * p.nkb;
    return {kItemC, (tile / ncol) * kBM, (tile % ncol) * kBN, tap, chunk * k / p.wc_chunks,
            (chunk + 1) * k / p.wc_chunks, chunk};
  }
  i -= p.n_wc;
  if (i < p.n_z) {
    const int ncol = cdiv(p.code, kBN), split = i % p.splits, tile = i / p.splits;
    const int k0 = split * p.z_chunk;
    return {kItemZ, (tile / ncol) * kBM, (tile % ncol) * kBN, 0, k0, min(k0 + p.z_chunk, p.z_steps),
            split};
  }
  i -= p.n_z;
  const int ncol = cdiv(p.proj, kBN);
  return {kItemP, (i / ncol) * kBM, (i % ncol) * kBN, 0, 0, p.nkb, 0};
}

// The j-th item of block b of G, in snake order (W) or in turn (D); may
// be past the end.
__device__ __forceinline__ int item_of(int j, int b, int G, bool snake) {
  return j * G + (snake && (j & 1) ? G - 1 - b : b);
}

// Copies of k-step kt of item x into a stage (a, b), completing on bar.
template <int KIND>
__device__ __forceinline__ void issue(const Args& p, const Maps& maps, const Work& x, int kt,
                                      unsigned char* sa, uint64_t* bar) {
  unsigned char* sb = sa + kTile;
  if (KIND == kData) {
    // g as (2 c1, s0, 2, s0, batch) box {64, s0, 1, s0, per} at the tap's
    // parity (px, py) and shift (dj, di); Wc (c1, c0, 16) box {64, 128, 1}.
    const int tap = kt / p.nkc, k0 = (kt - tap * p.nkc) * 64;
    const int kh = tap >> 2, kw = tap & 3, py = (kh + 1) & 1, px = (kw + 1) & 1;
    gea::tma_load_5d(sa, &maps.m[0], px * p.c1 + k0, (kw - 1 - px) / 2, py, (kh - 1 - py) / 2,
                     x.m0, bar);
    gea::tma_load_3d(sb, &maps.m[1], k0, x.n0, tap, bar);
  } else if (x.kind == kItemZ) {  // ds (proj, batch) box {64, 128}; Wp (proj, code) box {64, 128}
    gea::tma_load_2d(sa, &maps.m[0], kt * 64, x.m0, bar);
    gea::tma_load_2d(sb, &maps.m[1], kt * 64, x.n0, bar);
  } else {  // (columns, planes, batch) boxes {64, 1, 64}
    int pa = 0, pb = 0, k0 = kt * 64, map = 2;
    if (x.kind == kItemC) {
      const int pos = kt / p.nkb;
      k0 = (kt - pos * p.nkb) * 64;
      tap_planes(p.s0, x.tap, pos, pa, pb);
      map = 4;
    }
#pragma unroll
    for (int w = 0; w < 2; ++w)
      gea::tma_load_3d(sa + w * kBox, &maps.m[map], x.m0 + 64 * w, pa, k0, bar);
#pragma unroll
    for (int w = 0; w < 2; ++w)
      gea::tma_load_3d(sb + w * kBox, &maps.m[map + 1], x.n0 + 64 * w, pb, k0, bar);
  }
}

// One k-step of 64 on the stage at (sa, sb) for this warpgroup's 64 rows.
// MN: both operands N-major (dwp, dWc), else both K-major (D, dz).
template <int MN>
__device__ __forceinline__ void mma_step(float* acc, const unsigned char* sa,
                                         const unsigned char* sb) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t da = MN ? gea::wgmma_desc_sw128(sa + s * 2048, kBox, 1024)
                           : gea::wgmma_desc_sw128(sa + s * 32, 0, 1024);
    const uint64_t db = MN ? gea::wgmma_desc_sw128(sb + s * 2048, kBox, 1024)
                           : gea::wgmma_desc_sw128(sb + s * 32, 0, 1024);
    gea::wgmma_m64n128k16_ss<MN, MN>(acc, da, db);
  }
}

// The k-steps of item x for consumer warpgroup c: wait for a stage, run
// its products, and release the stage before (each warp, once the product
// that read it has retired). MN: both operands N-major, else K-major.
template <int MN>
__device__ __forceinline__ void consume(float* acc, const Work& x, int& it, unsigned char* base,
                                        uint64_t* full, uint64_t* empty, int c, int lane) {
  for (int kt = x.k0; kt < x.k1; ++kt, ++it) {
    const int slot = it % kStages;
    gea::mbar_wait(&full[slot], (it / kStages) & 1);
#pragma unroll
    for (int r = 0; r < 64; ++r) gea::reg_fence(acc[r]);
    gea::wgmma_fence();
    mma_step<MN>(acc, base + slot * kStage + c * kBox, base + slot * kStage + kTile);
    gea::wgmma_commit();
    gea::wgmma_wait<1>();  // the previous k-step's product retired: its stage is free
#pragma unroll
    for (int r = 0; r < 64; ++r) gea::reg_fence(acc[r]);
    if (kt > x.k0 && lane == 0) gea::mbar_arrive(&empty[(it + kStages - 1) % kStages]);
  }
  gea::wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 64; ++r) gea::reg_fence(acc[r]);
  if (x.k1 > x.k0 && lane == 0) gea::mbar_arrive(&empty[(it + kStages - 1) % kStages]);
}

// Byte offset of (row, byte) in a tile stored as 128-byte column chunks
// with the 128-byte swizzle (the 16-byte unit XOR the row's low 3 bits), as
// TMA reads and writes it: byte counts from the tile's first column, in
// units of the element size.
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  return (byte >> 7) * kChunk + row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// The consumers' turn on the staging tile: the previous tile's store has
// read it (thread 128 issues the stores), and every consumer is here.
__device__ __forceinline__ void staging_acquire() {
  if (threadIdx.x == 128) gea::bulk_wait_read();
  gea::named_barrier(1, 256);
}
// The staging tile written: fenced for TMA, and every consumer done.
__device__ __forceinline__ void staging_release() {
  gea::fence_proxy_async();
  gea::named_barrier(1, 256);
}

// D's epilogue for consumer warpgroup c: the ds step on the accumulators
// (s from the tile of s that the producer loaded), ds staged for one TMA
// store a 64-column chunk, and each warp's column sums of the negative
// branch over its 16 rows into slot (image group) * 8 + 4c + warp.
__device__ __forceinline__ void d_epilogue(const Args& p, const Work& x, int c, const float* acc,
                                           uint32_t staging, uint32_t s_tile) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int rows = p.per * p.area, total = p.batch * p.area;
  int r[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] = 64 * c + 16 * warp + g + 8 * h;
    ok[h] = r[h] < rows && x.m0 * p.area + r[h] < total;
  }
  const size_t slot = (size_t)x.slot * 8 + 4 * c + warp, stride = (size_t)p.act_slots * p.c0;
#pragma unroll
  for (int j0 = 0; j0 < 16; j0 += 4) {
    float sl[8], tr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sl[i] = tr[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = 8 * (j0 + jj) + 2 * t4, gcol = x.n0 + col;
      const bool oc = gcol < p.c0;
      const float a0 = oc ? __ldg(p.slope + gcol) : 0.f, a1 = oc ? __ldg(p.slope + gcol + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r[h] >= rows) continue;
        const float2 sv = gea::lds_f32x2(s_tile + swz(r[h], 4 * col));
        const float s2[2] = {sv.x, sv.y}, a[2] = {a0, a1};
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = __bfloat162float(__float2bfloat16_rn(acc[4 * (j0 + jj) + 2 * h + e]));
          const bool neg = s2[e] < 0.f;
          v[e] = neg ? __fmul_rn(a[e], d) : d;
          if (neg && ok[h] && oc) {
            sl[2 * jj + e] = __fadd_rn(sl[2 * jj + e], __fmul_rn(d, s2[e]));
            tr[2 * jj + e] = __fadd_rn(tr[2 * jj + e], __fmul_rn(d, __fsub_rn(1.f, a[e])));
          }
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
        gea::sts_b32(staging + swz(r[h], 2 * col), *reinterpret_cast<const uint32_t*>(&pair));
      }
    }
    if (!p.sums) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        sl[i] = __fadd_rn(sl[i], __shfl_xor_sync(0xffffffffu, sl[i], m));
        tr[i] = __fadd_rn(tr[i], __shfl_xor_sync(0xffffffffu, tr[i], m));
      }
    if (g != 0) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gcol = x.n0 + 8 * (j0 + jj) + 2 * t4;
      if (gcol >= p.c0) continue;
      store2(p.part_act + slot * p.c0 + gcol, sl[2 * jj], sl[2 * jj + 1], true);
      store2(p.part_act + stride + slot * p.c0 + gcol, tr[2 * jj], tr[2 * jj + 1], true);
    }
  }
}

// W's epilogue: the tile in its output type (fp32 for the partials of dz
// and dWc) staged for its TMA stores.
__device__ __forceinline__ void w_stage(int c, const float* acc, uint32_t staging, bool out_bf16) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * c + 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t4;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (out_bf16) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
        gea::sts_b32(staging + swz(r, 2 * col), *reinterpret_cast<const uint32_t*>(&pair));
      } else {
        gea::sts_f32x2(staging + swz(r, 4 * col), v0, v1);
      }
    }
  }
}

// A persistent, warp-specialised pass (KIND kData or kWeight): gridDim.x
// blocks, each walking its items; see the top of this file.
template <int KIND>
__global__ void __launch_bounds__(kThreadsWS, 1)
seed_bwd_gemm(const __grid_constant__ Maps maps, const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* staging = base + kStages * kStage;
  unsigned char* s_tile = staging + WSmem<KIND>::staging;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + WSmem<KIND>::bars);
  uint64_t* empty = full + kStages;
  uint64_t* s_full = empty + kStages;  // D: the tile of s landed
  uint64_t* s_empty = s_full + 1;      // D: every consumer warp has read it
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int G = gridDim.x, b = blockIdx.x;
  const bool snake = KIND == kWeight;
  const int total = KIND == kData ? p.d_items : p.n_wc + p.n_z + p.n_wp;
  const int rows_d = p.per * p.area;  // D: rows a tile
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      gea::mbar_init(&full[s], 1);
      gea::mbar_init(&empty[s], 8);  // every consumer warp
    }
    gea::mbar_init(s_full, 1);
    gea::mbar_init(s_empty, 8);
    gea::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    gea::setmaxnreg_dec<40>();
    if (tid != 0) return;
    int it = 0, tile = 0;
    for (int j = 0; j * G < total; ++j) {
      const int i = item_of(j, b, G, snake);
      if (i >= total) continue;
      const Work x = KIND == kData ? d_item(p, i) : w_item(p, i);
      // TMA counts a box's bytes whole, zero-filled parts included.
      const uint32_t bytes = (KIND == kData ? rows_d * 128 : kTile) + kTile;
      for (int kt = x.k0; kt < x.k1; ++kt, ++it) {
        const int slot = it % kStages;
        if (it >= kStages) gea::mbar_wait(&empty[slot], ((it / kStages) + 1) & 1);
        gea::mbar_expect_tx(&full[slot], bytes);
        issue<KIND>(p, maps, x, kt, base + slot * kStage, &full[slot]);
      }
      if (KIND == kData) {  // the tile's s, once the previous tile's epilogue has read it
        if (tile > 0) gea::mbar_wait(s_empty, (tile - 1) & 1);
        gea::mbar_expect_tx(s_full, 4 * rows_d * 128);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gea::tma_load_2d(s_tile + q * kChunk, &maps.m[2], x.n0 + 32 * q, x.m0 * p.area, s_full);
      }
      ++tile;
    }
    return;
  }

  gea::setmaxnreg_inc<232>();  // 128 x 40 + 256 x 232 registers: the SM's 64K
  const int c = wg - 1;  // consumer warpgroup: rows 64 c .. 64 c + 63 of a tile
  int it = 0, tile = 0;
  float acc[64];
  for (int j = 0; j * G < total; ++j) {
    const int i = item_of(j, b, G, snake);
    if (i >= total) continue;
    const Work x = KIND == kData ? d_item(p, i) : w_item(p, i);
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;
    // The whole k-loop under one operand layout, so that no branch sits
    // between two products on the accumulators.
    if (KIND == kWeight && x.kind != kItemZ)
      consume<1>(acc, x, it, base, full, empty, c, lane);
    else
      consume<0>(acc, x, it, base, full, empty, c, lane);

    staging_acquire();
    if (KIND == kData) {
      gea::mbar_wait(s_full, tile & 1);
      d_epilogue(p, x, c, acc, gea::smem_u32(staging), gea::smem_u32(s_tile));
      __syncwarp();
      if (lane == 0) gea::mbar_arrive(s_empty);
      staging_release();
      if (tid == 128) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          gea::tma_store_2d(&maps.m[3], staging + q * kChunk, x.n0 + 64 * q, x.m0 * p.area);
        gea::bulk_commit();
      }
    } else {
      const bool out_bf16 = x.kind == kItemP   ? p.dwp_bf16
                            : x.kind == kItemC ? p.dwc_bf16 && p.wc_chunks == 1
                                               : false;
      w_stage(c, acc, gea::smem_u32(staging), out_bf16);
      staging_release();
      if (tid == 128) {
        const int e = out_bf16 ? 64 : 32;  // columns a 128-byte chunk
        for (int q = 0; q * e < kBN; ++q) {
          const unsigned char* src = staging + q * kChunk;
          if (x.kind == kItemZ)
            gea::tma_store_3d(&maps.m[6], src, x.n0 + q * e, x.m0, x.slot);
          else if (x.kind == kItemP)
            gea::tma_store_2d(&maps.m[7], src, x.n0 + q * e, x.m0);
          else
            gea::tma_store_3d(&maps.m[8], src, x.n0 + q * e, x.m0,
                              p.wc_chunks == 1 ? x.tap : x.slot * 16 + x.tap);
        }
        gea::bulk_commit();
      }
    }
    ++tile;
  }
  if (tid == 128) gea::bulk_wait();
}

// ------------------------------------------------------------ fp32, CUDA cores

constexpr int kFT = 64, kFK = 16;  // output tile, k-step

template <int PASS>
__device__ __forceinline__ float a_f32(const Args& p, int m, int k) {
  if (PASS == kData) {
    const int tap = k / p.c1, c = k - tap * p.c1, side = 2 * p.s0;
    const int img = m / p.area, rem = m - img * p.area, i = rem / p.s0, j = rem - i * p.s0;
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
    rows = p.batch * p.area, cols = p.c0, k1 = 16 * p.c1;
  } else if (PASS == kDz) {
    rows = p.batch, cols = p.code;
    k0 = blockIdx.z * p.z_chunk * 64;
    k1 = min(k0 + p.z_chunk * 64, p.proj);
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

  if (PASS == kData) {  // the ds step; a warp's 8 rows (ty, ty ^ 1) summed into its slot
    float sl[4] = {0.f, 0.f, 0.f, 0.f}, tr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col >= cols) continue;
        const size_t o = (size_t)row * p.c0 + col;
        ds_step<float>(p, o, acc[i][j], p.s[o], __ldg(p.slope + col), sl[j], tr[j]);
      }
    }
    if (!p.sums) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sl[j] = __fadd_rn(sl[j], __shfl_xor_sync(0xffffffffu, sl[j], 16));
      tr[j] = __fadd_rn(tr[j], __shfl_xor_sync(0xffffffffu, tr[j], 16));
    }
    if (tid % 32 >= 16) return;
    const size_t slot = (size_t)blockIdx.x * 8 + tid / 32, stride = (size_t)p.act_slots * p.c0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= cols) continue;
      p.part_act[slot * p.c0 + col] = sl[j];
      p.part_act[stride + slot * p.c0 + col] = tr[j];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row >= rows || col >= cols) continue;
      if (PASS == kDz)
        store2(p.dz_part + ((size_t)blockIdx.z * p.batch + row) * p.code + col, acc[i][j],
               acc[i][j + 1], col + 1 < cols);
      else
        store2(p.w_out, p.w_bf16, ((size_t)blockIdx.z * rows + row) * cols + col, acc[i][j],
               acc[i][j + 1], col + 1 < cols);
    }
}

// ------------------------------------------------------------ 4. sums, both types

// dst[c] = sum_{i < r} src[i * c_total + c], in a fixed order: the 8 warps
// of a block take every 8th term (16 loads at a time, added in turn), then
// warp 0 adds their 8 sums in order. A block sums 32 columns of one set of
// partials; the sets come longest first, so their blocks start first.
struct Sum {
  const void* src;
  void* dst;
  int r, c, src_bf16, dst_bf16;
};
struct Sums {
  Sum s[6];
};

__device__ __forceinline__ float load_term(const void* src, size_t o, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(src)[o])
                 : static_cast<const float*>(src)[o];
}

__global__ void __launch_bounds__(256) seed_bwd_reduce(const Sums sums) {
  __shared__ float part[8][33];
  int k = 0, group = blockIdx.x;
  while (group >= cdiv(sums.s[k].c, 32)) group -= cdiv(sums.s[k++].c, 32);
  const Sum t = sums.s[k];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = group * 32 + lane;
  float acc = 0.f;
  if (c < t.c) {
    int i = w;
    for (; i + 15 * 8 < t.r; i += 16 * 8) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        v[u] = load_term(t.src, (size_t)(i + 8 * u) * t.c + c, t.src_bf16);
#pragma unroll
      for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; i < t.r; i += 8) acc = __fadd_rn(acc, load_term(t.src, (size_t)i * t.c + c, t.src_bf16));
  }
  part[w][lane] = acc;
  __syncthreads();
  if (w != 0 || c >= t.c) return;
  for (int q = 1; q < 8; ++q) acc = __fadd_rn(acc, part[q][lane]);
  if (t.dst_bf16)
    static_cast<bf16*>(t.dst)[c] = __float2bfloat16_rn(acc);
  else
    static_cast<float*>(t.dst)[c] = acc;
}

// ------------------------------------------------------------ host

typedef unsigned long long u64;
typedef cuuint64_t D;
typedef cuuint32_t B;

#define GEA_TRY(x)              \
  do {                          \
    const int rc_ = (x);        \
    if (rc_ != 0) return rc_;   \
  } while (0)

template <int KIND>
int launch_gemm(const Maps& maps, const Args& p, int grid, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      seed_bwd_gemm<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, WSmem<KIND>::bytes);
  if (err != cudaSuccess) return (int)err;
  seed_bwd_gemm<KIND><<<grid, kThreadsWS, WSmem<KIND>::bytes, st>>>(maps, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_project(const Args& p, int blocks, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(seed_bwd_project<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         RTile<T>::smem);
  if (err != cudaSuccess) return (int)err;
  seed_bwd_project<T><<<blocks, 128, RTile<T>::smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int PASS>
int launch_f32(const Args& p, dim3 grid, cudaStream_t st) {
  seed_bwd_f32<PASS><<<grid, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

int backward(const u64* ptr, const int* dim, cudaStream_t st) {
  Args p{};
  p.batch = dim[0], p.code = dim[1], p.s0 = dim[2], p.c0 = dim[3], p.c1 = dim[4];
  const int is_bf16 = dim[5], need = dim[6], out_bf16 = dim[7];
  p.z_chunk = dim[8], p.splits = dim[9], p.wc_chunks = dim[10], p.colsum_rows = dim[11];
  const int gchunks = dim[12], d_tiles_m = dim[13];
  p.d_tiles_n = dim[14];
  const int d_grid = dim[15];
  p.n_wc = dim[16], p.n_z = dim[17], p.n_wp = dim[18];
  const int w_grid = dim[19];
  p.r_tiles = dim[20], p.act_slots = dim[21];
  const int batch = p.batch, code = p.code, s0 = p.s0, c0 = p.c0, c1 = p.c1;
  const int area = s0 * s0, proj = area * c0;
  p.area = area, p.proj = proj;
  p.per = is_bf16 ? kBM / area : 0;
  p.nkb = cdiv(batch, 64), p.nkc = cdiv(c1, 64), p.z_steps = cdiv(proj, 64);
  p.d_items = d_tiles_m * p.d_tiles_n;
  p.r_tiles_n = cdiv(proj, kRN);
  p.sums = (need & 24) != 0;
  p.dwp_bf16 = (out_bf16 >> 1) & 1, p.dwc_bf16 = (out_bf16 >> 5) & 1;
  p.z = reinterpret_cast<const void*>(ptr[0]);
  p.wp = reinterpret_cast<const void*>(ptr[1]);
  p.bp = reinterpret_cast<const float*>(ptr[2]);
  p.slope = reinterpret_cast<const float*>(ptr[3]);
  p.trans = reinterpret_cast<const float*>(ptr[4]);
  p.wc = reinterpret_cast<const void*>(ptr[5]);
  p.g = reinterpret_cast<const void*>(ptr[6]);
  p.s = reinterpret_cast<float*>(ptr[7]);
  p.h = (need & 32) ? reinterpret_cast<void*>(ptr[8]) : nullptr;
  p.ds = reinterpret_cast<void*>(ptr[9]);
  p.dz_part = reinterpret_cast<float*>(ptr[10]);
  p.part_act = reinterpret_cast<float*>(ptr[11]);
  p.part_bc = reinterpret_cast<float*>(ptr[12]);
  p.wc_part = reinterpret_cast<float*>(ptr[13]);
  p.dwp = reinterpret_cast<void*>(ptr[15]);
  p.dwc = reinterpret_cast<void*>(ptr[19]);

  // 1. The projection, and dbc's column partials.
  const int col_blocks = (need & 64) ? cdiv(c1, 128) * gchunks : 0;
  if (p.r_tiles + col_blocks > 0)
    GEA_TRY(is_bf16 ? launch_project<bf16>(p, p.r_tiles + col_blocks, st)
                    : launch_project<float>(p, p.r_tiles + col_blocks, st));

  // Tensor maps of the bf16 passes: dims innermost first, byte strides of
  // the outer dims.
  const int e = 2;
  auto make_map = [](CUtensorMap* m, const void* ptr_, int rank, std::initializer_list<D> dims,
                     std::initializer_list<D> strides, std::initializer_list<B> box) {
    return gea::tensor_map_bf16(m, ptr_, rank, dims.begin(), strides.begin(), box.begin());
  };
  // The epilogues' maps: 128-byte boxes (64 bf16 or 32 fp32 columns) of
  // `rows` rows (and one plane).
  auto rows_map = [](CUtensorMap* m, bool bf, const void* ptr_, int rank,
                     std::initializer_list<D> dims, std::initializer_list<D> strides, int rows) {
    const B box[3] = {(B)(bf ? 64 : 32), (B)rows, 1};
    return gea::tensor_map_rows(m, bf, ptr_, rank, dims.begin(), strides.begin(), box);
  };
  if (is_bf16 && gea::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;

  // 2. D with the ds step.
  if (need & 31) {
    if (is_bf16) {
      Maps maps{};
      if (!make_map(&maps.m[0], p.g, 5, {(D)2 * c1, (D)s0, 2, (D)s0, (D)batch},
                    {(D)2 * c1 * e, (D)2 * s0 * c1 * e, (D)4 * s0 * c1 * e, (D)4 * area * c1 * e},
                    {64, (B)s0, 1, (B)s0, (B)p.per}) ||
          !make_map(&maps.m[1], p.wc, 3, {(D)c1, (D)c0, 16}, {(D)c1 * e, (D)c0 * c1 * e},
                    {64, kBN, 1}) ||
          !rows_map(&maps.m[2], false, p.s, 2, {(D)c0, (D)batch * area}, {(D)c0 * 4},
                    p.per * area) ||
          !rows_map(&maps.m[3], true, p.ds, 2, {(D)c0, (D)batch * area}, {(D)c0 * e},
                    p.per * area))
        return (int)cudaErrorInvalidValue;
      GEA_TRY(launch_gemm<kData>(maps, p, d_grid, st));
    } else {
      GEA_TRY(launch_f32<kData>(p, dim3(d_tiles_m, p.d_tiles_n), st));
    }
  }

  // 3. dz, dwp, dWc.
  if (is_bf16) {
    Maps maps{};
    if (p.n_z && (!make_map(&maps.m[0], p.ds, 2, {(D)proj, (D)batch}, {(D)proj * e}, {64, kBM}) ||
                  !make_map(&maps.m[1], p.wp, 2, {(D)proj, (D)code}, {(D)proj * e}, {64, kBN}) ||
                  !rows_map(&maps.m[6], false, p.dz_part, 3, {(D)code, (D)batch, (D)p.splits},
                            {(D)code * 4, (D)batch * code * 4}, kBM)))
      return (int)cudaErrorInvalidValue;
    if (p.n_wp &&
        (!make_map(&maps.m[2], p.z, 3, {(D)code, 1, (D)batch}, {(D)code * e, (D)code * e},
                   {64, 1, 64}) ||
         !make_map(&maps.m[3], p.ds, 3, {(D)proj, 1, (D)batch}, {(D)proj * e, (D)proj * e},
                   {64, 1, 64}) ||
         !rows_map(&maps.m[7], p.dwp_bf16, p.dwp, 2, {(D)proj, (D)code},
                   {(D)proj * (p.dwp_bf16 ? 2 : 4)}, kBM)))
      return (int)cudaErrorInvalidValue;
    if (p.n_wc &&
        (!make_map(&maps.m[4], p.h, 3, {(D)c0, (D)area, (D)batch}, {(D)c0 * e, (D)proj * e},
                   {64, 1, 64}) ||
         !make_map(&maps.m[5], p.g, 3, {(D)c1, (D)4 * area, (D)batch},
                   {(D)c1 * e, (D)4 * area * c1 * e}, {64, 1, 64})))
      return (int)cudaErrorInvalidValue;
    // dWc (16, c0, c1) in its type, or its fp32 partials (chunks * 16, c0, c1).
    const bool wc_final = p.wc_chunks == 1, wc_bf = wc_final && p.dwc_bf16;
    if (p.n_wc && !rows_map(&maps.m[8], wc_bf, wc_final ? p.dwc : p.wc_part, 3,
                            {(D)c1, (D)c0, (D)16 * p.wc_chunks},
                            {(D)c1 * (wc_bf ? 2 : 4), (D)c0 * c1 * (wc_bf ? 2 : 4)}, kBM))
      return (int)cudaErrorInvalidValue;
    if (p.n_wc + p.n_z + p.n_wp > 0) GEA_TRY(launch_gemm<kWeight>(maps, p, w_grid, st));
  } else {
    if (need & 1)
      GEA_TRY(launch_f32<kDz>(p, dim3(cdiv(batch, kFT), cdiv(code, kFT), p.splits), st));
    if (need & 2) {  // dwp = z^T ds
      Args w = p;
      w.w_rows = code, w.w_cols = proj, w.w_taps = 0, w.w_bf16 = p.dwp_bf16, w.w_out = p.dwp;
      w.a_src = p.z, w.a_ld = code, w.a_ps = 0, w.b_src = p.ds, w.b_ld = proj, w.b_ps = 0;
      GEA_TRY(launch_f32<kWeight>(w, dim3(cdiv(code, kFT), cdiv(proj, kFT), 1), st));
    }
    if (need & 32) {  // dWc[tap] = sum over the tap's pixel pairs of h^T g
      Args w = p;
      w.w_rows = c0, w.w_cols = c1, w.w_taps = 16, w.w_bf16 = p.dwc_bf16, w.w_out = p.dwc;
      w.a_src = p.h, w.a_ld = proj, w.a_ps = c0, w.b_src = p.g, w.b_ld = 4 * area * c1,
      w.b_ps = c1;
      GEA_TRY(launch_f32<kWeight>(w, dim3(cdiv(c0, kFT), cdiv(c1, kFT), 16), st));
    }
  }

  // 4. The sums.
  Sums sums{};
  int n = 0;
  if (need & 1)
    sums.s[n++] = {p.dz_part, reinterpret_cast<void*>(ptr[14]), p.splits, batch * code, 0,
                   out_bf16 & 1};
  if (need & 4) sums.s[n++] = {p.ds, reinterpret_cast<void*>(ptr[16]), batch, proj, is_bf16, 0};
  if (need & 8)
    sums.s[n++] = {p.part_act, reinterpret_cast<void*>(ptr[17]), p.act_slots, c0, 0, 0};
  if (need & 16)
    sums.s[n++] = {p.part_act + (size_t)p.act_slots * c0, reinterpret_cast<void*>(ptr[18]),
                   p.act_slots, c0, 0, 0};
  if ((need & 32) && is_bf16 && p.wc_chunks > 1)
    sums.s[n++] = {p.wc_part, p.dwc, p.wc_chunks, 16 * c0 * c1, 0, p.dwc_bf16};
  if (need & 64) sums.s[n++] = {p.part_bc, reinterpret_cast<void*>(ptr[20]), gchunks, c1, 0, 0};
  if (n == 0) return 0;
  // The longest sums first (insertion sort on the terms a column).
  for (int i = 1; i < n; ++i)
    for (int j = i; j > 0 && sums.s[j].r > sums.s[j - 1].r; --j) {
      const Sum tmp = sums.s[j];
      sums.s[j] = sums.s[j - 1];
      sums.s[j - 1] = tmp;
    }
  int blocks = 0;
  for (int i = 0; i < n; ++i) blocks += cdiv(sums.s[i].c, 32);
  seed_bwd_reduce<<<blocks, 256, 0, st>>>(sums);
  return (int)cudaGetLastError();
}

}  // namespace

// ptr: z, wp, bp, slope, trans, wc, g (inputs; z, wp, wc and g in the
// computing type, bp, slope and trans fp32), then the wrapper's scratch s
// (fp32), h, ds, the dz partials, the dslope and dtrans partials, the dbc
// partials and the dWc partials, then the outputs dz, dwp, dbp, dslope,
// dtrans, dWc and dbc (dbp, dslope, dtrans and dbc fp32). dim: batch, code,
// s0, c0, c1, is_bf16, need (bit i for gradient i, in that order), bf16
// outputs (bits 0, 1, 5 for dz, dwp, dWc), then the plan
// (gea_torch/ops/seed.py::BackwardPlan.dims): dz's k-steps a chunk and
// chunks, dWc's chunks a tap, g's rows a column-sum chunk and chunks, D's
// tiles (rows, columns) and blocks, W's items (dWc, dz, dwp) and blocks,
// the projection's tiles, D's partial slots.
extern "C" int gea_seed_backward(const unsigned long long* ptr, const int* dim, void* stream) {
  return backward(ptr, dim, static_cast<cudaStream_t>(stream));
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
