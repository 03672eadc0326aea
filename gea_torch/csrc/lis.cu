// One LIS link of the G-LIS generator as one kernel:
//
//     out = z + T(W2 @ T(tprelu(W1 @ z + b1)) + b2)
//
// where T() rounds to z's type (fp32 or bf16) and tprelu(h) is
// max(s, 0) + a * min(s, 0) + t with s = h - t, all in fp32.
//
// Replaces gea/ops/pallas/lis.py::lis_residual_mlp (its pl.pallas_call);
// the rounding points are those of that kernel's body.
//
// Bound on the H100: launch latency. At the flagship shape (B = 64,
// C = H = 256) one link moves about 0.33 MB and does about 17 MFLOP, well
// under a microsecond at peak either way, so the kernel's job is to be one
// short launch that keeps the hidden row out of device memory and spreads
// the work over many SMs without each of them reading both weights whole.
//
// bf16 design (tensor cores, mma.sync.m16n8k16 with fp32 accumulation;
// mma.cuh): a thread block cluster of kCluster = 8 blocks of 4 warps shares
// a tile of kRows = 16 rows (the flagship runs 4 clusters, 32 blocks).
// Block `rank` copies the tile's z rows, its slice of W1 (H / 8 hidden
// columns), its slice of W2 (C / 8 output columns) and the matching bias,
// slope and trans values into shared memory in one cp.async group, computes
// its hidden slice (TPReLU in fp32, rounded to bf16), and after a cluster
// barrier copies the full hidden rows from the 8 blocks' shared memory
// (distributed shared memory). It then computes its output columns, adds
// b2, rounds, adds the residual from its copy of z and rounds again. A
// block only waits for the others (second cluster barrier) just before it
// exits, so its last product overlaps their copies. Each block reads an
// eighth of each weight, so no SM streams W1 whole. Each warp's products run
// as two independent accumulator chains.
//
// fp32 design (the same cluster structure on the FFMA pipe; TF32 would
// lose the fp32 tolerance): a cluster of `cluster` (16 or 8) blocks of
// kF32Threads threads shares a tile of `rows` (8 or 16) rows, all three from
// the host plan (gea_torch/ops/lis.py::forward_plan). One thread of block
// `rank` has TMA copy its slices of W1 (hidden columns [rank wh, +wh)) and
// W2 (output columns [rank wo, +wo)) in chunks of kChunk k-rows into a ring
// of `depth` slots, each chunk of W1 with the same columns of the tile's z
// rows, and the vector slices by bulk copies, each slot completing on its
// own mbarrier; where the ring holds every chunk (the flagship) all copies
// are in flight from the start, and the first product starts when its
// first chunk lands. Each thread owns a register tile of outputs (1 x 1 up
// to 2 x 4, by the layer's rows x columns) and walks k in order, one fmaf
// chain an output from 0, exactly as a single accumulator would: the
// outputs do not depend on the plan, the batch or the tile. Hidden slice
// and TPReLU, then the slice stored into every block's full hidden rows
// (distributed shared memory) and one cluster barrier, then the output
// columns, + b2, + the residual from the block's copy of z. What bounds it
// at the flagship (NVIDIA H100 80GB HBM3, scripts/torch_lis_forward_variants.py):
// of about 13.5 us a link, the launch takes about 5, the products 3.5 (the
// latency of their shared-memory loads, which one k-ordered chain an output
// leaves exposed), the exchange and its cluster barrier 1.4.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using gea::bf16;

__device__ __forceinline__ float tprelu(float h, float a, float t) {
  const float s = __fsub_rn(h, t);
  return __fadd_rn(__fadd_rn(fmaxf(s, 0.f), __fmul_rn(a, fminf(s, 0.f))), t);
}

// ------------------------------------------------------------ bf16, tensor cores

constexpr int kRows = 16;  // rows of z a cluster shares

// Block `rank` of a cluster computes hidden columns [rank * wh, +wh) and
// output columns [rank * wo, +wo), where wh, wo are H / kCluster and
// C / kCluster rounded up to 8.
constexpr int kCluster = 8;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct ClusterLayout {  // element offsets (bf16) into shared memory
  int kz, wh, wo, ld_z, ld_h1, ld_o, ld_hf, w1s, w2s, hl, hf, vec, total;
  __host__ __device__ ClusterLayout(int code, int hidden) {
    kz = round_up(code, 16);
    wh = round_up((hidden + kCluster - 1) / kCluster, 8);
    wo = round_up((code + kCluster - 1) / kCluster, 8);
    ld_z = kz + 8;
    ld_h1 = wh + 8;
    ld_o = wo + 8;
    ld_hf = hidden + 8;
    w1s = kRows * ld_z;
    w2s = w1s + kz * ld_h1;
    hl = w2s + hidden * ld_o;
    hf = hl + kRows * ld_h1;
    vec = hf + kRows * ld_hf;  // fp32: b1, slope, trans of the hidden slice; b2 of the output slice
    total = vec + 2 * (3 * wh + wo);
  }
};

// acc = A (16 x k, rows a_lane) . B (k x 8, rows b_lane) over k in steps
// of 16, two independent accumulator chains.
__device__ __forceinline__ void warp_product(float (&acc)[4], const bf16* a_lane,
                                             const bf16* b_lane, int ldb, int k_end) {
  float odd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.f;
  for (int k = 0; k < k_end; k += 32) {
    uint32_t af[4], bfr[2];
    gea::ldmatrix_x4(af, a_lane + k);
    gea::ldmatrix_x2_trans(bfr, b_lane + k * ldb);
    gea::mma_bf16(acc, af, bfr[0], bfr[1]);
    if (k + 16 < k_end) {
      gea::ldmatrix_x4(af, a_lane + k + 16);
      gea::ldmatrix_x2_trans(bfr, b_lane + (k + 16) * ldb);
      gea::mma_bf16(odd, af, bfr[0], bfr[1]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], odd[e]);
}

__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(128)
lis_kernel_bf16(const bf16* __restrict__ z, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ slope,
                const float* __restrict__ trans, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out, int batch, int code,
                int hidden) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterLayout L(code, hidden);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16 *zs = smem, *w1s = smem + L.w1s, *w2s = smem + L.w2s, *hl = smem + L.hl, *hf = smem + L.hf;
  float* b1s = reinterpret_cast<float*>(smem + L.vec);
  float *as = b1s + L.wh, *ts = as + L.wh, *b2s = ts + L.wh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = (int)cluster.block_rank();
  const int r0 = blockIdx.x * kRows, h0 = rank * L.wh, o0 = rank * L.wo;

  // z rows, W1[:, h0:h0+wh], W2[:, o0:o0+wo] and the vector slices, as one
  // copy group; masked parts are zero-filled.
  for (int q = tid; q < kRows * (L.kz / 8); q += 128) {
    const int r = q / (L.kz / 8), k = (q % (L.kz / 8)) * 8;
    const bool ok = r0 + r < batch && k < code;
    gea::cp_async16(zs + r * L.ld_z + k, ok ? z + (size_t)(r0 + r) * code + k : z, ok ? 16 : 0);
  }
  for (int q = tid; q < L.kz * (L.wh / 8); q += 128) {
    const int k = q / (L.wh / 8), c = (q % (L.wh / 8)) * 8;
    const bool ok = k < code && h0 + c < hidden;
    gea::cp_async16(w1s + k * L.ld_h1 + c, ok ? w1 + (size_t)k * hidden + h0 + c : w1, ok ? 16 : 0);
  }
  for (int q = tid; q < hidden * (L.wo / 8); q += 128) {
    const int k = q / (L.wo / 8), c = (q % (L.wo / 8)) * 8;
    const bool ok = o0 + c < code;
    gea::cp_async16(w2s + k * L.ld_o + c, ok ? w2 + (size_t)k * code + o0 + c : w2, ok ? 16 : 0);
  }
  for (int q = tid; q < L.wh / 4; q += 128) {
    const int j = h0 + 4 * q;
    const bool ok = j < hidden;
    gea::cp_async16(b1s + 4 * q, ok ? b1 + j : b1, ok ? 16 : 0);
    gea::cp_async16(as + 4 * q, ok ? slope + j : slope, ok ? 16 : 0);
    gea::cp_async16(ts + 4 * q, ok ? trans + j : trans, ok ? 16 : 0);
  }
  for (int q = tid; q < L.wo / 4; q += 128) {
    const bool ok = o0 + 4 * q < code;
    gea::cp_async16(b2s + 4 * q, ok ? b2 + o0 + 4 * q : b2, ok ? 16 : 0);
  }
  gea::cp_async_commit();
  gea::cp_async_wait<0>();
  __syncthreads();

  const int g = lane / 4, t = lane % 4;
  // Hidden slice: warp w takes the n8 tiles w, w + 4, ... of its wh columns.
  const bf16* a_lane = zs + (lane & 15) * L.ld_z + (lane >> 4) * 8;
  for (int nt = warp; nt < L.wh / 8; nt += 4) {
    float acc[4];
    warp_product(acc, a_lane, w1s + (lane & 15) * L.ld_h1 + nt * 8, L.ld_h1, L.kz);
    const int c = nt * 8 + 2 * t;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (h0 + c < hidden) {
      v[0] = tprelu(__fadd_rn(acc[0], b1s[c]), as[c], ts[c]);
      v[1] = tprelu(__fadd_rn(acc[1], b1s[c + 1]), as[c + 1], ts[c + 1]);
      v[2] = tprelu(__fadd_rn(acc[2], b1s[c]), as[c], ts[c]);
      v[3] = tprelu(__fadd_rn(acc[3], b1s[c + 1]), as[c + 1], ts[c + 1]);
    }
    *reinterpret_cast<__nv_bfloat162*>(hl + g * L.ld_h1 + c) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(hl + (g + 8) * L.ld_h1 + c) = __floats2bfloat162_rn(v[2], v[3]);
  }
  cluster.sync();  // every block's hidden slice is written

  // Full hidden rows from the cluster's blocks.
  for (int q = tid; q < kRows * (hidden / 8); q += 128) {
    const int r = q / (hidden / 8), j = (q % (hidden / 8)) * 8;
    const int owner = j / L.wh;
    const bf16* remote = cluster.map_shared_rank(hl, owner);
    *reinterpret_cast<uint4*>(hf + r * L.ld_hf + j) =
        *reinterpret_cast<const uint4*>(remote + r * L.ld_h1 + (j - owner * L.wh));
  }
  __syncthreads();
  // The copies are done: arrive now, wait before exiting, so that no block
  // leaves while another still reads its slice.
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");

  // Output slice: warp w takes the n8 tiles w, w + 4, ... of its wo columns.
  a_lane = hf + (lane & 15) * L.ld_hf + (lane >> 4) * 8;
  for (int nt = warp; nt < L.wo / 8; nt += 4) {
    float acc[4];
    warp_product(acc, a_lane, w2s + (lane & 15) * L.ld_o + nt * 8, L.ld_o, hidden);
    const int c = nt * 8 + 2 * t, col = o0 + c;
    if (col >= code) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r0 + r >= batch) continue;
      const float2 zr =  // the residual, from the block's copy of z
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(zs + r * L.ld_z + col));
      const float y0 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc[2 * h], b2s[c])));
      const float y1 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc[2 * h + 1], b2s[c + 1])));
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r0 + r) * code + col) =
          __floats2bfloat162_rn(__fadd_rn(zr.x, y0), __fadd_rn(zr.y, y1));
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

int launch_bf16(const void* z, const void* w1, const void* b1, const void* slope,
                const void* trans, const void* w2, const void* b2, void* out, int batch,
                int code, int hidden, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)ClusterLayout(code, hidden).total;
  cudaError_t err = cudaFuncSetAttribute(
      lis_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + kRows - 1) / kRows, kCluster);
  lis_kernel_bf16<<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(slope),
      static_cast<const float*>(trans), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), batch, code, hidden);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ fp32, CUDA cores

constexpr int kF32Threads = 256;  // threads of the products; one more warp copies
constexpr int kChunk = 64;     // k-rows of a weight slice a ring slot holds
constexpr int kMaxSlots = 32;  // ring slots (one mbarrier each)
constexpr int kMaxTile = 8;    // outputs a thread holds (2 x 4)
constexpr int kSmemLimit = 232448;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared memory of a block, in floats after the ring's mbarriers (at a
// 128-byte aligned base): z's rows in chunks of kChunk columns ([chunk][row]
// [kChunk], as TMA lands each chunk's box), the ring's slots (kChunk k-rows
// of the wider slice each), the full hidden rows (padded by 4 floats), the
// block's hidden slice and the vector slices.
struct F32Layout {
  int wh, wo, ws, ld_h, n1, chunks, zs, ring, hf, hl, vec, bytes;
  __host__ __device__ F32Layout(int code, int hidden, int rows, int cluster, int depth) {
    wh = round_up(cdiv(hidden, cluster), 4);
    wo = round_up(cdiv(code, cluster), 4);
    ws = wh > wo ? wh : wo;
    ld_h = hidden + 4;  // rows 4 banks apart: a warp's float4 reads of several rows
    n1 = cdiv(code, kChunk);
    chunks = n1 + cdiv(hidden, kChunk);
    zs = 0;
    ring = zs + n1 * rows * kChunk;
    hf = ring + depth * kChunk * ws;
    hl = hf + rows * ld_h;
    vec = hl + rows * wh;  // b1, slope, trans of the hidden slice; b2 of the output slice
    bytes = 128 + 8 * kMaxSlots + 4 * (vec + 3 * wh + wo);
  }
};

// The outputs a thread holds for a layer of rows x w: the first tile of
// 1 x 1, 1 x 2, 2 x 2, 2 x 4 whose tiles the block's threads cover.
__host__ __device__ inline int tile_size(int rows, int w) {
  int t = 1;
  while (t < kMaxTile && rows * w > t * kF32Threads) t *= 2;
  return t;
}

struct F32Args {
  CUtensorMap zmap, w1map, w2map;  // boxes: z kChunk x rows, W1 wh x kChunk, W2 wo x kChunk
  const float *b1, *slope, *trans, *b2;
  float* out;
  int batch, code, hidden, rows, depth;
};

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

// One thread: chunk c of the block's weight slices (W1's k-rows first,
// then W2's) into ring slot c % depth by TMA, with the same k-columns of
// z's rows for W1's chunks and the vector slices with W1's last (the first
// product needs none of them), all completing on the slot's barrier. Reads
// outside the tensors land as zeros.
__device__ void issue_chunk(const F32Args& a, const F32Layout& L, float* smem, uint64_t* bars,
                            int c, int r0, int h0, int o0) {
  uint64_t* bar = bars + c % a.depth;
  float* slot = smem + L.ring + (c % a.depth) * kChunk * L.ws;
  if (c >= L.n1) {
    gea::mbar_expect_tx(bar, 4 * kChunk * L.wo);
    gea::tma_load_2d(slot, &a.w2map, o0, (c - L.n1) * kChunk, bar);
    return;
  }
  const bool last = c == L.n1 - 1;
  const int nh = max(0, min(L.wh, a.hidden - h0)), no = max(0, min(L.wo, a.code - o0));
  gea::mbar_expect_tx(bar, 4 * kChunk * (a.rows + L.wh) + (last ? 4 * (3 * nh + no) : 0));
  gea::tma_load_2d(smem + L.zs + c * a.rows * kChunk, &a.zmap, c * kChunk, r0, bar);
  gea::tma_load_2d(slot, &a.w1map, h0, c * kChunk, bar);
  if (!last) return;
  float* v = smem + L.vec;
  if (nh) {
    bulk_load(v, a.b1 + h0, 4 * nh, bar);
    bulk_load(v + L.wh, a.slope + h0, 4 * nh, bar);
    bulk_load(v + 2 * L.wh, a.trans + h0, 4 * nh, bar);
  }
  if (no) bulk_load(v + 3 * L.wh, a.b2 + o0, 4 * no, bar);
}

template <int N>
__device__ __forceinline__ void lds(float (&b)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x, b[1] = v.y;
  } else {
    b[0] = *p;
  }
}

// One layer: out[r][j] = sum_k A[r][k] B[k][j] over k = 0 .. K - 1 in
// order, for rows x w outputs, B the layer's chunks (k-rows of w floats)
// from ring chunk c0 on; A's chunk i at A + i * a_chunk, rows lda apart. A
// thread holds RT x CT outputs (rows rt0.., columns j0..), each one fmaf
// chain from 0, and hands each sum to epi(r, j, sum). In a ring shallower
// than the chunks, every chunk ends with a barrier of the product's threads
// and the copy of the chunk `depth` on into the slot just read.
template <int RT, int CT, class Epi>
__device__ __forceinline__ void layer(const F32Args& a, const F32Layout& L, float* smem,
                                      uint64_t* bars, const float* A, int a_chunk, int lda, int K,
                                      int w, int c0, int r0, int h0, int o0, Epi epi) {
  const int tid = threadIdx.x, across = w / CT;
  const bool active = tid < (a.rows / RT) * across;
  const int j0 = (tid % across) * CT, rt0 = (tid / across) * RT;
  const bool ring = a.depth < L.chunks;
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
  constexpr int kUnroll = RT * CT == 1 ? 16 : RT * CT == 2 ? 8 : 4;  // k-steps of 4 loaded ahead
  const int n = cdiv(K, kChunk);
  for (int i = 0; i < n; ++i) {
    const int c = c0 + i;
    gea::mbar_wait(bars + c % a.depth, (c / a.depth) & 1);
    if (active) {
      const float* B = smem + L.ring + (c % a.depth) * kChunk * L.ws + j0;
      const float* Ar = A + i * a_chunk + rt0 * lda;
      const int kc = min(kChunk, K - i * kChunk);
#pragma unroll kUnroll
      for (int k = 0; k < kc; k += 4) {
        float x[RT][4];
#pragma unroll
        for (int r = 0; r < RT; ++r) lds(x[r], Ar + r * lda + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float b[CT];
          lds(b, B + (k + kk) * w);
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int j = 0; j < CT; ++j) acc[r][j] = fmaf(x[r][kk], b[j], acc[r][j]);
        }
      }
    }
    if (ring) {
      gea::named_barrier(1, kF32Threads);  // every product thread is done with the slot
      if (tid == 0 && c + a.depth < L.chunks)
        issue_chunk(a, L, smem, bars, c + a.depth, r0, h0, o0);
    }
  }
  if (active)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < CT; ++j) epi(rt0 + r, j0 + j, acc[r][j]);
}

template <class Epi>
__device__ __forceinline__ void any_layer(const F32Args& a, const F32Layout& L, float* smem,
                                          uint64_t* bars, const float* A, int a_chunk, int lda,
                                          int K, int w, int c0, int r0, int h0, int o0, Epi epi) {
  switch (tile_size(a.rows, w)) {
    case 1: return layer<1, 1>(a, L, smem, bars, A, a_chunk, lda, K, w, c0, r0, h0, o0, epi);
    case 2: return layer<1, 2>(a, L, smem, bars, A, a_chunk, lda, K, w, c0, r0, h0, o0, epi);
    case 4: return layer<2, 2>(a, L, smem, bars, A, a_chunk, lda, K, w, c0, r0, h0, o0, epi);
    default: return layer<2, 4>(a, L, smem, bars, A, a_chunk, lda, K, w, c0, r0, h0, o0, epi);
  }
}

__global__ void __launch_bounds__(kF32Threads + 32, 1)
lis_kernel_f32_cluster(const __grid_constant__ F32Args a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const F32Layout L(a.code, a.hidden, a.rows, cl, a.depth);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA's boxes land at 128-byte aligned addresses. The base is offset from
  // smem_raw, not cast from an integer, so that the compiler still knows
  // every pointer below as shared memory (ld.shared, not generic loads).
  unsigned char* base = smem_raw + ((128 - (gea::smem_u32(smem_raw) & 127)) & 127);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  float* smem = reinterpret_cast<float*>(base + 8 * kMaxSlots);
  const int tid = threadIdx.x;
  const bool copier = tid == kF32Threads;  // lane 0 of the last warp
  const int r0 = (blockIdx.x / cl) * a.rows, h0 = rank * L.wh, o0 = rank * L.wo;
  if (copier) {
    const CUtensorMap* maps[3] = {&a.zmap, &a.w1map, &a.w2map};
    for (const CUtensorMap* m : maps)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
    for (int s = 0; s < a.depth; ++s) gea::mbar_init(bars + s, 1);
    gea::mbar_init_fence();
  }
  __syncthreads();
  // The copier issues the first chunks while the product's threads wait for
  // the first to land.
  if (copier)
    for (int c = 0; c < min(a.depth, L.chunks); ++c) issue_chunk(a, L, smem, bars, c, r0, h0, o0);
  // This block has started: its shared memory may be written by the others
  // once every block has arrived (the wait comes before the first push).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Hidden slice: T(tprelu(z W1[:, h0:h0+wh] + b1)), into hl.
  const float* zs = smem + L.zs;
  float *hf = smem + L.hf, *hl = smem + L.hl;
  const float *b1s = smem + L.vec, *as = b1s + L.wh, *ts = as + L.wh, *b2s = ts + L.wh;
  if (tid < kF32Threads)
    any_layer(a, L, smem, bars, zs, a.rows * kChunk, kChunk, a.code, L.wh, 0, r0, h0, o0,
              [&](int r, int j, float acc) {
                hl[r * L.wh + j] = tprelu(__fadd_rn(acc, b1s[j]), as[j], ts[j]);
              });
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every block has started
  // The slice into every block's full hidden rows (distributed shared
  // memory), then a cluster barrier: every block's rows are whole.
  const int per = L.wh / 4, pieces = a.rows * per;
  for (int q = tid; q < cl * pieces; q += blockDim.x) {
    const int dst = q / pieces, r = q % pieces / per, j = 4 * (q % per);
    if (h0 + j < a.hidden)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(hf, dst) + r * L.ld_h + h0 + j) =
          *reinterpret_cast<const float4*>(hl + r * L.wh + j);
  }
  cluster.sync();
  if (tid >= kF32Threads) return;  // the copier's warp: W2's chunks are in flight or in the ring

  // Output slice: z + (h W2[:, o0:o0+wo] + b2).
  any_layer(a, L, smem, bars, hf, kChunk, L.ld_h, a.hidden, L.wo, L.n1, r0, h0, o0,
            [&](int r, int j, float acc) {
              const int col = o0 + j;
              if (col < a.code && r0 + r < a.batch)
                a.out[(size_t)(r0 + r) * a.code + col] = __fadd_rn(
                    zs[col / kChunk * a.rows * kChunk + r * kChunk + col % kChunk],
                    __fadd_rn(acc, b2s[j]));
            });
}

// An fp32 row-major tensor (rows x cols) in boxes of box_cols x box_rows,
// dense in shared memory; reads outside it land as zeros.
bool f32_map(CUtensorMap* m, const void* p, int rows, int cols, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, one[2] = {1, 1};
  gea::EncodeTiled fn = gea::encode_tiled();
  return fn != nullptr &&
         fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// plan: rows, cluster, ring depth, blocks, shared bytes (forward_plan's
// dims); any other grid or shared size than this kernel's is refused.
int launch_f32(const void* z, const void* w1, const void* b1, const void* slope,
               const void* trans, const void* w2, const void* b2, void* out, int batch,
               int code, int hidden, const int* plan, cudaStream_t stream) {
  if (plan == nullptr || code % 4 || hidden % 4) return (int)cudaErrorInvalidValue;
  const int rows = plan[0], cluster = plan[1], depth = plan[2], blocks = plan[3], smem = plan[4];
  const F32Layout L(code, hidden, rows, cluster, depth);
  if ((rows != 8 && rows != 16) || (cluster != 8 && cluster != 16) || depth < 1 ||
      depth > kMaxSlots || blocks != cdiv(batch, rows) * cluster || smem != L.bytes ||
      smem > kSmemLimit || rows * L.ws > kMaxTile * kF32Threads)
    return (int)cudaErrorInvalidValue;
  F32Args a{};
  if (!f32_map(&a.zmap, z, batch, code, kChunk, rows) ||
      !f32_map(&a.w1map, w1, code, hidden, L.wh, kChunk) ||
      !f32_map(&a.w2map, w2, hidden, code, L.wo, kChunk))
    return (int)cudaErrorInvalidValue;
  a.b1 = static_cast<const float*>(b1);
  a.slope = static_cast<const float*>(slope);
  a.trans = static_cast<const float*>(trans);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<float*>(out);
  a.batch = batch, a.code = code, a.hidden = hidden, a.rows = rows, a.depth = depth;
  cudaError_t err = cudaFuncSetAttribute(lis_kernel_f32_cluster,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // a cluster of 16 is above the portable 8
    err = cudaFuncSetAttribute(lis_kernel_f32_cluster,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kF32Threads + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lis_kernel_f32_cluster, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of a block of the kernel for these widths: bf16, the
// cluster layout (rows, cluster and depth unread); fp32, the plan's rows,
// cluster and ring depth.
extern "C" long long gea_lis_smem_bytes(int code, int hidden, int is_bf16, int rows, int cluster,
                                        int depth) {
  if (is_bf16) return 2 * (long long)ClusterLayout(code, hidden).total;
  return F32Layout(code, hidden, rows, cluster, depth).bytes;
}

// plan: forward_plan's dims (rows, cluster, ring depth, blocks, shared
// bytes); a bf16 plan must name the bf16 kernel's own tile, cluster and
// shared bytes.
extern "C" int gea_lis_forward(const void* z, const void* w1, const void* b1,
                               const void* slope, const void* trans, const void* w2,
                               const void* b2, void* out, int batch, int code, int hidden,
                               int is_bf16, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (plan == nullptr || plan[0] != kRows || plan[1] != kCluster ||
        plan[3] != cdiv(batch, kRows) * kCluster ||
        plan[4] != 2 * ClusterLayout(code, hidden).total)
      return (int)cudaErrorInvalidValue;
    return launch_bf16(z, w1, b1, slope, trans, w2, b2, out, batch, code, hidden, s);
  }
  return launch_f32(z, w1, b1, slope, trans, w2, b2, out, batch, code, hidden, plan, s);
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
