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
// The fp32 instance stays on the CUDA cores (TF32 would lose the fp32
// tolerance): one block of 256 threads per kRowsF32 rows; thread j computes
// hidden column j (then output column c) for the block's rows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

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

constexpr int kRowsF32 = 4;
constexpr int kThreadsF32 = 256;

__global__ void __launch_bounds__(kThreadsF32)
lis_kernel_f32(const float* __restrict__ z, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ slope,
               const float* __restrict__ trans, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int batch, int code,
               int hidden) {
  extern __shared__ float smem[];
  float* zs = smem;                     // [kRowsF32][code]
  float* hs = smem + kRowsF32 * code;   // [kRowsF32][hidden]
  const int row0 = blockIdx.x * kRowsF32;

  for (int i = threadIdx.x; i < kRowsF32 * code; i += blockDim.x) {
    const int r = i / code;
    const int c = i - r * code;
    zs[i] = (row0 + r < batch) ? z[(size_t)(row0 + r) * code + c] : 0.f;
  }
  __syncthreads();

  // Hidden layer: h = tprelu(z @ W1 + b1), kept in shared memory.
  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    float acc[kRowsF32];
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r) acc[r] = 0.f;
    for (int k = 0; k < code; ++k) {
      const float w = w1[(size_t)k * hidden + j];
#pragma unroll
      for (int r = 0; r < kRowsF32; ++r) acc[r] = fmaf(zs[r * code + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r)
      hs[r * hidden + j] = tprelu(__fadd_rn(acc[r], b1[j]), slope[j], trans[j]);
  }
  __syncthreads();

  // Output layer and residual: out = z + (h @ W2 + b2).
  for (int c = threadIdx.x; c < code; c += blockDim.x) {
    float acc[kRowsF32];
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r) acc[r] = 0.f;
    for (int k = 0; k < hidden; ++k) {
      const float w = w2[(size_t)k * code + c];
#pragma unroll
      for (int r = 0; r < kRowsF32; ++r) acc[r] = fmaf(hs[r * hidden + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r)
      if (row0 + r < batch)
        out[(size_t)(row0 + r) * code + c] = __fadd_rn(zs[r * code + c], __fadd_rn(acc[r], b2[c]));
  }
}

int launch_f32(const void* z, const void* w1, const void* b1, const void* slope,
               const void* trans, const void* w2, const void* b2, void* out, int batch,
               int code, int hidden, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRowsF32 * (code + hidden);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lis_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((batch + kRowsF32 - 1) / kRowsF32);
  lis_kernel_f32<<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(slope),
      static_cast<const float*>(trans), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), batch, code, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the kernel needs for a hidden width (bf16 or fp32).
extern "C" long long gea_lis_smem_bytes(int code, int hidden, int is_bf16) {
  if (is_bf16) return 2 * (long long)ClusterLayout(code, hidden).total;
  return (long long)sizeof(float) * kRowsF32 * (code + hidden);
}

extern "C" int gea_lis_forward(const void* z, const void* w1, const void* b1,
                               const void* slope, const void* trans, const void* w2,
                               const void* b2, void* out, int batch, int code, int hidden,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(z, w1, b1, slope, trans, w2, b2, out, batch, code, hidden, s);
  return launch_f32(z, w1, b1, slope, trans, w2, b2, out, batch, code, hidden, s);
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
