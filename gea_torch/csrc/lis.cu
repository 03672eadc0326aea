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
// C = H = 256) one link moves about 0.33 MB and does about 17 MFLOP, a few
// microseconds at peak either way, so the kernel's job is to be one launch
// that keeps the hidden row out of device memory. Design: one block of 256
// threads per tile of kRows rows of z. The tile of z and the hidden rows
// live in shared memory (fp32); thread j computes hidden column j (then
// output column c) for all kRows rows, reading the weights straight from
// global memory with neighbouring threads on neighbouring columns, so each
// weight element is read once per block, coalesced, and reused kRows times
// in registers. No two threads share a weight element, so staging weights
// through shared memory would add a copy and no reuse. Accumulation is fp32
// on CUDA cores; wgmma is for a later, faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lis_kernel(const T* __restrict__ z, const T* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ slope,
           const float* __restrict__ trans, const T* __restrict__ w2,
           const float* __restrict__ b2, T* __restrict__ out, int batch,
           int code, int hidden) {
  extern __shared__ float smem[];
  float* zs = smem;                  // [kRows][code]
  float* hs = smem + kRows * code;   // [kRows][hidden]
  const int row0 = blockIdx.x * kRows;

  for (int i = threadIdx.x; i < kRows * code; i += blockDim.x) {
    const int r = i / code;
    const int c = i - r * code;
    zs[i] = (row0 + r < batch) ? to_f(z[(size_t)(row0 + r) * code + c]) : 0.f;
  }
  __syncthreads();

  // Hidden layer: h = T(tprelu(z @ W1 + b1)), kept in shared memory.
  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < code; ++k) {
      const float w = to_f(w1[(size_t)k * hidden + j]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(zs[r * code + k], w, acc[r]);
    }
    const float bj = b1[j], aj = slope[j], tj = trans[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = __fsub_rn(__fadd_rn(acc[r], bj), tj);
      const float h = __fadd_rn(
          __fadd_rn(fmaxf(s, 0.f), __fmul_rn(aj, fminf(s, 0.f))), tj);
      hs[r * hidden + j] = to_f(from_f<T>(h));
    }
  }
  __syncthreads();

  // Output layer and residual: out = z + T(h @ W2 + b2).
  for (int c = threadIdx.x; c < code; c += blockDim.x) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < hidden; ++k) {
      const float w = to_f(w2[(size_t)k * code + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hs[r * hidden + k], w, acc[r]);
    }
    const float bc = b2[c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r < batch) {
        const float o = to_f(from_f<T>(__fadd_rn(acc[r], bc)));
        out[(size_t)(row0 + r) * code + c] = from_f<T>(__fadd_rn(zs[r * code + c], o));
      }
    }
  }
}

template <typename T>
int launch(const void* z, const void* w1, const void* b1, const void* slope,
           const void* trans, const void* w2, const void* b2, void* out,
           int batch, int code, int hidden, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (code + hidden);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lis_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((batch + kRows - 1) / kRows);
  lis_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(slope),
      static_cast<const float*>(trans), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out), batch, code, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gea_lis_forward(const void* z, const void* w1, const void* b1,
                               const void* slope, const void* trans,
                               const void* w2, const void* b2, void* out,
                               int batch, int code, int hidden, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(z, w1, b1, slope, trans, w2, b2, out, batch,
                                 code, hidden, s);
  return launch<float>(z, w1, b1, slope, trans, w2, b2, out, batch, code,
                       hidden, s);
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
