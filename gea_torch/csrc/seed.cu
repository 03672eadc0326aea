// The generator's seed segment as one kernel:
//
//     h   = T(tprelu(z @ Wp + bp))            reshaped (s0, s0, c0), channels fastest
//     out = T(conv_transpose2d(h, Wc, stride 2, padding 1) + bc)     NHWC
//
// where T() rounds to z's type (fp32 or bf16) and the products accumulate
// in fp32. Replaces gea/ops/pallas/seed.py::fused_seed (the pl.pallas_call
// in _forward); it does not include up1's activation, which follows it.
//
// The transposed conv is computed by output parity: with hp = pad(h, 1) and
// Wf the spatially flipped kernel,
//
//     out[2i+du, 2j+dv] = sum_{a,b in {0,1}} hp[i+du+a, j+dv+b] @ Wf[du+2a, dv+2b]
//
// so each of the 4 output phases is a sum of 4 dense (c0 -> c1) taps.
//
// Bound on the H100: operations. At the flagship shape (256 codes, code 256,
// s0 5, c0 512, c1 256) one launch is about 28.5 GFLOP, about 29 us on the
// bf16 tensor cores. Design: one block of kThreads threads per kCodes codes.
// The block first computes the projection and TPReLU for its codes into a
// zero-bordered map hp in shared memory, so the seed map never reaches
// device memory. Then each thread owns one (phase, output channel) item at
// a time and keeps the kCodes * s0 * s0 outputs of that item in registers:
// for each tap and each group of 4 input channels it reads 4 weights
// (neighbouring threads on neighbouring output channels, coalesced) and 4
// channels of hp per position (the same address across the warp, a
// broadcast), and does 4 * kCodes * s0 * s0 FMAs. This first version runs on
// the CUDA cores in fp32, far from the tensor-core bound; wgmma and TMA are
// for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodes = 2;
constexpr int kThreads = 512;

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

// Four consecutive channels of hp (16-byte aligned for fp32, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T, int S0>
__global__ void __launch_bounds__(kThreads)
seed_kernel(const T* __restrict__ z, const T* __restrict__ wp,
            const float* __restrict__ bp, const float* __restrict__ slope,
            const float* __restrict__ trans, const T* __restrict__ wf,
            const float* __restrict__ bc, T* __restrict__ out, int batch,
            int code, int c0, int c1) {
  constexpr int P = S0 + 2;  // side of the zero-bordered map
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* zs = reinterpret_cast<float*>(smem_raw);                          // [kCodes][code]
  T* hp = reinterpret_cast<T*>(smem_raw + sizeof(float) * kCodes * code);  // [kCodes][P][P][c0]
  const int n0 = blockIdx.x * kCodes;

  for (int i = threadIdx.x; i < kCodes * code; i += blockDim.x) {
    const int n = i / code;
    zs[i] = (n0 + n < batch) ? to_f(z[(size_t)n0 * code + i]) : 0.f;
  }
  for (int i = threadIdx.x; i < kCodes * P * P * c0; i += blockDim.x) hp[i] = from_f<T>(0.f);
  __syncthreads();

  // Projection + TPReLU into the interior of hp.
  const int proj = S0 * S0 * c0;
  for (int p = threadIdx.x; p < proj; p += blockDim.x) {
    float acc[kCodes];
#pragma unroll
    for (int n = 0; n < kCodes; ++n) acc[n] = 0.f;
    for (int k = 0; k < code; ++k) {
      const float w = to_f(wp[(size_t)k * proj + p]);
#pragma unroll
      for (int n = 0; n < kCodes; ++n) acc[n] = fmaf(zs[n * code + k], w, acc[n]);
    }
    const int c = p % c0;
    const int ij = p / c0;
    const int i = ij / S0, j = ij - (ij / S0) * S0;
    const float bpp = bp[p], a = slope[c], t = trans[c];
#pragma unroll
    for (int n = 0; n < kCodes; ++n) {
      const float s = __fsub_rn(__fadd_rn(acc[n], bpp), t);
      const float h = __fadd_rn(__fadd_rn(fmaxf(s, 0.f), __fmul_rn(a, fminf(s, 0.f))), t);
      hp[((n * P + i + 1) * P + j + 1) * c0 + c] = from_f<T>(h);
    }
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
      const T* wt = wf + (size_t)((du + 2 * a) * 4 + (dv + 2 * b)) * c0 * c1 + co;
      for (int ci = 0; ci < c0; ci += 4) {
        const float w0 = to_f(wt[(size_t)(ci + 0) * c1]);
        const float w1 = to_f(wt[(size_t)(ci + 1) * c1]);
        const float w2 = to_f(wt[(size_t)(ci + 2) * c1]);
        const float w3 = to_f(wt[(size_t)(ci + 3) * c1]);
#pragma unroll
        for (int n = 0; n < kCodes; ++n)
#pragma unroll
          for (int i = 0; i < S0; ++i)
#pragma unroll
            for (int j = 0; j < S0; ++j) {
              const float4 h = load4(&hp[((n * P + i + oi) * P + j + oj) * c0 + ci]);
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
          out[o] = from_f<T>(__fadd_rn(acc[n][i][j], bias));
        }
    }
  }
}

template <typename T, int S0>
int launch(const void* z, const void* wp, const void* bp, const void* slope,
           const void* trans, const void* wf, const void* bc, void* out,
           int batch, int code, int c0, int c1, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kCodes * code + sizeof(T) * kCodes * (S0 + 2) * (S0 + 2) * c0;
  cudaError_t err = cudaFuncSetAttribute(
      seed_kernel<T, S0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((batch + kCodes - 1) / kCodes);
  seed_kernel<T, S0><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(wp),
      static_cast<const float*>(bp), static_cast<const float*>(slope),
      static_cast<const float*>(trans), static_cast<const T*>(wf),
      static_cast<const float*>(bc), static_cast<T*>(out), batch, code, c0, c1);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* z, const void* wp, const void* bp, const void* slope,
             const void* trans, const void* wf, const void* bc, void* out,
             int batch, int code, int s0, int c0, int c1, cudaStream_t stream) {
  switch (s0) {
    case 4: return launch<T, 4>(z, wp, bp, slope, trans, wf, bc, out, batch, code, c0, c1, stream);
    case 5: return launch<T, 5>(z, wp, bp, slope, trans, wf, bc, out, batch, code, c0, c1, stream);
    case 6: return launch<T, 6>(z, wp, bp, slope, trans, wf, bc, out, batch, code, c0, c1, stream);
    case 7: return launch<T, 7>(z, wp, bp, slope, trans, wf, bc, out, batch, code, c0, c1, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gea_seed_forward(const void* z, const void* wp, const void* bp,
                                const void* slope, const void* trans,
                                const void* wf, const void* bc, void* out,
                                int batch, int code, int s0, int c0, int c1,
                                int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(z, wp, bp, slope, trans, wf, bc, out, batch,
                                   code, s0, c0, c1, s);
  return dispatch<float>(z, wp, bp, slope, trans, wf, bc, out, batch, code, s0,
                         c0, c1, s);
}

extern "C" const char* gea_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
