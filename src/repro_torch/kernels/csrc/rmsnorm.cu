// Row RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale,
// computed in fp32 and cast back to the input type.
//
// Replaces the TPU kernel `rmsnorm` of the reference package
// (kernels/rmsnorm.py, body `_rmsnorm_kernel`). The TPU kernel normalises
// a (block_rows, d) tile in VMEM per grid step so each element is read
// from HBM once and written once.
//
// Bound: bytes. Two flops and one load per element against 989 TFLOP/s
// and 3.35 TB/s: the row must stream at HBM rate. What the design does
// about it: one block per row (one warp for a narrow row), the row walked
// in 16-byte vector loads with a scalar tail, a warp-shuffle then
// shared-memory fp32 reduction of the sum of squares, and a second pass
// over the same row that the first pass has just brought into L1, so HBM
// sees each element read once and written once. No scratch in device
// memory, no second launch.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and checks the returned
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float load_scale(const void* scale, int code,
                                            int i) {
  if (code == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[i]);
  if (code == kF16) return __half2float(static_cast<const __half*>(scale)[i]);
  return static_cast<const float*>(scale)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const void* __restrict__ scale, int scale_code,
                               T* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  const bool aligned = (reinterpret_cast<uintptr_t>(xr) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(orow) % 16 == 0);
  const int nvec = aligned ? d / VEC : 0;
  const int tail = nvec * VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x) {
    const float f = to_f(xr[i]);
    ss = fmaf(f, f, ss);
  }

  __shared__ float part[32];
  ss = warp_sum(ss);
  if (blockDim.x > 32) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      ss = lane < static_cast<int>(blockDim.x / 32) ? part[lane] : 0.f;
      ss = warp_sum(ss);
      if (lane == 0) part[0] = ss;
    }
    __syncthreads();
    ss = part[0];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      r[j] = from_f<T>(to_f(e[j]) * inv *
                       load_scale(scale, scale_code, i * VEC + j));
    reinterpret_cast<uint4*>(orow)[i] = res;
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_f<T>(to_f(xr[i]) * inv * load_scale(scale, scale_code, i));
}

}  // namespace

// Launches the norm of `n` contiguous rows of width `d` on `stream`;
// `x_code` is the dtype of x and out (kF32 or kBF16), `scale_code` that of
// the (d,) scale vector (kF32, kBF16 or kF16). Returns the launch's
// cudaError_t (0 on success). Does not synchronise and allocates nothing.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int n, int d, float eps, int x_code,
                              int scale_code, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (scale_code != kF32 && scale_code != kBF16 && scale_code != kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = x_code == kF32 ? 4 : 8;
  int threads = ((d + vec - 1) / vec + 31) / 32 * 32;  // one vector each
  if (threads > 256) threads = 256;
  if (x_code == kF32) {
    rmsnorm_kernel<float><<<n, threads, 0, s>>>(
        static_cast<const float*>(x), scale, scale_code,
        static_cast<float*>(out), d, eps);
  } else if (x_code == kBF16) {
    rmsnorm_kernel<__nv_bfloat16><<<n, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale, scale_code,
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
