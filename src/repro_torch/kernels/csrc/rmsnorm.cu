// Row RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * scale,
// computed in fp32 and cast back to the input type.
//
// Replaces the TPU kernel `rmsnorm` of the reference package
// (kernels/rmsnorm.py, body `_rmsnorm_kernel`). The TPU kernel normalises
// a (block_rows, d) tile in VMEM per grid step so each element is read
// from HBM once and written once.
//
// Bound: bytes. Four flops per element against 4 (fp32) or 2 (bf16) bytes
// read and as many written, far below the card's ~295 flops a byte: the
// rows must stream through at HBM rate with nothing else on the critical
// path. Two variants, chosen on the host (`kernels/rmsnorm.py::plan`):
//
// * `rmsnorm_rows<T, VPT>`, the register variant. A row group of `tpr`
//   threads (a power of two up to the block's 256: part of a warp, one
//   warp, or up to eight warps) owns a row, and every thread of it issues
//   its VPT 16-byte loads of the row back to back before any arithmetic;
//   the launcher picks tpr and VPT with vpt * tpr * (16 / sizeof(T)) == d,
//   so every lane does the same work and there is no remainder round. The
//   row stays in those registers, packed: the sum of squares and the
//   scaled output both read them, so no instruction reads x twice (an
//   empty asm between the two keeps the compiler from holding the row
//   widened to fp32, which doubled its registers). Where VPT <= 10 the
//   next row's loads are issued before this row's stores, so a warp keeps
//   loads in flight while it stores (two rows of registers; above 10 the
//   second row would cost occupancy and measured no gain). The sum is
//   reduced with __shfl_xor_sync inside a warp; a row of g > 1 warps adds
//   one shared-memory exchange under a named barrier of its g warps
//   (`bar.sync 1 + group, 32 g`, double-buffered by the row's parity, so
//   one barrier a row), never a block barrier. The grid is persistent (the
//   SMs times the blocks that fit on one), and each row group walks the
//   rows with a grid stride; the first row's loads are in flight while the
//   block stages its scale. __launch_bounds__(256, 2) keeps every
//   instantiation at <= 128 registers, so at least 16 warps an SM.
//   The scale is staged once per block in shared memory as fp32 and read
//   with 16-byte ld.shared: at d = 2560 in bf16 (VPT 10, one warp a row)
//   the row takes 40 registers, and keeping the scale's 10 vectors in
//   registers too would double that; in shared memory it costs d * 4 bytes
//   a block and no registers. The floats are laid out in planes of four
//   columns (plane p holds columns 4p..4p+3 of every 16-byte vector of x),
//   so the lanes of a warp read consecutive 16-byte words: no bank
//   conflicts.
//   x is loaded with ld.global.nc.L1::no_allocate and out stored with
//   st.global.cs: each byte is touched once and should evict nothing.
//   bf16 converts in pairs (__bfloat1622float2, __floats2bfloat162_rn),
//   fp32 moves as float4.
// * `rmsnorm_general<T, S>`, for rows outside that plan (d not a multiple
//   of the 16-byte vector, d too wide for 256 threads x 16 vectors, x or
//   out not 16-byte aligned): one block per row, 16-byte vector loads
//   where the row is aligned and a scalar tail, a warp-shuffle then
//   shared-memory reduction and a second pass over the row from L1. The
//   scale's dtype is a template parameter, so its loads carry no branch.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, the plan, the device and its current stream, and checks
// the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
// variant codes shared with the Python wrapper
constexpr int kRows = 0, kGeneral = 1;
// threads of a block of the register variant; the widest row group
constexpr int kBlock = 256;
// the most 16-byte vectors a thread of the register variant holds
constexpr int kVptMax = 16;
// up to this many vectors a thread, the next row is loaded before the
// current row is stored
constexpr int kPrefetchVptMax = 10;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

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

// 16 bytes read once: through the non-coherent path, not kept in L1
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes written once, evict-first
__device__ __forceinline__ void st_stream(uint4* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = w;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t f2_to_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One 16-byte vector of a row: its sum of squares, and its scaled copy.
// `s` is the scale staged in float4 planes of `nvec` vectors each.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ static float sumsq(const uint4& v, float ss) {
    const float a = __uint_as_float(v.x), b = __uint_as_float(v.y);
    const float c = __uint_as_float(v.z), d = __uint_as_float(v.w);
    return fmaf(d, d, fmaf(c, c, fmaf(b, b, fmaf(a, a, ss))));
  }
  __device__ static uint4 scaled(const uint4& v, float inv, const float4* s,
                                 int nvec, int i) {
    const float4 c = s[i];
    uint4 r;
    r.x = __float_as_uint(__uint_as_float(v.x) * inv * c.x);
    r.y = __float_as_uint(__uint_as_float(v.y) * inv * c.y);
    r.z = __float_as_uint(__uint_as_float(v.z) * inv * c.z);
    r.w = __float_as_uint(__uint_as_float(v.w) * inv * c.w);
    return r;
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static float sumsq(const uint4& v, float ss) {
    const float2 a = bf2_to_f2(v.x), b = bf2_to_f2(v.y);
    const float2 c = bf2_to_f2(v.z), d = bf2_to_f2(v.w);
    ss = fmaf(a.y, a.y, fmaf(a.x, a.x, ss));
    ss = fmaf(b.y, b.y, fmaf(b.x, b.x, ss));
    ss = fmaf(c.y, c.y, fmaf(c.x, c.x, ss));
    return fmaf(d.y, d.y, fmaf(d.x, d.x, ss));
  }
  __device__ static uint4 scaled(const uint4& v, float inv, const float4* s,
                                 int nvec, int i) {
    const float4 lo = s[i], hi = s[nvec + i];
    const float2 a = bf2_to_f2(v.x), b = bf2_to_f2(v.y);
    const float2 c = bf2_to_f2(v.z), d = bf2_to_f2(v.w);
    uint4 r;
    r.x = f2_to_bf2(a.x * inv * lo.x, a.y * inv * lo.y);
    r.y = f2_to_bf2(b.x * inv * lo.z, b.y * inv * lo.w);
    r.z = f2_to_bf2(c.x * inv * hi.x, c.y * inv * hi.y);
    r.w = f2_to_bf2(d.x * inv * hi.z, d.y * inv * hi.w);
    return r;
  }
};

// The row group's total, the same bits in every thread of it: a butterfly
// inside the warp (or the tpr-lane part of it), then, for g = tpr / 32 > 1
// warps, their g partials added in warp order after a barrier of those g
// warps. `part` is this row's half of the double buffer.
__device__ __forceinline__ float row_sum(float v, int tpr, int group,
                                         float* part) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tpr <= 32) return v;
  const int warps = tpr / 32, first = group * warps;
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  named_barrier(1 + group, tpr);
  float total = 0.f;
  for (int w = 0; w < warps; ++w) total += part[first + w];
  return total;
}

// The VPT vectors of row `row` this thread owns (zeros past the last row,
// so a partly filled warp still joins its shuffles).
template <int VPT>
__device__ __forceinline__ void load_row(uint4 (&v)[VPT], const uint4* x,
                                         long long row, int n, int nvec,
                                         int tpr, int t) {
  if (row < n) {
    const uint4* xr = x + row * nvec + t;
#pragma unroll
    for (int j = 0; j < VPT; ++j) v[j] = ld_stream(xr + j * tpr);
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) v[j] = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kBlock, 2)
    rmsnorm_rows(const T* __restrict__ x, const void* __restrict__ scale,
                 int scale_code, T* __restrict__ out, int n, int d, int tpr,
                 float eps) {
  using V = Vec<T>;
  constexpr int kElems = V::kElems;
  constexpr bool kPrefetch = VPT <= kPrefetchVptMax;
  extern __shared__ float4 scale4[];  // d floats in planes of four columns
  __shared__ float part[2][kBlock / 32];
  const int nvec = d / kElems;
  const int group = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int rows_per_block = blockDim.x / tpr;
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* out4 = reinterpret_cast<uint4*>(out);

  long long base = static_cast<long long>(blockIdx.x) * rows_per_block;
  uint4 v[VPT];
  load_row(v, x4, base + group, n, nvec, tpr, t);

  float* sf = reinterpret_cast<float*>(scale4);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const int vec = i / kElems, c = i % kElems;
    sf[((c / 4) * nvec + vec) * 4 + c % 4] = load_scale(scale, scale_code, i);
  }
  __syncthreads();

  const float inv_d = 1.f / static_cast<float>(d);
  for (int parity = 0; base < n; base += stride, parity ^= 1) {
    const long long row = base + group;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      ss = V::sumsq(v[j], ss);
      asm volatile("" : "+r"(v[j].x), "+r"(v[j].y), "+r"(v[j].z),
                   "+r"(v[j].w));
    }
    ss = row_sum(ss, tpr, group, part[parity]);
    const float inv = rsqrtf(ss * inv_d + eps);
    uint4 next[kPrefetch ? VPT : 1];
    if constexpr (kPrefetch)
      load_row(next, x4, base + stride + group, n, nvec, tpr, t);
    if (row < n) {
      uint4* orow = out4 + row * nvec + t;
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        st_stream(orow + j * tpr, V::scaled(v[j], inv, scale4, nvec,
                                            j * tpr + t));
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) v[j] = next[j];
    } else {
      load_row(v, x4, base + stride + group, n, nvec, tpr, t);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename S>
__global__ void rmsnorm_general(const T* __restrict__ x,
                                const S* __restrict__ scale,
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
  const float inv = rsqrtf(ss * (1.f / static_cast<float>(d)) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      r[j] = from_f<T>(to_f(e[j]) * inv * to_f(scale[i * VEC + j]));
    reinterpret_cast<uint4*>(orow)[i] = res;
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_f<T>(to_f(xr[i]) * inv * to_f(scale[i]));
}

// Occupancy of one instantiation of the register variant at `smem` bytes
// of scale on one device: found once, then reused.
struct Occupancy {
  int device = -1;
  size_t smem = 0;
  int sms = 0, blocks_per_sm = 0;
};

std::mutex occupancy_lock;

template <typename T, int VPT>
cudaError_t launch_rows(const void* x, const void* scale, int scale_code,
                        void* out, int n, int d, int tpr, float eps,
                        int device, cudaStream_t s) {
  static Occupancy occ;
  const auto kernel = rmsnorm_rows<T, VPT>;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = cudaSuccess;
  int sms, blocks_per_sm;
  {
    std::lock_guard<std::mutex> guard(occupancy_lock);
    if (occ.device != device || occ.smem != smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&occ.sms, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ.blocks_per_sm, kernel, kBlock, smem);
      if (err != cudaSuccess) {
        occ.device = -1;
        return err;
      }
      occ.device = device;
      occ.smem = smem;
    }
    sms = occ.sms;
    blocks_per_sm = occ.blocks_per_sm;
  }
  if (blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  const int rows_per_block = kBlock / tpr;
  const long long wanted =
      (static_cast<long long>(n) + rows_per_block - 1) / rows_per_block;
  const long long resident = static_cast<long long>(sms) * blocks_per_sm;
  const int grid = static_cast<int>(wanted < resident ? wanted : resident);
  kernel<<<grid, kBlock, smem, s>>>(static_cast<const T*>(x), scale,
                                    scale_code, static_cast<T*>(out), n, d,
                                    tpr, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int vpt, const void* x, const void* scale,
                          int scale_code, void* out, int n, int d, int tpr,
                          float eps, int device, cudaStream_t s) {
  switch (vpt) {
#define RMSNORM_VPT(V)                                                   \
  case V:                                                                \
    return launch_rows<T, V>(x, scale, scale_code, out, n, d, tpr, eps,  \
                             device, s);
    RMSNORM_VPT(1) RMSNORM_VPT(2) RMSNORM_VPT(3) RMSNORM_VPT(4)
    RMSNORM_VPT(5) RMSNORM_VPT(6) RMSNORM_VPT(7) RMSNORM_VPT(8)
    RMSNORM_VPT(9) RMSNORM_VPT(10) RMSNORM_VPT(11) RMSNORM_VPT(12)
    RMSNORM_VPT(13) RMSNORM_VPT(14) RMSNORM_VPT(15) RMSNORM_VPT(16)
#undef RMSNORM_VPT
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_general(const void* x, const void* scale, int scale_code,
                           void* out, int n, int d, int threads, float eps,
                           cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (scale_code == kF32)
    rmsnorm_general<T, float><<<n, threads, 0, s>>>(
        xt, static_cast<const float*>(scale), ot, d, eps);
  else if (scale_code == kBF16)
    rmsnorm_general<T, __nv_bfloat16><<<n, threads, 0, s>>>(
        xt, static_cast<const __nv_bfloat16*>(scale), ot, d, eps);
  else
    rmsnorm_general<T, __half><<<n, threads, 0, s>>>(
        xt, static_cast<const __half*>(scale), ot, d, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches the norm of `n` contiguous rows of width `d` on `stream` of
// `device` (made current for the launch, then restored);
// `x_code` is the dtype of x and out (kF32 or kBF16), `scale_code` that of
// the (d,) scale vector (kF32, kBF16 or kF16). The plan comes from the
// wrapper: `variant` kRows with `vpt` vectors a thread and `tpr` threads a
// row (their product times the vector's elements must be d, and x and out
// 16-byte aligned), or kGeneral with `tpr` threads a block (a multiple of
// 32, at most 256; `vpt` unused). Returns the launch's cudaError_t (0 on
// success); a plan that breaks these rules is refused as
// cudaErrorInvalidValue. Does not synchronise and allocates nothing.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int n, int d, float eps, int x_code,
                              int scale_code, int variant, int vpt, int tpr,
                              int device, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if ((x_code != kF32 && x_code != kBF16) ||
      (scale_code != kF32 && scale_code != kBF16 && scale_code != kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elems = x_code == kF32 ? 4 : 8;
  if (variant == kRows) {
    const bool fits = tpr >= 1 && tpr <= kBlock && (tpr & (tpr - 1)) == 0 &&
                      vpt >= 1 && vpt <= kVptMax &&
                      static_cast<long long>(vpt) * tpr * elems == d &&
                      aligned16(x) && aligned16(out);
    if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  } else if (variant != kGeneral || tpr < 32 || tpr > kBlock || tpr % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kRows)
    err = x_code == kF32
              ? dispatch_rows<float>(vpt, x, scale, scale_code, out, n, d,
                                     tpr, eps, device, s)
              : dispatch_rows<__nv_bfloat16>(vpt, x, scale, scale_code, out,
                                             n, d, tpr, eps, device, s);
  else
    err = x_code == kF32
              ? launch_general<float>(x, scale, scale_code, out, n, d, tpr,
                                      eps, s)
              : launch_general<__nv_bfloat16>(x, scale, scale_code, out, n,
                                              d, tpr, eps, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
