// Mega-batch predict recurrence for Hopper (sm_90a), float64.
//
// Replaces the TPU kernel `_scan_pallas` of the reference package
// (kernels/megabatch_scan.py). For step j and candidate lane k of a
// compiled (T, K) program:
//
//     start            = max_{d<3}( ends[dep[j,k,d]] + delay[j,k,d] )
//     starts[out[j,k]] = start
//     ends[out[j,k]]   = start + dur[j,k]
//
// The TPU kernel walks a sequential grid of T steps over one
// VMEM-resident `ends` vector. Here the whole program is ONE launch:
// one thread owns one lane and loops over that lane's steps; lanes run
// in parallel and never synchronise. That is sound because a lane reads
// only slot 0 (the constant 0.0) and slots that the same lane wrote at
// an earlier step, and padding rows write only a trash slot whose value
// nobody reads. A thread sees its own earlier global stores in program
// order, so `ends`/`starts` need neither atomics nor fences; they are
// deliberately NOT declared __restrict__.
//
// Bound: the work is a dependency chain, not bandwidth. The bytes of a
// program are read once (48 B per live step) and would stream in well
// under a millisecond, but every step waits for the gather of the step
// before it, so the time is (steps of the longest lane) x (one
// dependent L2/HBM round trip). What the design does about it: the
// program rows do not depend on the chain, so they are fetched one step
// ahead into registers and several steps ahead into L2, leaving only
// the `ends` gather on the critical path; (T, K) row-major planes make
// the 32 lanes of a warp read consecutive addresses at each step; and
// a lane stops at its own length instead of walking padding.
//
// Arithmetic is `+` and `max` on doubles only (no products, so nothing
// can be contracted into an FMA): results are bit-identical to the
// float64 NumPy reference. Programs are NaN-free by construction.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and checks the returned
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPrefetchAhead = 8;   // rows fetched ahead into L2

struct Row {
  int32_t o, d0, d1, d2;
  double l0, l1, l2, du;
};

__device__ __forceinline__ Row load_row(const int32_t* __restrict__ out,
                                        const int32_t* __restrict__ dep,
                                        const double* __restrict__ delay,
                                        const double* __restrict__ dur,
                                        size_t r) {
  Row w;
  w.o = __ldg(out + r);
  w.d0 = __ldg(dep + 3 * r);
  w.d1 = __ldg(dep + 3 * r + 1);
  w.d2 = __ldg(dep + 3 * r + 2);
  w.l0 = __ldg(delay + 3 * r);
  w.l1 = __ldg(delay + 3 * r + 1);
  w.l2 = __ldg(delay + 3 * r + 2);
  w.du = __ldg(dur + r);
  return w;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__global__ void megabatch_scan_kernel(const int32_t* __restrict__ out,
                                      const int32_t* __restrict__ dep,
                                      const double* __restrict__ delay,
                                      const double* __restrict__ dur,
                                      const int32_t* __restrict__ lengths,
                                      double* ends, double* starts,
                                      int T, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  int n = lengths[k];
  if (n > T) n = T;
  if (n <= 0) return;

  const size_t stride = static_cast<size_t>(K);
  size_t r = static_cast<size_t>(k);
  Row cur = load_row(out, dep, delay, dur, r);
  for (int j = 0; j < n; ++j) {
    Row nxt = cur;
    if (j + 1 < n) nxt = load_row(out, dep, delay, dur, r + stride);
    if (j + kPrefetchAhead < n) {
      const size_t p = r + kPrefetchAhead * stride;
      prefetch_l2(out + p);
      prefetch_l2(dep + 3 * p);
      prefetch_l2(delay + 3 * p);
      prefetch_l2(dur + p);
    }
    const double a0 = ends[cur.d0] + cur.l0;
    const double a1 = ends[cur.d1] + cur.l1;
    const double a2 = ends[cur.d2] + cur.l2;
    const double s = fmax(fmax(a0, a1), a2);
    starts[cur.o] = s;
    ends[cur.o] = s + cur.du;
    cur = nxt;
    r += stride;
  }
}

}  // namespace

// Launches the scan on `stream`; returns the launch's cudaError_t (0 on
// success). Does not synchronise and allocates nothing. `ends` and
// `starts` must be zero-filled by the caller (slot 0 reads 0.0).
extern "C" int megabatch_scan_launch(const int32_t* out, const int32_t* dep,
                                     const double* delay, const double* dur,
                                     const int32_t* lengths, double* ends,
                                     double* starts, int T, int K,
                                     int threads, void* stream) {
  if (T <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (K + threads - 1) / threads;
  megabatch_scan_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      out, dep, delay, dur, lengths, ends, starts, T, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* megabatch_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
