// Mega-batch predict recurrence for Hopper (sm_90a), float64: a dataflow
// scan over walks.
//
// Replaces the TPU kernel `_scan_pallas` of the reference package
// (kernels/megabatch_scan.py). Every live row of a compiled program
// evaluates
//
//     start      = max_{d<3}( ends[dep[d]] + delay[d] )
//     starts[out] = start
//     ends[out]   = start + dur
//
// The TPU kernel walks a sequential grid of T steps over one
// VMEM-resident `ends` vector. Here the program comes in its walk layout
// (kernels/megabatch_scan.py `build_walks`): a lane's live rows grouped into
// walks — one pipeline device's chain of tasks each, chains folded
// modulo 64 — every walk in ascending step order. One block runs one
// lane and one thread one walk:
//
// * A thread advances its walk row by row. The row that wrote a
//   dependency just before is usually the thread's own previous row
//   (dep0, the device's previous task): that value comes from a register.
//   The dummy slot 0 reads as the constant 0.0.
// * Every other dependency is read from `ends` in global memory, which is
//   its own ready flag: the wrapper fills the written slots with a
//   signalling-NaN sentinel that no arithmetic produces, and a reader
//   polls a slot with relaxed block-scope loads until it holds another
//   value. Producer and readers share the block (dependencies never leave
//   a lane), so block scope suffices. `ends` is deliberately neither
//   `const __restrict__` nor read through `__ldg`: the read-only path
//   may keep returning a stale sentinel.
// * The loop is convergent: each pass every thread polls the
//   dependencies its head row still lacks, and threads whose values have
//   all arrived compute and move on. Nothing spins inside a branch, so a
//   producer is never starved by a waiting thread of its own warp.
// * Rows do not depend on the chain, so each thread stages its next
//   kRing rows into its own ring in shared memory with cp.async, one
//   commit group a row.
//
// No deadlock: a walk is a subsequence of its lane's step order, and a
// dependency is the dummy or a slot the lane wrote at an earlier step
// (`build_walks` refuses anything else), so the lane's earliest
// unfinished row always has its dependencies done and heads its walk. A
// wait that lasts 10 s traps all the same (as K2's `mbar_wait`): the
// launch then fails instead of hanging the card.
//
// Bound: the bytes of the program (48 B a live row) would stream in well
// under a millisecond; what bounds the kernel is the dependency chain.
// The one-thread-per-lane kernel this replaces paid one dependent L2/HBM
// round trip per step of the longest lane (262 144 steps on the serve
// program); here a walk pays one block-local round trip per wave of the
// DAG, about its depth (~4 200 waves there), and the walks of a lane
// overlap.
//
// Arithmetic is `+` and `max` on doubles only (no products, so nothing
// can be contracted into an FMA), the same operations per row as the
// float64 NumPy reference, dep0's `+ 0.0` included: results are
// bit-identical to it.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers and the current stream, and checks the returned
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int kMaxThreads = 64;    // walks a lane at most (MAX_WALKS)
constexpr int kRing = 8;           // rows a thread stages ahead
constexpr int kRowBytes = 48;      // out 4 + dep 12 + delay 24 + dur 8
constexpr long long kSentinel = 0x7FF0DEAD0000BEEFll;   // SENTINEL_BITS
constexpr uint64_t kWatchdogNs = 10000000000ull;

__device__ __forceinline__ double ld_block(const double* p) {
  double v;
  asm volatile("ld.relaxed.cta.global.f64 %0, [%1];"
               : "=d"(v)
               : "l"(__cvta_generic_to_global(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_block(double* p, double v) {
  asm volatile("st.relaxed.cta.global.f64 [%0], %1;" ::"l"(
                   __cvta_generic_to_global(p)),
               "d"(v)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// returns once at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool pending(double v) {
  return __double_as_longlong(v) == kSentinel;
}

struct Row {
  int32_t o, d0, d1, d2;
  double l0, l1, l2, du;
};

// This thread's ring: slot `s` of thread `t` of `nt` is element s*nt+t of
// each plane (dep and delay three wide), so a warp's threads read
// consecutive words whatever slots they are at.
struct Ring {
  double* delay;   // [kRing][nt][3]
  double* dur;     // [kRing][nt]
  int32_t* dep;    // [kRing][nt][3]
  int32_t* out;    // [kRing][nt]
};

__device__ __forceinline__ void stage(const Ring& q, int e, int r, int r1,
                                      const int32_t* __restrict__ out,
                                      const int32_t* __restrict__ dep,
                                      const double* __restrict__ delay,
                                      const double* __restrict__ dur) {
  if (r < r1) {
    const size_t i = static_cast<size_t>(r);
    cp_async4(q.out + e, out + i);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      cp_async4(q.dep + 3 * e + d, dep + 3 * i + d);
      cp_async8(q.delay + 3 * e + d, delay + 3 * i + d);
    }
    cp_async8(q.dur + e, dur + i);
  }
  cp_async_commit();   // one group a row, empty past the walk's end
}

__device__ __forceinline__ Row unstage(const Ring& q, int e) {
  Row w;
  w.o = q.out[e];
  w.d0 = q.dep[3 * e];
  w.d1 = q.dep[3 * e + 1];
  w.d2 = q.dep[3 * e + 2];
  w.l0 = q.delay[3 * e];
  w.l1 = q.delay[3 * e + 1];
  w.l2 = q.delay[3 * e + 2];
  w.du = q.dur[e];
  return w;
}

// a dependency's value if this thread knows it already, else the sentinel
__device__ __forceinline__ double known(int32_t d, int32_t prev_out,
                                        double prev_end) {
  if (d == prev_out) return prev_end;
  if (d == 0) return 0.0;   // the dummy slot
  return __longlong_as_double(kSentinel);
}

__global__ void __launch_bounds__(kMaxThreads)
    megabatch_walk_kernel(const int32_t* __restrict__ out,
                          const int32_t* __restrict__ dep,
                          const double* __restrict__ delay,
                          const double* __restrict__ dur,
                          const int32_t* __restrict__ walk_ptr,
                          const int32_t* __restrict__ lane_walk_ptr,
                          double* ends, double* starts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int w0 = lane_walk_ptr[blockIdx.x];
  const int w1 = lane_walk_ptr[blockIdx.x + 1];
  if (w1 - w0 > nt) __trap();   // a walk without a thread would never run
  const int w = w0 + t;
  if (w >= w1) return;
  const int r0 = walk_ptr[w];
  const int r1 = walk_ptr[w + 1];
  if (r0 >= r1) return;

  Ring q;
  q.delay = reinterpret_cast<double*>(smem);
  q.dur = q.delay + kRing * nt * 3;
  q.dep = reinterpret_cast<int32_t*>(q.dur + kRing * nt);
  q.out = q.dep + kRing * nt * 3;

#pragma unroll
  for (int i = 0; i < kRing; ++i) stage(q, i * nt + t, r0 + i, r1, out, dep,
                                        delay, dur);

  int r = r0;
  int32_t prev_out = -1;   // no slot
  double prev_end = 0.0;
  cp_async_wait<kRing - 1>();
  Row cur = unstage(q, t);
  double v0 = known(cur.d0, prev_out, prev_end);
  double v1 = known(cur.d1, prev_out, prev_end);
  double v2 = known(cur.d2, prev_out, prev_end);
  uint32_t polls = 0;
  uint64_t since = 0;

  for (;;) {
    if (pending(v0)) v0 = ld_block(ends + cur.d0);
    if (pending(v1)) v1 = ld_block(ends + cur.d1);
    if (pending(v2)) v2 = ld_block(ends + cur.d2);
    if (!pending(v0) && !pending(v1) && !pending(v2)) {
      const double s = fmax(fmax(v0 + cur.l0, v1 + cur.l1), v2 + cur.l2);
      const double e = s + cur.du;
      starts[cur.o] = s;
      st_block(ends + cur.o, e);
      prev_out = cur.o;
      prev_end = e;
      // the row just read out of its slot frees it for row r + kRing
      const int slot = (r - r0) & (kRing - 1);
      stage(q, slot * nt + t, r + kRing, r1, out, dep, delay, dur);
      if (++r == r1) break;
      cp_async_wait<kRing - 1>();
      cur = unstage(q, ((r - r0) & (kRing - 1)) * nt + t);
      v0 = known(cur.d0, prev_out, prev_end);
      v1 = known(cur.d1, prev_out, prev_end);
      v2 = known(cur.d2, prev_out, prev_end);
      polls = 0;
      since = 0;
    } else if ((++polls & 0x3FFu) == 0) {
      const uint64_t now = hopper::global_ns();
      if (since == 0) since = now;
      else if (now - since > kWatchdogNs) __trap();
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
}

}  // namespace

// Shared memory a block of `threads` threads uses.
extern "C" int megabatch_scan_smem_bytes(int threads) {
  return threads * kRing * kRowBytes;
}

// Launches the scan on `stream`, one block of `threads` threads per lane;
// returns the launch's cudaError_t (0 on success). Does not synchronise
// and allocates nothing. The caller fills `ends` with the sentinel in the
// slots the rows write and 0.0 elsewhere, and `starts` with zeros.
extern "C" int megabatch_scan_launch(const int32_t* out, const int32_t* dep,
                                     const double* delay, const double* dur,
                                     const int32_t* walk_ptr,
                                     const int32_t* lane_walk_ptr,
                                     double* ends, double* starts, int lanes,
                                     int threads, void* stream) {
  if (lanes <= 0) return static_cast<int>(cudaSuccess);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  megabatch_walk_kernel<<<lanes, threads, megabatch_scan_smem_bytes(threads),
                          static_cast<cudaStream_t>(stream)>>>(
      out, dep, delay, dur, walk_ptr, lane_walk_ptr, ends, starts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* megabatch_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
