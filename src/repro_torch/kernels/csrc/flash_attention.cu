// Forward flash attention for Hopper (sm_90a) on the model's (B, S, H, hd)
// layout with grouped-query KV heads, causal and sliding-window masks;
// Sk may differ from Sq in any call (positions aligned top-left).
//
// Replaces the TPU kernel `flash_attention_bh` / `_flash_kernel` of the
// reference package (kernels/flash_attention.py), reached from the
// model through `ops.flash_attention`. For each query row q and key k
// (positions are the row indices, 0..Sq-1 and 0..Sk-1):
//
//     s      = (q . k) * hd^-0.5                     in fp32
//     valid  = k < Sk  &  (!causal | k <= q)  &  (window | q - k < window)
//     out[q] = sum_k softmax_k(s)[k] * v[k] / max(l, 1e-30)
//
// with the running (m, l, acc) online softmax. The reference body casts
// q, k and v to fp32 before both products, so P.V is an fp32 product;
// here too: tiles are staged in shared memory as fp32 and every product
// is an IEEE fp32 FMA on the CUDA cores (no tensor cores, hence no TF32
// and no bf16 rounding of P). It serves fp32 inputs and the bf16 inputs
// the tensor-core kernel (flash_attention_tc.cu) does not take; the
// Python wrapper's `uses_tensor_cores` decides which, before the launch.
//
// A row with no valid key (windowed, Sq > Sk, q >= Sk - 1 + window) gets
// the reference's value: its -1e30 fill weighs every slot of the padded
// key range 1, so the row is sum_{k<Sk} v[k] / (Sk + pk), pk the zero
// rows padding Sk to whole blocks of min(128, max(8, Sk)). Its l is 0
// here: before the epilogue, the block sums V's columns once and gives
// each such row those sums as its acc and Sk + pk as its l, in a variant
// of the kernel (EMPTY) launched only where a row can see no key (Sq -
// Sk >= window); the other variant is the kernel without that step.
//
// The TPU grid (BH, q-blocks, kv-blocks) runs its kv dimension in order
// and carries (m, l, acc) in VMEM scratch. Here one block owns one
// (batch*head, 64-row q tile) and loops over the kv tiles itself, so the
// scratch becomes registers: each of the 256 threads owns 4 query rows
// (ty + 16 i) x 4 key columns (tx + 16 j) of the 64x64 score tile and
// the same 4 rows x hd/16 columns of the output accumulator. The 16
// threads of a row sit in one half-warp, so row max and row sum are
// shuffles. P goes through shared memory for the P.V product.
//
// Differences from the TPU kernel, all on purpose:
// * kv tiles wholly outside the causal/window band are not visited (the
//   reference walks and masks them); masked scores are -inf with the
//   usual guard, not -1e30, so a tile where a row has no valid key
//   contributes exactly nothing;
// * the KV head of query head h is h / n_rep, read in place through
//   strides: no repeated or transposed copy of K and V;
// * a ragged S is handled by masked loads (zeros), not host padding;
// * hd is padded to a template width (32, 64, 80, 96 or 128) with zeros
//   in shared memory.
//
// Bound: operations. At S = 8192 with window 4096 a (b, h) pair holds
// 25 M valid (q, k) pairs at 4 hd flops each; the bytes (q, k, v, o
// once) are two orders of magnitude below that at 3.35 TB/s. This
// version runs on the fp32 CUDA cores and is bound by shared-memory
// reads (about 2 FMAs per 4-byte load), well above the tensor-core
// bound; PERF.md has the numbers.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, element strides and the current stream, and checks
// the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0, kBF16 = 1;  // dtype codes shared with Python

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TR = BM / 16;   // rows per thread
constexpr int TC = BN / 16;   // score columns per thread
constexpr int LDP = BN + 1;   // odd strides: conflict-free column reads

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of the batch, sequence and head dimensions (the
  // head_dim stride is 1)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, n_rep, Sq, Sk, hd, causal, window;  // window <= 0: none
  float scale;
  float empty_den;  // Sk + pk: an empty row's divisor
};

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

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BM) * (HDP + 1) +  // Q
          static_cast<size_t>(BN) * (HDP + 1) +  // K
          static_cast<size_t>(BN) * HDP +        // V
          static_cast<size_t>(BM) * LDP);        // P
}

template <typename T, int HDP, bool EMPTY>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int LDQ = HDP + 1;  // odd: the 16 rows a half-warp reads
  constexpr int LDV = HDP;      //   at one column sit in 16 banks
  constexpr int TO = HDP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LDQ;
  float* Vs = Ks + BN * LDQ;
  float* Ps = Vs + BN * LDV;

  const int n_qt = (p.Sq + BM - 1) / BM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // long first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kh = h / p.n_rep;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qt * BM;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  for (int e = tid; e < BM * HDP; e += THREADS) {
    const int r = e / HDP, c = e % HDP;
    float val = 0.f;
    if (q0 + r < p.Sq && c < p.hd) val = to_f(qg[(q0 + r) * p.q_ss + c]);
    Qs[r * LDQ + c] = val;
  }

  // the kv range any row of this tile can see
  const int q_last = min(q0 + BM, p.Sq) - 1;
  const int kv_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kv_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int t_lo = kv_lo / BN;
  const int t_hi = (kv_hi + BN - 1) / BN;

  float m[TR], l[TR], acc[TR][TO];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TO; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < BN * HDP; e += THREADS) {
      const int r = e / HDP, c = e % HDP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < p.Sk && c < p.hd) {
        kv = to_f(kg[(k0 + r) * p.k_ss + c]);
        vv = to_f(vg[(k0 + r) * p.v_ss + c]);
      }
      Ks[r * LDQ + c] = kv;
      Vs[r * LDV + c] = vv;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kv[j] = Ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos) &&
                        (p.window <= 0 || qpos - kpos < p.window);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no inf-inf
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float pv = expf(s[i][j] - m_use);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + n];
#pragma unroll
      for (int c = 0; c < TO; ++c) {
        const float vv = Vs[n * LDV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  if constexpr (EMPTY) {
    // a row that saw no key (l == 0) takes V's column sums over all Sk
    // keys as its acc and the padded key range's length as its l: the 16
    // row groups each sum every 16th key of their columns, then thread
    // (ty, tx) adds up the 16 partial sums of its columns
    bool empty = false;
#pragma unroll
    for (int i = 0; i < TR; ++i)
      empty |= q0 + ty + 16 * i < p.Sq && l[i] == 0.f;
    if (__syncthreads_or(empty)) {
      float part[TO];
#pragma unroll
      for (int c = 0; c < TO; ++c) part[c] = 0.f;
      for (int r = ty; r < p.Sk; r += 16)
#pragma unroll
        for (int c = 0; c < TO; ++c) {
          const int col = tx + 16 * c;
          if (col < p.hd) part[c] += to_f(vg[r * p.v_ss + col]);
        }
      // Ps is free: __syncthreads_or is a barrier after the last P.V
#pragma unroll
      for (int c = 0; c < TO; ++c) Ps[ty * HDP + tx + 16 * c] = part[c];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        if (l[i] != 0.f) continue;
        l[i] = p.empty_den;
#pragma unroll
        for (int c = 0; c < TO; ++c) {
          float sum = 0.f;
          for (int g = 0; g < 16; ++g) sum += Ps[g * HDP + tx + 16 * c];
          acc[i][c] = sum;
        }
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < TO; ++c) {
      const int col = tx + 16 * c;
      if (col < p.hd) og[qpos * p.o_ss + col] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int HDP, bool EMPTY>
cudaError_t launch_variant(const Params& p, int BH, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP, EMPTY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, BH);
  flash_fwd_kernel<T, HDP, EMPTY><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The variant with the empty-row step only where a row can see no
// key (windowed, Sq - Sk >= window): every other call runs the kernel
// without it.
template <typename T, int HDP>
cudaError_t launch(const Params& p, int BH, cudaStream_t stream) {
  if (p.window > 0 && p.Sq - p.Sk >= p.window)
    return launch_variant<T, HDP, true>(p, BH, stream);
  return launch_variant<T, HDP, false>(p, BH, stream);
}

template <typename T>
cudaError_t launch_hd(const Params& p, int BH, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, 32>(p, BH, stream);
  if (p.hd <= 64) return launch<T, 64>(p, BH, stream);
  if (p.hd <= 80) return launch<T, 80>(p, BH, stream);
  if (p.hd <= 96) return launch<T, 96>(p, BH, stream);
  if (p.hd <= 128) return launch<T, 128>(p, BH, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches forward attention on `stream`. q: (B, Sq, H, hd); k, v:
// (B, Sk, H / n_rep, hd); o: (B, Sq, H, hd); all of dtype `code` (kF32 or
// kBF16) with unit head_dim stride. `strides` holds 12 element strides:
// (batch, seq, head) of q, k, v and o in that order. window <= 0 means no
// window. Returns the launch's cudaError_t (0 on success). Does not
// synchronise and allocates nothing.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B,
                                      int H, int n_rep, int Sq, int Sk,
                                      int hd, int causal, int window,
                                      float scale, int code, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || hd <= 0 || n_rep <= 0 || H % n_rep != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.H = H;
  p.n_rep = n_rep;
  p.Sq = Sq;
  p.Sk = Sk;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const int block_kv = Sk < 8 ? 8 : (Sk < 128 ? Sk : 128);
  p.empty_den =
      static_cast<float>(Sk + (block_kv - Sk % block_kv) % block_kv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (code == kF32)
    err = launch_hd<float>(p, B * H, s);
  else if (code == kBF16)
    err = launch_hd<__nv_bfloat16>(p, B * H, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
