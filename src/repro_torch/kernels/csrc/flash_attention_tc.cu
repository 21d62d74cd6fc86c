// Forward flash attention on Hopper's tensor cores (sm_90a): bf16 q, k, v
// on the model's (B, S, H, hd) layout with grouped-query KV heads, causal
// and sliding-window masks, hd in {32, 64, 80, 96, 128}; any call may
// have Sk != Sq (positions aligned top-left, as the reference's).
//
// Replaces the TPU kernel `flash_attention_bh` / `_flash_kernel` of the
// reference package (src/repro/kernels/flash_attention.py:74), reached
// from the model through `ops.flash_attention`. For each query row q and
// key k (positions are the row indices, 0..Sq-1 and 0..Sk-1):
//
//     s      = (q . k) * hd^-0.5                     in fp32
//     valid  = k < Sk &  (!causal | k <= q)  &  (window | q - k < window)
//     out[q] = sum_k softmax_k(s)[k] * v[k] / max(l, 1e-30)
//
// with the running (m, l, acc) online softmax, rounded to bf16 at the end.
// A row with no valid key (windowed, Sq > Sk, q >= Sk - 1 + window) gets
// the reference's value: its -1e30 fill weighs every slot of the padded
// key range 1, so the row is sum_{k<Sk} v[k] / (Sk + pk), pk the zero
// rows that pad Sk to whole blocks of min(128, max(8, Sk)).
// The Python wrapper sends here bf16 inputs whose head dim is one of the
// five widths and whose base and strides TMA can address (16-byte base,
// strides in multiples of 16 bytes); fp32 and every other bf16 input go to
// the scalar IEEE-fp32 kernel in flash_attention.cu. That is a rule on
// dtype and shape decided before any launch, not a fallback.
//
// Bound: operations, 4 hd flops a valid (q, k) pair at the bf16 tensor-core
// rate (0.52 ms for the model's layer: q 2x8192x32x80, window 4096). The
// kernel issues about 1.5x that (the split below) plus the masked parts
// of the tiles on the diagonal and the window's edge.
//
// Design. One block per (batch*head, 128-row q tile), longest tiles first;
// kv tiles wholly outside the causal/window band are not visited.
// * Warp specialisation: warpgroups 0 and 1 each own 64 query rows; one
//   warp of warpgroup 2 issues the copies. Registers move from the
//   producer (24) to the consumers (240) with setmaxnreg.
// * Copies: TMA through 4-D tensor maps (hd, S, heads, B) built on the
//   caller's strides, so the KV head h / n_rep is a coordinate (no repeat,
//   no copy) and a ragged Sq or Sk tail arrives as zeros. A zero key
//   still scores 0 and would take softmax mass, so keys k >= Sk are
//   masked to -inf by position in the last tile; the Q and K/V maps have
//   Sq and Sk rows; the band's bounds below take q positions from Q's
//   rows and key positions from K's, both from 0. Q is loaded
//   once; K and V go through a 2-stage ring in shared memory, with a full
//   barrier each for K and V (S = Q K^T starts before V lands) and one
//   empty barrier that all 256 consumer threads arrive on.
// * hd = 80 is not a multiple of the 64-element atom of the 128-byte
//   swizzle. The tiles use the 32-byte swizzle instead: 16-element atoms,
//   hd = 5 x 16 with no padding, one TMA box of 16 columns each. Padding
//   hd to 96 for the 64-byte swizzle would cost 1.2x the tensor-core work
//   on every product; the narrower swizzle costs only more TMA boxes (5 a
//   tile) and descriptors, and serves 32..128 alike.
// * S = Q K^T: wgmma m64n128k16, A = Q and B = the K tile, both K-major
//   in shared memory, hd / 16 steps, fp32 accumulators.
// * Softmax in registers: each thread holds two rows; row max by quad
//   shuffles, hd^-0.5 * log2(e) folded into one scale and exp2 (ex2.approx,
//   2 ulp); a row with no valid key yet uses 0 as its max (the -inf guard),
//   so such a tile adds exactly nothing. Only tiles that cross the
//   diagonal, the window's edge or the end of Sk are masked.
// * O += P V: wgmma m64nHDk16 with A = P from registers (the S accumulator
//   of a 16-key slice is already in the A-fragment layout) and B = the V
//   tile read MN-major. The reference computes P.V in fp32 (its body
//   casts q, k, v to fp32 and P stays fp32), and a bf16 P would add a
//   relative error of up to 2^-9 a term: about 3e-5 on an output of a
//   full 4096-key window, past the two-bf16-ulp bar near zero. So P is
//   split into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and both run
//   through the tensor cores into the same fp32 accumulator; V is bf16,
//   so each product is exact, and what remains is about 2^-17 relative,
//   below fp32 summation noise. Q K^T needs no split: bf16 x bf16 products
//   are exact in fp32.
// * Epilogue: O / max(l, 1e-30) to bf16, rows past Sq not stored. A row
//   whose l is 0 saw no key: before the epilogue, a warp that holds one
//   sums V's columns over all Sk keys (the 8 lanes that share a thread's
//   columns each take every 8th key, then shuffles add them up) and
//   gives the row those sums and the padded range's length as its l.
//   That step is compiled into a variant of its own (EMPTY), launched
//   only where a row can see no key (windowed, Sq - Sk >= window); the
//   other variant is the kernel without it.
//
// Plain C interface (no PyTorch headers): the Python wrapper passes raw
// device pointers, element strides and the current stream, and checks
// the returned cudaError_t. cuTensorMapEncodeTiled is looked up at run
// time through the runtime's entry-point query, so nothing links libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;         // query rows a block: two warpgroups of 64
constexpr int BN = 128;         // keys a kv tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 384;    // consumer warpgroups 0, 1; producer 2
constexpr int ATOM = 16;        // bf16 columns of one 32-byte swizzle row
constexpr int ROW_BYTES = 32;   // bytes of one row of a box
constexpr int CONSUMERS = 256;  // threads that arrive on an empty barrier
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

struct Params {
  void* o;
  long long o_sb, o_ss, o_sh;  // element strides of the output
  int H, n_rep, Sq, Sk, causal, window;  // window <= 0: none
  float scale_log2;                 // hd^-0.5 * log2(e)
  const __nv_bfloat16* v;           // V again, for an empty row's mean
  long long v_sb, v_ss, v_sh;
  float empty_den;                  // Sk + pk: an empty row's divisor
};

// Shared memory of one block, in bytes from a 1024-aligned base. Every
// box (16 columns x 128 rows = 4096 bytes) starts on a multiple of 4096.
template <int HD>
struct Layout {
  static constexpr int q_bytes = BM * HD * 2;
  static constexpr int kv_bytes = BN * HD * 2;  // one K or V tile
  static constexpr int q = 0;
  static constexpr int k = q + q_bytes;
  static constexpr int v = k + STAGES * kv_bytes;
  static constexpr int bars = v + STAGES * kv_bytes;  // 8 bytes each
  // bar_q, full_k[STAGES], full_v[STAGES], empty[STAGES]; 1024 of slack
  // to align the base
  static constexpr int bytes = bars + 8 * (1 + 3 * STAGES) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, bool EMPTY>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const Params p) {
  using L = Layout<HD>;
  constexpr int STEPS = HD / ATOM;  // k16 steps of Q K^T, boxes a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::q, sk = base + L::k, sv = base + L::v;
  const uint32_t bar_q = base + L::bars;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

  const int n_qt = (p.Sq + BM - 1) / BM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // long first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kh = h / p.n_rep;
  const int q0 = qt * BM;

  // the kv tiles any row of this block can see
  const int q_last = min(q0 + BM, p.Sq) - 1;
  const int kv_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kv_hi = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int t_lo = kv_lo / BN;
  const int t_hi = (kv_hi + BN - 1) / BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    regs_dec<PRODUCER_REGS>();
    if (tid == 2 * 128) {
      mbar_arrive_expect_tx(bar_q, L::q_bytes);
      for (int j = 0; j < STEPS; ++j)
        tma_load_4d(sq + j * BM * ROW_BYTES, &tq, bar_q, j * ATOM, q0, h, b);
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int s = i % STAGES;
        const uint32_t phase = (i / STAGES) & 1;
        mbar_wait(empty(s), phase ^ 1);  // the first round passes at once
        const uint32_t k_dst = sk + s * L::kv_bytes;
        const uint32_t v_dst = sv + s * L::kv_bytes;
        mbar_arrive_expect_tx(full_k(s), L::kv_bytes);
        for (int j = 0; j < STEPS; ++j)
          tma_load_4d(k_dst + j * BN * ROW_BYTES, &tk, full_k(s), j * ATOM,
                      t * BN, kh, b);
        mbar_arrive_expect_tx(full_v(s), L::kv_bytes);
        for (int j = 0; j < STEPS; ++j)
          tma_load_4d(v_dst + j * BN * ROW_BYTES, &tv, full_v(s), j * ATOM,
                      t * BN, kh, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_inc<CONSUMER_REGS>();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = q0 + 64 * wg;                    // first row of this WG
    const int row = r0 + 16 * warp + lane / 4;      // rows row, row + 8
    const int col = 2 * (lane % 4);  // first of two columns per 8-col group

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    // Q rows of this warpgroup: box j at sq + j * BM * 32, row r at r * 32;
    // K-major, 8-row groups 256 bytes apart
    const uint32_t q_rows = sq + 64 * wg * ROW_BYTES;
    mbar_wait(bar_q, 0);

    for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
      const int s = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      const int k0 = t * BN;
      const uint32_t k_tile = sk + s * L::kv_bytes;
      const uint32_t v_tile = sv + s * L::kv_bytes;

      // S = Q K^T (the K tile is K-major too: keys are its rows); the
      // first step overwrites sc (scale_d = 0), so it needs no zeroing
      float sc[BN / 2];
      mbar_wait(full_k(s), phase);
      keep(sc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < STEPS; ++j)
        wgmma_m64n128k16_ss(
            sc, desc_sw32(q_rows + j * BM * ROW_BYTES, 16, 8 * ROW_BYTES),
            desc_sw32(k_tile + j * BN * ROW_BYTES, 16, 8 * ROW_BYTES), j);
      wgmma_commit();
      wgmma_wait<0>();
      keep(sc);

      // scale into log2 units; mask only tiles that cross the diagonal,
      // the window's edge or the end of Sk (uniform over the warpgroup)
      const bool masked = k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > r0) ||
                          (p.window > 0 && r0 + 63 - k0 >= p.window);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        float x = sc[e] * p.scale_log2;
        if (masked) {
          const int qpos = row + 8 * ((e >> 1) & 1);
          const int kpos = k0 + 8 * (e >> 2) + col + (e & 1);
          const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos) &&
                          (p.window <= 0 || qpos - kpos < p.window);
          x = ok ? x : -INFINITY;
        }
        sc[e] = x;
      }

      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int e = 2 * r; e < BN / 2; e += 4)
          mx = fmaxf(mx, fmaxf(sc[e], sc[e + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no inf - inf
        alpha[r] = ex2(m[r] - mu[r]);
        m[r] = m_new;
      }

      // P, split into two bf16 A fragments: 16-key slice c is
      // sc[8c .. 8c+7], fragment register f = sc[8c + 2f], sc[8c + 2f + 1]
      uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int e = 8 * c + 2 * f, r = f & 1;
          const float p0 = ex2(sc[e] - mu[r]);
          const float p1 = ex2(sc[e + 1] - mu[r]);
          rs[r] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[c][f] = bf16x2_bits(hi);
          p_lo[c][f] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x,
                                                         p1 - hf.y));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

      // O += P_hi V + P_lo V. The V tile read MN-major: 16 head columns
      // per box (boxes BN * 32 bytes apart: LBO), 8-key groups 256 bytes
      // apart (SBO), key slice c at c * 16 rows.
      mbar_wait(full_v(s), phase);
      keep(o);
      keep(p_hi);
      keep(p_lo);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c)
        wgmma_rs<HD>(o, p_hi[c],
                     desc_sw32(v_tile + c * 16 * ROW_BYTES, BN * ROW_BYTES,
                               8 * ROW_BYTES));
#pragma unroll
      for (int c = 0; c < BN / 16; ++c)
        wgmma_rs<HD>(o, p_lo[c],
                     desc_sw32(v_tile + c * 16 * ROW_BYTES, BN * ROW_BYTES,
                               8 * ROW_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
      keep(o);
      keep(p_hi);
      keep(p_lo);
      mbar_arrive(empty(s));
    }

    if constexpr (EMPTY) {
      // A row whose l is 0 saw no key: its O becomes V's column sums over
      // all Sk keys and its l the padded key range's length (a quarter on
      // each lane of its quad, exact), which the epilogue divides by.
      // Lanes lane % 4 apart hold the same two columns of each 8-column
      // group: each takes every 8th key, then shuffles add them up.
      bool empty[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        empty[r] = row + 8 * r < p.Sq && sum == 0.f;
      }
      if (__any_sync(0xffffffffu, empty[0] || empty[1])) {
        const __nv_bfloat16* vg = p.v + b * p.v_sb + kh * p.v_sh;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          float sx = 0.f, sy = 0.f;
          for (int k = lane / 4; k < p.Sk; k += 8) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(vg + k * p.v_ss +
                                                         8 * j + col));
            sx += x.x;
            sy += x.y;
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            sx += __shfl_xor_sync(0xffffffffu, sx, off);
            sy += __shfl_xor_sync(0xffffffffu, sy, off);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (empty[r]) {
              o[4 * j + 2 * r] = sx;
              o[4 * j + 2 * r + 1] = sy;
            }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (empty[r]) l[r] = 0.25f * p.empty_den;
    }

    // epilogue: the quad's shares of each row sum, then O / l
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                        h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float den = fmaxf(sum, 1e-30f);
      const int qpos = row + 8 * r;
      if (qpos >= p.Sq) continue;
      __nv_bfloat16* orow = og + qpos * p.o_ss;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int e = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) =
            __floats2bfloat162_rn(o[e] / den, o[e + 1] / den);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (hd, S, heads, B) map over a bf16 tensor with element strides
// (ss, sh, sb) along S, heads and B; boxes of 16 columns x `rows` rows,
// 32-byte swizzle, zeros outside the tensor.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd,
              int S, int heads, int B, long long ss, long long sh,
              long long sb, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {ATOM, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool EMPTY>
cudaError_t launch_variant(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, const Params& p, int BH,
                           cudaStream_t stream) {
  constexpr int bytes = Layout<HD>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD, EMPTY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, BH);
  flash_tc_kernel<HD, EMPTY><<<grid, THREADS, bytes, stream>>>(tq, tk, tv,
                                                               p);
  return cudaGetLastError();
}

// The variant with the empty-row step only where a row can see no
// key (windowed, Sq - Sk >= window): every other call runs the kernel
// without it.
template <int HD>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int BH,
                   cudaStream_t stream) {
  if (p.window > 0 && p.Sq - p.Sk >= p.window)
    return launch_variant<HD, true>(tq, tk, tv, p, BH, stream);
  return launch_variant<HD, false>(tq, tk, tv, p, BH, stream);
}

int smem_bytes(int hd) {
  switch (hd) {
    case 32: return Layout<32>::bytes;
    case 64: return Layout<64>::bytes;
    case 80: return Layout<80>::bytes;
    case 96: return Layout<96>::bytes;
    case 128: return Layout<128>::bytes;
    default: return 0;
  }
}

}  // namespace

// Launches forward attention on `stream`. q: (B, Sq, H, hd); k, v:
// (B, Sk, H / n_rep, hd); o: (B, Sq, H, hd); all bf16 with unit head_dim
// stride, hd in {32, 64, 80, 96, 128}, q, k and v 16-byte aligned with
// (batch, seq, head) strides in multiples of 8 elements. `strides` holds
// 12 element strides: (batch, seq, head) of q, k, v and o in that order.
// window <= 0 means no window; `scale` is hd^-0.5. Returns the launch's
// cudaError_t (0 on success); a tensor map cuTensorMapEncodeTiled refuses
// returns cudaErrorInvalidValue. Does not synchronise and allocates
// nothing.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* strides, int B,
                                         int H, int n_rep, int Sq, int Sk,
                                         int hd, int causal, int window,
                                         float scale,
                                         void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || n_rep <= 0 || H % n_rep != 0 || smem_bytes(hd) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int KH = H / n_rep;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, hd, Sq, H, B, strides[1], strides[2], strides[0],
                BM) ||
      !make_map(enc, &tk, k, hd, Sk, KH, B, strides[4], strides[5],
                strides[3], BN) ||
      !make_map(enc, &tv, v, hd, Sk, KH, B, strides[7], strides[8],
                strides[6], BN))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = o;
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.H = H;
  p.n_rep = n_rep;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  const int block_kv = Sk < 8 ? 8 : (Sk < 128 ? Sk : 128);
  p.empty_den =
      static_cast<float>(Sk + (block_kv - Sk % block_kv) % block_kv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 32: err = launch<32>(tq, tk, tv, p, B * H, s); break;
    case 64: err = launch<64>(tq, tk, tv, p, B * H, s); break;
    case 80: err = launch<80>(tq, tk, tv, p, B * H, s); break;
    case 96: err = launch<96>(tq, tk, tv, p, B * H, s); break;
    default: err = launch<128>(tq, tk, tv, p, B * H, s); break;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory a block of the kernel uses at head dim `hd`
// (0 for a width it does not take).
extern "C" int flash_attention_tc_smem_bytes(int hd) { return smem_bytes(hd); }

extern "C" const char* flash_attention_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
