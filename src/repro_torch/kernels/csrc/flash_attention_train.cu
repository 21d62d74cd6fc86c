// Training attention on Hopper's tensor cores (sm_90a): the forward that
// also writes the log-sum-exp, and the flash backward that recomputes the
// probabilities from it. bf16 q, k, v on the model's (B, S, H, hd) layout
// with grouped-query KV heads, hd in {32, 64, 80, 96, 128}, any positions.
//
// Replaces no TPU kernel: the reference's training attention
// (`flash_jnp` and its custom_vjp in src/repro/models/layers.py) is plain
// jnp. It was added because the port's plain version of that algorithm
// (`_flash_fwd_impl` / `_flash_bwd_impl` in models/layers.py) runs each
// block pair through a dozen fp32 elementwise passes over 512 x 1024
// scores and copies the block pairs to the host once a layer: most of a
// training step's device time. The wrapper (kernels/flash_attention_train.py)
// sends here what the dispatch rule takes; everything else keeps the plain
// version.
//
// What is computed, per (batch b, query head h, query q, key k), KV head
// h / n_rep, positions qp = q_pos[b, q], kp = k_pos[b, k]:
//
//     valid  = qp >= 0 & kp < 2^29 & (!causal | kp <= qp)
//              & (!window | qp - kp < window)
//     s      = (q . k) * hd^-0.5                    (fp32 sum of exact
//                                                    bf16 products)
//     lse[q] = log sum_k exp(s)          out[q] = sum_k P[q, k] v[k]
//     P      = exp(s - lse)              rounded to bf16 once before P.V,
//                                        as the plain version rounds it
// and the backward, at the plain version's rounding points:
//     delta[q] = sum_d dO[q, d] O[q, d]                  (fp32)
//     dV      += bf16(P)^T dO            dP = dO V^T
//     dS       = bf16((dP - delta) * P * hd^-0.5)
//     dK      += dS^T Q                  dQ += dS K      (fp32 sums)
// A row with no valid key gets out 0 and lse -inf (the plain version's is
// undefined there); its gradients are 0.
//
// Bound: operations. Per valid (q, k) pair of a head the forward needs 4
// hd flops and the backward 8 hd (h2o's training layer, B=2 x 4096, 32
// heads of 80, causal: 0.174 ms and 0.347 ms at 989 TFLOP/s). The kernels
// issue 2 products a visited tile pair forward and 7 backward (dQ's pass
// recomputes S and dP), plus the masked parts of the tiles on a band's
// edge.
//
// Design.
// * Block pairs on the device. A small kernel ahead of the forward makes
//   a (ceil(Sq/64), ceil(Sk/128)) table of pair kinds (SKIP: no entry of
//   the pair is valid for any batch row; FULL: every entry is; PARTIAL
//   otherwise) from each tile's range of positions, one thread a pair.
//   Every kernel reads it: SKIP pairs are not loaded, FULL pairs are not
//   masked, and PARTIAL pairs are masked element by element from q_pos
//   and k_pos. No copy to the host, any positions.
// * Forward: K2's tensor-core design (flash_attention_tc.cu) with two
//   departures: it writes lse (fp32, (B, H, Sq rounded up to 64)), and
//   rounds P to bf16 once before P.V instead of splitting it into two
//   terms. One block per (batch * head, 128-row q tile), the longest
//   tiles first over the whole grid: warpgroups 0 and 1 own 64 query rows
//   each (one row of the pair table each), a ninth warp issues TMA copies
//   through 4-D tensor maps on the caller's strides (the KV head is a
//   coordinate: no repeat, no copy); K/V ring of 2 stages; wgmma
//   m64n128k16 for S, m64nHDk16 for P.V with P from registers; softmax in
//   registers with exp2. 288 threads a block, no setmaxnreg: ptxas gave
//   168 registers a thread and spilled alike with K2's 384 threads and
//   setmaxnreg 240, so the kernels keep their working set near 168: the
//   dQ pass works in halves of 64 keys, and the dK/dV pass forms P^T and
//   dS^T from S^T and dP^T a pair of elements at a time.
// * Backward, dK and dV: one block per (batch, KV head, 128-key tile),
//   the first key tiles (a causal band's longest) first;
//   warpgroups 0 and 1 own 64 keys each and keep their dK, dV in fp32
//   registers while the block walks the query heads of its KV head and,
//   for each, the 64-row q tiles its keys pair with. Per q tile: S^T = K
//   Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands in shared
//   memory), P^T and dS^T in registers (they are already in the A-fragment
//   layout), dV += P^T dO and dK += dS^T Q (wgmma m64nHDk16, A from
//   registers). Q, dO, lse and delta of a q tile come through a 2-stage
//   ring (TMA for Q and dO, bulk copies for lse and delta). The sum over
//   a KV head's query heads is taken in fp32 inside the block, more
//   exact than the plain version's head-by-head bf16 sum.
// * Backward, dQ: a second pass, one block per (batch * head, 128-row q
//   tile) as the forward: S = Q K^T and dP = dO V^T recomputed, dQ += dS
//   K, each 128-key tile in two halves of 64 (wgmma m64n64k16) so that S
//   and dP fit in the registers beside dQ. Deterministic (no atomics):
//   every gradient is summed in one order on every run.
// * delta = rowsum(dO * O) in fp32: a small kernel, one thread a row.
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

constexpr int BM = 128;         // query rows of a forward or dQ block
constexpr int BN = 128;         // keys of a kv tile (a pair-table column)
constexpr int TQ = 64;          // query rows of a pair-table row
constexpr int STAGES = 2;       // ring depth (3 measured no faster)
// consumer warpgroups 0, 1 and one producer warp
constexpr int THREADS = 288;
constexpr int ATOM = 16;        // bf16 columns of one 32-byte swizzle row
constexpr int ROW_BYTES = 32;   // bytes of one row of a box
constexpr int CONSUMERS = 256;  // threads that arrive on an empty barrier
constexpr int SKIP = 0, FULL = 2;  // pair kinds (PARTIAL = 1)
constexpr long long Q_PAD = -1, K_PAD = 1ll << 30;  // positions past S
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

struct Masks {
  const long long* q_pos;  // (B, Sq), unit stride along Sq
  const long long* k_pos;  // (B, Sk), unit stride along Sk
  long long qp_sb, kp_sb;  // batch strides (0 when shared)
  const uint8_t* kinds;    // (n_qt, n_kt) pair kinds, row-major
  int n_qt, n_kt;
  int causal;
  long long window;  // <= 0: none
};

__device__ __forceinline__ bool valid(const Masks& m, long long qp,
                                      long long kp) {
  return qp >= 0 && kp < (1ll << 29) && (!m.causal || kp <= qp) &&
         (m.window <= 0 || qp - kp < m.window);
}

__device__ __forceinline__ int kind_of(const Masks& m, int qi, int t) {
  return qi < m.n_qt ? m.kinds[qi * m.n_kt + t] : SKIP;
}

__device__ __forceinline__ long long q_position(const Masks& m, int b, int q,
                                                int Sq) {
  return q < Sq ? __ldg(m.q_pos + b * m.qp_sb + q) : Q_PAD;
}

__device__ __forceinline__ long long k_position(const Masks& m, int b, int k,
                                                int Sk) {
  return k < Sk ? __ldg(m.k_pos + b * m.kp_sb + k) : K_PAD;
}

struct Params {
  Masks m;
  int H, n_rep, Sq, Sk, Sq_pad;
  float scale, scale_log2;  // hd^-0.5 and hd^-0.5 * log2(e)
  // forward: o, lse written; backward: o read by delta, the rest written
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;
  float* lse;    // (B, H, Sq_pad)
  float* delta;  // (B, H, Sq_pad)
  const __nv_bfloat16* dout;
  long long d_sb, d_ss, d_sh;
  __nv_bfloat16 *dq, *dk, *dv;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows r, r + 8 of a warpgroup's 64 x N fp32 accumulator, as bf16 pairs
// into row-major global rows (those at or past `rows` not stored).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2],
                                           __nv_bfloat16* base, int row,
                                           int rows, long long row_stride,
                                           int col, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= rows) continue;
    __nv_bfloat16* out = base + (row + 8 * r) * row_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int e = 4 * j + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col) =
          __floats2bfloat162_rn(acc[e] * mul, acc[e + 1] * mul);
    }
  }
}

// -------------------------------------------------------------- pairs

// The pair table from the positions, one thread a (64-row q tile,
// 128-key tile) pair, each tile's range of positions taken over the batch
// rows: the rule of the plain version's table (layers._block_pairs). The
// positions past Sq and Sk count as padding (-1 and 2^30).
__global__ void kinds_kernel(const Params p, int B, uint8_t* kinds) {
  const Masks& m = p.m;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m.n_qt * m.n_kt) return;
  const int qi = idx / m.n_kt, t = idx % m.n_kt;
  constexpr long long big = 1ll << 40;
  long long qmin = big, qmax = Q_PAD, kmin = big, kmax = -big;
  bool qall = true, kall = true;
  for (int b = 0; b < B; ++b) {
    for (int r = 0; r < TQ; ++r) {
      const long long qp = q_position(m, b, qi * TQ + r, p.Sq);
      qmax = max(qmax, qp);
      if (qp >= 0) qmin = min(qmin, qp);
      else qall = false;
    }
    for (int c = 0; c < BN; ++c) {
      const long long kp = k_position(m, b, t * BN + c, p.Sk);
      kmin = min(kmin, kp);
      if (kp < (1ll << 29)) kmax = max(kmax, kp);
      else kall = false;
    }
  }
  const bool some = qmax >= 0 && kmin < (1ll << 29) &&
                    (!m.causal || kmin <= qmax) &&
                    (m.window <= 0 || qmin - kmax < m.window);
  const bool every = qall && kall && (!m.causal || qmin >= kmax) &&
                     (m.window <= 0 || qmax - kmin < m.window);
  kinds[idx] = every ? FULL : some ? 1 : SKIP;
}

// ------------------------------------------------------------- forward

// Shared memory of a forward block, in bytes from a 1024-aligned base.
template <int HD>
struct FwdLayout {
  static constexpr int q_bytes = BM * HD * 2;
  static constexpr int kv_bytes = BN * HD * 2;
  static constexpr int q = 0;
  static constexpr int k = q + q_bytes;
  static constexpr int v = k + STAGES * kv_bytes;
  static constexpr int bars = v + STAGES * kv_bytes;
  // bar_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int bytes = bars + 8 * (1 + 3 * STAGES) + 1024;
};

// Whether a 128-row block (pair-table rows 2 qt, 2 qt + 1) visits kv tile t.
__device__ __forceinline__ bool visits(const Masks& m, int qt, int t) {
  return kind_of(m, 2 * qt, t) != SKIP || kind_of(m, 2 * qt + 1, t) != SKIP;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = FwdLayout<HD>;
  constexpr int STEPS = HD / ATOM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::q, sk = base + L::k, sv = base + L::v;
  const uint32_t bar_q = base + L::bars;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

  const Masks& m = p.m;
  const int n_blocks = (p.Sq + BM - 1) / BM;
  const int qt = n_blocks - 1 - static_cast<int>(blockIdx.y);  // long first
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kh = h / p.n_rep;
  const int q0 = qt * BM;

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
    if (tid == CONSUMERS) {
      mbar_arrive_expect_tx(bar_q, L::q_bytes);
      for (int j = 0; j < STEPS; ++j)
        tma_load_4d(sq + j * BM * ROW_BYTES, &tq, bar_q, j * ATOM, q0, h, b);
      for (int t = 0, i = 0; t < m.n_kt; ++t) {
        if (!visits(m, qt, t)) continue;
        const int s = i % STAGES;
        const uint32_t phase = (i / STAGES) & 1;
        ++i;
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
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int qi = 2 * qt + wg;                     // this WG's table row
    const int row = q0 + 64 * wg + 16 * warp + lane / 4;  // rows row, +8
    const int col = 2 * (lane % 4);  // first of two columns per 8-col group
    long long qp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) qp[r] = q_position(m, b, row + 8 * r, p.Sq);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float mx_run[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    const uint32_t q_rows = sq + 64 * wg * ROW_BYTES;
    mbar_wait(bar_q, 0);

    for (int t = 0, i = 0; t < m.n_kt; ++t) {
      if (!visits(m, qt, t)) continue;
      const int s = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      ++i;
      const int k0 = t * BN;
      const uint32_t k_tile = sk + s * L::kv_bytes;
      const uint32_t v_tile = sv + s * L::kv_bytes;

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

      // scale into log2 units; mask element by element unless the pair
      // is FULL (uniform over the warpgroup)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sc[e] *= p.scale_log2;
      if (kind_of(m, qi, t) != FULL) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const long long kp = k_position(m, b, k0 + 8 * j + col + c, p.Sk);
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (!valid(m, qp[r], kp)) sc[4 * j + 2 * r + c] = -INFINITY;
          }
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
        const float m_new = fmaxf(mx_run[r], mx);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no inf - inf
        alpha[r] = ex2(mx_run[r] - mu[r]);
        mx_run[r] = m_new;
      }

      // P as bf16 A fragments: 16-key slice c is sc[8c .. 8c+7], fragment
      // register f = sc[8c + 2f], sc[8c + 2f + 1]; the row sums take P in
      // fp32, as the plain version's do
      uint32_t pf[BN / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int e = 8 * c + 2 * f, r = f & 1;
          const float p0 = ex2(sc[e] - mu[r]);
          const float p1 = ex2(sc[e + 1] - mu[r]);
          rs[r] += p0 + p1;
          pf[c][f] = bf16x2_bits(p0, p1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

      // O += P V, the V tile read MN-major (16 head columns a box, boxes
      // BN * 32 bytes apart; 8-key groups 256 bytes apart)
      mbar_wait(full_v(s), phase);
      keep(o);
      keep(pf);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c)
        wgmma_rs<HD>(o, pf[c],
                     desc_sw32(v_tile + c * 16 * ROW_BYTES, BN * ROW_BYTES,
                               8 * ROW_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
      keep(o);
      keep(pf);
      mbar_arrive(empty(s));
    }

    // epilogue: the quad's shares of each row sum, lse, then O / l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = sum;
      const int q = row + 8 * r;
      if (lane % 4 == 0 && q < p.Sq_pad)
        p.lse[static_cast<long long>(bh) * p.Sq_pad + q] =
            sum > 0.f ? (mx_run[r] + log2f(sum)) * LN2 : -INFINITY;
    }
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float den = fmaxf(l[r], 1e-30f);
      const int q = row + 8 * r;
      if (q >= p.Sq) continue;
      __nv_bfloat16* orow = og + q * p.o_ss;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int e = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) =
            __floats2bfloat162_rn(o[e] / den, o[e + 1] / den);
      }
    }
  }
}

// --------------------------------------------------------------- delta

// delta[b, h, q] = sum_d dO[b, q, h, d] O[b, q, h, d] in fp32, 0 for the
// padded rows q >= Sq. One thread a row, heads fastest (neighbouring
// threads read neighbouring rows of memory), 16-byte loads.
template <int HD>
__global__ void delta_kernel(const Params p, int B) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * p.Sq_pad * p.H) return;
  const int h = static_cast<int>(idx % p.H);
  const long long rest = idx / p.H;
  const int q = static_cast<int>(rest % p.Sq_pad);
  const int b = static_cast<int>(rest / p.Sq_pad);
  float sum = 0.f;
  if (q < p.Sq) {
    const uint4* o4 =
        reinterpret_cast<const uint4*>(p.o + b * p.o_sb + q * p.o_ss +
                                       h * p.o_sh);
    const uint4* d4 =
        reinterpret_cast<const uint4*>(p.dout + b * p.d_sb + q * p.d_ss +
                                       h * p.d_sh);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const uint4 a = o4[j], c = d4[j];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 x = __bfloat1622float2(a2[u]);
        const float2 y = __bfloat1622float2(c2[u]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
  }
  p.delta[(static_cast<long long>(b) * p.H + h) * p.Sq_pad + q] = sum;
}

// ---------------------------------------------------------- dK and dV

template <int HD>
struct KvLayout {
  static constexpr int kv_bytes = BN * HD * 2;  // the block's K or V tile
  static constexpr int q_bytes = TQ * HD * 2;   // one Q or dO tile
  static constexpr int k = 0;
  static constexpr int v = k + kv_bytes;
  static constexpr int q = v + kv_bytes;          // Q ring
  static constexpr int d = q + STAGES * q_bytes;  // dO ring
  static constexpr int lse = d + STAGES * q_bytes;     // TQ fp32 a stage
  static constexpr int delta = lse + STAGES * TQ * 4;  // TQ fp32 a stage
  static constexpr int bars = delta + STAGES * TQ * 4;
  // bar_kv, full[STAGES], empty[STAGES]
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap td, const Params p) {
  using L = KvLayout<HD>;
  constexpr int STEPS = HD / ATOM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);  // generic pointer to base
  const uint32_t sk = base + L::k, sv = base + L::v;
  const uint32_t bar_kv = base + L::bars;
  auto full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };

  const Masks& m = p.m;
  const int t = blockIdx.y;  // causal: the first key tiles have most work
  const int KH = p.H / p.n_rep;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int k0 = t * BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    if (tid == CONSUMERS) {
      mbar_arrive_expect_tx(bar_kv, 2 * L::kv_bytes);
      for (int j = 0; j < STEPS; ++j)
        tma_load_4d(sk + j * BN * ROW_BYTES, &tk, bar_kv, j * ATOM, k0, kh,
                    b);
      for (int j = 0; j < STEPS; ++j)
        tma_load_4d(sv + j * BN * ROW_BYTES, &tv, bar_kv, j * ATOM, k0, kh,
                    b);
      int i = 0;
      for (int r = 0; r < p.n_rep; ++r) {
        const int h = kh * p.n_rep + r;
        const long long row0 = (static_cast<long long>(b) * p.H + h) *
                               p.Sq_pad;
        for (int qi = 0; qi < m.n_qt; ++qi) {
          if (kind_of(m, qi, t) == SKIP) continue;
          const int s = i % STAGES;
          const uint32_t phase = (i / STAGES) & 1;
          ++i;
          mbar_wait(empty(s), phase ^ 1);
          mbar_arrive_expect_tx(full(s), 2 * L::q_bytes + 2 * TQ * 4);
          const uint32_t q_dst = base + L::q + s * L::q_bytes;
          const uint32_t d_dst = base + L::d + s * L::q_bytes;
          for (int j = 0; j < STEPS; ++j)
            tma_load_4d(q_dst + j * TQ * ROW_BYTES, &tq, full(s), j * ATOM,
                        qi * TQ, h, b);
          for (int j = 0; j < STEPS; ++j)
            tma_load_4d(d_dst + j * TQ * ROW_BYTES, &td, full(s), j * ATOM,
                        qi * TQ, h, b);
          bulk_load(base + L::lse + s * TQ * 4, p.lse + row0 + qi * TQ,
                    TQ * 4, full(s));
          bulk_load(base + L::delta + s * TQ * 4, p.delta + row0 + qi * TQ,
                    TQ * 4, full(s));
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int krow = k0 + 64 * wg + 16 * warp + lane / 4;  // keys krow, +8
    const int col = 2 * (lane % 4);
    long long kp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) kp[r] = k_position(m, b, krow + 8 * r, p.Sk);

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dk[e] = dv[e] = 0.f;
    const uint32_t k_rows = sk + 64 * wg * ROW_BYTES;
    const uint32_t v_rows = sv + 64 * wg * ROW_BYTES;
    mbar_wait(bar_kv, 0);

    int i = 0;
    for (int r = 0; r < p.n_rep; ++r) {
      for (int qi = 0; qi < m.n_qt; ++qi) {
        const int kind = kind_of(m, qi, t);
        if (kind == SKIP) continue;
        const int s = i % STAGES;
        const uint32_t phase = (i / STAGES) & 1;
        ++i;
        const uint32_t q_tile = base + L::q + s * L::q_bytes;
        const uint32_t d_tile = base + L::d + s * L::q_bytes;
        const float* lse_s =
            reinterpret_cast<const float*>(gbase + L::lse + s * TQ * 4);
        const float* delta_s =
            reinterpret_cast<const float*>(gbase + L::delta + s * TQ * 4);

        // S^T = K Q^T and dP^T = V dO^T (keys are rows, queries columns)
        float st[TQ / 2], dpt[TQ / 2];
        mbar_wait(full(s), phase);
        keep(st);
        keep(dpt);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < STEPS; ++j)
          wgmma_m64n64k16_ss(
              st, desc_sw32(k_rows + j * BN * ROW_BYTES, 16, 8 * ROW_BYTES),
              desc_sw32(q_tile + j * TQ * ROW_BYTES, 16, 8 * ROW_BYTES), j);
#pragma unroll
        for (int j = 0; j < STEPS; ++j)
          wgmma_m64n64k16_ss(
              dpt, desc_sw32(v_rows + j * BN * ROW_BYTES, 16, 8 * ROW_BYTES),
              desc_sw32(d_tile + j * TQ * ROW_BYTES, 16, 8 * ROW_BYTES), j);
        wgmma_commit();
        wgmma_wait<0>();
        keep(st);
        keep(dpt);

        // P^T and dS^T as bf16 A fragments: 16-query slice c is elements
        // 8c .. 8c+7; element e holds key row krow + 8 ((e >> 1) & 1) and
        // query column 8 (e >> 2) + col + (e & 1). Each pair of elements
        // goes from st and dpt to the fragments at once, which keeps the
        // registers in use under ptxas's 168 (forming P^T while dP^T is
        // still in the tensor cores measured slower: more spills).
        uint32_t pf[TQ / 16][4], dsf[TQ / 16][4];
        const bool masked = kind != FULL;
#pragma unroll
        for (int c = 0; c < TQ / 16; ++c) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int e = 8 * c + 2 * f, hr = f & 1;
            const int qc = 8 * (e >> 2) + col;
            float pv[2], dsv[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float pe = ex2(fmaf(st[e + u], p.scale_log2,
                                  -lse_s[qc + u] * LOG2E));
              if (masked &&
                  !valid(m, q_position(m, b, qi * TQ + qc + u, p.Sq),
                         kp[hr]))
                pe = 0.f;
              pv[u] = pe;
              dsv[u] = (dpt[e + u] - delta_s[qc + u]) * pe * p.scale;
            }
            pf[c][f] = bf16x2_bits(pv[0], pv[1]);
            dsf[c][f] = bf16x2_bits(dsv[0], dsv[1]);
          }
        }

        // dV += P^T dO and dK += dS^T Q: the dO and Q tiles read MN-major
        // (boxes TQ * 32 bytes apart)
        keep(dv);
        keep(dk);
        keep(pf);
        keep(dsf);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < TQ / 16; ++c)
          wgmma_rs<HD>(dv, pf[c],
                       desc_sw32(d_tile + c * 16 * ROW_BYTES, TQ * ROW_BYTES,
                                 8 * ROW_BYTES));
#pragma unroll
        for (int c = 0; c < TQ / 16; ++c)
          wgmma_rs<HD>(dk, dsf[c],
                       desc_sw32(q_tile + c * 16 * ROW_BYTES, TQ * ROW_BYTES,
                                 8 * ROW_BYTES));
        wgmma_commit();
        wgmma_wait<0>();
        keep(dv);
        keep(dk);
        keep(pf);
        keep(dsf);
        mbar_arrive(empty(s));
      }
    }

    store_rows<HD>(dk, p.dk + b * p.dk_sb + kh * p.dk_sh, krow, p.Sk,
                   p.dk_ss, col, 1.f);
    store_rows<HD>(dv, p.dv + b * p.dv_sb + kh * p.dv_sh, krow, p.Sk,
                   p.dv_ss, col, 1.f);
  }
}

// ------------------------------------------------------------------ dQ

template <int HD>
struct QLayout {
  static constexpr int q_bytes = BM * HD * 2;
  static constexpr int kv_bytes = BN * HD * 2;
  static constexpr int q = 0;
  static constexpr int d = q + q_bytes;
  static constexpr int k = d + q_bytes;
  static constexpr int v = k + STAGES * kv_bytes;
  static constexpr int bars = v + STAGES * kv_bytes;
  // bar_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int bytes = bars + 8 * (1 + 3 * STAGES) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap td,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = QLayout<HD>;
  constexpr int STEPS = HD / ATOM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::q, sd = base + L::d;
  const uint32_t sk = base + L::k, sv = base + L::v;
  const uint32_t bar_q = base + L::bars;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

  const Masks& m = p.m;
  const int n_blocks = (p.Sq + BM - 1) / BM;
  const int qt = n_blocks - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kh = h / p.n_rep;
  const int q0 = qt * BM;

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
    if (tid == CONSUMERS) {
      mbar_arrive_expect_tx(bar_q, 2 * L::q_bytes);
      for (int j = 0; j < STEPS; ++j)
        tma_load_4d(sq + j * BM * ROW_BYTES, &tq, bar_q, j * ATOM, q0, h, b);
      for (int j = 0; j < STEPS; ++j)
        tma_load_4d(sd + j * BM * ROW_BYTES, &td, bar_q, j * ATOM, q0, h, b);
      for (int t = 0, i = 0; t < m.n_kt; ++t) {
        if (!visits(m, qt, t)) continue;
        const int s = i % STAGES;
        const uint32_t phase = (i / STAGES) & 1;
        ++i;
        mbar_wait(empty(s), phase ^ 1);
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
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int qi = 2 * qt + wg;
    const int row = q0 + 64 * wg + 16 * warp + lane / 4;
    const int col = 2 * (lane % 4);
    long long qp[2];
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row + 8 * r;
      qp[r] = q_position(m, b, q, p.Sq);
      const long long at = static_cast<long long>(bh) * p.Sq_pad + q;
      lse2[r] = q < p.Sq ? p.lse[at] * LOG2E : 0.f;
      dl[r] = q < p.Sq ? p.delta[at] : 0.f;
    }

    float dq[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dq[e] = 0.f;
    const uint32_t q_rows = sq + 64 * wg * ROW_BYTES;
    const uint32_t d_rows = sd + 64 * wg * ROW_BYTES;
    mbar_wait(bar_q, 0);

    for (int t = 0, i = 0; t < m.n_kt; ++t) {
      if (!visits(m, qt, t)) continue;
      const int s = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      ++i;
      const int k0 = t * BN;
      const uint32_t k_tile = sk + s * L::kv_bytes;
      const uint32_t v_tile = sv + s * L::kv_bytes;

      // the tile in two halves of 64 keys: S and dP of a half, 32
      // accumulators each, beside dQ's in the registers
      mbar_wait(full_k(s), phase);
      mbar_wait(full_v(s), phase);
      const bool masked = kind_of(m, qi, t) != FULL;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const uint32_t kh0 = half * 64 * ROW_BYTES;  // the half's first row
        float sc[32], dp[32];
        keep(sc);
        keep(dp);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < STEPS; ++j)
          wgmma_m64n64k16_ss(
              sc, desc_sw32(q_rows + j * BM * ROW_BYTES, 16, 8 * ROW_BYTES),
              desc_sw32(k_tile + j * BN * ROW_BYTES + kh0, 16,
                        8 * ROW_BYTES),
              j);
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < STEPS; ++j)
          wgmma_m64n64k16_ss(
              dp, desc_sw32(d_rows + j * BM * ROW_BYTES, 16, 8 * ROW_BYTES),
              desc_sw32(v_tile + j * BN * ROW_BYTES + kh0, 16,
                        8 * ROW_BYTES),
              j);
        wgmma_commit();
        wgmma_wait<1>();
        keep(sc);

        // P in place while dP is still in the tensor cores (element e:
        // row row + 8 ((e >> 1) & 1), key k0 + 64 half + 8 (e >> 2) + col
        // + (e & 1)), then dS as bf16 A fragments
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = (e >> 1) & 1;
          float pe = ex2(fmaf(sc[e], p.scale_log2, -lse2[r]));
          if (masked &&
              !valid(m, qp[r],
                     k_position(m, b,
                                k0 + 64 * half + 8 * (e >> 2) + col + (e & 1),
                                p.Sk)))
            pe = 0.f;
          sc[e] = pe;
        }
        wgmma_wait<0>();
        keep(dp);
        uint32_t dsf[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int e = 8 * c + 2 * f, r = f & 1;
            dsf[c][f] = bf16x2_bits((dp[e] - dl[r]) * sc[e] * p.scale,
                                    (dp[e + 1] - dl[r]) * sc[e + 1] * p.scale);
          }
        }

        // dQ += dS K, the half's keys of the K tile read MN-major as the
        // forward reads V
        keep(dq);
        keep(dsf);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wgmma_rs<HD>(dq, dsf[c],
                       desc_sw32(k_tile + kh0 + c * 16 * ROW_BYTES,
                                 BN * ROW_BYTES, 8 * ROW_BYTES));
        wgmma_commit();
        wgmma_wait<0>();
        keep(dq);
        keep(dsf);
      }
      mbar_arrive(empty(s));
    }

    store_rows<HD>(dq, p.dq + b * p.dq_sb + h * p.dq_sh, row, p.Sq,
                   p.dq_ss, col, 1.f);
  }
}

// ---------------------------------------------------------------- host

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
              int S, int heads, int B, const long long* st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  // st: (batch, seq, head) element strides
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {ATOM, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int HD>
cudaError_t launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk,
                       const CUtensorMap& tv, const Params& p, int B,
                       uint8_t* kinds, cudaStream_t stream) {
  const int pairs = p.m.n_qt * p.m.n_kt;
  kinds_kernel<<<(pairs + 127) / 128, 128, 0, stream>>>(p, B, kinds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int bytes = FwdLayout<HD>::bytes;
  err = allow_smem(fwd_kernel<HD>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.Sq + BM - 1) / BM);
  fwd_kernel<HD><<<grid, THREADS, bytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const CUtensorMap& tq128, const CUtensorMap& td128,
                       const CUtensorMap& tq64, const CUtensorMap& td64,
                       const CUtensorMap& tk, const CUtensorMap& tv,
                       const Params& p, int B, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * p.Sq_pad * p.H;
  delta_kernel<HD><<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                     stream>>>(p, B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int kv_bytes = KvLayout<HD>::bytes;
  err = allow_smem(dkdv_kernel<HD>, kv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(B * (p.H / p.n_rep), p.m.n_kt);
  dkdv_kernel<HD><<<kv_grid, THREADS, kv_bytes, stream>>>(tk, tv, tq64, td64,
                                                          p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_bytes = QLayout<HD>::bytes;
  err = allow_smem(dq_kernel<HD>, q_bytes);
  if (err != cudaSuccess) return err;
  const dim3 q_grid(B * p.H, (p.Sq + BM - 1) / BM);
  dq_kernel<HD><<<q_grid, THREADS, q_bytes, stream>>>(tq128, td128, tk, tv,
                                                      p);
  return cudaGetLastError();
}

bool takes_hd(int hd) {
  return hd == 32 || hd == 64 || hd == 80 || hd == 96 || hd == 128;
}

Params base_params(int H, int n_rep, int Sq, int Sk, float scale,
                   int causal, long long window, const long long* q_pos,
                   long long qp_sb, const long long* k_pos, long long kp_sb,
                   const uint8_t* kinds) {
  Params p = {};
  p.m.q_pos = q_pos;
  p.m.k_pos = k_pos;
  p.m.qp_sb = qp_sb;
  p.m.kp_sb = kp_sb;
  p.m.kinds = kinds;
  p.m.n_qt = (Sq + TQ - 1) / TQ;
  p.m.n_kt = (Sk + BN - 1) / BN;
  p.m.causal = causal;
  p.m.window = window;
  p.H = H;
  p.n_rep = n_rep;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Sq_pad = p.m.n_qt * TQ;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  return p;
}

}  // namespace

// Launches the pair table's kernel and the forward on `stream`. q: (B, Sq,
// H, hd); k, v: (B, Sk,
// H / n_rep, hd); o: (B, Sq, H, hd); all bf16, unit head_dim stride, hd in
// {32, 64, 80, 96, 128}, 16-byte aligned with (batch, seq, head) strides in
// multiples of 8 elements. `strides` holds 12 element strides: (batch,
// seq, head) of q, k, v and o. lse: fp32 (B, H, Sq_pad), Sq_pad = Sq
// rounded up to 64. q_pos (B, Sq) and k_pos (B, Sk): int64 with unit
// stride along the sequence and batch strides qp_sb, kp_sb. kinds: uint8
// (ceil(Sq / 64), ceil(Sk / 128)), written with the pair kinds the
// backward reads again. window <= 0: none; `scale`
// is hd^-0.5. Returns the launch's cudaError_t (0 on success); a tensor
// map cuTensorMapEncodeTiled refuses returns cudaErrorInvalidValue. Does
// not synchronise and allocates nothing.
extern "C" int attn_train_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* strides, int B, int H, int n_rep, int Sq, int Sk,
    int hd, int causal, long long window, float scale,
    const long long* q_pos, long long qp_sb, const long long* k_pos,
    long long kp_sb, uint8_t* kinds, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || n_rep <= 0 || H % n_rep != 0 || !takes_hd(hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int KH = H / n_rep;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, hd, Sq, H, B, strides, BM) ||
      !make_map(enc, &tk, k, hd, Sk, KH, B, strides + 3, BN) ||
      !make_map(enc, &tv, v, hd, Sk, KH, B, strides + 6, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = base_params(H, n_rep, Sq, Sk, scale, causal, window, q_pos,
                         qp_sb, k_pos, kp_sb, kinds);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.lse = lse;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 32: err = launch_fwd<32>(tq, tk, tv, p, B, kinds, s); break;
    case 64: err = launch_fwd<64>(tq, tk, tv, p, B, kinds, s); break;
    case 80: err = launch_fwd<80>(tq, tk, tv, p, B, kinds, s); break;
    case 96: err = launch_fwd<96>(tq, tk, tv, p, B, kinds, s); break;
    default: err = launch_fwd<128>(tq, tk, tv, p, B, kinds, s); break;
  }
  return static_cast<int>(err);
}

// Launches the backward on `stream`: delta, then dK and dV, then dQ.
// q, k, v, o as the forward took and gave them; dout like o; lse the
// forward's; delta: fp32 scratch of lse's shape; dq like q, dk and dv like
// k, all written. `strides` holds 24 element strides: (batch, seq, head) of
// q, k, v, o, dout, dq, dk and dv. The rest as the forward. Does not
// synchronise and allocates nothing.
extern "C" int attn_train_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, float* lse, float* delta, void* dq, void* dk, void* dv,
    const long long* strides, int B, int H, int n_rep, int Sq, int Sk,
    int hd, int causal, long long window, float scale,
    const long long* q_pos, long long qp_sb, const long long* k_pos,
    long long kp_sb, const uint8_t* kinds, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || n_rep <= 0 || H % n_rep != 0 || !takes_hd(hd))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int KH = H / n_rep;
  CUtensorMap tq128, td128, tq64, td64, tk, tv;
  if (!make_map(enc, &tq128, q, hd, Sq, H, B, strides, BM) ||
      !make_map(enc, &td128, dout, hd, Sq, H, B, strides + 12, BM) ||
      !make_map(enc, &tq64, q, hd, Sq, H, B, strides, TQ) ||
      !make_map(enc, &td64, dout, hd, Sq, H, B, strides + 12, TQ) ||
      !make_map(enc, &tk, k, hd, Sk, KH, B, strides + 3, BN) ||
      !make_map(enc, &tv, v, hd, Sk, KH, B, strides + 6, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = base_params(H, n_rep, Sq, Sk, scale, causal, window, q_pos,
                         qp_sb, k_pos, kp_sb, kinds);
  p.o = static_cast<__nv_bfloat16*>(const_cast<void*>(o));
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.d_sb = strides[12];
  p.d_ss = strides[13];
  p.d_sh = strides[14];
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = strides[15];
  p.dq_ss = strides[16];
  p.dq_sh = strides[17];
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dk_sb = strides[18];
  p.dk_ss = strides[19];
  p.dk_sh = strides[20];
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dv_sb = strides[21];
  p.dv_ss = strides[22];
  p.dv_sh = strides[23];
  p.lse = lse;
  p.delta = delta;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 32:
      err = launch_bwd<32>(tq128, td128, tq64, td64, tk, tv, p, B, s);
      break;
    case 64:
      err = launch_bwd<64>(tq128, td128, tq64, td64, tk, tv, p, B, s);
      break;
    case 80:
      err = launch_bwd<80>(tq128, td128, tq64, td64, tk, tv, p, B, s);
      break;
    case 96:
      err = launch_bwd<96>(tq128, td128, tq64, td64, tk, tv, p, B, s);
      break;
    default:
      err = launch_bwd<128>(tq128, td128, tq64, td64, tk, tv, p, B, s);
      break;
  }
  return static_cast<int>(err);
}

extern "C" const char* attn_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
