// Flash-attention forward for bf16 on Hopper's tensor cores (sm_90a):
// softmax(mask(softcap(q*scale . k^T))) . v with an online softmax, so the
// (S, Skv) logits never reach device memory.
//
// Replaces: src/repro/kernels/flash_attn.py::_flash_kernel (the Pallas TPU
// kernel behind flash_attention_hsd / flash_attention) for bf16 inputs; fp32
// inputs go to csrc/flash_attn.cu. It computes what kernels/ref.py::
// flash_attention_ref computes: per query row i and key j, positions from 0,
//   s_ij = (q_i . k_j) * scale                       (fp32 accumulation)
//   s_ij = softcap * tanh(s_ij / softcap)            (when softcap > 0)
//   keep j iff j < Skv, j <= i (causal), j > i - window (window >= 0)
//   o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
// with one difference every tensor-core flash kernel has: the probabilities
// are rounded to bf16 before p . v (their sum stays fp32), so a result is
// held to |got - want| <= 1e-5 + 2^-7 |want| + 2^-8 (P . |v|).
//
// Bound: 4 * D flops a kept (query, key) pair against 2 * (S + 2 Skv + S) * D
// bytes a (batch, head): at the prefill shapes hundreds of flops a byte, so
// bound by the bf16 tensor-core rate (989 TFLOP/s dense on an H100 SXM).
//
// Design:
// - One CTA of two consumer warpgroups owns one (batch, head, 128-query
//   block); each warpgroup owns 64 query rows, the M of one wgmma.
//   blockIdx.y counts the query blocks from the last and blockIdx.x the
//   (batch, head) pairs, so the causal mask's longest rows start first and
//   the CTAs in flight together have work of like length (faster on the
//   H100 than running a head's query blocks side by side).
// - Q (128 x D) and a ring of K/V stages (BN x D each; three up to D 128,
//   two at D 256) live in shared memory as bf16, in the canonical GMMA
//   layout with a 128-byte swizzle (64-byte for D = 32): atoms of 8 rows x
//   W bytes, 16-byte chunk c of row r at c ^ (r % 8). TMA writes exactly
//   that layout: one thread issues a box a swizzle atom (4-d tensor maps
//   over (d, head, row, batch)), an mbarrier a stage counts the bytes in,
//   and rows past S or Skv arrive as zeros. Loads run ahead by kStages - 1
//   tiles while the warps compute, and no warp spends time issuing them (a
//   cp.async version, every thread issuing 16-byte copies, was slower).
// - S = Q . K^T is wgmma m64nBNk16 with both operands from shared memory
//   (K-major); O += P . V is wgmma m64nDk16 with P from registers (the RS
//   form: the S accumulator's layout is the A fragment's, so P never goes
//   back to shared memory) and V from shared memory read MN-major.
// - The two warpgroups take turns on the tensor cores (named barriers):
//   the issue order is S0 S1 PV0 PV1, so one warpgroup's softmax runs
//   beside the other's product.
// - The softmax keeps each row's max and sum in fp32 registers in the log2
//   domain (log2(e) folded into the scale, ex2.approx), rescales O only when
//   the max moved, and masks only the blocks that cross the diagonal, the
//   window's edge or Skv. k-blocks wholly outside the band are not visited.
//   The softcap is a template argument, so the common case pays nothing.
// - GQA reads kv head h / (H / Hkv); nothing is repeated in memory.
// - The output goes through shared memory (Q's space) so the stores to
//   device memory are 16-byte and coalesced.
// - When the caller passes an lse buffer, the lane that holds a row's sum
//   also writes the row's logsumexp, m + log l (natural log, fp32), which
//   the backward (csrc/flash_attn_bwd.cu) recomputes P from; a null buffer
//   skips the store.

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBM = 128;        // query rows a CTA, 64 a warpgroup

template <int D>
struct Cfg {
  static constexpr int W = D >= 64 ? 128 : 64;    // swizzle width: bytes a row of an atom
  static constexpr int kLayout = W == 128 ? 1 : 2;  // descriptor layout: B128 or B64
  static constexpr int BN = D >= 256 ? 64 : 128;  // keys a tile
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = BN * D * 2;
  static constexpr int kStages = D >= 256 ? 2 : 3;  // K/V ring (smem: 3 fit up to D 128)
  static constexpr size_t kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;  // + alignment
};

template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, float* __restrict__ lse, int H,
                    int Hkv, int S, int Skv,
                    float scale_log2, float cap_in, float cap_out, int causal,
                    int window) {
  using C = Cfg<D>;
  constexpr int W = C::W, BN = C::BN, L = C::kLayout, AC = W / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sq = base;
  const uint32_t sk = sq + C::kQBytes;
  const uint32_t sv = sk + C::kStages * C::kKVBytes;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const long long q_stride = (long long)H * D;

  // the k-blocks some row of this CTA may attend
  const int k_end = causal ? min(Skv, q0 + kBM) : Skv;
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kb0 = k_begin / BN, kb1 = (k_end + BN - 1) / BN;

  // K/V tile kb goes to stage (kb - kb0) % kStages and completes its
  // stage's barrier; Q rides with the first tile. One thread issues the
  // copies (one box an atom column); TMA zero-fills rows past S or Skv.
  auto load_kv = [&](int kb) {
    if (tid != 0 || kb >= kb1) return;
    const int st = (kb - kb0) % C::kStages, k0 = kb * BN;
    const uint32_t bar = smem_u32(&full[st]);
    mbar_expect_tx(bar, 2 * C::kKVBytes + (kb == kb0 ? C::kQBytes : 0));
    if (kb == kb0)
#pragma unroll
      for (int a = 0; a < D / AC; ++a)
        tma_load(sq + a * (kBM * W), &tq, bar, a * AC, h, q0, b);
#pragma unroll
    for (int a = 0; a < D / AC; ++a) {
      tma_load(sk + st * C::kKVBytes + a * (BN * W), &tk, bar, a * AC, hk, k0, b);
      tma_load(sv + st * C::kKVBytes + a * (BN * W), &tv, bar, a * AC, hk, k0, b);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < C::kStages; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) load_kv(kb0 + i);

  // this thread's two rows of the accumulators (wgmma's C layout: warp w of
  // the warpgroup holds rows 16w..16w+15; lane l rows l/4 and l/4 + 8 and
  // columns 8j + 2(l%4) + {0, 1})
  const int row_lo = q0 + 64 * wg + 16 * warp + lane / 4, row_hi = row_lo + 8;
  const int col_in = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // issue order of the products: S0 S1 PV0 PV1, block after block; warpgroup
  // 1 hands warpgroup 0 the first turn, and keeps its last pass
  if (wg == 1 && kb0 < kb1) turn_pass(1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int st = (kb - kb0) % C::kStages;
    const int k0 = kb * BN;
    mbar_wait(smem_u32(&full[st]), ((kb - kb0) / C::kStages) & 1);   // tile kb landed
    __syncthreads();   // every thread is done with tile kb - 1's stage
    load_kv(kb + C::kStages - 1);

    // S = Q . K^T: D/16 steps of k16, both operands K-major
    float s[BN / 2];
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk * 32 / W) * (kBM * W) + (kk * 32) % W;
      const uint32_t b_off = (kk * 32 / W) * (BN * W) + (kk * 32) % W;
      wgmma_bf16_ss<BN>(s, make_desc(sq + a_off + wg * 64 * W, 16, 8 * W, L),
                   make_desc(sk + st * C::kKVBytes + b_off, 16, 8 * W, L),
                   kk > 0);
    }
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);

    // scale (log2 domain) and softcap; the softcap is a template argument
    // and the mask a loop of its own, so the common block pays for neither
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s[i] = kSoftcap ? cap_out * tanhf(s[i] * cap_in) : s[i] * scale_log2;
    // mask only the blocks that cross the diagonal, the window's edge or Skv
    if (k0 + BN > Skv || (causal && k0 + BN - 1 > q0) ||
        (window >= 0 && k0 <= q0 + kBM - 1 - window)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int row = (i & 2) ? row_hi : row_lo;
        const int col = k0 + 8 * (i / 4) + col_in + (i & 1);
        const bool keep = col < Skv && (!causal || col <= row) &&
                          (window < 0 || col > row - window);
        if (!keep) s[i] = -INFINITY;
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      if (i & 2) mx_hi = fmaxf(mx_hi, s[i]);
      else mx_lo = fmaxf(mx_lo, s[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // a row with no key yet keeps max -inf; exponents then use 0, giving p = 0
    const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    if (mn_lo != m_lo) {
      const float alpha = ex2(m_lo - mu_lo);
      l_lo *= alpha;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        acc[i] *= alpha;
        acc[i + 1] *= alpha;
      }
    }
    if (mn_hi != m_hi) {
      const float alpha = ex2(m_hi - mu_hi);
      l_hi *= alpha;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        acc[i + 2] *= alpha;
        acc[i + 3] *= alpha;
      }
    }
    m_lo = mn_lo;
    m_hi = mn_hi;

    // p = exp2(x - m); the A fragment of k16 step kk is S columns 16kk..+15
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[e] = ex2(s[8 * kk + e] - ((e & 2) ? mu_hi : mu_lo));
        if (e & 2) l_hi += p[e];
        else l_lo += p[e];
      }
      pa[kk][0] = pack_bf16(p[0], p[1]);
      pa[kk][1] = pack_bf16(p[2], p[3]);
      pa[kk][2] = pack_bf16(p[4], p[5]);
      pa[kk][3] = pack_bf16(p[6], p[7]);
    }

    // O += P . V: BN/16 steps of k16 (16 keys), V read MN-major
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_bf16_rs<D>(acc, pa[kk],
                  make_desc(sv + st * C::kKVBytes + kk * 16 * W, BN * W, 8 * W, L));
    wgmma_commit();
    if (wg == 0 || kb + 1 < kb1) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // the row sums are spread over the 4 lanes of a quad
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  // the row's logsumexp of the scaled, softcapped logits (natural log),
  // for the backward; one lane of the quad writes it, none without lse
  if (lse != nullptr && lane % 4 == 0) {
    float* lp = lse + ((long long)b * H + h) * S;
    if (row_lo < S) lp[row_lo] = l_lo > 0.f ? (m_lo + log2f(l_lo)) * kLn2 : -INFINITY;
    if (row_hi < S) lp[row_hi] = l_hi > 0.f ? (m_hi + log2f(l_hi)) * kLn2 : -INFINITY;
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  // each warpgroup writes its own 64 rows of Q's tile, which only its own
  // wgmmas read, then the CTA stores the tile with 16-byte stores
  const int r_lo = row_lo - q0, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t in = (lane % 4) * 4;
    *reinterpret_cast<uint32_t*>(smem + swz_offset<Cfg<D>::W, kBM>(r_lo, j) + in) =
        pack_bf16(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(smem + swz_offset<Cfg<D>::W, kBM>(r_hi, j) + in) =
        pack_bf16(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
  }
  __syncthreads();
  constexpr int CH = D / 8;
  bf16* op = o + ((long long)b * S + q0) * q_stride + (long long)h * D;
#pragma unroll
  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(op + r * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz_offset<Cfg<D>::W, kBM>(r, c));
  }
}

// (B, rows, heads, D) bf16 as a 4-d map, cut into boxes of one swizzle
// atom: AC columns x box_rows rows.
template <int D>
bool make_map_bf16(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
                   int box_rows) {
  return make_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, rows, heads, D,
                  Cfg<D>::W / 2, box_rows,
                  Cfg<D>::W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int D, bool kSoftcap>
int launch_cap(const void* q, const void* k, const void* v, void* o, void* lse, int B,
               int H, int Hkv, int S, int Skv, float scale, int causal,
               int window, float softcap, cudaStream_t st) {
  constexpr size_t smem = Cfg<D>::kSmem;
  static bool configured = false;   // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D, kSoftcap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map_bf16<D>(&tq, q, B, S, H, kBM) ||
      !make_map_bf16<D>(&tk, k, B, Skv, Hkv, Cfg<D>::BN) ||
      !make_map_bf16<D>(&tv, v, B, Skv, Hkv, Cfg<D>::BN))
    return (int)cudaErrorInvalidValue;
  const float cap_in = kSoftcap ? scale / softcap : 0.f;
  const float cap_out = kSoftcap ? softcap * kLog2e : 0.f;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  flash_tc_kernel<D, kSoftcap><<<grid, kThreads, smem, st>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, H, Hkv, S, Skv, scale * kLog2e, cap_in, cap_out,
      causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
           int Hkv, int S, int Skv, float scale, int causal, int window,
           float softcap, cudaStream_t st) {
  return softcap > 0.f
             ? launch_cap<D, true>(q, k, v, o, lse, B, H, Hkv, S, Skv, scale, causal,
                                   window, softcap, st)
             : launch_cap<D, false>(q, k, v, o, lse, B, H, Hkv, S, Skv, scale,
                                    causal, window, softcap, st);
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, Skv, Hkv, D); bf16, contiguous, 16-byte
// aligned. H % Hkv == 0, D in {32, 64, 128, 256}. window < 0: no window;
// softcap <= 0: no softcap. lse: null, or (B, H, S) fp32 for each row's
// logsumexp (the backward's input; serving passes null and pays nothing).
extern "C" int flash_attn_tc_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int batch, int heads, int kv_heads,
                                 int seq_q, int seq_kv, int head_dim,
                                 float scale, int causal, int window,
                                 float softcap, void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_kv <= 0 ||
      (seq_q + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, o, lse, batch, heads, kv_heads, seq_q, seq_kv, scale, causal, window, softcap, st);
    case 64:
      return launch<64>(q, k, v, o, lse, batch, heads, kv_heads, seq_q, seq_kv, scale, causal, window, softcap, st);
    case 128:
      return launch<128>(q, k, v, o, lse, batch, heads, kv_heads, seq_q, seq_kv, scale, causal, window, softcap, st);
    case 256:
      return launch<256>(q, k, v, o, lse, batch, heads, kv_heads, seq_q, seq_kv, scale, causal, window, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
