// Flash-attention backward for bf16 on Hopper's tensor cores (sm_90a): dQ,
// dK and dV of o = softmax(mask(softcap(q*scale . k^T))) . v, from q, k, v,
// the forward's o, the output's gradient dO and the forward's row
// logsumexp. fp32 inputs go to csrc/flash_attn_bwd_f32.cu.
//
// Replaces: nothing on the TPU. The JAX package trains through its plain
// attention (src/repro/nn/attention.py::_sdpa) and its Pallas kernel
// (src/repro/kernels/flash_attn.py::_flash_kernel) has no backward; the
// port trains through its forward kernels (csrc/flash_attn_tc.cu, bf16;
// csrc/flash_attn.cu, fp32), so their gradient is a kernel too. It
// computes what kernels/ref.py::flash_attention_bwd_ref computes, per query
// row i and key j (positions from 0 in both, GQA kv head h / (H / Hkv)):
//   s_ij  = (q_i . k_j) * scale
//   t_ij  = softcap * tanh(s_ij / softcap)     (s_ij without a softcap)
//   P_ij  = exp(t_ij - lse_i) on the kept pairs, 0 elsewhere
//           (keep j iff j < Skv, j <= i (causal), j > i - window (window))
//   D_i   = dO_i . o_i
//   dS_ij = P_ij (dO_i . v_j - D_i) * (1 - tanh^2(s_ij / softcap))
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_{i, heads of j's group} dS_ij q_i
//   dv_j  = sum_{i, heads of j's group} P_ij dO_i
// The five products run on the tensor cores (fp32 accumulation), P and dS
// rounded to bf16 before their products, as every tensor-core flash
// backward does; the softmax arithmetic in fp32. The outputs are rounded
// once, to bf16. kernels/ref.py::flash_attention_bwd_tol holds the result.
//
// Bound: five products of 2 * D flops a kept (query, key) pair (2.5x the
// forward's), against reading q, k, v, o, dO once and writing dq, dk, dv:
// at the training shape thousands of flops a byte, so bound by the bf16
// tensor-core rate (989 TFLOP/s dense on an H100 SXM).
//
// Design: no float atomics and a fixed order of every sum, so a result
// repeats bit for bit. The dQ pass recomputes S and dP (seven products in
// all, not five) so that dQ needs no atomics. Three launches in stream
// order, the same kernels at every head dim (32, 64, 128, 256):
// (a) bwd_prep_kernel: D_i = dO_i . o_i in fp32, in a fixed order, and lse
//     times log2(e), both as (B, H, Sp) with Sp = S rounded up to 128, so
//     that a tile's values are one 16-byte aligned bulk copy and a padded
//     row gets P = 0 (lse +inf).
// (b) dkdv_wg_kernel: one CTA a (batch, kv head, block of keys), GQA summed
//     inside the CTA over the query heads of the group, the query tiles the
//     causal band and the window leave (in that order).
// (c) dq_wg_kernel: one CTA a (batch, head, block of queries), the longest
//     rows first, over the key tiles the masks leave.
// Both are built from csrc/flash_common.cuh as the forward
// (csrc/flash_attn_tc.cu) is: two consumer warpgroups, 64 rows each (the M
// of one wgmma). Tiles live in shared memory in the canonical GMMA layout
// with a 128-byte swizzle (64-byte at D 32, whose rows are 64 bytes), written
// by TMA (one thread issues a box an atom column, an mbarrier a stage counts
// the bytes in, rows past S or Skv arrive as zeros); a ring of two or three
// stages runs ahead of the math. Only the tiles that cross the diagonal,
// the window's edge, S or Skv test the masks.
// - dq_wg_kernel: Q, dO, their lse and D_i stay resident; a ring of K/V
//   tiles. S = Q.K^T and dP = dO.V^T are wgmma with both operands K-major;
//   P and dS are computed in fp32 registers and dS is rounded to bf16 there;
//   dQ += dS.K is the RS form (dS as the A fragment straight from the
//   accumulator layout, K read MN-major), so P and dS never touch shared
//   memory.
// - dkdv_wg_kernel: K, V stay resident; a ring of (Q, dO, lse, D) tiles of
//   64 queries over the (query head, query tile) pairs. S^T = K.Q^T and
//   dP^T = V.dO^T keep the keys along M, so P^T and dS^T come out of the
//   accumulators in the A-fragment layout of dV += P^T.dO and dK += dS^T.Q,
//   which read dO and Q MN-major. dK and dV stay in registers over all
//   pairs.
// Up to D 128 (Wg<D>::kSplit false) each warpgroup owns 64 rows of a 128-row
// CTA (128 keys of K/V tiles for dQ, 2% faster than 64 at the training
// shape on the H100) and all D columns of its accumulators (dK and dV: 64 +
// 64 fp32 a thread at D 128). The two warpgroups take turns on the tensor
// cores (named barriers), so one's softmax runs beside the other's
// products.
// At D 256 that tile would need 256 fp32 a thread for dK and dV alone, and
// 128 resident rows 2 x 64 KiB of shared memory a tensor. So (kSplit) the two
// warpgroups share a CTA of 64 rows and split the head dim: each keeps 128
// columns of its accumulators (dK and dV: 64 + 64 fp32 a thread, dQ: 64).
// The CTA's S (S^T) and dP (dP^T) are needed whole by both: warpgroup 0
// takes the first product, warpgroup 1 the second, each over all 256 columns,
// and they swap the fp32 results through shared memory (32 KiB, one float a
// thread an element, in the accumulator layout, so no swizzle and no bank
// conflict); then both compute P and dS, identically, and each runs its
// half of the RS products (N = 128). No product is done twice. Resident 64
// rows (64 KiB for two tensors), stages of 64 rows (64 KiB) in a ring of
// two, and the swap fill 225-226 KiB.
// The outputs go through shared memory (Q's or K's and V's tiles, which no
// product reads after the last tile), so the stores to device memory are
// 16-byte and coalesced.

#include <cuda_bf16.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 256;   // two consumer warpgroups

template <int D>
struct Wg {
  static constexpr int W = D >= 64 ? 128 : 64;   // swizzle width: bytes an atom row
  static constexpr int AC = W / 2;               // head-dim columns an atom column
  static constexpr bool kSplit = D >= 256;       // the warpgroups split the head dim
  static constexpr int kRows = kSplit ? 64 : 128;   // a CTA's queries (dq) or keys (dkdv)
  static constexpr int DH = kSplit ? D / 2 : D;     // accumulator columns a warpgroup
  static constexpr int BN = kSplit ? 64 : 128;      // dq: keys a tile of the K/V ring
  static constexpr int BM = 64;                     // dkdv: queries a tile of the Q/dO ring
  static constexpr int kRowBytes = kRows * D * 2;   // a resident Q or dO (dq), K or V (dkdv)
  static constexpr int kKvTile = BN * D * 2;        // a K or V stage (dq)
  static constexpr int kQTile = BM * D * 2;         // a Q or dO stage (dkdv)
  // the swap of S and dP (kSplit): 32 fp32 a thread of each warpgroup
  static constexpr int kSwap = kSplit ? 2 * 128 * 32 * 4 : 0;
  // ring stages: three where they fit in the 227 KiB a CTA may hold, else two
  static constexpr int kDqStages =
      2 * kRowBytes + 6 * kKvTile + kSwap + 1024 <= 227 * 1024 ? 3 : 2;
  static constexpr int kDkvStages =
      2 * kRowBytes + 6 * kQTile + 6 * BM * 4 + kSwap + 1024 <= 227 * 1024 ? 3 : 2;
  static constexpr size_t kDqSmem = 2 * kRowBytes + 2 * kDqStages * kKvTile + kSwap + 1024;
  static constexpr size_t kDkvSmem =
      2 * kRowBytes + 2 * kDkvStages * kQTile + 2 * kDkvStages * BM * 4 + kSwap + 1024;
};

// D_i = dO_i . o_i and the forward's logsumexp in the log2 domain: one warp
// a row of a (B, H, Sp) layout whose rows are padded to Sp = S rounded up to
// 128, so that a tile's rows are one 16-byte aligned copy; a padded row gets
// lse +inf (P = 0) and D 0
__global__ void __launch_bounds__(256)
    bwd_prep_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ delta, long long rows, int S, int Sp, int H, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = (int)(row % Sp);
  const long long bh = row / Sp;
  float acc = 0.f;
  if (s < S && lane < D / 8) {   // (b, s, h) in memory: 16 bytes a lane
    const long long at = ((bh / H * S + s) * H + bh % H) * D + lane * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(dout + at);
    const uint4 y = *reinterpret_cast<const uint4*>(o + at);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(x2[e]), c = __bfloat1622float2(y2[e]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    lse2[row] = s < S ? lse[bh * S + s] * kLog2e : INFINITY;
    delta[row] = acc;
  }
}

// dQ: one CTA of two warpgroups a (batch, head, kRows-query block), the
// longest rows first. Up to D 128 warpgroup wg owns queries q0 + 64 wg ..
// + 63 and all D columns of dQ; at D 256 both own the CTA's 64 queries and
// warpgroup wg the columns 128 wg .. + 127.
template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse2, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int Hkv, int S, int Skv, int Sp, float scale,
                 float scale_log2, float cap_in, float cap_out, int causal, int window) {
  using C = Wg<D>;
  constexpr int W = C::W, AC = C::AC, BN = C::BN, ST = C::kDqStages, TILE = C::kKvTile;
  constexpr int R = C::kRows, DH = C::DH;
  constexpr bool kSplit = C::kSplit;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sq = base, sdo = sq + C::kRowBytes, sk = sdo + C::kRowBytes,
                 sv = sk + ST * TILE, sw = sv + ST * TILE;

  const int tid = threadIdx.x, wg = warpgroup_index(), warp = (tid % 128) / 32,
            lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  const int qw = kSplit ? q0 : q0 + 64 * wg;   // this warpgroup's first query

  // the key tiles some row of the CTA keeps: j <= i (causal), j > i - window
  const int k_end = causal ? min(Skv, q0 + R) : Skv;
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kb0 = k_begin / BN, kb1 = k_end > k_begin ? (k_end + BN - 1) / BN : kb0;

  // K/V tile kb goes to stage (kb - kb0) % ST; Q and dO ride with the first.
  // One thread issues the copies; rows past S or Skv arrive as zeros.
  auto load = [&](int kb) {
    if (tid != 0 || kb >= kb1) return;
    const int st = (kb - kb0) % ST, k0 = kb * BN;
    const uint32_t bar = smem_u32(&full[st]);
    mbar_expect_tx(bar, 2 * TILE + (kb == kb0 ? 2 * C::kRowBytes : 0));
    if (kb == kb0)
#pragma unroll
      for (int a = 0; a < D / AC; ++a) {
        tma_load(sq + a * (R * W), &tq, bar, a * AC, h, q0, b);
        tma_load(sdo + a * (R * W), &tdo, bar, a * AC, h, q0, b);
      }
#pragma unroll
    for (int a = 0; a < D / AC; ++a) {
      tma_load(sk + st * TILE + a * (BN * W), &tk, bar, a * AC, hk, k0, b);
      tma_load(sv + st * TILE + a * (BN * W), &tv, bar, a * AC, hk, k0, b);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < ST; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) load(kb0 + i);

  // this thread's two rows of the accumulators (wgmma's C layout) with
  // their lse (log2 domain) and D_i, fixed over the key tiles
  const int row_lo = qw + 16 * warp + lane / 4, row_hi = row_lo + 8;
  const int col_in = 2 * (lane % 4);
  const long long bh = ((long long)b * H + h) * Sp;
  const float l_lo = lse2[bh + row_lo], l_hi = lse2[bh + row_hi];
  const float d_lo = delta[bh + row_lo], d_hi = delta[bh + row_hi];
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  // the K columns this warpgroup's dQ columns read (kSplit: its half)
  const uint32_t k_cols = kSplit ? wg * (DH / AC) * (BN * W) : 0;

  // issue order (up to D 128): (S, dP) of warpgroup 0, of 1, then dQ of 0, of 1
  if constexpr (!kSplit)
    if (wg == 1 && kb0 < kb1) turn_pass(1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int st = (kb - kb0) % ST, k0 = kb * BN;
    mbar_wait(smem_u32(&full[st]), ((kb - kb0) / ST) & 1);
    __syncthreads();   // every thread is done with tile kb - 1's stage
    load(kb + ST - 1);

    // S = Q.K^T and dP = dO.V^T, both operands K-major
    float s[BN / 2], dp[BN / 2];
    if constexpr (kSplit) {   // warpgroup 0 takes S, 1 takes dP; then they swap
      float x[BN / 2];
      const uint32_t ta = wg == 0 ? sq : sdo, tb = (wg == 0 ? sk : sv) + st * TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss<BN>(x, kmajor_desc<W, R>(ta, kk, 0), kmajor_desc<W, BN>(tb, kk, 0),
                          kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      swap_products(x, s, dp, reinterpret_cast<float*>(smem + (sw - base)), wg, tid % 128);
    } else {
      turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss<BN>(s, kmajor_desc<W, R>(sq, kk, 64 * wg),
                          kmajor_desc<W, BN>(sk + st * TILE, kk, 0), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss<BN>(dp, kmajor_desc<W, R>(sdo, kk, 64 * wg),
                          kmajor_desc<W, BN>(sv + st * TILE, kk, 0), kk > 0);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    }

    // P and dS in fp32, dS rounded to bf16 as the A fragments of dQ += dS.K
    // (k16 step kk: keys 16kk..16kk+15, the accumulator's columns); only the
    // tiles that cross the diagonal, the window's edge or Skv test the masks
    const bool edge = k0 + BN > Skv || (causal && k0 + BN - 1 > qw) ||
                      (window >= 0 && k0 <= qw + 63 - window);
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      float e8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * kk + e;
        float th = 0.f;
        const float t = kSoftcap ? cap_out * (th = tanhf(s[i] * cap_in)) : s[i] * scale_log2;
        float p = ex2(t - ((e & 2) ? l_hi : l_lo));
        if (edge) {
          const int row = (e & 2) ? row_hi : row_lo, col = k0 + 8 * (i / 4) + col_in + (e & 1);
          if (!(col < Skv && (!causal || col <= row) && (window < 0 || col > row - window)))
            p = 0.f;
        }
        const float dl = (e & 2) ? d_hi : d_lo;
        float ds = p * (dp[i] - dl);
        if (kSoftcap) ds *= 1.f - th * th;
        e8[e] = ds;
      }
      da[kk][0] = pack_bf16(e8[0], e8[1]);
      da[kk][1] = pack_bf16(e8[2], e8[3]);
      da[kk][2] = pack_bf16(e8[4], e8[5]);
      da[kk][3] = pack_bf16(e8[6], e8[7]);
    }

    // dQ += dS.K: dS from registers, K read MN-major
    if constexpr (!kSplit) turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_bf16_rs<DH>(acc, da[kk], mnmajor_desc<W, BN>(sk + st * TILE + k_cols, kk));
    wgmma_commit();
    if constexpr (!kSplit)
      if (wg == 0 || kb + 1 < kb1) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // each warpgroup writes its rows (up to D 128) or its columns (D 256) of
  // Q's tile, which no product reads any more, then the CTA stores the tile
  // with 16-byte stores
  const int r_lo = row_lo - q0, r_hi = r_lo + 8, c0 = kSplit ? wg * (DH / 8) : 0;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const uint32_t in = (lane % 4) * 4;
    *reinterpret_cast<uint32_t*>(smem + swz_offset<W, R>(r_lo, c0 + j) + in) =
        pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(smem + swz_offset<W, R>(r_hi, c0 + j) + in) =
        pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
  __syncthreads();
  constexpr int CH = D / 8;
  const long long qs = (long long)H * D;
  bf16* out = dq + ((long long)b * S + q0) * qs + (long long)h * D;
  for (int i = tid; i < R * CH; i += kWgThreads) {
    const int r = i / CH, c = i % CH;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(out + r * qs + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz_offset<W, R>(r, c));
  }
}

// dK and dV: one CTA of two warpgroups a (batch, kv head, kRows-key block);
// up to D 128 warpgroup wg owns keys k0 + 64 wg .. + 63, at D 256 both own
// the CTA's 64 keys and warpgroup wg the columns 128 wg .. + 127. Under the
// causal mask key block 0 has the longest column, and blockIdx.y counts
// from it.
template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkdv_wg_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse2, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int S, int Skv,
                   int Sp, float scale, float scale_log2, float cap_in, float cap_out,
                   int causal, int window) {
  using C = Wg<D>;
  constexpr int W = C::W, AC = C::AC, BM = C::BM, ST = C::kDkvStages, TILE = C::kQTile;
  constexpr int R = C::kRows, DH = C::DH;
  constexpr bool kSplit = C::kSplit;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sk = base, sv = sk + C::kRowBytes, sq = sv + C::kRowBytes,
                 sdo = sq + ST * TILE, sl = sdo + ST * TILE, sd = sl + ST * BM * 4,
                 sw = sd + ST * BM * 4;

  const int tid = threadIdx.x, wg = warpgroup_index(), warp = (tid % 128) / 32,
            lane = tid % 32;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * R;
  const int kw = kSplit ? k0 : k0 + 64 * wg;   // this warpgroup's first key

  // the query tiles some key of the CTA is kept for: i >= j (causal) and
  // i < j + window; each query head of the group visits them in turn
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window >= 0 ? min(S, k0 + R - 1 + window) : S;
  const int qt0 = i_lo / BM, nq = i_hi > i_lo ? (i_hi + BM - 1) / BM - qt0 : 0;
  const int n = G * nq;   // (query head, query tile) pairs

  // pair it goes to stage it % ST; K and V ride with the first. The tile's
  // lse and D come as two plain copies of BM floats.
  auto load = [&](int it) {
    if (tid != 0 || it >= n) return;
    const int st = it % ST, h = hk * G + it / nq, q0 = (qt0 + it % nq) * BM;
    const uint32_t bar = smem_u32(&full[st]);
    mbar_expect_tx(bar, 2 * TILE + 2 * BM * 4 + (it == 0 ? 2 * C::kRowBytes : 0));
    if (it == 0)
#pragma unroll
      for (int a = 0; a < D / AC; ++a) {
        tma_load(sk + a * (R * W), &tk, bar, a * AC, hk, k0, b);
        tma_load(sv + a * (R * W), &tv, bar, a * AC, hk, k0, b);
      }
#pragma unroll
    for (int a = 0; a < D / AC; ++a) {
      tma_load(sq + st * TILE + a * (BM * W), &tq, bar, a * AC, h, q0, b);
      tma_load(sdo + st * TILE + a * (BM * W), &tdo, bar, a * AC, h, q0, b);
    }
    const long long at = ((long long)b * H + h) * Sp + q0;
    bulk_load(sl + st * BM * 4, lse2 + at, BM * 4, bar);
    bulk_load(sd + st * BM * 4, delta + at, BM * 4, bar);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < ST; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) load(i);

  // this thread's two keys (rows of S^T); its query columns are
  // 8c + col_in + {0, 1} of the tile
  const int key_lo = kw + 16 * warp + lane / 4, key_hi = key_lo + 8;
  const int col_in = 2 * (lane % 4);
  float acc_k[DH / 2], acc_v[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  // the dO and Q columns this warpgroup's dV and dK columns read
  const uint32_t q_cols = kSplit ? wg * (DH / AC) * (BM * W) : 0;

  // issue order (up to D 128): (S^T, dP^T) of warpgroup 0, of 1, then (dV,
  // dK) of 0, of 1
  if constexpr (!kSplit)
    if (wg == 1 && n > 0) turn_pass(1);
  for (int it = 0; it < n; ++it) {
    const int st = it % ST, q0 = (qt0 + it % nq) * BM;
    mbar_wait(smem_u32(&full[st]), (it / ST) & 1);
    __syncthreads();   // every thread is done with pair it - 1's stage
    load(it + ST - 1);

    // S^T = K.Q^T and dP^T = V.dO^T: keys along M, both operands K-major
    float s[BM / 2], dp[BM / 2];
    if constexpr (kSplit) {   // warpgroup 0 takes S^T, 1 takes dP^T; then they swap
      float x[BM / 2];
      const uint32_t ta = wg == 0 ? sk : sv, tb = (wg == 0 ? sq : sdo) + st * TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss<BM>(x, kmajor_desc<W, R>(ta, kk, 0), kmajor_desc<W, BM>(tb, kk, 0),
                          kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      swap_products(x, s, dp, reinterpret_cast<float*>(smem + (sw - base)), wg, tid % 128);
    } else {
      turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss<BM>(s, kmajor_desc<W, R>(sk, kk, 64 * wg),
                          kmajor_desc<W, BM>(sq + st * TILE, kk, 0), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16_ss<BM>(dp, kmajor_desc<W, R>(sv, kk, 64 * wg),
                          kmajor_desc<W, BM>(sdo + st * TILE, kk, 0), kk > 0);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    }

    // P^T and dS^T in fp32, rounded to bf16: with keys along M they are
    // already the A fragments of dV += P^T.dO and dK += dS^T.Q
    const float* lt = reinterpret_cast<const float*>(smem + (sl - base) + st * BM * 4);
    const float* dt = reinterpret_cast<const float*>(smem + (sd - base) + st * BM * 4);
    const bool edge = kw + 64 > Skv || q0 + BM > S || (causal && kw + 63 > q0) ||
                      (window >= 0 && kw <= q0 + BM - 1 - window);
    uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      float p8[8], e8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * kk + e, c = 8 * (i / 4) + col_in + (e & 1);
        float th = 0.f;
        const float t = kSoftcap ? cap_out * (th = tanhf(s[i] * cap_in)) : s[i] * scale_log2;
        float p = ex2(t - lt[c]);
        if (edge) {
          const int key = (e & 2) ? key_hi : key_lo, row = q0 + c;
          if (!(key < Skv && row < S && (!causal || key <= row) &&
                (window < 0 || key > row - window)))
            p = 0.f;
        }
        const float dl = dt[c];
        float ds = p * (dp[i] - dl);
        if (kSoftcap) ds *= 1.f - th * th;
        p8[e] = p;
        e8[e] = ds;
      }
      pa[kk][0] = pack_bf16(p8[0], p8[1]);
      pa[kk][1] = pack_bf16(p8[2], p8[3]);
      pa[kk][2] = pack_bf16(p8[4], p8[5]);
      pa[kk][3] = pack_bf16(p8[6], p8[7]);
      da[kk][0] = pack_bf16(e8[0], e8[1]);
      da[kk][1] = pack_bf16(e8[2], e8[3]);
      da[kk][2] = pack_bf16(e8[4], e8[5]);
      da[kk][3] = pack_bf16(e8[6], e8[7]);
    }

    // dV += P^T.dO and dK += dS^T.Q: A from registers, dO and Q MN-major
    if constexpr (!kSplit) turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_bf16_rs<DH>(acc_v, pa[kk], mnmajor_desc<W, BM>(sdo + st * TILE + q_cols, kk));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_bf16_rs<DH>(acc_k, da[kk], mnmajor_desc<W, BM>(sq + st * TILE + q_cols, kk));
    wgmma_commit();
    if constexpr (!kSplit)
      if (wg == 0 || it + 1 < n) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }

  // dK (times scale) into K's tile and dV into V's, each warpgroup its rows
  // (up to D 128) or its columns (D 256), which no product reads any more,
  // then 16-byte stores
  const int r_lo = key_lo - k0, r_hi = r_lo + 8, c0 = kSplit ? wg * (DH / 8) : 0;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const uint32_t in = (lane % 4) * 4;
    const uint32_t lo = swz_offset<W, R>(r_lo, c0 + j) + in,
                   hi = swz_offset<W, R>(r_hi, c0 + j) + in;
    *reinterpret_cast<uint32_t*>(smem + lo) =
        pack_bf16(acc_k[4 * j] * scale, acc_k[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(smem + hi) =
        pack_bf16(acc_k[4 * j + 2] * scale, acc_k[4 * j + 3] * scale);
    *reinterpret_cast<uint32_t*>(smem + C::kRowBytes + lo) =
        pack_bf16(acc_v[4 * j], acc_v[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(smem + C::kRowBytes + hi) =
        pack_bf16(acc_v[4 * j + 2], acc_v[4 * j + 3]);
  }
  __syncthreads();
  constexpr int CH = D / 8;
  const long long ks = (long long)Hkv * D;
  const long long at = ((long long)b * Skv + k0) * ks + (long long)hk * D;
  for (int i = tid; i < R * CH; i += kWgThreads) {
    const int r = i / CH, c = i % CH;
    if (k0 + r < Skv) {
      const uint32_t off = swz_offset<W, R>(r, c);
      *reinterpret_cast<uint4*>(dk + at + r * ks + c * 8) =
          *reinterpret_cast<const uint4*>(smem + off);
      *reinterpret_cast<uint4*>(dv + at + r * ks + c * 8) =
          *reinterpret_cast<const uint4*>(smem + C::kRowBytes + off);
    }
  }
}

// (B, rows, heads, D) bf16 as a 4-d tensor map, boxes of one swizzle atom
// column (Wg<D>::AC columns) x box_rows
template <int D>
bool wg_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int box_rows) {
  return make_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, rows, heads, D, Wg<D>::AC,
                  box_rows,
                  Wg<D>::W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int D, bool kSoftcap>
int launch_cap(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H,
               int Hkv, int S, int Skv, float scale, int causal, int window, float softcap,
               cudaStream_t st) {
  using C = Wg<D>;
  constexpr int R = C::kRows;
  static bool dkdv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(dkdv_wg_kernel<D, kSoftcap>, C::kDkvSmem, dkdv_ok);
  if (e == cudaSuccess) e = allow_smem(dq_wg_kernel<D, kSoftcap>, C::kDqSmem, dq_ok);
  if (e != cudaSuccess) return (int)e;
  const int Sp = (S + 127) / 128 * 128;
  float* lse2 = scratch;
  float* delta = scratch + (long long)B * H * Sp;
  CUtensorMap q_rows, do_rows, k_tile, v_tile, k_rows, v_rows, q_tile, do_tile;
  if (!wg_map<D>(&q_rows, q, B, S, H, R) || !wg_map<D>(&do_rows, dout, B, S, H, R) ||
      !wg_map<D>(&k_tile, k, B, Skv, Hkv, C::BN) || !wg_map<D>(&v_tile, v, B, Skv, Hkv, C::BN) ||
      !wg_map<D>(&k_rows, k, B, Skv, Hkv, R) || !wg_map<D>(&v_rows, v, B, Skv, Hkv, R) ||
      !wg_map<D>(&q_tile, q, B, S, H, C::BM) || !wg_map<D>(&do_tile, dout, B, S, H, C::BM))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sp;
  bwd_prep_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const bf16*)dout, (const bf16*)o, lse, lse2, delta, rows, S, Sp, H, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const float scale_log2 = scale * kLog2e;
  const float cap_in = kSoftcap ? scale / softcap : 0.f;
  const float cap_out = kSoftcap ? softcap * kLog2e : 0.f;
  dkdv_wg_kernel<D, kSoftcap>
      <<<dim3(B * Hkv, (Skv + R - 1) / R), kWgThreads, C::kDkvSmem, st>>>(
          k_rows, v_rows, q_tile, do_tile, lse2, delta, (bf16*)dk, (bf16*)dv, H, Hkv, S, Skv,
          Sp, scale, scale_log2, cap_in, cap_out, causal, window);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dq_wg_kernel<D, kSoftcap><<<dim3(B * H, (S + R - 1) / R), kWgThreads, C::kDqSmem, st>>>(
      q_rows, do_rows, k_tile, v_tile, lse2, delta, (bf16*)dq, H, Hkv, S, Skv, Sp, scale,
      scale_log2, cap_in, cap_out, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H,
           int Hkv, int S, int Skv, float scale, int causal, int window, float softcap,
           cudaStream_t st) {
  return softcap > 0.f
             ? launch_cap<D, true>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, Hkv, S,
                                   Skv, scale, causal, window, softcap, st)
             : launch_cap<D, false>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, Hkv, S,
                                    Skv, scale, causal, window, softcap, st);
}

}  // namespace

// q, o, dout, dq: (B, S, H, D); k, v, dk, dv: (B, Skv, Hkv, D); bf16,
// contiguous. lse: (B, H, S) fp32, the forward's; scratch: fp32 of 2 * B * H
// * Sp floats, Sp = seq_q rounded up to 128. H % Hkv == 0, D in {32, 64, 128,
// 256}; window < 0: no window; softcap <= 0: no softcap. Three launches on
// `stream`, in order; returns the first launch error.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* scratch, void* dq,
                              void* dk, void* dv, int batch, int heads, int kv_heads,
                              int seq_q, int seq_kv, int head_dim, float scale, int causal,
                              int window, float softcap, void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_kv <= 0 || seq_q / 64 > 65535 ||
      seq_kv / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* sc = (float*)scratch;
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, o, dout, l, sc, dq, dk, dv, batch, heads, kv_heads, seq_q, seq_kv, scale, causal, window, softcap, st);
    case 64:
      return launch<64>(q, k, v, o, dout, l, sc, dq, dk, dv, batch, heads, kv_heads, seq_q, seq_kv, scale, causal, window, softcap, st);
    case 128:
      return launch<128>(q, k, v, o, dout, l, sc, dq, dk, dv, batch, heads, kv_heads, seq_q, seq_kv, scale, causal, window, softcap, st);
    case 256:
      return launch<256>(q, k, v, o, dout, l, sc, dq, dk, dv, batch, heads, kv_heads, seq_q, seq_kv, scale, causal, window, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
