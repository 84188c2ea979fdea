// Flash-attention forward for fp32 on Hopper's tensor cores (sm_90a), in
// 3xTF32: softmax(mask(softcap(q*scale . k^T))) . v with an online softmax,
// so the (S, Skv) logits never reach device memory.
//
// Replaces: src/repro/kernels/flash_attn.py::_flash_kernel (the Pallas TPU
// kernel behind flash_attention_hsd / flash_attention) for fp32 inputs;
// bf16 inputs go to csrc/flash_attn_tc.cu. Per query row i and key j, with
// positions counted from 0 in both:
//   s_ij = (q_i * scale) . k_j                       (fp32)
//   s_ij = softcap * tanh(s_ij / softcap)            (when softcap > 0)
//   keep j iff j < Skv, j <= i (causal), j > i - window (window >= 0)
//   o_i  = sum_j exp(s_ij - m_i) v_j / sum_j exp(s_ij - m_i)
// held to kernels/ref.py::flash_attention_tol's fp32 bound, 1e-5 + 1e-5|x|
// of the exact answer x.
//
// Arithmetic. One TF32 product keeps 11 of a float's 24 mantissa bits and
// misses that bound by ~100x. So each operand x is split into hi (x rounded
// to the nearest TF32, its low 13 mantissa bits written as zeros, so hi +
// lo == x exactly) and lo = x - hi, itself rounded to TF32 (|lo| <= 2^-11
// |x|, so at most 2^-23 |x| is lost), and each product a.b is taken as
// hi_a.hi_b + hi_a.lo_b + lo_a.hi_b on the TF32 tensor cores with fp32
// accumulation (lo.lo, at most 2^-22 of a.b, is dropped). Both products,
// S = Q.K^T and O += P.V, are done so. Clearing hi's bits without rounding
// leaves |lo| up to 2^-10 |x|, and doubled the worst error on the card.
//
// Accumulation. The tensor cores add a k-step's 8 products and the
// accumulator in one step that truncates every addend below the largest
// one's last bit (measured on the H100), so a long chain of large terms
// drifts well past fp32's rounding. So each k-step of S's hi.hi takes a
// fresh accumulator, summed in fp32 registers while the next one runs; the
// cross terms, 2^-11 of the logit or less, take one chain of their own; and
// each tile's P.V goes into a fresh accumulator added to O in registers.
// The softmax's exponent is fma(s, log2(e), -m log2(e)): one rounding of
// s - m, so a large logit near the row's max keeps its bits. With these the
// kernel lies closer to the exact answer than the fp32 plain version where
// the logits are large (launch/profile_flash.py: ACCURACY).
//
// Bound: 4 * D flops a kept (query, key) pair, three times over, against
// 4 * (S + 2 Skv + S) * D bytes a (batch, head): at the prefill shapes
// bound by the TF32 rate (494.7 TFLOP/s dense on an H100 SXM, so 165 of
// fp32-accurate work), 2.5x the fp32 FMA rate of 67.
//
// Differences from the TPU kernel, none of which changes a result the model
// can see: keys at j >= Skv are always masked (the JAX wrapper pads k/v with
// zeros and masks the padding only through the causal test); k-blocks that
// lie wholly outside the causal/window band are skipped, not visited and
// masked. A query row with no key to attend (a window and S >= Skv + window)
// would come out 0 where the plain version gives the mean of v, so the
// wrapper refuses such calls (kernels/flash_attn.py).
//
// Design (the bf16 kernel's, csrc/flash_attn_tc.cu, where fp32 allows):
// - One CTA of NW consumer warpgroups owns one (batch, head, 64*NW-query
//   block); each warpgroup owns 64 query rows, the M of one wgmma.
//   blockIdx.y counts the query blocks from the last, so the causal mask's
//   longest rows start first. Two warpgroups take turns on the tensor cores
//   (S0 S1 PV0 PV1), so one's softmax runs beside the other's product.
// - TMA (FLOAT32 tensor maps, 128-byte swizzle: atoms of 8 rows x 32
//   floats) brings Q with the first tile and raw K/V tiles into a ring of
//   kStages stages, an mbarrier a stage, and keeps the next tiles' loads in
//   flight while the warps compute. Rows past S or Skv arrive as zeros.
// - The split pass: every thread of the CTA (both consumer warpgroups; no
//   warpgroup of its own, which would take registers and shared memory the
//   tiles need) turns the raw K tile into K_hi and K_lo, and the raw V tile
//   into V_hi^T and V_lo^T, once a tile for all the CTA's rows. Then the raw
//   stage goes back to TMA. Q is split once, times scale, in place (hi) and
//   into Q_lo. A tile costs each thread BN*D/(256*NW) 16-byte loads and
//   twice that in stores, beside 3 * 2 * 64*NW * BN * D MACs on the tensor
//   cores.
// - tf32 wgmma reads both shared-memory operands K-major (it takes no
//   transpose flag). Q and K arrive with D contiguous, right for S = Q.K^T
//   (wgmma m64nBNk8, both from shared memory). For O += P.V, V arrives with
//   D contiguous, which is MN-major, so the split pass writes V^T: rows d,
//   keys contiguous, in the same swizzled atoms.
// - P stays in registers (the RS form). The S accumulator gives a thread
//   keys 8j + 2t and 8j + 2t + 1 of rows g and g + 8 (lane = 4g + t), while
//   the tf32 A fragment of k-step j wants k indices t and t + 4. The sum
//   over keys does not care for their order, so k index t stands for key
//   2t and t + 4 for key 2t + 1: V^T stores the keys of each group of 8 in
//   the order 0 2 4 6 1 3 5 7, and P needs no shuffle. P_hi and P_lo are
//   split in registers.
// - Shared memory sets the tiles (227 KB a CTA): Q as hi + lo is 8 bytes a
//   float, the split K/V set four BN x D fp32 tiles and each raw stage two.
//     D  NW BM  BN  stages  Q hi+lo  split set  raw ring   total
//     32  2 128 64   2       32 KB    32 KB      32 KB      97 KB
//     64  2 128 64   2       64 KB    64 KB      64 KB     193 KB
//    128  2 128 32   1      128 KB    64 KB      32 KB     225 KB
//    256  1  64 16   1      128 KB    64 KB      32 KB     225 KB
//   At D 128 and 256 one raw stage suffices: it is free again after the
//   split pass, so the next tile loads during the whole of this one's
//   products and softmax. D 256 keeps one warpgroup: 128 accumulator
//   registers a thread for O leave no room for a second 64-row Q, and its
//   P.V goes in two halves of 128 columns.
// - The softmax is the bf16 kernel's: ex2.approx in the log2 domain, O
//   rescaled only when the max moved, masks only on the blocks that cross
//   the diagonal, the window's edge or Skv, the softcap a template
//   argument. GQA reads kv head h / (H / Hkv); nothing is repeated in
//   memory.
// - The output goes through shared memory (Q_hi's space) so the stores to
//   device memory are 16-byte and coalesced.
// - When the caller passes an lse buffer, the lane that holds a row's sum
//   also writes the row's logsumexp, m + log l (natural log, fp32), which
//   the backward (csrc/flash_attn_bwd.cu) recomputes P from; a null buffer
//   skips the store.

#include "flash_common.cuh"

namespace {

constexpr int kW = 128;   // bytes an atom row of Q, K and raw V: 32 floats

template <int D>
struct Cfg {
  static constexpr int NW = D >= 256 ? 1 : 2;            // consumer warpgroups
  static constexpr int kThreads = 128 * NW;
  static constexpr int BM = 64 * NW;                     // query rows a CTA
  static constexpr int BN = D >= 256 ? 16 : D >= 128 ? 32 : 64;   // keys a tile
  static constexpr int kStages = D >= 128 ? 1 : 2;       // raw K/V ring
  static constexpr int WV = BN * 4 >= 128 ? 128 : BN * 4;  // V^T atom row bytes
  static constexpr int kLayoutV = WV == 128 ? 1 : 2;     // B128 or B64
  static constexpr int kQBytes = BM * D * 4;
  static constexpr int kTile = BN * D * 4;
  static constexpr size_t kSmem = 2 * kQBytes + (4 + 2 * kStages) * kTile + 1024;
};

template <int D, bool kSoftcap>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_f32_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                    int Hkv, int S, int Skv,
                     float scale, float cap_in, float softcap, int causal,
                     int window) {
  using C = Cfg<D>;
  constexpr int NW = C::NW, BM = C::BM, BN = C::BN, WV = C::WV;
  constexpr int T = C::kThreads, QB = C::kQBytes, TB = C::kTile;
  // byte offsets in shared memory: Q_hi (TMA lands raw Q here), Q_lo, the
  // split set K_hi, K_lo, V_hi^T, V_lo^T, then the raw K/V ring
  constexpr uint32_t oQH = 0, oQL = QB, oKH = 2 * QB, oKL = oKH + TB,
                     oVH = oKL + TB, oVL = oVH + TB, oRaw = oVL + TB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;

  // the k-blocks some row of this CTA may attend
  const int k_end = causal ? min(Skv, q0 + BM) : Skv;
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kb0 = k_begin / BN, kb1 = (k_end + BN - 1) / BN;

  // raw K/V tile kb goes to stage (kb - kb0) % kStages and completes its
  // stage's barrier; Q rides with the first tile. One thread issues the
  // copies, one box an atom column.
  auto load_kv = [&](int kb) {
    if (tid != 0 || kb >= kb1) return;
    const int st = (kb - kb0) % C::kStages, k0 = kb * BN;
    const uint32_t bar = smem_u32(&full[st]);
    const uint32_t rk = base + oRaw + st * 2 * TB, rv = rk + TB;
    mbar_expect_tx(bar, 2 * TB + (kb == kb0 ? QB : 0));
    if (kb == kb0)
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
        tma_load(base + oQH + a * (BM * kW), &tq, bar, a * 32, h, q0, b);
#pragma unroll
    for (int a = 0; a < D / 32; ++a) {
      tma_load(rk + a * (BN * kW), &tk, bar, a * 32, hk, k0, b);
      tma_load(rv + a * (BN * kW), &tv, bar, a * 32, hk, k0, b);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < C::kStages; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::kStages; ++i) load_kv(kb0 + i);

  // elementwise split of `bytes` of fp32 at src (times mul) into hi and lo
  // tiles of the same layout
  auto split_tile = [&](uint32_t src, uint32_t hi, uint32_t lo, int bytes,
                        float mul) {
    for (int i = tid * 16; i < bytes; i += T * 16) {
      float4 x = *reinterpret_cast<const float4*>(smem + src + i);
      x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
      float4 xh, xl;
      split4(x, xh, xl);
      *reinterpret_cast<float4*>(smem + hi + i) = xh;
      *reinterpret_cast<float4*>(smem + lo + i) = xl;
    }
  };
  // raw V (BN keys x D) -> V_hi^T, V_lo^T (D rows x BN keys, K-major for
  // P.V). Item (gi, c): keys 8(gi/2) + gi%2 + {0, 2, 4, 6}, which are k
  // indices 4gi..4gi+3 (see the header), at d 4c..4c+3: four 16-byte loads,
  // a 4x4 transpose in registers, 16-byte stores to chunk gi of four rows.
  auto split_v = [&](uint32_t src) {
    constexpr int G = BN / 4;
    for (int it = tid; it < G * (D / 4); it += T) {
      const int gi = it % G, c = it / G;
      const int j0 = 8 * (gi >> 1) + (gi & 1);
      float4 x[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        x[m] = *reinterpret_cast<const float4*>(
            smem + src + swz_offset<kW, BN>(j0 + 2 * m, c));
      const float4 rows[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                              make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                              make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                              make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float4 xh, xl;
        split4(rows[dd], xh, xl);
        const uint32_t off = swz_offset<WV, D>(4 * c + dd, gi);
        *reinterpret_cast<float4*>(smem + oVH + off) = xh;
        *reinterpret_cast<float4*>(smem + oVL + off) = xl;
      }
    }
  };
  // descriptors of k-step kk (8 floats, 32 bytes) of this warpgroup's Q
  // rows, of a K tile, and of a V^T tile (8 keys) from row (d) row0
  auto q_desc = [&](uint32_t t, int kk) {
    return make_desc(base + t + (kk * 32 / kW) * (BM * kW) + (kk * 32) % kW +
                         wg * 64 * kW, 16, 8 * kW, 1);
  };
  auto k_desc = [&](uint32_t t, int kk) {
    return make_desc(base + t + (kk * 32 / kW) * (BN * kW) + (kk * 32) % kW, 16,
                     8 * kW, 1);
  };
  auto v_desc = [&](uint32_t t, int kk, int row0) {   // rows row0.. of V^T
    return make_desc(base + t + (kk * 32 / WV) * (D * WV) + row0 * WV +
                         (kk * 32) % WV, 16, 8 * WV, C::kLayoutV);
  };

  // this thread's two rows of the accumulators (wgmma's C layout: warp w of
  // the warpgroup holds rows 16w..16w+15; lane l rows l/4 and l/4 + 8 and
  // columns 8j + 2(l%4) + {0, 1})
  const int row_lo = q0 + 64 * wg + 16 * warp + lane / 4, row_hi = row_lo + 8;
  const int col_in = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float ml_lo = -INFINITY, ml_hi = -INFINITY;   // m log2(e), as rounded for p

  // issue order of the products: S0 S1 PV0 PV1, block after block; warpgroup
  // 1 hands warpgroup 0 the first turn, and keeps its last pass
  if constexpr (NW == 2)
    if (wg == 1 && kb0 < kb1) turn_pass(1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int st = (kb - kb0) % C::kStages;
    const int k0 = kb * BN;
    mbar_wait(smem_u32(&full[st]), ((kb - kb0) / C::kStages) & 1);   // tile kb landed
    __syncthreads();   // every warpgroup is done with tile kb - 1's split set
    if (kb == kb0) split_tile(oQH, oQH, oQL, QB, scale);
    split_tile(oRaw + st * 2 * TB, oKH, oKL, TB, 1.f);
    split_v(oRaw + st * 2 * TB + TB);
    fence_proxy_async();
    __syncthreads();   // the split set is written; the raw stage is free
    load_kv(kb + C::kStages);

    // S = Q.K^T, D/8 k-steps of each of hi.hi, hi.lo, lo.hi (see
    // Accumulation above): each k-step of hi.hi into a fresh accumulator,
    // summed here while the next runs, then the cross terms in one chain
    float s[BN / 2], sx[BN / 2], t[2][BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    if constexpr (NW == 2) turn_wait(wg);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_fence();
      wgmma_ss<BN>(t[kk & 1], q_desc(oQH, kk), k_desc(oKH, kk), 0);
      wgmma_commit();
      if (kk > 0) {   // k-step kk - 1 is done
        wgmma_wait<1>();
        fence_regs(t[(kk - 1) & 1]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] += t[(kk - 1) & 1][i];
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_ss<BN>(sx, q_desc(oQH, kk), k_desc(oKL, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_ss<BN>(sx, q_desc(oQL, kk), k_desc(oKH, kk), 1);
    wgmma_commit();
    if constexpr (NW == 2) turn_pass(wg);
    wgmma_wait<1>();
    fence_regs(t[(D / 8 - 1) & 1]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] += t[(D / 8 - 1) & 1][i];
    wgmma_wait<0>();
    fence_regs(sx);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] += sx[i];

    // softcap (q carries the scale); the softcap is a template argument and
    // the mask a loop of its own, so the common block pays for neither
    if constexpr (kSoftcap) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = softcap * tanhf(s[i] * cap_in);
    }
    // mask only the blocks that cross the diagonal, the window's edge or Skv
    if (k0 + BN > Skv || (causal && k0 + BN - 1 > q0) ||
        (window >= 0 && k0 <= q0 + BM - 1 - window)) {
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
    // the max in the log2 domain; a row with no key yet keeps max -inf and
    // exponents then use 0, giving p = 0
    const float ml_new_lo = mn_lo == -INFINITY ? 0.f : mn_lo * kLog2e;
    const float ml_new_hi = mn_hi == -INFINITY ? 0.f : mn_hi * kLog2e;
    if (mn_lo != m_lo) {
      const float alpha = ex2(ml_lo - ml_new_lo);
      l_lo *= alpha;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        acc[i] *= alpha;
        acc[i + 1] *= alpha;
      }
    }
    if (mn_hi != m_hi) {
      const float alpha = ex2(ml_hi - ml_new_hi);
      l_hi *= alpha;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        acc[i + 2] *= alpha;
        acc[i + 3] *= alpha;
      }
    }
    m_lo = mn_lo;
    m_hi = mn_hi;
    ml_lo = mn_lo == -INFINITY ? -INFINITY : ml_new_lo;
    ml_hi = mn_hi == -INFINITY ? -INFINITY : ml_new_hi;

    // p = exp2(x log2(e) - m log2(e)) in one rounding, so a logit near the
    // max keeps its bits however large it is; summed in fp32, then split.
    // The A fragment of k-step kk is (row g: key 8kk + 2t, row g + 8: same,
    // row g: key 8kk + 2t + 1, row g + 8: same), V^T's key order
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(s[4 * kk + e], kLog2e, (e & 2) ? -ml_new_hi : -ml_new_lo));
        if (e & 2) l_hi += p[e];
        else l_lo += p[e];
      }
      const float frag[4] = {p[0], p[2], p[1], p[3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hi = tf32_round(frag[e]);
        ph[kk][e] = __float_as_uint(hi);
        pl[kk][e] = __float_as_uint(tf32_round(frag[e] - hi));
      }
    }

    // O += P.V: BN/8 k-steps of each of hi.hi, hi.lo, lo.hi, into a fresh
    // accumulator of at most 128 columns (D 256 takes two, one after the
    // other: no registers for more), added to O here in fp32
    constexpr int DN = D < 128 ? D : 128;
    if constexpr (NW == 2) turn_wait(wg);
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += DN) {
      float pv[DN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        wgmma_rs<DN>(pv, ph[kk], v_desc(oVH, kk, c0), kk > 0);
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        wgmma_rs<DN>(pv, ph[kk], v_desc(oVL, kk, c0), 1);
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        wgmma_rs<DN>(pv, pl[kk], v_desc(oVH, kk, c0), 1);
      wgmma_commit();
      if constexpr (NW == 2)
        if (wg == 0 || kb + 1 < kb1) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) acc[c0 / 2 + i] += pv[i];
    }
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
    if (row_lo < S) lp[row_lo] = l_lo > 0.f ? m_lo + logf(l_lo) : -INFINITY;
    if (row_hi < S) lp[row_hi] = l_hi > 0.f ? m_hi + logf(l_hi) : -INFINITY;
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  // each warpgroup writes its own 64 rows of Q_hi's tile, which only its own
  // wgmmas read, then the CTA stores the tile with 16-byte stores
  const int r_lo = row_lo - q0, r_hi = r_lo + 8;
  const uint32_t in = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 2 * j + (lane % 4) / 2;
    *reinterpret_cast<float2*>(smem + oQH + swz_offset<kW, BM>(r_lo, c) + in) =
        make_float2(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
    *reinterpret_cast<float2*>(smem + oQH + swz_offset<kW, BM>(r_hi, c) + in) =
        make_float2(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
  }
  __syncthreads();
  constexpr int CH = D / 4;
  const long long q_stride = (long long)H * D;
  float* op = o + ((long long)b * S + q0) * q_stride + (long long)h * D;
  for (int i = tid; i < BM * CH; i += T) {
    const int r = i / CH, c = i % CH;
    if (q0 + r < S)
      *reinterpret_cast<float4*>(op + r * q_stride + c * 4) =
          *reinterpret_cast<const float4*>(smem + oQH + swz_offset<kW, BM>(r, c));
  }
}

template <int D, bool kSoftcap>
int launch_cap(const void* q, const void* k, const void* v, void* o, void* lse, int B,
               int H, int Hkv, int S, int Skv, float scale, int causal,
               int window, float softcap, cudaStream_t st) {
  using C = Cfg<D>;
  static bool configured = false;   // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<D, kSoftcap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, f32, 4, B, S, H, D, 32, C::BM, sw) ||
      !make_map(&tk, k, f32, 4, B, Skv, Hkv, D, 32, C::BN, sw) ||
      !make_map(&tv, v, f32, 4, B, Skv, Hkv, D, 32, C::BN, sw))
    return (int)cudaErrorInvalidValue;
  const float cap_in = kSoftcap ? 1.f / softcap : 0.f;
  const dim3 grid(B * H, (S + C::BM - 1) / C::BM);
  flash_f32_kernel<D, kSoftcap><<<grid, C::kThreads, C::kSmem, st>>>(
      tq, tk, tv, (float*)o, (float*)lse, H, Hkv, S, Skv, scale, cap_in, softcap, causal,
      window);
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

// q, o: (B, S, H, D); k, v: (B, Skv, Hkv, D); all fp32, contiguous, 16-byte
// aligned. H % Hkv == 0, D in {32, 64, 128, 256}. window < 0: no window;
// softcap <= 0: no softcap. lse: null, or (B, H, S) fp32 for each row's
// logsumexp (the backward's input; serving passes null and pays nothing).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int batch, int heads,
                              int kv_heads, int seq_q, int seq_kv,
                              int head_dim, float scale, int causal,
                              int window, float softcap, void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_kv <= 0 ||
      (seq_q + 63) / 64 > 65535)
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
