// Flash-attention backward for fp32 (sm_90a): dQ, dK and dV of o =
// softmax(mask(softcap(q*scale . k^T))) . v, from q, k, v, the forward's o,
// the output's gradient dO and the forward's row logsumexp; up to D 128 on
// Hopper's tensor cores in 3xTF32, at D 256 on fp32 FMAs. bf16 inputs go
// to csrc/flash_attn_bwd.cu, whose header states the function; this file
// computes the same one, P and dS kept in fp32, and holds the fp32 bound of
// kernels/ref.py::flash_attention_bwd_tol against the exact answer.
//
// Replaces: nothing on the TPU (the gradient of
// src/repro/kernels/flash_attn.py::_flash_kernel's function, which the
// reference takes by autodiff of its plain attention); it is the gradient
// of csrc/flash_attn.cu.
//
// Bound: five products of 2 * D flops a kept (query, key) pair, each three
// TF32 products (494.7 TFLOP/s dense on an H100 SXM, so 165 of fp32-accurate
// work), against reading q, k, v, o, dO once and writing dq, dk, dv: bound
// by the operations at the training shape.
//
// Arithmetic (csrc/flash_attn.cu's): each operand x is split into hi (x
// rounded to the nearest TF32) and lo = x - hi rounded to TF32, and each
// product a.b is taken as hi_a.hi_b + hi_a.lo_b + lo_a.hi_b on the TF32
// tensor cores with fp32 accumulation; P^T, dS^T (dK/dV) and dS (dQ) are
// split in registers. The tensor cores truncate every addend of a k-step
// below the largest one's last bit, so no accumulator runs long: S and dP
// (D / 8 k-steps) keep hi.hi, hi.lo and lo.hi in three accumulators, summed
// as hi.hi + (hi.lo + lo.hi); dK, dV and dQ take each streamed tile's
// product in a fresh accumulator and add it to their fp32 sums in registers
// (accumulating across tiles on the tensor cores was hardly faster on the
// H100 and lay several times further from the exact answer). Every sum has
// a fixed order: the same bytes every call, no atomics.
//
// Design (three launches in stream order):
// (a) bwd_prep_f32_kernel: D_i = dO_i . o_i in fp32 and lse times log2(e),
//     (B, H, Sp) with Sp = S rounded up to 128, as the bf16 path's prep.
// (b) dkdv_tf32_kernel: one CTA a (batch, kv head, 64 keys), GQA summed in
//     the CTA over the group's query heads and the query tiles of 32
//     queries that the causal band and the window leave.
// (c) dq_tf32_kernel: one CTA a (batch, head, 64 queries), the longest rows
//     first, over the key tiles of 32 keys that the masks leave.
// - tf32 wgmma reads both shared-memory operands K-major only (no transpose
//   flag). S^T = K.Q^T, dP^T = V.dO^T (dK/dV) and S = Q.K^T, dP = dO.V^T
//   (dQ) contract over the head dim, along which the tiles arrive, so they
//   read the TMA layout (128-byte swizzle, atoms of 8 rows x 32 floats). dV
//   += P^T.dO and dK += dS^T.Q contract over queries and dQ += dS.K over
//   keys, so a split pass writes dO^T, Q^T (dK/dV) and K^T (dQ) with the
//   head dim along rows, as the forward writes V^T. The RS A fragment of a
//   k-step wants k indices t and t + 4 where the accumulator gives columns
//   2t and 2t + 1, so those transposed tiles keep each group of 8 in the
//   order 0 2 4 6 1 3 5 7 and the fragments need no shuffle.
// - The two warpgroups share the CTA's 64 rows (the M of one wgmma) and
//   split the head dim of dK, dV and dQ (D/2 columns each, D/4 fp32 a
//   thread). Warpgroup 0 takes S^T (S), warpgroup 1 dP^T (dP), each over
//   all D columns, and they swap the fp32 results through shared memory in
//   the accumulator layout; both then compute P and dS, identically, and
//   each runs its half of the RS products. No product is done twice.
// - Each warpgroup keeps its resident A's hi (K_hi or V_hi; Q_hi or dO_hi)
//   in registers as RS fragments (D/2 a thread), split there from the raw
//   tile, whose place then takes the lo that the lo.hi term reads; so the
//   resident set is two 64 x D tiles, not four.
// - Shared memory sets the tile of 32 rows (227 KiB a CTA): at D 128 the
//   resident lo tiles take 64 KiB, a dK/dV split set (Q, dO, Q^T, dO^T, hi
//   and lo) 128 KiB, the swap 16 KiB: 209 KiB (dQ: K, V, K^T, 96 KiB; 177
//   KiB). Tiles of 16 rows, which would leave room for a ring of raw tiles
//   or a second split set, were slower on the H100: a tf32 wgmma of N 16
//   costs nearly what one of N 32 does. So TMA writes a tile's raw
//   values into its hi tiles, the split pass (every thread; each thread's
//   loads before its stores) rounds them in place and writes lo and the
//   transposes, and the next tile's copies start once S and dP have read
//   the hi tiles (after the swap), landing during the softmax and the RS
//   products.
//   At D 256 the resident lo tiles and one split set alone are 384 KiB, so
//   D 256 takes the FMA kernels below (a compile-time choice): dot_kernel,
//   dkdv_kernel and dq_kernel, every tile fp32 in shared memory with rows
//   padded by one float, each thread of a 16 x 16 grid owning the entries
//   (ty + 16a, tx + 16c) of a product's output, tiles of 32.
// - The softmax is the bf16 path's: ex2.approx in the log2 domain, masks
//   only on the tiles that cross the diagonal, the window's edge, S or Skv,
//   the softcap a template argument; bands outside the masks are skipped.
// - The outputs go through shared memory (split-set tiles, which no product
//   reads after the last tile) so the stores are 16-byte.

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;   // two consumer warpgroups; the FMA kernels' 16 x 16 grid
constexpr int kW = 128;         // bytes an atom row of a TMA-layout tile: 32 floats
constexpr int kR = 64;          // a CTA's keys (dK/dV) or queries (dQ)

template <int D>
struct F32 {
  static constexpr int BT = 32;                   // a streamed tile's rows
  static constexpr int DH = D / 2;                // output columns a warpgroup
  static constexpr int WT = 128;                  // transposed tiles' atom row bytes
  static constexpr int kRes = kR * D * 4;    // one resident tile
  static constexpr int kTile = BT * D * 4;   // one streamed tile
  static constexpr int kSwap = 2 * 128 * (BT / 2) * 4;
  // dK/dV: resident K_lo, V_lo; the split set Q, dO (raw Q, dO land in their
  // hi), Q^T, dO^T, hi and lo; the raw and the split set's lse and D
  static constexpr size_t kDkvSmem = 2 * kRes + 8 * kTile + 4 * BT * 4 + kSwap + 1024;
  // dQ: resident Q_lo, dO_lo; the split set K, V (raw K, V land in their hi),
  // K^T, hi and lo
  static constexpr size_t kDqSmem = 2 * kRes + 6 * kTile + kSwap + 1024;
};

// ---- 3xTF32 on wgmma (D 32, 64, 128) -----------------------------------------

// D_i = dO_i . o_i and lse * log2(e), as csrc/flash_attn_bwd.cu's
// bwd_prep_kernel for fp32 rows: one warp a row of (B, H, Sp), 16 bytes a lane
__global__ void __launch_bounds__(256)
    bwd_prep_f32_kernel(const float* __restrict__ dout, const float* __restrict__ o,
                        const float* __restrict__ lse, float* __restrict__ lse2,
                        float* __restrict__ delta, long long rows, int S, int Sp, int H, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = (int)(row % Sp);
  const long long bh = row / Sp;
  float acc = 0.f;
  if (s < S && lane < D / 4) {
    const long long at = ((bh / H * S + s) * H + bh % H) * D + lane * 4;
    const float4 x = *reinterpret_cast<const float4*>(dout + at);
    const float4 y = *reinterpret_cast<const float4*>(o + at);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    lse2[row] = s < S ? lse[bh * S + s] * kLog2e : INFINITY;
    delta[row] = acc;
  }
}

// elementwise split of BYTES of fp32 at `src` into hi and lo tiles of the
// same layout (src may be hi), by NT threads of which this is thread t; all
// loads are issued before the first store, which the compiler may not move
// past a store to shared memory on its own
template <int BYTES, int NT>
__device__ __forceinline__ void split_tile(uint8_t* smem, uint32_t src, uint32_t hi,
                                           uint32_t lo, int t) {
  constexpr int PER = BYTES / 16 / NT;
  static_assert(PER * 16 * NT == BYTES, "a whole number of chunks a thread");
  float4 x[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r)
    x[r] = *reinterpret_cast<const float4*>(smem + src + (t + r * NT) * 16);
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    float4 xh, xl;
    split4(x[r], xh, xl);
    *reinterpret_cast<float4*>(smem + hi + (t + r * NT) * 16) = xh;
    *reinterpret_cast<float4*>(smem + lo + (t + r * NT) * 16) = xl;
  }
}

// a raw tile (BT rows x D, TMA layout) -> hi and lo in the TMA layout (at
// rhi, rlo; rhi may be src) and its transpose split into hi and lo (at hi,
// lo: D rows x BT, K-major with WT-byte atom rows), by NT threads of which
// this is thread t. Item (gi, c): rows 8(gi/2) + gi%2 + {0, 2, 4, 6}, which
// are k indices 4gi..4gi+3 (see the header), at d 4c..4c+3: four 16-byte
// loads (a thread's items' loads all before its first store), their splits
// stored, a 4x4 transpose in registers, 16-byte stores to chunk gi of four
// rows.
template <int D, int BT, int WT, int NT>
__device__ __forceinline__ void split_t(uint8_t* smem, uint32_t src, uint32_t rhi,
                                        uint32_t rlo, uint32_t hi, uint32_t lo, int t) {
  constexpr int G = BT / 4, ITEMS = G * (D / 4), PER = (ITEMS + NT - 1) / NT;
  float4 x[PER][4];
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int it = t + r * NT, gi = it % G, c = it / G;
    const int j0 = 8 * (gi >> 1) + (gi & 1);
    if (it < ITEMS)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        x[r][m] =
            *reinterpret_cast<const float4*>(smem + src + swz_offset<kW, BT>(j0 + 2 * m, c));
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int it = t + r * NT, gi = it % G, c = it / G;
    const int j0 = 8 * (gi >> 1) + (gi & 1);
    if (it >= ITEMS) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t off = swz_offset<kW, BT>(j0 + 2 * m, c);
      float4 xh, xl;
      split4(x[r][m], xh, xl);
      *reinterpret_cast<float4*>(smem + rhi + off) = xh;
      *reinterpret_cast<float4*>(smem + rlo + off) = xl;
    }
    const float4 rows[4] = {make_float4(x[r][0].x, x[r][1].x, x[r][2].x, x[r][3].x),
                            make_float4(x[r][0].y, x[r][1].y, x[r][2].y, x[r][3].y),
                            make_float4(x[r][0].z, x[r][1].z, x[r][2].z, x[r][3].z),
                            make_float4(x[r][0].w, x[r][1].w, x[r][2].w, x[r][3].w)};
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float4 xh, xl;
      split4(rows[dd], xh, xl);
      const uint32_t off = swz_offset<WT, D>(4 * c + dd, gi);
      *reinterpret_cast<float4*>(smem + hi + off) = xh;
      *reinterpret_cast<float4*>(smem + lo + off) = xl;
    }
  }
}

// a resident raw 64-row tile in the TMA layout, split by the warpgroup that
// takes it as its A operand: its hi as this thread's A fragments, k steps 0
// .. D/8 - 1 ((row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the
// warp's 16 rows), its lo written over the raw values in place (each
// element is one thread's)
template <int D>
__device__ __forceinline__ void split_frags(uint8_t* smem, uint32_t tile,
                                            uint32_t (&a)[D / 8][4], int warp, int lane) {
  const int r = 16 * warp + lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + (e & 1) * 8, col = 8 * kk + t + (e >> 1) * 4;
      float* p = reinterpret_cast<float*>(smem + tile + swz_offset<kW, kR>(row, col / 4) +
                                          (col % 4) * 4);
      const float x = *p, h = tf32_round(x);
      a[kk][e] = __float_as_uint(h);
      *p = tf32_round(x - h);
    }
}

// issue x = A.B^T over the head dim in 3xTF32 (the caller waits): A (64
// rows) hi from registers (ah) and lo at al, B (BT rows) hi/lo at bh/bl, both
// in the TMA layout. hi.hi (x), hi.lo (xc) and lo.hi (xd) each take an
// accumulator of their own, issued in turn k-step by k-step; the caller
// sums them as hi.hi + (hi.lo + lo.hi)
template <int D, int BT>
__device__ __forceinline__ void issue_3x(float (&x)[BT / 2], float (&xc)[BT / 2],
                                         float (&xd)[BT / 2], const uint32_t (&ah)[D / 8][4],
                                         uint32_t al, uint32_t bh, uint32_t bl) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_rs<BT>(x, ah[kk], kmajor_desc<kW, BT>(bh, kk, 0), kk > 0);
    wgmma_rs<BT>(xc, ah[kk], kmajor_desc<kW, BT>(bl, kk, 0), kk > 0);
    wgmma_ss<BT>(xd, kmajor_desc<kW, kR>(al, kk, 0), kmajor_desc<kW, BT>(bh, kk, 0), kk > 0);
  }
  wgmma_commit();
}

// t = A.B over a streamed tile's BT rows in 3xTF32, in a fresh accumulator
// (hi.hi, then hi.lo, then lo.hi), issued and waited for: A from registers
// (hi, lo fragments), B a transposed tile hi/lo at bh/bl, rows row0 .. row0
// + N - 1
template <int D, int BT, int WT, int N>
__device__ __forceinline__ void rs_3x(float (&t)[N / 2], const uint32_t (&ah)[BT / 8][4],
                                      const uint32_t (&al)[BT / 8][4], uint32_t bh, uint32_t bl,
                                      int row0) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk)
    wgmma_rs<N>(t, ah[kk], kmajor_desc<WT, D>(bh, kk, row0), kk > 0);
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk)
    wgmma_rs<N>(t, ah[kk], kmajor_desc<WT, D>(bl, kk, row0), 1);
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk)
    wgmma_rs<N>(t, al[kk], kmajor_desc<WT, D>(bh, kk, row0), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(t);
}

// the A fragments of k-steps 0 .. BT/8 - 1 from an accumulator x (elements
// 4kk..4kk+3: rows g, g, g+8, g+8; columns 2t, 2t+1), split: (g, 2t),
// (g+8, 2t), (g, 2t+1), (g+8, 2t+1), k indices t, t, t+4, t+4
template <int BT>
__device__ __forceinline__ void split_frags_acc(const float (&x)[BT / 2],
                                                uint32_t (&hi)[BT / 8][4],
                                                uint32_t (&lo)[BT / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk) {
    const float f[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1], x[4 * kk + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32_round(f[e]);
      hi[kk][e] = __float_as_uint(h);
      lo[kk][e] = __float_as_uint(tf32_round(f[e] - h));
    }
  }
}

// dK and dV: one CTA of two warpgroups a (batch, kv head, 64-key block),
// warpgroup wg owning columns DH wg .. + DH - 1; blockIdx.y counts the key
// blocks from the first, whose column is the longest under the causal mask.
template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_tf32_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Hkv, int S, int Skv, int Sp, float scale,
                     float scale_log2, float cap_in, float cap_out, int causal, int window) {
  using C = F32<D>;
  constexpr int BT = C::BT, DH = C::DH, WT = C::WT;
  constexpr uint32_t RES = C::kRes, TL = C::kTile;
  // byte offsets: K_lo (raw K lands here), V_lo (raw V); the split set: Q_hi
  // (raw Q lands here), Q_lo, dO_hi (raw dO), dO_lo, Q^T hi, lo, dO^T hi,
  // lo; the tile's lse and D as they land and as the softmax reads them; the
  // swap
  constexpr uint32_t oKL = 0, oVL = RES, oQH = 2 * RES, oQL = oQH + TL, oOH = oQL + TL,
                     oOL = oOH + TL, oQTH = oOL + TL, oQTL = oQTH + TL, oOTH = oQTL + TL,
                     oOTL = oOTH + TL, oRL = oOTL + TL, oRD = oRL + BT * 4, oL = oRD + BT * 4,
                     oD = oL + BT * 4, oSw = oD + BT * 4;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = warpgroup_index(), warp = (tid % 128) / 32,
            lane = tid % 32;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * kR;

  // the query tiles some key of the CTA is kept for: i >= j (causal) and
  // i < j + window; each query head of the group visits them in turn
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window >= 0 ? min(S, k0 + kR - 1 + window) : S;
  const int qt0 = i_lo / BT, nq = i_hi > i_lo ? (i_hi + BT - 1) / BT - qt0 : 0;
  const int n = G * nq;   // (query head, query tile) pairs

  // pair it's raw Q, dO into Q_hi, dO_hi, its lse and D beside; K and V ride
  // with the first. Lane 0 of each warp of warpgroup 0 issues a share of the
  // copies (warp 0 also the barrier's byte count), so that no one warp
  // waits on all of them.
  auto load = [&](int it) {
    if (tid % 32 != 0 || tid >= 128 || it >= n) return;
    const int h = hk * G + it / nq, q0 = (qt0 + it % nq) * BT;
    const uint32_t bar = smem_u32(&full);
    if (warp == 0) {
      mbar_expect_tx(bar, 2 * TL + 2 * BT * 4 + (it == 0 ? 2 * RES : 0));
      if (it == 0)
#pragma unroll
        for (int a = 0; a < D / 32; ++a) {
          tma_load(base + oKL + a * (kR * kW), &tk, bar, a * 32, hk, k0, b);
          tma_load(base + oVL + a * (kR * kW), &tv, bar, a * 32, hk, k0, b);
        }
    } else if (warp == 1) {
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
        tma_load(base + oQH + a * (BT * kW), &tq, bar, a * 32, h, q0, b);
    } else if (warp == 2) {
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
        tma_load(base + oOH + a * (BT * kW), &tdo, bar, a * 32, h, q0, b);
    } else {
      const long long at = ((long long)b * H + h) * Sp + q0;
      bulk_load(base + oRL, lse2 + at, BT * 4, bar);
      bulk_load(base + oRD, delta + at, BT * 4, bar);
    }
  };
  if (tid == 0) {
    mbar_init(smem_u32(&full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load(0);

  // this thread's two keys (rows of S^T); its query columns are
  // 8c + col_in + {0, 1} of the tile
  const int key_lo = k0 + 16 * warp + lane / 4, key_hi = key_lo + 8;
  const int col_in = 2 * (lane % 4);
  float acc_k[DH / 2], acc_v[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  uint32_t ah[D / 8][4];   // K_hi (warpgroup 0) or V_hi (1) as A fragments
  const float* lt = reinterpret_cast<const float*>(smem + oL);
  const float* dt = reinterpret_cast<const float*>(smem + oD);

  for (int it = 0; it < n; ++it) {
    const int q0 = (qt0 + it % nq) * BT;
    mbar_wait(smem_u32(&full), it & 1);
    // the split: K (warpgroup 0) or V (1) once, hi to registers and lo in
    // place; then warpgroup 0 splits Q, 1 splits dO, hi in place
    if (it == 0) split_frags<D>(smem, wg ? oVL : oKL, ah, warp, lane);
    split_t<D, BT, WT, 128>(smem, wg ? oOH : oQH, wg ? oOH : oQH, wg ? oOL : oQL,
                            wg ? oOTH : oQTH, wg ? oOTL : oQTL, tid % 128);
    if (tid < BT) {
      reinterpret_cast<float*>(smem + oL)[tid] = reinterpret_cast<const float*>(smem + oRL)[tid];
      reinterpret_cast<float*>(smem + oD)[tid] = reinterpret_cast<const float*>(smem + oRD)[tid];
    }
    fence_proxy_async();
    __syncthreads();   // the split set is written

    // S^T = K.Q^T (warpgroup 0) and dP^T = V.dO^T (warpgroup 1), keys along
    // M; then they swap, and the next pair may land
    float x[BT / 2], xc[BT / 2], xd[BT / 2], s[BT / 2], dp[BT / 2];
    issue_3x<D, BT>(x, xc, xd, ah, base + (wg ? oVL : oKL), base + (wg ? oOH : oQH),
                    base + (wg ? oOL : oQL));
    wgmma_wait<0>();
    fence_regs(x);
    fence_regs(xc);
    fence_regs(xd);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) x[i] += xc[i] + xd[i];
    swap_products(x, s, dp, reinterpret_cast<float*>(smem + oSw), wg, tid % 128);
    load(it + 1);

    // P^T and dS^T in fp32; only the tiles that cross the diagonal, the
    // window's edge, S or Skv test the masks
    const bool edge = k0 + kR > Skv || q0 + BT > S || (causal && k0 + kR - 1 > q0) ||
                      (window >= 0 && k0 <= q0 + BT - 1 - window);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int c = 8 * (i / 4) + col_in + (i & 1);
      float th = 0.f;
      const float t = kSoftcap ? cap_out * (th = tanhf(s[i] * cap_in)) : s[i] * scale_log2;
      float p = ex2(t - lt[c]);
      if (edge) {
        const int key = (i & 2) ? key_hi : key_lo, row = q0 + c;
        if (!(key < Skv && row < S && (!causal || key <= row) &&
              (window < 0 || key > row - window)))
          p = 0.f;
      }
      const float dl = dt[c];
      float ds = p * (dp[i] - dl);
      if (kSoftcap) ds *= 1.f - th * th;
      s[i] = p;
      dp[i] = ds;
    }

    // dV (this warpgroup's columns) += P^T.dO, then dK += dS^T.Q, the A
    // fragments split from P^T and dS^T, each tile's product in a fresh
    // accumulator added to the sum here in fp32
    {
      uint32_t fh[BT / 8][4], fl[BT / 8][4];
      float t[DH / 2];
      split_frags_acc<BT>(s, fh, fl);
      rs_3x<D, BT, WT, DH>(t, fh, fl, base + oOTH, base + oOTL, wg * DH);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc_v[i] += t[i];
      split_frags_acc<BT>(dp, fh, fl);
      rs_3x<D, BT, WT, DH>(t, fh, fl, base + oQTH, base + oQTL, wg * DH);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc_k[i] += t[i];
    }
    __syncthreads();   // both warpgroups are done with the split set
  }

  // dK (times scale) into Q_hi's tiles and dV into Q^T's (64 x D each), each
  // warpgroup its columns, then 16-byte stores
  const uint32_t oK = oQH, oV = oQTH;
  const int r_lo = key_lo - k0, r_hi = r_lo + 8;
  const uint32_t in = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = wg * (DH / 4) + 2 * j + (lane % 4) / 2;
    const uint32_t lo = swz_offset<kW, kR>(r_lo, c) + in, hi = swz_offset<kW, kR>(r_hi, c) + in;
    *reinterpret_cast<float2*>(smem + oK + lo) =
        make_float2(acc_k[4 * j] * scale, acc_k[4 * j + 1] * scale);
    *reinterpret_cast<float2*>(smem + oK + hi) =
        make_float2(acc_k[4 * j + 2] * scale, acc_k[4 * j + 3] * scale);
    *reinterpret_cast<float2*>(smem + oV + lo) = make_float2(acc_v[4 * j], acc_v[4 * j + 1]);
    *reinterpret_cast<float2*>(smem + oV + hi) = make_float2(acc_v[4 * j + 2], acc_v[4 * j + 3]);
  }
  __syncthreads();
  constexpr int CH = D / 4;
  const long long ks = (long long)Hkv * D;
  const long long at = ((long long)b * Skv + k0) * ks + (long long)hk * D;
  for (int i = tid; i < kR * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    if (k0 + r < Skv) {
      const uint32_t off = swz_offset<kW, kR>(r, c);
      *reinterpret_cast<float4*>(dk + at + r * ks + c * 4) =
          *reinterpret_cast<const float4*>(smem + oK + off);
      *reinterpret_cast<float4*>(dv + at + r * ks + c * 4) =
          *reinterpret_cast<const float4*>(smem + oV + off);
    }
  }
}

// dQ: one CTA of two warpgroups a (batch, head, 64-query block), the
// longest rows first, warpgroup wg owning columns DH wg .. + DH - 1
template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse2, const float* __restrict__ delta,
                   float* __restrict__ dq, int H, int Hkv, int S, int Skv, int Sp, float scale,
                   float scale_log2, float cap_in, float cap_out, int causal, int window) {
  using C = F32<D>;
  constexpr int BT = C::BT, DH = C::DH, WT = C::WT;
  constexpr uint32_t RES = C::kRes, TL = C::kTile;
  // byte offsets: Q_lo (raw Q lands here), dO_lo (raw dO); the split set:
  // K_hi (raw K lands here), K_lo, V_hi (raw V), V_lo, K^T hi, lo; the swap
  constexpr uint32_t oQL = 0, oOL = RES, oKH = 2 * RES, oKL = oKH + TL, oVH = oKL + TL,
                     oVL = oVH + TL, oKTH = oVL + TL, oKTL = oKTH + TL, oSw = oKTL + TL;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = warpgroup_index(), warp = (tid % 128) / 32,
            lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kR;

  // the key tiles some row of the CTA keeps: j <= i (causal), j > i - window
  const int k_end = causal ? min(Skv, q0 + kR) : Skv;
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kb0 = k_begin / BT, kb1 = k_end > k_begin ? (k_end + BT - 1) / BT : kb0;

  // key tile kb's raw K, V into K_hi, V_hi; Q and dO ride with the first.
  // Lane 0 of three warps of warpgroup 0 issues a share of the copies (warp
  // 0 also the barrier's byte count).
  auto load = [&](int kb) {
    if (tid % 32 != 0 || tid >= 96 || kb >= kb1) return;
    const int k0 = kb * BT;
    const uint32_t bar = smem_u32(&full);
    if (warp == 0) {
      mbar_expect_tx(bar, 2 * TL + (kb == kb0 ? 2 * RES : 0));
      if (kb == kb0)
#pragma unroll
        for (int a = 0; a < D / 32; ++a) {
          tma_load(base + oQL + a * (kR * kW), &tq, bar, a * 32, h, q0, b);
          tma_load(base + oOL + a * (kR * kW), &tdo, bar, a * 32, h, q0, b);
        }
    } else if (warp == 1) {
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
        tma_load(base + oKH + a * (BT * kW), &tk, bar, a * 32, hk, k0, b);
    } else {
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
        tma_load(base + oVH + a * (BT * kW), &tv, bar, a * 32, hk, k0, b);
    }
  };
  if (tid == 0) {
    mbar_init(smem_u32(&full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load(kb0);

  // this thread's two rows of the accumulators with their lse (log2
  // domain) and D_i, fixed over the key tiles
  const int row_lo = q0 + 16 * warp + lane / 4, row_hi = row_lo + 8;
  const int col_in = 2 * (lane % 4);
  const long long bh = ((long long)b * H + h) * Sp;
  const float l_lo = lse2[bh + row_lo], l_hi = lse2[bh + row_hi];
  const float d_lo = delta[bh + row_lo], d_hi = delta[bh + row_hi];
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  uint32_t ah[D / 8][4];   // Q_hi (warpgroup 0) or dO_hi (1) as A fragments

  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BT;
    mbar_wait(smem_u32(&full), (kb - kb0) & 1);
    // the split: Q (warpgroup 0) or dO (1) once, hi to registers and lo in
    // place; then warpgroup 0 splits K (and its transpose), 1 splits V, hi
    // in place
    if (kb == kb0) split_frags<D>(smem, wg ? oOL : oQL, ah, warp, lane);
    split_t<D, BT, WT, kThreads>(smem, oKH, oKH, oKL, oKTH, oKTL, tid);
    split_tile<TL, kThreads>(smem, oVH, oVH, oVL, tid);
    fence_proxy_async();
    __syncthreads();   // the split set is written

    // S = Q.K^T (warpgroup 0) and dP = dO.V^T (warpgroup 1); then they swap,
    // and the next tile may land
    float x[BT / 2], xc[BT / 2], xd[BT / 2], s[BT / 2], dp[BT / 2];
    issue_3x<D, BT>(x, xc, xd, ah, base + (wg ? oOL : oQL), base + (wg ? oVH : oKH),
                    base + (wg ? oVL : oKL));
    wgmma_wait<0>();
    fence_regs(x);
    fence_regs(xc);
    fence_regs(xd);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) x[i] += xc[i] + xd[i];
    swap_products(x, s, dp, reinterpret_cast<float*>(smem + oSw), wg, tid % 128);
    load(kb + 1);

    // dS in fp32
    const bool edge = k0 + BT > Skv || (causal && k0 + BT - 1 > q0) ||
                      (window >= 0 && k0 <= q0 + kR - 1 - window);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      float th = 0.f;
      const float t = kSoftcap ? cap_out * (th = tanhf(s[i] * cap_in)) : s[i] * scale_log2;
      float p = ex2(t - ((i & 2) ? l_hi : l_lo));
      if (edge) {
        const int row = (i & 2) ? row_hi : row_lo, col = k0 + 8 * (i / 4) + col_in + (i & 1);
        if (!(col < Skv && (!causal || col <= row) && (window < 0 || col > row - window)))
          p = 0.f;
      }
      const float dl = (i & 2) ? d_hi : d_lo;
      float ds = p * (dp[i] - dl);
      if (kSoftcap) ds *= 1.f - th * th;
      dp[i] = ds;
    }

    // dQ (this warpgroup's columns) += dS.K, the A fragments split from dS,
    // in a fresh accumulator over the tile added to the sum here in fp32
    uint32_t fh[BT / 8][4], fl[BT / 8][4];
    float xq[DH / 2];
    split_frags_acc<BT>(dp, fh, fl);
    rs_3x<D, BT, WT, DH>(xq, fh, fl, base + oKTH, base + oKTL, wg * DH);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] += xq[i];
    __syncthreads();   // both warpgroups are done with K^T
  }

  // dQ (times scale) into K_hi's and K_lo's tiles (64 x D), each warpgroup
  // its columns, then 16-byte stores
  const uint32_t oQ = oKH;
  const int r_lo = row_lo - q0, r_hi = r_lo + 8;
  const uint32_t in = (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = wg * (DH / 4) + 2 * j + (lane % 4) / 2;
    *reinterpret_cast<float2*>(smem + oQ + swz_offset<kW, kR>(r_lo, c) + in) =
        make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<float2*>(smem + oQ + swz_offset<kW, kR>(r_hi, c) + in) =
        make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
  __syncthreads();
  constexpr int CH = D / 4;
  const long long qs = (long long)H * D;
  float* out = dq + ((long long)b * S + q0) * qs + (long long)h * D;
  for (int i = tid; i < kR * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    if (q0 + r < S)
      *reinterpret_cast<float4*>(out + r * qs + c * 4) =
          *reinterpret_cast<const float4*>(smem + oQ + swz_offset<kW, kR>(r, c));
  }
}

template <int D, bool kSoftcap>
int launch_tf32(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H,
                int Hkv, int S, int Skv, float scale, int causal, int window, float softcap,
                cudaStream_t st) {
  using C = F32<D>;
  static bool dkdv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(dkdv_tf32_kernel<D, kSoftcap>, C::kDkvSmem, dkdv_ok);
  if (e == cudaSuccess)
    e = allow_smem(dq_tf32_kernel<D, kSoftcap>, C::kDqSmem, dq_ok);
  if (e != cudaSuccess) return (int)e;
  const int Sp = (S + 127) / 128 * 128;
  float* lse2 = scratch;
  float* delta = scratch + (long long)B * H * Sp;
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap q_rows, do_rows, k_rows, v_rows, q_tile, do_tile, k_tile, v_tile;
  if (!make_map(&q_rows, q, f32, 4, B, S, H, D, 32, kR, sw) ||
      !make_map(&do_rows, dout, f32, 4, B, S, H, D, 32, kR, sw) ||
      !make_map(&k_rows, k, f32, 4, B, Skv, Hkv, D, 32, kR, sw) ||
      !make_map(&v_rows, v, f32, 4, B, Skv, Hkv, D, 32, kR, sw) ||
      !make_map(&q_tile, q, f32, 4, B, S, H, D, 32, C::BT, sw) ||
      !make_map(&do_tile, dout, f32, 4, B, S, H, D, 32, C::BT, sw) ||
      !make_map(&k_tile, k, f32, 4, B, Skv, Hkv, D, 32, C::BT, sw) ||
      !make_map(&v_tile, v, f32, 4, B, Skv, Hkv, D, 32, C::BT, sw))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sp;
  bwd_prep_f32_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const float*)dout, (const float*)o, lse, lse2, delta, rows, S, Sp, H, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const float scale_log2 = scale * kLog2e;
  const float cap_in = kSoftcap ? scale / softcap : 0.f;
  const float cap_out = kSoftcap ? softcap * kLog2e : 0.f;
  dkdv_tf32_kernel<D, kSoftcap>
      <<<dim3(B * Hkv, (Skv + kR - 1) / kR), kThreads, C::kDkvSmem, st>>>(
          k_rows, v_rows, q_tile, do_tile, lse2, delta, (float*)dk, (float*)dv, H, Hkv, S,
          Skv, Sp, scale, scale_log2, cap_in, cap_out, causal, window);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dq_tf32_kernel<D, kSoftcap>
      <<<dim3(B * H, (S + kR - 1) / kR), kThreads, C::kDqSmem, st>>>(
          q_rows, do_rows, k_tile, v_tile, lse2, delta, (float*)dq, H, Hkv, S, Skv, Sp, scale,
          scale_log2, cap_in, cap_out, causal, window);
  return (int)cudaGetLastError();
}

// ---- fp32 FMAs (D 256) -----------------------------------------------------

constexpr int kBT = 32;            // queries or keys a tile
constexpr int kLD = 256 + 1;       // a Q/K/V/dO tile's padded row
constexpr int kLB = kBT + 1;       // a P/dS tile's padded row
constexpr int kTR = kBT / 16;      // tile rows a thread
constexpr int kTD = 256 / 16;      // head-dim columns a thread
// K, V, Q, dO; P, dS; lse, D
constexpr size_t kFmaSmem = (4 * kBT * kLD + 2 * kBT * kLB + 2 * kBT) * sizeof(float);

// rows r0 .. r0 + kBT - 1 of one head of a (B, rows, heads, 256) tensor into
// a padded tile; rows past `rows` as zeros. `src` points at (b, 0, h, 0).
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long row_stride, int r0, int rows) {
  for (int e = threadIdx.x; e < kBT * 256; e += kThreads) {
    const int r = e / 256, c = e % 256;
    dst[r * kLD + c] = r0 + r < rows ? src[(long long)(r0 + r) * row_stride + c] : 0.f;
  }
}

// c[a][b] += sum_k A(ty + 16a, k) * B(k, tx + 16b): A(r, k) at
// A[r * ARS + k * AKS], B(k, col) at B[k * BKS + col * BCS]; fp32 FMAs in
// k order.
template <int RA, int RB, int K, int ARS, int AKS, int BKS, int BCS>
__device__ __forceinline__ void mma(float (&c)[RA][RB], const float* A, const float* B,
                                    int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RA], bv[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + 16 * a) * ARS + k * AKS];
#pragma unroll
    for (int b = 0; b < RB; ++b) bv[b] = B[k * BKS + (tx + 16 * b) * BCS];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) c[a][b] = fmaf(av[a], bv[b], c[a][b]);
  }
}

template <int RA, int RB>
__device__ __forceinline__ void zero(float (&c)[RA][RB]) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) c[a][b] = 0.f;
}

// S = Q.K^T and dP = dO.V^T over a (query tile, key tile), then P and dS
// of each of this thread's entries (rows il = ty + 16a, keys jl = tx + 16c
// of the tiles), written to sP (when given) and sS.
template <bool kSoftcap>
__device__ __forceinline__ void p_and_ds(const float* sQ, const float* sK, const float* sO,
                                         const float* sV, const float* sL, const float* sD,
                                         float* sP, float* sS, int q0, int k0, int S, int Skv,
                                         float scale, float softcap, int causal, int window,
                                         int ty, int tx) {
  float s[kTR][kTR], dp[kTR][kTR];
  zero(s);
  zero(dp);
  mma<kTR, kTR, 256, kLD, 1, 1, kLD>(s, sQ, sK, ty, tx);
  mma<kTR, kTR, 256, kLD, 1, 1, kLD>(dp, sO, sV, ty, tx);
#pragma unroll
  for (int a = 0; a < kTR; ++a) {
    const int il = ty + 16 * a, i = q0 + il;
#pragma unroll
    for (int c = 0; c < kTR; ++c) {
      const int jl = tx + 16 * c, j = k0 + jl;
      const float x = s[a][c] * scale;
      float t = x, th = 0.f;
      if (kSoftcap) {
        th = tanhf(x / softcap);
        t = softcap * th;
      }
      const bool keep = i < S && j < Skv && (!causal || j <= i) &&
                        (window < 0 || j > i - window);
      const float p = keep ? expf(t - sL[il]) : 0.f;
      float ds = p * (dp[a][c] - sD[il]);
      if (kSoftcap) ds *= 1.f - th * th;
      if (sP != nullptr) sP[il * kLB + jl] = p;
      sS[il * kLB + jl] = ds;
    }
  }
}

// D_i = dO_i . o_i, one warp a row, written as (B, H, S) like lse
__global__ void __launch_bounds__(kThreads)
    dot_kernel(const float* __restrict__ dout, const float* __restrict__ o,
               float* __restrict__ delta, long long rows, int S, int H, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* a = dout + row * D;
  const float* b = o + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(a[c], b[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {   // (b, s, h) in memory order; delta is (B, H, S)
    const long long h = row % H, s = (row / H) % S, bi = row / ((long long)H * S);
    delta[(bi * H + h) * S + s] = acc;
  }
}

template <bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int S, int Skv,
                float scale, float softcap, int causal, int window) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBT * kLD;
  float* sQ = sV + kBT * kLD;
  float* sO = sQ + kBT * kLD;
  float* sP = sO + kBT * kLD;
  float* sS = sP + kBT * kLB;
  float* sL = sS + kBT * kLB;
  float* sD = sL + kBT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * kBT;
  const long long qs = (long long)H * 256, ks = (long long)Hkv * 256;
  const long long kv_off = (long long)b * Skv * ks + (long long)hk * 256;

  load_tile(sK, k + kv_off, ks, k0, Skv);
  load_tile(sV, v + kv_off, ks, k0, Skv);

  // the query rows some key of the tile is kept for: i >= j (causal) and
  // i < j + window
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window >= 0 ? min(S, k0 + kBT - 1 + window) : S;
  const int qt0 = i_lo / kBT, qt1 = i_hi > i_lo ? (i_hi + kBT - 1) / kBT : qt0;

  float acc_k[kTR][kTD], acc_v[kTR][kTD];
  zero(acc_k);
  zero(acc_v);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long q_off = (long long)b * S * qs + (long long)h * 256;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kBT;
      __syncthreads();   // the last tile's products are done with Q, dO, P, dS
      load_tile(sQ, q + q_off, qs, q0, S);
      load_tile(sO, dout + q_off, qs, q0, S);
      for (int r = threadIdx.x; r < kBT; r += kThreads) {
        const bool in = q0 + r < S;   // a row past S: P = exp(-inf) = 0
        sL[r] = in ? lrow[q0 + r] : INFINITY;
        sD[r] = in ? drow[q0 + r] : 0.f;
      }
      __syncthreads();
      p_and_ds<kSoftcap>(sQ, sK, sO, sV, sL, sD, sP, sS, q0, k0, S, Skv, scale, softcap,
                         causal, window, ty, tx);
      __syncthreads();
      // dV += P^T.dO, dK += dS^T.Q: rows of the output are keys, columns d
      mma<kTR, kTD, kBT, 1, kLB, kLD, 1>(acc_v, sP, sO, ty, tx);
      mma<kTR, kTD, kBT, 1, kLB, kLD, 1>(acc_k, sS, sQ, ty, tx);
    }
  }
#pragma unroll
  for (int a = 0; a < kTR; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= Skv) continue;
    float* dkr = dk + kv_off + (long long)j * ks;
    float* dvr = dv + kv_off + (long long)j * ks;
#pragma unroll
    for (int c = 0; c < kTD; ++c) {
      dkr[tx + 16 * c] = acc_k[a][c] * scale;
      dvr[tx + 16 * c] = acc_v[a][c];
    }
  }
}

template <bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int Hkv, int S, int Skv, float scale,
              float softcap, int causal, int window) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBT * kLD;
  float* sQ = sV + kBT * kLD;
  float* sO = sQ + kBT * kLD;
  float* sS = sO + kBT * kLD + kBT * kLB;   // P's space stays unused here
  float* sL = sS + kBT * kLB;
  float* sD = sL + kBT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBT;
  const long long qs = (long long)H * 256, ks = (long long)Hkv * 256;
  const long long q_off = (long long)b * S * qs + (long long)h * 256;
  const long long kv_off = (long long)b * Skv * ks + (long long)hk * 256;

  load_tile(sQ, q + q_off, qs, q0, S);
  load_tile(sO, dout + q_off, qs, q0, S);
  const float* lrow = lse + ((long long)b * H + h) * S;
  const float* drow = delta + ((long long)b * H + h) * S;
  for (int r = threadIdx.x; r < kBT; r += kThreads) {
    const bool in = q0 + r < S;
    sL[r] = in ? lrow[q0 + r] : INFINITY;
    sD[r] = in ? drow[q0 + r] : 0.f;
  }

  // the keys some row of the tile keeps: j <= i (causal), j > i - window
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Skv, q0 + kBT) : Skv;
  const int kt0 = k_begin / kBT, kt1 = k_end > k_begin ? (k_end + kBT - 1) / kBT : kt0;

  float acc[kTR][kTD];
  zero(acc);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();   // the last tile's product is done with K and dS
    load_tile(sK, k + kv_off, ks, k0, Skv);
    load_tile(sV, v + kv_off, ks, k0, Skv);
    __syncthreads();
    p_and_ds<kSoftcap>(sQ, sK, sO, sV, sL, sD, nullptr, sS, q0, k0, S, Skv, scale, softcap,
                       causal, window, ty, tx);
    __syncthreads();
    mma<kTR, kTD, kBT, kLB, 1, kLD, 1>(acc, sS, sK, ty, tx);   // dQ += dS.K
  }
#pragma unroll
  for (int a = 0; a < kTR; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    float* dqr = dq + q_off + (long long)i * qs;
#pragma unroll
    for (int c = 0; c < kTD; ++c) dqr[tx + 16 * c] = acc[a][c] * scale;
  }
}

template <bool kSoftcap>
int launch_fma(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
               int Hkv, int S, int Skv, float scale, int causal, int window, float softcap,
               cudaStream_t st) {
  static bool dkdv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(dkdv_kernel<kSoftcap>, kFmaSmem, dkdv_ok);
  if (e == cudaSuccess) e = allow_smem(dq_kernel<kSoftcap>, kFmaSmem, dq_ok);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * S * H;
  dot_kernel<<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, st>>>(
      (const float*)dout, (const float*)o, delta, rows, S, H, 256);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dkdv_kernel<kSoftcap><<<dim3(B * Hkv, (Skv + kBT - 1) / kBT), kThreads, kFmaSmem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, H, Hkv, S, Skv, scale, softcap, causal, window);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dq_kernel<kSoftcap><<<dim3(B * H, (S + kBT - 1) / kBT), kThreads, kFmaSmem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, H, Hkv, S, Skv, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H,
           int Hkv, int S, int Skv, float scale, int causal, int window, float softcap,
           cudaStream_t st) {
  if constexpr (D == 256)
    return softcap > 0.f
               ? launch_fma<true>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, Hkv, S,
                                  Skv, scale, causal, window, softcap, st)
               : launch_fma<false>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, Hkv, S,
                                   Skv, scale, causal, window, softcap, st);
  else
    return softcap > 0.f
               ? launch_tf32<D, true>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, Hkv,
                                      S, Skv, scale, causal, window, softcap, st)
               : launch_tf32<D, false>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, H, Hkv,
                                       S, Skv, scale, causal, window, softcap, st);
}

}  // namespace

// q, o, dout, dq: (B, S, H, D); k, v, dk, dv: (B, Skv, Hkv, D); fp32,
// contiguous, 16-byte aligned. lse: (B, H, S) fp32, the forward's; scratch:
// fp32 of 2 * B * H * Sp floats, Sp = seq_q rounded up to 128. H % Hkv == 0,
// D in {32, 64, 128, 256}; window < 0: no window; softcap <= 0: no
// softcap. Three launches on `stream`, in order; returns the first launch
// error.
extern "C" int flash_attn_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* scratch, void* dq,
                                  void* dk, void* dv, int batch, int heads, int kv_heads,
                                  int seq_q, int seq_kv, int head_dim, float scale, int causal,
                                  int window, float softcap, void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_kv <= 0 || seq_q / 32 > 65535 ||
      seq_kv / 32 > 65535)
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
