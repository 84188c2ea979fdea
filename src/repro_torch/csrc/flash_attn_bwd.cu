// Flash-attention backward for bf16 and fp32 (sm_90a): dQ, dK and dV of
// o = softmax(mask(softcap(q*scale . k^T))) . v, from q, k, v, the
// forward's o, the output's gradient dO and the forward's row logsumexp.
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
// fp32 inputs: all arithmetic in fp32 FMAs, P and dS kept in fp32. bf16
// inputs: the five products on the tensor cores (fp32 accumulation), P and
// dS rounded to bf16 before their products, as every tensor-core flash
// backward does; the softmax arithmetic in fp32. The outputs are rounded
// once, to the inputs' type. kernels/ref.py::flash_attention_bwd_tol holds
// the result.
//
// Bound: five products of 2 * D flops a kept (query, key) pair (2.5x the
// forward's), against reading q, k, v, o, dO once and writing dq, dk, dv:
// at the training shape thousands of flops a byte, so bound by the
// operations at the type's rate (bf16: 989 TFLOP/s on the tensor cores;
// fp32: 67 TFLOP/s of FMAs on an H100 SXM).
//
// Design: no float atomics and a fixed order of every sum, so a result
// repeats bit for bit. The dQ pass recomputes S and dP (seven products in
// all, not five) so that dQ needs no atomics.
// Which kernels run is fixed at compile time by dtype and head dim:
//   bf16, D 64 and 128: bwd_prep_kernel, dkdv_wg_kernel, dq_wg_kernel (wgmma
//     with TMA, below); bf16, D 32 and 256: dot_kernel, dkdv_tc_kernel,
//     dq_tc_kernel (mma.sync: at D 256 the dK and dV accumulators alone
//     would fill a warpgroup's registers, and D 32 takes no 128-byte
//     swizzle); fp32: dot_kernel, dkdv_kernel, dq_kernel (FMAs).
// Three launches in stream order each:
// (a) D_i = dO_i . o_i, fp32, in a fixed order. dot_kernel writes it as
//     (B, H, S) like lse; bwd_prep_kernel as (B, H, Sp) with Sp = S rounded up
//     to 128, beside lse times log2(e), so that the wgmma kernels copy a
//     tile's values with one 16-byte aligned bulk copy and a padded row
//     gets P = 0.
// (b) dK, dV: one CTA a (batch, kv head, block of keys), GQA summed inside
//     the CTA over the query heads of the group, the query tiles the causal
//     band and the window leave (in that order).
// (c) dQ: one CTA a (batch, head, block of queries), the longest rows first,
//     over the key tiles the masks leave.
//
// wgmma kernels (bf16, D 64 and 128), built from csrc/flash_common.cuh as
// the forward (csrc/flash_attn_tc.cu) is: a CTA is two consumer warpgroups
// of 64 rows (the M of one wgmma), 128 rows a CTA. Tiles live in shared
// memory in the canonical GMMA layout with a 128-byte swizzle, written by
// TMA (one thread issues a box an atom column, an mbarrier a stage counts
// the bytes in, rows past S or Skv arrive as zeros); a ring of three
// stages (two for dQ's K/V at D 128, which fill 192 KiB with Q and dO)
// runs ahead of the math. The two warpgroups take turns on the
// tensor cores (named barriers), so one's softmax arithmetic runs beside
// the other's products. Only the tiles that cross the diagonal, the
// window's edge, S or Skv test the masks.
// - dq_wg_kernel: Q, dO (128 rows), their lse and D_i stay resident; a ring
//   of K/V tiles of 128 keys (2% faster than 64 at the training shape, 4%
//   at granite's, on the H100). S = Q.K^T and dP = dO.V^T are wgmma with both
//   operands K-major; P and dS are computed in fp32 registers and dS is
//   rounded to bf16 there; dQ += dS.K is the RS form (dS as the A fragment
//   straight from the accumulator layout, K read MN-major), so P and dS
//   never touch shared memory.
// - dkdv_wg_kernel: K, V (128 keys) stay resident; a ring of (Q, dO, lse,
//   D) tiles of 64 queries over the (query head, query tile) pairs. S^T =
//   K.Q^T and dP^T = V.dO^T keep the keys along M, so P^T and dS^T come out
//   of the accumulators in the A-fragment layout of dV += P^T.dO and dK +=
//   dS^T.Q, which read dO and Q MN-major. dK and dV (64 + 64 fp32 a thread
//   at D 128) stay in registers over all pairs.
// The outputs go through shared memory (Q's or K's and V's tiles), so the
// stores to device memory are 16-byte and coalesced.
//
// mma.sync kernels (bf16, D 32 and 256): BT 64, tiles in bf16 with rows
// padded by 16 bytes, loaded by every thread; 8 warps, each owning 16 rows
// x 32 keys of S and dP and then 16 rows x D/2 columns of the output,
// m16n8k16 products whose A fragments load as 32-bit pairs and whose B
// fragments of dO, Q (for dV, dK) and K (for dQ) come through
// ldmatrix.trans; P and dS go through shared memory.
// fp32 FMA kernels: every tile is fp32 in shared memory, rows padded by one
// float so that the column reads of a product meet no bank conflict; each
// thread of a 16 x 16 grid owns the entries (ty + 16a, tx + 16c) of a
// product's output and takes them as FMAs over the shared dim. BT is 64 up
// to D 128 and 32 at D 256, so that the six tiles fit.

#include <cuda_bf16.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // fp32: a 16 x 16 grid; bf16: 8 warps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

template <int D>
struct Tile {
  static constexpr int BT = D >= 256 ? 32 : 64;   // queries or keys a tile
  static constexpr int LD = D + 1;                // a Q/K/V/dO tile's padded row
  static constexpr int LB = BT + 1;               // a P/dS tile's padded row
  static constexpr int R = BT / 16;               // tile rows a thread
  static constexpr int RD = D / 16;               // head-dim columns a thread
  // K, V, Q, dO; P, dS; lse, D
  static constexpr size_t kSmem = (4 * BT * LD + 2 * BT * LB + 2 * BT) * sizeof(float);
};

// rows r0 .. r0 + BT - 1 of one head of a (B, rows, heads, D) tensor, fp32,
// into a padded tile; rows past `rows` as zeros. `src` points at (b, 0, h, 0).
template <typename T, int D, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int r0, int rows) {
  for (int e = threadIdx.x; e < BT * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        r0 + r < rows ? to_f(src[(long long)(r0 + r) * row_stride + c]) : 0.f;
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
template <int D, bool kSoftcap>
__device__ __forceinline__ void p_and_ds(const float* sQ, const float* sK, const float* sO,
                                         const float* sV, const float* sL, const float* sD,
                                         float* sP, float* sS, int q0, int k0, int S, int Skv,
                                         float scale, float softcap, int causal, int window,
                                         int ty, int tx) {
  using C = Tile<D>;
  constexpr int R = C::R, LD = C::LD, LB = C::LB;
  float s[R][R], dp[R][R];
  zero(s);
  zero(dp);
  mma<R, R, D, LD, 1, 1, LD>(s, sQ, sK, ty, tx);
  mma<R, R, D, LD, 1, 1, LD>(dp, sO, sV, ty, tx);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int il = ty + 16 * a, i = q0 + il;
#pragma unroll
    for (int c = 0; c < R; ++c) {
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
      if (sP != nullptr) sP[il * LB + jl] = p;
      sS[il * LB + jl] = ds;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dot_kernel(const T* __restrict__ dout, const T* __restrict__ o,
               float* __restrict__ delta, long long rows, int S, int H, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* a = dout + row * D;
  const T* b = o + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(a[c]), to_f(b[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {   // (b, s, h) in memory order; delta is (B, H, S)
    const long long h = row % H, s = (row / H) % S, bi = row / ((long long)H * S);
    delta[(bi * H + h) * S + s] = acc;
  }
}

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int H, int Hkv, int S, int Skv, float scale, float softcap, int causal,
                int window) {
  using C = Tile<D>;
  constexpr int BT = C::BT, LD = C::LD, LB = C::LB, R = C::R, RD = C::RD;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;
  float* sP = sO + BT * LD;
  float* sS = sP + BT * LB;
  float* sL = sS + BT * LB;
  float* sD = sL + BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * BT;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long kv_off = (long long)b * Skv * ks + (long long)hk * D;

  load_tile<T, D, BT>(sK, k + kv_off, ks, k0, Skv);
  load_tile<T, D, BT>(sV, v + kv_off, ks, k0, Skv);

  // the query rows some key of the tile is kept for: i >= j (causal) and
  // i < j + window
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window >= 0 ? min(S, k0 + BT - 1 + window) : S;
  const int qt0 = i_lo / BT, qt1 = i_hi > i_lo ? (i_hi + BT - 1) / BT : qt0;

  float acc_k[R][RD], acc_v[R][RD];
  zero(acc_k);
  zero(acc_v);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long q_off = (long long)b * S * qs + (long long)h * D;
    const float* lrow = lse + ((long long)b * H + h) * S;
    const float* drow = delta + ((long long)b * H + h) * S;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();   // the last tile's products are done with Q, dO, P, dS
      load_tile<T, D, BT>(sQ, q + q_off, qs, q0, S);
      load_tile<T, D, BT>(sO, dout + q_off, qs, q0, S);
      for (int r = threadIdx.x; r < BT; r += kThreads) {
        const bool in = q0 + r < S;   // a row past S: P = exp(-inf) = 0
        sL[r] = in ? lrow[q0 + r] : INFINITY;
        sD[r] = in ? drow[q0 + r] : 0.f;
      }
      __syncthreads();
      p_and_ds<D, kSoftcap>(sQ, sK, sO, sV, sL, sD, sP, sS, q0, k0, S, Skv, scale,
                            softcap, causal, window, ty, tx);
      __syncthreads();
      // dV += P^T.dO, dK += dS^T.Q: rows of the output are keys, columns d
      mma<R, RD, BT, 1, LB, LD, 1>(acc_v, sP, sO, ty, tx);
      mma<R, RD, BT, 1, LB, LD, 1>(acc_k, sS, sQ, ty, tx);
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= Skv) continue;
    T* dkr = dk + kv_off + (long long)j * ks;
    T* dvr = dv + kv_off + (long long)j * ks;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      dkr[tx + 16 * c] = from_f<T>(acc_k[a][c] * scale);
      dvr[tx + 16 * c] = from_f<T>(acc_v[a][c]);
    }
  }
}

template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv, int S,
              int Skv, float scale, float softcap, int causal, int window) {
  using C = Tile<D>;
  constexpr int BT = C::BT, LD = C::LD, LB = C::LB, R = C::R, RD = C::RD;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;
  float* sS = sO + BT * LD + BT * LB;   // P's space stays unused here
  float* sL = sS + BT * LB;
  float* sD = sL + BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long q_off = (long long)b * S * qs + (long long)h * D;
  const long long kv_off = (long long)b * Skv * ks + (long long)hk * D;

  load_tile<T, D, BT>(sQ, q + q_off, qs, q0, S);
  load_tile<T, D, BT>(sO, dout + q_off, qs, q0, S);
  const float* lrow = lse + ((long long)b * H + h) * S;
  const float* drow = delta + ((long long)b * H + h) * S;
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const bool in = q0 + r < S;
    sL[r] = in ? lrow[q0 + r] : INFINITY;
    sD[r] = in ? drow[q0 + r] : 0.f;
  }

  // the keys some row of the tile keeps: j <= i (causal), j > i - window
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Skv, q0 + BT) : Skv;
  const int kt0 = k_begin / BT, kt1 = k_end > k_begin ? (k_end + BT - 1) / BT : kt0;

  float acc[R][RD];
  zero(acc);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the last tile's product is done with K and dS
    load_tile<T, D, BT>(sK, k + kv_off, ks, k0, Skv);
    load_tile<T, D, BT>(sV, v + kv_off, ks, k0, Skv);
    __syncthreads();
    p_and_ds<D, kSoftcap>(sQ, sK, sO, sV, sL, sD, nullptr, sS, q0, k0, S, Skv, scale,
                          softcap, causal, window, ty, tx);
    __syncthreads();
    mma<R, RD, BT, LB, 1, LD, 1>(acc, sS, sK, ty, tx);   // dQ += dS.K
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    T* dqr = dq + q_off + (long long)i * qs;
#pragma unroll
    for (int c = 0; c < RD; ++c) dqr[tx + 16 * c] = from_f<T>(acc[a][c] * scale);
  }
}

// ---- bf16: the same two kernels on the tensor cores (mma.sync) ----------

constexpr int kBT = 64;   // queries and keys a tile

template <int D>
struct TcTile {
  static constexpr int LD = D + 8;     // a Q/K/V/dO tile's bf16 row, padded 16 bytes
  static constexpr int LP = kBT + 8;   // a P^T/dS tile's bf16 row, padded 16 bytes
  // K, V, Q, dO; P^T and dS^T (dq: dS); lse, D
  static constexpr size_t kSmem =
      (4 * kBT * LD + 2 * kBT * LP) * sizeof(bf16) + 2 * kBT * sizeof(float);
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragment of k rows k0 .. k0 + 15 and columns n0 .. n0 + 7 of a
// row-major [k][n] tile: lanes 0-15 address rows k0 + lane, the .trans load
// hands each lane (k = 2t, 2t + 1; n = g) and (k = 2t + 8, 2t + 9; n = g)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// rows r0 .. r0 + kBT - 1 of one head of a (B, rows, heads, D) bf16 tensor
// into a padded tile, 16 bytes a copy; rows past `rows` as zeros
template <int D>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* __restrict__ src,
                                        long long row_stride, int r0, int rows) {
  constexpr int CPR = D / 8;
  for (int e = threadIdx.x; e < kBT * CPR; e += kThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * TcTile<D>::LD + c) = val;
  }
}

__device__ __forceinline__ void tc_lse_d(float* sL, float* sD, const float* lrow,
                                         const float* drow, int q0, int S) {
  for (int r = threadIdx.x; r < kBT; r += kThreads) {
    const bool in = q0 + r < S;   // a row past S: P = exp(-inf) = 0
    sL[r] = in ? lrow[q0 + r] : INFINITY;
    sD[r] = in ? drow[q0 + r] : 0.f;
  }
}

// S = Q.K^T and dP = dO.V^T for warp w's 16 query rows (16 (w % 4) ..) and
// 32 keys (32 (w / 4) ..) of a (query tile, key tile), then P and dS,
// rounded to bf16: written transposed (sP^T, sS^T: [key][query]) for the
// dK/dV kernel, or dS as [query][key] for the dQ kernel (sP null).
template <int D, bool kSoftcap>
__device__ __forceinline__ void tc_p_ds(const bf16* sQ, const bf16* sK, const bf16* sO,
                                        const bf16* sV, const float* sL, const float* sD,
                                        bf16* sPt, bf16* sS, int q0, int k0, int S, int Skv,
                                        float scale, float softcap, int causal, int window) {
  constexpr int LD = TcTile<D>::LD, LP = TcTile<D>::LP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % 4, ch = warp / 4;
  float s[4][4], dp[4][4];
  zero(s);
  zero(dp);
  const bf16* qa = sQ + (16 * rg + g) * LD + 2 * t;
  const bf16* oa = sO + (16 * rg + g) * LD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a[4] = {ld32(qa + 16 * kk), ld32(qa + 8 * LD + 16 * kk),
                           ld32(qa + 16 * kk + 8), ld32(qa + 8 * LD + 16 * kk + 8)};
    const uint32_t ao[4] = {ld32(oa + 16 * kk), ld32(oa + 8 * LD + 16 * kk),
                            ld32(oa + 16 * kk + 8), ld32(oa + 8 * LD + 16 * kk + 8)};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = (32 * ch + 8 * nt + g) * LD + 16 * kk + 2 * t;
      mma16816(s[nt], a, ld32(sK + row), ld32(sK + row + 8));
      mma16816(dp[nt], ao, ld32(sV + row), ld32(sV + row + 8));
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int il = 16 * rg + g + (e >= 2 ? 8 : 0), jl = 32 * ch + 8 * nt + 2 * t + (e & 1);
      const int i = q0 + il, j = k0 + jl;
      const float x = s[nt][e] * scale;
      float tt = x, th = 0.f;
      if (kSoftcap) {
        th = tanhf(x / softcap);
        tt = softcap * th;
      }
      const bool keep = i < S && j < Skv && (!causal || j <= i) &&
                        (window < 0 || j > i - window);
      const float p = keep ? expf(tt - sL[il]) : 0.f;
      float ds = p * (dp[nt][e] - sD[il]);
      if (kSoftcap) ds *= 1.f - th * th;
      if (sPt != nullptr) {
        sPt[jl * LP + il] = __float2bfloat16(p);
        sS[jl * LP + il] = __float2bfloat16(ds);
      } else {
        sS[il * LP + jl] = __float2bfloat16(ds);
      }
    }
  }
}

// a warp's (16 rows x 8 columns) fp32 accumulator, times `mul`, as bf16
// pairs at rows r, r + 8 of a row-major [row][D] output with row stride rs
__device__ __forceinline__ void tc_store(bf16* out, long long rs, int r, int col, int rows,
                                         const float (&c)[4], float mul) {
  if (r < rows)
    *reinterpret_cast<__nv_bfloat162*>(out + r * rs + col) =
        __floats2bfloat162_rn(c[0] * mul, c[1] * mul);
  if (r + 8 < rows)
    *reinterpret_cast<__nv_bfloat162*>(out + (r + 8) * rs + col) =
        __floats2bfloat162_rn(c[2] * mul, c[3] * mul);
}

template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int S,
                   int Skv, float scale, float softcap, int causal, int window) {
  using C = TcTile<D>;
  constexpr int LD = C::LD, LP = C::LP, NT = D / 16;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);
  bf16* sV = sK + kBT * LD;
  bf16* sQ = sV + kBT * LD;
  bf16* sO = sQ + kBT * LD;
  bf16* sPt = sO + kBT * LD;
  bf16* sSt = sPt + kBT * LP;
  float* sL = reinterpret_cast<float*>(sSt + kBT * LP);
  float* sD = sL + kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % 4, ch = warp / 4;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * kBT;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long kv_off = (long long)b * Skv * ks + (long long)hk * D;

  tc_load<D>(sK, k + kv_off, ks, k0, Skv);
  tc_load<D>(sV, v + kv_off, ks, k0, Skv);
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window >= 0 ? min(S, k0 + kBT - 1 + window) : S;
  const int qt0 = i_lo / kBT, qt1 = i_hi > i_lo ? (i_hi + kBT - 1) / kBT : qt0;

  // this warp's 16 keys (16 rg ..) x D/2 columns (ch D/2 ..) of dK and dV
  float acc_k[NT][4], acc_v[NT][4];
  zero(acc_k);
  zero(acc_v);
  const bf16* pa = sPt + (16 * rg + g) * LP + 2 * t;
  const bf16* sa = sSt + (16 * rg + g) * LP + 2 * t;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const long long q_off = (long long)b * S * qs + (long long)h * D;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kBT;
      __syncthreads();   // the last tile's products are done with Q, dO, P^T, dS^T
      tc_load<D>(sQ, q + q_off, qs, q0, S);
      tc_load<D>(sO, dout + q_off, qs, q0, S);
      tc_lse_d(sL, sD, lse + ((long long)b * H + h) * S, delta + ((long long)b * H + h) * S,
               q0, S);
      __syncthreads();
      tc_p_ds<D, kSoftcap>(sQ, sK, sO, sV, sL, sD, sPt, sSt, q0, k0, S, Skv, scale, softcap,
                           causal, window);
      __syncthreads();
      // dV += P^T.dO, dK += dS^T.Q over the tile's 64 queries
#pragma unroll
      for (int kk = 0; kk < kBT / 16; ++kk) {
        const uint32_t ap[4] = {ld32(pa + 16 * kk), ld32(pa + 8 * LP + 16 * kk),
                                ld32(pa + 16 * kk + 8), ld32(pa + 8 * LP + 16 * kk + 8)};
        const uint32_t as[4] = {ld32(sa + 16 * kk), ld32(sa + 8 * LP + 16 * kk),
                                ld32(sa + 16 * kk + 8), ld32(sa + 8 * LP + 16 * kk + 8)};
        const int row = (16 * kk + (lane & 15)) * LD + ch * (D / 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, sO + row + 8 * nt);
          mma16816(acc_v[nt], ap, b0, b1);
          ldsm_x2_trans(b0, b1, sQ + row + 8 * nt);
          mma16816(acc_k[nt], as, b0, b1);
        }
      }
    }
  }
  const int r = k0 + 16 * rg + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = ch * (D / 2) + 8 * nt + 2 * t;
    tc_store(dk + kv_off, ks, r, col, Skv, acc_k[nt], scale);
    tc_store(dv + kv_off, ks, r, col, Skv, acc_v[nt], 1.f);
  }
}

template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int Hkv, int S, int Skv, float scale,
                 float softcap, int causal, int window) {
  using C = TcTile<D>;
  constexpr int LD = C::LD, LP = C::LP, NT = D / 16;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);
  bf16* sV = sK + kBT * LD;
  bf16* sQ = sV + kBT * LD;
  bf16* sO = sQ + kBT * LD;
  bf16* sS = sO + kBT * LD;   // dS [query][key], in P^T's space; dS^T's stays unused
  float* sL = reinterpret_cast<float*>(sS + 2 * kBT * LP);
  float* sD = sL + kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % 4, ch = warp / 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBT;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  const long long q_off = (long long)b * S * qs + (long long)h * D;
  const long long kv_off = (long long)b * Skv * ks + (long long)hk * D;

  tc_load<D>(sQ, q + q_off, qs, q0, S);
  tc_load<D>(sO, dout + q_off, qs, q0, S);
  tc_lse_d(sL, sD, lse + ((long long)b * H + h) * S, delta + ((long long)b * H + h) * S, q0,
           S);
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(Skv, q0 + kBT) : Skv;
  const int kt0 = k_begin / kBT, kt1 = k_end > k_begin ? (k_end + kBT - 1) / kBT : kt0;

  float acc[NT][4];
  zero(acc);
  const bf16* sa = sS + (16 * rg + g) * LP + 2 * t;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBT;
    __syncthreads();   // the last tile's product is done with K and dS
    tc_load<D>(sK, k + kv_off, ks, k0, Skv);
    tc_load<D>(sV, v + kv_off, ks, k0, Skv);
    __syncthreads();
    tc_p_ds<D, kSoftcap>(sQ, sK, sO, sV, sL, sD, nullptr, sS, q0, k0, S, Skv, scale, softcap,
                         causal, window);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {   // dQ += dS.K over the tile's 64 keys
      const uint32_t as[4] = {ld32(sa + 16 * kk), ld32(sa + 8 * LP + 16 * kk),
                              ld32(sa + 16 * kk + 8), ld32(sa + 8 * LP + 16 * kk + 8)};
      const int row = (16 * kk + (lane & 15)) * LD + ch * (D / 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, sK + row + 8 * nt);
        mma16816(acc[nt], as, b0, b1);
      }
    }
  }
  const int r = q0 + 16 * rg + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    tc_store(dq + q_off, qs, r, ch * (D / 2) + 8 * nt + 2 * t, S, acc[nt], scale);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;   // the attribute is per kernel, set once
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  configured = e == cudaSuccess;
  return e;
}

// ---- bf16 at D 64 and 128: wgmma, TMA, two warpgroups (Hopper) --------

constexpr int kWgThreads = 256;   // two consumer warpgroups
constexpr int kRows = 128;        // a CTA's queries (dq) or keys (dkdv), 64 a warpgroup

template <int D>
struct Wg {
  static constexpr int W = 128;    // 128-byte swizzle: an atom row is 64 bf16
  static constexpr int AC = 64;    // head-dim columns an atom column
  static constexpr int BN = 128;   // dq: keys a tile of the K/V ring
  static constexpr int BM = 64;    // dkdv: queries a tile of the Q/dO ring
  static constexpr int kRowBytes = kRows * D * 2;   // a resident Q or dO (dq), K or V (dkdv)
  static constexpr int kKvTile = BN * D * 2;       // a K or V stage (dq)
  static constexpr int kQTile = BM * D * 2;        // a Q or dO stage (dkdv)
  // ring stages: three where they fit in the 227 KiB a CTA may hold, else two
  static constexpr int kDqStages = 2 * kRowBytes + 6 * kKvTile + 1024 <= 227 * 1024 ? 3 : 2;
  static constexpr int kDkvStages = 3;
  static constexpr size_t kDqSmem = 2 * kRowBytes + 2 * kDqStages * kKvTile + 1024;
  static constexpr size_t kDkvSmem =
      2 * kRowBytes + 2 * kDkvStages * kQTile + 2 * kDkvStages * BM * sizeof(float) + 1024;
};

// the wgmma descriptor of k16 step kk of a K-major tile of `rows` rows,
// from row r0 on: head-dim columns 16kk..16kk+15, in atom column kk / 4
template <int rows>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk, int r0) {
  constexpr int W = 128;
  return make_desc(tile + (kk * 32 / W) * (rows * W) + (kk * 32) % W + r0 * W, 16, 8 * W, 1);
}
// the descriptor of k16 step kk of a tile of `rows` rows read MN-major (the
// rows are the product's shared dim, the head dim its N): rows 16kk..16kk+15
template <int rows>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  constexpr int W = 128;
  return make_desc(tile + kk * 16 * W, rows * W, 8 * W, 1);
}

// D_i = dO_i . o_i and the forward's logsumexp in the log2 domain, for the
// wgmma kernels: one warp a row of a (B, H, Sp) layout whose rows are padded
// to Sp = S rounded up to 128, so that a tile's rows are one 16-byte aligned
// copy; a padded row gets lse +inf (P = 0) and D 0
__global__ void __launch_bounds__(kThreads)
    bwd_prep_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ delta, long long rows, int S, int Sp, int H, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
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

// dQ: one CTA of two warpgroups a (batch, head, 128-query block), the
// longest rows first; warpgroup wg owns queries q0 + 64 wg .. + 63.
template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse2, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int Hkv, int S, int Skv, int Sp, float scale,
                 float scale_log2, float cap_in, float cap_out, int causal, int window) {
  using C = Wg<D>;
  constexpr int W = C::W, AC = C::AC, BN = C::BN, ST = C::kDqStages, TILE = C::kKvTile;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sq = base, sdo = sq + C::kRowBytes, sk = sdo + C::kRowBytes,
                 sv = sk + ST * TILE;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int qw = q0 + 64 * wg;   // this warpgroup's first query

  // the key tiles some row of the CTA keeps: j <= i (causal), j > i - window
  const int k_end = causal ? min(Skv, q0 + kRows) : Skv;
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
        tma_load(sq + a * (kRows * W), &tq, bar, a * AC, h, q0, b);
        tma_load(sdo + a * (kRows * W), &tdo, bar, a * AC, h, q0, b);
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
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // issue order: (S, dP) of warpgroup 0, of 1, then dQ of 0, of 1
  if (wg == 1 && kb0 < kb1) turn_pass(1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int st = (kb - kb0) % ST, k0 = kb * BN;
    mbar_wait(smem_u32(&full[st]), ((kb - kb0) / ST) & 1);
    __syncthreads();   // every thread is done with tile kb - 1's stage
    load(kb + ST - 1);

    // S = Q.K^T and dP = dO.V^T, both operands K-major
    float s[BN / 2], dp[BN / 2];
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_ss<BN>(s, kmajor_desc<kRows>(sq, kk, 64 * wg),
                        kmajor_desc<BN>(sk + st * TILE, kk, 0), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_ss<BN>(dp, kmajor_desc<kRows>(sdo, kk, 64 * wg),
                        kmajor_desc<BN>(sv + st * TILE, kk, 0), kk > 0);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

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
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_bf16_rs<D>(acc, da[kk], mnmajor_desc<BN>(sk + st * TILE, kk));
    wgmma_commit();
    if (wg == 0 || kb + 1 < kb1) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // each warpgroup writes its own 64 rows of Q's tile (only its own wgmmas
  // read them), then the CTA stores the tile with 16-byte stores
  const int r_lo = row_lo - q0, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t in = (lane % 4) * 4;
    *reinterpret_cast<uint32_t*>(smem + swz_offset<W, kRows>(r_lo, j) + in) =
        pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(smem + swz_offset<W, kRows>(r_hi, j) + in) =
        pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
  __syncthreads();
  constexpr int CH = D / 8;
  const long long qs = (long long)H * D;
  bf16* out = dq + ((long long)b * S + q0) * qs + (long long)h * D;
  for (int i = tid; i < kRows * CH; i += kWgThreads) {
    const int r = i / CH, c = i % CH;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(out + r * qs + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz_offset<W, kRows>(r, c));
  }
}

// dK and dV: one CTA of two warpgroups a (batch, kv head, 128-key block);
// warpgroup wg owns keys k0 + 64 wg .. + 63. Under the causal mask key
// block 0 has the longest column, and blockIdx.y counts from it.
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
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sk = base, sv = sk + C::kRowBytes, sq = sv + C::kRowBytes,
                 sdo = sq + ST * TILE, sl = sdo + ST * TILE, sd = sl + ST * BM * 4;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * kRows;
  const int kw = k0 + 64 * wg;   // this warpgroup's first key

  // the query tiles some key of the CTA is kept for: i >= j (causal) and
  // i < j + window; each query head of the group visits them in turn
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window >= 0 ? min(S, k0 + kRows - 1 + window) : S;
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
        tma_load(sk + a * (kRows * W), &tk, bar, a * AC, hk, k0, b);
        tma_load(sv + a * (kRows * W), &tv, bar, a * AC, hk, k0, b);
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
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  // issue order: (S^T, dP^T) of warpgroup 0, of 1, then (dV, dK) of 0, of 1
  if (wg == 1 && n > 0) turn_pass(1);
  for (int it = 0; it < n; ++it) {
    const int st = it % ST, q0 = (qt0 + it % nq) * BM;
    mbar_wait(smem_u32(&full[st]), (it / ST) & 1);
    __syncthreads();   // every thread is done with pair it - 1's stage
    load(it + ST - 1);

    // S^T = K.Q^T and dP^T = V.dO^T: keys along M, both operands K-major
    float s[BM / 2], dp[BM / 2];
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_ss<BM>(s, kmajor_desc<kRows>(sk, kk, 64 * wg),
                        kmajor_desc<BM>(sq + st * TILE, kk, 0), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_ss<BM>(dp, kmajor_desc<kRows>(sv, kk, 64 * wg),
                        kmajor_desc<BM>(sdo + st * TILE, kk, 0), kk > 0);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

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
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_bf16_rs<D>(acc_v, pa[kk], mnmajor_desc<BM>(sdo + st * TILE, kk));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_bf16_rs<D>(acc_k, da[kk], mnmajor_desc<BM>(sq + st * TILE, kk));
    wgmma_commit();
    if (wg == 0 || it + 1 < n) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }

  // dK (times scale) into K's tile and dV into V's, each warpgroup its own
  // 64 rows (only its own wgmmas read them), then 16-byte stores
  const int r_lo = key_lo - k0, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t in = (lane % 4) * 4;
    const uint32_t lo = swz_offset<W, kRows>(r_lo, j) + in, hi = swz_offset<W, kRows>(r_hi, j) + in;
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
  for (int i = tid; i < kRows * CH; i += kWgThreads) {
    const int r = i / CH, c = i % CH;
    if (k0 + r < Skv) {
      const uint32_t off = swz_offset<W, kRows>(r, c);
      *reinterpret_cast<uint4*>(dk + at + r * ks + c * 8) =
          *reinterpret_cast<const uint4*>(smem + off);
      *reinterpret_cast<uint4*>(dv + at + r * ks + c * 8) =
          *reinterpret_cast<const uint4*>(smem + C::kRowBytes + off);
    }
  }
}

// (B, rows, heads, D) bf16 as a 4-d tensor map, boxes of one 128-byte
// swizzle atom column (64 columns) x box_rows
template <int D>
bool wg_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int box_rows) {
  return make_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, rows, heads, D, Wg<D>::AC,
                  box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D, bool kSoftcap>
int launch_wg(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int H,
              int Hkv, int S, int Skv, float scale, int causal, int window, float softcap,
              cudaStream_t st) {
  using C = Wg<D>;
  static bool dkdv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(dkdv_wg_kernel<D, kSoftcap>, C::kDkvSmem, dkdv_ok);
  if (e == cudaSuccess) e = allow_smem(dq_wg_kernel<D, kSoftcap>, C::kDqSmem, dq_ok);
  if (e != cudaSuccess) return (int)e;
  const int Sp = (S + kRows - 1) / kRows * kRows;
  float* lse2 = scratch;
  float* delta = scratch + (long long)B * H * Sp;
  CUtensorMap q_rows, do_rows, k_tile, v_tile, k_rows, v_rows, q_tile, do_tile;
  if (!wg_map<D>(&q_rows, q, B, S, H, kRows) || !wg_map<D>(&do_rows, dout, B, S, H, kRows) ||
      !wg_map<D>(&k_tile, k, B, Skv, Hkv, C::BN) || !wg_map<D>(&v_tile, v, B, Skv, Hkv, C::BN) ||
      !wg_map<D>(&k_rows, k, B, Skv, Hkv, kRows) || !wg_map<D>(&v_rows, v, B, Skv, Hkv, kRows) ||
      !wg_map<D>(&q_tile, q, B, S, H, C::BM) || !wg_map<D>(&do_tile, dout, B, S, H, C::BM))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sp;
  const unsigned blocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  bwd_prep_kernel<<<blocks, kThreads, 0, st>>>((const bf16*)dout, (const bf16*)o, lse, lse2,
                                               delta, rows, S, Sp, H, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const float scale_log2 = scale * kLog2e;
  const float cap_in = kSoftcap ? scale / softcap : 0.f;
  const float cap_out = kSoftcap ? softcap * kLog2e : 0.f;
  dkdv_wg_kernel<D, kSoftcap>
      <<<dim3(B * Hkv, (Skv + kRows - 1) / kRows), kWgThreads, C::kDkvSmem, st>>>(
          k_rows, v_rows, q_tile, do_tile, lse2, delta, (bf16*)dk, (bf16*)dv, H, Hkv, S, Skv,
          Sp, scale, scale_log2, cap_in, cap_out, causal, window);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dq_wg_kernel<D, kSoftcap><<<dim3(B * H, (S + kRows - 1) / kRows), kWgThreads, C::kDqSmem, st>>>(
      q_rows, do_rows, k_tile, v_tile, lse2, delta, (bf16*)dq, H, Hkv, S, Skv, Sp, scale,
      scale_log2, cap_in, cap_out, causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kSoftcap>
int launch_cap(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq, void* dk,
               void* dv, int B, int H, int Hkv, int S, int Skv, float scale, int causal,
               int window, float softcap, cudaStream_t st) {
  constexpr bool kTc = std::is_same<T, bf16>::value;   // bf16: the tensor cores
  if constexpr (kTc && (D == 64 || D == 128)) {   // wgmma and TMA
    return launch_wg<D, kSoftcap>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, Skv,
                                  scale, causal, window, softcap, st);
  } else {   // mma.sync (bf16 at D 32 and 256) or fp32 FMAs
    constexpr int BT = kTc ? kBT : Tile<D>::BT;
    constexpr size_t smem = kTc ? TcTile<D>::kSmem : Tile<D>::kSmem;
    auto dkdv = [] {
      if constexpr (kTc) return dkdv_tc_kernel<D, kSoftcap>;
      else return dkdv_kernel<T, D, kSoftcap>;
    }();
    auto dqk = [] {
      if constexpr (kTc) return dq_tc_kernel<D, kSoftcap>;
      else return dq_kernel<T, D, kSoftcap>;
    }();
    static bool dkdv_ok = false, dq_ok = false;
    cudaError_t e = allow_smem(dkdv, smem, dkdv_ok);
    if (e == cudaSuccess) e = allow_smem(dqk, smem, dq_ok);
    if (e != cudaSuccess) return (int)e;
    const long long rows = (long long)B * S * H;
    dot_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, st>>>(
        (const T*)dout, (const T*)o, delta, rows, S, H, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    dkdv<<<dim3(B * Hkv, (Skv + BT - 1) / BT), kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, H,
        Hkv, S, Skv, scale, softcap, causal, window);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    dqk<<<dim3(B * H, (S + BT - 1) / BT), kThreads, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, H, Hkv, S,
        Skv, scale, softcap, causal, window);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
           int Hkv, int S, int Skv, float scale, int causal, int window, float softcap,
           cudaStream_t st) {
  return softcap > 0.f
             ? launch_cap<T, D, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv,
                                      S, Skv, scale, causal, window, softcap, st)
             : launch_cap<T, D, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv,
                                       S, Skv, scale, causal, window, softcap, st);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
             int Hkv, int S, int Skv, int D, float scale, int causal, int window,
             float softcap, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, Skv, scale, causal, window, softcap, st);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, Skv, scale, causal, window, softcap, st);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, Skv, scale, causal, window, softcap, st);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Hkv, S, Skv, scale, causal, window, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16: 1 for bf16 tensors, 0 for fp32. q, o, dout, dq: (B, S, H, D); k, v,
// dk, dv: (B, Skv, Hkv, D); contiguous. lse: (B, H, S) fp32, the forward's;
// delta: fp32 scratch of 2 * B * H * Sp floats, Sp = seq_q rounded up to
// 128. H % Hkv == 0, D in {32, 64, 128, 256};
// window < 0: no window; softcap <= 0: no softcap. Three launches on
// `stream`, in order; returns the first launch error.
extern "C" int flash_attn_bwd(int bf16_in, const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const void* lse,
                              void* delta, void* dq, void* dk, void* dv, int batch,
                              int heads, int kv_heads, int seq_q, int seq_kv, int head_dim,
                              float scale, int causal, int window, float softcap,
                              void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_kv <= 0 || seq_q / 32 > 65535 ||
      seq_kv / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_in
             ? dispatch<bf16>(q, k, v, o, dout, (const float*)lse, (float*)delta, dq, dk,
                              dv, batch, heads, kv_heads, seq_q, seq_kv, head_dim, scale,
                              causal, window, softcap, st)
             : dispatch<float>(q, k, v, o, dout, (const float*)lse, (float*)delta, dq, dk,
                               dv, batch, heads, kv_heads, seq_q, seq_kv, head_dim, scale,
                               causal, window, softcap, st);
}
