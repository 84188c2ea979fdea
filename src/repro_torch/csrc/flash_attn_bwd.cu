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
// inputs: the five products on the tensor cores (mma.sync m16n8k16, fp32
// accumulation), P and dS rounded to bf16 before their products, as every
// tensor-core flash backward does; the softmax arithmetic in fp32. The
// outputs are rounded once, to the inputs' type.
// kernels/ref.py::flash_attention_bwd_tol holds the result.
//
// Bound: five products of 2 * D flops a kept (query, key) pair (2.5x the
// forward's), against reading q, k, v, o, dO once and writing dq, dk, dv:
// at the training shape thousands of flops a byte, so bound by the
// operations at the type's rate (bf16: 989 TFLOP/s on the tensor cores;
// fp32: 67 TFLOP/s of FMAs on an H100 SXM). This first version issues
// mma.sync from registers and shared memory, one tile at a time; wgmma,
// TMA and a pipeline of tiles are a later version's work.
//
// Design: three launches, in stream order, and no atomics, so a result
// repeats bit for bit.
// (a) dot_kernel: D_i = dO_i . o_i, one warp a (batch, row, head), fp32, a
//     fixed order; written as (B, H, S) like lse.
// (b) dkdv: one CTA of 256 threads a (batch, kv head, tile of BT keys). K
//     and V of its tile sit in shared memory; dK and dV accumulate in
//     registers over the query heads of its group (GQA summed inside the
//     CTA) and the query tiles the masks leave (the causal band and the
//     window's edge bound the tiles it visits). For each query tile it
//     loads Q, dO, lse and D, recomputes S = Q.K^T and dP = dO.V^T, writes
//     P and dS to shared memory and adds P^T.dO to dV and dS^T.Q to dK.
// (c) dq: one CTA a (batch, head, tile of BT queries), the longest rows
//     first. Q, dO, lse and D stay in shared memory; for each key tile the
//     masks leave it recomputes S and dP, writes dS, and adds dS.K to dQ in
//     registers.
// (b) and (c) recompute S and dP each: two products more than one pass
// with float atomics on dQ would take, which would not repeat bit for bit.
// fp32 (dkdv_kernel, dq_kernel): every tile is fp32 in shared memory, rows
// padded by one float so that the column reads of a product meet no bank
// conflict; each thread of a 16 x 16 grid owns the entries (ty + 16a, tx +
// 16c) of a product's output and takes them as FMAs over the shared dim.
// BT is 64 up to D 128 and 32 at D 256, so that the six tiles fit.
// bf16 (dkdv_tc_kernel, dq_tc_kernel): BT 64, tiles in bf16 with rows
// padded by 16 bytes; 8 warps, each owning 16 rows x 32 keys of S and dP
// and then 16 rows x D/2 columns of the output. A fragments load as 32-bit
// pairs from tiles whose shared dim is contiguous (Q, dO; P^T and dS^T
// written transposed; dS); the B fragments of dO, Q (for dV, dK) and K
// (for dQ), whose shared dim is the row, come through ldmatrix.trans.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

template <typename T, int D, bool kSoftcap>
int launch_cap(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq, void* dk,
               void* dv, int B, int H, int Hkv, int S, int Skv, float scale, int causal,
               int window, float softcap, cudaStream_t st) {
  constexpr bool kTc = std::is_same<T, bf16>::value;   // bf16: the tensor cores
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
// delta: (B, H, S) fp32 scratch. H % Hkv == 0, D in {32, 64, 128, 256};
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
