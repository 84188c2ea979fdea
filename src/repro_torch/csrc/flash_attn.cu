// Flash-attention forward: softmax(mask(softcap(q*scale . k^T))) . v with an
// online softmax, so the (S, Skv) logits never reach device memory.
//
// Replaces: src/repro/kernels/flash_attn.py::_flash_kernel (the Pallas TPU
// kernel behind flash_attention_hsd / flash_attention). Per query row i and
// key j, with positions counted from 0 in both:
//   s_ij = (q_i * scale) . k_j                       (fp32)
//   s_ij = softcap * tanh(s_ij / softcap)            (when softcap > 0)
//   keep j iff j < Skv, j <= i (causal), j > i - window (window >= 0)
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
// fp32 in, math and out. bf16 inputs go to csrc/flash_attn_tc.cu, the
// tensor-core kernel: on the tensor cores fp32 would be TF32, which misses
// the fp32 tolerance, so this kernel stays for fp32 (the smoke configs).
//
// Differences from the TPU kernel, none of which changes a result the model
// can see: keys at j >= Skv are always masked (the JAX wrapper pads k/v with
// zeros and masks the padding only through the causal test); k-blocks that
// lie wholly outside the causal/window band are skipped, not visited and
// masked. A query row with no key to attend (a window and S >= Skv + window)
// would come out 0 where the plain version gives the mean of v, so the
// wrapper refuses such calls (kernels/flash_attn.py).
//
// Bound: at the prefill shapes the work is 4*S*Skv*D flops a (batch, head)
// pair (halved by the causal mask) against 2*(S+Skv)*D elements moved, so
// it is bound by operations. It does them as fp32 FMAs on the CUDA cores, as
// the TPU kernel's fp32 math does: 67 TFLOP/s at best.
//
// Design: the TPU grid walks k-blocks in sequence and carries (m, l, acc) in
// VMEM scratch between grid steps. Here one CTA owns one (batch, head,
// 64-query block) and loops over the k-blocks itself, keeping m, l and the
// fp32 output accumulator in registers. q, k and v tiles are staged in
// shared memory as fp32 (q pre-scaled); the probability tile reuses the k
// tile's space. 256 threads as a 16x16 grid: thread (ty, tx) owns query rows
// ty + 16r (r < 4), so each row's max and sum reduce over the 16 lanes of a
// half-warp with shuffles, and key columns tx + 16c (c < 4), which makes the
// k-tile reads conflict-free. GQA reads kv head h / (H / Hkv) in place of
// repeating k and v in memory. Query blocks are issued last-first so the
// causal mask's longest rows start first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64;          // query rows and keys a tile
constexpr float kNegInf = -1e30f;   // NEG_INF of the TPU kernel

__device__ __forceinline__ void to_f(const float4& raw, float* out) {
  out[0] = raw.x;
  out[1] = raw.y;
  out[2] = raw.z;
  out[3] = raw.w;
}

template <typename T>
struct Vec;  // one 16-byte load of T
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// rows x D elements of T at src (row stride in elements) -> fp32 smem rows
// of stride ld, times mul; rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int valid,
                                          float mul) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n;
  constexpr int per_row = D / n;
  for (int idx = threadIdx.x; idx < kBlock * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx % per_row) * n;
    float f[n];
    if (r < valid) {
      to_f(*reinterpret_cast<const V*>(src + r * stride + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < n; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < n; e += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + e) =
          make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul,
                      f[e + 3] * mul);
  }
}

template <int D>
struct Shape {
  static constexpr int ld = D + 4;              // q/k/v smem row stride
  static constexpr int ldp = kBlock + 4;        // probability tile stride
  static constexpr int kp = ld > ldp ? ld : ldp;
  static constexpr int cw = D >= 64 ? 4 : 2;    // output columns a chunk
  static constexpr int nc = D / (16 * cw);      // output chunks a thread
  static constexpr size_t smem = sizeof(float) * kBlock * (2 * ld + kp);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int Hkv, int S, int Skv, float scale, int causal,
                     int window, float softcap) {
  using Sh = Shape<D>;
  constexpr int ld = Sh::ld, ldp = Sh::ldp, cw = Sh::cw, nc = Sh::nc;
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* vs = qs + kBlock * ld;
  float* ks = vs + kBlock * ld;   // k tile, then the probability tile
  float* ps = ks;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qb * kBlock;
  const long long q_stride = (long long)H * D, kv_stride = (long long)Hkv * D;
  const T* qp = q + ((long long)b * S + q0) * q_stride + (long long)h * D;
  const T* kp = k + (long long)b * Skv * kv_stride + (long long)hk * D;
  const T* vp = v + (long long)b * Skv * kv_stride + (long long)hk * D;

  load_tile<T, D>(qs, ld, qp, q_stride, min(kBlock, S - q0), scale);

  // keys that some row of this block may attend
  int k_end = Skv;
  if (causal) k_end = min(k_end, q0 + kBlock);
  const int k_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kb_end = (k_end + kBlock - 1) / kBlock;

  float m[4], l[4], acc[4][nc * cw];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < nc * cw; ++e) acc[r][e] = 0.f;
  }

  for (int kb = k_begin / kBlock; kb < kb_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();   // the last block's p.v is done with ps and vs
    load_tile<T, D>(ks, ld, kp + k0 * kv_stride, kv_stride,
                    min(kBlock, Skv - k0), 1.f);
    load_tile<T, D>(vs, ld, vp + k0 * kv_stride, kv_stride,
                    min(kBlock, Skv - k0), 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * ld + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * ld + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = s[r][c];
          a = fmaf(qv[r].x, kv[c].x, a);
          a = fmaf(qv[r].y, kv[c].y, a);
          a = fmaf(qv[r].z, kv[c].z, a);
          a = fmaf(qv[r].w, kv[c].w, a);
          s[r][c] = a;
        }
    }

    // mask, softcap and the online softmax update, row by row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[r][c];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        keep[c] = kj < Skv && (!causal || kj <= qi) &&
                  (window < 0 || kj > qi - window);
        s[r][c] = x;
        if (keep[c]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = keep[c] ? expf(s[r][c] - m_new) : 0.f;
        s[r][c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < nc * cw; ++e) acc[r][e] *= alpha;
    }

    __syncthreads();   // every thread is done reading ks
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) ps[(ty + 16 * r) * ldp + tx + 16 * c] = s[r][c];
    __syncthreads();

    // acc += p . v; thread columns are chunks of cw at tx*cw + 16*cw*i
#pragma unroll 2
    for (int j = 0; j < kBlock; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(ps + (ty + 16 * r) * ldp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j + jj) * ld + tx * cw;
        float vv[nc * cw];
#pragma unroll
        for (int i = 0; i < nc; ++i) {
          if constexpr (cw == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + 16 * cw * i);
            vv[4 * i] = t.x;
            vv[4 * i + 1] = t.y;
            vv[4 * i + 2] = t.z;
            vv[4 * i + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow + 16 * cw * i);
            vv[2 * i] = t.x;
            vv[2 * i + 1] = t.y;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = jj == 0 ? pv[r].x : jj == 1 ? pv[r].y
                        : jj == 2 ? pv[r].z : pv[r].w;
#pragma unroll
          for (int e = 0; e < nc * cw; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (q0 + row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((long long)b * S + q0 + row) * q_stride + (long long)h * D;
#pragma unroll
    for (int i = 0; i < nc; ++i)
#pragma unroll
      for (int e = 0; e < cw; ++e)
        store(orow + tx * cw + 16 * cw * i + e, acc[r][i * cw + e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int S, int Skv, float scale, int causal, int window,
           float softcap, cudaStream_t st) {
  constexpr size_t smem = Shape<D>::smem;
  static bool configured = false;   // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, S, Skv, scale,
      causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int Skv, int D, float scale, int causal,
             int window, float softcap, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, S, Skv, scale, causal, window, softcap, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, S, Skv, scale, causal, window, softcap, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, S, Skv, scale, causal, window, softcap, st);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, Hkv, S, Skv, scale, causal, window, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, Skv, Hkv, D); all fp32, contiguous, 16-byte
// aligned. H % Hkv == 0, D in {32, 64, 128, 256}. window < 0: no window;
// softcap <= 0: no softcap.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int batch, int heads,
                              int kv_heads, int seq_q, int seq_kv,
                              int head_dim, float scale, int causal,
                              int window, float softcap, void* stream) {
  if (batch <= 0 || seq_q <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq_kv <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_d<float>(q, k, v, o, batch, heads, kv_heads, seq_q, seq_kv,
                         head_dim, scale, causal, window, softcap,
                         (cudaStream_t)stream);
}
