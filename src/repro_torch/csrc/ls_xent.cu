// Label-smoothed cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ls_xent.py::_ls_xent_kernel (the Pallas TPU
// kernel behind ls_xent_pallas), which is forward only. The backward is new:
// the port trains through this loss, and JAX never differentiated the kernel.
//
// Per row r with label y, smoothing a and V classes:
//   lse  = log sum_j exp(x_j)
//   loss = (1 - a) * (lse - x_y) - a * (sum_j x_j / V - lse)
//   dx_j = gout_r * (exp(x_j - lse) - (1 - a) * [j == y] - a / V)
//
// Bound: device-memory bytes. The forward reads the (R, V) logits once and
// writes two floats a row; the backward reads the logits, label, lse and
// upstream gradient once and writes (R, V) gradients. Both do a few flops
// a byte, so the least time is bytes / 3.35 TB/s. On an NVIDIA H100 80GB
// HBM3 at 700 W (python3 -m repro_torch.launch.profile_xent):
//
//   shape              kernel  bound ms   earlier design ms
//   (64, 1000) fp32    fwd     0.0000767  0.003029
//                      bwd     0.000153   0.002288
//   (4096, 151936)     fwd     0.7431     0.7956
//     fp32             bwd     1.4862     1.7895
//   (4096, 151936)     fwd     0.3716     0.6054
//     bf16             bwd     0.7431     1.0497
//
// The earlier design took a row a 256-thread block with one scalar load a
// thread in flight, merged the warps' partials in a serial loop on thread 0
// and then loaded x_y, a dependent load at the end of every row. Here:
// - Loads are 16 bytes (4 fp32 or 8 bf16 values). Each lane holds a span of
//   U of them (4; 8 fp32 vectors when a warp takes a row) and issues them all
//   before any arithmetic: 64-128 bytes a thread in flight, in either type.
//   A warp's U loads cover 32 * U adjacent vectors, so its traffic is one
//   contiguous run. The last span of a row is masked, not walked one vector
//   at a time. A row whose start is not 16-byte aligned (V odd in bf16,
//   V % 4 != 0 in fp32) takes a scalar head up to the first boundary and a
//   scalar tail; no case is refused.
// - The wrapper (kernels/ls_xent.py:row_threads) picks the threads a row at
//   launch, from measurements at the two shapes that run: a warp a row (4
//   rows a 128-thread block) for the forward over short rows (the ResNet-50
//   head), where all of a row's loads go out at once and the merge is 5
//   shuffle rounds with no shared memory; a block of 128 or 512 threads a
//   row otherwise, where the warps' partials are merged by one warp's
//   shuffles, not a loop on one thread.
// - The label is read at the top; the lane whose vector holds column y
//   keeps x_y from its registers, so nothing is loaded after the loop.
// - Each lane takes the max of the span it holds, then sums its
//   exponentials: the running (max, sum) pair is rescaled once a span, not
//   on every new maximum. Exponentials are ex2.approx in the log2 domain
//   (about 2^-22 relative).
// - The backward uses the same spans, one exponential an element, a/V and
//   1 - a hoisted, and reads gout and lse once a row. The wrapper gives
//   dlogits the logits' offset from a 16-byte boundary, so a lane's load
//   and store vectors line up.
// - A label outside [0, V) gives NaN (loss, and every dx of the row), which
//   the trainer's guard counts. Sums are fp32 in a fixed order with no
//   atomics, so a run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarpRowBlock = 128;   // threads a block when a warp takes a row

// 2^x in one MUFU instruction; a result below 2^-126 flushes to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// N values of T in one 16-byte vector, loaded and stored as fp32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[N]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[N]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// v[k] for a k known only at run time, without indexing registers by it
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int k) {
  float out = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) out = k == i ? v[i] : out;
  return out;
}

// The row that a thread works on, its index t among the row's G threads
// (warp w, lane), and where the row's 16-byte vectors start: `head` scalar
// columns up to the first boundary, then `nvec` vectors of N, then a scalar
// tail from `tail0`. Warp w takes the spans at w * 32 * U + k * G * U: with
// the warps' vectors interleaved at a stride of G instead, the backward at
// (4096, 151936) fp32 took 2.81 ms with 512 threads a row, against 1.71 ms
// with spans (PERF.md).
template <typename T, int G>
struct RowSplit {
  static constexpr int N = Vec<T>::N;
  long long r;
  int t, w, lane, head, nvec, tail0;
  __device__ __forceinline__ RowSplit(const T* base, int vocab) {
    if (G == 32) {
      r = (long long)blockIdx.x * (kWarpRowBlock / 32) + threadIdx.x / 32;
      t = threadIdx.x % 32;
    } else {
      r = blockIdx.x;
      t = threadIdx.x;
    }
    w = t / 32;
    lane = t % 32;
    const uintptr_t a = reinterpret_cast<uintptr_t>(base + r * vocab);
    head = min(vocab, (int)(((16 - (a & 15)) & 15) / sizeof(T)));
    nvec = (vocab - head) / N;
    tail0 = head + nvec * N;
  }
};

// Merge (m2, s2) into the running pair (m, s): s is sum exp(x - m).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * ex2((m - mn) * kLog2e) + s2 * ex2((m2 - mn) * kLog2e);
  m = mn;
}

// One scalar column into the running (m, s, sum) and, at y, x_y.
__device__ __forceinline__ void take_scalar(float x, long long col, long long y,
                                            float& m, float& s, float& sum, float& xy) {
  merge(m, s, x, 1.f);
  sum += x;
  if (col == y) xy = x;
}

// A lane's span: vectors base + u * 32 + lane for u < U, so one warp
// instruction covers 32 adjacent vectors and the warp's U instructions one
// contiguous run. MASKED spans run past nvec: an absent vector reads as
// -inf and ok[u] is false.
template <bool MASKED, int U, typename T>
__device__ __forceinline__ void load_span(const T* body, int nvec, int base, int lane,
                                          float (&v)[U][Vec<T>::N], bool (&ok)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * 32 + lane;
    ok[u] = !MASKED || i < nvec;
    if (ok[u]) {
      Vec<T>::load(body + (size_t)i * Vec<T>::N, v[u]);
    } else {
#pragma unroll
      for (int k = 0; k < Vec<T>::N; ++k) v[u][k] = -INFINITY;
    }
  }
}

// A span into the running (m, s, sum) and, at column y, x_y: all its loads
// are issued first, then its max, then its exponentials, so (m, s) is
// rescaled once a span.
template <bool MASKED, int U, typename T>
__device__ __forceinline__ void fwd_span(const T* body, int head, int nvec, int base, int lane,
                                         long long y, float& m, float& s, float& sum,
                                         float& xy) {
  constexpr int N = Vec<T>::N;
  float v[U][N];
  bool ok[U];
  load_span<MASKED, U>(body, nvec, base, lane, v, ok);
  float cm[N], cs[N], cx[N];   // N partials each, so no chain is U * N long
#pragma unroll
  for (int k = 0; k < N; ++k) cm[k] = v[0][k];
#pragma unroll
  for (int u = 1; u < U; ++u)
#pragma unroll
    for (int k = 0; k < N; ++k) cm[k] = fmaxf(cm[k], v[u][k]);
  float mc = cm[0];
#pragma unroll
  for (int k = 1; k < N; ++k) mc = fmaxf(mc, cm[k]);
  const float mn = fmaxf(m, mc);
#pragma unroll
  for (int k = 0; k < N; ++k) cs[k] = 0.f, cx[k] = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      cs[k] += ex2((v[u][k] - mn) * kLog2e);   // 0 for an absent vector
      cx[k] += ok[u] ? v[u][k] : 0.f;
    }
  float ss = 0.f, sx = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) ss += cs[k], sx += cx[k];
  s = s * ex2((m - mn) * kLog2e) + ss;
  m = mn;
  sum += sx;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long d = y - (head + (long long)(base + u * 32 + lane) * N);
    if (ok[u] && (unsigned long long)d < (unsigned long long)N) xy = pick(v[u], (int)d);
  }
}

// dx of a span, stored where its vectors came from; column y also takes
// -(1 - a). l is the row's lse, go its upstream gradient.
template <bool MASKED, int U, typename T>
__device__ __forceinline__ void bwd_span(const T* body, T* dbody, int head, int nvec, int base,
                                         int lane, long long y, float l, float go, float off,
                                         float hit) {
  constexpr int N = Vec<T>::N;
  float v[U][N];
  bool ok[U];
  load_span<MASKED, U>(body, nvec, base, lane, v, ok);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long d = y - (head + (long long)(base + u * 32 + lane) * N);
    const int k_y = (unsigned long long)d < (unsigned long long)N ? (int)d : -1;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float t = ex2((v[u][k] - l) * kLog2e) - off;
      if (k == k_y) t -= hit;
      v[u][k] = go * t;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u]) Vec<T>::store(dbody + (size_t)(base + u * 32 + lane) * N, v[u]);
}

// G threads a row (32: a warp; more: the block), U vectors a span.
template <typename T, int G, int U>
__global__ void __launch_bounds__(G == 32 ? kWarpRowBlock : G)
ls_xent_fwd_kernel(const T* __restrict__ logits, const long long* __restrict__ labels,
                   float* __restrict__ loss, float* __restrict__ lse_out, long long rows,
                   int vocab, float smoothing) {
  const RowSplit<T, G> rs(logits, vocab);
  if (rs.r >= rows) return;   // a whole warp (G == 32); never a block
  const long long y = labels[rs.r];
  const T* row = logits + rs.r * vocab;
  // -FLT_MAX, not -inf: merging two empty partials must not give inf - inf
  float m = -FLT_MAX, s = 0.f, sum = 0.f, xy = 0.f;
  for (int base = rs.w * 32 * U; base < rs.nvec; base += G * U) {
    if (base + 32 * U <= rs.nvec)   // warp-uniform
      fwd_span<false, U>(row + rs.head, rs.head, rs.nvec, base, rs.lane, y, m, s, sum, xy);
    else
      fwd_span<true, U>(row + rs.head, rs.head, rs.nvec, base, rs.lane, y, m, s, sum, xy);
  }
  if (rs.t < rs.head) take_scalar(to_f(row[rs.t]), rs.t, y, m, s, sum, xy);
  if (rs.t < vocab - rs.tail0)
    take_scalar(to_f(row[rs.tail0 + rs.t]), rs.tail0 + rs.t, y, m, s, sum, xy);

  // x_y is held by one thread and 0 elsewhere, so a sum finds it exactly
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, s, off));
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    xy += __shfl_xor_sync(0xffffffffu, xy, off);
  }
  if (G > 32) {   // the warps' partials, merged by warp 0's shuffles
    constexpr int W = G / 32;
    __shared__ float part[4][W];
    if (rs.lane == 0)
      part[0][rs.w] = m, part[1][rs.w] = s, part[2][rs.w] = sum, part[3][rs.w] = xy;
    __syncthreads();
    if (rs.w != 0) return;
    const bool mine = rs.lane < W;
    m = mine ? part[0][rs.lane] : -FLT_MAX;
    s = mine ? part[1][rs.lane] : 0.f;
    sum = mine ? part[2][rs.lane] : 0.f;
    xy = mine ? part[3][rs.lane] : 0.f;
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) {
      merge(m, s, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, s, off));
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      xy += __shfl_xor_sync(0xffffffffu, xy, off);
    }
  }
  if (rs.t == 0) {
    const float lse = m + logf(s);
    const bool bad = y < 0 || y >= vocab;
    loss[rs.r] = bad ? NAN
                     : (1.f - smoothing) * (lse - xy) - smoothing * (sum / (float)vocab - lse);
    lse_out[rs.r] = lse;
  }
}

template <typename T, int G, int U>
__global__ void __launch_bounds__(G == 32 ? kWarpRowBlock : G)
ls_xent_bwd_kernel(const T* __restrict__ logits, const long long* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ gout,
                   T* __restrict__ dlogits, long long rows, int vocab, float smoothing) {
  const RowSplit<T, G> rs(logits, vocab);
  if (rs.r >= rows) return;
  const long long y = labels[rs.r];
  const bool bad = y < 0 || y >= vocab;
  const float l = lse[rs.r], go = bad ? NAN : gout[rs.r];
  const float off = smoothing / (float)vocab, hit = 1.f - smoothing;
  const T* row = logits + rs.r * vocab;
  T* drow = dlogits + rs.r * vocab;
  for (int base = rs.w * 32 * U; base < rs.nvec; base += G * U) {
    if (base + 32 * U <= rs.nvec)   // warp-uniform
      bwd_span<false, U>(row + rs.head, drow + rs.head, rs.head, rs.nvec, base, rs.lane, y, l,
                         go, off, hit);
    else
      bwd_span<true, U>(row + rs.head, drow + rs.head, rs.head, rs.nvec, base, rs.lane, y, l,
                        go, off, hit);
  }
  auto scalar = [&](int j) {
    float t = ex2((to_f(row[j]) - l) * kLog2e) - off;
    if (j == y) t -= hit;
    drow[j] = from_f<T>(go * t);
  };
  if (rs.t < rs.head) scalar(rs.t);   // the scalar head and tail, under N columns each
  if (rs.t < vocab - rs.tail0) scalar(rs.tail0 + rs.t);
}

template <typename T, int G, int U>
cudaError_t launch_fwd(const void* logits, const long long* labels, float* loss, float* lse,
                       long long rows, int vocab, float smoothing, cudaStream_t st) {
  const long long blocks = G == 32 ? (rows + kWarpRowBlock / 32 - 1) / (kWarpRowBlock / 32) : rows;
  ls_xent_fwd_kernel<T, G, U><<<(unsigned)blocks, G == 32 ? kWarpRowBlock : G, 0, st>>>(
      (const T*)logits, labels, loss, lse, rows, vocab, smoothing);
  return cudaGetLastError();
}

template <typename T, int G, int U>
cudaError_t launch_bwd(const void* logits, const long long* labels, const float* lse,
                       const float* gout, void* dlogits, long long rows, int vocab,
                       float smoothing, cudaStream_t st) {
  const long long blocks = G == 32 ? (rows + kWarpRowBlock / 32 - 1) / (kWarpRowBlock / 32) : rows;
  ls_xent_bwd_kernel<T, G, U><<<(unsigned)blocks, G == 32 ? kWarpRowBlock : G, 0, st>>>(
      (const T*)logits, labels, lse, gout, (T*)dlogits, rows, vocab, smoothing);
  return cudaGetLastError();
}

// Calls F<T, G, U>(args...) for the dtype code and threads a row: 32 (a warp
// a row; 8 fp32 or 4 bf16 vectors in flight a thread, so one pass of the
// warp covers 1024 columns) or a block of 128 or 512 (4 vectors). These are
// the mappings that the ResNet-50 head's and Qwen3-1.7B's rows take.
#define LS_XENT_DISPATCH(F, dtype, row_threads, ...)                                   \
  do {                                                                                 \
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;                   \
    switch (row_threads) {                                                             \
      case 32:                                                                         \
        return (int)(dtype == 0 ? F<float, 32, 8>(__VA_ARGS__) : F<bf16, 32, 4>(__VA_ARGS__)); \
      case 128:                                                                        \
        return (int)(dtype == 0 ? F<float, 128, 4>(__VA_ARGS__) : F<bf16, 128, 4>(__VA_ARGS__)); \
      case 512:                                                                        \
        return (int)(dtype == 0 ? F<float, 512, 4>(__VA_ARGS__) : F<bf16, 512, 4>(__VA_ARGS__)); \
      default:                                                                         \
        return (int)cudaErrorInvalidValue;                                             \
    }                                                                                  \
  } while (0)

}  // namespace

// dtype: 0 = fp32 logits, 1 = bf16 logits. Rows are contiguous, row-major.
// row_threads: 32 (a warp a row) or 128, 512 (a block a row).
extern "C" int ls_xent_fwd(const void* logits, int dtype, const long long* labels, float* loss,
                           float* lse, long long rows, int vocab, float smoothing,
                           int row_threads, void* stream) {
  if (rows <= 0) return 0;
  if (vocab <= 0 || ((uintptr_t)logits % (dtype == 1 ? 2 : 4)) != 0)
    return (int)cudaErrorInvalidValue;
  LS_XENT_DISPATCH(launch_fwd, dtype, row_threads, logits, labels, loss, lse, rows, vocab,
                   smoothing, (cudaStream_t)stream);
}

// dlogits must sit at the same offset from a 16-byte boundary as logits.
extern "C" int ls_xent_bwd(const void* logits, int dtype, const long long* labels,
                           const float* lse, const float* gout, void* dlogits, long long rows,
                           int vocab, float smoothing, int row_threads, void* stream) {
  if (rows <= 0) return 0;
  if (vocab <= 0 || ((uintptr_t)logits % (dtype == 1 ? 2 : 4)) != 0 ||
      (((uintptr_t)logits ^ (uintptr_t)dlogits) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  LS_XENT_DISPATCH(launch_bwd, dtype, row_threads, logits, labels, lse, gout, dlogits, rows,
                   vocab, smoothing, (cudaStream_t)stream);
}
