// Label-smoothed cross-entropy, forward and backward, one row per block.
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
// a byte, so the least time is bytes / 3.35 TB/s.
//
// Design: the TPU kernel walks vocab tiles in sequence and carries an
// online logsumexp in scratch between grid steps. Here blocks run in
// parallel with nothing carried between them, so one block owns a row:
// its threads stride over the vocab together (coalesced loads), each keeps
// an online (max, sum of exp) pair plus the plain sum, and the block merges
// the partials with warp shuffles and one shared-memory pass. No (R, V)
// intermediate is written: the forward saves only the per-row lse that the
// backward needs. Logits are fp32 or bf16 and all arithmetic is fp32. A
// label outside [0, V) yields NaN, which the trainer's guard counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Merge (m2, s2) into the online logsumexp pair (m, s).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void ls_xent_fwd_kernel(const T* __restrict__ logits,
                                   const long long* __restrict__ labels,
                                   float* __restrict__ loss,
                                   float* __restrict__ lse_out, int vocab,
                                   float smoothing) {
  const long long r = blockIdx.x;
  const T* row = logits + r * vocab;
  // -FLT_MAX, not -inf: merging two empty partials must not give inf - inf.
  float m = -FLT_MAX, s = 0.f, sum = 0.f;
  for (int j = threadIdx.x; j < vocab; j += kThreads) {
    const float x = to_f(row[j]);
    if (x > m) {
      s = s * expf(m - x) + 1.f;
      m = x;
    } else {
      s += expf(x - m);
    }
    sum += x;
  }
  for (int off = 16; off > 0; off >>= 1) {
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, s, off));
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  __shared__ float sm[kThreads / 32], ss[kThreads / 32], ssum[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
    ssum[warp] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      merge(m, s, sm[w], ss[w]);
      sum += ssum[w];
    }
    const float lse = m + logf(s);
    const long long y = labels[r];
    const float x_y = (y >= 0 && y < vocab) ? to_f(row[y]) : NAN;
    loss[r] = (1.f - smoothing) * (lse - x_y) -
              smoothing * (sum / (float)vocab - lse);
    lse_out[r] = lse;
  }
}

template <typename T>
__global__ void ls_xent_bwd_kernel(const T* __restrict__ logits,
                                   const long long* __restrict__ labels,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ gout,
                                   T* __restrict__ dlogits, int vocab,
                                   float smoothing) {
  const long long r = blockIdx.x;
  const T* row = logits + r * vocab;
  T* drow = dlogits + r * vocab;
  const long long y = labels[r];
  const bool bad = y < 0 || y >= vocab;
  const float l = lse[r], go = gout[r];
  const float off = smoothing / (float)vocab, hit = 1.f - smoothing;
  for (int j = threadIdx.x; j < vocab; j += kThreads) {
    const float p = expf(to_f(row[j]) - l);
    const float d = bad ? NAN : go * (p - off - (j == y ? hit : 0.f));
    drow[j] = from_f<T>(d);
  }
}

}  // namespace

// dtype: 0 = fp32 logits, 1 = bf16 logits. Rows are contiguous, row-major.
extern "C" int ls_xent_fwd(const void* logits, int dtype,
                           const long long* labels, float* loss, float* lse,
                           long long rows, int vocab, float smoothing,
                           void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    ls_xent_fwd_kernel<float><<<(unsigned)rows, kThreads, 0, st>>>(
        (const float*)logits, labels, loss, lse, vocab, smoothing);
  else if (dtype == 1)
    ls_xent_fwd_kernel<__nv_bfloat16><<<(unsigned)rows, kThreads, 0, st>>>(
        (const __nv_bfloat16*)logits, labels, loss, lse, vocab, smoothing);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ls_xent_bwd(const void* logits, int dtype,
                           const long long* labels, const float* lse,
                           const float* gout, void* dlogits, long long rows,
                           int vocab, float smoothing, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    ls_xent_bwd_kernel<float><<<(unsigned)rows, kThreads, 0, st>>>(
        (const float*)logits, labels, lse, gout, (float*)dlogits, vocab,
        smoothing);
  else if (dtype == 1)
    ls_xent_bwd_kernel<__nv_bfloat16><<<(unsigned)rows, kThreads, 0, st>>>(
        (const __nv_bfloat16*)logits, labels, lse, gout,
        (__nv_bfloat16*)dlogits, vocab, smoothing);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
