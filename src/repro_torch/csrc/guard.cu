// The train step's non-finite guard in two multi-tensor kernels: one pass
// that unscales the synced gradients and counts their non-finite elements,
// and one launch after LARS that keeps LARS's output unless the step is
// skipped.
//
// Replaces no TPU kernel: the JAX package leaves its guard to XLA
// (src/repro/train/trainer.py:make_train_step, an all-finite flag and
// jnp.where selects that XLA fuses). In eager PyTorch the same code is about
// ten launches a leaf (g * inv, isfinite, ~, sum, then a where over each p
// and each v), ~1,670 launches a ResNet-50 step and ~3,300 over Qwen3-1.7B's
// 310 leaves, with the selects reading and writing every parameter and
// momentum element again. Here (train/trainer.py:make_train_step, which
// keeps the finite flag and the loss scale's rules as ops on 0-d tensors):
//   guard_unscale_count_kernel: g = g * (1 / scale) in place, and the count
//     of non-finite elements of the result added into one int64 counter;
//     with no scale (the guard off) it only counts.
//   guard_commit_kernel: reads the step's finite flag on the device and,
//     only when it is false, copies the old params and momenta over LARS's
//     outputs.
// Bit for bit the plain version (kernels/ref.py:guard_unscale_count_ref,
// guard_commit_ref): one round-to-nearest multiply by the correctly rounded
// reciprocal (what torch's 1.0 / scale and g * inv give), integer counts,
// whose sum is exact in any order, and a select that is a copy of the old
// value or nothing.
//
// Bound: device-memory bytes. The unscale reads and writes each gradient
// element once (8 bytes, one multiply): 2 x 4 B x n / 3.35 TB/s, 4.11 ms
// over Qwen3-1.7B's 1,720,574,976 parameters. The commit reads one flag
// and, on a finite step, no parameter byte; a skipped step copies p and v
// (16 bytes an element), which is what the selects wrote on every step.
//
// Design, as csrc/lars_update.cu: a table of the leaves (pointers, sizes,
// each leaf's first block) goes by value in the launch's parameters
// (__grid_constant__), so no host-to-device copy precedes a launch; the
// wrapper (kernels/guard.py) cuts the leaves into tables of up to 512 and
// each leaf into blocks of `chunk` elements (kernels/lars_update.py:
// leaf_plan). A block of the unscale owns one chunk, found by a binary
// search of the table, and moves it with 16-byte accesses (a scalar head
// up to the first 16-byte boundary, so any leaf offset in a flat buffer
// vectorises), four loads in flight a thread. Its count is summed over
// the block and added with one integer atomic, and only when it is not
// zero: a clean step makes no atomic. The unscale writes every element
// whatever the scale: its cost does not depend on the scale's value. The
// commit is a grid of a few CTAs an SM that every CTA leaves at once on a
// finite step; on a skipped one they stride over the table's chunks. Both
// launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 512;   // leaves a launch; the wrapper splits beyond
constexpr int kUnroll = 4;        // 16-byte loads in flight a thread

struct UnscaleTable {
  float* g[kMaxLeaves];
  int n[kMaxLeaves];              // the leaf's elements
  int chunk0[kMaxLeaves + 1];     // its first block; chunk0[n_leaves] = blocks
  int n_leaves;
  int chunk;                      // elements a block, a multiple of 4
};

struct CommitTable {
  const float* p_old[kMaxLeaves];
  float* p_new[kMaxLeaves];
  const float* v_old[kMaxLeaves];
  float* v_new[kMaxLeaves];
  int n[kMaxLeaves];
  int chunk0[kMaxLeaves + 1];
  int n_leaves;
  int chunk;
};

// the leaf that owns block b: the last i with chunk0[i] <= b
template <typename Table>
__device__ __forceinline__ int find_leaf(const Table& t, int b) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.chunk0[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<unsigned long long>(a) & 15) == 0;
}

// 1 for NaN and +-Inf: every exponent bit set
__device__ __forceinline__ int nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

template <bool kWrite>
__device__ __forceinline__ int unscale4(float4& a, float inv) {
  if (kWrite) {
    a.x = __fmul_rn(a.x, inv);
    a.y = __fmul_rn(a.y, inv);
    a.z = __fmul_rn(a.z, inv);
    a.w = __fmul_rn(a.w, inv);
  }
  return nonfinite(a.x) + nonfinite(a.y) + nonfinite(a.z) + nonfinite(a.w);
}

// unscale (kWrite) and count one chunk of `len` floats at g; the thread's count
template <bool kWrite>
__device__ __forceinline__ int unscale_chunk(float* g, int len, float inv) {
  int bad = 0;
  // scalar head up to the first 16-byte boundary (a float is 4-byte aligned)
  const int head = min(len, (int)((16 - (reinterpret_cast<unsigned long long>(g) & 15)) & 15) / 4);
  if ((int)threadIdx.x < head) {
    float x = g[threadIdx.x];
    if (kWrite) g[threadIdx.x] = x = __fmul_rn(x, inv);
    bad += nonfinite(x);
  }
  float4* g4 = reinterpret_cast<float4*>(g + head);
  const int n4 = (len - head) / 4;
  int j = threadIdx.x;
  for (; j + (kUnroll - 1) * kThreads < n4; j += kUnroll * kThreads) {
    float4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = g4[j + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bad += unscale4<kWrite>(a[u], inv);
      if (kWrite) g4[j + u * kThreads] = a[u];
    }
  }
  for (; j < n4; j += kThreads) {
    float4 a = g4[j];
    bad += unscale4<kWrite>(a, inv);
    if (kWrite) g4[j] = a;
  }
  for (int k = head + 4 * n4 + threadIdx.x; k < len; k += kThreads) {
    float x = g[k];
    if (kWrite) g[k] = x = __fmul_rn(x, inv);
    bad += nonfinite(x);
  }
  return bad;
}

template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
    guard_unscale_count_kernel(const __grid_constant__ UnscaleTable t,
                               const float* __restrict__ scale,
                               unsigned long long* __restrict__ count) {
  __shared__ int red[kThreads / 32];
  const int i = find_leaf(t, blockIdx.x);
  const long long start = (long long)(blockIdx.x - t.chunk0[i]) * t.chunk;
  const int len = (int)min((long long)t.chunk, t.n[i] - start);
  // the reciprocal rounded once, as torch's 1.0 / scale (exact for the
  // powers of two the loss scale takes)
  const float inv = kWrite ? __frcp_rn(*scale) : 1.f;
  int bad = unscale_chunk<kWrite>(t.g[i] + start, len, inv);
  bad = __reduce_add_sync(0xffffffffu, bad);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w];
    if (sum) atomicAdd(count, (unsigned long long)sum);
  }
}

__device__ __forceinline__ void copy_chunk(const float* src, float* dst, int len) {
  if (aligned16(src) && aligned16(dst)) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int j = threadIdx.x; j < len / 4; j += kThreads) d4[j] = s4[j];
    for (int k = len / 4 * 4 + threadIdx.x; k < len; k += kThreads) dst[k] = src[k];
  } else {
    for (int k = threadIdx.x; k < len; k += kThreads) dst[k] = src[k];
  }
}

__global__ void __launch_bounds__(kThreads)
    guard_commit_kernel(const __grid_constant__ CommitTable t,
                        const bool* __restrict__ finite) {
  if (*finite) return;   // LARS's output stands: no parameter byte moves
  const int blocks = t.chunk0[t.n_leaves];
  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int i = find_leaf(t, b);
    const long long start = (long long)(b - t.chunk0[i]) * t.chunk;
    const int len = (int)min((long long)t.chunk, t.n[i] - start);
    copy_chunk(t.p_old[i] + start, t.p_new[i] + start, len);
    copy_chunk(t.v_old[i] + start, t.v_new[i] + start, len);
  }
}

template <typename Table>
bool table_ok(const Table& t, int blocks) {
  return t.n_leaves > 0 && t.n_leaves <= kMaxLeaves && t.chunk > 0 &&
         t.chunk % 4 == 0 && blocks > 0 && blocks == t.chunk0[t.n_leaves];
}

}  // namespace

// 0 when the caller's tables have this file's layouts (their sizes in bytes).
extern "C" int guard_table_check(long long unscale_bytes, long long commit_bytes) {
  return unscale_bytes == (long long)sizeof(UnscaleTable) &&
                 commit_bytes == (long long)sizeof(CommitTable)
             ? 0
             : (int)cudaErrorInvalidValue;
}

// table: a host UnscaleTable, copied into the launch's parameters; scale:
// the fp32 loss scale on the device, or null to count without writing;
// count: an int64, zero before the first table's launch, that every launch
// adds its count into.
extern "C" int guard_unscale_count(const void* table, const float* scale,
                                   unsigned long long* count, int blocks,
                                   void* stream) {
  UnscaleTable t;
  memcpy(&t, table, sizeof t);
  if (!table_ok(t, blocks)) return (int)cudaErrorInvalidValue;
  if (scale)
    guard_unscale_count_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        t, scale, count);
  else
    guard_unscale_count_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        t, scale, count);
  return (int)cudaGetLastError();
}

// table: a host CommitTable; finite: the step's flag (a bool on the
// device); grid: CTAs, a few an SM.
extern "C" int guard_commit(const void* table, const bool* finite, int blocks, int grid,
                            void* stream) {
  CommitTable t;
  memcpy(&t, table, sizeof t);
  if (!table_ok(t, blocks) || grid <= 0) return (int)cudaErrorInvalidValue;
  guard_commit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, finite);
  return (int)cudaGetLastError();
}
