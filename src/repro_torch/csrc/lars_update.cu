// LARS step over every leaf of a model in two launches: the norms, then the
// update.
//
// Replaces: src/repro/kernels/lars_update.py::_lars_kernel (the Pallas TPU
// kernel behind lars_update_pallas, one leaf a call, its trust ratio computed
// outside), and the per-leaf loop of core/lars.py::update around it. Per leaf
// with LARS (core/lars.py::is_skip false):
//   trust = eta*||p|| / (||g|| + wd*||p|| + eps), or 1 when a norm is 0
//   v'    = mom * v + trust * lr * (g + wd * p)
//   s     = nesterov ? mom * v' + (v' - mom * v) : v'
//   p'    = p - s
// and per skip leaf (BN, biases) the same with trust 1 and wd 0, which is
// plain momentum SGD. All fp32.
//
// Bound: device-memory bytes. Each element reads p, g, v and writes p', v'
// (20 bytes, a handful of flops), far below the H100's ~295 flops per byte,
// so the least time is 20 * n / 3.35 TB/s. The norm pass reads p and g a
// second time (8 bytes an element more): the price of computing each
// leaf's norms before any block of it updates, without float atomics.
//
// Groups. ||p|| and ||g|| are taken over a LARS group: one leaf, or the
// consecutive leaves that the reference holds as one stacked array (a
// transformer's repeated layers, convert.leaf_groups), whose norms are the
// norms over all of the group's leaves. A group's leaves may span two
// tables: the wrapper issues every norms launch before the first apply.
//
// Design: a table of the leaves (pointers, sizes, the LARS-or-skip flag,
// the offset into the flat outputs, the first block of each leaf, its
// group and the group's blocks) goes by value in the kernel parameters
// (__grid_constant__, up to 32,764 bytes on CUDA 12.1+), so no
// host-to-device copy precedes a launch. Block b owns a fixed chunk of one
// leaf, found by a binary search of the table.
// - lars_norms_kernel: each block of a LARS leaf sums p^2 and g^2 over its
//   chunk and writes the two partial sums to its slot of a scratch buffer,
//   then counts itself in on its group (an integer atomic). The group's
//   last block to arrive sums all of the group's partials, in slot order,
//   and writes the group's two sums: which block does it varies, the order
//   of the sum does not, and the sum is taken once a group (a block that
//   summed its group itself would read a 28-layer group's ~10^4 partials,
//   ~10^4 times over).
// - lars_apply_kernel: each block of a LARS leaf reads its group's sums,
//   computes the trust ratio, then updates its chunk; a skip leaf's block
//   goes straight to the update.
// Every float sum runs in a fixed order and no float atomic is used, so a
// step's result repeats bit for bit. Loads and stores are 16 bytes a thread where
// a leaf's pointers allow it. The kernels allocate nothing and launch on the
// caller's stream; the wrapper (kernels/lars_update.py) owns the buffers.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 512;   // leaves a launch; the wrapper splits beyond

struct LarsTable {
  const float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  const float* v[kMaxLeaves];
  long long off[kMaxLeaves];      // the leaf's offset in the flat p', v'
  int n[kMaxLeaves];              // its elements
  int chunk0[kMaxLeaves + 1];     // its first block; chunk0[n_leaves] = blocks
  int lars[kMaxLeaves];           // 1: trust ratio and weight decay; 0: skip
  int grp[kMaxLeaves];            // its LARS group, counted over all tables
  int gb0[kMaxLeaves];            // the group's first block, over all tables
  int gb1[kMaxLeaves];            // one past the group's last block
  int base;                       // this table's first block, over all tables
  int n_leaves;
  int chunk;                      // elements a block, a multiple of 4
};

// the leaf that owns block b: the last i with chunk0[i] <= b
__device__ __forceinline__ int find_leaf(const LarsTable& t, int b) {
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

// sum over the block in a fixed order; the result lands in every thread
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();   // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
    lars_norms_kernel(const __grid_constant__ LarsTable t, float* partial,
                      int* __restrict__ count, float* __restrict__ sums) {
  __shared__ float red[kThreads / 32];
  const int i = find_leaf(t, blockIdx.x);
  if (!t.lars[i]) return;   // skip leaves need no norms
  const long long start = (long long)(blockIdx.x - t.chunk0[i]) * t.chunk;
  const int len = (int)min((long long)t.chunk, t.n[i] - start);
  const float* p = t.p[i] + start;
  const float* g = t.g[i] + start;
  float sp = 0.f, sg = 0.f;
  int done = 0;
  if (aligned16(p) && aligned16(g)) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int j = threadIdx.x; j < len / 4; j += kThreads) {
      const float4 a = p4[j], b = g4[j];
      sp += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
      sg += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
    }
    done = len / 4 * 4;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads) {
    sp += p[j] * p[j];
    sg += g[j] * g[j];
  }
  sp = block_sum(sp, red);
  sg = block_sum(sg, red);
  __shared__ int last;
  if (threadIdx.x == 0) {
    const int slot = t.base + blockIdx.x;
    partial[2 * slot] = sp;
    partial[2 * slot + 1] = sg;
    __threadfence();   // the partials are seen before the count
    last = atomicAdd(&count[t.grp[i]], 1) == t.gb1[i] - t.gb0[i] - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every partial of the group is in: sum them in slot order (L2 reads, as
  // other blocks wrote them)
  sp = 0.f;
  sg = 0.f;
  for (int c = t.gb0[i] + threadIdx.x; c < t.gb1[i]; c += kThreads) {
    sp += __ldcg(&partial[2 * c]);
    sg += __ldcg(&partial[2 * c + 1]);
  }
  sp = block_sum(sp, red);
  sg = block_sum(sg, red);
  if (threadIdx.x == 0) {
    sums[2 * t.grp[i]] = sp;
    sums[2 * t.grp[i] + 1] = sg;
  }
}

__device__ __forceinline__ void step(float p, float g, float v, float tl,
                                     float wd, float mom, int nesterov,
                                     float& p_new, float& v_new) {
  v_new = mom * v + tl * (g + wd * p);
  p_new = p - (nesterov ? mom * v_new + (v_new - mom * v) : v_new);
}

__global__ void __launch_bounds__(kThreads)
    lars_apply_kernel(const __grid_constant__ LarsTable t,
                      const float* __restrict__ sums,
                      float* __restrict__ p_out, float* __restrict__ v_out,
                      float lr, float mom, float eta, float wd, float eps,
                      int nesterov) {
  const int i = find_leaf(t, blockIdx.x);
  float tl = lr, wdl = 0.f;   // skip leaf: trust 1, no weight decay
  if (t.lars[i]) {
    const float w = sqrtf(sums[2 * t.grp[i]]), gn = sqrtf(sums[2 * t.grp[i] + 1]);
    const float trust = (w > 0.f && gn > 0.f) ? eta * w / (gn + wd * w + eps) : 1.f;
    tl = trust * lr;
    wdl = wd;
  }
  const long long start = (long long)(blockIdx.x - t.chunk0[i]) * t.chunk;
  const int len = (int)min((long long)t.chunk, t.n[i] - start);
  const float* p = t.p[i] + start;
  const float* g = t.g[i] + start;
  const float* v = t.v[i] + start;
  float* po = p_out + t.off[i] + start;
  float* vo = v_out + t.off[i] + start;
  int done = 0;
  if (aligned16(p) && aligned16(g) && aligned16(v) && aligned16(po) &&
      aligned16(vo)) {
    for (int j = threadIdx.x; j < len / 4; j += kThreads) {
      const float4 a = reinterpret_cast<const float4*>(p)[j];
      const float4 b = reinterpret_cast<const float4*>(g)[j];
      const float4 c = reinterpret_cast<const float4*>(v)[j];
      float4 pn, vn;
      step(a.x, b.x, c.x, tl, wdl, mom, nesterov, pn.x, vn.x);
      step(a.y, b.y, c.y, tl, wdl, mom, nesterov, pn.y, vn.y);
      step(a.z, b.z, c.z, tl, wdl, mom, nesterov, pn.z, vn.z);
      step(a.w, b.w, c.w, tl, wdl, mom, nesterov, pn.w, vn.w);
      reinterpret_cast<float4*>(po)[j] = pn;
      reinterpret_cast<float4*>(vo)[j] = vn;
    }
    done = len / 4 * 4;
  }
  for (int j = done + threadIdx.x; j < len; j += kThreads)
    step(p[j], g[j], v[j], tl, wdl, mom, nesterov, po[j], vo[j]);
}

bool table_ok(const LarsTable& t, int blocks) {
  if (!(t.n_leaves > 0 && t.n_leaves <= kMaxLeaves && t.chunk > 0 &&
        t.chunk % 4 == 0 && blocks == t.chunk0[t.n_leaves] && t.base >= 0))
    return false;
  for (int i = 0; i < t.n_leaves; ++i)   // the leaf's blocks lie in its group's
    if (t.grp[i] < 0 || t.gb0[i] > t.base + t.chunk0[i] ||
        t.gb1[i] < t.base + t.chunk0[i + 1])
      return false;
  return true;
}

}  // namespace

// 0 when the caller's table has this file's layout (its size in bytes).
extern "C" int lars_table_check(long long bytes) {
  return bytes == (long long)sizeof(LarsTable) ? 0 : (int)cudaErrorInvalidValue;
}

// table: a host LarsTable, copied into the launch's parameters; partial:
// 2 fp32 of scratch a block over all tables; count: an int a group, zero
// before the first table's launch; sums: 2 fp32 a group, the group's sums
// of p^2 and g^2 once its last block is in.
extern "C" int lars_norms_f32(const void* table, float* partial, int* count,
                              float* sums, int blocks, void* stream) {
  LarsTable t;
  memcpy(&t, table, sizeof t);
  if (!table_ok(t, blocks)) return (int)cudaErrorInvalidValue;
  lars_norms_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(t, partial, count,
                                                                    sums);
  return (int)cudaGetLastError();
}

// sums: as lars_norms_f32 left them, every norms launch done; p_out, v_out:
// the flat outputs, each leaf at its table offset.
extern "C" int lars_apply_f32(const void* table, const float* sums,
                              float* p_out, float* v_out, int blocks, float lr,
                              float mom, float eta, float wd, float eps,
                              int nesterov, void* stream) {
  LarsTable t;
  memcpy(&t, table, sizeof t);
  if (!table_ok(t, blocks)) return (int)cudaErrorInvalidValue;
  lars_apply_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, sums, p_out, v_out, lr, mom, eta, wd, eps, nesterov);
  return (int)cudaGetLastError();
}
