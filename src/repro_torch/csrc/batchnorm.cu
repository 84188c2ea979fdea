// Batch norm with the ReLU and the residual add that follow it, forward and
// backward, for Hopper (sm_90a): four kernels, templated on the activations'
// type (bf16 or fp32), every sum in fp32.
//
// Replaces no TPU kernel: the JAX package leaves BN to XLA
// (src/repro/nn/layers.py::batchnorm), which fuses it with what follows. The
// port ran it as a chain of ~15 fp32 PyTorch passes a call forward and ~25
// backward (kernels/ref.py::batchnorm_chain_ref, now the tests' reference).
//
// x is (N, C, H, W) with channels-last strides, as every conv output of the
// model: M = N*H*W rows of C contiguous channels, C a multiple of 8. Per
// channel, with a = rsqrt(var + eps), s the scale and b the bias (fp32
// masters, rounded to x's type T as they are loaded, as the model's cast
// rounded them), M' = M x ranks:
//   bn_fwd_stats_kernel  Σx, Σx² over the rows; mean = Σx·(1/M),
//                        var = Σx²·(1/M) - mean² (the E[x²] - mean² form)
//   bn_fwd_apply_kernel  v = T((x - mean)·(a·s) + b), in that order and
//                        uncontracted, as the plain path rounds; with a
//                        residual r, v = T(v + r); the ReLU last
//   bn_bwd_sums_kernel   Σg and Σg·x̂, x̂ = (x - mean)·a, g = dy where the
//                        ReLU passed it and 0 elsewhere; the bias's and the
//                        scale's gradients, those rounded to T, in fp32 (what
//                        the cast's backward gave the masters)
//   bn_bwd_dx_kernel     dx = s·a·(g - Σg/M' - x̂·Σg·x̂/M') (with given
//                        statistics: s·a·g), and g, the residual's gradient
// The ReLU's mask: without a residual it is recomputed from x (v rounded to
// T, then v > 0), which equals F.relu's on the stored output bit for bit, so
// the output is not read; with a residual the mask depends on r too, and the
// stored output is read. Across ranks the wrapper (kernels/batchnorm.py)
// all-reduces the stats' sums between the two forward kernels and the
// backward's sums between the two backward kernels.
//
// Bound: device-memory bytes, at a few flops a byte. A pass over the
// statistics has to end before any output is written, and a tensor of up
// to 411 MB (the stem's, 256 images) does not stay on chip, so x is read
// twice forward (stats, apply) and x and dy twice backward (sums, dx).
// ResNet-50 at 256 images moves ~19.9 GB forward and ~37.0 GB backward
// this way: ~17 ms at 3.35 TB/s (PERF.md §6).
//
// Design:
// - A thread owns 8 channels (16 bytes of bf16; two 16-byte loads of fp32)
//   for the whole launch, so its channels' statistics, scale and bias are
//   loaded once. A CTA of 256 threads covers a tile of up to 64 channels (8
//   threads across) by 32 rows of threads (256 / (C/8) rows when C < 64):
//   a warp reads four whole 128-byte runs. The grid is (channel tiles) x
//   (row chunks), sized by the wrapper (kernels/batchnorm.py:plan) from
//   (M, C), about 8 CTAs an SM over all 53 shapes of ResNet-50, from the
//   stem's C 64 x M 3.2M to stage 4's C 2048 x M 12,544.
// - Each thread issues 4 rows' loads (2 backward, which reads two or three
//   tensors) before any arithmetic on them.
// - The reductions: a thread sums its rows in order; the CTA sums its rows
//   of threads in order through shared memory and writes one partial a
//   channel for its chunk; then it takes a ticket on its channel tile, an
//   integer atomicInc that wraps to 0 at the tile's last CTA, so the
//   counters are left at zero for the next launch; that last CTA sums the
//   tile's partials in chunk order and writes the results. No float atomic
//   is used and every sum runs in an order that the shape fixes, so two
//   calls give the same bytes.
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;   // channels a thread

struct Shape {
  long long rows;        // M
  int C;                 // channels, a multiple of kVec
  int lanes;             // threads across a channel tile
  int rpp;               // rows of threads, lanes * rpp <= kThreads
  int chunks;            // row chunks (gridDim.y); gridDim.x is the tiles
  long long chunk_rows;  // rows a chunk
};

struct Slot {            // a thread's place in the grid
  int c0;                // its first channel
  int ty;                // its row of threads
  bool on;               // it has rows and channels
  long long r0, r1;      // its first row; the end of its chunk
};

__device__ __forceinline__ Slot slot(const Shape& s) {
  Slot q;
  const int tx = threadIdx.x % s.lanes;
  q.ty = threadIdx.x / s.lanes;
  q.c0 = (blockIdx.x * s.lanes + tx) * kVec;
  q.on = q.ty < s.rpp && q.c0 < s.C;
  q.r0 = (long long)blockIdx.y * s.chunk_rows + q.ty;
  q.r1 = min((long long)(blockIdx.y + 1) * s.chunk_rows, s.rows);
  return q;
}

// -- 8 channels in, 8 out ------------------------------------------------------

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float (&v)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // the lower half holds the first of a pair
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// partials that other CTAs of this launch wrote: from L2, not the read-only path
__device__ __forceinline__ void load8_l2(const float* p, float (&v)[kVec]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// -- per channel -----------------------------------------------------------------

struct Channels {        // a thread's 8 channels
  float mean[kVec];
  float rs[kVec];        // a = rsqrt(var + eps)
  float inv[kVec];       // a * s
  float b[kVec];
};

// 8 fp32 parameters, rounded to T
template <typename T>
__device__ __forceinline__ void load8_as(const float* __restrict__ p, float (&v)[kVec]) {
  load8(p, v);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = rnd<T>(v[j]);
}

// mv: (mean, var), 2 x C fp32; scale, bias: C fp32
template <typename T>
__device__ __forceinline__ void channels(const float* __restrict__ mv,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, int C, int c0,
                                         float eps, Channels& ch) {
  float var[kVec], s[kVec];
  load8(mv + c0, ch.mean);
  load8(mv + C + c0, var);
  load8_as<T>(scale + c0, s);
  load8_as<T>(bias + c0, ch.b);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    ch.rs[j] = rsqrtf(__fadd_rn(var[j], eps));
    ch.inv[j] = __fmul_rn(ch.rs[j], s[j]);
  }
}

// the BN's value, rounded to T: T((x - mean)·inv + b)
template <typename T>
__device__ __forceinline__ float bn_value(float x, const Channels& ch, int j) {
  return rnd<T>(__fadd_rn(__fmul_rn(__fsub_rn(x, ch.mean[j]), ch.inv[j]), ch.b[j]));
}

// dy where the ReLU passed it: mask 0 no ReLU, 1 its mask recomputed from x,
// 2 read from the stored output y (threshold_backward's: y <= 0 gives 0)
template <typename T>
__device__ __forceinline__ float grad_in(float dy, float x, float y, int mask,
                                         const Channels& ch, int j) {
  if (mask == 0) return dy;
  const float v = mask == 1 ? bn_value<T>(x, ch, j) : y;
  return v <= 0.f ? 0.f : dy;
}

// -- the reductions ------------------------------------------------------------------

// red: 2 * kThreads * kVec floats of shared memory. The CTA's sums of a and b
// over its rows of threads, in row order, for channel threadIdx.x of its tile
// (threads below lanes * kVec; 0 in the others).
__device__ __forceinline__ void cta_sums(const float (&a)[kVec], const float (&b)[kVec],
                                         const Shape& s, const Slot& q, float* red,
                                         float& sa, float& sb) {
  const int w = s.lanes * kVec;
  if (q.ty < s.rpp) {
    float4* ra = reinterpret_cast<float4*>(red + q.ty * w + (threadIdx.x % s.lanes) * kVec);
    float4* rb = reinterpret_cast<float4*>(reinterpret_cast<float*>(ra) + kThreads * kVec);
    ra[0] = make_float4(a[0], a[1], a[2], a[3]);
    ra[1] = make_float4(a[4], a[5], a[6], a[7]);
    rb[0] = make_float4(b[0], b[1], b[2], b[3]);
    rb[1] = make_float4(b[4], b[5], b[6], b[7]);
  }
  __syncthreads();
  sa = 0.f;
  sb = 0.f;
  if ((int)threadIdx.x < w)
    for (int r = 0; r < s.rpp; ++r) {
      sa += red[r * w + threadIdx.x];
      sb += red[kThreads * kVec + r * w + threadIdx.x];
    }
  __syncthreads();   // red is free again
}

// Writes the CTA's partials of a and b (2 x C floats a chunk), takes a ticket
// on its channel tile, and returns false, or true in the tile's last CTA with
// every chunk's partials summed in chunk order in sa, sb (for channel
// threadIdx.x of the tile, as cta_sums).
__device__ __forceinline__ bool tile_sums(const float (&a)[kVec], const float (&b)[kVec],
                                          const Shape& s, const Slot& q, float* red,
                                          float* partial, unsigned* tickets,
                                          float& sa, float& sb) {
  __shared__ bool last;
  cta_sums(a, b, s, q, red, sa, sb);
  const int w = s.lanes * kVec;
  const int c = blockIdx.x * w + threadIdx.x;
  if ((int)threadIdx.x < w && c < s.C) {
    partial[2LL * blockIdx.y * s.C + c] = sa;
    partial[(2LL * blockIdx.y + 1) * s.C + c] = sb;
  }
  __threadfence();   // the partials are seen before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&tickets[blockIdx.x], s.chunks - 1) == (unsigned)(s.chunks - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  float pa[kVec] = {}, pb[kVec] = {};
  if (q.on)
    for (int k = q.ty; k < s.chunks; k += s.rpp) {
      float u[kVec], v[kVec];
      load8_l2(partial + 2LL * k * s.C + q.c0, u);
      load8_l2(partial + (2LL * k + 1) * s.C + q.c0, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        pa[j] += u[j];
        pb[j] += v[j];
      }
    }
  cta_sums(pa, pb, s, q, red, sa, sb);
  return true;
}

// -- the kernels -------------------------------------------------------------------------

// partial: 2 x C x chunks fp32; tickets: a zeroed unsigned a tile; sums:
// (Σx, Σx²) and mv: (mean, var) over the rows, each 2 x C fp32; inv_count:
// the fp32 reciprocal of the rows, 1/M (the wrapper's, so that the plain
// version multiplies by the same number)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    bn_fwd_stats_kernel(const T* __restrict__ x, const Shape s, float* partial,
                        unsigned* tickets, float* __restrict__ sums, float* __restrict__ mv,
                        float inv_count) {
  __shared__ __align__(16) float red[2 * kThreads * kVec];
  const Slot q = slot(s);
  float a[kVec] = {}, b[kVec] = {};
  if (q.on) {
    const T* p = x + q.c0;
    const long long step = s.rpp;
    long long r = q.r0;
    for (; r + 3 * step < q.r1; r += 4 * step) {
      float v[4][kVec];
#pragma unroll
      for (int u = 0; u < 4; ++u) load8(p + (r + u * step) * s.C, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          a[j] += v[u][j];
          b[j] = fmaf(v[u][j], v[u][j], b[j]);
        }
    }
    for (; r < q.r1; r += step) {
      float v[kVec];
      load8(p + r * s.C, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        a[j] += v[j];
        b[j] = fmaf(v[j], v[j], b[j]);
      }
    }
  }
  float sa, sb;
  if (!tile_sums(a, b, s, q, red, partial, tickets, sa, sb)) return;
  const int w = s.lanes * kVec, c = blockIdx.x * w + threadIdx.x;
  if ((int)threadIdx.x < w && c < s.C) {
    sums[c] = sa;
    sums[s.C + c] = sb;
    const float mean = __fmul_rn(sa, inv_count);
    mv[c] = mean;
    mv[s.C + c] = __fsub_rn(__fmul_rn(sb, inv_count), __fmul_rn(mean, mean));
  }
}

// res: the residual or null; relu: 0 or 1
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    bn_fwd_apply_kernel(const T* __restrict__ x, const Shape s, const float* __restrict__ mv,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        const T* __restrict__ res, T* __restrict__ y, float eps, int relu) {
  const Slot q = slot(s);
  if (!q.on) return;
  Channels ch;
  channels<T>(mv, scale, bias, s.C, q.c0, eps, ch);
  const long long step = s.rpp;
  long long r = q.r0;
  auto out = [&](const float (&v)[kVec], const float (&rv)[kVec], long long row) {
    float o[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float t = bn_value<T>(v[j], ch, j);
      if (res) t = rnd<T>(__fadd_rn(t, rv[j]));
      o[j] = relu && t <= 0.f ? 0.f : t;
    }
    store8(y + row * s.C + q.c0, o);
  };
  for (; r + 3 * step < q.r1; r += 4 * step) {
    float v[4][kVec], rv[4][kVec] = {};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      load8(x + (r + u * step) * s.C + q.c0, v[u]);
      if (res) load8(res + (r + u * step) * s.C + q.c0, rv[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) out(v[u], rv[u], r + u * step);
  }
  for (; r < q.r1; r += step) {
    float v[kVec], rv[kVec] = {};
    load8(x + r * s.C + q.c0, v);
    if (res) load8(res + r * s.C + q.c0, rv);
    out(v, rv, r);
  }
}

// y: the stored output, read where mask is 2 (null otherwise); sums: (Σg,
// Σg·x̂) and dparams: (bias's, scale's gradient), those rounded to T, each
// 2 x C fp32
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    bn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const T* __restrict__ y, const Shape s, const float* __restrict__ mv,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       float eps, int mask, float* partial, unsigned* tickets,
                       float* __restrict__ sums, float* __restrict__ dparams) {
  __shared__ __align__(16) float red[2 * kThreads * kVec];
  const Slot q = slot(s);
  float a[kVec] = {}, b[kVec] = {};
  if (q.on) {
    Channels ch;
    channels<T>(mv, scale, bias, s.C, q.c0, eps, ch);
    const long long step = s.rpp;
    auto add = [&](const float (&xv)[kVec], const float (&gv)[kVec], const float (&yv)[kVec]) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float g = grad_in<T>(gv[j], xv[j], yv[j], mask, ch, j);
        a[j] += g;
        b[j] = fmaf(g, __fmul_rn(__fsub_rn(xv[j], ch.mean[j]), ch.rs[j]), b[j]);
      }
    };
    long long r = q.r0;
    for (; r + step < q.r1; r += 2 * step) {
      float xv[2][kVec], gv[2][kVec], yv[2][kVec] = {};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long long off = (r + u * step) * s.C + q.c0;
        load8(x + off, xv[u]);
        load8(dy + off, gv[u]);
        if (mask == 2) load8(y + off, yv[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) add(xv[u], gv[u], yv[u]);
    }
    for (; r < q.r1; r += step) {
      float xv[kVec], gv[kVec], yv[kVec] = {};
      const long long off = r * s.C + q.c0;
      load8(x + off, xv);
      load8(dy + off, gv);
      if (mask == 2) load8(y + off, yv);
      add(xv, gv, yv);
    }
  }
  float sa, sb;
  if (!tile_sums(a, b, s, q, red, partial, tickets, sa, sb)) return;
  const int w = s.lanes * kVec, c = blockIdx.x * w + threadIdx.x;
  if ((int)threadIdx.x < w && c < s.C) {
    sums[c] = sa;
    sums[s.C + c] = sb;
    dparams[c] = rnd<T>(sa);
    dparams[s.C + c] = rnd<T>(sb);
  }
}

// sums: (Σg, Σg·x̂) over every rank's rows, inv_count = 1/M' of them; null
// with given statistics (the direct term alone); dres: where g goes, or null
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ y,
                     const Shape s, const float* __restrict__ mv,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ sums, float eps,
                     float inv_count, int mask, T* __restrict__ dx, T* __restrict__ dres) {
  const Slot q = slot(s);
  if (!q.on) return;
  Channels ch;
  channels<T>(mv, scale, bias, s.C, q.c0, eps, ch);
  float sc[kVec], k1[kVec], k2[kVec];
  load8_as<T>(scale + q.c0, sc);
  if (sums) {
    load8(sums + q.c0, k1);
    load8(sums + s.C + q.c0, k2);
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sc[j] = __fmul_rn(sc[j], ch.rs[j]);   // s·a
    k1[j] = sums ? __fmul_rn(k1[j], inv_count) : 0.f;
    k2[j] = sums ? __fmul_rn(k2[j], inv_count) : 0.f;
  }
  const long long step = s.rpp;
  auto out = [&](const float (&xv)[kVec], const float (&gv)[kVec], const float (&yv)[kVec],
                 long long off) {
    float d[kVec], g[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      g[j] = grad_in<T>(gv[j], xv[j], yv[j], mask, ch, j);
      const float xh = __fmul_rn(__fsub_rn(xv[j], ch.mean[j]), ch.rs[j]);
      d[j] = sums ? __fmul_rn(sc[j], __fsub_rn(__fsub_rn(g[j], k1[j]), __fmul_rn(xh, k2[j])))
                  : __fmul_rn(sc[j], g[j]);
    }
    store8(dx + off, d);
    if (dres) store8(dres + off, g);
  };
  long long r = q.r0;
  for (; r + step < q.r1; r += 2 * step) {
    float xv[2][kVec], gv[2][kVec], yv[2][kVec] = {};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long off = (r + u * step) * s.C + q.c0;
      load8(x + off, xv[u]);
      load8(dy + off, gv[u]);
      if (mask == 2) load8(y + off, yv[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) out(xv[u], gv[u], yv[u], (r + u * step) * s.C + q.c0);
  }
  for (; r < q.r1; r += step) {
    float xv[kVec], gv[kVec], yv[kVec] = {};
    const long long off = r * s.C + q.c0;
    load8(x + off, xv);
    load8(dy + off, gv);
    if (mask == 2) load8(y + off, yv);
    out(xv, gv, yv, off);
  }
}

// shape: rows, C, lanes, rpp, tiles, chunks, chunk_rows (kernels/batchnorm.py:Plan)
bool read_shape(const long long* in, Shape& s, dim3& grid) {
  s.rows = in[0];
  s.C = (int)in[1];
  s.lanes = (int)in[2];
  s.rpp = (int)in[3];
  const long long tiles = in[4];
  s.chunks = (int)in[5];
  s.chunk_rows = in[6];
  grid = dim3((unsigned)tiles, (unsigned)s.chunks);
  return s.rows > 0 && in[1] > 0 && s.C % kVec == 0 && s.lanes > 0 && s.rpp > 0 &&
         s.lanes * s.rpp <= kThreads && tiles > 0 && tiles < (1LL << 31) &&
         tiles * s.lanes * kVec >= s.C && in[5] > 0 && in[5] <= 65535 && s.chunk_rows > 0 &&
         (long long)s.chunks * s.chunk_rows >= s.rows;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool all_aligned(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (p && !aligned16(p)) return false;
  return true;
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (kernels/batchnorm.py:_DTYPES). Each entry returns a
// cudaError_t: cudaErrorInvalidValue for a shape or type it does not take,
// cudaErrorMisalignedAddress for a pointer off a 16-byte boundary.
#define BN_CHECK(...)                                                         \
  Shape s;                                                                    \
  dim3 grid;                                                                  \
  if (!read_shape(shape, s, grid) || (dtype != 0 && dtype != 1))              \
    return (int)cudaErrorInvalidValue;                                        \
  if (!all_aligned({__VA_ARGS__})) return (int)cudaErrorMisalignedAddress;

// tickets: one unsigned a channel tile, zero before the first launch and left
// at zero by every launch
extern "C" int bn_fwd_stats(const void* x, int dtype, const long long* shape, float* partial,
                            unsigned* tickets, float* sums, float* mv, float inv_count,
                            void* stream) {
  BN_CHECK(x, partial, sums, mv);
  if (dtype == 1)
    bn_fwd_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, s, partial, tickets, sums, mv, inv_count);
  else
    bn_fwd_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, s, partial, tickets, sums, mv, inv_count);
  return (int)cudaGetLastError();
}

extern "C" int bn_fwd_apply(const void* x, int dtype, const long long* shape, const float* mv,
                            const float* scale, const float* bias, const void* res, void* y,
                            float eps, int relu, void* stream) {
  BN_CHECK(x, mv, scale, bias, res, y);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    bn_fwd_apply_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, s, mv, scale, bias, (const T*)res, (T*)y, eps, relu);
  } else {
    using T = float;
    bn_fwd_apply_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, s, mv, scale, bias, (const T*)res, (T*)y, eps, relu);
  }
  return (int)cudaGetLastError();
}

// mask: 0 no ReLU, 1 its mask from x, 2 from y (then y is read)
extern "C" int bn_bwd_sums(const void* x, int dtype, const long long* shape, const void* dy,
                           const void* y, const float* mv, const float* scale,
                           const float* bias, float eps, int mask, float* partial,
                           unsigned* tickets, float* sums, float* dparams, void* stream) {
  BN_CHECK(x, dy, y, mv, scale, bias, partial, sums, dparams);
  if (mask < 0 || mask > 2 || (mask == 2 && !y)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    bn_bwd_sums_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)dy, (const T*)y, s, mv, scale, bias, eps, mask, partial,
        tickets, sums, dparams);
  } else {
    using T = float;
    bn_bwd_sums_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)dy, (const T*)y, s, mv, scale, bias, eps, mask, partial,
        tickets, sums, dparams);
  }
  return (int)cudaGetLastError();
}

extern "C" int bn_bwd_dx(const void* x, int dtype, const long long* shape, const void* dy,
                         const void* y, const float* mv, const float* scale, const float* bias,
                         const float* sums, float eps, float inv_count, int mask, void* dx,
                         void* dres, void* stream) {
  BN_CHECK(x, dy, y, mv, scale, bias, sums, dx, dres);
  if (mask < 0 || mask > 2 || (mask == 2 && !y)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    bn_bwd_dx_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)dy, (const T*)y, s, mv, scale, bias, sums, eps, inv_count,
        mask, (T*)dx, (T*)dres);
  } else {
    using T = float;
    bn_bwd_dx_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)dy, (const T*)y, s, mv, scale, bias, sums, eps, inv_count,
        mask, (T*)dx, (T*)dres);
  }
  return (int)cudaGetLastError();
}
