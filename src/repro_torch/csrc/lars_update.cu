// Fused LARS elementwise update for one fp32 parameter tensor.
//
// Replaces: src/repro/kernels/lars_update.py::_lars_kernel (the Pallas TPU
// kernel behind lars_update_pallas), and adds the nesterov branch that the
// JAX kernel path skips, so the port has one path that computes what
// core/lars.py::update(use_kernel=False) computes.
//
//   v' = mom * v + trust_lr * (g + wd * p)
//   s  = nesterov ? mom * v' + (v' - mom * v) : v'
//   p' = p - s
//
// Bound: device-memory bytes. Each element reads p, g, v and writes p', v'
// (20 bytes, 5-8 flops), far below the H100's ~295 flops per byte, so the
// least time is 20 * n / 3.35 TB/s.
//
// Design: a grid-stride loop, one element per thread per iteration, with
// neighbouring threads on neighbouring addresses so every warp load and
// store is coalesced. The trust ratio is read from a device pointer (the
// TPU kernel read it from its (4,) scalar operand): it is computed on the
// device from the two norms and never goes through the host, so a step
// over 54 leaves costs no host synchronisation. lr, mom and wd are host
// values and come by value. The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_runtime.h>

namespace {

__global__ void lars_update_kernel(const float* __restrict__ p,
                                   const float* __restrict__ g,
                                   const float* __restrict__ v,
                                   float* __restrict__ p_out,
                                   float* __restrict__ v_out,
                                   const float* __restrict__ trust,
                                   float lr, float mom, float wd,
                                   long long n, int nesterov) {
  const float tl = trust[0] * lr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pi = p[i];
    const float vi = v[i];
    const float v_new = mom * vi + tl * (g[i] + wd * pi);
    const float step = nesterov ? mom * v_new + (v_new - mom * vi) : v_new;
    p_out[i] = pi - step;
    v_out[i] = v_new;
  }
}

}  // namespace

extern "C" int lars_update_f32(const float* p, const float* g, const float* v,
                               float* p_out, float* v_out, const float* trust,
                               float lr, float mom, float wd, long long n,
                               int nesterov, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then stride
  lars_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, g, v, p_out, v_out, trust, lr, mom, wd, n, nesterov);
  return (int)cudaGetLastError();
}
