// One-pass Adam update of one parameter leaf, in place, for Hopper (sm_90a),
// fp32.
//
// Replaces the TPU kernel scripts/opt_layout_r4.py::fused_adam_pallas (body
// `kernel`, the pallas_call in `apply_leaf`). That kernel reads p, g, m, v
// and two bias corrections and writes p, m, v in one pass, on views merged
// until the minor axis fills the TPU's 128 lanes. A contiguous leaf needs no
// such view here: the kernel indexes it linearly.
//
//   m <- b1 m + (1 - b1) g
//   v <- b2 v + (1 - b2) g^2
//   p <- p - lr (m c1) / (sqrt(v c2) + eps),  c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t)
//
// eps stands outside the root, as in optax.adam and torch.optim.Adam. Every
// scalar goes by value at the launch; 1 - b1 and 1 - b2 are rounded from the
// host's doubles (1 - 0.999f in fp32 is off by 1.3e-5 of itself).
//
// Bound: bytes. Seven streams of 4 B an element (four read, three written)
// against about ten flops: 28 B n / 3.35 TB/s (H100 SXM data sheet), 0.138 ms
// for the 16,469,791 parameters of the SFNO McWilliams recipe. The design is a
// grid-stride loop of float4 loads and stores where all four pointers are
// 16-byte aligned, and a scalar loop over the last n % 4 elements (or over all
// of them when a pointer is unaligned). A leaf of a few floats is bound by the
// launch, not by bytes: one launch a leaf.
//
// Plain C interface: pointers and the stream are void*, and the entry point
// returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // a few waves of the card's 132 SMs

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, c1, c2;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  p = p - h.lr * (m * h.c1) / (sqrtf(v * h.c2) + h.eps);
}

// Elements [0, 4 * n4) as float4s, then [4 * n4, n) one at a time.
__global__ void __launch_bounds__(THREADS) adam_kernel(
    float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, long long n, long long n4, Hyper h) {
  const long long stride = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = tid; i < n4; i += stride) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    update(pp.x, gg.x, mm.x, vv.x, h);
    update(pp.y, gg.y, mm.y, vv.y, h);
    update(pp.z, gg.z, mm.z, vv.z, h);
    update(pp.w, gg.w, mm.w, vv.w, h);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    update(pp, g[i], mm, vv, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

extern "C" {

// p, g, m, v: n contiguous floats each; p, m and v are updated in place.
// omb1 = 1 - b1 and omb2 = 1 - b2 as the host rounds them from doubles.
int adam_step(void* p, const void* g, void* m, void* v, long long n, float lr,
              float b1, float b2, float omb1, float omb2, float eps, float c1,
              float c2, void* stream) {
  if (n <= 0) return 0;
  const uintptr_t bits = (uintptr_t)p | (uintptr_t)g | (uintptr_t)m | (uintptr_t)v;
  const long long n4 = (bits & 15) == 0 ? n / 4 : 0;
  const long long work = n4 > 0 ? n4 : n;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const Hyper h{lr, b1, b2, omb1, omb2, eps, c1, c2};
  adam_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)p, (const float*)g, (float*)m, (float*)v, n, n4, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
