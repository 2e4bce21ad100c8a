// One-pass Adam update of a list of parameter leaves in one launch, in place,
// for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel scripts/opt_layout_r4.py::fused_adam_pallas (body
// `kernel`, the pallas_call in `apply_leaf`). That kernel reads p, g, m, v
// and two bias corrections and writes p, m, v in one pass, one pallas_call a
// leaf, on views merged until the minor axis fills the TPU's 128 lanes. A
// contiguous leaf needs no such view here: the kernel indexes it linearly.
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
// for the 16,469,791 parameters of the SFNO McWilliams recipe. A first
// design launched once a leaf; the SFNO has 52 leaves, 36 of them of 10 to
// 400 floats, so a step cost 52 launches of host time (about 1 ms) against
// 0.2 ms of device time. This design is PyTorch's multi_tensor_apply
// pattern: one launch updates up to MAX_LEAVES leaves from a table passed by
// value as a kernel parameter (under the classic 4 KB limit). Each leaf is
// cut into chunks of CHUNK floats and each block takes one chunk, finding its
// leaf by a binary search over the table's chunk prefix, so a small leaf
// costs one block, not one launch. A chunk runs float4 loads and stores where
// all four of its leaf's pointers are 16-byte aligned (the chunk starts at a
// multiple of CHUNK, so alignment carries over), and one float at a time over
// the last n % 4 elements or over an unaligned leaf.
//
// Plain C interface: the table comes as an int64 array of six columns a
// leaf (p, g, m, v, n, first chunk), planned on the host
// (tpu_cfd_torch/ops/cuda/adam.py::plan_launches); the entry point returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 64;
constexpr long long CHUNK = 16384;  // floats a block; a multiple of 4

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, c1, c2;
};

struct Table {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  long long n[MAX_LEAVES];
  int first[MAX_LEAVES + 1];  // chunk prefix: leaf i owns [first[i], first[i+1])
  unsigned long long aligned;  // bit i: all four pointers of leaf i 16-byte aligned
  int leaves;
};
static_assert(sizeof(Table) + sizeof(Hyper) <= 4096, "kernel parameters over 4 KB");

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h) {
  m = h.b1 * m + h.omb1 * g;
  v = h.b2 * v + h.omb2 * g * g;
  p = p - h.lr * (m * h.c1) / (sqrtf(v * h.c2) + h.eps);
}

__global__ void __launch_bounds__(THREADS) adam_multi_kernel(const Table t,
                                                             const Hyper h) {
  const int chunk = blockIdx.x;
  int lo = 0, hi = t.leaves - 1;  // the last leaf whose first chunk <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.first[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const int leaf = lo;
  const long long start = (long long)(chunk - t.first[leaf]) * CHUNK;
  const long long rest = t.n[leaf] - start;
  const long long len = rest < CHUNK ? rest : CHUNK;
  float* p = t.p[leaf] + start;
  const float* g = t.g[leaf] + start;
  float* m = t.m[leaf] + start;
  float* v = t.v[leaf] + start;
  long long done = 0;
  if ((t.aligned >> leaf) & 1ull) {
    const long long n4 = len / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
#pragma unroll 4
    for (long long i = threadIdx.x; i < n4; i += THREADS) {
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
    done = 4 * n4;
  }
  for (long long i = done + threadIdx.x; i < len; i += THREADS) {
    float pp = p[i], mm = m[i], vv = v[i];
    update(pp, g[i], mm, vv, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

extern "C" {

// rows: `leaves` rows of six int64 (p, g, m, v, n, first chunk), n > 0, first
// chunks increasing from 0; `chunks` is the group's total. p, m and v are
// updated in place. omb1 = 1 - b1 and omb2 = 1 - b2 as the host rounds them
// from doubles.
int adam_step_leaves(const long long* rows, int leaves, int chunks, float lr,
                     float b1, float b2, float omb1, float omb2, float eps,
                     float c1, float c2, void* stream) {
  if (leaves < 1 || leaves > MAX_LEAVES || chunks < 1)
    return (int)cudaErrorInvalidValue;
  Table t;
  t.leaves = leaves;
  t.aligned = 0;
  for (int i = 0; i < leaves; ++i) {
    const long long* r = rows + 6 * i;
    t.p[i] = (float*)(uintptr_t)r[0];
    t.g[i] = (const float*)(uintptr_t)r[1];
    t.m[i] = (float*)(uintptr_t)r[2];
    t.v[i] = (float*)(uintptr_t)r[3];
    t.n[i] = r[4];
    t.first[i] = (int)r[5];
    if (((r[0] | r[1] | r[2] | r[3]) & 15) == 0) t.aligned |= 1ull << i;
  }
  t.first[leaves] = chunks;
  const Hyper h{lr, b1, b2, omb1, omb2, eps, c1, c2};
  adam_multi_kernel<<<(unsigned)chunks, THREADS, 0, (cudaStream_t)stream>>>(t, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
