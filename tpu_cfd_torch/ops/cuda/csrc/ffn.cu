// Fused pointwise FFN, out = act(x @ w1^T + b1) @ w2^T + b2, for Hopper
// (sm_90a): fp32 weights and accumulation, fp32 or bf16 input and output.
//
// Replaces the TPU kernel tpu_cfd/ops/pallas/ffn.py::_ffn_kernel (the
// pallas_call in _ffn_forward). That kernel tiles the rows and keeps both
// weight matrices and the expanded intermediate in VMEM; here the hidden
// activations never leave registers either.
//
// Bound: 2 M H (K + KO) flops against M (K + KO) row bytes. At the SFNO
// McWilliams recipe (M = 64*64^2*10 = 2,621,440 rows, K = KO = 10, H = 40)
// that is 4.19 GFLOP and 210 MB: 0.063 ms by bytes at 3.35 TB/s, 0.063 ms
// by FFMA at 67 TFLOP/s and 0.025 ms as 3xTF32 on the tensor cores (495
// TFLOP/s dense TF32 / 3; H100 SXM data sheet). With bf16 rows the bytes
// halve (0.031 ms). One row a thread on FFMA is bound by instruction rate,
// not by either: one shared-memory weight load for every four FMAs, a
// serial chain of K FMAs for each hidden unit and a full tanhf for each
// (0.32 ms at the recipe on an H100, with fp32 or bf16 rows alike).
//
// Design: the two products go to the tensor cores, which leaves the FMA
// and shared-memory pipes little to do.
//   - Each warp takes 16-row tiles of x on its own, one after the other
//     (blocks are persistent: as many as fit on the SMs), and computes the
//     tile's output with mma.sync.m16n8k8 TF32 in the 3xTF32 split, which
//     keeps fp32 accuracy (tf32_mma.cuh). bf16 rows are exact in TF32, so
//     their lo part is zero and the first product takes two passes.
//   - The hidden units go 8 at a time: pre (16 x 8) = x W1^T + b1 over the
//     K/8 depth steps; act() on the accumulators in registers; then those
//     registers ARE the A fragment of the second product's 8-deep step, with
//     no shuffle or shared-memory round trip: lane (g, t) holds hidden units
//     2t and 2t+1 of rows g and g+8, which the A fragment takes as k = t and
//     t + 4. So the second product's logical k order within each block of 8
//     hidden units is [0, 2, 4, 6, 1, 3, 5, 7], and W2 is staged in that
//     order: lane (g, t)'s B fragment of output block ns is w2[8ns+g][8j+2t]
//     and w2[8ns+g][8j+2t+1]. K, KO and H are padded to multiples of 8 with
//     zero weights; a padded hidden unit meets a zero row of W2, so act(0)
//     adds nothing.
//   - Each block splits W1 and W2 into TF32 hi and lo parts once, straight
//     into the per-lane fragment order: one conflict-free float4 load
//     (b0 hi, b1 hi, b0 lo, b1 lo) a lane a product step. The biases start
//     the accumulators.
//   - The splits of x and of the activations use integer ops (split_int), not
//     cvt.rna.tf32.f32: conversions run on the same narrow pipe as the
//     activation's exp and reciprocal.
//   - Two blocks of hidden units are in flight, into two sets of output
//     accumulators, so that one's products overlap the other's activation;
//     GELU and ReLU are compiled into their own instances (ACT), with no
//     branch between the products.
//   - A tile of 16 rows is 16 K contiguous elements, 16-byte aligned for any
//     K; it comes in by cp.async, double-buffered, one tile ahead. The
//     output tile goes through shared memory, so that rows leave as
//     coalesced 16-byte stores. The ragged last tile is masked.
//   - GELU (the tanh form, as flax's nn.gelu) is 0.5 x (1 + tanh u) =
//     x sigma(2u) = x / (1 + exp(-2u)), u = sqrt(2/pi) (x + 0.044715 x^3),
//     with ex2.approx and rcp.approx: for x -> -inf, exp -> inf and the
//     result -> 0; for x -> +inf, exp -> 0 and the result -> x.
//
// On an NVIDIA H100 80GB HBM3 (700 W) this takes 0.227 ms at the recipe, 28 %
// of the bytes bound: mma.sync runs TF32 far below the dense peak that only
// wgmma reaches, and K = KO = 10 padded to 16 wastes 37.5 % of both products.
//
// The shared-memory layout (tpu_cfd_torch/ops/cuda/ffn.py::ffn_layout, in
// the order of FfnLayout) comes from the host.
//
// Plain C interface: pointers and the stream are void*, and the entry
// point returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// Offsets in bytes from the start of dynamic shared memory.
struct FfnLayout {
  int K, H, KO;
  int ks, ns, hs;     // K, KO and H padded to 8, over 8
  int warps;          // warps a block
  int w1f, w2f;       // [hs][ks][32] and [hs][ns][32] float4 fragments
  int b1, b2;         // [8 hs] and [8 ns] floats, zero-padded
  int xs;             // per warp: two x tiles, then the output tile
  int xbuf, obuf;     // bytes of one x tile (16 K) and one output tile (16 KO)
  int p;              // 8 * max(ks, ns): the template instance
};

enum Act {
  RELU, GELU, SILU, ELU, CELU, LEAKY_RELU, SIGMOID, TANH, SOFTPLUS, MISH,
  IDENTITY
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// GELU, the tanh approximation as flax's nn.gelu, as x sigma(2u):
// exp(-2u) = 2^(-2 sqrt(2/pi) log2(e) (x + 0.044715 x^3)), then x / (1 + it)
__device__ __forceinline__ float gelu(float x) {
  const float a = -2.302208198144325f * fmaf(0.044715f * x, x * x, x);
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(a));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return x * r;
}

// The activations of tpu_cfd_torch/ops/cuda/ffn.py ACTIVATIONS, same order.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case RELU: return fmaxf(x, 0.f);
    case GELU: return gelu(x);
    case SILU: return x / (1.f + expf(-x));
    case ELU:
    case CELU: return x > 0.f ? x : expm1f(x);  // alpha = 1 for both
    case LEAKY_RELU: return x >= 0.f ? x : 0.01f * x;
    case SIGMOID: return 1.f / (1.f + expf(-x));
    case TANH: return tanhf(x);
    case SOFTPLUS: return softplus(x);
    case MISH: return x * tanhf(softplus(x));
    default: return x;
  }
}

// The activation of a kernel instance: GELU and ReLU (the main paths') are
// compiled in, with no branch between the products; ANY switches on `act`.
constexpr int ANY = -1;
template <int ACT>
__device__ __forceinline__ float activation(float x, int act) {
  if constexpr (ACT == GELU) return gelu(x);
  else if constexpr (ACT == RELU) return fmaxf(x, 0.f);
  else return activate(x, act);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float y);
template <>
__device__ __forceinline__ float from_float<float>(float y) { return y; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float y) {
  return __float2bfloat16(y);  // round to nearest even
}

// The 3xTF32 split without a conversion instruction (those share the SFU's
// pipe with the activation's exp and reciprocal): hi is x rounded to the
// nearest TF32, ties away from zero (as cvt.rna.tf32.f32), by integer ops;
// lo = x - hi is exact and goes in as it is: the tensor core reads a TF32
// operand's top 19 bits, so lo is truncated, off by less than 2^-21 |x|.
__device__ __forceinline__ void split_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 split_pair(float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split_int(v0, h0, l0);
  split_int(v1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
}

// T is the type of the rows of x and out: float or __nv_bfloat16. P is K
// and KO padded to 8, the larger: the register arrays' size.
template <int P, typename T, int ACT>
__global__ void __launch_bounds__(MAX_THREADS) ffn_kernel(
    const T* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ out, long long M,
    const FfnLayout L, int act) {
  constexpr int S = P / 8;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* W1f = reinterpret_cast<float4*>(smem + L.w1f);
  float4* W2f = reinterpret_cast<float4*>(smem + L.w2f);
  float* B1s = reinterpret_cast<float*>(smem + L.b1);
  float* B2s = reinterpret_cast<float*>(smem + L.b2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // W1: position (j, ks), b0 = w1[8j+g][8ks+t], b1 = w1[8j+g][8ks+t+4]
  for (int i = tid; i < L.hs * L.ks * 32; i += blockDim.x) {
    const int pos = i >> 5, gg = (i & 31) >> 2, tt = i & 3;
    const int r = 8 * (pos / L.ks) + gg, c = 8 * (pos % L.ks) + tt;
    const bool row = r < L.H;
    W1f[i] = split_pair(row && c < L.K ? w1[r * L.K + c] : 0.f,
                        row && c + 4 < L.K ? w1[r * L.K + c + 4] : 0.f);
  }
  // W2 in the permuted order: position (j, ns), b0 = w2[8ns+g][8j+2t],
  // b1 = w2[8ns+g][8j+2t+1]
  for (int i = tid; i < L.hs * L.ns * 32; i += blockDim.x) {
    const int pos = i >> 5, gg = (i & 31) >> 2, tt = i & 3;
    const int o = 8 * (pos % L.ns) + gg, h = 8 * (pos / L.ns) + 2 * tt;
    const bool row = o < L.KO;
    W2f[i] = split_pair(row && h < L.H ? w2[o * L.H + h] : 0.f,
                        row && h + 1 < L.H ? w2[o * L.H + h + 1] : 0.f);
  }
  for (int i = tid; i < 8 * L.hs; i += blockDim.x) B1s[i] = i < L.H ? b1[i] : 0.f;
  for (int i = tid; i < 8 * L.ns; i += blockDim.x) B2s[i] = i < L.KO ? b2[i] : 0.f;
  __syncthreads();

  unsigned char* mine = smem + L.xs + warp * (2 * L.xbuf + L.obuf);
  auto xbuf = [&](int which) { return reinterpret_cast<T*>(mine + which * L.xbuf); };
  T* ob = reinterpret_cast<T*>(mine + 2 * L.xbuf);
  const long long tiles = (M + 15) / 16;
  const long long stride = (long long)gridDim.x * L.warps;

  // One cp.async group a tile, empty past the end, so that waiting for all
  // but the newest group always waits for the current tile.
  auto fetch = [&](long long tile, T* buf) {
    if (tile < tiles) {
      const long long r0 = 16 * tile;
      const T* src = x + r0 * L.K;
      if (M - r0 >= 16) {
        for (int i = lane; i < L.xbuf / 16; i += 32)
          cp_async16(reinterpret_cast<char*>(buf) + 16 * i,
                     reinterpret_cast<const char*>(src) + 16 * i);
      } else {  // the ragged last tile
        for (int i = lane; i < (int)(M - r0) * L.K; i += 32) buf[i] = src[i];
      }
    }
    cp_async_commit();
  };

  long long tile = (long long)blockIdx.x * L.warps + warp;
  fetch(tile, xbuf(0));
  for (int cur = 0; tile < tiles; tile += stride, cur ^= 1) {
    fetch(tile + stride, xbuf(cur ^ 1));
    cp_async_wait<1>();
    __syncwarp();
    const long long r0 = 16 * tile;
    const int rows = (int)min(16LL, M - r0);
    const T* xs = xbuf(cur);

    // the tile's A fragments, hi and lo; zero past K and past the rows
    uint32_t ah[S][4], al[S][4];
#pragma unroll
    for (int ks = 0; ks < S; ++ks) {
      if (ks < L.ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = g + 8 * (q & 1), c = 8 * ks + t + 4 * (q >> 1);
          const float v = r < rows && c < L.K ? to_float(xs[r * L.K + c]) : 0.f;
          if (BF16) {
            ah[ks][q] = __float_as_uint(v);
            al[ks][q] = 0u;
          } else {
            split_int(v, ah[ks][q], al[ks][q]);
          }
        }
      }
    }
    float acc[S][4];
#pragma unroll
    for (int ns = 0; ns < S; ++ns) {
      const float2 bb = *reinterpret_cast<const float2*>(B2s + 8 * ns + 2 * t);
      acc[ns][0] = acc[ns][2] = bb.x;
      acc[ns][1] = acc[ns][3] = bb.y;
    }

    // One block of 8 hidden units into sum: pre = x W1^T + b1 on the
    // tensor cores, act() in registers, and the accumulators straight back
    // as the A fragment of the second product.
    auto hidden = [&](int j, float (&sum)[S][4]) {
      const float2 bb = *reinterpret_cast<const float2*>(B1s + 8 * j + 2 * t);
      float pre[4] = {bb.x, bb.y, bb.x, bb.y};
#pragma unroll
      for (int ks = 0; ks < S; ++ks) {
        if (ks < L.ks) {
          const float4 w = W1f[(j * L.ks + ks) * 32 + lane];
          const uint32_t bh[2] = {__float_as_uint(w.x), __float_as_uint(w.y)};
          const uint32_t bl[2] = {__float_as_uint(w.z), __float_as_uint(w.w)};
          if (!BF16) mma_tf32(pre, al[ks], bh);
          mma_tf32(pre, ah[ks], bl);
          mma_tf32(pre, ah[ks], bh);
        }
      }
      // C fragment (rows g, g, g+8, g+8; units 2t, 2t+1, 2t, 2t+1) into the
      // A fragment (a0 = row g k t, a1 = row g+8 k t, a2 = row g k t+4, a3 =
      // row g+8 k t+4): k = t is unit 2t, k = t + 4 is unit 2t + 1
      uint32_t hh[4], hl[4];
      split_int(activation<ACT>(pre[0], act), hh[0], hl[0]);
      split_int(activation<ACT>(pre[2], act), hh[1], hl[1]);
      split_int(activation<ACT>(pre[1], act), hh[2], hl[2]);
      split_int(activation<ACT>(pre[3], act), hh[3], hl[3]);
#pragma unroll
      for (int ns = 0; ns < S; ++ns) {
        if (ns < L.ns) {
          const float4 w = W2f[(j * L.ns + ns) * 32 + lane];
          const uint32_t bh[2] = {__float_as_uint(w.x), __float_as_uint(w.y)};
          const uint32_t bl[2] = {__float_as_uint(w.z), __float_as_uint(w.w)};
          mma_tf32(sum[ns], hl, bh);
          mma_tf32(sum[ns], hh, bl);
          mma_tf32(sum[ns], hh, bh);
        }
      }
    };
    // two blocks in flight, into two sets of accumulators, so that the
    // products of one overlap the activation of the other
    float acc2[S][4] = {};
    int j = 0;
    for (; j + 1 < L.hs; j += 2) {
      hidden(j, acc);
      hidden(j + 1, acc2);
    }
    if (j < L.hs) hidden(j, acc);
#pragma unroll
    for (int ns = 0; ns < S; ++ns)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[ns][q] += acc2[ns][q];

    // the output tile through shared memory, rows of KO, then out
#pragma unroll
    for (int ns = 0; ns < S; ++ns) {
      if (ns < L.ns) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = g + 8 * (q >> 1), c = 8 * ns + 2 * t + (q & 1);
          if (c < L.KO) ob[r * L.KO + c] = from_float<T>(acc[ns][q]);
        }
      }
    }
    __syncwarp();
    T* dst = out + r0 * L.KO;
    if (rows == 16) {
      for (int i = lane; i < L.obuf / 16; i += 32)
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst) + 16 * i) =
            *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(ob) + 16 * i);
    } else {
      for (int i = lane; i < rows * L.KO; i += 32) dst[i] = ob[i];
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// A launch plan: the SMs of a device, and how many blocks of a layout fit
// on one, with the shared-memory attribute set for that layout.
struct Plan {
  int sms = 0, smem = -1, warps = 0, blocks = 0;
};
constexpr int kMaxDevices = 64;

// Blocks a launch: as many as fit on the SMs at once, no more than there
// are tiles for their warps. The launch and the attribute go to the current
// device, so the plan is kept a device.
template <int P, typename T, int ACT>
int launch_rows(const T* x, const float* w1, const float* b1, const float* w2,
                const float* b2, T* out, long long M, const FfnLayout& L,
                int smem, int act, cudaStream_t stream) {
  static Plan plans[kMaxDevices];
  const auto kernel = ffn_kernel<P, T, ACT>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Plan& plan = plans[dev];
  if (smem != plan.smem || L.warps != plan.warps) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
    }
    e = cudaDeviceGetAttribute(&plan.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan.blocks, kernel,
                                                      32 * L.warps, smem);
    if (e != cudaSuccess) return (int)e;
    if (plan.blocks < 1) return (int)cudaErrorInvalidValue;
    plan.smem = smem;
    plan.warps = L.warps;
  }
  const long long tiles = (M + 15) / 16;
  const long long want = (tiles + L.warps - 1) / L.warps;
  const long long fit = (long long)plan.blocks * plan.sms;
  const long long blocks = want < fit ? want : fit;
  kernel<<<(unsigned)blocks, 32 * L.warps, smem, stream>>>(x, w1, b1, w2, b2, out,
                                                           M, L, act);
  return (int)cudaGetLastError();
}

template <int P, typename T>
int launch_act(const void* x, const float* w1, const float* b1, const float* w2,
               const float* b2, void* out, long long M, const FfnLayout& L, int smem,
               int act, cudaStream_t stream) {
  const T* xt = (const T*)x;
  T* ot = (T*)out;
  if (act == GELU)
    return launch_rows<P, T, GELU>(xt, w1, b1, w2, b2, ot, M, L, smem, act, stream);
  if (act == RELU)
    return launch_rows<P, T, RELU>(xt, w1, b1, w2, b2, ot, M, L, smem, act, stream);
  return launch_rows<P, T, ANY>(xt, w1, b1, w2, b2, ot, M, L, smem, act, stream);
}

template <int P>
int launch(const void* x, const float* w1, const float* b1, const float* w2,
           const float* b2, void* out, long long M, const FfnLayout& L, int smem,
           int act, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_act<P, __nv_bfloat16>(x, w1, b1, w2, b2, out, M, L, smem, act, stream);
  return launch_act<P, float>(x, w1, b1, w2, b2, out, M, L, smem, act, stream);
}

}  // namespace

extern "C" {

// x (M, K), w1 (H, K), b1 (H), w2 (KO, H), b2 (KO) -> out (M, KO); the
// nn.Linear layouts. x and out are bf16 when `bf16` is non-zero, else fp32,
// both 16-byte aligned; the weights are fp32 either way. `layout` is
// ffn_layout's ints; a width it does not take returns cudaErrorInvalidValue
// without a launch.
int pointwise_ffn(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, long long M,
                  int act, int bf16, const int* layout, int smem_bytes,
                  void* stream) {
  FfnLayout L;
  memcpy(&L, layout, sizeof(FfnLayout));
  const float *w1p = (const float*)w1, *b1p = (const float*)b1,
              *w2p = (const float*)w2, *b2p = (const float*)b2;
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 0) return 0;
  if (L.warps < 1 || 32 * L.warps > MAX_THREADS) return (int)cudaErrorInvalidValue;
#define FFN_CASE(P) \
  case P: return launch<P>(x, w1p, b1p, w2p, b2p, out, M, L, smem_bytes, act, bf16, s);
  switch (L.p) {
    FFN_CASE(8) FFN_CASE(16) FFN_CASE(24) FFN_CASE(32) FFN_CASE(40) FFN_CASE(48)
    FFN_CASE(56) FFN_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFN_CASE
}

}  // extern "C"
