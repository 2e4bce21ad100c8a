// Fused pointwise FFN, out = act(x @ w1^T + b1) @ w2^T + b2, for Hopper
// (sm_90a): fp32 weights and accumulation, fp32 or bf16 input and output.
//
// Replaces the TPU kernel tpu_cfd/ops/pallas/ffn.py::_ffn_kernel (the
// pallas_call in _ffn_forward). That kernel tiles the rows and keeps both
// weight matrices and the expanded intermediate in VMEM. Here one block
// takes THREADS consecutive rows, one row per thread: both weight
// matrices sit in shared memory (zero-padded to a width P, a multiple of
// 4, so every weight read is a broadcast float4), the row's K inputs and
// K_out accumulators sit in registers, and the hidden unit is computed,
// activated and folded into the output one at a time, so the H-wide
// intermediate never exists in memory. The block's rows are staged
// through shared memory so that the loads of x and the stores of out are
// coalesced.
//
// Bound: 2 M H (K + K_out) flops against 4 M (K + K_out) bytes. At the
// SFNO McWilliams recipe (M = 64*64^2*10 = 2,621,440 rows, K = K_out = 10,
// H = 40) that is 4.19 GFLOP and 210 MB: 0.063 ms at 67 TFLOP/s fp32
// and 0.063 ms at 3.35 TB/s (H100 SXM data sheet), so the two balance.
// Padding K = 10 to P = 12 adds 20 % to the FMAs. With bf16 input and output
// (the SFNO's compute_dtype) the rows are 2 B an element, so the bytes halve
// (0.031 ms) and the operations bound it. As the TPU kernel does, it takes
// the rows in their own type, accumulates in fp32 and rounds once at the
// store; the weights stay fp32.
//
// Plain C interface: pointers and the stream are void*, and the entry
// point returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

enum Act {
  RELU, GELU, SILU, ELU, CELU, LEAKY_RELU, SIGMOID, TANH, SOFTPLUS, MISH,
  IDENTITY
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// The activations of tpu_cfd_torch/ops/cuda/ffn.py ACTIVATIONS, same order.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case RELU: return fmaxf(x, 0.f);
    case GELU: {  // tanh approximation, as flax's nn.gelu
      const float u = 0.7978845608028654f * fmaf(0.044715f * x, x * x, x);
      return 0.5f * x * (1.f + tanhf(u));
    }
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

__device__ __forceinline__ float load_row(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load_row(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ void store_row(float* o, long long i, float y) {
  o[i] = y;
}
__device__ __forceinline__ void store_row(__nv_bfloat16* o, long long i, float y) {
  o[i] = __float2bfloat16(y);  // round to nearest even
}

__host__ __device__ constexpr int pad4(int k) { return (k + 3) / 4 * 4; }

// The padded width P a channel count runs at: the next multiple of 4 up to
// 32, then 48 or 64; 0 for a width the kernel does not take.
int ffn_width(int k) {
  const int p = pad4(k);
  return p <= 32 ? p : p <= 48 ? 48 : p <= 64 ? 64 : 0;
}

// Shared memory of one block.
size_t ffn_smem(int P, int K, int H, int KO) {
  return sizeof(float) *
         ((size_t)2 * H * P + pad4(H) + P + (size_t)THREADS * (K + KO));
}

// T is the type of the rows of x and out: float or __nv_bfloat16.
template <int P, typename T>
__global__ void __launch_bounds__(THREADS) ffn_kernel(
    const T* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ out, long long M,
    int K, int H, int KO, int act) {
  extern __shared__ float4 smem4[];
  float* W1s = reinterpret_cast<float*>(smem4);  // [H][P], w1 rows padded
  float* W2s = W1s + H * P;                      // [H][P], w2 transposed
  float* B1s = W2s + H * P;                      // [H]
  float* B2s = B1s + pad4(H);                    // [P]
  float* Xs = B2s + P;                           // [THREADS][K]
  float* Os = Xs + THREADS * K;                  // [THREADS][KO]
  const int tid = threadIdx.x;

  for (int i = tid; i < H * P; i += THREADS) {
    const int j = i / P, k = i % P;
    W1s[i] = k < K ? w1[j * K + k] : 0.f;
    W2s[i] = k < KO ? w2[k * H + j] : 0.f;
  }
  for (int i = tid; i < H; i += THREADS) B1s[i] = b1[i];
  for (int i = tid; i < P; i += THREADS) B2s[i] = i < KO ? b2[i] : 0.f;

  const long long r0 = (long long)blockIdx.x * THREADS;
  const int rows = (int)min((long long)THREADS, M - r0);
  const T* xb = x + r0 * K;
  for (int i = tid; i < rows * K; i += THREADS) Xs[i] = load_row(xb, i);
  __syncthreads();

  if (tid < rows) {
    float xv[P], o[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      xv[k] = k < K ? Xs[tid * K + k] : 0.f;
      o[k] = B2s[k];
    }
    for (int j = 0; j < H; ++j) {
      const float4* a = reinterpret_cast<const float4*>(W1s + j * P);
      float pre = B1s[j];
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 w = a[q];
        pre = fmaf(xv[4 * q], w.x, pre);
        pre = fmaf(xv[4 * q + 1], w.y, pre);
        pre = fmaf(xv[4 * q + 2], w.z, pre);
        pre = fmaf(xv[4 * q + 3], w.w, pre);
      }
      const float hj = activate(pre, act);
      const float4* c = reinterpret_cast<const float4*>(W2s + j * P);
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 w = c[q];
        o[4 * q] = fmaf(hj, w.x, o[4 * q]);
        o[4 * q + 1] = fmaf(hj, w.y, o[4 * q + 1]);
        o[4 * q + 2] = fmaf(hj, w.z, o[4 * q + 2]);
        o[4 * q + 3] = fmaf(hj, w.w, o[4 * q + 3]);
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < KO) Os[tid * KO + k] = o[k];
  }
  __syncthreads();
  T* ob = out + r0 * KO;
  for (int i = tid; i < rows * KO; i += THREADS) store_row(ob, i, Os[i]);
}

template <int P, typename T>
int launch_rows(const T* x, const float* w1, const float* b1, const float* w2,
                const float* b2, T* out, long long M, int K, int H, int KO,
                int act, cudaStream_t stream) {
  const size_t smem = ffn_smem(P, K, H, KO);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ffn_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (M + THREADS - 1) / THREADS;
  ffn_kernel<P, T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      x, w1, b1, w2, b2, out, M, K, H, KO, act);
  return (int)cudaGetLastError();
}

template <int P>
int launch(const void* x, const float* w1, const float* b1, const float* w2,
           const float* b2, void* out, long long M, int K, int H, int KO,
           int act, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_rows<P>((const __nv_bfloat16*)x, w1, b1, w2, b2,
                          (__nv_bfloat16*)out, M, K, H, KO, act, stream);
  return launch_rows<P>((const float*)x, w1, b1, w2, b2, (float*)out, M, K, H,
                        KO, act, stream);
}

}  // namespace

extern "C" {

// x (M, K), w1 (H, K), b1 (H), w2 (KO, H), b2 (KO) -> out (M, KO); the
// nn.Linear layouts. x and out are bf16 when `bf16` is non-zero, else fp32;
// the weights are fp32 either way. K and KO at most 64; a wider FFN returns
// cudaErrorInvalidValue without a launch.
int pointwise_ffn(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, long long M,
                  int K, int H, int KO, int act, int bf16, void* stream) {
  const float *w1p = (const float*)w1, *b1p = (const float*)b1,
              *w2p = (const float*)w2, *b2p = (const float*)b2;
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 0) return 0;
#define FFN_CASE(P) \
  case P: return launch<P>(x, w1p, b1p, w2p, b2p, out, M, K, H, KO, act, bf16, s);
  switch (ffn_width(K > KO ? K : KO)) {
    FFN_CASE(4) FFN_CASE(8) FFN_CASE(12) FFN_CASE(16) FFN_CASE(20)
    FFN_CASE(24) FFN_CASE(28) FFN_CASE(32) FFN_CASE(48) FFN_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFN_CASE
}

}  // extern "C"
