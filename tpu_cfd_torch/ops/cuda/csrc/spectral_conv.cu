// Truncated 2-D DFT pair of the SFNO spatial spectral conv, for Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernels of tpu_cfd/models/pallas_conv.py::make_dft2d_ops:
//
//   dft2d_modes   (_modes_kernel, pallas_call in _modes_impl):
//     v (B, nx, ny) real -> g (B, 2my, 2mx) complex,
//     g[y', x'] = sum_{x,y} Fy[y', y] Fx[x', x] v[x, y]
//   dft2d_inverse (_inverse_kernel, pallas_call in _inverse_impl):
//     g (B, 2my, 2mx) complex -> out (B, nx, ny) real,
//     out[x, y] = scale * Re sum_{x',y'} Gx[x, x'] Gy[y, y'] g[y', x']
//
// over B = b * P planes (P = time steps x channels), modes [0..m-1, -m..-1].
// The TPU kernel runs both contractions of a chunk of planes in VMEM. A
// 256^2 fp32 plane (256 KiB) alone is more than an SM's 227 KB of shared
// memory, and the model's eval phase runs at 256^2, so here each transform
// is two passes of one tiled batched complex GEMM, one pass per
// contraction, with the intermediate in device memory (L2 when it fits):
//
//   modes:   H = v @ FyT (nx x 2my, real x complex);  g = H^T @ FxT
//   inverse: Q = g @ GxT (2my x nx, complex);          out = scale Re(Q^T @ GyT)
//
// Each pass is C[p] = op(A[p]) @ B for a matrix B shared by every plane:
// 64 x 64 output tiles, 16-deep contraction chunks staged in shared
// memory, 256 threads, each thread a 4 x 4 register tile. Any size works;
// ragged edges are masked.
//
// Cost: these kernels do 4 nx ny 2my + 8 2my nx 2mx flops per plane for
// either transform (the real x complex contraction costs half a complex
// one): 20.1 GFLOP at the SFNO McWilliams recipe (B = 64 * 100 planes of
// 64^2, 2m = 64). The function needs less: at 2m = n it is a full real 2-D
// DFT, which an FFT computes in 2.5 N log2 N flops per plane (0.79 GFLOP).
// Its floor is then the 315 MB read and written: 0.094 ms at 3.35 TB/s
// (H100 SXM data sheet), bound by bytes. The intermediate adds 2 x 210 MB
// of traffic that a fused design would keep on chip.
//
// Plain C interface: pointers and the stream are void*; each entry point
// returns the first launch error (cudaGetLastError() after each launch).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256, RT = 4;

template <bool REAL>
struct Elem;
template <>
struct Elem<true> {
  using T = float;
};
template <>
struct Elem<false> {
  using T = float2;
};

__device__ __forceinline__ float2 zero_of(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ float zero_of(float) { return 0.f; }

// acc += a * b for the three operand kinds the passes use.
__device__ __forceinline__ void mac(float2& acc, float a, float2 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
}
__device__ __forceinline__ void mac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}
__device__ __forceinline__ void mac(float& acc, float2 a, float2 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(-a.y, b.y, acc);
}

__device__ __forceinline__ void store(float2* c, float2 v, float alpha) {
  *c = make_float2(alpha * v.x, alpha * v.y);
}
__device__ __forceinline__ void store(float* c, float v, float alpha) {
  *c = alpha * v;
}

// C[p] (M x N) = alpha * op(A[p]) @ B for p < batch. A[p] is (M x K)
// row-major, or (K x M) row-major when TRANS_A; B is (K x N) complex. With
// REAL_OUT, C holds only the real part.
template <bool REAL_A, bool TRANS_A, bool REAL_OUT>
__global__ void __launch_bounds__(THREADS) bgemm_kernel(
    const typename Elem<REAL_A>::T* __restrict__ A,
    const float2* __restrict__ B, typename Elem<REAL_OUT>::T* __restrict__ C,
    int M, int N, int K, long long batch, float alpha) {
  using TA = typename Elem<REAL_A>::T;
  using TC = typename Elem<REAL_OUT>::T;
  __shared__ TA As[BK][BM + 1];
  __shared__ float2 Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const TA za = zero_of(TA());
  const TC zc = zero_of(TC());

  for (long long p = blockIdx.z; p < batch; p += gridDim.z) {
    const TA* Ap = A + p * (long long)M * K;
    TC* Cp = C + p * (long long)M * N;
    TC acc[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = zc;

    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        int mi, ki;
        if (TRANS_A) {
          ki = i / BM;
          mi = i % BM;
        } else {
          mi = i / BK;
          ki = i % BK;
        }
        const int m = m0 + mi, k = k0 + ki;
        As[ki][mi] = (m < M && k < K)
                         ? (TRANS_A ? Ap[(long long)k * M + m]
                                    : Ap[(long long)m * K + k])
                         : za;
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int ki = i / BN, ni = i % BN, k = k0 + ki, n = n0 + ni;
        Bs[ki][ni] = (k < K && n < N) ? B[(long long)k * N + n]
                                      : make_float2(0.f, 0.f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        TA a[RT];
        float2 b[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RT; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RT; ++j) mac(acc[i][j], a[i], b[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int n = n0 + tx + 16 * j;
        if (m < M && n < N) store(&Cp[(long long)m * N + n], acc[i][j], alpha);
      }
    }
  }
}

template <bool REAL_A, bool TRANS_A, bool REAL_OUT>
int bgemm(const void* A, const void* B, void* C, int M, int N, int K,
          long long batch, float alpha, cudaStream_t stream) {
  const long long z = batch < 65535 ? batch : 65535;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (unsigned)z);
  bgemm_kernel<REAL_A, TRANS_A, REAL_OUT><<<grid, THREADS, 0, stream>>>(
      (const typename Elem<REAL_A>::T*)A, (const float2*)B,
      (typename Elem<REAL_OUT>::T*)C, M, N, K, batch, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// v (B, nx, ny) f32, FyT (ny, my2) c64, FxT (nx, mx2) c64, scratch H
// (B, nx, my2) c64 -> g (B, my2, mx2) c64.
int dft2d_modes(const void* v, const void* FyT, const void* FxT, void* H,
                void* g, long long B, int nx, int ny, int my2, int mx2,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return 0;
  const int e = bgemm<true, false, false>(v, FyT, H, nx, my2, ny, B, 1.f, s);
  if (e != 0) return e;
  return bgemm<false, true, false>(H, FxT, g, my2, mx2, nx, B, 1.f, s);
}

// g (B, my2, mx2) c64, GxT (mx2, nx) c64, GyT (my2, ny) c64, scratch Q
// (B, my2, nx) c64 -> out (B, nx, ny) f32 = scale * Re(...).
int dft2d_inverse(const void* g, const void* GxT, const void* GyT, void* Q,
                  void* out, long long B, int nx, int ny, int my2, int mx2,
                  float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return 0;
  const int e = bgemm<false, false, false>(g, GxT, Q, my2, nx, mx2, B, 1.f, s);
  if (e != 0) return e;
  return bgemm<false, true, true>(Q, GyT, out, nx, ny, my2, B, scale, s);
}

}  // extern "C"
