// Fused RK4-CN pseudo-spectral vorticity stage for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_cfd/ops/pallas/spectral_step.py::_make_kernel
// (pallas_call in _fused_rollout), in both of its layouts: the 2/3-rule
// Galerkin block (fused_rollout_galerkin) and the aligned (n, n/2) spectrum
// (fused_rollout_aligned). The TPU kernel keeps a whole rollout chunk in
// VMEM. An SM has 227 KB of shared memory, less than the eight transform
// matrices (~1 MB at 256^2) or one sample's four physical fields (1 MiB),
// so one low-storage RK4-CN stage is three kernels here, and the host
// wrapper (tpu_cfd_torch/ops/cuda/spectral_step.py) loops steps x 5 stages:
//
//   K1 spectral_inverse_first: the stream function and the four spectral
//      multipliers (u, v, d/dx w, d/dy w are each i*c_f*w) fused into the
//      first-axis inverse DFT, A_f = G @ (i c_f w): a batched complex
//      (n x R)(R x m) product for the four fields.
//   K2 spectral_advect: one block per (sample, TX physical rows): inverse
//      last-axis DFT of the four fields, the advection product
//      -(u dw/dx + v dw/dy), and the forward last-axis DFT, chunked over
//      block_cols physical columns. The physical fields never reach
//      device memory; the (m x n) and (n x m) matrices are read through
//      L1/L2.
//   K3 spectral_forward_first: the forward first-axis DFT (R x n)(n x m)
//      with the dealias filter, the constant forcing, h = e + beta_k h and
//      the per-mode Crank-Nicolson update in its epilogue, in place on the
//      state.
//
// Arithmetic is fp32 FFMA throughout, for every precision mode, so all
// three modes compute at least the accuracy that "highest" asks for.
//
// Bound: per sample and step, 5 * (40 n R m + 20 n^2 m) flops; at 256^2
// Galerkin (R=170, m=86) that is 1.31 GFLOP, 19.6 us per sample-step at
// the H100 SXM's 67 TFLOP/s fp32 (NVIDIA data sheet). The kernels are
// operation-bound at that rate; this first version is a plain tiled
// design (no tensor cores, no TMA) and runs at about a quarter of it:
// 75.6 us per sample-step at b=32 on an H100 80GB HBM3 at 700 W
// (chip_smoke.py; PERF.md).
//
// Plain C interface: every pointer and the stream are void*, and each
// entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;        // output tile edge of the first-axis products
constexpr int KC = 16;          // contraction chunk staged in shared memory
constexpr int TY = 8;           // thread rows per block (TILE x TY = 256)
constexpr int RPT = TILE / TY;  // output rows per thread
constexpr int TX = 8;           // physical rows per block in K2
constexpr int K2_THREADS = 256;

__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
  return acc;
}

// K1: A[s, f, x, c] = sum_r G[x, r] * (i * cf[f, r, c] * w[s, r, c]).
__global__ void __launch_bounds__(TILE * TY) inverse_first_kernel(
    const float2* __restrict__ w, const float2* __restrict__ G,
    const float* __restrict__ cf, float2* __restrict__ A, int R, int m,
    int n) {
  __shared__ float2 Gs[TILE][KC + 1];
  __shared__ float2 Ws[KC][TILE];
  __shared__ float Cs[4][KC][TILE];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE + tx;
  const int c0 = blockIdx.x * TILE, x0 = blockIdx.y * TILE, s = blockIdx.z;
  const float2* ws = w + (size_t)s * R * m;
  const float2 zero = make_float2(0.f, 0.f);
  float2 acc[4][RPT];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[f][i] = zero;

  for (int r0 = 0; r0 < R; r0 += KC) {
    for (int i = tid; i < TILE * KC; i += TILE * TY) {
      const int xi = i / KC, ri = i % KC, x = x0 + xi, r = r0 + ri;
      Gs[xi][ri] = (x < n && r < R) ? G[(size_t)x * R + r] : zero;
    }
    for (int i = tid; i < KC * TILE; i += TILE * TY) {
      const int ri = i / TILE, ci = i % TILE, r = r0 + ri, c = c0 + ci;
      const bool ok = r < R && c < m;
      Ws[ri][ci] = ok ? ws[(size_t)r * m + c] : zero;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        Cs[f][ri][ci] = ok ? cf[((size_t)f * R + r) * m + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float2 wv = Ws[kk][tx];
      float2 sv[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float cv = Cs[f][kk][tx];
        sv[f] = make_float2(-cv * wv.y, cv * wv.x);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float2 g = Gs[ty + TY * i][kk];
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[f][i] = cmac(acc[f][i], g, sv[f]);
      }
    }
    __syncthreads();
  }
  const int c = c0 + tx;
  if (c >= m) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int x = x0 + ty + TY * i;
    if (x >= n) continue;
#pragma unroll
    for (int f = 0; f < 4; ++f)
      A[(((size_t)s * 4 + f) * n + x) * m + c] = acc[f][i];
  }
}

// K2: T[s, x, c] = sum_j adv[x, j] * FL[j, c], with
// adv = -(gx*vx + gy*vy) and field_f[x, j] = sum_c Re(A_f) IL_re + Im(A_f) IL_im.
__global__ void __launch_bounds__(K2_THREADS) advect_kernel(
    const float2* __restrict__ A, const float* __restrict__ il_re,
    const float* __restrict__ il_im, const float2* __restrict__ fl,
    float2* __restrict__ T, int n, int m, int jc) {
  extern __shared__ float2 smem[];
  float2* As = smem;                                  // [4][TX][m]
  float2* Ts = As + 4 * TX * m;                       // [TX][m]
  float* adv = reinterpret_cast<float*>(Ts + TX * m);  // [TX][jc]
  const int tid = threadIdx.x, s = blockIdx.y, x0 = blockIdx.x * TX;
  const int rows = min(TX, n - x0);
  const float2 zero = make_float2(0.f, 0.f);

  for (int i = tid; i < 4 * TX * m; i += K2_THREADS) {
    const int f = i / (TX * m), rem = i % (TX * m), xi = rem / m, c = rem % m;
    As[i] = xi < rows ? A[(((size_t)s * 4 + f) * n + x0 + xi) * m + c] : zero;
  }
  for (int i = tid; i < TX * m; i += K2_THREADS) Ts[i] = zero;
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += jc) {
    for (int i = tid; i < TX * jc; i += K2_THREADS) {
      const int xi = i / jc, j = j0 + i % jc;
      const float2* a0 = As + xi * m;
      const float2* a1 = As + (TX + xi) * m;
      const float2* a2 = As + (2 * TX + xi) * m;
      const float2* a3 = As + (3 * TX + xi) * m;
      float vx = 0.f, vy = 0.f, gx = 0.f, gy = 0.f;
      for (int c = 0; c < m; ++c) {
        const float cr = __ldg(il_re + (size_t)c * n + j);
        const float ci = __ldg(il_im + (size_t)c * n + j);
        float2 a;
        a = a0[c]; vx = fmaf(a.x, cr, fmaf(a.y, ci, vx));
        a = a1[c]; vy = fmaf(a.x, cr, fmaf(a.y, ci, vy));
        a = a2[c]; gx = fmaf(a.x, cr, fmaf(a.y, ci, gx));
        a = a3[c]; gy = fmaf(a.x, cr, fmaf(a.y, ci, gy));
      }
      adv[i] = -(gx * vx + gy * vy);
    }
    __syncthreads();
    for (int i = tid; i < TX * m; i += K2_THREADS) {
      const int xi = i / m, c = i % m;
      float2 acc = Ts[i];
      const float* arow = adv + xi * jc;
      for (int j = 0; j < jc; ++j) {
        const float a = arow[j];
        const float2 f = __ldg(fl + (size_t)(j0 + j) * m + c);
        acc.x = fmaf(a, f.x, acc.x);
        acc.y = fmaf(a, f.y, acc.y);
      }
      Ts[i] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < TX * m; i += K2_THREADS) {
    const int xi = i / m;
    if (xi < rows) T[((size_t)s * n + x0 + xi) * m + i % m] = Ts[i];
  }
}

// K3: Z = F @ T, e = Z*filt + forcing, h = e + beta*h (h = e at stage 0),
// w = (w + dtg*h + mu*lin*w) * dens, in place on h and w.
__global__ void __launch_bounds__(TILE * TY) forward_first_kernel(
    const float2* __restrict__ T, const float2* __restrict__ F,
    const float* __restrict__ filt, const float2* __restrict__ frc,
    const float* __restrict__ lin, const float* __restrict__ dens,
    float2* __restrict__ h, float2* __restrict__ w, int R, int m, int n,
    int first, float beta, float dtg, float mu) {
  __shared__ float2 Fs[TILE][KC + 1];
  __shared__ float2 Tsh[KC][TILE];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE + tx;
  const int c0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE, s = blockIdx.z;
  const float2* ts = T + (size_t)s * n * m;
  const float2 zero = make_float2(0.f, 0.f);
  float2 acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = zero;

  for (int k0 = 0; k0 < n; k0 += KC) {
    for (int i = tid; i < TILE * KC; i += TILE * TY) {
      const int ri = i / KC, ki = i % KC, r = r0 + ri, k = k0 + ki;
      Fs[ri][ki] = (r < R && k < n) ? F[(size_t)r * n + k] : zero;
    }
    for (int i = tid; i < KC * TILE; i += TILE * TY) {
      const int ki = i / TILE, ci = i % TILE, k = k0 + ki, c = c0 + ci;
      Tsh[ki][ci] = (k < n && c < m) ? ts[(size_t)k * m + c] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float2 tv = Tsh[kk][tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = cmac(acc[i], Fs[ty + TY * i][kk], tv);
    }
    __syncthreads();
  }
  const int c = c0 + tx;
  if (c >= m) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= R) continue;
    const size_t p = (size_t)r * m + c, o = (size_t)s * R * m + p;
    const float fl = filt[p];
    const float2 fv = frc[p];
    const float2 e = make_float2(acc[i].x * fl + fv.x, acc[i].y * fl + fv.y);
    float2 hv = e;
    if (!first) {
      const float2 ho = h[o];
      hv = make_float2(e.x + beta * ho.x, e.y + beta * ho.y);
    }
    h[o] = hv;
    const float2 wv = w[o];
    const float li = lin[p], d = dens[p];
    w[o] = make_float2((wv.x + dtg * hv.x + mu * (li * wv.x)) * d,
                       (wv.y + dtg * hv.y + mu * (li * wv.y)) * d);
  }
}

// Dynamic shared memory K2 needs for a given spectrum width and chunk
// (mirrored by resolve_block_cols in spectral_step.py, which rejects
// configurations above the 227 KB a block may use).
size_t advect_smem(int m, int jc) {
  return (size_t)5 * TX * m * sizeof(float2) + (size_t)TX * jc * sizeof(float);
}

}  // namespace

extern "C" {

int spectral_inverse_first(const void* w, const void* G, const void* cf,
                           void* A, int b, int R, int m, int n,
                           void* stream) {
  const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE, b);
  inverse_first_kernel<<<grid, dim3(TILE, TY), 0, (cudaStream_t)stream>>>(
      (const float2*)w, (const float2*)G, (const float*)cf, (float2*)A, R, m,
      n);
  return (int)cudaGetLastError();
}

int spectral_advect(const void* A, const void* il_re, const void* il_im,
                    const void* fl, void* T, int b, int n, int m, int jc,
                    void* stream) {
  const size_t smem = advect_smem(m, jc);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        advect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + TX - 1) / TX, b);
  advect_kernel<<<grid, K2_THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)A, (const float*)il_re, (const float*)il_im,
      (const float2*)fl, (float2*)T, n, m, jc);
  return (int)cudaGetLastError();
}

int spectral_forward_first(const void* T, const void* F, const void* filt,
                           const void* frc, const void* lin, const void* dens,
                           void* h, void* w, int b, int R, int m, int n,
                           int first, float beta, float dtg, float mu,
                           void* stream) {
  const dim3 grid((m + TILE - 1) / TILE, (R + TILE - 1) / TILE, b);
  forward_first_kernel<<<grid, dim3(TILE, TY), 0, (cudaStream_t)stream>>>(
      (const float2*)T, (const float2*)F, (const float*)filt,
      (const float2*)frc, (const float*)lin, (const float*)dens, (float2*)h,
      (float2*)w, R, m, n, first, beta, dtg, mu);
  return (int)cudaGetLastError();
}

}  // extern "C"
