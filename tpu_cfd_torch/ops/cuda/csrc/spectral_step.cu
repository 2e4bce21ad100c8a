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
//      -(u dw/dx + v dw/dy), and the forward last-axis DFT, over chunks of
//      block_cols physical columns. The physical fields never reach device
//      memory.
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
// the H100 SXM's 67 TFLOP/s fp32 (NVIDIA data sheet): the kernels are bound
// by operations, so each one is a register-tiled product whose operands are
// staged in shared memory by cp.async one chunk ahead of the FMAs:
//
//   K1: 64 x 32 (x, c) tiles of all four fields, 16-deep chunks of r; a
//       thread holds 8 rows x 4 fields, and forms i c_f w for its column
//       as the operand loads (c_f comes as one float4 of the four fields);
//   K3: 64 x 32 (r, c) tiles, 32-deep chunks of x, 4 x 2 a thread, the
//       Crank-Nicolson update in the epilogue, in place on h and w;
//   K2: TX = 32 rows (16 or 8 where the spectrum is wider) of the four
//       first-axis fields stay in shared memory for the whole block
//       ([k][x][field], k = 2c + re/im), and one stream of tiles runs
//       through a 3-slot cp.async ring of 4 KB: for each chunk of
//       block_cols columns, 16-deep tiles of the interleaved inverse
//       matrix IL (2m x n) for each 64 columns, then FR-row tiles of the
//       forward matrix FL (n x 2m). A thread holds 4 fields x 2 rows x 4
//       columns of the physical fields, writes their advection term to
//       shared memory at the end of the depth, and keeps its part of T
//       (2 rows x NP passes of 4 floats) in registers across all chunks.
//       The pass count is a template parameter, so the forward part has
//       no branch between its loads; at 256^2 Galerkin a block takes
//       112 KB and two share an SM.
//
// Plain C interface: every pointer and the stream are void*, and each
// entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int K13_THREADS = 256;
constexpr int K1_BM = 64, K1_BN = 32, K1_KC = 16, K1_TM = 8;  // 8 rows x 1 column a thread
constexpr int K3_BM = 64, K3_BN = 32, K3_KC = 32, K3_TM = 4, K3_TN = 2;
constexpr int K2_THREADS = 256, K2_JC = 64, K2_KC = 16, K2_STAGES = 3, K2_SLOT = 1024;

__device__ __forceinline__ float2 cmac(float2 acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
  return acc;
}

// cp.async of 4, 8 or 16 bytes; zeros where !ok (nothing is read then)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K1: A[s, f, x, c] = sum_r G[x, r] * (i * cf[f, r, c] * w[s, r, c]), with
// GT = G^T (R x n) and cf4[r, c] = the four fields' multipliers.
__global__ void __launch_bounds__(K13_THREADS) inverse_first_kernel(
    const float2* __restrict__ w, const float2* __restrict__ GT,
    const float4* __restrict__ cf4, float2* __restrict__ A, int R, int m,
    int n) {
  extern __shared__ float4 smem4[];
  float2* Gs = reinterpret_cast<float2*>(smem4);                  // [2][KC][BM]
  float2* Ws = Gs + 2 * K1_KC * K1_BM;                             // [2][KC][BN]
  float4* Cs = reinterpret_cast<float4*>(Ws + 2 * K1_KC * K1_BN);  // [2][KC][BN]
  const int tid = threadIdx.x, tc = tid % K1_BN, tr = tid / K1_BN;
  const int c0 = blockIdx.x * K1_BN, x0 = blockIdx.y * K1_BM, s = blockIdx.z;
  const float2* ws = w + (size_t)s * R * m;
  auto load = [&](int buf, int r0) {
    for (int i = tid; i < K1_KC * K1_BM; i += K13_THREADS) {
      const int ri = i / K1_BM, xi = i % K1_BM, r = r0 + ri, x = x0 + xi;
      const bool ok = r < R && x < n;
      cp_async8(Gs + (buf * K1_KC + ri) * K1_BM + xi, ok ? GT + (size_t)r * n + x : GT, ok);
    }
    for (int i = tid; i < K1_KC * K1_BN; i += K13_THREADS) {
      const int ri = i / K1_BN, ci = i % K1_BN, r = r0 + ri, c = c0 + ci;
      const bool ok = r < R && c < m;
      const size_t o = (size_t)r * m + c;
      cp_async8(Ws + (buf * K1_KC + ri) * K1_BN + ci, ok ? ws + o : ws, ok);
      cp_async16z(Cs + (buf * K1_KC + ri) * K1_BN + ci, ok ? cf4 + o : cf4, ok);
    }
    cp_async_commit();
  };
  float2 acc[4][K1_TM];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < K1_TM; ++i) acc[f][i] = make_float2(0.f, 0.f);

  const int chunks = (R + K1_KC - 1) / K1_KC;
  load(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks)
      load((ch + 1) & 1, (ch + 1) * K1_KC);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float2* G = Gs + (ch & 1) * K1_KC * K1_BM + K1_TM * tr;
    const float2* W = Ws + (ch & 1) * K1_KC * K1_BN + tc;
    const float4* C = Cs + (ch & 1) * K1_KC * K1_BN + tc;
#pragma unroll 8
    for (int k = 0; k < K1_KC; ++k) {
      float2 g[K1_TM];
#pragma unroll
      for (int i = 0; i < K1_TM / 2; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(G + k * K1_BM + 2 * i);
        g[2 * i] = make_float2(t.x, t.y);
        g[2 * i + 1] = make_float2(t.z, t.w);
      }
      const float2 wv = W[k * K1_BN];
      const float4 cv = C[k * K1_BN];
      const float cf[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float2 sv = make_float2(-cf[f] * wv.y, cf[f] * wv.x);
#pragma unroll
        for (int i = 0; i < K1_TM; ++i) acc[f][i] = cmac(acc[f][i], g[i], sv);
      }
    }
    __syncthreads();
  }
  const int c = c0 + tc;
  if (c >= m) return;
#pragma unroll
  for (int i = 0; i < K1_TM; ++i) {
    const int x = x0 + K1_TM * tr + i;
    if (x >= n) continue;
#pragma unroll
    for (int f = 0; f < 4; ++f)
      A[(((size_t)s * 4 + f) * n + x) * m + c] = acc[f][i];
  }
}

// K2's place in its stream of tiles, chunk by chunk (j0): for each 64
// columns (sub) the nk IL tiles of the depth (kt), then the nf FL tiles
// (ft >= 0).
struct Cursor {
  int j0, sub, kt, ft;
  __device__ __forceinline__ void next(int nk, int nsub, int nf, int jc) {
    if (ft < 0) {
      if (++kt == nk) {
        kt = 0;
        if (++sub == nsub) sub = 0, ft = 0;
      }
    } else if (++ft == nf) {
      ft = -1, j0 += jc;
    }
  }
};

// K2: T[s, x, c] = sum_j adv[x, j] * FL[j, c], with adv = -(gx*vx + gy*vy)
// and field_f[x, j] = sum_k A_f[x, k] IL[k, j] (k = 2c + re/im, IL's rows
// il_re and il_im interleaved). A thread holds NP passes of 4 floats of
// T's row, each pass 4 CG floats wide, so NP covers 2m.
template <int TX, int NP>
struct Advect {
  static constexpr int RG = TX >= 16 ? 16 : TX;  // row groups, RT rows each
  static constexpr int RT = TX / RG, CG = K2_THREADS / RG, CT = K2_JC / CG;
  static constexpr int W2 = NP * 4 * CG;  // columns of an FL tile (2m and padding)
  // rows of an FL tile: as many as fill a ring slot, at most 16
  static constexpr int FR = W2 >= K2_SLOT ? 1 : (K2_SLOT / W2 >= 16 ? 16 : K2_SLOT / W2 >= 8 ? 8 :
                            K2_SLOT / W2 >= 4 ? 4 : K2_SLOT / W2 >= 2 ? 2 : 1);
  static constexpr int SLOT = FR * W2 > K2_SLOT ? FR * W2 : K2_SLOT;
  static constexpr int AS = 4 * TX + 4;  // row stride of the field rows: [k][x][f]
  static constexpr int VS = TX + 1;      // row stride of the advection term: [j][x]
};

template <int TX, int NP>
__global__ void __launch_bounds__(K2_THREADS, 2) advect_kernel(
    const float* __restrict__ A, const float* __restrict__ IL,
    const float* __restrict__ FL, float2* __restrict__ T, int n, int m, int jc) {
  using K = Advect<TX, NP>;
  constexpr int RT = K::RT, CG = K::CG, CT = K::CT, W2 = K::W2, FR = K::FR;
  constexpr int AS = K::AS, VS = K::VS;
  extern __shared__ float4 smem4[];
  const int m2 = 2 * m, k1p = (m2 + K2_KC - 1) / K2_KC * K2_KC;
  float* As = reinterpret_cast<float*>(smem4);
  float* ring = As + k1p * AS;
  float* adv = ring + K2_STAGES * K::SLOT;  // (jc + FR) x VS, the last FR rows zero
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int s = blockIdx.y, x0 = blockIdx.x * TX;
  const int nk = k1p / K2_KC;  // IL tiles for each 64 columns
  const int nsub = (jc + K2_JC - 1) / K2_JC, nf = (jc + FR - 1) / FR;
  for (int i = tid; i < FR * VS; i += K2_THREADS) adv[jc * VS + i] = 0.f;

  // this block's rows of the four fields, zero past n and past 2m: thread
  // tid copies floats tid, tid + 256, ... of the (4 TX) x k1p rows
  {
    int row = tid / k1p, k = tid - row * k1p;
    for (; row < 4 * TX;) {
      const int f = row / TX, x = row - f * TX;
      const bool ok = x0 + x < n && k < m2;
      cp_async4(As + k * AS + 4 * x + f,
                ok ? A + ((((size_t)s * 4 + f) * n + x0 + x) * m2 + k) : A, ok);
      for (k += K2_THREADS; k >= k1p; k -= k1p) ++row;
    }
  }
  // the next tile into ring slot `slot_i` (the copies above go with tile 0)
  Cursor in{0, 0, 0, -1};
  auto fetch = [&](int slot_i) {
    if (in.j0 < n) {
      float* dst = ring + slot_i * K::SLOT;
      if (in.ft < 0) {  // IL rows k0.., columns jb..jb+63 of the chunk
        const int k0 = in.kt * K2_KC + (tid >> 6), j = in.j0 + in.sub * K2_JC + (tid & 63);
        const bool in_chunk = j < in.j0 + jc;
        static_assert(K2_KC * K2_JC == K2_SLOT, "an IL tile fills a slot");
#pragma unroll
        for (int q = 0; q < K2_KC * K2_JC / K2_THREADS; ++q) {
          const int k = k0 + q * (K2_THREADS / K2_JC);
          const bool ok = in_chunk && k < m2;
          cp_async4(dst + tid + q * K2_THREADS, ok ? IL + (size_t)k * n + j : IL, ok);
        }
      } else {  // FL rows j0 + ft FR.., all 2m columns
        const int row0 = in.ft * FR;
#pragma unroll
        for (int q = 0; q < (FR * W2 + K2_THREADS - 1) / K2_THREADS; ++q) {
          const int i = tid + q * K2_THREADS, rr = i / W2, col = i - rr * W2;
          if ((FR * W2) % K2_THREADS != 0 && i >= FR * W2) break;
          const bool ok = col < m2 && row0 + rr < jc;
          cp_async4(dst + i, ok ? FL + (size_t)(in.j0 + row0 + rr) * m2 + col : FL, ok);
        }
      }
      in.next(nk, nsub, nf, jc);
    }
    cp_async_commit();
  };

  float acc1[4][RT][CT];
  float acc2[NP][RT][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[p][r][e] = 0.f;

#pragma unroll
  for (int t = 0; t < K2_STAGES - 1; ++t) fetch(t);
  Cursor at{0, 0, 0, -1};
  for (int t = 0; at.j0 < n; ++t) {
    cp_async_wait<K2_STAGES - 2>();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    fetch((t + K2_STAGES - 1) % K2_STAGES);
    const float* cur = ring + (t % K2_STAGES) * K::SLOT;
    if (at.ft < 0) {
      if (at.kt == 0) {
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < CT; ++c) acc1[f][r][c] = 0.f;
      }
      const float* a = As + at.kt * K2_KC * AS + 4 * RT * rg;
      const float* b = cur + CT * cg;
#pragma unroll
      for (int kk = 0; kk < K2_KC; ++kk) {
        float av[RT][4], bv[CT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 t4 = *reinterpret_cast<const float4*>(a + kk * AS + 4 * r);
          av[r][0] = t4.x, av[r][1] = t4.y, av[r][2] = t4.z, av[r][3] = t4.w;
        }
        if constexpr (CT == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(b + kk * K2_JC);
          bv[0] = t4.x, bv[1] = t4.y, bv[2] = t4.z, bv[3] = t4.w;
        } else {
          static_assert(CT == 2, "a thread takes 2 or 4 columns");
          const float2 t2 = *reinterpret_cast<const float2*>(b + kk * K2_JC);
          bv[0] = t2.x, bv[1] = t2.y;
        }
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < CT; ++c) acc1[f][r][c] = fmaf(av[r][f], bv[c], acc1[f][r][c]);
      }
      if (at.kt == nk - 1) {  // the depth is done: this sub-tile's advection term
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const int j = at.sub * K2_JC + CT * cg + c;
          if (j >= jc) continue;
#pragma unroll
          for (int r = 0; r < RT; ++r)
            adv[j * VS + RT * rg + r] =
                -(acc1[2][r][c] * acc1[0][r][c] + acc1[3][r][c] * acc1[1][r][c]);
        }
      }
    } else {  // rows past jc read the zero rows of adv and of the tile
      const float* ap = adv + at.ft * FR * VS + RT * rg;
#pragma unroll
      for (int rr = 0; rr < FR; ++rr) {
        float av[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) av[r] = ap[rr * VS + r];
        const float* b = cur + rr * W2 + 4 * cg;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float4 bv = *reinterpret_cast<const float4*>(b + p * 4 * CG);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            acc2[p][r][0] = fmaf(av[r], bv.x, acc2[p][r][0]);
            acc2[p][r][1] = fmaf(av[r], bv.y, acc2[p][r][1]);
            acc2[p][r][2] = fmaf(av[r], bv.z, acc2[p][r][2]);
            acc2[p][r][3] = fmaf(av[r], bv.w, acc2[p][r][3]);
          }
        }
      }
    }
    at.next(nk, nsub, nf, jc);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int x = x0 + RT * rg + r;
      if (x >= n) continue;
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int c = (p * 4 * CG + 4 * cg + e) >> 1;
        if (c < m)
          T[((size_t)s * n + x) * m + c] = make_float2(acc2[p][r][e], acc2[p][r][e + 1]);
      }
    }
  }
}

// K3: Z = F @ T, e = Z*filt + forcing, h = e + beta*h (h = e at stage 0),
// w = (w + dtg*h + mu*lin*w) * dens, in place on h and w; FT = F^T (n x R).
__global__ void __launch_bounds__(K13_THREADS) forward_first_kernel(
    const float2* __restrict__ T, const float2* __restrict__ FT,
    const float* __restrict__ filt, const float2* __restrict__ frc,
    const float* __restrict__ lin, const float* __restrict__ dens,
    float2* __restrict__ h, float2* __restrict__ w, int R, int m, int n,
    int first, float beta, float dtg, float mu) {
  extern __shared__ float4 smem4[];
  float2* Fs = reinterpret_cast<float2*>(smem4);  // [2][KC][BM]
  float2* Ts = Fs + 2 * K3_KC * K3_BM;             // [2][KC][BN]
  constexpr int CGS = K3_BN / K3_TN;               // 16 column groups
  const int tid = threadIdx.x, tc = tid % CGS, tr = tid / CGS;
  const int c0 = blockIdx.x * K3_BN, r0 = blockIdx.y * K3_BM, s = blockIdx.z;
  const float2* ts = T + (size_t)s * n * m;
  auto load = [&](int buf, int k0) {
    for (int i = tid; i < K3_KC * K3_BM; i += K13_THREADS) {
      const int ki = i / K3_BM, ri = i % K3_BM, k = k0 + ki, r = r0 + ri;
      const bool ok = k < n && r < R;
      cp_async8(Fs + (buf * K3_KC + ki) * K3_BM + ri, ok ? FT + (size_t)k * R + r : FT, ok);
    }
    for (int i = tid; i < K3_KC * K3_BN; i += K13_THREADS) {
      const int ki = i / K3_BN, ci = i % K3_BN, k = k0 + ki, c = c0 + ci;
      const bool ok = k < n && c < m;
      cp_async8(Ts + (buf * K3_KC + ki) * K3_BN + ci, ok ? ts + (size_t)k * m + c : ts, ok);
    }
    cp_async_commit();
  };
  float2 acc[K3_TM][K3_TN];
#pragma unroll
  for (int i = 0; i < K3_TM; ++i)
#pragma unroll
    for (int j = 0; j < K3_TN; ++j) acc[i][j] = make_float2(0.f, 0.f);

  const int chunks = (n + K3_KC - 1) / K3_KC;
  load(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks)
      load((ch + 1) & 1, (ch + 1) * K3_KC);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float2* Fp = Fs + (ch & 1) * K3_KC * K3_BM + K3_TM * tr;
    const float2* Tp = Ts + (ch & 1) * K3_KC * K3_BN + K3_TN * tc;
#pragma unroll 8
    for (int k = 0; k < K3_KC; ++k) {
      const float4 f01 = *reinterpret_cast<const float4*>(Fp + k * K3_BM);
      const float4 f23 = *reinterpret_cast<const float4*>(Fp + k * K3_BM + 2);
      const float4 t01 = *reinterpret_cast<const float4*>(Tp + k * K3_BN);
      const float2 fv[K3_TM] = {make_float2(f01.x, f01.y), make_float2(f01.z, f01.w),
                                make_float2(f23.x, f23.y), make_float2(f23.z, f23.w)};
      const float2 tv[K3_TN] = {make_float2(t01.x, t01.y), make_float2(t01.z, t01.w)};
#pragma unroll
      for (int i = 0; i < K3_TM; ++i)
#pragma unroll
        for (int j = 0; j < K3_TN; ++j) acc[i][j] = cmac(acc[i][j], fv[i], tv[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < K3_TM; ++i) {
    const int r = r0 + K3_TM * tr + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < K3_TN; ++j) {
      const int c = c0 + K3_TN * tc + j;
      if (c >= m) continue;
      const size_t p = (size_t)r * m + c, o = (size_t)s * R * m + p;
      const float fl = filt[p];
      const float2 fv = frc[p];
      const float2 e = make_float2(acc[i][j].x * fl + fv.x, acc[i][j].y * fl + fv.y);
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
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int TX, int NP>
int launch_advect(const void* A, const void* IL, const void* FL, void* T, int b,
                  int n, int m, int jc, int smem, cudaStream_t stream) {
  // the host sizes the layout (advect_layout); refuse one smaller than the
  // instance reads
  using K = Advect<TX, NP>;
  const long long k1p = (2LL * m + K2_KC - 1) / K2_KC * K2_KC;
  if (NP * 4 * K::CG < 2 * m ||
      smem < 4 * (k1p * K::AS + K2_STAGES * K::SLOT + (jc + K::FR) * (long long)K::VS))
    return (int)cudaErrorInvalidValue;
  const int e = set_smem((const void*)advect_kernel<TX, NP>, smem);
  if (e != 0) return e;
  const dim3 grid((n + TX - 1) / TX, b);
  advect_kernel<TX, NP><<<grid, K2_THREADS, smem, stream>>>(
      (const float*)A, (const float*)IL, (const float*)FL, (float2*)T, n, m, jc);
  return (int)cudaGetLastError();
}

// the instance <TX, np> for np <= NP
template <int TX, int NP>
int dispatch_advect(int np, const void* A, const void* IL, const void* FL, void* T,
                    int b, int n, int m, int jc, int smem, cudaStream_t stream) {
  if constexpr (NP == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (np == NP) return launch_advect<TX, NP>(A, IL, FL, T, b, n, m, jc, smem, stream);
    return dispatch_advect<TX, NP - 1>(np, A, IL, FL, T, b, n, m, jc, smem, stream);
  }
}

}  // namespace

extern "C" {

int spectral_inverse_first(const void* w, const void* GT, const void* cf4,
                           void* A, int b, int R, int m, int n,
                           void* stream) {
  const size_t smem = 2 * K1_KC * ((K1_BM + K1_BN) * sizeof(float2) + K1_BN * sizeof(float4));
  const int e = set_smem((const void*)inverse_first_kernel, smem);
  if (e != 0) return e;
  const dim3 grid((m + K1_BN - 1) / K1_BN, (n + K1_BM - 1) / K1_BM, b);
  inverse_first_kernel<<<grid, K13_THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)w, (const float2*)GT, (const float4*)cf4, (float2*)A, R, m,
      n);
  return (int)cudaGetLastError();
}

// The K2 instance and its layout come from the host
// (spectral_step.py::advect_layout): tx rows a block (32, 16 or 8), np
// passes (up to 4, 8 or 12), smem bytes.
int spectral_advect(const void* A, const void* IL, const void* FL, void* T, int b,
                    int n, int m, int jc, int tx, int np, int smem, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tx) {
    case 32: return dispatch_advect<32, 4>(np, A, IL, FL, T, b, n, m, jc, smem, s);
    case 16: return dispatch_advect<16, 8>(np, A, IL, FL, T, b, n, m, jc, smem, s);
    case 8: return dispatch_advect<8, 12>(np, A, IL, FL, T, b, n, m, jc, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int spectral_forward_first(const void* T, const void* FT, const void* filt,
                           const void* frc, const void* lin, const void* dens,
                           void* h, void* w, int b, int R, int m, int n,
                           int first, float beta, float dtg, float mu,
                           void* stream) {
  const size_t smem = 2 * K3_KC * (K3_BM + K3_BN) * sizeof(float2);
  const int e = set_smem((const void*)forward_first_kernel, smem);
  if (e != 0) return e;
  const dim3 grid((m + K3_BN - 1) / K3_BN, (R + K3_BM - 1) / K3_BM, b);
  forward_first_kernel<<<grid, K13_THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)T, (const float2*)FT, (const float*)filt,
      (const float2*)frc, (const float*)lin, (const float*)dens, (float2*)h,
      (float2*)w, R, m, n, first, beta, dtg, mu);
  return (int)cudaGetLastError();
}

}  // extern "C"
