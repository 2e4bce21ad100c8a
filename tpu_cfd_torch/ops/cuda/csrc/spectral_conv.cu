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
// The TPU kernel runs both contractions of a chunk of planes in VMEM.
//
// Cost: the dense contractions do 4 nx ny 2my + 8 2my nx 2mx flops per
// plane for either transform (the real x complex contraction costs half a
// complex one): 20.1 GFLOP at the SFNO McWilliams recipe (B = 64 * 100
// planes of 64^2, 2m = 64). The function needs less: at 2m = n it is a full
// real 2-D DFT, which an FFT computes in 2.5 N log2 N flops per plane (0.79
// GFLOP). Its floor is then the 315 MB read and written: 0.094 ms at 3.35
// TB/s (H100 SXM data sheet), bound by bytes.
//
// Two-pass route (each transform where its fused kernel does not fit: a
// 256^2 fp32 plane alone is more than an SM's 227 KB of shared memory, and
// the model's eval phase runs at 256^2). Each transform is two passes of one
// tiled batched complex GEMM on CUDA cores, one pass per contraction, with
// the intermediate in device memory (L2 when it fits):
//
//   modes:   H = v @ FyT (nx x 2my, real x complex);  g = H^T @ FxT
//   inverse: Q = g @ GxT (2my x nx, complex);          out = scale Re(Q^T @ GyT)
//
// Each pass is C[p] = op(A[p]) @ B for a matrix B shared by every plane:
// 64 x 64 output tiles, 16-deep contraction chunks staged in shared
// memory, 256 threads, each thread a 4 x 4 register tile. Any size works;
// ragged edges are masked. At the recipe either transform takes 0.61-0.68
// ms this way on an H100, behind cuFFT: the FFMA work, and the intermediate
// (210 MB) written and read back.
//
// Fused routes, where a few planes, their intermediate and both transform
// matrices fit in one SM's shared memory (64^2 at m = 32, two planes). Keeping
// the intermediate on chip alone cannot pass cuFFT, since the FFMA floor of
// 20.1 GFLOP is 0.30 ms; the products go to the tensor cores, on
// mma.sync.m16n8k8 TF32 with the 3xTF32 split (a_lo b_hi + a_hi b_lo + a_hi
// b_hi, fp32 accumulation), which keeps fp32 accuracy (plain TF32 keeps three
// digits), and only half of the modes take them. One persistent kernel a
// transform does both contractions of its planes on chip, as the TPU kernel
// does in VMEM; each block splits both matrices into TF32 hi and lo parts
// once and walks groups of planes, blockIdx.x, + gridDim.x, ..., the next
// group coming in by cp.async while one computes. The bound of either
// function stays 0.094 ms by bytes.
//
// dft2d_modes_fused (modes_fused_kernel, 30 GFLOP of TF32 products at the
// recipe):
//   - v is real, so g[-y, -x] = conj g[y, x] and H[x, -y] = conj H[x, y]:
//     the tensor cores compute the modes y = 0..my-1 only (my = my2 / 2),
//     and each row of g is stored with its mirror. Mode y = -my has no
//     mirror among the modes, and the mirrors of column x = -mx need column
//     x = +mx: those are sums on the CUDA cores (4 % of the flops at the
//     recipe); two v buffers;
//   - y-contraction: H (nx x my, re/im interleaved) = v @ view_as_real(FyT's
//     first my columns), one real product for the pp planes stacked, kept
//     in shared memory;
//   - x-contraction: g[y][.] = H[:, y]^T @ FxT, complex, as one real product
//     with a 2nx-deep contraction: A2[y'][2x + c] = H[x][2y' + c] and
//     B2[2x + c][n] = (c ? (n even ? -1 : 1) : 1) FxT_re_im[x][n ^ c], read
//     straight from the interleaved FxT, so g comes out interleaved
//     complex64 (B, 2my, 2mx) and is stored from the accumulators.
//
// dft2d_inverse_fused (inverse_fused_kernel): only the real part of the
// result is kept, and Gx[x, -x'] = conj Gx[x, x'] (Gy likewise), so a mode
// and its mirror add as Re(a (g + conj g')) for any g, Hermitian or not (the
// backward feeds it random cotangents). Each plane is folded as it moves
// from its cp.async buffer into the operand, gf[y'] = g[y'] + conj g[-y']
// with row 0 at weight 1/2, and the tensor cores take the my rows y' >= 0:
//   - x-contraction: Q (pp my x 2nx) = gf @ GxT, complex, in the same real
//     form as above (B2 from the interleaved GxT), the pp planes' rows
//     stacked; each warp holds one 32 x 32 tile of Q in registers while
//     Q^T overwrites the folded modes in shared memory;
//   - y-contraction: out[x][y] = scale sum_k Q^T[x][k] B3[k][y] with
//     B3[2y' + c][y] = (c ? -Im : Re) GyT[y'][y], depth 2my, reading Q's
//     re/im pairs in place;
//   - on the CUDA cores: row y' = -my and the mirrors of column x' = -mx,
//     which have no partner among the modes (2 % of the flops at the recipe).
//
// 8 warps each own 32 x 32 output tiles. Shared-memory strides are padded
// (row stride = 4, 8 or 16 mod 32 words) and the matrices' columns permuted
// within 32-column blocks, so that every fragment load is free of bank
// conflicts and a thread's four B fragments come in one 16-byte load. The
// layouts (planes a block, padded sizes, strides) come from the host
// (tpu_cfd_torch/ops/cuda/spectral_conv.py::fused_modes_layout and
// fused_inverse_layout), which also decides by their byte count whether a
// shape takes a fused kernel. mma.sync is Hopper's older path to the tensor
// cores; wgmma, which reaches the dense TF32 peak, is the next step.
//
// Plain C interface: pointers and the stream are void*; each entry point
// returns the first launch error (cudaGetLastError() after each launch).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tf32_mma.cuh"

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


// ---------------------------------------------------------------- fused ----

constexpr int FT = 256;  // threads of the fused kernel: 8 warps
constexpr int FWARPS = FT / 32;

// The fused kernel's shared-memory layout, in floats; the host computes it.
struct Layout {
  int nx, ny, my2, mx2;
  int pp;   // planes a block takes at once
  int k1;   // ny padded to 8: depth of the y-contraction
  int m1;   // nx padded to 32: rows of a plane in v and H
  int n1;   // 2 my (= my2) padded to 32: columns of H the tensor cores compute
  int m2;   // my = my2 / 2 padded to 32: rows of g the tensor cores compute
  int n2;   // 2 mx2 padded to 32: columns of g
  int xr;   // nx padded to 4: rows of FxT (the x-contraction is 2 xr deep)
  int sv, sy, sh, sx;  // row strides of v, FyT, H, FxT (4, 8, 16, 8 mod 32)
};

// Where column c of a transform matrix sits in shared memory: within each
// 32-column block, the four columns a thread's B fragments take (c, c + 8,
// c + 16, c + 24) are neighbours, so one 16-byte load fetches them.
__device__ __forceinline__ int perm32(int c) {
  return (c & ~31) | ((c & 7) << 2) | ((c >> 3) & 3);
}

// The fragments of one 8-deep step of a warp's 32 x 32 tile: A's two
// 16-row and B's four 8-column fragments, hi and lo TF32 parts.
struct Frags {
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
};

// acc[i][j] += A_i B_j in 3xTF32: the small terms first, and each pass over
// all eight accumulators, so no product waits on the one before it.
__device__ __forceinline__ void mma3(float (&acc)[2][4][4], const Frags& f) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], f.al[i], f.bh[j]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], f.ah[i], f.bl[j]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], f.ah[i], f.bh[j]);
}

__device__ __forceinline__ void b_quad(uint32_t (&b)[4][2], int slot,
                                       const float* at, float sgn) {
  const float4 t = *reinterpret_cast<const float4*>(at);
  b[0][slot] = __float_as_uint(sgn * t.x);
  b[1][slot] = __float_as_uint(sgn * t.y);
  b[2][slot] = __float_as_uint(sgn * t.z);
  b[3][slot] = __float_as_uint(sgn * t.w);
}

// A fragments at depth k0 of a row-major operand (row stride s).
__device__ __forceinline__ void a_rows(Frags& f, const float* A, int m0, int k0,
                                       int gq, int tq, int s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* a = A + (m0 + 16 * i + gq) * s + k0 + tq;
    split(a[0], f.ah[i][0], f.al[i][0]);
    split(a[8 * s], f.ah[i][1], f.al[i][1]);
    split(a[4], f.ah[i][2], f.al[i][2]);
    split(a[8 * s + 4], f.ah[i][3], f.al[i][3]);
  }
}

// B fragments at depth k0 of a real operand held as TF32 parts (row stride
// s, columns permuted by perm32).
__device__ __forceinline__ void b_real(Frags& f, const float* bh, const float* bl,
                                       int n0, int k0, int gq, int tq, int s) {
  const int o = (k0 + tq) * s + n0 + 4 * gq;
  b_quad(f.bh, 0, bh + o, 1.f);
  b_quad(f.bh, 1, bh + o + 4 * s, 1.f);
  b_quad(f.bl, 0, bl + o, 1.f);
  b_quad(f.bl, 1, bl + o + 4 * s, 1.f);
}

// B fragments at depth 2 x0 of a complex product in real form, read from
// the interleaved complex matrix F (TF32 parts, row stride s, columns
// permuted): B2[2x + c][n] = sgn F[x][n ^ c], c = tq & 1, sgn = -1 on the
// imaginary row (c = 1) of a real column (n even).
__device__ __forceinline__ void b_cplx(Frags& f, const float* bh, const float* bl,
                                       int n0, int x0, int gq, int tq, int s) {
  const int c = tq & 1;
  const float sgn = (c == 1 && (gq & 1) == 0) ? -1.f : 1.f;
  const int o = (x0 + (tq >> 1)) * s + n0 + 4 * (gq ^ c);
  b_quad(f.bh, 0, bh + o, sgn);
  b_quad(f.bh, 1, bh + o + 2 * s, sgn);
  b_quad(f.bl, 0, bl + o, sgn);
  b_quad(f.bl, 1, bl + o + 2 * s, sgn);
}

// y-contraction fragments at depth k0: A from V (row stride sv), B from the
// FyT parts (row stride sy).
__device__ __forceinline__ void frags_y(Frags& f, const float* V, const float* yh,
                                        const float* yl, int m0, int n0, int k0,
                                        int gq, int tq, int sv, int sy) {
  a_rows(f, V, m0, k0, gq, tq, sv);
  b_real(f, yh, yl, n0, k0, gq, tq, sy);
}

// x-contraction fragments at depth 2 x0: A2[y][2x + c] = H[x][2y + c] and
// B2 from the FxT parts (b_cplx).
__device__ __forceinline__ void frags_x(Frags& f, const float* H, const float* xh,
                                        const float* xl, int m0, int n0, int x0,
                                        int gq, int tq, int sh, int sx) {
  const float* hr = H + (x0 + (tq >> 1)) * sh + (tq & 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* a = hr + 2 * (m0 + 16 * i + gq);
    split(a[0], f.ah[i][0], f.al[i][0]);
    split(a[16], f.ah[i][1], f.al[i][1]);        // row + 8: column + 16
    split(a[2 * sh], f.ah[i][2], f.al[i][2]);    // k + 4: x + 2
    split(a[2 * sh + 16], f.ah[i][3], f.al[i][3]);
  }
  b_cplx(f, xh, xl, n0, x0, gq, tq, sx);
}

// The inverse's x-contraction fragments at depth 2 x0: A from the folded
// modes, row-major (row stride sg), B2 from the GxT parts (b_cplx).
__device__ __forceinline__ void frags_xi(Frags& f, const float* G, const float* xh,
                                         const float* xl, int m0, int n0, int x0,
                                         int gq, int tq, int sg, int sx) {
  a_rows(f, G, m0, 2 * x0, gq, tq, sg);
  b_cplx(f, xh, xl, n0, x0, gq, tq, sx);
}

// acc += the product of a warp's 32 x 32 tile over depth 8 * steps, the
// fragments of step s loaded by frag(f, s) one step ahead of the multiply.
template <typename Load>
__device__ __forceinline__ void tile_product(float (&acc)[2][4][4], int steps,
                                             Load frag) {
  Frags f[2];
  frag(f[0], 0);
  for (int s = 0; s < steps; s += 2) {
    if (s + 1 < steps) frag(f[1], s + 1);
    mma3(acc, f[0]);
    if (s + 1 >= steps) break;
    if (s + 2 < steps) frag(f[0], s + 2);
    mma3(acc, f[1]);
  }
}

// One plane (nx x ny floats, rows 16-byte aligned) into a v buffer.
__device__ __forceinline__ void load_plane(float* buf, const float* vp,
                                           const Layout& L) {
  const int q = L.ny / 4;
  for (int i = threadIdx.x; i < L.nx * q; i += FT) {
    const int r = i / q, c = 4 * (i - r * q);
    cp_async16(buf + r * L.sv + c, vp + (long long)r * L.ny + c);
  }
}

// Both TF32 parts of the first `cols` columns of a (rows x ld) fp32 matrix
// into (prow x stride) shared arrays, zero outside it, the first `pcols`
// columns permuted by perm32.
__device__ void load_split(float* hi, float* lo, const float* src, int rows,
                           int cols, int ld, int prow, int pcols, int stride) {
  for (int i = threadIdx.x; i < prow * stride; i += FT) {
    const int r = i / stride, c = i - r * stride;
    const float x = (r < rows && c < cols) ? src[r * ld + c] : 0.f;
    uint32_t h, l;
    split(x, h, l);
    const int at = r * stride + (c < pcols ? perm32(c) : c);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// v (B, nx, ny) f32 -> g (B, my2, mx2) c64 through FyT (ny, my2) and FxT
// (nx, mx2), both c64 read as interleaved floats. v is real, so
// g[-y, -x] = conj g[y, x]: the tensor cores compute the rows y = 0..my-1
// (my = my2 / 2) and each one's mirror is stored with it; row -my, whose
// mirror is not a mode, and column +mx, which the mirrors of column -mx
// need, are sums on the CUDA cores.
__global__ void __launch_bounds__(FT, 1) modes_fused_kernel(
    const float* __restrict__ v, const float* __restrict__ FyT,
    const float* __restrict__ FxT, float* __restrict__ g, long long B,
    const Layout L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int my = L.my2 / 2, mx = L.mx2 / 2;
  const int psz = L.m1 * L.sv;      // one plane in a v buffer
  const int vsz = L.pp * psz;       // two v buffers of pp planes first
  float* yh = smem + 2 * vsz;       // parts of FyT's first my columns (k1 x sy)
  float* yl = yh + L.k1 * L.sy;
  float* xh = yl + L.k1 * L.sy;     // FxT parts (xr x sx)
  float* xl = xh + L.xr * L.sx;
  float* H = xl + L.xr * L.sx;      // pp planes of (m1 x sh); column n1: y = -my
  float* fym = H + L.pp * L.m1 * L.sh;  // FyT column my (y = -my): ny complex
  float* fxp = fym + 2 * L.ny;          // conj FxT column mx: Fx at x = +mx, nx complex

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  const long long plane_v = (long long)L.nx * L.ny, plane_g = 2LL * L.my2 * L.mx2;
  const long long groups = (B + L.pp - 1) / L.pp;

  long long grp = blockIdx.x;
  auto load_group = [&](float* buf, long long gi) {
    for (int q = 0; q < L.pp; ++q) {
      const long long p = gi * L.pp + q;
      if (p < B) load_plane(buf + q * psz, v + p * plane_v, L);
    }
    cp_async_commit();
  };
  if (grp < groups) load_group(smem, grp);
  // zero the v buffers' padding (cp.async writes only the planes) and H,
  // then the matrices' TF32 parts and FyT's column my
  for (int i = threadIdx.x; i < vsz; i += FT) {
    const int r = (i % psz) / L.sv, c = i % L.sv;
    if (r >= L.nx || c >= L.ny) smem[i] = 0.f;
    smem[vsz + i] = 0.f;
  }
  for (int i = threadIdx.x; i < L.pp * L.m1 * L.sh; i += FT) H[i] = 0.f;
  load_split(yh, yl, FyT, L.ny, 2 * my, 2 * L.my2, L.k1, L.n1, L.sy);
  load_split(xh, xl, FxT, L.nx, 2 * L.mx2, 2 * L.mx2, L.xr, L.n2, L.sx);
  for (int i = threadIdx.x; i < 2 * L.ny; i += FT)
    fym[i] = FyT[(i >> 1) * 2 * L.my2 + 2 * my + (i & 1)];
  for (int i = threadIdx.x; i < 2 * L.nx; i += FT)  // Fx[+mx] = conj Fx[-mx]
    fxp[i] = (i & 1 ? -1.f : 1.f) * FxT[(i >> 1) * 2 * L.mx2 + 2 * mx + (i & 1)];
  __syncthreads();  // the second buffer is zero before the first prefetch

  const int ncol1 = L.n1 / 32, units1 = (L.pp * L.m1 / 32) * ncol1;
  const int ncol2 = L.n2 / 32, per2 = (L.m2 / 32) * ncol2, units2 = L.pp * per2;
  const int hsz = L.m1 * L.sh;
  for (int it = 0; grp < groups; grp += gridDim.x, ++it) {
    const long long next = grp + gridDim.x;
    if (next < groups) {
      load_group(smem + ((it + 1) & 1) * vsz, next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* V = smem + (it & 1) * vsz;

    // y-contraction of the pp planes stacked: H (pp m1 x n1) = V @ Fy[:, :my]
    for (int u = warp; u < units1; u += FWARPS) {
      const int m0 = (u / ncol1) * 32, n0 = (u % ncol1) * 32;
      const float* Vp = V + (m0 / L.m1) * psz;  // a tile never spans two planes
      float* Hp = H + (m0 / L.m1) * hsz;
      const int r0 = m0 % L.m1;
      float acc[2][4][4] = {};
      Frags f[2];  // the next step's fragments load while this step's multiply
      frags_y(f[0], Vp, yh, yl, r0, n0, 0, gq, tq, L.sv, L.sy);
      for (int k0 = 0; k0 < L.k1; k0 += 16) {
        if (k0 + 8 < L.k1) frags_y(f[1], Vp, yh, yl, r0, n0, k0 + 8, gq, tq, L.sv, L.sy);
        mma3(acc, f[0]);
        if (k0 + 8 >= L.k1) break;
        if (k0 + 16 < L.k1) frags_y(f[0], Vp, yh, yl, r0, n0, k0 + 16, gq, tq, L.sv, L.sy);
        mma3(acc, f[1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* h = Hp + (r0 + 16 * i + gq) * L.sh + n0 + 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(h) = make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(h + 8 * L.sh) =
              make_float2(acc[i][j][2], acc[i][j][3]);
        }
    }
    // H's column y = -my (at n1) on the CUDA cores: two neighbouring threads
    // a row, each over every other y, then one shuffle
    // (whole warps go round the loop, so that every lane takes the shuffle)
    const int pairs = 2 * L.pp * L.nx, span = (pairs + 31) & ~31;
    for (int i0 = threadIdx.x & ~1; i0 < span; i0 += FT) {
      const int i = i0 >> 1, q = i / L.nx, x = i - q * L.nx;
      float re = 0.f, im = 0.f;
      if (i0 < pairs) {
        const float* row = V + q * psz + x * L.sv;
        const float2* f = reinterpret_cast<const float2*>(fym);
        for (int y = lane & 1; y < L.ny; y += 2) {
          re = fmaf(row[y], f[y].x, re);
          im = fmaf(row[y], f[y].y, im);
        }
      }
      re += __shfl_xor_sync(0xffffffffu, re, 1);
      im += __shfl_xor_sync(0xffffffffu, im, 1);
      if (i0 < pairs && (lane & 1) == 0)
        *reinterpret_cast<float2*>(H + q * hsz + x * L.sh + L.n1) = make_float2(re, im);
    }
    __syncthreads();

    // x-contraction: g rows 0..my-1 (m2 x n2) = A2 (m2 x 2xr) @ B2 (2xr x n2),
    // with A2[y][2x + c] = H[x][2y + c] and B2[2x + c][n] = +-Fx[x][n ^ c];
    // each row y >= 1 also gives row -y: g[-y][-x] = conj g[y][x]
    for (int u = warp; u < units2; u += FWARPS) {
      const int q = u / per2, w = u - q * per2;
      const long long p = (grp * L.pp + q);
      if (p >= B) continue;
      const int m0 = (w / ncol2) * 32, n0 = (w % ncol2) * 32;
      const float* Hp = H + q * hsz;
      float* gp = g + p * plane_g;
      float acc[2][4][4] = {};
      Frags f[2];
      frags_x(f[0], Hp, xh, xl, m0, n0, 0, gq, tq, L.sh, L.sx);
      for (int x0 = 0; x0 < L.xr; x0 += 8) {  // depth 2 x0, 8 a step
        if (x0 + 4 < L.xr) frags_x(f[1], Hp, xh, xl, m0, n0, x0 + 4, gq, tq, L.sh, L.sx);
        mma3(acc, f[0]);
        if (x0 + 4 >= L.xr) break;
        if (x0 + 8 < L.xr) frags_x(f[0], Hp, xh, xl, m0, n0, x0 + 8, gq, tq, L.sh, L.sx);
        mma3(acc, f[1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + 2 * tq, cx = n >> 1;
          if (cx >= L.mx2) continue;
          // the mirror column: x -> -x; column -mx has none among the modes
          const int cm = cx == 0 ? 0 : L.mx2 - cx;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int y = m0 + 16 * i + gq + 8 * h;
            if (y >= my) continue;
            const float re = acc[i][j][2 * h], im = acc[i][j][2 * h + 1];
            *reinterpret_cast<float2*>(gp + (long long)y * 2 * L.mx2 + n) =
                make_float2(re, im);
            if (y > 0 && cx != mx)
              *reinterpret_cast<float2*>(gp + (long long)(L.my2 - y) * 2 * L.mx2 +
                                         2 * cm) = make_float2(re, -im);
          }
        }
    }
    // on the CUDA cores, a warp a plane and 32 outputs, lanes over outputs:
    // row -my, g[my][cx] = sum_x H[x][-my] Fx[x][cx], and, for the rows -y,
    // y = 1..my-1, column mx: conj g[y][+mx] = conj sum_x H[x][y] Fx[x][+mx]
    const int nrow = (L.mx2 + 31) / 32, ncolx = (my + 30) / 32;
    for (int t = warp; t < L.pp * (nrow + ncolx); t += FWARPS) {
      const int q = t / (nrow + ncolx), k = t - q * (nrow + ncolx);
      const long long p = grp * L.pp + q;
      if (p >= B) continue;
      const float* Hp = H + q * hsz;
      float* gp = g + p * plane_g;
      float re = 0.f, im = 0.f, re2 = 0.f, im2 = 0.f;
      if (k < nrow) {
        const int cx = 32 * k + lane;
        if (cx >= L.mx2) continue;
        const int cr = perm32(2 * cx), ci = perm32(2 * cx + 1);
        for (int x = 0; x < L.nx; ++x) {
          const float2 h = *reinterpret_cast<const float2*>(Hp + x * L.sh + L.n1);
          const float* a = xh + x * L.sx;
          const float* b = xl + x * L.sx;
          const float fr = a[cr] + b[cr], fi = a[ci] + b[ci];
          re = fmaf(h.x, fr, re);
          im = fmaf(h.x, fi, im);
          re2 = fmaf(-h.y, fi, re2);
          im2 = fmaf(h.y, fr, im2);
        }
        re += re2;
        im += im2;
        *reinterpret_cast<float2*>(gp + (long long)my * 2 * L.mx2 + 2 * cx) =
            make_float2(re, im);
      } else {
        const int y = 1 + 32 * (k - nrow) + lane;
        if (y >= my) continue;
        for (int x = 0; x < L.nx; ++x) {
          const float2 h = *reinterpret_cast<const float2*>(Hp + x * L.sh + 2 * y);
          const float2 f = reinterpret_cast<const float2*>(fxp)[x];
          re = fmaf(h.x, f.x, re);
          im = fmaf(h.x, f.y, im);
          re2 = fmaf(-h.y, f.y, re2);
          im2 = fmaf(h.y, f.x, im2);
        }
        re += re2;
        im += im2;
        *reinterpret_cast<float2*>(gp + (long long)(L.my2 - y) * 2 * L.mx2 + 2 * mx) =
            make_float2(re, -im);
      }
    }
    __syncthreads();  // H and this group's buffer are free again
  }
}

// The fused inverse kernel's shared-memory layout, in floats; the host
// computes it (spectral_conv.py::fused_inverse_layout).
struct InvLayout {
  int nx, ny, my2, mx2;
  int pp;   // planes a block takes at once
  int r1;   // pp * my folded rows (my = my2 / 2) padded to 32: rows of Q
  int kr;   // mx2 padded to 4: rows of GxT (the x-contraction is 2 kr deep)
  int n1;   // 2 nx padded to 32: columns of Q (re/im interleaved)
  int m2;   // nx padded to 32: rows of a plane in the y-contraction
  int k2;   // 2 my padded to 8: depth of the y-contraction
  int n2;   // ny padded to 32: columns of out
  int sg, sx, sq, sy;  // row strides of the folded modes, GxT, Q^T, B3 (4, 8, 4, 8 mod 32)
  int gsz;  // floats of the region the folded modes and then Q^T take
};

// g (B, my2, mx2) c64 -> out (B, nx, ny) f32 = scale Re(Gx g^T Gy^T), through
// GxT (mx2, nx) and GyT (my2, ny), both c64 read as interleaved floats.
// Only the real part is kept, and Gx[x, -x'] = conj Gx[x, x'], Gy likewise,
// so a mode and its mirror give Re(a g) + Re(conj(a) g') = Re(a (g + conj
// g')): the planes are folded as they are read, and the tensor cores take
// the my rows y' = 0..my-1 of
//   gf[y'][x'] = g[y'][x'] + conj g[-y'][-x']   (y' >= 1, x' != -mx),
//   gf[0][x']  = (g[0][x'] + conj g[0][-x']) / 2 (x' != -mx; x' = 0 is its
//                own mirror),
//   gf[y'][-mx] = g[y'][-mx]                    (no mirror among the modes).
// The rest are sums on the CUDA cores: the mirrors of column -mx,
// conj g[-y'][-mx] times Gx[., +mx] = conj Gx[., -mx], added to Q row y';
// and row -my, whose mirror is not a mode, through its own Q row qm.
//   x-contraction: Q (pp my x 2nx) = gf @ B2 (complex, in real form: b_cplx);
//   y-contraction: out[x][y] = scale (sum_k Q^T[x][k] B3[k][y] + Re(qm[x]
//     Gy[y][-my])), B3[2y' + c][y] = (c ? -Im : Re) GyT[y'][y].
__global__ void __launch_bounds__(FT, 1) inverse_fused_kernel(
    const float* __restrict__ g, const float* __restrict__ GxT,
    const float* __restrict__ GyT, float* __restrict__ out, long long B,
    float scale, const InvLayout L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int my = L.my2 / 2, mx = L.mx2 / 2;
  const int rawp = 2 * L.my2 * L.mx2;  // floats of one plane of g
  float* raw = smem;                   // pp planes as they come (cp.async)
  float* G = raw + L.pp * rawp;        // folded modes (r1 x sg), then Q^T (pp x m2 x sq)
  float* xh = G + L.gsz;               // GxT parts (kr x sx)
  float* xl = xh + L.kr * L.sx;
  float* yh = xl + L.kr * L.sx;        // B3 parts (k2 x sy)
  float* yl = yh + L.k2 * L.sy;
  float2* qm = reinterpret_cast<float2*>(yl + L.k2 * L.sy);  // pp x nx: row -my's Q
  float2* gm = qm + L.pp * L.nx;       // pp x my: conj g[-y'][-mx]
  float2* gxm = gm + L.pp * my;        // nx: conj Gx[x][-mx]
  float2* gym = gxm + L.nx;            // ny: Gy[y][-my]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const long long groups = (B + L.pp - 1) / L.pp;
  long long grp = blockIdx.x;
  auto load_group = [&](long long gi) {
    for (int q = 0; q < L.pp && gi * L.pp + q < B; ++q) {
      const float* src = g + (gi * L.pp + q) * rawp;
      for (int i = 4 * threadIdx.x; i < rawp; i += 4 * FT)
        cp_async16(raw + q * rawp + i, src + i);
    }
    cp_async_commit();
  };
  if (grp < groups) load_group(grp);
  load_split(xh, xl, GxT, L.mx2, 2 * L.nx, 2 * L.nx, L.kr, L.n1, L.sx);
  for (int i = threadIdx.x; i < L.k2 * L.sy; i += FT) {
    const int k = i / L.sy, y = i - k * L.sy;
    const float x = (k < 2 * my && y < L.ny)
                        ? ((k & 1) ? -1.f : 1.f) * GyT[(k >> 1) * 2 * L.ny + 2 * y + (k & 1)]
                        : 0.f;
    uint32_t h, l;
    split(x, h, l);
    const int at = k * L.sy + (y < L.n2 ? perm32(y) : y);
    yh[at] = __uint_as_float(h);
    yl[at] = __uint_as_float(l);
  }
  const float2* gx2 = reinterpret_cast<const float2*>(GxT);
  const float2* gy2 = reinterpret_cast<const float2*>(GyT);
  for (int x = threadIdx.x; x < L.nx; x += FT) {
    const float2 a = gx2[mx * L.nx + x];
    gxm[x] = make_float2(a.x, -a.y);
  }
  for (int y = threadIdx.x; y < L.ny; y += FT) gym[y] = gy2[my * L.ny + y];

  const int ncol1 = L.n1 / 32, units1 = (L.r1 / 32) * ncol1;
  const int ncol2 = L.n2 / 32, per2 = (L.m2 / 32) * ncol2, units2 = L.pp * per2;
  const int qsz = L.m2 * L.sq;
  for (; grp < groups; grp += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // this group's planes are in; the last group's Q^T is read

    // fold the modes into G (rows q my + y', pp my of them, then zeros)
    for (int i = threadIdx.x; i < L.r1 * L.kr; i += FT) {
      const int r = i / L.kr, kx = i - r * L.kr;
      const int q = r / my, ky = r - q * my;
      float2 v = make_float2(0.f, 0.f);
      if (q < L.pp && kx < L.mx2 && grp * L.pp + q < B) {
        const float2* pl = reinterpret_cast<const float2*>(raw + q * rawp);
        const float2 a = pl[ky * L.mx2 + kx];
        const float2 b = pl[(ky == 0 ? 0 : L.my2 - ky) * L.mx2 +
                            (kx == mx ? mx : (kx == 0 ? 0 : L.mx2 - kx))];
        if (kx == mx) {
          v = a;
          gm[q * my + ky] = make_float2(b.x, -b.y);  // read for y' >= 1 only
        } else {
          v = make_float2(a.x + b.x, a.y - b.y);
          if (ky == 0) v = make_float2(0.5f * v.x, 0.5f * v.y);
        }
      }
      *reinterpret_cast<float2*>(G + r * L.sg + 2 * kx) = v;
    }
    // row -my's Q on the CUDA cores, qm[q][x] = sum_x' g[-my][x'] GxT[x'][x]:
    // two neighbouring threads an output, each over every other x', then one
    // shuffle (whole warps go round the loop, so every lane takes it)
    const int pairs = 2 * L.pp * L.nx, span = (pairs + 31) & ~31;
    for (int i0 = threadIdx.x & ~1; i0 < span; i0 += FT) {
      const int i = i0 >> 1, q = i / L.nx, x = i - q * L.nx;
      float re = 0.f, im = 0.f, re2 = 0.f, im2 = 0.f;
      if (i0 < pairs) {
        const float2* row = reinterpret_cast<const float2*>(raw + q * rawp) + my * L.mx2;
        for (int kx = lane & 1; kx < L.mx2; kx += 2) {
          const float2 a = row[kx], f = __ldg(gx2 + kx * L.nx + x);
          re = fmaf(a.x, f.x, re);
          im = fmaf(a.x, f.y, im);
          re2 = fmaf(-a.y, f.y, re2);
          im2 = fmaf(a.y, f.x, im2);
        }
      }
      re += re2;
      im += im2;
      re += __shfl_xor_sync(0xffffffffu, re, 1);
      im += __shfl_xor_sync(0xffffffffu, im, 1);
      if (i0 < pairs && (lane & 1) == 0) qm[i] = make_float2(re, im);
    }
    __syncthreads();  // G, gm, qm are ready; the planes are read
    if (grp + gridDim.x < groups) load_group(grp + gridDim.x);

    // x-contraction: each warp at most one 32 x 32 tile of Q (the host sees
    // to it), held in registers while Q^T overwrites the folded modes
    float acc[2][4][4] = {};
    const bool mine = warp < units1;
    const int m0 = (warp / ncol1) * 32, n0 = (warp % ncol1) * 32;
    if (mine)
      tile_product(acc, L.kr / 4, [&](Frags& f, int s) {
        frags_xi(f, G, xh, xl, m0, n0, 4 * s, gq, tq, L.sg, L.sx);
      });
    __syncthreads();  // every read of the folded modes is done
    if (mine) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + 16 * i + gq + 8 * h, n = n0 + 8 * j + 2 * tq;
            if (r >= L.pp * my || n >= 2 * L.nx) continue;
            const int q = r / my, ky = r - q * my, x = n >> 1;
            float re = acc[i][j][2 * h], im = acc[i][j][2 * h + 1];
            if (ky > 0) {  // the mirror of g[y'][-mx]: conj g[-y'][-mx] Gx[x][+mx]
              const float2 a = gm[q * my + ky], b = gxm[x];
              re = fmaf(a.x, b.x, fmaf(-a.y, b.y, re));
              im = fmaf(a.x, b.y, fmaf(a.y, b.x, im));
            }
            *reinterpret_cast<float2*>(G + q * qsz + x * L.sq + 2 * ky) =
                make_float2(re, im);
          }
    }
    if (L.k2 > 2 * my)  // the y-contraction's depth padding must read zeros
      for (int i = threadIdx.x; i < L.pp * L.m2 * (L.k2 - 2 * my); i += FT) {
        const int row = i / (L.k2 - 2 * my), k = i - row * (L.k2 - 2 * my);
        G[row * L.sq + 2 * my + k] = 0.f;
      }
    __syncthreads();  // Q^T is ready

    // y-contraction, a plane at a time: out (m2 x n2) = Q^T (m2 x k2) @ B3
    for (int u = warp; u < units2; u += FWARPS) {
      const int q = u / per2, w = u - q * per2;
      const long long p = grp * L.pp + q;
      if (p >= B) continue;
      const int mt = (w / ncol2) * 32, nt = (w % ncol2) * 32;
      const float* Qp = G + q * qsz;
      float acc2[2][4][4] = {};
      tile_product(acc2, L.k2 / 8, [&](Frags& f, int s) {
        frags_y(f, Qp, yh, yl, mt, nt, 8 * s, gq, tq, L.sq, L.sy);
      });
      float* op = out + p * (long long)L.nx * L.ny;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = mt + 16 * i + gq + 8 * h;
          if (x >= L.nx) continue;
          const float2 a = qm[q * L.nx + x];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int y = nt + 8 * j + 2 * tq;
            if (y >= L.ny) continue;
            const float2 b0 = gym[y], b1 = gym[y + 1];
            const float v0 = fmaf(a.x, b0.x, fmaf(-a.y, b0.y, acc2[i][j][2 * h]));
            const float v1 = fmaf(a.x, b1.x, fmaf(-a.y, b1.y, acc2[i][j][2 * h + 1]));
            *reinterpret_cast<float2*>(op + x * L.ny + y) =
                make_float2(scale * v0, scale * v1);
          }
        }
    }
  }
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

// The fused dft2d_modes: v (B, nx, ny) f32 -> g (B, my2, mx2) c64, with the
// layout from the host (15 ints, as struct Layout) and `smem_bytes` of
// dynamic shared memory. Rows of v must be 16-byte aligned (ny % 4 == 0 and
// a 16-byte aligned v). One persistent block an SM, or as many as fit.
int dft2d_modes_fused(const void* v, const void* FyT, const void* FxT, void* g,
                      long long B, const int* layout, int smem_bytes,
                      void* stream) {
  if (B == 0) return 0;
  Layout L;
  memcpy(&L, layout, sizeof(Layout));
  // the attribute holds for the current device only (the wrapper makes it
  // the tensors'), so it is set at each launch
  cudaError_t e = cudaFuncSetAttribute(
      modes_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, modes_fused_kernel,
                                                    FT, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (B + L.pp - 1) / L.pp;
  const long long blocks =
      groups < (long long)sms * per_sm ? groups : (long long)sms * per_sm;
  modes_fused_kernel<<<(unsigned)blocks, FT, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)FyT, (const float*)FxT, (float*)g, B, L);
  return (int)cudaGetLastError();
}

// The fused dft2d_inverse: g (B, my2, mx2) c64 -> out (B, nx, ny) f32, with
// the layout from the host (16 ints, as struct InvLayout) and `smem_bytes` of
// dynamic shared memory. g must be 16-byte aligned. One persistent block an
// SM, or as many as fit.
int dft2d_inverse_fused(const void* g, const void* GxT, const void* GyT, void* out,
                        long long B, float scale, const int* layout, int smem_bytes,
                        void* stream) {
  if (B == 0) return 0;
  InvLayout L;
  memcpy(&L, layout, sizeof(InvLayout));
  cudaError_t e = cudaFuncSetAttribute(
      inverse_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inverse_fused_kernel,
                                                    FT, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (B + L.pp - 1) / L.pp;
  const long long blocks =
      groups < (long long)sms * per_sm ? groups : (long long)sms * per_sm;
  inverse_fused_kernel<<<(unsigned)blocks, FT, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)GxT, (const float*)GyT, (float*)out, B, scale, L);
  return (int)cudaGetLastError();
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
