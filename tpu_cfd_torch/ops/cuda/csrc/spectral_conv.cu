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
// Two-pass route (dft2d_inverse, and dft2d_modes where the fused kernel does
// not fit: a 256^2 fp32 plane alone is more than an SM's 227 KB of shared
// memory, and the model's eval phase runs at 256^2). Each transform is two
// passes of one tiled batched complex GEMM on CUDA cores, one pass per
// contraction, with the intermediate in device memory (L2 when it fits):
//
//   modes:   H = v @ FyT (nx x 2my, real x complex);  g = H^T @ FxT
//   inverse: Q = g @ GxT (2my x nx, complex);          out = scale Re(Q^T @ GyT)
//
// Each pass is C[p] = op(A[p]) @ B for a matrix B shared by every plane:
// 64 x 64 output tiles, 16-deep contraction chunks staged in shared
// memory, 256 threads, each thread a 4 x 4 register tile. Any size works;
// ragged edges are masked. At the recipe dft2d_modes this way takes 0.68 ms
// on an H100, twice cuFFT's time: the FFMA work, and the intermediate
// (210 MB) written and read back.
//
// Fused route (dft2d_modes_fused), where a few planes, their H and both
// transform matrices fit in one SM's shared memory (64^2 at m = 32: two
// planes, 213 KB). Keeping H on chip alone cannot pass cuFFT, since the
// FFMA floor of 20.1 GFLOP is 0.30 ms; the products go to the tensor cores,
// and a real input lets them do half of them. One persistent kernel does
// both contractions of its planes on chip, as the TPU kernel does in VMEM:
//
//   - each block loads FyT and FxT once, split into TF32 hi and lo parts;
//   - it walks groups of pp planes, blockIdx.x, + gridDim.x, ...; the next
//     group comes in by cp.async into the second buffer while one computes;
//   - v is real, so g[-y, -x] = conj g[y, x] and H[x, -y] = conj H[x, y]:
//     the tensor cores compute the modes y = 0..my-1 only (my = my2 / 2),
//     and each row of g is stored with its mirror. Mode y = -my has no
//     mirror among the modes, and the mirrors of column x = -mx need column
//     x = +mx: those are sums on the CUDA cores (4 % of the flops at the
//     recipe);
//   - y-contraction: H (nx x my, re/im interleaved) = v @ view_as_real(FyT's
//     first my columns), one real product for the pp planes stacked, kept
//     in shared memory;
//   - x-contraction: g[y][.] = H[:, y]^T @ FxT, complex, as one real product
//     with a 2nx-deep contraction: A2[y'][2x + c] = H[x][2y' + c] and
//     B2[2x + c][n] = (c ? (n even ? -1 : 1) : 1) FxT_re_im[x][n ^ c], read
//     straight from the interleaved FxT, so g comes out interleaved
//     complex64 (B, 2my, 2mx) and is stored from the accumulators;
//   - both products run on mma.sync.m16n8k8 TF32 with the 3xTF32 split
//     (a_lo b_hi + a_hi b_lo + a_hi b_hi, fp32 accumulation), which keeps
//     fp32 accuracy (plain TF32 keeps three digits): 30 GFLOP of TF32
//     products at the recipe. The bound of the function stays 0.094 ms by
//     bytes.
//
// 8 warps each own 32 x 32 output tiles; pp is the fewest planes that give
// each contraction 8 tiles. Shared-memory strides are padded (row stride
// = 4, 8 or 16 mod 32 words) and the matrices' columns permuted within
// 32-column blocks, so that every fragment load is free of bank conflicts
// and a thread's four B fragments come in one 16-byte load. The layout
// (pp, padded sizes, strides) comes from the host
// (tpu_cfd_torch/ops/cuda/spectral_conv.py::fused_modes_layout), which also
// decides by its byte count whether a shape takes this kernel. mma.sync is
// Hopper's older path to the tensor cores; wgmma, which reaches the dense
// TF32 peak, is the next step for the x-contraction.
//
// Plain C interface: pointers and the stream are void*; each entry point
// returns the first launch error (cudaGetLastError() after each launch).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  // not volatile: the compiler may interleave independent products and
  // move fragment loads across them
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// y-contraction fragments at depth k0: A from V (row stride sv), B from the
// FyT parts (row stride sy, columns permuted by perm32).
__device__ __forceinline__ void frags_y(Frags& f, const float* V, const float* yh,
                                        const float* yl, int m0, int n0, int k0,
                                        int gq, int tq, int sv, int sy) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* a = V + (m0 + 16 * i + gq) * sv + k0 + tq;
    split(a[0], f.ah[i][0], f.al[i][0]);
    split(a[8 * sv], f.ah[i][1], f.al[i][1]);
    split(a[4], f.ah[i][2], f.al[i][2]);
    split(a[8 * sv + 4], f.ah[i][3], f.al[i][3]);
  }
  const int o = (k0 + tq) * sy + n0 + 4 * gq;
  b_quad(f.bh, 0, yh + o, 1.f);
  b_quad(f.bh, 1, yh + o + 4 * sy, 1.f);
  b_quad(f.bl, 0, yl + o, 1.f);
  b_quad(f.bl, 1, yl + o + 4 * sy, 1.f);
}

// x-contraction fragments at depth 2 x0: A2[y][2x + c] = H[x][2y + c] and
// B2[2x + c][n] = sgn Fx[x][n ^ c], c = tq & 1, sgn = -1 on the imaginary
// row (c = 1) of a real column (n even).
__device__ __forceinline__ void frags_x(Frags& f, const float* H, const float* xh,
                                        const float* xl, int m0, int n0, int x0,
                                        int gq, int tq, int sh, int sx) {
  const int c = tq & 1;
  const float sgn = (c == 1 && (gq & 1) == 0) ? -1.f : 1.f;
  const float* hr = H + (x0 + (tq >> 1)) * sh + c;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* a = hr + 2 * (m0 + 16 * i + gq);
    split(a[0], f.ah[i][0], f.al[i][0]);
    split(a[16], f.ah[i][1], f.al[i][1]);        // row + 8: column + 16
    split(a[2 * sh], f.ah[i][2], f.al[i][2]);    // k + 4: x + 2
    split(a[2 * sh + 16], f.ah[i][3], f.al[i][3]);
  }
  const int o = (x0 + (tq >> 1)) * sx + n0 + 4 * (gq ^ c);
  b_quad(f.bh, 0, xh + o, sgn);
  b_quad(f.bh, 1, xh + o + 2 * sx, sgn);
  b_quad(f.bl, 0, xl + o, sgn);
  b_quad(f.bl, 1, xl + o + 2 * sx, sgn);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
  cudaError_t e = cudaFuncSetAttribute(
      modes_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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
