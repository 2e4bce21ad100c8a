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
//      first-axis inverse transforms of the four fields' columns, as radix
//      FFTs in shared memory.
//   K2 spectral_advect: TX physical rows a block: the inverse last-axis
//      transforms of the four fields, the advection product
//      -(u dw/dx + v dw/dy) and the forward last-axis transform, as radix
//      FFTs in shared memory. The physical fields never reach device
//      memory.
//   K3 spectral_forward_first: the forward first-axis transforms of T's
//      columns, as radix FFTs in shared memory, their R kept outputs taken
//      into the dealias filter, the constant forcing, h = e + beta_k h and
//      the per-mode Crank-Nicolson update, in place on the state.
//
// Arithmetic is fp32 on the CUDA cores throughout (FFMA), for every
// precision mode, so all three modes compute at least the accuracy that
// "highest" asks for.
//
// K1, K2 and K3 are radix FFTs, all three bound by bytes. n/16 threads hold
// an n-point transform, 16 points each, and run Stockham passes of radix 16
// (the last of radix 2, 4, 8 or 16) in registers with one exchange through
// shared memory between passes (one float2 of padding every 16, so no bank
// conflicts). The twiddles come from a host table (float64 rounded to
// float32); n is a power of two from 16 to 2048, and the host picks each
// kernel's blocks from the shape (spectral_step.py::inverse_layout,
// advect_layout, forward_layout).
//
// K1 takes the first axis: column c of field f is the n-point inverse
// transform of i c_f w[:, c], its R kept rows put at their wavenumbers' slots
// (rows 0..R/2-1 at slots 0..R/2-1, the rest at n-R/2..n-1 on the Galerkin
// block; the identity on the aligned layout) and zeros elsewhere, 1/n
// normalised as the dense matrix G is. That is 4 m complex FFTs a sample,
// 5 n log2 n flops each: at 256^2 Galerkin (R=170, m=86), b=32, 0.11 GFLOP a
// launch against 3.7 MB of w read and 22.5 MB of A written, so K1 is bound by
// bytes (7.9 us at 3.35 TB/s). A block takes a tile of consecutive columns of
// one sample and all four fields or one: it stages w's tile and the
// multipliers with loads coalesced along c, forms i c_f w as each thread
// reads its points, transforms, and stages the outputs point-major so that
// A's rows are written along c.
//
// K3 mirrors K1: column c of T[s] is the unnormalised n-point forward
// transform, as the dense matrix F is, and slot p of it is kept row r by the
// same slot map. That is m complex FFTs a sample: at 256^2 Galerkin, b=32,
// 0.028 GFLOP a launch against 5.6 MB of T read and 15 MB of h and w read
// and written (6.2 us at 3.35 TB/s). A block takes a tile of consecutive
// columns of one sample: it stages T's tile with loads coalesced along c,
// puts h's and w's tiles in flight beside it, transforms, keeps the R rows
// point-major, and every thread walks the (r, c) tile, c fastest, for the
// Crank-Nicolson update.
//
// K2 does by the FFT rule what a dense product would do in n^2 m: u and v
// of a physical row go into one complex row z1 = u + i v, dw/dx and dw/dy
// into z2, so that a row takes two complex inverse transforms and the
// product is -(Re z1 Re z2 + Im z1 Im z2); rows x and x + 1 share one
// forward transform of adv_x + i adv_{x+1}. That is 2.5 complex n-point
// FFTs a row: at 256^2, b=32, 0.21 GFLOP a launch against 28 MB of A read
// and T written once (8.4 us at 3.35 TB/s). A block loads its rows of A
// straight into the Hermitian-extended rows in shared memory (zeros
// elsewhere), runs the inverse passes, takes the product in registers, runs
// the forward passes and writes the m kept bins of T.
//
// Plain C interface: every pointer and the stream are void*, and each
// entry point returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int AXIS0_THREADS = 512;  // the most threads a K1 or K3 block
constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may have
constexpr int K2_THREADS = 256;  // the most threads a K2 block

// cp.async of 4 or 8 bytes; zeros where !ok (nothing is read then)
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The radix passes of K1, K2 and K3. rot16 turns a by e sixteenths of a turn, clockwise for
// the forward transform and counterclockwise for the inverse (e in 0..7);
// e is known once the loops are unrolled, so its branches fold.
constexpr float K2_C1 = 0.923879532511286756f;  // cos(pi/8)
constexpr float K2_S1 = 0.382683432365089772f;  // sin(pi/8)
constexpr float K2_H = 0.707106781186547524f;   // cos(pi/4)

__device__ __forceinline__ float2 rot16(float2 a, int e, bool inv) {
  if (e == 0) return a;
  if (e == 4) return inv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  const float c = e == 1 ? K2_C1 : e == 2 ? K2_H : e == 3 ? K2_S1 : e == 5 ? -K2_S1
                : e == 6 ? -K2_H : -K2_C1;
  const float s0 = e == 1 ? K2_S1 : e == 2 ? K2_H : e == 3 ? K2_C1 : e == 5 ? K2_C1
                 : e == 6 ? K2_H : K2_S1;
  const float s = inv ? s0 : -s0;
  return make_float2(fmaf(a.x, c, -a.y * s), fmaf(a.x, s, a.y * c));
}

__host__ __device__ constexpr int bitrev(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

// the radix-2 stages of an R-point DFT in registers, decimation in frequency,
// from butterflies HALF apart down to neighbours (a stage a template
// instance, so every index is a constant and u stays in registers)
template <int R, bool INV, int HALF>
__device__ __forceinline__ void dif_stages(float2 (&u)[R]) {
#pragma unroll
  for (int b0 = 0; b0 < R; b0 += 2 * HALF)
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float2 a = u[b0 + i], b = u[b0 + i + HALF];
      u[b0 + i] = make_float2(a.x + b.x, a.y + b.y);
      u[b0 + i + HALF] = rot16(make_float2(a.x - b.x, a.y - b.y), i * (8 / HALF), INV);
    }
  if constexpr (HALF > 1) dif_stages<R, INV, HALF / 2>(u);
}

// an R-point DFT (R = 2, 4, 8 or 16) of u in registers, its bit-reversed
// order undone by renaming registers
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  dif_stages<R, INV, R / 2>(u);
  constexpr int BITS = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  float2 o[R];
#pragma unroll
  for (int k = 0; k < R; ++k) o[k] = u[bitrev(k, BITS)];
#pragma unroll
  for (int k = 0; k < R; ++k) u[k] = o[k];
}

// An n-point transform, n = 2^LOG2N: G threads hold a row, 16 points each, and
// it takes PASSES passes, of radix 16 but the last (LAST: 2, 4, 8 or 16). A row
// in shared memory takes NP float2, one of padding after every 16 (NP = 17 G,
// which is G modulo 16, so that rows side by side sharing a half-warp fall on
// distinct banks, as K1's do); K2's physical row, two rows, takes RS, which
// for rows of fewer than 256 points is G modulo 16 too.
template <int LOG2N>
struct Fft {
  static constexpr int N = 1 << LOG2N, G = N / 16;
  static constexpr int PASSES = (LOG2N + 3) / 4;
  static constexpr int LAST = 1 << (LOG2N - 4 * (PASSES - 1));
  static constexpr int NP = N + N / 16;
  static constexpr int RS = G >= 16 ? 2 * NP : 2 * NP + ((G - 2 * NP) % 16 + 16) % 16;
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// where the twiddles of pass p >= 1 start in the table (spectral_step.py
// _twiddles): (R - 1) x NS entries a pass, NS = 16^p
__host__ __device__ constexpr int tw_offset(int p) {
  int o = 0, ns = 16;
  for (int i = 1; i < p; ++i, ns *= 16) o += 15 * ns;
  return o;
}

// Pass P of NV transforms, and the passes after it (Stockham, decimation in
// time). v[i][k] holds point t + G k of transform i as the pass reads it.
// Butterfly j = t + G q (q < 16 / R) takes points j + r N / R, which are
// v[i][q + (16 / R) r], twiddles them by the table (conjugated for the
// inverse) and puts its outputs back in the same registers. A pass before the
// last sends output r of butterfly j to point (j / NS) NS R + j % NS + r NS
// of buf[i] and reads the next pass's points from there; after the last,
// v[i][k] holds output point t + G k. Threads with !act compute nothing but
// meet every barrier.
template <int LOG2N, bool INV, int NV, int P = 0>
__device__ __forceinline__ void fft_passes(float2 (&v)[NV][16], float2* const (&buf)[NV],
                                           int t, const float2* __restrict__ tw, bool act) {
  using F = Fft<LOG2N>;
  constexpr int R = P < F::PASSES - 1 ? 16 : F::LAST, BF = 16 / R, NS = 1 << (4 * P);
  if (act) {
#pragma unroll
    for (int q = 0; q < BF; ++q) {
      float2 w[R];
      if constexpr (NS > 1) {
        const float2* tp = tw + tw_offset(P) + ((t + F::G * q) & (NS - 1));
#pragma unroll
        for (int r = 1; r < R; ++r) w[r] = __ldg(tp + (r - 1) * NS);
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float2 u[R];
#pragma unroll
        for (int r = 0; r < R; ++r) u[r] = v[i][q + BF * r];
        if constexpr (NS > 1) {
#pragma unroll
          for (int r = 1; r < R; ++r) {
            const float2 a = u[r];
            const float wx = w[r].x, wy = INV ? -w[r].y : w[r].y;
            u[r] = make_float2(fmaf(a.x, wx, -a.y * wy), fmaf(a.x, wy, a.y * wx));
          }
        }
        dft<R, INV>(u);
#pragma unroll
        for (int r = 0; r < R; ++r) v[i][q + BF * r] = u[r];
      }
    }
  }
  if constexpr (P < F::PASSES - 1) {
    const int base = (t / NS) * NS * 16 + t % NS;
    __syncthreads();  // every thread has read its points of this pass
    if (act) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int r = 0; r < 16; ++r) buf[i][pad(base + r * NS)] = v[i][r];
    }
    __syncthreads();
    if (act) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < 16; ++k) v[i][k] = buf[i][pad(t + F::G * k)];
    }
    fft_passes<LOG2N, INV, NV, P + 1>(v, buf, t, tw, act);
  }
}

// The slot map of K1 and K3: slot p of an n-point first-axis transform
// holds kept row p below R/2 and row p - (n - R) from n - R/2 up (the
// Galerkin block's signed modes; every slot its own row where R = n), and no
// kept row in the gap between (-1).
__device__ __forceinline__ int kept_row(int p, int n, int R) {
  const int h = R / 2;
  return p < h ? p : p >= n - h ? p - (n - R) : -1;
}

// K1's tiles in shared memory, for tc columns at n = 16 g points (the
// launcher sizes a block's shared memory from them). The staged rows are
// tcp = tc | 1 apart, an odd number, so that a transform's consecutive
// points fall on distinct banks. The multipliers' planes are cfs floats
// apart and the outputs' fs float2, so that where a half-warp (a warp, for
// the multipliers) holds several fields of one column, field q + 1 continues
// field q's points on the banks.
__host__ __device__ constexpr int k1_cf_stride(int g, int R, int tcp) {
  return R * tcp + ((g * tcp - R * tcp) % 32 + 32) % 32;
}
__host__ __device__ constexpr int k1_out_stride(int g, int n, int tcp) {
  return n * tcp + g * tcp % 16;
}
// bytes of the largest of the three phases a K1 block keeps in shared memory
__host__ __device__ constexpr size_t k1_smem(int log2n, int R, int tc, int fb) {
  const int n = 1 << log2n, g = n / 16, tcp = tc | 1;
  const size_t staged = 8 * (size_t)R * tcp + 4 * (size_t)fb * k1_cf_stride(g, R, tcp);
  const size_t rows = 8 * (size_t)tc * fb * (n + g);
  const size_t out = 8 * (size_t)fb * k1_out_stride(g, n, tcp);
  return staged > rows ? (staged > out ? staged : out) : (rows > out ? rows : out);
}

// K1: A[s, f, x, c] = (1/n) sum_p e^{2 pi i p x / n} Z[p] for c < m, the
// inverse first-axis transform of column c of field f, where Z[p] =
// i cf[f, r, c] w[s, r, c] at the slot p of kept row r (kept_row) and zero
// at the other slots. A block takes tc consecutive columns c0.. of sample s
// and fb fields f0.. (fb = 1 or 4): tc fb transforms, transform
// i = col fb + fl, G threads each. Its shared
// memory holds in turn (1) w's tile and the fields' multipliers, staged by
// loads coalesced along c; (2) the transforms' exchange rows, NP float2 at
// i NP; (3) the outputs, point-major, read back for stores along c.
template <int LOG2N>
__global__ void __launch_bounds__(AXIS0_THREADS) inverse_fft_kernel(
    const float2* __restrict__ w, const float* __restrict__ cf,
    const float2* __restrict__ tw, float2* __restrict__ A, int R, int m, int tc,
    int fb) {
  using F = Fft<LOG2N>;
  constexpr int N = F::N, G = F::G;
  extern __shared__ float4 smem4[];
  float2* const sm = reinterpret_cast<float2*>(smem4);
  const int tcp = tc | 1, cfs = k1_cf_stride(G, R, tcp), fs = k1_out_stride(G, N, tcp);
  const int tid = threadIdx.x;
  const int t = tid % G, i = tid / G, col = i / fb, fl = i - col * fb;
  const int f0 = blockIdx.x * fb, c0 = blockIdx.y * tc, s = blockIdx.z;
  // the staging loops' rows: thread tid takes column cc of rows tid / tc + j fb G
  const int cc = tid % tc, r0 = tid / tc, rstep = fb * G;
  const bool live = cc < m - c0;

  // (1) w[s, :, c0 : c0 + tc] and the multipliers cf[f0 : f0 + fb, :, c0 :
  // c0 + tc], zeros past column m, all in flight at once by cp.async
  float2* const ws = sm;                                     // [R][tcp]
  float* const cs = reinterpret_cast<float*>(sm + R * tcp);  // [fb][cfs]
  {
    const float2* const wg = w + (size_t)s * R * m + c0 + cc;
    const float* const cg = cf + (size_t)f0 * R * m + c0 + cc;
    for (int r = r0; r < R; r += rstep) {
      const int o = r * tcp + cc;
      cp_async8(ws + o, live ? wg + (size_t)r * m : w, live);
      for (int q = 0; q < fb; ++q)
        cp_async4(cs + q * cfs + o, live ? cg + (size_t)(q * R + r) * m : cf, live);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // this thread's points p = t + G k of transform (col, fl): i cf w / n at
  // the kept slots (1/n is a power of two, so the scaling is exact)
  float2 v[1][16];
  {
    const float2* const wc = ws + col;
    const float* const ca = cs + fl * cfs + col;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int r = kept_row(t + G * k, N, R);
      v[0][k] = make_float2(0.f, 0.f);
      if (r >= 0) {
        const float2 z = wc[r * tcp];
        const float a = ca[r * tcp] * (1.f / N);
        v[0][k] = make_float2(-a * z.y, a * z.x);
      }
    }
  }
  float2* const bufs[1] = {sm + i * F::NP};
  fft_passes<LOG2N, true, 1>(v, bufs, t, tw, true);

  // (3) the outputs point-major, then A's rows, tc columns each
  __syncthreads();  // every thread has read its points of the last pass
  float2* const os = sm;  // [fb][fs]
#pragma unroll
  for (int k = 0; k < 16; ++k) os[fl * fs + (t + G * k) * tcp + col] = v[0][k];
  __syncthreads();
  if (!live) return;
  // rows q N + x of fields f0 + q, fb N / rstep = 16 a thread
  float2* const dst = A + (size_t)(s * 4 + f0) * N * m + c0 + cc;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int row = r0 + j * rstep;
    dst[(size_t)row * m] = os[(row >> LOG2N) * fs + (row & (N - 1)) * tcp + cc];
  }
}

// K2: T[s, x, c] = sum_j adv[s, x, j] e^{-2 pi i c j / n} for c < m, where
// adv = -(u gx + v gy) and each field is the inverse real transform of its
// row A_f[s, x, :m] (1/n normalised, bin 0's imaginary part ignored, bins m
// to n/2 zero). Rows of the flattened (sample, x) index, `rows` = b n of
// them, blockDim.x / G a block (an even number, so a pair x, x + 1 never
// straddles a sample); row g of a block works in the RS float2 at g RS.
// A complex row pairs fields of like size, u with v and gx with gy: gx is
// up to ~(n/3)^2 times u at the highest modes, and a row's rounding follows
// its larger part, so z = u + i gx would lose that factor of u's precision
// (1.3e-4 of T at 256^2, 2e-3 at 1024^2, against 6e-7 paired by size).
template <int LOG2N>
__global__ void __launch_bounds__(K2_THREADS, 2) advect_fft_kernel(
    const float2* __restrict__ A, const float2* __restrict__ tw, float2* __restrict__ T,
    int rows, int m) {
  using F = Fft<LOG2N>;
  constexpr int N = F::N, G = F::G;
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x % G, g = threadIdx.x / G;
  const int row = blockIdx.x * (blockDim.x / G) + g;
  const bool live = row < rows, even = (g & 1) == 0;
  const int s = row >> LOG2N, x = row & (N - 1);
  float2* const z1 = reinterpret_cast<float2*>(smem4) + g * F::RS;  // u + i v
  float2* const z2 = z1 + F::NP;                                     // gx + i gy

  // The spectra of z1 and z2, Hermitian-extended from the m kept bins of
  // (u, v) and (gx, gy): bin c of fields a, b gives Z[c] = a_c + i b_c and
  // Z[n - c] = conj(a_c) + i conj(b_c), bin 0 Re a_0 + i Re b_0; bins m to
  // n - m are zero.
  {
    const size_t fs = (size_t)N * m;  // one field of one sample
    const float2* a = A + ((size_t)s * 4 * N + x) * m;
    float2 f[4][8];  // m <= n / 2 = 8 G
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = t + G * q;
      const bool ok = live && c < m;
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i][q] = ok ? __ldg(a + i * fs + c) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = t + G * q;
      if (c < m) {
        const float2 u = f[0][q], v = f[1][q], gx = f[2][q], gy = f[3][q];
        if (c == 0) {
          z1[0] = make_float2(u.x, v.x);
          z2[0] = make_float2(gx.x, gy.x);
        } else {
          z1[pad(c)] = make_float2(u.x - v.y, u.y + v.x);
          z1[pad(N - c)] = make_float2(u.x + v.y, v.x - u.y);
          z2[pad(c)] = make_float2(gx.x - gy.y, gx.y + gy.x);
          z2[pad(N - c)] = make_float2(gx.x + gy.y, gy.x - gx.y);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int c = t + G * q;
      if (c >= m && c <= N - m) z1[pad(c)] = z2[pad(c)] = make_float2(0.f, 0.f);
    }
  }
  float2* const zs[2] = {z1, z2};
  float2 v[2][16];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 16; ++k) v[i][k] = zs[i][pad(t + G * k)];
  fft_passes<LOG2N, true, 2>(v, zs, t, tw, true);

  // the advection term at points t + G k, each inverse's 1/n applied here
  constexpr float scale = 1.f / ((float)N * (float)N);
  float adv[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    adv[k] = -fmaf(v[1][k].x, v[0][k].x, v[1][k].y * v[0][k].y) * scale;

  // rows x (g even) and x + 1 (g + 1) in one forward transform of
  // y = adv_x + i adv_{x+1}: row g + 1 hands its term over in its own z1
  __syncthreads();
  if (!even) {
    float* const mine = reinterpret_cast<float*>(z1);
#pragma unroll
    for (int k = 0; k < 16; ++k) mine[pad(t + G * k)] = adv[k];
  }
  __syncthreads();
  float2 y[1][16];
#pragma unroll
  for (int k = 0; k < 16; ++k) y[0][k] = make_float2(adv[k], 0.f);
  if (even) {
    const float* other = reinterpret_cast<const float*>(z1 + F::RS);
#pragma unroll
    for (int k = 0; k < 16; ++k) y[0][k].y = other[pad(t + G * k)];
  }
  float2* const ys[1] = {z1};
  fft_passes<LOG2N, false, 1>(y, ys, t, tw, even);
  __syncthreads();
  if (even) {
#pragma unroll
    for (int k = 0; k < 16; ++k) z1[pad(t + G * k)] = y[0][k];
  }
  __syncthreads();

  // T[x, c] = (Y[c] + conj Y[n - c]) / 2, T[x + 1, c] = (Y[c] - conj Y[n - c]) / 2i
  if (!live) return;
  const float2* Y = even ? z1 : z1 - F::RS;
  float2* const out = T + (size_t)row * m;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = t + G * q;
    if (c < m) {
      const float2 a = Y[pad(c)], b = Y[pad((N - c) & (N - 1))];
      out[c] = even ? make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y))
                    : make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
    }
  }
}

// K3's tiles in shared memory, for tc columns at n points: one region holds
// in turn T's staged tile (n rows tcp = tc | 1 apart), the transforms'
// exchange rows (NP float2 a column) and the kept outputs (R rows tcp
// apart); h's and w's tiles (R rows tcp apart each) follow it, in flight
// through the transforms.
__host__ __device__ constexpr int k3_region(int n, int tc) {
  return n * (tc | 1) > tc * (n + n / 16) ? n * (tc | 1) : tc * (n + n / 16);
}
// bytes of shared memory a K3 block keeps
__host__ __device__ constexpr size_t k3_smem(int log2n, int R, int tc) {
  return 8 * ((size_t)k3_region(1 << log2n, tc) + 2 * (size_t)R * (tc | 1));
}

// K3: Z[r, c] = sum_x e^{-2 pi i p x / n} T[s, x, c] at the slot p of kept
// row r (kept_row), e = Z filt + frc, h = e + beta h (h = e at stage 0),
// w = (w + dtg h + mu lin w) dens, in place on h and w. A block takes tc
// consecutive columns c0.. of sample s: tc transforms, transform col G
// threads. Its shared memory holds (1) T's tile, staged by loads coalesced
// along c, zeros past column m, with h's and w's tiles staged after it;
// (2) the exchange rows; (3) the kept outputs, point-major, which every
// thread reads back with h and w for the update along c.
template <int LOG2N>
__global__ void __launch_bounds__(AXIS0_THREADS) forward_fft_kernel(
    const float2* __restrict__ T, const float2* __restrict__ tw,
    const float* __restrict__ filt, const float2* __restrict__ frc,
    const float* __restrict__ lin, const float* __restrict__ dens,
    float2* __restrict__ h, float2* __restrict__ w, int R, int m, int tc, int first,
    float beta, float dtg, float mu) {
  using F = Fft<LOG2N>;
  constexpr int N = F::N, G = F::G;
  extern __shared__ float4 smem4[];
  float2* const sm = reinterpret_cast<float2*>(smem4);
  const int tcp = tc | 1, tid = threadIdx.x;
  const int t = tid % G, col = tid / G;
  const int c0 = blockIdx.x * tc, s = blockIdx.y;
  // the staging and update loops' rows: thread tid takes column cc of rows
  // r0 + j G (threads = tc G, so r0 < G)
  const int cc = tid % tc, r0 = tid / tc;
  const bool live = cc < m - c0;
  float2* const hs = sm + k3_region(N, tc);  // [R][tcp]
  float2* const ws = hs + R * tcp;            // [R][tcp]
  const size_t p0 = (size_t)c0 + cc, o0 = (size_t)s * R * m + p0;

  // (1) T[s, :, c0 : c0 + tc] in one group, h's (past stage 0) and w's
  // tiles in the next, all in flight at once by cp.async
  {
    const float2* const tg = T + (size_t)s * N * m + p0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int x = r0 + j * G;
      cp_async8(sm + x * tcp + cc, live ? tg + (size_t)x * m : T, live);
    }
    cp_async_commit();
    if (live) {
      for (int r = r0; r < R; r += G) {
        if (!first) cp_async8(hs + r * tcp + cc, h + o0 + (size_t)r * m, true);
        cp_async8(ws + r * tcp + cc, w + o0 + (size_t)r * m, true);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
  }
  __syncthreads();

  // (2) this thread's points t + G k of column col, transformed
  float2 v[1][16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[0][k] = sm[(t + G * k) * tcp + col];
  float2* const bufs[1] = {sm + col * F::NP};
  fft_passes<LOG2N, false, 1>(v, bufs, t, tw, true);

  // (3) the kept outputs point-major, row kept_row(p) of slot p
  __syncthreads();  // every thread has read its points of the last pass
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int r = kept_row(t + G * k, N, R);
    if (r >= 0) sm[r * tcp + col] = v[0][k];
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!live) return;

  // (4) the update of rows r0 + j G of column c0 + cc (R <= N = 16 G)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = r0 + j * G;
    if (r < R) {
      const size_t p = p0 + (size_t)r * m, o = o0 + (size_t)r * m;
      const float2 z = sm[r * tcp + cc];
      const float fl = filt[p];
      const float2 fv = frc[p];
      const float2 e = make_float2(z.x * fl + fv.x, z.y * fl + fv.y);
      float2 hv = e;
      if (!first) {
        const float2 ho = hs[r * tcp + cc];
        hv = make_float2(e.x + beta * ho.x, e.y + beta * ho.y);
      }
      h[o] = hv;
      const float2 wv = ws[r * tcp + cc];
      const float li = lin[p], d = dens[p];
      w[o] = make_float2((wv.x + dtg * hv.x + mu * (li * wv.x)) * d,
                         (wv.y + dtg * hv.y + mu * (li * wv.y)) * d);
    }
  }
}

// The attribute holds for the current device only, so it is set at each
// launch, on the device the wrapper made current (the tensors').
int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int LOG2N>
int launch_inverse(const void* w, const void* cf, const void* tw, void* A, int b, int R,
                   int m, int tc, int fb, int threads, cudaStream_t stream) {
  // the host picks the blocks (inverse_layout), the shared memory follows from
  // them; refuse a layout the kernel cannot take or a block cannot hold
  using F = Fft<LOG2N>;
  if ((fb != 1 && fb != 4) || tc < 1 || threads != tc * fb * F::G ||
      threads > AXIS0_THREADS || R < 2 || R % 2 || R > F::N || m < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k1_smem(LOG2N, R, tc, fb);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int e = set_smem((const void*)inverse_fft_kernel<LOG2N>, smem);
  if (e != 0) return e;
  const dim3 grid(4 / fb, (m + tc - 1) / tc, b);
  inverse_fft_kernel<LOG2N><<<grid, threads, smem, stream>>>(
      (const float2*)w, (const float*)cf, (const float2*)tw, (float2*)A, R, m, tc, fb);
  return (int)cudaGetLastError();
}

template <int LOG2N>
int launch_advect(const void* A, const void* tw, void* T, int rows, int m, int threads,
                  int smem, cudaStream_t stream) {
  // the host sizes the layout (advect_layout); refuse one the kernel cannot take
  using F = Fft<LOG2N>;
  const int tx = threads / F::G;
  if (threads > K2_THREADS || threads % F::G || tx % 2 || 2 * m > F::N ||
      smem < tx * F::RS * (int)sizeof(float2))
    return (int)cudaErrorInvalidValue;
  const int e = set_smem((const void*)advect_fft_kernel<LOG2N>, smem);
  if (e != 0) return e;
  advect_fft_kernel<LOG2N><<<(rows + tx - 1) / tx, threads, smem, stream>>>(
      (const float2*)A, (const float2*)tw, (float2*)T, rows, m);
  return (int)cudaGetLastError();
}

template <int LOG2N>
int launch_forward(const void* T, const void* tw, const void* filt, const void* frc,
                   const void* lin, const void* dens, void* h, void* w, int b, int R,
                   int m, int tc, int threads, int first, float beta, float dtg,
                   float mu, cudaStream_t stream) {
  // the host picks the blocks (forward_layout), the shared memory follows from
  // them; refuse a layout the kernel cannot take or a block cannot hold
  using F = Fft<LOG2N>;
  if (tc < 1 || threads != tc * F::G || threads > AXIS0_THREADS || R < 2 || R % 2 ||
      R > F::N || m < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k3_smem(LOG2N, R, tc);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int e = set_smem((const void*)forward_fft_kernel<LOG2N>, smem);
  if (e != 0) return e;
  const dim3 grid((m + tc - 1) / tc, b);
  forward_fft_kernel<LOG2N><<<grid, threads, smem, stream>>>(
      (const float2*)T, (const float2*)tw, (const float*)filt, (const float2*)frc,
      (const float*)lin, (const float*)dens, (float2*)h, (float2*)w, R, m, tc, first,
      beta, dtg, mu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 at n = 2^log2n, 16 <= n <= 2048; the columns and fields a block and
// the threads come from the host (spectral_step.py::inverse_layout).
int spectral_inverse_first(const void* w, const void* cf, const void* tw, void* A, int b,
                           int R, int m, int log2n, int tc, int fb, int threads,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (log2n) {
    case 4: return launch_inverse<4>(w, cf, tw, A, b, R, m, tc, fb, threads, s);
    case 5: return launch_inverse<5>(w, cf, tw, A, b, R, m, tc, fb, threads, s);
    case 6: return launch_inverse<6>(w, cf, tw, A, b, R, m, tc, fb, threads, s);
    case 7: return launch_inverse<7>(w, cf, tw, A, b, R, m, tc, fb, threads, s);
    case 8: return launch_inverse<8>(w, cf, tw, A, b, R, m, tc, fb, threads, s);
    case 9: return launch_inverse<9>(w, cf, tw, A, b, R, m, tc, fb, threads, s);
    case 10: return launch_inverse<10>(w, cf, tw, A, b, R, m, tc, fb, threads, s);
    case 11: return launch_inverse<11>(w, cf, tw, A, b, R, m, tc, fb, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2 at n = 2^log2n, 16 <= n <= 2048; the threads a block and the shared
// memory come from the host (spectral_step.py::advect_layout).
int spectral_advect(const void* A, const void* tw, void* T, int b, int log2n, int m,
                    int threads, int smem, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows = b << log2n;
  switch (log2n) {
    case 4: return launch_advect<4>(A, tw, T, rows, m, threads, smem, s);
    case 5: return launch_advect<5>(A, tw, T, rows, m, threads, smem, s);
    case 6: return launch_advect<6>(A, tw, T, rows, m, threads, smem, s);
    case 7: return launch_advect<7>(A, tw, T, rows, m, threads, smem, s);
    case 8: return launch_advect<8>(A, tw, T, rows, m, threads, smem, s);
    case 9: return launch_advect<9>(A, tw, T, rows, m, threads, smem, s);
    case 10: return launch_advect<10>(A, tw, T, rows, m, threads, smem, s);
    case 11: return launch_advect<11>(A, tw, T, rows, m, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3 at n = 2^log2n, 16 <= n <= 2048; the columns a block and the threads
// come from the host (spectral_step.py::forward_layout).
int spectral_forward_first(const void* T, const void* tw, const void* filt,
                           const void* frc, const void* lin, const void* dens, void* h,
                           void* w, int b, int R, int m, int log2n, int tc, int threads,
                           int first, float beta, float dtg, float mu, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (log2n) {
    case 4:
      return launch_forward<4>(T, tw, filt, frc, lin, dens, h, w, b, R, m, tc, threads,
                               first, beta, dtg, mu, s);
    case 5:
      return launch_forward<5>(T, tw, filt, frc, lin, dens, h, w, b, R, m, tc, threads,
                               first, beta, dtg, mu, s);
    case 6:
      return launch_forward<6>(T, tw, filt, frc, lin, dens, h, w, b, R, m, tc, threads,
                               first, beta, dtg, mu, s);
    case 7:
      return launch_forward<7>(T, tw, filt, frc, lin, dens, h, w, b, R, m, tc, threads,
                               first, beta, dtg, mu, s);
    case 8:
      return launch_forward<8>(T, tw, filt, frc, lin, dens, h, w, b, R, m, tc, threads,
                               first, beta, dtg, mu, s);
    case 9:
      return launch_forward<9>(T, tw, filt, frc, lin, dens, h, w, b, R, m, tc, threads,
                               first, beta, dtg, mu, s);
    case 10:
      return launch_forward<10>(T, tw, filt, frc, lin, dens, h, w, b, R, m, tc, threads,
                                first, beta, dtg, mu, s);
    case 11:
      return launch_forward<11>(T, tw, filt, frc, lin, dens, h, w, b, R, m, tc, threads,
                                first, beta, dtg, mu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
