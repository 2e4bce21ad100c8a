// The pseudo-spectral IMEX-2 step's pointwise passes around the cuFFT pair,
// for Hopper (sm_90a): an explicit evaluation's four spectra (velocity and
// vorticity gradient), its advection product, its dealiasing and forcing,
// and the RK2 Crank-Nicolson stage update, each one launch over a batch of
// rfft2 half-spectra (..., n0, m) or physical planes (..., n0, n1).
//
// Replaces no TPU kernel. The JAX package writes this chain
// (tpu_cfd/solvers/equations.py, NavierStokes2DSpectral._explicit_terms and
// IMEXStepper._rk2_crank_nicolson) as array code that XLA fuses; eager
// PyTorch runs it as about 85 kernels an IMEX-2 step (products, sums,
// negations, divisions, the four spectra's stack), 45 of them full passes
// over the batch. The transforms between the passes stay on cuFFT.
//
// What each launch computes, for every mode (or point) of every sample, as
// tpu_cfd_torch/solvers/equations.py computes it on the composed path:
//   spectra       psi = -w / lap (lap the Laplacian symbol, 1 at the zero
//                 mode), then out = [dy psi, -(dx psi), dx w, dy w] with
//                 dx = 2 pi i kx and dy = 2 pi i ky, one (4, b, n0, m) buffer
//                 in place of torch.stack;
//   advect        x' = x * scale for the four planes of the inverse transform
//                 (the normalisation torch.fft.irfft2 applies after cuFFT's
//                 c2r), then out = -(gx' vx' + gy' vy');
//   finish        t = t * filt (the 2/3 rule), then t = t + f_hat, in place;
//   rk2_cn_stage  g = u + (beta dt) (L u), then with f given
//                 h = alpha f + (1 - alpha) h, then
//                 out = (1 / (1 - (beta dt) L)) (g + dt h).
// Every operation is the IEEE operation torch's elementwise kernel performs,
// in the same order and in the fields' type: a real table or a Python scalar
// enters a complex product as (x, +0), and the product is c10::complex's
// (a.re b.re - a.im b.im, a.re b.im + a.im b.re); torch adds complex tensors
// as a + b * (1, 0); c10's quotient by (c, +0) is numpy's, rat = 0 / c,
// scl = 1 / (c + 0 rat), ((a.re + a.im rat) scl, (a.im - a.re rat) scl);
// 1 / x is torch's reciprocal. Each is written out with the _rn intrinsics,
// so the compiler fuses no multiply-add; in every product one factor is
// exact (a 0, a 1 or a part of a promoted real), so torch's own contraction
// of these lines rounds the same. The results equal the composed path's on
// the card bit for bit, the signs of zeros included.
//
// Bound: bytes, with a few operations a value moved. At b = 256, 256^2, fp32
// a half-spectrum batch (33,024 modes a sample) is 67.6 MB and a physical
// one 67.1 MB; at 3.35 TB/s:
//   spectra       1 read, 4 written: 338 MB, 0.101 ms;
//   advect        4 read, 1 written: 336 MB, 0.100 ms;
//   finish        1 read, 1 written: 135 MB, 0.040 ms;
//   rk2_cn_stage  2 read and 1 written (first stage), 203 MB, 0.061 ms;
//                 3 read and 1 written (second), 271 MB, 0.081 ms;
// so an IMEX-2 step's eight launches move 2.09 GB, 0.62 ms; fp64 twice that.
// The design moves each value between device memory and the SMs once:
//
// - The mode kernels take one thread a mode, 256 threads a block, the grid
//   (ceil(n0 m / 256), min(b, SLICES)): blockIdx.x walks the modes of one
//   half-spectrum, blockIdx.y a slice of the samples, which the thread
//   walks SLICES apart. A mode's constants (the symbols, the Laplacian's
//   quotient terms, the stage's reciprocal) are read and computed once and
//   serve every sample of the slice.
// - advect is elementwise over the b n0 n1 points, one a thread, its four
//   planes b n0 n1 values apart.
// - Complex values move as float2/double2, 8 or 16 bytes a thread, so a
//   warp reads and writes whole 256- or 512-byte lines.
// - No shared memory and no barrier: nothing is reused between threads.
//
// Plain C interface: every pointer and the stream are void*, the scalars
// come as doubles and are rounded to the fields' type here, as torch rounds
// a Python scalar; each entry point returns cudaGetLastError() right after
// its launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLICES = 32;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T>
struct Cx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> load(const typename Pair<T>::type* p, long long i) {
  const typename Pair<T>::type v = p[i];
  return {v.x, v.y};
}

template <typename T>
__device__ __forceinline__ void store(typename Pair<T>::type* p, long long i, Cx<T> v) {
  typename Pair<T>::type out;
  out.x = v.re;
  out.y = v.im;
  p[i] = out;
}

// A real table entry or a scalar as torch promotes it into a complex product.
template <typename T>
__device__ __forceinline__ Cx<T> real(T x) {
  return {x, T(0)};
}

// c10::complex<T>'s a * b.
template <typename T>
__device__ __forceinline__ Cx<T> mul(Cx<T> a, Cx<T> b) {
  return {sub_rn(mul_rn(a.re, b.re), mul_rn(a.im, b.im)),
          add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re))};
}

// torch's a + b on complex tensors: AddFunctor's a + b * alpha, alpha = (1, 0).
template <typename T>
__device__ __forceinline__ Cx<T> add(Cx<T> a, Cx<T> b) {
  const Cx<T> b1 = mul(b, real(T(1)));
  return {add_rn(a.re, b1.re), add_rn(a.im, b1.im)};
}

template <typename T>
__device__ __forceinline__ Cx<T> neg(Cx<T> a) {
  return {-a.re, -a.im};
}

// c10::complex<T>'s quotient by (c, +0), c != 0: numpy's division, whose
// branch |c| >= |d| every such divisor takes.
template <typename T>
struct RealDivisor {
  T rat, scl;
};

template <typename T>
__device__ __forceinline__ RealDivisor<T> real_divisor(T c) {
  const T rat = div_rn(T(0), c);
  return {rat, div_rn(T(1), add_rn(c, mul_rn(T(0), rat)))};
}

template <typename T>
__device__ __forceinline__ Cx<T> quotient(Cx<T> a, RealDivisor<T> d) {
  return {mul_rn(add_rn(a.re, mul_rn(a.im, d.rat)), d.scl),
          mul_rn(sub_rn(a.im, mul_rn(a.re, d.rat)), d.scl)};
}

template <typename T>
__global__ void __launch_bounds__(THREADS) spectra_kernel(
    const typename Pair<T>::type* __restrict__ w, const typename Pair<T>::type* __restrict__ dx,
    const typename Pair<T>::type* __restrict__ dy, const T* __restrict__ lap,
    typename Pair<T>::type* __restrict__ out, int b, int modes) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= modes) return;
  const Cx<T> kx = load<T>(dx, p), ky = load<T>(dy, p);
  const RealDivisor<T> d = real_divisor(lap[p]);
  const long long plane = (long long)b * modes;
  for (long long s = blockIdx.y; s < b; s += gridDim.y) {
    const long long i = s * modes + p;
    const Cx<T> wv = load<T>(w, i);
    const Cx<T> psi = quotient(neg(wv), d);
    store<T>(out, i, mul(ky, psi));
    store<T>(out, plane + i, neg(mul(kx, psi)));
    store<T>(out, 2 * plane + i, mul(kx, wv));
    store<T>(out, 3 * plane + i, mul(ky, wv));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) advect_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long count, T scale) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= count) return;
  const T vx = mul_rn(x[i], scale);
  const T vy = mul_rn(x[count + i], scale);
  const T gx = mul_rn(x[2 * count + i], scale);
  const T gy = mul_rn(x[3 * count + i], scale);
  out[i] = -add_rn(mul_rn(gx, vx), mul_rn(gy, vy));
}

template <typename T, bool FILTER, bool FORCE>
__global__ void __launch_bounds__(THREADS) finish_kernel(
    typename Pair<T>::type* __restrict__ t, const T* __restrict__ filt,
    const typename Pair<T>::type* __restrict__ forcing, int b, int modes) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= modes) return;
  const T keep = FILTER ? filt[p] : T(0);
  const Cx<T> f = FORCE ? load<T>(forcing, p) : real(T(0));
  for (long long s = blockIdx.y; s < b; s += gridDim.y) {
    const long long i = s * modes + p;
    Cx<T> v = load<T>(t, i);
    if (FILTER) v = mul(v, real(keep));
    if (FORCE) v = add(v, f);
    store<T>(t, i, v);
  }
}

template <typename T, bool SECOND>
__global__ void __launch_bounds__(THREADS) rk2_cn_stage_kernel(
    const typename Pair<T>::type* __restrict__ u, const typename Pair<T>::type* __restrict__ h,
    const typename Pair<T>::type* __restrict__ f, const T* __restrict__ lin,
    typename Pair<T>::type* __restrict__ out, int b, int modes, T dt, T eta, T alpha,
    T one_minus_alpha) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= modes) return;
  const T L = lin[p];
  const T r = div_rn(T(1), sub_rn(T(1), mul_rn(L, eta)));
  for (long long s = blockIdx.y; s < b; s += gridDim.y) {
    const long long i = s * modes + p;
    const Cx<T> uv = load<T>(u, i);
    const Cx<T> g = add(uv, mul(mul(real(L), uv), real(eta)));
    Cx<T> hv = load<T>(h, i);
    if (SECOND) hv = add(mul(load<T>(f, i), real(alpha)), mul(hv, real(one_minus_alpha)));
    store<T>(out, i, mul(real(r), add(g, mul(hv, real(dt)))));
  }
}

bool modes_fit(int b, int modes) { return b >= 1 && modes >= 1; }

dim3 modes_grid(int b, int modes) {
  return dim3((unsigned)((modes + THREADS - 1) / THREADS),
              (unsigned)(b < SLICES ? b : SLICES));
}

template <typename T>
int launch_spectra(const void* w, const void* dx, const void* dy, const void* lap, void* out,
                   int b, int modes, cudaStream_t stream) {
  if (!modes_fit(b, modes)) return (int)cudaErrorInvalidValue;
  using V = typename Pair<T>::type;
  spectra_kernel<T><<<modes_grid(b, modes), THREADS, 0, stream>>>(
      (const V*)w, (const V*)dx, (const V*)dy, (const T*)lap, (V*)out, b, modes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_advect(const void* x, void* out, long long count, double scale,
                  cudaStream_t stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (count + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  advect_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>((const T*)x, (T*)out, count,
                                                             (T)scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish(void* t, const void* filt, const void* forcing, int b, int modes,
                  cudaStream_t stream) {
  if (!modes_fit(b, modes)) return (int)cudaErrorInvalidValue;
  using V = typename Pair<T>::type;
  const dim3 grid = modes_grid(b, modes);
  V* tv = (V*)t;
  const T* fl = (const T*)filt;
  const V* fc = (const V*)forcing;
  if (filt && forcing) {
    finish_kernel<T, true, true><<<grid, THREADS, 0, stream>>>(tv, fl, fc, b, modes);
  } else if (filt) {
    finish_kernel<T, true, false><<<grid, THREADS, 0, stream>>>(tv, fl, fc, b, modes);
  } else if (forcing) {
    finish_kernel<T, false, true><<<grid, THREADS, 0, stream>>>(tv, fl, fc, b, modes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rk2_cn_stage(const void* u, const void* h, const void* f, const void* lin,
                        void* out, int b, int modes, double dt, double eta, double alpha,
                        double one_minus_alpha, cudaStream_t stream) {
  if (!modes_fit(b, modes)) return (int)cudaErrorInvalidValue;
  using V = typename Pair<T>::type;
  const dim3 grid = modes_grid(b, modes);
  if (f) {
    rk2_cn_stage_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        (const V*)u, (const V*)h, (const V*)f, (const T*)lin, (V*)out, b, modes, (T)dt,
        (T)eta, (T)alpha, (T)one_minus_alpha);
  } else {
    rk2_cn_stage_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        (const V*)u, (const V*)h, nullptr, (const T*)lin, (V*)out, b, modes, (T)dt,
        (T)eta, (T)alpha, (T)one_minus_alpha);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w: b half-spectra of `modes` complex values; dx, dy: `modes` complex
// values; lap: `modes` real values, none 0; out: 4 b `modes` complex values.
int imex_spectra_f32(const void* w, const void* dx, const void* dy, const void* lap,
                     void* out, int b, int modes, void* stream) {
  return launch_spectra<float>(w, dx, dy, lap, out, b, modes, (cudaStream_t)stream);
}

int imex_spectra_f64(const void* w, const void* dx, const void* dy, const void* lap,
                     void* out, int b, int modes, void* stream) {
  return launch_spectra<double>(w, dx, dy, lap, out, b, modes, (cudaStream_t)stream);
}

// x: 4 planes of `count` real values, contiguous; out: `count` values.
int imex_advect_f32(const void* x, void* out, long long count, double scale, void* stream) {
  return launch_advect<float>(x, out, count, scale, (cudaStream_t)stream);
}

int imex_advect_f64(const void* x, void* out, long long count, double scale, void* stream) {
  return launch_advect<double>(x, out, count, scale, (cudaStream_t)stream);
}

// t: b half-spectra, in place; filt: `modes` real values or null; forcing:
// `modes` complex values or null; not both null.
int imex_finish_f32(void* t, const void* filt, const void* forcing, int b, int modes,
                    void* stream) {
  return launch_finish<float>(t, filt, forcing, b, modes, (cudaStream_t)stream);
}

int imex_finish_f64(void* t, const void* filt, const void* forcing, int b, int modes,
                    void* stream) {
  return launch_finish<double>(t, filt, forcing, b, modes, (cudaStream_t)stream);
}

// u, h, out and f (null for the first stage): b half-spectra; lin: `modes`
// real values; eta = beta dt and one_minus_alpha = 1 - alpha as the caller
// computes them in double.
int imex_rk2_cn_stage_f32(const void* u, const void* h, const void* f, const void* lin,
                          void* out, int b, int modes, double dt, double eta, double alpha,
                          double one_minus_alpha, void* stream) {
  return launch_rk2_cn_stage<float>(u, h, f, lin, out, b, modes, dt, eta, alpha,
                                    one_minus_alpha, (cudaStream_t)stream);
}

int imex_rk2_cn_stage_f64(const void* u, const void* h, const void* f, const void* lin,
                          void* out, int b, int modes, double dt, double eta, double alpha,
                          double one_minus_alpha, void* stream) {
  return launch_rk2_cn_stage<double>(u, h, f, lin, out, b, modes, dt, eta, alpha,
                                     one_minus_alpha, (cudaStream_t)stream);
}

}  // extern "C"
