// The FVM step's field passes around the pressure solve, for Hopper (sm_90a):
// the Runge-Kutta combination that feeds each projection, the projection's
// right-hand side (the MAC divergence) and its output (the velocity minus the
// pressure's gradient), each one launch over a batch of periodic 2-D fields.
//
// Replaces no TPU kernel. The JAX package writes these passes
// (tpu_cfd/solvers/fvm.py RKStepper, tpu_cfd/solvers/pressure.py) as array
// code that XLA fuses; eager PyTorch runs them as about 116 separate
// elementwise kernels a classic-RK4 step (rolls, negations, adds, scalar
// products), each a full pass over device memory. The Poisson solve between
// divergence and gradient stays on cuFFT (rfftn, the eigenvalue product,
// irfftn), in the fields' precision.
//
// What each launch computes, for every cell of every sample, as
// tpu_cfd_torch/solvers/fvm.py and solvers/pressure.py compute it on the
// plain path. u lies at offset (1, 1/2), v at (1/2, 1), the pressure p at
// (1/2, 1/2); axis 0 is the rows, axis 1 the contiguous columns; indices
// wrap (periodic).
//   combine            out = (((x0 + c1 k1) + c2 k2) + ...)   for x = u, v,
//                      up to MAX_TERMS terms, the sum in this order;
//   divergence         out = (u[i,j] - u[i-1,j]) / h0 + (v[i,j] - v[i,j-1]) / h1;
//   subtract_gradient  u' = u - (p[i+1,j] - p[i,j]) / h0,
//                      v' = v - (p[i,j+1] - p[i,j]) / h1.
// Every operation is one IEEE operation in the fields' type, rounded as
// torch's elementwise kernels round it: products and sums through the _rn
// intrinsics, so the compiler fuses no multiply-add, and each division by
// h_a as a product by the reciprocal rounded in the fields' type, as torch
// divides a CUDA tensor by a Python scalar. The plain path on the card gives
// the same bits.
//
// Bound: bytes, with about one operation a value moved. At b = 512, 128^2,
// fp64 a field is 67.1 MB and 3.35 TB/s moves it in 0.020 ms:
//   combine            2 (1 + terms) fields read, 2 written: 0.120 ms with one
//                      term, 0.240 ms with four;
//   divergence         2 read, 1 written: 0.060 ms;
//   subtract_gradient  3 read, 2 written: 0.100 ms.
// So the design moves each value between device memory and the SMs once:
//
// - One thread a cell, 256 threads a block. The stencils read their
//   neighbours straight from global memory: the column neighbour lies in the
//   same 128-byte line or the next, which the warp's own loads bring into L1,
//   and the row neighbour one row (n1 values) away, which the block before
//   read moments earlier and L2 still holds. Only the wrapped first (or
//   last) row of a sample comes from device memory twice.
// - The stencil grids are (ceil(n0 n1 / 256), min(b, 65535)): blockIdx.x
//   walks the cells of one plane, blockIdx.y the samples (a loop covers a
//   batch beyond 65,535), so the cell's row, column and wrapped neighbours
//   are computed once and serve every sample the block takes. combine is
//   elementwise over b n0 n1 values with no neighbour, one flat index a
//   thread.
// - No shared memory and no barrier: nothing is reused within a block that
//   L1 does not already keep.
//
// Plain C interface: every pointer and the stream are void*, the scalars
// come as doubles and are rounded to the fields' type here, as torch rounds
// a Python scalar; each entry point returns cudaGetLastError() right after
// its launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TERMS = 4;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
struct Terms {
  const T* k0[MAX_TERMS];  // the terms' u components
  const T* k1[MAX_TERMS];  // their v components
  T coef[MAX_TERMS];
};

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS) combine_kernel(
    const T* __restrict__ u0, const T* __restrict__ v0, Terms<T> t, T* __restrict__ out_u,
    T* __restrict__ out_v, long long count) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= count) return;
  T a = u0[i], b = v0[i];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    a = add_rn(a, mul_rn(t.k0[j][i], t.coef[j]));
    b = add_rn(b, mul_rn(t.k1[j][i], t.coef[j]));
  }
  out_u[i] = a;
  out_v[i] = b;
}

// A cell of the plane and its wrapped neighbours, as flat offsets in the plane.
struct Cell {
  int at, up, down, left, right;  // (i, j), (i-1, j), (i+1, j), (i, j-1), (i, j+1)
};

__device__ __forceinline__ Cell cell_at(int p, int n0, int n1) {
  const int plane = n0 * n1;
  const int i = p / n1, j = p - i * n1;
  Cell c;
  c.at = p;
  c.up = i > 0 ? p - n1 : p + plane - n1;
  c.down = i < n0 - 1 ? p + n1 : p - plane + n1;
  c.left = j > 0 ? p - 1 : p + n1 - 1;
  c.right = j < n1 - 1 ? p + 1 : p - n1 + 1;
  return c;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) divergence_kernel(
    const T* __restrict__ u, const T* __restrict__ v, T* __restrict__ out, int b, int n0,
    int n1, T inv_h0, T inv_h1) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n0 * n1) return;
  const Cell c = cell_at(p, n0, n1);
  for (long long s = blockIdx.y; s < b; s += gridDim.y) {
    const long long base = s * n0 * n1;
    const T d0 = mul_rn(sub_rn(u[base + c.at], u[base + c.up]), inv_h0);
    const T d1 = mul_rn(sub_rn(v[base + c.at], v[base + c.left]), inv_h1);
    out[base + c.at] = add_rn(d0, d1);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) subtract_gradient_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ q,
    T* __restrict__ out_u, T* __restrict__ out_v, int b, int n0, int n1, T inv_h0,
    T inv_h1) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n0 * n1) return;
  const Cell c = cell_at(p, n0, n1);
  for (long long s = blockIdx.y; s < b; s += gridDim.y) {
    const long long base = s * n0 * n1;
    const T q0 = q[base + c.at];
    const T g0 = mul_rn(sub_rn(q[base + c.down], q0), inv_h0);
    const T g1 = mul_rn(sub_rn(q[base + c.right], q0), inv_h1);
    out_u[base + c.at] = sub_rn(u[base + c.at], g0);
    out_v[base + c.at] = sub_rn(v[base + c.at], g1);
  }
}

bool plane_fits(int b, int n0, int n1) {
  return b >= 1 && n0 >= 1 && n1 >= 1 && (long long)n0 * n1 <= 0x7fffffffLL;
}

dim3 plane_grid(int b, int n0, int n1) {
  return dim3((unsigned)((n0 * n1 + THREADS - 1) / THREADS),
              (unsigned)(b < MAX_GRID_Y ? b : MAX_GRID_Y));
}

// The reciprocal of h rounded as torch rounds it: 1 / h in the fields' type.
template <typename T>
T reciprocal(double h) {
  return T(1) / T(h);
}

template <typename T>
int launch_combine(const void* u0, const void* v0, const void* const* k0,
                   const void* const* k1, const double* coef, int terms, void* out_u,
                   void* out_v, long long count, cudaStream_t stream) {
  if (terms < 1 || terms > MAX_TERMS || count < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (count + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Terms<T> t = {};
  for (int j = 0; j < terms; ++j) {
    t.k0[j] = (const T*)k0[j];
    t.k1[j] = (const T*)k1[j];
    t.coef[j] = (T)coef[j];
  }
  const T* a = (const T*)u0;
  const T* b = (const T*)v0;
  T* ou = (T*)out_u;
  T* ov = (T*)out_v;
  switch (terms) {
    case 1: combine_kernel<T, 1><<<(unsigned)blocks, THREADS, 0, stream>>>(a, b, t, ou, ov, count); break;
    case 2: combine_kernel<T, 2><<<(unsigned)blocks, THREADS, 0, stream>>>(a, b, t, ou, ov, count); break;
    case 3: combine_kernel<T, 3><<<(unsigned)blocks, THREADS, 0, stream>>>(a, b, t, ou, ov, count); break;
    default: combine_kernel<T, 4><<<(unsigned)blocks, THREADS, 0, stream>>>(a, b, t, ou, ov, count); break;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_divergence(const void* u, const void* v, void* out, int b, int n0, int n1,
                      double h0, double h1, cudaStream_t stream) {
  if (!plane_fits(b, n0, n1)) return (int)cudaErrorInvalidValue;
  divergence_kernel<T><<<plane_grid(b, n0, n1), THREADS, 0, stream>>>(
      (const T*)u, (const T*)v, (T*)out, b, n0, n1, reciprocal<T>(h0), reciprocal<T>(h1));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_subtract_gradient(const void* u, const void* v, const void* q, void* out_u,
                             void* out_v, int b, int n0, int n1, double h0, double h1,
                             cudaStream_t stream) {
  if (!plane_fits(b, n0, n1)) return (int)cudaErrorInvalidValue;
  subtract_gradient_kernel<T><<<plane_grid(b, n0, n1), THREADS, 0, stream>>>(
      (const T*)u, (const T*)v, (const T*)q, (T*)out_u, (T*)out_v, b, n0, n1,
      reciprocal<T>(h0), reciprocal<T>(h1));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u0, v0, out_u, out_v and each term's k0[j], k1[j]: `count` values, contiguous,
// of one type; coef[j] the terms' coefficients, terms 1 to MAX_TERMS.
int fvm_combine_f32(const void* u0, const void* v0, const void* const* k0,
                    const void* const* k1, const double* coef, int terms, void* out_u,
                    void* out_v, long long count, void* stream) {
  return launch_combine<float>(u0, v0, k0, k1, coef, terms, out_u, out_v, count,
                               (cudaStream_t)stream);
}

int fvm_combine_f64(const void* u0, const void* v0, const void* const* k0,
                    const void* const* k1, const double* coef, int terms, void* out_u,
                    void* out_v, long long count, void* stream) {
  return launch_combine<double>(u0, v0, k0, k1, coef, terms, out_u, out_v, count,
                                (cudaStream_t)stream);
}

// u, v, out: b samples of (n0, n1), contiguous, of one type; h_a the grid step.
int fvm_divergence_f32(const void* u, const void* v, void* out, int b, int n0, int n1,
                       double h0, double h1, void* stream) {
  return launch_divergence<float>(u, v, out, b, n0, n1, h0, h1, (cudaStream_t)stream);
}

int fvm_divergence_f64(const void* u, const void* v, void* out, int b, int n0, int n1,
                       double h0, double h1, void* stream) {
  return launch_divergence<double>(u, v, out, b, n0, n1, h0, h1, (cudaStream_t)stream);
}

// u, v, q (the pressure), out_u, out_v: b samples of (n0, n1), contiguous, of
// one type; h_a the grid step.
int fvm_subtract_gradient_f32(const void* u, const void* v, const void* q, void* out_u,
                              void* out_v, int b, int n0, int n1, double h0, double h1,
                              void* stream) {
  return launch_subtract_gradient<float>(u, v, q, out_u, out_v, b, n0, n1, h0, h1,
                                         (cudaStream_t)stream);
}

int fvm_subtract_gradient_f64(const void* u, const void* v, const void* q, void* out_u,
                              void* out_v, int b, int n0, int n1, double h0, double h1,
                              void* stream) {
  return launch_subtract_gradient<double>(u, v, q, out_u, out_v, b, n0, n1, h0, h1,
                                          (cudaStream_t)stream);
}

}  // extern "C"
