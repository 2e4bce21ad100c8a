// One explicit evaluation of the MAC-grid momentum equation for Hopper
// (sm_90a): Van Leer convection, diffusion, forcing and drag of both
// velocity components of a batch of periodic 2-D fields in one launch.
//
// Replaces no TPU kernel. The JAX package evaluates these terms
// (tpu_cfd/solvers/fvm.py, NavierStokes2DFVMProjection.explicit_terms) as
// array code that XLA fuses; eager PyTorch runs the same expression as about
// 300 separate elementwise kernels (rolls, wheres, divisions, adds), each a
// full pass over device memory. This kernel is what XLA's fusion gave the
// TPU: u and v read once, du/dt and dv/dt written once.
//
// What one launch computes, for every cell of every sample, exactly as
// tpu_cfd_torch/solvers/fvm.py::NavierStokes2DFVMProjection._explicit_terms
// does with its default `convect`. u lies at offset (1, 1/2), v at (1/2, 1);
// axis 0 is the rows, axis 1 the contiguous columns. For component c (u or
// v) and axis a, the face between cells i and i + e_a carries
//   w      = 0.5 q[i] + 0.5 q[i + e_d]   (q = velocity component a, d = c's own
//                                         axis: interpolation.linear)
//   low    = w > 0 ? c[i] : c[i+1]                           (upwind)
//   high   = w > 0 ? c[i] + 0.5 (1 - C) (c[i+1] - c[i])      (Lax-Wendroff,
//                  : c[i+1] - 0.5 (1 + C) (c[i+1] - c[i])     C = dt/h_a w)
//   r      = (w > 0 ? c[i] - c[i-1] : c[i+2] - c[i+1]) / (c[i+1] - c[i])
//            (a zero denominator taken as 1: interpolation.safe_div)
//   phi    = r > 0 ? 2r / (1 + r) : 0                        (Van Leer)
//   flux   = (low - (low - high) phi) w
// and the rate is
//   dc/dt  = -sum_a (flux_a[i] - flux_a[i - e_a]) / h_a
//            + nu (the 5-point Laplacian of c) + f_c / rho - drag c,
// nu = viscosity / rho, f_c the state-independent forcing (an (n0, n1) array
// a component, the same for every sample) or none. Every intermediate is in
// the fields' type (float or double); no fast-math. The divisions by h_a and
// rho are products by host-rounded reciprocals, as torch computes a CUDA
// tensor over a Python scalar.
//
// Bound: bytes. A launch reads u and v and writes both rates, 4 fields:
// at b = 512, 128^2, fp64 that is 268 MB, 0.080 ms at 3.35 TB/s. The
// arithmetic is close behind in fp64: a face costs two fp64 divisions (r and
// the limiter; each a reciprocal seed and about eight DFMAs) and some 25 other
// fp64 operations, and a cell takes 4.19 faces (below), about 8.4 divisions
// and 190 fp64 instructions a cell: at 8.4 M cells, 1.6 G instructions against
// the SMs' ~15 T fp64 instructions a second, ~0.1 ms. So the design moves
// each byte once and computes each face once:
//
// - A block takes a tile of TR x TC cells (16 rows x 32 columns) of one
//   sample, and stages u and v over the tile with a periodic halo of 2 on
//   every side ((TR + 4) x (TC + 4) values each; the faces need the shifts
//   -2..+2 along their axis and the face velocities +1 across it). Loads run
//   along the contiguous columns, so a warp reads whole 128-byte lines; the
//   halos of neighbouring tiles come from L2, which blocks of one sample
//   reach close together in time (blockIdx.x walks the column tiles, then
//   the row tiles, then the samples).
// - Each face flux is computed once, into shared memory: (TR + 1) x TC
//   faces along axis 0 and TR x (TC + 1) along axis 1 a component, 2,144 a
//   block for 512 cells. The limiter's two branches are selects, so a warp
//   never diverges on the sign of w; only the chosen gradient ratio is
//   formed.
// - Each thread then takes two cells, differences their fluxes, adds the
//   Laplacian from the staged tile and the forcing (an (n0, n1) array that
//   stays in L2), and writes both rates along the columns.
// - (n1 / 32) (n0 / 16) b blocks of 256 threads: 16,384 at b = 512, 128^2,
//   about 31 waves over 132 SMs; 28 KB of shared memory a block in fp64.
//   A grid that is not a multiple of the tile wraps its loads and masks its
//   writes.
//
// Plain C interface: every pointer and the stream are void*, the scalars
// come as doubles (rounded to the fields' type here, as torch rounds a
// Python scalar), and each entry point returns cudaGetLastError() right
// after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int TR = 16;  // rows (axis 0) of a block's tile
constexpr int TC = 32;  // columns (axis 1, contiguous) of a block's tile
constexpr int HALO = 2;
constexpr int SR = TR + 2 * HALO;
constexpr int SC = TC + 2 * HALO;
constexpr int THREADS = 256;
constexpr int F0 = (TR + 1) * TC;  // axis-0 faces of a component: rows -1..TR-1
constexpr int F1 = TR * (TC + 1);  // axis-1 faces: columns -1..TC-1
constexpr int FACES = F0 + F1;

template <typename T>
struct Scalars {
  T courant0, courant1;  // dt / h_a
  T inv_h0, inv_h1;      // 1 / h_a
  T s0, s1, s_sum;       // 1 / h_a^2 and their sum
  T nu;                  // viscosity / density
  T inv_rho;             // 1 / density
  T neg_drag;            // -drag
};

// The flux through one face along an axis: cm, c0, cp, cpp are c at i - 1,
// i, i + 1, i + 2 along it, w the face velocity, courant dt / h.
template <typename T>
__device__ __forceinline__ T face_flux(T cm, T c0, T cp, T cpp, T w, T courant) {
  const bool pos = w > T(0);
  const T diff = cp - c0;
  const T low = pos ? c0 : cp;
  const T cw = courant * w;
  const T high = pos ? c0 + T(0.5) * (T(1) - cw) * diff
                     : cp - T(0.5) * (T(1) + cw) * diff;
  const T num = pos ? c0 - cm : cpp - cp;
  const T r = num / (diff != T(0) ? diff : T(1));
  const T one_r = T(1) + r;
  const T phi = r > T(0) ? (T(2) * r) / (one_r != T(0) ? one_r : T(1)) : T(0);
  return (low - (low - high) * phi) * w;
}

__device__ __forceinline__ int wrap(int x, int n) {
  while (x < 0) x += n;
  while (x >= n) x -= n;
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fvm_explicit_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ fu,
    const T* __restrict__ fv, T* __restrict__ du, T* __restrict__ dv, int n0, int n1,
    int tiles0, int tiles1, Scalars<T> k, int has_drag) {
  __shared__ T s_c[2][SR * SC];      // u, v over the tile and its halo
  __shared__ T s_flux[2][FACES];     // per component: axis-0 faces, then axis-1
  int t = blockIdx.x;
  const int tc = t % tiles1;
  t /= tiles1;
  const int tr = t % tiles0;
  const long long sample = t / tiles0;
  const int r0 = tr * TR, c0 = tc * TC;
  const long long base = sample * n0 * n1;

  for (int i = threadIdx.x; i < SR * SC; i += THREADS) {
    const int lr = i / SC, lc = i - lr * SC;
    const long long at = base + (long long)wrap(r0 - HALO + lr, n0) * n1
                         + wrap(c0 - HALO + lc, n1);
    s_c[0][i] = u[at];
    s_c[1][i] = v[at];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 2 * FACES; i += THREADS) {
    const int comp = i >= FACES;  // 0: u, 1: v
    const int f = i - comp * FACES;
    const bool axis0 = f < F0;
    int si, sj;  // the face's lower cell in the staged tile
    if (axis0) {
      si = f / TC + HALO - 1;
      sj = f % TC + HALO;
    } else {
      const int g = f - F0;
      si = g / (TC + 1) + HALO;
      sj = g % (TC + 1) + HALO - 1;
    }
    const int at = si * SC + sj;
    const int step = axis0 ? SC : 1;
    // the face velocity: component `axis`, averaged along comp's own axis
    const T* q = s_c[axis0 ? 0 : 1] + at;
    const T w = T(0.5) * q[0] + T(0.5) * q[comp ? 1 : SC];
    const T* c = s_c[comp] + at;
    s_flux[comp][f] = face_flux(c[-step], c[0], c[step], c[2 * step], w,
                                axis0 ? k.courant0 : k.courant1);
  }
  __syncthreads();

  const int lc = threadIdx.x % TC;
  const int j = c0 + lc;
#pragma unroll
  for (int p = 0; p < (TR * TC) / THREADS; ++p) {
    const int lr = threadIdx.x / TC + p * (THREADS / TC);
    const int i = r0 + lr;
    if (i >= n0 || j >= n1) continue;
    const long long at = base + (long long)i * n1 + j;
    const int s = (lr + HALO) * SC + lc + HALO;
#pragma unroll
    for (int comp = 0; comp < 2; ++comp) {
      const T* fl = s_flux[comp];
      const T* c = s_c[comp] + s;
      const T d0 = (fl[(lr + 1) * TC + lc] - fl[lr * TC + lc]) * k.inv_h0;
      const T d1 = (fl[F0 + lr * (TC + 1) + lc + 1] - fl[F0 + lr * (TC + 1) + lc])
                   * k.inv_h1;
      const T adv = -(d0 + d1);
      const T lap = T(-2) * c[0] * k.s_sum + (c[-SC] + c[SC]) * k.s0
                    + (c[-1] + c[1]) * k.s1;
      T rate = adv + k.nu * lap;
      const T* force = comp ? fv : fu;
      if (force != nullptr) rate = rate + force[(long long)i * n1 + j] * k.inv_rho;
      if (has_drag) rate = rate + k.neg_drag * c[0];
      (comp ? dv : du)[at] = rate;
    }
  }
}

static_assert((TR * TC) % THREADS == 0 && THREADS % TC == 0, "tile and threads");

template <typename T>
int launch(const void* u, const void* v, const void* fu, const void* fv, void* du,
           void* dv, int b, int n0, int n1, double courant0, double courant1,
           double h0, double h1, double nu, double density, double drag,
           cudaStream_t stream) {
  if (b < 1 || n0 < 1 || n1 < 1) return (int)cudaErrorInvalidValue;
  const int tiles0 = (n0 + TR - 1) / TR, tiles1 = (n1 + TC - 1) / TC;
  const long long blocks = (long long)b * tiles0 * tiles1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const double s0 = 1.0 / (h0 * h0), s1 = 1.0 / (h1 * h1);
  Scalars<T> k;
  k.courant0 = (T)courant0;
  k.courant1 = (T)courant1;
  k.inv_h0 = (T)(1.0 / h0);
  k.inv_h1 = (T)(1.0 / h1);
  k.s0 = (T)s0;
  k.s1 = (T)s1;
  k.s_sum = (T)(s0 + s1);
  k.nu = (T)nu;
  k.inv_rho = (T)(1.0 / density);
  k.neg_drag = (T)(-drag);
  fvm_explicit_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)u, (const T*)v, (const T*)fu, (const T*)fv, (T*)du, (T*)dv, n0, n1,
      tiles0, tiles1, k, drag > 0.0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u, v, du, dv: b samples of (n0, n1), contiguous, of one type; fu, fv: the
// forcing's (n0, n1) arrays, or both null. courant_a = dt / h_a; nu =
// viscosity / density; drag applies where it is above 0.
int fvm_explicit_f32(const void* u, const void* v, const void* fu, const void* fv,
                     void* du, void* dv, int b, int n0, int n1, double courant0,
                     double courant1, double h0, double h1, double nu, double density,
                     double drag, void* stream) {
  return launch<float>(u, v, fu, fv, du, dv, b, n0, n1, courant0, courant1, h0, h1, nu,
                       density, drag, (cudaStream_t)stream);
}

int fvm_explicit_f64(const void* u, const void* v, const void* fu, const void* fv,
                     void* du, void* dv, int b, int n0, int n1, double courant0,
                     double courant1, double h0, double h1, double nu, double density,
                     double drag, void* stream) {
  return launch<double>(u, v, fu, fv, du, dv, b, n0, n1, courant0, courant1, h0, h1, nu,
                        density, drag, (cudaStream_t)stream);
}

}  // extern "C"
