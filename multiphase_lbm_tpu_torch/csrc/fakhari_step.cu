// Fakhari conservative phase-field D2Q9 step (h̄ for φ, ḡ for p*; BGK of
// both with the interface-sharpening and force terms; periodic streaming;
// post-stream field refresh; stale-u velocity update) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_fakhari.py:_make_kernel (the
// Pallas TPU kernel behind pallas_fakhari.run_fused) and computes what its
// step_block computes (pallas_fakhari.py:207-264), one step per call of
// fakhari_step_f32/_f64:
//   φ = Σh, p* = Σg, ρ = ρ_L + φ(ρ_H − ρ_L), ∇φ and ∇²φ (isotropic D2Q9
//   stencils), μ = 4βφ(φ − 1)(φ − ½) − κ∇²φ, n = ∇φ/|∇φ|, the stress
//   Σ_{k≠rest} (g_k − g_eq,k) c c at the state's u, F = μ∇φ − p*(ρ_H − ρ_L)/3
//   ∇φ + (½ − τ)/τ (S·∇φ)(ρ_H − ρ_L), BGK of h with the sharpening term and
//   of g with the force term, periodic streaming, then the fields of the
//   streamed (h, g) and u = Σ c g + F/(2ρ) with F taken at the PREVIOUS u
//   (the reference's stale-u refresh, Young_Laplace2D.h:353-368).
// Unlike the Pallas kernel (float32 scratch) it also runs in float64.
//
// Bound: device memory.  A step must read h, g and u and write them back:
// 160 B per cell in float32, 671 MB per step at 2048², so at 3.35 TB/s (H100
// SXM data sheet) no step takes less than 0.20 ms (20,900 MLUPS).
//
// Design (simple and right first; the Pallas 8-row halos, nsub stripes,
// roll factorisation and float32 scratch were Mosaic constraints and are
// not carried over).  One thread per cell; x and y wrap by index.  The
// fields depend only on (h, g), and φ needs its 3 × 3 neighbourhood, so φ
// lives in a (ny, nx) scratch field between launches:
//   1. phi_kernel: φ = Σh (36 B read, 4 B written per cell), only on the
//      first step of a call: every later step reuses the φ of launch 3.
//   2. collide_stream_kernel: reads h, g and u of its cell and φ of its
//      neighbourhood, collides both populations and PUSHES each post_k to
//      (r + c_k, k).  The map r → r + c_k is a bijection of the periodic
//      lattice, so every output slot is written exactly once and the push
//      equals the Pallas pull streaming (80 B read, 72 B written, φ 4 B).
//   3. phi_kernel on the streamed h (40 B).
//   4. velocity_kernel: reads the streamed g, the old u and φ of its
//      neighbourhood, writes the new u (36 + 8 + 4 B read, 8 B written).
// About 252 B per cell per step in all; three launches per step after the
// first.  The wrapper ping-pongs two triples of buffers, so input and
// output never alias.
#include <cuda_runtime.h>
#include <stddef.h>

// Model constants, filled by multiphase_lbm_tpu_torch/ops/fakhari_fused.py
// (_FakhariConst, same field order).  Doubles, converted to the working
// type in the kernel exactly as JAX casts Python floats into a float32
// kernel.
struct FakhariConst {
  double rhol, drho;         // ρ_L, ρ_H − ρ_L
  double four_beta, kappa;   // 4β, κ of μ
  double W;                  // interface width
  double wc, one_minus_wc;   // phase-field relaxation
  double s8, one_minus_s8;   // hydrodynamic relaxation 1/τ
  double fac;                // (½ − τ)/τ of F_μ
  double drho3;              // (ρ_H − ρ_L)/3 of F_p
};

namespace {

// D2Q9 module ordering (rest at k = 4), multiphase_lbm_tpu/core/lattice.py:
// c_k = (-1,0) (0,-1) (-1,-1) (-1,1) (0,0) (1,0) (0,1) (1,1) (1,-1).
__host__ __device__ __forceinline__ constexpr int cx(int k) {
  return (k == 5 || k == 7 || k == 8) - (k == 0 || k == 2 || k == 3);
}
__host__ __device__ __forceinline__ constexpr int cy(int k) {
  return (k == 3 || k == 6 || k == 7) - (k == 1 || k == 2 || k == 8);
}
__host__ __device__ __forceinline__ constexpr double wk(int k) {
  return k == 4 ? 4.0 / 9.0
                : ((cx(k) != 0 && cy(k) != 0) ? 1.0 / 36.0 : 1.0 / 9.0);
}

constexpr double EPS_C = 1e-30;  // reference epsC, Young_Laplace2D.h:100

// The 9 neighbours r + c_k of cell i = y·nx + x, wrapping in x and y.
struct Nbr {
  size_t nb[9];
};

__device__ __forceinline__ Nbr neighbours(size_t i, int ny, int nx) {
  Nbr s;
  const int y = (int)(i / nx);
  const int x = (int)(i - (size_t)y * nx);
  const int xs[3] = {x == 0 ? nx - 1 : x - 1, x, x == nx - 1 ? 0 : x + 1};
  const int ys[3] = {y == 0 ? ny - 1 : y - 1, y, y == ny - 1 ? 0 : y + 1};
#pragma unroll
  for (int k = 0; k < 9; ++k)
    s.nb[k] = (size_t)ys[cy(k) + 1] * nx + xs[cx(k) + 1];
  return s;
}

// The fields of one cell that the collision and the velocity update share.
template <typename T>
struct Fields {
  T C, P, rho, dCx, dCy, mu;
};

// φ, ∇φ, μ from the φ neighbourhood; p* and ρ (derive_fields).
template <typename T>
__device__ __forceinline__ Fields<T> derive_fields(const T* __restrict__ phi,
                                                   const Nbr& s, const T* gk,
                                                   const FakhariConst& c) {
  Fields<T> d;
  d.C = phi[s.nb[4]];
  T gx = T(0), gy = T(0), lap = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const T v = phi[s.nb[k]];
    if (cx(k)) gx += T(wk(k) * cx(k)) * v;
    if (cy(k)) gy += T(wk(k) * cy(k)) * v;
    lap += T(wk(k)) * (v - d.C);
  }
  d.dCx = T(3) * gx;
  d.dCy = T(3) * gy;
  d.mu = T(c.four_beta) * d.C * (d.C - T(1)) * (d.C - T(0.5)) -
         T(c.kappa) * (T(6) * lap);
  T P = gk[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) P += gk[k];
  d.P = P;
  d.rho = T(c.rhol) + d.C * T(c.drho);
  return d;
}

// F = μ∇φ + F_p + F_μ (total_force), with the stress of g against its
// equilibrium at the velocity (ux, uy).
template <typename T>
__device__ __forceinline__ void total_force(const T* gk, const Fields<T>& d,
                                            T ux, T uy, const FakhariConst& c,
                                            T* Fx, T* Fy) {
  const T usqr = T(1.5) * (ux * ux + uy * uy);
  T sxx = T(0), sxy = T(0), syy = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const T w = T(wk(k));
    const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
    const T geq = d.P * w + w * (T(3) * cu + T(4.5) * cu * cu - usqr);
    const T dn = gk[k] - geq;
    if (cx(k)) sxx += dn;
    if (cx(k) && cy(k)) sxy += T(cx(k) * cy(k)) * dn;
    if (cy(k)) syy += dn;
  }
  const T fac = T(c.fac), dR = T(c.drho);
  const T FmX = fac * (sxx * d.dCx + sxy * d.dCy) * dR;
  const T FmY = fac * (sxy * d.dCx + syy * d.dCy) * dR;
  const T FpX = -d.P * T(c.drho3) * d.dCx;
  const T FpY = -d.P * T(c.drho3) * d.dCy;
  *Fx = d.mu * d.dCx + FpX + FmX;
  *Fy = d.mu * d.dCy + FpY + FmY;
}

template <typename T>
__global__ void phi_kernel(const T* __restrict__ h, T* __restrict__ phi,
                           size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = h[i];
#pragma unroll
  for (int k = 1; k < 9; ++k) s += h[k * n + i];
  phi[i] = s;
}

// Two blocks of 256 threads per SM in float32 (at most 128 registers a
// thread), as for the HCZ collide kernel, where the cap ran 1.49× faster on
// an H100 than the compiler's own choice (PERF.md); in float64 the cap
// would spill, so there it stays at one block.
template <typename T>
__global__ void __launch_bounds__(256, sizeof(T) == 4 ? 2 : 1)
collide_stream_kernel(const T* __restrict__ h, const T* __restrict__ g,
                      const T* __restrict__ u, const T* __restrict__ phi,
                      T* __restrict__ ho, T* __restrict__ go, int ny, int nx,
                      FakhariConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Nbr s = neighbours(i, ny, nx);
  T gk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) gk[k] = g[k * n + i];
  const Fields<T> d = derive_fields(phi, s, gk, c);
  const T ux = u[i], uy = u[n + i];
  T Fx, Fy;
  total_force(gk, d, ux, uy, c, &Fx, &Fy);

  const T inv_norm = T(1) / sqrt(d.dCx * d.dCx + d.dCy * d.dCy + T(1e-32));
  const T nxv = d.dCx * inv_norm, nyv = d.dCy * inv_norm;
  const T shape = (T(1) - T(4) * ((d.C - T(0.5)) * (d.C - T(0.5)))) / T(c.W);
  const T inv_rho = T(1) / (d.rho + T(EPS_C));
  const T usqr = T(1.5) * (ux * ux + uy * uy);
  const T wc = T(c.wc), wc1 = T(c.one_minus_wc);
  const T s8 = T(c.s8), s81 = T(c.one_minus_s8);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T w = T(wk(k));
    const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
    const T GaWa = w * (T(3) * cu + T(4.5) * cu * cu - usqr);  // Γ_k − w_k
    // g: equilibrium with the force term
    const T geq = d.P * w + GaWa;
    const T eF = T(cx(k)) * Fx + T(cy(k)) * Fy;
    const T hlp_g = T(3) * w * eF * inv_rho;
    go[k * n + s.nb[k]] = s81 * gk[k] + s8 * (geq - T(0.5) * hlp_g) + hlp_g;
    // h: equilibrium with the sharpening term
    const T proj = T(cx(k)) * nxv + T(cy(k)) * nyv;
    const T hlp_h = w * shape * proj;
    const T heq = d.C * (w + GaWa) - T(0.5) * hlp_h;
    ho[k * n + s.nb[k]] = wc1 * h[k * n + i] + wc * heq + hlp_h;
  }
}

template <typename T>
__global__ void velocity_kernel(const T* __restrict__ g,
                                const T* __restrict__ u,
                                const T* __restrict__ phi, T* __restrict__ uo,
                                int ny, int nx, FakhariConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Nbr s = neighbours(i, ny, nx);
  T gk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) gk[k] = g[k * n + i];
  const Fields<T> d = derive_fields(phi, s, gk, c);
  T Fx, Fy;
  total_force(gk, d, u[i], u[n + i], c, &Fx, &Fy);
  const T momx = gk[5] + gk[7] + gk[8] - gk[0] - gk[2] - gk[3];
  const T momy = gk[3] + gk[6] + gk[7] - gk[1] - gk[2] - gk[8];
  const T rho_eps = d.rho + T(EPS_C);
  uo[i] = momx + T(0.5) * Fx / rho_eps;
  uo[n + i] = momy + T(0.5) * Fy / rho_eps;
}

template <typename T>
int launch_step(const T* h, const T* g, const T* u, T* ho, T* go, T* uo,
                T* phi, int ny, int nx, int fresh_phi, const FakhariConst* c,
                cudaStream_t stream) {
  const size_t n = (size_t)ny * nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaError_t err;
  if (!fresh_phi) {
    phi_kernel<T><<<blocks, threads, 0, stream>>>(h, phi, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  collide_stream_kernel<T>
      <<<blocks, threads, 0, stream>>>(h, g, u, phi, ho, go, ny, nx, *c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  phi_kernel<T><<<blocks, threads, 0, stream>>>(ho, phi, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  velocity_kernel<T><<<blocks, threads, 0, stream>>>(go, u, phi, uo, ny, nx,
                                                     *c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One step: (h, g) (9, ny, nx) and u (2, ny, nx) → (ho, go, uo); phi is a
// (ny, nx) scratch that holds Σh of the output afterwards.  fresh_phi != 0
// says that phi already holds Σh of the input (the previous call's
// output), so its launch is skipped.  Returns the cudaError_t of the
// launches (0 on success).
int fakhari_step_f32(const void* h, const void* g, const void* u, void* ho,
                     void* go, void* uo, void* phi, int ny, int nx,
                     int fresh_phi, const void* consts, void* stream) {
  return launch_step<float>((const float*)h, (const float*)g,
                            (const float*)u, (float*)ho, (float*)go,
                            (float*)uo, (float*)phi, ny, nx, fresh_phi,
                            (const FakhariConst*)consts, (cudaStream_t)stream);
}

int fakhari_step_f64(const void* h, const void* g, const void* u, void* ho,
                     void* go, void* uo, void* phi, int ny, int nx,
                     int fresh_phi, const void* consts, void* stream) {
  return launch_step<double>((const double*)h, (const double*)g,
                             (const double*)u, (double*)ho, (double*)go,
                             (double*)uo, (double*)phi, ny, nx, fresh_phi,
                             (const FakhariConst*)consts,
                             (cudaStream_t)stream);
}

}  // extern "C"
