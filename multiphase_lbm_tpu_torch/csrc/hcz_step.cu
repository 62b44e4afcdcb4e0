// HCZ phase-field D2Q9 step (order parameter f, pressure g; Carnahan–
// Starling EOS; mirrored stencils at walls; Guo-type forcing; BGK of f and
// g; bounce-back streaming) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_hcz.py:_make_kernel (the Pallas
// TPU kernel behind pallas_hcz.run_fused) and computes what its step_block
// computes (pallas_hcz.py:139-261), one step per call of hcz_step_f32/_f64:
//   φ = Σf, P_term = Σg, ρ = ρ_g + (φ − φ_g)·Δρ/Δφ, ψρ and ψφ (CS minus
//   ρ/3), ∇²φ, ∇ψρ, ∇ψφ, ∇ρ and ∇(∇²φ) with mirrored reads (q(r − c_k)
//   where r + c_k is solid), F = κρ∇∇²φ + (gx ρ + Gx_const, gravity ρ),
//   u = (Σ c g + F/6)/(ρ/3), P = P_term + ½ u·∇ρ/3, f_eq and g_eq, the
//   forcing terms, BGK of f and g, then streaming with on-site bounce-back
//   (solid cells hold zeros).
// Unlike the Pallas kernel it also runs in float64, and it takes one
// reciprocal of φ per cell where the Pallas kernel divides nine times (the
// divide forms there were kept for an XLA-CPU interpret-mode pathology).
//
// Bound: device memory.  A step must read f and g and write them back
// (144 B per cell in float32) and read the mask (4 B): 148 B per cell,
// 2.48 GB per step at RTI-2048 (2048 × 8194), so at 3.35 TB/s (H100 SXM
// data sheet) no step takes less than 0.74 ms (22,600 MLUPS).
//
// Design (simple and right first; the Pallas 8-row halos, lane-whole
// stripes, stacked rolls and temporal blocking were Mosaic constraints and
// are not carried over).  One thread per cell, x and y wrap by index, and
// three launches per step:
//   1. phi_kernel: φ = Σ_k f_k into a (ny, nx) scratch (36 B read, 4 B
//      written per cell).
//   2. lap_kernel: ∇²φ with mirrored reads into a second scratch, at every
//      cell, solid ones included, as the plain path computes it (φ, mask
//      and ∇²φ: 12 B per cell; the neighbourhood comes from cache).
//   3. collide_stream_kernel: reads its 18 populations, φ and ∇²φ of its 8
//      neighbours (recomputing ρ, ψρ and ψφ from φ instead of storing three
//      more fields), takes the mirrored gradients and ∇(∇²φ), collides f
//      and g, then PUSHES each post_k to (r + c_k, k) when that cell is
//      fluid, or bounces it back to (r, opp k).  Solid cells write zeros to
//      their own 18 slots.  Every output slot is written exactly once, so
//      the push is race-free and equals the Pallas pull rule
//        new_k(r) = fluid(r − c_k) ? post_k(r − c_k) : post_{opp k}(r),
//      times fluid(r).  Pushing needs ∇∇²φ only at r, so the reach of the
//      last launch is 2, which launches 1 and 2 cover.
//      (72 B read, 72 B written, 12 B of φ, ∇²φ and mask per cell.)
// About 208 B per cell per step in all.  The wrapper ping-pongs two pairs
// of buffers, so input and output never alias.
#include <cuda_runtime.h>
#include <stddef.h>

// Model constants, filled by multiphase_lbm_tpu_torch/ops/hcz_fused.py
// (_HCZConst, same field order).  Doubles, converted to the working type in
// the kernel exactly as JAX casts Python floats into a float32 kernel.
struct HCZConst {
  double omega, one_minus_omega, half;  // half = 1 − ω/2
  double phi_g, rho_g, drho_dphi;       // ρ = ρ_g + (φ − φ_g)·drho_dphi
  double a, b_quarter;                  // Carnahan–Starling a and b/4
  double kappa, gravity, gx, Gx_const;
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
__host__ __device__ __forceinline__ constexpr int opp(int k) {
  return k == 4 ? 4 : (k < 4 ? k + 5 : k - 5);
}
__host__ __device__ __forceinline__ constexpr double wk(int k) {
  return k == 4 ? 4.0 / 9.0
                : ((cx(k) != 0 && cy(k) != 0) ? 1.0 / 36.0 : 1.0 / 9.0);
}

template <typename T>
__device__ __forceinline__ T rho_of_phi(T phi, const HCZConst& c) {
  return T(c.rho_g) + (phi - T(c.phi_g)) * T(c.drho_dphi);
}

// ψ(r) = p_CS(r) − r/3 with one divide, as pallas_hcz.py:60-65 forms it.
template <typename T>
__device__ __forceinline__ T cs_psi(T r, const HCZConst& c) {
  const T rt = r * T(c.b_quarter);
  const T om = T(1) - rt;
  return (r * T(1.0 / 3.0)) * (T(1) + rt + rt * rt - rt * rt * rt) /
             (om * om * om) -
         T(c.a) * r * r - r * T(1.0 / 3.0);
}

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

template <typename T>
__global__ void phi_kernel(const T* __restrict__ f, T* __restrict__ phi,
                           size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = f[i];
#pragma unroll
  for (int k = 1; k < 9; ++k) s += f[k * n + i];
  phi[i] = s;
}

template <typename T>
__global__ void lap_kernel(const T* __restrict__ phi,
                           const float* __restrict__ mask,
                           T* __restrict__ lap, int ny, int nx) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Nbr s = neighbours(i, ny, nx);
  const T pc = phi[i];
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const T v = mask[s.nb[k]] > 0.5f ? phi[s.nb[k]] : phi[s.nb[opp(k)]];
    acc += T(wk(k)) * (v - pc);
  }
  lap[i] = T(6) * acc;
}

// Two blocks of 256 threads per SM in float32 (at most 128 registers a
// thread, no spills), which ran faster on an H100 than the compiler's own
// choice of 150-170 registers and one block (PERF.md); in float64 the cap
// would spill, so there it stays at one block.
template <typename T>
__global__ void __launch_bounds__(256, sizeof(T) == 4 ? 2 : 1)
collide_stream_kernel(
    const T* __restrict__ f, const T* __restrict__ g,
    const T* __restrict__ phi, const T* __restrict__ lap,
    const float* __restrict__ mask, T* __restrict__ fo, T* __restrict__ go,
    int ny, int nx, HCZConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!(mask[i] > 0.5f)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      fo[k * n + i] = T(0);
      go[k * n + i] = T(0);
    }
    return;
  }
  const Nbr s = neighbours(i, ny, nx);
  bool nbf[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) nbf[k] = mask[s.nb[k]] > 0.5f;

  // ---- macroscopic fields at r ----
  T fk[9], gk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    fk[k] = f[k * n + i];
    gk[k] = g[k * n + i];
  }
  T Pterm = gk[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) Pterm += gk[k];
  const T phi_c = phi[i];
  const T rho = rho_of_phi(phi_c, c);

  // ---- mirrored stencils: ∇ψρ, ∇ψφ, ∇ρ, ∇(∇²φ) ----
  T ph[9], lp[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    ph[k] = phi[s.nb[k]];
    lp[k] = lap[s.nb[k]];
  }
  T gprx = T(0), gpry = T(0), gppx = T(0), gppy = T(0);
  T grx = T(0), gry = T(0), glx = T(0), gly = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const T vphi = nbf[k] ? ph[k] : ph[opp(k)];
    const T vlap = nbf[k] ? lp[k] : lp[opp(k)];
    const T vrho = rho_of_phi(vphi, c);
    const T vpr = cs_psi(vrho, c);
    const T vpp = cs_psi(vphi, c);
    if (cx(k)) {
      const T w = T(wk(k) * cx(k));
      gprx += w * vpr;
      gppx += w * vpp;
      grx += w * vrho;
      glx += w * vlap;
    }
    if (cy(k)) {
      const T w = T(wk(k) * cy(k));
      gpry += w * vpr;
      gppy += w * vpp;
      gry += w * vrho;
      gly += w * vlap;
    }
  }
  gprx *= T(3); gpry *= T(3);
  gppx *= T(3); gppy *= T(3);
  grx *= T(3); gry *= T(3);
  glx *= T(3); gly *= T(3);

  // ---- force, velocity, total pressure ----
  const T Fx = T(c.kappa) * rho * glx + T(c.gx) * rho + T(c.Gx_const);
  const T Fy = T(c.kappa) * rho * gly + T(c.gravity) * rho;
  T momx = T(0), momy = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (cx(k)) momx += T(cx(k)) * gk[k];
    if (cy(k)) momy += T(cy(k)) * gk[k];
  }
  const T rho3 = rho * T(1.0 / 3.0);
  const T ux = (momx + Fx * T(1.0 / 6.0)) / rho3;
  const T uy = (momy + Fy * T(1.0 / 6.0)) / rho3;
  const T P = Pterm + T(0.5 / 3.0) * (ux * grx + uy * gry);

  // ---- equilibria, forcing, BGK of f and g ----
  const T usqr = T(1.5) * (ux * ux + uy * uy);
  const T inv_phi = T(1) / phi_c;
  const T half = T(c.half);
  const T uF = ux * Fx + uy * Fy;
  const T uE = ux * gprx + uy * gpry;
  const T uG = ux * gppx + uy * gppy;
  const T om = T(c.omega), om1 = T(c.one_minus_omega);
  T pf[9], pg[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T w = T(wk(k));
    const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
    const T eqf = phi_c * w * (T(1) + T(3) * cu + T(4.5) * cu * cu - usqr);
    const T eqg = w * (P + rho3 * (T(3) * cu + T(4.5) * cu * cu - usqr));
    const T e_u_F = (T(cx(k)) * Fx + T(cy(k)) * Fy) - uF;
    const T e_u_E = (T(cx(k)) * gprx + T(cy(k)) * gpry) - uE;
    const T e_u_G = (T(cx(k)) * gppx + T(cy(k)) * gppy) - uG;
    const T eqf_over = eqf * inv_phi;
    const T fg = half * (e_u_F * eqf_over + (-e_u_E) * (eqf_over - w));
    const T ff = half * (-e_u_G) * T(3) * eqf_over;
    pf[k] = om1 * fk[k] + om * eqf + ff;
    pg[k] = om1 * gk[k] + om * eqg + fg;
  }

  // ---- push streaming with on-site bounce-back ----
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) {
      fo[4 * n + i] = pf[4];
      go[4 * n + i] = pg[4];
    } else if (nbf[k]) {
      fo[k * n + s.nb[k]] = pf[k];
      go[k * n + s.nb[k]] = pg[k];
    } else {
      fo[opp(k) * n + i] = pf[k];
      go[opp(k) * n + i] = pg[k];
    }
  }
}

template <typename T>
int launch_step(const T* f, const T* g, T* fo, T* go, T* phi, T* lap,
                const float* mask, int ny, int nx, const HCZConst* c,
                cudaStream_t stream) {
  const size_t n = (size_t)ny * nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  phi_kernel<T><<<blocks, threads, 0, stream>>>(f, phi, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lap_kernel<T><<<blocks, threads, 0, stream>>>(phi, mask, lap, ny, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  collide_stream_kernel<T><<<blocks, threads, 0, stream>>>(
      f, g, phi, lap, mask, fo, go, ny, nx, *c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One step: (f, g) (9, ny, nx) each → (fo, go); phi and lap are (ny, nx)
// scratch; mask is the (ny, nx) float32 fluid mask (1 fluid / 0 solid).
// Returns the cudaError_t of the launches (0 on success).
int hcz_step_f32(const void* f, const void* g, void* fo, void* go, void* phi,
                 void* lap, const void* mask, int ny, int nx,
                 const void* consts, void* stream) {
  return launch_step<float>((const float*)f, (const float*)g, (float*)fo,
                            (float*)go, (float*)phi, (float*)lap,
                            (const float*)mask, ny, nx,
                            (const HCZConst*)consts, (cudaStream_t)stream);
}

int hcz_step_f64(const void* f, const void* g, void* fo, void* go, void* phi,
                 void* lap, const void* mask, int ny, int nx,
                 const void* consts, void* stream) {
  return launch_step<double>((const double*)f, (const double*)g, (double*)fo,
                             (double*)go, (double*)phi, (double*)lap,
                             (const float*)mask, ny, nx,
                             (const HCZConst*)consts, (cudaStream_t)stream);
}

}  // extern "C"
