// HCZ phase-field D3Q19 step on a fully periodic box (order parameter f,
// pressure g; Carnahan–Starling EOS; Guo-type forcing; BGK of f and g;
// periodic streaming) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_hcz3d.py:_make_kernel (the Pallas
// TPU kernel behind pallas_hcz3d.run_fused_3d) and computes what its
// step_block computes (pallas_hcz3d.py:115-233), one step per call of
// hcz3d_step_f32/_f64:
//   φ = Σf, P_term = Σg, ρ = ρ_g + (φ − φ_g)·Δρ/Δφ, ψφ (CS minus φ/3),
//   ∇²φ, ∇ψφ, ∇(∇²φ), F = κφ∇∇²φ + (0, gravity ρ, 0),
//   u = (Σ c g + F/6)/(ρ/3), P = P_term − ½ u·∇ψφ, the E field
//   ∇(P − ρ/3) of the materialised P, f_eq and g_eq, the forcing terms (the
//   phase forcing divides by ρ, not φ as in 2D), BGK of f and g, then
//   periodic streaming.
// Unlike the Pallas kernel it also runs in float64.
//
// Bound: device memory.  A step must read f and g and write them back:
// 4 × 19 × 4 B = 304 B per cell in float32, 637.5 MB per step at 128³, so
// at 3.35 TB/s (H100 SXM data sheet) no step takes less than 0.19 ms
// (11,000 MLUPS).
//
// Design (simple and right first; the Pallas z-stripes, halo slabs, stacked
// rolls and temporal blocking were VMEM constraints and are not carried
// over).  One thread per cell, x, y and z wrap by index.  P must exist at
// the neighbours before E can be taken, so a step is four launches:
//   1. phi_kernel: φ = Σ_k f_k into a (nz, ny, nx) scratch (76 B read, 4 B
//      written per cell).
//   2. lap_kernel: ∇²φ into a second scratch (φ read, ∇²φ written; the
//      neighbourhood comes from cache).
//   3. pressure_kernel: reads g, φ and ∇²φ of the 18 neighbours, forms u
//      and writes P (76 + 8 B read, 4 B written).
//   4. collide_stream_kernel: reads f and g, recomputes u exactly as
//      launch 3 does (from g, which it needs anyway), reads P and φ of the
//      18 neighbours for E, collides f and g and PUSHES each post_k to
//      (r + c_k, k); every output slot is written exactly once, which is
//      the Pallas pull rule new_k(r) = post_k(r − c_k).  (152 B read,
//      152 B written, 12 B of scratch fields per cell.)
// About 492 B per cell per step in all.  The wrapper ping-pongs two pairs
// of buffers, so input and output never alias.
#include <cuda_runtime.h>
#include <stddef.h>

// Model constants, filled by multiphase_lbm_tpu_torch/ops/hcz_fused.py
// (_HCZConst, same field order as in hcz_step.cu; gx and Gx_const are
// unused in 3D).
struct HCZConst3 {
  double omega, one_minus_omega, half;  // half = 1 − ω/2
  double phi_g, rho_g, drho_dphi;       // ρ = ρ_g + (φ − φ_g)·drho_dphi
  double a, b_quarter;                  // Carnahan–Starling a and b/4
  double kappa, gravity, gx, Gx_const;
};

namespace {

// D3Q19 ordering of the phase-field 3D module
// (multiphase_lbm_tpu/core/lattice.py): nine "negative-half" directions
// (-1,0,0) (0,-1,0) (0,0,-1) (-1,-1,0) (-1,1,0) (-1,0,-1) (-1,0,1)
// (0,-1,-1) (0,-1,1), rest at k = 9, then their mirrors at k + 10.
__host__ __device__ __forceinline__ constexpr int cx_lo(int k) {
  return -(k == 0 || k == 3 || k == 4 || k == 5 || k == 6);
}
__host__ __device__ __forceinline__ constexpr int cy_lo(int k) {
  return (k == 4) - (k == 1 || k == 3 || k == 7 || k == 8);
}
__host__ __device__ __forceinline__ constexpr int cz_lo(int k) {
  return (k == 6 || k == 8) - (k == 2 || k == 5 || k == 7);
}
__host__ __device__ __forceinline__ constexpr int cx(int k) {
  return k == 9 ? 0 : (k < 9 ? cx_lo(k) : -cx_lo(k - 10));
}
__host__ __device__ __forceinline__ constexpr int cy(int k) {
  return k == 9 ? 0 : (k < 9 ? cy_lo(k) : -cy_lo(k - 10));
}
__host__ __device__ __forceinline__ constexpr int cz(int k) {
  return k == 9 ? 0 : (k < 9 ? cz_lo(k) : -cz_lo(k - 10));
}
__host__ __device__ __forceinline__ constexpr double wk(int k) {
  return k == 9 ? 1.0 / 3.0
                : ((cx(k) != 0) + (cy(k) != 0) + (cz(k) != 0) == 1
                       ? 1.0 / 18.0
                       : 1.0 / 36.0);
}

template <typename T>
__device__ __forceinline__ T rho_of_phi(T phi, const HCZConst3& c) {
  return T(c.rho_g) + (phi - T(c.phi_g)) * T(c.drho_dphi);
}

// ψ(r) = p_CS(r) − r/3 with one divide, as pallas_hcz3d.py:53-58 forms it.
template <typename T>
__device__ __forceinline__ T cs_psi(T r, const HCZConst3& c) {
  const T rt = r * T(c.b_quarter);
  const T om = T(1) - rt;
  return (r * T(1.0 / 3.0)) * (T(1) + rt + rt * rt - rt * rt * rt) /
             (om * om * om) -
         T(c.a) * r * r - r * T(1.0 / 3.0);
}

// Cell i = (z·ny + y)·nx + x; nb(k) is r + c_k, wrapping on every axis.
struct Nbr3 {
  int xs[3], ys[3], zs[3], ny, nx;
  __device__ __forceinline__ size_t nb(int k) const {
    return ((size_t)zs[cz(k) + 1] * ny + ys[cy(k) + 1]) * nx + xs[cx(k) + 1];
  }
};

__device__ __forceinline__ Nbr3 neighbours(size_t i, int nz, int ny, int nx) {
  Nbr3 s;
  s.ny = ny;
  s.nx = nx;
  const size_t plane = (size_t)ny * nx;
  const int z = (int)(i / plane);
  const size_t r = i - (size_t)z * plane;
  const int y = (int)(r / nx);
  const int x = (int)(r - (size_t)y * nx);
  s.xs[0] = x == 0 ? nx - 1 : x - 1; s.xs[1] = x; s.xs[2] = x == nx - 1 ? 0 : x + 1;
  s.ys[0] = y == 0 ? ny - 1 : y - 1; s.ys[1] = y; s.ys[2] = y == ny - 1 ? 0 : y + 1;
  s.zs[0] = z == 0 ? nz - 1 : z - 1; s.zs[1] = z; s.zs[2] = z == nz - 1 ? 0 : z + 1;
  return s;
}

template <typename T>
__global__ void phi_kernel(const T* __restrict__ f, T* __restrict__ phi,
                           size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = f[i];
#pragma unroll
  for (int k = 1; k < 19; ++k) s += f[k * n + i];
  phi[i] = s;
}

template <typename T>
__global__ void lap_kernel(const T* __restrict__ phi, T* __restrict__ lap,
                           int nz, int ny, int nx) {
  const size_t n = (size_t)nz * ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Nbr3 s = neighbours(i, nz, ny, nx);
  const T pc = phi[i];
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 19; ++k) {
    if (k == 9) continue;
    acc += T(wk(k)) * (phi[s.nb(k)] - pc);
  }
  lap[i] = T(6) * acc;
}

// What launches 3 and 4 both need at r: ρ, u, ∇ψφ, F and P_term, from the
// 19 g of the cell and the φ and ∇²φ neighbourhoods.  One function, so that
// launch 4 recomputes launch 3's u bit for bit.
template <typename T>
struct Macro {
  T rho, ux, uy, uz, gppx, gppy, gppz, Fx, Fy, Fz, Pterm;
};

template <typename T>
__device__ __forceinline__ Macro<T> macro(const T (&gk)[19], T phi_c,
                                          const T* __restrict__ phi,
                                          const T* __restrict__ lap,
                                          const Nbr3& s, const HCZConst3& c) {
  Macro<T> m;
  T Pterm = gk[0], momx = T(0), momy = T(0), momz = T(0);
#pragma unroll
  for (int k = 0; k < 19; ++k) {
    if (k) Pterm += gk[k];
    if (cx(k)) momx += T(cx(k)) * gk[k];
    if (cy(k)) momy += T(cy(k)) * gk[k];
    if (cz(k)) momz += T(cz(k)) * gk[k];
  }
  T gx = T(0), gy = T(0), gz = T(0), lx = T(0), ly = T(0), lz = T(0);
#pragma unroll
  for (int k = 0; k < 19; ++k) {
    if (k == 9) continue;
    const size_t j = s.nb(k);
    const T pp = cs_psi(phi[j], c);
    const T lp = lap[j];
    if (cx(k)) { const T w = T(wk(k) * cx(k)); gx += w * pp; lx += w * lp; }
    if (cy(k)) { const T w = T(wk(k) * cy(k)); gy += w * pp; ly += w * lp; }
    if (cz(k)) { const T w = T(wk(k) * cz(k)); gz += w * pp; lz += w * lp; }
  }
  m.gppx = T(3) * gx; m.gppy = T(3) * gy; m.gppz = T(3) * gz;
  m.rho = rho_of_phi(phi_c, c);
  const T kphi = T(c.kappa) * phi_c;
  m.Fx = kphi * (T(3) * lx);
  m.Fy = kphi * (T(3) * ly) + T(c.gravity) * m.rho;
  m.Fz = kphi * (T(3) * lz);
  const T rho3 = m.rho * T(1.0 / 3.0);
  m.ux = (momx + m.Fx * T(1.0 / 6.0)) / rho3;
  m.uy = (momy + m.Fy * T(1.0 / 6.0)) / rho3;
  m.uz = (momz + m.Fz * T(1.0 / 6.0)) / rho3;
  m.Pterm = Pterm;
  return m;
}

template <typename T>
__global__ void pressure_kernel(const T* __restrict__ g,
                                const T* __restrict__ phi,
                                const T* __restrict__ lap, T* __restrict__ P,
                                int nz, int ny, int nx, HCZConst3 c) {
  const size_t n = (size_t)nz * ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Nbr3 s = neighbours(i, nz, ny, nx);
  T gk[19];
#pragma unroll
  for (int k = 0; k < 19; ++k) gk[k] = g[k * n + i];
  const Macro<T> m = macro(gk, phi[i], phi, lap, s, c);
  // total_P (laplace3D.h:318-330): P_term − ½ u·∇ψφ
  P[i] = m.Pterm - T(0.5) * (m.ux * m.gppx + m.uy * m.gppy + m.uz * m.gppz);
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
    const T* __restrict__ P, T* __restrict__ fo, T* __restrict__ go, int nz,
    int ny, int nx, HCZConst3 c) {
  const size_t n = (size_t)nz * ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Nbr3 s = neighbours(i, nz, ny, nx);
  T gk[19];
#pragma unroll
  for (int k = 0; k < 19; ++k) gk[k] = g[k * n + i];
  const T phi_c = phi[i];
  const Macro<T> m = macro(gk, phi_c, phi, lap, s, c);
  const T Pc = P[i];

  // E field: ∇(P − ρ/3) of the materialised P (laplace3D.h:333-337)
  T ex = T(0), ey = T(0), ez = T(0);
#pragma unroll
  for (int k = 0; k < 19; ++k) {
    if (k == 9) continue;
    const size_t j = s.nb(k);
    const T v = P[j] - rho_of_phi(phi[j], c) * T(1.0 / 3.0);
    if (cx(k)) ex += T(wk(k) * cx(k)) * v;
    if (cy(k)) ey += T(wk(k) * cy(k)) * v;
    if (cz(k)) ez += T(wk(k) * cz(k)) * v;
  }
  ex *= T(3); ey *= T(3); ez *= T(3);

  const T ux = m.ux, uy = m.uy, uz = m.uz;
  const T usqr = T(1.5) * (ux * ux + uy * uy + uz * uz);
  const T inv_phi = T(1) / phi_c;
  const T inv_rho = T(1) / m.rho;
  const T rho3 = m.rho * T(1.0 / 3.0);
  const T half = T(c.half);
  const T uF = ux * m.Fx + uy * m.Fy + uz * m.Fz;
  const T uE = ux * ex + uy * ey + uz * ez;
  const T uG = ux * m.gppx + uy * m.gppy + uz * m.gppz;
  const T om = T(c.omega), om1 = T(c.one_minus_omega);
#pragma unroll
  for (int k = 0; k < 19; ++k) {
    const T w = T(wk(k));
    const T ckx = T(cx(k)), cky = T(cy(k)), ckz = T(cz(k));
    const T cu = ckx * ux + cky * uy + ckz * uz;
    const T eqf = phi_c * w * (T(1) + T(3) * cu + T(4.5) * cu * cu - usqr);
    const T eqg = w * (Pc + rho3 * (T(3) * cu + T(4.5) * cu * cu - usqr));
    const T e_u_F = (ckx * m.Fx + cky * m.Fy + ckz * m.Fz) - uF;
    const T e_u_E = (ckx * ex + cky * ey + ckz * ez) - uE;
    const T e_u_G = (ckx * m.gppx + cky * m.gppy + ckz * m.gppz) - uG;
    const T eqf_over = eqf * inv_phi;
    const T fg = half * (e_u_F * eqf_over + (-e_u_E) * (eqf_over - w));
    // 3D phase forcing divides by ρ (laplace3D.h:608)
    const T ff = half * (-e_u_G) * T(3) * eqf * inv_rho;
    const size_t dst = k * n + (k == 9 ? i : s.nb(k));
    fo[dst] = om1 * f[k * n + i] + om * eqf + ff;
    go[dst] = om1 * gk[k] + om * eqg + fg;
  }
}

template <typename T>
int launch_step(const T* f, const T* g, T* fo, T* go, T* phi, T* lap, T* P,
                int nz, int ny, int nx, const HCZConst3* c,
                cudaStream_t stream) {
  const size_t n = (size_t)nz * ny * nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  phi_kernel<T><<<blocks, threads, 0, stream>>>(f, phi, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lap_kernel<T><<<blocks, threads, 0, stream>>>(phi, lap, nz, ny, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pressure_kernel<T><<<blocks, threads, 0, stream>>>(g, phi, lap, P, nz, ny,
                                                     nx, *c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  collide_stream_kernel<T><<<blocks, threads, 0, stream>>>(
      f, g, phi, lap, P, fo, go, nz, ny, nx, *c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One step: (f, g) (19, nz, ny, nx) each → (fo, go); phi, lap and P are
// (nz, ny, nx) scratch.  Returns the cudaError_t of the launches (0 on
// success).
int hcz3d_step_f32(const void* f, const void* g, void* fo, void* go,
                   void* phi, void* lap, void* P, int nz, int ny, int nx,
                   const void* consts, void* stream) {
  return launch_step<float>((const float*)f, (const float*)g, (float*)fo,
                            (float*)go, (float*)phi, (float*)lap, (float*)P,
                            nz, ny, nx, (const HCZConst3*)consts,
                            (cudaStream_t)stream);
}

int hcz3d_step_f64(const void* f, const void* g, void* fo, void* go,
                   void* phi, void* lap, void* P, int nz, int ny, int nx,
                   const void* consts, void* stream) {
  return launch_step<double>((const double*)f, (const double*)g, (double*)fo,
                             (double*)go, (double*)phi, (double*)lap,
                             (double*)P, nz, ny, nx, (const HCZConst3*)consts,
                             (cudaStream_t)stream);
}

}  // extern "C"
