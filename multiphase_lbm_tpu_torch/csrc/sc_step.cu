// Shan–Chen D2Q9 step (Yuan–CS pseudopotential, BGK or rank-2 MRT,
// velocity-shift forcing, bounce-back streaming) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_sc.py:_make_kernel (the Pallas TPU
// kernel behind pallas_sc.run_fused) and computes what its step_block
// computes (pallas_sc.py:96-196), one step per call of sc_step_f32/_f64:
//   ρ (one reciprocal, floored at 1e-14), u, Yuan Z and the G₁ branch,
//   ψ with p_shift, wall ψ on the centre node's branch (or ρ_w's own),
//   the 8-neighbour force with masked fluid ψ plus ψ_w at solid neighbours,
//   gx·ρ and gravity·ρ, feq at u + τF/ρ, BGK or
//   post = feq − (ω−1)(mi7·(m7·dneq) + mi8·(m8·dneq)),
//   then streaming with on-site bounce-back, solid cells held at zero.
// The operations and their order follow the Pallas kernel, so float32
// results agree with it to rounding (nvcc contracts a*b+c into FMAs; no
// fast-math, so sqrt and division stay IEEE).
//
// Bound: device memory.  A step must read the 9 populations of every cell
// and write 9 back: at least 72 B per cell in float32 (302 MB per step at
// 2048²), so the ceiling is the card's bandwidth / 72 B — about 46.5 G
// cell updates/s on an H100 SXM data sheet (3.35 TB/s).
//
// Design (simple and correct first; the Pallas 8-row halos, lane-whole
// stripes, wrap-case DMAs and temporal blocking were Mosaic constraints and
// are not carried over).  Two launches per step:
//   1. psi_kernel: one thread per cell, ψ(ρ) into a (ny, nx) scratch field
//      (36 B read + 4 B written per cell).
//   2. collide_stream_kernel: one thread per cell; reads its 9
//      populations, the 9 ψ of its neighbourhood (mostly L1/L2 hits) and,
//      for walls, the mask; collides; then PUSHES each post_k to
//      (r + c_k, k) when that cell is fluid, or bounces it back to
//      (r, opp k).  Solid cells write zeros to their own 9 slots.  Every
//      (cell, k) output slot is written exactly once, so the push is
//      race-free and equals the Pallas pull rule
//        new_k(r) = fluid(r−c_k) ? post_k(r−c_k) : post_{opp k}(r).
// About 116 B per cell per step in all.  x and y both wrap.  The wrapper
// ping-pongs two buffers, so input and output never alias.
#include <cuda_runtime.h>
#include <stddef.h>

// Model constants, filled by multiphase_lbm_tpu_torch/ops/sc_fused.py
// (_SCConst, same field order).  Doubles, converted to the working type in
// the kernel exactly as JAX casts Python floats into a float32 kernel.
struct SCConst {
  double R, Tt, RT, a, cs2, p_shift;
  double wall_c;        // 6 ρ_w (R T Z(ρ_w) − a ρ_w − c_s²) + 6 p_shift
  double psi_w_fixed;   // ψ(ρ_w) on ρ_w's own branch
  double gx, gravity, tau, omega, one_minus_omega, omega_minus_one;
  double m7[9], m8[9], mi7[9], mi8[9];  // rows 7, 8 of MRT_M_I; cols of its inverse
  int center_branch, mrt;
};

// D2Q9 module ordering (rest at k = 4), multiphase_lbm_tpu/core/lattice.py:
// c_k = (-1,0) (0,-1) (-1,-1) (-1,1) (0,0) (1,0) (0,1) (1,1) (1,-1).  As
// functions of k, so that every unrolled loop folds them to constants.
__device__ __forceinline__ constexpr int cx(int k) {
  return (k == 5 || k == 7 || k == 8) - (k == 0 || k == 2 || k == 3);
}
__device__ __forceinline__ constexpr int cy(int k) {
  return (k == 3 || k == 6 || k == 7) - (k == 1 || k == 2 || k == 8);
}
__device__ __forceinline__ constexpr int opp(int k) {  // 5 6 7 8 4 0 1 2 3
  return k == 4 ? 4 : (k < 4 ? k + 5 : k - 5);
}
__device__ __forceinline__ constexpr double wk(int k) {
  return k == 4 ? 4.0 / 9.0 : ((cx(k) != 0 && cy(k) != 0) ? 1.0 / 36.0 : 1.0 / 9.0);
}

template <typename T>
__device__ __forceinline__ T floor0(T v) {  // max(v, 0), NaN propagates
  return v < T(0) ? T(0) : v;
}

// Loads the 9 populations of cell i and returns ρ = f0 + f1 + … + f8.
template <typename T>
__device__ __forceinline__ T cell_density(const T* __restrict__ f, size_t n,
                                          size_t i, T* fk) {
#pragma unroll
  for (int k = 0; k < 9; ++k) fk[k] = f[k * n + i];
  T rho = fk[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += fk[k];
  return rho;
}

// Yuan–CS ψ(ρ) and its G₁ branch (pallas_sc.py:115-122).
template <typename T>
__device__ __forceinline__ T yuan_psi(T rho, const SCConst& c, bool* pos) {
  const T d = T(1) - rho;
  const T Z = T(1) + (T(4) * rho - T(2) * rho * rho) / (d * d * d);
  const T s = T(c.RT) * Z - T(c.a) * rho - T(c.cs2);
  *pos = s > T(0);
  const T inv_G1 = *pos ? T(3) : T(-3);
  const T P = rho * T(c.R) * T(c.Tt) * Z - T(c.a) * rho * rho + T(c.p_shift);
  return sqrt(floor0(T(6) * (P - T(c.cs2) * rho) * inv_G1));
}

template <typename T>
__global__ void psi_kernel(const T* __restrict__ f, T* __restrict__ psi,
                           size_t n, SCConst c) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T fk[9];
  bool pos;
  psi[i] = yuan_psi(cell_density(f, n, i, fk), c, &pos);
}

template <typename T, bool PERIODIC>
__global__ void collide_stream_kernel(const T* __restrict__ f,
                                      const T* __restrict__ psi,
                                      const float* __restrict__ mask,
                                      T* __restrict__ out, int ny, int nx,
                                      SCConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = (int)(i / nx);
  const int x = (int)(i - (size_t)y * nx);
  const int xs[3] = {x == 0 ? nx - 1 : x - 1, x, x == nx - 1 ? 0 : x + 1};
  const int ys[3] = {y == 0 ? ny - 1 : y - 1, y, y == ny - 1 ? 0 : y + 1};
  size_t nb[9];  // cell r + c_k
#pragma unroll
  for (int k = 0; k < 9; ++k)
    nb[k] = (size_t)ys[cy(k) + 1] * nx + xs[cx(k) + 1];

  if (!PERIODIC && !(mask[i] > 0.5f)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k * n + i] = T(0);
    return;
  }

  // ---- macroscopic fields ----
  T fk[9];
  const T rho = cell_density(f, n, i, fk);
  const T rho_safe = rho < T(1e-14) ? T(1e-14) : rho;
  const T inv_rho = T(1) / rho_safe;
  const T ux = (fk[5] + fk[7] + fk[8] - fk[0] - fk[2] - fk[3]) * inv_rho;
  const T uy = (fk[3] + fk[6] + fk[7] - fk[1] - fk[2] - fk[8]) * inv_rho;

  // ---- Yuan–CS pseudopotential + force ----
  bool pos;
  (void)yuan_psi(rho, c, &pos);
  const T psi_c = psi[i];
  const T G1 = pos ? T(c.cs2) : -T(c.cs2);
  const T inv_G1 = pos ? T(3) : T(-3);
  const T psi_w = c.center_branch ? sqrt(floor0(T(c.wall_c) * inv_G1))
                                  : T(c.psi_w_fixed);
  T sff_x = T(0), sff_y = T(0), sbb_x = T(0), sbb_y = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    T ff = psi[nb[k]];
    T bb = T(0);
    if (!PERIODIC) {
      const T nb_m = T(mask[nb[k]]);
      ff = nb_m * ff;
      bb = T(1) - nb_m;
    }
    if (cx(k)) {
      const T wc = T(wk(k) * cx(k));
      sff_x += wc * ff;
      if (!PERIODIC) sbb_x += wc * bb;
    }
    if (cy(k)) {
      const T wc = T(wk(k) * cy(k));
      sff_y += wc * ff;
      if (!PERIODIC) sbb_y += wc * bb;
    }
  }
  T Fx, Fy;
  if (PERIODIC) {
    Fx = -G1 * psi_c * sff_x + T(c.gx) * rho;
    Fy = -G1 * psi_c * sff_y + T(c.gravity) * rho;
  } else {
    Fx = -G1 * psi_c * (sff_x + psi_w * sbb_x) + T(c.gx) * rho;
    Fy = -G1 * psi_c * (sff_y + psi_w * sbb_y) + T(c.gravity) * rho;
  }

  // ---- collision at the shifted velocity ----
  const T tau = T(c.tau);
  const T uex = ux + tau * Fx * inv_rho;
  const T uey = uy + tau * Fy * inv_rho;
  const T usqr = T(1.5) * (uex * uex + uey * uey);
  T post[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T cu = T(cx(k)) * uex + T(cy(k)) * uey;
    post[k] = rho * T(wk(k)) * (T(1) + T(3) * cu + T(4.5) * cu * cu - usqr);
  }
  if (c.mrt) {
    T mom7 = T(0), mom8 = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T dneq = fk[k] - post[k];
      if (c.m7[k] != 0.0) mom7 += T(c.m7[k]) * dneq;
      if (c.m8[k] != 0.0) mom8 += T(c.m8[k]) * dneq;
    }
    const T r7 = T(c.omega_minus_one) * mom7;
    const T r8 = T(c.omega_minus_one) * mom8;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      post[k] = post[k] - (T(c.mi7[k]) * r7 + T(c.mi8[k]) * r8);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k)
      post[k] = T(c.one_minus_omega) * fk[k] + T(c.omega) * post[k];
  }

  // ---- push streaming with on-site bounce-back ----
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) {
      out[4 * n + i] = post[4];
    } else if (PERIODIC || mask[nb[k]] > 0.5f) {
      out[k * n + nb[k]] = post[k];
    } else {
      out[opp(k) * n + i] = post[k];
    }
  }
}

template <typename T>
static int launch_step(const T* f, T* out, T* psi, const float* mask, int ny,
                       int nx, int periodic, const SCConst* c,
                       cudaStream_t stream) {
  const size_t n = (size_t)ny * nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  psi_kernel<T><<<blocks, threads, 0, stream>>>(f, psi, n, *c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (periodic)
    collide_stream_kernel<T, true>
        <<<blocks, threads, 0, stream>>>(f, psi, mask, out, ny, nx, *c);
  else
    collide_stream_kernel<T, false>
        <<<blocks, threads, 0, stream>>>(f, psi, mask, out, ny, nx, *c);
  return (int)cudaGetLastError();
}

extern "C" {

// One step: f (9, ny, nx) → out (9, ny, nx); psi is (ny, nx) scratch; mask
// is the (ny, nx) float32 fluid mask (1 fluid / 0 solid), unread when
// periodic.
// Returns the cudaError_t of the launches (0 on success).
int sc_step_f32(const void* f, void* out, void* psi, const void* mask, int ny,
                int nx, int periodic, const void* consts, void* stream) {
  return launch_step<float>((const float*)f, (float*)out, (float*)psi,
                            (const float*)mask, ny, nx, periodic,
                            (const SCConst*)consts, (cudaStream_t)stream);
}

int sc_step_f64(const void* f, void* out, void* psi, const void* mask, int ny,
                int nx, int periodic, const void* consts, void* stream) {
  return launch_step<double>((const double*)f, (double*)out, (double*)psi,
                             (const float*)mask, ny, nx, periodic,
                             (const SCConst*)consts, (cudaStream_t)stream);
}

const char* sc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
