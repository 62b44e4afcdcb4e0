// Shan–Chen Rayleigh–Taylor D2Q9 step (ψ = 1 − e^(−ρ), fluid–fluid force
// with mirrored ψ reads at the walls, gravity, Guo forcing inside BGK,
// bounce-back streaming, channel walls at rows 0 and ny − 1) for NVIDIA
// Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_scrt.py:_make_kernel (the Pallas
// TPU kernel behind pallas_scrt.run_fused) and computes what its step_block
// computes (pallas_scrt.py:97-171), one step per call of scrt_step_f32/_f64:
//   ρ = Σf, ρ_safe = max(ρ, 1e-14), u = Σ c f / ρ_safe, ψ = 1 − e^(−ρ),
//   F = −g ψ(r) Σ_k w_k c_k ψ_k + (0, gravity·ρ) with ψ_k = ψ(r + c_k), or
//   ψ(r − c_k) where r + c_k is a wall cell, u_eq = u + F/(2ρ_safe), f_eq
//   at u_eq, the Guo source w_k (1 − ω/2) [3(c_k − u_eq)·F + 9 (c_k·u_eq)
//   (c_k·F)], post = (1 − ω) f + ω f_eq + src on fluid rows and 0 on the wall
//   rows, then streaming with on-site bounce-back off the walls.
// The lattice keeps the model's (9, ny, nx) layout: the transpose of
// pallas_scrt.py:12-21 existed only for the TPU's lane alignment.  The
// channel is implied by the row index (fluid iff 1 <= y <= ny − 2), so no
// mask is read; x wraps.  Unlike the Pallas kernel it also runs in float64
// and returns its input's type.
//
// Bound: device memory.  A step must read the 9 populations of every cell
// and write 9 back: 72 B per cell in float32, 1.21 GB per step at
// 2048 × 8194, so at 3.35 TB/s (H100 SXM data sheet) no step takes less
// than 0.36 ms (46,500 MLUPS).
//
// Design (simple and right first; the Pallas 8-row halos, transposed
// stripes and temporal blocking were Mosaic constraints and are not carried
// over).  One thread per cell and two launches per step, as in sc_step.cu:
//   1. psi_kernel: ψ(ρ) into a (ny, nx) scratch field (36 B read, 4 B
//      written per cell).
//   2. collide_stream_kernel: reads its 9 populations and the ψ of its
//      neighbourhood (mostly cache hits), collides, then PUSHES each post_k
//      to (r + c_k, k) when that cell is fluid, or bounces it back to
//      (r, opp k).  Wall cells write zeros to their own 9 slots.  Every
//      output slot is written exactly once, so the push is race-free and
//      equals the Pallas pull rule
//        new_k(r) = fluid(r − c_k) ? post_k(r − c_k) : post_{opp k}(r),
//      times fluid(r).
// About 116 B per cell per step in all.  The wrapper ping-pongs two
// buffers, so input and output never alias.
#include <cuda_runtime.h>
#include <stddef.h>

// Model constants, filled by multiphase_lbm_tpu_torch/ops/scrt_fused.py
// (_SCRTConst, same field order).  Doubles, converted to the working type
// in the kernel exactly as JAX casts Python floats into a float32 kernel.
struct SCRTConst {
  double omega, one_minus_omega;
  double neg_g;     // −g: the fluid–fluid coupling with its sign folded in
  double gravity;
  double src_fac;   // 1 − ω/2, the Guo source prefactor
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
__global__ void psi_kernel(const T* __restrict__ f, T* __restrict__ psi,
                           size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T rho = f[i];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += f[k * n + i];
  psi[i] = T(1) - exp(-rho);
}

template <typename T>
__global__ void collide_stream_kernel(const T* __restrict__ f,
                                      const T* __restrict__ psi,
                                      T* __restrict__ out, int ny, int nx,
                                      SCRTConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = (int)(i / nx);
  const int x = (int)(i - (size_t)y * nx);
  if (y == 0 || y == ny - 1) {  // wall rows hold zeros
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k * n + i] = T(0);
    return;
  }
  // 1 <= y <= ny − 2, so rows y ± 1 exist; a row is fluid iff it is not a
  // wall row
  const int xs[3] = {x == 0 ? nx - 1 : x - 1, x, x == nx - 1 ? 0 : x + 1};
  const int ys[3] = {y - 1, y, y + 1};
  const bool row_fluid[3] = {y - 1 >= 1, true, y + 1 <= ny - 2};
  size_t nb[9];  // cell r + c_k
#pragma unroll
  for (int k = 0; k < 9; ++k)
    nb[k] = (size_t)ys[cy(k) + 1] * nx + xs[cx(k) + 1];

  // ---- macroscopic fields ----
  T fk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) fk[k] = f[k * n + i];
  T rho = fk[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += fk[k];
  const T rho_safe = rho < T(1e-14) ? T(1e-14) : rho;  // NaN propagates
  const T inv_rho = T(1) / rho_safe;
  const T ux = (fk[5] + fk[7] + fk[8] - fk[0] - fk[2] - fk[3]) * inv_rho;
  const T uy = (fk[3] + fk[6] + fk[7] - fk[1] - fk[2] - fk[8]) * inv_rho;

  // ---- fluid–fluid force with mirrored reads, gravity ----
  const T psi_c = psi[i];
  T sx = T(0), sy = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const T v = row_fluid[cy(k) + 1] ? psi[nb[k]] : psi[nb[opp(k)]];
    if (cx(k)) sx += T(wk(k) * cx(k)) * v;
    if (cy(k)) sy += T(wk(k) * cy(k)) * v;
  }
  const T Fx = T(c.neg_g) * psi_c * sx;
  const T Fy = T(c.neg_g) * psi_c * sy + T(c.gravity) * rho;

  // ---- BGK with Guo forcing at u_eq = u + F/(2ρ) ----
  const T uex = ux + T(0.5) * Fx * inv_rho;
  const T uey = uy + T(0.5) * Fy * inv_rho;
  const T usqr = T(1.5) * (uex * uex + uey * uey);
  const T uF = uex * Fx + uey * Fy;
  const T om = T(c.omega), om1 = T(c.one_minus_omega);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T w = T(wk(k));
    const T cu = T(cx(k)) * uex + T(cy(k)) * uey;
    const T feq = rho * w * (T(1) + T(3) * cu + T(4.5) * cu * cu - usqr);
    const T cF = T(cx(k)) * Fx + T(cy(k)) * Fy;
    const T src = w * T(c.src_fac) * (T(3) * (cF - uF) + T(9) * cu * cF);
    const T post = om1 * fk[k] + om * feq + src;
    // ---- push streaming with on-site bounce-back ----
    if (k == 4)
      out[4 * n + i] = post;
    else if (row_fluid[cy(k) + 1])
      out[k * n + nb[k]] = post;
    else
      out[opp(k) * n + i] = post;
  }
}

template <typename T>
int launch_step(const T* f, T* out, T* psi, int ny, int nx,
                const SCRTConst* c, cudaStream_t stream) {
  const size_t n = (size_t)ny * nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  psi_kernel<T><<<blocks, threads, 0, stream>>>(f, psi, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  collide_stream_kernel<T>
      <<<blocks, threads, 0, stream>>>(f, psi, out, ny, nx, *c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One step: f (9, ny, nx) → out (9, ny, nx), ny >= 3; psi is (ny, nx)
// scratch.  Rows 0 and ny − 1 are walls.  Returns the cudaError_t of the
// launches (0 on success).
int scrt_step_f32(const void* f, void* out, void* psi, int ny, int nx,
                  const void* consts, void* stream) {
  return launch_step<float>((const float*)f, (float*)out, (float*)psi, ny, nx,
                            (const SCRTConst*)consts, (cudaStream_t)stream);
}

int scrt_step_f64(const void* f, void* out, void* psi, int ny, int nx,
                  const void* consts, void* stream) {
  return launch_step<double>((const double*)f, (double*)out, (double*)psi, ny,
                             nx, (const SCRTConst*)consts,
                             (cudaStream_t)stream);
}

}  // extern "C"
