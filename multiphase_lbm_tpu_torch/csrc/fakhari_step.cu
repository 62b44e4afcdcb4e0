// Fakhari conservative phase-field D2Q9 step (h̄ for φ, ḡ for p*; BGK of
// both with the interface-sharpening and force terms; periodic streaming;
// post-stream field refresh; stale-u velocity update) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_fakhari.py:_make_kernel (the
// Pallas TPU kernel behind pallas_fakhari.run_fused) and computes what its
// step_block computes (pallas_fakhari.py:207-264):
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
// Design (the Pallas 8-row halos, nsub stripes, roll factorisation and
// float32 scratch were Mosaic constraints and are not carried over).  One
// launch a step.  The velocity update that ends step n and the collision
// that opens step n + 1 read the same fields: φ over the 3 × 3
// neighbourhood of the streamed h, and the streamed g of the cell.  So a
// launch forms them once and does both jobs: it DEFERS each step's velocity
// update into the next launch.  A block of 256 threads owns a tile of
// TILE_Y × TILE_X cells, x fastest, so that a warp is one row of the tile
// and its loads and pushed stores coalesce.  Two stages, separated by one
// __syncthreads:
//   1. over the tile plus a 1-cell ring, φ = Σ_k h_k into shared memory:
//      each thread sums its own cell, keeping its h in registers, then the
//      ring's 84 cells are shared out (their h comes mostly from L2, where
//      the neighbouring tiles read it).
//   2. each thread takes its own cell: its g and u (loaded here: loading
//      them with h in stage 1 measured 1–3% slower at 2048², PERF.md), the
//      fields once (derive_fields, φ and its stencils from shared memory),
//      then, unless the launch opens a call (mode FIRST: the call's input u
//      is already fresh), the deferred update u = Σ c g + F(u_stored)/(2ρ)
//      at the stored, stale u; the force at that u, the collision of h and
//      g, and a PUSH of each post_k to (r + c_k, k).  The map r → r + c_k is a bijection of the
//      periodic lattice, so every output slot is written exactly once and
//      the push equals the Pallas pull streaming.  Each launch writes the u
//      it collided with.
// A call of n steps is n launches and one more in mode VELOCITY, which
// stops after the update and writes only u: the call returns the state in
// its canonical form (h, g and the fresh u), as the plain path does.  The
// mode is a runtime argument of one kernel, so the velocity pass and the
// update inside a step are the same instructions: k calls of one step give
// the state of one call of k steps, bit for bit.
// Bytes: h 36 + g 36 + u 8 read and h 36 + g 36 + u 8 written, 160 B a cell
// a step in float32 (the ring's extra h reads are L2 hits); the velocity
// pass reads 80 B and writes 8 once a call.  The three-launch form it
// replaces (collide-and-stream, a φ pass into a scratch field, a velocity
// pass) moved about 252 B a cell a step.
// Every lattice index wraps modulo nx and ny with a true modulo, so a ring
// wider than the lattice (a 1-column or 1-row lattice) reads the right
// cells, and a tile that overhangs the lattice's edge loads wrapped cells
// there: they serve as ring of the cells beside them and write nothing.
// Each cell's values go through one code path wherever it sits in a tile,
// so a slab of the decomposition computes bit for bit what the whole
// lattice does.  Indices are 32-bit: the wrapper (ops/_grid.
// launch_geometry) and launch refuse 9 · ny · nx >= 2^31.  The wrapper
// ping-pongs two (h, g, u) triples, so input and output never alias.
#include <cuda_runtime.h>

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

// The block tile (ops/fakhari_fused.TILE mirrors it) and its box, the tile
// plus the 1-cell ring over which φ is formed.
constexpr int TILE_X = 32, TILE_Y = 8;
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int BX = TILE_X + 2, BY = TILE_Y + 2;
constexpr int RING = BX * BY - THREADS;

// What a launch does (the C entry's mode; ops/fakhari_fused.py mirrors it):
// FIRST collides at the input u; STEP updates u first; VELOCITY only
// updates u.
constexpr int FIRST = 0, STEP = 1, VELOCITY = 2;

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

// v mod n in [0, n) for any v and n >= 1.
__device__ __forceinline__ int wrap(int v, int n) {
  if ((unsigned)v < (unsigned)n) return v;
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// Σ_k v_k in k order (the same sum for the own cell and for a ring cell).
template <typename T>
__device__ __forceinline__ T sum9(const T (&v)[9]) {
  T s = v[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) s += v[k];
  return s;
}

// Position r of the ring (the box less the tile) as (by, bx): its top row,
// its bottom row, then the two ends of the tile's rows.
__device__ __forceinline__ void ring_cell(int r, int& by, int& bx) {
  if (r < 2 * BX) {
    by = r < BX ? 0 : TILE_Y + 1;
    bx = r < BX ? r : r - BX;
  } else {
    const int s = r - 2 * BX;
    by = 1 + (s >> 1);
    bx = (s & 1) ? TILE_X + 1 : 0;
  }
}

// The fields of one cell that the collision and the velocity update share.
template <typename T>
struct Fields {
  T C, P, rho, dCx, dCy, mu;
};

// φ, ∇φ, μ from the φ of the box around box cell b; p* and ρ
// (derive_fields).
template <typename T>
__device__ __forceinline__ Fields<T> derive_fields(const T* s_phi, int b,
                                                   const T* gk,
                                                   const FakhariConst& c) {
  Fields<T> d;
  d.C = s_phi[b];
  T gx = T(0), gy = T(0), lap = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const T v = s_phi[b + cy(k) * BX + cx(k)];
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

// Two blocks of 256 threads per SM in float32 (at most 128 registers a
// thread), as for the HCZ collide kernel, where the cap ran 1.49× faster on
// an H100 than the compiler's own choice (PERF.md); in float64 the cap
// would spill, so there it stays at one block.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
fakhari_step_kernel(const T* __restrict__ h, const T* __restrict__ g,
                    const T* __restrict__ u, T* __restrict__ ho,
                    T* __restrict__ go, T* __restrict__ uo, int ny, int nx,
                    int mode, FakhariConst c) {
  __shared__ T s_phi[BY * BX];

  const int n = ny * nx;
  const int tid = threadIdx.x;
  const int tx = tid % TILE_X, ty = tid / TILE_X;
  const int x0 = blockIdx.x * TILE_X, y0 = blockIdx.y * TILE_Y;
  const bool active = x0 + tx < nx && y0 + ty < ny;
  const int x = wrap(x0 + tx, nx), y = wrap(y0 + ty, ny);
  const int i = y * nx + x;

  // ---- stage 1: φ over the box, own cell first ----
  T hk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) hk[k] = h[k * n + i];
  const int b = (ty + 1) * BX + tx + 1;
  s_phi[b] = sum9(hk);
  for (int r = tid; r < RING; r += THREADS) {
    int by, bx;
    ring_cell(r, by, bx);
    const int j = wrap(y0 + by - 1, ny) * nx + wrap(x0 + bx - 1, nx);
    T v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = h[k * n + j];
    s_phi[by * BX + bx] = sum9(v);
  }
  __syncthreads();

  // ---- stage 2: the own cell's fields, deferred update, collide, push ----
  if (!active) return;
  T gk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) gk[k] = g[k * n + i];
  T ux = u[i], uy = u[n + i];
  const Fields<T> d = derive_fields(s_phi, b, gk, c);
  if (mode != FIRST) {
    T Fx, Fy;
    total_force(gk, d, ux, uy, c, &Fx, &Fy);
    const T momx = gk[5] + gk[7] + gk[8] - gk[0] - gk[2] - gk[3];
    const T momy = gk[3] + gk[6] + gk[7] - gk[1] - gk[2] - gk[8];
    const T rho_eps = d.rho + T(EPS_C);
    ux = momx + T(0.5) * Fx / rho_eps;
    uy = momy + T(0.5) * Fy / rho_eps;
  }
  uo[i] = ux;
  uo[n + i] = uy;
  if (mode == VELOCITY) return;

  T Fx, Fy;
  total_force(gk, d, ux, uy, c, &Fx, &Fy);
  const T inv_norm = T(1) / sqrt(d.dCx * d.dCx + d.dCy * d.dCy + T(1e-32));
  const T nxv = d.dCx * inv_norm, nyv = d.dCy * inv_norm;
  const T shape = (T(1) - T(4) * ((d.C - T(0.5)) * (d.C - T(0.5)))) / T(c.W);
  const T inv_rho = T(1) / (d.rho + T(EPS_C));
  const T usqr = T(1.5) * (ux * ux + uy * uy);
  const T wc = T(c.wc), wc1 = T(c.one_minus_wc);
  const T s8 = T(c.s8), s81 = T(c.one_minus_s8);
  const int xs[3] = {x == 0 ? nx - 1 : x - 1, x, x == nx - 1 ? 0 : x + 1};
  const int ys[3] = {y == 0 ? ny - 1 : y - 1, y, y == ny - 1 ? 0 : y + 1};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int dst = k * n + ys[cy(k) + 1] * nx + xs[cx(k) + 1];
    const T w = T(wk(k));
    const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
    const T GaWa = w * (T(3) * cu + T(4.5) * cu * cu - usqr);  // Γ_k − w_k
    // g: equilibrium with the force term
    const T geq = d.P * w + GaWa;
    const T eF = T(cx(k)) * Fx + T(cy(k)) * Fy;
    const T hlp_g = T(3) * w * eF * inv_rho;
    go[dst] = s81 * gk[k] + s8 * (geq - T(0.5) * hlp_g) + hlp_g;
    // h: equilibrium with the sharpening term
    const T proj = T(cx(k)) * nxv + T(cy(k)) * nyv;
    const T hlp_h = w * shape * proj;
    const T heq = d.C * (w + GaWa) - T(0.5) * hlp_h;
    ho[dst] = wc1 * hk[k] + wc * heq + hlp_h;
  }
}

template <typename T>
int launch(const T* h, const T* g, const T* u, T* ho, T* go, T* uo, int ny,
           int nx, int mode, const FakhariConst* c, cudaStream_t stream) {
  const long long tiles_y = (ny + TILE_Y - 1) / TILE_Y;
  if (ny < 1 || nx < 1 || 9LL * ny * nx >= (1LL << 31) || tiles_y > 65535 ||
      mode < FIRST || mode > VELOCITY)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nx + TILE_X - 1) / TILE_X), (unsigned)tiles_y);
  fakhari_step_kernel<T><<<grid, THREADS, 0, stream>>>(h, g, u, ho, go, uo,
                                                       ny, nx, mode, *c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on (h, g) (9, ny, nx) and u (2, ny, nx), which are only read.
// mode 0 (FIRST) and 1 (STEP) write the streamed (ho, go) and the u the
// step collided with to uo: the input u in mode 0, the deferred update of
// the input u in mode 1.  mode 2 (VELOCITY) writes only uo, the updated u
// (ho and go may be null).  A call of n steps is mode 0, n − 1 times mode
// 1, then mode 2.  Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue, launching nothing, for a lattice of
// 9 · ny · nx >= 2^31 slots or 8 · 65535 rows, or another mode).
int fakhari_step_f32(const void* h, const void* g, const void* u, void* ho,
                     void* go, void* uo, int ny, int nx, int mode,
                     const void* consts, void* stream) {
  return launch<float>((const float*)h, (const float*)g, (const float*)u,
                       (float*)ho, (float*)go, (float*)uo, ny, nx, mode,
                       (const FakhariConst*)consts, (cudaStream_t)stream);
}

int fakhari_step_f64(const void* h, const void* g, const void* u, void* ho,
                     void* go, void* uo, int ny, int nx, int mode,
                     const void* consts, void* stream) {
  return launch<double>((const double*)h, (const double*)g,
                        (const double*)u, (double*)ho, (double*)go,
                        (double*)uo, ny, nx, mode,
                        (const FakhariConst*)consts, (cudaStream_t)stream);
}

}  // extern "C"
