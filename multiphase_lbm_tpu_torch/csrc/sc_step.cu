// Shan–Chen D2Q9 step (Yuan–CS or constant-G pseudopotential, BGK or
// rank-2 MRT, velocity-shift forcing, bounce-back streaming) for NVIDIA
// Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_sc.py:_make_kernel (the Pallas TPU
// kernel behind pallas_sc.run_fused and step_fused_halo) and computes what
// models/shan_chen.step computes, one launch a step:
//   ρ = Σf (one reciprocal, floored at 1e-14), u, ψ(ρ) — Yuan–CS with its
//   G₁ = ±c_s² branch and p_shift, or the constant-G form
//   ψ = √max(2 (c_s²ρ − (P_eos(ρ) + p_shift)) / (|G| c_s²), 0) with G₁ = G
//   (models/shan_chen.py:88-96) — the wall ψ_w (Yuan: on the centre node's
//   branch or on ρ_w's own; constant G: ψ(ρ_w)), the 8-neighbour force
//   with fluid ψ plus ψ_w at solid neighbours, F_x += gx·ρ + gx_u and
//   F_y += gravity·ρ + gy_u (in that order), feq at u + τF/ρ, BGK or
//   post = feq − (ω−1)(mi7·(m7·dneq) + mi8·(m8·dneq)), then streaming with
//   on-site bounce-back, solid cells held at zero.
// nvcc contracts a*b+c into FMAs; no fast-math, so sqrt and division stay
// IEEE.
//
// Bound: device memory.  A step must read the 9 populations of every cell
// and write 9 back: at least 72 B per cell in float32 (302 MB per step at
// 2048²; the walled path also reads its 4 B mask), so at 3.35 TB/s (H100
// SXM data sheet) no 2048² step takes less than 0.090 ms.
//
// Design (the Pallas 8-row halos, lane-whole stripes, wrap-case DMAs and
// temporal blocking were Mosaic constraints and are not carried over).  One
// launch a step; a block of 256 threads owns a tile of TILE_Y × TILE_X
// cells, x fastest, so that a warp is one row of the tile and its loads and
// pushed stores coalesce.  Two stages, separated by one __syncthreads:
//   1. over the tile plus a 1-cell ring (the force reads ψ one cell away),
//      ρ, ψ(ρ) and the fluid flag into shared memory, once a cell: each
//      thread takes its own cell, keeping its populations, ρ and (Yuan)
//      the G₁ branch bit in registers, then the ring's 84 cells are shared
//      out (their f comes mostly from L2, where the neighbouring tiles read
//      it).
//   2. each thread takes its own cell: u from its populations, the force
//      from the shared ψ and flags, the collide, then PUSHES each post_k
//      to (r + c_k, k) when that cell is fluid, or bounces it back to
//      (r, opp k).  Solid cells write zeros to their own 9 slots.  Every
//      output slot is written exactly once, so the push is race-free and
//      equals the pull rule of models/shan_chen.step,
//        new_k(r) = fluid(r − c_k) ? post_k(r − c_k) : post_{opp k}(r),
//      times fluid(r).
// The two-launch form it replaces (a ψ pass, then a collide that read ψ
// and the populations again) moved about 116 B a cell; this one moves the
// 72 B (76 walled) plus the ring's re-reads, L2 hits.  Measured at 2048²
// periodic MRT float32 (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W):
// 0.126–0.130 ms a step, 69–71% of the bound, where the two launches took
// 0.190–0.192.  Two alternatives measured slower in one call and were not
// kept: reading the own populations again after the barrier (1–2%), and
// colliding the tile plus its ring into shared memory, then pulling with
// aligned stores (32%: it loads the populations of 1.33 cells and forms ψ
// for 1.69 a cell).
// Every lattice index wraps modulo nx and ny with a true modulo, so a ring
// wider than the lattice (3 × 5, a 1-column lattice) reads the right cells,
// and a tile that overhangs the lattice's edge loads wrapped cells there:
// they serve as ring of the cells beside them and write nothing.  Each
// cell's values go through one code path wherever it sits in a tile, so a
// slab of the decomposition computes bit for bit what the whole lattice
// does.  Indices are 32-bit: the wrapper (ops/_grid.launch_geometry) and
// run_steps refuse 9 · ny · nx >= 2^31.  run_steps launches n_steps times
// on the caller's stream, ping-ponging two buffers, so a call costs one
// host crossing.
#include <cuda_runtime.h>

// Model constants, filled by multiphase_lbm_tpu_torch/ops/sc_fused.py
// (_SCConst, same field order).  Doubles, converted to the working type in
// the kernel exactly as JAX casts Python floats into a float32 kernel.
struct SCConst {
  double R, Tt, RT, a, cs2, p_shift;
  double wall_c;        // 6 ρ_w (R T Z(ρ_w) − a ρ_w − c_s²) + 6 p_shift
  double psi_w_fixed;   // Yuan ψ(ρ_w) on ρ_w's own branch
  double G, absG_cs2;   // constant-G coupling and |G| c_s²
  double psi_w_cg;      // constant-G ψ(ρ_w)
  double gx, gravity, gx_u, gy_u;
  double tau, omega, one_minus_omega, omega_minus_one;
  double m7[9], m8[9], mi7[9], mi8[9];  // rows 7, 8 of MRT_M_I; cols of its inverse
  int center_branch, mrt, psi_mode;     // psi_mode: 0 Yuan–CS, 1 constant G
};

namespace {

// The block tile (ops/sc_fused.TILE mirrors it) and its box, the tile plus
// a 1-cell ring.
constexpr int TILE_X = 32, TILE_Y = 8;
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int BX = TILE_X + 2, BY = TILE_Y + 2;
constexpr int RING = BX * BY - THREADS;

// D2Q9 module ordering (rest at k = 4), multiphase_lbm_tpu/core/lattice.py:
// c_k = (-1,0) (0,-1) (-1,-1) (-1,1) (0,0) (1,0) (0,1) (1,1) (1,-1).  As
// functions of k, so that every unrolled loop folds them to constants.
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
__device__ __forceinline__ T floor0(T v) {  // max(v, 0), NaN propagates
  return v < T(0) ? T(0) : v;
}

// v mod n in [0, n) for any v and n >= 1.
__device__ __forceinline__ int wrap(int v, int n) {
  if ((unsigned)v < (unsigned)n) return v;
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// The 9 populations of cell i and ρ = f0 + f1 + … + f8 (the same sum for
// the own cell and for a ring cell).
template <typename T>
__device__ __forceinline__ T load_cell(const T* __restrict__ f, int n, int i,
                                       T (&fk)[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) fk[k] = f[k * n + i];
  T rho = fk[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += fk[k];
  return rho;
}

// ψ(ρ) and, for Yuan–CS, its G₁ branch (pos: G₁ = +c_s²).  Yuan follows
// eos.yuan_psi with 1/G₁ = ±3; constant G follows psi_cg of
// models/shan_chen.sc_force.
template <typename T, bool CONST_G>
__device__ __forceinline__ T psi_of(T rho, const SCConst& c, bool* pos) {
  const T d = T(1) - rho;
  const T Z = T(1) + (T(4) * rho - T(2) * rho * rho) / (d * d * d);
  const T P = rho * T(c.R) * T(c.Tt) * Z - T(c.a) * rho * rho;
  if (CONST_G) {
    *pos = false;
    const T S = T(c.cs2) * rho - (P + T(c.p_shift));
    return sqrt(floor0(T(2) * S / T(c.absG_cs2)));
  }
  *pos = T(c.RT) * Z - T(c.a) * rho - T(c.cs2) > T(0);
  const T inv_G1 = *pos ? T(3) : T(-3);
  return sqrt(floor0(T(6) * (P + T(c.p_shift) - T(c.cs2) * rho) * inv_G1));
}

// Position r of the box's ring (the box less the tile) as (by, bx): its top
// row, its bottom row, then one cell at each end of the tile's rows.
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

// Six blocks of 256 threads per SM in float32 (48 warps, no spills), two in
// float64.  Measured at 2048² f32 (PERF.md §6): 4 and 5 blocks ran 7%
// and 2% slower, 8 spilled and ran 12% slower.
template <typename T, bool PERIODIC, bool CONST_G>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 6 : 2)
sc_step_kernel(const T* __restrict__ f, const float* __restrict__ mask,
               T* __restrict__ out, int ny, int nx, SCConst c) {
  __shared__ T s_psi[BY * BX];
  __shared__ unsigned char s_fl[BY * BX];

  const int n = ny * nx;
  const int tid = threadIdx.x;
  const int tx = tid % TILE_X, ty = tid / TILE_X;
  const int x0 = blockIdx.x * TILE_X, y0 = blockIdx.y * TILE_Y;
  const bool active = x0 + tx < nx && y0 + ty < ny;
  const int x = wrap(x0 + tx, nx), y = wrap(y0 + ty, ny);
  const int i = y * nx + x;
  const int b = (ty + 1) * BX + tx + 1;

  // ---- stage 1: ρ, ψ and the flag over the box, own cell first ----
  T fk[9];
  const T rho = load_cell(f, n, i, fk);
  bool pos;
  const T psi_c = psi_of<T, CONST_G>(rho, c, &pos);
  const bool fluid = PERIODIC || mask[i] > 0.5f;
  s_psi[b] = psi_c;
  s_fl[b] = fluid;
  for (int r = tid; r < RING; r += THREADS) {
    int by, bx;
    ring_cell(r, by, bx);
    const int j = wrap(y0 + by - 1, ny) * nx + wrap(x0 + bx - 1, nx);
    T v[9];
    bool unused;
    s_psi[by * BX + bx] = psi_of<T, CONST_G>(load_cell(f, n, j, v), c, &unused);
    s_fl[by * BX + bx] = PERIODIC || mask[j] > 0.5f;
  }
  __syncthreads();

  // ---- stage 2: the own cell's force, collide and push ----
  if (!active) return;
  if (!fluid) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k * n + i] = T(0);
    return;
  }
  bool nbf[9];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    nbf[k] = PERIODIC || s_fl[b + cy(k) * BX + cx(k)];

  const T rho_safe = rho < T(1e-14) ? T(1e-14) : rho;
  const T inv_rho = T(1) / rho_safe;
  const T ux = (fk[5] + fk[7] + fk[8] - fk[0] - fk[2] - fk[3]) * inv_rho;
  const T uy = (fk[3] + fk[6] + fk[7] - fk[1] - fk[2] - fk[8]) * inv_rho;

  T G1, psi_w;
  if (CONST_G) {
    G1 = T(c.G);
    psi_w = T(c.psi_w_cg);
  } else {
    G1 = pos ? T(c.cs2) : -T(c.cs2);
    psi_w = c.center_branch ? sqrt(floor0(T(c.wall_c) * (pos ? T(3) : T(-3))))
                            : T(c.psi_w_fixed);
  }
  T sff_x = T(0), sff_y = T(0), sbb_x = T(0), sbb_y = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const T nb_psi = s_psi[b + cy(k) * BX + cx(k)];
    const T ff = nbf[k] ? nb_psi : T(0);
    const T bb = nbf[k] ? T(0) : T(1);
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
    Fx = -G1 * psi_c * sff_x;
    Fy = -G1 * psi_c * sff_y;
  } else {
    Fx = -G1 * psi_c * (sff_x + psi_w * sbb_x);
    Fy = -G1 * psi_c * (sff_y + psi_w * sbb_y);
  }
  Fx = Fx + T(c.gx) * rho + T(c.gx_u);
  Fy = Fy + T(c.gravity) * rho + T(c.gy_u);

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
  const int xs[3] = {x == 0 ? nx - 1 : x - 1, x, x == nx - 1 ? 0 : x + 1};
  const int ys[3] = {y == 0 ? ny - 1 : y - 1, y, y == ny - 1 ? 0 : y + 1};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    int dst;
    if (k == 4)
      dst = 4 * n + i;
    else if (nbf[k])
      dst = k * n + ys[cy(k) + 1] * nx + xs[cx(k) + 1];
    else
      dst = opp(k) * n + i;
    out[dst] = post[k];
  }
}

template <typename T, bool PERIODIC, bool CONST_G>
int launch_steps(const T* f, T* a, T* b, const float* mask, int ny, int nx,
                 int n_steps, const SCConst* c, cudaStream_t stream) {
  const dim3 grid((unsigned)((nx + TILE_X - 1) / TILE_X),
                  (unsigned)((ny + TILE_Y - 1) / TILE_Y));
  for (int s = 0; s < n_steps; ++s) {
    const T* src = s == 0 ? f : ((s & 1) ? a : b);
    T* dst = (s & 1) ? b : a;
    sc_step_kernel<T, PERIODIC, CONST_G><<<grid, THREADS, 0, stream>>>(
        src, mask, dst, ny, nx, *c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int run_steps(const T* f, T* a, T* b, const float* mask, int ny, int nx,
              int periodic, int n_steps, const SCConst* c,
              cudaStream_t stream) {
  const long long tiles_y = (ny + TILE_Y - 1) / TILE_Y;
  if (ny < 1 || nx < 1 || 9LL * ny * nx >= (1LL << 31) || tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  const bool cg = c->psi_mode == 1;
  if (periodic)
    return cg ? launch_steps<T, true, true>(f, a, b, mask, ny, nx, n_steps, c, stream)
              : launch_steps<T, true, false>(f, a, b, mask, ny, nx, n_steps, c, stream);
  return cg ? launch_steps<T, false, true>(f, a, b, mask, ny, nx, n_steps, c, stream)
            : launch_steps<T, false, false>(f, a, b, mask, ny, nx, n_steps, c, stream);
}

}  // namespace

extern "C" {

// n_steps steps of f (9, ny, nx), which is only read: step s writes a when
// s is even and b when s is odd, so the result is in a when n_steps is odd
// and in b when it is even (b may be null when n_steps <= 1).  mask is the
// (ny, nx) float32 fluid mask (1 fluid / 0 solid), unread (and may be null)
// when periodic.  Returns the cudaError_t of the first launch that failed
// (0 on success; cudaErrorInvalidValue, launching nothing, for a lattice of
// 9 · ny · nx >= 2^31 slots or 8 · 65535 rows).
int sc_step_f32(const void* f, void* a, void* b, const void* mask, int ny,
                int nx, int periodic, int n_steps, const void* consts,
                void* stream) {
  return run_steps<float>((const float*)f, (float*)a, (float*)b,
                          (const float*)mask, ny, nx, periodic, n_steps,
                          (const SCConst*)consts, (cudaStream_t)stream);
}

int sc_step_f64(const void* f, void* a, void* b, const void* mask, int ny,
                int nx, int periodic, int n_steps, const void* consts,
                void* stream) {
  return run_steps<double>((const double*)f, (double*)a, (double*)b,
                           (const float*)mask, ny, nx, periodic, n_steps,
                           (const SCConst*)consts, (cudaStream_t)stream);
}

const char* sc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
