// HCZ phase-field D2Q9 step (order parameter f, pressure g; Carnahan–
// Starling EOS; mirrored stencils at walls; Guo-type forcing; BGK of f and
// g; bounce-back streaming) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_hcz.py:_make_kernel (the Pallas
// TPU kernel behind pallas_hcz.run_fused and step_fused_halo) and computes
// what its step_block computes (pallas_hcz.py:139-261), one launch a step:
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
// Design (the Pallas 8-row halos, lane-whole stripes, stacked rolls and
// temporal blocking were Mosaic constraints and are not carried over).  One
// launch a step; a block owns a tile of TILE_Y × TILE_X cells, x fastest,
// so that a warp is one row of the tile and its loads and pushed stores
// coalesce.  Three stages, separated by __syncthreads:
//   1. over the tile plus a 2-cell halo, φ = Σ_k f_k and the fluid flag
//      into shared memory: each thread sums its own cell, then the halo
//      ring is shared out (its f comes mostly from L2, where the
//      neighbouring tiles read it).  A uniform row-by-row pass over the
//      36 × 12 box, whose warps straddle rows, measured 6% slower.
//   2. over the tile plus a 1-cell halo, ρ, ψρ, ψφ and ∇²φ (mirrored reads,
//      at solid cells too, as the plain path forms it) once per cell into
//      shared memory: 2 Carnahan–Starling divides per cell and about 1.3
//      evaluations per tile cell, where the three-launch form took 16 per
//      cell, 2 for each of its 8 neighbours.
//   3. each thread takes its own cell: its f (again, from L2: keeping the
//      stage-1 values live across the barriers measured slower) and its g,
//      the mirrored gradients ∇ψρ, ∇ψφ, ∇ρ and ∇(∇²φ) from shared memory,
//      the collide, then PUSHES each post_k to (r + c_k, k) when that cell
//      is fluid, or bounces it back to (r, opp k).  Solid cells write zeros
//      to their own 18 slots.  Every output slot is written exactly once,
//      so the push is race-free and equals the Pallas pull rule
//        new_k(r) = fluid(r − c_k) ? post_k(r − c_k) : post_{opp k}(r),
//      times fluid(r).
// Every lattice index wraps modulo nx and ny with a true modulo, so a halo
// wider than the lattice (3 × 5, a 5-row slab) reads the right cells, and a
// tile that overhangs the lattice's edge loads wrapped cells there: they
// serve as halo of the cells beside them and write nothing.  Each cell's
// values go through one code path wherever it sits in a tile, so a slab of
// the decomposition computes bit for bit what the whole lattice does.
// Indices are 32-bit: the wrapper (ops/_grid.launch_geometry) and
// run_steps refuse 9 · ny · nx >= 2^31.  DRAM traffic is close to the
// 148 B bound: f, g and the mask in, f and g out; the halo's extra f reads
// are L2 hits.  run_steps launches n_steps times on the caller's stream,
// ping-ponging two buffer pairs, so a call costs one host crossing.
//
// The record (hcz_record_kernel, the C entries hcz_record_*): the drivers'
// energy and spike/bubble record of one state in one launch over the same
// tiles, through the same stage 1 and 2 code (phi_box, fields_box), then u
// alone in the own cell, a block sum and a fixed-order total in the last
// block; the host reads back three doubles instead of φ and the plain
// diagnostics' fields.
#include <cuda_runtime.h>

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

// The block tile (ops/hcz_fused.TILE mirrors it) and its two halo boxes:
// H, 2 cells wide (φ and the flag), and G, 1 cell wide (ρ, ψρ, ψφ, ∇²φ).
constexpr int TILE_X = 32, TILE_Y = 8;
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int HX = TILE_X + 4, HY = TILE_Y + 4;
constexpr int GX = TILE_X + 2, GY = TILE_Y + 2;
constexpr int RING = HX * HY - THREADS;

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

// v mod n in [0, n) for any v and n >= 1.
__device__ __forceinline__ int wrap(int v, int n) {
  if ((unsigned)v < (unsigned)n) return v;
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// φ of one cell: Σ_k f_k in k order (the same sum for the own cell and
// for a halo cell).
template <typename T>
__device__ __forceinline__ T sum9(const T (&v)[9]) {
  T s = v[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) s += v[k];
  return s;
}

// Position r of the H box's ring (the H box less the tile) as (hy, hx):
// its two top rows, its two bottom rows, then two cells at each end of the
// tile's rows.
__device__ __forceinline__ void ring_cell(int r, int& hy, int& hx) {
  if (r < 4 * HX) {
    const int row = r / HX;
    hy = row < 2 ? row : TILE_Y + row;
    hx = r - row * HX;
  } else {
    const int s = r - 4 * HX;
    hy = 2 + s / 4;
    const int e = s % 4;
    hx = e < 2 ? e : TILE_X + e;
  }
}

// Stage 1 of both kernels: φ and the fluid flag over the H box (the tile
// plus 2 cells) into shared memory, the own cell i = (y0 + ty, x0 + tx)
// first, then the halo ring shared out over the block.
template <typename T>
__device__ __forceinline__ void phi_box(const T* __restrict__ f,
                                        const float* __restrict__ mask,
                                        T* s_phi, unsigned char* s_fl, int n,
                                        int i, int tid, int tx, int ty,
                                        int x0, int y0, int ny, int nx) {
  {
    T v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = f[k * n + i];
    s_phi[(ty + 2) * HX + tx + 2] = sum9(v);
    s_fl[(ty + 2) * HX + tx + 2] = mask[i] > 0.5f;
  }
  for (int r = tid; r < RING; r += THREADS) {
    int hy, hx;
    ring_cell(r, hy, hx);
    const int j = wrap(y0 + hy - 2, ny) * nx + wrap(x0 + hx - 2, nx);
    T v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = f[k * n + j];
    s_phi[hy * HX + hx] = sum9(v);
    s_fl[hy * HX + hx] = mask[j] > 0.5f;
  }
}

// Stage 2 of both kernels: ρ and ∇²φ (mirrored reads, at solid cells too,
// as the plain path forms it) over the G box (the tile plus 1 cell), once
// a cell; with PSI also ψρ and ψφ, which only the step reads.
template <typename T, bool PSI>
__device__ __forceinline__ void fields_box(const T* s_phi,
                                           const unsigned char* s_fl,
                                           T* s_rho, T* s_pr, T* s_pp,
                                           T* s_lap, int tid,
                                           const HCZConst& c) {
  for (int r = tid; r < GX * GY; r += THREADS) {
    const int gy = r / GX, gx = r - gy * GX;
    const int h = (gy + 1) * HX + gx + 1;
    const T pc = s_phi[h];
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (k == 4) continue;
      const int o = cy(k) * HX + cx(k);
      const T v = s_fl[h + o] ? s_phi[h + o] : s_phi[h - o];
      acc += T(wk(k)) * (v - pc);
    }
    s_lap[r] = T(6) * acc;
    const T rho = rho_of_phi(pc, c);
    s_rho[r] = rho;
    if constexpr (PSI) {
      s_pr[r] = cs_psi(rho, c);
      s_pp[r] = cs_psi(pc, c);
    }
  }
}

// Three blocks of 256 threads per SM in float32: 80 registers, no spills,
// 24 warps (the three-launch collide ran 16).  Four blocks fit 64
// registers without spilling but ran slower at RTI-2048 (PERF.md); in
// float64 one block.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 3 : 1)
hcz_step_kernel(const T* __restrict__ f, const T* __restrict__ g,
                const float* __restrict__ mask, T* __restrict__ fo,
                T* __restrict__ go, int ny, int nx, HCZConst c) {
  __shared__ T s_phi[HY * HX];
  __shared__ unsigned char s_fl[HY * HX];
  __shared__ T s_rho[GY * GX], s_pr[GY * GX], s_pp[GY * GX], s_lap[GY * GX];

  const int n = ny * nx;
  const int tid = threadIdx.x;
  const int tx = tid % TILE_X, ty = tid / TILE_X;
  const int x0 = blockIdx.x * TILE_X, y0 = blockIdx.y * TILE_Y;
  const bool active = x0 + tx < nx && y0 + ty < ny;
  const int x = wrap(x0 + tx, nx), y = wrap(y0 + ty, ny);
  const int i = y * nx + x;

  // ---- stage 1: φ and the flag over the H box, own cell first ----
  phi_box(f, mask, s_phi, s_fl, n, i, tid, tx, ty, x0, y0, ny, nx);
  __syncthreads();
  // ---- stage 2: ρ, ψρ, ψφ and ∇²φ over the G box, once per cell ----
  fields_box<T, true>(s_phi, s_fl, s_rho, s_pr, s_pp, s_lap, tid, c);
  __syncthreads();

  // ---- stage 3: the own cell's collide and push ----
  if (!active) return;
  const int hc = (ty + 2) * HX + tx + 2;
  if (!s_fl[hc]) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      fo[k * n + i] = T(0);
      go[k * n + i] = T(0);
    }
    return;
  }
  // the own populations: f read again (from L2, where stage 1 left it)
  T fk[9], gk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    fk[k] = __ldcg(&f[k * n + i]);
    gk[k] = g[k * n + i];
  }
  bool nbf[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) nbf[k] = s_fl[hc + cy(k) * HX + cx(k)];

  // ---- macroscopic fields at r ----
  T Pterm = gk[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) Pterm += gk[k];
  const int gc = (ty + 1) * GX + tx + 1;
  const T phi_c = s_phi[hc];
  const T rho = s_rho[gc];

  // ---- mirrored stencils: ∇ψρ, ∇ψφ, ∇ρ, ∇(∇²φ) ----
  T gprx = T(0), gpry = T(0), gppx = T(0), gppy = T(0);
  T grx = T(0), gry = T(0), glx = T(0), gly = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const int o = cy(k) * GX + cx(k);
    const int j = gc + (nbf[k] ? o : -o);
    const T vrho = s_rho[j], vpr = s_pr[j], vpp = s_pp[j], vlap = s_lap[j];
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

  // ---- equilibria, forcing, BGK of f and g, push streaming ----
  const T usqr = T(1.5) * (ux * ux + uy * uy);
  const T inv_phi = T(1) / phi_c;
  const T half = T(c.half);
  const T uF = ux * Fx + uy * Fy;
  const T uE = ux * gprx + uy * gpry;
  const T uG = ux * gppx + uy * gppy;
  const T om = T(c.omega), om1 = T(c.one_minus_omega);
  const int xs[3] = {x == 0 ? nx - 1 : x - 1, x, x == nx - 1 ? 0 : x + 1};
  const int ys[3] = {y == 0 ? ny - 1 : y - 1, y, y == ny - 1 ? 0 : y + 1};
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
    const T pf = om1 * fk[k] + om * eqf + ff;
    const T pg = om1 * gk[k] + om * eqg + fg;
    int dst;
    if (k == 4)
      dst = 4 * n + i;
    else if (nbf[k])
      dst = k * n + ys[cy(k) + 1] * nx + xs[cx(k) + 1];
    else
      dst = opp(k) * n + i;
    fo[dst] = pf;
    go[dst] = pg;
  }
}

// Sum of e and the largest h0 and h1 over the block, in a fixed order:
// the shuffle tree within each warp, then the warps in turn, on thread 0
// (the other threads keep partial values).  Every thread of the block
// must call it.
__device__ __forceinline__ void block_reduce(double& e, int& h0, int& h1,
                                             double* s_e, int* s_h,
                                             int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    e += __shfl_down_sync(0xffffffffu, e, o);
    const int a0 = __shfl_down_sync(0xffffffffu, h0, o);
    const int a1 = __shfl_down_sync(0xffffffffu, h1, o);
    h0 = a0 > h0 ? a0 : h0;
    h1 = a1 > h1 ? a1 : h1;
  }
  if (tid % 32 == 0) {
    s_e[tid / 32] = e;
    s_h[2 * (tid / 32)] = h0;
    s_h[2 * (tid / 32) + 1] = h1;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      e += s_e[w];
      h0 = s_h[2 * w] > h0 ? s_h[2 * w] : h0;
      h1 = s_h[2 * w + 1] > h1 ? s_h[2 * w + 1] : h1;
    }
  }
}

// The record of one state (what models/hcz.kinetic_energy and
// interface_heights compute from it), in one launch over the step's tiles:
// stages 1 and 2 as in the step (ψ left out), then each fluid cell's
//   u = (Σ c g + F/6)/(ρ/3),  F = κρ∇∇²φ + (gx ρ + Gx_const, gravity ρ),
// exactly as stage 3 of the step forms it, and |u|² summed in double; and,
// for the spike column x = nx/2 and the bubble column x = 0, the largest y
// in [1, ny − 2] with φ ≤ φ_mid (0 if none).  Each block leaves its sum and
// its two heights in part and hpart; the last block to finish (a counter
// the entry zeroes) adds the sums up in block order and writes
// out = [½ Σ|u|² / (ny·nx), spike height, bubble height].  No float
// atomics: the same state gives the same bits.  Reads f and the mask once
// (the halo's re-reads hit L2) and 8 of the 9 g: 72 B a cell in float32.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 3 : 1)
hcz_record_kernel(const T* __restrict__ f, const T* __restrict__ g,
                  const float* __restrict__ mask, int ny, int nx,
                  HCZConst c, double phi_mid, double* __restrict__ part,
                  int* __restrict__ hpart, unsigned* __restrict__ done,
                  double* __restrict__ out) {
  __shared__ T s_phi[HY * HX];
  __shared__ unsigned char s_fl[HY * HX];
  __shared__ T s_rho[GY * GX], s_lap[GY * GX];
  __shared__ double s_e[THREADS / 32];
  __shared__ int s_h[2 * (THREADS / 32)];
  __shared__ bool s_last;

  const int n = ny * nx;
  const int tid = threadIdx.x;
  const int tx = tid % TILE_X, ty = tid / TILE_X;
  const int x0 = blockIdx.x * TILE_X, y0 = blockIdx.y * TILE_Y;
  const bool active = x0 + tx < nx && y0 + ty < ny;
  const int x = wrap(x0 + tx, nx), y = wrap(y0 + ty, ny);
  const int i = y * nx + x;

  phi_box(f, mask, s_phi, s_fl, n, i, tid, tx, ty, x0, y0, ny, nx);
  __syncthreads();
  fields_box<T, false>(s_phi, s_fl, s_rho, nullptr, nullptr, s_lap, tid, c);
  __syncthreads();

  // ---- the own cell's |u|² and its part in the heights ----
  const int hc = (ty + 2) * HX + tx + 2;
  double e = 0.0;
  int h0 = 0, h1 = 0;
  const int spike_x = nx / 2;
  if (active && y >= 1 && y <= ny - 2 && s_phi[hc] <= T(phi_mid)) {
    if (x == spike_x) h0 = y;
    if (x == 0) h1 = y;
  }
  if (active && s_fl[hc]) {
    T gk[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (k != 4) gk[k] = g[k * n + i];
    const int gc = (ty + 1) * GX + tx + 1;
    const T rho = s_rho[gc];
    T glx = T(0), gly = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (k == 4) continue;
      const int o = cy(k) * GX + cx(k);
      const T vlap = s_lap[gc + (s_fl[hc + cy(k) * HX + cx(k)] ? o : -o)];
      if (cx(k)) glx += T(wk(k) * cx(k)) * vlap;
      if (cy(k)) gly += T(wk(k) * cy(k)) * vlap;
    }
    glx *= T(3);
    gly *= T(3);
    const T Fx = T(c.kappa) * rho * glx + T(c.gx) * rho + T(c.Gx_const);
    const T Fy = T(c.kappa) * rho * gly + T(c.gravity) * rho;
    T momx = T(0), momy = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (cx(k)) momx += T(cx(k)) * gk[k];
      if (cy(k)) momy += T(cy(k)) * gk[k];
    }
    const T rho3 = rho * T(1.0 / 3.0);
    const double ux = (momx + Fx * T(1.0 / 6.0)) / rho3;
    const double uy = (momy + Fy * T(1.0 / 6.0)) / rho3;
    e = ux * ux + uy * uy;
  }

  // ---- the block's part, then the last block's fixed-order total ----
  block_reduce(e, h0, h1, s_e, s_h, tid);
  const int nb = gridDim.x * gridDim.y;
  if (tid == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    part[b] = e;
    hpart[2 * b] = h0;
    hpart[2 * b + 1] = h1;
    __threadfence();
    s_last = atomicAdd(done, 1u) == (unsigned)nb - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  e = 0.0;
  h0 = h1 = 0;
  for (int b = tid; b < nb; b += THREADS) e += __ldcg(&part[b]);
  // a column's heights come from the blocks of its tile column
  for (int by = tid; by < (int)gridDim.y; by += THREADS) {
    const int v0 = __ldcg(&hpart[2 * (by * gridDim.x + spike_x / TILE_X)]);
    const int v1 = __ldcg(&hpart[2 * by * gridDim.x + 1]);
    h0 = v0 > h0 ? v0 : h0;
    h1 = v1 > h1 ? v1 : h1;
  }
  block_reduce(e, h0, h1, s_e, s_h, tid);
  if (tid == 0) {
    out[0] = 0.5 * e / ((double)ny * nx);
    out[1] = h0;
    out[2] = h1;
  }
}

template <typename T>
int run_steps(const T* f, const T* g, T* fa, T* ga, T* fb, T* gb,
              const float* mask, int ny, int nx, int n_steps,
              const HCZConst* c, cudaStream_t stream) {
  const long long tiles_y = (ny + TILE_Y - 1) / TILE_Y;
  if (ny < 1 || nx < 1 || 9LL * ny * nx >= (1LL << 31) || tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nx + TILE_X - 1) / TILE_X), (unsigned)tiles_y);
  for (int s = 0; s < n_steps; ++s) {
    const T* src_f = s == 0 ? f : ((s & 1) ? fa : fb);
    const T* src_g = s == 0 ? g : ((s & 1) ? ga : gb);
    T* dst_f = (s & 1) ? fb : fa;
    T* dst_g = (s & 1) ? gb : ga;
    hcz_step_kernel<T><<<grid, THREADS, 0, stream>>>(
        src_f, src_g, mask, dst_f, dst_g, ny, nx, *c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The record's launch.  The workspace ws, 2 · (blocks) + 1 doubles, holds
// part (a double a block), hpart (two ints a block) and the counter, which
// is zeroed first.
template <typename T>
int run_record(const T* f, const T* g, const float* mask, double* ws,
               double* out, int ny, int nx, const HCZConst* c,
               double phi_mid, cudaStream_t stream) {
  const long long tiles_y = (ny + TILE_Y - 1) / TILE_Y;
  if (ny < 1 || nx < 1 || 9LL * ny * nx >= (1LL << 31) || tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nx + TILE_X - 1) / TILE_X), (unsigned)tiles_y);
  const long long nb = (long long)grid.x * grid.y;
  int* hpart = (int*)(ws + nb);
  unsigned* done = (unsigned*)(ws + 2 * nb);
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  hcz_record_kernel<T><<<grid, THREADS, 0, stream>>>(
      f, g, mask, ny, nx, *c, phi_mid, ws, hpart, done, out);
  err = cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" {

// n_steps steps of (f, g), each (9, ny, nx), which are only read: step s
// writes (fa, ga) when s is even and (fb, gb) when s is odd, so the result
// is in (fa, ga) when n_steps is odd and in (fb, gb) when it is even
// (fb and gb may be null when n_steps <= 1).  mask is the (ny, nx) float32
// fluid mask (1 fluid / 0 solid).  Returns the cudaError_t of the first
// launch that failed (0 on success; cudaErrorInvalidValue, launching
// nothing, for a lattice of 9 · ny · nx >= 2^31 slots or 8 · 65535 rows).
int hcz_step_f32(const void* f, const void* g, void* fa, void* ga, void* fb,
                 void* gb, const void* mask, int ny, int nx, int n_steps,
                 const void* consts, void* stream) {
  return run_steps<float>((const float*)f, (const float*)g, (float*)fa,
                          (float*)ga, (float*)fb, (float*)gb,
                          (const float*)mask, ny, nx, n_steps,
                          (const HCZConst*)consts, (cudaStream_t)stream);
}

int hcz_step_f64(const void* f, const void* g, void* fa, void* ga, void* fb,
                 void* gb, const void* mask, int ny, int nx, int n_steps,
                 const void* consts, void* stream) {
  return run_steps<double>((const double*)f, (const double*)g, (double*)fa,
                           (double*)ga, (double*)fb, (double*)gb,
                           (const float*)mask, ny, nx, n_steps,
                           (const HCZConst*)consts, (cudaStream_t)stream);
}

// The record of the state (f, g), each (9, ny, nx), with the (ny, nx)
// float32 fluid mask: out (3 doubles) = [½ Σ|u|² over the fluid / (ny·nx),
// the largest y in [1, ny − 2] with φ ≤ phi_mid in the spike column
// x = nx/2, the same in the bubble column x = 0] (a height 0 where there is
// none).  ws holds 2 · ⌈ny/8⌉ · ⌈nx/32⌉ + 1 doubles of workspace (two a
// tile, and the counter).  One memset and one launch on the stream; returns
// the cudaError_t (cudaErrorInvalidValue, launching nothing, for a lattice
// the step refuses).

int hcz_record_f32(const void* f, const void* g, const void* mask, void* ws,
                   void* out, int ny, int nx, const void* consts,
                   double phi_mid, void* stream) {
  return run_record<float>((const float*)f, (const float*)g,
                           (const float*)mask, (double*)ws, (double*)out, ny,
                           nx, (const HCZConst*)consts, phi_mid,
                           (cudaStream_t)stream);
}

int hcz_record_f64(const void* f, const void* g, const void* mask, void* ws,
                   void* out, int ny, int nx, const void* consts,
                   double phi_mid, void* stream) {
  return run_record<double>((const double*)f, (const double*)g,
                            (const float*)mask, (double*)ws, (double*)out, ny,
                            nx, (const HCZConst*)consts, phi_mid,
                            (cudaStream_t)stream);
}

}  // extern "C"
