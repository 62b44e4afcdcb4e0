// Reactive MRT combustion step (D2Q9, rest-first ordering: flow f, species
// g_O2 and g_CO2, temperature g_T) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_combustion.py:_make_body (the step
// body of the Pallas TPU kernels _make_kernel and _make_striped_kernel
// behind pallas_combustion.run_fused) and computes one make_step of
// multiphase_lbm_tpu/models/combustion.py per step, for the configurations
// that the Pallas kernel admits: the four topologies (inflow/outflow,
// cavity, Couette, Poiseuille), scheme li2014 or none, solid reaction on or
// off, konv on (all four populations) or off (flow only), the first-step
// switch that skips the LI2014 conjugate fix, and the MRT body force.  The
// whole-lattice and y-striped variants of the Pallas kernel were VMEM
// artefacts; one kernel family covers every lattice size here, in float32
// and float64.
//
// Bound: device memory.  A konv step must read f, g_O2, g_CO2, g_T, the
// three previous forcing terms and the LI2014 store g_coll (72 values per
// cell) and write them back: 576 B per cell in float32 (72 B flow only),
// against about 1,500 floating-point operations per cell (five 9 × 9 MRT
// products, the equilibria, the forcing, the gradients and the Arrhenius
// terms).  At the reference's 420 × 80 the whole state is 9.7 MB and fits
// in the 50 MB L2, so the launches and the host set the pace there.
//
// Design (simple and right first).  Three launches a step on one stream:
//   1. boundary_kernel, one block, inflow/outflow only: the boundary phase
//      of the model in its sequential order, in place on the incoming
//      populations, with __syncthreads() between the sub-phases (see the
//      kernel's comment for which sums each one reads);
//   2. fields_kernel, konv only, one thread per cell: the LI2014 conjugate
//      fix of the cell's own incoming g_T entries from g_coll (pull form:
//      each entry has exactly one writer) unless first_step, then ρ, u
//      (with the half-force shift), Y_O2 and Y_CO2 into a field buffer;
//   3. collide_stream_kernel, one thread per cell: reads the fields at
//      reach 2 (the one-sided gradients next to solids), does the five
//      collisions and the forcing, writes the three new forcing terms and
//      the new g_coll, and streams into the other buffer of a ping-pong
//      pair.  Every output slot is written exactly once: the receiving cell
//      writes it where the model's streaming keeps or bounces a value there
//      (its upstream is solid or an interface, the outlet pin, a zeroed
//      non-bulk cell), and otherwise the upstream cell pushes its
//      post-collision value.
// Every neighbour read wraps modulo nx and ny, as the model's rolls do.
// Solid cells carry NaN in u and in the forcing terms, as in the model:
// every mask is a selection, never a product.  The flags, the interface
// normal factors ck_n (small integers, int8) and the momentum-exchange
// populations of the inlet column and the lid row are the only static
// inputs; every link mask is derived from the flags of its two ends.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Model constants, filled by multiphase_lbm_tpu_torch/ops/combustion_fused.py
// (_CombustionConst, same field order).  Doubles, converted to the working
// type in the kernel as PyTorch casts Python floats.
struct CombustionConst {
  double w2[9];               // 2 w_k, the anti-bounce-back factor
  double t367, t76;           // w3 + w7 + w6, w7 + w6 (flow outlet)
  double wsum_bot, wsum_top;  // weight sums of the species outlet corners
  double amp_in[3];           // inlet Y_O2, Y_CO2, T
  double conj_neg_a, conj_a, conj_b2, conj_c2;  // LI2014 factors
  double half_dpdx, half_dpdy, dpdx, dpdy;
  double D_O2, D_CO2;
  double fac_O2, fac_CO2, fac_T;  // (τ − ½)/τ of the forcing terms
  double A_pre, neg_E, R_id;      // kr = A exp(neg_E / (R max(T, 0.01)))
  double half_stoich;             // 0.5 · stoich_O2
  double M_CO2, DM;               // M_CO2, D_CO2 · M_O2
  double M_O2, delta_hr, cp_gas;
  int io, konv, li2014, body_force, solid_reaction;
};

namespace {

enum { BULK = 0, WALL = 1, SPECULAR = 2, OBSTACLE = 3 };
// planes of the (8, 9, ny, nx) state buffer
enum { P_F = 0, P_O2 = 1, P_CO2 = 2, P_T = 3, P_FO2 = 4, P_FCO2 = 5,
       P_FT = 6, P_GCOLL = 7 };
// planes of the (5, ny, nx) field buffer
enum { F_RHO = 0, F_UX = 1, F_UY = 2, F_YO2 = 3, F_YCO2 = 4 };
// matrices: M⁻¹ diag(S) M of flow, O2, CO2, T, T solid, then the body-force
// M⁻¹ diag(1 − S/2) M
constexpr int NMAT = 6;
// threads of the one-block boundary launch (ptxas: 128 registers a thread in
// float32, 156 in float64, under __launch_bounds__(BC_THREADS))
constexpr int BC_THREADS = 256;

// rest-first D2Q9: c_k = (0,0) (1,0) (0,1) (−1,0) (0,−1) (1,1) (−1,1)
// (−1,−1) (1,−1)
__host__ __device__ __forceinline__ constexpr int cx(int k) {
  return (k == 1 || k == 5 || k == 8) - (k == 3 || k == 6 || k == 7);
}
__host__ __device__ __forceinline__ constexpr int cy(int k) {
  return (k == 2 || k == 5 || k == 6) - (k == 4 || k == 7 || k == 8);
}
__host__ __device__ __forceinline__ constexpr int opp(int k) {
  return k == 0 ? 0 : (k <= 4 ? (k + 1) % 4 + 1 : (k - 3) % 4 + 5);
}
__host__ __device__ __forceinline__ constexpr double wk(int k) {
  return k == 0 ? 4.0 / 9.0 : (k <= 4 ? 1.0 / 9.0 : 1.0 / 36.0);
}
// the outlet pin: west-pointing populations of column nx − 1
__host__ __device__ __forceinline__ constexpr bool west(int k) {
  return k == 3 || k == 6 || k == 7;
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// pop − A (pop − eq), A row-major 9 × 9
template <typename T>
__device__ __forceinline__ void mrt(const T* A, const T* pop, const T* eq,
                                    T* post) {
  T d[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k] = pop[k] - eq[k];
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    T s = A[r * 9] * d[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) s += A[r * 9 + k] * d[k];
    post[r] = pop[r] - s;
  }
}

// amp w_k (1 + 3 cu + 4.5 cu² − usqr)
template <typename T>
__device__ __forceinline__ void equilibrium(T amp, T ux, T uy, T usqr,
                                            T* eq) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
    eq[k] = amp * T(wk(k)) * (T(1) + T(3) * cu + T(4.5) * cu * cu - usqr);
  }
}

// ρ and u (with the half-force shift) of one cell's flow populations
template <typename T>
__device__ __forceinline__ void flow_macro(const T* f, const CombustionConst& c,
                                           T& rho, T& ux, T& uy) {
  rho = f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += f[k];
  const T mx = f[1] - f[3] + f[5] - f[6] - f[7] + f[8];
  const T my = f[2] - f[4] + f[5] + f[6] - f[7] - f[8];
  ux = mx / rho;
  uy = my / rho;
  if (c.body_force) {
    ux = ux + T(c.half_dpdx) / rho;
    uy = uy + T(c.half_dpdy) / rho;
  }
}

// ---------------------------------------------------------------------------
// Launch 1: the boundary phase of the inflow/outflow channel, one block.
// In the model's order (models/combustion.py make_step, phase 1):
//   0. flow outlet at x = nx − 1 (apply_flow_outlet): each row from its
//      own entry values and the entry macros of columns nx − 2, nx − 3;
// then, with konv, for g_O2, g_CO2 (species) and g_T (apply_scalar_bcs):
//   A. from the ENTRY sums m: amp_top(x) = (4 m(ny−3, x) − m(ny−4, x))/3,
//      overridden at x = 1 by the sums of column 1 after its inlet fix and
//      at x = nx − 1 by those of column nx − 1 after its outlet fix, and
//      amp_out(y) = (4 m(y, nx−2) − m(y, nx−3))/3, entry-time on purpose;
//   B. the top row ny − 2 (k 7, 4, 8 ← 5, 2, 6) with amp_top;
//   C. amp_bot(x) from the sums of rows 2 and 3 AFTER B, then the bottom
//      row 1 (k 6, 2, 5 ← 8, 4, 7);
//   D. the inlet column 1 (k 5, 1, 8 ← 7, 3, 6) with the inlet value,
//      reading the row-fixed values of B and C;
//   E. the outlet column nx − 1 (k 6, 3, 7 ← 8, 1, 5) with amp_out, every
//      row for g_T, not rows 1 and ny − 2 for the species;
//   F. the species outlet corners (rows 1, ny − 2): the post-fix column
//      nx − 1 and the post-row-fix sums of columns nx − 2, nx − 3, with u
//      from the outlet-fixed flow of step 0.
// Sub-phases are separated by __syncthreads(); the thread loops cover rows
// and columns of any length.
template <typename T>
__global__ void __launch_bounds__(BC_THREADS)
    boundary_kernel(T* __restrict__ s, T* __restrict__ amp_top,
                    T* __restrict__ amp_out, int ny, int nx, CombustionConst c) {
  const size_t n = (size_t)ny * nx;
  const int tid = threadIdx.x, nt = blockDim.x;
  auto at = [&](int plane, int k, int y, int x) -> T& {
    return s[((size_t)plane * 9 + k) * n + (size_t)y * nx + x];
  };
  auto sum9 = [&](int plane, int y, int x) -> T {
    T m = at(plane, 0, y, x);
#pragma unroll
    for (int k = 1; k < 9; ++k) m += at(plane, k, y, x);
    return m;
  };

  // ---- 0. flow outlet ----
  for (int y = tid; y < ny; y += nt) {
    if (y < 1 || y > ny - 2) continue;
    T r1 = T(0), mx1 = T(0), my1 = T(0), r2 = T(0), mx2 = T(0), my2 = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T a = at(P_F, k, y, nx - 2), b = at(P_F, k, y, nx - 3);
      r1 += a;
      r2 += b;
      mx1 += T(cx(k)) * a;
      my1 += T(cy(k)) * a;
      mx2 += T(cx(k)) * b;
      my2 += T(cy(k)) * b;
    }
    const T rho = (T(4) * r1 - r2) / T(3);
    const T ux = (T(4) * (mx1 / r1) - mx2 / r2) / T(3);
    const T uy = (T(4) * (my1 / r1) - my2 / r2) / T(3);
    T col[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) col[k] = at(P_F, k, y, nx - 1);
    if (y > 1 && y < ny - 2) {
      const T usqr = ux * ux + uy * uy;  // the reference's un-scaled u²
      T feq[9];
#pragma unroll
      for (int k = 3; k <= 7; ++k) {
        const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
        feq[k] = rho * T(wk(k)) *
                 (T(1) + T(3) * cu + T(4.5) * cu * cu - T(1.5) * usqr);
      }
      const T two3 = T(2.0 / 3.0);
      const T f3 = feq[3] + two3 * rho * ux +
                   two3 * (feq[3] - col[1] + feq[7] - col[5] + feq[6] - col[8]);
      const T e1 = (rho * ux - col[1] - col[5] - col[8] + feq[6] + feq[3] +
                    feq[7]) / T(c.t367);
      const T e2 = (rho * uy - col[2] - col[5] + col[8] + col[4] - feq[6] +
                    feq[7]) / T(c.t76);
      at(P_F, 3, y, nx - 1) = f3;
      at(P_F, 6, y, nx - 1) = feq[6] - T(wk(6)) * (e1 - e2);
      at(P_F, 7, y, nx - 1) = feq[7] - T(wk(7)) * (e1 + e2);
    } else {  // the corners, y = 1 (bottom) and y = ny − 2 (top)
      const bool bottom = y == 1;
      const T f8 = bottom ? (rho + rho * ux - T(2.0 / 3.0) * rho * uy -
                             col[0] - T(2) * (col[1] + col[4] + col[8])) / T(2)
                          : (rho + rho * ux + T(2.0 / 3.0) * rho * uy -
                             col[0] - T(2) * (col[1] + col[2] + col[5])) / T(2);
      at(P_F, 8, y, nx - 1) = f8;
      at(P_F, 6, y, nx - 1) = f8 - rho * ux / T(6) + rho * uy / T(6);
      at(P_F, 3, y, nx - 1) = col[1] - T(2.0 / 3.0) * rho * ux;
      at(P_F, 7, y, nx - 1) = col[5] - rho * ux / T(6) + rho * uy / T(6);
      if (bottom)
        at(P_F, 2, y, nx - 1) = col[4] + T(2.0 / 3.0) * rho * uy;
      else
        at(P_F, 4, y, nx - 1) = col[2] - T(2.0 / 3.0) * rho * uy;
    }
  }
  if (!c.konv) return;
  __syncthreads();

  // ---- A. amplitudes from the entry sums ----
  const int nmax = nx > ny ? nx : ny;
  for (int i = tid; i < nmax; i += nt) {
    for (int p = 0; p < 3; ++p) {
      const int plane = P_O2 + p;
      if (i < ny)
        amp_out[p * ny + i] =
            (T(4) * sum9(plane, i, nx - 2) - sum9(plane, i, nx - 3)) / T(3);
      if (i >= nx) continue;
      T top[2];  // the sums of rows ny − 3 and ny − 4 that the row reads
      for (int r = 0; r < 2; ++r) {
        const int y = ny - 3 - r;
        T m = sum9(plane, y, i);
        if (i == 1 || i == nx - 1) {
          // the column's own fix (inlet at x = 1, outlet at nx − 1) first
          const bool in = i == 1;
          const T amp = in ? T(c.amp_in[p])
                           : (T(4) * sum9(plane, y, nx - 2) -
                              sum9(plane, y, nx - 3)) / T(3);
          // (k_in, k_out): inlet (5,7) (1,3) (8,6), outlet (6,8) (3,1) (7,5)
          const int kin[3] = {in ? 5 : 6, in ? 1 : 3, in ? 8 : 7};
          const int kout[3] = {in ? 7 : 8, in ? 3 : 1, in ? 6 : 5};
          T d = T(0);
          for (int t = 0; t < 3; ++t)
            d += (-at(plane, kout[t], y, i) + T(c.w2[kout[t]]) * amp) -
                 at(plane, kin[t], y, i);
          m = m + d;
        }
        top[r] = m;
      }
      amp_top[p * nx + i] = (T(4) * top[0] - top[1]) / T(3);
    }
  }
  __syncthreads();

  // ---- B. top row ny − 2 ----
  for (int x = tid; x < nx; x += nt)
    for (int p = 0; p < 3; ++p) {
      const int plane = P_O2 + p;
      const T amp = amp_top[p * nx + x];
      const int y = ny - 2;
      at(plane, 7, y, x) = -at(plane, 5, y, x) + T(c.w2[7]) * amp;
      at(plane, 4, y, x) = -at(plane, 2, y, x) + T(c.w2[2]) * amp;
      at(plane, 8, y, x) = -at(plane, 6, y, x) + T(c.w2[6]) * amp;
    }
  __syncthreads();

  // ---- C. bottom row 1, from the sums after B ----
  for (int x = tid; x < nx; x += nt)
    for (int p = 0; p < 3; ++p) {
      const int plane = P_O2 + p;
      const T amp = (T(4) * sum9(plane, 2, x) - sum9(plane, 3, x)) / T(3);
      at(plane, 6, 1, x) = -at(plane, 8, 1, x) + T(c.w2[8]) * amp;
      at(plane, 2, 1, x) = -at(plane, 4, 1, x) + T(c.w2[4]) * amp;
      at(plane, 5, 1, x) = -at(plane, 7, 1, x) + T(c.w2[7]) * amp;
    }
  __syncthreads();

  // ---- D. inlet column 1 ----
  for (int y = tid; y < ny; y += nt)
    for (int p = 0; p < 3; ++p) {
      const int plane = P_O2 + p;
      const T amp = T(c.amp_in[p]);
      at(plane, 5, y, 1) = -at(plane, 7, y, 1) + T(c.w2[7]) * amp;
      at(plane, 1, y, 1) = -at(plane, 3, y, 1) + T(c.w2[3]) * amp;
      at(plane, 8, y, 1) = -at(plane, 6, y, 1) + T(c.w2[6]) * amp;
    }
  __syncthreads();

  // ---- E. outlet column nx − 1 ----
  for (int y = tid; y < ny; y += nt)
    for (int p = 0; p < 3; ++p) {
      if (p < 2 && (y == 1 || y == ny - 2)) continue;  // species corners
      const int plane = P_O2 + p;
      const T amp = amp_out[p * ny + y];
      at(plane, 6, y, nx - 1) = -at(plane, 8, y, nx - 1) + T(c.w2[8]) * amp;
      at(plane, 3, y, nx - 1) = -at(plane, 1, y, nx - 1) + T(c.w2[1]) * amp;
      at(plane, 7, y, nx - 1) = -at(plane, 5, y, nx - 1) + T(c.w2[5]) * amp;
    }
  __syncthreads();

  // ---- F. species outlet corners ----
  for (int t4 = tid; t4 < 4; t4 += nt) {
    const int plane = P_O2 + (t4 & 1);
    const bool bottom = t4 < 2;
    const int y = bottom ? 1 : ny - 2;
    T colc[9], fc[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      colc[k] = at(plane, k, y, nx - 1);
      fc[k] = at(P_F, k, y, nx - 1);
    }
    T Yc = colc[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) Yc += colc[k];
    const T Ylok = (T(4) * sum9(plane, y, nx - 2) - sum9(plane, y, nx - 3)) /
                   T(3);
    T rl = fc[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) rl += fc[k];
    const T uxl = (fc[1] - fc[3] + fc[5] - fc[6] - fc[7] + fc[8]) / rl;
    const T uyl = (fc[2] - fc[4] + fc[5] + fc[6] - fc[7] - fc[8]) / rl;
    const T usqr = T(1.5) * (uxl * uxl + uyl * uyl);
    T geq[9];
    equilibrium(Yc, uxl, uyl, usqr, geq);
    // bottom: eps over k 0, 1, 4, 8, rewritten 2, 3, 5, 6, 7;
    // top: eps over k 0, 1, 2, 5, rewritten 3, 4, 6, 7, 8
    const int eps_k[4] = {0, 1, bottom ? 4 : 2, bottom ? 8 : 5};
    const int geq_k[5] = {bottom ? 2 : 3, bottom ? 3 : 4, bottom ? 5 : 6,
                          bottom ? 6 : 7, bottom ? 7 : 8};
    T e1 = colc[eps_k[0]];
    for (int t = 1; t < 4; ++t) e1 += colc[eps_k[t]];
    T e2 = geq[geq_k[0]];
    for (int t = 1; t < 5; ++t) e2 += geq[geq_k[t]];
    const T GC = (Ylok - (e1 + e2)) / T(bottom ? c.wsum_bot : c.wsum_top);
    for (int t = 0; t < 5; ++t) {
      const int k = geq_k[t];
      at(plane, k, y, nx - 1) = geq[k] + T(wk(k)) * GC;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 2 (konv): the LI2014 conjugate fix of the cell's own incoming g_T
// (unless first_step) and the fields ρ, u, Y_O2, Y_CO2.  For each direction
// d with neighbour nb = r − c_d (apply_conjugate_bc in pull form):
//   obstacle r, bulk nb: g_T(r, d) = −a g_coll(r, opp d) + b2 g_coll(nb, d)
//   bulk r, obstacle nb: g_T(r, d) =  a g_coll(r, opp d) + c2 g_coll(nb, d)
template <typename T>
__global__ void fields_kernel(T* __restrict__ s, const int8_t* __restrict__ flags,
                              T* __restrict__ fld, int ny, int nx, int conjugate,
                              CombustionConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = (int)(i / nx), x = (int)(i - (size_t)y * nx);
  const int fl = flags[i];
  if (conjugate && (fl == BULK || fl == OBSTACLE)) {
    const T* gc = s + (size_t)P_GCOLL * 9 * n;
    T* gT = s + (size_t)P_T * 9 * n;
    for (int d = 1; d < 9; ++d) {
      const size_t nb = (size_t)wrap(y - cy(d), ny) * nx + wrap(x - cx(d), nx);
      const int fn = flags[nb];
      if (fl == OBSTACLE && fn == BULK)
        gT[d * n + i] = T(c.conj_neg_a) * gc[opp(d) * n + i] +
                        T(c.conj_b2) * gc[d * n + nb];
      else if (fl == BULK && fn == OBSTACLE)
        gT[d * n + i] = T(c.conj_a) * gc[opp(d) * n + i] +
                        T(c.conj_c2) * gc[d * n + nb];
    }
  }
  T f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = s[(size_t)k * n + i];
  T rho, ux, uy;
  flow_macro(f, c, rho, ux, uy);
  T y1 = s[(size_t)(P_O2 * 9) * n + i], y2 = s[(size_t)(P_CO2 * 9) * n + i];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    y1 += s[(size_t)(P_O2 * 9 + k) * n + i];
    y2 += s[(size_t)(P_CO2 * 9 + k) * n + i];
  }
  fld[F_RHO * n + i] = rho;
  fld[F_UX * n + i] = ux;
  fld[F_UY * n + i] = uy;
  fld[F_YO2 * n + i] = y1;
  fld[F_YCO2 * n + i] = y2;
}

// _central_gradient at one cell: central differences, one-sided second
// order where the neighbour beyond is not bulk (the later rule wins, as the
// model's selections do)
template <typename T>
__device__ __forceinline__ void gradient(const T* q, const int* ys,
                                         const int* xs, int nx, bool s_n,
                                         bool s_s, bool s_e, bool s_w, T& gx,
                                         T& gy) {
  // ys, xs: rows y−2 .. y+2 and columns x−2 .. x+2, wrapped
  const T c0 = q[(size_t)ys[2] * nx + xs[2]];
  const T E = q[(size_t)ys[2] * nx + xs[3]], Wv = q[(size_t)ys[2] * nx + xs[1]];
  const T N = q[(size_t)ys[3] * nx + xs[2]], S = q[(size_t)ys[1] * nx + xs[2]];
  gx = (E - Wv) / T(2);
  gy = (N - S) / T(2);
  if (s_s) gy = (T(-3) * c0 + T(4) * N - q[(size_t)ys[4] * nx + xs[2]]) / T(2);
  if (s_n) gy = (T(3) * c0 - T(4) * S + q[(size_t)ys[0] * nx + xs[2]]) / T(2);
  if (s_w) gx = (T(-3) * c0 + T(4) * E - q[(size_t)ys[2] * nx + xs[4]]) / T(2);
  if (s_e) gx = (T(3) * c0 - T(4) * Wv + q[(size_t)ys[2] * nx + xs[0]]) / T(2);
}

// ---------------------------------------------------------------------------
// Launch 3: collide and stream.  src holds the boundary-fixed populations
// (launches 1 and 2 wrote them in place), dst the next state.
template <typename T>
__global__ void __launch_bounds__(256)
    collide_stream_kernel(const T* __restrict__ src, T* __restrict__ dst,
                          const int8_t* __restrict__ flags,
                          const int8_t* __restrict__ ckn,
                          const T* __restrict__ fs_col,
                          const T* __restrict__ fs_row,
                          const T* __restrict__ mats_g,
                          const T* __restrict__ fld, int ny, int nx,
                          CombustionConst c) {
  __shared__ T mats[NMAT * 81];
  for (int t = threadIdx.x; t < NMAT * 81; t += blockDim.x) mats[t] = mats_g[t];
  __syncthreads();
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = (int)(i / nx), x = (int)(i - (size_t)y * nx);
  const int fl = flags[i];
  const bool bulk = fl == BULK;
  const bool out_col = c.io && x == nx - 1;
  // neighbour r + c_k (nbp) and upstream r − c_k (nbm) of every direction
  size_t nbp[9], nbm[9];
  int fp[9], fm[9];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    nbp[k] = (size_t)wrap(y + cy(k), ny) * nx + wrap(x + cx(k), nx);
    nbm[k] = (size_t)wrap(y - cy(k), ny) * nx + wrap(x - cx(k), nx);
    fp[k] = flags[nbp[k]];
    fm[k] = flags[nbm[k]];
  }
  auto S = [&](int plane, int k) -> const T& {
    return src[((size_t)plane * 9 + k) * n + i];
  };
  auto D = [&](int plane, int k, size_t cell) -> T& {
    return dst[((size_t)plane * 9 + k) * n + cell];
  };

  // ---- macroscopic fields ----
  T rho, ux, uy, YO2 = T(0), YCO2 = T(0), T_ = T(0);
  if (c.konv) {
    rho = fld[F_RHO * n + i];
    ux = fld[F_UX * n + i];
    uy = fld[F_UY * n + i];
    YO2 = fld[F_YO2 * n + i];
    YCO2 = fld[F_YCO2 * n + i];
    T_ = S(P_T, 0);
#pragma unroll
    for (int k = 1; k < 9; ++k) T_ += S(P_T, k);
  } else {
    T f[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = S(P_F, k);
    flow_macro(f, c, rho, ux, uy);
  }
  const T usqr = T(1.5) * (ux * ux + uy * uy);

  // ---- flow: collide, body force, stream ----
  {
    T f[9], eq[9], post[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = S(P_F, k);
    equilibrium(rho, ux, uy, usqr, eq);
    mrt(mats, f, eq, post);
    if (c.body_force) {
      const T px = T(c.dpdx), py = T(c.dpdy);
      const T uF = ux * px + uy * py;
      T Fk[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
        const T cF = T(cx(k)) * px + T(cy(k)) * py;
        Fk[k] = T(wk(k)) * (T(3) * cF + T(9) * cu * cF - T(3) * uF);
      }
      const T* B = mats + 5 * 81;
#pragma unroll
      for (int r = 0; r < 9; ++r) {
        T s = B[r * 9] * Fk[0];
#pragma unroll
        for (int k = 1; k < 9; ++k) s += B[r * 9 + k] * Fk[k];
        post[r] += s;
      }
    }
    if (!bulk) {
#pragma unroll
      for (int k = 0; k < 9; ++k) D(P_F, k, i) = T(0);
    } else {
      D(P_F, 0, i) = post[0];
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        // receiver: the outlet pin, or bounce-back off a solid upstream
        if (out_col && west(k)) {
          D(P_F, k, i) = f[k];
        } else if (fm[k] != BULK) {
          const int ko = opp(k);
          const int uy_ = (int)(nbm[k] / nx), ux_ = (int)(nbm[k] - (size_t)uy_ * nx);
          const T fs = ux_ == 0 ? fs_col[ko * ny + uy_]
                                : (uy_ == ny - 1 ? fs_row[ko * nx + ux_] : T(0));
          D(P_F, k, i) = post[ko] + fs;
        }
        // sender: push into a bulk neighbour that is not pinned
        const bool pin_j = c.io && wrap(x + cx(k), nx) == nx - 1 && west(k);
        if (fp[k] == BULK && !pin_j) D(P_F, k, nbp[k]) = post[k];
      }
    }
  }
  if (!c.konv) return;

  // ---- species forcing: gradients at reach 2 ----
  int ys[5], xs[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    ys[t] = wrap(y + t - 2, ny);
    xs[t] = wrap(x + t - 2, nx);
  }
  const bool s_n = fp[2] != BULK, s_s = fp[4] != BULK;
  const bool s_e = fp[1] != BULK, s_w = fp[3] != BULK;
  T grx, gry, gux, guy, g1x, g1y, g2x, g2y, dummy;
  gradient(fld + F_RHO * n, ys, xs, nx, s_n, s_s, s_e, s_w, grx, gry);
  gradient(fld + F_UX * n, ys, xs, nx, s_n, s_s, s_e, s_w, gux, dummy);
  gradient(fld + F_UY * n, ys, xs, nx, s_n, s_s, s_e, s_w, dummy, guy);
  gradient(fld + F_YO2 * n, ys, xs, nx, s_n, s_s, s_e, s_w, g1x, g1y);
  gradient(fld + F_YCO2 * n, ys, xs, nx, s_n, s_s, s_e, s_w, g2x, g2y);
  if (x == nx - 1) {  // outlet column: zero x-gradients (every topology)
    g1x = T(0);
    g2x = T(0);
    gux = T(0);
  }
  const T div_u = gux + guy;
  const T F_O2 = (T(c.D_O2) / rho) * (g1x * grx + g1y * gry) + YO2 * div_u;
  const T F_CO2 = (T(c.D_CO2) / rho) * (g2x * grx + g2y * gry) + YCO2 * div_u;

  // ---- reaction: interfacial mass fractions, heat release ----
  const T Tm = T_ < T(1e-2) ? T(1e-2) : T_;  // NaN propagates
  const T kr = T(c.A_pre) * exp(T(c.neg_E) / (T(c.R_id) * Tm));
  T Y1i[9], Y2i[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T hck = T(c.half_stoich * (double)ckn[(size_t)k * n + i]);
    const T yo = T(c.D_O2) * YO2 / (T(c.D_O2) + hck * kr);
    Y1i[k] = yo;
    Y2i[k] = YCO2 - (T(0.5 * (double)ckn[(size_t)k * n + i]) * kr * yo *
                     T(c.M_CO2)) / T(c.DM);
  }
  T F_T = T(0);
  if (c.li2014) {
    T ysum = T(0);
#pragma unroll
    for (int k = 1; k <= 4; ++k)
      if (fp[k] == OBSTACLE) ysum += Y1i[k];
    const T F_r = kr * ysum * rho / T(c.M_O2);
    F_T = F_r * T(c.delta_hr) / (rho * T(c.cp_gas));
  }

  // ---- species: collide, force, stream ----
  for (int sp = 0; sp < 2; ++sp) {
    const int plane = sp == 0 ? P_O2 : P_CO2;
    const T amp = sp == 0 ? YO2 : YCO2;
    const T Fs = sp == 0 ? F_O2 : F_CO2;
    const T fac = T(sp == 0 ? c.fac_O2 : c.fac_CO2);
    const T* Yi = sp == 0 ? Y1i : Y2i;
    T g[9], eq[9], post[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = S(plane, k);
    equilibrium(amp, ux, uy, usqr, eq);
    mrt(mats + (1 + sp) * 81, g, eq, post);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
      const T Fk = T(wk(k)) * Fs * (T(1) + T(3) * cu * fac);
      post[k] = post[k] + Fk + T(0.5) * (Fk - S(plane + 3, k));
      D(plane + 3, k, i) = Fk;
    }
    if (!bulk) {
#pragma unroll
      for (int k = 0; k < 9; ++k) D(plane, k, i) = T(0);
      continue;
    }
    D(plane, 0, i) = post[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const int ko = opp(k);
      if (out_col && west(k)) {
        D(plane, k, i) = g[k];
      } else if (fm[k] == WALL || (fm[k] == OBSTACLE && !c.solid_reaction)) {
        D(plane, k, i) = post[ko];
      } else if (fm[k] == OBSTACLE) {
        D(plane, k, i) = -post[ko] + T(c.w2[ko]) * Yi[ko];
      }
      const bool pin_j = c.io && wrap(x + cx(k), nx) == nx - 1 && west(k);
      if (fp[k] == BULK && !pin_j) D(plane, k, nbp[k]) = post[k];
    }
  }

  // ---- temperature: gas or solid collision, store, stream ----
  {
    T g[9], eq[9], post[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) g[k] = S(P_T, k);
    if (bulk) {
      equilibrium(T_, ux, uy, usqr, eq);
      mrt(mats + 3 * 81, g, eq, post);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
        const T Fk = T(wk(k)) * F_T * (T(1) + T(3) * cu * T(c.fac_T));
        post[k] = post[k] + Fk + T(0.5) * (Fk - S(P_FT, k));
        D(P_FT, k, i) = Fk;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        eq[k] = T_ * T(wk(k));
        const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
        D(P_FT, k, i) = T(wk(k)) * F_T * (T(1) + T(3) * cu * T(c.fac_T));
      }
      mrt(mats + 4 * 81, g, eq, post);
    }
    const bool obst = fl == OBSTACLE;
    D(P_T, 0, i) = post[0];
    D(P_GCOLL, 0, i) = T(0);
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      // receiver: keep the fixed incoming value across an interface, from
      // an inlet-channel wall, and at the outlet pin
      const bool iface_in = (fm[k] == OBSTACLE && bulk) ||
                            (fm[k] == BULK && obst);
      const bool keep_in = (c.li2014 && iface_in) ||
                           (c.io && fm[k] == WALL) || (out_col && bulk && west(k));
      if (keep_in) D(P_T, k, i) = g[k];
      // sender: the same rule seen from the neighbour r + c_k
      const bool iface_out = (bulk && fp[k] == OBSTACLE) ||
                             (obst && fp[k] == BULK);
      const bool pin_j = c.io && wrap(x + cx(k), nx) == nx - 1 && west(k) &&
                         fp[k] == BULK;
      const bool keep_out = (c.li2014 && iface_out) ||
                            (c.io && fl == WALL) || pin_j;
      if (!keep_out) D(P_T, k, nbp[k]) = post[k];
      D(P_GCOLL, k, i) = iface_out ? post[k] : T(0);
    }
  }
}

template <typename T>
int run_steps(T* a, T* b, const int8_t* flags, const int8_t* ckn,
              const T* fs_col, const T* fs_row, const T* mats, T* fld,
              T* scratch, int ny, int nx, int n_steps, int first_mode,
              const CombustionConst* c, cudaStream_t stream) {
  const size_t n = (size_t)ny * nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  for (int s = 0; s < n_steps; ++s) {
    T* src = (s & 1) ? b : a;
    T* dst = (s & 1) ? a : b;
    // first_mode: 0 none, 1 the first step of the call, 2 every step
    const bool first = first_mode == 2 || (first_mode == 1 && s == 0);
    if (c->io) {
      boundary_kernel<T><<<1, BC_THREADS, 0, stream>>>(
          src, scratch, scratch + 3 * nx, ny, nx, *c);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (c->konv) {
      fields_kernel<T><<<blocks, threads, 0, stream>>>(
          src, flags, fld, ny, nx, c->li2014 && !first, *c);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    collide_stream_kernel<T><<<blocks, threads, 0, stream>>>(
        src, dst, flags, ckn, fs_col, fs_row, mats, fld, ny, nx, *c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// n_steps steps of the (8, 9, ny, nx) state: a holds the input and is
// written in place by the boundary phase; the result is in a when n_steps
// is even, else in b.  flags (ny, nx) and ck_n (9, ny, nx) int8; fs_col
// (9, ny) and fs_row (9, nx) the momentum-exchange populations of column 0
// and row ny − 1; mats (6, 9, 9); fld (5, ny, nx) and scratch (3 (nx + ny))
// are work space.  Returns the cudaError_t of the launches (0 on success).
int combustion_run_f32(void* a, void* b, const void* flags, const void* ckn,
                       const void* fs_col, const void* fs_row,
                       const void* mats, void* fld, void* scratch, int ny,
                       int nx, int n_steps, int first_mode, const void* consts,
                       void* stream) {
  return run_steps<float>((float*)a, (float*)b, (const int8_t*)flags,
                          (const int8_t*)ckn, (const float*)fs_col,
                          (const float*)fs_row, (const float*)mats,
                          (float*)fld, (float*)scratch, ny, nx, n_steps,
                          first_mode, (const CombustionConst*)consts,
                          (cudaStream_t)stream);
}

int combustion_run_f64(void* a, void* b, const void* flags, const void* ckn,
                       const void* fs_col, const void* fs_row,
                       const void* mats, void* fld, void* scratch, int ny,
                       int nx, int n_steps, int first_mode, const void* consts,
                       void* stream) {
  return run_steps<double>((double*)a, (double*)b, (const int8_t*)flags,
                           (const int8_t*)ckn, (const double*)fs_col,
                           (const double*)fs_row, (const double*)mats,
                           (double*)fld, (double*)scratch, ny, nx, n_steps,
                           first_mode, (const CombustionConst*)consts,
                           (cudaStream_t)stream);
}

}  // extern "C"
