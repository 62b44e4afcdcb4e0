// One full reference iteration of the deformable pulsatile vessel (D2Q9,
// pressure-form MRT, two moving Bouzidi walls, Zou/He pressure ends, wall
// ODE, geometry rebuild, fresh-node reseed) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_pulsatile_full.py:_make_kernel (the
// Pallas TPU kernel behind run_fused_full) and computes what its substep
// computes in the reference parity mode (momentum quirk on, ping-pong
// collisions, the reference's scrambled MRT basis, no Zou/He corner
// closure), one step per call of pulsatile_step_f32/_f64.  The Pallas kernel
// kept the whole lattice resident in 100 MB of VMEM across nsub sub-steps;
// Hopper has no such memory and runs blocks in no order, so a step is eight
// launches, each boundary placed where the next phase needs the whole
// lattice (or a whole pass) finished:
//   1. collide_kernel (per cell): fluid from the analytic Fobj of the current
//      walls, F = (ysel − yc)/(Y − yc) by division as the plain path forms
//      it (Pallas multiplies by a reciprocal, which can flip a fluid
//      decision at F ≈ 1); the low-rank MRT post-collision state at fluid
//      cells, g_stream at solid ones, into gout.
//   2-5. bouzidi_links_kernel then bouzidi_scatter_kernel, for the bottom
//      wall and then for the top wall (which must see the bottom pass's
//      writes).  One thread per column finds the column's main border node
//      and its jump node and evaluates their active links (at most six per
//      column and wall) in closed form from yr at X − 1, X, X + 1; no Δ field
//      is stored.  Every read of a pass comes from gout as it was when the
//      pass began: the values go to a side buffer, and the scatter launch
//      writes them after the whole pass has read.
//   6. stream_kernel (per cell): pull streaming (periodic in x), Zou/He at
//      x = 0 and x = nx − 1 from the cell's own streamed populations, and the
//      macroscopic sums with the reference's k = 0 momentum quirk, masked
//      with the old fluid map: g2 into g_stream, (P, Ux, Uy) into mac.
//   7. tail_kernel (per cell): the wall ODE of the cell's column from P at
//      rows y0 and y0 + 1 (every thread of a column computes it; row 0
//      stores it), fresh-cell detection, and the dense reseed fill of each
//      fresh cell, read from the pre-reseed g2 only.  Fills go to a compact
//      list (slot by atomicAdd), so no thread reads a cell that another
//      thread of the launch writes.  A fill that reads a fresh cell (an
//      edge copy from a fresh row, or an interior cell with no old-fluid
//      neighbour, where the reference's sequential ring search would run)
//      marks the step order-dependent; the kernel fills it densely, as the
//      Pallas kernel does, and counts it.
//   8. reseed_scatter_kernel: writes the fills and the fresh cells' macros
//      (the full first moment); block 0 adds the step's order-dependence
//      flag and fresh-cell count to the device counters and clears the
//      other parity's slots for the next step.  Cells that stay fluid, stay
//      solid or are killed keep the macros of launch 6, which equal the
//      plain path's re-masked values.
//
// Arithmetic follows the plain path (multiphase_lbm_tpu_torch/models/
// pulsatile.py) operation by operation: sums run k = 0..8 one rounding at a
// time, constants arrive as doubles and are rounded here as JAX rounds
// Python floats, and ops/_build.py compiles this file with -fmad=false so
// no multiply and add fuse.  The model is chaotic (staircase wall decisions
// amplify ulp noise), so that is what lets the float64 kernel stay on the
// plain path's trajectory over tens of steps.
//
// Bound: device memory.  A step must read g_coll at fluid cells or g_stream
// at solid ones (36 B in float32) and the macros (12 B), and write gout, g2
// and the macros (84 B): 132 B per cell, 1.38 GB per step at the N = 1024
// bench size (10,221 × 1,024), so no step takes less than 0.41 ms at
// 3.35 TB/s.  Launches 1 and 6 move about 168 B per cell (6 re-reads gout);
// the Bouzidi, tail and scatter launches touch O(nx) cells besides the
// tail's per-cell geometry test.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// Constants of one parameter set, filled by
// multiphase_lbm_tpu_torch/ops/pulsatile_fused.py (_PulsatileConst, same
// field order).
struct PulsatileConst {
  // the relaxed moments j (S_j ≠ 1) of M⁻¹ (S − I) M: row r < nrel holds
  // M's row j in Mr[9r..9r+8] and (S_j − 1)·M⁻¹[:, j] in C[9r..9r+8]
  double Mr[81], C[81];
  double rho0;
  double rho0_3;       // ρ₀/3 (equilibrium)
  double rho0_2_9;     // 2ρ₀/9 (Zou/He)
  double rho0_18;      // ρ₀/18
  double neg_rho0_18;  // −ρ₀/18
  double yc;           // channel centre y0 + 0.5
  double alpha;        // wall compliance
  double p_tissue;
  double ytop;         // ny − 1 − 0.5, the top wall's rest row
  double pin, pout, p_osc, omega;
  int nrel, y0, t_start, t_prop, severed, t_sever;
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
// "Abbas I" ordering of the boundary code: 0 rest, 1 E, 2 N, 3 W, 4 S,
// 5 NE, 6 NW, 7 SW, 8 SE; K_FROM_I maps it to the module ordering.
__host__ __device__ __forceinline__ constexpr int ex_i(int I) {
  return (I == 1 || I == 5 || I == 8) - (I == 3 || I == 6 || I == 7);
}
__host__ __device__ __forceinline__ constexpr int ey_i(int I) {
  return (I == 2 || I == 5 || I == 6) - (I == 4 || I == 7 || I == 8);
}
__host__ __device__ __forceinline__ constexpr int jb_i(int I) {
  return I == 0 ? 0 : (I <= 4 ? (I + 1) % 4 + 1 : (I + 1) % 4 + 5);
}
__host__ __device__ __forceinline__ constexpr int k_from_i(int I) {
  return I == 0 ? 4 : I == 1 ? 5 : I == 2 ? 6 : I == 3 ? 0 : I == 4 ? 1
       : I == 5 ? 7 : I == 6 ? 3 : I == 7 ? 2 : 8;
}

// max(0, x) keeping NaN (jnp.maximum / torch.maximum)
template <typename T>
__device__ __forceinline__ T max0(T x) {
  return (x != x) ? x : (x > T(0) ? x : T(0));
}

// Fobj at (Y, X) from the wall rows yr = (yr1[nx], yr2[nx]): the bottom wall
// for Y ≤ y0, else the top wall (models/pulsatile.py fobj_from_walls).
template <typename T>
__device__ __forceinline__ T fobj(const T* yr, int nx, int Y, int X,
                                  const PulsatileConst& c) {
  const T ysel = (Y <= c.y0) ? yr[X] : yr[nx + X];
  return (ysel - T(c.yc)) / (T(Y) - T(c.yc));
}

// Δ = max(0, 1 − |Y1/(mA − mB)|)
template <typename T>
__device__ __forceinline__ T find_delta(double mA, T mB, T Y1) {
  return max0(T(1) - fabs(Y1 / (T(mA) - mB)));
}

// ---------------------------------------------------------------- 1. collide
template <typename T>
__global__ void collide_kernel(const T* __restrict__ gc,
                               const T* __restrict__ gs,
                               const T* __restrict__ mac,
                               const T* __restrict__ yr, T* __restrict__ gout,
                               int ny, int nx, PulsatileConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = (int)(i / nx);
  const int x = (int)(i - (size_t)y * nx);
  if (!(fobj(yr, nx, y, x, c) >= T(1))) {
#pragma unroll
    for (int k = 0; k < 9; ++k) gout[k * n + i] = gs[k * n + i];
    return;
  }
  const T P = mac[i], ux = mac[n + i], uy = mac[2 * n + i];
  const T usqr = T(1.5) * (ux * ux + uy * uy);
  T geq[9], d[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
    geq[k] =
        T(wk(k)) * (P + T(c.rho0_3) * (cu * (T(3) + T(4.5) * cu) - usqr));
    d[k] = gc[k * n + i] - geq[k];
  }
  // post = g_eq − Σ_j (S_j − 1) M⁻¹[:, j] (M_j · (g − g_eq)): only the
  // relaxed moments (S_j ≠ 1) enter, as in the Pallas kernel's low-rank form
  T post[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) post[k] = geq[k];
  for (int r = 0; r < c.nrel; ++r) {
    T m = T(c.Mr[9 * r]) * d[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) m = m + T(c.Mr[9 * r + k]) * d[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) post[k] = post[k] - T(c.C[9 * r + k]) * m;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) gout[k * n + i] = post[k];
}

// ------------------------------------------------------------ 2-5. Bouzidi
// Border row of column X (models/pulsatile.py border_deltas): the highest
// solid row under the bottom wall, the lowest solid row over the top wall.
template <typename T>
__device__ __forceinline__ int border_row(const T* yr, int ny, int nx, int X,
                                          bool bottom,
                                          const PulsatileConst& c) {
  const T v = bottom ? yr[X] : yr[nx + X];
  const int Y0 = bottom ? (int)floor(v) : (int)ceil(v);
  const int Yg = Y0 < -1 ? -1 : (Y0 > ny ? ny : Y0);  // the F halo's clamp
  const bool fl0 = fobj(yr, nx, Yg, X, c) >= T(1);
  int Y = bottom ? (fl0 ? Y0 - 1 : Y0) : (fl0 ? Y0 + 1 : Y0);
  return Y < 0 ? 0 : (Y > ny - 1 ? ny - 1 : Y);
}

// One Bouzidi link of direction I at border cell (Y, X) with Δ = D:
// quadratic interpolation along the link with the reference's fallback order
// (models/pulsatile.py _bouzidi_one).  Reads gout only.
template <typename T>
__device__ T link_value(const T* __restrict__ g, const T* yr, int ny, int nx,
                        int Y, int X, int I, T D, const PulsatileConst& c) {
  const size_t n = (size_t)ny * nx;
  const int ex = ex_i(I), ey = ey_i(I);
  const int kI = k_from_i(I), kJ = k_from_i(jb_i(I));
  auto in = [&](int m) {
    const int Xm = X + m * ex, Ym = Y + m * ey;
    return Xm >= 0 && Xm < nx && Ym >= 0 && Ym < ny;
  };
  auto at = [&](int k, int m) {
    return g[k * n + (size_t)(Y + m * ey) * nx + (X + m * ex)];
  };
  const T gJ1 = at(kJ, 1), gI1 = at(kI, 1);
  const T F1 = fobj(yr, nx, Y + ey, X + ex, c);
  const bool in2 = in(2), in3 = in(3);
  const T F2_eff = in2 ? fobj(yr, nx, Y + 2 * ey, X + 2 * ex, c) : F1;
  const bool use1for2 = (!in2) || (F2_eff < T(1));
  const T gJ2 = use1for2 ? gJ1 : at(kJ, 2);
  const T gI2 = use1for2 ? gI1 : at(kI, 2);
  const T F3_eff = in3 ? fobj(yr, nx, Y + 3 * ey, X + 3 * ex, c) : F1;
  T gJ3 = in3 ? at(kJ, 3) : gJ1;
  if (F3_eff < T(1)) gJ3 = gJ2;
  const T p = T(1) + T(2) * D, q = T(1) - T(2) * D;
  if (D < T(0.5))
    return gJ1 * p * D + gJ2 * q * p - gJ3 * q * D;
  return (gJ1 - gI1 * q * p + gI2 * q * D) / (D * p + T(1e-30));
}

// Entry j of column X's six slots: a link is written only if Δ < 1 and its
// first sample lies inside the lattice.
template <typename T>
__device__ __forceinline__ void put_link(const T* g, const T* yr, int ny,
                                         int nx, int Y, int X, int I, T D,
                                         int* idx, T* val, int slot,
                                         const PulsatileConst& c) {
  const int Xn = X + ex_i(I), Yn = Y + ey_i(I);
  if (D < T(1) && Xn >= 0 && Xn < nx && Yn >= 0 && Yn < ny) {
    val[slot] = link_value(g, yr, ny, nx, Y, X, I, D, c);
    idx[slot] = (int)(k_from_i(I) * (size_t)ny * nx + (size_t)Y * nx + X);
  } else {
    idx[slot] = -1;
  }
}

template <typename T>
__global__ void bouzidi_links_kernel(const T* __restrict__ g,
                                     const T* __restrict__ yr,
                                     int* __restrict__ idx,
                                     T* __restrict__ val, int ny, int nx,
                                     int bottom, PulsatileConst c) {
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  if (X >= nx) return;
  int* id = idx + 6 * X;
  T* vl = val + 6 * X;
  const T* w = bottom ? yr : yr + nx;   // this wall's row
  const T r = w[X];
  const T r_w = w[X == 0 ? nx - 1 : X - 1];
  const T r_e = w[X == nx - 1 ? 0 : X + 1];
  const T slope_e = r_e - r, slope_w = r - r_w;
  const int Yx = border_row(yr, ny, nx, X, bottom != 0, c);
  const T dist = r - T(Yx);
  const bool int_e = X != nx - 1, int_w = X != 0;
  auto fl = [&](int Y, int Xc) { return fobj(yr, nx, Y, Xc, c) >= T(1); };
  const T two = T(2);
  if (bottom) {
    // D[0] E, D[1] N, D[2] W, D[4] NE, D[5] NW (reference :302-319)
    put_link(g, yr, ny, nx, Yx, X, 1,
             (int_e && fl(Yx, X + 1)) ? find_delta(0.0, slope_e, dist) : two,
             id, vl, 0, c);
    put_link(g, yr, ny, nx, Yx, X, 2, T(1) - (r - T(Yx)), id, vl, 1, c);
    put_link(g, yr, ny, nx, Yx, X, 3,
             (int_w && fl(Yx, X - 1)) ? find_delta(0.0, slope_w, dist) : two,
             id, vl, 2, c);
    put_link(g, yr, ny, nx, Yx, X, 5,
             (int_e && fl(Yx + 1, X + 1)) ? find_delta(1.0, slope_e, dist)
                                          : two,
             id, vl, 3, c);
    put_link(g, yr, ny, nx, Yx, X, 6,
             (int_w && fl(Yx + 1, X - 1)) ? find_delta(-1.0, slope_w, dist)
                                          : two,
             id, vl, 4, c);
  } else {
    // D[0] E, D[2] W, D[3] S, D[6] SW, D[7] SE (reference :346-364)
    put_link(g, yr, ny, nx, Yx, X, 1,
             (int_e && fl(Yx, X + 1)) ? find_delta(0.0, slope_e, dist) : two,
             id, vl, 0, c);
    put_link(g, yr, ny, nx, Yx, X, 3,
             (int_w && fl(Yx, X - 1)) ? find_delta(0.0, slope_w, dist) : two,
             id, vl, 1, c);
    put_link(g, yr, ny, nx, Yx, X, 4, T(1) - (T(Yx) - r), id, vl, 2, c);
    put_link(g, yr, ny, nx, Yx, X, 7,
             (int_w && fl(Yx - 1, X - 1)) ? find_delta(1.0, slope_w, dist)
                                          : two,
             id, vl, 3, c);
    put_link(g, yr, ny, nx, Yx, X, 8,
             (int_e && fl(Yx - 1, X + 1)) ? find_delta(-1.0, slope_e, dist)
                                          : two,
             id, vl, 4, c);
  }
  // the jump node between columns X − 1 and X (reference :307-313,
  // :352-358): up to one extra link, in column X or in column X − 1
  id[5] = -1;
  if (X == 0) return;
  const int Yp = border_row(yr, ny, nx, X - 1, bottom != 0, c);
  if (Yp == Yx) return;
  if (bottom) {
    if (Yx > Yp)   // node (Yp, X), D[5] NW
      put_link(g, yr, ny, nx, Yp, X, 6,
               find_delta(-1.0, slope_w, r - T(Yp)), id, vl, 5, c);
    else           // node (Yx, X − 1), D[4] NE
      put_link(g, yr, ny, nx, Yx, X - 1, 5,
               find_delta(1.0, slope_w, r_w - T(Yx)), id, vl, 5, c);
  } else {
    if (Yx > Yp)   // node (Yx, X − 1), D[7] SE
      put_link(g, yr, ny, nx, Yx, X - 1, 8,
               find_delta(-1.0, slope_w, r_w - T(Yx)), id, vl, 5, c);
    else           // node (Yp, X), D[6] SW
      put_link(g, yr, ny, nx, Yp, X, 7,
               find_delta(1.0, slope_w, r - T(Yp)), id, vl, 5, c);
  }
}

// Every (cell, population) of a pass is written by at most one link (the
// main and jump nodes of a wall occupy distinct rows of a column), so the
// scatter order does not matter.
template <typename T>
__global__ void bouzidi_scatter_kernel(T* __restrict__ g,
                                       const int* __restrict__ idx,
                                       const T* __restrict__ val, int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int t = idx[j];
  if (t >= 0) g[t] = val[j];
}

// ------------------------------------------------- 6. stream, Zou/He, macros
template <typename T>
__device__ __forceinline__ void waveforms(int t, const PulsatileConst& c,
                                          T* Pin, T* Pout) {
  const T tt = T(t);
  *Pin = t >= c.t_start
             ? T(c.pin) + T(c.p_osc) * sin(T(c.omega) * ((tt + T(1)) -
                                                          T(c.t_start)))
             : T(c.pin);
  *Pout = t >= c.t_start + c.t_prop
              ? T(c.pout) + T(c.p_osc) *
                                sin(T(c.omega) * (((tt + T(1)) -
                                                   T(c.t_start)) -
                                                  T(c.t_prop)))
              : T(c.pout);
  if (c.severed && t > c.t_sever) *Pout = T(0);
}

template <typename T>
__device__ __forceinline__ bool zh_row(const T* yr, int ny, int nx, int X,
                                       int y) {
  int lo = (int)ceil(yr[X] - T(0.01));
  int hi = (int)floor(yr[nx + X] + T(0.01));
  lo = lo < 0 ? 0 : lo;
  hi = hi > ny - 1 ? ny - 1 : hi;
  return y >= lo && y <= hi;
}

template <typename T>
__global__ void stream_kernel(const T* __restrict__ gout,
                              const T* __restrict__ yr, T* __restrict__ g2,
                              T* __restrict__ mac, int ny, int nx, int t,
                              PulsatileConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = (int)(i / nx);
  const int x = (int)(i - (size_t)y * nx);
  T g[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    int ys = y - cy(k), xs = x - cx(k);
    ys = ys < 0 ? ys + ny : (ys >= ny ? ys - ny : ys);
    xs = xs < 0 ? xs + nx : (xs >= nx ? xs - nx : xs);
    g[k] = gout[k * n + (size_t)ys * nx + xs];
  }
  constexpr int k0 = k_from_i(0), k1 = k_from_i(1), k2 = k_from_i(2),
                k3 = k_from_i(3), k4 = k_from_i(4), k5 = k_from_i(5),
                k6 = k_from_i(6), k7 = k_from_i(7), k8 = k_from_i(8);
  if ((x == 0 && zh_row(yr, ny, nx, 0, y)) ||
      (x == nx - 1 && zh_row(yr, ny, nx, nx - 1, y))) {
    T Pin, Pout;
    waveforms<T>(t, c, &Pin, &Pout);
    if (x == 0 && zh_row(yr, ny, nx, 0, y)) {  // inlet (reference :618-643)
      const T a0 = g[k0], a2 = g[k2], a3 = g[k3], a4 = g[k4], a6 = g[k6],
              a7 = g[k7];
      const T U = (Pin - a0 - a2 - T(2) * a3 - a4 - T(2) * a6 - T(2) * a7) *
                  T(3) / T(c.rho0);
      g[k1] = a3 + T(c.rho0_2_9) * U;
      g[k5] = T(c.rho0_18) * U - T(0.5) * (a2 - a4) + a7;
      g[k8] = T(c.rho0_18) * U + T(0.5) * (a2 - a4) + a6;
    }
    if (x == nx - 1 && zh_row(yr, ny, nx, nx - 1, y)) {  // outlet (:644-668)
      const T h0 = g[k0], h1 = g[k1], h2 = g[k2], h4 = g[k4], h5 = g[k5],
              h8 = g[k8];
      const T U = (h0 + T(2) * h1 + h2 + h4 + T(2) * h5 + T(2) * h8 - Pout) *
                  T(3) / T(c.rho0);
      g[k3] = h1 - T(c.rho0_2_9) * U;
      g[k6] = T(c.neg_rho0_18) * U - T(0.5) * (h2 - h4) + h8;
      g[k7] = T(c.neg_rho0_18) * U + T(0.5) * (h2 - h4) + h5;
    }
  }
  // macros; the momentum sum omits k = 0 (the reference's quirk, :224)
  T P = T(1) * g[0], mx = T(0) * g[0], my = T(0) * g[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    P = P + T(1) * g[k];
    mx = mx + T(cx(k)) * g[k];
    my = my + T(cy(k)) * g[k];
  }
  const T m = fobj(yr, nx, y, x, c) >= T(1) ? T(1) : T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) g2[k * n + i] = g[k];
  mac[i] = P * m;
  mac[n + i] = T(3) * mx / T(c.rho0) * m;
  mac[2 * n + i] = T(3) * my / T(c.rho0) * m;
}

// ---------------------------------------------- 7. wall ODE, fresh, reseed
// counters: [0] order-dependent steps, [1] reseeded cells, [2] steps whose
// fresh cells overflowed the list, [4 + parity] fresh cells of the step,
// [6 + parity] the step's order-dependence flag
enum { kDiagDep = 0, kDiagCells = 1, kDiagOver = 2, kCnt = 4, kFlag = 6 };

template <typename T>
__device__ __forceinline__ T clamp_q(T v) {  // clip to ±0.25, NaN kept
  return v < T(-0.25) ? T(-0.25) : (v > T(0.25) ? T(0.25) : v);
}

template <typename T>
__global__ void tail_kernel(const T* __restrict__ g2,
                            const T* __restrict__ mac,
                            const T* __restrict__ yr, T* __restrict__ yr_new,
                            int* __restrict__ list_idx,
                            T* __restrict__ list_val, int* __restrict__ ctr,
                            int par, int cap, int ny, int nx,
                            PulsatileConst c) {
  const size_t n = (size_t)ny * nx;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = (int)(i / nx);
  const int x = (int)(i - (size_t)y * nx);
  // wall ODE of this column (models/pulsatile.py move_walls)
  const T Ps1 = mac[(size_t)c.y0 * nx + x] - T(c.p_tissue);
  const T Ps2 = mac[(size_t)(c.y0 + 1) * nx + x] - T(c.p_tissue);
  const T y1 = yr[x], y2 = yr[nx + x];
  const T y1n = y1 + clamp_q((T(0.5) - Ps1 / T(c.alpha)) - y1);
  const T y2n = y2 + clamp_q((T(c.ytop) + Ps2 / T(c.alpha)) - y2);
  if (y == 0) {
    yr_new[x] = y1n;
    yr_new[nx + x] = y2n;
  }
  auto fresh = [&](int Y) {
    const T Fn = ((Y <= c.y0 ? y1n : y2n) - T(c.yc)) / (T(Y) - T(c.yc));
    return fobj(yr, nx, Y, x, c) < T(1) && Fn >= T(1);
  };
  if (!fresh(y)) return;

  T val[9];
  bool dep;
  if (x == 0 || x == nx - 1) {
    // inlet/outlet: copy the row toward the channel centre (:408-422)
    const int ys = y < c.y0 ? y + 1 : y - 1;
    const bool ok = ys >= 0 && ys < ny;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      val[k] = ok ? g2[k * n + (size_t)ys * nx + x] : T(0);
    dep = ok && fresh(ys);
  } else {
    // Ffrac-weighted 3x3 average (:465-490), Ffrac = max(trunc(F_old), 0)
    T W[3][3], acc[9], sum = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = T(0);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int Y = y + j - 1, X = x + a - 1;
        const bool ok = Y >= 0 && Y < ny;
        const T w = ok ? max0(trunc(fobj(yr, nx, Y, X, c))) : T(0);
        W[j][a] = w;
        sum = sum + w;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          acc[k] = acc[k] + (ok ? g2[k * n + (size_t)Y * nx + X] : T(0)) * w;
      }
    }
    const T den = (sum != sum) ? sum : (sum < T(1e-30) ? T(1e-30) : sum);
#pragma unroll
    for (int I = 0; I < 9; ++I) {
      const int kI = k_from_i(I);
      // replace only directions whose upstream old cell was not plain fluid
      val[kI] = W[1 - ey_i(I)][1 - ex_i(I)] != T(1) ? acc[kI] / den
                                                    : g2[kI * n + i];
    }
    dep = sum == T(0);   // the reference would run its ring search here
  }
  const int slot = atomicAdd(&ctr[kCnt + par], 1);
  if (slot < cap) {
    list_idx[slot] = (int)i;
#pragma unroll
    for (int k = 0; k < 9; ++k) list_val[(size_t)k * cap + slot] = val[k];
  }
  if (dep) atomicOr(&ctr[kFlag + par], 1);
}

// ------------------------------------------------------- 8. reseed scatter
template <typename T>
__global__ void reseed_scatter_kernel(T* __restrict__ g2, T* __restrict__ mac,
                                      const int* __restrict__ list_idx,
                                      const T* __restrict__ list_val,
                                      int* __restrict__ ctr, int par, int cap,
                                      int ny, int nx, PulsatileConst c) {
  const size_t n = (size_t)ny * nx;
  const int cnt = ctr[kCnt + par];
  const int m = cnt < cap ? cnt : cap;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += gridDim.x * blockDim.x) {
    const size_t i = (size_t)list_idx[j];
    T v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      v[k] = list_val[(size_t)k * cap + j];
      g2[k * n + i] = v[k];
    }
    // fresh cells take the FULL first moment (reference :492-498)
    T P = T(1) * v[0], mx = T(cx(0)) * v[0], my = T(cy(0)) * v[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      P = P + T(1) * v[k];
      mx = mx + T(cx(k)) * v[k];
      my = my + T(cy(k)) * v[k];
    }
    mac[i] = P * T(1);
    mac[n + i] = T(3) * mx / T(c.rho0);
    mac[2 * n + i] = T(3) * my / T(c.rho0);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctr[kDiagDep] += ctr[kFlag + par] != 0;
    ctr[kDiagCells] += cnt;
    ctr[kDiagOver] += cnt > cap;
    ctr[kCnt + 1 - par] = 0;    // the next step's slots
    ctr[kFlag + 1 - par] = 0;
  }
}

template <typename T>
int launch_step(const T* gc, const T* gs, const T* mac, const T* yr,
                T* gc_o, T* gs_o, T* mac_o, T* yr_o, int* bz_idx, T* bz_val,
                int* rs_idx, T* rs_val, int* ctr, int ny, int nx, int cap,
                int t, int par, const PulsatileConst* c,
                cudaStream_t stream) {
  const size_t n = (size_t)ny * nx;
  const int threads = 256;
  const unsigned cells = (unsigned)((n + threads - 1) / threads);
  const unsigned cols = (unsigned)((nx + 127) / 128);
  const unsigned links = (unsigned)((6 * nx + 255) / 256);
  unsigned rs = (unsigned)((cap + threads - 1) / threads);
  rs = rs > 264 ? 264 : rs;
  cudaError_t err;
#define MLBM_CHECK()                                   \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err
  collide_kernel<T><<<cells, threads, 0, stream>>>(gc, gs, mac, yr, gc_o, ny,
                                                   nx, *c);
  MLBM_CHECK();
  for (int bottom = 1; bottom >= 0; --bottom) {
    bouzidi_links_kernel<T>
        <<<cols, 128, 0, stream>>>(gc_o, yr, bz_idx, bz_val, ny, nx, bottom,
                                   *c);
    MLBM_CHECK();
    bouzidi_scatter_kernel<T>
        <<<links, 256, 0, stream>>>(gc_o, bz_idx, bz_val, 6 * nx);
    MLBM_CHECK();
  }
  stream_kernel<T><<<cells, threads, 0, stream>>>(gc_o, yr, gs_o, mac_o, ny,
                                                  nx, t, *c);
  MLBM_CHECK();
  tail_kernel<T><<<cells, threads, 0, stream>>>(gs_o, mac_o, yr, yr_o, rs_idx,
                                                rs_val, ctr, par, cap, ny, nx,
                                                *c);
  MLBM_CHECK();
  reseed_scatter_kernel<T><<<rs, threads, 0, stream>>>(
      gs_o, mac_o, rs_idx, rs_val, ctr, par, cap, ny, nx, *c);
  MLBM_CHECK();
#undef MLBM_CHECK
  return 0;
}

}  // namespace

extern "C" {

// One step from (gc, gs, mac, yr) to (gc_o, gs_o, mac_o, yr_o): populations
// (9, ny, nx), mac (3, ny, nx) = (P, Ux, Uy), yr (2, nx) = (yr1, yr2).
// Scratch: bz_idx/bz_val 6·nx entries, rs_idx/rs_val cap entries (rs_val
// 9·cap), ctr 8 ints (zeroed by the caller before the first step; the
// device adds to ctr[0..2]).  t is the step index, par = t's parity within
// the caller's run.  Returns the cudaError_t of the launches (0 on success).
int pulsatile_step_f32(const void* gc, const void* gs, const void* mac,
                       const void* yr, void* gc_o, void* gs_o, void* mac_o,
                       void* yr_o, void* bz_idx, void* bz_val, void* rs_idx,
                       void* rs_val, void* ctr, int ny, int nx, int cap, int t,
                       int par, const void* consts, void* stream) {
  return launch_step<float>(
      (const float*)gc, (const float*)gs, (const float*)mac,
      (const float*)yr, (float*)gc_o, (float*)gs_o, (float*)mac_o,
      (float*)yr_o, (int*)bz_idx, (float*)bz_val, (int*)rs_idx,
      (float*)rs_val, (int*)ctr, ny, nx, cap, t, par,
      (const PulsatileConst*)consts, (cudaStream_t)stream);
}

int pulsatile_step_f64(const void* gc, const void* gs, const void* mac,
                       const void* yr, void* gc_o, void* gs_o, void* mac_o,
                       void* yr_o, void* bz_idx, void* bz_val, void* rs_idx,
                       void* rs_val, void* ctr, int ny, int nx, int cap, int t,
                       int par, const void* consts, void* stream) {
  return launch_step<double>(
      (const double*)gc, (const double*)gs, (const double*)mac,
      (const double*)yr, (double*)gc_o, (double*)gs_o, (double*)mac_o,
      (double*)yr_o, (int*)bz_idx, (double*)bz_val, (int*)rs_idx,
      (double*)rs_val, (int*)ctr, ny, nx, cap, t, par,
      (const PulsatileConst*)consts, (cudaStream_t)stream);
}

}  // extern "C"
