// One full reference iteration of the deformable pulsatile vessel (D2Q9,
// pressure-form MRT, two moving Bouzidi walls, Zou/He pressure ends, wall
// ODE, geometry rebuild, fresh-node reseed) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_pulsatile_full.py:_make_kernel (the
// Pallas TPU kernel behind run_fused_full) and computes what its substep
// computes in the reference parity mode (momentum quirk on, ping-pong
// collisions, the reference's scrambled MRT basis, no Zou/He corner
// closure).  The Pallas kernel kept the whole lattice resident in 100 MB of
// VMEM across nsub sub-steps; Hopper has no such memory and runs blocks in
// no order, so a step is five launches, each boundary placed where the next
// phase needs the whole lattice (or a whole wall pass) finished:
//   1. links_kernel, bottom wall: one thread per (slot, column).  Slots 0-4
//      are the links of the column's main border node (the solid cell just
//      outside the wall), slot 5 the jump node between columns X − 1 and X.
//      Each thread evaluates its link's quadratic Bouzidi value in closed
//      form from yr at X − 1, X, X + 1 (no Δ field is stored), reading the
//      post-collision populations of up to three cells along the link: it
//      recomputes them through load_cell and collide_in, the functions the
//      tile uses, so they are the values the step's gout holds.  It writes
//      (index, value) to its slot of a side buffer.
//   2. links_kernel, top wall: the same, but the pass must see the bottom
//      pass's writes (in a narrow passage a top link samples a bottom border
//      cell): a read of population k at (Y, X) looks for k's index in the
//      bottom slots of columns X and X + 1 (the jump node of column X + 1
//      writes in column X).  Within a pass every (cell, population) is
//      written by at most one link (the main and jump nodes of a wall
//      occupy distinct rows of a column).  One launch for both walls, each
//      top read near the bottom wall recomputing the bottom links it needs,
//      measured slower at N = 64, whose narrow columns send most top reads
//      down that path (PERF.md §6).
//   3. tile_kernel: a block owns a strip of 64 columns and marches down
//      `bands` bands of 4 rows (enough blocks to fill the card, up to 16
//      bands a block), keeping each band plus a 1-cell halo (6 rows of 66)
//      in a ring in shared memory: the first band collides all six rows, each
//      later band the four new ones, one cell a thread, with that cell's
//      loads issued before the band above finishes.  A cell's collision:
//      fluid from the analytic Fobj of the current walls, F = (ysel −
//      yc)/(Y − yc) by division as the plain path forms it (Pallas
//      multiplies by a reciprocal, which can flip a fluid decision at
//      F ≈ 1); the low-rank MRT post-collision state at fluid cells,
//      g_stream at solid ones (the ping-pong aliasing).  The side-buffer
//      entries that fall in the new rows go over them (the bottom wall's, a
//      barrier, the top wall's: the top pass wins).  Each own cell then
//      writes its gout (the next state's g_coll), pulls its populations
//      from the ring (periodic in x and y), applies Zou/He at x = 0 and
//      x = nx − 1 from the old walls, forms the macros with the reference's
//      k = 0 momentum quirk, masked with its old fluid flag, and writes g2
//      (the next g_stream) and mac.
//   4. tail_kernel: eight threads per (column, wall) run the column's wall
//      ODE, from P at rows y0 and y0 + 1 (not once for every cell of the
//      column), and look for the wall's fresh cells (solid under the old
//      walls, fluid under the new) only in a window of rows around the old
//      and new wall positions (fresh_window), a row a thread.  They fill
//      each fresh cell densely from the pre-reseed g2 into a compact list
//      (slot by atomicAdd), so no thread reads a cell that another thread
//      of the launch writes.  A fill that reads a fresh cell (an edge copy
//      from a fresh row, or an interior cell with no old-fluid neighbour,
//      where the reference's sequential ring search would run) marks the
//      step order-dependent; the kernel fills it densely, as the Pallas
//      kernel does, and counts it.
//   5. reseed_scatter_kernel: writes the fills and the fresh cells' macros
//      (the full first moment); block 0 adds the step's order-dependence
//      flag and fresh-cell count to the device counters and clears the
//      other parity's slots for the next step.  Cells that stay fluid, stay
//      solid or are killed keep the macros of launch 3, which equal the
//      plain path's re-masked values.
// pulsatile_run_* loops the five launches over n_steps steps on the
// caller's stream, ping-ponging two buffer sets, so a call costs one host
// crossing.  A call of GRAPH_STEPS steps or more launches step 0, captures
// steps 1 and 2 in a CUDA graph and replays it for every further pair: the
// pairs read and write the same buffers, and the tile takes the step index
// from a device counter that the scatter advances.
//
// The fresh window is exact: for a fixed wall the numerator ysel − yc is
// one rounded value and the denominator Y − yc a half-integer, exact in
// either type, so F is monotone in Y on each side of yc under correctly
// rounded division, and more than two rows from the wall F stays clear of
// 1 by far more than a rounding.  Rows outside the window are therefore
// never fresh; a wall that is not finite or lies beyond the lattice's
// edge by four rows takes the per-cell test over its whole side
// (tests/test_torch_pulsatile_emulated.py holds fresh_map_kernel, the
// window's own code, to the per-cell test on random, NaN and inverted
// walls).
//
// Arithmetic follows the plain path (multiphase_lbm_tpu_torch/models/
// pulsatile.py) operation by operation: sums run k = 0..8 one rounding at a
// time, constants arrive as doubles and are rounded once to the working
// type (in_type) as JAX rounds Python floats, and ops/_build.py compiles this file with -fmad=false so
// no multiply and add fuse.  The model is chaotic (staircase wall decisions
// amplify ulp noise), so that is what lets the float64 kernel stay on the
// plain path's trajectory over tens of steps.  Indices are 32-bit (the
// entry refuses 9 · ny · nx >= 2^31).
//
// Bound: device memory.  A step must read g_coll at fluid cells or g_stream
// at solid ones (36 B in float32) and the macros (12 B), and write gout, g2
// and the macros (84 B): 132 B per cell, 194 MB per step at N = 384
// (3,821 × 384), so no step takes less than 0.058 ms at 3.35 TB/s.  The
// tile reads the halo of its strip and of its first band again (mostly
// from L2, where the neighbouring strips read it); the link, tail and
// scatter launches touch O(nx) cells.
#include <cuda_runtime.h>
#include <math.h>

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

// The tile launch's band (ops/pulsatile_fused.TILE mirrors it): a block
// owns a strip of TILE_X columns and marches down its bands of TILE_Y rows,
// keeping the band plus a 1-cell halo (GX columns) in a ring of RB rows of
// shared memory.  Each band adds TILE_Y rows of GX cells to the ring, one
// cell a thread.  The side-buffer columns whose slots can land in the box
// are its GX columns and the one right of it (SCAN).
constexpr int TILE_X = 64, TILE_Y = 4;
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int GX = TILE_X + 2, RB = TILE_Y + 2, RN = RB * GX;
constexpr int NEW = TILE_Y * GX;
constexpr int BOX_THREADS = (NEW + 31) / 32 * 32;
constexpr int SCAN = GX + 1, SLOTS = 6 * SCAN;
// blocks the tile launch aims at: four waves of three blocks on each of
// the H100's 132 SMs; larger lattices give a block more bands
constexpr int BLOCKS_AIM = 4 * 3 * 132;
constexpr int MAX_BANDS = 16;
// calls of this many steps or more replay a captured graph of two steps
constexpr int GRAPH_STEPS = 8;
constexpr int LINK_THREADS = 128;

// PulsatileConst in the working type, each double rounded once on the host
// (as a conversion on the device would round it), so that the kernels do
// no double-to-float conversion.
template <typename T>
struct Const {
  T Mr[81], C[81];
  T rho0, rho0_3, rho0_2_9, rho0_18, neg_rho0_18, yc, alpha, p_tissue, ytop;
  T pin, pout, p_osc, omega;
  int nrel, y0, t_start, t_prop, severed, t_sever;
};

template <typename T>
Const<T> in_type(const PulsatileConst& c) {
  Const<T> k;
  for (int j = 0; j < 81; ++j) {
    k.Mr[j] = T(c.Mr[j]);
    k.C[j] = T(c.C[j]);
  }
  k.rho0 = T(c.rho0), k.rho0_3 = T(c.rho0_3), k.rho0_2_9 = T(c.rho0_2_9);
  k.rho0_18 = T(c.rho0_18), k.neg_rho0_18 = T(c.neg_rho0_18);
  k.yc = T(c.yc), k.alpha = T(c.alpha), k.p_tissue = T(c.p_tissue);
  k.ytop = T(c.ytop), k.pin = T(c.pin), k.pout = T(c.pout);
  k.p_osc = T(c.p_osc), k.omega = T(c.omega);
  k.nrel = c.nrel, k.y0 = c.y0, k.t_start = c.t_start, k.t_prop = c.t_prop;
  k.severed = c.severed, k.t_sever = c.t_sever;
  return k;
}

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

// v mod n in [0, n) for any v and n >= 1.
__device__ __forceinline__ int wrap(int v, int n) {
  if ((unsigned)v < (unsigned)n) return v;
  const int r = v % n;
  return r < 0 ? r + n : r;
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
                                  const Const<T>& c) {
  const T ysel = (Y <= c.y0) ? yr[X] : yr[nx + X];
  return (ysel - T(c.yc)) / (T(Y) - T(c.yc));
}

// Δ = max(0, 1 − |Y1/(mA − mB)|)
template <typename T>
__device__ __forceinline__ T find_delta(double mA, T mB, T Y1) {
  return max0(T(1) - fabs(Y1 / (T(mA) - mB)));
}

// ---------------------------------------------------------------- collide
// What the collision of one cell reads: its fluid flag (the analytic Fobj
// of the current walls), g_coll at a fluid cell or g_stream at a solid one,
// and the macros at a fluid cell.
template <typename T>
struct CellIn {
  T g[9], P, ux, uy;
  bool fluid;
};

template <typename T>
__device__ __forceinline__ void load_cell(const T* __restrict__ gc,
                                          const T* __restrict__ gs,
                                          const T* __restrict__ mac,
                                          const T* __restrict__ yr, int n,
                                          int nx, int y, int x,
                                          const Const<T>& c, CellIn<T>& in) {
  const int i = y * nx + x;
  in.fluid = fobj(yr, nx, y, x, c) >= T(1);
  const T* src = in.fluid ? gc : gs;
#pragma unroll
  for (int k = 0; k < 9; ++k) in.g[k] = src[k * n + i];
  in.P = in.fluid ? mac[i] : T(0);
  in.ux = in.fluid ? mac[n + i] : T(0);
  in.uy = in.fluid ? mac[2 * n + i] : T(0);
}

// The post-collision populations of a loaded cell: the low-rank MRT state
// at a fluid cell, g_stream at a solid one (the ping-pong aliasing).
template <typename T>
__device__ __forceinline__ void collide_in(const CellIn<T>& in,
                                           const Const<T>& c, T (&out)[9]) {
  if (!in.fluid) {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = in.g[k];
    return;
  }
  const T ux = in.ux, uy = in.uy;
  const T usqr = T(1.5) * (ux * ux + uy * uy);
  T d[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
    out[k] =
        T(wk(k)) * (in.P + T(c.rho0_3) * (cu * (T(3) + T(4.5) * cu) - usqr));
    d[k] = in.g[k] - out[k];
  }
  // post = g_eq − Σ_j (S_j − 1) M⁻¹[:, j] (M_j · (g − g_eq)): only the
  // relaxed moments (S_j ≠ 1) enter, as in the Pallas kernel's low-rank
  // form; r runs to 9 so that every index into c is a constant
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    if (r >= c.nrel) break;
    T m = T(c.Mr[9 * r]) * d[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) m = m + T(c.Mr[9 * r + k]) * d[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = out[k] - T(c.C[9 * r + k]) * m;
  }
}

// -------------------------------------------------------------- Bouzidi
// Border row of column X (models/pulsatile.py border_deltas): the highest
// solid row under the bottom wall, the lowest solid row over the top wall.
template <typename T>
__device__ __forceinline__ int border_row(const T* yr, int ny, int nx, int X,
                                          bool bottom, const Const<T>& c) {
  const T v = bottom ? yr[X] : yr[nx + X];
  const int Y0 = bottom ? (int)floor(v) : (int)ceil(v);
  const int Yg = Y0 < -1 ? -1 : (Y0 > ny ? ny : Y0);  // the F halo's clamp
  const bool fl0 = fobj(yr, nx, Yg, X, c) >= T(1);
  int Y = bottom ? (fl0 ? Y0 - 1 : Y0) : (fl0 ? Y0 + 1 : Y0);
  return Y < 0 ? 0 : (Y > ny - 1 ? ny - 1 : Y);
}

// The link of slot s of column X of one wall (reference :302-319 bottom,
// :346-364 top, jump nodes :307-313 and :352-358): its direction I, node
// (Y, Xn) and Δ.  False when the slot writes nothing: a link is written
// only if Δ < 1 and its first sample lies inside the lattice.  Slots 0-4
// are the main border node's links, slot 5 the jump node between columns
// X − 1 and X (up to one extra link, in column X or in column X − 1).
template <typename T>
__device__ __forceinline__ bool slot_link(const T* yr, int ny, int nx,
                                          bool bottom, int s, int X,
                                          const Const<T>& c, int& I, int& Y,
                                          int& Xn, T& D) {
  const T* w = bottom ? yr : yr + nx;   // this wall's row
  const T r = w[X];
  const T r_w = w[X == 0 ? nx - 1 : X - 1];
  const T r_e = w[X == nx - 1 ? 0 : X + 1];
  const T slope_e = r_e - r, slope_w = r - r_w;
  const int Yx = border_row(yr, ny, nx, X, bottom, c);
  const T dist = r - T(Yx);
  const bool int_e = X != nx - 1, int_w = X != 0;
  auto fl = [&](int Yc, int Xc) { return fobj(yr, nx, Yc, Xc, c) >= T(1); };
  const T two = T(2);
  Y = Yx, Xn = X;
  if (s < 5) {
    if (bottom) {   // D[0] E, D[1] N, D[2] W, D[4] NE, D[5] NW
      switch (s) {
        case 0:
          I = 1;
          D = (int_e && fl(Yx, X + 1)) ? find_delta(0.0, slope_e, dist) : two;
          break;
        case 1:
          I = 2;
          D = T(1) - (r - T(Yx));
          break;
        case 2:
          I = 3;
          D = (int_w && fl(Yx, X - 1)) ? find_delta(0.0, slope_w, dist) : two;
          break;
        case 3:
          I = 5;
          D = (int_e && fl(Yx + 1, X + 1)) ? find_delta(1.0, slope_e, dist)
                                           : two;
          break;
        default:
          I = 6;
          D = (int_w && fl(Yx + 1, X - 1)) ? find_delta(-1.0, slope_w, dist)
                                           : two;
      }
    } else {        // D[0] E, D[2] W, D[3] S, D[6] SW, D[7] SE
      switch (s) {
        case 0:
          I = 1;
          D = (int_e && fl(Yx, X + 1)) ? find_delta(0.0, slope_e, dist) : two;
          break;
        case 1:
          I = 3;
          D = (int_w && fl(Yx, X - 1)) ? find_delta(0.0, slope_w, dist) : two;
          break;
        case 2:
          I = 4;
          D = T(1) - (T(Yx) - r);
          break;
        case 3:
          I = 7;
          D = (int_w && fl(Yx - 1, X - 1)) ? find_delta(1.0, slope_w, dist)
                                           : two;
          break;
        default:
          I = 8;
          D = (int_e && fl(Yx - 1, X + 1)) ? find_delta(-1.0, slope_e, dist)
                                           : two;
      }
    }
  } else {
    if (X == 0) return false;
    const int Yp = border_row(yr, ny, nx, X - 1, bottom, c);
    if (Yp == Yx) return false;
    if (bottom) {
      if (Yx > Yp) {   // node (Yp, X), D[5] NW
        I = 6, Y = Yp;
        D = find_delta(-1.0, slope_w, r - T(Yp));
      } else {         // node (Yx, X − 1), D[4] NE
        I = 5, Xn = X - 1;
        D = find_delta(1.0, slope_w, r_w - T(Yx));
      }
    } else {
      if (Yx > Yp) {   // node (Yx, X − 1), D[7] SE
        I = 8, Xn = X - 1;
        D = find_delta(-1.0, slope_w, r_w - T(Yx));
      } else {         // node (Yp, X), D[6] SW
        I = 7, Y = Yp;
        D = find_delta(1.0, slope_w, r - T(Yp));
      }
    }
  }
  const int Xs = Xn + ex_i(I), Ys = Y + ey_i(I);
  return D < T(1) && Xs >= 0 && Xs < nx && Ys >= 0 && Ys < ny;
}

// What a wall pass reads: the post-collision populations, and in the top
// pass (bidx non-null) the bottom pass's writes over them.
template <typename T>
struct PassSource {
  const T *gc, *gs, *mac, *yr;
  const int* bidx;   // the bottom pass's slots, or null
  const T* bval;
  int ny, nx;
  const Const<T>& c;

  // populations kI and kJ of cell (Y, X), which lies in the lattice
  __device__ __forceinline__ void read(int Y, int X, int kI, int kJ, T& vI,
                                       T& vJ) const {
    const int n = ny * nx;
    CellIn<T> in;
    T post[9];
    load_cell(gc, gs, mac, yr, n, nx, Y, X, c, in);
    collide_in(in, c, post);
    vI = post[kI];
    vJ = post[kJ];
    if (!bidx) return;
    // the bottom pass writes column X from the slots of columns X and
    // X + 1 (whose jump node can lie in column X)
    const int tI = kI * n + Y * nx + X, tJ = kJ * n + Y * nx + X;
#pragma unroll
    for (int s = 0; s < 6; ++s) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int at = s * nx + X + dx;
        if (X + dx >= nx) continue;
        const int id = bidx[at];
        if (id == tI) vI = bval[at];
        if (id == tJ) vJ = bval[at];
      }
    }
  }
};

// One Bouzidi link of direction I at border cell (Y, X) with Δ = D:
// quadratic interpolation along the link with the reference's fallback order
// (models/pulsatile.py _bouzidi_one).  (Y + ey, X + ex) lies in the lattice.
// The three samples are read before the fallbacks choose among them, so
// that their loads overlap.
template <typename T>
__device__ __forceinline__ T link_value(const PassSource<T>& src, int I,
                                        int Y, int X, T D) {
  const int ex = ex_i(I), ey = ey_i(I);
  const int kI = k_from_i(I), kJ = k_from_i(jb_i(I));
  T gI[3], gJ[3], F[3];
  bool in[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int Xm = X + (m + 1) * ex, Ym = Y + (m + 1) * ey;
    in[m] = Xm >= 0 && Xm < src.nx && Ym >= 0 && Ym < src.ny;
    gI[m] = gJ[m] = F[m] = T(0);
    if (in[m]) {
      src.read(Ym, Xm, kI, kJ, gI[m], gJ[m]);
      F[m] = fobj(src.yr, src.nx, Ym, Xm, src.c);
    }
  }
  const T gI1 = gI[0], gJ1 = gJ[0], F1 = F[0];
  const T F2_eff = in[1] ? F[1] : F1;
  const bool use1for2 = (!in[1]) || (F2_eff < T(1));
  const T gJ2 = use1for2 ? gJ1 : gJ[1];
  const T gI2 = use1for2 ? gI1 : gI[1];
  const T F3_eff = in[2] ? F[2] : F1;
  T gJ3 = in[2] ? gJ[2] : gJ1;
  if (F3_eff < T(1)) gJ3 = gJ2;
  const T p = T(1) + T(2) * D, q = T(1) - T(2) * D;
  if (D < T(0.5))
    return gJ1 * p * D + gJ2 * q * p - gJ3 * q * D;
  return (gJ1 - gI1 * q * p + gI2 * q * D) / (D * p + T(1e-30));
}

// One thread a (slot, column) of one wall: slot s of column X is
// idx/val[6·nx·top + s·nx + X] (slot-major, so that the threads of a warp
// take one direction of 32 columns); a slot that writes nothing holds
// index −1.  The top wall's launch reads the bottom wall's slots.
template <typename T>
__global__ void __launch_bounds__(LINK_THREADS)
links_kernel(const T* __restrict__ gc, const T* __restrict__ gs,
             const T* __restrict__ mac, const T* __restrict__ yr,
             int* __restrict__ idx, T* __restrict__ val, int ny, int nx,
             int top, Const<T> c) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 6 * nx) return;
  const int s = j / nx, X = j - s * nx;
  int* id = idx + (top ? 6 * nx : 0) + j;
  *id = -1;
  int I, Y, Xn;
  T D;
  if (!slot_link(yr, ny, nx, !top, s, X, c, I, Y, Xn, D)) return;
  const PassSource<T> src{gc, gs, mac, yr, top ? idx : nullptr,
                          top ? val : nullptr, ny, nx, c};
  val[(top ? 6 * nx : 0) + j] = link_value(src, I, Y, Xn, D);
  *id = k_from_i(I) * ny * nx + Y * nx + Xn;
}

// --------------------------------------------- the tile: collide + stream
template <typename T>
__device__ __forceinline__ void waveforms(int t, const Const<T>& c,
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

// Zou/He at x = 0 and x = nx − 1 from the old walls (at step t0 + *step),
// then the macros with the reference's k = 0 momentum quirk, masked with
// the cell's old fluid flag, of cell (y, x) = i whose pulled populations
// are g: writes g2 and mac_o.
template <typename T>
__device__ __forceinline__ void finish_cell(T (&g)[9], bool fluid,
                                            const T* __restrict__ yr,
                                            T* __restrict__ g2,
                                            T* __restrict__ mac_o, int n,
                                            int ny, int nx, int x, int y,
                                            int i, int t0, const int* step,
                                            const Const<T>& c) {
  constexpr int k0 = k_from_i(0), k1 = k_from_i(1), k2 = k_from_i(2),
                k3 = k_from_i(3), k4 = k_from_i(4), k5 = k_from_i(5),
                k6 = k_from_i(6), k7 = k_from_i(7), k8 = k_from_i(8);
  if ((x == 0 && zh_row(yr, ny, nx, 0, y)) ||
      (x == nx - 1 && zh_row(yr, ny, nx, nx - 1, y))) {
    T Pin, Pout;
    waveforms<T>(t0 + *step, c, &Pin, &Pout);
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
  const T m = fluid ? T(1) : T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) g2[k * n + i] = g[k];
  mac_o[i] = P * m;
  mac_o[n + i] = T(3) * mx / T(c.rho0) * m;
  mac_o[2 * n + i] = T(3) * my / T(c.rho0) * m;
}

// Three blocks of 288 threads an SM in float32 (27 warps).  While a band's
// own cells are finished, each thread's loads for the next band are in
// flight.
template <typename T>
__global__ void __launch_bounds__(BOX_THREADS, sizeof(T) == 4 ? 3 : 2)
tile_kernel(const T* __restrict__ gc, const T* __restrict__ gs,
            const T* __restrict__ mac, const T* __restrict__ yr,
            const int* __restrict__ bidx, const T* __restrict__ bval,
            T* __restrict__ gout, T* __restrict__ g2, T* __restrict__ mac_o,
            const int* __restrict__ step, int ny, int nx, int t0, int bands,
            Const<T> c) {
  __shared__ T s_g[9 * RN];
  __shared__ bool s_fl[RN];
  // the strip's Bouzidi slots, bottom wall then top: the row (−1: none),
  // the population, the first box column and the value of each
  __shared__ int s_row[2 * SLOTS], s_k[2 * SLOTS], s_bx[2 * SLOTS];
  __shared__ T s_val[2 * SLOTS];
  const int n = ny * nx;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TILE_X;
  // box row q holds lattice row ys − 1 + q (wrapped); ring slot q mod RB
  const int ys = blockIdx.y * bands * TILE_Y;

  const int ncol = nx < SCAN ? nx : SCAN;
  for (int e = tid; e < 2 * SLOTS; e += BOX_THREADS) {
    const int wall = e / SLOTS, r = e - wall * SLOTS;
    const int s = r / SCAN, q = r - s * SCAN;
    int id = -1;
    T v = T(0);
    if (q < ncol) {
      const int at = 6 * nx * wall + s * nx + wrap(x0 - 1 + q, nx);
      id = bidx[at];
      v = bval[at];
    }
    const int k = id / n, cell = id - k * n;
    const int Y = cell / nx, X = cell - Y * nx;
    s_row[e] = id < 0 ? -1 : Y;
    s_k[e] = k;
    s_bx[e] = wrap(X - x0 + 1, nx);
    s_val[e] = v;
  }

  // the post-collision populations of box rows q0 .. q0 + nq − 1
  auto store = [&](int q, int bx, const CellIn<T>& in) {
    T post[9];
    collide_in(in, c, post);
    const int at = (q % RB) * GX + bx;
    s_fl[at] = in.fluid;
#pragma unroll
    for (int k = 0; k < 9; ++k) s_g[k * RN + at] = post[k];
  };
  // the slots over box rows q0 .. q0 + nq − 1: the bottom wall's, then the
  // top's (every box position of a cell: a lattice narrower than the box
  // holds a cell more than once)
  auto overlay = [&](int q0, int nq) {
    for (int wall = 0; wall < 2; ++wall) {
      for (int e = wall * SLOTS + tid; e < (wall + 1) * SLOTS;
           e += BOX_THREADS) {
        const int Y = s_row[e];
        if (Y < 0) continue;
        for (int q = q0 + wrap(Y - ys + 1 - q0, ny); q < q0 + nq; q += ny)
          for (int bx = s_bx[e]; bx < GX; bx += nx)
            s_g[s_k[e] * RN + (q % RB) * GX + bx] = s_val[e];
      }
      __syncthreads();
    }
  };

  // ---- the first band's box: RB rows ----
  for (int r = tid; r < RN; r += BOX_THREADS) {
    const int q = r / GX, bx = r - q * GX;
    CellIn<T> in;
    load_cell(gc, gs, mac, yr, n, nx, wrap(ys - 1 + q, ny),
              wrap(x0 - 1 + bx, nx), c, in);
    store(q, bx, in);
  }
  __syncthreads();
  overlay(0, RB);

  const int qa = tid / GX, ba = tid - qa * GX;   // this thread's new cell
  const int tx = tid % TILE_X, ty = tid / TILE_X;
  for (int b = 0; b < bands; ++b) {
    // the next band's new rows, loaded now, collided after this band
    const int qn = (b + 1) * TILE_Y + 2;
    const bool more = b + 1 < bands;
    CellIn<T> next;
    if (more && tid < NEW)
      load_cell(gc, gs, mac, yr, n, nx, wrap(ys - 1 + qn + qa, ny),
                wrap(x0 - 1 + ba, nx), c, next);

    // ---- the band's own cells: gout, pull, Zou/He, macros ----
    const int x = x0 + tx, y = ys + b * TILE_Y + ty;
    if (tid < THREADS && x < nx && y < ny) {
      const int i = y * nx + x;
      const int q = b * TILE_Y + ty + 1, bx = tx + 1;
      T g[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        gout[k * n + i] = s_g[k * RN + (q % RB) * GX + bx];
        g[k] = s_g[k * RN + ((q - cy(k)) % RB) * GX + bx - cx(k)];
      }
      finish_cell(g, s_fl[(q % RB) * GX + bx], yr, g2, mac_o, n, ny, nx, x,
                  y, i, t0, step, c);
    }
    if (!more) break;
    __syncthreads();              // the band's oldest TILE_Y rows may go
    if (tid < NEW) store(qn + qa, ba, next);
    __syncthreads();
    overlay(qn, TILE_Y);
  }
}

// ------------------------------------------------- wall ODE, fresh, reseed
// counters: [0] order-dependent steps, [1] reseeded cells, [2] steps whose
// fresh cells overflowed the list, [3] steps done in this call (the step
// index less t0, kept on the device so that a replayed graph advances it),
// [4 + parity] fresh cells of the step, [6 + parity] the step's
// order-dependence flag
enum {
  kDiagDep = 0, kDiagCells = 1, kDiagOver = 2, kStep = 3, kCnt = 4, kFlag = 6
};

template <typename T>
__device__ __forceinline__ T clamp_q(T v) {  // clip to ±0.25, NaN kept
  return v < T(-0.25) ? T(-0.25) : (v > T(0.25) ? T(0.25) : v);
}

// The column's new wall rows (models/pulsatile.py move_walls).
template <typename T>
__device__ __forceinline__ void move_walls(const T* mac, const T* yr, int nx,
                                           int x, const Const<T>& c,
                                           T& y1n, T& y2n) {
  const T Ps1 = mac[c.y0 * nx + x] - T(c.p_tissue);
  const T Ps2 = mac[(c.y0 + 1) * nx + x] - T(c.p_tissue);
  const T y1 = yr[x], y2 = yr[nx + x];
  y1n = y1 + clamp_q((T(0.5) - Ps1 / T(c.alpha)) - y1);
  y2n = y2 + clamp_q((T(c.ytop) + Ps2 / T(c.alpha)) - y2);
}

// Whether cell (Y, x) is fresh: solid under the old walls yr, fluid under
// the new walls (y1n, y2n) of its column.
template <typename T>
__device__ __forceinline__ bool is_fresh(const T* yr, int nx, int Y, int x,
                                         T y1n, T y2n,
                                         const Const<T>& c) {
  const T Fn = ((Y <= c.y0 ? y1n : y2n) - T(c.yc)) / (T(Y) - T(c.yc));
  return fobj(yr, nx, Y, x, c) < T(1) && Fn >= T(1);
}

// Rows [lo, hi] of one wall's side (the bottom's rows 0..y0, the top's
// y0 + 1..ny − 1) that can hold fresh cells of a column whose wall moves
// from v_old to v_new: two rows beyond the wall's old and new positions
// (see the header note), or the whole side for a wall that is not finite or
// lies four rows beyond the lattice.
template <typename T>
__device__ __forceinline__ void fresh_window(bool top, T v_old, T v_new,
                                             int ny, const Const<T>& c,
                                             int& lo, int& hi) {
  lo = top ? c.y0 + 1 : 0;
  hi = top ? ny - 1 : c.y0;
  const T lim = T(ny + 4);
  if (v_old > T(-4) && v_old < lim && v_new > T(-4) && v_new < lim) {
    const T a = v_old < v_new ? v_old : v_new;
    const T b = v_old < v_new ? v_new : v_old;
    const int wl = (int)floor(a) - 2, wh = (int)ceil(b) + 2;
    lo = lo > wl ? lo : wl;
    hi = hi < wh ? hi : wh;
  }
}

// WIN threads per (column, wall), (column, wall) j = 0..2nx − 1 with the
// bottom wall first; lane r takes rows lo + r, lo + r + WIN, ... of the
// wall's window [lo, hi].  A finite wall moves at most 0.25 rows a step, so
// its window spans at most 7 rows and every lane takes one row at most.
constexpr int WIN = 8;
constexpr int TAIL_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_kernel(const T* __restrict__ g2, const T* __restrict__ mac,
            const T* __restrict__ yr, T* __restrict__ yr_new,
            int* __restrict__ list_idx, T* __restrict__ list_val,
            int* __restrict__ ctr, int par, int cap, int ny, int nx,
            Const<T> c) {
  const int n = ny * nx;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = g / WIN, lane = g - j * WIN;
  if (j >= 2 * nx) return;
  const int top = j >= nx, x = j - top * nx;
  // both walls: an edge copy's source row can lie on the other wall's side
  T y1n, y2n;
  move_walls(mac, yr, nx, x, c, y1n, y2n);
  if (lane == 0) yr_new[j] = top ? y2n : y1n;
  int lo, hi;
  fresh_window<T>(top, yr[j], top ? y2n : y1n, ny, c, lo, hi);
  bool dep_any = false;
  for (int y = lo + lane; y <= hi; y += WIN) {
    if (!is_fresh(yr, nx, y, x, y1n, y2n, c)) continue;
    const int i = y * nx + x;
    T val[9];
    bool dep;
    if (x == 0 || x == nx - 1) {
      // inlet/outlet: copy the row toward the channel centre (:408-422)
      const int ys = y < c.y0 ? y + 1 : y - 1;
      const bool ok = ys >= 0 && ys < ny;
#pragma unroll
      for (int k = 0; k < 9; ++k) val[k] = ok ? g2[k * n + ys * nx + x] : T(0);
      dep = ok && is_fresh(yr, nx, ys, x, y1n, y2n, c);
    } else {
      // Ffrac-weighted 3x3 average (:465-490), Ffrac = max(trunc(F_old), 0)
      T W[3][3], acc[9], sum = T(0);
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] = T(0);
#pragma unroll
      for (int jy = 0; jy < 3; ++jy) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int Y = y + jy - 1, X = x + a - 1;
          const bool ok = Y >= 0 && Y < ny;
          const T w = ok ? max0(trunc(fobj(yr, nx, Y, X, c))) : T(0);
          W[jy][a] = w;
          sum = sum + w;
#pragma unroll
          for (int k = 0; k < 9; ++k)
            acc[k] = acc[k] + (ok ? g2[k * n + Y * nx + X] : T(0)) * w;
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
      list_idx[slot] = i;
#pragma unroll
      for (int k = 0; k < 9; ++k) list_val[k * cap + slot] = val[k];
    }
    dep_any = dep_any || dep;
  }
  if (dep_any) atomicOr(&ctr[kFlag + par], 1);
}

// One thread a fill: the fills and the fresh cells' macros (the full first
// moment); thread 0 adds the step's order-dependence flag and fresh-cell
// count to the device counters and clears the other parity's slots for the
// next step.
template <typename T>
__global__ void reseed_scatter_kernel(T* __restrict__ g2, T* __restrict__ mac,
                                      const int* __restrict__ list_idx,
                                      const T* __restrict__ list_val,
                                      int* __restrict__ ctr, int par, int cap,
                                      int ny, int nx, Const<T> c) {
  const int n = ny * nx;
  const int cnt = ctr[kCnt + par];
  const int m = cnt < cap ? cnt : cap;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += gridDim.x * blockDim.x) {
    const int i = list_idx[j];
    T v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      v[k] = list_val[k * cap + j];
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
    ctr[kStep] += 1;
  }
}

// The fresh cells of walls moving from yr to yr_new, through the tail's
// own window and test, as a (ny, nx) map (1 fresh; cells outside every
// window are left as they were).
template <typename T>
__global__ void fresh_map_kernel(const T* __restrict__ yr,
                                 const T* __restrict__ yr_new,
                                 unsigned char* __restrict__ map, int ny,
                                 int nx, Const<T> c) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = g / WIN, lane = g - j * WIN;
  if (j >= 2 * nx) return;
  const int top = j >= nx, x = j - top * nx;
  const T y1n = yr_new[x], y2n = yr_new[nx + x];
  int lo, hi;
  fresh_window<T>(top, yr[j], yr_new[j], ny, c, lo, hi);
  for (int y = lo + lane; y <= hi; y += WIN)
    map[y * nx + x] = is_fresh(yr, nx, y, x, y1n, y2n, c);
}

bool bad_shape(int ny, int nx) {
  return ny < 4 || nx < 2 || 9LL * ny * nx >= (1LL << 31) ||
         (ny + TILE_Y - 1) / TILE_Y > 65535;
}

template <typename T>
int run_steps(const T* gc, const T* gs, const T* mac, const T* yr,
              T* const (&dst)[2][4], int* bz_idx, T* bz_val, int* rs_idx,
              T* rs_val, int* ctr, int ny, int nx, int cap, int n_steps,
              int t0, const PulsatileConst* c, cudaStream_t stream) {
  if (bad_shape(ny, nx) || cap < 1 || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  const int strips = (nx + TILE_X - 1) / TILE_X;
  const int band_rows = (ny + TILE_Y - 1) / TILE_Y;
  int bands = (int)((long long)strips * band_rows / BLOCKS_AIM);
  bands = bands < 1 ? 1 : (bands > MAX_BANDS ? MAX_BANDS : bands);
  const dim3 tiles((unsigned)strips,
                   (unsigned)((band_rows + bands - 1) / bands));
  const unsigned links =
      (unsigned)((6 * nx + LINK_THREADS - 1) / LINK_THREADS);
  const unsigned walls =
      (unsigned)((2 * WIN * nx + TAIL_THREADS - 1) / TAIL_THREADS);
  unsigned rs = (unsigned)((cap + 255) / 256);
  rs = rs > 264 ? 264 : rs;
  const Const<T> kc = in_type<T>(*c);
  // step s: par = s mod 2 picks the buffer set it writes and the counters
  // it fills; it reads the input state (s = 0) or the other set
  auto launch = [&](int s, cudaStream_t st) {
    const int par = s & 1;
    const T* src_gc = s == 0 ? gc : dst[1 - par][0];
    const T* src_gs = s == 0 ? gs : dst[1 - par][1];
    const T* src_mac = s == 0 ? mac : dst[1 - par][2];
    const T* src_yr = s == 0 ? yr : dst[1 - par][3];
    T* const* o = dst[par];
    cudaError_t err;
    for (int top = 0; top < 2; ++top) {
      links_kernel<T><<<links, LINK_THREADS, 0, st>>>(
          src_gc, src_gs, src_mac, src_yr, bz_idx, bz_val, ny, nx, top, kc);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    tile_kernel<T><<<tiles, BOX_THREADS, 0, st>>>(
        src_gc, src_gs, src_mac, src_yr, bz_idx, bz_val, o[0], o[1], o[2],
        ctr + kStep, ny, nx, t0, bands, kc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    tail_kernel<T><<<walls, TAIL_THREADS, 0, st>>>(
        o[1], o[2], src_yr, o[3], rs_idx, rs_val, ctr, par, cap, ny, nx, kc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    reseed_scatter_kernel<T><<<rs, 256, 0, st>>>(
        o[1], o[2], rs_idx, rs_val, ctr, par, cap, ny, nx, kc);
    return cudaGetLastError();
  };
  int s = 0;
  cudaError_t err = cudaSuccess;
  if (n_steps >= GRAPH_STEPS) {
    // step 0, then the pairs (odd, even) from one captured graph: every
    // pair reads and writes the same buffers, and the step index comes
    // from the device counter
    if ((err = launch(s++, stream)) != cudaSuccess) return (int)err;
    cudaStream_t cs = nullptr;
    cudaGraph_t graph = nullptr;
    cudaGraphExec_t exec = nullptr;
    err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
    if (err == cudaSuccess)
      err = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
    if (err == cudaSuccess) {
      const cudaError_t e1 = launch(1, cs);
      const cudaError_t e2 = e1 == cudaSuccess ? launch(2, cs) : e1;
      err = cudaStreamEndCapture(cs, &graph);
      if (err == cudaSuccess) err = e2;
    }
    if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
    for (; err == cudaSuccess && s + 2 <= n_steps; s += 2)
      err = cudaGraphLaunch(exec, stream);
    if (exec) cudaGraphExecDestroy(exec);
    if (graph) cudaGraphDestroy(graph);
    if (cs) cudaStreamDestroy(cs);
    if (err != cudaSuccess) return (int)err;
  }
  for (; s < n_steps; ++s)
    if ((err = launch(s, stream)) != cudaSuccess) return (int)err;
  return 0;
}

template <typename T>
int run_entry(const void* const* p, int ny, int nx, int cap, int n_steps,
              int t0, const void* consts, void* stream) {
  T* const dst[2][4] = {{(T*)p[4], (T*)p[5], (T*)p[6], (T*)p[7]},
                        {(T*)p[8], (T*)p[9], (T*)p[10], (T*)p[11]}};
  return run_steps<T>((const T*)p[0], (const T*)p[1], (const T*)p[2],
                      (const T*)p[3], dst, (int*)p[12], (T*)p[13],
                      (int*)p[14], (T*)p[15], (int*)p[16], ny, nx, cap,
                      n_steps, t0, (const PulsatileConst*)consts,
                      (cudaStream_t)stream);
}

template <typename T>
int fresh_map_entry(const void* yr, const void* yr_new, void* map, int ny,
                    int nx, const void* consts, void* stream) {
  if (bad_shape(ny, nx)) return (int)cudaErrorInvalidValue;
  fresh_map_kernel<T><<<(unsigned)((2 * WIN * nx + 127) / 128), 128, 0,
                        (cudaStream_t)stream>>>(
      (const T*)yr, (const T*)yr_new, (unsigned char*)map, ny, nx,
      in_type<T>(*(const PulsatileConst*)consts));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n_steps steps from step index t0 of the state (gc, gs, mac, yr), which is
// only read: populations (9, ny, nx), mac (3, ny, nx) = (P, Ux, Uy), yr
// (2, nx) = (yr1, yr2).  Step s writes buffer set a = (gc_a, gs_a, mac_a,
// yr_a) when s is even and b when s is odd, so the result is in a when
// n_steps is odd and in b when it is even (b may be null when n_steps <= 1).
// Scratch: bz_idx/bz_val 12·nx entries (the bottom wall's six slots a
// column, then the top's), rs_idx/rs_val cap entries (rs_val 9·cap), ctr 8
// ints, zeroed by the caller (the device adds to ctr[0..2]).  Returns the
// cudaError_t of the first launch that failed (0 on success;
// cudaErrorInvalidValue, launching nothing, for ny < 4, nx < 2,
// 9 · ny · nx >= 2^31, cap < 1 or n_steps < 0).
int pulsatile_run_f32(const void* gc, const void* gs, const void* mac,
                      const void* yr, void* gc_a, void* gs_a, void* mac_a,
                      void* yr_a, void* gc_b, void* gs_b, void* mac_b,
                      void* yr_b, void* bz_idx, void* bz_val, void* rs_idx,
                      void* rs_val, void* ctr, int ny, int nx, int cap,
                      int n_steps, int t0, const void* consts, void* stream) {
  const void* p[17] = {gc,   gs,   mac,    yr,     gc_a,   gs_a,
                       mac_a, yr_a, gc_b,   gs_b,   mac_b,  yr_b,
                       bz_idx, bz_val, rs_idx, rs_val, ctr};
  return run_entry<float>(p, ny, nx, cap, n_steps, t0, consts, stream);
}

int pulsatile_run_f64(const void* gc, const void* gs, const void* mac,
                      const void* yr, void* gc_a, void* gs_a, void* mac_a,
                      void* yr_a, void* gc_b, void* gs_b, void* mac_b,
                      void* yr_b, void* bz_idx, void* bz_val, void* rs_idx,
                      void* rs_val, void* ctr, int ny, int nx, int cap,
                      int n_steps, int t0, const void* consts, void* stream) {
  const void* p[17] = {gc,   gs,   mac,    yr,     gc_a,   gs_a,
                       mac_a, yr_a, gc_b,   gs_b,   mac_b,  yr_b,
                       bz_idx, bz_val, rs_idx, rs_val, ctr};
  return run_entry<double>(p, ny, nx, cap, n_steps, t0, consts, stream);
}

// The fresh cells of walls moving from yr to yr_new (each (2, nx)) through
// the tail launch's window and test: map (ny, nx) bytes gets 1 at a fresh
// cell and 0 at a cell of a window that is not fresh; the caller zeroes it.
int pulsatile_fresh_map_f32(const void* yr, const void* yr_new, void* map,
                            int ny, int nx, const void* consts,
                            void* stream) {
  return fresh_map_entry<float>(yr, yr_new, map, ny, nx, consts, stream);
}

int pulsatile_fresh_map_f64(const void* yr, const void* yr_new, void* map,
                            int ny, int nx, const void* consts,
                            void* stream) {
  return fresh_map_entry<double>(yr, yr_new, map, ny, nx, consts, stream);
}

}  // extern "C"
