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
// cell) and write them back: 576 B per cell in float32 (72 B flow only).
// The arithmetic is a few hundred operations a cell: each collision is
// formed through the low-rank factors of its M⁻¹ diag(S) M, as the Pallas
// kernel's _mrt_terms does (BGK for g_T, rank 2 for each species, rank 0 to
// 6 for the flow).  At the reference's 420 × 80 the whole state is 9.7 MB
// and fits in the 50 MB L2, so the launches and the host set the pace there.
//
// Design.  At most three launches a step on one stream, none of them on a
// fixed grid:
//   1. boundary_kernel, inflow/outflow with all four populations: one
//      thread for each boundary cell of the slab (rows yb and yt, columns 1
//      and nx − 1) and each of g_O2, g_CO2 and g_T, 3 (2 nx + 2 ny) threads
//      over as many blocks as they fill.  A thread reads only the entry
//      state: what its cell's fixes read from other boundary cells it
//      recomputes in registers (see the kernel's comment), and it writes its
//      cell's final populations into a side buffer, never in place;
//   2. fields_kernel, konv only, one thread per cell: copies its own cell's
//      values from the side buffer into src and applies the flow outlet at
//      x = nx − 1 (boundary fixes first, as in the model), then the LI2014
//      conjugate fix of the cell's own incoming g_T entries from g_coll
//      (pull form: each entry has exactly one writer) unless first_step,
//      then ρ, u (with the half-force shift), Y_O2 and Y_CO2 into fld;
//   3. collide_stream_kernel, one thread per cell: flow only, it first
//      applies the flow outlet in registers at x = nx − 1 (one launch a
//      step); reads the fields at reach 2 (the one-sided gradients next to
//      solids), does the five collisions and the forcing, writes the three
//      new forcing terms and the new g_coll, and streams into the other
//      buffer of a ping-pong pair.  Every output slot is written exactly
//      once: the receiving cell writes it where the model's streaming keeps
//      or bounces a value there (its upstream is solid or an interface, the
//      outlet pin, a zeroed non-bulk cell), and otherwise the upstream cell
//      pushes its post-collision value.  Its registers are held down so that
//      two blocks of 256 threads fit on an SM in float32 without spills:
//      32-bit cell indices, the 16 neighbour flags packed 2 bits each into
//      two words, the interface mass fractions formed only where a rule
//      reads them, the kept or pinned incoming values written before the
//      collision, and g_T read once, before the species.
// Every neighbour read wraps modulo nx and ny, as the model's rolls do.
//
// Slab mode (the halo-in entry, pallas_combustion.step_fused_halo): the
// buffers hold ny rows of a lattice of ny_glob rows, local row 0 being global
// row row0 (0 <= row0 < ny_glob, ny <= ny_glob).  Each row's role is decided
// by its global row g = (row0 + y) mod ny_glob: the flow outlet on
// 1 <= g <= ny_glob − 2, the wall-row fixes at g = 1 and g = ny_glob − 2, the
// lid's momentum exchange at g = ny_glob − 1; the wall-row fixes read the
// local rows next to them (y ± 1, y ± 2, wrapping mod ny).  Each row of the
// slab then evolves as that global row does in the whole-lattice run, which
// wraps in y too, except that reads across the slab's edges wrap to its
// other edge: that reaches REACH rows in a step (ops/combustion_fused.py),
// all of them cropped by the caller.  The whole lattice is the slab
// row0 = 0, ny_glob = ny: one code path for both entries.
// Solid cells carry NaN in u and in the forcing terms, as in the model:
// every mask is a selection, never a product.  The flags, the interface
// normal factors ck_n (small integers, int8) and the momentum-exchange
// populations of the inlet column and the lid row are the only static
// inputs; every link mask is derived from the flags of its two ends.
#include <cuda_runtime.h>
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
  // collision factors (apply_lowrank) of the flow, O2, CO2, T gas, T solid
  // and the body force: lr_a[q], then lr_c[9 q + j] for the rows j of M
  double lr_a[6];
  double lr_c[54];
  int io, konv, li2014, body_force, solid_reaction;
};

namespace {

enum { BULK = 0, WALL = 1, SPECULAR = 2, OBSTACLE = 3 };
// planes of the (8, 9, ny, nx) state buffer
enum { P_F = 0, P_O2 = 1, P_CO2 = 2, P_T = 3, P_FO2 = 4, P_FCO2 = 5,
       P_FT = 6, P_GCOLL = 7 };
// planes of the (5, ny, nx) field buffer
enum { F_RHO = 0, F_UX = 1, F_UY = 2, F_YO2 = 3, F_YCO2 = 4 };
// collisions of CombustionConst.lr_a / lr_c
enum { LR_F = 0, LR_O2 = 1, LR_CO2 = 2, LR_T = 3, LR_TS = 4, LR_BODY = 5 };
constexpr int THREADS = 256;
// blocks of the collide launch an SM must hold (__launch_bounds__): two in
// float32, at most 128 registers a thread, which ptxas meets without spills;
// at three (80 registers) it spills, and the launch ran slower (PERF.md)
template <typename T>
struct CollideBlocks {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};
template <int V>
struct Int {
  static constexpr int value = V;
};

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
// row j of the MRT transform M (models/combustion.py M_MAT); its rows are
// orthogonal, M⁻¹ = Mᵀ diag(1 / |M_j|²)
__host__ __device__ __forceinline__ constexpr int mrow(int j, int k) {
  return j == 0   ? 1
         : j == 1 ? (k == 0 ? -4 : (k <= 4 ? -1 : 2))
         : j == 2 ? (k == 0 ? 4 : (k <= 4 ? -2 : 1))
         : j == 3 ? cx(k)
         : j == 4 ? (k <= 4 ? -2 * cx(k) : cx(k))
         : j == 5 ? cy(k)
         : j == 6 ? (k <= 4 ? -2 * cy(k) : cy(k))
         : j == 7 ? (k == 0 || k > 4 ? 0 : (k % 2 ? 1 : -1))
                  : (k <= 4 ? 0 : cx(k) * cy(k));
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// the global row of local row y (0 <= y < ny <= ny_glob, 0 <= row0 < ny_glob)
__device__ __forceinline__ int global_row(int y, int row0, int ny_glob) {
  const int g = row0 + y;
  return g >= ny_glob ? g - ny_glob : g;
}

// the local row that holds global row g, or −1 when the slab has none
__device__ __forceinline__ int local_row(int g, int row0, int ny, int ny_glob) {
  const int y = g - row0 < 0 ? g - row0 + ny_glob : g - row0;
  return y < ny ? y : -1;
}

// out −= A v (SUB) or out += A v, A = a I + Σ_j c_j M_jᵀ M_j the collision Q
// of c: M⁻¹ diag(S) M with a the most common rate of S and
// c_j = (S_j − a) / |M_j|² (ops/combustion_fused.low_rank_factors), so only
// the rates other than a cost work; c_j is the same in every thread, so the
// skip is a uniform branch
template <int Q, bool SUB, typename T>
__device__ __forceinline__ void apply_lowrank(const CombustionConst& c,
                                              const T* v, T* out) {
  const T a = T(c.lr_a[Q]);
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = SUB ? out[k] - a * v[k] : out[k] + a * v[k];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const T cj = T(c.lr_c[9 * Q + j]);
    if (cj == T(0)) continue;
    T m = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (mrow(j, k) != 0) m += T(mrow(j, k)) * v[k];
    m *= cj;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (mrow(j, k) != 0)
        out[k] = SUB ? out[k] - T(mrow(j, k)) * m : out[k] + T(mrow(j, k)) * m;
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

// The flow outlet (models/combustion.py apply_flow_outlet) at local row y of
// global row g, 1 <= g <= G − 2: col holds the populations of (y, nx − 1) and
// gets the fixed ones.  Reads the macros of (y, nx − 2) and (y, nx − 3) in s,
// which no boundary fix changes.
template <typename T>
__device__ __forceinline__ void flow_outlet(const T* __restrict__ s, int y,
                                            int g, int G, int n, int nx,
                                            const CombustionConst& c, T* col) {
  T r1 = T(0), mx1 = T(0), my1 = T(0), r2 = T(0), mx2 = T(0), my2 = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const T a = s[k * n + y * nx + nx - 2], b = s[k * n + y * nx + nx - 3];
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
  if (g > 1 && g < G - 2) {
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
    col[3] = f3;
    col[6] = feq[6] - T(wk(6)) * (e1 - e2);
    col[7] = feq[7] - T(wk(7)) * (e1 + e2);
  } else {  // the corners, g = 1 (bottom) and g = G − 2 (top)
    const bool bottom = g == 1;
    const T f8 = bottom ? (rho + rho * ux - T(2.0 / 3.0) * rho * uy -
                           col[0] - T(2) * (col[1] + col[4] + col[8])) / T(2)
                        : (rho + rho * ux + T(2.0 / 3.0) * rho * uy -
                           col[0] - T(2) * (col[1] + col[2] + col[5])) / T(2);
    col[8] = f8;
    col[6] = f8 - rho * ux / T(6) + rho * uy / T(6);
    col[3] = col[1] - T(2.0 / 3.0) * rho * ux;
    col[7] = col[5] - rho * ux / T(6) + rho * uy / T(6);
    if (bottom)
      col[2] = col[4] + T(2.0 / 3.0) * rho * uy;
    else
      col[4] = col[2] - T(2.0 / 3.0) * rho * uy;
  }
}

// ---------------------------------------------------------------------------
// Launch 1: the boundary phase of one scalar population of the channel
// (models/combustion.py make_step, phase 1, apply_scalar_bcs), as a function
// of the entry state s.  The model runs it in this order:
//   A. from the ENTRY sums m: amp_top(x) = (4 m(yt−1, x) − m(yt−2, x))/3,
//      overridden at x = 1 by the sums of column 1 after its inlet fix and
//      at x = nx − 1 by those of column nx − 1 after its outlet fix, and
//      amp_out(y) = (4 m(y, nx−2) − m(y, nx−3))/3, entry-time on purpose;
//   B. the top row yt (k 7, 4, 8 ← 5, 2, 6) with amp_top;
//   C. amp_bot(x) from the sums of rows yb+1 and yb+2 AFTER B (row yb+2 is
//      yt on a lattice of 5 rows), then the bottom row yb (k 6, 2, 5 ←
//      8, 4, 7);
//   D. the inlet column 1 (k 5, 1, 8 ← 7, 3, 6) with the inlet value,
//      reading the row-fixed values of B and C;
//   E. the outlet column nx − 1 (k 6, 3, 7 ← 8, 1, 5) with amp_out, every
//      row for g_T, not rows yb and yt for the species;
//   F. the species outlet corners (rows yb, yt): the row-fixed column
//      nx − 1, the row-fixed sums of columns nx − 2, nx − 3 (D and E leave
//      those columns alone), with u from the outlet-fixed flow.
// Each cell's fixes read, besides its own entry values, only values that
// another fix of its own chain produces from the entry state, so one
// thread per cell recomputes that chain in registers (a corner of a
// 5-row lattice walks F → C → B → A, the longest).  Rows are global (see
// the slab mode above): yt or yb is −1 where the slab lacks that row, and
// the rows read next to them wrap inside the slab.
template <typename T>
struct ScalarBoundary {
  const T* __restrict__ s;  // the entry state (8, 9, ny, nx)
  const CombustionConst& c;
  int ny, nx, n, plane, yt, yb;
  T amp_in;

  __device__ T at(int k, int y, int x) const {
    return s[(plane * 9 + k) * n + y * nx + x];
  }
  __device__ void load(int y, int x, T* v) const {
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = at(k, y, x);
  }
  __device__ static T sum9(const T* v) {
    T m = v[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) m += v[k];
    return m;
  }
  __device__ T sum_at(int y, int x) const {
    T m = at(0, y, x);
#pragma unroll
    for (int k = 1; k < 9; ++k) m += at(k, y, x);
    return m;
  }
  __device__ T amp_out(int y) const {
    return (T(4) * sum_at(y, nx - 2) - sum_at(y, nx - 3)) / T(3);
  }
  // A: the sums of rows yt − 1 and yt − 2 at column x, after the column's
  // own inlet or outlet fix at x = 1 and x = nx − 1
  __device__ T amp_top(int x) const {
    T top[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int y = wrap(yt - 1 - r, ny);
      T m = sum_at(y, x);
      if (x == 1) {
        const T a = amp_in;
        T d = (-at(7, y, x) + T(c.w2[7]) * a) - at(5, y, x);
        d += (-at(3, y, x) + T(c.w2[3]) * a) - at(1, y, x);
        d += (-at(6, y, x) + T(c.w2[6]) * a) - at(8, y, x);
        m = m + d;
      } else if (x == nx - 1) {
        const T a = amp_out(y);
        T d = (-at(8, y, x) + T(c.w2[8]) * a) - at(6, y, x);
        d += (-at(1, y, x) + T(c.w2[1]) * a) - at(3, y, x);
        d += (-at(5, y, x) + T(c.w2[5]) * a) - at(7, y, x);
        m = m + d;
      }
      top[r] = m;
    }
    return (T(4) * top[0] - top[1]) / T(3);
  }
  // B on the values v of (yt, x)
  __device__ void top_fix(int x, T* v) const {
    const T a = amp_top(x);
    v[7] = -v[5] + T(c.w2[7]) * a;
    v[4] = -v[2] + T(c.w2[2]) * a;
    v[8] = -v[6] + T(c.w2[6]) * a;
  }
  // C: amp_bot from the sums of rows yb + 1 and yb + 2 after B
  __device__ T amp_bot(int x) const {
    T m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int y = wrap(yb + 1 + r, ny);
      if (y == yt) {
        T v[9];
        load(y, x, v);
        top_fix(x, v);
        m[r] = sum9(v);
      } else {
        m[r] = sum_at(y, x);
      }
    }
    return (T(4) * m[0] - m[1]) / T(3);
  }
  // C on the values v of (yb, x)
  __device__ void bottom_fix(int x, T* v) const {
    const T a = amp_bot(x);
    v[6] = -v[8] + T(c.w2[8]) * a;
    v[2] = -v[4] + T(c.w2[4]) * a;
    v[5] = -v[7] + T(c.w2[7]) * a;
  }
  // the values of (y, x) after B and C
  __device__ void row_fixed(int y, int x, T* v) const {
    load(y, x, v);
    if (y == yt)
      top_fix(x, v);
    else if (y == yb)
      bottom_fix(x, v);
  }
  // D
  __device__ void inlet_fix(T* v) const {
    const T a = amp_in;
    v[5] = -v[7] + T(c.w2[7]) * a;
    v[1] = -v[3] + T(c.w2[3]) * a;
    v[8] = -v[6] + T(c.w2[6]) * a;
  }
  // E at row y
  __device__ void outlet_fix(int y, T* v) const {
    const T a = amp_out(y);
    v[6] = -v[8] + T(c.w2[8]) * a;
    v[3] = -v[1] + T(c.w2[1]) * a;
    v[7] = -v[5] + T(c.w2[5]) * a;
  }
  // F at (y, nx − 1), y = yb or yt, on its row-fixed values v; fc holds the
  // outlet-fixed flow populations of the cell
  __device__ void species_corner(int y, const T* fc, T* v) const {
    const T Yc = sum9(v);
    T w[9];
    row_fixed(y, nx - 2, w);
    const T m2 = sum9(w);
    row_fixed(y, nx - 3, w);
    const T Ylok = (T(4) * m2 - sum9(w)) / T(3);
    T rl = fc[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) rl += fc[k];
    const T uxl = (fc[1] - fc[3] + fc[5] - fc[6] - fc[7] + fc[8]) / rl;
    const T uyl = (fc[2] - fc[4] + fc[5] + fc[6] - fc[7] - fc[8]) / rl;
    const T usqr = T(1.5) * (uxl * uxl + uyl * uyl);
    T geq[9];
    equilibrium(Yc, uxl, uyl, usqr, geq);
    if (y == yb) {  // eps over k 0, 1, 4, 8; rewritten 2, 3, 5, 6, 7
      const T e1 = ((v[0] + v[1]) + v[4]) + v[8];
      const T e2 = (((geq[2] + geq[3]) + geq[5]) + geq[6]) + geq[7];
      const T GC = (Ylok - (e1 + e2)) / T(c.wsum_bot);
      v[2] = geq[2] + T(wk(2)) * GC;
      v[3] = geq[3] + T(wk(3)) * GC;
      v[5] = geq[5] + T(wk(5)) * GC;
      v[6] = geq[6] + T(wk(6)) * GC;
      v[7] = geq[7] + T(wk(7)) * GC;
    } else {  // eps over k 0, 1, 2, 5; rewritten 3, 4, 6, 7, 8
      const T e1 = ((v[0] + v[1]) + v[2]) + v[5];
      const T e2 = (((geq[3] + geq[4]) + geq[6]) + geq[7]) + geq[8];
      const T GC = (Ylok - (e1 + e2)) / T(c.wsum_top);
      v[3] = geq[3] + T(wk(3)) * GC;
      v[4] = geq[4] + T(wk(4)) * GC;
      v[6] = geq[6] + T(wk(6)) * GC;
      v[7] = geq[7] + T(wk(7)) * GC;
      v[8] = geq[8] + T(wk(8)) * GC;
    }
  }
};

// The side buffer (3, 9, 2 nx + 2 ny): slot x for (yt, x), nx + x for
// (yb, x), 2 nx + y for (y, 1) and 2 nx + ny + y for (y, nx − 1); a cell of
// rows yt or yb takes its row's slot, and its column slot stays unwritten.
__device__ __forceinline__ int side_slot(int y, int x, int yt, int yb, int ny,
                                         int nx) {
  if (y == yt) return x;
  if (y == yb) return nx + x;
  if (x == 1) return 2 * nx + y;
  if (x == nx - 1) return 2 * nx + ny + y;
  return -1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    boundary_kernel(const T* __restrict__ s, T* __restrict__ side, int ny,
                    int nx, int row0, int ny_glob, CombustionConst c) {
  const int nb = 2 * (nx + ny);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 3 * nb) return;
  const int p = t / nb, slot = t - p * nb;  // p: g_O2, g_CO2, g_T
  const int G = ny_glob;
  const int yt = local_row(G - 2, row0, ny, G);  // top wall row, or −1
  const int yb = local_row(1, row0, ny, G);      // bottom wall row, or −1
  int y, x;
  if (slot < nx) {
    y = yt;
    x = slot;
  } else if (slot < 2 * nx) {
    y = yb;
    x = slot - nx;
  } else {
    y = slot < 2 * nx + ny ? slot - 2 * nx : slot - 2 * nx - ny;
    x = slot < 2 * nx + ny ? 1 : nx - 1;
    if (y == yt || y == yb) return;  // the row's thread owns the cell
  }
  if (y < 0) return;  // the slab lacks that wall row
  const ScalarBoundary<T> bc{
      s, c, ny, nx, ny * nx, P_O2 + p, yt, yb,
      T(p == 0 ? c.amp_in[0] : (p == 1 ? c.amp_in[1] : c.amp_in[2]))};
  T v[9];
  bc.row_fixed(y, x, v);
  if (x == 1) {
    bc.inlet_fix(v);
  } else if (x == nx - 1) {
    if (p == 2 || (y != yt && y != yb)) {
      bc.outlet_fix(y, v);
    } else {
      T fc[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) fc[k] = s[k * bc.n + y * nx + nx - 1];
      flow_outlet(s, y, global_row(y, row0, G), G, bc.n, nx, c, fc);
      bc.species_corner(y, fc, v);
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) side[(p * 9 + k) * nb + slot] = v[k];
}

// ---------------------------------------------------------------------------
// Launch 2 (konv): the cell's boundary values (side buffer, flow outlet),
// the LI2014 conjugate fix of the cell's own incoming g_T (unless
// first_step) and the fields ρ, u, Y_O2, Y_CO2.  For each direction d with
// neighbour nb = r − c_d (apply_conjugate_bc in pull form):
//   obstacle r, bulk nb: g_T(r, d) = −a g_coll(r, opp d) + b2 g_coll(nb, d)
//   bulk r, obstacle nb: g_T(r, d) =  a g_coll(r, opp d) + c2 g_coll(nb, d)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fields_kernel(T* __restrict__ s, const int8_t* __restrict__ flags,
                  const T* __restrict__ side, T* __restrict__ fld, int ny,
                  int nx, int row0, int ny_glob, int conjugate,
                  CombustionConst c) {
  const int n = ny * nx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = i / nx, x = i - y * nx;
  T f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = s[k * n + i];
  if (c.io) {
    const int G = ny_glob;
    const int slot = side_slot(y, x, local_row(G - 2, row0, ny, G),
                               local_row(1, row0, ny, G), ny, nx);
    if (slot >= 0) {
      const int nb = 2 * (nx + ny);
#pragma unroll
      for (int k = 0; k < 27; ++k) s[(P_O2 * 9 + k) * n + i] = side[k * nb + slot];
    }
    const int g = global_row(y, row0, G);
    if (x == nx - 1 && g >= 1 && g <= G - 2) {
      flow_outlet(s, y, g, G, n, nx, c, f);
#pragma unroll
      for (int k = 0; k < 9; ++k) s[k * n + i] = f[k];
    }
  }
  const int fl = flags[i];
  if (conjugate && (fl == BULK || fl == OBSTACLE)) {
    const T* gc = s + P_GCOLL * 9 * n;
    T* gT = s + P_T * 9 * n;
    for (int d = 1; d < 9; ++d) {
      const int nb = wrap(y - cy(d), ny) * nx + wrap(x - cx(d), nx);
      const int fn = flags[nb];
      if (fl == OBSTACLE && fn == BULK)
        gT[d * n + i] = T(c.conj_neg_a) * gc[opp(d) * n + i] +
                        T(c.conj_b2) * gc[d * n + nb];
      else if (fl == BULK && fn == OBSTACLE)
        gT[d * n + i] = T(c.conj_a) * gc[opp(d) * n + i] +
                        T(c.conj_c2) * gc[d * n + nb];
    }
  }
  T rho, ux, uy;
  flow_macro(f, c, rho, ux, uy);
  T y1 = s[(P_O2 * 9) * n + i], y2 = s[(P_CO2 * 9) * n + i];
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    y1 += s[(P_O2 * 9 + k) * n + i];
    y2 += s[(P_CO2 * 9 + k) * n + i];
  }
  fld[F_RHO * n + i] = rho;
  fld[F_UX * n + i] = ux;
  fld[F_UY * n + i] = uy;
  fld[F_YO2 * n + i] = y1;
  fld[F_YCO2 * n + i] = y2;
}

// _central_gradient at one cell: central differences, one-sided second
// order where the neighbour beyond is not bulk (the later rule wins, as the
// model's selections do); rm, r0, rp are the offsets of rows y − 1, y, y + 1
template <typename T>
__device__ __forceinline__ void gradient(const T* __restrict__ q, int y,
                                         int x, int rm, int r0, int rp,
                                         int xm, int xp, int ny, int nx,
                                         bool s_n, bool s_s, bool s_e,
                                         bool s_w, T& gx, T& gy) {
  const T c0 = q[r0 + x];
  const T E = q[r0 + xp], Wv = q[r0 + xm];
  const T N = q[rp + x], S = q[rm + x];
  gx = (E - Wv) / T(2);
  gy = (N - S) / T(2);
  if (s_s) gy = (T(-3) * c0 + T(4) * N - q[wrap(y + 2, ny) * nx + x]) / T(2);
  if (s_n) gy = (T(3) * c0 - T(4) * S + q[wrap(y - 2, ny) * nx + x]) / T(2);
  if (s_w) gx = (T(-3) * c0 + T(4) * E - q[r0 + wrap(x + 2, nx)]) / T(2);
  if (s_e) gx = (T(3) * c0 - T(4) * Wv + q[r0 + wrap(x - 2, nx)]) / T(2);
}

// ---------------------------------------------------------------------------
// Launch 3: collide and stream.  src holds the boundary-fixed populations
// (launches 1 and 2 wrote them in place; flow only, the outlet is fixed here
// in registers), dst the next state.  Only this thread's own cell of src is
// read, besides columns nx − 2 and nx − 3 for the flow outlet.
template <typename T>
__global__ void __launch_bounds__(THREADS, CollideBlocks<T>::value)
    collide_stream_kernel(const T* __restrict__ src, T* __restrict__ dst,
                          const int8_t* __restrict__ flags,
                          const int8_t* __restrict__ ckn,
                          const T* __restrict__ fs_col,
                          const T* __restrict__ fs_row,
                          const T* __restrict__ fld, int ny, int nx,
                          int row0, int ny_glob, CombustionConst c) {
  const int n = ny * nx;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = i / nx, x = i - y * nx;
  const int fl = flags[i];
  const bool bulk = fl == BULK, obst = fl == OBSTACLE;
  const bool out_col = c.io && x == nx - 1;
  // offsets of rows y − 1, y, y + 1 and columns x − 1, x + 1, wrapped
  const int rm = wrap(y - 1, ny) * nx, r0 = y * nx, rp = wrap(y + 1, ny) * nx;
  const int xm = wrap(x - 1, nx), xp = wrap(x + 1, nx);
  // the cell at r + (dx, dy), |dx|, |dy| <= 1
  auto cell = [&](int dx, int dy) {
    return (dy < 0 ? rm : (dy > 0 ? rp : r0)) + (dx < 0 ? xm : (dx > 0 ? xp : x));
  };
  // the flags of the neighbour r + c_k (down) and the upstream r − c_k (up)
  // of every direction, 2 bits each
  unsigned downw = 0, upw = 0;
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    downw |= unsigned(flags[cell(cx(k), cy(k))]) << (2 * k);
    upw |= unsigned(flags[cell(-cx(k), -cy(k))]) << (2 * k);
  }
  auto fp = [&](int k) { return int(downw >> (2 * k)) & 3; };
  auto fm = [&](int k) { return int(upw >> (2 * k)) & 3; };
  // the push into r + c_k goes to a bulk cell that the outlet pin leaves
  // alone
  auto pushes = [&](int k) {
    return fp(k) == BULK &&
           !(c.io && west(k) && (cx(k) > 0 ? xp : (cx(k) < 0 ? xm : x)) == nx - 1);
  };
  auto S = [&](int plane, int k) -> T {
    return src[(plane * 9 + k) * n + i];
  };
  auto D = [&](int plane, int k, int at) -> T& {
    return dst[(plane * 9 + k) * n + at];
  };

  // ---- flow: collide, body force, stream ----
  T rho, ux, uy;
  {
    T p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = S(P_F, k);
    if (!c.konv && out_col) {
      const int g = global_row(y, row0, ny_glob);
      if (g >= 1 && g <= ny_glob - 2)
        flow_outlet(src, y, g, ny_glob, n, nx, c, p);
    }
    if (c.konv) {
      rho = fld[F_RHO * n + i];
      ux = fld[F_UX * n + i];
      uy = fld[F_UY * n + i];
    } else {
      flow_macro(p, c, rho, ux, uy);
    }
    if (!bulk) {
#pragma unroll
      for (int k = 0; k < 9; ++k) D(P_F, k, i) = T(0);
    } else {
      if (out_col) {  // the outlet pin keeps the fixed incoming values
        D(P_F, 3, i) = p[3];
        D(P_F, 6, i) = p[6];
        D(P_F, 7, i) = p[7];
      }
      const T usqr = T(1.5) * (ux * ux + uy * uy);
      T d[9];
      equilibrium(rho, ux, uy, usqr, d);
#pragma unroll
      for (int k = 0; k < 9; ++k) d[k] = p[k] - d[k];
      apply_lowrank<LR_F, true>(c, d, p);
      if (c.body_force) {
        const T px = T(c.dpdx), py = T(c.dpdy);
        const T uF = ux * px + uy * py;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
          const T cF = T(cx(k)) * px + T(cy(k)) * py;
          d[k] = T(wk(k)) * (T(3) * cF + T(9) * cu * cF - T(3) * uF);
        }
        apply_lowrank<LR_BODY, false>(c, d, p);
      }
      D(P_F, 0, i) = p[0];
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        // receiver: bounce-back off a solid upstream (not at the pin)
        if (!(out_col && west(k)) && fm(k) != BULK) {
          const int ko = opp(k);
          const int yu = wrap(y - cy(k), ny);
          const int xu = cx(k) > 0 ? xm : (cx(k) < 0 ? xp : x);
          const T fs = xu == 0 ? fs_col[ko * ny + yu]
                               : (global_row(yu, row0, ny_glob) == ny_glob - 1
                                      ? fs_row[ko * nx + xu]
                                      : T(0));
          D(P_F, k, i) = p[ko] + fs;
        }
        // sender: push into a bulk neighbour that is not pinned
        if (pushes(k)) D(P_F, k, cell(cx(k), cy(k))) = p[k];
      }
    }
  }
  if (!c.konv) return;
  const T usqr = T(1.5) * (ux * ux + uy * uy);
  const T YO2 = fld[F_YO2 * n + i], YCO2 = fld[F_YCO2 * n + i];

  // ---- species forcing: gradients at reach 2 ----
  T F_O2, F_CO2;
  {
    const bool s_n = fp(2) != BULK, s_s = fp(4) != BULK;
    const bool s_e = fp(1) != BULK, s_w = fp(3) != BULK;
    T grx, gry, gux, guy, gx, gy, dummy;
    gradient(fld + F_RHO * n, y, x, rm, r0, rp, xm, xp, ny, nx, s_n, s_s, s_e,
             s_w, grx, gry);
    gradient(fld + F_UX * n, y, x, rm, r0, rp, xm, xp, ny, nx, s_n, s_s, s_e,
             s_w, gux, dummy);
    gradient(fld + F_UY * n, y, x, rm, r0, rp, xm, xp, ny, nx, s_n, s_s, s_e,
             s_w, dummy, guy);
    if (x == nx - 1) gux = T(0);  // outlet column: zero x-gradients
    const T div_u = gux + guy;
    gradient(fld + F_YO2 * n, y, x, rm, r0, rp, xm, xp, ny, nx, s_n, s_s,
             s_e, s_w, gx, gy);
    if (x == nx - 1) gx = T(0);
    F_O2 = (T(c.D_O2) / rho) * (gx * grx + gy * gry) + YO2 * div_u;
    gradient(fld + F_YCO2 * n, y, x, rm, r0, rp, xm, xp, ny, nx, s_n, s_s,
             s_e, s_w, gx, gy);
    if (x == nx - 1) gx = T(0);
    F_CO2 = (T(c.D_CO2) / rho) * (gx * grx + gy * gry) + YCO2 * div_u;
  }

  // ---- temperature: reaction rate, heat release, gas or solid collision,
  // store, stream (before the species, so that g_T is read once) ----
  T kr;
  // the interface mass fractions of direction k, formed where read
  auto y1i = [&](int k) -> T {
    const T hck = T(c.half_stoich * (double)ckn[k * n + i]);
    return T(c.D_O2) * YO2 / (T(c.D_O2) + hck * kr);
  };
  auto y2i = [&](int k) -> T {
    return YCO2 - (T(0.5 * (double)ckn[k * n + i]) * kr * y1i(k) *
                   T(c.M_CO2)) / T(c.DM);
  };
  {
    T p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = S(P_T, k);
    T T_ = p[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) T_ += p[k];
    const T Tm = T_ < T(1e-2) ? T(1e-2) : T_;  // NaN propagates
    kr = T(c.A_pre) * exp(T(c.neg_E) / (T(c.R_id) * Tm));
    T F_T = T(0);
    if (c.li2014) {
      T ysum = T(0);
#pragma unroll
      for (int k = 1; k <= 4; ++k)
        if (fp(k) == OBSTACLE) ysum += y1i(k);
      const T F_r = kr * ysum * rho / T(c.M_O2);
      F_T = F_r * T(c.delta_hr) / (rho * T(c.cp_gas));
    }
    // receiver: keep the fixed incoming value across an interface, from an
    // inlet-channel wall, and at the outlet pin
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const bool iface_in = (fm(k) == OBSTACLE && bulk) || (fm(k) == BULK && obst);
      if ((c.li2014 && iface_in) || (c.io && fm(k) == WALL) ||
          (out_col && bulk && west(k)))
        D(P_T, k, i) = p[k];
    }
    T d[9];
    if (bulk) {
      equilibrium(T_, ux, uy, usqr, d);
#pragma unroll
      for (int k = 0; k < 9; ++k) d[k] = p[k] - d[k];
      apply_lowrank<LR_T, true>(c, d, p);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
        const T Fk = T(wk(k)) * F_T * (T(1) + T(3) * cu * T(c.fac_T));
        p[k] = p[k] + Fk + T(0.5) * (Fk - S(P_FT, k));
        D(P_FT, k, i) = Fk;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
        D(P_FT, k, i) = T(wk(k)) * F_T * (T(1) + T(3) * cu * T(c.fac_T));
        d[k] = p[k] - T_ * T(wk(k));
      }
      apply_lowrank<LR_TS, true>(c, d, p);
    }
    D(P_T, 0, i) = p[0];
    D(P_GCOLL, 0, i) = T(0);
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      // sender: the same rule seen from the neighbour r + c_k
      const bool iface_out = (bulk && fp(k) == OBSTACLE) || (obst && fp(k) == BULK);
      const bool keep_out = (c.li2014 && iface_out) || (c.io && fl == WALL) ||
                            (fp(k) == BULK && !pushes(k));
      if (!keep_out) D(P_T, k, cell(cx(k), cy(k))) = p[k];
      D(P_GCOLL, k, i) = iface_out ? p[k] : T(0);
    }
  }

  // ---- species: collide, force, stream ----
  auto species = [&](auto sp) {
    constexpr int SP = decltype(sp)::value;
    constexpr int plane = SP == 0 ? P_O2 : P_CO2;
    const T Fs = SP == 0 ? F_O2 : F_CO2;
    const T fac = T(SP == 0 ? c.fac_O2 : c.fac_CO2);
    T p[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) p[k] = S(plane, k);
    if (!bulk) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
        D(plane + 3, k, i) = T(wk(k)) * Fs * (T(1) + T(3) * cu * fac);
        D(plane, k, i) = T(0);
      }
      return;
    }
    if (out_col) {  // the outlet pin
      D(plane, 3, i) = p[3];
      D(plane, 6, i) = p[6];
      D(plane, 7, i) = p[7];
    }
    T d[9];
    equilibrium(SP == 0 ? YO2 : YCO2, ux, uy, usqr, d);
#pragma unroll
    for (int k = 0; k < 9; ++k) d[k] = p[k] - d[k];
    apply_lowrank<LR_O2 + SP, true>(c, d, p);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T cu = T(cx(k)) * ux + T(cy(k)) * uy;
      const T Fk = T(wk(k)) * Fs * (T(1) + T(3) * cu * fac);
      p[k] = p[k] + Fk + T(0.5) * (Fk - S(plane + 3, k));
      D(plane + 3, k, i) = Fk;
    }
    D(plane, 0, i) = p[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const int ko = opp(k);
      if (!(out_col && west(k))) {
        if (fm(k) == WALL || (fm(k) == OBSTACLE && !c.solid_reaction))
          D(plane, k, i) = p[ko];
        else if (fm(k) == OBSTACLE)
          D(plane, k, i) = -p[ko] + T(c.w2[ko]) * (SP == 0 ? y1i(ko) : y2i(ko));
      }
      if (pushes(k)) D(plane, k, cell(cx(k), cy(k))) = p[k];
    }
  };
  species(Int<0>());
  species(Int<1>());
}

template <typename T>
int run_steps(T* a, T* b, const int8_t* flags, const int8_t* ckn,
              const T* fs_col, const T* fs_row, T* fld, T* side, int ny,
              int nx, int row0, int ny_glob, int n_steps, int first_mode,
              const CombustionConst* c, cudaStream_t stream) {
  const int n = ny * nx;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  // one thread for each boundary cell and each scalar population
  const unsigned bc_blocks = (unsigned)((3 * 2 * (nx + ny) + THREADS - 1) / THREADS);
  for (int s = 0; s < n_steps; ++s) {
    T* src = (s & 1) ? b : a;
    T* dst = (s & 1) ? a : b;
    // first_mode: 0 none, 1 the first step of the call, 2 every step
    const bool first = first_mode == 2 || (first_mode == 1 && s == 0);
    if (c->io && c->konv) {
      boundary_kernel<T><<<bc_blocks, THREADS, 0, stream>>>(
          src, side, ny, nx, row0, ny_glob, *c);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (c->konv) {
      fields_kernel<T><<<blocks, THREADS, 0, stream>>>(
          src, flags, side, fld, ny, nx, row0, ny_glob, c->li2014 && !first,
          *c);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    collide_stream_kernel<T><<<blocks, THREADS, 0, stream>>>(
        src, dst, flags, ckn, fs_col, fs_row, fld, ny, nx, row0, ny_glob, *c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// n_steps steps of the (8, 9, ny, nx) state, rows row0 .. row0 + ny − 1
// (mod ny_glob) of a lattice of ny_glob rows (row0 = 0, ny_glob = ny: the
// whole lattice; the caller keeps 0 <= row0 < ny_glob and ny <= ny_glob): a
// holds the input and is written in place by the boundary fixes; the result
// is in a when n_steps is even, else in b.  flags (ny, nx) and ck_n
// (9, ny, nx) int8 and fs_col (9, ny), the momentum-exchange populations of
// column 0, of the slab's rows; fs_row (9, nx) those of global row
// ny_glob − 1; fld (5, ny, nx) and side (3, 9, 2 nx + 2 ny) are work space.
// Returns the cudaError_t of the launches (0 on success).
int combustion_run_f32(void* a, void* b, const void* flags, const void* ckn,
                       const void* fs_col, const void* fs_row, void* fld,
                       void* side, int ny, int nx, int row0, int ny_glob,
                       int n_steps, int first_mode, const void* consts,
                       void* stream) {
  return run_steps<float>((float*)a, (float*)b, (const int8_t*)flags,
                          (const int8_t*)ckn, (const float*)fs_col,
                          (const float*)fs_row, (float*)fld, (float*)side, ny,
                          nx, row0, ny_glob, n_steps, first_mode,
                          (const CombustionConst*)consts, (cudaStream_t)stream);
}

int combustion_run_f64(void* a, void* b, const void* flags, const void* ckn,
                       const void* fs_col, const void* fs_row, void* fld,
                       void* side, int ny, int nx, int row0, int ny_glob,
                       int n_steps, int first_mode, const void* consts,
                       void* stream) {
  return run_steps<double>((double*)a, (double*)b, (const int8_t*)flags,
                           (const int8_t*)ckn, (const double*)fs_col,
                           (const double*)fs_row, (double*)fld, (double*)side,
                           ny, nx, row0, ny_glob, n_steps, first_mode,
                           (const CombustionConst*)consts, (cudaStream_t)stream);
}

}  // extern "C"
