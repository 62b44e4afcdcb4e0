// HCZ phase-field D3Q19 step on a fully periodic box (order parameter f,
// pressure g; Carnahan–Starling EOS; Guo-type forcing; BGK of f and g;
// periodic streaming) for NVIDIA Hopper.
//
// Replaces multiphase_lbm_tpu/ops/pallas_hcz3d.py:_make_kernel (the Pallas
// TPU kernel behind pallas_hcz3d.run_fused_3d and step_fused_halo_3d) and
// computes what its step_block computes (pallas_hcz3d.py:115-233):
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
// Design (the Pallas z-stripes, halo slabs, stacked rolls and temporal
// blocking were VMEM constraints and are not carried over).  A step reaches
// 3 cells in φ (E needs P at r + c, P needs ψφ at r + 2c through u's
// ∇(∇²φ), which needs φ at r + 3c) and 1 cell in g.  A box tile with a
// 3-cell ring would load 8–9 times its cells, so the tile marches in z.
// Two launches a step:
//   A. phi_kernel: φ = Σ_k f_k into an (nz, ny, nx) scratch (76 B read,
//      4 B written a cell).
//   B. tile_kernel: a block of 256 threads owns an xy tile of TILE_X ×
//      TILE_Y cells, x fastest, so that a warp is one row and its loads and
//      pushed stores coalesce, and marches up a chunk of ZC z-planes,
//      keeping rolling windows of planes in shared memory.  At plane t
//      (the plane it collides), in two phases separated by __syncthreads:
//        X. for plane t + 1 over the tile plus a 1-cell ring: the four g
//           moments of each cell (its 19 g, the ring's from L2), ∇ψφ and
//           ∇(∇²φ) from the window, F, u, P and P − ρ/3, each formed once
//           a cell; P − ρ/3 goes to a 3-plane window, and the own cell's
//           P, u, F, ∇ψφ, ρ and φ stay in registers for the next plane.
//        Y. for the own cell of plane t: E from the window of P − ρ/3, its
//           f and g (g again: L1 or L2, where phase X left it), the collide
//           of both populations, then a PUSH of each post_k to
//           (r + c_k, k), which is the Pallas pull rule
//           new_k(r) = post_k(r − c_k) and writes every slot once; and,
//           ahead, ψφ and ∇²φ of plane t + 3 over the tile plus 2 (once a
//           cell, from a 4-plane window of φ over the tile plus 3), and the
//           φ of plane t + 5, loaded at the phase's start and stored at its
//           end.
//      A chunk warms up on the planes below it: φ over ZC + 6 planes, ψφ
//      and ∇²φ over ZC + 4, g over ZC + 2.
// Every lattice index wraps with a true modulo on all three axes, so a box
// or slab thinner than the ring (nz = 2, ny < 8) reads the right cells, and
// a tile or chunk that overhangs the lattice loads wrapped cells: they
// serve as ring of the cells beside them and write nothing.  Each cell's
// values go through one code path wherever it sits in a tile or chunk, so a
// z-slab of the decomposition computes bit for bit what the whole lattice
// computes.  Indices are 32-bit: the wrapper (ops/_grid.launch_geometry_3d)
// and the C entries (box_grid) refuse 19 · nz · ny · nx >= 2^31.
// DRAM traffic: 80 B a cell in A, 308 B in B (f, g and φ in; f and g out):
// about 388 B against the 304 B bound; the ring's g and φ re-reads are L2
// hits.  A memory-only copy of launch B (the same loads, windows and
// pushes, no physics) runs no faster than launch B: its access pattern,
// not its arithmetic, sets its time.  run_steps loops the steps on the caller's stream, ping-ponging two
// buffer pairs, so a call costs one host crossing.
//
// The record (hcz3d_record_kernel, the C entries hcz3d_record_*): the
// laplace3D driver's energy ½ Σ|u|² / (nz·ny·nx) of one state, which the
// plain path takes from models/hcz.macro_3d's whole-box fields.  Two
// launches: the step's phi_kernel, unchanged, then one record tile over the
// step's grid that forms u exactly as phase X of tile_kernel does, with a
// smaller reach (u needs φ two cells away and the own cell's g), and sums
// |u|² in double in a fixed order; the host reads back one double.  Bound:
// 160 B a cell in float32 (the φ pass's 76 B in and 4 B out; the record
// tile's 76 B of g and 4 B of φ, the ring's φ re-reads L2 hits).
#include <cuda_runtime.h>

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

// The block tile and chunk (ops/hcz3d_fused.TILE and ZC mirror them) and
// the three boxes of its windows: A, the tile plus 3 (φ), B, the tile plus
// 2 (ψφ, ∇²φ), C, the tile plus 1 (P − ρ/3).
constexpr int TILE_X = 32, TILE_Y = 8, ZC = 16;
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int AX = TILE_X + 6, AY = TILE_Y + 6, A_N = AX * AY;
constexpr int BX = TILE_X + 4, BY = TILE_Y + 4, B_N = BX * BY;
constexpr int CX = TILE_X + 2, CY = TILE_Y + 2, C_N = CX * CY;
constexpr int A_ROUNDS = (A_N + THREADS - 1) / THREADS;
constexpr int B_ROUNDS = (B_N + THREADS - 1) / THREADS;
constexpr int C_ROUNDS = (C_N + THREADS - 1) / THREADS;

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

// v mod n in [0, n) for any v and n >= 1.
__device__ __forceinline__ int wrap(int v, int n) {
  if ((unsigned)v < (unsigned)n) return v;
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// Position r of the C box as (hy, hx): r < THREADS is the tile's own cell
// of thread r, then the ring: its top and bottom rows, then the two ends
// of the tile's rows.
__device__ __forceinline__ void c_cell(int r, int& hy, int& hx) {
  if (r < THREADS) {
    hy = r / TILE_X + 1;
    hx = r % TILE_X + 1;
    return;
  }
  const int s = r - THREADS;
  if (s < 2 * CX) {
    hy = s < CX ? 0 : CY - 1;
    hx = s < CX ? s : s - CX;
    return;
  }
  const int e = s - 2 * CX;
  hy = 1 + e / 2;
  hx = (e & 1) ? CX - 1 : 0;
}

template <typename T>
__global__ void __launch_bounds__(256)
phi_kernel(const T* __restrict__ f, T* __restrict__ phi, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T s = f[i];
#pragma unroll
  for (int k = 1; k < 19; ++k) s += f[k * n + i];
  phi[i] = s;
}

// What phase X forms at a cell and phase Y's collide reads at the own cell.
template <typename T>
struct CellMacro {
  T P, ux, uy, uz, Fx, Fy, Fz, gppx, gppy, gppz, rho, phi;
};

// Two blocks of 256 threads per SM in float32 (128 registers, no spills),
// one in float64.  Three blocks at 80 registers, one block, ZC = 8 or 32,
// and keeping the own g in registers from phase X all ran slower on an
// H100 (PERF.md §6).
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 4 ? 2 : 1)
tile_kernel(const T* __restrict__ f, const T* __restrict__ g,
            const T* __restrict__ phi, T* __restrict__ fo,
            T* __restrict__ go, int nz, int ny, int nx, HCZConst3 c) {
  __shared__ T s_phi[4][A_N];
  __shared__ T s_pp[3][B_N], s_lap[3][B_N];
  __shared__ T s_pm[3][C_N];

  const int plane = ny * nx, n = nz * plane;
  const int tid = threadIdx.x;
  const int tx = tid % TILE_X, ty = tid / TILE_X;
  const int x0 = blockIdx.x * TILE_X, y0 = blockIdx.y * TILE_Y;
  const int z0 = blockIdx.z * ZC;
  const int z_end = z0 + ZC < nz ? z0 + ZC : nz;
  const bool active = x0 + tx < nx && y0 + ty < ny;
  // slots of plane p in the 4-plane φ window and the 3-plane windows
  // (p >= z0 − 3 throughout)
  auto sa = [z0](int p) { return (p - z0 + 8) & 3; };
  auto sb = [z0](int p) { return (p - z0 + 6) % 3; };

  // in-plane offsets of this thread's cells of the A and C boxes
  int offA[A_ROUNDS], offC[C_ROUNDS], posC[C_ROUNDS];
#pragma unroll
  for (int i = 0; i < A_ROUNDS; ++i) {
    const int r = tid + i * THREADS;
    const int ay = r / AX, ax = r - ay * AX;
    offA[i] = wrap(y0 + ay - 3, ny) * nx + wrap(x0 + ax - 3, nx);
  }
#pragma unroll
  for (int i = 0; i < C_ROUNDS; ++i) {
    int hy, hx;
    c_cell(tid + i * THREADS, hy, hx);
    posC[i] = hy * CX + hx;
    offC[i] = wrap(y0 + hy - 1, ny) * nx + wrap(x0 + hx - 1, nx);
  }
  const int x = wrap(x0 + tx, nx), y = wrap(y0 + ty, ny);
  const int xs[3] = {x == 0 ? nx - 1 : x - 1, x, x == nx - 1 ? 0 : x + 1};
  const int ys[3] = {(y == 0 ? ny - 1 : y - 1) * nx, y * nx,
                     (y == ny - 1 ? 0 : y + 1) * nx};

  // ---- prologue: φ of planes z0 − 3 .. z0 − 1 ----
  for (int p = z0 - 3; p < z0; ++p) {
    const int base = wrap(p, nz) * plane;
#pragma unroll
    for (int i = 0; i < A_ROUNDS; ++i)
      if (tid + i * THREADS < A_N)
        s_phi[sa(p)][tid + i * THREADS] = phi[base + offA[i]];
  }
  __syncthreads();

  CellMacro<T> cur, nxt;
  for (int t = z0 - 5; t < z_end; ++t) {
    // ---- phase X: P − ρ/3 of plane t + 1 over the C box ----
    if (t >= z0 - 2) {
      const int q = t + 1;
      const int gbase = wrap(q, nz) * plane;
      const T* pp_lo = s_pp[sb(q - 1)];
      const T* pp_md = s_pp[sb(q)];
      const T* pp_hi = s_pp[sb(q + 1)];
      const T* lp_lo = s_lap[sb(q - 1)];
      const T* lp_md = s_lap[sb(q)];
      const T* lp_hi = s_lap[sb(q + 1)];
      const T* ph = s_phi[sa(q)];
#pragma unroll 1
      for (int i = 0; i < C_ROUNDS; ++i) {
        if (tid + i * THREADS >= C_N) break;
        const int pos = posC[i];
        const int hy = pos / CX, hx = pos - hy * CX;
        const int b = (hy + 1) * BX + hx + 1;
        const int j = gbase + offC[i];
        T Pterm = T(0), momx = T(0), momy = T(0), momz = T(0);
#pragma unroll
        for (int k = 0; k < 19; ++k) {
          const T v = g[k * n + j];
          Pterm = k ? Pterm + v : v;
          if (cx(k)) momx += T(cx(k)) * v;
          if (cy(k)) momy += T(cy(k)) * v;
          if (cz(k)) momz += T(cz(k)) * v;
        }
        T gx = T(0), gy = T(0), gz = T(0), lx = T(0), ly = T(0), lz = T(0);
#pragma unroll
        for (int k = 0; k < 19; ++k) {
          if (k == 9) continue;
          const int o = b + cy(k) * BX + cx(k);
          const T pp = cz(k) < 0 ? pp_lo[o] : (cz(k) > 0 ? pp_hi[o] : pp_md[o]);
          const T lp = cz(k) < 0 ? lp_lo[o] : (cz(k) > 0 ? lp_hi[o] : lp_md[o]);
          if (cx(k)) { const T w = T(wk(k) * cx(k)); gx += w * pp; lx += w * lp; }
          if (cy(k)) { const T w = T(wk(k) * cy(k)); gy += w * pp; ly += w * lp; }
          if (cz(k)) { const T w = T(wk(k) * cz(k)); gz += w * pp; lz += w * lp; }
        }
        CellMacro<T> m;
        m.gppx = T(3) * gx; m.gppy = T(3) * gy; m.gppz = T(3) * gz;
        m.phi = ph[(hy + 2) * AX + hx + 2];
        m.rho = rho_of_phi(m.phi, c);
        const T kphi = T(c.kappa) * m.phi;
        m.Fx = kphi * (T(3) * lx);
        m.Fy = kphi * (T(3) * ly) + T(c.gravity) * m.rho;
        m.Fz = kphi * (T(3) * lz);
        const T rho3 = m.rho * T(1.0 / 3.0);
        m.ux = (momx + m.Fx * T(1.0 / 6.0)) / rho3;
        m.uy = (momy + m.Fy * T(1.0 / 6.0)) / rho3;
        m.uz = (momz + m.Fz * T(1.0 / 6.0)) / rho3;
        // total_P (laplace3D.h:318-330): P_term − ½ u·∇ψφ
        m.P = Pterm - T(0.5) * (m.ux * m.gppx + m.uy * m.gppy + m.uz * m.gppz);
        s_pm[sb(q)][pos] = m.P - m.rho * T(1.0 / 3.0);
        if (i == 0) nxt = m;
      }
    }
    __syncthreads();

    // ---- phase Y: the own cell of plane t, and the windows ahead ----
    const bool load_ahead = t + 5 < z_end + 3;
    T ahead[A_ROUNDS];
    if (load_ahead) {
      const int base = wrap(t + 5, nz) * plane;
#pragma unroll
      for (int i = 0; i < A_ROUNDS; ++i)
        if (tid + i * THREADS < A_N) ahead[i] = phi[base + offA[i]];
    }
    if (t >= z0 && active) {
      // E field: ∇(P − ρ/3) of the materialised P (laplace3D.h:333-337)
      const int hc = (ty + 1) * CX + tx + 1;
      const T* pm_lo = s_pm[sb(t - 1)];
      const T* pm_md = s_pm[sb(t)];
      const T* pm_hi = s_pm[sb(t + 1)];
      T ex = T(0), ey = T(0), ez = T(0);
#pragma unroll
      for (int k = 0; k < 19; ++k) {
        if (k == 9) continue;
        const int o = hc + cy(k) * CX + cx(k);
        const T v = cz(k) < 0 ? pm_lo[o] : (cz(k) > 0 ? pm_hi[o] : pm_md[o]);
        if (cx(k)) ex += T(wk(k) * cx(k)) * v;
        if (cy(k)) ey += T(wk(k) * cy(k)) * v;
        if (cz(k)) ez += T(wk(k) * cz(k)) * v;
      }
      ex *= T(3); ey *= T(3); ez *= T(3);

      const CellMacro<T>& m = cur;
      const T ux = m.ux, uy = m.uy, uz = m.uz;
      const T usqr = T(1.5) * (ux * ux + uy * uy + uz * uz);
      const T inv_phi = T(1) / m.phi;
      const T inv_rho = T(1) / m.rho;
      const T rho3 = m.rho * T(1.0 / 3.0);
      const T half = T(c.half);
      const T uF = ux * m.Fx + uy * m.Fy + uz * m.Fz;
      const T uE = ux * ex + uy * ey + uz * ez;
      const T uG = ux * m.gppx + uy * m.gppy + uz * m.gppz;
      const T om = T(c.omega), om1 = T(c.one_minus_omega);
      const int i = t * plane + ys[1] + x;
      const int zs[3] = {(t == 0 ? nz - 1 : t - 1) * plane, t * plane,
                         (t == nz - 1 ? 0 : t + 1) * plane};
#pragma unroll
      for (int k = 0; k < 19; ++k) {
        const T w = T(wk(k));
        const T ckx = T(cx(k)), cky = T(cy(k)), ckz = T(cz(k));
        const T cu = ckx * ux + cky * uy + ckz * uz;
        const T eqf = m.phi * w * (T(1) + T(3) * cu + T(4.5) * cu * cu - usqr);
        const T eqg = w * (m.P + rho3 * (T(3) * cu + T(4.5) * cu * cu - usqr));
        const T e_u_F = (ckx * m.Fx + cky * m.Fy + ckz * m.Fz) - uF;
        const T e_u_E = (ckx * ex + cky * ey + ckz * ez) - uE;
        const T e_u_G = (ckx * m.gppx + cky * m.gppy + ckz * m.gppz) - uG;
        const T eqf_over = eqf * inv_phi;
        const T fg = half * (e_u_F * eqf_over + (-e_u_E) * (eqf_over - w));
        // 3D phase forcing divides by ρ (laplace3D.h:608)
        const T ff = half * (-e_u_G) * T(3) * eqf * inv_rho;
        const int dst = k * n + zs[cz(k) + 1] + ys[cy(k) + 1] + xs[cx(k) + 1];
        fo[dst] = om1 * f[k * n + i] + om * eqf + ff;
        go[dst] = om1 * g[k * n + i] + om * eqg + fg;
      }
    }
    // ψφ and ∇²φ of plane t + 3 over the B box, once a cell
    if (t + 3 <= z_end + 1) {
      const int q = t + 3;
      const T* lo = s_phi[sa(q - 1)];
      const T* md = s_phi[sa(q)];
      const T* hi = s_phi[sa(q + 1)];
      for (int r = tid; r < B_N; r += THREADS) {
        const int by = r / BX, bx = r - by * BX;
        const int h = (by + 1) * AX + bx + 1;
        const T pc = md[h];
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < 19; ++k) {
          if (k == 9) continue;
          const int o = h + cy(k) * AX + cx(k);
          const T v = cz(k) < 0 ? lo[o] : (cz(k) > 0 ? hi[o] : md[o]);
          acc += T(wk(k)) * (v - pc);
        }
        s_lap[sb(q)][r] = T(6) * acc;
        s_pp[sb(q)][r] = cs_psi(pc, c);
      }
    }
    if (load_ahead) {
#pragma unroll
      for (int i = 0; i < A_ROUNDS; ++i)
        if (tid + i * THREADS < A_N) s_phi[sa(t + 5)][tid + i * THREADS] = ahead[i];
    }
    cur = nxt;
    __syncthreads();
  }
}

// Sum of e over the block in a fixed order: the shuffle tree within each
// warp, then the warps in turn, on thread 0 (the other threads keep partial
// values).  Every thread of the block must call it.
__device__ __forceinline__ double block_sum(double e, double* s_e, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) e += __shfl_down_sync(0xffffffffu, e, o);
  if (tid % 32 == 0) s_e[tid / 32] = e;
  __syncthreads();
  if (tid == 0)
    for (int w = 1; w < THREADS / 32; ++w) e += s_e[w];
  return e;
}

// The energy record of one state (what models/hcz.kinetic_energy computes
// from it with three_d=True over the fully periodic box), from φ = Σf (the
// step's phi_kernel) and g, over the step's grid: a block owns a TILE_X ×
// TILE_Y tile and marches up its chunk of ZC z-planes.  At plane t, after
// φ of plane t + 2 has joined a 4-plane window over the tile plus 2 (the B
// box) and ∇²φ of plane t + 1 a 3-plane window over the tile plus 1 (the C
// box), each cell of the tile forms
//   u = (Σ c g + F/6)/(ρ/3),  F = κφ∇∇²φ + (0, gravity ρ, 0),
// with phase X's arithmetic, and adds |u|² in double; its 19 g are loaded
// at the plane's start, before the barriers.  Each block leaves its sum in
// part; the last block to finish (a counter the entry zeroes) sums the
// parts, each thread a fixed strided subset, then block_sum's tree, and
// writes out[0] = ½ Σ|u|² / (nz·ny·nx).  No float atomics: the same state
// gives the same bits.
template <typename T>
__global__ void __launch_bounds__(THREADS)
hcz3d_record_kernel(const T* __restrict__ g, const T* __restrict__ phi,
                    int nz, int ny, int nx, HCZConst3 c,
                    double* __restrict__ part, unsigned* __restrict__ done,
                    double* __restrict__ out) {
  __shared__ T s_phi[4][B_N];
  __shared__ T s_lap[3][C_N];
  __shared__ double s_e[THREADS / 32];
  __shared__ bool s_last;

  const int plane = ny * nx, n = nz * plane;
  const int tid = threadIdx.x;
  const int tx = tid % TILE_X, ty = tid / TILE_X;
  const int x0 = blockIdx.x * TILE_X, y0 = blockIdx.y * TILE_Y;
  const int z0 = blockIdx.z * ZC;
  const int z_end = z0 + ZC < nz ? z0 + ZC : nz;
  const bool active = x0 + tx < nx && y0 + ty < ny;
  // slots of plane p in the 4-plane φ window (p >= z0 − 2) and the 3-plane
  // ∇²φ window (p >= z0 − 1)
  auto sa = [z0](int p) { return (p - z0 + 8) & 3; };
  auto sb = [z0](int p) { return (p - z0 + 6) % 3; };

  // in-plane offsets of this thread's cells of the B box
  int offB[B_ROUNDS];
#pragma unroll
  for (int i = 0; i < B_ROUNDS; ++i) {
    const int r = tid + i * THREADS;
    const int by = r / BX, bx = r - by * BX;
    offB[i] = wrap(y0 + by - 2, ny) * nx + wrap(x0 + bx - 2, nx);
  }
  const int own = wrap(y0 + ty, ny) * nx + wrap(x0 + tx, nx);
  const int hb = (ty + 2) * BX + tx + 2;   // the own cell in the B box
  const int hc = (ty + 1) * CX + tx + 1;   // and in the C box

  // ---- prologue: φ of planes z0 − 2 and z0 − 1 ----
  for (int p = z0 - 2; p < z0; ++p) {
    const int base = wrap(p, nz) * plane;
#pragma unroll
    for (int i = 0; i < B_ROUNDS; ++i)
      if (tid + i * THREADS < B_N)
        s_phi[sa(p)][tid + i * THREADS] = phi[base + offB[i]];
  }

  double e = 0.0;
  for (int t = z0 - 2; t < z_end; ++t) {
    const bool own_plane = t >= z0 && active;
    T gk[19];
    if (own_plane) {
#pragma unroll
      for (int k = 0; k < 19; ++k) gk[k] = g[k * n + t * plane + own];
    }
    {
      const int base = wrap(t + 2, nz) * plane;
#pragma unroll
      for (int i = 0; i < B_ROUNDS; ++i)
        if (tid + i * THREADS < B_N)
          s_phi[sa(t + 2)][tid + i * THREADS] = phi[base + offB[i]];
    }
    __syncthreads();

    // ∇²φ of plane t + 1 over the C box, once a cell
    {
      const T* lo = s_phi[sa(t)];
      const T* md = s_phi[sa(t + 1)];
      const T* hi = s_phi[sa(t + 2)];
      for (int r = tid; r < C_N; r += THREADS) {
        const int ry = r / CX, rx = r - ry * CX;
        const int h = (ry + 1) * BX + rx + 1;
        const T pc = md[h];
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < 19; ++k) {
          if (k == 9) continue;
          const int o = h + cy(k) * BX + cx(k);
          const T v = cz(k) < 0 ? lo[o] : (cz(k) > 0 ? hi[o] : md[o]);
          acc += T(wk(k)) * (v - pc);
        }
        s_lap[sb(t + 1)][r] = T(6) * acc;
      }
    }
    __syncthreads();

    // ---- the own cell of plane t ----
    if (own_plane) {
      const T* lp_lo = s_lap[sb(t - 1)];
      const T* lp_md = s_lap[sb(t)];
      const T* lp_hi = s_lap[sb(t + 1)];
      T momx = T(0), momy = T(0), momz = T(0);
#pragma unroll
      for (int k = 0; k < 19; ++k) {
        if (cx(k)) momx += T(cx(k)) * gk[k];
        if (cy(k)) momy += T(cy(k)) * gk[k];
        if (cz(k)) momz += T(cz(k)) * gk[k];
      }
      T lx = T(0), ly = T(0), lz = T(0);
#pragma unroll
      for (int k = 0; k < 19; ++k) {
        if (k == 9) continue;
        const int o = hc + cy(k) * CX + cx(k);
        const T lp = cz(k) < 0 ? lp_lo[o] : (cz(k) > 0 ? lp_hi[o] : lp_md[o]);
        if (cx(k)) lx += T(wk(k) * cx(k)) * lp;
        if (cy(k)) ly += T(wk(k) * cy(k)) * lp;
        if (cz(k)) lz += T(wk(k) * cz(k)) * lp;
      }
      const T ph = s_phi[sa(t)][hb];
      const T rho = rho_of_phi(ph, c);
      const T kphi = T(c.kappa) * ph;
      const T Fx = kphi * (T(3) * lx);
      const T Fy = kphi * (T(3) * ly) + T(c.gravity) * rho;
      const T Fz = kphi * (T(3) * lz);
      const T rho3 = rho * T(1.0 / 3.0);
      const double ux = (momx + Fx * T(1.0 / 6.0)) / rho3;
      const double uy = (momy + Fy * T(1.0 / 6.0)) / rho3;
      const double uz = (momz + Fz * T(1.0 / 6.0)) / rho3;
      e += ux * ux + uy * uy + uz * uz;
    }
  }

  // ---- the block's part, then the last block's fixed-order total ----
  e = block_sum(e, s_e, tid);
  const int nb = gridDim.x * gridDim.y * gridDim.z;
  if (tid == 0) {
    part[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = e;
    __threadfence();
    s_last = atomicAdd(done, 1u) == (unsigned)nb - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  e = 0.0;
  for (int b = tid; b < nb; b += THREADS) e += __ldcg(&part[b]);
  e = block_sum(e, s_e, tid);
  if (tid == 0) out[0] = 0.5 * e / ((double)nz * ny * nx);
}

// The launch grid of a box (one block a tile and chunk), or false for a box
// the kernels cannot index: 19 · nz · ny · nx >= 2^31 slots, or more than
// 65,535 tile rows or chunks.
bool box_grid(int nz, int ny, int nx, dim3* grid) {
  const long long tiles_y = (ny + TILE_Y - 1) / TILE_Y;
  const long long chunks = (nz + ZC - 1) / ZC;
  if (nz < 1 || ny < 1 || nx < 1 ||
      19LL * nz * ny * nx >= (1LL << 31) || tiles_y > 65535 ||
      chunks > 65535)
    return false;
  *grid = dim3((unsigned)((nx + TILE_X - 1) / TILE_X), (unsigned)tiles_y,
               (unsigned)chunks);
  return true;
}

template <typename T>
int run_steps(const T* f, const T* g, T* fa, T* ga, T* fb, T* gb, T* phi,
              int nz, int ny, int nx, int n_steps, const HCZConst3* c,
              cudaStream_t stream) {
  dim3 grid;
  if (!box_grid(nz, ny, nx, &grid)) return (int)cudaErrorInvalidValue;
  const int n = nz * ny * nx;
  const unsigned phi_blocks = (unsigned)((n + 255) / 256);
  for (int s = 0; s < n_steps; ++s) {
    const T* src_f = s == 0 ? f : ((s & 1) ? fa : fb);
    const T* src_g = s == 0 ? g : ((s & 1) ? ga : gb);
    T* dst_f = (s & 1) ? fb : fa;
    T* dst_g = (s & 1) ? gb : ga;
    phi_kernel<T><<<phi_blocks, 256, 0, stream>>>(src_f, phi, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_kernel<T><<<grid, THREADS, 0, stream>>>(src_f, src_g, phi, dst_f,
                                                 dst_g, nz, ny, nx, *c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The record's launches: the φ pass, then the record tile.  The workspace
// ws, blocks + 1 doubles, holds part (a double a block) and the counter,
// which is zeroed first.
template <typename T>
int run_record(const T* f, const T* g, T* phi, double* ws, double* out,
               int nz, int ny, int nx, const HCZConst3* c,
               cudaStream_t stream) {
  dim3 grid;
  if (!box_grid(nz, ny, nx, &grid)) return (int)cudaErrorInvalidValue;
  const int n = nz * ny * nx;
  const long long nb = (long long)grid.x * grid.y * grid.z;
  unsigned* done = (unsigned*)(ws + nb);
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  phi_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(f, phi, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hcz3d_record_kernel<T><<<grid, THREADS, 0, stream>>>(g, phi, nz, ny, nx,
                                                       *c, ws, done, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n_steps steps of (f, g), each (19, nz, ny, nx), which are only read: step
// s writes (fa, ga) when s is even and (fb, gb) when s is odd, so the
// result is in (fa, ga) when n_steps is odd and in (fb, gb) when it is
// even (fb and gb may be null when n_steps <= 1).  phi is an (nz, ny, nx)
// scratch.  Returns the cudaError_t of the first launch that failed (0 on
// success; cudaErrorInvalidValue, launching nothing, for a box of
// 19 · nz · ny · nx >= 2^31 slots or more than 65,535 tile rows or chunks).
int hcz3d_step_f32(const void* f, const void* g, void* fa, void* ga,
                   void* fb, void* gb, void* phi, int nz, int ny, int nx,
                   int n_steps, const void* consts, void* stream) {
  return run_steps<float>((const float*)f, (const float*)g, (float*)fa,
                          (float*)ga, (float*)fb, (float*)gb, (float*)phi,
                          nz, ny, nx, n_steps, (const HCZConst3*)consts,
                          (cudaStream_t)stream);
}

int hcz3d_step_f64(const void* f, const void* g, void* fa, void* ga,
                   void* fb, void* gb, void* phi, int nz, int ny, int nx,
                   int n_steps, const void* consts, void* stream) {
  return run_steps<double>((const double*)f, (const double*)g, (double*)fa,
                           (double*)ga, (double*)fb, (double*)gb,
                           (double*)phi, nz, ny, nx, n_steps,
                           (const HCZConst3*)consts, (cudaStream_t)stream);
}

// The energy record of the state (f, g), each (19, nz, ny, nx), which are
// only read: out (1 double) = [½ Σ|u|² / (nz·ny·nx)].  phi is an
// (nz, ny, nx) scratch; ws holds ⌈nz/16⌉ · ⌈ny/8⌉ · ⌈nx/32⌉ + 1 doubles of
// workspace (one a block, and the counter).  One memset and two launches on
// the stream; returns the cudaError_t of the first that failed
// (cudaErrorInvalidValue, launching nothing, for a box the step refuses).
int hcz3d_record_f32(const void* f, const void* g, void* phi, void* ws,
                     void* out, int nz, int ny, int nx, const void* consts,
                     void* stream) {
  return run_record<float>((const float*)f, (const float*)g, (float*)phi,
                           (double*)ws, (double*)out, nz, ny, nx,
                           (const HCZConst3*)consts, (cudaStream_t)stream);
}

int hcz3d_record_f64(const void* f, const void* g, void* phi, void* ws,
                     void* out, int nz, int ny, int nx, const void* consts,
                     void* stream) {
  return run_record<double>((const double*)f, (const double*)g, (double*)phi,
                            (double*)ws, (double*)out, nz, ny, nx,
                            (const HCZConst3*)consts, (cudaStream_t)stream);
}

}  // extern "C"
