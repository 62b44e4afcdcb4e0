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
  __syncthreads();

  // ---- stage 2: ρ, ψρ, ψφ and ∇²φ over the G box, once per cell ----
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
    s_pr[r] = cs_psi(rho, c);
    s_pp[r] = cs_psi(pc, c);
  }
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

}  // extern "C"
