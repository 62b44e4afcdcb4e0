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
// buffers, so input and output never alias.  Both kernels form a cell's
// fields through the force-inlined helpers neighbourhood, moments and
// force.
//
// The record (scrt_record_kernel, the C entries scrt_record_*): the
// driver's energy, mass and spike/bubble record of one state, after
// psi_kernel has filled a scratch ψ from it (the step's ψ buffer holds the
// state before the last step).  One pass forms each fluid cell's ρ, u and F
// through the same helpers, sums |u + F/(2ρ)|² and ρ in double (warp
// shuffles, one partial a block, a fixed-order total in the last block) and
// finds the two columns' topmost light rows; the host reads back four
// doubles instead of the ρ field and the plain diagnostics' fields.  About
// 80 B a cell in float32: the ψ pass's 36 in and 4 out, the record's 36 and
// ψ's 4 in.
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

// The record pass's block and its largest grid (ops/scrt_fused.RECORD_BLOCKS
// mirrors the latter): each thread walks the lattice with the grid's stride,
// so the last block adds up at most 2048 partials.
constexpr int RECORD_THREADS = 256;
constexpr int RECORD_BLOCKS = 2048;

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

// ---- shared by the step and the record: the fields of one fluid cell ----

// The cells r + c_k of the fluid cell (y, x), 1 <= y <= ny − 2, in nb (x
// wraps, rows y ± 1 exist), and whether each of the rows y − 1, y, y + 1 is
// fluid (a row is fluid iff it is not a wall row).
__device__ __forceinline__ void neighbourhood(int y, int x, int ny, int nx,
                                              size_t nb[9],
                                              bool row_fluid[3]) {
  const int xs[3] = {x == 0 ? nx - 1 : x - 1, x, x == nx - 1 ? 0 : x + 1};
  const int ys[3] = {y - 1, y, y + 1};
  row_fluid[0] = y - 1 >= 1;
  row_fluid[1] = true;
  row_fluid[2] = y + 1 <= ny - 2;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    nb[k] = (size_t)ys[cy(k) + 1] * nx + xs[cx(k) + 1];
}

// ρ = Σ_k f_k summed k = 0…8, 1/ρ_safe with ρ_safe = max(ρ, 1e-14), and
// u = Σ c f / ρ_safe of the populations fk.
template <typename T>
__device__ __forceinline__ void moments(const T fk[9], T& rho, T& inv_rho,
                                        T& ux, T& uy) {
  rho = fk[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) rho += fk[k];
  const T rho_safe = rho < T(1e-14) ? T(1e-14) : rho;  // NaN propagates
  inv_rho = T(1) / rho_safe;
  ux = (fk[5] + fk[7] + fk[8] - fk[0] - fk[2] - fk[3]) * inv_rho;
  uy = (fk[3] + fk[6] + fk[7] - fk[1] - fk[2] - fk[8]) * inv_rho;
}

// The fluid–fluid force with mirrored reads, and gravity:
// F = −g ψ(r) Σ_k w_k c_k ψ_k + (0, gravity·ρ) of the cell i, ψ_k = ψ(r + c_k)
// where that row is fluid and ψ(r − c_k) where it is a wall.
template <typename T>
__device__ __forceinline__ void force(const T* __restrict__ psi, size_t i,
                                      const size_t nb[9],
                                      const bool row_fluid[3], T rho,
                                      const SCRTConst& c, T& Fx, T& Fy) {
  const T psi_c = psi[i];
  T sx = T(0), sy = T(0);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const T v = row_fluid[cy(k) + 1] ? psi[nb[k]] : psi[nb[opp(k)]];
    if (cx(k)) sx += T(wk(k) * cx(k)) * v;
    if (cy(k)) sy += T(wk(k) * cy(k)) * v;
  }
  Fx = T(c.neg_g) * psi_c * sx;
  Fy = T(c.neg_g) * psi_c * sy + T(c.gravity) * rho;
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
  size_t nb[9];  // cell r + c_k
  bool row_fluid[3];
  neighbourhood(y, x, ny, nx, nb, row_fluid);

  // ---- macroscopic fields ----
  T fk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) fk[k] = f[k * n + i];
  T rho, inv_rho, ux, uy;
  moments(fk, rho, inv_rho, ux, uy);

  // ---- fluid–fluid force with mirrored reads, gravity ----
  T Fx, Fy;
  force(psi, i, nb, row_fluid, rho, c, Fx, Fy);

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

// ---- the record ----

// Sums of e and m and the largest h0 and h1 over the block, in a fixed
// order: the shuffle tree within each warp, then the warps in turn, on
// thread 0 (the other threads keep partial values).  Every thread of the
// block must call it.
__device__ __forceinline__ void block_reduce(double& e, double& m, int& h0,
                                             int& h1, double* s_d, int* s_h,
                                             int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    e += __shfl_down_sync(0xffffffffu, e, o);
    m += __shfl_down_sync(0xffffffffu, m, o);
    const int a0 = __shfl_down_sync(0xffffffffu, h0, o);
    const int a1 = __shfl_down_sync(0xffffffffu, h1, o);
    h0 = a0 > h0 ? a0 : h0;
    h1 = a1 > h1 ? a1 : h1;
  }
  if (tid % 32 == 0) {
    s_d[2 * (tid / 32)] = e;
    s_d[2 * (tid / 32) + 1] = m;
    s_h[2 * (tid / 32)] = h0;
    s_h[2 * (tid / 32) + 1] = h1;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < RECORD_THREADS / 32; ++w) {
      e += s_d[2 * w];
      m += s_d[2 * w + 1];
      h0 = s_h[2 * w] > h0 ? s_h[2 * w] : h0;
      h1 = s_h[2 * w + 1] > h1 ? s_h[2 * w + 1] : h1;
    }
  }
}

// The record of one state (what models/shan_chen_rt.kinetic_energy, the
// driver's mass and interface_height compute from it), after psi_kernel has
// filled psi from the same state: each fluid cell's ρ, u and F through the
// step's helpers, ua = u + F/(2ρ_safe), and |ua|² and ρ summed in double;
// and, for the spike column x = nx/2 and the bubble column x = 0, the
// largest y in [1, ny − 2] with ρ ≤ rho_cut (0 if none).  Each thread walks
// the lattice with the grid's stride; each block leaves its sums and its
// two rows in part and hpart; the last block to finish (a counter the
// entry zeroes) adds them up in block order and writes
// out = [½ Σ|ua|² / (ny·nx), Σρ, spike row, bubble row].  No float atomics:
// the same state gives the same bits.  Reads f and ψ once (the
// neighbours' ψ hit the caches): 40 B a cell in float32.
template <typename T>
__global__ void __launch_bounds__(RECORD_THREADS)
scrt_record_kernel(const T* __restrict__ f, const T* __restrict__ psi,
                   int ny, int nx, SCRTConst c, double rho_cut,
                   double* __restrict__ part, int* __restrict__ hpart,
                   unsigned* __restrict__ done, double* __restrict__ out) {
  __shared__ double s_d[2 * (RECORD_THREADS / 32)];
  __shared__ int s_h[2 * (RECORD_THREADS / 32)];
  __shared__ bool s_last;

  const size_t n = (size_t)ny * nx;
  const int tid = threadIdx.x;
  const size_t stride = (size_t)gridDim.x * RECORD_THREADS;
  const int spike_x = nx / 2;
  const T cut = T(rho_cut);
  double e = 0.0, m = 0.0;
  int h0 = 0, h1 = 0;
  for (size_t i = (size_t)blockIdx.x * RECORD_THREADS + tid; i < n;
       i += stride) {
    const int y = (int)(i / nx);
    const int x = (int)(i - (size_t)y * nx);
    if (y == 0 || y == ny - 1) continue;  // the walls are not fluid
    size_t nb[9];
    bool row_fluid[3];
    neighbourhood(y, x, ny, nx, nb, row_fluid);
    T fk[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) fk[k] = f[k * n + i];
    T rho, inv_rho, ux, uy;
    moments(fk, rho, inv_rho, ux, uy);
    T Fx, Fy;
    force(psi, i, nb, row_fluid, rho, c, Fx, Fy);
    const double ax = ux + T(0.5) * Fx * inv_rho;
    const double ay = uy + T(0.5) * Fy * inv_rho;
    e += ax * ax + ay * ay;
    m += rho;
    if (rho <= cut) {
      if (x == spike_x) h0 = y > h0 ? y : h0;
      if (x == 0) h1 = y > h1 ? y : h1;
    }
  }

  // ---- the block's part, then the last block's fixed-order total ----
  block_reduce(e, m, h0, h1, s_d, s_h, tid);
  const int nblocks = gridDim.x;
  if (tid == 0) {
    part[2 * blockIdx.x] = e;
    part[2 * blockIdx.x + 1] = m;
    hpart[2 * blockIdx.x] = h0;
    hpart[2 * blockIdx.x + 1] = h1;
    __threadfence();
    s_last = atomicAdd(done, 1u) == (unsigned)nblocks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  e = m = 0.0;
  h0 = h1 = 0;
  for (int b = tid; b < nblocks; b += RECORD_THREADS) {
    e += __ldcg(&part[2 * b]);
    m += __ldcg(&part[2 * b + 1]);
    const int v0 = __ldcg(&hpart[2 * b]), v1 = __ldcg(&hpart[2 * b + 1]);
    h0 = v0 > h0 ? v0 : h0;
    h1 = v1 > h1 ? v1 : h1;
  }
  block_reduce(e, m, h0, h1, s_d, s_h, tid);
  if (tid == 0) {
    out[0] = 0.5 * e / (double)n;
    out[1] = m;
    out[2] = h0;
    out[3] = h1;
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

// The record's launches: the counter zeroed, psi_kernel into the scratch
// psi, then the record pass on min(⌈n/RECORD_THREADS⌉, RECORD_BLOCKS)
// blocks.  The workspace ws, 3 · RECORD_BLOCKS + 1 doubles, holds part (two
// doubles a block), hpart (two ints a block) and the counter.
template <typename T>
int launch_record(const T* f, T* psi, double* ws, double* out, int ny,
                  int nx, const SCRTConst* c, double rho_cut,
                  cudaStream_t stream) {
  if (ny < 3 || nx < 1) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)ny * nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const size_t want = (n + RECORD_THREADS - 1) / RECORD_THREADS;
  const unsigned rblocks =
      (unsigned)(want < RECORD_BLOCKS ? want : RECORD_BLOCKS);
  int* hpart = (int*)(ws + 2 * RECORD_BLOCKS);
  unsigned* done = (unsigned*)(ws + 3 * RECORD_BLOCKS);
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  psi_kernel<T><<<blocks, threads, 0, stream>>>(f, psi, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scrt_record_kernel<T><<<rblocks, RECORD_THREADS, 0, stream>>>(
      f, psi, ny, nx, *c, rho_cut, ws, hpart, done, out);
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

// The record of the channel state f (9, ny, nx), ny >= 3: out (4 doubles)
// = [½ Σ|u + F/(2ρ_safe)|² over the fluid rows / (ny·nx), Σρ over them,
// the largest y in [1, ny − 2] with ρ ≤ rho_cut in the spike column
// x = nx/2, the same in the bubble column x = 0] (a row 0 where there is
// none).  psi is (ny, nx) scratch; ws holds 3 · 2048 + 1 doubles of
// workspace.  One memset and two launches on the stream; returns the
// cudaError_t (cudaErrorInvalidValue, launching nothing, for ny < 3).
int scrt_record_f32(const void* f, void* psi, void* ws, void* out, int ny,
                    int nx, const void* consts, double rho_cut,
                    void* stream) {
  return launch_record<float>((const float*)f, (float*)psi, (double*)ws,
                              (double*)out, ny, nx, (const SCRTConst*)consts,
                              rho_cut, (cudaStream_t)stream);
}

int scrt_record_f64(const void* f, void* psi, void* ws, void* out, int ny,
                    int nx, const void* consts, double rho_cut,
                    void* stream) {
  return launch_record<double>((const double*)f, (double*)psi, (double*)ws,
                               (double*)out, ny, nx,
                               (const SCRTConst*)consts, rho_cut,
                               (cudaStream_t)stream);
}

}  // extern "C"
