// Depth CG of SRmeetsPS as hand-written CUDA kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py::
// _kernel_vmem_stencil (pallas_call at :1471 through
// cg_pallas_vmem_fromop[_batched], in its "full_stencil" mode with the
// energy tracked: plain CG, scaled Jacobi or in-sweep Jacobi PCG, B >= 1
// lanes), and covers _kernel_vmem_hybrid_stencil (:708), the same CG whose
// C planes the TPU re-streams from HBM on 1080p-class grids: nothing here
// depends on the grid size. Each lane solves M x = rhs from the warm start
// x0, with M = KT^T KT + lam A^T A collapsed to a spatially varying 9-point
// stencil. The TPU kernel keeps the whole solve resident in VMEM inside a
// padded (8-row ring, 128-lane) layout and walks the lanes in sequence over
// its grid; here the planes are the unpadded (h, w) row-major images
// (stencil_common.cuh) and the lane is the grid's z dimension, so all lanes
// of a launch run at once.
//
// Jacobi modes (the `jacobi` argument; invd = 1 / diag(M) per lane):
//   0 PLAIN   plain CG;
//   1 SCALED  plain CG on S M S, S = diag(sqrt(invd)) (sf <= 2): the
//             prologue forms M x0 with the unscaled planes, then stores
//             C'_d[i] = (s_i C_d[i]) s_{i+d} and r' = s (rhs - M x0) and
//             starts the correction y at 0; the sweeps are PLAIN's; an
//             epilogue writes x = x0 + s y and sum r'^2 / invd;
//   2 PCG     in-sweep PCG: p = invd r + beta p, rz = sum r^2 invd drives
//             alpha, beta and the energy, rr = <r, r> the stop test.
//
// Kernels (all launched by srps_stencil_cg on the caller's stream):
//   prologue    builds the 9 planes C = [C0, C+x, C-x, C+y, C-y, C+x+y,
//               C+x-y, C-x+y, C-x-y] from P11..P33, the 4 gradient masks
//               and ktw (_build_c_band), forms r0 = rhs - M x0 and the
//               warm-start energy in residual form (_e0_band), and writes
//               per-block partial sums of <r0, r0>, of the energy and (PCG)
//               of rz;
//   sweep_a     p = z + beta p_old into the other buffer of a ping-pong
//               pair (p at the neighbours is recomputed from r and p_old),
//               w = sum_d C_d p[i + d] (+ ktw * tilesum(p) at sf = 4) and
//               per-block partials of <p, w>;
//   sweep_b     x += alpha p, r -= alpha w and partials of <r, r> (and rz);
//   reduce_*    one block per lane that sums the lane's partials in a fixed
//               order (in double) and updates the lane's device scalars
//               alpha, beta, r0, r1, rr, E, active and iters;
//               sweep_b and reduce_init/a/b live in std_cg.cuh, shared with
//               direct_cg.cu;
//   epilogue    (SCALED) x = x0 + sqrt(invd) y and partials of r'^2 / invd,
//               summed by reduce_res.
// The host launches max_iter + 1 iterations and never reads a scalar: each
// block returns at once when its lane's flag `active` is 0, so a lane that
// has stopped costs one flag read per kernel while the others run on. No
// float atomics are used, so iteration counts and energies repeat exactly,
// and a lane's result does not depend on the other lanes of its launch.
// No fast-math flags: sqrtf and the divisions are IEEE, so C' equals its
// plain PyTorch version bit for bit.
//
// Bound: memory bandwidth. Per iteration sweep A reads the 9 C planes plus
// r and p_old and writes p and w (13 planes), sweep B reads x, p, r, w and
// writes x, r (6 planes): about 19 f32 planes per lane, 93 MB at
// 960 x 1280, against about 27 flops per pixel; PCG reads invd in both
// sweeps (21 planes). The design keeps M as 9 coefficient planes (9
// multiply-adds a pixel instead of the ~40-op mask-gated matvec chain),
// folds the scaled Jacobi form into them once, and recomputes p at the
// neighbours instead of a separate pass. Fusing the sweeps, CUDA graphs and
// TMA staging are later work.

#include "std_cg.cuh"

namespace {

using namespace srps;

constexpr int PLAIN = 0, SCALED = 1, PCG = 2;

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
prologue_kernel(const float* __restrict__ F, const float* __restrict__ R0,
                const float* __restrict__ Z0U, const float* __restrict__ x0,
                const float* __restrict__ invd, float* __restrict__ x,
                float* __restrict__ r, float* __restrict__ p0,
                float* __restrict__ C, float* __restrict__ part, int h, int w,
                int sf, float lam) {
  __shared__ float sh_r[MAX_THREADS];
  __shared__ float sh_e[MAX_THREADS];
  __shared__ float sh_z[MODE == PCG ? MAX_THREADS : 1];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const size_t lane = blockIdx.z;
  const int nb = gridDim.x * gridDim.y;
  F += lane * F_ROWS * hw;
  R0 += lane * R_ROWS * hw;
  Z0U += lane * 2 * hw;
  x0 += lane * hw;
  if (MODE != PLAIN) invd += lane * hw;
  x += lane * hw;
  r += lane * hw;
  p0 += lane * hw;
  C += lane * N_STENCIL * hw;
  part += lane * PART_ROWS * nb;
  float rr = 0.0f, en = 0.0f, rz = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    float c[9];
    build_c(F, hw, i, j, h, w, lam, sf, c);
    auto X = [&](int a, int b) { return at(x0, a, b, h, w); };
    const float xc = x0[o];
    const float ktw = F[F_KTW * hw + o];
    const float ts = tile_sum(X, i, j, sf);
    float mx = stencil(c, X, i, j);
    if (sf == 4) mx += ktw * ts;
    float rv = rhs_at(F, R0, hw, i, j, h, w, lam) - mx;
    if (MODE == SCALED) {
      // M x0 above used the unscaled planes; the CG runs on S M S from
      // y = 0, and x0 stays in its input for the epilogue.
      // Offsets (di, dj) of the 9 planes, in the order of stencil().
      constexpr int DI[9] = {0, 0, 0, 1, -1, 1, -1, 1, -1};
      constexpr int DJ[9] = {0, 1, -1, 0, 0, 1, 1, -1, -1};
      const float si = sqrtf(invd[o]);
#pragma unroll
      for (int d = 0; d < 9; ++d)
        C[d * hw + o] =
            (si * c[d]) * sqrtf(at(invd, i + DI[d], j + DJ[d], h, w));
      rv = si * rv;
      x[o] = 0.0f;
    } else {
#pragma unroll
      for (int d = 0; d < 9; ++d) C[d * hw + o] = c[d];
      x[o] = xc;
    }
    r[o] = rv;
    p0[o] = 0.0f;
    rr = rv * rv;
    if (MODE == PCG) rz = rr * invd[o];

    // Warm-start energy in residual form (_e0_band); the caller adds
    // lam * sum B^2.
    en = energy_at(F, R0, Z0U, hw, o, i, j, sf, lam, X, ts);
  }
  const float sr = block_sum(rr, sh_r);
  const float se = block_sum(en, sh_e);
  const float sz = MODE == PCG ? block_sum(rz, sh_z) : 0.0f;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    part[lane_block()] = sr;
    part[nb + lane_block()] = se;
    if (MODE == PCG) part[2 * nb + lane_block()] = sz;
  }
}

template <bool JAC>
__global__ void __launch_bounds__(MAX_THREADS)
sweep_a_kernel(const float* __restrict__ C, const float* __restrict__ r,
               const float* __restrict__ p_old, float* __restrict__ p_new,
               float* __restrict__ wv, const float* __restrict__ F,
               const float* __restrict__ invd, float* __restrict__ part,
               const float* __restrict__ scal, int h, int w, int sf) {
  const size_t lane = blockIdx.z;
  scal += lane * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  __shared__ float sh[MAX_THREADS];
  const float beta = scal[S_BETA];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  C += lane * N_STENCIL * hw;
  r += lane * hw;
  p_old += lane * hw;
  p_new += lane * hw;
  wv += lane * hw;
  if (JAC) invd += lane * hw;
  const float* ktw = F + lane * F_ROWS * hw + F_KTW * hw;
  part += lane * PART_ROWS * gridDim.x * gridDim.y;
  auto P = [&](int a, int b) {
    if (!inside(a, b, h, w)) return 0.0f;
    const size_t q = (size_t)a * w + b;
    const float z = JAC ? invd[q] * r[q] : r[q];
    return z + beta * p_old[q];
  };
  float v = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    float c[9];
#pragma unroll
    for (int d = 0; d < 9; ++d) c[d] = C[d * hw + o];
    const float pc = P(i, j);
    float ws = stencil(c, P, i, j);
    if (sf == 4) ws += ktw[o] * tile_sum(P, i, j, 4);
    p_new[o] = pc;
    wv[o] = ws;
    v = pc * ws;
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[lane_block()] = s;
}

// SCALED: x = x0 + sqrt(invd) y over y in x, and partials of the plain
// residual <r, r> = sum r'^2 / invd (pallas_cg_vmem.py:665-696). Runs for
// every lane, stopped or not.
__global__ void __launch_bounds__(MAX_THREADS)
epilogue_kernel(const float* __restrict__ x0, const float* __restrict__ invd,
                float* __restrict__ x, const float* __restrict__ r,
                float* __restrict__ part, int h, int w) {
  __shared__ float sh[MAX_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const size_t lane = blockIdx.z;
  const size_t o = lane * hw + (size_t)i * w + j;
  float v = 0.0f;
  if (i < h && j < w) {
    const float iv = invd[o];
    // Two roundings, as in the plain version: no contraction to an FMA.
    x[o] = __fadd_rn(x0[o], __fmul_rn(sqrtf(iv), x[o]));
    const float rv = r[o];
    v = iv > 0.0f ? rv * rv / iv : 0.0f;
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    part[lane * PART_ROWS * gridDim.x * gridDim.y + lane_block()] = s;
}

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_res_kernel(const float* __restrict__ part, int nb,
                  float* __restrict__ scal) {
  __shared__ double sh[REDUCE_THREADS];
  const double rr =
      reduce_parts(part + (size_t)blockIdx.x * PART_ROWS * nb, nb, sh);
  if (threadIdx.x == 0) scal[(size_t)blockIdx.x * N_SCAL + S_RR] = (float)rr;
}

template <int MODE>
int run(const float* F, const float* R0, const float* Z0U, const float* x0,
        const float* invd, float* x, float* r, float* pa, float* pb,
        float* wv, float* C, float* part, float* scal, int B, int h, int w,
        int sf, float lam, float tol2, int max_iter, int bx, int by,
        cudaStream_t st) {
  constexpr bool JAC = MODE == PCG;
  const dim3 block(bx, by);
  const dim3 grid((w + bx - 1) / bx, (h + by - 1) / by, B);
  const int nb = (int)(grid.x * grid.y);
  prologue_kernel<MODE><<<grid, block, 0, st>>>(F, R0, Z0U, x0, invd, x, r,
                                                pa, C, part, h, w, sf, lam);
  SRPS_CHECK();
  reduce_init_kernel<JAC><<<B, REDUCE_THREADS, 0, st>>>(part, nb, scal, tol2,
                                                        max_iter);
  SRPS_CHECK();
  for (int k = 1; k <= max_iter + 1; ++k) {
    const float* p_old = (k % 2 == 1) ? pa : pb;
    float* p_new = (k % 2 == 1) ? pb : pa;
    sweep_a_kernel<JAC><<<grid, block, 0, st>>>(C, r, p_old, p_new, wv, F,
                                                invd, part, scal, h, w, sf);
    SRPS_CHECK();
    reduce_a_kernel<<<B, REDUCE_THREADS, 0, st>>>(part, nb, scal);
    SRPS_CHECK();
    sweep_b_kernel<JAC><<<grid, block, 0, st>>>(x, r, p_new, wv, invd, part,
                                                scal, h, w);
    SRPS_CHECK();
    reduce_b_kernel<JAC><<<B, REDUCE_THREADS, 0, st>>>(part, nb, scal, tol2,
                                                       max_iter);
    SRPS_CHECK();
  }
  if (MODE == SCALED) {
    epilogue_kernel<<<grid, block, 0, st>>>(x0, invd, x, r, part, h, w);
    SRPS_CHECK();
    reduce_res_kernel<<<B, REDUCE_THREADS, 0, st>>>(part, nb, scal);
    SRPS_CHECK();
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The depth CG of B lanes on `stream`. Inputs, per lane: F (11, h, w),
// R0 (4, h, w), Z0U (2, h, w) = [up(masks), up(masks * z0s)], x0 (h, w),
// invd (h, w) or null with jacobi = 0. Outputs and scratch, allocated by
// the caller, per lane: x, r, p0, p1, w (h, w); C (9, h, w); part
// (PART_ROWS * blocks per lane); scal (N_SCAL floats). jacobi: 0 plain CG,
// 1 scaled Jacobi (sf <= 2), 2 in-sweep Jacobi PCG. Returns a cudaError_t.
extern "C" int srps_stencil_cg(const void* F, const void* R0, const void* Z0U,
                               const void* x0, const void* invd, void* x,
                               void* r, void* p0, void* p1, void* wv, void* C,
                               void* part, void* scal, int B, int h, int w,
                               int sf, float lam, float tol2, int max_iter,
                               int bx, int by, int jacobi, void* stream) {
  if ((jacobi != PLAIN) != (invd != nullptr) || jacobi < PLAIN ||
      jacobi > PCG || (jacobi == SCALED && sf > 2))
    return (int)cudaErrorInvalidValue;
  auto run_mode = &run<PLAIN>;
  if (jacobi == SCALED) run_mode = &run<SCALED>;
  if (jacobi == PCG) run_mode = &run<PCG>;
  return run_mode((const float*)F, (const float*)R0, (const float*)Z0U,
                  (const float*)x0, (const float*)invd, (float*)x, (float*)r,
                  (float*)p0, (float*)p1, (float*)wv, (float*)C, (float*)part,
                  (float*)scal, B, h, w, sf, lam, tol2, max_iter, bx, by,
                  (cudaStream_t)stream);
}
