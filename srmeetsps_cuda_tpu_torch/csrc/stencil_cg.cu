// Depth CG of SRmeetsPS as hand-written CUDA kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py::
// _kernel_vmem_stencil (pallas_call at :1471 through
// cg_pallas_vmem_fromop[_batched], in its "full_stencil" mode with the
// energy tracked, plain CG, B >= 1 lanes). Each lane solves M x = rhs from
// the warm start x0, with M = KT^T KT + lam A^T A collapsed to a spatially
// varying 9-point stencil. The TPU kernel keeps the whole solve resident in
// VMEM inside a padded (8-row ring, 128-lane) layout and walks the lanes in
// sequence over its grid; here the planes are the unpadded (h, w) row-major
// images (stencil_common.cuh) and the lane is the grid's z dimension, so
// all lanes of a launch run at once.
//
// Kernels (all launched by srps_stencil_cg on the caller's stream):
//   prologue    builds the 9 planes C = [C0, C+x, C-x, C+y, C-y, C+x+y,
//               C+x-y, C-x+y, C-x-y] from P11..P33, the 4 gradient masks
//               and ktw (_build_c_band), forms r0 = rhs - M x0 and the
//               warm-start energy in residual form (_e0_band), and writes
//               per-block partial sums of <r0, r0> and of the energy;
//   sweep_a     p = r + beta p_old into the other buffer of a ping-pong
//               pair (p at the neighbours is recomputed from r and p_old),
//               w = sum_d C_d p[i + d] (+ ktw * tilesum(p) at sf = 4) and
//               per-block partials of <p, w>;
//   sweep_b     x += alpha p, r -= alpha w and partials of <r, r>;
//   reduce_*    one block per lane that sums the lane's partials in a fixed
//               order (in double) and updates the lane's device scalars
//               alpha, beta, r0, r1, E, active and iters.
// The host launches max_iter + 1 iterations and never reads a scalar: each
// block returns at once when its lane's flag `active` is 0, so a lane that
// has stopped costs one flag read per kernel while the others run on. No
// float atomics are used, so iteration counts and energies repeat exactly,
// and a lane's result does not depend on the other lanes of its launch.
//
// Bound: memory bandwidth. Per iteration sweep A reads the 9 C planes plus
// r and p_old and writes p and w (13 planes), sweep B reads x, p, r, w and
// writes x, r (6 planes): about 19 f32 planes per lane, 93 MB at
// 960 x 1280, against about 27 flops per pixel. The design keeps M as 9
// coefficient planes (9 multiply-adds a pixel instead of the ~40-op
// mask-gated matvec chain) and recomputes p at the neighbours instead of a
// separate pass. Fusing the sweeps, CUDA graphs and TMA staging are later
// work.

#include "stencil_common.cuh"

namespace {

using namespace srps;

// Device scalars of one lane (float).
constexpr int S_R0 = 0, S_R1 = 1, S_PW = 2, S_ALPHA = 3, S_BETA = 4,
              S_E = 5, S_ACT = 6, S_ITERS = 7, S_K = 8;
constexpr int N_SCAL = 9;

__global__ void __launch_bounds__(MAX_THREADS)
prologue_kernel(const float* __restrict__ F, const float* __restrict__ R0,
                const float* __restrict__ Z0U, const float* __restrict__ x0,
                float* __restrict__ x, float* __restrict__ r,
                float* __restrict__ p0, float* __restrict__ C,
                float* __restrict__ part, int h, int w, int sf, float lam) {
  __shared__ float sh_r[MAX_THREADS];
  __shared__ float sh_e[MAX_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const size_t lane = blockIdx.z;
  const int nb = gridDim.x * gridDim.y;
  F += lane * F_ROWS * hw;
  R0 += lane * R_ROWS * hw;
  Z0U += lane * 2 * hw;
  x0 += lane * hw;
  x += lane * hw;
  r += lane * hw;
  p0 += lane * hw;
  C += lane * N_STENCIL * hw;
  part += lane * 2 * nb;
  float rr = 0.0f, en = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    float c[9];
    build_c(F, hw, i, j, h, w, lam, sf, c);
#pragma unroll
    for (int d = 0; d < 9; ++d) C[d * hw + o] = c[d];
    auto X = [&](int a, int b) { return at(x0, a, b, h, w); };
    const float xc = x0[o];
    const float ktw = F[F_KTW * hw + o];
    const float ts = tile_sum(X, i, j, sf);
    float mx = stencil(c, X, i, j);
    if (sf == 4) mx += ktw * ts;
    const float rv = rhs_at(F, R0, hw, i, j, h, w, lam) - mx;
    x[o] = xc;
    r[o] = rv;
    p0[o] = 0.0f;
    rr = rv * rv;

    // Warm-start energy in residual form (_e0_band); the caller adds
    // lam * sum B^2.
    const float ax = F[F_AX * hw + o], bx = F[F_BX * hw + o];
    const float ay = F[F_AY * hw + o], by = F[F_BY * hw + o];
    const float g = ax * (X(i, j + 1) - xc) + bx * (xc - X(i, j - 1));
    const float hh = ay * (X(i + 1, j) - xc) + by * (xc - X(i - 1, j));
    const float quad =
        F[F_P11 * hw + o] * g * g + F[F_P22 * hw + o] * hh * hh +
        F[F_P33 * hw + o] * xc * xc +
        2.0f * (F[F_P12 * hw + o] * g * hh - F[F_P13 * hw + o] * g * xc -
                F[F_P23 * hw + o] * hh * xc);
    const float lin = R0[R_QB1 * hw + o] * g + R0[R_QB2 * hw + o] * hh -
                      R0[R_QB3 * hw + o] * xc;
    const float inv = 1.0f / (float)(sf * sf);
    const float rkt = Z0U[o] * (ts * inv) - Z0U[hw + o];
    en = rkt * rkt * inv + lam * (quad - 2.0f * lin);
  }
  const float sr = block_sum(rr, sh_r);
  const float se = block_sum(en, sh_e);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    part[lane_block()] = sr;
    part[nb + lane_block()] = se;
  }
}

// One block per lane (blockIdx.x).
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_init_kernel(const float* __restrict__ part, int nb,
                   float* __restrict__ scal, float tol2, int max_iter) {
  __shared__ double sh[REDUCE_THREADS];
  part += (size_t)blockIdx.x * 2 * nb;
  scal += (size_t)blockIdx.x * N_SCAL;
  const double r1 = reduce_parts(part, nb, sh);
  const double e0 = reduce_parts(part + nb, nb, sh);
  if (threadIdx.x == 0) {
    const float r1f = (float)r1;
    const bool act = (r1f > tol2) && (0 <= max_iter);
    scal[S_R0] = 0.0f;
    scal[S_R1] = r1f;
    scal[S_PW] = 0.0f;
    scal[S_ALPHA] = 0.0f;
    scal[S_BETA] = 0.0f;
    scal[S_E] = (float)e0;
    scal[S_ACT] = act ? 1.0f : 0.0f;
    scal[S_ITERS] = act ? 1.0f : 0.0f;
    scal[S_K] = 1.0f;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
sweep_a_kernel(const float* __restrict__ C, const float* __restrict__ r,
               const float* __restrict__ p_old, float* __restrict__ p_new,
               float* __restrict__ wv, const float* __restrict__ F,
               float* __restrict__ part, const float* __restrict__ scal,
               int h, int w, int sf) {
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
  const float* ktw = F + lane * F_ROWS * hw + F_KTW * hw;
  part += lane * 2 * gridDim.x * gridDim.y;
  auto P = [&](int a, int b) {
    if (!inside(a, b, h, w)) return 0.0f;
    const size_t q = (size_t)a * w + b;
    return r[q] + beta * p_old[q];
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

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_a_kernel(const float* __restrict__ part, int nb,
                float* __restrict__ scal) {
  scal += (size_t)blockIdx.x * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  __shared__ double sh[REDUCE_THREADS];
  const double pw = reduce_parts(part + (size_t)blockIdx.x * 2 * nb, nb, sh);
  if (threadIdx.x == 0) {
    const float pwf = (float)pw;
    const float r1 = scal[S_R1];
    const float alpha = r1 / (pwf == 0.0f ? 1.0f : pwf);
    scal[S_PW] = pwf;
    scal[S_ALPHA] = alpha;
    // E(x + alpha p) = E(x) - alpha <p, r> with <p, r> = r1 (_e0_band),
    // using r1 from before sweep B.
    scal[S_E] = scal[S_E] - alpha * r1;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
sweep_b_kernel(float* __restrict__ x, float* __restrict__ r,
               const float* __restrict__ p, const float* __restrict__ wv,
               float* __restrict__ part, const float* __restrict__ scal,
               int h, int w) {
  const size_t lane = blockIdx.z;
  scal += lane * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  __shared__ float sh[MAX_THREADS];
  const float alpha = scal[S_ALPHA];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  x += lane * hw;
  r += lane * hw;
  p += lane * hw;
  wv += lane * hw;
  part += lane * 2 * gridDim.x * gridDim.y;
  float v = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    x[o] = x[o] + alpha * p[o];
    const float rv = r[o] - alpha * wv[o];
    r[o] = rv;
    v = rv * rv;
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[lane_block()] = s;
}

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_b_kernel(const float* __restrict__ part, int nb,
                float* __restrict__ scal, float tol2, int max_iter) {
  scal += (size_t)blockIdx.x * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  __shared__ double sh[REDUCE_THREADS];
  const double rr = reduce_parts(part + (size_t)blockIdx.x * 2 * nb, nb, sh);
  if (threadIdx.x == 0) {
    const float rrf = (float)rr;
    const float r1_old = scal[S_R1];
    scal[S_R0] = r1_old;
    scal[S_R1] = rrf;
    // Start of the next iteration k: the reference's test
    // r1 > tol^2 && k - 1 <= max_iter, and beta = r1 / r0.
    const float k = scal[S_K] + 1.0f;
    scal[S_K] = k;
    const bool act = (rrf > tol2) && (k - 1.0f <= (float)max_iter);
    scal[S_ACT] = act ? 1.0f : 0.0f;
    scal[S_BETA] = rrf / (r1_old == 0.0f ? 1.0f : r1_old);
    if (act) scal[S_ITERS] = scal[S_ITERS] + 1.0f;
  }
}

}  // namespace

// The depth CG of B lanes on `stream`. Inputs, per lane: F (11, h, w),
// R0 (4, h, w), Z0U (2, h, w) = [up(masks), up(masks * z0s)], x0 (h, w).
// Outputs and scratch, allocated by the caller, per lane: x, r, p0, p1, w
// (h, w); C (9, h, w); part (2 * blocks per lane); scal (9 floats).
// Returns a cudaError_t.
extern "C" int srps_stencil_cg(const void* F, const void* R0, const void* Z0U,
                               const void* x0, void* x, void* r, void* p0,
                               void* p1, void* wv, void* C, void* part,
                               void* scal, int B, int h, int w, int sf,
                               float lam, float tol2, int max_iter, int bx,
                               int by, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(bx, by);
  const dim3 grid((w + bx - 1) / bx, (h + by - 1) / by, B);
  const int nb = (int)(grid.x * grid.y);
  const float* Ff = (const float*)F;
  float* sc = (float*)scal;
  float* pt = (float*)part;
  float* xf = (float*)x;
  float* rf = (float*)r;
  float* pa = (float*)p0;
  float* pb = (float*)p1;
  float* wf = (float*)wv;
  const float* Cf = (const float*)C;

  prologue_kernel<<<grid, block, 0, st>>>(
      Ff, (const float*)R0, (const float*)Z0U, (const float*)x0, xf, rf, pa,
      (float*)C, pt, h, w, sf, lam);
  SRPS_CHECK();
  reduce_init_kernel<<<B, REDUCE_THREADS, 0, st>>>(pt, nb, sc, tol2, max_iter);
  SRPS_CHECK();
  for (int k = 1; k <= max_iter + 1; ++k) {
    const float* p_old = (k % 2 == 1) ? pa : pb;
    float* p_new = (k % 2 == 1) ? pb : pa;
    sweep_a_kernel<<<grid, block, 0, st>>>(Cf, rf, p_old, p_new, wf, Ff, pt,
                                           sc, h, w, sf);
    SRPS_CHECK();
    reduce_a_kernel<<<B, REDUCE_THREADS, 0, st>>>(pt, nb, sc);
    SRPS_CHECK();
    sweep_b_kernel<<<grid, block, 0, st>>>(xf, rf, p_new, wf, pt, sc, h, w);
    SRPS_CHECK();
    reduce_b_kernel<<<B, REDUCE_THREADS, 0, st>>>(pt, nb, sc, tol2,
                                                  max_iter);
    SRPS_CHECK();
  }
  return (int)cudaGetLastError();
}
