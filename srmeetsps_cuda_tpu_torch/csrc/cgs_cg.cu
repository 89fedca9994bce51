// Chronopoulos-Gear depth CG of SRmeetsPS as hand-written CUDA kernels for
// Hopper (sm_90a).
//
// Replaces the TPU kernel srmeetsps_cuda_tpu/solve/pallas_cg_cgs.py::_kernel
// (pallas_call at :409 through cg_pallas_cgs :439 and cg_pallas_cgs_batched
// :375), B >= 1 lanes, sf 1/2/4. The recurrence (pallas_cg_cgs.py:1-33,
// 213-333) needs one reduction point per iteration:
//
//   gamma = <r, r>, delta = <w, r>, w = M r
//   beta  = gamma / gamma_old                      (0 at the first iteration)
//   alpha = gamma / (delta - beta gamma / alpha_old)  (guarded divisions)
//   s = w + beta s, r' = r - alpha s, p = r + beta p, x += alpha p, w' = M r'
//
// M is applied through the 9 coefficient planes C of stencil_cg.cu
// (build_c is exact algebra for the mask-gated matvec _matvec_band, with
// ktw * tilesum added at sf = 4), not through the TPU kernel's band stream.
//
// Kernels (all launched by srps_cgs_cg on the caller's stream; the lane is
// blockIdx.z of the sweeps and blockIdx.x of the reduce):
//   prologue_a  the C planes, x = x0, p = s = 0, r0 = rhs - M x0;
//   prologue_b  w0 = M r0 and per-block partials of gamma0 and delta0;
//   sweep       one fused pass per iteration: s', p and x at the pixel, r'
//               at the pixel and its eight neighbours recomputed from
//               (r, w, s) (as stencil_cg.cu's sweep A recomputes p), w' =
//               M r', written to the other of two (r, w, s) buffer sets, and
//               per-block partials of gamma' and delta'. The two sets remove
//               the read-after-write hazard of a neighbour's r being
//               overwritten in the same pass (pallas_cg_cgs.py:56-61);
//   reduce      one block per lane: sums the partials in a fixed order (in
//               double), then decides the next iteration as the TPU kernel's
//               step it >= 1 does (active, beta, alpha, iters).
// That is 2 launches per iteration against the standard kernel's 4. No
// float atomics: runs repeat exactly and a lane's result does not depend on
// the other lanes. Like the TPU kernel, no energy is tracked; the caller
// evaluates it at the final iterate.
//
// Bound: memory bandwidth. Per iteration the sweep reads the 9 C planes,
// r, w, s, x, p and writes r', w', s', x, p: 19 f32 planes per lane, 93 MB
// at 960 x 1280, against about 29 flops per pixel (the standard kernel
// moves the same 19 planes in two sweeps).

#include "stencil_common.cuh"

namespace {

using namespace srps;

// Device scalars of one lane (float). S_K counts the sweeps done.
constexpr int S_GAMMA = 0, S_DELTA = 1, S_GOLD = 2, S_AOLD = 3, S_ALPHA = 4,
              S_BETA = 5, S_ACT = 6, S_ITERS = 7, S_K = 8;
constexpr int N_SCAL = 9;
// Planes of the (r, w, s) buffer pair, per lane: [r, w, s] of set 0, then
// of set 1.
constexpr int RWS_ROWS = 6;

__global__ void __launch_bounds__(MAX_THREADS)
prologue_a_kernel(const float* __restrict__ F, const float* __restrict__ R0,
                  const float* __restrict__ x0, float* __restrict__ x,
                  float* __restrict__ p, float* __restrict__ rws,
                  float* __restrict__ C, int h, int w, int sf, float lam) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const size_t hw = (size_t)h * w;
  const size_t lane = blockIdx.z;
  F += lane * F_ROWS * hw;
  R0 += lane * R_ROWS * hw;
  x0 += lane * hw;
  x += lane * hw;
  p += lane * hw;
  rws += lane * RWS_ROWS * hw;
  C += lane * N_STENCIL * hw;
  const size_t o = (size_t)i * w + j;
  float c[9];
  build_c(F, hw, i, j, h, w, lam, sf, c);
#pragma unroll
  for (int d = 0; d < 9; ++d) C[d * hw + o] = c[d];
  auto X = [&](int a, int b) { return at(x0, a, b, h, w); };
  float mx = stencil(c, X, i, j);
  if (sf == 4) mx += F[F_KTW * hw + o] * tile_sum(X, i, j, 4);
  x[o] = x0[o];
  p[o] = 0.0f;
  rws[o] = rhs_at(F, R0, hw, i, j, h, w, lam) - mx;  // r0, set 0
  rws[2 * hw + o] = 0.0f;                            // s0, set 0
}

__global__ void __launch_bounds__(MAX_THREADS)
prologue_b_kernel(const float* __restrict__ C, const float* __restrict__ F,
                  float* __restrict__ rws, float* __restrict__ part, int h,
                  int w, int sf) {
  __shared__ float sh_g[MAX_THREADS];
  __shared__ float sh_d[MAX_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const size_t lane = blockIdx.z;
  const int nb = gridDim.x * gridDim.y;
  C += lane * N_STENCIL * hw;
  const float* ktw = F + lane * F_ROWS * hw + F_KTW * hw;
  rws += lane * RWS_ROWS * hw;
  part += lane * 2 * nb;
  const float* r = rws;
  float g = 0.0f, d = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    float c[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = C[k * hw + o];
    auto R = [&](int a, int b) { return at(r, a, b, h, w); };
    float wv = stencil(c, R, i, j);
    if (sf == 4) wv += ktw[o] * tile_sum(R, i, j, 4);
    rws[hw + o] = wv;  // w0, set 0
    const float rv = r[o];
    g = rv * rv;
    d = wv * rv;
  }
  const float sg = block_sum(g, sh_g);
  const float sd = block_sum(d, sh_d);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    part[lane_block()] = sg;
    part[nb + lane_block()] = sd;
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
sweep_kernel(const float* __restrict__ C, const float* __restrict__ F,
             float* __restrict__ x, float* __restrict__ p,
             float* __restrict__ rws, int src, float* __restrict__ part,
             const float* __restrict__ scal, int h, int w, int sf) {
  const size_t lane = blockIdx.z;
  scal += lane * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  __shared__ float sh_g[MAX_THREADS];
  __shared__ float sh_d[MAX_THREADS];
  const float alpha = scal[S_ALPHA];
  const float beta = scal[S_BETA];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const int nb = gridDim.x * gridDim.y;
  C += lane * N_STENCIL * hw;
  const float* ktw = F + lane * F_ROWS * hw + F_KTW * hw;
  x += lane * hw;
  p += lane * hw;
  rws += lane * RWS_ROWS * hw;
  part += lane * 2 * nb;
  const float* r = rws + (size_t)(3 * src) * hw;
  const float* wo = r + hw;
  const float* so = r + 2 * hw;
  float* rn = rws + (size_t)(3 * (1 - src)) * hw;
  float* wn = rn + hw;
  float* sn = rn + 2 * hw;
  // s' and r' at any pixel, with explicit roundings so that every block
  // recomputes a neighbour's r' to the same bits as its owner writes it.
  auto S = [&](size_t q) { return __fmaf_rn(beta, so[q], wo[q]); };
  auto R = [&](int a, int b) {
    if (!inside(a, b, h, w)) return 0.0f;
    const size_t q = (size_t)a * w + b;
    return __fmaf_rn(-alpha, S(q), r[q]);
  };
  float g = 0.0f, d = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    float c[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = C[k * hw + o];
    const float pv = __fmaf_rn(beta, p[o], r[o]);
    x[o] = __fmaf_rn(alpha, pv, x[o]);
    p[o] = pv;
    const float rv = R(i, j);
    float wv = stencil(c, R, i, j);
    if (sf == 4) wv += ktw[o] * tile_sum(R, i, j, 4);
    rn[o] = rv;
    wn[o] = wv;
    sn[o] = S(o);
    g = rv * rv;
    d = wv * rv;
  }
  const float sg = block_sum(g, sh_g);
  const float sd = block_sum(d, sh_d);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    part[lane_block()] = sg;
    part[nb + lane_block()] = sd;
  }
}

// One block per lane (blockIdx.x). `first` follows the prologue: it seeds
// gamma_old = alpha_old = 1, active = 1 and iters = 0 (pallas_cg_cgs.py:
// 100-103); otherwise it follows a sweep and shifts gamma and alpha into
// their _old slots (:329-332). Then it decides the next iteration
// it = sweeps done + 1 (:216-232).
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_kernel(const float* __restrict__ part, int nb, float* __restrict__ scal,
              float tol2, int max_iter, int first) {
  scal += (size_t)blockIdx.x * N_SCAL;
  if (!first && scal[S_ACT] == 0.0f) return;
  __shared__ double sh[REDUCE_THREADS];
  part += (size_t)blockIdx.x * 2 * nb;
  const double gd = reduce_parts(part, nb, sh);
  const double dd = reduce_parts(part + nb, nb, sh);
  if (threadIdx.x == 0) {
    float act = 1.0f, iters = 0.0f, k = 0.0f;
    if (first) {
      scal[S_GOLD] = 1.0f;
      scal[S_AOLD] = 1.0f;
    } else {
      scal[S_GOLD] = scal[S_GAMMA];
      scal[S_AOLD] = scal[S_ALPHA];
      act = scal[S_ACT];
      iters = scal[S_ITERS];
      k = scal[S_K];
    }
    const float gamma = (float)gd;
    const float delta = (float)dd;
    scal[S_GAMMA] = gamma;
    scal[S_DELTA] = delta;
    const float it = k + 1.0f;
    const bool on = act > 0.0f && gamma > tol2 &&
                    it - 1.0f <= (float)max_iter;
    const float gold = scal[S_GOLD];
    const float beta =
        it == 1.0f ? 0.0f : gamma / (gold == 0.0f ? 1.0f : gold);
    const float denom = delta - beta * gamma / scal[S_AOLD];
    scal[S_BETA] = beta;
    scal[S_ALPHA] = gamma / (denom == 0.0f ? 1.0f : denom);
    scal[S_ACT] = on ? 1.0f : 0.0f;
    scal[S_ITERS] = on ? iters + 1.0f : iters;
    scal[S_K] = it;
  }
}

}  // namespace

// The Chronopoulos-Gear depth CG of B lanes on `stream`. Inputs, per lane:
// F (11, h, w), R0 (4, h, w), x0 (h, w). Outputs and scratch, allocated by
// the caller, per lane: x, p (h, w); rws (6, h, w); C (9, h, w); part
// (2 * blocks per lane); scal (9 floats: gamma = r1 in slot 0, iters in
// slot 7). Returns a cudaError_t.
extern "C" int srps_cgs_cg(const void* F, const void* R0, const void* x0,
                           void* x, void* p, void* rws, void* C, void* part,
                           void* scal, int B, int h, int w, int sf, float lam,
                           float tol2, int max_iter, int bx, int by,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(bx, by);
  const dim3 grid((w + bx - 1) / bx, (h + by - 1) / by, B);
  const int nb = (int)(grid.x * grid.y);
  const float* Ff = (const float*)F;
  const float* Cf = (const float*)C;
  float* xf = (float*)x;
  float* pf = (float*)p;
  float* rf = (float*)rws;
  float* pt = (float*)part;
  float* sc = (float*)scal;

  prologue_a_kernel<<<grid, block, 0, st>>>(Ff, (const float*)R0,
                                            (const float*)x0, xf, pf, rf,
                                            (float*)C, h, w, sf, lam);
  SRPS_CHECK();
  prologue_b_kernel<<<grid, block, 0, st>>>(Cf, Ff, rf, pt, h, w, sf);
  SRPS_CHECK();
  reduce_kernel<<<B, REDUCE_THREADS, 0, st>>>(pt, nb, sc, tol2, max_iter, 1);
  SRPS_CHECK();
  for (int k = 1; k <= max_iter + 1; ++k) {
    // Sweep k reads set (k + 1) % 2 and writes set k % 2 (set 0 holds r0).
    sweep_kernel<<<grid, block, 0, st>>>(Cf, Ff, xf, pf, rf, (k + 1) % 2, pt,
                                         sc, h, w, sf);
    SRPS_CHECK();
    reduce_kernel<<<B, REDUCE_THREADS, 0, st>>>(pt, nb, sc, tol2, max_iter,
                                                0);
    SRPS_CHECK();
  }
  return (int)cudaGetLastError();
}
