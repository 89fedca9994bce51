// Row-shard depth CG of SRmeetsPS as hand-written CUDA kernels for Hopper
// (sm_90a): the per-shard kernels of a solve split into N row bands.
//
// Replaces the TPU kernels of srmeetsps_cuda_tpu/parallel/shard_pallas.py:
//   _prologue_kernel   (:124)  -> prologue_kernel (+ w0_kernel for CGS)
//   _cgs_sweep_kernel  (:249)  -> cgs_sweep_kernel
//   _std_kernel_a      (:375)  -> sweep_a_kernel
//   _std_kernel_b      (:440)  -> sweep_b_kernel<false> (std_cg.cuh)
//   _std_kernel_b_jac  (:495)  -> sweep_b_kernel<true>  (std_cg.cuh)
// The TPU kernels walk a shard in bands inside an 8-row ring padded to 128
// lanes, with a tail band that overlaps its predecessor; here a shard is one
// launch over its (h, w) rows, h = H / N a multiple of sf, so that sf x sf
// tiles never cross a shard and a shard's first row has an even global
// index (build_c's sf = 2 phase fold holds as on the whole grid).
//
// Halo layout. Every plane a kernel reads at a neighbouring row is an
// (h + 2, w) plane: rows -1 and h hold the neighbour shards' edge rows, or
// zeros at the global top and bottom, and the kernels take a pointer to row
// 0 with HALO = 1 (stencil_common.cuh). The caller fills those rows:
//   - once per solve: F (11 planes, for the C planes' A^T A part at i +- 1),
//     R0 (QB2 at i +- 1 in rhs), x0 (M x0) and, under Jacobi, invd;
//   - standard CG, one exchange per iteration: r after sweep B. Sweep A
//     recomputes p = z + beta p_old on the two halo rows from the exchanged
//     r and its own p_old halo (which it wrote the iteration before by the
//     same arithmetic), and writes them: p needs no exchange of its own,
//     where the TPU path exchanges both p and r (shard_pallas.py:942, 947);
//   - CGS, one stacked exchange of (r, w, s) per iteration (as :856): the
//     sweep recomputes r' on the halo rows as cgs_cg.cu does at a block's
//     edge.
// Dot products. Each launch writes per-block partials; sum_kernel adds a
// shard's partials in a fixed order in double into `own`; the caller copies
// every shard's `own` into each shard's `gathered` (N x 2 doubles, shard
// order), and the combine step at the start of the next launch adds them in
// shard order and updates that shard's scalars (std_cg.cuh scal_* or
// cgs::update). All shards add the same doubles in the same order, so their
// scalars are equal bit for bit, and a repeated solve repeats exactly.
//
// Entry points, each launched on the caller's stream, in the order a solve
// calls them (the caller exchanges halos and gathers sums in between):
//   srps_shard_prologue   r0 = rhs - M x0, the C planes, x = x0, partials
//                         <r0, r0> (and rz0 under Jacobi);
//   srps_shard_cgs_w0     CGS: w0 = M r0, partials gamma0 and delta0;
//   srps_shard_step_a     combine (the prologue's sums, or sweep B's),
//                         sweep A: p = z + beta p_old (z = invd r under
//                         Jacobi), w = sum_d C_d p[i + d] (+ ktw *
//                         tilesum(p) at sf = 4), partials <p, w>;
//   srps_shard_step_b     combine <p, w>, sweep B: x += alpha p, r -= alpha
//                         w, partials <r, r> (and rz under Jacobi);
//   srps_shard_cgs_step   combine (gamma, delta), one CGS sweep, partials;
//   srps_shard_finish / srps_shard_cgs_finish  the last combine.
// A stopped solve's launches return at their first read of `active`.
//
// Bound: memory bandwidth, as the unsharded kernels: per iteration and
// pixel the standard CG moves 19 f32 planes (9 C, r, p_old, p, w; x, p, r,
// w read and x, r written), 21 under Jacobi, the CGS sweep 19. Per shard
// and iteration it adds two launches of one-block sums, one combine of N
// doubles per launch, and 2 halo rows per exchanged plane. A simple kernel:
// the sweeps are those of stencil_cg.cu and cgs_cg.cu, one shard at a time.

#include "cgs_common.cuh"
#include "std_cg.cuh"

namespace {

using namespace srps;

// Sum of `rows` rows of nb partials into own[0..rows), in double, by one
// block; skipped when `scal` (the shard's standard or CGS scalars) says the
// solve has stopped.
__global__ void __launch_bounds__(REDUCE_THREADS)
sum_kernel(const float* __restrict__ part, int nb, int rows,
           double* __restrict__ own, const float* __restrict__ scal,
           int act_slot) {
  if (scal != nullptr && scal[act_slot] == 0.0f) return;
  __shared__ double sh[REDUCE_THREADS];
  for (int k = 0; k < rows; ++k) {
    const double s = reduce_parts(part + (size_t)k * nb, nb, sh);
    if (threadIdx.x == 0) own[k] = s;
    __syncthreads();
  }
}

// Column k of the gathered (n, 2) sums, added in shard order.
__device__ __forceinline__ double shard_sum(const double* __restrict__ g,
                                            int n, int k) {
  double s = 0.0;
  for (int j = 0; j < n; ++j) s += g[2 * j + k];
  return s;
}

constexpr int INIT = 0, AFTER_A = 1, AFTER_B = 2;

// One thread: the standard-CG scalar update from the gathered sums.
template <int STEP, bool JAC>
__global__ void combine_std_kernel(const double* __restrict__ g, int n,
                                   float* __restrict__ scal, float tol2,
                                   int max_iter) {
  if (STEP != INIT && scal[S_ACT] == 0.0f) return;
  const double a = shard_sum(g, n, 0);
  if (STEP == AFTER_A) {
    scal_a(scal, a);
    return;
  }
  const double rz = JAC ? shard_sum(g, n, 1) : a;
  if (STEP == INIT)
    scal_init(scal, a, 0.0, rz, tol2, max_iter);
  else
    scal_b(scal, a, rz, tol2, max_iter);
}

__global__ void combine_cgs_kernel(const double* __restrict__ g, int n,
                                   float* __restrict__ scal, float tol2,
                                   int max_iter, int first) {
  cgs::update(scal, shard_sum(g, n, 0), shard_sum(g, n, 1), tol2, max_iter,
              first != 0);
}

// r0 = rhs - M x0 into r, the C planes, x = x0, partials <r0, r0> (row 0)
// and, under Jacobi, rz0 = sum r0^2 invd (row 1). F, R0, x0 and invd are
// halo planes (row-0 pointers, he floats apart).
template <bool JAC>
__global__ void __launch_bounds__(MAX_THREADS)
prologue_kernel(const float* __restrict__ F, const float* __restrict__ R0,
                const float* __restrict__ x0, const float* __restrict__ invd,
                float* __restrict__ x, float* __restrict__ r,
                float* __restrict__ C,
                float* __restrict__ part, int h, int w, size_t he, int sf,
                float lam) {
  __shared__ float sh_r[MAX_THREADS];
  __shared__ float sh_z[JAC ? MAX_THREADS : 1];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const int nb = gridDim.x * gridDim.y;
  float rr = 0.0f, rz = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    float c[9];
    build_c<1>(F, he, i, j, h, w, lam, sf, c);
#pragma unroll
    for (int d = 0; d < 9; ++d) C[d * hw + o] = c[d];
    auto X = [&](int a, int q) { return at<1>(x0, a, q, h, w); };
    float mx = stencil(c, X, i, j);
    if (sf == 4) mx += F[F_KTW * he + o] * tile_sum(X, i, j, 4);
    const float rv = rhs_at<1>(F, R0, he, i, j, h, w, lam) - mx;
    x[o] = x0[o];
    r[o] = rv;
    rr = rv * rv;
    if (JAC) rz = rr * invd[o];
  }
  const float sr = block_sum(rr, sh_r);
  const float sz = JAC ? block_sum(rz, sh_z) : 0.0f;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    part[lane_block()] = sr;
    if (JAC) part[nb + lane_block()] = sz;
  }
}

// CGS: w0 = M r0 into the w plane of set 0 and partials of gamma0 = <r0,
// r0> and delta0 = <w0, r0>. rws holds the (r, w, s) halo planes of both
// sets, he floats apart; r0 has its halo rows.
__global__ void __launch_bounds__(MAX_THREADS)
w0_kernel(const float* __restrict__ C, const float* __restrict__ F,
          float* __restrict__ rws, float* __restrict__ part, int h, int w,
          size_t he, int sf) {
  __shared__ float sh_g[MAX_THREADS];
  __shared__ float sh_d[MAX_THREADS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const int nb = gridDim.x * gridDim.y;
  const float* r = rws;
  float g = 0.0f, d = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    float c[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = C[k * hw + o];
    auto R = [&](int a, int q) { return at<1>(r, a, q, h, w); };
    float wv = stencil(c, R, i, j);
    if (sf == 4) wv += F[F_KTW * he + o] * tile_sum(R, i, j, 4);
    rws[he + o] = wv;
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

// Standard-CG sweep A on a shard. r, invd, p_old and p_new are halo planes;
// p_new's halo rows are written from the same expression the neighbour
// shard evaluates for its edge row (explicit roundings: no contraction may
// differ between the two).
template <bool JAC>
__global__ void __launch_bounds__(MAX_THREADS)
sweep_a_kernel(const float* __restrict__ C, const float* __restrict__ F,
               const float* __restrict__ r, const float* __restrict__ invd,
               const float* __restrict__ p_old, float* __restrict__ p_new,
               float* __restrict__ wv, float* __restrict__ part,
               const float* __restrict__ scal, int h, int w, size_t he,
               int sf) {
  if (scal[S_ACT] == 0.0f) return;
  __shared__ float sh[MAX_THREADS];
  const float beta = scal[S_BETA];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  auto P = [&](int a, int q) {
    if (!inside<1>(a, q, h, w)) return 0.0f;
    const ptrdiff_t o = (ptrdiff_t)a * w + q;
    const float z = JAC ? __fmul_rn(invd[o], r[o]) : r[o];
    return __fmaf_rn(beta, p_old[o], z);
  };
  float v = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    float c[9];
#pragma unroll
    for (int d = 0; d < 9; ++d) c[d] = C[d * hw + o];
    const float pc = P(i, j);
    float ws = stencil(c, P, i, j);
    if (sf == 4) ws += F[F_KTW * he + o] * tile_sum(P, i, j, 4);
    p_new[o] = pc;
    if (i == 0) p_new[(ptrdiff_t)j - w] = P(-1, j);
    if (i == h - 1) p_new[hw + j] = P(h, j);
    wv[o] = ws;
    v = pc * ws;
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[lane_block()] = s;
}

// One CGS iteration on a shard (cgs_cg.cu's sweep): reads set `src` of the
// (r, w, s) halo planes, writes the other set's interior rows, x and p, and
// partials of gamma' and delta'.
__global__ void __launch_bounds__(MAX_THREADS)
cgs_sweep_kernel(const float* __restrict__ C, const float* __restrict__ F,
                 float* __restrict__ x, float* __restrict__ p,
                 float* __restrict__ rws, int src, float* __restrict__ part,
                 const float* __restrict__ scal, int h, int w, size_t he,
                 int sf) {
  if (scal[cgs::S_ACT] == 0.0f) return;
  __shared__ float sh_g[MAX_THREADS];
  __shared__ float sh_d[MAX_THREADS];
  const float alpha = scal[cgs::S_ALPHA];
  const float beta = scal[cgs::S_BETA];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const int nb = gridDim.x * gridDim.y;
  const float* r = rws + (size_t)(3 * src) * he;
  const float* wo = r + he;
  const float* so = r + 2 * he;
  float* rn = rws + (size_t)(3 * (1 - src)) * he;
  float* wn = rn + he;
  float* sn = rn + 2 * he;
  auto S = [&](ptrdiff_t q) { return __fmaf_rn(beta, so[q], wo[q]); };
  auto R = [&](int a, int b) {
    if (!inside<1>(a, b, h, w)) return 0.0f;
    const ptrdiff_t q = (ptrdiff_t)a * w + b;
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
    if (sf == 4) wv += F[F_KTW * he + o] * tile_sum(R, i, j, 4);
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

struct Geo {
  dim3 grid, block;
  int nb;
};

Geo geo(int h, int w, int bx, int by) {
  Geo g;
  g.block = dim3(bx, by);
  g.grid = dim3((w + bx - 1) / bx, (h + by - 1) / by, 1);
  g.nb = (int)(g.grid.x * g.grid.y);
  return g;
}

template <int STEP>
int combine_std(const double* g, int n, float* scal, float tol2, int max_iter,
                bool jac, cudaStream_t st) {
  if (jac)
    combine_std_kernel<STEP, true><<<1, 1, 0, st>>>(g, n, scal, tol2,
                                                    max_iter);
  else
    combine_std_kernel<STEP, false><<<1, 1, 0, st>>>(g, n, scal, tol2,
                                                     max_iter);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes, per shard: h x w interior rows; a halo plane is (h + 2) x w and
// is passed as a pointer to its row 0, he = (h + 2) * w floats separating
// the planes of a halo stack. F: 11 halo planes (P11..P33, fwd_x, bwd_x,
// fwd_y, bwd_y, ktw); R0: 4 halo planes (QB1, QB2, QB3, z0t); x0: a halo
// plane; invd: a halo plane or null (jacobi = 0). Outputs, allocated by the
// caller: x (h, w), r (halo plane), C (9, h, w), part (3 * blocks), own (2
// doubles). Every function returns a cudaError_t.
extern "C" int srps_shard_prologue(const void* F, const void* R0,
                                   const void* x0, const void* invd, void* x,
                                   void* r, void* C, void* part, void* own,
                                   int h, int w, int sf, float lam, int bx,
                                   int by, int jacobi, void* stream) {
  if ((jacobi != 0) != (invd != nullptr) || R0 == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Geo g = geo(h, w, bx, by);
  const size_t he = (size_t)(h + 2) * w;
  auto kern = jacobi ? &prologue_kernel<true> : &prologue_kernel<false>;
  kern<<<g.grid, g.block, 0, st>>>(
      (const float*)F, (const float*)R0, (const float*)x0,
      (const float*)invd, (float*)x, (float*)r, (float*)C, (float*)part, h,
      w, he, sf, lam);
  SRPS_CHECK();
  sum_kernel<<<1, REDUCE_THREADS, 0, st>>>((const float*)part, g.nb,
                                           jacobi ? 2 : 1, (double*)own,
                                           nullptr, 0);
  return (int)cudaGetLastError();
}

// CGS after the prologue and an exchange of r0's halo rows: rws (6 halo
// planes: r, w, s of set 0, then of set 1) gets w0.
extern "C" int srps_shard_cgs_w0(const void* C, const void* F, void* rws,
                                 void* part, void* own, int h, int w, int sf,
                                 int bx, int by, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Geo g = geo(h, w, bx, by);
  const size_t he = (size_t)(h + 2) * w;
  w0_kernel<<<g.grid, g.block, 0, st>>>((const float*)C, (const float*)F,
                                        (float*)rws, (float*)part, h, w, he,
                                        sf);
  SRPS_CHECK();
  sum_kernel<<<1, REDUCE_THREADS, 0, st>>>((const float*)part, g.nb, 2,
                                           (double*)own, nullptr, 0);
  return (int)cudaGetLastError();
}

// Iteration k's sweep A: `first` (k = 1) combines the prologue's sums,
// otherwise sweep B's. gathered: (n, 2) doubles; scal: N_SCAL floats.
extern "C" int srps_shard_step_a(const void* gathered, int n, void* scal,
                                 const void* C, const void* F, const void* r,
                                 const void* invd, const void* p_old,
                                 void* p_new, void* wv, void* part, void* own,
                                 int h, int w, int sf, float tol2,
                                 int max_iter, int bx, int by, int jacobi,
                                 int first, void* stream) {
  if ((jacobi != 0) != (invd != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const double* gd = (const double*)gathered;
  float* sc = (float*)scal;
  const int err = first ? combine_std<INIT>(gd, n, sc, tol2, max_iter,
                                            jacobi != 0, st)
                        : combine_std<AFTER_B>(gd, n, sc, tol2, max_iter,
                                               jacobi != 0, st);
  if (err != 0) return err;
  const Geo g = geo(h, w, bx, by);
  const size_t he = (size_t)(h + 2) * w;
  auto kern = jacobi ? &sweep_a_kernel<true> : &sweep_a_kernel<false>;
  kern<<<g.grid, g.block, 0, st>>>(
      (const float*)C, (const float*)F, (const float*)r, (const float*)invd,
      (const float*)p_old, (float*)p_new, (float*)wv, (float*)part, sc, h, w,
      he, sf);
  SRPS_CHECK();
  sum_kernel<<<1, REDUCE_THREADS, 0, st>>>((const float*)part, g.nb, 1,
                                           (double*)own, sc, S_ACT);
  return (int)cudaGetLastError();
}

// Sweep B after the gathered <p, w>. r, p and invd are halo planes.
extern "C" int srps_shard_step_b(const void* gathered, int n, void* scal,
                                 void* x, void* r, const void* p,
                                 const void* wv, const void* invd,
                                 void* part, void* own, int h, int w, int bx,
                                 int by, int jacobi, void* stream) {
  if ((jacobi != 0) != (invd != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* sc = (float*)scal;
  const int err = combine_std<AFTER_A>((const double*)gathered, n, sc, 0.0f,
                                       0, jacobi != 0, st);
  if (err != 0) return err;
  const Geo g = geo(h, w, bx, by);
  auto kern = jacobi ? &sweep_b_kernel<true> : &sweep_b_kernel<false>;
  kern<<<g.grid, g.block, 0, st>>>((float*)x, (float*)r, (const float*)p,
                                   (const float*)wv, (const float*)invd,
                                   (float*)part, sc, h, w);
  SRPS_CHECK();
  sum_kernel<<<1, REDUCE_THREADS, 0, st>>>((const float*)part, g.nb,
                                           jacobi ? 2 : 1, (double*)own, sc,
                                           S_ACT);
  return (int)cudaGetLastError();
}

// The combine after the last sweep B: iters and rr are then final.
extern "C" int srps_shard_finish(const void* gathered, int n, void* scal,
                                 float tol2, int max_iter, int jacobi,
                                 void* stream) {
  return combine_std<AFTER_B>((const double*)gathered, n, (float*)scal, tol2,
                              max_iter, jacobi != 0, (cudaStream_t)stream);
}

// One CGS iteration: the combine of the gathered (gamma, delta) (`first`
// after w0), then the sweep from set `src` (x, p: (h, w); rws as in
// srps_shard_cgs_w0; scal: cgs::N_SCAL floats).
extern "C" int srps_shard_cgs_step(const void* gathered, int n, void* scal,
                                   const void* C, const void* F, void* x,
                                   void* p, void* rws, int src, void* part,
                                   void* own, int h, int w, int sf,
                                   float tol2, int max_iter, int bx, int by,
                                   int first, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* sc = (float*)scal;
  combine_cgs_kernel<<<1, 1, 0, st>>>((const double*)gathered, n, sc, tol2,
                                      max_iter, first);
  SRPS_CHECK();
  const Geo g = geo(h, w, bx, by);
  const size_t he = (size_t)(h + 2) * w;
  cgs_sweep_kernel<<<g.grid, g.block, 0, st>>>(
      (const float*)C, (const float*)F, (float*)x, (float*)p, (float*)rws,
      src, (float*)part, sc, h, w, he, sf);
  SRPS_CHECK();
  sum_kernel<<<1, REDUCE_THREADS, 0, st>>>((const float*)part, g.nb, 2,
                                           (double*)own, sc, cgs::S_ACT);
  return (int)cudaGetLastError();
}

extern "C" int srps_shard_cgs_finish(const void* gathered, int n, void* scal,
                                     float tol2, int max_iter, void* stream) {
  combine_cgs_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)gathered, n, (float*)scal, tol2, max_iter, 0);
  return (int)cudaGetLastError();
}
