// Row-shard depth CG of SRmeetsPS as hand-written CUDA kernels for Hopper
// (sm_90a): a solve split into N row bands, in two routes.
//
// Replaces the TPU kernels of srmeetsps_cuda_tpu/parallel/shard_pallas.py:
//   _prologue_kernel   (:124)  -> shard_std_kernel / shard_cgs_kernel's
//                                 prologue; per step: prologue_kernel (+
//                                 w0_kernel for CGS)
//   _cgs_sweep_kernel  (:249)  -> shard_cgs_kernel; cgs_sweep_kernel
//   _std_kernel_a      (:375)  -> shard_std_kernel's phase A; sweep_a_kernel
//   _std_kernel_b      (:440)  -> shard_std_kernel<false>'s phase B;
//                                 sweep_b_kernel<false> (std_cg.cuh)
//   _std_kernel_b_jac  (:495)  -> shard_std_kernel<true>'s phase B;
//                                 sweep_b_kernel<true> (std_cg.cuh)
// The TPU kernels walk a shard in bands inside an 8-row ring padded to 128
// lanes, with a tail band that overlaps its predecessor; here a shard's h =
// H / N rows are a multiple of sf, so that sf x sf tiles never cross a
// shard and a shard's first row has an even global index (build_c's sf = 2
// phase fold holds as on the whole grid).
//
// Halo layout. Every plane a kernel reads at a neighbouring row is an
// (h + 2, w) plane: rows -1 and h hold the neighbour shards' edge rows, or
// zeros at the global top and bottom, and the kernels address it from row
// 0 with HALO = 1 (stencil_common.cuh). F (11 planes, for the C planes'
// A^T A part at i +- 1), R0 (QB2 at i +- 1 in rhs), x0 (M x0) and, under
// Jacobi, invd get theirs once per solve from the caller. Per iteration:
//   - standard CG and Jacobi: r's halo rows. Phase (sweep) A recomputes p
//     = z + beta p_old on the two halo rows from the exchanged r and its
//     own p_old halo (which it wrote the iteration before by the same
//     arithmetic), and writes them: p needs no exchange of its own, where
//     the TPU path exchanges both p and r (shard_pallas.py:942, 947);
//   - CGS: the halo rows of the (r, w, s) set a sweep writes; the sweep
//     recomputes r' on the halo rows as cgs_cg.cu does at a tile's edge.
//
// The persistent route (every shard on one device; srps_shard_std,
// srps_shard_cgs): one cooperative launch per CG solve over every shard,
// built on persistent.cuh. Shard l is lane l of the tile plan (tiles of
// (h, w, block), so a shard's partial sums come from the same threads in
// the same order whatever G is), its planes one (N, ...) stack each. The
// tile that writes a shard's first or last row of r (of r, w, s in CGS)
// also writes it into the adjacent shard's halo row, and the grid barrier
// that follows the phase publishes it: the halo exchange costs no pass and
// no launch. After each barrier every CTA sums each shard's per-tile
// partials in double (persist::lane_sums), adds the N shard sums in shard
// order, and applies scal_* (std_cg.cuh) or cgs::update to its own copy of
// the one scalar set every shard shares: the all_reduce and the combine
// step without their launches; every CTA holds the same bits, and a
// repeated solve repeats exactly. Two barriers per iteration (CGS: one), a
// stopped solve leaves the loop in every CTA at the same iteration, and
// CTA 0 writes the scalars into every shard's slot at the end. Device
// memory layout only (x, w, p make the round trip, staged with the tile).
//
// The per-step route (shards on distinct devices; srps_shard_prologue ...
// srps_shard_cgs_finish), one launch per shard and step on the caller's
// stream, the caller exchanging halo rows and gathering sums in between:
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
// Each launch writes per-block partials; sum_kernel adds a shard's partials
// in a fixed order in double into `own`; the caller copies every shard's
// `own` into each shard's `gathered` (N x 2 doubles, shard order), and the
// combine step at the start of the next launch adds them in shard order.
// A stopped solve's launches return at their first read of `active`.
//
// Bound: memory bandwidth by the bytes, instruction issue on the H100 as
// the unsharded persistent kernels (PERF.md): per iteration and pixel the
// standard CG moves 19 f32 planes in device memory (9 C, r, p_old, p, w; x,
// p, r, w read and x, r written), 21 under Jacobi, the CGS 19, sf = 4 ktw
// + 1, against about 27-30 flops. The persistent route adds per iteration 2
// halo rows per shard of each exchanged plane and N lane sums per barrier
// in every CTA; the per-step route two launches of one-block sums per shard
// and step, a combine of N doubles per launch and the host's copies.

#include "cgs_common.cuh"
#include "persistent.cuh"
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

// ---------------------------------------------------------------------------
// The persistent route: one cooperative launch per CG solve over every
// shard of a one-device mesh.
// ---------------------------------------------------------------------------

namespace {
namespace mesh {

using persist::Geo;
using persist::Tile;
using persist::tile_of;

constexpr int SW = persist::SCAL_WORDS;
// Planes per shard of the halo stacks (F, R0: F_ROWS, R_ROWS), p's
// ping-pong pair and CGS's (r, w, s) sets.
constexpr int P_PAIR = 2, RWS = 6;

// Plane k of shard l of a halo stack of `planes` planes per shard, at its
// row 0 (he floats a plane).
template <class T>
__device__ __forceinline__ T* row0(T* base, size_t he, int w, int planes,
                                   int l, int k) {
  return base + ((size_t)l * planes + k) * he + w;
}

// Pixel (i, j) of shard l's plane k into the adjacent shard's halo row,
// where row i is the shard's first or last row (none at the global top
// and bottom, whose halo rows stay zero).
__device__ __forceinline__ void share(float* base, size_t he, const Geo& g,
                                      int planes, int k, int l, int i, int j,
                                      float v) {
  if (i == 0 && l > 0)
    row0(base, he, g.w, planes, l - 1, k)[(size_t)g.h * g.w + j] = v;
  if (i == g.h - 1 && l < g.B - 1)
    row0(base, he, g.w, planes, l + 1, k)[j - g.w] = v;
}

// The sums over the mesh of ND rows of per-tile partials (row r at part +
// r * stride, shard l's tiles at l * tiles): each shard's tiles in double
// (persist::lane_sums), then the N shard sums added in shard order, as
// the per-step route's all_reduce and combine add them. Every CTA gets the
// same bits. Valid in thread 0; all threads must call it.
template <int ND, class SH>
__device__ void mesh_sums(const SH& s, const float* part, size_t stride,
                          const int (&rows)[ND], double* dred,
                          double (&out)[ND]) {
#pragma unroll
  for (int d = 0; d < ND; ++d) out[d] = 0.0;
  for (int l = 0; l < s.g.B; ++l) {
    double v[ND];
    persist::lane_sums<ND>(s, part, stride, rows, l, s.g.tiles, dred, v);
#pragma unroll
    for (int d = 0; d < ND; ++d) out[d] += v[d];
  }
}

// r0 = rhs - M x0 at pixel (i, j) of a shard, the C planes written. F, R0
// and x0 are halo planes (row-0 pointers, he floats apart); C (9, h, w).
// Kept out of line, so that its registers do not crowd the CG loop's.
__device__ __noinline__ float r0_pixel(const float* __restrict__ F,
                                       const float* __restrict__ R0,
                                       const float* __restrict__ x0, float* C,
                                       size_t hw, size_t he, int i, int j,
                                       int h, int w, int sf, float lam) {
  const size_t o = (size_t)i * w + j;
  float c[9];
  build_c<1>(F, he, i, j, h, w, lam, sf, c);
#pragma unroll
  for (int d = 0; d < 9; ++d) C[d * hw + o] = c[d];
  auto X = [&](int a, int b) { return at<1>(x0, a, b, h, w); };
  float mx = stencil(c, X, i, j);
  if (sf == 4) mx += F[F_KTW * he + o] * tile_sum(X, i, j, 4);
  return rhs_at<1>(F, R0, he, i, j, h, w, lam) - mx;
}

// ---- Standard CG and in-sweep Jacobi PCG ----

// Rows of per-tile partials: phase A's <p, w>; phase B's (and the
// prologue's) <r, r> and rz. A row is written again only after a barrier
// that follows every CTA's reads of it.
constexpr int P_PW = 0, P_RR = 1, P_RZ = 2;
// Planes a tile stages: phase A r and p_old (Jacobi invd) with the halo,
// then the 9 C planes (sf = 4: and ktw) alone; phase B p, r (Jacobi invd),
// x and w alone.
template <bool JAC>
constexpr int NH_A = JAC ? 3 : 2;
constexpr int NI_A = N_STENCIL + 1;
template <bool JAC>
constexpr int NI_B = 4 + (JAC ? 1 : 0);

template <bool JAC>
__host__ __device__ int std_stage_floats(const Geo& g) {
  const int a = NH_A<JAC> * g.sp() + NI_A * g.tile_px();
  const int b = NI_B<JAC> * g.tile_px();
  return a > b ? a : b;
}

struct StdParams {
  const float* F;     // (N, 11, h + 2, w)
  const float* R0;    // (N, 4, h + 2, w)
  const float* x0;    // (N, h + 2, w)
  const float* invd;  // (N, h + 2, w) or null
  float* x;           // (N, h, w)
  float* r;           // (N, h + 2, w)
  float* p;           // (N, 2, h + 2, w)
  float* wv;          // (N, h, w)
  float* C;           // (N, 9, h, w)
  float* part;        // 3 rows of N x tiles
  float* scal;        // (N, N_SCAL)
  int sf;
  float lam, tol2;
  int max_iter;
  Geo g;  // B = N shards of h rows
};

template <bool JAC, int BX, int BY>
__global__ void __launch_bounds__(MAX_THREADS)
shard_std_kernel(const StdParams P) {
  namespace cg = cooperative_groups;
  constexpr int NH = NH_A<JAC>;
  constexpr int NB = NI_B<JAC>;
  extern __shared__ __align__(16) unsigned char raw[];
  const Geo& g = P.g;
  const persist::Shape<BX, BY> sh(g);
  const int buf = std_stage_floats<JAC>(g);
  const persist::Smem S = persist::carve(raw, g, buf);
  cg::grid_group grid = cg::this_grid();
  const size_t hw = (size_t)g.h * g.w;
  const size_t he = hw + 2 * (size_t)g.w;
  const size_t stride = (size_t)g.B * g.tiles;
  const int n = g.count();
  const int t0 = persist::tid();
  const int sp = sh.sp(), sw = sh.sw(), tpx = sh.tpx();
  float* sc = S.scal;  // the scalars every shard shares
  auto put = [&](int row, const Tile& tl, float v) {
    if (t0 == 0) P.part[row * stride + (size_t)tl.lane * g.tiles + tl.t] = v;
  };
  auto all = [](int) { return true; };
  int par = 0;

  // Prologue: the C planes, x = x0, r0 (its edge rows into the adjacent
  // shards' halo rows), p_old = 0 with its halo rows, and per-tile
  // partials of <r0, r0> (Jacobi: and rz0).
  for (int k = 0; k < n; ++k) {
    const Tile tl = tile_of(g, k);
    const int L = tl.lane;
    const float* invd = JAC ? row0(P.invd, he, g.w, 1, L, 0) : nullptr;
    float* r = row0(P.r, he, g.w, 1, L, 0);
    float* p0 = row0(P.p, he, g.w, P_PAIR, L, 0);
    float v[2] = {0.0f, 0.0f};
    persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
      const int o = i * g.w + j;
      const float* x0 = row0(P.x0, he, g.w, 1, L, 0);
      const float rv = r0_pixel(row0(P.F, he, g.w, F_ROWS, L, 0),
                                row0(P.R0, he, g.w, R_ROWS, L, 0), x0,
                                P.C + (size_t)L * N_STENCIL * hw, hw, he, i,
                                j, g.h, g.w, P.sf, P.lam);
      P.x[L * hw + o] = x0[o];
      r[o] = rv;
      share(P.r, he, g, 1, 0, L, i, j, rv);
      p0[o] = 0.0f;
      if (i == 0) p0[o - g.w] = 0.0f;
      if (i == g.h - 1) p0[o + g.w] = 0.0f;
      const float q = __fmul_rn(rv, rv);
      v[0] = __fadd_rn(v[0], q);
      if (JAC) v[1] = __fadd_rn(v[1], __fmul_rn(q, invd[o]));
    });
    persist::cta_sum(sh, v, S.red, par);
    par ^= 1;
    put(P_RR, tl, v[0]);
    if (JAC) put(P_RZ, tl, v[1]);
  }
  grid.sync();
  if constexpr (JAC) {
    double s[2];
    mesh_sums<2>(sh, P.part, stride, {P_RR, P_RZ}, S.dred, s);
    if (t0 == 0) scal_init(sc, s[0], 0.0, s[1], P.tol2, P.max_iter);
  } else {
    double s[1];
    mesh_sums<1>(sh, P.part, stride, {P_RR}, S.dred, s);
    if (t0 == 0) scal_init(sc, s[0], 0.0, s[0], P.tol2, P.max_iter);
  }
  __syncthreads();

  // Phase A stages ktw only at sf = 4.
  const int ni_a = N_STENCIL + (P.sf == 4 ? 1 : 0);
  for (int it = 1; it <= P.max_iter + 1; ++it) {
    if (sc[S_ACT] == 0.0f) break;
    // Iteration it reads p_old = p[(it + 1) % 2] and writes p[it % 2].
    const int po = (it + 1) % 2, pn = it % 2;

    // Phase A: p = z + beta p_old on the tile and its halo, w = M p, <p,
    // w>; p written on the tile and, at a shard's edge, on its halo row.
    auto src_a = [&](int k, int l) -> const float* {
      if (k == 0) return row0(P.r, he, g.w, 1, l, 0);
      if (k == 1) return row0(P.p, he, g.w, P_PAIR, l, po);
      if (k < NH) return row0(P.invd, he, g.w, 1, l, 0);
      if (k < NH + N_STENCIL)
        return P.C + ((size_t)l * N_STENCIL + (k - NH)) * hw;
      return row0(P.F, he, g.w, F_ROWS, l, F_KTW);
    };
    persist::staged_tiles<NH, NI_A, 1>(sh, S.stage, buf, ni_a, src_a, all,
                                       [&](const Tile& tl, float* b,
                                           int bpar) {
      const float beta = sc[S_BETA];
      const float* rb = b;
      float* pb = b + sp;
      const float* ib = b + 2 * sp;  // Jacobi
      const float* cb = b + NH * sp;  // C planes, then ktw
      // The arithmetic of shard_kernels.step_a_plain (two roundings), the
      // same on the halo rows as in the shard that owns them.
      persist::staged(sh, [&](int q) {
        const float z = JAC ? __fmul_rn(ib[q], rb[q]) : rb[q];
        pb[q] = __fadd_rn(z, __fmul_rn(beta, pb[q]));
      });
      __syncthreads();
      const size_t L = tl.lane;
      float* pl = row0(P.p, he, g.w, P_PAIR, tl.lane, pn);
      float* wl = P.wv + L * hw;
      float v[1] = {0.0f};
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        const int o = i * g.w + j, e = py * sh.tw() + px;
        float c[9];
#pragma unroll
        for (int d = 0; d < 9; ++d) c[d] = cb[d * tpx + e];
        const int q = sh.sq(py, px);
        const float pc = pb[q];
        float ws = persist::stencil_staged(c, pb + q, sw);
        if (P.sf == 4)
          ws = __fmaf_rn(cb[N_STENCIL * tpx + e],
                         persist::tile_sum4_staged(pb, sw, py, px), ws);
        pl[o] = pc;
        if (i == 0) pl[o - g.w] = pb[q - sw];
        if (i == g.h - 1) pl[o + g.w] = pb[q + sw];
        wl[o] = ws;
        v[0] = __fadd_rn(v[0], __fmul_rn(pc, ws));
      });
      persist::cta_sum(sh, v, S.red, bpar);
      put(P_PW, tl, v[0]);
    });
    grid.sync();
    {
      double s[1];
      mesh_sums<1>(sh, P.part, stride, {P_PW}, S.dred, s);
      if (t0 == 0) scal_a(sc, s[0]);
    }
    __syncthreads();

    // Phase B: x += alpha p, r -= alpha w (r's edge rows into the adjacent
    // shards' halo rows), <r, r> (and rz).
    auto src_b = [&](int k, int l) -> const float* {
      const size_t L = l;
      if (k == 0) return row0(P.p, he, g.w, P_PAIR, l, pn);
      if (k == 1) return row0(P.r, he, g.w, 1, l, 0);
      if (JAC && k == 2) return row0(P.invd, he, g.w, 1, l, 0);
      return (k == NB - 2 ? P.x : P.wv) + L * hw;
    };
    persist::staged_tiles<0, NB>(sh, S.stage, buf, NB, src_b, all,
                                 [&](const Tile& tl, float* b, int bpar) {
      const float alpha = sc[S_ALPHA];
      const size_t L = tl.lane;
      const float* bp = b;
      const float* br = b + tpx;
      const float* bi = b + 2 * tpx;  // Jacobi
      const float* bx = b + (NB - 2) * tpx;
      const float* bw = bx + tpx;
      float* xl = P.x + L * hw;
      float* rl = row0(P.r, he, g.w, 1, tl.lane, 0);
      float v[2] = {0.0f, 0.0f};
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        const int o = i * g.w + j, e = py * sh.tw() + px;
        xl[o] = __fmaf_rn(alpha, bp[e], bx[e]);
        const float rn = __fmaf_rn(-alpha, bw[e], br[e]);
        rl[o] = rn;
        share(P.r, he, g, 1, 0, tl.lane, i, j, rn);
        const float q = __fmul_rn(rn, rn);
        v[0] = __fadd_rn(v[0], q);
        if (JAC) v[1] = __fadd_rn(v[1], __fmul_rn(q, bi[e]));
      });
      persist::cta_sum(sh, v, S.red, bpar);
      put(P_RR, tl, v[0]);
      if (JAC) put(P_RZ, tl, v[1]);
    });
    grid.sync();
    if constexpr (JAC) {
      double s[2];
      mesh_sums<2>(sh, P.part, stride, {P_RR, P_RZ}, S.dred, s);
      if (t0 == 0) scal_b(sc, s[0], s[1], P.tol2, P.max_iter);
    } else {
      double s[1];
      mesh_sums<1>(sh, P.part, stride, {P_RR}, S.dred, s);
      if (t0 == 0) scal_b(sc, s[0], s[0], P.tol2, P.max_iter);
    }
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (int q = t0; q < g.B * N_SCAL; q += blockDim.x * blockDim.y)
      P.scal[q] = sc[q % N_SCAL];
}

// ---- Chronopoulos-Gear CG ----

// Planes a sweep stages: r, w, s of the set read, with the halo; then the
// 9 C planes, x, p and (sf = 4) ktw alone.
constexpr int NH_C = 3;
constexpr int NI_C = N_STENCIL + 3;

__host__ __device__ inline int cgs_stage_floats(const Geo& g) {
  return NH_C * g.sp() + NI_C * g.tile_px();
}

struct CgsParams {
  const float* F;   // (N, 11, h + 2, w)
  const float* R0;  // (N, 4, h + 2, w)
  const float* x0;  // (N, h + 2, w)
  float* x;         // (N, h, w)
  float* p;         // (N, h, w)
  float* rws;       // (N, 6, h + 2, w): r, w, s of set 0, then of set 1
  float* C;         // (N, 9, h, w)
  float* part;      // 4 rows of N x tiles
  float* scal;      // (N, cgs::N_SCAL)
  int sf;
  float lam, tol2;
  int max_iter;
  Geo g;
};

template <int BX, int BY>
__global__ void __launch_bounds__(MAX_THREADS)
shard_cgs_kernel(const CgsParams P) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char raw[];
  const Geo& g = P.g;
  const persist::Shape<BX, BY> sh(g);
  const int buf = cgs_stage_floats(g);
  const persist::Smem S = persist::carve(raw, g, buf);
  cg::grid_group grid = cg::this_grid();
  const size_t hw = (size_t)g.h * g.w;
  const size_t he = hw + 2 * (size_t)g.w;
  const size_t stride = (size_t)g.B * g.tiles;
  const int n = g.count();
  const int t0 = persist::tid();
  const int sw = sh.sw(), tpx = sh.tpx();
  float* sc = S.scal;
  auto put = [&](int row, const Tile& tl, float v) {
    if (t0 == 0) P.part[row * stride + (size_t)tl.lane * g.tiles + tl.t] = v;
  };
  auto all = [](int) { return true; };
  int par = 0;

  // Prologue: C, x = x0, p = 0, r0 and s0 = 0 (set 0), their edge rows
  // into the adjacent shards' halo rows.
  for (int k = 0; k < n; ++k) {
    const Tile tl = tile_of(g, k);
    const int L = tl.lane;
    float* r = row0(P.rws, he, g.w, RWS, L, 0);
    float* s = row0(P.rws, he, g.w, RWS, L, 2);
    persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
      const int o = i * g.w + j;
      const float* x0 = row0(P.x0, he, g.w, 1, L, 0);
      const float rv = r0_pixel(row0(P.F, he, g.w, F_ROWS, L, 0),
                                row0(P.R0, he, g.w, R_ROWS, L, 0), x0,
                                P.C + (size_t)L * N_STENCIL * hw, hw, he, i,
                                j, g.h, g.w, P.sf, P.lam);
      P.x[L * hw + o] = x0[o];
      P.p[L * hw + o] = 0.0f;
      r[o] = rv;
      s[o] = 0.0f;
      share(P.rws, he, g, RWS, 0, L, i, j, rv);
      share(P.rws, he, g, RWS, 2, L, i, j, 0.0f);
    });
  }
  grid.sync();
  // w0 = M r0 (set 0; r0's halo rows written before the barrier) and the
  // partials of gamma0, delta0 (rows 0, 1).
  for (int k = 0; k < n; ++k) {
    const Tile tl = tile_of(g, k);
    const int L = tl.lane;
    const float* C = P.C + (size_t)L * N_STENCIL * hw;
    const float* ktw = row0(P.F, he, g.w, F_ROWS, L, F_KTW);
    const float* r = row0(P.rws, he, g.w, RWS, L, 0);
    float* wp = row0(P.rws, he, g.w, RWS, L, 1);
    float v[2] = {0.0f, 0.0f};
    persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
      const int o = i * g.w + j;
      float c[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) c[d] = C[d * hw + o];
      // r0 of other CTAs' tiles and shards: read through L2.
      auto R = [&](int a, int b) {
        return inside<1>(a, b, g.h, g.w) ? __ldcg(r + a * g.w + b) : 0.0f;
      };
      float wv = stencil(c, R, i, j);
      if (P.sf == 4) wv += __ldg(ktw + o) * tile_sum(R, i, j, 4);
      wp[o] = wv;
      share(P.rws, he, g, RWS, 1, L, i, j, wv);
      const float rv = r[o];
      v[0] = __fadd_rn(v[0], __fmul_rn(rv, rv));
      v[1] = __fadd_rn(v[1], __fmul_rn(wv, rv));
    });
    persist::cta_sum(sh, v, S.red, par);
    par ^= 1;
    put(0, tl, v[0]);
    put(1, tl, v[1]);
  }
  grid.sync();
  {
    double s[2];
    mesh_sums<2>(sh, P.part, stride, {0, 1}, S.dred, s);
    if (t0 == 0) cgs::update(sc, s[0], s[1], P.tol2, P.max_iter, true);
  }
  __syncthreads();

  const int ni = NI_C - (P.sf == 4 ? 0 : 1);
  for (int it = 1; it <= P.max_iter + 1; ++it) {
    if (sc[cgs::S_ACT] == 0.0f) break;
    // Sweep `it` reads set (it + 1) % 2 and writes set it % 2 (set 0
    // holds r0); its partials go to rows 2 (it % 2) and 2 (it % 2) + 1.
    const int src = (it + 1) % 2, dst = 3 * (it % 2);
    const int row = 2 * (it % 2);
    auto from = [&](int k, int l) -> const float* {
      const size_t L = l;
      if (k < NH_C) return row0(P.rws, he, g.w, RWS, l, 3 * src + k);
      k -= NH_C;
      if (k < N_STENCIL) return P.C + (L * N_STENCIL + k) * hw;
      k -= N_STENCIL;
      if (k < 2) return (k == 0 ? P.x : P.p) + L * hw;
      return row0(P.F, he, g.w, F_ROWS, l, F_KTW);
    };
    persist::staged_tiles<NH_C, NI_C, 1>(sh, S.stage, buf, ni, from, all,
                                         [&](const Tile& tl, float* b,
                                             int bpar) {
      const float alpha = sc[cgs::S_ALPHA], beta = sc[cgs::S_BETA];
      const float* rb = b;            // r
      float* wb = b + sh.sp();        // w, then r'
      float* sb = b + 2 * sh.sp();    // s, then s'
      const float* cb = b + NH_C * sh.sp();  // C, x, p, ktw
      const float* bx = cb + N_STENCIL * tpx;
      const float* bp = bx + tpx;
      const float* bk = bp + tpx;  // ktw at sf = 4
      persist::staged(sh, [&](int q) {
        const float sn = __fmaf_rn(beta, sb[q], wb[q]);
        wb[q] = __fmaf_rn(-alpha, sn, rb[q]);
        sb[q] = sn;
      });
      __syncthreads();
      const int L = tl.lane;
      float* rn = row0(P.rws, he, g.w, RWS, L, dst);
      float* xl = P.x + (size_t)L * hw;
      float* pl = P.p + (size_t)L * hw;
      float v[2] = {0.0f, 0.0f};
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        const int o = i * g.w + j, e = py * sh.tw() + px;
        float c[9];
#pragma unroll
        for (int d = 0; d < 9; ++d) c[d] = cb[d * tpx + e];
        const int q = sh.sq(py, px);
        const float pv = __fmaf_rn(beta, bp[e], rb[q]);
        pl[o] = pv;
        xl[o] = __fmaf_rn(alpha, pv, bx[e]);
        const float rv = wb[q];
        float wv = persist::stencil_staged(c, wb + q, sw);
        if (P.sf == 4)
          wv = __fmaf_rn(bk[e], persist::tile_sum4_staged(wb, sw, py, px),
                         wv);
        const float sv = sb[q];
        rn[o] = rv;
        rn[he + o] = wv;
        rn[2 * he + o] = sv;
        share(P.rws, he, g, RWS, dst, L, i, j, rv);
        share(P.rws, he, g, RWS, dst + 1, L, i, j, wv);
        share(P.rws, he, g, RWS, dst + 2, L, i, j, sv);
        v[0] = __fadd_rn(v[0], __fmul_rn(rv, rv));
        v[1] = __fadd_rn(v[1], __fmul_rn(wv, rv));
      });
      persist::cta_sum(sh, v, S.red, bpar);
      put(row, tl, v[0]);
      put(row + 1, tl, v[1]);
    });
    grid.sync();
    {
      double s[2];
      mesh_sums<2>(sh, P.part, stride, {row, row + 1}, S.dred, s);
      if (t0 == 0)
        cgs::update(sc, s[0], s[1], P.tol2, P.max_iter, false);
    }
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (int q = t0; q < g.B * cgs::N_SCAL; q += blockDim.x * blockDim.y)
      P.scal[q] = sc[q % cgs::N_SCAL];
}

// The kernel instance of a block: the two standard blocks get the tile
// shape at compile time; any other block reads it at run time.
template <bool JAC>
auto std_instance(const Geo& g) -> void (*)(StdParams) {
  if (g.bx == 256 && g.by == 4) return shard_std_kernel<JAC, 256, 4>;
  if (g.bx == 32 && g.by == 16) return shard_std_kernel<JAC, 32, 16>;
  return shard_std_kernel<JAC, 0, 0>;
}

inline auto cgs_instance(const Geo& g) -> void (*)(CgsParams) {
  if (g.bx == 256 && g.by == 4) return shard_cgs_kernel<256, 4>;
  if (g.bx == 32 && g.by == 16) return shard_cgs_kernel<32, 16>;
  return shard_cgs_kernel<0, 0>;
}

bool bad_block(int n, int bx, int by) {
  return n < 1 || bx <= 0 || by <= 0 || bx * by > MAX_THREADS;
}

}  // namespace mesh
}  // namespace

// One standard (jacobi = 0) or in-sweep Jacobi PCG (jacobi = 1) solve over
// the n row shards of one device on `stream`, in one cooperative launch of
// CTAs of bx x by threads, as many as persist::launch chooses, in device
// memory. Stacks of the n shards' planes, passed by their first float:
// halo stacks F (n, 11, h + 2, w), R0 (n, 4, h + 2, w), x0 and invd (n, h +
// 2, w; invd null with jacobi = 0) in, their halo rows filled by the
// caller, zeros at the global top and bottom; r (n, h + 2, w) and p (n, 2,
// h + 2, w), zeros at the global top and bottom; x, wv (n, h, w), C (n, 9,
// h, w), part (3 x n x tiles of the tile plan of (h, w, block)) and scal
// (n x N_SCAL, every shard's slot written with the same scalars) out.
// info as srps_stencil_cg's. Returns a cudaError_t;
// cudaErrorCooperativeLaunchTooLarge where the CTAs cannot all be resident.
extern "C" int srps_shard_std(const void* F, const void* R0, const void* x0,
                              const void* invd, void* x, void* r, void* p,
                              void* wv, void* C, void* part, void* scal,
                              int n, int h, int w, int sf, float lam,
                              float tol2, int max_iter, int bx, int by,
                              int jacobi, int* info, void* stream) {
  if ((jacobi != 0) != (invd != nullptr) || mesh::bad_block(n, bx, by))
    return (int)cudaErrorInvalidValue;
  mesh::StdParams prm{(const float*)F, (const float*)R0, (const float*)x0,
                      (const float*)invd, (float*)x, (float*)r, (float*)p,
                      (float*)wv, (float*)C, (float*)part, (float*)scal,
                      sf, lam, tol2, max_iter,
                      persist::make_geo(n, h, w, bx, by)};
  prm.g.vec = persist::aligned16(w, {F, R0, x0, invd, x, r, p, wv, C});
  cudaStream_t st = (cudaStream_t)stream;
  if (jacobi) {
    auto k = mesh::std_instance<true>(prm.g);
    const int buf = mesh::std_stage_floats<true>(prm.g);
    return persist::launch(k, k, prm.g, buf, buf, 0, 0, &prm, st, info);
  }
  auto k = mesh::std_instance<false>(prm.g);
  const int buf = mesh::std_stage_floats<false>(prm.g);
  return persist::launch(k, k, prm.g, buf, buf, 0, 0, &prm, st, info);
}

// One Chronopoulos-Gear solve over the n row shards of one device, as
// srps_shard_std: F, R0, x0 as there; x, p (n, h, w); rws (n, 6, h + 2, w),
// zeros at the global top and bottom; C (n, 9, h, w); part (4 x n x
// tiles); scal (n x cgs::N_SCAL).
extern "C" int srps_shard_cgs(const void* F, const void* R0, const void* x0,
                              void* x, void* p, void* rws, void* C,
                              void* part, void* scal, int n, int h, int w,
                              int sf, float lam, float tol2, int max_iter,
                              int bx, int by, int* info, void* stream) {
  if (mesh::bad_block(n, bx, by)) return (int)cudaErrorInvalidValue;
  mesh::CgsParams prm{(const float*)F, (const float*)R0, (const float*)x0,
                      (float*)x, (float*)p, (float*)rws, (float*)C,
                      (float*)part, (float*)scal, sf, lam, tol2, max_iter,
                      persist::make_geo(n, h, w, bx, by)};
  prm.g.vec = persist::aligned16(w, {F, R0, x0, x, p, rws, C});
  auto k = mesh::cgs_instance(prm.g);
  return persist::launch(k, k, prm.g, mesh::cgs_stage_floats(prm.g),
                         mesh::cgs_stage_floats(prm.g), 0, 0, &prm,
                         (cudaStream_t)stream, info);
}
