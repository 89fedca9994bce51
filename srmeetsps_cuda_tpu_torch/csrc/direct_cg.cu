// Depth CG of SRmeetsPS through the direct mask-gated matvec, as
// hand-written CUDA kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of the direct family, one computation that the
// JAX package places six ways in TPU memory:
//   srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py:961 _kernel_vmem (modes
//     "full" and "full_packed", tracked energy) and :1148
//     _kernel_vmem_hybrid, through cg_pallas_vmem_fromop[_batched];
//   solve/pallas_cg_pipe.py:80 _kernel, through cg_pallas_pipelined[_fromop]
//     [_batched] (residual given or built in the kernel, in-sweep Jacobi);
//   solve/pallas_cg_fused.py:50 _kernel, through cg_pallas_fused;
//   solve/pallas_cg.py:163 _cg_kernel_a and :237 _cg_kernel_b, the
//     two-call form, through cg_pallas.
// Each lane solves M x = rhs from the warm start x0 with M applied as the
// TPU kernels apply it (_matvec_band, pallas_cg_vmem.py:185):
//   g = Dx v, h = Dy v (masked two-point differences),
//   t1 = P11 g + P12 h - P13 v, t2 = P12 g + P22 h - P23 v,
//   t3 = P13 g + P23 h - P33 v,
//   M v = ktw * tilesum(v) + lam (Dx^T t1 + Dy^T t2 - t3),
// where Dx^T t1 = fwd_x t1 [j-1] - fwd_x t1 + bwd_x t1 - bwd_x t1 [j+1]
// (and Dy^T alike over rows). So M v at (i, j) reads v at (i, j+-1),
// (i, j+-2), (i+-1, j), (i+-2, j) and (i+-1, j+-1): a 2-pixel halo. The
// stencil kernel (stencil_cg.cu) collapses the same M into 9 planes; in f32
// the two round differently.
//
// None of the TPU machinery comes across (8-row ring, 128-lane padding,
// packed mask bitfield, band double-buffering, residency modes): the planes
// are the unpadded (h, w) row-major images of stencil_common.cuh with
// guarded neighbour reads, and the lane is the grid's z dimension.
//
// Modes:
//   r0 in the kernel (R0 given, b null): r0 = rhs - M x0 from QB1..3 and
//     KT^T z0s, with partials of <r0, r0>, rz and, with `energy`, of the
//     warm-start energy in residual form (_e0_band), updated per iteration
//     by E -= alpha r1 (pallas_cg_vmem.py:1115-1118);
//   residual given (b given, R0 null): r0 = b, partials of <r0, r0> and rz;
//     no energy (the caller evaluates it at the result);
//   invd given: the in-sweep Jacobi PCG of pallas_cg_pipe.py:455-461:
//     p = invd r + beta p, rz = sum r^2 invd drives alpha, beta and the
//     energy, <r, r> the stop test and the reported residual. The direct
//     family has no scaled form.
//
// Kernels (all launched by srps_direct_cg on the caller's stream):
//   prologue    x = x0, r = r0, p0 = 0 and the partials above;
//   sweep_a     p = z + beta p_old (z = r, or invd r) into the other buffer
//               of a ping-pong pair, staged with its 2-pixel halo in shared
//               memory (a point outside the staged tile is recomputed from
//               r and p_old), w = M p and per-block partials of <p, w>;
//   reduce_a, sweep_b, reduce_b, reduce_init (std_cg.cuh): alpha and E,
//               x += alpha p and r -= alpha w with partials of <r, r> (and
//               rz), then beta and the stop test rr <= tol^2 or k >
//               max_iter.
// The host launches max_iter + 1 iterations and never reads a scalar; the
// reference's quirks hold: cap 100 runs 101 iterations, beta = 0 at k = 1,
// divisions guarded against 0.
//
// Bound: memory bandwidth. Per iteration sweep A reads the 11 F planes, r
// and p_old and writes p and w (15 planes), sweep B reads x, p, r, w and
// writes x, r (6 planes): about 21 f32 planes per lane, 103 MB at
// 960 x 1280, against about 50 flops per pixel; Jacobi reads invd in both
// sweeps (23 planes). This first design reads the 10 F fields of the 5
// points (i, j), (i, j+-1), (i+-1, j) that t1 and t2 are needed at through
// the cache rather than staging them; fusing the sweeps and staging F are
// later work.

#include "std_cg.cuh"

namespace {

using namespace srps;

// Halo of the p tile that sweep A stages in shared memory.
constexpr int HALO = 2;

// Dx v and Dy v at (a, b), with the masks of q (all 0 outside the image).
template <typename Get>
__device__ __forceinline__ void grads(const Pt& q, Get v, int a, int b,
                                      float vc, float& g, float& hh) {
  g = q.ax * (v(a, b + 1) - vc) + q.bx * (vc - v(a, b - 1));
  hh = q.ay * (v(a + 1, b) - vc) + q.by * (vc - v(a - 1, b));
}

__device__ __forceinline__ float t1_of(const Pt& q, float g, float hh,
                                       float vc) {
  return q.p11 * g + q.p12 * hh - q.p13 * vc;
}

__device__ __forceinline__ float t2_of(const Pt& q, float g, float hh,
                                       float vc) {
  return q.p12 * g + q.p22 * hh - q.p23 * vc;
}

// (M v)(i, j) through the gradient masks and the P fields (_matvec_band).
template <typename Get>
__device__ float direct_mv(const float* __restrict__ F, size_t hw, int i,
                           int j, int h, int w, int sf, float lam, Get v) {
  const Pt q = load_pt(F, hw, i, j, h, w);
  const Pt e = load_pt(F, hw, i, j + 1, h, w);
  const Pt o = load_pt(F, hw, i, j - 1, h, w);
  const Pt s = load_pt(F, hw, i + 1, j, h, w);
  const Pt n = load_pt(F, hw, i - 1, j, h, w);
  const float vc = v(i, j), ve = v(i, j + 1), vo = v(i, j - 1);
  const float vs = v(i + 1, j), vn = v(i - 1, j);
  float g, hh, ge, he, go, ho, gs, hs, gn, hn;
  grads(q, v, i, j, vc, g, hh);
  grads(e, v, i, j + 1, ve, ge, he);
  grads(o, v, i, j - 1, vo, go, ho);
  grads(s, v, i + 1, j, vs, gs, hs);
  grads(n, v, i - 1, j, vn, gn, hn);
  const float t1 = t1_of(q, g, hh, vc);
  const float t2 = t2_of(q, g, hh, vc);
  const float t3 = q.p13 * g + q.p23 * hh - q.p33 * vc;
  const float dxt =
      o.ax * t1_of(o, go, ho, vo) - q.ax * t1 + q.bx * t1 -
      e.bx * t1_of(e, ge, he, ve);
  const float dyt =
      n.ay * t2_of(n, gn, hn, vn) - q.ay * t2 + q.by * t2 -
      s.by * t2_of(s, gs, hs, vs);
  const float ktw = F[F_KTW * hw + (size_t)i * w + j];
  return ktw * tile_sum(v, i, j, sf) + lam * (dxt + dyt - t3);
}

template <bool JAC>
__global__ void __launch_bounds__(MAX_THREADS)
prologue_kernel(const float* __restrict__ F, const float* __restrict__ R0,
                const float* __restrict__ Z0U, const float* __restrict__ x0,
                const float* __restrict__ b, const float* __restrict__ invd,
                float* __restrict__ x, float* __restrict__ r,
                float* __restrict__ p0, float* __restrict__ part, int h,
                int w, int sf, float lam, int energy) {
  __shared__ float sh_r[MAX_THREADS];
  __shared__ float sh_e[MAX_THREADS];
  __shared__ float sh_z[JAC ? MAX_THREADS : 1];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const size_t lane = blockIdx.z;
  const int nb = gridDim.x * gridDim.y;
  F += lane * F_ROWS * hw;
  if (b != nullptr) {
    b += lane * hw;
  } else {
    R0 += lane * R_ROWS * hw;
  }
  if (energy) Z0U += lane * 2 * hw;
  x0 += lane * hw;
  if (JAC) invd += lane * hw;
  x += lane * hw;
  r += lane * hw;
  p0 += lane * hw;
  part += lane * PART_ROWS * nb;
  float rr = 0.0f, en = 0.0f, rz = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    auto X = [&](int a, int c) { return at(x0, a, c, h, w); };
    float rv;
    if (b != nullptr) {
      rv = b[o];
    } else {
      rv = rhs_at(F, R0, hw, i, j, h, w, lam) -
           direct_mv(F, hw, i, j, h, w, sf, lam, X);
      // Warm-start energy in residual form (_e0_band); the caller adds
      // lam * sum B^2.
      if (energy)
        en = energy_at(F, R0, Z0U, hw, o, i, j, sf, lam, X,
                       tile_sum(X, i, j, sf));
    }
    x[o] = x0[o];
    r[o] = rv;
    p0[o] = 0.0f;
    rr = rv * rv;
    if (JAC) rz = rr * invd[o];
  }
  const float sr = block_sum(rr, sh_r);
  const float se = block_sum(en, sh_e);
  const float sz = JAC ? block_sum(rz, sh_z) : 0.0f;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    part[lane_block()] = sr;
    part[nb + lane_block()] = se;
    if (JAC) part[2 * nb + lane_block()] = sz;
  }
}

template <bool JAC>
__global__ void __launch_bounds__(MAX_THREADS)
sweep_a_kernel(const float* __restrict__ F, const float* __restrict__ r,
               const float* __restrict__ p_old, float* __restrict__ p_new,
               float* __restrict__ wv, const float* __restrict__ invd,
               float* __restrict__ part, const float* __restrict__ scal,
               int h, int w, int sf, float lam) {
  const size_t lane = blockIdx.z;
  scal += lane * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  // p over the block's pixels and a HALO-pixel frame, row-major.
  extern __shared__ float tile[];
  __shared__ float sh[MAX_THREADS];
  const float beta = scal[S_BETA];
  const size_t hw = (size_t)h * w;
  F += lane * F_ROWS * hw;
  r += lane * hw;
  p_old += lane * hw;
  p_new += lane * hw;
  wv += lane * hw;
  if (JAC) invd += lane * hw;
  part += lane * PART_ROWS * gridDim.x * gridDim.y;
  // p = z + beta p_old, two roundings as in the plain version (no FMA), so
  // a staged value and a recomputed one are the same float.
  auto pnew_at = [&](int a, int c) {
    if (!inside(a, c, h, w)) return 0.0f;
    const size_t q = (size_t)a * w + c;
    const float z = JAC ? __fmul_rn(invd[q], r[q]) : r[q];
    return __fadd_rn(z, __fmul_rn(beta, p_old[q]));
  };
  const int tw = blockDim.x + 2 * HALO;
  const int tn = (blockDim.y + 2 * HALO) * tw;
  const int i0 = blockIdx.y * blockDim.y - HALO;
  const int j0 = blockIdx.x * blockDim.x - HALO;
  for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < tn;
       k += blockDim.x * blockDim.y)
    tile[k] = pnew_at(i0 + k / tw, j0 + k % tw);
  __syncthreads();
  // A tile-sum mate at sf = 4 can lie beyond the halo when the block is not
  // tile-aligned: it is recomputed.
  auto P = [&](int a, int c) {
    const int ta = a - i0, tc = c - j0;
    if (ta >= 0 && tc >= 0 && tc < tw && ta * tw + tc < tn)
      return tile[ta * tw + tc];
    return pnew_at(a, c);
  };
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  float v = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    const float pc = P(i, j);
    const float ws = direct_mv(F, hw, i, j, h, w, sf, lam, P);
    p_new[o] = pc;
    wv[o] = ws;
    v = pc * ws;
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0) part[lane_block()] = s;
}

template <bool JAC>
int run(const float* F, const float* R0, const float* Z0U, const float* x0,
        const float* b, const float* invd, float* x, float* r, float* pa,
        float* pb, float* wv, float* part, float* scal, int B, int h, int w,
        int sf, float lam, float tol2, int max_iter, int bx, int by,
        int energy, cudaStream_t st) {
  const dim3 block(bx, by);
  const dim3 grid((w + bx - 1) / bx, (h + by - 1) / by, B);
  const int nb = (int)(grid.x * grid.y);
  const size_t tile_bytes =
      sizeof(float) * (size_t)(bx + 2 * HALO) * (size_t)(by + 2 * HALO);
  prologue_kernel<JAC><<<grid, block, 0, st>>>(F, R0, Z0U, x0, b, invd, x, r,
                                               pa, part, h, w, sf, lam,
                                               energy);
  SRPS_CHECK();
  reduce_init_kernel<JAC><<<B, REDUCE_THREADS, 0, st>>>(part, nb, scal, tol2,
                                                        max_iter);
  SRPS_CHECK();
  for (int k = 1; k <= max_iter + 1; ++k) {
    const float* p_old = (k % 2 == 1) ? pa : pb;
    float* p_new = (k % 2 == 1) ? pb : pa;
    sweep_a_kernel<JAC><<<grid, block, tile_bytes, st>>>(
        F, r, p_old, p_new, wv, invd, part, scal, h, w, sf, lam);
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
  return (int)cudaGetLastError();
}

}  // namespace

// The direct-matvec depth CG of B lanes on `stream`. Inputs, per lane: F
// (11, h, w), x0 (h, w); either R0 (4, h, w) (r0 built in the kernel) or b
// (h, w) (the residual given), the other null; Z0U (2, h, w) with energy =
// 1 (r0 in the kernel only), else null; invd (h, w) for Jacobi PCG, else
// null. Outputs and scratch, allocated by the caller, per lane: x, r, p0,
// p1, w (h, w); part (PART_ROWS * blocks per lane); scal (N_SCAL floats).
// Returns a cudaError_t.
extern "C" int srps_direct_cg(const void* F, const void* R0, const void* Z0U,
                              const void* x0, const void* b, const void* invd,
                              void* x, void* r, void* p0, void* p1, void* wv,
                              void* part, void* scal, int B, int h, int w,
                              int sf, float lam, float tol2, int max_iter,
                              int bx, int by, int energy, void* stream) {
  if ((R0 == nullptr) == (b == nullptr) ||
      (energy != 0) != (Z0U != nullptr) || (energy && b != nullptr) ||
      (sf != 1 && sf != 2 && sf != 4) || bx <= 0 || by <= 0 ||
      bx * by > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  auto run_mode = invd == nullptr ? &run<false> : &run<true>;
  return run_mode((const float*)F, (const float*)R0, (const float*)Z0U,
                  (const float*)x0, (const float*)b, (const float*)invd,
                  (float*)x, (float*)r, (float*)p0, (float*)p1, (float*)wv,
                  (float*)part, (float*)scal, B, h, w, sf, lam, tol2,
                  max_iter, bx, by, energy, (cudaStream_t)stream);
}
