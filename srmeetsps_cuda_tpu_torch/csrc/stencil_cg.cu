// Depth CG of SRmeetsPS as hand-written CUDA kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py::
// _kernel_vmem_stencil (pallas_call at :1471 through
// cg_pallas_vmem_fromop_batched, in its "full_stencil" mode with the energy
// tracked, plain CG, one problem). It solves M x = rhs from the warm start
// x0, with M = KT^T KT + lam A^T A collapsed to a spatially varying 9-point
// stencil. The TPU kernel keeps the whole solve resident in VMEM inside a
// padded (8-row ring, 128-lane) layout; here the planes are the unpadded
// (h, w) row-major images and every neighbour read outside the image is
// guarded and reads 0.
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
//   reduce_*    one block that sums the partials in a fixed order (in
//               double) and updates the device scalars alpha, beta, r0, r1,
//               E, active and iters.
// The host launches max_iter + 1 iterations and never reads a scalar: each
// kernel returns at once when the device flag `active` is 0. No float
// atomics are used, so iteration counts and energies repeat exactly.
//
// Bound: memory bandwidth. Per iteration sweep A reads the 9 C planes plus
// r and p_old and writes p and w (13 planes), sweep B reads x, p, r, w and
// writes x, r (6 planes): about 19 f32 planes, 93 MB at 960 x 1280, against
// about 40 flops per pixel. The design keeps M as 9 coefficient planes (9
// multiply-adds a pixel instead of the ~40-op mask-gated matvec chain) and
// recomputes p at the neighbours instead of a separate pass. Fusing the
// sweeps, CUDA graphs and TMA staging are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Rows of the F pack: the depth operator's Gram fields, the gradient masks
// and the KT^T KT weight.
constexpr int F_P11 = 0, F_P12 = 1, F_P13 = 2, F_P22 = 3, F_P23 = 4,
              F_P33 = 5, F_AX = 6, F_BX = 7, F_AY = 8, F_BY = 9, F_KTW = 10;
// Rows of the R0 pack: the rhs fields and KT^T z0s.
constexpr int R_QB1 = 0, R_QB2 = 1, R_QB3 = 2, R_Z0T = 3;
// Device scalars (float).
constexpr int S_R0 = 0, S_R1 = 1, S_PW = 2, S_ALPHA = 3, S_BETA = 4,
              S_E = 5, S_ACT = 6, S_ITERS = 7, S_K = 8;

constexpr int MAX_THREADS = 1024;
constexpr int REDUCE_THREADS = 1024;

__device__ __forceinline__ bool inside(int i, int j, int h, int w) {
  return i >= 0 && i < h && j >= 0 && j < w;
}

__device__ __forceinline__ float at(const float* __restrict__ a, int i, int j,
                                    int h, int w) {
  return inside(i, j, h, w) ? a[(size_t)i * w + j] : 0.0f;
}

// The fields of the F pack at one pixel; all zero outside the image.
struct Pt {
  float ax, bx, ay, by, p11, p12, p13, p22, p23, p33;
};

__device__ __forceinline__ Pt load_pt(const float* __restrict__ F, size_t hw,
                                      int i, int j, int h, int w) {
  Pt q{};
  if (!inside(i, j, h, w)) return q;
  const size_t o = (size_t)i * w + j;
  q.ax = F[F_AX * hw + o];
  q.bx = F[F_BX * hw + o];
  q.ay = F[F_AY * hw + o];
  q.by = F[F_BY * hw + o];
  q.p11 = F[F_P11 * hw + o];
  q.p12 = F[F_P12 * hw + o];
  q.p13 = F[F_P13 * hw + o];
  q.p22 = F[F_P22 * hw + o];
  q.p23 = F[F_P23 * hw + o];
  q.p33 = F[F_P33 * hw + o];
  return q;
}

// One-sided mask-folded field combinations of _build_c_band.
__device__ __forceinline__ float e1(const Pt& q) {
  return q.ax * (q.p11 + (q.ay - q.by) * q.p12 + q.p13);
}
__device__ __forceinline__ float e2(const Pt& q) {
  return q.bx * (q.p11 - (q.ay - q.by) * q.p12 - q.p13);
}
__device__ __forceinline__ float f1(const Pt& q) {
  return q.ay * (q.p22 + (q.ax - q.bx) * q.p12 + q.p23);
}
__device__ __forceinline__ float f2(const Pt& q) {
  return q.by * (q.p22 - (q.ax - q.bx) * q.p12 - q.p23);
}
__device__ __forceinline__ float paa(const Pt& q) { return q.ax * q.ay * q.p12; }
__device__ __forceinline__ float pab(const Pt& q) { return q.ax * q.by * q.p12; }
__device__ __forceinline__ float pba(const Pt& q) { return q.bx * q.ay * q.p12; }
__device__ __forceinline__ float pbb(const Pt& q) { return q.bx * q.by * q.p12; }

// The 9 stencil coefficients of M at pixel (i, j). "+x" is column j + 1,
// "+y" is row i + 1. At sf <= 2 the KT^T KT tile mates are folded in by the
// pixel's row and column phase (h and w are multiples of sf).
__device__ void build_c(const float* __restrict__ F, size_t hw, int i, int j,
                        int h, int w, float lam, int sf, float c[9]) {
  const Pt q = load_pt(F, hw, i, j, h, w);
  const Pt e = load_pt(F, hw, i, j + 1, h, w);
  const Pt o = load_pt(F, hw, i, j - 1, h, w);
  const Pt s = load_pt(F, hw, i + 1, j, h, w);
  const Pt n = load_pt(F, hw, i - 1, j, h, w);
  const float cx = q.ax - q.bx;
  const float cy = q.ay - q.by;
  c[1] = -(e1(q) + e2(e));
  c[2] = -(e1(o) + e2(q));
  c[3] = -(f1(q) + f2(s));
  c[4] = -(f1(n) + f2(q));
  c[5] = -(pba(e) + pab(s));
  c[6] = pbb(e) + paa(n);
  c[7] = paa(o) + pbb(s);
  c[8] = -(pab(o) + pba(n));
  c[0] = o.ax * o.p11 + (q.ax + q.bx) * q.p11 + e.bx * e.p11 + n.ay * n.p22 +
         (q.ay + q.by) * q.p22 + s.by * s.p22 +
         2.0f * (cx * cy * q.p12 + cx * q.p13 + cy * q.p23) + q.p33;
#pragma unroll
  for (int d = 0; d < 9; ++d) c[d] *= lam;
  if (sf > 2) return;
  const float ktw = F[F_KTW * hw + (size_t)i * w + j];
  c[0] += ktw;
  if (sf == 1) return;
  const bool pye = (i % 2) == 0;
  const float kxe = (j % 2) == 0 ? ktw : 0.0f;
  const float kxo = ktw - kxe;
  c[1] += kxe;
  c[2] += kxo;
  c[3] += pye ? ktw : 0.0f;
  c[4] += pye ? 0.0f : ktw;
  c[5] += pye ? kxe : 0.0f;
  c[6] += pye ? 0.0f : kxe;
  c[7] += pye ? kxo : 0.0f;
  c[8] += pye ? 0.0f : kxo;
}

template <typename Get>
__device__ __forceinline__ float stencil(const float c[9], Get v, int i,
                                         int j) {
  return c[0] * v(i, j) + c[1] * v(i, j + 1) + c[2] * v(i, j - 1) +
         c[3] * v(i + 1, j) + c[4] * v(i - 1, j) + c[5] * v(i + 1, j + 1) +
         c[6] * v(i - 1, j + 1) + c[7] * v(i + 1, j - 1) +
         c[8] * v(i - 1, j - 1);
}

// Sum of v over the aligned sf x sf tile holding (i, j).
template <typename Get>
__device__ __forceinline__ float tile_sum(Get v, int i, int j, int sf) {
  const int i0 = i - i % sf;
  const int j0 = j - j % sf;
  float t = 0.0f;
  for (int a = 0; a < sf; ++a)
    for (int b = 0; b < sf; ++b) t += v(i0 + a, j0 + b);
  return t;
}

// Sum over the block in a fixed tree order; the result is valid in thread 0.
__device__ float block_sum(float v, float* sh) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  sh[t] = v;
  __syncthreads();
  int p = 1;
  while (p < nt) p <<= 1;
  for (int s = p >> 1; s > 0; s >>= 1) {
    if (t < s && t + s < nt) sh[t] += sh[t + s];
    __syncthreads();
  }
  return sh[0];
}

// Sum of part[0..n) by one block in a fixed order: strided per thread, then
// a tree. Valid in thread 0.
__device__ double reduce_parts(const float* __restrict__ part, int n,
                               double* sh) {
  const int t = threadIdx.x;
  double acc = 0.0;
  for (int k = t; k < n; k += blockDim.x) acc += (double)part[k];
  __syncthreads();
  sh[t] = acc;
  __syncthreads();
  for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  return sh[0];
}

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

    // rhs = z0t + lam * (Dx^T QB1 + Dy^T QB2 - QB3)
    const float* ax = F + F_AX * hw;
    const float* bx = F + F_BX * hw;
    const float* ay = F + F_AY * hw;
    const float* by = F + F_BY * hw;
    const float* qb1 = R0 + R_QB1 * hw;
    const float* qb2 = R0 + R_QB2 * hw;
    const float qb3 = R0[R_QB3 * hw + o];
    const float dxq = at(ax, i, j - 1, h, w) * at(qb1, i, j - 1, h, w) -
                      ax[o] * qb1[o] + bx[o] * qb1[o] -
                      at(bx, i, j + 1, h, w) * at(qb1, i, j + 1, h, w);
    const float dyq = at(ay, i - 1, j, h, w) * at(qb2, i - 1, j, h, w) -
                      ay[o] * qb2[o] + by[o] * qb2[o] -
                      at(by, i + 1, j, h, w) * at(qb2, i + 1, j, h, w);
    const float rhs = R0[R_Z0T * hw + o] + lam * (dxq + dyq - qb3);
    const float rv = rhs - mx;
    x[o] = xc;
    r[o] = rv;
    p0[o] = 0.0f;
    rr = rv * rv;

    // Warm-start energy in residual form (_e0_band); the caller adds
    // lam * sum B^2.
    const float g = ax[o] * (X(i, j + 1) - xc) + bx[o] * (xc - X(i, j - 1));
    const float hh = ay[o] * (X(i + 1, j) - xc) + by[o] * (xc - X(i - 1, j));
    const float quad =
        F[F_P11 * hw + o] * g * g + F[F_P22 * hw + o] * hh * hh +
        F[F_P33 * hw + o] * xc * xc +
        2.0f * (F[F_P12 * hw + o] * g * hh - F[F_P13 * hw + o] * g * xc -
                F[F_P23 * hw + o] * hh * xc);
    const float lin = qb1[o] * g + qb2[o] * hh - qb3 * xc;
    const float inv = 1.0f / (float)(sf * sf);
    const float rkt = Z0U[o] * (ts * inv) - Z0U[hw + o];
    en = rkt * rkt * inv + lam * (quad - 2.0f * lin);
  }
  const float sr = block_sum(rr, sh_r);
  const float se = block_sum(en, sh_e);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    const int nb = gridDim.x * gridDim.y;
    part[b] = sr;
    part[nb + b] = se;
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_init_kernel(const float* __restrict__ part, int nb,
                   float* __restrict__ scal, float tol2, int max_iter) {
  __shared__ double sh[REDUCE_THREADS];
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
               float* __restrict__ wv, const float* __restrict__ ktw,
               float* __restrict__ part, const float* __restrict__ scal,
               int h, int w, int sf) {
  if (scal[S_ACT] == 0.0f) return;
  __shared__ float sh[MAX_THREADS];
  const float beta = scal[S_BETA];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
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
  if (threadIdx.x == 0 && threadIdx.y == 0)
    part[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_a_kernel(const float* __restrict__ part, int nb,
                float* __restrict__ scal) {
  if (scal[S_ACT] == 0.0f) return;
  __shared__ double sh[REDUCE_THREADS];
  const double pw = reduce_parts(part, nb, sh);
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
  if (scal[S_ACT] == 0.0f) return;
  __shared__ float sh[MAX_THREADS];
  const float alpha = scal[S_ALPHA];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  float v = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    x[o] = x[o] + alpha * p[o];
    const float rv = r[o] - alpha * wv[o];
    r[o] = rv;
    v = rv * rv;
  }
  const float s = block_sum(v, sh);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    part[blockIdx.y * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_b_kernel(const float* __restrict__ part, int nb,
                float* __restrict__ scal, float tol2, int max_iter) {
  if (scal[S_ACT] == 0.0f) return;
  __shared__ double sh[REDUCE_THREADS];
  const double rr = reduce_parts(part, nb, sh);
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

#define SRPS_CHECK()                         \
  do {                                       \
    const cudaError_t err = cudaGetLastError(); \
    if (err != cudaSuccess) return (int)err; \
  } while (0)

// The whole depth CG on `stream`. Inputs: F (11, h, w), R0 (4, h, w),
// Z0U (2, h, w) = [up(masks), up(masks * z0s)], x0 (h, w). Outputs and
// scratch, allocated by the caller: x, r, p0, p1, w (h, w); C (9, h, w);
// part (2 * number of blocks); scal (9 floats). Returns a cudaError_t.
extern "C" int srps_stencil_cg(const void* F, const void* R0, const void* Z0U,
                               const void* x0, void* x, void* r, void* p0,
                               void* p1, void* wv, void* C, void* part,
                               void* scal, int h, int w, int sf, float lam,
                               float tol2, int max_iter, int bx, int by,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(bx, by);
  const dim3 grid((w + bx - 1) / bx, (h + by - 1) / by);
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
  const float* ktw = Ff + (size_t)F_KTW * h * w;

  prologue_kernel<<<grid, block, 0, st>>>(
      Ff, (const float*)R0, (const float*)Z0U, (const float*)x0, xf, rf, pa,
      (float*)C, pt, h, w, sf, lam);
  SRPS_CHECK();
  reduce_init_kernel<<<1, REDUCE_THREADS, 0, st>>>(pt, nb, sc, tol2,
                                                   max_iter);
  SRPS_CHECK();
  for (int k = 1; k <= max_iter + 1; ++k) {
    const float* p_old = (k % 2 == 1) ? pa : pb;
    float* p_new = (k % 2 == 1) ? pb : pa;
    sweep_a_kernel<<<grid, block, 0, st>>>(Cf, rf, p_old, p_new, wf, ktw, pt,
                                           sc, h, w, sf);
    SRPS_CHECK();
    reduce_a_kernel<<<1, REDUCE_THREADS, 0, st>>>(pt, nb, sc);
    SRPS_CHECK();
    sweep_b_kernel<<<grid, block, 0, st>>>(xf, rf, p_new, wf, pt, sc, h, w);
    SRPS_CHECK();
    reduce_b_kernel<<<1, REDUCE_THREADS, 0, st>>>(pt, nb, sc, tol2,
                                                  max_iter);
    SRPS_CHECK();
  }
  return (int)cudaGetLastError();
}
