// Device helpers shared by the depth-CG kernels (stencil_cg.cu, cgs_cg.cu,
// direct_cg.cu, shard_cg.cu).
//
// Layout of every plane: unpadded (h, w) row-major f32; a problem stack
// holds B lanes of such planes back to back, and a kernel's blockIdx.z is
// its lane (the persistent kernels take a tile's lane from the tile plan,
// persistent.cuh). Neighbour reads outside the image are guarded and read
// 0. The row-shard kernels (shard_cg.cu) read planes with HALO = 1
// neighbour row above and below their h rows: pointers there address row 0
// of an (h + 2, w) plane, and rows -1 and h are readable.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace srps {

// Rows of the F pack: the depth operator's Gram fields, the gradient masks
// and the KT^T KT weight.
constexpr int F_P11 = 0, F_P12 = 1, F_P13 = 2, F_P22 = 3, F_P23 = 4,
              F_P33 = 5, F_AX = 6, F_BX = 7, F_AY = 8, F_BY = 9, F_KTW = 10;
constexpr int F_ROWS = 11;
// Rows of the R0 pack: the rhs fields and KT^T z0s.
constexpr int R_QB1 = 0, R_QB2 = 1, R_QB3 = 2, R_Z0T = 3;
constexpr int R_ROWS = 4;
constexpr int N_STENCIL = 9;

constexpr int MAX_THREADS = 1024;
constexpr int REDUCE_THREADS = 1024;

template <int HALO = 0>
__device__ __forceinline__ bool inside(int i, int j, int h, int w) {
  return i >= -HALO && i < h + HALO && j >= 0 && j < w;
}

template <int HALO = 0>
__device__ __forceinline__ float at(const float* __restrict__ a, int i, int j,
                                    int h, int w) {
  return inside<HALO>(i, j, h, w) ? a[(ptrdiff_t)i * w + j] : 0.0f;
}

// The fields of the F pack at one pixel; all zero outside the image.
struct Pt {
  float ax, bx, ay, by, p11, p12, p13, p22, p23, p33;
};

template <int HALO = 0>
__device__ __forceinline__ Pt load_pt(const float* __restrict__ F, size_t hw,
                                      int i, int j, int h, int w) {
  Pt q{};
  if (!inside<HALO>(i, j, h, w)) return q;
  const ptrdiff_t o = (ptrdiff_t)i * w + j;
  const ptrdiff_t s = (ptrdiff_t)hw;
  q.ax = F[F_AX * s + o];
  q.bx = F[F_BX * s + o];
  q.ay = F[F_AY * s + o];
  q.by = F[F_BY * s + o];
  q.p11 = F[F_P11 * s + o];
  q.p12 = F[F_P12 * s + o];
  q.p13 = F[F_P13 * s + o];
  q.p22 = F[F_P22 * s + o];
  q.p23 = F[F_P23 * s + o];
  q.p33 = F[F_P33 * s + o];
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
// pixel's row and column phase (h and w are multiples of sf; a row shard's
// first row has an even global index).
template <int HALO = 0>
__device__ void build_c(const float* __restrict__ F, size_t hw, int i, int j,
                        int h, int w, float lam, int sf, float c[9]) {
  const Pt q = load_pt<HALO>(F, hw, i, j, h, w);
  const Pt e = load_pt<HALO>(F, hw, i, j + 1, h, w);
  const Pt o = load_pt<HALO>(F, hw, i, j - 1, h, w);
  const Pt s = load_pt<HALO>(F, hw, i + 1, j, h, w);
  const Pt n = load_pt<HALO>(F, hw, i - 1, j, h, w);
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

// rhs = z0t + lam * (Dx^T QB1 + Dy^T QB2 - QB3) at pixel (i, j).
template <int HALO = 0>
__device__ __forceinline__ float rhs_at(const float* __restrict__ F,
                                        const float* __restrict__ R0,
                                        size_t hw, int i, int j, int h, int w,
                                        float lam) {
  const size_t o = (size_t)i * w + j;
  const float* ax = F + F_AX * hw;
  const float* bx = F + F_BX * hw;
  const float* ay = F + F_AY * hw;
  const float* by = F + F_BY * hw;
  const float* qb1 = R0 + R_QB1 * hw;
  const float* qb2 = R0 + R_QB2 * hw;
  const float dxq =
      at<HALO>(ax, i, j - 1, h, w) * at<HALO>(qb1, i, j - 1, h, w) -
      ax[o] * qb1[o] + bx[o] * qb1[o] -
      at<HALO>(bx, i, j + 1, h, w) * at<HALO>(qb1, i, j + 1, h, w);
  const float dyq =
      at<HALO>(ay, i - 1, j, h, w) * at<HALO>(qb2, i - 1, j, h, w) -
      ay[o] * qb2[o] + by[o] * qb2[o] -
      at<HALO>(by, i + 1, j, h, w) * at<HALO>(qb2, i + 1, j, h, w);
  return R0[R_Z0T * hw + o] + lam * (dxq + dyq - R0[R_QB3 * hw + o]);
}

// The depth energy of pixel o = (i, j) at x in residual form (_e0_band),
// without lam * sum B^2 (the caller adds it): the data term's P/QB-weighted
// quadratics of (Dx x, Dy x, x) and the KT term against the Z0U planes
// [up(masks), up(masks * z0s)]. X reads x (0 outside the image); ts is the
// sum of x over the aligned sf x sf tile holding (i, j).
template <typename Get>
__device__ __forceinline__ float energy_at(
    const float* __restrict__ F, const float* __restrict__ R0,
    const float* __restrict__ Z0U, size_t hw, size_t o, int i, int j,
    int sf, float lam, Get X, float ts) {
  const float xc = X(i, j);
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
  return rkt * rkt * inv + lam * (quad - 2.0f * lin);
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

// Index of this block among the blocks of its lane.
__device__ __forceinline__ int lane_block() {
  return blockIdx.y * gridDim.x + blockIdx.x;
}

}  // namespace srps

#define SRPS_CHECK()                            \
  do {                                          \
    const cudaError_t err = cudaGetLastError(); \
    if (err != cudaSuccess) return (int)err;    \
  } while (0)
