// The standard-CG pieces shared by stencil_cg.cu, direct_cg.cu and
// shard_cg.cu: the lane's device scalars and their updates, the one-block
// reduces that apply them, and sweep B (x += alpha p, r -= alpha w). Only
// the prologue and sweep A (how M is applied) differ between the kernels.
//
// Each lane owns N_SCAL floats of scalars and PART_ROWS rows of per-block
// partial sums. r1 drives alpha and beta (rz under Jacobi PCG); rr is <r, r>
// (the stop dot) and, after the loop, the reported residual. The reduces sum
// the partials in a fixed order in double: no float atomics, so iteration
// counts and energies repeat exactly, and a lane's result does not depend on
// the other lanes of its launch.

#pragma once

#include "stencil_common.cuh"

namespace {

using namespace srps;

constexpr int S_R0 = 0, S_R1 = 1, S_PW = 2, S_ALPHA = 3, S_BETA = 4,
              S_E = 5, S_ACT = 6, S_ITERS = 7, S_K = 8, S_RR = 9;
constexpr int N_SCAL = 10;
// Rows of per-block partial sums per lane: the prologue writes <r0, r0>,
// the energy and (Jacobi) rz; sweep A <p, w>; sweep B <r, r> and rz.
constexpr int PART_ROWS = 3;

// The lane's scalar updates from the sums of its partials, each done by one
// thread: after the prologue (rr, the energy e0 and, in PCG, rz), after
// sweep A (pw) and after sweep B (rr, rz). In PCG r1 = rz and the stop test
// reads rr; otherwise both are <r, r>. The reduces below call them on a
// lane's own sums; shard_cg.cu on the sums of every row shard.
__device__ void scal_init(float* __restrict__ scal, double rr, double e0,
                          double rz, float tol2, int max_iter) {
  const float rrf = (float)rr;
  const bool act = (rrf > tol2) && (0 <= max_iter);
  scal[S_R0] = 0.0f;
  scal[S_R1] = (float)rz;
  scal[S_RR] = rrf;
  scal[S_PW] = 0.0f;
  scal[S_ALPHA] = 0.0f;
  scal[S_BETA] = 0.0f;
  scal[S_E] = (float)e0;
  scal[S_ACT] = act ? 1.0f : 0.0f;
  scal[S_ITERS] = act ? 1.0f : 0.0f;
  scal[S_K] = 1.0f;
}

__device__ void scal_a(float* __restrict__ scal, double pw) {
  const float pwf = (float)pw;
  const float r1 = scal[S_R1];
  const float alpha = r1 / (pwf == 0.0f ? 1.0f : pwf);
  scal[S_PW] = pwf;
  scal[S_ALPHA] = alpha;
  // E(x + alpha p) = E(x) - alpha <p, r> with <p, r> = r1 (_e0_band),
  // using r1 from before sweep B.
  scal[S_E] = scal[S_E] - alpha * r1;
}

__device__ void scal_b(float* __restrict__ scal, double rr, double rz,
                       float tol2, int max_iter) {
  const float rrf = (float)rr;
  const float r1f = (float)rz;
  const float r1_old = scal[S_R1];
  scal[S_R0] = r1_old;
  scal[S_R1] = r1f;
  scal[S_RR] = rrf;
  // Start of the next iteration k: the reference's test
  // rr > tol^2 && k - 1 <= max_iter, and beta = r1 / r0.
  const float k = scal[S_K] + 1.0f;
  scal[S_K] = k;
  const bool act = (rrf > tol2) && (k - 1.0f <= (float)max_iter);
  scal[S_ACT] = act ? 1.0f : 0.0f;
  scal[S_BETA] = r1f / (r1_old == 0.0f ? 1.0f : r1_old);
  if (act) scal[S_ITERS] = scal[S_ITERS] + 1.0f;
}

// One block per lane (blockIdx.x).
template <bool JAC>
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_init_kernel(const float* __restrict__ part, int nb,
                   float* __restrict__ scal, float tol2, int max_iter) {
  __shared__ double sh[REDUCE_THREADS];
  part += (size_t)blockIdx.x * PART_ROWS * nb;
  scal += (size_t)blockIdx.x * N_SCAL;
  const double rr = reduce_parts(part, nb, sh);
  const double e0 = reduce_parts(part + nb, nb, sh);
  const double rz = JAC ? reduce_parts(part + 2 * nb, nb, sh) : rr;
  if (threadIdx.x == 0) scal_init(scal, rr, e0, rz, tol2, max_iter);
}

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_a_kernel(const float* __restrict__ part, int nb,
                float* __restrict__ scal) {
  scal += (size_t)blockIdx.x * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  __shared__ double sh[REDUCE_THREADS];
  const double pw =
      reduce_parts(part + (size_t)blockIdx.x * PART_ROWS * nb, nb, sh);
  if (threadIdx.x == 0) scal_a(scal, pw);
}

template <bool JAC>
__global__ void __launch_bounds__(MAX_THREADS)
sweep_b_kernel(float* __restrict__ x, float* __restrict__ r,
               const float* __restrict__ p, const float* __restrict__ wv,
               const float* __restrict__ invd, float* __restrict__ part,
               const float* __restrict__ scal, int h, int w) {
  const size_t lane = blockIdx.z;
  scal += lane * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  __shared__ float sh[MAX_THREADS];
  __shared__ float sh_z[JAC ? MAX_THREADS : 1];
  const float alpha = scal[S_ALPHA];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t hw = (size_t)h * w;
  const int nb = gridDim.x * gridDim.y;
  x += lane * hw;
  r += lane * hw;
  p += lane * hw;
  wv += lane * hw;
  if (JAC) invd += lane * hw;
  part += lane * PART_ROWS * nb;
  float v = 0.0f, vz = 0.0f;
  if (i < h && j < w) {
    const size_t o = (size_t)i * w + j;
    x[o] = x[o] + alpha * p[o];
    const float rv = r[o] - alpha * wv[o];
    r[o] = rv;
    v = rv * rv;
    if (JAC) vz = v * invd[o];
  }
  const float s = block_sum(v, sh);
  const float sz = JAC ? block_sum(vz, sh_z) : 0.0f;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    part[lane_block()] = s;
    if (JAC) part[nb + lane_block()] = sz;
  }
}

template <bool JAC>
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_b_kernel(const float* __restrict__ part, int nb,
                float* __restrict__ scal, float tol2, int max_iter) {
  scal += (size_t)blockIdx.x * N_SCAL;
  if (scal[S_ACT] == 0.0f) return;
  __shared__ double sh[REDUCE_THREADS];
  part += (size_t)blockIdx.x * PART_ROWS * nb;
  const double rr = reduce_parts(part, nb, sh);
  const double rz = JAC ? reduce_parts(part + nb, nb, sh) : rr;
  if (threadIdx.x == 0) scal_b(scal, rr, rz, tol2, max_iter);
}

}  // namespace
