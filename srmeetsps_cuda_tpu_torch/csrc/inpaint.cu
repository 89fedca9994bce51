// The depth inpaint's Jacobi relaxation as one hand-written CUDA kernel for
// Hopper (sm_90a), run a few times per capture.
//
// Replaces no TPU kernel: the JAX package relaxes with lax.conv inside a
// fori_loop (srmeetsps_cuda_tpu/pre/inpaint.py::inpaint_diffusion), which
// XLA fuses on a TPU. The port's plain version
// (srmeetsps_cuda_tpu_torch/pre/inpaint.py::relax_plain) runs each sweep
// as ~28 small PyTorch operations, 512 sweeps a capture: launches, not
// work, bound it. One sweep is
//
//   u[i, j] = known[i, j] ? u[i, j] : conv3(u)[i, j] / 6,
//   conv3 = [[.5, 1, .5], [1, 0, 1], [.5, 1, .5]], zero outside the image,
//
// ~12 operations a pixel on an LR grid of 1-2 MB that lives in L2: 512
// sweeps at 480 x 640 are ~1.9 GFLOP, ~0.03 ms at 67 TFLOP/s.
//
// Design: temporal blocking in shared memory. A CTA owns a TILE x TILE
// tile. It stages the tile and a halo of K pixels on every side (u, and
// the known mask; outside the image a fixed 0, as the plain version's
// shift pads), runs up to K sweeps there between two ping-pong buffers,
// the swept square shrinking by one pixel a side each sweep, and writes
// back the tile alone: after s <= K sweeps every pixel at least s from
// the staged square's edge is exact. A run of `iters` sweeps is
// ceil(iters / K) launches (passes) that alternate between two global
// buffers; the last pass runs iters mod K sweeps (K if that is 0). K lives
// here alone: the C entry returns the passes it launched, and the caller
// takes the result's buffer and its launch count from that.
//
// Each update rounds as the plain version does on the card, one PyTorch
// operation at a time: edges = ((u[i,j+1] + u[i,j-1]) + u[i+1,j]) +
// u[i-1,j], corners = ((u[i+1,j+1] + u[i+1,j-1]) + u[i-1,j+1]) +
// u[i-1,j-1], then (edges + 0.5 corners) times the float 1/6 (PyTorch on
// CUDA divides by a Python scalar as a product with its reciprocal). The
// _rn intrinsics keep nvcc from contracting them into FMAs, so the result
// is bit for bit the plain version's on the card.
//
// The kernel allocates nothing and does not synchronise; the C entry
// launches the passes on the caller's stream and returns their count, or
// minus the CUDA error.

#include <cuda_runtime.h>

namespace {

// K = 16 sweeps a pass: 32 launches for the default 512 sweeps. On one H100
// 80GB HBM3 at 700 W (512 sweeps at 480 x 640, 5% of the pixels holes,
// 32 x 16 threads) K = 4, 8, 16 and 32 took 1.27, 1.04, 1.02 and 1.69 ms;
// at K = 16, 32 x 8 threads took 1.18 ms and 32 x 32 1.16.
constexpr int TILE = 32;             // a tile's rows and columns
constexpr int K = 16;                // sweeps a pass, and the halo's width
constexpr int R = TILE + 2 * K;      // the staged square's side
constexpr int BX = 32, BY = 16;      // the thread block
constexpr float INV6 = 1.0f / 6.0f;  // rounded to float, as PyTorch does
// Two float buffers and the mask: 36,864 bytes, static shared memory.
constexpr size_t SHARED_BYTES = size_t(R) * R * (2 * sizeof(float) + 1);
static_assert(SHARED_BYTES <= 48 * 1024, "the square must fit 48 KB");

__global__ void __launch_bounds__(BX * BY)
jacobi_pass(const float* __restrict__ src, float* __restrict__ dst,
            const unsigned char* __restrict__ known, int h, int w,
            int sweeps) {
  __shared__ float a[R * R];
  __shared__ float b[R * R];
  __shared__ unsigned char fixed[R * R];
  const int i0 = blockIdx.y * TILE - K, j0 = blockIdx.x * TILE - K;

  for (int r = threadIdx.y; r < R; r += BY) {
    const int i = i0 + r;
    for (int c = threadIdx.x; c < R; c += BX) {
      const int j = j0 + c;
      const bool in = i >= 0 && i < h && j >= 0 && j < w;
      const size_t g = in ? size_t(i) * w + j : 0;
      const float v = in ? src[g] : 0.0f;
      a[r * R + c] = v;
      b[r * R + c] = v;
      fixed[r * R + c] = in ? (known[g] != 0) : 1;
    }
  }
  __syncthreads();

  float* cur = a;
  float* nxt = b;
  for (int s = 1; s <= sweeps; ++s) {
    for (int r = s + threadIdx.y; r < R - s; r += BY) {
      for (int c = s + threadIdx.x; c < R - s; c += BX) {
        const int k = r * R + c;
        if (fixed[k]) continue;  // both buffers hold its value
        const float edges = __fadd_rn(
            __fadd_rn(__fadd_rn(cur[k + 1], cur[k - 1]), cur[k + R]),
            cur[k - R]);
        const float corners = __fadd_rn(
            __fadd_rn(__fadd_rn(cur[k + R + 1], cur[k + R - 1]),
                      cur[k - R + 1]),
            cur[k - R - 1]);
        nxt[k] = __fmul_rn(__fadd_rn(edges, __fmul_rn(0.5f, corners)), INV6);
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int r = K + threadIdx.y; r < K + TILE; r += BY) {
    const int i = i0 + r, j = j0 + K + threadIdx.x;
    if (i < h && j < w) dst[size_t(i) * w + j] = cur[r * R + K + threadIdx.x];
  }
}

}  // namespace

// K, for the caller's counts of launches.
extern "C" int srps_inpaint_sweeps_per_pass() { return K; }

// Relax `iters` sweeps, K a pass. a holds the start on entry and b equals
// it at every known pixel; pass p reads a if p is even, b if odd, and
// writes the other, so the result is in a after an even count of passes
// and in b after an odd one. `known` is h x w bytes (nonzero = known).
// Returns the count of passes launched, ceil(iters / K), or minus the
// CUDA error.
extern "C" int srps_inpaint(void* a, void* b, const void* known, int h,
                            int w, int iters, void* stream) {
  if (h <= 0 || w <= 0 || iters < 0) return -int(cudaErrorInvalidValue);
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  const dim3 block(BX, BY);
  const unsigned char* m = static_cast<const unsigned char*>(known);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* src = static_cast<float*>(a);
  float* dst = static_cast<float*>(b);
  int passes = 0;
  for (int left = iters; left > 0; left -= K, ++passes) {
    jacobi_pass<<<grid, block, 0, st>>>(src, dst, m, h, w,
                                        left < K ? left : K);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return -int(e);
    float* t = src;
    src = dst;
    dst = t;
  }
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? passes : -int(e);
}
