// Chronopoulos-Gear depth CG of SRmeetsPS as one hand-written persistent
// CUDA kernel for Hopper (sm_90a).
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
// Design: one cooperative launch per CG solve, G co-resident CTAs owning
// the tiles of every lane for the whole solve (persistent.cuh):
//   prologue  the C planes, x = x0, p = s = 0, r0 = rhs - M x0; barrier;
//             w0 = M r0 and per-tile partials of gamma0 and delta0;
//             barrier; cgs::update (cgs_common.cuh) of every lane;
//   iteration per tile: r, w and s of the tile and its one-pixel halo,
//             and the tile's 9 C planes (in device memory x and p, at sf =
//             4 ktw), staged in shared memory by cp.async (the next tile's
//             copy in flight while one computes); s' and r' formed once
//             per staged pixel with __fmaf_rn, so that a halo pixel is bit
//             for bit its owner's r'; p and x at the tile's pixels; w' =
//             M r' (+ ktw * tilesum(r') at sf = 4) from the staged r'; r',
//             w', s' written to the other of two (r, w, s) buffer sets,
//             which removes the hazard of a neighbour's r being
//             overwritten in the same pass (pallas_cg_cgs.py:56-61);
//             per-tile partials of gamma' and delta' (in one of two row
//             pairs, alternating, so that no CTA overwrites a row another
//             still sums); one barrier; every CTA sums each lane's
//             partials in tile order in double and applies cgs::update to
//             its own copy of the lane's scalars.
// One barrier per CG iteration. A stopped lane's tiles are skipped, never
// the barrier. CTA 0 writes the lanes' scalars at the end. Like the TPU
// kernel, no energy is tracked; the caller evaluates it at the result.
//
// Layouts (ONCHIP, chosen with G by persist::launch): on chip, x
// and p (which no neighbour reads) stay in shared memory for the whole
// solve and x is written out once; in device memory they make the round
// trip every iteration. The arithmetic is the same in both.
//
// Bound: by its bytes, memory bandwidth; on the H100, instruction issue
// (PERF.md), at 1.8x the stream below. Per iteration a tile reads the 9 C
// planes and one (r, w, s) set and writes the other (15 f32 planes on
// chip; sf = 4 ktw + 1), or also reads and writes x and p (19) in device
// memory, against about 29 flops per pixel. The earlier design moved the
// same 19 planes in 2 launches per iteration, one of them a one-block
// reduce.

#include "cgs_common.cuh"
#include "persistent.cuh"

namespace {

using namespace srps;
using persist::Geo;
using persist::Tile;
using persist::tile_of;

// Planes of the (r, w, s) buffer pair, per lane: [r, w, s] of set 0, then
// of set 1.
constexpr int RWS_ROWS = 6;
// On-chip planes of the CTA's tiles: x, p.
constexpr int NON = 2;
constexpr int O_X = 0, O_P = 1;
constexpr int SW = persist::SCAL_WORDS;
// Planes a tile stages: r, w, s of the set read, with the halo; then the
// 9 C planes, in device memory x and p, and at sf = 4 ktw, alone.
constexpr int NH = 3;
template <bool ONCHIP>
constexpr int NI = N_STENCIL + (ONCHIP ? 0 : 2) + 1;

template <bool ONCHIP>
__host__ __device__ int stage_floats(const Geo& g) {
  return NH * g.sp() + NI<ONCHIP> * g.tile_px();
}

struct Params {
  const float* F;
  const float* R0;
  const float* x0;
  float* x;
  float* p;
  float* rws;
  float* C;
  float* part;
  float* scal;
  int sf;
  float lam, tol2;
  int max_iter;
  Geo g;
};

// The prologue at pixel (i, j) of one lane (pointers at the lane's
// planes): the C planes, r0 and s0 = 0 (set 0) written. Kept out of line,
// so that its registers do not crowd the CG loop's.
__device__ __noinline__ void prologue_pixel(const float* __restrict__ F,
                                            const float* __restrict__ R0,
                                            const float* __restrict__ x0,
                                            float* C, float* rws, size_t hw,
                                            int i, int j, int h, int w,
                                            int sf, float lam) {
  const size_t o = (size_t)i * w + j;
  float c[9];
  build_c(F, hw, i, j, h, w, lam, sf, c);
#pragma unroll
  for (int d = 0; d < 9; ++d) C[d * hw + o] = c[d];
  auto X = [&](int a, int b) { return at(x0, a, b, h, w); };
  float mx = stencil(c, X, i, j);
  if (sf == 4) mx += F[F_KTW * hw + o] * tile_sum(X, i, j, 4);
  rws[o] = rhs_at(F, R0, hw, i, j, h, w, lam) - mx;
  rws[2 * hw + o] = 0.0f;
}

template <bool ONCHIP, int BX, int BY>
__global__ void __launch_bounds__(MAX_THREADS) cgs_kernel(const Params P) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char raw[];
  const Geo& g = P.g;
  const persist::Shape<BX, BY> sh(g);
  const int buf = stage_floats<ONCHIP>(g);
  const persist::Smem S = persist::carve(raw, g, buf);
  cg::grid_group grid = cg::this_grid();
  const size_t hw = (size_t)g.h * g.w;
  const int ihw = g.h * g.w;
  const size_t stride = (size_t)g.B * g.tiles;
  const int n = g.count();
  const int t0 = persist::tid();
  const int sw = sh.sw();
  const int tpx = sh.tpx();
  const int plane = g.slots * tpx;  // stride of the on-chip planes
  auto slots = [&](const Tile& tl) { return S.slots + tl.slot * tpx; };
  auto put = [&](int row, const Tile& tl, float v) {
    if (t0 == 0) P.part[row * stride + (size_t)tl.lane * g.tiles + tl.t] = v;
  };
  auto act = [&](int l) { return S.scal[l * SW + cgs::S_ACT] != 0.0f; };
  int par = 0;

  // Prologue: C, x = x0, p = 0, r0 (set 0), s0 = 0 (set 0).
  for (int k = 0; k < n; ++k) {
    const Tile tl = tile_of(g, k);
    const size_t L = tl.lane;
    float* sl = slots(tl);
    persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
      prologue_pixel(P.F + L * F_ROWS * hw, P.R0 + L * R_ROWS * hw,
                     P.x0 + L * hw, P.C + L * N_STENCIL * hw,
                     P.rws + L * RWS_ROWS * hw, hw, i, j, g.h, g.w, P.sf,
                     P.lam);
      const size_t o = L * hw + (size_t)i * g.w + j;
      if (ONCHIP) {
        sl[O_X * plane + py * sh.tw() + px] = P.x0[o];
        sl[O_P * plane + py * sh.tw() + px] = 0.0f;
      } else {
        P.x[o] = P.x0[o];
        P.p[o] = 0.0f;
      }
    });
  }
  grid.sync();
  // w0 = M r0 (set 0) and the partials of gamma0, delta0 (rows 0, 1).
  for (int k = 0; k < n; ++k) {
    const Tile tl = tile_of(g, k);
    const size_t L = tl.lane;
    const float* C = P.C + L * N_STENCIL * hw;
    const float* ktw = P.F + L * F_ROWS * hw + F_KTW * hw;
    float* rws = P.rws + L * RWS_ROWS * hw;
    float v[2] = {0.0f, 0.0f};
    persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
      const int o = i * g.w + j;
      float c[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) c[d] = C[d * ihw + o];
      // r0 of other CTAs' tiles: read through L2, after the barrier.
      auto R = [&](int a, int b) {
        return inside(a, b, g.h, g.w) ? __ldcg(rws + a * g.w + b) : 0.0f;
      };
      float wv = stencil(c, R, i, j);
      if (P.sf == 4) wv += __ldg(ktw + o) * tile_sum(R, i, j, 4);
      rws[ihw + o] = wv;
      const float rv = rws[o];
      v[0] = __fadd_rn(v[0], __fmul_rn(rv, rv));
      v[1] = __fadd_rn(v[1], __fmul_rn(wv, rv));
    });
    persist::cta_sum(sh, v, S.red, par);
    par ^= 1;
    put(0, tl, v[0]);
    put(1, tl, v[1]);
  }
  grid.sync();
  for (int l = 0; l < g.B; ++l) {
    double s[2];
    persist::lane_sums<2>(sh, P.part, stride, {0, 1}, l, g.tiles, S.dred,
                          s);
    if (t0 == 0)
      cgs::update(S.scal + l * SW, s[0], s[1], P.tol2, P.max_iter, true);
  }
  __syncthreads();

  const int ni = NI<ONCHIP> - (P.sf == 4 ? 0 : 1);
  for (int it = 1; it <= P.max_iter + 1; ++it) {
    bool any = false;
    for (int l = 0; l < g.B; ++l) any = any || act(l);
    if (!any) break;
    // Sweep `it` reads set (it + 1) % 2 and writes set it % 2 (set 0
    // holds r0); its partials go to rows 2 (it % 2) and 2 (it % 2) + 1.
    const int src = (it + 1) % 2;
    const int row = 2 * (it % 2);
    auto from = [&](int k, int l) -> const float* {
      const size_t L = l;
      if (k < NH) return P.rws + (L * RWS_ROWS + 3 * src + k) * hw;
      k -= NH;
      if (k < N_STENCIL) return P.C + (L * N_STENCIL + k) * hw;
      k -= N_STENCIL;
      if (!ONCHIP && k < 2) return (k == 0 ? P.x : P.p) + L * hw;
      return P.F + (L * F_ROWS + F_KTW) * hw;
    };
    persist::staged_tiles<NH, NI<ONCHIP>>(sh, S.stage, buf, ni, from, act,
                                         [&](const Tile& tl, float* b,
                                             int bpar) {
      const float* sc = S.scal + tl.lane * SW;
      const float alpha = sc[cgs::S_ALPHA], beta = sc[cgs::S_BETA];
      const float* rb = b;          // r
      float* wb = b + sh.sp();       // w, then r'
      float* sb = b + 2 * sh.sp();   // s, then s'
      const float* cb = b + NH * sh.sp();  // C, (x, p), ktw
      const float* bx = cb + N_STENCIL * tpx;  // device memory
      const float* bp = bx + tpx;
      const float* bk = cb + (NI<ONCHIP> - 1) * tpx;  // ktw at sf = 4
      persist::staged(sh, [&](int q) {
        const float sn = __fmaf_rn(beta, sb[q], wb[q]);
        wb[q] = __fmaf_rn(-alpha, sn, rb[q]);
        sb[q] = sn;
      });
      __syncthreads();
      const size_t L = tl.lane;
      float* rn = P.rws + (L * RWS_ROWS + 3 * (1 - src)) * hw;
      float* xl = P.x + L * hw;
      float* pl = P.p + L * hw;
      float* sl = slots(tl);
      float v[2] = {0.0f, 0.0f};
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        const int o = i * g.w + j, e = py * sh.tw() + px;
        float c[9];
#pragma unroll
        for (int d = 0; d < 9; ++d) c[d] = cb[d * tpx + e];
        const int q = sh.sq(py, px);
        const float p_old = ONCHIP ? sl[O_P * plane + e] : bp[e];
        const float x_old = ONCHIP ? sl[O_X * plane + e] : bx[e];
        const float pv = __fmaf_rn(beta, p_old, rb[q]);
        const float xv = __fmaf_rn(alpha, pv, x_old);
        if (ONCHIP) {
          sl[O_P * plane + e] = pv;
          sl[O_X * plane + e] = xv;
        } else {
          pl[o] = pv;
          xl[o] = xv;
        }
        const float rv = wb[q];
        float wv = persist::stencil_staged(c, wb + q, sw);
        if (P.sf == 4)
          wv = __fmaf_rn(bk[e], persist::tile_sum4_staged(wb, sw, py, px),
                         wv);
        rn[o] = rv;
        rn[hw + o] = wv;
        rn[2 * hw + o] = sb[q];
        v[0] = __fadd_rn(v[0], __fmul_rn(rv, rv));
        v[1] = __fadd_rn(v[1], __fmul_rn(wv, rv));
      });
      persist::cta_sum(sh, v, S.red, bpar);
      put(row, tl, v[0]);
      put(row + 1, tl, v[1]);
    });
    grid.sync();
    for (int l = 0; l < g.B; ++l) {
      if (!act(l)) continue;
      double s[2];
      persist::lane_sums<2>(sh, P.part, stride, {row, row + 1}, l, g.tiles,
                            S.dred, s);
      if (t0 == 0)
        cgs::update(S.scal + l * SW, s[0], s[1], P.tol2, P.max_iter, false);
    }
    __syncthreads();
  }

  if (ONCHIP) {
    for (int k = 0; k < n; ++k) {
      const Tile tl = tile_of(g, k);
      float* sl = slots(tl);
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        P.x[tl.lane * hw + (size_t)i * g.w + j] =
            sl[O_X * plane + py * sh.tw() + px];
      });
    }
  }
  if (blockIdx.x == 0)
    for (int q = t0; q < g.B * cgs::N_SCAL; q += blockDim.x * blockDim.y)
      P.scal[q] = S.scal[(q / cgs::N_SCAL) * SW + q % cgs::N_SCAL];
}

using Kernel = void (*)(Params);

// The kernel instance of a block: the two standard blocks get the tile
// shape at compile time.
template <bool ONCHIP>
Kernel instance(const Geo& g) {
  if (g.bx == 256 && g.by == 4) return cgs_kernel<ONCHIP, 256, 4>;
  if (g.bx == 32 && g.by == 16) return cgs_kernel<ONCHIP, 32, 16>;
  return cgs_kernel<ONCHIP, 0, 0>;
}

}  // namespace

// The Chronopoulos-Gear depth CG of B lanes on `stream`, one cooperative
// launch of CTAs of bx x by threads, as many and in the layout
// persist::launch chooses. Inputs, per lane: F (11, h, w), R0 (4, h, w),
// x0 (h, w). Outputs and scratch, allocated by the caller, per lane: x, p
// (h, w); rws (6, h, w); C (9, h, w); part (4 rows of B x tiles per lane);
// scal (9 floats: gamma = r1 in slot 0, iters in slot 7). layout and info
// as srps_stencil_cg's. Returns a cudaError_t.
extern "C" int srps_cgs_cg(const void* F, const void* R0, const void* x0,
                           void* x, void* p, void* rws, void* C, void* part,
                           void* scal, int B, int h, int w, int sf, float lam,
                           float tol2, int max_iter, int bx, int by,
                           int layout, int* info, void* stream) {
  if (bx <= 0 || by <= 0 || bx * by > MAX_THREADS || layout < -1 ||
      layout > 1)
    return (int)cudaErrorInvalidValue;
  Params prm{(const float*)F, (const float*)R0, (const float*)x0, (float*)x,
             (float*)p, (float*)rws, (float*)C, (float*)part, (float*)scal,
             sf, lam, tol2, max_iter, persist::make_geo(B, h, w, bx, by)};
  prm.g.vec = persist::aligned16(w, {F, x, p, rws, C});
  return persist::launch(instance<true>(prm.g), instance<false>(prm.g),
                         prm.g, stage_floats<true>(prm.g),
                         stage_floats<false>(prm.g), NON, layout, &prm,
                         (cudaStream_t)stream, info);
}
