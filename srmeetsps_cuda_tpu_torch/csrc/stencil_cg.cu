// Depth CG of SRmeetsPS as one hand-written persistent CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel srmeetsps_cuda_tpu/solve/pallas_cg_vmem.py::
// _kernel_vmem_stencil (pallas_call at :1471 through
// cg_pallas_vmem_fromop[_batched], in its "full_stencil" mode with the
// energy tracked: plain CG, scaled Jacobi or in-sweep Jacobi PCG, B >= 1
// lanes), and covers _kernel_vmem_hybrid_stencil (:708), the same CG whose
// C planes the TPU re-streams from HBM on 1080p-class grids: nothing here
// depends on the grid size but the layout below. Each lane solves M x =
// rhs from the warm start x0, with M = KT^T KT + lam A^T A collapsed to a
// spatially varying 9-point stencil. The planes are the unpadded (h, w)
// row-major images of stencil_common.cuh; the lanes of a launch run at
// once.
//
// Jacobi modes (the `jacobi` argument; invd = 1 / diag(M) per lane):
//   0 PLAIN   plain CG;
//   1 SCALED  plain CG on S M S, S = diag(sqrt(invd)) (sf <= 2): the
//             prologue forms M x0 with the unscaled planes, then stores
//             C'_d[i] = (s_i C_d[i]) s_{i+d} and r' = s (rhs - M x0) and
//             starts the correction y at 0; the epilogue writes x = x0 + s
//             y and sum r'^2 / invd;
//   2 PCG     in-sweep PCG: p = invd r + beta p, rz = sum r^2 invd drives
//             alpha, beta and the energy, rr = <r, r> the stop test.
//
// Design: one cooperative launch per CG solve (persistent.cuh has the tile
// plan). G co-resident CTAs own the tiles of every lane for the whole
// solve and run, between grid barriers:
//   prologue  per tile: the 9 planes C = [C0, C+x, C-x, C+y, C-y, C+x+y,
//             C+x-y, C-x+y, C-x-y] from P11..P33, the 4 gradient masks and
//             ktw (_build_c_band), r0 = rhs - M x0, the warm-start energy
//             in residual form (_e0_band), p_old = 0, and per-tile partials
//             of <r0, r0>, the energy and (PCG) rz;
//   phase A   per tile: r and p_old (and PCG invd) of the tile and its
//             one-pixel halo, and the tile's 9 C planes (sf = 4: and
//             ktw), staged in shared memory by cp.async (zero filled
//             outside the image), the next tile's copy in flight while one
//             computes; p = z + beta p_old formed once per staged pixel
//             with __fmaf_rn, so that a halo pixel is bit for bit its
//             owner's p; w = sum_d C_d p[i + d] (+ ktw * tilesum(p) at sf
//             = 4) from the staged p; p written to the other buffer of a
//             ping-pong pair; per-tile <p, w>;
//   barrier   every CTA sums each lane's per-tile partials in tile order
//             in double and applies scal_a (std_cg.cuh) to its own copy
//             of the lane's scalars in shared memory: every CTA holds the
//             same bits, with no atomics and no one-block reduce;
//   phase B   per tile, from p and r (PCG invd) staged the same way: x +=
//             alpha p, r -= alpha w, per-tile <r, r> (and rz); barrier;
//             scal_b;
//   epilogue  (SCALED) x = x0 + sqrt(invd) y and per-tile sum r'^2 /
//             invd; barrier; the reported residual.
// Two barriers per CG iteration. A stopped lane's tiles are skipped, never
// the barriers; when no lane is active every CTA leaves the loop at the
// same iteration. CTA 0 writes the lanes' scalars once, at the end.
//
// Layouts (the ONCHIP template parameter, chosen with G by persist::launch
// from the occupancy calculator): on chip, x and w (which no neighbour
// reads) stay in shared memory across iterations and x is written out
// once at the end; in device memory they make the round trip every
// iteration, staged with p and r in phase B. The arithmetic is the same
// in both, so a lane's bits do not depend on the layout (chip_smoke.py
// holds the two layouts bit-equal on one grid).
//
// Bound: by its bytes, memory bandwidth; on the H100, instruction issue
// (PERF.md): with the tile shape compiled in for the standard blocks it
// runs at 2.3x the stream below. Per iteration phase A reads the 9 C
// planes, r and p_old and writes p (12 planes; PCG invd 13, sf = 4 ktw
// + 1), phase B reads p and r and writes r (3; PCG invd 4): 15 planes on
// chip, 19 in device memory (w written and read, x read and written),
// against about 27 flops per pixel. The earlier design moved 19 planes in
// 4 launches per iteration (two of them one-block reduces). No fast-math
// flags: sqrtf and the divisions are IEEE, so C' equals its plain PyTorch
// version bit for bit.

#include "persistent.cuh"
#include "std_cg.cuh"

namespace {

using namespace srps;
using persist::Geo;
using persist::Tile;
using persist::tile_of;

constexpr int PLAIN = 0, SCALED = 1, PCG = 2;
// Rows of per-tile partials: phase A's <p, w>; phase B's (and the
// prologue's) <r, r> and rz; the prologue's energy and the SCALED
// epilogue's residual. A row is written again only after a barrier that
// follows every CTA's reads of it.
constexpr int P_PW = 0, P_RR = 1, P_RZ = 2, P_E = 3;
// On-chip planes of the CTA's tiles: x, w.
constexpr int NON = 2;
constexpr int O_X = 0, O_W = 1;
// Planes a tile stages: phase A r and p_old (PCG invd) with the halo, then
// the 9 C planes (sf = 4: and ktw) alone; phase B p and r (PCG invd; in
// device memory x and w too) alone.
template <int MODE>
constexpr int NH_A = MODE == PCG ? 3 : 2;
constexpr int NI_A = N_STENCIL + 1;
template <int MODE, bool ONCHIP>
constexpr int NI_B = 2 + (MODE == PCG ? 1 : 0) + (ONCHIP ? 0 : 2);

// Floats of one staging buffer: the larger phase's planes.
template <int MODE, bool ONCHIP>
__host__ __device__ int stage_floats(const Geo& g) {
  const int a = NH_A<MODE> * g.sp() + NI_A * g.tile_px();
  const int b = NI_B<MODE, ONCHIP> * g.tile_px();
  return a > b ? a : b;
}
constexpr int SW = persist::SCAL_WORDS;

struct Params {
  const float* F;
  const float* R0;
  const float* Z0U;
  const float* x0;
  const float* invd;
  float* x;
  float* r;
  float* p0;
  float* p1;
  float* wv;
  float* C;
  float* part;
  float* scal;
  int sf;
  float lam, tol2;
  int max_iter;
  Geo g;
};

// The prologue at pixel (i, j) of one lane (pointers at the lane's
// planes): the C planes (C' in SCALED), r0 and p_old = 0 written; returns
// {<r0, r0> term, energy term, rz term, x's start}. Kept out of line, so
// that its registers do not crowd the CG loop's.
struct Pro {
  float rr, e, rz, x;
};

template <int MODE>
__device__ __noinline__ Pro prologue_pixel(const float* __restrict__ F,
                                           const float* __restrict__ R0,
                                           const float* __restrict__ Z0U,
                                           const float* __restrict__ x0,
                                           const float* __restrict__ invd,
                                           float* C, float* r, float* p0,
                                           size_t hw, int i, int j, int h,
                                           int w, int sf, float lam) {
  const size_t o = (size_t)i * w + j;
  float c[9];
  build_c(F, hw, i, j, h, w, lam, sf, c);
  auto X = [&](int a, int b) { return at(x0, a, b, h, w); };
  const float ts = tile_sum(X, i, j, sf);
  float mx = stencil(c, X, i, j);
  if (sf == 4) mx += F[F_KTW * hw + o] * ts;
  float rv = rhs_at(F, R0, hw, i, j, h, w, lam) - mx;
  Pro out;
  if (MODE == SCALED) {
    // M x0 above used the unscaled planes; the CG runs on S M S from y =
    // 0, and x0 stays in its input for the epilogue. Offsets (di, dj) of
    // the 9 planes, in the order of stencil().
    constexpr int DI[9] = {0, 0, 0, 1, -1, 1, -1, 1, -1};
    constexpr int DJ[9] = {0, 1, -1, 0, 0, 1, 1, -1, -1};
    const float si = sqrtf(invd[o]);
#pragma unroll
    for (int d = 0; d < 9; ++d)
      C[d * hw + o] =
          (si * c[d]) * sqrtf(at(invd, i + DI[d], j + DJ[d], h, w));
    rv = si * rv;
    out.x = 0.0f;
  } else {
#pragma unroll
    for (int d = 0; d < 9; ++d) C[d * hw + o] = c[d];
    out.x = x0[o];
  }
  r[o] = rv;
  p0[o] = 0.0f;
  out.rr = __fmul_rn(rv, rv);
  out.rz = MODE == PCG ? __fmul_rn(out.rr, invd[o]) : 0.0f;
  // Warm-start energy in residual form (_e0_band); the caller adds lam *
  // sum B^2.
  out.e = energy_at(F, R0, Z0U, hw, o, i, j, sf, lam, X, ts);
  return out;
}

template <int MODE, bool ONCHIP, int BX, int BY>
__global__ void __launch_bounds__(MAX_THREADS) cg_kernel(const Params P) {
  namespace cg = cooperative_groups;
  constexpr bool JAC = MODE == PCG;
  constexpr int NH = NH_A<MODE>;
  constexpr int NB = NI_B<MODE, ONCHIP>;
  extern __shared__ __align__(16) unsigned char raw[];
  const Geo& g = P.g;
  const persist::Shape<BX, BY> sh(g);
  const int buf = stage_floats<MODE, ONCHIP>(g);
  const persist::Smem S = persist::carve(raw, g, buf);
  cg::grid_group grid = cg::this_grid();
  const size_t hw = (size_t)g.h * g.w;
  const size_t stride = (size_t)g.B * g.tiles;
  const int n = g.count();
  const int t0 = persist::tid();
  const int sp = sh.sp(), sw = sh.sw();
  const int tpx = sh.tpx();
  const int plane = g.slots * tpx;  // stride of the on-chip planes
  // The on-chip state of tile tl: plane k at slots(tl) + k * plane.
  auto slots = [&](const Tile& tl) { return S.slots + tl.slot * tpx; };
  auto put = [&](int row, const Tile& tl, float v) {
    if (t0 == 0) P.part[row * stride + (size_t)tl.lane * g.tiles + tl.t] = v;
  };
  auto act = [&](int l) { return S.scal[l * SW + S_ACT] != 0.0f; };
  int par = 0;

  for (int k = 0; k < n; ++k) {
    const Tile tl = tile_of(g, k);
    const size_t L = tl.lane;
    float* sl = slots(tl);
    float v[3] = {0.0f, 0.0f, 0.0f};  // rr, energy, rz
    persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
      const Pro q = prologue_pixel<MODE>(
          P.F + L * F_ROWS * hw, P.R0 + L * R_ROWS * hw, P.Z0U + L * 2 * hw,
          P.x0 + L * hw, MODE != PLAIN ? P.invd + L * hw : nullptr,
          P.C + L * N_STENCIL * hw, P.r + L * hw, P.p0 + L * hw, hw, i, j,
          g.h, g.w, P.sf, P.lam);
      if (ONCHIP)
        sl[O_X * plane + py * sh.tw() + px] = q.x;
      else
        P.x[L * hw + (size_t)i * g.w + j] = q.x;
      v[0] = __fadd_rn(v[0], q.rr);
      v[1] = __fadd_rn(v[1], q.e);
      if (JAC) v[2] = __fadd_rn(v[2], q.rz);
    });
    persist::cta_sum(sh, v, S.red, par);
    par ^= 1;
    put(P_RR, tl, v[0]);
    put(P_E, tl, v[1]);
    if (JAC) put(P_RZ, tl, v[2]);
  }
  grid.sync();
  for (int l = 0; l < g.B; ++l) {
    double s[3];
    if (JAC) {
      persist::lane_sums<3>(sh, P.part, stride, {P_RR, P_E, P_RZ}, l,
                            g.tiles, S.dred, s);
    } else {
      double s2[2];
      persist::lane_sums<2>(sh, P.part, stride, {P_RR, P_E}, l, g.tiles,
                            S.dred, s2);
      s[0] = s[2] = s2[0];
      s[1] = s2[1];
    }
    if (t0 == 0)
      scal_init(S.scal + l * SW, s[0], s[1], s[2], P.tol2, P.max_iter);
  }
  __syncthreads();

  // Phase A stages ktw only at sf = 4.
  const int ni_a = N_STENCIL + (P.sf == 4 ? 1 : 0);
  for (int it = 1; it <= P.max_iter + 1; ++it) {
    bool any = false;
    for (int l = 0; l < g.B; ++l) any = any || act(l);
    if (!any) break;
    const float* p_old = (it % 2 == 1) ? P.p0 : P.p1;
    float* p_new = (it % 2 == 1) ? P.p1 : P.p0;

    // Phase A: p = z + beta p_old, w = M p, <p, w>.
    auto src_a = [&](int k, int l) -> const float* {
      const size_t L = l;
      if (k < NH)
        return (k == 0 ? P.r : k == 1 ? p_old : P.invd) + L * hw;
      if (k < NH + N_STENCIL)
        return P.C + (L * N_STENCIL + (k - NH)) * hw;
      return P.F + (L * F_ROWS + F_KTW) * hw;
    };
    persist::staged_tiles<NH, NI_A>(sh, S.stage, buf, ni_a, src_a, act,
                                    [&](const Tile& tl, float* b,
                                        int bpar) {
      const float beta = S.scal[tl.lane * SW + S_BETA];
      const float* rb = b;
      float* pb = b + sp;
      const float* ib = b + 2 * sp;
      const float* cb = b + NH * sp;  // C planes, then ktw
      persist::staged(sh, [&](int q) {
        const float z = JAC ? __fmul_rn(ib[q], rb[q]) : rb[q];
        pb[q] = __fmaf_rn(beta, pb[q], z);
      });
      __syncthreads();
      const size_t L = tl.lane;
      float* pn = p_new + L * hw;
      float* wl = P.wv + L * hw;
      float* sl = slots(tl);
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
        pn[o] = pc;
        if (ONCHIP)
          sl[O_W * plane + e] = ws;
        else
          wl[o] = ws;
        v[0] = __fadd_rn(v[0], __fmul_rn(pc, ws));
      });
      persist::cta_sum(sh, v, S.red, bpar);
      put(P_PW, tl, v[0]);
    });
    grid.sync();
    for (int l = 0; l < g.B; ++l) {
      if (!act(l)) continue;
      double s[1];
      persist::lane_sums<1>(sh, P.part, stride, {P_PW}, l, g.tiles, S.dred,
                            s);
      if (t0 == 0) scal_a(S.scal + l * SW, s[0]);
    }
    __syncthreads();

    // Phase B: x += alpha p, r -= alpha w, <r, r> (and rz), from p and r
    // (PCG invd; in device memory x and w) staged.
    auto src_b = [&](int k, int l) -> const float* {
      const float* planes[5] = {p_new, P.r, JAC ? P.invd : P.x,
                                JAC ? P.x : P.wv, P.wv};
      return planes[k] + (size_t)l * hw;
    };
    persist::staged_tiles<0, NB>(sh, S.stage, buf, NB, src_b, act,
                                 [&](const Tile& tl, float* b, int bpar) {
      const float alpha = S.scal[tl.lane * SW + S_ALPHA];
      const size_t L = tl.lane;
      const float* bp = b;
      const float* br = b + tpx;
      const float* bi = b + 2 * tpx;  // PCG
      const float* bx = b + (JAC ? 3 : 2) * tpx;  // device memory
      const float* bw = bx + tpx;
      float* xl = P.x + L * hw;
      float* rl = P.r + L * hw;
      float* sl = slots(tl);
      float v[2] = {0.0f, 0.0f};
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        const int o = i * g.w + j, e = py * sh.tw() + px;
        const float wv = ONCHIP ? sl[O_W * plane + e] : bw[e];
        const float xv = ONCHIP ? sl[O_X * plane + e] : bx[e];
        const float xn = __fmaf_rn(alpha, bp[e], xv);
        if (ONCHIP)
          sl[O_X * plane + e] = xn;
        else
          xl[o] = xn;
        const float rn = __fmaf_rn(-alpha, wv, br[e]);
        rl[o] = rn;
        const float q = __fmul_rn(rn, rn);
        v[0] = __fadd_rn(v[0], q);
        if (JAC) v[1] = __fadd_rn(v[1], __fmul_rn(q, bi[e]));
      });
      persist::cta_sum(sh, v, S.red, bpar);
      put(P_RR, tl, v[0]);
      if (JAC) put(P_RZ, tl, v[1]);
    });
    grid.sync();
    for (int l = 0; l < g.B; ++l) {
      if (!act(l)) continue;
      double s[2];
      if (JAC) {
        persist::lane_sums<2>(sh, P.part, stride, {P_RR, P_RZ}, l, g.tiles,
                              S.dred, s);
      } else {
        double s1[1];
        persist::lane_sums<1>(sh, P.part, stride, {P_RR}, l, g.tiles,
                              S.dred, s1);
        s[0] = s[1] = s1[0];
      }
      if (t0 == 0) scal_b(S.scal + l * SW, s[0], s[1], P.tol2, P.max_iter);
    }
    __syncthreads();
  }

  if (MODE == SCALED) {
    // x = x0 + sqrt(invd) y, and the plain residual <r, r> = sum r'^2 /
    // invd (pallas_cg_vmem.py:665-696), for every lane, stopped or not.
    for (int k = 0; k < n; ++k) {
      const Tile tl = tile_of(g, k);
      const size_t L = tl.lane;
      float* sl = slots(tl);
      float v[1] = {0.0f};
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        const size_t o = L * hw + (size_t)i * g.w + j;
        const float iv = __ldg(P.invd + o);
        const float y = ONCHIP ? sl[O_X * plane + py * sh.tw() + px] : P.x[o];
        // Two roundings, as in the plain version: no contraction to an FMA.
        P.x[o] = __fadd_rn(__ldg(P.x0 + o), __fmul_rn(sqrtf(iv), y));
        const float rv = P.r[o];
        v[0] = __fadd_rn(v[0],
                         iv > 0.0f ? __fdiv_rn(__fmul_rn(rv, rv), iv) : 0.0f);
      });
      persist::cta_sum(sh, v, S.red, par);
      par ^= 1;
      put(P_E, tl, v[0]);
    }
    grid.sync();
    for (int l = 0; l < g.B; ++l) {
      double s[1];
      persist::lane_sums<1>(sh, P.part, stride, {P_E}, l, g.tiles, S.dred,
                            s);
      if (t0 == 0) S.scal[l * SW + S_RR] = (float)s[0];
    }
  } else if (ONCHIP) {
    for (int k = 0; k < n; ++k) {
      const Tile tl = tile_of(g, k);
      float* sl = slots(tl);
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        P.x[tl.lane * hw + (size_t)i * g.w + j] =
            sl[O_X * plane + py * sh.tw() + px];
      });
    }
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int q = t0; q < g.B * N_SCAL; q += blockDim.x * blockDim.y)
      P.scal[q] = S.scal[(q / N_SCAL) * SW + q % N_SCAL];
}

// The kernel instance of a block: the two standard blocks (the CLI's
// default and chip_smoke.py's other) get the tile shape at compile time;
// any other block reads it at run time.
using Kernel = void (*)(Params);

template <int MODE, bool ONCHIP>
Kernel instance(const Geo& g) {
  if (g.bx == 256 && g.by == 4) return cg_kernel<MODE, ONCHIP, 256, 4>;
  if (g.bx == 32 && g.by == 16) return cg_kernel<MODE, ONCHIP, 32, 16>;
  return cg_kernel<MODE, ONCHIP, 0, 0>;
}

template <int MODE>
int run(Params p, int layout, cudaStream_t st, int* info) {
  return persist::launch(instance<MODE, true>(p.g), instance<MODE, false>(p.g),
                         p.g, stage_floats<MODE, true>(p.g),
                         stage_floats<MODE, false>(p.g), NON, layout, &p, st,
                         info);
}

}  // namespace

// The depth CG of B lanes on `stream`, one cooperative launch of CTAs of
// bx x by threads, as many and in the layout persist::launch chooses.
// Inputs, per lane: F (11, h, w), R0 (4, h, w), Z0U (2, h, w) =
// [up(masks), up(masks * z0s)], x0 (h, w), invd (h, w) or null with
// jacobi = 0. Outputs and scratch, allocated by the caller, per lane: x,
// r, p0, p1, w (h, w); C (9, h, w); part (4 rows of B x tiles per lane);
// scal (N_SCAL floats). jacobi: 0 plain CG, 1 scaled Jacobi (sf <= 2), 2
// in-sweep Jacobi PCG. layout: -1 chosen, 0 device memory, 1 on chip.
// info (host, 9 ints): CTAs, resident CTAs per SM, SMs, registers, local
// bytes, shared bytes, launches made (added to), on chip, tiles per lane.
// Returns a cudaError_t; cudaErrorCooperativeLaunchTooLarge where the CTAs
// cannot all be resident.
extern "C" int srps_stencil_cg(const void* F, const void* R0, const void* Z0U,
                               const void* x0, const void* invd, void* x,
                               void* r, void* p0, void* p1, void* wv, void* C,
                               void* part, void* scal, int B, int h, int w,
                               int sf, float lam, float tol2, int max_iter,
                               int bx, int by, int jacobi, int layout,
                               int* info, void* stream) {
  if ((jacobi != PLAIN) != (invd != nullptr) || jacobi < PLAIN ||
      jacobi > PCG || (jacobi == SCALED && sf > 2) || bx <= 0 || by <= 0 ||
      bx * by > MAX_THREADS || layout < -1 || layout > 1)
    return (int)cudaErrorInvalidValue;
  Params p{(const float*)F, (const float*)R0, (const float*)Z0U,
           (const float*)x0, (const float*)invd, (float*)x, (float*)r,
           (float*)p0, (float*)p1, (float*)wv, (float*)C, (float*)part,
           (float*)scal, sf, lam, tol2, max_iter,
           persist::make_geo(B, h, w, bx, by)};
  p.g.vec = persist::aligned16(w, {F, invd, x, r, p0, p1, wv, C});
  cudaStream_t st = (cudaStream_t)stream;
  if (jacobi == SCALED) return run<SCALED>(p, layout, st, info);
  if (jacobi == PCG) return run<PCG>(p, layout, st, info);
  return run<PLAIN>(p, layout, st, info);
}
