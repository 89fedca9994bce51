// Depth CG of SRmeetsPS through the direct mask-gated matvec, as one
// hand-written persistent CUDA kernel for Hopper (sm_90a).
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
// (and Dy^T alike over rows). The stencil kernel (stencil_cg.cu) collapses
// the same M into 9 planes; in f32 the two round differently.
//
// Forms:
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
// Design: one cooperative launch per CG solve, on persistent.cuh's tile
// plan, staging and fixed-order sums, as stencil_cg.cu. G co-resident CTAs
// own the tiles of every lane for the whole solve and run, between grid
// barriers:
//   prologue  per pixel (out of line, through the cache): x = x0, r0,
//             the energy term, p_old = 0; per-tile partials of <r0, r0>,
//             the energy and (PCG) rz;
//   phase A   per tile: r, p_old (PCG invd) and F's 10 fields [fwd_x,
//             bwd_x, fwd_y, bwd_y, P11..P33] of the tile and its one-pixel
//             halo, and the tile's ktw, staged by cp.async (zero filled
//             outside the image), the next tile's copy in flight; then
//             three passes over shared memory, a __syncthreads apart:
//             1. p = z + beta p_old at every staged pixel, rounded twice
//                as cg_loop rounds it (a halo pixel is bit for bit its
//                owner's p);
//             2. at every pixel of the tile and its ring, once: g, h,
//                t1..t3 and the products fwd_x t1, bwd_x t1, fwd_y t2,
//                bwd_y t2 and t3, written in place of P11..P23 (a P field
//                is read only at its own pixel, by the thread that
//                overwrites it);
//             3. at the tile's pixels: w = ktw tilesum(p) + lam (((fx[j-1]
//                - fx) + bxt) - bxt[j+1] + ((fy[i-1] - fy) + byt) -
//                byt[i+1] - t3) in direct_matvec's order, p written to the
//                other buffer of a ping-pong pair, per-tile <p, w>;
//             an sf = 4 tile sum lies inside the tile (tile origins are
//             multiples of 4);
//   barrier   every CTA sums each lane's per-tile partials in tile order
//             in double and applies scal_a (std_cg.cuh) to its own copy
//             of the lane's scalars;
//   phase B   as stencil_cg.cu's in device memory: per tile, from p, r,
//             (PCG invd,) x and w staged, x += alpha p, r -= alpha w,
//             per-tile <r, r> (and rz); barrier; scal_b.
// Two barriers per CG iteration; a stopped lane's tiles are skipped, never
// the barriers; the host reads no scalar. The reference's quirks hold:
// cap 100 runs 101 iterations, beta = 0 at k = 1, divisions guarded.
//
// Why a one-pixel halo is exact: M v reads v at (i, j+-2) and (i+-2, j)
// only through g or h at a ring pixel, and there fwd and bwd are
// exclusive: the difference across the ring's outer edge is multiplied by
// a mask that is 0 whenever the ring pixel's t1 (t2) reaches the tile
// with a nonzero factor. Pass 2 reads that neighbour from the staged
// plane's margin columns or the neighbouring plane's edge row (r above p,
// invd or fwd_x below it, neither written in pass 2); the buffers are
// zeroed at the start and hold only finite staged values afterwards, so
// every such product is an exact 0. (tests/test_torch_direct_cg.py holds
// a CPU model of this staging geometry bit for bit to direct_matvec.)
//
// Layout: device memory only. x and w make the round trip every iteration,
// staged with p and r in phase B. The staged F fields fill most of the
// shared memory (about 160 KB a CTA at 256 x 4), so keeping x and w on
// chip as the stencil and CGS kernels do would fit only at fewer resident
// CTAs per SM, or on grids the direct route does not serve.
//
// Bytes: per iteration phase A reads F's 11 planes, r and p_old and writes
// p, phase B reads p, r, x and w and writes r and x, with w written in
// phase A: 21 f32 planes (PCG 23, invd twice), against about 50 flops per
// pixel. On the H100 it takes about 1.9x (960 x 1280) and 1.5x (4K) that
// stream's time (PERF.md): its time is not set by those bytes alone, and
// which part sets the rest is not yet attributed. The earlier design read
// F at 5 points per pixel through the cache and recomputed 5 gradients per
// pixel in 4 launches per iteration.

#include "persistent.cuh"
#include "std_cg.cuh"

namespace {

using namespace srps;
using persist::Geo;
using persist::Tile;
using persist::tile_of;

// Rows of per-tile partials: phase A's <p, w>; phase B's (and the
// prologue's) <r, r> and rz; the prologue's energy. A row is written again
// only after a barrier that follows every CTA's reads of it.
constexpr int P_PW = 0, P_RR = 1, P_RZ = 2, P_E = 3;
constexpr int SW = persist::SCAL_WORDS;
// Phase A's planes with the halo: r, p_old (PCG invd), then F's fields in
// the order below, from plane A_F on; the tile's ktw alone after them.
// Pass 2 writes its products in place of P11..P23.
constexpr int A_R = 0, A_P = 1, A_I = 2;
template <bool JAC>
constexpr int A_F = JAC ? 3 : 2;
constexpr int H_AX = 0, H_BX = 1, H_AY = 2, H_BY = 3, H_P11 = 4, H_P12 = 5,
              H_P13 = 6, H_P22 = 7, H_P23 = 8, H_P33 = 9;
constexpr int N_FIELDS = 10;
constexpr int T_FX = H_P11, T_BX = H_P12, T_FY = H_P13, T_BY = H_P22,
              T_T3 = H_P23;
template <bool JAC>
constexpr int NH_A = A_F<JAC> + N_FIELDS;
// Phase B: p, r, (PCG invd,) x and w, tile alone.
template <bool JAC>
constexpr int NI_B = 4 + (JAC ? 1 : 0);

// Floats of one staging buffer: the larger phase's planes.
template <bool JAC>
__host__ __device__ int stage_floats(const Geo& g) {
  const int a = NH_A<JAC> * g.sp() + g.tile_px();
  const int b = NI_B<JAC> * g.tile_px();
  return a > b ? a : b;
}

// The F row of staged field f (H_*).
__device__ __forceinline__ int f_row(int f) {
  return f < 4 ? F_AX + f : F_P11 + (f - 4);
}

struct Params {
  const float* F;
  const float* R0;
  const float* Z0U;
  const float* x0;
  const float* b;
  const float* invd;
  float* x;
  float* r;
  float* p0;
  float* p1;
  float* wv;
  float* part;
  float* scal;
  int sf;
  float lam, tol2;
  int max_iter;
  int energy;
  Geo g;
};

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

// (M v)(i, j) through the gradient masks and the P fields read through the
// cache (_matvec_band): the prologue's M x0.
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

// The prologue at pixel (i, j) of one lane (pointers at the lane's planes;
// R0 and Z0U null where not read): r0 and p_old = 0 written; returns {<r0,
// r0> term, energy term, rz term, x's start}. Kept out of line, so that
// its registers do not crowd the CG loop's.
struct Pro {
  float rr, e, rz, x;
};

template <bool JAC>
__device__ __noinline__ Pro prologue_pixel(
    const float* __restrict__ F, const float* __restrict__ R0,
    const float* __restrict__ Z0U, const float* __restrict__ x0,
    const float* __restrict__ b, const float* __restrict__ invd, float* r,
    float* p0, size_t hw, int i, int j, int h, int w, int sf, float lam) {
  const size_t o = (size_t)i * w + j;
  Pro out;
  out.e = 0.0f;
  float rv;
  if (b != nullptr) {
    rv = b[o];
  } else {
    auto X = [&](int a, int c) { return at(x0, a, c, h, w); };
    rv = rhs_at(F, R0, hw, i, j, h, w, lam) -
         direct_mv(F, hw, i, j, h, w, sf, lam, X);
    // Warm-start energy in residual form (_e0_band); the caller adds lam *
    // sum B^2.
    if (Z0U != nullptr)
      out.e = energy_at(F, R0, Z0U, hw, o, i, j, sf, lam, X,
                        tile_sum(X, i, j, sf));
  }
  r[o] = rv;
  p0[o] = 0.0f;
  out.x = x0[o];
  out.rr = __fmul_rn(rv, rv);
  out.rz = JAC ? __fmul_rn(out.rr, invd[o]) : 0.0f;
  return out;
}

// Sum of a staged plane over the aligned sf x sf tile holding tile pixel
// (py, px).
__device__ __forceinline__ float tile_sum_staged(const float* plane, int sw,
                                                 int py, int px, int sf) {
  if (sf == 4) return persist::tile_sum4_staged(plane, sw, py, px);
  if (sf == 1) return plane[(py + 1) * sw + px + persist::HX];
  const float* v = plane + (py - py % 2 + 1) * sw + (px - px % 2 + persist::HX);
  return (v[0] + v[1]) + (v[sw] + v[sw + 1]);
}

template <bool JAC, int BX, int BY>
__global__ void __launch_bounds__(MAX_THREADS) direct_kernel(const Params P) {
  namespace cg = cooperative_groups;
  constexpr int NH = NH_A<JAC>;
  constexpr int FB = A_F<JAC>;
  constexpr int NB = NI_B<JAC>;
  extern __shared__ __align__(16) unsigned char raw[];
  const Geo& g = P.g;
  const persist::Shape<BX, BY> sh(g);
  const int buf = stage_floats<JAC>(g);
  const persist::Smem S = persist::carve(raw, g, buf);
  cg::grid_group grid = cg::this_grid();
  const size_t hw = (size_t)g.h * g.w;
  const size_t stride = (size_t)g.B * g.tiles;
  const int n = g.count();
  const int t0 = persist::tid();
  const int nt = sh.nt();
  const int sp = sh.sp(), sw = sh.sw();
  const int tpx = sh.tpx(), tw = sh.tw();
  auto put = [&](int row, const Tile& tl, float v) {
    if (t0 == 0) P.part[row * stride + (size_t)tl.lane * g.tiles + tl.t] = v;
  };
  auto act = [&](int l) { return S.scal[l * SW + S_ACT] != 0.0f; };
  int par = 0;

  // Both staging buffers zeroed: pass 2 reads margins that float-by-float
  // staging never writes (the barriers below order this before any copy).
  for (int q = t0; q < 2 * buf; q += nt) S.stage[q] = 0.0f;

  for (int k = 0; k < n; ++k) {
    const Tile tl = tile_of(g, k);
    const size_t L = tl.lane;
    float v[3] = {0.0f, 0.0f, 0.0f};  // rr, energy, rz
    persist::pixels(sh, tl, [&](int, int, int i, int j) {
      const Pro q = prologue_pixel<JAC>(
          P.F + L * F_ROWS * hw,
          P.R0 != nullptr ? P.R0 + L * R_ROWS * hw : nullptr,
          P.energy ? P.Z0U + L * 2 * hw : nullptr, P.x0 + L * hw,
          P.b != nullptr ? P.b + L * hw : nullptr,
          JAC ? P.invd + L * hw : nullptr, P.r + L * hw, P.p0 + L * hw, hw,
          i, j, g.h, g.w, P.sf, P.lam);
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

  for (int it = 1; it <= P.max_iter + 1; ++it) {
    bool any = false;
    for (int l = 0; l < g.B; ++l) any = any || act(l);
    if (!any) break;
    const float* p_old = (it % 2 == 1) ? P.p0 : P.p1;
    float* p_new = (it % 2 == 1) ? P.p1 : P.p0;

    // Phase A: p = z + beta p_old, w = M p, <p, w>.
    auto src_a = [&](int k, int l) -> const float* {
      const size_t L = l;
      if (k == A_R) return P.r + L * hw;
      if (k == A_P) return p_old + L * hw;
      if (JAC && k == A_I) return P.invd + L * hw;
      const int row = k == NH ? F_KTW : f_row(k - FB);
      return P.F + (L * F_ROWS + row) * hw;
    };
    persist::staged_tiles<NH, 1>(sh, S.stage, buf, 1, src_a, act,
                                 [&](const Tile& tl, float* b, int bpar) {
      const float beta = S.scal[tl.lane * SW + S_BETA];
      const float* rb = b + A_R * sp;
      float* pb = b + A_P * sp;
      const float* ib = b + A_I * sp;  // PCG
      float* fb = b + FB * sp;
      const float* kt = b + NH * sp;
      // 1. p at every staged float of the plane, margins included.
      for (int q = t0; q < sp; q += nt) {
        const float z = JAC ? __fmul_rn(ib[q], rb[q]) : rb[q];
        pb[q] = __fadd_rn(z, __fmul_rn(beta, pb[q]));
      }
      __syncthreads();
      // 2. The products at the tile and its ring, rw x (th + 2) pixels.
      const int rw = tw + 2, rn = (sh.th() + 2) * rw;
      for (int k = t0; k < rn; k += nt) {
        const int a = k / rw;
        const int q = a * sw + (k - a * rw) + (persist::HX - 1);
        const float pc = pb[q];
        const float ax = fb[H_AX * sp + q], bx = fb[H_BX * sp + q];
        const float ay = fb[H_AY * sp + q], by = fb[H_BY * sp + q];
        const float gx = ax * (pb[q + 1] - pc) + bx * (pc - pb[q - 1]);
        const float gy = ay * (pb[q + sw] - pc) + by * (pc - pb[q - sw]);
        const float p11 = fb[H_P11 * sp + q], p12 = fb[H_P12 * sp + q];
        const float p13 = fb[H_P13 * sp + q], p22 = fb[H_P22 * sp + q];
        const float p23 = fb[H_P23 * sp + q], p33 = fb[H_P33 * sp + q];
        const float t1 = p11 * gx + p12 * gy - p13 * pc;
        const float t2 = p12 * gx + p22 * gy - p23 * pc;
        const float t3 = p13 * gx + p23 * gy - p33 * pc;
        fb[T_FX * sp + q] = ax * t1;
        fb[T_BX * sp + q] = bx * t1;
        fb[T_FY * sp + q] = ay * t2;
        fb[T_BY * sp + q] = by * t2;
        fb[T_T3 * sp + q] = t3;
      }
      __syncthreads();
      // 3. w at the tile's pixels.
      const float* fx = fb + T_FX * sp;
      const float* bxt = fb + T_BX * sp;
      const float* fy = fb + T_FY * sp;
      const float* byt = fb + T_BY * sp;
      const float* t3b = fb + T_T3 * sp;
      const size_t L = tl.lane;
      float* pn = p_new + L * hw;
      float* wl = P.wv + L * hw;
      float v[1] = {0.0f};
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        const int o = i * g.w + j, e = py * tw + px;
        const int q = sh.sq(py, px);
        const float dxt = ((fx[q - 1] - fx[q]) + bxt[q]) - bxt[q + 1];
        const float dyt = ((fy[q - sw] - fy[q]) + byt[q]) - byt[q + sw];
        const float ata = (dxt + dyt) - t3b[q];
        const float ws =
            kt[e] * tile_sum_staged(pb, sw, py, px, P.sf) + P.lam * ata;
        const float pc = pb[q];
        pn[o] = pc;
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

    // Phase B: x += alpha p, r -= alpha w, <r, r> (and rz), from p, r,
    // (PCG invd,) x and w staged.
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
      const float* bx = b + (JAC ? 3 : 2) * tpx;
      const float* bw = bx + tpx;
      float* xl = P.x + L * hw;
      float* rl = P.r + L * hw;
      float v[2] = {0.0f, 0.0f};
      persist::pixels(sh, tl, [&](int py, int px, int i, int j) {
        const int o = i * g.w + j, e = py * tw + px;
        xl[o] = __fmaf_rn(alpha, bp[e], bx[e]);
        const float rn = __fmaf_rn(-alpha, bw[e], br[e]);
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

  __syncthreads();
  if (blockIdx.x == 0)
    for (int q = t0; q < g.B * N_SCAL; q += nt)
      P.scal[q] = S.scal[(q / N_SCAL) * SW + q % N_SCAL];
}

// The kernel instance of a block: the two standard blocks get the tile
// shape at compile time; any other block reads it at run time.
using Kernel = void (*)(Params);

template <bool JAC>
Kernel instance(const Geo& g) {
  if (g.bx == 256 && g.by == 4) return direct_kernel<JAC, 256, 4>;
  if (g.bx == 32 && g.by == 16) return direct_kernel<JAC, 32, 16>;
  return direct_kernel<JAC, 0, 0>;
}

// The device layout alone (persist::launch's layout 0, no on-chip planes).
template <bool JAC>
int run(Params p, cudaStream_t st, int* info) {
  const Kernel k = instance<JAC>(p.g);
  const int buf = stage_floats<JAC>(p.g);
  return persist::launch(k, k, p.g, buf, buf, 0, 0, &p, st, info);
}

}  // namespace

// The direct-matvec depth CG of B lanes on `stream`, one cooperative
// launch of CTAs of bx x by threads, as many and in the layout
// persist::launch chooses. Inputs, per lane: F (11, h, w), x0 (h, w);
// either R0 (4, h, w) (r0 built in the kernel) or b (h, w) (the residual
// given), the other null; Z0U (2, h, w) with energy = 1 (r0 in the kernel
// only), else null; invd (h, w) for Jacobi PCG, else null. Outputs and
// scratch, allocated by the caller, per lane: x, r, p0, p1, w (h, w);
// part (4 rows of B x tiles per lane); scal (N_SCAL floats). layout: -1
// chosen or 0, device memory (the only layout; 1, on chip, is refused as
// an invalid value). info (host, 9 ints): CTAs, resident
// CTAs per SM, SMs, registers, local bytes, shared bytes, launches made
// (added to), on chip, tiles per lane. Returns a cudaError_t;
// cudaErrorCooperativeLaunchTooLarge where the CTAs cannot all be
// resident.
extern "C" int srps_direct_cg(const void* F, const void* R0, const void* Z0U,
                              const void* x0, const void* b, const void* invd,
                              void* x, void* r, void* p0, void* p1, void* wv,
                              void* part, void* scal, int B, int h, int w,
                              int sf, float lam, float tol2, int max_iter,
                              int bx, int by, int energy, int layout,
                              int* info, void* stream) {
  if ((R0 == nullptr) == (b == nullptr) ||
      (energy != 0) != (Z0U != nullptr) || (energy && b != nullptr) ||
      (sf != 1 && sf != 2 && sf != 4) || bx <= 0 || by <= 0 ||
      bx * by > MAX_THREADS || layout < -1 || layout > 0)
    return (int)cudaErrorInvalidValue;
  Params p{(const float*)F, (const float*)R0, (const float*)Z0U,
           (const float*)x0, (const float*)b, (const float*)invd, (float*)x,
           (float*)r, (float*)p0, (float*)p1, (float*)wv, (float*)part,
           (float*)scal, sf, lam, tol2, max_iter, energy,
           persist::make_geo(B, h, w, bx, by)};
  p.g.vec = persist::aligned16(w, {F, invd, x, r, p0, p1, wv});
  cudaStream_t st = (cudaStream_t)stream;
  if (invd != nullptr) return run<true>(p, st, info);
  return run<false>(p, st, info);
}
