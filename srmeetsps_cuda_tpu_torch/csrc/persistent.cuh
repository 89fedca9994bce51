// The pieces of the persistent cooperative depth-CG kernels (stencil_cg.cu,
// cgs_cg.cu, direct_cg.cu, shard_cg.cu): the tile plan, staging with
// cp.async, fixed-order sums and the cooperative launch.
//
// The kernels are bound by instruction issue (PERF.md), so the two standard
// blocks (256 x 4, 32 x 16) get the tile shape as template parameters
// (Shape<BX, BY>: constant offsets and trip counts); other blocks read it
// at run time (Shape<0, 0>).
//
// Tile plan (solve/stencil_cg.py::tile_plan computes the same tiles;
// launch() below chooses G and the layout): the CTA's thread shape (bx,
// by) rounded up to multiples of 4 is the tile, th = 4 ceil(by / 4) rows
// by tw = 4 ceil(bx / 4) columns, and each thread handles the pixels (ty
// + a by, tx + b bx) of a tile. Each lane is cut
// into tiles_x x tiles_y tiles from (0, 0), so a tile's origin and its
// edges are multiples of 4 and an sf = 4 tile sum stays inside one tile;
// tiles past the image's right or bottom edge are partial. Tile t of lane
// l is the launch's tile g = l T + t (T tiles per lane); CTA c of the G
// co-resident CTAs owns the tiles g = c, c + G, c + 2G, ..., the k-th in
// its slot k, for the whole solve. The tile grid depends only on (h, w,
// block), never on B or G, and each tile's partial sums come from the
// same threads in the same order whichever CTA owns it: a lane's result
// is bit for bit that of its solo launch.
//
// Shared memory of a CTA, in order: ND_MAX x 32 doubles (warp sums of the
// lane sums), 2 x ND_MAX x 32 floats (warp sums of the tile sums, two
// sets), B x SCAL_WORDS floats rounded up to a multiple of 4 (every lane's
// scalars), two staging buffers of `buf` floats each (a tile's planes: some
// with their one-pixel halo, th + 2 rows of tw + 8 floats with the tile's
// first column at HX, so that rows start on 16 bytes; some without, th x
// tw; the next tile's copy is in flight while one computes) and, in the
// on-chip layout, NON planes of slots x th x tw (the pointwise state of the
// CTA's tiles). Where the image's rows and the planes start on 16 bytes
// (`vec`), tiles are copied in 16-byte pieces, else float by float.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <initializer_list>

#include "stencil_common.cuh"

namespace persist {

constexpr int ND_MAX = 3;
constexpr int SCAL_WORDS = 10;
// The staged column of a tile's first column.
constexpr int HX = 4;
// Slots of the info array the C entries fill for the wrapper.
constexpr int I_CTAS = 0, I_OCC = 1, I_SMS = 2, I_REGS = 3, I_LOCAL = 4,
              I_SMEM = 5, I_LAUNCHES = 6, I_ONCHIP = 7, I_TILES = 8;

struct Geo {
  int B, h, w;
  int bx, by;
  int th, tw;
  int tiles_x, tiles;  // per lane
  int G, slots;
  int vec;  // 16-byte copies
  __host__ __device__ int sw() const { return tw + 2 * HX; }
  __host__ __device__ int sp() const { return (th + 2) * sw(); }
  __host__ __device__ int tile_px() const { return th * tw; }
  // Tiles of CTA c.
  __device__ int count() const {
    const int n = B * tiles, c = blockIdx.x;
    return c < n ? (n - 1 - c) / G + 1 : 0;
  }
};

// The tiles of a launch; launch() sets G and slots.
inline Geo make_geo(int B, int h, int w, int bx, int by) {
  Geo g;
  g.B = B;
  g.h = h;
  g.w = w;
  g.bx = bx;
  g.by = by;
  g.th = (by + 3) / 4 * 4;
  g.tw = (bx + 3) / 4 * 4;
  g.tiles_x = (w + g.tw - 1) / g.tw;
  g.tiles = g.tiles_x * ((h + g.th - 1) / g.th);
  g.G = g.slots = 0;
  g.vec = 0;
  return g;
}

// Dynamic shared memory of a CTA (the layout above).
__host__ __device__ inline int scal_floats(const Geo& g) {
  return (g.B * SCAL_WORDS + 3) / 4 * 4;
}

inline size_t smem_bytes(const Geo& g, int buf, int non, bool onchip) {
  return sizeof(double) * ND_MAX * 32 +
         sizeof(float) * (2 * ND_MAX * 32 + (size_t)scal_floats(g) +
                          2 * (size_t)buf +
                          (onchip ? (size_t)non * g.slots * g.tile_px() : 0));
}

struct Smem {
  double* dred;
  float* red;
  float* scal;
  float* stage;  // two buffers of `buf` floats
  float* slots;  // non planes of slots x tile_px (on-chip layout)
};

__device__ inline Smem carve(unsigned char* raw, const Geo& g, int buf) {
  Smem s;
  s.dred = reinterpret_cast<double*>(raw);
  s.red = reinterpret_cast<float*>(s.dred + ND_MAX * 32);
  s.scal = s.red + 2 * ND_MAX * 32;
  s.stage = s.scal + scal_floats(g);
  s.slots = s.stage + 2 * buf;
  return s;
}

// Whether rows of w floats and every plane start on 16 bytes.
inline bool aligned16(int w, std::initializer_list<const void*> planes) {
  if (w % 4 != 0) return false;
  for (const void* p : planes)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return false;
  return true;
}

struct Tile {
  int lane, t, i0, j0, slot;
};

// The k-th tile of this CTA.
__device__ inline Tile tile_of(const Geo& g, int k) {
  const int gi = blockIdx.x + k * g.G;
  Tile r;
  r.lane = gi / g.tiles;
  r.t = gi - r.lane * g.tiles;
  r.i0 = (r.t / g.tiles_x) * g.th;
  r.j0 = (r.t % g.tiles_x) * g.tw;
  r.slot = k;
  return r;
}

__device__ __forceinline__ int tid() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// The tile geometry the device code reads: known at compile time for a
// block (BX, BY) whose sides are multiples of 4 (the tile is the block,
// one pixel a thread: constant offsets and trip counts), else (0, 0) read
// from the Geo at run time.
template <int BX, int BY>
struct Shape {
  static constexpr bool FIXED = BX > 0 && BY > 0;
  static_assert(!FIXED || (BX % 4 == 0 && BY % 4 == 0), "tile = block");
  // Every warp full: the shuffle trees need no partial-warp masks.
  static constexpr bool FULL_WARPS = FIXED && (BX * BY) % 32 == 0;
  const Geo& g;
  __device__ explicit Shape(const Geo& geo) : g(geo) {}
  __device__ int bx() const { return FIXED ? BX : (int)blockDim.x; }
  __device__ int by() const { return FIXED ? BY : (int)blockDim.y; }
  __device__ int nt() const { return bx() * by(); }
  __device__ int th() const { return FIXED ? BY : g.th; }
  __device__ int tw() const { return FIXED ? BX : g.tw; }
  __device__ int sw() const { return tw() + 2 * HX; }
  __device__ int sp() const { return (th() + 2) * sw(); }
  __device__ int tpx() const { return th() * tw(); }
  // Staged index of tile pixel (py, px).
  __device__ int sq(int py, int px) const {
    return (py + 1) * sw() + px + HX;
  }
  // Lanes of warp wp that exist.
  __device__ int warp_lanes(int wp) const {
    return FULL_WARPS ? 32 : min(32, nt() - 32 * wp);
  }
};

// Every pixel (py, px) of tile `tl` this thread handles and that lies in
// the image: f(py, px, i, j).
template <class SH, class F>
__device__ __forceinline__ void pixels(const SH& s, const Tile& tl, F f) {
  if constexpr (SH::FIXED) {
    const int py = threadIdx.y, px = threadIdx.x;
    const int i = tl.i0 + py, j = tl.j0 + px;
    if (i < s.g.h && j < s.g.w) f(py, px, i, j);
  } else {
    for (int py = threadIdx.y; py < s.th(); py += blockDim.y) {
      const int i = tl.i0 + py;
      if (i >= s.g.h) break;
      for (int px = threadIdx.x; px < s.tw(); px += blockDim.x) {
        const int j = tl.j0 + px;
        if (j < s.g.w) f(py, px, i, j);
      }
    }
  }
}

// 4-byte and 16-byte asynchronous copies global -> shared; zero fill
// where !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(a * sw + b) for each pixel of a staged tile with its one-pixel halo
// (rows a in [0, th + 2), columns b in [HX - 1, HX + tw + 1)) this thread
// handles.
template <class SH, class F>
__device__ __forceinline__ void staged(const SH& s, F f) {
#pragma unroll
  for (int a = threadIdx.y; a < s.th() + 2; a += s.by())
#pragma unroll
    for (int b = HX - 1 + threadIdx.x; b < HX + s.tw() + 1; b += s.bx())
      f(a * s.sw() + b);
}

// Start copying the planes of tile `tl` into `buf`: NH planes with the
// one-pixel halo (plane k at buf + k sp, row stride sw, tile pixel (py,
// px) at sq(py, px); zeros outside the image), then ni <= NI planes of the
// tile alone (plane k at buf + NH sp + k tile_px, row stride tw; pixels
// outside the image left alone). src(k, lane) is plane k of the lane, k <
// NH + ni, starting on 16 bytes where g.vec. With HALO = 1 the NH planes
// are halo planes (row-0 pointers of (h + 2, w) planes, the row shards of
// shard_cg.cu): rows -1 and h are read from them, not zero filled.
template <int NH, int NI, int HALO = 0, class SH, class Src>
__device__ void stage_tile(const SH& s, const Tile& tl, float* buf, int ni,
                           Src src) {
  const Geo& g = s.g;
  const int sp = s.sp(), sw = s.sw(), tpx = s.tpx(), tw = s.tw();
  const int nt = s.nt(), t0 = tid();
  const float* base[NH + NI];
#pragma unroll
  for (int k = 0; k < NH + NI; ++k)
    base[k] = k < NH + ni ? src(k, tl.lane) : nullptr;
  float* ib = buf + NH * sp;
  if (g.vec) {
    // Rows of the halo planes from column j0 - HX, tw + 2 HX floats; rows
    // of the other planes, tw floats: whole 16-byte pieces, each inside
    // the image or outside it (w and j0 are multiples of 4).
    const int nh = sw / 4, nv = tw / 4;
    if constexpr (NH > 0) {
#pragma unroll
      for (int q = t0; q < (s.th() + 2) * nh; q += nt) {
        const int a = q / nh, c = 4 * (q - a * nh);
        const int i = tl.i0 - 1 + a, j = tl.j0 - HX + c;
        const bool ok = i >= -HALO && i < g.h + HALO && j >= 0 && j < g.w;
        const int o = ok ? i * g.w + j : 0;
#pragma unroll
        for (int k = 0; k < NH; ++k)
          cp_async16(buf + k * sp + a * sw + c, base[k] + o, ok);
      }
    }
#pragma unroll
    for (int q = t0; q < s.th() * nv; q += nt) {
      const int a = q / nv, c = 4 * (q - a * nv);
      const int i = tl.i0 + a, j = tl.j0 + c;
      if (i >= g.h || j >= g.w) continue;
      const int o = i * g.w + j, e = a * tw + c;
#pragma unroll
      for (int k = 0; k < NI; ++k)
        if (k < ni) cp_async16(ib + k * tpx + e, base[NH + k] + o, true);
    }
    return;
  }
  if constexpr (NH > 0) {
    for (int a = threadIdx.y; a < s.th() + 2; a += s.by()) {
      const int i = tl.i0 - 1 + a;
      for (int b = HX - 1 + threadIdx.x; b < HX + tw + 1; b += s.bx()) {
        const int j = tl.j0 - HX + b;
        const bool ok = i >= -HALO && i < g.h + HALO && j >= 0 && j < g.w;
        const int o = ok ? i * g.w + j : 0;
#pragma unroll
        for (int k = 0; k < NH; ++k)
          cp_async4(buf + k * sp + a * sw + b, base[k] + o, ok);
      }
    }
  }
  pixels(s, tl, [&](int py, int px, int i, int j) {
    const int o = i * g.w + j, e = py * tw + px;
#pragma unroll
    for (int k = 0; k < NI; ++k)
      if (k < ni) cp_async4(ib + k * tpx + e, base[NH + k] + o, true);
  });
}

// The lane of this CTA's k-th tile.
__device__ __forceinline__ int lane_of(const Geo& g, int k) {
  return (blockIdx.x + k * g.G) / g.tiles;
}

// body(tile, buffer, par) over this CTA's tiles whose lane passes
// take(lane), in slot order, each with its planes staged in its buffer
// (stage_tile<NH, NI>; the two buffers `buf` floats apart); the next
// tile's staging is in flight while one computes. The body must end in a
// cta_sum (its __syncthreads frees the buffer for the copy after next).
// HALO as stage_tile's.
template <int NH, int NI, int HALO = 0, class SH, class Src, class Take,
          class Body>
__device__ void staged_tiles(const SH& s, float* stage, int buf, int ni,
                             Src src, Take take, Body body) {
  const Geo& g = s.g;
  const int n = g.count();
  auto next = [&](int k) {
    while (k < n && !take(lane_of(g, k))) ++k;
    return k;
  };
  int k = next(0), par = 0;
  Tile cur = tile_of(g, k < n ? k : 0), nxt = cur;
  if (k < n) stage_tile<NH, NI, HALO>(s, cur, stage, ni, src);
  cp_async_commit();
  while (k < n) {
    const int kn = next(k + 1);
    if (kn < n) {
      nxt = tile_of(g, kn);
      stage_tile<NH, NI, HALO>(s, nxt, stage + (par ^ 1) * buf, ni, src);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    body(cur, stage + par * buf, par);
    cur = nxt;
    k = kn;
    par ^= 1;
  }
  cp_async_wait<0>();
}

// A fixed-order shuffle tree over the n lanes of a warp (lane ln); the sum
// lands in lane 0.
template <class T>
__device__ __forceinline__ T warp_tree(T v, int ln, int n) {
  const unsigned m = n == 32 ? 0xffffffffu : (1u << n) - 1u;
  for (int o = 16; o > 0; o >>= 1) {
    const T b = __shfl_down_sync(m, v, o);
    if (ln + o < n) v += b;
  }
  return v;
}

// The sums over the CTA of ND per-thread floats, in a fixed order: a
// shuffle tree in each warp, then one over the warps' sums in warp 0.
// Valid in thread 0. `par` alternates between consecutive calls: warp 0
// may still read one set of warp sums while the warps write the other.
template <class SH, int ND>
__device__ void cta_sum(const SH& s, float (&v)[ND], float* red, int par) {
  const int nt = s.nt(), t = tid();
  const int ln = t & 31, wp = t >> 5;
  const int n = s.warp_lanes(wp);
  float* rp = red + par * ND_MAX * 32;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    v[d] = warp_tree(v[d], ln, n);
    if (ln == 0) rp[d * 32 + wp] = v[d];
  }
  __syncthreads();
  if (wp == 0) {
    const int nw = (nt + 31) / 32;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      v[d] = warp_tree(ln < nw ? rp[d * 32 + ln] : 0.0f, ln,
                       s.warp_lanes(0));
  }
}

// The sums in double of ND rows of lane `lane`'s per-tile partials (row r
// at part + r * stride, lane l's tiles at l * T): thread t adds tiles t, t
// + nt, ... in order, then a shuffle tree per warp and one over the warps'
// sums in warp 0. Every CTA runs the same order on the same floats and
// gets the same bits. Valid in thread 0; all threads must call it.
template <int ND, class SH>
__device__ void lane_sums(const SH& s, const float* part, size_t stride,
                          const int (&rows)[ND], int lane, int T,
                          double* dred, double (&out)[ND]) {
  const int nt = s.nt(), t = tid();
  const int ln = t & 31, wp = t >> 5;
  const int n = s.warp_lanes(wp);
  double v[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    v[d] = 0.0;
    const float* row = part + rows[d] * stride + (size_t)lane * T;
    for (int k = t; k < T; k += nt) v[d] += (double)__ldcg(row + k);
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    v[d] = warp_tree(v[d], ln, n);
    if (ln == 0) dred[d * 32 + wp] = v[d];
  }
  __syncthreads();
  if (wp == 0) {
    const int nw = (nt + 31) / 32;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      out[d] = warp_tree(ln < nw ? dred[d * 32 + ln] : 0.0, ln,
                         s.warp_lanes(0));
  }
  __syncthreads();
}

// sum_d C_d v[i + d] in the order of srps::stencil, one rounding a step;
// v points at the pixel in a staged plane of row stride sw.
__device__ __forceinline__ float stencil_staged(const float c[9],
                                                const float* v, int sw) {
  float s = __fmul_rn(c[0], v[0]);
  s = __fmaf_rn(c[1], v[1], s);
  s = __fmaf_rn(c[2], v[-1], s);
  s = __fmaf_rn(c[3], v[sw], s);
  s = __fmaf_rn(c[4], v[-sw], s);
  s = __fmaf_rn(c[5], v[sw + 1], s);
  s = __fmaf_rn(c[6], v[-sw + 1], s);
  s = __fmaf_rn(c[7], v[sw - 1], s);
  s = __fmaf_rn(c[8], v[-sw - 1], s);
  return s;
}

// Sum of a staged plane over the aligned 4 x 4 tile holding tile pixel
// (py, px) (tile origins are multiples of 4, so it lies in the tile).
__device__ __forceinline__ float tile_sum4_staged(const float* plane, int sw,
                                                  int py, int px) {
  const float* v = plane + (py - py % 4 + 1) * sw + (px - px % 4 + HX);
  float t = 0.0f;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) t = __fadd_rn(t, v[a * sw + b]);
  return t;
}

// G and the slots of a launch on `sms` SMs, c CTAs resident per SM.
inline void set_ctas(Geo& g, int c, int sms) {
  g.G = c * sms;
  g.slots = (g.B * g.tiles + g.G - 1) / g.G;
}

// The one cooperative launch of a solve, laid out here: on chip (kernel
// `on`, staging buffers of buf_on floats and the `non` planes of its tiles)
// at the most CTAs per SM c for which the occupancy calculator lets c such
// CTAs be resident, else in device memory (`off`, buf_off) at as many CTAs
// per SM as it allows; G = c x SMs, all resident at once. `layout`: -1
// choose so, 0 device memory, 1 on chip. Refused (an error returned,
// nothing launched) where no CTA, or with layout 1 no on-chip CTA, fits.
// Sets g (the launch's Geo, inside `params`) and fills info.
template <class K>
int launch(K on, K off, Geo& g, int buf_on, int buf_off, int non, int layout,
           void* params, cudaStream_t st, int* info) {
  int dev = 0, coop = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  for (K k : {on, off})
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  const int threads = g.bx * g.by;
  bool onchip = false;
  int occ = 0;
  size_t smem = 0;
  if (layout != 0) {
    // The most CTAs per SM that the threads and registers allow, down to 1.
    int most = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&most, on, threads, 0);
    for (int c = most; e == cudaSuccess && c >= 1 && !onchip; --c) {
      set_ctas(g, c, sms);
      smem = smem_bytes(g, buf_on, non, true);
      if (smem > (size_t)optin) continue;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, on, threads,
                                                        smem);
      onchip = e == cudaSuccess && occ >= c;
    }
  }
  if (e == cudaSuccess && !onchip) {
    if (layout == 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    smem = smem_bytes(g, buf_off, non, false);
    occ = 0;
    if (smem <= (size_t)optin)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, off, threads,
                                                        smem);
    set_ctas(g, occ > 0 ? occ : 1, sms);
  }
  const K kernel = onchip ? on : off;
  cudaFuncAttributes fa{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  info[I_CTAS] = g.G;
  info[I_OCC] = occ;
  info[I_SMS] = sms;
  info[I_REGS] = fa.numRegs;
  info[I_LOCAL] = (int)fa.localSizeBytes;
  info[I_SMEM] = (int)smem;
  info[I_ONCHIP] = onchip ? 1 : 0;
  info[I_TILES] = g.tiles;
  if (!coop || occ < 1 || g.G > occ * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {params};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(g.G),
                                  dim3(g.bx, g.by), args, smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  info[I_LAUNCHES] += 1;
  return 0;
}

}  // namespace persist
