// The Chronopoulos-Gear scalar recurrence shared by cgs_cg.cu (a lane) and
// shard_cg.cu (every row shard holds the same copy).

#pragma once

namespace cgs {

// Device scalars of one lane (float). S_K counts the sweeps done.
constexpr int S_GAMMA = 0, S_DELTA = 1, S_GOLD = 2, S_AOLD = 3, S_ALPHA = 4,
              S_BETA = 5, S_ACT = 6, S_ITERS = 7, S_K = 8;
constexpr int N_SCAL = 9;

// The update of one thread from the sums gamma = <r, r> and delta = <w, r>.
// `first` follows the prologue: it seeds gamma_old = alpha_old = 1, active
// = 1 and iters = 0 (pallas_cg_cgs.py:100-103); otherwise it follows a
// sweep, returns at once for a stopped lane and shifts gamma and alpha into
// their _old slots (:329-332). Then it decides the next iteration it =
// sweeps done + 1 (:216-232).
__device__ void update(float* __restrict__ scal, double gd, double dd,
                       float tol2, int max_iter, bool first) {
  if (!first && scal[S_ACT] == 0.0f) return;
  float act = 1.0f, iters = 0.0f, k = 0.0f;
  if (first) {
    scal[S_GOLD] = 1.0f;
    scal[S_AOLD] = 1.0f;
  } else {
    scal[S_GOLD] = scal[S_GAMMA];
    scal[S_AOLD] = scal[S_ALPHA];
    act = scal[S_ACT];
    iters = scal[S_ITERS];
    k = scal[S_K];
  }
  const float gamma = (float)gd;
  const float delta = (float)dd;
  scal[S_GAMMA] = gamma;
  scal[S_DELTA] = delta;
  const float it = k + 1.0f;
  const bool on = act > 0.0f && gamma > tol2 && it - 1.0f <= (float)max_iter;
  const float gold = scal[S_GOLD];
  const float beta = it == 1.0f ? 0.0f : gamma / (gold == 0.0f ? 1.0f : gold);
  const float denom = delta - beta * gamma / scal[S_AOLD];
  scal[S_BETA] = beta;
  scal[S_ALPHA] = gamma / (denom == 0.0f ? 1.0f : denom);
  scal[S_ACT] = on ? 1.0f : 0.0f;
  scal[S_ITERS] = on ? iters + 1.0f : iters;
  scal[S_K] = it;
}

}  // namespace cgs
