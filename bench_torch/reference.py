"""The plain reference: SRmeetsPS on one capture in plain PyTorch.

It computes what the port computes, written out from the equations
(reference nihalsid/SRmeetsPS-CUDA, SRPS.cu and devicecalls.cu, with the
port's preprocessing) and importing nothing of the port:

* preprocessing: the mean of the LR frames (a pixel that any frame lacks
  is a hole), the holes filled by a coarse-to-fine seed and 2 r^2 Jacobi
  sweeps of the masked harmonic equation, the max-normalised bilateral
  filter (radius round(1.5 sigma_s), disk, reflect-101 borders) and the
  bicubic upsample (Keys, A = -0.75, half-pixel centres, clamped borders);
* each outer iteration: the per-(image, channel) lighting by its 4 x 4
  normal equations, the per-pixel albedo, the depth by a warm-started
  conjugate gradient on ``M = KT^T KT + lam A^T A`` (stop at <r, r> <
  tol^2 or after cap + 1 iterations) and the normals;
* the energy ``||KT z - z0s||^2 + lam ||A z - b||^2`` summed row by row
  from its residuals.

Every float is float32 and matrix products run without TF32, the
configuration's precision; only the 4 x 4 lighting systems are solved in
float64 on the host. ``tf32=True`` computes the same in TF32 (on a
CUDA device the library's TF32 mode; on the CPU, which has none, each
product's inputs are rounded to TF32's 10 mantissa bits): the control that
has to fail the comparison.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (10 mantissa bits)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    """One capture's solve. ``tf32`` selects the control's precision."""

    def __init__(self, device, tf32: bool = False):
        self.device = torch.device(device)
        self.tf32 = tf32

    @contextlib.contextmanager
    def precision(self):
        """Matrix products and convolutions in float32 (TF32 for the
        control); the previous settings are restored."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.tf32 and self.device.type == "cuda"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    def mm(self, a, b):
        if self.tf32 and self.device.type != "cuda":
            a, b = _round_tf32(a), _round_tf32(b)
        return torch.matmul(a, b)

    def conv(self, x, k):
        if self.tf32 and self.device.type != "cuda":
            x, k = _round_tf32(x), _round_tf32(k)
        return F.conv2d(x, k)

    # -- preprocessing -----------------------------------------------------

    def inpaint(self, img, holes, iters):
        known = (~holes).float()
        h, w = img.shape
        levels = []
        num, den = img * known, known
        size = max(h, w)

        def down(x):
            x = F.pad(x, (0, x.shape[1] % 2, 0, x.shape[0] % 2))
            return x.reshape(x.shape[0] // 2, 2, x.shape[1] // 2, 2).sum(
                dim=(1, 3))

        while size > 1:
            levels.append((num, den))
            num, den = down(num), down(den)
            size = (size + 1) // 2
        fill = num / den.clamp(min=1e-20)
        for num_l, den_l in reversed(levels):
            hl, wl = num_l.shape
            fill = fill.repeat_interleave(2, 0).repeat_interleave(2, 1)[:hl, :wl]
            fill = torch.where(den_l > 0, num_l / den_l.clamp(min=1e-20), fill)
        kb = known > 0
        u = torch.where(kb, img, fill)
        k = torch.tensor([[0.5, 1.0, 0.5], [1.0, 0.0, 1.0], [0.5, 1.0, 0.5]],
                         device=img.device)[None, None] / 6.0
        for _ in range(iters):
            u = torch.where(kb, img, self.conv(F.pad(u, (1, 1, 1, 1))[None, None],
                                               k)[0, 0])
        return u

    @staticmethod
    def bilateral(img, sigma_color, sigma_space):
        r = int(round(1.5 * sigma_space))
        h, w = img.shape
        pad = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
        num = torch.zeros_like(img)
        den = torch.zeros_like(img)
        for di in range(-r, r + 1):
            for dj in range(-r, r + 1):
                if di * di + dj * dj > r * r:
                    continue
                q = pad[r + di:r + di + h, r + dj:r + dj + w]
                wt = math.exp(-(di * di + dj * dj) / (2 * sigma_space ** 2)) \
                    * torch.exp(-(q - img) ** 2 / (2 * sigma_color ** 2))
                num = num + wt * q
                den = den + wt
        return num / den

    def bicubic_matrix(self, n_in, n_out):
        A = -0.75
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(src).astype(np.int64)
        t = src - i0
        wts = [((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A,
               ((A + 2) * t - (A + 3)) * t * t + 1,
               ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1]
        wts.append(1.0 - wts[0] - wts[1] - wts[2])
        W = np.zeros((n_out, n_in))
        for tap in range(4):
            np.add.at(W, (np.arange(n_out), np.clip(i0 - 1 + tap, 0, n_in - 1)),
                      wts[tap])
        return torch.tensor(W, dtype=torch.float32, device=self.device)

    def preprocess(self, z0, h, w, cfg):
        """``(zs, z_init)``: the smoothed LR depth and the HR start."""
        n = z0.shape[0]
        mean = z0.sum(0) / n
        holes = (z0 == 0).any(0)
        iters = cfg["inpaint_iters"] or 2 * cfg["inpaint_radius"] ** 2
        zs = self.inpaint(mean, holes, iters)
        mx = zs.max()
        mx = torch.where(mx == 0, torch.ones_like(mx), mx)
        zs = self.bilateral(zs / mx, cfg["bilateral_sigma_color"],
                            cfg["bilateral_sigma_space"]) * mx
        hl, wl = zs.shape
        z_init = self.mm(self.mm(self.bicubic_matrix(hl, h), zs),
                         self.bicubic_matrix(wl, w).T)
        return zs, z_init

    # -- the problem -------------------------------------------------------

    @staticmethod
    def shift(a, di, dj):
        """``out[..., i, j] = a[..., i + di, j + dj]``, 0 outside."""
        h, w = a.shape[-2:]
        out = torch.zeros_like(a)
        out[..., max(0, -di):h - max(0, di), max(0, -dj):w - max(0, dj)] = \
            a[..., max(0, di):h - max(0, -di), max(0, dj):w - max(0, -dj)]
        return out

    def setup(self, cap, cfg, pad_to=None):
        """Problem fields and the initial state of one capture."""
        d = self.device
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=d)  # noqa: E731
        sf = int(cap.sf)
        mask_in = t(cap.mask)
        h, w = mask_in.shape
        zs, z_init = self.preprocess(t(cap.z0), h, w, cfg)
        I = t(cap.I)
        if pad_to is not None:
            H, W = pad_to
            pad = lambda a: F.pad(a, (0, W - a.shape[-1], 0, H - a.shape[-2]))  # noqa: E731
            mask_in, I, z_init = pad(mask_in), pad(I), pad(z_init)
            zs = F.pad(zs, (0, W // sf - zs.shape[1], 0, H // sf - zs.shape[0]))
            h, w = H, W
        m = mask_in != 0
        mask = m.float()
        masks = (mask.reshape(h // sf, sf, w // sf, sf).sum((1, 3))
                 >= sf * sf).float()
        K = np.asarray(cap.K, np.float64)
        jj = torch.arange(w, device=d, dtype=torch.float32)[None, :].expand(h, w)
        ii = torch.arange(h, device=d, dtype=torch.float32)[:, None].expand(h, w)
        fx_ = m & self.shift(m, 0, 1)
        fy_ = m & self.shift(m, 1, 0)
        p = dict(
            sf=sf, mask=mask, masks=masks, fx=float(K[0, 0]), fy=float(K[1, 1]),
            xx=(jj - float(K[0, 2])) * mask, yy=(ii - float(K[1, 2])) * mask,
            I=(I * mask).permute(1, 0, 2, 3).contiguous(),  # (c, n, h, w)
            z0s=zs * masks,
            gx=(fx_.float(), (m & self.shift(m, 0, -1) & ~fx_).float()),
            gy=(fy_.float(), (m & self.shift(m, -1, 0) & ~fy_).float()),
        )
        z = z_init * mask
        N, dz = self.normals(z, p)
        c, n = p["I"].shape[:2]
        s = torch.zeros((n, c, 4), device=d)
        s[:, :, 2] = -1.0
        state = dict(z=z, rho=(0.5 * mask).expand(c, h, w).clone(), s=s,
                     N=N, dz=dz)
        return p, state, z_init

    def dx(self, z, p):
        f, b = p["gx"]
        return f * (self.shift(z, 0, 1) - z) + b * (z - self.shift(z, 0, -1))

    def dy(self, z, p):
        f, b = p["gy"]
        return f * (self.shift(z, 1, 0) - z) + b * (z - self.shift(z, -1, 0))

    def dxt(self, y, p):
        f, b = p["gx"]
        return self.shift(f * y, 0, -1) - f * y + b * y - self.shift(b * y, 0, 1)

    def dyt(self, y, p):
        f, b = p["gy"]
        return self.shift(f * y, -1, 0) - f * y + b * y - self.shift(b * y, 1, 0)

    def normals(self, z, p):
        zx, zy = self.dx(z, p), self.dy(z, p)
        n = torch.stack([p["fx"] * zx, p["fy"] * zy,
                         -z - p["xx"] * zx - p["yy"] * zy])
        dz = torch.sqrt((n * n).sum(0)).clamp(min=1e-10)
        return torch.cat([n / dz, p["mask"][None]]), dz

    def kt(self, z, p):
        """``KT z``: the masked sf x sf box mean."""
        sf = p["sf"]
        h, w = z.shape
        return z.reshape(h // sf, sf, w // sf, sf).mean((1, 3)) * p["masks"]

    def ktt(self, u, p):
        """``KT^T u``."""
        sf = p["sf"]
        up = (u * p["masks"]).repeat_interleave(sf, 0).repeat_interleave(sf, 1)
        return up / (sf * sf) * p["mask"]

    # -- one outer iteration -----------------------------------------------

    def lighting(self, p, rho, N, s_prev):
        """Each (image, channel) lighting from its 4 x 4 normal equations.
        Their sums run over every pixel of the mask (a million at 960 x
        1280), and the equations are ill-conditioned, so they are summed
        as reductions, not as one long matrix product (whose sequential
        f32 accumulation over 10^6 terms parts from the sum by ~1e-3),
        and solved in float64 on the host; a singular system keeps the
        previous lighting."""
        c, n, h, w = p["I"].shape
        Tf = (rho[:, None] * N[None]).reshape(c, 4, -1)  # (c, 4, P)
        If = p["I"].reshape(c, n, -1)
        ATA = torch.stack([torch.stack([(Tf[:, a] * Tf[:, b]).sum(-1)
                                        for b in range(4)], -1)
                           for a in range(4)], -2)  # (c, 4, 4)
        ATb = torch.stack([(If * Tf[:, None, a]).sum(-1) for a in range(4)],
                          -1)  # (c, n, 4)
        A = ATA.double().cpu().numpy()
        B = ATb.double().cpu().numpy()
        with np.errstate(all="ignore"):
            try:
                sol = np.linalg.solve(A[:, None], B[..., None])[..., 0]
            except np.linalg.LinAlgError:
                sol = np.full(B.shape, np.nan)
        sol = torch.as_tensor(sol.transpose(1, 0, 2), dtype=torch.float32,
                              device=rho.device)  # (n, c, 4)
        ok = torch.isfinite(sol).all(-1, keepdim=True)
        return torch.where(ok, sol, s_prev)

    def albedo(self, p, s, N, rho_prev):
        c, n, h, w = p["I"].shape
        sc = s.permute(1, 2, 0)  # (c, 4, n)
        J = self.mm(sc, p["I"].reshape(c, n, -1)).reshape(c, 4, h, w)
        G = self.mm(sc, sc.transpose(1, 2))  # (c, 4, 4)
        num = (N[None] * J).sum(1)
        den = torch.einsum("ckl,khw,lhw->chw", G, N, N)
        rho = torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                          rho_prev)
        return rho * p["mask"], J, G

    def depth_fields(self, p, s, rho, dz, J, G):
        """The Gram fields of ``A^T A`` and ``A^T b`` (the sums over images
        of the row coefficients ``(rho / dz) (fx s1 - xx s3, fy s2 - yy s3,
        -s3)`` on (zx, zy, z) with rhs ``I - rho s4``)."""
        xx, yy, fx, fy = p["xx"], p["yy"], p["fx"], p["fy"]
        w1 = rho / dz  # (c, h, w)
        w2 = w1 * w1
        A = lambda a, b: (w2 * G[:, a, b, None, None]).sum(0)  # noqa: E731
        Bk = lambda k: (w1 * (J[:, k] - rho * G[:, k, 3, None, None])).sum(0)  # noqa: E731
        A00, A01, A02 = A(0, 0), A(0, 1), A(0, 2)
        A11, A12, A22 = A(1, 1), A(1, 2), A(2, 2)
        b0, b1, b2 = Bk(0), Bk(1), Bk(2)
        f = dict(
            P11=fx * fx * A00 - 2 * fx * xx * A02 + xx * xx * A22,
            P22=fy * fy * A11 - 2 * fy * yy * A12 + yy * yy * A22,
            P12=fx * fy * A01 - fx * yy * A02 - fy * xx * A12 + xx * yy * A22,
            P13=fx * A02 - xx * A22, P23=fy * A12 - yy * A22, P33=A22,
            Q3=b2)
        f["Q1"] = fx * b0 - xx * b2
        f["Q2"] = fy * b1 - yy * b2
        return f

    def matvec(self, v, f, p, lam):
        g, h = self.dx(v, p), self.dy(v, p)
        t1 = f["P11"] * g + f["P12"] * h - f["P13"] * v
        t2 = f["P12"] * g + f["P22"] * h - f["P23"] * v
        t3 = f["P13"] * g + f["P23"] * h - f["P33"] * v
        return (self.ktt(self.kt(v, p), p)
                + lam * (self.dxt(t1, p) + self.dyt(t2, p) - t3))

    def cg(self, z, f, p, cfg):
        lam = cfg["lam"]
        rhs = self.ktt(p["z0s"], p) + lam * (
            self.dxt(f["Q1"], p) + self.dyt(f["Q2"], p) - f["Q3"])
        tol_sq = float(np.float32(cfg["cg_tol"]) * np.float32(cfg["cg_tol"]))
        x = z
        r = rhs - self.matvec(x, f, p, lam)
        rr = (r * r).sum()
        pv = torch.zeros_like(r)
        rr_old = None
        k = 0
        while k <= cfg["cg_max_iter"] and float(rr) > tol_sq:
            k += 1
            pv = r if rr_old is None else r + (rr / rr_old) * pv
            wv = self.matvec(pv, f, p, lam)
            alpha = rr / (pv * wv).sum()
            x = x + alpha * pv
            r = r - alpha * wv
            rr_old, rr = rr, (r * r).sum()
        return x * p["mask"], k

    def energy(self, z, p, s, rho, dz, lam):
        """The depth energy at ``z``, row by row from its residuals."""
        r1 = self.kt(z, p) - p["z0s"]
        zx, zy = self.dx(z, p), self.dy(z, p)
        w1 = rho / dz
        e = (r1 * r1).sum()
        for i in range(s.shape[0]):
            si = s[i][:, :, None, None]  # (c, 4, 1, 1)
            a = w1 * ((p["fx"] * si[:, 0] - p["xx"] * si[:, 2]) * zx
                      + (p["fy"] * si[:, 1] - p["yy"] * si[:, 2]) * zy
                      - si[:, 2] * z)
            res = a - (p["I"][:, i] - rho * si[:, 3])
            e = e + lam * (res * res).sum()
        return e

    def iteration(self, p, st, cfg):
        s = self.lighting(p, st["rho"], st["N"], st["s"])
        rho, J, G = self.albedo(p, s, st["N"], st["rho"])
        f = self.depth_fields(p, s, rho, st["dz"], J, G)
        z, k = self.cg(st["z"], f, p, cfg)
        e = self.energy(z, p, s, rho, st["dz"], cfg["lam"])
        N, dz = self.normals(z, p)
        return dict(z=z, rho=rho, s=s, N=N, dz=dz), float(e), k

    def solve(self, cap, cfg, iterations=None, pad_to=None):
        """The solve of ``cap``. ``iterations`` fixes the count of outer
        iterations (the program's, so that the two end alike); None stops
        by the reference's rule. Returns host arrays: z_init, z, rho, s,
        N, the energy trace and the CG iterations of each outer
        iteration."""
        with torch.no_grad(), self.precision():
            p, st, z_init = self.setup(cap, cfg, pad_to)
            energies, cg = [], []
            while True:
                st, e, k = self.iteration(p, st, cfg)
                energies.append(e)
                cg.append(k)
                n = len(energies)
                if iterations is not None:
                    if n >= iterations:
                        break
                elif stop_rule(energies, cfg):
                    break
            out = {k: v.cpu().numpy() for k, v in st.items() if k != "dz"}
            out.update(z_init=(z_init * p["mask"]).cpu().numpy(),
                       mask=p["mask"].cpu().numpy(), energies=energies, cg=cg)
            return out


def stop_rule(energies, cfg) -> bool:
    """The reference's stopping rule after the last of ``energies``
    (SRPS.cu:297-301), in float32 as the device computes it: an energy
    increase, a relative change below the tolerance, or the iteration cap
    (checked one-based: the cap plus one iterations at most). Comparisons
    with NaN are false."""
    k = len(energies)
    if k > cfg["max_iterations"]:
        return True
    if k < 2:
        return False
    last, err = np.float32(energies[-2]), np.float32(energies[-1])
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.float32(abs(last - err)) / np.float32(abs(err))
        return bool(err > last) or bool(rel < np.float32(cfg["tolerance"]))


def stop_count(energies, cfg) -> int:
    """The outer iterations after which the rule stops on this trace."""
    for k in range(1, len(energies) + 1):
        if stop_rule(energies[:k], cfg):
            return k
    return len(energies) + 1
