"""Batched EPnP (Efficient Perspective-n-Point) — PyTorch.

Counterpart of ``spef_tpu.codec.epnp``, written over leading batch
dimensions where the JAX solver ``vmap``s (the batch, and RANSAC's
hypotheses):

  * image points are undistorted to normalized coordinates by 20 fixed
    Brown-model iterations;
  * EPnP proper: control points from a 3x3 ``eigh``, barycentric
    coordinates, the 12x12 ``M^T M`` and its four null-space vectors from
    ``eigh``, the three beta approximations, each refined by 10
    Gauss-Newton steps, Horn alignment by a 3x3 SVD with the determinant's
    sign fixed, and the candidate of least reprojection error;
  * a Gauss-Newton reprojection refinement, kept only where it lowers the
    error, and the guard that gives the identity pose and ``t = [0, 0, 10]``
    to a non-finite solve;
  * RANSAC over a fixed table of 16 six-point subsets (:data:`RANSAC_SUBSETS`),
    inlier voting, the full-set anchor and a masked refinement.

``eigh`` fixes no sign for the control frame's principal axes, and on
noisy keypoints EPnP's answer depends on them (its beta approximations are
not invariant to the frame): ``axes`` / ``subset_axes`` turn each axis the
way JAX's LAPACK ``eigh`` turns it (``codec.keypoints.TANGO_AXES``), so
that cuSOLVER on the card and LAPACK on the CPU take JAX's frame.

Optional per-point ``weights`` make every least-squares stage weighted.

Everything is branch-free tensor code: no ``.item()``, no data-dependent
``if``.  The small solves are ``solve_ex`` / ``inv_ex`` with
``check_errors=False``, so a singular system gives the non-finite values
the guards expect instead of an exception.  ``eigh`` and ``svd`` have no
such form and raise on non-finite input: their inputs are masked to a
finite matrix and their outputs set back to NaN, as JAX's would be.
Ties in ``argmin`` / ``argmax`` go to the first index, a NaN error wins
``argmin`` as in JAX.

All of it runs in float32 with TF32 off (:func:`exact_f32`): the 12x12
system's condition number reaches about 1e8 at far range, where
reduced-precision products lose the null space.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["RANSAC_SUBSETS", "exact_f32", "undistort_points", "epnp_solve", "epnp_solve_batch",
           "epnp_ransac"]

_GN_ITERS = 10
_UNDISTORT_ITERS = 20

# The 16 six-point subsets of ``spef_tpu.codec.epnp.epnp_ransac`` for 11
# points: ``jax.random.choice(k, 11, (6,), replace=False)`` over
# ``jax.random.split(PRNGKey(0), 16)`` (tests/test_torch_epnp.py holds it
# against JAX).
RANSAC_SUBSETS = (
    (10, 0, 8, 2, 4, 1), (0, 3, 9, 5, 1, 8), (7, 4, 3, 10, 1, 6), (8, 10, 2, 9, 1, 7),
    (2, 5, 4, 9, 6, 8), (3, 6, 8, 7, 4, 2), (6, 7, 3, 5, 0, 2), (0, 7, 5, 9, 2, 10),
    (8, 6, 7, 0, 4, 5), (4, 0, 2, 8, 5, 6), (6, 2, 5, 8, 10, 1), (0, 3, 6, 1, 7, 5),
    (0, 4, 8, 6, 9, 3), (6, 5, 8, 4, 9, 10), (7, 10, 3, 8, 9, 0), (1, 8, 4, 6, 10, 2),
)

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def exact_f32() -> None:
    """Turn TF32 off for float32 matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sym_eigh(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``eigh`` of symmetric ``(..., n, n)``; a non-finite matrix gives NaN."""
    bad = ~torch.isfinite(a).all(dim=-1).all(dim=-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    ew, v = torch.linalg.eigh(torch.where(bad[..., None, None], eye, a))
    return ew.masked_fill(bad[..., None], float("nan")), v.masked_fill(bad[..., None, None],
                                                                      float("nan"))


def _svd3(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u, vt)`` of ``(..., 3, 3)``; a non-finite matrix gives NaN."""
    bad = ~torch.isfinite(h).all(dim=-1).all(dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    u, _, vt = torch.linalg.svd(torch.where(bad, eye, h))
    return u.masked_fill(bad, float("nan")), vt.masked_fill(bad, float("nan"))


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of ``(..., 3, 3)`` by cofactors (no LU, no host sync)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmin`` over the last axis: the first minimum, or the first NaN."""
    return torch.argmin(torch.where(torch.isnan(x), float("-inf"), x), dim=-1)


def _first_argmax(counts: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of integer counts over the last axis: the first maximum."""
    n = counts.shape[-1]
    order = torch.arange(n - 1, -1, -1, device=counts.device)
    return torch.argmax(counts.long() * n + order, dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, ...]`` per batch row: ``x`` (B, K, *rest), ``idx`` (B,)."""
    index = idx.view(-1, 1, *([1] * (x.dim() - 2))).expand(-1, 1, *x.shape[2:])
    return torch.gather(x, 1, index)[:, 0]


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where`` of a per-problem condition ``(...)`` over ``(..., *rest)``."""
    return torch.where(cond.view(*cond.shape, *([1] * (a.dim() - cond.dim()))), a, b)


def undistort_points(pts: torch.Tensor, K: torch.Tensor, dist: Optional[torch.Tensor]
                     ) -> torch.Tensor:
    """Pixel coords ``(..., N, 2)`` -> normalized image coords, inverting
    Brown distortion ``dist = (k1, k2, p1, p2, k3)`` by fixed-point
    iteration (OpenCV ``undistortPoints``); ``dist=None`` skips it."""
    x = (pts[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts[..., 1] - K[1, 2]) / K[1, 1]
    if dist is None:
        return torch.stack([x, y], dim=-1)
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x0, y0 = x, y
    for _ in range(_UNDISTORT_ITERS):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return torch.stack([x, y], dim=-1)


# ---------------------------------------------------------------------------
# EPnP proper, over leading dims: pws (..., N, 3), uv (..., N, 2), w (..., N)
# ---------------------------------------------------------------------------


def _wmean(w: torch.Tensor, p: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """``(w @ p) / sw``: (..., N), (..., N, 3), (...) -> (..., 3)."""
    return (w.unsqueeze(-2) @ p).squeeze(-2) / sw.unsqueeze(-1)


def _choose_control_points(pws: torch.Tensor, w: Optional[torch.Tensor],
                           axes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Centroid + principal axes scaled by the spread -> (..., 4, 3).  With
    ``axes`` (..., 3, 3), rows by descending spread, each axis is turned to
    point the way its row does (``eigh`` fixes no sign)."""
    if w is None:
        sw = torch.full((), float(pws.shape[-2]), dtype=pws.dtype, device=pws.device)
        c0 = pws.mean(dim=-2)
        a = pws - c0.unsqueeze(-2)
    else:
        sw = w.sum(dim=-1)
        c0 = _wmean(w, pws, sw)
        a = (pws - c0.unsqueeze(-2)) * torch.sqrt(w).unsqueeze(-1)
    ew, v = _sym_eigh(a.mT @ a)  # ascending
    ew, v = ew.flip(-1), v.flip(-1)  # descending, the EPnP convention
    if axes is not None:
        v = v * torch.where((v.mT * axes).sum(dim=-1) < 0, -1.0, 1.0).unsqueeze(-2)
    k = torch.sqrt(torch.clamp(ew, min=0.0) / (sw if w is None else sw.unsqueeze(-1)))
    cs = c0.unsqueeze(-2) + (v * k.unsqueeze(-2)).mT
    return torch.cat([c0.unsqueeze(-2), cs], dim=-2)


def _barycentric(pws: torch.Tensor, cws: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates (..., N, 4) of the points in the control frame."""
    cc = (cws[..., 1:, :] - cws[..., :1, :]).mT  # column j = c_{j+1} - c0
    eye = torch.eye(3, dtype=cc.dtype, device=cc.device)
    cc_inv, _ = torch.linalg.inv_ex(cc + 1e-9 * eye, check_errors=False)
    a123 = (pws - cws[..., :1, :]) @ cc_inv.mT
    return torch.cat([1.0 - a123.sum(dim=-1, keepdim=True), a123], dim=-1)


def _fill_M(alphas: torch.Tensor, uv: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Measurement matrix (..., 2N, 12) in normalized coords."""
    u, v = uv[..., 0:1], uv[..., 1:2]
    zeros = torch.zeros_like(alphas)
    row_u = torch.stack([alphas, zeros, -alphas * u], dim=-1)  # (..., N, 4, 3)
    row_v = torch.stack([zeros, alphas, -alphas * v], dim=-1)
    m = torch.stack([row_u, row_v], dim=-3)  # (..., N, 2, 4, 3)
    if w is not None:
        m = m * torch.sqrt(w)[..., None, None, None]
    return m.reshape(*m.shape[:-4], 2 * m.shape[-4], 12)


def _rho(cws: torch.Tensor) -> torch.Tensor:
    return torch.stack([((cws[..., i, :] - cws[..., j, :]) ** 2).sum(dim=-1)
                        for i, j in _PAIRS], dim=-1)


def _compute_L6x10(vs: torch.Tensor) -> torch.Tensor:
    """``vs`` (..., 4, 12) null-space vectors -> L (..., 6, 10), columns
    [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44]."""
    c = vs.reshape(*vs.shape[:-1], 4, 3)  # (..., 4 vectors, 4 points, 3)
    dv = torch.stack([c[..., i, :] - c[..., j, :] for i, j in _PAIRS], dim=-2)  # (..., 4, 6, 3)

    def dot(a, b):
        return (dv[..., a, :, :] * dv[..., b, :, :]).sum(dim=-1)

    cols = [dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2), dot(2, 2),
            2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3)]
    return torch.stack(cols, dim=-1)


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Normal-equation least squares ``(..., m, n), (..., m) -> (..., n)``."""
    ata = a.mT @ a
    atb = (a.mT @ b.unsqueeze(-1))
    eye = torch.eye(ata.shape[-1], dtype=a.dtype, device=a.device)
    x, _ = torch.linalg.solve_ex(ata + 1e-12 * eye, atb, check_errors=False)
    return x.squeeze(-1)


def _betas_approx_1(l_mat, rho):
    # Columns (b11, b12, b13, b14), by slices: an index list would be copied
    # to the device on every call.
    b = _lstsq(torch.cat([l_mat[..., 0:2], l_mat[..., 3:4], l_mat[..., 6:7]], dim=-1), rho)
    b1 = torch.sqrt(torch.abs(b[..., 0]))
    sign = torch.sign(b[..., 0])
    return torch.stack([b1, b[..., 1] / b1 * sign, b[..., 2] / b1 * sign,
                        b[..., 3] / b1 * sign], dim=-1)


def _betas_approx_2(l_mat, rho):
    b = _lstsq(l_mat[..., 0:3], rho)
    b1 = torch.sqrt(torch.abs(b[..., 0]))
    b2 = torch.where(b[..., 0] * b[..., 2] < 0.0, 0.0, torch.sqrt(torch.abs(b[..., 2])))
    b1 = torch.where(b[..., 1] < 0, -b1, b1)
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, z, z], dim=-1)


def _betas_approx_3(l_mat, rho):
    b = _lstsq(l_mat[..., 0:5], rho)
    b1 = torch.sqrt(torch.abs(b[..., 0]))
    b2 = torch.where(b[..., 0] * b[..., 2] < 0.0, 0.0, torch.sqrt(torch.abs(b[..., 2])))
    b1 = torch.where(b[..., 1] < 0, -b1, b1)
    b3 = torch.where(b1 != 0, b[..., 3] / b1, 0.0)
    return torch.stack([b1, b2, b3, torch.zeros_like(b1)], dim=-1)


def _gauss_newton(l_mat, rho, betas):
    """10 Gauss-Newton steps on the control-point distances."""
    for _ in range(_GN_ITERS):
        b1, b2, b3, b4 = betas.unbind(-1)
        prod = torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3, b1 * b4,
                            b2 * b4, b3 * b4, b4 * b4], dim=-1)
        res = (l_mat @ prod.unsqueeze(-1)).squeeze(-1) - rho
        z = torch.zeros_like(b1)
        jac_rows = torch.stack([
            torch.stack([2 * b1, z, z, z], -1), torch.stack([b2, b1, z, z], -1),
            torch.stack([z, 2 * b2, z, z], -1), torch.stack([b3, z, b1, z], -1),
            torch.stack([z, b3, b2, z], -1), torch.stack([z, z, 2 * b3, z], -1),
            torch.stack([b4, z, z, b1], -1), torch.stack([z, b4, z, b2], -1),
            torch.stack([z, z, b4, b3], -1), torch.stack([z, z, z, 2 * b4], -1),
        ], dim=-2)  # (..., 10, 4)
        betas = betas + _lstsq(l_mat @ jac_rows, -res)
    return betas


def _compute_ccs_pcs(betas, vs, alphas, w):
    ccs = (betas.unsqueeze(-2) @ vs).squeeze(-2).reshape(*betas.shape[:-1], 4, 3)
    pcs = alphas @ ccs
    signs = torch.sign(pcs[..., 2])
    flip = (signs if w is None else w * signs).sum(dim=-1) < 0
    s = torch.where(flip, -1.0, 1.0).to(ccs.dtype)[..., None, None]
    return ccs * s, pcs * s


def _horn_rt(pws, pcs, w):
    """R, t with pcs ~= R @ pws + t (no scale), by a 3x3 SVD."""
    if w is None:
        cw, cc = pws.mean(dim=-2), pcs.mean(dim=-2)
        a = pws - cw.unsqueeze(-2)
    else:
        sw = w.sum(dim=-1)
        cw, cc = _wmean(w, pws, sw), _wmean(w, pcs, sw)
        a = (pws - cw.unsqueeze(-2)) * w.unsqueeze(-1)
    b = pcs - cc.unsqueeze(-2)
    u, vt = _svd3(b.mT @ a)
    d = torch.sign(_det3(u @ vt))
    ones = torch.ones_like(d)
    r = (u * torch.stack([ones, ones, d], dim=-1).unsqueeze(-2)) @ vt  # u @ diag(1, 1, d) @ vt
    t = cc - (r @ cw.unsqueeze(-1)).squeeze(-1)
    return r, t


def _transform(pws, r, t):
    """``pws @ r.T + t`` over leading dims."""
    return pws @ r.mT + t.unsqueeze(-2)


def _reproj_error(r, t, pws, uv, w):
    pc = _transform(pws, r, t)
    e = ((pc[..., :2] / pc[..., 2:3] - uv) ** 2).sum(dim=-1)
    if w is None:
        return e.mean(dim=-1)
    return (w * e).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1e-6)


def _epnp_normalized(pws: torch.Tensor, uv: torch.Tensor, w: Optional[torch.Tensor] = None,
                     axes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """EPnP on normalized coords: pws (..., N, 3), uv (..., N, 2), w (..., N),
    the control frame's axis signs ``axes`` (..., 3, 3) -> R (..., 3, 3),
    t (..., 3)."""
    pws = pws.expand(*uv.shape[:-1], 3)
    cws = _choose_control_points(pws, w, axes)
    alphas = _barycentric(pws, cws)
    m = _fill_M(alphas, uv, w)
    _, v = _sym_eigh(m.mT @ m)  # ascending eigenvalues
    vs = v[..., :4].mT  # (..., 4, 12): smallest eigenvalue first
    l_mat = _compute_L6x10(vs)
    rho = _rho(cws)
    errs, rs, ts = [], [], []
    for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
        betas = _gauss_newton(l_mat, rho, approx(l_mat, rho))
        _, pcs = _compute_ccs_pcs(betas, vs, alphas, w)
        r, t = _horn_rt(pws, pcs, w)
        errs.append(_reproj_error(r, t, pws, uv, w))
        rs.append(r)
        ts.append(t)
    best = _first_argmin(torch.stack(errs, dim=-1))  # (...)
    rs, ts = torch.stack(rs, dim=-3), torch.stack(ts, dim=-2)  # (..., 3, 3, 3), (..., 3, 3)
    r = torch.gather(rs, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))
    t = torch.gather(ts, -2, best[..., None, None].expand(*best.shape, 1, 3))
    return r.squeeze(-3), t.squeeze(-2)


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], dim=-2)


def _exp_so3_times(omega: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``exp(skew(omega)) @ r`` by Rodrigues' formula."""
    th = torch.linalg.vector_norm(omega, dim=-1) + 1e-12
    k = _skew(omega / th.unsqueeze(-1))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    th = th[..., None, None]
    return (eye + torch.sin(th) * k + (1 - torch.cos(th)) * (k @ k)) @ r


def _point_jacobian(pc, du, dv):
    """Rows of d(u, v)/d(omega, t): (..., N, 2, 6)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zero = torch.zeros_like(x)
    skew_pc = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(
        *pc.shape[:-1], 3, 3)
    ju = torch.cat([-(du.unsqueeze(-2) @ skew_pc).squeeze(-2), du], dim=-1)
    jv = torch.cat([-(dv.unsqueeze(-2) @ skew_pc).squeeze(-2), dv], dim=-1)
    return torch.stack([ju, jv], dim=-2)


def _refine_pose(r, t, pws, uv, iters: int = 5, w: Optional[torch.Tensor] = None):
    """Gauss-Newton reprojection refinement on se(3), ``iters`` steps."""
    sqw = None if w is None else torch.sqrt(w).unsqueeze(-1)
    for _ in range(iters):
        pc = _transform(pws, r, t)
        res = pc[..., :2] / pc[..., 2:3] - uv
        if sqw is not None:
            res = res * sqw
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        inv_z = 1.0 / z
        u, v = x * inv_z, y * inv_z
        zero = torch.zeros_like(z)
        du = torch.stack([inv_z, zero, -u * inv_z], dim=-1)
        dv = torch.stack([zero, inv_z, -v * inv_z], dim=-1)
        j = _point_jacobian(pc, du, dv)
        if sqw is not None:
            j = j * sqw.unsqueeze(-1)
        delta = _lstsq(j.reshape(*j.shape[:-3], -1, 6), -res.reshape(*res.shape[:-2], -1))
        r, t = _exp_so3_times(delta[..., :3], r), t + delta[..., 3:]
    return r, t


def _identity_guard(r, t):
    """Non-finite solves -> identity pose and t = [0, 0, 10]."""
    bad = ~(torch.isfinite(r).flatten(-2).all(dim=-1) & torch.isfinite(t).all(dim=-1))
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand_as(r)
    z = torch.zeros_like(t[..., 0])
    return _where(bad, eye, r), _where(bad, torch.stack([z, z, z + 10.0], dim=-1), t)


def _keep_if_better(r0, t0, r, t, e0, e1):
    """The refined pose only where its error is finite and not above e0."""
    worse = ~(torch.isfinite(e1) & (e1 <= e0))
    return _where(worse, r0, r), _where(worse, t0, t)


def _refined_full_solve(pws, uv, w, axes):
    r0, t0 = _epnp_normalized(pws, uv, w, axes)
    r, t = _refine_pose(r0, t0, pws, uv, w=w)
    return _keep_if_better(r0, t0, r, t, _reproj_error(r0, t0, pws, uv, w),
                           _reproj_error(r, t, pws, uv, w))


def _as(x, ref: torch.Tensor) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def epnp_solve(pts3d, pts2d, K, dist=None, refine: bool = True, weights=None, axes=None):
    """One PnP problem: world points (N, 3) + pixels (N, 2) -> (R, t)."""
    pts2d = torch.as_tensor(pts2d)
    pts3d, K, dist, weights, axes = (_as(x, pts2d) for x in (pts3d, K, dist, weights, axes))
    uv = undistort_points(pts2d, K, dist)
    r, t = _epnp_normalized(pts3d, uv, weights, axes)
    if refine:
        r, t = _refine_pose(r, t, pts3d, uv, w=weights)
    return r, t


def epnp_solve_batch(pts3d, pts2d, K, dist=None, refine: bool = True, weights=None,
                     axes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched solve: ``pts3d`` (N, 3) shared, ``pts2d`` (B, N, 2) pixels,
    optional ``weights`` (B, N) -> ``(R (B, 3, 3), t (B, 3))``.  The
    refinement is kept only where it lowers the reprojection error; a
    non-finite solve gives the identity pose and ``t = [0, 0, 10]``.
    ``axes`` (3, 3): the signs of the control frame's principal axes (rows,
    descending spread; ``codec.keypoints.TANGO_AXES``), else ``eigh``'s."""
    pts2d = torch.as_tensor(pts2d)
    pts3d, K, dist, weights, axes = (_as(x, pts2d) for x in (pts3d, K, dist, weights, axes))
    uv = undistort_points(pts2d, K, dist)
    if refine:
        r, t = _refined_full_solve(pts3d, uv, weights, axes)
    else:
        r, t = _epnp_normalized(pts3d, uv, weights, axes)
    return _identity_guard(r, t)


def _project_clamped(pws, r, t):
    pc = _transform(pws, r, t)
    return pc, pc[..., :2] / torch.clamp(pc[..., 2:3], min=1e-6)


def _inliers(pws, r, t, uv, thr, valid):
    pc, proj = _project_clamped(pws, r, t)
    inl = (torch.linalg.vector_norm(proj - uv, dim=-1) < thr) & (pc[..., 2] > 0)
    return inl if valid is None else inl & valid


def epnp_ransac(pts3d, pts2d, K, dist=None, subsets=None, inlier_threshold_px: float = 8.0,
                refine: bool = True, weights=None, axes=None, subset_axes=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC-robust batched EPnP: (B, N, 2) pixels -> (R, t, inlier mask).

    ``subsets`` (H, S) point indices, one EPnP hypothesis each, shared by
    the batch; the default is :data:`RANSAC_SUBSETS`, JAX's table for 11
    points.  The best hypothesis by inlier count replaces the all-point
    solve only where it has strictly more inliers; the winner is refined by
    10 Gauss-Newton steps on its inliers, kept where that lowers the masked
    error.  Zero-weight points neither take part in a solve nor vote.
    ``axes`` (3, 3) and ``subset_axes`` (H, 3, 3): the control frames' axis
    signs of the all-point solve and of each subset's.
    """
    pts2d = torch.as_tensor(pts2d)
    pts3d, K, dist, weights, axes, subset_axes = (
        _as(x, pts2d) for x in (pts3d, K, dist, weights, axes, subset_axes))
    n = pts3d.shape[0]
    if subsets is None:
        if n != 11:
            raise ValueError(f"the default subset table is for 11 points, got {n}: pass subsets")
        subsets = RANSAC_SUBSETS
    subsets = torch.as_tensor(subsets, dtype=torch.long, device=pts2d.device)
    thr = inlier_threshold_px / K[0, 0]
    uv = undistort_points(pts2d, K, dist)  # (B, N, 2)
    valid = None if weights is None else weights > 0

    # Hypotheses, (B, H, ...): EPnP on each subset, scored on every point.
    sel_w = None if weights is None else weights[:, subsets]
    rs, ts = _epnp_normalized(pts3d[subsets], uv[:, subsets], sel_w, subset_axes)
    inl = _inliers(pts3d, rs, ts, uv.unsqueeze(1), thr,
                   None if valid is None else valid.unsqueeze(1))
    counts = inl.sum(dim=-1)
    best = _first_argmax(counts)
    r0, t0, inliers, best_count = _take(rs, best), _take(ts, best), _take(inl, best), \
        _take(counts.unsqueeze(-1), best)[:, 0]

    # The full-set anchor: a hypothesis wins only by strictly more inliers.
    rf, tf = _refined_full_solve(pts3d, uv, weights, axes)
    inliers_f = _inliers(pts3d, rf, tf, uv, thr, valid)
    use_hyp = best_count > inliers_f.sum(dim=-1)
    r0, t0 = _where(use_hyp, r0, rf), _where(use_hyp, t0, tf)
    inliers = _where(use_hyp, inliers, inliers_f)
    r, t = r0, t0

    if refine:
        w = inliers.to(uv.dtype).unsqueeze(-1)  # (B, N, 1)
        if weights is not None:
            w = w * weights.unsqueeze(-1)

        def masked_err(r_, t_):
            _, proj = _project_clamped(pts3d, r_, t_)
            return (((proj - uv) * w) ** 2).sum(dim=(-2, -1))

        for _ in range(_GN_ITERS):
            pc, proj = _project_clamped(pts3d, r, t)
            res = ((proj - uv) * w).reshape(uv.shape[0], -1)
            x, y, z = pc[..., 0], pc[..., 1], torch.clamp(pc[..., 2], min=1e-6)
            inv_z = 1.0 / z
            zero = torch.zeros_like(z)
            du = torch.stack([inv_z, zero, -x * inv_z * inv_z], dim=-1)
            dv = torch.stack([zero, inv_z, -y * inv_z * inv_z], dim=-1)
            jmat = _point_jacobian(torch.stack([x, y, z], dim=-1), du, dv) * w.unsqueeze(-1)
            delta = _lstsq(jmat.reshape(uv.shape[0], -1, 6), -res)
            r, t = _exp_so3_times(delta[..., :3], r), t + delta[..., 3:]
        r, t = _keep_if_better(r0, t0, r, t, masked_err(r0, t0), masked_err(r, t))
    r, t = _identity_guard(r, t)
    return r, t, inliers
