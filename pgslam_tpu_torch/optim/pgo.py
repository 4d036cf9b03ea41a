"""SE(3) pose-graph optimization by Levenberg-Marquardt with a
block-Jacobi preconditioned conjugate-gradient solve. Counterpart of
:mod:`pgslam_tpu.optim.pgo`.

``optimize_pose_graph`` dispatches on the device of its inputs: CUDA
tensors run the whole LM in one launch of K3 (:mod:`.lm`), CPU tensors
run ``lm_optimize_plain``, the port of ``pgo._optimize_xla`` and K3's
plain version. Twists and covariances are in [t; r] order; the anchor
vertex gets a prior with sigma ``prior_sigma``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import se3


@dataclasses.dataclass(frozen=True)
class PGOConfig:
    """Same fields and defaults as ``pgslam_tpu.optim.pgo.PGOConfig``.
    Every PCG solver name selects the one block-Jacobi PCG LM here."""
    max_iterations: int = 50
    solver: str = "pcg"
    cg_iterations: int = 64
    cg_tol: float = 1e-4
    lambda_init: float = 1e-6
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    prior_sigma: float = 1e-6
    min_step_norm: float = 1e-8
    min_cost_decrease: float = 1e-7
    assembly: str = "auto"
    robust: str = "none"
    robust_delta: float = 1.0


PCG_SOLVERS = ("pcg", "pcg_xla", "lm_pallas")
ROBUST = ("none", "huber", "cauchy", "gm")


def check_supported(config: PGOConfig) -> None:
    if config.solver not in PCG_SOLVERS:
        raise NotImplementedError(
            f"solver {config.solver!r} is not ported yet (dense Cholesky "
            f"and the CG-only kernel wait)")
    if config.robust not in ROBUST:
        raise ValueError(f"unknown robust kernel {config.robust!r}")


def _ad(xi: torch.Tensor) -> torch.Tensor:
    """Little ad of a twist in [t; r] order: [[hat w, hat v], [0, hat w]]."""
    hw, hv = se3.hat(xi[..., 3:]), se3.hat(xi[..., :3])
    top = torch.cat([hw, hv], -1)
    bot = torch.cat([torch.zeros_like(hw), hw], -1)
    return torch.cat([top, bot], -2)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of (batched) 3x3 matrices."""
    c1 = torch.linalg.cross(A[..., 1, :], A[..., 2, :], dim=-1)
    c2 = torch.linalg.cross(A[..., 2, :], A[..., 0, :], dim=-1)
    c3 = torch.linalg.cross(A[..., 0, :], A[..., 1, :], dim=-1)
    det = (A[..., 0, :] * c1).sum(-1)[..., None, None]
    return torch.stack([c1, c2, c3], -1) / det


def spd_inverse6(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of SPD 6x6 blocks via the Schur complement of
    the leading 3x3 block."""
    A, B, C = M[..., :3, :3], M[..., :3, 3:], M[..., 3:, 3:]
    Ai = inv3(A)
    AiB = Ai @ B
    Si = inv3(C - B.transpose(-1, -2) @ AiB)
    AiBSi = AiB @ Si
    TL = Ai + AiBSi @ AiB.transpose(-1, -2)
    TR = -AiBSi
    return torch.cat([torch.cat([TL, TR], -1),
                      torch.cat([TR.transpose(-1, -2), Si], -1)], -2)


def _jr_inv(e: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SE(3), 2nd order:
    I + ad(e)/2 + ad(e)^2/12."""
    a = _ad(e)
    eye = torch.eye(6, dtype=e.dtype, device=e.device)
    return eye + 0.5 * a + (1.0 / 12.0) * (a @ a)


def robust_weight(chi2, config: PGOConfig, robust_emask):
    """IRLS weight per edge, or None without a robust kernel."""
    if config.robust == "none":
        return None
    d = config.robust_delta
    if config.robust == "huber":
        w = torch.clamp(d / torch.sqrt(torch.clamp(chi2, min=1e-30)),
                        max=1.0)
    elif config.robust == "cauchy":
        w = 1.0 / (1.0 + chi2 / (d * d))
    else:
        w = (d * d / (d * d + chi2)) ** 2
    if robust_emask is not None:
        w = torch.where(robust_emask, w, 1.0)
    return w


def robust_cost(chi2, config: PGOConfig, robust_emask):
    """rho(chi2), consistent with :func:`robust_weight`."""
    if config.robust == "none":
        return chi2
    d = config.robust_delta
    if config.robust == "huber":
        r = torch.sqrt(torch.clamp(chi2, min=1e-30))
        rho = torch.where(r <= d, chi2, 2.0 * d * r - d * d)
    elif config.robust == "cauchy":
        rho = d * d * torch.log1p(chi2 / (d * d))
    else:
        rho = d * d * chi2 / (d * d + chi2)
    return rho if robust_emask is None else torch.where(robust_emask, rho,
                                                        chi2)


def prior_residual(X, X0, X0_inv):
    """``log(X0^-1 X)``, evaluated as ``log(I + X0^-1 (X - X0))``. The two
    are equal in exact arithmetic, but the prior's information (1e12 at
    sigma 1e-6) turns the fp32 rounding of ``X0^-1 X`` (~1e-7 at the
    anchor's initial pose) into a gradient of ~1e5 that swamps the CG
    residual and ends the solve after one step. This form is exactly 0
    at the initial pose."""
    eye = torch.eye(4, dtype=X.dtype, device=X.device)
    return se3.log(eye + X0_inv @ (X - X0))


def _quad(e, info):
    """e^T info e per edge."""
    return (e[:, None, :] @ info @ e[:, :, None])[:, 0, 0]


def lm_optimize_plain(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                      emask, fixed_id, robust_emask=None, *,
                      config: PGOConfig = PGOConfig()):
    """Plain PyTorch LM (K3's plain version). Returns (poses, stats) with
    stats ``initial_cost``, ``final_cost``, ``iterations``, ``lambda``."""
    V = poses.shape[0]
    dev, dtype = poses.device, poses.dtype
    fixed = int(fixed_id)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    prior_info = torch.tensor(1.0 / config.prior_sigma ** 2, dtype=dtype,
                              device=dev)
    prior_Tinv = se3.inverse(poses[fixed])
    Tinv_meas = se3.inverse(edge_T)
    info = spd_inverse6(torch.where(emask[:, None, None], edge_cov, eye6))
    info = torch.where(emask[:, None, None], info, 0.0)
    ef = torch.clamp(edge_from.long(), 0, V - 1)
    et = torch.clamp(edge_to.long(), 0, V - 1)

    def scatter(y, idx):
        return torch.zeros((V,) + tuple(y.shape[1:]), dtype=dtype,
                           device=dev).index_add_(0, idx, y)

    def edge_residuals(cur):
        M = se3.inverse(cur[ef]) @ cur[et]
        return se3.log(Tinv_meas @ M), M

    def build_system(cur):
        e, M = edge_residuals(cur)
        rw = robust_weight(_quad(e, info), config, robust_emask)
        info_e = info if rw is None else info * rw[:, None, None]
        Jt = _jr_inv(e)
        Jf = -Jt @ se3.adjoint(se3.inverse(M))
        JtT_O = Jt.transpose(-1, -2) @ info_e
        JfT_O = Jf.transpose(-1, -2) @ info_e
        H_tt, H_ff, H_ft = JtT_O @ Jt, JfT_O @ Jf, JfT_O @ Jt
        b = scatter((JfT_O @ e[..., None])[..., 0], ef) \
            + scatter((JtT_O @ e[..., None])[..., 0], et)
        rp = prior_residual(cur[fixed], poses[fixed], prior_Tinv)
        b[fixed] += prior_info * rp
        D = scatter(H_ff, ef) + scatter(H_tt, et)
        D[fixed] += prior_info * eye6
        return (H_ff, H_tt, H_ft), b, D

    def matvec(blocks, D, lam, x):
        H_ff, H_tt, H_ft = blocks
        xf, xt = x[ef][..., None], x[et][..., None]
        yf = (H_ff @ xf + H_ft @ xt)[..., 0]
        yt = (H_tt @ xt + H_ft.transpose(-1, -2) @ xf)[..., 0]
        y = scatter(yf, ef) + scatter(yt, et)
        y[fixed] += prior_info * x[fixed]
        return y + lam * torch.diagonal(D, dim1=-2, dim2=-1) * x

    def pcg(blocks, D, lam, b):
        diag_term = lam * torch.diagonal(D, dim1=-2, dim2=-1)
        P = torch.where(vmask[:, None, None], D + torch.diag_embed(diag_term),
                        eye6)
        P_inv = spd_inverse6(P + 1e-10 * eye6)
        rhs = -b
        x = torch.zeros_like(rhs)
        r = rhs
        z = (P_inv @ r[..., None])[..., 0]
        p = z
        rz = (r * z).sum()
        rhs_norm2 = torch.clamp((rhs * rhs).sum(), min=1e-30)
        it = 0
        while it < config.cg_iterations and \
                bool((r * r).sum() > config.cg_tol * rhs_norm2):
            Ap = matvec(blocks, D, lam, p)
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = (P_inv @ r[..., None])[..., 0]
            rz_new = (r * z).sum()
            p = z + rz_new / torch.clamp(rz, min=1e-30) * p
            rz = rz_new
            it += 1
        return x

    def cost_fn(cur):
        e, _ = edge_residuals(cur)
        c = robust_cost(_quad(e, info), config, robust_emask)
        rp = prior_residual(cur[fixed], poses[fixed], prior_Tinv)
        return torch.where(emask, c, 0.0).sum() + prior_info * (rp * rp).sum()

    cur = poses
    lam = torch.tensor(config.lambda_init, dtype=dtype, device=dev)
    cost = init_cost = cost_fn(poses)
    it, done = 0, False
    while it < config.max_iterations and not done:
        blocks, b, D = build_system(cur)
        delta = torch.where(vmask[:, None], pcg(blocks, D, lam, b), 0.0)
        cand = torch.where(vmask[:, None, None], cur @ se3.exp(delta), cur)
        new_cost = cost_fn(cand)
        accept = bool(new_cost < cost)
        step_norm = torch.linalg.norm(delta)
        rel_decrease = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        if accept:
            cur, cost = cand, new_cost
            lam = lam * config.lambda_down
            done = bool((step_norm < config.min_step_norm)
                        | (rel_decrease < config.min_cost_decrease))
        else:
            lam = lam * config.lambda_up
        lam = torch.clamp(lam, 1e-12, 1e10)
        it += 1
    stats = {"initial_cost": init_cost, "final_cost": cost,
             "iterations": torch.tensor(it, dtype=torch.int32),
             "lambda": lam}
    return finish_poses(cur, poses, vmask), stats


def finish_poses(final, poses, vmask):
    """Re-orthonormalize the optimized rotations; invalid vertices pass
    through unchanged."""
    final = se3.normalize_rotation_fast(final)
    return torch.where(vmask[:, None, None], final, poses)


def optimize_pose_graph(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                        emask, fixed_id, robust_emask=None,
                        config: PGOConfig = PGOConfig()):
    """Run LM on the pose graph; returns (optimized poses, stats dict).
    CUDA tensors run K3, CPU tensors the plain LM. Padded entries
    (``vmask`` / ``emask`` False) contribute nothing."""
    check_supported(config)
    from .lm import lm_optimize
    return lm_optimize(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                       emask, fixed_id, robust_emask, config=config)
