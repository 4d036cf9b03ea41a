"""SE(3) pose-graph optimization by Levenberg-Marquardt. Counterpart of
:mod:`pgslam_tpu.optim.pgo`.

``optimize_pose_graph`` routes as ``pgslam_tpu.optim.pgo`` does
(:func:`route`): the whole LM in one launch of K3 (:mod:`.lm`) for
graphs of up to ``K3_MAX_SIZE`` vertices and edges on the card, else
``lm_optimize_loop``, the port of ``pgo._optimize_xla``, with one of
three linear solves: ``pcg_solve_plain`` (the block-Jacobi PCG),
``pcg_solve`` (the same solve as one launch of K4, :mod:`.pcg`) or
``dense_solve`` (Cholesky of the assembled normal matrix). Twists and
covariances are in [t; r] order; the anchor vertex gets a prior with
sigma ``prior_sigma``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import se3


@dataclasses.dataclass(frozen=True)
class PGOConfig:
    """Same fields and defaults as ``pgslam_tpu.optim.pgo.PGOConfig``.
    ``assembly`` picks the TPU's incidence matmuls or scatters there; the
    port always gathers and scatters, and ignores it."""
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


ROBUST = ("none", "huber", "cauchy", "gm")
# Under ``"pcg"`` the whole-LM kernel K3 takes graphs with V + E up to
# this many vertices and edges (padded shapes, as ``Optimizer`` pads them
# to powers of two), the LM loop with K4 larger ones. K3 runs one
# thread-block cluster of up to 16 CTAs; the LM loop with K4 spreads each
# CG step over the card but pays a host cost per LM iteration that hardly
# depends on the graph. ``python3 chip_smoke.py --crossover`` (K3 against
# the K4 loop under the default PGOConfig on ring trajectories padded as
# ``Optimizer`` pads them, E = V and E = 2V, on an NVIDIA H100 80GB HBM3
# at a 700 W power limit) found K3 faster at every size up to 16384 +
# 32768; the gate stops where K3's working set no longer fits the shared
# memory of the largest cluster that schedules there (4096 + 4096 fits 14
# CTAs; 4096 + 8192 does not, and would run from global scratch). The
# card's counterpart of the JAX package's ``fits_vmem`` /
# ``layout_plan`` gate.
K3_MAX_SIZE = 8192
DENSE_MAX_ROWS = 8192     # "auto" factorizes while 6V <= this


def check_supported(config: PGOConfig) -> None:
    """Every solver name routes (unknown ones to the plain PCG, as in
    ``_optimize_xla``); an unknown robust kernel raises."""
    if config.robust not in ROBUST:
        raise ValueError(f"unknown robust kernel {config.robust!r}")


def route(config: PGOConfig, n_vertices: int, n_edges: int,
          device) -> str:
    """Which path ``optimize_pose_graph`` takes: ``"lm"`` (K3's wrapper:
    the kernel on CUDA, ``lm_optimize_plain`` on the CPU) or the linear
    solve of ``lm_optimize_loop``: ``"dense"``, ``"pcg"`` (K4's wrapper)
    or ``"pcg_plain"``. Mirrors ``pgo.optimize_pose_graph`` and the solve
    selection of ``pgo._optimize_xla``."""
    solver = config.solver
    on_card = torch.device(device).type == "cuda"
    if solver == "lm_pallas":
        return "lm"
    if solver == "pcg":
        large = n_vertices + n_edges > K3_MAX_SIZE
        return "pcg" if on_card and large else "lm"
    if solver == "cholesky" or (solver == "auto"
                                and 6 * n_vertices <= DENSE_MAX_ROWS):
        return "dense"
    if solver == "pcg_pallas":
        return "pcg"
    return "pcg_plain"


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


def block_jacobi(D, lam, vmask):
    """The PCG's preconditioner and damping: ``P_inv`` [V, 6, 6], the
    inverse of each vertex's damped diagonal block (identity at padded
    vertices), and ``damp_diag = lam * diag(D)`` [V, 6]."""
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    damp_diag = lam * torch.diagonal(D, dim1=-2, dim2=-1)
    P = torch.where(vmask[:, None, None], D + torch.diag_embed(damp_diag),
                    eye6)
    return spd_inverse6(P + 1e-10 * eye6), damp_diag


def _scatter(y, idx, V):
    return torch.zeros((V,) + tuple(y.shape[1:]), dtype=y.dtype,
                       device=y.device).index_add_(0, idx, y)


def system_matvec(blocks, damp_diag, prior_info, fixed_id, edge_from,
                  edge_to, x):
    """``(H + prior + diag(damp_diag)) x`` for x [V, 6], matrix-free."""
    H_ff, H_tt, H_ft = blocks
    V, fixed = x.shape[0], int(fixed_id)
    xf, xt = x[edge_from][..., None], x[edge_to][..., None]
    yf = (H_ff @ xf + H_ft @ xt)[..., 0]
    yt = (H_tt @ xt + H_ft.transpose(-1, -2) @ xf)[..., 0]
    y = _scatter(yf, edge_from, V) + _scatter(yt, edge_to, V)
    y[fixed] += prior_info * x[fixed]
    return y + damp_diag * x


def pcg_solve_plain(blocks, P_inv, damp_diag, b, prior_info, fixed_id,
                    edge_from, edge_to, *, cg_iterations: int,
                    cg_tol: float, return_iterations: bool = False):
    """Block-Jacobi PCG for ``(H + prior + diag(damp_diag)) x = -b`` from
    x = 0, with H applied matrix-free from the per-edge blocks
    ``(H_ff, H_tt, H_ft)`` [E, 6, 6]; ``edge_from`` / ``edge_to`` are in
    range. Stops after ``cg_iterations`` or once ``|r|^2 <= cg_tol |b|^2``.
    K4's plain version and the ``"pcg_xla"`` solve; reads the stop test
    on the host, one sync per CG step. Returns x [V, 6] (and the step
    count with ``return_iterations``)."""
    fixed = int(fixed_id)
    rhs = -b
    x = torch.zeros_like(rhs)
    r = rhs
    z = (P_inv @ r[..., None])[..., 0]
    p = z
    rz = (r * z).sum()
    rhs_norm2 = torch.clamp((rhs * rhs).sum(), min=1e-30)
    it = 0
    while it < cg_iterations and \
            bool((r * r).sum() > cg_tol * rhs_norm2):
        Ap = system_matvec(blocks, damp_diag, prior_info, fixed, edge_from,
                           edge_to, p)
        alpha = rz / torch.clamp((p * Ap).sum(), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = (P_inv @ r[..., None])[..., 0]
        rz_new = (r * z).sum()
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz = rz_new
        it += 1
    return (x, it) if return_iterations else x


def _dense_matrix(blocks, damping, vmask, prior_info, fixed, ef, et):
    """The 6V x 6V normal matrix from the [V, V, 6, 6] block grid, with
    the prior on the fixed vertex and ``damping + 1e-8`` on the diagonal
    (1 more on the rows of padded vertices)."""
    H_ff, H_tt, H_ft = blocks
    V = vmask.shape[0]
    dtype, dev = H_ff.dtype, H_ff.device
    Hb = torch.zeros((V * V, 6, 6), dtype=dtype, device=dev)
    Hb.index_add_(0, ef * V + ef, H_ff)
    Hb.index_add_(0, et * V + et, H_tt)
    Hb.index_add_(0, ef * V + et, H_ft)
    Hb.index_add_(0, et * V + ef, H_ft.transpose(-1, -2))
    H = Hb.view(V, V, 6, 6).permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
    rows = slice(6 * fixed, 6 * fixed + 6)
    H[rows, rows] += prior_info * torch.eye(6, dtype=dtype, device=dev)
    pad = (~vmask).repeat_interleave(6).to(dtype)
    H.diagonal().add_(damping + pad + 1e-8)
    return H


def dense_solve(blocks, D, lam, b, vmask, prior_info, fixed_id, edge_from,
                edge_to):
    """Exact Newton step: Cholesky solve of the assembled normal matrix
    damped by ``lam * diag(D)``. Port of ``_optimize_xla``'s
    ``dense_solve``; the factorization is PyTorch's, as the JAX package
    leaves it to XLA."""
    damping = lam * torch.diagonal(D, dim1=-2, dim2=-1).reshape(-1)
    H = _dense_matrix(blocks, damping, vmask, prior_info, int(fixed_id),
                      edge_from, edge_to)
    # No info check (a sync): a failed factorization gives a non-finite
    # step that LM rejects, as in the JAX package.
    L, _ = torch.linalg.cholesky_ex(H)
    return torch.cholesky_solve(-b.reshape(-1, 1), L).reshape(b.shape)


class LMProblem:
    """The fixed parts of one optimize (information matrices, clamped
    endpoints, the anchor prior) and its two evaluations at poses
    ``cur``: the linear system and the cost."""

    def __init__(self, poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                 emask, fixed_id, robust_emask=None, *,
                 config: PGOConfig = PGOConfig()):
        V = poses.shape[0]
        dev, dtype = poses.device, poses.dtype
        self.config, self.poses, self.vmask = config, poses, vmask
        self.emask, self.robust_emask = emask, robust_emask
        self.fixed = int(fixed_id)
        self.eye6 = torch.eye(6, dtype=dtype, device=dev)
        # Scalars are filled on the device: a copy from the host would
        # synchronize the stream.
        self.prior_info = torch.full((), 1.0 / config.prior_sigma ** 2,
                                     dtype=dtype, device=dev)
        self.prior_Tinv = se3.inverse(poses[self.fixed])
        self.Tinv_meas = se3.inverse(edge_T)
        info = spd_inverse6(torch.where(emask[:, None, None], edge_cov,
                                        self.eye6))
        self.info = torch.where(emask[:, None, None], info, 0.0)
        self.ef = torch.clamp(edge_from.long(), 0, V - 1)
        self.et = torch.clamp(edge_to.long(), 0, V - 1)

    def edge_residuals(self, cur):
        M = se3.inverse(cur[self.ef]) @ cur[self.et]
        return se3.log(self.Tinv_meas @ M), M

    def prior(self, cur):
        return prior_residual(cur[self.fixed], self.poses[self.fixed],
                              self.prior_Tinv)

    def system(self, cur):
        """Per-edge blocks ``(H_ff, H_tt, H_ft)`` [E, 6, 6], gradient b
        [V, 6] and block diagonal D [V, 6, 6] (prior included)."""
        V, fixed = cur.shape[0], self.fixed
        e, M = self.edge_residuals(cur)
        rw = robust_weight(_quad(e, self.info), self.config,
                           self.robust_emask)
        info_e = self.info if rw is None else self.info * rw[:, None, None]
        Jt = _jr_inv(e)
        Jf = -Jt @ se3.adjoint(se3.inverse(M))
        JtT_O = Jt.transpose(-1, -2) @ info_e
        JfT_O = Jf.transpose(-1, -2) @ info_e
        H_tt, H_ff, H_ft = JtT_O @ Jt, JfT_O @ Jf, JfT_O @ Jt
        b = _scatter((JfT_O @ e[..., None])[..., 0], self.ef, V) \
            + _scatter((JtT_O @ e[..., None])[..., 0], self.et, V)
        b[fixed] += self.prior_info * self.prior(cur)
        D = _scatter(H_ff, self.ef, V) + _scatter(H_tt, self.et, V)
        D[fixed] += self.prior_info * self.eye6
        return (H_ff, H_tt, H_ft), b, D

    def cost(self, cur):
        e, _ = self.edge_residuals(cur)
        c = robust_cost(_quad(e, self.info), self.config, self.robust_emask)
        rp = self.prior(cur)
        return torch.where(self.emask, c, 0.0).sum() \
            + self.prior_info * (rp * rp).sum()


SOLVES = ("pcg_plain", "pcg", "dense")


def lm_optimize_loop(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                     emask, fixed_id, robust_emask=None, *,
                     config: PGOConfig = PGOConfig(),
                     solve: str = "pcg_plain", ptr_host=None):
    """The LM loop (port of ``pgo._optimize_xla``) with the linear solve
    ``solve``: ``"pcg_plain"`` (:func:`pcg_solve_plain`), ``"pcg"`` (K4's
    wrapper :func:`.pcg.pcg_solve`; its plan, the edge CSR order, layout,
    slot tables and scratch, is built once here, from ``ptr_host``, the
    host's :func:`.lm.edge_csr_ptr_host` of the graph, where given) or
    ``"dense"`` (:func:`dense_solve`). Returns (poses, stats) with stats
    ``initial_cost``, ``final_cost``, ``iterations``, ``lambda`` and
    ``cg_steps`` (PCG steps over the whole optimize, 0 for the dense
    solve).

    Host syncs: one per LM iteration (accept / stop), plus one per CG
    step with ``pcg_solve_plain``; K4 and the dense solve add none."""
    if solve not in SOLVES:
        raise ValueError(f"unknown solve {solve!r}")
    prob = LMProblem(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                     emask, fixed_id, robust_emask, config=config)
    ef, et, fixed, prior_info = prob.ef, prob.et, prob.fixed, prob.prior_info
    if solve == "pcg":
        from .pcg import k4_plan, pcg_solve
        plan = (k4_plan(ef, et, poses.shape[0], emask, ptr_host=ptr_host)
                if poses.device.type == "cuda" else None)

    def linear_solve(blocks, D, lam, b):
        """Returns (x, CG steps)."""
        if solve == "dense":
            return dense_solve(blocks, D, lam, b, vmask, prior_info, fixed,
                               ef, et), 0
        P_inv, damp_diag = block_jacobi(D, lam, vmask)
        kw = dict(cg_iterations=config.cg_iterations, cg_tol=config.cg_tol,
                  return_iterations=True)
        if solve == "pcg":
            return pcg_solve(blocks, P_inv, damp_diag, b, prior_info, fixed,
                             ef, et, plan=plan, **kw)
        return pcg_solve_plain(blocks, P_inv, damp_diag, b, prior_info,
                               fixed, ef, et, **kw)

    cur = poses
    lam = torch.full((), config.lambda_init, dtype=poses.dtype,
                     device=poses.device)
    cost = init_cost = prob.cost(poses)
    it, done, cg_steps = 0, False, 0
    while it < config.max_iterations and not done:
        blocks, b, D = prob.system(cur)
        x, steps = linear_solve(blocks, D, lam, b)
        cg_steps = cg_steps + steps
        delta = torch.where(vmask[:, None], x, 0.0)
        cand = torch.where(vmask[:, None, None], cur @ se3.exp(delta), cur)
        new_cost = prob.cost(cand)
        rel_decrease = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        small = (torch.linalg.norm(delta) < config.min_step_norm) \
            | (rel_decrease < config.min_cost_decrease)
        accept, small = torch.stack([new_cost < cost, small]).tolist()
        if accept:
            cur, cost = cand, new_cost
            lam = lam * config.lambda_down
            done = small
        else:
            lam = lam * config.lambda_up
        lam = torch.clamp(lam, 1e-12, 1e10)
        it += 1
    stats = {"initial_cost": init_cost, "final_cost": cost,
             "iterations": torch.tensor(it, dtype=torch.int32),
             "lambda": lam,
             "cg_steps": torch.as_tensor(cg_steps, dtype=torch.int32)}
    return finish_poses(cur, poses, vmask), stats


def lm_optimize_plain(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                      emask, fixed_id, robust_emask=None, *,
                      config: PGOConfig = PGOConfig()):
    """Plain PyTorch LM (K3's plain version): the LM loop with the plain
    PCG. Returns (poses, stats) as :func:`lm_optimize_loop`."""
    return lm_optimize_loop(poses, vmask, edge_from, edge_to, edge_T,
                            edge_cov, emask, fixed_id, robust_emask,
                            config=config, solve="pcg_plain")


def finish_poses(final, poses, vmask):
    """Re-orthonormalize the optimized rotations; invalid vertices pass
    through unchanged."""
    final = se3.normalize_rotation_fast(final)
    return torch.where(vmask[:, None, None], final, poses)


def optimize_pose_graph(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                        emask, fixed_id, robust_emask=None,
                        config: PGOConfig = PGOConfig(), ptr_host=None):
    """Run LM on the pose graph; returns (optimized poses, stats dict).
    The path follows :func:`route` on the device of ``poses``. Padded
    entries (``vmask`` / ``emask`` False) contribute nothing.
    ``ptr_host`` (:func:`.lm.edge_csr_ptr_host` of the graph, optional)
    lets K3 and K4 plan their layouts without reading the incidence
    pointer back from the card."""
    check_supported(config)
    args = (poses, vmask, edge_from, edge_to, edge_T, edge_cov, emask,
            fixed_id, robust_emask)
    path = route(config, poses.shape[0], edge_from.shape[0], poses.device)
    if path == "lm":
        from .lm import lm_optimize
        return lm_optimize(*args, config=config, ptr_host=ptr_host)
    return lm_optimize_loop(*args, config=config, solve=path,
                            ptr_host=ptr_host)


def pose_marginals(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                   emask, fixed_id, prior_sigma: float = 1e-6,
                   method: str = "dense"):
    """Per-vertex 6x6 marginal covariances [V, 6, 6] of the pose graph at
    ``poses`` ([t; r] order), zero at padded vertices. Port of
    ``pgo.pose_marginals``: ``"dense"`` inverts the whole information
    matrix (144 V^2 bytes for each of the block grid and the matrix) and
    takes its diagonal blocks; ``"block_diag"`` inverts each vertex's
    diagonal block, the covariance conditioned on its neighbours."""
    if method not in ("dense", "block_diag"):
        raise ValueError(f"unknown method {method!r}")
    prob = LMProblem(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                     emask, fixed_id,
                     config=PGOConfig(prior_sigma=prior_sigma))
    blocks, _, D = prob.system(poses)
    vm, eye6 = vmask[:, None, None], prob.eye6
    if method == "block_diag":
        D = torch.where(vm, D, eye6)
        return torch.where(vm, spd_inverse6(D + 1e-8 * eye6), 0.0)
    H = _dense_matrix(blocks, 0.0, vmask, prob.prior_info, prob.fixed,
                      prob.ef, prob.et)
    V = poses.shape[0]
    Sigma = torch.linalg.inv(H).reshape(V, 6, V, 6)
    idx = torch.arange(V, device=poses.device)
    return torch.where(vm, Sigma[idx, :, idx, :], 0.0)
