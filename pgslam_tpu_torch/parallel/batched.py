"""Batched registration (the headline metric's path, BASELINE config 5's
scan matching): B independent registrations in one call.

Counterpart of :mod:`pgslam_tpu.parallel.batched`. Eligible configs run
as one K2 launch for the whole batch, one thread block per registration;
the rest run ``icp_core`` entry by entry, which is also the CPU's "auto"
route (the JAX package's CPU route is the vmapped ``icp_core``). The
reference's switch ``PGSLAM_FUSED_BATCHED`` ("1" on, "0" off) decides
where a caller leaves the route at "auto" (:func:`fused_mode`); every
K2 route of the port but the single-scan one goes through
:func:`use_fused`.
"""

from __future__ import annotations

import os

import torch

from ..cloud import Cloud
from ..ops.icp import ICPConfig, ICPResult, icp_core
from ..ops.icp_fused import fused_eligible, fused_icp_register


def fused_mode(fused: str = "auto") -> str:
    """The K2 route a caller asks for, with the reference's switch
    ``PGSLAM_FUSED_BATCHED`` read where the caller left it at "auto":
    "1" forces "on", "0" forces "off", anything else keeps "auto". A
    caller's explicit "on" or "off" wins over the switch."""
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be 'auto', 'on' or 'off', not {fused!r}")
    if fused == "auto":
        return {"1": "on", "0": "off"}.get(
            os.environ.get("PGSLAM_FUSED_BATCHED", ""), "auto")
    return fused


def fused_ready(cfg: ICPConfig, references: Cloud) -> bool:
    """Whether K2 covers this registration: the config is eligible and a
    point-to-plane reference carries normals."""
    return fused_eligible(cfg) and (
        cfg.error != "point_to_plane" or "normals" in references.descriptors)


def use_fused(cfg: ICPConfig, references: Cloud, device: torch.device,
              fused: str = "auto") -> bool:
    """Whether a batch goes to K2: :func:`fused_ready`, and the route of
    :func:`fused_mode` is "on", or "auto" on the card. Eligibility is
    never bypassed."""
    mode = fused_mode(fused)
    return fused_ready(cfg, references) and (
        mode == "on" or (mode == "auto" and device.type == "cuda"))


def register_one(reading: Cloud, reference: Cloud, T0: torch.Tensor,
                 cfg: ICPConfig) -> ICPResult:
    """One registration through K2: the pair lifted to a batch of one,
    entry 0 of the result."""
    lift = lambda c: c.map(lambda a: a[None])
    res = fused_icp_register(lift(reading), lift(reference), T0[None], cfg)
    return ICPResult(**{name: None if v is None else v[0]
                        for name, v in vars(res).items()})


def stack_results(results) -> ICPResult:
    """Per-entry results (0-d fields) -> one batched result."""
    def stack(name):
        vals = [getattr(r, name) for r in results]
        return None if vals[0] is None else torch.stack(vals)
    return ICPResult(T=stack("T"), iterations=stack("iterations"),
                     converged=stack("converged"),
                     max_iter_reached=stack("max_iter_reached"),
                     overlap=stack("overlap"), residual=stack("residual"),
                     cov=stack("cov"), diverged=stack("diverged"))


def batched_register(readings: Cloud, references: Cloud,
                     T_inits: torch.Tensor, cfg: ICPConfig = ICPConfig(),
                     fused: str = "auto") -> ICPResult:
    """Register a batch: ``readings`` and ``references`` carry a leading
    agent axis ``[B, N, ...]``, ``T_inits`` is ``[B, 4, 4]``. Returns a
    batched :class:`ICPResult`.

    ``fused`` ("auto" | "on" | "off", :func:`fused_mode`): eligible
    configs go to K2 with "on", or with "auto" on the card; "on" with CPU
    tensors runs K2's plain version. Eligibility is never bypassed: K2
    implements only TrimmedDist / MaxDist and needs reference normals for
    point-to-plane, so an ineligible config runs ``icp_core``."""
    if use_fused(cfg, references, readings.points.device, fused):
        return fused_icp_register(readings, references, T_inits, cfg)
    return stack_results([
        icp_core(readings.map(lambda a: a[b]),
                 references.map(lambda a: a[b]), T_inits[b], cfg)
        for b in range(readings.points.shape[0])])
