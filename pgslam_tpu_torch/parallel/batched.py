"""Batched registration (the headline metric's path, BASELINE config 5's
scan matching): B independent registrations in one call.

Counterpart of :mod:`pgslam_tpu.parallel.batched`. Eligible configs run
as one K2 launch for the whole batch, one thread block per registration;
the rest run ``icp_core`` entry by entry, which is also the CPU's "auto"
route (the JAX package's CPU route is the vmapped ``icp_core``).
"""

from __future__ import annotations

import torch

from ..cloud import Cloud
from ..ops.icp import ICPConfig, ICPResult, icp_core
from ..ops.icp_fused import fused_eligible, fused_icp_register


def use_fused(cfg: ICPConfig, references: Cloud, device: torch.device,
              fused: str = "auto") -> bool:
    """Whether a batch goes to K2: the config is eligible, point-to-plane
    references carry normals, and ``fused`` is "on", or "auto" on the
    card."""
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be 'auto', 'on' or 'off', not {fused!r}")
    eligible = fused_eligible(cfg) and (
        cfg.error != "point_to_plane" or "normals" in references.descriptors)
    return eligible and (fused == "on"
                         or (fused == "auto" and device.type == "cuda"))


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

    ``fused`` ("auto" | "on" | "off"): eligible configs go to K2 with
    "on", or with "auto" on the card; "on" with CPU tensors runs K2's
    plain version. Eligibility is never bypassed: K2 implements only
    TrimmedDist / MaxDist and needs reference normals for
    point-to-plane, so an ineligible config runs ``icp_core``."""
    if use_fused(cfg, references, readings.points.device, fused):
        return fused_icp_register(readings, references, T_inits, cfg)
    return stack_results([
        icp_core(readings.map(lambda a: a[b]),
                 references.map(lambda a: a[b]), T_inits[b], cfg)
        for b in range(readings.points.shape[0])])
