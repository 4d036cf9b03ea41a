"""Batched registration (the headline metric's path, BASELINE config 5's
scan matching): B independent registrations in one call.

Counterpart of :mod:`pgslam_tpu.parallel.batched`. Eligible configs run
as one K2 launch for the whole batch, one thread block per registration;
the rest run ``icp_core`` entry by entry, which is also the CPU's "auto"
route (the JAX package's CPU route is the vmapped ``icp_core``). The
reference's switch ``PGSLAM_FUSED_BATCHED`` ("1" on, "0" off) decides
where a caller leaves the route at "auto" (:func:`fused_mode`); every
K2 route of the port but the single-scan one goes through
:func:`use_fused`. :func:`shard_batch` splits a batch over a device
mesh's dp axis.
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


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of clouds, tuples, lists and
    tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Cloud):
        return tree.map(fn)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return tree


def shard_batch(mesh, axis: str = "dp"):
    """Split a batch's leading agent axis over a mesh axis ("dp" or "tp"
    of a :class:`.multichip.Mesh`). Torch has no global sharded tensor, so
    ``put(tree)`` returns a list of the axis' size of chunks, each the
    tree with every tensor of one or more dimensions cut to its rows of
    the leading axis (0-d tensors whole): chunk i on ``mesh.devices[i,
    0]`` for dp, ``mesh.devices[0, i]`` for tp. Run each chunk on its
    device, e.g. :func:`batched_register`, and concatenate."""
    if axis not in ("dp", "tp"):
        raise ValueError(f"axis must be 'dp' or 'tp', not {axis!r}")
    n = mesh.shape[axis]

    def put(tree):
        chunks = []
        for i in range(n):
            dev = mesh.devices[i, 0] if axis == "dp" else mesh.devices[0, i]

            def cut(x):
                if x.ndim == 0:
                    return x.to(dev)
                if x.shape[0] % n:
                    raise ValueError(f"a leading axis of {x.shape[0]} does "
                                     f"not split over {axis}={n}")
                m = x.shape[0] // n
                return x[i * m:(i + 1) * m].to(dev)
            chunks.append(_tree_map(cut, tree))
        return chunks

    return put


def concat_results(parts, device) -> ICPResult:
    """Batched results of consecutive chunks as one result on
    ``device``."""
    return ICPResult(**{
        name: None if getattr(parts[0], name) is None else torch.cat(
            [getattr(p, name).to(device) for p in parts])
        for name in vars(parts[0])})
