"""A configuration file's ``slam`` and ``icp`` sections as the program's
``SlamConfig``, built through its public configuration classes.

ICP sections name their filters and outlier filters as ``[class name,
{field: value}]`` pairs of ``pgslam_tpu_torch.ops.filters`` and
``pgslam_tpu_torch.ops.outlier``; an ICP section with ``"base"`` is that
section with the other keys replaced. The localizer's and the loop
closer's ``"icp"`` name a section.
"""

from __future__ import annotations

import copy


def icp_section(cfg: dict, name: str) -> dict:
    """The ICP section ``name`` with its ``base`` resolved (a dict)."""
    sec = copy.deepcopy(cfg["icp"][name])
    base = sec.pop("base", None)
    if base is None:
        return sec
    out = icp_section(cfg, base)
    out.update(sec)
    return out


def build(cfg: dict):
    from pgslam_tpu_torch import LocalizerConfig, LoopCloserConfig, SlamConfig
    from pgslam_tpu_torch.ops import filters as F
    from pgslam_tpu_torch.ops import outlier as O
    from pgslam_tpu_torch.ops.icp import ICPConfig
    from pgslam_tpu_torch.optimizer import OptimizerConfig

    def icp(name):
        sec = icp_section(cfg, name)
        chains = {}
        for key, mod in (("reading_filters", F), ("reference_filters", F),
                         ("outlier", O)):
            chains[key] = tuple(getattr(mod, n)(**p)
                                for n, p in sec.pop(key, []))
        return ICPConfig(**sec, **chains)

    slam = copy.deepcopy(cfg["slam"])
    loc = slam["localizer"]
    loc["icp"] = icp(loc["icp"])
    lc = slam["loop_closer"]
    lc["icp"] = icp(lc["icp"])
    return SlamConfig(localizer=LocalizerConfig(**loc),
                      loop_closer=LoopCloserConfig(**lc),
                      optimizer=OptimizerConfig(**slam.get("optimizer", {})),
                      sensor_cloud_capacity=slam["sensor_cloud_capacity"])
