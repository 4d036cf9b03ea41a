"""The YAML entry points: the port's loaders against pgslam_tpu.config on
every YAML of examples/ and of the JAX package's config tests, the
tagged config dicts of ``convert`` over every config the repo builds,
and the facade's and components' YAML setters (the cases of
tests/test_config_io.py)."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import pgslam_tpu.config as JC
from pgslam_tpu.slam import PoseGraphSlam as JSlam
from pgslam_tpu_torch import config as TC
from pgslam_tpu_torch import replays
from pgslam_tpu_torch.convert import config_from_dict, config_to_dict
from pgslam_tpu_torch.slam import PoseGraphSlam, SlamConfig
from test_config_io import ICP_YAML
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

# The YAML strings of tests/test_config_io.py, each with the loader it goes
# through there.
YAML_DOCS = [
    ("icp", ICP_YAML),
    ("icp", "\nmatcher:\n  GridMatcher: {cellSize: 0.5, bucketCap: 16}\n"),
    ("slam", """
localizer:
  localMapSize: 4
  overlapThreshold: 0.75
  inputFilters:
    - MaxDistDataPointsFilter: {maxDist: 20.0}
  icp:
    errorMinimizer: PointToPointErrorMinimizer
loopCloser:
  topoDistThreshold: 5.0
sensorCloudCapacity: 4096
"""),
    ("icp", "errorMinimizer: PointToPointErrorMinimizer\n"
            "outlierFilters:\n"
            "  - TrimmedDistOutlierFilter: {ratio: 0.8}\n"),
    ("filters", "- MaxDistDataPointsFilter: {maxDist: 25.0}\n"),
    ("icp", "errorMinimizer: PointToPlaneErrorMinimizer\n"),
    ("icp", "errorMinimizer: PointToPointErrorMinimizer\n"
            "outlierFilters:\n"
            "  - TrimmedDistOutlierFilter: {ratio: 0.9}\n"),
    ("filters", "- MaxDistDataPointsFilter: {maxDist: 30.0}\n"),
    ("slam", "optimizer: {priorSigma: 1.0e-5}\n"),
]

# Chains of tests/test_config_io.py and tests/test_filters_extra.py given
# as parsed lists, and one entry per filter and outlier filter of the
# tables.
FILTER_LISTS = [
    ["IdentityDataPointsFilter",
     {"MaxDistDataPointsFilter": {"maxDist": 30.0}},
     {"VoxelGridDataPointsFilter": {"vSizeX": 0.1}}],
    [{"ShadowDataPointsFilter": {"eps": 0.2}},
     {"MaxDensityDataPointsFilter": {"radius": 1.0, "maxCount": 2}},
     "FixStepSamplingDataPointsFilter"],
    list(JC._FILTERS),
]
OUTLIER_LISTS = [
    [{"VarTrimmedDistOutlierFilter": {"minRatio": 0.3, "lambda": 1.5}}],
    list(JC._OUTLIERS),
]


def _load(kind, path):
    return {"icp": (JC.load_icp_config, TC.load_icp_config),
            "slam": (JC.load_slam_config, TC.load_slam_config),
            "filters": (JC.load_input_filters, TC.load_input_filters)}[kind]


def _as_dicts(value):
    if isinstance(value, tuple):
        return [(type(x).__name__, dataclasses.asdict(x)) for x in value]
    return config_to_dict(value)


@pytest.mark.parametrize("case", range(len(YAML_DOCS)))
def test_yaml_docs_parse_as_in_jax(case, tmp_path):
    kind, text = YAML_DOCS[case]
    path = tmp_path / "doc.yaml"
    path.write_text(text)
    jload, tload = _load(kind, path)
    assert _as_dicts(tload(str(path))) == _as_dicts(jload(str(path)))


@pytest.mark.parametrize("name", ["slam_config.yaml",
                                  "icp_point_to_plane.yaml"])
def test_examples_load_as_in_jax(name):
    path = os.path.join(EXAMPLES, name)
    kind = "slam" if name.startswith("slam") else "icp"
    jload, tload = _load(kind, path)
    ours, theirs = tload(path), jload(path)
    assert config_to_dict(ours) == config_to_dict(theirs)
    cls = SlamConfig if kind == "slam" else type(ours)
    assert config_from_dict(cls, config_to_dict(theirs)) == ours


@pytest.mark.parametrize("case", range(len(FILTER_LISTS)))
def test_filter_chains_parse_as_in_jax(case):
    spec = FILTER_LISTS[case]
    assert _as_dicts(TC.parse_filter_chain(spec)) == \
        _as_dicts(JC.parse_filter_chain(spec))


@pytest.mark.parametrize("case", range(len(OUTLIER_LISTS)))
def test_outlier_chains_parse_as_in_jax(case):
    spec = OUTLIER_LISTS[case]
    assert _as_dicts(TC.parse_outlier_chain(spec)) == \
        _as_dicts(JC.parse_outlier_chain(spec))


@pytest.mark.parametrize("parse,spec,word", [
    ("parse_filter_chain", [{"BogusFilter": {}}], "BogusFilter"),
    ("parse_outlier_chain", [{"BogusOutlier": {}}], "BogusOutlier"),
    ("parse_filter_chain", [3], "bad chain entry"),
    ("parse_icp_config", "matcher: {OctreeMatcher: {}}\n", "OctreeMatcher"),
    ("parse_icp_config", "errorMinimizer: Bogus\n", "Bogus"),
    ("parse_icp_config", "transformationCheckers: [BoundChecker]\n",
     "BoundChecker"),
])
def test_unknown_names_raise_as_in_jax(parse, spec, word):
    with pytest.raises(ValueError, match=word) as ours:
        getattr(TC, parse)(spec)
    with pytest.raises(ValueError) as theirs:
        getattr(JC, parse)(spec)
    assert str(ours.value) == str(theirs.value)


def _repo_configs():
    """(name, JAX config, port config) for every config the repo builds."""
    import bench
    import golden_replay
    from test_slam_e2e import small_config
    from pgslam_tpu_torch import fleet_problems as FP
    sys.path.insert(0, EXAMPLES)
    from velodyne_slam import velodyne_config
    return [
        ("golden", golden_replay.golden_config(), replays.loop_config()),
        ("velodyne_64k", velodyne_config(), replays.velodyne_config()),
        ("velodyne_64k_lag2", velodyne_config(sync_lag=2),
         replays.velodyne_config(sync_lag=2)),
        ("fleet", small_config(), FP.fleet_config()),
        ("batched_icp", bench.batched_icp_config(), FP.batched_icp_config()),
        ("slam_yaml", JSlam.from_yaml(
            os.path.join(EXAMPLES, "slam_config.yaml")).config,
         replays.yaml_config()),
        ("p2plane_yaml", JC.load_icp_config(
            os.path.join(EXAMPLES, "icp_point_to_plane.yaml")),
         TC.load_icp_config(os.path.join(EXAMPLES,
                                         "icp_point_to_plane.yaml"))),
    ]


@pytest.mark.parametrize("case", range(7))
def test_config_from_dict_round_trips_every_repo_config(case):
    name, theirs, ours = _repo_configs()[case]
    d = config_to_dict(theirs)
    rebuilt = config_from_dict(type(ours), d)
    assert rebuilt == ours, name
    assert config_to_dict(rebuilt) == d
    assert dataclasses.asdict(rebuilt) == dataclasses.asdict(theirs)


def test_config_from_dict_tells_max_dist_filters_from_outliers():
    """The filter MaxDist and the outlier MaxDist share a name and a field
    set; the field they sit in decides."""
    from pgslam_tpu_torch.localizer import LocalizerConfig
    from pgslam_tpu_torch.ops import filters as F
    from pgslam_tpu_torch.ops import outlier as O
    from pgslam_tpu_torch.ops.icp import ICPConfig
    cfg = LocalizerConfig(input_filters=(F.MaxDist(30.0), F.MinDist(1.0)),
                          icp=ICPConfig(outlier=(O.MaxDist(0.5),)))
    assert config_from_dict(LocalizerConfig, config_to_dict(cfg)) == cfg
    with pytest.raises(ValueError, match="MedianDist"):
        config_from_dict(LocalizerConfig, {
            "input_filters": [("MedianDist", {"factor": 3.0})]})


# -- the facade and the components -----------------------------------------

def test_from_yaml_and_config_paths_match_jax(tmp_path):
    slam_yaml = os.path.join(EXAMPLES, "slam_config.yaml")
    p2plane = os.path.join(EXAMPLES, "icp_point_to_plane.yaml")
    ours = PoseGraphSlam.from_yaml(slam_yaml, device="cpu")
    assert ours.device == torch.device("cpu")
    assert config_to_dict(ours.config) == config_to_dict(
        JSlam.from_yaml(slam_yaml).config)
    filters = replays.input_filters_yaml(str(tmp_path))
    ours = PoseGraphSlam.from_config_paths(p2plane, filters, p2plane,
                                           device="cpu")
    theirs = JSlam.from_config_paths(p2plane, filters, p2plane)
    assert config_to_dict(ours.config) == config_to_dict(theirs.config)
    assert ours.config == replays.p2plane_config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PoseGraphSlam.from_yaml(slam_yaml)


def _yaml(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_set_icp_config_one_and_three_paths(tmp_path):
    filt = _yaml(tmp_path, "f.yaml", "- MaxDistDataPointsFilter: "
                                     "{maxDist: 30.0}\n")
    loc = _yaml(tmp_path, "l.yaml", "errorMinimizer: "
                                    "PointToPointErrorMinimizer\n")
    loop = _yaml(tmp_path, "c.yaml", "errorMinimizer: "
                                     "PointToPlaneErrorMinimizer\n")
    ours, theirs = PoseGraphSlam(device="cpu"), JSlam()
    for slam in (ours, theirs):
        slam.SetIcpConfig(filt, loc, loop)
        with pytest.raises(TypeError):
            slam.set_icp_config(filt, loc)
    for part in ("localizer", "loop_closer"):
        assert config_to_dict(getattr(ours, part).config) == config_to_dict(
            getattr(theirs, part).config)
    ours.set_icp_config(loop)
    assert ours.localizer.config.icp.error == "point_to_plane"
    assert ours.loop_closer.config.icp.error == "point_to_plane"
    ours.set_input_filters_config(filt)
    assert _as_dicts(ours.localizer.config.input_filters) == _as_dicts(
        theirs.localizer.config.input_filters)


def test_set_icp_config_after_the_first_scan(tmp_path):
    """The new engine gets the live local map, and the next scan runs."""
    from pgslam_tpu_torch.localizer import LocalizerConfig
    p = _yaml(tmp_path, "icp.yaml", "errorMinimizer: "
              "PointToPointErrorMinimizer\noutlierFilters:\n"
              "  - TrimmedDistOutlierFilter: {ratio: 0.9}\n")
    slam = PoseGraphSlam(SlamConfig(
        localizer=LocalizerConfig(keyframe_cloud_capacity=256),
        sensor_cloud_capacity=256), device="cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(200, 3)).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    slam.add_data(0, "world", eye, eye, pts)
    old = slam.localizer.icp_engine
    slam.set_icp_config(p)
    assert slam.localizer.icp_engine is not old
    assert slam.localizer.icp_engine.reference is not None
    T = eye.copy()
    T[0, 3] = 0.05
    slam.add_data(1, "world", T, eye, pts + np.float32([0.05, 0, 0]))
    assert np.isfinite(slam.T_world_robot).all()


def test_component_setters_match_jax(tmp_path):
    from pgslam_tpu.graph.pose_graph import MapManager as JMM
    from pgslam_tpu.localizer import Localizer as JLoc
    from pgslam_tpu.loopcloser import LoopCloser as JLC
    from pgslam_tpu.optimizer import Optimizer as JOpt
    from pgslam_tpu_torch.graph.pose_graph import MapManager
    from pgslam_tpu_torch.localizer import Localizer
    from pgslam_tpu_torch.loopcloser import LoopCloser
    from pgslam_tpu_torch.optimizer import Optimizer
    icp = _yaml(tmp_path, "icp.yaml", "errorMinimizer: "
                                      "PointToPlaneErrorMinimizer\n")
    filt = _yaml(tmp_path, "f.yaml", "- MinDistDataPointsFilter: "
                                     "{minDist: 1.5}\n")
    jmm, mm = JMM(), MapManager()
    jloc, loc = JLoc(jmm), Localizer(mm, device="cpu")
    jlc = JLC(jmm, JOpt(jmm))
    lc = LoopCloser(mm, Optimizer(mm, device="cpu"), device="cpu")
    for l in (jloc, loc):
        l.set_local_map_max_size(5)
        l.set_overlap_threshold(0.7)
        l.set_minimal_overlap_threshold(0.4)
        l.set_icp_config(icp)
        l.set_input_filters_config(filt)
    for c in (jlc, lc):
        c.set_topological_distance_threshold(7.0)
        c.set_geometrical_distance_threshold(2.5)
        c.set_overlap_threshold(0.65)
        c.set_residual_error_threshold(100.0)
        c.set_candidate_local_map_max_size(4)
        c.set_icp_config(icp)
    assert config_to_dict(loc.config) == config_to_dict(jloc.config)
    assert config_to_dict(lc.config) == config_to_dict(jlc.config)
    assert loc.local_map.capacity() == jloc.local_map.capacity() == 5
    assert lc.candidate_local_map.capacity() == 4
    dead = _yaml(tmp_path, "dead.yaml", "transformationCheckers:\n"
                 "  - CounterTransformationChecker: {maxIterationCount: 2}\n")
    with pytest.raises(ValueError):
        lc.set_icp_config(dead)
    with pytest.raises(ValueError):
        jlc.set_icp_config(dead)


def test_import_without_yaml():
    """``import pgslam_tpu_torch`` (and its config module) imports neither
    PyYAML nor triton; the loaders do."""
    import subprocess
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import pgslam_tpu_torch, pgslam_tpu_torch.config\n"
            "import pgslam_tpu_torch.slam, pgslam_tpu_torch.replays\n"
            "print(sorted(m for m in ('yaml', 'triton', 'jax')\n"
            "             if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
