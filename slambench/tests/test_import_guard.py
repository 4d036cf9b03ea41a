"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``pgslam_tpu``; ``pgslam_tpu_torch`` is not ``pgslam_tpu``."""

import json
import subprocess
import sys
import textwrap

from slambench import run as R
from slambench.tests.helpers import ROOT


def test_top_level_names_compare_whole(monkeypatch):
    fake = {"pgslam_tpu_torch.ops": None, "pgslam_tpu_torchx": None}
    monkeypatch.setattr(sys, "modules", {**fake})
    assert R.loaded_forbidden() == []
    monkeypatch.setattr(sys, "modules", {**fake, "pgslam_tpu.ops": None,
                                         "jax.numpy": None})
    assert R.loaded_forbidden() == ["jax", "pgslam_tpu"]


def test_a_run_loads_neither(tmp_path):
    """A shrunken run on the CPU in a fresh process, then its modules."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {ROOT!r})
        from slambench.tests.helpers import tiny_checkout, run_tiny
        bench = tiny_checkout({str(tmp_path)!r})
        res, _, _ = run_tiny({str(tmp_path)!r}, bench, "fleet16.shared",
                             seconds=2.0)
        from slambench import run as R
        print(json.dumps({{"bad": R.loaded_forbidden(),
                          "torch_port": "pgslam_tpu_torch" in sys.modules,
                          "correct": res["correct"]}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "torch_port": True, "correct": True}


def test_no_result_once_a_reader_loads_jax(tmp_path):
    """A metric reader that loads ``jax`` after the window: the run exits
    non-zero and prints no result."""
    code = textwrap.dedent(f"""
        import json, os, sys
        sys.path.insert(0, {ROOT!r})
        from slambench.tests.helpers import card_routes, tiny_checkout
        tmp = {str(tmp_path)!r}
        bench = tiny_checkout(tmp)
        with open(os.path.join(tmp, "slambench", "metrics",
                               "loads_jax.py"), "w") as fh:
            fh.write("import sys, types\\n"
                     "sys.modules['jax'] = types.ModuleType('jax')\\n"
                     "def read(run):\\n    return 1.0\\n")
        bench["end_to_end"].append({{"name": "loads_jax", "unit": "s",
                                    "better": "lower", "bound": 0.25,
                                    "source": "host_clock"}})
        with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
            json.dump(bench, fh)
        from slambench import run as R
        with card_routes():
            rc = R.main(["--workload", "fleet16.shared", "--seed", "5",
                         "--seconds", "1"], root=tmp, devices=["cpu"])
        print("rc", rc, file=sys.stderr)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "forbidden modules loaded: jax" in out.stderr
    assert out.stderr.rstrip().endswith("rc 3"), out.stderr[-2000:]
    assert out.stdout.strip() == ""
