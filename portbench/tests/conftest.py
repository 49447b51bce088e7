"""Shared fixtures of the benchmark's CPU tests: a checkout-like root with
the benchmark at a tiny size, for driving whole runs on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: the tiny size of the CPU runs: a few namespaces, every mechanism present
TINY = {"n_pods": 600, "n_policies": 80, "n_namespaces": None}


def make_root(tmp: Path, sizes=TINY) -> Path:
    """A copy of BENCHMARK.json and portbench/ under tmp, each configuration
    cut to `sizes` in a file of its own."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in bench["configs"]:
        body = json.loads((REPO / cfg["file"]).read_text())
        body.update(sizes)
        cfg["file"] = f"portbench/configs/{cfg['name']}.tiny.json"
        (tmp / cfg["file"]).write_text(json.dumps(body))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
