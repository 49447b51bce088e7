"""The reference's static lint legs over the port, and the port's own
dynamic harnesses, on the CPU.

tools/{locklint,shapelint,cachelint,planlint,statelint,wirelint}.py run
unchanged as subprocesses over the port's paths — the Makefile's path
sets with cyclonus_tpu read as cyclonus_tpu_torch — and each gives 0
findings; planlint reads the port's own registry (engine/planspec.py)
and writes its manifest only into a temporary directory.  Every
suppression in the port carries its reason on its line.  The state and
race harnesses (torch_tools/) run their quick slices as subprocesses on
the CPU, the race harness under CYCLONUS_GUARD_CHECK=1 with the
reference's seeded quick schedule counts; its 16-thread sweep is slow,
as the reference's is.  The harnesses import nothing of the reference."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from test_torch_engine import REPO

P = "cyclonus_tpu_torch"

#: leg -> the paths the Makefile's leg scans, read for the port
LEGS = {
    "locklint": [P],
    "shapelint": [f"{P}/engine", f"{P}/analysis", f"{P}/worker/model.py", f"{P}/perfobs",
                  f"{P}/serve", f"{P}/tiers", f"{P}/chaos", f"{P}/linter", f"{P}/recipes",
                  f"{P}/slo", f"{P}/audit"],
    "cachelint": [f"{P}/engine", f"{P}/serve", f"{P}/perfobs", f"{P}/chaos", f"{P}/audit"],
    "planlint": [f"{P}/engine", f"{P}/serve", f"{P}/tiers", f"{P}/slo", f"{P}/audit"],
    "statelint": [f"{P}/serve", f"{P}/audit"],
    "wirelint": [f"{P}/worker", f"{P}/serve"],
}

HARNESSES = ("skewharness", "stateharness", "raceharness", "planharness")


def _run(argv, env=None, timeout=600):
    return subprocess.run(
        [sys.executable, *argv], cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})),
    )


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_is_clean_over_the_port(leg, tmp_path):
    argv = [os.path.join("tools", f"{leg}.py")]
    if leg == "planlint":
        argv += ["--manifest", str(tmp_path / "plan_manifest.json")]
    proc = _run(argv + LEGS[leg])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(rf"^{leg}: 0 finding\(s\)", proc.stdout + proc.stderr, re.M), (
        proc.stdout + proc.stderr
    )
    if leg == "planlint":
        manifest = json.loads((tmp_path / "plan_manifest.json").read_text())
        assert all(p["gate"].startswith("tests/test_torch_") for p in manifest["paths"])


def test_planlint_reads_the_ports_registry():
    """The registry planlint lints against is the port's own (its
    23 paths), not the reference's it used to fall back to."""
    proc = _run([os.path.join("tools", "planlint.py"), *LEGS["planlint"]])
    assert "23 path / 12 interaction declaration(s)" in proc.stdout + proc.stderr


def _suppressions():
    pat = re.compile(r"#\s*(\w+lint): ignore(\[[A-Z0-9, ]+\])?(.*)$")
    for root, _dirs, files in os.walk(os.path.join(REPO, P)):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                with open(path) as f:
                    for n, line in enumerate(f, 1):
                        m = pat.search(line)
                        if m:
                            yield os.path.relpath(path, REPO), n, m


def test_every_suppression_carries_its_reason():
    """A `# <leg>: ignore[CODE]` names its code and gives its reason on
    its own line, after the bracket."""
    found = list(_suppressions())
    assert found
    for path, n, m in found:
        assert m.group(2), f"{path}:{n}: suppression names no code"
        assert len(m.group(3).strip()) >= 8, f"{path}:{n}: suppression gives no reason"


@pytest.mark.parametrize("name", HARNESSES)
def test_harness_imports_nothing_of_the_reference(name):
    """torch_tools/ harnesses import the port only (the cross-package
    legs live in the tests), and no jax."""
    with open(os.path.join(REPO, "torch_tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    bad = {m for m in mods if m.split(".")[0] in ("cyclonus_tpu", "jax", "bench")}
    assert not bad, bad
    assert any(m.startswith("cyclonus_tpu_torch") for m in mods)


def test_stateharness_quick_slice_runs():
    proc = _run([os.path.join("torch_tools", "stateharness.py"), "--device", "cpu"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["harness"] == "state" and out["ok"]
    assert out["results"]["coverage_census"] == {"fields": 5, "kinds": 10}


def test_raceharness_fifty_seeded_schedules_with_guard_check():
    """The reference's quick gate on the port: 50 seeded schedules x 6
    scenarios at 8 threads, with the guards asserting the declared lock
    is held on every access the schedules reach."""
    proc = _run(
        [os.path.join("torch_tools", "raceharness.py"), "--device", "cpu",
         "--schedules", "50", "--threads", "8", "--seed", "1234"],
        env={"CYCLONUS_GUARD_CHECK": "1"},
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["harness"] == "race" and out["results"]["schedules"] == 50
    assert "engine_cache" in out["results"]["scenarios"]


@pytest.mark.slow
def test_raceharness_extended_sweep():
    """200 schedules at up to 16 threads (--full)."""
    proc = _run(
        [os.path.join("torch_tools", "raceharness.py"), "--device", "cpu", "--full"],
        env={"CYCLONUS_GUARD_CHECK": "1"}, timeout=1800,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
