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
as the reference's is.  The harnesses import nothing of the reference.

cachelint's CC002 reads new caches in __init__ only, and the engine sets
its caches in _init_state, so the rule is applied to _init_state here:
every cache-patterned attribute set there declares what it derives from,
and the lint's summary must count the port's declarations (it can no
longer pass by reading none)."""

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

HARNESSES = ("skewharness", "stateharness", "raceharness", "planharness", "keyharness")


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


_CACHELINT_SUMMARY = re.compile(
    r"cachelint: (\d+) finding\(s\), (\d+) cache-key / (\d+) derived-from / "
    r"(\d+) never-raises")


def test_cachelint_reads_the_ports_declarations():
    """At least ten derived-from declarations (the engine's value-derived
    caches) and nine never-raises (the reference's fifteen over the same
    path set less aot_cache.py's five and patch_byte_budget, which the
    port keeps inline in serve/incremental.py)."""
    proc = _run([os.path.join("tools", "cachelint.py"), *LEGS["cachelint"]])
    m = _CACHELINT_SUMMARY.search(proc.stdout + proc.stderr)
    assert m, proc.stdout + proc.stderr
    findings, _keys, derived, never = (int(g) for g in m.groups())
    assert findings == 0 and derived >= 10 and never >= 9, m.group(0)


def _cachelint():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import cachelint

    return cachelint


def _init_state_caches(path):
    """(cache-patterned attributes _init_state sets, those of them with no
    `# derived-from:` declaration, the class's declarations): CC002's
    new-cache rule, applied to the method the engine sets its caches in."""
    cachelint = _cachelint()
    with open(path) as f:
        src = f.read()
    model = cachelint.ModuleModel(path, ast.parse(src), src.splitlines())
    cls = model.classes["TorchPolicyEngine"]
    decls, _invalidate, _reset = cachelint.derived_model(model, cls)
    init = next(s for s in cls.body
                if isinstance(s, ast.FunctionDef) and s.name == "_init_state")
    caches = []
    for node in ast.walk(init):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                        and t.value.id == "self" and cachelint._CACHE_ATTR_RE.search(t.attr)):
                    caches.append(t.attr)
    return caches, [a for a in caches if a not in decls], decls


API = os.path.join(REPO, P, "engine", "api.py")
#: the value-derived caches invalidate_after_patch resets
VALUE_CACHES = ("_pre_cache", "_slab_ops_cache", "_pre_cache_misses", "_pre_cache_declined",
                "_last_counts_key", "_slab_choice", "_slab_plan_state", "_selpod_prebucket",
                "_pod_perm", "_pod_perm_host")


def test_init_state_caches_are_declared():
    cachelint = _cachelint()
    caches, undeclared, decls = _init_state_caches(API)
    assert len(caches) >= 6 and not undeclared, undeclared
    for attr in VALUE_CACHES:
        tokens = decls[attr][0]
        assert set(tokens) - cachelint.DERIVED_EXEMPT_TOKENS, (attr, tokens)
    assert decls["_device_tensors"][0][0] == "patched"


def _copy_with(tmp_path, edit):
    with open(API) as f:
        src = f.read()
    out = tmp_path / "api.py"
    out.write_text(edit(src))
    return str(out)


def test_undeclared_init_state_cache_is_flagged(tmp_path):
    """Failing first: a cache added to _init_state without a declaration
    is found (CC002 itself reads __init__ only)."""
    anchor = "        self._last_counts_key = None  # derived-from: buffer\n"
    path = _copy_with(tmp_path, lambda s: s.replace(
        anchor, anchor + "        self._grid_cache = None\n"))
    _caches, undeclared, _decls = _init_state_caches(path)
    assert undeclared == ["_grid_cache"]


@pytest.mark.parametrize("attr", VALUE_CACHES)
def test_cc002_flags_an_invalidate_that_misses_a_cache(attr, tmp_path):
    """Failing first: with one reset taken out of invalidate_after_patch,
    cachelint's CC002 names the declared cache it no longer resets."""
    cachelint = _cachelint()
    with open(API) as f:
        tree = ast.parse(f.read())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "TorchPolicyEngine")
    inv = next(n for n in cls.body if isinstance(n, ast.FunctionDef)
               and n.name == "invalidate_after_patch")
    line = next(n.lineno for n in ast.walk(inv) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Attribute) and t.attr == attr for t in n.targets))

    def drop(src):
        lines = src.splitlines(keepends=True)
        indent = lines[line - 1][: len(lines[line - 1]) - len(lines[line - 1].lstrip())]
        lines[line - 1] = indent + "pass\n"
        return "".join(lines)

    findings, _stats = cachelint.analyze_file(_copy_with(tmp_path, drop))
    assert [f.code for f in findings] == ["CC002"], findings
    assert f"TorchPolicyEngine.{attr} is declared value-derived" in findings[0].message
    assert not cachelint.analyze_file(API)[0]
