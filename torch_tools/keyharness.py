"""Key-mutation harness of the port: the dynamic proof behind
tools/cachelint.py over cyclonus_tpu_torch (the twin of the reference
package's tests/keyharness.py).

The static pass proves every cache of the engine declares what it
derives from; this harness proves the keys actually DISCRIMINATE: for
every key component of a cache family it perturbs that one component,
asserts the cache misses, then reverts and asserts a hit.  A component
that can be mutated without a miss is an incomplete key — the engine
would serve operands (or a kernel library) made for a different value:
the stale-verdict failure mode, strictly worse than a crash.

The families (utils/cachekeys.py; this process arms the registry with
CYCLONUS_KEYHARNESS=1 before it imports the package):

  * ``autotune`` — the persisted slab-autotune winners
    (engine/autotune.py): every shape-bucket field, the device string
    the engine builds (``cuda:<name>:<count>``) and the dtype plan;
  * ``kernels.library`` — the persisted kernel libraries
    (engine/build.py): the source, each header, NVCC_FLAGS and the
    compiler stamp, on a temporary copy of csrc/ (nothing of the
    package is written), plus a SUBPROCESS restart leg: a fresh process
    on a warm build directory compiles nothing and counts the same;
  * ``engine.pre_cache`` / ``engine.slab_ops`` — the steady state's
    pinned operands (engine/api.py): each of (q_port, q_name, q_proto,
    n_pods) mutated on the packed plan (K1) and the dense plan (K4, and
    K6 with its gathered slab operands), every call's counts held to a
    fresh engine's.

The reference's ``sharded.programs``, ``ring.pipelines`` and per-
signature ``aot:grid`` / ``aot:pairs`` families hold no state in the
port (DECIDED): the census lists them with their reasons.

    python torch_tools/keyharness.py [--device cpu] [--full] [--scenarios ...]

Without --device the harness wants the card.  On the CPU every kernel
runs its plain version, and a stub nvcc (it answers --version and writes
a placeholder library) stands in for the toolkit in a temporary build
directory; on the card the restart leg runs only the warm child, so it
starts no second real nvcc.  The quick slice runs in tier-1
(tests/test_torch_cachekeys.py); --full adds the dense plan, the restart
leg and the registry census (chip_smoke.py's guards leg (e)).  The last
line of the output is one JSON object (torch_tools/_harness.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import random
import shutil
import stat
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import _harness

# the registry is armed at cachekeys IMPORT (strip contract): set the
# flag before any cyclonus_tpu_torch import (a child that sets it to 0
# keeps its setting)
_harness.arm(CYCLONUS_KEYHARNESS=os.environ.get("CYCLONUS_KEYHARNESS", "1"))

REPO = _harness.REPO

#: the families the port registers, in registration order
FAMILIES = ("autotune", "kernels.library", "engine.pre_cache", "engine.slab_ops")

#: the reference's families that hold no state in the port, and why
DECIDED = {
    "sharded.programs": "eager torch compiles no shard_map program per "
                        "(mesh, schedule, pack): the mesh runs plain torch "
                        "and K1/K4 per shard",
    "ring.pipelines": "no compiled ring pipeline per (mesh, block, pack): "
                      "the ring schedules are plain torch loops",
    "aot:grid": "no ahead-of-time executable: evaluate_grid runs eagerly "
                "(the AOT cache, engine/aot_cache.py, is a decided drop)",
    "aot:pairs": "no ahead-of-time executable: evaluate_pairs runs "
                 "eagerly on exactly its pairs, nothing padded or compiled",
}

#: the cluster of every scenario: bench.py's synthetic cluster, small
N_PODS, N_POLICIES, CLUSTER_SEED = 24, 6, 7
#: the census children's cluster, per device type: on the card big enough
#: for the steady K1 call to be a real launch
CENSUS_PODS = {"cpu": 24, "cuda": 4096}
#: the dense plan's slab tile (pods), so the small cluster spans tiles
SLAB_TILE = 8
#: paired rounds (min of 10 steady calls each) of the census's timing
ROUNDS = 10

STUB_NVCC = """#!{python}
import sys
if "--version" in sys.argv:
    print("Cuda compilation tools, release {release}, V{release}.0")
    sys.exit(0)
with open({log!r}, "a") as f:
    f.write("start\\n")
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("stub library")
"""


class HarnessFailure(AssertionError):
    """A key component failed its miss-on-mutate / hit-on-revert proof;
    the message names the cache and the component."""


def _check(cond: bool, cache: str, component: str, detail: str) -> None:
    if not cond:
        raise HarnessFailure(f"{cache}: key component {component!r} failed — {detail}")


@contextlib.contextmanager
def _env(**kv: Optional[str]):
    """Set/unset env vars, restoring exactly on exit (mutate/revert is
    the harness's whole contract — it must apply to its own state)."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def install_stub_nvcc(bindir: str, log: str, release: str = "12.8") -> str:
    """Write the stub nvcc into `bindir`; returns its path."""
    os.makedirs(bindir, exist_ok=True)
    path = os.path.join(bindir, "nvcc")
    with open(path, "w") as f:
        f.write(STUB_NVCC.format(python=sys.executable, log=log, release=release))
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def _stub_starts(log: str) -> int:
    if not os.path.exists(log):
        return 0
    with open(log) as f:
        return f.read().count("start")


class Ctx:
    """Shared scenario context: tmp dir, device, the small synthetic
    cluster, the stub toolkit on the CPU, and the kernel launches of the
    child processes."""

    def __init__(self, tmp: str, device):
        self.tmp = tmp
        self.device = device
        self.cuda = device.type == "cuda"
        self.child_launches: Dict[str, int] = {}
        self._cluster = None
        self.stub_log = os.path.join(tmp, "nvcc.log")
        if not self.cuda:
            # the CPU has no toolkit: the stub answers the compiler stamp
            # and "builds" into a build directory of the run's own
            bindir = os.path.join(tmp, "bin")
            install_stub_nvcc(bindir, self.stub_log)
            os.environ["PATH"] = bindir + os.pathsep + os.environ.get("PATH", "")
            os.environ["CYCLONUS_TORCH_BUILD_DIR"] = os.path.join(tmp, "kernels")

    def cluster(self):
        """(pods, namespaces, policies, compiled policy)."""
        if self._cluster is None:
            from cyclonus_tpu_torch.matcher import build_network_policies
            from cyclonus_tpu_torch.synthetic import build_synthetic

            pods, namespaces, policies = build_synthetic(
                N_PODS, N_POLICIES, random.Random(CLUSTER_SEED))
            self._cluster = (pods, namespaces, policies,
                             build_network_policies(True, policies))
        return self._cluster

    def engine(self, **options):
        from cyclonus_tpu_torch.engine import TorchPolicyEngine

        pods, namespaces, _policies, policy = self.cluster()
        options.setdefault("class_compress", "0")
        return TorchPolicyEngine(policy, pods, namespaces, device=self.device, **options)

    @staticmethod
    def cases():
        from cyclonus_tpu_torch.engine import PortCase

        return [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]

    def note_launches(self, launches: Dict[str, int]) -> None:
        for k, v in launches.items():
            self.child_launches[k] = self.child_launches.get(k, 0) + int(v)


# --- scenarios -------------------------------------------------------------


def scenario_autotune_key_fields(ctx: Ctx) -> Dict:
    """Persisted autotune winner: every shape-bucket field, the device
    string and the dtype plan each miss when mutated and hit on revert —
    through the real store/load path against a cache file of the run's
    own (no winners file of a user's home decides anything)."""
    import torch

    from cyclonus_tpu_torch.engine import autotune as at

    eng = ctx.engine(pack=False, slab="0")
    mesh = json.loads(eng._autotune_key(2))["mesh"]  # the string the engine builds
    want = (f"cuda:{torch.cuda.get_device_name(ctx.device)}:{torch.cuda.device_count()}"
            if ctx.cuda else "cpu:cpu:1")
    _check(mesh == want, "autotune", "mesh", f"engine built {mesh!r}, expected {want!r}")
    kind, rest = mesh.split(":", 1)
    name, count = rest.rsplit(":", 1)
    path = os.path.join(ctx.tmp, "autotune.json")
    shape = {"n": 256, "te": 16, "ti": 16, "q": 2, "tiered": False, "classes": False}
    with _env(CYCLONUS_AUTOTUNE_CACHE=path):
        key = at.make_key(shape, mesh, "int8")
        winner = {"kernel": "slab"}
        _check(at.store_winner(key, winner, {"default_s": 0.1, "slab_s": 0.05}),
               "autotune", "baseline", "store_winner failed")
        got = at.load_winner(key)
        _check(got == winner, "autotune", "baseline", f"store/load broke: {got}")
        muts = 0
        for field, mutated, m, plan in [
            ("shape.n", dict(shape, n=512), mesh, "int8"),
            ("shape.te", dict(shape, te=32), mesh, "int8"),
            ("shape.ti", dict(shape, ti=32), mesh, "int8"),
            ("shape.q", dict(shape, q=3), mesh, "int8"),
            ("shape.tiered", dict(shape, tiered=True), mesh, "int8"),
            ("shape.classes", dict(shape, classes=True), mesh, "int8"),
            ("mesh.count", shape, f"{kind}:{name}:{int(count) + 1}", "int8"),
            ("mesh.name", shape, f"{kind}:{name} (other):{count}", "int8"),
            ("dtype_plan", shape, mesh, "packed32"),
        ]:
            miss = at.load_winner(at.make_key(mutated, m, plan))
            _check(miss is None, "autotune", field, "mutation did not miss")
            muts += 1
        _check(at.load_winner(at.make_key(dict(shape), mesh, "int8")) == winner,
               "autotune", "revert", "revert did not hit")
    return {"mutations": muts, "mesh": mesh}


def _tree_digest(root: str) -> str:
    h = hashlib.sha256()
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            h.update(os.path.relpath(p, root).encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def scenario_kernel_library_key_fields(ctx: Ctx) -> Dict:
    """The kernel library's name: mutating the source, each .cuh header,
    NVCC_FLAGS or the compiler stamp (one at a time) names another
    library; reverting names the same one again.  The mutations are made
    on a temporary copy of csrc/: nothing of the package is written."""
    from cyclonus_tpu_torch.engine import build

    real = str(build._CSRC)
    before = _tree_digest(real)
    copy = os.path.join(ctx.tmp, "csrc-copy")
    shutil.copytree(real, copy)
    stamp = build.compiler_stamp()
    saved_csrc, saved_flags = build._CSRC, build.NVCC_FLAGS
    muts = 0
    try:
        for name in sorted(build.SOURCES):
            base = build.library_path(name)
            _check(build.library_path(name, compiler=stamp) == base, "kernels.library",
                   "compiler", "the default path does not read the compiler stamp")
            build._CSRC = type(saved_csrc)(copy)
            _check(build.library_path(name) == base, "kernels.library", "copy",
                   "an identical copy of csrc/ names another library")
            files = [build.SOURCES[name]] + sorted(
                f for f in os.listdir(copy) if f.endswith(".cuh"))
            for fn in files:
                p = os.path.join(copy, fn)
                with open(p, "rb") as f:
                    orig = f.read()
                component = "source" if fn == build.SOURCES[name] else f"headers:{fn}"
                with open(p, "ab") as f:
                    f.write(b"\n// keyharness mutation\n")
                _check(build.library_path(name) != base, "kernels.library", component,
                       "mutation did not miss")
                muts += 1
                with open(p, "wb") as f:
                    f.write(orig)
                _check(build.library_path(name) == base, "kernels.library",
                       f"{component}.revert", "revert did not hit")
            build.NVCC_FLAGS = saved_flags + ("-DCYCLONUS_KEYHARNESS_MUTATION",)
            _check(build.library_path(name) != base, "kernels.library", "nvcc_flags",
                   "mutation did not miss")
            muts += 1
            build.NVCC_FLAGS = saved_flags
            _check(build.library_path(name) == base, "kernels.library", "nvcc_flags.revert",
                   "revert did not hit")
            _check(build.library_path(name, compiler=stamp + " (mutated)") != base,
                   "kernels.library", "compiler", "mutation did not miss")
            muts += 1
            _check(build.library_path(name, compiler=stamp) == base, "kernels.library",
                   "compiler.revert", "revert did not hit")
            build._CSRC = saved_csrc
    finally:
        build._CSRC, build.NVCC_FLAGS = saved_csrc, saved_flags
    _check(_tree_digest(real) == before, "kernels.library", "package",
           "the harness wrote under cyclonus_tpu_torch/csrc")
    return {"mutations": muts, "compiler": stamp}


def scenario_invalidate_derived_contract(ctx: Ctx) -> Dict:
    """Runtime cross-check of the CC002 contract: every attribute
    engine/api.py declares value-derived (`# derived-from:` with a value
    token) is actually overwritten by invalidate_after_patch — the
    static declaration list drives the runtime assertion, so the two
    sides can never drift."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import ast

    import cachelint

    path = os.path.join(REPO, "cyclonus_tpu_torch", "engine", "api.py")
    with open(path) as f:
        src = f.read()
    model = cachelint.ModuleModel(path, ast.parse(src), src.splitlines())
    cls = model.classes["TorchPolicyEngine"]
    decls, invalidate, _reset = cachelint.derived_model(model, cls)
    _check(invalidate is not None, "invalidate", "-", "no invalidate_after_patch")
    value_attrs = sorted(
        attr for attr, (tokens, _ln) in decls.items()
        if any(t not in cachelint.DERIVED_EXEMPT_TOKENS for t in tokens)
    )
    _check(len(value_attrs) >= 10, "invalidate", "census",
           f"expected >=10 declared value-derived attrs, found {value_attrs}")
    eng = ctx.engine()
    sentinels = {}
    for attr in value_attrs:
        sentinel = object()
        with eng._slab_lock:  # _slab_ops_cache is guarded by it
            setattr(eng, attr, sentinel)
        sentinels[attr] = sentinel
    eng.invalidate_after_patch()
    stale = []
    for attr, sentinel in sentinels.items():
        with eng._slab_lock:
            if getattr(eng, attr, None) is sentinel:
                stale.append(attr)
    _check(not stale, "invalidate", ",".join(stale) or "-",
           "declared value-derived attr(s) survived invalidate_after_patch")
    return {"mutations": len(value_attrs), "value_attrs": len(value_attrs)}


def _drive_pre_cache(ctx: Ctx, label: str, *, pack: bool, slab: str) -> Dict:
    """One plan's pre_cache key proof on a live verdict service's engine:
    pin the base case set (fused, split, steady), then mutate each of
    q_port, q_name, q_proto in turn (not steady, a pre-cache miss, the
    pin kept) and revert (steady again); then a pod add through the
    service changes n_pods and must drop the pin, not serve it.  Every
    call's counts equal a fresh engine's.  With the slab kernel chosen,
    the gathered slab operands must miss on no mutated call and hit on
    every revert."""
    from cyclonus_tpu_torch.chaos.harness import _slab_tiles
    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
    from cyclonus_tpu_torch.serve import VerdictService
    from cyclonus_tpu_torch.telemetry import instruments as ti
    from cyclonus_tpu_torch.worker.model import Delta

    family = f"engine.pre_cache[{label}]"
    pods, namespaces, policies, _policy = ctx.cluster()
    base = ctx.cases()
    fresh_counts: Dict = {}
    env = dict(CYCLONUS_PACK="1" if pack else "0", CYCLONUS_PALLAS_SLAB=slab,
               CYCLONUS_PRE_CACHE="1", CYCLONUS_AUTOTUNE="0",
               CYCLONUS_AUTOTUNE_CACHE=os.path.join(ctx.tmp, f"autotune-{label}.json"))
    tiles = _slab_tiles(SLAB_TILE) if slab == "1" else contextlib.nullcontext()
    with _env(**env), tiles:
        svc = VerdictService(pods, namespaces, policies, class_compress="0", device=ctx.device)
        eng = svc.engine

        def fresh(cases, cluster):
            key = (tuple(cases), cluster)
            if key not in fresh_counts:
                src = svc if cluster == "patched" else None
                if src is None:
                    p, n, pol = pods, namespaces, _policy
                else:
                    p, n, pol = list(src.pods.values()), dict(src.namespaces), src._policy
                fresh_counts[key] = TorchPolicyEngine(
                    pol, p, n, device=ctx.device, class_compress="0", pack=pack, slab=slab,
                ).evaluate_grid_counts(cases)
            return fresh_counts[key]

        def call(cases, component, cluster="base"):
            """(mode, pre-cache misses, slab-operand hits) of one call,
            whose counts must equal a fresh engine's (a key that lost
            `component` serves another case set's operands)."""
            m0, s0 = ti.PRE_CACHE_MISSES.value(), ti.SLAB_OPS_CACHE_HITS.value()
            got = eng.evaluate_grid_counts(cases)
            seen = (eng.pre_cache_stats()["mode"], ti.PRE_CACHE_MISSES.value() - m0,
                    ti.SLAB_OPS_CACHE_HITS.value() - s0)
            want = fresh(cases, cluster)  # after the reads: its calls move them too
            _check(got == want, family, component,
                   f"counts {got} != a fresh engine's {want} at {cases}")
            return seen

        modes = [call(base, "baseline")[0] for _ in range(3)]
        _check(modes == ["fused", "split", "steady"], family, "baseline",
               f"the base set did not pin: {modes}")
        slab_chosen = eng._slab_choice is True
        _check(slab_chosen == (slab == "1"), family, "slab",
               f"slab choice {eng._slab_choice} under slab {slab!r}")
        if slab_chosen:
            mode, _m, slab_hits = call(base, "baseline")
            _check(mode == "steady" and slab_hits == 1, "engine.slab_ops", "baseline",
                   f"the slab operands were not reused: {mode}, {slab_hits} hits")
        arrays = [a.tobytes() for a in eng._port_case_arrays(base)]
        unnamed = "" if base[1].port_name in eng._port_names else next(iter(eng._port_names))
        mutations = [
            ("q_port", 0, [PortCase(8080, base[0].port_name, base[0].protocol), base[1]]),
            ("q_name", 1, [base[0], PortCase(base[1].port, unnamed, base[1].protocol)]),
            ("q_proto", 2, [PortCase(base[0].port, base[0].port_name, "UDP"), base[1]]),
        ]
        muts = 0
        for component, idx, mutated in mutations:
            got_arrays = [a.tobytes() for a in eng._port_case_arrays(mutated)]
            _check(got_arrays[idx] != arrays[idx] and all(
                got_arrays[i] == arrays[i] for i in range(3) if i != idx),
                family, component, "the mutation does not change exactly this component")
            mode, missed, slab_hits = call(mutated, component)
            _check(mode != "steady" and missed >= 1, family, component,
                   f"mutation did not miss (mode {mode}, {missed} misses)")
            _check(slab_hits == 0, "engine.slab_ops", component,
                   "a mutated case set read the pinned slab operands")
            _check(eng._pre_cache is not None, family, component,
                   "one miss evicted the pin")
            muts += 1
            mode, missed, slab_hits = call(base, f"{component}.revert")
            _check(mode == "steady" and missed == 0, family, f"{component}.revert",
                   f"revert did not hit (mode {mode}, {missed} misses)")
            if slab_chosen:
                _check(slab_hits == 1, "engine.slab_ops", f"{component}.revert",
                       "revert did not reuse the slab operands")
        # n_pods: a pod add through the service patches the engine in place
        report = svc.apply([Delta(
            kind="pod_add", namespace="ns0", name="keyharness-pod",
            labels={"app": "app1", "pod": "p99", "tier": "tier1"}, ip="10.99.0.1",
        )])
        _check(report.get("mode") == "incremental" and svc.engine is eng, family, "n_pods",
               f"the pod add rebuilt the engine: {report}")
        _check(eng._pre_cache is None, family, "n_pods", "the patch kept the pin")
        mode, missed, slab_hits = call(base, "n_pods", "patched")
        _check(mode != "steady" and missed >= 1 and slab_hits == 0, family, "n_pods",
               f"the pin was served after the pod add (mode {mode})")
        muts += 1
    return {"mutations": muts, "slab": slab_chosen,
            "stats": {k: v for k, v in eng.pre_cache_stats().items() if k != "autotune"}}


def scenario_pre_cache_key(ctx: Ctx) -> Dict:
    """The pinned operands' key on the packed plan (K1)."""
    return _drive_pre_cache(ctx, "packed", pack=True, slab="0")


def scenario_pre_cache_key_dense(ctx: Ctx) -> Dict:
    """The same on the dense plan: the default kernel (K4, slab "0") and
    the slab kernel (K6, slab "1") with its gathered slab operands."""
    k4 = _drive_pre_cache(ctx, "dense", pack=False, slab="0")
    k6 = _drive_pre_cache(ctx, "slab", pack=False, slab="1")
    return {"mutations": k4["mutations"] + k6["mutations"], "dense": k4, "slab": k6}


_CHILD = """
import json, os, random, sys, time
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tools!r})
import keyharness
sys.exit(keyharness.child_main({args!r}))
"""


def _child(ctx: Ctx, args: Dict, env: Optional[Dict[str, str]] = None) -> Dict:
    """Run child_main(args) in a fresh process; its last stdout line."""
    code = _CHILD.format(repo=REPO, tools=os.path.dirname(os.path.abspath(__file__)),
                         args=args)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
        cwd=REPO, env={**os.environ, **(env or {})},
    )
    if proc.returncode != 0:
        raise HarnessFailure(f"child {args} failed: {proc.stdout[-1500:]}{proc.stderr[-1500:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ctx.note_launches(out.get("launches", {}))
    return out


def child_main(args: Dict) -> int:
    """A child process: "restart" builds (0.0 a library when the build
    directory is warm) and counts on the small cluster; "census" drives
    every family on the device and times the steady K1 call.  Prints one
    JSON line."""
    import torch

    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine, build
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.synthetic import build_synthetic
    from cyclonus_tpu_torch.telemetry.metrics import REGISTRY
    from cyclonus_tpu_torch.utils import cachekeys

    device = torch.device(args["device"])
    if args.get("mutate_flags"):
        build.NVCC_FLAGS = build.NVCC_FLAGS + ("-DCYCLONUS_KEYHARNESS_MUTATION",)
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
    out: Dict = {"armed": cachekeys.ACTIVE}
    if args["mode"] == "restart":
        out["build"] = build.build()
        out["paths"] = {n: build.library_path(n).name for n in sorted(build.SOURCES)}
        pods, namespaces, policies = build_synthetic(N_PODS, N_POLICIES, random.Random(CLUSTER_SEED))
        eng = TorchPolicyEngine(build_network_policies(True, policies), pods, namespaces,
                                device=device, class_compress="0", pack=True)
        out["counts"] = eng.evaluate_grid_counts(cases)
    else:
        n_pods = int(args["pods"])
        pods, namespaces, policies = build_synthetic(n_pods, max(6, n_pods // 20),
                                                     random.Random(CLUSTER_SEED))
        policy = build_network_policies(True, policies)
        for name in sorted(build.SOURCES):
            build.library_path(name)
        packed = TorchPolicyEngine(policy, pods, namespaces, device=device,
                                   class_compress="0", pack=True)
        for _ in range(3):  # fused, split, steady: engine.pre_cache
            packed.evaluate_grid_counts(cases)
        def steady_min(n=10):
            times = []
            for _ in range(n):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                packed.evaluate_grid_counts(cases)  # the readback is the barrier
                times.append(time.perf_counter() - t0)
            return min(times)

        steady_min(20)  # warm-up
        # paired rounds in one process, on one card at its clocks: the
        # armed child flips the flag between rounds (the sites read
        # cachekeys.ACTIVE at each call); the unarmed one never arms
        armed = cachekeys.ACTIVE
        sides = {True: [], False: []}
        for r in range(ROUNDS):
            for flag in ((True, False) if r % 2 == 0 else (False, True)):
                cachekeys.ACTIVE = flag and armed
                sides[flag].append(steady_min())
        cachekeys.ACTIVE = armed
        out["steady_s"] = {"on": statistics.median(sides[True]),
                           "off": statistics.median(sides[False])}
        reps = 10000
        t0 = time.perf_counter()
        for _ in range(reps):  # the per-call registration the steady call makes
            cachekeys.register("engine.pre_cache", kind="device",
                               components=cachekeys.program("q_port", "q_name", "q_proto",
                                                            "n_pods"))
        out["register_us"] = (time.perf_counter() - t0) / reps * 1e6
        out["steady_mode"] = packed.pre_cache_stats()["mode"]
        from cyclonus_tpu_torch.chaos.harness import _slab_tiles

        pods, namespaces, policies = build_synthetic(N_PODS, N_POLICIES,
                                                     random.Random(CLUSTER_SEED))
        with _slab_tiles(SLAB_TILE):
            slab = TorchPolicyEngine(build_network_policies(True, policies), pods, namespaces,
                                     device=device, class_compress="0", pack=False, slab="1")
            for _ in range(3):  # fused, split, steady: engine.slab_ops
                slab.evaluate_grid_counts(cases)
        slab._autotune_key(len(cases))  # autotune.make_key, as the autotune builds it
        reg = cachekeys.registered()
        out.update({
            "names": sorted(reg),
            "kinds": {k: v.kind for k, v in reg.items()},
            "components": {k: list(v.components) for k, v in reg.items()},
            "count": cachekeys.registered_count(),
            "metrics": sorted(n for n in REGISTRY.snapshot()
                              if n.startswith("cyclonus_tpu_cachekey")),
            "pods": n_pods,
        })
    out["launches"] = _harness.launches()
    print(json.dumps(out, default=str))
    return 0


def scenario_kernel_library_restart(ctx: Ctx) -> Dict:
    """The restart leg (the twin of the reference's aot_restart_subprocess):
    a fresh process on a warm build directory runs no compiler (build()
    gives 0.0 for every library) and counts what this process counts.
    On the CPU, with the stub toolkit, a child with a mutated flag and a
    child under another compiler release each compile every library
    once; on the card only the warm child runs, so no second real nvcc
    is started."""
    from cyclonus_tpu_torch.engine import build

    eng = ctx.engine(pack=True)
    want = eng.evaluate_grid_counts(ctx.cases())
    build.build()  # warm the directory (the card's is warm already)
    dev = {"device": ctx.device.type, "mode": "restart"}
    starts = _stub_starts(ctx.stub_log)
    warm = _child(ctx, dev)
    _check(set(warm["build"].values()) == {0.0}, "kernels.library", "restart",
           f"a warm restart compiled: {warm['build']}")
    _check(warm["counts"] == want, "kernels.library", "restart.counts",
           f"{warm['counts']} != {want}")
    _check(warm["paths"] == {n: build.library_path(n).name for n in sorted(build.SOURCES)},
           "kernels.library", "restart.paths", "a fresh process named other libraries")
    out = {"mutations": 0, "warm_build_s": warm["build"]}
    if ctx.cuda:
        return out
    _check(_stub_starts(ctx.stub_log) == starts, "kernels.library", "restart",
           "the warm child started nvcc")
    other = os.path.join(ctx.tmp, "bin-other")
    install_stub_nvcc(other, ctx.stub_log, release="99.9")
    for component, args, env in [
        ("nvcc_flags", {**dev, "mutate_flags": True}, None),
        ("compiler", dev, {"PATH": other + os.pathsep + os.environ["PATH"]}),
    ]:
        before = _stub_starts(ctx.stub_log)
        got = _child(ctx, args, env)
        _check(_stub_starts(ctx.stub_log) - before == len(build.SOURCES) and all(
            s > 0 for s in got["build"].values()), "kernels.library", component,
            f"a mutated child did not compile every library once: {got['build']}")
        _check(not set(got["paths"].values()) & set(warm["paths"].values()),
               "kernels.library", component, "a mutated child named a warm library")
        _check(got["counts"] == want, "kernels.library", f"{component}.counts",
               f"{got['counts']} != {want}")
        out["mutations"] += 1
    return out


def scenario_registry_census(ctx: Ctx) -> Dict:
    """A child under CYCLONUS_KEYHARNESS=1 registers exactly the port's
    four families, each with components; a child with it unset
    registers nothing and creates no cachekey instrument (the strip
    contract).  The armed child times the steady K1 call in paired
    rounds, registry on and off in turns (median of 10 rounds, each the
    min of 10 calls); both time one registration call (mean of
    10,000)."""
    args = {"device": ctx.device.type, "mode": "census",
            "pods": CENSUS_PODS[ctx.device.type]}
    armed = _child(ctx, args, {"CYCLONUS_KEYHARNESS": "1"})
    unarmed = _child(ctx, args, {"CYCLONUS_KEYHARNESS": "0"})
    names = armed["names"]
    _check(armed["armed"] and names == sorted(FAMILIES), "registry", "census",
           f"registered {names}, expected {sorted(FAMILIES)}")
    _check(armed["count"] == len(names), "registry", "count", "census mismatch")
    for name, comps in armed["components"].items():
        _check(bool(comps), "registry", name, "registered with no components")
    _check(sorted(armed["metrics"]) == ["cyclonus_tpu_cachekey_registered",
                                        "cyclonus_tpu_cachekey_registrations_total"],
           "registry", "instruments", f"armed instruments {armed['metrics']}")
    _check(not unarmed["armed"] and unarmed["names"] == [] and unarmed["count"] == 0
           and unarmed["metrics"] == [], "registry", "strip",
           f"the unarmed child registered {unarmed['names']} / {unarmed['metrics']}")
    _check(armed["steady_mode"] == unarmed["steady_mode"] == "steady", "registry",
           "steady", "the timed calls were not steady-state calls")
    _check(not set(DECIDED) & set(names), "registry", "decided",
           "a decided family registered")
    return {
        "mutations": 0,
        "registered": armed["count"],
        "families": {n: {"kind": armed["kinds"][n], "components": armed["components"][n]}
                     for n in names},
        "decided": DECIDED,
        "pods": armed["pods"],
        "steady_s": {"armed": armed["steady_s"]["on"], "unarmed": armed["steady_s"]["off"],
                     "unarmed_process": unarmed["steady_s"]["off"]},
        "register_us": {"armed": armed["register_us"], "unarmed": unarmed["register_us"]},
    }


#: (name, fn, in_quick_slice)
SCENARIOS: List[Tuple[str, Callable[[Ctx], Dict], bool]] = [
    ("autotune_key_fields", scenario_autotune_key_fields, True),
    ("kernel_library_key_fields", scenario_kernel_library_key_fields, True),
    ("invalidate_derived_contract", scenario_invalidate_derived_contract, True),
    ("pre_cache_key", scenario_pre_cache_key, True),
    ("pre_cache_key_dense", scenario_pre_cache_key_dense, False),
    ("kernel_library_restart", scenario_kernel_library_restart, False),
    ("registry_census", scenario_registry_census, False),
]


def run(
    tmp: str,
    *,
    quick: bool = True,
    only: Optional[List[str]] = None,
    device="cpu",
    log: Optional[Callable[[str], None]] = None,
) -> Tuple[Dict[str, Dict], Ctx]:
    """Run the scenario set; raises HarnessFailure on the first
    violation.  Returns per-scenario stats (each with its seconds) and
    the context (the children's launches)."""
    import torch

    ctx = Ctx(tmp, torch.device(device))
    results: Dict[str, Dict] = {}
    for name, fn, in_quick in SCENARIOS:
        if only is not None:
            if name not in only:
                continue
        elif quick and not in_quick:
            continue
        t0 = time.perf_counter()
        stats = fn(ctx)
        stats["seconds"] = time.perf_counter() - t0
        results[name] = stats
        if log is not None:
            log(f"keyharness {name}: OK {stats}")
    return results, ctx


def main(argv: Optional[List[str]] = None) -> int:
    ap = _harness.parser(__doc__)
    ap.add_argument(
        "--scenarios", nargs="*", default=None,
        help=f"subset (choices: {[n for n, _f, _q in SCENARIOS]})",
    )
    args = ap.parse_args(argv)
    device = _harness.resolve_device(args.device)
    from cyclonus_tpu_torch.utils import cachekeys

    with tempfile.TemporaryDirectory(prefix="keyharness-") as tmp:
        results, ctx = run(tmp, quick=not args.full, only=args.scenarios, device=device,
                           log=print if args.verbose else None)
    print(
        f"keyharness: {len(results)} scenario(s) passed "
        f"({', '.join(sorted(results))}) on {device}",
        file=sys.stderr,
    )
    _harness.report("key", device, results, registered=sorted(cachekeys.registered()),
                    child_launches=ctx.child_launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
