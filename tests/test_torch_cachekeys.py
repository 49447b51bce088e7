"""The port's cache-key registry (cyclonus_tpu_torch/utils/cachekeys.py)
and its key-mutation harness (torch_tools/keyharness.py) on the CPU,
against the reference's (cyclonus_tpu/utils/cachekeys.py,
tests/keyharness.py).

Unarmed, the registry is inert: register() returns None, nothing is
registered and no cyclonus_tpu_cachekey_* instrument exists (shown
structurally; the reference's wall-clock bound on the off path is not
ported, the card's guards leg times the steady call armed and unarmed).
Armed (CYCLONUS_KEYHARNESS=1, read at import, so only in children),
exactly the port's four families register.  The autotune key is the
reference's, byte for byte; the kernel library's name moves with each
of its four components; the harness fails when a key or the invalidate
contract loses a component."""

import json
import os
import subprocess
import sys

import pytest
import torch

from cyclonus_tpu.engine import autotune as ref_autotune
from cyclonus_tpu_torch.engine import autotune, build
from cyclonus_tpu_torch.utils import cachekeys

from test_torch_engine import REPO

HARNESS = os.path.join("torch_tools", "keyharness.py")
QUICK = {"autotune_key_fields", "kernel_library_key_fields", "invalidate_derived_contract",
         "pre_cache_key"}
FAMILIES = ["autotune", "engine.pre_cache", "engine.slab_ops", "kernels.library"]

SHAPE = {"n": 256, "te": 16, "ti": 16, "q": 2, "tiered": False, "classes": False}
#: the reference harness's eight autotune mutations (tests/keyharness.py
#: scenario_autotune_key_fields): (field, shape, mesh, dtype plan)
AUTOTUNE_MUTATIONS = [
    ("shape.n", dict(SHAPE, n=512), "cpu:host:8", "packed32"),
    ("shape.te", dict(SHAPE, te=32), "cpu:host:8", "packed32"),
    ("shape.ti", dict(SHAPE, ti=32), "cpu:host:8", "packed32"),
    ("shape.q", dict(SHAPE, q=3), "cpu:host:8", "packed32"),
    ("shape.tiered", dict(SHAPE, tiered=True), "cpu:host:8", "packed32"),
    ("shape.classes", dict(SHAPE, classes=True), "cpu:host:8", "packed32"),
    ("mesh", SHAPE, "tpu:v5e:4", "packed32"),
    ("dtype_plan", SHAPE, "cpu:host:8", "int8"),
]


def _run(argv, env=None, timeout=600):
    return subprocess.run(
        [sys.executable, *argv], cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})),
    )


def _last_json(proc):
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


class TestInertRegistry:
    def test_inactive_registry_is_inert(self):
        """The suite never sets CYCLONUS_KEYHARNESS: registration is a
        no-op, the registry stays empty, and the cachekey instruments
        never enter the port's metric registry (the strip proof)."""
        from cyclonus_tpu_torch.telemetry.metrics import REGISTRY

        assert cachekeys.ACTIVE is False
        assert cachekeys.register("t", kind="program", components=("a",),
                                  fingerprint="f") is None
        assert cachekeys.registered_count() == 0
        assert cachekeys.registered() == {}
        names = set(REGISTRY.snapshot())
        assert not any(n.startswith("cyclonus_tpu_cachekey") for n in names), names

    def test_program_descriptor_passthrough(self):
        assert cachekeys.program("a", "b") == ("a", "b")
        assert cachekeys.program() == ()

    def test_unarmed_sites_register_nothing(self, tmp_path, monkeypatch):
        """Every registration site of the port runs unarmed and leaves the
        registry empty."""
        from cyclonus_tpu_torch.engine import PortCase

        import test_torch_engine as te

        monkeypatch.setenv("CYCLONUS_AUTOTUNE_CACHE", "0")
        autotune.make_key(SHAPE, "cpu:cpu:1", "int8")
        for name in build.SOURCES:
            build.library_path(name, compiler="release 0.0")
        policies, pods, namespaces = te.fuzz_policies(0)
        eng = te.TorchPolicyEngine(te.port_policy(policies), pods, namespaces, device="cpu",
                                   class_compress="0")
        for _ in range(3):
            eng.evaluate_grid_counts([PortCase(80, "", "TCP")])
        assert eng.pre_cache_stats()["mode"] == "steady"
        assert cachekeys.registered() == {} and cachekeys.registered_count() == 0

    def test_api_is_the_references(self):
        from cyclonus_tpu.utils import cachekeys as ref

        for name in ("ACTIVE", "RegisteredCache", "register", "program", "registered",
                     "registered_count", "clear"):
            assert hasattr(cachekeys, name) and hasattr(ref, name), name
        assert ref.RegisteredCache.__dataclass_fields__.keys() == \
            cachekeys.RegisteredCache.__dataclass_fields__.keys()


class TestAutotuneKey:
    @pytest.mark.parametrize("shape", [SHAPE, {"n": 1}, dict(SHAPE, tiered=True, q=1)])
    @pytest.mark.parametrize("mesh,plan", [("cpu:host:8", "packed32"),
                                           ("cuda:NVIDIA H100 80GB HBM3:1", "int8")])
    def test_key_is_byte_equal_to_the_reference(self, shape, mesh, plan):
        assert autotune.make_key(shape, mesh, plan) == ref_autotune.make_key(shape, mesh, plan)

    @pytest.mark.parametrize("field,shape,mesh,plan", AUTOTUNE_MUTATIONS,
                             ids=[m[0] for m in AUTOTUNE_MUTATIONS])
    def test_reference_mutation_misses_in_both_packages(self, field, shape, mesh, plan,
                                                        tmp_path, monkeypatch):
        """Each of the reference harness's eight mutations misses a stored
        winner in both packages, and the unmutated key hits."""
        for pkg, winner in ((autotune, {"kernel": "slab"}),
                            (ref_autotune, {"kernel": "packed", "bs": 256, "bd": 512})):
            monkeypatch.setenv("CYCLONUS_AUTOTUNE_CACHE", str(tmp_path / f"{pkg.__name__}.json"))
            key = pkg.make_key(SHAPE, "cpu:host:8", "packed32")
            assert pkg.store_winner(key, winner, {"default_s": 0.1})
            assert pkg.load_winner(pkg.make_key(shape, mesh, plan)) is None, (pkg, field)
            assert pkg.load_winner(pkg.make_key(dict(SHAPE), "cpu:host:8", "packed32")) == winner


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that build reads instead (nothing of the package
    is written)."""
    import shutil

    copy = tmp_path / "csrc"
    shutil.copytree(build._CSRC, copy)
    monkeypatch.setattr(build, "_CSRC", copy)
    return copy


class TestLibraryKey:
    STAMP = "Cuda compilation tools, release 12.8, V12.8.93"

    @pytest.mark.parametrize("component", ["source", "headers", "nvcc_flags", "compiler"])
    def test_component_names_another_library(self, component, csrc_copy, monkeypatch):
        name = "dense_counts"
        base = build.library_path(name, compiler=self.STAMP)
        stamp = self.STAMP
        if component == "source":
            path = csrc_copy / build.SOURCES[name]
            path.write_bytes(path.read_bytes() + b"\n")
        elif component == "headers":
            header = sorted(csrc_copy.glob("*.cuh"))[0]
            header.write_bytes(header.read_bytes() + b"\n")
        elif component == "nvcc_flags":
            monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
        else:
            stamp = "Cuda compilation tools, release 12.9, V12.9.86"
        got = build.library_path(name, compiler=stamp)
        assert got != base and got.parent == base.parent
        assert got.name.startswith(f"lib{name}-") and got.suffix == ".so"

    def test_unchanged_inputs_name_the_same_library(self, csrc_copy):
        for name in build.SOURCES:
            assert build.library_path(name, compiler=self.STAMP) == build.library_path(
                name, compiler=self.STAMP)


_REF_CENSUS = """
import json
from cyclonus_tpu.engine import autotune
from cyclonus_tpu.utils import cachekeys
autotune.make_key({"n": 1}, "cpu", "packed32")
reg = cachekeys.registered()
print(json.dumps({"names": sorted(reg), "count": cachekeys.registered_count(),
                  "components": {k: list(v.components) for k, v in reg.items()},
                  "kinds": {k: v.kind for k, v in reg.items()}}))
"""


class TestArmedCensus:
    def test_port_registers_its_four_families_and_autotune_equals_the_reference(self):
        """Armed children: the port's census (the harness's
        registry_census scenario, which also holds the unarmed child to
        an empty registry) registers exactly the four families; the
        reference's child registers `autotune` with the same components
        and kind."""
        port = _last_json(_run([HARNESS, "--device", "cpu", "--scenarios", "registry_census"]))
        census = port["results"]["registry_census"]
        assert sorted(census["families"]) == FAMILIES and census["registered"] == 4
        assert set(census["decided"]) == {"sharded.programs", "ring.pipelines", "aot:grid",
                                          "aot:pairs"}
        ref = _last_json(_run(["-c", _REF_CENSUS], env={"CYCLONUS_KEYHARNESS": "1"}))
        assert ref["names"] == ["autotune"] and ref["count"] == 1
        assert census["families"]["autotune"] == {"kind": ref["kinds"]["autotune"],
                                                  "components": ref["components"]["autotune"]}
        assert census["families"]["kernels.library"]["components"] == [
            "source", "headers", "nvcc_flags", "compiler"]
        for fam in ("engine.pre_cache", "engine.slab_ops"):
            assert census["families"][fam] == {
                "kind": "device", "components": ["q_port", "q_name", "q_proto", "n_pods"]}


class TestHarness:
    def test_quick_slice(self):
        out = _last_json(_run([HARNESS, "--device", "cpu"]))
        assert out["harness"] == "key" and out["ok"] and out["device"] == "cpu"
        res = out["results"]
        assert set(res) == QUICK
        assert res["invalidate_derived_contract"]["value_attrs"] >= 10
        assert res["autotune_key_fields"]["mutations"] == 9
        assert res["kernel_library_key_fields"]["mutations"] == 8
        assert res["pre_cache_key"]["mutations"] == 4
        assert out["registered"] == ["autotune", "engine.pre_cache", "kernels.library"]

    def test_without_a_card_the_default_device_exits_2(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is available")
        proc = _run([HARNESS, "--scenarios", "autotune_key_fields"])
        assert proc.returncode == 2 and "no CUDA device" in proc.stderr

    @pytest.mark.slow
    def test_full(self):
        out = _last_json(_run([HARNESS, "--device", "cpu", "--full"], timeout=1800))
        res = out["results"]
        assert len(res) == 7
        assert res["kernel_library_restart"]["mutations"] == 2
        assert res["pre_cache_key_dense"]["slab"]["slab"] is True
        assert res["registry_census"]["registered"] == 4


_SABOTAGE = """
import sys, tempfile
sys.path.insert(0, "torch_tools")
import keyharness
from cyclonus_tpu_torch.engine import api

kind, idx = sys.argv[1], int(sys.argv[2])
E = api.TorchPolicyEngine
if kind == "key":
    orig = E._steady_state_args

    def broken(self, cases):
        key, ok, slab = orig(self, cases)
        key = tuple(b"" if i == idx else k for i, k in enumerate(key))
        return key, ok, slab

    E._steady_state_args = broken
    scenario = "pre_cache_key"
else:
    orig = E.invalidate_after_patch
    attr = sys.argv[3]

    def broken(self):
        keep = getattr(self, attr)
        orig(self)
        with self._slab_lock:
            setattr(self, attr, keep)

    E.invalidate_after_patch = broken
    scenario = "invalidate_derived_contract"
with tempfile.TemporaryDirectory() as tmp:
    try:
        keyharness.run(tmp, only=[scenario], device="cpu")
    except keyharness.HarnessFailure as e:
        print("caught:", e)
        sys.exit(0)
print("the harness passed a broken engine")
sys.exit(1)
"""


class TestHarnessHasTeeth:
    @pytest.mark.parametrize("idx,component", [(0, "q_port"), (1, "q_name"), (2, "q_proto")])
    def test_a_key_without_a_component_fails(self, idx, component):
        proc = _run(["-c", _SABOTAGE, "key", str(idx)])
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert component in proc.stdout

    @pytest.mark.parametrize("attr", ["_pre_cache", "_pod_perm_host", "_slab_ops_cache"])
    def test_an_invalidate_that_keeps_a_cache_fails(self, attr):
        proc = _run(["-c", _SABOTAGE, "invalidate", "0", attr])
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert attr in proc.stdout
