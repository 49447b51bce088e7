"""The tier fuzz gate of the PyTorch port (tiers/fuzz.py: run_seed with
its linter, mesh, counts, class-audit and pair legs, run_cidr_seed with
its mesh leg, run_conformance) against the reference's, on the CPU, and
the two copies that come with it (generator/anp_cases.py and
kube/pathological.py) against the reference's originals.

The reference's gate runs its mesh leg on its 8 virtual CPU devices, the
port's on 8 logical shards on the CPU; the stats dicts they return must
be equal, key for key.  The fixtures cross through to_dict, so each
package compiles its own objects from identical input."""

import dataclasses

import pytest

from cyclonus_tpu.generator import anp_cases as ref_anp_cases
from cyclonus_tpu.kube import pathological as ref_pathological
from cyclonus_tpu.kube.netpol import NetworkPolicy as RefNetworkPolicy
from cyclonus_tpu.kube.yaml_io import policy_to_dict as ref_policy_to_dict
from cyclonus_tpu.tiers import fuzz as ref_fuzz
from cyclonus_tpu_torch.engine import TorchPolicyEngine, sharded
from cyclonus_tpu_torch.generator import anp_cases
from cyclonus_tpu_torch.generator.generator import TestCaseGenerator
from cyclonus_tpu_torch.kube import pathological
from cyclonus_tpu_torch.kube.netpol import NetworkPolicy
from cyclonus_tpu_torch.kube.yaml_io import policy_to_dict
from cyclonus_tpu_torch.tiers import fuzz

MESH = sharded.logical_mesh("cpu", 8)


def plain(v):
    """A fixture as plain data: a NetworkPolicy through its package's
    policy_to_dict, other objects through their to_dict, dataclasses
    field by field, containers element by element."""
    if isinstance(v, RefNetworkPolicy):
        return ref_policy_to_dict(v)
    if isinstance(v, NetworkPolicy):
        return policy_to_dict(v)
    if hasattr(v, "to_dict"):
        return v.to_dict()
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    return v


class TestGate:
    @pytest.mark.parametrize("seed", range(8))
    def test_run_seed_equals_reference(self, seed):
        """Both class modes, the mesh leg on, counts, class audit, 16 pair
        samples and the linter census: the port's stats equal the
        reference's for the same seed."""
        got = fuzz.run_seed(seed, device="cpu", mesh=MESH)
        assert got == ref_fuzz.run_seed(seed)
        assert got["mesh_cells"] == got["cells"] > 0

    @pytest.mark.parametrize("seed", range(4))
    def test_run_cidr_seed_equals_reference(self, seed):
        got = fuzz.run_cidr_seed(seed, check_mesh=True, device="cpu", mesh=MESH)
        assert got == ref_fuzz.run_cidr_seed(seed, check_mesh=True)
        assert got["mesh_cells"] == got["cells"] > 0

    def test_run_conformance_equals_reference(self):
        assert fuzz.run_conformance(device="cpu") == ref_fuzz.run_conformance() == 10

    def test_run_report_equals_reference(self):
        got = fuzz.run(2, 5, cidr_seeds=1, device="cpu", mesh=sharded.logical_mesh("cpu", 4))
        assert got.to_dict() == ref_fuzz.run(2, 5, cidr_seeds=1).to_dict()

    def test_mesh_leg_catches_a_wrong_cell(self, monkeypatch):
        """A mesh grid with one flipped cell fails the seed's gate."""
        real = TorchPolicyEngine.evaluate_grid_sharded

        def flipped(self, cases, mesh=None, schedule=None):
            grid = real(self, cases, mesh=mesh, schedule=schedule)
            grid.egress_dev[0, 0, 0] = ~grid.egress_dev[0, 0, 0]
            return grid

        monkeypatch.setattr(TorchPolicyEngine, "evaluate_grid_sharded", flipped)
        with pytest.raises(fuzz.FuzzMismatch, match="mesh"):
            fuzz.run_seed(0, device="cpu", mesh=MESH)
        with pytest.raises(fuzz.FuzzMismatch, match="dense/mesh"):
            fuzz.run_cidr_seed(0, device="cpu", mesh=MESH)
        assert fuzz.run_seed(0, device="cpu", check_mesh=False)["mesh_cells"] == 0


class TestCopies:
    def test_tier_cases_equal_reference(self):
        ref, port = ref_anp_cases.tier_cases(), anp_cases.tier_cases()
        assert len(port) == len(ref) == 10
        for r, p in zip(ref, port):
            assert p.description == r.description
            assert sorted(p.tags) == sorted(r.tags)
            assert plain(p.netpols) == plain(r.netpols)
            assert plain(p.tiers.anps) == plain(r.tiers.anps)
            assert plain(p.tiers.banp) == plain(r.tiers.banp)
            assert [dataclasses.astuple(c) for c in p.cases] == [
                dataclasses.astuple(c) for c in r.cases
            ]
            assert p.cluster() == r.cluster()
        assert plain(anp_cases.per_namespace_default_deny(["x", "y"])) == plain(
            ref_anp_cases.per_namespace_default_deny(["x", "y"])
        )
        generator = TestCaseGenerator(False, "1.2.3.4", ["x", "y", "z"])
        assert [c.description for c in generator.tier_test_cases()] == [
            c.description for c in ref
        ]

    def test_pathological_fixtures_equal_reference(self):
        names = [n for n in dir(ref_pathological) if n.isupper() and not n.startswith("_")]
        assert names == [n for n in dir(pathological) if n.isupper() and not n.startswith("_")]
        for name in names:
            assert plain(getattr(pathological, name)) == plain(getattr(ref_pathological, name)), name
        calls = [
            ("allow_all_egress_policy", ("x",)),
            ("allow_all_ingress_policy", ("y",)),
            ("allow_nothing_from", ("x", "SELECTOR_AB")),
            ("allow_from_to_ns_labels", ("z", "SELECTOR_CD", {"ns": "y", "a": "b"})),
            ("example_complicated_network_policy", ()),
        ]
        for fn, args in calls:
            def resolve(mod):
                return [getattr(mod, a) if isinstance(a, str) and a.isupper() else a for a in args]

            got = getattr(pathological, fn)(*resolve(pathological))
            want = getattr(ref_pathological, fn)(*resolve(ref_pathological))
            assert plain(got) == plain(want), fn
        assert len(pathological.ALL_PATHOLOGICAL_POLICIES) > 0
