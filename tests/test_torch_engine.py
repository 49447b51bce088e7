"""TorchPolicyEngine (cyclonus_tpu_torch) against TpuPolicyEngine
(cyclonus_tpu) and the scalar oracle, on the CPU: the same policies,
pods and port cases through both packages — host tensors leaf by leaf,
truth-table grids, and full-grid counts on the dense route and the
class-compressed route.  Every comparison is exact.

Policies reach the port through its own YAML-dict parser
(reference policy_to_dict -> port parse_policy_dict), so each package
compiles its own matcher objects from identical input."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.kube.netpol import (
    IPBlock,
    LabelSelector,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
)
from cyclonus_tpu.kube.yaml_io import policy_to_dict
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu_torch import oracle, synthetic
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.engine import encoding as port_encoding
from cyclonus_tpu_torch.engine import host
from cyclonus_tpu_torch.kube import examples
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.kube.yaml_io import policy_to_dict as port_policy_to_dict
from cyclonus_tpu_torch.matcher import build_network_policies

from test_engine_parity import default_cluster, mkpol, random_policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASE_TUPLES = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP"), (79, "", "SCTP")]
REF_CASES = [RefPortCase(*c) for c in CASE_TUPLES]
PORT_CASES = [PortCase(*c) for c in CASE_TUPLES]


def fuzz_policies(seed, n_extra_pods=0):
    """(policies, pods, namespaces): the reference's fuzz cluster
    (tests/test_engine_tiled.fuzz_problem) with the raw policy list."""
    rng = random.Random(seed)
    nss = ["x", "y", "z"]
    keys = ["pod", "app", "ns", "team"]
    values = ["a", "b", "c", "x", "y", "z", "blue", "red"]
    pods, namespaces = default_cluster()
    for ns in nss:
        namespaces[ns] = {"ns": ns, "team": rng.choice(["blue", "red"])}
    for i in range(n_extra_pods):
        ns = rng.choice(nss)
        pods.append((ns, f"extra-{i}", {"app": rng.choice(values)}, f"192.168.2.{i + 1}"))
    policies = [random_policy(rng, i, nss, keys, values) for i in range(rng.randrange(2, 6))]
    return policies, pods, namespaces


def port_policy(policies):
    return build_network_policies(
        True, [parse_policy_dict(policy_to_dict(p)) for p in policies]
    )


def engines(policies, pods, namespaces, **kw):
    ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces, **kw)
    port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu", **kw)
    return ref, port


def assert_tree_equal(ref, port, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(port), f"{path}: {sorted(ref)} != {sorted(port)}"
        for k in ref:
            assert_tree_equal(ref[k], port[k], f"{path}/{k}")
        return
    assert isinstance(port, np.ndarray), path
    assert ref.dtype == port.dtype, f"{path}: {ref.dtype} != {port.dtype}"
    assert np.array_equal(ref, port), f"{path} differs"


def grids(g):
    return {k: np.asarray(getattr(g, k)) for k in ("ingress", "egress", "combined")}


def grid_sums(g):
    return {k: int(v.sum()) for k, v in grids(g).items()}


# (seed, extra pods, class_compress): "0" is the dense route, "1" forces
# the class-compressed route
ROUTES = [(0, 4, "0"), (1, 7, "1"), (2, 0, "1"), (5, 13, "0"), (6, 13, "1")]


class TestEngineParity:
    @pytest.mark.parametrize("seed,extra,mode", ROUTES)
    def test_tensors_leaf_equal(self, seed, extra, mode):
        ref, port = engines(*fuzz_policies(seed, extra), class_compress=mode)
        assert_tree_equal(ref._tensors, port._tensors)
        if mode == "1":
            rs, ps = ref._class_state, port._class_state
            assert rs is not None and ps is not None
            assert_tree_equal(rs["ctensors"], ps["ctensors"])
            for k in ("class_of_pod", "class_rep", "class_size"):
                assert np.array_equal(getattr(rs["classes"], k), getattr(ps["classes"], k))
            assert rs["aux_bytes"] == ps["aux_bytes"]
        else:
            assert ref._class_state is None and port._class_state is None

    @pytest.mark.parametrize("seed,extra,mode", ROUTES)
    def test_grid_and_counts(self, seed, extra, mode):
        policies, pods, namespaces = fuzz_policies(seed, extra)
        ref, port = engines(policies, pods, namespaces, class_compress=mode)
        want = grids(ref.evaluate_grid(REF_CASES))
        got = port.evaluate_grid(PORT_CASES)
        assert_tree_equal(want, grids(got))
        if seed < 3:
            assert_tree_equal(
                oracle.oracle_grid(port_policy(policies), pods, namespaces, PORT_CASES),
                grids(got),
            )
        counts = port.evaluate_grid_counts(PORT_CASES)
        assert counts == ref.evaluate_grid_counts(REF_CASES, backend="pallas")
        assert {k: counts[k] for k in ("ingress", "egress", "combined")} == grid_sums(got)
        assert counts["cells"] == len(PORT_CASES) * len(pods) ** 2

    @pytest.mark.parametrize("mode", ["0", "1"])
    def test_from_tensors(self, mode):
        policies, pods, namespaces = fuzz_policies(3, 9)
        ref, port = engines(policies, pods, namespaces, class_compress=mode)
        st = ref._class_state
        vocab = ref.encoding.cluster.vocab
        carried = TorchPolicyEngine.from_tensors(
            ref._tensors,
            pod_keys=ref.pod_keys,
            port_names=vocab.port_name,
            protocols=vocab.proto,
            classes=st["classes"] if st else None,
            ctensors=st["ctensors"] if st else None,
            device="cpu",
        )
        assert_tree_equal(grids(port.evaluate_grid(PORT_CASES)), grids(carried.evaluate_grid(PORT_CASES)))
        assert carried.evaluate_grid_counts(PORT_CASES) == port.evaluate_grid_counts(PORT_CASES)

    def test_gather_and_stats(self):
        ref, port = engines(*fuzz_policies(4, 6))
        g_ref, g_port = ref.evaluate_grid(REF_CASES), port.evaluate_grid(PORT_CASES)
        triples = [(q, s, d) for q in range(3) for s in range(0, 15, 4) for d in range(0, 15, 3)]
        assert np.array_equal(g_ref.gather(triples), g_port.gather(triples))
        assert g_ref.allow_stats() == g_port.allow_stats()
        assert g_port.job_verdict(1, 2, 3) == g_ref.job_verdict(1, 2, 3)

    def test_empty_cases(self):
        _ref, port = engines(*fuzz_policies(0))
        assert port.evaluate_grid([]).ingress.shape == (0, 9, 9)
        assert port.evaluate_grid_counts([]) == {
            "ingress": 0, "egress": 0, "combined": 0, "cells": 0,
        }

    @pytest.mark.parametrize("mode", ["0", "1"])
    def test_ipv6_host_rows(self, mode):
        """IPv6 / mixed-family IPBlocks are evaluated on the host and
        patched in; the dense counts route permutes their columns with
        the pods."""
        pods, namespaces = default_cluster()
        pods = [
            (ns, name, labels, f"fd00::{i + 1}" if i % 3 == 0 else ip)
            for i, (ns, name, labels, ip) in enumerate(pods)
        ]
        policies = [
            mkpol(
                "v6", "y", LabelSelector.make(), ["Ingress"],
                ingress=[
                    NetworkPolicyIngressRule(
                        from_=[
                            NetworkPolicyPeer(ip_block=IPBlock.make("fd00::/120", ["fd00::4/128"])),
                            NetworkPolicyPeer(ip_block=IPBlock.make("192.168.1.0/29")),
                        ]
                    )
                ],
            )
        ]
        ref, port = engines(policies, pods, namespaces, class_compress=mode)
        assert "host_ip_match" in port._tensors["ingress"]
        got = port.evaluate_grid(PORT_CASES)
        assert_tree_equal(grids(ref.evaluate_grid(REF_CASES)), grids(got))
        assert_tree_equal(
            oracle.oracle_grid(port_policy(policies), pods, namespaces, PORT_CASES), grids(got)
        )
        counts = port.evaluate_grid_counts(PORT_CASES)
        assert counts == ref.evaluate_grid_counts(REF_CASES, backend="pallas")

    def test_unparseable_ip_raises(self):
        pods, namespaces = default_cluster()
        pods[4] = (pods[4][0], pods[4][1], pods[4][2], "not-an-ip")
        policies = [
            mkpol(
                "ipb", "x", LabelSelector.make(), ["Ingress"],
                ingress=[
                    NetworkPolicyIngressRule(
                        from_=[NetworkPolicyPeer(ip_block=IPBlock.make("192.168.1.0/24"))]
                    )
                ],
            )
        ]
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu")
        with pytest.raises(ValueError, match="unable to parse"):
            port.evaluate_grid(PORT_CASES)
        with pytest.raises(ValueError, match="unable to parse"):
            port.evaluate_grid_counts(PORT_CASES)


class TestExamples:
    @pytest.mark.parametrize("idx", range(len(examples.all_examples())))
    def test_example_vs_oracle(self, idx):
        pods, namespaces = examples.example_cluster()
        policy = build_network_policies(True, [examples.all_examples()[idx]])
        cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(5000, "", "TCP"), PortCase(53, "", "UDP")]
        engine = TorchPolicyEngine(policy, pods, namespaces, device="cpu")
        assert_tree_equal(
            oracle.oracle_grid(policy, pods, namespaces, cases),
            grids(engine.evaluate_grid(cases)),
        )


class TestSynthetic:
    def test_matches_bench(self):
        import bench

        want = bench.build_synthetic(500, 80, random.Random(20260729))
        got = synthetic.build_synthetic(500, 80, random.Random(20260729))
        assert got[0] == want[0] and got[1] == want[1]
        assert [policy_to_dict(p) for p in want[2]] == [
            port_policy_to_dict(p) for p in got[2]
        ]

    def test_auto_classes_match_reference(self, monkeypatch):
        """At a bench-shaped cluster above the (lowered) auto floor both
        engines take the same class decision and the same counts on both
        routes."""
        import bench

        monkeypatch.setenv("CYCLONUS_CLASS_MIN_PODS", "256")
        pods, namespaces, policies = bench.build_synthetic(600, 60, random.Random(7))
        cases = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP")]
        ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces)
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu")
        assert ref.pod_classes() is not None and port.pod_classes() is not None
        assert np.array_equal(ref.pod_classes().class_of_pod, port.pod_classes().class_of_pod)
        want = ref.evaluate_grid_counts([RefPortCase(*c) for c in cases], backend="pallas")
        assert port.evaluate_grid_counts([PortCase(*c) for c in cases]) == want
        dense = TorchPolicyEngine(
            port_policy(policies), pods, namespaces, device="cpu", class_compress="0"
        )
        assert dense.evaluate_grid_counts([PortCase(*c) for c in cases]) == want


class TestPortBoundaries:
    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        policies, pods, namespaces = fuzz_policies(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchPolicyEngine(port_policy(policies), pods, namespaces)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchPolicyEngine.from_tensors(
                {}, pod_keys=[], port_names={}, protocols={}
            )

    def test_classes_dense_bits_match_reference(self):
        from cyclonus_tpu.engine.encoding import compute_pod_classes as ref_classes

        ref, port = engines(*fuzz_policies(8, 20), class_compress="0")
        t = port._tensors
        selpod = host._selector_pod_matches_host(t)
        a = port_encoding.compute_pod_classes(t, selpod)
        b = ref_classes(ref._tensors, selpod, cidr=None)
        for k in ("class_of_pod", "class_rep", "class_size"):
            assert np.array_equal(getattr(a, k), getattr(b, k))

    def test_imports_neither_jax_nor_reference(self):
        """Every module of the port loads without jax and without the
        reference package."""
        code = (
            "import importlib, pkgutil, sys\n"
            "import cyclonus_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'cyclonus_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'cyclonus_tpu' or m.startswith('cyclonus_tpu.')]\n"
            "assert not bad, bad\n"
            "new = ['cyclonus_tpu_torch.engine.cidrspace', 'cyclonus_tpu_torch.analysis.audit',\n"
            "       'cyclonus_tpu_torch.analysis.classes', 'cyclonus_tpu_torch.analysis.cluster',\n"
            "       'cyclonus_tpu_torch.analysis.diff', 'cyclonus_tpu_torch.analysis.oracle',\n"
            "       'cyclonus_tpu_torch.linter.checks', 'cyclonus_tpu_torch.utils.text',\n"
            "       'cyclonus_tpu_torch.cli.analyze', 'cyclonus_tpu_torch.engine.sharded',\n"
            "       'cyclonus_tpu_torch.generator.anp_cases', 'cyclonus_tpu_torch.kube.pathological',\n"
            "       'cyclonus_tpu_torch.cli.fuzz_cmd', 'cyclonus_tpu_torch.utils.retry',\n"
            "       'cyclonus_tpu_torch.utils.bounded', 'cyclonus_tpu_torch.worker.worker',\n"
            "       'cyclonus_tpu_torch.worker.client', 'cyclonus_tpu_torch.worker.__main__',\n"
            "       'cyclonus_tpu_torch.kube.kubectl', 'cyclonus_tpu_torch.kube.loopback',\n"
            "       'cyclonus_tpu_torch.kube.loopback_server', 'cyclonus_tpu_torch.cli._cluster',\n"
            "       'cyclonus_tpu_torch.utils.envflags', 'cyclonus_tpu_torch.chaos',\n"
            "       'cyclonus_tpu_torch.chaos.harness', 'cyclonus_tpu_torch.slo',\n"
            "       'cyclonus_tpu_torch.slo.objectives', 'cyclonus_tpu_torch.slo.accounting',\n"
            "       'cyclonus_tpu_torch.slo.engine', 'cyclonus_tpu_torch.audit',\n"
            "       'cyclonus_tpu_torch.audit.digest', 'cyclonus_tpu_torch.audit.sampler',\n"
            "       'cyclonus_tpu_torch.recipes', 'cyclonus_tpu_torch.recipes.recipes',\n"
            "       'cyclonus_tpu_torch.cli.chaos_cmd', 'cyclonus_tpu_torch.cli.recipes_cmd',\n"
            "       'cyclonus_tpu_torch.native', 'cyclonus_tpu_torch.native.bridge',\n"
            "       'cyclonus_tpu_torch.native.build', 'cyclonus_tpu_torch.native.evaluate',\n"
            "       'cyclonus_tpu_torch.perfobs', 'cyclonus_tpu_torch.perfobs.schema',\n"
            "       'cyclonus_tpu_torch.perfobs.ledger', 'cyclonus_tpu_torch.perfobs.sentinel',\n"
            "       'cyclonus_tpu_torch.perfobs.report', 'cyclonus_tpu_torch.cli.perf_cmd',\n"
            "       'cyclonus_tpu_torch.utils.cachekeys']\n"
            "assert all(m in sys.modules for m in new), [m for m in new if m not in sys.modules]\n"
            "print(len([m for m in sys.modules if m.startswith('cyclonus_tpu_torch')]))\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
        )
        assert out.returncode == 0, out.stderr
        assert int(out.stdout.split()[-1]) >= 139
