"""The port's verdict service (cyclonus_tpu_torch/serve) against the
reference's (cyclonus_tpu/serve), on the CPU: the same cluster, policies,
tiers and seeded delta stream through both services, step by step.  At
every step the apply's mode and epoch, the query verdicts, state(), the
patched engine's host tensors (leaf by leaf) and the port's device views
must agree, and a delta that patches must move no whole tensor set to
the device (api.TRANSFERS).  Every value is boolean or integer, so the
tolerance is zero.

Also: Ineligible fallbacks, malformed deltas, slab headroom, the stdio
loop's bytes, the `serve` CLI, and no fallback without a card.  The
`cuda`-marked test runs a delta stream on the card against the CPU."""

import dataclasses
import io
import json
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from cyclonus_tpu.cli import main as ref_main
from cyclonus_tpu.kube.netpol import (
    IntOrString,
    IPBlock,
    LabelSelector,
    NetworkPolicy,
    NetworkPolicyIngressRule,
    NetworkPolicyPeer,
    NetworkPolicySpec,
)
from cyclonus_tpu.kube.yaml_io import policy_to_dict
from cyclonus_tpu.serve import VerdictService as RefService
from cyclonus_tpu.serve import run_stdio as ref_run_stdio
from cyclonus_tpu.serve import service as ref_service_mod
from cyclonus_tpu.serve import stateregistry as ref_stateregistry
from cyclonus_tpu.telemetry import instruments as ti
from cyclonus_tpu.tiers.model import (
    AdminNetworkPolicy,
    BaselineAdminNetworkPolicy,
    TierPort,
    TierRule,
    TierScope,
    TierSet,
)
from cyclonus_tpu.worker import wireregistry as ref_wireregistry
from cyclonus_tpu.worker.model import Batch as RefBatch
from cyclonus_tpu.worker.model import Delta as RefDelta
from cyclonus_tpu.worker.model import FlowQuery as RefQuery
from cyclonus_tpu_torch import carry
from cyclonus_tpu_torch import telemetry as port_telemetry
from cyclonus_tpu_torch.cli import main
from cyclonus_tpu_torch.engine import api
from cyclonus_tpu_torch.engine import packed_kernel as pk
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.serve import VerdictService, run_stdio, stateregistry
from cyclonus_tpu_torch.serve import service as service_mod
from cyclonus_tpu_torch.worker import wireregistry
from cyclonus_tpu_torch.worker.model import Batch, Delta, FlowQuery

from test_serve import APPS, NS, TIERS, mk_cluster, mk_policy, random_delta
from test_torch_engine import REPO, assert_tree_equal
from test_torch_tiers import port_tiers

PORT_CASES = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP"), (79, "", "SCTP")]

#: state() keys that read a clock or a process-wide counter (the SLO and
#: audit blocks among them: tests/test_torch_slo.py and
#: tests/test_torch_audit.py hold those against the reference)
VOLATILE = {"slo", "audit", "degraded_queries", "query_latency", "last_apply_s",
            "last_full_rebuild_s", "staleness_s"}


def port_policies(policies):
    return [parse_policy_dict(policy_to_dict(p)) for p in policies]


def port_delta(d: RefDelta) -> Delta:
    return Delta.from_dict(json.loads(json.dumps(d.to_dict())))


def anp(name, rng):
    """A seeded AdminNetworkPolicy over the mk_cluster labels."""
    ports = [TierPort(protocol="TCP", port=IntOrString(80))] if rng.random() < 0.5 else None
    rule = TierRule(
        action=rng.choice(["Allow", "Deny", "Pass"]),
        peers=[TierScope(pod_selector=LabelSelector.make({"tier": rng.choice(TIERS)}))],
        ports=ports,
    )
    egress = []
    if rng.random() < 0.4:
        egress = [TierRule(action=rng.choice(["Allow", "Deny"]),
                           peers=[TierScope(namespace_selector=LabelSelector.make({"ns": rng.choice(NS)}))])]
    return AdminNetworkPolicy(
        name=name, priority=rng.randrange(1, 30),
        subject=TierScope(pod_selector=LabelSelector.make({"app": rng.choice(APPS)})),
        ingress=[rule], egress=egress,
    )


def banp(rng):
    return BaselineAdminNetworkPolicy(
        subject=TierScope(pod_selector=LabelSelector.make({"app": rng.choice(APPS)})),
        ingress=[TierRule(action=rng.choice(["Allow", "Deny"]), peers=[TierScope()])],
    )


def stream_delta(svc, rng, tiers: bool) -> RefDelta:
    """One delta of the seeded stream against the reference service's
    current state: test_serve.random_delta's kinds (pod add / remove /
    labels, namespace labels, policy upsert / delete, no-ops), plus pod
    ip changes, pods in namespaces new to the cluster (one fits the
    bucketed namespace table, the next does not) and, when `tiers`, ANP
    and BANP upserts and deletes."""
    roll = rng.random()
    if roll < 0.04:
        i = rng.randrange(1000)
        return RefDelta(kind="pod_add", namespace=rng.choice(["w", "v"]), name=f"fresh{i}",
                        labels={"app": rng.choice(APPS)}, ip=f"10.8.{i // 250}.{i % 250 + 1}")
    if roll < 0.10 and svc.pods:
        key = rng.choice(list(svc.pods))
        ns, name, labels, _ip = svc.pods[key]
        i = rng.randrange(200)
        return RefDelta(kind="pod_add", namespace=ns, name=name, labels=dict(labels),
                        ip=f"10.0.0.{i + 1}")
    if tiers and roll < 0.30:
        sub = rng.random()
        if sub < 0.45:
            name = f"anp{rng.randrange(3)}"
            return RefDelta(kind="anp_upsert", name=name, policy=anp(name, rng).to_dict())
        if sub < 0.65:
            return RefDelta(kind="anp_delete", name=rng.choice(list(svc.anps) + ["nope"]))
        if sub < 0.9:
            return RefDelta(kind="banp_upsert", policy=banp(rng).to_dict())
        return RefDelta(kind="banp_delete")
    return random_delta(svc, rng)


def assert_device_equal(dev, want, path=""):
    if isinstance(want, dict):
        assert set(dev) == set(want), path
        for k in want:
            assert_device_equal(dev[k], want[k], f"{path}/{k}")
        return
    assert dev.dtype == want.dtype, path
    assert torch.equal(dev, want), f"{path} differs"


class Twin:
    """One seeded delta stream through the reference and the port."""

    def __init__(self, pods, namespaces, policies, tiers=None, **kw):
        self.ref = RefService(pods, namespaces, policies, tiers=tiers, **kw)
        self.port = VerdictService(
            pods, namespaces, port_policies(policies), tiers=port_tiers(tiers),
            device="cpu", **kw,
        )
        self.modes = []

    def apply(self, deltas):
        want = self.ref.apply(deltas)
        before = dict(api.TRANSFERS)
        resident = self.port.engine._device_tensors is not None
        got = self.port.apply([port_delta(d) for d in deltas])
        for k in ("applied", "mode", "epoch", "rejected"):
            assert got.get(k) == want.get(k), (k, got, want)
        if got["mode"] != "full" and resident:
            # a patch of resident device views uploads no tensor set
            assert api.TRANSFERS["tensors"] == before["tensors"], (got, deltas)
        self.modes.append(got["mode"])
        self.check()
        return got

    def check(self):
        ref_eng, eng = self.ref.engine, self.port.engine
        assert_tree_equal(ref_eng._tensors, eng._tensors)
        with self.port._lock, self.ref._lock:
            assert self.port._pod_idx == self.ref._pod_idx
        assert eng.pod_keys == ref_eng.pod_keys
        rst, pst = ref_eng._class_state, eng._class_state
        assert (rst is None) == (pst is None)
        if pst is not None:
            assert_tree_equal(rst["ctensors"], pst["ctensors"])
            for k in ("class_of_pod", "class_rep", "class_size"):
                assert np.array_equal(getattr(rst["classes"], k), getattr(pst["classes"], k))
        if eng._device_tensors is not None:
            assert_device_equal(eng._device_tensors,
                                carry.tensors_from_reference(eng._tensors, "cpu"))
        if pst is not None and pst["device_tensors"] is not None:
            assert_device_equal(pst["device_tensors"],
                                carry.tensors_from_reference(pst["ctensors"], "cpu"))
        a, b = self.ref.state(), self.port.state()
        for s in (a, b):
            for k in VOLATILE:
                s.pop(k, None)
            s["tiers"].pop("resolve_s")
        assert a == b

    def query(self, rng, n=8):
        keys = list(self.ref.pods) + ["zz/ghost"]
        qs = [(rng.choice(keys), rng.choice(keys), rng.choice(PORT_CASES)) for _ in range(n)]
        want = self.ref.query([RefQuery(src=s, dst=d, port=c[0], port_name=c[1], protocol=c[2])
                               for s, d, c in qs])
        got = self.port.query([FlowQuery(src=s, dst=d, port=c[0], port_name=c[1], protocol=c[2])
                               for s, d, c in qs])

        def fields(v):
            return (v.query.to_dict(), v.ingress, v.egress, v.combined, v.epoch, v.error)

        assert [fields(v) for v in got] == [fields(v) for v in want]


def tier_set(rng):
    return TierSet(anps=[anp("anp0", rng), anp("anp1", rng)], banp=banp(rng))


class TestDeltaStream:
    @pytest.mark.parametrize("seed", range(4))
    def test_stream(self, seed):
        rng = random.Random(seed)
        pods, namespaces = mk_cluster(15)
        twin = Twin(pods, namespaces, [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(3)])
        twin.query(rng)
        for _step in range(7):
            twin.apply([stream_delta(twin.ref, rng, False) for _ in range(rng.randrange(1, 4))])
            twin.query(rng)
        twin.port.verify_parity(rng=rng, oracle_samples=16)
        assert "incremental" in twin.modes

    @pytest.mark.parametrize("seed", range(2))
    def test_stream_tiered(self, seed):
        """ANP and BANP deltas ride the same stream over a tiered
        service; tier slabs patch like rule slabs."""
        rng = random.Random(40 + seed)
        pods, namespaces = mk_cluster(15)
        twin = Twin(pods, namespaces, [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(2)],
                    tiers=tier_set(rng))
        twin.query(rng)
        for _step in range(7):
            twin.apply([stream_delta(twin.ref, rng, True) for _ in range(rng.randrange(1, 3))])
            twin.query(rng)
        twin.port.verify_parity(rng=rng, oracle_samples=16)
        assert "incremental" in twin.modes

    def test_stream_class_compressed(self):
        """The same with class compression forced on: label flips move
        pods between classes or rebuild the class state."""
        rng = random.Random(7)
        pods, namespaces = mk_cluster(18)
        twin = Twin(pods, namespaces, [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(2)],
                    class_compress="1")
        twin.query(rng)
        for _step in range(6):
            twin.apply([stream_delta(twin.ref, rng, False) for _ in range(rng.randrange(1, 3))])
            twin.query(rng)
        assert twin.port.engine.class_compression_stats()["active"]
        twin.port.verify_parity(rng=rng, oracle_samples=8)

    def test_class_membership_move_in_place(self):
        namespaces = {"x": {"ns": "x"}}
        pods = [("x", f"p{i}", {"app": APPS[i % 2]}, f"10.0.0.{i + 1}") for i in range(8)]
        twin = Twin(pods, namespaces, [mk_policy("pol0", "x", random.Random(3))],
                    class_compress="1")
        before = twin.port.engine.class_compression_stats()["classes"]
        r = twin.apply([RefDelta(kind="pod_labels", namespace="x", name="p4",
                                 labels={"app": "a1"})])
        assert r["mode"] == "incremental"
        assert twin.port.engine.class_compression_stats()["classes"] == before

    def test_delete_then_recreate(self):
        rng = random.Random(42)
        pods, namespaces = mk_cluster(9)
        twin = Twin(pods, namespaces, [mk_policy("pol0", "x", rng)])
        ns, name = pods[2][0], pods[2][1]
        twin.apply([
            RefDelta(kind="pod_remove", namespace=ns, name=name),
            RefDelta(kind="pod_add", namespace=ns, name=name,
                     labels={"app": "a2", "tier": "db"}, ip="10.0.0.99"),
        ])
        twin.apply([
            RefDelta(kind="pod_add", namespace="y", name="ghost", labels={"app": "a0"},
                     ip="10.0.0.98"),
            RefDelta(kind="pod_remove", namespace="y", name="ghost"),
        ])
        assert "y/ghost" not in twin.port.pods
        twin.query(rng)
        twin.port.verify_parity()


@pytest.mark.parametrize("seed", range(3))
def test_pod_signatures_match_reference(seed):
    """The class signatures the patch path recomputes per pod equal the
    reference's dense-bit signatures (cidr=None), whole and row by row."""
    from cyclonus_tpu.engine.encoding import pod_signatures as ref_signatures
    from cyclonus_tpu_torch.engine import host
    from cyclonus_tpu_torch.engine.encoding import pod_signatures

    from test_torch_engine import engines, fuzz_policies

    _ref, port = engines(*fuzz_policies(seed, 5), class_compress="1")
    t = port._tensors
    selpod = host._selector_pod_matches_host(t)
    want = ref_signatures(t, selpod, cidr=None)
    assert np.array_equal(pod_signatures(t, selpod), want)
    view = {k: t[k][3:4] for k in ("pod_ns_id", "pod_ip", "pod_ip_valid")}
    view.update(ingress=t["ingress"], egress=t["egress"])
    assert np.array_equal(pod_signatures(view, selpod[:, 3:4])[0], want[3])


class TestDevicePatch:
    def test_pod_delta_writes_only_its_rows(self):
        """A single-pod delta changes exactly that pod's row of each pod
        leaf in the device views and no other row or leaf, with no
        upload of the tensor set and a few hundred bytes patched."""
        pods, namespaces = mk_cluster(24)
        svc = VerdictService(pods, namespaces, port_policies([mk_policy("pol0", "x", random.Random(5))]),
                             device="cpu")
        svc.query([FlowQuery(src="x/p0", dst="y/p1", port=80, protocol="TCP")])
        eng = svc.engine
        before = {k: v.clone() for k, v in eng._device_tensors.items() if isinstance(v, torch.Tensor)}
        leaves_before = {id(v) for v in eng._device_tensors.values() if isinstance(v, torch.Tensor)}
        transfers, bytes0 = dict(api.TRANSFERS), svc.patch_stats()["patch_bytes"]
        r = svc.apply([Delta(kind="pod_labels", namespace="x", name="p3",
                             labels={"app": "a2", "tier": "db"})])
        assert r["mode"] == "incremental", r
        assert api.TRANSFERS == transfers
        assert svc.engine is eng
        dev = eng._device_tensors
        assert {id(v) for v in dev.values() if isinstance(v, torch.Tensor)} == leaves_before
        row = svc._pod_idx["x/p3"]
        for k, old in before.items():
            changed = (dev[k] != old).reshape(old.shape[0], -1).any(dim=1).nonzero().flatten().tolist()
            assert changed in ([], [row]), (k, changed)
        assert not torch.equal(dev["pod_kv"], before["pod_kv"])
        patched = svc.patch_stats()["patch_bytes"] - bytes0
        assert 0 < patched <= 4096
        assert_device_equal(dev, carry.tensors_from_reference(eng._tensors, "cpu"))
        svc.verify_parity(oracle_samples=8)

    def test_widened_ip_row(self):
        """A pod ip delta writes the widened int64 value of the uint32."""
        pods, namespaces = mk_cluster(6)
        svc = VerdictService(pods, namespaces, [], device="cpu")
        svc.query([FlowQuery(src="x/p0", dst="y/p1", port=80, protocol="TCP")])
        svc.apply([Delta(kind="pod_add", namespace="x", name="p0", labels=dict(pods[0][2]),
                         ip="255.255.255.254")])
        i = svc._pod_idx["x/p0"]
        assert svc.engine._device_tensors["pod_ip"].dtype == torch.int64
        assert int(svc.engine._device_tensors["pod_ip"][i]) == 0xFFFFFFFE

    def test_invalidate_keeps_device_views(self):
        _ref, port = None, VerdictService(*mk_cluster(6), [], device="cpu").engine
        views = port._dev()
        port.invalidate_after_patch()
        assert port._dev() is views


class TestIneligible:
    def test_churn_threshold_falls_back_to_full(self, monkeypatch):
        monkeypatch.setenv("CYCLONUS_SERVE_CHURN_ROWS", "0")
        monkeypatch.setenv("CYCLONUS_SERVE_CHURN_FRAC", "0.0")
        pods, namespaces = mk_cluster(9)
        twin = Twin(pods, namespaces, [mk_policy("pol0", "x", random.Random(11))])
        r = twin.apply([RefDelta(kind="pod_labels", namespace="x", name="p0", labels={"app": "a1"})])
        assert r["mode"] == "full"

    def test_ipv6_ipblock_is_ineligible(self):
        namespaces = {"x": {"ns": "x"}}
        pods = [("x", f"p{i}", {"app": "a0"}, f"10.0.0.{i + 1}") for i in range(4)]
        pol = NetworkPolicy(
            name="v6", namespace="x",
            spec=NetworkPolicySpec(
                pod_selector=LabelSelector.make(match_labels={}),
                policy_types=["Ingress"],
                ingress=[NetworkPolicyIngressRule(
                    ports=[], from_=[NetworkPolicyPeer(ip_block=IPBlock.make("fd00::/8", []))],
                )],
            ),
        )
        twin = Twin(pods, namespaces, [pol])
        twin.query(random.Random(0))
        before = api.TRANSFERS["tensors"]
        r = twin.apply([RefDelta(kind="pod_labels", namespace="x", name="p0", labels={"app": "a1"})])
        assert r["mode"] == "full"
        twin.query(random.Random(1))
        assert api.TRANSFERS["tensors"] == before + 1  # the rebuilt engine's upload
        twin.port.verify_parity()

    def test_label_row_overflow_rebuilds(self):
        pods, namespaces = mk_cluster(6)
        twin = Twin(pods, namespaces, [mk_policy("pol0", "x", random.Random(2))])
        wide = {f"k{i}": "v" for i in range(9)}
        r = twin.apply([RefDelta(kind="pod_labels", namespace="x", name="p0", labels=wide)])
        assert r["mode"] == "full"

    @pytest.mark.parametrize("headroom", ["0", "1"])
    def test_headroom(self, monkeypatch, headroom):
        """Policies whose selectors outgrow the natural selector bucket
        patch into the headroom reservation (one save) instead of
        rebuilding; with no headroom the same batch rebuilds."""
        monkeypatch.setenv("CYCLONUS_SERVE_HEADROOM", headroom)
        pods, namespaces = mk_cluster(12)
        rng = random.Random(9)
        twin = Twin(pods, namespaces, [mk_policy("pol0", "x", rng)])
        saves0 = ti.SERVE_HEADROOM_SAVES.value()
        batch = []
        for i, (app, tier) in enumerate([(a, t) for a in APPS for t in TIERS][:3]):
            pol = mk_policy(f"grow{i}", NS[i % 3], rng)
            pol.spec.pod_selector = LabelSelector.make(match_labels={"app": app, "tier": tier})
            batch.append(RefDelta(kind="policy_upsert", namespace=NS[i % 3], name=f"grow{i}",
                                  policy=policy_to_dict(pol)))
        r = twin.apply(batch)
        saves = ti.SERVE_HEADROOM_SAVES.value() - saves0
        assert twin.port.patch_stats()["headroom_saves"] == saves
        assert r["mode"] == ("incremental" if headroom == "1" else "full")
        assert saves == (1 if headroom == "1" else 0)
        twin.port.verify_parity()


class TestMalformedDeltas:
    def test_unknown_kind_and_bad_policy_rejected(self):
        pods, namespaces = mk_cluster(8)
        twin = Twin(pods, namespaces, [mk_policy("pol0", "x", random.Random(6))])
        r = twin.apply([
            RefDelta(kind="pod_labels", namespace="x", name="p0", labels={"app": "a1", "tier": "db"}),
            RefDelta(kind="pod_rename", namespace="x", name="p0"),
            RefDelta(kind="policy_upsert", namespace="x", name="bad",
                     policy={"spec": {"policyTypes": []}}),
        ])
        assert r["applied"] == 1 and len(r["rejected"]) == 2
        assert "unknown delta kind" in r["rejected"][0]

    def test_pod_add_without_parseable_ip_rejected(self):
        pods, namespaces = mk_cluster(4)
        twin = Twin(pods, namespaces, [])
        r = twin.apply([
            RefDelta(kind="pod_add", namespace="x", name="noip", labels={"app": "a0"}),
            RefDelta(kind="pod_add", namespace="x", name="badip", labels={"app": "a0"},
                     ip="not-an-ip"),
        ])
        assert r["mode"] == "noop" and len(r["rejected"]) == 2
        twin.query(random.Random(0))

    def test_misrouted_tier_payload_rejected(self):
        pods, namespaces = mk_cluster(4)
        twin = Twin(pods, namespaces, [])
        payload = anp("a", random.Random(1)).to_dict()
        r = twin.apply([
            RefDelta(kind="banp_upsert", policy=payload),
            RefDelta(kind="anp_upsert", name="a", policy={**payload, "spec": {}}),
        ])
        assert r["mode"] == "noop" and len(r["rejected"]) == 2

    def test_policy_delete_empty_namespace_roundtrips(self):
        pods, namespaces = mk_cluster(6)
        twin = Twin(pods, namespaces, [])
        deny = mk_policy("deny", "", random.Random(17))
        twin.apply([RefDelta(kind="policy_upsert", namespace="", name="deny",
                             policy=policy_to_dict(deny))])
        assert "default/deny" in twin.port.netpols
        r = twin.apply([RefDelta(kind="policy_delete", namespace="", name="deny")])
        assert r["mode"] != "noop" and not twin.port.netpols

    def test_apply_failure_rolls_back_batch(self, monkeypatch):
        pods, namespaces = mk_cluster(8)
        rng = random.Random(11)
        svc = VerdictService(pods, namespaces, port_policies([mk_policy("pol0", "x", rng)]),
                             device="cpu")
        real = VerdictService._compiled_policy
        calls = {"n": 0}

        def boom(self):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("fails only in combination")
            return real(self)

        monkeypatch.setattr(VerdictService, "_compiled_policy", boom)
        delta = Delta(kind="policy_upsert", namespace="x", name="newpol",
                      policy=policy_to_dict(mk_policy("newpol", "x", rng)))
        with pytest.raises(RuntimeError, match="in combination"):
            svc.apply([delta])
        assert "x/newpol" not in svc.netpols and svc.state()["epoch"] == 0
        svc.verify_parity()
        r = svc.apply([delta])
        assert r["mode"] == "incremental" and "x/newpol" in svc.netpols
        svc.verify_parity()


class TestQueries:
    def test_grouping_unknown_keys_and_epoch(self):
        pods, namespaces = mk_cluster(10)
        twin = Twin(pods, namespaces, [mk_policy("pol0", "x", random.Random(1))])
        for seed in range(3):
            twin.query(random.Random(seed), n=13)

    def test_one_unpadded_pairs_call_per_case(self, monkeypatch):
        """A batch runs one evaluate_pairs call per port case, on exactly
        that case's pairs."""
        pods, namespaces = mk_cluster(10)
        svc = VerdictService(pods, namespaces, port_policies([mk_policy("pol0", "x", random.Random(1))]),
                             device="cpu")
        calls = []
        real = svc.engine.evaluate_pairs
        monkeypatch.setattr(svc.engine, "evaluate_pairs",
                            lambda cases, pairs: calls.append(len(pairs)) or real(cases, pairs))
        keys = [f"{p[0]}/{p[1]}" for p in pods]
        qs = [FlowQuery(src=keys[i], dst=keys[(3 * i) % 10], port=80, protocol="TCP") for i in range(5)]
        qs += [FlowQuery(src=keys[i], dst=keys[i], port=53, protocol="UDP") for i in range(3)]
        verdicts = svc.query(qs)
        assert sorted(calls) == [3, 5] and len(verdicts) == 8

    def test_degraded_route_while_warming(self):
        """Before prewarm the service answers from the scalar oracle, the
        same verdicts as the live route."""
        pods, namespaces = mk_cluster(10)
        policies = port_policies([mk_policy("pol0", "x", random.Random(1))])
        warm = VerdictService(pods, namespaces, policies, device="cpu", defer_ready=True)
        live = VerdictService(pods, namespaces, policies, device="cpu")
        # degraded_queries reads the process-wide counter, as the
        # reference's state() does: start this worker's count at zero
        port_telemetry.reset()
        qs = [FlowQuery(src=f"{pods[i][0]}/{pods[i][1]}", dst=f"{pods[j][0]}/{pods[j][1]}",
                        port=80, protocol="TCP", port_name="serve-80-tcp")
              for i in range(10) for j in (0, 3, 7)]
        assert not warm.ready
        degraded = warm.query(qs)
        assert warm.state()["degraded_queries"] == len(qs)
        pw = warm.prewarm()
        assert warm.ready and pw["calls"] == 1
        verdicts = [(v.ingress, v.egress, v.combined) for v in live.query(qs)]
        assert [(v.ingress, v.egress, v.combined) for v in degraded] == verdicts
        assert [(v.ingress, v.egress, v.combined) for v in warm.query(qs)] == verdicts

    def test_latency_quantiles(self):
        """query_latency reads cyclonus_tpu_serve_query_latency_seconds,
        a process-wide histogram (as the reference's state() does): reset
        the port's telemetry so earlier queries in this worker drop out;
        the quantiles are bucket interpolations (histogram_quantile)."""
        svc = VerdictService(*mk_cluster(6), [], device="cpu")
        port_telemetry.reset()
        svc.query([FlowQuery(src="x/p0", dst="y/p1", port=80, protocol="TCP")] * 3)
        lat = svc.state()["query_latency"]
        assert lat["count"] == 3 and 0 <= lat["p50_s"] <= lat["p99_s"]

    def test_state_covers_every_registered_field(self):
        svc = VerdictService(*mk_cluster(6), [], device="cpu")
        st = svc.state()
        for field in stateregistry.FIELDS:
            assert field.state_key in st
        assert set(st["slo"]) == {"enforce", "objectives"} and st["audit"] == {"enabled": False}


class TestWire:
    def test_copies_match_reference(self):
        assert stateregistry.manifest() == ref_stateregistry.manifest()
        assert wireregistry.message_names() == ref_wireregistry.message_names()
        for name in ref_wireregistry.message_names():
            assert dataclasses.asdict(wireregistry.message(name)) == dataclasses.asdict(
                ref_wireregistry.message(name)
            )
        batch = RefBatch(namespace="", pod="", container="",
                         deltas=[RefDelta(kind="pod_labels", namespace="x", name="p0",
                                          labels={"app": "a1"})],
                         queries=[RefQuery(src="x/p0", dst="y/p1", port=80, protocol="TCP")])
        assert Batch.from_json(batch.to_json()).to_json() == batch.to_json()

    def test_stdio_bytes_equal_reference(self, monkeypatch):
        """A scripted stdin through both loops: stdout byte for byte
        equal (the latency field pinned by a fixed clock on both)."""
        still = types.SimpleNamespace(perf_counter=lambda: 0.0, monotonic=lambda: 0.0)
        monkeypatch.setattr(ref_service_mod, "time", still)
        monkeypatch.setattr(service_mod, "time", still)
        pods, namespaces = mk_cluster(8)
        rng = random.Random(2)
        policies = [mk_policy("pol0", "x", rng), mk_policy("pol1", "y", rng)]
        q = [{"Src": "x/p0", "Dst": "x/p3", "Port": 80, "Protocol": "TCP",
              "PortName": "serve-80-tcp"},
             {"Src": "y/p1", "Dst": "zz/none", "Port": 81, "Protocol": "UDP"}]
        lines = [
            json.dumps({"Namespace": "", "Pod": "", "Container": "", "Requests": [],
                        "Deltas": [{"Kind": "pod_labels", "Namespace": "x", "Name": "p0",
                                    "Labels": {"app": "a1", "tier": "db"}}],
                        "Queries": q}),
            "this is not json",
            json.dumps({"Namespace": "", "Pod": "", "Container": "", "Queries": q}),
            json.dumps({"Namespace": "", "Pod": "", "Container": "",
                        "Deltas": [{"Kind": "nope", "Namespace": "x", "Name": "p1"},
                                   {"Kind": "policy_delete", "Namespace": "y", "Name": "pol1"}]}),
            "",
            json.dumps({"Namespace": "", "Pod": "", "Container": ""}),
        ]
        stdin = "\n".join(lines) + "\n"
        out_ref, out = io.StringIO(), io.StringIO()
        assert ref_run_stdio(RefService(pods, namespaces, policies), io.StringIO(stdin), out_ref) == 5
        assert run_stdio(VerdictService(pods, namespaces, port_policies(policies), device="cpu"),
                         io.StringIO(stdin), out) == 5
        assert out.getvalue() == out_ref.getvalue()
        assert '"Error"' in out.getvalue() and '"Rejected"' in out.getvalue()


class TestCli:
    ARGV = ["serve", "--synthetic-pods", "12", "--synthetic-namespaces", "2",
            "--max-lines", "2", "--no-prewarm"]

    def test_serve_equals_reference(self, monkeypatch, capsys):
        still = types.SimpleNamespace(perf_counter=lambda: 0.0, monotonic=lambda: 0.0)
        monkeypatch.setattr(ref_service_mod, "time", still)
        monkeypatch.setattr(service_mod, "time", still)
        from cyclonus_tpu_torch.cli.serve_cmd import synthetic_cluster

        pods, _namespaces = synthetic_cluster(12, 2, 7)
        other = f"{pods[3][0]}/{pods[3][1]}"
        stdin = "\n".join([
            Batch(namespace="", pod="", container="",
                  deltas=[Delta(kind="pod_add", namespace="ns0", name="extra",
                                labels={"app": "app1", "pod": "p1", "tier": "tier1"},
                                ip="10.99.0.1")],
                  queries=[FlowQuery(src="ns0/extra", dst=other, port=80,
                                     protocol="TCP")]).to_json(),
            json.dumps({"Namespace": "", "Pod": "", "Container": "",
                        "Queries": [{"Src": other, "Dst": "ns0/extra", "Port": 80,
                                     "Protocol": "TCP"}]}),
        ]) + "\n"
        outs = []
        for fn, argv in ((main, self.ARGV + ["--device", "cpu"]), (ref_main, self.ARGV)):
            monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
            assert fn(argv) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert json.loads(outs[0].splitlines()[0])["Mode"] == "incremental"

    def test_module_entry_point(self):
        from cyclonus_tpu_torch.cli.serve_cmd import synthetic_cluster

        pods, _namespaces = synthetic_cluster(6, 4, 7)
        key = f"{pods[0][0]}/{pods[0][1]}"
        line = Batch(namespace="", pod="", container="",
                     queries=[FlowQuery(src=key, dst=key, port=80, protocol="TCP")]).to_json()
        proc = subprocess.run(
            [sys.executable, "-m", "cyclonus_tpu_torch", "serve", "--synthetic-pods", "6",
             "--max-lines", "1", "--device", "cpu"],
            input=line + "\n", cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        reply = json.loads(proc.stdout.strip().splitlines()[-1])
        assert reply["Epoch"] == 0 and reply["Verdicts"][0]["Combined"] is True
        assert "prewarmed the query path" in proc.stderr

    def test_synthesize_pods_not_ported(self, monkeypatch, capsys):
        """--synthesize-pods (ported with the analysis layer) boots the
        reference's synthesized cluster: the same pod count on stderr and
        the same reply to a query between two of its pods (the whole
        stream against the reference: test_torch_cli_kube.py)."""
        from cyclonus_tpu_torch.analysis import synthesize_cluster
        from cyclonus_tpu_torch.kube.yaml_io import load_policies_from_path
        from cyclonus_tpu_torch.matcher import build_network_policies

        path = os.path.join(REPO, "examples", "networkpolicies", "simple-example")
        pods, _ = synthesize_cluster(build_network_policies(True, load_policies_from_path(path)))
        key = f"{pods[0][0]}/{pods[0][1]}"
        line = json.dumps({"Namespace": "", "Pod": "", "Container": "", "Queries": [
            {"Src": key, "Dst": f"{pods[1][0]}/{pods[1][1]}", "Port": 80, "Protocol": "TCP"}]})
        still = types.SimpleNamespace(perf_counter=lambda: 0.0, monotonic=lambda: 0.0)
        monkeypatch.setattr(ref_service_mod, "time", still)
        monkeypatch.setattr(service_mod, "time", still)
        outs = []
        argv = ["serve", "--synthesize-pods", "--policies", path, "--no-prewarm"]
        for fn, extra in ((main, ["--device", "cpu"]), (ref_main, [])):
            monkeypatch.setattr(sys, "stdin", io.StringIO(line + "\n"))
            assert fn(argv + extra) == 0
            outs.append(capsys.readouterr())
        assert outs[0].out == outs[1].out
        assert f"{len(pods)} pods" in outs[0].err and f"{len(pods)} pods" in outs[1].err



def http(url):
    """(status, decoded JSON or text) of a GET; error statuses read."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            status, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body


@pytest.fixture
def both_servers(monkeypatch, tmp_path):
    """The reference's and the port's process metrics servers on ephemeral
    ports, with their routes and readiness callbacks unregistered after."""
    from cyclonus_tpu.telemetry import server as ref_server
    from cyclonus_tpu_torch.telemetry import server as port_server

    monkeypatch.setenv("CYCLONUS_FLIGHT_RECORDER_PATH", str(tmp_path / "flight.json"))
    mods = (ref_server, port_server)
    for m in mods:
        m.stop_metrics_server()
    srvs = tuple(m.start_metrics_server(0) for m in mods)
    try:
        yield srvs
    finally:
        for m in mods:
            for route in ("/state", "/query"):
                m.unregister_route(route)
            m.register_readiness(None)
            m.register_slo(None)
            m.register_audit(None)
            m.stop_metrics_server()


class TestHttp:
    """register_http: /state and /query over HTTP, as the reference's."""

    def test_state_and_query_equal_reference(self, both_servers):
        ref_srv, srv = both_servers
        pods, namespaces = mk_cluster(12)
        rng = random.Random(4)
        twin = Twin(pods, namespaces, [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(3)])
        ref_service_mod.register_http(twin.ref)
        service_mod.register_http(twin.port)
        twin.apply([RefDelta(kind="pod_labels", namespace="x", name="p0",
                             labels={"app": "a1", "tier": "db"})])
        keys = list(twin.ref.pods) + ["zz/ghost"]
        for _ in range(24):
            src, dst = rng.choice(keys), rng.choice(keys)
            port, name, proto = rng.choice(PORT_CASES)
            q = f"/query?src={src}&dst={dst}&port={port}&protocol={proto}"
            if name:
                q += f"&portName={name}"
            want, got = http(ref_srv.url + q), http(srv.url + q)
            for _status, body in (want, got):
                body.pop("LatencyMs", None)
            assert got == want, q
            assert got[0] == (400 if dst == "zz/ghost" or src == "zz/ghost" else 200)
        want, got = http(ref_srv.url + "/state")[1], http(srv.url + "/state")[1]
        assert got == json.loads(json.dumps(twin.port.state(), default=str)) | {
            k: got[k] for k in VOLATILE & set(got)}
        for st in (want, got):
            for k in VOLATILE:
                st.pop(k, None)
            st["tiers"].pop("resolve_s")
        assert got == want

    def test_query_bad_requests(self, both_servers):
        ref_srv, srv = both_servers
        pods, namespaces = mk_cluster(6)
        ref_service_mod.register_http(RefService(pods, namespaces, []))
        service_mod.register_http(VerdictService(pods, namespaces, [], device="cpu"))
        for q in ("/query?src=x/p0&dst=y/p1&port=eighty", "/query?src=x/p0&port=80",
                  "/query?dst=x/p0", "/query"):
            want, got = http(ref_srv.url + q), http(srv.url + q)
            assert got == want and got[0] == 400, q
        for path in ("/slo", "/audit"):
            want, got = http(ref_srv.url + path), http(srv.url + path)
            assert got[0] == want[0] == 200 and set(got[1]) == set(want[1]), path
        assert http(srv.url + "/audit")[1] == {"enabled": False}

    def test_readyz_across_prewarm_and_metrics(self, both_servers):
        """/readyz answers 503 while the service warms (queries then
        degrade to the oracle) and 200 after the prewarm; the queries
        move cyclonus_tpu_serve_queries_total and the /state latency."""
        from cyclonus_tpu_torch.telemetry import server as port_server

        _ref_srv, srv = both_servers
        pods, namespaces = mk_cluster(10)
        svc = VerdictService(pods, namespaces, port_policies([mk_policy("pol0", "x", random.Random(1))]),
                             device="cpu", defer_ready=True)
        service_mod.register_http(svc)
        port_server.register_readiness(svc.readiness)
        status, body = http(srv.url + "/readyz")
        assert status == 503 and body.startswith("warming")
        port_telemetry.reset()
        q = "/query?src=x/p0&dst=y/p1&port=80&protocol=TCP"
        degraded = http(srv.url + q)
        assert degraded[0] == 200
        svc.prewarm()
        status, body = http(srv.url + "/readyz")
        assert status == 200 and "serving at epoch 0" in body
        live = http(srv.url + q)
        for _s, b in (degraded, live):
            b.pop("LatencyMs", None)
        assert live == degraded
        st = http(srv.url + "/state")[1]
        assert st["ready"] and st["degraded_queries"] == 1 and st["query_latency"]["count"] == 2
        metrics = http(srv.url + "/metrics")[1]
        assert "cyclonus_tpu_serve_queries_total 2" in metrics
        assert "cyclonus_tpu_serve_degraded_queries_total 1" in metrics

    def test_cli_metrics_port(self, monkeypatch, capsys, tmp_path):
        """`serve --metrics-port 0` binds, prints the bound routes, and
        serves /state while the stdio loop runs."""
        from cyclonus_tpu_torch.telemetry import server as port_server

        monkeypatch.setenv("CYCLONUS_FLIGHT_RECORDER_PATH", str(tmp_path / "flight.json"))
        port_server.stop_metrics_server()
        seen = {}

        class Stdin(io.StringIO):
            def __iter__(self):
                srv = port_server.active_server()
                seen["state"] = http(srv.url + "/state")
                seen["ready"] = http(srv.url + "/readyz")
                return super().__iter__()

        monkeypatch.setattr(sys, "stdin", Stdin(""))
        try:
            assert main(["serve", "--synthetic-pods", "8", "--device", "cpu",
                         "--metrics-port", "0"]) == 0
        finally:
            port_server.register_readiness(None)
            for route in ("/state", "/query"):
                port_server.unregister_route(route)
            port_server.stop_metrics_server()
        err = capsys.readouterr().err
        assert "serve: metrics on http://127.0.0.1:" in err and "/readyz" in err
        assert seen["state"][0] == 200 and seen["state"][1]["pods"] == 8
        assert seen["ready"][0] == 200

class TestNoFallback:
    def test_service_raises_without_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VerdictService(*mk_cluster(4), [])
        with pytest.raises(RuntimeError, match="requested but no CUDA device"):
            VerdictService(*mk_cluster(4), [], device="cuda")

    def test_cli_raises_without_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["serve", "--synthetic-pods", "4"])


@pytest.mark.cuda
def test_cuda_stream_equals_cpu():
    """On the card: a delta stream through a service on the card and one
    on the CPU; verdicts, host tensors and device views agree at every
    step, no patch uploads the tensor set, and the dense counts after a
    patch launch K1 and equal the CPU service's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = random.Random(3)
    pods, namespaces = mk_cluster(40)
    policies = port_policies([mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(4)])
    cpu = VerdictService(pods, namespaces, policies, device="cpu")
    card = VerdictService(pods, namespaces, policies, device="cuda")
    cases = [api.PortCase(80, "serve-80-tcp", "TCP"), api.PortCase(81, "serve-81-udp", "UDP")]
    for _ in range(3):
        card.engine.evaluate_grid_counts(cases)
    for _step in range(6):
        deltas = [stream_delta(cpu, rng, False) for _ in range(2)]
        transfers = dict(api.TRANSFERS)
        a = cpu.apply([port_delta(d) for d in deltas])
        b = card.apply([port_delta(d) for d in deltas])
        assert a["mode"] == b["mode"]
        if b["mode"] != "full":
            assert api.TRANSFERS["tensors"] == transfers["tensors"]
        assert_tree_equal(cpu.engine._tensors, card.engine._tensors)
        dev = card.engine._device_tensors
        if dev is not None:
            assert_device_equal(dev, carry.tensors_from_reference(card.engine._tensors, "cuda"))
        keys = list(cpu.pods)
        qs = [FlowQuery(src=rng.choice(keys), dst=rng.choice(keys), port=80, protocol="TCP",
                        port_name="serve-80-tcp") for _ in range(16)]
        assert [(v.ingress, v.egress, v.combined) for v in card.query(qs)] == [
            (v.ingress, v.egress, v.combined) for v in cpu.query(qs)
        ]
    launched = pk.LAUNCHES["packed_counts"]
    assert card.engine.evaluate_grid_counts(cases) == cpu.engine.evaluate_grid_counts(cases)
    assert pk.LAUNCHES["packed_counts"] == launched + 1
    card.verify_parity(oracle_samples=8)
