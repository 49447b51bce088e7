"""The port's verdict audit plane (cyclonus_tpu_torch/audit) against the
reference's (cyclonus_tpu/audit): over the same seeded delta stream the
port's service commits the reference's epoch digests, untiered, tiered
and class-compressed; the sampler draws the reference's sample for a
seed; an armed `verdict_corrupt` is detected with the reference's repro
bundle; a clean stream audits with zero divergences; queue overflow and
epoch eviction are counted as the reference counts them; /audit answers
200, 503 and 500; a divergence burns `verdict_integrity`; and with
auditing off the query path touches no audit method."""

import json
import random
import urllib.error
import urllib.request

import pytest

import cyclonus_tpu.audit as ref_audit
import cyclonus_tpu_torch.audit as port_audit
from cyclonus_tpu import chaos as ref_chaos
from cyclonus_tpu import telemetry as ref_telemetry
from cyclonus_tpu.matcher.builder import build_network_policies as ref_build
from cyclonus_tpu.serve import VerdictService as RefService
from cyclonus_tpu.telemetry import instruments as ref_ti
from cyclonus_tpu.worker.model import FlowQuery as RefQuery
from cyclonus_tpu_torch import chaos
from cyclonus_tpu_torch import telemetry as port_telemetry
from cyclonus_tpu_torch.audit import AuditController
from cyclonus_tpu_torch.audit import sampler as sampler_mod
from cyclonus_tpu_torch.matcher.builder import build_network_policies
from cyclonus_tpu_torch.serve import VerdictService
from cyclonus_tpu_torch.serve.service import register_http
from cyclonus_tpu_torch.slo import SloController
from cyclonus_tpu_torch.telemetry import instruments as ti
from cyclonus_tpu_torch.telemetry import server as tserver
from cyclonus_tpu_torch.worker.model import Delta, FlowQuery

from test_serve import NS, mk_cluster, mk_policy
from test_torch_serve import PORT_CASES, port_delta, port_policies, stream_delta, tier_set
from test_torch_tiers import port_tiers


@pytest.fixture(autouse=True)
def _disarmed():
    """Chaos state is process-global in each package (the env var is the
    control surface): every test starts and ends disarmed."""
    chaos.reset("")
    ref_chaos.reset("")
    yield
    chaos.reset("")
    ref_chaos.reset("")


def mk_audit(module=port_audit, **kw):
    kw.setdefault("rate", 1.0)
    kw.setdefault("seed", 7)
    kw.setdefault("start_worker", False)
    return module.AuditController(**kw)


class Pair:
    """A reference and a port service over one cluster, each with an
    audit controller drained on the calling thread."""

    def __init__(self, pods, namespaces, policies, tiers=None, **kw):
        self.ref = RefService(pods, namespaces, policies, tiers=tiers,
                              audit=mk_audit(ref_audit), **kw)
        self.port = VerdictService(pods, namespaces, port_policies(policies),
                                   tiers=port_tiers(tiers), device="cpu",
                                   audit=mk_audit(), **kw)

    def apply(self, deltas):
        want = self.ref.apply(deltas)
        got = self.port.apply([port_delta(d) for d in deltas])
        assert (got["mode"], got["epoch"]) == (want["mode"], want["epoch"])

    def query(self, rng, n=6):
        keys = list(self.ref.pods)
        qs = [(rng.choice(keys), rng.choice(keys), rng.choice(PORT_CASES)) for _ in range(n)]
        want = self.ref.query([RefQuery(src=s, dst=d, port=c[0], port_name=c[1],
                                        protocol=c[2]) for s, d, c in qs])
        got = self.port.query([FlowQuery(src=s, dst=d, port=c[0], port_name=c[1],
                                         protocol=c[2]) for s, d, c in qs])
        assert [(v.ingress, v.egress, v.combined) for v in got] == [
            (v.ingress, v.egress, v.combined) for v in want]
        return len(qs)

    def digests(self):
        """Both services' digests by epoch, without the timing field."""
        out = []
        for svc in (self.ref, self.port):
            svc.audit.drain()
            out.append({e: {k: v for k, v in d.items() if k != "seconds"}
                        for e, d in svc.audit.digests().items()})
        return out


def run_stream(pair, rng, tiers, steps=7):
    answered = pair.query(rng)
    for _ in range(steps):
        pair.apply([stream_delta(pair.ref, rng, tiers) for _ in range(rng.randrange(1, 4))])
        answered += pair.query(rng)
        want, got = pair.digests()
        assert got == want
    return answered


class TestEpochDigests:
    @pytest.mark.parametrize("seed", range(4))
    def test_stream_digests_equal_reference(self, seed):
        rng = random.Random(seed)
        pods, namespaces = mk_cluster(15)
        pair = Pair(pods, namespaces, [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(3)])
        run_stream(pair, rng, False)
        want, got = pair.digests()
        assert len(got) == min(pair.port.epoch + 1, pair.port.audit.epoch_ring)

    @pytest.mark.parametrize("seed", range(3))
    def test_stream_digests_equal_reference_tiered(self, seed):
        rng = random.Random(40 + seed)
        pods, namespaces = mk_cluster(15)
        pair = Pair(pods, namespaces, [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(2)],
                    tiers=tier_set(rng))
        run_stream(pair, rng, True)

    def test_stream_digests_equal_reference_class_compressed(self):
        rng = random.Random(7)
        pods, namespaces = mk_cluster(18)
        pair = Pair(pods, namespaces, [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(2)],
                    class_compress="1")
        run_stream(pair, rng, False, steps=5)
        assert pair.port.engine.class_compression_stats()["active"]

    def test_digest_is_route_independent(self, monkeypatch):
        """Dense, class-compressed and TSS services over one state digest
        alike: nothing engine-derived enters the hash."""
        digests = set()
        for kw, tss in (({"class_compress": "0"}, "0"), ({"class_compress": "1"}, "0"),
                        ({"class_compress": "1"}, "1")):
            monkeypatch.setenv("CYCLONUS_CIDR_TSS", tss)
            svc = VerdictService(*mk_cluster(9), [], device="cpu", audit=mk_audit(), **kw)
            svc.audit.drain()
            digests.add(svc.audit.digests()[0]["digest"])
        assert len(digests) == 1

    @pytest.mark.parametrize("n_rows", [0, 1, 8, 33])
    def test_digest_functions_equal_reference(self, n_rows):
        rng = random.Random(n_rows)
        pods_list, namespaces = mk_cluster(12)
        pols = [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(3)]
        pods = {f"{p[0]}/{p[1]}": p for p in pods_list}
        ref_np = {f"{p.effective_namespace()}/{p.name}": p for p in pols}
        port_np = {f"{p.effective_namespace()}/{p.name}": p for p in port_policies(pols)}
        want = ref_audit.epoch_digest(5, pods, namespaces, ref_np, {}, None,
                                      ref_build(True, pols), None, seed=3, n_rows=n_rows)
        got = port_audit.epoch_digest(5, pods, namespaces, port_np, {}, None,
                                      build_network_policies(True, port_policies(pols)), None,
                                      seed=3, n_rows=n_rows)
        want.pop("seconds"), got.pop("seconds")
        assert got == want and got["n_rows"] == n_rows
        assert port_audit.canonical_state(pods, namespaces, port_np, {}, None) == \
            ref_audit.canonical_state(pods, namespaces, ref_np, {}, None)
        # order independent, and the epoch counter is not hashed
        shuffled = dict(reversed(list(pods.items())))
        again = port_audit.epoch_digest(0, shuffled, dict(reversed(list(namespaces.items()))),
                                        port_np, {}, None,
                                        build_network_policies(True, port_policies(pols)), None,
                                        seed=3, n_rows=n_rows)
        assert again["digest"] == got["digest"] and again["epoch"] == 0

    def test_state_change_changes_digest(self):
        pods_list, namespaces = mk_cluster(8)
        pods = {f"{p[0]}/{p[1]}": p for p in pods_list}
        policy = build_network_policies(True, [])
        base = port_audit.epoch_digest(0, pods, namespaces, {}, {}, None, policy, None)
        p = pods["x/p0"]
        pods["x/p0"] = (p[0], p[1], {**p[2], "app": "z"}, p[3])
        assert port_audit.epoch_digest(0, pods, namespaces, {}, {}, None, policy,
                                       None)["digest"] != base["digest"]


class TestShadowChecks:
    def test_clean_stream_zero_divergence(self):
        """Every answered verdict of a churned service is checked (rate
        1.0) against the scalar oracle at its epoch, with no divergence."""
        rng = random.Random(11)
        pods, namespaces = mk_cluster(15)
        pair = Pair(pods, namespaces, [mk_policy(f"pol{i}", NS[i % 3], rng) for i in range(3)])
        checked0, diverged0 = ti.AUDIT_CHECKED.value(), ti.AUDIT_DIVERGED.value()
        answered = run_stream(pair, rng, False)
        assert ti.AUDIT_CHECKED.value() == checked0 + answered
        assert ti.AUDIT_DIVERGED.value() == diverged0
        snap = pair.port.audit.snapshot()
        assert snap["sampled"] == answered and snap["queue_depth"] == 0
        assert snap["last_divergence"] is None
        assert json.loads(json.dumps(snap)) == snap
        assert set(snap) == set(pair.ref.audit.snapshot())

    def test_flush_waits_for_the_worker(self):
        svc = VerdictService(*mk_cluster(10), [], device="cpu",
                             audit=AuditController(rate=1.0, seed=7))
        try:
            checked0 = ti.AUDIT_CHECKED.value()
            keys = list(svc.pods)
            svc.query([FlowQuery(src=keys[i], dst=keys[-i], port=80, protocol="TCP")
                       for i in range(4)])
            assert svc.audit.flush(timeout=10.0)
            assert ti.AUDIT_CHECKED.value() == checked0 + 4
            assert sorted(svc.audit.digests()) == [0]
        finally:
            svc.audit.close()

    @pytest.mark.parametrize("rate,seed", [(0.5, 11), (0.5, 12), (0.1, 3), (1.0, 0), (0.0, 0)])
    def test_sampler_draws_equal_reference(self, rate, seed):
        q = {"src": "x/p0", "dst": "y/p1", "port": 80, "port_name": "", "protocol": "TCP"}
        pattern = []
        for module in (ref_audit, port_audit):
            aud = mk_audit(module, rate=rate, seed=seed, queue_cap=256)
            pattern.append([aud.offer(q, (True, True, True), "r", 0) for _ in range(64)])
        assert pattern[1] == pattern[0]
        if rate in (0.0, 1.0):
            assert sum(pattern[1]) == 64 * rate
        else:
            assert 0 < sum(pattern[1]) < 64

    def test_audited_verdicts_equal_an_unaudited_service(self):
        svc = VerdictService(*mk_cluster(10), [], device="cpu", audit=mk_audit())
        twin = VerdictService(*mk_cluster(10), [], device="cpu")
        keys = list(svc.pods)
        rng = random.Random(5)
        qs = [FlowQuery(src=rng.choice(keys), dst=rng.choice(keys), port=80, protocol="TCP")
              for _ in range(12)]
        assert [(v.ingress, v.egress, v.combined, v.error) for v in svc.query(qs)] == [
            (v.ingress, v.egress, v.combined, v.error) for v in twin.query(qs)]
        svc.audit.drain()
        assert svc.audit.snapshot()["diverged"] == 0

    def test_state_carries_the_audit_block(self):
        assert VerdictService(*mk_cluster(6), [], device="cpu").state()["audit"] == {
            "enabled": False}
        svc = VerdictService(*mk_cluster(6), [], device="cpu", audit=mk_audit())
        block = svc.state()["audit"]
        assert block["enabled"] is True and block["rate"] == 1.0
        assert block == svc.audit_snapshot()

    def test_env_arms_the_audit_plane(self, monkeypatch):
        monkeypatch.setenv("CYCLONUS_AUDIT", "1")
        monkeypatch.setenv("CYCLONUS_AUDIT_RATE", "0.25")
        svc = VerdictService(*mk_cluster(6), [], device="cpu")
        try:
            assert isinstance(svc.audit, AuditController) and svc.audit.rate == 0.25
        finally:
            svc.audit.close()


def corrupt_bundle(pkg, tmp_path, monkeypatch):
    """One armed `verdict_corrupt` through a package's audited service:
    the divergence dump's repro bundle and the divergence count."""
    dump = tmp_path / f"{pkg}-audit.json"
    monkeypatch.setenv("CYCLONUS_FLIGHT_RECORDER_PATH", str(dump))
    pods, namespaces = mk_cluster(10)
    if pkg == "ref":
        ref_telemetry.reset()
        svc = RefService(pods, namespaces, [], audit=mk_audit(ref_audit))
        cls, ch, inst = RefQuery, ref_chaos, ref_ti
    else:
        port_telemetry.reset()
        svc = VerdictService(pods, namespaces, [], device="cpu", audit=mk_audit())
        cls, ch, inst = FlowQuery, chaos, ti
    keys = list(svc.pods)
    token = ch.reset("verdict_corrupt:1")
    try:
        out = svc.query([cls(src=keys[i], dst=keys[i + 1], port=80, protocol="TCP",
                             port_name="serve-80-tcp") for i in range(4)])
    finally:
        ch.disarm(token)
    assert all(not v.error for v in out)
    svc.audit.drain()
    dumped = json.loads(dump.read_text())
    bundles = [e for e in dumped["entries"] if e.get("path") == "audit.divergence"]
    assert dumped["reason"] == "audit-divergence" and len(bundles) == 1
    b = {k: v for k, v in bundles[0].items() if k not in ("seq", "at")}
    b["digest"] = b["digest"] and b["digest"]["digest"]
    return b, inst.AUDIT_DIVERGED.value(), svc.audit.snapshot()["last_divergence"]


class TestDivergenceBlackBox:
    def test_verdict_corrupt_detected_with_the_reference_bundle(self, tmp_path, monkeypatch):
        want, want_n, want_last = corrupt_bundle("ref", tmp_path, monkeypatch)
        got, got_n, got_last = corrupt_bundle("port", tmp_path, monkeypatch)
        assert got == want
        assert got_n == want_n == 1 and got_last == want_last
        assert set(got) >= {"epoch", "query", "served", "oracle", "route", "config", "state",
                            "digest"}
        assert got["served"] == [not o for o in got["oracle"]]
        assert got["route"] == "serve.query.live" and got["state"]["pods"]
        assert ti.CHAOS_INJECTIONS.value(point="verdict_corrupt") == 1

    def test_divergence_burns_verdict_integrity(self):
        ctl = SloController(enforce=False)
        hist = {"buckets": [0.05], "samples": [{"count": 1, "counts": [1]}]}
        ctl.tick(latency_snapshot=hist, now=0.0)
        ti.AUDIT_CHECKED.inc(10)
        ti.AUDIT_DIVERGED.inc(2)
        ctl.tick(latency_snapshot=hist, now=1.0)
        obj = ctl.snapshot()["objectives"]["verdict_integrity"]
        assert obj["burn"]["fast"] > 0.0 and obj["budget_remaining"] < 1.0


def note_epoch(aud, epoch, pods, namespaces, policy):
    aud.note_epoch(epoch, pods=dict(pods), namespaces=dict(namespaces), netpols={}, anps={},
                   banp=None, policy=policy, tiers=None)


def drops(module, build, queue_cap, epoch_ring, script):
    """Run a script of ("epoch", n) / ("offer", epoch) / ("drain",) steps
    on a package's controller; returns the accept pattern and the drop,
    check and digest counts."""
    tel, inst = (ref_telemetry, ref_ti) if module is ref_audit else (port_telemetry, ti)
    tel.reset()
    pods_list, namespaces = mk_cluster(8)
    pods = {f"{p[0]}/{p[1]}": p for p in pods_list}
    policy = build(True, [])
    aud = mk_audit(module, queue_cap=queue_cap, epoch_ring=epoch_ring)
    accepted = []
    for i, step in enumerate(script):
        if step[0] == "epoch":
            note_epoch(aud, step[1], pods, namespaces, policy)
        elif step[0] == "offer":
            q = {"src": f"x/p{(2 * i) % 8}", "dst": f"y/p{(2 * i + 1) % 8}", "port": 80,
                 "port_name": "serve-80-tcp", "protocol": "TCP"}
            accepted.append(aud.offer(q, (True, True, True), "r", step[1]))
        else:
            aud.drain()
    return (accepted, inst.AUDIT_DROPPED.value(reason="overflow"),
            inst.AUDIT_DROPPED.value(reason="epoch_evicted"), inst.AUDIT_CHECKED.value(),
            sorted(aud.digests()), aud.snapshot()["dropped"])


DROP_SCRIPTS = {
    "overflow": (2, 8, [("epoch", 0)] + [("offer", 0)] * 5 + [("drain",)]),
    "eviction": (16, 1, [("epoch", 0), ("offer", 0), ("offer", 0), ("epoch", 1),
                         ("offer", 0), ("drain",)]),
    "mixed": (3, 2, [("epoch", 0), ("offer", 0), ("epoch", 1), ("offer", 1), ("offer", 0),
                     ("offer", 1), ("offer", 1), ("epoch", 2), ("drain",), ("offer", 2),
                     ("drain",)]),
}


class TestDropAccounting:
    @pytest.mark.parametrize("name", sorted(DROP_SCRIPTS))
    def test_drops_equal_reference(self, name):
        cap, ring, script = DROP_SCRIPTS[name]
        want = drops(ref_audit, ref_build, cap, ring, script)
        got = drops(port_audit, build_network_policies, cap, ring, script)
        assert got == want

    def test_overflow_and_eviction_counts(self):
        accepted, overflow, evicted, checked, digests, _ = drops(
            port_audit, build_network_policies, *DROP_SCRIPTS["overflow"])
        assert accepted == [True, True, False, False, False]
        assert (overflow, evicted, checked) == (3, 0, 2)
        accepted, overflow, evicted, checked, digests, _ = drops(
            port_audit, build_network_policies, *DROP_SCRIPTS["eviction"])
        assert (overflow, evicted, checked, digests) == (0, 3, 0, [1])


class TestDisabledPath:
    def test_off_by_default_and_no_audit_method_runs(self, monkeypatch):
        """With auditing off, _audit is None and neither the query paths
        (live, degraded, shed) nor an apply call any audit method."""
        monkeypatch.delenv("CYCLONUS_AUDIT", raising=False)

        def boom(*_a, **_k):
            raise AssertionError("an audit method ran with auditing off")

        for name in ("sample", "offer", "note_epoch", "drain", "snapshot"):
            monkeypatch.setattr(sampler_mod.AuditController, name, boom)
        monkeypatch.setattr(VerdictService, "_offer_audit", boom)
        monkeypatch.setattr(VerdictService, "_note_epoch_locked", boom)
        svc = VerdictService(*mk_cluster(8), [], device="cpu",
                             slo=SloController(enforce=True))
        assert svc.audit is None and svc._audit is None
        keys = list(svc.pods)
        qs = [FlowQuery(src=keys[0], dst=keys[1], port=80, protocol="TCP")]
        svc.query(qs)
        ns, name = keys[2].split("/")
        svc.apply([Delta(kind="pod_labels", namespace=ns, name=name, labels={"app": "q"})])
        for state in ("burning", "exhausted"):
            svc.slo.force_state("query_p99", state)
            svc.query(qs)
        assert svc.audit_snapshot() == {"enabled": False}
        assert svc.state()["audit"] == {"enabled": False}


def get_json(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


class TestAuditHttpRoute:
    def test_audit_route_200_with_a_service_and_503_without(self):
        tserver.register_audit(None)
        srv = tserver.start_metrics_server(0)
        try:
            status, body = get_json(srv.url + "/audit")
            assert status == 503 and "no audit provider" in body["error"]
            svc = VerdictService(*mk_cluster(8), [], device="cpu", audit=mk_audit())
            keys = list(svc.pods)
            svc.query([FlowQuery(src=keys[0], dst=keys[1], port=80, protocol="TCP")])
            svc.audit.drain()
            register_http(svc)
            status, body = get_json(srv.url + "/audit")
            assert status == 200 and body == json.loads(json.dumps(svc.audit_snapshot()))
            assert body["enabled"] is True and "0" in body["digests"] and body["checked"] >= 1
        finally:
            for route in ("/state", "/query"):
                tserver.unregister_route(route)
            tserver.register_slo(None)
            tserver.register_audit(None)
            tserver.stop_metrics_server()

    def test_broken_provider_answers_500(self):
        def boom():
            raise RuntimeError("auditor exploded")

        tserver.register_audit(boom)
        srv = tserver.start_metrics_server(0)
        try:
            status, body = get_json(srv.url + "/audit")
            assert status == 500 and "auditor exploded" in body["error"]
        finally:
            tserver.register_audit(None)
            tserver.stop_metrics_server()
