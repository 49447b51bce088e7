"""The np-100k-egress configuration's parts on the CPU: the frozen
allowlist generator (reference/allowlists.py) at the configuration's own
size, the cluster generator that adds it (clusters/egress.py), and the
ip_peers_ms reader on a made-up span trace."""

import json
import random

import pytest

from portbench import harness
from portbench.reference import allowlists, synthetic
from portbench.trace import DeviceTrace

CONFIG = harness.ROOT / "portbench" / "configs" / "np-100k-egress.json"


def blocks_of(policy):
    (rule,) = policy["spec"]["egress"]
    assert "ports" not in rule
    return [(p["ipBlock"]["cidr"], tuple(p["ipBlock"].get("except", ()))) for p in rule["to"]]


@pytest.fixture(scope="module")
def full():
    config = json.loads(CONFIG.read_text())
    rng = random.Random(config["cluster_seed"])
    pods, namespaces, _policies = synthetic.build_synthetic(
        config["n_pods"], 0, rng, config["n_namespaces"])
    shape = config["allowlists"]
    return config, pods, namespaces, allowlists.allowlists(
        pods, namespaces, random.Random(1), shape["blocks_per_policy"], shape["tier_values"])


def test_allowlists_give_100k_distinct_blocks_50_a_policy(full):
    config, _pods, namespaces, pols = full
    assert len(pols) == 2000 == len(namespaces) * 5
    per = [blocks_of(p) for p in pols]
    assert all(len(b) == 50 for b in per)
    flat = [b for bs in per for b in bs]
    assert len(set(flat)) == len(flat) == 100000
    # one per (namespace, tier), each selecting its tier, egress only
    keys = {(p["metadata"]["namespace"], p["spec"]["podSelector"]["matchLabels"]["tier"])
            for p in pols}
    assert len(keys) == 2000
    assert all(p["spec"]["policyTypes"] == ["Egress"] for p in pols)
    # every family is there; the /16s carry one /24 except inside them
    prefixes = {c.split("/")[1] for c, _e in flat}
    assert prefixes == {"32", "24", "16", "15", "14", "12"}
    for c, e in flat:
        if c.endswith("/16"):
            assert len(e) == 1 and e[0].startswith(c.rsplit(".", 2)[0] + ".")
        else:
            assert not e


def test_allowlists_are_a_function_of_the_seed(full):
    _config, pods, namespaces, pols = full
    small = pods[:3000]
    a = allowlists.allowlists(small, namespaces, random.Random(9), 4)
    b = allowlists.allowlists(small, namespaces, random.Random(9), 4)
    c = allowlists.allowlists(small, namespaces, random.Random(10), 4)
    assert a == b and a != c
    # the splinters land on the pods' own /24s
    pool24 = {p[3].rsplit(".", 1)[0] for p in small}
    assert any(cidr.rsplit(".", 1)[0] in pool24 and cidr.endswith("/32")
               for p in a for cidr, _e in blocks_of(p))


def test_cluster_adds_the_allowlists_to_the_synthetic_cluster():
    config = json.loads(CONFIG.read_text())
    config.update(n_pods=600, n_policies=40, n_namespaces=None)
    module = harness.load_module(harness.ROOT, "clusters", config["generator"])
    inputs = module.build(config, 1)
    assert inputs["anps"] == [] and inputs["banp"] is None
    pods, namespaces, base = synthetic.build_synthetic(
        600, 40, random.Random(config["cluster_seed"]), None)
    assert inputs["pods"] == pods and inputs["policies"][:40] == base
    assert len(inputs["policies"]) == 40 + 5 * len(namespaces)
    assert inputs == module.build(config, 2)  # the cluster seed, not the run's


def _run(host, ranges):
    return harness.Run(steps=[], events=[], window_s=10.0, setup_s=1.0,
                       trace=DeviceTrace([], {"portbench.window": [(0.0, 10.0)], **ranges}, host))


def test_ip_peers_ms_reads_a_span_trace():
    read = harness.load_reader(harness.ROOT, "ip_peers_ms")
    host = [("engine.pre_patch", 1.0, 1.1), ("engine.ip_peers", 1.01, 1.03),
            ("engine.ip_peers", 1.05, 1.06), ("aten::mm", 1.06, 1.07),
            ("engine.precompute", 2.0, 2.5), ("engine.ip_peers", 2.1, 2.4),
            ("engine.ip_peers", 7.0, 8.0)]  # outside every recount
    ranges = {"portbench.recount": [(0.9, 1.2), (1.9, 2.6), (3.0, 3.1), (4.0, 4.1)]}
    assert read(_run(host, ranges)) == pytest.approx((30 + 300) / 4)
    # a program without the span, and a run without a trace
    assert read(_run([("engine.pre_patch", 1.0, 1.1)], ranges)) is None
    assert read(harness.Run(steps=[], events=[], window_s=1.0, setup_s=1.0, trace=None)) is None
