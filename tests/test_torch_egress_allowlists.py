"""The dense precompute's ip leg (engine/tiled.py _direction_tallow) on the
CPU: ipBlock peer rows resolved through the CIDR tuple-space partition
(cidrspace.ip_leg, kernel.ip_atom_table, kernel.ip_partition_words) and,
for rows with excepts or host-evaluated rows, row by row in blocks.

Held here:
  * the new leg's tallow_pk equals the per-row formula's (the leg it
    replaces: direction_precompute over every peer row, apply_host_ip,
    the one-hot product, the packing), word for word, per direction and
    case: every allowlist family, excepts (one equal to its CIDR), nested
    and overlapping prefixes, /0 and /32, pods at 0.0.0.0 and
    255.255.255.255 and pods with no IPv4 address, bucket padding, a pin
    patch's pod columns, small block and chunk budgets, and the dense
    plan's tallow_bf;
  * the verdict service on a 2,048-pod, 8-namespace cluster with 40
    allowlists of 50 blocks counts what the benchmark's plain reference
    (portbench/reference/netpol.py) counts: at build, after pod-label and
    remove-then-add batches (the pin patch) and after a policy upsert
    (the whole precompute, the ip legs rebuilt);
  * the patch's operation count does not grow with the number of
    partitions.

The `cuda` twin is tests/test_torch_egress_allowlists_cuda.py.
"""

import random

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine, tiled
from cyclonus_tpu_torch.engine import kernel as K
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.matcher import build_network_policies
from cyclonus_tpu_torch.serve import VerdictService
from cyclonus_tpu_torch.worker.model import Delta

from portbench.reference import allowlists, netpol, synthetic

CASES = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]
CASE_TUPLES = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP")]


def old_tallow_pk(tensors):
    """{direction: [W, N, Q] int32} by the per-row formula over every peer
    row: the ip leg the partition replaces."""
    selpod, selns = K.selector_tables(tensors)
    out = {}
    q = tensors["q_port"].shape[0]
    for d in ("ingress", "egress"):
        enc = tensors[d]
        pre = K.direction_precompute(enc, selpod, selns, tensors["pod_ns_id"],
                                     tensors["pod_ip"], tensors["pod_ip_valid"])
        match = K.apply_host_ip(enc, pre["peer_match"])
        pport = K.port_spec_allows(enc["port_spec"], tensors["q_port"], tensors["q_name"],
                                   tensors["q_proto"])
        n_p, n = match.shape
        allow = (match[:, :, None] & pport[:, None, :]).reshape(n_p, n * q)
        tallow = K._bool_matmul(K.m_tp_onehot(enc), allow)
        out[d] = K.pack_bool_words_torch(tallow.reshape(tallow.shape[0], n, q))
    return out


def ip_peer(cidr, excepts=()):
    blk = {"cidr": cidr}
    if excepts:
        blk["except"] = list(excepts)
    return {"ipBlock": blk}


def policy(name, ns, peers, types=("Egress",), ports=None, selector=None):
    rule = {"ports": ports} if ports else {}
    spec = {"podSelector": {"matchLabels": selector or {}}, "policyTypes": list(types)}
    if "Egress" in types:
        spec["egress"] = [{**rule, "to": peers}]
    if "Ingress" in types:
        spec["ingress"] = [{**rule, "from": peers}]
    return {"apiVersion": "networking.k8s.io/v1", "kind": "NetworkPolicy",
            "metadata": {"name": name, "namespace": ns}, "spec": spec}


def edge_cluster(seed=5):
    """A small cluster and a policy set with every shape the leg meets."""
    rng = random.Random(seed)
    pods, namespaces, policies = synthetic.build_synthetic(300, 24, rng, 3)
    edge_ips = ["0.0.0.0", "255.255.255.255", "fd00::7", "10.0.1.7", "10.0.1.255"]
    for i, ip in enumerate(edge_ips):
        pods.append(("ns0", f"edge-{i}", {"app": "app1", "tier": f"tier{i % 5}"}, ip))
    policies += allowlists.allowlists(pods, namespaces, rng, per_policy=12)
    udp = [{"protocol": "UDP", "port": "serve-81-udp"}]
    tcp = [{"protocol": "TCP", "port": 80}]
    nested = [ip_peer("10.0.0.0/8"), ip_peer("10.0.0.0/16"), ip_peer("10.0.1.0/24"),
              ip_peer("10.0.1.7/32")]
    policies += [
        policy("nested", "ns0", nested, types=("Ingress", "Egress")),
        policy("nested-udp", "ns1", nested[1:] + [ip_peer("10.0.0.0/17")], ports=udp,
               selector={"tier": "tier1"}),
        policy("overlap-tcp", "ns0", [ip_peer("10.0.0.0/15"), ip_peer("10.0.1.0/24")],
               ports=tcp, selector={"tier": "tier0"}),
        policy("everything", "ns2", [ip_peer("0.0.0.0/0")], ports=tcp),
        policy("edges", "ns1", [ip_peer("255.255.255.255/32"), ip_peer("0.0.0.0/32"),
                                ip_peer("0.0.0.0/0", ["10.0.0.0/8"])], types=("Ingress",)),
        policy("self-except", "ns0", [ip_peer("10.0.1.0/24", ["10.0.1.0/24"]),
                                      ip_peer("10.0.0.0/16", ["10.0.1.0/24", "10.0.0.0/30"])],
               selector={"tier": "tier2"}),
        policy("v6", "ns2", [ip_peer("fd00::/64"), ip_peer("10.0.0.0/24")], types=("Ingress",)),
        policy("wide-ports", "ns1", [ip_peer("10.0.0.0/12")], ports=tcp + udp,
               selector={"tier": "tier3"}),
    ]
    return pods, namespaces, policies


def engine(pods, namespaces, policies):
    policy_set = build_network_policies(True, [parse_policy_dict(p) for p in policies])
    return TorchPolicyEngine(policy_set, pods, namespaces, device="cpu", compact=False)


@pytest.fixture(scope="module")
def edge_engine():
    return engine(*edge_cluster())


def assert_equal_words(new, old):
    for d in ("ingress", "egress"):
        assert new[d]["tallow_pk"].dtype == torch.int32
        assert torch.equal(new[d]["tallow_pk"], old[d]), d


def test_leg_covers_every_group(edge_engine):
    legs = edge_engine._ip_legs_for()
    eg, ig = legs["egress"], legs["ingress"]
    assert eg["n_part"] and eg["n_block"] and ig["n_part"] and ig["n_block"]
    # /0, /8 .. /32 among the partitions, ancestors found across them
    assert eg["n_partitions"] >= 6
    assert bool((eg["anc"] >= 0).any())
    assert int(edge_engine._tensors["pod_ns_id"].shape[0]) > 305  # bucket padding
    assert "host_ip_mask" in edge_engine._tensors["ingress"]


def test_whole_precompute_equals_the_per_row_formula(edge_engine):
    t = edge_engine._dense_counts_tensors(CASES)
    new = tiled._precompute(t, True, edge_engine._ip_legs_for())
    assert_equal_words(new, old_tallow_pk(t))
    # the legs the engine keeps equal those built from the tensors alone
    assert_equal_words(tiled._precompute(t, True), old_tallow_pk(t))


def test_dense_plan_equals_the_per_row_formula(edge_engine):
    t = edge_engine._dense_counts_tensors(CASES)
    new = tiled._precompute(t, False, edge_engine._ip_legs_for())
    old = old_tallow_pk(t)
    for d in ("ingress", "egress"):
        assert torch.equal(K.pack_bool_words_torch(new[d]["tallow_bf"] > 0), old[d])


@pytest.mark.parametrize("budget", [1 << 12, 1 << 16])
def test_small_blocks_and_chunks_change_nothing(edge_engine, monkeypatch, budget):
    monkeypatch.setattr(tiled, "IP_BLOCK_BYTES", budget)
    t = edge_engine._dense_counts_tensors(CASES)
    assert_equal_words(tiled._precompute(t, True, edge_engine._ip_legs_for()), old_tallow_pk(t))


def test_patch_columns_equal_the_per_row_formula(edge_engine):
    n = edge_engine.n_pods
    idx = torch.tensor([0, 3, n - 5, n - 4, n - 3, n - 1, n + 2], dtype=torch.long)
    t = edge_engine._dense_counts_tensors(CASES, idx)
    assert_equal_words(tiled._precompute(t, True, edge_engine._ip_legs_for()), old_tallow_pk(t))


# --- the verdict service against the plain reference -------------------------


def service_cluster(seed=23):
    rng = random.Random(seed)
    pods, namespaces, policies = synthetic.build_synthetic(2048, 24, rng, 8)
    policies += allowlists.allowlists(pods, namespaces, rng, per_policy=50)
    return pods, namespaces, policies


def pod_batch(state, rng, n=3):
    """n label changes and one remove-then-add, as the churn mix sends."""
    out = []
    for ns, name, labels, _ip in rng.sample(sorted(state.values()), n):
        out.append(Delta(kind="pod_labels", namespace=ns, name=name,
                         labels={**labels, "tier": f"tier{rng.randrange(5)}"}))
    ns, name, labels, ip = state[sorted(state)[rng.randrange(len(state))]]
    out.append(Delta(kind="pod_remove", namespace=ns, name=name))
    out.append(Delta(kind="pod_add", namespace=ns, name=name, labels=labels, ip=ip))
    return out


def fold(state, deltas):
    for d in deltas:
        key = f"{d.namespace}/{d.name}"
        if d.kind == "pod_remove":
            del state[key]
        elif d.kind == "pod_add":
            state[key] = (d.namespace, d.name, dict(d.labels), d.ip)
        elif d.kind == "pod_labels":
            state[key] = (d.namespace, d.name, dict(d.labels), state[key][3])


def test_service_counts_equal_the_reference():
    pods, namespaces, policies = service_cluster()
    assert sum(1 for p in policies if p["metadata"]["name"].startswith("egress-allow")) == 40
    svc = VerdictService(pods, namespaces, [parse_policy_dict(p) for p in policies],
                         device="cpu")
    state = {f"{p[0]}/{p[1]}": p for p in pods}
    ps = netpol.PolicySet(policies)

    def check():
        got = svc.engine.evaluate_grid_counts(CASES)
        want = netpol.grid_counts(state.values(), namespaces, policies, CASE_TUPLES,
                                  policy_set=ps)
        assert got == want

    check()
    check()  # split: the pin
    legs = svc.engine._ip_legs
    assert legs is not None and legs["egress"]["n_part"] > 1500
    rng = random.Random(7)
    for _ in range(2):
        batch = pod_batch(state, rng)
        assert svc.apply(batch)["mode"] == "incremental"
        fold(state, batch)
        check()
        assert svc.engine._last_counts_mode == "steady"
        assert svc.engine._ip_legs is legs  # pod rows alone keep the legs
    # an allowlist upserted with new blocks: the whole precompute, new legs
    ns, tier = "ns3", "tier2"
    blocks = [ip_peer("10.0.9.0/24"), ip_peer("10.0.0.0/16", ["10.0.2.0/24"]),
              ip_peer("10.0.4.17/32"), ip_peer("10.0.0.0/13")]
    upsert = policy(f"egress-allow-{tier}", ns, blocks, selector={"tier": tier})
    report = svc.apply([Delta(kind="policy_upsert", namespace=ns, name=upsert["metadata"]["name"],
                              policy=upsert)])
    assert not report.get("rejected")
    policies = [upsert if (p["metadata"]["namespace"], p["metadata"]["name"])
                == (ns, upsert["metadata"]["name"]) else p for p in policies]
    ps = netpol.PolicySet(policies)
    assert svc.engine._ip_legs is None or svc.engine._ip_legs is not legs
    check()
    assert svc.engine._last_counts_mode == "fused"


# --- the patch's operations do not grow with the partitions ------------------


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def patch_ops(prefixes):
    """Operations of one pin patch (a label change) of a service whose
    64 /prefix allowlist blocks fall into len(set(prefixes)) partitions."""
    rng = random.Random(1)
    pods, namespaces, policies = synthetic.build_synthetic(256, 8, rng, 2)
    peers = [ip_peer(f"10.{i % 4}.{i}.0/{prefixes[i % len(prefixes)]}".replace(".0/32", ".1/32"))
             for i in range(64)]
    policies.append(policy("allow", "ns0", peers, selector={"tier": "tier1"}))
    svc = VerdictService(pods, namespaces, [parse_policy_dict(p) for p in policies], device="cpu")
    svc.engine.evaluate_grid_counts(CASES)
    svc.engine.evaluate_grid_counts(CASES)
    ns, name, labels, _ip = pods[5]
    svc.apply([Delta(kind="pod_labels", namespace=ns, name=name, labels={**labels, "tier": "tier1"})])
    eng = svc.engine
    assert eng._pre_cache_dirty
    with OpCount() as count:
        eng._patch_pin(CASES)
    assert eng._ip_legs["egress"]["n_partitions"] == len(set(prefixes))
    return count.n


def test_patch_operations_flat_in_partitions():
    one = patch_ops([24])
    many = patch_ops([24, 25, 26, 27, 28, 29, 30, 31])
    assert one == many
