"""The TSS/LPM CIDR class signature of the port (cyclonus_tpu_torch/
engine/cidrspace.py, kernel.lpm_partition_signature) against the
reference's (cyclonus_tpu/engine/cidrspace.py), on the CPU, class by
class as tests/test_engine_cidr.py: partitions, the signature twins (the
port's torch LPM, its numpy twin, the reference's numpy twin and its JAX
program), invalid IPs and the pad tie, v6 routing, the CIDR fuzz family,
gating, and the serve deltas.  Above the 256-spec floor the port's
classes, class ids, class stats, cidr stats and partition map must equal
the reference's.  Every value is boolean or integer: the tolerance is
zero."""

import random

import numpy as np
import pytest
import torch

from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.engine import cidrspace as ref_cidrspace
from cyclonus_tpu.engine.encoding import pod_signatures as ref_pod_signatures
from cyclonus_tpu.engine.kernel import lpm_partition_signature as ref_lpm
from cyclonus_tpu.kube.netpol import IPBlock
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu.tiers import fuzz as ref_fuzz
from cyclonus_tpu_torch import carry
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.engine import cidrspace
from cyclonus_tpu_torch.engine.encoding import (
    _mask_for_prefix,
    pack_bool_words,
    pod_signatures,
)
from cyclonus_tpu_torch.engine.kernel import lpm_partition_signature
from cyclonus_tpu_torch.oracle import oracle_grid
from cyclonus_tpu_torch.tiers import fuzz

from test_engine_cidr import mk_cluster, mk_np
from test_torch_engine import assert_tree_equal, port_policy
from test_torch_serve import Twin

CASE_TUPLES = [(80, "serve-80-tcp", "TCP"), (81, "serve-81-udp", "UDP")]
REF_CASES = [RefPortCase(*c) for c in CASE_TUPLES]
CASES = [PortCase(*c) for c in CASE_TUPLES]

#: the CidrSpace fields that must equal the reference's leaf by leaf
SPACE_ARRAYS = ("atom_base", "atom_mask", "atom_part", "pmask", "pprefix", "pbases", "pindex")
#: cidr_stats keys that read a clock (the port adds classify_s)
TIMING = ("lpm_s", "classify_s")


def build_pair(blocks, ips, **kw):
    """(reference engine, port engine, port policy, pods, namespaces)
    over one policy of `blocks` and pods at `ips`."""
    pods, namespaces = mk_cluster(ips)
    pols = [mk_np("np0", "x", blocks)]
    ref = TpuPolicyEngine(ref_build(True, pols), pods, namespaces, **kw)
    policy = port_policy(pols)
    port = TorchPolicyEngine(policy, pods, namespaces, device="cpu", **kw)
    return ref, port, policy, pods, namespaces


def space_of(engine):
    st = engine._class_state
    return st.get("cidr") if st is not None else None


def assert_space_equal(ref, port):
    assert (ref is None) == (port is None)
    if ref is None:
        return
    for k in ("n_specs", "n_atoms", "n_host_rows", "spec_atoms"):
        assert getattr(ref, k) == getattr(port, k), k
    for k in SPACE_ARRAYS:
        a, b = getattr(ref, k), getattr(port, k)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def stats_without_timing(stats):
    return {k: v for k, v in stats.items() if k not in TIMING}


def table(grid):
    return np.stack(
        [np.swapaxes(np.asarray(grid.ingress), 1, 2), np.asarray(grid.egress),
         np.asarray(grid.combined)],
        axis=-1,
    )


def heavy_blocks(seed, n=320):
    """A CIDR-heavy block set above the 256-spec floor: /32 splinters,
    /24s, and /16s with /24 excepts whose except-only atoms split pods
    the per-spec bits keep together."""
    rng = random.Random(seed)
    seen, blocks = set(), []
    while len(blocks) < n:
        roll = rng.random()
        if roll < 0.4:
            cidr, ex = f"10.{rng.randrange(4)}.{rng.randrange(4)}.{rng.randrange(256)}/32", ()
        elif roll < 0.8:
            cidr, ex = f"10.{rng.randrange(4)}.{rng.randrange(64)}.0/24", ()
        else:
            b2 = rng.randrange(4)
            cidr = f"10.{b2}.0.0/16"
            ex = (f"10.{b2}.{rng.randrange(4)}.0/24", f"10.{b2}.{rng.randrange(4, 8)}.0/24")
        if (cidr, ex) not in seen:
            seen.add((cidr, ex))
            blocks.append(IPBlock.make(cidr, list(ex)))
    ips = [f"10.{rng.randrange(4)}.{rng.randrange(8)}.{rng.randrange(256)}" for _ in range(48)]
    return blocks, ips + ["fd00::7", "11.0.0.1"]


class TestPartitions:
    def test_mask_for_prefix_boundaries(self):
        assert _mask_for_prefix(0) == 0
        assert _mask_for_prefix(32) == 0xFFFFFFFF
        assert _mask_for_prefix(31) == 0xFFFFFFFE
        assert _mask_for_prefix(8) == 0xFF000000

    @pytest.mark.parametrize("n", [1, 127, 128, 129, 1000])
    def test_lane_round_up_equals_reference(self, n):
        from cyclonus_tpu.engine.pallas_kernel import lane_round_up

        assert cidrspace.lane_round_up(n) == lane_round_up(n)

    def test_partitions_lpm_order_and_dedup(self):
        blocks = [
            IPBlock.make("10.0.0.0/8", ["10.0.1.0/24"]),
            IPBlock.make("10.0.1.0/24", []),
            IPBlock.make("0.0.0.0/0", []),
            IPBlock.make("10.0.1.7/32", []),
        ]
        ref, port, *_ = build_pair(blocks, ["10.0.1.1"], class_compress="1", cidr_tss="1")
        space = space_of(port)
        assert list(space.pprefix) == [32, 24, 8, 0]
        assert space.n_atoms == 4 and space.n_specs == 4
        assert_space_equal(space_of(ref), space)
        assert space.structure() == space_of(ref).structure()
        assert cidrspace.mask_structure(space) == ref_cidrspace.mask_structure(space_of(ref))
        assert cidrspace.mask_structure(None) is None

    def test_annihilation_and_full_cover(self):
        blocks = [
            IPBlock.make("10.0.1.0/24", ["10.0.1.0/24"]),
            IPBlock.make("0.0.0.0/0", []),
        ]
        ref, port, *_ = build_pair(
            blocks, ["10.0.1.9", "9.9.9.9"], class_compress="1", cidr_tss="1"
        )
        space = space_of(port)
        t = port._tensors
        ip, valid = t["pod_ip"][:2], t["pod_ip_valid"][:2]
        sig = space.signature_host(ip, valid)
        dense = cidrspace.dense_spec_membership(space, ip, valid)
        ann = [s for s, (p, exs) in enumerate(space.spec_atoms) if exs and p in exs]
        full = [s for s, (p, exs) in enumerate(space.spec_atoms)
                if not exs and space.atom_mask[p] == 0]
        assert ann and full
        assert not dense[ann[0]].any() and dense[full[0]].all()
        words = cidrspace.spec_membership_words(space, sig)
        assert np.array_equal(words, pack_bool_words(dense, axis=0))
        rs = space_of(ref)
        assert np.array_equal(words, ref_cidrspace.spec_membership_words(rs, sig))
        assert np.array_equal(dense, ref_cidrspace.dense_spec_membership(rs, ip, valid))


class TestSignatureTwins:
    def _random_pair(self, seed):
        rng = random.Random(seed)
        blocks = []
        for _ in range(rng.randint(4, 10)):
            p = rng.choice((0, 8, 12, 16, 24, 31, 32, 32))
            base = (f"{rng.randrange(256)}.{rng.randrange(256)}"
                    f".{rng.randrange(256)}.{rng.randrange(256)}")
            exs = []
            if p <= 24 and rng.random() < 0.5:
                exs = [f"{base.rsplit('.', 1)[0]}.0/{rng.choice((31, 32))}"]
            blocks.append(IPBlock.make(f"{base}/{p}", exs))
        ips = ["0.0.0.0", "255.255.255.255"] + [
            f"{rng.randrange(256)}.{rng.randrange(256)}"
            f".{rng.randrange(256)}.{rng.randrange(256)}"
            for _ in range(10)
        ] + ["fd00::1"]
        ref, port, *_ = build_pair(blocks, ips, class_compress="1", cidr_tss="1")
        return ref, port

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    def test_host_device_bit_identity(self, seed):
        """The port's torch LPM (on the CPU), its numpy twin, the
        reference's numpy twin and the reference's JAX program agree."""
        ref, port = self._random_pair(seed)
        space, rspace = space_of(port), space_of(ref)
        assert space is not None
        assert_space_equal(rspace, space)
        n = port.n_pods
        ip, valid = port._tensors["pod_ip"][:n], port._tensors["pod_ip_valid"][:n]
        host = space.signature_host(ip, valid)
        dev = space.signature(ip, valid, device=True)
        assert space.last_device is True
        assert host.dtype == np.int32 and dev.dtype == np.int32
        assert np.array_equal(host, dev)
        assert np.array_equal(host, rspace.signature_host(ip, valid))
        assert np.array_equal(host, np.asarray(ref_lpm(ip, valid, rspace.pmask, rspace.pbases,
                                                       rspace.pindex)))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_signature_reproduces_dense_membership(self, seed):
        _ref, port = self._random_pair(seed)
        space = space_of(port)
        n = port.n_pods
        ip, valid = port._tensors["pod_ip"][:n], port._tensors["pod_ip_valid"][:n]
        sig = space.signature_host(ip, valid)
        dense = cidrspace.dense_spec_membership(space, ip, valid)
        assert np.array_equal(
            cidrspace.spec_membership_words(space, sig), pack_bool_words(dense, axis=0)
        )

    def test_invalid_ip_signs_minus_one(self):
        _ref, port = self._random_pair(0)
        space = space_of(port)
        ip, valid = np.array([0], dtype=np.uint32), np.array([False])
        assert (space.signature_host(ip, valid) == -1).all()
        assert (space.signature(ip, valid, device=True) == -1).all()

    def test_max_base_vs_pad_tie(self):
        """A real 255.255.255.255/32 base ties the 0xFFFFFFFF bucket pad
        after the widening to int64; the leftmost search still resolves
        it and the -1 pindex still rejects the pads."""
        ref, port, *_ = build_pair(
            [IPBlock.make("255.255.255.255/32", [])],
            ["255.255.255.255", "255.255.255.254"],
            class_compress="1", cidr_tss="1",
        )
        space = space_of(port)
        ip = np.array([0xFFFFFFFF, 0xFFFFFFFE], dtype=np.uint32)
        valid = np.array([True, True])
        sig = space.signature_host(ip, valid)
        assert sig[0, 0] >= 0 and sig[0, 1] == -1
        dev = lpm_partition_signature(
            *(carry.to_torch(a, "cpu") for a in (ip, valid, space.pmask, space.pbases,
                                                 space.pindex))
        )
        assert dev.dtype == torch.int32
        assert np.array_equal(dev.numpy(), sig)
        assert np.array_equal(sig, space_of(ref).signature_host(ip, valid))

    def test_empty_pod_axis(self):
        _ref, port = self._random_pair(1)
        space = space_of(port)
        ip, valid = np.zeros((0,), np.uint32), np.zeros((0,), bool)
        for device in (False, True):
            sig = space.signature(ip, valid, device=device)
            assert sig.shape == (space.n_partitions, 0) and sig.dtype == np.int32


class TestHostRowRouting:
    def test_v6_rows_never_reach_the_trie(self):
        blocks = [
            IPBlock.make("fd00::/64", []),
            IPBlock.make("10.0.0.0/16", ["fd00::/96"]),
            IPBlock.make("10.0.1.0/24", []),
        ]
        ref, port, policy, pods, namespaces = build_pair(
            blocks, ["10.0.1.5", "10.0.2.5", "fd00::5"], class_compress="1", cidr_tss="1"
        )
        assert len(port.encoding.ingress.host_ip_rows) == 2
        space = space_of(port)
        assert space.n_atoms == 1 and space.n_host_rows >= 2
        assert_space_equal(space_of(ref), space)
        want = oracle_grid(policy, pods, namespaces, CASES)
        g = port.evaluate_grid(CASES)
        for k in want:
            assert np.array_equal(np.asarray(getattr(g, k)), want[k]), k

    def test_host_ip_mask_boundary_vs_oracle(self):
        ref, port, policy, pods, namespaces = build_pair(
            [IPBlock.make("fd00:aa::/32", [])],
            ["fd00:aa::1", "fd00:bb::1", "10.0.0.1"],
            class_compress="1", cidr_tss="1",
        )
        want = oracle_grid(policy, pods, namespaces, CASES)
        g = port.evaluate_grid(CASES)
        for k in want:
            assert np.array_equal(np.asarray(getattr(g, k)), want[k]), k
        assert np.array_equal(table(g), table(ref.evaluate_grid(REF_CASES)))


class TestParity:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_cidr_fuzz_family(self, seed):
        """The port's CIDR gate (dense == classes(bits) == classes(TSS) ==
        oracle, grid and counts, plus the membership bridge) on the same
        scenario as the reference's generator, seed for seed."""
        fc, rfc = fuzz.build_cidr_fuzz_case(seed), ref_fuzz.build_cidr_fuzz_case(seed)
        assert fc.pods == rfc.pods and fc.namespaces == rfc.namespaces
        assert [c.__dict__ for c in fc.cases] == [c.__dict__ for c in rfc.cases]
        assert fc.simplify == rfc.simplify
        from cyclonus_tpu.kube.yaml_io import policy_to_dict
        from cyclonus_tpu_torch.kube.yaml_io import policy_to_dict as port_to_dict

        assert [port_to_dict(p) for p in fc.netpols] == [policy_to_dict(p) for p in rfc.netpols]
        r = fuzz.run_cidr_seed(seed, device="cpu")
        assert r["cells"] > 0

    @pytest.mark.parametrize("seed", [0, 1, 3])
    def test_cidr_fuzz_classes_equal_reference(self, seed):
        """The forced-TSS engine's classes and partition map equal the
        reference's on the fuzz family's scenarios."""
        fc = ref_fuzz.build_cidr_fuzz_case(seed)
        ref = TpuPolicyEngine(ref_build(fc.simplify, fc.netpols), fc.pods, fc.namespaces,
                              class_compress="1", cidr_tss="1")
        from cyclonus_tpu.kube.yaml_io import policy_to_dict
        from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
        from cyclonus_tpu_torch.matcher import build_network_policies

        policy = build_network_policies(
            fc.simplify, [parse_policy_dict(policy_to_dict(p)) for p in fc.netpols]
        )
        port = TorchPolicyEngine(policy, fc.pods, fc.namespaces, device="cpu",
                                 class_compress="1", cidr_tss="1")
        assert_space_equal(space_of(ref), space_of(port))
        for k in ("class_of_pod", "class_rep", "class_size"):
            assert np.array_equal(getattr(ref.pod_classes(), k), getattr(port.pod_classes(), k))

    def test_forced_tss_matches_bit_classes_verdicts(self):
        blocks = [
            IPBlock.make("10.0.0.0/8", ["10.0.1.0/24", "10.0.2.0/24"]),
            IPBlock.make("10.0.1.0/24", []),
        ]
        ips = [f"10.0.{i % 4}.{i + 1}" for i in range(12)]
        _r, e_bit, *_ = build_pair(blocks, ips, class_compress="1", cidr_tss="0")
        _r2, e_tss, *_ = build_pair(blocks, ips, class_compress="1", cidr_tss="1")
        assert space_of(e_tss) is not None and space_of(e_bit) is None
        # the partition signature may split finer than the per-spec bits
        assert e_tss.pod_classes().n_classes >= e_bit.pod_classes().n_classes
        assert np.array_equal(table(e_bit.evaluate_grid(CASES)), table(e_tss.evaluate_grid(CASES)))
        assert e_bit.evaluate_grid_counts(CASES) == e_tss.evaluate_grid_counts(CASES)


class TestAboveFloor:
    """Auto mode above the 256-spec floor: the reference classifies by
    the partition signature, and so must the port — the same classes,
    class ids, stats and partition map.  Before the port had the stage,
    its per-spec bits classified these sets coarser than the reference."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_classes_equal_reference(self, seed):
        blocks, ips = heavy_blocks(seed)
        ref, port, *_ = build_pair(blocks, ips, class_compress="1")
        rs, ps = space_of(ref), space_of(port)
        assert rs is not None and rs.n_specs >= 256
        assert_space_equal(rs, ps)
        assert stats_without_timing(port.cidr_stats()) == stats_without_timing(ref.cidr_stats())
        assert port.cidr_stats()["active"] and port.cidr_stats()["device"] is False
        for k in ("class_of_pod", "class_rep", "class_size"):
            assert np.array_equal(getattr(ref.pod_classes(), k), getattr(port.pod_classes(), k))
        rcs, pcs = ref.class_compression_stats(), port.class_compression_stats()
        rcs.pop("gather_s")
        assert pcs == rcs
        assert port._class_state["aux_bytes"] == ref._class_state["aux_bytes"]
        assert_tree_equal(ref._class_state["ctensors"], port._class_state["ctensors"])

    def test_signature_bytes_and_lpm_equal_reference(self):
        blocks, ips = heavy_blocks(3)
        ref, port, *_ = build_pair(blocks, ips, class_compress="1")
        rs, ps = space_of(ref), space_of(port)
        n = port.n_pods
        t = port._tensors
        view = {k: t[k][:n] for k in ("pod_ns_id", "pod_ip", "pod_ip_valid")}
        view["ingress"], view["egress"] = t["ingress"], t["egress"]
        selpod = np.zeros((0, n), bool)
        got = pod_signatures(view, selpod, cidr=ps)
        assert np.array_equal(got, ref_pod_signatures(view, selpod, cidr=rs))
        # the device leg (torch on the CPU) gives the same bytes
        sig_dev = ps.signature(view["pod_ip"], view["pod_ip_valid"], device=True)
        assert np.array_equal(sig_dev, rs.signature_host(view["pod_ip"], view["pod_ip_valid"]))
        # the CIDR_AUTO default resolves the same space as the engine
        assert np.array_equal(pod_signatures(view, selpod), got)
        # and the pre-TSS bit path stays the reference's cidr=None bytes
        assert np.array_equal(pod_signatures(view, selpod, cidr=None),
                              ref_pod_signatures(view, selpod, cidr=None))

    def test_device_leg_above_work_floor(self, monkeypatch):
        """Above CYCLONUS_CIDR_DEVICE_MIN pods x atoms the engine's LPM
        stage takes the device leg (here the CPU device) and classifies
        exactly as the reference."""
        monkeypatch.setenv("CYCLONUS_CIDR_DEVICE_MIN", "1000")
        blocks, ips = heavy_blocks(4)
        ref, port, *_ = build_pair(blocks, ips, class_compress="1")
        assert port.cidr_stats()["device"] is True
        assert space_of(port).device == torch.device("cpu")
        for k in ("class_of_pod", "class_rep", "class_size"):
            assert np.array_equal(getattr(ref.pod_classes(), k), getattr(port.pod_classes(), k))

    def test_device_leg_raises_without_falling_back(self, monkeypatch):
        """A device leg that cannot run raises; it never falls back to
        the numpy twin."""
        blocks, ips = heavy_blocks(5)
        _ref, port, *_ = build_pair(blocks, ips, class_compress="1")
        space = space_of(port)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        space.device = None  # the current CUDA device: there is none
        n = port.n_pods
        with pytest.raises(RuntimeError, match="no CUDA device"):
            space.signature(port._tensors["pod_ip"][:n], port._tensors["pod_ip_valid"][:n],
                            device=True)


class TestGating:
    BLOCKS = [
        IPBlock.make("10.0.0.0/8", []),
        IPBlock.make("10.0.1.0/24", []),
        IPBlock.make("10.0.1.7/32", []),
    ]
    IPS = ["10.0.1.7", "10.0.1.8", "10.0.2.1", "11.0.0.1"]

    def test_off_is_byte_identical(self, monkeypatch):
        monkeypatch.setenv("CYCLONUS_CIDR_TSS", "0")
        _r, e_off, *_ = build_pair(self.BLOCKS, self.IPS, class_compress="1")
        monkeypatch.delenv("CYCLONUS_CIDR_TSS")
        _r2, e_env, *_ = build_pair(self.BLOCKS, self.IPS, class_compress="1")
        assert space_of(e_env) is None and space_of(e_off) is None
        n = e_off.n_pods
        sel = np.zeros((0, n), bool)

        def view(e):
            t = e._tensors
            v = {k: t[k][:n] for k in ("pod_ns_id", "pod_ip", "pod_ip_valid")}
            v["ingress"], v["egress"] = t["ingress"], t["egress"]
            return v

        s_off = pod_signatures(view(e_off), sel, cidr=None)
        assert np.array_equal(s_off, pod_signatures(view(e_env), sel, cidr=None))
        assert np.array_equal(s_off, ref_pod_signatures(view(e_off), sel, cidr=None))
        assert e_off.pod_classes().n_classes == e_env.pod_classes().n_classes

    def test_auto_floor_and_force(self, monkeypatch):
        monkeypatch.setenv("CYCLONUS_CIDR_TSS", "auto")
        ref, port, *_ = build_pair(self.BLOCKS, self.IPS, class_compress="1")
        assert space_of(port) is None and space_of(ref) is None
        monkeypatch.setenv("CYCLONUS_CIDR_TSS_MIN", "1")
        ref, port, *_ = build_pair(self.BLOCKS, self.IPS, class_compress="1")
        assert space_of(port) is not None
        assert not port.cidr_stats()["device"]
        assert stats_without_timing(port.cidr_stats()) == stats_without_timing(ref.cidr_stats())

    def test_budget_fallback(self, monkeypatch):
        monkeypatch.setenv("CYCLONUS_SLAB_MAX_BYTES", "64")
        ref, e, *_ = build_pair(self.BLOCKS, self.IPS, class_compress="1", cidr_tss="1")
        assert space_of(e) is None and space_of(ref) is None
        assert not e.cidr_stats()["active"]
        assert e.cidr_stats() == ref.cidr_stats()
        monkeypatch.delenv("CYCLONUS_SLAB_MAX_BYTES")
        _r, e2, *_ = build_pair(self.BLOCKS, self.IPS, class_compress="1", cidr_tss="1")
        assert np.array_equal(table(e.evaluate_grid(CASES)), table(e2.evaluate_grid(CASES)))

    def test_aux_bytes_counts_partition_tensors(self):
        ref, e_tss, *_ = build_pair(self.BLOCKS, self.IPS, class_compress="1", cidr_tss="1")
        space = space_of(e_tss)
        assert space.nbytes() > 0
        assert e_tss.cidr_stats()["bytes"] == space.nbytes() == space_of(ref).nbytes()
        st = e_tss._class_state
        from cyclonus_tpu_torch.engine import host

        base = int(
            e_tss.n_pods * 4
            + st["ctensors"]["pod_ns_id"].shape[0] * 4
            + sum(a.nbytes for a in host._np_leaves(st["ctensors"]))
        )
        assert st["aux_bytes"] == base + space.nbytes() == ref._class_state["aux_bytes"]

    def test_bad_mode_raises(self):
        with pytest.raises(ValueError):
            cidrspace.tss_mode("bogus")
        with pytest.raises(ValueError):
            build_pair(self.BLOCKS, self.IPS, class_compress="1", cidr_tss="bogus")

    def test_inactive_stats_equal_reference(self):
        ref, port, *_ = build_pair(self.BLOCKS, self.IPS, class_compress="0")
        assert port.cidr_stats() == ref.cidr_stats()


class TestServeDeltas:
    """The same delta stream through the reference's service and the
    port's over a TSS-classified engine: modes, tensors, classes and
    state equal at every step (test_torch_serve.Twin), verify_parity on
    the port."""

    BASE_BLOCKS = [
        IPBlock.make("10.0.0.0/8", ["10.0.9.0/24"]),
        IPBlock.make("10.0.1.0/24", []),
    ]

    def _twin(self, monkeypatch, blocks):
        monkeypatch.setenv("CYCLONUS_CIDR_TSS", "1")
        pods, namespaces = mk_cluster(["10.0.1.5", "10.0.1.6", "10.0.2.7", "10.0.3.8"])
        twin = Twin(pods, namespaces, [mk_np("np0", "x", blocks)], class_compress="1")
        assert space_of(twin.port.engine) is not None
        return twin

    def _upsert(self, blocks):
        from cyclonus_tpu.kube.yaml_io import policy_to_dict
        from cyclonus_tpu.worker.model import Delta

        return Delta(kind="policy_upsert", namespace="x", name="np0",
                     policy=policy_to_dict(mk_np("np0", "x", blocks)))

    def _check_space(self, twin):
        assert_space_equal(space_of(twin.ref.engine), space_of(twin.port.engine))

    def test_same_structure_delta_stays_incremental(self, monkeypatch):
        twin = self._twin(monkeypatch, self.BASE_BLOCKS)
        report = twin.apply([self._upsert([
            IPBlock.make("10.0.0.0/8", ["10.0.9.0/24"]),
            IPBlock.make("10.0.2.0/24", []),
        ])])
        assert report["mode"] in ("incremental", "class_rebuild")
        twin.port.verify_parity(CASES)
        self._check_space(twin)
        assert space_of(twin.port.engine).n_atoms == 3

    def test_new_mask_structure_forces_full_rebuild(self, monkeypatch):
        twin = self._twin(monkeypatch, self.BASE_BLOCKS)
        report = twin.apply([self._upsert([
            IPBlock.make("10.0.0.0/8", ["10.0.9.0/24"]),
            IPBlock.make("10.0.1.0/24", []),
            IPBlock.make("10.0.1.16/28", []),
        ])])
        assert report["mode"] == "full"
        twin.port.verify_parity(CASES)
        self._check_space(twin)
        assert 28 in list(space_of(twin.port.engine).pprefix)

    def test_structure_pin_raises_before_mutation(self, monkeypatch):
        """patch_policy raises Ineligible on a new mask structure with
        the engine's tensors and partition map untouched."""
        from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
        from cyclonus_tpu_torch.serve.incremental import IncrementalEngine, Ineligible
        from cyclonus_tpu.kube.yaml_io import policy_to_dict

        monkeypatch.setenv("CYCLONUS_CIDR_TSS", "1")
        pods, namespaces = mk_cluster(["10.0.1.5", "10.0.2.7"])
        inc = IncrementalEngine(port_policy([mk_np("np0", "x", self.BASE_BLOCKS)]), pods,
                                namespaces, device="cpu", class_compress="1")
        before = space_of(inc.engine)
        tensors = {k: v.copy() for k, v in inc.engine._tensors["ingress"].items()
                   if isinstance(v, np.ndarray)}
        new = mk_np("np0", "x", self.BASE_BLOCKS + [IPBlock.make("10.0.1.16/28", [])])
        from cyclonus_tpu_torch.matcher import build_network_policies

        with pytest.raises(Ineligible, match="mask structure"):
            inc.patch_policy(build_network_policies(True, [parse_policy_dict(policy_to_dict(new))]))
        assert space_of(inc.engine) is before
        for k, v in tensors.items():
            assert np.array_equal(inc.engine._tensors["ingress"][k], v), k
        assert inc._resolved_cidr == (False, None)

    def test_empty_cluster_rebuild_survives(self, monkeypatch):
        from cyclonus_tpu.worker.model import Delta

        twin = self._twin(monkeypatch, self.BASE_BLOCKS)
        for key in list(twin.ref.pods):
            ns, name = key.split("/", 1)
            twin.apply([Delta(kind="pod_remove", namespace=ns, name=name)])
        assert not twin.port.pods
        report = twin.apply([Delta(kind="pod_add", namespace="x", name="fresh",
                                   labels={"app": "a0"}, ip="10.0.9.50")])
        assert report["applied"] == 1
        twin.port.verify_parity(CASES)
        self._check_space(twin)

    def test_pod_delta_uses_cached_map(self, monkeypatch):
        from cyclonus_tpu.worker.model import Delta

        twin = self._twin(monkeypatch, self.BASE_BLOCKS)
        space = space_of(twin.port.engine)
        report = twin.apply([Delta(kind="pod_add", namespace="x", name="p0",
                                   labels={"app": "a1"}, ip="10.0.9.77")])
        assert report["mode"] in ("incremental", "class_rebuild")
        twin.port.verify_parity(CASES)
        self._check_space(twin)
        if report["mode"] == "incremental":
            assert space_of(twin.port.engine) is space

    def test_mixed_stream_equal_reference(self, monkeypatch):
        """A seeded stream of pod, label and same-structure policy
        deltas over a CIDR-heavy set: every step equal to the reference."""
        from cyclonus_tpu.worker.model import Delta

        blocks, ips = heavy_blocks(6, n=64)
        twin = self._twin(monkeypatch, blocks)
        rng = random.Random(6)
        for step in range(12):
            roll = rng.random()
            keys = list(twin.ref.pods)
            if roll < 0.5 and keys:
                ns, name = keys[rng.randrange(len(keys))].split("/", 1)
                d = Delta(kind="pod_add", namespace=ns, name=name,
                          labels={"app": f"a{rng.randrange(2)}"},
                          ip=f"10.{rng.randrange(4)}.{rng.randrange(8)}.{rng.randrange(256)}")
            elif roll < 0.8:
                d = Delta(kind="pod_add", namespace="x", name=f"new{step}", labels={"app": "a0"},
                          ip=f"10.{rng.randrange(4)}.{rng.randrange(8)}.{rng.randrange(256)}")
            else:
                rng.shuffle(blocks)
                d = self._upsert(blocks[: len(blocks) - 1])
            twin.apply([d])
            self._check_space(twin)
        twin.port.verify_parity(CASES)
