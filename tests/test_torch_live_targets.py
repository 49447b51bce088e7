"""The live-target pass of the packed counts kernels, on the CPU.

Before each K1/K2/K3 launch, counts_from_packed_ops cuts each
direction's contraction to the targets that select a pod
(engine/packed_kernel.py live_targets): the OR of the tmatch rows marks
the live targets, and both operands of the direction are packed again
over them.  Held here:
  * counts through the compacted wrapper equal the plain version on the
    operands as given (plain=True), untiered, tiered and weighted, with
    scattered live targets, a direction with none, every target live
    (the skip: the operands pass through as they are), and invalid rows
    whose bits select targets that are dead among the valid ones;
  * the compacted depth is max(8, round_up(ceil(L / 32), 8)) words, the
    plain gather's bits are a bool reference's live columns, and the pass
    reads the live words back only where some direction is deeper than
    one step (and within MAX_LIVE_DEPTH), the same rule on the card;
  * an IncrementalEngine whose pod relabel makes a dead target live
    between two recounts counts as a freshly built engine does.

The card's test is tests/test_torch_live_targets_cuda.py."""

import math

import numpy as np
import pytest
import torch

from cyclonus_tpu_torch.engine import PortCase
from cyclonus_tpu_torch.engine import packed_kernel as pk
from cyclonus_tpu_torch.engine.api import TorchPolicyEngine
from cyclonus_tpu_torch.engine.encoding import TIER_KEY_NONE
from cyclonus_tpu_torch.engine.kernel import pack_bool_words_torch
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.matcher import build_network_policies
from cyclonus_tpu_torch.serve.incremental import IncrementalEngine
from cyclonus_tpu_torch.telemetry import instruments as ti


def _live(rng, t, n_live):
    return np.sort(rng.choice(t, size=n_live, replace=False)) if n_live else np.zeros(0, int)


def _launch(seed, q, te, tn, ns, nd, live_e, live_i, tiered=False, weighted=False,
            invalid=False):
    """(packed operands, expected live counts): tmatch bits on the live
    targets alone (plus, with `invalid`, bits of dead targets on invalid
    rows only), tallow bits on every target, so a dead target's tallow
    column is not zero."""
    rng = np.random.default_rng(seed)
    vs = rng.random(ns) < 0.8 if invalid else np.ones(ns, bool)
    vd = rng.random(nd) < 0.8 if invalid else np.ones(nd, bool)

    def tmatch(t, n, live, valid):
        sel = np.zeros(t, bool)
        sel[live] = True
        m = (rng.random((t, n)) < 0.3) & sel[:, None]
        m[live, rng.choice(np.flatnonzero(valid), size=len(live))] = True
        if invalid:
            dead = rng.choice(np.flatnonzero(~sel), size=20, replace=False)
            m[dead[:, None], np.flatnonzero(~valid)[None, :]] = True
        return m

    tm_e, tm_i = tmatch(te, ns, live_e, vs), tmatch(tn, nd, live_i, vd)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = (
        pack_bool_words_torch(t(tm_e)), t(rng.random(ns) < 0.7),
        pack_bool_words_torch(t(rng.random((te, nd, q)) < 0.3)),
        pack_bool_words_torch(t(tm_i)), t(rng.random(nd) < 0.7),
        pack_bool_words_torch(t(rng.random((tn, ns, q)) < 0.3)),
    )
    tier = None
    if tiered:
        def side(g, n_subj, n_peer):
            key = (rng.integers(0, 4, size=g) * 4 + rng.integers(1, 4, size=g)).astype(np.int32)
            banp = np.arange(g) >= g - 2
            return {"subj": t(rng.random((g, n_subj)) < 0.3),
                    "peerq": t(rng.random((g, n_peer, q)) < 0.3),
                    "anp_key": t(np.where(banp, TIER_KEY_NONE, key).astype(np.int32)),
                    "banp_key": t(np.where(banp, key, TIER_KEY_NONE).astype(np.int32))}
        tier = {"egress": side(5, ns, nd), "ingress": side(6, nd, ns)}
    w = t(rng.integers(0, 5, size=nd).astype(np.float32)) if weighted else None
    ops = pk.packed_operands(*args, valid_src=t(vs), valid_dst=t(vd), tier=tier, w_dst=w,
                             bs=64, bd=128)
    n_live = {"egress": int((tm_e & vs[None, :]).any(1).sum()),
              "ingress": int((tm_i & vd[None, :]).any(1).sum())}
    return ops, n_live


#: name: (q, egress targets, ingress targets, src pods, dst pods, live
#: egress, live ingress, tiered, weighted, invalid rows); live counts are
#: drawn at random positions, "scattered" every 23rd target
CASES = {
    "untiered": (2, 700, 900, 150, 170, 40, 60, False, False, False),
    "tiered": (2, 700, 900, 150, 170, 40, 60, True, False, False),
    "weighted": (1, 700, 900, 150, 170, 40, 60, False, True, False),
    "tiered_weighted": (3, 300, 520, 90, 130, 40, 60, True, True, False),
    "scattered": (2, 800, 800, 120, 140, "every23", "every23", False, False, False),
    "no_live_egress": (2, 600, 700, 120, 140, 0, 50, False, False, False),
    "all_live": (2, 300, 300, 120, 140, "all", "all", False, False, False),
    "invalid_rows": (2, 700, 900, 150, 170, 40, 60, False, False, True),
}


def _positions(rng, t, spec):
    if spec == "all":
        return np.arange(t)
    if spec == "every23":
        return np.arange(5, t, 23)
    return _live(rng, t, spec)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compacted_counts_equal_plain(case):
    q, te, tn, ns, nd, le, li, tiered, weighted, invalid = CASES[case]
    rng = np.random.default_rng(len(case))
    live_e, live_i = _positions(rng, te, le), _positions(rng, tn, li)
    ops, n_live = _launch(7, q, te, tn, ns, nd, live_e, live_i, tiered, weighted, invalid)
    depth = {"egress": ops["a_e"].shape[1], "ingress": ops["a_i"].shape[1]}
    want = {d: pk.compacted_depth(n_live[d]) if pk.compacted_depth(n_live[d]) < depth[d]
            else depth[d] for d in depth}
    if case == "no_live_egress":
        assert n_live["egress"] == 0 and want["egress"] == pk.STEP_WORDS
    got_ops = pk.live_targets(ops)
    if case == "all_live":
        assert want == depth and got_ops is ops
    else:
        assert want != depth and got_ops is not ops
    assert (got_ops["a_e"].shape[1], got_ops["b_e"].shape[2]) == (want["egress"],) * 2
    assert (got_ops["a_i"].shape[1], got_ops["b_i"].shape[2]) == (want["ingress"],) * 2
    compactions = ti.PACKED_COMPACTIONS.value()
    skips = ti.PACKED_COMPACTION_SKIPS.value()
    got = pk.counts_from_packed_ops(ops)
    assert ti.PACKED_COMPACTIONS.value() == compactions + (case != "all_live")
    assert ti.PACKED_COMPACTION_SKIPS.value() == skips + (case == "all_live")
    for d in depth:
        assert ti.PACKED_CONTRACTION_WORDS.value(direction=d, depth="encoded") == depth[d]
        assert ti.PACKED_CONTRACTION_WORDS.value(direction=d, depth="launched") == want[d]
    plain = pk.counts_from_packed_ops(ops, plain=True)
    assert got.dtype == plain.dtype and torch.equal(got, plain)
    assert plain.abs().sum() > 0


@pytest.mark.parametrize(
    "de,di,n_live_e,n_live_i,reads,want",
    [
        # one step a direction (the class route at 4,096 classes): no OR
        (8, 8, 10, 10, False, (8, 8)),
        # ingress deeper, its targets all live: the OR, then the skip
        (8, 16, 10, 300, True, (8, 16)),
        (8, 16, 10, 10, True, (8, 8)),
        (16, 8, 10, 10, True, (8, 8)),
        # past the gather's map (MAX_LIVE_DEPTH) and one step: no OR
        (8200, 8, 10, 10, False, (8200, 8)),
        (8200, 16, 10, 10, True, (8200, 8)),
        (8192, 8, 300, 10, True, (16, 8)),
    ],
)
def test_the_pass_reads_back_where_a_direction_is_deeper_than_a_step(
        monkeypatch, de, di, n_live_e, n_live_i, reads, want):
    """live_targets reads the live words only where some direction could
    lose a step, and compacts each such direction whose live targets fit
    in fewer: a rule of the operands' depths and bits alone."""
    rng = np.random.default_rng(de + di)

    def operand(*shape, n_live=None):
        d = shape[-1]
        bits = torch.zeros(shape[:-1] + (32 * d,), dtype=torch.bool)
        if n_live is None:
            bits[..., : 32 * d : 7] = torch.from_numpy(rng.random(bits[..., ::7].shape) < 0.5)
        else:
            bits[0, np.linspace(0, 32 * d - 1, n_live).astype(int)] = True
        return pack_bool_words_torch(bits, len(shape) - 1)

    ops = {"a_e": operand(4, de, n_live=n_live_e), "b_e": operand(1, 5, de),
           "b_i": operand(1, 4, di), "a_i": operand(5, di, n_live=n_live_i)}
    calls = []
    live_words = pk._live_words
    monkeypatch.setattr(pk, "_live_words", lambda *a: calls.append(1) or live_words(*a))
    skips = ti.PACKED_COMPACTION_SKIPS.value()
    got = pk.live_targets(ops)
    assert bool(calls) is reads
    assert (got["a_e"].shape[1], got["b_e"].shape[2]) == (want[0],) * 2
    assert (got["a_i"].shape[1], got["b_i"].shape[2]) == (want[1],) * 2
    assert (got is ops) is (want == (de, di))
    assert ti.PACKED_COMPACTION_SKIPS.value() == skips + (want == (de, di))
    for name, d in (("a_e", "egress"), ("b_e", "egress"), ("b_i", "ingress"), ("a_i", "ingress")):
        if got[name] is not ops[name]:
            live = pk._or_rows(ops["a_e"] if d == "egress" else ops["a_i"])
            assert torch.equal(got[name], pk.gather_live_plain(ops[name], live, got[name].shape[-1]))


@pytest.mark.parametrize("n_live", [0, 1, 31, 32, 33, 255, 256, 257, 1000])
def test_compacted_depth(n_live):
    want = max(8, math.ceil(math.ceil(n_live / 32) / 8) * 8)
    assert pk.compacted_depth(n_live) == want
    assert want % pk.STEP_WORDS == 0 and 32 * want >= n_live


@pytest.mark.parametrize("shape,t,n_live", [((40,), 300, 17), ((3, 25), 260, 90), ((30,), 64, 64)])
def test_plain_gather_matches_bool_reference(shape, t, n_live):
    """gather_live_plain packs the live columns of a bool reference (bit
    31 included), with zero words past the live count."""
    rng = np.random.default_rng(t + n_live)
    bits = torch.from_numpy(rng.random(shape + (t,)) < 0.5)
    live_pos = torch.from_numpy(_live(rng, t, n_live))
    last = len(shape)
    a = pk._pad(pack_bool_words_torch(bits, last), last, 8 * -(-t // 256))
    live_bits = torch.zeros(t, dtype=torch.bool)
    live_bits[live_pos] = True
    live = pk._pad(pack_bool_words_torch(live_bits), 0, a.shape[-1])
    depth = pk.compacted_depth(n_live)
    got = pk.gather_live_plain(a, live, depth)
    want = pk._pad(pack_bool_words_torch(bits[..., live_pos], last), last, depth)
    assert got.shape == shape + (depth,) and torch.equal(got, want)
    # and the plain OR of the rows is the reference's any over them
    any_bits = pack_bool_words_torch(bits.reshape(-1, t).any(0))
    assert torch.equal(pk._or_rows(a.reshape(-1, a.shape[-1])), pk._pad(any_bits, 0, a.shape[-1]))


#: one (namespace, app) target per policy, 4 x 80 of them, both
#: directions: the pods carry 3 of the 80 apps, so most targets are dead
N_NS, N_APPS, N_PODS = 4, 80, 24
CASES_TCP = [PortCase(80, "", "TCP"), PortCase(81, "", "TCP")]


def _cluster():
    namespaces = {f"ns{i}": {"ns": f"ns{i}"} for i in range(N_NS)}
    pods = [(f"ns{i % N_NS}", f"pod-{i}", {"app": f"a{i % 3}", "role": f"r{i % 4}"},
             f"10.0.0.{i + 1}") for i in range(N_PODS)]
    policies = []
    for n in range(N_NS):
        for k in range(N_APPS):
            port = [{"protocol": "TCP", "port": 80 + k % 2}]
            policies.append(parse_policy_dict({
                "metadata": {"name": f"p{k}", "namespace": f"ns{n}"},
                "spec": {
                    "podSelector": {"matchLabels": {"app": f"a{k}"}},
                    "policyTypes": ["Ingress", "Egress"],
                    "ingress": [{"from": [{"podSelector": {"matchLabels": {"role": f"r{k % 4}"}}}],
                                 "ports": port}],
                    "egress": [{"to": [{"podSelector": {"matchLabels": {"role": f"r{(k + 1) % 4}"}}}],
                                "ports": port}],
                },
            }))
    return build_network_policies(True, policies), pods, namespaces


def test_relabel_makes_a_dead_target_live():
    policy, pods, namespaces = _cluster()
    inc = IncrementalEngine(policy, pods, namespaces, device="cpu", class_compress="0")
    eng = inc.engine

    def n_live(ops):
        live = pk._live_words(ops["a_e"], ops["a_i"]).numpy()
        return int(np.unpackbits(live.view(np.uint8)).sum())

    def relabel(i, app):
        ns, name, labels, ip = pods[i]
        pods[i] = (ns, name, {**labels, "app": app}, ip)
        patch = inc.main_patchset()
        inc.update_pod(i, pods[i], patch)
        inc.flush(patch)
        inc.finish()

    modes, lives = [], []
    for step, app in enumerate([None, None, "a50", "a77"]):
        if app is not None:
            relabel(5 * step, app)
        compactions = ti.PACKED_COMPACTIONS.value()
        got = eng.evaluate_grid_counts(CASES_TCP)
        assert ti.PACKED_COMPACTIONS.value() == compactions + 1
        modes.append(eng.pre_cache_stats()["mode"])
        if eng._pre_cache is not None:
            ops = eng._pre_cache[1]["ops"]
            assert ops["a_e"].shape[1] == ops["a_i"].shape[1] == 16
            assert ti.PACKED_CONTRACTION_WORDS.value(direction="ingress", depth="launched") == 8
            lives.append(n_live(ops))
        fresh = TorchPolicyEngine(policy, pods, namespaces, device="cpu", compact=False,
                                  class_compress="0")
        assert got == fresh._counts_dense(CASES_TCP, plain=True), step
    assert modes == ["fused", "split", "steady", "steady"]
    # each relabel gave a pod an app no pod of its namespace had: one more
    # live target a direction
    assert lives[1] == lives[0] + 2 and lives[2] == lives[1] + 2
