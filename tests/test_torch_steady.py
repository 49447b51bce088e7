"""The steady state of the PyTorch port's dense counts route against the
reference's, on the CPU: the fused -> split -> steady machine of
TorchPolicyEngine._counts_dense call for call against
TpuPolicyEngine._counts_pallas_dispatch (its Pallas kernels in interpret
mode, backend="pallas"), the byte gate and the opt-out, steady counts on
every kernel route, the slab autotune and its persisted winners, the
pipelined figure and invalidate_after_patch.  Every count comparison is
exact.

The port's steady state on the card is held by the `cuda`-marked test at
the end (skipped without a card) and by chip_smoke.py."""

import json

import numpy as np
import pytest
import torch

import cyclonus_tpu.engine.api as ref_api
import cyclonus_tpu.engine.pallas_kernel as ref_pk
from cyclonus_tpu.engine import PortCase as RefPortCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.matcher import build_network_policies as ref_build
from cyclonus_tpu.tiers import fuzz as ref_fuzz
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.engine import api
from cyclonus_tpu_torch.engine import autotune as at
from cyclonus_tpu_torch.engine import dense_kernel as dk
from cyclonus_tpu_torch.engine import packed_kernel as pk

from test_torch_engine import CASE_TUPLES, fuzz_policies, port_policy
from test_torch_tiers import port_policy as tier_port_policy
from test_torch_tiers import port_tiers

#: the case sets of the call pattern: A is the three cases the port's
#: engine tests use, B and C one case each
SETS = {
    "A": CASE_TUPLES,
    "B": [(81, "", "UDP")],
    "C": [(9999, "", "TCP")],
}
PATTERN = "AAABABCAC"


def _cases(name):
    tuples = SETS[name]
    return [RefPortCase(*c) for c in tuples], [PortCase(*c) for c in tuples]


def _tiny_slab(monkeypatch):
    """Both packages' slab tiles and window ceiling set to 8, so a fuzz
    cluster spans several tiles."""
    for mod in (ref_pk, dk):
        monkeypatch.setattr(mod, "SLAB_BS", 8)
        monkeypatch.setattr(mod, "SLAB_BD", 8)
        monkeypatch.setattr(mod, "SLAB_W", 8)


def _engines(monkeypatch, plan, seed=14, extra=8, **kw):
    """(reference, port) engines of one cluster: plan "packed" and
    "dense" on NetworkPolicy fuzz seed `seed`, "tiered" on tier fuzz seed
    `seed` (packed), each on the dense route."""
    monkeypatch.setenv("CYCLONUS_PACK", "0" if plan == "dense" else "1")
    if plan == "tiered":
        fc = ref_fuzz.build_fuzz_case(seed)
        ref = TpuPolicyEngine(ref_build(fc.simplify, fc.netpols), fc.pods, fc.namespaces,
                              tiers=fc.tiers, class_compress="0")
        port = TorchPolicyEngine(tier_port_policy(fc.simplify, fc.netpols), fc.pods,
                                 fc.namespaces, tiers=port_tiers(fc.tiers), class_compress="0",
                                 device="cpu")
        assert "tiers" in port._tensors
        return ref, port
    if "slab" in kw:
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", kw["slab"])
    ref_kw = {k: v for k, v in kw.items() if k != "slab"}
    policies, pods, namespaces = fuzz_policies(seed, extra)
    ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces, class_compress="0",
                          **ref_kw)
    port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                             class_compress="0", **kw)
    return ref, port


def _state(eng):
    pin = eng._pre_cache
    return (None if pin is None else pin[0], eng._pre_cache_misses, eng._pre_cache_declined)


def _walk(ref, port, pattern=PATTERN):
    """Both engines through the call pattern; at every step the pinned
    key, the misses and the declined key are equal, and so are the
    counts.  Returns the port's modes."""
    modes = []
    for step, name in enumerate(pattern):
        ref_cases, cases = _cases(name)
        want = ref.evaluate_grid_counts(ref_cases, backend="pallas")
        got = port.evaluate_grid_counts(cases)
        assert got == want, f"step {step} ({name})"
        assert _state(port) == _state(ref), f"step {step} ({name})"
        modes.append(port.pre_cache_stats()["mode"])
    return modes


class TestStateMachine:
    @pytest.mark.parametrize("plan,seed", [("packed", 14), ("packed", 3), ("dense", 14),
                                           ("dense", 6), ("tiered", 3), ("tiered", 6)])
    def test_call_pattern_matches_reference(self, monkeypatch, plan, seed):
        """A, A, A, B, A, B, C, A, C: fused, split, steady; one call of
        another set keeps the pin, its second call pins it instead; two
        other sets in a row evict."""
        ref, port = _engines(monkeypatch, plan, seed)
        modes = _walk(ref, port)
        assert modes == ["fused", "split", "steady", "fused", "steady", "split", "fused",
                         "fused", "fused"]
        st = port.pre_cache_stats()
        assert (st["hits"], st["misses"], st["precomputes"]) == (2, 7, 7)
        assert port._pre_cache is None  # C, A after the pinned B

    def test_slab_forced_pattern(self, monkeypatch):
        """slab "1": the same sequence, the slab operands gathered at the
        first steady-state call and evicted with the pin."""
        _tiny_slab(monkeypatch)
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", "1")
        ref, port = _engines(monkeypatch, "dense", 35, 10)
        _walk(ref, port, "AAA")
        assert port._slab_choice is True and port._slab_plan_state is not None
        assert port._slab_ops_cache is not None
        assert port._slab_ops_cache[0] == port._pre_cache[0]
        # the pin keeps only what K6 reads: its gathered operands
        assert port._pre_cache[1] == {"ops": None, "pre": None}
        _walk(ref, port, "BC")
        assert port._pre_cache is None and port._slab_ops_cache is None

    def test_estimate_matches_reference(self, monkeypatch):
        for plan, seed in (("packed", 14), ("dense", 5), ("tiered", 3)):
            ref, port = _engines(monkeypatch, plan, seed)
            for q in (1, 2, 5):
                assert port._pre_bytes_estimate(q) == ref._pre_bytes_estimate(q), (plan, q)


class TestGate:
    @pytest.mark.parametrize("plan", ["packed", "dense"])
    def test_cap_zero_and_opt_out(self, monkeypatch, plan):
        """Over the cap, or with CYCLONUS_PRE_CACHE=0, nothing is pinned
        and every call runs fused, with the same counts."""
        monkeypatch.setattr(ref_api, "_PRE_CACHE_MAX_BYTES", 0)
        monkeypatch.setattr(api, "_PRE_CACHE_MAX_BYTES", 0)
        ref, port = _engines(monkeypatch, plan, 15)
        assert set(_walk(ref, port, "AAA")) == {"fused"}
        assert port._pre_cache is None and ref._pre_cache is None
        monkeypatch.undo()
        monkeypatch.setenv("CYCLONUS_PRE_CACHE", "0")
        ref, port = _engines(monkeypatch, plan, 15)
        assert set(_walk(ref, port, "AAA")) == {"fused"}
        assert port.pre_cache_stats()["precomputes"] == 3

    def test_actual_bytes_decline(self, monkeypatch):
        """An estimate under the cap but pinned bytes over it declines the
        key: the split call counts, nothing stays pinned, and later calls
        of the key run fused instead of splitting again."""
        _ref, port = _engines(monkeypatch, "dense", 5)
        _ref_cases, cases = _cases("A")
        want = [port.evaluate_grid_counts(cases) for _ in range(3)]
        pinned = port.pre_cache_stats()["pinned_bytes"]
        assert pinned > 0
        monkeypatch.setattr(api, "_PRE_CACHE_MAX_BYTES", pinned - 1)
        port = _engines(monkeypatch, "dense", 5)[1]
        if port._pre_bytes_estimate(len(cases)) > pinned - 1:
            pytest.fail("the estimate must pass the gate for this check")
        modes = []
        for w in want:
            assert port.evaluate_grid_counts(cases) == w
            modes.append(port.pre_cache_stats()["mode"])
        assert modes == ["fused", "split", "fused"]
        assert port._pre_cache is None
        assert port._pre_cache_declined == port._steady_state_args(cases)[0]


class _Precomputes:
    """Counts the precompute calls of the engine module."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = api._precompute

        def spy(*a, **kw):
            self.n += 1
            return real(*a, **kw)

        monkeypatch.setattr(api, "_precompute", spy)


# (plan, seed, extra pods, engine options): every kernel route of the
# dense counts call
ROUTES = [
    ("packed", 0, 4, {}),
    ("tiered", 5, 0, {}),
    ("dense", 0, 4, {}),
    ("dense", 1, 7, {"compact": False}),
    ("dense", 5, 13, {"slab": "1"}),
]


class TestSteadyCounts:
    @pytest.mark.parametrize("plan,seed,extra,kw", ROUTES)
    def test_steady_equals_first(self, monkeypatch, plan, seed, extra, kw):
        """Every kernel route: the split and steady calls equal the
        first; a steady call runs no precompute (the engine's counter and
        a spy agree) and its counts equal the plain fused call's."""
        _tiny_slab(monkeypatch)
        _ref, port = _engines(monkeypatch, plan, seed, extra, **kw)
        cases = _cases("A")[1]
        spy = _Precomputes(monkeypatch)
        first = port.evaluate_grid_counts(cases)
        for mode in ("split", "steady", "steady"):
            before = port.pre_cache_stats()
            assert port.evaluate_grid_counts(cases) == first
            after = port.pre_cache_stats()
            assert after["mode"] == mode
            if mode == "steady":
                assert after["hits"] == before["hits"] + 1
                assert after["precomputes"] == before["precomputes"]
        assert spy.n == port.pre_cache_stats()["precomputes"] == 2
        assert port._counts_dense(cases, plain=True) == first
        assert port.pre_cache_stats()["hits"] == 2  # plain=True leaves the machine alone
        assert port.evaluate_grid_counts(cases, backend="xla") == first

    def test_pinned_nz_maps(self, monkeypatch):
        """with_nz_maps pins K5's maps beside its operands; single-chunk
        operands (K4) get none; counts_from_ops gives the same counts."""
        monkeypatch.setattr(dk, "KT", 128)
        rng = np.random.default_rng(3)
        n, q = 200, 2
        args = [
            torch.from_numpy(rng.random((300, n)) < 0.05), torch.from_numpy(rng.random(n) < 0.7),
            torch.from_numpy(rng.random((300, n, q)) < 0.1).to(torch.bfloat16),
            torch.from_numpy(rng.random((40, n)) < 0.05), torch.from_numpy(rng.random(n) < 0.7),
            torch.from_numpy(rng.random((40, n, q)) < 0.1).to(torch.bfloat16),
        ]
        valid = torch.arange(n) < 190
        ops = dk.dense_operands(*args, valid, valid, bs=64)
        assert not dk.single_chunk(ops)
        pinned = dk.with_nz_maps(ops)
        assert all(torch.equal(a, b) for a, b in zip(pinned["nz"], dk._nz_maps(ops)))
        assert torch.equal(dk.counts_from_ops(pinned), dk.counts_from_ops(ops))
        small = dk.dense_operands(*[a[:100] if i % 3 != 1 else a for i, a in enumerate(args)],
                                  valid, valid, bs=64)
        assert dk.single_chunk(small) and "nz" not in dk.with_nz_maps(small)

    def test_packed_ops_compose(self, monkeypatch):
        """packed_operands + counts_from_packed_ops is verdict_counts_packed."""
        _ref, port = _engines(monkeypatch, "packed", 2, 5)
        pre = api._precompute(port._dense_counts_tensors(_cases("A")[1]), True)
        e, ig = pre["egress"], pre["ingress"]
        args = (e["tmatch_pk"], e["has_target"], e["tallow_pk"],
                ig["tmatch_pk"], ig["has_target"], ig["tallow_pk"])
        ops = pk.packed_operands(*args, n_pods=port.n_pods)
        assert ops["bs"] == pk.PACKED_BS
        want = pk.verdict_counts_packed(*args, n_pods=port.n_pods)
        assert torch.equal(pk.counts_from_packed_ops(ops), want)
        assert torch.equal(pk.counts_from_packed_ops(ops, plain=True), want)


def _to_autotune(monkeypatch, seed=35, extra=10, port_kw=None, autotune="1"):
    """A dense engine with a slab plan whose choice is left open, so the
    split call pins for the autotune and the first steady-state call
    runs it (the slab "auto" mode plans on a CUDA device only)."""
    _tiny_slab(monkeypatch)
    monkeypatch.setenv("CYCLONUS_AUTOTUNE", autotune)
    monkeypatch.setenv("CYCLONUS_AUTOTUNE_REPS", "1")
    monkeypatch.setenv("CYCLONUS_AUTOTUNE_ROUNDS", "2")
    _ref, port = _engines(monkeypatch, "dense", seed, extra, slab="1", **(port_kw or {}))
    cases = _cases("A")[1]
    first = port.evaluate_grid_counts(cases)
    assert port._slab_choice is True
    port._slab_choice = None
    assert port.evaluate_grid_counts(cases) == first
    pin = port._pre_cache[1]
    assert pin["ops"] is not None and pin["pre"] is not None
    return port, cases, first


class TestAutotune:
    def test_search_mechanics(self, monkeypatch):
        """The first steady-state call times both kernels from the pin,
        records a choice, keeps only what the winner reads, and returns
        the counts; later calls run the winner without a search."""
        port, cases, first = _to_autotune(monkeypatch)
        assert port.evaluate_grid_counts(cases) == first
        st = port.pre_cache_stats()
        assert st["autotune_searches"] == 1 and st["mode"] == "steady"
        stats = port._autotune_stats
        assert stats["source"] == "search"
        assert [c["kernel"] for c in stats["candidates"]] == ["default", "slab"]
        assert all(len(c["rounds"]) == 2 for c in stats["candidates"])
        key = port._pre_cache[0]
        if port._slab_choice:
            assert port._slab_ops_cache[0] == key
            assert port._pre_cache[1] == {"ops": None, "pre": None}
        else:
            assert port._slab_ops_cache is None and port._pre_cache[1]["pre"] is None
        assert port.evaluate_grid_counts(cases) == first
        assert port.pre_cache_stats()["autotune_searches"] == 1

    @pytest.mark.parametrize("slab_s,chose", [(0.5, True), (0.95, False), (2.0, False)])
    def test_choice_by_margin(self, monkeypatch, slab_s, chose):
        """K6 is kept only if it beats the default by the noise floor
        (10% here: the default's rounds agree)."""
        port, cases, first = _to_autotune(monkeypatch)
        real = TorchPolicyEngine._timed_rounds
        calls = []

        def timed(dispatch):
            _best, _rounds, out = real(dispatch)
            s = 1.0 if not calls else slab_s
            calls.append(s)
            return s, [s, s], out

        monkeypatch.setattr(TorchPolicyEngine, "_timed_rounds", staticmethod(timed))
        assert port.evaluate_grid_counts(cases) == first
        assert port._slab_choice is chose and len(calls) == 2
        assert (port._slab_ops_cache is not None) == chose
        assert port.evaluate_grid_counts(cases) == first

    def test_enabled_after_the_split(self, monkeypatch):
        """While the choice is open the pin keeps the precompute: with the
        autotune off the steady state runs the default kernel, and turned
        on later it still searches from the pin."""
        port, cases, first = _to_autotune(monkeypatch, autotune="0")
        assert port.evaluate_grid_counts(cases) == first
        st = port.pre_cache_stats()
        assert st["mode"] == "steady" and st["autotune_searches"] == 0
        assert port._slab_choice is None and port._slab_ops_cache is None
        monkeypatch.setenv("CYCLONUS_AUTOTUNE", "1")
        assert port.evaluate_grid_counts(cases) == first
        assert port.pre_cache_stats()["autotune_searches"] == 1
        assert port._slab_choice in (True, False)

    def test_failing_candidate_raises(self, monkeypatch):
        """A slab kernel that fails fails the call: no fallback, no choice."""
        port, cases, _first = _to_autotune(monkeypatch)

        def failing(ops, plain=False):
            raise RuntimeError("slab kernel launch failed (simulated)")

        monkeypatch.setattr(dk, "verdict_counts_slab_from_ops", failing)
        with pytest.raises(RuntimeError, match="simulated"):
            port.evaluate_grid_counts(cases)
        assert port._slab_choice is None

    def test_persisted_winner_adopted(self, monkeypatch, tmp_path):
        """The search stores its winner; a new engine of the same shape
        adopts it with no search and equal counts."""
        path = tmp_path / "autotune.json"
        monkeypatch.setenv("CYCLONUS_AUTOTUNE_CACHE", str(path))
        port, cases, first = _to_autotune(monkeypatch)
        assert port.evaluate_grid_counts(cases) == first
        data = json.loads(path.read_text())
        (entry,) = data["entries"].values()
        assert entry["winner"] == port._autotune_stats["winner"]
        assert set(entry["timings"]) == {"default_s", "slab_s"}
        again, cases, first2 = _to_autotune(monkeypatch)
        assert first2 == first
        assert again.evaluate_grid_counts(cases) == first
        assert again.pre_cache_stats()["autotune_searches"] == 0
        assert again._autotune_stats["source"] == "cache"
        assert again._slab_choice is port._slab_choice

    def test_corrupt_cache_never_raises(self, monkeypatch, tmp_path):
        path = tmp_path / "autotune.json"
        monkeypatch.setenv("CYCLONUS_AUTOTUNE_CACHE", str(path))
        for junk in ("{not json", "[]", json.dumps({"v": 99, "entries": {}}),
                     json.dumps({"v": 1, "entries": {"k": {"winner": {"kernel": "packed"}}}})):
            path.write_text(junk)
            assert at.load_winner("k") is None
        port, cases, first = _to_autotune(monkeypatch)
        assert port.evaluate_grid_counts(cases) == first
        assert port.pre_cache_stats()["autotune_searches"] == 1
        assert json.loads(path.read_text())["v"] == at.CACHE_VERSION
        # a cache that cannot be written is reported, not raised
        monkeypatch.setenv("CYCLONUS_AUTOTUNE_CACHE", str(tmp_path))
        assert at.store_winner("k", {"kernel": "slab"}) is False
        for off in ("0", ""):
            monkeypatch.setenv("CYCLONUS_AUTOTUNE_CACHE", off)
            assert at.cache_path() is None and at.load_winner("k") is None
            assert at.store_winner("k", {"kernel": "slab"}) is False

    def test_modes(self, monkeypatch):
        """CYCLONUS_AUTOTUNE: "auto" tunes on a CUDA device only, "1"
        always, "0" never; the slab "auto" mode never plans on the CPU."""
        _ref, port = _engines(monkeypatch, "dense", 35, 10)
        for mode, want in (("auto", False), ("1", True), ("0", False), ("AUTO", False)):
            monkeypatch.setenv("CYCLONUS_AUTOTUNE", mode)
            assert port._autotune_enabled() is want
        _tiny_slab(monkeypatch)
        monkeypatch.setenv("CYCLONUS_AUTOTUNE", "1")
        _ref, port = _engines(monkeypatch, "dense", 35, 10, slab="auto")
        cases = _cases("A")[1]
        for _ in range(3):
            port.evaluate_grid_counts(cases)
        assert port._slab_plan_state is None and port._slab_choice is None
        assert port.pre_cache_stats()["autotune_searches"] == 0
        key = port._autotune_key(2)
        assert json.loads(key)["mesh"] == "cpu:cpu:1" and json.loads(key)["dtype"] == "int8"


class TestPipelined:
    @pytest.mark.parametrize("plan,kw", [("packed", {}), ("dense", {}), ("dense", {"slab": "1"})])
    def test_only_at_steady_state(self, monkeypatch, plan, kw):
        _tiny_slab(monkeypatch)
        _ref, port = _engines(monkeypatch, plan, 40, 7, **kw)
        cases = _cases("A")[1]
        assert port.counts_pipelined_eval_s(cases) is None
        want = port.evaluate_grid_counts(cases)
        assert port.counts_pipelined_eval_s(cases) is None
        port.evaluate_grid_counts(cases)
        dt, counts = port.counts_pipelined_eval_s(cases, reps=3)
        assert dt > 0 and counts == want
        assert port.counts_pipelined_eval_s(_cases("C")[1]) is None
        hits = port.pre_cache_stats()["hits"]
        port.evaluate_grid_counts(cases)
        assert port.pre_cache_stats()["hits"] == hits + 1

    @pytest.mark.parametrize("pack", [True, False])
    def test_class_route_always_measures(self, monkeypatch, pack):
        policies, pods, namespaces = fuzz_policies(2, 13)
        port = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cpu",
                                 class_compress="1", pack=pack)
        cases = _cases("A")[1]
        assert port._class_counts_eligible(len(cases))
        dt, counts = port.counts_pipelined_eval_s(cases, reps=2)
        assert dt > 0 and counts == port.evaluate_grid_counts(cases)
        assert port._pre_cache is None and port.pre_cache_stats()["misses"] == 0


class TestInvalidate:
    @pytest.mark.parametrize("plan", ["packed", "dense"])
    def test_back_to_fused(self, monkeypatch, plan):
        """invalidate_after_patch drops the pin and the keys on both
        engines alike: fused, split, steady again, with equal counts."""
        ref, port = _engines(monkeypatch, plan, 14)
        assert _walk(ref, port, "AAA")[-1] == "steady"
        ref.invalidate_after_patch()
        port.invalidate_after_patch()
        assert _state(port) == _state(ref) == (None, 0, None)
        assert _walk(ref, port, "AAA") == ["fused", "split", "steady"]

    def test_slab_off_until_rebuilt(self, monkeypatch):
        _tiny_slab(monkeypatch)
        monkeypatch.setenv("CYCLONUS_PALLAS_SLAB", "1")
        ref, port = _engines(monkeypatch, "dense", 35, 10)
        _walk(ref, port, "AAA")
        assert port._slab_ops_cache is not None
        ref.invalidate_after_patch()
        port.invalidate_after_patch()
        assert port._slab_ops_cache is None and port._slab_choice is None
        assert _walk(ref, port, "AAA") == ["fused", "split", "steady"]
        assert port._slab_plan_state is None and port._slab_ops_cache is None


@pytest.mark.cuda
class TestCudaSteady:
    @pytest.mark.parametrize("plan,seed,extra,kw", ROUTES)
    def test_steady_launches_only_the_kernel(self, monkeypatch, plan, seed, extra, kw):
        """On the card: each steady-state call launches its kernel once
        and runs no precompute; counts equal the CPU engine's, and so do
        the pipelined figure's."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels have no CPU mode")
        _tiny_slab(monkeypatch)
        monkeypatch.setenv("CYCLONUS_AUTOTUNE", "0")
        _ref, cpu = _engines(monkeypatch, plan, seed, extra, **kw)
        monkeypatch.setenv("CYCLONUS_PACK", "0" if plan == "dense" else "1")
        if plan == "tiered":
            fc = ref_fuzz.build_fuzz_case(seed)
            card = TorchPolicyEngine(tier_port_policy(fc.simplify, fc.netpols), fc.pods,
                                     fc.namespaces, tiers=port_tiers(fc.tiers),
                                     class_compress="0", device="cuda")
        else:
            policies, pods, namespaces = fuzz_policies(seed, extra)
            card = TorchPolicyEngine(port_policy(policies), pods, namespaces, device="cuda",
                                     class_compress="0", **kw)
        cases = _cases("A")[1]
        want = cpu.evaluate_grid_counts(cases)
        for _ in range(2):
            assert card.evaluate_grid_counts(cases) == want
        launches = {**dk.LAUNCHES, **pk.LAUNCHES}
        before = card.pre_cache_stats()
        assert card.evaluate_grid_counts(cases) == want
        ran = {k: v - launches[k] for k, v in {**dk.LAUNCHES, **pk.LAUNCHES}.items()}
        assert sum(ran.values()) == 1, ran
        after = card.pre_cache_stats()
        assert after["mode"] == "steady" and after["precomputes"] == before["precomputes"]
        _dt, counts = card.counts_pipelined_eval_s(cases, reps=3)
        assert counts == want
