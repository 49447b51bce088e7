"""The live-target pass on the card (the `cuda` mark; skipped without a
card): the hand-written OR and gather (csrc/packed_counts.cu
live_or_kernel, live_gather_kernel) against their plain versions, bit
for bit, on random operands with pad rows, at depths from a few steps to
past the gather's 48 KB of shared memory; a pinned verdict service,
untiered (K1) and under the benchmark's admin tiers (K3), through three
pod-patch batches, each recount running the pass before its launch and
counting what the plain version counts on the uncompacted pin; and a
launch whose targets are all live, which reads the live words back and
passes its operands through.  This
file imports no JAX, so it runs on a machine that has none:

    python3 -m pytest -m cuda tests/test_torch_live_targets_cuda.py -q
"""

import random

import numpy as np
import pytest
import torch

from cyclonus_tpu_torch import synthetic
from cyclonus_tpu_torch.engine import PortCase
from cyclonus_tpu_torch.engine import packed_kernel as pk
from cyclonus_tpu_torch.engine.kernel import pack_bool_words_torch
from cyclonus_tpu_torch.serve import VerdictService
from cyclonus_tpu_torch.telemetry import instruments as ti
from cyclonus_tpu_torch.worker.model import Delta

CASES = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the live-target kernels have no CPU mode")


def _ops(seed, q, te, tn, ns, nd, n_live_e, n_live_i):
    """Packed operands (CPU) with tmatch bits on n_live random targets a
    direction, tallow bits everywhere, a fifth of the rows invalid (and
    so zero), and the dst axis padded past the last pod."""
    rng = np.random.default_rng(seed)
    vs, vd = rng.random(ns) < 0.8, rng.random(nd) < 0.8

    def words(bits):
        return pack_bool_words_torch(torch.from_numpy(bits))

    def tmatch(t, n, n_live):
        sel = np.zeros(t, bool)
        sel[rng.choice(t, size=n_live, replace=False)] = True
        return (rng.random((t, n)) < 0.05) & sel[:, None]

    return pk.packed_operands(
        words(tmatch(te, ns, n_live_e)), torch.from_numpy(rng.random(ns) < 0.7),
        words(rng.random((te, nd, q)) < 0.1),
        words(tmatch(tn, nd, n_live_i)), torch.from_numpy(rng.random(nd) < 0.7),
        words(rng.random((tn, ns, q)) < 0.1),
        valid_src=torch.from_numpy(vs), valid_dst=torch.from_numpy(vd),
    )


def _to(ops, device):
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in ops.items()}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "seed,q,te,tn,ns,nd,n_live_e,n_live_i",
    # depths 16-160 words at a few live bits a word; one direction with no
    # live target; an ingress depth of 3,136 words, whose map and row tile
    # pass 48 KB of shared memory
    [(0, 2, 500, 900, 300, 700, 40, 70), (1, 3, 2000, 5000, 1000, 1300, 300, 900),
     (2, 1, 700, 300, 200, 129, 0, 50), (3, 1, 900, 100_000, 200, 256, 60, 3000)],
)
def test_kernels_match_plain(seed, q, te, tn, ns, nd, n_live_e, n_live_i):
    """The OR, then the gather at the depths the plain pass chose; then
    the counts through the card's wrapper, which runs the pass, equal to
    the plain version on the operands as given."""
    _need_card()
    ops = _ops(seed, q, te, tn, ns, nd, n_live_e, n_live_i)
    card = _to(ops, "cuda")
    live = pk._live_words(card["a_e"], card["a_i"])
    torch.cuda.synchronize()
    assert torch.equal(live.cpu(), torch.cat([pk._or_rows(ops["a_e"]), pk._or_rows(ops["a_i"])]))
    want = pk.live_targets(ops)
    assert want is not ops
    de = ops["a_e"].shape[1]
    words = {"egress": slice(0, de), "ingress": slice(de, None)}
    todo = [(card[name], live[words[d]], want[name].shape[-1])
            for d, pair in pk._DIRECTIONS.items() for name in pair
            if want[name].shape[-1] < ops[name].shape[-1]]
    got = pk._gather_live_cuda(todo)
    torch.cuda.synchronize()
    names = [name for d, pair in pk._DIRECTIONS.items() for name in pair
             if want[name].shape[-1] < ops[name].shape[-1]]
    assert names
    for name, out in zip(names, got):
        assert torch.equal(out.cpu(), want[name]), name
    assert torch.equal(pk.counts_from_packed_ops(card).cpu(),
                       pk.counts_from_packed_ops(ops, plain=True))


def _batch(svc, rng):
    """Four label changes and one remove-then-add of a random pod."""
    pods = list(svc.pods.values())
    out = [Delta(kind="pod_labels", namespace=ns, name=name,
                 labels={**labels, "app": f"app{rng.randrange(20)}"})
           for ns, name, labels, _ip in rng.sample(pods, 4)]
    ns, name, labels, ip = rng.choice(pods)
    out.append(Delta(kind="pod_remove", namespace=ns, name=name))
    out.append(Delta(kind="pod_add", namespace=ns, name=name, labels=labels, ip=ip))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tiered", [False, True])
def test_pinned_service_compacts_before_each_launch(tiered):
    """20,480 pods in 400 namespaces, 10,000 policies, as the benchmark's
    cluster: a namespace's pods carry one of the 20 apps, so most targets
    select no pod.  Each recount of the pinned
    engine runs the pass (LAUNCHES), compacts (the counter) and counts
    what the plain version counts on the pin."""
    _need_card()
    pods, namespaces, policies = synthetic.build_synthetic(20480, 10000, random.Random(24),
                                                           n_ns=400)
    tiers = synthetic.bench_tiers() if tiered else None
    svc = VerdictService(pods, namespaces, policies, device="cuda", tiers=tiers,
                         class_compress="0")
    eng = svc.engine
    rng = random.Random(2024 + tiered)
    kernel = "packed_counts_tiered" if tiered else "packed_counts"
    for _ in range(2):  # the warm-up: fused, then split (pins)
        svc.apply(_batch(svc, rng))
        eng.evaluate_grid_counts(CASES)
    for i in range(3):
        assert svc.apply(_batch(svc, rng))["mode"] == "incremental"
        launches, compactions = dict(pk.LAUNCHES), ti.PACKED_COMPACTIONS.value()
        got = eng.evaluate_grid_counts(CASES)
        assert eng.pre_cache_stats()["mode"] == "steady", i
        ran = {k: v - launches[k] for k, v in pk.LAUNCHES.items() if v != launches[k]}
        assert ran == {kernel: 1, "live_targets": 1}, (i, ran)
        assert ti.PACKED_COMPACTIONS.value() == compactions + 1, i
        for d in ("egress", "ingress"):
            assert (ti.PACKED_CONTRACTION_WORDS.value(direction=d, depth="launched")
                    < ti.PACKED_CONTRACTION_WORDS.value(direction=d, depth="encoded")), (i, d)
        pin = eng._pre_cache[1]["ops"]
        plain = pk.sum_partials(pk.counts_from_packed_ops(pin, plain=True), len(CASES), eng.n_pods)
        assert got == plain, i


@pytest.mark.cuda
def test_all_live_launch_passes_its_operands_through():
    """A launch 16 words deep a direction whose targets are all live (as
    the class route's, compacted at encode time): the OR runs on the card,
    no gather, the skip is counted and the wrapper launches K1 on the
    operands as given, counting what the plain version counts."""
    _need_card()
    card = _to(_ops(5, 2, 300, 300, 4000, 4096, 300, 300), "cuda")
    assert card["a_e"].shape[1] == card["a_i"].shape[1] == 16
    launches, skips = pk.LAUNCHES["live_targets"], ti.PACKED_COMPACTION_SKIPS.value()
    assert pk.live_targets(card) is card
    assert pk.LAUNCHES["live_targets"] == launches + 1
    assert ti.PACKED_COMPACTION_SKIPS.value() == skips + 1
    got = pk.counts_from_packed_ops(card)
    assert torch.equal(got, pk.counts_from_packed_ops(card, plain=True))
