"""The column-patched pin on the card (the `cuda` mark; skipped without a
card): a verdict service at 4,096 pods, untiered (K1) and under the
benchmark's admin tiers (K3), through 50 seeded pod batches of label
changes and remove-then-adds.  After each batch the recount launches the
counts kernel once, after one live-target pass (its own launch count:
the pin is encoded at compact=False, deeper than one step), opens
engine.pre_patch and not engine.precompute,
and counts what a freshly built engine of the same state counts.  This
file imports no JAX, so it runs on a machine that has none:

    python3 -m pytest -m cuda tests/test_torch_pre_patch_cuda.py -q
"""

import random

import pytest
import torch

from cyclonus_tpu_torch import synthetic
from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine
from cyclonus_tpu_torch.engine import packed_kernel as pk
from cyclonus_tpu_torch.serve import VerdictService
from cyclonus_tpu_torch.utils import tracing
from cyclonus_tpu_torch.worker.model import Delta

N_PODS, N_POLICIES, BATCHES = 4096, 200, 50
CASES = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "serve-81-udp", "UDP")]


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


def _span_counts():
    st = tracing.stats()
    return {k: int(st.get(k, {}).get("count", 0)) for k in ("engine.pre_patch", "engine.precompute")}


@pytest.mark.cuda
@pytest.mark.parametrize("tiered", [False, True])
def test_patched_pin_on_the_card(tiered):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counts kernels have no CPU mode")
    pods, namespaces, policies = synthetic.build_synthetic(N_PODS, N_POLICIES, random.Random(22))
    tiers = synthetic.bench_tiers() if tiered else None
    svc = VerdictService(pods, namespaces, policies, device="cuda", tiers=tiers,
                         class_compress="0")
    eng = svc.engine
    rng = random.Random(2022 + tiered)
    kernel = "packed_counts_tiered" if tiered else "packed_counts"
    modes = []
    for _ in range(2):  # the warm-up: fused, then split (pins)
        assert svc.apply(_batch(svc, rng))["mode"] == "incremental"
        eng.evaluate_grid_counts(CASES)
        modes.append(eng.pre_cache_stats()["mode"])
    assert modes == ["fused", "split"]
    for i in range(BATCHES):
        assert svc.apply(_batch(svc, rng))["mode"] == "incremental" and svc.engine is eng
        launches, spans, st0 = dict(pk.LAUNCHES), _span_counts(), eng.pre_cache_stats()
        got = eng.evaluate_grid_counts(CASES)
        st = eng.pre_cache_stats()
        ran = {k: v - launches[k] for k, v in pk.LAUNCHES.items() if v != launches[k]}
        assert ran == {kernel: 1, "live_targets": 1}, (i, ran)
        assert _span_counts() == {"engine.pre_patch": spans["engine.pre_patch"] + 1,
                                  "engine.precompute": spans["engine.precompute"]}, i
        assert st["mode"] == "steady" and st["patches"] == st0["patches"] + 1, (i, st)
        if i % 10 == 9 or i == 0:
            fresh = TorchPolicyEngine(svc._policy, list(svc.pods.values()), dict(svc.namespaces),
                                      device="cuda", compact=False, class_compress="0",
                                      tiers=tiers)
            assert got == fresh.evaluate_grid_counts(CASES), i
            del fresh
    assert eng.pre_cache_stats()["precomputes"] == 2
