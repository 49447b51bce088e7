"""The dense precompute's ip leg on the card (the `cuda` mark; skipped
without a card): the new leg's tallow_pk equals the per-row formula's,
word for word, per direction and case, at the benchmark's sizes: the
np-100k policy set at 100,352 bucketed pods (ipBlocks with excepts: the
row-by-row blocks), and the np-100k-egress configuration's 100,000
allowlisted CIDRs over its first 8,192 pods (the tuple-space partition).
The per-row formula forms [P, N] int64 temporaries, which is why the
second case keeps 8,192 pods.  This file imports no JAX:

    python3 -m pytest -m cuda tests/test_torch_egress_allowlists_cuda.py -q
"""

import json
import random

import pytest
import torch

from cyclonus_tpu_torch.engine import TorchPolicyEngine, tiled
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.matcher import build_network_policies

from portbench.clusters import egress
from portbench.reference import synthetic
from test_torch_egress_allowlists import CASES, old_tallow_pk

REPO_CONFIG = "portbench/configs/np-100k-egress.json"


def _engine(pods, namespaces, policies):
    policy_set = build_network_policies(True, [parse_policy_dict(p) for p in policies])
    return TorchPolicyEngine(policy_set, pods, namespaces, device="cuda", compact=False)


def _assert_leg_equal(eng):
    t = eng._dense_counts_tensors(CASES)
    new = tiled._precompute(t, True, eng._ip_legs_for())
    new = {d: new[d]["tallow_pk"] for d in ("ingress", "egress")}
    torch.cuda.synchronize()
    old = old_tallow_pk(t)
    for d in ("ingress", "egress"):
        assert new[d].shape == old[d].shape, d
        assert torch.equal(new[d], old[d]), d
    return eng._ip_legs_for()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check runs at the benchmark's sizes")
    torch.cuda.empty_cache()
    yield
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_np_100k_policy_set(card):
    pods, namespaces, policies = synthetic.build_synthetic(100000, 10000, random.Random(20260729), 400)
    eng = _engine(pods, namespaces, policies)
    assert int(eng._tensors["pod_ns_id"].shape[0]) == 100352
    legs = _assert_leg_equal(eng)
    assert legs["ingress"]["n_block"] > 1000 and legs["ingress"]["n_part"] == 0


@pytest.mark.cuda
def test_np_100k_egress_allowlists_at_8192_pods(card):
    with open(REPO_CONFIG) as f:
        config = json.load(f)
    inputs = egress.build(config, 0)
    eng = _engine(inputs["pods"][:8192], inputs["namespaces"], inputs["policies"])
    legs = _assert_leg_equal(eng)
    assert legs["egress"]["n_part"] > 80000 and legs["egress"]["n_block"] > 10000
