"""The `egress` cluster generator: the synthetic cluster and its policies
(reference/synthetic.py, as the `synthetic` generator draws them), plus
one egress allowlist policy per (namespace, tier label value)
(reference/allowlists.py), drawn from the same generator after the
cluster, with the configuration's `allowlists` parameters.

The cluster is drawn from the configuration's `cluster_seed` where it
fixes one (the deployment is one cluster; the run's seed then varies the
traffic), else from the run's seed.

A configuration's `cuda_alloc_conf` is the CUDA caching allocator's
setting of the deployment (PYTORCH_CUDA_ALLOC_CONF), applied here, before
the system under test allocates: the plain reference's check at this
size holds a [peers, pods] float32 copy of some 38 GB in each call, which
an allocator that splits its cached blocks cannot place twice on one
80 GB card."""

import os
import random

import torch

from portbench.reference import allowlists, synthetic


def build(config, seed):
    alloc = config.get("cuda_alloc_conf")
    if alloc and torch.cuda.is_available():
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        torch.cuda.memory._set_allocator_settings(alloc)
    rng = random.Random(config.get("cluster_seed", seed))
    pods, namespaces, policies = synthetic.build_synthetic(
        config["n_pods"], config["n_policies"], rng, config.get("n_namespaces"))
    shape = config["allowlists"]
    policies = policies + allowlists.allowlists(
        pods, namespaces, rng, shape["blocks_per_policy"], shape["tier_values"])
    return {"pods": pods, "namespaces": namespaces, "policies": policies,
            "anps": [], "banp": None}
