"""The `synthetic` cluster generator: the reference project's bench
cluster (reference/synthetic.py), plus the admin tier set that the
configuration names (`tiers`: null, or "bench" for bench_tiers).

The cluster is drawn from the configuration's `cluster_seed` where it
fixes one (the deployment is one cluster; the run's seed then varies the
traffic), else from the run's seed."""

import random

from portbench.reference import synthetic


def build(config, seed):
    rng = random.Random(config.get("cluster_seed", seed))
    pods, namespaces, policies = synthetic.build_synthetic(
        config["n_pods"], config["n_policies"], rng, config.get("n_namespaces"))
    anps, banp = [], None
    tiers = config.get("tiers")
    if tiers == "bench":
        anps, banp = synthetic.bench_tiers()
    elif tiers:
        raise ValueError(f"unknown admin tier set {tiers!r}")
    return {"pods": pods, "namespaces": namespaces, "policies": policies,
            "anps": anps, "banp": banp}
