"""The benchmark's one traffic generator: a seeded, open-loop schedule of
pod events, read from a mix file (portbench/traffic/<mix>.json).

The event mix is a frozen copy of the reference project's serve churn
(bench.py's serve leg, chip_smoke.serve_stream): a pod label change with
random `pod`/`app`/`tier` values, or a remove-then-add of the same pod
with its labels and address.  Reshaped as a schedule: every seed gets the
same number of events, the same share of each kind and the same set of
gaps between arrivals (the quantiles of an exponential distribution at
the mix's rate, so the arrivals look like a Poisson process); the seed
picks their order, the pods and the new labels.  So two seeds do the same
amount of work, in another order.

Events are plain dicts, {"due": seconds after the window opens, "deltas":
[{"kind", "namespace", "name", "labels"?, "ip"?}]}; the deltas of one event
are applied together.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Sequence, Tuple

#: event kinds a mix may weight (see event_deltas)
KINDS = ("pod_labels", "pod_remove_add")


def _labels(rng: random.Random, mix: dict) -> Dict[str, str]:
    return {k: f"{prefix}{rng.randrange(n)}" for k, (prefix, n) in mix["labels"].items()}


def event_deltas(kind: str, rng: random.Random, mix: dict, key: str, pod: tuple) -> List[dict]:
    ns, name = key.split("/", 1)
    if kind == "pod_labels":
        return [{"kind": "pod_labels", "namespace": ns, "name": name,
                 "labels": _labels(rng, mix)}]
    if kind == "pod_remove_add":
        return [{"kind": "pod_remove", "namespace": ns, "name": name},
                {"kind": "pod_add", "namespace": ns, "name": name,
                 "labels": dict(pod[2]), "ip": pod[3]}]
    raise ValueError(f"unknown event kind {kind!r}")


def _kinds(mix: dict, n: int) -> List[str]:
    """Exactly the mix's share of each kind among n events (largest
    remainders), in kind order."""
    weights = mix["events"]
    for k in weights:
        if k not in KINDS:
            raise ValueError(f"unknown event kind {k!r} in the mix")
    total = sum(weights.values())
    exact = {k: n * w / total for k, w in weights.items()}
    count = {k: int(v) for k, v in exact.items()}
    for k in sorted(exact, key=lambda k: count[k] - exact[k])[: n - sum(count.values())]:
        count[k] += 1
    return [k for k in weights for _ in range(count[k])]


def gaps(rate: float, n: int) -> List[float]:
    """The n quantiles (i + 0.5) / n of an exponential distribution of
    mean 1 / rate."""
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


def schedule(mix: dict, seconds: float, pods: Dict[str, tuple], seed: int) -> List[dict]:
    """The window's events, due in [0, seconds), in order of due time.
    `pods` is the state when the window opens (key -> (ns, name, labels,
    ip)); events pick pods from its keys, and a remove-then-add re-adds
    the pod as the state holds it at that event."""
    rng = random.Random(f"portbench.churn.{seed}")
    n = max(1, round(mix["rate_per_s"] * seconds))
    g = gaps(mix["rate_per_s"], n)
    rng.shuffle(g)
    # scale the arrivals so that the last one falls inside the window
    scale = seconds * n / (n + 1) / sum(g)
    kinds = _kinds(mix, n)
    rng.shuffle(kinds)
    keys = sorted(pods)
    state = dict(pods)
    out, t = [], 0.0
    for gap, kind in zip(g, kinds):
        t += gap * scale
        key = keys[rng.randrange(len(keys))]
        deltas = event_deltas(kind, rng, mix, key, state[key])
        apply_deltas(state, deltas)
        out.append({"due": t, "deltas": deltas})
    return out


def warmup_batches(mix: dict, pods: Dict[str, tuple], seed: int) -> List[List[dict]]:
    """The set-up's batches of deltas, drawn from the seed apart from the
    window's: `warmup_steps` batches (default 1) of `warmup_batch` events
    (default 1) of the mix's first kind, so that set-up applies batches of
    the size the window will."""
    rng = random.Random(f"portbench.warmup.{seed}")
    keys = sorted(pods)
    state = dict(pods)
    kind = next(iter(mix["events"]))
    out = []
    for _ in range(mix.get("warmup_steps", 1)):
        batch = []
        for _ in range(mix.get("warmup_batch", 1)):
            key = keys[rng.randrange(len(keys))]
            deltas = event_deltas(kind, rng, mix, key, state[key])
            apply_deltas(state, deltas)
            batch += deltas
        out.append(batch)
    return out


def apply_deltas(pods: Dict[str, tuple], deltas: Sequence[dict]) -> None:
    """Fold pod deltas into a plain state dict (key -> (ns, name, labels, ip))."""
    for d in deltas:
        key = f"{d['namespace']}/{d['name']}"
        if d["kind"] == "pod_labels":
            if key in pods:
                ns, name, _labels, ip = pods[key]
                pods[key] = (ns, name, dict(d["labels"]), ip)
        elif d["kind"] == "pod_remove":
            pods.pop(key, None)
        elif d["kind"] == "pod_add":
            pods[key] = (d["namespace"], d["name"], dict(d.get("labels") or {}), d["ip"])
        else:
            raise ValueError(f"unknown delta kind {d['kind']!r}")


def cases(mix: dict) -> List[Tuple[int, str, str]]:
    return [tuple(c) for c in mix["cases"]]
