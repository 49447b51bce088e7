"""The `churn` traffic kind: pod events on a seeded open-loop schedule
(reference/churn.py) from the mix's parameters, served by one closed
controller loop that applies each due batch and recounts the whole grid.
The system under test supplies apply(deltas) -> report, recount() ->
{ingress, egress, combined, cells} and sync().

  warm-up  `warmup_steps` controller steps, each an apply of
           `warmup_batch` events and a recount, drawn from the seed apart
           from the window's;
  window   the schedule's events due over `seconds`: each step applies
           every event due by its start as one batch, then recounts; the
           window closes when every event due in it has been answered by
           a recount that includes it (or a minute past its end);
  check    a sample of the window's recounts (`check_recounts`), drawn
           from the seed with the first and the last in it, against the
           plain reference (reference/netpol.py) at the cluster state
           each recount saw.

The control breaks the configuration's guarantee that every delta
applied before a recount is visible in it: each step recounts before it
applies its batch.
"""

from __future__ import annotations

import random
import time
from collections import Counter
from typing import Dict, List

from portbench.reference import bound, churn, netpol


def _prefix(d: Dict) -> str:
    return f"{d['kind']}/{d['namespace']}/{d['name']}:"


def warm_up(sut, inputs: Dict, mix: Dict, seed: int, seconds: float) -> Dict:
    """Warm up the cell's shapes; the plan of the window: its schedule, the
    state it starts from (the reference's start) and the port cases."""
    state = {f"{p[0]}/{p[1]}": p for p in inputs["pods"]}
    for deltas in churn.warmup_batches(mix, state, seed):
        report = sut.apply(deltas)
        if report.get("rejected"):
            raise RuntimeError(f"warm-up delta rejected: {report['rejected']}")
        sut.recount()
        sut.sync()
        churn.apply_deltas(state, deltas)
    return {"schedule": churn.schedule(mix, seconds, state, seed), "start": state,
            "cases": churn.cases(mix)}


def window(sut, plan: Dict, seconds: float, control: bool, rf) -> Dict:
    """{steps, events, window_s}: each step {start, apply_end, end (seconds
    after the window opened), events (indices), deltas (their count),
    applied (the deltas the service took), apply_s (its own report),
    apply_host_s, recount_s (host, ended by a device synchronise), mode,
    counts, error}; each event {due, answered, failed}."""
    schedule = plan["schedule"]
    clock = time.perf_counter
    n = len(schedule)
    events = [{"due": e["due"], "answered": None, "failed": False} for e in schedule]
    steps: List[Dict] = []
    nxt, waiting = 0, []
    give_up = seconds + 60.0
    t0 = clock()
    while nxt < n or waiting:
        now = clock() - t0
        if now > give_up:
            break
        if nxt < n and schedule[nxt]["due"] > now and not waiting:
            with rf("portbench.wait"):
                time.sleep(schedule[nxt]["due"] - now)
            continue
        batch = []
        while nxt < n and schedule[nxt]["due"] <= now:
            batch.append(nxt)
            nxt += 1
        deltas = [d for i in batch for d in schedule[i]["deltas"]]
        step = {"start": now, "events": batch, "deltas": len(deltas), "applied": [],
                "apply_s": None, "mode": None, "counts": None, "error": None}
        stale = None
        if control:
            stale = sut.recount()
            sut.sync()
        with rf("portbench.apply"):
            ta = clock()
            try:
                report = sut.apply(deltas) if deltas else {"seconds": 0.0, "mode": None,
                                                           "rejected": []}
                sut.sync()
            except Exception as e:  # the service rolled the batch back
                step["error"] = f"apply: {type(e).__name__}: {e}"
                report = None
            step["apply_host_s"] = clock() - ta
        if report is None:
            for i in batch:
                events[i]["failed"] = True
        else:
            rejected = {r.split(" ", 1)[0] for r in report.get("rejected") or []}
            step["applied"] = [d for d in deltas if _prefix(d) not in rejected]
            for i in batch:
                if any(_prefix(d) in rejected for d in schedule[i]["deltas"]):
                    events[i]["failed"] = True
            step["apply_s"] = report["seconds"]
            step["mode"] = report["mode"]
        step["apply_end"] = clock() - t0
        with rf("portbench.recount"):
            tr = clock()
            try:
                counts = sut.recount() if stale is None else stale
                sut.sync()
                step["counts"] = dict(counts)
            except Exception as e:
                step["error"] = f"recount: {type(e).__name__}: {e}"
            step["recount_s"] = clock() - tr
        step["end"] = clock() - t0
        waiting += [i for i in batch if not events[i]["failed"]]
        if step["counts"] is not None:
            for i in waiting:
                events[i]["answered"] = step["end"]
            waiting = []
        steps.append(step)
    return {"steps": steps, "events": events, "window_s": clock() - t0}


def _states(run):
    """Per step, the reference's state after its applied deltas (the same
    dict, folded in place)."""
    pods = dict(run.plan["start"])
    for step in run.steps:
        churn.apply_deltas(pods, step["applied"])
        yield pods


def check(run, device, seed: int):
    """(recounts checked, the numbers compared, each {value, limit}):
    recounts whose counts differ from the reference's, the largest gap of
    one count, and the recounts that raised."""
    rec = [i for i, s in enumerate(run.steps) if s["counts"] is not None]
    errors = sum(1 for s in run.steps if s["error"] and s["error"].startswith("recount"))
    picked = set()
    if rec:
        rng = random.Random(f"portbench.check.{seed}")
        picked = {rec[0], rec[-1]}
        rest = [i for i in rec if i not in picked]
        sample = run.mix.get("check_recounts", 6)
        picked |= set(rng.sample(rest, min(len(rest), max(0, sample - 2))))
    inp = run.inputs
    ps = netpol.PolicySet(inp["policies"], inp["anps"], inp["banp"])
    mismatched, gap, j = 0, 0, 0
    for i, (step, pods) in enumerate(zip(run.steps, _states(run))):
        if i not in picked:
            continue
        want = netpol.grid_counts(pods.values(), inp["namespaces"], inp["policies"],
                                  run.plan["cases"], device=device, policy_set=ps)
        got = step["counts"]
        diff = max(abs(int(got.get(k, -1)) - want[k]) for k in want)
        mismatched += diff > 0
        gap = max(gap, diff)
        j += 1
    return j, {
        "mismatched_recounts": {"value": mismatched, "limit": 0},
        "max_count_gap": {"value": gap, "limit": 0},
        "recount_errors": {"value": errors, "limit": 0},
    }


def work(run) -> List[Dict]:
    """Per step, the work its recount had to do (reference.bound.key_work
    at the state it counted)."""

    def key(p):
        return p[0], tuple(sorted(p[2].items()))

    inp = run.inputs
    start = run.plan["start"]
    keys = Counter(key(p) for p in start.values())
    pods = dict(start)
    ps = netpol.PolicySet(inp["policies"], inp["anps"], inp["banp"])
    out = []
    for s in run.steps:
        for d in s["applied"]:
            name = f"{d['namespace']}/{d['name']}"
            if name in pods:
                keys[key(pods[name])] -= 1
            churn.apply_deltas(pods, [d])
            if name in pods:
                keys[key(pods[name])] += 1
        out.append(bound.key_work(keys, inp["namespaces"], ps, run.plan["cases"], run.device))
    return out
