"""Peer version-skew harness of the port: the dynamic proof behind
tools/wirelint.py over cyclonus_tpu_torch/worker and /serve (a copy of
the reference package's tests/skewharness.py, its scenarios run on the
port's codecs, serve loop and engine).

The static pass proves the scanned emit/read sites agree with the
declared wire registry (cyclonus_tpu_torch/worker/wireregistry.py) and
that the registry agrees with the frozen golden wire_schema.json.  This
harness proves the declarations PREDICT live interop: it arms the
skew-view recorder (CYCLONUS_SKEWHARNESS=1, read once at import — the
strip contract) plus the reader-side wire checks
(CYCLONUS_SHAPE_CHECK=1), and for every registered message drives both
peer-skew directions through the REAL codecs and the REAL serve wire
loop, whose verdict service keeps its engine on --device:

  * older emitter -> newer reader: every version view synthesized by
    ``wireregistry.legacy_view`` round-trips the real parse/emit pair
    unchanged, and a pre-verdict-service Batch answers a bare epoch
    reply with ZERO state change,
  * newer emitter -> older reader: ``inject_unknown`` views parse
    IDENTICALLY to clean ones, and two live services fed clean vs
    unknown-injected lines answer equal replies under the registry's
    portable projection,
  * reply-epoch discipline: every verdict in a reply carries the
    reply's own Epoch stamp,
  * a malformed peer line (non-object payload, drifted key type) is
    rejected with the offending key NAMED,

plus a coverage census that fails if any registered optional key was
never exercised under skew in both directions.  The cross-package leg
(a port emitter read by the reference's codec and the reverse) needs
both packages and lives in tests/test_torch_wire.py.

    python torch_tools/skewharness.py [--device cpu] [--full] [--verbose]

The quick slice runs in tier-1 (tests/test_torch_wire.py, --device
cpu); --full adds the scaled mixed-version stream leg.  The last line
of the output is one JSON object (torch_tools/_harness.py).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

import _harness
from _harness import REPO

# the recorder is armed at wireregistry IMPORT (strip contract) and the
# reader-side checks at contracts import: set both flags before any
# cyclonus_tpu_torch import
_harness.arm(CYCLONUS_SKEWHARNESS="1", CYCLONUS_SHAPE_CHECK="1")


class HarnessFailure(AssertionError):
    """A live wire exchange diverged from the registry's declaration;
    the message names the scenario and the divergence."""


def _check(cond: bool, scenario: str, detail: str) -> None:
    if not cond:
        raise HarnessFailure(f"{scenario}: {detail}")


class Ctx:
    """Shared scenario context: small live services (8 pods across 2
    namespaces) built on demand — twin-parity legs need FRESH peers, so
    services are constructed per call from the same seed."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = device
        self.sweep: Optional[Dict] = None
        self.loop_messages: set = set()
        self._pods = None
        self._namespaces = None

    def cluster(self):
        if self._pods is None:
            from cyclonus_tpu_torch.cli.serve_cmd import synthetic_cluster

            self._pods, self._namespaces = synthetic_cluster(
                8, 2, self.seed
            )
        return self._pods, self._namespaces

    def fresh_service(self):
        from cyclonus_tpu_torch.serve import VerdictService

        pods, namespaces = self.cluster()
        return VerdictService(pods, namespaces, [], device=self.device)

    def full_batch_payload(self) -> dict:
        """A current-version Batch exercising every optional envelope
        key: trace context, a committing delta, and an answerable
        query between two real pods."""
        from cyclonus_tpu_torch.worker.model import Batch, Delta, FlowQuery

        pods, _ = self.cluster()
        src = f"{pods[0][0]}/{pods[0][1]}"
        dst = f"{pods[1][0]}/{pods[1][1]}"
        batch = Batch(
            namespace="", pod="", container="",
            trace_id="t-skew", parent_span="0.1",
            deltas=[Delta(
                kind="pod_add", namespace="ns0", name="skew-pod",
                labels={"pod": "p99", "app": "app1", "tier": "tier1"},
                ip="10.99.0.1",
            )],
            queries=[FlowQuery(src=src, dst=dst, port=80,
                               protocol="TCP")],
        )
        return json.loads(batch.to_json())


# --- scenarios --------------------------------------------------------------


def scenario_registry_sweep(ctx: Ctx) -> Dict:
    """Both skew directions for every registered message through the
    REAL model codecs, synthesized from the registry — plus the proof
    (via the armed recorder) that the views came from the registry
    helpers, not a hand-rolled copy that could drift."""
    from cyclonus_tpu_torch.worker import model, wireregistry

    wireregistry.drain()
    sweep = wireregistry.skew_sweep(model.CODECS)
    _check(
        not sweep["problems"], "sweep",
        f"skew round-trips diverged: {sweep['problems']}",
    )
    gaps = wireregistry.census_gaps(sweep)
    _check(not gaps, "sweep", f"census gaps: {gaps}")
    _check(
        sweep["keys"] == wireregistry.key_count(),
        "sweep",
        f"sweep saw {sweep['keys']} keys, registry declares "
        f"{wireregistry.key_count()}",
    )
    _check(
        sweep["skew_pairs_checked"] >= 40, "sweep",
        f"only {sweep['skew_pairs_checked']} skew pairs checked "
        f"(want >= 40: both directions x every message x versions)",
    )
    calls = set(wireregistry.drain())
    for op in ("legacy_view", "inject", "drop"):
        _check(
            op in calls, "sweep",
            f"registry helper {op!r} never recorded: the skew views "
            f"did not come from the registry",
        )
    ctx.sweep = sweep
    return {
        "pairs": sweep["skew_pairs_checked"],
        "keys": sweep["keys"],
        "messages": sweep["messages"],
    }


def scenario_manifest_pinned(ctx: Ctx) -> Dict:
    """The static extraction (tools/wirelint.py, AST-only) is
    byte-identical to the runtime manifest — the linter provably lints
    the real declarations."""
    from cyclonus_tpu_torch.worker import wireregistry

    tools_dir = os.path.join(REPO, "tools")
    if tools_dir not in sys.path:
        sys.path.insert(0, tools_dir)
    import wirelint

    reg = wirelint.load_registry(
        os.path.join(REPO, "cyclonus_tpu_torch", "worker", "wireregistry.py")
    )
    _check(reg is not None, "manifest", "static registry load failed")
    static = json.dumps(wirelint.build_manifest(reg), sort_keys=True)
    runtime = json.dumps(wireregistry.manifest(), sort_keys=True)
    _check(
        static == runtime, "manifest",
        "static manifest != wireregistry.manifest() (the linter is "
        "checking a drifted view of the protocol)",
    )
    return {"bytes": len(static)}


def scenario_reply_discipline(ctx: Ctx) -> Dict:
    """WR004 live: a verdict-bearing reply from the real loop stamps
    exactly one Epoch, equal to every verdict's own stamp, and the
    whole reply validates against the Reply declaration."""
    from cyclonus_tpu_torch.serve import loop as serve_loop
    from cyclonus_tpu_torch.worker import wireregistry

    svc = ctx.fresh_service()
    reply = serve_loop.handle_line(
        svc, json.dumps(ctx.full_batch_payload())
    )
    wireregistry.check_read("Reply", reply)
    declared = {k.name for k in wireregistry.message("Reply").keys}
    _check(
        set(reply) <= declared, "reply",
        f"loop reply carries undeclared keys: "
        f"{sorted(set(reply) - declared)}",
    )
    _check("Epoch" in reply, "reply", f"no Epoch stamp: {reply}")
    verdicts = reply.get("Verdicts") or []
    _check(bool(verdicts), "reply", "query line answered no verdicts")
    for v in verdicts:
        _check(
            v.get("Epoch") == reply["Epoch"], "reply",
            f"verdict epoch {v.get('Epoch')} != reply epoch "
            f"{reply['Epoch']} (mixed-epoch reply)",
        )
    _check(
        reply["Epoch"] == svc.epoch, "reply",
        f"reply epoch {reply['Epoch']} != service epoch {svc.epoch}",
    )
    ctx.loop_messages.update(
        {"Batch", "Reply", "Verdict", "Delta", "FlowQuery"}
    )
    return {"verdicts": len(verdicts), "epoch": reply["Epoch"]}


def scenario_older_emitter(ctx: Ctx) -> Dict:
    """Older emitter -> newer reader through the real loop: a peer at
    v1..v3 predates the verdict service, so its view of the same line
    (registry-synthesized) must answer a bare epoch reply and change
    NOTHING; after the real line commits, the skewed peer's service
    and a clean twin agree exactly."""
    from cyclonus_tpu_torch.serve import loop as serve_loop
    from cyclonus_tpu_torch.worker import wireregistry

    svc_skew = ctx.fresh_service()
    svc_twin = ctx.fresh_service()
    full = ctx.full_batch_payload()
    epoch0 = svc_skew.epoch
    for v in (1, 2, 3):
        view = wireregistry.legacy_view("Batch", full, v)
        reply = serve_loop.handle_line(svc_skew, json.dumps(view))
        _check(
            set(reply) == {"Epoch"} and reply["Epoch"] == epoch0,
            f"older.v{v}",
            f"pre-service view was not a no-op: {reply}",
        )
        _check(
            svc_skew.epoch == epoch0, f"older.v{v}",
            f"legacy view mutated state (epoch {svc_skew.epoch})",
        )
    reply_a = serve_loop.handle_line(svc_skew, json.dumps(full))
    reply_b = serve_loop.handle_line(svc_twin, json.dumps(full))
    strip = wireregistry.strip_nonportable
    _check(
        strip("Reply", reply_a) == strip("Reply", reply_b), "older",
        "a service that saw legacy no-op lines diverged from a clean "
        "twin on the same committed line",
    )
    return {"versions": 3, "epoch": svc_skew.epoch}


def scenario_newer_emitter(ctx: Ctx) -> Dict:
    """Newer emitter -> older reader through the real loop: unknown
    keys injected at every nesting level of the line must be ignored —
    twin services fed clean vs injected lines answer equal replies
    under the registry's portable projection."""
    from cyclonus_tpu_torch.serve import loop as serve_loop
    from cyclonus_tpu_torch.worker import wireregistry

    svc_a = ctx.fresh_service()
    svc_b = ctx.fresh_service()
    full = ctx.full_batch_payload()
    injected = wireregistry.inject_unknown("Batch", full)
    _check(
        injected != full, "newer",
        "inject_unknown produced no unknown keys",
    )
    reply_a = serve_loop.handle_line(svc_a, json.dumps(full))
    reply_b = serve_loop.handle_line(svc_b, json.dumps(injected))
    strip = wireregistry.strip_nonportable
    _check(
        strip("Reply", reply_a) == strip("Reply", reply_b), "newer",
        f"unknown keys changed the reply: "
        f"{strip('Reply', reply_a)} != {strip('Reply', reply_b)}",
    )
    _check(
        svc_a.epoch == svc_b.epoch, "newer",
        "unknown keys changed the commit",
    )
    return {"epoch": svc_a.epoch}


def scenario_malformed_rejected(ctx: Ctx) -> Dict:
    """check_wire_read live (CYCLONUS_SHAPE_CHECK=1): a non-object
    payload and a drifted-type key are rejected with the payload /
    offending key NAMED, not surfaced as a downstream KeyError."""
    from cyclonus_tpu_torch.utils import contracts
    from cyclonus_tpu_torch.worker.model import Batch, Result

    _check(contracts.CHECK, "malformed", "shape checks are not armed")
    try:
        Batch.from_json("[1, 2]")
    except contracts.ContractViolation as e:
        _check(
            "Batch" in str(e), "malformed",
            f"rejection does not name the payload: {e}",
        )
    else:
        raise HarnessFailure(
            "malformed: non-object Batch payload was accepted"
        )
    bad = {
        "Request": {"Key": "k", "Protocol": "TCP", "Host": "h",
                    "Port": 80},
        "Output": "", "Error": "", "LatencyMs": "fast",
    }
    try:
        Result.from_dict(bad)
    except contracts.ContractViolation as e:
        _check(
            "LatencyMs" in str(e), "malformed",
            f"rejection does not name the offending key: {e}",
        )
    else:
        raise HarnessFailure(
            "malformed: drifted-type LatencyMs was accepted"
        )
    return {"rejections": 2}


def scenario_delta_kinds_skew(ctx: Ctx) -> Dict:
    """Every wire Delta kind survives a newer peer's unknown keys: the
    injected envelope parses to the same emitted dict as the clean
    one (the kind lifecycle stays wire-stable under skew)."""
    from cyclonus_tpu_torch.worker import wireregistry
    from cyclonus_tpu_torch.worker.model import Delta

    for kind in Delta.KINDS:
        d = Delta(kind=kind, namespace="ns0", name="skew-n").to_dict()
        injected = wireregistry.inject_unknown("Delta", d)
        back = Delta.from_dict(injected).to_dict()
        _check(
            back == d, f"kinds.{kind}",
            f"unknown keys leaked through the Delta envelope: "
            f"{back} != {d}",
        )
    return {"kinds": len(Delta.KINDS)}


def scenario_scaled_stream(ctx: Ctx) -> Dict:
    """The slow leg (--full): a mixed-version stdio stream
    (clean, legacy-view, and unknown-injected lines interleaved)
    through the real run_stdio loop; every reply validates against the
    Reply declaration, and a clean twin fed only the effective lines
    lands on the same epoch and the same final verdicts."""
    import io

    from cyclonus_tpu_torch.serve import loop as serve_loop
    from cyclonus_tpu_torch.worker import wireregistry
    from cyclonus_tpu_torch.worker.model import Batch, Delta, FlowQuery

    pods, _ = ctx.cluster()
    src = f"{pods[0][0]}/{pods[0][1]}"
    dst = f"{pods[1][0]}/{pods[1][1]}"
    svc = ctx.fresh_service()
    svc_twin = ctx.fresh_service()
    lines: List[str] = []
    effective: List[str] = []
    for i in range(24):
        batch = Batch(
            namespace="", pod="", container="",
            deltas=[Delta(
                kind="pod_add", namespace="ns0", name=f"skew-{i}",
                labels={"pod": f"p{50 + i}", "app": "app1",
                        "tier": "tier1"},
                ip=f"10.99.1.{i}",
            )],
            queries=[FlowQuery(src=src, dst=dst, port=80,
                               protocol="TCP")],
        )
        payload = json.loads(batch.to_json())
        mode = i % 3
        if mode == 0:
            lines.append(json.dumps(payload))
            effective.append(json.dumps(payload))
        elif mode == 1:
            # a v1 peer's view: pre-service, must be a no-op
            lines.append(json.dumps(
                wireregistry.legacy_view("Batch", payload, 1)
            ))
        else:
            injected = wireregistry.inject_unknown("Batch", payload)
            lines.append(json.dumps(injected))
            effective.append(json.dumps(payload))
    out = io.StringIO()
    handled = serve_loop.run_stdio(
        svc, io.StringIO("\n".join(lines) + "\n"), out
    )
    _check(handled == len(lines), "stream", f"handled {handled}")
    replies = [json.loads(l) for l in out.getvalue().splitlines()]
    for reply in replies:
        wireregistry.check_read("Reply", reply)
        _check(
            "Error" not in reply, "stream",
            f"stream line answered an error: {reply}",
        )
    for line in effective:
        serve_loop.handle_line(svc_twin, line)
    _check(
        svc.epoch == svc_twin.epoch, "stream",
        f"mixed-version stream epoch {svc.epoch} != clean twin "
        f"{svc_twin.epoch}",
    )
    strip = wireregistry.strip_nonportable
    final_a = [strip("Verdict", v.to_dict()) for v in svc.query(
        [FlowQuery(src=src, dst=dst, port=80, protocol="TCP")]
    )]
    final_b = [strip("Verdict", v.to_dict()) for v in svc_twin.query(
        [FlowQuery(src=src, dst=dst, port=80, protocol="TCP")]
    )]
    _check(
        final_a == final_b, "stream",
        f"final verdicts diverged: {final_a} != {final_b}",
    )
    return {"lines": len(lines), "epoch": svc.epoch}


#: (name, fn, in_quick_slice)
SCENARIOS: List[Tuple[str, Callable[[Ctx], Dict], bool]] = [
    ("registry_sweep", scenario_registry_sweep, True),
    ("manifest_pinned", scenario_manifest_pinned, True),
    ("reply_discipline", scenario_reply_discipline, True),
    ("older_emitter", scenario_older_emitter, True),
    ("newer_emitter", scenario_newer_emitter, True),
    ("malformed_rejected", scenario_malformed_rejected, True),
    ("delta_kinds_skew", scenario_delta_kinds_skew, True),
    ("scaled_stream", scenario_scaled_stream, False),
]


def coverage_census(ctx: Ctx) -> Dict:
    """Every registered optional key must have been exercised under
    skew in BOTH directions, and the loop-visible messages must all
    have crossed the real wire loop."""
    from cyclonus_tpu_torch.worker import wireregistry

    _check(ctx.sweep is not None, "coverage", "sweep never ran")
    gaps = wireregistry.census_gaps(ctx.sweep)
    _check(
        not gaps, "coverage",
        f"registered keys never exercised under skew: {gaps}",
    )
    loop_expected = {"Batch", "Reply", "Verdict", "Delta", "FlowQuery"}
    missing = sorted(loop_expected - ctx.loop_messages)
    _check(
        not missing, "coverage",
        f"messages never driven through the live loop: {missing}",
    )
    return {
        "keys": ctx.sweep["keys"],
        "pairs": ctx.sweep["skew_pairs_checked"],
        "loop_messages": len(ctx.loop_messages),
    }


def run(
    *,
    quick: bool = True,
    only: Optional[List[str]] = None,
    seed: int = 0,
    device="cpu",
    log: Optional[Callable[[str], None]] = None,
) -> Dict[str, Dict]:
    """Run the scenario set on services whose engines live on `device`;
    raises HarnessFailure on the first divergence.  Returns per-scenario
    stats."""
    ctx = Ctx(seed, device)
    results: Dict[str, Dict] = {}
    for name, fn, in_quick in SCENARIOS:
        if only is not None:
            if name not in only:
                continue
        elif quick and not in_quick:
            continue
        stats = fn(ctx)
        results[name] = stats
        if log is not None:
            log(f"skewharness {name}: OK {stats}")
    if only is None:
        results["coverage_census"] = coverage_census(ctx)
        if log is not None:
            log(
                f"skewharness coverage_census: OK "
                f"{results['coverage_census']}"
            )
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = _harness.parser(__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--scenarios", nargs="*", default=None,
        help=f"subset (choices: {[n for n, _f, _q in SCENARIOS]})",
    )
    args = ap.parse_args(argv)
    device = _harness.resolve_device(args.device)
    results = run(
        quick=not args.full,
        only=args.scenarios,
        seed=args.seed,
        device=device,
        log=print if args.verbose else None,
    )
    print(
        f"skewharness: {len(results)} scenario(s) passed "
        f"({', '.join(sorted(results))}) on {device}",
        file=sys.stderr,
    )
    _harness.report("skew", device, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
