"""The verdict service's wire loop: JSON lines over stdin/stdout, one
Batch envelope in, one reply object out (the reference's serve/loop.py).

    {"Namespace":"","Pod":"","Container":"","Requests":[],
     "Deltas":[{"Kind":"pod_labels","Namespace":"x","Name":"a",
                "Labels":{"app":"web"}}],
     "Queries":[{"Src":"x/a","Dst":"y/b","Port":80,"Protocol":"TCP"}]}

replies

    {"Applied":1,"Mode":"incremental","Epoch":4,
     "Verdicts":[{"Query":{...},"Ingress":true,"Egress":true,
                  "Combined":true,"Epoch":4}]}

Deltas apply before queries on the same line, so a line's queries see
its own deltas (read-your-writes per line).  A malformed line answers
{"Error": ...} and the loop continues; EOF is the clean shutdown."""

from __future__ import annotations

import json
from typing import IO, Optional

from ..worker.model import Batch
from .service import AdmissionRejected, VerdictService


def run_stdio(
    service: VerdictService,
    in_stream: IO[str],
    out_stream: IO[str],
    max_lines: Optional[int] = None,
) -> int:
    """Serve until EOF (or max_lines, for tests); returns the number of
    lines handled."""
    handled = 0
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        handled += 1
        try:
            reply = handle_line(service, line)
        except Exception as e:  # a bad line must answer, not kill the loop
            reply = {"Error": f"{type(e).__name__}: {e}"}
        out_stream.write(json.dumps(reply) + "\n")
        out_stream.flush()
        if max_lines is not None and handled >= max_lines:
            break
    return handled


def handle_line(service: VerdictService, line: str) -> dict:
    batch = Batch.from_json(line)
    reply: dict = {}
    if batch.deltas:
        try:
            report = service.apply(batch.deltas)
        except AdmissionRejected as e:
            # SLO admission control refused the batch (nothing was
            # enqueued): report the back-pressure, still answer the
            # line's queries
            reply["Applied"] = 0
            reply["Admission"] = str(e)
        else:
            reply["Applied"] = report["applied"]
            reply["Mode"] = report["mode"]
            reply["Epoch"] = report["epoch"]
            if report.get("rejected"):
                reply["Rejected"] = report["rejected"]
    verdicts = service.query(batch.queries) if batch.queries else []
    if batch.queries:
        reply["Verdicts"] = [v.to_dict() for v in verdicts]
    if "Epoch" not in reply:
        reply["Epoch"] = verdicts[0].epoch if verdicts else service.epoch
    return reply
