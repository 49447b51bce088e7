"""Per-test-case result journaling for crash-safe conformance runs.

The reference has no checkpoint/resume: a full `generate` run is one
process and a crash means rerunning all ~216 cases x perturbation waits
(SURVEY.md section 5).  Here each completed test case is appended to a JSONL
journal (flushed per line), and `--resume` skips cases already journaled.

Cases are keyed by "<index>:<description>": generated descriptions are NOT
unique (e.g. ingress/egress variants of the same perturbation share one),
so the position in the deterministic generated order disambiguates.  The
key is only stable for identical generator configuration; changing
include/exclude flags shifts indices and simply causes re-runs — never a
silent skip of an unexecuted case.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Set


class Journal:
    def __init__(self, path: str):
        self.path = path
        self._completed: Dict[str, dict] = {}
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entry = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn write from a crash mid-line
                    key = entry.get("key", entry.get("description"))
                    if key is not None:
                        self._completed[key] = entry

    def completed(self) -> Set[str]:
        return set(self._completed)

    def entries(self) -> List[dict]:
        return list(self._completed.values())

    def is_completed(self, key: str) -> bool:
        return key in self._completed

    def should_skip(self, key: str) -> bool:
        """Resume skips cases that ran to completion; cases journaled with a
        non-empty error (infra flakes, crashes mid-case) are re-run."""
        entry = self._completed.get(key)
        return entry is not None and not entry.get("error")

    def record(
        self,
        description: str,
        passed: bool,
        step_count: int,
        tags: Optional[List[str]] = None,
        error: str = "",
        key: Optional[str] = None,
    ) -> None:
        key = key if key is not None else description
        entry = {
            "key": key,
            "description": description,
            "passed": passed,
            "step_count": step_count,
            "tags": tags or [],
            "error": error,
            "ts": time.time(),
        }
        self._completed[key] = entry
        prefix = ""
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    # a previous crash tore a line mid-write: terminate it so
                    # this entry stays parseable
                    prefix = "\n"
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(prefix + json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())
