"""Persisted winners of the engine's slab autotune.

TorchPolicyEngine._autotune_slab times the dense plan's default counts
kernel (K4/K5) against the slab kernel (K6) from the same pinned
operands, at the first steady-state call of a case set, and keeps the
winner for the engine's life.  The answer is a function of (shape
bucket, device, dtype plan) only, so this module keeps it on disk under
exactly that key: a later process with an equal key adopts the winner
with no search.

The cache is advisory.  A missing, truncated, version-skewed or
otherwise surprising file reads as empty (load_winner never raises), and
a failed write is a logged warning, never an error.  Writes are atomic
(a temporary file, then os.replace) and read-merge-write, so processes
tuning different keys keep each other's entries.

CYCLONUS_AUTOTUNE_CACHE: the cache file; "0" or "" turns persistence
off; unset, the per-user file _DEFAULT_PATH, apart from the reference
package's file so the two never share entries.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)

#: bump when the entry layout or the meaning of a winner changes: an entry
#: of another version reads as missing
CACHE_VERSION = 1

#: the winners an entry may name; anything else reads as missing
KNOWN_KERNELS = ("default", "slab")

_DEFAULT_PATH = os.path.join("~", ".cache", "cyclonus_tpu_torch", "autotune.json")


def cache_path() -> Optional[str]:  # never raises
    """The cache file, or None when persistence is off."""
    raw = os.environ.get("CYCLONUS_AUTOTUNE_CACHE")
    if raw is None:
        raw = _DEFAULT_PATH
    raw = raw.strip()
    if raw in ("", "0"):
        return None
    return os.path.expanduser(raw)


def make_key(shape_bucket: Dict[str, Any], device: str, dtype_plan: str) -> str:
    """The key of one tuned configuration: the shape bucket (the bucketed
    axes and flags that fix the candidates' operand shapes), the device
    string (kind, name and count) and the dtype plan.  Two processes with
    equal keys time the same launches on the same kind of card."""
    return json.dumps(
        {"shape": shape_bucket, "mesh": device, "dtype": dtype_plan},
        sort_keys=True,
        separators=(",", ":"),
    )


def _read_all(path: str) -> Dict[str, Any]:  # never raises
    """The file's entries, {} on any problem: missing, unreadable, not
    JSON, not a dict, another version, or entries that are not a dict."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    except Exception as e:  # advisory cache: any failure reads as empty
        log.debug("autotune cache unreadable (%s): %s", path, e)
        return {}
    if not isinstance(data, dict) or data.get("v") != CACHE_VERSION:
        return {}
    entries = data.get("entries")
    return entries if isinstance(entries, dict) else {}


def load_winner(key: str) -> Optional[Dict[str, Any]]:  # never raises
    """The persisted winner of `key` ({"kernel": "default" | "slab"}), or
    None: persistence off, no entry, or an entry that is not a winner."""
    path = cache_path()
    if path is None:
        return None
    entry = _read_all(path).get(key)
    if not isinstance(entry, dict):
        return None
    winner = entry.get("winner")
    if not isinstance(winner, dict) or winner.get("kernel") not in KNOWN_KERNELS:
        return None
    return winner


def store_winner(  # never raises
    key: str, winner: Dict[str, Any], timings: Optional[Dict[str, Any]] = None
) -> bool:
    """Persist `winner` (and its timings) under `key`: read the file,
    merge, write a temporary file beside it and replace.  True when
    written; a failure logs a warning and returns False, since a broken
    cache must not fail the evaluation that just finished its search."""
    path = cache_path()
    if path is None:
        return False
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        entries = _read_all(path)
        entries[key] = {"winner": dict(winner), "timings": dict(timings or {})}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", prefix=".autotune-")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump({"v": CACHE_VERSION, "entries": entries}, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True
    except Exception as e:  # advisory cache: report and go on
        log.warning("autotune cache write failed (%s): %s", path, e)
        return False
