"""Shared scaffolding of the port's dynamic harnesses
(torch_tools/{skew,state,race,plan,key}harness.py): the checkout on
sys.path, the common flags, the device check, and the one JSON line each
harness prints last.

Each harness arms its recorders through the environment before it
imports anything of cyclonus_tpu_torch (the flags are read once, at
import), so this module imports nothing of the package at its top.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def arm(**flags: str) -> None:
    """Set the harness's env flags, and keep the slab autotune's winners
    off disk; call before any package import."""
    os.environ.update(flags)
    os.environ.setdefault("CYCLONUS_AUTOTUNE_CACHE", "0")


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (default: the card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--full", action="store_true", help="every scenario, slow legs too")
    ap.add_argument("--verbose", action="store_true")
    return ap


def resolve_device(name: str):
    """The torch device `name`; exits 2 when it is a card and none is
    available (the harness never falls back to the CPU on its own)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"{os.path.basename(sys.argv[0])}: no CUDA device is available; "
              f"pass --device cpu", file=sys.stderr)
        sys.exit(2)
    return dev


def launches() -> Dict[str, int]:
    """Every counts kernel's launch count in this process."""
    from cyclonus_tpu_torch.engine import dense_kernel, packed_kernel

    return {**dense_kernel.LAUNCHES, **packed_kernel.LAUNCHES}


def report(name: str, device, results: Dict, child_launches: Optional[Dict[str, int]] = None,
           **extra) -> None:
    """The harness's last line: one JSON object with its results, any
    `extra` fields, and the kernel launches it made, those of its child
    processes (`child_launches`) added (chip_smoke.py sums them)."""
    counts = launches()
    for k, v in (child_launches or {}).items():
        counts[k] = counts.get(k, 0) + v
    print(json.dumps({"harness": name, "ok": True, "device": str(device),
                      "results": results, **extra, "launches": counts}, default=str))
