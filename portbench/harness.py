"""The benchmark's harness: runs one cell once and prints its result line.

Everything that belongs to one configuration, traffic mix, system or
metric is found by name, each in a module of its own that a later cell
adds as a new file:

  the cell's entry in BENCHMARK.json names its configuration (the
  entry's `file`) and its mix (portbench/traffic/<mix>.json);
  the configuration's `generator` names its cluster generator,
  portbench/clusters/<generator>.py: build(config, seed) -> the inputs;
  the mix's `generator` names its traffic kind,
  portbench/generators/<generator>.py, which drives the window and judges
  it:
    warm_up(sut, inputs, mix, seed, seconds) -> the window's plan,
    window(sut, plan, seconds, control, rf) -> {steps, events, window_s},
    check(run, device, seed) -> (answers checked, {number: {value, limit}}),
    and optionally work(run) -> per step, the work its device call had;
  the mix's `system` names the system under test,
  portbench/systems/<system>.py: System(inputs, mix, device), with the
  calls its traffic kind makes, route() and close();
  each metric of BENCHMARK.json is read by portbench/metrics/<metric>.py,
  whose `read(run)` returns a number, or None when the run holds nothing
  to read.

One run: set-up (the inputs, the system over them, the traffic kind's
warm-up of the cell's own shapes), the window, then, after the system is
freed, the traffic kind's check against the plain reference.  Each event
of the window is {due, answered (seconds after the window opened, or
None), failed}; an event that failed or was never answered counts as
failed.  With trace on, torch.profiler records the whole window
(trace.py).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import re
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import trace as tracemod

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "cyclonus_tpu")


class HarnessError(Exception):
    """A run that cannot give a result: no result line is printed."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find_cell(bench: Dict, name: str):
    for cell in bench["workloads"]:
        if cell["name"] == name:
            for cfg in bench["configs"]:
                if cfg["name"] == cell["config"]:
                    return cell, cfg
            raise HarnessError(f"cell {name!r} names no configuration {cell['config']!r}")
    raise HarnessError(f"no cell {name!r} in BENCHMARK.json")


def metrics_for(bench: Dict, cell: str, traced: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list the cell, or list no cells."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_module(root: Path, folder: str, name: str):
    """portbench/<folder>/<name>.py under root, loaded from its file."""
    path = root / "portbench" / folder / f"{name}.py"
    if not path.is_file():
        raise HarnessError(f"{folder} has no module {name!r} at {path}")
    mod_name = f"portbench_{folder}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, metric: str) -> Callable:
    return load_module(root, "metrics", metric).read


class Run:
    """What a metric reader and a traffic kind's check read.

    cell, config, mix, seed, seconds, traced: the run's parameters;
    setup_s: process start to the window's first step;
    window_s: the window, from its start to the end of the step that
    answered its last event;
    steps, events: the traffic kind's window (steps carry the host times
    and answers of its calls; events {due, answered, failed});
    trace: a trace.DeviceTrace of the window, or None;
    inputs: the cluster generator's inputs; plan: the traffic kind's
    plan; generator: the traffic kind's module; device."""

    def __init__(self, **kw):
        self.generator = None
        self.__dict__.update(kw)
        self._work = None

    def recounts(self) -> List[Dict]:
        """The steps whose device call returned its counts."""
        return [s for s in self.steps if s.get("counts") is not None]

    def work(self) -> Optional[List[Dict]]:
        """Per step, the work of its device call, where the traffic kind
        reckons it; else None."""
        if self._work is None and getattr(self.generator, "work", None):
            self._work = self.generator.work(self)
        return self._work


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    traced: bool,
    *,
    root: Path = ROOT,
    device: str = "cuda",
    system=None,
    control: bool = False,
    t_start: Optional[float] = None,
    out=None,
    err=None,
) -> Dict:
    """Run one cell once; print its result line (and the numbers compared,
    last on standard error).  Returns the result.  `system` replaces the
    mix's system under test (System(inputs, mix, device)); `control` runs
    the traffic kind's control in its window."""
    out = out or sys.stdout
    err = err or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_json(root / "BENCHMARK.json")
    cell, cfg_entry = find_cell(bench, name)
    config = load_json(root / cfg_entry["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    cluster = load_module(root, "clusters", config["generator"])
    gen = load_module(root, "generators", mix["generator"])
    if system is None:
        system = load_module(root, "systems", mix["system"]).System
    readers = [(m, load_reader(root, m["name"])) for m in metrics_for(bench, name, traced)]
    dev = torch.device(device)

    inputs = cluster.build(config, seed)
    sut = system(inputs, mix, device)
    plan = gen.warm_up(sut, inputs, mix, seed, seconds)
    total = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else None
    print(f"route {json.dumps({'cell': name, 'seed': seed, 'device_total_bytes': total, **sut.route()})}",
          file=out, flush=True)
    gc.collect()

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    rf = torch.profiler.record_function if traced else (lambda _name: nullcontext())
    t_window = time.perf_counter()
    with rf("portbench.window"):
        win = gen.window(sut, plan, seconds, control, rf)
    if prof is not None:
        prof.__exit__(None, None, None)
    setup_s = t_window - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    dtrace = tracemod.reduce(prof) if prof is not None else None
    prof = None

    run = Run(cell=name, config=config, mix=mix, seed=seed, seconds=seconds, traced=traced,
              setup_s=setup_s, window_s=win["window_s"], steps=win["steps"],
              events=win["events"], trace=dtrace, inputs=inputs, plan=plan, generator=gen,
              device=dev)
    metrics = {}
    for m, read in readers:
        value = read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    sut.close()
    del sut
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checked, checks = gen.check(run, dev, seed)
    print(f"window {run.window_s:.3f} s, {len(run.steps)} steps; setup {setup_s:.3f} s; "
          f"reference check of {checked} answers {time.perf_counter() - t_check:.3f} s",
          file=err, flush=True)
    correct = checked > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise HarnessError(f"modules that the run may not load are loaded: {loaded}")

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": bool(correct),
        "attempted": len(run.events),
        "failed": sum(1 for e in run.events if e["failed"] or e["answered"] is None),
        "metrics": metrics,
        "device": device_info,
    }
    if dtrace is not None:
        device_info["busy_s"] = dtrace.busy_s
        device_info["window_s"] = dtrace.window_s
        result["breakdown"] = dtrace.breakdown()
    result["checked"] = checked
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return result
