"""The port's chaos layer (cyclonus_tpu_torch/chaos) against the
reference's (cyclonus_tpu/chaos): spec parsing and fault budgets point
for point, the fault points of the port's serve apply and worker client,
the suite report of the in-process scenarios (backend_init_flake,
worker_wire, delta_drop) equal to the reference's apart from `seconds`
and `injected`, the poisoned autotune winners with the forced autotune,
the audit-divergence and SLO ttfv scenarios on `--device cpu` through a
real `serve` subprocess, and the `chaos` command."""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from cyclonus_tpu import chaos as ref_chaos
from cyclonus_tpu.chaos import harness as ref_harness
from cyclonus_tpu.engine import PortCase as RefCase
from cyclonus_tpu.engine import TpuPolicyEngine
from cyclonus_tpu.matcher.builder import build_network_policies as ref_build
from cyclonus_tpu_torch import chaos
from cyclonus_tpu_torch.chaos import harness
from cyclonus_tpu_torch.engine import autotune
from cyclonus_tpu_torch.engine import dense_kernel as dk
from cyclonus_tpu_torch.telemetry import instruments as ti

from bench import build_synthetic as ref_build_synthetic
from test_torch_engine import REPO

#: the scenarios that run in-process with no engine of their own choice
IN_PROCESS = ["backend_init_flake", "worker_wire", "delta_drop"]


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends disarmed in both packages: chaos state
    is process-global (the env var is the control surface)."""
    chaos.reset("")
    ref_chaos.reset("")
    yield
    chaos.reset("")
    ref_chaos.reset("")


SPECS = [
    "",
    "backend_init:2",
    "worker_wire_stall:1:0.01,delta_apply:3",
    "::,bad:notanint:x,,ok:1",
    "a:-4,b:0,c",
    "verdict_corrupt:1:1e9,delta_apply:2:zz",
    " worker_wire : 2 ",
]


class TestInjection:
    @pytest.mark.parametrize("spec", SPECS)
    def test_spec_parses_as_reference(self, spec):
        assert chaos._parse(spec) == ref_chaos._parse(spec)

    @pytest.mark.parametrize("spec", SPECS[1:])
    def test_budgets_fire_as_reference(self, spec):
        """The same spec armed in each package: the same points fire the
        same number of times, then disarm."""
        points = sorted(set(chaos._parse(spec)) | {"never_armed"})

        def drive(mod):
            mod.reset(spec)
            fired = []
            for _ in range(5):
                for p in points:
                    try:
                        mod.fire(p)
                        fired.append((p, False))
                    except mod.ChaosError as e:
                        assert e.point == p
                        fired.append((p, True))
            out = (fired, mod.injected(), [mod.armed(p) for p in points])
            mod.disarm()
            return out

        assert drive(chaos) == drive(ref_chaos)

    def test_disarmed_hooks_are_noops(self):
        chaos.fire("backend_init")
        assert chaos.stall("worker_wire_stall") == 0.0
        assert chaos.injected() == {}

    def test_stall_sleeps_its_arg(self):
        chaos.reset("worker_wire_stall:1:0.01")
        assert chaos.stall("worker_wire_stall") == pytest.approx(0.01)
        assert not chaos.armed("worker_wire_stall")
        assert chaos.stall("worker_wire_stall") == 0.0

    def test_env_change_rearms(self, monkeypatch):
        monkeypatch.setenv("CYCLONUS_CHAOS", "delta_apply:1")
        assert chaos.armed("delta_apply")
        monkeypatch.setenv("CYCLONUS_CHAOS", "")
        assert not chaos.armed("delta_apply")

    def test_stale_token_does_not_disarm(self):
        old = chaos.reset("delta_apply:1")
        chaos.reset("delta_apply:2")
        chaos.disarm(old)
        assert chaos.armed("delta_apply")

    def test_injections_counted_in_telemetry(self):
        before = ti.CHAOS_INJECTIONS.value(point="worker_wire")
        chaos.reset("worker_wire:1")
        with pytest.raises(chaos.ChaosError):
            chaos.fire("worker_wire")
        assert ti.CHAOS_INJECTIONS.value(point="worker_wire") == before + 1


class TestFaultPoints:
    def _batch(self):
        from cyclonus_tpu_torch.worker.model import Batch

        return Batch(namespace="x", pod="a", container="c", requests=[])

    def test_worker_wire_retries(self, monkeypatch):
        from cyclonus_tpu_torch.worker.client import Client

        monkeypatch.setenv("CYCLONUS_WORKER_BACKOFF_S", "0.01")
        chaos.reset("worker_wire:2")
        retries0 = ti.WORKER_RETRIES.value()
        assert Client(harness._InProcessKube()).batch(self._batch()) == []
        assert ti.WORKER_RETRIES.value() == retries0 + 2
        assert chaos.injected() == {"worker_wire": 2}

    def test_stall_trips_the_timeout_then_recovers(self, monkeypatch):
        from cyclonus_tpu_torch.worker.client import Client

        monkeypatch.setenv("CYCLONUS_WORKER_TIMEOUT_S", "0.3")
        monkeypatch.setenv("CYCLONUS_WORKER_BACKOFF_S", "0.01")
        chaos.reset("worker_wire_stall:1:5")

        class OkKube:
            def execute_remote_command(self, ns, pod, container, command):
                return "[]", "", None

        retries0 = ti.WORKER_RETRIES.value()
        assert Client(OkKube()).batch(self._batch()) == []
        assert ti.WORKER_RETRIES.value() == retries0 + 1

    def test_delta_apply_rolls_back(self):
        report = harness.scenario_delta_drop(seed=3, n_pods=12, device="cpu")
        assert report["ok"] and report["rolled_back"]
        assert [p["pods"] for p in report["parity"]] == [12, 12]
        assert report["injected"] == {"delta_apply": 1}


def strip(report):
    """A suite report without its timings and injection tallies."""
    out = json.loads(json.dumps(report, default=str))
    for r in out["scenarios"].values():
        r.pop("seconds", None)
        r.pop("injected", None)
    return out


class TestSuiteReport:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_in_process_report_equals_reference(self, seed):
        got = harness.run_all(seed=seed, only=IN_PROCESS, bound_s=120.0, device="cpu")
        want = ref_harness.run_all(seed=seed, only=IN_PROCESS, bound_s=120.0)
        assert got["ok"] and want["ok"]
        assert strip(got) == strip(want)
        for name in IN_PROCESS:
            assert got["scenarios"][name]["seconds"] >= 0

    def test_cli_json_equals_reference(self):
        proc = subprocess.run(
            [sys.executable, "-m", "cyclonus_tpu_torch", "chaos", "--device", "cpu", "--json",
             "--seed", "4"] + [a for s in IN_PROCESS for a in ("--scenario", s)],
            capture_output=True, text=True, timeout=300, cwd=REPO,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        got = json.loads(proc.stdout)
        want = ref_harness.run_all(seed=4, only=IN_PROCESS)
        assert strip(got) == strip(want)

    def test_run_all_needs_a_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            harness.run_all(only=["backend_init_flake"])


class TestPoisonedCaches:
    def test_every_mode_searches_again_with_equal_counts(self, tmp_path):
        """The forced autotune writes a winner; after each poisoning a
        fresh engine searches again and gives the first engine's counts,
        grid and pairs, which equal the reference engine's counts."""
        stores0 = ti.AUTOTUNE_CACHE.value(outcome="store")
        report = harness.scenario_poisoned_caches(seed=1, workdir=str(tmp_path), device="cpu")
        assert report["ok"] and report["rejected"] == report["entries_poisoned"] == 3
        assert set(report["modes"]) == set(harness.POISON_MODES)
        assert ti.AUTOTUNE_CACHE.value(outcome="store") == stores0 + 4
        pods, namespaces, policies = ref_build_synthetic(24, 4, random.Random(1))
        ref = TpuPolicyEngine(ref_build(True, policies), pods, namespaces)
        want = ref.evaluate_grid_counts([RefCase(80, "chaos-80-tcp", "TCP"),
                                         RefCase(81, "chaos-81-udp", "UDP")])
        assert report["counts"] == {k: int(v) for k, v in want.items()}
        # the last search left a readable winner; the tiles are restored
        data = json.loads((tmp_path / "autotune.json").read_text())
        assert data["v"] == autotune.CACHE_VERSION and len(data["entries"]) == 1
        assert (dk.SLAB_BS, dk.SLAB_BD) == (2048, 1024)
        assert os.environ.get("CYCLONUS_AUTOTUNE_CACHE") == "0"

    @pytest.mark.parametrize("mode", harness.POISON_MODES)
    def test_a_poisoned_file_reads_as_empty(self, mode, tmp_path, monkeypatch):
        path = tmp_path / "autotune.json"
        monkeypatch.setenv("CYCLONUS_AUTOTUNE_CACHE", str(path))
        assert autotune.store_winner("k", {"kernel": "slab"})
        assert autotune.load_winner("k") == {"kernel": "slab"}
        harness._poison_file(str(path), mode)
        assert autotune.load_winner("k") is None
        assert autotune.store_winner("k", {"kernel": "default"})
        assert autotune.load_winner("k") == {"kernel": "default"}


class TestServeScenarios:
    def test_audit_divergence_detected_within_budget(self, tmp_path):
        report = harness.scenario_audit_divergence(seed=0, workdir=str(tmp_path), device="cpu")
        assert report["ok"] and 1 <= report["detected_after_checks"] <= report["check_budget"]
        assert report["bundle_route"] == "serve.query.live"
        assert not (tmp_path / "audit-clean.json").exists()

    def test_slo_ttfv_breach_dump_names_the_objective(self, tmp_path):
        report = harness.scenario_slo_ttfv(seed=0, workdir=str(tmp_path), device="cpu")
        assert report["ok"] and report["breach_reason"] == "slo-breach:ttfv"
        assert report["restart"]["ttfv_s"] <= report["ttfv_budget_s"]
        assert report["restart"]["oracle_checked"] == 16

    @pytest.mark.slow
    def test_serve_kill_restart_bounds_ttfv(self, tmp_path):
        report = harness.scenario_serve_kill_restart(
            seed=1, workdir=str(tmp_path), n_pods=16, churn_steps=3, device="cpu")
        assert report["ok"] and report["ttfv_s"] <= report["ttfv_bound_s"]
        assert report["oracle_checked"] >= 16


class TestCli:
    def test_unknown_scenario_exits_2(self):
        proc = subprocess.run(
            [sys.executable, "-m", "cyclonus_tpu_torch", "chaos", "--device", "cpu",
             "--scenario", "nope"],
            capture_output=True, text=True, timeout=120, cwd=REPO,
        )
        assert proc.returncode == 2 and "unknown scenario" in proc.stderr

    def test_text_report(self, capsys):
        from cyclonus_tpu_torch.cli import main

        assert main(["chaos", "--device", "cpu", "--scenario", "worker_wire",
                     "--scenario", "poisoned_caches"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("chaos OK  worker_wire (") and out[0].endswith("retries=2")
        assert out[1].startswith("chaos OK  poisoned_caches (")
        assert out[1].endswith("rejected_entries=3")
        assert out[-1] == "chaos: all scenarios held"
