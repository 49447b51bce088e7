"""The port's CLI (`python -m cyclonus_tpu_torch probe|generate|version`)
against the reference's (`python -m cyclonus_tpu`), on the CPU: the same
arguments, plus `--device cpu`, print the same report and write the same
journal.  Without a card and without `--device cpu` the commands raise,
and without `--mock` or `--loopback` they go to kubectl, as the
reference's do (the loopback paths: test_torch_loopback.py)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from cyclonus_tpu.cli import main as ref_main
from cyclonus_tpu_torch.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLE_EXAMPLE = os.path.join(REPO, "examples", "networkpolicies", "simple-example")


def run(main_fn, argv, capsys):
    rc = main_fn(argv)
    return rc, capsys.readouterr().out


class TestProbe:
    @pytest.mark.parametrize(
        "extra",
        [
            [],
            ["--noisy"],
            ["--noisy", "--probe-port", "80", "--probe-port", "serve-81-udp", "--probe-protocol", "UDP"],
        ],
        ids=["default", "noisy", "ports"],
    )
    def test_probe_equals_reference(self, extra, capsys):
        argv = ["probe", "--mock", "--perfect-cni", "--policy-path", SIMPLE_EXAMPLE] + extra
        rc, out = run(main, argv + ["--device", "cpu"], capsys)
        ref_rc, ref_out = run(ref_main, argv, capsys)
        assert rc == ref_rc == 0
        assert out == ref_out
        assert "0 wrong" in out

    def test_probe_oracle_engine_equals_cuda(self, capsys):
        argv = ["probe", "--mock", "--perfect-cni", "--noisy", "--policy-path", SIMPLE_EXAMPLE]
        _, cuda = run(main, argv + ["--device", "cpu"], capsys)
        _, oracle = run(main, argv + ["--engine", "oracle"], capsys)
        assert cuda == oracle


class TestGenerate:
    def test_journal_equals_reference(self, tmp_path, capsys):
        argv = ["generate", "--mock", "--perfect-cni", "--include", "deny-all", "--max-cases", "3"]
        port_journal, ref_journal = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
        rc, out = run(main, argv + ["--device", "cpu", "--journal", str(port_journal)], capsys)
        ref_rc, ref_out = run(ref_main, argv + ["--journal", str(ref_journal)], capsys)
        assert rc == ref_rc == 0
        assert out == ref_out

        def entries(path):
            rows = [json.loads(line) for line in path.read_text().splitlines()]
            for row in rows:
                del row["ts"]
            return rows

        port_rows = entries(port_journal)
        assert port_rows == entries(ref_journal)
        assert len(port_rows) == 3 and all(r["passed"] for r in port_rows)

    def test_dry_run_equals_reference(self, capsys):
        argv = ["generate", "--mock", "--dry-run", "--exclude", "none"]
        rc, out = run(main, argv + ["--device", "cpu"], capsys)
        ref_rc, ref_out = run(ref_main, argv, capsys)
        assert rc == ref_rc == 0
        assert out == ref_out
        assert "total: 216 test cases" in out


class TestNoFallback:
    @pytest.mark.parametrize(
        "argv",
        [
            ["probe", "--mock", "--perfect-cni"],
            ["generate", "--mock", "--perfect-cni", "--include", "deny-all", "--max-cases", "1"],
        ],
    )
    def test_no_card_raises(self, argv, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)

    @pytest.mark.parametrize("command", ["probe", "generate"])
    def test_only_mock_cluster(self, command, tmp_path, monkeypatch):
        """Neither --mock nor --loopback names the kubectl cluster (now
        ported, as the reference's), which needs kubectl on PATH: both
        packages raise the same KubeError; --mock with --loopback exits
        with the reference's one line."""
        monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
        errors = []
        for fn, extra in ((main, ["--device", "cpu"]), (ref_main, [])):
            with pytest.raises(Exception) as e:
                fn([command] + extra)
            errors.append((type(e.value).__name__, str(e.value)))
        assert errors[0] == errors[1] == ("KubeError", "kubectl not found on PATH")
        with pytest.raises(SystemExit) as e:
            main([command, "--mock", "--loopback", "--device", "cpu"])
        assert str(e.value) == "--mock and --loopback are mutually exclusive"


def test_module_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "cyclonus_tpu_torch", "version"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("cyclonus-tpu-torch version ")
    assert "jax" not in out.stdout
