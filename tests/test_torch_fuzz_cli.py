"""The port's `fuzz` command and its `cuda-sharded` probe engine against
the reference's `fuzz` and the single-device engine, on the CPU: the
same arguments plus `--device cpu` print the same JSON report apart
from its seconds, a mismatch prints {"ok": false, ...} and exits 1, and
a probe over the mesh prints what the single-device probe prints."""

import json
import os

import pytest

from cyclonus_tpu.cli import main as ref_main
from cyclonus_tpu_torch.cli import main
from cyclonus_tpu_torch.tiers import fuzz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLE_EXAMPLE = os.path.join(REPO, "examples", "networkpolicies", "simple-example")


def run(main_fn, argv, capsys):
    rc = main_fn(argv)
    return rc, capsys.readouterr().out


def report(out):
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep.pop("seconds") >= 0
    return rep


class TestFuzzCli:
    @pytest.mark.parametrize(
        "argv",
        [
            ["--seeds", "2", "--cidr-seeds", "1", "--conformance"],
            ["--seed", "3", "--seeds", "1", "--cidr-seeds", "0", "--no-mesh", "--dense-only",
             "--no-counts", "--pair-samples", "4"],
        ],
        ids=["default", "flags"],
    )
    def test_json_report_equals_reference(self, argv, capsys):
        rc, out = run(main, ["fuzz", "--json", "--device", "cpu"] + argv, capsys)
        ref_rc, ref_out = run(ref_main, ["fuzz", "--json"] + argv, capsys)
        assert rc == ref_rc == 0
        got = report(out)
        assert got == report(ref_out)
        assert got["ok"] is True
        if "--no-mesh" in argv:
            assert got["mesh_cells_checked"] == 0
        else:
            assert got["mesh_cells_checked"] == got["cells_checked"] > 0
            assert got["conformance_cases"] == 10

    def test_text_report(self, capsys):
        rc, out = run(main, ["fuzz", "--device", "cpu", "--seeds", "1", "--cidr-seeds", "1"], capsys)
        assert rc == 0
        assert "seed 0: " in out and "cidr seed 0: " in out
        assert out.strip().splitlines()[-1].startswith("fuzz gate green: 1 seeds")

    def test_forced_mismatch_exits_1(self, capsys, monkeypatch):
        """An oracle table with one flipped cell: the gate prints
        {"ok": false, "error": ...} naming the seed, and exits 1."""
        real = fuzz._oracle_table

        def flipped(*args):
            want = real(*args)
            want[0, 0, 0, 2] = ~want[0, 0, 0, 2]
            return want

        monkeypatch.setattr(fuzz, "_oracle_table", flipped)
        rc, out = run(main, ["fuzz", "--json", "--device", "cpu", "--seeds", "1",
                             "--cidr-seeds", "0"], capsys)
        assert rc == 1
        rep = json.loads(out.strip().splitlines()[-1])
        assert rep["ok"] is False and rep["error"].startswith("seed 0 ")
        rc, out = run(main, ["fuzz", "--device", "cpu", "--seeds", "1", "--cidr-seeds", "0"], capsys)
        assert rc == 1 and "FUZZ GATE FAILED: seed 0 " in out

    def test_needs_a_device(self, capsys, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["fuzz", "--seeds", "1", "--cidr-seeds", "0"])


class TestShardedProbe:
    @pytest.mark.parametrize("extra", [[], ["--noisy"]], ids=["default", "noisy"])
    def test_probe_sharded_equals_cuda(self, extra, capsys):
        argv = ["probe", "--mock", "--perfect-cni", "--device", "cpu",
                "--policy-path", SIMPLE_EXAMPLE] + extra
        rc, cuda = run(main, argv + ["--engine", "cuda"], capsys)
        rc_s, mesh = run(main, argv + ["--engine", "cuda-sharded"], capsys)
        assert rc == rc_s == 0
        assert mesh == cuda and "0 wrong" in mesh

    def test_runner_takes_the_mesh(self, capsys, monkeypatch):
        """The cuda-sharded engine evaluates its grids through
        evaluate_grid_sharded, never evaluate_grid."""
        from cyclonus_tpu_torch.engine import TorchPolicyEngine
        from cyclonus_tpu_torch.probe.runner import ENGINE_CHOICES

        assert ENGINE_CHOICES == ["oracle", "cuda", "cuda-sharded"]
        calls = []
        real = TorchPolicyEngine.evaluate_grid_sharded

        def spy(self, cases, mesh=None, schedule=None):
            calls.append(len(cases))
            return real(self, cases, mesh=mesh, schedule=schedule)

        def refuse(self, cases):
            raise AssertionError("the sharded engine took the single-device grid")

        monkeypatch.setattr(TorchPolicyEngine, "evaluate_grid_sharded", spy)
        monkeypatch.setattr(TorchPolicyEngine, "evaluate_grid", refuse)
        rc, out = run(main, ["probe", "--mock", "--perfect-cni", "--device", "cpu",
                             "--engine", "cuda-sharded", "--policy-path", SIMPLE_EXAMPLE], capsys)
        assert rc == 0 and calls and "0 wrong" in out
