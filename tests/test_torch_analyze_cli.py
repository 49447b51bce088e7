"""The port's `analyze` command (cyclonus_tpu_torch/cli/analyze.py) and
linter (cyclonus_tpu_torch/linter) against the reference's, on the CPU:
each mode's stdout byte for byte equal to the reference's `run_analyze`
with the same flags (the port's with `--device cpu` added), and the
linter's warnings on the cases of tests/test_cli_linter.py."""

import os

import pytest

from cyclonus_tpu.cli.root import main as ref_main
from cyclonus_tpu.kube.examples import all_examples
from cyclonus_tpu.kube.netpol import (
    IntOrString,
    LabelSelector,
    NetworkPolicy,
    NetworkPolicyIngressRule,
    NetworkPolicyPort,
    NetworkPolicySpec,
)
from cyclonus_tpu.kube.yaml_io import policies_to_yaml, policy_to_dict
from cyclonus_tpu.linter import lint as ref_lint
from cyclonus_tpu.linter import warnings_table as ref_warnings_table
from cyclonus_tpu_torch.cli import main
from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
from cyclonus_tpu_torch.linter import lint, warnings_table
from cyclonus_tpu_torch.linter import checks

from test_analysis import SHADOW_YAML
from test_torch_engine import REPO

EXAMPLES_DIR = os.path.join(REPO, "examples")
SIMPLE = os.path.join(EXAMPLES_DIR, "networkpolicies", "simple-example")
GETTING_STARTED = os.path.join(EXAMPLES_DIR, "networkpolicies", "getting-started")

MODES = {
    "parse": ["--mode", "parse"],
    "explain": ["--mode", "explain"],
    "lint": ["--mode", "lint"],
    "audit": ["--mode", "audit"],
    "diff": ["--mode", "diff", "--policy-path2", GETTING_STARTED],
    "query-target": ["--mode", "query-target", "--target-pod-path",
                     os.path.join(EXAMPLES_DIR, "targets.json")],
    "query-traffic": ["--mode", "query-traffic", "--traffic-path",
                      os.path.join(EXAMPLES_DIR, "traffic.json")],
    "probe": ["--mode", "probe", "--probe-path", os.path.join(EXAMPLES_DIR, "probe.json")],
}


def both(capsys, argv):
    """(reference stdout, port stdout) of `analyze` + argv."""
    assert ref_main(["analyze"] + argv) == 0
    want = capsys.readouterr().out
    assert main(["analyze"] + argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    return want, got


class TestModes:
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_simple_example(self, capsys, mode):
        want, got = both(capsys, ["--policy-path", SIMPLE] + MODES[mode])
        assert want and got == want

    @pytest.mark.parametrize("mode", ["parse", "explain", "lint", "audit", "query-target",
                                      "query-traffic", "probe"])
    def test_example_policies(self, capsys, mode):
        want, got = both(capsys, ["--use-example-policies"] + MODES[mode])
        assert want and got == want

    @pytest.mark.parametrize("mode", ["audit", "probe"])
    def test_getting_started(self, capsys, mode):
        want, got = both(capsys, ["--policy-path", GETTING_STARTED] + MODES[mode])
        assert want and got == want

    def test_default_mode_and_several_modes(self, capsys):
        want, got = both(capsys, ["--policy-path", SIMPLE])
        assert want and got == want
        want, got = both(capsys, ["--policy-path", SIMPLE, "--mode", "lint", "--mode", "explain",
                                  "--mode", "audit"])
        assert got == want

    @pytest.mark.parametrize("engine", ["oracle", "cuda"])
    def test_probe_engines(self, capsys, engine):
        argv = ["--policy-path", GETTING_STARTED] + MODES["probe"]
        assert ref_main(["analyze"] + argv) == 0
        want = capsys.readouterr().out
        assert main(["analyze"] + argv + ["--engine", engine, "--device", "cpu"]) == 0
        assert capsys.readouterr().out == want

    def test_audit_flags_shadowed_rule(self, capsys, tmp_path):
        p = tmp_path / "shadow.yaml"
        p.write_text(SHADOW_YAML)
        want, got = both(capsys, ["--mode", "audit", "--policy-path", str(p),
                                  "--simplify-policies", "false"])
        assert got == want and "shadowed" in got and "confirmed" in got

    @pytest.mark.parametrize("perturb", [False, True])
    def test_diff_sets(self, capsys, tmp_path, perturb):
        a = tmp_path / "a.yaml"
        a.write_text(SHADOW_YAML)
        b = tmp_path / "b.yaml"
        b.write_text(SHADOW_YAML.replace("    - from:\n        - podSelector: {}\n", "", 1)
                     if perturb else SHADOW_YAML)
        want, got = both(capsys, ["--mode", "diff", "--policy-path", str(a), "--policy-path2",
                                  str(b), "--simplify-policies", "false",
                                  "--max-diff-cells", "5"])
        assert got == want
        assert ("DIFFER" in got) == perturb

    def test_audit_probe_path_cluster(self, capsys):
        """audit and diff take their cluster from --probe-path when given."""
        want, got = both(capsys, ["--policy-path", GETTING_STARTED, "--mode", "audit",
                                  "--mode", "diff", "--policy-path2", SIMPLE,
                                  "--probe-path", os.path.join(EXAMPLES_DIR, "probe.json")])
        assert got == want

    def test_parse_and_lint_of_written_policies(self, capsys, tmp_path):
        path = tmp_path / "pols.yaml"
        path.write_text(policies_to_yaml(all_examples()[:3]))
        want, got = both(capsys, ["--policy-path", str(path), "--mode", "parse", "--mode", "lint"])
        assert got == want and "allow-nothing-to-app-web" in got


class TestErrors:
    @pytest.mark.parametrize("argv", [["-n", "x"], ["-A"], ["-n", "x", "-A"]])
    def test_cluster_flags_exit_with_one_line(self, argv, tmp_path, monkeypatch):
        """-n / -A read the cluster through kubectl (ported; the reads
        themselves: test_torch_cli_kube.py): without kubectl on PATH both
        packages raise the same KubeError, and the two flags together exit
        with the reference's one line."""
        monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
        got = []
        for run in (main, ref_main):
            with pytest.raises((SystemExit, Exception)) as e:
                run(["analyze", "--mode", "explain"] + argv)
            got.append((type(e.value).__name__, str(e.value)))
        assert got[0] == got[1]
        if "-A" in argv and "-n" in argv:
            assert got[0] == ("SystemExit", "--namespace and --all-namespaces are mutually exclusive")
        else:
            assert got[0] == ("KubeError", "kubectl not found on PATH")

    @pytest.mark.parametrize("mode,needs", [("diff", "policy-path2"),
                                            ("query-traffic", "traffic file"),
                                            ("query-target", "target pod file"),
                                            ("probe", "--probe-path")])
    def test_missing_inputs_raise_as_reference(self, mode, needs):
        for run in (ref_main, main):
            with pytest.raises(ValueError, match=needs):
                run(["analyze", "--policy-path", SIMPLE, "--mode", mode])

    def test_no_card_no_fallback(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["analyze", "--policy-path", SIMPLE, "--mode", "audit"])


def port_policies(policies):
    return [parse_policy_dict(policy_to_dict(p)) for p in policies]


def warning_keys(warnings):
    return [
        (w.check,
         None if w.source_policy is None else (w.source_policy.namespace, w.source_policy.name),
         None if w.target is None else w.target.get_primary_key())
        for w in warnings
    ]


def source_check_policies():
    return [
        NetworkPolicy(
            name="dup",
            namespace="",
            spec=NetworkPolicySpec(
                pod_selector=LabelSelector.make(),
                policy_types=[],
                ingress=[NetworkPolicyIngressRule(ports=[NetworkPolicyPort(port=IntOrString(80))])],
            ),
        ),
        NetworkPolicy(
            name="dup",
            namespace="",
            spec=NetworkPolicySpec(pod_selector=LabelSelector.make(), policy_types=["Ingress"]),
        ),
    ]


def deny_all(types):
    return NetworkPolicy(
        name="deny", namespace="x",
        spec=NetworkPolicySpec(pod_selector=LabelSelector.make(), policy_types=types),
    )


class TestLinter:
    def test_source_checks(self):
        pols = source_check_policies()
        got = lint(port_policies(pols))
        assert warning_keys(got) == warning_keys(ref_lint(pols))
        found = {w.check for w in got}
        for c in (checks.CHECK_SOURCE_MISSING_NAMESPACE, checks.CHECK_SOURCE_MISSING_POLICY_TYPES,
                  checks.CHECK_SOURCE_MISSING_POLICY_TYPE_INGRESS,
                  checks.CHECK_SOURCE_DUPLICATE_POLICY_NAME,
                  checks.CHECK_SOURCE_PORT_MISSING_PROTOCOL):
            assert c in found
        assert warnings_table(got) == ref_warnings_table(ref_lint(pols))

    def test_resolved_checks(self):
        pols = [deny_all(["Ingress", "Egress"])]
        got = lint(port_policies(pols))
        assert warning_keys(got) == warning_keys(ref_lint(pols))
        found = {w.check for w in got}
        for c in (checks.CHECK_TARGET_ALL_INGRESS_BLOCKED, checks.CHECK_TARGET_ALL_EGRESS_BLOCKED,
                  checks.CHECK_DNS_BLOCKED_ON_TCP, checks.CHECK_DNS_BLOCKED_ON_UDP):
            assert c in found
        assert warnings_table(got) == ref_warnings_table(ref_lint(pols))

    def test_skip_filter(self):
        pols = [deny_all(["Ingress"])]
        skip = {checks.CHECK_TARGET_ALL_INGRESS_BLOCKED}
        got = lint(port_policies(pols), skip=skip)
        assert warning_keys(got) == warning_keys(ref_lint(pols, skip=skip))
        assert checks.CHECK_TARGET_ALL_INGRESS_BLOCKED not in {w.check for w in got}

    @pytest.mark.parametrize("k", [1, 5, 21])
    def test_examples_equal_reference(self, k):
        pols = all_examples()[:k]
        got = lint(port_policies(pols))
        want = ref_lint(pols)
        assert warning_keys(got) == warning_keys(want)
        assert warnings_table(got) == ref_warnings_table(want)
