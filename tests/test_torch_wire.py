"""The port's wire protocol (cyclonus_tpu_torch/worker/wireregistry.py,
its frozen golden worker/wire_schema.json and the model codecs) against
the reference's, on the CPU.

On a real cluster the port's client speaks to a worker image built from
either package, so the two must agree on the wire: the same registry,
the same golden, the same registry-synthesized skew views, and — the
cross-package leg — every message under every version view, absence view
and unknown-key injection emitted by one package's real codec, sent as
JSON, and read by the other's, both ways, parses to the same payload
under the registry's portable projection.  The serve loops are crossed
too: the same line answers the same reply from both packages' services,
and each package's reply passes the other's reader check.  The port's
skew harness (torch_tools/skewharness.py) runs its quick slice as a
subprocess."""

import json
import os
import subprocess
import sys

import pytest

from cyclonus_tpu.worker import model as ref_model
from cyclonus_tpu.worker import wireregistry as ref_wr
from cyclonus_tpu_torch.worker import model
from cyclonus_tpu_torch.worker import wireregistry as wr

from test_torch_engine import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import wirelint  # noqa: E402

MESSAGES = [m.name for m in ref_wr.MESSAGES]


def _views(reg, name):
    """(label, payload) of every skew view of the message's sample:
    the full sample, each older version, each optional key absent, and
    the unknown-key injection of each of those."""
    msg = reg.message(name)
    full = reg.sample_payload(name)
    out = [("full", full)]
    out += [(f"v{v}", reg.legacy_view(name, full, v))
            for v in range(msg.since, reg.PROTOCOL_VERSION)]
    out += [(f"absent({k.name})", reg.drop_view(name, full, k.name))
            for k in msg.keys if k.optional]
    out += [(f"inject[{label}]", reg.inject_unknown(name, view)) for label, view in list(out)]
    return out


def _codec(pkg_model, reg, name):
    return pkg_model.CODECS.get(name) or reg._generic_codec(name)


class TestRegistry:
    def test_golden_equals_the_reference_as_json(self):
        with open(wr.golden_path()) as f:
            port_golden = json.load(f)
        with open(ref_wr.golden_path()) as f:
            ref_golden = json.load(f)
        assert port_golden == ref_golden
        assert wr.build_golden() == port_golden

    def test_committed_golden_is_current(self):
        """The committed file is what --write-golden writes."""
        with open(wr.golden_path()) as f:
            text = f.read()
        assert text == json.dumps(wr.build_golden(), indent=2, sort_keys=True) + "\n"

    def test_manifest_equals_the_reference(self):
        assert wr.manifest() == ref_wr.manifest()
        assert wr.PROTOCOL_VERSION == ref_wr.PROTOCOL_VERSION

    def test_static_extraction_equals_the_runtime_manifest(self):
        """tools/wirelint.py reads the port's registry off the AST as
        the runtime manifest: the lint checks the real declarations."""
        reg = wirelint.load_registry(
            os.path.join(REPO, "cyclonus_tpu_torch", "worker", "wireregistry.py")
        )
        assert wirelint.build_manifest(reg) == wr.manifest()

    def test_recorder_stripped_when_unarmed(self):
        assert not wr.ACTIVE
        wr.legacy_view("Batch", wr.sample_payload("Batch"), 1)
        assert wr.drain() == []

    @pytest.mark.parametrize("name", MESSAGES)
    def test_views_equal_the_reference(self, name):
        """legacy_view, drop_view, inject_unknown and strip_nonportable of
        every sample_payload give equal dicts in both packages."""
        assert wr.sample_payload(name) == ref_wr.sample_payload(name)
        got, want = _views(wr, name), _views(ref_wr, name)
        assert [label for label, _ in got] == [label for label, _ in want]
        for (label, a), (_, b) in zip(got, want):
            assert a == b, label
            assert wr.strip_nonportable(name, a) == ref_wr.strip_nonportable(name, b), label
            assert wr.guard_violations(name, a) == ref_wr.guard_violations(name, b), label

    @pytest.mark.parametrize("name", MESSAGES)
    def test_wire_tables_equal_the_reference(self, name):
        a, b = wr.wire_table(name), ref_wr.wire_table(name)
        assert {k: (v.type, v.optional) for k, v in a.items()} == {
            k: (v.type, v.optional) for k, v in b.items()
        }


class TestCrossPackage:
    """A port emitter read by the reference's real codec, and the
    reverse, for every message under every view."""

    @pytest.mark.parametrize("name", MESSAGES)
    @pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
    def test_every_view_parses_identically(self, name, direction):
        port_parse, port_emit = _codec(model, wr, name)
        ref_parse, ref_emit = _codec(ref_model, ref_wr, name)
        if direction == "port_to_ref":
            (e_parse, e_emit), (r_parse, r_emit), reg = (
                (port_parse, port_emit), (ref_parse, ref_emit), wr)
        else:
            (e_parse, e_emit), (r_parse, r_emit), reg = (
                (ref_parse, ref_emit), (port_parse, port_emit), ref_wr)
        for label, view in _views(reg, name):
            sent = json.dumps(e_emit(e_parse(view)))  # what the emitter puts on the wire
            read = r_emit(r_parse(json.loads(sent)))  # what the other package reads
            assert wr.strip_nonportable(name, read) == wr.strip_nonportable(
                name, json.loads(sent)
            ), (name, label)
            # and the reader agrees with its own package on the same line
            own = e_emit(e_parse(json.loads(sent)))
            assert wr.strip_nonportable(name, read) == wr.strip_nonportable(name, own), label

    @pytest.mark.parametrize("name", MESSAGES)
    def test_reader_checks_agree(self, name):
        """Each package's reader check accepts the other's emitted
        sample and rejects the same drifted key type."""
        full = wr.sample_payload(name)
        wr.check_read(name, ref_wr.sample_payload(name))
        ref_wr.check_read(name, full)
        key = next(k for k in wr.message(name).keys if k.type in ("int", "str", "bool"))
        bad = dict(full, **{key.name: [] if key.type != "list" else 0})
        for reg in (wr, ref_wr):
            table = reg.wire_table(name)
            with pytest.raises(AssertionError, match=f"{name}.{key.name}"):
                # check_read's contract check, armed or not
                reg.contracts.check_wire_read(name, bad, table)


def _cluster():
    from cyclonus_tpu_torch.cli.serve_cmd import synthetic_cluster

    return synthetic_cluster(8, 2, 0)


def _line(pods):
    src = f"{pods[0][0]}/{pods[0][1]}"
    dst = f"{pods[1][0]}/{pods[1][1]}"
    batch = model.Batch(
        namespace="", pod="", container="", trace_id="t-cross", parent_span="0.1",
        deltas=[model.Delta(kind="pod_add", namespace="ns0", name="cross-pod",
                            labels={"pod": "p99", "app": "app1", "tier": "tier1"},
                            ip="10.99.0.1")],
        queries=[model.FlowQuery(src=src, dst=dst, port=80, protocol="TCP")],
    )
    return json.loads(batch.to_json())


class TestCrossServeLoop:
    """The port's serve loop and the reference's answer the same line,
    and its legacy and unknown-injected views, with the same reply
    under the portable projection; each reply passes the other's
    reader check."""

    @pytest.fixture(scope="class")
    def services(self):
        from cyclonus_tpu.serve import VerdictService as RefService
        from cyclonus_tpu_torch.serve import VerdictService

        pods, namespaces = _cluster()

        def make():
            return (RefService(pods, namespaces, []),
                    VerdictService(pods, namespaces, [], device="cpu"))

        return make, pods

    @pytest.mark.parametrize("view", ["full", "v1", "v3", "inject"])
    def test_loops_answer_alike(self, services, view):
        from cyclonus_tpu.serve import loop as ref_loop
        from cyclonus_tpu_torch.serve import loop

        make, pods = services
        full = _line(pods)
        payload = {"full": full, "inject": wr.inject_unknown("Batch", full)}.get(view)
        if payload is None:
            payload = wr.legacy_view("Batch", full, int(view[1:]))
        ref_svc, svc = make()
        ref_reply = ref_loop.handle_line(ref_svc, json.dumps(payload))
        reply = loop.handle_line(svc, json.dumps(payload))
        assert wr.strip_nonportable("Reply", reply) == ref_wr.strip_nonportable(
            "Reply", ref_reply
        )
        ref_wr.check_read("Reply", json.loads(json.dumps(reply)))
        wr.check_read("Reply", json.loads(json.dumps(ref_reply)))
        assert svc.epoch == ref_svc.epoch


def test_skewharness_quick_slice_runs():
    """torch_tools/skewharness.py --device cpu: every quick scenario and
    the coverage census pass, and the last line is its JSON result."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "torch_tools", "skewharness.py"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["harness"] == "skew" and out["ok"] and out["device"] == "cpu"
    assert "coverage_census" in out["results"]
    assert out["results"]["registry_sweep"]["pairs"] >= 40
