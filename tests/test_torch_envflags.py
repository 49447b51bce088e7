"""The port's CYCLONUS_* registry (cyclonus_tpu_torch/utils/envflags.py)
against the reference's: complete over every token the port's package
names, the same type, default, owner and choices for every shared flag,
the same never-raise parsing of malformed values, and the reads the port
switched to it (serve churn limits, prewarm, headroom) with their
defaults unchanged."""

import os
import re
import subprocess
import sys

import pytest

from cyclonus_tpu.utils import envflags as ref
from cyclonus_tpu_torch.utils import envflags

from test_torch_engine import REPO

PORT_ONLY = {"CYCLONUS_TORCH_BUILD_DIR"}

#: malformed values, per kind
MALFORMED = {
    "int": ("not-a-number", "6GiB", "1.5", ""),
    "float": ("soon", "", "1,5"),
    "bool": ("yes", "true", "", "2"),
    "enum": ("bogus", "", "AUTOX"),
    "str": (),
    "path": (),
}


def _tokens():
    pat = re.compile(r"CYCLONUS_[A-Z0-9_]+")
    seen = set()
    pkg = os.path.join(REPO, "cyclonus_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py") and not (fn == "envflags.py" and root.endswith("utils")):
                with open(os.path.join(root, fn)) as f:
                    seen.update(pat.findall(f.read()))
    return seen


class TestRegistry:
    def test_every_token_in_the_port_is_registered(self):
        """Walk cyclonus_tpu_torch/ for CYCLONUS_* tokens (docstrings
        count): each is registered, or one of the reference's flags the
        module docstring lists as dropped."""
        seen = _tokens()
        missing = sorted(seen - set(envflags.REGISTRY) - set(envflags.DROPPED))
        assert not missing, f"undeclared env vars: {missing}"
        # the registry names what the port reads, nothing it does not
        assert not sorted(set(envflags.REGISTRY) - seen)

    def test_dropped_flags_are_reference_flags_the_port_never_reads(self):
        doc = envflags.__doc__
        for name in envflags.DROPPED:
            assert name in ref.REGISTRY, name
            assert name not in envflags.REGISTRY, name
            assert name in doc, name
        assert set(ref.REGISTRY) - set(envflags.REGISTRY) == set(envflags.DROPPED)
        assert set(envflags.REGISTRY) - set(ref.REGISTRY) == PORT_ONLY

    @pytest.mark.parametrize("name", sorted(set(ref.REGISTRY) & set(envflags.REGISTRY)))
    def test_shared_flag_matches_reference(self, name):
        a, b = envflags.REGISTRY[name], ref.REGISTRY[name]
        assert (a.kind, a.default, a.owner, a.choices) == (b.kind, b.default, b.owner, b.choices)
        assert a.description

    def test_keyharness_row_is_the_references(self):
        """CYCLONUS_KEYHARNESS is registered now that the port has its
        recorder (utils/cachekeys.py): its row of the harness table equals
        the reference's apart from the meaning column, in the reference's
        place, and it reads the strip contract's way (opt-in)."""
        def row(table):
            lines = table.splitlines()
            names = [ln.split("`")[1] for ln in lines[2:]]
            return names.index("CYCLONUS_KEYHARNESS"), lines[2:][
                names.index("CYCLONUS_KEYHARNESS")].rsplit("|", 2)[0]

        assert "CYCLONUS_KEYHARNESS" not in envflags.DROPPED
        assert row(envflags.markdown_table("harness")) == row(ref.markdown_table("harness"))
        assert envflags.get_bool("CYCLONUS_KEYHARNESS") is False

    def test_unregistered_name_is_a_programming_error(self):
        with pytest.raises(KeyError):
            envflags.get_int("CYCLONUS_NO_SUCH_FLAG")
        with pytest.raises(KeyError):
            envflags.get_raw("CYCLONUS_AOT_CACHE")

    def test_loads_without_torch(self):
        code = (
            "import sys\n"
            "from cyclonus_tpu_torch.utils import envflags\n"
            "assert envflags.get_bool('CYCLONUS_TELEMETRY')\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'cyclonus_tpu')]\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr


_GETTERS = {"int": "get_int", "float": "get_float", "bool": "get_bool", "enum": "get_enum",
            "str": "get_str", "path": "get_str"}


def _good(flag):
    """A well-formed value other than the flag's default."""
    if flag.kind == "int":
        return "7"
    if flag.kind == "float":
        return "2.5"
    if flag.kind == "bool":
        return "0" if flag.default else "1"
    return next(c for c in flag.choices if c != flag.default)


def _shared(kinds):
    return sorted(n for n in set(ref.REGISTRY) & set(envflags.REGISTRY)
                  if envflags.REGISTRY[n].kind in kinds)


class TestAccessors:
    @pytest.mark.parametrize("name", _shared(("int", "float", "bool", "enum")))
    def test_malformed_and_wellformed_values_read_as_reference(self, name, monkeypatch):
        """Unset, each malformed value and a well-formed one read the same
        through both registries: the default for anything malformed."""
        flag = envflags.REGISTRY[name]
        getter = _GETTERS[flag.kind]
        good = _good(flag)
        monkeypatch.delenv(name, raising=False)
        assert getattr(envflags, getter)(name) == getattr(ref, getter)(name) == flag.default
        for raw in MALFORMED[flag.kind] + (good,):
            monkeypatch.setenv(name, raw)
            got, want = getattr(envflags, getter)(name), getattr(ref, getter)(name)
            assert got == want, (name, raw)
            if raw != good:
                assert got == flag.default, (name, raw)
        monkeypatch.setenv(name, good)
        assert getattr(envflags, getter)(name) != flag.default

    def test_bool_conventions(self, monkeypatch):
        monkeypatch.setenv("CYCLONUS_TRACE_EVENTS", "yes")
        assert envflags.get_bool("CYCLONUS_TRACE_EVENTS") is False
        monkeypatch.setenv("CYCLONUS_TELEMETRY", "anything")
        assert envflags.get_bool("CYCLONUS_TELEMETRY") is True
        monkeypatch.setenv("CYCLONUS_TELEMETRY", "0")
        assert envflags.get_bool("CYCLONUS_TELEMETRY") is False

    def test_str_and_raw(self, monkeypatch):
        monkeypatch.delenv("CYCLONUS_WORKER_IMAGE", raising=False)
        assert envflags.get_str("CYCLONUS_WORKER_IMAGE") == "cyclonus-tpu-worker:latest"
        assert envflags.get_raw("CYCLONUS_WORKER_IMAGE") is None
        monkeypatch.setenv("CYCLONUS_WORKER_IMAGE", "img:1")
        assert envflags.get_str("CYCLONUS_WORKER_IMAGE") == "img:1" == envflags.get_raw(
            "CYCLONUS_WORKER_IMAGE")


class TestSwitchedReads:
    """The serve reads the port moved onto the registry keep their
    defaults and degrade as the reference's do."""

    @pytest.mark.parametrize("raw", [None, "not-a-number", "3", "-2"])
    def test_serve_headroom(self, raw, monkeypatch):
        from cyclonus_tpu.serve.incremental import serve_headroom as ref_headroom
        from cyclonus_tpu_torch.serve.incremental import serve_headroom

        if raw is None:
            monkeypatch.delenv("CYCLONUS_SERVE_HEADROOM", raising=False)
        else:
            monkeypatch.setenv("CYCLONUS_SERVE_HEADROOM", raw)
        assert serve_headroom() == ref_headroom()

    @pytest.mark.parametrize("raw", [None, "x", "5", "0.5"])
    def test_churn_limits(self, raw, monkeypatch):
        from cyclonus_tpu.serve import service as ref_service
        from cyclonus_tpu_torch.serve import service

        for name in ("CYCLONUS_SERVE_CHURN_ROWS", "CYCLONUS_SERVE_CHURN_FRAC"):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
        assert service._churn_row_limit() == ref_service._churn_row_limit()
        assert service._churn_frac_limit() == ref_service._churn_frac_limit()

    @pytest.mark.parametrize("raw,want", [(None, True), ("0", False), ("1", True), ("no", True)])
    def test_serve_prewarm(self, raw, want, monkeypatch):
        if raw is None:
            monkeypatch.delenv("CYCLONUS_SERVE_PREWARM", raising=False)
        else:
            monkeypatch.setenv("CYCLONUS_SERVE_PREWARM", raw)
        assert envflags.get_bool("CYCLONUS_SERVE_PREWARM") is want
        assert ref.get_bool("CYCLONUS_SERVE_PREWARM") is want


def _owners():
    return sorted({f.owner for f in envflags._FLAGS} & {f.owner for f in ref._FLAGS})


class TestMarkdownTable:
    """utils/envflags.markdown_table and _render_default against the
    reference's (cyclonus_tpu/utils/envflags.py:291-311)."""

    @pytest.mark.parametrize("name", sorted(set(ref.REGISTRY) & set(envflags.REGISTRY)))
    def test_render_default(self, name):
        assert envflags._render_default(envflags.REGISTRY[name]) == ref._render_default(
            ref.REGISTRY[name])

    @pytest.mark.parametrize("owner", [None] + _owners())
    def test_table_of_the_reference_registry(self, owner, monkeypatch):
        """The port's renderer over the reference's flags prints the
        reference's table, byte for byte."""
        monkeypatch.setattr(envflags, "_FLAGS", [
            envflags.Flag(f.name, f.kind, f.default, f.owner, f.description, f.choices)
            for f in ref._FLAGS])
        assert envflags.markdown_table(owner) == ref.markdown_table(owner)

    @pytest.mark.parametrize("owner", _owners())
    def test_table_of_the_port_registry(self, owner):
        """The port's own table of an owner: the reference's rows of the
        flags both register, in its order, apart from the meaning column
        (the port words some meanings for itself), plus the port's own
        flags."""
        def rows(table, names):
            lines = table.splitlines()
            out = [ln.rsplit("|", 2)[0] for ln in lines[2:] if ln.split("`")[1] in names]
            return lines[:2], out

        shared = set(ref.REGISTRY) & set(envflags.REGISTRY)
        head, got = rows(envflags.markdown_table(owner), shared)
        want_head, want = rows(ref.markdown_table(owner), shared)
        assert head == want_head
        assert got == want and got
        port_rows = envflags.markdown_table(owner).splitlines()[2:]
        names = [ln.split("`")[1] for ln in port_rows]
        assert names == [f.name for f in envflags._FLAGS if f.owner == owner]
        assert set(names) - shared <= PORT_ONLY
