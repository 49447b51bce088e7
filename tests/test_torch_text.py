"""utils/text.py of the port against the reference's: json_string (with
its _default for objects with to_dict, with a __dict__ only, and with
neither) and yaml_string give the same text."""

import datetime
import enum
from dataclasses import dataclass

import pytest

from cyclonus_tpu.utils import text as ref
from cyclonus_tpu_torch import utils
from cyclonus_tpu_torch.kube import netpol
from cyclonus_tpu_torch.utils import text

from cyclonus_tpu.kube import netpol as ref_netpol


class WithToDict:
    def __init__(self, n):
        self.n = n

    def to_dict(self):
        return {"n": self.n, "nested": [WithDictOnly(self.n + 1)]}


class WithDictOnly:
    def __init__(self, n):
        self.n = n
        self.label = f"pod-{n}"


@dataclass
class Plain:
    a: int
    b: str


class Color(enum.Enum):
    RED = 1


OBJECTS = {
    "scalars": {"a": 1, "b": [1.5, None, True, "x"], "c": {"d": {}}},
    "to_dict": WithToDict(3),
    "dict_only": WithDictOnly(7),
    "dataclass": Plain(1, "two"),
    "nested": {"x": [WithToDict(1), WithDictOnly(2)], "y": (1, 2)},
    "no_dict": {"when": datetime.date(2026, 8, 3), "enum": Color.RED, "set": frozenset()},
    "unicode": {"name": "pod-é", "empty": ""},
}


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_json_string(name):
    obj = OBJECTS[name]
    assert text.json_string(obj) == ref.json_string(obj)


def test_json_string_of_a_policy():
    """A NetworkPolicy of the examples through each package's own kube
    model (both have to_dict)."""
    import os

    from test_torch_engine import REPO

    path = os.path.join(REPO, "examples", "networkpolicies", "simple-example")
    from cyclonus_tpu.kube import load_policies_from_path as ref_load
    from cyclonus_tpu_torch.kube import load_policies_from_path

    mine, theirs = load_policies_from_path(path), ref_load(path)
    assert mine and len(mine) == len(theirs)
    assert text.json_string(mine) == ref.json_string(theirs)
    assert isinstance(mine[0], netpol.NetworkPolicy)
    assert isinstance(theirs[0], ref_netpol.NetworkPolicy)


@pytest.mark.parametrize("name", ["scalars", "unicode"])
def test_yaml_string(name):
    assert text.yaml_string(OBJECTS[name]) == ref.yaml_string(OBJECTS[name])


def test_package_exports():
    assert utils.json_string is text.json_string
    assert utils.yaml_string is text.yaml_string
    assert sorted(utils.__all__) == sorted(["json_string", "yaml_string", "render_table"])
