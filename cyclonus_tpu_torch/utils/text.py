"""String helpers (reference: pkg/utils/utils.go:18-30; a copy of the
reference package's utils/text.py).  PyYAML is imported inside
yaml_string, as kube/yaml_io.py imports it."""

from __future__ import annotations

import json


def json_string(obj) -> str:
    return json.dumps(obj, indent=2, default=_default)


def yaml_string(obj) -> str:
    import yaml

    return yaml.safe_dump(obj, sort_keys=False)


def _default(obj):
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if hasattr(obj, "__dict__"):
        return obj.__dict__
    return str(obj)
