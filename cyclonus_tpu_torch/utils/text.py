"""String helpers (reference: pkg/utils/utils.go:18-30; the reference
package's utils/text.py cut to what the linter uses).  PyYAML is
imported inside yaml_string, as kube/yaml_io.py imports it."""

from __future__ import annotations


def yaml_string(obj) -> str:
    import yaml

    return yaml.safe_dump(obj, sort_keys=False)
