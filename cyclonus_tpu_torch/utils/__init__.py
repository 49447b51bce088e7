"""Small utilities (reference: pkg/utils)."""

from .table import render_table
from .text import json_string, yaml_string

__all__ = ["json_string", "yaml_string", "render_table"]
