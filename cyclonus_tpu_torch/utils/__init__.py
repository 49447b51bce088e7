"""Small utilities (reference: pkg/utils)."""

from .table import render_table

__all__ = ["render_table"]
