"""Static + resolved-policy lint checks (reference: pkg/linter; a copy of
the reference package's linter)."""

from .checks import Check, Warning, lint, warnings_table

__all__ = ["Check", "Warning", "lint", "warnings_table"]
