"""CLI (reference: pkg/cli): generate / probe / version.

Run as `python -m cyclonus_tpu_torch <command> ...`."""

from .root import main

__all__ = ["main"]
