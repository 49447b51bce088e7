"""Argument parsing and command dispatch (reference: pkg/cli/root.go)."""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from .. import __version__


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cyclonus-tpu-torch",
        description="kubernetes network policy prober and conformance-test "
        "generator on PyTorch and CUDA",
    )
    parser.add_argument(
        "-v",
        "--verbosity",
        default="info",
        choices=["debug", "info", "warn", "error"],
        help="log level",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    from .generate import setup_generate
    from .probe_cmd import setup_probe
    from .serve_cmd import setup_serve

    setup_generate(sub)
    setup_probe(sub)
    setup_serve(sub)

    version_cmd = sub.add_parser("version", help="print version information")
    version_cmd.set_defaults(func=_run_version)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level={"debug": logging.DEBUG, "info": logging.INFO, "warn": logging.WARNING,
               "error": logging.ERROR}[args.verbosity],
        format="%(levelname)s %(name)s: %(message)s",
    )
    return args.func(args) or 0


def _run_version(args) -> int:
    # static info only, like the reference (pkg/cli/version.go:1-34):
    # torch's version comes from package metadata, and no device is touched
    from importlib import metadata

    print(f"cyclonus-tpu-torch version {__version__}")
    try:
        torch_version = metadata.version("torch")
    except metadata.PackageNotFoundError:
        torch_version = "not installed"
    print(f"torch {torch_version}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
