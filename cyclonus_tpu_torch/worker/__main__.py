"""In-pod worker entrypoint (reference: cmd/worker/main.go + worker/cli.go):
`python -m cyclonus_tpu_torch.worker --jobs '<batch json>'` issues the
batch's probes and prints JSON results on stdout (the driver-side Client
parses them from the kubectl-exec stream)."""

from __future__ import annotations

import argparse
import sys

from .worker import run_worker


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cyclonus-worker", description="in-pod batch connectivity prober"
    )
    parser.add_argument(
        "--jobs", required=True, help="JSON-serialized worker Batch"
    )
    args = parser.parse_args(argv)
    print(run_worker(args.jobs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
