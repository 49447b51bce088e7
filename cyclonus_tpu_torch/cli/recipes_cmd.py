"""`recipes` subcommand (reference: cmd/recipes/main.go -> recipes.Run;
the reference package's cli/recipes_cmd.py with --device)."""

from __future__ import annotations

from ..probe.runner import DEFAULT_ENGINE, ENGINE_CHOICES


def setup_recipes(sub) -> None:
    cmd = sub.add_parser(
        "recipes", help="run the canned policy recipe scenarios"
    )
    cmd.add_argument(
        "--engine",
        default=DEFAULT_ENGINE,
        choices=ENGINE_CHOICES,
        help="simulated engine",
    )
    cmd.add_argument(
        "--device",
        default=None,
        help="torch device of the cuda engine (default: the current CUDA "
        "device, and an error without one; 'cpu' runs it on the CPU)",
    )
    cmd.set_defaults(func=_run)


def _run(args) -> int:
    from ..recipes import run_all_recipes

    run_all_recipes(engine=args.engine, device=args.device)
    return 0
