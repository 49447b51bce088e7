"""ASCII table rendering in the spirit of the reference's tablewriter output.

Cells may be multi-line; columns size to their widest line.  This backs the
explain/probe/comparison tables (the reference leans on
github.com/olekukonko/tablewriter everywhere)."""

from __future__ import annotations

from typing import List, Optional, Sequence


def _cell_lines(cell: object) -> List[str]:
    return str(cell).split("\n") if cell is not None else [""]


def render_table(
    header: Sequence[object],
    rows: Sequence[Sequence[object]],
    footer: Optional[Sequence[object]] = None,
    row_line: bool = False,
) -> str:
    """Render an ASCII table with +-/| borders.

    row_line inserts a separator between every row (tablewriter SetRowLine)."""
    all_rows = [list(header)] + [list(r) for r in rows]
    if footer is not None:
        all_rows.append(list(footer))
    ncols = max(len(r) for r in all_rows) if all_rows else 0
    for r in all_rows:
        while len(r) < ncols:
            r.append("")

    widths = [0] * ncols
    for r in all_rows:
        for i, cell in enumerate(r):
            for line in _cell_lines(cell):
                widths[i] = max(widths[i], len(line))

    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt_row(r: Sequence[object]) -> List[str]:
        cells = [_cell_lines(c) for c in r]
        height = max(len(c) for c in cells)
        lines = []
        for h in range(height):
            parts = []
            for i, c in enumerate(cells):
                text = c[h] if h < len(c) else ""
                parts.append(" " + text.ljust(widths[i]) + " ")
            lines.append("|" + "|".join(parts) + "|")
        return lines

    out: List[str] = [sep]
    out.extend(fmt_row(all_rows[0]))
    out.append(sep)
    body = all_rows[1:-1] if footer is not None else all_rows[1:]
    for idx, r in enumerate(body):
        out.extend(fmt_row(r))
        if row_line and idx != len(body) - 1:
            out.append(sep)
    if body:
        out.append(sep)
    if footer is not None:
        out.extend(fmt_row(all_rows[-1]))
        out.append(sep)
    return "\n".join(out) + "\n"
