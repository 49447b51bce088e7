"""Generic N x N ordered-pair grid with strict key checking
(reference: probe/truthtable.go)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..utils.table import render_table


class TruthTable:
    def __init__(
        self,
        froms: List[str],
        tos: List[str],
        default_value: Optional[Callable[[str, str], object]] = None,
    ):
        self.froms = list(froms)
        self.tos = list(tos)
        self._to_set = set(tos)
        self.values: Dict[str, Dict[str, object]] = {}
        for fr in froms:
            self.values[fr] = {}
            if default_value is not None:
                for to in tos:
                    self.values[fr][to] = default_value(fr, to)

    @staticmethod
    def from_items(
        items: List[str], default_value: Optional[Callable[[str, str], object]] = None
    ) -> "TruthTable":
        return TruthTable(items, items, default_value)

    def is_complete(self) -> bool:
        return all(
            to in self.values[fr] for fr in self.froms for to in self.tos
        )

    def set(self, from_: str, to: str, value: object) -> None:
        """Strict: unknown keys raise (truthtable.go:63-72)."""
        if from_ not in self.values:
            raise KeyError(f"from-key {from_} not found")
        if to not in self._to_set:
            raise KeyError(f"to-key {to} not allowed")
        self.values[from_][to] = value

    def get(self, from_: str, to: str) -> object:
        if from_ not in self.values:
            raise KeyError(f"from-key {from_} not found")
        if to not in self.values[from_]:
            raise KeyError(f"to-key {to} not found")
        return self.values[from_][to]

    def keys(self):
        return [(fr, to) for fr in self.froms for to in self.tos]

    def render(
        self,
        schema: str,
        row_line: bool,
        print_element: Callable[[str, str, object], str],
    ) -> str:
        """truthtable.go:101-117: header row is '<schema> | to...'; one row
        per from."""
        rows = []
        for fr in self.froms:
            rows.append(
                [fr] + [print_element(fr, to, self.values[fr].get(to)) for to in self.tos]
            )
        return render_table([schema] + self.tos, rows, row_line=row_line)
