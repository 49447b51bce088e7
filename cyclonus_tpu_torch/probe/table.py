"""Probe result table: a TruthTable of per-pair JobResult dicts
(reference: probe/table.go)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .connectivity import CONNECTIVITY_UNKNOWN, short_string
from .job import JobResult
from .truthtable import TruthTable


class Item:
    def __init__(self, from_: str, to: str):
        self.from_ = from_
        self.to = to
        self.job_results: Dict[str, JobResult] = {}

    def add_job_result(self, jr: JobResult) -> None:
        if jr.key() in self.job_results:
            raise ValueError(
                f"unable to add job result: duplicate key {jr.key()} (job {jr.job})"
            )
        self.job_results[jr.key()] = jr


class Table:
    def __init__(self, items: List[str]):
        self.wrapped = TruthTable.from_items(items, lambda fr, to: Item(fr, to))

    @staticmethod
    def from_job_results(resources, job_results: List[JobResult]) -> "Table":
        table = Table(resources.sorted_pod_names())
        for result in job_results:
            table.get(result.job.from_key, result.job.to_key).add_job_result(result)
        return table

    def get(self, from_: str, to: str) -> Item:
        return self.wrapped.get(from_, to)  # type: ignore

    def render_ingress(self) -> str:
        return self._render(lambda r: short_string(r.ingress or CONNECTIVITY_UNKNOWN))

    def render_egress(self) -> str:
        return self._render(lambda r: short_string(r.egress or CONNECTIVITY_UNKNOWN))

    def render_table(self) -> str:
        return self._render(lambda r: short_string(r.combined))

    def _render(self, render: Callable[[JobResult], str]) -> str:
        """Layout selection: simple / uniform-multi / non-uniform
        (table.go:70-98)."""
        is_schema_uniform, is_single_element = True, True
        schema_set = set()
        for fr, to in self.wrapped.keys():
            d = self.get(fr, to).job_results
            if len(d) != 1:
                is_single_element = False
            schema_set.add("_".join(sorted(d.keys())))
            if len(schema_set) > 1:
                is_schema_uniform = False
                break
        if is_schema_uniform and is_single_element:
            return self._render_simple(render)
        elif is_schema_uniform:
            return self._render_uniform_multi(render)
        return self._render_nonuniform(render)

    def _render_simple(self, render) -> str:
        def element(fr, to, item):
            for v in item.job_results.values():
                return render(v)
            return short_string(CONNECTIVITY_UNKNOWN)

        return self.wrapped.render("", False, element)

    def _render_uniform_multi(self, render) -> str:
        first = self.get(*self.wrapped.keys()[0])
        keys = sorted(first.job_results.keys())
        schema = "\n".join(keys)

        def element(fr, to, item):
            return "\n".join(render(item.job_results[k]) for k in keys)

        return self.wrapped.render(schema, True, element)

    def _render_nonuniform(self, render) -> str:
        def element(fr, to, item):
            return "\n".join(
                f"{k}: {render(item.job_results[k])}"
                for k in sorted(item.job_results.keys())
            )

        return self.wrapped.render("", True, element)
