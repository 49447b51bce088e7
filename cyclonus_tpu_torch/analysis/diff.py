"""Policy-set diff / equivalence on the verdict tensors (a copy of the
reference package's analysis/diff.py on the port's engine).

Encode both policy sets against the SAME cluster and port cases, XOR
their verdict grids on the engines' device, and report the exact
(case, src, dst) cells that differ — per direction and combined; only
the counts, the differing cells' indices and the cells the report and
the oracle read come back to the host.  An empty diff is a semantic
equivalence proof relative to that cluster and case set (the same
relativity the verdict grid itself has).  Reported cells are
cross-checked against the scalar matcher oracle on a sampled subset.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.api import PortCase, TorchPolicyEngine
from ..matcher.core import Policy
from ..utils.table import render_table
from .cluster import derive_port_cases
from .oracle import (
    PodTuple,
    oracle_verdicts,
    sample_cells,
    traffic_for_cell,
)


@dataclass
class DiffCell:
    case: PortCase
    src: str  # "ns/name"
    dst: str
    a: Tuple[bool, bool, bool]  # (ingress, egress, combined) under set A
    b: Tuple[bool, bool, bool]


@dataclass
class DiffReport:
    cases: List[PortCase]
    pod_keys: List[str]
    n_diff: Dict[str, int]  # per grid: ingress / egress / combined
    cells: List[DiffCell] = field(default_factory=list)  # capped sample
    truncated: bool = False
    oracle_checked: int = 0

    @property
    def total_cells(self) -> int:
        n = len(self.pod_keys)
        return len(self.cases) * n * n

    @property
    def equivalent(self) -> bool:
        return not any(self.n_diff.values())

    def table(self) -> str:
        def fmt(v):
            i, e, c = v
            return f"I={'Y' if i else 'n'} E={'Y' if e else 'n'} C={'Y' if c else 'n'}"

        rows = [
            [
                f"{c.case.port}"
                + (f"({c.case.port_name})" if c.case.port_name else "")
                + f"/{c.case.protocol}",
                c.src,
                c.dst,
                fmt(c.a),
                fmt(c.b),
            ]
            for c in self.cells
        ]
        return render_table(
            ["Port/Protocol", "Src", "Dst", "Set A", "Set B"],
            rows,
            row_line=True,
        )


def diff_policy_sets(
    policy_a: Policy,
    policy_b: Policy,
    pods: Sequence[PodTuple],
    namespaces: Dict[str, Dict[str, str]],
    cases: Optional[Sequence[PortCase]] = None,
    *,
    max_cells: int = 64,
    oracle_samples: int = 8,
    seed: int = 0,
    device=None,
) -> DiffReport:
    """XOR the two policy sets' verdict grids over the shared cluster.
    Differing cells (any of the three grids) are reported src-major,
    capped at max_cells; up to oracle_samples differing and
    oracle_samples agreeing cells are re-derived with the scalar
    matcher, raising RuntimeError on any disagreement with the grids.
    The engines run on `device` (None: the current CUDA device)."""
    if cases is None:
        cases = derive_port_cases(policy_a, policy_b)
    cases = list(cases)
    engine_a = TorchPolicyEngine(policy_a, pods, namespaces, device=device)
    engine_b = TorchPolicyEngine(policy_b, pods, namespaces, device=device)
    grid_a = engine_a.evaluate_grid(cases)
    grid_b = engine_b.evaluate_grid(cases)

    # every grid as [q, src, dst] on the device (ingress ships
    # [q, dst, src])
    def grids(g):
        return {
            "ingress": g.ingress_dev.transpose(1, 2),
            "egress": g.egress_dev,
            "combined": g.combined_dev,
        }

    ga, gb = grids(grid_a), grids(grid_b)
    xors = {k: ga[k] ^ gb[k] for k in ga}
    n_diff = {k: int(v.sum()) for k, v in xors.items()}
    any_diff = xors["ingress"] | xors["egress"] | xors["combined"]

    pod_keys = engine_a.pod_keys
    # [K, 3] rows (q, s, d), row-major
    idx = torch.nonzero(any_diff).cpu().numpy()
    truncated = idx.shape[0] > max_cells

    def triples(g, cells_idx) -> List[Tuple[bool, bool, bool]]:
        """(ingress, egress, combined) of each (q, s, d), one device
        gather for the lot."""
        if not len(cells_idx):
            return []
        t = torch.as_tensor(
            np.asarray(cells_idx, dtype=np.int64).reshape(-1, 3),
            device=g["egress"].device,
        )
        q, s, d = t[:, 0], t[:, 1], t[:, 2]
        out = torch.stack(
            [g["ingress"][q, s, d], g["egress"][q, s, d], g["combined"][q, s, d]],
            dim=1,
        ).cpu().numpy()
        return [tuple(bool(x) for x in row) for row in out]

    shown = idx[:max_cells]
    cells = [
        DiffCell(
            case=cases[q],
            src=pod_keys[s],
            dst=pod_keys[d],
            a=ta,
            b=tb,
        )
        for (q, s, d), ta, tb in zip(shown, triples(ga, shown), triples(gb, shown))
    ]

    # oracle cross-check: sampled differing cells must differ the same
    # way under the scalar matcher; sampled agreeing cells must agree
    rng = random.Random(seed)
    checked = 0
    check: List[Tuple[int, int, int]] = []
    if idx.shape[0]:
        picks = rng.sample(range(idx.shape[0]), min(oracle_samples, idx.shape[0]))
        check.extend(tuple(int(x) for x in idx[i]) for i in picks)
    check.extend(sample_cells(len(pod_keys), len(cases), oracle_samples, rng))
    for (q, s, d), grid_ta, grid_tb in zip(check, triples(ga, check), triples(gb, check)):
        t = traffic_for_cell(pods, namespaces, cases[q], s, d)
        oa = oracle_verdicts(policy_a, t)
        ob = oracle_verdicts(policy_b, t)
        if oa != grid_ta or ob != grid_tb:
            raise RuntimeError(
                f"oracle REFUTED diff cell (case={cases[q]}, "
                f"src={pod_keys[s]}, dst={pod_keys[d]}): oracle A={oa} "
                f"B={ob}, grids A={grid_ta} "
                f"B={grid_tb}"
            )
        checked += 1
    return DiffReport(
        cases=cases,
        pod_keys=list(pod_keys),
        n_diff=n_diff,
        cells=cells,
        truncated=truncated,
        oracle_checked=checked,
    )
