"""The `verdict_service` system under test: cyclonus_tpu_torch's verdict
service, driven through the entry points a controller calls.  Modules
under systems/ are the only ones of the benchmark that import the
program; this one hands the program the inputs the benchmark made (plain
API dicts, converted by the program's own parsers) and passes back what
the program returns.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


class System:
    """A VerdictService over one cluster (a cluster generator's inputs),
    the port cases of the mix (`cases`), and the two calls of a
    controller step: apply a batch of pod deltas, and recount the whole
    grid through svc.engine.evaluate_grid_counts."""

    def __init__(self, inputs: Dict, mix: Dict, device="cuda"):
        from cyclonus_tpu_torch.engine import PortCase
        from cyclonus_tpu_torch.kube.yaml_io import parse_policy_dict
        from cyclonus_tpu_torch.serve import VerdictService
        from cyclonus_tpu_torch.tiers.model import (
            AdminNetworkPolicy, BaselineAdminNetworkPolicy, TierSet,
        )
        from cyclonus_tpu_torch.worker.model import Delta

        self._delta = Delta
        anps, banp = inputs["anps"], inputs["banp"]
        tiers = None
        if anps or banp:
            tiers = TierSet(anps=[AdminNetworkPolicy.from_dict(a) for a in anps],
                            banp=BaselineAdminNetworkPolicy.from_dict(banp) if banp else None)
        self.device = torch.device(device)
        self.svc = VerdictService(inputs["pods"], inputs["namespaces"],
                                  [parse_policy_dict(p) for p in inputs["policies"]],
                                  device=device, tiers=tiers)
        self.cases = [PortCase(*c) for c in mix["cases"]]

    def apply(self, deltas: Sequence[dict]) -> Dict:
        """The service's report {applied, mode, rejected, epoch, seconds}."""
        return self.svc.apply([self._delta(**d) for d in deltas])

    def recount(self) -> Dict[str, int]:
        """{ingress, egress, combined, cells} over the whole grid."""
        return self.svc.engine.evaluate_grid_counts(self.cases)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def route(self) -> Dict:
        """What the last recount ran: the steady state's mode and the
        counts kernels' launch counters."""
        from cyclonus_tpu_torch.engine import dense_kernel, packed_kernel

        eng = self.svc.engine
        launches = {k: v for k, v in {**packed_kernel.LAUNCHES, **dense_kernel.LAUNCHES}.items() if v}
        return {"mode": eng.pre_cache_stats()["mode"], "pack": bool(eng._pack),
                "tiers": "tiers" in eng._tensors, "class_state": eng._class_state is not None,
                "launches": launches}

    def close(self) -> None:
        self.svc = None

