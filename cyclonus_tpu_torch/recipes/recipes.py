"""The 15 canned recipe scenarios (reference: pkg/recipes/policies.go,
recipe.go:15-54; scenarios from the public kubernetes-network-policy-recipes
collection).

Every recipe runs the simulated probe (engine selectable: 'oracle' scalar
path, or 'cuda' / 'cuda-sharded' on the port's engine — all must render
identical tables) and prints the explain/resources/result tables,
mirroring recipes.Run() (recipe.go:56-72).  A copy of the reference's
recipes/recipes.py, with the engine's `device`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..kube.netpol import IntOrString, NetworkPolicy
from ..kube.yaml_io import load_policies_from_yaml
from ..matcher import build_network_policies, explain_table
from ..probe.pod import Container, Pod
from ..probe.probeconfig import ProbeConfig
from ..probe.resources import Resources
from ..probe.runner import DEFAULT_ENGINE, new_simulated_runner
from ..probe.table import Table


def _pods(
    spec: List[tuple], port: int = 80, protocol: str = "TCP"
) -> List[Pod]:
    """spec rows: (namespace, name, labels-or-None)."""
    return [
        Pod(
            namespace=ns,
            name=name,
            labels=dict(labels or {}),
            containers=[Container.default(port, protocol)],
        )
        for ns, name, labels in spec
    ]


def _default_grid(
    namespaces: Dict[str, Dict[str, str]],
    special: Dict[str, Dict[str, str]],
    port: int = 80,
) -> Resources:
    """A 3-namespace x {a,b,c} pod grid; `special` maps 'ns/pod' to labels."""
    rows = [
        (ns, name, special.get(f"{ns}/{name}"))
        for ns in namespaces
        for name in ("a", "b", "c")
    ]
    return Resources(namespaces=namespaces, pods=_pods(rows, port=port))


@dataclass
class Recipe:
    """recipe.go:15-20."""

    name: str
    policy_yamls: List[str]
    resources: Resources
    protocol: str
    port: int

    def policies(self) -> List[NetworkPolicy]:
        out: List[NetworkPolicy] = []
        for y in self.policy_yamls:
            out.extend(load_policies_from_yaml(y))
        return out

    def run_probe(self, engine: str = DEFAULT_ENGINE, policy=None, device=None) -> Table:
        """recipe.go:33-36.  `policy` reuses an already-built matcher set;
        `device` is the engine's torch device (None: the current CUDA
        device)."""
        if policy is None:
            policy = build_network_policies(True, self.policies())
        runner = new_simulated_runner(policy, engine=engine, device=device)
        return runner.run_probe_for_config(
            ProbeConfig.port_protocol_config(IntOrString(self.port), self.protocol),
            self.resources,
        )


_PLAIN_NS = {"x": {}, "default": {}, "y": {}}

# 01: deny all traffic to an application
RECIPE_01 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: web-deny-all
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: web
  ingress: []
"""

# 02: limit traffic to an application
RECIPE_02 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: api-allow
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: bookstore
      role: api
  ingress:
    - from:
        - podSelector:
            matchLabels:
              app: bookstore
"""

# 02a: allow all traffic to an application (stacked over 01)
RECIPE_02A = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: web-allow-all
  namespace: default
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: web
  ingress:
    - {}
"""

# 03: deny all non-whitelisted traffic in a namespace
RECIPE_03 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: default-deny-all
  namespace: default
spec:
  policyTypes:
    - Ingress
  podSelector: {}
  ingress: []
"""

# 04: deny traffic from other namespaces (empty matchLabels podSelector)
RECIPE_04 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  namespace: secondary
  name: deny-from-other-namespaces
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
  ingress:
    - from:
        - podSelector: {}
"""

# 05: allow traffic from all namespaces
RECIPE_05 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  namespace: default
  name: web-allow-all-namespaces
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: web
  ingress:
    - from:
        - namespaceSelector: {}
"""

# 06: allow traffic from a namespace by label
RECIPE_06 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: web-allow-prod
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: web
  ingress:
    - from:
        - namespaceSelector:
            matchLabels:
              purpose: production
"""

# 07: allow traffic from some pods in another namespace (ns AND pod selector)
RECIPE_07 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: web-allow-all-ns-monitoring
  namespace: default
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: web
  ingress:
    - from:
        - namespaceSelector:
            matchLabels:
              team: operations
          podSelector:
            matchLabels:
              type: monitoring
"""

# 08: allow external traffic (empty from, stacked over 01)
RECIPE_08 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: web-allow-external
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: web
  ingress:
    - from: []
"""

# 09: allow traffic only to a port of an application
RECIPE_09 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: api-allow-5000
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: apiserver
  ingress:
    - ports:
        - port: 5000
      from:
        - podSelector:
            matchLabels:
              role: monitoring
"""

# 10: allow traffic from apps using multiple selectors
RECIPE_10 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: redis-allow-services
spec:
  policyTypes:
    - Ingress
  podSelector:
    matchLabels:
      app: bookstore
      role: db
  ingress:
    - from:
        - podSelector:
            matchLabels:
              app: bookstore
              role: search
        - podSelector:
            matchLabels:
              app: bookstore
              role: api
        - podSelector:
            matchLabels:
              app: inventory
              role: web
"""

# 11: deny egress traffic from an application
RECIPE_11_1 = """
apiVersion: networking.k8s.io/v1
kind: NetworkPolicy
metadata:
  name: foo-deny-egress
spec:
  podSelector:
    matchLabels:
      app: foo
  policyTypes:
    - Egress
  egress: []
"""

# 11 variant: deny egress except DNS
RECIPE_11_2 = """
apiVersion: networking.k8s.io/v1
kind: NetworkPolicy
metadata:
  name: foo-deny-egress
spec:
  podSelector:
    matchLabels:
      app: foo
  policyTypes:
    - Egress
  egress:
    - ports:
        - port: 53
          protocol: UDP
        - port: 53
          protocol: TCP
"""

# 12: deny all non-whitelisted egress in a namespace
RECIPE_12 = """
kind: NetworkPolicy
apiVersion: networking.k8s.io/v1
metadata:
  name: default-deny-all-egress
  namespace: default
spec:
  policyTypes:
    - Egress
  podSelector: {}
  egress: []
"""

# 14: limit egress to the cluster (deny external egress)
RECIPE_14 = """
apiVersion: networking.k8s.io/v1
kind: NetworkPolicy
metadata:
  name: foo-deny-external-egress
spec:
  podSelector:
    matchLabels:
      app: foo
  policyTypes:
    - Egress
  egress:
    - ports:
        - port: 53
          protocol: UDP
        - port: 53
          protocol: TCP
    - to:
        - namespaceSelector: {}
"""


def _build_all() -> List[Recipe]:
    web = {"default/b": {"app": "web"}}
    foo = {"default/b": {"app": "foo"}}
    bookstore = {
        "x/b": {"app": "bookstore"},
        "default/a": {"app": "bookstore"},
        "default/b": {"app": "bookstore", "role": "api"},
        "default/c": {"role": "api"},
        "y/c": {"app": "bookstore"},
    }
    monitoring = {
        "x/a": {"type": "monitoring"},
        "default/a": {"type": "monitoring"},
        "default/b": {"app": "web"},
        "y/a": {"type": "monitoring"},
    }
    apiserver = {
        "x/a": {"role": "monitoring"},
        "default/a": {"role": "monitoring"},
        "default/b": {"app": "apiserver"},
        "y/a": {"role": "monitoring"},
    }
    redis_rows = [
        ("x", "a", None),
        ("x", "b", None),
        ("x", "c", None),
        ("default", "a", {"app": "bookstore", "role": "search"}),
        ("default", "b", {"app": "bookstore", "role": "db"}),
        ("default", "c", {"app": "bookstore", "role": "api"}),
        ("default", "d", {"app": "inventory", "role": "web"}),
        ("y", "a", {"app": "bookstore", "role": "search"}),
        ("y", "b", {"app": "bookstore", "role": "api"}),
        ("y", "c", {"app": "inventory", "role": "web"}),
    ]
    secondary_ns = {"x": {}, "default": {}, "secondary": {}}
    prod_ns = {"x": {"purpose": "production"}, "default": {}, "y": {}}
    ops_ns = {"x": {"team": "operations"}, "default": {}, "y": {"team": "operations"}}

    return [
        Recipe("01-deny-all-to-app", [RECIPE_01], _default_grid(_PLAIN_NS, web), "TCP", 80),
        Recipe("02-limit-to-app", [RECIPE_02], _default_grid(_PLAIN_NS, bookstore), "TCP", 80),
        Recipe(
            "02a-allow-all-to-app",
            [RECIPE_01, RECIPE_02A],
            _default_grid(_PLAIN_NS, web),
            "TCP",
            80,
        ),
        Recipe("03-default-deny-ns", [RECIPE_03], _default_grid(_PLAIN_NS, {}), "TCP", 80),
        Recipe(
            "04-deny-other-namespaces",
            [RECIPE_04],
            _default_grid(secondary_ns, {}),
            "TCP",
            80,
        ),
        Recipe(
            "05-allow-all-namespaces",
            [RECIPE_01, RECIPE_05],
            _default_grid(_PLAIN_NS, web),
            "TCP",
            80,
        ),
        Recipe("06-allow-prod-namespace", [RECIPE_06], _default_grid(prod_ns, web), "TCP", 80),
        Recipe(
            "07-allow-monitoring-pods",
            [RECIPE_07],
            _default_grid(ops_ns, monitoring),
            "TCP",
            80,
        ),
        Recipe(
            "08-allow-external",
            [RECIPE_01, RECIPE_08],
            _default_grid(_PLAIN_NS, web),
            "TCP",
            80,
        ),
        Recipe(
            "09-allow-port-5000",
            [RECIPE_09],
            _default_grid(_PLAIN_NS, apiserver, port=5000),
            "TCP",
            5000,
        ),
        Recipe(
            "10-multiple-selectors",
            [RECIPE_10],
            Resources(namespaces=dict(_PLAIN_NS), pods=_pods(redis_rows)),
            "TCP",
            80,
        ),
        Recipe("11-deny-egress", [RECIPE_11_1], _default_grid(_PLAIN_NS, foo), "TCP", 80),
        Recipe(
            "11a-deny-egress-allow-dns",
            [RECIPE_11_2],
            _default_grid(_PLAIN_NS, foo),
            "TCP",
            53,
        ),
        Recipe(
            "12-default-deny-egress-ns",
            [RECIPE_12],
            _default_grid(_PLAIN_NS, {}),
            "TCP",
            80,
        ),
        Recipe(
            "14-deny-external-egress",
            [RECIPE_14],
            _default_grid(_PLAIN_NS, foo),
            "TCP",
            80,
        ),
    ]


ALL_RECIPES: List[Recipe] = _build_all()


def run_all_recipes(engine: str = DEFAULT_ENGINE, out=None, device=None) -> None:
    """recipe.go:56-72: print explain/resources/result tables per recipe."""
    import sys

    out = out or sys.stdout
    for recipe in ALL_RECIPES:
        policy = build_network_policies(True, recipe.policies())
        table = recipe.run_probe(engine=engine, policy=policy, device=device)
        out.write(f"=== recipe {recipe.name} ===\n")
        out.write(f"Policies:\n{explain_table(policy)}\n")
        out.write(f"Resources:\n{recipe.resources.render_table()}\n")
        out.write(f"Results:\n{table.render_table()}\n")
        out.write(f"Ingress:\n{table.render_ingress()}\n")
        out.write(f"Egress:\n{table.render_egress()}\n\n")
