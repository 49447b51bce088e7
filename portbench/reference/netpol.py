"""Plain reference: allow counts over the whole N x N x Q grid of a cluster.

Works out Kubernetes NetworkPolicy semantics (networking.k8s.io/v1), and
the AdminNetworkPolicy / BaselineAdminNetworkPolicy lattice
(policy.networking.k8s.io/v1alpha1) on top of it, from plain API dicts,
in plain PyTorch.  It imports nothing of the program under test and takes
nothing it made.

Semantics, per direction (ingress: the target is the destination pod and
the peer the source; egress the other way round):

  * a NetworkPolicy selects the pods of its namespace that its
    podSelector matches, for each direction in its policyTypes (absent:
    Ingress, plus Egress where it has egress rules);
  * a pod that no policy selects for a direction is allowed in that
    direction; a selected pod is allowed where some rule of a selecting
    policy matches both the peer and the port case;
  * a peer is an ipBlock (the peer's IP inside the CIDR and outside every
    except, for pods as for any address), or a pod selector in the
    policy's namespace, or a namespace selector (with an optional pod
    selector) over all namespaces; a rule with no peers matches every
    peer, and one with no ports every port case;
  * a port term matches a case (port, port name, protocol) on its
    protocol (default TCP) and on its number, its number range up to
    endPort, or its name;
  * with admin tiers: ANP rules in the order (priority, policy name,
    rule index) — the first whose subject holds the target, a peer the
    peer pod, and a port term the case decides: Allow, Deny, or Pass to
    the next tier; then the NetworkPolicy verdict for a pod that some
    NetworkPolicy selects; then the BANP's rules in declaration order;
    then allow;
  * combined = ingress and egress, each cell counted once; the grid
    holds every (source, destination) pair, a pod with itself included.

The arithmetic is exact: 0/1 matrices multiplied in float32 with TF32
off (every sum stays under 2**24), sums in float64 or int64. Pods with the
same namespace and labels select alike, so the target side runs over those
keys and the peer side over every pod; the work goes in blocks of keys and
of destination pods, so that its memory stays bounded as churn makes keys.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

#: (port, port name, protocol)
Case = Tuple[int, str, str]

ALLOW, DENY, PASS = 1, 2, 3
#: keys worked out together (a [KEY_BLOCK, pods] float32 product at a time)
KEY_BLOCK = 4096
#: destination pods counted together for the combined verdict
POD_BLOCK = 4096
_ACTIONS = {"Allow": ALLOW, "Deny": DENY, "Pass": PASS}


@contextmanager
def exact_matmul():
    """float32 products without TF32, restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _ipv4(s: str) -> int:
    parts = s.split(".")
    if len(parts) != 4:
        raise NotImplementedError(f"only IPv4 addresses are covered: {s!r}")
    a, b, c, d = (int(x) for x in parts)
    return (a << 24) | (b << 16) | (c << 8) | d


def _cidr(s: str) -> Tuple[int, int]:
    net, bits = s.split("/")
    bits = int(bits)
    mask = (0xFFFFFFFF << (32 - bits)) & 0xFFFFFFFF
    return _ipv4(net) & mask, mask


def _selector_terms(sel: Optional[dict], prefix: str) -> List[str]:
    sel = sel or {}
    if sel.get("matchExpressions"):
        raise NotImplementedError("matchExpressions are not covered by this reference")
    return [f"{prefix}{k}={v}" for k, v in (sel.get("matchLabels") or {}).items()]


def _np_peer(peer: dict, policy_ns: str) -> tuple:
    """A NetworkPolicy peer as a canonical key: ("ip", cidr, excepts) or
    ("sel", required terms)."""
    if "ipBlock" in peer:
        blk = peer["ipBlock"]
        return ("ip", blk["cidr"], tuple(sorted(blk.get("except") or ())))
    terms = _selector_terms(peer.get("podSelector"), "l:")
    if "namespaceSelector" in peer:
        terms += _selector_terms(peer["namespaceSelector"], "n:")
    else:
        terms.append(f"ns={policy_ns}")
    return ("sel", tuple(sorted(terms)))


def _scope(scope: dict) -> tuple:
    """An ANP/BANP subject or peer scope as a ("sel", terms) key."""
    if "namespaces" in scope:
        return ("sel", tuple(sorted(_selector_terms(scope["namespaces"], "n:"))))
    if "pods" in scope:
        p = scope["pods"] or {}
        terms = _selector_terms(p.get("namespaceSelector"), "n:")
        terms += _selector_terms(p.get("podSelector"), "l:")
        return ("sel", tuple(sorted(terms)))
    raise NotImplementedError(f"admin peer kind not covered: {sorted(scope)}")


_ALL = ("all",)


def np_port_matches(ports: Optional[list], case: Case) -> bool:
    if not ports:
        return True
    port, name, proto = case
    for p in ports:
        if p.get("protocol", "TCP") != proto:
            continue
        v = p.get("port")
        if v is None:
            return True
        if isinstance(v, str):
            if v == name:
                return True
        elif p.get("endPort") is not None:
            if v <= port <= p["endPort"]:
                return True
        elif v == port:
            return True
    return False


def admin_port_matches(ports: Optional[list], case: Case) -> bool:
    if not ports:
        return True
    port, name, proto = case
    for p in ports:
        if "portNumber" in p:
            pn = p["portNumber"]
            if pn["protocol"] == proto and pn["port"] == port:
                return True
        elif "portRange" in p:
            pr = p["portRange"]
            if pr["protocol"] == proto and pr["start"] <= port <= pr["end"]:
                return True
        elif "namedPort" in p:
            if p["namedPort"] == name:
                return True
        else:
            raise NotImplementedError(f"admin port kind not covered: {sorted(p)}")
    return False


def _policy_types(spec: dict) -> List[str]:
    types = spec.get("policyTypes")
    if types:
        return list(types)
    return ["Ingress"] + (["Egress"] if spec.get("egress") else [])


class PolicySet:
    """The policy side, compiled once: every selector as the set of terms
    it requires ("ns=<name>", "l:<key>=<value>" of the pod,
    "n:<key>=<value>" of its namespace), the peers, the NetworkPolicy
    rows (target, peer, ports) of each direction, and the admin rules."""

    def __init__(self, policies: Sequence[dict], anps: Sequence[dict] = (), banp=None):
        self.sels: Dict[tuple, int] = {}
        self.peers: Dict[tuple, int] = {}
        self.np_rows = {"ingress": [], "egress": []}
        self.np_targets = {"ingress": set(), "egress": set()}
        for pol in policies:
            ns = pol["metadata"].get("namespace") or "default"
            spec = pol["spec"]
            target = self._sel(("sel", tuple(sorted(
                _selector_terms(spec.get("podSelector"), "l:") + [f"ns={ns}"]))))
            for typ, d, side in (("Ingress", "ingress", "from"), ("Egress", "egress", "to")):
                if typ not in _policy_types(spec):
                    continue
                self.np_targets[d].add(target)
                for rule in spec.get(d) or []:
                    ports = rule.get("ports") or None
                    for peer in rule.get(side) or [None]:
                        k = self._peer(_ALL if peer is None else _np_peer(peer, ns))
                        self.np_rows[d].append((target, k, ports))
        # admin tiers: (subject selector, [peer], ports, action) per direction
        self.anp_rules = {"ingress": [], "egress": []}
        self.banp_rules = {"ingress": [], "egress": []}
        ordered = sorted(anps, key=lambda a: (a["spec"]["priority"], a["metadata"]["name"]))
        for tier, objs in ((self.anp_rules, ordered), (self.banp_rules, [banp] if banp else [])):
            for obj in objs:
                spec = obj["spec"]
                subj = self._sel(_scope(spec["subject"]))
                for d, side in (("ingress", "from"), ("egress", "to")):
                    for rule in spec.get(d) or []:
                        peers = [self._peer(_scope(s)) for s in rule.get(side) or []]
                        tier[d].append((subj, peers, rule.get("ports") or None,
                                        _ACTIONS[rule["action"]]))
        self.vocab: Dict[str, int] = {}
        for key in self.sels:
            for t in key[1]:
                self.vocab.setdefault(t, len(self.vocab))
        st = torch.zeros(len(self.sels), max(len(self.vocab), 1), dtype=torch.float32)
        for key, i in self.sels.items():
            for t in key[1]:
                st[i, self.vocab[t]] = 1.0
        self.st = st
        self._st_on = {}
        #: (pod key, namespace labels) -> the vocabulary columns it holds
        self._key_cols: Dict[tuple, List[int]] = {}

    def _sel(self, key: tuple) -> int:
        return self.sels.setdefault(key, len(self.sels))

    def _peer(self, key: tuple) -> int:
        if key[0] == "sel":
            self._sel(key)
        return self.peers.setdefault(key, len(self.peers))

    def st_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._st_on:
            self._st_on[key] = self.st.to(device)
        return self._st_on[key]

    def match_keys(self, keys: Sequence[tuple], namespaces: Dict[str, Dict[str, str]],
                   device) -> torch.Tensor:
        """[S, U]: selector s holds pod key u = (namespace, sorted labels)."""
        rows, cols = [], []
        for u, key in enumerate(keys):
            ns, labels = key
            hit = self._key_cols.get((key, tuple(sorted((namespaces.get(ns) or {}).items()))))
            if hit is None:
                terms = [f"ns={ns}"] + [f"l:{k}={v}" for k, v in labels]
                terms += [f"n:{k}={v}" for k, v in (namespaces.get(ns) or {}).items()]
                hit = [self.vocab[t] for t in terms if t in self.vocab]
                self._key_cols[(key, tuple(sorted((namespaces.get(ns) or {}).items())))] = hit
            rows += [u] * len(hit)
            cols += hit
        kt = torch.zeros(len(keys), self.st.shape[1], dtype=torch.float32)
        kt[torch.tensor(rows, dtype=torch.long), torch.tensor(cols, dtype=torch.long)] = 1.0
        st = self.st_on(device)
        with exact_matmul():
            return (st @ kt.to(device).T) == st.sum(dim=1, keepdim=True)


class _Compiled:
    """One cluster state against a PolicySet: pod keys, every selector
    matched against them, and the peer masks over every pod."""

    def __init__(self, pods, namespaces, ps: PolicySet, device):
        self.device = device
        self.ps = ps
        key_of: Dict[tuple, int] = {}
        pod_u, ips = [], []
        for ns, _name, labels, ip in pods:
            key = (ns, tuple(sorted(labels.items())))
            pod_u.append(key_of.setdefault(key, len(key_of)))
            ips.append(_ipv4(ip))
        self.n = len(pod_u)
        self.u = len(key_of)
        self.pod_u = torch.tensor(pod_u, dtype=torch.long, device=device)
        self.ip = torch.tensor(ips, dtype=torch.long, device=device)
        self.key_count = torch.bincount(self.pod_u, minlength=self.u).to(torch.float64)
        self.sel_keys = ps.match_keys(list(key_of), namespaces, device)  # [S, U]
        mp = torch.zeros(len(ps.peers), self.n, dtype=torch.bool, device=device)
        sel_peers = [(k, ps.sels[key]) for key, k in ps.peers.items() if key[0] == "sel"]
        if sel_peers:
            rows = torch.tensor([k for k, _ in sel_peers], device=device)
            cols = torch.tensor([s for _, s in sel_peers], device=device)
            mp[rows] = self.sel_keys[cols][:, self.pod_u]
        for key, k in ps.peers.items():
            if key[0] == "all":
                mp[k] = True
            elif key[0] == "ip":
                net, mask = _cidr(key[1])
                m = (self.ip & mask) == net
                for ex in key[2]:
                    enet, emask = _cidr(ex)
                    m &= (self.ip & emask) != enet
                mp[k] = m
        self.peer_pods = mp  # [K, N]

    def _selected(self, d: str) -> torch.Tensor:
        """[U]: some NetworkPolicy selects the key in direction d."""
        targets = sorted(self.ps.np_targets[d])
        if not targets:
            return torch.zeros(self.u, dtype=torch.bool, device=self.device)
        return self.sel_keys[torch.tensor(targets, device=self.device)].any(dim=0)

    def _np_weights(self, d: str, case: Case) -> Optional[torch.Tensor]:
        """[S, K]: 1 where a selector is the target of a rule of direction d
        that holds the peer and matches the case."""
        ps = self.ps
        rows = [(t, k) for t, k, ports in ps.np_rows[d] if np_port_matches(ports, case)]
        if not rows:
            return None
        w = torch.zeros(len(ps.sels), len(ps.peers), dtype=torch.float32, device=self.device)
        w[torch.tensor([t for t, _ in rows], device=self.device),
          torch.tensor([k for _, k in rows], device=self.device)] = 1.0
        return w

    def _rule_mask(self, subj: int, peers: List[int], lo: int, hi: int) -> torch.Tensor:
        sub = self.sel_keys[subj, lo:hi]
        if peers:
            peer = self.peer_pods[torch.tensor(peers, device=self.device)].any(dim=0)
        else:
            peer = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        return sub[:, None] & peer[None, :]

    def allowed(self, d: str, case: Case) -> torch.Tensor:
        """[U, N]: target key x peer pod allowed in direction d, worked out
        in blocks of KEY_BLOCK keys."""
        out = torch.empty(self.u, self.n, dtype=torch.bool, device=self.device)
        selected = self._selected(d)
        w = self._np_weights(d, case)
        anp = [r for r in self.ps.anp_rules[d] if admin_port_matches(r[2], case)]
        banp = [r for r in self.ps.banp_rules[d] if admin_port_matches(r[2], case)]
        peers = self.peer_pods.to(torch.float32) if w is not None else None
        for lo in range(0, self.u, KEY_BLOCK):
            hi = min(lo + KEY_BLOCK, self.u)
            if w is None:
                np_allow = torch.zeros(hi - lo, self.n, dtype=torch.bool, device=self.device)
            else:
                with exact_matmul():
                    key_peer = (self.sel_keys[:, lo:hi].T.to(torch.float32) @ w) > 0  # [B, K]
                    np_allow = (key_peer.to(torch.float32) @ peers) > 0
            sel = selected[lo:hi, None]
            if not anp and not banp:
                out[lo:hi] = np_allow | ~sel
                continue
            decided = torch.zeros(hi - lo, self.n, dtype=torch.int8, device=self.device)
            for subj, rule_peers, _ports, action in anp:
                decided[self._rule_mask(subj, rule_peers, lo, hi) & (decided == 0)] = action
            base = torch.ones(hi - lo, self.n, dtype=torch.bool, device=self.device)
            base_done = torch.zeros_like(base)
            for subj, rule_peers, _ports, action in banp:
                m = self._rule_mask(subj, rule_peers, lo, hi) & ~base_done
                base[m] = action == ALLOW
                base_done |= m
            lower = torch.where(sel, np_allow, base)
            out[lo:hi] = torch.where(decided == ALLOW, True,
                                     torch.where(decided == DENY, False, lower))
        return out


def grid_counts(
    pods: Iterable[tuple],
    namespaces: Dict[str, Dict[str, str]],
    policies: Sequence[dict],
    cases: Sequence[Case],
    anps: Sequence[dict] = (),
    banp: Optional[dict] = None,
    device="cpu",
    policy_set: Optional[PolicySet] = None,
) -> Dict[str, int]:
    """{ingress, egress, combined, cells}: the allowed cells of each
    direction, of both, and all cells, summed over the port cases.
    `policy_set`, when given, is PolicySet(policies, anps, banp) compiled
    once for several states."""
    ps = policy_set or PolicySet(policies, anps, banp)
    c = _Compiled(list(pods), namespaces, ps, device)
    out = {"ingress": 0, "egress": 0, "combined": 0, "cells": c.n * c.n * len(cases)}
    for case in cases:
        # ingress: [dst key, src pod]; egress: [src key, dst pod]
        a_in = c.allowed("ingress", tuple(case))
        a_eg = c.allowed("egress", tuple(case))
        for d, a in (("ingress", a_in), ("egress", a_eg)):
            out[d] += int((c.key_count * a.sum(dim=1, dtype=torch.float64)).sum())
        # combined, a block of destination pods at a time: ingress rows of
        # their keys against the egress columns of their pods, by source key
        for lo in range(0, c.n, POD_BLOCK):
            hi = min(lo + POD_BLOCK, c.n)
            ing = a_in[c.pod_u[lo:hi]]  # [dst, src]
            egr = a_eg[:, lo:hi][c.pod_u]  # [src, dst]
            out["combined"] += int((ing & egr.T).sum(dtype=torch.int64))
        del a_in, a_eg
    return out
