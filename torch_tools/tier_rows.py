"""Time the tiered packed counts kernel (K3-plain) against the number of
tier rows, at the packed plan's headline shapes.

    python3 torch_tools/tier_rows.py [--rows 4,32,256,1500] [--out FILE]

Run from the root of a checkout: it times that checkout's
cyclonus_tpu_torch, so two checkouts (say a parent and a change, each
unpacked with `git archive`) can be compared on one card.  The operands
are the headline's packed shapes: Q = 2 port cases, 100,352 pods a side,
We = 8 and Wi = 12 words of sparse random target bits.  For each G it
draws G tier rows per direction from a seed on the card, laid out as the
engine emits them (ANP rows by key, then BANP rows by key, a fifth of the
rows pads) and sparser as G grows, so that a cell matches a handful of
rows.  It reports the kernel's median time under CUDA events (5 runs
after 1 warm-up; the operand layout is built once, outside the timing),
the untiered kernel (K1) on the same operands, and the sums of each
output, which two checkouts must agree on.  Prints the card's name and
power limit, then one JSON line, and writes the line to --out.  Needs a
CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

Q, N_PODS, WE, WI = 2, 100_352, 8, 12
SEED = 20260729


def _time_ms(fn, reps=5, warm=1):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _words(gen, shape, p=0.02):
    """Packed int32 words of bits set with probability p."""
    import torch

    bits = torch.rand(shape + (32,), generator=gen, device="cuda") < p
    weights = torch.tensor([1 << b if b < 31 else -(1 << 31) for b in range(32)],
                           dtype=torch.int32, device="cuda")
    return (bits.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def _tier_side(gen, g, n_subj, n_peer, none):
    import torch

    p = min(0.3, 4 / g) ** 0.5
    rank = torch.randint(0, max(g // 2, 1), (g,), generator=gen, device="cuda")
    banp = torch.rand(g, generator=gen, device="cuda") < 0.3
    act_anp = torch.randint(1, 4, (g,), generator=gen, device="cuda")
    act_banp = torch.randint(1, 3, (g,), generator=gen, device="cuda")
    key = (rank * 4 + torch.where(banp, act_banp, act_anp)).to(torch.int32)
    # the engine's order: ANP rows by key, then BANP rows by key
    key = torch.cat([key[~banp].sort().values, key[banp].sort().values])
    banp = banp.sort().values
    pad = torch.rand(g, generator=gen, device="cuda") < 0.2
    keep = torch.tensor(none, dtype=torch.int32, device="cuda")
    return {
        "subj": torch.rand((g, n_subj), generator=gen, device="cuda") < p,
        "peerq": torch.rand((g, n_peer, Q), generator=gen, device="cuda") < p,
        "anp_key": torch.where(~banp & ~pad, key, keep),
        "banp_key": torch.where(banp & ~pad, key, keep),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="4,32,256,1500")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tier_rows: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    from cyclonus_tpu_torch.engine import packed_kernel as pk
    from cyclonus_tpu_torch.engine.encoding import TIER_KEY_NONE

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    n = N_PODS
    flags = lambda: torch.rand(n, generator=gen, device="cuda") < 0.7  # noqa: E731
    ops_args = [_words(gen, (WE, n)), flags(), _words(gen, (WE, n, Q)),
                _words(gen, (WI, n)), flags(), _words(gen, (WI, n, Q))]
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    bs, bd = pk.PACKED_BS, pk.PACKED_BD

    def run(tier):
        ops = pk._packed_operands(*ops_args, valid, valid, tier, None, bs, bd)
        out = pk._counts_cuda(ops, bs)
        sums = [int(v) for v in out.to(torch.int64).sum(dim=(0, 1)).tolist()]
        ms = _time_ms(lambda: pk._counts_cuda(ops, bs))
        del ops
        torch.cuda.empty_cache()
        return {"ms": ms, "sums": sums}

    result = {"card": card, "q": Q, "pods": n, "we": WE, "wi": WI, "k1": run(None), "k3": {}}
    print(f"K1: {result['k1']}", flush=True)
    for g in (int(x) for x in args.rows.split(",")):
        tier = {"egress": _tier_side(gen, g, n, n, TIER_KEY_NONE),
                "ingress": _tier_side(gen, g, n, n, TIER_KEY_NONE)}
        rec = run(tier)
        rec["real"] = [int(((t["anp_key"] < TIER_KEY_NONE) | (t["banp_key"] < TIER_KEY_NONE)).sum())
                       for t in (tier["egress"], tier["ingress"])]
        result["k3"][g] = rec
        print(f"K3-plain, {g} tier rows a direction: {rec}", flush=True)
        del tier
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
