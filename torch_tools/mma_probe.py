"""Probe of the tensor-core instructions for the packed counts' boolean
contraction on one Hopper card (mma_probe.cu beside this script).

    python3 torch_tools/mma_probe.py [--out FILE]      (from the repo root)

Builds mma_probe.cu once per instruction (single-bit wgmma
m64n256k256 and.popc, single-bit mma.sync m16n8k256 and.popc, int8 wgmma
m64n256k32) with `-Xptxas -v`, and reports for each whether ptxas accepted
it, ptxas's notes (a serialized wgmma shows as note C7520), and its
measured rate: multiply-adds per second (a bit multiply-add for the
single-bit ones, an int8 one for the yardstick) in a tight loop of products
from shared memory on every SM.  The single-bit wgmma is also checked
against popc(a & b) on random bits through TMA in the 32-, 64- and 128-byte
swizzles.  Prints one JSON line and writes it to --out.  Needs a CUDA card
and nvcc; exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PROBES = {
    1: "wgmma m64n256k256 .s32.b1.b1.and.popc",
    2: "mma.sync m16n8k256 .s32.b1.b1.s32.and.popc",
    3: "wgmma m64n256k32 .s32.s8.s8",
}


def _build(n: int):
    from cyclonus_tpu_torch.engine import build

    out_dir = build.build_dir() / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libmma_probe{n}.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", f"-DPROBE={n}",
           "-o", str(lib), str(Path(__file__).with_name("mma_probe.cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    return (lib if proc.returncode == 0 else None), log


def _notes(log: str):
    return [ln.strip() for ln in log.splitlines()
            if "C75" in ln or "serializ" in ln or "spill" in ln or "error" in ln.lower()]


def _rate(lib, torch) -> dict:
    lib.probe_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.probe_macs_per_round.restype = ctypes.c_double
    lib.probe_error_string.restype = ctypes.c_char_p
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms
    sink = torch.zeros(blocks * lib.probe_threads(), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(rounds):
        err = lib.probe_rate(blocks, rounds, sink.data_ptr(), stream)
        if err:
            raise RuntimeError(lib.probe_error_string(err).decode())

    run(16)
    torch.cuda.synchronize()
    rounds = 256
    times = []
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(rounds)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms > 20 or rounds >= 1 << 22:
            break
        rounds *= 4
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(rounds)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    ms = times[len(times) // 2]
    macs = lib.probe_macs_per_round() * rounds * blocks
    return {"blocks": blocks, "rounds": rounds, "ms": ms, "macs_per_s": macs / (ms / 1e3)}


def _check(lib, torch) -> dict:
    import numpy as np

    lib.probe_check.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    rng = np.random.default_rng(7)
    out = {}
    t = np.arange(128)
    warp, lane = t // 32, t % 32
    i = np.arange(128)
    # accumulator i of thread t: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
    # col 8 (i / 4) + 2 (lane % 4) + i % 2
    rows = 16 * warp[:, None] + lane[:, None] // 4 + 8 * ((i[None, :] >> 1) & 1)
    cols = 8 * (i[None, :] >> 2) + 2 * (lane[:, None] % 4) + (i[None, :] & 1)
    for kk in (32, 64, 128):
        a = rng.integers(0, 256, size=(64, kk), dtype=np.uint8)
        b = rng.integers(0, 256, size=(256, kk), dtype=np.uint8)
        want = np.unpackbits(a[:, None, :] & b[None, :, :], axis=2).sum(axis=2)
        ta = torch.from_numpy(a).cuda()
        tb = torch.from_numpy(b).cuda()
        got = torch.zeros((128, 128), dtype=torch.int32, device="cuda")
        err = lib.probe_check(kk, ta.data_ptr(), tb.data_ptr(), got.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            out[kk] = f"launch failed ({err})"
            continue
        g = got.cpu().numpy()
        bad = int((g != want[rows, cols]).sum())
        out[kk] = "equal" if bad == 0 else f"{bad} of 16384 differ"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mma_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "probes": {}}
    for n, what in PROBES.items():
        lib_path, log = _build(n)
        rec = {"instruction": what, "accepted": lib_path is not None, "ptxas_notes": _notes(log)}
        print(f"--- probe {n}: {what}\n{log}", flush=True)
        if lib_path is not None:
            lib = ctypes.CDLL(str(lib_path))
            rec.update(_rate(lib, torch))
            if n == 1:
                rec["check"] = _check(lib, torch)
        result["probes"][n] = rec
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
