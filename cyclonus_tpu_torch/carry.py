"""State carried across from the reference engine: its numpy tensor dict
(`TpuPolicyEngine._tensors`, or a class state's `ctensors`) as the
port's torch tensors on the device that resolve_device names.

The engine's tensors are integer and boolean arrays built on the host;
the port moves the same bytes onto its device.  `uint32` columns (pod
IPs and CIDR bases/masks) widen to `int64`: torch supports few
operations on `uint32` (no shifts, no searchsorted), and a widened value
compares and masks exactly like the unsigned one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_DTYPES = {
    np.dtype(bool): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.float32): torch.float32,
}


def resolve_device(device=None) -> torch.device:
    """`device`, or the current CUDA device when None; raises when that
    is not available (the port never falls back to the CPU on its own:
    a caller who wants the CPU asks for it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the engine on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but no CUDA device is available")
    return device


def to_torch(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array as a torch tensor on `device` (uint32 -> int64).
    Always a copy, on the CPU too: the tensor never shares memory with
    the host array, so an edit of one is not an edit of the other."""
    a = np.asarray(a)
    dtype = _DTYPES.get(a.dtype)
    if dtype is None:
        raise TypeError(f"unsupported tensor dtype {a.dtype}")
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype, copy=True)


def tensors_from_reference(np_tensors: Dict, device) -> Dict:
    """The reference's nested numpy tensor dict as torch tensors on
    `device`, leaf by leaf; non-array leaves pass through unchanged."""
    out = {}
    for k, v in np_tensors.items():
        if isinstance(v, dict):
            out[k] = tensors_from_reference(v, device)
        elif isinstance(v, np.ndarray):
            out[k] = to_torch(v, device)
        else:
            out[k] = v
    return out
