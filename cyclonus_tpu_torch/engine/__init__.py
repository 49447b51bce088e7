"""The verdict engine: host tensor compiler (encoding, host), plain
PyTorch kernels (kernel, tiled), the CUDA packed counts kernel
(packed_kernel, build) and the TorchPolicyEngine facade (api)."""

from .api import GridVerdict, PortCase, TorchPolicyEngine
from .encoding import ClusterEncoding, PolicyEncoding, encode_cluster, encode_policy

__all__ = [
    "ClusterEncoding",
    "GridVerdict",
    "PolicyEncoding",
    "PortCase",
    "TorchPolicyEngine",
    "encode_cluster",
    "encode_policy",
]
