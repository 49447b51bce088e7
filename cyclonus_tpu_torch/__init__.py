"""cyclonus-tpu on PyTorch and CUDA: the NetworkPolicy verdict engine of
`cyclonus_tpu`, ported to one NVIDIA H100.

The host layers (kube, the scalar matcher, the tensor compiler) are
copies of the reference package's; the device layers are PyTorch, and
the packed verdict-count kernel is hand-written CUDA for sm_90a
(csrc/packed_counts.cu).  Nothing here imports jax or cyclonus_tpu.

    from cyclonus_tpu_torch.engine import TorchPolicyEngine, PortCase

The probe runner, the conformance interpreter and the `probe` / `generate`
commands run on that engine: `python -m cyclonus_tpu_torch probe --mock`.
"""

__version__ = "0.1.0"
