"""Kernel ``fused_mlp_chain`` (``ops/fused_mlp.py`` → ``csrc/fused_mlp.cu``):
the summed bound of the chains it runs in a traced stretch of forwards
(their operations at the dense TF32 peak, their bytes at HBM bandwidth,
whichever is larger; ``portbench/counts.py``) over the device time of its
operations, in %. Its operations: ``chain_kernel`` taking a ``Chain`` and
the ``pool_kernel`` that reduces a pooled chain's tile maxima."""

from portbench.metrics import _kernels

PATTERN = r"chain_kernel.*\bChain\b|(?<![A-Za-z0-9_])pool_kernel\b"


def read(layers):
    return _kernels.roofline(layers, "fused_mlp_chain", PATTERN, int8=False)
