"""Kernel ``quantized_mlp_chain`` (``ops/quantized_mlp.py`` →
``csrc/quantized_mlp.cu``): the summed bound of the chains it runs in a
traced stretch of forwards (their int8 operations at the dense int8 peak,
their bytes at HBM bandwidth, whichever is larger; ``portbench/counts.py``)
over the device time of its operations, in %. Its operations: the
``absmax_kernel`` and every pass of ``chain_kernel`` taking ``Params``."""

from portbench.metrics import _kernels

PATTERN = r"chain_kernel.*\bParams\b|absmax_kernel"


def read(layers):
    return _kernels.roofline(layers, "quantized_mlp_chain", PATTERN, int8=True)
