"""Device selection shared by every entry point of the port.

Entry points default to the card (``device="cuda"``). The CPU runs only when
the caller asks for it (``device="cpu"``, as the tests do); a CUDA request on a
machine without a usable GPU raises instead of quietly running on the CPU.

On the fp32 path both TF32 switches are turned off explicitly: a float32
matmul on the card is full fp32 by default, but a float32 convolution goes
through cuDNN in TF32 by default, and TF32 keeps about three decimal digits —
too few for the 1e-5 / 5e-3 parity the port is held to.

Under a bfloat16 compute dtype (``train --dtype bfloat16``) cuBLAS may
reduce a split-K product's partial sums in bfloat16 unless told not to. It
is told not to: XLA, which the JAX package runs on, accumulates a bfloat16
dot in float32 and rounds once, and so does every product here.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument; raises when
    CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda | cpu)")
    return dev
