"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and never fall back to the CPU on
their own: a caller who wants the CPU (the tests) asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device`` and pin float32 math to full float32.

    A float32 convolution goes through cuDNN in TF32 by default, which keeps
    about three decimal digits; the JAX reference computes in float32, so
    both TF32 switches are turned off here, at every entry point. bf16
    products (``compute_dtype: bfloat16``) accumulate in float32 in the JAX
    package (``preferred_element_type``); cuBLAS may otherwise reduce
    split-K partials in bf16, so that is turned off too.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
