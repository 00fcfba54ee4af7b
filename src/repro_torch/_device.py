"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``"cuda"``, and a CUDA device with no card present raises --
nothing carries on silently on the CPU.  The tests pass ``device="cpu"``.

Float32 throughout: importing the package turns TF32 off for matrix
products and cuDNN convolutions, so a float32 product on the card keeps its
full 24-bit mantissa, as the reference computes it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device; raise when a CUDA device is asked
    for and no card is present.  A CUDA device always carries its index,
    so devices compare equal to the ones tensors report."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the "
                "CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
