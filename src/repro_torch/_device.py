"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
resolves to ``"cuda"``, and a CUDA device with no card present raises --
nothing carries on silently on the CPU.  The tests pass ``device="cpu"``.

Float32 throughout: importing the package turns TF32 off for matrix
products and cuDNN convolutions, so a float32 product on the card keeps its
full 24-bit mantissa, as the reference computes it.

Divisions by a count go through :func:`div_exact`: CUDA divides a tensor
by a Python number as a product with the number's reciprocal, which can be
one ulp off the quotient the CPU and the reference compute.
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


def exact_divisor(n, like: torch.Tensor) -> torch.Tensor:
    """The Python number ``n`` as a 0-dim tensor of like's dtype on like's
    device.  CUDA divides by a tensor, but turns a division by a Python
    number into a product with its reciprocal, one ulp off the quotient
    for a share of values (4.5 % at n = 127, 29 % at n = 300 in float32).
    On the CPU both forms divide."""
    return torch.full((), n, dtype=like.dtype, device=like.device)


def div_exact(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` correctly rounded on every device (see
    :func:`exact_divisor`)."""
    return t / exact_divisor(n, t)
