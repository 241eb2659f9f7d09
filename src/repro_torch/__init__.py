"""PyTorch port of the BPD reproduction, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its module
names, function names, tensor layouts and parameter key paths, and imports
nothing of it (nor ``jax``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the hand-written CUDA kernels under ``kernels/csrc``
replace the reference's Pallas kernels on the decode path, and their plain
PyTorch versions serve CPU tensors and the tests.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on.

    ``None`` means the card.  Asking for CUDA on a host without one raises
    instead of dropping to the CPU: pass ``device="cpu"`` (``--device cpu``
    on the command line) to run on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU")
    return dev
