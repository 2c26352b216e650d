"""The device every public entry point of the port resolves its
``device`` argument through.

Entry points default to ``device="cuda"``: the port runs on the card
unless the caller asks for the CPU.  Without CUDA the default raises
and names ``device='cpu'``; nothing falls back to the CPU silently.
"""

from __future__ import annotations

import torch


def resolve_device(device, caller: str = "the port") -> torch.device:
    """``device`` as a :class:`torch.device`; raises RuntimeError when it
    names CUDA and no CUDA device is available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller} runs on a CUDA device by default, and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device
