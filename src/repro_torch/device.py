"""Device selection: entry points default to the card and never fall back.

Every entry point takes ``device`` (default ``"cuda"``); tests pass
``"cpu"``. Asking for CUDA where there is none is a configuration error,
raised here, instead of a run that quietly measures the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a `torch.device`; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
