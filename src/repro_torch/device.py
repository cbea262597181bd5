"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
explicit ``"cpu"`` and no CUDA device they raise, and nothing falls back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return the torch device to run on; raise if CUDA is asked for and absent.

    Also turns TF32 off for matmuls and cuDNN, so float32 runs on the card
    are full float32 (the references compare at 2e-5).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA device requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
