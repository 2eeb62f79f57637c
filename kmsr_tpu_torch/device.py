"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device an entry point runs on.

    "cuda" (the default of every entry point) requires a usable card and
    raises RuntimeError without one: the port never downgrades to the CPU
    on its own. Pass device="cpu" to run the plain PyTorch path on the
    host, as the tests do.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                f"(torch {torch.__version__}, built for CUDA "
                f"{torch.version.cuda}); pass device='cpu' to run the plain "
                f"PyTorch path on the host"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {str(device)!r}")
    return dev
