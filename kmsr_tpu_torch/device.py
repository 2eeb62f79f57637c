"""Device selection for the port's entry points, and the deterministic
algorithms every trainer runs its steps under on the card."""
from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

#: cuBLAS's workspace setting that `torch.use_deterministic_algorithms`
#: needs; cuBLAS reads it when it first sizes a handle's workspace
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


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


def set_cublas_workspace_config() -> None:
    """Set CUBLAS_WORKSPACE_CONFIG unless the caller already did. The
    training CLIs (and `run_all`, whose stages run in its process) call it
    first, before anything touches CUDA."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


@contextlib.contextmanager
def deterministic(dev: str | torch.device = "cuda") -> Iterator[None]:
    """Run the block under PyTorch's deterministic algorithms (cuDNN's and
    cuBLAS's included) when `dev` is a CUDA device; on the CPU, do nothing.

    The JAX package's trainers are reproducible on the TPU: a fleet scene
    equals its standalone run at seed + s. On the card, cuDNN's
    deterministic flag alone leaves a chain-mode scene off its twin, and a
    GAN's steps amplify any difference; so every trainer runs its step
    loop in here. The flags found on entry are restored on exit.

    cuBLAS under these algorithms needs CUBLAS_WORKSPACE_CONFIG set before
    the process first uses cuBLAS (`set_cublas_workspace_config`; the
    training CLIs set it). A library caller that has not set it gets
    torch's RuntimeError at the first cuBLAS call in the block, not a
    silently non-deterministic run; one that used cuBLAS before setting it
    must set it earlier, as cuBLAS has already sized its workspace.
    """
    if torch.device(dev).type != "cuda":
        yield
        return
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[:2]
        torch.use_deterministic_algorithms(prev[2], warn_only=prev[3])
