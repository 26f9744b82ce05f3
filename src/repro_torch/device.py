"""Device selection: the GPU by default, the CPU only when asked for."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` means the GPU.  Without a visible CUDA device this raises
    instead of quietly running on the CPU: a CPU run must be asked for
    with ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device is visible to torch; repro_torch runs on the GPU "
        "by default — pass device='cpu' to run on the CPU")
