"""Device selection: the GPU by default, the CPU only when asked for.

Importing this module pins float32 matrix products and convolutions to
full float32 (no TF32) for the process; the models and the kernels
import it for that.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "sm_count"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_SMS: dict[int, int] = {}       # device index -> multiprocessor count


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


def sm_count(device: torch.device) -> int:
    """The multiprocessor count of a CUDA device, read once per device."""
    idx = device.index if device.index is not None else 0
    sms = _SMS.get(idx)
    if sms is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _SMS[idx] = sms
    return sms
