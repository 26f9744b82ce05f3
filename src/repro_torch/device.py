"""Device selection: the GPU by default, the CPU only when asked for.

Importing this module pins float32 matrix products and convolutions to
full float32 (no TF32) for the process; the models and the kernels
import it for that.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "sm_count", "upload", "upload_into"]

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


def upload(data, device: torch.device, dtype: torch.dtype | None = None
           ) -> torch.Tensor:
    """``data`` (a list, an array or a host tensor) on ``device``, copied
    without the host waiting for the device.

    ``torch.tensor(data, device=cuda)`` and ``host.to(cuda)`` copy from
    pageable memory and then synchronize the stream, so the host waits for
    all the work queued before them.  On CUDA this stages ``data`` in
    pinned memory and copies it ``non_blocking``, in stream order; the
    caching host allocator keeps the pinned block until the copy has run.
    """
    if isinstance(data, torch.Tensor):
        host = data if dtype is None else data.to(dtype)
    else:
        host = torch.tensor(data, dtype=dtype)
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def upload_into(dst: torch.Tensor, data) -> None:
    """Copy host ``data`` into the tensor ``dst`` in place, on CUDA
    without the host waiting (as :func:`upload`)."""
    src = torch.as_tensor(data)
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)
