"""Device resolution and numeric settings for the PyTorch port.

The port's entry points run on the card: ``resolve_device(None)`` returns
``cuda`` and raises when no CUDA device exists. The CPU is used only when a
caller asks for it (``device="cpu"``), as the CPU tests do; nothing drops to
the CPU on its own.

TF32 is turned off: an f32 matmul on an H100 would otherwise keep about
three decimal digits (10-bit mantissa) where the reference keeps f32.
"""

from __future__ import annotations

import torch


def configure_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); otherwise
    ``torch.device(device)``."""
    configure_numerics()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fl_slam_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain versions on "
                "the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def backend_name(device=None) -> str:
    """``"cuda"`` or ``"cpu"``: the type of ``resolve_device(device)`` (the
    reference's ``backend_name`` names JAX's default backend)."""
    return resolve_device(device).type


def device_count() -> int:
    """The number of visible CUDA devices."""
    return torch.cuda.device_count()


_CONSTS: dict = {}


def const(values, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A small constant tensor on ``like``'s device, cached per (values,
    dtype, device) and copied without a host sync. Callers never mutate it."""
    dtype = like.dtype if dtype is None else dtype
    key = (tuple(values), dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(list(values), dtype=dtype).to(like.device,
                                                        non_blocking=True)
        _CONSTS[key] = t
    return t


def instance_first(B: int, x: torch.Tensor, dim) -> torch.Tensor:
    """``x`` as seen by a kernel's instance-batching rule
    (``torch.library.register_vmap``), with its instance axis first: moved
    there from ``dim``, or broadcast to ``B`` instances where ``dim`` is
    None (an operand shared by every instance)."""
    if dim is None:
        return x.expand(B, *x.shape)
    return x.movedim(dim, 0)
