"""Where the port's entry points run: the CUDA card unless asked otherwise,
and how a driver reads several of its tensors back in one copy."""
from __future__ import annotations

import torch

__all__ = ["host_buffer", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises.

    The entry points never drop to the CPU on their own: a caller that
    wants the CPU (the tests, a laptop run) passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return dev


# dtypes whose every value survives a round trip through float64
_EXACT_IN_F64 = (torch.bool, torch.int32, torch.float32, torch.float64)


def host_buffer(*tensors):
    """``(flat, unflatten)``: the tensors in one float64 buffer on their
    device, and the function that splits a host copy of it back into
    numpy arrays of their shapes and dtypes.

    ``unflatten(flat.cpu().numpy())`` reads them all in one blocking copy,
    where a ``.cpu()`` of each would block once per tensor.  Every dtype
    must be exact in float64 (bool, int32, float32, float64).
    """
    for t in tensors:
        if t.dtype not in _EXACT_IN_F64:
            raise TypeError(f"{t.dtype} is not exact in float64")
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    layout = [(tuple(t.shape), str(t.dtype).removeprefix("torch."),
               t.numel()) for t in tensors]

    def unflatten(host):
        out, at = [], 0
        for shape, dtype, n in layout:
            out.append(host[at:at + n].astype(dtype).reshape(shape))
            at += n
        return out

    return flat, unflatten
