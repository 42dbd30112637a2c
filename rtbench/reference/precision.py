"""The reference's matrix products, and the lower precision its control
runs in: TF32, the step below float32 with TF32 off that a faster
matmul would tempt a change to take. Inside tf32() every product of
float32 operands runs in TF32: on a card through cuBLAS's TF32 mode, on
the CPU (which has none) with each operand rounded to TF32's 10-bit
mantissa first, which is what the card's tensor cores read."""

from __future__ import annotations

import contextlib
import contextvars

import torch

_TF32 = contextvars.ContextVar("rtbench_tf32", default=False)


@contextlib.contextmanager
def tf32():
    token = _TF32.set(True)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        _TF32.reset(token)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _TF32.get() and a.dtype == torch.float32 and not a.is_cuda:
        a, b = to_tf32(a), to_tf32(b)
    return a @ b
