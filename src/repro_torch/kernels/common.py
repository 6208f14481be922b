"""Shared wrapper plumbing for the CUDA kernels.

Every wrapper checks its operands before it hands raw pointers to a C
launcher, and raises if the launch was refused. (The Pallas tile helpers of
``repro.kernels.common`` have no counterpart: the CUDA kernels take their
extents at run time and mask the ragged edge themselves.)
"""
from __future__ import annotations

from typing import Optional

import torch


def cuda_operand(t: torch.Tensor, what: str, kernel: str, device: torch.device,
                 dtype: Optional[torch.dtype] = None, align: int = 4) -> int:
    """The data pointer of ``t`` after checking that it lies on ``device``,
    has ``dtype`` (when given), is contiguous and ``align``-byte aligned."""
    if t.device != device:
        raise ValueError(f"{kernel}: {what} on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{kernel}: {what} dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be contiguous")
    ptr = t.data_ptr()
    if ptr % align:
        raise ValueError(f"{kernel}: {what} not {align}-byte aligned")
    return ptr


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")
