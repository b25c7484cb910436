"""Selective scan on the card: the wrapper of ``csrc/ssm_scan.cu``.

Port of ``repro/kernels/ssm_scan.py`` (the Pallas ``ssm_scan``): the
Mamba recurrence ``s_t = decay_t*s_{t-1} + u_t``, ``y_t = sum_n s_t*c_t``
over the whole sequence from ``state0``. Unlike the Pallas wrapper it takes
any S and any D (the kernel masks the ragged edge). ``ops.ssm_scan``
dispatches here for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_STATE = 32  # the N lanes of one (b, d) share a warp
MAX_BATCH = 65535  # the grid's y dimension


def check_args(decay: torch.Tensor, u: torch.Tensor, c: torch.Tensor,
               state0: torch.Tensor) -> None:
    """decay, u: (B, S, D, N); c: (B, S, N); state0: (B, D, N), all on one
    device."""
    if decay.ndim != 4 or decay.shape != u.shape:
        raise ValueError(f"ssm_scan wants decay and u of one (B, S, D, N) "
                         f"shape, got {tuple(decay.shape)} and "
                         f"{tuple(u.shape)}")
    b, s, d, n = decay.shape
    if c.shape != (b, s, n) or state0.shape != (b, d, n):
        raise ValueError(f"ssm_scan: decay {tuple(decay.shape)}, c "
                         f"{tuple(c.shape)}, state0 {tuple(state0.shape)}")
    devices = {t.device for t in (decay, u, c, state0)}
    if len(devices) != 1:
        raise ValueError(f"ssm_scan: inputs on {sorted(map(str, devices))}")


def ssm_scan_cuda(decay: torch.Tensor, u: torch.Tensor, c: torch.Tensor,
                  state0: torch.Tensor):
    """Launch the kernel on ``decay.device``. Returns (y (B, S, D) f32,
    final state (B, D, N) f32)."""
    b, s, d, n = decay.shape
    ins = (decay, u, c, state0)
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"ssm_scan on the card takes float32 inputs, got "
                         f"{[t.dtype for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssm_scan wants contiguous inputs")
    if n > MAX_STATE or n & (n - 1):
        raise ValueError(f"ssm_scan on the card takes a state size N that "
                         f"is a power of two up to {MAX_STATE}, got {n}")
    if b > MAX_BATCH or d >= 2 ** 31:
        raise ValueError(f"ssm_scan: B={b}, D={d} exceed the grid")
    lib = _build.load("ssm_scan")
    lib.ssm_scan.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.ssm_scan.restype = ctypes.c_int
    y = torch.empty((b, s, d), dtype=torch.float32, device=decay.device)
    final = torch.empty((b, d, n), dtype=torch.float32, device=decay.device)
    stream = torch.cuda.current_stream(decay.device).cuda_stream
    err = lib.ssm_scan(decay.data_ptr(), u.data_ptr(), c.data_ptr(),
                       state0.data_ptr(), y.data_ptr(), final.data_ptr(),
                       b, s, d, n, stream)
    _build.check(lib, err, "ssm_scan launch")
    _build.LAUNCHES["ssm_scan"] += 1
    return y, final
