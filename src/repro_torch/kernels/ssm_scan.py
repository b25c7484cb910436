"""Selective scan on the card: the wrappers of ``csrc/ssm_scan.cu`` and
``csrc/ssm_scan_bwd.cu``.

Port of ``repro/kernels/ssm_scan.py`` (the Pallas ``ssm_scan``): the
Mamba recurrence ``s_t = decay_t*s_{t-1} + u_t``, ``y_t = sum_n s_t*c_t``
over the whole sequence from ``state0``. Unlike the Pallas wrapper it takes
any S and any D (the kernel masks the ragged edge). Under autograd the
forward also keeps the state entering every ``CHUNK`` steps, from which
the backward kernel recomputes each chunk's states. ``ops.ssm_scan``
dispatches here for CUDA tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_STATE = 32  # the N lanes of one (b, d) share a warp
MAX_BATCH = 65535  # the grid's y dimension
CHUNK = 32  # kChunk of both sources: the boundary states' stride
THREADS = 256  # a block of either kernel: 256 / N d's


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


def work(b: int, s: int, d: int, n: int) -> tuple:
    """(flops, bytes) of the forward: an FMA for the state and one for the
    output sum at each (b, s, d, n); decay and u read once, c and state0
    once, y and the final state written once."""
    return 4 * b * s * d * n, 4 * (2 * b * s * d * n + b * s * n
                                   + 2 * b * d * n + b * s * d)


def bwd_work(b: int, s: int, d: int, n: int) -> tuple:
    """(flops, bytes) of the backward: at each (b, s, d, n) the state's
    recompute, the carried gradient and the d_c sum (three FMAs) and
    d_decay (a product); decay, u, dy, c and state0 read once, d_decay,
    d_u, d_c and d_state0 written once."""
    return 8 * b * s * d * n, 4 * (4 * b * s * d * n + b * s * d
                                   + 2 * b * s * n + 2 * b * d * n)


def _check_card_args(name: str, ins, n: int, b: int, d: int) -> None:
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"{name} on the card takes float32 inputs, got "
                         f"{[t.dtype for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name} wants contiguous inputs")
    if not 1 <= n <= MAX_STATE or n & (n - 1):
        raise ValueError(f"{name} on the card takes a state size N that "
                         f"is a power of two up to {MAX_STATE}, got {n}")
    if b > MAX_BATCH or d >= 2 ** 31:
        raise ValueError(f"{name}: B={b}, D={d} exceed the grid")


def ssm_scan_cuda(decay: torch.Tensor, u: torch.Tensor, c: torch.Tensor,
                  state0: torch.Tensor, *, with_bounds: bool = False):
    """Launch the kernel on ``decay.device``. Returns (y (B, S, D) f32,
    final state (B, D, N) f32), and with ``with_bounds`` the state entering
    each ``CHUNK``-step chunk, (B, ceil(S/CHUNK), D, N) f32, for
    ``ssm_scan_bwd_cuda``."""
    b, s, d, n = decay.shape
    _check_card_args("ssm_scan", (decay, u, c, state0), n, b, d)
    lib = _build.load("ssm_scan")
    lib.ssm_scan.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.ssm_scan.restype = ctypes.c_int
    y = torch.empty((b, s, d), dtype=torch.float32, device=decay.device)
    final = torch.empty((b, d, n), dtype=torch.float32, device=decay.device)
    bounds = torch.empty((b, -(-s // CHUNK), d, n), dtype=torch.float32,
                         device=decay.device) if with_bounds else None
    stream = torch.cuda.current_stream(decay.device).cuda_stream
    err = lib.ssm_scan(decay.data_ptr(), u.data_ptr(), c.data_ptr(),
                       state0.data_ptr(), y.data_ptr(), final.data_ptr(),
                       None if bounds is None else bounds.data_ptr(),
                       b, s, d, n, stream)
    _build.check(lib, err, "ssm_scan launch")
    _build.LAUNCHES["ssm_scan"] += 1
    return (y, final, bounds) if with_bounds else (y, final)


def ssm_scan_bwd_cuda(decay: torch.Tensor, u: torch.Tensor, c: torch.Tensor,
                      bounds: torch.Tensor, dy: torch.Tensor,
                      dfinal: Optional[torch.Tensor] = None):
    """Launch the backward kernel on ``decay.device``: the gradient of
    ``ssm_scan`` from the forward's inputs and its boundary states
    (``ssm_scan_cuda(..., with_bounds=True)``), dy (B, S, D) and dfinal
    (B, D, N) or None (zeros). Returns (d_decay, d_u (B, S, D, N),
    d_c (B, S, N), d_state0 (B, D, N)), all f32."""
    if decay.ndim != 4:
        raise ValueError(f"ssm_scan_bwd wants a (B, S, D, N) decay, got "
                         f"{tuple(decay.shape)}")
    b, s, d, n = decay.shape
    want = [(u, (b, s, d, n)), (c, (b, s, n)), (dy, (b, s, d)),
            (bounds, (b, -(-s // CHUNK), d, n))]
    if dfinal is not None:
        want.append((dfinal, (b, d, n)))
    if any(t.shape != shape for t, shape in want):
        raise ValueError(f"ssm_scan_bwd: decay {tuple(decay.shape)}, want "
                         f"{[shape for _, shape in want]}, got "
                         f"{[tuple(t.shape) for t, _ in want]}")
    ins = [decay] + [t for t, _ in want]
    if len({t.device for t in ins}) != 1:
        raise ValueError("ssm_scan_bwd: inputs on more than one device")
    _check_card_args("ssm_scan_bwd", ins, n, b, d)
    lib = _build.load("ssm_scan_bwd")
    lib.ssm_scan_bwd.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])
    lib.ssm_scan_bwd.restype = ctypes.c_int
    dev = decay.device
    d_decay = torch.empty((b, s, d, n), dtype=torch.float32, device=dev)
    d_u = torch.empty_like(d_decay)
    d_c = torch.empty((b, s, n), dtype=torch.float32, device=dev)
    d_state0 = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    n_blocks = -(-d // (THREADS // n))
    dc_part = torch.empty((b, s, n_blocks, n), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssm_scan_bwd(
        decay.data_ptr(), u.data_ptr(), c.data_ptr(), bounds.data_ptr(),
        dy.data_ptr(), None if dfinal is None else dfinal.data_ptr(),
        d_decay.data_ptr(), d_u.data_ptr(), dc_part.data_ptr(),
        d_c.data_ptr(), d_state0.data_ptr(), b, s, d, n, stream)
    _build.check(lib, err, "ssm_scan_bwd launch")
    _build.LAUNCHES["ssm_scan_bwd"] += 1
    return d_decay, d_u, d_c, d_state0
