"""Flash-attention forward on the card: the wrapper of
``csrc/flash_attention.cu``.

Port of ``repro/kernels/flash_attention.py`` (the Pallas
``flash_attention``): causal softmax attention with an optional sliding
window, in (B, H, S, D) layout, ``Dv != D`` allowed. Unlike the Pallas
wrapper it takes any S (the kernel masks the ragged last tile) and GQA
inputs (k, v with Hk heads, H % Hk == 0) without expanding them.
``ops.flash_attention`` dispatches here for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block can use


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention wants (B, H, S, D) inputs")
    b, h, s, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[2] != s \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[1]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: devices {q.device}, {k.device}, "
                         f"{v.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window, scale) -> torch.Tensor:
    """Launch the kernel. Inputs may be strided views (for example the
    (B, S, H, D) projections transposed) as long as the last dim is
    contiguous. Returns (B, H, S, Dv) in ``q.dtype``, laid out in memory as
    (B, S, H, Dv) so that the caller's transpose back is free."""
    b, h, s, d = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention on the card takes float32 or "
                         f"bfloat16, not {q.dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention on the card takes head dims up to "
                         f"{MAX_HEAD_DIM}, got D={d}, Dv={dv}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention wants a contiguous last dim")
    lib = _build.load("flash_attention")
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    smem = lib.flash_attention_smem_bytes(d, dv)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"flash_attention: D={d}, Dv={dv} need {smem} bytes "
                         f"of shared memory, more than {_SMEM_LIMIT}")
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    out = torch.empty((b, s, h, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, hk, s, d, dv, *strides, float(scale),
        int(causal), int(window or 0), stream)
    _build.check(lib, err, "flash_attention launch")
    _build.LAUNCHES["flash_attention"] += 1
    return out
