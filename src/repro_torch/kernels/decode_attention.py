"""GQA decode attention on the card: the wrapper of
``csrc/decode_attention.cu``.

One query row a sequence against its KV cache, the attention of a decode
step: q (B, 1, H, D) against caches (B, S, Hk, D) up to each row's
``cur_pos`` (and within ``window`` of it), H % Hk == 0, query head h
reading kv head h // (H/Hk). The kernel reads each kv head's live rows once,
in the cache's dtype, for all the query heads that share them; it replaces
no TPU kernel (the JAX package's decode attention is jnp).
``ops.decode_attention`` dispatches here for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# A split takes at least this many rows; below twice as many blocks as the
# card has SMs, the rows are split into as many pieces as bring the blocks
# there (``split_count``).
MIN_SPLIT_ROWS = 256


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cur_pos: torch.Tensor) -> None:
    """Shapes: q (B, 1, H, D), k and v (B, S, Hk, D) with H % Hk == 0,
    cur_pos (B,)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention wants q (B, 1, H, D) and caches "
                         f"(B, S, Hk, D), got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, one, h, d = q.shape
    if one != 1 or k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"caches {tuple(k.shape)}")
    if cur_pos.shape != (b,):
        raise ValueError(f"decode_attention: cur_pos {tuple(cur_pos.shape)}, "
                         f"want ({b},)")


def live_rows(s: int, window) -> int:
    """The most rows a query reads: the cache's, or the window's."""
    return min(s, window) if window else s


def work(b, h, hk, s, d, window, itemsize, q_itemsize=None) -> tuple:
    """(flops, bytes) of a step at the cache's last position, where the
    most rows are live: Q K^T and P V over them for every query head; each
    live row of K and V read once, q and cur_pos read and the output
    written once."""
    n = live_rows(s, window)
    q_itemsize = q_itemsize or itemsize
    return (4 * b * h * n * d,
            itemsize * 2 * b * hk * n * d + q_itemsize * 2 * b * h * d
            + 8 * b)


def head_group(g: int) -> int:
    """The query heads a block takes: G rounded up to 1, 4 or 8 (a G above
    8 takes several groups of 8, each reading the rows again)."""
    return 1 if g <= 1 else 4 if g <= 4 else 8


def split_count(blocks: int, rows: int, sms: int) -> int:
    """Splits of each (batch row, kv head, head group)'s rows: 1 where its
    ``blocks`` fill twice the card's ``sms``; else as many as bring them
    there, each of at least ``MIN_SPLIT_ROWS`` of the ``rows``."""
    if blocks >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // blocks), rows // MIN_SPLIT_ROWS))


_SMS: dict = {}


def _sms(index: int) -> int:
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def layout_error(name: str, t: torch.Tensor):
    """Why a cache breaks the kernel's rule (16-byte copies: a 16-byte
    aligned pointer, batch, position and head strides of whole 16 bytes),
    or None where it keeps it."""
    size = t.element_size()
    if t.data_ptr() % 16:
        return (f"decode_attention: {name}'s data pointer is not 16-byte "
                f"aligned")
    if any(t.shape[i] > 1 and t.stride(i) * size % 16 for i in range(3)):
        return (f"decode_attention: {name}'s batch, position and head "
                f"strides {t.stride()[:3]} are not all multiples of 16 bytes")
    return None


# The arguments as ``csrc/decode_attention.cu``'s DecodeArgs takes them,
# one packed block: q, k, v, o, cur_pos, the split scratch, the stream; q's
# batch and head strides, k's and v's batch, position and head strides;
# q's dtype, the caches', B, H, Hk, S, D, window, splits; scale. The C entry
# checks the caches' layout first and returns _BAD_LAYOUT where it fails.
_ARGS = struct.Struct("<7Q8q9if")
_BAD_LAYOUT = -1


def _fn():
    """The C entry point, its argument type set at the library's first
    call."""
    fn = _build.load("decode_attention").decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, cur_pos: torch.Tensor, window=None,
                          scale=None) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (B, 1, H, D) in
    ``q.dtype``. q, k and v may be strided views with a contiguous last
    dim; k and v share a dtype, q may have another (float32 or bfloat16
    each); cur_pos is a (B,) int64 tensor on the card, read there. The
    rows are split as ``split_count`` says. The host
    work is kept to what a call needs: the checks, one allocation (the
    output, with the splits' scratch behind it), the stream's raw handle
    and one ctypes call of one packed argument block. Everything is
    checked before the kernel is built or loaded."""
    check_args(q, k, v, cur_pos)
    b, _, h, d = q.shape
    s, hk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention on the card takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    qcode, kcode = _DTYPES.get(q.dtype), _DTYPES.get(k.dtype)
    if qcode is None or kcode is None or v.dtype != k.dtype:
        raise ValueError(f"decode_attention on the card takes float32 or "
                         f"bfloat16 q and caches of one dtype, got q "
                         f"{q.dtype}, k {k.dtype}, v {v.dtype}")
    if cur_pos.dtype != torch.int64 or cur_pos.stride(0) != 1 and b > 1:
        raise ValueError(f"decode_attention wants a contiguous int64 "
                         f"cur_pos, got {cur_pos.dtype} with strides "
                         f"{cur_pos.stride()}")
    sq, sk, sv = q.stride(), k.stride(), v.stride()
    if sq[3] != 1 or sk[3] != 1 or sv[3] != 1:
        raise ValueError(f"decode_attention wants a contiguous last dim, got "
                         f"strides q {sq}, k {sk}, v {sv}")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window {window} must be positive")
    index = q.get_device()
    if not (index >= 0 and k.get_device() == v.get_device()
            == cur_pos.get_device() == index):
        raise ValueError(f"decode_attention on the card: q on {q.device}, "
                         f"k on {k.device}, v on {v.device}, cur_pos on "
                         f"{cur_pos.device}")
    g = h // hk
    splits = split_count(max(1, b * hk * -(-g // head_group(g))),
                         live_rows(s, window), _sms(index))
    part = 0
    if splits == 1:
        out = q.new_empty((b, 1, h, d))
    else:  # the output, then the splits' f32 scratch on a 256-byte line
        size = q.element_size()
        head = _up(b * h * d * size, 256) // size
        buf = q.new_empty(head + _up(splits * b * h * (d + 2) * 4, size)
                          // size)
        out = buf.as_strided((b, 1, h, d), (h * d, h * d, d, 1))
        part = buf.data_ptr() + head * size
    fn = _fn()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = fn(_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        cur_pos.data_ptr(), part, stream, sq[0], sq[2], sk[0], sk[1], sk[2],
        sv[0], sv[1], sv[2], qcode, kcode, b, h, hk, s, d, int(window or 0),
        splits, float(scale)))
    if err:
        if err == _BAD_LAYOUT:  # name the cache and the rule it breaks
            for name, t in (("k", k), ("v", v)):
                msg = layout_error(name, t)
                if msg is not None:
                    raise ValueError(msg)
        _build.check(_build.load("decode_attention"), err,
                     "decode_attention launch")
    _build.LAUNCHES["decode_attention"] += 1
    return out
