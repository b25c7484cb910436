"""Flash attention on the card: the wrappers of ``csrc/flash_attention.cu``
(forward) and ``csrc/flash_attention_bwd.cu`` (backward, float32).

Port of ``repro/kernels/flash_attention.py`` (the Pallas
``flash_attention``): causal softmax attention with an optional sliding
window, in (B, H, S, D) layout, ``Dv != D`` allowed. Unlike the Pallas
wrapper it takes any S (the kernel masks the ragged last tile) and GQA
inputs (k, v with Hk heads, H % Hk == 0) without expanding them.
``ops.flash_attention`` dispatches here for CUDA tensors. Both dtypes run
on warpgroup products (``wgmma``) fed by TMA through an mbarrier ring
(shared helpers in ``csrc/hopper.cuh``): bfloat16 in ``flash_fwd_wgmma``,
float32 in ``flash_fwd_tf32``, each product as three TF32 products for f32
accuracy, on K and V^T split into TF32 halves once a call by a pre-pass.
The backward (``flash_attention_bwd_cuda``) is the gradient that the JAX
package leaves to autodiff; it runs in float32, as 3xTF32 warpgroup
products on tiles that TMA brings, from the log-sum-exp that the f32
forward keeps when asked (``with_lse=True``).
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention wants (B, H, S, D) inputs")
    b, h, s, d = q.shape
    kb, hk, ks, kd = k.shape
    if v.shape[:3] != (kb, hk, ks) or kb != b or ks != s or kd != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % hk:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {hk} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: devices {q.device}, {k.device}, "
                         f"{v.device}")


def pairs(s: int, window, causal: bool = True) -> int:
    """The (query, key) pairs the mask keeps: the causal band, or within
    ``window`` of the query (both sides when not causal)."""
    w = min(window or s, s)
    if causal:  # sum(min(i + 1, w) for i in range(s))
        return s * w - w * (w - 1) // 2
    # (i, j) with i - j < w: every j >= i, and w - 1 below each i
    return s * (s + 1) // 2 + (s * (w - 1) - w * (w - 1) // 2)


def work(b, h, hk, s, d, dv, window, itemsize, causal=True) -> tuple:
    """(flops, bytes) of the forward: its two products (Q K^T, P V) over the
    unmasked pairs; q, k, v read once, o written once."""
    flops = b * h * pairs(s, window, causal) * 2 * (d + dv)
    nbytes = itemsize * (b * h * s * d + b * hk * s * (d + dv)
                         + b * h * s * dv)
    return flops, nbytes


def bwd_work(b, h, hk, s, d, dv, window, itemsize=4, causal=True) -> tuple:
    """(flops, bytes) of the backward: five products (Q K^T, dO V^T, P^T dO,
    dS K, dS^T Q) over the unmasked pairs; q, k, v, o, dO read once, dq,
    dk, dv written once."""
    flops = b * h * pairs(s, window, causal) * 2 * (3 * d + 2 * dv)
    nbytes = itemsize * (2 * b * h * s * d + 2 * b * hk * s * (d + dv)
                         + 2 * b * h * s * dv)
    return flops, nbytes


def head_tile(d: int, dv: int) -> int:
    """The head width of the bf16 kernel's shared-memory tiles (64-column
    atoms): max(D, Dv) rounded up to 64, 128 or 256, the zero-filled
    columns included; D = Dv = 160 (stablelm-12b) has a 192-wide tile of
    its own. Each tile of 64, 128 and 256 has an instantiation that reads
    D and Dv at run time."""
    if d == dv == 160:
        return 192
    return next(t for t in (64, 128, 256) if max(d, dv) <= t)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def bwd_product_widths(d: int, dv: int) -> tuple:
    """The widths at which the backward kernel computes its five products,
    in ``bwd_work``'s order (Q K^T D deep, dO V^T Dv deep, P^T dO Dv wide,
    dS K D wide, dS^T Q D wide): S and dP D and Dv deep rounded up to the
    tf32 k-step of 8; dV^T and dK^T D and Dv rows rounded up to wgmma's 64;
    dQ D wide rounded up to 32 (its n-tiles are 64 and 32 wide)."""
    return _up(d, 8), _up(dv, 8), _up(dv, 64), _up(d, 32), _up(d, 64)


def product_widths(d: int, dv: int, dtype=torch.float32) -> tuple:
    """(depth of Q K^T, width of P V) that the forward kernel computes for
    ``dtype``: the bf16 kernel's wgmma runs D rounded up to its k-step of
    16 and Dv rounded up to its n-step of 8; the float32 kernel runs D
    rounded up to its tf32 k-step of 8, and Dv in chunks of 64 columns, the
    last one 16, 32 or 64 wide (so 64, 128 and 256 exactly)."""
    if dtype == torch.bfloat16:
        return _up(d, 16), _up(dv, 8)
    last = dv - 64 * ((dv - 1) // 64)
    return _up(d, 8), dv - last + next(w for w in (16, 32, 64) if last <= w)


def padded_flops(flops: float, d: int, dv: int, backward: bool = False,
                 dtype=torch.float32):
    """``flops`` of ``work`` (or ``bwd_work``) at the widths the kernel
    computes: the forward's products at ``product_widths``, the backward's
    (float32 only) at ``bwd_product_widths``."""
    if backward:
        return flops * sum(bwd_product_widths(d, dv)) / (3 * d + 2 * dv)
    wd, wdv = product_widths(d, dv, dtype)
    return flops * (wd + wdv) / (d + dv)


def layout_error(name: str, t: torch.Tensor):
    """Why ``t`` breaks the kernels' layout rule (see ``check_tma_layout``),
    or None where it keeps it."""
    n = 16 // t.element_size()
    shape, stride = t.shape, t.stride()
    what = f"flash_attention ({str(t.dtype).split('.')[-1]})"
    if shape[-1] % n:
        return (f"{what}: {name} has head dim {shape[-1]}, not a multiple "
                f"of {n}")
    if t.data_ptr() % 16:
        return f"{what}: {name}'s data pointer is not 16-byte aligned"
    if any(shape[i] > 1 and stride[i] % n for i in range(3)):
        return (f"{what}: {name}'s batch, head and sequence strides "
                f"{stride[:3]} are not all multiples of {n} elements")
    return None


def check_tma_layout(tensors: dict) -> None:
    """The kernels move 16-byte rows, most of them through TMA tensor
    maps: each (B, H, S, D) tensor needs a 16-byte aligned data pointer,
    batch, head and sequence strides that are multiples of 16 bytes, and a
    last dim that is a multiple of 16 bytes (8 bfloat16 or 4 float32
    elements). Raises ValueError naming what fails; there is no other path
    for such an input. The forward's C entry checks the same rule on its
    argument block and leaves the naming to this function."""
    for name, t in tensors.items():
        err = layout_error(name, t)
        if err is not None:
            raise ValueError(err)


# The forward's arguments as ``csrc/flash_attention.cu``'s FwdArgs takes
# them, one packed block (a ctypes call of thirty arguments takes about
# five times the host time): q, k, v, o; their batch, head and sequence
# strides; lse, the f32 scratch kv and vt, the stream; dtype, B, H, Hk, S,
# D, Dv; scale, causal, window. The C entry checks ``check_tma_layout``'s
# rule on the block first and returns _BAD_LAYOUT where it fails.
_FWD_ARGS = struct.Struct("<4Q12q4Q7ifii")
_BAD_LAYOUT = -1


def _fwd_fn():
    """The C entry point of ``csrc/flash_attention.cu``, its argument type
    set at the library's first call."""
    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window, scale, with_lse=False):
    """Launch the kernel. Inputs may be strided views (for example the
    (B, S, H, D) projections transposed) as long as the last dim is
    contiguous and the layout passes ``check_tma_layout``. Returns
    (B, H, S, Dv) in ``q.dtype``, laid out in memory as (B, S, H, Dv) so
    that the caller's transpose back is free. With ``with_lse`` (float32
    only) returns ``(out, lse)``: lse (B, H, S) float32 holds each row's
    log-sum-exp of its scaled, masked scores in base 2,
    ``log2 sum_j 2**(s_ij * scale * log2(e))`` (the natural one times
    log2(e)), which ``flash_attention_bwd_cuda`` takes. The host work is
    kept to what a call needs: the launch's checks, one allocation of the
    output (and for float32 one of the pre-pass's scratch), the stream's
    raw handle and one ctypes call of one packed argument block, on which
    the C entry checks the layout rule in one pass."""
    b, h, s, d = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    dtype = q.dtype
    code = _DTYPES.get(dtype)
    if code is None:
        raise ValueError(f"flash_attention on the card takes float32 or "
                         f"bfloat16, not {dtype}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention on the card takes head dims up to "
                         f"{MAX_HEAD_DIM}, got D={d}, Dv={dv}")
    sq, sk, sv = q.stride(), k.stride(), v.stride()
    if sq[3] != 1 or sk[3] != 1 or sv[3] != 1:
        raise ValueError("flash_attention wants a contiguous last dim")
    if with_lse and dtype != torch.float32:
        raise ValueError(f"flash_attention keeps its log-sum-exp for the "
                         f"float32 backward only, not {dtype}")
    so = (s * h * dv, dv, h * dv, 1)  # (B, S, H, Dv) in memory
    out = q.new_empty_strided((b, h, s, dv), so)
    lse = q.new_empty((b, h, s), dtype=torch.float32) if with_lse else None
    fn = _fwd_fn()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    kv = vt = 0
    if code == 0:
        # the pre-pass's f32 scratch, in one buffer: K's TF32 halves (B, Hk,
        # 2, S, D rounded up to 8), then V^T's (B, Hk, 2, Dv, ld), ld = S
        # rounded up to 8, on a 256-byte line
        n_kv = _up(b * hk * 2 * s * _up(d, 8), 64)
        scratch = q.new_empty(n_kv + b * hk * 2 * dv * _up(s, 8))
        kv = scratch.data_ptr()
        vt = kv + 4 * n_kv
    err = fn(_FWD_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), sq[0],
        sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], so[0], so[1],
        so[2], 0 if lse is None else lse.data_ptr(), kv, vt, stream, code,
        b, h, hk, s, d, dv, float(scale), int(causal), int(window or 0)))
    if err:
        if err == _BAD_LAYOUT:  # name the tensor and the rule it breaks
            check_tma_layout({"q": q, "k": k, "v": v, "out": out})
        _build.check(_build.load("flash_attention"), err,
                     "flash_attention launch")
    _build.LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


def _like_bshd(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, D) tensor laid out in memory as (B, S, H, D), as
    the model's transposed projections are, so that the gradient's
    transpose back is free."""
    b, h, s, d = t.shape
    return t.new_empty_strided((b, h, s, d), (s * h * d, d, h * d, 1))


# dS of one launch stays under this many bytes: a larger problem runs in
# slabs of batches (or, within one, of kv-head groups)
BWD_DS_BYTES = 1 << 30


def _slabs(b: int, hk: int, group: int, s: int, ld: int):
    """(batch slice, kv-head slice) pieces whose dS scratch (G query heads
    a kv head, S x ld f32 each) fits ``BWD_DS_BYTES``, at least one kv
    head a piece."""
    per_kvh = group * s * ld * 4
    if b * hk * per_kvh <= BWD_DS_BYTES:
        return [(slice(0, b), slice(0, hk))]
    if hk * per_kvh <= BWD_DS_BYTES:
        n = BWD_DS_BYTES // (hk * per_kvh)
        return [(slice(i, min(i + n, b)), slice(0, hk))
                for i in range(0, b, n)]
    n = max(1, BWD_DS_BYTES // per_kvh)
    return [(slice(i, i + 1), slice(j, min(j + n, hk)))
            for i in range(b) for j in range(0, hk, n)]


# The backward's arguments as ``csrc/flash_attention_bwd.cu``'s BwdArgs
# takes them, one packed block: q, k, v, out, dout, dq, dk, dv; their batch,
# head and sequence strides; lse, the seven f32 scratch pointers (0 where
# unused), the stream; B, H, Hk, S, D, Dv, ld; scale, causal, window. The C
# entry checks ``check_tma_layout``'s rule on q and dout first and returns
# _BAD_LAYOUT where it fails.
_BWD_ARGS = struct.Struct("<8Q24q9Q7ifii")


def _bwd_fn():
    """The C entry point of ``csrc/flash_attention_bwd.cu``, its argument
    type set at the library's first call."""
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool, window, scale):
    """Launch ``csrc/flash_attention_bwd.cu``: the gradient of the forward
    that gave ``out`` and ``lse`` (``flash_attention_cuda(...,
    with_lse=True)``, same causal, window and scale) for the incoming
    gradient ``dout`` (both (B, H, S, Dv)). Returns (dq, dk, dv) shaped as
    q, k and v. float32 only; every input but lse may be a strided view
    with a contiguous last dim; q and dout, which the kernel reads by TMA,
    must pass ``check_tma_layout``. The kernels keep dS (B, H, S, S rounded
    up to 8) in device memory for the dQ pass; where that passes
    ``BWD_DS_BYTES``, the call runs in slabs of batches or kv-head
    groups. The host work is kept to what a call needs, as the forward's:
    the checks, the three outputs and one scratch allocation, the stream's
    raw handle and one ctypes call of one packed argument block a slab, on
    which the C entry checks the layout rule."""
    check_args(q, k, v)  # q, k and v of one dtype and device
    b, h, s, d = q.shape
    hk, dv_dim = k.shape[1], v.shape[-1]
    device = q.device
    if not (q.dtype == out.dtype == dout.dtype == torch.float32
            and out.device == dout.device == device
            and q.stride(-1) == k.stride(-1) == v.stride(-1)
            == out.stride(-1) == dout.stride(-1) == 1):
        tensors = {"q": q, "k": k, "v": v, "out": out, "dout": dout}
        for name, t in tensors.items():  # name what fails
            if t.dtype != torch.float32:
                raise ValueError(f"flash_attention_bwd on the card takes "
                                 f"float32 only, got {name} in {t.dtype}")
            if t.device != device:
                raise ValueError(f"flash_attention_bwd: {name} on "
                                 f"{t.device}, q on {device}")
            if t.stride(-1) != 1:
                raise ValueError(f"flash_attention_bwd wants a contiguous "
                                 f"last dim, {name} has strides "
                                 f"{t.stride()}")
    if out.shape != (b, h, s, dv_dim) or dout.shape != out.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, want "
                         f"{(b, h, s, dv_dim)}")
    if d > MAX_HEAD_DIM or dv_dim > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd on the card takes head dims "
                         f"up to {MAX_HEAD_DIM}, got D={d}, Dv={dv_dim}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or lse.device != device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}, want a contiguous "
                         f"{(b, h, s)} float32 tensor on {q.device}")
    group, ld = h // hk, _up(s, 8)
    slabs = _slabs(b, hk, group, s, ld)
    if len(slabs) > 1:
        # a slab's views can keep the rule where the whole tensor breaks it
        # (a batch stride that a one-batch slab does not read): check the
        # whole before the first slab launches
        check_tma_layout({"q": q, "dout": dout})
    dq, dk, dv = _like_bshd(q), _like_bshd(k), _like_bshd(v)
    fn = _bwd_fn()
    scale = float(scale if scale is not None else 1.0 / math.sqrt(d))
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    # f32 scratch of the largest (the first) slab, in one buffer: delta
    # (B, H, S); K's and V's halves (B, Hk, 2, S, D | Dv rounded up to 8);
    # K^T's halves (B, Hk, 2, D, ld); dS (B, H, S, ld), ld = S rounded up
    # to 8; where G > 1 the per-query-head partials of dK and dV,
    # (B, H, S, D | Dv), summed in head order by a second pass (no
    # atomics). Each piece starts on a 256-byte line.
    first_b, first_k = slabs[0]
    nb, nhk = first_b.stop - first_b.start, first_k.stop - first_k.start
    nh = nhk * group
    sizes = [nb * nh * s, nb * nhk * 2 * s * _up(d, 8),
             nb * nhk * 2 * s * _up(dv_dim, 8), nb * nhk * 2 * d * ld,
             nb * nh * s * ld]
    if group > 1:
        sizes += [nb * nh * s * d, nb * nh * s * dv_dim]
    sizes = [_up(n, 64) for n in sizes]
    scratch = q.new_empty(sum(sizes))
    ptrs, at = [], scratch.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += 4 * n
    ptrs += [0] * (7 - len(ptrs))
    whole = (q, k, v, out, dout, dq, dk, dv)
    views, lse_ptr = whole, lse.data_ptr()
    for bs, ks in slabs:
        if len(slabs) > 1:  # k, v, dk and dv by kv head, the rest by head
            hs = slice(ks.start * group, ks.stop * group)  # their heads
            views = tuple(t[bs, ks if i in (1, 2, 6, 7) else hs]
                          for i, t in enumerate(whole))
            lse_ptr = lse[bs, hs].data_ptr()
        qv, kv = views[0], views[1]
        err = fn(_BWD_ARGS.pack(
            *[t.data_ptr() for t in views],
            *[x for t in views for x in t.stride()[:3]], lse_ptr, *ptrs,
            stream, qv.shape[0], qv.shape[1], kv.shape[1], s, d, dv_dim, ld,
            scale, int(causal), int(window or 0)))
        if err:
            if err == _BAD_LAYOUT:  # name the tensor and the rule it breaks
                check_tma_layout({"q": q, "dout": dout})
            lib = _build.load("flash_attention_bwd")
            lib.flash_attention_bwd_failure.restype = ctypes.c_char_p
            _build.check(lib, err, "flash_attention_bwd launch, at "
                         + lib.flash_attention_bwd_failure().decode())
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
