"""The port's kernels (repro_torch.kernels) against the JAX package.

On the CPU the port's ops run their plain PyTorch versions; they are held
against ``repro.kernels.ref.flash_attention_ref`` (the Pallas
``flash_attention`` does not run under the installed jax) and against the
Pallas ``delta_mask`` in interpret mode. The ``cuda`` tests hold each
CUDA kernel against its plain version and skip where there is no card;
they need no JAX, so that they run on a machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels.py
"""
import io
import math
import re
import types

import numpy as np
import pytest
import torch

from repro.ckpt.delta import changed_blocks
from repro_torch.ckpt.checkpoint import _changed_block_idxs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as flash


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and oracles, imported only by the tests
    that compare against them."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return types.SimpleNamespace(
        jnp=jnp, ops=jops, ref=jref,
        dtype={torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16})


def _qkv(shape, dtype, seed, dv=None, hk=None):
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hk or h, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk or h, s, dv or d)).astype(np.float32)
    return q, k, v


def _port(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _check_flash(jx, q, k, v, dtype, tol, **kw):
    out = ops.flash_attention(*_port((q, k, v), dtype), **kw)
    assert out.dtype == dtype
    rep = q.shape[1] // k.shape[1]
    exp = jx.ref.flash_attention_ref(
        *[jx.jnp.asarray(a, jx.dtype[dtype]) for a in
          (q, np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1))], **kw)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,s,d", [(1, 1, 128, 64), (2, 3, 256, 64),
                                     (1, 2, 256, 128), (2, 1, 512, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_causal(jx, b, h, s, d, dtype):
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    _check_flash(jx, *_qkv((b, h, s, d), dtype, seed=s + d), dtype, tol)


@pytest.mark.parametrize("window", [32, 100, 256])
def test_flash_attention_window(jx, window):
    _check_flash(jx, *_qkv((1, 2, 256, 64), torch.float32, seed=window),
                 torch.float32, 2e-5, window=window)


def test_flash_attention_vdim_differs(jx):
    _check_flash(jx, *_qkv((1, 2, 128, 64), torch.float32, seed=3, dv=32),
                 torch.float32, 2e-5)


@pytest.mark.parametrize("window", [None, 48])
def test_flash_attention_gqa(jx, window):
    _check_flash(jx, *_qkv((2, 4, 128, 32), torch.float32, seed=4, hk=1),
                 torch.float32, 2e-5, window=window)


@pytest.mark.parametrize("window", [None, 32])
def test_flash_attention_ragged(jx, window):
    _check_flash(jx, *_qkv((1, 2, 100, 64), torch.float32, seed=5),
                 torch.float32, 2e-5, window=window)


@pytest.mark.parametrize("window", [None, 32])
def test_flash_attention_noncausal(jx, window):
    _check_flash(jx, *_qkv((1, 2, 128, 32), torch.float32, seed=10),
                 torch.float32, 2e-5, causal=False, window=window)


def test_flash_attention_rejects_bad_shapes():
    q, k, v = _port(_qkv((1, 3, 64, 16), torch.float32, seed=6, hk=2),
                    torch.float32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)


def _bsdh_views(b, s, h, hk, d, dtype):
    """q, k, v as the model hands them over: (B, S, H*D) projections
    reshaped to (B, S, H, D) and transposed to (B, H, S, D)."""
    rng = np.random.default_rng(d + h)
    return [torch.from_numpy(rng.standard_normal((b, s, n * d)).astype(
        np.float32)).to(dtype).reshape(b, s, n, d).transpose(1, 2)
        for n in (h, hk, hk)]


# Jamba's and gemma3-1b's attention, and gemma3-1b-reduced's (head_dim 16)
@pytest.mark.parametrize("d,h,hk,dtype", [(128, 64, 8, torch.bfloat16),
                                          (256, 4, 1, torch.bfloat16),
                                          (256, 4, 1, torch.float32),
                                          (16, 4, 1, torch.float32)])
def test_check_mma_layout_takes_model_views(d, h, hk, dtype):
    q, k, v = _bsdh_views(2, 24, h, hk, d, dtype)
    flash.check_mma_layout({"q": q, "k": k, "v": v})


def _misaligned(what, device="cpu", dtype=torch.bfloat16):
    """A (1, 2, 16, 64) tensor that breaks one rule of the kernels' layout
    (16-byte rows: 8 bf16 or 4 f32 elements)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    if what == "pointer":  # data starts one element into a 16-byte line
        return zeros(2 * 16 * 64 + 1)[1:].view(1, 2, 16, 64)
    bf16 = dtype == torch.bfloat16
    if what == "seq_stride":  # rows 68 bf16 (66 f32) elements apart
        return zeros(1, 2, 16, 68 if bf16 else 66)[..., :64]
    return zeros(1, 2, 16, 36 if bf16 else 6)  # head dim 36 (6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("what", ["pointer", "seq_stride", "head_dim"])
def test_check_mma_layout_raises(what, dtype):
    with pytest.raises(ValueError, match=str(dtype).split(".")[-1]):
        flash.check_mma_layout({"k": _misaligned(what, dtype=dtype)})


def _body(src, head):
    """The C++ function of ``src`` that starts at ``head``."""
    start = src.index(head)
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_cu_bf16_runs_only_on_tensor_cores(dtype):
    """Each dtype goes to one tensor-core kernel: bf16 to flash_fwd_mma,
    whose products are mma.sync m16n8k16 bf16; f32 to flash_fwd_tf32, whose
    products are three mma.sync m16n8k8 tf32 on operands split with the
    rounding of cvt.rna.tf32.f32. No SIMT kernel and no scalar product is
    left."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    code, entry, launcher, kernel, product = {
        "bfloat16": (1, "launch_mma", "launch_bf16", "flash_fwd_mma",
                     "mma16816"),
        "float32": (0, "launch_tf32", "launch_f32", "flash_fwd_tf32",
                    "mma_3xtf32")}[dtype]
    assert f"if (dtype == {code}) return {entry}(p, B, st);" in src
    assert set(re.findall(r"mma::(launch_\w+)<",
                          _body(src, f"int {entry}("))) == {launcher}
    assert re.findall(r"launch\((flash_fwd_\w+)<",
                      _body(src, f"int {launcher}(")) == [kernel]
    assert f"{product}(" in _body(src, f"{kernel}(Params p) {{")
    if dtype == "bfloat16":
        assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" \
            in _body(src, "void mma16816(")
    else:
        assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" \
            in _body(src, "void mma1688(")
        assert _body(src, "void mma_3xtf32(").count("mma1688(") == 3
        # both parts rounded as _tf32 below (and cvt.rna.tf32.f32) round
        assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" \
            in _body(src, "uint32_t rna_tf32(")
        assert _body(src, "void split_tf32(").count("rna_tf32(") == 2
        assert "split_tf32(" in _body(src, f"{kernel}(Params p) {{")
    assert "flash_fwd_simt" not in src and "fmaf(" not in src


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32: add half the weight of the 13 dropped bits
    to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, how):
    """a @ b as the tensor cores compute it from f32 operands: "f32" as
    is, "tf32" one product of the rounded operands, "3xtf32" the split
    x = big + small: small*big + big*small, then + big*big."""
    if how == "f32":
        return a @ b
    a_big, b_big = _tf32(a), _tf32(b)
    if how == "tf32":
        return a_big @ b_big
    return (_tf32(a - a_big) @ b_big + a_big @ _tf32(b - b_big)) \
        + a_big @ b_big


def _emulated_flash(q, k, v, window, qk, pv):
    """flash_fwd_tf32's arithmetic over the whole row at once: S = Q K^T
    by ``qk``, the log2(e)-folded scale, the -1e30 mask, exp2, then P V by
    ``pv`` over the unnormalised P, divided by l."""
    h, s, d = q.shape[1:]
    k, v = (t.repeat_interleave(h // t.shape[1], dim=1) for t in (k, v))
    x = _product(q, k.transpose(-1, -2), qk) * (
        1.0 / math.sqrt(d) * math.log2(math.e))
    i = torch.arange(s)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[:, None] - i[None, :] < window
    x = torch.where(mask, x, torch.full_like(x, ref.NEG_INF))
    p = torch.exp2(x - x.amax(dim=-1, keepdim=True))
    return _product(p, v, pv) / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_3xtf32_split_keeps_f32_parity(window):
    """Why the f32 kernel splits both products into three TF32 products.
    At gemma3-1b's heads (H=4, Hk=1, D=256), B=2, S=256, the emulated split
    is 1.91e-06 from the f32 plain version (window None or 64); one TF32
    product on Q K^T alone is 8.17e-04 from it, on P V alone 9.35e-04:
    outside the 1e-4 that the card's f32 tests and chip_smoke.py hold the
    kernel to."""
    q, k, v = _port(_qkv((2, 4, 256, 256), torch.float32, seed=256, hk=1),
                    torch.float32)
    exp = ref.flash_attention_ref(q, k, v, window=window)

    def err(qk, pv):
        out = _emulated_flash(q, k, v, window, qk, pv)
        return (out - exp).abs().max().item()
    assert err("3xtf32", "3xtf32") < 1e-4
    assert err("tf32", "f32") > 1e-4
    assert err("f32", "tf32") > 1e-4


def _flipped(n, block, seed):
    rng = np.random.default_rng(seed)
    new = rng.integers(0, 255, n).astype(np.uint8)
    old = new.copy()
    old[block + 3] ^= 0xFF  # one byte in block 1
    old[3 * block: 3 * block + 10] ^= 1  # a run in block 3
    old[-1] ^= 0x80  # the last byte of the last block
    return new, old


@pytest.mark.parametrize("block,bpt,tiles", [(256, 4, 4), (2048, 8, 4),
                                             (65536, 8, 1)])
def test_delta_mask_matches_pallas(jx, block, bpt, tiles):
    new, old = _flipped(block * bpt * tiles, block, seed=block)
    m = ops.delta_mask(torch.from_numpy(new), torch.from_numpy(old),
                       block=block, bpt=bpt)
    exp = jx.ops.delta_mask(jx.jnp.asarray(new), jx.jnp.asarray(old),
                            block=block, bpt=bpt, interpret=True)
    assert m.dtype == torch.int8
    np.testing.assert_array_equal(m.numpy(), np.asarray(exp))
    idx, blocks = ops.delta_pack(new, m, block)
    assert set(idx.tolist()) == {1, 3, block * bpt * tiles // block - 1}
    np.testing.assert_array_equal(blocks[0], new[block:2 * block])


def test_delta_mask_identical_inputs(jx):
    new, _ = _flipped(256 * 4 * 2, 256, seed=7)
    m = ops.delta_mask(torch.from_numpy(new), torch.from_numpy(new.copy()),
                       block=256, bpt=4)
    exp = jx.ops.delta_mask(jx.jnp.asarray(new), jx.jnp.asarray(new),
                            block=256, bpt=4, interpret=True)
    np.testing.assert_array_equal(m.numpy(), np.asarray(exp))
    assert not m.any()


def test_delta_encode_ref_matches_jax(jx):
    new, old = _flipped(256 * 8, 256, seed=8)
    mask, packed = ref.delta_encode_ref(torch.from_numpy(new),
                                        torch.from_numpy(old), 256)
    jm, jp = jx.ref.delta_encode_ref(jx.jnp.asarray(new),
                                     jx.jnp.asarray(old), 256)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))


@pytest.mark.parametrize("new,old,block,bpt", [
    (np.zeros(100, np.uint8), np.zeros(100, np.uint8), 16, 2),  # ragged
    (np.zeros((2, 64), np.uint8), np.zeros((2, 64), np.uint8), 16, 2),
    (np.zeros(64, np.uint8), np.zeros(32, np.uint8), 16, 2),
    (np.zeros(64, np.int32), np.zeros(64, np.int32), 16, 2),
])
def test_delta_mask_contract(new, old, block, bpt):
    with pytest.raises(ValueError):
        ops.delta_mask(torch.from_numpy(new), torch.from_numpy(old),
                       block=block, bpt=bpt)


def _npy(arr):
    bio = io.BytesIO()
    np.save(bio, arr, allow_pickle=False)
    return bio.getvalue()


@pytest.mark.parametrize("block", [256, 1024])
def test_changed_block_idxs_matches_host_scan(block):
    rng = np.random.default_rng(block)
    a = rng.standard_normal((3, 1000)).astype(np.float32)
    b = a.copy()
    b[0, 7] += 1.0
    b[1, 500:520] = 0.0
    b[2, -1] -= 1.0  # in the unaligned tail
    new, old = _npy(b), _npy(a)
    assert len(new) % (block * 8)  # np.save output is not tile-aligned
    got = _changed_block_idxs(new, old, block, torch.device("cpu"))
    assert got == changed_blocks(new, old, block)
    assert len(got) >= 3


# -- on the card: each CUDA kernel against its plain version -----------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,window,hk", [(1024, 512, 1), (1024, None, 1),
                                         (1000, 512, 1), (256, None, 4)])
def test_flash_attention_kernel(cuda, dtype, tol, s, window, hk):
    q, k, v = (t.to(cuda) for t in _port(
        _qkv((2, 4, s, 256), dtype, seed=s, hk=hk), dtype))
    out = ops.flash_attention(q, k, v, window=window)
    exp = ref.flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == exp.shape
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 40), (False, None),
                                           (False, 40)])
def test_flash_attention_kernel_vdim_and_views(cuda, causal, window):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 96, 4, 64)).astype(
        np.float32)).to(cuda)  # (B,S,H,D) viewed as (B,H,S,D)
    v = torch.from_numpy(rng.standard_normal((2, 2, 96, 32)).astype(
        np.float32)).to(cuda)
    q = x.transpose(1, 2)
    k = x[:, :, :2].transpose(1, 2)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, exp, atol=1e-4, rtol=1e-4)


_MMA_CASES = pytest.mark.parametrize("b,h,hk,s,d,dv,causal,window", [
    (1, 64, 8, 256, 128, 128, True, None),  # Jamba's heads
    (1, 64, 8, 1000, 128, 128, True, None),  # ragged S
    (1, 4, 1, 1024, 256, 256, True, 512),  # gemma3-1b's local layers
    (1, 4, 1, 1024, 256, 256, True, None),  # ... and global ones
    (2, 2, 1, 200, 40, 24, True, None),  # padded head dims
    (2, 4, 2, 300, 64, 64, False, 40),  # non-causal with a window
    (1, 4, 4, 77, 16, 8, True, 5),  # a tile smaller than one of the kernel
])


# bf16 on tensor cores: products of bf16 inputs summed in f32 (mma.sync),
# P rounded to bf16 before P V, exp2 with log2(e) folded into the scale,
# and a bf16 output: within 2e-2 of the f32 plain version.
@pytest.mark.cuda
@_MMA_CASES
def test_flash_attention_mma_kernel(cuda, b, h, hk, s, d, dv, causal,
                                    window):
    q, k, v = (t.to(cuda) for t in _port(
        _qkv((b, h, s, d), torch.bfloat16, seed=s + d, dv=dv, hk=hk),
        torch.bfloat16))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == exp.shape
    torch.testing.assert_close(out.float(), exp.float(), atol=2e-2,
                               rtol=2e-2)


# f32 on tensor cores as 3xTF32 (flash_fwd_tf32): each product split
# into three TF32 products summed in f32, exp2 with log2(e) folded into the
# scale: within the same 1e-4 as the other f32 tests (the CPU emulation in
# test_flash_attention_3xtf32_split_keeps_f32_parity gives ~2e-6).
@pytest.mark.cuda
@_MMA_CASES
def test_flash_attention_tf32_kernel(cuda, b, h, hk, s, d, dv, causal,
                                     window):
    q, k, v = (t.to(cuda) for t in _port(
        _qkv((b, h, s, d), torch.float32, seed=s + d, dv=dv, hk=hk),
        torch.float32))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == torch.float32 and out.shape == exp.shape
    torch.testing.assert_close(out, exp, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("d,h,hk,window", [(128, 64, 8, None),
                                           (256, 4, 1, 512),
                                           (16, 4, 1, 32)])
def test_flash_attention_mma_kernel_model_views(cuda, d, h, hk, window,
                                                dtype, tol):
    q, k, v = (t.to(cuda) for t in _bsdh_views(2, 300, h, hk, d, dtype))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, window=window)
    exp = ref.flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("what", ["pointer", "seq_stride", "head_dim"])
def test_flash_attention_mma_kernel_rejects(cuda, what, dtype):
    """An input that breaks the layout rule raises, with no launch and no
    other path."""
    bad = _misaligned(what, cuda, dtype)
    q = torch.zeros(1, 2, 16, bad.shape[-1], dtype=dtype, device=cuda)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match=str(dtype).split(".")[-1]):
        ops.flash_attention(q, bad, q)
    assert ops.LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("block,bpt", [(256, 4), (2048, 8), (65536, 8)])
def test_delta_mask_kernel(cuda, block, bpt):
    new, old = _flipped(block * bpt * 16, block, seed=block)
    nv, ov = torch.from_numpy(new).to(cuda), torch.from_numpy(old).to(cuda)
    m = ops.delta_mask(nv, ov, block=block, bpt=bpt)
    torch.cuda.synchronize()
    assert torch.equal(m.cpu(), ref.delta_mask_ref(torch.from_numpy(new),
                                                   torch.from_numpy(old),
                                                   block))
    assert not ops.delta_mask(nv, nv.clone(), block=block, bpt=bpt).any()


def _scan_inputs(shape, seed, device):
    b, s, d, n = shape
    rng = np.random.default_rng(seed)
    arrs = (np.exp(-rng.uniform(0.0, 2.0, (b, s, d, n))),
            rng.standard_normal((b, s, d, n)), rng.standard_normal((b, s, n)),
            rng.standard_normal((b, d, n)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 512, 16),  # Jamba's N
                                   (2, 1000, 300, 16),  # ragged S and D
                                   (1, 77, 33, 4),  # the reduced config's N
                                   (2, 64, 17, 32), (3, 50, 9, 1)])
def test_ssm_scan_kernel(cuda, shape):
    decay, u, c, s0 = _scan_inputs(shape, seed=shape[1], device=cuda)
    before = ops.LAUNCHES["ssm_scan"]
    y, fin = ops.ssm_scan(decay, u, c, s0)
    ey, efin = ref.ssm_scan_ref(decay, u, c, s0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan"] == before + 1
    assert y.shape == ey.shape and fin.shape == efin.shape
    # FMA and the shuffle sum's order against the plain version's mul, add
    # and einsum: a few float32 ulps per step, damped by decay <= 1
    torch.testing.assert_close(y, ey, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(fin, efin, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["bfloat16", "n3", "n64", "strided"])
def test_ssm_scan_kernel_rejects(cuda, bad):
    n = {"n3": 3, "n64": 64}.get(bad, 8)
    decay, u, c, s0 = _scan_inputs((2, 16, 8, n), seed=0, device=cuda)
    if bad == "bfloat16":
        decay = decay.to(torch.bfloat16)
    if bad == "strided":
        u = u.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        ops.ssm_scan(decay, u, c, s0)
