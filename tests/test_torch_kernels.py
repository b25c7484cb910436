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
import types

import numpy as np
import pytest
import torch

from repro.ckpt.delta import changed_blocks
from repro_torch.ckpt.checkpoint import _changed_block_idxs
from repro_torch.kernels import ops, ref


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
