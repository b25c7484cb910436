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
import inspect
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
from repro_torch.kernels import ssm_scan as ssm


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
def test_check_tma_layout_takes_model_views(d, h, hk, dtype):
    q, k, v = _bsdh_views(2, 24, h, hk, d, dtype)
    flash.check_tma_layout({"q": q, "k": k, "v": v})


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
def test_check_tma_layout_raises(what, dtype):
    with pytest.raises(ValueError, match=str(dtype).split(".")[-1]):
        flash.check_tma_layout({"k": _misaligned(what, dtype=dtype)})


def _body(src, head):
    """The C++ function of ``src`` that starts at ``head``."""
    start = src.index(head)
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_cu_bf16_runs_only_on_tensor_cores(dtype):
    """Each dtype goes to one tensor-core kernel, fed by TMA tensor copies
    through mbarriers from a producer warpgroup that hands its registers
    over with setmaxnreg, helpers that hopper.cuh holds: bf16 to
    flash_fwd_wgmma, whose products are wgmma.mma_async bf16 (Q K^T from
    shared memory, P V with P from registers); f32 to flash_fwd_tf32, whose
    products are 3xTF32 wgmma.mma_async .tf32 (wgmma_3xtf32) with A split
    in registers (split4) and B the TF32 halves that its pre-pass writes.
    No SIMT kernel, no scalar product, no warp-level mma.sync and no
    cp.async copy is left."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    hop = (_build.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    if dtype == "bfloat16":
        assert "if (dtype == 1) return launch_wgmma(p, B, st);" in src
        # every branch of the entry launches the one kernel, at some tile,
        # but the one that refuses head dims that are not multiples of 8
        entry = _body(src, "int launch_wgmma(")
        refuse = "return static_cast<int>(cudaErrorInvalidValue);"
        assert entry.count(refuse) == 1
        assert entry.count("return wg::launch<") \
            == entry.count("return ") - 1
        assert re.findall(r"(flash_fwd_\w+)<HD, BK, KS, VN>\s*<<<",
                          _body(src, "int launch(const Params& p")) \
            == ["flash_fwd_wgmma"]
        kernel = _body(src, "flash_fwd_wgmma(const __grid_constant__")
        for call in ("tma_load(", "tma_store(", "mbar_wait(", "mbar_arrive(",
                     "mbar_expect_tx(", "setmaxnreg_dec<", "setmaxnreg_inc<",
                     "issue_qk<", "issue_pv<", "wgmma_fence(",
                     "wgmma_commit(", "wgmma_wait<", "named_sync(",
                     "named_arrive("):
            assert call in kernel, call
        # Q K^T from shared memory, P V with P from registers (64 or 128
        # columns a product)
        assert "wgmma_ss(" in _body(src, "void issue_qk(")
        assert "wgmma_rs_tb(" in _body(src, "void issue_pv(")
        assert "wgmma_rs_tb(" in _body(src, "void pv_atom(")
        shapes = re.findall(r"wgmma\.mma_async\.sync\.aligned\.m64n(\d+)k16"
                            r"\.f32\.(\w+)\.(\w+)", hop)
        assert shapes and all(a == b == "bf16" for _, a, b in shapes)
        assert "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier" \
            in _body(hop, "void tma_load(")
        assert "mbarrier.try_wait.parity" in _body(hop, "void mbar_wait(")
        assert "setmaxnreg.dec.sync.aligned" in _body(hop,
                                                      "void setmaxnreg_dec(")
        assert "cuTensorMapEncodeTiled" in _body(hop,
                                                 "PFN_cuTensorMapEncodeTiled "
                                                 "encode_tiled(")
        for gone in ("mma16816", "flash_fwd_mma", "ldmatrix.sync", "m16n8k16",
                     "launch_mma"):
            assert gone not in src, gone
        assert "mma.sync" not in kernel and "cp.async.cg" not in kernel
    else:
        # the entry sends f32 to launch_tf32, whose every branch launches
        # tf::launch at some tile but the one that refuses head dims that
        # are not multiples of 4 (or a call without the pre-pass's scratch)
        assert re.search(r"if \(dtype == 0\)\s*return launch_tf32\(", src)
        entry = _body(src, "int launch_tf32(")
        assert entry.count("return static_cast<int>(cudaErrorInvalidValue);") \
            == 1
        assert entry.count("return tf::launch<") == entry.count("return ") - 1
        # a call is the pre-pass, then the one kernel
        launch = _body(src, "int launch(const Params& p, int B, float* kv,")
        assert re.findall(r"(flash_fwd_\w+)(?:<<<|<BQ, QW, DV, BK, ST, KS, "
                          r"VN>;)", launch) \
            == ["flash_fwd_prep_kv", "flash_fwd_tf32"]
        assert launch.count("<<<") == 2
        assert "split_keys(" in _body(src, "flash_fwd_prep_kv(Params p")
        kernel = _body(src, "flash_fwd_tf32(const __grid_constant__")
        for call in ("tma_load(", "mbar_wait(", "mbar_arrive(",
                     "mbar_expect_tx(", "setmaxnreg_dec<", "setmaxnreg_inc<",
                     "issue_qk<", "issue_pv<", "wgmma_fence(",
                     "wgmma_commit(", "wgmma_wait<", "split4("):
            assert call in kernel, call
        # every product is a 3xTF32 wgmma: Q K^T on Q split in registers,
        # P V on P split in registers, both with B from shared memory
        tf = src[src.index("namespace tf {"):]  # the f32 kernel's helpers
        qk, pv = _body(tf, "void issue_qk("), _body(tf, "void issue_pv(")
        assert qk.count("wgmma_3xtf32(") == 1 and "split4(" in qk
        assert pv.count("wgmma_3xtf32(") == 4  # 64 wide; or 16, 32, 64
        assert "wgmma_" not in kernel.replace("wgmma_fence(", "").replace(
            "wgmma_commit(", "").replace("wgmma_wait<", "")
        for n in (16, 32, 64):
            assert f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32" \
                in hop
        assert _body(hop, "void wgmma_3xtf32(").count("wgmma_tf32(") == 3
        # both halves of a B operand rounded as _tf32 below rounds
        assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" \
            in _body(hop, "uint32_t tf32_big(")
        for gone in ("mma.sync", "mma1688", "cp.async.cg", "cp.async.ca",
                     "split_tf32", "flash_fwd_tf32(Params p", "atomicAdd"):
            assert gone not in src, gone
        assert not re.search(r"\bmma_3xtf32\(", src)
        assert not (_build.CSRC / "tf32_mma.cuh").exists()
    assert "flash_fwd_simt" not in src and "fmaf(" not in src


def test_flash_attention_cu_d160_has_its_own_instantiations():
    """D = Dv = 160 (stablelm-12b) goes, in each dtype, to an instantiation
    whose k-steps and P V width are template constants, so that no run-time
    width sits between its products: bf16 a 192-wide tile (three 64-column
    atoms) of 64-key tiles, ten 16-deep k-steps, P V 160 wide; f32
    128-row items whose consumers take all 160 head dims of their 64 rows
    (twenty 8-deep k-steps, O 160 wide), 32-key tiles, one stage. Every
    other width of each head tile still reaches the instantiation that
    reads D and Dv at run time, after the branch."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    branch = r"if \(p\.D == 160 && p\.Dv == 160\)[^\n]*\n\s*return "
    wg = _body(src, "int launch_wgmma(")
    m = re.search(branch + r"wg::launch<([\d, ]+)>\(", wg)
    assert m and m.group(1) == "192, 64, 10, 160"
    assert wg.index(m.group(0)) < wg.index("return wg::launch<256, 64>(")
    for tile in ("64, 128", "128, 128", "256, 64"):
        assert f"return wg::launch<{tile}>(p, B, stream);" in wg
    tf = _body(src, "int launch_tf32(")
    m = re.search(branch + r"tf::launch<([\d, ]+)>\(", tf)
    assert m and m.group(1) == "128, 160, 160, 32, 1, 20, 160"
    assert tf.index(m.group(0)) < tf.index(
        "return tf::launch<64, 256, 256, 32, 1>(")
    for tile in ("128, 64, 64, 64, 2", "128, 128, 128, 32, 2",
                 "64, 256, 256, 32, 1"):
        assert f"return tf::launch<{tile}>(p, B, kv, vt, stream);" in tf
    # the bf16 tile of 192 keeps its own output tile (the next Q loads
    # while the output is stored), and its P V is the 128-wide product
    # over atoms 0 and 1 plus a 32-wide one on atom 2
    assert "static constexpr bool kOwnO = HD <= 192;" in src
    assert "constexpr bool kWide = VN == 128 || VN == 160;" in src
    assert flash.head_tile(160, 160) == 192


def test_flash_attention_fwd_takes_one_block_and_checks_layout_first():
    """The forward's C entry takes one packed argument block, as many bytes
    as the wrapper packs, and checks the layout rule before anything else,
    the empty problem's early return included; the SM count and each
    kernel's shared-memory attribute are set once a device, not once a
    call."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    entry = _body(src, "int flash_attention_fwd(const FwdArgs* a) {")
    assert f"sizeof(FwdArgs) == {flash._FWD_ARGS.size}" in src
    assert entry.index("return kBadLayout;") \
        < entry.index("if (B <= 0 || H <= 0 || S <= 0) return 0;")
    assert entry.count("layout_ok(") == 4  # q, k, v and o
    assert "constexpr int kBadLayout = -1;" in src \
        and flash._BAD_LAYOUT == -1
    for launch in ("int launch(const Params& p, int B, cudaStream_t",
                   "int launch(const Params& p, int B, float* kv,"):
        body = _body(src, launch)
        assert "device_setup(" in body
        assert "cudaFuncSetAttribute" not in body
        assert "cudaDeviceGetAttribute" not in body


def test_flash_attention_bwd_cu_d160_has_its_own_instantiation():
    """D = Dv = 160 (stablelm-12b) goes to a backward instantiation whose
    k-steps (twenty of 8, D and Dv) and dQ width (160) are template
    constants: 160-wide tiles of five 32-column atoms, 32-key tiles, one
    Q/dO stage, a block an item (as at 256; persistent blocks measured
    slower), with dK^T and dV^T as three m64 tiles (the last with 32 real
    rows) and dQ's n-tiles 64, 64 and 32 wide. Every other
    width above 128 still reaches the instantiation of the 256-wide tile
    that reads D and Dv at run time, after the branch; the products' widths
    and so the padded bound are unchanged."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    entry = _body(src, "int flash_attention_bwd(const BwdArgs* a) {")
    m = re.search(r"if \(D == 160 && Dv == 160\)[^\n]*\n\s*return "
                  r"launch<([\d, ]+)>\(p, stream\);", entry)
    assert m and m.group(1) == "160, 32, 1, 4, 20, 20, 160"
    assert entry.index(m.group(0)) \
        < entry.index("return launch<256, 16, 1, 2, 0, 0, 0>(p, stream);")
    for run_time in ("64, 64, 2, 4", "128, 32, 2, 4", "256, 16, 1, 2"):
        assert f"return launch<{run_time}, 0, 0, 0>(p, stream);" in entry
    # dK^T and dV^T run in m64 tiles of a head tile that need not be a
    # multiple of 64; only tiles up to 128 wide are persistent
    assert "constexpr int m_tiles(int hd) { return (hd + 63) / 64; }" in src
    assert "HD / 64" not in src.replace("? (W + 63) / 64 : HD / 64", "")
    assert "constexpr bool persistent(int hd) { return hd <= 128; }" in src
    assert "dkdv::persistent(HD) && items > sms ? sms : items" in src
    # the dQ pass's last n-tile is 32 wide where W is not a multiple of 64
    assert "constexpr int kNT = W > 0 ? (W + 63) / 64 : HD / 64;" in src
    assert flash.bwd_product_widths(160, 160) == (160, 160, 192, 160, 192)


def test_flash_attention_bwd_takes_one_block_and_checks_layout_first():
    """The backward's C entry takes one packed argument block, as many
    bytes as the wrapper packs, and checks q's and dout's layout before
    anything else, the empty problem's early return included; the SM count
    and each kernel's shared-memory attribute are set once a device
    (device_setup), not once a call. The forward and the backward share
    device_setup and the layout rule (hopper.cuh)."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    hop = (_build.CSRC / "hopper.cuh").read_text()
    entry = _body(src, "int flash_attention_bwd(const BwdArgs* a) {")
    assert f"sizeof(BwdArgs) == {flash._BWD_ARGS.size}" in src
    first = entry.index("return noted(kBadLayout,")
    assert first < entry.index("cudaGetLastError();")
    assert first < entry.index("if (B <= 0 || H <= 0 || S <= 0) return 0;")
    assert entry.count("layout_ok(") == 2  # q and dout, which TMA reads
    assert "constexpr int kBadLayout = -1;" in src \
        and flash._BAD_LAYOUT == -1
    launch = _body(src, "int launch(const Params& p")
    assert launch.count("device_setup(") == 2  # dK/dV and dQ
    for per_call in ("cudaFuncSetAttribute", "cudaDeviceGetAttribute",
                     "cudaGetDevice", "set_smem"):
        assert per_call not in src, per_call
    for helper in ("inline int device_setup(", "inline bool layout_ok("):
        assert helper in hop
        assert helper not in src
        assert helper not in (_build.CSRC / "flash_attention.cu").read_text()
    wrapper = inspect.getsource(flash.flash_attention_bwd_cuda)
    assert "_BWD_ARGS.pack(" in wrapper
    assert "_cuda_getCurrentRawStream" in wrapper
    assert "current_stream(" not in wrapper


@pytest.mark.parametrize("d,dv,dtype,widths", [
    (96, 64, torch.bfloat16, (96, 64)),  # MLA: no column of the tile past D
    (128, 128, torch.bfloat16, (128, 128)),  # Jamba
    (40, 24, torch.bfloat16, (48, 24)),  # D to the k-step of 16
    (16, 8, torch.bfloat16, (16, 8)),
    (256, 200, torch.bfloat16, (256, 200)),
    (96, 64, torch.float32, (96, 64)),  # MLA: no column past D or Dv
    (40, 24, torch.float32, (40, 32)),  # D to the k-step of 8, Dv to 32
    (256, 200, torch.float32, (256, 208)),  # Dv: chunks of 64, then 16
])
def test_flash_product_widths_per_dtype(d, dv, dtype, widths):
    """The widths each forward kernel computes at, and the padded work the
    chip_smoke bounds take from them: the bf16 kernel's wgmma runs D up to
    16 and Dv up to 8, the f32 kernel's D up to 8 and Dv in chunks of 64
    columns, the last one 16, 32 or 64 wide."""
    assert flash.product_widths(d, dv, dtype) == widths
    flops, _ = flash.work(4, 40, 40, 1024, d, dv, None, 2)
    assert flash.padded_flops(flops, d, dv, dtype=dtype) == pytest.approx(
        flops * sum(widths) / (d + dv), rel=1e-12)
    assert flash.head_tile(d, dv) == next(
        t for t in (64, 128, 256) if max(d, dv) <= t)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32: add half the weight of the 13 dropped bits
    to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """x with its 13 low mantissa bits cleared, as the tensor cores read
    an f32 word as TF32."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _product(a, b, how):
    """a @ b as the tensor cores compute it from f32 operands: "f32" as
    is, "tf32" one product of the rounded operands, "3xtf32" the split
    x = big + small: small*big + big*small, then + big*big, with big and
    small both rounded to TF32 (the forward's split); "3xtf32k" the
    backward's: b split so (its tiles in shared memory), a, the operand in
    registers, with small = a - big unrounded, read by the tensor cores
    with its low 13 bits dropped."""
    if how == "f32":
        return a @ b
    a_big, b_big = _tf32(a), _tf32(b)
    if how == "tf32":
        return a_big @ b_big
    a_small = (_tf32_trunc if how == "3xtf32k" else _tf32)(a - a_big)
    return (a_small @ b_big + a_big @ _tf32(b - b_big)) + a_big @ b_big


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
    is 1.91e-06 from the f32 plain version (window None or 64), and so is
    within 1e-5 the split that the kernel runs ("3xtf32k": Q and P split in
    registers with small = x - big unrounded, K's and V^T's halves both
    rounded); one TF32 product on Q K^T alone is 8.17e-04 from it, on P V
    alone 9.35e-04: outside the 1e-4 that the card's f32 tests and
    chip_smoke.py hold the kernel to."""
    q, k, v = _port(_qkv((2, 4, 256, 256), torch.float32, seed=256, hk=1),
                    torch.float32)
    exp = ref.flash_attention_ref(q, k, v, window=window)

    def err(qk, pv):
        out = _emulated_flash(q, k, v, window, qk, pv)
        return (out - exp).abs().max().item()
    assert err("3xtf32", "3xtf32") < 1e-4
    assert err("3xtf32k", "3xtf32k") < 1e-5
    assert err("tf32", "f32") > 1e-4
    assert err("f32", "tf32") > 1e-4


# -- the backward: flash_attention_bwd_ref and the autograd path ------------

_BWD_CASES = pytest.mark.parametrize("b,h,hk,s,d,dv,causal,window", [
    (2, 2, 2, 64, 32, 32, True, None),  # causal
    (1, 4, 4, 96, 16, 16, True, 24),  # a window
    (2, 4, 1, 80, 32, 32, True, 16),  # GQA, gemma3-1b's 4:1
    (1, 2, 2, 77, 16, 16, True, None),  # ragged S
    (1, 4, 2, 64, 32, 16, True, 20),  # Dv != D
    (1, 2, 1, 48, 16, 16, False, 12),  # non-causal with a window
])


def _bwd_inputs(b, h, hk, s, d, dv, seed):
    q, k, v = _qkv((b, h, s, d), torch.float32, seed=seed, dv=dv, hk=hk)
    dout = np.random.default_rng(seed + 1).standard_normal(
        (b, h, s, dv)).astype(np.float32)
    return q, k, v, dout


# f32 tolerance of the backward: 1e-5 of the largest gradient element (the
# full-matrix formulas against JAX's autodiff, both f32 on the CPU)
def _assert_grads_close(got, exp, rel=1e-5):
    for g, e in zip(got, exp):
        g, e = np.asarray(g, np.float32), np.asarray(e, np.float32)
        assert g.shape == e.shape
        np.testing.assert_allclose(g, e, rtol=0,
                                   atol=rel * np.abs(e).max())


@_BWD_CASES
def test_flash_attention_bwd_ref_matches_jax_vjp(jx, b, h, hk, s, d, dv,
                                                  causal, window):
    """The plain backward against ``jax.vjp`` of the JAX package's
    ``flash_attention_ref``; JAX gets k and v expanded to H heads, and its
    gradients are summed back over each kv head's group."""
    import jax
    q, k, v, dout = _bwd_inputs(b, h, hk, s, d, dv, seed=s + d)
    g = h // hk
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, causal=causal,
                                      window=window)
    _, vjp = jax.vjp(lambda a, b_, c: jx.ref.flash_attention_ref(
        a, b_, c, causal=causal, window=window), *(jx.jnp.asarray(a) for a in (
            q, np.repeat(k, g, axis=1), np.repeat(v, g, axis=1))))
    jq, jk, jv = (np.asarray(a) for a in vjp(jx.jnp.asarray(dout)))
    jk = jk.reshape(b, hk, g, s, d).sum(axis=2)
    jv = jv.reshape(b, hk, g, s, dv).sum(axis=2)
    _assert_grads_close([t.numpy() for t in got], [jq, jk, jv])


@_BWD_CASES
def test_flash_attention_autograd_matches_plain_autograd(b, h, hk, s, d, dv,
                                                         causal, window):
    """``ops.flash_attention`` under autograd (its backward is
    ``flash_attention_bwd_ref`` on the CPU) gives the gradients that
    autograd takes through ``flash_attention_ref``."""
    arrs = _bwd_inputs(b, h, hk, s, d, dv, seed=s + h)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    dout = torch.from_numpy(arrs[3])
    got = torch.autograd.grad(ops.flash_attention(
        q, k, v, causal=causal, window=window), (q, k, v), dout)
    exp = torch.autograd.grad(ref.flash_attention_ref(
        q, k, v, causal=causal, window=window), (q, k, v), dout)
    _assert_grads_close(got, exp)


def test_flash_attention_without_grad_saves_nothing():
    """Serving (no gradient) runs the forward alone: no autograd node."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(
        (1, 2, 16, 8), torch.float32, seed=1))
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.flash_attention(q, k, v).grad_fn is not None


def _emulated_flash_bwd(q, k, v, out, dout, window, how):
    """flash_attention_bwd.cu's arithmetic over whole rows at once: the
    forward's log-sum-exp in base 2 (from 3xTF32 scores, as flash_fwd_tf32
    gives it), P = exp2(S scale log2(e) - lse) with S recomputed by
    ``how``, delta = rowsum(dO o O) in f32, and dP = dO V^T, dV = P^T dO,
    dK = dS^T Q scale, dQ = dS K scale by ``how``, each with the operand
    that the kernel holds in registers first (dV^T = dO^T P, dK^T = Q^T
    dS); with "3xtf32k" dS takes P as the sum of its split halves, as the
    kernel reads P back from the tiles it wrote; dK and dV summed over
    each kv head's group."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = h // hk
    ke, ve = (t.repeat_interleave(g, dim=1) for t in (k, v))
    scale = 1.0 / math.sqrt(d)
    i = torch.arange(s)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[:, None] - i[None, :] < window

    def scores(qk):
        x = _product(q, ke.transpose(-1, -2), qk) * (
            scale * math.log2(math.e))
        return torch.where(mask, x, torch.full_like(x, ref.NEG_INF))
    lse = torch.logsumexp(scores("3xtf32") * math.log(2), dim=-1,
                          keepdim=True) / math.log(2)
    p = torch.exp2(scores(how) - lse)
    delta = (dout * out).sum(dim=-1, keepdim=True)
    p_ds = p
    if how == "3xtf32k":
        p_ds = _tf32(p) + _tf32(p - _tf32(p))
    ds = p_ds * (_product(dout, ve.transpose(-1, -2), how) - delta)
    dv = _product(dout.transpose(-1, -2), p, how).transpose(-1, -2)
    dk = _product(q.transpose(-1, -2), ds, how).transpose(-1, -2) * scale
    dq = _product(ds, ke, how) * scale
    return (dq, dk.reshape(b, hk, g, s, d).sum(dim=2),
            dv.reshape(b, hk, g, s, v.shape[-1]).sum(dim=2))


@pytest.mark.parametrize("split", ["3xtf32", "3xtf32k"])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_bwd_3xtf32_split_keeps_f32_parity(window, split):
    """Why the backward splits every product into three TF32 products. At
    gemma3-1b's heads (H=4, Hk=1, D=256), B=2, S=256, the emulated split
    is within 1.5e-06 of each gradient's max from the f32 plain version,
    both with the forward's split ("3xtf32") and with the one the kernel
    runs ("3xtf32k": small unrounded in the register operand; see
    _emulated_flash_bwd; window None or 64); with each of the five
    products and the recomputed P as one TF32 product, dQ is 1.18e-03 of
    its max from it, dK 6.8e-04 to 7.7e-04, dV 7.2e-04: outside the 1e-4
    that the card's tests and chip_smoke.py hold the kernel to."""
    q, k, v, dout = (torch.from_numpy(a) for a in _bwd_inputs(
        2, 4, 1, 256, 256, 256, seed=512))
    out = ref.flash_attention_ref(q, k, v, window=window)
    exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, window=window)

    def errs(how):
        got = _emulated_flash_bwd(q, k, v, out, dout, window, how)
        return [((g - e).abs().max() / e.abs().max()).item()
                for g, e in zip(got, exp)]
    assert max(errs(split)) < 1e-5
    assert min(errs("tf32")) > 5e-4


def test_flash_attention_bwd_cu_runs_only_on_tensor_cores():
    """Every product of the backward is 3xTF32 wgmma on tiles that TMA
    brings: the dK/dV kernel runs S or dP through product_nt and dK^T or
    dV^T through product_tn, the dQ kernel dS K, each as wgmma_3xtf32
    (hopper.cuh: three wgmma.mma_async .tf32 products, A in registers) on
    A fragments split once by split4, with B tiles that TMA lands
    (cp.async.bulk.tensor) on mbarriers. No mma.sync, mma1688, cp_async4,
    atomicAdd or SIMT product loop is left; the passes that are not
    products (delta, the K/V split, the group sum) issue no wgmma."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    hdr = (_build.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src and "tf32_mma.cuh" not in src
    for gone in ("mma.sync", "mma1688", "cp_async4", "cp.async.ca",
                 "atomicAdd", "dots<", "fmaf("):
        assert gone not in src
    assert not re.search(r"\bmma_3xtf32\(", src)  # tf32_mma.cuh's
    for n in (16, 32, 64):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32" in hdr
    assert _body(hdr, "void wgmma_3xtf32(").count("wgmma_tf32(") == 3
    assert "cp.async.bulk.tensor" in _body(hdr, "void tma_load(")
    assert "FLOAT32" in _body(hdr, "inline int make_map(")
    for helper in ("void product_nt(", "void product_tn("):
        body = _body(src, helper)
        assert body.count("wgmma_3xtf32(") == 1 and "split4(" in body
        assert "wgmma_fence()" in body and "wgmma_wait<0>()" in body
    # an atom of Q or dO is waited for before its products, freed after
    assert "mbar_wait(" in _body(src, "void product_nt(")
    assert "mbar_arrive(" in _body(src, "void product_tn(")
    consume = _body(src, "void consume(")
    assert consume.count("product_nt<") == 1
    assert consume.count("product_tn<") == 1
    dkdv = _body(src, "flash_bwd_dkdv(const __grid_constant__")
    assert dkdv.count("tma_load(") == 6 and "setmaxnreg_dec<" in dkdv
    # both roles, in the persistent loop (HD <= 128) and in the one-item
    # body (HD = 256)
    assert dkdv.count("consume<") == 4 and "if constexpr (kPersistent)" in dkdv
    dq = _body(src, "flash_bwd_dq(const __grid_constant__")
    assert dq.count("tma_load(") == 3 and "split4(" in dq
    assert dq.count("wgmma_3xtf32(") == 3  # 64 wide, or the last 32 wide
    for kernel in ("flash_bwd_delta(Params p)", "flash_bwd_prep_kv(Params p)",
                   "flash_bwd_dkdv_sum(Params p)"):
        body = _body(src, kernel)
        assert "wgmma" not in body and "tma_" not in body
    launch = _body(src, "int launch(const Params& p")
    assert re.findall(r"(?:launch_one\(|::)(flash_bwd_\w+)", launch) == [
        "flash_bwd_delta", "flash_bwd_prep_kv", "flash_bwd_dkdv",
        "flash_bwd_dkdv_sum", "flash_bwd_dq"]


@pytest.mark.parametrize("b,hk,group,s,cap", [
    (4, 1, 4, 1024, 1 << 30),  # gemma3-1b's train shape: one launch
    (4, 2, 6, 1280, 80 << 20),  # batches a slab
    (2, 8, 1, 4096, 130 << 20),  # kv heads a slab, within one batch
    (1, 2, 4, 8192, 1 << 20),  # one kv head over the limit: a slab alone
])
def test_flash_bwd_slabs_cover_each_kv_head_once(monkeypatch, b, hk, group,
                                                 s, cap):
    """The backward's dS scratch stays under BWD_DS_BYTES a launch: the
    slabs cover every (batch, kv head) once, each within the limit unless
    it is one kv head, and where several batches share a slab it holds
    all their kv heads (lse and the scratch stay contiguous)."""
    monkeypatch.setattr(flash, "BWD_DS_BYTES", cap)
    ld = -(-s // 8) * 8
    slabs = flash._slabs(b, hk, group, s, ld)
    seen = [(i, j) for bs, ks in slabs for i in range(bs.start, bs.stop)
            for j in range(ks.start, ks.stop)]
    assert sorted(seen) == [(i, j) for i in range(b) for j in range(hk)]
    for bs, ks in slabs:
        n_kvh = (bs.stop - bs.start) * (ks.stop - ks.start)
        assert n_kvh == 1 or n_kvh * group * s * ld * 4 <= cap
        assert bs.stop - bs.start == 1 or (ks.start, ks.stop) == (0, hk)


def test_library_path_hashes_headers(tmp_path, monkeypatch):
    """An edit to a csrc header names a new library, so every source is
    rebuilt with it; an edit elsewhere does not."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    (tmp_path / "notes.txt").write_text("not a header")
    assert {n: _build.library_path(n) for n in _build.SOURCES} == before
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)


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
    (2, 4, 4, 256, 256, 256, True, 64),  # gemma's heads with G = 1
    (2, 2, 1, 200, 40, 24, True, None),  # padded head dims
    (2, 4, 2, 300, 64, 64, False, 40),  # non-causal with a window
    (1, 4, 4, 77, 16, 8, True, 5),  # a tile smaller than one of the kernel
    (1, 40, 40, 1024, 96, 64, True, None),  # minicpm3-4b's MLA heads
    (1, 8, 2, 1000, 256, 192, True, 300),  # HD = 256, windowed, ragged
    (1, 8, 2, 1000, 160, 160, True, None),  # stablelm's D = 160, ragged
    (2, 4, 4, 1024, 160, 160, True, 512),  # D = 160, window, G = 1
    (1, 4, 2, 256, 160, 160, False, 64),  # D = 160, non-causal window
    (1, 4, 1, 300, 200, 200, True, None),  # run-time widths at HD = 256
])


# bf16 on tensor cores: products of bf16 inputs summed in f32 (wgmma),
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hk,s,d,dv,window", [
    (4, 64, 8, 1024, 128, 128, None),  # Jamba's prefill
    (4, 40, 40, 1024, 96, 64, None),  # minicpm3-4b's MLA heads
    (1, 8, 2, 1000, 256, 192, 300),  # HD = 256 at run-time widths
    (1, 8, 2, 1000, 160, 160, 512),  # stablelm's D = 160, ragged, window
    (1, 4, 1, 300, 200, 200, None),  # run-time widths at HD = 256
])
def test_flash_attention_wgmma_kernel_bit_equal(cuda, b, h, hk, s, d, dv,
                                                window):
    """Two launches of the bf16 kernel on the same inputs give the same
    bits: each row's sums run in one fixed order, with no atomics."""
    gen = torch.Generator(cuda).manual_seed(s + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for shape in ((b, h, s, d), (b, hk, s, d),
                                      (b, hk, s, dv)))
    first = ops.flash_attention(q, k, v, window=window)
    second = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


# The f32 forward's log-sum-exp, kept for the backward: base 2 of the
# scores scaled by scale*log2(e), so times ln 2 it is torch.logsumexp of
# the masked, scaled f32 scores, within 1e-5 (3xTF32 scores, an exp2 sum
# in another order).
@pytest.mark.cuda
@_MMA_CASES
def test_flash_attention_tf32_kernel_lse(cuda, b, h, hk, s, d, dv, causal,
                                         window):
    q, k, v = (t.to(cuda) for t in _port(
        _qkv((b, h, s, d), torch.float32, seed=s + d, dv=dv, hk=hk),
        torch.float32))
    out, lse = flash.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, scale=None,
                                          with_lse=True)
    alone = flash.flash_attention_cuda(q, k, v, causal=causal,
                                       window=window, scale=None)
    ke = k.repeat_interleave(h // hk, dim=1)
    x = torch.einsum("bhqd,bhkd->bhqk", q, ke) / math.sqrt(d)
    i = torch.arange(s, device=cuda)
    mask = torch.ones((s, s), dtype=torch.bool, device=cuda)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[:, None] - i[None, :] < window
    exp = torch.logsumexp(x.masked_fill(~mask, -math.inf), dim=-1)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert torch.equal(out, alone)  # keeping lse leaves the output as it is
    torch.testing.assert_close(lse * math.log(2), exp, atol=1e-5, rtol=0)


@pytest.mark.cuda
@_MMA_CASES
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_attention_tf32_kernel_bit_equal(cuda, b, h, hk, s, d, dv,
                                               causal, window, with_lse):
    """Two launches of the f32 kernel on the same inputs give the same bits,
    output and lse: each row's sums run in one fixed order (at HD = 256 the
    two consumer warpgroups' partial scores are added alike by both), with
    no atomics; the bit-exact train resumes rest on it."""
    q, k, v = (t.to(cuda) for t in _port(
        _qkv((b, h, s, d), torch.float32, seed=s + d, dv=dv, hk=hk),
        torch.float32))
    kw = dict(causal=causal, window=window, scale=None, with_lse=with_lse)
    first = flash.flash_attention_cuda(q, k, v, **kw)
    second = flash.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    if not with_lse:
        first, second = (first,), (second,)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_flash_attention_lse_is_f32_only(cuda):
    q = torch.zeros(1, 2, 16, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        flash.flash_attention_cuda(q, q, q, causal=True, window=None,
                                   scale=None, with_lse=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("d,h,hk,window", [(128, 64, 8, None),
                                           (256, 4, 1, 512),
                                           (16, 4, 1, 32),
                                           (160, 32, 8, None),  # stablelm
                                           (160, 8, 8, 512)])
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_rejects_empty_bad_layout(cuda, dtype):
    """The C entry checks the layout rule before it returns at once on an
    empty problem, so an S = 0 input with a head dim that breaks the rule
    raises as it did when the wrapper checked it in Python."""
    bad = torch.zeros(1, 2, 0, 6 if dtype == torch.float32 else 36,
                      dtype=dtype, device=cuda)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention_cuda(bad, bad, bad, causal=True, window=None,
                                   scale=None)
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


def _scan_grad_inputs(shape, seed, device):
    """_scan_inputs with 5 % exact-zero decays, and dy, dfinal."""
    b, s, d, n = shape
    decay, u, c, s0 = _scan_inputs(shape, seed, device)
    gen = torch.Generator(device).manual_seed(seed)
    decay[torch.rand(decay.shape, generator=gen, device=device) < 0.05] = 0
    dy = torch.randn((b, s, d), generator=gen, device=device)
    dfinal = torch.randn((b, d, n), generator=gen, device=device)
    return decay, u, c, s0, dy, dfinal


_SCAN_BWD_SHAPES = pytest.mark.parametrize("shape", [
    (4, 1024, 512, 16),  # Jamba's N, whole chunks
    (2, 1000, 300, 16),  # ragged S (a last chunk of 8) and D
    (1, 77, 33, 4),  # the reduced config's N
    (2, 64, 17, 32), (3, 50, 9, 1), (1, 5, 3, 8)])  # one short chunk


@pytest.mark.cuda
@_SCAN_BWD_SHAPES
def test_ssm_scan_kernel_boundary_states(cuda, shape):
    """Asked for them, the forward kernel also writes the state entering
    every 32 steps (state0 first), and its outputs are the same bits as
    without them."""
    decay, u, c, s0 = _scan_inputs(shape, seed=shape[1], device=cuda)
    y, fin, bounds = ssm.ssm_scan_cuda(decay, u, c, s0, with_bounds=True)
    y2, fin2 = ssm.ssm_scan_cuda(decay, u, c, s0)
    states = [s0]
    for t in range(0, shape[1] - 1):
        _, st = ref.ssm_scan_ref(decay[:, t:t + 1], u[:, t:t + 1],
                                 c[:, t:t + 1], states[-1])
        states.append(st)
    exp = torch.stack(states[::ssm.CHUNK], dim=1)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    assert bounds.shape == exp.shape
    assert torch.equal(bounds[:, 0], s0)
    torch.testing.assert_close(bounds, exp, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@_SCAN_BWD_SHAPES
@pytest.mark.parametrize("with_dfinal", [False, True])
def test_ssm_scan_bwd_kernel(cuda, shape, with_dfinal):
    """From the forward kernel's boundary states, against the plain reverse
    scan, exact-zero decays included: within 1e-4 of each gradient's
    largest element, and the same bits from two launches (no atomics)."""
    decay, u, c, s0, dy, dfinal = _scan_grad_inputs(shape, shape[1], cuda)
    dfinal = dfinal if with_dfinal else None
    _, _, bounds = ssm.ssm_scan_cuda(decay, u, c, s0, with_bounds=True)
    before = ops.LAUNCHES["ssm_scan_bwd"]
    got = ssm.ssm_scan_bwd_cuda(decay, u, c, bounds, dy, dfinal)
    again = ssm.ssm_scan_bwd_cuda(decay, u, c, bounds, dy, dfinal)
    exp = ref.ssm_scan_bwd_ref(decay, u, c, s0, dy, dfinal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan_bwd"] == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _assert_grads_close([g.cpu() for g in got], [e.cpu() for e in exp],
                        rel=BWD_TOL)


@pytest.mark.cuda
def test_ssm_scan_kernel_through_autograd(cuda):
    """``ops.ssm_scan`` under autograd on the card: one forward launch that
    keeps its boundary states, one backward launch, and the gradients of
    autograd through the plain version."""
    ins = [t.requires_grad_() for t in _scan_inputs((2, 100, 40, 16),
                                                    seed=4, device=cuda)]
    dy = torch.randn(2, 100, 40, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5))
    before = dict(ops.LAUNCHES)
    y, _ = ops.ssm_scan(*ins)
    got = torch.autograd.grad(y, ins, dy)
    assert ops.LAUNCHES["ssm_scan"] == before["ssm_scan"] + 1
    assert ops.LAUNCHES["ssm_scan_bwd"] == before["ssm_scan_bwd"] + 1
    exp = torch.autograd.grad(ref.ssm_scan_ref(*ins)[0], ins, dy)
    _assert_grads_close([g.cpu() for g in got], [e.cpu() for e in exp],
                        rel=BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["bfloat16", "n3", "bounds", "strided"])
def test_ssm_scan_bwd_kernel_rejects(cuda, bad):
    """The backward kernel takes float32, contiguous inputs, N a power of
    two and the forward's (B, ceil(S/32), D, N) boundary states; any other
    input raises, with no launch and no other path."""
    n = 3 if bad == "n3" else 8
    decay, u, c, s0, dy, _ = _scan_grad_inputs((2, 40, 8, n), 0, cuda)
    bounds = torch.zeros(2, 1 if bad == "bounds" else 2, 8, n, device=cuda)
    if bad == "bfloat16":
        u = u.to(torch.bfloat16)
    if bad == "strided":
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    before = ops.LAUNCHES["ssm_scan_bwd"]
    with pytest.raises(ValueError):
        ssm.ssm_scan_bwd_cuda(decay, u, c, bounds, dy)
    assert ops.LAUNCHES["ssm_scan_bwd"] == before


# The backward kernel against its plain version on the card: f32 sums of up
# to G*S terms in another order than the plain version's einsums, held to
# 1e-4 of the largest gradient element.
BWD_TOL = 1e-4


def _bwd_on_card(cuda, b, h, hk, s, d, dv, seed):
    return [torch.from_numpy(a).to(cuda) for a in
            _bwd_inputs(b, h, hk, s, d, dv, seed)]


@pytest.mark.cuda
@_MMA_CASES
def test_flash_attention_bwd_kernel(cuda, b, h, hk, s, d, dv, causal,
                                    window):
    """From the forward kernel's output and lse. Where H > Hk (gemma3-1b's
    4:1, Jamba's 8:1) dK and dV go through per-head scratch and the
    group-sum pass; where H == Hk they are written in place."""
    q, k, v, dout = _bwd_on_card(cuda, b, h, hk, s, d, dv, seed=s + d)
    out, lse = flash.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, scale=None,
                                          with_lse=True)
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                         causal=causal, window=window,
                                         scale=None)
    again = flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                           causal=causal, window=window,
                                           scale=None)
    exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                      window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 2
    for g, a in zip(got, again):  # no atomics: the same bits every launch
        assert torch.equal(g, a)
    _assert_grads_close([g.cpu() for g in got], [e.cpu() for e in exp],
                        rel=BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,hk,window", [(256, 4, 1, 512), (16, 4, 1, 32),
                                           (128, 8, 2, None)])
def test_flash_attention_bwd_kernel_through_autograd(cuda, d, h, hk, window):
    """The model's strided (B, S, H, D) views through ``ops.flash_attention``
    under autograd: the backward kernel runs once, and the gradients come
    back in the inputs' shapes."""
    q, k, v = (t.to(cuda).requires_grad_() for t in _bsdh_views(
        2, 300, h, hk, d, torch.float32))
    dout = torch.randn(2, h, 300, d, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(d))
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = torch.autograd.grad(ops.flash_attention(q, k, v, window=window),
                              (q, k, v), dout)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    with torch.no_grad():
        out = ref.flash_attention_ref(q, k, v, window=window)
        exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, window=window)
    for g, t in zip(got, (q, k, v)):
        assert g.shape == t.shape
    _assert_grads_close([g.cpu() for g in got], [e.cpu() for e in exp],
                        rel=BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["bfloat16", "float16", "strided", "lse"])
def test_flash_attention_bwd_kernel_rejects(cuda, bad):
    """The backward kernel takes float32 with a contiguous last dim and the
    forward's (B, H, S) lse; any other input raises, with no launch and no
    other path."""
    dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        bad, torch.float32)
    q, k, v, dout = (t.to(dtype) for t in _bwd_on_card(
        cuda, 1, 2, 2, 32, 16, 16, seed=0))
    out = torch.zeros_like(dout)
    lse = torch.zeros(1, 2, 31 if bad == "lse" else 32, device=cuda)
    if bad == "strided":
        dout = dout.transpose(-1, -2).contiguous().transpose(-1, -2)
    before = ops.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError):
        flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=True,
                                       window=None, scale=None)
    assert ops.LAUNCHES["flash_attention_bwd"] == before


def _misaligned_dout(what, b, h, s, dv, device, seed):
    """dO as a (B, S, H, Dv) view transposed to (B, H, S, Dv) that breaks
    TMA's 16-byte rule: its data pointer one element past a 16-byte line,
    or rows H * Dv + 2 elements apart."""
    gen = torch.Generator(device).manual_seed(seed)
    n = b * s * (h * dv + 2)
    flat = torch.randn(n + 1, generator=gen, device=device)
    if what == "pointer":
        return flat[1:1 + b * s * h * dv].view(b, s, h, dv).transpose(1, 2)
    return flat[:n].view(b, s, h * dv + 2)[..., :h * dv].view(
        b, s, h, dv).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["pointer", "seq_stride"])
def test_flash_attention_bwd_copies_misaligned_dout(cuda, what):
    """An incoming gradient whose layout TMA cannot read goes through
    ``ops.flash_attention`` as a copy: the gradients equal those of the
    same values laid out contiguously, bit for bit."""
    q, k, v = (t.to(cuda).requires_grad_() for t in _bsdh_views(
        2, 300, 4, 1, 64, torch.float32))
    bad = _misaligned_dout(what, 2, 4, 300, 64, cuda, seed=3)
    assert flash.layout_error("dout", bad) is not None
    out = ops.flash_attention(q, k, v, window=40)
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = torch.autograd.grad(out, (q, k, v), bad, retain_graph=True)
    exp = torch.autograd.grad(out, (q, k, v), bad.contiguous())
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 2
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["pointer", "seq_stride"])
def test_flash_attention_bwd_kernel_rejects_misaligned_dout(cuda, what):
    """The wrapper itself takes no view that TMA cannot read: it raises,
    naming dout, with no launch."""
    q, k, v = (t.to(cuda) for t in _bsdh_views(2, 300, 4, 1, 64,
                                                torch.float32))
    out, lse = flash.flash_attention_cuda(q, k, v, causal=True, window=None,
                                          scale=None, with_lse=True)
    bad = _misaligned_dout(what, 2, 4, 300, 64, cuda, seed=4)
    before = ops.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="dout"):
        flash.flash_attention_bwd_cuda(q, k, v, out, bad, lse, causal=True,
                                       window=None, scale=None)
    assert ops.LAUNCHES["flash_attention_bwd"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("h,d,cap", [(4, 64, 2 << 20), (4, 64, 1 << 20),
                                     (8, 160, 4 << 20)])
def test_flash_attention_bwd_kernel_slabs(cuda, monkeypatch, h, d, cap):
    """A problem whose dS (2.9 MB at 4 heads, 5.8 MB at 8) passes
    BWD_DS_BYTES runs in slabs (of batches at 2 MiB, of kv heads within a
    batch at 1 MiB; stablelm-12b's D = 160 in a GQA group of 4, of batches
    at 4 MiB) and gives the bits of one launch: each slab runs the same
    kernels on its own heads."""
    q, k, v, dout = _bwd_on_card(cuda, 2, h, 2, 300, d, d, seed=5)
    out, lse = flash.flash_attention_cuda(q, k, v, causal=True, window=None,
                                          scale=None, with_lse=True)
    whole = flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                           causal=True, window=None,
                                           scale=None)
    monkeypatch.setattr(flash, "BWD_DS_BYTES", cap)
    assert len(flash._slabs(2, 2, h // 2, 300, 304)) > 1
    before = ops.LAUNCHES["flash_attention_bwd"]
    sliced = flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                            causal=True, window=None,
                                            scale=None)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    for g, w in zip(sliced, whole):
        assert torch.equal(g, w)


# minicpm3-4b's MLA heads: D = 96 (64 nope + 32 rope), Dv = 64, H = Hk =
# 40; the kernels pad both to their 128-wide head tile
MLA_SHAPE = dict(b=4, s=1024, h=40)


def _mla_views(b, s, h, dtype, device, seed):
    """q, k, v as ``mla_forward`` hands them to the kernel: q and k
    (B, S, H, 96) concatenations, v the second half of a (B, S, H, 128)
    expansion, each viewed as (B, H, S, D)."""
    gen = torch.Generator(device).manual_seed(seed)
    q, k, kvb = (torch.randn(b, s, h, d, generator=gen, device=device)
                 .to(dtype) for d in (96, 96, 128))
    return q.transpose(1, 2), k.transpose(1, 2), kvb[..., 64:].transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_kernel_mla_shape(cuda, dtype, tol):
    q, k, v = _mla_views(**MLA_SHAPE, dtype=dtype, device=cuda, seed=0)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, scale=96 ** -0.5)
    exp = ref.flash_attention_ref(q, k, v, scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == (4, 40, 1024, 64)
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_mla_shape(cuda):
    """The backward at the MLA shape from the forward kernel's output and
    lse, twice bit-equal, then once more through autograd on the model's
    views: dv comes back 64 wide, dq and dk 96."""
    q, k, v = _mla_views(**MLA_SHAPE, dtype=torch.float32, device=cuda,
                         seed=1)
    dout = torch.randn(4, 40, 1024, 64, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(2))
    kw = dict(causal=True, window=None, scale=96 ** -0.5)
    out, lse = flash.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    got = flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    again = flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    exp = ref.flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _assert_grads_close([g.cpu() for g in got], [e.cpu() for e in exp],
                        rel=BWD_TOL)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = ops.LAUNCHES["flash_attention_bwd"]
    auto = torch.autograd.grad(ops.flash_attention(
        *leaves, scale=96 ** -0.5), leaves, dout)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    assert [tuple(g.shape[-1:]) for g in auto] == [(96,), (96,), (64,)]
    _assert_grads_close([g.cpu() for g in auto], [e.cpu() for e in exp],
                        rel=BWD_TOL)


# stablelm-12b's attention: GQA 32 on 8 heads of 160 (5120 / 32), the one
# head width of the repo's archs that is not 64, 96, 128 or 256. The
# forwards run instantiations of their own (bf16: a 192-wide tile, 32
# zero-filled columns; f32: 128-row items, O as 64 + 64 + 32 columns); the
# backward runs its run-time widths, its dK/dV products 192 wide.
STABLELM_SHAPE = (4, 32, 8, 1024, 160)


def _stablelm_qkv(device, dtype, seed):
    b, h, hk, s, d = STABLELM_SHAPE
    gen = torch.Generator(device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_flash_attention_kernel_stablelm_heads(cuda, dtype, tol):
    """The forward at stablelm-12b's prefill shape against its plain
    version, and two launches bit-equal."""
    q, k, v = _stablelm_qkv(cuda, dtype, seed=160)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v)
    again = ops.flash_attention(q, k, v)
    exp = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 2
    assert out.dtype == dtype and out.shape == exp.shape
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_tf32_kernel_lse_stablelm_heads(cuda):
    """The f32 forward at stablelm-12b's shape with its log-sum-exp kept:
    the output the same bits as without it, and lse times ln 2 within 1e-5
    of ``torch.logsumexp`` of the masked, scaled scores."""
    q, k, v = _stablelm_qkv(cuda, torch.float32, seed=161)
    b, h, hk, s, d = STABLELM_SHAPE
    kw = dict(causal=True, window=None, scale=None)
    out, lse = flash.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    alone = flash.flash_attention_cuda(q, k, v, **kw)
    x = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(h // hk, dim=1)) / math.sqrt(d)
    i = torch.arange(s, device=cuda)
    exp = torch.logsumexp(x.masked_fill(i[None, :] > i[:, None], -math.inf),
                          dim=-1)
    torch.cuda.synchronize()
    assert torch.equal(out, alone)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse * math.log(2), exp, atol=1e-5, rtol=0)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_attention_bwd_kernel_stablelm_heads(cuda):
    """The backward at stablelm-12b's train shape from the forward kernel's
    output and lse: within BWD_TOL of the plain version, two launches
    bit-equal, dK and dV summed over each kv head's group of 4."""
    q, k, v = _stablelm_qkv(cuda, torch.float32, seed=162)
    dout = torch.randn(q.shape, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(163))
    kw = dict(causal=True, window=None, scale=None)
    out, lse = flash.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    again = flash.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    exp = ref.flash_attention_bwd_ref(q, k, v, out, dout)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _assert_grads_close([g.cpu() for g in got], [e.cpu() for e in exp],
                        rel=BWD_TOL)
