"""The GQA decode-attention kernel (``kernels/decode_attention.py``,
``csrc/decode_attention.cu``) and its plain version
(``ref.decode_attention_ref``).

On the CPU ``ops.decode_attention`` runs the plain version, bit for bit;
the wrapper's checks raise before anything is built; the source has an
instantiation for every head dim the models run; on meta the op records
the kernel's work. The ``cuda`` tests hold the kernel against the plain
version on the card and need no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_decode_attention.py
"""
import re

import pytest
import torch

from repro_torch import roofline
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MLPSpec, Stage)
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as dattn
from repro_torch.models import attention as pattn
from repro_torch.models import transformer as tf
from repro_torch.weights import tree_map

SOURCE = _build.CSRC / "decode_attention.cu"


def _inputs(b, s, h, hk, d, dtype, seed, device="cpu", q_dtype=None):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=gen)
    k, v = (torch.randn((b, s, hk, d), generator=gen) for _ in range(2))
    return (q.to(device, q_dtype or dtype), k.to(device, dtype),
            v.to(device, dtype))


def _positions(b, s, device="cpu"):
    """Every row's own position: the first, the last and between."""
    pos = [0, s - 1, s // 2, 1, s - 2, s // 3][:b]
    return torch.tensor(pos + [s - 1] * (b - len(pos)), dtype=torch.int64,
                        device=device)


# -- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("h,hk,d,window", [(4, 1, 16, None), (4, 2, 32, 5),
                                           (6, 6, 64, None), (8, 1, 16, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_decode_attention_cpu_is_the_plain_version(h, hk, d, window,
                                                       dtype):
    q, k, v = _inputs(4, 24, h, hk, d, dtype, seed=h + d)
    pos = _positions(4, 24)
    got = ops.decode_attention(q, k, v, cur_pos=pos, window=window)
    want = ref.decode_attention_ref(q, k, v, cur_pos=pos, window=window)
    assert got.dtype == dtype and got.shape == (4, 1, h, d)
    assert torch.equal(got, want)
    # and the model's function is the op
    assert torch.equal(pattn.decode_attention(q, k, v, cur_pos=pos,
                                              window=window), want)


def test_plain_version_weighs_only_live_rows():
    """Rows past cur_pos, or outside the window, weigh exactly 0: their
    values do not reach the output."""
    q, k, v = _inputs(3, 16, 4, 2, 16, torch.float32, seed=7)
    pos = torch.tensor([0, 9, 15])
    want = ref.decode_attention_ref(q, k, v, cur_pos=pos, window=4)
    k2, v2 = k.clone(), v.clone()
    for row, p in enumerate(pos.tolist()):
        dead = [i for i in range(16) if i > p or p - i >= 4]
        k2[row, dead] = 1e3
        v2[row, dead] = -1e3
    assert torch.equal(ref.decode_attention_ref(q, k2, v2, cur_pos=pos,
                                                window=4), want)


@pytest.fixture()
def no_build(monkeypatch):
    """A build or load of any kernel fails the test."""
    def fail(*args, **kwargs):
        raise AssertionError("a kernel was built or loaded")
    monkeypatch.setattr(_build, "build", fail)
    monkeypatch.setattr(_build, "load", fail)


@pytest.mark.parametrize("case", ["head_dim", "dtypes", "last_dim",
                                  "cur_pos_shape", "cur_pos_dtype", "shape",
                                  "window", "device"])
def test_wrapper_checks_raise_before_any_build(no_build, case):
    q, k, v = _inputs(2, 16, 4, 2, 64, torch.bfloat16, seed=1)
    pos = _positions(2, 16)
    if case == "head_dim":
        q, k, v = _inputs(2, 16, 4, 2, 48, torch.bfloat16, seed=1)
        match = "head dims"
    elif case == "dtypes":
        v = v.float()
        match = "one dtype"
    elif case == "last_dim":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
        match = "contiguous last dim"
    elif case == "cur_pos_shape":
        pos = pos[:, None]
        match = "cur_pos"
    elif case == "cur_pos_dtype":
        pos = pos.int()
        match = "int64"
    elif case == "shape":
        q = q[:, :, :3]
        match = "against"
    elif case == "window":
        match = "window"
    else:
        match = "on the card"
    with pytest.raises(ValueError, match=match):
        dattn.decode_attention_cuda(q, k, v, cur_pos=pos,
                                    window=0 if case == "window" else None)


def test_decode_attention_cu_has_an_instantiation_for_every_head_dim():
    """Each head dim the models run (64 musicgen; 128 mistral, phi3.5,
    qwen, deepseek, Jamba; 160 stablelm; 256 gemma3) and the reduced
    configurations' 16 and 32 reach an instantiation of their own in each
    cache dtype, for each head group (1, 4 or 8 query heads a block);
    nothing runs on tensor cores."""
    src = SOURCE.read_text()
    dims = re.findall(r"if \(D == (\d+)\) return launch_groups<KT, (\d+)>",
                      src)
    assert [int(a) for a, b in dims] == list(dattn.HEAD_DIMS)
    assert all(a == b for a, b in dims)
    for gt in (1, 4, 8):
        assert f"return launch<KT, D, L, {gt}>(p, stream);" in src
    assert "launch_dims<__nv_bfloat16>(p, a->D, gt, st)" in src
    assert "launch_dims<float>(p, a->D, gt, st)" in src
    for gone in ("wgmma.mma_async", "mma.sync", "nvcuda::wmma"):
        assert gone not in src
    assert "Replaces no TPU kernel" in src
    assert "cp.async.cg.shared.global" in src
    # the head groups of the C entry are the wrapper's
    assert "return g <= 1 ? 1 : g <= 4 ? 4 : 8;" in src
    assert [dattn.head_group(g) for g in (1, 2, 3, 4, 6, 8, 12)] \
        == [1, 4, 4, 4, 8, 8, 8]
    assert f"sizeof(DecodeArgs) == {dattn._ARGS.size}" in src


def test_split_count_fills_the_card():
    """The chat shape (48 rows, 8 kv heads of 4 query heads) fills 132 SMs
    twice with one split; one row of a 32k cache splits into pieces of at
    least MIN_SPLIT_ROWS rows until the blocks do."""
    assert dattn.split_count(48 * 8, 1152, 132) == 1
    n = dattn.split_count(8, 32768, 132)
    assert n == 33 and 32768 // n >= dattn.MIN_SPLIT_ROWS
    assert dattn.split_count(8, 300, 132) == 1
    assert dattn.split_count(4 * 8, 1152, 132) == 4


def test_work_gives_the_chat_bound():
    """At the chat shape (bf16, B=48, H=32, Hk=8, D=128, 1,089 live rows)
    the bytes bound: 214.9 MB, 0.0641 ms at 3.35 TB/s."""
    flops, nbytes = dattn.work(48, 32, 8, 1089, 128, None, 2)
    assert nbytes == 2 * 2 * 48 * 8 * 1089 * 128 + 2 * 2 * 48 * 32 * 128 \
        + 8 * 48
    assert flops == 4 * 48 * 32 * 1089 * 128
    assert round(nbytes / roofline.HBM_BW * 1e3, 4) == 0.0641
    assert dattn.work(1, 4, 1, 1024, 256, 512, 4)[0] == 4 * 4 * 512 * 256


def test_meta_records_the_kernel_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(ref, "decode_attention_ref", _no_plain)
    launches = dict(ops.LAUNCHES)
    q = torch.empty((3, 1, 8, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((3, 100, 2, 128), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((3,), dtype=torch.int64, device="meta")
    with ops.record_work() as rows:
        out = ops.decode_attention(q, k, k, cur_pos=pos, window=64)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert rows == [("decode_attention",
                     *dattn.work(3, 8, 2, 100, 128, 64, 2, 2))]
    assert ops.LAUNCHES == launches


def _no_plain(*args, **kwargs):
    raise AssertionError("the plain version ran on meta")


def _tiny_cfg(layers=2):
    attn = AttnSpec(n_heads=8, n_kv_heads=2, head_dim=16, rope=True,
                    rope_theta=1e4)
    spec = LayerSpec(kind="attn", attn=attn,
                     mlp=MLPSpec(kind="dense", d_ff=96, act="swiglu"))
    return ArchConfig(name="tiny-gqa", family="dense", d_model=64,
                      vocab_size=256,
                      stages=(Stage(block=(spec,), repeat=layers),))


def _decode_once(device):
    """One decode step of a two-layer GQA model (4 query heads a kv head)
    at position 5 of an 8-row cache, f32, weights drawn on the CPU; its
    logits."""
    cfg = _tiny_cfg()
    rc = tf.RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.to(device),
                      tf.init_params(cfg, gen, rc, device="cpu"))
    caches = tf.init_cache(cfg, 2, 8, rc, device)
    tokens = torch.tensor([[3], [7]], device=device)
    logits, _ = tf.decode_step(cfg, params, tokens, 5, caches, rc)
    return logits


def test_model_decode_reaches_the_op(monkeypatch):
    """Each attention layer of a decode step calls the op once (here its
    plain version)."""
    calls = []
    plain = ref.decode_attention_ref

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)
    monkeypatch.setattr(ref, "decode_attention_ref", counted)
    logits = _decode_once(torch.device("cpu"))
    assert calls == [(2, 1, 8, 16)] * 2 and torch.isfinite(logits).all()


# -- on the card: the kernel against its plain version ------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(out, q, k, v, pos, window):
    """The kernel's output against the plain version's in f32. Both sum
    f32 products of the same values: only the order of the sums differs
    (and the kernel's exponents are base 2 of the scaled scores), a few
    f32 ulps, so 1e-5. A bf16 output is the f32 result rounded once,
    within half a bf16 ulp (2^-9 relative) of the plain f32 result, so
    rtol 2^-8."""
    want = ref.decode_attention_ref(q.float(), k, v, cur_pos=pos,
                                    window=window)
    tol = 2 ** -8 if out.dtype == torch.bfloat16 else 1e-5
    assert out.shape == q.shape and out.dtype == q.dtype
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4, 6, 8])
@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_kernel_matches_plain(cuda, d, g, dtype, window):
    b, s, hk = 6, 300, 2
    q, k, v = _inputs(b, s, g * hk, hk, d, dtype, seed=d + g, device=cuda)
    pos = _positions(b, s, cuda)
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, cur_pos=pos, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    _check(out, q, k, v, pos, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window,pos", [(1000, None, [999, 10]),
                                          (4000, 600, [3999, 10]),
                                          (8192, None, [8191])])
def test_kernel_splits_match_plain(cuda, dtype, s, window, pos):
    """Rows the wrapper splits (a few rows on 2 or 8 kv heads do not fill
    the card), merged by the second kernel; a row with fewer live rows
    than the splits' tiles leaves splits empty."""
    b, hk, g, d = len(pos), 2 if len(pos) > 1 else 8, 4, 128
    q, k, v = _inputs(b, s, g * hk, hk, d, dtype, seed=s, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert dattn.split_count(b * hk, dattn.live_rows(s, window), sms) > 1
    pos = torch.tensor(pos, device=cuda)
    out = ops.decode_attention(q, k, v, cur_pos=pos, window=window)
    torch.cuda.synchronize()
    _check(out, q, k, v, pos, window)


@pytest.mark.cuda
def test_kernel_views_and_mixed_dtypes(cuda):
    """Caches that are views of a wider one (a batch stride of more rows,
    the model's layout), f32 q against a bf16 cache, and a row whose
    position lies past the cache (all rows live, as in the plain
    version)."""
    b, s, hk, d = 3, 200, 2, 128
    q, k, v = _inputs(b, 256, 8, hk, d, torch.bfloat16, seed=5, device=cuda,
                      q_dtype=torch.float32)
    k, v = k[:, :s], v[:, :s]
    pos = torch.tensor([17, s - 1, s + 40], device=cuda)
    out = ops.decode_attention(q, k, v, cur_pos=pos)
    torch.cuda.synchronize()
    _check(out, q, k, v, pos, None)


@pytest.mark.cuda
def test_model_decode_launches_once_a_layer(cuda):
    """A two-layer GQA model's decode step launches the kernel once per
    attention layer, and its logits are the CPU's within f32 sums."""
    before = ops.LAUNCHES["decode_attention"]
    logits = _decode_once(cuda)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 2
    torch.testing.assert_close(logits.cpu(), _decode_once(
        torch.device("cpu")), rtol=1e-4, atol=1e-4)
