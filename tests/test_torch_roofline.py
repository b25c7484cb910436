"""``repro_torch.roofline`` against the JAX package's ``repro.roofline``.

Twin of ``test_roofline.py``: exact product FLOPs, a loop counted once per
iteration, a gradient as forward plus two backward products, the keys of
``roofline_terms``. Then the port's step counted on the ``meta`` device
against JAX's count of the jitted step's compiled HLO, float32, B = 2:

  - decode: equal, FLOP for FLOP;
  - prefill: JAX runs ``attn_impl="naive"``, which computes all S x S
    scores, where the flash kernel counts the causal band; with the full
    square, ``2·B·H·S²·(D+Dv)`` a layer, in place of the kernel's count
    the two are equal, but for two einsums that XLA lowers to products and
    the port computes elementwise (0 FLOPs): RWKV6's bonus
    ``bthd,hd,bthd->bth`` (``2·B·S·d_model`` a layer) and Mamba's
    ``u = (dt·x) ⊗ B`` outer product and ``y = Σ_n s·c`` contraction,
    which the port's scan kernel does (``4·B·S·d_inner·d_state`` a layer);
  - train: with the naive attention's forward, its recompute in a stacked
    stage and its four backward products (``(3 + remat)·2·B·H·S²·(D+Dv)``
    a layer) in place of the flash kernels' counts, equal for the attention
    archs when the loss has several chunks. With one loss chunk (``S <=
    loss_chunk``, which the default 1024 gives at S = 1024) JAX counts
    exactly one logits product (``2·B·S·d_model·V``) less: XLA folds the
    one-trip loop's rematerialized logits into the forward's, while
    ``torch.utils.checkpoint`` recomputes them. That is most of the port's
    14.4 % over JAX on rwkv6-1.6b-reduced in one chunk (pinned below, with
    16-token wkv chunks; 12.0 % with JAX's default 64); RWKV6 and Jamba, whose
    mixers are formulated differently (the einsums above, and the port's
    running sum of log decays as a product with a triangle of ones where
    JAX's cumsum counts 0), are pinned at their measured ratios.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import roofline as jroofline
from repro.configs import get_config as jax_get_config
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import roofline
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as port_get_config
from repro_torch.kernels import delta_encode, ops, ref
from repro_torch.kernels import flash_attention as pflash
from repro_torch.kernels import ssm_scan as pssm
from repro_torch.models import transformer as ptf

META = torch.device("meta")
B, S = 2, 64


def _meta(*shape, requires_grad=False):
    return torch.empty(shape, device=META, requires_grad=requires_grad)


def _flops(fn, *args):
    return roofline.count(fn, *args)[1].flops


# -- the counter ---------------------------------------------------------------


def test_matmul_flops_exact():
    assert _flops(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32)) \
        == 2 * 64 * 128 * 32


def _loop(w, x, n=8):
    for _ in range(n):
        x = torch.relu(x @ w)
    return x


def test_loop_counts_every_iteration():
    assert _flops(_loop, _meta(256, 256), _meta(32, 256)) \
        == 8 * 2 * 32 * 256 * 256


def test_grad_of_loop_counts_backward():
    w = _meta(256, 256, requires_grad=True)
    x = _meta(32, 256, requires_grad=True)

    def grad(w, x):
        return torch.autograd.grad(_loop(w, x).sum(), (w, x))
    assert _flops(grad, w, x) == 3 * 8 * 2 * 32 * 256 * 256  # fwd + 2 bwd


def test_roofline_terms_shape():
    _, cost = roofline.count(lambda a, b: a @ b, _meta(64, 64), _meta(64, 64))
    t = roofline.roofline_terms(cost, dtype=torch.float32,
                                model_flops_per_chip=1e6)
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "step_s_lower_bound", "roofline_fraction", "useful_flops_ratio",
              "model_flops_per_chip", "counted_flops_per_chip",
              "counted_bytes_per_chip", "min_bytes_per_chip",
              "kernel_flops_share", "coll_wire_bytes_per_chip",
              "coll_operand_bytes_per_chip", "coll_counts"):
        assert k in t
    assert t["counted_flops_per_chip"] == 2 * 64 ** 3
    # a @ b reads two 16 KiB operands and writes one
    assert t["counted_bytes_per_chip"] == 3 * 64 * 64 * 4
    assert t["compute_s"] == 2 * 64 ** 3 / roofline.PEAK_FLOPS["float32"]
    assert t["dominant"] == "memory" and t["collective_s"] == 0.0


def test_bytes_skip_views_and_count_slice_writes():
    """A view moves nothing; an in-place write of a cache slice moves twice
    the slice (the JAX module's in-place dynamic-update-slice); a gather
    twice its rows, not the table; an indexed write in place twice its
    rows (the JAX module's in-place scatter)."""
    cache, new = _meta(2, 64, 8), _meta(2, 1, 8)
    table, idx = _meta(1000, 16), torch.empty((2, 3), dtype=torch.int64,
                                              device=META)
    rows = torch.empty(6, dtype=torch.int64, device=META)

    def step(cache, new, table, idx, rows):
        cache.transpose(0, 1)
        cache[:, 5:6] = new
        table.index_copy_(0, rows, _meta(6, 16))
        return table[idx]
    _, cost = roofline.count(step, cache, new, table, idx, rows)
    assert cost.rows["aten.copy_"][2] == 2 * new.numel() * 4
    assert cost.rows["aten.index"][2] == 2 * 2 * 3 * 16 * 4
    assert cost.rows["aten.index_copy_"][2] == 2 * 6 * 16 * 4
    assert "aten.transpose" not in cost.rows
    assert cost.bytes == 2 * new.numel() * 4 + 2 * 2 * 3 * 16 * 4 \
        + 2 * 6 * 16 * 4


def test_model_flops_match_jax():
    for kind in ("train", "prefill", "decode"):
        assert roofline.model_flops(123_456, kind, 789) \
            == jroofline.model_flops(123_456, kind, 789)


# -- the kernels on meta -------------------------------------------------------


def test_meta_ops_count_work_and_launch_nothing(monkeypatch):
    """On meta each op returns empty outputs of the card's shapes and
    dtypes, records its kernel's work, runs no plain version and counts no
    launch; a device with no implementation still raises."""
    for name in ("flash_attention_ref", "flash_attention_bwd_ref",
                 "ssm_scan_ref", "ssm_scan_bwd_ref", "delta_mask_ref"):
        monkeypatch.setattr(ref, name, _raise)
    launches = dict(ops.LAUNCHES)
    q = _meta(2, 4, 48, 32, requires_grad=True)
    k = _meta(2, 2, 48, 32, requires_grad=True)
    v = _meta(2, 2, 48, 16, requires_grad=True)
    decay, u = (_meta(2, 40, 6, 4, requires_grad=True) for _ in range(2))
    c, s0 = _meta(2, 40, 4, requires_grad=True), _meta(2, 6, 4)
    new = torch.empty(4096, dtype=torch.uint8, device=META)
    with ops.record_work() as rows:
        out = ops.flash_attention(q, k, v, window=16)
        y, final = ops.ssm_scan(decay, u, c, s0)
        grads = torch.autograd.grad((out.sum() + y.sum()),
                                    (q, k, v, decay, u, c))
        mask = ops.delta_mask(new, new, block=256, bpt=4)
    assert ops.LAUNCHES == launches
    assert out.shape == (2, 4, 48, 16) and out.stride()[1] == 16
    assert y.shape == (2, 40, 6) and final.shape == (2, 6, 4)
    assert [g.shape for g in grads] == [t.shape for t in (q, k, v, decay, u,
                                                         c)]
    assert mask.shape == (16,) and mask.dtype == torch.int8
    assert rows == [
        ("flash_attention", *pflash.work(2, 4, 2, 48, 32, 16, 16, 4)),
        ("ssm_scan", *pssm.work(2, 40, 6, 4)),
        ("ssm_scan_bwd", *pssm.bwd_work(2, 40, 6, 4)),
        ("flash_attention_bwd", *pflash.bwd_work(2, 4, 2, 48, 32, 16, 16)),
        ("delta_mask", *delta_encode.work(4096, 256))]
    with pytest.raises(ValueError, match="no implementation"):
        ops._route(SimpleNamespace(device=torch.device("xpu")), "x")


def _raise(*args, **kwargs):
    raise AssertionError("a plain version ran on meta")


def _bound_ms(work, dtype="float32"):
    flops, nbytes = work
    return max(flops / roofline.PEAK_FLOPS[dtype],
               nbytes / roofline.HBM_BW) * 1e3


@pytest.mark.parametrize("case,bound", [
    ((4, 4, 1, 1024, 256, 256, 512, "float32"), 0.0391),  # gemma3-1b local
    ((4, 40, 40, 1024, 96, 64, None, "float32"), 0.1629),  # minicpm3 MLA
    ((4, 32, 32, 1088, 64, 64, None, "float32"), 0.1177),  # musicgen-large
    ((4, 12, 2, 1280, 128, 128, None, "float32"), 0.1222),  # qwen2-vl-2b
    ((4, 64, 8, 1024, 128, 128, None, "bfloat16"), 0.0696),  # Jamba
    ((4, 40, 40, 1024, 96, 64, None, "bfloat16"), 0.0313)])  # MLA bf16
def test_flash_work_gives_the_chip_bounds(case, bound):
    """The forward's bound at ``chip_smoke.py``'s shapes, as the kernel
    table records it (ms at the H100 SXM's rates)."""
    *shape, dtype = case
    itemsize = 4 if dtype == "float32" else 2
    assert round(_bound_ms(pflash.work(*shape, itemsize), dtype), 4) == bound


@pytest.mark.parametrize("case,bound", [
    ((4, 4, 1, 1024, 256, 256, 512), 0.0977),
    ((4, 4, 1, 1024, 256, 256, None), 0.1304),
    ((4, 40, 40, 1024, 96, 64, None), 0.4237),
    ((4, 32, 32, 1088, 64, 64, None), 0.2943),
    ((4, 12, 2, 1280, 128, 128, None), 0.3055)])
def test_flash_bwd_work_gives_the_chip_bounds(case, bound):
    assert round(_bound_ms(pflash.bwd_work(*case)), 4) == bound


def test_scan_and_delta_work_give_the_chip_bounds():
    assert round(_bound_ms(pssm.work(4, 1024, 16384, 16)), 4) == 2.6469
    assert round(_bound_ms(pssm.bwd_work(4, 1024, 16384, 16)), 4) == 5.2111
    assert round(_bound_ms(delta_encode.work(256 << 20, 1 << 16)), 4) \
        == 0.1603


def test_padded_head_work():
    """MLA's D = 96, Dv = 64: the f32 forward runs Q K^T 96 deep and P V 64
    wide, so all of its work is real (D = 40, Dv = 24: 40 and 32, 64 of 72);
    the backward runs S 96 deep, dP 64 deep, dV^T 64 rows, dQ 96 wide and
    dK^T 128 rows, so 416 of 448 (92.9 %)."""
    flops, _ = pflash.work(4, 40, 40, 1024, 96, 64, None, 4)
    assert pflash.head_tile(96, 64) == 128 and pflash.head_tile(64, 64) == 64
    assert pflash.padded_flops(flops, 96, 64) == flops
    assert pflash.padded_flops(flops, 40, 24) == pytest.approx(
        flops * 72 / 64, rel=1e-12)
    bflops, _ = pflash.bwd_work(4, 40, 40, 1024, 96, 64, None)
    assert pflash.bwd_product_widths(96, 64) == (96, 64, 64, 96, 128)
    assert pflash.padded_flops(bflops, 96, 64, backward=True) \
        == pytest.approx(bflops * 448 / 416, rel=1e-12)


# -- whole steps against the JAX package's HLO count ---------------------------


def _jax_flops(fn, *args):
    return jroofline.entry_cost(jax.jit(fn).lower(*args).compile()
                                .as_text()).flops


def _jax_rc(**kw):
    return jtf.RunConfig(attn_impl="naive", param_dtype=jnp.float32,
                         cache_dtype=jnp.float32, **kw)


def _port_rc(**kw):
    return ptf.RunConfig(param_dtype=torch.float32,
                         cache_dtype=torch.float32, **kw)


def _specs(jcfg, jrc):
    return jax.eval_shape(lambda k: jtf.init_params(jcfg, k, jrc),
                          jax.random.key(0))


def _sds(*shape, dtype=jnp.int32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _attn_square(cfg, rows, per_layer=lambda stage: 1):
    """Sum over attention layers of ``per_layer(stage)`` times
    2·B·H·rows²·(D+Dv): the naive attention's two products over every
    score."""
    total = 0
    for stage in cfg.stages:
        for spec in stage.block:
            if spec.kind != "attn":
                continue
            a = spec.attn
            d, dv = ((a.mla.qk_nope_dim + a.mla.qk_rope_dim,
                      a.mla.v_head_dim) if a.mla else (a.head_dim,) * 2)
            total += stage.repeat * per_layer(stage) * 2 * B * a.n_heads \
                * rows * rows * (d + dv)
    return total


def _mixer_einsums(cfg, rows):
    """FLOPs of the einsums JAX lowers to products and the port computes
    elementwise: RWKV6's bonus, Mamba's outer product and contraction."""
    total = 0
    for spec in cfg.layer_specs():
        if spec.kind == "rwkv":
            total += 2 * B * rows * cfg.d_model
        elif spec.kind == "mamba":
            total += 4 * B * rows * spec.mamba.d_inner(cfg.d_model) \
                * spec.mamba.d_state
    return total


DECODE_ARCHS = ["gemma3-1b-reduced", "deepseek-moe-16b-reduced",
                "minicpm3-4b-reduced", "jamba-1.5-large-398b-reduced",
                "rwkv6-1.6b-reduced"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_flops_equal_jax(arch):
    """One decode step against a 64-position cache, B = 2, f32: the port's
    count equals the HLO count of JAX's jitted ``decode_step`` exactly,
    with JAX's two einsums over the whole cache, ``4·B·H·S·D`` a GQA
    layer, in place of the decode kernel's count, which is that at the
    cache's last position but for a sliding window's layers (gemma3's
    local ones), where it reads the window's rows alone. The kernel is
    the only one on the path, once a GQA layer; MLA and RWKV decode launch
    none."""
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    jrc = _jax_rc()
    want = _jax_flops(
        lambda p, t, q, c: jtf.decode_step(jcfg, jrc, p, t, q, c),
        _specs(jcfg, jrc), _sds(B, 1), _sds(),
        jax.eval_shape(lambda: jtf.init_cache(jcfg, B, S, jrc)))
    cost = roofline.step_cost(pcfg, _port_rc(), "decode", B, S)
    gqa = [spec.attn for spec in pcfg.layer_specs()
           if spec.kind == "attn" and spec.attn.mla is None]
    full = sum(4 * B * a.n_heads * S * a.head_dim for a in gqa)
    assert cost.flops - cost.kernel_flops + full == want
    n_gqa = len(gqa)
    kernels = {name: row for name, row in cost.rows.items()
               if name.startswith("kernel:")}
    assert {name: row[0] for name, row in kernels.items()} \
        == ({"kernel:decode_attention": n_gqa} if n_gqa else {})
    assert cost.kernel_flops == sum(row[1] for row in kernels.values())


@pytest.mark.parametrize("arch", DECODE_ARCHS + ["qwen2-vl-2b-reduced"])
def test_prefill_flops_equal_jax_naive(arch):
    """Prefill of S = 64 rows (after the front end's where the arch has
    one): the port's FLOPs outside the kernels, plus the naive attention's
    full square and the mixers' einsums (module docstring), equal JAX's
    ``attn_impl="naive"`` count; rwkv6-reduced's whole count is 0.16 %
    below JAX's with 16-token wkv chunks (0.14 % with 64), its bonus
    einsum."""
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    jrc, nf = _jax_rc(rwkv_chunk=16), jcfg.n_frontend
    front = _sds(B, nf, jcfg.d_model, dtype=jnp.float32) if nf else None
    want = _jax_flops(
        lambda p, t, c, f: jtf.prefill(jcfg, jrc, p, t, c, frontend=f),
        _specs(jcfg, jrc), _sds(B, S),
        jax.eval_shape(lambda: jtf.init_cache(jcfg, B, S + nf, jrc)), front)
    cost = roofline.step_cost(pcfg, _port_rc(rwkv_chunk=16), "prefill", B, S,
                              frontend_rows=nf)
    assert cost.flops - cost.kernel_flops + _attn_square(pcfg, S + nf) \
        + _mixer_einsums(pcfg, S + nf) == want
    if arch == "rwkv6-1.6b-reduced":
        assert cost.flops / want == pytest.approx(10223616 / 10240000,
                                                  abs=1e-9)


def _jax_train_flops(jcfg, jrc, nf=0):
    params = _specs(jcfg, jrc)
    batch = {"tokens": _sds(B, S), "labels": _sds(B, S)}
    if nf:
        batch["frontend_embeds"] = _sds(B, nf, jcfg.d_model,
                                        dtype=jnp.float32)
    return _jax_flops(jtrain.make_train_step(jcfg, jrc, jadamw.AdamWConfig()),
                      params, jax.eval_shape(jadamw.adamw_init, params),
                      batch)


def _stacked(cfg, repeat):
    st = list(cfg.stages)
    st[0] = dataclasses.replace(st[0], repeat=repeat)
    return dataclasses.replace(cfg, stages=tuple(st))


@pytest.mark.parametrize("arch,repeat", [
    ("gemma3-1b-reduced", 1), ("gemma3-1b-reduced", 2),
    ("deepseek-moe-16b-reduced", 1), ("minicpm3-4b-reduced", 1),
    ("qwen2-vl-2b-reduced", 1)])
def test_train_flops_equal_jax_naive(arch, repeat):
    """A train step (loss in four 16-token chunks, backward, AdamW): the
    port's FLOPs outside the kernels plus the naive attention's forward,
    its recompute in a stacked stage and its four backward products equal
    JAX's count. ``repeat`` stacks the first stage, which both recompute
    in the backward."""
    jcfg = _stacked(jax_get_config(arch), repeat)
    pcfg = _stacked(port_get_config(arch), repeat)
    nf = jcfg.n_frontend
    want = _jax_train_flops(jcfg, _jax_rc(loss_chunk=16), nf)
    cost = roofline.step_cost(pcfg, _port_rc(loss_chunk=16), "train", B, S,
                              frontend_rows=nf)
    square = _attn_square(pcfg, S + nf,
                          lambda stage: 3 + (stage.repeat > 1))
    assert cost.flops - cost.kernel_flops + square == want


@pytest.mark.parametrize("arch,ratio_one,ratio_four", [
    ("rwkv6-1.6b-reduced", 63471616 / 55476224, 63471616 / 63864832),
    ("deepseek-moe-16b-reduced", 92618752 / 89358336, 92618752 / 97746944),
    ("jamba-1.5-large-398b-reduced", None, None)])
def test_train_flops_one_loss_chunk(arch, ratio_one, ratio_four):
    """With the loss in one chunk (S = loss_chunk = 64) JAX counts exactly
    one logits product less than with four 16-token chunks; the port
    counts the same either way (it recomputes the chunk's logits in the
    backward). Port over JAX, pinned: rwkv6 +14.4 % in one chunk (-0.6 %
    in four: the wkv chunk's formulation), deepseek-moe +3.6 % (-5.2 %:
    the flash band against the naive square). Jamba's Mamba layers are
    pinned in four chunks only."""
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    logits = 2 * B * S * pcfg.d_model * ptf.padded_vocab(pcfg.vocab_size)
    one = _jax_train_flops(jcfg, _jax_rc(loss_chunk=64, rwkv_chunk=16))
    four = _jax_train_flops(jcfg, _jax_rc(loss_chunk=16, rwkv_chunk=16))
    assert four - one == logits
    port = roofline.step_cost(pcfg, _port_rc(loss_chunk=64, rwkv_chunk=16),
                              "train", B, S).flops
    assert roofline.step_cost(pcfg, _port_rc(loss_chunk=16, rwkv_chunk=16),
                              "train", B, S).flops == port
    if ratio_one is None:  # Jamba: 290906112 / 409075712
        assert port / four == pytest.approx(290906112 / 409075712,
                                            abs=1e-9)
        return
    assert port / one == pytest.approx(ratio_one, abs=1e-9)
    assert port / four == pytest.approx(ratio_four, abs=1e-9)


def test_step_cost_counts_the_kernels_on_their_paths():
    """Jamba's reduced train step: every attention and Mamba layer's kernel
    and its backward, recorded by name, launch nothing; ``min_bytes``
    holds the parameters, both AdamW moments and the batch."""
    cfg = port_get_config("jamba-1.5-large-398b-reduced")
    launches = dict(ops.LAUNCHES)
    cost = roofline.step_cost(cfg, _port_rc(loss_chunk=16), "train", B, S)
    assert ops.LAUNCHES == launches
    n_attn = sum(s.kind == "attn" for s in cfg.layer_specs())
    n_mamba = sum(s.kind == "mamba" for s in cfg.layer_specs())
    assert cost.rows["kernel:flash_attention"][0] == n_attn
    assert cost.rows["kernel:flash_attention_bwd"][0] == n_attn
    assert cost.rows["kernel:ssm_scan"][0] == n_mamba
    assert cost.rows["kernel:ssm_scan_bwd"][0] == n_mamba
    n = ptf.count_params(cfg)
    assert 3 * 4 * n < cost.min_bytes < 3 * 4 * n + 4096
    names = [name for name, _ in roofline.cost_breakdown(cost, top_k=5)]
    assert len(names) == 5 and all(isinstance(x, str) for x in names)


# -- parameter counts ----------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_match_jax(arch):
    """``count_params`` and ``count_active_params`` equal the JAX
    package's for every architecture at its full size (counted on meta)."""
    from repro_torch.models import count_active_params, count_params
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    assert count_params(pcfg) == jtf.count_params(jcfg)
    assert count_active_params(pcfg) == jtf.count_active_params(jcfg)


def test_models_public_api():
    import repro.models as jmodels
    import repro_torch.models as pmodels
    assert pmodels.__all__ == jmodels.__all__
    from repro_torch.models import (Model, RunConfig, count_active_params,
                                    count_params, init_cache, init_params)
    assert (Model, RunConfig, init_params, init_cache) == (
        ptf.Model, ptf.RunConfig, ptf.init_params, ptf.init_cache)
    assert count_params(port_get_config("gemma3-1b")) == 999_812_736
    assert count_active_params is ptf.count_active_params
