"""The modality front ends (qwen2-vl-2b's patch embeddings, musicgen-large's
conditioning embeddings and sinusoidal positions), the train driver's batch
casts, and ``repro_torch.optim.compress`` against the JAX package.

Inputs come from a seed with numpy; the JAX parameters are carried into
the port with ``repro_torch.weights.params_from_jax``. Everything runs on
the CPU. The whole-model parity of both front-end archs (prefill, decode,
loss, gradients) runs in the parametrised tests of ``test_torch_models.py``
and ``test_torch_train.py``, their serve failover in ``test_torch_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import TokenPipeline
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import compress as jcompress
from repro_torch.configs import get_config as port_get_config
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptf
from repro_torch.optim import compress as pcompress
from repro_torch.weights import leaf_to_tensor, params_from_jax, tree_map

CPU = torch.device("cpu")
ARCHS = ["qwen2-vl-2b-reduced", "musicgen-large-reduced"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("dim", [64, 2048])
def test_sinusoidal_pos_emb(dim):
    """Positions 0..1400, which the serve and train runs reach (musicgen-
    large serves 64 + 1024 + 32 = 1120 positions). The frequencies' exp
    arguments are bit-equal; XLA's f32 ``exp`` and torch's differ by one
    ulp on some frequencies (102 of 1024 at dim 2048), so the angles
    differ by at most pos * 2^-24 plus one ulp of the angle after its
    rounding (2^-13 below 2048): 1400 * 2^-24 + 2^-13 = 2.05e-4. Measured:
    3.8e-06 at dim 64, 1.2207e-04 at dim 2048."""
    pos = np.arange(1401)[None]
    got = players.sinusoidal_pos_emb(torch.from_numpy(pos), dim)
    exp = np.asarray(jlayers.sinusoidal_pos_emb(jnp.asarray(pos), dim))
    assert got.shape == (1, 1401, dim) and got.dtype == torch.float32
    bound = 1400 * 2.0 ** -24 + 2.0 ** -13
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=bound)
    # position 0 is [0 | 1] exactly in both
    np.testing.assert_array_equal(got[0, 0].numpy(), exp[0, 0])


@pytest.mark.parametrize("name", ["silu", "gelu", "relu2"])
def test_act_fn(name):
    """Within 1e-6 (f32; gelu is the tanh approximation in both)."""
    x = (np.random.default_rng(0).standard_normal((4, 100)) * 3).astype(
        np.float32)
    got = players.act_fn(name)(torch.from_numpy(x))
    exp = jlayers.act_fn(name)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                               atol=1e-6)


def _model_inputs(arch, small_rc, seed, b=2, s=10):
    """JAX and port parameters of ``arch``, tokens and random front-end
    embeddings (std 1, so that a dropped or misplaced front end shows)."""
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    jparams = jtf.init_params(jcfg, jax.random.key(seed), small_rc)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (b, s), dtype=np.int32)
    front = rng.standard_normal((b, jcfg.n_frontend, jcfg.d_model)).astype(
        np.float32)
    return (jcfg, pcfg, jparams, params_from_jax(_np_tree(jparams), CPU),
            toks, front)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_with_frontend(arch, small_rc):
    """``_embed``: the front end's rows first, then the token rows (qwen2-
    vl: bit-equal to the inputs); musicgen adds sinusoidal positions over
    all Nf + S rows, within 1e-6 (dim 64, positions < 14)."""
    jcfg, pcfg, jparams, params, toks, front = _model_inputs(arch, small_rc,
                                                             1)
    nf, s = jcfg.n_frontend, toks.shape[1]
    positions = np.arange(nf + s)[None]
    exp = np.asarray(jtf._embed(jcfg, jparams, jnp.asarray(toks),
                                jnp.asarray(front), jnp.asarray(positions)))
    got = ptf._embed(pcfg, params, torch.from_numpy(toks).long(),
                     torch.from_numpy(front), torch.from_numpy(positions))
    assert got.shape == exp.shape == (2, nf + s, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-6)
    if jcfg.pos_emb == "sinusoidal":
        pe = players.sinusoidal_pos_emb(torch.from_numpy(positions),
                                        jcfg.d_model)
        torch.testing.assert_close(got[:, :nf],
                                   torch.from_numpy(front) + pe[:, :nf],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got[:, nf:],
                                   params["embed"][toks] + pe[:, nf:],
                                   rtol=0, atol=0)
    else:
        assert torch.equal(got[:, :nf], torch.from_numpy(front))
        assert torch.equal(got[:, nf:], params["embed"][toks])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_embeds_at_the_position_after_the_frontend(arch, small_rc):
    """Prefill of Nf + S rows, then one decode step at position Nf + S,
    against the same Nf + S + 1 rows prefilled at once: the last logits
    agree within 1e-4 (f32). A decode step at S instead of Nf + S would
    rotate (qwen2-vl) or embed (musicgen) at the wrong position."""
    jcfg, pcfg, jparams, params, toks, front = _model_inputs(arch, small_rc,
                                                             2)
    nf, s = jcfg.n_frontend, toks.shape[1] - 1
    rc = ptf.RunConfig(param_dtype=torch.float32, cache_dtype=torch.float32)
    model = ptf.Model(pcfg, rc, device=CPU)
    t = torch.from_numpy(toks).long()
    f = torch.from_numpy(front)
    caches = model.init_cache(2, nf + s + 1)
    _, caches = model.prefill(params, t[:, :s], caches, f)
    got, _ = model.decode_step(params, t[:, s:], nf + s, caches)
    whole, _ = model.prefill(params, t, model.init_cache(2, nf + s + 1), f)
    torch.testing.assert_close(got, whole, rtol=1e-4, atol=1e-4)
    wrong, _ = model.decode_step(params, t[:, s:], s, caches)
    assert (wrong - whole).abs().max() > 1e-3


def test_serve_driver_decodes_after_the_frontend(monkeypatch, tmp_path):
    """The serve driver sizes the caches for Nf + prompt + gen positions,
    prefills the stub front end (drawn after the prompts from the seed's
    generator, in the weights' dtype) and decodes from Nf + prompt_len."""
    seen = {}
    real_prefill, real_decode = ptf.Model.prefill, ptf.Model.decode_step

    def prefill(self, params, tokens, caches, frontend=None):
        seen["frontend"] = frontend
        seen["max_len"] = caches[0]["L0"]["k"].shape[1]
        return real_prefill(self, params, tokens, caches, frontend)

    def decode_step(self, params, tokens, pos, caches):
        seen.setdefault("pos", []).append(pos)
        return real_decode(self, params, tokens, pos, caches)

    monkeypatch.setattr(ptf.Model, "prefill", prefill)
    monkeypatch.setattr(ptf.Model, "decode_step", decode_step)
    cfg = port_get_config("qwen2-vl-2b-reduced")
    pserve.main(["--device", "cpu", "--arch", cfg.name, "--batch", "2",
                 "--prompt-len", "8", "--gen", "3", "--snapshot-every", "0",
                 "--workdir", str(tmp_path), "--seed", "5"])
    rng = np.random.default_rng(5)
    rng.integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
    front = rng.standard_normal((2, 4, cfg.d_model), dtype=np.float32) * 0.02
    assert seen["frontend"].dtype == torch.float32
    assert torch.equal(seen["frontend"], torch.from_numpy(front))
    assert seen["max_len"] == 4 + 8 + 3
    assert seen["pos"] == [12, 13, 14]


@pytest.mark.parametrize("arch,count", [("qwen2-vl-2b", 1_543_910_912),
                                        ("musicgen-large", 2_424_705_024)])
def test_param_counts_match_published(arch, count):
    """Twin of ``test_archs_smoke.py::test_param_counts_match_published``
    for the port's init on the meta device: every parameter and cache leaf
    has the JAX package's name, shape and dtype, and ``count_params``
    equals the JAX package's (within 5 % of the published 2B and 3.3B with
    its text encoder)."""
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    jshapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                             jax.random.key(0))
    pshapes = _meta_shapes(ptf.init_params(pcfg, torch.Generator(),
                                           device="meta"))
    assert pshapes == _meta_shapes(jshapes)
    assert ptf.count_params(pcfg) == jtf.count_params(jcfg) == count
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 4, 64))
    pcache = ptf.init_cache(pcfg, 4, 64, device="meta")
    assert _meta_shapes(pcache) == _meta_shapes(jcache)


def _meta_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _meta_shapes(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _meta_shapes(sub, f"{prefix}/{i}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


# -- the train driver's batch -------------------------------------------------


def test_train_driver_hands_frontend_embeds_as_floats(monkeypatch,
                                                      tmp_path):
    """The driver casts tokens and labels to int64 and the pipeline's
    ``frontend_embeds`` to the parameters' dtype (not to integers, which
    would make them zeros): the loss sees the pipeline's values exactly."""
    seen = []
    real = ptrain.loss_fn

    def spy(cfg, rc, params, batch):
        seen.append(dict(batch))
        return real(cfg, rc, params, batch)

    monkeypatch.setattr(ptrain, "loss_fn", spy)
    cfg = port_get_config("musicgen-large-reduced")
    ptrain.main(["--device", "cpu", "--arch", cfg.name, "--steps", "2",
                 "--batch", "2", "--seq", "16", "--ckpt-every", "0",
                 "--workdir", str(tmp_path)])
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=2, seed=7, prefetch=0,
                         frontend=cfg.n_frontend, d_model=cfg.d_model)
    assert len(seen) == 2
    for step, batch in enumerate(seen):
        exp = pipe.batch_at(step)
        assert batch["tokens"].dtype == batch["labels"].dtype == torch.int64
        front = batch["frontend_embeds"]
        assert front.dtype == torch.float32 and front.shape == (2, 4, 64)
        assert torch.equal(front, torch.from_numpy(exp["frontend_embeds"]))
        assert front.abs().max() > 0
        assert torch.equal(batch["tokens"],
                           torch.from_numpy(exp["tokens"]).long())


# -- optim/compress.py --------------------------------------------------------


def _grad_tree(rng):
    """A leaf whose size (300) is not a multiple of the 256-element block,
    a bf16 leaf, an all-zero leaf (the scale's 1e-12 clamp) and a block of
    exact halves (127 sets the scale to 1: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0
    under round-half-to-even)."""
    halves = np.zeros(256, np.float32)
    halves[:4] = [127.0, 2.5, -3.5, 0.5]
    return {"w": (rng.standard_normal(300) * 0.1).astype(np.float32),
            "blocks": {"bf16": (rng.standard_normal((4, 96)) * 3).astype(
                np.float32).astype(jnp.bfloat16),
                "zero": np.zeros((2, 5), np.float32)},
            "layers": [rng.standard_normal((3, 5, 7)).astype(np.float32),
                       halves]}


def test_compress_grads_match_jax():
    """Two steps of error feedback: ``q`` and ``scale`` bit-equal to the
    JAX package's, the f32 error state within 1e-7, and the decompressed
    gradients within 1e-7."""
    rng = np.random.default_rng(3)
    cfg_j = jcompress.CompressionConfig(enabled=True)
    cfg_p = pcompress.CompressionConfig(enabled=True)
    g0 = _grad_tree(rng)
    jerr = jcompress.init_error_state(jax.tree.map(jnp.asarray, g0))
    perr = pcompress.init_error_state(tree_map(
        lambda a: leaf_to_tensor(a, CPU), g0))
    assert perr["blocks"]["bf16"].dtype == torch.float32
    for step in range(2):
        g = g0 if step == 0 else _grad_tree(rng)
        jwire, jerr = jcompress.compress_grads(
            jax.tree.map(jnp.asarray, g), jerr, cfg_j)
        pgrads = tree_map(lambda a: leaf_to_tensor(a, CPU), g)
        pwire, perr = pcompress.compress_grads(pgrads, perr, cfg_p)
        for key in ("q", "scale"):
            tree_map(lambda p, j: np.testing.assert_array_equal(
                p.numpy(), np.asarray(j)), pwire[key], _np_tree(jwire[key]))
        assert pwire["q"]["w"].dtype == torch.int8
        assert pwire["q"]["w"].shape == (2, 256)
        tree_map(lambda p, j: np.testing.assert_allclose(
            p.numpy(), np.asarray(j), rtol=0, atol=1e-7), perr,
            _np_tree(jerr))
        jdeq = jcompress.decompress_grads(jwire, jax.tree.map(jnp.asarray,
                                                              g))
        pdeq = pcompress.decompress_grads(pwire, pgrads)
        tree_map(lambda p, j: np.testing.assert_allclose(
            p.numpy(), np.asarray(j), rtol=0, atol=1e-7), pdeq,
            _np_tree(jdeq))


def test_compress_rounds_half_to_even():
    """127 in a block sets its scale to exactly 1; the halves then round to
    the even integer, as ``jnp.round``."""
    g = torch.zeros(256)
    g[:4] = torch.tensor([127.0, 2.5, -3.5, 0.5])
    wire, err = pcompress.compress_grads(
        {"g": g}, pcompress.init_error_state({"g": g}),
        pcompress.CompressionConfig())
    assert wire["scale"]["g"].item() == 1.0
    assert wire["q"]["g"][0, :4].tolist() == [127, 2, -4, 0]
    assert err["g"][:4].tolist() == [0.0, 0.5, 0.5, 0.5]
