"""Whole reduced models in bf16 against the JAX package run op by op.

``jax.disable_jit`` makes every bf16 op round as the port's eager ops do
(``jax.jit`` moves bf16 roundings by up to 1.86e-2). Each arch prefills 20
tokens (qwen2-vl after 4 random front-end embeddings) and decodes 4 steps;
every step's logits within 2^-8, one bf16 ulp at the logits' scale (< 1),
as the Jamba and RWKV6 bf16 tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config as port_get_config
from repro_torch.models import transformer as ptf
from repro_torch.weights import params_from_jax

CPU = torch.device("cpu")


@pytest.mark.parametrize("arch", ["gemma3-1b-reduced",
                                  "deepseek-moe-16b-reduced",
                                  "minicpm3-4b-reduced",
                                  "qwen2-vl-2b-reduced"])
def test_bf16_prefill_and_decode_match_eager_jax(arch):
    jcfg, pcfg = jax_get_config(arch), port_get_config(arch)
    model, prc = jtf.Model(jcfg, jtf.RunConfig()), ptf.RunConfig()
    jparams = model.init(jax.random.key(0))
    rng = np.random.default_rng(11)
    b, s, n_dec, nf = 2, 20, 4, jcfg.n_frontend
    toks = rng.integers(0, jcfg.vocab_size, (b, s + n_dec), dtype=np.int32)
    front = (rng.standard_normal((b, nf, jcfg.d_model)).astype(np.float32)
             if nf else None)
    with jax.disable_jit():
        jl, jcaches = model.prefill(
            jparams, jnp.asarray(toks[:, :s]),
            model.init_cache(b, nf + s + n_dec),
            None if front is None else jnp.asarray(front))
        want = [jl]
        for i in range(s, s + n_dec):
            jl, jcaches = model.decode_step(
                jparams, jnp.asarray(toks[:, i:i + 1]), jnp.int32(nf + i),
                jcaches)
            want.append(jl)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), CPU)
    caches = ptf.init_cache(pcfg, b, nf + s + n_dec, prc, device=CPU)
    pl, caches = ptf.prefill(pcfg, params, torch.from_numpy(toks[:, :s])
                             .long(), caches, prc,
                             frontend=None if front is None
                             else torch.from_numpy(front))
    got = [pl]
    for i in range(s, s + n_dec):
        pl, caches = ptf.decode_step(pcfg, params, torch.from_numpy(
            toks[:, i:i + 1]).long(), nf + i, caches, prc)
        got.append(pl)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=2.0 ** -8, rtol=0,
                                   err_msg=f"step {step}")
