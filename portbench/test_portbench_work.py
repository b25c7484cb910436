"""The benchmark's counts of work against hand counts at a small shape."""
import pytest

from portbench.families.transformer import work

DENSE = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 2, "intermediate_size": 6,
         "vocab_size": 10}
MOE = dict(DENSE, n_routed_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=3, n_shared_experts=1,
           first_k_dense_replace=1)


def test_active_params_by_hand():
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8  # wq, wk, wv, wo
    assert work.active_params(DENSE) == 2 * (attn + 3 * 8 * 6)
    # layer 0 dense; layer 1: router + 2 routed + 1 shared expert of 3
    assert work.active_params(MOE) == (attn + 3 * 8 * 6) \
        + (attn + 8 * 4 + 3 * 8 * 3 * 3)
    assert work.head_params(DENSE) == 80


def test_flash_counts_by_hand():
    # B=1, H=4, Hk=2, D=Dv=2, S=3: 6 causal pairs, 2 products of 2 each
    flops, nbytes = work.flash_fwd(DENSE, 1, 3, 2)
    assert flops == 2 * 4 * 6 * 4
    assert nbytes == 2 * 3 * (8 + 4 + 4 + 8)
    flops, nbytes = work.flash_bwd(DENSE, 1, 3, 4)
    assert flops == 2 * 4 * 6 * 8
    assert nbytes == 4 * 3 * (8 + 4 + 4 + 16) + 4 * 3 * 4 \
        + 4 * 3 * (8 + 4 + 4)


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_step_flops_by_hand(cfg):
    p, hp = work.active_params(cfg), work.head_params(cfg)
    attn = 2 * 4 * 6 * 4  # one layer's causal attention at S=3
    assert work.prefill_flops(cfg, 1, 3) == 2 * p * 3 + 2 * hp + 2 * attn
    # new token at position 2 attends 3 positions in each of 2 layers
    assert work.decode_flops(cfg, 1, 2) == 2 * p + 2 * hp \
        + 2 * (2 * 4 * 3 * 4)
    assert work.train_flops(cfg, 1, 3) == 3 * (2 * (p + hp) * 3 + 2 * attn)
