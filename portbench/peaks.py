"""Published peaks of the cards the benchmark knows, dense rates without
sparsity (NVIDIA's H100 SXM data sheet). A share of a peak is stated
against these, with the card's power limit beside it; on a card not in
the table the shares are left out."""
from __future__ import annotations

H100_SXM = {
    "bfloat16": 989e12,
    # float32 products as 3xTF32 on the tensor cores (TF32's 494.7 / 3),
    # the rate the port's f32 flash kernels and f32 steps are held to
    "float32": 494.7e12 / 3,
    "hbm_bytes_s": 3.35e12,
}

CARDS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def for_card(name: str):
    """The peak table of the card named ``name``, or None."""
    return CARDS.get(name)
