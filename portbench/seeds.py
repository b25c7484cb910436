"""Seeds derived from a run's ``--seed``, one stream a purpose, so that the
same seed gives the same weights, prompts, batches and samples whatever
else the run does. ``--seed`` may be any whole number."""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *tag) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    text = ":".join(str(t) for t in (seed, *tag)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "big") >> 1


def generator(seed: int, device, *tag) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, *tag))
    return gen
