"""The one generator of traffic: it reads a traffic file's parameters and
makes the inputs on the device from the seed. Every seed gets the same
sizes; only the token ids differ.

kind "serve": closed-loop rounds of ``sessions`` concurrent sessions, each
a prompt of ``prompt_len`` token ids (uniform over the vocabulary) and
``gen`` greedy output tokens; a round starts when the last one ended.
kind "train": steps of ``batch`` sequences of ``seq_len`` token ids, the
labels the next token of each.
"""
from __future__ import annotations

import torch

from portbench import seeds

WARM_UP = -1  # the round or step index of set-up's warm-up inputs


def prompts(traffic: dict, vocab: int, seed: int, round_: int, device):
    """The prompts (sessions, prompt_len) int64 of round ``round_``."""
    gen = seeds.generator(seed, device, "prompts", round_)
    return torch.randint(0, vocab, (traffic["sessions"],
                                    traffic["prompt_len"]),
                         generator=gen, device=device)


def batch(traffic: dict, vocab: int, seed: int, step: int, device) -> dict:
    """Train step ``step``'s {"tokens", "labels"} (batch, seq_len) int64."""
    gen = seeds.generator(seed, device, "batch", step)
    rows = torch.randint(0, vocab, (traffic["batch"],
                                    traffic["seq_len"] + 1),
                         generator=gen, device=device)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
