"""The comparisons that decide ``correct``: each number compared against
its limit (the cell file's ``check.limits``, set in ``PERF.md`` from the
program's readings over a dozen seeds and the control's)."""
from __future__ import annotations

import math
import statistics

import torch


def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position. ref_logits (N, G, V), tokens (N, G)."""
    chosen = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return float((ref_logits.max(-1).values - chosen).max())


def leaf_gaps(prog: dict, ref: dict, skip=()) -> dict:
    """{leaf: |prog - ref| / max(ref's norm of the leaf, of the median
    leaf)} over the leaves not in ``skip``."""
    names = [n for n in ref if n not in skip]
    median = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median) for n in names}


def worst(gaps: dict):
    """(the largest gap, its leaf)."""
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def still(first_grad: dict) -> set:
    """Leaves whose first gradient is nought to rounding: under a
    thousandth of the median leaf's. Adam moves them by round-off alone,
    so their change is not compared."""
    median = statistics.median(first_grad.values())
    return {n for n, g in first_grad.items() if g < 1e-3 * median}


def loss_gap(prog: list, ref: list) -> float:
    """The worst step's |loss - reference's| / |reference's|."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def route_regret(ref_probs: list, probs: list, k: int) -> float:
    """How far the routing chosen from ``probs`` (the top k of each
    token's router probabilities, a layer after another) lies from the
    reference's: the largest, over tokens and layers, of the reference's
    k-th largest probability less its smallest probability among the
    chosen experts (0 where the sets agree). A group (a sequence) counts
    up to the first layer where one of its tokens' experts differ: past
    it the two sides route different tokens, as the group's capacity and
    attention carry one token's change to the others. Infinite where the
    two cover different tokens."""
    worst, agree = 0.0, None
    for ref, other in zip(ref_probs, probs, strict=True):
        if ref.shape != other.shape:
            return float("inf")
        chosen = torch.sort(other, dim=-1, descending=True,
                            stable=True)[1][..., :k]
        r_chosen = torch.sort(ref, dim=-1, descending=True,
                              stable=True)[1][..., :k]
        kth = ref.gather(-1, r_chosen[..., -1:])[..., 0]
        regret = kth - ref.gather(-1, chosen).min(-1).values
        if agree is None:
            agree = torch.ones_like(regret, dtype=torch.bool)
        if agree.any():
            worst = max(worst, float(regret[agree].max()))
        same = (chosen.sort(-1)[0] == r_chosen.sort(-1)[0]).all(-1)
        agree &= same.all(dim=1, keepdim=True)
    return worst


def judge(readings: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct when every reading
    is finite and at most its limit."""
    checks = {n: {"value": readings[n], "limit": limits[n]}
              for n in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
