"""The comparisons that decide ``correct``, by hand on small inputs."""
import math

import pytest
import torch

from portbench import check


def test_served_gap():
    ref = torch.tensor([[[1.0, 3.0, 2.0], [0.0, 0.5, 0.2]]])
    assert check.served_gap(ref, torch.tensor([[1, 1]])) == 0.0
    assert check.served_gap(ref, torch.tensor([[2, 0]])) == 1.0


def test_leaf_gaps_against_leaf_or_median():
    ref = {"a": 10.0, "b": 1.0, "c": 2.0}
    gaps = check.leaf_gaps({"a": 11.0, "b": 1.1, "c": 2.0}, ref)
    # a against its own norm; b against the median leaf's, 2
    assert gaps == pytest.approx({"a": 0.1, "b": 0.05, "c": 0.0})
    assert check.worst(gaps) == (pytest.approx(0.1), "a")
    assert check.leaf_gaps({"a": 0.0, "c": 2.0}, ref, skip={"b"})["a"] == 1


def test_still_leaves():
    assert check.still({"a": 1.0, "b": 2.0, "c": 1e-4}) == {"c"}


def test_loss_gap_and_judge():
    assert check.loss_gap([2.0, 4.0], [2.0, 5.0]) == pytest.approx(0.2)
    ok, checks = check.judge({"x": 0.1, "y": 3.0}, {"x": 0.2})
    assert ok and checks == {"x": {"value": 0.1, "limit": 0.2}}
    assert not check.judge({"x": math.inf}, {"x": 0.2})[0]
    assert not check.judge({"x": math.nan}, {"x": 0.2})[0]


def test_route_regret():
    """Two groups (sequences) of two tokens, three experts, top 1."""
    ref = [torch.tensor([[[0.5, 0.3, 0.2], [0.1, 0.6, 0.3]],
                         [[0.4, 0.35, 0.25], [0.2, 0.2, 0.6]]]),
           torch.tensor([[[0.2, 0.3, 0.5], [0.7, 0.2, 0.1]],
                         [[0.3, 0.6, 0.1], [0.1, 0.8, 0.1]]])]
    assert check.route_regret(ref, ref, 1) == 0.0
    # group 0's token 0 routed to expert 1 in layer 0: 0.5 - 0.3
    other = [ref[0].clone(), ref[1].clone()]
    other[0][0, 0] = torch.tensor([0.3, 0.5, 0.2])
    assert check.route_regret(ref, other, 1) == pytest.approx(0.2)
    # past its first disagreement group 0 no longer counts, either token
    other[1][0] = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.2, 0.7]])
    assert check.route_regret(ref, other, 1) == pytest.approx(0.2)
    # group 1 agrees in layer 0, then its token 1 takes expert 0
    other[1][1, 1] = torch.tensor([0.9, 0.05, 0.05])
    assert check.route_regret(ref, other, 1) == pytest.approx(0.7)
    assert check.route_regret(ref, [r[:, :1] for r in ref], 1) \
        == math.inf
