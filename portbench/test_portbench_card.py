"""On the card, at each cell's own size (one seed, a window of one round
or one step): the program's readings within the cell's limits and the
control's beyond one of them. Run on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        portbench/test_portbench_card.py
"""
import os
import time

import pytest

from portbench import check, manifest

# the deterministic train step's cuBLAS setting, before the process's
# first product (a serve cell's run may come first)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
CONTROLS = {"serve": ("fp8",), "train": ("tf32", "half_batch")}
CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_and_control_on_the_card(card, name):
    import importlib
    cell = manifest.cell(manifest.benchmark(), name)
    kind = cell.traffic["kind"]
    run = importlib.import_module(f"portbench.kinds.{kind}").run
    _, readings, _, _ = run(cell, 2**31 + 17, 0.001, False, card,
                            time.perf_counter(), controls=CONTROLS[kind])
    limits = cell.spec["check"]["limits"]
    assert check.judge(readings, limits)[0], readings
    for control in CONTROLS[kind]:
        low = {k: readings[f"{k}.{control}"] for k in limits}
        assert not check.judge(low, limits)[0], (control, low)
