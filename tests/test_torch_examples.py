"""The three example twins (``examples/*_torch.py``) run on the CPU with
small arguments: quickstart's loss and its read after failover; the serve
twin's resumed tokens against an uninterrupted run; the train twin's
resumed losses and parameters bit for bit against an uninterrupted run."""
import ast
import importlib.util
import math
import pathlib

import numpy as np
import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TWINS = ("quickstart_torch", "serve_failover_torch", "train_failover_torch")


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_repro(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert not {m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "repro")}


def test_quickstart(capsys):
    loss, read = _load("quickstart_torch").main(["--device", "cpu"])
    assert math.isfinite(loss) and abs(loss - math.log(512)) < 0.5
    assert read == b"assise"
    out = capsys.readouterr().out
    assert "after failover: b'assise'" in out and "loss=" in out


def test_serve_failover_resumes_as_uninterrupted():
    """rwkv6-1.6b-reduced with the script's kill at token 24 (snapshots
    every 16), shortened prompt, against the same run without the kill."""
    main = _load("serve_failover_torch").main
    small = ["--device", "cpu", "--prompt-len", "8"]
    toks, stats = main(small)
    ref, ref_stats = main(small + ["--inject-failure", "0"])
    assert toks.shape == (4, 48) and stats["failover_s"] > 0
    np.testing.assert_array_equal(toks, ref)
    assert stats["logits_crc"] == ref_stats["logits_crc"]


def test_train_failover_resumes_bit_for_bit():
    """gemma3-1b-reduced, the script's 14 steps with checkpoints after steps
    3 and 7 and a kill after the tenth step (resumed at step 8), at seq 32,
    against the same steps without kill or checkpoints."""
    main = _load("train_failover_torch").main
    small = ["--device", "cpu", "--seq", "32", "--batch", "2"]
    losses, stats = main(small)
    ref, ref_stats = main(small + ["--inject-failure", "0",
                                   "--ckpt-every", "0"])
    assert len(losses) == 16 and stats["saves"] == 3
    assert losses[:10] == ref[:10] and losses[10:] == ref[8:]
    assert stats["params_crc"] == ref_stats["params_crc"]
