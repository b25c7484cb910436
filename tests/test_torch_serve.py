"""The port's serving slice end to end on the CPU, its checkpointer against
the JAX package's, and the port's independence from JAX and ``repro``."""
import ast
import copy
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as jckpt
import repro.core as jcore
import repro_torch.ckpt.checkpoint as pckpt
import repro_torch.core as pcore
from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

SERVE_ARGS = ["--device", "cpu", "--arch", "gemma3-1b-reduced", "--batch",
              "2", "--prompt-len", "48", "--gen", "16", "--snapshot-every",
              "4"]


@pytest.fixture()
def small_blocks(monkeypatch):
    """256-byte delta blocks (2 KiB tiles), so that the reduced model's
    cache leaves reach the delta_mask path; counts its calls."""
    monkeypatch.setattr(serve, "CheckpointConfig", functools.partial(
        pckpt.CheckpointConfig, delta_block=256))
    calls = []
    real = pckpt.delta_mask

    def spy(*a, **kw):
        calls.append(kw["block"])
        return real(*a, **kw)

    monkeypatch.setattr(pckpt, "delta_mask", spy)
    return calls


def test_serve_failover_matches_uninterrupted_run(small_blocks, tmp_path):
    toks, stats = serve.main(SERVE_ARGS + ["--inject-failure", "10",
                                           "--workdir", str(tmp_path / "a")])
    assert small_blocks and set(small_blocks) == {256}
    ref_toks, ref_stats = serve.main(SERVE_ARGS + [
        "--workdir", str(tmp_path / "b")])
    assert toks.shape == (2, 16)
    np.testing.assert_array_equal(toks, ref_toks)
    assert stats["logits_crc"] == ref_stats["logits_crc"]
    assert stats["failover_s"] > 0 and stats["device"] == "cpu"
    # tokens 4 and 8 before the kill at 10; 12 and 16 after resuming from 8
    assert stats["snapshots"] == ref_stats["snapshots"] == 4
    assert 0 < ref_stats["bytes_logged"] < ref_stats["bytes_full"]
    # on the CPU the plain versions run: no kernel was launched
    assert stats["launches"] == {"delta_mask": 0, "flash_attention": 0}


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "gemma3-1b-reduced", "--gen", "2"])


def _cache_states(seed):
    rng = np.random.default_rng(seed)
    state = {"caches": [
        {"L0": {n: rng.standard_normal((2, 40, 1, 16)).astype(np.float32)
                for n in "kv"}},
        {"L0": {"k": np.zeros((3, 2, 40, 1, 16), np.float32)}}]}
    states = [state]
    for step in (1, 2):
        state = copy.deepcopy(state)
        state["caches"][0]["L0"]["k"][:, 10 * step] += 1.0
        state["caches"][1]["L0"]["k"][step, :, 5 * step] = step
        states.append(state)
    return states


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy())


def test_checkpointer_matches_jax(tmp_path):
    jc = jcore.AssiseCluster(str(tmp_path / "jax"), n_nodes=3,
                             replication=2, n_reserve=1)
    pc = pcore.AssiseCluster(str(tmp_path / "port"), n_nodes=3,
                             replication=2, n_reserve=1)
    try:
        js, ps = jc.open_process("p"), pc.open_process("p")
        jck = jckpt.AssiseCheckpointer(js, jckpt.CheckpointConfig(
            delta_block=256))
        pck = pckpt.AssiseCheckpointer(ps, pckpt.CheckpointConfig(
            delta_block=256), device="cpu")
        for step, state in enumerate(_cache_states(11)):
            jck.save(step, state)
            pck.save(step, _to_torch(state))
            assert pck.stats["bytes_logged"] == jck.stats["bytes_logged"]
            assert pck.stats["bytes_full"] == jck.stats["bytes_full"]
            jman = json.loads(js.get(f"/ckpt/run0/MANIFEST.{step}"))
            pman = json.loads(ps.get(f"/ckpt/run0/MANIFEST.{step}"))
            assert pman == jman
        assert 0 < pck.stats["bytes_logged"] < pck.stats["bytes_full"]
        jflat, _ = jck.restore()
        pflat, _ = pck.restore()
        for name in jflat:
            np.testing.assert_array_equal(pflat[name], jflat[name])
    finally:
        jc.close()
        pc.close()


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


_COPIES = (sorted((ROOT / "src/repro/core").glob("*.py"))
           + sorted((ROOT / "src/repro/configs").glob("*.py"))
           + [ROOT / "src/repro/ckpt/delta.py"])


@pytest.mark.parametrize("src", _COPIES,
                         ids=lambda p: str(p.relative_to(ROOT / "src")))
def test_verbatim_copies(src):
    port_copy = PORT / src.relative_to(ROOT / "src" / "repro")
    assert port_copy.read_text() == src.read_text().replace("repro.",
                                                            "repro_torch.")
