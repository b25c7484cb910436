"""Nothing of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program. Top-level module names are
compared whole: ``repro_torch`` is the port, ``repro`` the JAX package."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(HERE.rglob("*.py"))


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_import_in_sources(path):
    assert not {n.split(".")[0] for n in imported(path)} & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    """The reference of every family under ``families/`` and the
    portbench modules it reaches import no ``repro_torch`` (nor JAX),
    transitively."""
    todo = [f"portbench.families.{p.name}.reference"
            for p in sorted((HERE / "families").iterdir())
            if (p / "__init__.py").is_file()]
    assert todo
    seen = set()
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = ROOT / (mod.replace(".", "/") + ".py")
        for name in imported(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"repro_torch"}, (mod, name)
            if top == "portbench":
                todo.append(name)


def test_a_run_loads_no_jax_in_a_fresh_process():
    """Every module of the benchmark imported, and every cell of
    ``BENCHMARK.json`` run at its tiny sizes on the CPU through the
    harness, in a new interpreter (the test process may hold JAX from
    other tests); then ``sys.modules`` read by whole top-level names."""
    code = """
import importlib, json, pathlib, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from portbench import harness, manifest, tiny
here = pathlib.Path(sys.argv[1]) / "portbench"
for p in sorted(here.rglob("*.py")):
    rel = p.relative_to(here.parent).with_suffix("")
    if p.parent.name == "metrics":
        manifest.reader(p.stem)
    elif p.parent.name == "expect":  # named by configuration, test-only
        continue
    elif not p.name.startswith("test_"):
        importlib.import_module(".".join(rel.parts).replace(".__init__", ""))
bench = manifest.benchmark()
for name in [w["name"] for w in bench["workloads"]]:
    harness.run(bench, name, 1, 0.2, False, "cpu", time.perf_counter(),
                cell=tiny.cell(name, "float32"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout
    loaded = set(json.loads(out.splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN


def test_run_without_a_card_prints_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would run the cell")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "mistral-nemo-12b.chat", "--seed", str(2**33 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
