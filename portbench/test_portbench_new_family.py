"""A configuration of a new family is new files and entries only. In a
copy of ``BENCHMARK.json`` and ``portbench/``, ``add_probe`` adds a family
``probe`` (its modules re-export the ``transformer`` family's), a
configuration of it at DeepSeekMoE-16B's widths (layer 0 dense, four
layers of routed and shared experts) in the keys the port runs, its
expectation, a one-chip train cell and that cell's check. The tests that
stand for each configuration, cell and family then pass in the copy, and
no file that was copied changes."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FILES = ("test_portbench_manifest.py", "test_portbench_reference.py",
         "test_portbench_imports.py")
CONFIG = "probe-moe-l5"
CELL = CONFIG + ".train"

PROBE = {
    "name": CONFIG,
    "source": "https://huggingface.co/deepseek-ai/deepseek-moe-16b-base",
    "family": "probe",
    "hidden_size": 2048, "num_hidden_layers": 5, "num_attention_heads": 16,
    "num_key_value_heads": 16, "head_dim": 128, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "n_routed_experts": 64,
    "num_experts_per_tok": 6, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "vocab_size": 102400, "hidden_act": "silu",
    "norm": "rmsnorm", "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
    "sliding_window": None, "tie_word_embeddings": False,
    "scoring_func": "softmax", "norm_topk_prob": True,
    "capacity_factor": 1.25, "aux_loss_alpha": 0.01, "dtype": "float32",
    "reduced": ["num_hidden_layers"],
    "departures": "5 of 28 layers; the port's router (gates renormalised "
                  "over the top 6, a capacity a group, balance loss 0.01), "
                  "not the published one",
}
EXPECT = '''"""The port's own DeepSeekMoE-16B, cut to layer 0 and four MoE
layers, with the published RMSNorm eps that its registry leaves out."""
import dataclasses


def arch_config():
    from repro_torch.configs import get_config
    full = get_config("deepseek-moe-16b")
    dense, moe = full.stages
    return dataclasses.replace(
        full, stages=(dense, dataclasses.replace(moe, repeat=4)),
        norm_eps=1e-6)
'''
CHECK = {"check": {"limits": {"loss_gap": 1e-06, "grad_gap": 0.0001,
                              "change_gap": 1.5e-06}}}


def copy_benchmark(dest: Path) -> None:
    """``BENCHMARK.json`` and ``portbench/`` as they stand, and the
    repository's ``src`` beside them as a link."""
    shutil.copy2(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(HERE, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "src").symlink_to(ROOT / "src", target_is_directory=True)


def add_probe(root: Path) -> None:
    """The family ``probe``, its configuration, expectation, cell and
    check, as new files and new entries of ``BENCHMARK.json``."""
    pb = root / "portbench"
    fam = pb / "families" / "probe"
    fam.mkdir()
    (fam / "__init__.py").write_text(
        '"""A probe family: the transformer family\'s modules."""\n')
    for part in ("layout", "port", "reference", "work"):
        (fam / f"{part}.py").write_text(
            f"from portbench.families.transformer.{part} import *  "
            f"# noqa: F401,F403\n")
    (pb / "configs" / f"{CONFIG}.json").write_text(json.dumps(PROBE))
    (pb / "expect" / f"{CONFIG}.py").write_text(EXPECT)
    (pb / "workloads" / f"{CELL}.json").write_text(json.dumps(CHECK))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": CONFIG, "source": PROBE["source"],
        "file": f"portbench/configs/{CONFIG}.json",
        "reduced": PROBE["reduced"], "why": "a probe of a new family"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "pretrain", "chips": 1,
        "why": "a probe of a new family's train cell"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_tok_s")["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def without_probe(bench: dict) -> dict:
    """``bench`` with every entry ``add_probe`` made taken out again."""
    out = dict(bench)
    out["configs"] = [c for c in bench["configs"] if c["name"] != CONFIG]
    out["workloads"] = [w for w in bench["workloads"] if w["name"] != CELL]
    out["end_to_end"] = [
        dict(m, workloads=[w for w in m["workloads"] if w != CELL])
        if "workloads" in m else m for m in bench["end_to_end"]]
    return out


def test_a_new_family_is_new_files_and_entries(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    copy_benchmark(copy)
    copied = sorted(p.relative_to(copy)
                    for p in (copy / "portbench").rglob("*") if p.is_file())
    add_probe(copy)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join([str(copy), str(ROOT / "src")])
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p",
         "no:cacheprovider", "-p", "no:randomly", "--basetemp",
         str(tmp_path / "basetemp"),
         *(str(copy / "portbench" / f) for f in FILES)],
        cwd=copy, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    for case in (f"test_configuration_is_the_ports[{CONFIG}]",
                 f"test_layout_is_the_ports[{CONFIG}]",
                 f"test_every_cell_reports_enough[{CELL}]",
                 "test_reference_imports_nothing_of_the_program",
                 "test_a_run_loads_no_jax_in_a_fresh_process"):
        assert any(line.startswith("PASSED") and line.endswith(case)
                   for line in proc.stdout.splitlines()), case
    for rel in copied:
        assert (copy / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    assert without_probe(bench) == json.loads(
        (ROOT / "BENCHMARK.json").read_text())
