"""One run of one cell: drive the port through the cell's traffic kind,
read every metric the cell reports and assemble the result line."""
from __future__ import annotations

import importlib
import subprocess

import torch

from portbench import check, manifest, peaks, profiling


def power_limit_w():
    """The card's power limit in watts (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(bench: dict, name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, cell=None) -> dict:
    """The result line's object. ``cell`` (a ``manifest.Cell``) replaces
    the one ``BENCHMARK.json`` names, for the tests."""
    cell = cell or manifest.cell(bench, name)
    device = torch.device(device)
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    rec, readings, attempted, failed = kind.run(
        cell, seed, seconds, trace, device, t_start)
    correct, checks = check.judge(readings, cell.spec["check"]["limits"])
    gpu = device.type == "cuda"
    rec.device_name = torch.cuda.get_device_name(device) if gpu else "cpu"
    rec.peaks = peaks.for_card(rec.device_name)
    if trace and gpu:
        rec.power_limit_w = power_limit_w()

    metrics = {}
    for m in manifest.metrics(bench, cell.name, trace):
        value = manifest.reader(m["name"])(rec)
        if value is None:
            if gpu and not trace:
                raise RuntimeError(f"{cell.name}: end-to-end metric "
                                   f"{m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if m["unit"] == "%" and rec.power_limit_w is not None:
            metrics[m["name"]]["power_limit_w"] = rec.power_limit_w
    dev = {"platform": "gpu" if gpu else "cpu", "kind": rec.device_name,
           "count": cell.chips, "memory_peak_bytes": rec.peak_bytes}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and rec.stretch:
        dev["busy_s"] = rec.stretch["busy_s"]
        dev["window_s"] = rec.stretch["window_s"]
        dev["power_limit_w"] = rec.power_limit_w
        out["breakdown"] = {
            "device_ops": profiling.top({k: s for k, (_, s) in
                                         rec.stretch["kernels"].items()}),
            "idle_gaps": profiling.top(rec.stretch["idle"])}
    out["setup_marks_s"] = rec.setup_marks
    out["checks"] = checks
    return out
