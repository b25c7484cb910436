#!/usr/bin/env python3
"""Readings for a cell's correctness limits, on the card at the cell's
own size: for each seed, one run of the cell with a short window (at
least one round or one step, then the comparison), and the same readings
of the controls in the program's place. Prints one JSON line a seed.
The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload mistral-nemo-12b.chat \\
        --seeds 11 12 13 --controls fp8
    python3 portbench/calibrate.py --workload mistral-nemo-12b-l5.train \\
        --seeds 11 12 13 --controls tf32 half_batch

A serving control ("fp8", "bf16", "tf32") is the reference computed in
that precision, read as the gap of the token it puts first at each
position; a training control is the reference in that precision, or with
half of each batch left out ("half_batch"), compared as the program is.
The limits are set from these lines in ``PERF.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=[])
    args = ap.parse_args(argv)

    from portbench import manifest
    bench = manifest.benchmark()
    cell = manifest.cell(bench, args.workload)
    if cell.traffic["kind"] == "train":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        _, readings, _, _ = kind.run(cell, seed, 0.001, False, "cuda", t0,
                                     controls=args.controls)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          **readings}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
