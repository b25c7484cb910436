#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload mistral-nemo-12b.chat --seed 1 \\
        --seconds 45 --trace 0

Builds the cell from ``BENCHMARK.json`` and the files it names, runs the
port (``src/repro_torch``) on one NVIDIA GPU: set-up, a window of
``--seconds``, then the comparison with the plain reference. Prints the
numbers compared beside their limits as the last lines of standard error,
and the result as one JSON object on the last line of standard output:
the end-to-end metrics with ``--trace 0``, the per-layer metrics and the
device's busy and traced seconds with ``--trace 1``. Exits non-zero,
printing no result, without a CUDA device, without the port's sources,
or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # not portbench/: its modules are portbench.*
sys.path.insert(1, str(ROOT / "src"))

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}  # top-level names, whole


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import manifest
    bench = manifest.benchmark()
    work = manifest.workload(bench, args.workload)
    if manifest.traffic(work["traffic"])["kind"] == "train":
        # the deterministic train step's cuBLAS, before its first call
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < work["chips"]:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {work['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is missing ({e}); run from a checkout "
              f"that holds src/repro_torch", file=sys.stderr)
        return 2
    from portbench import harness
    result = harness.run(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", T_START)
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"portbench: the run loaded {found}; the benchmark measures "
              f"repro_torch alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
