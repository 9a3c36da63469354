"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix,
metrics and limits are named in `BENCHMARK.json` (see README.md). The
last line of standard output is the result as one JSON object; the last
lines of standard error are the compared numbers beside their limits.
Exits 2 without a result where the card, the cards the cell asks for or
the program is missing, and 3 where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        ticks = int(Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _finite(x):
    """The result with each non-finite number as null (JSON has none)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    started = time.perf_counter() - _process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the port builds its nvcc libraries into build/kernels/ of the
    # checkout by its own rule, and uses no other kernel cache
    os.environ["USE_FLAX"] = "0"
    phases = {"interpreter": time.perf_counter() - started}
    import torch
    phases["torch_import"] = time.perf_counter() - started \
        - sum(phases.values())
    from pbench import harness, program
    try:
        program.load(ROOT)
        bench = harness.Bench(ROOT)
        chips = bench.workload(args.workload)["chips"]
    except (FileNotFoundError, KeyError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    phases["harness_import"] = time.perf_counter() - started \
        - sum(phases.values())
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); {found} "
              f"found", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    phases["cuda_context"] = time.perf_counter() - started \
        - sum(phases.values())
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", started=started,
                              phases=phases)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if loaded:
        print(f"perfbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
