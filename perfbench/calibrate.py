"""Readings that the limits of `correct` are set from, for one cell, in
one process on the card: for each seed, the program's numbers after a
short window at the cell's own load; for the first ``--control`` seeds
also the control's (the reference computed in fp8, put in the program's
place) and each planted fault's (``FAULTS`` of its ``drivers/``
module), every one against the float32 reference. One JSON line a seed
on standard output and in ``--out``.

    python3 perfbench/calibrate.py --workload qwen2-vl-7b.prefill \\
        --seeds 11,12,13 --control 3 --faults half_batch --seconds 2 \\
        --out calibrate.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=0,
                    help="seeds (the first ones) that also read the "
                         "control and the faults")
    ap.add_argument("--faults", default="",
                    help="comma-separated faults of the cell's driver")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from pbench import compare, harness, program
    program.load(ROOT)
    program.set_precision()
    bench = harness.Bench(ROOT)
    wl = bench.workload(args.workload)
    conf, mix = bench.config(wl["config"]), bench.traffic(wl["traffic"])
    ref = bench.reference(conf["family"])
    Driver = bench.driver(mix["driver"]).Driver
    limits = bench.limits(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(seeds):
            rec = {"workload": args.workload, "seed": seed}
            drv = Driver(conf, mix, seed, "cuda", ref)
            drv.setup()
            drv.window(args.seconds)
            drv.release()
            t = time.perf_counter()
            refs = drv.reference_run("float32")
            rec["reference_s"] = time.perf_counter() - t
            rec["program"] = compare.worst(drv.numbers(refs))
            rec["program_correct"] = compare.judge(rec["program"],
                                                   limits)[0]
            if k < args.control:
                ctrl = drv.reference_run("fp8")
                rec["control"] = compare.worst(drv.numbers(refs, got=ctrl))
                del ctrl
                for f in faults:
                    fd = Driver(conf, mix, seed, "cuda", ref, fault=f)
                    fd.setup()
                    fd.window(args.seconds)
                    fd.release()
                    rec.setdefault("faults", {})[f] = compare.worst(
                        fd.numbers(refs))
                    del fd
            del drv, refs
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
