"""Roofline analysis of the port's dry-run records: the counterpart of
`repro.launch.roofline`.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--csv]

Hardware model: one NVIDIA H100 SXM (80GB HBM3, 700 W power limit), from
its data sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 900 GB/s NVLink 4.
These are published peaks, not measurements; a card set below 700 W runs
slower under load.

Terms per (arch x shape), all per-device per-step seconds:
  compute    = dot FLOPs / peak     (`op_profile`: ATen products + kernels)
  memory     = memory bytes / HBM bw (`memory_bytes`: arguments, outputs,
               temporaries written and read)
  collective = collective operand bytes / link bw (0 on one card)

MODEL_FLOPS = 6*N*D (train) or 2*N_active*D (serve) per device; the ratio
MODEL_FLOPS / counted FLOPs exposes remat and dispatch waste. The records
come from `launch/dryrun.py` (`RESULTS`); a record's ``chips`` field gives
the device count, and a record without one (the reference's) takes it
from its mesh name as the reference does. The port's records are of one
card, so the reference's ``--mesh`` and ``--rules`` filters, which choose
among meshes and sharding rules, are left to the multi-card work.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

# NVIDIA H100 80GB HBM3 (SXM) at 700 W: data-sheet peaks, not measured
PEAK_FLOPS = 989e12          # bf16 dense / card
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 900e9              # bytes/s / card, NVLink 4

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch.json"


def chips_of(rec: Dict) -> int:
    """The record's device count: its ``chips``, else the reference's
    meshes (512 on "2x16x16", 256 otherwise)."""
    if rec.get("chips"):
        return int(rec["chips"])
    return 512 if rec["mesh"] == "2x16x16" else 256


def model_flops_per_device(rec: Dict) -> float:
    from repro_torch.configs import get_arch, get_shape
    cfg = get_arch(rec["arch"])
    shape = get_shape(rec["shape"])
    chips = chips_of(rec)
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d / chips
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d / chips
    d = shape.global_batch          # one new token per sequence
    return 2.0 * n * d / chips


def memory_bytes(rec: Dict) -> float:
    """HBM traffic proxy per step per device: arguments read once (params,
    optimizer state, cache, batch) + outputs written once + temp buffers
    written+read. The op-level sum (`op_profile`'s ``hbm_bytes``) is kept
    in the record beside it: it charges every eager op's operands and
    results to HBM, including those the card's 50 MB L2 serves."""
    m = rec["memory"]
    return ((m["argument_size_bytes"] or 0)
            + (m["output_size_bytes"] or 0)
            + 2.0 * (m["temp_size_bytes"] or 0))


def analyze_record(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    compute = rec["flops"] / PEAK_FLOPS
    memory = memory_bytes(rec) / HBM_BW
    coll = rec.get("collective_bytes", 0.0) / LINK_BW
    coll_wire = rec.get("collective_wire_bytes", 0.0) / LINK_BW
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dom = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    bound = max(terms.values())
    util = mf / PEAK_FLOPS / max(bound, 1e-30)   # roofline fraction
    suggestions = {
        "compute": "cut recompute/dispatch waste (remat policy, causal "
                   "block skip, fused kernels) to close FLOPs ratio",
        "memory": "raise arithmetic intensity: fuse elementwise chains, "
                  "bf16/int8 the dominant streams, larger microbatch",
        "collective": "reshard to cut per-layer weight gathers (TP for "
                      "serve, bf16 gathers, overlap via async collectives)",
    }
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "rules": rec.get("rules", "baseline"), "kind": rec["kind"],
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "collective_wire_s": coll_wire, "dominant": dom,
        "model_flops": mf, "hlo_flops": rec["flops"],
        "flops_ratio": mf / max(rec["flops"], 1e-30),
        "roofline_fraction": util,
        "step_bound_s": bound,
        "suggestion": suggestions[dom],
        "temp_gb": (rec["memory"]["temp_size_bytes"] or 0) / 1e9,
        "args_gb": (rec["memory"]["argument_size_bytes"] or 0) / 1e9,
    }


def load_results() -> List[Dict]:
    if RESULTS.exists():
        return json.loads(RESULTS.read_text())
    return []


def table() -> List[Dict]:
    rows = [a for a in map(analyze_record, load_results()) if a]
    rows.sort(key=lambda x: (x["arch"], x["shape"]))
    return rows


def fmt_ms(s: float) -> str:
    return f"{s * 1e3:.2f}" if s < 10 else f"{s * 1e3:.0f}"


def markdown(rows: List[Dict]) -> str:
    out = ["| arch | shape | compute ms | memory ms | collective ms | "
           "dominant | 6ND/HLO | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(r['compute_s'])} | "
            f"{fmt_ms(r['memory_s'])} | {fmt_ms(r['collective_s'])} | "
            f"{r['dominant']} | {r['flops_ratio']:.2f} | "
            f"{r['roofline_fraction'] * 100:.1f}% |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args()
    rows = table()
    if args.csv:
        keys = ["arch", "shape", "mesh", "rules", "compute_s", "memory_s",
                "collective_s", "dominant", "flops_ratio",
                "roofline_fraction"]
        print(",".join(keys))
        for r in rows:
            print(",".join(str(r[k]) for k in keys))
    else:
        print(markdown(rows))
        worst = sorted(rows, key=lambda r: r["roofline_fraction"])[:3]
        print("\nworst roofline fractions:")
        for r in worst:
            print(f"  {r['arch']} x {r['shape']}: "
                  f"{r['roofline_fraction'] * 100:.1f}% "
                  f"({r['dominant']}-bound) -> {r['suggestion']}")


if __name__ == "__main__":
    main()
