"""The benchmark, driven by data: `BENCHMARK.json` at the checkout's root
names each cell's configuration and traffic mix and each metric; the
harness finds every file by those names under the benchmark's folder:

    configs/<config>.json      the configuration as it is run (the file
                               its `configs` entry names)
    traffic/<traffic>.json     a mix's parameters (`generator`), with the
                               name of its ``driver``
    drivers/<driver>.py        a kind of traffic's loop: set-up, window,
                               traced slice, what the comparison reads
    reference/<family>.py      the family's plain reference
    metrics/<metric>.py        a metric's reader, ``read(ctx)``, for the
                               end-to-end and the per-layer metrics alike
    limits/<workload>.json     each compared number's limit

`run_cell` sets up the program, measures the window, traces a slice
when asked, reads the memory peak, frees the program and compares what
the window produced with the reference.
"""
from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, Optional

import torch

from pbench import compare, counting, program

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder
ROOT = HERE.parent                                # the checkout


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    return json.loads(path.read_text())


def _mod_name(kind: str, name: str) -> str:
    return "perfbench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


class Bench:
    """`BENCHMARK.json` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.doc = _json(self.root / "BENCHMARK.json")
        self.dir = HERE

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{[w['name'] for w in self.doc['workloads']]}")

    def config(self, name: str) -> dict:
        return _json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> Dict[str, dict]:
        return _json(self.dir / "limits" / f"{workload}.json")["limits"]

    def reference(self, family: str) -> ModuleType:
        return _module(self.dir / "reference" / f"{family}.py",
                       _mod_name("reference", family))

    def driver(self, name: str) -> ModuleType:
        return _module(self.dir / "drivers" / f"{name}.py",
                       _mod_name("driver", name))

    def reader(self, metric: str) -> ModuleType:
        return _module(self.dir / "metrics" / f"{metric}.py",
                       _mod_name("metric", metric))

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.doc["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        moved = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.doc["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device, started: Optional[float] = None,
             conf: Optional[dict] = None, mix: Optional[dict] = None,
             fault: Optional[str] = None,
             phases: Optional[dict] = None) -> dict:
    """One run of a cell; the result line's object. ``started`` is the
    process's start on `time.perf_counter`'s clock; ``conf``, ``mix``
    and ``fault`` stand in for the cell's own (tests at small sizes);
    ``phases`` gets the set-up's seconds by phase."""
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    wl = bench.workload(workload)
    conf = bench.config(wl["config"]) if conf is None else conf
    mix = bench.traffic(wl["traffic"]) if mix is None else mix
    limits = bench.limits(workload)
    program.set_precision()
    drv = bench.driver(mix["driver"]).Driver(
        conf, mix, seed, device, bench.reference(conf["family"]), fault)
    drv.setup()
    setup_s = time.perf_counter() - started
    if phases is not None:
        phases.update(drv.phases)
    drv.window(seconds)
    tr = drv.trace() if trace else None
    dev = device_info(device)
    drv.release()
    each = drv.numbers(drv.reference_run())
    ok, checks = compare.judge(compare.worst(each), limits)
    # calls with a non-finite output, checked calls outside a limit
    failed = int(drv.nonfinite) + sum(
        not compare.judge(n, limits)[0] for n in each)
    ctx = SimpleNamespace(conf=conf, mix=mix, stats=drv.stats, trace=tr,
                          traced=drv.traced, counting=counting,
                          setup_s=setup_s)
    metrics = bench.per_layer(workload) if trace else \
        bench.end_to_end(workload)
    values = {m["name"]: (bench.reader(m["name"]).read(ctx), m["unit"])
              for m in metrics}
    if trace:
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    out = {"correct": bool(ok and failed == 0),
           "attempted": drv.attempted(), "failed": failed,
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in values.items() if v is not None},
           "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(10)}
    out["checks"] = checks
    return out
