"""What a run and the reference load, in a fresh interpreter: the
references load nothing of the program, and a whole run of each cell (at
small sizes on the CPU) loads neither JAX nor the JAX package, compared
by the modules' top-level names (the part before the first dot, whole, so the
port `repro_torch` is not the package `repro`)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)

def tops():
    return sorted({m.split(".")[0] for m in sys.modules})

from pbench import generator, harness, small, weights
bench = harness.Bench()
for wl in bench.doc["workloads"]:
    conf = bench.config(wl["config"])
    ref = bench.reference(conf["family"])
    mix = bench.traffic(wl["traffic"])
ref_only = tops()
from pbench import program
program.load(harness.ROOT)
for wl in bench.doc["workloads"]:
    w = bench.workload(wl["name"])
    conf = small.config(bench.config(w["config"]))
    mix = small.mix(bench.traffic(w["traffic"]))
    harness.run_cell(bench, w["name"], 3, 0.0, False, "cpu", conf=conf,
                     mix=mix)
    for m in bench.per_layer(w["name"]) + bench.end_to_end(w["name"]):
        bench.reader(m["name"])
print(json.dumps({"reference": ref_only, "run": tops()}))
"""


def test_nothing_loads_jax_and_the_reference_loads_no_program():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(HERE)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    banned = {"jax", "jaxlib", "flax", "repro"}
    assert not banned & set(tops["run"]), tops["run"]
    assert "repro_torch" in tops["run"]
    assert not (banned | {"repro_torch"}) & set(tops["reference"])
    assert "torch" in tops["reference"]
