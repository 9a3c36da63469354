"""The comparison that decides `correct` fails what it has to, at sizes a
CPU test holds (the program's REDUCED sizes of each architecture, short
prompts): the control, the reference computed in fp8 and put in the
program's place, and a run of the harness with each fault a cell can
have planted under its timed path (its driver's ``FAULTS``; one card, so
no exchange between chips to leave out). The card's readings at the
cells' own sizes are in PERF.md."""
from __future__ import annotations

import pytest
import torch

from pbench import compare, harness, program, small

program.load(harness.ROOT)

BENCH = harness.Bench()
CELLS = [w["name"] for w in BENCH.doc["workloads"]]
SEED = 2 ** 34 + 9


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(workload):
    wl = BENCH.workload(workload)
    return (small.config(BENCH.config(wl["config"])),
            small.mix(BENCH.traffic(wl["traffic"])))


def _faults(workload):
    mix = BENCH.traffic(BENCH.workload(workload)["traffic"])
    return BENCH.driver(mix["driver"]).FAULTS


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, one_thread):
    conf, mix = _small(workload)
    drv = BENCH.driver(mix["driver"]).Driver(
        conf, mix, SEED, "cpu", BENCH.reference(conf["family"]))
    drv.setup()
    drv.window(0.0)
    drv.release()
    refs = drv.reference_run()
    limits = BENCH.limits(workload)
    assert compare.judge(compare.worst(drv.numbers(refs)), limits)[0]
    control = drv.numbers(refs, got=drv.reference_run("fp8"))
    assert not compare.judge(compare.worst(control), limits)[0]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in _faults(w)])
def test_a_run_with_a_fault_under_the_timed_path_is_not_correct(
        workload, fault, one_thread):
    conf, mix = _small(workload)
    out = harness.run_cell(BENCH, workload, SEED, 0.0, False, "cpu",
                           conf=conf, mix=mix, fault=fault)
    assert out["correct"] is False and out["failed"] >= 1
