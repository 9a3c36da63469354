"""Simulated synthesis oracle: accelerator-level PPA + critical path.

NumPy and networkx, as `repro.accel.synth`: area and power are sums of
unit and fixed-component figures, latency is the longest path through the
dataflow DAG (node delay = unit latency + fanout wire delay), the critical
path is every node on a longest path, and a sha256 hash of the
configuration gives the deterministic run-to-run synthesis jitter.
`static_timing` is the timing-only analysis behind the schema-v2 dynamic
feature columns.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Set

import networkx as nx

from repro_torch.accel import library as lib
from repro_torch.accel.apps import AccelDef

FIXED_PPA = {
    "mem": {"area": 220.0, "power": 35.0, "latency": 4.0},
    "abs": {"area": 12.0, "power": 3.0, "latency": 2.5},
    "cmp": {"area": 18.0, "power": 4.0, "latency": 3.0},
    "div": {"area": 450.0, "power": 60.0, "latency": 0.0},  # off critical loop
    "shift": {"area": 2.0, "power": 0.5, "latency": 0.5},
}
WIRE_DELAY_PER_FANOUT = 0.35
LEAKAGE_FRAC = 0.08


def _jitter(key: str, spread: float = 0.004) -> float:
    # run-to-run synthesis variation; must stay well below the
    # configuration-induced PPA spread or it becomes the R^2 noise floor
    h = int(hashlib.sha256(key.encode()).hexdigest()[:8], 16)
    return 1.0 + ((h % 1000) - 500) / 500.0 * spread


def node_ppa(app: AccelDef, choice: Dict[str, lib.LibEntry]
             ) -> Dict[str, Dict[str, float]]:
    out = {}
    for n in app.nodes:
        if n.fixed:
            out[n.id] = dict(FIXED_PPA[n.kind])
        else:
            e = choice[n.id]
            out[n.id] = {"area": e.area, "power": e.power,
                         "latency": e.latency}
    return out


def acyclic_dataflow(app: AccelDef) -> nx.DiGraph:
    """The accelerator dataflow as a DAG. Physical unit reuse introduces
    cycles; those back-edges are registered in the RTL (sequential
    boundaries, not combinational paths) and are broken deterministically
    in edge order."""
    acyclic = nx.DiGraph()
    acyclic.add_nodes_from(n.id for n in app.nodes)
    for u, v in app.edges:
        if u == v:
            continue
        acyclic.add_edge(u, v)
        if not nx.is_directed_acyclic_graph(acyclic):
            acyclic.remove_edge(u, v)      # registered feedback edge
    return acyclic


def wire_delay(g: nx.DiGraph, nid: str) -> float:
    """Fanout-proportional wire delay added to a node's unit latency."""
    return WIRE_DELAY_PER_FANOUT * max(g.out_degree(nid), 1)


def _sweeps(app: AccelDef, ppa: Dict[str, Dict[str, float]]):
    """Arrival-time sweep and the critical-path back-propagation:
    ``(acyclic, order, delay, arrive, tmax, creq)``, where a node is
    critical iff ``creq[nid] > -1e29`` (on some path achieving tmax, with
    1e-9 tolerances, so the bits do not depend on float noise)."""
    acyclic = acyclic_dataflow(app)
    delay = {nid: ppa[nid]["latency"] + wire_delay(acyclic, nid)
             for nid in acyclic.nodes}
    order = list(nx.topological_sort(acyclic))
    arrive = {nid: delay[nid] for nid in order}
    for nid in order:
        for _, v in acyclic.out_edges(nid):
            arrive[v] = max(arrive[v], arrive[nid] + delay[v])
    tmax = max(arrive.values())
    creq = {nid: -1e30 for nid in order}
    for nid in order:
        if abs(arrive[nid] - tmax) < 1e-9:
            creq[nid] = tmax
    for nid in reversed(order):
        for _, v in acyclic.out_edges(nid):
            if creq[v] > -1e29 and abs(
                    arrive[nid] + delay[v] - creq[v]) < 1e-9:
                creq[nid] = max(creq[nid], arrive[nid])
    return acyclic, order, delay, arrive, tmax, creq


def static_timing(app: AccelDef, choice: Dict[str, lib.LibEntry],
                  device=None) -> Dict[str, object]:
    """Timing-only static analysis of one configuration, for the
    schema-v2 dynamic timing block: ``{tmax, nodes}`` where
    ``nodes[nid]`` has

      on_critical_path  the bit of ``synthesize()['critical_nodes']``;
      slack             (required - arrival) / tmax, from a min-based
                        required-time sweep (sinks required at tmax);
      criticality       arrival / tmax;
      err_mae, err_wce  unit error profiles accumulated along the DAG,
                        raw (`graph.reduce_timing` compresses them);
      probe_err8/16     the functional-probe distortion
                        (`apps.probe_scalar` on ``device``), identical on
                        every node.

    The scalar reference of `batch_oracle.timing_batch` and
    `batch_oracle.probe_batch`."""
    from repro_torch.accel import apps as apps_lib
    acyclic, order, delay, arrive, tmax, creq = _sweeps(
        app, node_ppa(app, choice))
    req = {nid: (tmax if acyclic.out_degree(nid) == 0 else float("inf"))
           for nid in order}
    for nid in reversed(order):
        for _, v in acyclic.out_edges(nid):
            req[nid] = min(req[nid], req[v] - delay[v])
    # each edge forwards its source's accumulated error mass once;
    # topological order finalizes a source before its out-edges fire
    err = {}
    for key in ("mae", "wce"):
        acc = {n.id: (0.0 if n.fixed else float(getattr(choice[n.id], key)))
               for n in app.nodes}
        for nid in order:
            for _, v in acyclic.out_edges(nid):
                acc[v] += acc[nid]
        err[key] = acc
    probe = apps_lib.probe_scalar(app, choice, device)
    nodes = {nid: {"on_critical_path": float(creq[nid] > -1e29),
                   "slack": (req[nid] - arrive[nid]) / tmax,
                   "criticality": arrive[nid] / tmax,
                   "err_mae": err["mae"][nid],
                   "err_wce": err["wce"][nid],
                   **probe}
             for nid in order}
    return {"tmax": float(tmax), "nodes": nodes}


def synthesize(app: AccelDef, choice: Dict[str, lib.LibEntry]
               ) -> Dict[str, object]:
    """Returns {area, power, latency, critical_nodes (set), node_delay}
    for one configuration (the scalar oracle; `batch_oracle` is the
    batched one)."""
    ppa = node_ppa(app, choice)
    cfg_key = app.name + "|" + ",".join(
        f"{k}:{v.inst.name}" for k, v in sorted(choice.items()))

    area = sum(p["area"] for p in ppa.values()) * _jitter(cfg_key + "A")
    dyn = sum(p["power"] for p in ppa.values())
    power = dyn * (1 + LEAKAGE_FRAC) * _jitter(cfg_key + "P")
    _, order, delay, _, tmax, creq = _sweeps(app, ppa)
    latency = tmax * _jitter(cfg_key + "L")
    crit: Set[str] = {nid for nid in order if creq[nid] > -1e29}
    return {"area": float(area), "power": float(power),
            "latency": float(latency), "critical_nodes": crit,
            "node_delay": delay}
