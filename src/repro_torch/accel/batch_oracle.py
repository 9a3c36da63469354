"""Batched ground-truth labeling: the synthesis oracle as (B, N) arrays.

Each app's DAG is precompiled once (topologically levelled edge groups,
fanout wire delays, fixed-component PPA sums) and a whole (B, n_units)
block of configurations is evaluated in broadcast float64 NumPy, as in
`repro.accel.batch_oracle`: area/power sums, a levelled longest-path sweep
for latency, the same sweep backwards for the critical nodes, and the
per-config sha256 jitter. `label_configs` adds the SSIM scores of the
config-batched functional model (`apps.accuracy_ssim_batch`, which runs
on the images' device).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import networkx as nx
import numpy as np

from repro_torch.accel import apps as apps_lib
from repro_torch.accel import synth

EdgeGroup = Tuple[np.ndarray, np.ndarray]           # (src idx, dst idx)


@dataclass(frozen=True)
class CompiledApp:
    """Config-independent DAG precompilation for one accelerator."""
    node_ids: Tuple[str, ...]
    base_delay: np.ndarray        # (N,) float64: fixed latency + wire delay
    fixed_area: float
    fixed_power: float
    unit_pos: Tuple[int, ...]     # node index per app.unit_nodes entry
    jitter_order: Tuple[int, ...]  # unit_nodes indices sorted by node id
    fwd_groups: Tuple[EdgeGroup, ...]   # level-ascending, unique dst
    rev_groups: Tuple[EdgeGroup, ...]   # level-descending, unique src


def _conflict_free(edges: List[Tuple[int, int]], pos: int
                   ) -> List[EdgeGroup]:
    """Split edges into groups whose ``pos``-side endpoints are unique, so
    a fancy-indexed np.maximum assignment accumulates correctly."""
    groups: List[List[Tuple[int, int]]] = []
    used: List[set] = []
    for e in edges:
        for g, s in zip(groups, used):
            if e[pos] not in s:
                g.append(e)
                s.add(e[pos])
                break
        else:
            groups.append([e])
            used.append({e[pos]})
    return [(np.array([e[0] for e in g], np.int64),
             np.array([e[1] for e in g], np.int64)) for g in groups]


@functools.lru_cache(maxsize=None)
def compile_app(app_name: str) -> CompiledApp:
    app = apps_lib.APPS[app_name]
    acyclic = synth.acyclic_dataflow(app)
    ids = [n.id for n in app.nodes]
    idx = {nid: i for i, nid in enumerate(ids)}

    level = {nid: 0 for nid in ids}                 # longest-path depth
    for u in nx.topological_sort(acyclic):
        for _, v in acyclic.out_edges(u):
            level[v] = max(level[v], level[u] + 1)
    by_level: Dict[int, List[Tuple[int, int]]] = {}
    for u, v in acyclic.edges:
        by_level.setdefault(level[u], []).append((idx[u], idx[v]))

    fwd: List[EdgeGroup] = []
    rev: List[EdgeGroup] = []
    for lvl in sorted(by_level):
        fwd.extend(_conflict_free(by_level[lvl], pos=1))
    for lvl in sorted(by_level, reverse=True):
        rev.extend(_conflict_free(by_level[lvl], pos=0))

    base = np.zeros(len(ids), np.float64)
    fixed_area = fixed_power = 0.0
    for n in app.nodes:
        w = synth.wire_delay(acyclic, n.id)
        if n.fixed:
            pp = synth.FIXED_PPA[n.kind]
            base[idx[n.id]] = pp["latency"] + w
            fixed_area += pp["area"]
            fixed_power += pp["power"]
        else:
            base[idx[n.id]] = w                     # unit latency added later

    unit_pos = tuple(idx[n.id] for n in app.unit_nodes)
    jitter_order = tuple(sorted(range(len(app.unit_nodes)),
                                key=lambda j: app.unit_nodes[j].id))
    return CompiledApp(tuple(ids), base, fixed_area, fixed_power,
                       unit_pos, jitter_order, tuple(fwd), tuple(rev))


@functools.lru_cache(maxsize=None)
def _unit_tables(app_name: str, entries_items):
    """Per-unit-node float64 (area, power, latency, mae, wce) columns and
    entry names."""
    app = apps_lib.APPS[app_name]
    entries = dict(entries_items)
    cols = {f: [] for f in ("area", "power", "latency", "mae", "wce")}
    names = []
    for node in app.unit_nodes:
        ent = entries[node.kind]
        for f, col in cols.items():
            col.append(np.array([getattr(e, f) for e in ent], np.float64))
        names.append(tuple(e.inst.name for e in ent))
    return {f: tuple(c) for f, c in cols.items()}, tuple(names)


def _jitter_cols(app: apps_lib.AccelDef, ca: CompiledApp, names,
                 C: np.ndarray) -> np.ndarray:
    """(B, 3) area/power/latency jitter factors — the per-config sha256
    hashes of `synth._jitter`, key-identical to the scalar oracle."""
    unit_ids = [n.id for n in app.unit_nodes]
    out = np.empty((C.shape[0], 3), np.float64)
    prefix = app.name + "|"
    for b in range(C.shape[0]):
        key = prefix + ",".join(
            f"{unit_ids[j]}:{names[j][C[b, j]]}" for j in ca.jitter_order)
        out[b] = (synth._jitter(key + "A"), synth._jitter(key + "P"),
                  synth._jitter(key + "L"))
    return out


def synthesize_batch(app: apps_lib.AccelDef, entries: Dict[str, Sequence],
                     configs) -> Dict[str, np.ndarray]:
    """Vectorized `synth.synthesize` over a (B, n_units) config block:
    ``{area, power, latency: (B,), crit: (B, N) bool, node_delay: (B, N),
    node_ids}``."""
    ca = compile_app(app.name)
    C = np.asarray(configs, np.int64).reshape(-1, len(app.unit_nodes))
    B = C.shape[0]
    tab, names = _unit_tables(app.name, apps_lib._entries_items(app, entries))

    area = np.full(B, ca.fixed_area)
    dyn = np.full(B, ca.fixed_power)
    delay = np.repeat(ca.base_delay[None, :], B, axis=0)
    for j, pos in enumerate(ca.unit_pos):
        cj = C[:, j]
        area += tab["area"][j][cj]
        dyn += tab["power"][j][cj]
        delay[:, pos] += tab["latency"][j][cj]

    arrive = delay.copy()
    for src, dst in ca.fwd_groups:
        arrive[:, dst] = np.maximum(arrive[:, dst],
                                    arrive[:, src] + delay[:, dst])
    tmax = arrive.max(axis=1)

    # required-time back-propagation: a node is critical iff it sits on
    # some path achieving tmax (same 1e-9 tolerances as the scalar oracle)
    req = np.where(np.abs(arrive - tmax[:, None]) < 1e-9,
                   tmax[:, None], -1e30)
    for src, dst in ca.rev_groups:
        ok = (req[:, dst] > -1e29) & (
            np.abs(arrive[:, src] + delay[:, dst] - req[:, dst]) < 1e-9)
        cand = np.where(ok, arrive[:, src], -np.inf)
        req[:, src] = np.maximum(req[:, src], cand)

    jit = _jitter_cols(app, ca, names, C)
    return {"area": area * jit[:, 0],
            "power": dyn * (1 + synth.LEAKAGE_FRAC) * jit[:, 1],
            "latency": tmax * jit[:, 2],
            "crit": req > -1e29,
            "node_delay": delay,
            "node_ids": ca.node_ids}


def timing_batch(app: apps_lib.AccelDef, entries: Dict[str, Sequence],
                 configs) -> Dict[str, np.ndarray]:
    """Timing-only slice of `synthesize_batch` for the surrogate's
    featurizer: arrival/required-time sweeps and the DAG error
    propagation, without jitter hashing, area/power or SSIM.

    Returns ``{slack, criticality, err_mae, err_wce: (B, N) float64,
    crit: (B, N) bool, tmax: (B,), node_ids}``; slack is normalized by
    tmax and criticality is arrive/tmax.
    """
    ca = compile_app(app.name)
    C = np.asarray(configs, np.int64).reshape(-1, len(app.unit_nodes))
    B = C.shape[0]
    N = len(ca.node_ids)
    tab, _ = _unit_tables(app.name, apps_lib._entries_items(app, entries))

    delay = np.repeat(ca.base_delay[None, :], B, axis=0)
    err_mae = np.zeros((B, N), np.float64)
    err_wce = np.zeros((B, N), np.float64)
    for j, pos in enumerate(ca.unit_pos):
        cj = C[:, j]
        delay[:, pos] += tab["latency"][j][cj]
        err_mae[:, pos] = tab["mae"][j][cj]
        err_wce[:, pos] = tab["wce"][j][cj]

    arrive = delay.copy()
    for src, dst in ca.fwd_groups:
        arrive[:, dst] = np.maximum(arrive[:, dst],
                                    arrive[:, src] + delay[:, dst])
        # each edge forwards its source's accumulated error mass exactly
        # once; level-ascending groups finalize sources before use
        err_mae[:, dst] += err_mae[:, src]
        err_wce[:, dst] += err_wce[:, src]
    tmax = arrive.max(axis=1)

    creq = np.where(np.abs(arrive - tmax[:, None]) < 1e-9,
                    tmax[:, None], -1e30)
    # slack: min-based required times — sinks carry tmax (all node delays
    # are positive, so the max arrival lands on a sink)
    is_sink = np.ones(N, bool)
    for src, _ in ca.fwd_groups:
        is_sink[src] = False
    req = np.where(is_sink[None, :], tmax[:, None], np.inf)
    for src, dst in ca.rev_groups:
        ok = (creq[:, dst] > -1e29) & (
            np.abs(arrive[:, src] + delay[:, dst] - creq[:, dst]) < 1e-9)
        cand = np.where(ok, arrive[:, src], -np.inf)
        creq[:, src] = np.maximum(creq[:, src], cand)
        req[:, src] = np.minimum(req[:, src], req[:, dst] - delay[:, dst])

    return {"slack": (req - arrive) / tmax[:, None],
            "criticality": arrive / tmax[:, None],
            "err_mae": err_mae, "err_wce": err_wce,
            "crit": creq > -1e29, "tmax": tmax, "node_ids": ca.node_ids}


def probe_batch(app: apps_lib.AccelDef, entries: Dict[str, Sequence],
                configs, chunk: int = 1024, device=None
                ) -> Dict[str, np.ndarray]:
    """Functional-probe distortion columns ``{probe_err8, probe_err16:
    (B,) float64}``: 1 - SSIM of the config-batched functional model on
    the tiny deterministic probe images (`apps.probe_inputs`), run on
    ``device``."""
    C = np.asarray(configs, np.int64).reshape(-1, len(app.unit_nodes))
    out = {}
    for size in apps_lib.PROBE_SIZES:
        inp, exact_out = apps_lib.probe_inputs(app.name, size, device)
        s = apps_lib.accuracy_ssim_batch(app, entries, C, inp, exact_out,
                                         chunk=chunk)
        out[f"probe_err{size}"] = 1.0 - s
    return out


def crit_sets(rep: Dict[str, np.ndarray]) -> List[set]:
    """Per-config critical-node id sets (the scalar oracle's format)."""
    ids = np.asarray(rep["node_ids"])
    return [set(ids[row]) for row in rep["crit"]]


def label_configs(app: apps_lib.AccelDef, entries: Dict[str, Sequence],
                  configs, images, exact_out=None, *, chunk: int = 256
                  ) -> Dict[str, np.ndarray]:
    """Complete batched label rows: synthesis PPA/critical bits + SSIM
    (the functional model runs on ``images``' device)."""
    C = np.asarray(configs, np.int64).reshape(len(configs), -1)
    rep = synthesize_batch(app, entries, C)
    rep["ssim"] = apps_lib.accuracy_ssim_batch(
        app, entries, C, images, exact_out, chunk=chunk)
    return rep


def objective_rows(app: apps_lib.AccelDef, entries: Dict[str, Sequence],
                   configs, images, exact_out=None, *,
                   chunk: int = 256) -> np.ndarray:
    """(B, 4) minimization objectives [area, power, latency, 1-ssim] —
    the layout `SurrogateEngine.from_oracle` serves."""
    rep = label_configs(app, entries, configs, images, exact_out,
                        chunk=chunk)
    return np.stack([rep["area"], rep["power"], rep["latency"],
                     1 - rep["ssim"]], axis=1).astype(np.float64)
