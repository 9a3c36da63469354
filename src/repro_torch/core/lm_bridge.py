"""ApproxPilot-LM: the paper's technique applied to the LM framework
itself; the port of `repro.core.lm_bridge`.

The transformer step is itself an "accelerator": a dataflow graph of
coarse ops (embed, qkv, attention, out-proj, mlp/moe, lm-head) where each
op picks an arithmetic precision from {bf16, fp8, int8} — a design space
isomorphic to the paper's approximate-unit selection. The same two-stage
GNN predicts (step_time, hbm_bytes, quality_penalty) and the critical-path
stage predicts which op dominates the roofline (per-op time = max(compute,
memory) term; the step's bottleneck is the argmax op).

The oracle is a roofline cost model at `launch.roofline`'s constants (the
H100's here, the TPU v5e's in the reference) fed by per-op FLOPs/bytes
derived from the arch config. `op_graph` keeps the reference's per-device
split of a 256-device mesh, so the op graph is the reference's.
`train_surrogate` trains on ``device`` (the card unless told otherwise)
and serves a predict that runs every gsae layer through
`kernels.ops.gnn_mp` there.
"""
from __future__ import annotations

import types
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.roofline import PEAK_FLOPS, HBM_BW

# precision options: (flops multiplier vs bf16 peak, bytes multiplier,
# quality penalty per op in "approx-units" — literature-informed relative
# sensitivities, attention/lm-head most sensitive)
PRECISIONS = ("bf16", "fp8", "int8")
_SPEED = {"bf16": 1.0, "fp8": 2.0, "int8": 2.0}
_BYTES = {"bf16": 1.0, "fp8": 0.5, "int8": 0.5}
_SENS = {"embed": 0.2, "qkv": 0.6, "attn": 1.5, "out": 0.6,
         "mlp_in": 0.4, "mlp_out": 0.5, "moe": 0.7, "head": 2.0}
_PENALTY = {"bf16": 0.0, "fp8": 1.0, "int8": 2.5}

OP_CLASSES = ("embed", "qkv", "attn", "out", "mlp_in", "mlp_out", "head")

# the surrogate's engine: chunks of up to 256 configs, padded to
# power-of-two buckets
CHUNK = 256
# the gnn_mp layer path against `models.predict` on a probe batch
# (normalized outputs), checked when the engine is built
PARITY_ATOL = 2e-3


def op_graph(cfg: ArchConfig, shape: ShapeConfig, n_devices: int = 256
             ) -> Tuple[List[Dict], np.ndarray]:
    """Per-op [flops, bytes] for one (micro)batch step on one device."""
    B = max(shape.global_batch // max(n_devices // 16, 1), 1)
    S = shape.seq_len
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    # decode processes ONE new token per sequence (KV cache of length S)
    T = B if shape.kind == "decode" else B * S
    mult = 6 if shape.kind == "train" else 2        # fwd+bwd vs fwd
    ops = []

    emb_bytes = T * d * 2 + cfg.vocab_size * d * 2 / max(L, 1)
    ops.append({"name": "embed", "f": 2 * T * d, "b": emb_bytes,
                "fanin": []})
    ops.append({"name": "qkv",
                "f": L * 2 * T * d * (H + 2 * KV) * hd,
                "b": L * (T * d * 2 + d * (H + 2 * KV) * hd * 2),
                "fanin": ["embed"]})
    sk = min(S, cfg.swa_window) if cfg.swa_window else S
    q_len = 1 if shape.kind == "decode" else S
    # decode attention also re-reads the whole KV cache from HBM
    cache_bytes = (B * sk * 2 * KV * hd * 2 * L
                   if shape.kind == "decode" else 0)
    ops.append({"name": "attn", "f": L * 4 * B * q_len * sk * H * hd,
                "b": L * T * (H + 2 * KV) * hd * 2 + cache_bytes,
                "fanin": ["qkv"]})
    ops.append({"name": "out", "f": L * 2 * T * H * hd * d,
                "b": L * (T * d * 2 + H * hd * d * 2), "fanin": ["attn"]})
    eff_f = cfg.top_k * cfg.expert_d_ff if cfg.is_moe else f
    ops.append({"name": "mlp_in", "f": L * 4 * T * d * eff_f,
                "b": L * (T * d * 2 + 2 * d * eff_f * 2),
                "fanin": ["out"]})
    ops.append({"name": "mlp_out", "f": L * 2 * T * eff_f * d,
                "b": L * (T * eff_f * 2 + eff_f * d * 2),
                "fanin": ["mlp_in"]})
    ops.append({"name": "head", "f": 2 * T * d * cfg.vocab_size,
                "b": T * cfg.vocab_size * 2 + d * cfg.vocab_size * 2,
                "fanin": ["mlp_out"]})
    scale = mult / 2.0
    for o in ops:
        o["f"] *= scale
        o["b"] *= scale

    names = [o["name"] for o in ops]
    adj = np.zeros((len(ops), len(ops)), np.float32)
    for j, o in enumerate(ops):
        for src in o["fanin"]:
            adj[names.index(src), j] = 1.0
    return ops, adj


def oracle(cfg: ArchConfig, shape: ShapeConfig, ops: List[Dict]):
    """evaluate(configs) -> (step_time_s, hbm_gb, penalty) + critical op."""
    def evaluate_one(choice: Sequence[int]):
        times, bytes_tot, pen = [], 0.0, 0.0
        for o, ci in zip(ops, choice):
            p = PRECISIONS[ci]
            t_c = o["f"] / (PEAK_FLOPS * _SPEED[p])
            b = o["b"] * _BYTES[p]
            t_m = b / HBM_BW
            times.append(max(t_c, t_m))
            bytes_tot += b
            pen += _SENS.get(o["name"], 0.5) * _PENALTY[p]
        step_time = sum(times)
        crit = int(np.argmax(times))
        return (step_time, bytes_tot / 1e9, pen), crit

    def evaluate(configs):
        return np.asarray([evaluate_one(c)[0] for c in configs], np.float64)

    return evaluate, evaluate_one


def _samples(ops, adj, evaluate_one, n_samples: int, seed: int):
    """The reference's training set: ``n_samples`` random choices from
    ``default_rng(seed)``, as an `AccelDataset`, and the featurizer."""
    from repro_torch.core.dataset import AccelDataset
    from repro_torch.core.graph import normalized_adjacency

    n_ops = len(ops)
    rng = np.random.default_rng(seed)
    A1 = normalized_adjacency(adj)

    # features: [log flops, log bytes, onehot(op), onehot(precision)]
    def feats(choice):
        x = np.zeros((n_ops, 2 + n_ops + len(PRECISIONS)), np.float32)
        for i, (o, c) in enumerate(zip(ops, choice)):
            x[i, 0] = np.log10(max(o["f"], 1.0))
            x[i, 1] = np.log10(max(o["b"], 1.0))
            x[i, 2 + i] = 1.0
            x[i, 2 + n_ops + c] = 1.0
        return x

    X, Y, C = [], [], []
    for _ in range(n_samples):
        choice = tuple(rng.integers(0, len(PRECISIONS), n_ops))
        (t, hbm, pen), crit = evaluate_one(choice)
        X.append(feats(choice))
        Y.append([np.log10(t), np.log10(max(hbm, 1e-9)), pen, 0.0])
        C.append(np.eye(n_ops, dtype=np.float32)[crit])
    X = np.stack(X)
    Y = np.asarray(Y, np.float32)
    C = np.stack(C)
    ymu, ysd = Y.mean(0), Y.std(0) + 1e-6
    Yn = (Y - ymu) / ysd
    A = np.broadcast_to(A1, (len(X), n_ops, n_ops)).copy()
    M = np.ones((len(X), n_ops), np.float32)
    ds = AccelDataset("lm_bridge", None, A, X, M, M, Yn, Y, C,
                      [tuple()] * len(X), ymu, ysd,
                      np.zeros(X.shape[-1]), np.ones(X.shape[-1]))
    return ds, A1, feats


def train_surrogate(cfg: ArchConfig, shape: ShapeConfig, n_samples: int = 400,
                    epochs: int = 30, seed: int = 0, ensemble: int = 0,
                    device=None):
    """Train the paper's two-stage GNN on the LM op-graph design space:
    stage 1 classifies the roofline-critical op ("critical path" transfer),
    stage 2 regresses [step_time, hbm_gb, penalty, 0]. Returns (metrics,
    predict) — the full ApproxPilot model, not just its DSE, on the LM
    framework.

    Trains and serves on ``device`` (default: the CUDA card, raising
    without one). ``predict`` is a `SurrogateEngine` over chunks of up to
    `CHUNK` configs padded to power-of-two buckets; each chunk runs the
    gsae layers through `kernels.ops.gnn_mp` (`engine._make_predict`),
    which is held against `models.predict` on a probe batch at
    `PARITY_ATOL` when built (`engine._checked_predict`).

    ``ensemble > 0`` trains that many members (`training.fit_ensemble`);
    predictions are the members' mean and the metrics gain per-target
    ``mean_std`` uncertainty columns."""
    import torch

    from repro_torch import device as device_lib
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import gnn, models, training

    dev = device_lib.resolve(device)
    ops, adj = op_graph(cfg, shape)
    _, evaluate_one = oracle(cfg, shape, ops)
    n_ops = len(ops)
    ds, A1, feats = _samples(ops, adj, evaluate_one, n_samples, seed)
    tr, te = ds.split(0.9)
    two = models.TwoStageConfig(gnn=gnn.GNNConfig(
        arch="gsae", n_layers=3, hidden=64, feature_dim=ds.x.shape[-1]))
    tc = training.TrainConfig(epochs=epochs, seed=seed)

    def featurize(choices):
        return np.stack([feats(c) for c in choices])

    graph = types.SimpleNamespace(adj=A1, mask=np.ones(n_ops, np.float32),
                                  sizes=[len(PRECISIONS)] * n_ops)
    if ensemble > 0:
        ens, _hist = training.fit_ensemble(two, tr, tc, n_members=ensemble,
                                           device=dev)
        metrics = training.evaluate_ensemble(ens, ds, te, device=dev)
        predicts, _ = engine_lib._member_predicts(ens, graph, featurize, dev,
                                                  PARITY_ATOL, CHUNK)
    else:
        params = training.fit_two_stage(two, tr, tc, device=dev)
        metrics = training.evaluate(two, params, ds, te, device=dev)
        predicts = [engine_lib._checked_predict(two, params, graph, featurize,
                                                dev, PARITY_ATOL, CHUNK)[0]]

    def _predict_batch(choices):
        Xq = torch.from_numpy(featurize(choices)).to(dev)
        with torch.no_grad():
            y = torch.stack([fn(Xq) for fn in predicts]).mean(0)
        return ds.denorm_y(y.cpu().numpy())

    predict = engine_lib.SurrogateEngine(_predict_batch, backend="gnn-lm",
                                         chunk_size=CHUNK, fixed_shape=True)
    return metrics, predict


def run_dse(cfg: ArchConfig, shape: ShapeConfig, budget: int = 1500,
            seed: int = 0, max_penalty: float = 6.0):
    """NSGA-III over per-op precisions; returns the Pareto front filtered by
    the quality constraint, plus the bf16 baseline for comparison.

    The roofline oracle is served through a caching `SurrogateEngine`, so
    NSGA's parent re-evaluations are free; engine throughput counters are
    returned under the ``"engine"`` key.
    """
    from repro_torch.core import dse
    from repro_torch.core.engine import SurrogateEngine
    ops, _adj = op_graph(cfg, shape)
    evaluate, evaluate_one = oracle(cfg, shape, ops)
    engine = SurrogateEngine(evaluate, backend="roofline-oracle")
    sizes = [len(PRECISIONS)] * len(ops)
    res = dse.run_nsga(sizes, engine, budget, seed=seed, pop=48)
    base, crit = evaluate_one([0] * len(ops))
    feasible = [(c, o) for c, o in zip(res.pareto_configs, res.pareto_objs)
                if o[2] <= max_penalty]
    feasible.sort(key=lambda co: co[1][0])
    return {"ops": [o["name"] for o in ops],
            "baseline": {"time": base[0], "hbm_gb": base[1],
                         "critical_op": ops[crit]["name"]},
            "pareto": feasible,
            "best": feasible[0] if feasible else None,
            "engine": engine.stats.as_dict()}
