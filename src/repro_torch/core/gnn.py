"""GNN model zoo in PyTorch: GCN, GraphSAGE ("GSAE"), GAT, MPNN.

Graphs are small (<= 32 nodes after merging), so every layer works on a
batched DENSE adjacency. Parameters are plain dicts of tensors in the
layout of `repro.core.gnn` (``{"layers": [{"w_self", "w_nbr", "b",
...}], "ro_w1", "ro_b1", "ro_w2", "ro_b2"}``), so weights carry across
unchanged (`models.params_from_numpy`).

Paper setup: 5 layers, hidden 300 (Sec IV-A).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch import device as device_lib


@dataclass(frozen=True)
class GNNConfig:
    arch: str = "gsae"             # gcn | gsae | gat | mpnn
    n_layers: int = 5
    hidden: int = 300
    feature_dim: int = 21
    out_dim: int = 1               # regression heads / node classes
    readout: str = "meanmax"       # graph-level readout
    node_level: bool = False       # True -> per-node logits (stage 1)
    dropout: float = 0.1


def _dense(gen: torch.Generator, fan_in: int, fan_out: int, device
           ) -> torch.Tensor:
    """uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)), as the reference."""
    s = 1.0 / math.sqrt(fan_in)
    u = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float32,
                   device=gen.device)
    return (u * (2 * s) - s).to(device)


def init_params(gen: torch.Generator, cfg: GNNConfig, device=None) -> Dict:
    """Random parameters from ``gen`` (the reference's distribution:
    uniform +-1/sqrt(fan_in) weights, zero biases)."""
    dev = device_lib.resolve(device)
    params: Dict = {"layers": []}
    dim = cfg.feature_dim
    for _ in range(cfg.n_layers):
        layer = {"w_self": _dense(gen, dim, cfg.hidden, dev),
                 "w_nbr": _dense(gen, dim, cfg.hidden, dev),
                 "b": torch.zeros(cfg.hidden, device=dev)}
        if cfg.arch == "gat":
            layer["attn_src"] = _dense(gen, cfg.hidden, 1, dev)
            layer["attn_dst"] = _dense(gen, cfg.hidden, 1, dev)
        if cfg.arch == "mpnn":
            layer["w_msg"] = _dense(gen, 2 * dim, cfg.hidden, dev)
            layer["w_upd"] = _dense(gen, dim + cfg.hidden, cfg.hidden, dev)
        params["layers"].append(layer)
        dim = cfg.hidden
    ro_in = dim if cfg.node_level else 2 * dim
    params["ro_w1"] = _dense(gen, ro_in, cfg.hidden, dev)
    params["ro_b1"] = torch.zeros(cfg.hidden, device=dev)
    params["ro_w2"] = _dense(gen, cfg.hidden, cfg.out_dim, dev)
    params["ro_b2"] = torch.zeros(cfg.out_dim, device=dev)
    return params


def _layer(cfg: GNNConfig, lp: Dict, adj, h, mask):
    """adj: (B,N,N) normalized; h: (B,N,D); mask: (B,N)."""
    if cfg.arch == "gcn":
        out = adj @ (h @ lp["w_nbr"]) + h @ lp["w_self"]
    elif cfg.arch == "gsae":                 # GraphSAGE-mean
        deg = torch.clamp(adj.sum(-1, keepdim=True), min=1e-6)
        mean_nbr = (adj @ h) / deg
        out = h @ lp["w_self"] + mean_nbr @ lp["w_nbr"]
    elif cfg.arch == "gat":
        hs = h @ lp["w_nbr"]
        a_src = hs @ lp["attn_src"]          # (B,N,1)
        a_dst = hs @ lp["attn_dst"]
        logits = torch.nn.functional.leaky_relu(
            a_src + a_dst.transpose(1, 2), 0.2)
        logits = torch.where(adj > 0, logits, -1e30)
        alpha = torch.softmax(logits, dim=-1)
        alpha = torch.where(adj > 0, alpha, 0.0)
        out = alpha @ hs + h @ lp["w_self"]
    elif cfg.arch == "mpnn":
        B, N, D = h.shape
        hi = h[:, :, None, :].expand(B, N, N, D)
        hj = h[:, None, :, :].expand(B, N, N, D)
        msg = torch.relu(torch.cat([hi, hj], -1) @ lp["w_msg"])
        agg = (msg * adj[..., None]).sum(2)
        out = torch.cat([h, agg], -1) @ lp["w_upd"]
    else:
        raise ValueError(cfg.arch)
    return torch.relu(out + lp["b"]) * mask[..., None]


def readout(cfg: GNNConfig, params: Dict, h, mask):
    """Node-level logits (B,N,out) or the mean+max graph readout (B,out)."""
    if cfg.node_level:
        out = torch.relu(h @ params["ro_w1"] + params["ro_b1"])
        return out @ params["ro_w2"] + params["ro_b2"]
    denom = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    mean = (h * mask[..., None]).sum(1) / denom
    mx = torch.where(mask[..., None] > 0, h, -1e30).amax(1)
    g = torch.relu(torch.cat([mean, mx], -1) @ params["ro_w1"]
                   + params["ro_b1"])
    return g @ params["ro_w2"] + params["ro_b2"]


def draw_keep(cfg: GNNConfig, generator: torch.Generator, B: int, N: int,
              lead: tuple = ()) -> torch.Tensor:
    """Dropout keep masks for one training forward pass, drawn from
    ``generator`` on its device: (*lead, n_layers, B, N, hidden)
    booleans, True where an activation is kept."""
    shape = lead + (cfg.n_layers, B, N, cfg.hidden)
    return torch.rand(shape, generator=generator,
                      device=generator.device) >= cfg.dropout


def layers(cfg: GNNConfig, params: Dict, adj, x, mask, *,
           keep: Optional[torch.Tensor] = None):
    """The message-passing stack: (B, N, hidden) node states before the
    readout.

    ``keep`` gates dropout: training passes one boolean mask per layer,
    ``(n_layers, B, N, hidden)`` (`draw_keep`); inference passes
    nothing and is deterministic regardless of ``cfg.dropout``. Inverted
    scaling (``/ (1 - p)``) keeps activations unbiased."""
    h = x * mask[..., None]
    for i, lp in enumerate(params["layers"]):
        h = _layer(cfg, lp, adj, h, mask)
        if keep is not None and cfg.dropout > 0:
            h = h * keep[i] / (1 - cfg.dropout)
    return h


def apply(cfg: GNNConfig, params: Dict, adj, x, mask, *,
          keep: Optional[torch.Tensor] = None):
    """Returns (B, N, out) for node-level or (B, out) for graph-level:
    `layers` (``keep`` as there), then `readout`."""
    return readout(cfg, params, layers(cfg, params, adj, x, mask, keep=keep),
                   mask)
