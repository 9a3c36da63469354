"""The benchmark's own arithmetic: model FLOPs from a configuration's
shapes, attention pairs, the operations and bytes of the port's kernels
K3 (`flash_attention`) and K4 (`ssm_scan`), and the card's published
peaks. Frozen from `chip_smoke.py` (`fa_pairs`, `bound_ms`, the K3 and K4
counts of its kernel phases, the data-sheet peaks) so that a change to
the program cannot move the yardstick.
"""
from __future__ import annotations

from typing import List, Tuple

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, n_flops: float,
            peak: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """The least time the card could take: (seconds, what bounds it)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(Sq: int, Sk: int, causal: bool = True,
                    window: int = 0) -> int:
    """Query-key pairs: under ``causal`` query i sits at key position
    Sk - Sq + i and reads the keys up to it, the last ``window`` of them
    where a window is given; else all Sq x Sk."""
    if not causal:
        return Sq * Sk
    if not window or window >= Sk:
        return Sq * (Sk - Sq) + Sq * (Sq + 1) // 2
    return sum(min(p + 1, window) for p in range(Sk - Sq, Sk))


def layer_windows(conf: dict) -> List[int]:
    """Each layer's attention window (0: none): a hybrid stack's global
    layers, every ``global_attn_every``-th from layer 0, have none."""
    w, every = conf.get("swa_window", 0), conf.get("global_attn_every", 0)
    return [0 if (not w or (every and i % every == 0)) else w
            for i in range(conf["n_layers"])]


def block_macs_per_token(conf: dict) -> int:
    """Multiply-adds of one token through every block's weight products
    (attention's q, k, v, o; the SSM heads' five projections in the
    hybrid family; the SwiGLU MLP)."""
    d, H, KV, D = (conf["d_model"], conf["n_heads"], conf["n_kv_heads"],
                   conf["head_dim"])
    attn = d * H * D + 2 * d * KV * D + H * D * d
    mlp = 3 * d * conf["d_ff"]
    ssm = 0
    if conf["family"] == "hybrid":
        N = conf["ssm_state"]
        ssm = 2 * d * H * D + d * 2 * N + d * H + H * D * d
    return conf["n_layers"] * (attn + ssm + mlp)


def forward_flops(conf: dict, batch: int, seq: int,
                  head_positions: int) -> int:
    """FLOPs of one forward of ``batch`` x ``seq`` tokens: every weight
    product, the attention products (4 x head_dim per query-key pair and
    head) and the head at ``head_positions`` positions a row. Elementwise
    work (norms, rotations, softmax, the SSM recurrence) is not counted."""
    products = 2 * batch * seq * block_macs_per_token(conf)
    head = 2 * batch * head_positions * conf["d_model"] * conf["vocab_size"]
    pairs = sum(attention_pairs(seq, seq, True, w)
                for w in layer_windows(conf))
    attention = 4 * batch * conf["n_heads"] * conf["head_dim"] * pairs
    return products + head + attention


def prefill_flops(conf: dict, batch: int, seq: int) -> int:
    """A prefill: the forward, the head at the last position."""
    return forward_flops(conf, batch, seq, head_positions=1)


def train_flops(conf: dict, batch: int, seq: int) -> int:
    """A training step: the forward with the head at every position, and
    the backward at twice the forward (a recompute is not counted)."""
    return 3 * forward_flops(conf, batch, seq, head_positions=seq)


def k3_cost(B: int, H: int, KV: int, Sq: int, Sk: int, D: int,
            causal: bool = True, elem_bytes: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K3 call: 2 products of 2 D FLOPs a pair and
    head; q and o once, k and v once."""
    flops = 4 * B * H * D * attention_pairs(Sq, Sk, causal)
    n_bytes = elem_bytes * (2 * B * H * Sq * D + 2 * B * KV * Sk * D)
    return flops, n_bytes


def k3_layers(conf: dict, seq: int) -> int:
    """Layers whose attention of ``seq`` positions runs on K3: those with
    no window in effect (none, or one of ``seq`` keys or more)."""
    return sum(1 for w in layer_windows(conf) if not w or w >= seq)


def k3_bound_s(conf: dict, batch: int, seq: int) -> float:
    """The least time of one forward's K3 calls, bf16."""
    flops, n_bytes = k3_cost(batch, conf["n_heads"], conf["n_kv_heads"],
                             seq, seq, conf["head_dim"])
    return k3_layers(conf, seq) * bound_s(n_bytes, flops)[0]


def k4_cost(T: int, D: int, decay_cols: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one K4 call over T steps and D float32 channels
    with a (T, decay_cols) decay: a multiply and an add a channel and
    step; the decay, b and ys once, y0 and y_final once."""
    return 2 * T * D, 4 * (decay_cols * T + 2 * T * D + 2 * D)
