"""Step functions and input specs of the LM stack: the port of
`repro.launch.steps` on one card (`input_specs`, `make_train_step`,
`make_prefill_step`, `make_decode_step`). The reference's sharding plans
and its tensor-parallel step (``tp_train_step``) are multi-card work
(ROADMAP queue 1). Steps take tensors and run where the tensors live."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import decoding, transformer
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import adamw


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every input a step of ``shape.kind`` takes, in
    the reference's order: tokens, labels (training), the VLM's vision
    embeddings and M-RoPE positions, Whisper's encoder frames."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32)}
    specs = {"tokens": ((B, S), i32)}
    if shape.kind == "train":
        specs["labels"] = ((B, S), i32)
    if cfg.n_vision_tokens:
        specs["vision_embeds"] = ((B, cfg.n_vision_tokens, cfg.d_model),
                                  bf16)
        if cfg.mrope_sections:
            specs["positions"] = ((B, S, 3), i32)
    if cfg.enc_dec:
        specs["enc_frames"] = ((B, cfg.enc_len, cfg.d_model), bf16)
    return specs


def micro_batches(batch: Dict[str, torch.Tensor], accum: int):
    """The reference's split of a batch into ``accum`` micro-batches:
    (B, ...) reshaped to (B/accum, accum, ...) and the accum axis moved
    to the front, so micro-batch j holds rows j, j + accum, ... (not a
    contiguous block)."""
    return [{k: v[j::accum] for k, v in batch.items()}
            for j in range(accum)]


def make_train_step(cfg: ArchConfig, shape: ShapeConfig,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the reference's ``train_step`` on one card.

    ``params`` are float32 master parameters (leaf tensors; the step sets
    ``requires_grad`` on them while it differentiates, and clears it
    after), cast to ``cfg.dtype`` inside
    `transformer.loss_fn`. With ``shape.grad_accum`` = A > 1 the batch is
    split as `micro_batches` does, each micro-batch's loss (averaged over
    its own labels) is differentiated in turn with the float32 gradients
    summed in the leaves' ``.grad``, and the step takes the mean of the A
    losses and gradients; metrics["moe_aux"] then reads 0, as the
    reference's does. `adamw.update` then writes the parameters and the
    moments in place. The metrics are tensors on the parameters' device
    ("loss", "moe_aux", "grad_norm", "lr"): reading one waits for the
    step."""
    lr_fn = adamw.cosine_schedule(base_lr, warmup, total_steps)
    accum = max(shape.grad_accum, 1)

    def train_step(params, opt_state, batch):
        flat = tree_leaves(params)
        for p in flat:
            p.requires_grad_(True)
            p.grad = None
        losses = []
        try:
            for mb in micro_batches(batch, accum):
                total, m = transformer.loss_fn(cfg, params, mb)
                total.backward()
                losses.append(m["loss"].detach())
        finally:
            grads = []
            for p in flat:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = None
                p.requires_grad_(False)
                grads.append(g)
        if accum == 1:
            metrics = {"loss": losses[0], "moe_aux": m["moe_aux"].detach()}
        else:
            grads = [g.div_(accum) for g in grads]
            metrics = {"loss": sum(losses) / accum,
                       "moe_aux": torch.zeros_like(losses[0])}
        _, opt_state, om = adamw.update(grads, opt_state, flat, lr_fn)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: int = 0):
    """prefill_step(params, batch) -> (last logits (B,V), cache); the
    cache holds ``max(max_len, S)`` slots in its full-attention layers."""
    def prefill_step(params, batch):
        return decoding.prefill(cfg, params, batch, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """decode_step(params, cache, tokens (B,1), step, row=None) ->
    (logits (B,1,V), cache), the cache (its batch row ``row``, every row
    if None) updated in place."""
    def decode_step(params, cache, tokens, step, row=None):
        return decoding.decode_step(cfg, params, cache, tokens, step, row)
    return decode_step
