"""Step functions, input specs and sharding plans of the LM stack: the
port of `repro.launch.steps`.

`input_specs`, `make_train_step`, `make_prefill_step` and
`make_decode_step` without a mesh take tensors and run where the tensors
live (one card, or the CPU). `plan` returns the reference's
``(step_fn, arg_specs, in_placements, out_placements, donate)`` for a
mesh: its placements are the reference's `PartitionSpec`s
(`distributed.meshes.param_shardings`, `cache_shardings`,
`data_sharding`) and its steps take and return `ShardedTensor`s placed
by them, run over the mesh by `distributed.spmd` (every family, under
every preset, the context-parallel one included).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import meshes as M
from repro_torch.distributed import spmd
from repro_torch.models import decoding, transformer
from repro_torch.models.layers import tree_leaves, tree_map
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


def batch_shardings(mesh: M.Mesh, cfg: ArchConfig, shape: ShapeConfig,
                    specs: Dict[str, Any]) -> Dict[str, M.Placement]:
    """Every input's placement: rows over the batch axes
    (`meshes.data_sharding`)."""
    return {name: M.data_sharding(mesh, shp[0], len(shp))
            for name, (shp, _dt) in specs.items()}


def micro_batches(batch: Dict[str, torch.Tensor], accum: int):
    """The reference's split of a batch into ``accum`` micro-batches:
    (B, ...) reshaped to (B/accum, accum, ...) and the accum axis moved
    to the front, so micro-batch j holds rows j, j + accum, ... (not a
    contiguous block)."""
    return [{k: v[j::accum] for k, v in batch.items()}
            for j in range(accum)]


def make_train_step(cfg: ArchConfig, shape: ShapeConfig,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_shardings=None,
                    compute_shardings=None, context_parallel: bool = False):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the reference's ``train_step`` on one card; with
    ``grad_shardings`` (the storage placements, a tree of `Placement`s)
    the step over their mesh (`_mesh_train_step`), and with
    ``compute_shardings`` too the reference's ``tp_train_step`` (with
    ``context_parallel``, the cp preset's: `spmd.loss_fn`'s ``cp``).

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
    if grad_shardings is not None:
        return _mesh_train_step(cfg, shape, lr_fn, accum, grad_shardings,
                                compute_shardings, context_parallel)

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


# --------------------------------------------------------------------------
# steps over a mesh
# --------------------------------------------------------------------------

def _mesh_of(placements) -> M.Mesh:
    return tree_leaves(placements)[0].mesh


def _unwrap(tree):
    """Each placed leaf's one piece (a mesh of one position)."""
    return tree_map(lambda x: x.pieces[0] if M.is_placed(x) else x, tree)


def _pieces(xs):
    """Every piece held of the placed tensors ``xs``, leaf by leaf."""
    return [p for x in xs for p in x.pieces if p is not None]


def init_opt(params):
    """`adamw.init` of ``params``, placed on a mesh or not: placed
    parameters get zero float32 moments placed like them and the step
    replicated on their mesh."""
    flat = tree_leaves(params)
    if not M.is_placed(flat[0]):
        return adamw.init(params)

    def zeros():
        return tree_map(lambda x: M.map_placed(
            lambda t: torch.zeros_like(t, dtype=torch.float32), x), params)
    step = M.place(torch.zeros((), dtype=torch.int32),
                   M.replicated(flat[0].mesh))
    return adamw.AdamWState(step=step, m=zeros(), v=zeros())


def place_batch(mesh: M.Mesh, cfg: ArchConfig, shape: ShapeConfig, batch):
    """A batch of tensors (or NumPy arrays) placed by `batch_shardings`
    in the specs' types; placed inputs are kept."""
    specs = input_specs(cfg, shape)
    pls = batch_shardings(mesh, cfg, shape, specs)
    out = {}
    for k, v in batch.items():
        if M.is_placed(v):
            out[k] = v
            continue
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        out[k] = M.place(t.to(specs[k][1] if k in specs else torch.int32),
                         pls[k])
    return out


def _mesh_train_step(cfg, shape, lr_fn, accum, psh, csh, cp):
    """The step over the mesh of ``psh``. Parameters, moments and
    gradients are placed by ``psh`` (float32 gradient accumulators pinned
    to the storage placement); on a mesh of one position the one-card
    step runs on the pieces.

    Without ``csh`` (the reference's ``train_step``, preset "baseline")
    each layer's weights are gathered and cast inside the loss
    (`spmd.Layout.view`, under remat with the block), and the backward
    reduce-scatters their gradients onto the storage pieces, one
    micro-batch at a time. With ``csh`` (``tp_train_step``) the float32
    masters are cast to the compute type and gathered onto ``csh`` once
    per step, outside the micro-batch loop; each micro-batch's backward
    accumulates the compute copies' gradients (in their type, as the
    reference's scan does), and the gather's transpose reduce-scatters
    them onto the storage placement once per step (ZeRO-3). The compute
    type is ``cfg.dtype`` (bf16 for every config of ``configs/``; the
    reference casts to bf16 whatever the config's type)."""
    mesh = _mesh_of(psh)
    one_card = make_train_step(cfg, shape) if mesh.size == 1 else None
    dt = getattr(torch, cfg.dtype)

    def step(params, opt_state, batch):
        if mesh.size == 1:
            st = opt_state.step
            p1, o1, metrics = one_card(_unwrap(params), _unwrap(opt_state),
                                       _unwrap(batch))
            st.pieces[0] = o1.step
            return params, adamw.AdamWState(st, opt_state.m,
                                            opt_state.v), metrics
        batch = place_batch(mesh, cfg, shape, batch)
        rows = batch["tokens"]
        n_rows = rows.first.shape[0]
        if n_rows % accum:
            raise ValueError(f"grad_accum={accum} does not divide the "
                             f"{n_rows} rows a position holds")
        micro = [{k: M.map_placed(lambda t, j=j: t[j::accum], v)
                  for k, v in batch.items()} for j in range(accum)]
        flat = tree_leaves(params)
        for p in _pieces(flat):
            p.requires_grad_(True)
            p.grad = None
        losses = []
        try:
            if csh is None:
                for mb in micro:
                    total, m = spmd.loss_fn(cfg, mesh, params, mb, cp)
                    total.backward()
                    losses.append(m["loss"].detach())
            else:
                pc = M.place_tree(params, csh, dt)
                det = tree_map(lambda x: M.ShardedTensor(
                    x.placement, x.shape,
                    [None if p is None else p.detach().requires_grad_(True)
                     for p in x.pieces]), pc)
                for mb in micro:
                    total, m = spmd.loss_fn(cfg, mesh, det, mb, cp)
                    total.backward()
                    losses.append(m["loss"].detach())
                # the gather's transpose, one leaf at a time (each compute
                # gradient is freed as its storage gradient lands)
                for a, b in zip(tree_leaves(pc), tree_leaves(det)):
                    outs, gouts = [], []
                    for pa, pb in zip(a.pieces, b.pieces):
                        if pa is None:
                            continue
                        if pa.requires_grad and pb.grad is not None:
                            outs.append(pa)
                            gouts.append(pb.grad)
                        pb.grad = None
                    if outs:
                        torch.autograd.backward(outs, gouts)
                    del outs, gouts
                del det, pc
        finally:
            grads = []
            for x in flat:
                gp = []
                for p in x.pieces:
                    if p is None:
                        gp.append(None)
                        continue
                    gp.append(p.grad if p.grad is not None
                              else torch.zeros_like(p))
                    p.grad = None
                    p.requires_grad_(False)
                grads.append(M.sync_replicas(
                    M.ShardedTensor(x.placement, x.shape, gp)))
        if accum > 1:
            for p in _pieces(grads):
                p.div_(accum)
        loss = sum(losses) / accum
        # the one-card step's: the micro-batch's aux, 0 with accumulation
        metrics = {"loss": loss, "moe_aux": (
            m["moe_aux"].detach() if accum == 1 else torch.zeros_like(loss))}
        # AdamW is elementwise: it updates the pieces, in leaf order
        st = opt_state.step
        _, o1, om = adamw.update(
            _pieces(grads), adamw.AdamWState(
                st.first, _pieces(tree_leaves(opt_state.m)),
                _pieces(tree_leaves(opt_state.v))),
            _pieces(flat), lr_fn, grad_norm=M.global_norm(grads))
        metrics.update(om)
        return params, adamw.AdamWState(M.place(o1.step, st.placement),
                                        opt_state.m, opt_state.v), metrics

    return step


def resolve_rules(name: str) -> Dict[str, Any]:
    """A named sharding-rule preset (`meshes.PRESETS`)."""
    return M.PRESETS[name]


def serve_param_specs(cfg: ArchConfig):
    """(the parameter table, its shapes as bf16 meta tensors): serving
    stores parameters in bf16."""
    table = transformer.build_param_table(cfg)
    return table, table.shapes(torch.bfloat16)


def plan(cfg: ArchConfig, shape: ShapeConfig, mesh: M.Mesh,
         rules: Optional[Dict[str, Any]] = None):
    """Returns (step_fn, arg_specs, in_placements, out_placements,
    donate), the reference's plan: ``rules`` is a preset dict
    {"storage": ..., "compute": ...} (`meshes.PRESETS`) or a bare
    storage-rules dict. Argument specs are meta tensors, (shape, dtype)
    pairs for the batch. Training stores float32 parameters and moments
    by the storage rules (gradients pinned there) and, with compute
    rules, computes on them (`tp_train_step`); serving stores bf16
    parameters by the compute rules where the preset has them, and the
    cache by `meshes.cache_shardings` (int8 with ``kv_int8``)."""
    if rules is None:
        rules = M.PRESETS["baseline"]
    if "storage" not in rules:
        rules = {"storage": rules, "compute": None}
    storage, compute = rules["storage"], rules["compute"]
    cp = bool(rules.get("context_parallel"))
    table = transformer.build_param_table(cfg)
    logical = table.logical_axes()
    specs = input_specs(cfg, shape)
    bsh = batch_shardings(mesh, cfg, shape, specs)
    rep = M.replicated(mesh)
    hd = cfg.resolved_head_dim

    if shape.kind == "train":
        pshapes = table.shapes()
        psh = M.param_shardings(mesh, logical, pshapes, storage, head_dim=hd)
        csh = (M.param_shardings(mesh, logical, pshapes, compute,
                                 head_dim=hd) if compute else None)
        opt_shapes = adamw.AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            m=pshapes, v=table.shapes())
        osh = adamw.AdamWState(step=rep, m=psh, v=psh)
        step_fn = make_train_step(cfg, shape, grad_shardings=psh,
                                  compute_shardings=csh,
                                  context_parallel=cp)
        metrics_sh = {"loss": rep, "moe_aux": rep, "grad_norm": rep,
                      "lr": rep}
        return (step_fn, (pshapes, opt_shapes, specs), (psh, osh, bsh),
                (psh, osh, metrics_sh), (0, 1))

    table, pshapes = serve_param_specs(cfg)
    # serving has no optimizer state: parameters are stored in the
    # compute placement when the preset has one (no per-step gathers)
    psh = M.param_shardings(mesh, logical, pshapes, compute or storage,
                            head_dim=hd)
    # the hybrid and RWKV caches have no int8 form: the reference's
    # cache_spec ignores the flag for them
    int8 = bool(rules.get("kv_int8")) and decoding.has_int8_cache(cfg)
    if shape.kind == "prefill":
        # a prefill returns a bf16 cache under every preset, as the
        # reference's does (`spmd.quantize_cache` makes the int8 one)
        cspec = spmd.meta_tree(decoding.cache_spec(cfg, shape))
        csh = M.cache_shardings(mesh, cspec)
        logits_sh = M.data_sharding(mesh, shape.global_batch, 2)

        def prefill_mesh(params, batch):
            # the tokens and, for the VLM, its vision embeds and positions
            batch = place_batch(mesh, cfg, shape, batch)
            return spmd.prefill(cfg, mesh, params, batch, cp=cp)

        return (prefill_mesh, (pshapes, specs), (psh, bsh), (logits_sh, csh),
                ())

    cspec = spmd.meta_tree(decoding.cache_spec(cfg, shape, kv_int8=int8))
    csh = M.cache_shardings(mesh, cspec)
    tok = ((shape.global_batch, 1), torch.int32)
    tok_sh = M.data_sharding(mesh, shape.global_batch, 2)
    step_scalar = ((), torch.int32)
    logits_sh = M.data_sharding(mesh, shape.global_batch, 3)

    def decode_mesh(params, cache, tokens, step):
        if not M.is_placed(tokens):
            tokens = M.place(torch.as_tensor(tokens, dtype=torch.int32),
                             tok_sh)
        return spmd.decode_step(cfg, mesh, params, cache, tokens, int(step))

    return (decode_mesh, (pshapes, cspec, tok, step_scalar),
            (psh, csh, tok_sh, rep), (logits_sh, csh), (1,))
