"""Every LM family over a (data, model) mesh, single-controller: the
dense, mixture-of-experts, hybrid, VLM, encoder-decoder (Whisper) and
attention-free (RWKV-6) ones.

No file of the JAX package corresponds to this one: there, GSPMD
partitions `repro.models.transformer.loss_fn` and
`repro.models.decoding` by the shardings of `repro.launch.steps.plan`.
Here one process runs the same functions piece by piece over the
positions of a `distributed.meshes.Mesh`, and the cross-position work is
`meshes`' collectives (copies and float32 sums in mesh order).

The split (Megatron over "model", data parallelism over ("pod", "data")):
- Batch rows follow the batch's placement (`steps.batch_shardings`);
  every position runs its rows with the one-card block functions.
- Model shard r of m owns query heads [r·H/m, (r+1)·H/m) and the KV
  heads h // G of those heads, which it hands to K3
  (`models.attention.attention`) at that slice; and ff columns
  [r·f/m, (r+1)·f/m). The products into heads and ff columns are
  column-parallel; ``wo`` and ``w_down`` are row-parallel: each shard's
  partial product is float32 (`mm_f32`), and `meshes.all_reduce` sums
  the partials in float32 before the one rounding to the compute type
  (bf16 partials summed in bf16 would make the result depend on the
  mesh). When H or the group mapping does not split evenly (H % m, or
  neither of H/m and G divides the other), every model shard computes
  all heads; when m does not divide f, all ff columns.
- Whatever the preset, each shard computes only its own heads and ff
  columns: the presets differ only in where the weights are stored and
  when they are gathered. A layer's weights are read through `views`:
  each leaf is `meshes.reshard`-ed to the placement its shard needs
  (its model block where the stored block is that block, else whole),
  cast to the compute type, and cut to the shard's range locally.
  `reshard`'s transpose reduce-scatters the gradients onto the stored
  placement.
- The embedding and the LM head keep the vocabulary whole on every
  shard (Granite's 49,155 divides by no model axis); the chunked NLL
  runs on each model shard's block of the sequence.
- The loss is global: the NLL and the count of labels >= 0 are summed
  over every position before the division.

Serving (`prefill`, `decode_step`) holds the cache under
`meshes.cache_shardings`: batch over data, the slots over "model".
Prefill computes each shard's heads as training does, then writes every
shard's block of the sequence. A decode step too projects each shard's
own heads; it gathers the queries across "model" and the new token's KV
heads onto the shard that owns slot ``step % W``, which writes them;
each shard attends over its own slots with every head (unnormalised
output, row max and row sum in float32), merged across "model" by
log-sum-exp; and ``wo`` is row-parallel, as in training.

The context-parallel preset ("cp", `launch.steps.plan`): the reference
constrains attention's queries to be sequence-sharded over "model" and
its keys and values whole, where S divides by the model axis and the
call has more than one query; elsewhere (a decode step, S % m) attention
runs as under tp. The result is the unsplit step's. Here model shard r
of m normalises and projects only its block of positions [r·S/m,
(r+1)·S/m), with every head (the attention weights gathered whole, so
no projection is computed twice); the blocks' K and V are all-gathered
over "model", and K3 (`models.attention.attention`) takes the shard's
S/m queries over the keys [0, (r+1)·S/m), the causal mask aligned
bottom-right; ``wo`` takes the shard's block, and the blocks' outputs
are all-gathered over "model", so that the MLP (or the experts) runs as
under tp. The last block reads m times the keys of the first: the
shards' attention is not balanced.

The mixture-of-experts family (expert parallelism): the experts split
over "model" (``"experts": "model"`` in every rule table), shard r
owning experts [r·E/m, (r+1)·E/m) where m divides E (else every shard
runs every expert). The router is whole on every shard, and a shard's
tokens are its data rows, the same on every model shard, so every model
shard routes alike (`models.moe.choose`). What is global is the capacity
bookkeeping: C is the whole batch's (`moe.capacity` of the global
micro-batch's B·S tokens in training, of B in decode), and an
assignment's place is its rank in the whole batch's order (its rows in
mesh order, then positions, then the k choices): each data position adds
the per-expert counts of the row blocks before its own (an exclusive
scan over the batch axes, `_over_rows`) before the places are compared
with C (`moe.place`). The load-balancing loss takes the router's mean
probabilities and the counts over the whole batch too. Dispatch, the
experts' products and the combine are local (`moe.expert_partial`): a
shard's buffer holds its experts' C places, and its gated outputs are a
float32 partial, summed over "model" before the one rounding, as the
row-parallel products are. No all-to-all is needed: the tokens are
replicated over "model" (the reference's note on an all-to-all describes
XLA's lowering of its scatter, not a semantic). The MoE layer's stages
keep `models.moe.SPANS` (`repro_torch.spans`), so a profile splits the
layer as on one card.

The hybrid family (Hymba): every layer runs attention and an SSM head
bank in parallel on the same normed input. The SSM's heads split as the
attention's query heads do (`Layout.heads`): model shard r scans the
heads of its query-head range with K4 (`ops.ssm_scan`, through
`models.ssm.ssm_heads`), over the whole sequence under every preset (a
scan takes no block of positions; the reference constrains only
attention under cp); where the group mapping makes attention compute
every head, the SSM computes every head too. ``in_proj`` and
``gate_proj`` are cut on their columns by the shard's heads (Dh columns
each), ``out_proj`` on its rows, and ``dt_proj``'s columns, ``a_log``
and ``d_skip`` (stored replicated) locally to the shard's heads;
``bc_proj`` stays whole, so every shard computes the same B_t and C_t.
``wo`` and ``out_proj`` are both row-parallel: the two float32 partials
are stacked and summed over "model" in one all-reduce, each rounded once
to the compute type, before the fuse ``x + 0.5 (f0 a + f1 s)`` (one
float32 partial of the fused sum would round otherwise than the unsplit
step). Under cp the attention's blocks are all-gathered first and then
fused with the SSM's output computed as under tp. The hybrid cache holds
per layer its own ring of W_i slots (the window in SWA layers, the whole
length in global ones), placed by `meshes.cache_shardings` (over "model"
where W_i divides), and the SSM state (L, B, H, Dh, N) float32, cut by H
where H divides. Prefill writes position p of each layer in slot
p % W_i and reshards each layer's state from the shards' heads; a decode
step finds, per layer, the shard that owns slot ``step % W_i``, and
reads each shard's state at its heads (resharded where the cache's
placement differs, as at H=12, KV=3 on m=2) and writes it back.

The VLM family (Qwen2-VL): dense blocks over M-RoPE positions (B, S, 3)
with the vision embeds in place of the first positions
(`models.transformer.embed_inputs`); both inputs follow the batch's
placement, under cp each block takes its slice of the positions, and a
decode step puts ``step`` on all three position sections.

The encoder-decoder family (Whisper): the decoder's positions add the
sinusoidal table (`transformer.embed_inputs`, each position on its
rows). The encoder runs over ``enc_frames`` placed with the batch's
rows: its blocks are the decoder's without the cross-attention, each
shard at its heads with a full mask (K3) and its ff columns, ending in
``enc_final_norm``; each position keeps the encoder output of its rows,
whole over "model". A decoder layer's cross-attention takes the shard's
query heads and its KV heads of that output (``xattn/wq`` and
``xattn/wk``/``wv`` cut on their columns, K3 at Sq < Sk under a full
mask), and ``xattn/wo`` is row-parallel, its float32 partials summed and
rounded once. Under cp the encoder's self-attention runs context-
parallel under a full mask (each block's S/m queries over all S keys)
where the model axis divides its length, and as under tp elsewhere; the
decoder's self-attention as the dense family's; the cross-attention as
under tp. The cache adds the cross keys and values (L, B, Se, KV, D)
bf16, computed a second time from the encoder's output after the
forward, as the reference computes them; `meshes.cache_shardings` cuts
Se over "model" where it divides, so each position takes its rows and
Se block of every KV head from the shards that computed them. They stay
bf16 under serve8 and kv8 (only the self-attention ring is int8). A
decode step adds the sinusoidal table at ``step``; its cross-attention
gathers the queries across "model", each shard attends over its Se
block with every head and no mask, and the blocks merge by log-sum-exp,
as the self-attention's slots do.

The attention-free family (RWKV-6): the time mix's head bank splits as
the query heads do (`Layout.heads`; the state is per head, so shard r
runs `models.rwkv.wkv` over its heads with no communication): ``w_r``,
``w_k``, ``w_v``, ``w_g`` and ``w_lora_b`` are cut on their columns,
``w0``, ``ln_g`` and ``u_bonus`` to the shard's heads, ``w_lora_a``,
``c_wr`` and the token-shift mixes stay whole. ``w_o`` is row-parallel;
the channel mix's ``c_wk`` is cut on its ff columns and ``c_wv`` on its
rows, its float32 partial summed and rounded once before the
``sigmoid(xr @ c_wr)`` gate multiplies it, as the unsplit ``k @ c_wv``
is. Every shard computes the token shifts of its rows. There is no
attention, so cp is tp. The cache's state (L, B, H, Dk, Dv) float32 is
cut by H where H divides (each shard's heads when they split, else
resharded, as the hybrid family's SSM state is); ``x_tm`` and ``x_cm``
(L, B, d) follow the rows, and a decode step writes every position's
piece of them.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import meshes as M
from repro_torch.models import attention as attn_lib
from repro_torch.models import decoding, moe, transformer
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (activation, apply_rope, fdot,
                                       rms_norm, rope_angles,
                                       sinusoidal_positions, wide)
from repro_torch.spans import span

FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio", "ssm")


def supports(cfg: ArchConfig) -> bool:
    """Whether this module runs ``cfg`` on a mesh of more than one
    position: every family of `FAMILIES`, under every preset (the
    context-parallel one included)."""
    return cfg.family in FAMILIES


def check_supported(cfg: ArchConfig, mesh: M.Mesh) -> None:
    """Raise `NotImplementedError` for a family this module does not know
    (`supports`) on a mesh of more than one position. Nothing falls back
    to one device."""
    if mesh.size > 1 and not supports(cfg):
        raise NotImplementedError(
            f"{cfg.name}: no split of the {cfg.family!r} family over a "
            f"mesh of {mesh.size} positions")


# --------------------------------------------------------------------------
# the float32 row-parallel product
# --------------------------------------------------------------------------

def _mm_out_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 (N, K) @ w (K, F) with float32 products and sums, float32 out:
    ``torch.mm(..., out_dtype=float32)`` on the card (no float32 copies
    of the operands), the float32 copies' product on the CPU. float32
    and float64 operands keep their type."""
    if x2.dtype in (torch.float32, torch.float64):
        return x2 @ w.to(x2.dtype)
    if x2.is_cuda:
        return torch.mm(x2, w.to(x2.dtype), out_dtype=torch.float32)
    return x2.float() @ w.float()


class _MmF32(torch.autograd.Function):
    """The float32 partial of a row-parallel product. The backward is
    `layers.fdot`'s: the gradient in the operands' type through their
    type's products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        shp = x.shape
        return _mm_out_f32(x.reshape(-1, shp[-1]), w).reshape(
            *shp[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wc = w.to(x.dtype)
        gc = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = gc @ wc.T
        if ctx.needs_input_grad[1]:
            gw = (x.reshape(-1, x.shape[-1]).T
                  @ gc.reshape(-1, gc.shape[-1])).to(w.dtype)
        return gx, gw


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, F) as float32 (`_MmF32`)."""
    return _MmF32.apply(x, w)


# --------------------------------------------------------------------------
# the split
# --------------------------------------------------------------------------

# which dim of a per-layer leaf the model axis cuts, and by what range
# ("q": query heads' columns, "kv": key/value heads' columns, "h": query
# heads, one entry each, "ff": ff columns, "experts"); the SSM's and the
# RWKV time mix's heads are the query heads' range; Whisper's encoder
# blocks are cut as the decoder's "attn/" and "mlp/" leaves
_SPLIT = {"attn/wq": (1, "q"), "attn/wk": (1, "kv"), "attn/wv": (1, "kv"),
          "attn/wo": (0, "q"), "attn/bq": (0, "q"), "attn/bk": (0, "kv"),
          "attn/bv": (0, "kv"), "mlp/w_gate": (1, "ff"),
          "mlp/w_up": (1, "ff"), "mlp/w_down": (0, "ff"),
          "moe/w_gate": (0, "experts"), "moe/w_up": (0, "experts"),
          "moe/w_down": (0, "experts"),
          "ssm/in_proj": (1, "q"), "ssm/gate_proj": (1, "q"),
          "ssm/out_proj": (0, "q"), "ssm/dt_proj": (1, "h"),
          "ssm/a_log": (0, "h"), "ssm/d_skip": (0, "h"),
          "xattn/wq": (1, "q"), "xattn/wk": (1, "kv"),
          "xattn/wv": (1, "kv"), "xattn/wo": (0, "q"),
          "rwkv/w_r": (1, "q"), "rwkv/w_k": (1, "q"), "rwkv/w_v": (1, "q"),
          "rwkv/w_g": (1, "q"), "rwkv/w0": (0, "q"), "rwkv/ln_g": (0, "q"),
          "rwkv/w_lora_b": (1, "q"), "rwkv/u_bonus": (0, "h"),
          "rwkv/w_o": (0, "q"), "rwkv/c_wk": (1, "ff"),
          "rwkv/c_wv": (0, "ff")}
# under context parallelism every shard projects every self-attention
# head (the SSM's heads and Whisper's cross-attention split as under tp)
_SPLIT_CP = {k: v for k, v in _SPLIT.items() if not k.startswith("attn/")}


class _Ctx(NamedTuple):
    """What a layer at every position needs of its call: the batch rows'
    spec, each position's rows (lo, hi) of the batch, the batch's rows,
    whether attention runs context-parallel, and the leaves' splits."""
    spec0: Any
    rows: List[Tuple[int, int]]
    n_rows: int
    cp: bool
    splits: Dict[str, Tuple[int, str]]


class Layout:
    """The split of ``cfg`` over ``mesh`` (module docstring)."""

    def __init__(self, cfg: ArchConfig, mesh: M.Mesh, cp: bool = False):
        self.cfg, self.mesh = cfg, mesh
        self.coords = M.positions(mesh)
        self.devs = mesh.device_list()
        self.n = mesh.size
        self.m = mesh.shape.get("model", 1)
        H, KV = cfg.n_heads, cfg.n_kv_heads
        # RWKV's head bank has no KV heads: its heads split alone
        self.G = 1 if cfg.attn_free else H // KV
        hq = H // self.m
        self.split_heads = (self.m > 1 and H % self.m == 0
                            and (hq % self.G == 0 or self.G % hq == 0))
        self.split_ff = self.m > 1 and cfg.d_ff % self.m == 0
        self.split_experts = (cfg.is_moe and self.m > 1
                              and cfg.n_experts % self.m == 0)
        # an attention-free stack has nothing to run context-parallel
        self.cp = cp and self.m > 1 and not cfg.attn_free
        self._want: Dict[tuple, M.PartitionSpec] = {}
        # each position's group over "model" (the positions that hold the
        # same batch rows), in mesh order
        self.group: List[List[int]] = [[] for _ in range(self.n)]
        for grp in M._groups(mesh, ("model",)):
            for i in grp:
                self.group[i] = grp
        # the groups over the batch axes (the positions of one model shard)
        self.data_groups = M._groups(mesh, M.batch_axes(mesh))
        # the positions that run: every one, or a count's (`meshes.Count`)
        self.active = M.active(mesh)
        self.counting = M.counting(mesh)

    def each(self, fn) -> List[Any]:
        """``fn(i)`` at every position that runs (mesh order), None at
        the others."""
        out: List[Any] = [None] * self.n
        for i in self.active:
            out[i] = fn(i)
        return out

    def r(self, i: int) -> int:
        return self.coords[i].get("model", 0)

    def cp_on(self, S: int) -> bool:
        """Whether attention over S positions runs context-parallel: the
        preset's, more than one query, S divisible by the model axis."""
        return self.cp and S > 1 and S % self.m == 0

    def experts(self, i: int) -> Tuple[int, int]:
        """The experts of position i."""
        E = self.cfg.n_experts
        if not self.split_experts:
            return 0, E
        e = E // self.m
        return self.r(i) * e, (self.r(i) + 1) * e

    def ctx(self, tokens: M.ShardedTensor) -> _Ctx:
        """The `_Ctx` of a call on the placed ``tokens`` (B, S)."""
        S = tokens.shape[1]
        cp = self.cp_on(S)
        return _Ctx(tokens.spec[0] if len(tokens.spec) else None,
                    [_rows_of(self, tokens, i) for i in range(self.n)],
                    tokens.shape[0], cp, _SPLIT_CP if cp else _SPLIT)

    def heads(self, i: int) -> Tuple[int, int]:
        """Query heads of position i."""
        H = self.cfg.n_heads
        if not self.split_heads:
            return 0, H
        hq = H // self.m
        return self.r(i) * hq, (self.r(i) + 1) * hq

    def kv_heads(self, i: int) -> Tuple[int, int]:
        """KV heads h // G of position i's query heads."""
        lo, hi = self.heads(i)
        return lo // self.G, (hi - 1) // self.G + 1

    def _range(self, kind: str, i: int) -> Optional[Tuple[int, int]]:
        hd = self.cfg.resolved_head_dim
        if kind == "experts":
            return self.experts(i) if self.split_experts else None
        if kind == "ff":
            if not self.split_ff:
                return None
            f = self.cfg.d_ff // self.m
            return self.r(i) * f, (self.r(i) + 1) * f
        if not self.split_heads:
            return None
        if kind == "h":
            return self.heads(i)
        lo, hi = self.heads(i) if kind == "q" else self.kv_heads(i)
        return lo * hd, hi * hd

    def view(self, x: M.ShardedTensor, dtype: torch.dtype,
             split: Optional[Tuple[int, str]] = None) -> List[torch.Tensor]:
        """Every position's piece of ``x`` as its shard computes with it:
        resharded (`meshes.reshard`, differentiable) to its model block
        on the split dim where the stored block is that block, else
        whole; cast to ``dtype``; cut to the shard's range."""
        key = (x.spec, tuple(x.shape), split)
        if key not in self._want:
            spec = list(x.spec) + [None] * (x.ndim - len(x.spec))
            want = [None] * x.ndim
            if split is not None:
                dim, kind = split
                keep = spec[dim] == "model" and all(
                    self._range(kind, i) == M.block_of(
                        self.mesh, x.spec, tuple(x.shape), c)[dim]
                    for i, c in enumerate(self.coords))
                if keep:
                    want[dim] = "model"
            self._want[key] = M.P(*want)
        want = self._want[key]
        y = M.reshard(x, M.Placement(self.mesh, want), dtype)
        out = []
        for i, piece in enumerate(y.pieces):
            if (piece is not None and split is not None
                    and want[split[0]] is None):
                rng = self._range(split[1], i)
                if rng is not None:
                    piece = piece.narrow(split[0], rng[0], rng[1] - rng[0])
            out.append(piece)
        return out

    def layer_views(self, lsrc: Dict[str, M.ShardedTensor],
                    dtype: torch.dtype, splits=_SPLIT
                    ) -> List[Dict[str, Dict]]:
        """One layer's weights (``{"attn/wq": placed, ...}``) as every
        position's nested dict of compute tensors, each leaf cut by its
        entry of ``splits`` (whole without one)."""
        per: List[Dict[str, Any]] = [dict() for _ in range(self.n)]
        for path, x in lsrc.items():
            for i, t in enumerate(self.view(x, dtype, splits.get(path))):
                if t is None:
                    continue
                node = per[i]
                *head, last = path.split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = t
        return per


def layer_sources(blocks) -> List[Dict[str, M.ShardedTensor]]:
    """The stacked placed block leaves as per-layer placed leaves (the
    "layers" dim is never split): a list over layers of {path: placed}."""
    flat: Dict[str, M.ShardedTensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = node
    walk(blocks, "")
    out: List[Dict[str, M.ShardedTensor]] = []
    for path, x in flat.items():
        assert not len(x.spec) or x.spec[0] is None, (path, x.spec)
        layers = [None if p is None else p.unbind(0) for p in x.pieces]
        pl = M.Placement(x.mesh, M.P(*list(x.spec)[1:]))
        for li in range(x.shape[0]):
            if len(out) <= li:
                out.append({})
            out[li][path] = M.ShardedTensor(
                pl, x.shape[1:], [None if ls is None else ls[li]
                                  for ls in layers])
    return out


def classes(cfg: ArchConfig, mesh: M.Mesh, kind: str, seq_len: int,
            cp: bool = False, cache=None, placements=None, step: int = 0
            ) -> List[List[int]]:
    """The positions of ``mesh`` grouped by the work one step of ``kind``
    ("train", "prefill" or "decode") over ``seq_len`` positions does at
    each (`launch.op_profile.profile_mesh` counts one of each), in mesh
    order. Positions along the batch axes do the same work, whatever rows
    they hold: the cross-position work over rows runs alike at each
    under a count (`_over_rows`, `_row_owner`). Along "model" the ranks
    differ where attention runs context-parallel (shard r reads
    (r + 1)·S/m keys; Whisper's encoder at its length), and in a decode
    step by which rings of the cache (``cache``, its tree of shaped
    leaves, placed by ``placements``) hold slot ``step % W`` at the
    position. (A training step where m does not divide S, whose shard 0
    alone sums the NLL, `_seq_block`, is not counted: `loss_fn`.)"""
    lay = Layout(cfg, mesh, cp)
    rings = []
    if kind == "decode" and cache is not None and not cfg.attn_free:
        if "layers" in cache:
            rings = [(tuple(c["k"].shape), p["k"].spec, 1)
                     for c, p in zip(cache["layers"], placements["layers"])]
        else:
            rings = [(tuple(cache["k"].shape), placements["k"].spec, 2)]
    keyed: Dict[tuple, List[int]] = {}
    for i, c in enumerate(lay.coords):
        if kind == "decode":
            key = tuple(lo <= step % shp[d] < hi for shp, spec, d in rings
                        for lo, hi in [M.block_of(mesh, spec, shp, c)[d]])
        elif lay.cp_on(seq_len) or (cfg.enc_dec and lay.cp_on(cfg.enc_len)):
            key = (lay.r(i),)
        else:
            key = ()
        keyed.setdefault(key, []).append(i)
    return list(keyed.values())


def _row_parallel(lay: Layout, parts: List[torch.Tensor], spec0,
                  dtype: torch.dtype) -> List[torch.Tensor]:
    """Sum the float32 partials of a row-parallel product over "model"
    (`meshes.all_reduce`), each position's copy in ``dtype``; ``spec0``
    places the partials' rows."""
    x = M.ShardedTensor.from_pieces(M.Placement(lay.mesh, M.P(spec0)),
                                    parts, ("model",))
    return M.all_reduce(x, "model", dtype).pieces


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------

def _project(cfg, p, nx):
    B, S, _ = nx.shape
    hd = cfg.resolved_head_dim
    q, k, v = fdot(nx, p["wq"]), fdot(nx, p["wk"]), fdot(nx, p["wv"])
    if cfg.qkv_bias and "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
            v.reshape(B, S, -1, hd))


def _attn_out(cfg, p, nx, positions, is_global, causal: bool = True):
    q, k, v = _project(cfg, p, nx)
    if cfg.rope_theta:
        ang = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                          cfg.mrope_sections)
        q, k = apply_rope(q, ang), apply_rope(k, ang)
    o = attn_lib.attention(q, k, v, causal=causal, window=cfg.swa_window,
                           chunk=cfg.attn_chunk, is_global=is_global)
    return o.reshape(*nx.shape[:2], -1), (k, v)


def _row_products(lay: Layout, pairs, spec0, dt: torch.dtype
                  ) -> List[List[torch.Tensor]]:
    """Each position's products ``y @ w`` of its list ``pairs[i]`` of (y,
    w) in ``dt``. Where the heads split they are row-parallel: float32
    partials (`mm_f32`), stacked and summed over "model" in one
    `meshes.all_reduce`, each rounded once to ``dt``; else every shard's
    whole product (`fdot`)."""
    if not lay.split_heads or not pairs[lay.active[0]]:
        return lay.each(lambda i: [fdot(y, w) for y, w in pairs[i]])
    parts = lay.each(lambda i: torch.stack([mm_f32(y, w)
                                            for y, w in pairs[i]]))
    x = M.ShardedTensor.from_pieces(M.Placement(lay.mesh, M.P(None, spec0)),
                                    parts, ("model",))
    sums = M.all_reduce(x, "model", dt).pieces
    return lay.each(lambda i: list(sums[i].unbind(0)))


def _block(cfg, lay: Layout, lsrc, xs, positions, ctx: _Ctx, is_global,
           collect: bool, causal: bool = True, enc=None):
    """One layer at every position: a decoder layer (``causal``; with
    ``enc``, each position's encoder output, Whisper's cross-attention
    after the self-attention), an encoder layer (not ``causal``) or an
    RWKV-6 layer (`_rwkv_block`). Returns (the layers' outputs, each
    position's cache entry if ``collect``: its (k, v) of its KV heads, or
    of every KV head under context parallelism, and for the hybrid family
    its SSM heads' final state after them; each position's load-balancing
    loss of the layer, or None without experts)."""
    dt = xs[lay.active[0]].dtype
    w = lay.layer_views(lsrc, dt, ctx.splits)
    if cfg.attn_free:
        return _rwkv_block(cfg, lay, w, xs, ctx, collect)
    hybrid = cfg.family == "hybrid"
    nxs = None
    if ctx.cp:
        attn, kvs = _cp_attention(cfg, lay, w, xs, positions, ctx.spec0,
                                  is_global, collect, causal)
        pairs = lay.each(lambda i: [])
    else:
        nxs = lay.each(lambda i: rms_norm(xs[i], w[i]["norm1"],
                                          cfg.norm_eps))
        os, kvs = _tp_attention(cfg, lay, w, nxs, positions, is_global,
                                collect, causal)
        pairs = lay.each(lambda i: [(os[i], w[i]["attn"]["wo"])])
    if hybrid:
        if nxs is None:
            nxs = lay.each(lambda i: rms_norm(xs[i], w[i]["norm1"],
                                              cfg.norm_eps))
        for i in lay.active:
            y, state = ssm_lib.ssm_heads(cfg, w[i]["ssm"], nxs[i])
            pairs[i].append((y, w[i]["ssm"]["out_proj"]))
            if collect:
                kvs[i] = tuple(kvs[i]) + (state,)
    outs = _row_products(lay, pairs, ctx.spec0, dt)
    if ctx.cp:
        outs = lay.each(lambda i: [attn[i]] + outs[i])
    if hybrid:
        xs = lay.each(lambda i: xs[i] + 0.5 * (
            w[i]["fuse_scale"][0] * outs[i][0]
            + w[i]["fuse_scale"][1] * outs[i][1]))
    else:
        xs = lay.each(lambda i: xs[i] + outs[i][0])
    if enc is not None:
        xs = _cross_attention(cfg, lay, w, xs, enc, ctx.spec0, dt)
    outs, aux = _ffn_all(cfg, lay, w, xs, ctx, dt)
    return outs, kvs, aux


def _cross_attention(cfg, lay: Layout, w, xs, enc, spec0, dt):
    """Whisper's cross-attention at every position, under every preset as
    under tp: the shard's query heads over its KV heads of its rows'
    encoder output ``enc[i]`` (K3, a full mask, Sq < Sk), ``xattn/wo``
    row-parallel where the heads split. Returns the residual sums."""
    hd = cfg.resolved_head_dim

    def pair(i):
        x, p = xs[i], w[i]["xattn"]
        nx = rms_norm(x, w[i]["norm3"], cfg.norm_eps)
        B, S, _ = x.shape
        q = fdot(nx, p["wq"]).reshape(B, S, -1, hd)
        k = fdot(enc[i], p["wk"]).reshape(B, enc[i].shape[1], -1, hd)
        v = fdot(enc[i], p["wv"]).reshape(B, enc[i].shape[1], -1, hd)
        o = attn_lib.attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        return [(o.reshape(B, S, -1), p["wo"])]
    outs = _row_products(lay, lay.each(pair), spec0, dt)
    return lay.each(lambda i: xs[i] + outs[i][0])


def _rwkv_block(cfg, lay: Layout, w, xs, ctx: _Ctx, collect: bool,
                carry=None):
    """One RWKV-6 layer at every position (module docstring): the time
    mix at the shard's heads (`rwkv.time_mix_heads`), ``w_o`` row-
    parallel; the channel mix at its ff columns, ``c_wv`` row-parallel and
    rounded before the gate. ``carry`` holds each position's (state at
    its heads, x_tm, x_cm) of a decode step (None: a prompt from zeros).
    Returns (the outputs, each position's [state, last time-mix input,
    last channel-mix input] if ``collect``, None)."""
    dt = xs[lay.active[0]].dtype
    pairs, entries = [None] * lay.n, [None] * lay.n
    for i in lay.active:
        p = w[i]["rwkv"]
        st, x_tm, _ = carry[i] if carry else (None, None, None)
        nx = rms_norm(xs[i], w[i]["norm1"], cfg.norm_eps)
        y, st, last = rwkv_lib.time_mix_heads(cfg, p, nx, st, x_tm)
        pairs[i] = [(y, p["w_o"])]
        entries[i] = [st, last]
    outs = _row_products(lay, pairs, ctx.spec0, dt)
    xs = lay.each(lambda i: xs[i] + outs[i][0])
    keys, gates = [None] * lay.n, [None] * lay.n
    for i in lay.active:
        p = w[i]["rwkv"]
        nx = rms_norm(xs[i], w[i]["norm2"], cfg.norm_eps)
        keys[i], xr = rwkv_lib.channel_mix_keys(
            cfg, p, nx, carry[i][2] if carry else None)
        gates[i] = torch.sigmoid(xr @ p["c_wr"])
        entries[i].append(nx[:, -1])
    if lay.split_ff:
        kvs = _row_parallel(lay, lay.each(lambda i: mm_f32(
            keys[i], w[i]["rwkv"]["c_wv"])), ctx.spec0, dt)
    else:
        kvs = lay.each(lambda i: keys[i] @ w[i]["rwkv"]["c_wv"])
    out = lay.each(lambda i: xs[i] + gates[i] * kvs[i])
    return out, (entries if collect else []), None


def _tp_attention(cfg, lay: Layout, w, nxs, positions, is_global,
                  collect: bool, causal: bool = True):
    """Attention at every position on its normed input ``nxs[i]``, each
    shard at its own heads. Returns (each position's output (B, S, h·D)
    of its heads, before ``wo``; each position's (k, v) of its KV heads if
    ``collect``)."""
    outs = lay.each(lambda i: _attn_out(cfg, w[i]["attn"], nxs[i],
                                        positions[i], is_global, causal))
    return _nth(outs, 0), (_nth(outs, 1) if collect else [])


def _cp_attention(cfg, lay: Layout, w, xs, positions, spec0, is_global,
                  collect: bool, causal: bool = True):
    """Context-parallel attention at every position (module docstring):
    shard r projects its block of S/m positions with every head, the
    blocks' K and V are all-gathered over "model", K3 takes the block's
    queries over the keys up to the block's end (``causal``; else over
    every key, a full mask), and ``wo``'s block outputs are all-gathered
    over "model". Returns (each position's attention output (B, S, d),
    after ``wo``; each position's whole (k, v), every KV head, if
    ``collect``)."""
    hd = cfg.resolved_head_dim
    S = xs[lay.active[0]].shape[1]
    blk = S // lay.m
    qs, ks, vs = [None] * lay.n, [None] * lay.n, [None] * lay.n
    for i in lay.active:
        lo = lay.r(i) * blk
        nx = rms_norm(xs[i][:, lo:lo + blk], w[i]["norm1"], cfg.norm_eps)
        q, k, v = _project(cfg, w[i]["attn"], nx)
        if cfg.rope_theta:
            ang = rope_angles(positions[i][:, lo:lo + blk], hd,
                              cfg.rope_theta, cfg.mrope_sections)
            q, k = apply_rope(q, ang), apply_rope(k, ang)
        qs[i], ks[i], vs[i] = q, k, v
    by_seq = M.Placement(lay.mesh, M.P(spec0, "model"))

    def gathered(pieces):
        x = M.ShardedTensor.from_pieces(by_seq, pieces)
        return M.all_gather(x, "model", 1).pieces
    k_all, v_all = gathered(ks), gathered(vs)

    def block(i):
        q = qs[i]
        hi = (lay.r(i) + 1) * blk if causal else S
        o = attn_lib.attention(q, k_all[i][:, :hi], v_all[i][:, :hi],
                               causal=causal, window=cfg.swa_window,
                               q_offset=hi - blk if causal else 0,
                               chunk=cfg.attn_chunk, is_global=is_global)
        return fdot(o.reshape(q.shape[0], blk, -1), w[i]["attn"]["wo"])
    return gathered(lay.each(block)), (list(zip(k_all, v_all)) if collect
                                       else [])


def _over_rows(lay: Layout, vals: List[torch.Tensor],
               rows: List[Tuple[int, int]]):
    """For every position i: the sum of ``vals`` over the batch's row
    blocks before position i's own (the batch's order), and over every
    row block. Each block's value is read from the first position (mesh
    order) of i's group over the batch axes that holds it, and the
    blocks are summed in their order on i's device: an exclusive scan
    and an all-reduce over the batch axes, where a block held twice
    (rows replicated over an axis) counts once. Under a count, each
    counted position all-gathers the blocks' values over the batch axes
    and scans them in one op, whatever its place among them."""
    before: List[Optional[torch.Tensor]] = [None] * lay.n
    total: List[Optional[torch.Tensor]] = [None] * lay.n
    if lay.counting:
        for grp in lay.data_groups:
            blocks = sorted({rows[j] for j in grp})
            for i in grp:
                if vals[i] is None:
                    continue
                if len(blocks) == 1:
                    before[i], total[i] = torch.zeros_like(vals[i]), vals[i]
                    continue
                every = M.record(lay.mesh, i, "all-gather", len(blocks),
                                 vals[i].new_empty((len(blocks),)
                                                   + vals[i].shape))
                upto = every.cumsum(0)
                before[i] = (upto - every)[blocks.index(rows[i])]
                total[i] = upto[-1]
        return before, total
    for grp in lay.data_groups:
        first: Dict[Tuple[int, int], int] = {}
        for j in grp:
            first.setdefault(rows[j], j)
        blocks = sorted(first)
        for i in grp:
            acc_b = acc_t = None
            for b in blocks:
                v = vals[first[b]].to(lay.devs[i])
                if b[0] < rows[i][0]:
                    acc_b = v if acc_b is None else acc_b + v
                acc_t = v if acc_t is None else acc_t + v
            before[i] = torch.zeros_like(acc_t) if acc_b is None else acc_b
            total[i] = acc_t
    return before, total


def _ffn_all(cfg, lay: Layout, w, xs, ctx: _Ctx, dt):
    """The residual MLP, or the experts, of a layer at every position.
    Returns (the outputs, each position's load-balancing loss or None)."""
    if cfg.is_moe:
        return _moe_all(cfg, lay, w, xs, ctx, dt)
    return _mlp_all(cfg, lay, w, xs, ctx.spec0, dt), None


def _moe_all(cfg, lay: Layout, w, xs, ctx: _Ctx, dt):
    """The mixture-of-experts layer at every position (module docstring):
    each routes its rows, places them in the whole batch's order among
    the whole batch's C places, and runs its experts; the shards' float32
    partials are summed over "model". The load-balancing loss is each
    position's, of the whole batch's mean probabilities and counts."""
    E, k = cfg.n_experts, cfg.top_k
    T = ctx.n_rows * xs[lay.active[0]].shape[1]
    with span("moe_router"):
        def choose(i):
            nx = rms_norm(xs[i], w[i]["norm2"], cfg.norm_eps)
            nx = nx.reshape(-1, nx.shape[-1])
            return nx, moe.choose(cfg, w[i]["moe"]["router"], nx)
        both = lay.each(choose)
        nxs, chs = _nth(both, 0), _nth(both, 1)
        before, counts = _over_rows(
            lay, lay.each(lambda i: chs[i].counts), ctx.rows)
        C = moe.capacity(cfg, T)
        routes = lay.each(lambda i: moe.place(chs[i], C, before[i]))
    parts = lay.each(lambda i: moe.expert_partial(
        cfg, w[i]["moe"], nxs[i], routes[i], *lay.experts(i)).view(
            xs[i].shape))
    with span("moe_combine"):
        if lay.split_experts:
            ys = _row_parallel(lay, parts, ctx.spec0, dt)
        else:
            ys = lay.each(lambda i: parts[i].to(dt))
    _, probs = _over_rows(lay, lay.each(lambda i: chs[i].probs.sum(0)),
                          ctx.rows)
    aux = lay.each(lambda i: E * torch.sum(
        (probs[i] / T) * (counts[i].float() / (T * k))))
    return lay.each(lambda i: xs[i] + ys[i]), aux


def _mlp_all(cfg, lay: Layout, w, xs, spec0, dt):
    """The residual MLP of a layer at every position: w_gate and w_up
    column-parallel, w_down row-parallel when the ff columns split."""
    act = activation(cfg.act)

    def mlp(i):
        p = w[i]["mlp"]
        nx = rms_norm(xs[i], w[i]["norm2"], cfg.norm_eps)
        h = act(fdot(nx, p["w_gate"])) * fdot(nx, p["w_up"])
        if lay.split_ff:
            return mm_f32(h, p["w_down"])
        return xs[i] + fdot(h, p["w_down"])
    res = lay.each(mlp)
    if lay.split_ff:
        sums = _row_parallel(lay, res, spec0, dt)
        res = lay.each(lambda i: xs[i] + sums[i])
    return res


def run_blocks(cfg: ArchConfig, lay: Layout, src, batch,
               remat: bool = False, collect: bool = False):
    """Embed, the encoder (Whisper), every layer and the final norm at
    every position. ``src`` is the placed parameter tree (any placement,
    any type: `Layout.view` casts to the compute type); ``batch`` the
    placed tokens (B, S), or a dict of the placed inputs ("tokens"; the
    VLM's "vision_embeds" (B, n_vision, d), spliced in place of the first
    positions, and "positions" (B, S, 3), else 0..S-1; Whisper's
    "enc_frames" (B, Se, d)), rows over the batch axes. Returns (each
    position's hidden (B_i, S, d), each layer's per-position cache
    entries if ``collect``, each position's load-balancing loss summed
    over the layers or None without experts, each position's encoder
    output (B_i, Se, d) or None)."""
    if M.is_placed(batch):
        batch = {"tokens": batch}
    tokens = batch["tokens"]
    dt = getattr(torch, cfg.dtype)
    ctx = lay.ctx(tokens)
    tables = lay.view(src["embed"]["tokens"], dt)
    xs, positions = [None] * lay.n, [None] * lay.n
    for i in lay.active:
        mine = {k: v.pieces[i] for k, v in batch.items()
                if k in ("tokens", "vision_embeds", "positions")}
        xs[i], positions[i] = transformer.embed_inputs(
            cfg, {"embed": {"tokens": tables[i]}}, mine)
    enc = (_encode(cfg, lay, src, batch["enc_frames"], remat)
           if cfg.enc_dec else None)
    kv_layers, aux = [], None
    for li, lsrc in enumerate(layer_sources(src["blocks"])):
        xs, kvs, layer_aux = transformer._remat(
            _block, remat, cfg, lay, lsrc, xs, positions, ctx,
            transformer.is_global_layer(cfg, li), collect, True, enc)
        if layer_aux is not None:
            aux = layer_aux if aux is None else lay.each(
                lambda i: aux[i] + layer_aux[i])
        if collect:
            kv_layers.append(kvs)
    norms = lay.view(src["final_norm"], dt)
    xs = lay.each(lambda i: rms_norm(xs[i], norms[i], cfg.norm_eps))
    return xs, kv_layers, aux, enc


def _encode(cfg: ArchConfig, lay: Layout, src, frames: M.ShardedTensor,
            remat: bool) -> List[torch.Tensor]:
    """Whisper's encoder at every position (`transformer.encode` on its
    rows of the placed ``frames``): the interleaved sinusoidal table
    added, every encoder layer (`_block`, a full mask; context-parallel
    under cp where the model axis divides Se), ``enc_final_norm``.
    Returns each position's output (B_i, Se, d), whole over "model"."""
    dt = getattr(torch, cfg.dtype)
    ctx = lay.ctx(frames)
    xs, positions = [None] * lay.n, [None] * lay.n
    for i in lay.active:
        x = frames.pieces[i].to(dt)
        B, T, _ = x.shape
        xs[i] = x + sinusoidal_positions(T, cfg.d_model, dt, x.device)[None]
        positions[i] = torch.arange(T, dtype=torch.int32,
                                    device=x.device).expand(B, T)
    for lsrc in layer_sources(src["enc_blocks"]):
        xs, _, _ = transformer._remat(_block, remat, cfg, lay, lsrc, xs,
                                      positions, ctx, None, False, False)
    norms = lay.view(src["enc_final_norm"], dt)
    return lay.each(lambda i: rms_norm(xs[i], norms[i], cfg.norm_eps))


def _head(cfg, lay: Layout, src, dt) -> List[torch.Tensor]:
    if cfg.tie_embeddings:
        return [t.T for t in lay.view(src["embed"]["tokens"], dt)]
    return lay.view(src["head"]["w"], dt)


def _seq_block(lay: Layout, i: int, S: int) -> Tuple[int, int]:
    """The block of the sequence whose NLL position i sums: its model
    shard's S/m positions (all of them at shard 0 when m does not divide
    S)."""
    m, r = lay.m, lay.r(i)
    if S % m == 0:
        return r * (S // m), (r + 1) * (S // m)
    return (0, S) if r == 0 else (0, 0)


def loss_fn(cfg: ArchConfig, mesh: M.Mesh, src, batch: Dict[str, Any],
            cp: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`models.transformer.loss_fn` over ``mesh`` (``cp``: the context-
    parallel preset): ``src`` the placed parameters, ``batch`` {"tokens",
    "labels"} (and the VLM's inputs, `run_blocks`) placed with their rows
    over the batch axes. Returns (total,
    {"loss", "moe_aux"}) on the mesh's first device: the NLL summed over
    every position and divided by the global count of labels >= 0, plus
    `transformer.MOE_AUX_WEIGHT` x the load-balancing loss of the whole
    batch (zero without experts)."""
    check_supported(cfg, mesh)
    lay = Layout(cfg, mesh, cp)
    tokens, labels = batch["tokens"], batch["labels"]
    for c in M.batch_axes(mesh):
        if c not in M._axes_of(tokens.spec[0] if len(tokens.spec) else None):
            if mesh.shape[c] > 1:
                raise ValueError(
                    f"a training batch of {tokens.shape[0]} rows does not "
                    f"split over the mesh's {c!r} axis ({mesh.shape[c]})")
    if lay.counting and tokens.shape[1] % lay.m:
        # the other shards' backward comes only from shard 0's loss
        raise NotImplementedError(
            f"a count of a training step over {tokens.shape[1]} positions, "
            f"which the model axis ({lay.m}) does not divide")
    hidden, _, aux, _ = run_blocks(
        cfg, lay, src, batch, remat=cfg.remat and torch.is_grad_enabled())
    first = lay.active[0]
    dt = hidden[first].dtype
    heads = _head(cfg, lay, src, dt)
    tots, cnts = [None] * lay.n, [None] * lay.n
    for i in lay.active:
        h, lab = hidden[i], labels.pieces[i]
        head = wide(heads[i].to(dt))
        S = h.shape[1]
        lo, hi = _seq_block(lay, i, S)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        n = hi - lo
        c = min(transformer.LOSS_CHUNK, n) if n else 0
        if c and n % c:
            c = n
        for a in range(lo, hi, c or 1):
            s, k = transformer._remat(
                transformer._chunk_nll, True, h[:, a:a + c],
                lab[:, a:a + c], head)
            tot, cnt = tot + s, cnt + k
        tots[i], cnts[i] = tot, cnt
    every = tuple(mesh.axis_names)
    rep = M.Placement(mesh, M.P())
    tot = M.all_reduce(M.ShardedTensor(rep, (), tots, every), every)
    cnt = M.all_reduce(M.ShardedTensor(rep, (), cnts, every), every)
    # on the mesh's first device (under a count, the first counted one)
    loss = tot.pieces[first] / torch.clamp(cnt.pieces[first], min=1.0)
    aux = (torch.zeros((), dtype=torch.float32, device=loss.device)
           if aux is None else aux[first])
    return (loss + transformer.MOE_AUX_WEIGHT * aux,
            {"loss": loss, "moe_aux": aux})


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def meta_tree(spec):
    """A cache spec's tree of (shape, dtype) as meta tensors."""
    if isinstance(spec, dict):
        return {k: meta_tree(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [meta_tree(v) for v in spec]
    shp, dt = spec
    return torch.empty(shp, dtype=dt, device="meta")


def prefill(cfg: ArchConfig, mesh: M.Mesh, src, batch, max_len: int = 0,
            cp: bool = False):
    """`models.decoding.prefill` over ``mesh`` (``cp``: the context-
    parallel preset): ``batch`` the placed tokens (B, S) or a dict of the
    placed inputs (`run_blocks`); returns (last logits (B, V) placed with
    their rows over the batch axes, the bf16 cache of ``max(max_len, S)``
    slots placed by `meshes.cache_shardings`). Every shard computes its
    heads (K3 at its head slice; the hybrid family's SSM heads on K4), or
    under cp its block of positions (K3 at its block's queries), and the
    cache takes each model shard's block of the slots, all KV heads
    (`quantize_cache` makes the int8 one)."""
    check_supported(cfg, mesh)
    if M.is_placed(batch):
        batch = {"tokens": batch}
    tokens = batch["tokens"]
    lay = Layout(cfg, mesh, cp)
    with torch.no_grad():
        hidden, kv_layers, _, enc = run_blocks(cfg, lay, src, batch,
                                               collect=True)
        dt = hidden[lay.active[0]].dtype
        heads = _head(cfg, lay, src, dt)
        logits = lay.each(lambda i: fdot(hidden[i][:, -1],
                                         heads[i].to(dt)))
    B, S = tokens.shape
    max_len = max(max_len, S)
    # the KV heads each shard collected: its own, or under cp all of them
    KV = cfg.n_kv_heads
    kv_ranges = (lambda j: (0, KV)) if lay.cp_on(S) else lay.kv_heads
    spec = decoding.cache_spec(cfg, ShapeConfig("prefill", max_len, B,
                                                "prefill"))
    pls = M.cache_shardings(mesh, meta_tree(spec))
    rows = tokens.spec[0] if len(tokens.spec) else None
    heads_spec = _state_placement(lay, rows).spec
    if cfg.attn_free:
        cache = {"state": _layer_stack(
            lay, [_nth(kvs, 0) for kvs in kv_layers], heads_spec,
            spec["state"][0], pls["state"])}
        for j, name in ((1, "x_tm"), (2, "x_cm")):
            cache[name] = _layer_stack(
                lay, [_nth(kvs, j) for kvs in kv_layers], M.P(rows),
                spec[name][0], pls[name], torch.bfloat16)
    elif cfg.family == "hybrid":
        layers = [_ring(lay, tokens, [kvs], lspec, lpls, kv_ranges)
                  for kvs, lspec, lpls in zip(kv_layers, spec["layers"],
                                              pls["layers"])]
        cache = {"layers": layers, "ssm": _layer_stack(
            lay, [_nth(kvs, -1) for kvs in kv_layers], heads_spec,
            spec["ssm"][0], pls["ssm"])}
    else:
        cache = _ring(lay, tokens, kv_layers, spec, pls, kv_ranges)
    if cfg.enc_dec:
        with torch.no_grad():
            cache.update(_cross_cache(cfg, lay, src, enc, tokens,
                                      spec["xk"][0], pls["xk"]))
    lpl = M.data_sharding(mesh, B, 2)
    out = _by_rows(lay, logits, tokens, lpl,
                   (B, logits[lay.active[0]].shape[-1]))
    return out, cache


def _nth(entries, j: int) -> List[Optional[torch.Tensor]]:
    """Item ``j`` of each position's cache entry (None where none)."""
    return [None if e is None else e[j] for e in entries]


def _ring(lay: Layout, tokens: M.ShardedTensor, kv_layers, spec, pls,
          kv_ranges) -> Dict[str, M.ShardedTensor]:
    """The ring of slots {"k", "v", "pos"} of the layers ``kv_layers``
    (each layer's per-position cache entries) placed by ``pls``: stacked
    (L, B, W, KV, D), or one hybrid layer's (B, W_i, KV, D). Each position
    takes its rows and its block of the slots, every KV head, the
    prompt's position p in slot p % W (`_slots`)."""
    mesh = lay.mesh
    kshape = spec["k"][0]
    stacked = len(kshape) == 5
    bdim, sdim = (1, 2) if stacked else (0, 1)
    W, S = kshape[sdim], tokens.shape[1]
    pieces: Dict[str, List[Optional[torch.Tensor]]] = {
        k: [None] * lay.n for k in ("k", "v", "pos")}
    split = (list(pls["k"].spec) + [None] * 5)[sdim] == "model"
    for i in lay.active:
        blk = M.block_of(mesh, pls["k"].spec, kshape, lay.coords[i])
        (b0, b1), (s0, s1) = blk[bdim], blk[sdim]
        # the rows of position i: the same rows on every model shard
        src_rows = _row_owner(lay, tokens, i, b0, b1)
        pos = torch.arange(S, dtype=torch.int32,
                           device=lay.devs[i]).expand(b1 - b0, S)
        # one layer at a time: only the position's slots outlive the loop
        ks, vs = [], []
        for kvs in kv_layers:
            k, v = _whole_kv(lay, kvs, src_rows, lay.devs[i], kv_ranges, i)
            moved = lay.counting and k.shape[2] != kvs[i][0].shape[2]
            k, v, p = _slots(k[None].to(torch.bfloat16),
                             v[None].to(torch.bfloat16), pos, W, s0, s1)
            if moved:
                _kv_moved(lay, i, (k, v), split)
            ks.append(k[0])
            vs.append(v[0])
        parts = {"k": torch.stack(ks) if stacked else ks[0],
                 "v": torch.stack(vs) if stacked else vs[0], "pos": p}
        for name in pieces:
            pieces[name][i] = parts[name].contiguous()
    return {name: M.ShardedTensor(pls[name], spec[name][0], pieces[name])
            for name in pieces}


def _state_placement(lay: Layout, rows) -> M.Placement:
    """The placement of one layer's recurrent states (B, H, ...) as the
    shards compute them: rows by ``rows`` (a batch dim's spec entry),
    heads over "model" where they split (`Layout.heads`), else whole."""
    return M.Placement(lay.mesh, M.P(rows,
                                     "model" if lay.split_heads else None))


def _layer_stack(lay: Layout, per_layer, src_spec, shape,
                 pl: M.Placement, dtype: Optional[torch.dtype] = None
                 ) -> M.ShardedTensor:
    """A stacked cache leaf of ``shape`` (L, ...) placed by ``pl``: layer
    l's per-position pieces ``per_layer[l]``, placed by ``src_spec`` (a
    layer's dims: the SSM or RWKV states by `_state_placement`, the token
    shifts by rows), resharded onto ``pl``'s placement of a layer, cast
    to ``dtype``, and stacked."""
    src = M.Placement(lay.mesh, src_spec)
    want = M.Placement(lay.mesh, M.P(*list(pl.spec)[1:]))
    layers = [M.reshard(M.ShardedTensor(src, shape[1:], pieces), want,
                        dtype).pieces for pieces in per_layer]
    return M.ShardedTensor(pl, shape, lay.each(lambda i: torch.stack(
        [pieces[i] for pieces in layers]).contiguous()))


def _cross_cache(cfg, lay: Layout, src, enc, tokens: M.ShardedTensor,
                 shape, pl: M.Placement) -> Dict[str, M.ShardedTensor]:
    """Whisper's cross keys and values {"xk", "xv"} (L, B, Se, KV, D)
    bf16 placed by ``pl``: each layer's computed by every shard at its KV
    heads from its rows' encoder output ``enc[i]`` (a second time after
    the forward, as the reference computes them); each position takes its
    rows and Se block of every KV head from the first shard (mesh order)
    that computed it (`_whole_kv`)."""
    dt = enc[lay.active[0]].dtype
    hd = cfg.resolved_head_dim
    blks = [M.block_of(lay.mesh, pl.spec, shape, c) for c in lay.coords]
    split = (list(pl.spec) + [None] * 5)[2] == "model"
    out: Dict[str, List[List[torch.Tensor]]] = {
        "xk": [[] for _ in range(lay.n)], "xv": [[] for _ in range(lay.n)]}
    for lsrc in layer_sources(src["blocks"]):
        wk, wv = (lay.view(lsrc[k], dt, _SPLIT[k])
                  for k in ("xattn/wk", "xattn/wv"))
        kvs = lay.each(lambda i: (
            fdot(enc[i], wk[i]).reshape(*enc[i].shape[:2], -1, hd),
            fdot(enc[i], wv[i]).reshape(*enc[i].shape[:2], -1, hd)))
        for i in lay.active:
            (b0, b1), (s0, s1) = blks[i][1], blks[i][2]
            k, v = _whole_kv(lay, [None if kv is None else
                                   (kv[0][:, s0:s1], kv[1][:, s0:s1])
                                   for kv in kvs],
                             _row_owner(lay, tokens, i, b0, b1),
                             lay.devs[i], lay.kv_heads, i)
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            if lay.counting and k.shape[2] != kvs[i][0].shape[2]:
                _kv_moved(lay, i, (k, v), split)
            out["xk"][i].append(k)
            out["xv"][i].append(v)
    return {name: M.ShardedTensor(pl, shape, lay.each(
        lambda i: torch.stack(pieces[i]).contiguous()))
            for name, pieces in out.items()}


def quantize_cache(cfg: ArchConfig, cache: Dict[str, M.ShardedTensor]
                   ) -> Dict[str, M.ShardedTensor]:
    """A placed bf16 cache (a prefill's) as the int8 cache of the kv8 and
    serve8 presets: every piece through `decoding.quantize_cache` (a piece
    holds whole (KV, D) rows, so the scales are the unsplit cache's); the
    scales placed as k and v. The hybrid cache has no int8 form
    (`decoding.quantize_cache` raises alike)."""
    decoding._check_int8(cfg, True)
    out = dict(cache)
    for name in ("k", "v"):
        x = cache[name]
        pairs = [None if p is None else decoding._quantize_kv(p)
                 for p in x.pieces]
        out[name] = M.ShardedTensor(x.placement, x.shape,
                                    _nth(pairs, 0))
        out[f"{name}_scale"] = M.ShardedTensor(
            x.placement, tuple(x.shape[:-1]) + (1,), _nth(pairs, 1))
    return out


def _rows_of(lay: Layout, x: M.ShardedTensor, i: int) -> Tuple[int, int]:
    return M.block_of(lay.mesh, x.spec, tuple(x.shape), lay.coords[i])[0]


def _row_owner(lay: Layout, x: M.ShardedTensor, i: int, b0: int,
               b1: int) -> List[Tuple[int, int, int]]:
    """Where rows [b0, b1) of the batch placed as ``x`` were computed:
    (position j, local lo, local hi) for each block of rows, j the first
    model shard 0 (mesh order) holding the block; under a count, position
    i itself, which holds them."""
    if lay.counting:
        r0, r1 = _rows_of(lay, x, i)
        if not r0 <= b0 <= b1 <= r1:
            raise NotImplementedError(f"a count reads rows [{b0}, {b1}) "
                                      f"at a position holding [{r0}, {r1})")
        return [(i, b0 - r0, b1 - r0)]
    out, seen = [], set()
    for j in range(lay.n):
        if lay.r(j) != 0:
            continue
        r0, r1 = _rows_of(lay, x, j)
        lo, hi = max(r0, b0), min(r1, b1)
        if lo < hi and (r0, r1) not in seen:
            seen.add((r0, r1))
            out.append((j, lo - r0, hi - r0))
    return out


def _heads_whole(lay: Layout, parts, ranges, grp, dev, i: int
                 ) -> torch.Tensor:
    """The whole head dim (dim 2) of a model group's per-shard tensors:
    ``parts[j]`` holds heads ``ranges(j)``; each head is taken from the
    first shard of ``grp`` (mesh order) that holds it, onto ``dev``.
    Under a count, position ``i`` all-gathers the distinct ranges, or
    reads its own part where it holds every head."""
    if lay.counting:
        whole = max(ranges(j)[1] for j in grp)
        if ranges(i) == (0, whole):
            return parts[i][:, :, 0:].to(dev)
        shp = list(parts[i].shape)
        shp[2] = whole
        return M.record(lay.mesh, i, "all-gather",
                        len({ranges(j) for j in grp}), parts[i].new_empty(shp))
    out, have = [], 0
    for j in grp:
        lo, hi = ranges(j)
        if hi <= have:
            continue
        out.append(parts[j][:, :, have - lo:].to(dev))
        have = hi
    return out[0] if len(out) == 1 else torch.cat(out, dim=2)


def _whole_kv(lay: Layout, kvs, rows, dev, ranges, i: int):
    """All KV heads of the rows ``rows`` (from `_row_owner`): each KV head
    from the first model shard (mesh order) that computed it, shard j
    holding the KV heads ``ranges(j)``. Under a count, position ``i``
    reads its own rows where it holds every KV head, else makes empty
    pieces of every KV head (its caller records the exchange,
    `_kv_moved`)."""
    if lay.counting:
        (_, lo, hi), = rows
        k, v = kvs[i][0][lo:hi], kvs[i][1][lo:hi]
        grp = lay.group[i]
        whole = max(ranges(j)[1] for j in grp)
        if ranges(i) == (0, whole):
            return torch.cat([k[:, :, 0:]]), torch.cat([v[:, :, 0:]])
        shp = list(k.shape)
        shp[2] = whole
        return k.new_empty(shp), v.new_empty(shp)
    ks, vs = [], []
    for j, lo, hi in rows:
        grp = lay.group[j]
        ks.append(_heads_whole(lay, [kv[0][lo:hi] for kv in kvs],
                               ranges, grp, dev, i))
        vs.append(_heads_whole(lay, [kv[1][lo:hi] for kv in kvs],
                               ranges, grp, dev, i))
    return torch.cat(ks), torch.cat(vs)


def _kv_moved(lay: Layout, i: int, kv, split: bool) -> None:
    """Record, under a count, the exchange that gives position i its
    cache block ``kv`` (k, v) of every KV head from the model shards that
    computed them: an all-to-all over "model" where the block's sequence
    is cut over "model", else an all-gather."""
    for t in kv:
        M.record(lay.mesh, i, "all-to-all" if split else "all-gather",
                 lay.m, t)


def _slots(k, v, pos, W: int, s0: int, s1: int):
    """A prompt's k, v (L, b, S, KV, D) and positions (b, S) as the ring
    of W slots (`decoding._pad_cache_entry` per layer), cut to slots
    [s0, s1)."""
    S = k.shape[2]
    if W <= S:
        sl = slice(S - W, S)
        k, v, pos = k[:, :, sl], v[:, :, sl], pos[:, sl]
        k, v = k.roll(S % W, dims=2), v.roll(S % W, dims=2)
        pos = pos.roll(S % W, dims=1)
    else:
        padk = k.new_zeros(k.shape[:2] + (W - S,) + k.shape[3:])
        k = torch.cat([k, padk], dim=2)
        v = torch.cat([v, padk], dim=2)
        pos = torch.cat([pos, pos.new_full((pos.shape[0], W - S), -1)],
                        dim=1)
    return k[:, :, s0:s1], v[:, :, s0:s1], pos[:, s0:s1]


def _by_rows(lay: Layout, per_pos: List[torch.Tensor], rows_of,
             placement: M.Placement, shape) -> M.ShardedTensor:
    """A placed tensor of ``placement`` (rows over the batch axes) from
    each position's results for its rows of ``rows_of``."""
    def piece(i):
        b0, b1 = M.block_of(lay.mesh, placement.spec, tuple(shape),
                            lay.coords[i])[0]
        parts = []
        for j, lo, hi in _row_owner(lay, rows_of, i, b0, b1):
            parts.append(per_pos[j][lo:hi].to(lay.devs[i], copy=True))
        return torch.cat(parts).contiguous()
    return M.ShardedTensor(placement, shape, lay.each(piece))


def decode_step(cfg: ArchConfig, mesh: M.Mesh, src, cache: Dict[str, Any],
                tokens: M.ShardedTensor, step: int):
    """`models.decoding.decode_step` over ``mesh``: ``cache`` placed by
    `meshes.cache_shardings` (bf16, or int8 with its scales; the hybrid
    family's per-layer rings and SSM state; Whisper's cross keys and
    values beside the ring; RWKV-6's state and token shifts) is updated in
    place; returns (logits (B, 1, V) placed with their rows over the batch
    axes, the cache).

    Each model shard projects its own query heads and their KV heads, as
    training does. The queries are gathered whole across "model" (every
    shard attends over its slots with every head); the new token's KV
    heads only onto the shard that owns slot ``step % W`` (per layer in
    the hybrid cache, whose W_i differ). The merged attention's own heads
    go through the shard's rows of ``wo`` (row-parallel, float32 partials
    summed across "model"), and the hybrid family's SSM heads one step
    through ``out_proj`` beside it (`_row_products`). Whisper's cross-
    attention follows the self-attention (`_cross_decode`); an RWKV-6
    layer steps each shard's heads from the cache (`_rwkv_decode`). A
    decode step never runs context-parallel; the experts run as in
    `_moe_all`, over the batch's B tokens."""
    check_supported(cfg, mesh)
    lay = Layout(cfg, mesh)
    ctx = lay.ctx(tokens)
    step = int(step)
    dt = getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim
    hybrid = cfg.family == "hybrid"
    with torch.no_grad():
        tables = lay.view(src["embed"]["tokens"], dt)
        xs = lay.each(lambda i: decoding._embed_decode(
            cfg, {"embed": {"tokens": tables[i]}}, tokens.pieces[i], step))
        for li, lsrc in enumerate(layer_sources(src["blocks"])):
            w = lay.layer_views(lsrc, dt)
            if cfg.attn_free:
                xs = _rwkv_decode(cfg, lay, w, xs, ctx, cache, li)
                continue
            nxs, qs, ks, vs = ([None] * lay.n for _ in range(4))
            for i in lay.active:
                nx = rms_norm(xs[i], w[i]["norm1"], cfg.norm_eps)
                q, k, v = _project(cfg, w[i]["attn"], nx)
                if cfg.rope_theta:
                    pos = torch.full((nx.shape[0], 1), step,
                                     dtype=torch.int32, device=nx.device)
                    if cfg.mrope_sections:    # step on all three sections
                        pos = pos[..., None].expand(nx.shape[0], 1, 3)
                    ang = rope_angles(pos, hd, cfg.rope_theta,
                                      cfg.mrope_sections)
                    q, k = apply_rope(q, ang), apply_rope(k, ang)
                nxs[i], qs[i], ks[i], vs[i] = nx, q, k, v
            if hybrid:
                ring = _LayerRing.of(cache["layers"][li], None)
                window = (0 if transformer.is_global_layer(cfg, li)
                          else cfg.swa_window)
            else:
                ring = _LayerRing.of(cache, li)
                window = cfg.swa_window or 0
            merged = _cached_attention(lay, ring, qs, ks, vs, step, window,
                                       write_pos=hybrid or li == 0)
            pairs = lay.each(lambda i: [(
                merged[i][:, slice(*lay.heads(i))].to(dt).reshape(
                    xs[i].shape[0], 1, -1), w[i]["attn"]["wo"])])
            if hybrid:
                ys = _ssm_decode(cfg, lay, w, nxs, cache["ssm"], li)
                for i in lay.active:
                    pairs[i].append((ys[i], w[i]["ssm"]["out_proj"]))
            outs = _row_products(lay, pairs, ctx.spec0, dt)
            if hybrid:
                new = lay.each(lambda i: xs[i] + 0.5 * (
                    w[i]["fuse_scale"][0] * outs[i][0]
                    + w[i]["fuse_scale"][1] * outs[i][1]))
            else:
                new = lay.each(lambda i: xs[i] + outs[i][0])
            if cfg.enc_dec:
                new = _cross_decode(cfg, lay, w, new, cache, li, ctx.spec0,
                                    dt)
            xs, _ = _ffn_all(cfg, lay, w, new, ctx, dt)
        norms = lay.view(src["final_norm"], dt)
        heads = _head(cfg, lay, src, dt)
        logits = lay.each(lambda i: rms_norm(xs[i], norms[i], cfg.norm_eps)
                          @ heads[i].to(dt))
    B = tokens.shape[0]
    lpl = M.data_sharding(mesh, B, 3)
    return _by_rows(lay, logits, tokens, lpl,
                    (B, 1, logits[lay.active[0]].shape[-1])), cache


def _cross_decode(cfg, lay: Layout, w, xs, cache, li: int, spec0, dt):
    """Whisper's cross-attention of a decode step at every position over
    layer ``li`` of the placed ``xk``/``xv``: the shard's query heads,
    gathered whole across "model"; each shard attends over its Se block
    with every head and no mask (`_partial_attention`), the blocks merged
    across "model" by log-sum-exp where Se is cut (`_merge`); ``xattn/wo``
    row-parallel on the shard's heads. Returns the residual sums."""
    hd = cfg.resolved_head_dim
    xk, xv = cache["xk"], cache["xv"]
    spec = list(xk.spec) + [None] * (xk.ndim - len(xk.spec))
    qs = lay.each(lambda i: fdot(
        rms_norm(xs[i], w[i]["norm3"], cfg.norm_eps),
        w[i]["xattn"]["wq"]).reshape(xs[i].shape[0], 1, -1, hd))

    def attend(i):
        q = qs[i]
        if lay.split_heads:
            q = _heads_whole(lay, qs, lay.heads, lay.group[i], lay.devs[i],
                             i)
        s0, s1 = M.block_of(lay.mesh, xk.spec, tuple(xk.shape),
                            lay.coords[i])[2]
        ck = xk.pieces[i][li]
        cpos = torch.arange(s0, s1, dtype=torch.int32,
                            device=ck.device).expand(ck.shape[0], s1 - s0)
        return _partial_attention(q, ck, xv.pieces[i][li], cpos, 0, 0)
    parts = lay.each(attend)
    merged = _merge(lay, spec[2] == "model", _nth(parts, 0), _nth(parts, 1),
                    _nth(parts, 2))
    pairs = lay.each(lambda i: [(
        merged[i][:, slice(*lay.heads(i))].to(dt).reshape(
            xs[i].shape[0], 1, -1), w[i]["xattn"]["wo"])])
    outs = _row_products(lay, pairs, spec0, dt)
    return lay.each(lambda i: xs[i] + outs[i][0])


def _layer_states(lay: Layout, x: M.ShardedTensor, li: int):
    """Layer ``li`` of a placed recurrent state (L, B, H, ...): (the
    layer as a placed tensor whose pieces are views of ``x``'s, each
    position's state at its shard's heads, resharded where the cache's
    heads are not the shard's)."""
    spec = list(x.spec) + [None] * (x.ndim - len(x.spec))
    stored = M.Placement(lay.mesh, M.P(*spec[1:]))
    layer = M.ShardedTensor(stored, x.shape[1:], [
        None if p is None else p[li] for p in x.pieces])
    return layer, M.reshard(layer, _state_placement(lay, spec[1])).pieces


def _write_states(lay: Layout, layer: M.ShardedTensor, states) -> None:
    """Each position's new state at its shard's heads ``states[i]``
    written, in place, into its block of ``layer`` (`_layer_states`)."""
    for i, st in enumerate(states):
        if st is None:
            continue
        h0, h1 = M.block_of(lay.mesh, layer.spec, tuple(layer.shape),
                            lay.coords[i])[1]
        c0 = lay.heads(i)[0]
        layer.pieces[i].copy_(st[:, h0 - c0:h1 - c0])


def _rwkv_decode(cfg, lay: Layout, w, xs, ctx: _Ctx, cache, li: int):
    """One step of every position's RWKV-6 layer ``li`` (`_rwkv_block`)
    from the placed cache: the state at the shard's heads
    (`_layer_states`), the token shifts of its rows; the new state written
    back into each position's block and the token shifts into every
    position's piece, in place. Returns the layer's outputs."""
    layer, states = _layer_states(lay, cache["state"], li)
    dt = xs[lay.active[0]].dtype
    carry = lay.each(lambda i: (states[i],
                                cache["x_tm"].pieces[i][li].to(dt),
                                cache["x_cm"].pieces[i][li].to(dt)))
    xs, entries, _ = _rwkv_block(cfg, lay, w, xs, ctx, True, carry)
    _write_states(lay, layer, _nth(entries, 0))
    for i in lay.active:
        _st, tm, cm = entries[i]
        cache["x_tm"].pieces[i][li].copy_(tm)
        cache["x_cm"].pieces[i][li].copy_(cm)
    return xs


class _LayerRing(NamedTuple):
    """One layer's ring of slots in a placed cache, as every position's
    pieces: k and v (B_i, W_i', KV, D) (int8 with ``scales``, each
    position's (k_scale, v_scale) pieces, else None), positions (B_i,
    W_i'); ``slots[i]`` the range of the W slots position i holds;
    ``split`` whether the slots are cut over "model"."""
    k: List[torch.Tensor]
    v: List[torch.Tensor]
    pos: List[torch.Tensor]
    scales: Optional[List[Tuple[torch.Tensor, torch.Tensor]]]
    slots: List[Tuple[int, int]]
    W: int
    split: bool

    @classmethod
    def of(cls, cache: Dict[str, M.ShardedTensor], li: Optional[int]):
        """Layer ``li`` of a stacked cache (L, B, W, KV, D), or the hybrid
        layer ``cache`` (B, W_i, KV, D) with ``li`` None."""
        k = cache["k"]
        sdim = 1 if li is None else 2
        spec = list(k.spec) + [None] * (k.ndim - len(k.spec))

        def at(x):
            return [p if li is None or p is None else p[li]
                    for p in x.pieces]
        coords = M.positions(k.mesh)
        slots = [M.block_of(k.mesh, k.spec, tuple(k.shape), c)[sdim]
                 for c in coords]
        scales = (list(zip(at(cache["k_scale"]), at(cache["v_scale"])))
                  if k.dtype == torch.int8 else None)
        return cls(at(k), at(cache["v"]), list(cache["pos"].pieces), scales,
                   slots, k.shape[sdim], spec[sdim] == "model")


def _cached_attention(lay: Layout, ring: _LayerRing, qs, ks, vs, step: int,
                      window: int, write_pos: bool) -> List[torch.Tensor]:
    """A decode step's attention over one layer's ``ring`` at every
    position: the new token's KV heads (each position's ``ks``/``vs`` of
    its KV heads) written into slot ``step % W`` by the position that
    holds it (with ``write_pos`` its position too), each position's
    partial attention of every head over its slots, merged across
    "model" (`_merge`). Returns each position's (B_i, H, D) float32."""
    slot = step % ring.W
    outs, ms, ls = [None] * lay.n, [None] * lay.n, [None] * lay.n
    for i in lay.active:
        q = qs[i]
        if lay.split_heads:
            q = _heads_whole(lay, qs, lay.heads, lay.group[i], lay.devs[i],
                             i)
        s0, s1 = ring.slots[i]
        ck, cv, cpos = ring.k[i], ring.v[i], ring.pos[i]
        if s0 <= slot < s1:
            local = slot - s0
            k, v = ks[i], vs[i]
            if lay.split_heads:
                k = _heads_whole(lay, ks, lay.kv_heads, lay.group[i],
                                 lay.devs[i], i)
                v = _heads_whole(lay, vs, lay.kv_heads, lay.group[i],
                                 lay.devs[i], i)
            if ring.scales is not None:
                (kq, ksc), (vq, vsc) = (decoding._quantize_kv(k),
                                        decoding._quantize_kv(v))
                ck[:, local] = kq[:, 0]
                cv[:, local] = vq[:, 0]
                ring.scales[i][0][:, local] = ksc[:, 0]
                ring.scales[i][1][:, local] = vsc[:, 0]
            else:
                ck[:, local] = k[:, 0].to(ck.dtype)
                cv[:, local] = v[:, 0].to(cv.dtype)
            if write_pos:
                cpos[:, local] = step
        if ring.scales is not None:
            ck = decoding._dequantize_kv(ck, ring.scales[i][0])
            cv = decoding._dequantize_kv(cv, ring.scales[i][1])
        outs[i], ms[i], ls[i] = _partial_attention(q, ck, cv, cpos, window,
                                                   step)
    return _merge(lay, ring.split, outs, ms, ls)


def _ssm_decode(cfg, lay: Layout, w, nxs, ssm: M.ShardedTensor,
                li: int) -> List[torch.Tensor]:
    """One step of every position's SSM heads (`Layout.heads`) on its
    normed input ``nxs[i]``: layer ``li``'s state read from the placed
    cache ``ssm`` (L, B, H, Dh, N) at the shard's heads
    (`_layer_states`), and the new state written back (`_write_states`).
    Returns each position's gated y (B_i, 1, h·Dh)."""
    layer, states = _layer_states(lay, ssm, li)
    both = lay.each(lambda i: ssm_lib.ssm_decode_heads(
        cfg, w[i]["ssm"], nxs[i], states[i]))
    _write_states(lay, layer, _nth(both, 1))
    return _nth(both, 0)


def _partial_attention(q, ck, cv, cpos, window: int, step: int):
    """One shard's attention of q (B, 1, H, D) over its slots: the
    unnormalised float32 output (B, KV, G, D), the row max and the row
    sum (B, KV, G); a shard with no valid slot gives zeros and a max of
    -inf."""
    B, _one, H, D = q.shape
    KV = ck.shape[2]
    G = H // KV
    q4 = q.reshape(B, KV, G, D) * D ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", q4.float(), ck.float())
    valid = cpos >= 0
    if window:
        valid &= (step - cpos) < window
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    mx = s.amax(dim=-1)
    safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    p = torch.exp(s - safe[..., None])
    o = torch.einsum("bkgs,bskd->bkgd", p, cv.float())
    return o, mx, p.sum(dim=-1)


def _merge(lay: Layout, split: bool, outs, ms, ls) -> List[torch.Tensor]:
    """Merge the shards' partial attentions across "model" by log-sum-
    exp, float32 in mesh order; every position gets its group's result
    (B, H, D). A cache whose slots are not ``split`` needs no merge: each
    shard attended over every slot."""
    if not split:
        return lay.each(lambda i: (outs[i] / ls[i][..., None]).reshape(
            outs[i].shape[0], -1, outs[i].shape[-1]))
    res: List[Optional[torch.Tensor]] = [None] * lay.n
    if lay.counting:
        # each counted position all-gathers its group's partials and
        # merges them itself
        for i in lay.active:
            g = len(lay.group[i])
            o, mx, sm = (M.record(lay.mesh, i, "all-gather", g,
                                  t.new_empty((g,) + t.shape))
                         for t in (outs[i], ms[i], ls[i]))
            f = torch.exp(mx - mx.amax(0))
            o = (o * f[..., None]).sum(0) / (sm * f).sum(0)[..., None]
            res[i] = o.reshape(o.shape[0], -1, o.shape[-1])
        return res
    for grp in M._groups(lay.mesh, ("model",)):
        dev = lay.devs[grp[0]]
        mx = None
        for j in grp:
            mj = ms[j].to(dev)
            mx = mj if mx is None else torch.maximum(mx, mj)
        o_acc, l_acc = None, None
        for j in grp:
            f = torch.exp(ms[j].to(dev) - mx)
            oj = outs[j].to(dev) * f[..., None]
            lj = ls[j].to(dev) * f
            o_acc = oj if o_acc is None else o_acc + oj
            l_acc = lj if l_acc is None else l_acc + lj
        o = o_acc / l_acc[..., None]
        o = o.reshape(o.shape[0], -1, o.shape[-1])
        for j in grp:
            res[j] = o.to(lay.devs[j], copy=True)
    return res
