"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, on a host with a CUDA card:

    python3 chip_smoke.py

It builds the five CUDA kernels from src/repro_torch/kernels/csrc (one
nvcc per source, in parallel, into build/kernels/) and prints ptxas's
registers, shared memory and spills of each and the count of
tensor-core instructions in each one's SASS, holds each kernel against
its plain PyTorch version at the main paths' shapes (rms_norm at 8,192
rows of each family's width, then each family's prefill timed with it
and with the plain norms; gnn_mp also at
N = 21 and 64, F = 1, an odd Fo, H x 1e3 and the LM bridge's N = 7
layers; flash_attention also at
Granite-20B's and Qwen2.5-32B's D = 128 prefills, Granite-3-2B's shards
on a (2, 2) mesh, Moonlight's on (1, 4), fewer queries than keys
(Granite-3-2B's context-parallel shards, Whisper's cross-attention),
ragged, full and D = 16/32 shapes) and times both, and the one PyTorch
call that computes
the same function where there is one, with CUDA events around a CUDA
graph of the calls, then drives the port's two main paths:

- the Gaussian accelerator: pruned library -> batched labeling of 2048
  configurations (SSIM through `lut_eval`) -> a paper-width two-stage
  GraphSAGE surrogate (5 layers, hidden 300, random weights from a seeded
  generator) served by `SurrogateEngine.from_gnn` (`gnn_mp` in every
  layer) and an oracle engine, with a device profile of one fresh
  512-configuration request;
- the other four accelerators (sobel, fir15, dct8, k-means) the same
  way, each with 8 configurations also labeled through the scalar path
  (`label_backend="loop"`) and held against the batched labels, then one
  cross-app surrogate (`dataset.merge` of all five, the same paper-width
  GraphSAGE over the 32-wide merged features) served per app by
  `SurrogateEngine.from_gnn_shared` (`apps_slice` line);
- training (`train_slice` line): the Gaussian dataset split 0.9, the
  paper-width gsae trained by `training.fit_two_stage` at
  `TrainConfig()` (40 epochs of batch 64), held first against the CPU
  (the first step's loss and gradients, two epochs' losses, dropout 0),
  evaluated on the held-out rows, profiled over 20 warm steps and served
  by `from_gnn`; then an 8-member `fit_ensemble` of 10 epochs against 8
  sequential fits, served by `from_gnn_ensemble` with its uncertainty;
- search (`search_slice` line): NSGA-III over the Gaussian design space
  at a budget of 20,000 with the trained surrogate (twice, on fresh
  engines, for determinism), the 4-island fleet at the same budget with
  its ranks computed on the card and held against NumPy, and the oracle
  on the NSGA-III front;
- the staged pipeline (`pipeline_slice` line): `run_staged` at
  `PipelineConfig.paper_faithful("gaussian")` (2,048 samples and 20
  epochs for the time limit) on an on-disk artifact store, cold, resumed
  on a new store and swept to the island sampler, `validate_pareto` on 10
  Pareto points with the card's oracle rows held against the CPU's, and
  an `EvalService` warmed from the store serving 8 client threads, each
  response held bit for bit against the same request served one by one;
- the splits over devices (`split_slice` line): over every card when
  there are several, else the one card named four times, each split held
  bit for bit against its unsplit run: the
  paper-width Gaussian engine's config rows (a fresh 512 and 2,048-config
  request, direct and through submit/drain, `gnn_mp` launches a chunk),
  the 8-member ensemble's member axis and the data-parallel fit's sample
  axis (2 epochs; the data-parallel fit within 1e-6, each in float64
  where float32 misses its bar), the 4-island fleet's rank kernel,
  `run_staged` with `eval_devices` on the pipeline slice's store (front
  identical), and GPipe: Granite-3-2B at full width and depth (random
  bf16 weights) as 4 stages of 10 layers, 8 micro-batches of 2 x 1024
  tokens, bit-equal to the blocks in sequence, `flash_attention` in
  every layer;
- the LM serving slice: Hymba-1.5B at full published width (32 layers,
  d_model 1600, 25 heads over 5 KV heads, SSM state 16, SWA window 1024)
  with random bf16 weights from a seeded generator, 8 prompts of 1024
  tokens through `make_prefill_step` (`flash_attention` and `ssm_scan` in
  every layer), then 32 greedy `make_decode_step` steps; held by
  prefill/decode consistency checks (float32 compute over all 32
  layers, bf16 over two), the float32 gap of a short prompt on the card
  against the CPU's plain path, and a card-against-CPU check of a
  two-layer model in bf16;
- the mixture-of-experts slice (`moe_slice` line): Moonlight-16B-A3B at
  full width and depth (48 layers, d_model 2048, 64 experts top-6,
  expert d_ff 1408, vocab 163,840; 28.06 B random bf16 parameters from
  a seeded generator, drawn in bounded pieces) on one card, the same
  prompts and steps as the LM slice (`flash_attention` in every prefill
  layer), the share of assignments dropped by capacity, the device time
  by MoE stage, a no-drop prefill/decode consistency check over two
  layers, a routing witness of two layers on the card against the CPU,
  and the LM `BatchServer` serving 8 requests through 4 slots;
- the last three LM families (`families_slice` line), each at full width
  and depth with random bf16 weights from a seeded generator, one after
  the other: Qwen2-VL-7B (8 prompts of 1024 tokens whose first 256
  positions are stub vision embeddings, M-RoPE positions with the image
  on a 16 x 16 grid; `flash_attention` in every layer), Whisper
  large-v3 (8 stub clips of 1500 frames through the encoder, full-mask
  `flash_attention` in every encoder layer, a 224-token decoder prompt
  with causal `flash_attention` in every decoder layer and full-mask
  `flash_attention` in its cross-attention, 224 queries over 1500
  frames) and RWKV-6 3B (8 prompts of 1024 tokens, the
  recurrence a step loop); 32 greedy decode steps each, a two-layer
  prefill + 4 steps vs longer-prefill check in bf16 (RWKV's float32
  state too) and a two-layer card-against-CPU check; Qwen2-VL's 32
  steps again on its bf16 cache and on an int8 one (`kv_int8`), fed the
  same greedy tokens: cache and peak GiB, ms a step, the logits' gap;
- LM training (`lm_train_slice` line): Hymba-1.5B at full width and
  depth, float32 master parameters from a seeded generator, AdamW,
  `TokenPipeline` batches of 8 x 1024 tokens in two micro-batches, remat
  on, through `make_train_step` (K3 forward and in each recompute with
  the plain version's backward, K4 forward, in each recompute and over
  reversed time in the backward): 2 warm and 4 timed steps, a device
  profile of one more; the two kernels' gradients against autograd of
  their plain versions at Hymba's shape, every parameter's gradient of
  the model cut to two layers on the card against the CPU (bf16 and
  float32), and a restart drill of `launch.train.train` (a crash, a
  restore, the end state against uninterrupted runs);
- the dense LM over a (data, model) mesh (`lm_mesh_slice` line):
  Granite-3-2B at full width and, here, 8 of its 40 layers (its full
  depth, 2 timed steps, 32 decode steps and a profiled step in
  `scripts/lm_mesh_slice.py dense`; the line's "reduced") on a (2, 2)
  mesh over every card, or card 0 named four times (`split_devices`):
  the tp training step of
  `launch.steps.plan` (float32 masters stored by BASE_RULES, bf16 compute
  copies gathered once a step, K3 at each shard's 16 query heads) over 8
  x 1024 tokens in two micro-batches, remat on, against the unsplit step
  from the same initial state (loss and first moments); the cp preset's
  step from the same
  state (context parallelism: each model shard projects its 512
  positions with every head, K3 takes them over the keys up to its
  block's end) against the unsplit and tp steps; serve8 (prefill of 8 x
  1024 tokens, 16 decode steps on the int8 cache whose slots split over
  "model") against the unsplit int8 run fed the same tokens, and a cp
  prefill against the unsplit and tp ones; `ef_allreduce` over
  "data" on one layer's gradients against the reference's formula; and
  the elastic restart of `launch.train.train` at two layers in float32,
  crashed on (2, 2) and restarted onto (4, 1) and one device;
- the mixture-of-experts family over a mesh (`lm_mesh_moe_slice` line),
  expert parallelism: Moonlight-16B-A3B at full width and, here, 8 of
  its 48 layers (its full depth and 32 decode steps in
  `scripts/lm_mesh_slice.py moe`) on (1, 4) (each shard 4 heads and 16
  experts), serve8 prefill of 8 x 1024 tokens and 16 decode steps
  against the unsplit one-card int8 run of the same weights, at twice
  that run's own gap to float32 compute; and its tp training step at
  full width and 3 of its 48 layers on (2, 2), 8 x 1024 tokens in two
  micro-batches, remat on, against the unsplit step (loss, first
  moments); capacity drops at the config's factor, the dropped share
  split and unsplit, a decode step's device profile by MoE stage;
- the hybrid and VLM families over meshes (`lm_mesh_families_slice`
  line), card 0 named as many times as a mesh has positions:
  Hymba-1.5B at full width and depth on (2, 2) (its 25 heads split on
  no m = 2: every shard computes every attention and SSM head, the ff
  columns split), the tp training step (8 x 1024 tokens in two
  micro-batches, remat on, K3 and K4 at every position) against the
  unsplit step from the same state (float32 compute at 4 layers within
  1e-4; the full-depth bf16 step, held within twice the unsplit step's
  own bf16-vs-float32 gap, is `scripts/lm_mesh_slice.py families`'s and
  left out here, the line's "reduced"), serve8 (the hybrid cache in bf16,
  16 decode steps here, 32 in the script) and a cp prefill against the
  unsplit run; Hymba on (1, 5), the one mesh that splits its heads (5
  query heads, one KV head, 5 SSM heads a shard), prefill and 8 decode
  steps; Qwen2-VL-7B serve8 on (1, 4) (7 query heads and one KV head a
  shard, 256 stub vision embeds and M-RoPE positions placed with the
  rows, 16 steps on the int8 cache here, 32 in the script); the serving
  runs here at 8 of their 32 and 28 layers (the script's at full depth;
  each line's "reduced");
- the encoder-decoder and attention-free families over meshes
  (`lm_mesh_whisper_rwkv_slice` line), card 0 named as many times as a
  mesh has positions: Whisper large-v3 at full width and depth, serve8
  on (1, 4) (8 prompts of 224 tokens over 1500 stub frames, 5 query and
  KV heads and 375 cross-cache frames a shard, 16 decode steps on the
  int8 self cache) and a cp prefill on (2, 2) (the encoder's 750-query
  blocks over its 1500 keys), its tp training step on (2, 2) (8 x 224
  decoder tokens over 8 x 1500 frames, two micro-batches, remat);
  RWKV-6 3B's tp serving on (1, 4) (8 prompts of 1024 tokens, 10 heads
  a shard, 8 decode steps against the families slice's run of the same
  weights and prompts) and its tp step on (2, 2) at 4 of its 32 layers
  over 8 x 128 tokens:
  the bf16 runs timed with their gap to the unsplit run reported, each
  held in float32 compute at 4 layers (RWKV-6's step at one: its float32
  gradient is too sensitive to roundings deeper) within 1e-4 beside a
  bf16 control that must exceed that bar, K3 counted in Whisper's
  encoder, self-attention and cross-attention;
- ApproxPilot-LM (`bridge_slice` line): `lm_bridge.train_surrogate` on
  Qwen2.5-32B's train_4k op graph at the reference's bench settings (400
  samples, 40 epochs), alone and as a 4-member ensemble, its engine
  serving 1,024 configs (`gnn_mp` in every gsae layer, chunks of 256
  graphs of 7 nodes), held to tests/test_system.py's properties;
  `lm_bridge.run_dse` on Granite-3-2B decode_32k and Qwen1.5-110B
  train_4k at a budget of 800, at the H100's constants and at the
  reference's, the latter fronts held bit for bit against a CPU process;
  and each LM path timed above (the five prefills, the training step)
  counted by `launch.dryrun` (`op_profile` on meta tensors) at the same
  batch and length, its roofline terms at the H100's constants beside
  the measured ms, a bound over the measured time failing the run.

Launch counters are zeroed just before each main path and read just
after; the `kernels` line sums the accelerator paths' counts and the
bridge's. The last line of standard output is the device JSON; the line
before it is the per-kernel JSON. Exits non-zero without a CUDA card,
outside a checkout, or when any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
GNN_TOL = 1e-4          # 3xTF32 against cuBLAS fp32: another summation order
PARITY_ATOL = 2e-3      # the reference engine's kernel-vs-plain bar
# the slice: Gaussian, paper-width GNN (Sec IV-A: 5 layers, hidden 300)
N_SAMPLES, N_LAYERS, HIDDEN, CHUNK = 2048, 5, 300, 512
# flash_attention against its plain version, which rounds p to bf16 at
# the same place. Each rounds every p_i (the kernel unnormalized, the
# plain version normalized) by up to 2^-8 of it and rounds each output,
# so an output o = sum_i p_i v_i may move by up to 2^-7 (sum_i p_i |v_i|
# + |o|) <= 2^-6 sum_i p_i |v_i|: a bar per element, which a bar in |o|
# cannot be (a row with few keys may have |o| far below the sum). Over a
# query row the roundings are independent, a few 2^-9 of the row's norm:
# a bar of 2e-2 on each row's relative L2 error, which a dropped key tile
# (1/16 of a late row's keys, ~25%) exceeds tenfold. float32: another
# summation order, 1e-4.
FA_BF16_ELEM, FA_BF16_ROW, FA_F32_TOL = 2.0 ** -6, 2e-2, 1e-4
# the LM slice: Hymba-1.5B at full width, 8 prompts of 1024 tokens, a
# decode horizon of 1056 slots, 32 greedy steps
LM_ARCH, LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS = \
    "hymba-1.5b", 8, 1024, 1056, 32
# prefill+decode against one longer prefill: tests/test_models.py's bar
# for decode against forward
LM_RTOL, LM_ATOL = 0.1, 0.15
# the second witness: at a short prompt the bf16 KV cache sets the
# float32 gap between the two orders; the card's gap, and the card's
# logits against the CPU's, within a quarter of the CPU path's gap (the
# port against the reference in float32 at reduced width reads 4% of it)
LM_WITNESS_PROMPT, WITNESS_SHARE = 100, 0.25
# card against CPU in bf16 over two layers: products rounded after
# another summation order (cuBLAS, oneDNN); the logits read 0.031
CARD_CPU_TOL = (5e-2, 5e-2)
# the SSM state: float32 sums of bf16 inputs that may differ by an ulp;
# an absolute bar at 1% of the state's largest entry
CARD_CPU_SSM_ATOL = 1e-2
# the MoE slice: Moonlight-16B-A3B at full width and depth (48 layers,
# 64 experts top-6) on one card, the LM slice's prompts and steps; its
# BatchServer serves 8 requests of 16 prompt tokens and 16 new tokens
# through 4 slots
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_SERVE = dict(requests=8, slots=4, prompt=16, max_new=16)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls, from CUDA
    events around one replay of a CUDA graph that holds the ``iters``
    calls, after a warm-up. The graph keeps the host's cost of a launch
    (Python, the wrapper's checks) out of the reading: issued back to
    back, a kernel shorter than that cost would read the host's time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back eager
    calls, from CUDA events: the device time, or the host's where the
    host cannot keep up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled template kernel, e.g.
    ``flash_wgmma_kernel<64>``; the mangled name if it is not one."""
    import re
    m = re.search(r"_kernel(?=[IEv])", mangled)
    if m is None:
        return mangled
    end = m.end()
    # the identifier is preceded by its length in digits
    for start in range(end - len("_kernel"), 0, -1):
        if mangled[:start].endswith(str(end - start)):
            ident = mangled[start:end]
            args = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[end:])
            if args is None:
                return ident
            vals = re.findall(r"L[a-z]+(\d+)E", args.group(1))
            return f"{ident}<{','.join(vals)}>"
    return mangled


def ptxas_report(build) -> dict:
    """Registers, static shared memory and spill bytes of every kernel
    this process built, from ``-Xptxas -v`` (build.NVCC_FLAGS)."""
    return {src: {kernel_name(fn): res
                  for fn, res in build.resources(log).items()}
            for src, log in build.LOGS.items()}


def sass_report(build) -> dict:
    """Count of tensor-core instructions (HMMA, HGMMA) in each kernel
    function's SASS, from cuobjdump beside nvcc; "not measured" where the
    toolkit has none."""
    import re
    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {"cuobjdump": "not measured: the toolkit has no cuobjdump"}
    out = {}
    for name in build.LOGS:
        sass = subprocess.run([str(tool), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True).stdout
        fns = {}
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = kernel_name(m.group(1))
                fns[fn] = {"HMMA": 0, "HGMMA": 0}
            elif fn is not None:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        fns[fn][op] += 1
                        break
        out[name] = fns
    return out


def bound_ms(n_bytes: float, n_flops: float, peak=PEAK_FP32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


FAILURES = []


def check(cond: bool, what: str) -> None:
    """Record a check that did not hold. The run goes on, so that every
    reading is printed, and fails at the end."""
    if not cond:
        FAILURES.append(what)
        print(f"chip_smoke: check failed: {what}", file=sys.stderr,
              flush=True)


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------

# K1's shapes: (B, N, F, Fo, scale of H). The first three are the
# Gaussian engine's (the first layer, the hidden layers, a ragged chunk);
# then N = 21, which does not divide the block's 64 rows, one graph of 64
# a block, F = 1 with Fo = 8, an odd Fo (the weights staged by 4-byte
# copies), and H x 1e3, where the lo terms of 3xTF32 decide the result;
# last the bridge surrogate's layers (a chunk of 256 op graphs of 7 nodes,
# 12 -> 64 and 64 -> 64).
GNN_SHAPES = [(512, 32, 27, 300, 1.0), (512, 32, 300, 300, 1.0),
              (37, 32, 300, 300, 1.0), (64, 21, 27, 300, 1.0),
              (16, 64, 300, 300, 1.0), (40, 32, 1, 8, 1.0),
              (48, 7, 13, 37, 1.0), (512, 32, 300, 300, 1e3),
              (256, 7, 12, 64, 1.0), (256, 7, 64, 64, 1.0)]


def gnn_mp_phase(gen):
    """K1 against its fp32 plain version (cuBLAS, TF32 off) at GNN_TOL,
    with the adjacency shared and batched. At H x s the bar is GNN_TOL in
    units of s (both sides divided by s): the plain fp32 version itself
    misses an absolute 1e-4 there against float64. Each row also reports
    the kernel's and the plain version's error against float64."""
    import torch
    from repro_torch.kernels import gnn_mp, ref
    dev = torch.device("cuda")
    rows = []
    for B, N, F, Fo, scale in GNN_SHAPES:
        adj = torch.rand(N, N, device=dev, generator=gen)
        h = torch.randn(B, N, F, device=dev, generator=gen) * scale
        ws = torch.randn(F, Fo, device=dev, generator=gen) * F ** -0.5
        wn = torch.randn(F, Fo, device=dev, generator=gen) * F ** -0.5
        b = torch.randn(Fo, device=dev, generator=gen) * 0.1
        err = 0.0
        for a in (adj, adj.expand(B, N, N).contiguous()):
            got = gnn_mp.gnn_mp(a, h, ws, wn, b)
            want = ref.gnn_mp_ref(a, h, ws, wn, b)
            torch.cuda.synchronize()
            check(torch.allclose(got / scale, want / scale, rtol=GNN_TOL,
                                 atol=GNN_TOL),
                  f"gnn_mp {B}x{N}x{F}->{Fo} (H x {scale:g}) disagrees with "
                  f"gnn_mp_ref")
            err = max(err, float((got - want).abs().max()))
        exact = ref.gnn_mp_ref(*(t.double() for t in (adj, h, ws, wn, b)))
        f64_err = float((got.double() - exact).abs().max())
        plain_f64_err = float((want.double() - exact).abs().max())
        del got, want, exact
        ms = cuda_ms(lambda: gnn_mp.gnn_mp(adj, h, ws, wn, b), 20)
        plain = cuda_ms(lambda: ref.gnn_mp_ref(adj, h, ws, wn, b), 20)
        flops = 2 * B * N * F * Fo * 2 + 2 * B * N * N * Fo
        nbytes = 4 * (N * N + B * N * F + 2 * F * Fo + Fo + B * N * Fo)
        # on the TF32 tensor cores, each product issued three times
        bnd, by = bound_ms(nbytes, 3 * flops, PEAK_TF32_FLOPS)
        rows.append({"shape": [B, N, F, Fo], "h_scale": scale,
                     "max_abs_err": err, "f64_err": f64_err,
                     "plain_f64_err": plain_f64_err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": "operations (3xTF32)"
                     if by == "operations" else by,
                     "fp32_simt_bound_ms": bound_ms(nbytes, flops)[0],
                     "gflop": flops / 1e9})
    return rows


def lut_eval_phase(gen):
    """K2 on seven tables of the main paths (the Gaussian, FIR-15 and
    DCT-8 constant-coefficient columns, two full multiplier tables and
    k-means' two), bit-exact at M, M + 777 and 1023 elements (and from a
    start off a 16-byte boundary), timed in the form the main path calls:
    without b where wb = 0 (the columns, sqrt), with b otherwise. The
    columns are also timed with a zero b, the form the kernel took
    before b became optional."""
    import numpy as np
    import torch
    from repro_torch.accel import library as lib
    from repro_torch.core import pruning
    from repro_torch.kernels import lut_eval, ref
    dev = torch.device("cuda")
    pruned, _ = pruning.prune_library()
    g17 = lib.stacked_lut(tuple(pruned["mul8x4"]), 8, 4)
    f10 = lib.stacked_lut(tuple(pruned["mul8x4"]), 10, 4)
    d13 = lib.stacked_lut(tuple(pruned["mul8x4"]), 13, 4)
    tables = {
        # (table, wb, operand a range per entry, entries)
        "gaussian_mul8x4_column": (g17.view(-1, 16)[:, 4].contiguous(), 0,
                                   8, len(pruned["mul8x4"])),
        "gaussian_mul8x4_8x4": (g17, 4, 8, len(pruned["mul8x4"])),
        # the columns of fir15's (68 KiB) and dct8's (544 KiB) constant
        # coefficients, which their functional models gather from
        "fir15_mul8x4_column": (f10.view(-1, 16)[:, 5].contiguous(), 0, 10,
                                len(pruned["mul8x4"])),
        "dct8_mul8x4_column": (d13.view(-1, 16)[:, 12].contiguous(), 0, 13,
                               len(pruned["mul8x4"])),
        "dct8_mul8x4_13x4": (d13, 4, 13, len(pruned["mul8x4"])),
        "kmeans_mul8_9x9": (lib.stacked_lut(tuple(pruned["mul8"]), 9, 9), 9,
                            9, len(pruned["mul8"])),
        "kmeans_sqrt18_20x0": (lib.stacked_lut(tuple(pruned["sqrt18"]), 20,
                                               0), 0, 20,
                               len(pruned["sqrt18"])),
    }
    rng = np.random.default_rng(0)
    rows = []
    M = 256 * 4 * 64 * 64            # one labeling chunk of one unit node
    # dct8's multipliers see one 8-pixel row of each block a call
    ELEMS = {"dct8_mul8x4_column": 256 * 4 * 64 * 8}

    def operands(m, wb, ea, n_ent):
        e = rng.integers(0, n_ent, m)
        a = torch.from_numpy(((e << ea) | rng.integers(0, 1 << ea, m))
                             .astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 1 << wb, m)
                             .astype(np.int32)).to(dev)
        return a, b

    for name, (table, wb, ea, n_ent) in tables.items():
        lut = table.to(dev)
        forms = ["a", "a,b"] if wb == 0 else ["a,b"]
        Mt = ELEMS.get(name, M)
        for m in (Mt, Mt + 777, 1023):
            a, b = operands(m + 1, wb, ea, n_ent)
            for form in forms:
                bb = b if form == "a,b" else None
                # a[1:] starts 4 bytes past a 16-byte boundary: the
                # kernel's scalar path
                for x, y in ((a[:m], None if bb is None else bb[:m]),
                             (a[1:], None if bb is None else bb[1:])):
                    got = lut_eval.lut_eval(lut, x, y, wb)
                    check(torch.equal(got, ref.lut_eval_ref(lut, x, y, wb)),
                          f"lut_eval {name} ({form}) M={m} offset "
                          f"{x.storage_offset()} is not bit-exact")
        a, b = operands(Mt, wb, ea, n_ent)
        for form in forms:
            bb = b if form == "a,b" else None
            idx = ((a << wb) | b).long()
            ms = cuda_ms(lambda: lut_eval.lut_eval(lut, a, bb, wb), 50)
            eager = eager_ms(lambda: lut_eval.lut_eval(lut, a, bb, wb), 50)
            plain = cuda_ms(lambda: ref.lut_eval_ref(lut, a, bb, wb), 50)
            library = cuda_ms(lambda: torch.take(lut, idx), 50)
            per_elem = 12 if bb is not None else 8
            bnd, by = bound_ms(4 * lut.numel() + per_elem * Mt, 0)
            rows.append({"table": name, "form": form,
                         "path": lut_eval.path(4 * lut.numel()),
                         "table_kib": 4 * lut.numel() / 1024, "m": Mt,
                         "max_abs_err": 0, "ms": ms, "eager_ms": eager,
                         "plain_ms": plain, "library_ms": library,
                         "bound_ms": bnd,
                         "bound_by": by,
                         "gb_per_s": (4 * lut.numel() + per_elem * Mt)
                         / ms / 1e6})
    return rows


# K3's shapes: (label, B, H, KV, S, D, dtype, causal), S an int (Sq = Sk)
# or a pair (Sq, Sk) of fewer queries than keys. The first is the
# Hymba-1.5B prefill (the kernels line reports it), the second the
# Moonlight-16B-A3B prefill (MHA: one query head per KV head); the other
# D = 128 rows are Granite-20B (MQA) and Qwen2.5-32B (GQA) prefills of
# 1024 tokens. The families slice's: the Qwen2-VL-7B prefill (G = 7),
# Whisper's encoder (a full mask over 1500 frames, not a multiple of the
# tile) and its decoder's 224-token prompt. Last the split slice's GPipe
# micro-batch of Granite-3-2B (2 x 1024 tokens, GQA 32/8, D = 64).
FA_SHAPES = [
    ("hymba_prefill", 8, 25, 5, 1024, 64, "bfloat16", True),
    ("moonshot_prefill_mha_d128", 8, 16, 16, 1024, 128, "bfloat16", True),
    ("hymba_ragged_1025", 8, 25, 5, 1025, 64, "bfloat16", True),
    ("hymba_float32", 8, 25, 5, 1024, 64, "float32", True),
    ("granite20b_mqa_d128", 2, 48, 1, 1024, 128, "bfloat16", True),
    ("qwen2.5_32b_gqa_d128", 2, 40, 8, 1024, 128, "bfloat16", True),
    ("hymba_ragged_1000", 8, 25, 5, 1000, 64, "bfloat16", True),
    ("full_d128_s200", 8, 40, 8, 200, 128, "bfloat16", False),
    ("qwen2_vl_prefill_gqa7_d128", 8, 28, 4, 1024, 128, "bfloat16", True),
    ("whisper_encoder_full_s1500", 8, 20, 20, 1500, 64, "bfloat16", False),
    ("whisper_decoder_s224", 8, 20, 20, 224, 64, "bfloat16", True),
    ("d32_s333", 4, 8, 2, 333, 32, "bfloat16", True),
    ("d16_s77", 4, 4, 2, 77, 16, "bfloat16", True),
    ("granite3_2b_gpipe_micro", 2, 32, 8, 1024, 64, "bfloat16", True),
    # a model shard of Granite-3-2B on the (2, 2) mesh: 16 query heads,
    # 4 KV heads; 2 rows a training micro-batch, 4 a prefill
    ("granite3_2b_mesh_train_shard", 2, 16, 4, 1024, 64, "bfloat16", True),
    ("granite3_2b_mesh_prefill_shard", 4, 16, 4, 1024, 64, "bfloat16",
     True),
    # Moonlight-16B-A3B's model shard on the (1, 4) serving mesh: 4 of its
    # 16 heads (MHA), 8 prompts of 1024 tokens
    ("moonlight_mesh_shard_d128", 8, 4, 4, 1024, 128, "bfloat16", True),
    # Granite-3-2B's context-parallel shards on the (2, 2) mesh: a model
    # shard's 512 queries over the keys up to its block's end, every head,
    # 2 rows (a training micro-batch); the first block's keys are its own
    ("granite3_2b_cp_shard0", 2, 32, 8, (512, 512), 64, "bfloat16", True),
    ("granite3_2b_cp_shard1", 2, 32, 8, (512, 1024), 64, "bfloat16", True),
    # Whisper-large-v3's cross-attention: the decoder's 224-token prompt
    # over the encoder's 1500 frames, a full mask
    ("whisper_cross_224x1500", 8, 20, 20, (224, 1500), 64, "bfloat16",
     False),
    # ragged lengths below the tiles, and the float32 path, at Sq < Sk
    ("ragged_d32_200x333", 2, 8, 2, (200, 333), 32, "bfloat16", True),
    ("float32_256x768", 2, 8, 2, (256, 768), 64, "float32", True),
    # the hybrid and VLM families' model shards: Hymba-1.5B on (2, 2),
    # every head (25 split on no m = 2), 2 rows a training micro-batch, 4
    # a prefill, and its cp shards' 512 queries over 512 and 1024 keys;
    # on (1, 5) 5 query heads and one KV head; Qwen2-VL-7B on (1, 4), 7
    # query heads and one KV head (G = 7)
    ("hymba_mesh_train_shard", 2, 25, 5, 1024, 64, "bfloat16", True),
    ("hymba_mesh_prefill_shard", 4, 25, 5, 1024, 64, "bfloat16", True),
    ("hymba_cp_shard0", 4, 25, 5, (512, 512), 64, "bfloat16", True),
    ("hymba_cp_shard1", 4, 25, 5, (512, 1024), 64, "bfloat16", True),
    ("hymba_1x5_shard", 8, 5, 1, 1024, 64, "bfloat16", True),
    ("qwen2_vl_1x4_shard_gqa7_d128", 8, 7, 1, 1024, 128, "bfloat16", True),
    # Whisper large-v3's model shards: on (1, 4) 5 of its 20 heads (MHA)
    # over 8 rows, on (2, 2) 10 heads over a training micro-batch's 2
    # rows, each at its encoder (1500 frames, full), its decoder's
    # 224-token self-attention (causal) and its cross-attention (224 over
    # 1500, full); and the cp prefill's encoder block on (2, 2), 750
    # queries over the 1500 keys, every head, 4 rows
    ("whisper_1x4_shard_encoder", 8, 5, 5, 1500, 64, "bfloat16", False),
    ("whisper_1x4_shard_decoder", 8, 5, 5, 224, 64, "bfloat16", True),
    ("whisper_1x4_shard_cross", 8, 5, 5, (224, 1500), 64, "bfloat16",
     False),
    ("whisper_mesh_train_shard_encoder", 2, 10, 10, 1500, 64, "bfloat16",
     False),
    ("whisper_mesh_train_shard_decoder", 2, 10, 10, 224, 64, "bfloat16",
     True),
    ("whisper_mesh_train_shard_cross", 2, 10, 10, (224, 1500), 64,
     "bfloat16", False),
    ("whisper_cp_encoder_block", 4, 20, 20, (750, 1500), 64, "bfloat16",
     False),
]


def fa_lengths(S):
    """(Sq, Sk) of a K3 shape's S."""
    return tuple(S) if isinstance(S, (tuple, list)) else (S, S)


def fa_pairs(Sq: int, Sk: int, causal: bool) -> float:
    """Query-key pairs K3 computes: under ``causal`` row i reads keys up
    to its position Sk - Sq + i (the bottom-right triangle and the
    rectangle left of it), else all Sq x Sk."""
    return Sq * (Sk - Sq) + Sq * (Sq + 1) / 2 if causal else Sq * Sk


def sdpa(q, k, v, causal: bool):
    """The library's attention over the same inputs: SDPA with its own
    causal flag where Sq == Sk (aligned top-left, the same mask there), and
    with the bottom-right causal bias where Sq < Sk."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    Sq, Sk = q.shape[2], k.shape[2]
    if causal and Sq != Sk:
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal_lower_right(Sq, Sk), enable_gqa=True)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def flash_attention_phase(gen, shapes=FA_SHAPES):
    """K3 against its plain version and SDPA on model-layout (B,S,H,D)
    tensors read in place: bf16 at the per-element and per-row bars,
    float32 at FA_F32_TOL."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    rows = []
    for label, B, H, KV, S, D, dt, causal in shapes:
        dt = getattr(torch, dt)
        Sq, Sk = fa_lengths(S)
        q, k, v = (torch.randn(B, n_s, n, D, device=dev, generator=gen)
                   .to(dt).transpose(1, 2)
                   for n, n_s in ((H, Sq), (KV, Sk), (KV, Sk)))
        got = fa.flash_attention(q, k, v, causal=causal).float()
        want = ref.flash_attention_ref(q, k, v, causal=causal).float()
        err = (got - want).abs()
        acc = {"max_abs_err": float(err.max())}
        if dt == torch.bfloat16:
            # sum_i p_i |v_i| for every output, in float32
            p_abs_v = ref.flash_attention_ref(q.float(), k.float(),
                                              v.float().abs(), causal=causal)
            acc["err_over_p_abs_v"] = float(
                (err / p_abs_v.clamp_min(1e-30)).max())
            acc["row_rel_l2"] = float(
                (err.norm(dim=-1) / want.norm(dim=-1)).max())
            ok = (acc["err_over_p_abs_v"] <= FA_BF16_ELEM
                  and acc["row_rel_l2"] <= FA_BF16_ROW)
            del p_abs_v
        else:
            ok = torch.allclose(got, want, rtol=FA_F32_TOL, atol=FA_F32_TOL)
        check(ok, f"flash_attention {label} {B}x{H}/{KV}x{Sq}x{Sk}x{D} "
              f"{dt} disagrees with its plain version: {acc}")
        del got, want, err
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal), 20)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                        causal=causal), 5)
        library = cuda_ms(lambda: sdpa(q, k, v, causal), 20)
        # query-key pairs (`fa_pairs`), 2 products of 2D FLOP each; q and
        # o once, k and v once
        flops = 4 * B * H * D * fa_pairs(Sq, Sk, causal)
        nbytes = q.element_size() * (2 * B * H * Sq * D
                                     + 2 * B * KV * Sk * D)
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
        bnd, by = bound_ms(nbytes, flops, peak)
        rows.append({"label": label, "shape": [B, H, KV, S, D],
                     "dtype": str(dt), "causal": causal, **acc, "ms": ms,
                     "plain_ms": plain, "library_ms": library,
                     "bound_ms": bnd, "bound_by": by, "gflop": flops / 1e9,
                     "tflop_per_s": flops / ms / 1e9})
    return rows


# K4's (T, D = B*H*Dh*N, the channels a decay is shared by): the LM
# slice's prefill (8 rows, 25 heads, Dh 64, N 16), the full (T, D) decay
# and a ragged T; then the mesh shards of Hymba-1.5B: on (2, 2) every
# head of a prefill's 4 rows and a training micro-batch's 2, on (1, 5)
# 5 heads of 8 rows
SCAN_SHAPES = [(1024, 8 * 25 * 64 * 16, 64 * 16),
               (1024, 8 * 25 * 64 * 16, 1),
               (1000, 8 * 25 * 64 * 16, 64 * 16),
               (1024, 4 * 25 * 64 * 16, 64 * 16),
               (1024, 2 * 25 * 64 * 16, 64 * 16),
               (1024, 8 * 5 * 64 * 16, 64 * 16)]


def ssm_scan_phase(gen, shapes=SCAN_SHAPES):
    """K4 against its plain version, bit for bit, at ``shapes`` (T, D,
    the channels a compact decay is shared by)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as sc
    dev = torch.device("cuda")
    rows = []
    for T, D, rep in shapes:
        a = torch.rand(T, D // rep, device=dev, generator=gen) * 0.95
        b = torch.randn(T, D, device=dev, generator=gen)
        y0 = torch.randn(D, device=dev, generator=gen)
        ys, yf = sc.ssm_scan(a, b, y0)
        a_full = a.repeat_interleave(rep, dim=1)
        want_ys, want_yf = ref.ssm_scan_ref(a_full, b, y0)
        torch.cuda.synchronize()
        # a rounded multiply, then a rounded add, on both sides
        check(torch.equal(ys, want_ys) and torch.equal(yf, want_yf),
              f"ssm_scan T={T} D={D} rep={rep} is not bit-exact")
        ms = cuda_ms(lambda: sc.ssm_scan(a, b, y0), 20)
        plain = cuda_ms(lambda: ref.ssm_scan_ref(a_full, b, y0), 2, warmup=1)
        bnd, by = bound_ms(4 * (a.numel() + 2 * T * D + 2 * D), 2 * T * D)
        rows.append({"T": T, "D": D, "decay_repeat": rep, "max_abs_err": 0,
                     "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by})
    return rows


# the norm kernel's rows: a call of the benchmark cell (8,192 tokens) at
# each family's width, Qwen2-VL-7B's first (the cell's); its epsilon
NORM_ROWS, NORM_EPS = 8192, 1e-6
NORM_WIDTHS = (("qwen2-vl-7b", 3584), ("hymba-1.5b", 1600),
               ("whisper-large-v3", 1280), ("granite-3-2b", 2048),
               ("rwkv6-3b", 2560), ("qwen2.5-32b", 5120),
               ("granite-20b", 6144))
# inputs a timing cycles through: more bytes than the 50 MB L2 holds, so
# every launch reads its row from device memory, as the bound counts
NORM_SWEEP_BYTES = 256 * 2 ** 20
# a family's float32 prefill with the kernel against one with the plain
# norms: the last logits apart by at most this share of their largest
# entry (only the order of the norm's float32 sums differs; a norm that
# misses a row, gamma or the mean moves them by the logits' own size)
NORM_F32_SHARE = 1e-3


def norm_launches(cfg, recompute: bool = False) -> int:
    """The norm kernel's launches in one forward on the card: two a block
    and the final norm; Whisper's decoder blocks three (the
    cross-attention's), its encoder blocks two and the encoder's final
    norm besides; with ``recompute`` (remat's backward) the blocks'
    twice."""
    blocks = (3 * cfg.n_layers + 2 * cfg.enc_layers if cfg.enc_dec
              else 2 * cfg.n_layers)
    return blocks * (1 + recompute) + 1 + bool(cfg.enc_dec)


def norm_ulps(got, want) -> float:
    """The largest |got - want| in units of the last place of want (a
    2-byte float type)."""
    import torch
    w = want.double()
    ulp = torch.finfo(want.dtype).eps * torch.exp2(
        torch.floor(torch.log2(w.abs().clamp_min(1e-30))))
    return float(((got.double() - w).abs() / ulp).max())


def rms_norm_phase(gen, widths=NORM_WIDTHS):
    """The norm kernel against its plain version (within one ulp of bf16)
    at NORM_ROWS x d bf16 for each width, timed beside the plain version
    and `F.rms_norm` (the library's yardstick; the port never calls it),
    each cycling through inputs of NORM_SWEEP_BYTES."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rms_norm as nk
    dev = torch.device("cuda")
    rows, out = NORM_ROWS, []
    for label, d in widths:
        n_in = -(-NORM_SWEEP_BYTES // (2 * rows * d))
        xs = [torch.randn(rows, d, device=dev, generator=gen)
              .to(torch.bfloat16) for _ in range(n_in)]
        g = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)) \
            .to(torch.bfloat16)
        got = nk.rms_norm(xs[0], g, NORM_EPS)
        want = ref.rms_norm_ref(xs[0], g, NORM_EPS)
        ulps = norm_ulps(got, want)
        exact = float((got == want).float().mean())
        check(ulps <= 1.0, f"rms_norm {label} {rows}x{d}: {ulps} ulp from "
              f"its plain version")
        del got, want
        turn = [0]

        def cycled(fn):
            def call():
                fn(xs[turn[0] % n_in])
                turn[0] += 1
            return call
        iters = 10 * n_in
        ms = cuda_ms(cycled(lambda x: nk.rms_norm(x, g, NORM_EPS)), iters)
        plain = cuda_ms(cycled(lambda x: ref.rms_norm_ref(x, g, NORM_EPS)),
                        n_in)
        library = cuda_ms(cycled(lambda x: F.rms_norm(x, (d,), g, NORM_EPS)),
                          iters)
        # x read and the result written once in bf16, gamma once; a
        # square, an add and two multiplies an element
        nbytes = 2 * (2 * rows * d + d)
        bnd, by = bound_ms(nbytes, 4 * rows * d)
        out.append({"label": label, "shape": [rows, d], "dtype": "bfloat16",
                    "plan": list(nk.plan(d, 2, True)), "max_ulps": ulps,
                    "exact_share": exact, "ms": ms, "plain_ms": plain,
                    "library_ms": library, "bound_ms": bnd, "bound_by": by,
                    "share_of_bound": bnd / ms,
                    "gb_per_s": nbytes / ms / 1e6})
        del xs
    return out


@contextmanager
def plain_norms():
    """`layers.rms_norm` through the plain version on the card, as before
    the kernel (a measurement's yardstick; the port has no such route)."""
    from repro_torch.kernels import ops, ref
    kernel = ops.rms_norm
    ops.rms_norm = ref.rms_norm_ref
    try:
        yield
    finally:
        ops.rms_norm = kernel


# the prefills timed with the norm kernel and with the plain norms:
# (arch, prompt tokens, decode horizon), 8 prompts each
NORM_FAMILIES = (("qwen2-vl-7b", LM_PROMPT, LM_MAX_LEN),
                 ("hymba-1.5b", LM_PROMPT, LM_MAX_LEN),
                 ("whisper-large-v3", 224, 224 + LM_STEPS),
                 ("rwkv6-3b", LM_PROMPT, LM_MAX_LEN))


def rms_norm_families_phase(card: str, dev, families=NORM_FAMILIES,
                            archs=None, batch: int = LM_BATCH):
    """Each family's warm prefill at full width and depth (random bf16
    weights), timed in turns with the plain norms and with the kernel
    (plain, kernel, kernel, plain, twice), one model at a time; the norm
    launches of one prefill and the logits' largest gap between the two
    routes. Then the same weights in float32, both routes again: their
    logits within NORM_F32_SHARE (checked), and the bf16 logits' gap to
    the float32 ones with the plain norms, the rounding's own reach
    beside the routes' bf16 gap."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import rms_norm as nk
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map
    archs = archs or ARCHS
    report = {"card": card, "batch": batch, "f32_share": NORM_F32_SHARE,
              "models": {}}
    for name, prompt_len, max_len in families:
        cfg = archs[name]
        gen = torch.Generator(device=dev).manual_seed(0)
        params = transformer.build_param_table(cfg).init(
            gen, device=dev, dtype=torch.bfloat16)
        tokens, extra = family_inputs(cfg, gen, dev, batch, max_len)
        prompt = family_batch(tokens, extra, prompt_len)
        prefill = steps.make_prefill_step(cfg, max_len=max_len)
        prefill32 = steps.make_prefill_step(
            dataclasses.replace(cfg, dtype="float32"), max_len=max_len)
        times = {"plain": [], "kernel": []}
        with torch.inference_mode():
            with plain_norms():
                want = prefill(params, prompt)[0]
            nk.LAUNCHES.reset()
            got = prefill(params, prompt)[0]
            launches = nk.LAUNCHES.value
            for route in ["plain", "kernel", "kernel", "plain"] * 2:
                if route == "plain":
                    with plain_norms():
                        _, ms = timed_ms(dev, lambda: prefill(params, prompt))
                else:
                    _, ms = timed_ms(dev, lambda: prefill(params, prompt))
                times[route].append(ms)
            params = tree_map(lambda a: a.float() if a.is_floating_point()
                              else a, params)
            with plain_norms():
                want32 = prefill32(params, prompt)[0].float()
            got32 = prefill32(params, prompt)[0].float()
        gap = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        gap32 = float((got32 - want32).abs().max())
        scale32 = float(want32.abs().max())
        check(gap32 <= NORM_F32_SHARE * scale32,
              f"{name}: float32 logits {gap32} apart with the kernel and "
              f"the plain norms, beyond {NORM_F32_SHARE} of {scale32}")
        per_run = norm_launches(cfg)
        check(launches == per_run, f"{name}: {launches} rms_norm launches "
              f"in a prefill, not {per_run}")
        report["models"][name] = {
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "prompt": prompt_len, "launches": launches,
            "plain_ms": times["plain"], "kernel_ms": times["kernel"],
            "plain_ms_median": sorted(times["plain"])[len(times["plain"])
                                                      // 2],
            "kernel_ms_median": sorted(times["kernel"])[len(times["kernel"])
                                                        // 2],
            "logits_max_gap": gap, "logits_max_abs": scale,
            "f32_logits_max_gap": gap32, "f32_logits_max_abs": scale32,
            "bf16_vs_f32_plain_max_gap": float(
                (want.float() - want32).abs().max())}
        del params, tokens, extra, prompt, want, got, want32, got32
        gc.collect()
        torch.cuda.empty_cache()
    return report


# --------------------------------------------------------------------------
# the main paths
# --------------------------------------------------------------------------

def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counts() -> dict:
    """The launch counts of the main slices' kernels, `lut_eval`'s by
    route too."""
    from repro_torch.kernels import gnn_mp, lut_eval
    return {"gnn_mp": gnn_mp.LAUNCHES.value,
            "lut_eval": lut_eval.LAUNCHES.value,
            "lut_eval_routes": {r: c.value for r, c in
                                lut_eval.ROUTE_LAUNCHES.items()}}


def reset_launch_counts() -> None:
    from repro_torch.kernels import gnn_mp, lut_eval
    for c in [gnn_mp.LAUNCHES, lut_eval.LAUNCHES,
              *lut_eval.ROUTE_LAUNCHES.values()]:
        c.reset()


def counts_sum(a: dict, b: dict, sign: int = 1) -> dict:
    """``a + sign * b`` of two `launch_counts` readings."""
    return {"gnn_mp": a["gnn_mp"] + sign * b["gnn_mp"],
            "lut_eval": a["lut_eval"] + sign * b["lut_eval"],
            "lut_eval_routes": {
                r: n + sign * b["lut_eval_routes"][r]
                for r, n in a["lut_eval_routes"].items()}}


def counts_since(before: dict) -> dict:
    return counts_sum(launch_counts(), before, -1)


def slice_phase(card: str, dev):
    """Drive the main path on ``dev``; returns (report, launches, (app
    context, dataset))."""
    import numpy as np
    import torch
    from repro_torch.accel import apps, batch_oracle
    from repro_torch.core import dataset, gnn, models, pipeline
    from repro_torch.core.engine import SurrogateEngine
    report = {"card": card, "requests": []}

    reset_launch_counts()
    t0 = time.perf_counter()
    ctx = pipeline.app_context("gaussian", device=dev)
    ds = dataset.build("gaussian", n_samples=N_SAMPLES,
                       lib_entries=ctx.entries, device=dev)
    sync(dev)
    report["dataset_s"] = time.perf_counter() - t0
    cfg = models.TwoStageConfig(gnn=gnn.GNNConfig(
        arch="gsae", n_layers=N_LAYERS, hidden=HIDDEN,
        feature_dim=ds.x.shape[-1]))
    params = models.init(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    t0 = time.perf_counter()
    eng = SurrogateEngine.from_gnn(cfg, params, ds, ctx.app, ctx.entries,
                                   chunk_size=CHUNK, device=dev)
    report["engine_build_s"] = time.perf_counter() - t0
    check(eng.backend == ("gnn_mp" if dev.type == "cuda" else "torch"),
          f"engine backend {eng.backend}")

    known = set(ds.configs)
    # the first 4096 draws are those of a sample of 4096 (same seed)
    pool = [c for c in dataset.sample_configs(ctx.app, 5000, seed=1,
                                              lib_entries=ctx.entries)
            if c not in known]
    blocks = [pool[0:512], pool[512:1024], pool[1024:1536]]
    ragged = pool[1536:1836]
    # the wave spans two chunks, so it runs the pipelined path
    subs = [pool[1836:2136], pool[2136:2536], pool[2536:2786]]
    check(len(subs[-1]) == 250, "not enough fresh configurations")

    def timed(label, fn, n):
        t = time.perf_counter()
        out = fn()
        sync(dev)
        dt = time.perf_counter() - t
        report["requests"].append({"request": label, "configs": n,
                                   "wall_ms": dt * 1e3,
                                   "configs_per_s": n / dt})
        return out

    rows = {}
    for i, blk in enumerate(blocks):
        rows[f"fresh{i}"] = timed(f"fresh block {i} (512)",
                                  lambda blk=blk: eng(blk), 512)
    evaluated = eng.stats.evaluated
    rows["repeat"] = timed("repeat of block 0 (512, memo)",
                           lambda: eng(blocks[0]), 512)
    check(eng.stats.evaluated == evaluated, "repeat block missed the memo")
    check(np.array_equal(rows["repeat"], rows["fresh0"]),
          "memo rows differ from the first evaluation")
    rows["ragged"] = timed("ragged block (300)", lambda: eng(ragged), 300)

    def wave():
        futs = [None] * 3
        ts = [threading.Thread(target=lambda i=i: futs.__setitem__(
            i, eng.submit(subs[i]))) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        check(eng.drain() == 3, "the three submissions were not one wave")
        return [f.result(timeout=60) for f in futs]
    wave_rows = timed("3 concurrent submits, one drain (950)", wave, 950)

    oracle = SurrogateEngine.from_oracle(ctx.app, ctx.entries, ctx.inp,
                                         ctx.exact_out)
    oracle_rows = timed("oracle engine (256)",
                        lambda: oracle(ds.configs[:256]), 256)
    launches = launch_counts()
    report["launches"] = launches
    report["engine_stats"] = {k: getattr(eng.stats, k) for k in (
        "calls", "configs", "cache_hits", "evaluated", "padded", "chunks",
        "submits", "drains", "featurize_s", "dispatch_s", "collect_s",
        "overlapped_s")}
    for name in ("gnn_mp", "lut_eval"):
        check(dev.type != "cuda" or launches[name] > 0,
              f"{name} was never launched on the main path")

    # where one fresh chunk's time goes, phase by phase (host clock; each
    # phase ends in a device sync)
    C = np.asarray(pool[2786:2786 + CHUNK])
    check(len(C) == CHUNK, "not enough fresh configurations")
    feat = dataset.featurizer_for(ds, ctx.app, ctx.entries, dev)
    phases = {}
    t = time.perf_counter()
    batch_oracle.timing_batch(ctx.app, ctx.entries, C)
    phases["timing_sweep_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    batch_oracle.probe_batch(ctx.app, ctx.entries, C, device=dev)
    sync(dev)
    phases["probe_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    X = feat.normalized(C)
    phases["featurize_total_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    handle = eng.pipeline.dispatch(X)
    sync(dev)
    phases["gnn_dispatch_and_device_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    eng.pipeline.collect(handle)
    phases["collect_ms"] = (time.perf_counter() - t) * 1e3
    report["fresh_chunk_breakdown"] = phases
    # where one warm fresh chunk's device time goes, and how long the
    # device idles in it (a request of 512 configurations the engine has
    # not seen)
    C = pool[2786 + CHUNK:2786 + 2 * CHUNK]
    check(len(C) == CHUNK, "not enough fresh configurations")
    if dev.type == "cuda":
        report["fresh_chunk_device_profile"] = device_profile(
            lambda: eng(C))

    # -- is it right? -------------------------------------------------------
    for key, r in list(rows.items()) + [("wave", np.concatenate(wave_rows))]:
        check(r.ndim == 2 and r.shape[1] == 4 and np.isfinite(r).all(),
              f"rows {key}: shape {r.shape} or non-finite values")
    # GNN rows against the plain path (models.predict) on the same features
    A, X, M = dataset.features_for_configs(ds, ctx.app, ctx.entries,
                                           blocks[0], device=dev)
    with torch.no_grad():
        y_plain = models.predict(
            cfg, params, *(torch.from_numpy(v).to(dev) for v in (A, X, M))
        )[0].cpu().numpy()
    y_eng = rows["fresh0"].copy()
    y_eng[:, 3] = 1 - y_eng[:, 3]
    y_eng = (y_eng - ds.y_mean) / ds.y_std
    gnn_err = float(np.abs(y_eng - y_plain).max())
    check(gnn_err <= PARITY_ATOL,
          f"engine vs models.predict: {gnn_err} > {PARITY_ATOL}")
    # oracle rows against the dataset's labels for the same configs
    want = ds.y_raw[:256].astype(np.float64)
    want[:, 3] = 1 - want[:, 3]
    check(np.allclose(oracle_rows, want, rtol=1e-6, atol=1e-6),
          "oracle rows differ from the dataset labels")
    # the functional model on the card against the plain CPU path
    cpu_imgs = ctx.inp.cpu()
    few = ds.configs[:8]
    check(torch.equal(apps.batch_outputs(ctx.app, ctx.entries, few,
                                         ctx.inp).cpu(),
                      apps.batch_outputs(ctx.app, ctx.entries, few,
                                         cpu_imgs)),
          "functional-model outputs differ between the card and the CPU")
    ssim_cpu = apps.accuracy_ssim_batch(ctx.app, ctx.entries, ds.configs[:64],
                                        cpu_imgs)
    ssim_err = float(np.abs(ssim_cpu - ds.y_raw[:64, 3]).max())
    check(ssim_err <= 1e-6, f"card SSIM labels vs CPU: {ssim_err}")
    report["checks"] = {"engine_vs_plain_max_abs": gnn_err,
                        "ssim_card_vs_cpu_max_abs": ssim_err}
    return report, launches, (ctx, ds)


# the apps slice: the other four accelerators, each labeled at the
# Gaussian slice's size; LOOP_CONFIGS of them also through the scalar
# path. Sobel has only adders and subtractors (add8, add12, sub10), which
# the functional model evaluates analytically: it has no table to gather.
OTHER_APPS = ("sobel", "fir15", "dct8", "kmeans")
NO_TABLE_APPS = {"sobel": "only add8, add12 and sub10 units: no truth "
                          "table to gather"}
LOOP_CONFIGS, RAGGED = 8, 300
# scalar labels against batched ones: the reference's bars
# (tests/test_batch_oracle.py, benchmarks/dataset_bench.py): PPA is the
# same float64 arithmetic, SSIM float32 reductions in another order; the
# probe feature columns at tests/test_feature_schema.py's 1e-4
PPA_RTOL, SSIM_ATOL, PROBE_ATOL = 1e-9, 2e-5, 1e-4


def apps_slice_phase(card: str, dev, gaussian, n_samples: int = N_SAMPLES,
                     n_layers: int = N_LAYERS, hidden: int = HIDDEN,
                     chunk: int = CHUNK):
    """Label and serve sobel, fir15, dct8 and k-means on ``dev``, then the
    cross-app surrogate's per-app views of all five (``gaussian`` is the
    slice phase's (app context, dataset)); returns (report, launches)."""
    import numpy as np
    import torch
    from repro_torch.accel import apps, batch_oracle, synth
    from repro_torch.core import dataset, gnn, graph, models, pipeline
    from repro_torch.core.engine import SurrogateEngine
    cuda = dev.type == "cuda"
    report = {"card": card, "apps": {}, "labeling": {}}
    reset_launch_counts()
    contexts, datasets, pools = {"gaussian": gaussian[0]}, \
        {"gaussian": gaussian[1]}, {}

    def fresh_pool(name, n):
        known = set(datasets[name].configs)
        pool = [c for c in dataset.sample_configs(
            contexts[name].app, n_samples + n + 64, seed=1,
            lib_entries=contexts[name].entries) if c not in known][:n]
        check(len(pool) == n, f"{name}: not enough fresh configurations")
        return pool

    def wall_ms(fn):
        sync(dev)
        t = time.perf_counter()
        out = fn()
        sync(dev)
        return out, (time.perf_counter() - t) * 1e3

    for name in OTHER_APPS:
        rep = {}
        app_start = before = launch_counts()
        ctx = pipeline.app_context(name, device=dev)
        contexts[name] = ctx
        ds, ms = wall_ms(lambda: dataset.build(
            name, n_samples=n_samples, lib_entries=ctx.entries, device=dev))
        datasets[name] = ds
        rep["build_launches"] = counts_since(before)
        # -- labels: the scalar path on the first configurations ----------
        loop, loop_ms = wall_ms(lambda: dataset.build(
            name, n_samples=LOOP_CONFIGS, lib_entries=ctx.entries,
            label_backend="loop", device=dev))
        batched8 = dataset.build(name, n_samples=LOOP_CONFIGS,
                                 lib_entries=ctx.entries, device=dev)
        report["labeling"][name] = {
            "batched_configs": len(ds.configs), "batched_s": ms / 1e3,
            "batched_configs_per_s": len(ds.configs) / (ms / 1e3),
            "loop_configs": LOOP_CONFIGS, "loop_s": loop_ms / 1e3,
            "loop_configs_per_s": LOOP_CONFIGS / (loop_ms / 1e3)}
        check(loop.configs == ds.configs[:LOOP_CONFIGS] == batched8.configs,
              f"{name}: the loop build sampled other configurations")
        C8 = np.asarray(loop.configs, np.int64)
        choices = [{u.id: ctx.entries[u.kind][i]
                    for u, i in zip(ctx.app.unit_nodes, cfg)}
                   for cfg in loop.configs]
        scalar_crit = [synth.synthesize(ctx.app, ch)["critical_nodes"]
                       for ch in choices]
        batch_crit = batch_oracle.crit_sets(
            batch_oracle.synthesize_batch(ctx.app, ctx.entries, C8))
        check(scalar_crit == batch_crit,
              f"{name}: scalar and batched critical sets differ")
        check(np.array_equal(loop.crit, ds.crit[:LOOP_CONFIGS]),
              f"{name}: loop crit bits differ from the batched build's")
        ppa_rel = float(np.max(np.abs(loop.y_raw[:, :3] / ds.y_raw[
            :LOOP_CONFIGS, :3] - 1)))
        ssim_err = float(np.max(np.abs(loop.y_raw[:, 3]
                                       - ds.y_raw[:LOOP_CONFIGS, 3])))
        check(ppa_rel <= PPA_RTOL, f"{name}: loop PPA off by {ppa_rel}")
        check(ssim_err <= SSIM_ATOL, f"{name}: loop SSIM off by {ssim_err}")
        probe = [loop.schema.col("timing", f) for f in apps.PROBE_FIELDS]
        exact = np.ones(loop.x.shape[-1], bool)
        exact[probe] = False
        probe_err = float(np.abs(loop.x[..., probe]
                                 - batched8.x[..., probe]).max())
        check(np.array_equal(loop.x[..., exact], batched8.x[..., exact]),
              f"{name}: loop features differ from batched features")
        check(probe_err <= PROBE_ATOL,
              f"{name}: loop probe features off by {probe_err}")
        rep["label_checks"] = {
            "ppa_max_rel": ppa_rel, "ssim_max_abs": ssim_err,
            "crit_sets_equal": scalar_crit == batch_crit,
            "features_identical_outside_probe": bool(np.array_equal(
                loop.x[..., exact], batched8.x[..., exact])),
            "probe_features_max_abs": probe_err,
            "features_identical": bool(np.array_equal(loop.x, batched8.x))}
        # one 256-configuration labeling chunk, as the build runs it
        before = launch_counts()
        apps.accuracy_ssim_batch(ctx.app, ctx.entries, ds.configs[:256],
                                 ctx.inp, ctx.exact_out)
        sync(dev)
        rep["labeling_chunk_launches"] = counts_since(before)
        # -- the GNN engine at paper width --------------------------------
        cfg = models.TwoStageConfig(gnn=gnn.GNNConfig(
            arch="gsae", n_layers=n_layers, hidden=hidden,
            feature_dim=ds.x.shape[-1]))
        params = models.init(torch.Generator(device=dev).manual_seed(0),
                             cfg, device=dev)
        eng = SurrogateEngine.from_gnn(cfg, params, ds, ctx.app,
                                       ctx.entries, chunk_size=chunk,
                                       device=dev)
        pools[name] = pool = fresh_pool(name, 3 * chunk + RAGGED)
        fresh, ragged = pool[:chunk], pool[chunk:chunk + RAGGED]
        before = launch_counts()
        y_fresh, fresh_ms = wall_ms(lambda: eng(fresh))
        rep["engine_chunk_launches"] = counts_since(before)
        y_memo, memo_ms = wall_ms(lambda: eng(fresh))
        y_ragged, ragged_ms = wall_ms(lambda: eng(ragged))
        rep["requests_ms"] = {f"fresh {chunk}": fresh_ms,
                              f"memo repeat {chunk}": memo_ms,
                              f"ragged {RAGGED}": ragged_ms}
        check(np.array_equal(y_memo, y_fresh),
              f"{name}: memo rows differ from the first evaluation")
        err = 0.0
        for cfgs, y in ((fresh, y_fresh), (ragged, y_ragged)):
            check(y.shape == (len(cfgs), 4) and np.isfinite(y).all(),
                  f"{name}: engine rows {y.shape} or non-finite")
            A, X, M = dataset.features_for_configs(ds, ctx.app, ctx.entries,
                                                   cfgs, device=dev)
            with torch.no_grad():
                plain = models.predict(cfg, params, *(
                    torch.from_numpy(v).to(dev) for v in (A, X, M))
                )[0].cpu().numpy()
            yn = y.copy()
            yn[:, 3] = 1 - yn[:, 3]
            err = max(err, float(np.abs((yn - ds.y_mean) / ds.y_std
                                        - plain).max()))
        check(err <= PARITY_ATOL,
              f"{name}: engine vs models.predict: {err} > {PARITY_ATOL}")
        rep["engine_vs_plain_max_abs"] = err
        rep["engine_stats"] = eng.stats.as_dict()
        if cuda:
            # a warm fresh request's device time and idle share
            rep["fresh_chunk_device_profile"] = device_profile(
                lambda: eng(pool[chunk + RAGGED:2 * chunk + RAGGED]))
        rep["launches"] = counts_since(app_start)
        n_lut = rep["launches"]["lut_eval"]
        check(not cuda or rep["launches"]["gnn_mp"] > 0,
              f"{name}: gnn_mp was never launched")
        if name in NO_TABLE_APPS:
            rep["lut_eval_none_because"] = NO_TABLE_APPS[name]
            check(n_lut == 0, f"{name}: lut_eval launched {n_lut} times")
        else:
            check(not cuda or n_lut > 0,
                  f"{name}: lut_eval was never launched")
        report["apps"][name] = rep

    # -- the cross-app surrogate: one model, a view per app ----------------
    before = launch_counts()
    merged = dataset.merge(datasets)
    cfg = models.TwoStageConfig(gnn=gnn.GNNConfig(
        arch="gsae", n_layers=n_layers, hidden=hidden,
        feature_dim=graph.MERGED_FEATURE_DIM))
    params = models.init(torch.Generator(device=dev).manual_seed(1), cfg,
                         device=dev)
    shared = {"merged_rows": len(merged.y), "n_pad": merged.n_pad,
              "feature_dim": merged.x.shape[-1], "views": {}}
    check(merged.app_names == tuple(graph.APP_VOCAB),
          f"merged apps {merged.app_names}")
    for name in graph.APP_VOCAB:
        ctx = contexts[name]
        eng = SurrogateEngine.from_gnn_shared(cfg, params, merged, name,
                                              ctx.entries, chunk_size=chunk,
                                              device=dev)
        cfgs = (pools[name][2 * chunk + RAGGED:] if name in pools
                else fresh_pool(name, chunk))
        y, ms = wall_ms(lambda: eng(cfgs))
        X = eng.pipeline.prepare(cfgs)
        view = merged.view(name)
        block = graph.app_block(name, view.mask[0])
        check(np.array_equal(X[..., graph.FEATURE_DIM:],
                             np.broadcast_to(block, X.shape[:1] + block.shape)),
              f"{name}: the shared view's features lack the app block")
        B = len(cfgs)
        adj = torch.from_numpy(view.adj[:1]).to(dev).expand(B, -1, -1)
        mask = torch.from_numpy(view.mask[:1]).to(dev).expand(B, -1)
        with torch.no_grad():
            plain = models.predict(cfg, params, adj,
                                   torch.from_numpy(X).to(dev),
                                   mask)[0].cpu().numpy()
        ds = merged.per_app[name]
        yn = y.copy()
        yn[:, 3] = 1 - yn[:, 3]
        err = float(np.abs((yn - ds.y_mean) / ds.y_std - plain).max())
        check(y.shape == (B, 4) and np.isfinite(y).all(),
              f"{name}: shared view rows {y.shape} or non-finite")
        check(err <= PARITY_ATOL, f"{name}: shared view vs models.predict:"
              f" {err} > {PARITY_ATOL}")
        shared["views"][name] = {"backend": eng.backend, "configs": B,
                                 "wall_ms": ms,
                                 "vs_plain_max_abs": err,
                                 "engine_stats": eng.stats.as_dict()}
    shared["launches"] = counts_since(before)
    check(not cuda or shared["launches"]["gnn_mp"] > 0,
          "gnn_mp was never launched by the shared views")
    report["shared"] = shared

    launches = launch_counts()
    report["launches"] = launches
    return report, launches


# the training slice: the Gaussian dataset of the slice phase, split 0.9,
# a paper-width gsae (GNNConfig's dropout 0.1) trained at TrainConfig()
# (Adam lr 1e-3, batch 64, 40 epochs, seed 0), then an 8-member ensemble
# of 10 epochs
TRAIN_SPLIT, ENS_MEMBERS, ENS_EPOCHS, PROFILE_STEPS = 0.9, 8, 10, 20
# Training is held in float64, where only the arithmetic's order differs:
# in float32 a pre-activation within rounding of a ReLU's kink (or a tie
# in the max readout) flips on one side, a first-step gradient leaf moves
# by up to ~2e-3 of its largest entry (relative L2 3e-4), and Adam turns
# such flips into steps of up to lr that grow: on an H100 two float32
# epochs on the card and the CPU drift past 1e-5 by step 4 and to 7e-2,
# an ensemble member from its single fit likewise (the float32 readings
# are reported beside the checks). float64: the first step's loss and
# each gradient leaf to 1e-12 of the leaf's largest entry (sums of 2048
# terms; an H100 reads 8e-16 against the CPU); per-step losses, kept
# as float32, to 1e-6 relative, over two epochs card against CPU
# (dropout 0) and for ensemble member 0 against the single fit with its
# seed (dropout 0.1: the same plan and masks; vmapped products against
# unbatched ones).
STEP_RTOL, LOSS_RTOL, F64_EPOCHS = 1e-12, 1e-6, 2
# the search slice: PipelineConfig.paper_faithful's budget, the paper's
# population (Sec III-C); the island fleet at the same budget
SEARCH_BUDGET, SEARCH_POP, N_ISLANDS = 20_000, 64, 4
TRAIN_KEYS = ("adj", "x", "mask", "unit_mask", "y", "crit")


def _fresh_configs(ctx, ds, n, seed):
    from repro_torch.core import dataset
    known = set(ds.configs)
    pool = [c for c in dataset.sample_configs(ctx.app, n + len(known),
                                              seed=seed,
                                              lib_entries=ctx.entries)
            if c not in known][:n]
    check(len(pool) == n, "not enough fresh configurations")
    return pool


def train_slice_phase(card: str, dev, gaussian, n_layers: int = N_LAYERS,
                      hidden: int = HIDDEN, tc=None,
                      n_members: int = ENS_MEMBERS,
                      ens_epochs: int = ENS_EPOCHS, chunk: int = CHUNK,
                      profile_steps: int = PROFILE_STEPS):
    """Train the Gaussian surrogate on ``dev`` through
    `training.fit_two_stage` and an ensemble through `fit_ensemble`, and
    serve both (``gaussian`` is the slice phase's (app context,
    dataset)); returns (report, launches, (config, trained params))."""
    import dataclasses
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core import gnn, models, training
    from repro_torch.core.engine import SurrogateEngine
    ctx, ds = gaussian
    cpu = torch.device("cpu")
    tc = tc or training.TrainConfig()
    tr, te = ds.split(TRAIN_SPLIT)
    n = len(tr.y)
    bs = min(tc.batch_size, n)
    cfg = models.TwoStageConfig(gnn=gnn.GNNConfig(
        arch="gsae", n_layers=n_layers, hidden=hidden,
        feature_dim=ds.x.shape[-1]))
    cfg0 = dataclasses.replace(cfg, gnn=dataclasses.replace(cfg.gnn,
                                                            dropout=0.0))
    report = {"card": card, "train_rows": n, "held_out_rows": len(te.y),
              "model": dataclasses.asdict(cfg.gnn),
              "train_config": dataclasses.asdict(tc)}
    checks = {}

    def on(tree, d):
        return pytree.tree_map(lambda a: a.to(d), tree)

    def timed(fn):
        sync(dev)
        t = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t

    reset_launch_counts()
    # -- the card against the CPU, from the same parameters, dropout 0 -----
    def f64(tree):
        return pytree.tree_map(lambda a: a.double(), tree)

    def rows_of(d, dt):
        return {k: torch.from_numpy(np.asarray(getattr(tr, k), np.float64)
                                    ).to(device=d, dtype=dt)
                for k in TRAIN_KEYS}

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    p0 = models.init(torch.Generator().manual_seed(tc.seed), cfg0,
                     device=cpu)
    idx, w = training._plan_for(tc, n, bs)
    for dt in (torch.float64, torch.float32):
        batch = {k: v[idx[0, 0]] for k, v in rows_of(cpu, dt).items()}
        batch["w"] = w[0, 0].to(dt)
        p = pytree.tree_map(lambda a: a.to(dt), p0)
        loss_c, grads_c = training.loss_and_grads(cfg0, p, batch)
        loss_d, grads_d = training.loss_and_grads(cfg0, on(p, dev),
                                                  on(batch, dev))
        leaves = list(zip(pytree.tree_leaves(grads_d),
                          pytree.tree_leaves(grads_c)))
        checks[f"first_step_{str(dt)[6:]}"] = {
            "loss_rel": abs(float(loss_d) - float(loss_c))
            / abs(float(loss_c)),
            "grad_max_of_leaf_max": max(
                float((d.cpu() - c).abs().max() / c.abs().max())
                for d, c in leaves if float(c.abs().max()) > 0),
            "grad_max_rel_l2": max(
                float((d.cpu() - c).norm() / c.norm())
                for d, c in leaves if float(c.norm()) > 0)}
    first = checks["first_step_float64"]
    check(first["loss_rel"] <= STEP_RTOL
          and first["grad_max_of_leaf_max"] <= STEP_RTOL,
          f"first step in float64, card vs CPU: {first} > {STEP_RTOL}")
    tc2 = dataclasses.replace(tc, epochs=F64_EPOCHS)
    idx2, w2 = training._plan_for(tc2, n, bs)
    for dt in (torch.float64, torch.float32):
        p = pytree.tree_map(lambda a: a.to(dt), p0)
        (_, (loss_cpu, _, _)), cpu_s = timed(lambda: training._fit(
            cfg0, tc2, rows_of(cpu, dt), p, idx2, w2.to(dt), None))
        (_, (loss_dev, _, _)), dev_s = timed(lambda: training._fit(
            cfg0, tc2, rows_of(dev, dt), on(p, dev), idx2, w2.to(dt),
            None))
        r = np.abs(loss_dev - loss_cpu) / np.abs(loss_cpu)
        checks[f"two_epochs_{str(dt)[6:]}"] = {
            "loss_max_rel": float(r.max()),
            "first_step_over_1e-5": int(np.argmax(r.ravel() > 1e-5))
            if (r > 1e-5).any() else None,
            "card_s": dev_s, "cpu_s": cpu_s}
    epochs64 = checks["two_epochs_float64"]["loss_max_rel"]
    check(epochs64 <= LOSS_RTOL, f"two epochs in float64, card vs CPU: "
          f"per-step losses {epochs64} apart")
    # ensemble member 0 against the single fit with its seed, float64,
    # dropout on: the members' runs stacked as `fit_ensemble` stacks them
    runs = [training._run_inputs(cfg, tc2, tc2.seed + m, n, dev)
            for m in range(n_members)]
    data64 = rows_of(dev, torch.float64)
    _, (ens_loss, _, _) = training._fit(
        cfg, tc2, data64, f64(pytree.tree_map(
            lambda *xs: torch.stack(xs), *[r[0] for r in runs])),
        torch.stack([r[1] for r in runs]),
        torch.stack([r[2] for r in runs]).double(), [r[3] for r in runs])
    one = training._run_inputs(cfg, tc2, tc2.seed, n, dev)
    _, (one_loss, _, _) = training._fit(cfg, tc2, data64, f64(one[0]),
                                        one[1], one[2].double(), one[3])
    member64 = rel(ens_loss[0], one_loss)
    check(member64 <= LOSS_RTOL, f"ensemble member 0 vs single fit in "
          f"float64: per-step losses {member64} apart")
    checks.update(member0_vs_single_float64_loss_max_rel=member64,
                  tolerances={"first_step_float64": STEP_RTOL,
                              "losses_float64": LOSS_RTOL})

    # -- the fit ---------------------------------------------------------------
    held = training._as_data(te, dev)
    with torch.no_grad():
        init_loss = float(models.losses(cfg, models.init(
            torch.Generator().manual_seed(tc.seed), cfg, device=dev),
            held)[0])
    (params, hist), wall = timed(lambda: training.fit_two_stage(
        cfg, tr, tc, return_history=True, device=dev))
    with torch.no_grad():
        held_loss = float(models.losses(cfg, params, held)[0])
    steps = int(np.isfinite(hist.train_loss).sum())
    report["fit"] = {
        "wall_s": wall, "steps": steps, "steps_per_s": steps / wall,
        "samples_per_s": n * hist.epochs_run / wall,
        "first_epoch_mean_loss": float(np.nanmean(hist.train_loss[0])),
        "last_epoch_mean_loss": float(np.nanmean(hist.train_loss[-1])),
        "held_out_loss": {"init": init_loss, "trained": held_loss}}
    check(np.isfinite(hist.train_loss).all() and held_loss < init_loss,
          f"training did not lower the held-out loss: {init_loss} -> "
          f"{held_loss}")
    report["evaluate"] = training.evaluate(cfg, params, ds, te, device=dev)
    if dev.type == "cuda":
        # warm steps under the profiler: one epoch over profile_steps
        # batches, through the entry point
        sub = tr.split((profile_steps * bs + 0.5) / n)[0]
        one = dataclasses.replace(tc, epochs=1)
        training.fit_two_stage(cfg, sub, one, device=dev)
        report["steps_device_profile"] = dict(
            steps=-(-len(sub.y) // bs), **device_profile(
                lambda: training.fit_two_stage(cfg, sub, one, device=dev)))

    # -- serve the trained surrogate -------------------------------------------
    fresh = _fresh_configs(ctx, ds, 2 * chunk, seed=7)
    eng = SurrogateEngine.from_gnn(cfg, params, ds, ctx.app, ctx.entries,
                                   chunk_size=chunk, device=dev)
    y, s = timed(lambda: eng(fresh[:chunk]))
    check(y.shape == (chunk, 4) and np.isfinite(y).all(),
          f"trained engine rows {y.shape} or non-finite")
    report["serve"] = {"backend": eng.backend, "fresh_ms": s * 1e3}

    # -- the ensemble, against sequential single fits --------------------------
    tce = dataclasses.replace(tc, epochs=ens_epochs)
    (ens, ens_hist), ens_s = timed(lambda: training.fit_ensemble(
        cfg, tr, tce, n_members=n_members, device=dev))
    singles, seq_s = timed(lambda: [training.fit_two_stage(
        cfg, tr, dataclasses.replace(tce, seed=tce.seed + m),
        return_history=True, device=dev) for m in range(n_members)])
    # float32: the two drift apart as the card and the CPU do
    member_rel = rel(ens_hist["train_loss"][0], singles[0][1].train_loss)
    member0 = pytree.tree_map(lambda a: a[0], ens.groups[0][1])
    member_param = max(float((a - b).abs().max()) for a, b in zip(
        pytree.tree_leaves(member0), pytree.tree_leaves(singles[0][0])))
    eng_e = SurrogateEngine.from_gnn_ensemble(ens, ds, ctx.app, ctx.entries,
                                              chunk_size=chunk, device=dev)
    y, s = timed(lambda: eng_e(fresh[chunk:]))
    evaluated, hits = eng_e.stats.evaluated, eng_e.stats.cache_hits
    unc = eng_e.uncertainty(fresh[chunk:])
    check(y.shape == (chunk, 4) and np.isfinite(y).all(),
          f"ensemble engine rows {y.shape} or non-finite")
    check(unc.shape == (chunk, 4) and bool((unc >= 0).all()),
          "ensemble uncertainty negative or misshapen")
    check(eng_e.stats.evaluated == evaluated
          and eng_e.stats.cache_hits == hits + chunk,
          "uncertainty was not served from the memo")
    report["ensemble"] = {
        "members": n_members, "epochs": ens_epochs, "wall_s": ens_s,
        "sequential_wall_s": seq_s, "speedup": seq_s / ens_s,
        "member0_vs_single_float32_loss_max_rel": member_rel,
        "member0_vs_single_float32_param_max_abs": member_param,
        "backend": eng_e.backend, "fresh_ms": s * 1e3,
        "mean_std": [float(v) for v in unc.mean(0)]}
    report["checks"] = checks
    launches = launch_counts()
    report["launches"] = launches
    for name in ("gnn_mp", "lut_eval"):
        check(dev.type != "cuda" or launches[name] > 0,
              f"{name} was never launched in the training slice")
    return report, launches, (cfg, params)


def search_slice_phase(card: str, dev, gaussian, trained,
                       budget: int = SEARCH_BUDGET, pop: int = SEARCH_POP,
                       n_islands: int = N_ISLANDS, chunk: int = CHUNK):
    """Search the Gaussian design space on ``dev`` with the trained
    surrogate (``trained`` is the training slice's (config, params)):
    NSGA-III twice on fresh engines, the island fleet with its ranks on
    the card, then the oracle on the NSGA-III front; returns (report,
    launches)."""
    import numpy as np
    from repro_torch.core import dse, islands
    from repro_torch.core.engine import SurrogateEngine
    ctx, ds = gaussian
    cfg, params = trained
    sizes = [len(ctx.entries[node.kind]) for node in ctx.app.unit_nodes]
    report = {"card": card, "sizes": sizes, "budget": budget, "pop": pop,
              "runs": {}}
    reset_launch_counts()

    def run(label, search):
        eng = SurrogateEngine.from_gnn(cfg, params, ds, ctx.app,
                                       ctx.entries, chunk_size=chunk,
                                       device=dev)
        before = launch_counts()
        sync(dev)
        t = time.perf_counter()
        res = search(eng)
        sync(dev)
        wall = time.perf_counter() - t
        report["runs"][label] = {
            "wall_s": wall, "configs_per_s": res.evaluated / wall,
            "requests": res.evaluated, "history_entries": len(res.history),
            "front_size": len(res.pareto_configs),
            "engine": {k: getattr(eng.stats, k) for k in (
                "calls", "evaluated", "cache_hits", "chunks")},
            "launches": counts_since(before)}
        check(len(res.pareto_configs) > 0
              and bool(dse.pareto_mask(res.pareto_objs).all()),
              f"{label}: the front is empty or dominated")
        check(np.isfinite(res.pareto_objs).all(),
              f"{label}: non-finite front rows")
        return res

    def nsga3(eng):
        return dse.run_nsga(sizes, eng, budget, seed=0, pop=pop,
                            variant="nsga3")

    res = run("nsga3", nsga3)
    again = run("nsga3, rerun on a fresh engine", nsga3)
    same = (again.pareto_configs == res.pareto_configs
            and np.array_equal(again.pareto_objs, res.pareto_objs))
    check(same, "the nsga3 rerun gave another front")
    # the island fleet, each generation's rank stacks recorded as the
    # fleet ranks them (PyTorch on the card) and held against NumPy
    stacks = []
    ranks_of = islands.fleet_ranks

    def recorded(F, backend="auto", device=None, devices=None):
        r = ranks_of(F, backend, device, devices)
        stacks.append((np.array(F), r))
        return r

    islands.fleet_ranks = recorded
    try:
        run("islands", lambda eng: islands.run_islands(
            sizes, eng, budget, seed=0, n_islands=n_islands, pop=pop,
            nds_backend="torch", device=dev))
    finally:
        islands.fleet_ranks = ranks_of
    differ = sum(not np.array_equal(r, ranks_of(F, "numpy"))
                 for F, r in stacks)
    check(stacks and differ == 0,
          f"fleet ranks on {dev.type} differ from NumPy in {differ} of "
          f"{len(stacks)} generations")
    report["checks"] = {"rerun_identical": same,
                        "fleet_rank_stacks": len(stacks),
                        "fleet_rank_stacks_differing": differ}
    # the oracle on the nsga3 front: the surrogate's error, a reading
    oracle = SurrogateEngine.from_oracle(ctx.app, ctx.entries, ctx.inp,
                                         ctx.exact_out)
    t = time.perf_counter()
    true = oracle(res.pareto_configs)
    rel = np.abs(res.pareto_objs - true) / np.maximum(np.abs(true), 1e-6)
    report["oracle_on_front"] = {
        "points": len(true), "wall_s": time.perf_counter() - t,
        "mean_rel_err": float(rel.mean()),
        "per_obj": {k: float(rel[:, i].mean()) for i, k in enumerate(
            ("area", "power", "latency", "1-ssim"))}}
    launches = launch_counts()
    report["launches"] = launches
    for name in ("gnn_mp", "lut_eval"):
        check(dev.type != "cuda" or launches[name] > 0,
              f"{name} was never launched in the search slice")
    return report, launches


# the pipeline slice: PipelineConfig.paper_faithful("gaussian") with two
# cuts for the time limit; the service run's clients and requests
PIPE_SAMPLES, PIPE_EPOCHS = 2048, 20
SERVE_CLIENTS, SERVE_PREDICTS, SERVE_CONFIGS = 8, 4, 64
SERVE_DSE_BUDGET, SERVE_DSE_SEEDS, SERVE_LABELS = 2_000, (1, 2), 16
# 1 - SSIM of the oracle on the card against the CPU: the window sums of
# integer pixels are exact in float32 in any order, but the variances'
# squared deviations round at 2^-24 and the card sums them in another
# order; the two packages on the CPU read up to 5.4e-7 apart
ORACLE_SSIM_ATOL = 1e-5


def _max_abs(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def _serve_run(card: str, dev, cfg, store, engine, ctx):
    """`EvalService` warmed from the store: 8 client threads of predict,
    dse and label requests, each response held bit for bit against the
    same request served one by one on a fresh engine."""
    import numpy as np
    from repro_torch.accel import batch_oracle
    from repro_torch.core import dse
    from repro_torch.core import pipeline as P
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.launch.serve import EvalService, ServeRequest
    sizes = [len(ctx.entries[n.kind]) for n in ctx.app.unit_nodes]

    def configs(seed, n):
        rng = np.random.default_rng(seed)
        return [tuple(int(rng.integers(0, k)) for k in sizes)
                for _ in range(n)]

    script = []           # per client: [(kind, payload), ...]
    for c in range(SERVE_CLIENTS):
        reqs = [("predict", configs(1000 + 10 * c + r, SERVE_CONFIGS))
                for r in range(SERVE_PREDICTS)]
        reqs += [("dse", s) for s in SERVE_DSE_SEEDS]
        reqs.append(("label", configs(2000 + c, SERVE_LABELS)))
        script.append(reqs)
    out = {"clients": SERVE_CLIENTS, "requests": sum(map(len, script))}
    svc = EvalService(store, max_workers=2 * SERVE_CLIENTS)
    try:
        name = svc.warm_start(cfg, device=dev)
        same = svc._tenants[name].engine is engine
        check(same, "warm_start's tenant does not serve the run_staged "
              "engine")
        stats0 = engine.stats.as_dict()
        got = [None] * SERVE_CLIENTS
        barrier = threading.Barrier(SERVE_CLIENTS)

        def client(c):
            barrier.wait()
            rids = []
            for kind, payload in script[c]:
                if kind == "dse":
                    req = ServeRequest("dse", name, sampler="nsga3",
                                       budget=SERVE_DSE_BUDGET, seed=payload,
                                       dse_kwargs={"pop": cfg.dse_pop})
                else:
                    req = ServeRequest(kind, name, configs=payload)
                rids.append(svc.submit(req))
            got[c] = svc.results(rids, timeout=600.0)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        health = svc.health()
    finally:
        svc.close()
    stats1 = engine.stats.as_dict()
    resps = [r for rs in got if rs for r in rs]
    check(len(resps) == out["requests"] and all(r.ok for r in resps),
          "service requests failed: " + "; ".join(
              str(r.error) for r in resps if not r.ok)[:500])
    lat = sorted(r.latency_s for r in resps)
    drains = stats1["drains"] - stats0["drains"]
    submits = stats1["submits"] - stats0["submits"]
    waved = stats1["configs"] - stats0["configs"]
    out.update({
        "tenant_is_run_staged_engine": same, "wall_s": wall,
        "requests_per_s": len(resps) / wall,
        "p50_ms": lat[len(lat) // 2] * 1e3,
        "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
        "drains": drains, "submits": submits,
        "mean_wave_configs": waved / max(drains, 1),
        "mean_wave_submits": submits / max(drains, 1),
        "health": {k: health[k] for k in (
            "ok", "inflight", "requests_tracked", "batchers",
            "queue_depth", "retries", "quarantined", "checkpoint_gc")}})
    # the same requests one by one, on a fresh engine; its launches are
    # the check's, not the main path's
    before = launch_counts()
    ds = P.stage_dataset(cfg, store, ctx, device=dev)
    art = P.stage_train(cfg, store, ds, device=dev)
    fresh = P.stage_engine(cfg, ArtifactStore(None), ctx, ds, art,
                           device=dev)
    one_shot = {s: dse.run_nsga(sizes, P.stage_engine(
        cfg, ArtifactStore(None), ctx, ds, art, device=dev),
        SERVE_DSE_BUDGET, seed=s, pop=cfg.dse_pop, variant="nsga3")
        for s in SERVE_DSE_SEEDS}
    differ = {"predict": [], "dse": [], "label": []}
    for c, rs in enumerate(got):
        for (kind, payload), r in zip(script[c], rs or ()):
            if not r.ok:
                continue
            if kind == "predict":
                want = fresh(payload)
                if not np.array_equal(r.value, want):
                    differ[kind].append(_max_abs(r.value, want))
            elif kind == "label":
                want = batch_oracle.objective_rows(
                    ctx.app, ctx.entries, payload, ctx.inp, ctx.exact_out)
                if not np.array_equal(r.value, want):
                    differ[kind].append(_max_abs(r.value, want))
            else:
                want = one_shot[payload]
                if not (r.value.pareto_configs == want.pareto_configs
                        and np.array_equal(r.value.pareto_objs,
                                           want.pareto_objs)
                        and r.value.history == want.history):
                    differ[kind].append(
                        _max_abs(r.value.pareto_objs, want.pareto_objs))
    out["serial_check_launches"] = counts_since(before)
    out["serial_differing"] = {k: len(v) for k, v in differ.items()}
    out["serial_max_abs"] = {k: max(v) for k, v in differ.items() if v}
    out["dse_front_sizes"] = {s: len(r.pareto_configs)
                              for s, r in one_shot.items()}
    for kind, v in differ.items():
        check(not v, f"{len(v)} {kind} responses differ from the serial "
              f"one-shot path (max |diff| {max(v) if v else 0})")
    return out


def pipeline_slice_phase(card: str, dev, n_samples: int = PIPE_SAMPLES,
                         epochs: int = PIPE_EPOCHS, keep_store: bool = False):
    """The staged pipeline on ``dev`` at `PipelineConfig.paper_faithful(
    "gaussian")` with an on-disk store in a temporary directory: a cold
    `run_staged`, a resume on a new store, an islands sweep, the oracle on
    10 Pareto points (also against the CPU's oracle rows), then an
    `EvalService` warmed from the store; returns (report, launches, kept).
    With ``keep_store`` a run that got through keeps its store for the
    split slice, and ``kept`` is (config, store root, the cold run's
    front configs and rows); else the store is removed and ``kept`` is
    None."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.core import dse
    from repro_torch.core import pipeline as P
    from repro_torch.core.artifacts import ArtifactStore
    paper = P.PipelineConfig.paper_faithful("gaussian")
    root = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    cfg = dataclasses.replace(paper, n_samples=n_samples, epochs=epochs,
                              artifact_dir=root)
    report = {"card": card, "config": {
        k: getattr(cfg, k) for k in (
            "app", "gnn_arch", "n_layers", "hidden", "sampler",
            "dse_budget", "dse_pop", "eval_chunk", "n_samples", "epochs")},
        "reduced": {"n_samples": [paper.n_samples, n_samples],
                    "epochs": [paper.epochs, epochs]}}
    reset_launch_counts()

    def staged(label, c, store):
        before = launch_counts()
        sync(dev)
        t = time.perf_counter()
        res = P.run_staged(c, store, device=dev)
        sync(dev)
        wall = time.perf_counter() - t
        check(len(res.pareto_configs) > 0
              and bool(dse.pareto_mask(res.pareto_objs).all())
              and bool(np.isfinite(res.pareto_objs).all()),
              f"{label}: the front is empty, dominated or not finite")
        report[label] = {
            "wall_s": wall, "stage_s": res.timings,
            "store": res.metrics["store"],
            "front_size": len(res.pareto_configs),
            "engine": {k: res.metrics["engine"][k] for k in (
                "backend", "calls", "configs", "evaluated", "cache_hits",
                "chunks", "configs_per_sec")},
            "launches": counts_since(before)}
        return res

    kept = None
    try:
        cold = staged("cold", cfg, ArtifactStore(root))
        report["cold"]["r2"] = {t: cold.metrics[t]["r2"] for t in (
            "area", "power", "latency", "ssim")}
        report["cold"]["crit_accuracy"] = \
            cold.metrics["critical_path"]["accuracy"]
        check(cold.engine.backend == ("gnn_mp" if dev.type == "cuda"
                                      else "torch"),
              f"the engine runs {cold.engine.backend}")
        check(cold.metrics["store"]["misses"] == {
            s: 1 for s in ("prune", "dataset", "train", "engine", "search")},
              f"cold run: {cold.metrics['store']}")

        store = ArtifactStore(root)              # a new process's store
        res = staged("resume", cfg, store)
        hits = {s: store.stats.hits.get(s, 0)
                for s in ("dataset", "train", "search")}
        check(hits == {"dataset": 1, "train": 1, "search": 1},
              f"resume: disk hits {hits}")
        same = (res.pareto_configs == cold.pareto_configs
                and np.array_equal(res.pareto_objs, cold.pareto_objs))
        check(same, "resume: the front differs from the cold run's")
        report["resume"]["front_identical"] = same

        sweep = staged("islands_sweep",
                       dataclasses.replace(cfg, sampler="islands"), store)
        check(sweep.metrics["store"]["misses"] == {"search": 1},
              f"islands sweep: {sweep.metrics['store']}")

        t = time.perf_counter()
        val = P.validate_pareto(res, k=10, store=store, device=dev)
        report["validate"] = {"wall_s": time.perf_counter() - t, **val}
        ctx = P.stage_prune(cfg, store, device=dev)
        sel = res.pareto_configs[:10]
        before = launch_counts()
        card_rows = P._oracle_eval(ctx.app, ctx.entries, ctx.inp,
                                   ctx.exact_out)(sel)
        oracle_check = counts_since(before)
        cpu = P.app_context("gaussian", cfg.theta, device="cpu")
        cpu_rows = P._oracle_eval(cpu.app, cpu.entries, cpu.inp,
                                  cpu.exact_out)(sel)
        ppa_equal = bool(np.array_equal(card_rows[:, :3], cpu_rows[:, :3]))
        ssim_gap = _max_abs(card_rows[:, 3], cpu_rows[:, 3])
        report["validate"]["oracle_card_vs_cpu"] = {
            "points": len(sel), "ppa_equal": ppa_equal,
            "ssim_max_abs": ssim_gap, "ssim_bar": ORACLE_SSIM_ATOL}
        check(len(sel) == 10 and ppa_equal and ssim_gap <= ORACLE_SSIM_ATOL,
              f"oracle rows on the card against the CPU: PPA equal "
              f"{ppa_equal}, 1-ssim gap {ssim_gap}")

        report["serve"] = _serve_run(card, dev, cfg, store, res.engine, ctx)
        kept = (cfg, root, cold.pareto_configs, cold.pareto_objs) \
            if keep_store else None
    finally:
        if not (keep_store and kept):
            shutil.rmtree(root, ignore_errors=True)
    # the main path's launches: all but those of the comparisons (the
    # card's oracle rows against the CPU's, the serial one-shot calls)
    checks = counts_sum(oracle_check,
                        report["serve"]["serial_check_launches"])
    launches = counts_sum(launch_counts(), checks, -1)
    report["launches"] = launches
    report["check_launches"] = checks
    for name in ("gnn_mp", "lut_eval"):
        check(dev.type != "cuda" or launches[name] > 0,
              f"{name} was never launched in the pipeline slice")
    return report, launches, kept


def finite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def gap(a, b) -> dict:
    """How far two logits tensors are apart: max |a - b|, relative L2,
    and the share of rows whose argmax agrees."""
    a, b = a.float().cpu(), b.float().cpu()
    check(a.shape == b.shape and finite(a) and finite(b),
          f"shapes {tuple(a.shape)} vs {tuple(b.shape)} or non-finite "
          f"values")
    return {"max_abs": float((a - b).abs().max()),
            "rel_l2": float((a - b).norm() / b.norm()),
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                  .float().mean())}


def within(a, b, rtol: float, atol: float) -> bool:
    import torch
    return bool(torch.allclose(a.float().cpu(), b.float().cpu(), rtol=rtol,
                               atol=atol))


KIND_OF_KERNEL = (  # device time of a call, by what the kernel does
    ("gnn_mp", ("gnn_mp",)),
    ("lut_eval", ("lut_",)),
    ("flash_attention", ("flash_",)),
    ("ssm_scan", ("ssm_scan",)),
    ("rms_norm", ("rms_norm",)),
    ("matmul", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
    ("copy", ("copy",)),
)


def device_profile(fn, spans=()) -> dict:
    """Device time of one call of ``fn`` from torch.profiler: the busy
    share of the call's wall time, the time by kind of kernel (K1-K4,
    matrix products, copies, the rest) and the kernels that take the
    most; with ``spans``, also the device time of the kernels inside each
    ``record_function`` span of those names. The profiler marks a span on
    the device as an event of the span's name from its first kernel's
    start to its last kernel's end (idle gaps included): it and every
    other span's mark are left out of the kernel sums, and a span's time
    is the sum of the kernels that start inside its marks. A profiler
    that records no device activity is reported, not fatal: it measures,
    it checks nothing."""
    import bisect
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    marks, starts = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name in spans:
            marks.append(e)
            continue
        if getattr(e, "is_user_annotation", False):
            continue                    # the mark of a span not asked for
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
        starts.append((e.time_range.start, e.time_range.elapsed_us()))
    starts.sort()
    at = [t for t, _ in starts]
    run = [0.0]
    for _, us in starts:
        run.append(run[-1] + us)
    by_span = dict.fromkeys(spans, 0.0)
    for m in marks:
        lo = bisect.bisect_left(at, m.time_range.start)
        hi = bisect.bisect_right(at, m.time_range.end)
        by_span[m.name] += (run[hi] - run[lo]) / 1e3
    if not by_name:
        return {"wall_ms": wall_ms, "device_ms": "not measured: the "
                "profiler recorded no device activity"}
    busy = sum(by_name.values())
    by_kind = dict.fromkeys([k for k, _ in KIND_OF_KERNEL] + ["other"], 0.0)
    for name, ms in by_name.items():
        kind = next((k for k, keys in KIND_OF_KERNEL
                     if any(s in name.lower() for s in keys)), "other")
        by_kind[kind] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms,
           "device_ms_by_kind": by_kind, "kernels": len(by_name),
           "top_ms": {name[:80]: ms for name, ms in top}}
    if spans:
        out["device_ms_by_span"] = by_span
    return out


def timed_ms(dev, fn):
    """(fn's result, its wall ms), the device synchronized around it."""
    sync(dev)
    t = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t) * 1e3


def first_layers(params, n: int):
    """An LM's parameters with its first ``n`` layers (views)."""
    from repro_torch.models.layers import tree_map
    return dict(params, blocks=tree_map(lambda a: a[:n], params["blocks"]))


def stepped_and_longer(cfg, params, toks, S: int, max_len: int):
    """Last logits of prefill(S) + decode_step(S), and of one
    prefill(S + 1), through `make_prefill_step` / `make_decode_step`."""
    from repro_torch.launch import steps
    pre = steps.make_prefill_step(cfg, max_len=max_len)
    _, cache = pre(params, {"tokens": toks[:, :S]})
    stepped, _ = steps.make_decode_step(cfg)(params, cache,
                                             toks[:, S:S + 1], S)
    longer, _ = pre(params, {"tokens": toks[:, :S + 1]})
    return stepped[:, 0], longer


def lm_slice_phase(card: str, dev, cfg, batch: int = LM_BATCH,
                   prompt_len: int = LM_PROMPT, max_len: int = LM_MAX_LEN,
                   n_steps: int = LM_STEPS, cpu_len: int = 256,
                   witness_len: int = LM_WITNESS_PROMPT):
    """Drive the LM serving slice on ``dev`` through `make_prefill_step`
    and `make_decode_step`; returns (report, launches of the counted
    prefill). On the CPU (a rehearsal at reduced size) the kernels' plain
    versions run and nothing is launched."""
    import dataclasses
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as nk
    from repro_torch.kernels import ssm_scan as sc
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map
    report = {"card": card, "arch": cfg.name, "batch": batch,
              "prompt": prompt_len, "max_len": max_len,
              "decode_steps": n_steps}
    per_run = cfg.n_layers if dev.type == "cuda" else 0
    per_norm = norm_launches(cfg) if dev.type == "cuda" else 0
    checks = {}

    gen = torch.Generator(device=dev).manual_seed(0)
    params, ms = timed_ms(dev, lambda: transformer.build_param_table(
        cfg).init(gen, device=dev, dtype=torch.bfloat16))
    report["init_ms"] = ms
    n_params = []
    tree_map(lambda a: n_params.append(a.numel()), params)
    report["params"] = sum(n_params)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len + 1),
                           generator=gen, device=dev, dtype=torch.int32)
    prompt = {"tokens": tokens[:, :prompt_len]}
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)

    with torch.inference_mode():
        (last, cache), report["prefill_cold_ms"] = timed_ms(
            dev, lambda: prefill(params, prompt))
        check(tuple(last.shape) == (batch, cfg.vocab_size)
              and finite(last), "prefill logits: shape or values")
        del cache

        # the counted run: one warm prefill, then greedy decoding
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        fa.LAUNCHES.reset()
        sc.LAUNCHES.reset()
        nk.LAUNCHES.reset()
        (last, cache), warm = timed_ms(dev, lambda: prefill(params, prompt))
        launches = {"flash_attention": fa.LAUNCHES.value,
                    "ssm_scan": sc.LAUNCHES.value,
                    "rms_norm": nk.LAUNCHES.value}
        for name, n in launches.items():
            n_want = per_run if name != "rms_norm" else per_norm
            check(n == n_want, f"{name}: {n} launches in the prefill, not "
                  f"{n_want} (on the card one per layer, two norms a "
                  f"layer and the final one)")
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        step_ms = []
        for i in range(n_steps):
            (logits, cache), ms = timed_ms(
                dev, lambda: decode(params, cache, tok, prompt_len + i))
            step_ms.append(ms)
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        check(finite(logits) and tuple(logits.shape)
              == (batch, 1, cfg.vocab_size), "decode logits")
        if dev.type == "cuda":
            report["peak_allocated_gib"] = (
                torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        report["prefill_warm_ms"] = warm
        report["prefill_tokens_per_s"] = batch * prompt_len / warm * 1e3
        report["decode_ms_per_step"] = sum(step_ms) / len(step_ms)
        report["decode_ms_per_step_median"] = sorted(step_ms)[n_steps // 2]
        report["decode_tokens_per_s"] = (batch * 1e3
                                         / report["decode_ms_per_step"])
        report["launches"] = launches
        del cache

        # where one warm prefill's and one decode step's device time goes
        if dev.type == "cuda":
            report["prefill_device_profile"] = device_profile(
                lambda: prefill(params, prompt))
            _, cache = prefill(params, prompt)
            report["decode_step_device_profile"] = device_profile(
                lambda: decode(params, cache, tok, prompt_len))
            del cache

        # consistency at full width: prefill(S) + one decode step at S
        # against one prefill(S + 1), at test_models.py's bar. At S + 1 >
        # window the SWA layers take the plain windowed path and the
        # global layers a ragged K3. In float32 compute (K3's float32
        # path) over all 32 layers; in bf16 (the served kernels) over two:
        # deeper, a one-ulp difference between the two orders grows past
        # any bar through the random-weight stack, in the JAX reference
        # too (tests/test_torch_lm.py::
        # test_bf16_decode_gap_at_depth_is_rounding_order).
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(lambda a: a.float(), params)
        a, b = stepped_and_longer(cfg32, p32, tokens, prompt_len, max_len)
        checks["decode_vs_longer_prefill_f32"] = gap(a, b)
        check(within(a, b, LM_RTOL, LM_ATOL),
              "float32 prefill+decode vs prefill(S+1) beyond the bar")
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        a, b = stepped_and_longer(cfg2, first_layers(params, 2), tokens,
                                  prompt_len, max_len)
        checks["decode_vs_longer_prefill_bf16_2_layers"] = gap(a, b)
        check(within(a, b, LM_RTOL, LM_ATOL),
              "bf16 two-layer prefill+decode vs prefill(S+1) beyond the bar")

        # the second witness: the float32 gap at a short prompt, on the
        # card and on the CPU's plain path with the same weights. Its
        # source is the bf16 KV cache (the decode step reads the prompt's
        # k/v rounded, the longer prefill does not), the same on both
        # devices; a kernel fault would make the card's gap its own.
        toks_w = tokens[:, :witness_len + 1]
        card_s, card_l = stepped_and_longer(cfg32, p32, toks_w, witness_len,
                                            max_len)
        del p32
        p32_cpu = tree_map(lambda a: a.float().cpu(), params)
        cpu_s, cpu_l = stepped_and_longer(cfg32, p32_cpu, toks_w.cpu(),
                                          witness_len, max_len)
        del p32_cpu
        w = {"prompt": witness_len, "card": gap(card_s, card_l),
             "cpu": gap(cpu_s, cpu_l),
             "stepped_card_vs_cpu": gap(card_s, cpu_s),
             "longer_card_vs_cpu": gap(card_l, cpu_l)}
        checks["decode_gap_f32_card_vs_cpu"] = w
        cpu_gap = w["cpu"]["max_abs"]
        check(abs(w["card"]["max_abs"] - cpu_gap) <= WITNESS_SHARE * cpu_gap,
              "float32 decode gap on the card is not the CPU plain path's")
        for key in ("stepped_card_vs_cpu", "longer_card_vs_cpu"):
            check(w[key]["max_abs"] <= WITNESS_SHARE * cpu_gap,
                  f"float32 {key} beyond {WITNESS_SHARE} of the CPU's gap")

        # card against CPU: two layers at full width in bf16, the same
        # weights; only what the kernels produce or feed: the logits, the
        # SSM state (K4's y_final) and the second layer's KV cache (its
        # input went through the first layer's K3 and K4)
        p2 = first_layers(params, 2)
        batch2 = {"tokens": tokens[:2, :cpu_len]}
        prefill2 = steps.make_prefill_step(cfg2)
        fa.LAUNCHES.reset()
        sc.LAUNCHES.reset()
        last_d, cache_d = prefill2(p2, batch2)
        check(fa.LAUNCHES.value == sc.LAUNCHES.value == (
            2 if dev.type == "cuda" else 0),
            "the two-layer prefill did not run both kernels in each layer")
        last_c, cache_c = prefill2(tree_map(lambda a: a.cpu(), p2),
                                   {"tokens": batch2["tokens"].cpu()})
        ssm_c = cache_c["ssm"]
        ssm_atol = CARD_CPU_SSM_ATOL * float(ssm_c.abs().max())
        checks["card_vs_cpu"] = {
            "logits": gap(last_d, last_c),
            "ssm_state_max_abs": float((cache_d["ssm"].cpu()
                                        - ssm_c).abs().max()),
            "ssm_state_ref_max_abs": float(ssm_c.abs().max()),
            "layer1_kv_max_abs": max(
                float((cache_d["layers"][1][n].float().cpu()
                       - cache_c["layers"][1][n].float()).abs().max())
                for n in ("k", "v"))}
        check(within(last_d, last_c, *CARD_CPU_TOL),
              "two-layer prefill logits, card vs CPU, beyond the bar")
        check(within(cache_d["ssm"], ssm_c, CARD_CPU_TOL[0], ssm_atol),
              "SSM state, card vs CPU, beyond the bar")
        for n in ("k", "v"):
            check(within(cache_d["layers"][1][n], cache_c["layers"][1][n],
                         *CARD_CPU_TOL),
                  f"layer 1 {n} cache, card vs CPU, beyond the bar")
    report["checks"] = checks
    report["tolerance"] = {"consistency": [LM_RTOL, LM_ATOL],
                           "witness_share": WITNESS_SHARE,
                           "card_vs_cpu": list(CARD_CPU_TOL),
                           "card_vs_cpu_ssm_atol": ssm_atol}
    return report, launches


@contextmanager
def recorded_routes():
    """While open, record every `moe.place` call's routing, (experts (T,
    k), kept (T, k)): the one-card layer calls it once through
    `moe.route`, a mesh once per position. It measures; the layer's
    result is unchanged."""
    from repro_torch.models import moe
    real = moe.place
    seen = []

    def recording(ch, C, before=None):
        r = real(ch, C, before)
        seen.append((r.idx, r.keep.view(r.idx.shape)))
        return r
    moe.place = recording
    try:
        yield seen
    finally:
        moe.place = real


def dropped_share(routes) -> float:
    """The share of assignments dropped by capacity over recorded calls."""
    kept = sum(float(keep.float().sum()) for _, keep in routes)
    return 1.0 - kept / sum(keep.numel() for _, keep in routes)


def moe_slice_phase(card: str, dev, cfg, batch: int = LM_BATCH,
                    prompt_len: int = LM_PROMPT, max_len: int = LM_MAX_LEN,
                    n_steps: int = LM_STEPS, cpu_len: int = 128,
                    witness_len: int = LM_WITNESS_PROMPT, serve=MOE_SERVE):
    """Drive the mixture-of-experts family on ``dev``: `make_prefill_step`
    and `make_decode_step` at full width and depth in bf16, then the LM
    `BatchServer`; returns (report, launches of the counted prefill). On
    the CPU (a rehearsal at reduced size) the kernels' plain versions run
    and nothing is launched."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as nk
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps
    from repro_torch.models import moe, transformer
    from repro_torch.models.layers import tree_map
    report = {"card": card, "arch": cfg.name, "batch": batch,
              "prompt": prompt_len, "max_len": max_len,
              "decode_steps": n_steps, "n_layers": cfg.n_layers,
              "experts": cfg.n_experts, "top_k": cfg.top_k,
              "capacity_factor": cfg.capacity_factor}
    per_run = cfg.n_layers if dev.type == "cuda" else 0
    per_norm = norm_launches(cfg) if dev.type == "cuda" else 0
    checks = {}

    def peak_gib():
        return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else "not measured: no card")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, report["init_ms"] = timed_ms(
        dev, lambda: transformer.build_param_table(cfg).init(
            gen, device=dev, dtype=torch.bfloat16))
    report["peak_gib_after_init"] = peak_gib()
    n_params = []
    tree_map(lambda a: n_params.append(a.numel()), params)
    report["params"] = sum(n_params)
    report["params_gib_bf16"] = 2 * sum(n_params) / 2 ** 30
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len + 1),
                           generator=gen, device=dev, dtype=torch.int32)
    prompt = {"tokens": tokens[:, :prompt_len]}
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    report["capacity"] = {
        "prefill": moe.capacity(cfg, batch * prompt_len),
        "decode_step": moe.capacity(cfg, batch)}

    with torch.inference_mode():
        (last, cache), report["prefill_cold_ms"] = timed_ms(
            dev, lambda: prefill(params, prompt))
        check(tuple(last.shape) == (batch, cfg.vocab_size)
              and finite(last), "moe prefill logits: shape or values")
        del cache

        # the counted run: one warm prefill, then greedy decoding
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        fa.LAUNCHES.reset()
        nk.LAUNCHES.reset()
        (last, cache), warm = timed_ms(dev, lambda: prefill(params, prompt))
        launches = {"flash_attention": fa.LAUNCHES.value,
                    "rms_norm": nk.LAUNCHES.value}
        check(launches["flash_attention"] == per_run,
              f"flash_attention: {launches['flash_attention']} launches in "
              f"the moe prefill, not {per_run} (one per layer on the card)")
        check(launches["rms_norm"] == per_norm,
              f"rms_norm: {launches['rms_norm']} launches in the moe "
              f"prefill, not {per_norm} (two a layer and the final one)")
        report["peak_gib_prefill"] = peak_gib()
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        step_ms = []
        for i in range(n_steps):
            (logits, cache), ms = timed_ms(
                dev, lambda: decode(params, cache, tok, prompt_len + i))
            step_ms.append(ms)
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        check(finite(logits) and tuple(logits.shape)
              == (batch, 1, cfg.vocab_size), "moe decode logits")
        report["peak_gib_decode"] = peak_gib()
        report["prefill_warm_ms"] = warm
        report["prefill_tokens_per_s"] = batch * prompt_len / warm * 1e3
        report["decode_ms_per_step"] = sum(step_ms) / len(step_ms)
        report["decode_ms_per_step_median"] = sorted(step_ms)[n_steps // 2]
        report["decode_tokens_per_s"] = (batch * 1e3
                                         / report["decode_ms_per_step"])
        report["launches"] = launches

        # the share of assignments that capacity drops: over a prefill's
        # 48 layers, and over one decode step's (C = 1 at batch 8)
        with recorded_routes() as seen:
            decode(params, cache, tok, prompt_len + n_steps)
        report["dropped_share_decode_step"] = dropped_share(seen)
        del cache
        with recorded_routes() as seen:
            prefill(params, prompt)
        report["dropped_share_prefill"] = dropped_share(seen)
        del seen

        # where one warm prefill's and one decode step's device time goes;
        # the MoE layer's stages by their record_function spans
        if dev.type == "cuda":
            report["prefill_device_profile"] = device_profile(
                lambda: prefill(params, prompt), spans=moe.SPANS)
            _, cache = prefill(params, prompt)
            report["decode_step_device_profile"] = device_profile(
                lambda: decode(params, cache, tok, prompt_len),
                spans=moe.SPANS)
            del cache

        # consistency: prefill(S) + one decode step at S against one
        # prefill(S + 1), at test_models.py's bar, over two layers at full
        # width, in bf16 (the served types) and float32. As configured
        # the two orders differ: a decode step of B rows has C = 1 and
        # drops assignments the longer prefill keeps. With capacity_factor
        # = n_experts, C = k T >= T places per expert and nothing is
        # dropped in either order.
        cfg_nd = dataclasses.replace(cfg, n_layers=2,
                                     capacity_factor=float(cfg.n_experts))
        p2 = first_layers(params, 2)
        toks_w = tokens[:2, :witness_len + 1]
        a, b = stepped_and_longer(cfg_nd, p2, toks_w, witness_len,
                                  max_len)
        checks["decode_vs_longer_prefill_bf16_2_layers_no_drop"] = gap(a, b)
        check(within(a, b, LM_RTOL, LM_ATOL),
              "moe bf16 two-layer prefill+decode vs prefill(S+1) beyond the "
              "bar (no drops)")
        cfg_nd32 = dataclasses.replace(cfg_nd, dtype="float32")
        p2_32 = tree_map(lambda t: t.float(), p2)
        a, b = stepped_and_longer(cfg_nd32, p2_32, toks_w, witness_len,
                                  max_len)
        del p2_32
        checks["decode_vs_longer_prefill_f32_2_layers_no_drop"] = gap(a, b)
        check(within(a, b, LM_RTOL, LM_ATOL),
              "moe float32 two-layer prefill+decode vs prefill(S+1) beyond "
              "the bar (no drops)")

        # routing witness, card against CPU: the first two layers at full
        # width in bf16 on the same tokens. A router product summed in
        # another order, or a layer-1 output rounded after another order,
        # may flip a near-tie of the top k; a flip moves the places of
        # the later assignments to both experts, and where capacity drops
        # assignments their keep flags with them. The share of tokens
        # whose experts or keep mask differ in either layer is reported,
        # not held. A token routed otherwise gets other experts' output
        # altogether, and through causal attention it reaches every later
        # token of its sequence in layer 2. So the logits are held at the
        # Hymba card-against-CPU bar over the tokens routed alike that
        # see only tokens routed alike (each sequence up to its first
        # token routed otherwise): the same experts' products, rounded to
        # bf16 after another summation order (cuBLAS, oneDNN), as there.
        # Every token routed alike is reported beside them.
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        batch2 = {"tokens": tokens[:2, :cpu_len]}
        with recorded_routes() as seen_d:
            logits_d, aux_d, _ = transformer.forward(cfg2, p2, batch2)
        p2_cpu = tree_map(lambda t: t.cpu(), p2)
        with recorded_routes() as seen_c:
            logits_c, aux_c, _ = transformer.forward(
                cfg2, p2_cpu, {"tokens": batch2["tokens"].cpu()})
        del p2_cpu
        logits_d = logits_d.cpu()
        shape = logits_c.shape[:2]
        differ = torch.zeros(shape, dtype=torch.bool)
        w = {"tokens": int(differ.numel()), "layers": []}
        for (idx_d, keep_d), (idx_c, keep_c) in zip(seen_d, seen_c):
            # a token's experts as a set, each with its keep flag: two
            # experts swapped in the order of their gates route alike
            idx_d, order = idx_d.cpu().sort(-1)
            keep_d = keep_d.cpu().gather(-1, order)
            idx_c, order = idx_c.sort(-1)
            keep_c = keep_c.gather(-1, order)
            idx_differs = (idx_d != idx_c).any(-1).view(shape)
            keep_differs = (keep_d != keep_c).any(-1).view(shape)
            w["layers"].append({
                "experts_differ_share": float(idx_differs.float().mean()),
                "keep_differs_share": float(keep_differs.float().mean()),
                "dropped_share_card": 1 - float(keep_d.float().mean()),
                "dropped_share_cpu": 1 - float(keep_c.float().mean())})
            differ |= idx_differs | keep_differs
        alike = ~differ
        prefix = alike.int().cumprod(dim=1).bool()
        w.update({"routing_differs_share": float(differ.float().mean()),
                  "alike_prefix_tokens": int(prefix.sum()),
                  "aux_card": float(aux_d), "aux_cpu": float(aux_c)})
        check(bool(prefix.any()), "moe routing witness: no token routed "
              "alike from the start of its sequence")
        if bool(prefix.any()):
            w["logits_alike_prefix"] = gap(logits_d[prefix],
                                           logits_c[prefix])
            check(within(logits_d[prefix], logits_c[prefix],
                         *CARD_CPU_TOL),
                  "moe two-layer logits over the tokens routed alike from "
                  "the start of their sequence, card vs CPU, beyond the bar")
        for name, mask in (("logits_routed_alike", alike),
                           ("logits_routed_otherwise", differ)):
            if bool(mask.any()):
                w[name] = gap(logits_d[mask], logits_c[mask])
        checks["routing_card_vs_cpu"] = w
        del logits_d, logits_c, seen_d, seen_c, p2

        # the LM BatchServer at full width: requests through its slots,
        # then request 0 alone in a fresh server with the same weights.
        # On a dense model the two token lists are equal; here the other
        # rows take expert capacity (C = 1 a step), so they may differ,
        # which is the model's semantics: reported, not held.
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, serve["prompt"])
                   for _ in range(serve["requests"])]
        reqs = [serve_lib.Request(i, p, serve["max_new"])
                for i, p in enumerate(prompts)]
        server = serve_lib.BatchServer(cfg, params, slots=serve["slots"],
                                       device=dev)
        served, ms = timed_ms(dev, lambda: server.run(reqs))
        n_tokens = sum(len(r.out) for r in reqs)
        check(sorted(served) == list(range(serve["requests"]))
              and n_tokens == serve["requests"] * serve["max_new"],
              "BatchServer did not serve every request in full")
        alone = serve_lib.Request(0, prompts[0], serve["max_new"])
        fresh = serve_lib.BatchServer(cfg, params, slots=serve["slots"],
                                      device=dev)
        _, alone_ms = timed_ms(dev, lambda: fresh.run([alone]))
        if dev.type == "cuda":
            # one step of the warm fresh server, slot 0 (its state is
            # thrown away after)
            server_step = device_profile(
                lambda: fresh._step_slot(0, int(prompts[0][0])),
                spans=moe.SPANS)
        report["batch_server"] = {
            **serve, "wall_ms": ms, "tokens": n_tokens,
            "decode_steps": server.steps,
            "tokens_per_s": n_tokens / ms * 1e3,
            "ms_per_step": ms / server.steps,
            "alone_wall_ms": alone_ms, "alone_steps": fresh.steps,
            "request0_tokens": reqs[0].out, "alone_tokens": alone.out,
            "alone_matches_shared": alone.out == reqs[0].out}
        if dev.type == "cuda":
            report["batch_server"]["step_device_profile"] = server_step
        del server, fresh
    report["checks"] = checks
    report["tolerance"] = {"consistency": [LM_RTOL, LM_ATOL],
                           "card_vs_cpu_alike_prefix": list(CARD_CPU_TOL)}
    return report, launches


# the last three LM families at full width and depth: (arch, decoder
# prompt tokens, decode horizon). Whisper's decoder prompt is 224 tokens,
# half of its 448-token text context; its encoder reads 1500 frames.
# layers of RWKV-6's prefill under the profiler (of 32): its ~12k kernels
# a layer take the profiler ~4-6 s a layer to post-process
RWKV_PROFILE_LAYERS = 1
FAMILIES = (("qwen2-vl-7b", LM_PROMPT, LM_MAX_LEN),
            ("whisper-large-v3", 224, 224 + LM_STEPS),
            ("rwkv6-3b", LM_PROMPT, LM_MAX_LEN))
# prefill(S) + k decode steps against prefill(S + k): S covers the VLM's
# 256 vision positions
FAMILY_WITNESS_PROMPT, FAMILY_WITNESS_STEPS = 300, 4


def vlm_positions(batch: int, length: int, n_vision: int, dev):
    """(B,S,3) M-RoPE positions: the vision block at (t, h, w) = (0, row,
    col) of a square grid, the text at its own index on all three columns
    (a decode step at position p puts p on all three: it continues the
    text)."""
    import torch
    side = int(round(n_vision ** 0.5))
    pos = torch.arange(length, dtype=torch.int32, device=dev)[None, :, None] \
        .repeat(batch, 1, 3)
    i = torch.arange(n_vision, dtype=torch.int32, device=dev)
    pos[:, :n_vision] = torch.stack([0 * i, i // side, i % side], -1)
    return pos


def family_inputs(cfg, gen, dev, batch: int, length: int):
    """Random tokens of ``length`` and what the family's stub frontend
    gives, drawn from ``gen``: vision embeddings N(0, 0.02) in bf16 with
    M-RoPE positions of ``length`` (VLM), frames N(0, 0.02) in bf16 of the
    encoder's length (Whisper)."""
    import torch
    tokens = torch.randint(0, cfg.vocab_size, (batch, length),
                           generator=gen, device=dev, dtype=torch.int32)
    extra = {}
    if cfg.n_vision_tokens:
        extra["vision_embeds"] = (torch.randn(
            batch, cfg.n_vision_tokens, cfg.d_model, generator=gen,
            device=dev) * 0.02).to(torch.bfloat16)
        extra["positions"] = vlm_positions(batch, length,
                                           cfg.n_vision_tokens, dev)
    if cfg.enc_dec:
        extra["enc_frames"] = (torch.randn(
            batch, cfg.enc_len, cfg.d_model, generator=gen, device=dev)
            * 0.02).to(torch.bfloat16)
    return tokens, extra


def family_batch(tokens, extra, S: int, rows: int = 0) -> dict:
    """The batch of the first ``S`` tokens (of the first ``rows`` rows if
    given)."""
    batch = {"tokens": tokens[:, :S]}
    for k, v in extra.items():
        batch[k] = v[:, :S] if k == "positions" else v
    if rows:
        batch = {k: v[:rows] for k, v in batch.items()}
    return batch


def cut_layers(cfg, params, n: int):
    """The model cut to its first ``n`` layers: the decoder's, and the
    encoder's too (Whisper)."""
    import dataclasses
    from repro_torch.models.layers import tree_map
    params = first_layers(params, n)
    over = {"n_layers": n}
    if cfg.enc_dec:
        params["enc_blocks"] = tree_map(lambda a: a[:n],
                                        params["enc_blocks"])
        over["enc_layers"] = n
    return dataclasses.replace(cfg, **over), params


def cache_gib(cache) -> float:
    from repro_torch.models.layers import tree_leaves
    return (sum(t.numel() * t.element_size() for t in tree_leaves(cache))
            / 2 ** 30)


def int8_decode_compare(dev, cfg, params, prefill, decode, prompt,
                        prompt_len: int, fed, want):
    """The bf16 cache and the int8 one (`decoding.quantize_cache` of the
    prefill's), each stepped through the same ``len(fed)`` decode steps
    fed the bf16 run's greedy tokens ``fed``: cache GiB, peak GiB of the
    decode, ms a step, each step's largest logits gap against the bf16
    run's logits ``want``, and the share of greedy tokens that agree."""
    import torch
    from repro_torch.models import decoding
    out = {}
    for kind in ("bf16", "int8"):
        _, cache = prefill(params, prompt)
        if kind == "int8":
            cache = decoding.quantize_cache(cfg, cache)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        step_ms, gaps, agree = [], [], []
        for i, tok in enumerate(fed):
            (logits, cache), ms = timed_ms(
                dev, lambda: decode(params, cache, tok, prompt_len + i))
            step_ms.append(ms)
            gaps.append(float((logits[:, 0].float() - want[i].float())
                              .abs().max()))
            agree.append(float((logits[:, 0].argmax(-1)
                                == want[i].argmax(-1)).float().mean()))
        out[kind] = {
            "cache_gib": cache_gib(
                {k: v for k, v in cache.items() if k != "pos"}),
            "peak_gib_decode": (torch.cuda.max_memory_allocated(dev)
                                / 2 ** 30 if dev.type == "cuda"
                                else "not measured: no card"),
            "ms_per_step": sum(step_ms) / len(step_ms),
            "logits_max_gap": max(gaps),
            "greedy_agree_share": sum(agree) / len(agree)}
        del cache
    gap8 = out["int8"]["logits_max_gap"]
    check(gap8 <= INT8_LOGITS_GAP, f"{cfg.name}: the int8 cache's logits "
          f"{gap8:.3g} from the bf16 cache's, beyond {INT8_LOGITS_GAP}")
    out["bar"] = INT8_LOGITS_GAP
    return out


def family_run(card: str, dev, cfg, prompt_len: int, max_len: int,
               batch: int = LM_BATCH, n_steps: int = LM_STEPS,
               witness_len: int = FAMILY_WITNESS_PROMPT,
               witness_steps: int = FAMILY_WITNESS_STEPS,
               int8_decode: bool = False, keep: int = 0):
    """One family at full width and depth on ``dev``: random bf16
    weights, a cold and a counted warm prefill of ``batch`` prompts
    through `make_prefill_step`, greedy `make_decode_step` steps, device
    profiles, and the checks; returns (report, K3's and the norm's
    launches in the counted prefill).
    With ``keep``, the report's "_yardstick" holds what a mesh run of the
    same weights and prompts compares with (`family_yardstick`): the
    prefill's last logits, the first ``keep`` steps' fed tokens and
    logits, the warm prefill's ms and the decode's ms a step. On the CPU
    (a rehearsal at reduced size) the kernels' plain versions run,
    nothing is launched and nothing is profiled."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rms_norm as nk
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map
    report = {"arch": cfg.name, "batch": batch, "prompt": prompt_len,
              "max_len": max_len, "decode_steps": n_steps,
              "n_layers": cfg.n_layers}
    if cfg.enc_dec:
        report.update(enc_layers=cfg.enc_layers, enc_frames=cfg.enc_len)
    if cfg.n_vision_tokens:
        report["vision_tokens"] = cfg.n_vision_tokens
    cuda = dev.type == "cuda"
    # K3 a prefill: every decoder layer's self-attention, and Whisper's
    # every encoder layer and every decoder layer's cross-attention (224
    # queries over 1500 frames, a full mask); RWKV has no attention
    per_run = 0 if cfg.attn_free or not cuda else (
        cfg.n_layers * (2 if cfg.enc_dec else 1) + cfg.enc_layers)
    per_norm = norm_launches(cfg) if cuda else 0
    checks = {}

    def peak_gib():
        if not cuda:
            return "not measured: no card"
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, report["init_ms"] = timed_ms(
        dev, lambda: transformer.build_param_table(cfg).init(
            gen, device=dev, dtype=torch.bfloat16))
    report["peak_gib_after_init"] = peak_gib()
    n_params = []
    tree_map(lambda a: n_params.append(a.numel()), params)
    report["params"] = sum(n_params)
    report["param_count_analytic"] = cfg.param_count()
    report["params_gib_bf16"] = 2 * sum(n_params) / 2 ** 30
    tokens, extra = family_inputs(cfg, gen, dev, batch, max_len)
    prompt = family_batch(tokens, extra, prompt_len)
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    # the phase's wall s by part (host clock)
    timing, t = {}, time.perf_counter()

    def lap(part):
        nonlocal t
        timing[part] = time.perf_counter() - t
        t = time.perf_counter()

    with torch.inference_mode():
        (last, cache), report["prefill_cold_ms"] = timed_ms(
            dev, lambda: prefill(params, prompt))
        check(tuple(last.shape) == (batch, cfg.vocab_size)
              and finite(last), f"{cfg.name} prefill logits: shape or "
              f"values")
        del cache

        # the counted run: one warm prefill, then greedy decoding
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        fa.LAUNCHES.reset()
        nk.LAUNCHES.reset()
        (last, cache), warm = timed_ms(dev, lambda: prefill(params, prompt))
        launches = {"flash_attention": fa.LAUNCHES.value,
                    "rms_norm": nk.LAUNCHES.value}
        check(launches["flash_attention"] == per_run,
              f"{cfg.name}: {launches['flash_attention']} flash_attention "
              f"launches in the prefill, not {per_run}")
        check(launches["rms_norm"] == per_norm,
              f"{cfg.name}: {launches['rms_norm']} rms_norm launches in the "
              f"prefill, not {per_norm}")
        report["peak_gib_prefill"] = peak_gib()
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        step_ms, fed, seen = [], [], []
        for i in range(n_steps):
            (logits, cache), ms = timed_ms(
                dev, lambda: decode(params, cache, tok, prompt_len + i))
            step_ms.append(ms)
            if int8_decode or i < keep:
                fed.append(tok)
                seen.append(logits[:, 0].clone())
            tok = logits[:, 0].argmax(-1, keepdim=True).to(torch.int32)
        check(finite(logits) and tuple(logits.shape)
              == (batch, 1, cfg.vocab_size), f"{cfg.name} decode logits")
        report["peak_gib_decode"] = peak_gib()
        report["prefill_warm_ms"] = warm
        report["prefill_tokens_per_s"] = batch * prompt_len / warm * 1e3
        report["decode_ms_per_step"] = sum(step_ms) / len(step_ms)
        report["decode_ms_per_step_median"] = sorted(step_ms)[n_steps // 2]
        report["decode_tokens_per_s"] = (batch * 1e3
                                         / report["decode_ms_per_step"])
        report["launches"] = launches
        if keep:
            report["_yardstick"] = {
                "last": last.float(), "fed": fed[:keep],
                "logits": [x.float() for x in seen[:keep]],
                "prefill_warm_ms": warm,
                "decode_ms_per_step": report["decode_ms_per_step"],
                "decode_step_device_profile": None}
        del cache
        lap("prefills_and_decode")

        # the int8 KV cache beside the bf16 one: the same greedy steps
        if int8_decode:
            report["int8_kv"] = int8_decode_compare(
                dev, cfg, params, prefill, decode, prompt, prompt_len, fed,
                seen)
            del fed, seen
            lap("int8_kv")

        # where one warm prefill's and one decode step's device time goes.
        # RWKV's prefill is a step loop of ~3 kernels a token and layer:
        # the profiler's post-processing of all 32 layers' ~100k kernels
        # took ~100 s, so its prefill is profiled over the first
        # `RWKV_PROFILE_LAYERS` layers (its decode step over all)
        if cuda:
            if cfg.attn_free:
                c_p, p_p = cut_layers(cfg, params, RWKV_PROFILE_LAYERS)
                pre_p = steps.make_prefill_step(c_p, max_len=max_len)
                report["prefill_device_profile"] = {
                    "layers": RWKV_PROFILE_LAYERS, **device_profile(
                        lambda: pre_p(p_p, prompt))}
                del c_p, p_p, pre_p
            else:
                report["prefill_device_profile"] = device_profile(
                    lambda: prefill(params, prompt))
            _, cache = prefill(params, prompt)
            report["decode_step_device_profile"] = device_profile(
                lambda: decode(params, cache, tok, prompt_len))
            if keep:
                report["_yardstick"]["decode_step_device_profile"] = \
                    report["decode_step_device_profile"]
            del cache
        lap("profiles")

        # consistency: prefill(S) + k decode steps against one
        # prefill(S + k), over the first two layers (both stacks for
        # Whisper) at full width in bf16, at test_models.py's bar (deeper,
        # a one-ulp difference between the two orders grows past any bar
        # through a random-weight stack: lm_slice's note)
        cfg2, p2 = cut_layers(cfg, params, 2)
        k = witness_steps
        S = min(witness_len, max_len - k)
        report["witness_prompt"] = S
        pre2 = steps.make_prefill_step(cfg2, max_len=S + k)
        _, cache = pre2(p2, family_batch(tokens, extra, S, rows=2))
        for i in range(k):
            stepped, cache = steps.make_decode_step(cfg2)(
                p2, cache, tokens[:2, S + i:S + i + 1], S + i)
        longer, want = pre2(p2, family_batch(tokens, extra, S + k, rows=2))
        checks["decode_vs_longer_prefill_bf16_2_layers"] = gap(
            stepped[:, 0], longer)
        check(within(stepped[:, 0], longer, LM_RTOL, LM_ATOL),
              f"{cfg.name} bf16 two-layer prefill + {k} steps vs "
              f"prefill(S+{k}) beyond the bar")
        if cfg.attn_free:
            # the float32 state after the steps against the longer
            # prefill's: float32 sums of bf16 inputs summed in another
            # order (a decode step's products are not a prefill's)
            st_atol = CARD_CPU_SSM_ATOL * float(want["state"].abs().max())
            checks["state_stepped_vs_longer"] = {
                "max_abs": float((cache["state"] - want["state"])
                                 .abs().max()),
                "ref_max_abs": float(want["state"].abs().max())}
            check(within(cache["state"], want["state"], CARD_CPU_TOL[0],
                         st_atol),
                  f"{cfg.name} state after prefill + {k} steps vs "
                  f"prefill(S+{k}) beyond the bar")
        del cache, want
        lap("consistency")

        # card against CPU: the first two layers (both stacks) at full
        # width in bf16, the same weights and inputs; the logits, and what
        # the kernels feed: layer 1's KV cache (its input went through
        # layer 0's K3), the cross-attention cache (the encoder's output,
        # through the encoder's K3), RWKV's state
        b2 = family_batch(tokens, extra, S, rows=2)
        fa.LAUNCHES.reset()
        last_d, cache_d = pre2(p2, b2)
        check(fa.LAUNCHES.value == (0 if cfg.attn_free or not cuda else
                                    2 + 4 * bool(cfg.enc_dec)),
              f"{cfg.name}: the two-layer prefill did not run K3 in each "
              f"attention layer")
        last_c, cache_c = pre2(tree_map(lambda a: a.cpu(), p2),
                               {k_: v.cpu() for k_, v in b2.items()})
        w = {"logits": gap(last_d, last_c)}
        check(within(last_d, last_c, *CARD_CPU_TOL),
              f"{cfg.name} two-layer prefill logits, card vs CPU, beyond "
              f"the bar")
        if cfg.attn_free:
            st_c = cache_c["state"]
            st_atol = CARD_CPU_SSM_ATOL * float(st_c.abs().max())
            w["state_max_abs"] = float((cache_d["state"].cpu() - st_c)
                                       .abs().max())
            w["state_ref_max_abs"] = float(st_c.abs().max())
            check(within(cache_d["state"], st_c, CARD_CPU_TOL[0], st_atol),
                  f"{cfg.name} state, card vs CPU, beyond the bar")
        else:
            names = [("k", 1), ("v", 1)]
            if cfg.enc_dec:
                names += [("xk", 1), ("xv", 1)]
            for n, layer in names:
                a, b = cache_d[n][layer], cache_c[n][layer]
                w[f"layer{layer}_{n}_max_abs"] = float(
                    (a.float().cpu() - b.float()).abs().max())
                check(within(a, b, *CARD_CPU_TOL),
                      f"{cfg.name} layer {layer} {n} cache, card vs CPU, "
                      f"beyond the bar")
        checks["card_vs_cpu_2_layers"] = w
        del p2, cache_d, cache_c
        lap("card_vs_cpu")
    report["checks"] = checks
    report["timing_s"] = timing
    del params
    return report, launches


def families_slice_phase(card: str, dev, families=FAMILIES, archs=None,
                         keep=None, **kw):
    """Drive the VLM, Whisper and RWKV-6 at full width and depth, one
    after the other, the memory freed between them; returns (report, K3's
    and the norm's launches of the counted prefills, {name: yardstick}).
    ``archs`` maps a name to its config (default: the published ones);
    ``keep`` maps a name to the decode steps to keep for a mesh run
    (`family_run`'s ``keep``), whose "_yardstick" the third value holds;
    ``kw`` goes to `family_run`."""
    import gc
    import torch
    from repro_torch.configs import ARCHS
    archs = archs or ARCHS
    report = {"card": card, "models": {}}
    launches, yardsticks = {"flash_attention": 0, "rms_norm": 0}, {}
    t0 = time.perf_counter()
    for name, prompt_len, max_len in families:
        t = time.perf_counter()
        n_keep = (keep or {}).get(name, 0)
        r, n = family_run(card, dev, archs[name], prompt_len, max_len,
                          int8_decode=name == INT8_FAMILY, keep=n_keep, **kw)
        if n_keep:
            yardsticks[name] = r.pop("_yardstick")
        r["phase_s"] = time.perf_counter() - t
        report["models"][name] = r
        for kernel, count in n.items():
            launches[kernel] += count
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    report["tolerance"] = {"consistency": [LM_RTOL, LM_ATOL],
                           "card_vs_cpu": list(CARD_CPU_TOL),
                           "state_atol_share": CARD_CPU_SSM_ATOL}
    report["wall_s"] = time.perf_counter() - t0
    return report, launches, yardsticks


# the LM training slice: Hymba-1.5B at full width and depth, TokenPipeline
# batches of 8 x 1024 tokens, two micro-batches a step, remat on; 2 warm
# steps then 4 timed ones
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_WARM, TRAIN_TIMED = \
    8, 1024, 2, 2, 4
# per-kernel gradient checks at Hymba's shape with B = 2: K4's gradients
# (a scan forward and one over reversed time, float32) against autograd
# of the plain loop within a relative L2 of 1e-5 per input (another
# order of the same float32 operations); K3's (its backward IS the plain
# version's, recomputed) within a per-row relative L2 of 2e-2, the
# forward's bar
GRAD_K4_REL, GRAD_K3_ROW = 1e-5, FA_BF16_ROW
# the whole model cut to two layers at full width, card against CPU, the
# same float32 master parameters and batch of 2 x 256 tokens: every
# leaf's gradient non-zero and within the card-vs-CPU logits bar (relative
# L2 per leaf); in float32 compute (K3's float32 path, K4) within 1e-3
GRAD_MODEL_BATCH, GRAD_MODEL_SEQ, GRAD_MODEL_BF16, GRAD_MODEL_F32 = \
    2, 256, CARD_CPU_TOL[0], 1e-3
# the restart drill: two layers at full width, 2 x 256 tokens a step,
# a crash at step 3, checkpoints every 2 steps, 5 steps
DRILL = dict(batch=2, seq=256, steps=5, crash_at=3, ckpt_every=2)
# the int8 KV cache against the bf16 one in the Qwen2-VL decode:
# tests/test_substrate.py's bar for the logits
INT8_FAMILY, INT8_LOGITS_GAP = "qwen2-vl-7b", 0.3


def rel_l2(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def row_rel_l2(a, b) -> float:
    """The largest relative L2 error over the rows of the last axis."""
    a, b = a.detach().float(), b.detach().float()
    return float(((a - b).norm(dim=-1)
                  / b.norm(dim=-1).clamp_min(1e-30)).max())


def leaf_names(tree, path: str = "") -> list:
    """The paths of a parameter tree's leaves, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{path}/{k}" if path else k)]
    return [path]


def kernel_grad_checks(dev, cfg, batch: int = 2, seq: int = TRAIN_SEQ):
    """K3's and K4's autograd Functions against autograd of their plain
    versions on ``dev``, at Hymba's per-layer shapes with ``batch`` rows
    and a random upstream gradient. Launches made here are not counted on
    the main path."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    # K4: T = S steps over B*H*Dh*N channels, the decay per (row, head)
    rep = D * cfg.ssm_state
    a0 = torch.rand(seq, batch * H, generator=gen, device=dev) * 0.9 + 0.05
    b0 = torch.randn(seq, batch * H * rep, generator=gen, device=dev)
    y00 = torch.randn(batch * H * rep, generator=gen, device=dev)
    gy = torch.randn(seq, batch * H * rep, generator=gen, device=dev)
    gf = torch.randn(batch * H * rep, generator=gen, device=dev)
    res = []
    for fn in (ops.ssm_scan, lambda a, b, y0: ref.ssm_scan_ref(
            a.repeat_interleave(rep, 1), b, y0)):
        a, b, y0 = (x.clone().requires_grad_(True) for x in (a0, b0, y00))
        ys, yf = fn(a, b, y0)
        res.append(torch.autograd.grad((ys * gy).sum() + (yf * gf).sum(),
                                       (a, b, y0)))
    k4 = {n: rel_l2(g, w) for n, g, w in zip(("a", "b", "y0"), *res)}
    out["ssm_scan"] = {"shape": [seq, batch * H * rep], "rel_l2": k4,
                       "bar": GRAD_K4_REL}
    check(all(v <= GRAD_K4_REL for v in k4.values()),
          f"ssm_scan gradients against the plain version's beyond "
          f"{GRAD_K4_REL}: {k4}")
    del res, a0, b0, y00, gy
    # K3: bf16, causal, q (B,H,S,D) and k/v (B,KV,S,D) as the model's
    # transposed views give them
    q0 = torch.randn(batch, seq, H, D, generator=gen,
                     device=dev).bfloat16().transpose(1, 2)
    k0, v0 = (torch.randn(batch, seq, KV, D, generator=gen,
                          device=dev).bfloat16().transpose(1, 2)
              for _ in range(2))
    g = torch.randn(batch, H, seq, D, generator=gen, device=dev).bfloat16()
    res = []
    for fn in (ops.flash_attention, ref.flash_attention_ref):
        q, k, v = (x.detach().requires_grad_(True) for x in (q0, k0, v0))
        res.append(torch.autograd.grad(fn(q, k, v, causal=True), (q, k, v),
                                       g))
    k3 = {n: row_rel_l2(a, b) for n, a, b in zip(("q", "k", "v"), *res)}
    out["flash_attention"] = {
        "shape": [batch, H, KV, seq, D], "row_rel_l2": k3,
        "max_abs": {n: float((a.float() - b.float()).abs().max())
                    for n, a, b in zip(("q", "k", "v"), *res)},
        "bar": GRAD_K3_ROW}
    check(all(v <= GRAD_K3_ROW for v in k3.values()),
          f"flash_attention gradients against the plain version's beyond "
          f"{GRAD_K3_ROW}: {k3}")
    return out


def model_grad_check(dev, cfg, params, dtype: str, bar: float,
                     batch: int = GRAD_MODEL_BATCH,
                     seq: int = GRAD_MODEL_SEQ):
    """`transformer.loss_fn` and every parameter's gradient of the model
    cut to two layers, on ``dev`` (both kernels, remat on) and on the CPU
    (the plain versions), from the same float32 master parameters and a
    TokenPipeline batch, in ``dtype`` compute."""
    import dataclasses
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as sc
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_leaves, tree_map
    cfg2, p2 = cut_layers(cfg, params, 2)
    cfg2 = dataclasses.replace(cfg2, dtype=dtype)
    host = TokenPipeline(cfg.vocab_size, seq, batch).batch_at(0)
    grads, losses = {}, {}
    for where in (dev, torch.device("cpu")):
        p = tree_map(lambda a: a.detach().to(where).clone()
                     .requires_grad_(True), p2)
        b = {k: torch.from_numpy(v).to(where) for k, v in host.items()}
        n3, n4 = fa.LAUNCHES.value, sc.LAUNCHES.value
        total, m = transformer.loss_fn(cfg2, p, b)
        total.backward()
        if where.type == "cuda":
            # forward, remat's recompute (and K4's reverse scan) per layer
            check(fa.LAUNCHES.value - n3 == 4 and sc.LAUNCHES.value - n4
                  == 6, f"the two-layer {dtype} gradient did not launch K3 "
                  f"twice and K4 three times a layer")
        grads[where.type] = [a.grad for a in tree_leaves(p)]
        losses[where.type] = float(m["loss"].detach())
        del p, total
    leaf_rel = {}
    for name, gd, gc in zip(leaf_names(p2), grads[dev.type], grads["cpu"]):
        ok = gd is not None and bool(gd.abs().max() > 0)
        check(ok, f"{dtype}: the card's gradient of {name} is missing or "
              f"zero")
        leaf_rel[name] = rel_l2(gd, gc) if ok else float("inf")
    worst = max(leaf_rel, key=leaf_rel.get)
    check(leaf_rel[worst] <= bar, f"{dtype} two-layer gradient of {worst}, "
          f"card vs CPU, {leaf_rel[worst]:.3g} beyond {bar}")
    return {"dtype": dtype, "batch": batch, "seq": seq,
            "loss_card": losses[dev.type], "loss_cpu": losses["cpu"],
            "leaves": len(leaf_rel), "all_nonzero": all(
                v < float("inf") for v in leaf_rel.values()),
            "worst_leaf": worst, "worst_rel_l2": leaf_rel[worst],
            "rel_l2_by_leaf": leaf_rel, "bar": bar}


def restart_drill(dev, cfg, drill=DRILL):
    """`launch.train.train` on the model cut to two layers: a crash at
    ``crash_at`` with checkpoints every ``ckpt_every`` steps, against two
    uninterrupted runs. The crashed run's final state differs from the
    first uninterrupted run's by no more than twice what the two
    uninterrupted runs differ by (the embedding's backward adds with
    atomics on the card), and its last checkpoint restores bit-equal."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch import checkpointing as ck
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.launch import train as train_lib
    from repro_torch.models.layers import tree_leaves
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    shape = ShapeConfig("drill", drill["seq"], drill["batch"], "train")
    kw = dict(ckpt_every=drill["ckpt_every"], log_every=0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        crashed = train_lib.train(
            cfg2, shape, drill["steps"], tmp,
            injector=FaultInjector(crash_at=[drill["crash_at"]]), **kw)
        crashed_s = time.perf_counter() - t
        saved, step = ck.restore(tmp, (crashed["params"], crashed["opt"]))
        state = tree_leaves((crashed["params"], crashed["opt"]))
        restored_equal = all(torch.equal(a, b) for a, b in
                             zip(tree_leaves(saved), state))
    runs = [train_lib.train(cfg2, shape, drill["steps"], None, **kw)
            for _ in range(2)]

    def gap(x, y):
        return max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(tree_leaves((x["params"], x["opt"])),
                                   tree_leaves((y["params"], y["opt"]))))
    run_gap, crash_gap = gap(runs[1], runs[0]), gap(crashed, runs[0])
    check(crashed["final_step"] == drill["steps"],
          f"restart drill ended at {crashed['final_step']}")
    check(step == drill["steps"] - 1 and restored_equal,
          "restart drill: the last checkpoint does not restore bit-equal")
    check(crash_gap <= 2 * run_gap,
          f"restart drill: the crashed run is {crash_gap:.3g} from an "
          f"uninterrupted one, which are {run_gap:.3g} apart")
    return {"n_layers": 2, **drill, "final_step": crashed["final_step"],
            "losses_after_restart": crashed["losses"],
            "losses_uninterrupted": runs[0]["losses"],
            "restored_step": step, "restored_bit_equal": restored_equal,
            "crashed_vs_uninterrupted_max_abs": crash_gap,
            "uninterrupted_vs_uninterrupted_max_abs": run_gap,
            "crashed_run_s": crashed_s}


def lm_train_slice_phase(card: str, dev, cfg, batch: int = TRAIN_BATCH,
                         seq: int = TRAIN_SEQ, accum: int = TRAIN_ACCUM,
                         warm: int = TRAIN_WARM, timed: int = TRAIN_TIMED,
                         grad_batch: int = 2, drill=DRILL,
                         model_seq: int = GRAD_MODEL_SEQ):
    """Train the LM on ``dev`` through `launch.steps.make_train_step` at
    the config's width and depth: float32 master parameters from a seeded
    generator, AdamW, TokenPipeline batches; ``warm`` steps, then
    ``timed`` counted ones, a device profile of one more, then the
    gradient checks and the restart drill. Returns (report, K3/K4/norm
    launches of the counted steps). On the CPU (a rehearsal at reduced
    size) the kernels' plain versions run, nothing is launched and
    nothing is profiled."""
    import gc
    import math
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rms_norm as nk
    from repro_torch.kernels import ssm_scan as sc
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_on
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw
    cuda = dev.type == "cuda"
    shape = ShapeConfig("train", seq, batch, "train", grad_accum=accum)
    report = {"card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "batch": batch, "seq": seq,
              "grad_accum": accum, "remat": cfg.remat,
              "warm_steps": warm, "timed_steps": timed}
    t0 = time.perf_counter()

    def peak_gib():
        if not cuda:
            return "not measured: no card"
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, report["init_ms"] = timed_ms(
        dev, lambda: transformer.build_param_table(cfg).init(
            gen, device=dev, dtype=torch.float32))
    opt = adamw.init(params)
    n_params = sum(a.numel() for a in tree_leaves(params))
    report["params"] = n_params
    report["peak_gib_state"] = peak_gib()
    tokens_per_step = batch * seq
    report["model_tflop_per_step"] = 6 * n_params * tokens_per_step / 1e12
    report["model_tflop_per_step_with_remat"] = (8 * n_params
                                                 * tokens_per_step / 1e12)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch)
    step_fn = steps.make_train_step(cfg, shape)
    per_step = {"flash_attention": 2 * accum * cfg.n_layers,
                "ssm_scan": 3 * accum * cfg.n_layers,
                "rms_norm": accum * norm_launches(cfg, recompute=cfg.remat)}
    counters = {"flash_attention": fa.LAUNCHES, "ssm_scan": sc.LAUNCHES,
                "rms_norm": nk.LAUNCHES}
    step_ms, losses, gnorms, launches_each = [], [], [], []
    for i in range(warm + timed):
        b = batch_on(pipe.batch_at(i), {}, dev)
        if i == warm:
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            for c in counters.values():
                c.reset()
        before = {name: c.value for name, c in counters.items()}
        (params, opt, m), ms = timed_ms(dev, lambda: step_fn(params, opt, b))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if i >= warm:
            step_ms.append(ms)
            launches_each.append({name: c.value - before[name]
                                  for name, c in counters.items()})
    counted = {name: c.value for name, c in counters.items()}
    for name, n in per_step.items():
        want = n if cuda else 0
        check(all(e[name] == want for e in launches_each),
              f"{name}: {[e[name] for e in launches_each]} launches a "
              f"training step, not {want} (forward and remat's recompute"
              f"{' and the reverse scan' if name == 'ssm_scan' else ''} "
              f"per layer and micro-batch"
              f"{', and the final norm' if name == 'rms_norm' else ''})")
    check(all(map(math.isfinite, losses + gnorms)),
          "training: a non-finite loss or grad norm")
    report["losses"] = losses
    report["grad_norms"] = gnorms
    report["step_ms"] = step_ms
    report["ms_per_step"] = sum(step_ms) / len(step_ms)
    report["ms_per_step_median"] = sorted(step_ms)[len(step_ms) // 2]
    report["tokens_per_s"] = tokens_per_step / report["ms_per_step"] * 1e3
    report["model_tflop_per_s"] = (report["model_tflop_per_step"]
                                   / report["ms_per_step"] * 1e3)
    report["peak_gib_steps"] = peak_gib()
    report["launches_per_step"] = launches_each[0]
    report["launches_counted_steps"] = counted
    timing = {"steps": time.perf_counter() - t0}
    t = time.perf_counter()

    # one more step under the profiler: device time by kind, and by span
    # (the plain attention backward, K4's reverse scan and its gradient
    # work, the AdamW update)
    if cuda:
        b = batch_on(pipe.batch_at(warm + timed), {}, dev)

        def one_step():
            nonlocal params, opt
            params, opt, _ = step_fn(params, opt, b)
        report["step_device_profile"] = device_profile(
            one_step, spans=ops.SPANS + (adamw.SPAN,))
    timing["profile"] = time.perf_counter() - t
    t = time.perf_counter()

    checks = {}
    if cuda:
        checks["kernel_gradients"] = kernel_grad_checks(dev, cfg,
                                                        batch=grad_batch,
                                                        seq=seq)
    timing["kernel_gradients"] = time.perf_counter() - t
    t = time.perf_counter()
    checks["model_gradients_2_layers"] = [
        model_grad_check(dev, cfg, params, "bfloat16", GRAD_MODEL_BF16,
                         seq=model_seq),
        model_grad_check(dev, cfg, params, "float32", GRAD_MODEL_F32,
                         seq=model_seq)]
    timing["model_gradients"] = time.perf_counter() - t
    del params, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks["restart_drill"] = restart_drill(dev, cfg, drill)
    timing["restart_drill"] = time.perf_counter() - t
    report["checks"] = checks
    report["timing_s"] = timing
    report["wall_s"] = time.perf_counter() - t0
    return report, counted


# the bridge slice (ApproxPilot-LM): the reference's bench settings
# (benchmarks/lm_bench.py:120-132): the surrogate on qwen2.5-32b at
# train_4k, 400 samples, 40 epochs, alone and as a 4-member ensemble; the
# search on two cells at a budget of 800
BRIDGE_SURROGATE = ("qwen2.5-32b", "train_4k", 400, 40)
BRIDGE_ENSEMBLE = 4
BRIDGE_DSE = (("granite-3-2b", "decode_32k"), ("qwen1.5-110b", "train_4k"))
BRIDGE_BUDGET = 800
# configs served to the surrogate after the fit: 4 chunks of 256
BRIDGE_QUERIES = 1024
# test_system.py's bar for the critical-op accuracy
BRIDGE_CRIT_ACC = 0.85
# the reference's roofline constants (the TPU v5e's, repro/launch/
# roofline.py:23-24): the fronts under them, card against CPU
V5E_PEAK_FLOPS, V5E_HBM_BW = 197e12, 819e9


def v5e_fronts() -> dict:
    """Each `BRIDGE_DSE` cell's `run_dse` front at the reference's
    constants, as exact values: configs and float.hex objectives. Run in
    this process and in a CPU-only one, the two must be equal."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core import lm_bridge
    saved = lm_bridge.PEAK_FLOPS, lm_bridge.HBM_BW
    lm_bridge.PEAK_FLOPS, lm_bridge.HBM_BW = V5E_PEAK_FLOPS, V5E_HBM_BW
    try:
        fronts = {}
        for arch, shape in BRIDGE_DSE:
            out = lm_bridge.run_dse(get_arch(arch), get_shape(shape),
                                    budget=BRIDGE_BUDGET)
            fronts[f"{arch}/{shape}"] = [
                [list(map(int, c)), [float(x).hex() for x in o]]
                for c, o in out["pareto"]]
        return fronts
    finally:
        lm_bridge.PEAK_FLOPS, lm_bridge.HBM_BW = saved


def surrogate_run(dev, ensemble: int = 0) -> dict:
    """`lm_bridge.train_surrogate` on ``dev`` at the bench settings, then
    `BRIDGE_QUERIES` random configs and the property pair through its
    engine; the metrics, the timings and the checks of test_system.py."""
    import numpy as np
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core import lm_bridge
    from repro_torch.kernels import gnn_mp
    arch, shape, n_samples, epochs = BRIDGE_SURROGATE
    n_start = gnn_mp.LAUNCHES.value
    t = time.perf_counter()
    m, predict = lm_bridge.train_surrogate(
        get_arch(arch), get_shape(shape), n_samples=n_samples,
        epochs=epochs, ensemble=ensemble, device=dev)
    fit_s = time.perf_counter() - t
    rng = np.random.default_rng(1)
    queries = [tuple(int(c) for c in rng.integers(0, 3, 7))
               for _ in range(BRIDGE_QUERIES)]
    n0 = gnn_mp.LAUNCHES.value
    t = time.perf_counter()
    y = predict(queries)
    sync(dev)
    query_ms = (time.perf_counter() - t) * 1e3
    n_end = gnn_mp.LAUNCHES.value
    # bf16 vs fp8 everywhere: a check, so its launches are not counted
    pred = predict([(0,) * 7, (1,) * 7])
    check(y.shape == (BRIDGE_QUERIES, 4) and bool(np.isfinite(y).all()),
          f"bridge surrogate (ensemble={ensemble}): rows of shape "
          f"{y.shape} or non-finite")
    acc = m["critical_path"]["accuracy"]
    check(acc > BRIDGE_CRIT_ACC, f"bridge surrogate (ensemble={ensemble}): "
          f"critical-op accuracy {acc} <= {BRIDGE_CRIT_ACC}")
    check(pred[1, 0] < pred[0, 0] and pred[1, 2] > pred[0, 2],
          f"bridge surrogate (ensemble={ensemble}): fp8 everywhere not "
          f"predicted faster and at a higher penalty than bf16")
    return {"ensemble": ensemble, "fit_s": fit_s,
            "r2": {k: v["r2"] for k, v in m.items() if "r2" in v},
            "mean_std": {k: v["mean_std"] for k, v in m.items()
                         if "mean_std" in v},
            "critical_op_accuracy": acc,
            "bf16_vs_fp8_everywhere": pred.tolist(),
            "query_ms": query_ms,
            "query_configs_per_s": BRIDGE_QUERIES / query_ms * 1e3,
            "gnn_mp_launches_in_queries": n_end - n0,
            "gnn_mp_launches": n_end - n_start,
            "engine": predict.stats.as_dict()}


def dse_run(arch: str, shape: str) -> dict:
    """`lm_bridge.run_dse` at `BRIDGE_BUDGET`: the baseline, the best
    feasible point, the wall s and the engine's stats."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core import lm_bridge
    t = time.perf_counter()
    out = lm_bridge.run_dse(get_arch(arch), get_shape(shape),
                            budget=BRIDGE_BUDGET)
    wall = time.perf_counter() - t
    base = out["baseline"]
    best = out["best"]
    check(best is not None and best[1][0] <= base["time"]
          and best[1][2] <= 6.0, f"bridge search {arch}/{shape}: no "
          f"feasible point at least as fast as bf16")
    return {"baseline_critical_op": base["critical_op"],
            "baseline_step_ms": base["time"] * 1e3,
            "best_config": [int(c) for c in best[0]],
            "best_speedup": base["time"] / best[1][0],
            "hbm_gb_before": base["hbm_gb"], "hbm_gb_after": best[1][1],
            "penalty": best[1][2], "front": len(out["pareto"]),
            "wall_s": wall, "engine": out["engine"]}


def counted_paths() -> list:
    """The LM paths whose steps the bridge slice holds against their
    measured ms: (label, arch, kind, seq, batch, grad_accum, max_len,
    mesh), at the batch and length each phase times. ``mesh`` (None on
    one card) gives the mesh, the preset and the phase's depth of the
    mesh phase's Granite tp step and serve8 decode step on (2, 2); the
    decode is counted at the last of its cache's slots."""
    on_mesh = {"mesh": "x".join(map(str, MESH_SHAPE)),
               "layers": SMOKE_MESH_LAYERS}
    paths = [("hymba_prefill", LM_ARCH, "prefill", LM_PROMPT, LM_BATCH, 1,
              LM_MAX_LEN, None),
             ("moonlight_prefill", MOE_ARCH, "prefill", LM_PROMPT, LM_BATCH,
              1, LM_MAX_LEN, None)]
    paths += [(f"{name}_prefill", name, "prefill", prompt_len, LM_BATCH, 1,
               max_len, None) for name, prompt_len, max_len in FAMILIES]
    return paths + [
        ("hymba_train_step", LM_ARCH, "train", TRAIN_SEQ, TRAIN_BATCH,
         TRAIN_ACCUM, 0, None),
        ("granite_tp_step_mesh", MESH_ARCH, "train", MESH_SEQ, MESH_BATCH,
         MESH_ACCUM, 0, dict(on_mesh, rules="tp")),
        ("granite_serve8_decode_mesh", MESH_ARCH, "decode",
         MESH_PROMPT + SMOKE_MESH_NEW, MESH_BATCH, 1, 0,
         dict(on_mesh, rules="serve8"))]


def count_paths(paths) -> list:
    """Each path's step counted by `dryrun.run_cell` (`op_profile` on meta
    tensors; a mesh path per position, `op_profile.profile_mesh`)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    out = []
    for label, arch, kind, seq, batch, accum, max_len, mesh in paths:
        cfg = get_arch(arch)
        if mesh:
            cfg = dataclasses.replace(cfg, n_layers=mesh["layers"])
        out.append(dryrun.run_cell(
            cfg, ShapeConfig(label, seq, batch, kind, grad_accum=accum),
            max_len=max_len, verbose=False,
            **({"mesh": mesh["mesh"], "rules_name": mesh["rules"]}
               if mesh else {})))
    return out


def _count_child(conn, paths) -> None:
    import traceback
    try:
        conn.send(("ok", count_paths(paths)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class BackgroundCount:
    """`count_paths` in a spawned process of its own (meta tensors only:
    it touches no card), started at the script's start so that the count
    runs beside the card's phases; `result` waits for it."""

    def __init__(self, paths):
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        self.t0 = time.perf_counter()
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_count_child, args=(child, paths),
                                daemon=True)
        self.proc.start()
        child.close()

    def result(self) -> list:
        status, out = self.conn.recv()
        self.proc.join()
        self.wall_s = time.perf_counter() - self.t0
        if status != "ok":
            raise RuntimeError(f"the background count failed:\n{out}")
        return out

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()


def counted_bounds(paths, records, measured: dict) -> list:
    """Each LM path's counted step (`count_paths`' ``records``), its
    roofline terms at the H100's constants beside the ms its phase
    measured (``measured``, by label). A mesh path's positions all run
    on card 0, so the card's terms are the positions' compute terms
    summed and their memory terms summed."""
    from repro_torch.launch import roofline
    rows = []
    for path, rec in zip(paths, records):
        label, arch, kind, seq, batch, accum, _max_len, mesh = path
        check(rec["status"] == "ok", f"counting {label}: {rec.get('error')}")
        if rec["status"] != "ok":
            continue
        classes = rec.get("classes") or [dict(rec, positions=[0])]
        compute = sum(len(c["positions"]) * c["flops"]
                      for c in classes) / roofline.PEAK_FLOPS * 1e3
        memory = sum(len(c["positions"]) * roofline.memory_bytes(c)
                     for c in classes) / roofline.HBM_BW * 1e3
        fraction = max(compute, memory) / measured[label]
        check(fraction <= 1.0, f"{label}: counted bound {max(compute, memory)}"
              f" ms over the measured {measured[label]} ms: the count is "
              f"wrong")
        row = {"path": label, "arch": arch, "kind": kind,
               "batch": batch, "seq": seq, "grad_accum": accum,
               "flops": rec["flops"], "hbm_bytes": rec["hbm_bytes"],
               "memory": rec["memory"], "peak_bytes": rec["peak_bytes"],
               "compute_ms": compute, "memory_ms": memory,
               "op_level_hbm_ms": sum(
                   len(c["positions"]) * c["hbm_bytes"] for c in classes)
               / roofline.HBM_BW * 1e3, "measured_ms": measured[label],
               "fraction": fraction,
               "bound_by": "compute" if compute >= memory else "memory",
               "n_ops": rec["n_ops"], "count_s": rec["count_s"]}
        if mesh:
            row.update(mesh=rec["mesh"], rules=rec["rules"],
                       n_layers=mesh["layers"], classes=[
                           {"positions": c["positions"], "flops": c["flops"],
                            "memory": c["memory"],
                            "collective_bytes": c["collective_bytes"],
                            "count_s": c["count_s"]} for c in classes],
                       collective_bytes=rec["collective_bytes"],
                       collective_wire_bytes=rec["collective_wire_bytes"])
        print(f"counted bound {label}: {max(compute, memory):.3f} ms "
              f"against the measured {measured[label]:.3f} ms (count "
              f"{rec['count_s']} s)", flush=True)
        rows.append(row)
    return rows


def bridge_slice_phase(card: str, dev, counting: BackgroundCount,
                       measured: dict):
    """ApproxPilot-LM on ``dev``: the surrogate (alone, then an ensemble)
    trained and queried through its engine (`gnn_mp` in every gsae
    layer), the search on two cells at the H100's constants and again at
    the reference's, held bit for bit against a CPU process, and the
    counted bound of each LM path in ``paths`` against its measured ms.
    Returns (report, `gnn_mp` launches of the surrogate runs: the
    engines' construction and their served queries)."""
    import os
    from repro_torch.kernels import gnn_mp
    from repro_torch.launch import roofline
    report = {"card": card, "constants": {
        "peak_flops": roofline.PEAK_FLOPS, "hbm_bw": roofline.HBM_BW}}
    t0 = time.perf_counter()
    gnn_mp.LAUNCHES.reset()
    report["surrogate"] = surrogate_run(dev)
    report["ensemble"] = surrogate_run(dev, BRIDGE_ENSEMBLE)
    launches = {"gnn_mp": report["surrogate"]["gnn_mp_launches"]
                + report["ensemble"]["gnn_mp_launches"]}
    check(launches["gnn_mp"] > 0, "the bridge surrogate never launched "
          "gnn_mp")
    report["launches"] = launches

    report["search"] = {f"{a}/{s}": dse_run(a, s) for a, s in BRIDGE_DSE}
    here = v5e_fronts()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    cpu = json.loads(subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.v5e_fronts()))"], env=env,
        capture_output=True, text=True, check=True,
        timeout=300).stdout.splitlines()[-1])
    same = {k: here[k] == cpu[k] for k in here}
    check(all(same.values()), f"v5e-constant fronts differ card vs CPU: "
          f"{same}")
    report["v5e_fronts_card_vs_cpu"] = {
        k: {"identical": same[k], "front": len(here[k])} for k in here}

    t = time.perf_counter()
    paths = counted_paths()
    report["counted_bounds"] = counted_bounds(paths, counting.result(),
                                              measured)
    report["count_wait_s"] = time.perf_counter() - t
    report["count_s"] = sum(r["count_s"] for r in report["counted_bounds"])
    report["count_wall_s"] = counting.wall_s
    report["wall_s"] = time.perf_counter() - t0
    return report, launches


# the split slice: every devices= split of the ApproxPilot main path over a
# device list (each card when there are several, else the one card named
# SPLIT_REPEAT times), each held against its unsplit run. The ensemble and
# the data-parallel fit are cut to SPLIT_EPOCHS epochs and the island fleet
# to SPLIT_ISLAND_BUDGET requests for the time limit; the data-parallel fit
# takes the first SPLIT_DP_ROWS rows, which 2, 4 and 8 divide (the 1,843
# rows of the training split only 1 and 19 do). GPipe: Granite-3-2B at full
# width and depth, 4 stages of 10 layers, 8 micro-batches of 2 x 1024.
SPLIT_REPEAT, SPLIT_EPOCHS, SPLIT_ISLAND_BUDGET = 4, 2, 4_000
SPLIT_DP_ROWS = 1840
# data parallelism reduces in another order: tests/test_training.py's bar
DP_TOL = 1e-6
GPIPE_ARCH, GPIPE_STAGES, GPIPE_MICRO, GPIPE_BATCH, GPIPE_SEQ = \
    "granite-3-2b", 4, 8, 2, 1024


def split_devices() -> list:
    """Every card when there are several, else card 0 named
    SPLIT_REPEAT times."""
    import torch
    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * SPLIT_REPEAT


def sync_all(devs) -> None:
    for d in set(devs):
        sync(d)


def max_leaf_diff(a, b) -> float:
    from torch.utils import _pytree as pytree
    return max(float((x.double().cpu() - y.double().cpu()).abs().max())
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def gpipe_run(dev, devs, cfg=None, n_stages: int = GPIPE_STAGES,
              n_micro: int = GPIPE_MICRO, batch: int = GPIPE_BATCH,
              seq: int = GPIPE_SEQ):
    """Granite's blocks as GPipe stages on the stage mesh over ``devs``
    (cycled to ``n_stages`` devices) against the same blocks in sequence
    on ``dev``: random bf16 weights and inputs from a seeded generator;
    ``cfg`` (default: GPIPE_ARCH's published config) sets the stack.
    Returns (report, the pipelined passes' K3 launches, the sequential
    passes' K3 launches)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import pipeline as pp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_leaves, tree_map
    cfg = cfg or get_arch(GPIPE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = transformer.build_param_table(cfg).init(
        gen, device=dev, dtype=torch.bfloat16)["blocks"]
    per = cfg.n_layers // n_stages
    stacked = tree_map(lambda a: a.reshape(n_stages, per, *a.shape[1:]),
                       blocks)
    xs = torch.randn(n_micro, batch, seq, cfg.d_model, device=dev,
                     generator=gen).to(torch.bfloat16)
    pos = torch.arange(seq, dtype=torch.int32, device=dev).expand(batch, seq)
    stage_devs = [devs[i % len(devs)] for i in range(n_stages)]
    pos_on = {d: pos.to(d) for d in set(stage_devs)}

    def stage_fn(lp, x):
        for i in range(per):
            x = transformer.block_fwd(cfg, transformer.layer_params(lp, i),
                                      x, pos_on[x.device])[0]
        return x

    apply = pp.pipelined(stage_fn, n_stages, n_micro,
                         pp.make_stage_mesh(n_stages, stage_devs))

    def sequential():
        out = []
        for m in range(n_micro):
            x = xs[m]
            for i in range(cfg.n_layers):
                x = transformer.block_fwd(cfg, transformer.layer_params(
                    blocks, i), x, pos)[0]
            out.append(x)
        return torch.stack(out)

    def timed(fn):
        sync_all(stage_devs + [dev])
        t = time.perf_counter()
        out = fn()
        sync_all(stage_devs + [dev])
        return out, (time.perf_counter() - t) * 1e3

    with torch.no_grad():
        n0 = fa.LAUNCHES.value
        seq_out, seq_cold_ms = timed(sequential)
        _, seq_ms = timed(sequential)
        n1 = fa.LAUNCHES.value
        pipe_out, pipe_cold_ms = timed(lambda: apply(stacked, xs))
        _, pipe_ms = timed(lambda: apply(stacked, xs))
        n2 = fa.LAUNCHES.value
        # where one warm pass's device time goes, by kind of kernel (the
        # profiled passes' launches are left out of the counts above)
        profiles = {} if dev.type != "cuda" else {
            "sequential_device_profile": device_profile(sequential),
            "pipelined_device_profile": device_profile(
                lambda: apply(stacked, xs))}
    same = bool(torch.equal(pipe_out, seq_out))
    finite = bool(torch.isfinite(pipe_out.float()).all())
    check(same and finite and pipe_out.shape == xs.shape,
          f"GPipe over {n_stages} stages differs from the sequential "
          f"blocks (equal {same}, finite {finite})")
    report = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads],
        "block_params": sum(a.numel() for a in tree_leaves(blocks)),
        "stages": n_stages, "layers_a_stage": per, "micro_batches": n_micro,
        "micro_batch": [batch, seq], "stage_devices": [str(d) for d in
                                                       stage_devs],
        "bubble_fraction": pp.bubble_fraction(n_micro, n_stages),
        "sequential_ms": seq_ms, "pipelined_ms": pipe_ms,
        "sequential_cold_ms": seq_cold_ms, "pipelined_cold_ms": pipe_cold_ms,
        "bit_equal": same, "finite": finite,
        "flash_attention_launches_a_pass": (n2 - n1) // 2, **profiles}
    return report, n2 - n1, n1 - n0


def split_slice_phase(card: str, dev, devs, gaussian, trained, kept, *,
                      chunk: int = CHUNK, n_layers: int = N_LAYERS,
                      hidden: int = HIDDEN, n_members: int = ENS_MEMBERS,
                      epochs: int = SPLIT_EPOCHS,
                      dp_rows: int = SPLIT_DP_ROWS,
                      island_budget: int = SPLIT_ISLAND_BUDGET,
                      pop: int = SEARCH_POP, n_islands: int = N_ISLANDS,
                      gpipe: dict = None):
    """Every ``devices=`` split of the main path over ``devs``, each held
    against its unsplit run: the paper-width Gaussian engine (a fresh 512
    and 2,048-config request, direct and through submit/drain), the
    8-member ensemble's member split, the data-parallel fit, the island
    fleet's rank split, `run_staged` with ``eval_devices`` on the pipeline
    slice's kept store (``kept``), and GPipe stages of Granite-3-2B.
    Returns (report, launches of the split runs); the unsplit runs'
    launches are reported apart as ``check_launches``."""
    import dataclasses
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.core import gnn, islands, models, training
    from repro_torch.core import pipeline as P
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.core.engine import SurrogateEngine
    from repro_torch.kernels import ops
    ctx, ds = gaussian
    t0 = time.perf_counter()
    report = {"card": card, "devices": [str(d) for d in devs],
              "distinct_cards": len(set(devs))}
    reset_launch_counts()
    zero = launch_counts()
    main, aside = dict(zero), dict(zero)

    def measured(fn, split: bool):
        nonlocal main, aside
        before = launch_counts()
        sync_all(devs + [dev])
        t = time.perf_counter()
        out = fn()
        sync_all(devs + [dev])
        ms = (time.perf_counter() - t) * 1e3
        got = counts_since(before)
        if split:
            main = counts_sum(main, got)
        else:
            aside = counts_sum(aside, got)
        return out, ms, got

    # -- the engine: a chunk's config rows over the devices -----------------
    cfg = models.TwoStageConfig(gnn=gnn.GNNConfig(
        arch="gsae", n_layers=n_layers, hidden=hidden,
        feature_dim=ds.x.shape[-1]))
    params = models.init(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    one = SurrogateEngine.from_gnn(cfg, params, ds, ctx.app, ctx.entries,
                                   chunk_size=chunk, device=dev)
    split = SurrogateEngine.from_gnn(cfg, params, ds, ctx.app, ctx.entries,
                                     chunk_size=chunk, devices=devs,
                                     device=dev)
    check(split.devices == split.stats.devices == len(devs),
          f"split engine reports {split.devices} devices for {len(devs)}")
    fresh = _fresh_configs(ctx, ds, 5 * chunk, seed=11)
    small, big = fresh[:chunk], fresh[chunk:]
    engine = {"backend": split.backend, "chunk": chunk, "requests": []}
    big_one = None
    for label, cfgs in (("fresh", small), ("fresh", big)):
        r1, ms1, l1 = measured(lambda: one(cfgs), False)
        rs, mss, ls = measured(lambda: split(cfgs), True)
        same = bool(np.array_equal(r1, rs))
        check(same and np.isfinite(rs).all() and rs.shape == (len(cfgs), 4),
              f"split engine rows differ from devices=1 on {len(cfgs)}")
        engine["requests"].append({
            "request": f"{label} {len(cfgs)}", "one_device_ms": ms1,
            "split_ms": mss, "identical": same,
            "gnn_mp_launches": {"one_device": l1["gnn_mp"],
                                "split": ls["gnn_mp"]},
            "chunks": -(-len(cfgs) // chunk)})
        big_one = r1
    one.clear_cache()
    split.clear_cache()

    def drained(e):
        futs = [e.submit(big[i:i + chunk]) for i in range(0, len(big),
                                                           chunk)]
        check(e.drain() == len(futs), "the submissions were not one wave")
        return np.concatenate([f.result(timeout=120) for f in futs])
    d1, ms1, _ = measured(lambda: drained(one), False)
    dsp, mss, _ = measured(lambda: drained(split), True)
    same = bool(np.array_equal(d1, dsp) and np.array_equal(d1, big_one))
    check(same, "split engine's submit/drain rows differ from devices=1")
    engine["requests"].append({
        "request": f"{len(big) // chunk} submits of {chunk}, one drain",
        "one_device_ms": ms1, "split_ms": mss, "identical": same})
    first = engine["requests"][0]["gnn_mp_launches"]
    engine["gnn_mp_per_chunk"] = first
    engine["slices_a_chunk"] = first["split"] // max(first["one_device"], 1)
    if dev.type == "cuda":
        # K1 alone at the slice's shape beside the chunk's (the layers
        # 300 -> 300), on a CUDA graph of the calls
        g = torch.Generator(device=dev).manual_seed(5)
        rows = {}
        for B in (chunk, chunk // max(engine["slices_a_chunk"], 1)):
            h = torch.randn(B, 32, hidden, device=dev, generator=g)
            adj = torch.rand(32, 32, device=dev, generator=g)
            ws, wn = (torch.randn(hidden, hidden, device=dev, generator=g)
                      * hidden ** -0.5 for _ in range(2))
            b = torch.zeros(hidden, device=dev)
            rows[f"B={B}"] = cuda_ms(lambda: ops.gnn_mp(adj, h, ws, wn, b),
                                     50)
        engine["gnn_mp_layer_ms"] = rows
    report["engine"] = engine

    # -- the ensemble: each group's member axis over the devices -------------
    tr, _ = ds.split(TRAIN_SPLIT)
    tce = training.TrainConfig(epochs=epochs)

    def timed_s(fn):
        sync_all(devs + [dev])
        t = time.perf_counter()
        out = fn()
        sync_all(devs + [dev])
        return out, time.perf_counter() - t

    (e1, h1), s1 = timed_s(lambda: training.fit_ensemble(
        cfg, tr, tce, n_members=n_members, device=dev))
    (es, hs), ss = timed_s(lambda: training.fit_ensemble(
        cfg, tr, tce, n_members=n_members, device=dev, devices=devs))
    f32 = max_leaf_diff(e1.groups[0][1], es.groups[0][1])
    f32_same = f32 == 0 and bool(np.array_equal(h1["train_loss"],
                                                hs["train_loss"]))
    ens = {"members": n_members, "epochs": epochs, "rows": len(tr.y),
           "one_device_s": s1, "split_s": ss,
           "float32_identical": f32_same, "float32_param_max_abs": f32}
    if not f32_same:
        # the same runs in float64, where only the order of the arithmetic
        # differs: the loop on one device against the member split
        n, bs = len(tr.y), min(tce.batch_size, len(tr.y))
        runs = [training._run_inputs(cfg, tce, tce.seed + m, n, dev)
                for m in range(n_members)]
        data64 = {k: v.double() for k, v in training._as_data(
            tr, dev).items()}
        p64 = pytree.tree_map(lambda *xs: torch.stack(xs).double(),
                              *[r[0] for r in runs])
        idx = torch.stack([r[1] for r in runs])
        w = torch.stack([r[2] for r in runs]).double()
        pa, (la, _, _) = training._fit(cfg, tce, data64, p64, idx, w,
                                       [r[3] for r in runs])
        pb, (lb, _, _) = training._fit_split(
            cfg, tce, data64, p64, idx, w,
            [tce.seed + m for m in range(n_members)], None, devs)
        rel64 = float(np.max(np.abs(la - lb) / np.abs(la)))
        ens.update(float64_identical=max_leaf_diff(pa, pb) == 0 and bool(
            np.array_equal(la, lb)), float64_param_max_abs=max_leaf_diff(
                pa, pb), float64_loss_max_rel=rel64,
            float64_bar=LOSS_RTOL)
        check(rel64 <= LOSS_RTOL, f"ensemble member split in float64: "
              f"per-step losses {rel64} apart")
        check(ens["float64_param_max_abs"] <= DP_TOL,
              f"ensemble member split in float64: parameters "
              f"{ens['float64_param_max_abs']} > {DP_TOL}")
    report["ensemble"] = ens

    # -- data parallelism: a single fit's sample axis over the devices -------
    trd = ds.split(dp_rows / len(ds.y))[0]
    check(len(trd.y) == dp_rows, f"{len(trd.y)} data-parallel rows")
    tcd = training.TrainConfig(epochs=epochs)
    (pa, ha), sa = timed_s(lambda: training.fit_two_stage(
        cfg, trd, tcd, return_history=True, device=dev))
    (pb, hb), sb = timed_s(lambda: training.fit_two_stage(
        cfg, trd, dataclasses.replace(tcd, data_parallel=True),
        return_history=True, device=dev, devices=devs))
    f32 = max_leaf_diff(pa, pb)
    dp = {"rows": dp_rows, "epochs": epochs, "one_device_s": sa,
          "split_s": sb, "float32_param_max_abs": f32,
          "float32_loss_max_abs": float(np.abs(ha.train_loss
                                               - hb.train_loss).max()),
          "bar": DP_TOL}
    if f32 > DP_TOL:
        n, bs = dp_rows, min(tcd.batch_size, dp_rows)
        p0 = pytree.tree_map(lambda a: a.double(), models.init(
            torch.Generator().manual_seed(tcd.seed), cfg, device=dev))
        idx, w = training._plan_for(tcd, n, bs)
        data64 = {k: v.double() for k, v in training._as_data(
            trd, dev).items()}
        fa64, _ = training._fit(cfg, tcd, data64, p0, idx, w.double(),
                                training._dropout_generator(tcd.seed, dev))
        fb64, _ = training._fit(cfg, tcd, data64, p0, idx, w.double(),
                                training._dropout_generator(tcd.seed, dev),
                                devices=devs)
        dp["float64_param_max_abs"] = max_leaf_diff(fa64, fb64)
        check(dp["float64_param_max_abs"] <= DP_TOL,
              f"data-parallel fit in float64: {dp['float64_param_max_abs']}"
              f" > {DP_TOL}")
    report["data_parallel"] = dp

    # -- the island fleet: the rank kernel's island axis over the devices ----
    tcfg, tparams = trained
    sizes = [len(ctx.entries[node.kind]) for node in ctx.app.unit_nodes]
    eng_i = SurrogateEngine.from_gnn(tcfg, tparams, ds, ctx.app, ctx.entries,
                                     chunk_size=chunk, devices=devs,
                                     device=dev)
    stacks = []
    ranks_of = islands.fleet_ranks

    def recorded(F, backend="auto", device=None, devices=None):
        r = ranks_of(F, backend, device, devices)
        stacks.append((np.array(F), r))
        return r

    islands.fleet_ranks = recorded
    try:
        res_s, ms_s, _ = measured(lambda: islands.run_islands(
            sizes, eng_i, island_budget, seed=0, n_islands=n_islands,
            pop=pop, nds_backend="torch", device=dev, devices=devs), True)
    finally:
        islands.fleet_ranks = ranks_of
    differ = sum(not np.array_equal(r, ranks_of(F, "numpy"))
                 for F, r in stacks)
    res_n, ms_n, _ = measured(lambda: islands.run_islands(
        sizes, eng_i, island_budget, seed=0, n_islands=n_islands, pop=pop,
        nds_backend="numpy"), False)
    same = (res_s.pareto_configs == res_n.pareto_configs
            and np.array_equal(res_s.pareto_objs, res_n.pareto_objs))
    check(stacks and differ == 0 and same,
          f"split fleet ranks differ from NumPy in {differ} of "
          f"{len(stacks)} generations, fronts identical {same}")
    report["islands"] = {
        "islands": n_islands, "pop": pop, "budget": island_budget,
        "split_ms": ms_s, "numpy_ms": ms_n, "rank_stacks": len(stacks),
        "rank_stacks_differing": differ, "front": len(res_s.pareto_configs),
        "front_identical": same}

    # -- the staged pipeline: eval_devices on the pipeline slice's store -----
    if kept is not None:
        pcfg, root, front_c, front_o = kept
        store = ArtifactStore(root)
        store.evict(store.key("search", P._search_spec(pcfg)))
        scfg = dataclasses.replace(pcfg, eval_devices=tuple(
            str(d) for d in devs))
        res, ms, _ = measured(lambda: P.run_staged(scfg, store, device=dev),
                              True)
        same = (res.pareto_configs == front_c
                and np.array_equal(res.pareto_objs, front_o))
        hits, misses = res.metrics["store"]["hits"], \
            res.metrics["store"]["misses"]
        check(same and res.engine.devices == len(devs)
              and hits.get("train") == 1 and misses.get("search") == 1,
              f"run_staged over {len(devs)} devices: front identical "
              f"{same}, engine devices {res.engine.devices}, store "
              f"{res.metrics['store']}")
        report["staged"] = {
            "eval_devices": list(scfg.eval_devices), "wall_ms": ms,
            "stage_s": res.timings, "store": res.metrics["store"],
            "front": len(res.pareto_configs), "front_identical": same,
            "engine_devices": res.engine.devices}
    else:
        check(False, "the pipeline slice kept no store for the split")

    # -- GPipe: Granite-3-2B's blocks as stages over the devices --------------
    gp, pipe_k3, seq_k3 = gpipe_run(dev, devs, **(gpipe or {}))
    report["gpipe"] = gp

    launches = dict(main, flash_attention=pipe_k3)
    report["launches"] = launches
    report["check_launches"] = dict(aside, flash_attention=seq_k3)
    report["wall_s"] = time.perf_counter() - t0
    for name in ("gnn_mp", "lut_eval", "flash_attention"):
        check(dev.type != "cuda" or launches[name] > 0,
              f"{name} was never launched in the split slice")
    return report, launches


# -- the LM over a (data, model) mesh: what the dense and MoE phases share --
MESH_BATCH, MESH_SEQ, MESH_ACCUM, MESH_TIMED = 8, 1024, 2, 2
MESH_PROMPT, MESH_NEW = 1024, 32
# the dense and MoE mesh phases in `main`: fewer timed training steps
# and decode steps, no training-step profile, 8 of Granite-3-2B's 40
# layers and of Moonlight's 48 in serving (each line's "reduced")
SMOKE_MESH_TIMED, SMOKE_MESH_NEW = 1, 16
SMOKE_MESH_LAYERS, SMOKE_MOE_SERVE_LAYERS = 8, 8
# the families mesh phase's serving runs (Hymba-1.5B on (2, 2) and
# (1, 5), Qwen2-VL-7B on (1, 4)) in `main`: 8 of their 32 and 28 layers
SMOKE_FAM_SERVE_LAYERS = 8
# bf16 bars of the sharded run against the unsplit one: the loss (the
# reference's own bar between its presets, tests/test_sharding.py), the
# first moment (a tenth of the gradient) of the checked leaves, as the
# two-layer card-vs-CPU gradient bar of the training slice
MESH_LOSS_ATOL, MESH_GRAD_REL = 5e-3, 5e-2
# float32 compute: the sharded step within 1e-5 (relative) of the unsplit
# one, loss and first moments, the bar of the CPU tests (another
# summation order of the same float32 products)
MESH_F32_REL = 1e-5


def _leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _first_layer(t):
    """A checked leaf's first layer (a stacked leaf), as float32 on the
    host."""
    from repro_torch.distributed import meshes as M
    if M.is_placed(t):
        t = t.gather()
    t = t.detach()
    return (t[0] if t.dim() == 3 else t).float().cpu().clone()


def peak_gib(dev):
    import torch
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else "not measured: no card")


def free_card(dev) -> None:
    """Collect garbage and, on the card, empty the cache and restart the
    peak."""
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def k3_launches() -> int:
    from repro_torch.kernels import flash_attention as fa
    return fa.LAUNCHES.value


def k4_launches() -> int:
    from repro_torch.kernels import ssm_scan as sc
    return sc.LAUNCHES.value


def mesh_on(devs, shape):
    """A ("data", "model") mesh of ``shape`` over ``devs`` cycled to its
    size, and its devices."""
    import math
    from repro_torch.launch.mesh import make_mesh
    ds = [devs[i % len(devs)] for i in range(int(math.prod(shape)))]
    return make_mesh(shape, ("data", "model"), ds), ds


def rel_l2_each(a: dict, b: dict) -> dict:
    """Relative L2 of each of ``a``'s tensors against ``b``'s."""
    return {p: float((a[p] - b[p]).norm() / b[p].norm().clamp_min(1e-30))
            for p in a}


def max_gap(a_list, b_list) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(a_list, b_list))


def greedy_agree(a_list, b_list) -> float:
    """The share of (step, row) whose greedy tokens agree."""
    hits = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
               for a, b in zip(a_list, b_list))
    return hits / sum(a.shape[0] for a in a_list)


# AdamW's global-norm clip (`optim.adamw.update`'s default, which every
# training step of the port keeps)
MAX_GRAD_NORM = 1.0


def leaf_paths(tree, prefix: str = "") -> list:
    """A tree of dicts' leaf paths in `models.layers.tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}" if prefix
                                    else k)]
    return [prefix]


def train_run(dev, step, state, batch_at, n_steps: int, leaves,
              routes: bool = False, unclipped: bool = False):
    """``step`` run ``n_steps`` times from ``state`` (params, opt) on
    ``batch_at(i)``, each timed on the device. Returns (state, run): each
    step's loss, grad norm and K3 and K4 launches, the wall ms of the
    steps after the first and their mean, the first step's metrics, the
    first layer's first moments of ``leaves`` (every leaf where None)
    after it and, with ``routes``, its recorded `moe.place` calls. With
    ``unclipped`` the first moments are divided by the step's clip scale
    (min(1, MAX_GRAD_NORM / grad norm), the one scalar that moves every
    leaf alike), and "sq0" holds each leaf's squared L2 over every layer
    so divided: the share of the grad norm each carries."""
    from contextlib import nullcontext
    from repro_torch.distributed import meshes as M
    params, opt = state
    run = {"losses": [], "grad_norms": [], "k3_per_step": [],
           "k4_per_step": [], "step_ms": []}
    for i in range(n_steps):
        b = batch_at(i)
        before, before4 = k3_launches(), k4_launches()
        with (recorded_routes() if routes and i == 0
              else nullcontext([])) as seen:
            (params, opt, m), ms = timed_ms(dev, lambda: step(params, opt,
                                                              b))
        run["k3_per_step"].append(k3_launches() - before)
        run["k4_per_step"].append(k4_launches() - before4)
        run["losses"].append(float(m["loss"]))
        run["grad_norms"].append(float(m["grad_norm"]))
        if i == 0:
            run["first_step_ms"] = ms
            run["metrics0"] = {k: float(m[k]) for k in
                               ("loss", "grad_norm", "moe_aux") if k in m}
            scale = (min(1.0, MAX_GRAD_NORM / max(float(m["grad_norm"]),
                                                  1e-6))
                     if unclipped else 1.0)
            paths = leaf_paths(opt.m) if leaves is None else leaves
            run["m0"] = {p: _first_layer(_leaf(opt.m, p)) / scale
                         for p in paths}
            if unclipped:
                run["sq0"] = {}
                for p in leaf_paths(opt.m):
                    t = _leaf(opt.m, p)
                    t = t.gather() if M.is_placed(t) else t
                    run["sq0"][p] = float(t.double().square().sum()
                                          ) / scale ** 2
                    del t
            run["routes0"] = [(a.cpu(), k.cpu()) for a, k in seen]
        else:
            run["step_ms"].append(ms)
    run["ms_per_step"] = (sum(run["step_ms"]) / len(run["step_ms"])
                          if run["step_ms"] else None)
    return (params, opt), run


def held_train(label: str, run: dict, want: dict, bars: dict,
               loss_bar: float, per_step: int, cuda: bool,
               grad_norm_bar: float = None) -> dict:
    """Check a sharded training run against the unsplit ``want`` (both of
    `train_run`): finite losses and norms, the first step's loss within
    ``loss_bar`` of ``want``'s, each first moment of ``bars`` within its
    bar (relative L2), the first step's grad norm within
    ``grad_norm_bar`` (relative) where given, and, on the card,
    ``per_step`` K3 launches a step. Returns the readings."""
    import math
    rel = rel_l2_each(run["m0"], want["m0"])
    loss_gap = abs(run["losses"][0] - want["losses"][0])
    gn, gn_want = run["grad_norms"][0], want["grad_norms"][0]
    gn_gap = abs(gn - gn_want) / max(abs(gn_want), 1e-30)
    over = {p: [rel[p], bar] for p, bar in bars.items() if not rel[p] <= bar}
    check(all(map(math.isfinite, run["losses"] + run["grad_norms"])),
          f"{label}: a non-finite loss or grad norm")
    check(loss_gap <= loss_bar, f"{label}: loss {run['losses'][0]} against "
          f"{want['losses'][0]}, bar {loss_bar}")
    check(not over, f"{label}: first moments over their bars {over}")
    check(grad_norm_bar is None or gn_gap <= grad_norm_bar,
          f"{label}: grad norm {gn} against {gn_want}, relative gap "
          f"{gn_gap}, bar {grad_norm_bar}")
    check(not cuda or all(e == per_step for e in run["k3_per_step"]),
          f"{label}: {run['k3_per_step']} K3 launches a step, not "
          f"{per_step} (forward and recompute, every layer, position and "
          f"micro-batch)")
    out = {"loss_gap_step0": loss_gap, "loss_bar": loss_bar,
           "grad_norm_step0": [gn, gn_want],
           "first_moment_rel_l2_layer0": rel, "first_moment_bars": bars}
    if grad_norm_bar is not None:
        out["grad_norm_rel_gap_step0"] = gn_gap
        out["grad_norm_bar"] = grad_norm_bar
    return out


def serve8_unsplit(dev, cfg, params, toks, new: int, feed=None,
                   extra=None):
    """The one-card serve8 run: a prefill of ``toks`` (B, prompt) and the
    family's ``extra`` inputs, its cache quantized where it has an int8
    form, then ``new`` decode steps fed ``feed`` or greedy. Returns (the
    prefill's last logits and each step's, float32; the tokens fed; each
    step's wall ms; the cache)."""
    from repro_torch.models import decoding
    prompt = toks.shape[1]
    last, cache = decoding.prefill(cfg, params,
                                   {"tokens": toks, **(extra or {})},
                                   max_len=prompt + new)
    if decoding.has_int8_cache(cfg):
        cache = decoding.quantize_cache(cfg, cache)
    out, fed, ms = [last.float()], [], []
    for t in range(new):
        nxt = (out[-1].argmax(-1, keepdim=True).int() if feed is None
               else feed[t])
        fed.append(nxt)
        (lg, cache), d = timed_ms(dev, lambda: decoding.decode_step(
            cfg, params, cache, nxt, prompt + t))
        ms.append(d)
        out.append(lg[:, 0].float())
    return out, fed, ms, cache


def serve8_mesh(dev, cfg, mesh, dfn, P, toks, feed, routes: bool = False,
                extra=None, warm: int = 0):
    """serve8 over ``mesh``: a warm prefill of ``toks`` (of its first
    ``warm`` positions where given) and the family's ``extra`` inputs
    placed by rows, a timed one, its cache quantized where it has an int8
    form, then the decode steps ``dfn`` of `launch.steps.plan` fed
    ``feed``. Returns a dict: the logits
    (float32, gathered on ``dev``) as `serve8_unsplit`'s, the prefill's
    wall ms and K3 and K4 launches, each step's, the placed prompts
    ("tokens") and inputs ("batch"), the cache and, with ``routes``, the
    warm prefill's and the second step's recorded `moe.place` calls."""
    from contextlib import nullcontext
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed import spmd
    from repro_torch.models import decoding
    B, prompt = toks.shape
    max_len = prompt + len(feed)
    tplaced = M.place(toks, M.data_sharding(mesh, B, 2))
    placed = {"tokens": tplaced, **{
        k: M.place(v, M.data_sharding(mesh, B, v.dim()))
        for k, v in (extra or {}).items()}}
    warm_in = placed if not warm else dict(placed, tokens=M.place(
        toks[:, :warm], M.data_sharding(mesh, B, 2)))
    with (recorded_routes() if routes else nullcontext([])) as seen:
        spmd.prefill(cfg, mesh, P, warm_in, max_len=max_len)     # warm
    out = {"tokens": tplaced, "batch": placed,
           "prefill_routes": [(i.cpu(), k.cpu()) for i, k in seen]}
    before, before4 = k3_launches(), k4_launches()
    (lg, cache), out["prefill_ms"] = timed_ms(dev, lambda: spmd.prefill(
        cfg, mesh, P, placed, max_len=max_len))
    out["prefill_k3"] = k3_launches() - before
    out["prefill_k4"] = k4_launches() - before4
    if decoding.has_int8_cache(cfg):
        cache = spmd.quantize_cache(cfg, cache)
    out["cache_bytes_per_position"] = M.nbytes_per_position(cache)
    got, step_ms, step_k3 = [lg.gather(dev).float()], [], []
    for t in range(len(feed)):
        before = k3_launches()
        with (recorded_routes() if routes and t == 1
              else nullcontext([])) as seen:
            (lg, cache), d = timed_ms(dev, lambda: dfn(P, cache, feed[t],
                                                       prompt + t))
        if t == 1:
            out["step_routes"] = list(seen)
        step_k3.append(k3_launches() - before)
        step_ms.append(d)
        got.append(lg.gather(dev)[:, 0].float())
    out.update(got=got, step_ms=step_ms, step_k3=step_k3, cache=cache)
    return out


def serve8_checks(label: str, got, want, own: float,
                  own_agree: float) -> dict:
    """Hold the sharded run's logits ``got`` against the unsplit run's
    ``want`` at twice the unsplit run's own bf16-vs-float32 max gap
    ``own`` (at the same prompts and fed tokens); greedy agreement is
    reported beside the unsplit run's with float32 (random weights: no
    floor). Returns the readings."""
    gaps = [float((a - b).abs().max()) for a, b in zip(got, want)]
    bar = 2 * own
    check(max(gaps) <= bar and all(map(finite, got)),
          f"{label} against the unsplit int8 run: gaps {gaps}, bar {bar}")
    return {"logits_max_abs_gap": max(gaps), "prefill_gap": gaps[0],
            "bar": bar, "bar_rule": "2 x the unsplit run's own bf16-vs-"
            "float32 max abs gap at the same prompts and fed tokens",
            "unsplit_bf16_vs_float32_gap": own,
            "logits_max_abs": max(float(w.abs().max()) for w in want),
            "greedy_agree_share": greedy_agree(got, want),
            "unsplit_bf16_vs_float32_greedy_agree_share": own_agree}


def phase_cuts(timed: int, timed0: int, new: int, new0: int,
               profile_train: bool, layers: int = 0, layers0: int = 0):
    """What a mesh phase's run leaves out against its defaults (the run
    of `scripts/lm_mesh_slice.py`), for its line's "reduced"."""
    out = []
    if layers and layers < layers0:
        out.append(f"n_layers {layers0} -> {layers}")
    if timed < timed0:
        out.append(f"timed training steps {timed0} -> {timed}")
    if new < new0:
        out.append(f"decode steps {new0} -> {new}")
    if not profile_train:
        out.append("no device profile of the training step "
                   "(scripts/lm_mesh_slice.py's)")
    return "; ".join(out) or None


# -- the LM over a (data, model) mesh: Granite-3-2B, tp training, serve8 ------
MESH_ARCH, MESH_SHAPE = "granite-3-2b", (2, 2)
MESH_DRILL = dict(n_layers=2, batch=8, seq=64, steps=3, crash_at=2,
                  ckpt_every=2)
MESH_DRILL_REL = 1e-4      # float32, the card's atomics in the embedding
MESH_LEAVES = ("embed/tokens", "blocks/attn/wq", "blocks/attn/wk",
               "blocks/mlp/w_down", "blocks/norm1", "head/w")


def lm_mesh_slice_phase(card: str, dev, devs, cfg=None,
                        shape=MESH_SHAPE, batch: int = MESH_BATCH,
                        seq: int = MESH_SEQ, accum: int = MESH_ACCUM,
                        timed: int = MESH_TIMED, prompt: int = MESH_PROMPT,
                        new: int = MESH_NEW, drill=MESH_DRILL,
                        profile: bool = True, profile_train: bool = True,
                        layers: int = 0):
    """The dense LM over a (data, model) mesh of ``devs`` (cycled to the
    mesh's size): the tp training step (`launch.steps.plan`, float32
    masters stored by BASE_RULES, bf16 compute copies gathered once a
    step) against the unsplit step from the same initial state, then the
    cp preset's step (context parallelism: each model shard's block of
    the sequence, K3 at its queries over the keys up to its block's end)
    from that state against both; serve8 serving (TP-placed bf16 weights,
    the int8 cache's slots over "model") against the unsplit int8 run fed
    the same tokens, and a cp prefill against the unsplit and tp ones;
    `ef_allreduce` over "data" on one layer's gradients; the elastic
    restart drill at two layers in float32. Returns (report, K3 launches
    of the mesh runs)."""
    import dataclasses
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed import spmd
    from repro_torch.distributed.fault import FaultInjector, HostFailure
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.train import batch_on
    from repro_torch.models import decoding, transformer
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import adamw
    cfg = cfg or get_arch(MESH_ARCH)
    depth = cfg.n_layers
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cuda = dev.type == "cuda"
    mesh, mesh_devs = mesh_on(devs, shape)
    n = mesh.size
    lay = spmd.Layout(cfg, mesh)
    report = {"card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "n_heads": cfg.n_heads,
              "n_kv_heads": cfg.n_kv_heads, "mesh": dict(mesh.shape),
              "devices": [str(d) for d in mesh_devs],
              "distinct_cards": len(set(mesh_devs)),
              "split_heads": lay.split_heads, "split_ff": lay.split_ff,
              "reduced": phase_cuts(timed, MESH_TIMED, new, MESH_NEW,
                                    profile_train, layers, depth)}
    t0 = time.perf_counter()
    timing = {}
    shape_t = ShapeConfig("train", seq, batch, "train", grad_accum=accum)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch)
    tokens_per_step = batch * seq
    mesh_k3 = 0

    # -- training: the unsplit step, then the tp step from the same state --
    free_card(dev)
    state = train_lib.build_state(cfg, dev)
    report["params"] = sum(a.numel() for a in tree_leaves(state[0]))
    state, u = train_run(dev, steps.make_train_step(cfg, shape_t), state,
                         lambda i: batch_on(pipe.batch_at(i), {}, dev),
                         1 + timed, MESH_LEAVES)
    train = {"batch": batch, "seq": seq, "grad_accum": accum,
             "remat": cfg.remat, "unsplit": {
                 "loss_step0": u["losses"][0],
                 "ms_per_step": u["ms_per_step"], "step_ms": u["step_ms"],
                 "peak_gib": peak_gib(dev),
                 "tokens_per_s": tokens_per_step / u["ms_per_step"] * 1e3}}
    del state
    free_card(dev)
    timing["unsplit_train"] = time.perf_counter() - t0

    fn = steps.plan(cfg, shape_t, mesh, steps.resolve_rules("tp"))[0]
    state = train_lib.build_state(cfg, dev, mesh=mesh)
    state_bytes = M.nbytes_per_position(state)
    train["peak_gib_state"] = peak_gib(dev)
    # forward and remat's recompute, every layer, position, micro-batch
    per_step = 2 * accum * cfg.n_layers * n
    state, tp = train_run(dev, fn, state, pipe.batch_at, 1 + timed,
                          MESH_LEAVES)
    mesh_k3 += sum(tp["k3_per_step"])
    train["sharded"] = {
        "preset": "tp", "ms_per_step": tp["ms_per_step"],
        "step_ms": tp["step_ms"], "losses": tp["losses"],
        "grad_norms": tp["grad_norms"], "peak_gib": peak_gib(dev),
        "k3_launches_per_step": tp["k3_per_step"],
        "k3_launches_expected": per_step,
        "state_bytes_per_position": state_bytes,
        "tokens_per_s": tokens_per_step / tp["ms_per_step"] * 1e3}
    train["sharded_over_unsplit"] = tp["ms_per_step"] / u["ms_per_step"]
    bars = dict.fromkeys(MESH_LEAVES, MESH_GRAD_REL)
    train["checks"] = held_train("mesh tp step", tp, u, bars,
                                 MESH_LOSS_ATOL, per_step, cuda)
    if cuda and profile and profile_train:
        b = pipe.batch_at(1 + timed)
        before = k3_launches()
        train["step_device_profile"] = device_profile(
            lambda: fn(*state, b), spans=(*ops.SPANS, adamw.SPAN))
        mesh_k3 += k3_launches() - before
    del state, fn
    free_card(dev)
    timing["sharded_train"] = time.perf_counter() - t0

    # -- the cp preset's step from the same state: against the unsplit
    # step and the tp step, at their bars
    fn = steps.plan(cfg, shape_t, mesh, steps.resolve_rules("cp"))[0]
    state = train_lib.build_state(cfg, dev, mesh=mesh)
    state, cp_run = train_run(dev, fn, state, pipe.batch_at, 1 + timed,
                              MESH_LEAVES)
    mesh_k3 += sum(cp_run["k3_per_step"])
    cp = {"preset": "cp", "ms_per_step": cp_run["ms_per_step"],
          "step_ms": cp_run["step_ms"], "losses": cp_run["losses"],
          "peak_gib": peak_gib(dev),
          "k3_launches_per_step": cp_run["k3_per_step"],
          "k3_launches_expected": per_step,
          "k3_shapes": [[seq // lay.m, (r + 1) * seq // lay.m]
                        for r in range(lay.m)],
          "tokens_per_s": tokens_per_step / cp_run["ms_per_step"] * 1e3,
          "cp_over_tp": cp_run["ms_per_step"] / tp["ms_per_step"],
          "checks": {
              "vs_unsplit": held_train("mesh cp step against the unsplit "
                                       "step", cp_run, u, bars,
                                       MESH_LOSS_ATOL, per_step, cuda),
              "vs_tp": held_train("mesh cp step against the tp step",
                                  cp_run, tp, bars, MESH_LOSS_ATOL,
                                  per_step, cuda)}}
    train["cp"] = cp
    report["train"] = train
    del state, fn, u, tp, cp_run
    free_card(dev)
    timing["cp_train"] = time.perf_counter() - t0

    # -- serving: serve8 over the mesh against the unsplit int8 run ---------
    serve = {"batch": batch, "prompt": prompt, "new_tokens": new,
             "preset": "serve8"}
    gen = torch.Generator(device=dev).manual_seed(1)
    params = transformer.build_param_table(cfg).init(
        gen, device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev, dtype=torch.int32)
    max_len = prompt + new
    _, pre_ms_u = timed_ms(dev, lambda: decoding.prefill(
        cfg, params, {"tokens": toks}, max_len=max_len))
    want, feed, dec_u, ucache = serve8_unsplit(dev, cfg, params, toks, new)
    if cuda and profile:
        serve["unsplit_decode_device_profile"] = device_profile(
            lambda: decoding.decode_step(cfg, params, ucache, feed[-1],
                                         max_len - 1))
    del ucache
    # the bar's yardstick: the unsplit path in float32 at the same prompts
    # and fed tokens, as the CPU test holds it
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    ref32 = serve8_unsplit(dev, c32, p32, toks, new, feed)[0]
    del p32
    free_card(dev)
    own, own_agree = max_gap(want, ref32), greedy_agree(want, ref32)
    del ref32
    serve["unsplit"] = {"prefill_warm_ms": pre_ms_u,
                        "decode_ms_per_step": sum(dec_u[1:])
                        / max(len(dec_u) - 1, 1)}
    dshape = ShapeConfig("decode", max_len, batch, "decode")
    dfn, _s, dins, _o, _d = steps.plan(cfg, dshape, mesh,
                                       steps.resolve_rules("serve8"))
    P = M.place_tree(params, dins[0])
    serve["param_bytes_per_position"] = M.nbytes_per_position(P)
    run = serve8_mesh(dev, cfg, mesh, dfn, P, toks, feed)
    mesh_k3 += run["prefill_k3"] + sum(run["step_k3"])
    serve["cache_bytes_per_position"] = run["cache_bytes_per_position"]
    serve["sharded"] = {"prefill_warm_ms": run["prefill_ms"],
                        "decode_ms_per_step": sum(run["step_ms"][1:])
                        / max(len(run["step_ms"]) - 1, 1),
                        "k3_launches_prefill": run["prefill_k3"],
                        "k3_launches_expected": cfg.n_layers * n,
                        "peak_gib": peak_gib(dev)}
    if cuda and profile:
        # the last step again (its slot rewritten with the same token)
        serve["sharded"]["decode_device_profile"] = device_profile(
            lambda: dfn(P, run["cache"], feed[-1], max_len - 1))
    got, tplaced = run["got"], run["tokens"]
    serve["checks"] = serve8_checks("serve8 over the mesh", got, want, own,
                                    own_agree)
    bar = serve["checks"]["bar"]
    # a cp prefill (each model shard its block of the prompt) against the
    # unsplit prefill and the tp one, at the same bar
    del P, run
    free_card(dev)
    pshape = ShapeConfig("prefill", prompt, batch, "prefill")
    cfn, _s, cins, _o, _d = steps.plan(cfg, pshape, mesh,
                                       steps.resolve_rules("cp"))
    P = M.place_tree(params, cins[0])
    cfn(P, {"tokens": tplaced})                              # warm
    before = k3_launches()
    (lg, _c), cp_ms = timed_ms(dev, lambda: cfn(P, {"tokens": tplaced}))
    cp_k3 = k3_launches() - before
    mesh_k3 += cp_k3
    cp_last = lg.gather(dev).float()
    cp_gap = float((cp_last - want[0]).abs().max())
    serve["cp_prefill"] = {
        "prefill_warm_ms": cp_ms, "peak_gib": peak_gib(dev),
        "k3_launches_prefill": cp_k3,
        "k3_launches_expected": cfg.n_layers * n,
        "logits_max_abs_gap_vs_unsplit": cp_gap,
        "logits_max_abs_gap_vs_tp": float((cp_last - got[0]).abs().max()),
        "bar": bar}
    check(cp_gap <= bar and finite(cp_last),
          f"cp prefill over the mesh against the unsplit prefill: "
          f"{cp_gap}, bar {bar}")
    check(not cuda or cp_k3 == cfg.n_layers * n,
          f"cp prefill: {cp_k3} K3 launches, not {cfg.n_layers * n}")
    report["serve"] = serve
    del params, P, _c, lg, got, want
    free_card(dev)
    timing["serve"] = time.perf_counter() - t0

    # -- ef_allreduce over "data": one layer's gradients at full width ------
    table = transformer.build_param_table(cfg)
    layer_paths = [("blocks/attn/" + k) for k in ("wq", "wk", "wv", "wo")] \
        + [("blocks/mlp/" + k) for k in ("w_gate", "w_up", "w_down")]
    g, res, want_avg = {}, {}, {}
    for path in layer_paths:
        shp = table.defs[path][0][1:]
        pieces = [torch.randn(shp, device=d, generator=None) * 1e-3
                  for d in mesh_devs]
        pl = M.Placement(mesh, M.P())
        g[path] = M.ShardedTensor(pl, shp, pieces, ("data",))
    (avg, res), ef_ms = timed_ms(dev, lambda: comp.ef_allreduce(
        g, None, "data"))
    worst = 0.0
    for path in layer_paths:
        for grp in M._groups(mesh, ("data",)):
            qs = [comp.quantize(g[path].pieces[j].float()) for j in grp]
            tot = sum(q.to(torch.int32) for q, _ in qs)
            s_mean = sum(s for _, s in qs) / len(grp)
            ref_avg = tot.float() * s_mean / len(grp)
            for j in grp:
                worst = max(worst, float((avg[path].pieces[j] - ref_avg)
                                         .abs().max()))
    report["ef_allreduce"] = {
        "axis": "data", "leaves": layer_paths,
        "elements": sum(int(torch.Size(table.defs[p][0][1:]).numel())
                        for p in layer_paths), "ms": ef_ms,
        "max_abs_vs_formula": worst}
    check(worst == 0.0, f"ef_allreduce over data: {worst} from the "
          f"reference's formula")
    del g, avg, res
    free_card(dev)
    timing["ef"] = time.perf_counter() - t0

    # -- the elastic restart: (2, 2) onto (4, 1) and one device -------------
    c2 = dataclasses.replace(cfg, n_layers=drill["n_layers"],
                             dtype="float32")
    dshape = ShapeConfig("drill", drill["seq"], drill["batch"], "train")
    kw = dict(ckpt_every=drill["ckpt_every"], log_every=0, device=dev)
    rest = {**drill}
    with tempfile.TemporaryDirectory() as tmp:
        ref = train_lib.train(c2, dshape, drill["steps"], None, mesh=mesh,
                              **kw)
        refl = [x.gather(dev) if M.is_placed(x) else x
                for x in tree_leaves((ref["params"], ref["opt"]))]
        del ref
        try:
            train_lib.train(c2, dshape, drill["steps"], tmp + "/a",
                            injector=FaultInjector(
                                crash_at=[drill["crash_at"]]),
                            restarts_left=0, mesh=mesh, **kw)
            crashed = False
        except HostFailure:
            crashed = True
        check(crashed, "mesh restart drill: the injected crash did not "
              "happen")
        for shp in ((4, 1), (1, 1)):
            m2, _ = mesh_on(mesh_devs, shp)
            d = f"{tmp}/m{shp[0]}x{shp[1]}"
            shutil.copytree(tmp + "/a", d)
            t = time.perf_counter()
            out = train_lib.train(c2, dshape, drill["steps"], d, mesh=m2,
                                  **kw)
            leaves = [x.gather(dev) if M.is_placed(x) else x
                      for x in tree_leaves((out["params"], out["opt"]))]
            worst = max(float((a.float() - b.float()).norm()
                              / b.float().norm().clamp_min(1e-30))
                        for a, b in zip(leaves, refl))
            rest[f"onto_{shp[0]}x{shp[1]}"] = {
                "final_step": out["final_step"], "mesh": out["mesh"],
                "losses": out["losses"], "max_leaf_rel_l2": worst,
                "s": time.perf_counter() - t}
            check(out["final_step"] == drill["steps"]
                  and worst <= MESH_DRILL_REL,
                  f"mesh restart onto {shp}: step {out['final_step']}, "
                  f"{worst} from the uninterrupted (2, 2) run")
            del out, leaves
    rest["bar"] = MESH_DRILL_REL
    report["restart_drill"] = rest
    del refl
    free_card(dev)
    timing["restart"] = time.perf_counter() - t0
    report["timing_s"] = timing
    report["wall_s"] = time.perf_counter() - t0
    report["launches"] = {"flash_attention": mesh_k3}
    return report, mesh_k3


# -- the MoE family over a (data, model) mesh: Moonlight-16B-A3B ------------
# serving at full width and depth on (1, 4) (4 of its 16 heads and 16 of
# its 64 experts a shard, each stored once), training at full width and 3
# of its 48 layers on (2, 2) (float32 masters and two moments, ~9 GB a
# layer with the gradients, do not fit 48 layers on one card)
MOE_MESH_SERVE, MOE_MESH_TRAIN = (1, 4), (2, 2)
MOE_MESH_TRAIN_LAYERS = 3
# the float32 step: masters, moments, compute copies and gradients all
# float32 do not fit 3 layers on (2, 2) (run out of memory on an H100)
MOE_MESH_F32_LAYERS = 2
MOE_MESH_TIMED = 1         # timed training steps after the first
# the checked first moments: the weights every token reaches, and the
# experts' (each sums only the tokens routed to it and kept)
MOE_MESH_LEAVES = ("embed/tokens", "blocks/attn/wq", "blocks/attn/wk",
                   "blocks/moe/router", "blocks/norm2", "head/w",
                   "blocks/moe/w_gate", "blocks/moe/w_down")


def place_consuming(tree: dict, placements):
    """`meshes.place` of every leaf of ``tree`` by ``placements``, each
    leaf taken out of ``tree`` once it is placed, so the card holds the
    whole weights once and one leaf twice (its pieces beside it)."""
    from repro_torch.distributed import meshes as M
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = (place_consuming(v, placements[k]) if isinstance(v, dict)
                  else M.place(v, placements[k]))
        del v
    return out


def position_rows(mesh, batch: int, seq: int, accum: int = 1) -> list:
    """Each mesh position's rows [lo, hi) of a (batch, seq) batch placed
    by rows, within a micro-batch of ``accum`` (a position's rows j::accum
    are micro-batch j's)."""
    from repro_torch.distributed import meshes as M
    spec = M.data_sharding(mesh, batch, 2).spec
    return [tuple(r // accum for r in M.block_of(mesh, spec, (batch, seq),
                                                  c)[0])
            for c in M.positions(mesh)]


def global_routes(lay, calls, rows) -> list:
    """A mesh's recorded `moe.place` calls (``lay.n`` positions a layer
    call) as the whole batch's (experts, kept) of each layer call: the
    model shard 0 positions' rows in the batch's order (``rows``, of
    `position_rows`). Checks that every position routes as the first of
    its group over "model" (the routing is replicated)."""
    import torch
    n = lay.n
    check(len(calls) % n == 0, f"{len(calls)} recorded routings, not a "
          f"multiple of the mesh's {n} positions")
    out = []
    for c in range(len(calls) // n):
        per = calls[c * n:(c + 1) * n]
        check(all(torch.equal(per[i][0], per[lay.group[i][0]][0])
                  and torch.equal(per[i][1], per[lay.group[i][0]][1])
                  for i in range(n)),
              "the model shards of a data position routed otherwise")
        blocks = {}
        for i in range(n):
            if lay.r(i) == 0:
                blocks.setdefault(rows[i], per[i])
        out.append((torch.cat([blocks[b][0] for b in sorted(blocks)]),
                    torch.cat([blocks[b][1] for b in sorted(blocks)])))
    return out


def as_sets(routes) -> list:
    """Recorded routings with each token's experts in ascending order and
    its kept flags beside them: the token's (expert, kept) pairs as a set
    (the order of its k choices follows their probabilities, which a
    near-tie between two chosen experts may swap)."""
    out = []
    for idx, keep in routes:
        idx, order = idx.sort(-1)
        out.append((idx, keep.gather(-1, order)))
    return out


def routing_differs(a, b) -> list:
    """Per layer call, the share of tokens whose experts (as a set) or
    kept flags differ between the whole-batch routings ``a`` and ``b``."""
    out = []
    for (ia, ka), (ib, kb) in zip(as_sets(a), as_sets(b)):
        d = (ia != ib).any(-1) | (ka != kb).any(-1)
        out.append(float(d.float().mean()))
    return out


def per_layer(shares, n_layers: int, remat: bool) -> list:
    """Layer-call shares of a training step as each layer's mean: a
    micro-batch calls the layers forward, then, under remat, again in
    reverse order as the backward recomputes them."""
    span = 2 * n_layers if remat else n_layers
    sums, counts = [0.0] * n_layers, [0] * n_layers
    for c, s in enumerate(shares):
        c %= span
        li = c if c < n_layers else span - 1 - c
        sums[li] += s
        counts[li] += 1
    return [s / max(k, 1) for s, k in zip(sums, counts)]


def lm_mesh_moe_slice_phase(card: str, dev, devs, cfg=None,
                            serve_shape=MOE_MESH_SERVE,
                            train_shape=MOE_MESH_TRAIN,
                            train_layers: int = MOE_MESH_TRAIN_LAYERS,
                            f32_layers: int = MOE_MESH_F32_LAYERS,
                            batch: int = MESH_BATCH, seq: int = MESH_SEQ,
                            accum: int = MESH_ACCUM,
                            timed: int = MOE_MESH_TIMED,
                            prompt: int = MESH_PROMPT, new: int = MESH_NEW,
                            profile: bool = True,
                            profile_train: bool = True,
                            serve_layers: int = 0):
    """The mixture-of-experts family over meshes of ``devs`` (cycled to
    the mesh's size): serve8 serving (`launch.steps.plan`: TP-placed bf16
    weights, the experts split over "model", the int8 cache's slots over
    "model") of ``batch`` prompts of ``prompt`` tokens and ``new`` greedy
    steps on ``serve_shape``, against the unsplit one-card int8 run of the
    same weights fed the same tokens, at twice the unsplit run's own
    bf16-vs-float32 gap (its float32 run computes in float32 over the same
    bf16 weights); the tp training step on ``train_shape`` against the
    unsplit step from the same state: in float32 compute at
    ``f32_layers`` layers within 1e-5, every layer's experts and kept
    flags bit-equal (so a wrong capacity or place fails), and in bf16 at
    ``train_layers`` layers each first moment within twice the unsplit
    step's own bf16-vs-float32 gap of that leaf. Returns (report, K3
    launches of the mesh runs)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.train import batch_on
    from repro_torch.models import decoding, moe, transformer
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw
    full = cfg or get_arch(MOE_ARCH)
    # serving's depth; training takes its own (`train_layers`)
    cfg = (dataclasses.replace(full, n_layers=serve_layers)
           if serve_layers else full)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    timing = {}
    mesh_k3 = 0

    # -- serving: serve8 on the serving mesh against the unsplit run -------
    mesh, mesh_devs = mesh_on(devs, serve_shape)
    n = mesh.size
    lay = spmd.Layout(cfg, mesh)
    report = {"card": card, "arch": cfg.name, "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
              "experts": cfg.n_experts, "top_k": cfg.top_k,
              "capacity_factor": cfg.capacity_factor,
              "devices": [str(d) for d in mesh_devs],
              "distinct_cards": len(set(mesh_devs))}
    serve = {"mesh": dict(mesh.shape), "n_layers": cfg.n_layers,
             "batch": batch, "prompt": prompt, "new_tokens": new,
             "preset": "serve8", "split_heads": lay.split_heads,
             "split_experts": lay.split_experts,
             "experts_per_shard": lay.experts(0)[1] - lay.experts(0)[0],
             "capacity": {"prefill": moe.capacity(cfg, batch * prompt),
                          "decode_step": moe.capacity(cfg, batch)}}
    free_card(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    params = transformer.build_param_table(cfg).init(
        gen, device=dev, dtype=torch.bfloat16)
    serve["params"] = sum(t.numel() for t in tree_leaves(params))
    serve["reduced"] = phase_cuts(timed, timed, new, MESH_NEW, True,
                                  serve_layers, full.n_layers)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev, dtype=torch.int32)
    max_len = prompt + new
    L = cfg.n_layers
    with torch.no_grad():
        decoding.prefill(cfg, params, {"tokens": toks},
                         max_len=max_len)                      # warm
        before = k3_launches()
        _, pre_ms_u = timed_ms(dev, lambda: decoding.prefill(
            cfg, params, {"tokens": toks}, max_len=max_len))
        unsplit_k3 = k3_launches() - before
        # the prefill's L calls of the layer, then L a decode step
        with recorded_routes() as seen:
            want, feed, dec_u, _c = serve8_unsplit(dev, cfg, params, toks,
                                                   new)
        del _c
        routes_u = [(i.cpu(), k.cpu()) for i, k in seen[:L]]
        drop_dec_u = dropped_share(seen[L:2 * L])
        del seen
        serve["unsplit"] = {
            "prefill_warm_ms": pre_ms_u,
            "prefill_tokens_per_s": batch * prompt / pre_ms_u * 1e3,
            "decode_ms_per_step": sum(dec_u[1:]) / max(len(dec_u) - 1, 1),
            "k3_launches_prefill": unsplit_k3,
            "dropped_share_prefill": dropped_share(routes_u),
            "dropped_share_decode_step": drop_dec_u,
            "peak_gib": peak_gib(dev)}
        serve["unsplit"]["decode_tokens_per_s"] = (
            batch / serve["unsplit"]["decode_ms_per_step"] * 1e3)
        # the bar: the unsplit run's own gap to float32 compute over the
        # same bf16 weights (each product casts its weight: a float32 copy
        # of 28 B parameters does not fit the card), fed the same tokens
        c32 = dataclasses.replace(cfg, dtype="float32")
        ref32 = serve8_unsplit(dev, c32, params, toks, new, feed)[0]
        own, own_agree = max_gap(want, ref32), greedy_agree(want, ref32)
        serve["unsplit"]["peak_gib_float32_run"] = peak_gib(dev)
        del ref32
    timing["unsplit_serve"] = time.perf_counter() - t0

    # the same weights placed on the mesh, leaf by leaf
    dshape = ShapeConfig("decode", max_len, batch, "decode")
    dfn, _s, dins, _o, _d = steps.plan(cfg, dshape, mesh,
                                       steps.resolve_rules("serve8"))
    free_card(dev)
    P = place_consuming(params, dins[0])
    del params
    gc.collect()
    serve["param_bytes_per_position"] = M.nbytes_per_position(P)
    serve["peak_gib_after_placing"] = peak_gib(dev)
    timing["place"] = time.perf_counter() - t0
    run = serve8_mesh(dev, cfg, mesh, dfn, P, toks, feed, routes=True)
    mesh_k3 += run["prefill_k3"] + sum(run["step_k3"])
    routes_m = global_routes(lay, run.pop("prefill_routes"),
                             position_rows(mesh, batch, prompt))
    differs = routing_differs(routes_u, routes_m)
    dec_ms = run["step_ms"]
    serve["cache_bytes_per_position"] = run["cache_bytes_per_position"]
    serve["sharded"] = {
        "prefill_warm_ms": run["prefill_ms"],
        "prefill_tokens_per_s": batch * prompt / run["prefill_ms"] * 1e3,
        "decode_ms_per_step": sum(dec_ms[1:]) / max(len(dec_ms) - 1, 1),
        "k3_launches_prefill": run["prefill_k3"],
        "k3_launches_expected": cfg.n_layers * n,
        "k3_launches_decode_step": max(run["step_k3"]),
        "dropped_share_prefill": dropped_share(routes_m),
        "dropped_share_decode_step": dropped_share(run.pop("step_routes")),
        "routing_differs_share_prefill": sum(differs) / len(differs),
        "routing_differs_share_prefill_per_layer": differs,
        "peak_gib": peak_gib(dev)}
    serve["sharded"]["decode_tokens_per_s"] = (
        batch / serve["sharded"]["decode_ms_per_step"] * 1e3)
    serve["sharded_over_unsplit"] = {
        "prefill": run["prefill_ms"] / pre_ms_u,
        "decode": (serve["sharded"]["decode_ms_per_step"]
                   / serve["unsplit"]["decode_ms_per_step"])}
    del routes_u, routes_m
    if cuda and profile:
        # the last step again (its slot rewritten with the same token)
        serve["sharded"]["decode_device_profile"] = device_profile(
            lambda: dfn(P, run["cache"], feed[-1], max_len - 1),
            spans=moe.SPANS)
    serve["checks"] = serve8_checks("moe serve8 over the mesh", run["got"],
                                    want, own, own_agree)
    check(not cuda or (run["prefill_k3"] == cfg.n_layers * n
                       and unsplit_k3 == cfg.n_layers
                       and max(run["step_k3"]) == 0),
          f"moe serving: {run['prefill_k3']} K3 launches in the mesh "
          f"prefill (not {cfg.n_layers * n}), {unsplit_k3} unsplit, "
          f"{run['step_k3']} a decode step")
    report["serve"] = serve
    del P, run, want
    free_card(dev)
    timing["serve"] = time.perf_counter() - t0

    # -- training: the tp step at reduced depth against the unsplit step,
    # in bf16 and in float32 compute, each from the same state ------------
    ct = dataclasses.replace(cfg, n_layers=train_layers)
    c32 = dataclasses.replace(ct, dtype="float32")
    cf = dataclasses.replace(c32, n_layers=f32_layers)
    mesh, _ = mesh_on(devs, train_shape)
    n = mesh.size
    lay = spmd.Layout(ct, mesh)
    rows = position_rows(mesh, batch, seq, accum)
    shape_t = ShapeConfig("train", seq, batch, "train", grad_accum=accum)
    pipe = TokenPipeline(ct.vocab_size, seq, batch)
    tokens_per_step = batch * seq

    def per_step(c):
        """K3 launches a step: forward (and remat's recompute), every
        layer, position and micro-batch."""
        return (2 if c.remat else 1) * accum * c.n_layers * n
    train = {"mesh": dict(mesh.shape), "n_layers": ct.n_layers,
             "n_layers_float32_check": cf.n_layers,
             "reduced": "; ".join(filter(None, (
                 f"n_layers {full.n_layers} -> {ct.n_layers} (bf16 and its "
                 f"float32 yardstick), {cf.n_layers} (the float32 check)",
                 phase_cuts(timed, MOE_MESH_TIMED, new, new,
                            profile_train)))),
             "batch": batch, "seq": seq, "grad_accum": accum,
             "remat": ct.remat,
             "capacity_per_micro_batch": moe.capacity(
                 ct, batch // accum * seq)}
    runs = {}
    for label, c, on_mesh in (("unsplit", ct, False),
                              ("unsplit_float32", c32, False),
                              ("tp", ct, True),
                              ("unsplit_float32_check", cf, False),
                              ("tp_float32_check", cf, True)):
        if on_mesh:
            fn = steps.plan(c, shape_t, mesh, steps.resolve_rules("tp"))[0]
            state = train_lib.build_state(c, dev, mesh=mesh)
            bytes_per_position = M.nbytes_per_position(state)
            state, r = train_run(dev, fn, state, pipe.batch_at, 1 + timed,
                                 MOE_MESH_LEAVES, routes=True)
            r["routes0"] = global_routes(lay, r["routes0"], rows)
            r["state_bytes_per_position"] = bytes_per_position
            mesh_k3 += sum(r["k3_per_step"])
        else:
            fn = steps.make_train_step(c, shape_t)
            state = train_lib.build_state(c, dev)
            r = {"params": sum(t.numel() for t in tree_leaves(state[0]))}
            state, run = train_run(dev, fn, state,
                                   lambda i: batch_on(pipe.batch_at(i), {},
                                                      dev),
                                   1 + timed, MOE_MESH_LEAVES, routes=True)
            r.update(run)
        r["peak_gib"] = peak_gib(dev)
        if cuda and profile and profile_train and label == "tp":
            b = pipe.batch_at(1 + timed)
            before = k3_launches()
            r["step_device_profile"] = device_profile(
                lambda: fn(*state, b),
                spans=(*moe.SPANS, *ops.SPANS, adamw.SPAN))
            mesh_k3 += k3_launches() - before
        runs[label] = r
        del state, fn
        free_card(dev)
        timing["train_" + label] = time.perf_counter() - t0
    for label, r in runs.items():
        train[label] = {
            k: r[k] for k in ("params", "losses", "grad_norms", "metrics0",
                              "ms_per_step", "step_ms", "first_step_ms",
                              "k3_per_step", "peak_gib",
                              "state_bytes_per_position",
                              "step_device_profile") if k in r}
        train[label]["tokens_per_s"] = (tokens_per_step / r["ms_per_step"]
                                        * 1e3)
        train[label]["dropped_share_step0"] = dropped_share(r["routes0"])
    u, u32, tp, uf, tpf = (runs[k] for k in (
        "unsplit", "unsplit_float32", "tp", "unsplit_float32_check",
        "tp_float32_check"))
    train["sharded_over_unsplit"] = tp["ms_per_step"] / u["ms_per_step"]
    # float32: 1e-5, and the same experts and kept flags everywhere
    f32 = held_train("moe mesh tp step in float32", tpf, uf,
                     dict.fromkeys(MOE_MESH_LEAVES, MESH_F32_REL),
                     MESH_F32_REL * abs(uf["losses"][0]), per_step(cf),
                     cuda)
    got, want = as_sets(tpf["routes0"]), as_sets(uf["routes0"])
    same = len(got) == len(want) and all(
        torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(got, want))
    f32["experts_and_kept_bit_equal"] = same
    f32["layer_calls"] = len(tpf["routes0"])
    f32["choice_order_differs_tokens"] = sum(
        int((a != c).any(-1).sum())
        for (a, _), (c, _) in zip(tpf["routes0"], uf["routes0"]))
    f32["dropped_share_step0"] = [dropped_share(tpf["routes0"]),
                                  dropped_share(uf["routes0"])]
    f32["routing_differs_share_per_layer"] = per_layer(
        routing_differs(uf["routes0"], tpf["routes0"]), cf.n_layers,
        cf.remat)
    check(same, "moe mesh tp step in float32: a token's experts or kept "
          "flags differ from the unsplit step's")
    check(f32["dropped_share_step0"][1] > 0, "moe mesh training: capacity "
          "dropped nothing at this batch (the check needs drops)")
    # bf16: each leaf within twice its own bf16-vs-float32 gap
    own = rel_l2_each(u["m0"], u32["m0"])
    bf16 = held_train("moe mesh tp step", tp, u,
                      {p: 2 * own[p] for p in MOE_MESH_LEAVES},
                      MESH_LOSS_ATOL, per_step(ct), cuda)
    bf16["first_moment_bar_rule"] = ("2 x the unsplit step's own bf16-vs-"
                                     "float32 first-moment gap, per leaf")
    bf16["unsplit_bf16_vs_float32_first_moment_rel_l2"] = own
    bf16["within_dense_bar"] = {
        p: v <= MESH_GRAD_REL
        for p, v in bf16["first_moment_rel_l2_layer0"].items()}
    bf16["dense_bar"] = MESH_GRAD_REL
    bf16["routing_differs_share_per_layer"] = per_layer(
        routing_differs(u["routes0"], tp["routes0"]), ct.n_layers,
        ct.remat)
    bf16["unsplit_bf16_vs_float32_routing_differs_share_per_layer"] = (
        per_layer(routing_differs(u32["routes0"], u["routes0"]),
                  ct.n_layers, ct.remat))
    train["checks"] = {"float32": f32, "bf16": bf16}
    report["train"] = train
    del runs, u, u32, tp, uf, tpf
    free_card(dev)
    report["timing_s"] = timing
    report["wall_s"] = time.perf_counter() - t0
    report["launches"] = {"flash_attention": mesh_k3}
    return report, mesh_k3


# -- the hybrid and VLM families over a (data, model) mesh ------------------
# Hymba-1.5B at full width and depth: on (2, 2) its 25 heads split on no
# m = 2 (every shard computes every attention and SSM head, the ff
# columns split); on (1, 5), the one mesh on which they split, 5 query
# heads, one KV head and 5 SSM heads a shard. Qwen2-VL-7B serve8 on
# (1, 4): 7 query heads and one KV head a shard (G = 7), 256 stub vision
# embeds and M-RoPE positions, the int8 cache
FAM_MESH_HYMBA, FAM_MESH_VLM = LM_ARCH, "qwen2-vl-7b"
FAM_MESH_SHAPE, FAM_MESH_SPLIT, FAM_MESH_VLM_SHAPE = (2, 2), (1, 5), (1, 4)
FAM_MESH_TIMED = 1         # timed training steps after the first
# the float32 checks' depth, training and serving: a global layer and
# three SWA layers. Hymba's bf16 runs at all 32 are timed, the step held
# at twice its own bf16-vs-float32 gap (~1.3 relative L2) and the
# serving gaps reported only: at 32 random layers bf16 is chaotic (the
# unsplit run's own logits gap, 5.8, exceeds the logits)
FAM_MESH_F32_LAYERS = 4
# their bar, relative (first moments and the SSM state by L2, logits of
# their largest value): at full width every gradient product sums 4,096
# tokens a micro-batch in another order on the mesh (per-position
# partials, the replicas' gradients summed), as two float32
# implementations do; the repository's bar for those (the port against
# the reference, tests/test_torch_lm_train.py) and not the CPU tests'
# 1e-5 at 64 tokens (1.0e-5-2.6e-5 read at 4 layers on an H100)
FAM_MESH_F32_REL = 1e-4
FAM_MESH_SPLIT_NEW = 8     # decode steps on (1, 5)
FAM_MESH_LEAVES = ("embed/tokens", "blocks/attn/wq", "blocks/attn/wk",
                   "blocks/ssm/in_proj", "blocks/ssm/gate_proj",
                   "blocks/ssm/dt_proj", "blocks/ssm/out_proj",
                   "blocks/mlp/w_down", "blocks/norm1", "head/w")


def k3_per_pass(cfg, S: int) -> int:
    """K3 launches a forward of S decoder positions makes at each mesh
    position: one a decoder layer, and for Whisper one an encoder layer
    and one a cross-attention where S <= Se (more queries than keys run
    plain); none for RWKV-6. The same under cp (a block of queries is one
    call)."""
    if cfg.attn_free:
        return 0
    return cfg.n_layers + (cfg.enc_layers + cfg.n_layers * (S <= cfg.enc_len)
                           if cfg.enc_dec else 0)


def served_on_mesh(label: str, dev, cfg, params, mesh, toks, extra,
                   new: int, held: bool, preset: str = "serve8",
                   warm: int = 0, yard=None) -> dict:
    """``preset`` serving (serve8) of ``params`` (bf16, one card) over
    ``mesh`` against the unsplit run fed the same tokens: the one run
    here, or ``yard`` (`family_run`'s "_yardstick" of the same weights
    and prompts, whose tokens are fed) in its place. With ``held``, the
    logits are held at twice the unsplit run's own gap to its float32 run
    (the bf16 weights cast per product); else the gap is reported only (a
    family whose bf16 gap is no yardstick holds its mesh in
    `float32_served_on_mesh`). ``warm``: the warm-up prefill's length
    (`serve8_mesh`). ``params`` are placed leaf by leaf and consumed.
    Returns the reading, with "_run" (`serve8_mesh`'s) and "_params" (the
    placed weights) for a caller that goes on with them."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed import spmd
    from repro_torch.launch import steps
    from repro_torch.models import decoding
    from repro_torch.models.layers import tree_leaves
    cuda = dev.type == "cuda"
    B, prompt = toks.shape
    max_len = prompt + new
    n, L = mesh.size, cfg.n_layers
    lay = spmd.Layout(cfg, mesh)
    hybrid = cfg.family == "hybrid"
    per = k3_per_pass(cfg, prompt)
    out = {"mesh": dict(mesh.shape), "n_layers": L, "batch": B,
           "prompt": prompt, "new_tokens": new, "preset": preset,
           "cache": ("int8" if decoding.has_int8_cache(cfg) else
                     "bf16 (no int8 form)" if hybrid else
                     "float32 state, bf16 token shifts (no int8 form)"),
           "split_heads": lay.split_heads,
           "heads_per_shard": lay.heads(0)[1] - lay.heads(0)[0],
           "kv_heads_per_shard": lay.kv_heads(0)[1] - lay.kv_heads(0)[0],
           "split_ff": lay.split_ff,
           "params": sum(t.numel() for t in tree_leaves(params))}
    batch = {"tokens": toks, **extra}
    with torch.no_grad():
        if yard is not None:
            # the families slice's run of these weights and prompts
            want = [yard["last"]] + yard["logits"][:new]
            feed, pre_ms_u = yard["fed"][:new], yard["prefill_warm_ms"]
            out["unsplit_decode_device_profile"] = \
                yard["decode_step_device_profile"]
            out["unsplit"] = {
                "prefill_warm_ms": pre_ms_u,
                "prefill_tokens_per_s": B * prompt / pre_ms_u * 1e3,
                "decode_ms_per_step": yard["decode_ms_per_step"],
                "from": "families_slice (the same weights, prompts and "
                "fed tokens)"}
            unsplit_k = [per, 0]
        else:
            decoding.prefill(cfg, params, batch, max_len=max_len)  # warm
            before, before4 = k3_launches(), k4_launches()
            _, pre_ms_u = timed_ms(dev, lambda: decoding.prefill(
                cfg, params, batch, max_len=max_len))
            unsplit_k = [k3_launches() - before, k4_launches() - before4]
            want, feed, dec_u, ucache = serve8_unsplit(
                dev, cfg, params, toks, new, extra=extra)
            if cuda:
                out["unsplit_decode_device_profile"] = device_profile(
                    lambda: decoding.decode_step(cfg, params, ucache,
                                                 feed[-1], max_len - 1))
            del ucache
            out["unsplit"] = {
                "prefill_warm_ms": pre_ms_u,
                "prefill_tokens_per_s": B * prompt / pre_ms_u * 1e3,
                "decode_ms_per_step": (sum(dec_u[1:])
                                       / max(len(dec_u) - 1, 1)),
                "k3_launches_prefill": unsplit_k[0],
                "k4_launches_prefill": unsplit_k[1],
                "peak_gib": peak_gib(dev)}
        if held:
            # the bar's yardstick: the unsplit path in float32 at the
            # same prompts and fed tokens
            c32 = dataclasses.replace(cfg, dtype="float32")
            ref32 = serve8_unsplit(dev, c32, params, toks, new, feed,
                                   extra=extra)[0]
            out["unsplit"]["peak_gib_float32_run"] = peak_gib(dev)
            own, own_agree = max_gap(want, ref32), greedy_agree(want, ref32)
            del ref32
    free_card(dev)
    dshape = ShapeConfig("decode", max_len, B, "decode")
    dfn, _s, dins, _o, _d = steps.plan(cfg, dshape, mesh,
                                       steps.resolve_rules(preset))
    P = place_consuming(params, dins[0])
    del params
    gc.collect()
    out["param_bytes_per_position"] = M.nbytes_per_position(P)
    out["peak_gib_after_placing"] = peak_gib(dev)
    run = serve8_mesh(dev, cfg, mesh, dfn, P, toks, feed, extra=extra,
                      warm=warm)
    if warm:
        out["warm_prefill_prompt"] = warm
    dec = run["step_ms"]
    out["cache_bytes_per_position"] = run["cache_bytes_per_position"]
    out["sharded"] = {
        "prefill_warm_ms": run["prefill_ms"],
        "prefill_tokens_per_s": B * prompt / run["prefill_ms"] * 1e3,
        "decode_ms_per_step": sum(dec[1:]) / max(len(dec) - 1, 1),
        "k3_launches_prefill": run["prefill_k3"],
        "k4_launches_prefill": run["prefill_k4"],
        "k3_launches_expected": per * n,
        "k4_launches_expected": L * n if hybrid else 0,
        "k3_launches_decode_step": max(run["step_k3"]),
        "peak_gib": peak_gib(dev)}
    out["sharded"]["decode_tokens_per_s"] = (
        B / out["sharded"]["decode_ms_per_step"] * 1e3)
    out["sharded_over_unsplit"] = {
        "prefill": run["prefill_ms"] / pre_ms_u,
        "decode": (out["sharded"]["decode_ms_per_step"]
                   / out["unsplit"]["decode_ms_per_step"])}
    if cuda:
        # the last step again (its slot rewritten with the same token)
        out["sharded"]["decode_device_profile"] = device_profile(
            lambda: dfn(P, run["cache"], feed[-1], max_len - 1))
    if held:
        out["checks"] = serve8_checks(f"{label} over the mesh", run["got"],
                                      want, own, own_agree)
    else:
        check(all(map(finite, run["got"])),
              f"{label} over the mesh: non-finite logits")
        out["checks"] = {
            "held": False, "logits_max_abs_gap": max_gap(run["got"], want),
            "prefill_gap": float((run["got"][0] - want[0]).abs().max()),
            "logits_max_abs": max(float(w.abs().max()) for w in want),
            "greedy_agree_share": greedy_agree(run["got"], want)}
    check(not cuda or (run["prefill_k3"] == per * n
                       and run["prefill_k4"] == (L * n if hybrid else 0)
                       and unsplit_k == [per, L if hybrid else 0]
                       and max(run["step_k3"]) == 0),
          f"{label}: {run['prefill_k3']} K3 and {run['prefill_k4']} K4 "
          f"launches in the mesh prefill (not {per * n} and "
          f"{L * n if hybrid else 0}), {unsplit_k} unsplit, "
          f"{run['step_k3']} K3 a decode step")
    out["_params"], out["_want"], out["_run"] = P, want, run
    return out


def cache_gaps(got, want) -> dict:
    """A placed cache ``got`` against the unsplit ``want``: each k, v
    (the hybrid family's per layer), Whisper's xk and xv and RWKV-6's
    token shifts by relative L2, and for bf16 ones the share of elements
    more than one bf16 rounding (2^-7 relative) apart; positions equal;
    the recurrent state (Hymba's "ssm", RWKV-6's "state") by the relative
    L2 of each position's piece against the same block of ``want``'s."""
    import torch
    out = {"kv_rel_l2": 0.0, "kv_bf16_share_over_one_rounding": 0.0,
           "pos_equal": True}
    leaves = []
    for g, w in zip(got.get("layers", []), want.get("layers", [])):
        leaves += [(name, g[name], b) for name, b in w.items()]
    leaves += [(name, got[name], b) for name, b in want.items()
               if name != "layers"]
    for name, x, b in leaves:
        if name in ("ssm", "state"):
            key = f"{name}_rel_l2"
            for piece, blk in zip(x.pieces, x.blocks()):
                ref = b[tuple(slice(lo, hi) for lo, hi in blk)]
                out[key] = max(out.get(key, 0.0), rel_l2_each(
                    {0: piece.to(ref.device)}, {0: ref})[0])
            continue
        a = x.gather(b.device)
        if name == "pos":
            out["pos_equal"] &= bool(torch.equal(a, b))
            continue
        af, bf = a.float(), b.float()
        out["kv_rel_l2"] = max(out["kv_rel_l2"],
                               rel_l2_each({0: af}, {0: bf})[0])
        if b.dtype == torch.bfloat16:
            out["kv_bf16_share_over_one_rounding"] = max(
                out["kv_bf16_share_over_one_rounding"],
                float(((af - bf).abs() > bf.abs() * 2 ** -7).float()
                      .mean()))
    return out


def float32_served_on_mesh(label: str, dev, cfg, mesh, toks, new: int,
                           cp_too: bool, gen, extra=None,
                           preset: str = "serve8") -> tuple:
    """A family in float32 compute at FAM_MESH_F32_LAYERS layers (both
    of Whisper's stacks), fresh weights from ``gen``, over ``mesh``
    against the unsplit float32 run of the prompts ``toks`` and the
    family's ``extra`` inputs: `plan`'s ``preset`` prefill (the logits)
    and the cache `spmd.prefill` writes; ``new`` decode steps of `plan`'s
    ``preset`` step from the unsplit prefill's cache in float32 slots,
    fed the unsplit run's greedy tokens, and the cache after them; with
    ``cp_too``, `plan`'s cp prefill. Each logits within FAM_MESH_F32_REL of its largest value in
    the unsplit run; the prefill's bf16 k and v within one bf16 rounding
    (2^-8) by relative L2 (each layer's, and Whisper's xk and xv, RWKV's
    token shifts; per element, an entry that cancels to near zero moves
    by more than its own rounding when the layers' float32 sums run in
    another order), the float32 ones after the decode steps and the
    recurrent state per head block within FAM_MESH_F32_REL (relative
    L2), positions equal. A bf16 control, the unsplit run of the same
    weights in bf16 compute fed the same tokens, reads against the same
    bar and must exceed it. Returns (the readings, [K3, K4] launches of
    the mesh runs)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed import spmd
    from repro_torch.launch import steps
    from repro_torch.models import decoding, transformer
    from repro_torch.models.layers import tree_map
    cuda = dev.type == "cuda"
    cf = dataclasses.replace(cfg, dtype="float32",
                             n_layers=FAM_MESH_F32_LAYERS)
    if cf.enc_dec:
        cf = dataclasses.replace(cf, enc_layers=FAM_MESH_F32_LAYERS)
    extra = extra or {}
    B, prompt = toks.shape
    max_len = prompt + new
    n, L = mesh.size, cf.n_layers
    lay = spmd.Layout(cf, mesh)
    params = transformer.build_param_table(cf).init(gen, device=dev,
                                                    dtype=torch.float32)
    batch = {"tokens": toks, **extra}

    def slots32(c):
        """A copy of the cache ``c``, its floating leaves in float32."""
        return tree_map(lambda t: t.to(torch.float32, copy=True)
                        if t.is_floating_point() else t.clone(), c)
    k = [0, 0]

    def counted(fn):
        before, before4 = k3_launches(), k4_launches()
        r = fn()
        k[0] += k3_launches() - before
        k[1] += k4_launches() - before4
        return r
    with torch.no_grad():
        last, c0 = decoding.prefill(cf, params, batch, max_len=max_len)
        cache = slots32(c0)
        want, feed = [last.float()], []
        for t in range(new):
            feed.append(want[-1].argmax(-1, keepdim=True).int())
            lg, cache = decoding.decode_step(cf, params, cache, feed[-1],
                                             prompt + t)
            want.append(lg[:, 0].float())
        end = cache
        bars = [FAM_MESH_F32_REL * float(w.abs().max()) for w in want]
        cb = dataclasses.replace(cf, dtype="bfloat16")
        ctrl = serve8_unsplit(dev, cb, tree_map(torch.Tensor.bfloat16,
                                                params), toks, new, feed,
                              extra=extra)[0]

        def over(got):
            return [float((a - b).abs().max()) / bar
                    for a, b, bar in zip(got, want, bars)]
        rules = steps.resolve_rules(preset)
        pfn, _s, pins, _o, _d = steps.plan(
            cf, ShapeConfig("prefill", prompt, B, "prefill"), mesh, rules)
        P = M.place_tree(params, pins[0])
        lg, _c = counted(lambda: pfn(P, batch))
        pre = [lg.gather(dev).float()]
        placed = {k: M.place(v, M.data_sharding(mesh, B, v.dim()))
                  for k, v in batch.items()}
        _, mc = counted(lambda: spmd.prefill(cf, mesh, P, placed,
                                             max_len=max_len))
        after_prefill = cache_gaps(mc, c0)
        del _c, mc
        dfn, _s, dins, _o, _d = steps.plan(
            cf, ShapeConfig("decode", max_len, B, "decode"), mesh, rules)
        P = M.place_tree(params, dins[0])
        cache = M.place_tree(slots32(c0), dins[1])
        got = []
        for t in range(new):
            lg, cache = counted(lambda: dfn(P, cache, feed[t], prompt + t))
            got.append(lg.gather(dev)[:, 0].float())
        after_decode = cache_gaps(cache, end)
        gaps = over(pre + got)
        out = {"mesh": dict(mesh.shape), "n_layers": L, "dtype": "float32",
               "batch": B, "prompt": prompt, "new_tokens": new,
               "preset": preset, "split_heads": lay.split_heads,
               "bar_rule": "FAM_MESH_F32_REL x each logits' largest |value| "
               "in the unsplit float32 run", "rel": FAM_MESH_F32_REL,
               "logits_max_abs": max(float(w.abs().max()) for w in want),
               "prefill_over_bar": gaps[0],
               "decode_over_bar_max": max(gaps[1:]),
               "cache_after_prefill": after_prefill,
               "cache_after_decode": after_decode,
               "bf16_control_over_bar": max(over(ctrl)),
               "bf16_control_rule": "the unsplit run of the same weights "
               "in bf16 compute, fed the same tokens, against the float32 "
               "run: it must exceed the bar"}
        ok = [out["prefill_over_bar"], out["decode_over_bar_max"]]
        if cp_too:
            cfn, _s, cins, _o, _d = steps.plan(
                cf, ShapeConfig("prefill", prompt, B, "prefill"), mesh,
                steps.resolve_rules("cp"))
            P = M.place_tree(params, cins[0])
            lg, _c = counted(lambda: cfn(P, batch))
            out["cp_prefill_over_bar"] = over([lg.gather(dev).float()])[0]
            ok.append(out["cp_prefill_over_bar"])
            del _c
    passes = 2 + bool(cp_too)
    want_k = [passes * k3_per_pass(cf, prompt) * n,
              passes * L * n if cf.family == "hybrid" else 0]
    out["launches"] = {"flash_attention": k[0], "ssm_scan": k[1],
                       "expected": want_k}
    check(max(ok) <= 1 and all(map(finite, pre + got)),
          f"{label} in float32 over the mesh against the unsplit run: "
          f"{ok} of the bar")
    cg = [after_prefill, after_decode]
    check(after_prefill["kv_rel_l2"] <= 2 ** -8
          and after_decode["kv_rel_l2"] <= FAM_MESH_F32_REL
          and all(c["pos_equal"] and all(
              v <= FAM_MESH_F32_REL for key, v in c.items()
              if key in ("ssm_rel_l2", "state_rel_l2")) for c in cg),
          f"{label} in float32: the mesh cache against the unsplit one {cg}")
    check(out["bf16_control_over_bar"] > 1,
          f"{label}: the bf16 control reads {out['bf16_control_over_bar']} "
          f"of the float32 bar, which would not see it")
    check(not cuda or k == want_k,
          f"{label} in float32: {k} K3 and K4 launches over the mesh, not "
          f"{want_k} (every layer and position a prefill)")
    return out, k


def lm_mesh_families_slice_phase(card: str, dev, devs,
                                 profile_train: bool = True,
                                 bf16_train: bool = True,
                                 new: int = MESH_NEW, serve_layers: int = 0):
    """The hybrid and VLM families over meshes of ``devs`` (cycled to the
    mesh's size). Hymba-1.5B's tp training step on FAM_MESH_SHAPE and,
    in float32, on FAM_MESH_SPLIT, where the heads split
    (`mesh_train_compare`: the float32 checks at FAM_MESH_F32_LAYERS
    layers, the full-depth bf16 step held at twice the unsplit step's
    own bf16-vs-float32 gap). Serve8 (the hybrid cache in bf16) and a cp
    prefill on FAM_MESH_SHAPE, and prefill and FAM_MESH_SPLIT_NEW decode
    steps on FAM_MESH_SPLIT, timed at full depth with their gap to the
    unsplit run reported, and each held in float32 compute by
    `float32_served_on_mesh`. Qwen2-VL-7B serve8 on FAM_MESH_VLM_SHAPE
    with its vision embeds and M-RoPE positions, held at twice the
    unsplit run's own bf16-vs-float32 gap. A warm decode step of each
    serving run is profiled, and with ``profile_train`` the tp step too
    (its profiler's post-processing takes about a minute). Without
    ``bf16_train`` the full-depth bf16 steps (unsplit, its float32
    yardstick, tp) are left out and the train line's "reduced" says so;
    ``new`` decode steps on FAM_MESH_SHAPE and FAM_MESH_VLM_SHAPE, and
    with ``serve_layers`` the serving runs at that many layers (each
    serving line's "reduced"). Returns
    (report, {"flash_attention": K3 launches, "ssm_scan": K4 launches}
    of the mesh runs)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed import spmd
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    batch = MESH_BATCH
    prompt = MESH_PROMPT
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    timing = {}
    k3 = k4 = 0
    report = {"card": card, "devices": [str(d) for d in devs],
              "distinct_cards": len(set(devs))}

    # -- Hymba: the tp step on FAM_MESH_SHAPE against the unsplit step,
    # from the same state (`mesh_train_compare`): in bf16 at full depth,
    # each first moment within twice the unsplit step's own
    # bf16-vs-float32 gap of that leaf; in float32 compute at
    # FAM_MESH_F32_LAYERS layers within FAM_MESH_F32_REL, on
    # FAM_MESH_SHAPE and on FAM_MESH_SPLIT -----------------------------------
    cfg = get_arch(FAM_MESH_HYMBA)
    mesh, _ = mesh_on(devs, FAM_MESH_SHAPE)
    mesh5, _ = mesh_on(devs, FAM_MESH_SPLIT)
    lay = spmd.Layout(cfg, mesh)
    train, kt = mesh_train_compare(
        "hymba mesh", dev, cfg, {"tp": mesh, "tp_split": mesh5}, MESH_SEQ,
        FAM_MESH_LEAVES, bf16=bf16_train,
        bf16_held=True, profile=profile_train)
    if not bf16_train:
        train["reduced"] += (": scripts/lm_mesh_slice.py families runs it "
                             "at full depth")
    k3, k4 = k3 + kt["flash_attention"], k4 + kt["ssm_scan"]
    report["hymba_train"] = train
    timing["hymba_train"] = time.perf_counter() - t0
    free_card(dev)

    # -- Hymba serve8 on FAM_MESH_SHAPE, then a cp prefill, timed in bf16
    # at full depth (``serve_layers``); then both held in float32 compute
    full = cfg.n_layers
    if serve_layers:
        cfg = dataclasses.replace(cfg, n_layers=serve_layers)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = transformer.build_param_table(cfg).init(
        gen, device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev, dtype=torch.int32)
    serve = served_on_mesh("hymba serve8", dev, cfg, params, mesh, toks, {},
                           new, held=False)
    del params
    run = serve.pop("_run")
    k3 += run["prefill_k3"] + sum(run["step_k3"])
    k4 += run["prefill_k4"]
    serve["reduced"] = phase_cuts(1, 1, new, MESH_NEW, True, serve_layers,
                                  full)
    P, want = serve.pop("_params"), serve.pop("_want")
    del run
    free_card(dev)
    timing["hymba_serve"] = time.perf_counter() - t0
    # a cp prefill: each model shard its block of the prompt for
    # attention, every SSM head over the whole prompt
    pshape = ShapeConfig("prefill", prompt, batch, "prefill")
    cfn, _s, cins, _o, _d = steps.plan(cfg, pshape, mesh,
                                       steps.resolve_rules("cp"))
    P = M.place_tree(P, cins[0])
    placed = {"tokens": M.place(toks, M.data_sharding(mesh, batch, 2))}
    cfn(P, placed)                                               # warm
    before, before4 = k3_launches(), k4_launches()
    (lg, _c), cp_ms = timed_ms(dev, lambda: cfn(P, placed))
    cp_k = [k3_launches() - before, k4_launches() - before4]
    k3 += cp_k[0]
    k4 += cp_k[1]
    cp_last = lg.gather(dev).float()
    serve["cp_prefill"] = {
        "prefill_warm_ms": cp_ms, "peak_gib": peak_gib(dev),
        "k3_launches_prefill": cp_k[0], "k4_launches_prefill": cp_k[1],
        "k3_launches_expected": cfg.n_layers * mesh.size,
        "k3_shapes": [[prompt // lay.m, (r + 1) * prompt // lay.m]
                      for r in range(lay.m)],
        "logits_max_abs_gap_vs_unsplit": float(
            (cp_last - want[0]).abs().max())}
    check(finite(cp_last), "hymba cp prefill over the mesh: non-finite "
          "logits")
    check(not cuda or cp_k == [cfg.n_layers * mesh.size] * 2,
          f"hymba cp prefill: {cp_k} K3 and K4 launches, not "
          f"{cfg.n_layers * mesh.size} each")
    del P, want, lg, _c, cp_last
    free_card(dev)
    timing["hymba_cp_prefill"] = time.perf_counter() - t0
    serve["float32"], kf = float32_served_on_mesh(
        "hymba serve8 and cp prefill", dev, cfg, mesh, toks, new, True, gen)
    k3, k4 = k3 + kf[0], k4 + kf[1]
    report["hymba_serve"] = serve
    del toks
    free_card(dev)
    timing["hymba_serve_float32"] = time.perf_counter() - t0

    # -- Hymba on FAM_MESH_SPLIT: every attention and SSM head split ------
    params = transformer.build_param_table(cfg).init(
        gen, device=dev, dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev, dtype=torch.int32)
    split = served_on_mesh("hymba serve8 (heads split)", dev, cfg, params,
                           mesh5, toks, {}, FAM_MESH_SPLIT_NEW, held=False)
    del params
    run = split.pop("_run")
    k3 += run["prefill_k3"] + sum(run["step_k3"])
    k4 += run["prefill_k4"]
    split.pop("_params")
    split.pop("_want")
    split["reduced"] = phase_cuts(1, 1, FAM_MESH_SPLIT_NEW, MESH_NEW, True,
                                  serve_layers, full)
    check(not cuda or split["split_heads"],
          f"hymba on {FAM_MESH_SPLIT}: the heads do not split")
    del run
    free_card(dev)
    timing["hymba_split_serve"] = time.perf_counter() - t0
    split["float32"], kf = float32_served_on_mesh(
        "hymba serve8 (heads split)", dev, cfg, mesh5, toks,
        FAM_MESH_SPLIT_NEW, False, gen)
    k3, k4 = k3 + kf[0], k4 + kf[1]
    report["hymba_split_heads_serve"] = split
    del toks
    free_card(dev)
    timing["hymba_split_serve_float32"] = time.perf_counter() - t0

    # -- Qwen2-VL-7B serve8 on FAM_MESH_VLM_SHAPE ---------------------------
    cfg = get_arch(FAM_MESH_VLM)
    full = cfg.n_layers
    if serve_layers:
        cfg = dataclasses.replace(cfg, n_layers=serve_layers)
    meshv, _ = mesh_on(devs, FAM_MESH_VLM_SHAPE)
    params = transformer.build_param_table(cfg).init(
        gen, device=dev, dtype=torch.bfloat16)
    toks, extra = family_inputs(cfg, gen, dev, batch, prompt)
    # the yardstick computes in float32 over the bf16 weights (each
    # product casts its weight): a float32 copy would hold 30 GB more
    vl = served_on_mesh("qwen2-vl serve8", dev, cfg, params, meshv, toks,
                        extra, new, held=True)
    del params
    run = vl.pop("_run")
    k3 += run["prefill_k3"] + sum(run["step_k3"])
    vl.pop("_params")
    vl.pop("_want")
    vl["reduced"] = phase_cuts(1, 1, new, MESH_NEW, True, serve_layers,
                               full)
    vl["n_vision_tokens"] = cfg.n_vision_tokens
    vl["mrope_sections"] = list(cfg.mrope_sections)
    report["vlm_serve"] = vl
    del run, toks, extra
    free_card(dev)
    timing["vlm_serve"] = time.perf_counter() - t0
    report["timing_s"] = timing
    report["wall_s"] = time.perf_counter() - t0
    report["launches"] = {"flash_attention": k3, "ssm_scan": k4}
    return report, {"flash_attention": k3, "ssm_scan": k4}


# -- Whisper large-v3 and RWKV-6 3B over a (data, model) mesh ----------------
# Whisper serve8 on (1, 4): the families slice's 8 prompts of 224 tokens
# over 1500 stub frames (5 query and 5 KV heads and 375 cross-cache
# frames a shard), WR_WHISPER_NEW decode steps on the int8 self cache; a
# cp prefill on (2, 2), the encoder's 750-query blocks over its 1500
# keys. Its tp step on (2, 2): 8 x 224 decoder tokens over 8 x 1500
# frames, two micro-batches, remat, full depth. RWKV-6 3B tp serving on
# (1, 4): the families slice's 8 prompts of 1024 tokens, 10 heads a
# shard, WR_RWKV_NEW decode steps fed the families slice's greedy tokens
# (its run is the unsplit yardstick: the same weights and prompts); its
# tp step on (2, 2) at WR_RWKV_TRAIN_LAYERS of 32 layers (the float32
# state, moments and the recurrence's saved states of 3.1 B parameters
# do not fit beside the rest at full depth) over WR_RWKV_TRAIN_SEQ
# tokens a row (the autograd loop over time issues ~30k launches a layer
# and position at 1024, 31 s a mesh step at 4 layers). The checks run at
# FAM_MESH_F32_LAYERS and cover every leaf; RWKV-6's in float64 compute:
# its float32 step at random weights is ill-conditioned (u_bonus starts
# at zero, so the token at t = 0 reaches the group norm with no variance,
# whose gradient there is 1/sqrt(eps) = 316 times the incoming one; that
# leaf carries 99.9% of the grad norm), and on an H100 the unsplit float32
# step regrouped (grad_accum 1 for 2, the same function) moves u_bonus's
# moment by 1.3e-3 and the median leaf by 1.0e-4, the bar
# (`scripts/rwkv_mesh_rounding.py`). In float64
# (`layers.wide`: the norms, the recurrence and the loss head in float64
# too) a split fault keeps its size while the rounding falls to the
# float32 moments' own (6.3e-8 read)
WR_WHISPER, WR_RWKV = "whisper-large-v3", "rwkv6-3b"
WR_SERVE_SHAPE, WR_TRAIN_SHAPE = (1, 4), (2, 2)
WR_WHISPER_PROMPT, WR_WHISPER_NEW = 224, 16
WR_RWKV_NEW = 8
# RWKV's warm-up prefill: 16 tokens (its 1024-token prefill over the
# mesh is a step loop of ~400k launches, ~6 s; no kernel is built)
WR_RWKV_WARM = 16
WR_TRAIN_SEQ = 224
WR_RWKV_TRAIN_LAYERS, WR_RWKV_TRAIN_SEQ = 4, 128
WR_RWKV_CHECK_DTYPE = "float64"


def k4_per_pass(cfg) -> int:
    """K4 launches a forward makes at each mesh position: one a hybrid
    layer (its SSM heads), none for the other families."""
    return cfg.n_layers if cfg.family == "hybrid" else 0


def mesh_train_compare(label: str, dev, cfg, meshes: dict, seq: int,
                       leaves=None, layers: int = 0, bf16: bool = True, bf16_held: bool = False,
                       profile: bool = False, check_dtype: str = "float32"):
    """The tp training step (`launch.steps.plan`, float32 masters, the
    compute copies in ``cfg``'s type) of ``cfg`` (cut to ``layers``
    layers of each stack where given) on each mesh of ``meshes`` ({name:
    mesh}, the first the bf16 one) against the unsplit step from the same
    state and `TokenPipeline` batches of MESH_BATCH x ``seq`` (Whisper's
    frames beside them), MESH_ACCUM micro-batches. First moments are
    compared with the clip scale divided out (`train_run`'s
    ``unclipped``), for ``leaves`` (every leaf where None).

    - ``check_dtype`` compute (float32, or float64 where the float32
      step's own rounding exceeds the bar) at FAM_MESH_F32_LAYERS, on
      every mesh: the loss, the grad norm and each first moment within
      FAM_MESH_F32_REL. The leaf that carries the grad norm's gap is
      reported (each leaf's share of the squared norm's change).
    - The unsplit bf16 step at that depth, a control, read against the
      same bar, must exceed it.
    - With ``bf16``: 1 + FAM_MESH_TIMED steps unsplit and on the first mesh in
      ``cfg``'s type, timed; their gap reported or, with ``bf16_held``,
      held within twice the unsplit step's own bf16-vs-float32 gap (the
      loss's and each leaf's first moment's), which takes one more
      unsplit step in float32 at that depth. With ``profile`` (on the
      card) a warm step of that mesh run is profiled.

    K3 and K4 launches a step counted and held. Returns (report,
    {"flash_attention": K3, "ssm_scan": K4 launches of the mesh runs})."""
    import dataclasses
    import math
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed import meshes as M
    from repro_torch.distributed import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.train import batch_on
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw
    cuda = dev.type == "cuda"

    def cut(c, n):
        over = {"n_layers": n}
        if c.enc_dec:
            over["enc_layers"] = n
        return dataclasses.replace(c, **over)
    full = cfg.n_layers
    layers = layers if layers and layers < full else 0
    if layers:
        cfg = cut(cfg, layers)
    batch, accum, timed = MESH_BATCH, MESH_ACCUM, FAM_MESH_TIMED
    shape_t = ShapeConfig("train", seq, batch, "train", grad_accum=accum)
    extra = {k: v for k, v in steps.input_specs(cfg, shape_t).items()
             if k not in ("tokens", "labels")}
    pipe = TokenPipeline(cfg.vocab_size, seq, batch)
    cf = dataclasses.replace(cut(cfg, FAM_MESH_F32_LAYERS),
                             dtype=check_dtype)
    cb = dataclasses.replace(cf, dtype="bfloat16")
    held = f"{check_dtype}_check"
    main = next(iter(meshes))
    reduced = [f"n_layers {full} -> {cfg.n_layers}"] if layers else []
    if cf.n_layers < cfg.n_layers:
        reduced.append(f"n_layers {cfg.n_layers} -> {cf.n_layers} in the "
                       f"{check_dtype} checks")
    if not bf16:
        reduced.append("no bf16 step at the run's depth (unsplit, tp)")
    out = {"meshes": {}, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "batch": batch, "seq": seq, "grad_accum": accum,
           "remat": cfg.remat, "check_dtype": check_dtype,
           "n_layers_check": cf.n_layers,
           "reduced": "; ".join(reduced) or None}
    for name, mesh in meshes.items():
        lay = spmd.Layout(cfg, mesh)
        out["meshes"][name] = {
            "shape": dict(mesh.shape), "split_heads": lay.split_heads,
            "heads_per_shard": lay.heads(0)[1] - lay.heads(0)[0],
            "split_ff": lay.split_ff}
    if cfg.enc_dec:
        out["enc_frames"] = cfg.enc_len

    def per_step(c, n):
        """K3 launches a step (forward and remat's recompute) and K4's
        (those and its reverse-time backward), every layer, position and
        micro-batch."""
        r = bool(c.remat)
        return ((1 + r) * accum * k3_per_pass(c, seq) * n,
                (2 + r) * accum * k4_per_pass(c) * n)
    plan_runs = []
    if bf16:
        plan_runs.append(("unsplit", cfg, None, 1 + timed))
        if bf16_held:
            plan_runs.append(("unsplit_float32",
                              dataclasses.replace(cfg, dtype="float32"),
                              None, 1))
        plan_runs.append((main, cfg, meshes[main], 1 + timed))
    plan_runs.append((f"unsplit_{held}", cf, None, 1))
    plan_runs += [(f"{name}_{held}", cf, mesh, 1)
                  for name, mesh in meshes.items()]
    if not (bf16 and cb == cfg):  # else the unsplit bf16 run is the control
        plan_runs.append(("unsplit_bf16_control", cb, None, 1))
    runs, k3, k4 = {}, 0, 0
    for name, c, on, n_steps in plan_runs:
        free_card(dev)
        if on is not None:
            fn = steps.plan(c, shape_t, on, steps.resolve_rules("tp"))[0]
            state = train_lib.build_state(c, dev, mesh=on)
            r = {"state_bytes_per_position": M.nbytes_per_position(state)}
            state, run = train_run(dev, fn, state,
                                   lambda i: pipe.batch_at(i, extra),
                                   n_steps, leaves, unclipped=True)
            k3 += sum(run["k3_per_step"])
            k4 += sum(run["k4_per_step"])
            want = per_step(c, on.size)
            check(not cuda or all(e == want[1] for e in run["k4_per_step"]),
                  f"{label} {name} step: {run['k4_per_step']} K4 launches "
                  f"a step, not {want[1]}")
            if cuda and profile and name == main:
                b = pipe.batch_at(n_steps, extra)
                before, before4 = k3_launches(), k4_launches()
                t = time.perf_counter()
                r["step_device_profile"] = device_profile(
                    lambda: fn(*state, b), spans=(*ops.SPANS, adamw.SPAN))
                r["step_device_profile"]["s"] = time.perf_counter() - t
                k3 += k3_launches() - before
                k4 += k4_launches() - before4
        else:
            fn = steps.make_train_step(c, shape_t)
            state = train_lib.build_state(c, dev)
            r = {"params": sum(a.numel() for a in tree_leaves(state[0]))}
            state, run = train_run(
                dev, fn, state,
                lambda i: batch_on(pipe.batch_at(i, extra), extra, dev),
                n_steps, leaves, unclipped=True)
        r.update(run)
        r["peak_gib"] = peak_gib(dev)
        runs[name] = r
        del state, fn
    free_card(dev)
    for name, r in runs.items():
        out[name] = {k: r[k] for k in (
            "params", "losses", "grad_norms", "ms_per_step", "step_ms",
            "first_step_ms", "k3_per_step", "k4_per_step", "peak_gib",
            "state_bytes_per_position", "step_device_profile") if k in r}
        if r["ms_per_step"]:
            out[name]["tokens_per_s"] = batch * seq / r["ms_per_step"] * 1e3
    uf = runs[f"unsplit_{held}"]
    total = sum(uf["sq0"].values())
    checked = {}
    for name, mesh in meshes.items():
        r = runs[f"{name}_{held}"]
        checked[name] = held_train(
            f"{label} {name} step in {check_dtype}", r, uf,
            dict.fromkeys(uf["m0"], FAM_MESH_F32_REL),
            FAM_MESH_F32_REL * abs(uf["losses"][0]),
            per_step(cf, mesh.size)[0], cuda, FAM_MESH_F32_REL)
        share = {p: (r["sq0"][p] - uf["sq0"][p]) / (2 * total)
                 for p in uf["sq0"]}
        top = sorted(share, key=lambda p: -abs(share[p]))[:3]
        checked[name]["grad_norm_gap_by_leaf"] = {p: share[p] for p in top}
        checked[name]["grad_norm_share_by_leaf"] = {
            p: uf["sq0"][p] / total for p in top}
    ctl = runs.get("unsplit_bf16_control", runs.get("unsplit"))
    control = rel_l2_each(ctl["m0"], uf["m0"])
    over_bar = max(control.values()) / FAM_MESH_F32_REL
    check(over_bar > 1, f"{label}: the bf16 control reads {over_bar} of "
          f"the {check_dtype} bar")
    checks = {check_dtype: checked, "bf16_control_over_bar": over_bar,
              "bf16_control_rule": "the unsplit step in bf16 compute at the "
              f"same depth, state and batch, against the {check_dtype} one: "
              "its largest first-moment gap over the bar must exceed 1",
              "bf16": None}
    if bf16:
        u, tp = runs["unsplit"], runs[main]
        out["sharded_over_unsplit"] = tp["ms_per_step"] / u["ms_per_step"]
        check(all(map(math.isfinite, tp["losses"] + tp["grad_norms"])),
              f"{label} {main} step: a non-finite loss or grad norm")
        want = per_step(cfg, meshes[main].size)[0]
        check(not cuda or all(e == want for e in tp["k3_per_step"]),
              f"{label} {main} step: {tp['k3_per_step']} K3 launches a "
              f"step, not {want}")
        if bf16_held:
            u32 = runs["unsplit_float32"]
            own = rel_l2_each(u["m0"], u32["m0"])
            own_loss = abs(u["losses"][0] - u32["losses"][0])
            checks["bf16"] = held_train(
                f"{label} {main} step", tp, u,
                {p: 2 * own[p] for p in own}, 2 * own_loss, want, cuda)
            checks["bf16"]["bar_rule"] = (
                "2 x the unsplit step's own bf16-vs-float32 gap: the "
                "loss's and each leaf's first moment's")
            checks["bf16"]["unsplit_bf16_vs_float32_first_moment_rel_l2"] \
                = own
        else:
            checks["bf16"] = {
                "held": False, "loss_gap_step0": abs(
                    tp["losses"][0] - u["losses"][0]),
                "first_moment_rel_l2_layer0": rel_l2_each(tp["m0"],
                                                          u["m0"])}
    out["checks"] = checks
    out["launches_expected_per_step"] = {
        name: dict(zip(("flash_attention", "ssm_scan"),
                       per_step(c, on.size)))
        for name, c, on, _n in plan_runs if on is not None}
    return out, {"flash_attention": k3, "ssm_scan": k4}


def lm_mesh_whisper_rwkv_slice_phase(card: str, dev, devs, yardsticks=None,
                                     rwkv_train_seq: int = WR_RWKV_TRAIN_SEQ,
                                     archs=None, batch: int = MESH_BATCH):
    """Whisper large-v3 and RWKV-6 3B over meshes of ``devs`` (cycled to
    each mesh's size), at full width: Whisper serve8 on WR_SERVE_SHAPE
    and a cp prefill on WR_TRAIN_SHAPE (full depth, timed, the gap to the
    unsplit run reported; held in float32 compute at FAM_MESH_F32_LAYERS
    by `float32_served_on_mesh`, a bf16 control beside it), its tp step
    on WR_TRAIN_SHAPE at full depth (`mesh_train_compare`); RWKV-6's tp
    serving on WR_SERVE_SHAPE at full depth against ``yardsticks``'s
    run of the same weights and prompts (`family_run`'s; run here when
    absent) and held in float32 alike, its tp step at
    WR_RWKV_TRAIN_LAYERS layers over ``rwkv_train_seq`` tokens a row,
    held in WR_RWKV_CHECK_DTYPE compute. A warm decode step of each
    serving run is profiled. ``archs`` maps a name to its config (default
    the published ones). Returns (report, {"flash_attention": K3 launches of
    the mesh runs})."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import meshes as M
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map
    archs = archs or ARCHS
    yardsticks = yardsticks or {}
    t0 = time.perf_counter()
    timing, k3 = {}, 0
    report = {"card": card, "devices": [str(d) for d in devs],
              "distinct_cards": len(set(devs))}
    mesh_s, _ = mesh_on(devs, WR_SERVE_SHAPE)
    mesh_t, _ = mesh_on(devs, WR_TRAIN_SHAPE)

    def weights(cfg, length):
        """The families slice's weights and inputs of ``cfg`` (`family_run`
        draws them from a generator seeded with 0 in this order)."""
        gen = torch.Generator(device=dev).manual_seed(0)
        params = transformer.build_param_table(cfg).init(
            gen, device=dev, dtype=torch.bfloat16)
        return (gen, params) + family_inputs(cfg, gen, dev, batch, length)

    # -- Whisper serve8 on WR_SERVE_SHAPE, then a cp prefill on
    # WR_TRAIN_SHAPE; both held in float32 compute --------------------------
    cfg = archs[WR_WHISPER]
    prompt, new = WR_WHISPER_PROMPT, WR_WHISPER_NEW
    gen, params, tokens, extra = weights(cfg, prompt + LM_STEPS)
    toks = tokens[:, :prompt]
    serve = served_on_mesh("whisper serve8", dev, cfg, params, mesh_s, toks,
                           extra, new, held=False)
    del params
    run = serve.pop("_run")
    k3 += run["prefill_k3"] + sum(run["step_k3"])
    serve["reduced"] = None
    serve["enc_frames"] = cfg.enc_len
    serve["cross_cache_frames_per_shard"] = run["cache"]["xk"].pieces[0] \
        .shape[2]
    P, want = serve.pop("_params"), serve.pop("_want")
    del run
    whole = tree_map(lambda x: x.gather(dev), P)
    del P
    free_card(dev)
    timing["whisper_serve"] = time.perf_counter() - t0
    pshape = ShapeConfig("prefill", prompt, batch, "prefill")
    cfn, _s, cins, _o, _d = steps.plan(cfg, pshape, mesh_t,
                                       steps.resolve_rules("cp"))
    P = place_consuming(whole, cins[0])
    del whole
    placed = {k: M.place(v, M.data_sharding(mesh_t, batch, v.dim()))
              for k, v in {"tokens": toks, **extra}.items()}
    cfn(P, placed)                                               # warm
    before = k3_launches()
    (lg, _c), cp_ms = timed_ms(dev, lambda: cfn(P, placed))
    cp_k = k3_launches() - before
    k3 += cp_k
    cp_last = lg.gather(dev).float()
    per = k3_per_pass(cfg, prompt) * mesh_t.size
    serve["cp_prefill"] = {
        "mesh": dict(mesh_t.shape), "prefill_warm_ms": cp_ms,
        "peak_gib": peak_gib(dev), "k3_launches_prefill": cp_k,
        "k3_launches_expected": per,
        "encoder_block_queries": cfg.enc_len // mesh_t.shape["model"],
        "logits_max_abs_gap_vs_unsplit": float(
            (cp_last - want[0]).abs().max())}
    check(finite(cp_last), "whisper cp prefill over the mesh: non-finite "
          "logits")
    check(dev.type != "cuda" or cp_k == per,
          f"whisper cp prefill: {cp_k} K3 launches, not {per}")
    del P, want, lg, _c, cp_last, placed
    free_card(dev)
    timing["whisper_cp_prefill"] = time.perf_counter() - t0
    serve["float32"], kf = float32_served_on_mesh(
        "whisper serve8", dev, cfg, mesh_s, toks, new, False, gen,
        extra=extra)
    serve["float32_cp"], kc = float32_served_on_mesh(
        "whisper serve8 and cp prefill", dev, cfg, mesh_t, toks, new, True,
        gen, extra=extra)
    k3 += kf[0] + kc[0]
    report["whisper_serve"] = serve
    del toks, tokens, extra
    free_card(dev)
    timing["whisper_serve_float32"] = time.perf_counter() - t0

    # -- Whisper's tp step on WR_TRAIN_SHAPE ---------------------------------
    train, kt = mesh_train_compare("whisper mesh", dev, cfg,
                                   {"tp": mesh_t}, WR_TRAIN_SEQ)
    k3 += kt["flash_attention"]
    report["whisper_train"] = train
    timing["whisper_train"] = time.perf_counter() - t0

    # -- RWKV-6 tp serving on WR_SERVE_SHAPE, against the families slice's
    # run of the same weights and prompts ----------------------------------
    cfg = archs[WR_RWKV]
    prompt = LM_PROMPT
    gen, params, tokens, extra = weights(cfg, LM_MAX_LEN)
    toks = tokens[:, :prompt]
    yard = yardsticks.get(WR_RWKV)
    rserve = served_on_mesh("rwkv tp serving", dev, cfg, params, mesh_s,
                            toks, extra, WR_RWKV_NEW, held=False,
                            preset="tp", warm=WR_RWKV_WARM,
                            yard=yard)
    del params
    run = rserve.pop("_run")
    rserve.pop("_params")
    rserve.pop("_want")
    rserve["reduced"] = f"new tokens {MESH_NEW} -> {WR_RWKV_NEW}"
    rserve["state_heads_per_shard"] = run["cache"]["state"].pieces[0] \
        .shape[2]
    del run
    free_card(dev)
    timing["rwkv_serve"] = time.perf_counter() - t0
    rserve["float32"], _k = float32_served_on_mesh(
        "rwkv tp serving", dev, cfg, mesh_s, toks, WR_RWKV_NEW, False, gen,
        preset="tp")
    report["rwkv_serve"] = rserve
    del toks, tokens, extra
    free_card(dev)
    timing["rwkv_serve_float32"] = time.perf_counter() - t0

    # -- RWKV-6's tp step on WR_TRAIN_SHAPE at WR_RWKV_TRAIN_LAYERS ---------
    rtrain, _k = mesh_train_compare("rwkv mesh", dev, cfg, {"tp": mesh_t},
                                    rwkv_train_seq,
                                    layers=WR_RWKV_TRAIN_LAYERS,
                                    check_dtype=WR_RWKV_CHECK_DTYPE)
    rtrain["reduced"] = "; ".join(
        x for x in (rtrain["reduced"], f"seq {MESH_SEQ} -> {rwkv_train_seq}")
        if x)
    report["rwkv_train"] = rtrain
    free_card(dev)
    timing["rwkv_train"] = time.perf_counter() - t0
    report["timing_s"] = timing
    report["wall_s"] = time.perf_counter() - t0
    report["launches"] = {"flash_attention": k3}
    return report, {"flash_attention": k3}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    FAILURES.clear()
    # the LM paths' counts (meta tensors, the host's CPU) run beside the
    # card's phases; the bridge slice reads them
    import atexit
    counting = BackgroundCount(counted_paths())
    atexit.register(counting.stop)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in float32 (models.layers.fdot)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
          f"{ {k: round(v, 1) for k, v in built.items()} }", flush=True)
    print("ptxas " + json.dumps(ptxas_report(build)), flush=True)
    print("sass " + json.dumps(sass_report(build)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    gnn_rows = gnn_mp_phase(gen)
    lut_rows = lut_eval_phase(gen)
    fa_rows = flash_attention_phase(gen)
    scan_rows = ssm_scan_phase(gen)
    norm_rows = rms_norm_phase(gen)
    print("kernel_shapes " + json.dumps({
        "card": card, "gnn_mp": gnn_rows, "lut_eval": lut_rows,
        "flash_attention": fa_rows, "ssm_scan": scan_rows,
        "rms_norm": norm_rows}), flush=True)
    print("rms_norm_families " + json.dumps(rms_norm_families_phase(
        card, torch.device("cuda"))), flush=True)
    report, launches, gaussian = slice_phase(card, torch.device("cuda"))
    print("slice " + json.dumps(report), flush=True)
    apps_report, apps_launches = apps_slice_phase(card, torch.device("cuda"),
                                                  gaussian)
    print("apps_slice " + json.dumps(apps_report), flush=True)
    train_report, train_launches, trained = train_slice_phase(
        card, torch.device("cuda"), gaussian)
    print("train_slice " + json.dumps(train_report), flush=True)
    search_report, search_launches = search_slice_phase(
        card, torch.device("cuda"), gaussian, trained)
    print("search_slice " + json.dumps(search_report), flush=True)
    pipe_report, pipe_launches, kept = pipeline_slice_phase(
        card, torch.device("cuda"), keep_store=True)
    print("pipeline_slice " + json.dumps(pipe_report), flush=True)
    import shutil
    try:
        split_report, split_launches = split_slice_phase(
            card, torch.device("cuda"), split_devices(), gaussian, trained,
            kept)
    finally:
        if kept is not None:
            shutil.rmtree(kept[1], ignore_errors=True)
    print("split_slice " + json.dumps(split_report), flush=True)
    del gaussian, trained
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    # the accelerator main path: the Gaussian slice, the apps slice, the
    # training slice, the search slice, the pipeline slice and the split
    # slice
    counted = (launches, apps_launches, train_launches, search_launches,
               pipe_launches, split_launches)
    routes = {r: sum(c["lut_eval_routes"][r] for c in counted)
              for r in launches["lut_eval_routes"]}
    launches = {k: sum(c[k] for c in counted)
                for k in ("gnn_mp", "lut_eval")}
    from repro_torch.configs import get_arch
    lm_report, lm_launches = lm_slice_phase(card, torch.device("cuda"),
                                            get_arch(LM_ARCH))
    print("lm_slice " + json.dumps(lm_report), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    moe_report, moe_launches = moe_slice_phase(card, torch.device("cuda"),
                                               get_arch(MOE_ARCH))
    print("moe_slice " + json.dumps(moe_report), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    # RWKV-6's run there is the unsplit yardstick of its mesh serving
    fam_report, fam_launches, yard = families_slice_phase(
        card, torch.device("cuda"), keep={WR_RWKV: WR_RWKV_NEW})
    print("families_slice " + json.dumps(fam_report), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    train_lm_report, train_lm_launches = lm_train_slice_phase(
        card, torch.device("cuda"), get_arch(LM_ARCH))
    print("lm_train_slice " + json.dumps(train_lm_report), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    # the earlier mesh phases run shorter here than in
    # `scripts/lm_mesh_slice.py` (each line's "reduced"), so that the
    # script ends inside its time limit with the families' phase
    mesh_report, mesh_k3 = lm_mesh_slice_phase(
        card, torch.device("cuda"), split_devices(), timed=SMOKE_MESH_TIMED,
        new=SMOKE_MESH_NEW, profile_train=False, layers=SMOKE_MESH_LAYERS)
    print("lm_mesh_slice " + json.dumps(mesh_report), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    moe_mesh_report, moe_mesh_k3 = lm_mesh_moe_slice_phase(
        card, torch.device("cuda"), split_devices(), new=SMOKE_MESH_NEW,
        profile_train=False, serve_layers=SMOKE_MOE_SERVE_LAYERS)
    print("lm_mesh_moe_slice " + json.dumps(moe_mesh_report), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    # the tp step's profile and the full-depth bf16 step are
    # `scripts/lm_mesh_slice.py families`'s
    fam_mesh_report, fam_mesh_launches = lm_mesh_families_slice_phase(
        card, torch.device("cuda"), split_devices(), profile_train=False,
        bf16_train=False, new=SMOKE_MESH_NEW,
        serve_layers=SMOKE_FAM_SERVE_LAYERS)
    print("lm_mesh_families_slice " + json.dumps(fam_mesh_report),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    wr_report, wr_launches = lm_mesh_whisper_rwkv_slice_phase(
        card, torch.device("cuda"), split_devices(), yardsticks=yard)
    del yard
    print("lm_mesh_whisper_rwkv_slice " + json.dumps(wr_report), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    fams = fam_report["models"]
    # the ms each counted path's phase measured (`counted_paths`)
    measured = {"hymba_prefill": lm_report["prefill_warm_ms"],
                "moonlight_prefill": moe_report["prefill_warm_ms"],
                "hymba_train_step": train_lm_report["ms_per_step"],
                "granite_tp_step_mesh":
                    mesh_report["train"]["sharded"]["ms_per_step"],
                "granite_serve8_decode_mesh":
                    mesh_report["serve"]["sharded"]["decode_ms_per_step"]}
    measured.update({f"{name}_prefill": fams[name]["prefill_warm_ms"]
                     for name, _p, _m in FAMILIES})
    bridge_report, bridge_launches = bridge_slice_phase(
        card, torch.device("cuda"), counting, measured)
    print("bridge_slice " + json.dumps(bridge_report), flush=True)

    g = gnn_rows[1]            # 512 x 32 x 300 -> 300: 8 of the 10 layers
    lt = lut_rows[0]           # the labeling gather: 17 KB column table
    kernels = [
        {"name": "gnn_mp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gnn_mp.cu",
         "replaces": "src/repro/kernels/gnn_mp.py:43",
         # the accelerator main path's and the bridge surrogate's
         "launches": launches["gnn_mp"] + bridge_launches["gnn_mp"],
         "max_abs_err": g["max_abs_err"],
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         # the bound on the TF32 tensor cores, each product issued three
         # times (3xTF32); the fp32 SIMT units' bound beside it
         "bound_by": g["bound_by"].split()[0],
         "bound_basis": "TF32 tensor cores, 3 products each (3xTF32)",
         "fp32_simt_bound_ms": g["fp32_simt_bound_ms"], "library_ms": None},
        {"name": "lut_eval", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lut_eval.cu",
         "replaces": "src/repro/kernels/lut_eval.py:28",
         "launches": launches["lut_eval"], "max_abs_err": lt["max_abs_err"],
         "ms": lt["ms"], "plain_ms": lt["plain_ms"],
         "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
         "library_ms": lt["library_ms"], "routes_on_main_path": routes},
    ]
    fr = fa_rows[0]            # the prefill shape: bf16, causal, S = 1024
    sr = scan_rows[0]          # the prefill shape, decay compact per head
    kernels += [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:67",
         # the Hymba, Moonlight, Qwen2-VL and Whisper prefills', the
         # Hymba training steps' (forward and recompute) and the Granite
         # GPipe passes of the split slice, the mesh slices' (Whisper's
         # encoder, self- and cross-attention among them)
         "launches": lm_launches["flash_attention"]
         + moe_launches["flash_attention"] + fam_launches["flash_attention"]
         + train_lm_launches["flash_attention"]
         + split_launches["flash_attention"] + mesh_k3 + moe_mesh_k3
         + fam_mesh_launches["flash_attention"]
         + wr_launches["flash_attention"],
         "max_abs_err": fr["max_abs_err"], "ms": fr["ms"],
         "plain_ms": fr["plain_ms"], "bound_ms": fr["bound_ms"],
         "bound_by": fr["bound_by"], "library_ms": fr["library_ms"]},
        # library_ms null: no one PyTorch call computes a linear recurrence
        {"name": "ssm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:49",
         # the Hymba prefill's, the training steps' (forward, recompute
         # and the reverse-time backward), and the Hymba mesh runs'
         "launches": lm_launches["ssm_scan"]
         + train_lm_launches["ssm_scan"] + fam_mesh_launches["ssm_scan"],
         "max_abs_err": sr["max_abs_err"], "ms": sr["ms"],
         "plain_ms": sr["plain_ms"], "bound_ms": sr["bound_ms"],
         "bound_by": sr["bound_by"], "library_ms": None},
    ]
    nr = norm_rows[0]          # the cell's call: 8,192 x 3,584 bf16
    kernels.append(
        {"name": "rms_norm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rms_norm.cu",
         "replaces": None,      # XLA fuses the norm in the JAX package
         # the counted prefills (Hymba, Moonlight, Qwen2-VL, Whisper,
         # RWKV-6) and the Hymba training steps (forward and remat's
         # recompute)
         "launches": lm_launches["rms_norm"] + moe_launches["rms_norm"]
         + fam_launches["rms_norm"] + train_lm_launches["rms_norm"],
         "max_ulps": nr["max_ulps"],
         "ms": nr["ms"], "plain_ms": nr["plain_ms"],
         "bound_ms": nr["bound_ms"], "bound_by": nr["bound_by"],
         "library_ms": nr["library_ms"]})
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: "
              + "; ".join(FAILURES), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
