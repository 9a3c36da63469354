"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, on a host with a CUDA card:

    python3 chip_smoke.py

It builds both CUDA kernels from src/repro_torch/kernels/csrc (one nvcc
per source, in parallel, into build/kernels/), holds each kernel against
its plain PyTorch version at the main path's shapes and times both with
CUDA events, then drives the port's main path for the Gaussian
accelerator: pruned library -> batched labeling of 2048 configurations
(SSIM through `lut_eval`) -> a paper-width two-stage GraphSAGE surrogate
(5 layers, hidden 300, random weights from a seeded generator) served by
`SurrogateEngine.from_gnn` (`gnn_mp` in every layer) and an oracle engine.
Launch counters are zeroed just before the main path and read just after.

The last line of standard output is the device JSON; the line before it
is the per-kernel JSON. Exits non-zero without a CUDA card, outside a
checkout, or when any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
GNN_TOL = 1e-4          # fp32 against cuBLAS fp32: another summation order
PARITY_ATOL = 2e-3      # the reference engine's kernel-vs-plain bar
# the slice: Gaussian, paper-width GNN (Sec IV-A: 5 layers, hidden 300)
N_SAMPLES, N_LAYERS, HIDDEN, CHUNK = 2048, 5, 300, 512


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls, from CUDA events after a warm-up."""
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


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------

def gnn_mp_phase(gen):
    import torch
    from repro_torch.kernels import gnn_mp, ref
    dev = torch.device("cuda")
    rows = []
    for B, N, F, Fo in [(512, 32, 27, 300), (512, 32, 300, 300),
                        (37, 32, 300, 300)]:
        adj = torch.rand(N, N, device=dev, generator=gen)
        h = torch.randn(B, N, F, device=dev, generator=gen)
        ws = torch.randn(F, Fo, device=dev, generator=gen) * F ** -0.5
        wn = torch.randn(F, Fo, device=dev, generator=gen) * F ** -0.5
        b = torch.randn(Fo, device=dev, generator=gen) * 0.1
        err = 0.0
        for a in (adj, adj.expand(B, N, N).contiguous()):
            got = gnn_mp.gnn_mp(a, h, ws, wn, b)
            want = ref.gnn_mp_ref(a, h, ws, wn, b)
            torch.cuda.synchronize()
            check(torch.allclose(got, want, rtol=GNN_TOL, atol=GNN_TOL),
                  f"gnn_mp {B}x{N}x{F}->{Fo} disagrees with gnn_mp_ref")
            err = max(err, float((got - want).abs().max()))
        ms = cuda_ms(lambda: gnn_mp.gnn_mp(adj, h, ws, wn, b), 20)
        plain = cuda_ms(lambda: ref.gnn_mp_ref(adj, h, ws, wn, b), 20)
        flops = 2 * B * N * F * Fo * 2 + 2 * B * N * N * Fo
        nbytes = 4 * (N * N + B * N * F + 2 * F * Fo + Fo + B * N * Fo)
        bnd, by = bound_ms(nbytes, flops)
        rows.append({"shape": [B, N, F, Fo], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                     "gflop": flops / 1e9})
    return rows


def lut_eval_phase(gen):
    import numpy as np
    import torch
    from repro_torch.accel import library as lib
    from repro_torch.core import pruning
    from repro_torch.kernels import lut_eval, ref
    dev = torch.device("cuda")
    pruned, _ = pruning.prune_library()
    g17 = lib.stacked_lut(tuple(pruned["mul8x4"]), 8, 4)
    tables = {
        # (table, wb, operand a range per entry, entries)
        "gaussian_mul8x4_column": (g17.view(-1, 16)[:, 4].contiguous(), 0,
                                   8, len(pruned["mul8x4"])),
        "gaussian_mul8x4_8x4": (g17, 4, 8, len(pruned["mul8x4"])),
        "dct8_mul8x4_13x4": (lib.stacked_lut(tuple(pruned["mul8x4"]), 13, 4),
                             4, 13, len(pruned["mul8x4"])),
        "kmeans_mul8_9x9": (lib.stacked_lut(tuple(pruned["mul8"]), 9, 9), 9,
                            9, len(pruned["mul8"])),
        "kmeans_sqrt18_20x0": (lib.stacked_lut(tuple(pruned["sqrt18"]), 20,
                                               0), 0, 20,
                               len(pruned["sqrt18"])),
    }
    rng = np.random.default_rng(0)
    rows = []
    M = 256 * 4 * 64 * 64            # one labeling chunk of one unit node
    for name, (table, wb, ea, n_ent) in tables.items():
        lut = table.to(dev)
        for m in (M, M + 777, 1023):
            e = rng.integers(0, n_ent, m)
            a = torch.from_numpy(((e << ea) | rng.integers(0, 1 << ea, m))
                                 .astype(np.int32)).to(dev)
            b = torch.from_numpy(rng.integers(0, 1 << wb, m)
                                 .astype(np.int32)).to(dev)
            got = lut_eval.lut_eval(lut, a, b, wb)
            check(torch.equal(got, ref.lut_eval_ref(lut, a, b, wb)),
                  f"lut_eval {name} M={m} is not bit-exact")
        e = rng.integers(0, n_ent, M)
        a = torch.from_numpy(((e << ea) | rng.integers(0, 1 << ea, M))
                             .astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 1 << wb, M)
                             .astype(np.int32)).to(dev)
        idx = ((a << wb) | b).long()
        ms = cuda_ms(lambda: lut_eval.lut_eval(lut, a, b, wb), 50)
        plain = cuda_ms(lambda: ref.lut_eval_ref(lut, a, b, wb), 50)
        library = cuda_ms(lambda: torch.take(lut, idx), 50)
        bnd, by = bound_ms(4 * lut.numel() + 12 * M, 0)
        rows.append({"table": name, "table_kib": 4 * lut.numel() / 1024,
                     "m": M, "max_abs_err": 0, "ms": ms, "plain_ms": plain,
                     "library_ms": library, "bound_ms": bnd,
                     "bound_by": by})
    return rows


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def slice_phase(card: str, dev):
    """Drive the main path on ``dev``; returns (report, launches)."""
    import numpy as np
    import torch
    from repro_torch.accel import apps, batch_oracle
    from repro_torch.core import dataset, gnn, models, pipeline
    from repro_torch.core.engine import SurrogateEngine
    from repro_torch.kernels import gnn_mp, lut_eval
    report = {"card": card, "requests": []}

    gnn_mp.LAUNCHES.reset()
    lut_eval.LAUNCHES.reset()
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
    pool = [c for c in dataset.sample_configs(ctx.app, 4096, seed=1,
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
    launches = {"gnn_mp": gnn_mp.LAUNCHES.value,
                "lut_eval": lut_eval.LAUNCHES.value}
    report["launches"] = launches
    report["engine_stats"] = {k: getattr(eng.stats, k) for k in (
        "calls", "configs", "cache_hits", "evaluated", "padded", "chunks",
        "submits", "drains", "featurize_s", "dispatch_s", "collect_s",
        "overlapped_s")}
    for name, n in launches.items():
        check(dev.type != "cuda" or n > 0,
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
    return report, launches


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
          f"{ {k: round(v, 1) for k, v in built.items()} }", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    gnn_rows = gnn_mp_phase(gen)
    lut_rows = lut_eval_phase(gen)
    print("kernel_shapes " + json.dumps({"card": card, "gnn_mp": gnn_rows,
                                         "lut_eval": lut_rows}), flush=True)
    report, launches = slice_phase(card, torch.device("cuda"))
    print("slice " + json.dumps(report), flush=True)

    g = gnn_rows[1]            # 512 x 32 x 300 -> 300: 8 of the 10 layers
    lt = lut_rows[0]           # the labeling gather: 17 KB column table
    kernels = [
        {"name": "gnn_mp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gnn_mp.cu",
         "replaces": "src/repro/kernels/gnn_mp.py:43",
         "launches": launches["gnn_mp"], "max_abs_err": g["max_abs_err"],
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": g["bound_by"], "library_ms": None},
        {"name": "lut_eval", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lut_eval.cu",
         "replaces": "src/repro/kernels/lut_eval.py:28",
         "launches": launches["lut_eval"], "max_abs_err": lt["max_abs_err"],
         "ms": lt["ms"], "plain_ms": lt["plain_ms"],
         "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
         "library_ms": lt["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
