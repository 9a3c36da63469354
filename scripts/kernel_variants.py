"""What the parts of a hand-written kernel cost on the card.

Run from the root of a checkout, on a host with a CUDA card:

    python3 scripts/kernel_variants.py flash_attention
    python3 scripts/kernel_variants.py lut_eval
    python3 scripts/kernel_variants.py gnn_mp

``flash_attention`` builds the kernel's source as it is and in variants
with parts taken out (the K/V loads, the exp2 of the softmax, the
softmax, both products, all but the loads, all of them, then the output
stores too), one nvcc per variant in parallel, and times each at the bf16 shapes of
chip_smoke.py's K3 phase beside scaled_dot_product_attention. A variant
with a part taken out computes a wrong result; the line reports its
error and times it all the same. ``lut_eval`` times both of the kernel's
paths (the table staged in shared memory, the table read through the
caches) at tables from 17 KiB to 8.5 MiB beside torch.take, by moving the
wrapper's staging threshold. ``gnn_mp`` builds K1 as it is and with
parts taken out or changed (the small terms of 3xTF32, the aggregation,
the products, the loads, the rounding, the waits; other tiles, warp
counts and ring depths), and times each at chip_smoke.py's main-path
shapes beside the plain version, with its ptxas registers and spills.
Times are CUDA events around a CUDA graph of the calls
(chip_smoke.cuda_ms); one JSON line a variant or table.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (old, new) substitutions on csrc/flash_attention.cu
_KV_LOADS = ("""          mbar_expect_tx(k_full, (P::kSplitKV ? 1 : 2) * P::kTileBytes);
#pragma unroll
          for (int x = 0; x < P::kBoxes; ++x)
            tma_load_4d(sK + x * kBK * kRow, &tk, k_full, x * P::kBoxD,
                        kt * kBK, kvh, it.b);
          if (P::kSplitKV) mbar_expect_tx(v_full, P::kTileBytes);
#pragma unroll
          for (int x = 0; x < P::kBoxes; ++x)
            tma_load_4d(sK + P::kTileBytes + x * kBK * kRow, &tv,
                        P::kSplitKV ? v_full : k_full, x * P::kBoxD,
                        kt * kBK, kvh, it.b);""",
             """          mbar_arrive(k_full);
          mbar_arrive(v_full);""")
_EXP2 = ("""      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sc, -m[0]));
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], sc, -m[1]));""",
         """      s[4 * j + e] = fmaf(s[4 * j + e], sc, -m[0]);
      s[4 * j + 2 + e] = fmaf(s[4 * j + 2 + e], sc, -m[1]);""")
_SOFTMAX = [
    ("softmax_tile<kBK>(s, edge(0), 0, t, r0 + off, p.Sk, p.causal, sc, m,\n"
     "                          al, l);",
     "al[0] = al[1] = 1.f; l[0] = l[1] = 1.f;"),
    ("softmax_tile<kBK>(s, edge(k0), k0, t, r0 + off, p.Sk, p.causal, sc,\n"
     "                            m, al, ls);",
     "al[0] = al[1] = 1.f; ls[0] = ls[1] = 1.f;")]
_PRODUCTS = [("qk_issue<D>(s, sQw, sKV + 2 * stage * P::kTileBytes);", ";"),
             ("pv_issue<D>(o, pa, sKV + (2 * prev + 1) * P::kTileBytes);",
              ";")]
_STORES = ("        for (int j = 0; j < D / 8; ++j) {\n"
           "          if (r0 < p.Sq)",
           "        for (int j = 0; j < 0; ++j) {\n          if (r0 < p.Sq)")
FA_VARIANTS = {
    "kernel": [],
    "no_kv_loads": [_KV_LOADS],
    "no_exp2": [_EXP2],
    "no_softmax": _SOFTMAX,
    "no_products": _PRODUCTS,
    "loads_only": [*_SOFTMAX, *_PRODUCTS],
    "skeleton": [_KV_LOADS, *_SOFTMAX, *_PRODUCTS],
    "skeleton_no_stores": [_KV_LOADS, *_SOFTMAX, *_PRODUCTS, _STORES],
}


# (old, new) substitutions on csrc/gnn_mp.cu
_LO_TERMS = [("      mma_tf32(small[i][j], al[i], bh[j]);\n", ""),
             ("    for (int j = 0; j < kNT; ++j) mma_tf32(small[i][j], ah[i], "
              "bl[j]);", "    for (int j = 0; j < kNT; ++j) {}")]
_MMA = [("  asm(\"mma.sync.aligned.m16n8k8",
         "  if (0) asm(\"mma.sync.aligned.m16n8k8")]
_EPILOGUE = [("  if (busy) {\n    const int last",
              "  if (false) {\n    const int last")]
# the staging skipped: the products then run on whatever the ring holds
_LOADS = [("      copy(sh + j * kHRowStep * kHStride, ok ? h_row + j * h_step "
           "+ k0 : h,\n           ok, kH16);", ""),
          ("      copy(sws + j * kWRowStep * kWStride, ws + off, ok, kW16);\n"
           "      copy(sws + kWTile + j * kWRowStep * kWStride, wn + off, ok, "
           "kW16);", "")]
# the split through cvt.rna.tf32.f32 (with its inf/NaN guard)
_SPLIT = "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));"
_CVT = [(_SPLIT,
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
         "  const float rest = x - __uint_as_float(hi);\n"
         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : \"f\"(rest));")]
# raw fp32 bits in place of the split (wrong, for timing the products)
_RAW_SPLIT = [(_SPLIT, "  hi = lo = __float_as_uint(x);")]
# the small terms summed into the hi*hi accumulators
_ONE_SUM = [("mma_tf32(small[i][j], al[i], bh[j]);",
             "mma_tf32(big[i][j], al[i], bh[j]);"),
            ("mma_tf32(small[i][j], ah[i], bl[j]);",
             "mma_tf32(big[i][j], ah[i], bl[j]);")]
# the copies issued, never waited for: what the waits cost
_NO_WAIT = [("    cp_async_wait<kStages - 2>();", "")]


def _const(name, old, new):
    return [(f"constexpr int {name} = {old};",
             f"constexpr int {name} = {new};")]


GNN_VARIANTS = {
    "kernel": [],
    "cvt_split": _CVT,
    "no_lo_terms": _LO_TERMS,
    "one_accumulator": _ONE_SUM,
    "no_epilogue": _EPILOGUE,
    "no_products": _MMA,
    "cols128_warps8": _const("kCols", 64, 128) + _const("kWarpsN", 2, 4),
    "warps8_16x32": _const("kWarpsM", 2, 4),
    "rows128_warps8": _const("kRows", 64, 128) + _const("kWarpsM", 2, 4),
    "no_loads": _LOADS,
    # the products alone: no staging, no rounding (the fragments' LDS and
    # the HMMAs)
    "hmma_lds_only": _LOADS + _RAW_SPLIT,
    "no_waits": _NO_WAIT,
    "stages2": _const("kStages", 3, 2),
    "stages4": _const("kStages", 3, 4),
}


def build_variants(build, name: str, variants: dict, out: Path) -> dict:
    """One shared library per variant of ``csrc/<name>.cu``, compiled in
    parallel with the port's flags; returns {variant: (path, nvcc's
    output)}."""
    src = (build.CSRC / build.SOURCES[name]).read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{var}: the source has no {old[:60]!r}")
            text = text.replace(old, new)
        (out / f"{var}.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"{var}.so"),
               str(out / f"{var}.cu")]
        procs[var] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for var, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{var}: nvcc exited {proc.returncode}\n{log}")
        libs[var] = (out / f"{var}.so", log)
    return libs


def flash_attention(cs, build) -> None:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    libs = build_variants(build, "flash_attention", FA_VARIANTS,
                          ROOT / "build" / "variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for label, B, H, KV, S, D, dt, causal in cs.FA_SHAPES:
        if dt != "bfloat16":
            continue
        Sq, Sk = cs.fa_lengths(S)
        q, k, v = (torch.randn(B, n_s, n, D, device="cuda", generator=gen)
                   .bfloat16().transpose(1, 2)
                   for n, n_s in ((H, Sq), (KV, Sk), (KV, Sk)))
        want = ref.flash_attention_ref(q, k, v, causal=causal).float()
        cases.append((label, q, k, v, causal, want))
    print(json.dumps({"variant": "scaled_dot_product_attention", "ms": {
        label: cs.cuda_ms(lambda: cs.sdpa(q, k, v, causal), 20)
        for label, q, k, v, causal, _ in cases}}), flush=True)
    for var, (path, _) in libs.items():
        lib = ctypes.CDLL(str(path))
        fa._declare(lib)
        build._libs["flash_attention"] = lib
        ms, err = {}, {}
        for label, q, k, v, causal, want in cases:
            got = fa.flash_attention(q, k, v, causal=causal).float()
            err[label] = float(((got - want).norm(dim=-1)
                                / want.norm(dim=-1)).max())
            ms[label] = cs.cuda_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal), 20)
        print(json.dumps({"variant": var, "ms": ms, "row_rel_l2": err}),
              flush=True)


def lut_eval(cs) -> None:
    import torch
    from repro_torch.kernels import lut_eval as le
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    M = 256 * 4 * 64 * 64
    threshold = le.STAGE_MAX_BYTES
    try:
        for n in (17 * 256, 12 * 1024, 24 * 1024, 17 << 12, 17 << 17):
            lut = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), device="cuda",
                                dtype=torch.int32, generator=gen)
            a = torch.randint(0, n, (M,), device="cuda", dtype=torch.int32,
                              generator=gen)
            idx = a.long()
            row = {"table_kib": 4 * n / 1024, "m": M,
                   "take_ms": cs.cuda_ms(lambda: torch.take(lut, idx), 50)}
            for stage_max in (0, 1 << 30):
                le.STAGE_MAX_BYTES = stage_max
                path = le.path(4 * n)
                if path == "shared" and 4 * n > 200 * 1024:
                    continue          # more than a block's shared memory
                if not torch.equal(le.lut_eval(lut, a),
                                   ref.lut_eval_ref(lut, a)):
                    raise SystemExit(f"lut_eval {path} {n}: not bit-exact")
                row[f"{path}_ms"] = cs.cuda_ms(lambda: le.lut_eval(lut, a),
                                               50)
            print(json.dumps(row), flush=True)
    finally:
        le.STAGE_MAX_BYTES = threshold


def gnn_mp(cs, build) -> None:
    import torch
    from repro_torch.kernels import gnn_mp as mp
    from repro_torch.kernels import ref
    libs = build_variants(build, "gnn_mp", GNN_VARIANTS,
                          ROOT / "build" / "variants_gnn")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for B, N, F, Fo, scale in cs.GNN_SHAPES[:3]:
        adj = torch.rand(N, N, device="cuda", generator=gen)
        h = torch.randn(B, N, F, device="cuda", generator=gen) * scale
        ws, wn = (torch.randn(F, Fo, device="cuda", generator=gen)
                  * F ** -0.5 for _ in range(2))
        b = torch.randn(Fo, device="cuda", generator=gen) * 0.1
        args = (adj, h, ws, wn, b)
        cases.append((f"{B}x{N}x{F}->{Fo}", args, ref.gnn_mp_ref(*args)))
    print(json.dumps({"variant": "plain", "ms": {
        label: cs.cuda_ms(lambda: ref.gnn_mp_ref(*args), 20)
        for label, args, _ in cases}}), flush=True)
    for var, (path, log) in libs.items():
        lib = ctypes.CDLL(str(path))
        mp._declare(lib)
        build._libs["gnn_mp"] = lib
        ms, err = {}, {}
        for label, args, want in cases:
            err[label] = float((mp.gnn_mp(*args) - want).abs().max())
            ms[label] = cs.cuda_ms(lambda: mp.gnn_mp(*args), 20)
        print(json.dumps({"variant": var, "ms": ms, "max_abs_err": err,
                          "ptxas": {cs.kernel_name(fn): res for fn, res in
                                    build.resources(log).items()}}),
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("kernel", choices=("flash_attention", "lut_eval",
                                           "gnn_mp"))
    args = parser.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    print(cs.card_line(), flush=True)
    if args.kernel == "flash_attention":
        flash_attention(cs, build)
    elif args.kernel == "gnn_mp":
        gnn_mp(cs, build)
    else:
        lut_eval(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
