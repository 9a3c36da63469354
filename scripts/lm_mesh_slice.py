"""`chip_smoke.py`'s LM-over-a-mesh phases alone, on the card.

    python3 scripts/lm_mesh_slice.py [dense|moe|families|whisper_rwkv|all]

Builds the kernels, holds K3 at the meshes' per-shard shapes (Granite-3-2B
on a (2, 2) mesh: 16 query heads and 4 KV heads a shard, 2 rows a
training micro-batch, 4 a prefill; its context-parallel shards, 512
queries over 512 and 1024 keys; Moonlight-16B-A3B's shard on (1, 4);
Hymba-1.5B's on (2, 2) and (1, 5), Qwen2-VL-7B's on (1, 4), Whisper
large-v3's on (1, 4) and (2, 2) and its cp encoder block) against its
plain version and SDPA, and K4 at Hymba's shards against its plain
version, then runs `chip_smoke.lm_mesh_slice_phase` (dense:
Granite-3-2B, the tp and cp presets), `chip_smoke.lm_mesh_moe_slice_phase`
(moe: Moonlight), `chip_smoke.lm_mesh_families_slice_phase` (families:
Hymba-1.5B and Qwen2-VL-7B) and
`chip_smoke.lm_mesh_whisper_rwkv_slice_phase` (whisper_rwkv: Whisper
large-v3 and RWKV-6 3B, the latter's unsplit serving run made here) over
every card, or card 0 named as many times as a mesh has positions
(`chip_smoke.split_devices`). Prints the card line, ``fa [...]`` and
``scan [...]`` lines (only the Whisper rows of ``fa``, and no ``scan``,
in whisper_rwkv) and the phases' ``lm_mesh_slice {...}``,
``lm_mesh_moe_slice {...}``, ``lm_mesh_families_slice {...}`` and
``lm_mesh_whisper_rwkv_slice {...}`` lines; exits 1 when a check fails.
About 2-4 minutes of command for each phase on an H100.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_mesh_slice: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = cs.card_line()
    print(card, flush=True)
    t = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [r for r in cs.FA_SHAPES if "_mesh_" in r[0]
              or "_cp_" in r[0] or "_shard" in r[0]]
    if which == "whisper_rwkv":
        shapes = [r for r in shapes if r[0].startswith("whisper_")]
    print("fa " + json.dumps(cs.flash_attention_phase(gen, shapes)),
          flush=True)
    if which != "whisper_rwkv":
        print("scan " + json.dumps(cs.ssm_scan_phase(gen,
                                                     cs.SCAN_SHAPES[3:])),
              flush=True)
    if which in ("dense", "all"):
        report, _ = cs.lm_mesh_slice_phase(card, torch.device("cuda"),
                                           cs.split_devices())
        print("lm_mesh_slice " + json.dumps(report), flush=True)
    if which in ("moe", "all"):
        report, _ = cs.lm_mesh_moe_slice_phase(card, torch.device("cuda"),
                                               cs.split_devices())
        print("lm_mesh_moe_slice " + json.dumps(report), flush=True)
    if which in ("families", "all"):
        report, _ = cs.lm_mesh_families_slice_phase(
            card, torch.device("cuda"), cs.split_devices())
        print("lm_mesh_families_slice " + json.dumps(report), flush=True)
    if which in ("whisper_rwkv", "all"):
        report, _ = cs.lm_mesh_whisper_rwkv_slice_phase(
            card, torch.device("cuda"), cs.split_devices())
        print("lm_mesh_whisper_rwkv_slice " + json.dumps(report),
              flush=True)
    if cs.FAILURES:
        print("lm_mesh_slice: " + "; ".join(cs.FAILURES), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
