"""How far RWKV-6 3B's training step moves under another order of the
same float32 sums, on the card.

    python3 scripts/rwkv_mesh_rounding.py [cuda|cpu]

RWKV-6 3B at 4 layers (full width; the vocabulary cut to 8,192 on the
CPU), random weights from `launch.train.build_state`, one `TokenPipeline`
batch of 8 x 128 tokens in two micro-batches. Runs the unsplit step in
float32 compute, then against it: the same step again (bit-equal), the
same step in one micro-batch (the same function, other sums), the step in
float64 compute, and `launch.steps.plan`'s tp step on (2, 1), (1, 2) and
(2, 2) meshes in float32 (twice on (2, 2)) and in float64 against the
unsplit float64 step. Prints one JSON line a run: the grad norm and its
relative gap, the loss, u_bonus's and the median leaf's relative L2 gap
of the first layer's first moments with the clip scale divided out
(`chip_smoke.train_run`), and the four largest.
"""
import dataclasses
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
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.train import batch_on
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("rwkv_mesh_rounding: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(cs.card_line(), flush=True)
    devs = cs.split_devices() if dev.type == "cuda" else [dev]
    seq = 128
    cfg = dataclasses.replace(ARCHS["rwkv6-3b"], n_layers=4, dtype="float32")
    if dev.type == "cpu":
        cfg = dataclasses.replace(cfg, vocab_size=8192)
    c64 = dataclasses.replace(cfg, dtype="float64")
    pipe = TokenPipeline(cfg.vocab_size, seq, 8)

    def run(c, mesh_shape, accum=2):
        shape = ShapeConfig("train", seq, 8, "train", grad_accum=accum)
        cs.free_card(dev)
        if mesh_shape is None:
            fn = steps.make_train_step(c, shape)
            state = train_lib.build_state(c, dev)
            batch_at = lambda i: batch_on(pipe.batch_at(i), {}, dev)  # noqa
        else:
            mesh, _ = cs.mesh_on(devs, mesh_shape)
            fn = steps.plan(c, shape, mesh, steps.resolve_rules("tp"))[0]
            state = train_lib.build_state(c, dev, mesh=mesh)
            batch_at = pipe.batch_at
        return cs.train_run(dev, fn, state, batch_at, 1, None,
                            unclipped=True)[1]
    t0 = time.perf_counter()
    base = {"float32": run(cfg, None)}
    cases = [("unsplit_again", cfg, None, 2, "float32"),
             ("unsplit_one_micro_batch", cfg, None, 1, "float32"),
             ("unsplit_float64", c64, None, 2, "float32"),
             ("mesh_2x1", cfg, (2, 1), 2, "float32"),
             ("mesh_1x2", cfg, (1, 2), 2, "float32"),
             ("mesh_2x2", cfg, (2, 2), 2, "float32"),
             ("mesh_2x2_again", cfg, (2, 2), 2, "float32"),
             ("mesh_2x2_float64", c64, (2, 2), 2, "float64")]
    for name, c, shape, accum, against in cases:
        r = run(c, shape, accum)
        if name == "unsplit_float64":
            base["float64"] = r
        b = base[against]
        rel = cs.rel_l2_each(r["m0"], b["m0"])
        gn, gb = r["grad_norms"][0], b["grad_norms"][0]
        print(name, json.dumps({
            "against": f"unsplit_{against}", "grad_norm": gn,
            "grad_norm_rel_gap": abs(gn - gb) / gb, "loss": r["losses"][0],
            "u_bonus": rel["blocks/rwkv/u_bonus"],
            "median": sorted(rel.values())[len(rel) // 2],
            "largest": dict(sorted(rel.items(), key=lambda kv: -kv[1])[:4]),
            "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
