"""What running the GNN engines' readouts at the chunk's rows buys and
costs on the card.

Run from the root of a checkout, on a host with a CUDA card:

    python3 scripts/readout_rows.py

For each architecture (gsae through the `gnn_mp` kernel; gat and mpnn
through torch's products) at the paper's widths (5 layers, hidden 300),
with random weights from a seed over a 256-sample Gaussian dataset, it
builds `SurrogateEngine.from_gnn` (chunks of 512, cache off) three ways:

* ``none``: every product at the chunk's own rows (no padding);
* ``readout``: the readouts at 512 rows (the engine's way for gcn, gsae
  and gat);
* ``whole``: the whole two-stage model at 512 rows (the engine's way for
  the architectures in `engine.WHOLE_MODEL_AT_ROWS`: mpnn).

For each it reports how many rows of a request of 1, 8, 64 or 200 configs
differ from the same configs' rows inside one call of 512 (0 everywhere:
a config's row does not depend on the batch it came in), the device time
of the model on a 64-config and a 512-config chunk (CUDA events around a
CUDA graph of 20 calls, chip_smoke.cuda_ms), the wall time of a warm
64-config engine call (median of 20) and the device profile of one
(chip_smoke.device_profile). One JSON line a variant.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ARCHS = ("gsae", "gat", "mpnn")
VARIANTS = ("none", "readout", "whole")
SIZES = (1, 8, 64, 200)
CHUNK = 512


def _patched(E, variant: str, seen: dict):
    """`engine._checked_predict` for ``variant`` (``none``: no rows to
    pad to); records the predict and featurizer it hands the engine in
    ``seen``."""
    orig = E._checked_predict

    def checked(two_cfg, params, feat, featurize, dev, atol, rows):
        fn, label = orig(two_cfg, params, feat, featurize, dev, atol,
                         0 if variant == "none" else rows)
        seen.update(predict=fn, featurize=featurize)
        return fn, label
    return checked


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("readout_rows: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import engine as E
    from repro_torch.core import gnn, models
    from repro_torch.core import pipeline as P
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    build.build(["gnn_mp", "lut_eval"])
    dev = torch.device("cuda")
    cfg = P.PipelineConfig(app="gaussian", n_samples=256)
    store = ArtifactStore(None)
    ctx = P.stage_prune(cfg, store, device=dev)
    ds = P.stage_dataset(cfg, store, ctx, device=dev)
    sizes = [len(ctx.entries[n.kind]) for n in ctx.app.unit_nodes]
    rng = np.random.default_rng(0)
    configs = [tuple(int(rng.integers(0, k)) for k in sizes)
               for _ in range(CHUNK)]
    for arch in ARCHS:
        two_cfg = models.TwoStageConfig(
            gnn=gnn.GNNConfig(arch=arch, n_layers=5, hidden=300,
                              feature_dim=ds.x.shape[-1]),
            schema_version=ds.schema_version)
        params = models.init(torch.Generator().manual_seed(0), two_cfg,
                             "cpu")
        for variant in VARIANTS:
            seen: dict = {}
            orig = E._checked_predict, E.WHOLE_MODEL_AT_ROWS
            E._checked_predict = _patched(E, variant, seen)
            E.WHOLE_MODEL_AT_ROWS = frozenset(
                {arch} if variant == "whole" else ())
            try:
                eng = E.SurrogateEngine.from_gnn(
                    two_cfg, params, ds, ctx.app, ctx.entries,
                    chunk_size=CHUNK, cache=False, device=dev)
            finally:
                E._checked_predict, E.WHOLE_MODEL_AT_ROWS = orig
            full = eng(configs)
            differ = {}
            for n in SIZES:
                part = eng(configs[:n])
                bad = ~np.all(part == full[:n], axis=1)
                differ[n] = {"rows": int(bad.sum()),
                             "max_abs": float(np.abs(part - full[:n]).max())}
            predict = seen["predict"]
            X = torch.from_numpy(seen["featurize"](configs)).to(dev)
            with torch.no_grad():
                model_ms = {n: cs.cuda_ms(lambda n=n: predict(X[:n]), 20)
                            for n in (64, CHUNK)}
            walls = []
            for _ in range(23):
                t = time.perf_counter()
                eng(configs[:64])
                walls.append((time.perf_counter() - t) * 1e3)
            print(json.dumps({
                "card": card, "arch": arch, "variant": variant,
                "engine_default": variant == (
                    "whole" if arch in orig[1] else "readout"),
                "backend": eng.backend, "differ_from_512": differ,
                "model_device_ms": model_ms,
                "call64_wall_ms_median": statistics.median(walls[3:]),
                "call64_profile": cs.device_profile(
                    lambda: eng(configs[:64]))}), flush=True)
            del eng, predict, X
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
