"""Quickstart: ApproxPilot end-to-end on the Sobel edge detector, on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/quickstart_torch.py [--app sobel] \
        [--paper] [--artifact-dir DIR] [--device cpu]

Builds + prunes the approximate-unit library, constructs a labeled
dataset through the simulated synthesis flow, trains the two-stage
critical-path-aware GNN, runs NSGA-III DSE on the surrogate, and
validates Pareto points against the oracle. Runs on the CUDA card
unless ``--device`` names another torch device.
"""
import argparse
import dataclasses

from repro_torch.core import pipeline as P


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="sobel",
                    choices=["sobel", "gaussian", "kmeans", "dct8", "fir15"])
    ap.add_argument("--paper", action="store_true",
                    help="paper-faithful scale (slow: 55k-105k samples)")
    ap.add_argument("--artifact-dir", default=None,
                    help="on-disk artifact cache: rerunning with the same "
                         "config resumes from cached dataset/params")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the plain PyTorch path)")
    args = ap.parse_args()

    cfg = (P.PipelineConfig.paper_faithful(args.app) if args.paper
           else P.PipelineConfig(app=args.app, n_samples=800, epochs=30,
                                 dse_budget=1500, hidden=96, n_layers=4))
    if args.artifact_dir:
        cfg = dataclasses.replace(cfg, artifact_dir=args.artifact_dir)
    print(f"== ApproxPilot on {args.app} ==")
    res = P.run(cfg, verbose=True, device=args.device)

    print("\n-- design space pruning (Table VIII analog) --")
    print(f"  {res.space}")
    print("\n-- surrogate quality (Table V analog) --")
    for k, v in res.metrics.items():
        if k in ("engine", "dse_history", "store"):
            continue
        print(f"  {k}: " + ", ".join(f"{m}={x:.3f}" for m, x in v.items()))
    st = res.metrics.get("store", {})
    if st:
        print("\n-- artifact store (stage cache) --")
        print(f"  hits={st.get('hits', {})} misses={st.get('misses', {})}")
    hist = res.metrics.get("dse_history", [])
    if hist:
        h0, h1 = hist[0], hist[-1]
        print("\n-- DSE convergence (metrics['dse_history']) --")
        print(f"  front {h0['front_size']} -> {h1['front_size']}, "
              f"hypervolume {h0['hypervolume']:.3g} -> "
              f"{h1['hypervolume']:.3g} over {len(hist)} recorded "
              f"generations")
    eng = res.metrics.get("engine", {})
    if eng:
        print("\n-- DSE evaluation engine --")
        print(f"  backend={eng.get('backend')} "
              f"configs/s={eng.get('configs_per_sec', 0):.0f} "
              f"cache_hit_rate={eng.get('cache_hit_rate', 0):.2f} "
              f"unique_evaluated={eng.get('evaluated', 0)} "
              f"chunks={eng.get('chunks', 0)}")
    print(f"\n-- DSE: {len(res.pareto_configs)} Pareto points --")
    for cfg_idx, obj in list(zip(res.pareto_configs, res.pareto_objs))[:5]:
        print(f"  area={obj[0]:.0f} power={obj[1]:.0f} "
              f"latency={obj[2]:.1f} ssim={1 - obj[3]:.4f}")
    val = P.validate_pareto(res, 8, device=args.device)
    print(f"\n-- oracle validation of selected points --\n  {val}")


if __name__ == "__main__":
    main()
