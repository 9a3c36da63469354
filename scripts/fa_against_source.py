"""K3 (`flash_attention`) of this checkout against an older kernel source,
on the card.

    python3 scripts/fa_against_source.py OLD_FLASH_ATTENTION_CU

``OLD_FLASH_ATTENTION_CU`` is an earlier ``csrc/flash_attention.cu``
whose launcher takes one sequence length (queries as many as keys), for
example ``git show <rev>:src/repro_torch/kernels/csrc/flash_attention.cu``
saved under ``scratch/``. It is compiled with `build.NVCC_FLAGS` into this
checkout's `build.BUILD_DIR` and driven through this checkout's wrapper,
its launcher called with the one length. At every shape of
`chip_smoke.FA_SHAPES` with as many queries as keys, on the same inputs,
the old and the current kernel run in the order old, new, new, old. Prints
the card line and one JSON line: per shape, whether the outputs are
bit-equal and each run's `chip_smoke.cuda_ms`. Exits 1 when a shape's
outputs differ.
"""
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


class _OneLength:
    """The old library behind the wrapper's call: the launcher's lengths
    (..., Sq, Sk, D, ...) passed on as (..., S, D, ...)."""

    def __init__(self, lib):
        self.lib = lib

    def flash_attention_launch(self, q, k, v, o, B, H, KV, Sq, Sk, *rest):
        assert Sq == Sk, (Sq, Sk)
        return self.lib.flash_attention_launch(q, k, v, o, B, H, KV, Sq,
                                               *rest)


def old_library(source: Path):
    """Compile ``source`` into this checkout's build directory (once per
    content) and load it with the one-length launcher's signature."""
    from repro_torch.kernels import build
    digest = hashlib.sha256(source.read_bytes() + " ".join(
        build.NVCC_FLAGS).encode()).hexdigest()[:12]
    target = build.BUILD_DIR / f"libflash_attention-old-{digest}.so"
    if not target.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(target),
                        str(source)], check=True)
    lib = ctypes.CDLL(str(target))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [p, p, p, p, i, i, i, i, i] + [ll] * 12 + [i, i, p, p])
    lib.flash_attention_launch.restype = i
    return _OneLength(lib)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("fa_against_source: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    print(cs.card_line(), flush=True)
    build.build(["flash_attention"])
    new = build.load("flash_attention", fa._declare)
    old = old_library(Path(sys.argv[1]).resolve())
    shapes = [s for s in cs.FA_SHAPES if not isinstance(s[4], (tuple, list))]
    report, differ = {}, []
    for i, (label, B, H, KV, S, D, dt, causal) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(i)
        q, k, v = (torch.randn(B, S, n, D, device="cuda", generator=gen)
                   .to(getattr(torch, dt)).transpose(1, 2)
                   for n in (H, KV, KV))
        outs, ms = {}, []
        for who, lib in (("old", old), ("new", new), ("new", new),
                         ("old", old)):
            build._libs["flash_attention"] = lib
            outs.setdefault(who, fa.flash_attention(q, k, v, causal=causal))
            ms.append([who, cs.cuda_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal), 20)])
        build._libs["flash_attention"] = new
        same = torch.equal(outs["old"], outs["new"])
        report[label] = {"bit_equal": same, "ms": ms}
        if not same:
            differ.append(label)
    print("fa_against_source " + json.dumps(report), flush=True)
    if differ:
        print(f"fa_against_source: outputs differ at {differ}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
