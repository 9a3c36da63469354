"""Small stand-ins for the CPU tests: a cell's configuration cut to the
program's `REDUCED` sizes of its architecture, and its traffic mix cut
to a few short prompts. The full sizes run only on the card."""
from __future__ import annotations

import dataclasses

SHAPE_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "ssm_state", "swa_window",
              "global_attn_every", "n_vision_tokens", "mrope_sections")


def config(conf: dict, **over) -> dict:
    """``conf`` at the program's REDUCED sizes of its ``arch``."""
    from repro_torch.configs import REDUCED_ARCHS
    red = dataclasses.asdict(REDUCED_ARCHS[conf["arch"]])
    red["head_dim"] = red["head_dim"] or red["d_model"] // red["n_heads"]
    out = dict(conf)
    for k in SHAPE_KEYS:
        if k in conf:
            v = red[k]
            out[k] = list(v) if isinstance(v, tuple) else v
    out.update(over)
    return out


def mix(mix: dict, **over) -> dict:
    """Two short shapes of the same tokens a call, the second with two
    images of unequal sides."""
    out = dict(mix, shapes=[{"batch": 4, "length": 16, "images": [[2, 2]]},
                            {"batch": 2, "length": 32,
                             "images": [[2, 3], [2, 2]]}],
               live_calls=3, warmup_rounds=1, traced_rounds=1)
    out.update(over)
    return out
