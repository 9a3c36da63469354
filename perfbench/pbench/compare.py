"""The numbers that decide `correct`, each against its limit from
``limits/<workload>.json``.

Prefill (every checked call, every row):
- ``logits_gap``: the worst row's relative L2 distance of the last
  position's logits from the reference's;
- ``cache_gap``: the worst layer's relative L2 distance of the cache's
  keys or values from the reference's;
- ``cache_pos_wrong``: cache slots whose position is not the one the
  ring keeps there, the last prompt position p with p % W = slot (-1
  where none is), an exact comparison, limit 0.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def rel_l2(got: torch.Tensor, want: torch.Tensor, dim=None) -> torch.Tensor:
    got, want = got.double(), want.double()
    num = torch.linalg.vector_norm(got - want, dim=dim)
    return num / torch.linalg.vector_norm(want, dim=dim).clamp_min(1e-30)


def ring_positions(width: int, S: int, device) -> torch.Tensor:
    """The prompt position each of ``width`` ring slots keeps after S
    positions: the largest p < S with p % width = slot, else -1."""
    j = torch.arange(width, device=device)
    p = j + torch.div(S - 1 - j, width, rounding_mode="floor") * width
    return torch.where(p >= 0, p, -1)


def prefill_numbers(logits, entries: Dict[str, List[torch.Tensor]],
                    ref_logits, ref_cache: Dict[str, List[torch.Tensor]]
                    ) -> Dict[str, float]:
    """One call's numbers: ``entries`` are the program's cache entries by
    layer (`program.Prefill.cache_entries`), ``ref_cache`` the
    reference's."""
    S = ref_cache["k"][0].shape[1]
    gaps, wrong = [], 0
    for n in ("k", "v"):
        for i, want in enumerate(ref_cache[n]):
            got = entries[n][i]
            slots = ring_positions(got.shape[1], S, got.device)
            got, want = got[:, slots >= 0], want[:, slots[slots >= 0]]
            gaps.append(float(rel_l2(got, want)))
    for i, p in enumerate(entries.get("pos", ())):
        wrong += int((p != ring_positions(p.shape[1], S, p.device)).sum())
    return {"logits_gap": float(rel_l2(logits, ref_logits, dim=-1).max()),
            "cache_gap": max(gaps),
            "cache_pos_wrong": float(wrong)}


def worst(numbers: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, dict]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number with no limit, or not finite, is not correct."""
    checks, ok = {}, True
    for name, spec in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": spec["limit"]}
        ok &= value <= spec["limit"]
    return ok, checks
