"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card: with no card present this raises rather
    than fall back to the CPU, so a run that was meant for the card can
    never silently measure the CPU. Pass ``device="cpu"`` to run the plain
    PyTorch path on purpose (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def local_devices(kind: Optional[str] = None) -> List[torch.device]:
    """Every local device of type ``kind`` (default: ``cuda`` when a card
    is present, else ``cpu``), in index order. The CPU is one device."""
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def canonical(device: DeviceLike) -> torch.device:
    """``device`` with a CUDA index filled in (the current device's), so
    that ``cuda`` and ``cuda:0`` compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


DevicesLike = Union[None, int, str, Sequence[DeviceLike]]


def device_list(devices: DevicesLike, device: DeviceLike = None
                ) -> List[torch.device]:
    """The devices a split runs over, the first one the primary.

    ``devices`` takes the reference's count: ``1`` (or None) is no split,
    [``device``]; ``0`` (or ``"auto"``) is every local device of
    ``device``'s type; ``N`` is at most N of them. It also takes an
    explicit sequence of devices, which may name one device several times
    (its shards then run one after another)."""
    if devices is None or (isinstance(devices, int) and devices == 1):
        return [canonical(resolve(device))]
    if isinstance(devices, str) and devices != "auto":
        raise ValueError(f"devices must be a count, 'auto' or a sequence "
                         f"of devices, got {devices!r}")
    if devices == "auto" or isinstance(devices, int):
        n = 0 if devices == "auto" else int(devices)
        if n < 0:
            raise ValueError(f"devices must be >= 0 or 'auto', got {devices}")
        local = local_devices(resolve(device).type)
        return local if n == 0 else local[:max(1, min(n, len(local)))]
    out = [canonical(d) for d in devices]
    if not out:
        raise ValueError("devices is an empty sequence")
    return out
