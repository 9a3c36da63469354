"""The port's profiler spans (`repro_torch.spans`): free while no profiler
records, and under one every span of the prefill step once per entry,
nested as the step calls them; the MoE and AdamW spans go through the
same gate."""
from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import REDUCED_ARCHS
from repro_torch.kernels import ops
from repro_torch.models import moe, transformer
from repro_torch.models.decoding import prefill
from repro_torch.optim import adamw
from repro_torch.spans import span

BLOCK_SPANS = ("embed_inputs", "rms_norm", "qkv_proj", "rope",
               "flash_attention_forward", "attn_out", "mlp")


def _per_call(L: int) -> dict:
    """Each prefill span's entries in one call of an L-layer stack."""
    return {"prefill_step": 1, "run_blocks": 1, "embed_inputs": 1,
            "rms_norm": 2 * L + 1, "qkv_proj": L, "rope": L,
            "flash_attention_forward": L, "attn_out": L, "mlp": L,
            "lm_head": 1, "cache_pack": 1}


def _model(arch: str):
    cfg = REDUCED_ARCHS[arch]
    params = transformer.build_param_table(cfg).init(
        torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.bfloat16)
    B, S = 2, 12
    batch = {"tokens": torch.arange(B * S, dtype=torch.int32).reshape(B, S)
             % cfg.vocab_size}
    if cfg.mrope_sections:
        batch["positions"] = torch.arange(S, dtype=torch.int32)[
            None, :, None].expand(B, S, 3).contiguous()
        batch["vision_embeds"] = torch.full(
            (B, cfg.n_vision_tokens, cfg.d_model), 0.01)
    return cfg, params, batch


def _events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.device_type ==
            torch.autograd.DeviceType.CPU]


def test_a_span_off_calls_nothing_but_the_gate(monkeypatch):
    """No profiler: a whole prefill enters no ``record_function`` (the
    dispatcher op that each entry would call is counted); under one the
    same count sees every span."""
    entered = []
    real = torch.ops.profiler._record_function_enter_new

    def counted(name, args=None):
        entered.append(name)
        return real(name, args)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    cfg, params, batch = _model("qwen2-vl-7b")
    assert span("a") is span("b")
    prefill(cfg, params, batch)
    assert entered == []
    _events(lambda: prefill(cfg, params, batch))
    assert Counter(entered) == _per_call(cfg.n_layers)


def test_the_prefill_step_records_every_span_nested():
    """One call of the reduced Qwen2-VL: each span of the table its count
    of times, the block spans inside `run_blocks`, which lies inside
    `prefill_step` with the head and the cache's packing, on the
    profiler's clock."""
    cfg, params, batch = _model("qwen2-vl-7b")
    events = _events(lambda: prefill(cfg, params, batch))
    want = _per_call(cfg.n_layers)
    got = Counter(e.name for e in events if e.name in want)
    assert got == want
    assert set(ops.SPANS) >= {"flash_attention_forward", "ssm_scan_forward"}

    def only(name):
        (e,) = [e for e in events if e.name == name]
        return e.time_range

    def inside(t, outer):
        return outer.start <= t.start and t.end <= outer.end
    step, blocks = only("prefill_step"), only("run_blocks")
    assert inside(blocks, step)
    for name in ("lm_head", "cache_pack"):
        assert inside(only(name), step) and not inside(only(name), blocks)
    for e in events:
        if e.name in BLOCK_SPANS:
            assert inside(e.time_range, blocks), e.name


@pytest.mark.parametrize("part", ["moe", "adamw"])
def test_the_routed_spans_are_still_recorded(part):
    """The MoE layer's four stages in a reduced Moonlight prefill, and
    the AdamW update, under a profiler."""
    if part == "moe":
        cfg, params, batch = _model("moonshot-v1-16b-a3b")
        want = set(moe.SPANS)
        events = _events(lambda: prefill(cfg, params, batch))
    else:
        p = {"w": torch.ones(3, 2)}
        g = {"w": torch.full((3, 2), 0.5)}
        want = {adamw.SPAN}
        events = _events(lambda: adamw.update(g, adamw.init(p), p,
                                              lambda step: 1e-3))
    assert want <= {e.name for e in events}
