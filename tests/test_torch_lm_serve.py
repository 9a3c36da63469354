"""The port's LM `BatchServer` (`repro_torch.launch.serve`) against the
reference's (`repro.launch.serve.BatchServer`) at reduced sizes on the
CPU, float32 compute over both packages' bf16 KV cache.

The reference's decode step writes every batch row's cache at the
stepped slot's position, and admission leaves a slot's earlier entries
in place, so its tokens for a request depend on the requests served
beside and before it. Its tokens for a request served alone in a fresh
server are free of that fault: the port's server gives every request
those tokens, however the requests share its slots.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import REDUCED_ARCHS as J_ARCHS
from repro.launch import serve as jserve
from repro.models import transformer as jtr
from repro_torch.configs import REDUCED_ARCHS as T_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import decoding as tdec
from repro_torch.models.layers import params_from_numpy

PROMPT, MAX_NEW = 6, 6


def _pair(name, seed=0):
    jcfg = dataclasses.replace(J_ARCHS[name], dtype="float32")
    tcfg = dataclasses.replace(T_ARCHS[name], dtype="float32")
    jp = jtr.build_param_table(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _prompts(cfg, n, seed=0):
    """The reference demo's prompts: default_rng(seed), PROMPT tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(n)]


def _ref_alone(jcfg, jp, prompt, slots=2):
    """The reference's tokens for ``prompt`` alone in a fresh server."""
    req = jserve.Request(0, prompt, MAX_NEW)
    jserve.BatchServer(jcfg, jp, slots=slots).run([req])
    return req.out


def _port(tcfg, tp, prompts, slots=2):
    reqs = [tserve.Request(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    server = tserve.BatchServer(tcfg, tp, slots=slots, device="cpu")
    served = server.run(reqs)
    assert all(r.done for r in reqs)
    assert served == {r.rid: r.out for r in reqs}
    return [r.out for r in reqs], server


def test_three_requests_through_two_slots_get_their_tokens_alone():
    """Reduced granite-3-2b: three requests through 2 slots, each gets
    the tokens the reference gives it alone in a fresh server (the fault-
    free column of the reference's runs)."""
    jcfg, tcfg, jp, tp = _pair("granite-3-2b")
    prompts = _prompts(tcfg, 3)
    got, server = _port(tcfg, tp, prompts)
    want = [_ref_alone(jcfg, jp, p) for p in prompts]
    assert got == want
    # the reference's own run of request 0 beside the others read
    # [88, 212, 202, 212, 202, 212] (ROADMAP.md, queue 3)
    assert got[0] == [19, 4, 147, 5, 112, 170]
    # every prompt token admitted by a step, MAX_NEW steps each to decode
    assert server.steps == 3 * (PROMPT + MAX_NEW)


# request 0's tokens: alone in a fresh reference server (the port's in
# any server), and in the reference's run beside the other two requests,
# which its shared-cache fault changes (ROADMAP.md, queue 3)
REQUEST0 = {"rwkv6-3b": ([80, 214, 209, 41, 35, 71],
                         [30, 251, 134, 130, 14, 214]),
            "qwen2-vl-7b": ([163, 163, 110, 241, 250, 249], [200] * 6)}


@pytest.mark.parametrize("name", sorted(REQUEST0))
def test_recurrent_and_vlm_requests_through_two_slots_get_their_tokens_alone(
        name):
    """Reduced rwkv6 and qwen2-vl: three requests through 2 slots, each
    gets the reference's tokens for it alone in a fresh server. RWKV's
    step writes only the stepped slot's state and token-shift inputs, and
    admission zeroes them."""
    jcfg, tcfg, jp, tp = _pair(name)
    prompts = _prompts(tcfg, 3)
    got, server = _port(tcfg, tp, prompts)
    assert got == [_ref_alone(jcfg, jp, p) for p in prompts]
    alone, shared = REQUEST0[name]
    assert got[0] == alone
    assert server.steps == 3 * (PROMPT + MAX_NEW)
    reqs = [jserve.Request(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    jserve.BatchServer(jcfg, jp, slots=2).run(reqs)
    assert reqs[0].out == shared


def test_moe_request_alone_gets_the_reference_tokens():
    """Reduced Moonlight: one request in a fresh server, the reference's
    tokens (alone, the idle row routes a zero token: the same in both)."""
    jcfg, tcfg, jp, tp = _pair("moonshot-v1-16b-a3b", seed=1)
    prompt = _prompts(tcfg, 1, seed=1)[0]
    got, _ = _port(tcfg, tp, [prompt])
    assert got == [_ref_alone(jcfg, jp, prompt)]


@pytest.mark.parametrize("name", ["granite-3-2b", "hymba-1.5b"])
def test_tokens_do_not_depend_on_the_request_before_in_the_slot(name):
    """One slot: request 1 served after request 0 gets the tokens it gets
    alone (the slot's rows are emptied at admission; the hybrid family's
    SSM state too)."""
    _jcfg, tcfg, _jp, tp = _pair(name, seed=2)
    p0, p1 = _prompts(tcfg, 2, seed=2)
    after, _ = _port(tcfg, tp, [p0, p1], slots=1)
    alone, _ = _port(tcfg, tp, [p1], slots=1)
    assert after[1] == alone[0]


def test_hybrid_requests_sharing_the_batch_get_their_tokens_alone():
    """Reduced Hymba, three requests through 2 slots: a step leaves the
    other slot's KV rows and SSM state as they were."""
    _jcfg, tcfg, _jp, tp = _pair("hymba-1.5b", seed=3)
    prompts = _prompts(tcfg, 3, seed=3)
    together, _ = _port(tcfg, tp, prompts)
    assert together == [_port(tcfg, tp, [p])[0][0] for p in prompts]


def _row(cfg, cache, row):
    """Every cache leaf's entries of batch row ``row``."""
    if cfg.attn_free:
        return [cache[n][:, row] for n in ("state", "x_tm", "x_cm")]
    if cfg.family == "hybrid":
        return [lc[n][row] for lc in cache["layers"]
                for n in ("k", "v", "pos")] + [cache["ssm"][:, row]]
    return [cache["k"][:, row], cache["v"][:, row], cache["pos"][row]]


@pytest.mark.parametrize("row", [0, 2])
@pytest.mark.parametrize("name", ["granite-3-2b", "hymba-1.5b", "rwkv6-3b"])
def test_decode_step_writes_only_the_named_row(name, row):
    """Steps with ``row`` give that row the logits and cache entries of
    full steps and leave the other rows' caches empty; clear_row empties
    the row again."""
    _jcfg, tcfg, _jp, tp = _pair(name, seed=4)
    shape = ShapeConfig("d", 8, 3, "decode")
    toks = torch.tensor([[5], [7], [9]], dtype=torch.int32)
    full = tdec.init_cache(tcfg, shape, "cpu")
    part = tdec.init_cache(tcfg, shape, "cpu")
    empty = tdec.init_cache(tcfg, shape, "cpu")
    for step in range(3):
        full_logits, full = tdec.decode_step(tcfg, tp, full, toks, step)
        part_logits, part = tdec.decode_step(tcfg, tp, part, toks, step,
                                             row=row)
        torch.testing.assert_close(part_logits[row], full_logits[row])
    for r in range(3):
        want = full if r == row else empty
        for got, ref in zip(_row(tcfg, part, r), _row(tcfg, want, r)):
            assert torch.equal(got, ref)
    tdec.clear_row(tcfg, part, row)
    for got, ref in zip(_row(tcfg, part, row), _row(tcfg, empty, row)):
        if got.dtype in (torch.int32, torch.float32) or tcfg.attn_free:
            assert torch.equal(got, ref)      # positions, recurrent state


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "rwkv6-3b",
                                  "qwen2-vl-7b"])
def test_lm_demo_serves_on_the_cpu(capsys, arch):
    """`--demo lm`'s function at the reference's defaults on the CPU."""
    import argparse
    args = argparse.Namespace(arch=arch, reduced=True,
                              requests=3, slots=2, max_new=3,
                              prompt_len=4, device="cpu")
    tserve._demo_lm(args)
    out = capsys.readouterr().out
    assert "served 3 requests on cpu, 9 tokens, 21 decode steps" in out
