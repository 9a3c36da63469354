"""The port's checkpointing (`repro_torch.checkpointing`): twins of the
reference's checkpoint tests (`tests/test_substrate.py`), checkpoints
that cross between the two packages in both directions, and the async
saver's host snapshot."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import checkpointing as jck
from repro_torch import checkpointing as ck
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import adamw


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.full((2, 2), 0.5, dtype=torch.bfloat16)}}


def _jax_tree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "b": {"c": jnp.ones((5,), jnp.int32),
                  "d": jnp.full((2, 2), 0.5, jnp.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ck.save(tmp_path, 3, t)
    restored, step = ck.restore(tmp_path, t)
    assert step == 3
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(tmp_path, s, t, keep_last=2)
    assert ck.all_steps(tmp_path) == [4, 5]
    assert ck.latest_step(tmp_path) == 5


def test_checkpoint_incomplete_ignored(tmp_path):
    t = _tree()
    ck.save(tmp_path, 1, t)
    # a crash mid-write: a step directory without the .complete marker
    bad = tmp_path / "step_9"
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ck.latest_step(tmp_path) == 1


def test_async_checkpointer(tmp_path):
    c = ck.AsyncCheckpointer(tmp_path)
    t = _tree()
    c.save(1, t)
    c.save(2, t)
    c.close()
    assert ck.latest_step(tmp_path) == 2


def test_async_save_does_not_see_a_later_in_place_update(tmp_path):
    """save() copies to the host before it returns: an in-place update
    right after (an optimizer step on CPU tensors, whose numpy views
    share memory) does not reach the checkpoint being written."""
    params = {"w": torch.zeros(256, 256), "s": torch.zeros((),
                                                           dtype=torch.int32)}
    c = ck.AsyncCheckpointer(tmp_path)
    for step in range(4):
        c.save(step, params)
        params["w"].add_(1.0)             # the next step, in place
        params["s"].add_(1)
    c.close()
    for step in range(2, 4):               # keep_last 3: steps 1-3 stay
        got, _ = ck.restore(tmp_path, params, step=step)
        assert torch.equal(got["w"], torch.full((256, 256), float(step)))
        assert int(got["s"]) == step and got["s"].shape == ()


def test_restore_raises_on_a_missing_or_mismatched_checkpoint(tmp_path):
    import pytest
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path, _tree())
    ck.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaf count"):
        ck.restore(tmp_path, {"a": torch.zeros(1)})


def test_layout_is_the_references(tmp_path):
    """The same files and manifest entries as the reference writes for
    the same tree: leaves in jax.tree order, bf16 as uint16 bits."""
    ck.save(tmp_path / "t", 3, _tree())
    jck.save(tmp_path / "j", 3, _jax_tree())
    mt = json.loads((tmp_path / "t/step_3/manifest.json").read_text())
    mj = json.loads((tmp_path / "j/step_3/manifest.json").read_text())
    assert mt["n_leaves"] == mj["n_leaves"] == 3
    assert mt["leaves"] == mj["leaves"]
    for i in range(3):
        a = np.load(tmp_path / f"t/step_3/arr_{i}.npy")
        b = np.load(tmp_path / f"j/step_3/arr_{i}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _state_trees(seed):
    """The port's and the reference's (params, AdamWState) with float32,
    bf16 and int32 leaves of the same values."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    h = rng.standard_normal((3, 5)).astype(np.float32)
    ids = rng.integers(-9, 9, (7,)).astype(np.int32)
    tp = {"w": torch.from_numpy(w), "h": torch.from_numpy(h).bfloat16(),
          "ids": torch.from_numpy(ids)}
    jp = {"w": jnp.asarray(w), "h": jnp.asarray(h, jnp.bfloat16),
          "ids": jnp.asarray(ids)}
    m = rng.standard_normal((4, 6)).astype(np.float32)
    tst = adamw.AdamWState(torch.tensor(7, dtype=torch.int32),
                           {"w": torch.from_numpy(m)},
                           {"w": torch.from_numpy(m * m)})
    from repro.optim import adamw as jadamw
    jst = jadamw.AdamWState(jnp.int32(7), {"w": jnp.asarray(m)},
                            {"w": jnp.asarray(m * m)})
    return (tp, tst), (jp, jst)


def _equal(torch_tree, jax_tree):
    tl, jl = tree_leaves(torch_tree), jax.tree.leaves(jax_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_port_restores_the_references_checkpoint(tmp_path):
    (tp, tst), (jp, jst) = _state_trees(0)
    jck.save(tmp_path, 4, (jp, jst))
    like = (tree_map(torch.zeros_like, tp), adamw.AdamWState(
        torch.zeros_like(tst.step), tree_map(torch.zeros_like, tst.m),
        tree_map(torch.zeros_like, tst.v)))
    got, step = ck.restore(tmp_path, like)
    assert step == 4 and isinstance(got[1], adamw.AdamWState)
    _equal(got, (jp, jst))


def test_reference_restores_the_ports_checkpoint(tmp_path):
    (tp, tst), (jp, jst) = _state_trees(1)
    ck.save(tmp_path, 5, (tp, tst))
    like = jax.tree.map(jnp.zeros_like, (jp, jst))
    got, step = jck.restore(tmp_path, like)
    assert step == 5
    _equal((tp, tst), got)
