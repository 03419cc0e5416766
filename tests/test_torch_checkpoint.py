"""Checkpoints of the port's state (``repro_torch.checkpoint.io``).

Nested NamedTuples and dicts of f32, int32, bool and bf16 tensors come
back bitwise with their dtypes (bf16 widened to f32 on disk and narrowed
on restore), into fresh memory; the newest step is found; writes leave no
temporary files; ``like`` decides each leaf's dtype and device.
"""
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402


class Inner(NamedTuple):
    a: torch.Tensor
    flags: torch.Tensor


class Outer(NamedTuple):
    inner: Inner
    hp: dict
    count: torch.Tensor
    half: torch.Tensor


def _tree(seed):
    rng = np.random.default_rng(seed)
    return Outer(
        inner=Inner(a=torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
                    flags=torch.from_numpy(rng.random(5) < 0.5)),
        hp={"gamma": torch.tensor(0.8), "delta": torch.tensor(1e-3)},
        count=torch.from_numpy(rng.integers(-5, 5, (2, 3)).astype(np.int32)),
        half=torch.from_numpy(rng.standard_normal(6).astype(np.float32)).to(torch.bfloat16))


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


def test_round_trip_is_bitwise_with_dtypes(tmp_path):
    tree = _tree(0)
    path = save_checkpoint(str(tmp_path), 3, tree)
    assert os.path.basename(path) == "step_3.npz"
    like = _tree(1)
    got, step = restore_checkpoint(str(tmp_path), like=like)
    assert step == 3
    assert _same(got, tree)
    assert got.inner.a.data_ptr() != like.inner.a.data_ptr()
    assert sorted(os.listdir(tmp_path)) == ["step_3.json", "step_3.npz"]   # no temporaries


def test_flat_restore_and_paths(tmp_path):
    save_checkpoint(str(tmp_path), 0, _tree(0))
    flat, step = restore_checkpoint(str(tmp_path))
    assert step == 0
    assert sorted(flat) == ["count", "half", "hp/delta", "hp/gamma", "inner/a", "inner/flags"]
    assert flat["half"].dtype == np.float32                 # bf16 widened on disk
    assert flat["inner/flags"].dtype == bool and flat["count"].dtype == np.int32


def test_latest_step_and_missing_directory(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    for step in (2, 10, 7):
        save_checkpoint(str(tmp_path), step, _tree(step))
    assert latest_step(str(tmp_path)) == 10
    got, step = restore_checkpoint(str(tmp_path), like=_tree(0))
    assert step == 10 and _same(got, _tree(10))
    got, step = restore_checkpoint(str(tmp_path), step=2, like=_tree(0))
    assert _same(got, _tree(2))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


def test_like_decides_dtype():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        tree = _tree(4)
        save_checkpoint(d, 1, tree)
        like = tree._replace(count=tree.count.to(torch.int64), half=tree.half.float())
        got, _ = restore_checkpoint(d, like=like)
        assert got.count.dtype == torch.int64 and torch.equal(got.count, tree.count.long())
        assert got.half.dtype == torch.float32 and torch.equal(got.half, tree.half.float())
