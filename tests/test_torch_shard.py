"""Sharded sweep buckets on the port's one card (``repro_torch.sim.shard``).

The JAX package's ``tests/test_shard.py``, held on the port: the padding
helpers at any device count (pad rows cycle the entries, ``i % B``, and
are sliced off again), the sharded engine bit for bit equal to the
unsharded one on a one-device mesh (divisible, uneven and hp-grid batches,
and ``sweep(shard=True)``), padded rows that do not touch the real ones,
and the axis rule.  The JAX file's multi-device tests have no port
counterpart: a mesh of several devices raises (the port runs a bucket on
one card).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core.bandits.base import stack_params  # noqa: E402
from repro_torch.core.channels import random_piecewise_env, stack_envs  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    SweepCase,
    pad_batch,
    sharded_aoi_regret_batch,
    simulate_aoi_regret_batch,
    sweep,
    sweep_mesh,
    unpad_batch,
)
from test_torch_sim_engine import _bitwise  # noqa: E402

T = 300
CPU = dict(device="cpu")
CPU_MESH = sweep_mesh(["cpu"])


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _envs(b, seed0=0):
    return stack_envs([random_piecewise_env(_gen(seed0 + i), 5, T, 2, **CPU) for i in range(b)])


def _u(seed, b):
    return torch.rand((b, T, 2, 5), generator=_gen(seed))


@pytest.mark.parametrize("b,mult,expect", [
    (3, 4, 4), (5, 4, 8), (8, 4, 8), (1, 4, 4), (6, 1, 6), (2, 8, 8),
])
def test_pad_batch_rounds_up_and_cycles_entries(b, mult, expect):
    tree = {"a": torch.arange(b), "m": torch.arange(2 * b).reshape(b, 2)}
    padded, orig = pad_batch(tree, mult)
    assert orig == b
    assert padded["a"].shape == (expect,)
    assert padded["m"].shape == (expect, 2)
    np.testing.assert_array_equal(padded["a"].numpy(), np.arange(expect) % b)
    back = unpad_batch(padded, orig)
    for k in tree:
        assert torch.equal(back[k], tree[k])


def test_pad_batch_noop_when_divisible_returns_same_tree():
    tree = {"a": torch.arange(8)}
    padded, b = pad_batch(tree, 4)
    assert b == 8 and padded is tree


def test_pad_batch_rejects_inconsistent_leading_axes():
    with pytest.raises(ValueError, match="inconsistent"):
        pad_batch({"a": torch.arange(3), "b": torch.arange(4)}, 2)


def test_pad_batch_pads_a_stacked_env():
    envs = _envs(3)
    padded, b = pad_batch(envs, 4)
    assert b == 3 and padded.means.shape[0] == 4
    assert torch.equal(padded.means[3], envs.means[0])
    assert torch.equal(padded.breaks[3], envs.breaks[0])


def test_sharded_matches_unsharded_bitwise():
    sched = tb.GLRCUCB(5, 2, history=64, detector_stride=4)
    envs, u = _envs(2), _u(100, 2)
    want = simulate_aoi_regret_batch(sched, envs, T, uniforms=u, **CPU)
    got = sharded_aoi_regret_batch(sched, envs, T, uniforms=u, mesh=CPU_MESH)
    _bitwise(want, got)


def test_sharded_uneven_batch_pads_and_unpads():
    sched = tb.ChannelAwareAsync(5, 2)
    envs = _envs(2)
    want = simulate_aoi_regret_batch(sched, envs, T, generator=_gen(200), **CPU)
    got = sharded_aoi_regret_batch(sched, envs, T, generator=_gen(200), **CPU)
    assert got["final_regret"].shape == (2,)
    _bitwise(want, got)


def test_padded_rows_do_not_corrupt_results():
    """pad -> run -> unpad == run, at a batch padded to 4 by hand."""
    b, mult = 3, 4
    sched = tb.GLRCUCB(5, 2, history=64, detector_stride=4)
    envs, u = _envs(b), _u(300, b)
    want = simulate_aoi_regret_batch(sched, envs, T, uniforms=u, **CPU)
    got = unpad_batch(simulate_aoi_regret_batch(sched, pad_batch(envs, mult)[0], T,
                                                uniforms=pad_batch(u, mult)[0], **CPU), b)
    _bitwise(want, got)


def test_sharded_hp_grid_matches_unsharded():
    env = random_piecewise_env(_gen(0), 5, T, 2, **CPU)
    rep = tb.GLRCUCB(5, 2, history=64, detector_stride=4)
    hp = stack_params([rep.replace_traced(gamma=g) for g in (0.5, 0.8, 1.1, 1.4, 1.7)], "cpu")
    u = _u(1, 1)[0]
    kw = dict(uniforms=u, env_axis=None, uniforms_axis=None, hparams=hp, hp_axis=0)
    want = simulate_aoi_regret_batch(rep, env, T, **kw, **CPU)
    got = sharded_aoi_regret_batch(rep, env, T, mesh=CPU_MESH, **kw)
    _bitwise(want, got)


def test_sharded_requires_some_axis():
    env = random_piecewise_env(_gen(0), 5, T, 2, **CPU)
    with pytest.raises(ValueError, match="nothing to batch"):
        sharded_aoi_regret_batch(tb.RandomScheduler(5, 2), env, T, env_axis=None,
                                 uniforms_axis=None, hp_axis=None, mesh=CPU_MESH)


def test_a_mesh_of_several_devices_is_refused():
    with pytest.raises(ValueError, match="one card"):
        sharded_aoi_regret_batch(tb.RandomScheduler(5, 2), _envs(2), T,
                                 mesh=sweep_mesh(["cpu", "cpu"]))


def test_mesh_lists_its_devices():
    mesh = sweep_mesh(["cpu"])
    assert mesh.devices == (torch.device("cpu"),) and mesh.axis_names == ("cases",)


def test_sweep_shard_path_bitwise_identical_to_unsharded():
    env = random_piecewise_env(_gen(0), 5, T, 2, **CPU)
    base = tb.GLRCUCB(5, 2, history=64, detector_stride=4)
    cases = ([SweepCase(f"g{i}", base.replace_traced(delta=d), env, i, T)
              for i, d in enumerate([1e-2, 1e-3, 1e-4])]
             + [SweepCase("rand", tb.RandomScheduler(5, 2), env, 0, T)])
    plain, _ = sweep(cases, **CPU)
    sharded, report = sweep(cases, shard=True, **CPU)
    assert all(r.sharded for r in report)
    for name in plain:
        _bitwise(plain[name], sharded[name], name)
