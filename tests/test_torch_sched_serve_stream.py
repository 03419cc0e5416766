"""The scheduler service's pipelined loop, boundary hygiene, crash recovery
and launcher (``repro_torch.sim.serve``, ``repro_torch.launch.sched_serve``),
held to the contracts ``tests/test_serve_scale.py`` and
``tests/test_serve_restore.py`` hold the JAX server to:

* ``serve_stream`` equals ``serve()`` bitwise over the same trace, with
  churn between flushed segments and autosized steps of several sizes,
  and with same-tenant duplicates deferred alike;
* a reward vector with NaN/inf/out-of-range entries serves like its
  clipped twin and counts once in ``bad_rewards``; clean streams count
  nothing;
* a server saved mid-stream and restored into a fresh one continues the
  decision stream bitwise; counters and slots survive; a snapshot of
  another geometry or scheduler, or none at all, is refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.bandits import GLRCUCB  # noqa: E402
from repro_torch.launch import sched_serve  # noqa: E402
from repro_torch.sim import SchedServer, ServeRequest  # noqa: E402

N, M = 6, 2
SCHED = dict(history=32, detector_stride=3, min_samples=4)


def _server(**kw):
    cfg = dict(capacity=8, slots=4, device="cpu")
    cfg.update(kw)
    return SchedServer(GLRCUCB(N, M, **SCHED), **cfg)


def _traffic(seed, rounds):
    rng = np.random.default_rng(seed)
    return ((rng.random((rounds, N)) < 0.6).astype(np.float32),
            rng.random((rounds, N)).astype(np.float32))


def _trace(tenants, states, uniforms, n):
    return [ServeRequest(tenants[j % len(tenants)], states[j], uniforms[j]) for j in range(n)]


def _same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))


def _flat(tree):
    if hasattr(tree, "_fields"):
        return [x for f in tree for x in _flat(f)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def _join(server, tenants):
    for i, tid in enumerate(tenants):
        server.join(tid, hp={"gamma": 0.7 + 0.1 * i})


@pytest.mark.parametrize("use_matching", [False, True], ids=["policy", "matched"])
def test_stream_matches_serve_bitwise(use_matching):
    tenants = [f"t{i}" for i in range(5)]
    states, uniforms = _traffic(0, 60)
    reqs = _trace(tenants, states, uniforms, 60)
    a, b = _server(use_matching=use_matching), _server(use_matching=use_matching)
    _join(a, tenants)
    _join(b, tenants)
    want = a.serve(reqs)
    got = dict(b.serve_stream(iter(reqs), autosize=False))
    assert sorted(got) == list(range(60))
    for i in range(60):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i}")
    assert _same_state(a._state, b._state)


def test_stream_with_churn_and_resizes_matches_serve():
    tenants = [f"t{i}" for i in range(6)]
    states, uniforms = _traffic(7, 41)
    seg_lens = [11, 3, 17, 1, 9]
    bounds = np.cumsum([0] + seg_lens)
    segs = [[ServeRequest(tenants[j % 6], states[j], uniforms[j])
             for j in range(bounds[s], bounds[s + 1])] for s in range(len(seg_lens))]

    def churn(server, s):
        server.leave(tenants[s % 6])
        server.join(tenants[s % 6], hp={"gamma": 0.5 + 0.1 * s})

    a = _server()
    _join(a, tenants)
    want = []
    for s, seg in enumerate(segs):
        want.extend(a.serve(seg))
        churn(a, s)

    b = _server()
    _join(b, tenants)
    b.warm()
    assert set(b._templates) == set(b._ladder) == {1, 2, 4}

    def source():
        for s, seg in enumerate(segs):
            yield from seg
            yield None              # flush the segment before churning
            churn(b, s)

    got = dict(b.serve_stream(source(), autosize=True))
    assert sorted(got) == list(range(int(bounds[-1])))
    for i in range(int(bounds[-1])):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i}")
    assert _same_state(a._state, b._state)
    assert len(b.stats()["sizes_used"]) >= 2, "the autosizer never resized"


def test_stream_defers_same_tenant_duplicates_like_serve():
    tenants = ["a", "b"]            # a pool smaller than the slot batch
    states, uniforms = _traffic(9, 24)
    reqs = _trace(tenants, states, uniforms, 24)
    a, b = _server(), _server()
    _join(a, tenants)
    _join(b, tenants)
    want = a.serve(reqs)
    got = dict(b.serve_stream(iter(reqs), autosize=False))
    for i in range(24):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"request {i}")
    assert _same_state(a._state, b._state)


# ---------------------------------------------------------------------------
# reward sanitization
# ---------------------------------------------------------------------------

def _two_tenant_requests(t0, t1, dirty=False):
    """Tenants a and b over rounds [t0, t1); ``dirty`` corrupts a's vector
    on every third round."""
    reqs = []
    for t in range(t0, t1):
        rng = np.random.default_rng(500 + t)
        rows = (rng.random((2, N)) < 0.6).astype(np.float32)
        us = rng.random((2, N)).astype(np.float32)
        for i, tenant in enumerate(("a", "b")):
            r = rows[i].copy()
            if dirty and tenant == "a" and t % 3 == 0:
                r[0], r[1], r[2] = np.nan, np.inf, -4.0
            reqs.append(ServeRequest(tenant, r, us[i]))
    return reqs


def _mk_two():
    server = _server(capacity=4, slots=4)
    server.join("a")
    server.join("b")
    return server


def _drain(server, reqs):
    out = [None] * len(reqs)
    for i, asg in server.serve_stream(reqs):
        out[i] = np.asarray(asg)
    return out


def test_clean_streams_are_untouched_and_unbilled():
    server = _mk_two()
    out = _drain(server, _two_tenant_requests(0, 8))
    assert len(out) == 16 and all(a is not None for a in out)
    assert server.stats()["bad_rewards"] == {}


def test_dirty_stream_serves_like_its_clipped_twin_and_bills_once_a_request():
    reqs = _two_tenant_requests(0, 9, dirty=True)
    clipped = [ServeRequest(rq.tenant, np.clip(np.where(np.isfinite(rq.rewards), rq.rewards,
                                                        0.0), 0.0, 1.0).astype(np.float32),
                            rq.u) for rq in reqs]
    dirty_server = _mk_two()
    a = _drain(dirty_server, reqs)
    b = _drain(_mk_two(), clipped)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert dirty_server.stats()["bad_rewards"] == {"a": 3}       # rounds 0, 3, 6


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------

def test_kill_mid_stream_save_restore_resumes_bitwise(tmp_path):
    full = _drain(_mk_two(), _two_tenant_requests(0, 20))
    crashed = _mk_two()
    first = _drain(crashed, _two_tenant_requests(0, 10))
    crashed.save(str(tmp_path), step=10)
    del crashed                                  # the "crash"
    revived = _mk_two()
    assert revived.restore(str(tmp_path), warm=False) == 10
    second = _drain(revived, _two_tenant_requests(10, 20))
    assert len(first) + len(second) == len(full)
    for x, y in zip(first + second, full):
        np.testing.assert_array_equal(x, y)


def test_restore_carries_counters_slots_and_clocks(tmp_path):
    server = _mk_two()
    server.join("c")
    server.leave("a")
    _drain(server, [rq for rq in _two_tenant_requests(0, 9, dirty=True) if rq.tenant == "b"])
    before = server.stats()
    server.save(str(tmp_path))
    revived = _mk_two()
    revived.restore(str(tmp_path))
    after = revived.stats()
    for k in ("tenants", "served", "steps", "stream_steps", "rows_dispatched",
              "bad_rewards", "sizes_used"):
        assert after[k] == before[k], k
    assert revived.tenants == server.tenants
    assert revived._free._recycled == server._free._recycled
    assert _same_state(revived._state, server._state)
    assert revived.join("d") == server.join("d")   # the free pool's order survives
    out = _drain(revived, _two_tenant_requests(9, 12)[1::2])
    assert len(out) == 3 and all(a is not None for a in out)


def test_restore_rejects_mismatched_geometry(tmp_path):
    server = _mk_two()
    _drain(server, _two_tenant_requests(0, 4))
    server.save(str(tmp_path))
    with pytest.raises(ValueError, match="capacity"):
        _server(capacity=8, slots=4).restore(str(tmp_path), warm=False)
    with pytest.raises(ValueError, match="slots"):
        _server(capacity=4, slots=2).restore(str(tmp_path), warm=False)
    other = SchedServer(GLRCUCB(N, M, history=64), capacity=4, slots=4, device="cpu")
    with pytest.raises(ValueError, match="scheduler configuration"):
        other.restore(str(tmp_path), warm=False)


def test_restore_into_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        _mk_two().restore(str(tmp_path / "nothing"), warm=False)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_on_the_cpu(capsys):
    sched_serve.main(["--tenants", "6", "--slots", "4", "--requests", "40", "--history", "16",
                      "--churn-stride", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(ln.startswith("[sched-serve]") for ln in out)
    assert "joined 6 tenants" in out[1]
    assert "decisions/s" in out[2] and "p99=" in out[3] and "churn_events=" in out[3]


def test_launch_functions_count_and_time_on_the_cpu():
    server = _server(capacity=6, slots=4)
    tenants = [f"job-{i}" for i in range(6)]
    _join(server, tenants)
    states, uniforms = sched_serve.make_traffic(6, N, 64, rounds=4, seed=1)
    assert states.shape == (4, 6, N) and uniforms.shape == (64, N)
    assert sched_serve.saturated_throughput(server, tenants, states, uniforms, 16) > 0
    arrivals = np.cumsum(np.full(24, 1e-4))
    lat, wall, churn = sched_serve.poisson_episode(server, tenants, states, uniforms, arrivals,
                                                   churn_stride=2)
    assert lat.shape == (24,) and (lat >= 0).all() and wall > 0 and churn >= 1
    assert server.stats()["served"] == 16 + 24
