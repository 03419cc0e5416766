"""The multi-tenant scheduler service (``repro_torch.sim.serve``) against the
JAX package's ``SchedServer``, and its own contracts.

Against JAX, on the same requests (a request's uniform is the draw behind
the JAX round key's ``k_sel``: ``uniform(split(key)[1], (N,))``):

* one tenant served 150 rounds on the offline round stream equals the JAX
  server's ``tenant_state`` and the port's own ``simulate_aoi_regret``:
  the port's every leaf bitwise (state, AoI, restarts); against JAX every
  leaf bitwise but ``mu_tilde``, the running mean (mu*d + r)/(d + 1),
  which XLA rounds differently by an ulp now and then, held at rtol 1e-6
  as in ``tests/test_torch_glr_cucb.py``;
* a 4-tenant trace with per-tenant hp overrides, short batches,
  same-tenant duplicates and the matcher gives the JAX server's
  assignments and states, bitwise (``mu_tilde`` as above).  ``log``/``sqrt`` differ by an ulp
  between XLA and torch on the CPU, so a trace may fork at an ulp-level
  near-tie: a fork passes only if, at the first differing request, the
  port's UCB keys, channel scores, matcher priorities or a GLR statistic
  and its threshold sit within 1e-5 relative.  Any other fork fails.

The port's own contracts (as ``tests/test_serve.py`` and
``tests/test_serve_scale.py`` hold the JAX server to them): padding rows
and bystander tenants untouched, batch splits invisible, hp overrides
equal config-level schedulers, membership, the O(1) free pool, and, on a
CUDA-looking slot ring, one call of the kernel's wrapper every step.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core.bandits import GLRCUCB as JaxGLRCUCB  # noqa: E402
from repro.core.channels import random_piecewise_env  # noqa: E402
from repro.sim import SchedServer as JaxServer  # noqa: E402
from repro.sim import ServeRequest as JaxRequest  # noqa: E402
from repro.sim import offline_round_stream as jax_round_stream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.bandits import GLRCUCB, AoIAware, MExp3, glr_threshold  # noqa: E402
from repro_torch.core.matching import AdaptiveMatcher  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.sim import SchedServer, ServeRequest, offline_round_stream  # noqa: E402
from repro_torch.sim.serve import _FreePool  # noqa: E402

KEY = jax.random.PRNGKey(0)
N, M = 6, 2
SCHED = dict(history=64, detector_stride=3, min_samples=4)
REL_TIE = 1e-5
JAX_CLOSE = ("mu_tilde",)      # the running mean rounds differently in XLA: rtol 1e-6


def _u(key):
    """The (N,) f32 uniform behind a JAX request key's ``k_sel``."""
    return np.array(jax.random.uniform(jax.random.split(key)[1], (N,)))


def _leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}{f}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree)


def _assert_same(a, b, close=()):
    """Every leaf bitwise, but those named in ``close`` at rtol 1e-6."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        if k.split("/")[-1] in close:
            np.testing.assert_allclose(la[k], lb[k], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _stream(key, rounds, n=N):
    """Bernoulli reward rows and round keys for traces."""
    states = np.asarray(jax.random.bernoulli(key, 0.6, (rounds, n)), np.float32)
    keys = np.asarray(jax.random.split(jax.random.fold_in(key, 1), rounds))
    return states, keys


def _tight(vals):
    """Whether two neighbours of ``vals`` sorted descending lie within REL_TIE."""
    v = torch.sort(vals.reshape(-1), descending=True).values
    gap = (v[:-1] - v[1:]).abs()
    return bool((gap <= REL_TIE * v[:-1].abs()).any())


def _near_tie(sched, row, rq, use_matching, beta=0.5):
    """Whether the port's row state meets request ``rq`` at an ulp-level
    near-tie: UCB keys, channel scores, matcher priorities, or a scheduled
    channel's GLR statistic against its threshold."""
    st, t = row.sched_state, int(row.t)
    u = torch.from_numpy(np.asarray(rq.u))
    aoi = row.aoi if rq.aoi is None else torch.from_numpy(np.asarray(rq.aoi))
    ucb = sched.ucb(st, t)
    key = torch.where(torch.isinf(ucb), 1e9, ucb) + torch.where(st.counts == 0, u * 1e6, 0.0)
    if _tight(torch.sort(key, descending=True).values[:M + 1]):
        return True
    channels, _ = sched.select(st, t, u, aoi)
    if use_matching:
        contrib = torch.ones(M) if rq.contrib is None else torch.from_numpy(
            np.asarray(rq.contrib, np.float32))
        matcher = AdaptiveMatcher(beta)
        lam, _ = matcher.priorities(row.matcher_state, contrib, aoi)
        if _tight(sched.channel_scores(st, t)[channels]) or _tight(lam):
            return True
        channels, _ = matcher.match(row.matcher_state, channels, sched.channel_scores(st, t),
                                    contrib, aoi)
    if t % sched.detector_stride:
        return False
    mask = torch.zeros(N, dtype=torch.bool).index_fill(0, channels, True)
    r_vec = torch.zeros(N).index_put((channels,), torch.from_numpy(
        np.asarray(rq.rewards, np.float32))[channels])
    *_, stats = ref.glr_step(st.cum, st.total, st.base, st.counts, r_vec, mask)
    thresh = glr_threshold((st.counts + mask.float()).clamp_max(float(sched.history))
                           .to(torch.int32), st.hp["delta"])
    gap = (stats - thresh).abs() <= REL_TIE * thresh.abs()
    return bool((gap & mask & torch.isfinite(stats)).any())


def _port_request(rq):
    return ServeRequest(rq.tenant, rq.rewards, _u(rq.key), rq.contrib, rq.aoi)


def _compare_traces(jserver, tserver, calls, use_matching):
    """Serve ``calls`` (lists of JAX requests) on both servers; on the
    first differing call, replay it request by request from the snapshots
    and require a near-tie at the first differing request.  Returns the
    fork's description, or None when the traces agree to the end."""
    for k, call in enumerate(calls):
        jsnap, tsnap = jserver._state, _clone(tserver._state)
        got = tserver.serve([_port_request(rq) for rq in call])
        want = jserver.serve(call)
        if all(np.array_equal(a, b) for a, b in zip(got, want)):
            continue
        jserver._state, tserver._state = jsnap, tsnap
        for rq in call:
            row = tserver.tenant_state(rq.tenant)
            a = tserver.serve([_port_request(rq)])[0]
            b = jserver.serve([rq])[0]
            if not np.array_equal(a, b):
                assert _near_tie(tserver.scheduler, row, _port_request(rq), use_matching), (
                    f"fork at call {k}, tenant {rq.tenant!r} without a near-tie: "
                    f"jax {b}, port {a}")
                return f"call {k}, tenant {rq.tenant!r}"
        raise AssertionError(f"call {k} differs served together but not one by one")
    return None


def _clone(x):
    if hasattr(x, "_fields"):
        return type(x)(*[_clone(y) for y in x])
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone()


# ---------------------------------------------------------------------------
# against the JAX server
# ---------------------------------------------------------------------------

def test_single_tenant_matches_jax_server_and_offline_run():
    t_rounds = 150
    jsched = JaxGLRCUCB(N, M, delta=0.5, **SCHED)     # a confidence that restarts in 150 rounds
    tsched = GLRCUCB(N, M, delta=0.5, **SCHED)
    env = random_piecewise_env(KEY, N, t_rounds, 3)
    keys, states = jax_round_stream(env, KEY, t_rounds)
    keys, states = np.asarray(keys), np.asarray(states, np.float32)
    uniforms = np.stack([np.stack([np.array(jax.random.uniform(k2, (N,)))
                                   for k2 in jax.random.split(k)]) for k in keys])
    tenv = convert.channel_env(env.form, env.means, env.breaks, env.table, device="cpu")

    # the port's stream is the JAX stream: same states, the k_sel uniforms
    u_sel, tstates = offline_round_stream(tenv, torch.from_numpy(uniforms), t_rounds)
    np.testing.assert_array_equal(tstates.numpy(), states)
    np.testing.assert_array_equal(u_sel.numpy(), uniforms[:, 1])

    jserver = JaxServer(jsched, capacity=4, slots=3, donate=False)
    tserver = SchedServer(tsched, capacity=4, slots=3, device="cpu")
    jserver.join("job", key=KEY)
    tserver.join("job")
    calls = [[JaxRequest("job", states[t], keys[t])] for t in range(t_rounds)]
    fork = _compare_traces(jserver, tserver, calls, use_matching=False)
    row = tserver.tenant_state("job")
    if fork is None:
        _assert_same(jserver.tenant_state("job"), row, close=JAX_CLOSE)
    else:
        print(f"single tenant: the trajectories fork at an ulp-level near-tie ({fork})")

    off = simulate_aoi_regret(tsched, tenv, t_rounds, uniforms=torch.from_numpy(uniforms),
                              collect_curve=False, return_state=True, device="cpu")
    _assert_same(off["final_sched_state"], row.sched_state)
    assert torch.equal(off["aoi_pi"], row.aoi)
    assert int(off["restarts"]) == int(row.sched_state.restarts) > 0
    assert int(row.t) == int(row.decisions) == t_rounds


def test_four_tenant_trace_with_matching_matches_jax():
    """hp overrides, short batches (slots=3, calls of 1-5 requests), a
    tenant twice in one call (deferred), per-request contributions and AoI
    overrides, the Sec.-V matcher."""
    jsched = JaxGLRCUCB(N, M, **SCHED)
    tsched = GLRCUCB(N, M, **SCHED)
    kw = dict(capacity=6, slots=3, use_matching=True)
    jserver = JaxServer(jsched, donate=False, **kw)
    tserver = SchedServer(tsched, device="cpu", **kw)
    tenants = ["a", "b", "c", "d"]
    for i, tid in enumerate(tenants):
        hp = {"gamma": 0.6 + 0.3 * i, "delta": 0.01 * (i + 1)}
        jserver.join(tid, key=jax.random.fold_in(KEY, i), hp=hp)
        tserver.join(tid, hp=hp)
    rng = np.random.default_rng(5)
    states, keys = _stream(jax.random.fold_in(KEY, 11), 160)
    calls, j = [], 0
    while j < 150:
        size = int(rng.integers(1, 6))
        call = []
        for _ in range(size):
            tid = tenants[int(rng.integers(0, 4))]
            contrib = rng.random(M).astype(np.float32) if rng.random() < 0.5 else None
            aoi = rng.integers(1, 6, M).astype(np.float32) if rng.random() < 0.3 else None
            call.append(JaxRequest(tid, states[j], keys[j], contrib=contrib, aoi=aoi))
            j += 1
        calls.append(call)
    assert any(len({rq.tenant for rq in c}) < len(c) for c in calls), "no duplicate in a call"
    fork = _compare_traces(jserver, tserver, calls, use_matching=True)
    if fork is None:
        for tid in tenants:
            _assert_same(jserver.tenant_state(tid), tserver.tenant_state(tid), close=JAX_CLOSE)
    else:
        print(f"four tenants: the traces fork at an ulp-level near-tie ({fork})")


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def _server(**kw):
    cfg = dict(capacity=4, slots=3, device="cpu")
    cfg.update(kw)
    return SchedServer(GLRCUCB(N, M, **SCHED), **cfg)


def _requests(tid, states, keys, rounds, start=0):
    return [ServeRequest(tid, states[t], _u(keys[t])) for t in range(start, start + rounds)]


def test_pad_rows_and_bystander_tenants_untouched():
    server = _server()
    server.join("a")
    server.join("b")
    server.join("gone")
    server.leave("gone")
    states, keys = _stream(jax.random.fold_in(KEY, 3), 8)
    snap = [x.clone() for _, x in _leaves_t(server._state)]
    for rq in _requests("a", states, keys, 8):
        assert server.serve([rq])[0].shape == (M,)
    a = server.tenants["a"]
    for before, (name, after) in zip(snap, _leaves_t(server._state)):
        keep = torch.ones(before.shape[0], dtype=torch.bool)
        keep[a] = False
        assert torch.equal(before[keep], after[keep]), name
    assert int(server.tenant_state("a").t) == 8


def _leaves_t(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves_t(getattr(tree, f), f"{prefix}{f}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_t(tree[k], f"{prefix}{k}/")
    else:
        yield prefix, tree


@pytest.mark.parametrize("use_matching", [False, True], ids=["policy", "matched"])
def test_batch_splits_and_duplicate_deferral_invisible(use_matching):
    states, keys = _stream(jax.random.fold_in(KEY, 4), 9)
    reqs = [ServeRequest(tid, states[j], _u(keys[j]))
            for j, tid in enumerate(["x", "y", "x", "y", "x", "x", "z", "y", "x"])]

    def run(slots, splits):
        server = _server(slots=slots, use_matching=use_matching)
        for tid in ("x", "y", "z"):
            server.join(tid)
        out, start = [], 0
        for end in splits + [len(reqs)]:
            out += server.serve(reqs[start:end])
            start = end
        return out, [server.tenant_state(t) for t in ("x", "y", "z")]

    one = run(3, [])
    for other in (run(3, [1, 4]), run(2, []), run(1, [2])):
        for a, b in zip(one[0], other[0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(one[1], other[1]):
            _assert_same(a, b)


def test_hp_override_matches_config_level_scheduler():
    states, keys = _stream(jax.random.fold_in(KEY, 5), 40)

    def run(server, hp=None):
        server.join("hot", hp=hp)
        for rq in _requests("hot", states, keys, 40):
            server.serve([rq])
        return server.tenant_state("hot")

    via_hp = run(_server(capacity=2, slots=2), hp={"gamma": 0.25})
    via_cfg = run(SchedServer(GLRCUCB(N, M, gamma=0.25, **SCHED), capacity=2, slots=2,
                              device="cpu"))
    _assert_same(via_hp, via_cfg)


def test_membership_lifecycle_and_errors():
    server = _server(capacity=2, slots=1)
    server.join("a")
    server.join("b")
    with pytest.raises(ValueError, match="already live"):
        server.join("a")
    with pytest.raises(RuntimeError, match="at capacity"):
        server.join("c")
    with pytest.raises(ValueError, match="unknown hyper-parameters"):
        _server().join("bad", hp={"learning_rate": 0.1})
    with pytest.raises(KeyError):
        server.leave("nope")
    with pytest.raises(KeyError):
        server.serve([ServeRequest("nope", np.zeros(N, np.float32), np.zeros(N, np.float32))])
    states, keys = _stream(jax.random.fold_in(KEY, 6), 3)
    server.serve(_requests("a", states, keys, 1))
    assert int(server.tenant_state("a").t) == 1
    server.leave("a")
    server.join("a")                 # re-join: fresh clock and state
    assert int(server.tenant_state("a").t) == 0
    assert set(server.tenants) == {"a", "b"}
    server.leave("b")
    server.join("c")                 # a freed slot admits again
    assert set(server.tenants) == {"a", "c"}


def test_server_refuses_what_it_does_not_serve():
    # what the reference's server serves is served: M-Exp3 (not GLR-CUCB)
    # and the recompute detector, once refused here, now answer a request
    states, keys = _stream(jax.random.fold_in(KEY, 10), 1)
    for sched in (MExp3(N, M, gamma=0.5),
                  GLRCUCB(N, M, history=16, detector_impl="recompute")):
        server = SchedServer(sched, capacity=2, slots=1, device="cpu")
        server.join("a")
        assert server.serve(_requests("a", states, keys, 1))[0].shape == (M,)
    with pytest.raises(ValueError, match="not a served policy"):
        SchedServer(object(), device="cpu")
    # AoI-Aware: the reference's server cannot serve it either
    with pytest.raises(ValueError, match="AoI-Aware is not served"):
        SchedServer(AoIAware(GLRCUCB(N, M, history=16)), device="cpu")
    with pytest.raises(ValueError, match="no super-arm"):
        SchedServer(MExp3(2, 3), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        _server(mesh=object())
    with pytest.raises(ValueError, match="capacity"):
        _server(capacity=0)
    with pytest.raises(ValueError, match="slots"):
        _server(slots=0)
    with pytest.raises(ValueError, match="score_kind"):
        _server(score_kind="median")


def test_free_pool_is_capacity_independent():
    t0 = time.perf_counter()
    pool = _FreePool(10**8)
    assert time.perf_counter() - t0 < 0.01, "construction scaled with capacity"
    assert len(pool) == 10**8
    slots = [pool.pop() for _ in range(100)]
    assert slots == list(range(100))
    t0 = time.perf_counter()
    for _ in range(10_000):
        pool.push(pool.pop())
    assert time.perf_counter() - t0 < 0.5
    pool.push(slots.pop())
    assert pool.pop() == 99
    assert len(pool) == 10**8 - 100


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one: the kernel dispatch
    routes on ``is_cuda``."""

    @property
    def is_cuda(self):
        return True


def _with_cum(server, cls):
    ss = server._state.sched_state
    server._state = server._state._replace(sched_state=ss._replace(cum=ss.cum.as_subclass(cls)))


@pytest.mark.parametrize("use_matching", [False, True], ids=["policy", "matched"])
def test_every_served_step_calls_the_kernel_on_cuda(monkeypatch, use_matching):
    """On a CUDA-looking slot ring every serve step goes to the in-place
    kernel's wrapper once, whether a row of it detects or not, and the
    plain append never runs outside it; decisions and states equal a CPU
    server's bit for bit.  The kernel is stood in for by its plain version."""
    from repro_torch.kernels import ops

    real_append, inside, calls = ref.glr_tenants_append, [], []

    def append(*a):
        assert inside, "the plain append ran outside the kernel"
        return real_append(*a)

    def kernel(*a, split_grid):
        calls.append(int(a[5].sum()))
        inside.append(True)
        try:
            return ref.glr_step_tenants(*a, split_grid=split_grid)
        finally:
            inside.pop()

    monkeypatch.setattr(ref, "glr_tenants_append", append)
    monkeypatch.setattr(ops._gst, "glr_step_tenants", kernel)
    states, keys = _stream(jax.random.fold_in(KEY, 8), 40)
    servers = [_server(capacity=4, slots=2, use_matching=use_matching) for _ in range(2)]
    _with_cum(servers[1], _CudaLooking)
    out = []
    for server in servers:
        for tid in ("a", "b", "c"):
            server.join(tid)
        inside.append(server is servers[0])      # the CPU server runs the plain version
        got = []
        for j in range(20):
            tids = ["a", "b"] if j % 3 else ["c"]
            got += server.serve([ServeRequest(t, states[j], _u(keys[j])) for t in tids])
            if j == 10:
                server.leave("b")
                server.join("b")
        inside.pop()
        out.append(got)
    card = servers[1]
    assert len(calls) == card.stats()["steps"] == 20
    assert 0 in calls and max(calls) > 0         # steps with and without a detecting row
    _with_cum(card, torch.Tensor)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    for tid in ("a", "b", "c"):
        _assert_same(servers[0].tenant_state(tid), card.tenant_state(tid))


def test_shard_is_the_identity_on_one_device():
    states, keys = _stream(jax.random.fold_in(KEY, 9), 12)
    out = []
    for shard in (False, True):
        server = _server(shard=shard)
        assert server.rows == server.capacity + 1
        server.join("a")
        out.append((server.serve(_requests("a", states, keys, 12)), server.tenant_state("a")))
        assert server.stats()["sharded"] is shard
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
    _assert_same(out[0][1], out[1][1])
