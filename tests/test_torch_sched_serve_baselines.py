"""The scheduler service (``repro_torch.sim.serve``) for every policy the JAX
``SchedServer`` serves besides streaming GLR-CUCB: M-Exp3 (with and
without Exp3.S sharing), random, round-robin, channel-aware, Lyapunov and
GLR-CUCB's recompute detector.

A request's uniform is the policy's own draw on the JAX request key's
``k_sel`` (``selection_uniform`` of ``tests/test_torch_baselines.py``).

Against the port's own offline run: one tenant served 150 rounds of
``offline_round_stream`` equals ``simulate_aoi_regret`` on the same
uniforms bit for bit (every state leaf, AoI, restarts).

Against the JAX server, on the same requests: the assignments, AoI,
clocks, counters, restarts and every count bit for bit; M-Exp3's
``log_w`` (``logsumexp``/``logaddexp``/``exp``), channel-aware's EMA
``p_hat``, Lyapunov's discounted ``mu_sum``/``pulls`` (XLA contracts the
discount's multiply-add) and GLR-CUCB's running mean ``mu_tilde`` at rtol
1e-5, JAX's own serving tolerance (``tests/test_serve.py``).  A trace may
fork only where a policy's decision goes through an operation XLA and
torch round apart, and only at a near-tie within 1e-5 relative at the
first differing request; ``FORKS`` names each policy that may fork and
why.  Random and round-robin may not fork.

The service's own contracts for these policies: padding rows and
bystander tenants untouched, batch splits and ``serve_stream`` invisible,
a server killed mid-stream resumed by ``restore`` bit for bit, ``join``'s
hp per policy; the FL trainers' ``run_served`` equal to ``run()`` bit for
bit (dense M-Exp3 with the matcher, sparse Lyapunov) and the dense run
against JAX's ``run_served``; on CUDA-looking slot tensors one tenant
``glr_scan`` call a recompute step and no kernel call for the others.
AoI-Aware is refused (so is it by the JAX server).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bandits as jb  # noqa: E402
from repro.core.channels import make_piecewise as jax_make_piecewise  # noqa: E402
from repro.core.channels import random_piecewise_env  # noqa: E402
from repro.fl import AsyncFLConfig as JaxConfig  # noqa: E402
from repro.fl import AsyncFLTrainer as JaxTrainer  # noqa: E402
from repro.sim import SchedServer as JaxServer  # noqa: E402
from repro.sim import ServeRequest as JaxRequest  # noqa: E402
from repro.sim import offline_round_stream as jax_round_stream  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bandits as tb  # noqa: E402
from repro_torch.core.availability import MarkovChurn  # noqa: E402
from repro_torch.core.bandits import glr_threshold  # noqa: E402
from repro_torch.core.channels import make_piecewise, make_scenario  # noqa: E402
from repro_torch.core.matching import AdaptiveMatcher  # noqa: E402
from repro_torch.core.regret import simulate_aoi_regret  # noqa: E402
from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer, SparseAsyncFLTrainer, SparseFLConfig  # noqa: E402,E501
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.sim import SchedServer, ServeRequest, offline_round_stream  # noqa: E402
from test_torch_baselines import near_tie, selection_uniform  # noqa: E402

KEY = jax.random.PRNGKey(0)
N, M, T = 6, 2, 150
REL_TIE = 1e-5
GLR = dict(history=64, detector_stride=3, min_samples=4)


def pair(name, n=N, m=M):
    """(JAX policy, port policy) of a served policy form."""
    mk = {
        "random": lambda p: p.RandomScheduler(n, m),
        "round-robin": lambda p: p.RoundRobinScheduler(n, m),
        "channel-aware": lambda p: p.ChannelAwareAsync(n, m),
        "lyapunov": lambda p: p.LyapunovSched(n, m),
        "m-exp3": lambda p: p.MExp3(n, m, gamma=0.5, share_alpha=1e-3),
        "m-exp3-plain": lambda p: p.MExp3(n, m, gamma=0.5),
        # a confidence that restarts within 150 rounds
        "glr-recompute": lambda p: p.GLRCUCB(n, m, delta=0.5, detector_impl="recompute", **GLR),
    }[name]
    return mk(jb), mk(tb)


POLICIES = ("random", "round-robin", "channel-aware", "lyapunov", "m-exp3", "m-exp3-plain",
            "glr-recompute")
# the leaves held at rtol 1e-5 against JAX, by policy (the rest bitwise)
CLOSE = {"channel-aware": ("p_hat",), "lyapunov": ("mu_sum", "pulls"),
         "m-exp3": ("log_w",), "m-exp3-plain": ("log_w",), "glr-recompute": ("mu_tilde",)}
# the policies whose trace may fork from JAX's, at a near-tie only, and why
FORKS = {
    "channel-aware": "the Gumbel noise goes through log",
    "lyapunov": "the discounted mean (contracted by XLA) ranks the channels",
    "m-exp3": "the super-arm CDF goes through logsumexp and exp",
    "m-exp3-plain": "the super-arm CDF goes through logsumexp and exp",
    "glr-recompute": "the UCB goes through log and sqrt, the GLR statistic through log",
}


def _leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}{f}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree)


def assert_same(a, b, close=()):
    """Every leaf bitwise, but those named in ``close`` at rtol 1e-5."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        if k.split("/")[-1] in close:
            np.testing.assert_allclose(la[k], lb[k], rtol=REL_TIE, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _tight(vals, m):
    v = torch.sort(vals.reshape(-1), descending=True).values[:m + 1]
    gap = (v[:-1] - v[1:]).abs()
    return bool((gap <= REL_TIE * v[:-1].abs()).any())


def _scores(server, st, t):
    fn = getattr(server.scheduler, "mean_scores", None)
    if server.score_kind == "mean" and fn is not None:
        return fn(st, t)
    return server.scheduler.channel_scores(st, t)


def _near_tie(server, row, rq):
    """Whether the port's row meets request ``rq`` at a near-tie: its
    selection (``near_tie``; Lyapunov's weights), the matcher's channel
    scores or priorities, or the recompute detector's statistic against
    its threshold."""
    sched, st, t = server.scheduler, row.sched_state, int(row.t)
    u = torch.from_numpy(np.asarray(rq.u))
    aoi = row.aoi if rq.aoi is None else torch.from_numpy(np.asarray(rq.aoi, np.float32))
    if near_tie(sched, st, t, u, aoi):
        return True
    if isinstance(sched, tb.LyapunovSched):
        weight = st.queues + st.hp["v"] * sched._mu_hat(st) + u * 1e-6
        if _tight(weight, sched.n_clients):
            return True
    channels, _ = sched.select(st, t, u, aoi)
    if server.use_matching:
        contrib = (torch.ones(sched.n_clients) if rq.contrib is None
                   else torch.from_numpy(np.asarray(rq.contrib, np.float32)))
        matcher = AdaptiveMatcher(server.matcher_beta)
        lam, _ = matcher.priorities(row.matcher_state, contrib, aoi)
        scores = _scores(server, st, t)
        if _tight(scores[channels], sched.n_clients) or _tight(lam, sched.n_clients):
            return True
        channels, _ = matcher.match(row.matcher_state, channels, scores, contrib, aoi)
    if not isinstance(sched, tb.GLRCUCB) or t % sched.detector_stride:
        return False
    mask = torch.zeros(sched.n_channels, dtype=torch.bool).index_fill(0, channels, True)
    r_vec = torch.zeros(sched.n_channels).index_put(
        (channels,), torch.from_numpy(np.asarray(rq.rewards, np.float32))[channels])
    n_valid = (st.counts + mask.float()).clamp_max(float(sched.history)).to(torch.int32)
    stats = ref.glr_scan(sched._hist_append(st.hist, mask, r_vec, st.counts), n_valid)
    thresh = glr_threshold(n_valid, st.hp["delta"])
    gap = (stats - thresh).abs() <= REL_TIE * thresh.abs()
    return bool((gap & mask & torch.isfinite(stats)).any())


def _clone(x):
    if hasattr(x, "_fields"):
        return type(x)(*[_clone(y) for y in x])
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone()


def compare_traces(name, jserver, tserver, calls):
    """Serve ``calls`` (lists of JAX requests) on both servers; on the
    first differing call, replay it request by request from the snapshots
    and require a policy of ``FORKS`` at a near-tie at the first differing
    request.  Returns the fork's description, or None."""
    jsched = jserver.scheduler

    def port(rq):
        u = selection_uniform(jsched, jax.random.split(rq.key)[1], jsched.n_channels)
        return ServeRequest(rq.tenant, rq.rewards, np.asarray(u), rq.contrib, rq.aoi)

    for k, call in enumerate(calls):
        jsnap, tsnap = jserver._state, _clone(tserver._state)
        got = tserver.serve([port(rq) for rq in call])
        want = jserver.serve(call)
        if all(np.array_equal(a, b) for a, b in zip(got, want)):
            continue
        jserver._state, tserver._state = jsnap, tsnap
        for rq in call:
            row = tserver.tenant_state(rq.tenant)
            a, b = tserver.serve([port(rq)])[0], jserver.serve([rq])[0]
            if not np.array_equal(a, b):
                assert name in FORKS, f"{name}: forks from JAX at call {k}: jax {b}, port {a}"
                assert _near_tie(tserver, row, port(rq)), (
                    f"{name}: fork at call {k}, tenant {rq.tenant!r} without a near-tie: "
                    f"jax {b}, port {a}")
                return f"call {k}, tenant {rq.tenant!r} ({FORKS[name]})"
        raise AssertionError(f"{name}: call {k} differs served together but not one by one")
    return None


def _stream(key, rounds, n=N):
    """Bernoulli reward rows and round keys for traces."""
    states = np.asarray(jax.random.bernoulli(key, 0.6, (rounds, n)), np.float32)
    keys = np.asarray(jax.random.split(jax.random.fold_in(key, 1), rounds))
    return states, keys


# ---------------------------------------------------------------------------
# one tenant: the offline run and the JAX server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", POLICIES)
def test_single_tenant_matches_offline_run_and_jax_server(name):
    jsched, tsched = pair(name)
    env = random_piecewise_env(KEY, N, T, 3)
    keys, states = jax_round_stream(env, KEY, T)
    keys, states = np.asarray(keys), np.asarray(states, np.float32)
    uniforms = np.stack([np.stack([np.array(jax.random.uniform(k_env, (N,))),
                                   np.array(selection_uniform(jsched, k_sel, N))])
                         for k_env, k_sel in (jax.random.split(k) for k in keys)])
    tenv = convert.channel_env(env.form, env.means, env.breaks, env.table, device="cpu")
    u_sel, tstates = offline_round_stream(tenv, torch.from_numpy(uniforms), T)
    np.testing.assert_array_equal(tstates.numpy(), states)

    jserver = JaxServer(jsched, capacity=4, slots=3, donate=False)
    tserver = SchedServer(tsched, capacity=4, slots=3, device="cpu")
    jserver.join("job", key=KEY)
    tserver.join("job")
    calls = [[JaxRequest("job", states[t], keys[t])] for t in range(T)]
    fork = compare_traces(name, jserver, tserver, calls)
    row = tserver.tenant_state("job")
    if fork is None:
        assert_same(jserver.tenant_state("job"), row, close=CLOSE.get(name, ()))
    else:
        print(f"{name}: the trajectories fork at an ulp-level near-tie ({fork})")

    # the port's served rounds are its offline rounds, bit for bit
    served = SchedServer(tsched, capacity=4, slots=3, device="cpu")
    served.join("job")
    for t in range(T):
        served.serve([ServeRequest("job", tstates[t].numpy(), u_sel[t].numpy())])
    row = served.tenant_state("job")
    off = simulate_aoi_regret(tsched, tenv, T, uniforms=torch.from_numpy(uniforms),
                              collect_curve=False, return_state=True, device="cpu")
    assert_same(off["final_sched_state"], row.sched_state)
    assert torch.equal(off["aoi_pi"], row.aoi)
    assert int(row.t) == int(row.decisions) == T
    assert float(row.successes) == round(float(off["success_rate"]) * T * M)
    if name == "glr-recompute":
        assert int(off["restarts"]) == int(row.sched_state.restarts) > 0


# ---------------------------------------------------------------------------
# four tenants, hp overrides, duplicates, the matcher: against JAX
# ---------------------------------------------------------------------------

HP = {"m-exp3": lambda i: {"gamma": 0.3 + 0.15 * i, "share_alpha": 1e-3 * (i + 1)},
      "lyapunov": lambda i: {"v": 2.0 + i, "discount": 0.9 + 0.02 * i}}


@pytest.mark.parametrize("score_kind", ["ucb", "mean"])
@pytest.mark.parametrize("name", ["m-exp3", "lyapunov"])
def test_four_tenant_matched_trace_matches_jax(name, score_kind):
    """hp overrides, short batches (slots=3, calls of 1-5 requests), a
    tenant twice in one call (deferred), per-request contributions and AoI
    overrides, the Sec.-V matcher ranking by ``channel_scores`` or, under
    ``"mean"``, ``mean_scores`` where the policy has them."""
    jsched, tsched = pair(name)
    kw = dict(capacity=6, slots=3, use_matching=True, score_kind=score_kind)
    jserver = JaxServer(jsched, donate=False, **kw)
    tserver = SchedServer(tsched, device="cpu", **kw)
    tenants = ["a", "b", "c", "d"]
    for i, tid in enumerate(tenants):
        jserver.join(tid, key=jax.random.fold_in(KEY, i), hp=HP[name](i))
        tserver.join(tid, hp=HP[name](i))
    rng = np.random.default_rng(5)
    states, keys = _stream(jax.random.fold_in(KEY, 11), 160)
    calls, j = [], 0
    while j < 150:
        call = []
        for _ in range(int(rng.integers(1, 6))):
            tid = tenants[int(rng.integers(0, 4))]
            contrib = rng.random(M).astype(np.float32) if rng.random() < 0.5 else None
            aoi = rng.integers(1, 6, M).astype(np.float32) if rng.random() < 0.3 else None
            call.append(JaxRequest(tid, states[j], keys[j], contrib=contrib, aoi=aoi))
            j += 1
        calls.append(call)
    assert any(len({rq.tenant for rq in c}) < len(c) for c in calls), "no duplicate in a call"
    fork = compare_traces(name, jserver, tserver, calls)
    if fork is None:
        for tid in tenants:
            assert_same(jserver.tenant_state(tid), tserver.tenant_state(tid),
                        close=CLOSE[name])
    else:
        print(f"{name} {score_kind}: the traces fork at an ulp-level near-tie ({fork})")


# ---------------------------------------------------------------------------
# the service's own contracts, for every policy
# ---------------------------------------------------------------------------

def _server(name, **kw):
    cfg = dict(capacity=4, slots=3, device="cpu")
    cfg.update(kw)
    return SchedServer(pair(name)[1], **cfg)


def _requests(tid, states, keys, rounds, start=0, n=N):
    u = lambda k: np.array(jax.random.uniform(jax.random.split(k)[1], (n,)))
    return [ServeRequest(tid, states[t], u(keys[t])) for t in range(start, start + rounds)]


def _flat(tree):
    if hasattr(tree, "_fields"):
        return [x for f in tree for x in _flat(f)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("use_matching", [False, True], ids=["policy", "matched"])
@pytest.mark.parametrize("name", POLICIES)
def test_pad_rows_and_bystanders_untouched(name, use_matching):
    server = _server(name, use_matching=use_matching)
    for tid in ("a", "b", "gone"):
        server.join(tid)
    server.leave("gone")
    states, keys = _stream(jax.random.fold_in(KEY, 3), 8)
    snap = [x.clone() for x in _flat(server._state)]
    for rq in _requests("a", states, keys, 8):
        assert server.serve([rq])[0].shape == (M,)
    a = server.tenants["a"]
    for before, after in zip(snap, _flat(server._state)):
        keep = torch.ones(before.shape[0], dtype=torch.bool)
        keep[a] = False
        assert torch.equal(before[keep], after[keep])
    assert int(server.tenant_state("a").t) == 8


@pytest.mark.parametrize("name", POLICIES)
def test_batch_splits_and_stream_invisible(name):
    states, keys = _stream(jax.random.fold_in(KEY, 4), 9)
    tids = ["x", "y", "x", "y", "x", "x", "z", "y", "x"]
    reqs = [ServeRequest(tid, states[j], np.array(jax.random.uniform(keys[j], (N,))))
            for j, tid in enumerate(tids)]

    def run(slots, splits, stream=False):
        server = _server(name, slots=slots, use_matching=True)
        for tid in ("x", "y", "z"):
            server.join(tid)
        if stream:
            got = dict(server.serve_stream(iter(reqs)))
            out = [got[i] for i in range(len(reqs))]
        else:
            out, start = [], 0
            for end in splits + [len(reqs)]:
                out += server.serve(reqs[start:end])
                start = end
        return out, [server.tenant_state(t) for t in ("x", "y", "z")]

    one = run(3, [])
    for other in (run(3, [1, 4]), run(2, []), run(1, [2]), run(3, [], stream=True)):
        for a, b in zip(one[0], other[0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(one[1], other[1]):
            assert_same(a, b)


@pytest.mark.parametrize("name", ["m-exp3", "glr-recompute", "lyapunov"])
def test_kill_mid_stream_restore_resumes_bitwise(name, tmp_path):
    """Every slot leaf (M-Exp3's (rows, C) ``log_w``, the recompute
    history, Lyapunov's queues) saves and restores bit for bit."""
    states, keys = _stream(jax.random.fold_in(KEY, 12), 40)
    reqs = [ServeRequest("ab"[j % 2], states[j], np.array(jax.random.uniform(keys[j], (N,))))
            for j in range(40)]

    def mk():
        server = _server(name, capacity=4, slots=4)
        server.join("a")
        server.join("b")
        return server

    full = mk()
    want = [a for _, a in sorted(full.serve_stream(iter(reqs)))]
    crashed = mk()
    first = [a for _, a in sorted(crashed.serve_stream(iter(reqs[:20])))]
    crashed.save(str(tmp_path), step=20)
    del crashed
    revived = mk()
    assert revived.restore(str(tmp_path), warm=False) == 20
    second = [a for _, a in sorted(revived.serve_stream(iter(reqs[20:])))]
    for a, b in zip(first + second, want):
        np.testing.assert_array_equal(a, b)
    for x, y in zip(_flat(revived._state), _flat(full._state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="scheduler configuration"):
        _server("random" if name != "random" else "round-robin",
                capacity=4, slots=4).restore(str(tmp_path), warm=False)


@pytest.mark.parametrize("name", POLICIES)
def test_join_hp_per_policy(name):
    """A policy with traced knobs takes per-tenant hp (equal to the config
    with those values); random and round-robin have none, so any name
    raises, as an unknown name does for the others."""
    jsched, tsched = pair(name)
    knobs = tsched.traced_fields()
    server = _server(name, capacity=2, slots=1)
    with pytest.raises(ValueError, match="unknown hyper-parameters"):
        server.join("bad", hp={"learning_rate": 0.1})
    if not knobs:
        assert name in ("random", "round-robin")
        with pytest.raises(ValueError, match="unknown hyper-parameters"):
            server.join("bad", hp={"gamma": 0.5})
        return
    override = {k: 0.5 * float(getattr(tsched, k)) for k in knobs}
    states, keys = _stream(jax.random.fold_in(KEY, 5), 30)

    def run(srv, hp=None):
        srv.join("hot", hp=hp)
        for rq in _requests("hot", states, keys, 30):
            srv.serve([rq])
        return srv.tenant_state("hot")

    via_hp = run(server, override)
    via_cfg = run(SchedServer(tsched.replace_traced(**override), capacity=2, slots=1,
                              device="cpu"))
    assert_same(via_hp, via_cfg)


def test_aoi_aware_is_refused_like_the_jax_server():
    for base in (tb.GLRCUCB(N, M, **GLR), tb.MExp3(N, M)):
        with pytest.raises(ValueError, match="AoI-Aware is not served"):
            SchedServer(tb.AoIAware(base), device="cpu")
    with pytest.raises(TypeError):
        JaxServer(jb.AoIAware(jb.MExp3(N, M)), capacity=2, slots=1, donate=False)


# ---------------------------------------------------------------------------
# kernels on a CUDA-looking slot state
# ---------------------------------------------------------------------------

class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one: the kernel dispatch
    routes on ``is_cuda``."""

    @property
    def is_cuda(self):
        return True


def _as(tree, cls):
    if hasattr(tree, "_fields"):
        return type(tree)(*[_as(x, cls) for x in tree])
    if isinstance(tree, dict):
        return {k: _as(v, cls) for k, v in tree.items()}
    return tree.as_subclass(cls)


@pytest.mark.parametrize("use_matching", [False, True], ids=["policy", "matched"])
@pytest.mark.parametrize("name", POLICIES)
def test_kernel_calls_on_cuda(monkeypatch, name, use_matching):
    """On CUDA-looking slot tensors a recompute step calls the tenant
    ``glr_scan`` wrapper exactly once, whether a row detects or not, and
    no other kernel; the five detector-free policies call no kernel.  The
    kernel is stood in for by its plain version; decisions and states
    equal a CPU server's bit for bit."""
    calls = {}

    def stand_in(kernel, plain):
        def fn(*a, **kw):
            calls[kernel] = calls.get(kernel, 0) + 1
            return plain(*[x.as_subclass(torch.Tensor) if isinstance(x, torch.Tensor) else x
                           for x in a], **kw)
        return fn

    monkeypatch.setattr(ops._gsc, "glr_scan_tenants",
                        stand_in("glr_scan_tenants", ref.glr_scan_tenants))
    for mod, fn in ((ops._gsc, "glr_scan"), (ops._gs, "glr_step"),
                    (ops._gst, "glr_step_tenants"), (ops._wa, "weighted_aggregate"),
                    (ops._ra, "robust_trimmed"), (ops._rs, "regret_scan")):
        monkeypatch.setattr(mod, fn, stand_in(fn, None))
    states, keys = _stream(jax.random.fold_in(KEY, 8), 40)
    servers = [_server(name, capacity=4, slots=2, use_matching=use_matching) for _ in range(2)]
    card = servers[1]
    card._state = _as(card._state, _CudaLooking)
    out = []
    for server in servers:
        for tid in ("a", "b", "c"):
            server.join(tid)
        got = []
        for j in range(20):
            tids = ["a", "b"] if j % 3 else ["c"]
            got += server.serve([ServeRequest(t, states[j],
                                              np.array(jax.random.uniform(keys[j], (N,))))
                                 for t in tids])
            if j == 10:
                server.leave("b")
                server.join("b")
        out.append(got)
    want = {"glr_scan_tenants": 20} if name == "glr-recompute" else {}
    assert calls == want and card.stats()["steps"] == 20
    card._state = _as(card._state, torch.Tensor)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    for tid in ("a", "b", "c"):
        assert_same(servers[0].tenant_state(tid), card.tenant_state(tid))


# ---------------------------------------------------------------------------
# the FL trainers on a served policy
# ---------------------------------------------------------------------------

D, BS, E = 4, 3, 2
FM, NCH, R = 4, 6, 10
FL_MEANS = np.array([[0.9, 0.2, 0.7, 0.3, 0.6, 0.1],
                     [0.2, 0.8, 0.3, 0.9, 0.1, 0.7]], np.float32)
FL_BREAKS = np.array([5], np.int64)
FL_CFG = dict(n_clients=FM, n_channels=NCH, local_epochs=E, staleness_cap=3,
              max_update_norm=50.0)


def _torch_loss(p, x, y):
    return ((x @ p["w"] + p["b"] - y) ** 2).mean()


def _jax_loss(p, x, y):
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def _params():
    return {"w": torch.zeros(D), "b": torch.zeros(())}


def _fl_data(seed, r=R):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(r, FM, E, BS, D)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(r, FM, E, BS)).astype(np.float32)))


def _fl_server(trainer):
    return SchedServer(trainer.scheduler, capacity=4, slots=2, use_matching=True,
                       matcher_beta=trainer.cfg.matcher_beta, device="cpu")


def _same(a, b, what):
    for x, y in zip(_flat(a), _flat(b)):
        assert (x == y) if isinstance(x, int) else torch.equal(x, y), what


def test_dense_mexp3_run_served_matches_run_bitwise():
    tsched = pair("m-exp3", NCH, FM)[1]
    env = make_piecewise(torch.from_numpy(FL_MEANS), torch.from_numpy(FL_BREAKS), device="cpu")
    tr = AsyncFLTrainer(AsyncFLConfig(**FL_CFG), tsched, env, _torch_loss, device="cpu")
    bx, by = _fl_data(1)
    u = torch.rand((R, 2, NCH), generator=torch.Generator().manual_seed(2))
    ref_state, ref_m = tr.run(tr.init(_params()), bx, by, uniforms=u)
    server = _fl_server(tr)
    server.join("job")
    state, mets = tr.run_served(tr.init(_params()), bx, by, server, "job", uniforms=u)
    for f in ref_state._fields:
        if f != "sched_state":
            _same(getattr(ref_state, f), getattr(state, f), f)
    _same(ref_state.sched_state, server.tenant_state("job").sched_state, "server sched_state")
    for k in ref_m:
        assert torch.equal(ref_m[k], mets[k]), k
    assert float(ref_m["n_success"].sum()) > 0


def test_sparse_lyapunov_run_served_matches_run_bitwise():
    n, m, nch, r = 10, 4, 8, 12
    rng = np.random.default_rng(0)
    cx = torch.from_numpy(rng.normal(size=(n, 12, D)).astype(np.float32))
    cy = torch.from_numpy(rng.normal(size=(n, 12)).astype(np.float32))
    proc = make_scenario("piecewise", n_channels=nch, horizon=r, n_breakpoints=2)
    tr = SparseAsyncFLTrainer(
        SparseFLConfig(n_clients=n, n_sched=m, n_channels=nch, batch_size=BS, local_epochs=E,
                       staleness_cap=3),
        tb.LyapunovSched(nch, m), proc, _torch_loss, device="cpu",
        realize_generator=torch.Generator().manual_seed(77),
        availability=MarkovChurn(p_drop=0.2, p_rejoin=0.5))
    g = torch.Generator().manual_seed(9)
    u, au = torch.rand((r, 2, nch), generator=g), torch.rand((r, 2 * n), generator=g)
    ref_s, ref_m = tr.run(tr.init(_params()), cx, cy, uniforms=u, avail_uniforms=au)
    server = _fl_server(tr)
    server.join("job")
    srv_s, srv_m = tr.run_served(tr.init(_params()), cx, cy, server, "job", uniforms=u,
                                 avail_uniforms=au)
    for f in ref_s._fields:
        if f != "sched_state":
            _same(getattr(ref_s, f), getattr(srv_s, f), f)
    _same(ref_s.sched_state, server.tenant_state("job").sched_state, "server sched_state")
    for k in ref_m:
        assert torch.equal(ref_m[k], srv_m[k]), k
    assert float(ref_m["n_success"].sum()) > 0


def test_dense_mexp3_run_served_matches_jax_run_served():
    rounds = 3
    jsched, tsched = pair("m-exp3", NCH, FM)
    jtr = JaxTrainer(JaxConfig(**FL_CFG), jsched,
                     jax_make_piecewise(FL_MEANS, FL_BREAKS.astype(np.int32)), _jax_loss)
    jparams = {"w": jnp.zeros((D,), jnp.float32), "b": jnp.zeros((), jnp.float32)}
    keys = jax.random.split(jax.random.PRNGKey(9), rounds)
    jserver = JaxServer(jsched, capacity=4, slots=2, use_matching=True,
                        matcher_beta=jtr.cfg.matcher_beta, donate=False)
    jserver.join("job", key=KEY)
    bx, by = _fl_data(5)
    jstate, jm = jtr.run_served(jtr.init(jparams, KEY), jnp.asarray(bx[:rounds].numpy()),
                                jnp.asarray(by[:rounds].numpy()), keys, jserver, "job")
    u = torch.from_numpy(np.stack([
        np.stack([np.array(jax.random.uniform(k_env, (NCH,))),
                  np.array(selection_uniform(jsched, k_sel, NCH))])
        for k_env, k_sel in (jax.random.split(k) for k in keys)]))
    env = make_piecewise(torch.from_numpy(FL_MEANS), torch.from_numpy(FL_BREAKS), device="cpu")
    tr = AsyncFLTrainer(AsyncFLConfig(**FL_CFG), tsched, env, _torch_loss, device="cpu")
    server = _fl_server(tr)
    server.join("job")
    state, mets = tr.run_served(tr.init(_params()), bx[:rounds], by[:rounds], server, "job",
                                uniforms=u)
    np.testing.assert_array_equal(mets["n_success"].numpy(), np.array(jm["n_success"]))
    np.testing.assert_array_equal(state.aoi.numpy(), np.array(jstate.aoi))
    np.testing.assert_array_equal(state.has_update.numpy(), np.array(jstate.has_update))
    assert_same(jserver.tenant_state("job").sched_state,
                server.tenant_state("job").sched_state, close=CLOSE["m-exp3"])
    close = lambda a, b, what: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=what)
    for k in ("w", "b"):
        close(state.params[k].numpy(), jstate.params[k], k)
    for name in ("buffers", "contrib", "zeta"):
        close(getattr(state, name).numpy(), getattr(jstate, name), name)
    for k in ("local_loss", "mean_aoi", "beta_t", "zeta_max"):
        close(mets[k].numpy(), jm[k], k)
