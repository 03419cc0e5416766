"""Scheduler-as-a-service launcher: serve channel-scheduling decisions.

Stands up a multi-tenant ``SchedServer`` (one serve step for the whole
tenant pool; see ``repro_torch.sim.serve``), joins ``--tenants`` concurrent
FL jobs, measures pipelined against synchronous saturated throughput at
equal batch size, then replays Poisson request traffic through the
pipelined ``serve_stream`` loop (autosized steps, churn interleaved with
in-flight steps) and reports p50/p99/p999 decision latency, queue depth,
batch occupancy and decisions a second.  The synchronous
``poisson_episode`` is kept beside it for comparison runs.  Every clock is
read after ``torch.cuda.synchronize()`` on the card.  Twin of
``repro/launch/sched_serve.py``; the requests' channel states and
selection uniforms are drawn with numpy from ``--seed``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.sched_serve --tenants 256 --slots 64
  PYTHONPATH=src python -m repro_torch.launch.sched_serve --tenants 8 --slots 4 \\
      --requests 64 --device cpu
"""
from __future__ import annotations

import argparse
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.bandits import GLRCUCB
from repro_torch.sim import SchedServer, ServeRequest


def _sync(server) -> None:
    """Retire the server's device work before a clock is read."""
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)


def _request(tenant_ids, states, uniforms, j):
    """Request j: tenant ``j mod T``, reward row ``states[(j // T) mod R, j mod T]``,
    selection uniform ``uniforms[j]``."""
    n_ten = len(tenant_ids)
    return ServeRequest(tenant_ids[j % n_ten], states[(j // n_ten) % states.shape[0], j % n_ten],
                        uniforms[j])


def poisson_episode(server, tenant_ids, states, uniforms, arrivals, churn_stride: int = 0,
                    churn_hp=None):
    """Replay Poisson request traffic through the synchronous ``serve``;
    returns ``(latencies_s, wall_s, churn_events)``.  Request j becomes
    eligible ``arrivals[j]`` seconds after the clock starts; every
    ``churn_stride`` steps one tenant is evicted and re-admitted fresh."""
    n_req, n_ten = len(arrivals), len(tenant_ids)
    lat = np.empty(n_req)
    queue: deque = deque()
    nxt = served = steps = churn_events = churn_ptr = 0
    t0 = time.perf_counter()
    while served < n_req:
        now = time.perf_counter() - t0
        while nxt < n_req and arrivals[nxt] <= now:
            queue.append(nxt)
            nxt += 1
        if not queue:
            time.sleep(min(max(arrivals[nxt] - now, 0.0), 1e-3))
            continue
        ids = [queue.popleft() for _ in range(min(server.slots, len(queue)))]
        server.serve([_request(tenant_ids, states, uniforms, j) for j in ids])
        done = time.perf_counter() - t0
        for j in ids:
            lat[j] = done - arrivals[j]
        served += len(ids)
        steps += 1
        if churn_stride and steps % churn_stride == 0:
            tid = tenant_ids[churn_ptr % n_ten]
            churn_ptr += 1
            server.leave(tid)
            server.join(tid, hp=churn_hp)
            churn_events += 1
    _sync(server)
    return lat, time.perf_counter() - t0, churn_events


def saturated_throughput(server, tenant_ids, states, uniforms, n_req: int) -> float:
    """Decisions a second: back-to-back full batches through ``serve``."""
    t0 = time.perf_counter()
    for start in range(0, n_req, server.slots):
        server.serve([_request(tenant_ids, states, uniforms, j)
                      for j in range(start, min(start + server.slots, n_req))])
    _sync(server)
    return n_req / (time.perf_counter() - t0)


def pipelined_throughput(server, tenant_ids, states, uniforms, n_req: int,
                         autosize: bool = False) -> float:
    """Decisions a second through ``serve_stream``: the request trace and
    batch size of ``saturated_throughput`` (``autosize=False``), with host
    packing and result conversion overlapping the in-flight step."""
    t0 = time.perf_counter()
    src = (_request(tenant_ids, states, uniforms, j) for j in range(n_req))
    for _ in server.serve_stream(src, autosize=autosize):
        pass
    _sync(server)
    return n_req / (time.perf_counter() - t0)


def pipelined_poisson_episode(server, tenant_ids, states, uniforms, arrivals,
                              churn_stride: int = 0, churn_hp=None, autosize: bool = True):
    """Poisson replay through ``serve_stream``; returns ``(latencies_s,
    wall_s, churn_events, queue_depths)``.

    Arrived requests are yielded to the stream; when the arrival queue runs
    dry a ``None`` flush marker dispatches what is pending as a short
    (autosized) step.  Churn (``leave`` + ``join`` every ``churn_stride``
    full batches of yielded requests) runs as a side effect of the source,
    between in-flight steps.  ``queue_depths`` samples the arrived-but-
    undispatched backlog at every yield.  Latency is retire time (the
    stream yielding the assignment) minus arrival: the one step of pipeline
    latency is counted."""
    n_req, n_ten = len(arrivals), len(tenant_ids)
    lat = np.empty(n_req)
    depths: list = []
    churn_events = churn_ptr = 0
    t0 = time.perf_counter()

    def source():
        nonlocal churn_events, churn_ptr
        nxt = arrived = 0
        while nxt < n_req:
            now = time.perf_counter() - t0
            # arrivals are sorted and the clock only advances: the arrived
            # count is a cursor, so a backlog costs nothing to measure
            while arrived < n_req and arrivals[arrived] <= now:
                arrived += 1
            if arrived == nxt:
                yield None                # nothing new: flush, then wait out the gap
                now = time.perf_counter() - t0
                if arrivals[nxt] > now:
                    time.sleep(min(arrivals[nxt] - now, 1e-3))
                continue
            depths.append(arrived - nxt)
            j = nxt
            nxt += 1
            yield _request(tenant_ids, states, uniforms, j)
            if churn_stride and (j + 1) % (churn_stride * server.slots) == 0:
                tid = tenant_ids[churn_ptr % n_ten]
                churn_ptr += 1
                server.leave(tid)
                server.join(tid, hp=churn_hp)
                churn_events += 1

    for i, _asg in server.serve_stream(source(), autosize=autosize):
        lat[i] = (time.perf_counter() - t0) - arrivals[i]
    _sync(server)
    return lat, time.perf_counter() - t0, churn_events, np.asarray(depths)


def make_traffic(n_tenants: int, n_channels: int, n_req: int, rounds: int = 32, seed: int = 0):
    """The benchmark's traffic: per-tenant channel means U[0.15, 0.9],
    ``rounds`` rounds of Bernoulli channel states (rounds, tenants, N) and
    one (N,) selection uniform a request, f32, from ``seed``."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.15, 0.9, (n_tenants, n_channels))
    states = (rng.random((rounds, n_tenants, n_channels)) < means[None]).astype(np.float32)
    uniforms = rng.random((n_req, n_channels)).astype(np.float32)
    return states, uniforms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=256)
    ap.add_argument("--slots", type=int, default=64, help="requests batched per serving step")
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--history", type=int, default=256)
    ap.add_argument("--requests", type=int, default=0,
                    help="episode length (default: 8 rounds per tenant)")
    ap.add_argument("--load", type=float, default=0.8,
                    help="offered Poisson load as a fraction of saturated throughput")
    ap.add_argument("--churn-stride", type=int, default=16,
                    help="evict+readmit one tenant every this many steps (0 = no churn)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (required)")
    args = ap.parse_args(argv)

    sched = GLRCUCB(args.channels, args.clients, history=args.history, detector_stride=5,
                    split_grid="auto")
    server = SchedServer(sched, capacity=args.tenants, slots=args.slots, device=args.device)
    print(f"[sched-serve] {sched.name}: N={args.channels} M={args.clients} H={args.history}; "
          f"capacity={args.tenants} slot_batch={args.slots} on {server.device}")

    tenant_ids = [f"job-{i}" for i in range(args.tenants)]
    for i, tid in enumerate(tenant_ids):
        server.join(tid, hp={"gamma": 0.8 + 0.4 * i / args.tenants})
    print(f"[sched-serve] joined {len(server.tenants)} tenants")

    n_req = args.requests or args.tenants * 8
    states, uniforms = make_traffic(args.tenants, args.channels, n_req, seed=args.seed)

    server.warm()
    warm = min(n_req, 4 * args.slots)
    rate = saturated_throughput(server, tenant_ids, states, uniforms, warm)
    pipe_n = min(n_req, 16 * args.slots)
    pipe_rate = pipelined_throughput(server, tenant_ids, states, uniforms, pipe_n)
    print(f"[sched-serve] saturated: sync {rate:.0f} decisions/s, pipelined {pipe_rate:.0f} "
          f"decisions/s ({pipe_rate / rate:.2f}x, equal batch={args.slots})")

    lam = args.load * rate
    arrivals = np.cumsum(np.random.default_rng(args.seed).exponential(1.0 / lam, size=n_req))
    lat, wall, churn, depths = pipelined_poisson_episode(
        server, tenant_ids, states, uniforms, arrivals, churn_stride=args.churn_stride)
    p50, p99, p999 = np.percentile(lat, [50, 99, 99.9]) * 1e3
    st = server.stats()
    print(f"[sched-serve] Poisson load {args.load:.0%} ({lam:.0f} req/s): served {n_req} "
          f"requests in {wall:.2f}s ({n_req / wall:.0f} decisions/s), latency "
          f"p50={p50:.2f}ms p99={p99:.2f}ms p999={p999:.2f}ms, queue depth "
          f"mean={depths.mean():.1f} max={depths.max()}, churn_events={churn}, "
          f"batch_occupancy={st['batch_occupancy']:.2f}, sizes_used={st['sizes_used']}")


if __name__ == "__main__":
    main()
