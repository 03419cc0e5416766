"""The recompute detector served: ``glr_scan``'s tenant form and
``GLRCUCB.update_rows`` on a ``SlotHist``.

``ref.glr_scan_tenants`` (the plain version of the CUDA kernel's tenant
entry, and the CPU path of ``ops.glr_scan_tenants``) is ``ref.glr_scan``
on the named slots' gathered rows, bit for bit, with -inf on the rows
whose detect flag is off; it never writes the history.  Against the JAX
package's ``glr_scan`` (the Pallas kernel in interpret mode) on the same
gathered rows, as the JAX serve step ``vmap``s it: -inf at the same
places, the statistic at rtol 1e-5 on {0, 1} histories and rtol 1e-4 /
atol 1e-5 on real-valued ones (the tolerances of
``tests/test_torch_glr_scan.py``).

``update_rows`` with the recompute detector equals ``update`` on each row
bit for bit (history append, roll, restart's zeroed history, counts,
``tau``, restarts); rows that are not live leave their slot alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.bandits import GLRCUCB, SlotHist  # noqa: E402
from repro_torch.kernels import glr_scan as gsc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

R, B, N = 9, 6, 4


def _inputs(seed, h, binary=True):
    rng = np.random.default_rng(seed)
    hist = (rng.integers(0, 2, (R, N, h)) if binary else rng.random((R, N, h)))
    counts = rng.integers(0, h + 1, (B, N)).astype(np.int32)
    counts.reshape(-1)[:4] = [0, 1, 2, h]                # empty, one sample, one split, full
    slots = np.array([3, 0, R - 1, R - 1, 5, 1], np.int32)   # two padding rows on scratch
    detect = np.array([1, 0, 0, 0, 1, 1], bool)
    return (torch.from_numpy(hist.astype(np.float32)), torch.from_numpy(slots),
            torch.from_numpy(detect), torch.from_numpy(counts))


@pytest.mark.parametrize("h", [1, 33, 64, 130])
@pytest.mark.parametrize("binary", [True, False], ids=["01", "real"])
def test_plain_version_is_glr_scan_on_the_gathered_rows(h, binary):
    hist, slots, detect, counts = _inputs(h, h, binary)
    before = hist.clone()
    got = ops.glr_scan_tenants(hist, slots, detect, counts)
    assert got.shape == (B, N) and got.dtype == torch.float32
    assert torch.equal(hist, before), "the plain version wrote the history"
    for b in range(B):
        if detect[b]:
            assert torch.equal(got[b], ref.glr_scan(hist[int(slots[b])], counts[b]))
        else:
            assert torch.isneginf(got[b]).all()


@pytest.mark.parametrize("binary", [True, False], ids=["01", "real"])
def test_plain_version_matches_jax_glr_scan_on_the_gathered_rows(binary):
    h = 96
    hist, slots, detect, counts = _inputs(11, h, binary)
    got = ops.glr_scan_tenants(hist, slots, detect, counts).numpy()
    rows = hist.numpy()[slots.numpy()].reshape(B * N, h)
    want = np.array(jops.glr_scan(jnp.asarray(rows), jnp.asarray(counts.numpy().reshape(-1)),
                                  backend="pallas_interpret")).reshape(B, N)
    want = np.where(detect.numpy()[:, None], want, -np.inf)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    tol = dict(rtol=1e-5, atol=0) if binary else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


def test_kernel_wrapper_checks_its_operands():
    hist, slots, detect, counts = _inputs(0, 16)
    with pytest.raises(ValueError, match="CUDA"):
        gsc.glr_scan_tenants(hist, slots, detect, counts)
    # the meta route (the dry run's) takes meta tensors only: a meta history
    # beside CPU operands is refused
    with pytest.raises(ValueError, match="meta route takes meta tensors"):
        ops.glr_scan_tenants(hist.to("meta"), slots, detect, counts)


def _update_trace(sched, slots, live, rounds, seed):
    """``rounds`` rounds of ``update_rows`` on a SlotHist against
    ``update`` on each live row; returns the restarts and the history."""
    n, m, h = sched.n_channels, sched.n_clients, sched.history
    rows = slots.numel()
    rng = np.random.default_rng(seed)
    singles = [sched.init("cpu") for _ in range(rows)]
    hist = torch.full((rows + 2, n, h), 7.0)        # slot contents the rows overwrite
    for i in range(rows):
        if live[i]:
            hist[int(slots[i])] = 0.0
    untouched = hist[rows + 1].clone()
    restarts = 0
    for t in range(rounds):
        stack = type(singles[0])(*[
            {k: torch.stack([s[f][k] for s in singles]) for k in singles[0][f]}
            if isinstance(singles[0][f], dict) else torch.stack([s[f] for s in singles])
            for f in range(len(singles[0]))])
        tt = torch.full((rows,), t, dtype=torch.int32)
        channels = torch.from_numpy(np.stack([rng.permutation(n)[:m] for _ in range(rows)]))
        p = 0.9 if (t // 25) % 2 == 0 else 0.1
        rewards = torch.from_numpy((rng.random((rows, m)) < p).astype(np.float32))
        ring = SlotHist(hist, slots, live, live & (tt % sched.detector_stride == 0))
        new = sched.update_rows(stack, tt, channels, rewards, ring)
        assert new.hist is hist
        for i in range(rows):
            if not live[i]:
                continue
            singles[i] = sched.update(singles[i], t, channels[i], rewards[i], None)
            for f in ("mu_tilde", "counts", "tau", "restarts"):
                assert torch.equal(getattr(new, f)[i], getattr(singles[i], f)), (t, i, f)
            assert torch.equal(hist[int(slots[i])], singles[i].hist), (t, i)
        restarts = int(new.restarts[live].sum())
    assert torch.equal(hist[rows + 1], untouched)
    return restarts, hist


@pytest.mark.parametrize("h", [8, 16], ids=["rolls", "appends"])
def test_update_rows_recompute_equals_update_on_each_row(h):
    """Short histories roll (h = 8), longer ones mostly append; the restart
    zeroes a live row's history in place; a row that is not live keeps
    its slot's contents."""
    sched = GLRCUCB(5, 2, history=h, detector_stride=2, min_samples=2, delta=0.5,
                    detector_impl="recompute")
    slots = torch.tensor([2, 0, 3, 1])
    live = torch.tensor([True, True, True, False])
    restarts, hist = _update_trace(sched, slots, live, 80, seed=4)
    assert restarts > 0, "the trace never restarted: the restart path went untested"
    assert torch.equal(hist[1], torch.full((5, h), 7.0)), "a row not live was written"
