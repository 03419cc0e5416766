"""Parity of the port's MLA and MoE decoders with the JAX package's.

The three smoke configs (minicpm3: MLA with a query LoRA; deepseek-v2: MLA,
a leading dense layer under ``layers/00``, then MoE with a shared expert;
dbrx: GQA with MoE; 2 layers, width 256): JAX ``init`` ->
``convert.model_params`` -> the port, so both run the same weights.  On the
CPU attention is the chunked plain path on both sides (MLA's value width
differs from its query width, so JAX takes its XLA path everywhere).

Tolerances: f32 logits rtol 1e-4 / atol 1e-5 and ``moe_aux`` rtol 1e-5
(sums in another order); bf16 logits within 3e-2 of the largest logit (the
dense models' rule, ``tests/test_torch_models.py``); decode against prefill
rtol/atol 2e-3 (the JAX test's own); loss and gradients rtol 1e-4.

Routing in bf16: the router's logits are a bf16 product, so two experts
often tie, and the two packages' hidden states differ by an ulp or so.  A
token the two route apart (another set of top-k experts) is allowed only
at a near-tie, the experts swapped within ``NEAR_TIE`` of each other
relative in the port's probabilities; the test then carries JAX's choice
across (the port takes JAX's experts for that token), so the runs stay
together, and it counts such tokens (at most ``MAX_APART`` a forward).
The dispatch is checked bitwise against JAX's on the integers: top-k ids
(ties to the lower id, as ``lax.top_k``), the stable expert sort, slots,
keep mask and which tokens drop past capacity.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.layers import ParamBuilder as JParamBuilder  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["minicpm3-4b", "deepseek-v2-236b", "dbrx-132b"]
KEY = jax.random.PRNGKey(0)
NEAR_TIE = 1e-2       # relative gap of two swapped experts' probabilities in bf16
MAX_APART = 4         # tokens routed apart in one forward of 2 x 40 tokens


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread, so the test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def _pair(arch, dtype="float32", **over):
    """The JAX model, its parameters, the port's model and the same
    parameters converted.  The parameters are drawn once an arch, in f32
    under ``jit`` (JAX's init dominates the file's time), and rounded to
    bf16 for the bf16 models; ``over`` changes config fields that add or
    reshape no parameter."""
    if (arch, dtype) not in _PAIRS:
        if dtype == "float32":
            jm = j_build(dataclasses.replace(j_smoke(arch), dtype=dtype), remat="none")
            jp = jax.jit(lambda key: jm.init(key)[0])(KEY)
        else:
            jp = jax.tree.map(lambda a: a.astype(dtype), _pair(arch)[1])
        _PAIRS[arch, dtype] = jp, convert.model_params(jp, "cpu")
    jp, pp = _PAIRS[arch, dtype]
    jm = j_build(dataclasses.replace(j_smoke(arch), dtype=dtype, **over), remat="none")
    pm = build_model(dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over),
                     remat="none")
    return jm, jp, pm, pp


def _no_drop(arch):
    """The capacity factor at which no token can drop: every expert has a
    slot for every token (a prefill that drops cannot equal decode)."""
    cfg = get_smoke_config(arch)
    return {"capacity_factor": cfg.n_experts / cfg.experts_per_token} if cfg.n_experts else {}


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.array(jnp.asarray(x, jnp.float32))


class _CarryRoutes:
    """Records JAX's top-k expert ids, call by call (``jax.lax.top_k`` is
    looked up at call time; inside the layer scan the ids leave through an
    ordered ``jax.debug.callback``), and makes the port's
    ``moe.route`` take JAX's experts for a token the two route apart, after
    checking that token is a near-tie in the port's probabilities."""

    def __init__(self, monkeypatch):
        self.jax_ids, self.calls, self.apart = [], 0, 0
        top_k = jax.lax.top_k

        def record(x, k):
            vals, ids = top_k(x, k)
            jax.debug.callback(lambda i: self.jax_ids.append(np.array(i)), ids, ordered=True)
            return vals, ids

        route = moe.route

        def carry(probs, k):
            topw, topi = route(probs, k)
            want = torch.from_numpy(self.jax_ids[self.calls]).long()
            self.calls += 1
            apart = (topi.sort(-1).values != want.sort(-1).values).any(-1)
            for idx in apart.nonzero().tolist():
                p = probs[tuple(idx)]
                mine, theirs = set(topi[tuple(idx)].tolist()), set(want[tuple(idx)].tolist())
                lo = min(float(p[e]) for e in mine - theirs)
                hi = max(float(p[e]) for e in theirs - mine)
                assert abs(hi - lo) <= NEAR_TIE * max(hi, lo), (idx, lo, hi)
            self.apart += int(apart.sum())
            if apart.any():
                topi = torch.where(apart[..., None], want, topi)
                topw = probs.gather(-1, topi)
                topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
            return topw, topi

        monkeypatch.setattr(jax.lax, "top_k", record)
        monkeypatch.setattr(moe, "route", carry)


# ---------------------------------------------------------------------------
# the models against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_have_the_jax_layout(arch):
    jm, jp, pm, pp = _pair(arch, dtype="bfloat16")
    specs, _ = jm.param_specs()
    mine, _ = pm.param_specs()
    assert set(pp) == set(specs) == set(mine)
    if pm.cfg.first_k_dense:
        assert "layers/00/b/mlp/w_gate" in pp and "blocks/b/moe/router" in pp
    for k, s in specs.items():
        assert tuple(pp[k].shape) == tuple(s.shape) == tuple(mine[k].shape), k
        assert pp[k].dtype == mine[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(pp[k].view(torch.int16).numpy(),
                                      np.array(jp[k]).view(np.int16), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax_f32(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg, (2, 40))
    want, jaux = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})
    got, aux = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 40, pm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert (float(aux) > 0) == bool(pm.cfg.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax_bf16(arch, monkeypatch):
    jm, jp, pm, pp = _pair(arch, dtype="bfloat16")
    routes = _CarryRoutes(monkeypatch)
    toks = _tokens(pm.cfg, (2, 40), seed=1)
    want, jaux = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})     # traced here: records
    got, aux = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    n_moe = pm.cfg.n_layers - pm.cfg.first_k_dense if pm.cfg.n_experts else 0
    assert routes.calls == len(routes.jax_ids) == n_moe
    assert routes.apart <= MAX_APART, routes.apart
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=3e-2 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg, (2, 3), seed=2)
    jcache = jm.init_cache(2, 16, dtype=jnp.float32)
    cache = pm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert set(cache) == set(jcache)
    jdecode = jax.jit(jm.decode_step)
    for t in range(3):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t]))
        lg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), _np(jl), rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), np.array(jnp.argmax(jl, -1)))
    assert int(cache["pos"]) == int(jcache["pos"]) == 3
    for layer, leaves in jcache.items():
        if layer == "pos":
            continue
        assert set(cache[layer]) == set(leaves)
        for name, v in leaves.items():
            np.testing.assert_allclose(cache[layer][name].numpy(), _np(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{layer}/{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_f32(arch):
    """The twin of tests/test_arch_smoke.py::test_decode_matches_prefill_f32,
    with no token dropped at capacity in the prefill (decode never drops)."""
    _, _, pm, pp = _pair(arch, **_no_drop(arch))
    toks = torch.from_numpy(_tokens(pm.cfg, (1, 12), seed=3))
    full, _ = pm.apply(pp, {"tokens": toks})
    cache = pm.init_cache(1, 12, dtype=torch.float32, device="cpu")
    for t in range(12):
        lg, cache = pm.decode_step(pp, cache, toks[:, t])
        torch.testing.assert_close(lg, full[:, t], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg, (4, 24), seed=4)
    weights = np.array([0.0, 1.5, 0.0, 0.5], np.float32)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}, jnp.asarray(weights)),
        has_aux=True))(jp)
    tl, tmet, tg = loss_and_grads(pm, pp, {"tokens": torch.from_numpy(toks)},
                                  torch.from_numpy(weights))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4)
    for k in ("loss", "per_example", "moe_aux"):
        np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), rtol=1e-4, err_msg=k)
    assert (float(tmet["moe_aux"]) > 0) == bool(pm.cfg.n_experts)
    assert set(tg) == set(jg)
    for k, g in jg.items():
        want = _np(g)
        assert tg[k].dtype == torch.float32 and tuple(tg[k].shape) == want.shape, k
        np.testing.assert_allclose(_np(tg[k]), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

_MLA = {}


def _mla_setup(**over):
    """JAX's own setup of tests/test_attention_variants.py (deepseek-v2's
    smoke MLA in f32 on a latent cache of 8 slots), with the port's twins
    (cached a config)."""
    key = tuple(sorted(over.items()))
    if key not in _MLA:
        _MLA[key] = _mla_draw(**over)
    return _MLA[key]


def _mla_draw(**over):
    cfg = dataclasses.replace(j_smoke("deepseek-v2-236b"), dtype="float32", **over)

    def draw(key):
        pb = JParamBuilder(key, dtype=jnp.float32)
        j_attn.add_mla_params(pb, "a", cfg)
        x = jax.random.normal(jax.random.fold_in(key, 1), (2, 1, cfg.d_model), jnp.float32)
        lat = jax.random.normal(jax.random.fold_in(key, 2), (2, 8, cfg.kv_lora_rank)) * 0.5
        kr = jax.random.normal(jax.random.fold_in(key, 3), (2, 8, cfg.qk_rope_dim)) * 0.5
        return pb.params, x, lat, kr

    params, x, lat, kr = jax.jit(draw)(KEY)
    tcfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), dtype="float32", **over)
    return cfg, params, x, lat, kr, tcfg, convert.model_params(params, "cpu")


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_absorbed_decode_equals_naive_and_jax(q_lora):
    """The twin of tests/test_attention_variants.py::test_mla_absorbed_decode_equals_naive
    (rtol 1e-4 / atol 1e-5; the latent cache bitwise), with and without the
    query LoRA, each against JAX's absorbed step."""
    over = {} if q_lora else {"q_lora_rank": 0}
    cfg, jp, x, lat, kr, tcfg, tp = _mla_setup(**over)
    assert ("a/wq_down" in tp) == q_lora and ("a/wq" in tp) != q_lora
    jy, jl, jk = jax.jit(lambda *a: j_attn.mla_decode(*a[:2], x, cfg, *a[2:], absorb=True),
                         static_argnums=1)(jp, "a", lat, kr, jnp.array(5))
    tx, pos = torch.from_numpy(np.array(x)), torch.tensor(5, dtype=torch.int32)
    outs = []
    for absorb in (True, False):
        tl, tk = torch.from_numpy(np.array(lat)), torch.from_numpy(np.array(kr))
        y, l2, k2 = attn.mla_decode(tp, "a", tx, tcfg, tl, tk, pos, absorb=absorb)
        assert l2 is tl and k2 is tk                       # written in place
        outs.append((y, l2, k2))
    (y_abs, l1, k1), (y_naive, l2, k2) = outs
    np.testing.assert_allclose(y_abs.numpy(), y_naive.numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(l1, l2) and torch.equal(k1, k2)
    np.testing.assert_allclose(y_abs.numpy(), np.array(jy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(l1.numpy(), np.array(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(k1.numpy(), np.array(jk), rtol=1e-5, atol=1e-6)


def test_mla_prefill_matches_jax():
    cfg, jp, _, _, _, tcfg, tp = _mla_setup()
    x = jax.random.normal(jax.random.fold_in(KEY, 4), (2, 9, cfg.d_model), jnp.float32)
    want = jax.jit(lambda p, xx: j_attn.mla_prefill(p, "a", xx, cfg))(jp, x)
    got = attn.mla_prefill(tp, "a", torch.from_numpy(np.array(x)), tcfg)
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-4, atol=1e-5)


def test_mla_ring_cache_decode_matches_windowed_prefill_and_jax():
    """minicpm3 on a ring of 8 latent slots over 12 steps (it wraps at step
    8) equals a prefill whose attention window is 8, and JAX's ring decode."""
    jm, jp, pm, pp = _pair("minicpm3-4b", local_attn_window=8)
    toks = _tokens(pm.cfg, (1, 12), seed=5)
    full, _ = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    cache = pm.init_cache(1, 12, window=8, dtype=torch.float32, device="cpu")
    jcache = jm.init_cache(1, 12, window=8, dtype=jnp.float32)
    assert cache["blocks"]["latent"].shape == (2, 1, 8, pm.cfg.kv_lora_rank)
    jdecode = jax.jit(jm.decode_step, static_argnames="window")
    for t in range(12):
        lg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]), window=8)
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t]), window=8)
        torch.testing.assert_close(lg, full[:, t], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(lg.numpy(), _np(jl), rtol=1e-4, atol=1e-5)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(cache["blocks"][name].numpy(), _np(jcache["blocks"][name]),
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# MoE dispatch, bitwise on the integers
# ---------------------------------------------------------------------------

def _jax_plan(cfg, x, router):
    """JAX's router and dispatch on (B, S, d) ``x`` in ``cfg.dtype``:
    (probs, topi, and per row: t_sorted, slot, keep_w, buf) as numpy."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(int(s * k * cfg.capacity_factor / e), 1)

    def plan(x, router):
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, router).astype(jnp.float32), -1)
        topw, topi = jax.lax.top_k(probs, k)
        topw = topw / jnp.maximum(jnp.sum(topw, -1, keepdims=True), 1e-9)
        buf, t_sorted, slot, keep_w = jax.vmap(
            lambda xr, ir, wr: j_moe._dispatch_one(xr, ir, wr, e, k, cap))(x, topi, topw)
        return probs, topi, t_sorted, slot, keep_w, buf

    out = jax.jit(plan)(jnp.asarray(x, cfg.dtype), jnp.asarray(router, cfg.dtype))
    return [np.array(a) for a in out], cap


def _port_plan(cfg, x, router, probs=None):
    e, k = cfg.n_experts, cfg.experts_per_token
    if probs is None:
        probs = torch.softmax((x @ router).float(), dim=-1)
    topw, topi = moe.route(probs, k)
    order, slot, keep_w = moe.dispatch(topi, topw, e, moe.capacity(cfg, probs.shape[1]))
    return probs, topi, torch.div(order, k, rounding_mode="floor"), slot, keep_w


def _moe_cfg(arch="deepseek-v2-236b", dtype="float32"):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def test_router_ties_go_to_the_lower_expert_id():
    """A zero router gives every expert the same probability: JAX's
    ``lax.top_k`` picks experts 0..k-1 for every token, and so does the
    port (``torch.topk`` fixes no order among ties)."""
    jcfg, cfg = _moe_cfg("dbrx-132b")
    x = np.random.default_rng(6).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    (_, jtopi, jt, jslot, jkeep, _), cap = _jax_plan(jcfg, x, router)
    _, topi, t_sorted, slot, keep_w = _port_plan(cfg, torch.from_numpy(x),
                                                 torch.from_numpy(router))
    k = cfg.experts_per_token
    assert (jtopi == np.arange(k)).all()
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    np.testing.assert_array_equal(t_sorted.numpy(), jt)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(keep_w.numpy(), jkeep)
    # 24 tokens on experts 0 and 1 of 4 with cap 15: the last 9 of each drop
    assert cap == 15 and int((slot == cfg.n_experts * cap).sum()) == 2 * 2 * 9


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_drops_what_jax_drops(arch, dtype):
    """A router skewed toward expert 0 makes the capacity bind, and experts
    1 and 2 share a column, so they tie in every token: the top-k ids, the
    stable expert order of the tokens, the slots, the keep mask and so
    which tokens drop equal JAX's on the integers, on the same
    probabilities."""
    jcfg, cfg = _moe_cfg(arch, dtype=dtype)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 40, cfg.d_model)).astype(np.float32)
    router = (0.05 * rng.standard_normal((cfg.d_model, cfg.n_experts))).astype(np.float32)
    router[:, 0] += 0.05                                  # skew toward expert 0
    router[:, 2] = router[:, 1]                           # experts 1 and 2 tie exactly
    (jprobs, jtopi, jt, jslot, jkeep, _), cap = _jax_plan(jcfg, x, router)
    probs, topi, t_sorted, slot, keep_w = _port_plan(cfg, None, None,
                                                     probs=torch.from_numpy(jprobs))
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    np.testing.assert_array_equal(t_sorted.numpy(), jt)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_array_equal(keep_w.numpy() != 0, jkeep != 0)
    np.testing.assert_allclose(keep_w.numpy(), jkeep, rtol=1e-6)
    dropped = slot == cfg.n_experts * cap
    assert int(dropped.sum()) > 0                         # the capacity binds
    desc = -np.sort(-jprobs, -1)
    k = cfg.experts_per_token
    assert int((desc[..., k - 1] == desc[..., k]).sum()) > 0   # ties at the top-k boundary


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "dbrx-132b"])
def test_moe_ffn_matches_jax(arch):
    """One MoE layer in f32 at the default capacity (tokens drop) against
    JAX's: the output and the aux loss."""
    jcfg, cfg = _moe_cfg(arch)

    def draw(key):
        pb = JParamBuilder(key, dtype=jnp.float32)
        j_moe.add_moe_params(pb, "m", jcfg)
        return pb.params, jax.random.normal(jax.random.fold_in(key, 8), (2, 40, cfg.d_model))

    params, x = jax.jit(draw)(KEY)
    want, jaux = jax.jit(lambda p, xx: j_moe.moe_ffn(p, "m", xx, jcfg))(params, x)
    got, aux = moe.moe_ffn(convert.model_params(params, "cpu"), "m",
                           torch.from_numpy(np.array(x)), cfg)
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
