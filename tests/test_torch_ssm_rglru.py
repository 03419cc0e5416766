"""Parity of the port's SSD (mamba-2) and RG-LRU hybrid decoders with the
JAX package's.

The two smoke configs (mamba2: 2 SSD layers under ``blocks/``, width 256,
8 heads of 64, state 32, chunk 32; recurrentgemma: rglru, rglru, attn
under ``layers/NN/``, width 256, MQA with 4 query heads, local window 64):
JAX ``init`` -> ``convert.model_params`` -> the port, so both run the
same weights.  On the CPU the port's attention is the chunked plain path.

Tolerances: the block functions and f32 logits at rtol 1e-4 / atol 1e-5
(sums and products in another order: the SSD chunk's contractions are
batched products, the RG-LRU recurrence a doubling scan where JAX runs an
associative tree); decode against prefill rtol/atol 2e-3 (the JAX test's
own, ``tests/test_arch_smoke.py``); bf16 logits within ``BF16_ATOL`` of
the largest logit: XLA on the CPU fuses chains of bf16 elementwise ops
(the conv's four-term sum, ``y * silu(z)``, the gate's GELU product) and
may keep their intermediates in f32, where torch rounds each op to bf16,
so one-ulp differences enter every layer and carry through the
recurrences.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.layers import ParamBuilder as JParamBuilder  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402

ARCHS = ["mamba2-1.3b", "recurrentgemma-2b"]
KEY = jax.random.PRNGKey(0)
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 3e-2      # of the largest |logit|: the dense models' rule (test_torch_models.py)
EXP_OVERFLOW = 88.72  # log of the largest f32


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
    parameters converted (drawn once an arch and layout, in f32 under
    ``jit``, rounded to bf16 for the bf16 models); ``over`` changes config
    fields, ``lru_gate_blocks`` included (it reshapes the gates, so it is
    part of the cache key)."""
    layout = tuple(sorted((k, v) for k, v in over.items() if k == "lru_gate_blocks"))
    if (arch, dtype, layout) not in _PAIRS:
        if dtype == "float32":
            jm = j_build(dataclasses.replace(j_smoke(arch), dtype=dtype, **dict(layout)),
                         remat="none")
            jp = jax.jit(lambda key: jm.init(key)[0])(KEY)
        else:
            jp = jax.tree.map(lambda a: a.astype(dtype), _pair(arch, **dict(layout))[1])
        _PAIRS[arch, dtype, layout] = jp, convert.model_params(jp, "cpu")
    jp, pp = _PAIRS[arch, dtype, layout]
    jm = j_build(dataclasses.replace(j_smoke(arch), dtype=dtype, **over), remat="none")
    pm = build_model(dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over),
                     remat="none")
    return jm, jp, pm, pp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.array(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# configs and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["phi-3-vision-4.2b"])
def test_configs_equal_jax_field_for_field(arch):
    from repro.configs import get_config as j_config

    for mine, theirs in ((get_config(arch), j_config(arch)),
                         (get_smoke_config(arch), j_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_have_the_jax_layout(arch):
    jm, jp, pm, pp = _pair(arch, dtype="bfloat16")
    specs, jlogical = jm.param_specs()
    mine, logical = pm.param_specs()
    assert set(pp) == set(specs) == set(mine)
    assert logical == jlogical
    if arch == "mamba2-1.3b":
        assert "blocks/b/ssm/a_log" in pp and not any(k.startswith("layers/") for k in pp)
        assert "blocks/b/norm2" not in pp                     # no FFN in a mamba block
    else:
        assert "layers/00/b/rglru/lam" in pp and "layers/02/b/attn/wq" in pp
        assert not any(k.startswith("blocks/") for k in pp)
    for k, s in specs.items():
        assert tuple(pp[k].shape) == tuple(s.shape) == tuple(mine[k].shape), k
        assert pp[k].dtype == mine[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(pp[k].view(torch.int16).numpy(),
                                      np.array(jp[k]).view(np.int16), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_have_the_jax_layout(arch):
    """At full width and depth: the same keys, shapes and dtypes (meta
    tensors, no storage)."""
    from repro.configs import get_config as j_config

    jspecs, _ = j_build(j_config(arch)).param_specs()
    mine, _ = build_model(get_config(arch)).param_specs()
    assert set(mine) == set(jspecs)
    for k, s in jspecs.items():
        assert tuple(mine[k].shape) == tuple(s.shape) and str(s.dtype) == "bfloat16", k
        assert mine[k].dtype == torch.bfloat16, k


def test_port_init_follows_the_jax_inits():
    """The port's own draws follow JAX's init kinds: ``dt_bias`` and
    ``a_log`` zeros, ``d_skip``, ``norm`` and ``lam`` ones, the convs at std
    0.5 and the gates at 0.02 (within 10 %)."""
    for arch in ARCHS:
        pm = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
        params, _ = pm.init(torch.Generator().manual_seed(0), device="cpu")
        for k, p in params.items():
            leaf = k.rsplit("/", 1)[-1]
            if leaf in ("dt_bias", "a_log"):
                assert not bool(p.any()), k
            elif leaf in ("d_skip", "lam") or "norm" in leaf:
                assert bool((p == 1).all()), k
            elif leaf.startswith("conv") or leaf in ("w_a", "w_i"):
                std = 0.5 if leaf.startswith("conv") else 0.02
                assert abs(float(p.std()) / std - 1.0) < 0.1, (k, float(p.std()))


# ---------------------------------------------------------------------------
# the block functions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(carry, dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 9, 24)), dtype)
    w = jnp.asarray(rng.standard_normal((4, 24)) * 0.5, dtype)
    tail = jnp.asarray(rng.standard_normal((2, 3, 24)), dtype) if carry else None
    want, want_tail = j_ssm._causal_conv(x, w, tail)
    got, got_tail = ssm._causal_conv(convert.tensor(x, "cpu"), convert.tensor(w, "cpu"),
                                     None if tail is None else convert.tensor(tail, "cpu"))
    assert got.dtype == got_tail.dtype == convert.tensor(x, "cpu").dtype
    tol = F32 if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_array_equal(_np(got_tail), _np(want_tail))     # a slice: exact


def _chunk_inputs(el, a_log=0.0, seed=2, b=2, h=3, p=8, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, el, h, p)).astype(np.float32)
    bb = rng.standard_normal((b, el, n)).astype(np.float32)
    c = rng.standard_normal((b, el, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, el, h)))).astype(np.float32)   # softplus
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    a_heads = -np.exp(np.full(h, a_log, np.float32) + np.arange(h, dtype=np.float32) * 0.1)
    return state, (x, bb, c, dt), a_heads.astype(np.float32)


def _max_upper_exponent(dt, a_heads):
    """The largest decay exponent cum_i - cum_j above the diagonal (i < j)."""
    cum = np.cumsum(dt.astype(np.float64) * a_heads, axis=1)
    return float((cum[:, :1] - cum[:, -1:]).max())


@pytest.mark.parametrize("el,a_log", [(1, 0.0), (7, 0.0), (32, 0.0), (64, 2.5)])
def test_ssd_chunk_matches_jax(el, a_log):
    """One chunk from a nonzero state; the last case drives the upper
    triangle's exponent past exp's f32 overflow, and stays finite."""
    state, xs, a_heads = _chunk_inputs(el, a_log)
    if a_log:
        assert _max_upper_exponent(xs[3], a_heads) > EXP_OVERFLOW
    want_state, want_y = j_ssm._ssd_chunk(jnp.asarray(state), tuple(map(jnp.asarray, xs)),
                                          jnp.asarray(a_heads))
    got_state, got_y = ssm._ssd_chunk(_t(state), tuple(map(_t, xs)), _t(a_heads))
    assert bool(torch.isfinite(got_y).all()) and bool(torch.isfinite(got_state).all())
    for got, want in ((got_y, _np(want_y)), (got_state, _np(want_state))):
        np.testing.assert_allclose(got.numpy(), want, **_ssd_tol(a_log, want))


def _ssd_tol(a_log, want):
    """F32, but where the decay is fast the cumulative sums reach |cum| ~
    10^2-10^3 (767 in the chunk case), where one f32 ulp is ~6e-5 absolute:
    each decay weight then carries ~1e-4 relative error whichever order the
    cumsum adds in, so atol is 1e-5 of the largest output."""
    return F32 if not a_log else dict(rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


def _ssm_params(cfg, seed, a_log=None):
    def draw(key):
        pb = JParamBuilder(key, dtype=jnp.float32)
        j_ssm.add_ssm_params(pb, "s", cfg)
        return pb.params

    jp = jax.jit(draw)(jax.random.PRNGKey(seed))
    if a_log is not None:
        jp = dict(jp, **{"s/a_log": jnp.full_like(jp["s/a_log"], a_log),
                         "s/dt_bias": jnp.full_like(jp["s/dt_bias"], 1.0)})
    return jp, convert.model_params(jp, "cpu")


@pytest.mark.parametrize("s,a_log", [(40, None), (20, None), (64, None), (64, 2.0)])
def test_ssm_forward_matches_jax(s, a_log):
    """S = 40 is not a multiple of the chunk (32), S = 20 is shorter than it,
    S = 64 two whole chunks; with a_log = 2 and dt_bias = 1 the decay
    exponent above the diagonal passes exp's f32 overflow in every chunk."""
    cfg = dataclasses.replace(j_smoke("mamba2-1.3b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), dtype="float32")
    jp, tp = _ssm_params(cfg, 3, a_log)
    u = jax.random.normal(jax.random.fold_in(KEY, s), (2, s, cfg.d_model), jnp.float32)
    if a_log is not None:
        dt = jax.nn.softplus(jnp.einsum("bsd,dh->bsh", u, jp["s/w_dt"]) + jp["s/dt_bias"])
        a_heads = -np.exp(np.array(jp["s/a_log"]))
        assert _max_upper_exponent(np.array(dt)[:, :cfg.ssm_chunk], a_heads) > EXP_OVERFLOW
    want = jax.jit(lambda p, x: j_ssm.ssm_forward(p, "s", x, cfg))(jp, u)
    got = ssm.ssm_forward(tp, "s", _t(u), tcfg)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), _np(want), **_ssd_tol(a_log, _np(want)))


@pytest.mark.parametrize("s", [1, 2, 5, 33, 64])
def test_linear_scan_matches_jax_and_a_loop(s):
    rng = np.random.default_rng(4)
    a = rng.uniform(0.0, 1.0, (2, s, 6)).astype(np.float32)
    b = rng.standard_normal((2, s, 6)).astype(np.float32)
    got = rglru.linear_scan(_t(a), _t(b))
    h, loop = np.zeros((2, 6), np.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(loop, 1), rtol=1e-5, atol=1e-6)

    def combine(lft, rgt):
        return lft[0] * rgt[0], lft[1] * rgt[0] + rgt[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("blocks", [0, 4])
def test_rglru_forward_matches_jax(blocks):
    """Dense gates (the smoke config's) and block-diagonal ones (4 blocks)."""
    cfg = dataclasses.replace(j_smoke("recurrentgemma-2b"), dtype="float32",
                              lru_gate_blocks=blocks)
    tcfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"), dtype="float32",
                               lru_gate_blocks=blocks)

    def draw(key):
        pb = JParamBuilder(key, dtype=jnp.float32)
        j_rglru.add_rglru_params(pb, "r", cfg)
        return pb.params

    jp = jax.jit(draw)(jax.random.PRNGKey(5))
    tp = convert.model_params(jp, "cpu")
    assert tp["r/w_a"].dim() == (3 if blocks else 2)
    u = jax.random.normal(jax.random.fold_in(KEY, 6), (2, 37, cfg.d_model), jnp.float32)
    want = jax.jit(lambda p, x: j_rglru.rglru_forward(p, "r", x, cfg))(jp, u)
    got = rglru.rglru_forward(tp, "r", _t(u), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    # one decode step from a carried state and conv tail
    rng = np.random.default_rng(7)
    cache = {"h": rng.standard_normal((2, 256)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, 256)).astype(np.float32)}
    jy, jc = j_rglru.rglru_decode(jp, "r", u[:, :1], cfg, {k: jnp.asarray(v) for k, v in
                                                            cache.items()})
    tc = {k: _t(v) for k, v in cache.items()}
    ty, tc2 = rglru.rglru_decode(tp, "r", _t(u[:, :1]), tcfg, tc)
    assert tc2["h"] is tc["h"] and tc2["conv"] is tc["conv"]          # written in place
    np.testing.assert_allclose(ty.numpy(), _np(jy), **F32)
    for k in cache:
        np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]), **F32)


# ---------------------------------------------------------------------------
# the models against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax_f32(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg, (2, 40))
    want, _ = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})
    got, aux = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 40, pm.cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax_bf16(arch):
    jm, jp, pm, pp = _pair(arch, dtype="bfloat16")
    toks = _tokens(pm.cfg, (2, 40), seed=1)
    want = _np(jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})[0])
    got, _ = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_ATOL * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg, (3, 33), seed=5)
    want = jax.jit(j_steps.make_prefill_step(jm))(jp, {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(pm)(pp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, 1, pm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def _same_cache(cache, jcache):
    assert set(cache) == set(jcache) and int(cache["pos"]) == int(jcache["pos"])
    for layer, leaves in jcache.items():
        if layer == "pos":
            continue
        assert set(cache[layer]) == set(leaves), layer
        for name, v in leaves.items():
            assert tuple(cache[layer][name].shape) == tuple(v.shape), (layer, name)
            np.testing.assert_allclose(cache[layer][name].numpy(), _np(v), **F32,
                                       err_msg=f"{layer}/{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = _tokens(pm.cfg, (2, 3), seed=2)
    jcache = jm.init_cache(2, 16, dtype=jnp.float32)
    cache = pm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jdecode = jax.jit(jm.decode_step)
    for t in range(3):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t]))
        lg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), _np(jl), **F32)
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), np.array(jnp.argmax(jl, -1)))
    _same_cache(cache, jcache)


@pytest.mark.parametrize("arch,over", [("mamba2-1.3b", {}), ("recurrentgemma-2b", {}),
                                       ("recurrentgemma-2b", {"lru_gate_blocks": 4})],
                         ids=["mamba2", "recurrentgemma", "recurrentgemma-blockdiag"])
def test_decode_matches_prefill_f32(arch, over):
    """The twins of tests/test_arch_smoke.py::test_decode_matches_prefill_f32
    and ::test_rglru_block_diagonal_gates_decode_consistency (12 steps)."""
    _, _, pm, pp = _pair(arch, **over)
    toks = torch.from_numpy(_tokens(pm.cfg, (1, 12), seed=3))
    full, _ = pm.apply(pp, {"tokens": toks})
    cache = pm.init_cache(1, 12, dtype=torch.float32, device="cpu")
    for t in range(12):
        lg, cache = pm.decode_step(pp, cache, toks[:, t])
        torch.testing.assert_close(lg, full[:, t], rtol=2e-3, atol=2e-3)


def test_block_diagonal_gates_match_jax():
    """recurrentgemma with 4 gate blocks: apply and 3 decode steps equal JAX's."""
    jm, jp, pm, pp = _pair("recurrentgemma-2b", lru_gate_blocks=4)
    assert tuple(pp["layers/00/b/rglru/w_a"].shape) == (4, 64, 64)
    toks = _tokens(pm.cfg, (2, 24), seed=8)
    want, _ = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})
    got, _ = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    jcache = jm.init_cache(2, 8, dtype=jnp.float32)
    cache = pm.init_cache(2, 8, dtype=torch.float32, device="cpu")
    for t in range(3):
        jl, jcache = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(toks[:, t]))
        lg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), _np(jl), **F32)
    _same_cache(cache, jcache)


def test_local_attention_ring_wraps_like_jax():
    """recurrentgemma's attention layer with its local window cut to 8: the
    ring of 8 slots wraps at step 8; 14 decode steps equal a prefill whose
    attention window is 8, and JAX's decode, cache included."""
    jm, jp, pm, pp = _pair("recurrentgemma-2b", local_attn_window=8)
    toks = _tokens(pm.cfg, (1, 14), seed=9)
    full, _ = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    jfull, _ = jax.jit(jm.apply)(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(full.numpy(), _np(jfull), **F32)
    cache = pm.init_cache(1, 14, dtype=torch.float32, device="cpu")
    jcache = jm.init_cache(1, 14, dtype=jnp.float32)
    assert cache["layers/02"]["k"].shape == (1, 1, 8, 64)      # the ring, not the context
    assert cache["layers/00"]["h"].shape == (1, 256)
    jdecode = jax.jit(jm.decode_step)
    for t in range(14):
        lg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]))
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t]))
        torch.testing.assert_close(lg, full[:, t], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(lg.numpy(), _np(jl), **F32)
    _same_cache(cache, jcache)


@pytest.mark.parametrize("arch,name", [("mamba2-1.3b", "mamba2-smoke"),
                                       ("recurrentgemma-2b", "recurrentgemma-smoke")])
def test_serve_cli_serves_the_archs_on_the_cpu(capsys, arch, name):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"[serve] {name}: 3 tokens x 8 seqs in ")
    assert "tok/s" in out and out.rstrip().endswith("cache pos=3")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax(arch):
    """Four greedy steps from token 0, as the CLI loops them: the tokens
    bitwise, the caches at the f32 tolerance."""
    jm, jp, pm, pp = _pair(arch)
    jserve, serve_step = jax.jit(j_steps.make_serve_step(jm)), steps.make_serve_step(pm)
    jcache = jm.init_cache(4, 16, dtype=jnp.float32)
    cache = pm.init_cache(4, 16, dtype=torch.float32, device="cpu")
    jtok, tok = jnp.zeros((4,), jnp.int32), torch.zeros((4,), dtype=torch.int32)
    for _ in range(4):
        jtok, jcache = jserve(jp, jcache, jtok)
        tok, cache = serve_step(pp, cache, tok)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.array(jtok))
    _same_cache(cache, jcache)
