"""Parity of the port's audio encoder (hubert-xlarge) with the JAX package's.

hubert's smoke config (2 non-causal GQA layers, width 256, 8 heads, GELU
MLPs, vocabulary 64): JAX ``init`` -> ``convert.model_params`` -> the
port, so both run the same weights, on the same frames (B, T, 256),
labels and mask drawn with numpy in the model's dtype.  The conv feature
extractor is a stub in both packages: the batch carries frame embeddings,
to which a sinusoidal position embedding is added.  ``embed`` is a
parameter the audio forward never reads: its gradient is zero.

Tolerances: ``_sinusoidal_pe`` in f32 rtol/atol 1e-6 at the tests'
lengths (its angles reach S - 1 radians; XLA's and torch's ``sin``,
``cos`` and ``power`` part by ulps), and at the full config's S = 2048 an
atol of (S - 1) 2^-23 (an ulp of ``power`` carried through the angle);
``layer_norm`` f32 rtol 1e-6 / atol 1e-6, bf16 within one bf16 ulp; f32
logits rtol 1e-4 / atol 1e-5 (sums in another order); the loss rtol 1e-5
and gradients rtol 1e-4
with an absolute floor of 1e-4 of the tensor's largest entry
(``tests/test_torch_train.py``'s rule); bf16 logits within 3e-2 of the
largest logit (the dense models' rule).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH = "hubert-xlarge"
KEY = jax.random.PRNGKey(0)
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A tiny model: one intra-op thread, so the test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _pair(dtype="float32"):
    """The JAX model, its parameters, the port's model and the same
    parameters converted (drawn once in f32, rounded to bf16 for the bf16
    model)."""
    if dtype not in _PARAMS:
        if dtype == "float32":
            jm = j_build(dataclasses.replace(j_smoke(ARCH), dtype=dtype), remat="none")
            jp = jax.jit(lambda key: jm.init(key)[0])(KEY)
        else:
            jp = jax.tree.map(lambda a: a.astype(dtype), _pair()[1])
        _PARAMS[dtype] = jp, convert.model_params(jp, "cpu")
    jp, pp = _PARAMS[dtype]
    jm = j_build(dataclasses.replace(j_smoke(ARCH), dtype=dtype), remat="none")
    pm = build_model(dataclasses.replace(get_smoke_config(ARCH), dtype=dtype), remat="none")
    return jm, jp, pm, pp


def _batch(cfg, b, t, seed=0, dtype=np.float32, empty_row=False):
    """Frames (in ``dtype``), labels and a mask drawn with numpy at
    ``mask_prob`` (at least one masked frame a row; with ``empty_row`` the
    first row has none): the JAX batch and the port's."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    mask = rng.random((b, t)) < max(cfg.mask_prob, 0.3)
    mask[:, 0] = True
    if empty_row:
        mask[0] = False
    jb = {"frames": jnp.asarray(frames, dtype), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    tb = {"frames": convert.tensor(np.array(jb["frames"]), "cpu"),
          "labels": torch.from_numpy(labels), "mask": torch.from_numpy(mask)}
    return jb, tb


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.array(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# config, layout, the two new primitives
# ---------------------------------------------------------------------------

def test_configs_equal_jax_field_for_field():
    for mine, theirs in ((get_config(ARCH), j_config(ARCH)),
                         (get_smoke_config(ARCH), j_smoke(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
    assert get_config(ARCH).is_encoder and not get_config(ARCH).is_decoder


def test_converted_params_have_the_jax_layout():
    """The smoke model's converted parameters (bf16, bit for bit) and the
    full config's specs have JAX's keys, shapes and dtypes, ``embed`` (the
    parameter no audio forward reads) and ``unembed`` included."""
    jm, jp, pm, pp = _pair(dtype="bfloat16")
    specs, jlogical = jm.param_specs()
    mine, logical = pm.param_specs()
    assert set(pp) == set(specs) == set(mine) and logical == jlogical
    assert {"embed", "unembed", "blocks/b/mlp/b_in", "blocks/b/attn/wq"} <= set(pp)
    assert not any(k.startswith("layers/") for k in pp)
    for k, s in specs.items():
        assert tuple(pp[k].shape) == tuple(s.shape) == tuple(mine[k].shape), k
        assert pp[k].dtype == mine[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(pp[k].view(torch.int16).numpy(),
                                      np.array(jp[k]).view(np.int16), err_msg=k)
    jfull, _ = j_build(j_config(ARCH)).param_specs()
    full, _ = build_model(get_config(ARCH)).param_specs()
    assert set(full) == set(jfull)
    for k, s in jfull.items():
        assert tuple(full[k].shape) == tuple(s.shape) and full[k].dtype == torch.bfloat16, k


@pytest.mark.parametrize("seq,d", [(1, 8), (24, 256), (2048, 1280)])
def test_sinusoidal_pe_matches_jax(seq, d):
    """At the tests' lengths (S <= 24) within rtol/atol 1e-6.  At the full
    config's S = 2048 XLA's ``power(10000, dim / d)`` and torch's part by an
    ulp on a few dims, which the angle (up to S - 1 radians) carries into
    an absolute difference up to (S - 1) 2^-23: that is the atol there."""
    want = np.array(j_model._sinusoidal_pe(seq, d, jnp.float32))
    got = model_mod._sinusoidal_pe(seq, d, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    atol = 1e-6 if seq <= 24 else 1e-6 + (seq - 1) * 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)
    bf = model_mod._sinusoidal_pe(seq, d, torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 96)) * 3 + 1.5).astype(np.float32)
    gamma = rng.standard_normal(96).astype(np.float32)
    beta = rng.standard_normal(96).astype(np.float32)
    jx, jg, jb = (jnp.asarray(a, dtype) for a in (x, gamma, beta))
    want = j_layers.layer_norm(jx, jg, jb)
    got = layers.layer_norm(*(convert.tensor(np.array(a), "cpu") for a in (jx, jg, jb)))
    assert str(got.dtype) == f"torch.{dtype}"
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7, atol=0)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["plain", "kernel"])
def test_apply_matches_jax_f32(attn_impl):
    """Non-causal attention, on the plain route and on the kernel route
    (its plain version on the CPU)."""
    jm, jp, _, pp = _pair()
    pm = Model(dataclasses.replace(get_smoke_config(ARCH), dtype="float32"), remat="none",
               attn_impl=attn_impl)
    jb, tb = _batch(pm.cfg, 2, 24)
    want, _ = jax.jit(jm.apply)(jp, jb)
    got, aux = pm.apply(pp, tb)
    assert got.shape == (2, 24, pm.cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    # bidirectional: the first frame's logits depend on the last frame
    moved = dict(tb, frames=tb["frames"].clone())
    moved["frames"][:, -1] += 1.0
    assert not torch.allclose(pm.apply(pp, moved)[0][:, 0], got[:, 0])


def test_apply_matches_jax_bf16():
    """bf16 weights and frames, as the launcher draws them: the PE added in
    bf16 on both sides."""
    jm, jp, pm, pp = _pair(dtype="bfloat16")
    jb, tb = _batch(pm.cfg, 2, 24, seed=1, dtype=jnp.bfloat16)
    want = _np(jax.jit(jm.apply)(jp, jb)[0])
    got, _ = pm.apply(pp, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 24, pm.cfg.vocab_size)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


def test_frames_go_to_the_parameters_dtype():
    """bf16 frames into the f32 model: the PE is added in bf16 (JAX's
    dtype for the sum), then the sum is cast to f32 (torch's products
    take no mixed dtypes)."""
    _, _, pm, pp = _pair()
    _, tb = _batch(pm.cfg, 1, 8, seed=2)
    frames = tb["frames"].to(torch.bfloat16)
    x = pm._embed_inputs(pp, {"frames": frames})
    pe = model_mod._sinusoidal_pe(8, pm.cfg.d_model, torch.bfloat16)
    assert x.dtype == torch.float32 and torch.equal(x, (frames + pe).float())


@pytest.mark.parametrize("ce_chunk", [0, 7])
def test_loss_and_grads_match_jax(ce_chunk):
    """The masked loss (a row without a masked frame counts 0, divided by
    max(sum mask, 1)) with example weights: loss, per-example losses and
    every gradient equal JAX's, ``embed``'s zeros included; the CE in
    chunks of 7 (one padded) too."""
    jm, jp, _, pp = _pair()
    pm = Model(dataclasses.replace(get_smoke_config(ARCH), dtype="float32"), remat="none",
               ce_chunk=ce_chunk)
    jb, tb = _batch(pm.cfg, 4, 20, seed=4, empty_row=True)
    weights = np.array([1.0, 1.5, 0.0, 0.5], np.float32)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, jnp.asarray(weights)), has_aux=True))(jp)
    tl, tmet, tg = loss_and_grads(pm, pp, tb, torch.from_numpy(weights))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for k in ("loss", "per_example", "moe_aux"):
        np.testing.assert_allclose(_np(tmet[k]), _np(jmet[k]), rtol=1e-5, err_msg=k)
    assert float(tmet["per_example"][0]) == 0.0
    assert set(tg) == set(jg)
    for k, g in jg.items():
        want = _np(g)
        assert tg[k].dtype == torch.float32 and tuple(tg[k].shape) == g.shape, k
        np.testing.assert_allclose(_np(tg[k]), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)
    assert not np.any(_np(jg["embed"])) and not torch.any(tg["embed"])


def test_loss_reads_only_masked_frames():
    """Labels of unmasked frames do not move the loss."""
    _, _, pm, pp = _pair()
    _, tb = _batch(pm.cfg, 2, 16, seed=5)
    base, _ = pm.loss(pp, tb)
    other = dict(tb, labels=torch.where(tb["mask"], tb["labels"],
                                        (tb["labels"] + 1) % pm.cfg.vocab_size))
    assert torch.equal(pm.loss(pp, other)[0], base)


def test_prefill_step_gives_every_frame():
    """An encoder's prefill returns the logits of every frame (JAX's
    ``make_prefill_step``: no ``last_only``)."""
    jm, jp, pm, pp = _pair()
    jb, tb = _batch(pm.cfg, 3, 17, seed=6)
    want = jax.jit(j_steps.make_prefill_step(jm))(jp, jb)
    got = steps.make_prefill_step(pm)(pp, tb)
    assert got.shape == (3, 17, pm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_init_cache_is_refused():
    _, _, pm, _ = _pair()
    with pytest.raises(ValueError, match="encoder-only"):
        pm.init_cache(2, 16, device="cpu")
