"""Parity of the port's optimizers with the JAX package's.

The same parameter trees (a matrix, a stacked matrix, a vector; f32 and
bf16) and the same five gradient trees, drawn from a seed with numpy, go
through JAX's and the port's ``sgd`` (momentum 0 and 0.9, nesterov) and
``adamw`` (the clip on and off, weight decay on and off); each side carries
its own state and parameters.  Updates, moments and parameters are held at
rtol 1e-6 (atol 1e-7 for entries near zero: a global norm summed in
another order moves every update by an ulp); ``count`` bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.optim.optimizers import apply_updates as j_apply  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.optim.optimizers import apply_updates  # noqa: E402

SHAPES = {"blocks/b/w": (3, 8, 6), "embed": (16, 8), "final_norm": (8,)}
STEPS = 5

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "sgd_nesterov": lambda m: m.sgd(0.1, momentum=0.9, nesterov=True),
    "adamw": lambda m: m.adamw(3e-3),
    "adamw_no_clip": lambda m: m.adamw(3e-3, grad_clip=None),
    "adamw_decay": lambda m: m.adamw(3e-3, weight_decay=0.1),
    "adamw_decay_no_clip": lambda m: m.adamw(3e-3, weight_decay=0.1, grad_clip=None),
}


class _Jax:
    sgd, adamw = staticmethod(j_sgd), staticmethod(j_adamw)


class _Port:
    sgd, adamw = staticmethod(sgd), staticmethod(adamw)


def _tree(rng, dtype, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name, dtype):
    rng = np.random.default_rng(3)
    p0 = _tree(rng, dtype)
    jp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    tp = convert.params(jp, "cpu")
    jopt, topt = OPTIMIZERS[name](_Jax), OPTIMIZERS[name](_Port)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(STEPS):
        # gradients of both sizes: the clip binds on some steps, not on others
        g = _tree(rng, dtype, scale=[0.01, 1.0, 0.05, 3.0, 0.2][step])
        jg = {k: jnp.asarray(v, dtype) for k, v in g.items()}
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(convert.params(jg, "cpu"), ts, tp)
        jp, tp = j_apply(jp, ju), apply_updates(tp, tu)
        for k in SHAPES:
            assert tu[k].dtype == torch.float32 and tp[k].dtype == getattr(torch, dtype)
            _close(tu[k], ju[k], f"step {step} update {k}")
            _close(tp[k], jp[k], f"step {step} param {k}")
        if name.startswith("adamw"):
            assert ts["count"].dtype == torch.int32 and int(ts["count"]) == int(js["count"])
            for m in ("mu", "nu"):
                for k in SHAPES:
                    assert ts[m][k].dtype == torch.float32
                    _close(ts[m][k], js[m][k], f"step {step} {m} {k}")
        elif name != "sgd":
            for k in SHAPES:
                _close(ts[k], js[k], f"step {step} momentum {k}")
        else:
            assert ts == () and js == ()


def test_apply_updates_rounds_to_the_parameter_dtype():
    p = {"a": torch.tensor([1.0, 2.0], dtype=torch.bfloat16), "b": torch.ones(2)}
    u = {"a": torch.tensor([2.0 ** -9, 0.5]), "b": torch.tensor([0.25, -1.0])}
    out = apply_updates(p, u)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    assert out["a"].tolist() == [1.0, 2.5] and out["b"].tolist() == [1.25, 0.0]
