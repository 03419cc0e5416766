"""The port's training path on the MLA and MoE models, against the JAX
package's and against itself.

``make_fl_train_step`` on the minicpm3 (MLA), deepseek-v2 (MLA + MoE, a
leading dense layer) and dbrx (GQA + MoE) smoke configs in f32, from JAX's
initial state, three rounds with the uniforms behind JAX's round keys:
the discrete FL state bit for bit, the loss, ``mean_aoi``, ``aoi_var`` and
``moe_aux`` at rtol 1e-5, AdamW one round at a time by
``chip_smoke.adam_round_close`` (``tests/test_torch_train_families.py``
says why); then the launcher's CLI on the CPU for each.

Against itself, bitwise: the MoE blocks under ``remat`` (the checkpoint
recomputes the router, the top-k and the dispatch; the recompute must pick
the same experts and slots), the donated AdamW step against the functional
one, the token gather's fixed-order backward against ``index_select``'s
own (an ``index_add``), and the donated step in slices against whole
leaves.  ``chip_smoke.train_flops`` counts the active parameters and MLA's
two head widths.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw, optimizers  # noqa: E402
from test_torch_train import _chip_smoke  # noqa: E402
from test_torch_train_families import (  # noqa: E402
    _batch,
    donated_step_equals_the_functional_step,
    fl_train_step_matches_jax,
    train_launcher_on_the_cpu,
)

ARCHS = ["minicpm3-4b", "deepseek-v2-236b", "dbrx-132b"]
MOE = ["deepseek-v2-236b", "dbrx-132b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models: one intra-op thread, so the test workers do not contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(arch, dtype="float32"):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def _inputs(arch, dtype="float32", seed=0):
    cfg = _smoke(arch, dtype)
    params, _ = Model(cfg).init(torch.Generator().manual_seed(seed), device="cpu")
    _, batch = _batch(cfg, 2, 40, np.random.default_rng(seed + 1))
    return cfg, params, batch


@pytest.mark.parametrize("arch", ARCHS)
def test_fl_train_step_matches_jax(arch):
    fl_train_step_matches_jax(arch)


@pytest.mark.parametrize("arch,name", [("minicpm3-4b", "minicpm3-smoke (dense)"),
                                       ("deepseek-v2-236b", "deepseek-v2-smoke (moe)"),
                                       ("dbrx-132b", "dbrx-smoke (moe)")])
def test_train_launcher_on_the_cpu(capsys, arch, name):
    train_launcher_on_the_cpu(capsys, arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_donated_step_equals_the_functional_step(arch):
    donated_step_equals_the_functional_step(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_remat_is_bitwise(arch, dtype):
    """The three remat policies give bitwise the same loss, ``moe_aux`` and
    gradients: the recompute routes every token as the forward did."""
    cfg, params, batch = _inputs(arch, dtype)
    ref = None
    for remat in ("none", "full", "dots"):
        loss, met, g = loss_and_grads(Model(cfg, remat=remat), params, batch,
                                      torch.tensor([1.0, 0.5]))
        if ref is None:
            ref = (loss, met, g)
            continue
        assert torch.equal(loss, ref[0]) and torch.equal(met["moe_aux"], ref[1]["moe_aux"])
        for k in g:
            assert torch.equal(g[k], ref[2][k]), (remat, k)


@pytest.mark.parametrize("arch", MOE)
def test_remat_recomputes_the_routing(monkeypatch, arch):
    """Under ``"full"`` each MoE layer routes twice (its forward, then the
    recompute in the backward pass), under ``"none"`` once, and the
    recompute picks the forward's experts, weights and slots bit for bit."""
    plans = []
    plain = moe.dispatch

    def recorded(topi, topw, e, cap):
        out = plain(topi, topw, e, cap)
        plans.append((topi.clone(), topw.detach().clone()) + tuple(t.detach().clone()
                                                                  for t in out))
        return out

    monkeypatch.setattr(moe, "dispatch", recorded)
    cfg, params, batch = _inputs(arch)
    n_moe = cfg.n_layers - cfg.first_k_dense
    loss_and_grads(Model(cfg, remat="none"), params, batch)
    assert len(plans) == n_moe
    plans.clear()
    loss_and_grads(Model(cfg, remat="full"), params, batch)
    assert len(plans) == 2 * n_moe
    for fwd, again in zip(plans[:n_moe], plans[n_moe:][::-1]):
        assert all(torch.equal(a, b) for a, b in zip(fwd, again))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_token_gather_backward_adds_as_index_add(monkeypatch, arch, dtype):
    """The gather of each token's k rows adds their gradients in ascending
    expert id from zero: bitwise ``index_select``'s own backward on the CPU
    (an ``index_add`` in index order, the order of JAX's scatter-add), in a
    model whose capacity drops tokens."""
    cfg, params, batch = _inputs(arch, dtype, seed=3)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    got = loss_and_grads(Model(cfg), params, batch)
    monkeypatch.setattr(moe._TokenRows, "apply",
                        staticmethod(lambda x, tok, pos: x.index_select(0, tok)))
    want = loss_and_grads(Model(cfg), params, batch)
    assert torch.equal(got[0], want[0])
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k


def test_sliced_step_equals_the_whole_leaf_update(monkeypatch):
    """``adamw.step_`` steps a leaf in slices of ``SLICE_ELEMENTS``, and a
    larger leaf's squares enter the clip's norm a slice at a time, in both
    steps: with slices of 7 elements, the donated step's parameters and
    moments equal ``update`` + ``apply_updates``'s bit for bit, and the
    slices cover every entry once, in order."""
    monkeypatch.setattr(optimizers, "SLICE_ELEMENTS", 7)
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((3, 4, 5), generator=gen).to(torch.bfloat16),
              "b": torch.randn((40,), generator=gen), "c": torch.randn((2, 3), generator=gen),
              "d": torch.randn((), generator=gen)}
    for k, p in params.items():
        idx = torch.arange(p.numel()).reshape(p.shape)
        parts = optimizers._slices(p)
        assert torch.equal(torch.cat([idx[sl].reshape(-1) for sl in parts]), idx.reshape(-1)), k
        assert max(idx[sl].numel() for sl in parts) <= max(7, p.shape[-1] if p.dim() else 1), k
    assert len(optimizers._slices(params["a"])) == 12 and len(optimizers._slices(params["c"])) == 1
    opt = adamw(1e-2)
    state = opt.init(params)
    for r in range(3):
        grads = {k: torch.randn(p.shape, generator=gen).to(p.dtype) for k, p in params.items()}
        upd, want_state = opt.update(grads, state, params)
        want = optimizers.apply_updates(params, upd)
        got = {k: p.clone() for k, p in params.items()}
        got_state = {"mu": {k: v.clone() for k, v in state["mu"].items()},
                     "nu": {k: v.clone() for k, v in state["nu"].items()},
                     "count": state["count"]}
        got_state = opt.step_(grads, got_state, got)
        for k in params:
            assert torch.equal(got[k], want[k]), (r, k)
            for m in ("mu", "nu"):
                assert torch.equal(got_state[m][k], want_state[m][k]), (r, m, k)
        params, state = want, want_state


def test_setup_trains_a_config_cut_in_depth():
    """``setup``'s ``cfg`` (no CLI flag: JAX's launcher has none) replaces
    the config ``--arch`` names; the step trains it through the launcher's
    own path."""
    args = train.parse_args(["--arch", "deepseek-v2-236b", "--smoke", "--steps", "2", "--batch",
                             "4", "--seq", "16", "--device", "cpu"])
    cut = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), n_layers=1)
    run = train.setup(args, cfg=cut)
    assert run.cfg is cut and run.model.cfg is cut
    assert not any(k.startswith("blocks/") for k in run.state.params)   # layer 0 only: dense
    state, met = train.train_round(run, run.state)
    assert state.fl.t == 1 and np.isfinite(float(met["loss"]))
    with pytest.raises(SystemExit):
        train.parse_args(["--arch", "deepseek-v2-236b", "--n-layers", "2"])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "phi-3-vision-4.2b"] + ARCHS)
def test_train_flops_counts_the_active_parameters(arch):
    """6 P B S with P the parameters a token meets in a product (the
    experts the router skips and an untied embedding table left out) plus
    3 x 2 (D_qk + D_v) FLOPs a visible pair a head an attention layer: for
    the dense and VLM models the count the trained families had (every
    parameter but the table, 12 D), for MLA its two head widths."""
    smoke = _chip_smoke()
    cfg = get_config(arch)
    n_params = sum(v.numel() for v in Model(cfg).param_specs()[0].values())
    b, s = 8, 2048 + (cfg.frontend_tokens if cfg.arch_type == "vlm" else 0)
    flops, attn, p = smoke.train_flops(cfg, n_params, b, s)
    table = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    dead = cfg.param_count() - cfg.active_param_count()
    assert (dead > 0) == bool(cfg.n_experts)
    assert p == n_params - table - dead and flops == 6 * p * b * s
    pairs = smoke.attn_pairs(s, True, cfg.local_attn_window)
    if cfg.attention == "mla":
        width = 6 * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim)
        assert width == {"minicpm3-4b": 6 * (96 + 64), "deepseek-v2-236b": 6 * (192 + 128)}[arch]
    else:
        width = 12 * cfg.resolved_head_dim
    assert attn == width * b * cfg.n_heads * cfg.n_layers * pairs
