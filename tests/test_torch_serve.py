"""The port's serving steps and CLI against the JAX package's.

``make_prefill_step`` and ``make_serve_step`` of ``repro_torch.launch.steps``
against their twins in ``repro.launch.steps`` on the same (converted) f32
weights of the three dense smoke configs: prefill logits at rtol 1e-4 /
atol 1e-5 (sums in another order), greedy tokens bitwise, the cache at
rtol 1e-4 / atol 1e-5.  The CLI ``python -m repro_torch.launch.serve``
runs on the CPU when asked to.
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
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = ["qwen3-32b", "qwen2.5-32b", "qwen1.5-0.5b"]


def _pair(arch):
    jm = j_build(dataclasses.replace(j_smoke(arch), dtype="float32"), remat="none")
    jp, _ = jm.init(jax.random.PRNGKey(1))
    pm = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    return jm, jp, pm, convert.model_params(jp, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    toks = np.random.default_rng(5).integers(0, pm.cfg.vocab_size, (3, 33)).astype(np.int32)
    want = np.array(j_steps.make_prefill_step(jm)(jp, {"tokens": jnp.asarray(toks)}))
    got = steps.make_prefill_step(pm)(pp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, 1, pm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax(arch):
    """Four greedy steps from token 0, as the CLI loops them."""
    jm, jp, pm, pp = _pair(arch)
    jserve, serve_step = j_steps.make_serve_step(jm), steps.make_serve_step(pm)
    jcache = jm.init_cache(4, 16, dtype=jnp.float32)
    cache = pm.init_cache(4, 16, dtype=torch.float32, device="cpu")
    jtok = jnp.zeros((4,), jnp.int32)
    tok = torch.zeros((4,), dtype=torch.int32)
    for _ in range(4):
        jtok, jcache = jserve(jp, jcache, jtok)
        tok, cache = serve_step(pp, cache, tok)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.array(jtok))
    assert int(cache["pos"]) == int(jcache["pos"]) == 4
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["blocks"][name].numpy(),
                                   np.array(jcache["blocks"][name]), rtol=1e-4, atol=1e-5)


def test_serve_cli_runs_on_the_cpu(capsys):
    assert serve.main(["--arch", "qwen3-32b", "--smoke", "--device", "cpu", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[serve] qwen3-smoke: 3 tokens x 8 seqs in ")
    assert "tok/s" in out and out.rstrip().endswith("cache pos=3")


@pytest.mark.parametrize("arch,name", [("minicpm3-4b", "minicpm3-smoke"),
                                       ("deepseek-v2-236b", "deepseek-v2-smoke"),
                                       ("dbrx-132b", "dbrx-smoke")])
def test_serve_cli_serves_the_mla_and_moe_archs_on_the_cpu(capsys, arch, name):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"[serve] {name}: 3 tokens x 8 seqs in ")
    assert "tok/s" in out and out.rstrip().endswith("cache pos=3")


def test_serve_loop_with_a_ring_cache():
    pm = build_model(get_smoke_config("qwen2.5-32b"))
    params, _ = pm.init(torch.Generator().manual_seed(0), device="cpu")
    tok, cache, secs = serve.serve_loop(pm, params, batch=2, context=64, tokens=10, window=4,
                                        device="cpu")
    assert tok.shape == (2,) and int(cache["pos"]) == 10 and secs > 0
    assert cache["blocks"]["k"].shape[3] == 4 and cache["blocks"]["k"].dtype == torch.bfloat16
