"""The port's examples (``examples/torch/``) run on the CPU at their smallest
size when asked for it, and raise without CUDA when no device is given."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"

# each example's smallest run, and a line its output must hold
SMALL = {
    "quickstart": (["--rounds", "200", "--fl-rounds", "2"], "final test accuracy"),
    "serve_batched": (["--batch", "2", "--prompt-len", "3", "--tokens", "3", "--window", "4"],
                      "cache position: 5 (physical cache length = window (ring))"),
    "tune_grid": (["--horizon", "60", "--grid", "2", "--seeds", "2"], "# best: gamma="),
    "federated_llm_train": (["--steps", "2", "--batch", "4", "--seq", "16"], "done in"),
}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_is_covered():
    assert {p.stem for p in EXAMPLES.glob("*.py")} == set(SMALL)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_runs_on_the_cpu(name, capsys):
    argv, expect = SMALL[name]
    assert _load(name).main(argv + ["--device", "cpu"]) == 0
    assert expect in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_needs_cuda_without_a_device(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main(SMALL[name][0])
