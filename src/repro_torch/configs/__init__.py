"""Architecture registry of the port: ``--arch <id>`` resolution.

get_config(id)  / get_smoke_config(id)  / list_archs().  Twin of
``repro/configs/__init__.py``, listing every decoder of the JAX zoo: the
GQA and MLA decoders, dense and MoE, the SSD state-space model, the
RG-LRU hybrid, the VLM backbone and the encoder-only audio model
(hubert-xlarge): the same ids as JAX's registry.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES.keys())


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list_archs()}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
