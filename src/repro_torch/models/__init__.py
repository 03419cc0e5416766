"""The model zoo's decoders, twin of ``repro/models``.

layers.py       norms, RoPE, MLPs, the ParamBuilder registry
attention.py    GQA (+bias/qk-norm/windowed) and MLA, prefill (flash kernel) + cached decode
moe.py          routed mixture of experts (top-k, capacity, shared experts)
ssm.py          Mamba-2 SSD block: causal conv, chunked scan, O(1) decode
rglru.py        Griffin's RG-LRU recurrent block (recurrentgemma)
transformer.py  block composition, the loop over stacked layers (remat)
model.py        build_model(config) -> Model(init/apply/loss/decode)
kvcache.py      full, ring (sliding-window) and MLA-latent caches
"""
from repro_torch.models.model import Model, build_model
