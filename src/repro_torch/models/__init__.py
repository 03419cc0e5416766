"""The model zoo's dense GQA decoders, twin of ``repro/models``.

layers.py       norms, RoPE, MLPs, the ParamBuilder registry
attention.py    GQA (+bias/qk-norm/windowed), prefill (flash kernel) + cached decode
transformer.py  block composition, the loop over stacked layers (remat)
model.py        build_model(config) -> Model(init/apply/loss/decode)
kvcache.py      full and ring (sliding-window) caches
"""
from repro_torch.models.model import Model, build_model
