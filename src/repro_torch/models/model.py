"""Model facade: ``build_model(config) -> Model`` with init / apply / loss /
cache / decode entry points for every decoder of the zoo: GQA and MLA,
dense and MoE, the SSD state-space model, the RG-LRU hybrid and the VLM.

Twin of ``repro/models/model.py``.  The parameter layout is the JAX one: a
flat ``{path: tensor}`` dict plus a parallel ``{path: logical_spec}`` dict.
A homogeneous layer stack lives under ``blocks/`` with a leading layer
axis; heterogeneous layers live under ``layers/NN/`` and run unrolled:
every layer of a hybrid pattern (recurrentgemma's rglru, rglru, attn), and
the leading dense layers of an MoE model (deepseek-v2's layer 0) before
the stack.  So ``convert.model_params`` carries JAX parameters across as
they are.  A hybrid's attention layers attend over ``local_attn_window``
and decode against a ring of that length.  A VLM batch may carry
``vision_embeds`` (B, frontend_tokens, d), prepended to the token
embeddings (the stub frontend of the JAX package).  An audio batch
(hubert, the encoder) carries ``frames`` (B, T, d) in place of tokens, with
a sinusoidal position embedding added, and trains on the cluster ids
``labels`` (B, T) of the frames ``mask`` (B, T) selects; its ``embed`` is
a parameter the forward never reads, as in the JAX package.  Where a
gradient is taken the unrolled layers run under the model's ``remat``
policy too (the JAX package runs them as they are): the same numbers,
and a hybrid's 26 layers of scan intermediates are not held at once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import kvcache
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.layers import ParamBuilder, rms_norm, torch_dtype
from repro_torch.models.transformer import (
    REMAT_POLICIES,
    _ffn_is_moe,
    _remat,
    _takes_grad,
    add_block_params,
    block_decode,
    block_forward,
    scanned_decode,
    scanned_forward,
)

Params = Dict[str, torch.Tensor]


def _subtree(params: Params, prefix: str) -> Params:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _sinusoidal_pe(seq: int, d: int, dtype, device=None) -> torch.Tensor:
    """Absolute PE for the encoder path (stands in for hubert's conv-pos
    stub): sin at the even dims, cos at the odd ones, angles in f32."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(seq, d).to(dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    remat: str = "full"          # none | full | dots (activation-checkpoint policy)
    ce_chunk: int = 0            # >0: compute the CE loss in sequence chunks of
                                 # this size (recomputed in the backward pass) so
                                 # (B, S, V) logits never persist
    seq_shard: bool = False      # sequence-parallel residual stream between
                                 # blocks: the identity on one card, as JAX's
                                 # ``constrain`` is without a mesh
    attn_impl: Optional[str] = None  # None: the kernel on CUDA; "plain": the chunked
                                     # reference path; "kernel": the kernel route everywhere

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"Model: unknown attn_impl {self.attn_impl!r}; one of {ATTN_IMPLS}")
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"Model: unknown remat {self.remat!r}; one of {REMAT_POLICIES}")

    # ------------------------------------------------------------------ layout
    def _is_hybrid(self) -> bool:
        return bool(self.cfg.layer_pattern)

    def _scanned_layers(self) -> int:
        if self._is_hybrid():
            return 0
        return self.cfg.n_layers - self.cfg.first_k_dense

    def _unrolled(self):
        """Indices of unrolled layers (hybrid: all; else the leading dense ones)."""
        if self._is_hybrid():
            return list(range(self.cfg.n_layers))
        return list(range(self.cfg.first_k_dense))

    def _local_window(self, kind: str) -> int:
        """A layer's own attention window: a hybrid's local attention."""
        return self.cfg.local_attn_window if kind == "attn" else 0

    # ------------------------------------------------------------------ init
    def param_specs(self) -> Tuple[Params, Dict[str, tuple]]:
        """(meta-tensor dict, logical-spec dict) — shapes and dtypes, no storage."""
        return self._build(None, meta=True)

    def init(self, generator: torch.Generator, device=None) -> Tuple[Params, Dict[str, tuple]]:
        """Draw the parameters from ``generator`` on ``device`` (``cuda``
        unless given; the generator must live on the same device type)."""
        return self._build(generator, meta=False, device=resolve_device(device))

    def _build(self, generator, meta: bool, device=None) -> Tuple[Params, Dict[str, tuple]]:
        cfg = self.cfg
        pb = ParamBuilder(generator, dtype=torch_dtype(cfg.dtype), meta=meta, device=device)
        pb.add("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), init="embed")
        if not cfg.tie_embeddings:
            pb.add("unembed", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
        pb.add("final_norm", (cfg.d_model,), (None,), init="ones")
        for i in self._unrolled():
            add_block_params(pb, f"layers/{i:02d}/b", cfg, cfg.layer_kind(i), _ffn_is_moe(cfg, i),
                             stacked=0)
        n_scan = self._scanned_layers()
        if n_scan:
            i0 = cfg.first_k_dense
            add_block_params(pb, "blocks/b", cfg, cfg.layer_kind(i0), _ffn_is_moe(cfg, i0),
                             stacked=n_scan)
        return pb.params, pb.specs

    # ------------------------------------------------------------------ forward
    def apply(
        self, params: Params, batch: Dict[str, torch.Tensor],
        last_only: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns (logits (B,S,V), moe_aux).

        ``last_only`` unembeds just the final position — the serving-prefill
        path, which avoids materializing (B, S, V) logits."""
        x, aux = self._forward_hidden(params, batch)
        if last_only:
            x = x[:, -1:]
        return x @ self._unembed_matrix(params), aux

    def _unembed_matrix(self, params: Params) -> torch.Tensor:
        return params["embed"].t() if self.cfg.tie_embeddings else params["unembed"]

    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.cfg.arch_type == "audio":
            # the PE is added in the frames' dtype, as in JAX; then the sum goes to the
            # parameters' dtype (JAX promotes bf16 frames at the first f32 product)
            x = batch["frames"]
            x = x + _sinusoidal_pe(x.shape[1], self.cfg.d_model, x.dtype, x.device)[None]
            return x.to(params["final_norm"].dtype)
        tok = params["embed"][batch["tokens"].long()]
        if self.cfg.arch_type == "vlm" and "vision_embeds" in batch:
            # stub frontend carve-out: pre-computed patch embeddings, prepended
            return torch.cat([batch["vision_embeds"].to(tok.dtype), tok], dim=1)
        return tok

    def _forward_hidden(
        self, params: Params, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All blocks + final norm; returns (hidden (B,S,d), moe_aux)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in self._unrolled():
            kind = cfg.layer_kind(i)
            layer = _subtree(params, f"layers/{i:02d}")
            body = functools.partial(block_forward, prefix="b", cfg=cfg, kind=kind,
                                     moe_ffn=_ffn_is_moe(cfg, i),
                                     window=self._local_window(kind), attn_impl=self.attn_impl)
            if _takes_grad(layer, x):
                body = _remat(body, self.remat)
            x, a = body(layer, x=x)
            aux = aux + a
        if self._scanned_layers():
            i0 = cfg.first_k_dense
            kind = cfg.layer_kind(i0)
            x, a = scanned_forward(_subtree(params, "blocks"), x, cfg, kind,
                                   _ffn_is_moe(cfg, i0), self._local_window(kind), self.remat,
                                   attn_impl=self.attn_impl)
            aux = aux + a
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    # ------------------------------------------------------------------ loss
    def loss(
        self, params: Params, batch: Dict[str, torch.Tensor],
        example_weights: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean loss + metrics.  ``example_weights`` (B,) scales per-example
        loss — this is how the FL round folds the transmission mask and the
        zeta aggregation weights (Eq. 7) into one backward pass."""
        cfg = self.cfg
        hidden, aux = self._forward_hidden(params, batch)
        if cfg.arch_type == "audio":
            # masked-frame prediction: a cluster id a frame, the loss over the masked ones
            nll = self._nll(hidden, self._unembed_matrix(params), batch["labels"])
            mask = batch["mask"].float()
            per_example = torch.sum(nll * mask, dim=1) / mask.sum(dim=1).clamp_min(1.0)
        else:
            tokens = batch["tokens"]
            offset = cfg.frontend_tokens if cfg.arch_type == "vlm" else 0
            # predict token t+1 from position (offset + t)
            nll = self._nll(hidden[:, offset: offset + tokens.shape[1] - 1],
                            self._unembed_matrix(params), tokens[:, 1:])   # (B, T)
            per_example = nll.mean(dim=1)
        w = example_weights if example_weights is not None else torch.ones_like(per_example)
        loss = torch.sum(per_example * w) / torch.sum(w).clamp_min(1e-9)
        total = loss + cfg.router_aux_weight * aux
        return total, {"loss": loss, "moe_aux": aux, "per_example": per_example}

    def _nll(self, hid: torch.Tensor, w_out: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Per-position NLL (B, T), optionally in recomputed sequence chunks.

        Cross-entropy as logsumexp minus the label's logit, taken with a
        ``gather`` (the JAX package's one-hot product adds only signed zeros
        to it, and would be a second (B, T, V) f32 tensor).  With
        ``ce_chunk`` each chunk's (B, C, V) logits are computed under a
        checkpoint and recomputed in the backward pass: they never persist."""
        t = hid.shape[1]
        c = self.ce_chunk
        if c <= 0 or t <= c:
            return _nll_dense(hid, w_out, labels)
        pad = (-t) % c
        if pad:
            hid = torch.nn.functional.pad(hid, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad))
        nll = [checkpoint(_nll_dense, hid[:, i:i + c], w_out, labels[:, i:i + c],
                          use_reentrant=False, preserve_rng_state=False)
               for i in range(0, hid.shape[1], c)]
        return torch.cat(nll, dim=1)[:, :t]

    # ------------------------------------------------------------------ caches
    def init_cache(
        self, batch: int, seq_len: int, window: Optional[int] = None,
        dtype=torch.bfloat16, device=None,
    ) -> Dict[str, Any]:
        """Decode cache for every layer on ``device`` (``cuda`` unless given).
        ``window`` overrides cfg.sliding_window (the serve-time ring cache)."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode cache")
        dev = resolve_device(device)
        win = cfg.sliding_window if window is None else window

        dt = torch_dtype(dtype)

        def one(kind: str, n_layers: int = 0, local: int = 0):
            w = local or win
            if kind == "ssm":
                return ssm_mod.init_ssm_cache(batch, cfg, n_layers, dt, dev)
            if kind == "rglru":
                return rglru_mod.init_rglru_cache(batch, cfg, n_layers, dt, dev)
            if cfg.attention == "mla":
                return kvcache.init_mla_cache(
                    batch, seq_len, cfg.kv_lora_rank, cfg.qk_rope_dim, window=w,
                    n_layers=n_layers, dtype=dt, device=dev)
            return kvcache.init_gqa_cache(
                batch, cfg.n_kv_heads, seq_len, cfg.resolved_head_dim, window=w,
                n_layers=n_layers, dtype=dt, device=dev)

        cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
        for i in self._unrolled():
            kind = cfg.layer_kind(i)
            cache[f"layers/{i:02d}"] = one(kind, 0, self._local_window(kind))
        if self._scanned_layers():
            cache["blocks"] = one(cfg.layer_kind(cfg.first_k_dense), self._scanned_layers())
        return cache

    # ------------------------------------------------------------------ decode
    def decode_step(
        self, params: Params, cache: Dict[str, Any], tokens: torch.Tensor,
        window: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One serve step: tokens (B,) -> (logits (B,V) f32, cache').  The
        cache's tensors are written in place; ``cache'`` holds them with
        ``pos + 1``."""
        cfg = self.cfg
        win = cfg.sliding_window if window is None else window
        pos = cache["pos"]
        x = params["embed"][tokens.long()][:, None]               # (B,1,d)
        new_cache: Dict[str, Any] = {"pos": pos + 1}
        for i in self._unrolled():
            name, kind = f"layers/{i:02d}", cfg.layer_kind(i)
            x, new_cache[name] = block_decode(_subtree(params, name), "b", x, cfg, kind,
                                              _ffn_is_moe(cfg, i), cache[name], pos,
                                              window=self._local_window(kind) or win)
        if self._scanned_layers():
            i0 = cfg.first_k_dense
            x, new_cache["blocks"] = scanned_decode(
                _subtree(params, "blocks"), x, cfg, cfg.layer_kind(i0), _ffn_is_moe(cfg, i0),
                cache["blocks"], pos, window=win)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x @ self._unembed_matrix(params))[:, 0].float()
        return logits, new_cache


def _nll_dense(h: torch.Tensor, w_out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lg = (h @ w_out).float()
    picked = lg.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lg, dim=-1) - picked


def build_model(cfg: ModelConfig, remat: str = "full",
                attn_impl: Optional[str] = None) -> Model:
    return Model(cfg=cfg, remat=remat, attn_impl=attn_impl)
