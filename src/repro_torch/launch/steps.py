"""Production steps: the FL round at LLM scale, and serving.

Twin of ``repro/launch/steps.py``.  ``make_fl_train_step`` folds the
paper's pipeline into one step a round:

  * GLR-CUCB (or any scheduler) picks M of N channels, the adaptive
    matcher assigns them by priority, the channel env draws Good/Bad;
  * the transmission mask x zeta weights become *per-example loss
    weights*, so the single backward pass computes exactly the masked
    weighted aggregate of per-client gradients (Eq. 7) without a
    server-side (M x params) buffer;
  * AoI (Eq. 8), the loss-proxy contributions, zeta (Eq. 43) and the
    bandit statistics update in the step.

Where the JAX step takes a key, the port's takes the round's two (N,) f32
uniforms, ``u_env`` for the channel states and ``u_sel`` for the
scheduler (the JAX step's ``split(key)``), as ``AsyncFLTrainer``'s round
does; the round index ``t`` is a Python int and the metrics stay tensors,
so the step adds no host sync of its own.  The prefill does not fill the
decode cache, as in the JAX package: the two serving steps are driven side
by side.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.aoi import aoi_variance, init_aoi, mean_aoi, update_aoi
from repro_torch.core.contribution import aggregation_weights
from repro_torch.core.matching import AdaptiveMatcher, MatcherState, matcher_scores
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer, apply_updates


class FLScaleState(NamedTuple):
    """Tiny FL control state carried across rounds."""
    aoi: torch.Tensor            # (M,)
    contrib: torch.Tensor        # (M,) loss-proxy marginal utility
    zeta: torch.Tensor           # (M,) aggregation weights (Eq. 43)
    sched_state: Any
    matcher_state: MatcherState
    t: int                       # round index (a Python int: no device sync)


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: Any
    fl: FLScaleState


def init_fl_scale_state(scheduler, n_clients: int, matcher_beta: float,
                        device=None) -> FLScaleState:
    dev = resolve_device(device)
    return FLScaleState(
        aoi=init_aoi(n_clients, dev),
        contrib=torch.ones((n_clients,), dtype=torch.float32, device=dev),
        zeta=torch.full((n_clients,), 1.0 / n_clients, dtype=torch.float32, device=dev),
        sched_state=scheduler.init(dev),
        matcher_state=AdaptiveMatcher(matcher_beta).init(dev),
        t=0,
    )


def make_train_state_init(model: Model, optimizer: Optimizer, scheduler,
                          n_clients: int, matcher_beta: float = 0.5):
    def init_fn(generator: torch.Generator, device=None) -> TrainState:
        """The parameters drawn from ``generator`` on ``device`` (``cuda``
        unless given; the generator lives on that device's type)."""
        dev = resolve_device(device)
        params, _ = model.init(generator, device=dev)
        return TrainState(
            params=params,
            opt_state=optimizer.init(params),
            fl=init_fl_scale_state(scheduler, n_clients, matcher_beta, dev),
        )
    return init_fn


def loss_and_grads(model: Model, params, batch, weights=None):
    """``model.loss`` (total, metrics) and its gradients with respect to
    ``params``, in the parameters' dtype, as ``jax.value_and_grad`` gives
    them: zeros for a parameter the loss never reads (hubert's ``embed``);
    everything returned is detached."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss, metrics = model.loss(leaves, batch, example_weights=weights)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, dict(zip(leaves, grads))


def make_fl_train_step(
    model: Model,
    optimizer: Optimizer,
    scheduler,
    env,
    n_clients: int,
    matcher_beta: float = 0.5,
    contrib_ema: float = 0.9,
    microbatches: int = 1,
    donate: bool = False,
) -> Callable:
    """``microbatches`` > 1 splits the batch and accumulates gradients in
    f32 (gradient accumulation): live activation memory divides by the
    factor with the same math.  The batch must split evenly over the
    ``n_clients`` clients (and the microbatches).  ``donate`` consumes the
    state a step is given: the optimizer's ``step_`` writes the new
    parameters and moments into its tensors (the same bits as the
    functional update), so a step holds one copy of them where the
    functional update holds two and an f32 update of every parameter; the
    launcher donates, which is what fits a 3-4 B-parameter model's AdamW
    state beside its training step on one card."""
    if donate and optimizer.step_ is None:
        raise ValueError("make_fl_train_step: donate=True needs an optimizer with step_ (adamw)")
    matcher = AdaptiveMatcher(matcher_beta)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], u_env: torch.Tensor,
             u_sel: torch.Tensor) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        fl = state.fl
        t = fl.t
        b = next(iter(batch.values())).shape[0]
        if b % n_clients or b % microbatches:
            raise ValueError(f"make_fl_train_step: batch {b} must split evenly over "
                             f"{n_clients} clients and {microbatches} microbatches")

        # ---- Step 3 (paper): schedule, match, transmit -------------------
        channels, aux = scheduler.select(fl.sched_state, t, u_sel, fl.aoi)
        # rank source routed by the scenario's regime metadata (Eq. 30 vs 31)
        scores = matcher_scores(scheduler, fl.sched_state, t, env)
        assignment, matcher_state = matcher.match(
            fl.matcher_state, channels, scores, fl.contrib, fl.aoi)
        ch_states = env.sample(t, u_env)
        rewards = ch_states[assignment]
        success = (rewards > 0.5).to(torch.float32)                   # (M,)
        n_succ = torch.sum(success).clamp_min(1.0)

        # ---- Steps 2+4: one weighted backward == masked zeta-aggregation --
        dev = success.device
        client_of = (torch.arange(b, device=dev) * n_clients) // b    # (B,)
        # an f32 division like JAX's: torch's `number / tensor` is a reciprocal times it
        coeff = success * fl.zeta * (torch.full_like(n_succ, n_clients) / n_succ)   # (M,)
        weights = coeff[client_of]

        if microbatches <= 1:
            loss, metrics, grads = loss_and_grads(model, state.params, batch, weights)
        else:
            mb, size = microbatches, b // microbatches
            w_tot = torch.sum(weights).clamp_min(1e-9)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in state.params.items()}
            ls, auxs, per_ex = [], [], []
            # per-microbatch losses are weight-normalized locally; scaling by
            # (sum w_mb / sum w) recomposes the exact global weighted mean
            for i in range(mb):
                part = slice(i * size, (i + 1) * size)
                l, met, g = loss_and_grads(model, state.params,
                                            {k: v[part] for k, v in batch.items()},
                                            weights[part])
                scale = torch.sum(weights[part]) / w_tot
                for k in grads:
                    grads[k] = grads[k] + g[k].float() * scale
                ls.append(l * scale)
                auxs.append(met["moe_aux"])
                per_ex.append(met["per_example"])
            loss = torch.sum(torch.stack(ls))
            metrics = {"loss": loss, "moe_aux": torch.mean(torch.stack(auxs)),
                       "per_example": torch.cat(per_ex)}
        if donate:
            params = state.params
            opt_state = optimizer.step_(grads, state.opt_state, params)
        else:
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)

        # ---- bookkeeping ---------------------------------------------------
        aoi = update_aoi(fl.aoi, success > 0.5)
        sched_state = scheduler.update(fl.sched_state, t, assignment, rewards, aux)
        per_client_loss = metrics["per_example"].reshape(n_clients, b // n_clients).mean(dim=1)
        # loss-proxy utility: clients whose data the global model fits worst
        # have the most to contribute (Eq. 33's role at LLM scale)
        contrib = contrib_ema * fl.contrib + (1 - contrib_ema) * (
            per_client_loss / per_client_loss.mean().clamp_min(1e-9))
        zeta = aggregation_weights(contrib)

        new_state = TrainState(
            params=params,
            opt_state=opt_state,
            fl=FLScaleState(aoi, contrib, zeta, sched_state, matcher_state, t + 1),
        )
        out_metrics = {
            "loss": metrics["loss"],
            "moe_aux": metrics["moe_aux"],
            "n_success": torch.sum(success),
            "mean_aoi": mean_aoi(aoi),
            "aoi_var": aoi_variance(aoi),
        }
        return new_state, out_metrics

    return step


def make_prefill_step(model: Model) -> Callable:
    def prefill(params, batch):
        logits, _ = model.apply(params, batch, last_only=not model.cfg.is_encoder)
        return logits
    return prefill


def make_serve_step(model: Model, window: int = 0) -> Callable:
    def serve(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens, window=window or None)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, cache
    return serve
