"""Training launcher: the FL round at LLM scale for every arch of the zoo.

Twin of ``repro/launch/train.py``.  Usage:
  python -m repro_torch.launch.train --arch qwen1.5-0.5b                  # on the card
  python -m repro_torch.launch.train --arch hubert-xlarge --seq 2048 --ce-chunk 512
  python -m repro_torch.launch.train --arch mamba2-1.3b --smoke --steps 3 --device cpu

Runs ``make_fl_train_step`` for ``--steps`` rounds: ``--clients`` FL
clients share each batch of ``--batch`` sequences of ``--seq`` positions,
GLR-CUCB (history 128) schedules them over ``--channels`` channels of a
random piecewise env, AdamW updates the model (in place: the step donates
its state).  ``make_batch`` builds a round's input as JAX's does: the next
token batch of ``synthetic_lm_batches`` (a VLM's behind bf16 patch
embeddings), or for the audio encoder (hubert) bf16 frames, per-frame
cluster labels and a mask drawn at ``mask_prob``, with no token stream.
The full config trains with ``remat="full"``, ``--smoke`` (the reduced
config of the same family) with none.  Weights, env, the rounds'
uniforms and the batches' draws come from ``--seed`` on ``--device``
(``cuda`` unless given; without CUDA and without ``--device`` it raises),
the tokens from ``--seed`` with numpy; the draws equal JAX's in
distribution only.  ``--seq-shard`` is the identity on one card.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.bandits import GLRCUCB
from repro_torch.core.channels import ChannelEnv, random_piecewise_env
from repro_torch.data.synthetic import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import TrainState, make_fl_train_step, make_train_state_init
from repro_torch.models.model import Model
from repro_torch.optim import adamw

CLIENTS, CHANNELS = 4, 8        # the FL setup's defaults (--clients, --channels)
SCHED_HISTORY = 128             # GLR-CUCB's ring length and detector stride
DETECTOR_STRIDE = 1


class TrainRun(NamedTuple):
    """What ``setup`` makes from the flags; ``train_round`` runs one round."""
    cfg: ModelConfig
    model: Model
    state: TrainState               # the initial state (the rounds donate it: a round
                                    # writes the new parameters and moments into it)
    step: Callable
    data: Optional[Iterator]        # (batch, seq) int32 token batches (numpy); None for audio
    draws: torch.Generator          # frames, labels, masks and patch embeddings
    uniforms: torch.Generator       # the rounds' (2, channels) uniforms
    n_channels: int
    batch: int
    seq: int
    device: torch.device
    env: ChannelEnv                 # the channels the step draws from (the step holds it)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clients", type=int, default=CLIENTS)
    ap.add_argument("--channels", type=int, default=CHANNELS)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the env, the uniforms and the tokens")
    return ap.parse_args(argv)


def make_batch(cfg: ModelConfig, batch: int, seq: int, generator: torch.Generator,
               device: torch.device, data: Optional[Iterator] = None) -> Dict[str, torch.Tensor]:
    """One round's input on ``device``, as JAX's ``make_batch`` builds it.
    Audio: ``frames`` (batch, seq, d) bf16 from a normal, ``labels`` (batch,
    seq) int32 uniform over the vocabulary and ``mask`` (batch, seq), each
    entry True with probability ``mask_prob``.  Every other arch: the next
    token batch of ``data`` (numpy (batch, seq) int32) and, for a VLM,
    ``vision_embeds`` (batch, frontend_tokens, d) bf16 from a normal.  The
    draws come from ``generator`` on ``device``.  Tokens go to the card from
    pinned memory without blocking: a blocking copy from pageable memory
    waits for the stream, so the host could not queue a step while the
    card runs the last one."""
    d = cfg.d_model
    if cfg.arch_type == "audio":
        return {
            "frames": torch.randn((batch, seq, d), generator=generator, device=device,
                                  dtype=torch.bfloat16),
            "labels": torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                                    device=device, dtype=torch.int32),
            "mask": torch.rand((batch, seq), generator=generator, device=device) < cfg.mask_prob,
        }
    toks = torch.from_numpy(next(data))
    out = {"tokens": toks.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
           else toks.to(device)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = torch.randn((batch, cfg.frontend_tokens, d), generator=generator,
                                           device=device, dtype=torch.bfloat16)
    return out


def setup(args: argparse.Namespace, cfg: Optional[ModelConfig] = None) -> TrainRun:
    """The run ``args`` describe.  ``cfg`` (never given by the CLI) replaces
    the config named by ``--arch``/``--smoke``: a caller trains a config cut
    in depth (``dataclasses.replace(get_config(arch), n_layers=...)``)
    through the launcher's own path."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg=cfg, remat="none" if args.smoke else "full",
                  ce_chunk=args.ce_chunk, seq_shard=args.seq_shard)
    sched = GLRCUCB(args.channels, args.clients, history=SCHED_HISTORY,
                    detector_stride=DETECTOR_STRIDE)

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(args.seed + offset)

    env = random_piecewise_env(gen(1), args.channels, args.steps,
                               max(args.steps // 40, 1), device=dev)
    opt = adamw(args.lr)
    state = make_train_state_init(model, opt, sched, args.clients)(gen(0), device=dev)
    step = make_fl_train_step(model, opt, sched, env, args.clients,
                              microbatches=args.microbatch, donate=True)
    data = (synthetic_lm_batches(args.batch, args.seq, cfg.vocab_size, seed=args.seed)
            if cfg.arch_type != "audio" else None)
    return TrainRun(cfg, model, state, step, data, gen(2), gen(3), args.channels, args.batch,
                    args.seq, dev, env)


def train_round(run: TrainRun, state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """One round: the next batch and the round's uniforms."""
    u = torch.rand((2, run.n_channels), generator=run.uniforms, device=run.device)
    batch = make_batch(run.cfg, run.batch, run.seq, run.draws, run.device, run.data)
    return run.step(state, batch, u[0], u[1])


def main(argv=None) -> int:
    args = parse_args(argv)
    run = setup(args)
    print(f"[train] {run.cfg.name} ({run.cfg.arch_type}) — {args.clients} clients, "
          f"{args.channels} channels, {args.steps} rounds")
    state = run.state
    t0 = time.time()
    for t in range(args.steps):
        state, mets = train_round(run, state)
        if t % max(args.steps // 10, 1) == 0 or t == args.steps - 1:
            print(f"  round {t:4d} loss={float(mets['loss']):8.4f} "
                  f"|S_t|={int(mets['n_success'])}/{args.clients} "
                  f"mean_aoi={float(mets['mean_aoi']):.2f}")
    if args.ckpt:
        print("  checkpoint:", save_checkpoint(args.ckpt, args.steps, {"params": state.params}))
    print(f"[train] done in {time.time()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
