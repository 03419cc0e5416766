#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--paths]

Phases, each printing its own lines; any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (all
   ``nvcc`` processes started together), with its seconds;
2. kernels against their plain PyTorch versions on the card, at the main
   path's shapes and larger ones, with the stated tolerances, and their
   times beside the plain version's, the bound (each wrapper's ``cost``,
   the count the dry run's walker uses) and a library call; the
   card's floor per launch, from an empty kernel launched back to back;
   ``weighted_aggregate`` bitwise against the row-order sum at every load
   width, and ``robust_trimmed``'s median bitwise on rows of NaN, +-inf,
   +-0 and ties; for both, kernel and library call timed back to back in
   one window each and again in interleaved turns, device time from a
   trace, and at the Fig. 3 shape the host split of one call (checks, load, allocation, stream lookup, ``ctypes``
   call); ``robust_trimmed``'s bound at 1 instruction an ordered pair,
   the older 4-op bound beside it; the batch form of both (a run axis on
   the grid, one launch for B runs) against its plain version and, row by
   row, bit for bit against the single-run kernel: ``weighted_aggregate``
   at (8, 20, 5674) f32 and bf16, (8, 64, 2^21) and (5, 7, 4099),
   ``robust_trimmed`` at (8, 20, 5674) with a mask, n and k a run (n = 0,
   odd and even n), on special values, and at (8, 64, 2^19 + 3), each
   timed beside the eight single-run launches it replaces, the plain
   version, the bound and the library call (``torch.bmm``; ``torch.sort``);
   ``glr_step_tenants`` (the scheduler service's detector step, in place
   on the slot state) against its plain version at the serving shapes
   (R = 257 / B = 64, N = 16, H = 256; R = 10001 / B = 64, H = 64), all
   rows live and detecting at (256, 16, 1024) beside the old functional
   ``glr_step`` kernel, and at H = 33 and 130, with both bounds (bytes;
   the FMA count or the split term's MUFU instructions, whose count a
   split is a constant below), device time and, at the serving shape, the
   host split of a call; ``glr_scan``'s tenant entry (the recompute
   detector served, read in place from the slot history) against its plain
   version at the same serving shapes (10 of 64 and all 64 rows detecting;
   R = 10001 / B = 64, H = 64) and at H = 33 and 130, bitwise on {0, 1}
   histories, on U[0, 1] ones bitwise the single-run kernel and inside the
   derived bound, with its time, device time, bound (bytes, split
   operations) and, at the serving shape, the host split of a call;
   and ``regret_scan`` (the whole regret harness in one launch) against the
   per-round route with the plain detector on eleven short edge runs (a table
   env, S=1, alpha=0.2, the geometric grid, H=33 with restarts, N=30 M=20
   stride 1, N=32, stride 1e9, the recompute detector, and the reactive
   template at N=32 with gain 1, sharp 16 and decay 0 and 1), and its batch form
   (one launch, one block a run) against the batched per-round route at
   B = 24 (own envs and uniforms) and B = 133 (one shared env and stream, a
   per-run gamma x delta grid, the recompute detector); ``glr_scan`` on
   real-valued histories inside ``ref.glr_scan_bounds``, the split term's
   derived forward error;
3. the Fig. 2 AoI-regret path: GLR-CUCB (history 1024, detector stride 5)
   on a piecewise env with N=5, M=2 and 5 breakpoints, T=20000 rounds, on
   both routes in turns (scan, rounds, scan): the scan route must launch
   ``regret_scan`` once and no ``glr_step``, the per-round route
   (``impl="rounds"``) ``glr_step`` T/5 times, and the two must agree bit
   for bit (schedule, restarts, regret curve, AoI, success rate, final
   state; the variance sums at rtol 1e-6); both routes' ms/round are
   printed.  A 5000-round run of the scan route is first held against the
   same run on the CPU (plain versions);
4. the Fig. 3 asynchronous-FL path: N=30 channels, M=20 clients, a skewed
   piecewise env, the MLP 48->96->10, E=3, B=16, lr 0.15, GLR-CUCB
   (history 256) with adaptive matching, 150 rounds; ``glr_step`` and
   ``weighted_aggregate`` must launch 150 times each.  Three rounds are
   first held against the same rounds on the CPU;
5. the Fig. 3 path under Byzantine client faults with the robust
   aggregators, phase 4's setup unchanged, 150 rounds a run, the chaos
   suite's attacks x defenses (``benchmarks/run.py:1160-1168``,
   ``:1245-1251``): sign_flip x {mean, trimmed_mean, coordinate_median},
   inner_product x norm_clip, burst(sign_flip) x coordinate_median;
   ``robust_trimmed`` must launch 150 times in each order-statistic run,
   ``weighted_aggregate`` 150 times in the others.  Three rounds of two
   runs are first held against the same rounds on the CPU;
6. the Fig. 2 path with ``detector_impl="recompute"`` on phase 3's env and
   uniforms, on both routes as in phase 3 but for the rounds route's cut
   (its first 5000 rounds, held to the scan's run of them: ``glr_scan``
   1000 times); the recompute scan must equal phase 3's streaming scan bit
   for bit at T=20000;
7. the model zoo's serving path on qwen3-32b at full width: (a) 2 layers
   in f32, the prefill of one 2048-token prompt through the kernel route
   against the plain chunked route, then 12 teacher-forced decode steps
   against ``apply``'s logits; (b) all 64 layers in bf16 (61.0 GiB of
   weights drawn on the card): ``make_prefill_step`` on 4 prompts of 2048
   tokens (``flash_attention`` must launch 64 times a prefill), then the
   ``launch/serve.py`` loop, batch 8, context 2048, 32 tokens;
8. the multi-tenant scheduler service at the JAX ``serve_suite``'s sizes
   (``benchmarks/run.py:1380-1456``): GLR-CUCB N=16, M=4, H=256, stride 5;
   (a) one tenant served 1000 rounds of ``offline_round_stream`` equals the
   scan route of ``simulate_aoi_regret`` and the CPU run bit for bit, with
   ``glr_step_tenants`` launched once a serve step; (b)
   256 tenants, slot batch 64: the first 3 steps equal the CPU run bit for
   bit; synchronous, serial (slots=1) and pipelined decisions a second
   (best of 2), a Poisson episode at 80 % of the synchronous rate with
   churn (p50/p99/p999 ms), the launches against the steps, one step under
   ``set_sync_debug_mode("error")`` and a profiled 10-step window; (c) a
   10^4-tenant server (H=64) whose first 64 requests equal the CPU run,
   and its saturated rate; (d) ``run_served`` on phase 4's setup, 10
   rounds equal to ``run()`` bit for bit;
9. the paper's baseline rows at their widths: (a) Fig. 2a's fifteen
   (``benchmarks/run.py:182-224``, N=5, M=2): nine policies on a piecewise
   env with 5 breakpoints, six on the adversarial table (flip_prob 0.002);
   the three ``regret_scan`` takes (piecewise glr-cucb and cucb-static,
   adversarial glr-cucb) at T=20000 on the scan route, the other twelve on
   the per-round route at T=1000 (the cut: that route is host-bound), each
   with regret, sublinearity index, growth exponent, ms/round, route and
   counters, and its first 500 rounds held against the CPU run (bitwise;
   channel-aware and M-Exp3 rows may fork only at a near-tie); (b) Fig.
   3/4's ten rows (``:744-786``), 150 rounds, one seed each (the cut):
   random, channel-aware and Lyapunov on phase 4's problem, those and
   M-Exp3 with and without matching on an adversarial N=6, M=4 problem,
   each with accuracy, cumulative AoI variance and s/round, three rounds
   held against the CPU run as in phase 4;
10. the batched engine (``repro_torch.sim``) at the JAX benchmark's sizes:
   (a) fig2c on GLR-CUCB (N=5, M=2, H=1024, stride 5), 24 seeds at
   T=20000, each its own piecewise env with 5 breakpoints and its own
   uniforms, as one ``regret_scan`` launch, each run equal to its
   single-run scan bit for bit; (b) the hp_grid, 16 gamma x delta points,
   as one ``sweep`` bucket and one launch, each point equal to its serial
   run; (c) the fill of the card: B = 1, 8, 132, 264, 528 runs on one
   shared env, ms a launch and a run-round beside the bound and the latency
   chain, and the occupancy the runtime reports; (d) fig2c on M-Exp3, N in
   {4, 5, 6, 7}, 24 seeds with their own adversarial tables (flip_prob
   0.002) and one shared stream (as the JAX benchmark), on the batched
   per-round route cut to T=1000, seeds 0 and 23 equal to their serial runs
   over 500 rounds; (e) Fig. 2a's fifteen rows x 4 seeds at T=1000 as one
   ``sweep`` (15 buckets), each row's seed 0 equal to phase 9's run; (f) a
   recompute-detector bucket of 8 seeds at T=20000 on the scan; (g)
   ``sweep(shard=True)`` equal to ``sweep()`` for a bucket of 5;
11. the non-stationary channel families and the closed-loop (reactive)
   form at the JAX benchmarks' sizes, each family's realization time first:
   (a) ``scenario_suite`` (``benchmarks/run.py:506-645``): M-Exp3(6, 2,
   gamma 0.5, share 1e-3) on 12 scenarios (Gilbert-Elliott, mobility,
   shadowing, jamming over a piecewise base) x 8 seeds at T=2000 as one
   ``sweep`` bucket on the batched per-round route, the first case of each
   family equal to its serial run; (b) ``scenario_suite_glr``: the same 96
   cases under GLR-CUCB(6, 2, H=512, stride 5) as one ``regret_scan`` launch,
   every row equal to its single-run scan and the first case of each family
   to the per-round route; (c) ``chaos_suite``'s regret half (``:1049-1100``):
   GLR-CUCB(8, 3, H=256, stride 5) at T=4000 on reactive jammers (strength
   0.6, 0.9) and congestion (severity 0.4, 0.8) as one launch of the
   reactive template, a batch of 1 equal to serial, one case of each family
   equal to the per-round route, and the reactive jammer against the
   matched open-loop jammer (different restarts and regret); (d) Fig. 2's
   run (phase 3's env as the reactive jammer's base, T=20000) on the
   reactive template beside phase 3's open-loop scan in turns, its first
   1000 rounds equal to the per-round route, and the occupancy of the
   three templates; (e) phase 4's Fig. 3 trainer on a reactive jammer over
   phase 4's env and on a Gilbert-Elliott process handed in unrealized
   (realized by the trainer from ``realize_generator``), three rounds of
   each against the CPU run and 150 rounds timed;
12. the batched FL engine (``simulate_fl_batch``, ``FLSweepCase`` buckets)
   at the JAX benchmark's sizes: (a) ``fig3_fig4_fl``'s ten rows
   (``benchmarks/run.py:742-786``: random, channel-aware, Lyapunov,
   GLR-CUCB with and without matching on phase 4's N = 30, M = 20 problem;
   the first three and M-Exp3 with and without matching on the adversarial
   N = 6, M = 4 one), 8 seeds a row as one batch, 150 rounds in segments
   ending at 40, 80 and 150 with a per-seed accuracy eval at each; each
   row's ``weighted_aggregate`` (and GLR-CUCB's ``glr_step``) launches 150
   times for the batch, and its seed 0 equals the row's serial run (phase
   9's, phase 4's for glr-cucb+aware): discrete state, n_success and mean
   AoI bit for bit, the rest at JAX's tolerances; (b) ``fl_batch_bench``'s
   twin (M = 4, N = 6, 8 seeds, 60 rounds in segments of 10 with evals),
   serial against batched (best of 3) and the batch-of-1 check; (c)
   ``chaos_suite``'s FL half: 9 attack x defense cells x 2 seeds as one
   ``sweep`` with JAX's containment verdicts, then the burst grid (2
   buckets, ``burst/0`` equal to its serial run bit for bit); (d)
   ``sweep(shard=True)`` equal to ``sweep()`` on an FL bucket, and a
   Gilbert-Elliott process bucket with per-case realizations; (e) a
   profiled 10-round window of a batch of 8;
13. the sparse client axis (``SparseAsyncFLTrainer``), ``fl_substrate``'s
   sizes: (0) ``weighted_aggregate``, ``robust_trimmed`` and ``glr_step``
   at the sparse round's shapes against their plain versions; (a) N =
   100,000 clients, M = 64 slots over 16 channels, a linear model (d =
   16), Markov churn, 24 rounds after a warm run: rounds a second, clients
   served, peak device memory, ``glr_step`` and ``weighted_aggregate``
   once a round; (b) its first three rounds against the CPU run (the
   discrete state and n_success bit for bit, params and buffers rtol
   1e-4); (c) dense against sparse at M = N = 20, 30 channels, 6 rounds,
   every state leaf and metric bit for bit; (d) each availability family
   over 24 rounds at (a)'s size, ``always_on`` bit for bit the run without
   a process; (e) ``run_served`` against ``run()`` over 10 rounds on (c)'s
   setup, bit for bit; (f) (a) with a coordinate-median aggregator,
   ``robust_trimmed`` once a round; (g) a profiled 10-round window of (a);
14. the FL training path at LLM scale (``make_fl_train_step``) on
   qwen1.5-0.5b: (0) ``flash_attention`` bf16 (8, 16/16, 2048, 64), its
   backward kernels (``flash_attention_bwd``: the logsumexp, dq, dk, dv
   against the f32 plain version at rtol 2^-6 / atol 2^-7 of the largest
   entry, two calls bitwise, the plain chunked route held against it, its
   time beside the plain version's, the chunked route's, SDPA's backward,
   the bound, its share of the bound and its time before the redesign for
   Hopper) and ``glr_step`` (8, 128) at the path's shapes against
   their plain versions; (a) at full width, 2 layers, f32: ``loss`` and
   its gradients on the kernel route against the plain route (rtol/atol
   2e-3), then in bf16: each leaf's relative error against that f32 run
   on the kernel route (the backward kernels) at most twice the bf16
   plain route's; (b) three
   rounds at the smoke config, f32, on the card against the CPU (the
   discrete state bit for bit, floats rtol 1e-4); (c) ``microbatches = 4``
   against 1 at (a)'s size in bf16; (d) all 24 layers in bf16 through the
   launcher's own functions (4 clients over 8 channels, AdamW, ``remat =
   "full"``, ``ce_chunk = 512``, B = 8, S = 2048, 20 rounds): finite and
   falling loss, ``flash_attention`` 48 times a step on the tensor-core
   route, its backward kernels 24 times and the chunked recompute never,
   ``glr_step`` once, ms a step, tokens a second, the model-FLOP share,
   peak device memory and a profiled 3-step window with the attention
   backward's share; (e) the trained parameters through
   ``save_checkpoint`` and back, bit for bit;
15. the scheduler service for every other policy it serves (random,
   round-robin, channel-aware, Lyapunov, M-Exp3 with Exp3.S sharing, each
   in its Fig. 2a configuration, and GLR-CUCB's recompute detector) at the
   ``serve_suite``'s sizes (N = 16, M = 4, capacity 256, slot batch 64,
   H = 256, stride 5): (a) one tenant served 1000 rounds equals
   ``simulate_aoi_regret`` on the card (the scan route for the recompute
   detector, the per-round route for the rest) and its first 200 rounds
   the CPU run, the tenant ``glr_scan`` launched once a recompute step and
   no kernel on the others; (b) 256 tenants with per-tenant hp: the first
   3 steps equal the CPU run, synchronous and pipelined decisions a second
   (best of 2), launches against steps, one step under
   ``set_sync_debug_mode("error")``, a profiled 10-step window for M-Exp3
   and the recompute detector; (c) ``run_served`` equal to ``run()`` bit
   for bit over 10 rounds: dense M-Exp3 with the matcher on phase 9's
   adversarial N = 6, M = 4 problem, sparse Lyapunov on phase 13 (c)'s
   setup; (d) phase 8's launches: no tenant ``glr_scan``.  A leaf that is
   not bitwise is named with its tolerance and why (``SERVED_NOT_BITWISE``);
16. MLA and MoE serving (minicpm3-4b, deepseek-v2-236b, dbrx-132b), one
   model at a time: (0) ``flash_attention`` at dbrx's prefill shape (4,
   48/8, 2048, 128) bf16 causal against its plain version, timed beside
   SDPA; (a) each at full width, 2 layers, f32 (deepseek-v2: its dense
   layer 0 and one MoE layer), a 2048-token prompt: the kernel route's
   prefill against the plain route (rtol/atol 2e-3; dbrx launches
   ``flash_attention`` twice on the FMA route, the MLA models never), then
   12 teacher-forced decode steps against ``apply``'s logits (rtol/atol
   2e-3), the MoE models at the capacity where no token drops; (b)
   deepseek-v2's router at full width on 2048 bf16 tokens: the card's
   top-6 ids, expert order, slots and keep mask bitwise those of the
   port's CPU code on the same probabilities, the ties counted; one MoE
   layer in f32 at the default capacity against a per-token loop over the
   kept (token, expert) pairs (rtol 2e-3); (c) bf16 serving at full width:
   minicpm3-4b at all 62 layers, deepseek-v2-236b and dbrx-132b cut to 8
   (``MLA_MOE_SERVED``): the parameter count, three prefills of 4 x 2048
   tokens (the first a warm-up; dbrx's launch ``flash_attention`` once a
   layer on the tensor-core route, the MLA models' never), the
   ``serve_loop`` at batch 8, context 2048, 32 tokens, peak memory, a
   profiled prefill's device time split into expert products, dispatch
   and combine, attention and the rest, and kernels a decode step;
17. SSM, RG-LRU hybrid and VLM serving (mamba2-1.3b, recurrentgemma-2b,
   phi-3-vision-4.2b), one model at a time, each at full width and depth:
   (a) ``flash_attention`` bf16 causal at recurrentgemma's local attention
   (4, 10/1, 2048, 256), window 2048, and at phi-3-vision's prefill (4,
   32/32, 2192, 96), both on the tensor-core route, against the f32 plain
   version (phase 2's bf16 tolerance), timed beside the plain version and
   SDPA (recurrentgemma's twice, around the FMA route on the same inputs,
   with its split-P ceiling); (b) f32 references at full width, cut in
   depth (mamba2 2 layers, recurrentgemma one whole rglru, rglru, attn
   cycle, phi-3-vision 2 layers): the kernel route's prefill of a
   2048-token prompt (phi-3-vision's behind 144 patch embeddings) against
   the plain route and 12 decode steps against ``apply`` (rtol/atol 2e-3);
   recurrentgemma again with its window cut to 64 and 80 decode steps, so
   the ring wraps; mamba2's prefill (L = 256 chunks, whose upper triangle
   overflows ``exp``) finite and equal to the CPU's run of the same
   weights; (c) bf16 serving: the parameter count against
   ``param_specs()``, three prefills of 4 x 2048 tokens (phi-3-vision's
   behind 144 random patch embeddings each; ``flash_attention`` 0, 8 and
   32 a prefill, all on the tensor-core route), the
   ``serve_loop`` at batch 8, context 2048, 32 tokens, peak memory, a
   profiled prefill's device time split into attention, the SSD chunk
   loop, the RG-LRU scan, the causal conv and the rest, and kernels a
   decode step;
18. training the SSM, RG-LRU hybrid, VLM and audio families (hubert-xlarge,
   mamba2-1.3b, recurrentgemma-2b, phi-3-vision-4.2b), one model at a
   time: (0) ``flash_attention`` bf16 at the three attending models'
   training shapes (hubert (8, 16/16, 2048, 80) non-causal, recurrentgemma
   (8, 10/1, 2048, 256) window 2048, phi-3-vision (8, 32/32, 2192, 96)),
   each on the tensor-core route against the f32 plain version (phase 2's
   bf16 tolerance), timed beside the plain version and SDPA, and its
   backward kernels as phase 14 (0); (a) f32 at
   full width, cut in depth (hubert, mamba2 and phi-3-vision 2 layers,
   recurrentgemma one rglru, rglru, attn cycle), B=2 x 512: ``loss`` and
   its gradients on the kernel route against the plain route (rtol/atol
   2e-3, and the bf16 gate, as phase 14 (a)), mamba2's (L = 256 chunks, the upper triangle's
   exponent past exp's overflow) finite and equal to the CPU's run of the
   same weights; (b) each smoke config in f32, three
   ``make_fl_train_step`` rounds on the card against the CPU run, as phase
   14 (b); (c) bf16 at full width and depth through ``launch/train.py``'s
   ``setup`` / ``train_round`` (B = 8 x 2048, phi-3-vision's behind 144
   patch embeddings, hubert's 2048 frames; ``remat="full"``, ``ce_chunk =
   512``, the launcher's clients, channels and history, the step donating
   its state), one warm-up round and three timed: the parameter count
   against ``param_specs()``, finite losses, moved parameters (hubert's
   never-read ``embed`` unchanged), ``flash_attention`` 96 / 0 / 16 / 64 a
   step on the tensor-core route, its backward kernels 48 / 0 / 8 / 32 and
   the chunked recompute never, ``glr_step`` once, ms a step,
   positions a second, the model-FLOP share of 989 TFLOP/s, peak device
   memory and a profiled step split into attention forward, the attention
   backward, the SSD chunk loop, the RG-LRU scan and the rest;
   then the MLA and MoE models (``MLA_MOE_TRAINED``: minicpm3-4b whole at
   B = 8 x 2048, deepseek-v2-236b cut to its dense layer 0 and one MoE
   layer at B = 4 x 1024, dbrx-132b cut to one layer at B = 8 x 2048, each
   cut the dry run's to a predicted peak of at most 75 GiB, printed where
   it runs), one at a time: (0) ``flash_attention`` at dbrx's training
   shape (8, 48/8, 2048, 128), tensor-core route, and its backward
   kernels, as above; (a) f32 at full
   width (minicpm3 and deepseek-v2 2 layers, dbrx 1), B=2 x 512:
   ``loss`` and its gradients twice, bit for bit (the MoE backward adds in
   a fixed order), then dbrx's kernel route against the plain route
   (rtol/atol 2e-3) and in bf16 (the gate of phase 14 (a)), and the MLA
   models' ``remat="full"`` against
   ``"none"`` (bitwise: the recompute routes as the forward did); (b) the
   smoke configs' rounds against the CPU, as above; (c) the cut through
   ``setup`` (its ``cfg``) / ``train_round``, one warm-up round and two
   timed, as above, with the active parameters (the model-FLOP share counts
   6 N_active B S, and MLA's attention at its two head widths), ``moe_aux``
   finite, and the profile's MoE dispatch, expert products and combine;
19. the dry run against the card, on the host (no step of its own): for
   every config and shape phases 7, 14, 16, 17 and 18 ran (qwen3-32b,
   minicpm3-4b, deepseek-v2-236b and dbrx-132b at 8 layers, mamba2-1.3b,
   recurrentgemma-2b and phi-3-vision-4.2b served; qwen1.5-0.5b,
   hubert-xlarge, mamba2, recurrentgemma, phi-3-vision, minicpm3-4b,
   deepseek-v2 (2 layers) and dbrx (1 layer) trained),
   ``repro_torch.launch.dryrun`` on meta tensors in six host processes,
   held against what those phases measured: (a) the step's static bytes
   (the weights and AdamW state after the launcher's setup; weights and
   prompts; weights, cache and tokens), as the allocator's requests count
   them, to 512 bytes a storage, with ``memory_allocated`` printed beside
   the allocator model's count; (b) the peak of a step
   (``max_memory_allocated`` from a reset before it, above what was held
   before the model was set up) within 10 %; (c) each kernel's launches a
   step exactly; (d) printed: the counted FLOPs, the roofline bound, the
   measured ms, the step's share of its roofline and the model-FLOP
   share.

Phase 2 releases its tensors and the allocator's cache before phase 3, so
the paths start from the same device memory state with or without it.
Phase 2 also holds ``flash_attention`` against ``ref.mha_attention`` at the
JAX package's five test shapes and at qwen3-32b's (4, 64/8, 2048, 128), in
f32 (the FMA route) and bf16 (the tensor-core route for D % 8 == 0 and
D <= 256, the FMA route otherwise), and times both routes, the plain
version and SDPA at the model shape in one call.
``--paths`` builds the kernels and runs phases 3-18 only (no kernel line, no phase 19):
the paths' own times, for comparing two checkouts (``tools/ab_smoke.py``).
To keep the whole near 900 s with phase 18, three host-bound depths are
cut, each printed where it runs: phase 6's rounds route to 5000 rounds
(20000 before), the per-round Fig. 2a rows of phases 9 and 10 to T=1000
(2000 before), phase 11 (d)'s rounds-route reference to 1000 rounds (2000
before).

Every path runs at the paper's sizes, uncut but for phase 9's two cuts,
phase 10's per-round cut (T=1000) and phase 6's rounds route (5000 of
its 20000 rounds), which they print (phases 11, 12 and 13
run the JAX benchmarks' own non-quick sizes).  Weights, envs and randomness
are made on the card from ``--seed``; the Fig. 3 data is the benchmark's
synthetic problem, made on the host from seeds offset by ``--seed`` (seed
0 gives the benchmark's own data).  The last line is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches (summed over the paths, each counted from zero), error
and times.  Without CUDA, or beside
no ``src/repro_torch`` package, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's rates and the kernels' counts are repro_torch's (utils/roofline.py, each
# wrapper's cost); one GLR split term of csrc/glr_kl.cuh, loads and store included,
# counted once in its sm_90a SASS (cuobjdump -sass; PERF.md gives the count's run)
SPLIT_SASS = 336
RANK_PAIR_OPS = 1              # lane instructions per ordered pair (kernels/robust_agg.py's)
OLD_RANK_PAIR_OPS = 4          # the bound stated before: two compares, a select, an add
HOST_SPLIT_CALLS = 10_000      # calls averaged in each host-split piece
FIG2_ROUNDS = 20000            # the paper's Fig. 2 horizon (benchmarks/run.py:175)
FIG2_REF_ROUNDS = 5000         # the card-vs-CPU reference run of Fig. 2
FIG2_ROUNDS_CUT = 5000         # phase 3's rounds route (host-bound, ~3-4.5 ms a round): T, cut
RECOMPUTE_ROUNDS_CUT = 5000    # phase 6's rounds route (host-bound, ~3.5 ms a round): T, cut
SCAN_EDGE_ROUNDS = 1500        # each edge run of regret_scan against the rounds route (phase 2)
FIG3_ROUNDS = 150              # the paper's Fig. 3 large-scale rounds (benchmarks/run.py:744-760)
FIG3_REF_ROUNDS = 3            # the card-vs-CPU reference rounds of Fig. 3
FIG3_REF_MAX_ROUNDS = 12       # ... extended, under attack, until a corrupted row is aggregated
SERVE_ARCH = "qwen3-32b"       # the most demanding dense GQA config of the zoo
SERVE_PROMPT = 2048            # prefill prompt length
SERVE_PREFILL_BATCH = 4        # prompts a prefill
SERVE_BATCH, SERVE_CONTEXT, SERVE_TOKENS = 8, 2048, 32   # the serve loop
SERVE_LAYERS = 64              # qwen3-32b's full depth: 61.0 GiB of bf16 weights
SERVE_REF_LAYERS = 2           # depth of the f32 reference model (full width)
DECODE_REF_STEPS = 12          # teacher-forced decode steps against the prefill
SCHED_CAPACITY, SCHED_SLOTS = 256, 64   # the serve suite's server (benchmarks/run.py:1380)
SCHED_N, SCHED_M, SCHED_H = 16, 4, 256  # GLR-CUCB served (benchmarks/run.py:1384-1385)
SCHED_PARITY_ROUNDS = 1000             # the single-tenant parity replay (:1381)
SCHED_REQUESTS = 12 * SCHED_CAPACITY   # saturated and Poisson requests (:1382)
SCHED_SERIAL_REQUESTS = 8 * SCHED_SLOTS   # the serial (slots=1) baseline's (:1383)
SCHED_BIG_CAPACITY, SCHED_BIG_H = 10_000, 64   # the 10^4-tenant server (:1451-1455)
SCHED_FL_ROUNDS = 10                   # run_served rounds on the Fig. 3 setup
FIG2A_ROUNDS_CUT = 1000        # Fig. 2a rows on the per-round route (phase 9): T, cut from 20000
FL_SEEDS = 8                   # seeds a Fig. 3/4 row and fl_batch_bench (run.py:747, :804)
FL_CHECKPOINTS = (40, 80, 150)  # a Fig. 3/4 row's segments, an accuracy eval at each end (:748)
FL_BENCH_SEGMENT, FL_BENCH_SEGMENTS = 10, 6   # fl_batch_bench's segments (:805)
CHAOS_FL_ROUNDS = 40           # chaos_suite's Byzantine matrix and burst grid (:1147)
GE_FL_ROUNDS = 40              # phase 12 (d)'s Gilbert-Elliott FL bucket, 4 cases
FIG2A_REF_ROUNDS = 500         # their card-vs-CPU rounds
FORKING_ROWS = ("channel-aware", "m-exp3", "aa-m-exp3")   # draws through log/exp: may fork
FIG2C_SEEDS = 24               # fig2c's seeds per N (benchmarks/run.py:262)
HP_GAMMAS = (0.5, 0.75, 1.0, 1.25)      # the hp_grid's 16 points (benchmarks/run.py:440-442)
HP_DELTAS = (1e-4, 1e-3, 1e-2, 1e-1)
FILL_BATCHES = (1, 8, 132, 264, 528)    # runs a regret_scan launch in phase 10 (c)
FIG2A_SEEDS = 4                # seeds a Fig. 2a row in phase 10's sweep (e)
RECOMPUTE_SEEDS = 8            # the recompute bucket of phase 10 (f)
SHARD_BATCH = 5                # the uneven bucket of phase 10 (g)
FORK_REL_TIE = 1e-5            # ... only at a near-tie this close, relative
SCEN_N, SCEN_M = 6, 2          # scenario_suite's policies (benchmarks/run.py:638-645)
SCEN_ROUNDS = 2000             # its horizon (:509, non-quick)
SCEN_SEEDS = 8                 # its seeds a scenario (:510)
CHAOS_N, CHAOS_M = 8, 3        # chaos_suite's regret half (:1049-1050)
CHAOS_ROUNDS = 4000            # its horizon, non-quick (:1049)
REACT_REF_ROUNDS = 1000        # phase 11 (d): the reactive Fig. 2 run's rounds held to the rounds route
FAMILY_REF_ROUNDS = 1000       # phase 11 (b), (c): the rounds route's references (~3.5 ms a round), cut
SUB_N, SUB_M, SUB_NCH, SUB_H = 100_000, 64, 16, 128   # fl_substrate (benchmarks/run.py:913, :924)
SUB_D, SUB_NEX, SUB_B = 16, 8, 4                       # its linear model and data (:913)
SUB_ROUNDS = 24                # its non-quick rounds (:914)
SUB_REF_ROUNDS = 3             # phase 13 (b): rounds on the card held to the CPU run
SUB_PROFILE_ROUNDS = 10        # phase 13 (g)'s window
PAR_N, PAR_NCH, PAR_ROUNDS, PAR_E, PAR_B = 20, 30, 6, 2, 3   # its dense-vs-sparse parity (:943)
SUB_SERVED_ROUNDS = 10         # phase 13 (e): run_served against run()
TRAIN_ARCH = "qwen1.5-0.5b"     # the training path's model, full width and depth (phase 14)
TRAIN_B, TRAIN_S = 8, 2048      # its batch: sequences x tokens
TRAIN_ROUNDS, TRAIN_WARM = 20, 2   # rounds of (d), the first two untimed
TRAIN_PROFILE_STEPS = 3         # (d)'s traced window
TRAIN_CLIENTS, TRAIN_CHANNELS, TRAIN_HISTORY = 4, 8, 128   # launch/train.py's own
TRAIN_LR, TRAIN_CE_CHUNK = 3e-4, 512
TRAIN_REF_LAYERS, TRAIN_REF_S = 2, 512   # (a) and (c): full width, 2 layers
TRAIN_REF_ROUNDS = 3            # (b): rounds on the card held to the CPU run
MLA_MOE_SERVED = (("minicpm3-4b", 62), ("deepseek-v2-236b", 8), ("dbrx-132b", 8))
# phase 16's models and the depth each is served at: minicpm3-4b whole (7.94 GiB of bf16
# weights); the two MoE models cut to 8 layers, 54.07 and 50.86 GiB (full depth: 438.8 and
# 245.1 GiB, past one card's 80 GB)
ROUTER_ARCH, ROUTER_TOKENS = "deepseek-v2-236b", 2048   # phase 16 (b): the router on the card
DBRX_ATTN = (SERVE_PREFILL_BATCH, 48, 8, SERVE_PROMPT, 128)   # dbrx-132b's prefill attention
# phase 17's models, each served at full depth, and the depth of its f32 reference: mamba2
# 2 SSD layers, recurrentgemma one whole (rglru, rglru, attn) cycle, phi-3-vision 2 layers
HYBRID_REF_LAYERS = (("mamba2-1.3b", 2), ("recurrentgemma-2b", 3), ("phi-3-vision-4.2b", 2))
RGEMMA_WINDOW = 2048           # recurrentgemma-2b's local attention window
RGEMMA_ATTN = (SERVE_PREFILL_BATCH, 10, 1, SERVE_PROMPT, 256)         # its prefill attention
PHI3V_ATTN = (SERVE_PREFILL_BATCH, 32, 32, 144 + SERVE_PROMPT, 96)    # 144 patches + the prompt
RING_CUT, RING_STEPS = 64, 80  # (b): recurrentgemma's window cut to 64, 80 decode steps
# phase 18's models, trained at full width and depth, and the depth of each one's f32
# reference: hubert and phi-3-vision 2 layers, mamba2 2 SSD layers, recurrentgemma one whole
# (rglru, rglru, attn) cycle
TRAIN_FAMILIES = (("hubert-xlarge", 2), ("mamba2-1.3b", 2), ("recurrentgemma-2b", 3),
                  ("phi-3-vision-4.2b", 2))
FAMILY_ROUNDS, FAMILY_WARM = 4, 1   # (c): rounds a model, the first untimed
# phase 18's MLA and MoE models: (arch, layers trained, B, S, layers of the f32 reference),
# each cut from the dry run to a predicted peak of at most 75 GiB at full width (PERF.md):
# minicpm3-4b whole (62.08 GiB at B = 8 x 2048); deepseek-v2 its dense layer 0 and one MoE
# layer at B = 4 x 1024 (63.04; 75.77 at 4 x 2048); dbrx one (MoE) layer (64.15); the
# references hold one layer of each kind
MLA_MOE_TRAINED = (("minicpm3-4b", 62, TRAIN_B, TRAIN_S, 2),
                   ("deepseek-v2-236b", 2, 4, 1024, 2),
                   ("dbrx-132b", 1, TRAIN_B, TRAIN_S, 1))
MLA_MOE_ROUNDS = 3             # (c): rounds a model, the first untimed (phase 18's 4, cut)
KERNEL_NAMES = ("glr_step", "weighted_aggregate", "robust_trimmed", "glr_scan",
                "flash_attention", "flash_attention_bwd", "regret_scan", "glr_step_tenants",
                "glr_scan_tenants")
FLASH_ROUTES = ("flash_attention_tc", "flash_attention_fma")   # its two routes' counters
# the backward kernels' ms a call before their redesign for Hopper (mma.sync m16n8k16 and
# cp.async), measured by this script on an H100 80GB HBM3 at 700 W, at the five training
# shapes (B, Hq, Hkv, S, D); printed beside this run's time, never compared against it
BWD_MMA_SYNC_MS = {(8, 16, 16, 2048, 64): 1.5854, (8, 16, 16, 2048, 80): 3.3711,
                   (8, 10, 1, 2048, 256): 6.0260, (8, 32, 32, 2192, 96): 4.9188,
                   (8, 48, 8, 2048, 128): 7.4530}
BATCH_ROUTES = ("weighted_aggregate_batch", "robust_trimmed_batch")   # the Step-4 batch launches
PLAIN_BACKWARD = "attention_plain_backward"   # attention gradients by the chunked recompute
COUNTERS = (KERNEL_NAMES + FLASH_ROUTES + ("regret_scan_reactive",) + BATCH_ROUTES
            + (PLAIN_BACKWARD,))
# (regret_scan's reactive template and the Step-4 batch launches count in .launches too;
# flash_attention_bwd counts a backward call, three launches: Delta, dK/dV, dQ)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def line(*parts):
    print(*parts, flush=True)


def kernel_wrappers():
    """Each kernel's wrapper, by name: the ``.launches`` counters."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.glr_scan import glr_scan, glr_scan_tenants
    from repro_torch.kernels.glr_step import glr_step
    from repro_torch.kernels.glr_step_tenants import glr_step_tenants
    from repro_torch.kernels.regret_scan import regret_scan
    from repro_torch.kernels.robust_agg import robust_trimmed
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate

    return dict(glr_step=glr_step, weighted_aggregate=weighted_aggregate,
                robust_trimmed=robust_trimmed, glr_scan=glr_scan,
                flash_attention=flash_attention, flash_attention_bwd=flash_attention_bwd,
                regret_scan=regret_scan, glr_step_tenants=glr_step_tenants,
                glr_scan_tenants=glr_scan_tenants)


def reset_launches():
    from repro_torch.models.attention import _KernelAttention

    for w in kernel_wrappers().values():
        w.launches = 0
    _KernelAttention.plain_backward_calls = 0
    fa = kernel_wrappers()["flash_attention"]
    fa.tc_launches = fa.fma_launches = 0
    kernel_wrappers()["regret_scan"].reactive_launches = 0
    for name in ("weighted_aggregate", "robust_trimmed"):
        kernel_wrappers()[name].batch_launches = 0


def read_launches():
    """Every counter of ``COUNTERS``: each wrapper's, ``flash_attention``'s
    per route, ``regret_scan``'s reactive template's and the attention
    gradients taken by the chunked recompute (``PLAIN_BACKWARD``)."""
    from repro_torch.models.attention import _KernelAttention

    out = {k: w.launches for k, w in kernel_wrappers().items()}
    out[PLAIN_BACKWARD] = _KernelAttention.plain_backward_calls
    fa = kernel_wrappers()["flash_attention"]
    out.update(flash_attention_tc=fa.tc_launches, flash_attention_fma=fa.fma_launches,
               regret_scan_reactive=kernel_wrappers()["regret_scan"].reactive_launches,
               **{f"{k}_batch": kernel_wrappers()[k].batch_launches
                  for k in ("weighted_aggregate", "robust_trimmed")})
    return out


def per_step(launches, steps, label):
    """Each counter's launches a step from a total over ``steps`` steps;
    fails unless every total splits evenly."""
    check(all(v % steps == 0 for v in launches.values()),
          f"{label}: launches {launches} do not split evenly over {steps} steps")
    return {k: v // steps for k, v in launches.items()}


def allocator_bytes(torch):
    """(allocated, requested) bytes of the caching allocator now: the blocks
    of live tensors (``memory_allocated``) and what their allocations asked
    for."""
    stats = torch.cuda.memory_stats()
    return stats["allocated_bytes.all.current"], stats.get("requested_bytes.all.current", 0)


def minus(a, b, plus=(0, 0)):
    return tuple(x - y + z for x, y, z in zip(a, b, plus))


def free_blocks(torch):
    """The caching allocator's free cached blocks in its default pool now,
    as (bytes, small pool) pairs: what ``release`` could not hand back,
    because live tensors of earlier work share their segments, and what a
    new request may land in."""
    return [(b["size"], seg["segment_type"] == "small")
            for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", (0, 0))) == (0, 0)
            for b in seg["blocks"] if b["state"] == "inactive"]


def env_sizes(env):
    """The storage sizes of the launcher's env (``TrainRun.env``), which the
    training step holds beside the state it is handed."""
    import dataclasses

    from repro_torch.utils.cost import storages

    return list(storages([getattr(env, f.name) for f in dataclasses.fields(env)]).values())


def card_step(static, peak, launches, ms, free, held=()):
    """A step's measurements for phase 19: the bytes it is handed (weights
    and AdamW state, or weights, prompts or cache; ``allocator_bytes``'
    pair) and its peak, both above what was held before the model was set
    up, its launches of each kernel and its ms; ``free``, the allocator's
    free blocks (``free_blocks``) where each run of the state's
    allocations began (the weights', and a decode step's cache's), and
    ``held``, the sizes of what setup made beside that state (training's
    env)."""
    return dict(static_bytes=static[0], static_requested=static[1], peak_bytes=peak,
                launches=launches, ms=ms, free=free, held=list(held))


def decode_step_card(torch, model, params, cache, tok, m_pre, weights, step_ms, free):
    """One more decode step after a serve loop, the peak statistics reset
    before it (not counted with the loop's launches): its measurements for
    phase 19.  ``m_pre`` was allocated before the loop made its cache;
    ``weights`` the parameters' bytes; ``free`` as ``card_step``'s."""
    from repro_torch.launch.steps import make_serve_step

    static = minus(allocator_bytes(torch), m_pre, weights)
    before = read_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    make_serve_step(model)(params, cache, tok)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - m_pre[0] + weights[0]
    after = read_launches()
    return card_step(static, peak, {k: after[k] - before[k] for k in after}, step_ms, free)


def scan_cost(sched, rounds, **kw):
    """``regret_scan.cost`` of ``rounds`` rounds of ``sched``'s scan
    (``runs``, ``splits`` and ``reactive`` as there)."""
    from repro_torch.kernels import regret_scan

    return regret_scan.cost(sched.n_channels, sched.n_clients, sched.history, rounds, **kw)


def bound_of(kcost):
    """(bound ms, what bounds it) of a kernel call's ``KernelCost`` (each
    wrapper's ``cost``: the count the dry run's walker uses too)."""
    return kcost.bound_ms, kcost.bound_by


def time_ms(torch, fn, iters):
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls, by CUDA events after a warm-up (host launch cost included)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trace_kernels(torch, fn):
    """Run ``fn`` once under ``torch.profiler``: (the device kernels of the
    exported trace, the wall time in us)."""
    events, wall_us = trace_events(torch, fn)
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e], wall_us


def trace_events(torch, fn):
    """Run ``fn`` once under ``torch.profiler``: (every event of the
    exported trace, the wall time in us)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
    return events, wall_us


def device_ms(torch, fn, calls):
    """Device time a call of ``fn``: the kernel intervals of ``calls``
    back-to-back calls in a ``torch.profiler`` trace, summed, over
    ``calls`` (every kernel a call launches counts).  None when the trace
    holds no kernel."""
    fn()
    kernels, _ = trace_kernels(torch, lambda: [fn() for _ in range(calls)])
    return sum(float(e["dur"]) for e in kernels) / calls / 1e3 if kernels else None


def host_split(torch, label, pieces, whole, calls=HOST_SPLIT_CALLS, chunk=500):
    """Mean host microseconds a call of each piece of a wrapper and of the
    whole wrapper call, by ``time.perf_counter`` over ``calls`` calls in
    chunks of ``chunk``; the device catches up between chunks (untimed), so
    the launch queue never fills and the host never waits for the device.
    Prints one line; returns {piece: us}."""
    def per_call(fn):
        fn()
        total = 0.0
        for _ in range(calls // chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(chunk):
                fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return total / (calls // chunk * chunk) * 1e6

    split = {name: per_call(fn) for name, fn in pieces.items()}
    split["whole call"] = per_call(whole)
    parts = sum(v for k, v in split.items() if k != "whole call")
    line(f"  {label} host split, mean of {calls} calls: "
         + ", ".join(f"{k} {v:.3f} us" for k, v in split.items() if k != "whole call")
         + f"; pieces {parts:.3f} us, whole call {split['whole call']:.3f} us "
         f"(the rest: data_ptr reads, the counter, the error test)")
    return split


def turns_ms(torch, fns, iters, turns=3):
    """``time_ms`` of each of ``fns`` ({label: fn}), taken in turns
    (a, b, a, b, ...) ``turns`` times: {label: [ms of each turn]}.  A host-
    bound call moves by tens of percent between back-to-back windows; the
    turns show that spread beside the single window of ``time_ms``."""
    out = {k: [] for k in fns}
    for _ in range(turns):
        for k, fn in fns.items():
            out[k].append(time_ms(torch, fn, iters))
    return out


def profile_window(torch, label, fn, rounds):
    """Trace ``fn`` (``rounds`` rounds of a loop) with ``torch.profiler`` and
    print the device's busy share of the wall time, kernels launched per
    round and the kernels that take the most device time.  Returns the
    device time by kernel name in us ({} when the trace has none)."""
    kernels, wall_us = trace_kernels(torch, fn)
    return report_kernels(label, kernels, wall_us, rounds)


def report_kernels(label, kernels, wall_us, rounds):
    """``profile_window``'s lines for the kernels of one trace."""
    if not kernels:
        line(f"  profile {label}: no device kernels in the trace; device busy share not measured")
        return {}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                      # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    line(f"  profile {label}: {rounds} rounds, wall {wall_us / rounds / 1e3:.4f} ms/round, "
         f"device busy {100 * busy / wall_us:.1f}% (idle {100 - 100 * busy / wall_us:.1f}%), "
         f"{len(kernels) / rounds:.1f} kernels/round, {busy / rounds:.1f} us device time/round")
    for name, dur in top:
        line(f"    {dur / rounds:8.2f} us/round  {100 * dur / busy:5.1f}%  {name[:90]}")
    return by_name


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def launch_floor(torch):
    """The card's floor per kernel launch: an empty kernel launched
    back to back (a) 1000 times from one C loop, the device's own floor,
    and (b) once per ``ctypes`` call, as the port's wrappers call a kernel
    (host call cost included).  Milliseconds per launch."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load("launch_floor", "launch_floor_launch", [ctypes.c_int, ctypes.c_void_p])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch(n):
        check(fn(n, stream) == 0, "launch_floor: empty kernel failed to launch")

    device_ms = time_ms(torch, lambda: launch(1000), 20) / 1000
    call_ms = time_ms(torch, lambda: launch(1), 5000)
    line(f"  launch floor: empty kernel {device_ms:.5f} ms per launch from a C loop, "
         f"{call_ms:.5f} ms per ctypes call")
    return device_ms, call_ms


def glr_inputs(torch, shape, gen, binary):
    """A prefix state across ring wraparound: counts in [0, 3H) with rows
    before, at and past the wrap; a mixed ``sched`` mask."""
    h, rows = shape[-1], shape[:-1]
    dev = "cuda"
    counts = torch.randint(0, 3 * h, rows, generator=gen, device=dev).to(torch.float32)
    flat = counts.view(-1)
    flat[:3] = torch.tensor([0.0, h - 1.0, float(h)], device=dev)[: flat.numel()]
    if binary:
        cum = torch.randint(0, 2 * h, shape, generator=gen, device=dev).to(torch.float32)
        total = torch.randint(0, 3 * h, rows, generator=gen, device=dev).to(torch.float32)
        base = torch.randint(0, h, rows, generator=gen, device=dev).to(torch.float32)
        r_vec = torch.randint(0, 2, rows, generator=gen, device=dev).to(torch.float32)
    else:
        cum = torch.sort(torch.rand(shape, generator=gen, device=dev), dim=-1).values * h
        total = torch.rand(rows, generator=gen, device=dev) * 3 * h
        base = torch.rand(rows, generator=gen, device=dev)
        r_vec = torch.rand(rows, generator=gen, device=dev)
    sched = torch.rand(rows, generator=gen, device=dev) < 0.7
    sched.view(-1)[0] = False                      # an empty window: stat -inf
    return cum, total, base, counts, r_vec, sched


def glr_split_count(torch, counts, sched, h, geometric):
    """GLR splits the kernel evaluates on these inputs (1 <= s <= n-1)."""
    n = torch.clamp(counts.to(torch.int64) + sched.to(torch.int64), max=h).view(-1, 1)
    s = torch.arange(1, h, device=counts.device).view(1, -1)
    valid = s <= n - 1
    if geometric:
        pow2 = lambda x: (x > 0) & ((x & (x - 1)) == 0)
        valid &= pow2(s) | pow2(n - s)
    return int(valid.sum())


def glr_bound_ms(torch, args, h, geometric):
    """``glr_step.cost`` on these inputs: the splits their counts make."""
    from repro_torch.kernels import glr_step

    cum, total, base, counts, r_vec, sched = args
    return bound_of(glr_step.cost(cum.numel() // h, h, glr_split_count(torch, counts, sched, h,
                                                                        geometric)))


def check_glr_step(torch, gen, floor_ms):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.glr_step import glr_step as kernel

    max_err = 0.0
    shapes = [(5, 1024), (30, 256), (1000, 1000), (256, 16, 1024)]
    for shape in shapes:
        for grid in ("all", "geometric"):
            for binary in (True, False):
                args = glr_inputs(torch, shape, gen, binary)
                h = shape[-1]
                got = ops.glr_step(*args, split_grid=grid)
                want = ref.glr_step(*(a.reshape(-1, h) if a.dim() == len(shape) else
                                      a.reshape(-1) for a in args), split_grid=grid)
                torch.cuda.synchronize()
                for g, w, name in zip(got[:3], want[:3], ("cum", "total", "base")):
                    g = g.reshape(w.shape)
                    if binary:
                        check(torch.equal(g, w), f"glr_step {shape} {grid}: {name} not bitwise")
                    else:
                        check(torch.allclose(g, w, rtol=1e-6, atol=0),
                              f"glr_step {shape} {grid}: {name} beyond rtol 1e-6")
                gs, ws = got[3].reshape(-1), want[3]
                check(torch.equal(torch.isneginf(gs), torch.isneginf(ws)),
                      f"glr_step {shape} {grid}: -inf at other places")
                fin = torch.isfinite(ws)
                check(torch.equal(fin, torch.isfinite(gs)), f"glr_step {shape} {grid}: non-finite stat")
                err = float((gs[fin] - ws[fin]).abs().max()) if bool(fin.any()) else 0.0
                check(torch.allclose(gs[fin], ws[fin], rtol=1e-5, atol=1e-5),
                      f"glr_step {shape} {grid}: stat beyond rtol/atol 1e-5 (max err {err})")
                max_err = max(max_err, err)
                line(f"  glr_step {shape} grid={grid} rewards={'{0,1}' if binary else 'U[0,1]'}: "
                     f"state {'bitwise' if binary else 'rtol 1e-6'}, stat max_abs_err={err:.3e} ok")

    timings = {}
    for shape, label in (((5, 1024), "fig2"), ((30, 256), "fig3")):
        h = shape[-1]
        args = glr_inputs(torch, shape, gen, True)
        cum, total, base, counts, r_vec, sched = args
        counts_i = counts.to(torch.int32)
        ms = time_ms(torch, lambda: kernel(cum, total, base, counts_i, r_vec, sched), 2000)
        plain_ms = time_ms(torch, lambda: ref.glr_step(*args), 200)
        bound, bound_by = glr_bound_ms(torch, args, h, geometric=False)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        line(f"  glr_step time {label} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"bound {bound:.2e} ms ({bound_by}), launch floor {floor_ms:.5f} ms, "
             f"per call back to back")

    return max_err, timings


def tenants_inputs(torch, r, b, n, h, frac_detect, pad, gen, binary=True):
    """A serve step's operands: slot state (R, N, H) across ring wraparound,
    B distinct slots of which the last ``pad`` are padding rows on the
    scratch slot R - 1 (not live), ``frac_detect`` of the live rows on a
    detection round (at least one), a mixed ``sched``."""
    dev = "cuda"
    if binary:
        cum = torch.randint(0, 2 * h, (r, n, h), generator=gen, device=dev).to(torch.float32)
        total = torch.randint(0, 3 * h, (r, n), generator=gen, device=dev).to(torch.float32)
        base = torch.randint(0, h, (r, n), generator=gen, device=dev).to(torch.float32)
        r_vec = torch.randint(0, 2, (b, n), generator=gen, device=dev).to(torch.float32)
    else:
        cum = torch.sort(torch.rand((r, n, h), generator=gen, device=dev), dim=-1).values * h
        total = torch.rand((r, n), generator=gen, device=dev) * 3 * h
        base = torch.rand((r, n), generator=gen, device=dev)
        r_vec = torch.rand((b, n), generator=gen, device=dev)
    counts = torch.randint(0, 3 * h, (b, n), generator=gen, device=dev).to(torch.float32)
    counts.view(-1)[:3] = torch.tensor([0.0, h - 1.0, float(h)], device=dev)[: counts.numel()]
    slots = torch.randperm(r - 1 if r > b else r, generator=gen, device=dev)[:b].to(torch.int32)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    if pad:
        slots[-pad:] = r - 1
        live[-pad:] = False
    detect = (torch.rand(b, generator=gen, device=dev) < frac_detect) & live
    detect[0] = True
    sched = torch.rand((b, n), generator=gen, device=dev) < 0.7
    return cum, total, base, slots, live, detect, counts, r_vec, sched


def tenants_bound_ms(torch, args, geometric):
    """The least time of one step on these inputs, in place: bytes
    (detecting rows' rings read once, every live row's 17 bytes a channel,
    6 bytes a row) over HBM, or operations, the larger of the FMA count
    (32 a split) over the f32 rate and the split term's MUFU instructions
    over 16 a clock on each of 132 SMs.  Returns (bound ms, bound_by, the
    split count, {bytes, fma, mufu ms})."""
    from repro_torch.kernels import glr_step_tenants
    from repro_torch.kernels.glr_step import KL_SPLIT_FLOPS
    from repro_torch.utils import roofline as rl

    cum, total, base, slots, live, detect, counts, r_vec, sched = args
    n, h = cum.shape[1:]
    det = detect & live
    splits = glr_split_count(torch, counts[det], sched[det], h, geometric)
    kc = glr_step_tenants.cost(n, h, slots.numel(), int(det.sum()), int(live.sum()), splits)
    parts = dict(bytes=kc.nbytes / rl.HBM_BW * 1e3,
                 fma=KL_SPLIT_FLOPS * splits / rl.PEAK_FLOPS_F32 * 1e3,
                 mufu=kc.ops / kc.rate * 1e3)
    return kc.bound_ms, kc.bound_by, splits, parts


def check_glr_step_tenants(torch, gen, floor_ms):
    """The in-place serving kernel against ``ref.glr_step_tenants`` on the
    same inputs: the slot state bitwise on {0, 1} rewards (rtol 1e-6 on
    U[0, 1]), rows not live untouched, the statistic at rtol/atol 1e-5 with
    -inf at the same places, both grids, at the serving shapes
    (R = 257 / B = 64, N = 16, H = 256 and R = 10001 / B = 64, H = 64, a
    fifth of the rows detecting, padding rows), all rows live and detecting
    at (256, 16, 1024), and at H = 33 and H = 130 (scalar loads).  Times per
    call back to back, device time from a trace, the old functional kernel
    beside it at (256, 16, 1024), the plain version, both bounds; the split
    term's issue time; at the serving shape the host split of a call."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import glr_step_tenants as gst_mod
    from repro_torch.kernels.glr_step import glr_step as old_kernel
    from repro_torch.utils import roofline as rl

    kernel = gst_mod.glr_step_tenants
    cases = {"full": (256, 256, 16, 1024, 1.0, 0), "serve": (257, 64, 16, 256, 0.2, 5),
             "big": (10001, 64, 16, 64, 0.2, 3), "h33": (20, 12, 5, 33, 0.6, 2),
             "h130": (20, 12, 5, 130, 0.6, 2)}
    max_err = 0.0
    for label, (r, b, n, h, frac, pad) in cases.items():
        for grid in ("all", "geometric"):
            for binary in (True, False):
                args = tenants_inputs(torch, r, b, n, h, frac, pad, gen, binary)
                got_state = [x.clone() for x in args[:3]]
                want_state = [x.clone() for x in args[:3]]
                got = ops.glr_step_tenants(*got_state, *args[3:], split_grid=grid)
                want = ref.glr_step_tenants(*want_state, *args[3:], split_grid=grid)
                torch.cuda.synchronize()
                where = f"glr_step_tenants ({r}, {b}, {n}, {h}) {grid}"
                for g, w, name in zip(got_state, want_state, ("cum", "total", "base")):
                    if binary:
                        check(torch.equal(g, w), f"{where}: {name} not bitwise")
                    else:
                        check(torch.allclose(g, w, rtol=1e-6, atol=0), f"{where}: {name} beyond rtol 1e-6")
                untouched = torch.ones(r, dtype=torch.bool, device="cuda")
                untouched[args[3][args[4]].long()] = False
                for g, x, name in zip(got_state, args[:3], ("cum", "total", "base")):
                    check(torch.equal(g[untouched], x[untouched]), f"{where}: {name} of a row not live changed")
                check(torch.equal(torch.isneginf(got), torch.isneginf(want)), f"{where}: -inf at other places")
                fin = torch.isfinite(want)
                check(torch.equal(fin, torch.isfinite(got)), f"{where}: non-finite stat")
                err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
                check(torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5),
                      f"{where}: stat beyond rtol/atol 1e-5 (max err {err})")
                max_err = max(max_err, err)
                line(f"  {where} rewards={'{0,1}' if binary else 'U[0,1]'}: "
                     f"{int(args[5].sum())}/{b} rows detecting, state "
                     f"{'bitwise' if binary else 'rtol 1e-6'}, rows not live untouched, "
                     f"stat max_abs_err={err:.3e} ok")

    timings = {}
    for label in ("full", "serve", "big"):
        r, b, n, h, frac, pad = cases[label]
        args = tenants_inputs(torch, r, b, n, h, frac, 0, gen, True)
        cum, total, base, slots, live, detect, counts, r_vec, sched = args
        counts_i = counts.to(torch.int32)
        call = lambda: kernel(cum, total, base, slots, live, detect, counts_i, r_vec, sched)
        small = label != "full"
        t = dict(ms=time_ms(torch, call, 2000 if small else 500),
                 plain_ms=time_ms(torch, lambda: ref.glr_step_tenants(*args), 50),
                 device_ms=device_ms(torch, call, 100), library_ms=None)
        bound, bound_by, splits, parts = tenants_bound_ms(torch, args, False)
        issue_ms = splits * SPLIT_SASS / (rl.LANES_PER_SM_CLOCK * rl.SM_COUNT
                                          * rl.SM_CLOCK_HZ) * 1e3
        t.update(bound_ms=bound, bound_by=bound_by, splits=splits,
                 detecting_rows=int(detect.sum()))
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        old = ""
        if label == "full":
            cum_o, total_o, base_o = cum.clone(), total.clone(), base.clone()
            t["old_ms"] = time_ms(torch, lambda: old_kernel(cum_o, total_o, base_o, counts_i, r_vec,
                                                           sched), 500)
            old = f", old functional glr_step kernel {t['old_ms']:.4f} ms"
        line(f"  glr_step_tenants time {label} ({r}, {b}, {n}, {h}), {t['detecting_rows']}/{b} "
             f"rows detecting: kernel {t['ms']:.4f} ms{old}, plain {t['plain_ms']:.4f} ms, per "
             f"call back to back, one window each; device time {fmt(t['device_ms'])}; bound "
             f"{bound:.5f} ms ({bound_by}; bytes {parts['bytes']:.5f}, FMA {parts['fma']:.5f}, "
             f"MUFU {parts['mufu']:.5f} ms over {splits} splits, {gst_mod.SPLIT_MUFU} MUFU a "
             f"split); "
             f"issue at {SPLIT_SASS} SASS instructions a split {issue_ms:.5f} ms (SM clock "
             f"{rl.SM_CLOCK_HZ / 1e6:.0f} MHz); launch floor {floor_ms:.5f} ms")
        if label == "serve":
            dev = cum.get_device()
            fn = _build.load("glr_step_tenants", "glr_step_tenants_launch", gst_mod._ARGTYPES)
            out = torch.empty((b, n), device="cuda")
            ptrs = (cum.data_ptr(), total.data_ptr(), base.data_ptr(), slots.data_ptr(),
                    live.data_ptr(), detect.data_ptr(), counts_i.data_ptr(), r_vec.data_ptr(),
                    sched.data_ptr(), out.data_ptr(), b, n, r, h, 0, _build.stream(dev))
            t["host_split_us"] = host_split(torch, f"glr_step_tenants ({r}, {b}, {n}, {h})", {
                "checks": lambda: gst_mod._checked(cum, total, base, slots, live, detect,
                                                   counts_i, r_vec, sched, "all"),
                "load": lambda: _build.load("glr_step_tenants", "glr_step_tenants_launch",
                                            gst_mod._ARGTYPES),
                "output allocation": lambda: counts_i.new_empty((b, n), dtype=torch.float32),
                "stream lookup": lambda: _build.stream(dev),
                "ctypes call + launch": lambda: fn(*ptrs),
            }, call)
        timings[label] = t
        del args, cum
    return max_err, timings


def scale_like_main_path(torch, m, gen):
    """Eq. 7 scales as the main path makes them: mask * zeta * M / |S_t|."""
    mask = (torch.rand(m, generator=gen, device="cuda") < 0.6).to(torch.float32)
    mask[0] = 1.0
    zeta = torch.rand(m, generator=gen, device="cuda") + 0.5
    zeta = zeta / zeta.sum()
    return mask * zeta * (m / mask.sum())


def row_order_sum(torch, upd, scale):
    """``acc = acc + scale[r] * x[r]``, r = 0..M-1, one rounded product and
    one rounded add a row: the kernel's own order and rounding."""
    acc = torch.zeros(upd.shape[1], device=upd.device)
    for r in range(upd.shape[0]):
        acc = acc + scale[r] * upd[r].float()
    return acc


def check_weighted_aggregate(torch, gen, floor_ms):
    """Kernel against plain (rtol 1e-5 / atol 1e-6: torch's ``sum`` may add
    in another order) and bitwise against the row-order sum, at every load
    width: (20, 5674) and (64, 2^24 + 2) 8-byte f32 rows, (64, 2^24) 16-byte,
    (64, 2^24 + 3) 4-byte.  Times at the Fig. 3 shape and both large ones:
    per call back to back (host included), device time from a trace, the
    plain version, ``scale @ updates``; the host split of one call."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import weighted_aggregate as wa_mod

    kernel = wa_mod.weighted_aggregate
    shapes = {"fig3": (20, 5674), "large": (64, 2 ** 24), "large_ragged": (64, 2 ** 24 + 2)}
    max_err = 0.0
    for m, p in (shapes["fig3"], (64, 2 ** 24 + 3), shapes["large"], shapes["large_ragged"]):
        for dtype in (torch.float32, torch.bfloat16):
            upd = torch.randn((m, p), generator=gen, device="cuda").to(dtype)
            scale = scale_like_main_path(torch, m, gen)
            got = ops.weighted_aggregate(upd, scale)
            want = ref.weighted_aggregate(upd, scale)
            rows = row_order_sum(torch, upd, scale)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(got.dtype == torch.float32 and got.shape == (p,),
                  "weighted_aggregate: shape/dtype")
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                  f"weighted_aggregate ({m}, {p}) {dtype}: beyond rtol 1e-5 / atol 1e-6 ({err})")
            check(torch.equal(got, rows),
                  f"weighted_aggregate ({m}, {p}) {dtype}: not bitwise equal to the row-order sum")
            max_err = max(max_err, err)
            line(f"  weighted_aggregate ({m}, {p}) {str(dtype).split('.')[-1]}: "
                 f"max_abs_err={err:.3e} vs plain, bitwise equal to the row-order sum ok")
            del upd, got, want, rows

    timings = {}
    for label, (m, p) in shapes.items():
        upd = torch.randn((m, p), generator=gen, device="cuda")
        scale = scale_like_main_path(torch, m, gen)
        small = p < 10 ** 6
        iters = 2000 if small else 20
        call, library = lambda: kernel(upd, scale), lambda: scale @ upd
        t = dict(ms=time_ms(torch, call, iters),
                 plain_ms=time_ms(torch, lambda: ref.weighted_aggregate(upd, scale), iters),
                 library_ms=time_ms(torch, library, iters))
        turns = turns_ms(torch, {"kernel": call, "library": library}, iters)
        t.update(turns_ms=turns["kernel"], library_turns_ms=turns["library"],
                 device_ms=device_ms(torch, call, 100 if small else 10),
                 library_device_ms=device_ms(torch, library, 100 if small else 10))
        nbytes = m * p * 4 + m * 4 + p * 4
        t["bound_ms"], t["bound_by"] = bound_of(wa_mod.cost((m, p), 4))
        timings[label] = t
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        each = lambda xs: " / ".join(f"{x:.4f}" for x in xs)
        line(f"  weighted_aggregate time {label} ({m}, {p}) f32: kernel {t['ms']:.4f} ms, "
             f"plain {t['plain_ms']:.4f} ms, library (scale @ updates) {t['library_ms']:.4f} ms, "
             f"per call back to back, one window each; interleaved turns: kernel "
             f"{each(t['turns_ms'])}, library {each(t['library_turns_ms'])}; device time: "
             f"kernel {fmt(t['device_ms'])}, library {fmt(t['library_device_ms'])}; bound "
             f"{t['bound_ms']:.4f} ms ({t['bound_by']}), launch floor {floor_ms:.5f} ms, "
             f"{nbytes / (t['ms'] * 1e-3) / 1e9:.1f} GB/s")
        if label == "fig3":
            dev = upd.get_device()
            fn = _build.load("weighted_aggregate", "weighted_aggregate_launch", wa_mod._ARGTYPES)
            out = torch.empty(p, device="cuda")
            args = (upd.data_ptr(), scale.data_ptr(), out.data_ptr(), m, p, 0, _build.stream(dev))
            t["host_split_us"] = host_split(torch, f"weighted_aggregate ({m}, {p}) f32", {
                "checks": lambda: wa_mod._checked(upd, scale),
                "load": lambda: _build.load("weighted_aggregate", "weighted_aggregate_launch",
                                            wa_mod._ARGTYPES),
                "output allocation": lambda: upd.new_empty(p, dtype=torch.float32),
                "stream lookup": lambda: _build.stream(dev),
                "ctypes call + launch": lambda: fn(*args),
            }, lambda: kernel(upd, scale))
        del upd
    return max_err, timings


def trim_inputs(torch, m, p, dtype, mask_kind, gen):
    """Updates on a grid of 1/2 (so that ties really occur) and a mask that
    is random (about 60 % participate), full or empty."""
    x = (torch.round(torch.randn((m, p), generator=gen, device="cuda") * 3.0) * 0.5).to(dtype)
    if mask_kind == "empty":
        mask = torch.zeros(m, device="cuda")
    elif mask_kind == "full":
        mask = torch.ones(m, device="cuda")
    else:
        mask = (torch.rand(m, generator=gen, device="cuda") < 0.6).to(torch.float32)
    return x, mask


def special_trim_inputs(torch, m, p, dtype, mask_kind, gen):
    """Values drawn from NaN, +-inf, +-0 and ties; every row holds each of
    them in its first columns; the mask random (about 60 %) or full."""
    table = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1.0, -1.0,
                          0.5, 0.5, 2.5], device="cuda")
    idx = torch.randint(0, len(table), (m, p), generator=gen, device="cuda")
    idx[:, :len(table)] = (torch.arange(m, device="cuda")[:, None]
                           + torch.arange(len(table), device="cuda")) % len(table)
    mask = torch.ones(m, device="cuda") if mask_kind == "full" else \
        (torch.rand(m, generator=gen, device="cuda") < 0.6).to(torch.float32)
    return table[idx].to(dtype), mask


def same_bits(torch, a, b):
    """Equal bit for bit, NaN where the other has NaN (any payload) and the
    sign of every zero included."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and \
        bool(torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def check_robust_trimmed(torch, gen, floor_ms):
    """Kernel against plain: the median (k = floor((n-1)/2), at most two
    kept values) bitwise; the trimmed mean (k = 0 and k between) within
    M * 2**-24 * max|x|, the rounding of any order of at most M adds
    divided by their count; on rows of NaN, +-inf, +-0 and ties the median
    bitwise, sign of zero and NaN included.  Times at the Fig. 3 shape and
    64 x (2^22 + 3): per call back to back, device time from a trace, the
    plain version, ``torch.sort`` + kept-slice mean; the host split; the
    bound at ``RANK_PAIR_OPS`` with the older ``OLD_RANK_PAIR_OPS`` beside."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import robust_agg as rt_mod
    from repro_torch.utils import roofline as rl

    kernel = rt_mod.robust_trimmed
    max_err = 0.0
    for m, p in ((20, 5674), (64, 2 ** 22 + 3)):
        for dtype in (torch.float32, torch.bfloat16):
            for mask_kind in ("random", "full", "empty"):
                x, mask = trim_inputs(torch, m, p, dtype, mask_kind, gen)
                n = mask.sum()
                n_int = int(n)
                med = max(n_int - 1, 0) // 2
                tol = m * 2.0 ** -24 * float(x.float().abs().max())
                errs = []
                for k in sorted({0, med // 2, med}):
                    kt = torch.tensor(float(k), device="cuda")
                    got = ops.robust_trimmed(x, mask, n, kt)
                    want = ref.robust_trimmed(x, mask, n, kt)
                    torch.cuda.synchronize()
                    check(got.dtype == torch.float32 and got.shape == (p,),
                          "robust_trimmed: shape/dtype")
                    err = float((got - want).abs().max())
                    if k == med:
                        check(same_bits(torch, got, want),
                              f"robust_trimmed ({m}, {p}) {dtype} {mask_kind}: median not bitwise")
                    else:
                        check(err <= tol, f"robust_trimmed ({m}, {p}) {dtype} {mask_kind} k={k}: "
                                          f"error {err} above {tol}")
                    if n_int == 0:
                        check(not bool(got.any()), "robust_trimmed: empty mask gave non-zeros")
                    errs.append(f"k={k}: {err:.1e}")
                    max_err = max(max_err, err)
                    del got, want
                line(f"  robust_trimmed ({m}, {p}) {str(dtype).split('.')[-1]} mask={mask_kind} "
                     f"n={n_int}: median bitwise, max_abs_err {', '.join(errs)} "
                     f"(bound {tol:.1e}) ok")
                del x
    for m, p in ((20, 5674), (9, 4099), (33, 4099), (64, 4099)):
        for dtype in (torch.float32, torch.bfloat16):
            for mask_kind in ("random", "full"):
                x, mask = special_trim_inputs(torch, m, p, dtype, mask_kind, gen)
                n = mask.sum()
                kt = torch.floor((n - 1.0) / 2.0).clamp_min(0.0)
                got, want = ops.robust_trimmed(x, mask, n, kt), ref.robust_trimmed(x, mask, n, kt)
                check(same_bits(torch, got, want), f"robust_trimmed special values ({m}, {p}) "
                                                   f"{dtype} {mask_kind}: median not bitwise")
                line(f"  robust_trimmed special values ({m}, {p}) {str(dtype).split('.')[-1]} "
                     f"mask={mask_kind} n={int(n)}: NaN, +-inf, +-0 and ties, median bitwise "
                     f"({int(torch.isnan(want).sum())} NaN and {int((want == 0).sum())} zeros "
                     f"in the output) ok")

    timings = {}
    for m, p, label in ((20, 5674, "fig3"), (64, 2 ** 22 + 3, "large")):
        x, mask = trim_inputs(torch, m, p, torch.float32, "full", gen)
        n = mask.sum()
        k = torch.floor((n - 1.0) / 2.0)              # the median, as on the main path
        lo, hi = (m - 1) // 2, m - (m - 1) // 2
        small = p < 10 ** 6
        call = lambda: kernel(x, mask, n, k)
        library = lambda: torch.sort(x, dim=0).values[lo:hi].mean(dim=0)
        t = dict(ms=time_ms(torch, call, 2000 if small else 20),
                 plain_ms=time_ms(torch, lambda: ref.robust_trimmed(x, mask, n, k),
                                  200 if small else 3),
                 library_ms=time_ms(torch, library, 2000 if small else 10))
        turns = turns_ms(torch, {"kernel": call, "library": library}, 2000 if small else 10)
        t.update(turns_ms=turns["kernel"], library_turns_ms=turns["library"],
                 device_ms=device_ms(torch, call, 100 if small else 10),
                 library_device_ms=device_ms(torch, library, 100 if small else 10))
        same = bool(torch.equal(library(), kernel(x, mask, n, k)))
        nbytes = m * p * 4 + m * 4 + 8 + p * 4
        pairs = m * m * p                              # every row participates
        t["bound_ms"], t["bound_by"] = bound_of(rt_mod.cost((m, p), 4))
        old_bound = rl.KernelCost(OLD_RANK_PAIR_OPS * pairs, nbytes, rl.PEAK_LANE_OPS_F32).bound_ms
        timings[label] = t
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        each = lambda xs: " / ".join(f"{x:.4f}" for x in xs)
        line(f"  robust_trimmed time {label} ({m}, {p}) f32 median: kernel {t['ms']:.4f} ms, "
             f"plain {t['plain_ms']:.4f} ms, library (sort + kept-slice mean) "
             f"{t['library_ms']:.4f} ms (equal to the kernel: {same}), per call back to back, "
             f"one window each; interleaved turns: kernel {each(t['turns_ms'])}, library "
             f"{each(t['library_turns_ms'])}; "
             f"device time: kernel {fmt(t['device_ms'])}, library {fmt(t['library_device_ms'])}; "
             f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {pairs:.3e} ordered pairs x "
             f"{RANK_PAIR_OPS} instruction / {rl.PEAK_LANE_OPS_F32:.3g} lane instructions/s; "
             f"bytes {nbytes / rl.HBM_BW * 1e3:.2e} ms), the older {OLD_RANK_PAIR_OPS}-op bound "
             f"{old_bound:.4f} ms, launch floor {floor_ms:.5f} ms, "
             f"{pairs / (t['ms'] * 1e-3) / 1e12:.2f} T pairs/s")
        if label == "fig3":
            dev = x.get_device()
            fn = _build.load("robust_trimmed", "robust_trimmed_launch", rt_mod._ARGTYPES)
            out = torch.empty(p, device="cuda")
            args = (x.data_ptr(), mask.data_ptr(), n.data_ptr(), k.data_ptr(), out.data_ptr(),
                    m, p, 0, _build.stream(dev))
            t["host_split_us"] = host_split(torch, f"robust_trimmed ({m}, {p}) f32", {
                "checks": lambda: rt_mod._checked(x, mask, n, k),
                "load": lambda: _build.load("robust_trimmed", "robust_trimmed_launch",
                                            rt_mod._ARGTYPES),
                "output allocation": lambda: x.new_empty(p, dtype=torch.float32),
                "stream lookup": lambda: _build.stream(dev),
                "ctypes call + launch": lambda: fn(*args),
            }, lambda: kernel(x, mask, n, k))
        del x
    return max_err, timings


def check_batched_aggregation(torch, gen, floor_ms):
    """Phase 2's batch forms of the two Step-4 kernels (a run axis on the
    grid, one launch for B runs): each batch against its plain version and,
    row by row, bit for bit against the single-run kernel on that run.
    ``weighted_aggregate`` at (8, 20, 5674) f32 and bf16, (8, 64, 2^21)
    (the bytes of phase 2's 64 x 2^24) and (5, 7, 4099) (4-byte loads);
    ``robust_trimmed`` at (8, 20, 5674) with a mask, n and k a run (n = 0,
    odd and even n; the median, 0 and between), on rows of NaN, +-inf, +-0
    and ties, and at (8, 64, 2^19 + 3).  Times at (8, 20, 5674) and the
    large shape: the batch launch, the plain version, the eight single-run
    launches it replaces, the bound, and the library call (``torch.bmm``;
    ``torch.sort`` + the kept slice's mean).  Returns ({kernel: the
    kernels line's ``batch`` dict})."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import robust_agg as rt_mod
    from repro_torch.kernels import weighted_aggregate as wa_mod

    wa, rt = wa_mod.weighted_aggregate, rt_mod.robust_trimmed
    out = {}

    # weighted_aggregate: (B, M, P) updates, (B, M) scales
    wa_err, wa_rows = 0.0, True
    for b, m, p, dtype in ((8, 20, 5674, torch.float32), (8, 20, 5674, torch.bfloat16),
                           (8, 64, 2 ** 21, torch.float32), (5, 7, 4099, torch.float32)):
        upd = torch.randn((b, m, p), generator=gen, device="cuda").to(dtype)
        scale = torch.stack([scale_like_main_path(torch, m, gen) for _ in range(b)])
        before = wa.batch_launches
        got = wa(upd, scale)
        check(wa.batch_launches == before + 1, "weighted_aggregate batch: not one batch launch")
        want = ref.weighted_aggregate(upd, scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(got.shape == (b, p) and torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"weighted_aggregate batch ({b}, {m}, {p}) {dtype}: beyond rtol 1e-5 ({err})")
        rows = all(bool(torch.equal(got[i], wa(upd[i], scale[i]))) for i in range(b))
        check(rows, f"weighted_aggregate batch ({b}, {m}, {p}) {dtype}: a row is not the "
                    "single-run kernel's bit for bit")
        wa_err, wa_rows = max(wa_err, err), wa_rows and rows
        line(f"  weighted_aggregate batch ({b}, {m}, {p}) {str(dtype).split('.')[-1]}: one "
             f"launch, max_abs_err={err:.3e} vs plain, every row bitwise the single-run "
             f"kernel's ok")
        del upd, got, want

    def wa_times(b, m, p, iters):
        upd = torch.randn((b, m, p), generator=gen, device="cuda")
        scale = torch.stack([scale_like_main_path(torch, m, gen) for _ in range(b)])
        t = dict(shape=[b, m, p], ms=time_ms(torch, lambda: wa(upd, scale), iters),
                 plain_ms=time_ms(torch, lambda: ref.weighted_aggregate(upd, scale), iters),
                 single_loop_ms=time_ms(torch, lambda: [wa(upd[i], scale[i]) for i in range(b)],
                                        iters),
                 library_ms=time_ms(torch, lambda: torch.bmm(scale[:, None, :], upd), iters),
                 device_ms=device_ms(torch, lambda: wa(upd, scale), 100 if iters > 100 else 10))
        t["bound_ms"], t["bound_by"] = bound_of(wa_mod.cost((b, m, p), 4))
        line(f"  weighted_aggregate batch time ({b}, {m}, {p}) f32: batch launch {t['ms']:.4f} "
             f"ms, the {b} single-run launches it replaces {t['single_loop_ms']:.4f} ms, plain "
             f"{t['plain_ms']:.4f} ms, library (torch.bmm) {t['library_ms']:.4f} ms, device "
             f"time {'not measured' if t['device_ms'] is None else '%.4f ms' % t['device_ms']}, "
             f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), launch floor {floor_ms:.5f} ms")
        return t

    fig3 = wa_times(8, 20, 5674, 2000)
    out["weighted_aggregate"] = dict(fig3, max_abs_err=wa_err, rows_bitwise=wa_rows,
                                     large=wa_times(8, 64, 2 ** 21, 20))

    # robust_trimmed: a mask, n and k a run
    rt_err, rt_rows = 0.0, True
    cases = [(8, 20, 5674, "random"), (8, 20, 5674, "special"), (8, 64, 2 ** 19 + 3, "random")]
    for b, m, p, kind in cases:
        if kind == "special":
            pairs = [special_trim_inputs(torch, m, p, torch.float32, "random", gen)
                     for _ in range(b)]
        else:
            pairs = [trim_inputs(torch, m, p, torch.float32, "random", gen) for _ in range(b)]
        x = torch.stack([xx for xx, _ in pairs])
        mask = torch.stack([mm for _, mm in pairs])
        mask[0] = 0.0                                   # run 0: nobody participates
        mask[1, :] = 1.0
        mask[1, 0] = 0.0                                # run 1: n = M - 1 (odd M - 1)
        mask[2, :] = 1.0                                # run 2: n = M (even)
        n = mask.sum(-1)
        med = torch.floor((n - 1.0) / 2.0).clamp_min(0.0)
        k = med.clone()
        if kind != "special":
            k[3::3] = 0.0
            k[4::3] = torch.floor(med[4::3] / 2.0)
        before = rt.batch_launches
        got = rt(x, mask, n, k)
        check(rt.batch_launches == before + 1, "robust_trimmed batch: not one batch launch")
        want = ref.robust_trimmed(x, mask, n, k)
        torch.cuda.synchronize()
        median_rows = (k == med).tolist()
        for i in range(b):
            if median_rows[i]:
                check(same_bits(torch, got[i], want[i]),
                      f"robust_trimmed batch ({b}, {m}, {p}) {kind} run {i}: median not bitwise")
            else:
                tol = m * 2.0 ** -24 * float(x[i].abs().max())
                check(float((got[i] - want[i]).abs().max()) <= tol,
                      f"robust_trimmed batch ({b}, {m}, {p}) run {i}: beyond {tol}")
        check(not bool(got[0].any()), "robust_trimmed batch: n = 0 gave non-zeros")
        rows = all(same_bits(torch, got[i], rt(x[i], mask[i], n[i:i + 1], k[i:i + 1]))
                   for i in range(b))
        check(rows, f"robust_trimmed batch ({b}, {m}, {p}) {kind}: a row is not the single-run "
                    "kernel's bit for bit")
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
        rt_err, rt_rows = max(rt_err, err), rt_rows and rows
        line(f"  robust_trimmed batch ({b}, {m}, {p}) {kind}: one launch, n a run "
             f"{[int(v) for v in n.tolist()]}, k {[int(v) for v in k.tolist()]}; medians bitwise, "
             f"max_abs_err {err:.1e}, every row bitwise the single-run kernel's ok")
        del x, got, want

    def rt_times(b, m, p, iters):
        pairs = [trim_inputs(torch, m, p, torch.float32, "full", gen) for _ in range(b)]
        x = torch.stack([xx for xx, _ in pairs])
        mask = torch.stack([mm for _, mm in pairs])
        n = mask.sum(-1)
        k = torch.floor((n - 1.0) / 2.0)
        lo, hi = (m - 1) // 2, m - (m - 1) // 2
        small = p < 10 ** 6
        t = dict(shape=[b, m, p], ms=time_ms(torch, lambda: rt(x, mask, n, k), iters),
                 plain_ms=time_ms(torch, lambda: ref.robust_trimmed(x, mask, n, k),
                                  max(iters // 10, 3)),
                 single_loop_ms=time_ms(torch, lambda: [rt(x[i], mask[i], n[i:i + 1],
                                                           k[i:i + 1]) for i in range(b)],
                                        iters),
                 library_ms=time_ms(torch, lambda: torch.sort(x, dim=1).values[:, lo:hi]
                                    .mean(dim=1), iters),
                 device_ms=device_ms(torch, lambda: rt(x, mask, n, k), 100 if small else 10))
        pairs_n = b * m * m * p
        t["bound_ms"], t["bound_by"] = bound_of(rt_mod.cost((b, m, p), 4))
        line(f"  robust_trimmed batch time ({b}, {m}, {p}) f32 median: batch launch "
             f"{t['ms']:.4f} ms, the {b} single-run launches it replaces "
             f"{t['single_loop_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library (sort + "
             f"kept-slice mean) {t['library_ms']:.4f} ms, device time "
             f"{'not measured' if t['device_ms'] is None else '%.4f ms' % t['device_ms']}, bound "
             f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {pairs_n:.3e} ordered pairs x "
             f"{RANK_PAIR_OPS} instruction), launch floor {floor_ms:.5f} ms")
        return t

    fig3 = rt_times(8, 20, 5674, 2000)
    out["robust_trimmed"] = dict(fig3, max_abs_err=rt_err, rows_bitwise=rt_rows,
                                 large=rt_times(8, 64, 2 ** 19 + 3, 10))
    return out


def check_glr_scan(torch, gen, floor_ms):
    """Kernel against plain: bitwise on {0, 1} histories (exact integer
    prefixes).  On real-valued ones the kernel rounds each prefix and the
    window total once from an f64 scan, and its statistic must land inside
    ``ref.glr_scan_bounds``: the split term's derived forward error around
    the exact statistic (per row, the max over splits of value +- bound)."""
    from repro_torch.kernels import glr_scan as gsc_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.glr_scan import glr_scan as kernel

    def inputs(n, h, binary, full=False):
        hist = (torch.randint(0, 2, (n, h), generator=gen, device="cuda").to(torch.float32)
                if binary else torch.rand((n, h), generator=gen, device="cuda"))
        if full:
            return hist, torch.full((n,), h, dtype=torch.int32, device="cuda")
        counts = torch.randint(0, h + 1, (n,), generator=gen, device="cuda").to(torch.int32)
        counts[:3] = torch.tensor([0, 1, h], device="cuda")[:n]
        return hist, counts

    max_err = 0.0
    for n, h in ((5, 1024), (30, 256), (1000, 1000)):
        for binary in (True, False):
            hist, counts = inputs(n, h, binary)
            got, want = ops.glr_scan(hist, counts), ref.glr_scan(hist, counts)
            torch.cuda.synchronize()
            check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
                  f"glr_scan ({n}, {h}): -inf at other places")
            fin = torch.isfinite(want)
            check(torch.equal(fin, torch.isfinite(got)), f"glr_scan ({n}, {h}): non-finite stat")
            err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
            if binary:
                check(torch.equal(got, want), f"glr_scan ({n}, {h}) {{0,1}}: not bitwise ({err})")
                how = "bitwise"
            else:
                exact = ref.glr_scan(hist.double(), counts)[fin].cpu()
                lo, hi = (b[fin.cpu()] for b in ref.glr_scan_bounds(hist.cpu(), counts.cpu()))
                k64 = got[fin].double().cpu()
                inside = (k64 >= lo) & (k64 <= hi)
                half = (hi - lo) / 2
                share = float(((k64 - exact).abs() / half).max())
                check(bool(inside.all()), f"glr_scan ({n}, {h}) real: {int((~inside).sum())} rows "
                                          f"outside the derived bound ({share:.3f} of its half-width)")
                e_plain = float((want[fin].double().cpu() - exact).abs().max())
                how = (f"inside the derived bound (kernel's error vs f64 at most {share:.3f} of the "
                       f"bound's half-width, max half-width {float(half.max()):.3e}; plain f32's "
                       f"error {e_plain:.3e})")
            max_err = max(max_err, err)
            line(f"  glr_scan ({n}, {h}) history={'{0,1}' if binary else 'U[0,1]'}: "
                 f"{how}, max_abs_err={err:.3e} ok")

    timings = {}
    for (n, h), label in (((5, 1024), "fig2"), ((30, 256), "fig3")):
        hist, counts = inputs(n, h, True, full=True)   # the steady state: full windows
        ms = time_ms(torch, lambda: kernel(hist, counts), 2000)
        plain_ms = time_ms(torch, lambda: ref.glr_scan(hist, counts), 200)
        bound, bound_by = bound_of(gsc_mod.cost(n, h))     # full windows: n (h - 1) splits
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)
        line(f"  glr_scan time {label} ({n}, {h}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
             f"bound {bound:.2e} ms ({bound_by}), launch floor {floor_ms:.5f} ms, "
             f"per call back to back")
    return max_err, timings


def scan_tenants_inputs(torch, r, b, n, h, frac_detect, pad, gen, binary=True):
    """A recompute serve step's operands for the tenant ``glr_scan``: slot
    history (R, N, H), B distinct slots of which the last ``pad`` are
    padding rows on the scratch slot R - 1 (not detecting), ``frac_detect``
    of the rows detecting (at least one), counts in [0, H] with the edges
    0, 1, 2 and H."""
    dev = "cuda"
    hist = (torch.randint(0, 2, (r, n, h), generator=gen, device=dev).to(torch.float32)
            if binary else torch.rand((r, n, h), generator=gen, device=dev))
    counts = torch.randint(0, h + 1, (b, n), generator=gen, device=dev).to(torch.int32)
    counts.view(-1)[:4] = torch.tensor([0, 1, min(2, h), h], device=dev)[: counts.numel()]
    slots = torch.randperm(r - 1 if r > b else r, generator=gen, device=dev)[:b].to(torch.int32)
    detect = torch.rand(b, generator=gen, device=dev) < frac_detect
    detect[0] = True
    if pad:
        slots[-pad:] = r - 1
        detect[-pad:] = False
    return hist, slots, detect, counts


def scan_tenants_bound_ms(torch, args):
    """The least time of one tenant ``glr_scan`` call on these inputs: the
    samples the detecting rows count read once (a row reads only its first
    ``counts`` of H), counts, slots and flags read and the statistics
    written, over HBM; or the split operations (32 a split over this run's
    splits) and the two scans' adds over those samples, over the f32 rate.
    Returns (bound ms, bound_by, the split count)."""
    from repro_torch.kernels import glr_scan

    hist, slots, detect, counts = args
    h = hist.shape[2]
    valid = counts[detect].clamp(min=0, max=h)
    samples = int(valid.sum())
    splits = int((valid - 1).clamp(min=0).sum())
    bound, bound_by = bound_of(glr_scan.tenants_cost(counts.shape[1], h, slots.numel(), samples,
                                                     splits))
    return bound, bound_by, splits


def check_glr_scan_tenants(torch, gen, floor_ms):
    """The recompute detector's serving kernel (``glr_scan``'s tenant entry,
    in place on the slot history) against ``ref.glr_scan_tenants`` on the
    same inputs: bitwise on {0, 1} histories; on U[0, 1] ones bitwise the
    single-run kernel on the gathered rows and inside ``ref.glr_scan_bounds``;
    -inf on every row not detecting; the history never written.  At the
    serving shapes (R = 257 / B = 64, N = 16, H = 256, 10 of 64 and all 64
    rows detecting, padding rows; R = 10001 / B = 64, H = 64) and at H = 33
    and 130.  Times per call back to back, device time from a trace, the
    plain version, the bound (bytes, split operations); at the serving
    shape the host split of a call."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import glr_scan as gsc_mod

    kernel, single = gsc_mod.glr_scan_tenants, gsc_mod.glr_scan
    cases = {"serve": (257, 64, 16, 256, 10 / 64, 5), "all": (257, 64, 16, 256, 1.0, 0),
             "big": (10001, 64, 16, 64, 10 / 64, 3), "h33": (20, 12, 5, 33, 0.6, 2),
             "h130": (20, 12, 5, 130, 0.6, 2)}
    max_err = 0.0
    for label, (r, b, n, h, frac, pad) in cases.items():
        for binary in (True, False):
            args = scan_tenants_inputs(torch, r, b, n, h, frac, pad, gen, binary)
            hist, slots, detect, counts = args
            before = hist.clone()
            got = ops.glr_scan_tenants(*args)
            want = ref.glr_scan_tenants(*args)
            torch.cuda.synchronize()
            where = f"glr_scan_tenants ({r}, {b}, {n}, {h})"
            check(torch.equal(hist, before), f"{where}: the history was written")
            check(bool(torch.isneginf(got[~detect]).all()), f"{where}: a row not detecting "
                  "has a statistic")
            check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
                  f"{where}: -inf at other places")
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
            if binary:
                check(torch.equal(got, want), f"{where} {{0,1}}: not bitwise ({err})")
                how = "bitwise the plain version"
            else:
                rows = hist.index_select(0, slots.long())[detect].reshape(-1, h)
                one = single(rows.contiguous(), counts[detect].reshape(-1).contiguous())
                check(torch.equal(got[detect].reshape(-1), one),
                      f"{where} real: not bitwise the single-run kernel on the gathered rows")
                lo, hi = (x.reshape(-1, n)[detect.cpu()] for x in ref.glr_scan_bounds(
                    hist.index_select(0, slots.long()).reshape(-1, h).cpu(),
                    counts.reshape(-1).cpu()))
                k64 = got[detect].double().cpu()
                ok = torch.isneginf(k64) | ((k64 >= lo) & (k64 <= hi))
                check(bool(ok.all()), f"{where} real: {int((~ok).sum())} rows outside the "
                                      "derived bound")
                how = "bitwise the single-run kernel, inside the derived bound"
            # the plain version on the CPU (its own logf) is no bitwise
            # reference for the card: how far the kernel lands from it
            cpu_want = ref.glr_scan_tenants(*(a.cpu() for a in args))
            both = fin.cpu() & torch.isfinite(cpu_want)
            gap = (got.cpu() - cpu_want)[both].abs()
            max_err = max(max_err, err)
            line(f"  {where} history={'{0,1}' if binary else 'U[0,1]'}: "
                 f"{int(detect.sum())}/{b} rows detecting, {how}, history untouched, "
                 f"max_abs_err vs plain={err:.3e} ok; against the plain version on the CPU "
                 f"{int((gap > 0).sum())} of {int(both.sum())} statistics differ, max "
                 f"{float(gap.max()) if gap.numel() else 0.0:.3e}")

    timings = {}
    for label in ("serve", "all", "big"):
        r, b, n, h, frac, pad = cases[label]
        args = scan_tenants_inputs(torch, r, b, n, h, frac, 0, gen, True)
        hist, slots, detect, counts = args
        call = lambda: kernel(hist, slots, detect, counts)
        bound, bound_by, splits = scan_tenants_bound_ms(torch, args)
        t = dict(ms=time_ms(torch, call, 2000),
                 plain_ms=time_ms(torch, lambda: ref.glr_scan_tenants(*args), 50),
                 device_ms=device_ms(torch, call, 100), library_ms=None, bound_ms=bound,
                 bound_by=bound_by, splits=splits, detecting_rows=int(detect.sum()))
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        line(f"  glr_scan_tenants time {label} ({r}, {b}, {n}, {h}), {t['detecting_rows']}/{b} "
             f"rows detecting: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, per call "
             f"back to back, one window each; device time {fmt(t['device_ms'])}; bound "
             f"{bound:.2e} ms ({bound_by}; {splits} splits); launch floor {floor_ms:.5f} ms")
        if label == "serve":
            dev = hist.get_device()
            fn = _build.load("glr_scan", "glr_scan_tenants_launch", gsc_mod._TENANTS_ARGTYPES)
            out = torch.empty((b, n), device="cuda")
            ptrs = (hist.data_ptr(), slots.data_ptr(), detect.data_ptr(), counts.data_ptr(),
                    out.data_ptr(), b, n, h, _build.stream(dev))
            t["host_split_us"] = host_split(torch, f"glr_scan_tenants ({r}, {b}, {n}, {h})", {
                "checks": lambda: gsc_mod._tenants_checked(hist, slots, detect, counts),
                "load": lambda: _build.load("glr_scan", "glr_scan_tenants_launch",
                                            gsc_mod._TENANTS_ARGTYPES),
                "output allocation": lambda: torch.empty((b, n), dtype=torch.float32,
                                                         device=hist.device),
                "stream lookup": lambda: _build.stream(dev),
                "ctypes call + launch": lambda: fn(*ptrs),
            }, call)
        timings[label] = t
        del args, hist
    return max_err, timings


def attn_pairs(s, causal, window):
    """(query, key) pairs the mask lets through: the work of a prefill
    (``flash_attention.pairs``, which its ``cost`` counts)."""
    from repro_torch.kernels.flash_attention import pairs

    return pairs(s, causal, window)


def attn_bound_ms(torch, shape, causal, window, dtype):
    """The least time of one attention call (``flash_attention.cost``): 4 D
    flops a visible pair (q.k and p.v) over the dtype's rate, or q, k, v
    read and the output written once over HBM bandwidth, whichever is
    larger."""
    from repro_torch.kernels import flash_attention

    return bound_of(flash_attention.cost(shape, causal, window, dtype))


def routes_in_turns(torch, q, k, v, window, tc_iters):
    """Both ``flash_attention`` routes on the same bf16 inputs, causal,
    timed in turns: tensor-core (``tc_iters`` calls), FMA (10), tensor-core
    again.  Returns ``ms``, ``fma_ms`` and ``ms_again``; counts nothing."""
    from repro_torch.kernels import flash_attention as fa_mod

    scale = 1.0 / q.shape[-1] ** 0.5
    tc_fn = lambda: fa_mod._launch("tensor-core", q, k, v, True, window, scale)
    ms = time_ms(torch, tc_fn, tc_iters)
    fma_ms = time_ms(torch, lambda: fa_mod._launch("FMA", q, k, v, True, window, scale), 10)
    return dict(ms=ms, fma_ms=fma_ms, ms_again=time_ms(torch, tc_fn, tc_iters))


def check_flash_attention(torch, gen, floor_ms):
    """Kernel against plain: f32 within rtol/atol 1e-4 of the f32 plain
    version (another order of the D-term sums, an online softmax); bf16
    within rtol 2**-8 / atol 1e-4 of the plain version on the same inputs in
    f32 (the output's one rounding to bf16 is at most 2**-9 relative; the
    tensor-core route splits P into two bf16 terms to stay inside it).
    Every case checks which route launched: bf16 with D % 8 == 0 up to
    D = 256 on the tensor cores (64-key tiles past D = 128), the rest on
    the FMA route.  Times at the JAX package's
    test shapes (f32) and at qwen3-32b's prefill shape: bf16 on both routes,
    f32, the plain version and SDPA."""
    from torch.nn import functional as F

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.utils import roofline as rl

    kernel = fa_mod.flash_attention

    def inputs(shape, dtype):
        b, hq, hkv, s, d = shape
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda") * 0.5
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda") * 0.5
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda")
        return q.to(dtype), k.to(dtype), v.to(dtype)

    jax_shapes = [((1, 2, 2, 128, 64), True, 0), ((2, 4, 2, 257, 72), True, 0),
                  ((1, 4, 1, 200, 128), False, 0), ((1, 2, 2, 300, 64), True, 64),
                  ((2, 8, 4, 64, 96), True, 16)]       # tests/test_kernels.py:155-159
    model = (4, 64, 8, SERVE_PROMPT, 128)              # qwen3-32b, 4 prompts of 2048
    cases = [(s, c, w, dt) for dt in (torch.float32, torch.bfloat16) for s, c, w in jax_shapes] + [
        (model, True, 0, torch.bfloat16), (model, True, 0, torch.float32),
        ((1, 64, 8, SERVE_PROMPT, 128), True, 1024, torch.bfloat16),   # a window
        ((1, 8, 2, 300, 128), True, 8, torch.float32),  # windows inside one tile
        ((1, 8, 2, 300, 128), True, 8, torch.bfloat16),
        ((1, 8, 2, 300, 32), True, 16, torch.bfloat16),
        ((1, 64, 8, SERVE_PROMPT, 128), False, 0, torch.float32),      # encoder-style
        ((1, 4, 2, 300, 200), True, 0, torch.bfloat16),    # tensor cores, D padded to 256
        ((1, 4, 2, 300, 196), True, 0, torch.bfloat16),                # bf16 on the FMA route
        ((1, 4, 2, 300, 128), False, 40, torch.bfloat16),   # non-causal window, tensor cores
        ((1, 4, 1, 4096, 256), True, RGEMMA_WINDOW, torch.bfloat16),   # tiles left of the window
    ] + [((1, 4, 2, 300, d), True, 0, dt, sc)    # a scale of either sign, and 0
         for d in (64, 256) for dt in (torch.bfloat16, torch.float32) for sc in (-0.1, 0.0)]
    max_err = 0.0
    for shape, causal, window, dtype, *opt in cases:
        scale = opt[0] if opt else None
        q, k, v = inputs(shape, dtype)
        tc = fa_mod.tc_route(dtype, shape[4])
        before = (kernel.tc_launches, kernel.fma_launches)
        got = ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
        want = ref.mha_attention(q.float(), k.float(), v.float(), causal=causal, window=window,
                                 scale=scale)
        torch.cuda.synchronize()
        check((kernel.tc_launches, kernel.fma_launches) == (before[0] + tc, before[1] + (not tc)),
              f"flash_attention {shape} {dtype}: not on the {'tensor-core' if tc else 'FMA'} route")
        check(got.dtype == dtype and got.shape == q.shape, f"flash_attention {shape}: shape/dtype")
        err = float((got.float() - want).abs().max())
        if dtype == torch.float32:
            ok, tol = torch.allclose(got, want, rtol=1e-4, atol=1e-4), "rtol/atol 1e-4 vs f32 plain"
        else:
            ok = torch.allclose(got.float(), want, rtol=2.0 ** -8, atol=1e-4)
            tol = "rtol 2^-8 atol 1e-4 vs f32 plain"
        at = f"causal={causal} window={window}" + (f" scale={scale}" if opt else "")
        check(ok, f"flash_attention {shape} {at} {dtype}: beyond {tol} (max err {err:.3e})")
        max_err = max(max_err, err)
        line(f"  flash_attention (B, Hq, Hkv, S, D)={shape} {at} "
             f"{str(dtype).split('.')[-1]} {'tensor-core' if tc else 'FMA'} route: "
             f"max_abs_err={err:.3e} ({tol}) ok")
        del q, k, v, got, want

    timings = {"jax_shapes": []}
    for shape, causal, window in jax_shapes:
        q, k, v = inputs(shape, torch.float32)
        ms = time_ms(torch, lambda: kernel(q, k, v, causal=causal, window=window), 200)
        plain_ms = time_ms(torch, lambda: ref.mha_attention(q, k, v, causal=causal,
                                                            window=window), 50)
        bound, bound_by = attn_bound_ms(torch, shape, causal, window, torch.float32)
        timings["jax_shapes"].append(dict(shape=list(shape), causal=causal, window=window,
                                          ms=ms, plain_ms=plain_ms, bound_ms=bound))
        line(f"  flash_attention time {shape} f32 causal={causal} window={window}: "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.2e} ms ({bound_by}, "
             f"f32 rate), launch floor {floor_ms:.5f} ms")
    flops = 4 * model[0] * model[1] * model[4] * attn_pairs(model[3], True, 0)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = inputs(model, dtype)
        rate = rl.PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else rl.PEAK_FLOPS_F32
        bound, bound_by = attn_bound_ms(torch, model, True, 0, dtype)
        t = dict(bound_ms=bound, bound_by=bound_by)
        if dtype == torch.bfloat16:
            t.update(routes_in_turns(torch, q, k, v, 0, 50))
        else:
            t["ms"] = time_ms(torch, lambda: kernel(q, k, v, causal=True), 10)
        t["plain_ms"] = time_ms(torch, lambda: ref.mha_attention(q, k, v, causal=True), 3)
        t["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20)
        label = "model" if dtype == torch.bfloat16 else "model_f32"
        timings[label] = t
        if dtype == torch.bfloat16:
            split_ms = 1.5 * flops / rl.PEAK_FLOPS_BF16 * 1e3
            line(f"  flash_attention time qwen3-32b prefill {model} causal bf16: tensor-core "
                 f"route {t['ms']:.4f} / {t['ms_again']:.4f} ms ({flops / t['ms'] / 1e9:.1f} "
                 f"TFLOP/s of attention), FMA route "
                 f"{t['fma_ms']:.4f} ms ({flops / t['fma_ms'] / 1e9:.1f} TFLOP/s), plain "
                 f"{t['plain_ms']:.4f} ms, library (SDPA, enable_gqa) {t['library_ms']:.4f} ms, "
                 f"bound {bound:.4f} ms ({bound_by} at {rate / 1e12:.0f} TFLOP/s), split-P "
                 f"ceiling {split_ms:.4f} ms (1.5x the products)")
        else:
            line(f"  flash_attention time qwen3-32b prefill {model} causal f32: FMA route "
                 f"{t['ms']:.4f} ms ({flops / t['ms'] / 1e9:.1f} TFLOP/s), plain "
                 f"{t['plain_ms']:.4f} ms, library (SDPA, enable_gqa) {t['library_ms']:.4f} ms, "
                 f"bound {bound:.4f} ms ({bound_by} at {rate / 1e12:.0f} TFLOP/s)")
        del q, k, v
    return max_err, timings


# ---------------------------------------------------------------------------
# the Fig. 2 harness's two routes: one regret_scan launch against the rounds
# ---------------------------------------------------------------------------

STATE_FIELDS = ("mu_tilde", "counts", "tau", "hist", "restarts", "cum", "total", "base")
BITWISE_OUT = ("channels", "restarts", "regret", "final_regret", "aoi_pi", "aoi_star",
               "success_rate")
VAR_OUT = ("cum_aoi_var", "final_cum_aoi_var", "oracle_cum_aoi_var")


def compare_routes(torch, a, b, label):
    """Two runs of the harness: schedule, restarts, regret, AoI, success rate
    and the final GLR-CUCB state bit for bit; the variance sums at rtol 1e-6
    (the kernel adds the M squared deviations in another order than torch's
    reduction: equal bits for M <= 2).  Returns the variance sums' largest
    absolute difference."""
    for k in BITWISE_OUT:
        check(torch.equal(a[k], b[k]), f"{label}: {k} not bitwise equal")
    sa, sb = a["final_sched_state"], b["final_sched_state"]
    for f in STATE_FIELDS:
        check(torch.equal(getattr(sa, f), getattr(sb, f)), f"{label}: final state {f} differs")
    for k in VAR_OUT:
        check(torch.allclose(a[k], b[k], rtol=1e-6, atol=0), f"{label}: {k} beyond rtol 1e-6")
    return max(float((a[k] - b[k]).abs().max()) for k in VAR_OUT)


def scan_edge_cases(seed, device, rounds):
    """Short runs at the kernel's edges: (label, GLRCUCB, env).  The envs
    alternate each channel's mean between two values every 250 rounds, so
    the detectors restart several times; the last two are reactive (the
    flipping means as the base table)."""
    import numpy as np

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import (dense_means, make_piecewise, make_stationary,
                                           reactive_env, table_env)

    rng = np.random.default_rng(seed)

    def flipping(n):
        a = rng.random(n).astype(np.float32)
        segs = -(-rounds // 250)
        means = np.stack([a if s % 2 == 0 else 1.0 - a for s in range(segs)])
        return make_piecewise(means, [250 * s for s in range(1, segs)], device=device)

    table = np.repeat(flipping(5).means.cpu().numpy(), 250, axis=0)[:rounds]
    table = table + rng.uniform(-0.05, 0.05, table.shape).astype(np.float32)
    fast = dict(delta=0.1, min_samples=4)
    return [
        ("table", GLRCUCB(5, 2, history=64, detector_stride=5, **fast),
         table_env(table.clip(0.0, 1.0), device=device)),
        ("stationary S=1", GLRCUCB(5, 2, history=1024, detector_stride=5),
         make_stationary(rng.random(5).astype(np.float32), device=device)),
        ("alpha=0.2", GLRCUCB(5, 2, history=64, detector_stride=5, alpha=0.2, **fast), flipping(5)),
        ("geometric", GLRCUCB(5, 2, history=256, split_grid="geometric", **fast), flipping(5)),
        ("H=33 restarts", GLRCUCB(5, 2, history=33, **fast), flipping(5)),
        ("N=30 M=20 H=256 stride 1", GLRCUCB(30, 20, history=256, **fast), flipping(30)),
        ("N=32 M=8 H=1024", GLRCUCB(32, 8, history=1024, detector_stride=5, **fast), flipping(32)),
        ("stride 1e9 (cucb-static)", GLRCUCB(5, 2, history=64, detector_stride=10**9), flipping(5)),
        ("recompute H=33", GLRCUCB(5, 2, history=33, detector_impl="recompute", **fast),
         flipping(5)),
    ] + [   # the reactive template on every lane, full suppression, decay at both ends
        (f"reactive N=32 M=8 gain 1 sharp 16 decay {d}",
         GLRCUCB(32, 8, history=256, detector_stride=5, **fast),
         reactive_env(dense_means(flipping(32), rounds), d, 1.0, 0.3, 16.0, device=device))
        for d in (0.0, 1.0)]


def check_regret_scan(torch, seed):
    """Phase 2: the scan kernel against the per-round route on short edge
    runs; the streaming rounds with ``detector_backend="torch"`` (every op a
    plain one on the card), the recompute rounds through ``glr_scan``."""
    import dataclasses

    from repro_torch.core.regret import simulate_aoi_regret
    from repro_torch.kernels.regret_scan import regret_scan

    rounds = SCAN_EDGE_ROUNDS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for label, sched, env in scan_edge_cases(seed, "cuda", rounds):
        u = torch.rand((rounds, 2, sched.n_channels), generator=gen, device="cuda")
        before = regret_scan.launches, regret_scan.reactive_launches
        scan = simulate_aoi_regret(sched, env, rounds, uniforms=u, return_state=True, impl="scan")
        check((regret_scan.launches, regret_scan.reactive_launches)
              == (before[0] + 1, before[1] + (env.form == "reactive")),
              f"regret_scan {label}: no launch of its template")
        before = before[0]
        plain = sched if sched.detector_impl == "recompute" else \
            dataclasses.replace(sched, detector_backend="torch")
        rounds_out = simulate_aoi_regret(plain, env, rounds, uniforms=u, return_state=True,
                                         impl="rounds")
        check(regret_scan.launches == before + 1,
              f"regret_scan {label}: the rounds route launched it")
        torch.cuda.synchronize()
        compare_routes(torch, scan, rounds_out, f"regret_scan {label}")
        line(f"  regret_scan {label}: T={rounds} restarts={int(scan['restarts'])} "
             f"regret={float(scan['final_regret']):.0f}, equal to the rounds route ok")


def flipping_env(rng, n, rounds, device):
    """A piecewise env whose channel means alternate between two draws every
    250 rounds (the detectors restart several times)."""
    from repro_torch.core.channels import make_piecewise

    import numpy as np

    a = rng.random(n).astype(np.float32)
    segs = -(-rounds // 250)
    means = np.stack([a if s % 2 == 0 else 1.0 - a for s in range(segs)])
    return make_piecewise(means, [250 * s for s in range(1, segs)], device=device)


def check_regret_scan_batch(torch, seed):
    """Phase 2: the scan with a run axis against its plain version, the
    batched per-round loop, at two batches: B = 24 runs of their own envs
    and uniforms (streaming; the plain detector on the rounds), and B = 133
    runs (more than one wave of the card's blocks) sharing one env and one
    stream with a per-run gamma x delta grid (recompute).  Returns the
    variance sums' largest absolute difference."""
    import dataclasses

    import numpy as np

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.bandits.base import stack_params
    from repro_torch.core.channels import stack_envs
    from repro_torch.kernels.regret_scan import regret_scan
    from repro_torch.sim import simulate_aoi_regret_batch

    rounds, err = SCAN_EDGE_ROUNDS, 0.0
    rng = np.random.default_rng(seed + 33)
    gen = torch.Generator(device="cuda").manual_seed(seed + 33)
    fast = dict(delta=0.1, min_samples=4)
    for label, b, shared, impl in (("B=24 own envs", 24, False, "streaming"),
                                   ("B=133 shared env, hp grid", 133, True, "recompute")):
        sched = GLRCUCB(5, 2, history=64, detector_stride=5, detector_impl=impl, **fast)
        if shared:
            grid = [sched.replace_traced(gamma=float(g), delta=float(d))
                    for g, d in zip(rng.uniform(0.3, 1.5, b), rng.uniform(1e-3, 0.2, b))]
            kw = dict(envs=flipping_env(rng, 5, rounds, "cuda"), env_axis=None,
                      uniforms=torch.rand((rounds, 2, 5), generator=gen, device="cuda"),
                      uniforms_axis=None, hparams=stack_params(grid, "cuda"), hp_axis=0)
        else:
            kw = dict(envs=stack_envs([flipping_env(rng, 5, rounds, "cuda") for _ in range(b)]),
                      uniforms=torch.rand((b, rounds, 2, 5), generator=gen, device="cuda"))
        before = regret_scan.launches
        scan = simulate_aoi_regret_batch(sched, horizon=rounds, return_state=True, impl="scan",
                                         **kw)
        check(regret_scan.launches == before + 1, f"regret_scan batch {label}: not one launch")
        plain = sched if impl == "recompute" else dataclasses.replace(sched,
                                                                      detector_backend="torch")
        rounds_out = simulate_aoi_regret_batch(plain, horizon=rounds, return_state=True,
                                               impl="rounds", **kw)
        check(regret_scan.launches == before + 1,
              f"regret_scan batch {label}: the rounds route launched it")
        torch.cuda.synchronize()
        err = max(err, compare_routes(torch, scan, rounds_out, f"regret_scan batch {label}"))
        line(f"  regret_scan batch {label} ({impl}): T={rounds}, one launch, restarts "
             f"{int(scan['restarts'].sum())} over the runs, equal to the batched rounds route ok")
    return err


def timed_run(torch, fn):
    """(output, seconds) of one run that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fig2_routes(torch, label, sched, env, uniforms, rounds_cut=None):
    """The T = FIG2_ROUNDS run on both routes, in turns scan, rounds, scan:
    launch counts, bit-for-bit equality and each route's ms/round.  With
    ``rounds_cut`` the rounds route runs the first ``rounds_cut`` rounds
    only and is held to the scan route's run of those rounds.  Returns (the
    scan's output, summed launches, the scan's kernel-line fields)."""
    from repro_torch.core.regret import simulate_aoi_regret
    from repro_torch.kernels.regret_scan import regret_scan

    rounds = uniforms.shape[0]
    cut = rounds_cut or rounds
    kernel = "glr_scan" if sched.detector_impl == "recompute" else "glr_step"
    run = lambda impl, t=rounds: simulate_aoi_regret(sched, env, t, uniforms=uniforms[:t],
                                                     return_state=True, impl=impl)
    reset_launches()
    scan, secs_scan = timed_run(torch, lambda: run(None))
    scan_launches = read_launches()
    splits = int(regret_scan.splits.sum())
    check(scan_launches["regret_scan"] == 1 and scan_launches[kernel] == 0
          and scan_launches["glr_step"] + scan_launches["glr_scan"] == 0,
          f"{label} scan: launches {scan_launches}, expected regret_scan once and no {kernel}")
    reset_launches()
    rounds_out, secs_rounds = timed_run(torch, lambda: run("rounds", cut))
    rounds_launches = read_launches()
    check(rounds_launches[kernel] == cut // sched.detector_stride
          and rounds_launches["regret_scan"] == 0,
          f"{label} rounds: {kernel} launched {rounds_launches[kernel]} times, expected "
          f"{cut // sched.detector_stride}, regret_scan {rounds_launches['regret_scan']}")
    _, secs_scan_again = timed_run(torch, lambda: run(None))
    err = compare_routes(torch, scan if cut == rounds else run(None, cut), rounds_out,
                         f"{label} scan vs rounds")
    kc = scan_cost(sched, rounds, splits=splits)
    bound, bound_by = kc.bound_ms, kc.bound_by
    ms_scan, ms_scan_again, ms_rounds = secs_scan * 1e3, secs_scan_again * 1e3, secs_rounds * 1e3
    line(f"  {label} scan route: T={rounds} {ms_scan:.3f} ms a run ({ms_scan / rounds:.6f} "
         f"ms/round), again {ms_scan_again:.3f} ms; regret_scan.launches="
         f"{scan_launches['regret_scan']}, {splits} GLR splits, bound {bound:.2e} ms ({bound_by})")
    line(f"  {label} rounds route: T={cut}{' (cut)' if cut < rounds else ''} {ms_rounds:.1f} ms "
         f"a run ({ms_rounds / cut:.4f} ms/round), {ms_rounds / cut / (ms_scan / rounds):.0f}x "
         f"the scan's a round; {kernel}.launches={rounds_launches[kernel]}")
    line(f"  {label}: schedule, restarts={int(rounds_out['restarts'])}, regret, AoI, success rate "
         f"and final state of the two routes over {cut} rounds bitwise equal, variance sums "
         f"within rtol 1e-6")
    launches = {k: scan_launches[k] + rounds_launches[k] for k in COUNTERS}
    fields = dict(scan_source="src/repro_torch/kernels/csrc/regret_scan.cu",
                  scan_launches=scan_launches["regret_scan"], scan_rounds=rounds,
                  scan_ms=ms_scan, scan_ms_again=ms_scan_again, scan_ms_per_round=ms_scan / rounds,
                  scan_plain_ms=ms_rounds, scan_plain_rounds=cut, scan_bound_ms=bound,
                  scan_bound_by=bound_by, scan_splits=splits, scan_max_abs_err=err)
    return scan, launches, fields


def scan_chain_cost(torch, sched, env, uniforms, ms_stride):
    """What a scan round costs without and with detection: the same run at
    detector stride 1e9 (a detection at round 0 only: the per-round
    dependency chain of warp 0 alone) and 1 (a detection every round),
    beside the run's own stride.  Per-round chain = t(1e9) / T; per
    detection round = (t(1) - t(1e9)) / (T - 1)."""
    import dataclasses

    from repro_torch.core.regret import simulate_aoi_regret

    rounds = uniforms.shape[0]
    ms = {}
    for stride in (10**9, 1):
        s = dataclasses.replace(sched, detector_stride=stride)
        _, secs = timed_run(torch, lambda: simulate_aoi_regret(s, env, rounds, uniforms=uniforms))
        ms[stride] = secs * 1e3
    chain_us = ms[10**9] / rounds * 1e3
    detect_us = (ms[1] - ms[10**9]) / (rounds - 1) * 1e3
    line(f"  fig2 scan chain: T={rounds} stride 1e9 {ms[10**9]:.3f} ms, stride "
         f"{sched.detector_stride} {ms_stride:.3f} ms, stride 1 {ms[1]:.3f} ms: the per-round "
         f"chain {chain_us:.3f} us a round, a detection round {detect_us:.3f} us more")
    return chain_us


def scan_call_cost(torch, sched, env, uniforms, ms_per_round, rounds=500, calls=20):
    """The scan route's fixed cost a call on the host: ``calls`` runs of
    ``rounds`` rounds (the profile window's length), each ending in a
    synchronize, against ``rounds`` x the full run's time a round."""
    from repro_torch.core.regret import simulate_aoi_regret

    u = uniforms[:rounds].contiguous()
    run = lambda: simulate_aoi_regret(sched, env, rounds, uniforms=u, collect_curve=False)
    timed_run(torch, run)
    ms_call = sum(timed_run(torch, run)[1] for _ in range(calls)) / calls * 1e3
    kernel_ms = rounds * ms_per_round
    line(f"  fig2 scan call: {rounds} rounds {ms_call:.4f} ms a call (mean of {calls}, each "
         f"synchronized), {rounds} x {ms_per_round:.6f} ms = {kernel_ms:.4f} ms of rounds: "
         f"{ms_call - kernel_ms:.4f} ms fixed a call (state init, checks, allocation, launch)")


# ---------------------------------------------------------------------------
# phase 3: Fig. 2 AoI-regret path
# ---------------------------------------------------------------------------

def fig2(torch, seed):
    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_scenario
    from repro_torch.core.regret import simulate_aoi_regret, sublinearity_index
    from repro_torch.kernels.regret_scan import regret_scan

    n, m = 5, 2
    sched = GLRCUCB(n, m, history=1024, detector_stride=5)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rounds = FIG2_ROUNDS
    env = make_scenario("piecewise", n_channels=n, horizon=rounds, n_breakpoints=5).realize(gen)
    # the env, for tools/fig2_reference.py --env (the JAX reference on it)
    line("  fig2 env: " + json.dumps({"means": env.means.cpu().tolist(),
                                      "breaks": env.breaks.cpu().tolist()}))

    # reference: a shorter run on the card (the scan kernel) equals the same
    # run on the CPU (the plain per-round loop) on the same uniforms
    t_ref = FIG2_REF_ROUNDS             # typically passes a breakpoint and a restart
    u = torch.rand((t_ref, 2, n), generator=gen, device="cuda")
    before = regret_scan.launches
    card = simulate_aoi_regret(sched, env, t_ref, uniforms=u)
    check(regret_scan.launches == before + 1, "fig2 reference: the card run did not take the scan")
    cpu = simulate_aoi_regret(sched, env.to("cpu"), t_ref, uniforms=u.cpu(), device="cpu")
    check(torch.equal(card["channels"].cpu(), cpu["channels"]), "fig2: card schedule != CPU schedule")
    check(int(card["restarts"]) == int(cpu["restarts"]), "fig2: card restarts != CPU restarts")
    check(torch.equal(card["regret"].cpu(), cpu["regret"]), "fig2: card regret != CPU regret")
    line(f"  fig2 reference: {t_ref} rounds of the scan route on the card equal the CPU run "
         f"(schedule, restarts={int(cpu['restarts'])}, regret={float(cpu['final_regret']):.0f})")

    # drawn as simulate_aoi_regret would draw them from gen; kept for phase 6
    uniforms = torch.rand((rounds, 2, n), generator=gen, device="cuda")
    out, launches, scan_fields = fig2_routes(torch, "fig2", sched, env, uniforms, FIG2_ROUNDS_CUT)
    regret = out["regret"]
    check(regret.shape == (rounds,) and bool(torch.isfinite(regret).all()), "fig2: regret not finite")
    chain_us = scan_chain_cost(torch, sched, env, uniforms, scan_fields["scan_ms"])
    scan_call_cost(torch, sched, env, uniforms, scan_fields["scan_ms_per_round"])
    profile_window(torch, "fig2 rounds route", lambda: simulate_aoi_regret(
        sched, env, 500, generator=gen, collect_curve=False, impl="rounds"), 500)
    profile_window(torch, "fig2 scan route", lambda: simulate_aoi_regret(
        sched, env, 500, generator=gen, collect_curve=False), 500)
    profile_window(torch, "fig2 scan route", lambda: simulate_aoi_regret(
        sched, env, rounds, uniforms=uniforms), rounds)
    sub = float(sublinearity_index(regret))
    line(f"  fig2: T={rounds} final_regret={float(out['final_regret']):.1f} "
         f"restarts={int(out['restarts'])} sublinearity_index={sub:.4f} "
         f"success_rate={float(out['success_rate']):.4f}")
    return launches, dict(env=env, uniforms=uniforms, out=out, n=n, m=m, scan=scan_fields,
                          chain_us=chain_us)


# ---------------------------------------------------------------------------
# phase 6: Fig. 2 with the recompute detector
# ---------------------------------------------------------------------------

def fig2_recompute(torch, f2):
    """Phase 3's run again with ``detector_impl="recompute"`` on the same
    env and uniforms, on both routes: every decision must equal the
    streaming scan's, bit for bit."""
    from repro_torch.core.bandits import GLRCUCB

    sched = GLRCUCB(f2["n"], f2["m"], history=1024, detector_stride=5, detector_impl="recompute")
    out, launches, scan_fields = fig2_routes(torch, "fig2 recompute", sched, f2["env"],
                                             f2["uniforms"], RECOMPUTE_ROUNDS_CUT)
    ref = f2["out"]
    for k in BITWISE_OUT + VAR_OUT:
        check(torch.equal(out[k], ref[k]), f"fig2 recompute: {k} differs from the streaming scan")
    for f in ("mu_tilde", "counts", "tau", "restarts"):
        check(torch.equal(getattr(out["final_sched_state"], f),
                          getattr(ref["final_sched_state"], f)),
              f"fig2 recompute: final {f} differs from the streaming scan")
    line(f"  fig2 recompute: schedule, restarts={int(out['restarts'])}, regret "
         f"{float(out['final_regret']):.1f}, AoI and variances bitwise equal to the streaming scan")
    return launches, scan_fields


# ---------------------------------------------------------------------------
# phase 4: Fig. 3 asynchronous-FL path
# ---------------------------------------------------------------------------

def fig3_setup(torch, seed, n=30, m=20, adversarial=False):
    """The Fig. 3 problem at the paper's size: data, the 5,674-param MLP,
    the skewed piecewise env, the config, GLR-CUCB and the uniforms.  With
    ``adversarial`` the env is the extremely non-stationary regime's
    (``random_adversarial_env``, flip_prob 0.01, at the paper's small scale
    N = 6, M = 4: ``benchmarks/run.py:770-776``); the draws before the env
    are those of the default."""
    import numpy as np
    from torch import nn
    from torch.nn import functional as F

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_piecewise, random_adversarial_env
    from repro_torch.data import FederatedLoader, SyntheticClassification, dirichlet_partition
    from repro_torch.fl import AsyncFLConfig

    dim, hidden, classes, spc = 48, 96, 10, 192
    rounds = FIG3_ROUNDS
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    # data: the benchmark's Fig. 3 problem (Dirichlet alpha 0.1, 192 samples a
    # client; its seeds 3 and 4 at --seed 0)
    ds = SyntheticClassification(m * spc * 2, n_classes=classes, dim=dim, noise=1.0, seed=3 + seed)
    (trx, try_), (tex, tey) = ds.split(0.9)
    parts = dirichlet_partition(try_, m, 0.1, seed=3 + seed, min_per_client=spc)
    cx = np.stack([trx[np.resize(p, spc)] for p in parts])
    cy = np.stack([try_[np.resize(p, spc)] for p in parts])
    bx, by = FederatedLoader(cx, cy, batch_size=16, local_epochs=3, seed=4 + seed).next_rounds(rounds)
    bx, by = torch.from_numpy(bx).cuda(), torch.from_numpy(by).to(torch.int64).cuda()
    tex, tey = torch.from_numpy(tex).cuda(), torch.from_numpy(tey).to(torch.int64).cuda()

    class MLP(nn.Module):
        """48 -> 96 -> 10, weights in the JAX package's (in, out) layout."""

        def __init__(self):
            super().__init__()
            self.w1 = nn.Parameter(torch.randn((dim, hidden), generator=gen, device="cuda") * 0.1)
            self.b1 = nn.Parameter(torch.zeros(hidden, device="cuda"))
            self.w2 = nn.Parameter(torch.randn((hidden, classes), generator=gen, device="cuda") * 0.1)
            self.b2 = nn.Parameter(torch.zeros(classes, device="cuda"))

        def forward(self, x):
            return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2

    model = MLP()
    params = {k: v.detach() for k, v in model.named_parameters()}
    n_params = sum(v.numel() for v in params.values())
    check(n_params == 5674, f"fig3: MLP has {n_params} params, expected 5674")

    def loss_fn(p, x, y):
        return F.cross_entropy(torch.func.functional_call(model, p, (x,)), y)

    def accuracy(state):
        with torch.no_grad():
            logits = torch.relu(tex @ state.params["w1"] + state.params["b1"]) \
                @ state.params["w2"] + state.params["b2"]
            return float((logits.argmax(1) == tey).float().mean())

    def accuracy_batch(params):
        """(B,) test accuracies of a batch of models (leaves (B, ...))."""
        with torch.no_grad():
            h = torch.relu(torch.matmul(tex, params["w1"]) + params["b1"][:, None])
            logits = torch.matmul(h, params["w2"]) + params["b2"][:, None]
            return (logits.argmax(-1) == tey).float().mean(-1)

    if adversarial:
        env = random_adversarial_env(gen, n, rounds, flip_prob=0.01)
    else:
        # the skewed piecewise env: Good channels are rare (means ~ u^4)
        means = 0.03 + (0.95 - 0.03) * torch.rand((5, n), generator=gen, device="cuda") ** 4.0
        breaks = torch.linspace(0, rounds, 6, device="cuda")[1:-1].to(torch.int64)
        env = make_piecewise(means, breaks)
    return dict(
        n=n, m=m, rounds=rounds, bx=bx, by=by, params=params, loss_fn=loss_fn,
        accuracy=accuracy, accuracy_batch=accuracy_batch, cx=cx, cy=cy, env=env,
        cfg=AsyncFLConfig(n_clients=m, n_channels=n, local_epochs=3, client_lr=0.15,
                          server_lr=0.15, use_matching=True, use_zeta=True),
        sched=GLRCUCB(n, m, history=256),
        uniforms=torch.rand((rounds, 2, n), generator=gen, device="cuda"))


def fig3_reference(torch, S, label, fault_uniforms=None, burst_on=False, **kw):
    """Rounds on the card equal the same rounds on the CPU, on the same
    uniforms: n_success and mean AoI bitwise, the rest at rtol 1e-4.  ``kw``
    (faults, aggregator) goes to both trainers.  With faults the CPU run is
    also held, round by round, against the same run without them: their
    params must part, so a corrupted row reached the aggregate within the
    compared rounds (``FIG3_REF_ROUNDS``, or up to ``FIG3_REF_MAX_ROUNDS``
    until that happens).  ``burst_on`` starts a burst schedule bursting."""
    from repro_torch.fl import AsyncFLTrainer

    faults = kw.get("faults")

    def start(tr):
        state = tr.init(S["params"])
        return state._replace(fault_state=torch.ones((), device=tr.device)) if burst_on else state

    def one_round(tr, state, r, fu):
        sl = slice(r, r + 1)
        return tr.run(state, S["bx"][sl].to(tr.device), S["by"][sl].to(tr.device),
                      uniforms=S["uniforms"][sl].to(tr.device),
                      fault_uniforms=None if fu is None else fu[sl].to(tr.device))

    cpu_tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"], device="cpu", **kw)
    s_cpu, mets, hit, r = start(cpu_tr), [], None, 0
    if faults is not None:
        clean_tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"], device="cpu",
                                  aggregator=kw.get("aggregator"))
        s_clean = clean_tr.init(S["params"])
    while r < FIG3_REF_ROUNDS or (faults is not None and hit is None and r < FIG3_REF_MAX_ROUNDS):
        s_cpu, m = one_round(cpu_tr, s_cpu, r, fault_uniforms)
        mets.append(m)
        if faults is not None and hit is None:
            s_clean, _ = one_round(clean_tr, s_clean, r, None)
            if any(not torch.equal(s_cpu.params[k], s_clean.params[k]) for k in S["params"]):
                hit = r + 1
        r += 1
    check(faults is None or hit is not None,
          f"{label}: no corrupted row reached the aggregate in {r} rounds")
    m_cpu = {k: torch.cat([m[k] for m in mets]) for k in mets[0]}

    card_tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"], **kw)
    s_card, m_card = card_tr.run(start(card_tr), S["bx"][:r], S["by"][:r],
                                 uniforms=S["uniforms"][:r],
                                 fault_uniforms=None if fault_uniforms is None else fault_uniforms[:r])
    for k in ("n_success", "mean_aoi"):
        check(torch.equal(m_card[k].cpu(), m_cpu[k]), f"{label}: card {k} != CPU {k}")
    for k in ("local_loss", "aoi_var", "zeta_max"):
        check(torch.allclose(m_card[k].cpu(), m_cpu[k], rtol=1e-4, atol=1e-5),
              f"{label}: card {k} not close to CPU {k}")
    for k in S["params"]:
        check(torch.allclose(s_card.params[k].cpu(), s_cpu.params[k], rtol=1e-4, atol=1e-5),
              f"{label}: card params {k} not close to CPU")
    hit_note = "" if faults is None else f"; an attacked row first reached the aggregate in round {hit}"
    line(f"  {label} reference: {r} rounds on the card match the CPU run "
         f"(n_success {m_cpu['n_success'].tolist()}, local_loss rtol 1e-4{hit_note})")


def fig3(torch, S):
    import numpy as np

    from repro_torch.fl import AsyncFLTrainer

    rounds = S["rounds"]
    fig3_reference(torch, S, "fig3")
    card_tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, mets = card_tr.run(card_tr.init(S["params"]), S["bx"], S["by"], uniforms=S["uniforms"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    profile_window(torch, "fig3", lambda: card_tr.run(
        state, S["bx"][:10], S["by"][:10], uniforms=S["uniforms"][:10]), 10)
    acc = S["accuracy"](state)
    loss = mets["local_loss"]
    check(bool(torch.isfinite(loss).all()) and np.isfinite(acc), "fig3: loss or accuracy not finite")
    check(launches["weighted_aggregate"] == rounds,
          f"fig3: weighted_aggregate launched {launches['weighted_aggregate']} times, expected {rounds}")
    check(launches["glr_step"] == rounds,
          f"fig3: glr_step launched {launches['glr_step']} times, expected {rounds}")
    check(acc > 0.2, f"fig3: test accuracy {acc:.3f} is not above chance")
    line(f"  fig3: rounds={rounds} local_loss first={float(loss[0]):.4f} last={float(loss[-1]):.4f} "
         f"n_success total={float(mets['n_success'].sum()):.0f} "
         f"mean_aoi last={float(mets['mean_aoi'][-1]):.3f} test_acc={acc:.4f} "
         f"seconds/round={secs / rounds:.6f} glr_step.launches={launches['glr_step']} "
         f"weighted_aggregate.launches={launches['weighted_aggregate']}")
    return launches, acc, dict(state=state, mets=mets, secs=secs)


# ---------------------------------------------------------------------------
# phase 5: the Fig. 3 path under Byzantine faults, robust aggregation
# ---------------------------------------------------------------------------

def fig3_robust(torch, S, seed, clean_acc):
    """The chaos suite's attack x defense runs on phase 4's setup."""
    import numpy as np

    from repro_torch.core.aggregation import make_aggregator
    from repro_torch.core.faults import make_fault
    from repro_torch.fl import AsyncFLTrainer

    rounds = S["rounds"]
    sign_flip = make_fault("sign_flip", rate=0.2, scale=8.0)
    trimmed = make_aggregator("trimmed_mean", trim_frac=0.34)
    median = make_aggregator("coordinate_median")
    burst = make_fault("burst", base=make_fault("sign_flip", rate=0.3, scale=6.0),
                       p_on=0.15, p_off=0.35)
    runs = [
        ("sign_flip+mean", sign_flip, make_aggregator("mean")),
        ("sign_flip+trimmed_mean", sign_flip, trimmed),
        ("sign_flip+coordinate_median", sign_flip, median),
        ("inner_product+norm_clip", make_fault("inner_product", rate=0.2, strength=8.0),
         make_aggregator("norm_clip", clip_norm=1.0)),
        ("burst+coordinate_median", burst, median),
    ]
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    fault_u = {name: torch.rand((rounds, f.n_uniforms(S["m"])), generator=gen, device="cuda")
               for name, f, _ in runs}
    fig3_reference(torch, S, "fig3 sign_flip+coordinate_median", faults=sign_flip,
                   aggregator=median, fault_uniforms=fault_u["sign_flip+coordinate_median"])
    fig3_reference(torch, S, "fig3 burst+trimmed_mean", faults=burst, aggregator=trimmed,
                   fault_uniforms=fault_u["burst+coordinate_median"],   # the same family
                   burst_on=True)

    totals = dict.fromkeys(COUNTERS, 0)
    for name, fault, agg in runs:
        tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"], faults=fault,
                            aggregator=agg)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mets = tr.run(tr.init(S["params"]), S["bx"], S["by"], uniforms=S["uniforms"],
                             fault_uniforms=fault_u[name])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        order_stat = agg.FAMILY in ("trimmed_mean", "coordinate_median")
        want = dict(robust_trimmed=rounds if order_stat else 0,
                    weighted_aggregate=0 if order_stat else rounds, glr_step=rounds)
        for k, v in want.items():
            check(launches[k] == v, f"fig3 {name}: {k} launched {launches[k]} times, expected {v}")
        acc = S["accuracy"](state)
        loss = mets["local_loss"]
        check(bool(torch.isfinite(loss).all()) and np.isfinite(acc)
              and all(bool(torch.isfinite(v).all()) for v in state.params.values()),
              f"fig3 {name}: loss, params or accuracy not finite")
        line(f"  fig3 {name}: rounds={rounds} test_acc={acc:.4f} (clean {clean_acc:.4f}) "
             f"local_loss last={float(loss[-1]):.4f} "
             f"n_success total={float(mets['n_success'].sum()):.0f} "
             f"seconds/round={secs / rounds:.6f} launches={launches}")
        for k in COUNTERS:
            totals[k] += launches[k]
        if name == "sign_flip+coordinate_median":
            profile_window(torch, f"fig3 {name}", lambda: tr.run(
                state, S["bx"][:10], S["by"][:10], uniforms=S["uniforms"][:10],
                fault_uniforms=fault_u[name][:10]), 10)
    return totals


# ---------------------------------------------------------------------------
# phase 7: the model zoo's serving path (prefill and greedy decode)
# ---------------------------------------------------------------------------

def release(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_reference(torch, seed):
    """qwen3-32b at full width, 2 layers, f32: the kernel route's prefill
    against the plain chunked route (rtol/atol 2e-3, the JAX package's
    kernel-vs-XLA tolerance), then decode against prefill (rtol/atol 2e-3,
    the twin of ``tests/test_arch_smoke.py::test_decode_matches_prefill_f32``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_REF_LAYERS, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    model, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params, _ = model.init(gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT), generator=gen, device="cuda",
                         dtype=torch.int32)
    before, before_fma = kernel.launches, kernel.fma_launches
    got = make_prefill_step(model)(params, {"tokens": toks})
    check(kernel.launches == before + SERVE_REF_LAYERS
          and kernel.fma_launches == before_fma + SERVE_REF_LAYERS,
          f"serve f32: the kernel route launched {kernel.launches - before} kernels, "
          f"{kernel.fma_launches - before_fma} on the FMA route")
    want = make_prefill_step(plain)(params, {"tokens": toks})
    check(kernel.launches == before + SERVE_REF_LAYERS, "serve f32: the plain route ran the kernel")
    err = float((got - want).abs().max())
    check(got.shape == (1, 1, cfg.vocab_size) and bool(torch.isfinite(got).all()),
          f"serve f32: prefill logits {tuple(got.shape)} not finite or of the wrong shape")
    check(torch.allclose(got, want, rtol=2e-3, atol=2e-3),
          f"serve f32: kernel-route prefill beyond rtol/atol 2e-3 of the plain route ({err:.3e})")
    line(f"  serve {cfg.name} width {cfg.d_model}, {cfg.n_layers} layers, f32: prefill of "
         f"{SERVE_PROMPT} tokens, kernel route vs plain chunked route max_abs_err={err:.3e} "
         f"(max |logit| {float(want.abs().max()):.3f}; rtol/atol 2e-3) ok")

    full, _ = model.apply(params, {"tokens": toks})
    cache = model.init_cache(1, SERVE_PROMPT, dtype=torch.float32, device="cuda")
    dec_err = 0.0
    for t in range(DECODE_REF_STEPS):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        ref_t = full[:, t].float()
        dec_err = max(dec_err, float((lg - ref_t).abs().max()))
        check(torch.allclose(lg, ref_t, rtol=2e-3, atol=2e-3),
              f"serve f32: decode step {t} beyond rtol/atol 2e-3 of apply's logits ({dec_err:.3e})")
    line(f"  serve {cfg.name} f32: {DECODE_REF_STEPS} teacher-forced decode steps match apply's "
         f"logits (kernel-route prefill), max_abs_err={dec_err:.3e} (rtol/atol 2e-3) ok")
    del params, got, want, full, cache, lg
    release(torch)


def serve_path(torch, seed, n_layers):
    """qwen3-32b at full width and ``n_layers`` depth in bf16: prefill steps
    and the serve loop, the main path whose launches are counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=n_layers)
    model = build_model(cfg)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    h0, free0 = allocator_bytes(torch), free_blocks(torch)
    m0 = h0[0]
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    t0 = time.perf_counter()
    params, _ = model.init(gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = minus(allocator_bytes(torch), h0)
    n_params = sum(v.numel() for v in params.values())
    norms = n_layers * (2 * cfg.d_model + 2 * cfg.resolved_head_dim * cfg.qk_norm) + cfg.d_model
    check(n_params == cfg.param_count() + norms,      # param_count leaves out the norm gains
          f"serve: {n_params} params, config says {cfg.param_count()} + {norms} norm gains")
    weights_gib = sum(v.numel() * v.element_size() for v in params.values()) / 2 ** 30
    line(f"  serve {cfg.name}: {n_layers} layers, width {cfg.d_model}, bf16, {n_params / 1e9:.2f} B "
         f"params ({weights_gib:.2f} GiB) drawn on the card in {init_s:.2f} s")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_PREFILL_BATCH, SERVE_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    prefill = make_prefill_step(model)
    prefill_static = minus(allocator_bytes(torch), h0)

    reset_launches()
    prefill_ms = []
    for i in range(3):                    # the first one is the warm-up
        before, before_tc = kernel.launches, kernel.tc_launches
        torch.cuda.synchronize()
        if i == 2:
            torch.cuda.reset_peak_memory_stats()      # phase 19 (b): the peak of one prefill
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        check(kernel.launches == before + n_layers and kernel.tc_launches == before_tc + n_layers,
              f"serve: flash_attention launched {kernel.launches - before} times in a prefill, "
              f"{kernel.tc_launches - before_tc} on the tensor-core route, expected {n_layers}")
        check(logits.shape == (SERVE_PREFILL_BATCH, 1, cfg.vocab_size)
              and logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
              f"serve: prefill logits {tuple(logits.shape)} {logits.dtype} not finite or misshapen")
    card = {"card_prefill": card_step(prefill_static, torch.cuda.max_memory_allocated() - m0,
                                      per_step(read_launches(), 3, "serve prefill"),
                                      sum(prefill_ms[1:]) / 2, (free0,))}
    release(torch)
    m_pre, free1 = allocator_bytes(torch), free_blocks(torch)
    tok, cache, secs = serve_loop(model, params, SERVE_BATCH, SERVE_CONTEXT, SERVE_TOKENS,
                                  device="cuda")
    launches = read_launches()
    check(int(cache["pos"]) == SERVE_TOKENS, f"serve: cache pos {int(cache['pos'])}")
    check(tok.shape == (SERVE_BATCH,) and tok.dtype == torch.int32
          and bool(((tok >= 0) & (tok < cfg.vocab_size)).all()), "serve: decoded tokens invalid")
    step_ms = secs / SERVE_TOKENS * 1e3
    card["card_decode"] = decode_step_card(torch, model, params, cache, tok, m_pre, weights,
                                           step_ms, (free0, free1))
    line(f"  serve {cfg.name}: prefill {SERVE_PREFILL_BATCH} x {SERVE_PROMPT} tokens "
         f"{prefill_ms[1]:.1f} / {prefill_ms[2]:.1f} ms (warm-up {prefill_ms[0]:.1f} ms), "
         f"{SERVE_PREFILL_BATCH * SERVE_PROMPT / (prefill_ms[1] / 1e3):.0f} prompt tok/s; "
         f"flash_attention.launches={launches['flash_attention']} "
         f"({launches['flash_attention'] // 3} a prefill, "
         f"{launches['flash_attention_tc'] // 3} of them on the tensor-core route)")
    line(f"  [serve] {cfg.name}: {SERVE_TOKENS} tokens x {SERVE_BATCH} seqs in {secs:.2f}s "
         f"({SERVE_BATCH * SERVE_TOKENS / secs:.1f} tok/s, {step_ms:.2f} ms a decode step, "
         f"context {SERVE_CONTEXT}), cache pos={int(cache['pos'])}")

    # not counted: the plain route's prefill for comparison, and traces
    got = logits.float()
    want = make_prefill_step(build_model(cfg, attn_impl="plain"))(params, batch).float()
    rel = float((got - want).abs().max() / want.abs().max())
    line(f"  serve {cfg.name}: bf16 prefill logits, kernel route vs plain chunked route: "
         f"max |diff| / max |logit| = {rel:.3e} (printed, not gated)")
    del got, want
    release(torch)
    by_name = profile_window(torch, f"serve prefill {SERVE_PREFILL_BATCH}x{SERVE_PROMPT}",
                             lambda: prefill(params, batch), 1)
    total = sum(by_name.values())
    attn_us = sum(v for k, v in by_name.items() if "flash_fwd" in k)
    if total:
        line(f"  serve prefill: flash_attention {attn_us / 1e3:.2f} ms of {total / 1e3:.2f} ms "
             f"device time ({100 * attn_us / total:.1f} %)")
    steps = 4
    out = {}

    def decode():
        tk = tok
        c = cache
        for _ in range(steps):
            lg, c = model.decode_step(params, c, tk)
            tk = lg.argmax(-1).to(torch.int32)
        out["logits"] = lg

    profile_window(torch, f"serve decode batch {SERVE_BATCH}", decode, steps)
    lg = out["logits"]
    check(lg.shape == (SERVE_BATCH, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
          "serve: decode logits not finite or misshapen")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line(f"  serve {cfg.name}: decode logits finite, peak device memory {peak:.2f} GiB")
    del params, logits, cache, lg, out
    release(torch)
    return launches, dict(prefill_ms=prefill_ms[1:], decode_step_ms=step_ms,
                          tok_s=SERVE_BATCH * SERVE_TOKENS / secs, card=card)


# ---------------------------------------------------------------------------
# phase 8: the multi-tenant scheduler service
# ---------------------------------------------------------------------------

def same_tree(torch, a, b):
    """Every tensor leaf of two equal NamedTuple/dict structures bitwise
    equal (compared on the CPU)."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return all(same_tree(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return all(same_tree(torch, a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def sched_parity(torch, sched, server, seed):
    """(a) One tenant served 1000 rounds on ``offline_round_stream`` of a
    piecewise env (N = 16, 3 breakpoints) equals ``simulate_aoi_regret``'s
    scan route on the card and the same rounds served on the CPU, bit for
    bit.  Returns the launches of the served run."""
    from repro_torch.core.channels import make_scenario
    from repro_torch.core.regret import offline_round_stream, simulate_aoi_regret
    from repro_torch.kernels.regret_scan import regret_scan
    from repro_torch.sim import SchedServer, ServeRequest

    n, rounds = sched.n_channels, SCHED_PARITY_ROUNDS
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    env = make_scenario("piecewise", n_channels=n, horizon=rounds, n_breakpoints=3).realize(gen)
    u = torch.rand((rounds, 2, n), generator=gen, device="cuda")
    before = regret_scan.launches
    off = simulate_aoi_regret(sched, env, rounds, uniforms=u, collect_curve=False,
                              return_state=True)
    check(regret_scan.launches == before + 1, "sched-serve parity: the offline run did not scan")
    u_sel, states = (x.cpu().numpy() for x in offline_round_stream(env, u, rounds))
    reqs = [ServeRequest("parity", states[t], u_sel[t]) for t in range(rounds)]
    server.join("parity")
    steps0 = server.stats()["steps"]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rq in reqs:
        server.serve([rq])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    steps = server.stats()["steps"] - steps0
    row = server.tenant_state("parity")
    cpu = SchedServer(sched, capacity=4, slots=1, device="cpu")
    cpu.join("parity")
    for rq in reqs:
        cpu.serve([rq])
    cpu_row = cpu.tenant_state("parity")
    check(same_tree(torch, off["final_sched_state"], row.sched_state),
          "sched-serve parity: served state != the scan route's final state")
    check(torch.equal(off["aoi_pi"].cpu(), row.aoi.cpu()), "sched-serve parity: AoI != the scan's")
    check(same_tree(torch, row, cpu_row), "sched-serve parity: card row != the CPU run's row")
    check(launches["glr_step_tenants"] == steps == rounds and launches["glr_step"] == 0,
          f"sched-serve parity: launches {launches} over {steps} steps")
    line(f"  sched-serve parity: {rounds} rounds of one tenant (slot batch {server.slots}) equal "
         f"the scan route and the CPU run bit for bit (every state leaf, AoI, restarts="
         f"{int(row.sched_state.restarts)}); glr_step_tenants launched "
         f"{launches['glr_step_tenants']} times over {steps} steps, glr_step "
         f"{launches['glr_step']} ({secs / rounds * 1e3:.4f} ms/step)")
    server.leave("parity")
    return launches


def sched_serve(torch, seed):
    """Phase 8: the JAX benchmark's ``serve_suite`` configuration
    (``benchmarks/run.py:1380-1456``) at its sizes.  Returns the launches of
    the served runs (each counted from zero) and the metrics."""
    from collections import deque

    import numpy as np

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.fl import AsyncFLTrainer
    from repro_torch.launch.sched_serve import (make_traffic, pipelined_poisson_episode,
                                                pipelined_throughput, saturated_throughput)
    from repro_torch.sim import SchedServer, ServeRequest

    c, b, n, m = SCHED_CAPACITY, SCHED_SLOTS, SCHED_N, SCHED_M
    sched = GLRCUCB(n, m, history=SCHED_H, detector_stride=5, split_grid="auto")
    server = SchedServer(sched, capacity=c, slots=b)
    serial = SchedServer(sched, capacity=c, slots=1)
    paths = [sched_parity(torch, sched, server, seed)]

    # (b) the 256-tenant server: per-tenant gamma, the benchmark's traffic
    n_req, n_serial = SCHED_REQUESTS, SCHED_SERIAL_REQUESTS
    ids = [f"job-{i}" for i in range(c)]
    cpu = SchedServer(sched, capacity=c, slots=b, device="cpu")
    for i, tid in enumerate(ids):
        hp = {"gamma": 0.8 + 0.4 * i / c}
        server.join(tid, hp=hp)
        cpu.join(tid, hp=hp)
        serial.join(tid)
    states, uniforms = make_traffic(c, n, max(n_req, n_serial), seed=seed)
    req = lambda j: ServeRequest(ids[j % c], states[(j // c) % states.shape[0], j % c],
                                 uniforms[j])
    first = [req(j) for j in range(3 * b)]
    got, want = server.serve(first), cpu.serve(first)
    check(all(np.array_equal(x, y) for x, y in zip(got, want)),
          "sched-serve 256: assignments of the first 3 steps != the CPU run's")
    check(same_tree(torch, server._state, cpu._state),
          "sched-serve 256: slot state after 3 steps != the CPU run's")
    line(f"  sched-serve {c} tenants: the first 3 steps ({3 * b} requests) equal the CPU run bit "
         f"for bit (assignments, every slot leaf)")
    del cpu

    st0, ser0 = server.stats(), serial.stats()
    reset_launches()
    rate = max(saturated_throughput(server, ids, states, uniforms, n_req) for _ in range(2))
    serial_rate = max(saturated_throughput(serial, ids, states, uniforms, n_serial)
                      for _ in range(2))
    pipe_rate = max(pipelined_throughput(server, ids, states, uniforms, n_req) for _ in range(2))
    server.warm()
    lam = 0.8 * rate
    arrivals = np.cumsum(np.random.default_rng(seed).exponential(1.0 / lam, size=n_req))
    lat, wall, churn, depths = pipelined_poisson_episode(server, ids, states, uniforms, arrivals,
                                                         churn_stride=8)
    launches = read_launches()
    paths.append(launches)
    st1, ser1 = server.stats(), serial.stats()
    steps = st1["steps"] - st0["steps"] + ser1["steps"] - ser0["steps"]
    occupancy = (st1["served"] - st0["served"]) / max(st1["rows_dispatched"]
                                                      - st0["rows_dispatched"], 1)
    p50, p99, p999 = (float(x) * 1e3 for x in np.percentile(lat, [50, 99, 99.9]))
    check(launches["glr_step_tenants"] == steps and launches["glr_step"] == 0
          and launches["glr_scan_tenants"] == 0,
          f"sched-serve: glr_step_tenants launched {launches['glr_step_tenants']} times over "
          f"{steps} steps; glr_step {launches['glr_step']}")
    check(np.isfinite(lat).all() and (lat > 0).all(), "sched-serve: a latency is not positive")
    line(f"  sched-serve saturated: sync {rate:.1f} decisions/s, serial (slots=1) "
         f"{serial_rate:.1f} decisions/s, pipelined {pipe_rate:.1f} decisions/s (best of 2 "
         f"each; pipelined/sync {pipe_rate / rate:.3f}x, sync/serial {rate / serial_rate:.2f}x) "
         f"({b / rate * 1e3:.4f} ms/step)")
    line(f"  sched-serve Poisson load 80% ({lam:.1f} req/s): served {n_req} requests in "
         f"{wall:.3f} s ({n_req / wall:.1f} decisions/s), latency p50={p50:.3f} ms "
         f"p99={p99:.3f} ms p999={p999:.3f} ms, queue depth mean={depths.mean():.2f} "
         f"max={depths.max()}, batch_occupancy={occupancy:.3f}, churn_events={churn}, "
         f"sizes_used={st1['sizes_used']}")
    line(f"  sched-serve launches: glr_step_tenants {launches['glr_step_tenants']} over {steps} "
         f"steps, glr_step {launches['glr_step']}")

    # one steady step may not wait on the device
    pending = deque(enumerate(req(j) for j in range(b)))
    batch = server._take_batch(pending, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inflight = server._dispatch(batch, b, False)
    except RuntimeError as exc:
        raise SmokeFailure(f"sched-serve: a serve step synchronized with the device: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    server._retire(inflight)
    line("  sched-serve: a steady step ran under torch.cuda.set_sync_debug_mode('error') with "
         "no host sync ok")
    window = [req(j) for j in range(10 * b)]
    profile_window(torch, f"sched-serve {c}-tenant step (slot batch {b})",
                   lambda: server.serve(window), 10)

    # (c) 10^4 tenants, H = 64, unsharded
    c2, n_req2 = SCHED_BIG_CAPACITY, 8 * b
    sched2 = GLRCUCB(n, m, history=SCHED_BIG_H, detector_stride=5, split_grid="auto")
    big = SchedServer(sched2, capacity=c2, slots=b)
    big_cpu = SchedServer(sched2, capacity=c2, slots=b, device="cpu")
    for i in range(c2):
        big.join(i)
        big_cpu.join(i)
    rng = np.random.default_rng(seed + 3)
    states2 = (rng.random((4, c2, n)) < 0.6).astype(np.float32)
    uniforms2 = rng.random((n_req2, n)).astype(np.float32)
    reqs2 = [ServeRequest(j % c2, states2[(j // c2) % 4, j % c2], uniforms2[j]) for j in range(b)]
    reset_launches()
    got = big.serve(reqs2)
    want = big_cpu.serve(reqs2)
    check(all(np.array_equal(x, y) for x, y in zip(got, want))
          and same_tree(torch, big._state, big_cpu._state),
          "sched-serve 10^4: the first 64 requests != the CPU run")
    del big_cpu
    big_rate = saturated_throughput(big, list(range(c2)), states2, uniforms2, n_req2)
    paths.append(read_launches())
    check(paths[-1]["glr_step_tenants"] == big.stats()["steps"] and paths[-1]["glr_step"] == 0,
          f"sched-serve 10^4: launches {paths[-1]} over {big.stats()['steps']} steps")
    line(f"  sched-serve {c2} tenants (H={SCHED_BIG_H}, unsharded): the first {b} requests equal "
         f"the CPU run bit for bit; saturated {big_rate:.1f} decisions/s")
    del big

    # (d) run_served on phase 4's Fig. 3 setup
    S = fig3_setup(torch, seed)
    r = SCHED_FL_ROUNDS
    tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"])
    ref_state, ref_m = tr.run(tr.init(S["params"]), S["bx"][:r], S["by"][:r],
                              uniforms=S["uniforms"][:r])
    fl_server = SchedServer(S["sched"], capacity=4, slots=4, use_matching=True,
                            matcher_beta=S["cfg"].matcher_beta)
    fl_server.join("fig3")
    reset_launches()
    state, mets = tr.run_served(tr.init(S["params"]), S["bx"][:r], S["by"][:r], fl_server, "fig3",
                                uniforms=S["uniforms"][:r])
    paths.append(read_launches())
    check(paths[-1]["glr_step_tenants"] == fl_server.stats()["steps"] == r
          and paths[-1]["glr_step"] == 0,
          f"sched-serve fig3: launches {paths[-1]} over {fl_server.stats()['steps']} steps")
    for f in ref_state._fields:
        if f != "sched_state":
            check(same_tree(torch, getattr(ref_state, f), getattr(state, f)),
                  f"sched-serve fig3: run_served {f} != run()'s")
    check(same_tree(torch, ref_state.sched_state, fl_server.tenant_state("fig3").sched_state),
          "sched-serve fig3: the server's tenant state != run()'s sched_state")
    check(all(torch.equal(ref_m[k], mets[k]) for k in ref_m), "sched-serve fig3: metrics differ")
    line(f"  sched-serve fig3 run_served: {r} rounds (N={S['n']}, M={S['m']}, matching) equal "
         f"run() bit for bit (every state leaf, the server's tenant state, metrics); "
         f"glr_step_tenants launched {paths[-1]['glr_step_tenants']} times, once a step")
    del S
    launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
    return launches, dict(rate=rate, serial_rate=serial_rate, pipe_rate=pipe_rate, p50_ms=p50,
                          p99_ms=p99, p999_ms=p999, big_rate=big_rate)


# ---------------------------------------------------------------------------
# phase 9: the paper's baseline rows (Fig. 2a, Fig. 3/4)
# ---------------------------------------------------------------------------

def fig2a_policies(n, m, adversarial):
    """Fig. 2a's rows, (name, scheduler), as ``benchmarks/run.py:182-207``:
    nine on the piecewise env, six on the adversarial one (M-Exp3 with the
    Exp3.S sharing term there)."""
    from repro_torch.core.bandits import (GLRCUCB, AoIAware, ChannelAwareAsync, LyapunovSched,
                                          MExp3, RandomScheduler, RoundRobinScheduler)

    def glr(stride=5):
        return GLRCUCB(n, m, history=1024, detector_stride=stride)

    if not adversarial:
        return [("random", RandomScheduler(n, m)), ("round-robin", RoundRobinScheduler(n, m)),
                ("channel-aware", ChannelAwareAsync(n, m)), ("lyapunov", LyapunovSched(n, m)),
                ("glr-cucb", glr()), ("cucb-static", glr(10 ** 9)),
                ("aa-glr-cucb", AoIAware(glr())), ("m-exp3", MExp3(n, m, gamma=0.5)),
                ("aa-m-exp3", AoIAware(MExp3(n, m, gamma=0.5)))]
    return [("random", RandomScheduler(n, m)), ("channel-aware", ChannelAwareAsync(n, m)),
            ("lyapunov", LyapunovSched(n, m)),
            ("m-exp3", MExp3(n, m, gamma=0.5, share_alpha=1e-3)),
            ("aa-m-exp3", AoIAware(MExp3(n, m, gamma=0.5, share_alpha=1e-3))),
            ("glr-cucb", glr())]


def baseline_near_tie(torch, sched, state, t, u, aoi, rel=FORK_REL_TIE):
    """Whether round ``t``'s selection from ``state`` sits on a near-tie
    (``rel`` relative) where the card's and the CPU's ``log``/``exp`` may
    decide apart: channel-aware's perturbed scores, M-Exp3's draw against a
    CDF boundary, AoI-Aware's threshold (then its base's)."""
    from repro_torch.core.bandits import AoIAware, ChannelAwareAsync, MExp3

    def close(a, b):
        return abs(float(a) - float(b)) <= rel * max(abs(float(a)), abs(float(b)))

    if isinstance(sched, AoIAware):
        mu_hat = state.mu_sum / state.pulls.clamp_min(1.0)
        h_t = state.hp["threshold_scale"] / mu_hat.max().clamp_min(1e-6)
        return close(aoi.max(), h_t) or baseline_near_tie(torch, sched.base, state.base, t, u,
                                                          aoi, rel)
    if isinstance(sched, ChannelAwareAsync):
        g = -torch.log(-torch.log((u * (1.0 - 1e-12) + 1e-12).clamp_min(1e-12)))
        top = torch.sort(torch.log(sched._weights(state)) + g, descending=True).values
        return any(close(top[i], top[i + 1]) for i in range(sched.n_clients))
    if isinstance(sched, MExp3):
        cdf = torch.cumsum(sched._probs(state), 0)
        r = cdf[-1] * (1.0 - u[0])
        return bool(((cdf - r).abs() <= rel * r.abs()).any())
    return False


def fig2a_reference(torch, label, name, sched, env, u):
    """The first ``FIG2A_REF_ROUNDS`` rounds of a Fig. 2a row on the card
    (its route) against the CPU run on the same uniforms: schedule, AoI,
    regret and counters bit for bit; only a row whose draw goes through
    ``log``/``exp`` (``FORKING_ROWS``) may fork, and only at a near-tie, with
    everything equal before it.  Returns (what held, the card's output)."""
    from repro_torch.core.regret import policy_round, simulate_aoi_regret

    r = FIG2A_REF_ROUNDS
    card = simulate_aoi_regret(sched, env, r, uniforms=u[:r], return_state=True)
    cpu_env, cpu_u = env.to("cpu"), u[:r].cpu()
    cpu = simulate_aoi_regret(sched, cpu_env, r, uniforms=cpu_u, device="cpu")
    differ = (card["channels"].cpu() != cpu["channels"]).any(1).nonzero()
    if differ.numel() == 0:
        for k in ("regret", "aoi_pi", "aoi_star", "restarts", "exploit_rounds"):
            if k in cpu:
                check(torch.equal(card[k].cpu(), cpu[k]), f"{label}: card {k} != CPU {k}")
        return "equal the CPU run (schedule, AoI, regret, counters)", card
    t0 = int(differ[0])
    check(name in FORKING_ROWS, f"{label}: the card's schedule forks from the CPU run's at "
          f"round {t0}; only a draw through log/exp may fork")
    check(torch.equal(card["regret"][:t0].cpu(), cpu["regret"][:t0]),
          f"{label}: the regret differs before the fork at round {t0}")
    state, aoi = sched.init("cpu"), torch.ones(sched.n_clients)
    for t in range(t0):
        state, aoi, _, _ = policy_round(sched, state, aoi, t, cpu_u[t, 1],
                                        cpu_env.sample(t, cpu_u[t, 0]))
    check(baseline_near_tie(torch, sched, state, t0, cpu_u[t0, 1], aoi),
          f"{label}: the schedule forks at round {t0} without a near-tie "
          f"({FORK_REL_TIE} relative)")
    return (f"equal the CPU run up to round {t0}, where they fork at a near-tie within "
            f"{FORK_REL_TIE} relative"), card


def fig2a_rows(torch, seed):
    """Phase 9 (a): Fig. 2a's fifteen rows at N = 5, M = 2.  The rows the
    scan takes run at the paper's T; the others the per-round route at
    ``FIG2A_ROUNDS_CUT`` on envs realized at that horizon.  Returns the
    launches of the timed runs and, by row label, the run at the cut (its
    env, uniforms, output and ms a round) for phase 10."""
    from repro_torch.core.bandits import GLRCUCB, AoIAware
    from repro_torch.core.bandits.base import init_with_hp
    from repro_torch.core.channels import random_adversarial_env, random_piecewise_env
    from repro_torch.core.regret import (regret_growth_exponent, simulate_aoi_regret,
                                         sublinearity_index)
    from repro_torch.kernels.regret_scan import refusal

    n, m, cut = 5, 2, FIG2A_ROUNDS_CUT
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    envs = {}
    for horizon in (FIG2_ROUNDS, cut):
        envs["piecewise", horizon] = random_piecewise_env(gen, n, horizon, 5)
        envs["adversarial", horizon] = random_adversarial_env(gen, n, horizon, flip_prob=0.002)
    line(f"  fig2a cut: the rows regret_scan does not take run the per-round route at T={cut} "
         f"of the paper's {FIG2_ROUNDS}, on envs realized at T={cut} (piecewise: 5 breakpoints; "
         f"adversarial: flip_prob 0.002 a round): that route is host-bound at ~1-2 ms a round, "
         f"12 x {FIG2_ROUNDS} rounds would take ~6 min")
    counted, refs = [], {}
    for kind in ("piecewise", "adversarial"):
        for name, sched in fig2a_policies(n, m, kind == "adversarial"):
            u_full = torch.rand((FIG2_ROUNDS, 2, n), generator=gen, device="cuda")
            why = refusal(sched, envs[kind, FIG2_ROUNDS], init_with_hp(sched, "cuda", None),
                          u_full)
            rounds = FIG2_ROUNDS if why is None else cut
            env, u = envs[kind, rounds], u_full[:rounds].contiguous()
            label = f"fig2a {kind}/{name}"
            how, card_ref = fig2a_reference(torch, label, name, sched, env, u)
            reset_launches()
            out, secs = timed_run(torch, lambda: simulate_aoi_regret(sched, env, rounds,
                                                                    uniforms=u))
            counted.append(read_launches())
            route = "scan" if why is None else "rounds"
            check(counted[-1]["regret_scan"] == (why is None),
                  f"{label}: regret_scan launched {counted[-1]['regret_scan']} times on the "
                  f"{route} route")
            detect = (isinstance(sched, AoIAware) and isinstance(sched.base, GLRCUCB))
            check(counted[-1]["glr_step"] == (rounds // 5 if detect else 0),
                  f"{label}: glr_step launched {counted[-1]['glr_step']} times")
            check(torch.equal(out["channels"][:FIG2A_REF_ROUNDS], card_ref["channels"]),
                  f"{label}: the timed run's first rounds differ from the reference run's")
            regret = out["regret"]
            check(regret.shape == (rounds,) and bool(torch.isfinite(regret).all()),
                  f"{label}: regret not finite")
            counters = " ".join(f"{k}={int(out[k])}" for k in ("restarts", "exploit_rounds")
                                if k in out)
            line(f"  {label}: route={route} T={rounds} final_regret="
                 f"{float(out['final_regret']):.1f} sublinearity_index="
                 f"{float(sublinearity_index(regret)):.4f} growth_exp="
                 f"{regret_growth_exponent(regret):.4f} ({secs / rounds * 1e3:.6f} ms/round) "
                 f"{counters}; its first {FIG2A_REF_ROUNDS} rounds {how}")
            if why is None:
                # the same policy at the cut, for comparing with the per-round rows
                at_cut = simulate_aoi_regret(sched, envs[kind, cut], cut,
                                             uniforms=u_full[:cut].contiguous())
                line(f"    {label} at the cut: T={cut} final_regret="
                     f"{float(at_cut['final_regret']):.1f} restarts={int(at_cut['restarts'])}")
            else:
                at_cut = out
                line(f"    {label}: the scan does not take it ({why})")
            refs[label] = dict(env=envs[kind, cut], u=u_full[:cut].contiguous(), out=at_cut,
                               ms_round=secs / rounds * 1e3, route=route)
            if (kind, name) == ("adversarial", "m-exp3"):
                profile_window(torch, f"{label} rounds route", lambda: simulate_aoi_regret(
                    sched, env, 200, uniforms=u[:200], collect_curve=False), 200)
    return {k: sum(p[k] for p in counted) for k in COUNTERS}, refs


def fig34_rows(torch, seed):
    """Phase 9 (b): the Fig. 3/4 baseline rows (``benchmarks/run.py:744-786``),
    ``FIG3_ROUNDS`` rounds and one seed a row: random, channel-aware and
    Lyapunov on phase 4's N = 30, M = 20 problem; those and M-Exp3 with and
    without matching on the adversarial N = 6, M = 4 problem.  Returns the
    launches of the timed runs and, by row label, each run (its final state,
    metrics and seconds), seed 0 of phase 12's batches."""
    import dataclasses

    import numpy as np

    from repro_torch.core.bandits import ChannelAwareAsync, LyapunovSched, MExp3, RandomScheduler
    from repro_torch.fl import AsyncFLTrainer

    line(f"  fig3/4 cut: one seed a row, {FIG3_ROUNDS} rounds (the JAX benchmark's 8 seeds a "
         f"row run through the batched FL engine in phase 12)")
    counted, runs = [], {}
    for kind in ("piecewise", "adversarial"):
        S = (fig3_setup(torch, seed) if kind == "piecewise"
             else fig3_setup(torch, seed, n=6, m=4, adversarial=True))
        n, m, rounds = S["n"], S["m"], S["rounds"]
        rows = [("random", RandomScheduler(n, m), False),
                ("channel-aware", ChannelAwareAsync(n, m), False),
                ("lyapunov", LyapunovSched(n, m), False)]
        if kind == "adversarial":
            rows += [("m-exp3", MExp3(n, m, share_alpha=1e-3), False),
                     ("m-exp3+aware", MExp3(n, m, share_alpha=1e-3), True)]
        for name, sched, match in rows:
            label = f"fig3 {kind}/{name}"
            R = dict(S, sched=sched, cfg=dataclasses.replace(S["cfg"], use_matching=match,
                                                             use_zeta=match))
            fig3_reference(torch, R, label)
            tr = AsyncFLTrainer(R["cfg"], sched, R["env"], R["loss_fn"])
            reset_launches()
            (state, mets), secs = timed_run(torch, lambda: tr.run(
                tr.init(R["params"]), R["bx"], R["by"], uniforms=R["uniforms"]))
            counted.append(read_launches())
            runs[f"{kind}/{name}"] = dict(state=state, mets=mets, secs=secs)
            check(counted[-1]["weighted_aggregate"] == rounds and counted[-1]["glr_step"] == 0,
                  f"{label}: launches {counted[-1]}, expected weighted_aggregate {rounds} times")
            acc = R["accuracy"](state)
            var = float(mets["aoi_var"].sum())
            check(bool(torch.isfinite(mets["local_loss"]).all()) and np.isfinite(acc)
                  and np.isfinite(var), f"{label}: loss, accuracy or AoI variance not finite")
            line(f"  {label}: N={n} M={m} matching={match} rounds={rounds} test_acc={acc:.4f} "
                 f"cum_aoi_var={var:.2f} seconds/round={secs / rounds:.6f} "
                 f"weighted_aggregate.launches={counted[-1]['weighted_aggregate']}")
            if name == "m-exp3+aware":     # from round 0: the table ends at round 150
                profile_window(torch, label, lambda: tr.run(
                    tr.init(R["params"]), R["bx"][:10], R["by"][:10],
                    uniforms=R["uniforms"][:10]), 10)
        del S
    return {k: sum(p[k] for p in counted) for k in COUNTERS}, runs


def baselines(torch, seed):
    """Phase 9: the paper's baseline rows on the card.  Returns the launches
    of the timed runs (every kernel of the slice must show one), Fig. 2a's
    runs at the cut, by row, and Fig. 3/4's runs, by row."""
    t0 = time.perf_counter()
    fig2a_launches, refs = fig2a_rows(torch, seed)
    fig34_launches, fig34_runs = fig34_rows(torch, seed)
    paths = (fig2a_launches, fig34_launches)
    launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
    check(all(launches[k] > 0 for k in ("regret_scan", "glr_step", "weighted_aggregate")),
          f"phase 9: a kernel of the slice never launched: {launches}")
    line(f"  phase 9 launches: regret_scan {launches['regret_scan']}, glr_step "
         f"{launches['glr_step']}, weighted_aggregate {launches['weighted_aggregate']}; "
         f"wall {time.perf_counter() - t0:.1f} s")
    return launches, refs, fig34_runs


# ---------------------------------------------------------------------------
# phase 10: the batched engine at the figures' sizes
# ---------------------------------------------------------------------------

def run_of(out, i):
    """Run ``i`` of a batched result: its tensors and final state."""
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: x[i] if hasattr(x, "dim") and x.dim() else x, out)


def same_run(torch, got, want, label, rounds=None):
    """Every output of two runs bit for bit (the variance sums too), the
    final policy state where both have it; with ``rounds`` only the first
    rounds of the schedule and the curves.  Returns the largest absolute
    difference over the outputs compared (0.0 when they pass)."""
    keys = [k for k, v in want.items() if hasattr(v, "dim") and k in got]
    if rounds is not None:
        keys = [k for k in ("channels", "regret", "cum_aoi_var") if k in want]
    err = 0.0
    for k in keys:
        a, b = got[k], want[k]
        if rounds is not None:
            a, b = a[:rounds], b[:rounds]
        if a.shape == b.shape and a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
        check(torch.equal(a, b), f"{label}: {k} differs")
    if rounds is None and "final_sched_state" in want and "final_sched_state" in got:
        for f in want["final_sched_state"]._fields:
            a, b = getattr(got["final_sched_state"], f), getattr(want["final_sched_state"], f)
            if hasattr(b, "dim"):
                check(torch.equal(a, b), f"{label}: final state {f} differs")
    return err


def batched_engine(torch, seed, chain_us, fig2a_refs):
    """Phase 10: the batched engine (``repro_torch.sim``) driven as the JAX
    benchmark's figures drive theirs (``benchmarks/run.py``), every batch
    against its serial runs.  Returns the launches of the batched runs (the
    serial comparisons excluded) and the kernels line's batch fields."""
    import math

    from repro_torch.core.bandits import GLRCUCB, MExp3
    from repro_torch.core.channels import (random_adversarial_env, random_piecewise_env,
                                           stack_envs)
    from repro_torch.core.regret import simulate_aoi_regret
    from repro_torch.kernels.regret_scan import occupancy, regret_scan
    from repro_torch.sim import SweepCase, simulate_aoi_regret_batch, sweep

    t_start = time.perf_counter()
    n, m, T = 5, 2, FIG2_ROUNDS
    sched = GLRCUCB(n, m, history=1024, detector_stride=5)
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    counted = []

    def counted_run(fn):
        reset_launches()
        out, secs = timed_run(torch, fn)
        counted.append(read_launches())
        return out, secs, counted[-1]

    def serial(s, env, rounds, u):
        return timed_run(torch, lambda: simulate_aoi_regret(s, env, rounds, uniforms=u,
                                                            return_state=True))

    # (a) fig2c on the scan route's policy: 24 seeds, each its own env and uniforms
    b = FIG2C_SEEDS
    envs = [random_piecewise_env(gen, n, T, 5) for _ in range(b)]
    u = torch.rand((b, T, 2, n), generator=gen, device="cuda")
    out, secs, got = counted_run(lambda: simulate_aoi_regret_batch(
        sched, stack_envs(envs), T, uniforms=u, return_state=True))
    check(out["route"] == "scan" and got["regret_scan"] == 1 and got["glr_step"] == 0,
          f"phase 10 (a): route {out['route']}, launches {got}; expected one regret_scan")
    serial_s = 0.0
    for i in range(b):
        want, s_i = serial(sched, envs[i], T, u[i])
        serial_s += s_i
        same_run(torch, run_of(out, i), want, f"phase 10 (a) seed {i}")
    fig2c = dict(b=b, ms=secs * 1e3, serial_ms=serial_s * 1e3)
    line(f"  (a) fig2c glr-cucb: {b} seeds x T={T} in one regret_scan launch, "
         f"{secs * 1e3:.3f} ms ({secs * 1e3 / (b * T):.3e} ms a run-round) against {b} "
         f"single-run launches {serial_s * 1e3:.3f} ms ({serial_s / secs:.1f}x); restarts "
         f"{out['restarts'].tolist()}; each run equals its single-run scan bit for bit ok")

    # (b) hp_grid: the 16-point gamma x delta grid as one sweep bucket
    env = random_piecewise_env(gen, n, T, 5)
    cases = [SweepCase(f"g{g}/d{d}", sched.replace_traced(gamma=g, delta=d), env, seed, T)
             for g in HP_GAMMAS for d in HP_DELTAS]
    (results, report), secs, got = counted_run(lambda: sweep(cases, collect_curve=False))
    check(len(report) == 1 and report[0].route == "scan" and got["regret_scan"] == 1,
          f"phase 10 (b): {len(report)} buckets, launches {got}; expected one regret_scan")
    for c in cases:
        want = simulate_aoi_regret(c.scheduler, env, T, uniforms=c.draw_uniforms("cuda"),
                                   collect_curve=False)
        same_run(torch, results[c.name], want, f"phase 10 (b) {c.name}")
    best = min(cases, key=lambda c: float(results[c.name]["final_regret"]))
    line(f"  (b) hp_grid: {len(cases)} points gamma x delta, T={T}, one bucket, one regret_scan "
         f"launch, {secs * 1e3:.3f} ms (bucket wall {report[0].wall_s * 1e3:.3f} ms, kernels "
         f"built {report[0].compile_s:.3f} s); best {best.name} regret "
         f"{float(results[best.name]['final_regret']):.0f}; every point equals its serial run ok")

    # (c) the fill of the card: B runs on one shared env
    occ = occupancy(sched, "segments")
    in_flight = occ * torch.cuda.get_device_properties(0).multi_processor_count
    u_all = torch.rand((max(FILL_BATCHES), T, 2, n), generator=gen, device="cuda")
    fill = []
    for bb in FILL_BATCHES:
        ub = u_all[:bb]
        out, secs, got = counted_run(lambda: simulate_aoi_regret_batch(
            sched, env, T, uniforms=ub, env_axis=None, collect_curve=False))
        check(out["route"] == "scan" and got["regret_scan"] == 1,
              f"phase 10 (c) B={bb}: launches {got}")
        splits = int(regret_scan.splits.sum())
        for i in sorted({0, bb - 1}):
            want, _ = serial(sched, env, T, ub[i])
            for k in ("final_regret", "final_cum_aoi_var", "restarts", "aoi_pi"):
                check(torch.equal(out[k][i], want[k]), f"phase 10 (c) B={bb} run {i}: {k}")
        kc = scan_cost(sched, T, runs=bb, splits=splits)
        bound, bound_by = kc.bound_ms, kc.bound_by
        chain = math.ceil(bb / in_flight) * T * chain_us / 1e3
        fill.append(dict(b=bb, ms=secs * 1e3, ms_per_run_round=secs * 1e3 / (bb * T),
                         bound_ms=bound, bound_by=bound_by, splits=splits))
        line(f"  (c) fill B={bb}: {secs * 1e3:.3f} ms a launch, {secs * 1e3 / (bb * T):.3e} ms a "
             f"run-round; bound {bound:.3e} ms ({bound_by}: {splits} splits), latency chain "
             f"ceil({bb}/{in_flight}) x {T} x {chain_us:.3f} us = {chain:.3f} ms; runs 0 and "
             f"{bb - 1} equal their single-run scans ok")
    line(f"  (c) occupancy: {occ} block(s) of {1024} threads an SM for N={n}, H=1024 "
         f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), {in_flight} in flight: a batch past "
         f"{in_flight} runs in waves")
    del u_all

    # (d) fig2c for M-Exp3 on the batched per-round route
    cut, m_ms = FIG2A_ROUNDS_CUT, {}
    for nn in (4, 5, 6, 7):
        s = MExp3(nn, m, gamma=0.5)
        envs = [random_adversarial_env(gen, nn, cut, flip_prob=0.002) for _ in range(b)]
        u = torch.rand((cut, 2, nn), generator=gen, device="cuda")      # one stream, as JAX's
        out, secs, got = counted_run(lambda: simulate_aoi_regret_batch(
            s, stack_envs(envs), cut, uniforms=u, uniforms_axis=None))
        check(out["route"] == "rounds" and got["regret_scan"] == 0,
              f"phase 10 (d) N={nn}: route {out['route']}")
        for i in (0, b - 1):
            want, _ = serial(s, envs[i], FIG2A_REF_ROUNDS, u[:FIG2A_REF_ROUNDS])
            same_run(torch, run_of(out, i), want, f"phase 10 (d) N={nn} seed {i}",
                     rounds=FIG2A_REF_ROUNDS)
        m_ms[nn] = secs * 1e3 / cut
        line(f"  (d) fig2c m-exp3 N={nn} |C|={s.n_super_arms}: {b} seeds x T={cut} (cut) on the "
             f"batched per-round route, {m_ms[nn]:.4f} ms a round for the batch; regret "
             f"{float(out['final_regret'].mean()):.0f} +- {float(out['final_regret'].std()):.0f}; "
             f"seeds 0 and {b - 1} equal their serial runs over {FIG2A_REF_ROUNDS} rounds ok")
    line(f"  (d) against phase 9's serial m-exp3 rows (N=5, M=2, T={cut}, one run): piecewise "
         f"{fig2a_refs['fig2a piecewise/m-exp3']['ms_round']:.4f}, adversarial (share 1e-3) "
         f"{fig2a_refs['fig2a adversarial/m-exp3']['ms_round']:.4f} ms a round")

    # (e) fig2a as one sweep: fifteen rows x 4 seeds at the cut; seed 0 is phase 9's run
    cases = []
    for label, ref_row in fig2a_refs.items():
        kind, name = label.split(" ")[1].split("/")
        s = dict(fig2a_policies(n, m, kind == "adversarial"))[name]
        cases.append(SweepCase(f"{label}#0", s, ref_row["env"], 0, cut, uniforms=ref_row["u"]))
        for j in range(1, FIG2A_SEEDS):
            e = (random_piecewise_env(gen, n, cut, 5) if kind == "piecewise"
                 else random_adversarial_env(gen, n, cut, flip_prob=0.002))
            cases.append(SweepCase(f"{label}#{j}", s, e, seed * 100 + j, cut))
    (results, report), secs, got = counted_run(lambda: sweep(cases))
    for label, ref_row in fig2a_refs.items():
        want = ref_row["out"]
        got_row = results[f"{label}#0"]
        for k in ("channels", "regret", "aoi_pi", "aoi_star", "restarts", "exploit_rounds"):
            if k in want:
                check(torch.equal(got_row[k], want[k]), f"phase 10 (e) {label}: {k} differs "
                      "from phase 9's run")
    for r in report:
        line(f"  (e) bucket {r.names[0].rsplit('#', 1)[0]}: {r.batch} cases, route {r.route}, "
             f"wall {r.wall_s * 1e3:.1f} ms ({r.wall_s * 1e3 / cut:.4f} ms a round)")
    check(len(report) == 15 and got["regret_scan"] == 3,
          f"phase 10 (e): {len(report)} buckets, launches {got}")
    line(f"  (e) fig2a sweep: {len(cases)} cases in {len(report)} buckets, {secs:.1f} s; "
         f"launches regret_scan {got['regret_scan']}, glr_step {got['glr_step']}; every row's "
         f"seed 0 equals phase 9's run ok")

    # (f) a recompute-detector bucket of 8 seeds on the scan
    rec = GLRCUCB(n, m, history=1024, detector_stride=5, detector_impl="recompute")
    cases = [SweepCase(f"r{i}", rec, random_piecewise_env(gen, n, T, 5), seed * 100 + 50 + i, T)
             for i in range(RECOMPUTE_SEEDS)]
    (results, report), secs, got = counted_run(lambda: sweep(cases))
    check(len(report) == 1 and report[0].route == "scan" and got["regret_scan"] == 1
          and got["glr_scan"] == 0, f"phase 10 (f): launches {got}")
    for c in cases:
        want, _ = serial(rec, c.env, T, c.draw_uniforms("cuda"))
        same_run(torch, results[c.name], {k: v for k, v in want.items()
                                          if k != "final_sched_state"}, f"phase 10 (f) {c.name}")
    line(f"  (f) recompute bucket: {len(cases)} seeds x T={T}, one regret_scan launch, "
         f"{secs * 1e3:.3f} ms; each run equals its serial run ok")

    # (g) sweep(shard=True) on the one card equals sweep(), an uneven bucket of 5
    cases = [SweepCase(f"s{i}", sched.replace_traced(delta=d), env, seed + i, cut)
             for i, d in enumerate((1e-4, 1e-3, 1e-2, 5e-2, 1e-1))]
    plain, _ = sweep(cases)
    (sharded, report), _, got = counted_run(lambda: sweep(cases, shard=True))
    check(report[0].sharded and report[0].batch == SHARD_BATCH, "phase 10 (g): not sharded")
    for c in cases:
        same_run(torch, sharded[c.name], plain[c.name], f"phase 10 (g) {c.name}")
    line(f"  (g) sweep(shard=True) on a 1-device mesh: a bucket of {SHARD_BATCH} equals sweep() "
         f"bit for bit ok")

    launches = {k: sum(c[k] for c in counted) for k in COUNTERS}
    check(launches["regret_scan"] > 0 and launches["glr_step"] > 0,
          f"phase 10: a kernel of the slice never launched: {launches}")
    line(f"  phase 10 launches: regret_scan {launches['regret_scan']}, glr_step "
         f"{launches['glr_step']}; wall {time.perf_counter() - t_start:.1f} s")
    return launches, dict(fig2c=fig2c, fill=fill, occupancy=occ, in_flight=in_flight,
                          chain_us=chain_us, mexp3_ms_per_round=m_ms,
                          launches=launches["regret_scan"])


# ---------------------------------------------------------------------------
# phase 11: the non-stationary channel families and the closed-loop form
# ---------------------------------------------------------------------------

def scenario_suite_cases(sched, seed):
    """``benchmarks/run.py:513-521``'s 12 scenarios (four table families)
    x ``SCEN_SEEDS`` seeds at T = ``SCEN_ROUNDS``: (scenarios, cases)."""
    from repro_torch.core.channels import (GilbertElliottProcess, JammingOverlay,
                                           MobilityDriftProcess, PiecewiseProcess,
                                           ShadowingProcess)
    from repro_torch.sim import SweepCase

    n, t = SCEN_N, SCEN_ROUNDS
    scenarios = ([(f"ge/{v}", GilbertElliottProcess(n, t, p_gb=v)) for v in (0.02, 0.05, 0.15)]
                 + [(f"mobility/{v}", MobilityDriftProcess(n, t, amplitude=v))
                    for v in (0.15, 0.3, 0.45)]
                 + [(f"shadowing/{v}", ShadowingProcess(n, t, rho=v)) for v in (0.85, 0.92, 0.97)]
                 + [(f"jam/{v}", JammingOverlay(base=PiecewiseProcess(n, t, 3), strength=v))
                    for v in (0.5, 0.8, 1.0)])
    cases = [SweepCase(f"{name}/s{i}", sched, p, seed * 1000 + 900 + 37 * j + i, t)
             for j, (name, p) in enumerate(scenarios) for i in range(SCEN_SEEDS)]
    return scenarios, cases


def family_firsts(cases):
    """The first case of each family (seed 0 of its first scenario)."""
    firsts = {}
    for c in cases:
        firsts.setdefault(c.env.FAMILY, c)
    return list(firsts.values())


def realized(case, dev):
    """A process case's env, realized as the sweep realizes it."""
    from repro_torch.core.channels import scenario_realize_generator

    return case.env.realize(scenario_realize_generator(case.seed, dev), dev)


def family_runs(torch, sched, cases, results, label, rounds=None, **kw):
    """The first case of each family run alone (``kw``: the route) from the
    case's own realization and uniforms, equal to its row of ``results``;
    with ``rounds``, its first ``rounds`` rounds only, equal to the default
    route's run of those rounds."""
    from repro_torch.core.channels import scenario_realize_generator
    from repro_torch.core.regret import simulate_aoi_regret

    for c in family_firsts(cases):
        t = rounds or c.horizon
        run = lambda **k: simulate_aoi_regret(
            sched, c.env, t, uniforms=c.draw_uniforms("cuda")[:t],
            generator=scenario_realize_generator(c.seed, "cuda"), collect_curve=False, **k)
        want = run(**kw)
        same_run(torch, results[c.name] if rounds is None else run(), want, f"{label} {c.name}")


def channel_families(torch, seed, fig2_env, fig2_u, chain_us):
    """Phase 11: the scenario and chaos suites' regret runs and Fig. 2's and
    Fig. 3's paths on the non-stationary families and the reactive form.
    Returns the launches of the main-path runs (the reference runs
    excluded) and the kernels line's reactive fields."""
    import math

    from repro_torch.core.bandits import GLRCUCB, MExp3
    from repro_torch.core.channels import (GilbertElliottProcess, JammingOverlay,
                                           PiecewiseProcess, ReactiveJammerProcess,
                                           make_scenario, registered_scenarios,
                                           scenario_realize_generator)
    from repro_torch.core.regret import simulate_aoi_regret
    from repro_torch.fl import AsyncFLTrainer
    from repro_torch.kernels.regret_scan import occupancy, regret_scan
    from repro_torch.kernels.regret_scan import REACT_FLOPS
    from repro_torch.sim import SweepCase, sweep

    t_start, dev = time.perf_counter(), torch.device("cuda")
    counted = []

    def counted_run(fn):
        reset_launches()
        out, secs = timed_run(torch, fn)
        counted.append(read_launches())
        return out, secs, counted[-1]

    line(f"  families registered: {sorted(registered_scenarios())}")
    # realization time of each family (the shadowing AR(1) is a loop of T rounds)
    mexp3 = MExp3(SCEN_N, SCEN_M, gamma=0.5, share_alpha=1e-3)
    scenarios, cases = scenario_suite_cases(mexp3, seed)
    for c in family_firsts(cases):
        realized(c, dev)                                    # warm
        env, secs = timed_run(torch, lambda: realized(c, dev))
        check(env.table.shape == (SCEN_ROUNDS, SCEN_N) and bool(
            ((env.table >= 0) & (env.table <= 1)).all()), f"phase 11: {c.name} realization")
        line(f"  realization {c.env.FAMILY}: T={SCEN_ROUNDS} N={SCEN_N} {secs * 1e3:.3f} ms")

    # (a) scenario_suite: M-Exp3 on the 96 cases, one bucket on the batched rounds route
    (results, report), secs, got = counted_run(lambda: sweep(cases, collect_curve=False))
    check(len(report) == 1 and report[0].route == "rounds" and report[0].batch == len(cases)
          and got["regret_scan"] == 0, f"phase 11 (a): {len(report)} buckets, launches {got}")
    family_runs(torch, mexp3, cases, results, "phase 11 (a)")
    line(f"  (a) scenario_suite m-exp3: {len(cases)} cases ({len(scenarios)} scenarios x "
         f"{SCEN_SEEDS} seeds, T={SCEN_ROUNDS}) in one bucket on the batched rounds route, "
         f"{report[0].wall_s * 1e3 / SCEN_ROUNDS:.4f} ms a round for the bucket "
         f"({report[0].wall_s:.3f} s; {secs:.3f} s with the 96 realizations); the first case of "
         f"each family equals its serial run bit for bit ok")
    for name, _ in scenarios:
        vals = torch.stack([results[f"{name}/s{i}"]["final_regret"] for i in range(SCEN_SEEDS)])
        line(f"    (a) {name}: regret {float(vals.mean()):.0f} +- {float(vals.std()):.0f}")

    # (b) scenario_suite_glr: GLR-CUCB on the same 96 cases, one regret_scan launch
    glr = GLRCUCB(SCEN_N, SCEN_M, history=512, detector_stride=5)
    _, cases = scenario_suite_cases(glr, seed)
    (results, report), secs, got = counted_run(lambda: sweep(cases, collect_curve=False))
    check(len(report) == 1 and report[0].route == "scan" and got["regret_scan"] == 1
          and got["glr_step"] == 0, f"phase 11 (b): {len(report)} buckets, launches {got}")
    b_ms = report[0].wall_s * 1e3
    for c in cases:
        want = simulate_aoi_regret(glr, realized(c, dev), SCEN_ROUNDS,
                                   uniforms=c.draw_uniforms(dev), collect_curve=False)
        same_run(torch, results[c.name], want, f"phase 11 (b) {c.name}")
    family_runs(torch, glr, cases, results, "phase 11 (b) rounds route", FAMILY_REF_ROUNDS,
                impl="rounds")
    line(f"  (b) scenario_suite_glr glr-cucb(H=512, stride 5): {len(cases)} cases in one "
         f"regret_scan launch (table template), {b_ms:.3f} ms a launch "
         f"({b_ms / (len(cases) * SCEN_ROUNDS):.3e} ms a run-round); every row equals its "
         f"single-run scan, the first case of each family the rounds route over its first "
         f"{FAMILY_REF_ROUNDS} rounds (cut), bit for bit ok")

    # (c) chaos_suite's regret half: the reactive grid in one launch of the reactive template
    chaos = GLRCUCB(CHAOS_N, CHAOS_M, history=256, detector_stride=5)
    base = PiecewiseProcess(CHAOS_N, CHAOS_ROUNDS, 4)
    procs = ([(f"reactive-jam/{v}", make_scenario("reactive_jammer", base=base, strength=v))
              for v in (0.6, 0.9)]
             + [(f"congestion/{v}", make_scenario("congestion", n_channels=CHAOS_N,
                                                  horizon=CHAOS_ROUNDS, severity=v))
                for v in (0.4, 0.8)])
    cases = [SweepCase(name, chaos, p, seed * 1000 + 300 + i, CHAOS_ROUNDS)
             for i, (name, p) in enumerate(procs)]
    (results, report), secs, got = counted_run(lambda: sweep(cases, collect_curve=False))
    check(len(report) == 1 and report[0].route == "scan" and got["regret_scan"] == 1
          and got["regret_scan_reactive"] == 1,
          f"phase 11 (c): {len(report)} buckets, launches {got}")
    c_ms = report[0].wall_s * 1e3
    for name, _ in procs:
        o = results[name]
        line(f"    (c) chaos/{name}: regret {float(o['final_regret']):.0f} restarts "
             f"{int(o['restarts'])} success_rate {float(o['success_rate']):.4f}")
    (one, _), _, got = counted_run(lambda: sweep([SweepCase("one", chaos, cases[0].env,
                                                            cases[0].seed, CHAOS_ROUNDS)],
                                                 collect_curve=False))
    check(got["regret_scan_reactive"] == 1, f"phase 11 (c) batch of 1: launches {got}")
    family_runs(torch, chaos, cases[:1], {cases[0].name: one["one"]}, "phase 11 (c) batch of 1")
    family_runs(torch, chaos, cases, results, "phase 11 (c) rounds route", FAMILY_REF_ROUNDS,
                impl="rounds")
    react = make_scenario("reactive_jammer", base=base, strength=0.9)
    openl = JammingOverlay(base=base, horizon=CHAOS_ROUNDS, strength=0.9)
    u_c = cases[1].draw_uniforms(dev)
    (rr, ro), _, got = counted_run(lambda: [simulate_aoi_regret(
        chaos, p, CHAOS_ROUNDS, uniforms=u_c, generator=scenario_realize_generator(seed, dev),
        collect_curve=False) for p in (react, openl)])
    check(got["regret_scan"] == 2 and got["regret_scan_reactive"] == 1,
          f"phase 11 (c) reactive vs open loop: launches {got}")
    check(int(rr["restarts"]) != int(ro["restarts"])
          and float(rr["final_regret"]) != float(ro["final_regret"]),
          f"phase 11 (c): the reactive jammer did not shift scheduling against the matched "
          f"open loop (restarts {int(rr['restarts'])} / {int(ro['restarts'])}, regret "
          f"{float(rr['final_regret'])} / {float(ro['final_regret'])})")
    line(f"  (c) chaos regret half glr-cucb(N={CHAOS_N}, M={CHAOS_M}, H=256, stride 5), "
         f"T={CHAOS_ROUNDS}: {len(cases)} reactive cases in one bucket, one launch of the "
         f"reactive template, {c_ms:.3f} ms; batch of 1 equals serial; reactive-jam/0.6 and "
         f"congestion/0.4 equal the rounds route over their first {FAMILY_REF_ROUNDS} rounds "
         f"(cut), bit for bit ok")
    line(f"  (c) reactive vs matched open loop (strength 0.9, one base and seed): reactive "
         f"regret {float(rr['final_regret']):.0f} restarts {int(rr['restarts'])}, open-loop "
         f"regret {float(ro['final_regret']):.0f} restarts {int(ro['restarts'])}: both differ ok")

    # (d) Fig. 2's size on a reactive env: phase 3's piecewise env as the jammer's base
    fig2 = GLRCUCB(5, 2, history=1024, detector_stride=5)
    jam = ReactiveJammerProcess(base=PiecewiseProcess(5, FIG2_ROUNDS, 5), strength=0.9)
    renv = jam._from_draws(dict(base=fig2_env), dev)
    run = lambda env: simulate_aoi_regret(fig2, env, FIG2_ROUNDS, uniforms=fig2_u,
                                          return_state=True)
    timed_run(torch, lambda: run(renv))                         # warm
    ms = {}
    for label, env in (("open1", fig2_env), ("react1", renv), ("react2", renv),
                       ("open2", fig2_env)):
        out, secs, got = counted_run(lambda: run(env))
        check(got["regret_scan"] == 1 and got["glr_step"] == 0
              and got["regret_scan_reactive"] == (env is renv),
              f"phase 11 (d) {label}: launches {got}")
        ms[label] = secs * 1e3
        if env is renv:
            r_out, splits = out, int(regret_scan.splits.sum())
    want, ref_s = timed_run(torch, lambda: simulate_aoi_regret(
        fig2, renv, REACT_REF_ROUNDS, uniforms=fig2_u[:REACT_REF_ROUNDS], impl="rounds"))
    r_err = same_run(torch, r_out, want, "phase 11 (d) first rounds", rounds=REACT_REF_ROUNDS)
    react_ms = min(ms["react1"], ms["react2"])
    kc = scan_cost(fig2, FIG2_ROUNDS, splits=splits, reactive=True)
    bound, bound_by = kc.bound_ms, kc.bound_by
    chain = FIG2_ROUNDS * chain_us / 1e3
    occ = {f: occupancy(fig2, f) for f in ("segments", "table", "reactive")}
    line(f"  (d) fig2 reactive scan: reactive_jammer(strength 0.9) over phase 3's env, T="
         f"{FIG2_ROUNDS}: {ms['react1']:.3f} / {ms['react2']:.3f} ms a run "
         f"({react_ms / FIG2_ROUNDS:.6f} ms/round) against the open-loop scan on phase 3's env "
         f"{ms['open1']:.3f} / {ms['open2']:.3f} ms ({min(ms['open1'], ms['open2']) / FIG2_ROUNDS:.6f}"
         f" ms/round), turns open, reactive, reactive, open; regret "
         f"{float(r_out['final_regret']):.0f} restarts {int(r_out['restarts'])}")
    line(f"  (d) its first {REACT_REF_ROUNDS} rounds equal the rounds route bit for bit ok "
         f"({ref_s * 1e3 / REACT_REF_ROUNDS:.4f} ms/round there); bound {bound:.3e} ms "
         f"({bound_by}: {splits} splits, {REACT_FLOPS} flops a channel-round), latency chain "
         f"T x {chain_us:.3f} us = {chain:.3f} ms (phase 3's open-loop chain); occupancy "
         f"{occ} block(s) an SM")
    check(occ["reactive"] == occ["segments"] == occ["table"],
          f"phase 11 (d): the templates' occupancies differ: {occ}")

    # (e) the FL path: phase 4's trainer on a reactive jammer, and on an unrealized
    # Gilbert-Elliott process realized by the trainer itself
    S = fig3_setup(torch, seed)
    rounds = S["rounds"]
    fl = {}
    rj_env = ReactiveJammerProcess(base=PiecewiseProcess(S["n"], rounds, 4), strength=0.9) \
        ._from_draws(dict(base=S["env"]), dev)
    ge = GilbertElliottProcess(S["n"], rounds)
    ge_gen = lambda: torch.Generator(device="cuda").manual_seed(seed + 11)
    for label, env, kw in (("reactive_jammer", rj_env, {}),
                           ("gilbert_elliott unrealized", ge, dict(realize_generator=ge_gen()))):
        tr = AsyncFLTrainer(S["cfg"], S["sched"], env, S["loss_fn"], **kw)
        if kw:
            check(tr.scenario is ge and torch.equal(tr.env.table, ge.realize(ge_gen()).table),
                  "phase 11 (e): the trainer's realization differs from the process's")
        fig3_reference(torch, dict(S, env=tr.env), f"fig3 {label}")
        (state, mets), secs, got = counted_run(lambda: tr.run(
            tr.init(S["params"]), S["bx"], S["by"], uniforms=S["uniforms"]))
        check(got["glr_step"] == rounds and got["weighted_aggregate"] == rounds,
              f"phase 11 (e) {label}: launches {got}")
        acc = S["accuracy"](state)
        check(bool(torch.isfinite(mets["local_loss"]).all()), f"phase 11 (e) {label}: loss")
        load = float(state.env_state.sum())
        check((load > 0) == (env is rj_env), f"phase 11 (e) {label}: interaction carry {load}")
        fl[label] = secs / rounds
        line(f"  (e) fig3 {label}: N={S['n']} M={S['m']} rounds={rounds} test_acc={acc:.4f} "
             f"n_success total={float(mets['n_success'].sum()):.0f} seconds/round="
             f"{secs / rounds:.6f} (load carry sum {load:.3f})")
    del S

    launches = {k: sum(c[k] for c in counted) for k in COUNTERS}
    check(launches["regret_scan_reactive"] > 0 and launches["glr_step"] > 0
          and launches["weighted_aggregate"] > 0,
          f"phase 11: a kernel of the slice never launched: {launches}")
    line(f"  phase 11 launches: regret_scan {launches['regret_scan']} (reactive template "
         f"{launches['regret_scan_reactive']}), glr_step {launches['glr_step']}, "
         f"weighted_aggregate {launches['weighted_aggregate']}; wall "
         f"{time.perf_counter() - t_start:.1f} s")
    return launches, dict(rounds=FIG2_ROUNDS,
                          ms=react_ms, ms_again=max(ms["react1"], ms["react2"]),
                          ms_per_round=react_ms / FIG2_ROUNDS,
                          open_loop_ms=min(ms["open1"], ms["open2"]),
                          plain_ms=ref_s * 1e3, plain_rounds=REACT_REF_ROUNDS,
                          max_abs_err=r_err, err_rounds=REACT_REF_ROUNDS,
                          bound_ms=bound, bound_by=bound_by, splits=splits,
                          occupancy=occ["reactive"], chaos_launch_ms=c_ms,
                          scenario_glr_launch_ms=b_ms, fl_seconds_per_round=fl)


# ---------------------------------------------------------------------------
# phase 12: the batched FL engine (Fig. 3/4 at 8 seeds, fl_batch, chaos FL half)
# ---------------------------------------------------------------------------

def tensor_leaves(tree, path=""):
    """(path, tensor) for every tensor of a state / metrics tree."""
    if hasattr(tree, "dim"):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tensor_leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, tuple):
        for f, v in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from tensor_leaves(v, f"{path}.{f}")


def same_tensors(torch, a, b):
    """Two trees of states and metrics equal bit for bit: the same tensor
    leaves (NaN where NaN, the sign of zero included) and round indices."""
    la, lb = list(tensor_leaves(a)), list(tensor_leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_floating_point():
            nan = torch.isnan(x)
            if not (torch.equal(nan, torch.isnan(y))
                    and torch.equal(x[~nan].view(torch.uint8), y[~nan].view(torch.uint8))):
                return False
        elif not torch.equal(x, y):
            return False
    ta = [x.t for x in (a.values() if isinstance(a, dict) else a) if hasattr(x, "_fields")]
    tb = [x.t for x in (b.values() if isinstance(b, dict) else b) if hasattr(x, "_fields")]
    return ta == tb


def same_fl_run(torch, got, want, label):
    """A run of a batch against its serial run: the discrete state (AoI,
    has_update, last_success, staleness, fault carry, bandit counts), the
    schedule's ``n_success`` and the mean AoI bit for bit; the other floats
    at JAX's multi-seed tolerances (metrics rtol 1e-6 / atol 1e-6, the rest
    of the state rtol 1e-5 / atol 1e-6).  Returns (bit for bit?, the largest
    absolute difference of a float)."""
    (gs, gm), (ws, wm) = got, want
    for f in ("aoi", "has_update", "last_success", "staleness", "fault_state"):
        check(torch.equal(getattr(gs, f), getattr(ws, f)), f"{label}: {f} differs")
    for f in ("counts", "restarts", "pulls"):
        if hasattr(ws.sched_state, f):
            check(torch.equal(getattr(gs.sched_state, f), getattr(ws.sched_state, f)),
                  f"{label}: scheduler {f} differs")
    for k in ("n_success", "mean_aoi"):
        check(torch.equal(gm[k], wm[k]), f"{label}: {k} differs")
    bitwise, worst = True, 0.0
    for (path, a), (_, b), tol in [(x, y, (1e-6, 1e-6)) for x, y in
                                   zip(tensor_leaves(gm), tensor_leaves(wm))] + \
            [(x, y, (1e-5, 1e-6)) for x, y in zip(tensor_leaves(gs), tensor_leaves(ws))]:
        same = bool(torch.equal(a, b))
        bitwise = bitwise and same
        if not same and a.is_floating_point():
            diff = float((a.double() - b.double()).abs().max())
            worst = max(worst, diff)
            check(torch.allclose(a, b, rtol=tol[0], atol=tol[1]),
                  f"{label}: {path} beyond rtol {tol[0]} / atol {tol[1]} (abs diff {diff:.2e})")
    return bitwise, worst


def fig34_batched(torch, seed, serial_runs):
    """Phase 12 (a): ``fig3_fig4_fl``'s ten rows (``benchmarks/run.py:742-786``)
    at its sizes, ``FL_SEEDS`` seeds a row as one batch, segments ending at
    ``FL_CHECKPOINTS`` with a per-seed accuracy eval at each.  Seed 0 is
    the serial run of phases 4 and 9 (same data, uniforms and model);
    seeds 1.. draw their data from the loader seeds after it and their
    uniforms from their own generator.  Returns the launches of the batched
    runs (evals excluded) and the rows' numbers."""
    import dataclasses

    import numpy as np

    from repro_torch.core.bandits import (GLRCUCB, ChannelAwareAsync, LyapunovSched, MExp3,
                                          RandomScheduler)
    from repro_torch.data import BatchedFederatedLoader
    from repro_torch.fl import AsyncFLTrainer
    from repro_torch.sim import simulate_fl_batch

    b = FL_SEEDS
    counted, rows = [], {}
    for kind in ("piecewise", "adversarial"):
        S = (fig3_setup(torch, seed) if kind == "piecewise"
             else fig3_setup(torch, seed, n=6, m=4, adversarial=True))
        n, m, rounds = S["n"], S["m"], S["rounds"]
        loader = BatchedFederatedLoader(S["cx"], S["cy"], batch_size=16, local_epochs=3,
                                        seeds=[4 + seed + i for i in range(b)])
        bx, by = loader.next_rounds(rounds)
        bx, by = torch.from_numpy(bx).cuda(), torch.from_numpy(by).to(torch.int64).cuda()
        check(torch.equal(bx[0], S["bx"]), f"phase 12 {kind}: seed 0's data is not phase 4's")
        gen = torch.Generator(device="cuda").manual_seed(seed + 12)
        u = torch.cat([S["uniforms"][None],
                       torch.rand((b - 1, rounds, 2, n), generator=gen, device="cuda")])
        table = [("random", RandomScheduler(n, m), False),
                 ("channel-aware", ChannelAwareAsync(n, m), False),
                 ("lyapunov", LyapunovSched(n, m), False)]
        if kind == "piecewise":
            table += [("glr-cucb", GLRCUCB(n, m, history=256), False),
                      ("glr-cucb+aware", GLRCUCB(n, m, history=256), True)]
        else:
            table += [("m-exp3", MExp3(n, m, share_alpha=1e-3), False),
                      ("m-exp3+aware", MExp3(n, m, share_alpha=1e-3), True)]
        for name, sched, match in table:
            label = f"{kind}/{name}"
            cfg = dataclasses.replace(S["cfg"], use_matching=match, use_zeta=match)
            tr = AsyncFLTrainer(cfg, sched, S["env"], S["loss_fn"])
            states, start, cum_var, curve, secs = tr.init_batch(S["params"], b), 0, 0.0, {}, 0.0
            seg_launches = []
            for cp in FL_CHECKPOINTS:
                reset_launches()
                (states, mets), dt = timed_run(torch, lambda: simulate_fl_batch(
                    tr, states, bx[:, start:cp], by[:, start:cp], uniforms=u[:, start:cp]))
                seg_launches.append(read_launches())
                secs += dt
                cum_var = cum_var + mets["aoi_var"].sum(1)
                seg_mets = mets if start == 0 else {k: torch.cat([seg_mets[k], v], dim=1)
                                                    for k, v in mets.items()}
                curve[cp] = S["accuracy_batch"](states.params).cpu().numpy()
                start = cp
            launches = {k: sum(p[k] for p in seg_launches) for k in COUNTERS}
            counted.append(launches)
            want = dict(weighted_aggregate=rounds, weighted_aggregate_batch=rounds,
                        glr_step=rounds if isinstance(sched, GLRCUCB) else 0)
            for k, v in want.items():
                check(launches[k] == v, f"phase 12 {label}: {k} launched {launches[k]} times "
                                        f"for the batch of {b}, expected {v}")
            if label == "piecewise/glr-cucb":
                ref_tr = AsyncFLTrainer(cfg, sched, S["env"], S["loss_fn"])
                (st, mt), ref_secs = timed_run(torch, lambda: ref_tr.run(
                    ref_tr.init(S["params"]), S["bx"], S["by"], uniforms=S["uniforms"]))
                serial = dict(state=st, mets=mt, secs=ref_secs)
            else:
                serial = serial_runs[label]
            bitwise, worst = same_fl_run(torch, (run_of(states, 0), run_of(seg_mets, 0)),
                                         (serial["state"], serial["mets"]),
                                         f"phase 12 {label} seed 0")
            acc, var = curve[rounds], cum_var.cpu().numpy()
            check(np.isfinite(acc).all() and np.isfinite(var).all()
                  and bool(torch.isfinite(seg_mets["local_loss"]).all()),
                  f"phase 12 {label}: accuracy, AoI variance or loss not finite")
            ms_round = secs / rounds * 1e3
            serial_ms = serial["secs"] / rounds * 1e3
            rows[label] = dict(acc_mean=float(acc.mean()), acc_std=float(acc.std()),
                               cum_aoi_var_mean=float(var.mean()), cum_aoi_var_std=float(var.std()),
                               ms_per_round=ms_round, ms_per_run_round=ms_round / b,
                               serial_ms_per_round=serial_ms, seed0_bitwise=bitwise,
                               seed0_max_abs_diff=worst)
            line(f"  (a) fig3/4 {label}: N={n} M={m} matching={match} seeds={b} rounds={rounds} "
                 f"acc={acc.mean():.4f}+-{acc.std():.4f} (at "
                 f"{'/'.join(str(c) for c in FL_CHECKPOINTS[:-1])}: "
                 f"{'/'.join(f'{curve[c].mean():.4f}' for c in FL_CHECKPOINTS[:-1])}) cum_aoi_var="
                 f"{var.mean():.2f}+-{var.std():.2f}; {ms_round:.4f} ms a round for the batch, "
                 f"{ms_round / b:.4f} ms a run-round, against {serial_ms:.4f} ms a round of the "
                 f"serial run ({serial_ms * b / ms_round:.2f}x the run-rounds a second); "
                 f"launches weighted_aggregate {launches['weighted_aggregate']} (batch "
                 f"{launches['weighted_aggregate_batch']}), glr_step {launches['glr_step']}; "
                 f"seed 0 equals the serial run "
                 + ("(bit for bit)" if bitwise
                    else f"(max abs diff {worst:.2e}, discrete state bitwise)"))
        del S, bx, by, u
    return {k: sum(p[k] for p in counted) for k in COUNTERS}, rows


def fl_bench_setup(torch, seed, rounds):
    """``fl_batch_bench``'s problem (``benchmarks/run.py:794-820``): M = 4,
    N = 6, the 8 -> 16 -> 10 MLP, E = 1, Bsz = 4, lr 0.1, GLR-CUCB (history
    128) on a skewed piecewise env with 2 breakpoints; the data of the
    benchmark's seeds, the weights and env drawn on the card."""
    import numpy as np

    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_piecewise
    from repro_torch.data import BatchedFederatedLoader, SyntheticClassification, \
        dirichlet_partition
    from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer

    m, n, dim, hidden, spc = 4, 6, 8, 16, 48
    ds = SyntheticClassification(m * spc * 2, n_classes=10, dim=dim, noise=1.0, seed=3 + seed)
    (trx, try_), (tex, tey) = ds.split(0.9)
    parts = dirichlet_partition(try_, m, 0.3, seed=3 + seed, min_per_client=spc)
    cx = np.stack([trx[np.resize(p, spc)] for p in parts])
    cy = np.stack([try_[np.resize(p, spc)] for p in parts])
    loader = BatchedFederatedLoader(cx, cy, batch_size=4, local_epochs=1,
                                    seeds=[4 + seed + i for i in range(FL_SEEDS)])
    bx, by = loader.next_rounds(rounds)
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    params = {"w1": torch.randn((dim, hidden), generator=gen, device="cuda") * 0.1,
              "b1": torch.zeros(hidden, device="cuda"),
              "w2": torch.randn((hidden, 10), generator=gen, device="cuda") * 0.1,
              "b2": torch.zeros(10, device="cuda")}
    means = 0.03 + (0.95 - 0.03) * torch.rand((3, n), generator=gen, device="cuda") ** 4.0
    env = make_piecewise(means, torch.linspace(0, rounds, 4, device="cuda")[1:-1].to(torch.int64))
    tex, tey = torch.from_numpy(tex).cuda(), torch.from_numpy(tey).to(torch.int64).cuda()

    def loss_fn(p, x, y):
        lg = torch.log_softmax(torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"], dim=-1)
        return -torch.gather(lg, -1, y[..., None]).mean()

    def accuracy_batch(p):
        with torch.no_grad():
            h = torch.relu(torch.matmul(tex, p["w1"]) + p["b1"][:, None])
            return ((torch.matmul(h, p["w2"]) + p["b2"][:, None]).argmax(-1) == tey).float() \
                .mean(-1)

    tr = AsyncFLTrainer(AsyncFLConfig(n_clients=m, n_channels=n, local_epochs=1, client_lr=0.1,
                                      server_lr=0.1), GLRCUCB(n, m, history=128), env, loss_fn)
    return dict(tr=tr, params=params, bx=torch.from_numpy(bx).cuda(),
                by=torch.from_numpy(by).to(torch.int64).cuda(), accuracy_batch=accuracy_batch,
                uniforms=torch.rand((FL_SEEDS, rounds, 2, n), generator=gen, device="cuda"),
                cx=cx, cy=cy)


def fl_batch_bench(torch, seed):
    """Phase 12 (b): ``fl_batch_bench``'s twin: 8 seeds x 60 rounds in
    segments of 10 with a metric sync and an accuracy eval at each, serial
    (seed by seed) against batched, best of 3 each, and the batch-of-1
    check (``simulate_fl_batch`` on one run equals ``run()`` bit for bit).
    Returns the launches of one batched pass and the numbers."""
    from repro_torch.sim import simulate_fl_batch
    from repro_torch.utils.tree import tree_map

    seg, rounds = FL_BENCH_SEGMENT, FL_BENCH_SEGMENT * FL_BENCH_SEGMENTS
    B = fl_bench_setup(torch, seed, rounds)
    tr, bx, by, u = B["tr"], B["bx"], B["by"], B["uniforms"]
    one = lambda p: tree_map(lambda x: x[None], p)

    def serial_all():
        for i in range(FL_SEEDS):
            st, cv = tr.init(B["params"]), 0.0
            for s0 in range(0, rounds, seg):
                st, mets = tr.run(st, bx[i, s0:s0 + seg], by[i, s0:s0 + seg],
                                  uniforms=u[i, s0:s0 + seg])
                cv += float(mets["aoi_var"].sum())                # a sync a segment
                float(B["accuracy_batch"](one(st.params))[0])     # the checkpoint eval

    def batched_all():
        st = tr.init_batch(B["params"], FL_SEEDS)
        cv = torch.zeros(FL_SEEDS, device="cuda")
        for s0 in range(0, rounds, seg):
            st, mets = simulate_fl_batch(tr, st, bx[:, s0:s0 + seg], by[:, s0:s0 + seg],
                                         uniforms=u[:, s0:s0 + seg])
            cv += mets["aoi_var"].sum(1)
            B["accuracy_batch"](st.params).cpu()
        return cv.cpu()

    serial_all()
    reset_launches()
    batched_all()
    launches = read_launches()
    check(launches["weighted_aggregate_batch"] == rounds and launches["glr_step"] == rounds,
          f"phase 12 (b): launches {launches}, expected {rounds} batch launches")
    serial_s = batched_s = float("inf")
    for _ in range(3):
        _, t = timed_run(torch, serial_all)
        serial_s = min(serial_s, t)
        _, t = timed_run(torch, batched_all)
        batched_s = min(batched_s, t)
    st_s, mets_s = tr.run(tr.init(B["params"]), bx[0], by[0], uniforms=u[0])
    st_1, mets_1 = simulate_fl_batch(tr, tr.init_batch(B["params"], 1), bx[:1], by[:1],
                                     uniforms=u[:1])
    batch1 = same_tensors(torch, (st_s, mets_s), (run_of(st_1, 0), run_of(mets_1, 0)))
    check(batch1, "phase 12 (b): a batch of 1 is not run() bit for bit")
    line(f"  (b) fl_batch_bench: M=4 N=6 seeds={FL_SEEDS} rounds={rounds} in segments of {seg}: "
         f"serial {serial_s:.3f} s, batched {batched_s:.3f} s (best of 3 each), speedup "
         f"{serial_s / batched_s:.2f}x; batch of 1 equals run() bit for bit: {batch1}")
    return launches, dict(serial_s=serial_s, batched_s=batched_s, speedup=serial_s / batched_s,
                          batch1_bitwise=batch1)


def chaos_fl(torch, seed):
    """Phase 12 (c): ``chaos_suite``'s FL half (``benchmarks/run.py:1136-1272``):
    the clean run and 2 attacks x 4 defenses, 2 seeds each, as one ``sweep``
    (9 buckets of 2) at its sizes (M = 6, N = 9, a 12-dim linear model, 40
    rounds), judged by JAX's containment rule on a held-out batch; then the
    burst grid, two burst schedules over one sign-flip attack with the
    coordinate median (2 buckets of 1), ``burst/0`` equal to its serial run
    bit for bit.  Returns the launches and the verdicts."""
    import numpy as np

    from repro_torch.core.aggregation import make_aggregator
    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_stationary
    from repro_torch.core.faults import make_fault
    from repro_torch.fl import AsyncFLConfig, AsyncFLTrainer
    from repro_torch.sim import FLSweepCase, sweep

    m, n, d, rounds = 6, 9, 12, CHAOS_FL_ROUNDS
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    bx = torch.randn((rounds, m, 1, 4, d), generator=gen, device="cuda")
    by = bx.sum(-1) * 0.3
    ex = torch.randn((256, d), generator=gen, device="cuda")
    ey = ex.sum(-1) * 0.3
    env = make_stationary(torch.full((n,), 0.8, device="cuda"))
    params0 = {"w": torch.full((d,), 0.5, device="cuda")}

    def loss_fn(p, x, y):
        return torch.mean((x @ p["w"] - y) ** 2)

    def mk(faults, aggregator):
        return AsyncFLTrainer(AsyncFLConfig(n_clients=m, n_channels=n),
                              GLRCUCB(n, m, history=64), env, loss_fn, faults=faults,
                              aggregator=aggregator)

    attacks = {"sign_flip": make_fault("sign_flip", rate=0.2, scale=8.0),
               "inner_product": make_fault("inner_product", rate=0.2, strength=8.0)}
    defenses = {"mean": None, "trimmed_mean": make_aggregator("trimmed_mean", trim_frac=0.34),
                "coordinate_median": make_aggregator("coordinate_median"),
                "norm_clip": make_aggregator("norm_clip", clip_norm=1.0)}
    cells = [("clean", mk(None, None))] + [(f"{a}+{dn}", mk(f, dfn)) for a, f in attacks.items()
                                           for dn, dfn in defenses.items()]
    cases = [FLSweepCase(f"byz/{name}/s{s}", tr, params0, 700 + s, bx, by)
             for name, tr in cells for s in range(2)]
    reset_launches()
    (res, report), secs = timed_run(torch, lambda: sweep(cases, collect_curve=False))
    launches = read_launches()
    check(len(report) == len(cells) and all(r.batch == 2 and r.route == "fl" for r in report),
          f"phase 12 (c): buckets {[(r.batch, r.route) for r in report]}")
    order_stat = 2 * rounds * 2       # trimmed_mean and coordinate_median, two attacks
    check(launches["robust_trimmed_batch"] == order_stat
          and launches["weighted_aggregate_batch"] == (len(cells) - 4) * rounds,
          f"phase 12 (c): launches {launches}")
    losses = {name: float(np.mean([float(loss_fn(res[f"byz/{name}/s{s}"]["state"].params, ex, ey))
                                   for s in range(2)])) for name, _ in cells}
    clean = losses["clean"]
    mean_degraded = all(not np.isfinite(losses[f"{a}+mean"]) or losses[f"{a}+mean"] >= 3 * clean
                        for a in attacks)

    def contains(dn, a):
        lo, ml = losses[f"{a}+{dn}"], losses[f"{a}+mean"]
        return np.isfinite(lo) and (not np.isfinite(ml) or lo - clean <= 0.3 * (ml - clean))

    contained = sorted(dn for dn in ("trimmed_mean", "coordinate_median", "norm_clip")
                       if all(contains(dn, a) for a in attacks))
    line(f"  (c) chaos FL half: {len(cases)} cases in {len(report)} buckets of 2, one sweep, "
         f"{secs:.3f} s ({secs / rounds * 1e3:.4f} ms a round for all buckets); eval loss "
         + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
         + f"; mean_degraded={mean_degraded} contained={','.join(contained) or 'none'} "
         f"(JAX's record: contained=norm_clip); launches robust_trimmed "
         f"{launches['robust_trimmed']} (batch {launches['robust_trimmed_batch']}), "
         f"weighted_aggregate {launches['weighted_aggregate']} "
         f"(batch {launches['weighted_aggregate_batch']})")
    check(all(np.isfinite(v) for k, v in losses.items() if not k.endswith("+mean")),
          "phase 12 (c): a defended or clean run is not finite")
    check(mean_degraded and "norm_clip" in contained,
          f"phase 12 (c): verdicts mean_degraded={mean_degraded} contained={contained}, JAX's "
          "record is mean degraded and norm_clip containing both attacks")

    base = make_fault("sign_flip", rate=0.3, scale=6.0)
    burst = [mk(make_fault("burst", base=base, p_on=0.15, p_off=0.35),
                defenses["coordinate_median"]),
             mk(make_fault("burst", base=base, p_on=0.35, p_off=0.15),
                defenses["coordinate_median"])]
    bcases = [FLSweepCase(f"burst/{i}", tr, params0, 800, bx, by) for i, tr in enumerate(burst)]
    reset_launches()
    bres, breport = sweep(bcases, collect_curve=False)
    blaunches = read_launches()
    st, mets = burst[0].run(burst[0].init(params0), bx, by,
                            generator=torch.Generator(device="cuda").manual_seed(800))
    got = bres["burst/0"]
    same = same_tensors(torch, (st, mets), (got["state"], got["metrics"]))
    finite = all(bool(torch.isfinite(c["state"].params["w"]).all()) for c in bres.values())
    check(len(breport) == 2 and same and finite,
          f"phase 12 (c) burst grid: {len(breport)} buckets, burst/0 bitwise {same}, "
          f"finite {finite}")
    line(f"  (c) burst grid: buckets={len(breport)} burst/0 equals its serial run bit for bit: "
         f"{same}; finite={finite}; robust_trimmed launches {blaunches['robust_trimmed']}")
    for k in COUNTERS:
        launches[k] += blaunches[k]
    return launches, dict(mean_degraded=mean_degraded, contained=contained, losses=losses)


def fl_sweep_checks(torch, seed):
    """Phase 12 (d): ``sweep(shard=True)`` equals ``sweep()`` on an FL bucket
    bit for bit, and a Gilbert-Elliott process bucket on phase 4's Fig. 3
    trainer (4 cases, per-case realizations from
    ``scenario_realize_generator(seed)``), each case against its own serial
    trainer.  Returns the launches of the sweeps."""
    from repro_torch.core.channels import make_scenario, scenario_realize_generator
    from repro_torch.fl import AsyncFLTrainer
    from repro_torch.sim import FLSweepCase, sweep

    B = fl_bench_setup(torch, seed, 20)
    cases = [FLSweepCase(f"sh{i}", B["tr"], B["params"], 900 + i, B["bx"][i], B["by"][i])
             for i in range(3)]
    reset_launches()
    plain, _ = sweep(cases)
    sharded, report = sweep(cases, shard=True)
    launches = read_launches()
    check(report[0].sharded and report[0].batch == 3, "phase 12 (d): not sharded")
    for c in cases:
        check(same_tensors(torch, plain[c.name], sharded[c.name]),
              f"phase 12 (d) {c.name}: sharded differs")
    line("  (d) sweep(shard=True) on an FL bucket of 3 equals sweep() bit for bit ok")

    S = fig3_setup(torch, seed)
    rounds = min(GE_FL_ROUNDS, S["rounds"])
    proc = make_scenario("gilbert_elliott", n_channels=S["n"], horizon=S["rounds"])
    tr = AsyncFLTrainer(S["cfg"], S["sched"], proc, S["loss_fn"],
                        realize_generator=scenario_realize_generator(0, "cuda"))
    gcases = [FLSweepCase(f"ge{s}", tr, S["params"], 40 + s, S["bx"][:rounds],
                          S["by"][:rounds]) for s in range(4)]
    reset_launches()
    (res, greport), secs = timed_run(torch, lambda: sweep(gcases))
    got = read_launches()
    check(len(greport) == 1 and got["weighted_aggregate_batch"] == rounds
          and got["glr_step"] == rounds, f"phase 12 (d) gilbert_elliott: {got}")
    worst = 0.0      # the largest float difference from the serial trainers
    for c in gcases[:2]:
        tr_c = AsyncFLTrainer(S["cfg"], S["sched"], proc, S["loss_fn"],
                              realize_generator=scenario_realize_generator(c.seed, "cuda"))
        want = tr_c.run(tr_c.init(S["params"]), c.batches_x, c.batches_y,
                        generator=torch.Generator(device="cuda").manual_seed(c.seed))
        _, diff = same_fl_run(torch, (res[c.name]["state"], res[c.name]["metrics"]), want,
                              f"phase 12 (d) {c.name}")
        worst = max(worst, diff)
    check(not torch.equal(res["ge0"]["metrics"]["n_success"], res["ge1"]["metrics"]["n_success"]),
          "phase 12 (d): two cases share one realization")
    line(f"  (d) gilbert_elliott FL bucket: 4 cases, one bucket, {rounds} rounds in {secs:.3f} s "
         f"({secs / rounds * 1e3:.4f} ms a round), per-case realizations; cases 0 and 1 equal "
         f"their serial trainers (max abs diff {worst:.2e}) ok")
    for k in COUNTERS:
        launches[k] += got[k]
    return launches


def batched_fl(torch, seed, serial_runs):
    """Phase 12: the batched FL engine at the JAX benchmark's sizes.
    Returns the launches of its batched runs and the numbers."""
    from repro_torch.fl import AsyncFLTrainer
    from repro_torch.sim import simulate_fl_batch

    t0 = time.perf_counter()
    a_launches, rows = fig34_batched(torch, seed, serial_runs)
    b_launches, bench = fl_batch_bench(torch, seed)
    c_launches, verdicts = chaos_fl(torch, seed)
    d_launches = fl_sweep_checks(torch, seed)
    S = fig3_setup(torch, seed)
    tr = AsyncFLTrainer(S["cfg"], S["sched"], S["env"], S["loss_fn"])
    states = tr.init_batch(S["params"], FL_SEEDS)
    bx = S["bx"][:10].expand(FL_SEEDS, *S["bx"][:10].shape)
    by = S["by"][:10].expand(FL_SEEDS, *S["by"][:10].shape)
    u = S["uniforms"][:10].expand(FL_SEEDS, *S["uniforms"][:10].shape)
    profile_window(torch, f"(e) fig3 glr-cucb+aware, a batch of {FL_SEEDS}",
                   lambda: simulate_fl_batch(tr, states, bx, by, uniforms=u), 10)
    launches = {k: a_launches[k] + b_launches[k] + c_launches[k] + d_launches[k]
                for k in COUNTERS}
    check(launches["weighted_aggregate_batch"] > 0 and launches["robust_trimmed_batch"] > 0
          and launches["glr_step"] > 0, f"phase 12: a kernel of the slice never launched: "
                                        f"{launches}")
    line(f"  phase 12 launches: weighted_aggregate {launches['weighted_aggregate']} (batch "
         f"{launches['weighted_aggregate_batch']}), robust_trimmed {launches['robust_trimmed']} "
         f"(batch {launches['robust_trimmed_batch']}), glr_step {launches['glr_step']}; wall "
         f"{time.perf_counter() - t0:.1f} s")
    return launches, dict(rows=rows, bench=bench, chaos=verdicts)


# ---------------------------------------------------------------------------
# phase 13: the sparse client axis (fl_substrate at N = 10^5)
# ---------------------------------------------------------------------------

def substrate_loss(p, x, y):
    return ((x @ p["w"] - y) ** 2).mean()


def substrate_trainer(torch, device, availability="churn", aggregator=None):
    """``fl_substrate``'s throughput trainer (``benchmarks/run.py:913-928``):
    N = 10^5 clients, M = 64 slots over 16 channels, a linear model (d =
    16), batch 4, E = 1, staleness cap 8, GLR-CUCB (history 128) on a
    stationary env, Markov churn (p_drop 0.05, p_rejoin 0.5) unless
    another ``availability`` (None: no process) is given."""
    from repro_torch.core.availability import MarkovChurn
    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_stationary
    from repro_torch.fl import SparseAsyncFLTrainer, SparseFLConfig

    if availability == "churn":
        availability = MarkovChurn(p_drop=0.05, p_rejoin=0.5)
    return SparseAsyncFLTrainer(
        SparseFLConfig(n_clients=SUB_N, n_sched=SUB_M, n_channels=SUB_NCH, batch_size=SUB_B,
                       local_epochs=1, staleness_cap=8),
        GLRCUCB(SUB_NCH, SUB_M, history=SUB_H),
        make_stationary(torch.linspace(0.9, 0.3, SUB_NCH), device=device), substrate_loss,
        device=device, availability=availability, aggregator=aggregator)


def glr_step_at(torch, shape, gen, label):
    """``glr_step`` at a path's (N, H) on {0, 1} rewards against its plain
    version: the state bitwise, the statistic at rtol 1e-5.  Returns its
    entry (error, times, bound)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.glr_step import glr_step as glr_kernel

    args = glr_inputs(torch, shape, gen, True)
    got = ops.glr_step(*args)
    want = ref.glr_step(*args)
    for g, w, name in zip(got[:3], want[:3], ("cum", "total", "base")):
        check(torch.equal(g, w), f"{label}: glr_step {shape} {name} not bitwise")
    fin = torch.isfinite(want[3])
    check(torch.equal(fin, torch.isfinite(got[3]))
          and torch.allclose(got[3][fin], want[3][fin], rtol=1e-5, atol=1e-5),
          f"{label}: glr_step {shape} statistic beyond rtol 1e-5")
    cum, total, base, counts, r_vec, sched = args
    counts_i = counts.to(torch.int32)
    gl = dict(shape=list(shape),
              max_abs_err=float((got[3][fin] - want[3][fin]).abs().max()) if bool(fin.any())
              else 0.0,
              ms=time_ms(torch, lambda: glr_kernel(cum, total, base, counts_i, r_vec, sched), 2000),
              plain_ms=time_ms(torch, lambda: ref.glr_step(*args), 200), library_ms=None)
    gl["bound_ms"], gl["bound_by"] = glr_bound_ms(torch, args, shape[-1], geometric=False)
    return gl


def substrate_kernels(torch, gen, floor_ms):
    """The Step-4 kernels and ``glr_step`` at the sparse round's shapes,
    against their plain versions (not counted as launches of the path):
    ``weighted_aggregate`` (64, 16) f32 bitwise against the row-order sum,
    ``robust_trimmed``'s median bitwise, ``glr_step`` (16, 128) on {0, 1}
    rewards bitwise in state, rtol 1e-5 in the statistic.  Returns each
    kernel's entry (error, times, bound)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import robust_agg as rt_mod
    from repro_torch.kernels import weighted_aggregate as wa_mod
    from repro_torch.kernels.robust_agg import robust_trimmed as rt_kernel
    from repro_torch.kernels.weighted_aggregate import weighted_aggregate as wa_kernel

    m, p = SUB_M, SUB_D
    upd = torch.randn((m, p), generator=gen, device="cuda")
    scale = scale_like_main_path(torch, m, gen)
    got = ops.weighted_aggregate(upd, scale)
    wa_err = float((got - ref.weighted_aggregate(upd, scale)).abs().max())
    check(torch.equal(got, row_order_sum(torch, upd, scale)),
          f"phase 13: weighted_aggregate ({m}, {p}) not bitwise the row-order sum")
    wa = dict(shape=[m, p], max_abs_err=wa_err,
              ms=time_ms(torch, lambda: wa_kernel(upd, scale), 2000),
              plain_ms=time_ms(torch, lambda: ref.weighted_aggregate(upd, scale), 2000),
              library_ms=time_ms(torch, lambda: scale @ upd, 2000))
    wa["bound_ms"], wa["bound_by"] = bound_of(wa_mod.cost((m, p), 4))

    x, mask = trim_inputs(torch, m, p, torch.float32, "random", gen)
    n = mask.sum()
    k = torch.floor((n - 1.0) / 2.0)
    got = ops.robust_trimmed(x, mask, n, k)
    want = ref.robust_trimmed(x, mask, n, k)
    check(same_bits(torch, got, want), f"phase 13: robust_trimmed ({m}, {p}) median not bitwise")
    xk = x[mask > 0.5]                                  # the participating rows
    lo, hi = (int(n) - 1) // 2, int(n) - (int(n) - 1) // 2
    rt = dict(shape=[m, p], max_abs_err=float((got - want).abs().max()),
              ms=time_ms(torch, lambda: rt_kernel(x, mask, n, k), 2000),
              plain_ms=time_ms(torch, lambda: ref.robust_trimmed(x, mask, n, k), 500),
              library_ms=time_ms(torch, lambda: torch.sort(xk, dim=0).values[lo:hi].mean(0),
                                 2000))
    rt["bound_ms"], rt["bound_by"] = bound_of(rt_mod.cost((m, p), 4, participants=int(n)))

    gl = glr_step_at(torch, (SUB_NCH, SUB_H), gen, "phase 13")
    torch.cuda.synchronize()
    for name, t in (("weighted_aggregate", wa), ("robust_trimmed", rt), ("glr_step", gl)):
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        line(f"  (0) {name} {tuple(t['shape'])} at the sparse round's shape: max_abs_err "
             f"{t['max_abs_err']:.3e} vs plain ok; kernel {t['ms']:.4f} ms, plain "
             f"{t['plain_ms']:.4f} ms, library {lib}, bound {t['bound_ms']:.2e} ms "
             f"({t['bound_by']}), launch floor {floor_ms:.5f} ms")
    return dict(weighted_aggregate=wa, robust_trimmed=rt, glr_step=gl)


def sparse_substrate(torch, seed, floor_ms):
    """Phase 13: ``fl_substrate``'s two parts (``benchmarks/run.py:888-1013``)
    and the sparse trainer's other paths.  Returns the launches of the paths
    (the comparisons with the CPU excluded), the kernels at the round's
    shapes and the numbers."""
    from repro_torch.core.aggregation import make_aggregator
    from repro_torch.core.availability import example_availability
    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_scenario
    from repro_torch.data import client_batch_indices, gather_client_batches
    from repro_torch.fl import (AsyncFLConfig, AsyncFLTrainer, SparseAsyncFLTrainer,
                                SparseFLConfig)
    from repro_torch.sim import SchedServer

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 130)
    kernels = substrate_kernels(torch, gen, floor_ms)
    paths = []

    def counted(fn):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        paths.append(read_launches())
        return out, secs, paths[-1]

    # (a) fl_substrate's throughput twin: data and randomness made on the card
    r = SUB_ROUNDS
    cx = torch.randn((SUB_N, SUB_NEX, SUB_D), generator=gen, device="cuda")
    cy = torch.randn((SUB_N, SUB_NEX), generator=gen, device="cuda")
    u = torch.rand((r, 2, SUB_NCH), generator=gen, device="cuda")
    au = torch.rand((r, 2 * SUB_N), generator=gen, device="cuda")
    params = {"w": torch.zeros(SUB_D, device="cuda")}
    tr = substrate_trainer(torch, "cuda")

    def run(trainer, state=None, rounds=r, start=0, **kw):
        k = trainer.n_avail_uniforms()
        return trainer.run(trainer.init(params) if state is None else state, cx, cy,
                           uniforms=u[start:start + rounds],
                           avail_uniforms=au[start:start + rounds, :k] if k else None,
                           data_seed=seed, **kw)

    run(tr)                                                   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (st, mets), secs, got = counted(lambda: run(tr))
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    check(got["glr_step"] == r and got["weighted_aggregate"] == r
          and got["robust_trimmed"] == 0,
          f"phase 13 (a): launches {got}; expected glr_step and weighted_aggregate {r} each")
    finite = bool(torch.isfinite(st.params["w"]).all() and torch.isfinite(mets["local_loss"]).all())
    served = int((st.aoi < r + 1).sum())
    check(finite and served > 0 and float(mets["n_success"].sum()) > 0,
          f"phase 13 (a): finite={finite}, clients served {served}")
    rps = r / secs
    line(f"  (a) fl_substrate N={SUB_N} M={SUB_M} channels={SUB_NCH} d={SUB_D} markov_churn: "
         f"{r} rounds in {secs * 1e3:.3f} ms after a warm run, {rps:.2f} rounds/s "
         f"({secs / r * 1e3:.4f} ms a round); finite={finite}, clients served {served}, "
         f"n_success {float(mets['n_success'].sum()):.0f}, available "
         f"{float(mets['n_available'].mean()):.1f} a round, evicted "
         f"{float(mets['n_evicted'].mean()):.1f} a round; peak device memory {peak_mib:.1f} MiB; "
         f"launches glr_step {got['glr_step']}, weighted_aggregate {got['weighted_aggregate']}")

    # (b) the first rounds on the card against the CPU (plain versions)
    cpu_tr = substrate_trainer(torch, "cpu")
    cx_c, cy_c, u_c, au_c = cx.cpu(), cy.cpu(), u.cpu(), au.cpu()
    s_cpu, s_card = cpu_tr.init({"w": params["w"].cpu()}), tr.init(params)
    for i in range(SUB_REF_ROUNDS):
        s_cpu, m_cpu = cpu_tr.run(s_cpu, cx_c, cy_c, uniforms=u_c[i:i + 1],
                                  avail_uniforms=au_c[i:i + 1], data_seed=seed)
        s_card, m_card = run(tr, s_card, rounds=1, start=i)
        for f in ("slot_clients", "slot_of", "avail", "aoi", "has_update", "staleness",
                  "last_success"):
            check(torch.equal(getattr(s_card, f).cpu(), getattr(s_cpu, f)),
                  f"phase 13 (b) round {i}: card {f} != CPU")
        check(torch.equal(m_card["n_success"].cpu(), m_cpu["n_success"]),
              f"phase 13 (b) round {i}: n_success")
        for name, a, b in (("w", s_card.params["w"], s_cpu.params["w"]),
                           ("buffers", s_card.buffers, s_cpu.buffers)):
            check(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5),
                  f"phase 13 (b) round {i}: {name} beyond rtol 1e-4")
    line(f"  (b) {SUB_REF_ROUNDS} rounds on the card equal the CPU run: selection, slot_of, "
         f"avail, AoI, has_update, staleness, last_success and n_success "
         f"{m_cpu['n_success'].tolist()} bit for bit; params and buffers rtol 1e-4")
    del cpu_tr, s_cpu, cx_c, cy_c, au_c

    # (c) dense-vs-sparse parity at the paper's FL size (benchmarks/run.py:943-993)
    pn, pnch, pr, pe, pb, pex = PAR_N, PAR_NCH, PAR_ROUNDS, PAR_E, PAR_B, 16
    pcx = torch.randn((pn, pex, 8), generator=gen, device="cuda")
    pcy = torch.randn((pn, pex), generator=gen, device="cuda")
    pu = torch.rand((SUB_SERVED_ROUNDS, 2, pnch), generator=gen, device="cuda")
    pp0 = {"w": torch.zeros(8, device="cuda"), "b": torch.zeros((), device="cuda")}

    def ploss(p, x, y):
        return ((x @ p["w"] + p["b"] - y) ** 2).mean()

    proc = make_scenario("piecewise", n_channels=pnch, horizon=pr, n_breakpoints=2)
    realize = lambda: torch.Generator(device="cuda").manual_seed(seed + 41)
    common = dict(local_epochs=pe, staleness_cap=3, max_update_norm=50.0)
    dense = AsyncFLTrainer(AsyncFLConfig(n_clients=pn, n_channels=pnch, **common),
                           GLRCUCB(pnch, pn, history=64), proc, ploss, realize_generator=realize())
    sparse = SparseAsyncFLTrainer(
        SparseFLConfig(n_clients=pn, n_sched=pn, n_channels=pnch, batch_size=pb, **common),
        GLRCUCB(pnch, pn, history=64), proc, ploss, realize_generator=realize())
    ids = torch.arange(pn, device="cuda")
    draws = [gather_client_batches(pcx, pcy, ids, client_batch_indices(seed, t, ids, pex, pe, pb))
             for t in range(pr)]        # the dense side replays the sparse draw
    bx, by = torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws])
    ds, dm = dense.run(dense.init(pp0), bx, by, uniforms=pu[:pr])
    (ss, sm), _, got_c = counted(lambda: sparse.run(sparse.init(pp0), pcx, pcy,
                                                    uniforms=pu[:pr], data_seed=seed))
    shared = ("params", "buffers", "has_update", "last_success", "aoi", "staleness", "contrib",
              "zeta", "contrib_buf", "sched_state", "env_state", "fault_state")
    for f in shared:
        check(same_tree(torch, getattr(ds, f), getattr(ss, f)),
              f"phase 13 (c): dense and sparse {f} differ")
    check(all(torch.equal(dm[k], sm[k]) for k in dm), "phase 13 (c): metrics differ")
    check(torch.equal(ss.slot_clients, ids) and got_c["weighted_aggregate"] == pr
          and got_c["glr_step"] == pr, f"phase 13 (c): selection or launches {got_c}")
    line(f"  (c) dense vs sparse, M=N={pn}, {pnch} channels, {pr} rounds, E={pe}, batch {pb}, "
         f"piecewise (2 breakpoints): every state leaf ({len(shared)} fields) and metric bit for "
         f"bit on the card; n_success {dm['n_success'].tolist()}")

    # (d) each availability family at (a)'s size
    fam = {}
    for name in (None, "always_on", "markov_churn", "straggler", "dropout_rejoin"):
        ftr = substrate_trainer(torch, "cuda", None if name is None else
                                example_availability(name))
        (fs, fm), fsecs, got_d = counted(lambda: run(ftr))
        check(got_d["glr_step"] == r and got_d["weighted_aggregate"] == r,
              f"phase 13 (d) {name}: launches {got_d}")
        check(bool(torch.isfinite(fs.params["w"]).all()), f"phase 13 (d) {name}: params")
        fam[name] = (fs, fm)
        line(f"  (d) availability {name or 'none'}: {r} rounds {r / fsecs:.2f} rounds/s "
             f"({fsecs / r * 1e3:.4f} ms a round); available {float(fm['n_available'].mean()):.1f} "
             f"a round (min {float(fm['n_available'].min()):.0f}), clients served "
             f"{int((fs.aoi < r + 1).sum())}, n_success {float(fm['n_success'].sum()):.0f}")
    (a_s, a_m), (n_s, n_m) = fam["always_on"], fam[None]
    for f in a_s._fields:
        if f != "avail_state":
            check(same_tree(torch, getattr(a_s, f), getattr(n_s, f)),
                  f"phase 13 (d): always_on {f} != no process")
    check(all(torch.equal(a_m[k], n_m[k]) for k in a_m), "phase 13 (d): always_on metrics")
    line("  (d) always_on equals the run without an availability process bit for bit")
    del fam, a_s, n_s

    # (e) run_served against run() on (c)'s setup
    rs = SUB_SERVED_ROUNDS
    ref_s, ref_m = sparse.run(sparse.init(pp0), pcx, pcy, uniforms=pu, data_seed=seed)
    server = SchedServer(sparse.scheduler, capacity=4, slots=2, use_matching=True,
                         matcher_beta=sparse.cfg.matcher_beta)
    server.join("job")
    (srv_s, srv_m), _, got_e = counted(lambda: sparse.run_served(
        sparse.init(pp0), pcx, pcy, server, "job", uniforms=pu, data_seed=seed))
    for f in ref_s._fields:
        if f != "sched_state":
            check(same_tree(torch, getattr(ref_s, f), getattr(srv_s, f)),
                  f"phase 13 (e): run_served {f} != run()'s")
    check(same_tree(torch, ref_s.sched_state, server.tenant_state("job").sched_state),
          "phase 13 (e): the server's tenant state != run()'s sched_state")
    check(all(torch.equal(ref_m[k], srv_m[k]) for k in ref_m), "phase 13 (e): metrics differ")
    check(got_e["glr_step_tenants"] == rs and got_e["weighted_aggregate"] == rs,
          f"phase 13 (e): launches {got_e}")
    line(f"  (e) sparse run_served: {rs} rounds equal run() bit for bit (every state leaf, the "
         f"server's tenant state, metrics); glr_step_tenants {got_e['glr_step_tenants']}, "
         f"weighted_aggregate {got_e['weighted_aggregate']}")

    # (f) (a) with a coordinate-median aggregator
    rtr = substrate_trainer(torch, "cuda", aggregator=make_aggregator("coordinate_median"))
    (rst, rm), rsecs, got_f = counted(lambda: run(rtr))
    check(got_f["robust_trimmed"] == r and got_f["weighted_aggregate"] == 0
          and got_f["glr_step"] == r, f"phase 13 (f): launches {got_f}")
    check(bool(torch.isfinite(rst.params["w"]).all()), "phase 13 (f): params not finite")
    line(f"  (f) coordinate_median: {r} rounds {r / rsecs:.2f} rounds/s ({rsecs / r * 1e3:.4f} ms "
         f"a round); robust_trimmed {got_f['robust_trimmed']}, glr_step {got_f['glr_step']}")

    # (g) a profiled 10-round window of (a)
    profile_window(torch, f"(g) fl_substrate N={SUB_N}", lambda: run(
        tr, st, rounds=SUB_PROFILE_ROUNDS), SUB_PROFILE_ROUNDS)

    launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
    check(launches["glr_step"] > 0 and launches["weighted_aggregate"] > 0
          and launches["robust_trimmed"] > 0,
          f"phase 13: a kernel of the slice never launched: {launches}")
    for name in kernels:
        kernels[name]["launches"] = launches[name]
    line(f"  phase 13 launches: glr_step {launches['glr_step']}, weighted_aggregate "
         f"{launches['weighted_aggregate']}, robust_trimmed {launches['robust_trimmed']}, "
         f"glr_step_tenants {launches['glr_step_tenants']}; wall "
         f"{time.perf_counter() - t_phase:.1f} s")
    return launches, kernels, dict(rounds_per_sec=rps, peak_mib=peak_mib, served=served)


# ---------------------------------------------------------------------------
# phase 14: the FL training path at LLM scale
# ---------------------------------------------------------------------------

def train_kernels(torch, gen, floor_ms):
    """``flash_attention``, its backward and ``glr_step`` at the training
    path's shapes against their plain versions (not counted as launches of
    the path): qwen1.5-0.5b's attention, bf16 (8, 16/16, 2048, 64) causal,
    on the tensor-core route within rtol 2**-8 / atol 1e-4 of the f32 plain
    version (phase 2's bf16 tolerance), and its gradient by the backward
    kernels (``attention_bwd_at``); ``glr_step`` (8, 128) on {0, 1}
    rewards, state bitwise, the statistic at rtol 1e-5.  Returns each
    kernel's entry (error, times, bound)."""
    from torch.nn import functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel

    cfg = get_config(TRAIN_ARCH)
    shape = (TRAIN_B, cfg.n_heads, cfg.n_kv_heads, TRAIN_S, cfg.resolved_head_dim)
    b, hq, hkv, s, d = shape
    q = (torch.randn((b, hq, s, d), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    k = (torch.randn((b, hkv, s, d), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    before = fa_kernel.tc_launches
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.mha_attention(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    check(fa_kernel.tc_launches == before + 1,
          f"phase 14 (0): flash_attention {shape} bf16 not on the tensor-core route")
    err = float((got.float() - want).abs().max())
    check(torch.allclose(got.float(), want, rtol=2.0 ** -8, atol=1e-4),
          f"phase 14 (0): flash_attention {shape} bf16 beyond rtol 2^-8 atol 1e-4 ({err:.3e})")
    del got, want
    fa = dict(shape_b_hq_hkv_s_d=list(shape), causal=True, dtype="bfloat16", max_abs_err=err,
              ms=time_ms(torch, lambda: fa_kernel(q, k, v, causal=True), 50),
              plain_ms=time_ms(torch, lambda: ref.mha_attention(q, k, v, causal=True), 3),
              library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True), 20))
    fa["bound_ms"], fa["bound_by"] = attn_bound_ms(torch, shape, True, 0, torch.bfloat16)
    del q, k, v

    gl = glr_step_at(torch, (TRAIN_CHANNELS, TRAIN_HISTORY), gen, "phase 14 (0)")
    torch.cuda.synchronize()
    line(f"  (0) flash_attention (B, Hq, Hkv, S, D)={shape} causal bf16 at the training "
         f"path's shape: max_abs_err {fa['max_abs_err']:.3e} vs f32 plain (rtol 2^-8 atol 1e-4) "
         f"ok; kernel {fa['ms']:.4f} ms, plain {fa['plain_ms']:.4f} ms, library (SDPA) "
         f"{fa['library_ms']:.4f} ms, bound {fa['bound_ms']:.4f} ms ({fa['bound_by']})")
    line(f"  (0) glr_step {tuple(gl['shape'])} at the training path's shape: max_abs_err "
         f"{gl['max_abs_err']:.3e} vs plain ok; kernel {gl['ms']:.4f} ms, plain "
         f"{gl['plain_ms']:.4f} ms, bound {gl['bound_ms']:.2e} ms ({gl['bound_by']}), launch "
         f"floor {floor_ms:.5f} ms")
    release(torch)
    bwd = attention_bwd_at(torch, gen.initial_seed() + 7, shape, True, 0, "(0)")
    return dict(flash_attention=fa, glr_step=gl, flash_attention_bwd=bwd)


def adam_step_bound(count, b1=0.9, b2=0.95):
    """The most one AdamW step moves an entry, in units of lr (weight decay
    aside): |m_hat| / sqrt(v_hat) after ``count`` steps, by Cauchy-Schwarz
    over the two moments' sums; 1 at the first step."""
    q = b1 * b1 / b2
    return ((1 - b1) / math.sqrt(1 - b2) * math.sqrt((1 - q ** count) / (1 - q))
            * math.sqrt(1 - b2 ** count) / (1 - b1 ** count))


def adam_round_close(torch, params, opt, ref_params, ref_opt, slack, lr, what, b1=0.9, b2=0.95,
                     eps=1e-8):
    """Hold one AdamW round's parameters and moments (CPU tensors) against a
    reference run's after the same round.  ``mu`` and ``nu`` within rtol 1e-4
    and atol min(1e-6, 1e-4 of the tensor's largest entry).  The parameters
    within 1e-6 + 1e-4 |p| + ``slack``: AdamW's step is scale free, so an
    entry whose gradient is rounding noise or cancels to a few thousandths of
    its terms steps by another fraction of lr in each run.  ``slack`` (an
    entry, carried over the rounds) grows each round by twice the step's
    first-order response to the two runs' moment differences (which the
    moment check bounds), lr (|dm| + |d sqrt v|) / (sqrt v + eps) with the
    bias corrections, and never by more than two steps can differ, 2 lr
    ``adam_step_bound``.  Returns the slack and the number of entries beyond
    the plain tolerance."""
    count = int(ref_opt["count"])
    check(int(opt["count"]) == count, f"{what}: count {int(opt['count'])} against {count}")
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    cap = 2 * lr * adam_step_bound(count, b1, b2)
    beyond = 0
    for k, want in ref_params.items():
        for m in ("mu", "nu"):
            got, ref = opt[m][k], ref_opt[m][k]
            atol = min(1e-6, 1e-4 * float(ref.abs().max()))
            check(bool(((got - ref).abs() <= 1e-4 * ref.abs() + atol).all()),
                  f"{what}: {m} {k} beyond rtol 1e-4 / atol {atol:.2e}")
        root = (ref_opt["nu"][k] / bc2).sqrt()
        step = lr * ((opt["mu"][k] - ref_opt["mu"][k]).abs() / bc1
                     + ((opt["nu"][k] / bc2).sqrt() - root).abs()) / (root + eps)
        slack[k] = slack[k] + torch.clamp(2 * step, max=cap)
        err, tol = (params[k].float() - want.float()).abs(), 1e-6 + 1e-4 * want.float().abs()
        check(bool((err <= tol + slack[k]).all()),
              f"{what}: params {k} beyond rtol 1e-4 / atol 1e-6 + the AdamW slack")
        beyond += int((err > tol).sum())
    return slack, beyond


def grads_close(torch, got, want, what):
    """Each gradient of ``got`` within rtol 2e-3 and atol min(2e-3, 1e-4 of
    its tensor's largest entry) of ``want``'s.  Returns (the largest
    |diff|, the largest |grad|, the worst tensor's largest |diff| over its
    largest |grad|)."""
    g_err, g_max, g_rel = 0.0, 0.0, 0.0
    for k, g in want.items():
        top = float(g.abs().max())
        atol = min(2e-3, 1e-4 * top)
        check(bool(torch.isfinite(got[k]).all()) and torch.allclose(got[k], g, rtol=2e-3, atol=atol),
              f"{what}: gradient {k} beyond rtol 2e-3 / atol {atol:.2e}")
        err = float((got[k] - g).abs().max())
        g_err, g_max = max(g_err, err), max(g_max, top)
        g_rel = max(g_rel, err / max(top, 1e-30))
    return g_err, g_max, g_rel


def attn_layers(cfg, n_layers=None):
    """The layers of ``cfg`` (its first ``n_layers``) that attend through
    ``flash_attention``: one launch each a prefill.  MLA never does (its
    value width is not its query width: the plain chunked path, as JAX's)."""
    if cfg.attention == "mla":
        return 0
    return sum(cfg.layer_kind(i) == "attn"
               for i in range(cfg.n_layers if n_layers is None else n_layers))


def ssd_upper_exponent(torch, params, cfg, batch):
    """The largest upper-triangle decay exponent cum_i - cum_j (i < j) of
    the first SSD layer's chunks on ``batch``: exp overflows f32 past 88.7."""
    from torch.nn import functional as F

    from repro_torch.models.layers import rms_norm

    u = rms_norm(params["embed"][batch["tokens"].long()], params["blocks/b/norm1"][0],
                 cfg.norm_eps)
    dt = F.softplus((u @ params["blocks/b/ssm/w_dt"][0]).float()
                    + params["blocks/b/ssm/dt_bias"][0].float())
    rate = dt * torch.exp(params["blocks/b/ssm/a_log"][0].float())          # -a dt >= 0
    s = rate.shape[1] // cfg.ssm_chunk * cfg.ssm_chunk
    chunks = rate[:, :s].reshape(rate.shape[0], -1, cfg.ssm_chunk, rate.shape[-1])
    return float((chunks.sum(2) - chunks[:, :, 0]).max())


def train_reference(torch, seed, arch=TRAIN_ARCH, n_layers=TRAIN_REF_LAYERS,
                    label="phase 14 (a)"):
    """(a) ``arch`` at full width, ``n_layers`` deep, f32, B=2 and
    ``TRAIN_REF_S`` positions (a VLM's behind its patch embeddings, an
    audio model's frames): one ``loss`` and its gradients on the kernel
    route (the FMA kernel, forward and the checkpoint's recompute: twice an
    attention layer) against the plain route: the loss at rtol / atol 2e-3
    (phase 7's tolerance), each gradient at ``grads_close``'s rule; a
    model with attention then again in bf16 (``bf16_grads_gate``: the
    tensor-core forward and the backward kernels).  An SSM (its L = 256
    chunks take the upper triangle's exponent past exp's f32 overflow) is
    also run on the CPU on the same weights: its gradients finite and equal
    to the card's by the same rule."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 140)
    model = build_model(cfg, remat="full")
    params, _ = model.init(gen, device="cuda")
    batch = model_batch(torch, cfg, 2, TRAIN_REF_S, gen)
    w = torch.tensor([1.0, 0.5], device="cuda")
    n_attn = 2 * attn_layers(cfg)
    before = (kernel.fma_launches, kernel.tc_launches)
    lk, _, gk = loss_and_grads(model, params, batch, w)
    torch.cuda.synchronize()
    launched = (kernel.fma_launches - before[0], kernel.tc_launches - before[1])
    check(launched == (n_attn, 0),
          f"{label}: kernel route launched {launched} (FMA, tensor-core), expected {n_attn} FMA")
    lp, _, gp = loss_and_grads(build_model(cfg, remat="full", attn_impl="plain"), params, batch, w)
    check(kernel.fma_launches - before[0] == n_attn, f"{label}: the plain route ran the kernel")
    check(bool(torch.isfinite(lk)) and torch.allclose(lk, lp, rtol=2e-3, atol=2e-3),
          f"{label}: loss {float(lk)} against the plain route's {float(lp)}")
    g_err, g_max, g_rel = grads_close(torch, gk, gp, f"{label} kernel vs plain route")
    kinds = ", ".join(sorted({cfg.layer_kind(i) for i in range(n_layers)}))
    s_total = TRAIN_REF_S + (cfg.frontend_tokens if cfg.arch_type == "vlm" else 0)
    line(f"  (a) {cfg.name} width {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.n_layers} layers "
         f"({kinds}), f32, B=2 S={s_total}: loss and gradients, kernel route (FMA, {launched[0]} "
         f"launches: forward and recompute) vs plain route: loss {float(lk):.6f} / "
         f"{float(lp):.6f}, gradients max_abs_err {g_err:.3e} (max |grad| {g_max:.3e}; worst "
         f"tensor's max_abs_err / its max |grad| {g_rel:.3e}; rtol 2e-3, atol min(2e-3, 1e-4 "
         f"max |grad|)) ok")
    if attn_layers(cfg):
        gk = None
        bf16_grads_gate(torch, cfg, params, batch, w, gp, label)
    if cfg.arch_type == "ssm":
        expo = ssd_upper_exponent(torch, params, cfg, batch)
        check(expo > 88.72, f"{label}: the upper-triangle exponent {expo:.1f} does not overflow")
        cpu = lambda t: {k: v.cpu() for k, v in t.items()}
        lc, _, gc = loss_and_grads(model, cpu(params), cpu(batch), w.cpu())
        check(torch.allclose(lk.cpu(), lc, rtol=2e-3, atol=2e-3),
              f"{label}: the card's loss {float(lk)} against the CPU's {float(lc)}")
        c_err, _, c_rel = grads_close(torch, cpu(gk), gc, f"{label} card vs CPU")
        line(f"  (a) {cfg.name} f32: L = {cfg.ssm_chunk} chunks, upper-triangle exponent up to "
             f"{expo:.1f} (exp's f32 overflow 88.7): the card's gradients finite and equal to the "
             f"CPU's run of the same weights, max_abs_err {c_err:.3e} (worst tensor's / its max "
             f"|grad| {c_rel:.3e}) ok")
    del params, gk, gp
    release(torch)


def bf16_grads_gate(torch, cfg, params, batch, w, want, label):
    """(a)'s size again in bf16: the f32 parameters and float inputs rounded
    to bf16, the loss's gradients on the kernel route (the tensor-core
    forward twice an attention layer, with the checkpoint's recompute, and
    the backward kernels once; no chunked recompute) and on the plain
    route, each leaf's relative Frobenius error ||g - g_f32|| / ||g_f32||
    against the f32 plain route's gradients ``want``: the kernel route's at
    most twice the plain route's own (a leaf the loss never reads has no
    gradient in either).  The two routes run one after the other, so only
    one set of bf16 gradients is held at a time."""
    import dataclasses

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fb
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model
    from repro_torch.models.attention import _KernelAttention

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    b16 = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in batch.items()}
    n_attn = attn_layers(cfg)
    counts = lambda: (fa.tc_launches, fb.launches, _KernelAttention.plain_backward_calls)
    norms = {k: float(g.float().norm()) for k, g in want.items()}

    def rel_errors(impl):
        _, _, got = loss_and_grads(build_model(cfg16, remat="full", attn_impl=impl), p16, b16, w)
        out = {}
        for k, g in want.items():
            if norms[k] == 0.0:
                check(not got[k].any(), f"{label} bf16 ({impl or 'kernel'} route): {k} has a "
                      f"gradient where the f32 run has none")
            else:
                out[k] = float((got[k].float() - g.float()).norm()) / norms[k]
        return out

    before = counts()
    ek = rel_errors(None)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(counts(), before))
    check(launched == (2 * n_attn, n_attn, 0),
          f"{label} bf16: the kernel route launched {launched} (tensor-core forward, backward "
          f"kernels, chunked recomputes), expected {(2 * n_attn, n_attn, 0)}")
    ep = rel_errors("plain")
    ratio = {k: ek[k] / max(ep[k], 1e-30) for k in ek}
    bad = {k: (ek[k], ep[k]) for k in ek if ek[k] > 2 * ep[k]}
    check(not bad, f"{label} bf16: the kernel route's relative error above twice the plain "
          f"route's: {bad}")
    worst = max(ratio, key=ratio.get)
    line(f"  (a) {cfg.name} bf16, the same size: gradients on the kernel route (tensor-core "
         f"forward {launched[0]}, backward kernels {launched[1]}, chunked recompute 0) and on "
         f"the plain route against the f32 plain route, ||g - g_f32|| / ||g_f32|| a leaf: kernel "
         f"route up to {max(ek.values()):.3e}, plain route up to {max(ep.values()):.3e}; the "
         f"largest ratio {ratio[worst]:.3f} ({worst}: {ek[worst]:.3e} / {ep[worst]:.3e}; gate "
         f"2) ok")
    del p16, b16


def _tree_to(tree, dev):
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda x: x.to(dev) if hasattr(x, "to") else x, tree)


def moments_excess(opt, ref_opt):
    """The largest |diff| of ``opt``'s AdamW moments from ``ref_opt``'s over
    ``adam_round_close``'s moment tolerance (rtol 1e-4, atol min(1e-6, 1e-4
    of the tensor's largest entry)), and the entries past it."""
    worst, beyond = 0.0, 0
    for m in ("mu", "nu"):
        for k, ref in ref_opt[m].items():
            tol = 1e-4 * ref.abs() + min(1e-6, 1e-4 * float(ref.abs().max()))
            excess = (opt[m][k] - ref).abs() / tol.clamp_min(1e-30)
            worst, beyond = max(worst, float(excess.max())), beyond + int((excess > 1).sum())
    return worst, beyond


def train_card_vs_cpu(torch, seed, arch=TRAIN_ARCH, label="phase 14 (b)", carried_adam=True):
    """(b) three ``make_fl_train_step`` rounds at ``arch``'s smoke config in
    f32 on the card against the same rounds on the CPU (same initial
    state, batches and uniforms): AoI, the scheduler's state, the count and
    ``n_success`` bit for bit; loss, contributions, zeta at rtol 1e-4;
    moments and parameters as ``adam_round_close`` holds them, on each
    round stepped on the card from the CPU's state before it and, with
    ``carried_adam``, on the run carried over the rounds.  Without it the
    carried run's moments are measured, not held: AdamW's scale-free first
    steps move an entry whose gradient is rounding noise by another
    fraction of lr on each device, and the gradients those moves induce a
    round later may pass the moments' rtol 1e-4 (the rule the JAX parity
    tests hold AdamW by, ``tests/test_torch_train_families.py``).  On the
    card each round launches ``glr_step`` once and ``flash_attention``
    twice an attention layer on the FMA route (the forward and the
    checkpoint's recompute); on the CPU nothing launches."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_piecewise
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.launch.steps import make_fl_train_step, make_train_state_init
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    lr, rounds = 1e-3, TRAIN_REF_ROUNDS
    model, sched, opt = build_model(cfg, remat="full"), GLRCUCB(8, 4, history=32), adamw(lr)
    means = np.array([np.linspace(0.9, 0.2, 8), np.linspace(0.2, 0.9, 8)], np.float32)
    state0 = make_train_state_init(model, opt, sched, 4)(
        torch.Generator().manual_seed(seed + 141), device="cpu")
    data = synthetic_lm_batches(8, 64, cfg.vocab_size, seed=seed + 142)
    gen = torch.Generator().manual_seed(seed + 146)
    batches = []
    for _ in range(rounds):
        batch = model_batch(torch, cfg, 8, 64, gen, "cpu")
        if "tokens" in batch:
            batch["tokens"] = torch.from_numpy(next(data))
        batches.append(batch)
    u = torch.rand((rounds, 2, 8), generator=torch.Generator().manual_seed(seed + 143))
    wrappers = kernel_wrappers()
    counters = lambda: (wrappers["glr_step"].launches, wrappers["flash_attention"].fma_launches,
                        wrappers["flash_attention"].tc_launches)
    to = lambda batch, dev: {k: v.to(dev) for k, v in batch.items()}
    n_attn = 2 * attn_layers(cfg)
    steps = {dev: make_fl_train_step(model, opt, sched, make_piecewise(means, [1], device=dev), 4)
             for dev in ("cpu", "cuda")}
    runs = {}
    for dev in ("cpu", "cuda"):
        state, out = _tree_to(state0, dev), []
        before = counters()
        for r in range(rounds):
            state, met = steps[dev](state, to(batches[r], dev), u[r, 0].to(dev), u[r, 1].to(dev))
            out.append(_tree_to((state, met), "cpu"))
        launched = tuple(a - b for a, b in zip(counters(), before))
        want = (rounds, rounds * n_attn, 0) if dev == "cuda" else (0, 0, 0)
        check(launched == want, f"{label} on {dev}: launched (glr_step, flash_attention "
              f"FMA, tensor-core) {launched}, expected {want}")
        runs[dev] = out
    # each round again on the card, from the CPU's state before it
    forced = [_tree_to(steps["cuda"](_tree_to(state0 if r == 0 else runs["cpu"][r - 1][0], "cuda"),
                                     to(batches[r], "cuda"), u[r, 0].cuda(), u[r, 1].cuda())[0],
                       "cpu") for r in range(rounds)]
    slack = {k: torch.zeros_like(v) for k, v in state0.params.items()}
    worst, beyond, drift = 0.0, 0, []
    for r, ((cs, cm), (gs, gm)) in enumerate(zip(runs["cpu"], runs["cuda"])):
        at = f"{label} round {r}"
        check(torch.equal(gs.fl.aoi, cs.fl.aoi) and gs.fl.t == cs.fl.t == r + 1, f"{at}: aoi")
        check(same_tree(torch, gs.fl.sched_state, cs.fl.sched_state), f"{at}: scheduler state")
        check(torch.equal(gs.opt_state["count"], cs.opt_state["count"]), f"{at}: count")
        check(torch.equal(gm["n_success"], cm["n_success"])
              and torch.equal(gm["mean_aoi"], cm["mean_aoi"]), f"{at}: n_success / mean_aoi")
        for name, a, c in (("contrib", gs.fl.contrib, cs.fl.contrib),
                           ("zeta", gs.fl.zeta, cs.fl.zeta), ("loss", gm["loss"], cm["loss"])):
            check(torch.allclose(a, c, rtol=1e-4, atol=0), f"{at}: {name} beyond rtol 1e-4")
        adam_round_close(torch, forced[r].params, forced[r].opt_state, cs.params, cs.opt_state,
                         {k: torch.zeros_like(v) for k, v in slack.items()}, lr,
                         f"{at} (stepped from the CPU's state)")
        if carried_adam:
            slack, n = adam_round_close(torch, gs.params, gs.opt_state, cs.params, cs.opt_state,
                                        slack, lr, at)
            beyond = max(beyond, n)
        else:
            drift.append(moments_excess(gs.opt_state, cs.opt_state))
        for k, p in cs.params.items():
            worst = max(worst, float(((gs.params[k] - p).abs() / (p.abs() + 1e-6)).max()))
    n_params = sum(p.numel() for p in state0.params.values())
    carried = (f"moments rtol 1e-4; params (largest |diff| / (|p| + 1e-6) {worst:.3e}; at most "
               f"{beyond} of {n_params} entries beyond rtol 1e-4 / atol 1e-6, inside the AdamW "
               f"slack) ok, each round also from the CPU's state ok" if carried_adam else
               f"each round's moments and params from the CPU's state as adam_round_close holds "
               f"them ok; the carried run measured: its moments' largest |diff| over the "
               f"tolerance by round {', '.join(f'{x:.3g}' for x, _ in drift)} ("
               f"{', '.join(str(n) for _, n in drift)} entries past it), params largest |diff| "
               f"/ (|p| + 1e-6) {worst:.3e}")
    line(f"  (b) {cfg.name} f32, {rounds} rounds of make_fl_train_step on the card equal the CPU "
         f"run: AoI, scheduler state, n_success bit for bit; loss, contributions, zeta rtol 1e-4; "
         f"{carried}; launches a round: glr_step 1, flash_attention (FMA) {n_attn}")


def train_microbatches(torch, seed):
    """(c) ``microbatches = 4`` against 1 for one step at (a)'s 2 layers in
    bf16, at ``tests/test_scale_steps.py``'s tolerances (loss rtol 2e-4,
    parameters rtol 2e-2 / atol 3e-3).  AdamW's first step moves every
    entry by about lr whatever its gradient, so those parameters cannot
    tell a wrong accumulation; the same step in f32 is held on its
    accumulated gradient, AdamW's first ``mu`` (0.1 g): rtol 1e-4, atol 1e-4
    of the tensor's largest entry (the gradients' rule)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.bandits import GLRCUCB
    from repro_torch.core.channels import make_stationary
    from repro_torch.launch.steps import make_fl_train_step, make_train_state_init
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    sched, opt = GLRCUCB(8, 4, history=32), adamw(1e-3)
    # channels good enough that the f32 step's clients all but surely deliver
    env = make_stationary(torch.linspace(0.95, 0.8, 8, device="cuda"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 144)
    u = torch.rand((2, 8), generator=gen, device="cuda")

    def one_step(dtype):
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_REF_LAYERS, dtype=dtype)
        model = build_model(cfg, remat="full")
        state = make_train_state_init(model, opt, sched, 4)(
            torch.Generator(device="cuda").manual_seed(seed + 145), device="cuda")
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, TRAIN_REF_S), generator=gen,
                                         device="cuda", dtype=torch.int32)}
        return cfg, {mb: make_fl_train_step(model, opt, sched, env, 4, microbatches=mb)(
            state, batch, u[0], u[1]) for mb in (1, 4)}

    _, out = one_step("float32")
    (s1, m1), (s4, m4) = out[1], out[4]
    check(float(m1["n_success"]) > 0, "phase 14 (c): no client delivered in the f32 step")
    g_rel = 0.0
    for k, mu in s1.opt_state["mu"].items():
        top = float(mu.abs().max())
        check(torch.allclose(s4.opt_state["mu"][k], mu, rtol=1e-4, atol=1e-4 * top),
              f"phase 14 (c): f32 accumulated gradient {k} beyond rtol 1e-4 / atol 1e-4 max")
        g_rel = max(g_rel, float((s4.opt_state["mu"][k] - mu).abs().max()) / max(top, 1e-30))
    del out, s1, s4
    cfg, out = one_step("bfloat16")
    (s1, m1), (s4, m4) = out[1], out[4]
    check(torch.allclose(m4["loss"], m1["loss"], rtol=2e-4, atol=0),
          f"phase 14 (c): loss {float(m4['loss'])} against {float(m1['loss'])}")
    check(torch.equal(m4["mean_aoi"], m1["mean_aoi"]), "phase 14 (c): mean_aoi")
    p_err = 0.0
    for k, p in s1.params.items():
        check(s4.params[k].dtype == p.dtype == torch.bfloat16
              and torch.allclose(s4.params[k].float(), p.float(), rtol=2e-2, atol=3e-3),
              f"phase 14 (c): params {k} beyond rtol 2e-2 / atol 3e-3")
        p_err = max(p_err, float((s4.params[k].float() - p.float()).abs().max()))
    line(f"  (c) {cfg.name} {cfg.n_layers} layers bf16, B=8 S={TRAIN_REF_S}: microbatches=4 vs 1, "
         f"one step: loss {float(m4['loss']):.6f} / {float(m1['loss']):.6f} (rtol 2e-4), params "
         f"max_abs_err {p_err:.3e} (rtol 2e-2 atol 3e-3) ok; in f32 the accumulated gradients' "
         f"worst max_abs_err / max |g| of a tensor {g_rel:.3e} (rtol 1e-4, atol 1e-4 max) ok")
    del out, s1, s4
    release(torch)


def model_flops(cfg, n_params, b, s):
    """Model FLOPs of one training step from shapes: 6 P B S (the products
    with the P parameters, forward and backward; the tied embedding counts
    once, as the unembedding's product) plus causal attention, 3 x 4 D
    FLOPs a visible (query, key) pair a head a layer; and what the card
    executes besides with ``remat="full"``: the blocks' forward again (2
    P' B S, P' the blocks' parameters), the CE chunks' unembedding again (2
    V d B S), attention's forward once more (the checkpoint's recompute, 4
    D a pair) and the backward kernels' recompute of the logits (2 D a
    pair)."""
    pairs = attn_pairs(s, True, 0)
    attn = 12 * cfg.resolved_head_dim * b * cfg.n_heads * cfg.n_layers * pairs
    blocks = n_params - cfg.vocab_size * cfg.d_model
    extra = (2 * blocks * b * s + 2 * cfg.vocab_size * cfg.d_model * b * s
             + 6 * cfg.resolved_head_dim * b * cfg.n_heads * cfg.n_layers * pairs)
    return 6 * n_params * b * s, attn, extra


def range_device_us(events, name):
    """Device time of the kernels launched inside the ``record_function``
    ranges called ``name``, and the number of ranges: the kernels whose
    launch (a CUDA runtime or driver call, matched by correlation id) falls
    inside one of the ranges on the host."""
    import bisect

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("name") == name and e.get("cat") == "user_annotation")
    starts = [a for a, _ in spans]

    def inside(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= spans[i][1]

    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {}) and inside(float(e["ts"]))}
    return sum(float(e["dur"]) for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in corr), len(spans)


def timed_rounds(torch, train, run, state, rounds, warm):
    """``rounds`` of ``train.train_round`` from ``state``, the launch
    counters reset first: (the state, each round's metrics, ms a step over
    the rounds after the first ``warm`` (host clock), ms between the timed
    steps' CUDA events, the launches, the peak ``max_memory_allocated`` of
    the ``warm`` rounds, the peak statistics reset before the first)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    mets, marks = [], []
    for t in range(rounds):
        if t == warm:
            torch.cuda.synchronize()
            warm_peak = torch.cuda.max_memory_allocated()
            t1 = time.perf_counter()
        state, met = train.train_round(run, state)
        mets.append(met)
        marks.append(torch.cuda.Event(enable_timing=True))   # the step's end on the stream
        marks[-1].record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / (rounds - warm) * 1e3
    spread = [a.elapsed_time(b) for a, b in zip(marks[warm - 1:], marks[warm:])]
    return state, mets, step_ms, spread, read_launches(), warm_peak


def train_path(torch, seed):
    """(d) qwen1.5-0.5b at full width and depth in bf16 through the CLI's
    own functions (``launch.train.parse_args``, ``setup``, ``train_round``):
    the main path whose launches are counted; then (e) its parameters
    through ``save_checkpoint`` and back."""
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch import train
    from repro_torch.models.attention import BACKWARD_RANGE
    from repro_torch.utils import roofline as rl

    args = train.parse_args(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_ROUNDS), "--batch",
                             str(TRAIN_B), "--seq", str(TRAIN_S), "--clients",
                             str(TRAIN_CLIENTS), "--channels", str(TRAIN_CHANNELS),
                             "--lr", str(TRAIN_LR), "--ce-chunk", str(TRAIN_CE_CHUNK),
                             "--seed", str(seed), "--device", "cuda"])
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    h0, free0 = allocator_bytes(torch), free_blocks(torch)
    m0 = h0[0]
    t0 = time.perf_counter()
    run = train.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    static = minus(allocator_bytes(torch), h0)
    cfg, state = run.cfg, run.state
    n_params = sum(v.numel() for v in state.params.values())
    # param_count leaves out the norm gains and the QKV biases
    extra_p = (cfg.n_layers * 2 * cfg.d_model + cfg.d_model + cfg.qkv_bias * cfg.n_layers
               * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.resolved_head_dim)
    check(n_params == cfg.param_count() + extra_p and run.model.remat == "full"
          and state.params["embed"].dtype == torch.bfloat16,
          f"phase 14 (d): {n_params} params, config says {cfg.param_count()} + {extra_p}")
    line(f"  (d) {cfg.name}: {cfg.n_layers} layers, width {cfg.d_model}, vocab {cfg.vocab_size}, "
         f"bf16, {n_params:,} params, remat={run.model.remat}, ce_chunk={run.model.ce_chunk}; "
         f"{TRAIN_CLIENTS} clients over {TRAIN_CHANNELS} channels, B={TRAIN_B} S={TRAIN_S}, "
         f"AdamW lr {TRAIN_LR}; set up on the card in {setup_s:.2f} s")

    state, mets, step_ms, spread, launches, warm_peak = timed_rounds(torch, train, run, state,
                                                                     TRAIN_ROUNDS, TRAIN_WARM)
    card = card_step(static, warm_peak - m0, per_step(launches, TRAIN_ROUNDS, "phase 14 (d)"),
                     step_ms, (free0,), env_sizes(run.env))
    spread = sorted(spread)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(m["loss"]) for m in mets]
    succ = [int(m["n_success"]) for m in mets]
    fa_per = 2 * cfg.n_layers
    check(launches["flash_attention_tc"] == TRAIN_ROUNDS * fa_per
          and launches["flash_attention"] == TRAIN_ROUNDS * fa_per
          and launches["flash_attention_bwd"] == TRAIN_ROUNDS * cfg.n_layers
          and launches[PLAIN_BACKWARD] == 0 and launches["glr_step"] == TRAIN_ROUNDS,
          f"phase 14 (d): launches {launches}; expected flash_attention {fa_per} a step on the "
          f"tensor-core route, its backward kernels {cfg.n_layers} a step and no chunked "
          f"recompute, and glr_step 1 a step")
    check(all(math.isfinite(x) for x in losses), f"phase 14 (d): losses {losses}")
    # a round in which no client delivered weighs every example 0: its loss is 0
    delivered = [x for x, n in zip(losses, succ) if n > 0]
    first, last = sum(delivered[:5]) / 5, sum(delivered[-5:]) / 5
    check(len(delivered) >= 10 and last < first,
          f"phase 14 (d): loss did not fall: {losses} (|S_t| {succ})")
    zsum = float(state.fl.zeta.sum())
    check(abs(zsum - 1.0) < 1e-5 and state.fl.t == TRAIN_ROUNDS,
          f"phase 14 (d): zeta sums to {zsum}, t = {state.fl.t}")
    tokens = TRAIN_B * TRAIN_S
    flops, attn, extra = model_flops(cfg, n_params, TRAIN_B, TRAIN_S)
    line(f"  (d) {TRAIN_ROUNDS} rounds: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first "
         f"/ last 5 rounds with a delivery {first:.4f} / {last:.4f}), |S_t| {succ}, zeta sums to "
         f"{zsum:.7f}, t = {state.fl.t}; launches flash_attention {launches['flash_attention']} "
         f"({launches['flash_attention_tc'] // TRAIN_ROUNDS} a step, tensor-core route), "
         f"flash_attention_bwd {launches['flash_attention_bwd']} "
         f"({launches['flash_attention_bwd'] // TRAIN_ROUNDS} a step; chunked recompute "
         f"{launches[PLAIN_BACKWARD]}), glr_step {launches['glr_step']}")
    line(f"  (d) {step_ms:.3f} ms a step untraced (rounds {TRAIN_WARM}-{TRAIN_ROUNDS - 1}, after "
         f"{TRAIN_WARM} warm-up rounds; between the steps' CUDA events min {spread[0]:.3f}, "
         f"median {spread[len(spread) // 2]:.3f}, max {spread[-1]:.3f} ms), "
         f"{tokens / step_ms * 1e3:,.0f} tokens/s; model FLOPs a "
         f"step 6 P B S = {flops:.4e} + causal attention {attn:.4e} = {flops + attn:.4e}, "
         f"{(flops + attn) / (step_ms * 1e-3) / 1e12:.1f} TFLOP/s = "
         f"{100 * (flops + attn) / (step_ms * 1e-3) / rl.PEAK_FLOPS_BF16:.1f} % of "
         f"{rl.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s (6 P B S alone "
         f"{100 * flops / (step_ms * 1e-3) / rl.PEAK_FLOPS_BF16:.1f} %); with the recompute the card "
         f"executes about {flops + attn + extra:.4e}")
    line(f"  (d) peak device memory {peak_gib:.2f} GiB (allocated; parameters "
         f"{n_params * 2 / 2 ** 30:.2f} GiB bf16, AdamW moments {n_params * 8 / 2 ** 30:.2f} GiB)")

    # not counted: a traced window of the same loop
    holder = {"state": state}

    def window():
        for _ in range(TRAIN_PROFILE_STEPS):
            holder["state"], _ = train.train_round(run, holder["state"])

    events, wall_us = trace_events(torch, window)
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_name = report_kernels(f"(d) {cfg.name} training step", kernels, wall_us,
                             TRAIN_PROFILE_STEPS)
    total = sum(by_name.values())
    bwd_us, n_ranges = range_device_us(events, BACKWARD_RANGE)
    flash_us = sum(v for k, v in by_name.items() if "flash_fwd" in k)
    flash_bwd_us = sum(v for k, v in by_name.items()            # stats, dK/dV, dQ
                       if "bwd_stats_kernel" in k or "bwd_kernel<" in k)
    gemm_us = sum(v for k, v in by_name.items() if "gemm" in k.lower() or "xmma" in k.lower()
                  or "cutlass" in k.lower())
    if total:
        line(f"  (d) profile: the attention backward (the backward kernels' route, {n_ranges} "
             f"ranges) {bwd_us / TRAIN_PROFILE_STEPS / 1e3:.2f} ms a step = "
             f"{100 * bwd_us / total:.1f} % of device time (its three kernels "
             f"{flash_bwd_us / TRAIN_PROFILE_STEPS / 1e3:.2f} ms); flash_attention "
             f"{flash_us / TRAIN_PROFILE_STEPS / 1e3:.2f} ms "
             f"({100 * flash_us / total:.1f} %); kernels named gemm/xmma/cutlass "
             f"{gemm_us / TRAIN_PROFILE_STEPS / 1e3:.2f} ms ({100 * gemm_us / total:.1f} %)")
    del holder, events, kernels

    # (e) the trained parameters through the checkpoint and back
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, TRAIN_ROUNDS, {"params": state.params})
        back, step = restore_checkpoint(tmp, like={"params": state.params})
        ck_s = time.perf_counter() - t0
        check(step == TRAIN_ROUNDS and all(torch.equal(back["params"][k], v)
                                           for k, v in state.params.items()),
              "phase 14 (e): restored parameters differ")
        line(f"  (e) checkpoint: {len(state.params)} tensors saved ({Path(path).stat().st_size / 2 ** 30:.2f} "
             f"GiB npz) and restored bit for bit in {ck_s:.1f} s")
    del back, state, run, mets
    release(torch)
    return launches, dict(step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
                          model_flops=flops + attn, peak_gib=peak_gib,
                          attn_backward_share=bwd_us / total if total else None,
                          card={"card_train": card})


def training(torch, seed, floor_ms):
    """Phase 14: the FL training path at LLM scale.  Returns the main path's
    launches ((d)'s 20 rounds), the kernels at its shapes and its numbers."""
    t_phase = time.perf_counter()
    kernels = train_kernels(torch, torch.Generator(device="cuda").manual_seed(seed + 139),
                            floor_ms)
    release(torch)
    train_reference(torch, seed)
    train_card_vs_cpu(torch, seed)
    train_microbatches(torch, seed)
    launches, numbers = train_path(torch, seed)
    for name in kernels:
        kernels[name]["launches"] = launches[name]
    line(f"  phase 14 launches: flash_attention {launches['flash_attention']} (tensor-core "
         f"{launches['flash_attention_tc']}), flash_attention_bwd "
         f"{launches['flash_attention_bwd']}, glr_step {launches['glr_step']}; wall "
         f"{time.perf_counter() - t_phase:.1f} s")
    return launches, kernels, numbers


# ---------------------------------------------------------------------------
# phase 15: the scheduler service for every served policy
# ---------------------------------------------------------------------------

SERVED_NOT_BITWISE = {   # leaf: (rtol, why), where a served leaf may part from its reference
    "log_w": (1e-5, "M-Exp3's log-weights go through logsumexp, logaddexp and exp, which the "
                    "card and the CPU round apart"),
}


def served_policies(n, m):
    """The policies the service serves besides streaming GLR-CUCB, each in
    its Fig. 2a configuration (``benchmarks/run.py:187-205``) at N, M; the
    recompute detector at the ``serve_suite``'s history and stride."""
    from repro_torch.core.bandits import (GLRCUCB, ChannelAwareAsync, LyapunovSched, MExp3,
                                          RandomScheduler, RoundRobinScheduler)

    return [("random", RandomScheduler(n, m)), ("round-robin", RoundRobinScheduler(n, m)),
            ("channel-aware", ChannelAwareAsync(n, m)), ("lyapunov", LyapunovSched(n, m)),
            ("m-exp3", MExp3(n, m, gamma=0.5, share_alpha=1e-3)),
            ("glr-recompute", GLRCUCB(n, m, history=SCHED_H, detector_stride=5,
                                      detector_impl="recompute"))]


def tree_parts(torch, a, b, path=""):
    """The leaves of two equal structures that are not bitwise equal:
    {path: max relative difference}."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        out = {}
        for f in a._fields:
            out.update(tree_parts(torch, getattr(a, f), getattr(b, f), f"{path}{f}/"))
        return out
    if isinstance(a, dict):
        out = {}
        for k in a:
            out.update(tree_parts(torch, a[k], b[k], f"{path}{k}/"))
        return out
    x, y = a.cpu(), b.cpu()
    if torch.equal(x, y):
        return {}
    rel = ((x.double() - y.double()).abs() / y.double().abs().clamp_min(1e-30)).max()
    return {path.rstrip("/"): float(rel)}


def held(torch, label, a, b):
    """``a`` equals ``b`` leaf for leaf, bit for bit but for the leaves of
    ``SERVED_NOT_BITWISE`` at their rtol; returns the text of what held."""
    parts = tree_parts(torch, a, b)
    for path, rel in parts.items():
        leaf = path.split("/")[-1]
        check(leaf in SERVED_NOT_BITWISE and rel <= SERVED_NOT_BITWISE[leaf][0],
              f"{label}: leaf {path} differs (max rel {rel:.3e})")
    if not parts:
        return "every leaf bit for bit"
    return "every leaf bit for bit but " + ", ".join(
        f"{p} (max rel {r:.2e} <= rtol {SERVED_NOT_BITWISE[p.split('/')[-1]][0]:g}: "
        f"{SERVED_NOT_BITWISE[p.split('/')[-1]][1]})" for p, r in parts.items())


def served_parity(torch, name, sched, seed):
    """(a) One tenant served ``SCHED_PARITY_ROUNDS`` rounds of
    ``offline_round_stream`` (N = 16, 3 breakpoints) on the 256-tenant,
    64-row server against ``simulate_aoi_regret`` on the card (the scan
    route for the recompute detector, the per-round route for the rest):
    schedule, AoI and state; its first 200 rounds against the same rounds
    served on the CPU.  Returns the served run's launches and ms a step."""
    from repro_torch.core.channels import make_scenario
    from repro_torch.core.regret import offline_round_stream, simulate_aoi_regret
    from repro_torch.kernels.regret_scan import regret_scan
    from repro_torch.sim import SchedServer, ServeRequest

    import numpy as np

    n, rounds, cpu_rounds = sched.n_channels, SCHED_PARITY_ROUNDS, 200
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    env = make_scenario("piecewise", n_channels=n, horizon=rounds, n_breakpoints=3).realize(gen)
    u = torch.rand((rounds, 2, n), generator=gen, device="cuda")
    recompute = name == "glr-recompute"
    before = regret_scan.launches
    off = simulate_aoi_regret(sched, env, rounds, uniforms=u, collect_curve=False,
                              return_state=True)
    route = "scan" if regret_scan.launches == before + 1 else "rounds"
    check(route == ("scan" if recompute else "rounds"), f"phase 15 (a) {name}: offline route "
          f"{route}")
    u_sel, states = (x.cpu().numpy() for x in offline_round_stream(env, u, rounds))
    reqs = [ServeRequest("parity", states[t], u_sel[t]) for t in range(rounds)]
    server = SchedServer(sched, capacity=SCHED_CAPACITY, slots=SCHED_SLOTS)
    server.join("parity")
    cpu = SchedServer(sched, capacity=4, slots=1, device="cpu")
    cpu.join("parity")
    cpu_asg = np.stack([cpu.serve([rq])[0] for rq in reqs[:cpu_rounds]])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asg = []
    for t, rq in enumerate(reqs):
        asg.append(server.serve([rq])[0])
        if t + 1 == cpu_rounds:
            early = server.tenant_state("parity")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    asg = np.stack(asg)
    row = server.tenant_state("parity")
    check(np.array_equal(asg, off["channels"].cpu().numpy()),
          f"phase 15 (a) {name}: the served schedule != the offline run's")
    check(torch.equal(off["aoi_pi"].cpu(), row.aoi.cpu()),
          f"phase 15 (a) {name}: AoI != the offline run's")
    off_held = held(torch, f"phase 15 (a) {name} vs offline", row.sched_state,
                    off["final_sched_state"])
    check(np.array_equal(asg[:cpu_rounds], cpu_asg),
          f"phase 15 (a) {name}: the first {cpu_rounds} rounds' schedule != the CPU run's")
    cpu_held = held(torch, f"phase 15 (a) {name} vs the CPU", early, cpu.tenant_state("parity"))
    kernels = {k: v for k, v in launches.items() if v}
    want = {"glr_scan_tenants": rounds} if recompute else {}
    check(kernels == want, f"phase 15 (a) {name}: launches {kernels} over {rounds} steps, "
          f"expected {want}")
    restarts = (f", restarts={int(row.sched_state.restarts)}" if recompute else "")
    line(f"  (a) {name}: {rounds} rounds of one tenant (slot batch {server.slots}) equal "
         f"simulate_aoi_regret's {route} route on the card (schedule, AoI; {off_held}"
         f"{restarts}); the first {cpu_rounds} equal the CPU run (schedule; {cpu_held}); "
         f"launches {kernels or 'none'} ({secs / rounds * 1e3:.4f} ms/step)")
    return launches, secs / rounds * 1e3


def served_pool(torch, name, sched, seed):
    """(b) The 256-tenant server, slot batch 64, per-tenant hp where the
    policy has knobs: the first 3 steps against the CPU run, synchronous
    and pipelined decisions a second (best of 2), launches against steps,
    one step under ``set_sync_debug_mode("error")``; a profiled 10-step
    window for M-Exp3 and the recompute detector."""
    from collections import deque

    import numpy as np

    from repro_torch.launch.sched_serve import (make_traffic, pipelined_throughput,
                                                saturated_throughput)
    from repro_torch.sim import SchedServer, ServeRequest

    c, b, n = SCHED_CAPACITY, SCHED_SLOTS, sched.n_channels
    server = SchedServer(sched, capacity=c, slots=b)
    cpu = SchedServer(sched, capacity=c, slots=b, device="cpu")
    ids = [f"job-{i}" for i in range(c)]
    knob = (sched.traced_fields() or (None,))[0]
    for i, tid in enumerate(ids):
        hp = None if knob is None else {knob: float(getattr(sched, knob)) * (0.8 + 0.4 * i / c)}
        server.join(tid, hp=hp)
        cpu.join(tid, hp=hp)
    states, uniforms = make_traffic(c, n, SCHED_REQUESTS, seed=seed + 15)
    req = lambda j: ServeRequest(ids[j % c], states[(j // c) % states.shape[0], j % c],
                                 uniforms[j])
    first = [req(j) for j in range(3 * b)]
    got, want = server.serve(first), cpu.serve(first)
    check(all(np.array_equal(x, y) for x, y in zip(got, want)),
          f"phase 15 (b) {name}: assignments of the first 3 steps != the CPU run's")
    what = held(torch, f"phase 15 (b) {name}", server._state, cpu._state)
    del cpu
    st0 = server.stats()
    reset_launches()
    rate = max(saturated_throughput(server, ids, states, uniforms, SCHED_REQUESTS)
               for _ in range(2))
    pipe = max(pipelined_throughput(server, ids, states, uniforms, SCHED_REQUESTS)
               for _ in range(2))
    launches = read_launches()
    steps = server.stats()["steps"] - st0["steps"]
    kernels = {k: v for k, v in launches.items() if v}
    expect = {"glr_scan_tenants": steps} if name == "glr-recompute" else {}
    check(kernels == expect, f"phase 15 (b) {name}: launches {kernels} over {steps} steps, "
          f"expected {expect}")
    pending = deque(enumerate(req(j) for j in range(b)))
    batch = server._take_batch(pending, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inflight = server._dispatch(batch, b, False)
    except RuntimeError as exc:
        raise SmokeFailure(f"phase 15 (b) {name}: a serve step synchronized with the device: "
                           f"{exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    server._retire(inflight)
    line(f"  (b) {name}: {c} tenants, slot batch {b}: the first 3 steps equal the CPU run "
         f"(assignments; slot state {what}); sync {rate:.1f} decisions/s ({b / rate * 1e3:.4f} "
         f"ms/step), pipelined {pipe:.1f} decisions/s (best of 2 each; pipelined/sync "
         f"{pipe / rate:.3f}x); launches {kernels or 'none'} over {steps} steps; a steady step "
         f"under set_sync_debug_mode('error') ok")
    if name in ("m-exp3", "glr-recompute"):
        window = [req(j) for j in range(10 * b)]
        profile_window(torch, f"(b) {name} {c}-tenant step (slot batch {b})",
                       lambda: server.serve(window), 10)
    return launches, dict(rate=rate, pipe_rate=pipe)


def served_fl(torch, seed):
    """(c) ``run_served`` against ``run()`` over ``SCHED_FL_ROUNDS`` rounds,
    bit for bit: dense, M-Exp3 with the matcher on phase 9's adversarial
    N = 6, M = 4 problem; sparse, Lyapunov on phase 13 (c)'s setup (M = N
    = 20 clients, 30 channels, its own draws).  Returns the launches."""
    import dataclasses

    from repro_torch.core.bandits import LyapunovSched, MExp3
    from repro_torch.core.channels import make_scenario
    from repro_torch.fl import AsyncFLTrainer, SparseAsyncFLTrainer, SparseFLConfig
    from repro_torch.sim import SchedServer

    r, counted = SCHED_FL_ROUNDS, []

    def served(tr, run, run_served, label):
        ref_s, ref_m = run()
        # the matcher ranks by the policy's means on an env that says so (the
        # adversarial table), as the trainer's own round does
        kind = ("mean" if getattr(tr.env, "score_kind", "ucb") == "mean"
                and hasattr(tr.scheduler, "mean_scores") else "ucb")
        server = SchedServer(tr.scheduler, capacity=4, slots=4, use_matching=True,
                             matcher_beta=tr.cfg.matcher_beta, score_kind=kind)
        server.join("job")
        reset_launches()
        state, mets = run_served(server)
        counted.append(read_launches())
        for f in ref_s._fields:
            if f != "sched_state":
                check(same_tree(torch, getattr(ref_s, f), getattr(state, f)),
                      f"phase 15 (c) {label}: run_served {f} != run()'s")
        check(same_tree(torch, ref_s.sched_state, server.tenant_state("job").sched_state),
              f"phase 15 (c) {label}: the server's tenant state != run()'s sched_state")
        check(all(torch.equal(ref_m[k], mets[k]) for k in ref_m),
              f"phase 15 (c) {label}: metrics differ")
        got = {k: v for k, v in counted[-1].items() if v}
        check(got == {"weighted_aggregate": r}, f"phase 15 (c) {label}: launches {got}")
        line(f"  (c) {label} run_served (score_kind {kind}): {r} rounds equal run() bit for bit "
             f"(every state leaf, the server's tenant state, metrics; n_success "
             f"{mets['n_success'].tolist()}); launches {got}")

    S = fig3_setup(torch, seed, n=6, m=4, adversarial=True)
    sched = MExp3(S["n"], S["m"], share_alpha=1e-3)
    cfg = dataclasses.replace(S["cfg"], use_matching=True, use_zeta=True)
    tr = AsyncFLTrainer(cfg, sched, S["env"], S["loss_fn"])
    args = (S["bx"][:r], S["by"][:r])
    served(tr, lambda: tr.run(tr.init(S["params"]), *args, uniforms=S["uniforms"][:r]),
           lambda srv: tr.run_served(tr.init(S["params"]), *args, srv, "job",
                                     uniforms=S["uniforms"][:r]),
           f"dense m-exp3+aware (N={S['n']}, M={S['m']}, adversarial)")
    del S

    gen = torch.Generator(device="cuda").manual_seed(seed + 151)
    pn, pnch, pe, pb, pex = PAR_N, PAR_NCH, PAR_E, PAR_B, 16
    pcx = torch.randn((pn, pex, 8), generator=gen, device="cuda")
    pcy = torch.randn((pn, pex), generator=gen, device="cuda")
    pu = torch.rand((r, 2, pnch), generator=gen, device="cuda")
    pp0 = {"w": torch.zeros(8, device="cuda"), "b": torch.zeros((), device="cuda")}

    def ploss(p, x, y):
        return ((x @ p["w"] + p["b"] - y) ** 2).mean()

    proc = make_scenario("piecewise", n_channels=pnch, horizon=r, n_breakpoints=2)
    sparse = SparseAsyncFLTrainer(
        SparseFLConfig(n_clients=pn, n_sched=pn, n_channels=pnch, batch_size=pb,
                       local_epochs=pe, staleness_cap=3, max_update_norm=50.0),
        LyapunovSched(pnch, pn), proc, ploss,
        realize_generator=torch.Generator(device="cuda").manual_seed(seed + 152))
    served(sparse, lambda: sparse.run(sparse.init(pp0), pcx, pcy, uniforms=pu, data_seed=seed),
           lambda srv: sparse.run_served(sparse.init(pp0), pcx, pcy, srv, "job", uniforms=pu,
                                         data_seed=seed),
           f"sparse lyapunov (M=N={pn}, {pnch} channels)")
    return {k: sum(p[k] for p in counted) for k in COUNTERS}


def served_baselines(torch, seed, phase8_launches):
    """Phase 15: the scheduler service for every policy it serves besides
    streaming GLR-CUCB, at the ``serve_suite``'s sizes (N = 16, M = 4,
    capacity 256, slot batch 64).  Returns the launches of the served runs
    (each counted from zero) and the rates by policy."""
    t_phase = time.perf_counter()
    paths, rates = [], {}
    for name, sched in served_policies(SCHED_N, SCHED_M):
        launches, ms_step = served_parity(torch, name, sched, seed)
        paths.append(launches)
        launches, rate = served_pool(torch, name, sched, seed)
        paths.append(launches)
        rates[name] = dict(rate, parity_ms_step=ms_step)
    paths.append(served_fl(torch, seed))
    # (d) phase 8's streaming GLR-CUCB service launched no tenant glr_scan
    check(phase8_launches["glr_scan_tenants"] == 0 and phase8_launches["glr_step_tenants"] > 0,
          f"phase 15 (d): phase 8's launches {phase8_launches}")
    line(f"  (d) phase 8 (streaming GLR-CUCB): glr_step_tenants "
         f"{phase8_launches['glr_step_tenants']}, glr_scan_tenants "
         f"{phase8_launches['glr_scan_tenants']}, glr_step {phase8_launches['glr_step']}; its "
         f"parity, 3-step and run_served checks passed above, unchanged")
    launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
    check(launches["glr_scan_tenants"] > 0,
          f"phase 15: a kernel of the slice never launched: {launches}")
    line(f"  phase 15 launches: glr_scan_tenants {launches['glr_scan_tenants']}, "
         f"weighted_aggregate {launches['weighted_aggregate']}; wall "
         f"{time.perf_counter() - t_phase:.1f} s")
    return launches, rates


# ---------------------------------------------------------------------------
# phase 16: MLA and MoE serving
# ---------------------------------------------------------------------------

def attention_at(torch, gen, shape, window, label, floor_ms, fma_turns=False, causal=True):
    """``flash_attention`` at a model's prefill ``shape`` (B, Hq, Hkv, S, D),
    bf16, causal (or not) with ``window``: on the route ``tc_route`` picks,
    within rtol 2**-8 / atol 1e-4 of the f32 plain version (phase 2's bf16
    tolerance), timed beside the plain version and SDPA (``enable_gqa``;
    the window must then cover S, so that SDPA's mask is the same), none of
    it counted as launches of a path.  With ``fma_turns`` the tensor-core
    route is timed twice, around the FMA route on the same inputs
    (``routes_in_turns``), and the line adds the split-P ceiling.  Prints
    ``label``'s line; returns the entry for the kernels line."""
    from torch.nn import functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
    from repro_torch.kernels.flash_attention import tc_route
    from repro_torch.utils import roofline as rl

    b, hq, hkv, s, d = shape
    q = (torch.randn((b, hq, s, d), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    k = (torch.randn((b, hkv, s, d), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    tc = tc_route(torch.bfloat16, d)
    route = "tensor-core" if tc else "FMA"
    before = (fa_kernel.tc_launches, fa_kernel.fma_launches)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.mha_attention(q.float(), k.float(), v.float(), causal=causal, window=window)
    torch.cuda.synchronize()
    check((fa_kernel.tc_launches, fa_kernel.fma_launches) == (before[0] + tc, before[1] + (not tc)),
          f"{label}: flash_attention {shape} bf16 not on the {route} route")
    err = float((got.float() - want).abs().max())
    check(torch.allclose(got.float(), want, rtol=2.0 ** -8, atol=1e-4),
          f"{label}: flash_attention {shape} beyond rtol 2^-8 atol 1e-4 ({err:.3e})")
    del got, want
    check(window == 0 or window >= s, f"{label}: SDPA takes no window shorter than S")
    check(tc and causal or not fma_turns,
          f"{label}: the FMA route is timed in turns only beside the tensor cores, causal")
    times = (routes_in_turns(torch, q, k, v, window, 20) if fma_turns else
             dict(ms=time_ms(torch, lambda: fa_kernel(q, k, v, causal=causal, window=window),
                             20)))
    fa = dict(shape_b_hq_hkv_s_d=list(shape), causal=causal, window=window, dtype="bfloat16",
              route="cuda-" + ("tc" if tc else "fma"), max_abs_err=err, **times,
              plain_ms=time_ms(torch, lambda: ref.mha_attention(q, k, v, causal=causal,
                                                                window=window), 3),
              library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=causal, enable_gqa=True), 20))
    fa["bound_ms"], fa["bound_by"] = attn_bound_ms(torch, shape, causal, window, torch.bfloat16)
    flops = 4 * b * hq * d * attn_pairs(s, causal, window)
    turns = ""
    if fma_turns:
        split_ms = 1.5 * flops / rl.PEAK_FLOPS_BF16 * 1e3
        turns = (f" / {fa['ms_again']:.4f} ms around the FMA route {fa['fma_ms']:.4f} ms "
                 f"({flops / fa['fma_ms'] / 1e9:.1f} TFLOP/s, "
                 f"{fa['fma_ms'] / fa['ms']:.1f}x), split-P ceiling {split_ms:.4f} ms "
                 f"(1.5x the products)")
    line(f"  {label} flash_attention (B, Hq, Hkv, S, D)={shape} "
         f"{'causal' if causal else 'non-causal'} window {window} bf16, "
         f"{route} route: max_abs_err {err:.3e} vs f32 plain (rtol 2^-8 atol 1e-4) ok; kernel "
         f"{fa['ms']:.4f} ms ({flops / fa['ms'] / 1e9:.1f} TFLOP/s){turns}, plain "
         f"{fa['plain_ms']:.4f} ms, library (SDPA, enable_gqa) {fa['library_ms']:.4f} ms, "
         f"bound {fa['bound_ms']:.4f} ms ({fa['bound_by']} at 989 TFLOP/s, {flops:.4e} flops), "
         f"launch floor {floor_ms:.5f} ms")
    del q, k, v
    release(torch)
    return fa


def attention_bwd_at(torch, seed, shape, causal, window, label, kernel=None):
    """The backward kernels (``flash_attention_bwd``) at a model's training
    ``shape`` (B, Hq, Hkv, S, D), bf16, with the mask of its attention, none
    of it counted as launches of a path: the tensor-core forward's logsumexp
    against the plain version's (rtol / atol 1e-5: the same f32 logits,
    summed in another order); dq, dk, dv against ``ref.mha_attention_bwd``
    in f32 on the same bf16 inputs, kernel output and logsumexp, per tensor
    within ``BWD_RTOL |want| + BWD_ATOL max|want|`` (2^-6, 2^-7: the
    emulation in tests/test_torch_flash_bwd_split.py); two calls bitwise
    equal; and the plain chunked backward route (``_KernelAttention``'s
    recompute, which f32 calls keep) held against the kernel by the same
    rule.  Times: the kernel (CUDA events), the plain version, the chunked
    route, SDPA's backward (its forward outside the timed window; the
    yardstick only) and the bound (``cost_bwd``).  ``kernel``, called as
    ``flash_attention_bwd``, replaces the wrapper in every check and time
    (tools/flash_bwd_ab.py passes another tree's kernels; their launches are
    then not counted).  Prints ``label``'s line; returns the entry for the
    kernels line."""
    from torch.nn import functional as F

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import _KernelAttention

    b, hq, hkv, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda h, sd: (torch.randn((b, h, s, d), generator=gen, device="cuda") * sd).to(
        torch.bfloat16)
    q, k, v, do = rand(hq, 0.5), rand(hkv, 0.5), rand(hkv, 1.0), rand(hq, 1.0)
    scale = 1.0 / math.sqrt(d)
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    _, want_lse = ref.mha_attention(q.float(), k.float(), v.float(), causal=causal,
                                    window=window, return_lse=True)
    lse_err = float((lse - want_lse).abs().max())
    check(torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5),
          f"{label} flash_attention's logsumexp {shape} beyond rtol/atol 1e-5 ({lse_err:.3e})")
    del want_lse
    own = kernel is None
    call, kernel = (ops.flash_attention_bwd, fa_mod.flash_attention_bwd) if own else (kernel,) * 2
    before = fa_mod.flash_attention_bwd.launches
    got = call(q, k, v, out, lse, do, causal=causal, window=window, scale=scale)
    again = call(q, k, v, out, lse, do, causal=causal, window=window, scale=scale)
    torch.cuda.synchronize()
    check(not own or fa_mod.flash_attention_bwd.launches == before + 2,
          f"{label} flash_attention_bwd {shape}: not launched")
    names = ("dq", "dk", "dv")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{label} flash_attention_bwd {shape}: two calls differ")
    del again
    want = ref.mha_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse, do.float(),
                                 causal=causal, window=window)
    excess = [fa_mod.bwd_within(g, w) for g, w in zip(got, want)]
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    check(max(excess) <= 1.0, f"{label} flash_attention_bwd {shape}: beyond rtol 2^-6 / atol "
          f"2^-7 max|want| against f32 plain: {dict(zip(names, excess))}")
    del want

    class Ctx:                      # _KernelAttention's context on its chunked route
        saved_tensors, kernel_backward = (q, k, v), False
        args = (causal, window, scale, 512)

    plain_route = lambda: _KernelAttention.backward(Ctx, do)[:3]
    route_excess = [fa_mod.bwd_within(g, w) for g, w in zip(got, plain_route())]
    check(max(route_excess) <= 1.0, f"{label} flash_attention_bwd {shape}: beyond the check "
          f"against the plain chunked route: {dict(zip(names, route_excess))}")
    del got
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
    check(window == 0 or window >= s, f"{label}: SDPA takes no window shorter than S")
    t = dict(shape_b_hq_hkv_s_d=list(shape), causal=causal, window=window, dtype="bfloat16",
             route="cuda-wgmma", max_abs_err=err, excess=dict(zip(names, excess)),
             excess_vs_chunked_route=dict(zip(names, route_excess)), lse_max_abs_err=lse_err,
             ms=time_ms(torch, lambda: kernel(q, k, v, out, lse, do, causal=causal,
                                               window=window, scale=scale), 20),
             plain_ms=time_ms(torch, lambda: ref.mha_attention_bwd(
                 q, k, v, out, lse, do, causal=causal, window=window), 3),
             chunked_route_ms=time_ms(torch, plain_route, 3),
             library_ms=time_ms(torch, lambda: torch.autograd.grad(
                 o_sdpa, leaves, do, retain_graph=True), 20))
    kc = fa_mod.cost_bwd(shape, causal, window, torch.bfloat16)
    t["bound_ms"], t["bound_by"] = bound_of(kc)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    before = (f", {BWD_MMA_SYNC_MS[tuple(shape)]:.4f} ms before the redesign (the mma.sync "
              f"kernels)" if tuple(shape) in BWD_MMA_SYNC_MS else "")
    line(f"  {label} flash_attention_bwd (B, Hq, Hkv, S, D)={shape} "
         f"{'causal' if causal else 'non-causal'} window {window} bf16: logsumexp max_abs_err "
         f"{lse_err:.2e} (rtol/atol 1e-5) ok; dq, dk, dv max_abs_err {err:.3e}, "
         f"|err| - 2^-6 |want| at most {max(excess):.3f} of 2^-7 max|want| vs f32 plain, "
         f"{max(route_excess):.3f} vs the plain chunked route; two calls bitwise ok; kernel "
         f"{t['ms']:.4f} ms ({kc.ops / t['ms'] / 1e9:.1f} TFLOP/s, "
         f"{100 * t['bound_share']:.1f} % of the bound){before}, plain "
         f"{t['plain_ms']:.4f} ms, plain chunked route {t['chunked_route_ms']:.4f} ms, library "
         f"(SDPA backward, enable_gqa) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
         f"({t['bound_by']}, {kc.ops:.4e} flops)")
    del q, k, v, do, out, lse, leaves, o_sdpa
    release(torch)
    return t


def dbrx_attention(torch, gen, floor_ms):
    """(0) ``flash_attention`` at dbrx-132b's prefill shape, bf16 causal, 6
    query heads a KV head, on the tensor-core route (``attention_at``).
    Returns its entry for the kernels line."""
    fa = attention_at(torch, gen, DBRX_ATTN, 0, "(0) dbrx-132b's prefill:", floor_ms)
    check(fa["route"] == "cuda-tc", "phase 16 (0): dbrx's attention not on the tensor-core route")
    return fa


def mla_moe_reference(torch, seed, arch):
    """(a) ``arch`` at full width, 2 layers, f32: the kernel route's prefill
    of one 2048-token prompt against the plain chunked route (rtol/atol
    2e-3; GQA launches ``flash_attention`` once a layer on the FMA route,
    MLA never), then 12 teacher-forced decode steps against ``apply``'s
    logits (rtol/atol 2e-3), an MoE model at its no-drop capacity."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity

    cfg = dataclasses.replace(get_config(arch), n_layers=SERVE_REF_LAYERS, dtype="float32")
    note = ""
    if cfg.n_experts:
        # every expert a slot for every token of the row: a prefill that drops
        # cannot equal decode, which never drops
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
        check(capacity(cfg, SERVE_PROMPT) >= SERVE_PROMPT, f"phase 16 (a) {arch}: capacity")
        note = (f", capacity_factor {cfg.capacity_factor:.4g} (n_experts / experts_per_token: "
                f"{capacity(cfg, SERVE_PROMPT)} slots an expert, no token drops)")
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    model, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params, _ = model.init(gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, SERVE_PROMPT), generator=gen, device="cuda",
                         dtype=torch.int32)
    batch = {"tokens": toks}
    kern = SERVE_REF_LAYERS if cfg.attention == "gqa" else 0
    before, before_fma = kernel.launches, kernel.fma_launches
    got = make_prefill_step(model)(params, batch)
    check(kernel.launches == before + kern and kernel.fma_launches == before_fma + kern,
          f"phase 16 (a) {arch}: the kernel route launched {kernel.launches - before} kernels, "
          f"{kernel.fma_launches - before_fma} on the FMA route, expected {kern}")
    want = make_prefill_step(plain)(params, batch)
    check(kernel.launches == before + kern, f"phase 16 (a) {arch}: the plain route ran the kernel")
    err = float((got - want).abs().max())
    check(got.shape == (1, 1, cfg.vocab_size) and bool(torch.isfinite(got).all()),
          f"phase 16 (a) {arch}: prefill logits {tuple(got.shape)} not finite or misshapen")
    check(torch.allclose(got, want, rtol=2e-3, atol=2e-3),
          f"phase 16 (a) {arch}: kernel-route prefill beyond rtol/atol 2e-3 of the plain route "
          f"({err:.3e})")
    line(f"  (a) {arch} width {cfg.d_model}, {cfg.n_layers} layers, {cfg.attention}"
         f"{' + MoE' if cfg.n_experts else ''}, f32{note}: prefill of {SERVE_PROMPT} tokens, "
         f"kernel route vs plain chunked route max_abs_err={err:.3e} (max |logit| "
         f"{float(want.abs().max()):.3f}; rtol/atol 2e-3) ok; flash_attention launches "
         f"{kern} (FMA route)")
    full, _ = model.apply(params, batch)
    cache = model.init_cache(1, SERVE_PROMPT, dtype=torch.float32, device="cuda")
    dec_err = 0.0
    for t in range(DECODE_REF_STEPS):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        ref_t = full[:, t].float()
        dec_err = max(dec_err, float((lg - ref_t).abs().max()))
        check(torch.allclose(lg, ref_t, rtol=2e-3, atol=2e-3),
              f"phase 16 (a) {arch}: decode step {t} beyond rtol/atol 2e-3 of apply's logits "
              f"({dec_err:.3e})")
    line(f"  (a) {arch} f32: {DECODE_REF_STEPS} teacher-forced decode steps match apply's "
         f"logits, max_abs_err={dec_err:.3e} (rtol/atol 2e-3) ok")
    del params, got, want, full, cache, lg
    release(torch)


def router_on_card(torch, seed):
    """(b) deepseek-v2's router at full width on 2048 bf16 tokens: the
    card's top-6 ids, the expert order of the assignments, their slots and
    keep mask bitwise those of the port's CPU code on the same
    probabilities copied down; then one MoE layer in f32 at the default
    capacity (tokens drop) against a per-token loop over the kept (token,
    expert) pairs, rtol 2e-3."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import ParamBuilder, swiglu

    cfg = get_config(ROUTER_ARCH)
    d, e, k = cfg.d_model, cfg.n_experts, cfg.experts_per_token
    cap = moe.capacity(cfg, ROUTER_TOKENS)
    gen = torch.Generator(device="cuda").manual_seed(seed + 161)
    x = torch.randn((1, ROUTER_TOKENS, d), generator=gen, device="cuda").to(torch.bfloat16)
    router = (torch.randn((d, e), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    probs = torch.softmax((x @ router).float(), dim=-1)

    def plan(pr):
        topw, topi = moe.route(pr, k)
        return (topi,) + moe.dispatch(topi, topw, e, cap)

    card = [t.cpu() for t in plan(probs)]
    cpu = plan(probs.cpu())
    for name, a, b in zip(("top-k ids", "expert order", "slots"), card, cpu):
        check(torch.equal(a, b), f"phase 16 (b): the card's {name} differ from the CPU's")
    keep_card, keep_cpu = card[2] < e * cap, cpu[2] < e * cap
    check(torch.equal(keep_card, keep_cpu), "phase 16 (b): the card's keep mask differs")
    w_err = float((card[3] - cpu[3]).abs().max())
    check(torch.allclose(card[3], cpu[3], rtol=1e-6, atol=0),
          f"phase 16 (b): kept weights beyond rtol 1e-6 of the CPU's ({w_err:.3e})")
    desc = torch.sort(probs, dim=-1, descending=True).values
    boundary = int((desc[..., k - 1] == desc[..., k]).sum())
    inside = int((desc[..., :k - 1] == desc[..., 1:k]).any(-1).sum())
    dropped = int((~keep_card).sum())
    line(f"  (b) {ROUTER_ARCH} router, {ROUTER_TOKENS} bf16 tokens x width {d}, {e} experts, "
         f"top-{k}, router std 0.02: {boundary} tokens tie across the top-{k} boundary, "
         f"{inside} inside their top {k}; capacity {cap}, {dropped} of {ROUTER_TOKENS * k} "
         f"assignments dropped; the card's top-k ids, expert order, slots and keep mask equal "
         f"the CPU code's on the same probabilities bit for bit (weights max diff "
         f"{w_err:.3e}) ok")
    del probs, router, card, cpu

    # one MoE layer in f32 at the default capacity against a per-token loop
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    pb = ParamBuilder(gen, dtype=torch.float32, device="cuda")
    moe.add_moe_params(pb, "m", cfg32)
    p = pb.params
    xf = x.float()
    out, _ = moe.moe_ffn(p, "m", xf, cfg32)
    topi, order, slot, keep_w = plan(torch.softmax(xf @ p["m/router"], dim=-1))
    kept = (slot < e * cap)[0]
    toks, experts, weights = ((order[0][kept] // k).tolist(), (slot[0][kept] // cap).tolist(),
                              keep_w[0][kept])
    by_tok = {}
    for i, (t, ex) in enumerate(zip(toks, experts)):
        by_tok.setdefault(t, []).append((ex, i))
    ref = swiglu(xf[0], p["m/ws_gate"], p["m/ws_up"], p["m/ws_down"])
    wg, wu, wd = p["m/w_gate"], p["m/w_up"], p["m/w_down"]
    for t, pairs in by_tok.items():
        ids = torch.tensor([ex for ex, _ in pairs], device="cuda")
        w = weights[[i for _, i in pairs]]
        g = torch.einsum("d,edf->ef", xf[0, t], wg[ids])
        u = torch.einsum("d,edf->ef", xf[0, t], wu[ids])
        y = torch.einsum("ef,efd->ed", torch.nn.functional.silu(g) * u, wd[ids])
        ref[t] += (w[:, None] * y).sum(0)
    err = float((out[0] - ref).abs().max())
    check(torch.allclose(out[0], ref, rtol=2e-3, atol=2e-3 * float(ref.abs().max())),
          f"phase 16 (b): the MoE layer beyond rtol 2e-3 of the per-token loop ({err:.3e})")
    line(f"  (b) {ROUTER_ARCH} MoE layer, f32, {ROUTER_TOKENS} tokens at capacity {cap}: "
         f"{len(toks)} kept (token, expert) pairs over {len(by_tok)} tokens; against a "
         f"per-token loop over them max_abs_err={err:.3e} (max |out| "
         f"{float(ref.abs().max()):.3f}; rtol 2e-3) ok")
    del p, pb, out, ref, xf, x
    release(torch)


def mla_moe_serve(torch, seed, arch, n_layers):
    """(c) ``arch`` at full width and ``n_layers`` depth in bf16: three
    prefills of 4 x 2048 tokens and the serve loop, the main path whose
    launches are counted; then (not counted) a profiled prefill split by
    the model's profiler ranges and a profiled decode window."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, moe
    from repro_torch.models.attention import FORWARD_RANGE

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    model = build_model(cfg)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    h0, free0 = allocator_bytes(torch), free_blocks(torch)
    m0 = h0[0]
    gen = torch.Generator(device="cuda").manual_seed(seed + 162)
    t0 = time.perf_counter()
    params, _ = model.init(gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = minus(allocator_bytes(torch), h0)
    n_params = sum(v.numel() for v in params.values())
    mla = cfg.attention == "mla"
    norms = (n_layers * (2 * cfg.d_model + (cfg.q_lora_rank + cfg.kv_lora_rank) * mla
                         + 2 * cfg.resolved_head_dim * cfg.qk_norm) + cfg.d_model)
    check(n_params == cfg.param_count() + norms,      # param_count leaves out the norm gains
          f"phase 16 (c) {arch}: {n_params} params, config says {cfg.param_count()} + {norms}")
    weights_gib = sum(v.numel() * v.element_size() for v in params.values()) / 2 ** 30
    line(f"  (c) {arch}: {n_layers} of {get_config(arch).n_layers} layers, width {cfg.d_model}, "
         f"bf16, {n_params / 1e9:.3f} B params = param_count() + {norms} norm gains "
         f"({weights_gib:.2f} GiB) drawn on the card in {init_s:.2f} s")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_PREFILL_BATCH, SERVE_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    prefill = make_prefill_step(model)
    kern = 0 if mla else n_layers
    prefill_static = minus(allocator_bytes(torch), h0)

    reset_launches()
    prefill_ms = []
    for i in range(3):                    # the first one is the warm-up
        before, before_tc = kernel.launches, kernel.tc_launches
        torch.cuda.synchronize()
        if i == 2:
            prefill_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()      # phase 19 (b): the peak of one prefill
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        check(kernel.launches == before + kern and kernel.tc_launches == before_tc + kern,
              f"phase 16 (c) {arch}: flash_attention launched {kernel.launches - before} times "
              f"in a prefill, {kernel.tc_launches - before_tc} on the tensor-core route, "
              f"expected {kern}")
        check(logits.shape == (SERVE_PREFILL_BATCH, 1, cfg.vocab_size)
              and logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
              f"phase 16 (c) {arch}: prefill logits {tuple(logits.shape)} {logits.dtype} not "
              f"finite or misshapen")
    card = {"card_prefill": card_step(prefill_static, torch.cuda.max_memory_allocated() - m0,
                                      per_step(read_launches(), 3, f"phase 16 (c) {arch}"),
                                      sum(prefill_ms[1:]) / 2, (free0,))}
    prefill_peak = max(prefill_peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    release(torch)
    m_pre, free1 = allocator_bytes(torch), free_blocks(torch)
    tok, cache, secs = serve_loop(model, params, SERVE_BATCH, SERVE_CONTEXT, SERVE_TOKENS,
                                  device="cuda")
    launches = read_launches()
    check(int(cache["pos"]) == SERVE_TOKENS, f"phase 16 (c) {arch}: cache pos {int(cache['pos'])}")
    check(tok.shape == (SERVE_BATCH,) and tok.dtype == torch.int32
          and bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
          f"phase 16 (c) {arch}: decoded tokens invalid")
    cache_gib = sum(v.numel() * v.element_size() for layer in cache.values()
                    if isinstance(layer, dict) for v in layer.values()) / 2 ** 30
    step_ms = secs / SERVE_TOKENS * 1e3
    card["card_decode"] = decode_step_card(torch, model, params, cache, tok, m_pre, weights,
                                           step_ms, (free0, free1))
    line(f"  (c) {arch}: prefill {SERVE_PREFILL_BATCH} x {SERVE_PROMPT} tokens "
         f"{prefill_ms[1]:.1f} / {prefill_ms[2]:.1f} ms (warm-up {prefill_ms[0]:.1f} ms), "
         f"{SERVE_PREFILL_BATCH * SERVE_PROMPT / (prefill_ms[1] / 1e3):.0f} prompt tok/s; "
         f"flash_attention {launches['flash_attention'] // 3} a prefill "
         f"({launches['flash_attention_tc'] // 3} on the tensor-core route); peak device memory "
         f"in the prefills {prefill_peak:.2f} GiB")
    line(f"  (c) [serve] {arch}: {SERVE_TOKENS} tokens x {SERVE_BATCH} seqs in {secs:.2f}s "
         f"({SERVE_BATCH * SERVE_TOKENS / secs:.1f} tok/s, {step_ms:.2f} ms a decode step, "
         f"context {SERVE_CONTEXT}, cache {cache_gib:.3f} GiB), cache pos={int(cache['pos'])}")

    # not counted: one profiled prefill split by the model's ranges, a decode window
    events, wall_us = trace_events(torch, lambda: prefill(params, batch))
    kernels = [ev for ev in events if ev.get("cat") == "kernel" and "dur" in ev]
    total = sum(float(ev["dur"]) for ev in kernels)
    parts = {"expert products": range_device_us(events, moe.EXPERTS_RANGE)[0],
             "dispatch and combine": range_device_us(events, moe.DISPATCH_RANGE)[0]
             + range_device_us(events, moe.COMBINE_RANGE)[0],
             "attention": range_device_us(events, FORWARD_RANGE)[0]}
    parts["the rest"] = total - sum(parts.values())
    split = ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f} %)" for k, v in parts.items()) \
        if total else "no device kernels in the trace (not measured)"
    line(f"  (c) {arch} prefill profile: wall {wall_us / 1e3:.1f} ms, {len(kernels)} kernels, "
         f"device time {total / 1e3:.2f} ms: {split}")
    steps = 4
    out = {}

    def decode():
        tk, c = tok, cache
        for _ in range(steps):
            lg, c = model.decode_step(params, c, tk)
            tk = lg.argmax(-1).to(torch.int32)
        out["logits"] = lg

    profile_window(torch, f"{arch} decode batch {SERVE_BATCH}", decode, steps)
    lg = out["logits"]
    check(lg.shape == (SERVE_BATCH, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
          f"phase 16 (c) {arch}: decode logits not finite or misshapen")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line(f"  (c) {arch}: decode logits finite, peak device memory {peak:.2f} GiB")
    del params, logits, cache, lg, out
    release(torch)
    return launches, dict(weights_gib=weights_gib, prefill_ms=prefill_ms[1:],
                          decode_step_ms=step_ms, tok_s=SERVE_BATCH * SERVE_TOKENS / secs,
                          peak_gib=peak, prefill_split_us=parts, prefill_device_us=total,
                          card=card)


def mla_moe_serving(torch, seed, floor_ms):
    """Phase 16: MLA and MoE serving, one model at a time.  Returns the
    launches of the served runs (each counted from zero) and
    ``flash_attention``'s entry at dbrx's shape for the kernels line."""
    t_phase = time.perf_counter()
    fa = dbrx_attention(torch, torch.Generator(device="cuda").manual_seed(seed + 160), floor_ms)
    for arch, _ in MLA_MOE_SERVED:
        mla_moe_reference(torch, seed, arch)
    router_on_card(torch, seed)
    paths, served = [], {}
    for arch, n_layers in MLA_MOE_SERVED:
        launches, served[arch] = mla_moe_serve(torch, seed, arch, n_layers)
        paths.append(launches)
    launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
    dbrx_layers = dict(MLA_MOE_SERVED)["dbrx-132b"]
    check(launches["flash_attention"] == launches["flash_attention_tc"] == 3 * dbrx_layers,
          f"phase 16: flash_attention launches {launches}, expected {3 * dbrx_layers} "
          f"(dbrx's three prefills)")
    fa["launches"] = launches["flash_attention"]
    line(f"  phase 16 launches: flash_attention {launches['flash_attention']} (tensor-core "
         f"{launches['flash_attention_tc']}); wall {time.perf_counter() - t_phase:.1f} s")
    return launches, fa, served


# ---------------------------------------------------------------------------
# phase 17: SSM, RG-LRU hybrid and VLM serving
# ---------------------------------------------------------------------------

def model_batch(torch, cfg, b, s, gen, device="cuda"):
    """A batch of ``cfg``'s family drawn from ``gen`` on ``device``: ``b``
    sequences of ``s`` random tokens, and for a VLM ``frontend_tokens``
    random patch embeddings each (std 1, in the model's dtype: the stub
    frontend's output); for the audio encoder ``s`` frames (std 1, in the
    model's dtype), random labels and a mask at ``mask_prob``."""
    from repro_torch.models.layers import torch_dtype

    dt = torch_dtype(cfg.dtype)
    if cfg.arch_type == "audio":
        return {"frames": torch.randn((b, s, cfg.d_model), generator=gen, device=device).to(dt),
                "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device,
                                        dtype=torch.int32),
                "mask": torch.rand((b, s), generator=gen, device=device) < cfg.mask_prob}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device,
                                     dtype=torch.int32)}
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.randn((b, cfg.frontend_tokens, cfg.d_model), generator=gen,
                                             device=device).to(dt)
    return batch


def hybrid_reference(torch, seed, arch, n_layers, window=None, steps=DECODE_REF_STEPS):
    """(b) ``arch`` at full width, ``n_layers`` deep, f32 (``window``: the
    local attention window cut to that): the kernel route's prefill of one
    2048-token prompt (a VLM's behind its patch embeddings) against the
    plain chunked route (rtol/atol 2e-3), then ``steps`` teacher-forced
    decode steps against ``apply``'s logits on the same tokens (rtol/atol
    2e-3).  mamba2's prefill is also run on the CPU, on the same weights
    and tokens, and must equal the card's (rtol/atol 2e-3): its L = 256
    chunks take the upper triangle's exponent past exp's f32 overflow."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    over = {} if window is None else {"local_attn_window": window}
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32", **over)
    gen = torch.Generator(device="cuda").manual_seed(seed + 170)
    model, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params, _ = model.init(gen, device="cuda")
    batch = model_batch(torch, cfg, 1, SERVE_PROMPT, gen)
    kern = attn_layers(cfg, n_layers)
    before, before_fma = kernel.launches, kernel.fma_launches
    got = make_prefill_step(model)(params, batch)
    check(kernel.launches == before + kern and kernel.fma_launches == before_fma + kern,
          f"phase 17 (b) {arch}: the kernel route launched {kernel.launches - before} kernels, "
          f"{kernel.fma_launches - before_fma} on the FMA route, expected {kern}")
    want = make_prefill_step(plain)(params, batch)
    check(kernel.launches == before + kern, f"phase 17 (b) {arch}: the plain route ran the kernel")
    err = float((got - want).abs().max())
    check(got.shape == (1, 1, cfg.vocab_size) and bool(torch.isfinite(got).all()),
          f"phase 17 (b) {arch}: prefill logits {tuple(got.shape)} not finite or misshapen")
    check(torch.allclose(got, want, rtol=2e-3, atol=2e-3),
          f"phase 17 (b) {arch}: kernel-route prefill beyond rtol/atol 2e-3 of the plain route "
          f"({err:.3e})")
    cut = "" if window is None else f", local_attn_window cut to {window} (the ring wraps)"
    vision = f" behind {cfg.frontend_tokens} patch embeddings" if cfg.arch_type == "vlm" else ""
    line(f"  (b) {arch} width {cfg.d_model}, {n_layers} layers "
         f"({', '.join(cfg.layer_kind(i) for i in range(n_layers))}), f32{cut}: prefill of "
         f"{SERVE_PROMPT} tokens{vision}, kernel route vs plain chunked route "
         f"max_abs_err={err:.3e} (max |logit| {float(want.abs().max()):.3f}; rtol/atol 2e-3) ok; "
         f"flash_attention launches {kern} (FMA route)")
    if cfg.arch_type == "ssm":
        cpu = make_prefill_step(model)({k: v.cpu() for k, v in params.items()},
                                       {k: v.cpu() for k, v in batch.items()})
        cpu_err = float((got.cpu() - cpu).abs().max())
        check(torch.allclose(got.cpu(), cpu, rtol=2e-3, atol=2e-3),
              f"phase 17 (b) {arch}: the card's prefill beyond rtol/atol 2e-3 of the CPU's "
              f"({cpu_err:.3e})")
        line(f"  (b) {arch} f32: the card's prefill ({SERVE_PROMPT // cfg.ssm_chunk} chunks of "
             f"{cfg.ssm_chunk}) finite and equal to the CPU's run of the same weights, "
             f"max_abs_err={cpu_err:.3e} (rtol/atol 2e-3) ok")
    toks = batch["tokens"][:, :steps]
    full, _ = model.apply(params, {"tokens": toks})
    cache = model.init_cache(1, steps, dtype=torch.float32, device="cuda")
    dec_err = 0.0
    for t in range(steps):
        lg, cache = model.decode_step(params, cache, toks[:, t])
        dec_err = max(dec_err, float((lg - full[:, t]).abs().max()))
        check(torch.allclose(lg, full[:, t], rtol=2e-3, atol=2e-3),
              f"phase 17 (b) {arch}: decode step {t} beyond rtol/atol 2e-3 of apply's logits "
              f"({dec_err:.3e})")
    line(f"  (b) {arch} f32{cut}: {steps} teacher-forced decode steps match apply's logits, "
         f"max_abs_err={dec_err:.3e} (rtol/atol 2e-3) ok")
    del params, got, want, full, cache, lg
    release(torch)


def hybrid_serve(torch, seed, arch):
    """(c) ``arch`` at full width and depth in bf16: three prefills of 4 x
    2048 tokens (a VLM's behind 144 random patch embeddings) and the serve
    loop, the main path whose launches are counted; then (not counted) a
    profiled prefill split by the model's profiler ranges and a profiled
    decode window."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.kernels.flash_attention import tc_route
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model, rglru, ssm
    from repro_torch.models.attention import FORWARD_RANGE

    cfg = get_config(arch)
    model = build_model(cfg)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    h0, free0 = allocator_bytes(torch), free_blocks(torch)
    m0 = h0[0]
    gen = torch.Generator(device="cuda").manual_seed(seed + 171)
    t0 = time.perf_counter()
    params, _ = model.init(gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = minus(allocator_bytes(torch), h0)
    n_params = sum(v.numel() for v in params.values())
    specs, _ = model.param_specs()
    n_specs = sum(v.numel() for v in specs.values())
    check(n_params == n_specs,
          f"phase 17 (c) {arch}: {n_params} params drawn, param_specs() says {n_specs}")
    weights_gib = sum(v.numel() * v.element_size() for v in params.values()) / 2 ** 30
    kinds = sorted({cfg.layer_kind(i) for i in range(cfg.n_layers)})
    line(f"  (c) {arch}: all {cfg.n_layers} layers ({'/'.join(kinds)}), width {cfg.d_model}, "
         f"bf16, {n_params / 1e9:.3f} B params = the sum over param_specs() (param_count() "
         f"{cfg.param_count() / 1e9:.3f} B, approximate for ssm and rglru) ({weights_gib:.2f} "
         f"GiB) drawn on the card in {init_s:.2f} s")
    batch = model_batch(torch, cfg, SERVE_PREFILL_BATCH, SERVE_PROMPT, gen)
    prefill = make_prefill_step(model)
    kern = attn_layers(cfg, cfg.n_layers)
    tc = bool(kern) and tc_route(torch.bfloat16, cfg.resolved_head_dim)
    s_total = batch["tokens"].shape[1] + (cfg.frontend_tokens if "vision_embeds" in batch else 0)
    prefill_static = minus(allocator_bytes(torch), h0)

    reset_launches()
    prefill_ms = []
    for i in range(3):                    # the first one is the warm-up
        before, before_tc = kernel.launches, kernel.tc_launches
        torch.cuda.synchronize()
        if i == 2:
            prefill_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()      # phase 19 (b): the peak of one prefill
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        check(kernel.launches == before + kern and kernel.tc_launches == before_tc + kern * tc,
              f"phase 17 (c) {arch}: flash_attention launched {kernel.launches - before} times "
              f"in a prefill, {kernel.tc_launches - before_tc} on the tensor-core route, "
              f"expected {kern} on the {'tensor-core' if tc else 'FMA'} route")
        check(logits.shape == (SERVE_PREFILL_BATCH, 1, cfg.vocab_size)
              and logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all()),
              f"phase 17 (c) {arch}: prefill logits {tuple(logits.shape)} {logits.dtype} not "
              f"finite or misshapen")
    card = {"card_prefill": card_step(prefill_static, torch.cuda.max_memory_allocated() - m0,
                                      per_step(read_launches(), 3, f"phase 17 (c) {arch}"),
                                      sum(prefill_ms[1:]) / 2, (free0,))}
    prefill_peak = max(prefill_peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    release(torch)
    m_pre, free1 = allocator_bytes(torch), free_blocks(torch)
    tok, cache, secs = serve_loop(model, params, SERVE_BATCH, SERVE_CONTEXT, SERVE_TOKENS,
                                  device="cuda")
    launches = read_launches()
    check(int(cache["pos"]) == SERVE_TOKENS, f"phase 17 (c) {arch}: cache pos {int(cache['pos'])}")
    check(tok.shape == (SERVE_BATCH,) and tok.dtype == torch.int32
          and bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
          f"phase 17 (c) {arch}: decoded tokens invalid")
    cache_gib = sum(v.numel() * v.element_size() for layer in cache.values()
                    if isinstance(layer, dict) for v in layer.values()) / 2 ** 30
    step_ms = secs / SERVE_TOKENS * 1e3
    card["card_decode"] = decode_step_card(torch, model, params, cache, tok, m_pre, weights,
                                           step_ms, (free0, free1))
    patches = f" + {s_total - SERVE_PROMPT} patches" if s_total > SERVE_PROMPT else ""
    line(f"  (c) {arch}: prefill {SERVE_PREFILL_BATCH} x {s_total} positions "
         f"({batch['tokens'].shape[1]} tokens{patches}) "
         f"{prefill_ms[1]:.1f} / {prefill_ms[2]:.1f} ms (warm-up {prefill_ms[0]:.1f} ms), "
         f"{SERVE_PREFILL_BATCH * SERVE_PROMPT / (prefill_ms[1] / 1e3):.0f} prompt tok/s; "
         f"flash_attention {launches['flash_attention'] // 3} a prefill "
         f"({launches['flash_attention_tc'] // 3} tensor-core, "
         f"{launches['flash_attention_fma'] // 3} FMA); peak device memory in the prefills "
         f"{prefill_peak:.2f} GiB")
    line(f"  (c) [serve] {arch}: {SERVE_TOKENS} tokens x {SERVE_BATCH} seqs in {secs:.2f}s "
         f"({SERVE_BATCH * SERVE_TOKENS / secs:.1f} tok/s, {step_ms:.2f} ms a decode step, "
         f"context {SERVE_CONTEXT}, cache {cache_gib:.3f} GiB), cache pos={int(cache['pos'])}")

    # not counted: one profiled prefill split by the model's ranges, a decode window
    events, wall_us = trace_events(torch, lambda: prefill(params, batch))
    kernels = [ev for ev in events if ev.get("cat") == "kernel" and "dur" in ev]
    total = sum(float(ev["dur"]) for ev in kernels)
    parts = {"attention": range_device_us(events, FORWARD_RANGE)[0],
             "SSD chunk loop": range_device_us(events, ssm.SSD_RANGE)[0],
             "RG-LRU scan": range_device_us(events, rglru.SCAN_RANGE)[0],
             "causal conv": range_device_us(events, ssm.CONV_RANGE)[0]}
    parts["the rest"] = total - sum(parts.values())
    split = ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f} %)" for k, v in parts.items()) \
        if total else "no device kernels in the trace (not measured)"
    line(f"  (c) {arch} prefill profile: wall {wall_us / 1e3:.1f} ms, {len(kernels)} kernels, "
         f"device time {total / 1e3:.2f} ms: {split}")
    report_kernels(f"{arch} prefill 4 x {s_total}", kernels, wall_us, 1)
    steps = 4
    out = {}

    def decode():
        tk, c = tok, cache
        for _ in range(steps):
            lg, c = model.decode_step(params, c, tk)
            tk = lg.argmax(-1).to(torch.int32)
        out["logits"] = lg

    profile_window(torch, f"{arch} decode batch {SERVE_BATCH}", decode, steps)
    lg = out["logits"]
    check(lg.shape == (SERVE_BATCH, cfg.vocab_size) and bool(torch.isfinite(lg).all()),
          f"phase 17 (c) {arch}: decode logits not finite or misshapen")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    line(f"  (c) {arch}: decode logits finite, peak device memory {peak:.2f} GiB")
    del params, logits, cache, lg, out, batch
    release(torch)
    return launches, dict(weights_gib=weights_gib, prefill_ms=prefill_ms[1:],
                          decode_step_ms=step_ms, tok_s=SERVE_BATCH * SERVE_TOKENS / secs,
                          peak_gib=peak, prefill_split_us=parts, prefill_device_us=total,
                          card=card)


def hybrid_serving(torch, seed, floor_ms):
    """Phase 17: SSM, RG-LRU hybrid and VLM serving, one model at a time.
    Returns the launches of the served runs (each counted from zero) and
    ``flash_attention``'s entries at recurrentgemma's and phi-3-vision's
    prefill shapes for the kernels line."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 172)
    fa = {"recurrentgemma": attention_at(torch, gen, RGEMMA_ATTN, RGEMMA_WINDOW,
                                         "(a) recurrentgemma-2b's local attention:", floor_ms,
                                         fma_turns=True),
          "phi3v": attention_at(torch, gen, PHI3V_ATTN, 0, "(a) phi-3-vision-4.2b's prefill:",
                                floor_ms)}
    check(fa["recurrentgemma"]["route"] == "cuda-tc" and fa["phi3v"]["route"] == "cuda-tc",
          "phase 17 (a): the attention shapes took the wrong routes")
    for arch, n_layers in HYBRID_REF_LAYERS:
        hybrid_reference(torch, seed, arch, n_layers)
    hybrid_reference(torch, seed, "recurrentgemma-2b", 3, window=RING_CUT, steps=RING_STEPS)
    paths, served = {}, {}
    for arch, _ in HYBRID_REF_LAYERS:
        paths[arch], served[arch] = hybrid_serve(torch, seed, arch)
    launches = {k: sum(p[k] for p in paths.values()) for k in COUNTERS}
    want = {"mamba2-1.3b": (0, 0), "recurrentgemma-2b": (24, 0), "phi-3-vision-4.2b": (96, 0)}
    for arch, (tc, fma) in want.items():
        got = (paths[arch]["flash_attention_tc"], paths[arch]["flash_attention_fma"])
        check(got == (tc, fma) and paths[arch]["flash_attention"] == tc + fma,
              f"phase 17: {arch}'s flash_attention launches (tensor-core, FMA) {got}, "
              f"expected {(tc, fma)} (three prefills)")
    fa["recurrentgemma"]["launches"] = paths["recurrentgemma-2b"]["flash_attention"]
    fa["phi3v"]["launches"] = paths["phi-3-vision-4.2b"]["flash_attention"]
    line(f"  phase 17 launches: flash_attention {launches['flash_attention']} (tensor-core "
         f"{launches['flash_attention_tc']}, FMA {launches['flash_attention_fma']}); wall "
         f"{time.perf_counter() - t_phase:.1f} s")
    return launches, fa, served


# ---------------------------------------------------------------------------
# phase 18: training for the SSM, RG-LRU hybrid, VLM and audio families
# ---------------------------------------------------------------------------

def family_attention_shape(cfg, b=TRAIN_B, s=TRAIN_S):
    """(shape (B, Hq, Hkv, S, D), causal, window) of ``cfg``'s attention at
    a training batch of ``b`` sequences of ``s`` positions (a VLM's behind
    its patch embeddings)."""
    s = s + (cfg.frontend_tokens if cfg.arch_type == "vlm" else 0)
    return ((b, cfg.n_heads, cfg.n_kv_heads, s, cfg.resolved_head_dim), cfg.is_decoder,
            cfg.local_attn_window)


def family_attention(torch, gen, floor_ms):
    """(0) ``flash_attention`` bf16 at the three attending families'
    training shapes (``attention_at``: hubert's non-causal, the first at
    full size), each on the tensor-core route, and its gradient by the
    backward kernels (``attention_bwd_at``).  Returns their entries, the
    backward's under ``backward``."""
    from repro_torch.configs import get_config

    out = {}
    for arch, _ in TRAIN_FAMILIES:
        cfg = get_config(arch)
        if not attn_layers(cfg):
            continue
        shape, causal, window = family_attention_shape(cfg)
        out[arch] = attention_at(torch, gen, shape, window, f"(0) {arch}'s training:", floor_ms,
                                 causal=causal)
        check(out[arch]["route"] == "cuda-tc",
              f"phase 18 (0): {arch}'s attention not on the tensor-core route")
        out[arch]["backward"] = attention_bwd_at(torch, gen.initial_seed() + len(out), shape,
                                                 causal, window, f"(0) {arch}'s training:")
    return out


def train_flops(cfg, n_params, b, s):
    """Model FLOPs of one training step: 6 P B S, P the parameters a token
    meets in a product (all but the untied embedding table, a lookup, and
    the experts the router does not pick: ``cfg.active_param_count()``'s
    cut), plus attention, 3 x 2 (D_qk + D_v) FLOPs a visible (query, key)
    pair a head an attention layer (causal or not, windowed or not, as the
    model's; MLA's D_qk = nope + rope and D_v its value width, 12 D
    elsewhere).  Returns (6 P B S, attention, P)."""
    p = (n_params - (cfg.param_count() - cfg.active_param_count())
         - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model))
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    attn = 0
    if n_attn:
        if cfg.attention == "mla":
            dqk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
        else:
            dqk = dv = cfg.resolved_head_dim
        _, causal, window = family_attention_shape(cfg)
        attn = 6 * (dqk + dv) * b * cfg.n_heads * n_attn * attn_pairs(s, causal, window)
    return 6 * p * b * s, attn, p


def family_train_path(torch, seed, arch, n_layers=None, b=TRAIN_B, s=TRAIN_S,
                      rounds=FAMILY_ROUNDS, shape="card_train"):
    """(c) ``arch`` at full width in bf16 through the CLI's own functions
    (``launch.train.parse_args``, ``setup``, ``train_round``:
    ``remat="full"``, ``ce_chunk`` 512, the launcher's clients, channels and
    history, the step donating its state), at full depth or cut to
    ``n_layers`` (``setup``'s ``cfg``), B = ``b`` x ``s``: one warm-up
    round and ``rounds - 1`` timed ones, the main path whose launches are
    counted; then (not counted) one profiled round split by the model's
    profiler ranges.  Phase 19 reads the step at the card's ``shape``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import moe, rglru, ssm
    from repro_torch.models.attention import BACKWARD_RANGE, FORWARD_RANGE
    from repro_torch.utils import roofline as rl

    label = f"phase 18 (c) {arch}"
    args = train.parse_args(["--arch", arch, "--steps", str(rounds), "--batch", str(b),
                             "--seq", str(s), "--clients",
                             str(TRAIN_CLIENTS), "--channels", str(TRAIN_CHANNELS),
                             "--lr", str(TRAIN_LR), "--ce-chunk", str(TRAIN_CE_CHUNK),
                             "--seed", str(seed), "--device", "cuda"])
    full = get_config(arch)
    cut = dataclasses.replace(full, n_layers=n_layers) if n_layers else None
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    h0, free0 = allocator_bytes(torch), free_blocks(torch)
    m0 = h0[0]
    t0 = time.perf_counter()
    run = train.setup(args, cfg=cut)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    static = minus(allocator_bytes(torch), h0)
    cfg, state = run.cfg, run.state
    n_params = sum(v.numel() for v in state.params.values())
    specs, _ = run.model.param_specs()
    n_specs = sum(v.numel() for v in specs.values())
    check(n_params == n_specs and run.model.remat == "full"
          and state.params["unembed"].dtype == torch.bfloat16,
          f"{label}: {n_params} params, param_specs() says {n_specs}")
    static_gib = torch.cuda.memory_allocated() / 2 ** 30
    s_total = family_attention_shape(cfg, b, s)[0][3]
    depth = (f"all {cfg.n_layers} layers" if cfg.n_layers == full.n_layers else
             f"{cfg.n_layers} of its {full.n_layers} layers (cut: {full.param_count():,} params "
             f"at full depth)")
    line(f"  (c) {arch}: {depth}, width {cfg.d_model}, vocab {cfg.vocab_size}, "
         f"bf16, {n_params:,} params = the sum over param_specs() (param_count() "
         f"{cfg.param_count():,}; active a token {cfg.active_param_count():,}), "
         f"remat={run.model.remat}, ce_chunk={run.model.ce_chunk}; "
         f"{TRAIN_CLIENTS} clients over {TRAIN_CHANNELS} channels, B={b} x {s_total} "
         f"positions, AdamW lr {TRAIN_LR}; set up on the card in {setup_s:.2f} s, "
         f"{static_gib:.2f} GiB allocated (weights and moments)")
    unembed0 = state.params["unembed"][:, :64].clone()
    embed0 = state.params["embed"].clone() if cfg.arch_type == "audio" else None

    state, mets, step_ms, spread, launches, warm_peak = timed_rounds(
        torch, train, run, state, rounds, FAMILY_WARM)
    card = card_step(static, warm_peak - m0, per_step(launches, rounds, label), step_ms,
                     (free0,), env_sizes(run.env))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(m["loss"]) for m in mets]
    succ = [int(m["n_success"]) for m in mets]
    fa_per = 2 * attn_layers(cfg)
    check(launches["flash_attention_tc"] == rounds * fa_per
          and launches["flash_attention"] == rounds * fa_per
          and launches["flash_attention_bwd"] == rounds * fa_per // 2
          and launches[PLAIN_BACKWARD] == 0 and launches["glr_step"] == rounds,
          f"{label}: launches {launches}; expected flash_attention {fa_per} a step on "
          f"the tensor-core route, its backward kernels {fa_per // 2} a step and no chunked "
          f"recompute, and glr_step 1 a step")
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    check(not torch.equal(state.params["unembed"][:, :64], unembed0),
          f"{label}: the parameters did not move")
    never_read = ""
    if embed0 is not None:
        check(torch.equal(state.params["embed"], embed0),
              f"{label}: embed (never read: zero gradient) moved")
        never_read = "; embed (never read) unchanged bit for bit"
    del unembed0, embed0
    aux = ""
    if cfg.n_experts:
        auxes = [float(m["moe_aux"]) for m in mets]
        check(all(math.isfinite(x) for x in auxes), f"{label}: moe_aux {auxes}")
        aux = f", moe_aux {', '.join(f'{x:.4f}' for x in auxes)}"
    positions = b * s_total
    flops, attn, p_prod = train_flops(cfg, n_params, b, s_total)
    share = (flops + attn) / (step_ms * 1e-3) / rl.PEAK_FLOPS_BF16
    line(f"  (c) {arch}: {rounds} rounds: loss {', '.join(f'{x:.4f}' for x in losses)} "
         f"(finite){aux}, |S_t| {succ}, the parameters moved{never_read}; launches "
         f"flash_attention {launches['flash_attention']} ({fa_per} a step, tensor-core route), "
         f"flash_attention_bwd {launches['flash_attention_bwd']} ({fa_per // 2} a step; chunked "
         f"recompute {launches[PLAIN_BACKWARD]}), glr_step {launches['glr_step']}")
    line(f"  (c) {arch}: {step_ms:.1f} ms a step untraced (rounds {FAMILY_WARM}-"
         f"{rounds - 1} after {FAMILY_WARM} warm-up; between the steps' CUDA events "
         f"{', '.join(f'{x:.1f}' for x in spread)} ms), {positions / step_ms * 1e3:,.0f} "
         f"positions/s ({b * s / step_ms * 1e3:,.0f} tokens/s of the {s} a "
         f"sequence); model FLOPs a step 6 P B S = {flops:.4e} (P = {p_prod:,} active in "
         f"products of {n_params:,}) + {'non-causal ' if not cfg.is_decoder else ''}attention "
         f"{attn:.4e} = {flops + attn:.4e}, {(flops + attn) / (step_ms * 1e-3) / 1e12:.1f} "
         f"TFLOP/s = {100 * share:.1f} % of {rl.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s; peak device "
         f"memory {peak_gib:.2f} GiB (allocated; {static_gib:.2f} GiB of weights and moments)")

    holder = {"state": state}

    def one_round():
        holder["state"], _ = train.train_round(run, holder["state"])

    events, wall_us = trace_events(torch, one_round)
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    total = sum(float(e["dur"]) for e in kernels)
    parts = {"attention forward": range_device_us(events, FORWARD_RANGE)[0],
             "attention backward (kernels)": range_device_us(events, BACKWARD_RANGE)[0],
             "SSD chunk loop": range_device_us(events, ssm.SSD_RANGE)[0],
             "RG-LRU scan": range_device_us(events, rglru.SCAN_RANGE)[0],
             "MoE dispatch": range_device_us(events, moe.DISPATCH_RANGE)[0],
             "MoE expert products": range_device_us(events, moe.EXPERTS_RANGE)[0],
             "MoE combine": range_device_us(events, moe.COMBINE_RANGE)[0]}
    parts["the rest"] = total - sum(parts.values())
    split = ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f} %)"
                      for k, v in parts.items() if v or k == "the rest") \
        if total else "no device kernels in the trace (not measured)"
    mla = ("; MLA's attention backward is autograd's of the plain chunked path, in no range: "
           "in the rest" if cfg.attention == "mla" else "")
    line(f"  (c) {arch} step profile: wall {wall_us / 1e3:.1f} ms, {len(kernels)} kernels, device "
         f"time {total / 1e3:.2f} ms: {split} (the forward ranges hold their forward and "
         f"recompute, not their backward{mla})")
    report_kernels(f"(c) {arch} training step", kernels, wall_us, 1)
    del holder, events, kernels, state, run, mets
    release(torch)
    return launches, dict(step_ms=step_ms, positions_per_s=positions / step_ms * 1e3,
                          model_flops=flops + attn, flop_share=share, peak_gib=peak_gib,
                          static_gib=static_gib, split_us=parts, device_us=total,
                          card={shape: card})


def card_train_shape(b, s):
    """The card shape (``launch/specs.py``) of phase 18's training step at
    B = ``b`` x ``s``."""
    return "card_train" if (b, s) == (TRAIN_B, TRAIN_S) else f"card_train_s{s}"


def mla_moe_train_reference(torch, seed, arch, n_layers):
    """(a) for an MLA or MoE model: ``arch`` at full width, ``n_layers`` deep
    (one layer of each kind), f32, B=2 x ``TRAIN_REF_S``: ``loss`` and its
    gradients under ``remat="full"`` twice, bitwise (the MoE backward adds
    each token's rows in a fixed order, so a step repeats on the card), then
    against another run: dbrx's plain route (its kernel route launches the
    FMA kernel twice an attention layer; rtol/atol 2e-3, as phase 14 (a)),
    an MLA model's ``remat="none"`` (both routes are plain attention there:
    the check is the checkpoint's recompute of the attention and of the
    routing, bitwise).  Two gradient sets are held at once.  dbrx then
    runs ``bf16_grads_gate``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model

    label = f"phase 18 (a) {arch}"
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(seed + 147)
    model = build_model(cfg, remat="full")
    params, _ = model.init(gen, device="cuda")
    batch = model_batch(torch, cfg, 2, TRAIN_REF_S, gen)
    w = torch.tensor([1.0, 0.5], device="cuda")
    n_attn = 2 * attn_layers(cfg)
    before = (kernel.fma_launches, kernel.tc_launches)
    l1, m1, g1 = loss_and_grads(model, params, batch, w)
    torch.cuda.synchronize()
    launched = (kernel.fma_launches - before[0], kernel.tc_launches - before[1])
    check(launched == (n_attn, 0),
          f"{label}: launched {launched} (FMA, tensor-core), expected {n_attn} FMA")
    check(bool(torch.isfinite(l1)) and all(bool(torch.isfinite(g).all()) for g in g1.values()),
          f"{label}: loss {float(l1)} or a gradient not finite")
    l2, m2, g2 = loss_and_grads(model, params, batch, w)
    repeat = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    check(torch.equal(l1, l2) and torch.equal(m1["moe_aux"], m2["moe_aux"]) and not repeat,
          f"{label}: a second identical loss and gradients differ: loss {float(l1)} / "
          f"{float(l2)}, gradients {repeat}")
    del g2
    kinds = ", ".join(sorted({cfg.layer_kind(i) + ("+moe" if cfg.n_experts and
                                                   i >= cfg.first_k_dense else "")
                              for i in range(n_layers)}))
    head = (f"  (a) {cfg.name} width {cfg.d_model}, vocab {cfg.vocab_size}, {n_layers} layers "
            f"({kinds}; {cfg.attention}), f32, B=2 S={TRAIN_REF_S}: loss {float(l1):.6f}, moe_aux "
            f"{float(m1['moe_aux']):.6f}; loss and all {len(g1)} gradients twice, bit for bit")
    if n_attn:
        lp, _, gp = loss_and_grads(build_model(cfg, remat="full", attn_impl="plain"), params,
                                   batch, w)
        check(kernel.fma_launches - before[0] == 2 * n_attn,
              f"{label}: the plain route ran the kernel")
        check(torch.allclose(l1, lp, rtol=2e-3, atol=2e-3),
              f"{label}: loss {float(l1)} against the plain route's {float(lp)}")
        g_err, g_max, g_rel = grads_close(torch, g1, gp, f"{label} kernel vs plain route")
        line(f"{head}; kernel route (FMA, {launched[0]} launches a pass: forward and recompute) "
             f"vs plain route: loss {float(lp):.6f}, gradients max_abs_err {g_err:.3e} (max "
             f"|grad| {g_max:.3e}; worst tensor's max_abs_err / its max |grad| {g_rel:.3e}; rtol "
             f"2e-3, atol min(2e-3, 1e-4 max |grad|)) ok")
        g1.clear()
        bf16_grads_gate(torch, cfg, params, batch, w, gp, label)
    else:
        ln, mn, gn = loss_and_grads(build_model(cfg, remat="none"), params, batch, w)
        apart = [k for k in g1 if not torch.equal(g1[k], gn[k])]
        check(torch.equal(l1, ln) and torch.equal(m1["moe_aux"], mn["moe_aux"]) and not apart,
              f"{label}: remat='full' against remat='none': loss {float(l1)} / {float(ln)}, "
              f"gradients apart {apart}")
        gp = gn
        line(f"{head}; remat='full' (the blocks recomputed in the backward pass: attention, "
             f"router, dispatch) = remat='none' bit for bit (MLA: both routes are the plain "
             f"chunked attention) ok")
    del params, g1, gp
    release(torch)


def mla_moe_training(torch, seed, floor_ms):
    """Phase 18's second part: training the MLA and MoE models
    (``MLA_MOE_TRAINED``), one at a time: (0) ``flash_attention`` at dbrx's
    training shape; (a) ``mla_moe_train_reference``; (b) the smoke configs'
    rounds on the card against the CPU (``train_card_vs_cpu``); (c) the cut
    run through the launcher (``family_train_path``).  Returns the main
    path's launches ((c), each model counted from zero), dbrx's attention
    entry and each model's numbers."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    dbrx = get_config("dbrx-132b")
    shape, causal, window = family_attention_shape(dbrx)
    attn = attention_at(torch, torch.Generator(device="cuda").manual_seed(seed + 181), shape,
                        window, "(0) dbrx-132b's training:", floor_ms, causal=causal)
    check(attn["route"] == "cuda-tc", "phase 18 (0): dbrx's attention not on the tensor-core route")
    attn["backward"] = attention_bwd_at(torch, seed + 182, shape, causal, window,
                                        "(0) dbrx-132b's training:")
    for arch, _, _, _, ref_layers in MLA_MOE_TRAINED:
        mla_moe_train_reference(torch, seed, arch, ref_layers)
    for arch, *_ in MLA_MOE_TRAINED:
        train_card_vs_cpu(torch, seed, arch, f"phase 18 (b) {arch}", carried_adam=False)
    paths, numbers = {}, {}
    for arch, n_layers, b, s, _ in MLA_MOE_TRAINED:
        paths[arch], numbers[arch] = family_train_path(torch, seed, arch, n_layers, b, s,
                                                       MLA_MOE_ROUNDS, card_train_shape(b, s))
    launches = {k: sum(p[k] for p in paths.values()) for k in COUNTERS}
    attn["launches"] = paths["dbrx-132b"]["flash_attention"]
    attn["backward"]["launches"] = paths["dbrx-132b"]["flash_attention_bwd"]
    line(f"  phase 18 MLA and MoE launches: flash_attention {launches['flash_attention']} "
         f"(tensor-core {launches['flash_attention_tc']}), flash_attention_bwd "
         f"{launches['flash_attention_bwd']}, glr_step {launches['glr_step']}; wall "
         f"{time.perf_counter() - t_phase:.1f} s")
    return launches, attn, numbers


def family_training(torch, seed, floor_ms):
    """Phase 18: training for the SSM, RG-LRU hybrid, VLM and audio
    families, one model at a time.  Returns the main path's launches ((c),
    each model counted from zero), ``flash_attention``'s entries at the
    three training shapes and each model's numbers."""
    t_phase = time.perf_counter()
    attn = family_attention(torch, torch.Generator(device="cuda").manual_seed(seed + 180),
                            floor_ms)
    for arch, n_layers in TRAIN_FAMILIES:
        train_reference(torch, seed, arch, n_layers, f"phase 18 (a) {arch}")
    for arch, _ in TRAIN_FAMILIES:
        train_card_vs_cpu(torch, seed, arch, f"phase 18 (b) {arch}")
    paths, numbers = {}, {}
    for arch, _ in TRAIN_FAMILIES:
        paths[arch], numbers[arch] = family_train_path(torch, seed, arch)
    launches = {k: sum(p[k] for p in paths.values()) for k in COUNTERS}
    for arch, fa in attn.items():
        fa["launches"] = paths[arch]["flash_attention"]
        fa["backward"]["launches"] = paths[arch]["flash_attention_bwd"]
    line(f"  phase 18 launches: flash_attention {launches['flash_attention']} (tensor-core "
         f"{launches['flash_attention_tc']}), flash_attention_bwd "
         f"{launches['flash_attention_bwd']}, glr_step {launches['glr_step']}; wall "
         f"{time.perf_counter() - t_phase:.1f} s")
    return launches, attn, numbers


# ---------------------------------------------------------------------------
# phase 19: the dry run against the card
# ---------------------------------------------------------------------------

PEAK_BAND = 0.10               # (b): the predicted peak within 10 % of the card's
DRYRUN_WORKERS = 6             # host processes running the dry runs at once


def dryrun_job(job):
    """One dry run on the host (meta tensors: no card, nothing allocated), in
    a worker process: ``job`` = (arch, layers or None for the full depth,
    shape, ce_chunk).  Returns (job, the record's numbers)."""
    import dataclasses

    import torch

    torch.set_num_threads(1)          # meta ops compute nothing: one thread a worker
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_one

    arch, n_layers, shape, ce_chunk = job
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    rec = run_one(cfg, shape, ce_chunk=ce_chunk, verbose=False)
    return job, {k: rec.get(k) for k in ("status", "error", "memory", "kernel_launches",
                                          "roofline", "cost_logical", "trace_s")}


def dry_runs(jobs):
    """The dry runs of ``jobs`` in ``DRYRUN_WORKERS`` spawned processes (the
    longest first); every worker has exited when this returns."""
    import concurrent.futures
    import multiprocessing

    order = sorted(jobs, key=lambda j: (j[2] != "card_train", j[0] != "mamba2-1.3b"))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=ctx) as pool:
        return dict(pool.map(dryrun_job, order))


def dry_run_vs_card(torch, measured):
    """Phase 19: for each config and shape phases 7, 14, 16, 17 and 18 ran,
    the dry run's prediction (``repro_torch.launch.dryrun``, on meta
    tensors on the host) against the card's measurement: (a) the step's
    static bytes exactly, as the allocator's requests count them (the
    dry run's storages and the launcher's env a training step holds) and
    as ``memory_allocated`` counts them (``utils/cost.py``
    ``allocated_bytes`` over the dry run's storage sizes, from the free
    blocks the card's allocator held when each run of allocations began:
    the cached blocks that live tensors of earlier work keep), (b) its
    peak within ``PEAK_BAND``, (c) each kernel's launches a step exactly;
    (d) printed: the counted FLOPs, the roofline bound, the measured ms and
    the step's share of its roofline, the model-FLOP share.  Runs no step
    on the card."""
    from repro_torch.launch.specs import CARD_SHAPES
    from repro_torch.utils import roofline as rl
    from repro_torch.utils.cost import allocated_bytes

    t_phase = time.perf_counter()
    fl = (TRAIN_CLIENTS, TRAIN_CHANNELS, TRAIN_HISTORY)
    smoke = {"card_train": (TRAIN_S, TRAIN_B, fl),
             "card_prefill": (SERVE_PROMPT, SERVE_PREFILL_BATCH),
             "card_decode": (SERVE_CONTEXT, SERVE_BATCH)}
    smoke.update({card_train_shape(b, s): (s, b, fl) for _, _, b, s, _ in MLA_MOE_TRAINED})
    spec = {k: (v.seq_len, v.global_batch, v.fl[:3])[:len(smoke.get(k, ()))]
            for k, v in CARD_SHAPES.items()}
    check(spec == smoke, f"phase 19: the card shapes {spec} are not the smoke's steps {smoke}")
    ce_of = lambda shape: TRAIN_CE_CHUNK if CARD_SHAPES[shape].mode == "train" else 0
    jobs = [(arch, n, shape, ce_of(shape)) for (arch, n), steps in measured.items()
            for shape in steps]
    recs = dry_runs(jobs)
    bad = {j: r["error"] for j, r in recs.items() if r["status"] != "ok"}
    check(not bad, f"phase 19: dry runs failed: {bad}")
    gib = lambda b: b / 2 ** 30
    out = {}
    for (arch, n), steps in measured.items():
        for shape, card in steps.items():
            rec = recs[(arch, n, shape, ce_of(shape))]
            mem, roof = rec["memory"], rec["roofline"]
            what = f"{arch}{f' ({n} layers)' if n else ''} {shape}"
            held, sizes, free = card["held"], mem["static_sizes"], card["free"]
            if shape == "card_decode":      # the weights, then the serve loop's cache and token
                model = (allocated_bytes(sizes[0], free[0])
                         + allocated_bytes(sum(sizes[1:], []), free[1]))
            else:                           # (training: the env, then the state)
                model = allocated_bytes(held + sum(sizes, []), free[0])
            diff = card["static_requested"] - mem["static_bytes_exact"] - sum(held)
            line(f"  (a) {what}: static {mem['static_bytes_exact']:,} bytes predicted "
                 f"({mem['static_storages']} storages) + {sum(held):,} of env held beside it, "
                 f"{card['static_requested']:,} requested on the card (difference {diff:,}); "
                 f"memory_allocated {card['static_bytes']:,} ({gib(card['static_bytes']):.4f} "
                 f"GiB) against the allocator model's {model:,} "
                 f"({card['static_bytes'] - model:+,}) from "
                 f"{' and '.join(f'{sum(n for n, _ in f):,} bytes in {len(f)}' for f in free)} "
                 f"free cached blocks; from an empty cache "
                 f"{mem['static_allocated']:,}, 512-byte rounding {mem['static_bytes']:,}")
            check(diff == 0, f"phase 19 (a) {what}: {card['static_requested']:,} bytes requested "
                  f"on the card, {mem['static_bytes_exact']:,} predicted + {sum(held):,} of env")
            check(card["static_bytes"] == model, f"phase 19 (a) {what}: memory_allocated "
                  f"{card['static_bytes']:,} on the card, the allocator model {model:,}")
            ratio = mem["peak_bytes"] / card["peak_bytes"]
            line(f"  (b) {what}: peak {gib(mem['peak_bytes']):.3f} GiB predicted, "
                 f"{gib(card['peak_bytes']):.3f} GiB on the card (max_memory_allocated over the "
                 f"step), ratio {ratio:.4f}")
            check(abs(ratio - 1) <= PEAK_BAND, f"phase 19 (b) {what}: predicted peak "
                  f"{gib(mem['peak_bytes']):.3f} GiB against {gib(card['peak_bytes']):.3f} GiB")
            want = {k: rec["kernel_launches"].get(k, 0) for k in KERNEL_NAMES}
            got = {k: card["launches"][k] for k in KERNEL_NAMES}
            line(f"  (c) {what}: launches a step predicted "
                 f"{ {k: v for k, v in want.items() if v} }, on the card "
                 f"{ {k: v for k, v in got.items() if v} }")
            check(want == got, f"phase 19 (c) {what}: launches {got} on the card, {want} predicted")
            bound_ms = roof["step_time_lower_bound_s"] * 1e3
            mshare = roof["model_flops"] / (card["ms"] * 1e-3) / rl.PEAK_FLOPS_BF16
            line(f"  (d) {what}: {rec['cost_logical']['flops']:.4e} FLOPs counted, roofline "
                 f"bound {bound_ms:.3f} ms ({roof['bottleneck']}), {card['ms']:.2f} ms measured: "
                 f"the step's share of its roofline {100 * bound_ms / card['ms']:.1f} %; "
                 f"model FLOPs {roof['model_flops']:.4e}, {100 * mshare:.2f} % of "
                 f"{rl.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s (dry run {rec['trace_s']:.1f} s)")
            out[what] = dict(predicted=dict(static=mem["static_bytes_exact"],
                                            static_allocated=model,
                                            peak=mem["peak_bytes"],
                                            launches=rec["kernel_launches"],
                                            flops=rec["cost_logical"]["flops"],
                                            bound_ms=bound_ms),
                             card=card)
    line(f"  phase 19: {len(recs)} dry runs; wall {time.perf_counter() - t_phase:.1f} s")
    return out


def kernel_line(launches, glr_err, glr_t, wa_err, wa_t, rt_err, rt_t, gs_err, gs_t, fa_err,
                fa_t, fig2_scan, recompute_scan, gst_err, gst_t, batch_scan, reactive_scan,
                agg_batch, sub_kernels, train_kernels, gsct_err, gsct_t, dbrx_attn, hybrid_attn,
                family_attn, dbrx_train_attn):
    """The entries of the kernels line: launches from the paths, the rest
    from phase 2; ``glr_step`` and ``glr_scan`` also carry their scan route
    (``regret_scan``, one launch a Fig. 2 run) from phases 3 and 6, and
    ``glr_step`` the scan's batch form (phase 10's launches, phase 2's error
    against the batched per-round loop, the fill of the card) and its
    reactive template (the paths' launches of it, phase 11 (d)'s Fig. 2 run
    on a reactive env; bit for bit against the rounds route).  The two
    Step-4 kernels carry their batch form (``batch``: the paths' batch
    launches, phase 2's error, row-by-row check and times at (8, 20, 5674)
    and the large shape).  ``glr_step`` and the Step-4 kernels carry the
    sparse round's shapes (``substrate``: phase 13's launches, its check
    against the plain version and its times there); ``glr_step`` and
    ``flash_attention`` the training path's (``train``: phase 14's launches,
    the check and the times at its shapes); ``flash_attention`` also dbrx's
    prefill shape (``dbrx``: phase 16's launches, (0)'s check and times),
    recurrentgemma's local attention (``recurrentgemma``) and phi-3-vision's
    prefill (``phi3v``), both on the tensor-core route, each with phase
    17's launches and (a)'s check and times; recurrentgemma's and the model
    shape's also carry ``fma_ms`` and ``ms_again`` (``routes_in_turns``);
    and the four training shapes of phase 18 (``train_hubert``, non-causal,
    ``train_recurrentgemma``, ``train_phi3v``, ``train_dbrx``), each with
    phase 18's launches and (0)'s check and times.  ``flash_attention_bwd``
    (the backward kernels) carries phase 14 (0)'s check and times at
    qwen1.5-0.5b's training shape with phase 14's and 18's launches, and
    the four other training shapes' under the same keys, each with its
    phase's launches."""
    def entry(name, replaces, err, t, source=None, **extra):
        source = source or f"src/repro_torch/kernels/csrc/{name}.cu"
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches[name], max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t.get("library_ms"), **extra)

    at = lambda t, shape: dict(shape_r_b_n_h=shape, **{k: t[k] for k in (
        "ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "splits", "detecting_rows")
        + (("old_ms",) if "old_ms" in t else ())})
    serve = gst_t["serve"]
    bwd = train_kernels["flash_attention_bwd"]
    without = lambda d, key: {k: v for k, v in d.items() if k != key}
    return [
        entry("glr_step", "src/repro/kernels/glr_step.py:163", glr_err, glr_t["fig2"],
              batch_scan=batch_scan, substrate=sub_kernels["glr_step"],
              train=train_kernels["glr_step"],
              reactive_scan=dict(reactive_scan, launches=launches["regret_scan_reactive"]),
              **fig2_scan),
        entry("glr_step_tenants", "src/repro/kernels/glr_step.py:210", gst_err, serve,
              shape_r_b_n_h=[257, 64, 16, 256], device_ms=serve["device_ms"],
              detecting_rows=serve["detecting_rows"], splits=serve["splits"],
              host_split_us=serve["host_split_us"],
              full=at(gst_t["full"], [256, 256, 16, 1024]),
              big=at(gst_t["big"], [10001, 64, 16, 64])),
        entry("weighted_aggregate", "src/repro/kernels/weighted_aggregate.py:47", wa_err,
              wa_t["fig3"], shape=[20, 5674], turns_ms=wa_t["fig3"]["turns_ms"],
              library_turns_ms=wa_t["fig3"]["library_turns_ms"],
              device_ms=wa_t["fig3"]["device_ms"],
              library_device_ms=wa_t["fig3"]["library_device_ms"],
              host_split_us=wa_t["fig3"]["host_split_us"],
              large=dict(shape=[64, 2 ** 24], **wa_t["large"]),
              large_ragged=dict(shape=[64, 2 ** 24 + 2], **wa_t["large_ragged"]),
              batch=dict(agg_batch["weighted_aggregate"],
                         launches=launches["weighted_aggregate_batch"]),
              substrate=sub_kernels["weighted_aggregate"]),
        entry("robust_trimmed", "src/repro/kernels/robust_agg.py:73", rt_err, rt_t["fig3"],
              shape=[20, 5674], turns_ms=rt_t["fig3"]["turns_ms"],
              library_turns_ms=rt_t["fig3"]["library_turns_ms"],
              device_ms=rt_t["fig3"]["device_ms"],
              library_device_ms=rt_t["fig3"]["library_device_ms"],
              host_split_us=rt_t["fig3"]["host_split_us"],
              large=dict(shape=[64, 2 ** 22 + 3], **rt_t["large"]),
              batch=dict(agg_batch["robust_trimmed"], launches=launches["robust_trimmed_batch"]),
              substrate=sub_kernels["robust_trimmed"]),
        entry("glr_scan", "src/repro/kernels/glr_scan.py:70", gs_err, gs_t["fig2"],
              **recompute_scan),
        entry("glr_scan_tenants", "src/repro/kernels/glr_scan.py:70", gsct_err, gsct_t["serve"],
              source="src/repro_torch/kernels/csrc/glr_scan.cu", shape_r_b_n_h=[257, 64, 16, 256],
              device_ms=gsct_t["serve"]["device_ms"],
              detecting_rows=gsct_t["serve"]["detecting_rows"],
              splits=gsct_t["serve"]["splits"], host_split_us=gsct_t["serve"]["host_split_us"],
              all=at(gsct_t["all"], [257, 64, 16, 256]),
              big=at(gsct_t["big"], [10001, 64, 16, 64])),
        entry("flash_attention", "src/repro/kernels/flash_attention.py:123", fa_err,
              fa_t["model"], source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
              shape_b_hq_hkv_s_d=[4, 64, 8, SERVE_PROMPT, 128], causal=True,
              dtype="bfloat16", tc_launches=launches["flash_attention_tc"],
              fma_launches=launches["flash_attention_fma"],
              fma_source="src/repro_torch/kernels/csrc/flash_attention.cu",
              fma_ms=fa_t["model"]["fma_ms"], ms_again=fa_t["model"]["ms_again"],
              f32_ms=fa_t["model_f32"]["ms"],
              f32_plain_ms=fa_t["model_f32"]["plain_ms"],
              f32_library_ms=fa_t["model_f32"]["library_ms"],
              f32_bound_ms=fa_t["model_f32"]["bound_ms"], jax_test_shapes=fa_t["jax_shapes"],
              train=train_kernels["flash_attention"], dbrx=dbrx_attn, **hybrid_attn,
              train_hubert=without(family_attn["hubert-xlarge"], "backward"),
              train_recurrentgemma=without(family_attn["recurrentgemma-2b"], "backward"),
              train_phi3v=without(family_attn["phi-3-vision-4.2b"], "backward"),
              train_dbrx=without(dbrx_train_attn, "backward")),
        entry("flash_attention_bwd", "src/repro/models/attention.py:147",
              bwd["max_abs_err"], bwd, replaces_note="no Pallas kernel: the counterpart of the "
              "JAX custom_vjp backward _bwd (:147-149), a recompute through XLA",
              redesigned="for Hopper: wgmma products on TMA-fed tiles, a producer warpgroup "
              "and two consumer warpgroups (was mma.sync m16n8k16 and cp.async)",
              **{k: bwd[k] for k in ("shape_b_hq_hkv_s_d", "causal", "window", "dtype",
                                     "excess", "excess_vs_chunked_route", "lse_max_abs_err",
                                     "chunked_route_ms", "bound_share")},
              train_hubert=family_attn["hubert-xlarge"]["backward"],
              train_recurrentgemma=family_attn["recurrentgemma-2b"]["backward"],
              train_phi3v=family_attn["phi-3-vision-4.2b"]["backward"],
              train_dbrx=dbrx_train_attn["backward"]),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", action="store_true",
                    help="build the kernels and run the paths (phases 3-18) only")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch package beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # full-f32 products on the card, so the CPU references compare like with like
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    try:
        line("[1] card")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        line(f"  python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        reports = _build.build(_build.KERNELS + _build.PROBES)
        line(f"  built {sorted(reports) or 'nothing (current builds present)'} "
             f"in {time.perf_counter() - t0:.1f} s")
        for name, rep in sorted(reports.items()):
            for ln in rep.strip().splitlines():
                if any(w in ln for w in ("registers", "spill", "arning", "C75",
                                         "Performance Loss")):
                    line(f"    {name}: {ln.strip()}")

        if not args.paths:
            line("[2] kernels against their plain versions on the card")
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            floor_ms, _ = launch_floor(torch)
            glr_err, glr_t = check_glr_step(torch, gen, floor_ms)
            # its own generator: the checks after it keep the draws they had before it
            gst_gen = torch.Generator(device="cuda").manual_seed(args.seed + 17)
            gst_err, gst_t = check_glr_step_tenants(torch, gst_gen, floor_ms)
            wa_err, wa_t = check_weighted_aggregate(torch, gen, floor_ms)
            rt_err, rt_t = check_robust_trimmed(torch, gen, floor_ms)
            # its own generator, as glr_step_tenants': the later checks keep their draws
            agg_batch = check_batched_aggregation(
                torch, torch.Generator(device="cuda").manual_seed(args.seed + 21), floor_ms)
            gs_err, gs_t = check_glr_scan(torch, gen, floor_ms)
            # its own generator, as glr_step_tenants': the later checks keep their draws
            gsct_err, gsct_t = check_glr_scan_tenants(
                torch, torch.Generator(device="cuda").manual_seed(args.seed + 24), floor_ms)
            check_regret_scan(torch, args.seed)
            batch_err = check_regret_scan_batch(torch, args.seed)
            fa_err, fa_t = check_flash_attention(torch, gen, floor_ms)
            # the checks' gigabytes go back to the driver before the timed paths
            peak = torch.cuda.max_memory_reserved() / 2 ** 30
            release(torch)
            line(f"  released the checks' memory: {peak:.2f} GiB reserved at peak, "
                 f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB now")

        line("[3] Fig. 2 AoI-regret path")
        fig2_launches, f2 = fig2(torch, args.seed)
        line("[4] Fig. 3 asynchronous-FL path")
        S = fig3_setup(torch, args.seed)
        fig3_launches, clean_acc, fig3_run = fig3(torch, S)
        line("[5] Fig. 3 path under Byzantine faults, robust aggregation")
        robust_launches = fig3_robust(torch, S, args.seed, clean_acc)
        line("[6] Fig. 2 path, recompute detector")
        recompute_launches, recompute_scan = fig2_recompute(torch, f2)
        fig2_scan, chain_us = f2["scan"], f2["chain_us"]
        fig2_env, fig2_u = f2["env"], f2["uniforms"]       # phase 11 (d)'s base and randomness
        del f2, S
        release(torch)
        line("[7] serving path: qwen3-32b prefill and greedy decode")
        serve_reference(torch, args.seed)
        serve_launches, serve_numbers = serve_path(torch, args.seed, SERVE_LAYERS)
        line("[8] the multi-tenant scheduler service")
        sched_launches, _ = sched_serve(torch, args.seed)
        line("[9] the paper's baseline rows: Fig. 2a and Fig. 3/4")
        baseline_launches, fig2a_refs, fig34_runs = baselines(torch, args.seed)
        line("[10] the batched engine: fig2c, hp_grid, the card's fill, fig2a as one sweep")
        batch_launches, batch_fields = batched_engine(torch, args.seed, chain_us, fig2a_refs)
        del fig2a_refs
        line("[11] the non-stationary channel families and the closed loop: the scenario and "
             "chaos suites, Fig. 2 and Fig. 3 on reactive envs")
        family_launches, reactive_fields = channel_families(torch, args.seed, fig2_env, fig2_u,
                                                            chain_us)
        line("[12] the batched FL engine: Fig. 3/4 at 8 seeds, fl_batch, the chaos FL half")
        fl_launches, _ = batched_fl(torch, args.seed,
                                    dict(fig34_runs, **{"piecewise/glr-cucb+aware": fig3_run}))
        del fig34_runs, fig3_run
        release(torch)
        line("[13] the sparse client axis: fl_substrate at N = 100,000, dense-vs-sparse parity, "
             "the availability families, run_served")
        if args.paths:
            floor_ms = launch_floor(torch)[0]
        sub_launches, sub_kernels, _ = sparse_substrate(torch, args.seed, floor_ms)
        release(torch)
        line("[14] the FL training path: qwen1.5-0.5b at full width and depth")
        train_launches, train_kernels, train_numbers = training(torch, args.seed, floor_ms)
        release(torch)
        line("[15] the scheduler service for every served policy: M-Exp3, random, round-robin, "
             "channel-aware, Lyapunov, the recompute detector")
        served_launches, _ = served_baselines(torch, args.seed, sched_launches)
        release(torch)
        line("[16] MLA and MoE serving: minicpm3-4b (62 layers), deepseek-v2-236b and "
             "dbrx-132b (8 layers) at full width")
        mla_moe_launches, dbrx_attn, mla_moe_numbers = mla_moe_serving(torch, args.seed, floor_ms)
        release(torch)
        line("[17] SSM, RG-LRU hybrid and VLM serving: mamba2-1.3b, recurrentgemma-2b and "
             "phi-3-vision-4.2b at full width and depth")
        hybrid_launches, hybrid_attn, hybrid_numbers = hybrid_serving(torch, args.seed, floor_ms)
        release(torch)
        line("[18] training the SSM, RG-LRU hybrid, VLM and audio families: hubert-xlarge, "
             "mamba2-1.3b, recurrentgemma-2b and phi-3-vision-4.2b at full width and depth")
        family_train_launches, family_attn, family_numbers = family_training(torch, args.seed,
                                                                             floor_ms)
        release(torch)
        line("[18] training the MLA and MoE models at full width: minicpm3-4b (62 layers, B = 8 "
             "x 2048), deepseek-v2-236b (2 layers, B = 4 x 1024), dbrx-132b (1 layer, B = 8 x "
             "2048)")
        mla_moe_train_launches, dbrx_train_attn, mla_moe_train_numbers = mla_moe_training(
            torch, args.seed, floor_ms)
        release(torch)
        if not args.paths:
            line("[19] the dry run against the card: static bytes, peaks, launches and roofline "
                 "shares of phases 7, 14, 16, 17 and 18's steps")
            measured = {}
            for key, numbers in ([((SERVE_ARCH, None), serve_numbers),
                                  ((TRAIN_ARCH, None), train_numbers)]
                                 + [((a, n), mla_moe_numbers[a]) for a, n in MLA_MOE_SERVED]
                                 + [((a, None), hybrid_numbers[a]) for a, _ in HYBRID_REF_LAYERS]
                                 + [((a, None), family_numbers[a]) for a, _ in TRAIN_FAMILIES]
                                 + [((a, n), mla_moe_train_numbers[a])
                                    for a, n, *_ in MLA_MOE_TRAINED]):
                measured.setdefault(key, {}).update(numbers["card"])
            dry_run_vs_card(torch, measured)
        paths = (fig2_launches, fig3_launches, robust_launches, recompute_launches,
                 serve_launches, sched_launches, baseline_launches, batch_launches,
                 family_launches, fl_launches, sub_launches, train_launches, served_launches,
                 mla_moe_launches, hybrid_launches, family_train_launches, mla_moe_train_launches)
        launches = {k: sum(p[k] for p in paths) for k in COUNTERS}
        check(all(launches[k] > 0 for k in KERNEL_NAMES + BATCH_ROUTES
                  + ("flash_attention_tc", "regret_scan_reactive")),
              f"a kernel never launched: {launches}")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1

    line(f"  launches on the main paths: {launches}")
    line(f"  total seconds {time.perf_counter() - t_start:.1f}")
    line(smi)
    if not args.paths:
        line(json.dumps({"kernels": kernel_line(launches, glr_err, glr_t, wa_err, wa_t, rt_err,
                                                rt_t, gs_err, gs_t, fa_err, fa_t, fig2_scan,
                                                recompute_scan, gst_err, gst_t,
                                                dict(batch_fields, max_abs_err=batch_err),
                                                reactive_fields, agg_batch, sub_kernels,
                                                train_kernels, gsct_err, gsct_t, dbrx_attn,
                                                hybrid_attn, family_attn, dbrx_train_attn)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
