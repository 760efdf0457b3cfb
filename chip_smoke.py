#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each of which raises on failure
(the script then exits non-zero and prints no result):

1. the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print the compiler's register/spill report;
2. K1 (``dense_fwd``) in bf16 against its plain version ``dense_ref`` on
   the card at every Yi-6B and Gemma-2 projection shape at M = 1, 4 and
   16 (the split-K decode stream), 17, 24 and 64 (the prefill tile GEMM's
   64-row weight stream) and, at Gemma-2's shapes, 512 and 5000 (its
   128-row tiles), with the slices S printed per shape, plus ragged cases
   with bias and relu; every shape reruns bit for bit; kernel, plain and
   ``torch.matmul`` times by CUDA events and (kernel, ``torch.matmul``)
   on the device's clock (``device_ms``: the same loop under
   ``torch.profiler``), beside the least time the card could take; the
   sums of a Yi-6B (224 launches) and a Gemma-2 8-layer (56 launches)
   decode step at M = 4 and prefill forward (Yi-6B at M = 24, Gemma-2 at
   M = 5000); the same at Qwen3-MoE's attention projections (M = 1, 4,
   16 and 2048; its 8-layer decode step and 2048-token prefill, 32
   launches each), at Mamba2's in- and out-projections (M up to 64 and
   2000; its 48-layer decode step and 2000-token prefill, 96 launches
   each), at Hymba's nine (in_proj 1600 -> 6457; M up to 64 and 2048;
   its 32-layer decode step and 2048-token prefill, 288 launches each),
   at InternVL2's seven (6144 -> 6144 / 1024 / 16384, 16384 -> 6144; M
   up to 64 and 3072, the 4 image prompts; 8 layers, 56 launches), at
   StableLM's (5120 -> 5120 / 1280 / 13824, 13824 -> 5120; up to 64 and
   2048) and at Seamless's three widths (1024 -> 1024 / 8192, 8192 ->
   1024; up to 64, 256 and 16384: the decoder prefix and the encoder's 4
   x 4096 frames), those five timed at the summed rows only
   (TIMED_ROWS);
2b. K2-K8 (and K1 in f32) against their plain versions at every shape of
   a Table-2 case7 training step at B = 64, plus ragged and tied cases,
   for the split-K f32 product of K1 and K2 shapes whose reduction
   crosses slice boundaries off the 16-deep step or takes the
   element-by-element loads, for K3 a long reduction that splits, and
   for K4/K5 shapes past one block's shared memory or 16 output channels;
   per kernel, its time, the plain version's, the library call's and the
   bound, per shape and summed over one step's launches (kernel and
   library also on the device's clock), per K1/K2/K3 shape the slices S
   it splits into (K4/K5: its tiles of output pixels), and per K6 shape
   each of its two passes' device time; K1 f32 and K2-K6 rerun bit for
   bit; first, one launch's device floor (a one-float ``zero_()``), to
   read the small layers' rows against;
2c. K9 (RMSNorm) at decode and prefill rows of d = 4608, 4096, 3072 in
   bf16 and f32 plus ragged rows (each rerun bit for bit; the launch
   geometry printed; Qwen3-MoE's rows: d = 2048 and its q/k norms at
   head_dim 128, decode and a 2048-token prefill; Mamba2's d = 1024,
   Hymba's 1600, InternVL2's 6144 and StableLM's 5120, decode and their
   long prefills; Seamless's 1024 at its encoder's 16384 rows and its
   prefix's 256), and K10 (flash
   attention) at Gemma-2's
   (bf16 and f32, q x 8 so the soft-cap of 50 acts), Yi-6B's and Phi-3's
   attention shapes (S up to 8192, windows) plus a small case with fully
   masked rows, each against its plain version (K10 in bf16 within one
   bf16 ulp of it plus 1e-3 of its rms, in f32 within atol 1e-4 and rtol
   1e-3; both bit for bit on a rerun; the f32 rows also print the bound
   of their three TF32 products at the TF32 rate), with
   kernel, plain, library (``F.rms_norm``; for K10 ``flex_attention``
   with a soft-cap ``score_mod`` where a soft-cap is on, in f32 at the
   long prompt's S only, else ``F.scaled_dot_product_attention``) and
   bound times, kernel and library also on the device's clock;
2d. the LM's training kernels: K1, K2 and K3 in bf16 at every Phi-3-mini
   and Yi-6B projection shape at M = 1024 (B 8 x S 128; K1 without bias,
   as the LM calls it, at K1 bf16's gate; K2 and K3 each on the TMA +
   wgmma route), and at Granite-MoE's (1536 -> 1536 and -> 512; summed
   over a phase-4h step too) and Hymba's (its nine projections, summed
   over a phase-4k step; K2 and K3 of in_proj on the mma.sync tile
   route, since 6457 is no multiple of 8, each shape asserted on the
   route its widths call for), InternVL2's at M = 3072 (phase 4m's B 8 x
   (256 + 128)) and Seamless's at 4096 and 1024 (4n's encoder and
   decoder rows; each summed over its step, ``mm_train_launches``), K2
   and K3 also at ragged M, with the relu
   mask, off 8
   and at widths off every tile width the route plan can choose (each
   printing its route), and K9's backward at d = 3072, 4096, 4608 (1024
   rows, and ragged rows) in bf16 and f32, and at Granite-MoE's d = 1536,
   Hymba's 1600, Qwen3-MoE's q/k norms (d = 128), InternVL2's 6144 (3072
   rows) and Seamless's 1024 (4096 and 1024 rows), against their plain
   versions:
   dx within one bf16 rounding (bf16) or at the f32 gradient gate, f32
   dw, db and dscale at the gradient gate (1e-4 x max(max|ref|, 1)), K3's
   bf16 dw equal bit for bit to its f32 dw cast to bf16; every case
   reruns bit for bit; kernel, plain, library (``torch.matmul`` on the
   same bf16 operands; autograd of ``F.rms_norm``, its backward alone)
   and bound times, kernel and library also on the device's clock,
   summed over one phase-4e step (K3 as the LM calls it: dw in bf16, no
   db);
3. reduced Yi-6B and reduced Gemma-2 (prompts longer than its window of
   16) in f32 served on the card and on the CPU from the same weights and
   request stream: identical token streams, logits within 1e-4;
3b. a reduced CNN and case1 trained 4 AdamW steps on the card and on the
   CPU from the same numpy params and batches: losses and params agree;
3c. reduced Yi-6B, Phi-3 and Gemma-2 in f32 and bf16: ``lm.loss_fn`` and
   every gradient leaf on the card against the port's CPU run from the
   same numpy params and batch (CE chunks that pad, labels of -1), remat
   off and on (f32 within atol 2e-5 / rtol 1e-4, bf16 loss within 5e-3
   and gradients within atol / rtol 3e-2);
3d. reduced Qwen3-MoE (``qk_norm``) and Granite-MoE in f32 on the card
   against the port's CPU path from the same numpy params: phase 3's
   token streams, prefill logits (1e-4) and cache (1e-4) and 4 decode
   steps with per-row lengths, ``loss_fn``'s value and aux and every
   gradient leaf (phase 3c's f32 gates; remat off and on), and every
   router decision (``top_e``, ``keep``, slot) of all these calls equal;
   then each config's bf16 forward on the card reruns bit for bit;
4. full-width Yi-6B from a seed, 8 Poisson requests through the
   continuous-batching engine with measured timing; every request
   completes, logits are finite, K1 ran 224 and K9 65 times per forward
   call;
4b. the training slice: case7 (20.4 M params) at 32 px, B = 64, 20 AdamW
   steps through ``make_node_round``: finite losses, every grad leaf
   nonzero (at the initial params),
   exactly 56 launches a step (K1-K8: 7 7 7 10 9 10 3 3), step time,
   device time per kernel, busy share and peak memory;
4c. the slice: Gemma-2-27B at full width and 8 layers (4 local, 4
   global) from a seed, 4 Poisson requests (one prompt of 5000 tokens,
   past the 4096 window) through the continuous engine with 4 slots of
   5120 positions: every request completes, logits are finite, K1 ran 56
   and K9 33 times per forward call; then K10 through ``ops.flash_attention``
   on the q, k, v of layers 0 (local) and 1 (global) of the long prompt,
   held against the model's own blockwise attention (atol 8e-2, rtol
   2e-2: it rounds p to bf16) and against its plain version on the same
   q, k, v (phase 2c's gate);
4d. (run after 4b) the outer layer on 4 virtual nodes at speeds 1.0, 1.3,
   1.7 and 2.2, IDPA balanced, AdamW at lr 2e-3, 4 local steps, B = 64:
   (a) the quickstart configuration (16 px, 2 conv layers of 8, FC 2 x 64,
   3 allocation batches) under ``vmap`` and ``sequential`` for 3 rounds
   and ``heap`` for 12 pushes, on the card and on the CPU from the same
   numpy params with the clock pinned (a stub ``time`` in the engine
   module, fixed per-node durations): allocations, AGWU's node order, the
   clock, the sync-wait and the comm identical, losses within rtol 1e-4 /
   atol 1e-6, merged params within rtol 1e-3 / atol 1e-5; (b) Table-2
   case7 at full width over 8192 images in 4 batches, 3 SGWU rounds and 12
   AGWU pushes on the measured clock, ``cnn_accuracy`` on 512 held-out
   images weighting Eq. 7 and Eq. 10: finite losses, allocations summing
   to N, Eq. 11's comm exactly (pulls + pushes) x c_w, K1-K8 launches per
   event exactly (an SGWU round: 4 nodes x 4 steps x 56, plus 5 evals of
   20 forward launches, 996), per event the wall, virtual clock, sync-wait
   and allocation, per round (after a warm-up round) the device time by
   kernel and the busy share, peak memory, and the Eq. 7 merge +
   rebroadcast and the Eq. 10 apply on case7's tree against their byte
   bounds (9 and 4 c_w at 3.35 TB/s);
4e. (run after 4d) the LM's local step: Phi-3-mini at full width and 8
   layers (1.10 B params), B 8 x S 128 from ``lm_corpus``, AdamW, 10
   steps through ``make_node_round`` with ``lm.loss_fn``: finite losses
   that fall, every grad leaf nonzero (at the initial params), exactly
   7 L K1, 7 L K2 and 7 L K3 launches in bf16 and 2 L + 1 K9 forward and
   backward a step (no f32 dense kernel in the trace, every K2 and K3 a
   ``dense_bwd_wgmma``), step wall, device
   time by kernel and busy share (a step traced after a warm-up one),
   tokens/s, peak memory, and AdamW's update and apply alone against
   its byte floor (7 c_w at 3.35 TB/s);
4f. the training CLI ``launch/train.py``'s ``run``: (a) reduced Yi-6B
   in f32 on the card and on the CPU with the clock pinned, SGWU
   (``vmap``) 3 rounds and AGWU (``heap``) 8 pushes: allocations, node
   order, clock, sync-wait and comm identical, losses within rtol 1e-4 /
   atol 1e-6, merged params within rtol 1e-3 / atol 1e-5, every leaf;
   (b) Phi-3-mini at full width and 2 layers on 4 nodes at the CLI's
   defaults, the same counts on the measured clock: per event the wall,
   clock, sync-wait, comm and K1-K3 and K9 launches (exact), Eq. 11's
   comm exactly (pulls + pushes) x c_w, peak memory, then in a second,
   shorter run one round's (4 pushes') device time by kernel and busy
   share (traced after a warm-up one); (c) the CLI once at its defaults
   with ``--ckpt-dir``, its checkpoint restored with the port's
   ``restore``;
4g. (run after 4f) Qwen3-30B-A3B at full width and 8 of 48 layers from
   a seed (5.61 B params, f32 + bf16 compute copy): 8 Poisson requests
   through the continuous engine (every request completes, logits
   finite, exactly 32 K1 and 33 K9 launches per forward call: ln1, ln2,
   the q and k norms a layer, the final norm; TTFT, latency p50/p99,
   tok/s, peak memory), a decode step of 4 full slots timed and traced
   by kernel (K1, K9, cuBLAS, other, and the moe layers' spans: router,
   dispatch, experts, combine) against its byte floor (the layers' and
   the head's bf16 weights, every expert's included), and a 2048-token
   prompt's prefill timed (exact launches per call) and traced;
4h. Granite-3.0-MoE-3B at full width and 8 of 32 layers, phase 4e's
   loop (B 8 x S 128 from ``lm_corpus``, AdamW, 200 steps; exactly 32
   K1, K2 and K3 and 17 K9 forward and backward launches a step, every
   K2/K3 on the wgmma route, the held-out loss falls), plus the moe
   spans forward and backward in the traced step and the step's flop
   floor counted from the code;
3e. reduced Mamba2 (SSD chunk 8, so its 19-token prompt chains three
   chunks, the last padded) and reduced Hymba (window 16 on layer 1) in
   f32 on the card against the port's CPU path, as 3d without routing:
   token streams, prefill logits (1e-4), 4 decode steps with per-row
   lengths, every cache leaf (kv, conv, ssm; 1e-4), ``loss_fn`` and every
   gradient leaf (remat off and on); then each bf16 forward reruns bit
   for bit;
4i. (run after 4h) Mamba2-370M at full width and all 48 layers: 8
   Poisson requests through the continuous engine (every request
   completes, logits finite, exactly 96 K1 and 49 K9 launches per forward
   call; TTFT, latency p50/p99, tok/s, peak memory), a decode step of 4
   full slots timed and traced by kernel and by the mixer's spans
   (in_proj, conv, ssd, gate_norm, out_proj) against its byte floor (the
   weights, the head, each slot's f32 state read and written), and a
   2000-token prompt (eight 256-token SSD chunks, the last padded)
   prefilled, timed and traced;
4j. Hymba-1.5B at full width and all 32 layers (global layers 0, 15, 31,
   window 1024 elsewhere), as 4i: 288 K1 (in_proj 1600 -> 6457 on K1's
   element-by-element loads) and 129 K9 launches per forward call, a
   2048-token prompt past the window;
4k. Hymba-1.5B at full width and 8 of 32 layers through phase 4e's loop
   (B 8 x S 128 from ``lm_corpus`` over the reduced config's 512 token
   ids, the model's 32001 kept; AdamW, 100 steps): exactly 72 K1, K2
   and K3 and 33 K9 forward and backward launches a step, the traced
   step's K2/K3 on the routes their shapes' plans give (in_proj's on the
   mma.sync tile GEMM, the rest on the TMA + wgmma GEMM), the mixer's
   spans forward and backward, tokens/s, peak memory; the held-out
   objective must fall, and its CE by more than SSM_MIN_FALL nats (both
   read every 10 steps);
3f. reduced InternVL2 (8 patch tokens), reduced SeamlessM4T-v2 and a
   narrow dense config at StableLM's head_dim 160 (d 320, 2 q heads, 1 kv
   head, 2 layers) in f32 on the card against the port's CPU path from
   one numpy tree: InternVL2's image prompt through ``lm.forward`` (and
   ``steps.make_prefill_step``), its caches in 2 of 3 slots and 4 decode
   steps; Seamless's ``encode``, ``_decode_stack``, the cross cache
   filled from the memory, the 7-token prefix decoded a token at a time
   (each position within 1e-4 of the stack's logits) and 4 more steps;
   the narrow config as 3d; logits and caches within 1e-4, ``loss_fn`` /
   ``encdec_loss_fn`` and every gradient leaf at phase 3c's f32 gates;
   then each bf16 forward reruns bit for bit;
4l. (run after 4k) InternVL2-26B at full width and 8 of 48 layers (4.30 B
   params, f32 + bf16 compute copy): 8 Poisson text requests through the
   continuous engine (exactly 56 K1 and 17 K9 launches per forward call),
   4 image prompts (256 patch embeddings + 512 tokens) through
   ``steps.make_prefill_step`` timed (the same exact launches) and
   traced, inserted into the engine's 4 slots, 32 greedy decode steps,
   and a 4-slot decode step traced against its byte floor (the 8 layers'
   and the head's bf16 weights);
4m. InternVL2 at full width and 2 of 48 layers through phase 4e's loop
   (B 8 x (256 patches, one seeded draw, + 128 tokens from ``lm_corpus``
   over 512 ids), AdamW, 50 steps): exactly 14 K1, K2 and K3 and 5 K9
   forward and backward launches a step, the held-out objective falls and
   its CE by more than 2 nats, read every 10 steps;
4n. SeamlessM4T-large-v2 at full width and all 24 + 24 layers (1.78 B
   params from ``init_encdec_params``): ``encode`` of 4 x 4096 frames
   (169 K1, 49 K9 launches) and ``_decode_stack`` of a 64-token prefix
   (264 K1, 73 K9), each timed and traced; the cross cache filled from the
   memory, the prefix decoded a token at a time and 32 greedy steps (216
   K1, 73 K9 each), one traced against its byte floor (the decoder's bf16
   leaves the step reads, the head, the cross K/V); then 50 steps of
   ``steps.make_train_step`` at B 8 x (512 frames + 128 tokens), exactly
   433 K1, 432 K2 (``frontend_proj``'s input takes no gradient), 433 K3
   and 122 K9 forward and backward a step, the held-out CE falling by
   more than 2 nats;
4o. StableLM-2-12B at full width and 8 of 40 layers (head_dim 160) as 4i:
   8 Poisson requests (56 K1, 17 K9 launches per forward call), a 4-slot
   decode step traced against its byte floor, a 2048-token prompt's
   prefill traced;
5. the serving CLI once on the reduced config;
4p. (run after 5) the outer layer's checkpoints and tooling, on Table-2
   case7 at full width and 4 nodes (one IDPA batch, 2 local steps of B =
   64, AdamW): (a) the uninterrupted ``vmap`` (6 rounds) and ``heap`` (16
   pushes, durations pinned) runs with exact K1-K8 launches, then each
   broken after 3 rounds (checkpoint every 2) or 8 pushes (every 4) and
   resumed by a fresh trainer: final merged weights and the loss trail
   bit for bit, each state checkpoint's bytes and its save and restore
   seconds; (b) ``tests/torch_chaos_worker.py --case case7`` on the card
   (2 nodes, 4 rounds) SIGKILLed after its 3rd event and resumed by a new
   process: its final weights within 1e-5 of the job run uninterrupted
   here; (c) ``launch/train.py`` on reduced Phi-3 with ``--ckpt-every 2
   --resume`` through ``run``: a round, the same command again (no new
   event or file), then 2 rounds (the heap re-seeded; the final
   checkpoint at ``last_event``); (d) (a)'s uninterrupted runs with
   ``REPRO_SANITIZE=1``: identical bits, only the documented
   ``sync_log`` labels, ``compile_budget(0)`` (no kernel build), and
   an implicit sync inside ``sanitized`` raising; (e)
   ``examples/train_bpt_cnn_torch.py`` at its defaults above its accuracy
   floor, with exact K1-K8 launches (per local step, evals apart) and a
   local step's device time; (f) ``ClusterSim`` (4 nodes, 2 iterations,
   AGWU and SGWU), each work unit one case7 SGD step on the card, its
   metrics equal to the CPU run's and its weights within 1e-5;
4q. (run after 4p) the multi-device outer layer, one controller over a
   pool of four ``cuda:0`` (``BPTTrainer(devices=)``): first K1-K8 at the
   batch family's shard shapes (case7 at B = 16) and K1-K3 at the channel
   family's column shards (M = 32, each fc width halved) against their
   plain versions, with their times summed over a node step; then (a)
   Table-2 case7, nothing cut, one IDPA batch, B = 32 a node, 2 local
   steps, 2 SGWU rounds: ``device`` on ``nodes4`` and on
   ``nodes2xmodel2`` under the batch and the channel family, each held to
   ``vmap`` on the card within rtol 1e-5 / atol 1e-6 (losses, merged
   weights) with exact K1-K8 launches, scheduled == executed, then each
   again with ``REPRO_SANITIZE=1`` (identical bits, the named sync
   points only, no kernel build), and the family the H100 ``HW`` default
   picks for case7 with its costs; (b) ``heap-device`` (8 pushes,
   durations pinned) held to ``heap``, and ``device`` and ``heap-device``
   broken and resumed bit for bit; (c) the quickstart on a ``[cuda:0,
   cpu]`` pool (node 1 takes the plain versions) held to the all-card
   run within 4d(a)'s tolerances, and armed (the ``node-move`` syncs
   logged); (d) Phi-3-mini at full width, 2 layers, through
   ``launch/train.py`` on ``nodes2xmodel2`` (the generic batch plan): the
   split gradient against the whole batch's (3c's bf16 gates), then 2
   rounds held to ``vmap`` (the bf16 loss gate; params within 2 lr a
   step), exact K1-K3 and K9 launches; then the wall and device ms of a
   case7 round of ``device`` and ``vmap``, in turns;
4r. (run after 4q) the dry-run tooling: (a) ``block_skip`` on the card:
   Gemma-2-27B at full width and 8 layers on phase 4c's 5000-token
   prompt, and Hymba-1.5B at full depth on phase 4j's 2048-token prompt,
   each prefilled (``lm.prefill``, bf16 compute copy) under
   ``get_config(arch, "opt")`` and under the plain config: logits and
   every cache leaf bit-identical, the kv blocks skipped counted, each
   run's device ms (``device_ms``) taken in turns, plain then opt;
   (b) started before (a), on the host while (a) runs on the card:
   ``python -m repro_torch.launch.dryrun`` for ``gemma2-27b train_4k
   pod`` and ``granite-moe-3b-a800m decode_32k pod`` in subprocesses
   (fake process groups of 256 ranks, no card), each under a time limit;
   their roofline rows (data-sheet estimates, not measurements) and wall
   seconds printed, a failure failing the phase; and the five
   ``decode_32k`` pairs on ``tiny`` that
   ``tests/test_torch_dryrun_collectives.py`` holds against the JAX
   dry-run (Yi-6B, Phi-3-mini, Mamba2-370M, Hymba-1.5B, Qwen3-MoE) and
   the two ``prefill_32k`` pairs cut to 2048 tokens that
   ``tests/test_torch_dryrun_prefill_collectives.py`` holds (Mamba2-370M,
   Hymba-1.5B), each held here to the reference's numbers written into
   the script: ``outside`` not negative and the per-layer collective
   bytes within 2x (both at f32 width); and four ``train_4k`` pairs cut
   to 1024 tokens that ``tests/test_torch_dryrun_train_collectives.py``
   and ``_moe_ssm.py`` hold (Yi-6B, StableLM-2-12B, InternVL2-26B,
   Hymba-1.5B), held to the reference's at its band: the total and
   per-layer bytes within 1.5x both ways, ``outside`` within 2x and not
   negative.  The ``gemma2-27b train_4k pod`` row fails the phase if its
   FLOPs or collective bytes are more than 1.1x those of the record this
   torch 2.13 sweep wrote (DRYRUN_RECORD: the card host's torch 2.11
   once counted 1.80x and 3.76x there);
6. a JSON line with every ported kernel (device-clock times as the extra
   fields ``device_ms`` and ``library_device_ms``, "not measured" being
   null; K1 also its prefill sums as ``prefill_*`` and ``gemma_prefill_*``,
   K9 its Gemma-2 prefill forward's 33 launches at 5000 x 4608 as
   ``prefill_*``, K6 its passes as ``pass_device_ms``, K10 its f32
   instance on the S = 5000 pair as ``f32_*``, K1-K8 phase 4d's launches
   as ``outer_launches``; K1 its bf16 training instance as
   ``train_bf16_*``, K2 and K3 their bf16 instances as ``bf16_*`` and K9
   its backward as ``bwd_*``, launches from phase 4e, their
   ``*_outer_launches`` from 4f(b); K1 Qwen3-MoE's decode and prefill
   sums as ``qwen_*`` and ``qwen_prefill_*`` (launches from 4g), K1, K2
   and K3 Granite-MoE's step as ``granite_train_bf16_*`` and
   ``granite_bf16_*``, K9 Qwen3-MoE's forwards as ``qwen_*`` and
   ``qwen_prefill_*`` and its backward in Granite-MoE's step as
   ``granite_bwd_*``; K1 and K9 Mamba2's and Hymba's decode steps and
   long prefills as ``mamba_*``, ``mamba_prefill_*``, ``hymba_*`` and
   ``hymba_prefill_*`` (launches from 4i, 4j), K1, K2 and K3 Hymba's
   training step as ``hymba_train_bf16_*`` and ``hymba_bf16_*``, K9's
   backward there as ``hymba_bwd_*``; K1 and K9 InternVL2's and
   StableLM's decode steps and prefills as ``internvl_*``,
   ``internvl_prefill_*`` (the 4 image prompts), ``stablelm_*`` and
   ``stablelm_prefill_*`` (launches from 4l, 4o), Seamless's decode step,
   encode and decoder prefix as ``seamless_*``, ``seamless_encode_*`` and
   ``seamless_prefill_*`` (4n); K1, K2 and K3 InternVL2's and Seamless's
   training steps as ``internvl_train_bf16_*`` / ``internvl_bf16_*`` and
   ``seamless_train_bf16_*`` / ``seamless_bf16_*``, K9's backward there
   as ``internvl_bwd_*`` and ``seamless_bwd_*``; K1-K8 phase 4p(a)'s
   launches as ``ckpt_launches`` and 4p(e)'s as ``example_launches``, K1,
   K2, K3 and K9 4p(c)'s as ``ckpt_cli_launches``; K1-K8 phase 4q's
   batch-family shards as ``multi_batch_*`` and K1-K3 its channel-family
   column shards as ``multi_channel_*``, launches from 4q(a)), then the
   card again, then the result line ``{"ok": true, "device": {...}}``.

It needs one card, imports no JAX and nothing of the JAX package ``repro``.

    python3 chip_smoke.py --k1-rows 512,5000

builds the kernels and runs phase 2 alone at those rows M (the other rows
and the sums are left out), then stops without a result line: copied into
the root of another checkout, it times that checkout's K1 the same way.

    python3 chip_smoke.py --train-kernels K3,K4,K5

does the same for phase 2b and the named kernels, phase 2d and its
named kernels (K1, K2, K3, K9: its backward), and

    python3 chip_smoke.py --lm-kernels K2,K3
    python3 chip_smoke.py --k9
    python3 chip_smoke.py --k10

for phase 2c's K9 and K10 cases, and

    python3 chip_smoke.py --outer

for phase 4d, and

    python3 chip_smoke.py --lm

for phases 2d, 3c, 4e and 4f, and

    python3 chip_smoke.py --moe

for phases 3d, 4g and 4h, and

    python3 chip_smoke.py --ssm

for phases 3e, 4i, 4j and 4k, and

    python3 chip_smoke.py --mm

for phases 3f, 4l, 4m, 4n and 4o, and

    python3 chip_smoke.py --ckpt

for phase 4p, and

    python3 chip_smoke.py --multi

for phase 4q, and

    python3 chip_smoke.py --dryrun

for phase 4r.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,
              "tf32": 495e12}      # dense tensor-core TF32
BF16_TOL = 1e-2                    # x max|ref|: one bf16 rounding of the output
F32_TOL = 1e-5                     # x max|ref|: f32 sums in another order
SERVE_TOL = 1e-4                   # card vs CPU logits, reduced f32 model
DECODE_SHAPES = {                  # one layer's projections: (name, K, N)
    "yi-6b": (("wq", 4096, 4096), ("wk", 4096, 512), ("wv", 4096, 512),
              ("wo", 4096, 4096), ("wg", 4096, 11008),
              ("wi", 4096, 11008), ("mlp_wo", 11008, 4096)),
    "gemma2-27b": (("wq", 4608, 4096), ("wk", 4608, 2048),
                   ("wv", 4608, 2048), ("wo", 4096, 4608),
                   ("wg", 4608, 36864), ("wi", 4608, 36864),
                   ("mlp_wo", 36864, 4608)),
    # the experts' products are library einsums, not K1 (moe.py)
    "qwen3-moe-30b-a3b": (("wq", 2048, 4096), ("wk", 2048, 512),
                          ("wv", 2048, 512), ("wo", 4096, 2048)),
    # the mixer's in- and out-projections (the scan, conv and gated norm
    # are library ops, as in the reference)
    "mamba2-370m": (("in_proj", 1024, 4384), ("out_proj", 2048, 1024)),
    # in_proj's 6457 columns are no multiple of 8: element-by-element loads
    "hymba-1.5b": (("wq", 1600, 1600), ("wk", 1600, 320), ("wv", 1600, 320),
                   ("wo", 1600, 1600), ("in_proj", 1600, 6457),
                   ("out_proj", 3200, 1600), ("wg", 1600, 5504),
                   ("wi", 1600, 5504), ("mlp_wo", 5504, 1600)),
    "internvl2-26b": (("wq", 6144, 6144), ("wk", 6144, 1024),
                      ("wv", 6144, 1024), ("wo", 6144, 6144),
                      ("wg", 6144, 16384), ("wi", 6144, 16384),
                      ("mlp_wo", 16384, 6144)),
    "stablelm-12b": (("wq", 5120, 5120), ("wk", 5120, 1280),
                     ("wv", 5120, 1280), ("wo", 5120, 5120),
                     ("wg", 5120, 13824), ("wi", 5120, 13824),
                     ("mlp_wo", 13824, 5120)),
    # a decoder layer's decode step: self-attention's four, the cross
    # attention's q and o (its k and v are the filled cache), the MLP's
    # three; the encoder's and the cross k/v projections share the widths
    "seamless-m4t-large-v2": (("wq", 1024, 1024), ("wk", 1024, 1024),
                              ("wv", 1024, 1024), ("wo", 1024, 1024),
                              ("xq", 1024, 1024), ("xo", 1024, 1024),
                              ("wg", 1024, 8192), ("wi", 1024, 8192),
                              ("mlp_wo", 8192, 1024)),
}
DECODE_LAYERS = {"yi-6b": 32, "gemma2-27b": 8,      # phases 4, 4c, 4g, 4i
                 "qwen3-moe-30b-a3b": 8,            # and 4j: full depth
                 "mamba2-370m": 48, "hymba-1.5b": 32,
                 "internvl2-26b": 8, "stablelm-12b": 8,   # 4l, 4o
                 "seamless-m4t-large-v2": 24}             # 4n: full depth
K1_ROWS = (1, 4, 16,               # decode rows (the split-K stream)
           17, 24, 64)             # prefill rows (the tile GEMM, 64-row)
K1_MODEL_ROWS = {"yi-6b": K1_ROWS,
                 # long prompts (128-row tiles)
                 "gemma2-27b": K1_ROWS + (512, 5000),
                 # and phase 4g's 2048-token prompt
                 "qwen3-moe-30b-a3b": K1_ROWS + (2048,),
                 # 4i's 2000-token prompt (8 SSD chunks, the last padded)
                 "mamba2-370m": K1_ROWS + (2000,),
                 # 4j's 2048-token prompt, past the 1024 window
                 "hymba-1.5b": K1_ROWS + (2048,),
                 # 4l's image prompts: 4 x (256 patches + 512 tokens)
                 "internvl2-26b": K1_ROWS + (3072,),
                 # 4o's 2048-token prompt
                 "stablelm-12b": K1_ROWS + (2048,),
                 # 4n: the decoder's 4 x 64-token prefix, the encoder's
                 # 4 x 4096 frames (and the cross k/v of that memory)
                 "seamless-m4t-large-v2": K1_ROWS + (256, 16384)}
PREFILL_ROWS = {"yi-6b": 24, "gemma2-27b": 5000,   # the prefill sums
                "qwen3-moe-30b-a3b": 2048, "mamba2-370m": 2000,
                "hymba-1.5b": 2048, "internvl2-26b": 3072,
                "stablelm-12b": 2048, "seamless-m4t-large-v2": 16384}
# archs whose phase-2 rows are timed at the summed rows only (these): the
# other rows are held against the plain version and rerun, which is what
# the served plans need
TIMED_ROWS = {arch: (4, PREFILL_ROWS[arch]) for arch in (
    "mamba2-370m", "hymba-1.5b", "internvl2-26b", "stablelm-12b")}
TIMED_ROWS["seamless-m4t-large-v2"] = (4, 256, 16384)
K1_RAGGED = (                      # (dtype, M, K, N), bias + relu
    ("float32", 37, 100, 77), ("bfloat16", 5, 72, 70),
    ("bfloat16", 33, 100, 130),
    # split-K: N off the 64-column tile, K off the 64-deep step, N or K not
    # a multiple of 8 (element-by-element loads), 144 slices of one step
    ("bfloat16", 1, 4100, 520), ("bfloat16", 16, 1000, 77),
    ("bfloat16", 7, 4099, 130), ("bfloat16", 3, 36864, 100),
    # prefill: N off the 128-column tile, K off the 32-deep step, 128-row
    # tiles clipped at M, element-by-element loads, split and not
    ("bfloat16", 17, 4099, 130), ("bfloat16", 65, 1000, 77),
    ("bfloat16", 129, 4100, 520), ("bfloat16", 200, 72, 70))

def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def roof_ms(nbytes, flops, dtype="float32") -> tuple[float, str]:
    """Least time for work that moves ``nbytes`` (each input read once,
    each output written once) and does ``flops`` at the tensor cores'
    (bf16) or FMA (f32) peak, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_ms(M, N, K, dtype) -> tuple[float, str]:
    """Least time for act(x @ w) with x (M, K) and w (K, N)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    return roof_ms((M * K + K * N + M * N) * itemsize, 2.0 * M * N * K,
                   dtype)


def dominant(bound_by_ms: dict) -> str:
    """"bytes" or "operations": whichever bounds more of a summed bound."""
    return max(bound_by_ms, key=bound_by_ms.get)


def time_ms(torch, fn, arg_sets, iters=50, warmup=5) -> float:
    """Mean time of ``fn`` by CUDA events, cycling through ``arg_sets`` so
    weights larger in total than the 50 MB L2 arrive cold, as in serving."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, arg_sets, iters=50, warmup=5, tries=3):
    """Device time of one ``fn`` call: ``time_ms``'s cycled loop under
    ``torch.profiler``, each CUDA kernel's time read as
    ``launch/profile_decode.py`` reads it.  The tracer starts a moment
    after the profiler and misses launches (seen: all of a short loop, one
    of four long calls), so a first pass of the loop is the warm-up step of
    the profiler's schedule and only the second is read; each kernel
    counts as the mean of its recorded launches times the launches a call
    makes, and a loop that records no device time is traced again, up to
    ``tries`` times.  Returns (ms, or None where the profiler recorded no
    device time; {kernel name: its ms per ``fn`` call})."""
    from repro_torch.launch.profile_decode import annotation, device_us
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for _ in range(tries):
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):          # the warm-up step, then the traced one
                for i in range(iters):
                    fn(*arg_sets[i % len(arg_sets)])
                torch.cuda.synchronize()
                prof.step()
        us, names = 0.0, {}
        for evt in prof.key_averages():
            t = device_us(evt)
            if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA \
                    and not annotation(evt):   # a span, not a kernel
                per = t / evt.count * max(1, round(evt.count / iters))
                us += per
                names[evt.key] = per / 1e3
        if us > 0:
            return us / 1e3, names
    return None, {}


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f}"


def add_ms(total, n, ms):
    """total + n * ms, None (not measured) once either is None."""
    return None if total is None or ms is None else total + n * ms


# ----------------------------------------------------------------------
def _k1_check(torch, dense_cuda, ref, x, w, b=None, activation="none"):
    """K1 against dense_ref; returns (out, max_abs_err, tol)."""
    got = dense_cuda(x, w, b, activation=activation)
    want = ref.dense_ref(x, w, b, activation=activation)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = (F32_TOL if x.dtype == torch.float32 else BF16_TOL) * \
        want.float().abs().max().item()
    return got, err, tol


def _k1_sum():
    return {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "library_device_ms": 0.0, "bound_ms": 0.0, "bound_by": {},
            "launches": 0}


def phase_kernel(torch, dense_mod, ref, only=None):
    """K1 against dense_ref at every Yi-6B and Gemma-2 projection shape at
    M = 1, 4, 16 (split-K decode stream), 17, 24 and 64 (prefill tile
    GEMM, 64-row tiles) and, at Gemma-2's shapes, 512 and 5000 (128-row
    tiles), at Qwen3-MoE's at M = 1, 4, 16 and 2048, plus ragged cases;
    every shape reruns bit for bit.  Returns the per-model sums of a
    decode step (M = 4) and of a prefill forward (Yi-6B at M = 24,
    Gemma-2 at M = 5000, Qwen3-MoE at 2048, ...; PREFILL_ROWS), the worst
    error, and per timed case (arch, M, K, N) its error, tolerance and
    ``_time_case``-style times (``k1_sum_of`` adds them up where a
    forward's launches are no multiple of DECODE_SHAPES: Seamless's).
    ``only``, a set of rows, keeps just those rows and leaves out the
    sums."""
    gen = torch.Generator("cuda").manual_seed(1)
    dense_cuda = dense_mod.dense_cuda
    sums = {(arch, kind): _k1_sum() for arch in DECODE_SHAPES
            for kind in ("decode", "prefill")
            if (arch, kind) != (ENC_ARCH, "prefill")}
    cases = {}
    worst = {"err": 0.0, "ratio": 0.0, "tol": 0.0}
    names = set()
    log(f"[k1] {'model':<10} {'shape':<12} {'x':>1} {'M':>4} {'S':>3}  "
        f"{'max_abs_err':<11} {'tol':<9} {'kernel_ms':<9} {'device_ms':<9} "
        f"{'plain_ms':<9} {'library_ms':<10} {'lib_dev_ms':<10} "
        f"{'bound_ms':<9} bound/device")
    for arch, shapes in DECODE_SHAPES.items():
        unique = {}
        for name, K, N in shapes:
            unique.setdefault((K, N), []).append(name)
        rows = K1_MODEL_ROWS[arch]
        for M in (M for M in rows if only is None or M in only):
            timed = arch not in TIMED_ROWS or M in TIMED_ROWS[arch]
            for (K, N), which in unique.items():
                wbytes = K * N * 2
                copies = max(2, min(64, math.ceil(256e6 / wbytes))) \
                    if timed else 1
                x = torch.randn((M, K), generator=gen, device="cuda"
                                ).to(torch.bfloat16)
                ws = [(torch.randn((K, N), generator=gen, device="cuda")
                       / math.sqrt(K)).to(torch.bfloat16)
                      for _ in range(copies)]
                got, err, tol = _k1_check(torch, dense_cuda, ref, x, ws[0])
                if not err <= tol:
                    raise AssertionError(f"K1 {arch} {K}x{N} M={M}: "
                                         f"max_abs_err {err} > tol {tol}")
                S, _ = dense_mod.bf16_splits(M, N, K)
                if not torch.equal(got, dense_cuda(x, ws[0])):
                    raise AssertionError(f"K1 {arch} {K}x{N} M={M} gave "
                                         "different bits on a rerun")
                if err / tol > worst["ratio"]:
                    worst = {"err": err, "ratio": err / tol, "tol": tol}
                if not timed:
                    log(f"[k1] {arch:<10} {K:>5}x{N:<6} {len(which)} {M:>4} "
                        f"{S:>3}  {err:<11.4g} {tol:<9.4g} (held and rerun; "
                        "timed at the summed rows only)")
                    del x, ws, got
                    continue
                sets = [(x, w) for w in ws]
                iters = 20 if M >= 512 else 50
                k_ms = time_ms(torch, dense_cuda, sets, iters=iters)
                k_dev, seen = device_ms(torch, dense_cuda, sets, iters=iters)
                names.update(seen)   # the kernels' names
                p_ms = time_ms(torch, ref.dense_ref, sets, iters=iters)
                l_ms = time_ms(torch, torch.matmul, sets, iters=iters)
                l_dev, _ = device_ms(torch, torch.matmul, sets, iters=iters)
                b_ms, by = bound_ms(M, N, K, "bfloat16")
                cases[(arch, M, K, N)] = dict(
                    err=err, tol=tol,
                    t=(k_ms, k_dev, p_ms, l_ms, l_dev, b_ms, by))
                log(f"[k1] {arch:<10} {K:>5}x{N:<6} {len(which)} {M:>4} "
                    f"{S:>3}  {err:<11.4g} {tol:<9.4g} "
                    f"{k_ms:<9.5f} {fmt_ms(k_dev):<9} {p_ms:<9.5f} "
                    f"{l_ms:<10.5f} {fmt_ms(l_dev):<10} {b_ms:<9.5f} "
                    + ("-" if k_dev is None else f"{b_ms / k_dev:.3f}"))
                for kind, at in (("decode", 4),
                                 ("prefill", PREFILL_ROWS[arch])):
                    if M != at or (arch, kind) not in sums:
                        continue
                    n = DECODE_LAYERS[arch] * len(which)
                    st = sums[(arch, kind)]
                    st["ms"] += n * k_ms
                    st["device_ms"] = add_ms(st["device_ms"], n, k_dev)
                    st["plain_ms"] += n * p_ms
                    st["library_ms"] += n * l_ms
                    st["library_device_ms"] = add_ms(
                        st["library_device_ms"], n, l_dev)
                    st["bound_ms"] += n * b_ms
                    st["bound_by"][by] = st["bound_by"].get(by, 0.0) + \
                        n * b_ms
                    st["launches"] += n
                del x, ws, sets, got
                torch.cuda.empty_cache()
    log("[k1] bf16 device kernels: " + ", ".join(sorted(names)))

    for dtype, M, K, N in K1_RAGGED:
        tdt = getattr(torch, dtype)
        x = torch.randn((M, K), generator=gen, device="cuda").to(tdt)
        w = torch.randn((K, N), generator=gen, device="cuda").to(tdt)
        b = torch.randn((N,), generator=gen, device="cuda")
        got, err, tol = _k1_check(torch, dense_cuda, ref, x, w, b, "relu")
        bf16 = dtype == "bfloat16"
        S = dense_mod.bf16_splits(M, N, K)[0] if bf16 else "-"
        log(f"[k1] ragged {dtype} M={M} K={K} N={N} S={S} bias+relu: "
            f"max_abs_err {err:.4g} tol {tol:.4g}")
        if not err <= tol:
            raise AssertionError(f"K1 ragged {dtype} ({M},{K},{N}): "
                                 f"max_abs_err {err} > tol {tol}")
        if bf16 and not torch.equal(got, dense_cuda(x, w, b, "relu")):
            raise AssertionError(f"K1 ragged ({M},{K},{N}) gave different "
                                 "bits on a rerun")
        if bf16 and err / tol > worst["ratio"]:
            worst = {"err": err, "ratio": err / tol, "tol": tol}
    log("[k1] bf16 reruns bit for bit at every decode, prefill and ragged "
        "shape")
    for (arch, kind), st in sums.items():
        if only is not None:
            break
        M = 4 if kind == "decode" else PREFILL_ROWS[arch]
        log(f"[k1] one {arch} {kind} forward ({st['launches']} launches, "
            f"M={M}): kernel {st['ms']:.4f} ms (device "
            f"{fmt_ms(st['device_ms'])}), plain {st['plain_ms']:.4f} ms, "
            f"torch.matmul {st['library_ms']:.4f} ms (device "
            f"{fmt_ms(st['library_device_ms'])}), bound "
            f"{st['bound_ms']:.4f} ms ({dominant(st['bound_by'])})")
    return sums, worst, cases


# ----------------------------------------------------------------------
# The CNN training slice: K2-K8 and K1 at the case7 shapes
# ----------------------------------------------------------------------
TRAIN_KERNELS = (  # (key, JSON name, source, the TPU kernel it replaces)
    ("K1", "dense_fwd (K1)", "dense_fwd.cu", "src/repro/kernels/dense.py:46"),
    ("K2", "dense_dx (K2)", "dense_bwd.cu", "src/repro/kernels/dense.py:59"),
    ("K3", "dense_dwdb (K3)", "dense_bwd.cu",
     "src/repro/kernels/dense.py:69"),
    ("K4", "conv2d_fwd (K4)", "conv2d.cu", "src/repro/kernels/conv2d.py:72"),
    ("K5", "conv2d_dx (K5)", "conv2d.cu", "src/repro/kernels/conv2d.py:86"),
    ("K6", "conv2d_dw (K6)", "conv2d.cu", "src/repro/kernels/conv2d.py:98"),
    ("K7", "max_pool2d_fwd (K7)", "pool2d.cu",
     "src/repro/kernels/pool2d.py:45"),
    ("K8", "max_pool2d_bwd (K8)", "pool2d.cu",
     "src/repro/kernels/pool2d.py:57"),
)
STEP_LAUNCHES = {"K1": 7, "K2": 7, "K3": 7, "K4": 10, "K5": 9, "K6": 10,
                 "K7": 3, "K8": 3}   # one case7 training step
GRAD_TOL = 1e-4                    # x max(max|ref|, 1): the reference's gate
TRAIN_BATCH = 64


def conv_flops(B, H, W, Cin, Cout, k, padding, ref):
    """2 x the multiply-adds a stride-1 conv needs: taps that land in the
    padding are not counted."""
    top, _, left, _ = ref.conv_pads(k, k, padding)
    Ho, Wo = (H, W) if padding == "SAME" else (H - k + 1, W - k + 1)
    th = sum(1 for h in range(Ho) for i in range(k) if 0 <= h + i - top < H)
    tw = sum(1 for w in range(Wo) for j in range(k) if 0 <= w + j - left < W)
    return 2.0 * B * th * tw * Cin * Cout


def case7_step_shapes(cnn, B=TRAIN_BATCH):
    """The shapes one case7 training step at B images (default 64) hands
    each kernel, as (shape, launches per step)."""
    cfg = cnn.make_case("case7")
    shapes, final = cnn._conv_shapes(cfg)
    k = cfg.filter_size
    dims = ([final * final * cfg.filters] + [cfg.fc_neurons]
            * (cfg.fc_layers - 1) + [cfg.num_classes])
    fc = {}
    for j in range(cfg.fc_layers):
        key = (B, dims[j], dims[j + 1], j < cfg.fc_layers - 1)
        fc[key] = fc.get(key, 0) + 1
    conv, conv_dx, pool = {}, {}, {}
    for i, (cin, cout, s, pooled) in enumerate(shapes):
        key = (B, s, s, cin, cout, k, "SAME")
        conv[key] = conv.get(key, 0) + 1
        if i > 0:                  # the images need no gradient
            conv_dx[key] = conv_dx.get(key, 0) + 1
        if pooled:
            pool[(B, s, s, cout)] = pool.get((B, s, s, cout), 0) + 1
    return {"K1": fc, "K2": fc, "K3": fc, "K4": conv, "K5": conv_dx,
            "K6": conv, "K7": pool, "K8": pool}


RAGGED = {   # correctness only: odd B, Cin = 3, k = 2/4/7, VALID, ragged tiles
    "dense": ((37, 100, 77, True), (5, 3, 130, False), (64, 192, 70, True)),
    # K3 over a long reduction on a small output (32 slices of 128 rows);
    # its 128 x 64 register tile with Din and Dout not multiples of 4
    "dwdb": ((4096, 77, 10, True), (70, 2001, 2003, True)),
    # (M, Din, Dout, relu) for K1 and K2's split-K product: reductions of
    # 1000-1002 cut into 7 slices of 144 (the last ragged), K or N not a
    # multiple of 4 (element-by-element loads), one 10-wide tile
    "split": ((37, 1000, 77, True), (37, 77, 1000, True),
              (64, 1002, 200, True), (64, 200, 1002, True),
              (3, 1001, 77, False), (64, 2000, 1000, False),
              (64, 10, 2000, True)),
    "conv": ((3, 9, 7, 3, 5, 2, "SAME"), (3, 9, 7, 3, 5, 4, "SAME"),
             (3, 9, 7, 3, 5, 7, "SAME"), (3, 9, 7, 4, 20, 3, "VALID"),
             (1, 8, 8, 12, 12, 7, "VALID"), (5, 6, 6, 12, 12, 7, "SAME")),
    # K4/K5 past one block's shared memory (Cin in chunks; K5's 2048-wide
    # output in column tiles) and past 16 output channels (column tiles)
    "conv_wide": ((1, 8, 8, 2048, 16, 3, "SAME"),
                  (2, 9, 7, 4, 300, 3, "SAME")),
    # (B, H, W, C[, window]): ragged, tied, and window 3 off the 16-byte lanes
    "pool": ((3, 9, 7, 5), (2, 8, 8, 12), (3, 10, 11, 7, 3)),
}


def _train_specs(torch, ref, mods):
    """Per kernel: make(gen, shape) -> args, the kernel and its plain
    version (on args), the library call (on lib_args(*args), made outside
    the timing: layout views and, for K8, the forward graph), bytes, flops
    and whether it is a gradient (tolerance)."""
    F = torch.nn.functional
    dn, cv, pl = mods["dense"], mods["conv2d"], mods["pool2d"]

    def rnd(gen, shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def relu_out(gen, shape):      # a post-relu map: about half zeros
        return torch.relu(rnd(gen, shape))

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def oihw(w):                   # HWIO -> OIHW view, channels-last strides
        return w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)

    def fc_args(gen, s, with_x):
        M, Din, Dout, relu = s
        g = rnd(gen, (M, Dout))
        first = rnd(gen, (M, Din)) if with_x else \
            rnd(gen, (Din, Dout)) / math.sqrt(Din)
        return (g, first, relu_out(gen, (M, Dout)) if relu else None)

    def conv_geom(s):
        B, H, W, Cin, Cout, k, pad = s
        Ho, Wo = (H, W) if pad == "SAME" else (H - k + 1, W - k + 1)
        return B, H, W, Cin, Cout, k, pad, Ho, Wo

    def pool_x(gen, s):
        B, H, W, C = s
        if H % 2 == 0 and W % 2 == 0 and B == 2:   # the tied-window case
            x = torch.relu(torch.round(rnd(gen, s)))
            x[0, :2, :2, :] = 0.0                   # an all-zero window
            return x
        return relu_out(gen, s)

    def k1(gen, s):
        M, Din, Dout, relu = s
        return (rnd(gen, (M, Din)), rnd(gen, (Din, Dout)) / math.sqrt(Din),
                rnd(gen, (Dout,)), "relu" if relu else "none")

    def k4(gen, s):
        B, H, W, Cin, Cout, k, pad, _, _ = conv_geom(s)
        return (rnd(gen, (B, H, W, Cin)),
                rnd(gen, (k, k, Cin, Cout)) / math.sqrt(k * k * Cin),
                rnd(gen, (Cout,)), pad)

    def k5(gen, s):
        B, H, W, Cin, Cout, k, pad, Ho, Wo = conv_geom(s)
        return (rnd(gen, (B, Ho, Wo, Cout)),
                rnd(gen, (k, k, Cin, Cout)) / math.sqrt(k * k * Cin),
                (B, H, W, Cin), pad, relu_out(gen, (B, Ho, Wo, Cout)))

    def k6(gen, s):
        B, H, W, Cin, Cout, k, pad, Ho, Wo = conv_geom(s)
        return (rnd(gen, (B, H, W, Cin)), rnd(gen, (B, Ho, Wo, Cout)),
                (k, k, Cin, Cout), pad, relu_out(gen, (B, Ho, Wo, Cout)))

    def window(s):
        return s[4] if len(s) > 4 else 2

    def k8(gen, s):
        x = pool_x(gen, s[:4])
        out = ref.max_pool2d_ref(x, window(s), window(s))
        return (x, out, rnd(gen, tuple(out.shape)), window(s))

    def pool_bwd_graph(x, out, g, k):   # the forward, outside the timing
        xg = nchw(x).detach().requires_grad_()
        return F.max_pool2d(xg, k), xg, nchw(g)

    def conv_bytes(s, bias, mask):
        """x (or dx), out (or g), the filter (or dw), bias (or db), mask."""
        B, H, W, Cin, Cout, k, pad, Ho, Wo = conv_geom(s)
        return 4 * (B * H * W * Cin + B * Ho * Wo * Cout * (1 + mask)
                    + k * k * Cin * Cout + Cout * bias)

    def cflops(s):
        B, H, W, Cin, Cout, k, pad = s
        return conv_flops(B, H, W, Cin, Cout, k, pad, ref)

    def splits_by(mod, name, per):
        """{"splits": shape -> per(mod.name, shape)}, the slices (K4/K5:
        tiles) a shape takes, where the checkout has mod.name; a parent's
        checkout, run with --train-kernels, may not."""
        fn = getattr(mod, name, None)
        return {} if fn is None else {"splits": lambda s: per(fn, s)}

    return {
        "K1": dict(make=k1, kern=lambda x, w, b, a: dn.dense_cuda(
                       x, w, b, activation=a),
                   plain=lambda x, w, b, a: ref.dense_ref(x, w, b, a),
                   lib=torch.matmul, lib_args=lambda x, w, b, a: (x, w),
                   nbytes=lambda s: 4 * (s[0] * s[1] + s[1] * s[2] + s[2]
                                         + s[0] * s[2]),
                   flops=lambda s: 2.0 * s[0] * s[1] * s[2], grad=False,
                   splits=lambda s: dn.dense_splits(s[0], s[2], s[1])),
        "K2": dict(make=lambda gen, s: fc_args(gen, s, False),
                   kern=dn.dense_dx_cuda, plain=ref.dense_dx_ref,
                   lib=lambda g, w, o: torch.matmul(g, w.t()),
                   nbytes=lambda s: 4 * (s[0] * s[2] * (2 if s[3] else 1)
                                         + s[1] * s[2] + s[0] * s[1]),
                   flops=lambda s: 2.0 * s[0] * s[1] * s[2], grad=True,
                   splits=lambda s: dn.dense_splits(s[0], s[1], s[2])),
        "K3": dict(make=lambda gen, s: (lambda g, x, o: (x, g, o))(
                       *fc_args(gen, s, True)),
                   kern=dn.dense_dwdb_cuda, plain=ref.dense_dwdb_ref,
                   lib=lambda x, g, o: (torch.matmul(x.t(), g), g.sum(0)),
                   nbytes=lambda s: 4 * (s[0] * s[1] + s[0] * s[2]
                                         * (2 if s[3] else 1) + s[1] * s[2]
                                         + s[2]),
                   flops=lambda s: 2.0 * s[0] * s[1] * s[2] + s[0] * s[2],
                   grad=True, **splits_by(dn, "dwdb_splits",
                                          lambda f, s: f(*s[:3]))),
        "K4": dict(make=k4, kern=lambda x, w, b, p: cv.conv2d_cuda(
                       x, w, b, padding=p, activation="relu"),
                   plain=lambda x, w, b, p: ref.conv2d_fused_ref(
                       x, w, b, padding=p, activation="relu"),
                   lib=lambda x, w, b: F.conv2d(x, w, b, padding="same"),
                   lib_args=lambda x, w, b, p: (nchw(x), oihw(w), b),
                   nbytes=lambda s: conv_bytes(s, 1, 0), flops=cflops,
                   grad=False, **splits_by(cv, "conv_tiles", lambda f, s: f(
                       s[0], *conv_geom(s)[7:], s[3], s[4], s[5], s[5],
                       False))),
        "K5": dict(make=k5, kern=cv.conv2d_dx_cuda, plain=ref.conv2d_dx_ref,
                   lib=lambda size, w, g: torch.nn.grad.conv2d_input(
                       size, w, g, padding=w.shape[2] // 2),
                   lib_args=lambda g, w, xs, p, o: (
                       (xs[0], xs[3], xs[1], xs[2]), oihw(w), nchw(g)),
                   nbytes=lambda s: conv_bytes(s, 0, 1), flops=cflops,
                   grad=True, **splits_by(cv, "conv_tiles", lambda f, s: f(
                       *s[:3], s[4], s[3], s[5], s[5], True))),
        "K6": dict(make=k6, kern=cv.conv2d_dw_cuda, plain=ref.conv2d_dw_ref,
                   lib=lambda x, size, g: torch.nn.grad.conv2d_weight(
                       x, size, g, padding=size[2] // 2),
                   lib_args=lambda x, g, ws, p, o: (
                       nchw(x), (ws[3], ws[2], ws[0], ws[1]), nchw(g)),
                   nbytes=lambda s: conv_bytes(s, 1, 1),
                   flops=lambda s: cflops(s) + s[0] * s[1] * s[2] * s[4],
                   grad=True),
        "K7": dict(make=lambda gen, s: (pool_x(gen, s[:4]), window(s)),
                   kern=pl.max_pool2d_cuda,
                   plain=lambda x, k: ref.max_pool2d_ref(x, k, k),
                   lib=F.max_pool2d, lib_args=lambda x, k: (nchw(x), k),
                   nbytes=lambda s: 4 * (s[0] * s[1] * s[2] * s[3] * 5 // 4),
                   flops=lambda s: float(s[0] * s[1] * s[2] * s[3]),
                   grad=False),
        "K8": dict(make=k8, kern=pl.max_pool2d_bwd_cuda,
                   plain=ref.max_pool2d_bwd_ref,
                   lib=lambda y, xg, g: torch.autograd.grad(
                       y, xg, g, retain_graph=True),
                   lib_args=pool_bwd_graph,
                   nbytes=lambda s: 4 * (s[0] * s[1] * s[2] * s[3] * 5 // 2),
                   flops=lambda s: float(2 * s[0] * s[1] * s[2] * s[3]),
                   grad=True),
    }


def _flat(torch, out):
    if isinstance(out, (tuple, list)):
        return torch.cat([t.reshape(-1) for t in out])
    return out.reshape(-1)


def _compare(torch, key, spec, args):
    got = _flat(torch, spec["kern"](*args))
    want = _flat(torch, spec["plain"](*args))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = GRAD_TOL * max(scale, 1.0) if spec["grad"] else F32_TOL * scale
    return err, tol


RERUN = ("K1", "K2", "K3", "K4", "K5", "K6")   # checked bit for bit


def _time_shape(torch, spec, gen, s, n, args, row, head):
    """Kernel (events and device clock), plain, library and bound times of
    one shape, added n times into ``row``'s sums and logged after
    ``head``; returns the kernel's device ms by kernel name."""
    nbytes = spec["nbytes"](s)
    copies = max(2, min(64, math.ceil(256e6 / nbytes)))
    sets = [args] + [spec["make"](gen, s) for _ in range(copies - 1)]
    k_ms = time_ms(torch, spec["kern"], sets)
    k_dev, seen = device_ms(torch, spec["kern"], sets)
    p_ms = time_ms(torch, spec["plain"], sets, iters=20)
    lib_args = spec.get("lib_args", lambda *a: a)
    lib_sets = [lib_args(*a) for a in sets]
    l_ms = time_ms(torch, spec["lib"], lib_sets)
    l_dev, _ = device_ms(torch, spec["lib"], lib_sets)
    b_ms, by = roof_ms(nbytes, spec["flops"](s))
    log(f"{head}{k_ms:<10.5f} {fmt_ms(k_dev):<12} {p_ms:<10.5f} "
        f"{l_ms:<10.5f} {fmt_ms(l_dev):<12} {b_ms:.5f}")
    row["ms"] += n * k_ms
    row["device_ms"] = add_ms(row["device_ms"], n, k_dev)
    row["library_device_ms"] = add_ms(row["library_device_ms"], n, l_dev)
    row["plain_ms"] += n * p_ms
    row["library_ms"] += n * l_ms
    row["bound_ms"] += n * b_ms
    row["bound_by"][by] = row["bound_by"].get(by, 0.0) + n * b_ms
    return seen


def phase_train_kernels(torch, ref, mods, cnn, only=None):
    """K2-K8 (and K1 at the FC shapes) against their plain versions on the
    card, at every case7 B = 64 shape and the ragged, wide and tied cases;
    per kernel, times summed over one training step's launches.  ``only``
    limits it to those kernels."""
    specs = _train_specs(torch, ref, mods)
    step = case7_step_shapes(cnn)
    gen = torch.Generator("cuda").manual_seed(2)
    rows = {}
    one = [(torch.zeros(1, device="cuda"),) for _ in range(2)]
    floor_dev, _ = device_ms(torch, lambda t: t.zero_(), one)
    log(f"[train-k] one launch's device floor (a one-float zero_(), "
        f"device_ms): {fmt_ms(floor_dev)} ms")
    log(f"[train-k] {'kernel':<4} {'shape':<34} {'x':>2} {'S':>4}  "
        f"{'max_abs_err':<11} {'tol':<10} {'kernel_ms':<10} {'device_ms':<12} "
        f"{'plain_ms':<10} {'library_ms':<10} {'lib_dev_ms':<12} bound_ms")
    for key, spec in specs.items():
        if only is not None and key not in only:
            continue
        row = {"err": 0.0, "tol": 0.0, "ratio": -1.0, "ms": 0.0,
               "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "library_device_ms": 0.0, "bound_ms": 0.0, "bound_by": {},
               "passes": {}}
        kind = {"K1": "dense", "K2": "dense", "K3": "dense", "K7": "pool",
                "K8": "pool"}.get(key, "conv")
        extra = list(RAGGED["split"] if key in ("K1", "K2") else
                     RAGGED["dwdb"] if key == "K3" else
                     RAGGED["conv_wide"] if key in ("K4", "K5") else ())
        cases = [(s, n) for s, n in step[key].items()]
        if key != "K1":
            cases += [(s, 0) for s in RAGGED[kind]]
        cases += [(s, 0) for s in extra]
        for s, n in cases:
            S = str(spec["splits"](s)) if "splits" in spec else "-"
            args = spec["make"](gen, s)
            err, tol = _compare(torch, key, spec, args)
            if not err <= tol:
                raise AssertionError(f"{key} {s}: max_abs_err {err} > tol "
                                     f"{tol}")
            ratio = err / tol if tol > 0 else 0.0
            if ratio > row["ratio"]:
                row.update(err=err, tol=tol, ratio=ratio)
            if n == 0:
                log(f"[train-k] {key:<4} {str(s):<34} {'-':>2} {S:>4}  "
                    f"{err:<11.4g} {tol:<10.4g}")
                continue
            seen = _time_shape(torch, spec, gen, s, n, args, row,
                               f"[train-k] {key:<4} {str(s):<34} {n:>2} "
                               f"{S:>4}  {err:<11.4g} {tol:<10.4g} ")
            if key == "K6":     # each pass's device time
                passes = {re.search(r"conv_dw_\w+", name).group(0): ms
                          for name, ms in seen.items()}
                for name, ms in passes.items():
                    row["passes"][name] = row["passes"].get(name, 0.0) \
                        + n * ms
                log(f"[train-k] K6   {str(s):<34} device ms by pass: "
                    + ", ".join(f"{k} {v:.5f}"
                                for k, v in sorted(passes.items())))
        if key in RERUN:
            # fixed summation orders: identical bits on a rerun, at every
            # case7 shape and the split, long and wide cases
            for s in list(step[key]) + extra:
                args = spec["make"](gen, s)
                a, b = (_flat(torch, spec["kern"](*args)) for _ in range(2))
                if not torch.equal(a, b):
                    raise AssertionError(f"{key} {s} gave different bits on "
                                         "a rerun")
            log(f"[train-k] {key} reruns bit for bit at every case7"
                + (" and extra" if extra else "") + " shape")
        log(f"[train-k] {key} one case7 step ({STEP_LAUNCHES[key]} launches): "
            f"kernel {row['ms']:.5f} ms (device {fmt_ms(row['device_ms'])}),"
            f" plain {row['plain_ms']:.5f} ms, library "
            f"{row['library_ms']:.5f} ms (device "
            f"{fmt_ms(row['library_device_ms'])}), bound {row['bound_ms']:.5f}"
            f" ms ({dominant(row['bound_by'])}); worst max_abs_err "
            f"{row['err']:.4g} at tol {row['tol']:.4g}"
            + ("; device ms by pass: " + ", ".join(
                f"{k} {v:.5f}" for k, v in sorted(row["passes"].items()))
               if row["passes"] else ""))
        rows[key] = row
    return rows


def _train_cfg(types, **kw):
    return types.TrainConfig(optimizer="adamw", learning_rate=2e-3, **kw)


def phase_train_reduced(torch, port):
    """A reduced CNN and Table-2 case1 trained 4 AdamW steps on the card
    and on the CPU from the same numpy params and batches."""
    import numpy as np
    cnn, weights, trainer = port.cnn, port.weights, port.trainer
    inner = cnn.CNNConfig(name="inner", image_size=8, conv_layers=1,
                          filters=4, fc_layers=2, fc_neurons=16)
    tc = _train_cfg(port.types, warmup_steps=5, total_steps=100)
    for cfg, B in ((inner, 16), (cnn.make_case("case1"), 8)):
        host = cnn.init_cnn(cfg, torch.Generator("cpu").manual_seed(0),
                            device="cpu")
        tree = weights.params_to_numpy(host)
        xs, ys = port.synthetic.image_dataset(4 * B, size=cfg.image_size, seed=0)

        def loss_fn(p, b, cfg=cfg):
            return cnn.cnn_loss(p, b, cfg), {}

        runs = {}
        for dev in ("cuda", "cpu"):
            params = weights.params_from_numpy(tree, cfg, dev)
            step = trainer.make_step_body(loss_fn, tc)
            opt = port.optim.make_optimizer(tc.optimizer).init(params)
            losses = []
            for i in range(4):
                batch = {"images": torch.as_tensor(xs[i * B:(i + 1) * B],
                                                   device=dev),
                         "labels": torch.as_tensor(ys[i * B:(i + 1) * B],
                                                   device=dev)}
                params, opt, loss = step(params, opt, batch, i + 1)
                losses.append(float(loss))
            runs[dev] = (losses, weights.params_to_numpy(params))
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                                   rtol=1e-4, atol=1e-6)
        diff = 0.0
        for a, b in zip(port.tree.tree_leaves(runs["cuda"][1]),
                        port.tree.tree_leaves(runs["cpu"][1]), strict=True):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)
            diff = max(diff, float(np.abs(a - b).max()))
        log(f"[train-reduced] {cfg.name} B={B}: 4 AdamW steps, card losses "
            f"{runs['cuda'][0]} vs cpu {runs['cpu'][0]}; final params "
            f"max_abs_diff {diff:.3g} (rtol 1e-3, atol 1e-5)")


KERNEL_NAMES = (   # device kernel name -> the port's kernel, for the profile
    # K1 f32 and K2 are two passes each (split-K product, fixed-order sum):
    # dense_fwd_f32_kernel + dense_fwd_f32_sum_kernel, dense_dx_kernel +
    # dense_dx_sum_kernel
    ("dense_fwd_f32", "K1"), ("dense_dx_", "K2"),
    ("dense_dwdb_", "K3"), ("conv_tile_kernel<false>", "K4"),
    ("conv_tile_kernel<true>", "K5"), ("conv_dw_", "K6"),
    ("pool_fwd_kernel", "K7"), ("pool_bwd_kernel", "K8"))


def _counts(mods):
    dn, cv, pl = mods["dense"], mods["conv2d"], mods["pool2d"]
    return {"K1": dn.dense_cuda.launches, "K2": dn.dense_dx_cuda.launches,
            "K3": dn.dense_dwdb_cuda.launches, "K4": cv.conv2d_cuda.launches,
            "K5": cv.conv2d_dx_cuda.launches,
            "K6": cv.conv2d_dw_cuda.launches,
            "K7": pl.max_pool2d_cuda.launches,
            "K8": pl.max_pool2d_bwd_cuda.launches}


def _zero_counts(mods):
    dn, cv, pl = mods["dense"], mods["conv2d"], mods["pool2d"]
    for fn in (dn.dense_cuda, dn.dense_dx_cuda, dn.dense_dwdb_cuda,
               cv.conv2d_cuda, cv.conv2d_dx_cuda, cv.conv2d_dw_cuda,
               pl.max_pool2d_cuda, pl.max_pool2d_bwd_cuda):
        fn.launches = 0


def phase_train_slice(torch, port, mods, card, steps=20):
    """The slice: Table-2 case7 at 32 px, B = 64, f32, 20 AdamW steps
    through make_node_round; exact launch counts per step."""
    import numpy as np
    cnn, trainer = port.cnn, port.trainer
    cfg = cnn.make_case("case7")
    B = TRAIN_BATCH
    params = cnn.init_cnn(cfg, torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    n_params = sum(p.numel() for p in port.tree.tree_leaves(params))
    tc = _train_cfg(port.types, warmup_steps=10, total_steps=steps, grad_clip=1.0,
                    local_steps=1)

    def loss_fn(p, b):
        return cnn.cnn_loss(p, b, cfg), {}

    node_round = trainer.make_node_round(loss_fn, tc)
    opt = port.optim.make_optimizer(tc.optimizer).init(params)
    xs, ys = port.synthetic.image_dataset(steps * B, size=cfg.image_size, seed=0)
    batches = [{"images": torch.as_tensor(xs[None, i * B:(i + 1) * B],
                                          device="cuda"),
                "labels": torch.as_tensor(ys[None, i * B:(i + 1) * B],
                                          device="cuda")}
               for i in range(steps)]
    # every leaf's gradient reaches it through the kernels (checked at the
    # initial params: with AdamW at lr 2e-3 the case7 softmax can saturate
    # within 20 steps, after which Eq. 16's gradient is exactly 0)
    one = {k: v[0] for k, v in batches[0].items()}
    _, grads = trainer.value_and_grad(loss_fn, params, one)
    zero = [i for i, g in enumerate(port.tree.tree_leaves(grads))
            if not bool(g.abs().sum() > 0)]
    if zero:
        raise AssertionError(f"grad leaves {zero} are all zero")
    del grads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    _zero_counts(mods)
    for i, batch in enumerate(batches):
        before = _counts(mods)
        t0 = time.perf_counter()
        params, opt, loss = node_round(params, opt, batch, i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: v - before[k] for k, v in _counts(mods).items()}
        if per != STEP_LAUNCHES:
            raise AssertionError(f"step {i}: launches {per} != "
                                 f"{STEP_LAUNCHES}")
        losses.append(loss)
    launches = _counts(mods)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu()
    log(f"[train] losses {losses.tolist()}")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite losses: {losses.tolist()}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof_steps = 3
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(prof_steps):
            params, opt, _ = node_round(params, opt, batches[i], steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / prof_steps
    dev_ms = {k: 0.0 for k in STEP_LAUNCHES}
    dev_ms["other"] = 0.0
    dev_n = dict.fromkeys(dev_ms, 0)
    passes = {}                    # K1 f32 / K2 device kernels by name
    for evt in prof.key_averages():
        us = port.profile.device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for pat, k in KERNEL_NAMES if pat in evt.key), "other")
        dev_ms[key] += us / 1e3 / prof_steps
        dev_n[key] += evt.count
        if key in ("K1", "K2"):
            name = re.search(r"dense_\w+", evt.key).group(0)
            ms, n = passes.get(name, (0.0, 0))
            passes[name] = (ms + us / 1e3 / prof_steps, n + evt.count)
    busy_ms = port.profile.busy_us(prof) / 1e3 / prof_steps
    total = sum(dev_ms.values())
    log(f"[train] case7 full width ({n_params} params f32), B={B}, {steps} "
        f"AdamW steps, card: {card}")
    log(f"[train] launches {launches} = {steps} x {STEP_LAUNCHES}; every "
        "grad leaf nonzero at the initial params")
    log(f"[train] step mean {np.mean(step_ms[1:]):.3f} ms over steps 2-"
        f"{steps} (first {step_ms[0]:.3f} ms), p50 "
        f"{np.percentile(step_ms[1:], 50):.3f} ms | max_memory_allocated "
        f"{peak / 1e9:.3f} GB ({card})")
    if total > 0:
        log(f"[train] profiled {prof_steps} steps: {wall_ms:.3f} ms wall a "
            f"step, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}"
            f"%), kernel time {total:.3f} ms a step: " + ", ".join(
                f"{k} {v:.4f}" for k, v in dev_ms.items()))
        k_kernels = sum(n for k, n in dev_n.items() if k != "other")
        log(f"[train] device kernels a step: "
            f"{k_kernels / prof_steps:.1f} of K1-K8 for their "
            f"{sum(STEP_LAUNCHES.values())} launches (K1 f32 and K2 run a "
            f"second pass where they split) and "
            f"{dev_n['other'] / prof_steps:.1f} others (PyTorch "
            "elementwise and reductions: loss, clipping, AdamW)")
        log("[train] K1 f32 / K2 device time a step by pass: " + ", ".join(
            f"{name} {ms:.4f} ms ({n / prof_steps:.0f})"
            for name, (ms, n) in sorted(passes.items())))
    else:
        log("[train] device time per kernel: not measured (the profiler "
            "recorded no device time)")
    return launches, {"step_ms": float(np.mean(step_ms[1:])),
                      "device_ms": dev_ms if total > 0 else None}


# ----------------------------------------------------------------------
# The outer layer: IDPA, SGWU (Eq. 7) and AGWU (Eq. 9-10) on 4 virtual nodes
# ----------------------------------------------------------------------
OUTER_SPEEDS = (1.0, 1.3, 1.7, 2.2)    # the quickstart's node speed factors
OUTER_NODES = 4
OUTER_LOCAL_STEPS = 4
OUTER_TICK = 0.05                      # phase 4d(a)'s stub clock step (s)
EVAL_LAUNCHES = {"K1": 7, "K4": 10, "K7": 3}   # one case7 cnn_accuracy call
QUICKSTART = dict(name="quickstart", image_size=16, conv_layers=2, filters=8,
                  fc_layers=2, fc_neurons=64)


class _StubClock:
    """Stands in for ``time`` in the port's engine module: ``perf_counter``
    steps by OUTER_TICK a call, so every stacked round's wall is fixed."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += OUTER_TICK
        return self.now


def _outer_trainer(port, cfg, params, data, engine_name, batches,
                   eval_fn=None, pinned=False, **tc):
    """A BPTTrainer on 4 nodes at OUTER_SPEEDS over IDPA (balanced) with
    the quickstart's optimizer; ``pinned`` fixes each node's local-round
    duration at 0.01 s x its speed through the ``_local_round`` seam."""
    import numpy as np
    speeds = np.asarray(OUTER_SPEEDS)
    xs, ys = data
    ds = port.pipeline.IDPADataset(
        {"images": xs, "labels": ys}, num_nodes=OUTER_NODES, batches=batches,
        frequencies=1.0 / speeds, partitioning="idpa", idpa_mode="balanced")
    kw = port.engine.engine_config(engine_name, outer_nodes=OUTER_NODES,
                                   local_steps=OUTER_LOCAL_STEPS,
                                   warmup_steps=10, **tc)
    tr = port.trainer.BPTTrainer(
        lambda p, b: (port.cnn.cnn_loss(p, b, cfg), {}), params, ds,
        _train_cfg(port.types, **kw), batch_size=TRAIN_BATCH,
        eval_fn=eval_fn, speed_factors=speeds)
    if pinned:
        orig = tr._local_round

        def pin(p, opt, node, step):
            p, opt, loss, _ = orig(p, opt, node, step)
            return p, opt, loss, 0.01 * float(speeds[node])

        tr._local_round = pin
    return tr


def phase_outer_parity(torch, port):
    """Phase 4d(a): the quickstart configuration's outer layer on the card
    and on the CPU from the same numpy params, with the clock pinned:
    ``vmap`` and ``sequential`` 3 rounds, ``heap`` 12 pushes."""
    import numpy as np
    cnn, weights = port.cnn, port.weights
    cfg = cnn.CNNConfig(**QUICKSTART)
    tree = weights.params_to_numpy(cnn.init_cnn(
        cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
    data = port.synthetic.image_dataset(2000, size=16, seed=0)
    for name in ("vmap", "sequential", "heap"):
        runs = {}
        for dev in ("cuda", "cpu"):
            tr = _outer_trainer(port, cfg,
                                weights.params_from_numpy(tree, cfg, dev),
                                data, name, batches=3,
                                pinned=name != "vmap", total_steps=400)
            real, port.engine.time = port.engine.time, _StubClock()
            try:
                evs = list(tr.run(3))
            finally:
                port.engine.time = real
            runs[dev] = (evs, [h.tolist() for h in tr.dataset.part.history])
        (card_evs, card_hist), (cpu_evs, cpu_hist) = runs["cuda"], runs["cpu"]
        keys = [[(e.round, e.node, e.virtual_clock, e.sync_wait,
                  e.comm_bytes) for e in evs] for evs in (card_evs, cpu_evs)]
        if keys[0] != keys[1] or card_hist != cpu_hist:
            raise AssertionError(f"[outer-parity] {name}: bookkeeping differs"
                                 f" card {keys[0]} {card_hist} vs cpu "
                                 f"{keys[1]} {cpu_hist}")
        loss_diff = param_diff = 0.0
        for a, b in zip(card_evs, cpu_evs):
            np.testing.assert_allclose(a.node_losses, b.node_losses,
                                       rtol=1e-4, atol=1e-6)
            loss_diff = max(loss_diff,
                            float(np.abs(a.node_losses - b.node_losses).max()))
            for x, y in zip(port.tree.tree_leaves(weights.params_to_numpy(
                    a.params)), port.tree.tree_leaves(weights.params_to_numpy(
                        b.params)), strict=True):
                np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5)
                param_diff = max(param_diff, float(np.abs(x - y).max()))
        log(f"[outer-parity] {name}: {len(card_evs)} events identical on "
            f"the card and the CPU (clock {card_evs[-1].virtual_clock:.4f} s,"
            f" sync_wait {card_evs[-1].sync_wait:.4f} s, comm "
            f"{card_evs[-1].comm_bytes} B, allocations {card_hist}"
            + (f", node order {[e.node for e in card_evs]}"
               if name == "heap" else "")
            + f"); losses max_abs_diff {loss_diff:.3g} (rtol 1e-4, atol "
            f"1e-6), merged params max_abs_diff {param_diff:.3g} (rtol 1e-3,"
            " atol 1e-5)")


def _outer_expected(name, i):
    """K1-K8 launches of event ``i``: the node rounds' steps and the evals'
    forwards.  SGWU: 4 nodes x 4 steps x 56, and 5 evals (one a node for
    Eq. 7, one of the merged weights). AGWU: 4 steps x 56, the pushing
    node's eval for Eq. 10, and every 4th push the merged weights' eval."""
    if name == "vmap":
        steps, evals = OUTER_NODES * OUTER_LOCAL_STEPS, OUTER_NODES + 1
    else:
        steps = OUTER_LOCAL_STEPS
        evals = 1 + ((i + 1) % OUTER_NODES == 0)
    return {k: steps * n + evals * EVAL_LAUNCHES.get(k, 0)
            for k, n in STEP_LAUNCHES.items()}


def _outer_profile(torch, port, tr, per_step):
    """Device time of one round (SGWU) or one virtual round of 4 pushes
    (AGWU) under ``torch.profiler``, after a warm-up step of its schedule
    (``device_ms``'s reading): {kernel: ms}, busy ms and the traced wall."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    events = tr.run(2)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):                # the warm-up step, then the traced
            t0 = time.perf_counter()
            for _ in range(per_step):
                next(events)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    dev_ms = dict.fromkeys(list(STEP_LAUNCHES) + ["other"], 0.0)
    for evt in prof.key_averages():
        us = port.profile.device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA \
                or port.profile.annotation(evt):   # a span, not a kernel
            continue
        key = next((k for pat, k in KERNEL_NAMES if pat in evt.key), "other")
        dev_ms[key] += us / 1e3
    return dev_ms, port.profile.busy_us(prof) / 1e3, wall_ms


def phase_outer_slice(torch, port, mods, card):
    """Phase 4d(b): Table-2 case7 at full width on 4 virtual nodes, 3 SGWU
    rounds (``vmap``) and 12 AGWU pushes (``heap``) on the measured clock:
    exact K1-K8 launches per event, exact Eq. 11 comm, IDPA allocations
    that sum to N; per event the wall, the virtual clock, the sync-wait
    and the allocation; per round the device time by kernel and the busy
    share; the Eq. 7 merge and the Eq. 10 apply against their byte
    bounds.  Returns the K1-K8 launches of the two runs."""
    import numpy as np
    cnn, gwu = port.cnn, port.gwu
    cfg = cnn.make_case("case7")
    params = cnn.init_cnn(cfg, torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    leaves = port.tree.tree_leaves(params)
    c_w = sum(p.numel() * p.element_size() for p in leaves)
    n_img = 8192
    data = port.synthetic.image_dataset(n_img, size=cfg.image_size, seed=0)
    xe, ye = port.synthetic.image_dataset(512, size=cfg.image_size, seed=42)
    eval_batch = {"images": torch.as_tensor(xe, device="cuda"),
                  "labels": torch.as_tensor(ye, device="cuda")}

    def eval_fn(p):
        return cnn.cnn_accuracy(p, eval_batch, cfg)

    def make(name):
        return _outer_trainer(port, cfg, params, data, name, batches=4,
                              eval_fn=eval_fn, total_steps=100, grad_clip=1.0)

    log(f"[outer] case7 full width ({sum(p.numel() for p in leaves)} params "
        f"f32, c_w {c_w} B), {OUTER_NODES} nodes at speeds {OUTER_SPEEDS}, "
        f"IDPA balanced over {n_img} images in 4 batches, B={TRAIN_BATCH}, "
        f"{OUTER_LOCAL_STEPS} local steps, AdamW lr 2e-3 (warmup 10 of 100 "
        f"steps, grad_clip 1.0), cnn_accuracy on 512 held-out images; "
        f"card: {card}")
    total = dict.fromkeys(STEP_LAUNCHES, 0)
    for name, what in (("vmap", "SGWU round"), ("heap", "AGWU push")):
        tr = make(name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(mods)
        before, last, walls = _counts(mods), None, []
        t_prev = time.perf_counter()
        for ev in tr.run(3):
            now = time.perf_counter()
            walls.append((now - t_prev) * 1e3)
            counts = _counts(mods)
            per = {k: counts[k] - before[k] for k in counts}
            before = counts
            if per != _outer_expected(name, ev.round):
                raise AssertionError(f"[outer] {name} event {ev.round}: "
                                     f"launches {per} != "
                                     f"{_outer_expected(name, ev.round)}")
            if not np.isfinite(ev.node_losses).all():
                raise AssertionError(f"[outer] {name} event {ev.round}: "
                                     f"losses {ev.node_losses}")
            log(f"[outer] {what} {ev.round}"
                + (f" (node {ev.node})" if ev.node >= 0 else "")
                + f": wall {walls[-1]:.3f} ms, virtual clock "
                f"{ev.virtual_clock:.6f} s, sync_wait {ev.sync_wait:.6f} s, "
                f"loss {ev.loss:.6f}, accuracy {ev.accuracy}, comm "
                f"{ev.comm_bytes} B, allocation {tr.dataset.totals.tolist()}"
                f", K1-K8 launches {sum(per.values())}")
            t_prev, last = time.perf_counter(), ev
        peak = torch.cuda.max_memory_allocated()
        for k, n in _counts(mods).items():
            total[k] += n
        hist = tr.dataset.part.history
        if any(int(h.sum()) != n_img // 4 for h in hist) \
                or int(tr.dataset.totals.sum()) != n_img:
            raise AssertionError(f"[outer] {name}: allocations "
                                 f"{[h.tolist() for h in hist]} do not "
                                 f"sum to {n_img}")
        # Eq. 11: SGWU pulls and pushes every node every round; AGWU's 12
        # pushes each re-pull but the last of each node, after 4 pulls
        pulls = pushes = OUTER_NODES * 3
        if last.comm_bytes != (pulls + pushes) * c_w:
            raise AssertionError(f"[outer] {name}: comm {last.comm_bytes} "
                                 f"!= ({pulls} + {pushes}) x {c_w}")
        log(f"[outer] {name}: {last.round + 1} events, comm "
            f"{last.comm_bytes} B = ({pulls} pulls + {pushes} pushes) x c_w "
            f"(Eq. 11, exact); allocations {[h.tolist() for h in hist]}; "
            f"max_memory_allocated {peak / 1e9:.3f} GB ({card})")
        per_step = 1 if name == "vmap" else OUTER_NODES
        dev_ms, busy_ms, wall_ms = _outer_profile(torch, port, make(name),
                                                  per_step)
        kern = sum(v for k, v in dev_ms.items() if k != "other")
        # the unprofiled wall of the same unit: the mean of the measured
        # events after the first (which carries the first launches)
        plain_ms = per_step * float(np.mean(walls[1:]))
        log(f"[outer] {name} profiled {'round' if name == 'vmap' else '4 pushes'}"
            f" (after a warm-up one): wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%; "
            f"{100 * busy_ms / plain_ms:.1f}% of the unprofiled "
            f"{plain_ms:.3f} ms), device ms by kernel: " + ", ".join(
                f"{k} {v:.4f}" for k, v in dev_ms.items())
            + f" (K1-K8 {kern:.4f})")

    # the merges on case7's tree, against their byte bounds: Eq. 7 reads
    # the 4-node stack and writes the merged tree and the new stack (9 c_w);
    # Eq. 10 reads global, local and base and writes the new global (4 c_w)
    stack = gwu.broadcast_tree(params, OUTER_NODES)
    qs = [0.25, 0.3, 0.2, 0.25]
    local = port.tree.tree_map(lambda x: x * 1.01, params)
    base = port.tree.tree_map(lambda x: x * 0.99, params)
    for label, fn, args, nbytes in (
            ("Eq. 7 merge + rebroadcast", gwu.sgwu_merge_and_rebroadcast,
             (stack, qs), 9 * c_w),
            ("Eq. 10 apply", lambda g, lw, b: gwu.agwu_update(
                g, lw, b, 0.7, 1.1), (params, local, base), 4 * c_w)):
        ev_ms = time_ms(torch, fn, [args], iters=20)
        dv_ms, names = device_ms(torch, fn, [args], iters=20)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[outer] {label}: event {ev_ms:.5f} ms, device {fmt_ms(dv_ms)} "
            f"ms against the byte bound {bound:.5f} ms ({nbytes / 1e6:.1f} MB"
            f" at 3.35 TB/s)" + (f", {bound / dv_ms:.0%} of it" if dv_ms
                                 else "") + "; device kernels: " + ", ".join(
                f"{k[:40]} {v:.4f}" for k, v in names.items()))
    del stack, local, base
    return total


# ----------------------------------------------------------------------
# K9 and K10 at the LM shapes
# ----------------------------------------------------------------------
ATTN_TOL = {"bfloat16": (8e-2, 2e-2), "float32": (1e-4, 1e-3)}  # atol, rtol
# K10 against flash_attention_ref: both sum the same f32 terms, in another
# order, and round once to the output dtype.  bf16: one bf16 ulp of |ref|
# (<= 2^-7 |ref|) plus 1e-3 of the output's rms for sums that cancel;
# f32: the test tolerance (atol 1e-4, rtol 1e-3).
K10_BF16_GATE = (2.0 ** -7, 1e-3)   # x |ref|, x rms(ref)
QSCALE = 8.0   # q x 8 where a soft-cap is on: scores ~N(0, 64) reach the
#                range where cap * tanh(s / cap) differs from s by percents
RMS_CASES = [(rows, d, dt) for d in (4608, 4096, 3072)   # decode, prefill
             for rows in (4, 4500) for dt in ("bfloat16", "float32")]
RMS_CASES += [(5000, 4608, "bfloat16"),                   # the long prompt
              (5, 4095, "bfloat16"), (37, 1000, "float32"),
              (3, 13, "bfloat16"),                        # ragged rows
              (3001, 4095, "bfloat16")]   # many unaligned rows: chunked
# Qwen3-MoE (phase 4g): ln1/ln2/final at d = 2048 and the q/k norms at
# head_dim 128, a decode step's rows (4 slots; 32 q and 4 k heads) and the
# 2048-token prompt's
QWEN_RMS = {"decode": ((4, 2048), (128, 128), (16, 128)),
            "prefill": ((2048, 2048), (65536, 128), (8192, 128))}
RMS_CASES += [(rows, d, "bfloat16") for kind in ("decode", "prefill")
              for rows, d in QWEN_RMS[kind]]
# Mamba2 (phase 4i, d = 1024), Hymba (4j, d = 1600), InternVL2 (4l, d =
# 6144; its prefill the 4 image prompts' 3072 rows) and StableLM (4o, d =
# 5120): every norm of a forward at d_model, a decode step's 4 rows and
# the long prompt's
SERVE_RMS = {arch: {"decode": (4, d), "prefill": (PREFILL_ROWS[arch], d)}
             for arch, d in (("mamba2-370m", 1024), ("hymba-1.5b", 1600),
                             ("internvl2-26b", 6144),
                             ("stablelm-12b", 5120))}
# Seamless (4n, d = 1024): a decode step's 4 rows, the encoder's 4 x 4096
# frames and the decoder's 4 x 64-token prefix
ENC_RMS = {"decode": (4, 1024), "encode": (16384, 1024),
           "prefill": (256, 1024)}
RMS_CASES = list(dict.fromkeys(RMS_CASES + [
    (rows, d, "bfloat16") for kinds in (*SERVE_RMS.values(), ENC_RMS)
    for rows, d in kinds.values()]))
# (name, B, H, KH, Sq, Sk, D, dtype, window, softcap)
FLASH_CASES = [
    ("gemma2 global", 1, 32, 16, 8192, 8192, 128, "bfloat16", 0, 50.0),
    ("gemma2 local", 1, 32, 16, 8192, 8192, 128, "bfloat16", 4096, 50.0),
    ("gemma2 local", 1, 32, 16, 5000, 5000, 128, "bfloat16", 4096, 50.0),
    ("gemma2 global", 1, 32, 16, 5000, 5000, 128, "bfloat16", 0, 50.0),
    ("gemma2 global", 1, 32, 16, 8192, 8192, 128, "float32", 0, 50.0),
    ("gemma2 local", 1, 32, 16, 8192, 8192, 128, "float32", 4096, 50.0),
    ("gemma2 local", 1, 32, 16, 5000, 5000, 128, "float32", 4096, 50.0),
    ("gemma2 global", 1, 32, 16, 5000, 5000, 128, "float32", 0, 50.0),
    ("yi-6b", 1, 32, 4, 4096, 4096, 128, "bfloat16", 0, 0.0),
    ("yi-6b swa", 1, 32, 4, 8192, 8192, 128, "bfloat16", 4096, 0.0),
    ("phi3", 1, 32, 32, 4096, 4096, 96, "bfloat16", 0, 0.0),
    ("sq>sk", 1, 4, 2, 300, 200, 64, "float32", 0, 0.0),
    ("sq>sk", 1, 4, 2, 300, 200, 64, "bfloat16", 0, 0.0),
]
GEMMA_LONG = 5000                  # the long prompt of phase 4c


def live_pairs(Sq, Sk, causal=True, window=0) -> int:
    """(q, k) pairs that no mask removes (ends aligned as in K10)."""
    import numpy as np
    qp = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(qp, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_bound_ms(B, H, KH, Sq, Sk, D, dtype, window, causal=True,
                   tf32x3=False):
    """QK and PV over the live pairs at the dtype's peak, or q, k, v and
    out read and written once, whichever is larger.  ``tf32x3``: f32 done
    as three TF32 products (3xTF32) at the tensor cores' TF32 peak, a
    lower bound than the FMA one for the same function."""
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * B * D * (2 * H * Sq + 2 * KH * Sk)
    flops = 4.0 * D * B * H * live_pairs(Sq, Sk, causal, window)
    if tf32x3:
        return roof_ms(nbytes, 3 * flops, "tf32")
    return roof_ms(nbytes, flops, dtype)


def _attn_err(torch, got, want, dtype):
    atol, rtol = ATTN_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return diff.max().item(), ok


def _k10_gate(torch, got, want, dtype):
    """K10 against its plain version at its gate; returns (max_abs_err,
    the allowance where |err| / allowance peaks, that peak, gate text);
    the gate holds while the peak is at most 1."""
    w = want.float()
    diff = (got.float() - w).abs()
    if dtype == "float32":
        atol, rtol = ATTN_TOL[dtype]
        allow = atol + rtol * w.abs()
        text = f"atol {atol}, rtol {rtol}"
    else:
        rel, frac = K10_BF16_GATE
        atol = frac * w.square().mean().sqrt().item()
        allow = rel * w.abs() + atol
        text = f"2^-7 |ref| + {atol:.3g}"
    ratio = diff / allow
    at = int(ratio.argmax())
    return (diff.max().item(), allow.flatten()[at].item(),
            ratio.flatten()[at].item(), text)


def flex_yardstick(torch, Sq, Sk, window, cap):
    """One PyTorch call for K10's function on rows that have a live key:
    ``flex_attention`` (compiled) with the soft-cap as ``score_mod`` and
    the causal (ends aligned) and window band as a block mask.  Timed
    only; never on the port's path."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    off = Sk - Sq

    def score_mod(s, b, h, qi, kj):
        return torch.tanh(s / cap) * cap

    def mask_mod(b, h, qi, kj):
        live = kj <= qi + off
        if window:
            live = live & (qi + off - kj < window)
        return live
    block = create_block_mask(mask_mod, None, None, Sq, Sk, device="cuda")
    torch._dynamo.reset()
    fn = torch.compile(flex_attention)
    return lambda q, k, v: fn(q, k, v, score_mod=score_mod,
                              block_mask=block, enable_gqa=True)


def phase_k9(torch, ref, rms):
    """K9 against its plain version at RMS_CASES, rerun bit for bit;
    returns per case (err, tol, kernel, plain, library, bound ms)."""
    F = torch.nn.functional
    gen = torch.Generator("cuda").manual_seed(3)
    out = {}
    log(f"[k9] {'rows x d':<12} {'dtype':<9} {'max_abs_err':<11} "
        f"{'tol':<10} {'kernel_ms':<10} {'device_ms':<12} {'plain_ms':<10} "
        f"{'library_ms':<10} {'lib_dev_ms':<12} bound_ms")
    for rows, d, dt in RMS_CASES:
        tdt = getattr(torch, dt)
        itemsize = 2 if dt == "bfloat16" else 4
        nbytes = 2 * rows * d * itemsize + 4 * d
        copies = max(2, min(64, math.ceil(256e6 / nbytes)))
        sets = [(torch.randn((rows, d), generator=gen, device="cuda").to(tdt),
                 torch.randn((d,), generator=gen, device="cuda") * 0.1 + 1.0)
                for _ in range(copies)]
        got = rms.rmsnorm_cuda(*sets[0])
        want = ref.rmsnorm_ref(*sets[0])
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = (BF16_TOL if dt == "bfloat16" else F32_TOL) * \
            want.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"K9 ({rows}, {d}) {dt}: max_abs_err {err} "
                                 f"> tol {tol}")
        if not torch.equal(got, rms.rmsnorm_cuda(*sets[0])):
            raise AssertionError(f"K9 ({rows}, {d}) {dt} gave different bits "
                                 "on a rerun")
        k_ms = time_ms(torch, rms.rmsnorm_cuda, sets)
        k_dev, _ = device_ms(torch, rms.rmsnorm_cuda, sets)
        p_ms = time_ms(torch, ref.rmsnorm_ref, sets, iters=20)
        lib_sets = [(x, (d,), s.to(tdt)) for x, s in sets]
        l_ms = time_ms(torch, F.rms_norm, lib_sets)
        l_dev, _ = device_ms(torch, F.rms_norm, lib_sets)
        b_ms, by = roof_ms(nbytes, 4.0 * rows * d)
        plan = getattr(rms, "rms_plan", None)   # a parent may not have it
        geo = f" {tuple(plan(rows, d, itemsize))}" if plan else ""
        log(f"[k9] {rows:>5}x{d:<6} {dt:<9} {err:<11.4g} {tol:<10.4g} "
            f"{k_ms:<10.5f} {fmt_ms(k_dev):<12} {p_ms:<10.5f} {l_ms:<10.5f} "
            f"{fmt_ms(l_dev):<12} {b_ms:.5f} ({by}){geo}")
        out[(rows, d, dt)] = dict(err=err, tol=tol, ms=k_ms, device_ms=k_dev,
                                  plain_ms=p_ms, library_ms=l_ms,
                                  library_device_ms=l_dev, bound_ms=b_ms,
                                  bound_by=by)
        del sets, lib_sets, got, want
    log("[k9] reruns bit for bit in every case")
    return out


def phase_k10(torch, ref, flash):
    """K10 against its plain version at FLASH_CASES, rerun bit for bit;
    returns per case (err, ratio, kernel, plain, library, bound ms; f32
    also the 3xTF32 bound)."""
    F = torch.nn.functional
    out = {}
    gen = torch.Generator("cuda").manual_seed(3)
    log(f"[k10] {'case':<14} {'B H KH Sq Sk D':<26} {'window':>6} "
        f"{'cap':>4} {'max_abs_err':<11} {'kernel_ms':<10} {'device_ms':<12} "
        f"{'plain_ms':<10} {'library_ms':<10} {'lib_dev_ms':<12} bound_ms")
    names = set()
    for name, B, H, KH, Sq, Sk, D, dt, window, cap in FLASH_CASES:
        tdt = getattr(torch, dt)
        kw = dict(causal=True, window=window, softcap=cap)

        def rnd(shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(tdt)
        sets = [(rnd((B, H, Sq, D), QSCALE if cap else 1.0),
                 rnd((B, KH, Sk, D)), rnd((B, KH, Sk, D))) for _ in range(2)]
        got = flash.flash_attention_cuda(*sets[0], **kw)
        want = ref.flash_attention_ref(*sets[0], **kw)
        torch.cuda.synchronize()
        err, tol, ratio, gate = _k10_gate(torch, got, want, dt)
        if not ratio <= 1.0:
            raise AssertionError(f"K10 {name} {(B, H, KH, Sq, Sk, D)} {dt}: "
                                 f"max_abs_err {err}, {ratio:.3g} x its "
                                 f"allowance ({gate})")
        if not torch.equal(got, flash.flash_attention_cuda(*sets[0], **kw)):
            raise AssertionError(f"K10 {name} {(B, H, KH, Sq, Sk, D)} gave "
                                 "different bits on a rerun")
        big = Sq * Sk * H > 2**29
        iters = 4 if big else 20
        l_ms = l_dev = lib_err = None
        if Sq == Sk and cap and (dt == "bfloat16" or Sq == GEMMA_LONG):
            # flex_attention soft-caps; it is held to ATTN_TOL to show it
            # computes the same function, then timed (f32: at the long
            # prompt's S, the kernel table's f32 row)
            flex = flex_yardstick(torch, Sq, Sk, window, cap)
            lib_err, lib_ok = _attn_err(torch, flex(*sets[0]), want, dt)
            if not lib_ok:
                raise AssertionError(f"flex_attention {name} {Sq} differs "
                                     f"from the plain version by {lib_err}")
            l_ms = time_ms(torch, flex, sets, iters=iters, warmup=1)
            l_dev, _ = device_ms(torch, flex, sets, iters=iters, warmup=1)
            del flex
        del got, want

        def kern(q, k, v):
            return flash.flash_attention_cuda(q, k, v, **kw)
        k_ms = time_ms(torch, kern, sets, iters=iters, warmup=1)
        k_dev, seen = device_ms(torch, kern, sets, iters=iters, warmup=1)
        names.update(seen)   # the kernels' names
        p_ms = time_ms(torch, lambda q, k, v: ref.flash_attention_ref(
            q, k, v, **kw), sets[:1], iters=2 if big else 5, warmup=1)
        torch.cuda.empty_cache()
        if Sq == Sk and not cap:   # the same function: no soft-cap, and
            #                        SDPA aligns causal at the top left
            mask = None
            if window:
                i = torch.arange(Sq, device="cuda")
                mask = (i[None, :] <= i[:, None]) & \
                    (i[:, None] - i[None, :] < window)
            def sdpa(q, k, v, mask=mask):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True)
            l_ms = time_ms(torch, sdpa, sets, iters=iters, warmup=1)
            l_dev, _ = device_ms(torch, sdpa, sets, iters=iters, warmup=1)
            del mask
        b_ms, by = flash_bound_ms(B, H, KH, Sq, Sk, D, dt, window)
        t3_ms = t3_by = None
        if dt == "float32":
            t3_ms, t3_by = flash_bound_ms(B, H, KH, Sq, Sk, D, dt, window,
                                          tf32x3=True)
        log(f"[k10] {name:<14} {str((B, H, KH, Sq, Sk, D)):<26} {window:>6} "
            f"{cap:>4g} {err:<11.4g} {k_ms:<10.5f} {fmt_ms(k_dev):<12} "
            f"{p_ms:<10.5f} {'-' if l_ms is None else f'{l_ms:.5f}':<10} "
            f"{'-' if l_ms is None else fmt_ms(l_dev):<12} {b_ms:.5f} ({by})"
            + ("" if t3_ms is None else
               f", 3xTF32 {t3_ms:.5f} ({t3_by})")
            + f"  [{dt}, gate {gate}: peak {ratio:.3g} of it"
            + (f"; q x {QSCALE:g}" if cap else "")
            + ("" if lib_err is None else
               f"; flex_attention vs plain {lib_err:.4g}") + "]")
        out[(name, Sq, Sk, D, dt, window)] = dict(
            err=err, tol=tol, ratio=ratio, ms=k_ms, device_ms=k_dev,
            plain_ms=p_ms, library_ms=l_ms, library_device_ms=l_dev,
            bound_ms=b_ms, bound_by=by, tf32x3_bound_ms=t3_ms)
        del sets
        torch.cuda.empty_cache()
    log("[k10] reruns bit for bit in every case (bf16 and f32); device "
        "kernels: " + ", ".join(sorted(names)))
    return out


def _worst(cases):
    return max(cases.values(),
               key=lambda r: r.get("ratio", r["err"] / r["tol"]))


def attn_json_rows(attn, k9_launches, k9_yi_launches, k9_prefill,
                   k10_launches, k10_path_diff):
    """The kernels-line rows of K9 and K10: times of the launches one
    Gemma-2 decode step makes (K9; its prefill instance: the launches of
    one Gemma-2 prefill forward of GEMMA_LONG rows, ``k9_prefill`` the K9
    launches phase 4c counted in each such call) and of the two launches
    on the long prompt's layers (K10)."""
    n9 = 33
    seen = k9_prefill.get(GEMMA_LONG, [])
    if not seen or set(seen) != {n9}:
        raise AssertionError(f"prefill calls of {GEMMA_LONG} rows launched K9 "
                             f"{seen} times, not {n9}")
    k9 = attn["K9"][(4, 4608, "bfloat16")]
    k9p = attn["K9"][(GEMMA_LONG, 4608, "bfloat16")]
    w9 = _worst(attn["K9"])
    local = attn["K10"][("gemma2 local", GEMMA_LONG, GEMMA_LONG, 128,
                         "bfloat16", 4096)]
    glob = attn["K10"][("gemma2 global", GEMMA_LONG, GEMMA_LONG, 128,
                        "bfloat16", 0)]
    pair32 = [attn["K10"][(name, GEMMA_LONG, GEMMA_LONG, 128, "float32", w)]
              for name, w in (("gemma2 local", 4096), ("gemma2 global", 0))]
    w10 = _worst(attn["K10"])

    def f32_sum(key):
        a, b = (r[key] for r in pair32)
        return None if a is None or b is None else a + b
    return [{
        "name": "rmsnorm (K9)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:20",
        "launches": k9_launches, "max_abs_err": w9["err"],
        "tolerance": w9["tol"], "ms": n9 * k9["ms"],
        "plain_ms": n9 * k9["plain_ms"], "bound_ms": n9 * k9["bound_ms"],
        "bound_by": k9["bound_by"], "library_ms": n9 * k9["library_ms"],
        "device_ms": add_ms(0.0, n9, k9["device_ms"]),
        "library_device_ms": add_ms(0.0, n9, k9["library_device_ms"]),
        "work": "one Gemma-2 (8 layers) decode step: 33 bf16 launches at "
                "4 x 4608",
        "yi_launches": k9_yi_launches,
        "prefill_launches": seen[0], "prefill_ms": n9 * k9p["ms"],
        "prefill_device_ms": add_ms(0.0, n9, k9p["device_ms"]),
        "prefill_plain_ms": n9 * k9p["plain_ms"],
        "prefill_bound_ms": n9 * k9p["bound_ms"],
        "prefill_library_ms": n9 * k9p["library_ms"],
        "prefill_library_device_ms": add_ms(0.0, n9,
                                            k9p["library_device_ms"]),
        "prefill_work": f"one Gemma-2 prefill forward of {GEMMA_LONG} tokens, "
                        f"8 layers: {seen[0]} bf16 launches at {GEMMA_LONG} x "
                        "4608, counted in phase 4c",
    }, {
        "name": "flash_attention (K10)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": k10_launches, "max_abs_err": w10["err"],
        "tolerance": w10["tol"], "ms": local["ms"] + glob["ms"],
        "plain_ms": local["plain_ms"] + glob["plain_ms"],
        "bound_ms": local["bound_ms"] + glob["bound_ms"],
        "bound_by": local["bound_by"],
        "library_ms": local["library_ms"] + glob["library_ms"],
        "device_ms": add_ms(local["device_ms"], 1, glob["device_ms"]),
        "library_device_ms": add_ms(local["library_device_ms"], 1,
                                    glob["library_device_ms"]),
        "work": f"layers 0 (window 4096) and 1 (global) of a {GEMMA_LONG}-"
                "token Gemma-2 prompt: 2 bf16 launches, soft-cap 50; "
                "library: flex_attention (compiled) with the soft-cap "
                "score_mod and the causal/window block mask",
        "path_max_abs_diff_vs_model": k10_path_diff["model"],
        "path_max_abs_err_vs_plain": k10_path_diff["plain"],
        **{f"f32_{key}": f32_sum(key) for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
            "library_device_ms")},
        "f32_bound_by": pair32[0]["bound_by"],
        "f32_tf32x3_bound_ms": f32_sum("tf32x3_bound_ms"),
        "f32_work": f"the same pair in f32 (phase 2c; 3xTF32 products): "
                    f"layers 0 (window 4096) and 1 (global) shapes at S = "
                    f"{GEMMA_LONG}, q x {QSCALE:g}, soft-cap 50; bound_ms at "
                    "the FMA rate, tf32x3_bound_ms for the three TF32 "
                    "products at the tensor cores' TF32 rate; library: "
                    "flex_attention in f32",
    }]


def _logit_diff(torch, a, b):
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


def phase_reduced(torch, configs, lm, serving, weights, arch="yi-6b",
                  **cfg_kw):
    """Reduced ``arch`` in f32 (``cfg_kw`` replaced), served on the card
    and on the CPU.  For Gemma-2 and Hymba the prompts (20-36 tokens) pass
    their window of 16, so the local layer masks in prefill and decode."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                              **cfg_kw)
    host = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                          device="cpu")
    tree = weights.params_to_numpy(host)
    params = {dev: weights.params_from_numpy(tree, cfg, dev)
              for dev in ("cuda", "cpu")}
    long_prompts = cfg.sliding_window > 0
    lens = dict(prompt_lens=(20, 28, 36)) if long_prompts else {}
    reqs = serving.poisson_requests(6, rate_rps=200.0, seed=0,
                                    vocab_size=cfg.vocab_size, **lens)
    sc = serving.ServeConfig(slots=4, max_seq=96, timing="model",
                             cache_dtype="float32")
    streams = {}
    for dev in ("cuda", "cpu"):
        eng = serving.make_serve_engine(params[dev], cfg, sc, device=dev)
        streams[dev] = {ev.request: ev.tokens for ev in eng.run(reqs)
                        if ev.kind == "complete"}
    if streams["cuda"] != streams["cpu"] or len(streams["cuda"]) != 6:
        raise AssertionError(f"{arch} token streams differ: card "
                             f"{streams['cuda']} cpu {streams['cpu']}")

    import numpy as np
    rng = np.random.default_rng(0)
    P = 24 if long_prompts else 16
    prompt = rng.integers(0, cfg.vocab_size, (2, P)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (4, 3, 1)).astype(np.int32)
    out = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            logits, sl = lm.prefill(params[dev], torch.as_tensor(
                prompt, device=dev), cfg, cache_dtype=torch.float32)
            cache = lm.init_cache(3, P + 16, cfg, dtype=torch.float32,
                                  device=dev)
            lm.cache_insert(cache, sl, 0, 0)
            lm.cache_insert(cache, sl, 2, 1)
            seq = [logits]
            for t in steps:
                logits, cache = lm.decode_step(params[dev], cache, None,
                                               torch.as_tensor(t, device=dev),
                                               cfg)
                seq.append(logits[[0, 2]])
            out[dev] = seq
    diff = max(_logit_diff(torch, a, b) for a, b in zip(out["cuda"],
                                                        out["cpu"]))
    log(f"[reduced] {arch} f32 card vs cpu: {len(streams['cuda'])} token "
        f"streams identical; prefill+decode logits max_abs_diff {diff:.3g} "
        f"(tol {SERVE_TOL})")
    if not diff <= SERVE_TOL:
        raise AssertionError(f"{arch} card vs cpu logits differ by {diff}")


def _serve(torch, eng, reqs, counters):
    """Run ``reqs`` through ``eng`` with every launch counter zeroed just
    before; check that logits stay finite.  Returns (events, launches,
    forward calls, decode step ms, peak bytes, {kernel: {prompt rows:
    its launches counted in each prefill call of that many rows}} for K1
    and K9)."""
    finite, decode_ms, pre = [], [], {"K1": {}, "K9": {}}
    prefill, decode = eng.prefill, eng.decode

    def checked_prefill(tokens):
        before = {k: counters[k].launches for k in pre}
        logits, sl, ms = prefill(tokens)
        for k, n in before.items():
            pre[k].setdefault(math.prod(tokens.shape), []).append(
                counters[k].launches - n)
        finite.append(bool(torch.isfinite(logits).all()))
        return logits, sl, ms

    def checked_decode(tokens):
        logits, ms = decode(tokens)
        finite.append(bool(torch.isfinite(logits).all()))
        decode_ms.append(ms)
        return logits, ms

    eng.prefill, eng.decode = checked_prefill, checked_decode
    torch.cuda.reset_peak_memory_stats()
    eng.prefill_calls = eng.decode_calls = 0
    for fn in counters.values():
        fn.launches = 0
    events = list(eng.run(reqs))
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    eng.prefill, eng.decode = prefill, decode
    if not all(finite):
        raise AssertionError("non-finite logits in the full-width run")
    return events, launches, eng.prefill_calls + eng.decode_calls, \
        decode_ms, peak, pre


def _report(events, n_req, eng, calls, launches, per_call, decode_ms, peak,
            card, tag):
    """Check completion and launches per forward call; log the end-to-end
    numbers."""
    import numpy as np
    done = [ev for ev in events if ev.kind == "complete"]
    ttft = [ev.ttft_ms for ev in events if ev.kind == "prefill"]
    if len(done) != n_req:
        raise AssertionError(f"{len(done)} of {n_req} requests completed")
    for key, n in per_call.items():
        if launches[key] != n * calls:
            raise AssertionError(f"{key} launches {launches[key]} != {n} x "
                                 f"{calls} forward calls")
    toks = sum(len(ev.tokens) for ev in done)
    makespan = max(ev.t_ms for ev in done)
    lat = [ev.latency_ms for ev in done]
    p = np.percentile
    log(f"[{tag}] card: {card}")
    log(f"[{tag}] {n_req}/{n_req} requests, {toks} tokens, "
        f"{eng.prefill_calls} prefill calls + {eng.decode_calls} decode "
        "steps, launches " + ", ".join(
            f"{k} {launches[k]} = {n} x {calls}" for k, n in per_call.items()))
    log(f"[{tag}] TTFT p50 {p(ttft, 50):.3f} ms p99 {p(ttft, 99):.3f} ms | "
        f"latency p50 {p(lat, 50):.3f} ms p99 {p(lat, 99):.3f} ms | "
        f"{toks / makespan * 1e3:.2f} tok/s over {makespan:.1f} ms")
    log(f"[{tag}] decode step mean {np.mean(decode_ms):.3f} ms p50 "
        f"{p(decode_ms, 50):.3f} ms | max_memory_allocated "
        f"{peak / 1e9:.2f} GB ({card})")


def phase_slice(torch, configs, lm, serving, counters, card):
    """Full-width Yi-6B: 8 Poisson requests, measured timing; 224 K1 and
    65 K9 launches per forward call."""
    import numpy as np
    cfg = configs.get_config("yi-6b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    eng = serving.make_serve_engine(params, cfg, serving.ServeConfig(
        slots=4, max_seq=128), device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] yi-6b full width ({cfg.param_count() / 1e9:.3f} B params "
        f"f32 + bf16 compute copy) ready in {time.perf_counter() - t0:.1f} s")
    eng.generate(np.zeros((1, 8), np.int32), 2)   # warm-up: CUDA/cuBLAS init
    reqs = serving.poisson_requests(8, rate_rps=50, seed=0,
                                    vocab_size=cfg.vocab_size)
    events, launches, calls, decode_ms, peak, pre = _serve(
        torch, eng, reqs, counters)
    L = cfg.num_layers             # 32: 224 K1 and 65 K9 a forward
    _report(events, 8, eng, calls, launches,
            {"K1": dense_per_layer(cfg) * L, "K9": norms_per_layer(cfg) * L
             + 1}, decode_ms, peak, card, "slice")
    return launches, pre["K1"]


def phase_gemma(torch, configs, serving, counters, card, layers=8):
    """The slice: Gemma-2-27B at full width, ``layers`` deep (the config's
    local/global pattern), 4 Poisson requests with one prompt of 5000
    tokens; then K10 on layers 0 and 1 of that prompt against the model's
    own attention and its plain version.  Returns (serving launches, K1
    launches per prefill call by prompt rows, K10 launches, K10's max
    difference from each)."""
    import numpy as np
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models import attention, blocks, layers as nn, lm
    cfg = dataclasses.replace(configs.get_config("gemma2-27b"),
                              num_layers=layers)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    eng = serving.make_serve_engine(params, cfg, serving.ServeConfig(
        slots=4, max_seq=GEMMA_LONG + 120), device="cuda")
    torch.cuda.synchronize()
    log(f"[gemma] gemma2-27b full width, {layers} of 46 layers "
        f"({n_params} params f32 + bf16 compute copy), windows "
        f"{blocks.layer_windows(cfg)}, ready in "
        f"{time.perf_counter() - t0:.1f} s")
    eng.generate(np.zeros((1, 8), np.int32), 2)   # warm-up
    reqs = serving.poisson_requests(4, rate_rps=20, seed=0,
                                    prompt_lens=(16, 32, 64), gen_lens=(8,),
                                    gen_probs=(1.0,),
                                    vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(1)
    reqs[0].tokens = rng.integers(0, cfg.vocab_size, GEMMA_LONG,
                                  dtype=np.int32)
    events, launches, calls, decode_ms, peak, pre = _serve(
        torch, eng, reqs, counters)
    _report(events, 4, eng, calls, launches,
            {"K1": dense_per_layer(cfg) * layers,
             "K9": norms_per_layer(cfg) * layers + 1}, decode_ms, peak, card,
            "gemma")
    long_pre = next(ev.prefill_ms for ev in events
                    if ev.kind == "prefill" and ev.request == 0)
    log(f"[gemma] the {GEMMA_LONG}-token prompt: prefill {long_pre:.3f} ms; "
        f"its decode steps read past the local window "
        f"({cfg.sliding_window})")

    # K10 on the long prompt's layer-0 (local) and layer-1 (global) q, k, v:
    # against the model's attention (which rounds p to bf16) at ATTN_TOL,
    # and against its plain version on the same q, k, v at its own gate
    from repro_torch.kernels import ref
    flash = counters["K10"]
    worst, k10_launches = {"model": 0.0, "plain": 0.0}, 0
    with torch.inference_mode():
        p = eng.params
        toks = torch.as_tensor(reqs[0].tokens[None], device="cuda")
        x = nn.embed(p["embed"], toks).to(torch.bfloat16)
        pos = torch.arange(GEMMA_LONG, device="cuda")[None]
        for i, win in enumerate(blocks.layer_windows(cfg)[:2]):
            lp = lm.layer_params(p["layers"], i)
            h = nn.rms_norm(lp["ln1"], x, cfg.norm_eps)
            q, k, v = attention.project_qkv(lp["attn"], h, pos, cfg)
            model = attention.chunked_attention(
                q, k, v, causal=True, window=win,
                attn_softcap=cfg.attn_softcap)
            flash.launches = 0
            got = ops.flash_attention(q, k, v, causal=True, window=win,
                                      softcap=cfg.attn_softcap)
            torch.cuda.synchronize()
            k10_launches += flash.launches
            if flash.launches != 1:
                raise AssertionError(f"K10 launched {flash.launches} times "
                                     "for one ops.flash_attention call")
            err, ok = _attn_err(torch, got, model, "bfloat16")
            kind = "global" if win == blocks.GLOBAL_WINDOW else "local"
            log(f"[gemma] layer {i} ({kind}"
                f", window {win}): K10 vs the model's attention max_abs_diff "
                f"{err:.4g} (atol {ATTN_TOL['bfloat16'][0]}, rtol "
                f"{ATTN_TOL['bfloat16'][1]})")
            if not ok:
                raise AssertionError(f"K10 differs from the model's attention"
                                     f" on layer {i} by {err}")
            plain = ref.flash_attention_ref(
                *(t.transpose(1, 2) for t in (q, k, v)), causal=True,
                window=win, softcap=cfg.attn_softcap).transpose(1, 2)
            p_err, _, ratio, gate = _k10_gate(torch, got, plain, "bfloat16")
            log(f"[gemma] layer {i}: K10 vs its plain version on the same "
                f"q, k, v max_abs_err {p_err:.4g} (gate {gate}: peak "
                f"{ratio:.3g} of it)")
            if not ratio <= 1.0:
                raise AssertionError(f"K10 differs from its plain version on"
                                     f" layer {i} by {p_err}")
            worst["model"] = max(worst["model"], err)
            worst["plain"] = max(worst["plain"], p_err)
            x, _, _ = blocks.block_forward(lp, x, pos, cfg, window=win)
            del q, k, v, model, got, plain
    return launches, pre, k10_launches, worst


def check_plans(dense_mod, arch, rows):
    """Raise unless every row count in ``rows`` takes, at each of the
    arch's widths, the block rows, splits and depth of a row count that
    phase 2 held against the plain version (K1_MODEL_ROWS)."""
    def plan(M, K, N):
        return (dense_mod.bf16_rows(M),) + dense_mod.bf16_splits(M, N, K)
    widths = {(K, N) for _, K, N in DECODE_SHAPES[arch]}
    unchecked = sorted((M, K, N) for M in rows for K, N in widths
                       if plan(M, K, N) not in {
                           plan(m, K, N) for m in K1_MODEL_ROWS[arch]})
    if unchecked:
        raise AssertionError(f"{arch}: the serving run sent K1 (M, K, N) "
                             f"{unchecked}, whose plans phase 2 did not "
                             "hold against the plain version")


def prefill_launches(dense_mod, k1_sums, arch, pre_k1):
    """Phase 2's prefill sum for ``arch`` with ``launches`` the K1 launches
    that phase 4, 4c or 4g counted in its prefill calls of
    PREFILL_ROWS[arch] rows; raises unless every such call launched K1 as
    often as the sum adds shapes, and unless every row count that the
    serving run's prefill calls sent K1 passes ``check_plans``."""
    check_plans(dense_mod, arch, pre_k1)
    st = dict(k1_sums[(arch, "prefill")])
    M = PREFILL_ROWS[arch]
    seen = pre_k1.get(M, [])
    if not seen or set(seen) != {st["launches"]}:
        raise AssertionError(f"{arch}: prefill calls of {M} rows launched K1 "
                             f"{seen} times; phase 2's sum adds "
                             f"{st['launches']} launches")
    log(f"[k1] {arch}: {len(seen)} prefill call(s) of {M} rows in the "
        f"serving run, each {seen[0]} K1 launches (counted); every prefill"
        f" row count it sent, {sorted(pre_k1)}, runs the plan of one that "
        "phase 2 checked")
    st["launches"] = seen[0]
    return st


# ----------------------------------------------------------------------
# The LM's training path: K2/K3 in bf16, K9's backward, loss_fn, the
# local step at full width and the training CLI
# ----------------------------------------------------------------------
LM_BWD_SHAPES = {                  # one layer's projections: (name, Din, Dout)
    "phi3-mini-3.8b": (("wq", 3072, 3072), ("wk", 3072, 3072),
                       ("wv", 3072, 3072), ("wo", 3072, 3072),
                       ("wg", 3072, 8192), ("wi", 3072, 8192),
                       ("mlp_wo", 8192, 3072)),
    "yi-6b": DECODE_SHAPES["yi-6b"],
    # phase 4h's attention projections (the experts are library einsums)
    "granite-moe-3b-a800m": (("wq", 1536, 1536), ("wk", 1536, 512),
                             ("wv", 1536, 512), ("wo", 1536, 1536)),
    # phase 4k: K2 and K3 of in_proj (6457 columns) take the mma.sync tile
    # route, the others the TMA + wgmma GEMM (dense.bwd_bf16_plan)
    "hymba-1.5b": DECODE_SHAPES["hymba-1.5b"],
}
LM_ROWS = 1024                     # B 8 x S 128, a training step's rows
LM_BATCH, LM_SEQ = 8, 128
LM_BWD_RAGGED = (                  # (M, Din, Dout, relu): ragged M, the
    (24, 4096, 4096, True), (1000, 3072, 3072, True),   # relu mask, shapes
    (1000, 3072, 8192, False), (37, 100, 77, True),     # off 8 (element-
    (5, 13, 9, False))                                  # by-element loads)
LM_BWD_EDGES = (                   # (M, Din, Dout), no mask, widths off 8's
    (1000, 3000, 3080), (24, 1000, 200),  # multiples: K2 and K3 each take
    (1000, 8200, 1000), (24, 3000, 3000))  # every tile width with a ragged
#                                   last tile (tests/test_torch_dense_plan.py)
RMS_BWD_CASES = [(LM_ROWS, d, dt) for d in (3072, 4096, 4608)
                 for dt in ("bfloat16", "float32")]
RMS_BWD_CASES += [(LM_ROWS, 1536, "bfloat16"),      # Granite-MoE's norms
                  (LM_ROWS, 1600, "bfloat16"),      # Hymba's (phase 4k)
                  (32768, 128, "bfloat16"),          # Qwen3's q/k norms at
                  (4096, 128, "bfloat16")]           # B 8 x S 128 (gated)
RMS_BWD_CASES += [(1000, 4608, "bfloat16"), (133, 3072, "bfloat16"),
                  (37, 1000, "float32"), (3, 13, "bfloat16")]   # ragged
LM_ARCH = "phi3-mini-3.8b"         # phases 4e and 4f(b), at full width
LM_LAYERS = 8                      # phase 4e's depth
LM_OUTER_LAYERS = 2                # phase 4f(b)'s depth, 4 nodes
LM_STEPS = 10
HELD_EVERY = 10                    # 4e/4h: the held-out batch's readings
LM_LR = 1e-3                       # the training CLI's default
LM_TOL = {"float32": (2e-5, 2e-5, 1e-4),      # loss, grads atol, rtol
          "bfloat16": (5e-3, 3e-2, 3e-2)}
LM_KERNEL_NAMES = (   # device kernel name -> the port's kernel (bf16 path)
    ("dense_fwd_bf16", "K1"), ("dense_bwd_wgmma<true", "K2"),
    ("dense_bwd_wgmma<false", "K3"), ("dense_db_colsum", "K3"),
    ("dense_bwd_bf16_tile<true", "K2 tile"),
    ("dense_bwd_bf16_tile<false", "K3 tile"), ("rmsnorm_bwd", "K9 bwd"),
    ("rmsnorm_", "K9"), ("dense_fwd_f32", "K1 f32"),
    ("dense_dx_", "K2 f32"), ("dense_dwdb_", "K3 f32"))
CUBLAS_NAMES = ("gemm", "nvjet", "cutlass", "xmma")   # the head's matmul


def layer_projections(cfg) -> list:
    """(name, Din, Dout) of every ``layers.dense`` a layer's forward
    calls, from the block's layout (``models/blocks.py``): the attention's
    q, k, v, o (every block but ssm), the mixer's in- and out-projections
    (ssm, hybrid) and the gated MLP's three (every block with d_ff but
    ssm and moe, whose experts are library einsums)."""
    d, t = cfg.d_model, cfg.arch_type
    out = []
    if t != "ssm":
        q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        out += [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d)]
    if t in ("ssm", "hybrid"):
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        out += [("in_proj", d, 2 * di + 2 * N + H), ("out_proj", di, d)]
    if t not in ("ssm", "moe") and cfg.d_ff > 0:
        out += [("wg", d, cfg.d_ff), ("wi", d, cfg.d_ff),
                ("mlp_wo", cfg.d_ff, d)]
    return out


def dense_per_layer(cfg) -> int:
    """K1 launches a layer's forward makes."""
    return len(layer_projections(cfg))


def norms_per_layer(cfg) -> int:
    """K9 launches a layer's forward makes: ln1; ln2 where the block has
    an MLP or moe; the hybrid's bn_attn and bn_ssm; Qwen3's q and k norms;
    Gemma-2's post-norms."""
    t = cfg.arch_type
    ln2 = t == "moe" or (t != "ssm" and cfg.d_ff > 0)
    return (1 + ln2 + 2 * (t == "hybrid") + 2 * bool(cfg.qk_norm)
            + bool(cfg.post_norm) * (1 + ln2))


def lm_step_launches(L: int, per_layer: int = 7, norms: int = 2) -> dict:
    """K1-K3 and K9 launches of one LM training step at depth L (remat
    off): ``per_layer`` projections a layer forward (K1) and backward (K2,
    K3), and ``norms`` L + 1 norms forward (K9) and backward."""
    n = per_layer * L
    return {"K1": n, "K2": n, "K3": n, "K9": norms * L + 1,
            "K9 bwd": norms * L + 1}


def bwd_routes(dn, cfg, M=LM_ROWS) -> dict:
    """{(kernel, route): launches a layer} of K2 and K3 in bf16 over the
    layer's projections, as ``dense.bwd_bf16_plan`` routes them."""
    out = {}
    for key in ("K2", "K3"):
        for _, Din, Dout in layer_projections(cfg):
            route = dn.bwd_bf16_plan(key, M, Din, Dout).route
            out[(key, route)] = out.get((key, route), 0) + 1
    return out


def _lm_counts(mods):
    dn, rms = mods["dense"], mods["rmsnorm"]
    return {"K1": dn.dense_cuda.launches, "K2": dn.dense_dx_cuda.launches,
            "K3": dn.dense_dwdb_cuda.launches,
            "K9": rms.rmsnorm_cuda.launches,
            "K9 bwd": rms.rmsnorm_bwd_cuda.launches}


def _zero_lm_counts(mods):
    dn, rms = mods["dense"], mods["rmsnorm"]
    for fn in (dn.dense_cuda, dn.dense_dx_cuda, dn.dense_dwdb_cuda,
               rms.rmsnorm_cuda, rms.rmsnorm_bwd_cuda):
        fn.launches = 0


def _grad_gate(torch, got, want, one_rounding):
    """(max_abs_err, tol): one bf16 rounding (BF16_TOL x max|ref|), or
    the f32 gradient gate (GRAD_TOL x max(max|ref|, 1))."""
    got, want = _flat(torch, got).float(), _flat(torch, want).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return err, (BF16_TOL * scale if one_rounding
                 else GRAD_TOL * max(scale, 1.0))


def _new_row():
    return {"err": 0.0, "tol": 0.0, "ratio": -1.0, "ms": 0.0,
            "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "library_device_ms": 0.0, "bound_ms": 0.0, "bound_by": {}}


def _note_err(row, err, tol):
    ratio = err / tol if tol > 0 else 0.0
    if ratio > row["ratio"]:
        row.update(err=err, tol=tol, ratio=ratio)


def _time_case(torch, row, n, kern, plain, lib, sets, lib_sets, nbytes,
               flops, dtype, iters=50):
    """Time one case (kernel, plain, library; CUDA events and the
    device's clock, ``iters`` calls each) and add n launches of it to
    ``row``'s sums; returns the per-launch numbers."""
    k_ms = time_ms(torch, kern, sets, iters=iters)
    k_dev, _ = device_ms(torch, kern, sets, iters=iters)
    p_ms = time_ms(torch, plain, sets, iters=min(20, iters))
    l_ms = time_ms(torch, lib, lib_sets, iters=iters)
    l_dev, _ = device_ms(torch, lib, lib_sets, iters=iters)
    b_ms, by = roof_ms(nbytes, flops, dtype)
    t = k_ms, k_dev, p_ms, l_ms, l_dev, b_ms, by
    _add_case(row, n, t)
    return t


def _add_case(row, n, t):
    """Add n launches of a case timed as ``_time_case`` returns it to
    ``row``'s sums."""
    k_ms, k_dev, p_ms, l_ms, l_dev, b_ms, by = t
    row["ms"] += n * k_ms
    row["device_ms"] = add_ms(row["device_ms"], n, k_dev)
    row["plain_ms"] += n * p_ms
    row["library_ms"] += n * l_ms
    row["library_device_ms"] = add_ms(row["library_device_ms"], n, l_dev)
    row["bound_ms"] += n * b_ms
    row["bound_by"][by] = row["bound_by"].get(by, 0.0) + n * b_ms


def _dense_bwd_case(torch, gen, key, M, Din, Dout, relu):
    """Random bf16 operands of K1 (x, w), K2 (g, w, out) or K3 (x, g,
    out)."""
    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()
    out = torch.relu(rnd((M, Dout))) if relu else None
    if key == "K1":
        return rnd((M, Din)), rnd((Din, Dout), Din ** -0.5)
    if key == "K2":
        return rnd((M, Dout)), rnd((Din, Dout), Din ** -0.5), out
    return rnd((M, Din)), rnd((M, Dout)), out


def _bwd_route(dn, key, M, Din, Dout, relu):
    """Which bf16 route K2 or K3 takes at this shape, as printed ("" in a
    checkout whose dense module has no route plan)."""
    if not hasattr(dn, "bwd_bf16_plan"):
        return ""
    p = dn.bwd_bf16_plan(key, M, Din, Dout, relu)
    return (f"{p.route} {p.bm}x{p.bn} tiles, {p.stages} stages, "
            f"{p.tiles} tiles on {p.grid} blocks")


def _check_dense_bwd(torch, dn, ref, key, args, where):
    """K2's dx within one bf16 rounding, or K3's f32 dw and db at the
    gradient gate and (where the checkout writes dw in bf16) its bf16 dw
    the f32 dw's ``.to(torch.bfloat16)`` bit for bit; every output again
    bit for bit on a rerun.  Returns the worst (err, tol)."""
    kern = dn.dense_dx_cuda if key == "K2" else dn.dense_dwdb_cuda
    plain = ref.dense_dx_ref if key == "K2" else ref.dense_dwdb_ref
    got = kern(*args)
    err, tol = _grad_gate(torch, got, plain(*args), key == "K2")
    if not err <= tol:
        raise AssertionError(f"{key} bf16 {where}: max_abs_err {err} > "
                             f"tol {tol}")
    if not torch.equal(_flat(torch, got), _flat(torch, kern(*args))):
        raise AssertionError(f"{key} bf16 {where} gave different bits on a "
                             "rerun")
    if key == "K3" and hasattr(dn, "bwd_bf16_plan"):
        dw16, db = kern(*args, dw_dtype=torch.bfloat16, want_db=False)
        again, _ = kern(*args, dw_dtype=torch.bfloat16, want_db=False)
        if db is not None or not torch.equal(dw16, got[0].bfloat16()) \
                or not torch.equal(dw16, again):
            raise AssertionError(f"K3 bf16 {where}: the bf16 dw is not the "
                                 "f32 dw cast bit for bit on every run (or "
                                 "db came back unasked)")
    return err, tol


def phase_lm_kernels(torch, ref, dn, rms, only=None):
    """Phase 2d: K1, K2 and K3 in bf16 at every Phi-3-mini and Yi-6B
    projection shape at M = 1024 (B 8 x S 128; K1 without bias, as the LM
    calls it), K2 and K3 also at ragged M, with the relu mask, off 8, and
    at widths off every tile the route plan can choose (each case prints
    its route), and K9's backward at d = 3072, 4096, 4608 (1024 rows and
    ragged), bf16 and f32, against their plain versions; every case
    reruns bit for bit.  K2 and K3 are timed as the LM calls them (K3: dw
    in bf16, no db, where the checkout's K3 takes ``dw_dtype``).
    ``only``: the kernels to run (K1, K2, K3, K9), all if None.  Returns
    per kernel its row, summed over one phase-4e step (Phi-3-mini,
    LM_LAYERS layers), and under (family, kernel) over one step of each
    of TRAIN_FAMILIES (Granite-MoE's phase 4h, Hymba's phase 4k) and of
    ``mm_train_launches``' (InternVL2's 4m and Seamless's 4n, whose
    shapes run at their own rows, LM_BWD_ROWS)."""
    gen = torch.Generator("cuda").manual_seed(4)
    new = hasattr(dn, "bwd_bf16_plan")   # K3 writes bf16 dw, db if asked
    lm_k3 = (lambda x, g, out: dn.dense_dwdb_cuda(
        x, g, out, dw_dtype=torch.bfloat16, want_db=False)[0]) if new \
        else dn.dense_dwdb_cuda
    kern = {"K1": dn.dense_cuda, "K2": dn.dense_dx_cuda, "K3": lm_k3}
    plain = {"K1": ref.dense_ref, "K2": ref.dense_dx_ref,
             "K3": (lambda x, g, out: ref.dense_dwdb_ref(
                 x, g, out, dw_dtype=torch.bfloat16, want_db=False)[0])
             if new else ref.dense_dwdb_ref}
    lib = {"K1": torch.matmul,
           "K2": lambda g, w, out: torch.matmul(g, w.t()),
           "K3": (lambda x, g, out: torch.matmul(x.t(), g)) if new else
           (lambda x, g, out: (torch.matmul(x.t(), g), g.sum(0)))}
    rows, cases = {}, {}
    log(f"[lm-k] {'kernel':<6} {'model':<15} {'M x Din x Dout':<18} "
        f"{'max_abs_err':<11} {'tol':<10} {'kernel_ms':<10} "
        f"{'device_ms':<12} {'plain_ms':<10} {'library_ms':<10} "
        f"{'lib_dev_ms':<12} bound_ms")
    for key in ("K1", "K2", "K3"):
        if only is not None and key not in only:
            continue
        row = _new_row()
        fam = {f: _new_row() for f in TRAIN_FAMILIES}
        for arch, shapes in LM_BWD_SHAPES.items():
            unique = {}
            for name, Din, Dout in shapes:
                unique.setdefault((Din, Dout), []).append(name)
            todo = [(M, Din, Dout, which)
                    for (Din, Dout), which in unique.items()
                    for M in LM_BWD_ROWS.get(arch, (LM_ROWS,))]
            for M, Din, Dout, which in todo:
                args = _dense_bwd_case(torch, gen, key, M, Din, Dout, False)
                where = f"({M}, {Din}, {Dout})"
                if key == "K1":
                    err, tol = _grad_gate(torch, kern[key](*args),
                                          plain[key](*args), True)
                    if not err <= tol:
                        raise AssertionError(f"K1 bf16 {where}: "
                                             f"max_abs_err {err} > tol {tol}")
                    a = _flat(torch, kern[key](*args))
                    if not torch.equal(a, _flat(torch, kern[key](*args))):
                        raise AssertionError(f"K1 bf16 {where} gave "
                                             "different bits on a rerun")
                else:
                    err, tol = _check_dense_bwd(torch, dn, ref, key, args,
                                                where)
                    # TMA's row stride wants widths of 8's multiples; the
                    # others take the mma.sync tile GEMM
                    want = "wgmma" if Din % 8 == 0 and Dout % 8 == 0 \
                        else "tile"
                    if new and dn.bwd_bf16_plan(key, M, Din,
                                                Dout).route != want:
                        raise AssertionError(f"{key} bf16 {where}: an LM "
                                             f"projection off the {want} "
                                             "route")
                _note_err(row, err, tol)
                wbytes = 2 * Din * Dout
                copies = max(2, min(16, math.ceil(256e6 / wbytes)))
                sets = [args] + [_dense_bwd_case(torch, gen, key, M, Din,
                                                 Dout, False)
                                 for _ in range(copies - 1)]
                if key != "K3" or new:   # bf16 in, bf16 out
                    nbytes = 2 * (M * Dout + Din * Dout + M * Din)
                    flops = 2.0 * M * Din * Dout
                else:                    # f32 dw and its db row
                    nbytes = 2 * (M * Din + M * Dout) + 4 * (Din + 1) * Dout
                    flops = 2.0 * M * (Din + 1) * Dout
                n = LM_LAYERS * len(which) if arch == LM_ARCH else 0
                # the large rows of 4m and 4n: 10 calls, within the
                # script's time
                t = _time_case(torch, row, n, kern[key], plain[key],
                               lib[key], sets, sets, nbytes, flops,
                               "bfloat16",
                               10 if arch in LM_BWD_ROWS else 50)
                cases[(key, M, Din, Dout)] = dict(err=err, tol=tol, t=t)
                for f, (farch, fL, *_) in TRAIN_FAMILIES.items():
                    if arch == farch:
                        _note_err(fam[f], err, tol)
                        _add_case(fam[f], fL * len(which), t)
                log(f"[lm-k] {key:<6} {arch:<15} "
                    f"{f'{M}x{Din}x{Dout}':<18} {err:<11.4g} {tol:<10.4g} "
                    f"{t[0]:<10.5f} {fmt_ms(t[1]):<12} {t[2]:<10.5f} "
                    f"{t[3]:<10.5f} {fmt_ms(t[4]):<12} {t[5]:.5f} ({t[6]})"
                    f"  x{len(which)} a layer" + (
                        f", S={dn.bf16_splits(M, Dout, Din)[0]}"
                        if key == "K1" else
                        f", {_bwd_route(dn, key, M, Din, Dout, False)}"))
                del sets, args
        extra = () if key == "K1" else LM_BWD_RAGGED + tuple(
            (M, Din, Dout, False) for M, Din, Dout in LM_BWD_EDGES)
        for M, Din, Dout, relu in extra:
            args = _dense_bwd_case(torch, gen, key, M, Din, Dout, relu)
            where = f"ragged ({M}, {Din}, {Dout}{', relu' if relu else ''})"
            err, tol = _check_dense_bwd(torch, dn, ref, key, args, where)
            log(f"[lm-k] {key:<6} {where}: max_abs_err {err:.4g} tol "
                f"{tol:.4g}; {_bwd_route(dn, key, M, Din, Dout, relu)}")
            _note_err(row, err, tol)
        log(f"[lm-k] {key} bf16 reruns bit for bit in every case; one "
            f"{LM_ARCH} step at {LM_LAYERS} layers ({7 * LM_LAYERS} "
            f"launches): kernel {row['ms']:.5f} ms (device "
            f"{fmt_ms(row['device_ms'])}), plain {row['plain_ms']:.5f}, "
            f"torch.matmul {row['library_ms']:.5f} (device "
            f"{fmt_ms(row['library_device_ms'])}), bound "
            f"{row['bound_ms']:.5f} ({dominant(row['bound_by'])}); worst "
            f"max_abs_err {row['err']:.4g} at tol {row['tol']:.4g}")
        if row["device_ms"] and row["library_device_ms"]:
            log(f"[lm-k] {key} bf16 step: {row['device_ms']:.5f} device ms,"
                f" {row['bound_ms'] / row['device_ms']:.1%} of the bound, "
                f"{row['device_ms'] / row['library_device_ms']:.3f}x "
                "torch.matmul's device time")
        for f, (farch, fL, *_) in TRAIN_FAMILIES.items():
            r = fam[f]
            if r["bound_ms"]:
                log(f"[lm-k] {key} bf16, one {farch} step at {fL} layers "
                    f"({fL * len(LM_BWD_SHAPES[farch])} launches): kernel "
                    f"{r['ms']:.5f} ms (device {fmt_ms(r['device_ms'])}), "
                    f"torch.matmul {r['library_ms']:.5f} (device "
                    f"{fmt_ms(r['library_device_ms'])}), bound "
                    f"{r['bound_ms']:.5f}")
            rows[(f, key)] = r
        for f, launches in mm_train_launches().items():
            r = rows[(f, key)] = case_sum(cases, key, launches[key])
            log(f"[lm-k] {key} bf16, one {f} step of phase "
                f"{MM_TRAIN_PHASE[f]} ({sum(launches[key].values())} "
                f"launches): kernel {r['ms']:.5f} ms (device "
                f"{fmt_ms(r['device_ms'])}), torch.matmul "
                f"{r['library_ms']:.5f} (device "
                f"{fmt_ms(r['library_device_ms'])}), bound "
                f"{r['bound_ms']:.5f}")
        rows[key] = row
    if only is not None and "K9" not in only:
        torch.cuda.empty_cache()
        return rows

    F = torch.nn.functional
    row = _new_row()
    fam = {f: _new_row() for f in TRAIN_FAMILIES}
    for rows_n, d, dt in RMS_BWD_CASES:
        tdt = getattr(torch, dt)
        itemsize = 2 if dt == "bfloat16" else 4

        def case():
            return (torch.randn((rows_n, d), generator=gen,
                                device="cuda").to(tdt),
                    torch.randn((d,), generator=gen, device="cuda") * 0.1
                    + 1.0,
                    torch.randn((rows_n, d), generator=gen,
                                device="cuda").to(tdt))
        args = case()
        dx, ds = rms.rmsnorm_bwd_cuda(*args)
        want_dx, want_ds = ref.rmsnorm_bwd_ref(*args)
        e1, t1 = _grad_gate(torch, dx, want_dx, dt == "bfloat16")
        e2, t2 = _grad_gate(torch, ds, want_ds, False)
        if not (e1 <= t1 and e2 <= t2):
            raise AssertionError(f"K9 bwd ({rows_n}, {d}) {dt}: dx {e1} "
                                 f"(tol {t1}), dscale {e2} (tol {t2})")
        _note_err(row, e1, t1)
        _note_err(row, e2, t2)
        worse = (e1, t1) if e1 * t2 >= e2 * t1 else (e2, t2)
        again = rms.rmsnorm_bwd_cuda(*args)
        if not (torch.equal(dx, again[0]) and torch.equal(ds, again[1])):
            raise AssertionError(f"K9 bwd ({rows_n}, {d}) {dt} gave "
                                 "different bits on a rerun")
        geo = tuple(rms.bwd_plan(rows_n, d, itemsize))
        # the ragged cases, and Qwen3's q/k norms (no path on the card
        # trains Qwen3 at full width): the gates and the rerun only
        if rows_n < LM_ROWS or d == 128:
            log(f"[lm-k] K9 bwd gated {rows_n}x{d} {dt}: dx {e1:.4g} (tol "
                f"{t1:.4g}), dscale {e2:.4g} (tol {t2:.4g}) {geo}")
            continue
        nbytes = 3 * rows_n * d * itemsize + 8 * d
        copies = max(2, min(16, math.ceil(256e6 / nbytes)))
        sets = [args] + [case() for _ in range(copies - 1)]
        lib_sets = []
        for x, s, g in sets:
            xr = x.detach().requires_grad_()
            sr = s.to(tdt, copy=True).requires_grad_()
            lib_sets.append((F.rms_norm(xr, (d,), sr, eps=1e-6), xr, sr, g))

        def lib(out, xr, sr, g):   # the backward alone; the graph is kept
            return torch.autograd.grad(out, (xr, sr), g, retain_graph=True)
        n = 2 * LM_LAYERS + 1 if (d, dt) == (3072, "bfloat16") else 0
        t = _time_case(torch, row, n, rms.rmsnorm_bwd_cuda,
                       ref.rmsnorm_bwd_ref, lib, sets, lib_sets, nbytes,
                       12.0 * rows_n * d, "float32")
        if dt == "bfloat16":
            cases[("K9 bwd", rows_n, d)] = dict(err=worse[0], tol=worse[1],
                                                t=t)
        for f, (_, fL, norms, fd) in TRAIN_FAMILIES.items():
            if (d, dt) == (fd, "bfloat16"):     # the family's norms
                _note_err(fam[f], e1, t1)
                _note_err(fam[f], e2, t2)
                _add_case(fam[f], norms * fL + 1, t)
        log(f"[lm-k] K9 bwd {f'{rows_n}x{d}':<12} {dt:<9} dx {e1:<10.4g} "
            f"(tol {t1:<9.4g}) dscale {e2:<10.4g} (tol {t2:<9.4g}) "
            f"{t[0]:<10.5f} {fmt_ms(t[1]):<12} {t[2]:<10.5f} {t[3]:<10.5f} "
            f"{fmt_ms(t[4]):<12} {t[5]:.5f} ({t[6]}) {geo}")
        del sets, lib_sets
    log(f"[lm-k] K9 bwd reruns bit for bit in every case; one {LM_ARCH} "
        f"step ({2 * LM_LAYERS + 1} launches at {LM_ROWS}x3072 bf16): "
        f"kernel {row['ms']:.5f} ms (device {fmt_ms(row['device_ms'])}), "
        f"plain {row['plain_ms']:.5f}, autograd of F.rms_norm "
        f"{row['library_ms']:.5f} (device "
        f"{fmt_ms(row['library_device_ms'])}), bound {row['bound_ms']:.5f}"
        f" ({dominant(row['bound_by'])}); worst max_abs_err "
        f"{row['err']:.4g} at tol {row['tol']:.4g}")
    rows["K9 bwd"] = row
    rows.update({(f, "K9 bwd"): r for f, r in fam.items()})
    for f, launches in mm_train_launches().items():
        rows[(f, "K9 bwd")] = case_sum(cases, "K9 bwd", launches["K9 bwd"])
    torch.cuda.empty_cache()
    return rows


def _lm_batch(np, vocab, B=2, S=12):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[0, 3] = -1
    labels[1, -2:] = -1
    return toks, labels


def phase_lm_parity(torch, port):
    """Phase 3c: reduced Yi-6B, Phi-3 and Gemma-2 in f32 and bf16:
    ``lm.loss_fn`` and every gradient leaf on the card against the port's
    CPU run from the same numpy params and batch (CE chunks of 5 over 12
    positions, labels of -1), remat off and on."""
    import numpy as np
    lm, weights, configs = port.lm, port.weights, port.configs
    for arch in ("yi-6b", "phi3-mini-3.8b", "gemma2-27b"):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.get_reduced(arch),
                                      dtype=dtype, ce_chunk=5)
            tree = weights.params_to_numpy(lm.init_params(
                cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
            toks, labels = _lm_batch(np, cfg.vocab_size)
            out = {}
            for remat in (False, True):
                for dev in ("cuda", "cpu"):
                    params = weights.params_from_numpy(tree, cfg, dev)
                    batch = {"tokens": torch.as_tensor(toks, device=dev),
                             "labels": torch.as_tensor(labels, device=dev)}
                    (loss, _), grads = port.trainer.value_and_grad(
                        lambda p, b: lm.loss_fn(p, b, cfg, remat=remat),
                        params, batch)
                    out[(dev, remat)] = (
                        float(loss), [g.float().cpu() for g in
                                      port.tree.tree_leaves(grads)])
            tl, atol, rtol = LM_TOL[dtype]
            worst = 0.0
            for remat in (False, True):
                (cl, cg), (hl, hg) = out[("cuda", remat)], out[("cpu", remat)]
                if not abs(cl - hl) <= tl * max(1.0, abs(hl)):
                    raise AssertionError(f"[lm-parity] {arch} {dtype} remat="
                                         f"{remat}: loss {cl} vs cpu {hl}")
                for a, b in zip(cg, hg, strict=True):
                    ok = (a - b).abs() <= atol + rtol * b.abs()
                    if not bool(ok.all()):
                        raise AssertionError(
                            f"[lm-parity] {arch} {dtype} remat={remat}: a "
                            f"grad leaf differs by {(a - b).abs().max()}")
                    worst = max(worst, float((a - b).abs().max()))
            rd = max(float((a - b).abs().max()) for a, b in zip(
                out[("cuda", False)][1], out[("cuda", True)][1]))
            log(f"[lm-parity] {arch} {dtype}: loss card "
                f"{out[('cuda', False)][0]:.7f} cpu "
                f"{out[('cpu', False)][0]:.7f}; every grad leaf within atol "
                f"{atol:g} / rtol {rtol:g} (max_abs_diff {worst:.3g}), remat"
                f" on and off; card remat vs no remat max_abs_diff {rd:.3g}")


def _lm_profile(torch, port, prof):
    """``prof``'s trace of one step (or forward call): ({kernel: device
    ms}, {kernel: its launches}, busy ms)."""
    dev_ms, counts = {}, {}
    for evt in prof.key_averages():
        us = port.profile.device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA \
                or port.profile.annotation(evt):   # a span, not a kernel
            continue
        key = _lm_kernel(evt.key)
        dev_ms[key] = dev_ms.get(key, 0.0) + us / 1e3
        counts[key] = counts.get(key, 0) + evt.count
    return dev_ms, counts, port.profile.busy_us(prof) / 1e3


def _log_profile(tag, what, wall_ms, dev_ms, counts, busy_ms):
    """One line: a traced step's wall, busy share and device ms by kernel
    (its launches in brackets), as ``_lm_profile`` reads them."""
    log(f"[{tag}] {what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f}"
        f" ms ({100 * busy_ms / wall_ms:.1f}%), kernel time "
        f"{sum(dev_ms.values()):.3f} ms: " + ", ".join(
            f"{k} {v:.4f} ({counts[k]:g})" for k, v in sorted(
                dev_ms.items(), key=lambda kv: -kv[1])))


def _log_spans(tag, what, fwd, bwd=None, family="moe layers'"):
    """One line: a family's spans (``spans``) in a traced step, forward,
    and backward where given."""
    log(f"[{tag}] {what}, the {family} spans, device ms forward"
        + (" / backward" if bwd else "") + " (the kernels launched under "
        "each span, booked by kernel above): " + ", ".join(
            f"{k} {fmt_ms(v)}" + (f" / {fmt_ms(bwd[k])}" if bwd else "")
            for k, v in fwd.items()))


def _lm_kernel(name):
    key = next((k for pat, k in LM_KERNEL_NAMES if pat in name), None)
    if key is None:
        key = "cuBLAS" if any(p in name for p in CUBLAS_NAMES) else "other"
    return key


def phase_lm_step(torch, port, mods, card, arch=LM_ARCH, layers=LM_LAYERS,
                  tag="lm-step", steps=LM_STEPS, min_fall=0.0,
                  corpus_vocab=0):
    """Phase 4e (4h: ``arch`` Granite-MoE, ``tag`` "moe-train", MOE_STEPS
    steps, MOE_MIN_FALL): Phi-3-mini at full width and LM_LAYERS layers,
    B 8 x S 128 from ``lm_corpus`` (over the first ``corpus_vocab`` token
    ids, else the whole vocabulary), AdamW, ``steps`` steps through
    ``make_node_round`` with ``lm.loss_fn``: finite losses, every grad
    leaf nonzero, exact launches a step, step wall, device time by kernel,
    busy share, tokens/s, peak memory, and the optimizer's time against
    AdamW's byte floor.  A held-out batch's objective (CE plus 0.01 x the
    moe layers' aux) must fall over the steps, and its CE by more than
    ``min_fall`` nats (each step's own loss is on a new batch); its
    objective, CE and aux are printed every HELD_EVERY steps.  A moe
    config also prints its layers' spans in the traced step
    (``moe.SPANS``, forward and backward) and the step's flop floor.  A
    config with a front end (4m: InternVL2) puts B rows of patch
    embeddings, one seeded ``random_frontend_embeds`` draw, before every
    batch's text, as ``launch/train.py`` does.  Returns (launches, step
    device ms by kernel)."""
    import numpy as np
    lm, pipeline = port.lm, port.pipeline
    cfg = dataclasses.replace(port.configs.get_config(arch),
                              num_layers=layers)
    L, B, S = layers, LM_BATCH, LM_SEQ
    expect = lm_step_launches(L, dense_per_layer(cfg), norms_per_layer(cfg))
    routes = {k: n * L for k, n in bwd_routes(mods["dense"], cfg).items()}
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    leaves = port.tree.tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    c_w = sum(p.numel() * p.element_size() for p in leaves)
    del leaves      # else the first params outlive the first step
    # ``steps`` training batches, 2 for the profile, 1 held out
    corpus_vocab = corpus_vocab or cfg.vocab_size
    corpus = port.synthetic.lm_corpus((steps + 3) * B * S + 1,
                                      corpus_vocab, seed=0)
    rows = pipeline.pack_sequences(corpus, S)
    batches = [{"rows": torch.as_tensor(rows[None, i * B:(i + 1) * B],
                                        device="cuda")}
               for i in range(steps + 3)]
    patches = port.frontends.random_frontend_embeds(
        torch.Generator("cuda").manual_seed(1), cfg, B, device="cuda")

    def loss_fn(p, b):
        hb = pipeline.host_batch(b["rows"])
        if patches is not None:
            hb["frontend_embeds"] = patches[:hb["tokens"].shape[0]]
        return lm.loss_fn(p, hb, cfg)

    def held_out(p):
        """(loss, its ce, its aux) on the held-out batch."""
        with torch.no_grad():
            loss, parts = loss_fn(p, {"rows": batches[-1]["rows"][0]})
        return float(loss), float(parts["ce"]), float(parts["aux"])
    held = [(0, held_out(params))]

    tc = port.types.TrainConfig(optimizer="adamw", learning_rate=LM_LR,
                                warmup_steps=2, total_steps=steps,
                                grad_clip=1.0, local_steps=1)
    opt = port.optim.make_optimizer(tc.optimizer)
    state = opt.init(params)
    node_round = port.trainer.make_node_round(loss_fn, tc)
    one = {k: v[0] for k, v in batches[0].items()}
    _, grads = port.trainer.value_and_grad(loss_fn, params, one)
    zero = [i for i, g in enumerate(port.tree.tree_leaves(grads))
            if not bool(g.abs().sum() > 0)]
    if zero:
        raise AssertionError(f"[{tag}] grad leaves {zero} are all zero")
    # the optimizer alone (AdamW's update and its apply) on these grads,
    # against its byte floor: read params, grads and both moments, write
    # params and both moments, 7 c_w
    def adamw():
        upd, new = opt.update(grads, state, params, 1e-4)
        return port.optim.apply_updates(params, upd), new
    o_ms = time_ms(torch, adamw, [()], iters=3, warmup=1)
    o_dev, _ = device_ms(torch, adamw, [()], iters=3, warmup=1)
    o_floor = 7 * c_w / HBM_BYTES_PER_S * 1e3
    del grads
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    _zero_lm_counts(mods)
    launches = dict.fromkeys(expect, 0)
    for i in range(steps):
        before = _lm_counts(mods)
        t0 = time.perf_counter()
        params, state, loss = node_round(params, state, batches[i], i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: v - before[k] for k, v in _lm_counts(mods).items()}
        if per != expect:
            raise AssertionError(f"[{tag}] step {i}: launches {per} != "
                                 f"{expect}")
        launches = {k: launches[k] + per[k] for k in expect}
        losses.append(float(loss))
        if (i + 1) % HELD_EVERY == 0 or i + 1 == steps:
            held.append((i + 1, held_out(params)))   # outside the counts
    peak = torch.cuda.max_memory_allocated()
    (_, h0), (_, h1) = held[0], held[-1]
    log(f"[{tag}] losses {losses}; held-out batch objective / ce / aux "
        "after step " + ", ".join(
            f"{i}: {o:.6f} / {c:.6f} / {a:.6f}" for i, (o, c, a) in held))
    if not (np.isfinite(losses).all() and h1[0] < h0[0]
            and h0[1] - h1[1] > min_fall):
        raise AssertionError(f"[{tag}] losses not finite, or the held-out "
                             f"objective did not fall ({h0[0]} -> {h1[0]}),"
                             f" or its CE not by more than {min_fall} "
                             f"({h0[1]} -> {h1[1]}): {losses}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for i in range(2):     # the warm-up step, then the traced one
            t0 = time.perf_counter()
            params, state, _ = node_round(params, state,
                                          batches[steps + i], steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    dev_ms, counts, busy_ms = _lm_profile(torch, port, prof)
    f32 = {k: counts.get(k, 0) for k in ("K1 f32", "K2 f32", "K3 f32")}
    if any(f32.values()):
        raise AssertionError(f"[{tag}] f32 dense kernels ran: {f32}")
    # the counters above hold the launches; the trace holds their kernels
    # (its tracer can miss a step's first launches: K1's, K9's), each on
    # the route its shape's plan gives: up to as many as the plan routes
    # there a step, and some where it routes any
    bwd = {(k, r): counts.get(k if r == "wgmma" else f"{k} tile", 0)
           for k in ("K2", "K3") for r in ("wgmma", "tile")}
    if any(not (0 < n <= routes[k]) if routes.get(k) else n
           for k, n in bwd.items()):
        raise AssertionError(f"[{tag}] the traced step's K2/K3 kernels by "
                             f"route {bwd}: want up to {routes} a step")
    mean = float(np.mean(step_ms[1:]))
    log(f"[{tag}] {arch} full width, {L} layers ({n_params} params "
        f"f32, c_w {c_w} B), B={B} x S={S} from lm_corpus over "
        f"{corpus_vocab} of {cfg.vocab_size} token ids, AdamW lr {LM_LR:g} "
        f"(warmup 2 of {steps}), grad_clip 1.0; card: {card}")
    log(f"[{tag}] launches {launches} = {steps} x {expect} (bf16 K1-K3:"
        " no f32 dense kernel in the trace; the traced step's K2 and K3 by "
        "route (wgmma: dense_bwd_wgmma, tile: dense_bwd_bf16_tile), traced"
        " of planned: " + ", ".join(
            f"{k} {r} {n:g} of {routes.get((k, r), 0)}"
            for (k, r), n in bwd.items())
        + "); every grad leaf nonzero at the initial params")
    log(f"[{tag}] step mean {mean:.3f} ms over steps 2-{steps} (first "
        f"{step_ms[0]:.3f} ms), p50 {np.percentile(step_ms[1:], 50):.3f} ms"
        f", {B * S / mean * 1e3:.1f} tokens/s | max_memory_allocated "
        f"{peak / 1e9:.3f} GB ({card})")
    _log_profile(tag, "profiled step (after a warm-up one)", wall_ms,
                 dev_ms, counts, busy_ms)
    log(f"[{tag}] AdamW update + apply alone: event {o_ms:.3f} ms, device "
        f"{fmt_ms(o_dev)} ms against its byte floor {o_floor:.3f} ms (7 c_w"
        f" = {7 * c_w / 1e9:.2f} GB at 3.35 TB/s)"
        + (f", {o_floor / o_dev:.0%} of it" if o_dev else ""))
    if cfg.arch_type in ("ssm", "hybrid"):
        _log_spans(tag, "the traced step", *mamba_spans(torch, prof),
                   family="mamba mixers'")
    if cfg.arch_type == "moe":
        _log_spans(tag, "the traced step", *moe_spans(torch, prof))
        flops = train_flops(cfg, B, S)
        f_ms = sum(flops.values()) / PEAK_FLOPS["bfloat16"] * 1e3
        log(f"[{tag}] the step's flop floor, from the code: "
            f"{sum(flops.values()) / 1e12:.4f} TFLOP (" + ", ".join(
                f"{k} {v / 1e12:.4f}" for k, v in flops.items())
            + f"), {f_ms:.3f} ms at 989 TFLOP/s bf16, "
            f"{f_ms / busy_ms:.1%} of the traced step's device busy "
            f"{busy_ms:.3f} ms")
    del params, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dev_ms


class _PinnedClock:
    """Pins the training CLI's clock as phase 4d(a) does: the engine module's
    ``time`` steps by OUTER_TICK a call, and ``BPTTrainer._local_round``
    reports 0.01 s x the node's speed."""

    def __init__(self, port):
        self.port = port

    def __enter__(self):
        cls = self.port.trainer.BPTTrainer
        self.real = self.port.engine.time, cls._local_round
        orig = cls._local_round

        def pinned(tr, params, opt_state, node, step):
            p, o, loss, _ = orig(tr, params, opt_state, node, step)
            return p, o, loss, 0.01 * float(tr.speed[node])
        self.port.engine.time = _StubClock()
        cls._local_round = pinned

    def __exit__(self, *exc):
        self.port.engine.time, self.port.trainer.BPTTrainer._local_round = \
            self.real


def _drive(port, argv, cfg, params, on_round=None, devices=None):
    """``launch/train.py``'s ``run`` quietly (its report is checked here),
    over the device pool ``devices`` where one is given."""
    import contextlib
    import io
    args = port.train.make_parser().parse_args(argv)
    hooks = port.engine.TrainHooks(on_round=on_round)
    with contextlib.redirect_stdout(io.StringIO()):
        return port.train.run(args, cfg, params, hooks, devices=devices)


def _named_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _params_close(np, a, b):
    """Merged params within rtol 1e-3 / atol 1e-5, every leaf (the
    tables too).  Returns the max diff."""
    worst = 0.0
    for (name, u), (_, v) in zip(_named_leaves(a), _named_leaves(b),
                                 strict=True):
        u, v = u.float().cpu().numpy(), v.float().cpu().numpy()
        d = np.abs(u - v)
        if (d > 1e-5 + 1e-3 * np.abs(v)).any():
            raise AssertionError(f"{name}: max diff {d.max()}")
        worst = max(worst, float(d.max()))
    return worst


def phase_lm_train(torch, port, mods, card):
    """Phase 4f: ``launch/train.py``'s ``run``.  (a) reduced Yi-6B in f32
    on the card and on the CPU with the clock pinned, SGWU (``vmap``) 3
    rounds and AGWU (``heap``) 8 pushes; (b) Phi-3-mini at full width and
    LM_OUTER_LAYERS layers on 4 nodes, the same counts on the measured
    clock; (c) the CLI at its defaults with ``--ckpt-dir``, its file
    restored.  Returns the K1-K3 and K9 launches of (b)."""
    import numpy as np
    lm, weights = port.lm, port.weights
    # (a) card vs CPU, clock pinned
    cfg = dataclasses.replace(port.configs.get_reduced("yi-6b"),
                              dtype="float32")
    tree = weights.params_to_numpy(lm.init_params(
        cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
    for outer, rounds in (("sgwu", 3), ("agwu", 2)):
        runs = {}
        for dev in ("cuda", "cpu"):
            evs = []
            with _PinnedClock(port):
                rep = _drive(port, ["--device", dev, "--outer", outer,
                                    "--rounds", str(rounds)], cfg,
                             weights.params_from_numpy(tree, cfg, dev),
                             evs.append)
            runs[dev] = (rep, evs)
        (crep, cevs), (hrep, hevs) = runs["cuda"], runs["cpu"]
        keys = [[(e.round, e.node, e.virtual_clock, e.sync_wait,
                  e.comm_bytes) for e in evs] for evs in (cevs, hevs)]
        if keys[0] != keys[1] or crep.allocation.tolist() != \
                hrep.allocation.tolist():
            raise AssertionError(f"[lm-train] {outer}: bookkeeping differs:"
                                 f" card {keys[0]} {crep.allocation} vs cpu "
                                 f"{keys[1]} {hrep.allocation}")
        loss_diff = param_diff = 0.0
        for a, b in zip(cevs, hevs):
            np.testing.assert_allclose(a.node_losses, b.node_losses,
                                       rtol=1e-4, atol=1e-6)
            loss_diff = max(loss_diff, float(np.abs(
                a.node_losses - b.node_losses).max()))
            param_diff = max(param_diff, _params_close(np, a.params,
                                                       b.params))
        log(f"[lm-train] {outer}: {len(cevs)} events identical on the card "
            f"and the CPU (clock {cevs[-1].virtual_clock:.4f} s, sync_wait "
            f"{cevs[-1].sync_wait:.4f} s, comm {cevs[-1].comm_bytes} B, "
            f"allocation {crep.allocation.tolist()}"
            + (f", node order {[e.node for e in cevs]}" if outer == "agwu"
               else "") + f"); losses {[round(e.loss, 5) for e in cevs]} "
            f"max_abs_diff {loss_diff:.3g} (rtol 1e-4, atol 1e-6), merged "
            f"params max_abs_diff {param_diff:.3g} (rtol 1e-3, atol 1e-5, "
            "every leaf)")
        del runs, crep, hrep, cevs, hevs

    # (b) Phi-3-mini at full width, 2 layers, 4 nodes, measured clock
    cfg = dataclasses.replace(port.configs.get_config(LM_ARCH),
                              num_layers=LM_OUTER_LAYERS)
    step = lm_step_launches(LM_OUTER_LAYERS)
    nodes, local = 4, 2                           # the CLI's defaults
    total = dict.fromkeys(step, 0)
    for outer, rounds, what in (("sgwu", 3, "SGWU round"),
                                ("agwu", 2, "AGWU push")):
        argv = ["--device", "cuda", "--full", "--arch", LM_ARCH, "--outer",
                outer, "--rounds", str(rounds)]
        params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                device="cuda")
        leaves = port.tree.tree_leaves(params)
        c_w = sum(p.numel() * p.element_size() for p in leaves)
        per_event = (nodes * local if outer == "sgwu" else local)
        want = {k: per_event * n for k, n in step.items()}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_lm_counts(mods)
        seen = {"before": _lm_counts(mods), "t": time.perf_counter()}
        lines = []       # logged after the run, whose own prints are muted

        def on_round(ev):
            now = time.perf_counter()
            counts = _lm_counts(mods)
            per = {k: counts[k] - seen["before"][k] for k in counts}
            seen["before"] = counts
            if per != want:
                raise AssertionError(f"[lm-train] {outer} event {ev.round}:"
                                     f" launches {per} != {want}")
            if not np.isfinite(ev.node_losses).all():
                raise AssertionError(f"[lm-train] {outer} event {ev.round}"
                                     f": losses {ev.node_losses}")
            lines.append(
                f"[lm-train] {what} {ev.round}"
                + (f" (node {ev.node})" if ev.node >= 0 else "")
                + f": wall {(now - seen['t']) * 1e3:.3f} ms, virtual clock "
                f"{ev.virtual_clock:.6f} s, sync_wait {ev.sync_wait:.6f} s, "
                f"loss {ev.loss:.6f}, comm {ev.comm_bytes} B, launches "
                + ", ".join(f"{k} {v}" for k, v in per.items()))
            seen["t"] = time.perf_counter()
        log(f"[lm-train] {LM_ARCH} full width, {LM_OUTER_LAYERS} layers "
            f"({sum(p.numel() for p in leaves)} params f32, c_w {c_w} B) on "
            f"{nodes} nodes, {outer}, launch/train.py defaults (B=8 x S=128,"
            f" {local} local steps, lr 1e-3, IDPA over 512 rows); card: "
            f"{card}")
        rep = _drive(port, argv, cfg, params, on_round)
        peak = torch.cuda.max_memory_allocated()
        for line in lines:
            log(line)
        for k, n in _lm_counts(mods).items():
            total[k] += n
        # Eq. 11: SGWU pulls and pushes every node every round; AGWU's
        # pushes each re-pull but the last of each node, after m pulls
        pulls = pushes = nodes * rounds
        if rep.comm_bytes != (pulls + pushes) * c_w:
            raise AssertionError(f"[lm-train] {outer}: comm "
                                 f"{rep.comm_bytes} != ({pulls} + {pushes})"
                                 f" x {c_w}")
        log(f"[lm-train] {outer}: {rep.last_event} events, losses "
            f"{[round(x, 4) for x in rep.losses]}, comm {rep.comm_bytes} B = "
            f"({pulls} pulls + {pushes} pushes) x c_w (Eq. 11, exact); "
            f"allocation {rep.allocation.tolist()}; max_memory_allocated "
            f"{peak / 1e9:.3f} GB ({card})")
        del rep, params, leaves
        gc.collect()
        torch.cuda.empty_cache()
        # one round (SGWU) or 4 pushes (AGWU) traced after a warm-up one,
        # in a run of their own: on an H100 a trace inside the counted run
        # stretched the traced round's wall by up to 1.8x
        per = 1 if outer == "sgwu" else nodes
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1,
                                        repeat=1)
        clock = {"n": 0, "t": time.perf_counter(), "wall": 0.0}
        params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                device="cuda")
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            def stepper(ev):
                clock["n"] += 1
                if clock["n"] % per == 0:
                    torch.cuda.synchronize()
                    now = time.perf_counter()
                    clock["wall"] = (now - clock["t"]) * 1e3
                    clock["t"] = now
                    prof.step()
            _drive(port, argv[:-1] + ["2"], cfg, params, stepper)
        dev_ms, _, busy_ms = _lm_profile(torch, port, prof)
        log(f"[lm-train] {outer} profiled {'round' if per == 1 else '4 pushes'}"
            f" (after a warm-up one): wall {clock['wall']:.3f} ms, device "
            f"busy {busy_ms:.3f} ms ({100 * busy_ms / clock['wall']:.1f}%), "
            f"device ms by kernel: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(dev_ms.items(),
                                                  key=lambda kv: -kv[1])))
        del params, prof
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the CLI at its defaults, with --ckpt-dir
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as ckdir:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--ckpt-dir",
             ckdir], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"training CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        cfg = port.configs.get_reduced("yi-6b")
        like = lm.init_params(cfg, torch.Generator("cpu").manual_seed(1),
                              device="cpu")
        got, step = port.checkpoint.restore(ckdir, like)
        if step != 8 * 4 or not all(bool(torch.isfinite(t).all())
                                    for t in port.tree.tree_leaves(got)):
            raise AssertionError(f"[lm-cli] checkpoint step {step} or "
                                 "non-finite leaves")
        lines = proc.stdout.strip().splitlines()
        log("[lm-cli] " + next(ln for ln in lines
                               if ln.startswith("[train] loss")))
        log(f"[lm-cli] checkpoint at step {step} restored "
            f"({len(port.tree.tree_leaves(got))} leaves, "
            f"{port.checkpoint.load_manifest(ckdir, step)['metadata']})")
    return total


# ----------------------------------------------------------------------
# The MoE family: Qwen3-30B-A3B served, Granite-3.0-MoE trained
# ----------------------------------------------------------------------
MOE_ARCHS = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m")
MOE_SERVE_ARCH = "qwen3-moe-30b-a3b"   # phase 4g, at full width
MOE_SERVE_LAYERS = 8                   # of 48
MOE_TRAIN_ARCH = "granite-moe-3b-a800m"   # phase 4h, at full width
MOE_TRAIN_LAYERS = 8                   # of 32
# 4h's steps, and the fall of the held-out CE they must bring (nats):
# over 200 steps it swung up to 0.09 above its start and ended 0.20
# below; 10 steps of this schedule do not show training (PERF.md, PR 25)
MOE_STEPS, MOE_MIN_FALL = 200, 0.1
MOE_PROMPT = PREFILL_ROWS[MOE_SERVE_ARCH]   # 4g's traced prefill
MOE_CACHE_TOL = 1e-4                   # card vs CPU f32 caches (post-rope k)
ROUTING = ("top_e", "keep", "slot")


def moe_spans(torch, prof):
    """``spans`` of the moe layer's ``moe.SPANS``."""
    from repro_torch.models.moe import SPANS
    return spans(torch, prof, SPANS)


def mamba_spans(torch, prof):
    """``spans`` of the mamba mixer's ``mamba.SPANS``."""
    from repro_torch.models.mamba import SPANS
    return spans(torch, prof, SPANS)


def spans(torch, prof, SPANS):
    """Device ms of the kernels launched under each span of ``SPANS``
    (``record_function`` names) in ``prof``'s trace of one step: forward,
    and backward (the autograd nodes of the ops
    recorded under the span, linked by their sequence numbers); None
    where the trace holds no device time."""
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    fwd, bwd = dict.fromkeys(SPANS, 0.0), dict.fromkeys(SPANS, 0.0)
    seqs = {k: set() for k in SPANS}

    def walk(evt, key):
        for ch in evt.cpu_children:
            if getattr(ch, "sequence_nr", -1) >= 0:
                seqs[key].add(ch.sequence_nr)
            walk(ch, key)
    for e in cpu:
        if e.name in fwd:
            fwd[e.name] += e.device_time_total / 1e3
            walk(e, e.name)
    for e in cpu:
        if e.name.startswith("autograd::engine::evaluate_function"):
            for k in SPANS:
                if e.sequence_nr in seqs[k]:
                    bwd[k] += e.device_time_total / 1e3
    return ({k: v or None for k, v in fwd.items()},
            {k: v or None for k, v in bwd.items()})


def train_flops(cfg, B, S) -> dict:
    """A training step's flops as the code runs them, 2 per multiply-add:
    forward, dx and dw of each product (3x), the chunked CE's head
    product 4x (its forward recomputed in the backward), attention over
    every key of its one key chunk (masked, not skipped), and the experts
    on every capacity row."""
    from repro_torch.models.moe import capacity
    M, d, L, V = B * S, cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"projections": 3 * L * 2 * M * (2 * d * H * D + 2 * d * KH * D),
           "attention": 3 * L * 2 * 2 * B * H * S * S * D,
           "head": 4 * 2 * M * d * V}
    if cfg.arch_type == "moe":
        E, k, f = cfg.num_experts, cfg.top_k, cfg.expert_d_ff
        C = capacity(S, k, cfg.moe_capacity_factor, E)
        out["experts"] = 3 * L * 2 * B * E * C * 3 * d * f
        out["router"] = 3 * L * 2 * M * d * E
    elif cfg.d_ff:
        out["mlp"] = 3 * L * 2 * M * 3 * d * cfg.d_ff
    return out


def _card_vs_cpu(torch, port, cfg, tag):
    """Reduced ``cfg`` (f32) on the card against the port's CPU path from
    one numpy tree: prefill logits of two prompts (5 and 19 tokens, in
    slots 0 and 2, slot 1 free) and 4 decode steps with per-row lengths,
    then every cache leaf of the occupied slots (kv, the mixer's conv and
    ssm) and the lengths; ``loss_fn``'s value and aux and every gradient
    leaf, remat off and on (phase 3c's f32 gates).  Returns (logits
    max_abs_diff, caches', lengths, {remat: (loss, aux)} on the card and
    on the cpu, the worst gradient difference)."""
    import numpy as np
    lm, weights = port.lm, port.weights
    tree = weights.params_to_numpy(lm.init_params(
        cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
    rng = np.random.default_rng(2)
    prompts = {0: rng.integers(0, cfg.vocab_size, (1, 5)),
               2: rng.integers(0, cfg.vocab_size, (1, 19))}
    steps = rng.integers(0, cfg.vocab_size, (4, 3, 1))
    toks, labels = _lm_batch(np, cfg.vocab_size)
    out = {}
    for dev in ("cuda", "cpu"):
        params = weights.params_from_numpy(tree, cfg, dev)
        cache = lm.init_cache(3, 32, cfg, dtype=torch.float32, device=dev)
        seq = []
        with torch.inference_mode():
            for slot, p in prompts.items():
                logits, sl = lm.prefill(params, torch.as_tensor(p, device=dev),
                                        cfg, cache_dtype=torch.float32)
                seq.append(logits)
                lm.cache_insert(cache, sl, slot)
            for t in steps:
                logits, cache = lm.decode_step(
                    params, cache, None, torch.as_tensor(t, device=dev), cfg)
                seq.append(logits[[0, 2]])
        leaves = [x[:, [0, 2]].cpu()
                  for x in port.tree.tree_leaves(cache.layers)]
        lens = cache.lengths.tolist()
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(labels, device=dev)}
        grads = {}
        for remat in (False, True):
            (loss, parts), g = port.trainer.value_and_grad(
                lambda p, b: lm.loss_fn(p, b, cfg, remat=remat), params,
                batch)
            grads[remat] = (float(loss), float(parts["aux"].detach()),
                            [x.float().cpu()
                             for x in port.tree.tree_leaves(g)])
        out[dev] = ([x.cpu() for x in seq], leaves, lens, grads)
    return _held_card_vs_cpu(torch, out, tag, cfg.name, [9, 0, 23])


def _held_card_vs_cpu(torch, out, tag, name, lengths):
    """The gates of ``_card_vs_cpu`` (and 3f's) on ``out[dev]`` = (logits
    and outputs, cache leaves, lengths, {remat: (loss, aux, gradient
    leaves)}) of the card and the cpu: outputs within SERVE_TOL, cache
    leaves within MOE_CACHE_TOL, the lengths equal and ``lengths``, loss
    and aux and every gradient leaf at phase 3c's f32 gates.  Returns
    what ``_card_vs_cpu`` returns."""
    (cs, ckv, clen, cg), (hs, hkv, hlen, hg) = out["cuda"], out["cpu"]
    diff = max(_logit_diff(torch, a, b) for a, b in zip(cs, hs, strict=True))
    cdiff = max(float((a - b).abs().max()) for a, b in zip(ckv, hkv,
                                                          strict=True))
    if clen != hlen or clen != lengths:
        raise AssertionError(f"[{tag}] {name}: lengths {clen} vs cpu "
                             f"{hlen}")
    if not (diff <= SERVE_TOL and cdiff <= MOE_CACHE_TOL):
        raise AssertionError(f"[{tag}] {name}: logits differ by {diff},"
                             f" caches by {cdiff}")
    tl, atol, rtol = LM_TOL["float32"]
    worst = 0.0
    for remat in cg:
        (cl, ca, cgr), (hl, ha, hgr) = cg[remat], hg[remat]
        if not (abs(cl - hl) <= tl * max(1.0, abs(hl))
                and abs(ca - ha) <= tl * max(1.0, abs(ha))):
            raise AssertionError(f"[{tag}] {name} remat={remat}: loss "
                                 f"{cl} aux {ca} vs cpu {hl} {ha}")
        for a, b in zip(cgr, hgr, strict=True):
            close = (a - b).abs() <= atol + rtol * b.abs()
            if not bool(close.all()):
                raise AssertionError(f"[{tag}] {name} remat={remat}: a "
                                     "grad leaf differs by "
                                     f"{(a - b).abs().max()}")
            worst = max(worst, float((a - b).abs().max()))
    return diff, cdiff, clen, {r: (cg[r][:2], hg[r][:2]) for r in cg}, worst


def _bf16_reruns(torch, port, cfg, tag):
    """``cfg``'s bf16 forward on the card (2 x 40 tokens, cache collected)
    twice: the hidden state, aux and every cache leaf bit for bit."""
    import numpy as np
    lm = port.lm
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                            device="cuda")
    toks = torch.as_tensor(_lm_batch(np, cfg.vocab_size, S=40)[0],
                           device="cuda")
    with torch.inference_mode():
        runs = [lm.forward(params, toks, cfg, collect_cache=True)
                for _ in range(2)]
    (h1, c1, a1), (h2, c2, a2) = runs
    same = torch.equal(h1, h2) and torch.equal(a1, a2) and all(
        torch.equal(x, y) for x, y in zip(port.tree.tree_leaves(c1),
                                          port.tree.tree_leaves(c2),
                                          strict=True))
    if not same or h1.dtype != torch.bfloat16:
        raise AssertionError(f"[{tag}] {cfg.name} bf16 forward on the card "
                             "gave different bits on a rerun")
    log(f"[{tag}] {cfg.name} bf16 forward (2 x 40 tokens, cache collected: "
        f"{', '.join(_leaf_names(c1))}) reruns bit for bit on the card")


def _leaf_names(tree, prefix=""):
    return [n for k in sorted(tree) for n in (
        _leaf_names(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict)
        else [prefix + k])]


def phase_moe_parity(torch, port, serving):
    """Phase 3d: reduced Qwen3-MoE (``qk_norm``) and Granite-MoE in f32
    (TF32 off), the card against the port's CPU path from the same numpy
    params: the serving engine's token streams (``phase_reduced``),
    ``_card_vs_cpu``'s prefill, decode, cache, loss and gradient checks,
    and every router decision (``top_e``, ``keep``, slot) of all these
    calls equal.  Then the bf16 forward on the card reruns bit for bit."""
    from repro_torch.models import moe
    lm, weights, configs = port.lm, port.weights, port.configs
    for arch in MOE_ARCHS:
        phase_reduced(torch, configs, lm, serving, weights, arch)
    seen = {"cuda": [], "cpu": []}
    route = moe.route

    def recording(params, x, cfg, capacity_factor=0.0):
        r = route(params, x, cfg, capacity_factor)
        seen[x.device.type].append({k: r[k].cpu() for k in ROUTING})
        return r
    moe.route = recording
    try:
        for arch in MOE_ARCHS:
            cfg = dataclasses.replace(configs.get_reduced(arch),
                                      dtype="float32", ce_chunk=5)
            diff, cdiff, clen, losses, worst = _card_vs_cpu(
                torch, port, cfg, "moe-parity")
            calls = len(seen["cuda"])
            if calls != len(seen["cpu"]) or calls == 0:
                raise AssertionError(f"[moe-parity] {arch}: {calls} routed "
                                     f"calls on the card, "
                                     f"{len(seen['cpu'])} on the cpu")
            for i, (a, b) in enumerate(zip(seen["cuda"], seen["cpu"])):
                for k in ROUTING:
                    if not torch.equal(a[k], b[k]):
                        raise AssertionError(
                            f"[moe-parity] {arch}: routed call {i} differs "
                            f"in {k}")
            n_tok = sum(int(r["keep"].numel()) for r in seen["cuda"])
            seen["cuda"].clear()
            seen["cpu"].clear()
            (cl, ca), (hl, ha) = losses[False]
            tl, atol, rtol = LM_TOL["float32"]
            log(f"[moe-parity] {arch} f32 card vs cpu: prefill + 4 decode "
                f"steps logits max_abs_diff {diff:.3g} (tol {SERVE_TOL}), "
                f"caches {cdiff:.3g} (tol {MOE_CACHE_TOL}), lengths {clen}; "
                f"loss {cl:.7f} (cpu {hl:.7f}), aux {ca:.7f} (cpu {ha:.7f}),"
                f" every grad leaf within atol {atol:g} / rtol {rtol:g} "
                f"(max_abs_diff {worst:.3g}), remat on and off; routing "
                f"equal in all {calls} routed calls ({n_tok} token copies: "
                "top_e, keep, slot)")
    finally:
        moe.route = route

    for arch in MOE_ARCHS:
        _bf16_reruns(torch, port, configs.get_reduced(arch), "moe-parity")
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_serve(torch, port, serving, counters, card):
    """Phase 4g: Qwen3-30B-A3B at full width, MOE_SERVE_LAYERS of 48
    layers, through ``serve_family``: K1 4 L and K9 4 L + 1 launches per
    forward call (ln1, ln2 and the q and k norms a layer, and the final
    norm); the decode step's byte floor holds every expert's weights (the
    reference runs every expert on its capacity rows); the moe layers'
    spans.  Returns what ``serve_family`` returns."""
    cfg = dataclasses.replace(port.configs.get_config(MOE_SERVE_ARCH),
                              num_layers=MOE_SERVE_LAYERS)
    return serve_family(torch, port, serving, counters, card, cfg,
                        MOE_PROMPT, "moe-serve", moe_spans,
                        f"{cfg.num_experts} experts top-{cfg.top_k}, "
                        "qk_norm")


def serve_family(torch, port, serving, counters, card, cfg, prompt_len,
                 tag, span_fn, about):
    """A served model at full width from a seed: 8 Poisson requests
    through the continuous engine (every request completes, logits
    finite, exactly ``dense_per_layer`` L K1 and ``norms_per_layer`` L +
    1 K9 launches per forward call; TTFT, latency p50/p99, tok/s, peak
    memory), a decode step of 4 full slots timed and traced by kernel
    (``_decode_trace``: K1, K9, cuBLAS, other, and ``span_fn``'s spans,
    if any) against its byte floor, and one ``prompt_len``-token prompt's
    prefill timed (exact launches per call; its logits and every cache
    leaf finite) and traced.  Returns (serving launches, {kernel: {prompt
    rows: K1/K9 launches a prefill call}}, the traced decode step's and
    prefill's {kernel: device ms})."""
    import numpy as np
    L = cfg.num_layers
    full = port.configs.get_config(cfg.name).num_layers
    t0 = start = time.perf_counter()
    params = port.lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                 device="cuda")
    n_params = sum(t.numel() for t in port.tree.tree_leaves(params))
    eng = serving.make_serve_engine(params, cfg, serving.ServeConfig(
        slots=4, max_seq=prompt_len + 64), device="cuda")
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name} full width, {L} of {full} layers ({n_params} "
        f"params f32 + bf16 compute copy, {about}), ready in "
        f"{time.perf_counter() - t0:.1f} s")
    eng.generate(np.zeros((1, 8), np.int32), 2)   # warm-up
    laps = [time.perf_counter()]     # the host's seconds a part, logged
    reqs = serving.poisson_requests(8, rate_rps=50, seed=0,
                                    vocab_size=cfg.vocab_size)
    events, launches, calls, decode_ms, peak, pre = _serve(
        torch, eng, reqs, counters)
    laps.append(time.perf_counter())
    per_call = {"K1": dense_per_layer(cfg) * L,
                "K9": norms_per_layer(cfg) * L + 1}
    _report(events, 8, eng, calls, launches, per_call, decode_ms, peak,
            card, tag)

    # a decode step of 4 full slots: unprofiled wall, then traced
    rng = np.random.default_rng(1)
    _, sl, _ = eng.prefill(rng.integers(0, cfg.vocab_size, (4, 16)))
    for slot in range(4):
        eng.insert(sl, slot, row=slot)
    family = "moe layers'" if span_fn is moe_spans else "mamba mixers'"
    dec = _decode_trace(torch, port, eng, rng.integers(0, cfg.vocab_size,
                                                       (4,)),
                        tag, span_fn, family)
    laps.append(time.perf_counter())

    # the long prompt's prefill: timed, then traced
    prompt = rng.integers(0, cfg.vocab_size, (1, prompt_len))
    pre_ms = []
    for _ in range(3):
        for fn in counters.values():
            fn.launches = 0
        pre_ms.append(eng.prefill(prompt)[2])
        for k, n in per_call.items():
            if counters[k].launches != n:
                raise AssertionError(
                    f"[{tag}] a prefill of {prompt_len} tokens launched "
                    f"{k} {counters[k].launches} times, not {n}")
            pre[k].setdefault(prompt_len, []).append(counters[k].launches)
    (logits, sl, _), traced_ms, prof = _traced(
        torch, lambda: eng.prefill(prompt), cpu=span_fn is not None)
    if not bool(torch.isfinite(logits).all()) or not all(
            bool(torch.isfinite(t).all())
            for t in port.tree.tree_leaves(sl.layers)):
        raise AssertionError(f"[{tag}] non-finite prefill logits or cache")
    pf, pf_n, pf_busy = _lm_profile(torch, port, prof)
    log(f"[{tag}] the {prompt_len}-token prompt: prefill "
        f"{', '.join(f'{m:.3f}' for m in pre_ms)} ms (K1 {per_call['K1']}, "
        f"K9 {per_call['K9']} launches each); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({card})")
    what = f"traced {prompt_len}-token prefill"
    _log_profile(tag, what, traced_ms, pf, pf_n, pf_busy)
    if span_fn:
        _log_spans(tag, what, span_fn(torch, prof)[0], family=family)
    laps.append(time.perf_counter())
    log(f"[{tag}] host seconds: set-up and warm-up {laps[0] - start:.1f}, "
        + ", ".join(f"{what} {b - a:.1f}" for what, a, b in zip(
            ("serving", "the decode step timed and traced",
             "the prefill timed and traced"), laps, laps[1:])))
    del params, eng, sl
    gc.collect()
    torch.cuda.empty_cache()
    return launches, pre, dec, pf


def _traced(torch, fn, cpu=True):
    """``fn()`` twice under ``torch.profiler``, the warm-up step and then
    the traced one: (the traced call's result, its wall ms, the
    profiler).  The trace of a host-paced call takes the host seconds to
    read, more than the call itself, so one call is traced; without
    ``cpu`` it records the device's kernels alone (all that
    ``_lm_profile`` reads; ``spans`` needs the host's ops), which reads in
    a fraction of the time where a call launches thousands of kernels."""
    acts = [torch.profiler.ProfilerActivity.CUDA] + (
        [torch.profiler.ProfilerActivity.CPU] if cpu else [])
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            prof.step()
    return out, wall, prof


def _decode_trace(torch, port, eng, toks, tag, span_fn=None, family=""):
    """A decode step of ``eng``'s 4 full slots: 2 warm-up steps, 10
    unprofiled (median, fastest), one traced after a warm-up one, against
    its byte floor (every layer leaf as the engine holds it, the head's
    table, each slot's mixer state read and written); ``span_fn``'s spans
    logged where given.  Returns the traced step's {kernel: device ms}."""
    import numpy as np
    for _ in range(2):
        eng.decode(toks)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.decode(toks)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _, traced_ms, prof = _traced(torch, lambda: eng.decode(toks),
                                 cpu=span_fn is not None)
    dec, dec_n, dec_busy = _lm_profile(torch, port, prof)
    cp = eng.params
    layer_bytes = sum(t.numel() * t.element_size()
                      for t in port.tree.tree_leaves(cp["layers"]))
    head = cp.get("lm_head", cp["embed"])["table"]
    state = eng.cache.layers.get("mamba", {})
    state_bytes = 2 * sum(t.numel() * t.element_size()
                          for t in port.tree.tree_leaves(state))
    floor_bytes = layer_bytes + head.numel() * head.element_size() \
        + state_bytes
    floor_ms = floor_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] decode step, 4 slots: unprofiled median "
        f"{np.median(walls):.3f} ms, fastest {min(walls):.3f} ms; byte "
        f"floor {floor_bytes / 1e9:.3f} GB (every layer leaf as held, the "
        f"head's bf16 table, and {state_bytes / 1e9:.3f} GB of the slots' "
        f"mixer state read and written) = {floor_ms:.3f} ms at 3.35 TB/s; "
        f"device busy {dec_busy:.3f} ms"
        + (f" (the floor is {floor_ms / dec_busy:.1%} of it)"
           if dec_busy else ""))
    # (the counters hold the launches; a K1 decode launch is two kernels,
    # the split-K slices and their sum)
    what = "traced decode step"
    _log_profile(tag, what, traced_ms, dec, dec_n, dec_busy)
    if span_fn:
        _log_spans(tag, what, span_fn(torch, prof)[0], family=family)
    return dec


# ----------------------------------------------------------------------
# The SSM and hybrid families: Mamba2-370M and Hymba-1.5B served at full
# depth, Hymba-1.5B trained
# ----------------------------------------------------------------------
SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")
# the served archs' kernels-line prefix (and log tag, "<prefix>-serve")
# and phase
SSM_SERVE = {"mamba2-370m": ("mamba", "4i"), "hymba-1.5b": ("hymba", "4j")}
SSM_TRAIN_ARCH = "hymba-1.5b"          # phase 4k, at full width
SSM_TRAIN_LAYERS = 8                   # of 32
# the families trained at full width beside phase 4e, keyed as phase 2d's
# rows: (arch, layers, norms a layer, d_model)
TRAIN_FAMILIES = {"moe": (MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, 2, 1536),
                  "ssm": (SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS, 4, 1600)}
# 4k's data, steps and the fall of the held-out CE they must bring
# (nats).  Reduced Hymba trained on the CPU beside the reference
# (tests/test_torch_lm_train.py's _held_out_trajectory("hymba-1.5b", 100,
# ssd_chunk=4): lm_corpus over its 512 token ids) lowers the held-out
# objective at every tenth step, the port within 1e-6 of the reference.
# Over all 32001 ids no 100 steps of this recipe lower it: the logits'
# spread grows near the peak lr and the CE with it, in the reference (on
# the CPU at d_model 1600), in the port with plain dispatch or the
# sequential SSD, with either branch alone, and in Phi-3
# (tools/train_probe.py).  So 4k draws lm_corpus over the reduced
# config's 512 ids; the model keeps its 32001.  The CE must fall by more
# than learning the ids' near-uniform frequencies alone brings (10.69 -
# ln 512 = 4.46 nats; it rests near 6.3 over steps 10-40), so the model
# must use the context: it fell 6.90 to 3.79 (PERF.md, the SSM and
# hybrid families)
SSM_CORPUS_VOCAB, SSM_STEPS, SSM_MIN_FALL = 512, 100, 4.5
# 3e runs reduced Mamba2's SSD in chunks of 8 (its config leaves 256, so a
# short prompt would be one chunk): its 19-token prompt chains 3 chunks,
# the last padded
SSM_CHUNK = {"mamba2-370m": dict(ssd_chunk=8), "hymba-1.5b": {}}


def phase_ssm_parity(torch, port, serving):
    """Phase 3e: reduced Mamba2 (SSD chunk 8) and reduced Hymba (window 16
    on layer 1) in f32 (TF32 off), the card against the port's CPU path
    from the same numpy params: the serving engine's token streams
    (``phase_reduced``; Hymba's prompts pass its window), and
    ``_card_vs_cpu``'s prefill logits, 4 decode steps with per-row
    lengths, every cache leaf (kv, conv, ssm), ``loss_fn`` and every
    gradient leaf, remat off and on.  Then each config's bf16 forward on
    the card reruns bit for bit."""
    lm, weights, configs = port.lm, port.weights, port.configs
    tl, atol, rtol = LM_TOL["float32"]
    for arch in SSM_ARCHS:
        phase_reduced(torch, configs, lm, serving, weights, arch,
                      **SSM_CHUNK[arch])
        cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                                  ce_chunk=5, **SSM_CHUNK[arch])
        diff, cdiff, clen, losses, worst = _card_vs_cpu(torch, port, cfg,
                                                        "ssm-parity")
        (cl, _), (hl, _) = losses[False]
        log(f"[ssm-parity] {arch} f32 card vs cpu (SSD chunk "
            f"{cfg.ssd_chunk or 256}, window {cfg.sliding_window}): prefill "
            f"+ 4 decode steps logits max_abs_diff {diff:.3g} (tol "
            f"{SERVE_TOL}), every cache leaf {cdiff:.3g} (tol "
            f"{MOE_CACHE_TOL}), lengths {clen}; loss {cl:.7f} (cpu "
            f"{hl:.7f}), every grad leaf within atol {atol:g} / rtol "
            f"{rtol:g} (max_abs_diff {worst:.3g}), remat on and off")
    for arch in SSM_ARCHS:
        _bf16_reruns(torch, port, dataclasses.replace(
            configs.get_reduced(arch), **SSM_CHUNK[arch]), "ssm-parity")
    gc.collect()
    torch.cuda.empty_cache()


def phase_ssm_serve(torch, port, serving, counters, card):
    """Phases 4i and 4j: Mamba2-370M (48 layers) and Hymba-1.5B (32
    layers; global layers 0, 15, 31, window 1024 elsewhere) at full width
    and depth through ``serve_family``, each with one long prompt
    (PREFILL_ROWS: 2000 tokens, eight 256-token SSD chunks, the last
    padded; 2048, past Hymba's window).  Returns per arch what
    ``serve_family`` returns."""
    out = {}
    for arch in SSM_ARCHS:
        cfg = port.configs.get_config(arch)
        about = (f"SSD H {cfg.ssm_heads} x P {cfg.ssm_head_dim} x N "
                 f"{cfg.ssm_state}, conv {cfg.conv_kernel}"
                 + (f", window {cfg.sliding_window} but layers "
                    f"{cfg.global_layers}" if cfg.sliding_window else ""))
        out[arch] = serve_family(torch, port, serving, counters, card, cfg,
                                 PREFILL_ROWS[arch],
                                 f"{SSM_SERVE[arch][0]}-serve",
                                 mamba_spans, about)
    return out


def serve_k9_row(k9_cases, arch, kind, n):
    """K9's phase-2c case of ``arch``'s d_model at ``kind``'s rows
    (SERVE_RMS; Seamless's: ENC_RMS), n launches of it."""
    rows, d = (ENC_RMS if arch == ENC_ARCH else SERVE_RMS[arch])[kind]
    c = k9_cases[(rows, d, "bfloat16")]
    row = _new_row()
    _note_err(row, c["err"], c["tol"])
    _add_case(row, n, (c["ms"], c["device_ms"], c["plain_ms"],
                       c["library_ms"], c["library_device_ms"],
                       c["bound_ms"], c["bound_by"]))
    return row


def sum_fields(prefix, st, launches, step_device_ms, work):
    """A kernels-line row's fields for a phase-2 sum ``st`` (``_k1_sum``)
    under ``prefix``, ``launches`` from the serving run."""
    return {**{f"{prefix}_{k}": v for k, v in st.items() if k != "bound_by"},
            f"{prefix}_bound_by": dominant(st["bound_by"]),
            f"{prefix}_launches": launches,
            f"{prefix}_step_device_ms": step_device_ms,
            f"{prefix}_work": work}


def qwen_k9_row(k9_cases, kind):
    """K9's phase-2c cases summed over one Qwen3-MoE forward
    (MOE_SERVE_LAYERS layers) of ``kind`` "decode" (4 slots) or "prefill"
    (MOE_PROMPT tokens): 2 L + 1 norms at d_model, L q norms and L k
    norms at head_dim."""
    L = MOE_SERVE_LAYERS
    row = _new_row()
    for (rows, d), n in zip(QWEN_RMS[kind], (2 * L + 1, L, L)):
        c = k9_cases[(rows, d, "bfloat16")]
        _note_err(row, c["err"], c["tol"])
        _add_case(row, n, (c["ms"], c["device_ms"], c["plain_ms"],
                           c["library_ms"], c["library_device_ms"],
                           c["bound_ms"], c["bound_by"]))
    return row


def instance_fields(prefix, row, launches, step_device_ms,
                    outer_launches, work):
    """A kernels-line row's fields for another instance of its kernel,
    under ``prefix``: the same keys as the row's own."""
    fields = {"launches": launches, "max_abs_err": row["err"],
              "tolerance": row["tol"], "ms": row["ms"],
              "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
              "bound_by": dominant(row["bound_by"]),
              "library_ms": row["library_ms"],
              "device_ms": row["device_ms"],
              "library_device_ms": row["library_device_ms"],
              "step_device_ms": step_device_ms,
              "outer_launches": outer_launches, "work": work}
    return {f"{prefix}_{k}": v for k, v in fields.items()}


# ----------------------------------------------------------------------
# The remaining LM families: InternVL2-26B (vlm: patch embeddings before
# the text), SeamlessM4T-large-v2 (encoder-decoder) and StableLM-2-12B
# (dense at head_dim 160)
# ----------------------------------------------------------------------
VLM_ARCH = "internvl2-26b"
VLM_SERVE_LAYERS = 8                   # of 48 (phase 4l)
VLM_TRAIN_LAYERS = 2                   # of 48 (phase 4m)
VLM_PATCHES = 256                      # the config's patch tokens an image
VLM_D = 6144                           # its d_model
VLM_TEXT = 512                         # 4l's image prompts: 256 + 512 tokens
VLM_ROWS = 4                           # ... 4 of them, into 4 slots
VLM_TRAIN_ROWS = LM_BATCH * (VLM_PATCHES + LM_SEQ)     # 4m: 8 x (256 + 128)
ENC_ARCH = "seamless-m4t-large-v2"     # phase 4n: full width and depth
ENC_LAYERS, ENC_D, ENC_FF = 24, 1024, 8192   # a stack's layers, d, d_ff
ENC_FRAMES = 4096                      # the config's frames a row
ENC_ROWS = 4                           # 4n's rows: 4 x 4096 frames encoded,
ENC_PREFIX = 64                        # a 64-token text prefix decoded
ENC_TRAIN_FRAMES = 512                 # 4n's training: B 8 x (512 + 128)
ENC_TRAIN_ROWS = (LM_BATCH * ENC_TRAIN_FRAMES, LM_BATCH * LM_SEQ)
STABLE_ARCH = "stablelm-12b"           # phase 4o
STABLE_LAYERS = 8                      # of 40
MM_DECODE_STEPS = 32                   # 4l's and 4n's decode steps
# 4m's and 4n's steps, the fall of the held-out CE they must bring (nats)
# and the corpus's token ids, as phase 4k draws them (lm_corpus over the
# reduced configs' 512 ids; the models keep their vocabularies)
MM_STEPS, MM_MIN_FALL, MM_CORPUS_VOCAB = 50, 2.0, 512
MM_TRAIN_PHASE = {"vlm": "4m", "encdec": "4n"}
# 3f's narrow dense config at StableLM's head_dim
NARROW_160 = dict(d_model=320, num_heads=2, num_kv_heads=1, head_dim=160,
                  d_ff=640)
# phase 2d at the new training shapes, at their own rows
LM_BWD_SHAPES[VLM_ARCH] = DECODE_SHAPES[VLM_ARCH]
LM_BWD_SHAPES[ENC_ARCH] = DECODE_SHAPES[ENC_ARCH]
LM_BWD_ROWS = {VLM_ARCH: (VLM_TRAIN_ROWS,), ENC_ARCH: ENC_TRAIN_ROWS}
RMS_BWD_CASES += [(VLM_TRAIN_ROWS, VLM_D, "bfloat16")] + [
    (M, ENC_D, "bfloat16") for M in ENC_TRAIN_ROWS]


def mm_train_launches() -> dict:
    """{family: {kernel: {shape: launches a step}}} of phases 4m
    (InternVL2, VLM_TRAIN_LAYERS layers) and 4n (Seamless, 24 + 24
    layers), counted from the models' code: K1, K2 and K3 at (M, Din,
    Dout), K9's backward at (M, d).  InternVL2's patch projection is a
    plain product, not K1.  Seamless's encoder rows run the
    ``frontend_proj`` (whose input takes no gradient: no K2), each
    layer's q, k, v, o and MLP, and each decoder layer's cross k and v of
    the memory; its decoder rows run the self-attention's four, the
    cross q and o and the MLP's three."""
    from collections import Counter
    vlm = Counter()
    for _, Din, Dout in DECODE_SHAPES[VLM_ARCH]:
        vlm[(VLM_TRAIN_ROWS, Din, Dout)] += VLM_TRAIN_LAYERS
    L, (Me, Md), d, f = ENC_LAYERS, ENC_TRAIN_ROWS, ENC_D, ENC_FF
    enc = Counter({(Me, d, d): 1 + 4 * L + 2 * L, (Me, d, f): 2 * L,
                   (Me, f, d): L})
    enc += Counter({(Md, d, d): 6 * L, (Md, d, f): 2 * L, (Md, f, d): L})
    enc_dx = enc.copy()
    enc_dx[(Me, d, d)] -= 1
    return {"vlm": {"K1": vlm, "K2": vlm, "K3": vlm,
                    "K9 bwd": {(VLM_TRAIN_ROWS, VLM_D):
                               2 * VLM_TRAIN_LAYERS + 1}},
            "encdec": {"K1": enc, "K2": enc_dx, "K3": enc,
                       "K9 bwd": Counter({(Me, d): 2 * L + 1})
                       + Counter({(Md, d): 3 * L + 1})}}


def enc_serve_launches() -> dict:
    """{part: ({(M, Din, Dout): K1 launches}, K9 launches)} of phase 4n's
    ``encode`` (ENC_ROWS x ENC_FRAMES), ``_decode_stack`` (ENC_ROWS x
    ENC_PREFIX tokens; each layer's cross k and v project the memory) and
    decode step (ENC_ROWS rows), counted from ``models/encdec.py``."""
    from collections import Counter
    L, d, f = ENC_LAYERS, ENC_D, ENC_FF
    Me, Mp, Md = ENC_ROWS * ENC_FRAMES, ENC_ROWS * ENC_PREFIX, ENC_ROWS
    return {"encode": ({(Me, d, d): 1 + 4 * L, (Me, d, f): 2 * L,
                        (Me, f, d): L}, 2 * L + 1),
            "prefill": (Counter({(Mp, d, d): 6 * L, (Mp, d, f): 2 * L,
                                 (Mp, f, d): L})
                        + Counter({(Me, d, d): 2 * L}), 3 * L + 1),
            "decode": ({(Md, d, d): 6 * L, (Md, d, f): 2 * L,
                        (Md, f, d): L}, 3 * L + 1)}


def case_sum(cases, key, launches) -> dict:
    """A ``_new_row`` adding up timed ``cases`` (phase 2's, keyed (arch,
    M, K, N); phase 2d's, keyed (kernel, M, Din, Dout) or ("K9 bwd", M,
    d)) of ``key``, each shape as many times as ``launches`` says."""
    row = _new_row()
    for shape, n in launches.items():
        c = cases[(key, *shape)]
        _note_err(row, c["err"], c["tol"])
        _add_case(row, n, c["t"])
    return row


def fill_cross(port, params, cfg, cache, memory):
    """Every decoder layer's ``cross_k`` / ``cross_v``: the memory
    projected by its cross-attention ``wk`` / ``wv`` (``layers.dense``:
    K1 on the card).  Nothing in the port fills them, as nothing in the
    reference does."""
    B, S, _ = memory.shape
    xa = params["decoder"]["cross_attn"]
    for i in range(cfg.num_layers):
        for n in ("k", "v"):
            leaf = cache[f"cross_{n}"]
            leaf[i] = port.layers.dense({"w": xa[f"w{n}"]["w"][i]}, memory) \
                .reshape(B, S, cfg.num_kv_heads, cfg.head_dim).to(leaf.dtype)


def _grads(torch, port, loss_fn, params, batch, remats=(False, True)):
    """{remat: (loss, aux, every gradient leaf on the cpu)}."""
    out = {}
    for remat in remats:
        (loss, parts), g = port.trainer.value_and_grad(
            lambda p, b: loss_fn(p, b, remat), params, batch)
        out[remat] = (float(loss), float(parts["aux"].detach()),
                      [x.float().cpu() for x in port.tree.tree_leaves(g)])
    return out


def _vlm_card_vs_cpu(torch, port, cfg, tag):
    """Reduced InternVL2 (f32) on the card against the port's CPU path
    from one numpy tree: an image prompt (the config's patches + 11
    tokens, 2 rows) through ``lm.forward`` with f32 caches (and
    ``steps.make_prefill_step``'s last hidden state equal to it), the
    caches into slots 0 and 2 of 3, 4 decode steps; ``loss_fn`` with the
    patches and every gradient leaf, remat off and on."""
    import numpy as np
    lm, weights = port.lm, port.weights
    tree = weights.params_to_numpy(lm.init_params(
        cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
    rng = np.random.default_rng(2)
    P = cfg.num_frontend_tokens
    fe = (rng.standard_normal((2, P, cfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    steps = rng.integers(0, cfg.vocab_size, (4, 3, 1))
    btoks, blabels = _lm_batch(np, cfg.vocab_size)
    n = P + 11
    out = {}
    for dev in ("cuda", "cpu"):
        params = weights.params_from_numpy(tree, cfg, dev)
        f = torch.as_tensor(fe, device=dev).bfloat16()
        t = torch.as_tensor(toks, device=dev)
        with torch.inference_mode():
            hidden, layers, _ = lm.forward(params, t, cfg, frontend_embeds=f,
                                           collect_cache=True,
                                           cache_dtype=torch.float32)
            last, _ = port.steps.make_prefill_step(cfg)(
                params, {"tokens": t, "frontend_embeds": f})
            if not torch.equal(last, hidden[:, -1]):
                raise AssertionError(f"[{tag}] {cfg.name}: make_prefill_step"
                                     " is not the forward's last state")
            cache = lm.init_cache(3, n + 8, cfg, dtype=torch.float32,
                                  device=dev)
            sl = lm.DecodeCache(layers=layers, lengths=torch.full(
                (2,), n, dtype=torch.int32, device=dev))
            lm.cache_insert(cache, sl, 0, 0)
            lm.cache_insert(cache, sl, 2, 1)
            seq = [hidden]
            for s in steps:
                logits, cache = lm.decode_step(
                    params, cache, None, torch.as_tensor(s, device=dev), cfg)
                seq.append(logits[[0, 2]])
        batch = {"tokens": torch.as_tensor(btoks, device=dev),
                 "labels": torch.as_tensor(blabels, device=dev),
                 "frontend_embeds": f}
        out[dev] = ([x.cpu() for x in seq],
                    [x[:, [0, 2]].cpu()
                     for x in port.tree.tree_leaves(cache.layers)],
                    cache.lengths.tolist(),
                    _grads(torch, port, lambda p, b, r: lm.loss_fn(
                        p, b, cfg, remat=r), params, batch))
    return _held_card_vs_cpu(torch, out, tag, cfg.name, [n + 4, 0, n + 4])


def _encdec_card_vs_cpu(torch, port, cfg, tag):
    """Reduced Seamless (f32) on the card against the port's CPU path from
    one numpy tree: ``encode`` of 2 x 16 frames, ``_decode_stack`` of a
    7-token prefix, the cross cache filled from the memory, the prefix
    decoded one token at a time (each position's logits within SERVE_TOL
    of the stack's, on each device) and 4 more decode steps;
    ``encdec_loss_fn`` and every gradient leaf.  Returns
    ``_held_card_vs_cpu``'s and the worst prefix difference."""
    import numpy as np
    encdec, weights = port.encdec, port.weights
    tree = weights.params_to_numpy(encdec.init_encdec_params(
        cfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
    rng = np.random.default_rng(2)
    F = cfg.num_frontend_tokens
    fe = (rng.standard_normal((2, F, cfg.d_model)) * 0.02).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 7))
    more = rng.integers(0, cfg.vocab_size, (4, 2, 1))
    btoks, blabels = _lm_batch(np, cfg.vocab_size)
    out, prefix = {}, 0.0
    for dev in ("cuda", "cpu"):
        p = weights.params_from_numpy(tree, cfg, dev)
        f = torch.as_tensor(fe, device=dev).bfloat16()
        t = torch.as_tensor(toks, device=dev)
        with torch.inference_mode():
            mem = encdec.encode(p, f, cfg)
            hid = encdec._decode_stack(p, encdec.embed_tokens(p, t, cfg), mem,
                                       cfg)
            want = (hid @ p["embed"]["table"].T).float()
            cache = encdec.init_encdec_cache(cfg, 2, 11, F,
                                             dtype=torch.float32, device=dev)
            fill_cross(port, p, cfg, cache, mem)
            seq = [mem, hid]
            for i in range(7):
                lo, _ = encdec.encdec_decode_step(p, cache, i, t[:, i:i + 1],
                                                  cfg)
                prefix = max(prefix, _logit_diff(torch, lo[:, 0],
                                                 want[:, i]))
                seq.append(lo)
            for i, s in enumerate(more):
                lo, _ = encdec.encdec_decode_step(
                    p, cache, 7 + i, torch.as_tensor(s, device=dev), cfg)
                seq.append(lo)
        batch = {"tokens": torch.as_tensor(btoks, device=dev),
                 "labels": torch.as_tensor(blabels, device=dev),
                 "frontend_embeds": f}
        out[dev] = ([x.cpu() for x in seq],
                    [x.cpu() for x in port.tree.tree_leaves(cache)], [11],
                    _grads(torch, port, lambda q, b, r: encdec.encdec_loss_fn(
                        q, b, cfg), p, batch, (False,)))
    if not prefix <= SERVE_TOL:
        raise AssertionError(f"[{tag}] {cfg.name}: the prefix decoded a "
                             f"token at a time differs from _decode_stack "
                             f"by {prefix}")
    return _held_card_vs_cpu(torch, out, tag, cfg.name, [11]) + (prefix,)


def phase_mm_parity(torch, port):
    """Phase 3f: reduced InternVL2 (``_vlm_card_vs_cpu``), reduced
    Seamless (``_encdec_card_vs_cpu``) and a narrow dense config at head_dim
    160 (NARROW_160, ``_card_vs_cpu``), each in f32 (TF32 off) on the card
    against the port's CPU path from one numpy tree; then each bf16
    forward on the card reruns bit for bit (InternVL2's with its patches,
    Seamless's ``encdec_forward``)."""
    configs, tl = port.configs, LM_TOL["float32"]
    f32 = dict(dtype="float32", ce_chunk=5)
    narrow = dataclasses.replace(configs.get_reduced(STABLE_ARCH), **f32,
                                 **NARROW_160)
    for name, run in (
            ("vlm", lambda: _vlm_card_vs_cpu(torch, port, dataclasses.replace(
                configs.get_reduced(VLM_ARCH), **f32), "mm-parity")),
            ("encdec", lambda: _encdec_card_vs_cpu(
                torch, port, dataclasses.replace(
                    configs.get_reduced(ENC_ARCH), **f32), "mm-parity")),
            ("head_dim 160", lambda: _card_vs_cpu(torch, port, narrow,
                                                  "mm-parity"))):
        diff, cdiff, clen, losses, worst, *prefix = run()
        (cl, _), (hl, _) = losses[False]
        log(f"[mm-parity] {name} f32 card vs cpu: outputs and logits "
            f"max_abs_diff {diff:.3g} (tol {SERVE_TOL}), every cache leaf "
            f"{cdiff:.3g} (tol {MOE_CACHE_TOL}), lengths {clen}; loss "
            f"{cl:.7f} (cpu {hl:.7f}), every grad leaf within atol {tl[1]:g}"
            f" / rtol {tl[2]:g} (max_abs_diff {worst:.3g})"
            + (f"; the prefix decoded a token at a time against "
               f"_decode_stack's logits max_abs_diff {prefix[0]:.3g}"
               if prefix else ""))
    _bf16_reruns(torch, port, dataclasses.replace(
        configs.get_reduced(STABLE_ARCH), **NARROW_160), "mm-parity")
    for arch in (VLM_ARCH, ENC_ARCH):
        cfg = configs.get_reduced(arch)
        gen = torch.Generator("cuda").manual_seed(1)
        fe = port.frontends.random_frontend_embeds(gen, cfg, 2, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                             device="cuda")
        if arch == ENC_ARCH:
            params = port.encdec.init_encdec_params(cfg, gen, "cuda")
            with torch.inference_mode():
                runs = [[port.encdec.encdec_forward(params, fe, toks, cfg)]
                        for _ in range(2)]
        else:
            params = port.lm.init_params(cfg, gen, "cuda")
            with torch.inference_mode():
                runs = [[x for x in port.lm.forward(
                    params, toks, cfg, frontend_embeds=fe,
                    collect_cache=True)[:2]] for _ in range(2)]
        a, b = (port.tree.tree_leaves(r) for r in runs)
        if not all(torch.equal(x, y) for x, y in zip(a, b, strict=True)) \
                or a[0].dtype != torch.bfloat16:
            raise AssertionError(f"[mm-parity] {arch} bf16 forward on the "
                                 "card gave different bits on a rerun")
        log(f"[mm-parity] {arch} bf16 forward ({'encdec_forward, 2 x 16 '
            'frames + 40 tokens' if arch == ENC_ARCH else 'forward, 2 x '
            '(8 patches + 40 tokens), cache collected'}) reruns bit for bit"
            " on the card")
    gc.collect()
    torch.cuda.empty_cache()


def _counted(torch, counters, fn, want, what):
    """``fn()`` with every launch counter zeroed just before: its result
    and wall ms; raises unless K1 and K9 launched ``want`` times."""
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = (counters["K1"].launches, counters["K9"].launches)
    if got != tuple(want):
        raise AssertionError(f"{what} launched (K1, K9) {got}, not {want}")
    return out, ms


def _finite(torch, *tensors):
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def phase_vlm_serve(torch, port, serving, counters, card):
    """Phase 4l: InternVL2-26B at full width, VLM_SERVE_LAYERS of 48
    layers: 8 Poisson text requests through the continuous engine (the
    reference serves a vlm's text through ``lm.prefill``; exactly 7 L K1
    and 2 L + 1 K9 launches per forward call), then VLM_ROWS image prompts
    (256 patch embeddings from ``random_frontend_embeds`` + VLM_TEXT
    tokens) through ``steps.make_prefill_step`` on the engine's bf16
    params, timed (the same exact launches) and traced, their caches
    inserted into the engine's 4 slots with ``lm.cache_insert``, and
    MM_DECODE_STEPS greedy decode steps (finite logits, exact launches);
    last a decode step of the 4 slots traced against its byte floor.
    Returns (serving launches, {kernel: {prompt rows: launches a prefill
    call}} with the image prefill's rows, the traced decode step's and
    image prefill's {kernel: device ms})."""
    import numpy as np
    lm = port.lm
    tag = "vlm-serve"
    cfg = dataclasses.replace(port.configs.get_config(VLM_ARCH),
                              num_layers=VLM_SERVE_LAYERS)
    L, P, T, R = cfg.num_layers, cfg.num_frontend_tokens, VLM_TEXT, VLM_ROWS
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    n_params = sum(t.numel() for t in port.tree.tree_leaves(params))
    eng = serving.make_serve_engine(params, cfg, serving.ServeConfig(
        slots=R, max_seq=P + T + MM_DECODE_STEPS + 16), device="cuda")
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name} full width, {L} of 48 layers ({n_params} "
        f"params f32 + bf16 compute copy; {P} patch tokens an image), ready"
        f" in {time.perf_counter() - t0:.1f} s")
    eng.generate(np.zeros((1, 8), np.int32), 2)   # warm-up
    reqs = serving.poisson_requests(8, rate_rps=50, seed=0,
                                    vocab_size=cfg.vocab_size)
    events, launches, calls, decode_ms, peak, pre = _serve(
        torch, eng, reqs, counters)
    per_call = {"K1": dense_per_layer(cfg) * L,
                "K9": norms_per_layer(cfg) * L + 1}
    _report(events, 8, eng, calls, launches, per_call, decode_ms, peak,
            card, tag)

    gen = torch.Generator("cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (R, T),
                                     generator=gen, device="cuda"),
             "frontend_embeds": port.frontends.random_frontend_embeds(
                 gen, cfg, R, device="cuda")}
    prefill = port.steps.make_prefill_step(cfg)

    def image_prefill():
        with torch.inference_mode():
            return prefill(eng.params, batch)
    rows = R * (P + T)
    _, pre_ms = _counted(torch, counters, image_prefill, per_call.values(),
                         f"[{tag}] the image prefill")
    for k, n in per_call.items():
        pre[k].setdefault(rows, []).append(n)
    (last, caches), traced_ms, prof = _traced(torch, image_prefill,
                                              cpu=False)
    pf, pf_n, pf_busy = _lm_profile(torch, port, prof)
    if not _finite(torch, last, *port.tree.tree_leaves(caches)):
        raise AssertionError(f"[{tag}] non-finite image prefill")
    log(f"[{tag}] {R} image prompts ({P} patches + {T} tokens each, "
        f"{rows} rows) through steps.make_prefill_step: {pre_ms:.3f} ms, "
        f"then {traced_ms:.3f} traced (K1 {per_call['K1']}, "
        f"K9 {per_call['K9']} launches each; the patch projection a "
        f"torch.matmul) ({card})")
    what = "traced image prefill"
    _log_profile(tag, what, traced_ms, pf, pf_n, pf_busy)

    sl = lm.DecodeCache(layers=caches, lengths=torch.full(
        (R,), P + T, dtype=torch.int32, device="cuda"))
    for slot in range(R):
        eng.insert(sl, slot, row=slot)
    head = eng.params["lm_head"]["table"]
    tok = (last @ head.T).argmax(-1).cpu().numpy()
    walls = []
    for i in range(MM_DECODE_STEPS):
        (logits, _), ms = _counted(
            torch, counters, lambda: eng.decode(tok), per_call.values(),
            f"[{tag}] decode step {i}")
        if not _finite(torch, logits):
            raise AssertionError(f"[{tag}] non-finite decode logits")
        walls.append(ms)
        tok = logits[:, 0].argmax(-1).cpu().numpy()
    lens = eng.cache.lengths.tolist()
    if lens != [P + T + MM_DECODE_STEPS] * R:
        raise AssertionError(f"[{tag}] slot lengths {lens}")
    log(f"[{tag}] the image prompts' caches inserted into the engine's {R}"
        f" slots, {MM_DECODE_STEPS} greedy decode steps (lengths {lens}): "
        f"median {np.median(walls):.3f} ms, fastest {min(walls):.3f} ms a "
        f"step, exact launches each ({card})")
    dec = _decode_trace(torch, port, eng, tok, tag)
    del params, eng, sl, caches, last, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, pre, dec, pf


def phase_encdec_serve(torch, port, counters, card):
    """Phase 4n's serving half: SeamlessM4T-large-v2 at full width and
    all 24 + 24 layers from a seed (a bf16 compute copy, as the engine
    holds): ``encode`` of ENC_ROWS x 4096 frames and ``_decode_stack`` of
    an ENC_PREFIX-token prefix, each timed (exact launches,
    ``enc_serve_launches``) and traced; the cross cache filled from the
    memory (``fill_cross``), the prefix decoded a token at a time (each
    position's logits beside the stack's, the difference printed) and
    MM_DECODE_STEPS greedy steps (finite, exact launches), one of them
    traced against its byte floor.  Returns ({part: (K1, K9) launches of
    one call}, the decode steps' (K1, K9) launches in all, {part: traced
    {kernel: device ms}})."""
    import numpy as np
    encdec = port.encdec
    tag = "enc-serve"
    cfg = port.configs.get_config(ENC_ARCH)
    L, R, F, Tp = cfg.num_layers, ENC_ROWS, cfg.num_frontend_tokens, \
        ENC_PREFIX
    want = {k: (sum(m.values()), n9)
            for k, (m, n9) in enc_serve_launches().items()}
    t0 = time.perf_counter()
    params = encdec.init_encdec_params(
        cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in port.tree.tree_leaves(params))
    cp = port.lm.compute_params(params, cfg)
    del params
    gc.collect()
    gen = torch.Generator("cuda").manual_seed(1)
    frames = port.frontends.random_frontend_embeds(gen, cfg, R,
                                                   device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (R, Tp), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name} full width and depth ({cfg.num_encoder_layers}"
        f" + {L} layers, {n_params} params from init_encdec_params; "
        f"ModelConfig.param_count() {cfg.param_count()} leaves out the "
        f"decoder's cross-attention), bf16 compute copy, ready in "
        f"{time.perf_counter() - t0:.1f} s")
    dev, out, laps = {}, {}, [time.perf_counter()]
    with torch.inference_mode():
        encdec.encode(cp, frames[:1, :64], cfg)       # warm-up
        for part, fn in (
                ("encode", lambda: encdec.encode(cp, frames, cfg)),
                ("prefill", lambda: encdec._decode_stack(
                    cp, encdec.embed_tokens(cp, toks, cfg), out["encode"],
                    cfg))):
            out[part], ms = _counted(torch, counters, fn, want[part],
                                     f"[{tag}] {part}")
            _, traced_ms, prof = _traced(torch, fn, cpu=False)
            dev[part], n, busy = _lm_profile(torch, port, prof)
            if not _finite(torch, out[part]):
                raise AssertionError(f"[{tag}] non-finite {part}")
            what = f"{R} x {F} frames" if part == "encode" else \
                f"{R} x {Tp} tokens against the memory"
            log(f"[{tag}] {part} ({what}): {ms:.3f} ms, then {traced_ms:.3f}"
                f" traced (K1 {want[part][0]}, K9 {want[part][1]} launches "
                f"each) ({card})")
            _log_profile(tag, f"traced {part}", traced_ms, dev[part], n,
                         busy)
            laps.append(time.perf_counter())
        memory, hidden = out["encode"], out["prefill"]
        table = cp["embed"]["table"]
        cache = encdec.init_encdec_cache(cfg, R, Tp + MM_DECODE_STEPS + 8, F,
                                         device="cuda")
        fill_cross(port, cp, cfg, cache, memory)
        prefix, walls = 0.0, []
        for i in range(Tp + MM_DECODE_STEPS):
            tok = toks[:, i:i + 1] if i < Tp else nxt
            (lo, _), ms = _counted(
                torch, counters,
                lambda: encdec.encdec_decode_step(cp, cache, i, tok, cfg),
                want["decode"], f"[{tag}] decode step {i}")
            if i < Tp:
                ref = (hidden[:, i] @ table.T).float()
                prefix = max(prefix, float((lo[:, 0] - ref).abs().max()))
            else:
                walls.append(ms)
            if not _finite(torch, lo):
                raise AssertionError(f"[{tag}] non-finite decode logits")
            nxt = lo[:, 0].argmax(-1, keepdim=True)
        steps = Tp + MM_DECODE_STEPS
        laps.append(time.perf_counter())
        (lo, _), traced_ms, prof = _traced(
            torch, lambda: encdec.encdec_decode_step(cp, cache, steps, nxt,
                                                     cfg), cpu=False)
    dev["decode"], n, busy = _lm_profile(torch, port, prof)
    laps.append(time.perf_counter())
    xa = cp["decoder"]["cross_attn"]
    read = [t for k, sub in cp["decoder"].items() if k != "cross_attn"
            for t in port.tree.tree_leaves(sub)] + [
        xa["wq"]["w"], xa["wo"]["w"], cp["final_norm"]["scale"], table,
        cache["cross_k"], cache["cross_v"]]
    kv = cache["kv"]["k"]
    kv_bytes = 2 * kv[:, :, :steps + 1].numel() * kv.element_size()
    floor = sum(t.numel() * t.element_size() for t in read) + kv_bytes
    floor_ms = floor / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] the {Tp}-token prefix decoded a token at a time against "
        f"the filled cross cache: logits max_abs_diff {prefix:.4g} from "
        f"_decode_stack's at every position (bf16, the order of sums and "
        f"the cross scores' division differ); then {MM_DECODE_STEPS} greedy"
        f" steps: median {np.median(walls):.3f} ms, fastest "
        f"{min(walls):.3f} ms ({card})")
    log(f"[{tag}] decode step, {R} rows: byte floor {floor / 1e9:.3f} GB "
        f"(the decoder's bf16 leaves it reads, the head's table, the cross "
        f"K/V {2 * cache['cross_k'].numel() * 2 / 1e9:.3f} GB, the self "
        f"cache's live positions) = {floor_ms:.3f} ms at 3.35 TB/s; device "
        f"busy {busy:.3f} ms"
        + (f" (the floor is {floor_ms / busy:.1%} of it)" if busy else ""))
    _log_profile(tag, "traced decode step", traced_ms, dev["decode"], n,
                 busy)
    log(f"[{tag}] host seconds: " + ", ".join(
        f"{what} {b - a:.1f}" for what, a, b in zip(
            ("encode timed and traced", "prefill timed and traced",
             f"{steps} decode steps", "one traced"), laps, laps[1:])))
    launches = tuple(v * steps for v in want["decode"])
    del cp, cache, memory, hidden, out, frames
    gc.collect()
    torch.cuda.empty_cache()
    return want, launches, dev


def phase_encdec_train(torch, port, mods, card, steps=MM_STEPS):
    """Phase 4n's training half: Seamless at full width and depth,
    ``steps`` steps of ``steps.make_train_step`` (AdamW at LM_LR, clip
    1.0) at B 8 x (512 frames + 128 text tokens), the text from
    ``lm_corpus`` over MM_CORPUS_VOCAB ids, the frames one seeded draw:
    exactly ``mm_train_launches``' K1-K3 and K9 launches a step, every
    grad leaf nonzero at the initial params, the held-out batch's CE read
    every HELD_EVERY steps falling by more than MM_MIN_FALL; a step
    traced after a warm-up one (no f32 dense kernel, K2/K3 on wgmma).
    Returns (launches over the steps, the traced step's {kernel: device
    ms})."""
    import numpy as np
    encdec, pipeline = port.encdec, port.pipeline
    tag = "enc-train"
    cfg = port.configs.get_config(ENC_ARCH)
    B, T, F = LM_BATCH, LM_SEQ, ENC_TRAIN_FRAMES
    lmap = mm_train_launches()["encdec"]
    expect = {k: sum(lmap[k].values()) for k in ("K1", "K2", "K3")}
    expect["K9"] = expect["K9 bwd"] = sum(lmap["K9 bwd"].values())
    params = encdec.init_encdec_params(
        cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    n_params = sum(p.numel() for p in port.tree.tree_leaves(params))
    frames = port.frontends.random_frontend_embeds(
        torch.Generator("cuda").manual_seed(1),
        dataclasses.replace(cfg, num_frontend_tokens=F), B, device="cuda")
    corpus = port.synthetic.lm_corpus((steps + 3) * B * T + 1,
                                      MM_CORPUS_VOCAB, seed=0)
    rows = torch.as_tensor(pipeline.pack_sequences(corpus, T), device="cuda")
    batches = [dict(pipeline.host_batch(rows[i * B:(i + 1) * B]),
                    frontend_embeds=frames) for i in range(steps + 3)]

    def held_out(p):
        with torch.no_grad():
            loss, _ = encdec.encdec_loss_fn(p, batches[-1], cfg)
        return float(loss)
    step = port.steps.make_train_step(cfg, learning_rate=LM_LR, grad_clip=1.0)
    state = port.optim.make_optimizer("adamw").init(params)
    _, grads = port.trainer.value_and_grad(
        lambda p, b: encdec.encdec_loss_fn(p, b, cfg), params, batches[0])
    zero = [i for i, g in enumerate(port.tree.tree_leaves(grads))
            if not bool(g.abs().sum() > 0)]
    if zero:
        raise AssertionError(f"[{tag}] grad leaves {zero} are all zero")
    del grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    laps = [time.perf_counter()]
    held, losses, step_ms = [(0, held_out(params))], [], []
    launches = dict.fromkeys(expect, 0)
    _zero_lm_counts(mods)
    for i in range(steps):
        before = _lm_counts(mods)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per = {k: v - before[k] for k, v in _lm_counts(mods).items()}
        if per != expect:
            raise AssertionError(f"[{tag}] step {i}: launches {per} != "
                                 f"{expect}")
        launches = {k: launches[k] + per[k] for k in expect}
        losses.append(float(m["loss"]))
        if (i + 1) % HELD_EVERY == 0 or i + 1 == steps:
            held.append((i + 1, held_out(params)))
    peak = torch.cuda.max_memory_allocated()
    (_, h0), (_, h1) = held[0], held[-1]
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}; held-out CE after"
        " step " + ", ".join(f"{i}: {c:.6f}" for i, c in held))
    if not (np.isfinite(losses).all() and h0 - h1 > MM_MIN_FALL):
        raise AssertionError(f"[{tag}] losses not finite, or the held-out CE"
                             f" did not fall by more than {MM_MIN_FALL} "
                             f"({h0} -> {h1})")
    laps.append(time.perf_counter())
    (params, state, _), wall_ms, prof = _traced(
        torch, lambda: step(params, state, batches[steps]), cpu=False)
    dev_ms, counts, busy_ms = _lm_profile(torch, port, prof)
    laps.append(time.perf_counter())
    f32 = {k: counts.get(k, 0) for k in ("K1 f32", "K2 f32", "K3 f32")}
    tile = {k: counts.get(f"{k} tile", 0) for k in ("K2", "K3")}
    if any(f32.values()) or any(tile.values()):
        raise AssertionError(f"[{tag}] f32 dense kernels {f32} or K2/K3 off"
                             f" the wgmma route {tile} in the traced step")
    mean = float(np.mean(step_ms[1:]))
    log(f"[{tag}] {cfg.name} full width and depth ({n_params} params f32),"
        f" B={B} x ({F} frames + {T} tokens from lm_corpus over "
        f"{MM_CORPUS_VOCAB} of {cfg.vocab_size} ids), AdamW lr {LM_LR:g}, "
        f"grad_clip 1.0, {steps} steps of steps.make_train_step; launches "
        f"{launches} = {steps} x {expect}; card: {card}")
    log(f"[{tag}] step mean {mean:.3f} ms over steps 2-{steps} (first "
        f"{step_ms[0]:.3f} ms), {B * (F + T) / mean * 1e3:.1f} positions/s |"
        f" max_memory_allocated {peak / 1e9:.3f} GB ({card})")
    _log_profile(tag, "profiled step (after a warm-up one)", wall_ms,
                 dev_ms, counts, busy_ms)
    log(f"[{tag}] host seconds: {steps} steps and the held-out readings "
        f"{laps[1] - laps[0]:.1f}, a step traced {laps[2] - laps[1]:.1f}")
    del params, state, batches, rows
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dev_ms


# the served archs' kernels-line prefix and phase (4i, 4j, 4l, 4o)
SERVED = {**SSM_SERVE, VLM_ARCH: ("internvl", "4l"),
          STABLE_ARCH: ("stablelm", "4o")}
# Seamless's parts on the kernels line (4n)
ENC_PARTS = {"decode": "seamless", "encode": "seamless_encode",
             "prefill": "seamless_prefill"}
ENC_WHAT = {"decode": f"one decode step of {ENC_ROWS} rows",
            "encode": f"one encode of {ENC_ROWS} x {ENC_FRAMES} frames",
            "prefill": f"one _decode_stack of {ENC_ROWS} x {ENC_PREFIX} "
                       "tokens (its cross k/v project the memory)"}


def prefill_what(arch) -> str:
    """The kernels line's name of ``arch``'s prefill instance."""
    if arch == VLM_ARCH:
        return (f"image prefill of {VLM_ROWS} x ({VLM_PATCHES} patches + "
                f"{VLM_TEXT} tokens) through steps.make_prefill_step")
    return f"prefill forward of {PREFILL_ROWS[arch]} tokens"


def mm_train_work(fam, key) -> str:
    """The kernels line's ``work`` of ``key``'s instance in 4m or 4n."""
    n = sum(mm_train_launches()[fam][key].values())
    what = "K9's backward in " if key == "K9 bwd" else ""
    if fam == "vlm":
        return (f"{what}one {VLM_ARCH} training step at full width, "
                f"{VLM_TRAIN_LAYERS} layers, B=8 x ({VLM_PATCHES} patches "
                f"+ {LM_SEQ} tokens) (phase 4m): {n} bf16 launches at "
                + (f"{VLM_TRAIN_ROWS} x {VLM_D}" if key == "K9 bwd" else
                   f"M={VLM_TRAIN_ROWS}"))
    return (f"{what}one {ENC_ARCH} training step at full width and depth, "
            f"B=8 x ({ENC_TRAIN_FRAMES} frames + {LM_SEQ} tokens) (phase "
            f"4n, steps.make_train_step): {n} bf16 launches at M="
            f"{ENC_TRAIN_ROWS[0]} (encoder, cross k/v) and "
            f"{ENC_TRAIN_ROWS[1]} (decoder)")


def phase_stablelm_serve(torch, port, serving, counters, card):
    """Phase 4o: StableLM-2-12B at full width, STABLE_LAYERS of 40 layers,
    through ``serve_family`` (8 Poisson requests, 7 L K1 and 2 L + 1 K9
    launches per forward call, a 4-slot decode step traced against its
    byte floor, a PREFILL_ROWS-token prompt's prefill traced)."""
    cfg = dataclasses.replace(port.configs.get_config(STABLE_ARCH),
                              num_layers=STABLE_LAYERS)
    return serve_family(torch, port, serving, counters, card, cfg,
                        PREFILL_ROWS[STABLE_ARCH], "stablelm-serve", None,
                        f"head_dim {cfg.head_dim}, {cfg.num_heads} q and "
                        f"{cfg.num_kv_heads} kv heads")


def phases_mm(torch, port, serving, counters, mods, card):
    """Phases 4l-4o in order, each one's host seconds logged; returns what
    each returns."""
    out, laps = [], [time.perf_counter()]
    for run in (
            lambda: phase_vlm_serve(torch, port, serving, counters, card),
            lambda: phase_lm_step(torch, port, mods, card, VLM_ARCH,
                                  VLM_TRAIN_LAYERS, "vlm-train", MM_STEPS,
                                  MM_MIN_FALL, MM_CORPUS_VOCAB),
            lambda: phase_encdec_serve(torch, port, counters, card),
            lambda: phase_encdec_train(torch, port, mods, card),
            lambda: phase_stablelm_serve(torch, port, serving, counters,
                                         card)):
        out.append(run())
        laps.append(time.perf_counter())
    log("[time] host seconds: " + ", ".join(
        f"{p} {b - a:.1f}" for p, a, b in zip(
            ("4l", "4m", "4n serving", "4n training", "4o"), laps,
            laps[1:])))
    return tuple(out)


# ----------------------------------------------------------------------
# Checkpoints, resume, the chaos worker, the sanitizer, the BPT-CNN example and the
# cluster simulator (phase 4p)
# ----------------------------------------------------------------------
CKPT_NODES = 4
CKPT_LOCAL_STEPS = 2
CKPT_DURS = (1.0, 1.25, 1.5, 1.75)      # heap: pinned local-round seconds
# engine -> (rounds, checkpoint every N events, break after N events)
CKPT_RUNS = {"vmap": (6, 2, 3), "heap": (4, 4, 8)}
SYNC_LABELS = {"vmap": ["upload", "round.losses"],
               "heap": ["upload"] * CKPT_LOCAL_STEPS + ["local-round.loss"]}
WORKER = ROOT / "tests" / "torch_chaos_worker.py"
WORKER_ROUNDS = 4
WORKER_NODES = 2                           # 4p(b): a state of 5 c_w an event
EXAMPLE = ROOT / "examples" / "train_bpt_cnn_torch.py"
SIM_ROWS = 16                              # 4p(f): a work unit's batch
SIM_TOL = 1e-5


def step_launches(cnn, cfg) -> tuple[dict, dict]:
    """K1-K8 launches of one training step and of one forward (an eval)
    of ``cfg``: a dense layer is K1 forward, K2 and K3 backward; a conv
    K4, K5 (but the first, whose input is the image) and K6; a pool K7
    and K8."""
    shapes, _ = cnn._conv_shapes(cfg)
    pools = sum(pooled for *_, pooled in shapes)
    fc, cv = cfg.fc_layers, cfg.conv_layers
    step = {"K1": fc, "K2": fc, "K3": fc, "K4": cv, "K5": cv - 1, "K6": cv,
            "K7": pools, "K8": pools}
    return step, {"K1": fc, "K4": cv, "K7": pools}


def _import_path(path, name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(torch, a, b, tree) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        tree.tree_leaves(a), tree.tree_leaves(b), strict=True))


def _ckpt_trainer(port, cfg, params, data, name):
    """Case7 on CKPT_NODES nodes, one IDPA batch (the allocation is fixed,
    so the measured clock moves no weight), AdamW, B = 64; ``heap`` with
    each node's local-round duration pinned at CKPT_DURS, so its event
    order is fixed."""
    xs, ys = data
    ds = port.pipeline.IDPADataset({"images": xs, "labels": ys},
                                   num_nodes=CKPT_NODES, batches=1)
    kw = port.engine.engine_config(name, outer_nodes=CKPT_NODES,
                                   local_steps=CKPT_LOCAL_STEPS,
                                   warmup_steps=5, total_steps=100, seed=0)
    tr = port.trainer.BPTTrainer(
        lambda p, b: (port.cnn.cnn_loss(p, b, cfg), {}), params, ds,
        _train_cfg(port.types, **kw), batch_size=TRAIN_BATCH)
    if name == "heap":
        orig = tr._local_round

        def pin(p, opt, node, step):
            p, opt, loss, _ = orig(p, opt, node, step)
            return p, opt, loss, CKPT_DURS[node]

        tr._local_round = pin
    return tr


def _timed(fn, store):
    def wrapped(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        store.append(time.perf_counter() - t0)
        return out
    return wrapped


def _crash_resume(torch, port, make, runs, ckdir):
    """The stream of ``runs`` = (rounds, checkpoint every N events, break
    after N events) broken, then a fresh trainer resumed from the latest
    state checkpoint (and checkpointing no more): (resumed events, save
    seconds, restore seconds, resumed-from step)."""
    rounds, every, stop = runs
    saves, restores = [], []
    crashed = make()
    crashed._save_run_state = _timed(crashed._save_run_state, saves)
    hooks = port.engine.TrainHooks(checkpoint_every=every,
                                   checkpoint_dir=ckdir)
    for n, _ in enumerate(crashed.run(rounds, hooks), 1):
        if n >= stop:
            break
    del crashed
    resumed = make()
    resumed._restore_run = _timed(resumed._restore_run, restores)
    hooks = port.engine.TrainHooks(checkpoint_dir=ckdir, resume=True)
    evs = list(resumed.run(rounds, hooks))
    torch.cuda.synchronize()
    return evs, saves, restores, (stop // every) * every


def phase_ckpt(torch, port, mods, card):
    """Phase 4p: (a) case7 crash and resume under ``vmap`` and ``heap``,
    bit for bit; (b) the chaos worker SIGKILLed and resumed; (c) the
    training CLI's ``--ckpt-every`` / ``--resume`` flows on reduced Phi-3;
    (d) (a) again with the sanitizer armed; (e) the BPT-CNN example at its
    defaults; (f) the cluster simulator training case7 on the card and on
    the CPU.  Returns the K1-K8 launches of (a)'s uninterrupted runs and
    of (e), and the K1-K3, K9 launches of (c)."""
    import contextlib
    import functools
    import io
    import shutil
    import signal
    import tempfile
    import numpy as np
    from repro_torch import sanitize
    cnn, tree = port.cnn, port.tree
    cfg = cnn.make_case("case7")
    params = cnn.init_cnn(cfg, torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    c_w = sum(p.numel() * p.element_size() for p in tree.tree_leaves(params))
    data = port.synthetic.image_dataset(64 * CKPT_NODES * 2,
                                        size=cfg.image_size, seed=0)
    per_step, _ = step_launches(cnn, cfg)
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_4p_")
    log(f"[ckpt] checkpoints under {root}: "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB free")
    try:
        # (a) the uninterrupted runs: this phase's main path, counted
        t0 = time.perf_counter()
        ref = {}
        _zero_counts(mods)
        for name in CKPT_RUNS:
            evs = list(_ckpt_trainer(port, cfg, params, data, name).run(
                CKPT_RUNS[name][0]))
            ref[name] = ([e.loss for e in evs], evs[-1].params, len(evs))
        torch.cuda.synchronize()
        out["ckpt"] = _counts(mods)
        steps = (ref["vmap"][2] * CKPT_NODES + ref["heap"][2]) \
            * CKPT_LOCAL_STEPS
        want = {k: steps * n for k, n in per_step.items()}
        if out["ckpt"] != want:
            raise AssertionError(f"[ckpt] launches {out['ckpt']} != {want}")
        log(f"[ckpt] case7 full width ({c_w // 4} params f32, c_w {c_w} B),"
            f" {CKPT_NODES} nodes, one IDPA batch, {CKPT_LOCAL_STEPS} local"
            f" steps of B={TRAIN_BATCH}: uninterrupted vmap "
            f"{ref['vmap'][2]} rounds and heap {ref['heap'][2]} pushes "
            f"(durations pinned at {CKPT_DURS} s) in "
            f"{time.perf_counter() - t0:.2f} s; K1-K8 launches "
            f"{out['ckpt']} = {steps} local steps x {per_step} (exact); "
            f"card: {card}")
        for name, (rounds, every, stop) in CKPT_RUNS.items():
            make = functools.partial(_ckpt_trainer, port, cfg, params, data,
                                     name)
            ckdir = os.path.join(root, f"a-{name}")
            t0 = time.perf_counter()
            evs, saves, restores, start = _crash_resume(
                torch, port, make, CKPT_RUNS[name], ckdir)
            losses, final, n = ref[name]
            same = _bits(torch, evs[-1].params, final, tree)
            trail = [e.loss for e in evs] == losses[start:]
            if not (same and trail and len(evs) == n - start):
                raise AssertionError(
                    f"[ckpt] {name}: resumed run is not the uninterrupted "
                    f"one: weights equal {same}, loss trail equal {trail}, "
                    f"{len(evs)} events after {start}")
            st = os.path.getsize(os.path.join(ckdir,
                                              f"state_{start:08d}.npz"))
            wt = os.path.getsize(os.path.join(ckdir,
                                              f"ckpt_{start:08d}.npz"))
            log(f"[ckpt] {name}: checkpoint every {every} events, broke "
                f"after {stop} of {n}, a fresh trainer (checkpointing no "
                f"more) resumed from event "
                f"{start}: final merged weights and the loss trail "
                f"bit-identical to the uninterrupted card run; state "
                f"checkpoint {st} B ({st / c_w:.2f} c_w), weight checkpoint "
                f"{wt} B; state saves {[round(s, 3) for s in saves]} s, "
                f"restore {[round(s, 3) for s in restores]} s; crash + "
                f"resume {time.perf_counter() - t0:.2f} s ({card})")
            shutil.rmtree(ckdir)
        gc.collect()

        # (b) the chaos worker's job uninterrupted here, then the worker
        # killed and resumed
        t0 = time.perf_counter()
        worker = _import_path(WORKER, "torch_chaos_worker")
        argv = ["--device", "cuda", "--case", "case7", "--nodes",
                str(WORKER_NODES), "--rounds", str(WORKER_ROUNDS)]
        kill_dir = os.path.join(root, "b-kill")
        w_ref = list(worker.build_trainer(
            WORKER_NODES, device="cuda", case="case7").run(
                WORKER_ROUNDS))[-1].params
        env = dict(os.environ)
        env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, str(WORKER), *argv, "--ckpt-dir", kill_dir]
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, text=True)
        seen = 0
        for line in proc.stdout:
            if line.startswith("EVENT"):
                seen += 1
                if seen >= 3:
                    os.kill(proc.pid, signal.SIGKILL)
                    break
        proc.wait(timeout=120)
        proc.stdout.close()
        if proc.returncode != -signal.SIGKILL:
            raise AssertionError(f"[ckpt-kill] worker exited "
                                 f"{proc.returncode}, not by SIGKILL")
        killed_at = port.checkpoint.latest_step(kill_dir, kind="state")
        res = subprocess.run(cmd + ["--resume"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0 or "DONE" not in res.stdout:
            raise AssertionError(f"[ckpt-kill] resume exited "
                                 f"{res.returncode}:\n{res.stderr[-4000:]}")
        w_res, _ = port.checkpoint.restore(kill_dir, w_ref,
                                           step=worker.FINAL_STEP)
        diff = max(float((a - b).abs().max()) for a, b in zip(
            tree.tree_leaves(w_ref), tree.tree_leaves(w_res), strict=True))
        if diff > 1e-5:
            raise AssertionError(f"[ckpt-kill] resumed weights differ by "
                                 f"{diff}")
        log(f"[ckpt-kill] tests/torch_chaos_worker.py --case case7 (vmap, "
            f"{WORKER_NODES} nodes, {WORKER_ROUNDS} rounds, a weight and a "
            f"state checkpoint every event): SIGKILLed after its 3rd event "
            f"(state checkpoint at {killed_at} on disk), resumed by a "
            f"second process: final weights max_abs_diff {diff:.3g} from "
            f"the job run uninterrupted here (bound 1e-5; "
            f"{'exact' if diff == 0 else 'not exact'}) in "
            f"{time.perf_counter() - t0:.2f} s ({card})")
        shutil.rmtree(kill_dir)

        # (c) the training CLI: run, re-run (nothing new), extended
        t0 = time.perf_counter()
        lm_cfg = port.configs.get_reduced(LM_ARCH)
        lm_params = port.lm.init_params(
            lm_cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
        ckdir = os.path.join(root, "c-cli")
        argv = ["--arch", LM_ARCH, "--device", "cuda", "--nodes", "2",
                "--rows", "64", "--seq-len", "32", "--ckpt-dir", ckdir,
                "--ckpt-every", "2", "--resume"]
        _zero_lm_counts(mods)
        reps, files = [], []
        for rounds in (1, 1, 2):
            reps.append(_drive(port, argv + ["--rounds", str(rounds)],
                               lm_cfg, lm_params))
            files.append(sorted(os.listdir(ckdir)))
        torch.cuda.synchronize()
        out["cli"] = _lm_counts(mods)
        if not all(out["cli"][k] for k in ("K1", "K2", "K3", "K9")):
            raise AssertionError(f"[ckpt-cli] a kernel of the path never "
                                 f"launched: {out['cli']}")
        last = [r.last_event for r in reps]
        if last != [2, 0, 4] or reps[1].losses or files[0] != files[1] \
                or port.checkpoint.latest_step(ckdir) != 4 \
                or not all(np.isfinite(r.losses).all() for r in reps):
            raise AssertionError(f"[ckpt-cli] last events {last}, files "
                                 f"{files}, losses "
                                 f"{[r.losses for r in reps]}")
        log(f"[ckpt-cli] launch/train.py --arch {LM_ARCH} (reduced) on 2 "
            f"nodes with --ckpt-every 2 --resume: 1 round (last_event "
            f"{last[0]}), the same command again (no new event, no new "
            f"file), then --rounds 2 (events 2-3, the heap re-seeded; final "
            f"ckpt step {port.checkpoint.latest_step(ckdir)} = last_event "
            f"{last[2]}); losses {[round(x, 4) for x in reps[2].losses]}; "
            f"K1-K3 and K9 launches {out['cli']} in "
            f"{time.perf_counter() - t0:.2f} s ({card})")
        shutil.rmtree(ckdir)
        del lm_params, reps
        gc.collect()

        # (d) (a)'s uninterrupted runs again with the sanitizer armed
        t0 = time.perf_counter()
        os.environ["REPRO_SANITIZE"] = "1"
        try:
            for name, (rounds, _, _) in CKPT_RUNS.items():
                sanitize.clear_sync_log()
                with sanitize.compile_budget(0, label=f"4p(d) {name}"):
                    evs = list(_ckpt_trainer(port, cfg, params, data,
                                             name).run(rounds))
                    torch.cuda.synchronize()
                losses, final, n = ref[name]
                if not _bits(torch, evs[-1].params, final, tree) or \
                        [e.loss for e in evs] != losses:
                    raise AssertionError(f"[ckpt-sanitize] {name}: armed "
                                         "run differs from the unarmed one")
                labels = sanitize.sync_log()
                if labels != SYNC_LABELS[name] * n:
                    raise AssertionError(f"[ckpt-sanitize] {name}: sync log "
                                         f"{sorted(set(labels))} x "
                                         f"{len(labels)}")
                log(f"[ckpt-sanitize] {name} with REPRO_SANITIZE=1: {n} "
                    f"events, final weights and the loss trail bit-identical"
                    f" to the unarmed run; sync_log {len(labels)} entries, "
                    f"each event {SYNC_LABELS[name]}; compile_budget(0) "
                    "held")
            x = torch.ones(4, device="cuda")
            try:
                with sanitize.sanitized("4p(d)"):
                    float((x * 2).sum())
            except RuntimeError as e:
                caught = str(e).splitlines()[0]
            else:
                raise AssertionError("[ckpt-sanitize] an implicit sync "
                                     "inside sanitized() did not raise")
            log(f"[ckpt-sanitize] an implicit float() of a card tensor "
                f"inside sanitized() raised: {caught!r}; 4p(d) "
                f"{time.perf_counter() - t0:.2f} s ({card})")
        finally:
            os.environ.pop("REPRO_SANITIZE", None)
            sanitize.clear_sync_log()
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (e) the BPT-CNN example at its defaults
    t0 = time.perf_counter()
    example = _import_path(EXAMPLE, "train_bpt_cnn_torch")
    _zero_counts(mods)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = example.main(["--device", "cuda"])
    torch.cuda.synchronize()
    out["example"] = _counts(mods)
    wall = time.perf_counter() - t0
    dcfg = cnn.CNNConfig(name="case2-wide", image_size=32, conv_layers=4,
                         filters=4, fc_layers=3, fc_neurons=2000)
    d_step, d_eval = step_launches(cnn, dcfg)
    n_steps = rep.steps * 3                 # pushes x the example's 3 steps
    n_evals = rep.steps + len(rep.accuracies)   # Eq. 10's Q, the cadence
    want = {k: n_steps * n + n_evals * d_eval.get(k, 0)
            for k, n in d_step.items()}
    if out["example"] != want:
        raise AssertionError(f"[bpt-cnn] launches {out['example']} != {want}")
    acc = rep.accuracies[-1][1]
    lines = buf.getvalue().splitlines()
    log("[bpt-cnn] " + " | ".join(
        ln for ln in lines if not ln.startswith("[bpt-cnn]   event")))
    trail = [re.search(r"loss=(\S+) clock=(\S+)s", ln).groups()
             for ln in lines if ln.startswith("[bpt-cnn]   event")]
    log(f"[bpt-cnn] per event (loss, virtual clock s): "
        f"{[(float(a), float(b)) for a, b in trail]}")
    log(f"[bpt-cnn] examples/train_bpt_cnn_torch.py at its defaults: "
        f"{rep.steps} AGWU pushes, {n_steps} local steps, final accuracy "
        f"{acc:.3f} (floor 0.3) in {wall:.2f} s; K1-K8 launches a local "
        f"step {d_step} (exact: {out['example']} = {n_steps} steps x that + "
        f"{n_evals} evals x {d_eval}) ({card})")
    dparams = cnn.init_cnn(dcfg, torch.Generator("cuda").manual_seed(0),
                           device="cuda")
    xs, ys = port.synthetic.image_dataset(32, size=32, seed=0)
    batch = {"images": torch.as_tensor(xs, device="cuda"),
             "labels": torch.as_tensor(ys, device="cuda")}
    dtc = port.types.TrainConfig(optimizer="adamw", learning_rate=1e-3,
                                 warmup_steps=10, total_steps=240)
    body = port.trainer.make_step_body(
        lambda p, b: (cnn.cnn_loss(p, b, dcfg), {}), dtc)
    opt = port.optim.make_optimizer("adamw").init(dparams)
    ms, names = device_ms(torch, lambda p, o, b: body(p, o, b, 1),
                          [(dparams, opt, batch)], iters=10)
    kern = sum(v for k, v in names.items()
               if any(pat in k for pat, _ in KERNEL_NAMES))
    log(f"[bpt-cnn] one local step (B=32): device {fmt_ms(ms)} ms, of which "
        f"K1-K8 {kern:.4f} ms ({card})")
    del dparams, opt, batch
    gc.collect()

    # (f) the cluster simulator, each work unit one case7 local step
    t0 = time.perf_counter()
    sim_mod = port.cluster_sim
    host = port.weights.params_to_numpy(params)
    xs, ys = port.synthetic.image_dataset(512, size=cfg.image_size, seed=3)
    stc = port.types.TrainConfig(optimizer="sgd", learning_rate=1e-2,
                                 warmup_steps=0, total_steps=10)
    sbody = port.trainer.make_step_body(
        lambda p, b: (cnn.cnn_loss(p, b, cfg), {}), stc)
    for strategy in ("agwu", "sgwu"):
        got = {}
        for dev in ("cuda", "cpu"):
            def worker_train(j, w, idx, it, dev=dev):
                rows = idx[:SIM_ROWS]
                b = {"images": torch.as_tensor(xs[rows], device=dev),
                     "labels": torch.as_tensor(ys[rows], device=dev)}
                w, _, _ = sbody(w, (), b, it + 1)
                return w, 1.0
            sim = sim_mod.ClusterSim(len(xs), [1.0, 1.3, 1.7, 2.2],
                                     iterations=2, batches=1,
                                     strategy=strategy)
            got[dev] = sim.run(init_weights=port.weights.params_from_numpy(
                host, cfg, dev), worker_train=worker_train)
        a, b = got["cuda"], got["cpu"]
        metrics = [(r.makespan, r.sync_wait, r.comm_bytes,
                    r.expected_comm_bytes, r.balance_degree,
                    r.allocation.tolist()) for r in (a, b)]
        diff = max(float(np.abs(x - y).max()) for x, y in zip(
            tree.tree_leaves(port.weights.params_to_numpy(a.final_weights)),
            tree.tree_leaves(port.weights.params_to_numpy(b.final_weights)),
            strict=True))
        if metrics[0] != metrics[1] or diff > SIM_TOL:
            raise AssertionError(f"[cluster-sim] {strategy}: metrics "
                                 f"{metrics} or weights max diff {diff}")
        log(f"[cluster-sim] {strategy}: 4 nodes, 2 iterations, each work "
            f"unit one case7 SGD step at B={SIM_ROWS} on the card: "
            f"{a.summary()} equal to the CPU run's; final weights "
            f"max_abs_diff {diff:.3g} (bound {SIM_TOL})")
    log(f"[cluster-sim] 4p(f) {time.perf_counter() - t0:.2f} s ({card})")
    return out


# ----------------------------------------------------------------------
# The multi-device outer layer (phase 4q): the mesh engines over a pool
# of one card repeated, a mixed card + host pool, and an LM on a 2-D mesh
# ----------------------------------------------------------------------
MULTI_NODES = 4                    # 4q(a) nodes4, 4q(b)
MULTI_HYBRID = "nodes2xmodel2"     # 4q(a)'s 2-D mesh and 4q(d)'s
MULTI_B = 32                       # a node's stripe; the batch family: 2 x 16
MULTI_LOCAL = 2
MULTI_ROUNDS = 2
MULTI_TOL = (1e-5, 1e-6)           # rtol, atol (tests/test_device_outer.py:61)
MIXED_TOL = ((1e-4, 1e-6), (1e-3, 1e-5))   # 4d(a)'s card vs CPU: losses,
#                                            merged params (rtol, atol)
MULTI_DURS = (1.0, 1.25, 1.5, 1.75)        # 4q(b): pinned local rounds (s)
# 4q(b), on 2 nodes: engine -> (rounds, checkpoint every N events, break
# after N events)
MULTI_RUNS = {"device": (4, 2, 3), "heap-device": (3, 2, 5)}
MULTI_LABELS = {"upload", "round.losses", "node-move"}   # 4q's sync_log


def _multi_trainer(port, cfg, params, data, name, m, devices=None, mesh="",
                   family="", model_cfg=None):
    """A CNN on m nodes, one IDPA batch (the allocation is fixed, so the
    measured clock moves no weight), AdamW, B = MULTI_B, MULTI_LOCAL local
    steps, over the pool ``devices``; the heap engines' local rounds
    pinned at MULTI_DURS, so their event order is fixed."""
    xs, ys = data
    ds = port.pipeline.IDPADataset({"images": xs, "labels": ys},
                                   num_nodes=m, batches=1)
    kw = port.engine.engine_config(name, outer_nodes=m,
                                   local_steps=MULTI_LOCAL, warmup_steps=5,
                                   total_steps=100, seed=0, mesh_name=mesh)
    tr = port.trainer.BPTTrainer(
        lambda p, b: (port.cnn.cnn_loss(p, b, cfg), {}), params, ds,
        _train_cfg(port.types, **kw), batch_size=MULTI_B,
        model_cfg=model_cfg, plan_family=family, devices=devices)
    if name in ("heap", "heap-device"):
        orig = tr._local_round

        def pin(p, opt, node, step):
            p, opt, loss, _ = orig(p, opt, node, step)
            return p, opt, loss, MULTI_DURS[node]

        tr._local_round = pin
    return tr


def hybrid_step_launches(step, plan) -> dict:
    """K1-K8 launches of one node step under a 2-D plan: the batch family
    runs the step on each of its K shards; the channel family launches
    K1-K3 once a shard of each column-parallel fc."""
    K = plan.model
    if plan.family == "batch":
        return {k: K * n for k, n in step.items()}
    fc = sum(K if lp.parallel_dim == "channel" else 1
             for lp in plan.layers if lp.kind == "fc")
    return {**step, "K1": fc, "K2": fc, "K3": fc}


def _held(np, tree, tag, got, want, tol_losses, tol_params):
    """Every event's node losses and the final merged weights of ``got``
    within tolerance of ``want``'s; returns the two worst differences."""
    (lr, la), (pr, pa) = tol_losses, tol_params
    ld = pd = 0.0
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.node_losses, b.node_losses, rtol=lr,
                                   atol=la, err_msg=tag)
        ld = max(ld, float(np.abs(a.node_losses - b.node_losses).max()))
    for x, y in zip(tree.tree_leaves(got[-1].params),
                    tree.tree_leaves(want[-1].params), strict=True):
        x, y = (t.detach().float().cpu().numpy() for t in (x, y))
        np.testing.assert_allclose(x, y, rtol=pr, atol=pa, err_msg=tag)
        pd = max(pd, float(np.abs(x - y).max()))
    return ld, pd


def phase_multi(torch, port, mods, card):
    """Phase 4q: (a) case7 on ``nodes4`` and on ``nodes2xmodel2`` under
    the batch and channel families, over four ``cuda:0``, held to ``vmap``
    with exact K1-K8 launches, then armed with the sanitizer; (b) AGWU
    ``heap-device`` held to ``heap``, and resume bit for bit for
    ``device`` and ``heap-device``; (c) a mixed pool [cuda:0, cpu] held to
    the all-card run; (d) Phi-3-mini at full width on ``nodes2xmodel2``
    (the generic batch plan) held to ``vmap``; then the wall and device
    ms a round of ``device`` against ``vmap``.  Returns the K1-K8
    launches of (a)'s runs by family."""
    import functools
    import shutil
    import tempfile
    import numpy as np
    from repro_torch import sanitize
    from repro_torch.core import planner
    cnn, tree, weights = port.cnn, port.tree, port.weights
    cfg = cnn.make_case("case7")
    params = cnn.init_cnn(cfg, torch.Generator("cuda").manual_seed(0),
                          device="cuda")
    c_w = sum(p.numel() * p.element_size() for p in tree.tree_leaves(params))
    data = port.synthetic.image_dataset(MULTI_B * MULTI_NODES * 2,
                                        size=cfg.image_size, seed=0)
    card0 = torch.device("cuda", 0)
    pool = [card0] * MULTI_NODES
    step, _ = step_launches(cnn, cfg)
    out = {}

    def run(name, m, **kw):
        tr = _multi_trainer(port, cfg, params, data, name, m, **kw)
        _zero_counts(mods)
        t0 = time.perf_counter()
        evs = list(tr.run(MULTI_ROUNDS))
        torch.cuda.synchronize()
        return tr, evs, _counts(mods), time.perf_counter() - t0

    def steps_of(m, per):
        return {k: m * MULTI_LOCAL * MULTI_ROUNDS * n for k, n in per.items()}

    # (a) the references, then nodes4 and the 2-D families
    t_a = time.perf_counter()
    ref = {m: run("vmap", m)[1] for m in (MULTI_NODES, 2)}
    log(f"[multi] case7 full width ({c_w // 4} params f32, c_w {c_w} B), "
        f"one IDPA batch, {MULTI_LOCAL} local steps of B={MULTI_B}, AdamW,"
        f" {MULTI_ROUNDS} SGWU rounds; pool {MULTI_NODES} x cuda:0; held "
        f"to vmap on the same card within rtol {MULTI_TOL[0]:g} / atol "
        f"{MULTI_TOL[1]:g} (losses, merged weights); card: {card}")
    cases = [("nodes4", MULTI_NODES, dict(mesh="nodes4"), step)]
    for family in ("batch", "channel"):
        plan = planner.plan_for_axes(cfg, nodes=2, model=2,
                                     batch_size=MULTI_B, family=family)
        cases.append((family, 2, dict(mesh=MULTI_HYBRID, family=family,
                                      model_cfg=cfg),
                      hybrid_step_launches(step, plan)))
    armed = {}
    for tag, m, kw, per in cases:
        tr, evs, counts, wall = run("device", m, devices=pool, **kw)
        plan = tr.last_plan
        if plan.backend != "device" or plan.fallback:
            raise AssertionError(f"[multi] {tag}: backend {plan.backend} "
                                 f"({plan.fallback!r})")
        want = steps_of(m, per)
        if counts != want:
            raise AssertionError(f"[multi] {tag}: launches {counts} != "
                                 f"{want}")
        eng = tr.last_engine
        sched = ""
        if eng.netplan is not None:
            planned = [lp for lp in eng.netplan.layers if lp.kind != "pool"]
            if eng.netplan.family != kw["family"] or \
                    eng.executed != planned:
                raise AssertionError(f"[multi] {tag}: scheduled "
                                     f"{[lp.name for lp in planned]} != "
                                     f"executed {eng.executed}")
            sched = (f"; scheduled == executed ({len(planned)} conv/fc "
                     f"LayerPlans: " + ", ".join(
                         f"{lp.name} {lp.parallel_dim}" for lp in planned
                         if lp.kind == "fc") + ")")
        ld, pd = _held(np, tree, f"[multi] {tag}", evs, ref[m], MULTI_TOL,
                       MULTI_TOL)
        out[tag] = counts
        armed[tag] = (m, kw, evs)
        log(f"[multi] {tag} ({m} nodes, mesh {kw['mesh']}): backend device,"
            f" {len(evs)} rounds in {wall:.3f} s, losses "
            f"{[e.loss for e in evs]}, max diff to vmap: losses {ld:.3g}, "
            f"merged weights {pd:.3g}; K1-K8 launches {counts} (exact, "
            f"{m} nodes x {MULTI_LOCAL} x {MULTI_ROUNDS} steps x {per})"
            + sched)
    for K in (2, 4):
        pick = planner.plan_for_axes(cfg, nodes=2, model=K,
                                     batch_size=MULTI_B)
        costs = {f: planner.plan_for_axes(cfg, nodes=2, model=K,
                                          batch_size=MULTI_B,
                                          family=f).total_cost_s * 1e3
                 for f in ("batch", "channel")}
        log(f"[multi] the H100 HW default ({planner.HW()}) picks "
            f"{pick.family} for case7 at (nodes 2, model {K}), B={MULTI_B}: "
            f"cost {pick.total_cost_s * 1e3:.5f} ms; forced batch "
            f"{costs['batch']:.5f} ms, forced channel "
            f"{costs['channel']:.5f} ms; fc dims "
            f"{[lp.parallel_dim for lp in pick.layers if lp.kind == 'fc']}")
    # the sanitizer armed: the same runs, the same bits, only the sync
    # points the code names
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        for tag, (m, kw, evs) in armed.items():
            sanitize.clear_sync_log()
            with sanitize.compile_budget(0, label=f"4q(a) {tag}"):
                _, again, _, _ = run("device", m, devices=pool, **kw)
            same = _bits(torch, again[-1].params, evs[-1].params, tree) and \
                [e.loss for e in again] == [e.loss for e in evs]
            labels = sanitize.sync_log()
            want = (["upload"] * m + ["round.losses"]) * MULTI_ROUNDS
            if not same or labels != want:
                raise AssertionError(f"[multi-sanitize] {tag}: bits equal "
                                     f"{same}, sync log {labels}")
        log(f"[multi-sanitize] {list(armed)} with REPRO_SANITIZE=1: "
            f"identical bits, sync_log m x upload + round.losses a round, "
            f"compile_budget(0) held; 4q(a) {time.perf_counter() - t_a:.1f}"
            f" s")
    finally:
        os.environ.pop("REPRO_SANITIZE", None)
        sanitize.clear_sync_log()

    # (b) AGWU with node-pinned weights, and resume
    t_b = time.perf_counter()
    _, href, _, _ = run("heap", MULTI_NODES)
    tr, hevs, counts, wall = run("heap-device", MULTI_NODES, devices=pool)
    want = steps_of(MULTI_NODES, step)
    keys = [[(e.node, e.virtual_clock, e.comm_bytes) for e in evs]
            for evs in (hevs, href)]
    if tr.last_plan.backend != "heap-device" or keys[0] != keys[1] \
            or counts != want:
        raise AssertionError(f"[multi] heap-device: backend "
                             f"{tr.last_plan.backend}, events {keys}, "
                             f"launches {counts}")
    ld, pd = _held(np, tree, "[multi] heap-device", hevs, href, MULTI_TOL,
                   MULTI_TOL)
    out["heap-device"] = counts
    log(f"[multi] heap-device ({MULTI_NODES} nodes pinned to cuda:0, "
        f"durations pinned at {MULTI_DURS} s): {len(hevs)} pushes in "
        f"{wall:.3f} s, node order {[e.node for e in hevs]}, clock and comm"
        f" equal to heap's; max diff to heap: losses {ld:.3g}, merged "
        f"weights {pd:.3g}; K1-K8 launches {counts} (exact)")
    root = tempfile.mkdtemp(prefix="chip_smoke_4q_")
    try:
        for name, runs in MULTI_RUNS.items():
            make = functools.partial(
                _multi_trainer, port, cfg, params, data, name, 2,
                devices=pool[:2], mesh="nodes2" if name == "device" else "")
            full = list(make().run(runs[0]))
            ckdir = os.path.join(root, name)
            evs, saves, restores, start = _crash_resume(torch, port, make,
                                                        runs, ckdir)
            same = _bits(torch, evs[-1].params, full[-1].params, tree)
            trail = [e.loss for e in evs] == [e.loss for e in full[start:]]
            if not (same and trail and len(evs) == len(full) - start):
                raise AssertionError(
                    f"[multi-resume] {name}: weights equal {same}, loss "
                    f"trail equal {trail}, {len(evs)} events after {start}")
            log(f"[multi-resume] {name}: broke after {runs[2]} of "
                f"{len(full)} events (a state checkpoint every {runs[1]}), "
                f"a fresh trainer resumed from event {start}: final merged "
                f"weights and the loss trail bit-identical; saves "
                f"{[round(s, 3) for s in saves]} s, restore "
                f"{[round(s, 3) for s in restores]} s")
            shutil.rmtree(ckdir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[multi] 4q(b) {time.perf_counter() - t_b:.1f} s")

    # (c) a mixed pool: node 0 on the card, node 1 on the host
    t_c = time.perf_counter()
    qcfg = cnn.CNNConfig(**QUICKSTART)
    qtree = weights.params_to_numpy(cnn.init_cnn(
        qcfg, torch.Generator("cpu").manual_seed(0), device="cpu"))
    qdata = port.synthetic.image_dataset(MULTI_B * 2 * 2, size=16, seed=0)
    mixed = [card0, torch.device("cpu")]
    runs = {}
    for tag, devs in (("card", [card0, card0]), ("mixed", mixed),
                      ("armed", mixed)):
        if tag == "armed":
            os.environ["REPRO_SANITIZE"] = "1"
            sanitize.clear_sync_log()
        try:
            tr = _multi_trainer(port, qcfg, weights.params_from_numpy(
                qtree, qcfg, "cuda"), qdata, "device", 2, devices=devs,
                mesh="nodes2")
            _zero_counts(mods)
            evs = list(tr.run(MULTI_ROUNDS))
            torch.cuda.synchronize()
            runs[tag] = (evs, _counts(mods), sanitize.sync_log())
        finally:
            os.environ.pop("REPRO_SANITIZE", None)
    (cevs, ccounts, _), (mevs, mcounts, _) = runs["card"], runs["mixed"]
    aevs, _, labels = runs["armed"]
    half = {k: n // 2 for k, n in ccounts.items()}
    if mcounts != half or not all(ccounts.values()):
        raise AssertionError(f"[multi-mixed] launches {mcounts}, the card "
                             f"run's {ccounts}: the host node must launch "
                             "none")
    if set(labels) != MULTI_LABELS or \
            labels.count("round.losses") != MULTI_ROUNDS or \
            not _bits(torch, aevs[-1].params, mevs[-1].params, tree):
        raise AssertionError(f"[multi-mixed] armed run: sync log {labels}")
    sanitize.clear_sync_log()
    ld, pd = _held(np, tree, "[multi-mixed]", mevs, cevs, *MIXED_TOL)
    log(f"[multi-mixed] quickstart on nodes2 over [cuda:0, cpu]: node 1 "
        f"on the host (plain versions: K1-K8 {mcounts}, half the all-card "
        f"run's {ccounts}); held to the all-card run: losses max diff "
        f"{ld:.3g} (rtol {MIXED_TOL[0][0]:g}, atol {MIXED_TOL[0][1]:g}), "
        f"merged weights {pd:.3g} (rtol {MIXED_TOL[1][0]:g}, atol "
        f"{MIXED_TOL[1][1]:g}); armed with REPRO_SANITIZE=1: identical "
        f"bits, sync_log {labels}; 4q(c) {time.perf_counter() - t_c:.1f} s")

    # (d) Phi-3-mini at full width on the 2-D mesh, the generic batch plan
    t_d = time.perf_counter()
    phase_multi_lm(torch, port, mods, card, pool)
    log(f"[multi-lm] 4q(d) {time.perf_counter() - t_d:.1f} s")

    # records: the wall and device ms a round of device against vmap, and
    # of the 2-D families against vmap on 2 nodes, in turns on the same
    # card (after a warm-up round each)
    one = dict(devices=pool, mesh="nodes4")
    two = dict(devices=pool, mesh=MULTI_HYBRID, model_cfg=cfg)
    for tag, name, m, kw in (
            ("vmap", "vmap", 4, {}), ("nodes4", "device", 4, one),
            ("nodes4", "device", 4, one), ("vmap", "vmap", 4, {}),
            ("vmap", "vmap", 2, {}),
            ("batch", "device", 2, dict(two, family="batch")),
            ("channel", "device", 2, dict(two, family="channel")),
            ("vmap", "vmap", 2, {})):
        dev_ms, busy_ms, wall_ms = _outer_profile(torch, port, _multi_trainer(
            port, cfg, params, data, name, m, **kw), 1)
        log(f"[multi-profile] {tag} round ({m} nodes, {MULTI_LOCAL} steps "
            f"of B={MULTI_B}): wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms, device ms by kernel: "
            + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()))
    return out


def phase_multi_lm(torch, port, mods, card, pool):
    """Phase 4q(d): Phi-3-mini at full width and LM_OUTER_LAYERS layers
    through ``launch/train.py``'s ``run`` on ``nodes2xmodel2`` (the generic
    batch plan: each node's 8 rows split in two) and on ``vmap``, 2 nodes:
    the split gradient at the first params against the whole batch's, then
    the two trajectories."""
    import numpy as np
    from repro_torch.core import planner
    from repro_torch.data.pipeline import host_batch
    lm, tree = port.lm, port.tree
    cfg = dataclasses.replace(port.configs.get_config(LM_ARCH),
                              num_layers=LM_OUTER_LAYERS)
    params = lm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
    rows = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ + 1)).astype(np.int32)
    batch = {"rows": torch.as_tensor(rows, device="cuda")}

    def loss_fn(p, b):
        return lm.loss_fn(p, host_batch(b["rows"]), cfg)

    (loss, _), grads = port.trainer.value_and_grad(loss_fn, params, batch)
    plan = planner.plan_for_axes(None, nodes=2, model=2,
                                 batch_size=LM_BATCH)
    split = port.trainer._split_grads(loss_fn, planner.grad_combine(plan))
    with planner.plan_scope(plan, pool[:2]):
        sloss, sgrads = split(params, batch)
    tl, atol, rtol = LM_TOL["bfloat16"]
    worst = 0.0
    if not abs(float(sloss) - float(loss)) <= tl * max(1.0, abs(float(loss))):
        raise AssertionError(f"[multi-lm] split loss {float(sloss)} vs "
                             f"{float(loss)}")
    for a, b in zip(tree.tree_leaves(sgrads), tree.tree_leaves(grads),
                    strict=True):
        d = (a.float() - b.float()).abs()
        if not bool((d <= atol + rtol * b.float().abs()).all()):
            raise AssertionError(f"[multi-lm] a split grad leaf differs by "
                                 f"{float(d.max())}")
        worst = max(worst, float(d.max()))
    log(f"[multi-lm] {LM_ARCH} full width, {LM_OUTER_LAYERS} layers: one "
        f"batch of {LM_BATCH} x {LM_SEQ} split over 2 model devices and "
        f"recombined (grad_combine) against the whole batch: loss "
        f"{float(sloss):.6f} vs {float(loss):.6f}, every grad leaf within "
        f"atol {atol:g} / rtol {rtol:g} (max diff {worst:.3g})")
    del grads, sgrads
    base = ["--device", "cuda", "--full", "--arch", LM_ARCH, "--nodes", "2",
            "--rounds", str(MULTI_ROUNDS)]
    steps = 2 * 2 * MULTI_ROUNDS              # nodes x local steps x rounds
    per = lm_step_launches(LM_OUTER_LAYERS)
    runs = {}
    for tag, extra, devs, shards in (
            ("vmap", ["--engine", "vmap"], None, 1),
            ("device", ["--engine", "device", "--mesh", MULTI_HYBRID], pool,
             2)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_lm_counts(mods)
        t0 = time.perf_counter()
        rep = _drive(port, base + extra, cfg, params, devices=devs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _lm_counts(mods)
        want = {k: shards * steps * n for k, n in per.items()}
        if rep.backend != tag or counts != want or \
                not np.isfinite(rep.losses).all():
            raise AssertionError(f"[multi-lm] {tag}: backend {rep.backend},"
                                 f" launches {counts} != {want}, losses "
                                 f"{rep.losses}")
        runs[tag] = rep
        log(f"[multi-lm] {tag}: {len(rep.losses)} rounds in {wall:.2f} s, "
            f"losses {[round(x, 6) for x in rep.losses]}, comm "
            f"{rep.comm_bytes} B, launches {counts} (exact), "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    a, b = runs["device"], runs["vmap"]
    # AdamW moves an element about lr a step, either way: elements whose
    # bf16 gradient rounds to the other sign part by up to 2 lr a step
    patol = 2 * LM_LR * MULTI_LOCAL * MULTI_ROUNDS
    ld = max(abs(x - y) for x, y in zip(a.losses, b.losses))
    pd = max(float((x.float() - y.float()).abs().max()) for x, y in zip(
        tree.tree_leaves(a.final_params), tree.tree_leaves(b.final_params),
        strict=True))
    if a.comm_bytes != b.comm_bytes or \
            ld > tl * max(1.0, max(abs(x) for x in b.losses)) or pd > patol:
        raise AssertionError(f"[multi-lm] device vs vmap: losses "
                             f"{a.losses} vs {b.losses}, params max diff "
                             f"{pd} (atol {patol}), comm {a.comm_bytes} vs "
                             f"{b.comm_bytes}")
    log(f"[multi-lm] device (nodes2xmodel2, generic batch plan) held to "
        f"vmap: losses max diff {ld:.3g} (bf16 loss gate {tl:g} x |loss|),"
        f" merged params max diff {pd:.3g} (atol {patol:g} = 2 lr x "
        f"{MULTI_LOCAL * MULTI_ROUNDS} steps), comm equal ({card})")
    del runs, a, b, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_multi_kernels(torch, ref, mods, cnn):
    """K1-K8 at the batch family's shard shapes (case7 at B = MULTI_B / 2)
    and K1-K3 at the channel family's column shards (B = MULTI_B, each fc
    width cut in two), against their plain versions, with their times
    summed over one node step's launches.  Returns {family: {kernel:
    row}}."""
    specs = _train_specs(torch, ref, mods)
    gen = torch.Generator("cuda").manual_seed(4)
    batch = case7_step_shapes(cnn, MULTI_B // 2)
    whole = case7_step_shapes(cnn, MULTI_B)
    shards = {key: {(M, Din, Dout // 2, relu): 2 * n
                    for (M, Din, Dout, relu), n in whole[key].items()}
              for key in ("K1", "K2", "K3")}
    batch = {key: {s: 2 * n for s, n in cases.items()}
             for key, cases in batch.items()}
    rows = {}
    for family, shapes in (("batch", batch), ("channel", shards)):
        rows[family] = {}
        for key, cases in shapes.items():
            spec, row = specs[key], _new_row()
            for s, n in cases.items():
                args = spec["make"](gen, s)
                err, tol = _compare(torch, key, spec, args)
                if not err <= tol:
                    raise AssertionError(f"[multi-k] {family} {key} {s}: "
                                         f"max_abs_err {err} > tol {tol}")
                _note_err(row, err, tol)
                _time_shape(torch, spec, gen, s, n, args, row,
                            f"[multi-k] {family:<7} {key} {str(s):<34} "
                            f"{n:>2} {err:<11.4g} {tol:<10.4g} ")
            rows[family][key] = row
            log(f"[multi-k] {family} {key}, one node step "
                f"({sum(cases.values())} launches): kernel {row['ms']:.5f} "
                f"ms (device {fmt_ms(row['device_ms'])}), plain "
                f"{row['plain_ms']:.5f}, library {row['library_ms']:.5f} "
                f"(device {fmt_ms(row['library_device_ms'])}), bound "
                f"{row['bound_ms']:.5f} ms ({dominant(row['bound_by'])})")
    return rows


DRYRUN_COMBOS = (("gemma2-27b", "train_4k", "pod"),
                 ("granite-moe-3b-a800m", "decode_32k", "pod"))
# the pairs on the 2 x 2 mesh whose collectives are held to the
# reference's: its dry-run's calibrated (total, per-layer, outside)
# collective bytes, from ``repro.launch.dryrun`` (jax 0.9.0, 8 forced host
# devices) on the CPU, the numbers ``tests/test_torch_dryrun_collectives.py``
# (the five decode pairs) and ``tests/test_torch_dryrun_prefill_collectives
# .py`` (the two prefills, their sequence cut to DRYRUN_CUT's) hold the
# port's (torch 2.13) within 2x of.  Both sides are compared with every
# floating payload at 4 bytes an element; these HLOs carry only f32
# collectives, so the numbers are also the reference's own
DRYRUN_REFERENCE = {
    ("yi-6b", "decode_32k"): (469237760, 8388608, 200802304),
    ("phi3-mini-3.8b", "decode_32k"): (302972928, 6291456, 101646336),
    ("mamba2-370m", "decode_32k"): (452042752, 6177792, 155508736),
    ("hymba-1.5b", "decode_32k"): (2415921152, 73449472, 65538048),
    ("qwen3-moe-30b-a3b", "decode_32k"): (14475722752, 291766272,
                                          470941696),
    ("mamba2-370m", "prefill_32k"): (26908688384, 543424512, 824311808),
    ("hymba-1.5b", "prefill_32k"): (57902465024, 1809426432, 819200),
    # ``tests/test_torch_dryrun_train_collectives*.py``'s, cut to 1024
    ("yi-6b", "train_4k"): (2854477758640, 87938039808, 40460484784),
    ("stablelm-12b", "train_4k"): (4626089410736, 114127339520,
                                   60995829936),
    ("internvl2-26b", "train_4k"): (6742469017776, 138211098624,
                                    108336283824),
    ("hymba-1.5b", "train_4k"): (540265216160, 16427578720, 14582697120),
}
DRYRUN_CUT = {"prefill_32k": 2048,   # a held pair's sequence, cut
              "train_4k": 1024}
# the band a held pair's total and per-layer bytes keep (both ways);
# ``outside`` within 2x too where the shape is listed
DRYRUN_BAND = {"train_4k": 1.5}
# (calibrated FLOPs, collective bytes) of the torch 2.13.0+cpu record of
# a DRYRUN_COMBOS row, which the card host's torch keeps within 1.1x
DRYRUN_RECORD = {("gemma2-27b", "train_4k", "pod"): (2.413384042503209e17,
                                                     85326262438912)}
DRYRUN_RECORD_BAND = 1.1
DRYRUN_HELD = tuple((arch, shape, "tiny") for arch, shape in DRYRUN_REFERENCE)
# a dry-run of one pair with its shape's sequence cut (argv: arch, shape,
# mesh, sequence), its record saved as the CLI's ``--tag smoke`` saves it
DRYRUN_CUT_RUN = """
import dataclasses, sys
from repro_torch import configs
from repro_torch.launch import dryrun
arch, shape, mesh, seq = sys.argv[1:]
configs.SHAPES[shape] = dataclasses.replace(configs.SHAPES[shape],
                                            seq_len=int(seq))
print("  ->", dryrun.save_result(dryrun.lower_and_compile(arch, shape, mesh),
                                 tag="smoke"))
"""
DRYRUN_LIMIT_S = 300                 # each dry-run subprocess's time limit
DRYRUN_DIR = ROOT / "experiments" / "dryrun_torch"
SKIP_PROMPTS = (("gemma2-27b", 8, GEMMA_LONG), ("hymba-1.5b", 0, 2048))


def json_of(stem):
    # the record beside ``stem`` (an arch's name may hold a dot:
    # ``with_suffix`` would cut it there)
    return stem.parent / f"{stem.name}.json"


def log_of(stem):
    return stem.parent / f"{stem.name}.log"


def start_dryruns():
    """Phase 4r(b)'s dry-runs, started in subprocesses on the host (no
    card: CUDA hidden from them); ``finish_dryruns`` waits for them."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for arch, shape, mesh in DRYRUN_COMBOS + DRYRUN_HELD:
        stem = DRYRUN_DIR / f"{arch}__{shape}__{mesh}__smoke"
        json_of(stem).unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--tag", "smoke"]
        if (arch, shape, mesh) in DRYRUN_HELD and shape in DRYRUN_CUT:
            cmd = [sys.executable, "-c", DRYRUN_CUT_RUN, arch, shape, mesh,
                   str(DRYRUN_CUT[shape])]
        with open(log_of(stem), "w") as out:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)
        procs.append(((arch, shape, mesh), stem, time.perf_counter(), proc))
    return procs


def finish_dryruns(procs):
    """Wait for phase 4r(b)'s dry-runs (each at most DRYRUN_LIMIT_S from
    its start; one past it is killed and fails the phase), print each
    roofline row, the seconds its two depth runs took (the record's
    ``compile_s``) and the wall seconds from its start to the end of its
    wait here (an upper bound: they are waited for after 4r(a))."""
    failed = []
    for (arch, shape, mesh), stem, t0, proc in procs:
        left = max(1.0, DRYRUN_LIMIT_S - (time.perf_counter() - t0))
        try:
            proc.wait(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failed.append(f"{arch} {shape} {mesh}: past {DRYRUN_LIMIT_S} s")
            continue
        wall = time.perf_counter() - t0
        fn = json_of(stem)
        if proc.returncode != 0 or not fn.exists():
            log(log_of(stem).read_text()[-3000:])
            failed.append(f"{arch} {shape} {mesh}: exit {proc.returncode}")
            continue
        rec = json.loads(fn.read_text())
        log(f"[dryrun] {arch} x {shape} x {mesh}: {rec['compile_s']} s in "
            f"its steps, done within {wall:.1f} s wall on the host "
            f"(torch {rec['torch']}); roofline row (H100 "
            f"data-sheet estimate) {json.dumps(rec['roofline'])}")
        if (arch, shape, mesh) in DRYRUN_HELD:
            failed += held_to_reference(arch, shape, rec)
        if (arch, shape, mesh) in DRYRUN_RECORD:
            failed += held_to_record(arch, shape, mesh, rec)
    if failed:
        raise AssertionError(f"dry-runs failed: {failed}")


def held_to_record(arch, shape, mesh, rec):
    """A DRYRUN_RECORD row's calibrated FLOPs and collective bytes beside
    the torch 2.13 record's; its faults: either past DRYRUN_RECORD_BAND
    times the record's."""
    cal = rec["calibrated"]
    name = f"{arch} {shape} {mesh}"
    faults = []
    for what, got, want in zip(("FLOPs", "collective bytes"),
                               (cal["flops"], cal["coll_bytes"]),
                               DRYRUN_RECORD[arch, shape, mesh]):
        log(f"[dryrun] {name} {what} (torch {rec['torch']}): {got:.6g}, "
            f"x{got / want:.3f} the torch 2.13.0+cpu record's {want:.6g}")
        if got > DRYRUN_RECORD_BAND * want:
            faults.append(f"{name}: {what} x{got / want:.3f} the 2.13 "
                          "record's")
    return faults


def held_to_reference(arch, shape, rec):
    """A DRYRUN_HELD record's collective bytes printed beside the
    reference's, its own and at f32 width (``dryrun.collectives_at_f32``);
    its faults: ``outside`` negative, or its per-layer bytes at f32 width
    off the reference's by more than 2x either way (where DRYRUN_BAND
    lists the shape: its total and per-layer bytes off by more than the
    band, or its ``outside`` by more than 2x)."""
    from repro_torch.launch.dryrun import collectives_at_f32
    cal, wide = rec["calibrated"], collectives_at_f32(rec)
    true = (cal["coll_bytes"], cal["per_layer"]["coll_bytes"],
            cal["outside"]["coll_bytes"])
    got = (wide["coll_bytes"], wide["per_layer"], wide["outside"])
    want = DRYRUN_REFERENCE[arch, shape]
    ratio = got[1] / want[1]
    name = f"{arch} {shape} tiny" + (f" cut to {DRYRUN_CUT[shape]} tokens"
                                     if shape in DRYRUN_CUT else "")
    log(f"[dryrun] {name} collective bytes (total, per "
        f"layer, outside; torch {rec['torch']}): {true[0]:.0f}, "
        f"{true[1]:.0f}, {true[2]:.0f}, at f32 width {got[0]:.0f}, "
        f"{got[1]:.0f}, {got[2]:.0f}; the reference's {want[0]}, {want[1]}, "
        f"{want[2]}; per layer at f32 width x{ratio:.3f}")
    faults = []
    if min(true[2], got[2]) < 0:
        faults.append(f"{name}: outside {true[2]:.0f} < 0")
    band = DRYRUN_BAND.get(shape)
    checks = [("per-layer", ratio, band or 2.0)]
    if band:
        checks += [("total", got[0] / want[0], band),
                   ("outside", got[2] / want[2], 2.0)]
        log(f"[dryrun] {name}: total x{checks[1][1]:.3f}, outside "
            f"x{checks[2][1]:.3f} the reference's at f32 width")
    for what, r, b in checks:
        if not 1 / b <= r <= b:
            faults.append(f"{name}: {what} collective bytes x{r:.3f} the "
                          "reference's")
    return faults


def phase_block_skip(torch, configs, lm, card):
    """Phase 4r(a): each SKIP_PROMPTS arch (0 layers: full depth)
    prefilled under its ``opt`` config (``attn_block_skip``) and its plain
    one, from one bf16 compute copy of seeded params: logits and every
    cache leaf bit-identical, the skipped kv blocks counted, and each
    prefill's device ms, plain then opt."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import attention
    for arch, layers, prompt in SKIP_PROMPTS:
        t0 = time.perf_counter()
        plain = configs.get_config(arch)
        opt = configs.get_config(arch, "opt")
        if layers:
            plain = dataclasses.replace(plain, num_layers=layers)
            opt = dataclasses.replace(opt, num_layers=layers)
        params = lm.compute_params(lm.init_params(
            plain, torch.Generator("cuda").manual_seed(0), device="cuda"),
            plain)
        gen = torch.Generator("cuda").manual_seed(1)
        toks = torch.randint(0, plain.vocab_size, (1, prompt),
                             generator=gen, device="cuda", dtype=torch.int32)
        with torch.inference_mode():
            want_logits, want = lm.prefill(params, toks, plain)
            attention.reset_block_skips()
            got_logits, got = lm.prefill(params, toks, opt)
            skipped = attention.BLOCK_SKIPS["skipped"]
            torch.cuda.synchronize()
            same = torch.equal(got_logits, want_logits) and all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(got.layers), tree_leaves(want.layers),
                    strict=True)) and torch.equal(got.lengths, want.lengths)
            n_leaves = len(tree_leaves(got.layers))
            del got, want, got_logits, want_logits
            if not same:
                raise AssertionError(f"{arch}: block_skip changed the "
                                     "prefill's logits or cache")
            if not skipped:
                raise AssertionError(f"{arch}: block_skip skipped nothing")
            times = {}
            for tag, cfg in (("plain", plain), ("opt", opt)):
                times[tag], _ = device_ms(torch, lambda c=cfg: lm.prefill(
                    params, toks, c), [()], iters=1, warmup=1, tries=2)
        log(f"[block_skip] {arch}: {plain.num_layers} layers, windows "
            f"{sorted(set(lm.layer_windows(plain)))}, a {prompt}-token "
            f"prefill: logits and all {n_leaves} cache leaves bit-identical "
            f"under opt; {skipped} kv blocks skipped (chunks "
            f"{plain.attn_q_chunk or 512} x {plain.attn_k_chunk or 1024}); "
            f"device ms, plain then opt: {fmt_ms(times['plain'])}, "
            f"{fmt_ms(times['opt'])} ({card}; "
            f"{time.perf_counter() - t0:.1f} s)")
        del params, toks
        gc.collect()
        torch.cuda.empty_cache()


def phase_dryrun(torch, configs, lm, card):
    """Phase 4r: (b)'s dry-runs on the host while (a) runs on the card."""
    t0 = time.perf_counter()
    procs = start_dryruns()
    try:
        phase_block_skip(torch, configs, lm, card)
    except BaseException:
        for *_, proc in procs:
            proc.kill()
            proc.wait()
        raise
    log(f"[time] phase 4r(a) {time.perf_counter() - t0:.1f} s")
    finish_dryruns(procs)
    log(f"[time] phase 4r {time.perf_counter() - t0:.1f} s")


def phase_cli():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b",
         "--device", "cuda", "--requests", "6", "--rate", "100",
         "--gen", "8"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serving CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    log("[cli] " + proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port "
                                 "on one NVIDIA card (see the module text).")
    ap.add_argument("--train-kernels", help="comma-separated kernels "
                    "(K1-K8): run phase 2b alone for them and print no "
                    "result line")
    ap.add_argument("--k1-rows", help="comma-separated rows M: run phase 2 "
                    "(K1) alone at these rows and print no result line")
    ap.add_argument("--lm-kernels", help="comma-separated kernels (K1, K2,"
                    " K3, K9): run phase 2d alone for them and print no "
                    "result line")
    ap.add_argument("--k9", action="store_true", help="run phase 2c's K9 "
                    "cases alone and print no result line")
    ap.add_argument("--k10", action="store_true", help="run phase 2c's K10 "
                    "cases alone and print no result line")
    ap.add_argument("--outer", action="store_true", help="run phase 4d (the "
                    "outer layer) alone and print no result line")
    ap.add_argument("--lm", action="store_true", help="run phases 2d, 3c, 4e "
                    "and 4f (the LM's training path) alone and print no "
                    "result line")
    ap.add_argument("--moe", action="store_true", help="run phases 3d, 4g "
                    "and 4h (the MoE family) alone and print no result "
                    "line")
    ap.add_argument("--moe-steps", type=int, default=MOE_STEPS,
                    help=f"phase 4h's training steps (default {MOE_STEPS})")
    ap.add_argument("--ssm", action="store_true", help="run phases 3e, 4i, "
                    "4j and 4k (the SSM and hybrid families) alone and print"
                    " no result line")
    ap.add_argument("--mm", action="store_true", help="run phases 3f, 4l, "
                    "4m, 4n and 4o (InternVL2, Seamless, StableLM) alone and"
                    " print no result line")
    ap.add_argument("--ckpt", action="store_true", help="run phase 4p "
                    "(checkpoints and resume, the chaos worker, the CLI's "
                    "resume flows, the sanitizer, the BPT-CNN example, the "
                    "cluster simulator) alone and print no result line")
    ap.add_argument("--multi", action="store_true", help="run phase 4q "
                    "(the multi-device engines, the planner's families, a "
                    "mixed pool, an LM on a 2-D mesh) alone and print no "
                    "result line")
    ap.add_argument("--dryrun", action="store_true", help="run phase 4r "
                    "(block_skip on the card, the dry-run on the host) alone"
                    " and print no result line")
    args = ap.parse_args()
    # torch.compile (the flex_attention yardstick) caches inside the checkout
    cache = SRC / "repro_torch" / "kernels" / "_build" / "compile_cache"
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import configs, serving, weights
    from repro_torch.checkpointing import checkpoint
    from repro_torch.core import (bpt_trainer, cluster_sim, engine, gwu,
                                  tree, types)
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import conv2d as conv_mod
    from repro_torch.kernels import dense as dense_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import pool2d as pool_mod
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.launch import profile_decode
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import cnn, encdec, frontends, layers, lm
    from repro_torch.optim import optimizers

    port = SimpleNamespace(cnn=cnn, weights=weights, trainer=bpt_trainer,
                           synthetic=synthetic, types=types, optim=optimizers,
                           tree=tree, profile=profile_decode, engine=engine,
                           gwu=gwu, pipeline=pipeline, lm=lm,
                           configs=configs, checkpoint=checkpoint,
                           train=train_mod, steps=steps_mod, encdec=encdec,
                           frontends=frontends, layers=layers,
                           cluster_sim=cluster_sim)
    mods = {"dense": dense_mod, "conv2d": conv_mod, "pool2d": pool_mod,
            "rmsnorm": rms_mod, "flash_attention": flash_mod}
    counters = {"K1": dense_mod.dense_cuda, "K9": rms_mod.rmsnorm_cuda,
                "K10": flash_mod.flash_attention_cuda}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    t0 = time.perf_counter()
    build.build()
    log(f"[build] {list(build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            log(f"[build] {name}: {line}")

    if args.k1_rows:
        phase_kernel(torch, dense_mod, ref,
                     {int(m) for m in args.k1_rows.split(",")})
        log(card_line())
        return 0
    if args.train_kernels:
        phase_train_kernels(torch, ref, mods, cnn,
                            set(args.train_kernels.split(",")))
        log(card_line())
        return 0
    if args.lm_kernels:
        phase_lm_kernels(torch, ref, dense_mod, rms_mod,
                         set(args.lm_kernels.split(",")))
        log(card_line())
        return 0
    if args.k9:
        phase_k9(torch, ref, rms_mod)
        log(card_line())
        return 0
    if args.k10:
        phase_k10(torch, ref, flash_mod)
        log(card_line())
        return 0
    if args.outer:
        phase_outer_parity(torch, port)
        phase_outer_slice(torch, port, mods, card)
        log(card_line())
        return 0
    if args.lm:
        phase_lm_kernels(torch, ref, dense_mod, rms_mod)
        phase_lm_parity(torch, port)
        phase_lm_step(torch, port, mods, card)
        phase_lm_train(torch, port, mods, card)
        log(card_line())
        return 0
    if args.moe:
        phase_moe_parity(torch, port, serving)
        phase_moe_serve(torch, port, serving, counters, card)
        phase_lm_step(torch, port, mods, card, MOE_TRAIN_ARCH,
                      MOE_TRAIN_LAYERS, "moe-train", args.moe_steps,
                      MOE_MIN_FALL)
        log(card_line())
        return 0
    if args.ssm:
        phase_ssm_parity(torch, port, serving)
        phase_ssm_serve(torch, port, serving, counters, card)
        phase_lm_step(torch, port, mods, card, SSM_TRAIN_ARCH,
                      SSM_TRAIN_LAYERS, "ssm-train", SSM_STEPS, SSM_MIN_FALL,
                      SSM_CORPUS_VOCAB)
        log(card_line())
        return 0
    if args.ckpt:
        t0 = time.perf_counter()
        phase_ckpt(torch, port, mods, card)
        log(f"[time] phase 4p {time.perf_counter() - t0:.1f} s")
        log(card_line())
        return 0
    if args.multi:
        t0 = time.perf_counter()
        phase_multi_kernels(torch, ref, mods, cnn)
        log(f"[time] phase 4q's kernels {time.perf_counter() - t0:.1f} s")
        phase_multi(torch, port, mods, card)
        log(f"[time] phase 4q {time.perf_counter() - t0:.1f} s")
        log(card_line())
        return 0
    if args.dryrun:
        phase_dryrun(torch, configs, lm, card)
        log(card_line())
        return 0
    if args.mm:
        t0 = time.perf_counter()
        phase_mm_parity(torch, port)
        log(f"[time] phase 3f {time.perf_counter() - t0:.1f} s")
        phases_mm(torch, port, serving, counters, mods, card)
        log(f"[time] phases 3f-4o {time.perf_counter() - t0:.1f} s")
        log(card_line())
        return 0
    t_run = time.perf_counter()

    def lap(what):
        log(f"[time] {what} done {time.perf_counter() - t_run:.1f} s after "
            "the build")
    k1_sums, worst, k1_cases = phase_kernel(torch, dense_mod, ref)
    lap("phase 2")
    train_rows = phase_train_kernels(torch, ref, mods, cnn)
    lap("phase 2b")
    attn_rows = {"K9": phase_k9(torch, ref, rms_mod),
                 "K10": phase_k10(torch, ref, flash_mod)}
    lap("phase 2c")
    lm_rows = phase_lm_kernels(torch, ref, dense_mod, rms_mod)
    lap("phase 2d")
    phase_reduced(torch, configs, lm, serving, weights, "yi-6b")
    phase_reduced(torch, configs, lm, serving, weights, "gemma2-27b")
    phase_train_reduced(torch, port)
    phase_lm_parity(torch, port)
    phase_moe_parity(torch, port, serving)
    lap("phases 3-3d")
    phase_ssm_parity(torch, port, serving)
    lap("phase 3e")
    phase_mm_parity(torch, port)
    lap("phase 3f")
    launches, yi_pre_k1 = phase_slice(torch, configs, lm, serving, counters,
                                      card)
    train_launches, train = phase_train_slice(torch, port, mods, card)
    phase_outer_parity(torch, port)
    outer_launches = phase_outer_slice(torch, port, mods, card)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 4, 4b, 4d")
    lm_launches, lm_step_ms = phase_lm_step(torch, port, mods, card)
    lm_outer_launches = phase_lm_train(torch, port, mods, card)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 4e, 4f")
    qwen_launches, qwen_pre_k, qwen_dec, qwen_pf = phase_moe_serve(
        torch, port, serving, counters, card)
    moe_launches, moe_step_ms = phase_lm_step(
        torch, port, mods, card, MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS,
        "moe-train", args.moe_steps, MOE_MIN_FALL)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 4g, 4h")
    ssm_serve = phase_ssm_serve(torch, port, serving, counters, card)
    lap("phases 4i, 4j")
    ssm_launches, ssm_step_ms = phase_lm_step(
        torch, port, mods, card, SSM_TRAIN_ARCH, SSM_TRAIN_LAYERS,
        "ssm-train", SSM_STEPS, SSM_MIN_FALL, SSM_CORPUS_VOCAB)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 4k")
    vlm, (vlm_launches, vlm_step_ms), enc, (enc_launches, enc_step_ms), \
        stable = phases_mm(torch, port, serving, counters, mods, card)
    lap("phases 4l-4o")
    gemma_launches, gem_pre, k10_launches, k10_diff = phase_gemma(
        torch, configs, serving, counters, card)
    phase_cli()
    lap("phases 4c, 5")
    t0 = time.perf_counter()
    ckpt = phase_ckpt(torch, port, mods, card)
    log(f"[time] phase 4p {time.perf_counter() - t0:.1f} s")
    lap("phase 4p")
    multi_rows = phase_multi_kernels(torch, ref, mods, cnn)
    multi = phase_multi(torch, port, mods, card)
    lap("phase 4q")
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun(torch, configs, lm, card)
    lap("phase 4r")

    k1 = train_rows["K1"]
    yi, gem = k1_sums[("yi-6b", "decode")], k1_sums[("gemma2-27b", "decode")]
    yi_pre = prefill_launches(dense_mod, k1_sums, "yi-6b", yi_pre_k1)
    qwen = k1_sums[(MOE_SERVE_ARCH, "decode")]
    qwen_pre = prefill_launches(dense_mod, k1_sums, MOE_SERVE_ARCH,
                                qwen_pre_k["K1"])
    gem_pre_k9 = gem_pre["K9"]
    gem_pre = prefill_launches(dense_mod, k1_sums, "gemma2-27b",
                               gem_pre["K1"])
    rows = [{
        "name": "dense_fwd (K1)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dense_fwd.cu",
        "replaces": "src/repro/kernels/dense.py:46",
        "launches": launches["K1"], "max_abs_err": worst["err"],
        "tolerance": worst["tol"], "ms": yi["ms"],
        "plain_ms": yi["plain_ms"], "bound_ms": yi["bound_ms"],
        "bound_by": dominant(yi["bound_by"]),
        "library_ms": yi["library_ms"], "device_ms": yi["device_ms"],
        "library_device_ms": yi["library_device_ms"],
        "work": "one Yi-6B decode step: 224 bf16 launches at M=4 "
                "(split-K weight stream)",
        "gemma_launches": gemma_launches["K1"], "gemma_ms": gem["ms"],
        "gemma_device_ms": gem["device_ms"],
        "gemma_plain_ms": gem["plain_ms"], "gemma_bound_ms": gem["bound_ms"],
        "gemma_library_ms": gem["library_ms"],
        "gemma_library_device_ms": gem["library_device_ms"],
        "gemma_work": "one Gemma-2 decode step, 8 layers: 56 bf16 launches "
                      "at M=4",
        **{f"{tag}_{key}": st[key] for tag, st in (
            ("prefill", yi_pre), ("gemma_prefill", gem_pre))
           for key in ("launches", "ms", "device_ms", "plain_ms", "bound_ms",
                       "library_ms", "library_device_ms")},
        "prefill_work": f"one Yi-6B prefill forward of "
                        f"{PREFILL_ROWS['yi-6b']} tokens: "
                        f"{yi_pre['launches']} bf16 launches, counted in "
                        "phase 4 (tile GEMM, 64-row tiles, split-K)",
        "gemma_prefill_work": f"one Gemma-2 prefill forward of "
                              f"{PREFILL_ROWS['gemma2-27b']} tokens, 8 "
                              f"layers: {gem_pre['launches']} bf16 launches,"
                              " counted in phase 4c (tile GEMM, 128-row "
                              "tiles)",
        "train_launches": train_launches["K1"],
        "outer_launches": outer_launches["K1"],
        "ckpt_launches": ckpt["ckpt"]["K1"],
        "example_launches": ckpt["example"]["K1"],
        "ckpt_cli_launches": ckpt["cli"]["K1"],
        "train_max_abs_err": k1["err"], "train_tolerance": k1["tol"],
        "train_ms": k1["ms"], "train_plain_ms": k1["plain_ms"],
        "train_bound_ms": k1["bound_ms"],
        "train_library_ms": k1["library_ms"],
        "train_device_ms": k1["device_ms"],
        "train_library_device_ms": k1["library_device_ms"],
        "train_step_device_ms": (train["device_ms"] or {}).get("K1"),
        "train_work": "one case7 training step: 7 f32 launches at M=64, "
                      "split-K into " + "/".join(
                          str(dense_mod.dense_splits(M, N, K))
                          for M, K, N, _ in case7_step_shapes(cnn)["K1"])
                      + " slices",
        **instance_fields(
            "train_bf16", lm_rows["K1"], lm_launches["K1"],
            lm_step_ms.get("K1"), lm_outer_launches["K1"],
            f"one {LM_ARCH} training step at full width, {LM_LAYERS} "
            f"layers, B=8 x S=128 (phase 4e): {7 * LM_LAYERS} bf16 "
            f"launches at M={LM_ROWS} without bias (tile GEMM, 128-row "
            "tiles, not split)"),
        **{f"qwen_{k}": v for k, v in qwen.items() if k != "bound_by"},
        "qwen_bound_by": dominant(qwen["bound_by"]),
        "qwen_launches": qwen_launches["K1"],
        "qwen_step_device_ms": qwen_dec.get("K1"),
        "qwen_work": f"one {MOE_SERVE_ARCH} decode step at full width, "
                     f"{MOE_SERVE_LAYERS} layers (phase 4g): "
                     f"{4 * MOE_SERVE_LAYERS} bf16 launches at M=4 (split-K "
                     "weight stream); launches: the serving run's",
        **{f"qwen_prefill_{k}": v for k, v in qwen_pre.items()
           if k != "bound_by"},
        "qwen_prefill_bound_by": dominant(qwen_pre["bound_by"]),
        "qwen_prefill_step_device_ms": qwen_pf.get("K1"),
        "qwen_prefill_work": f"one {MOE_SERVE_ARCH} prefill forward of "
                             f"{MOE_PROMPT} tokens, {MOE_SERVE_LAYERS} "
                             f"layers: {qwen_pre['launches']} bf16 "
                             "launches, counted in phase 4g (tile GEMM, "
                             "128-row tiles)",
        **instance_fields(
            "granite_train_bf16", lm_rows[("moe", "K1")], moe_launches["K1"],
            moe_step_ms.get("K1"), None,
            f"one {MOE_TRAIN_ARCH} training step at full width, "
            f"{MOE_TRAIN_LAYERS} layers, B=8 x S=128 (phase 4h): "
            f"{4 * MOE_TRAIN_LAYERS} bf16 launches at M={LM_ROWS} without "
            "bias (the attention's projections; the experts are library "
            "einsums)"),
        **instance_fields(
            "hymba_train_bf16", lm_rows[("ssm", "K1")], ssm_launches["K1"],
            ssm_step_ms.get("K1"), None,
            f"one {SSM_TRAIN_ARCH} training step at full width, "
            f"{SSM_TRAIN_LAYERS} layers, B=8 x S=128 (phase 4k): "
            f"{9 * SSM_TRAIN_LAYERS} bf16 launches at M={LM_ROWS} without "
            "bias (q, k, v, o, the mixer's in_proj 1600 -> 6457 and "
            "out_proj, the MLP's three)"),
    }]
    def multi_fields(key):
        """K1-K8's phase-4q instances: the batch family's shards (K1-K8),
        the channel family's column shards (K1-K3)."""
        out = instance_fields(
            "multi_batch", multi_rows["batch"][key], multi["batch"][key],
            None, None, f"one case7 node step of phase 4q(a)'s batch family "
            f"(nodes2xmodel2, each node's B {MULTI_B} split over 2 model "
            f"devices): {2 * STEP_LAUNCHES[key]} f32 launches at B "
            f"{MULTI_B // 2}; launches: the run's")
        if key in multi_rows["channel"]:
            out.update(instance_fields(
                "multi_channel", multi_rows["channel"][key],
                multi["channel"][key], None, None,
                f"one case7 node step of phase 4q(a)'s channel family: each "
                f"fc's columns in 2 shards, {2 * STEP_LAUNCHES[key]} f32 "
                f"launches at M {MULTI_B}; launches: the run's"))
        return out

    rows[0].update(multi_fields("K1"))
    served = {**ssm_serve, VLM_ARCH: vlm, STABLE_ARCH: stable}
    for arch, (prefix, phase) in SERVED.items():
        s_launches, s_pre, s_dec, s_pf = served[arch]
        cfg = configs.get_config(arch)
        n = dense_per_layer(cfg)
        L = DECODE_LAYERS[arch]
        depth = f"{L} layers" if L == cfg.num_layers else \
            f"{L} of {cfg.num_layers} layers"
        st_pre = prefill_launches(dense_mod, k1_sums, arch, s_pre["K1"])
        rows[0].update(sum_fields(
            prefix, k1_sums[(arch, "decode")], s_launches["K1"],
            s_dec.get("K1"),
            f"one {arch} decode step at full width, {depth} (phase "
            f"{phase}): {n * L} bf16 launches at M=4 (split-K weight "
            "stream); launches: the serving run's"))
        rows[0].update(sum_fields(
            f"{prefix}_prefill", st_pre, st_pre["launches"], s_pf.get("K1"),
            f"one {arch} {prefill_what(arch)}, {depth}: "
            f"{st_pre['launches']} bf16 launches, counted in phase {phase} "
            "(tile GEMM, 128-row tiles)"))
    enc_want, enc_dec_launches, enc_dev = enc
    enc_parts = enc_serve_launches()
    check_plans(dense_mod, ENC_ARCH, {M for k1, _ in enc_parts.values()
                                      for M, _, _ in k1})
    for part, prefix in ENC_PARTS.items():
        rows[0].update(instance_fields(
            prefix, case_sum(k1_cases, ENC_ARCH, enc_parts[part][0]),
            enc_dec_launches[0] if part == "decode" else enc_want[part][0],
            enc_dev[part].get("K1"), None,
            f"{ENC_WHAT[part]} of {ENC_ARCH} at full width and depth "
            f"(phase 4n): {enc_want[part][0]} bf16 launches; launches: "
            + ("the run's decode steps'" if part == "decode" else
               "one such call")))
    for prefix, fam, (ln, step_ms) in (
            ("internvl", "vlm", (vlm_launches, vlm_step_ms)),
            ("seamless", "encdec", (enc_launches, enc_step_ms))):
        rows[0].update(instance_fields(
            f"{prefix}_train_bf16", lm_rows[(fam, "K1")], ln["K1"],
            step_ms.get("K1"), None, mm_train_work(fam, "K1")))
    for key, name, src, replaces in TRAIN_KERNELS[1:]:
        r = train_rows[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": train_launches[key],
            "outer_launches": outer_launches[key],
            "ckpt_launches": ckpt["ckpt"][key],
            "example_launches": ckpt["example"][key],
            **({"ckpt_cli_launches": ckpt["cli"][key]}
               if key in ("K2", "K3") else {}),
            "max_abs_err": r["err"], "tolerance": r["tol"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": dominant(r["bound_by"]),
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "step_device_ms": (train["device_ms"] or {}).get(key),
            **multi_fields(key),
            **({"pass_device_ms": r["passes"]} if r["passes"] else {}),
            "work": f"one case7 training step at B=64: "
                    f"{STEP_LAUNCHES[key]} f32 launches" + (
                        ", split-K into " + "/".join(
                            str(dense_mod.dense_splits(M, Din, Dout))
                            for M, Din, Dout, _ in case7_step_shapes(cnn)[
                                "K2"]) + " slices" if key == "K2" else "")})
        if key in ("K2", "K3"):
            rows[-1].update(instance_fields(
                "bf16", lm_rows[key], lm_launches[key],
                lm_step_ms.get(key), lm_outer_launches[key],
                f"one {LM_ARCH} training step at full width, {LM_LAYERS} "
                f"layers, B=8 x S=128 (phase 4e): {7 * LM_LAYERS} bf16 "
                f"launches at M={LM_ROWS} (TMA + wgmma GEMM, persistent, "
                "not split" + (", dw written in bf16, no db)" if key == "K3"
                               else ")")))
            rows[-1].update(instance_fields(
                "granite_bf16", lm_rows[("moe", key)], moe_launches[key],
                moe_step_ms.get(key), None,
                f"one {MOE_TRAIN_ARCH} training step at full width, "
                f"{MOE_TRAIN_LAYERS} layers, B=8 x S=128 (phase 4h): "
                f"{4 * MOE_TRAIN_LAYERS} bf16 launches at M={LM_ROWS}"))
            for prefix, fam, (ln, step_ms) in (
                    ("internvl", "vlm", (vlm_launches, vlm_step_ms)),
                    ("seamless", "encdec", (enc_launches, enc_step_ms))):
                rows[-1].update(instance_fields(
                    f"{prefix}_bf16", lm_rows[(fam, key)], ln[key],
                    step_ms.get(key), None, mm_train_work(fam, key)))
            rows[-1].update(instance_fields(
                "hymba_bf16", lm_rows[("ssm", key)], ssm_launches[key],
                # both routes' kernels: in_proj's K2/K3 run the tile GEMM
                add_ms(ssm_step_ms.get(key), 1,
                       ssm_step_ms.get(f"{key} tile")), None,
                f"one {SSM_TRAIN_ARCH} training step at full width, "
                f"{SSM_TRAIN_LAYERS} layers, B=8 x S=128 (phase 4k): "
                f"{9 * SSM_TRAIN_LAYERS} bf16 launches at M={LM_ROWS}, "
                f"{SSM_TRAIN_LAYERS} of them (in_proj, 6457 columns) on the "
                f"mma.sync tile route, {8 * SSM_TRAIN_LAYERS} on the TMA + "
                "wgmma GEMM"))
    rows += attn_json_rows(attn_rows, gemma_launches["K9"],
                           launches["K9"], gem_pre_k9, k10_launches,
                           k10_diff)
    rows[-2].update({"ckpt_cli_launches": ckpt["cli"]["K9"],
                     "ckpt_cli_bwd_launches": ckpt["cli"]["K9 bwd"]})
    rows[-2].update(instance_fields(
        "bwd", lm_rows["K9 bwd"], lm_launches["K9 bwd"],
        lm_step_ms.get("K9 bwd"), lm_outer_launches["K9 bwd"],
        f"K9's backward in one {LM_ARCH} training step at full width, "
        f"{LM_LAYERS} layers (phase 4e): {2 * LM_LAYERS + 1} bf16 launches "
        f"at {LM_ROWS} x 3072; library: autograd of F.rms_norm (its "
        "backward alone)"))
    rows[-2].update(instance_fields(
        "granite_bwd", lm_rows[("moe", "K9 bwd")], moe_launches["K9 bwd"],
        moe_step_ms.get("K9 bwd"), None,
        f"K9's backward in one {MOE_TRAIN_ARCH} training step at full "
        f"width, {MOE_TRAIN_LAYERS} layers (phase 4h): "
        f"{2 * MOE_TRAIN_LAYERS + 1} bf16 launches at {LM_ROWS} x 1536"))
    L = MOE_SERVE_LAYERS
    k9_pre = qwen_pre_k["K9"].get(MOE_PROMPT, [])
    if not k9_pre or set(k9_pre) != {4 * L + 1}:
        raise AssertionError(f"prefill calls of {MOE_PROMPT} rows launched "
                             f"K9 {k9_pre} times, not {4 * L + 1}")
    for prefix, kind, n, steps, what in (
            ("qwen", "decode", qwen_launches["K9"], qwen_dec,
             "decode step (4 slots)"),
            ("qwen_prefill", "prefill", k9_pre[0], qwen_pf,
             f"prefill forward of {MOE_PROMPT} tokens")):
        rows[-2].update(instance_fields(
            prefix, qwen_k9_row(attn_rows["K9"], kind), n, steps.get("K9"),
            None, f"one {MOE_SERVE_ARCH} {what}, {L} layers (phase 4g): "
            f"{4 * L + 1} bf16 launches, {2 * L + 1} at d=2048 (ln1, ln2, "
            f"final), {L} q norms and {L} k norms at head_dim 128; "
            "launches: " + ("the serving run's" if kind == "decode" else
                            "one such call")))
    rows[-2].update(instance_fields(
        "hymba_bwd", lm_rows[("ssm", "K9 bwd")], ssm_launches["K9 bwd"],
        ssm_step_ms.get("K9 bwd"), None,
        f"K9's backward in one {SSM_TRAIN_ARCH} training step at full "
        f"width, {SSM_TRAIN_LAYERS} layers (phase 4k): "
        f"{4 * SSM_TRAIN_LAYERS + 1} bf16 launches at {LM_ROWS} x 1600"))
    for arch, (prefix, phase) in SERVED.items():
        s_launches, s_pre, s_dec, s_pf = served[arch]
        cfg = configs.get_config(arch)
        n9 = norms_per_layer(cfg) * DECODE_LAYERS[arch] + 1
        P = PREFILL_ROWS[arch]
        k9_pre = s_pre["K9"].get(P, [])
        if not k9_pre or set(k9_pre) != {n9}:
            raise AssertionError(f"prefill calls of {P} rows launched K9 "
                                 f"{k9_pre} times, not {n9}")
        for pfx, kind, n, steps, what in (
                (prefix, "decode", s_launches["K9"], s_dec,
                 "decode step (4 slots)"),
                (f"{prefix}_prefill", "prefill", k9_pre[0], s_pf,
                 prefill_what(arch))):
            rows[-2].update(instance_fields(
                pfx, serve_k9_row(attn_rows["K9"], arch, kind, n9), n,
                steps.get("K9"), None,
                f"one {arch} {what}, {DECODE_LAYERS[arch]} layers (phase "
                f"{phase}): {n9} bf16 launches at d={cfg.d_model}; "
                "launches: " + ("the serving run's" if kind == "decode"
                                else "one such call")))
    for part, prefix in ENC_PARTS.items():
        n9 = enc_want[part][1]
        rows[-2].update(instance_fields(
            prefix, serve_k9_row(attn_rows["K9"], ENC_ARCH, part, n9),
            enc_dec_launches[1] if part == "decode" else n9,
            enc_dev[part].get("K9"), None,
            f"{ENC_WHAT[part]} of {ENC_ARCH} (phase 4n): {n9} bf16 launches"
            f" at {ENC_RMS[part][0]} x {ENC_D}; launches: "
            + ("the run's decode steps'" if part == "decode" else
               "one such call")))
    for prefix, fam, (ln, step_ms) in (
            ("internvl", "vlm", (vlm_launches, vlm_step_ms)),
            ("seamless", "encdec", (enc_launches, enc_step_ms))):
        rows[-2].update(instance_fields(
            f"{prefix}_bwd", lm_rows[(fam, "K9 bwd")], ln["K9 bwd"],
            step_ms.get("K9 bwd"), None, mm_train_work(fam, "K9 bwd")))
    log(json.dumps({"kernels": rows}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
