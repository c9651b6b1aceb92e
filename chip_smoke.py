#!/usr/bin/env python
"""Drive the PyTorch port's serving and training paths (GPT-2, ResNet-50,
ViT-B/16, the video classifier, the MNIST MLP) and its shard loaders once
on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each a line of JSON on stdout; any failure raises (non-zero exit,
no final line):

1. env: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build: every kernel under ``frl_distributed_ml_scaffold_tpu_torch/ops/
   csrc`` compiled by nvcc, all in parallel, the seconds it took, and the
   registers and spill bytes of the bf16 dQ and contiguous decode kernels
   (the full ``-Xptxas -v`` reports go to ``OUT_DIR/ptxas_*.txt``).
3. kernel checks: each kernel held against its plain PyTorch version on
   the card at the serving paths' shapes, bf16 and fp32, plus a
   dirty-cache check (NaN where no row's occupancy reaches must leave the
   output bit-identical); then timed against the plain version (and one
   library call where one computes the same function), beside its bound:
   - contiguous decode: 8 slots, 16 heads, head_dim 64, S in {128, 1024},
     occupancies 1, S, random and > S; then the edges of its split over
     positions through a strided q: S = 4096, one slot (8 splits), two
     slots (4 splits) and 24 slots (B*H = 384: one split), with kv_len
     1, > S and lengths no chunk divides; and the kernel alone at every
     split count at S = 1024;
   - paged decode and verify (T = 5): the same rows and heads, block size
     16, 64-column tables into a 513-block pool with shuffled tables,
     occupancies 1, 16, 17, 1024, > 1024 (a retired row) and random;
     verify query 0 must equal the paged decode kernel bit for bit. Then
     the edges of the bf16-q kernels' split (``csrc/paged_tc.cuh``): T =
     1..8 at every forced split count 1..8 over occupancies that cross
     split boundaries and kv_len - T + 1 < 1, one slot (8 splits) and 24
     slots (one split), through a strided q; each held to the plain
     version, NaN past every row's occupancy bit-identical, query 0
     equal to the decode at the same split count bit for bit; timed at
     every split count (``ms_by_splits``).
   - quantized cache (``csrc/quant_attention.cu``; for bf16 q all three
     through ``csrc/paged_tc.cuh``, the contiguous one without its
     table): the three kernels in int8, fp8_e4m3 and fp8_e5m2, bf16 and
     fp32 q, at the same shapes (contiguous S in {128, 1024} and the
     contiguous edges above, bf16 also at every forced split count 1..8;
     the paged pool and T = 5, and the paged edges above), each against
     its plain version; NaN in the scales (and 0x7F in the payloads) of
     every position no row's occupancy reaches leaves the output
     bit-identical; quantized verify query 0 equals the quantized paged
     decode bit for bit. Timed in the format its path runs, the
     contiguous one also at every split count (``ms_by_splits``).
4. path: GPT-2-medium at full width (``gpt2_medium_serve``, seeded random
   weights, bf16_mixed) serving 16 requests through ``build_engine`` with
   8 slots over the bucketed cache; the decode kernel must launch 24 times
   per decode step, and no other kernel. One decode step's logits through
   the kernel against ``impl="dense"``. Then a few steady decode steps
   under ``torch.profiler``: device busy time, idle share and the kernels
   that take the device time.
5. paged_path: the same model with ``serving.kv_block_size=16
   serving.speculate=ngram serving.speculate_k=4`` serving 16 requests (8
   sharing a 256-token system prompt, 2 repeating a 32-token pattern, 6
   random); the paged decode and verify kernels must launch 24 times per
   paged decode and verify step and no other kernel; prefix hits, block
   appends and drafts must happen, every reservation unwinds, and the
   pool block's bytes equal the estimate. Then a profiled window.
6. quant_path and quant_paged_path: phases 4 and 5 again with
   ``model.kv_cache_quant=int8`` (contiguous) and ``fp8_e4m3`` (paged),
   through the quantized kernels, the unquantized ones launching never;
   the cache's bytes per slot and the pool block's bytes (811008) equal
   their estimates. In quant_path's profiled window the only attention
   kernel on the device is ``paged_tc.cuh``'s contiguous mode.
7. fp32 checks: the same requests under the fp32 policy, two of them
   re-run alone through ``generate()``, token for token; and the paged
   requests through the fp32 paged + ngram engine against the fp32
   contiguous engine, token for token; both again over the int8
   contiguous and the fp8_e4m3 paged cache (``fp32_quant_check``). A
   differing greedy pick passes only where the top-2 logit gap there is
   below ``FP32_GAP_TOL``.
7a. disagg_path: the same model with ``serving.kv_block_size=16
   serving.disaggregate=true`` (8 slots, ``prefill_max_per_tick=1``,
   tenants fg latency and bg best_effort) through ``build_engine``'s
   ``DisaggServingEngine``, beside the colocated paged engine in the same
   call, each a warm pass, ``reset_cache`` and a timed pass of the
   disaggregation mix (fg: 2 prompts of 4-8 tokens, 128 new; bg: 24 of
   505-512 tokens, 1 new): tokens/s, TTFT and gap-based TPOT p50 / p99
   per tenant and the fg TPOT p99 ratio (reported, not gated),
   handoffs, deferrals, preemptions, parks, resumes, the transfer
   counter (0 by construction: one shared pool has no transfer path;
   checked registered and 0) and the idle share of 4 profiled
   ticks. Both passes token-identical; the paged decode kernel 24 times
   a step and no other kernel; then a chaos pass (one
   ``serve.prefill_worker`` and one ``serve.handoff`` failure) in which
   every request ends ``ok`` with the fault-free tokens.
   draft_path: ``serving.speculate=draft serving.speculate_k=4`` with a
   seeded fp32 draft GPT (1 layer, width 128, 2 heads) against the
   plain paged engine, 8 requests of 48 new tokens, under bf16_mixed
   (timed: tokens/s, accept rate, tokens per slot-step, requests equal
   to the plain engine's) and under fp32 (token for token, the top-2-gap
   rule below); the contiguous decode kernel 3 times a draft round, the
   paged kernels 24 times a step of their kind, nothing else.
   serve_faults_check: a queue bound of 2 sheds, a queued deadline
   expires, ``serve.prefill`` quarantines (bucketed and paged) and
   ``serve.grow`` fails a growth, each with its typed completion and its
   counter in the engine's registry.
8. flash_kernel_checks: the three training-attention kernels
   (``csrc/flash_attention.cu``: forward, dQ, dK/dV) against their plain
   versions, O and lse, dQ, dK and dV, bf16 and fp32, causal and not, at
   the training path's [8, 1024, 16, 64], gpt2_long's [1, 8192, 16, 64],
   T = 1000 (not a multiple of the 64-row tile), T = 40 (below one tile)
   and head dims 32 and 128;
   then gradients through the autograd Function at the path shape
   against torch.autograd of the plain forward (fp32) and the plain
   backward (bf16). flash_kernel_timings: each kernel, its plain version
   and ``scaled_dot_product_attention`` (forward, or its backward), beside
   the bound, at both shapes, bf16, causal.
9. train_path: ``gpt2_medium_zero1`` with ``model.attention=flash`` at
   full width and depth (seeded weights, bf16_mixed, AdamW with the
   recipe's warmup, cosine and clip, dots remat, 64 x 1024 tokens in 8
   microbatches): one warm-up step (lr 0, the params must not move) and
   three timed steps; loss, grad_norm and lr per step, step seconds,
   tokens/s, model FLOPs and their share of the bf16 peak, peak memory;
   each step launches the forward kernel 384 times (twice per layer and
   microbatch: dots remat reruns it in the backward) and dQ and dK/dV 192
   times each, no serving kernel, and nothing falls back. train_profile:
   one more step under ``torch.profiler``.
10. fp32_train_check: one ``grad_accum=2`` step at full width, depth cut
   to 2 layers, through the kernels (``attention=flash``) and through the
   plain path (``attention=dense``) from the same weights and batch, fp32
   and then bf16_mixed: losses, every gradient and the params after it.
11. loop_path: the training loop as a user runs it,
   ``launcher/launch.py`` ``main`` with no --device (the card):
   ``--config=gpt2_medium_zero1 model.attention=flash
   trainer.total_steps=6 trainer.log_every=1 checkpoint.enabled=true
   checkpoint.save_every=3`` at full width and depth, its workdir a
   temporary directory under ``build/`` removed after (the port's log
   lines go to ``OUT_DIR/loop_phases.log``). Per step the flash kernels
   launch 384 / 192 / 192 times, as in train_path, and nothing else;
   the median step, samples/s, data wait, MFU (``flops_source``
   analytic) and train_path's median step beside it; the commit markers
   are steps 3 and 6, and each checkpoint's tensor payload is 12 bytes
   a parameter plus the step, its directory within 1 % above, with the
   seconds of its snapshot, its write and the loop's wait;
   ``telemetry.jsonl``, ``metrics.prom`` and ``trace_events.json``
   parse. Then 8 steps with checkpoints off: the loop's own median step
   beside train_path's.
12. loop_resume_check: a launch to step 7 under ``FRL_FAULT_PLAN`` at
   ``checkpoint.torn_write`` leaves step 7 torn (no marker; 6 is still
   the newest committed step); then step 6's marker is deleted and a
   launch to step 6 resumes from step 3 (``restore_or_init`` skips 6
   and 7), and its steps 4-6 give the first run's loss and grad_norm
   bit for bit (``LOOP_RESUME_TOL`` 0).
13. mlp_launch: ``mnist_mlp`` through ``main`` with no --device, 200
   steps; ``FRL_FAULT_PLAN`` at ``trainer.preempt`` sends SIGTERM at
   step 100: a committed checkpoint of step 100 and exit code 0; a
   second launch resumes there to step 200; the loss falls by half.
14. bn_kernel_checks / bn_kernel_timings: the two BatchNorm-backward
   kernels (``csrc/fused_bn.cu``: sums, dx) against their plain versions
   and, chained, against ``fallback_bwd``, bf16 and fp32, random gamma,
   at the rn50 path's (M, C) for the stem (3211264, 64), stage 1
   (802816, 256) and stage 4 (12544, 2048), and a ragged (12347, 100);
   timed beside their byte bounds and ``native_batch_norm_backward``.
   adamw_kernel_checks / adamw_kernel_timings: the AdamW kernel
   (``csrc/fused_adamw.cu``) against ``adamw_math`` on leaves of
   2359296, 2048000, 65536 and 65539 elements, the first and last again
   with a bf16 gradient (read in place) and with a bf16 p and g (p'
   rounded to bf16 to nearest even: within one ulp, and bit-equal in
   all but 1e-3 of the elements); timed beside its bound (28 bytes an
   element; 22 with a bf16 p and g) and ``torch._fused_adamw_``.
15. rn50_path: ``imagenet_rn50_ddp`` with ``model.fused_bn=true
   data.global_batch_size=256`` at full width and depth (seeded weights,
   bf16_mixed, the recipe's SGD with warmup, synthetic ImageNet batches
   on the card before the timed window): one warm-up step (lr 0: params
   unchanged, every running statistic moved) and three timed steps;
   loss, accuracy, grad_norm and lr per step, step seconds, images/s,
   FLOPs (``FlopCounterMode``) and their share of the bf16 peak, peak
   memory; each step launches each BN kernel 53 times and no other
   kernel. rn50_profile: one more step under ``torch.profiler``.
   rn50_adamw_path: the same with ``optimizer.name=fused_adamw``, two
   timed steps, the AdamW kernel 42 times per step.
16. fp32_rn50_check: one step of ResNet-50 (64 px, batch 8) through the
   kernels and through the plain path from the same weights and batch,
   fp32 and bf16_mixed, SGD and fused_adamw, and bf16 (bf16 gradients
   into the AdamW kernel) with fused_adamw: loss, every gradient,
   batch_stats and the params after it.
17. vit_path: ``imagenet_vitb_fsdp`` with ``data.global_batch_size=256``
   at full width and depth (86567656 params, 12 layers, D = 768, 12
   heads, 197 tokens, 1000 classes; seeded weights, bf16_mixed, the
   recipe's AdamW with warmup, cosine and clip 1.0, ``remat=full``) on
   rn50_path's synthetic ImageNet batches, already on the card: one
   warm-up step (lr 0: params unchanged) and three timed steps; loss,
   accuracy, grad_norm and lr per step, step seconds, images/s, FLOPs
   (``FlopCounterMode``, within 1 % of the analytic 26.98 TFLOP a step)
   and their share of the bf16 peak, peak memory; no kernel of the port
   launches (plain PyTorch: patches and products, attention written out
   as flax's). vit_profile: one more step under ``torch.profiler``.
18. fp32_vit_check: one ViT-B step (full width, depth 2, batch 8) on the
   card and through the port's CPU path from the same weights and
   batch, fp32 and bf16_mixed: loss, every gradient and the params after
   the update (``VIT_CHECK_TOL``).
19. video_path: ``ego4d_video_elastic`` at full width (784 tokens, 400
   classes) with batch 64 -> 16, synthetic clips made before the timed
   window: one warm-up and two timed steps, the fields of vit_path;
   video_profile: one more step under ``torch.profiler``.
20. mlp_path: ``mnist_mlp`` as published (535818 params, batch 256, fp32,
   synthetic MNIST): 200 steps of the recipe's schedule, the loss must
   fall; then 20 steps under the profiler for the idle share (the path is
   host-bound by nature).
21. shards: 2048 seeded uint8 images of 256 x 256 x 3 (0.4 GB) and
   their labels as four sealed ``train_*`` shards in a temporary
   directory under ``build/`` (with the token bin and clip shards below;
   removed at the end).
22. native_build: the port's C++ data core (``native/frl_data.cpp``)
   built by g++ on this host (seconds), its pool's threads, and every
   entry point against its numpy version bit for bit at the paths'
   shapes, both timed: ``gather_rows`` uint8 and float32 over 512 rows
   of 256 x 256 x 3, ``augment_batch`` to 224 in train and eval,
   ``gather_windows`` uint16 and uint32 over 64 x 1025 tokens; then
   ``ImageNet.batch`` at batch 512 over the shards alone: images/s and
   the gather and augment seconds.
23. stem_pool_check: on the card, the s2d stem with
   ``s2d_stem_weights(w7)`` against the conv7 stem (``STEM_TOL``) and
   the mask pool's gradient against autodiff's on a tie-free input
   (``POOL_TOL``); each stem and pool timed forward and backward at batch
   512 in bf16.
24. rn50_shards_path: ``imagenet_rn50_ddp`` at bench.py's headline point
   (``model.stem=s2d model.pool_grad=mask model.fused_bn=true
   data.global_batch_size=512``) at full width and depth through the
   port's ``Trainer`` from the shards, checkpoints off, 12 steps, the
   last two under the profiler: the median step (steps 7-10, after the
   prefetched head start), images/s, the data wait and the rest of each
   step, the idle share and 53 sums and 53 dx launches a step (and 53
   more for the loop's FLOP count); ``is_synthetic`` false and no loader
   call through numpy. Beside it in the same call: the same with
   ``data_dir`` unset (synthetic batches built on the host each step; 6
   steps) and the shards run with ``model.stem=conv7`` (8 steps).
25. lm_shards_path: a seeded uint16 token bin of 4M tokens written by
   ``write_token_bin``, then ``gpt2_medium_zero1`` with
   ``model.attention=flash data.name=lm`` through ``launch.main``, 3
   steps: 384 / 192 / 192 flash launches a step, the data wait per step.
26. video_shards_path: ``ego4d_video_elastic`` (batch 16) from 64 seeded
   uint8 clips of 8 x 224 x 224 x 3 through the ``Trainer``, 6 steps.
27. beam_path (after serve_faults_check): ``beam_search`` over the
   serving weights, 4 ragged prompts of 32-64 tokens, 4 beams, 64 new
   tokens, bf16_mixed: tokens/s and the decode kernel 24 x 63 times a
   call; in fp32 one beam equals greedy ``generate()`` (top-2-gap rule)
   and beam 0's score the teacher-forced sum of its log-probabilities.
28. long_path (after fp32_train_check): ``gpt2_long`` as published (T =
   8192, global batch 8 in 8 microbatches, ``trainer.remat=full``,
   ``lm_loss_chunk=256``, flash) from seeded weights: one warm-up and two
   timed steps, then ``trainer.remat=none`` with ``model.block_remat``
   full and save_attn on the same batches: step seconds, tokens/s, MFU,
   peak memory, the first step's loss (held across the three modes) and
   the flash launches a step.
29. adafactor_path: ``gpt2_medium_adafactor`` cut as train_path (warmup
   off, one batch repeated): the loss falls; step seconds, tokens/s and
   the optimizer state's bytes beside train_path's AdamW state.
30. optimizers_check: adam, lion, adafactor and sgd, two fp32 steps each
   on the card against the CPU from the same state and gradients.
31. dropout_check: ``gpt2_medium_zero1`` + flash with
   ``model.dropout=0.1``: each site's kept share within a binomial bound,
   one seed one loss, ``trainer.remat=full`` and ``model.block_remat=
   full`` / ``save_attn`` gradients against ``remat=none``, steps in
   turns with dropout 0, the masks' host cost.
32. init_params_check (after mlp_launch): seeded ``imagenet_rn50_ddp``
   params written as a flax msgpack file by the port, loaded under
   ``precision.policy=bf16`` (equal to the file's in bf16) and trained
   through ``launch.main`` with ``trainer.init_params_path`` and
   ``optimizer.name=fused_adamw``: 42 AdamW launches a step with a bf16
   p; ``gpt2_medium_zero1`` from a file of the serving weights: the first
   loss of the run without a file. The AdamW kernel's checks and timings
   (item 12) include a bf16 p, and the kernels line's AdamW row its
   bf16-p times.
33. mesh_path (after fp32_train_check), in a process group of one NCCL
   rank on the card whose mesh keeps its data / fsdp / model groups at
   size 1 (``build_mesh(unit_groups=True)``), so every collective of the
   step runs: train_path again through the mesh path (``mesh_setup``:
   the layout of ``parallel/layout.py``, ZeRO-1's specs over fsdp=1, a
   state of plain shards with fp32 moments, ``make_train_step`` over the
   layout), same weights and batches: losses and grad_norms equal
   train_path's bit for bit, the params' checksum equal, 384 / 192 / 192
   flash launches a step; the collectives and NCCL kernels a step, step
   seconds beside train_path's. rn50_mesh_path (after rn50_path):
   rn50_path through the mesh path from its weights and batches, sync-BN
   wired (each BatchNorm's statistics all-reduced, one all-reduce of the
   two sums between the BN kernels): 53 launches of each a step, the
   all-reduces counted, losses within ``RN50_MESH_LOSS_TOL``.
   launch_mesh: ``mnist_mlp`` through ``launch.main`` with
   ``--num-processes=1 --process-id=0 --coordinator=127.0.0.1:<port>``
   on the card, a checkpoint and a resume.
34. rn101_path / vitl_path (after mlp_path): ``imagenet_rn101_ddp`` +
   fused BN at batch 128 and ``imagenet_vitl_fsdp`` at batch 64 (cut
   from 1024 to fit one card), full width and depth, seeded weights: a
   warm-up and one timed step each; the BN kernels once per BatchNorm a
   step (RN101), none (ViT-L).
35. tp_serve_path (after beam_path): tensor-parallel serving over two
   processes of this script on the one card (``--tp-rank``; a gloo group
   carrying the CUDA tensors, chosen because NCCL refuses two ranks on
   one device), mesh ``data=1 model=2``: ``gpt2_medium_serve`` at full
   width and depth from seeded weights placed by ``build_engine(rules=
   gpt_tp_rules())``, 8 heads a rank, through the contiguous engine and
   the paged + ngram engine, fp32 then bf16_mixed, 8 requests of 32 new
   tokens each. Both ranks end with the same tokens; fp32 they are the
   one-rank engine's (top-2-gap rule); B4, B5 and B6 launch 24 times a
   step of their kind at 8 heads and agree with their plain versions
   there; the first step's bf16 logits within ``TP_BF16_LOGIT_ULPS`` of
   one rank's, and the first position the bf16 tokens part. Launches and
   collectives a step, tokens/s (gloo's host copies: no measure of TP
   serving speed). The disaggregated phase (item 7a's ``disagg_path``)
   also serves its workload with ``prefill_env=cuda:0``, a separate
   prefill partition: tokens equal the shared pool's, and the bytes
   moved equal the handoffs' analytic window bytes.
36. offload_path (after train_path): train_path's first three steps with
   ``trainer.offload_opt_state=true``: losses and grad_norms bit-equal,
   every state tensor pinned host memory, the peak memory below
   train_path's, the step beside train_path's.
36a. lowp_check (after tp_serve_path): ``qdot`` (``ops/quantization.py``)
   through each format's card route (int8 ``torch._int_mm``, fp8_e4m3
   ``torch._scaled_mm``, fp8_e5m2 the bf16 tensor cores into fp32) at
   GPT-2-medium's tensor-parallel products per rank at ``model=2`` (q /
   k / v [1024, 512], out [512, 1024], fc_in [1024, 2048], fc_out [2048,
   1024]) on 8192 rows, against its plain version on the same card
   operands (``LOWP_TOL``), timed beside bf16 ``torch.matmul`` at the
   same shape, with ``quantized_matmul`` and its straight-through
   backward. overlap_path: two processes of this script on the card
   (``--overlap-rank``, gloo) train ``gpt2_medium_tp_overlap``, its
   ``_int8`` twin (``model=2``, 8 heads a rank) and
   ``gpt2_medium_fsdp_overlap`` (``fsdp=2``) through the ``Trainer``
   with ``model.attention=flash`` at full width, 4 of the 24 layers,
   bf16_mixed, seeded weights, 8 x 1024 tokens in 2 microbatches (the
   FSDP run in one): a warm-up and two timed steps each, the warm-up
   against the
   plain Megatron / FSDP step of the same processes from the same
   weights and batch (losses within ``OVERLAP_RTOL``),
   and one fp32 step of the tensor-parallel pair (1e-4). Per step: B1-B3
   launches (2L, L, L a microbatch) at their heads, ring hops and bytes
   by dtype equal to ``ring_bytes_per_step``, staged bytes, block
   gathers, seconds and peak memory (gloo: no measure of overlap). The
   ranks' log goes to ``OUT_DIR/overlap_ranks.log``.
36b. moe_path, ep_path, sp_path (after overlap_path): ``gpt2_moe`` at
   full width, 6 of its 12 layers, on one card (``moe_phase``), then over
   ``expert=2`` at 6 of its 12 layers (``ep_phase``), and ``gpt2_ring``
   at 4 of its 24 layers, T 8192, over
   ``seq=2``, ring then Ulysses (``sp_phase``): two processes each
   (``--a12-rank``, gloo), against the one-rank step (loss and
   grad_norm; ``expert=2`` also in fp32 at 2 layers). Each rank then
   holds one MoE layer (``ep_layer_check``) or the attention
   (``sp_attention_check``) alone at the path's shapes against one rank,
   beside a control that a broken sum or ring would read; the ranks'
   logs go to ``OUT_DIR/{ep,sp}_ranks.log``.
36c. pp_path (after sp_path): ``gpt2_pp``, ``gpt2_pp_circular`` and
   ``gpt2_pipeline_mpmd`` as published but for depth (8 of the 24
   layers, D 1024, 16 heads, vocab 50257, T 1024, bf16_mixed, batch 64
   in 8 microbatches, dots remat) with ``model.attention=flash`` over
   ``pipe=4``: four processes
   of this script on the card (``--a12-rank``, ``--a12-phase pp``, gloo),
   one stage each, three steps each, held to the one-process run of the
   same params and batches (``PP_REFERENCE``; ``PP_RTOL`` on every
   step's loss and grad_norm and on the params after the steps) beside
   a control (``gpt2_pp`` with one stage's cotangent zeroed) that must
   fail the gate; per rank and step B1-B3 at 16 heads (GPipe and
   circular 96 / 48 / 48, the MPMD stages 144 / 48 / 48 and its last
   96 / 48 / 48), bytes over ``pipe`` at the send equal to
   ``pp_bytes``, staged bytes, peak memory, the 1F1B stage peaks; rank
   0 decodes the gathered ``gpt2_pp`` params through B4 (24 a decode
   step) to the plain model's tokens. The ranks' log goes to
   ``OUT_DIR/pp_ranks.log``.
36d. elastic_path (after rn50_shards_path): ``imagenet_rn50_ddp`` at
   rn50_shards_path's point (s2d stem, mask pool, fused BatchNorm,
   batch 512, full width and depth) through ``launch.main([... "--elastic"
   ...])``: the supervisor runs in this process, its children
   (``launch`` without ``--elastic``) as subprocesses on the card. The
   data is a fresh directory of hard links to pairs 0-1 of the shards
   phase, ``data.streaming=true`` refreshed every 2 steps; pairs 2-3 are
   sealed into it (``os.replace``) once the first child's
   ``metrics.jsonl`` shows step 2. ``FRL_FAULT_AT_STEP=7`` kills the
   first child after step 7 (``FRL_STEP_DELAY_S=0.5`` a step);
   checkpoints every 2 steps; the restarted child resumes from step 6 to
   10. Gates: exit 0, the supervisor's trace ``child_run`` rcs [43, 0]
   and one ``restart_wait``, ``elastic_restarts_total 1``, steps [2, 4,
   6, 8, 10] once each with finite losses, the first child's view
   widened from 2 to 4 pairs (1024 -> 2048 images) at step 4 or 6, the
   restarted child's view 4 pairs from its start, and 53 B10 and 53 B11
   kernels in the restarted child's profiled step (its
   ``torch.profiler`` trace: this process's counters do not see a
   child's launches). The children's log goes to
   ``OUT_DIR/elastic_path.log``.
36e. sanitize_check (beside elastic_path): ``sanitize("nans")`` traps
   ``0 / 0`` on the card naming ``aten.div.Tensor``; a NaN row of ``q``
   through B1 is trapped at ``aten.mul.Tensor``, the first operator
   reading the kernel's output (the launch itself goes through ctypes,
   past the dispatcher); ``mnist_mlp`` through ``launch.main`` under
   ``FRL_TPU_SANITIZE=nans,infs`` gives losses bit-equal to the run
   without it.
37. ``phase_seconds`` (the build, each phase above and the whole run),
   the ``kernels`` line (twelve kernels) and, last, ``{"ok": true,
   "device": ...}``.

Every launch count is set to 0 just before each path runs and read just
after it; a kernel's ``launches`` in the kernels line is that of its path.

Nothing here imports JAX. The CUDA check comes first: without a card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 3.35 TB/s,
# bf16 tensor cores 989 TFLOP/s, fp32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version. bf16: both round the output to bf16 (ulp 2^-7
# relative) and the kernel rounds unnormalised probabilities where the
# plain version rounds normalised ones, so allow a few ulps at |o| <= 4.
# fp32: only summation order and expf differ.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# Greedy picks of the fp32 engine (batch 8) and generate() (batch 1) may
# take different cuBLAS algorithms; a differing pick passes only where the
# top-2 logit gap there is below this (fp32 reassociation noise).
FP32_GAP_TOL = 1e-3


def emit(key: str, value) -> None:
    print(json.dumps({key: value}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# Kernels whose registers and spills the build line reports (nvcc's
# -Xptxas -v): those this script's latest redesigns touched.
PTXAS_KERNELS = ("flash_bwd_dq_tc_kernel", "decode_attention_kernel",
                 "paged_tc_kernel")


def ptxas_summary(reports: dict) -> list:
    """Registers and spill bytes of every instantiation of
    ``PTXAS_KERNELS`` from the build's ``-Xptxas -v`` reports, its
    template arguments demangled (bf16 / float, D, causal)."""
    out = []
    for source, report in reports.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" not in line:
                continue
            mangled = line.split("'")[1]
            name = next((n for n in PTXAS_KERNELS if n in mangled), None)
            if name is None:
                continue
            args = re.search(name + r"I(.*?)EEv", mangled)
            args = args[1] if args else ""
            for pat, rep in ((r"13__nv_bfloat16", "bf16,"), (r"^f", "float,"),
                             (r"Li(\d+)E", r"\1,"), (r"Lb1E", "true,"),
                             (r"Lb0E", "false,")):
                args = re.sub(pat, rep, args)
            block = " ".join(lines[i + 1: i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            out.append({"source": source,
                        "kernel": f"{name}<{args.rstrip(',')}>",
                        "registers": int(regs[1]) if regs else None,
                        "spill_store_bytes": int(spill[1]) if spill else None,
                        "spill_load_bytes": int(spill[2]) if spill else None})
    return out


def cuda_time_ms(fn, repeats: int = 20, per_call: int = 1,
                 queued: bool = True) -> float:
    """Median over ``repeats`` of CUDA-event time of ``fn()``, divided by
    the ``per_call`` launches it makes. ``queued``: a spin kernel holds
    the stream while the host enqueues ``fn``'s launches, so the events
    time the device alone; without it they time what a caller that
    launches one by one sees (host overhead included)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(20_000_000)  # ~10 ms at H100 clocks
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_call)
    return statistics.median(times)


# ------------------------------------------------------------------ kernels

# Payload formats of the quantized kernels (csrc/quant_attention.cu).
QUANT_FORMATS = ("int8", "fp8_e4m3", "fp8_e5m2")
PAGED_BS, PAGED_COLS, VERIFY_T = 16, 64, 5


def cache_pair(gen, shape, dtype, fmt):
    """K and V of ``shape [..., H, D]`` from the generator, in ``dtype``
    or, with ``fmt``, quantized as the model writes its cache. Returns
    (k, v, scales): scales are the routers' ``k_scale`` / ``v_scale``
    keywords (bf16, ``shape`` without D), empty when unquantized."""
    from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import quantize_kv

    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    if fmt is None:
        return k.to(dtype), v.to(dtype), {}
    (k, ks), (v, vs) = quantize_kv(k, fmt), quantize_kv(v, fmt)
    return k, v, {"k_scale": ks, "v_scale": vs}


def at(scales: dict, i) -> dict:
    """The scale keywords indexed like their cache."""
    return {name: s[i] for name, s in scales.items()}


def poisoned(k, v, scales: dict, dead):
    """Copies of a cache with NaN wherever ``dead`` (over its leading
    dims) is True: in K and V or, quantized, in the scales and as payload
    byte 0x7F (NaN in both fp8 formats; int8 has no NaN, and 0x7F is its
    largest value)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import byte_view

    if not scales:
        kd, vd = k.clone(), v.clone()
        kd[dead], vd[dead] = float("nan"), float("nan")
        return kd, vd, {}
    kd, vd = (byte_view(x).clone() for x in (k, v))
    kd[dead], vd[dead] = 0x7F, 0x7F
    sd = {name: s.clone() for name, s in scales.items()}
    for s in sd.values():
        s[dead] = float("nan")
    return kd.view(k.dtype), vd.view(v.dtype), sd


def held(what: str, got, want, dirty, dtype) -> float:
    """The kernel's output against its plain version within ``TOL``, and
    bit-identical with a poisoned cache. Returns the max abs error."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= TOL[dtype],
          f"{what} {dtype}: max abs err {err} > {TOL[dtype]}")
    check(torch.equal(dirty, got),
          f"{what} {dtype}: output changed with NaN where no row's "
          "occupancy reaches")
    return err


def _worst(checks: list, key: str) -> float:
    return max(e[key] for e in checks if e["dtype"] == "bfloat16")


def timed(kernel, plain, library=None, *, layers: int) -> dict:
    """``kernel(i)`` and ``plain(i)`` (and ``library(i)``) swept over
    ``layers`` layers per timed call, as a step does (so each launch finds
    its cache outside L2, like the real step), in the order plain, kernel,
    kernel, plain, library; per launch. Plus the kernel's launches
    enqueued one by one from Python, as the step sees them."""
    def sweep(op):
        def fn():
            for i in range(layers):
                op(i)
        return fn

    ms = {}
    order = [("plain", plain), ("kernel", kernel), ("kernel2", kernel),
             ("plain2", plain)] + ([("library", library)] if library else [])
    for name, op in order:
        ms[name] = cuda_time_ms(sweep(op), per_call=layers)
    return {
        "ms": statistics.median([ms["kernel"], ms["kernel2"]]),
        "plain_ms": statistics.median([ms["plain"], ms["plain2"]]),
        "library_ms": ms.get("library"),
        "unqueued_ms": cuda_time_ms(sweep(kernel), per_call=layers,
                                    queued=False),
        "order_plain_kernel_kernel_plain": [
            ms["plain"], ms["kernel"], ms["kernel2"], ms["plain2"]],
    }


def attention_bound(kv_len, cap: int, q, dtype, fmt, blocks: int = 0) -> dict:
    """The least time of one launch. Bytes: K and V at every occupied
    (position, head), D elements of ``dtype`` each or, quantized, D
    payload bytes and a 2-byte scale; the ``blocks`` table entries the
    occupancy reaches; q, o and kv_len. Operations: 4 D per (query,
    position, head) the causal occupancy admits."""
    b, h, d = q.shape[1], q.shape[-2], q.shape[-1]
    t = q.shape[2] if q.dim() == 5 else 1
    elem = torch.finfo(dtype).bits // 8
    per_kv = d * elem if fmt is None else d + 2
    n = int(kv_len.clamp(1, cap).sum())
    nbytes = (2 * n * h * per_kv + 2 * b * t * h * d * elem
              + 4 * blocks + 4 * b)
    n_q = sum(int((kv_len - (t - 1) + j).clamp(1, cap).sum())
              for j in range(t))
    flops = 4 * n_q * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


QUANT_LIBRARY_NOTE = ("no single PyTorch call attends over a 1-byte cache "
                      "with per-position scales")


def decode_inputs(gen, dtype, s, *, fmt=None, b=8, h=16, d=64, layers=1):
    """q [L, B, H, D], caches [L, B, S, H, D] (strided views into a
    2S-capacity buffer, as a grown engine cache would be; quantized to
    ``fmt`` with scales [L, B, S, H]), kv_len [B]: occupancies 1, S, > S
    and random ones in between."""
    dev = "cuda"
    q = torch.randn((layers, b, h, d), generator=gen, device=dev).to(dtype)
    k, v, sc = cache_pair(gen, (layers, b, 2 * s, h, d), dtype, fmt)
    k, v = k[:, :, :s], v[:, :, :s]
    sc = {name: x[:, :, :s] for name, x in sc.items()}
    mid = torch.randint(2, s, (b - 3,), generator=gen, device=dev)
    kv_len = torch.cat([
        torch.tensor([1, s, s + 37], device=dev), mid,
    ]).to(torch.int32)
    return q, k, v, kv_len, sc


# Split edges of the contiguous kernels (csrc/decode_attention.cu and,
# quantized with bf16 q, csrc/paged_tc.cuh without its table), beyond the
# path's shapes: (B, H, S) and occupancies. kv_len 1, > S and values no
# split's chunk divides; S = 4096 at the path's 8 x 16 (one split, 16
# passes); one slot (8 splits); two slots (4 splits); B*H = 384 >= 2 x
# 132 SMs (one split).
DECODE_EDGES = {
    "S4096": (8, 16, 4096, [1, 4101, 3001, 2999, 129, 4095, 1025, 7]),
    "one_slot": (1, 16, 4096, [2999]),
    "two_slots": (2, 16, 1024, [1000, 1030]),
    "wide_BH": (24, 16, 1024, [1, 1029, 1000] + list(range(5, 1024, 49))),
}


def _decode_case(dtype, q, k, v, kv_len, sc, what: str,
                 splits=None) -> float:
    """One contiguous decode call held against its plain version, and
    bit-identical with NaN past each row's occupancy (the kernel must
    never read those positions). Through the router, or with ``splits``
    the launch wrapper at that split count."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    def run(k, v, sc):
        if splits is None:
            return da.decode_attention(q, k, v, kv_len, **sc)
        launch = da._flash_decode_quant if sc else da._flash_decode
        return launch(q, k, v, kv_len, **sc, splits=splits)

    got = run(k, v, sc)
    want = da.decode_attention(q, k, v, kv_len.clamp_min(1), impl="dense",
                               **sc)
    dead = torch.arange(k.shape[1], device="cuda")[None, :] >= kv_len[:, None]
    kd, vd, sd = poisoned(k, v, sc, dead)
    return held(what, got, want, run(kd, vd, sd), dtype)


def decode_checks(gen, fmt=None) -> list:
    """The contiguous decode kernel (over a cache quantized to ``fmt``,
    or not) against its plain version, bf16 and fp32, S in {128, 1024};
    then at the split edges of ``DECODE_EDGES`` through a strided q and,
    quantized with bf16 q, at S = 1024 at every forced split count."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    name = fmt or "unquantized"
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for s in (128, 1024):
            q, k, v, kv_len, sc = decode_inputs(gen, dtype, s, fmt=fmt)
            q, k, v, sc = q[0], k[0], v[0], at(sc, 0)
            err = _decode_case(dtype, q, k, v, kv_len, sc,
                               f"decode kernel {name} S={s}")
            checks.append({"format": fmt or "none", "dtype": dt, "S": s,
                           "kv_len": kv_len.tolist(), "max_abs_err": err,
                           "tol": TOL[dtype], "dirty_cache_equal": True})
        if fmt is not None and dtype == torch.bfloat16:
            # The S = 1024 inputs at every split count 1..8.
            errs = [_decode_case(dtype, q, k, v, kv_len, sc,
                                 f"decode kernel {name} S=1024 splits={n}",
                                 splits=n)
                    for n in range(1, da.MAX_DECODE_SPLITS + 1)]
            checks.append({"format": fmt, "dtype": dt, "S": 1024,
                           "forced_splits": list(range(
                               1, da.MAX_DECODE_SPLITS + 1)),
                           "kv_len": kv_len.tolist(),
                           "max_abs_err": max(errs), "tol": TOL[dtype],
                           "dirty_cache_equal": True})
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        # The edges draw from a generator of their own, so the weights and
        # inputs of every later phase stay what they were without them.
        egen = torch.Generator(device="cuda").manual_seed(
            gen.initial_seed() + 1)
        for label, (b, h, s, lens) in DECODE_EDGES.items():
            d = 64
            q = torch.randn((b, h, 3 * d), generator=egen,
                            device="cuda").to(dtype)[..., d: 2 * d]
            k, v, sc = cache_pair(egen, (b, 2 * s, h, d), dtype, fmt)
            k, v = k[:, :s], v[:, :s]
            sc = {key: x[:, :s] for key, x in sc.items()}
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            err = _decode_case(dtype, q, k, v, kv_len, sc,
                               f"decode kernel {name} edge {label}")
            checks.append({"format": fmt or "none", "edge": label,
                           "dtype": dt, "B": b, "H": h, "S": s,
                           "q_strided": True,
                           "splits": da.decode_splits(b * h, s, sms),
                           "kv_len": lens, "max_abs_err": err,
                           "tol": TOL[dtype], "dirty_cache_equal": True})
    return checks


def time_decode(gen, s: int, fmt=None) -> dict:
    """The contiguous kernel (quantized to ``fmt`` or not), its plain
    version and, unquantized, one library call on the path's shapes
    (bf16 q, 24 layers' caches per timed call); then the kernel alone at
    every split count."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    layers, dtype = 24, torch.bfloat16
    q, k, v, kv_len, sc = decode_inputs(gen, dtype, s, fmt=fmt, layers=layers)
    scs = [at(sc, i) for i in range(layers)]
    lens = kv_len.clamp_min(1)
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] < lens[:, None])[:, None, None, :]  # [B,1,1,S]

    def kernel(i):
        da.decode_attention(q[i], k[i], v[i], kv_len, **scs[i])

    def plain(i):
        da.decode_attention(q[i], k[i], v[i], lens, impl="dense", **scs[i])

    def library(i):
        torch.nn.functional.scaled_dot_product_attention(
            q[i][:, :, None], k[i].transpose(1, 2), v[i].transpose(1, 2),
            attn_mask=mask,
        )

    report = timed(kernel, plain, None if fmt else library, layers=layers)
    if fmt:
        report["library_note"] = QUANT_LIBRARY_NOTE
    report["splits"] = da.decode_splits(
        q.shape[1] * q.shape[2], s,
        torch.cuda.get_device_properties(0).multi_processor_count)
    # The kernel alone (no router) at every split count, against which
    # decode_splits' choice is read.
    launch = da._flash_decode_quant if fmt else da._flash_decode
    report["ms_by_splits"] = {
        n: cuda_time_ms(lambda n=n: [
            launch(q[i], k[i], v[i], kv_len, **scs[i], splits=n)
            for i in range(layers)], per_call=layers)
        for n in range(1, da.MAX_DECODE_SPLITS + 1)}
    return {"S": s, "format": fmt or "none", "kv_len": kv_len.tolist(),
            **report, **attention_bound(kv_len, s, q, dtype, fmt)}


def kernel_phase(gen) -> dict:
    checks = decode_checks(gen)
    emit("kernel_checks", checks)
    timings = [time_decode(gen, s) for s in (128, 1024)]
    emit("kernel_timings", timings)
    return {"max_abs_err": _worst(checks, "max_abs_err"),
            "timing": timings[-1]}


# ------------------------------------------------------------ paged kernels


def paged_inputs(gen, dtype, *, fmt=None, t=None, layers=1, b=8, h=16, d=64):
    """q ([L, B, H, D], or [L, B, T, H, D] for the verify tile), pools
    [L, N, bs, H, D] with N = B * 64 + 1 (block 0 the trash block;
    quantized to ``fmt`` with scale pools [L, N, bs, H]), shuffled tables
    [B, 64] over blocks 1.. and kv_len [B]: occupancies 1, 16, 17, 1024,
    > 1024 (a retired row) and random ones."""
    dev, bs, m = "cuda", PAGED_BS, PAGED_COLS
    n = b * m + 1
    qshape = (layers, b, h, d) if t is None else (layers, b, t, h, d)
    q = torch.randn(qshape, generator=gen, device=dev).to(dtype)
    k, v, sc = cache_pair(gen, (layers, n, bs, h, d), dtype, fmt)
    perm = torch.randperm(n - 1, generator=gen, device=dev) + 1
    tables = perm.view(b, m).to(torch.int32)
    cap = m * bs
    mid = torch.randint(2, cap, (b - 5,), generator=gen, device=dev)
    kv_len = torch.cat([
        torch.tensor([1, bs, bs + 1, cap, cap + 37], device=dev), mid,
    ]).to(torch.int32)
    return q, k, v, kv_len, tables, sc


def _used_positions(kv_len, tables, n_blocks):
    """[N, bs] bool: the pool positions some row's occupancy reaches."""
    bs = PAGED_BS
    used = torch.zeros((n_blocks, bs), dtype=torch.bool, device="cuda")
    pos = torch.arange(tables.shape[1] * bs, device="cuda")
    for row, n in enumerate(kv_len.clamp(1, pos.numel()).tolist()):
        p = pos[:n]
        used[tables[row, p // bs].long(), p % bs] = True
    return used


# Split edges of the paged kernels for bf16 q (csrc/paged_tc.cuh), beyond
# the path's shapes: (B, H, table columns, occupancies), block size 16.
# "grid": 16 columns (16 tiles, so every split count 1..8 has work),
# occupancies that cross split boundaries, one past the table and 2
# (kv_len - T + 1 < 1 from T = 3), swept over T = 1..8 and every forced
# split count. "one_slot": one row, 128 columns (paged_splits: 8).
# "wide": 24 slots, B*H = 384 >= 132 SMs (one split).
PAGED_EDGES = {
    "grid": (6, 4, 16, [2, 33, 97, 130, 200, 263]),
    "one_slot": (1, 16, 128, [1999]),
    "wide": (24, 16, 64, [1, 1030, 513] + list(range(7, 1024, 49))),
}


def _paged_edge_case(dtype, fmt, q, k, v, kv_len, tables, sc, kd, vd, sd,
                     splits, what: str) -> tuple:
    """The verify tile q ``[B, T, H, D]`` and the decode of its query 0
    (at occupancy kv_len - T + 1, through q[:, 0]'s strided view) at a
    split count (None: ``paged_splits``'s), each held to its plain version
    and bit-identical over the poisoned pools; query 0 equal to the
    decode bit for bit. Returns both max abs errors."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    t = q.shape[1]
    lens = kv_len.clamp_min(1)
    dec_lens = (kv_len - (t - 1)).clamp_min(1)
    outs, errs = {}, []
    for op, qq, n in (("verify", q, lens), ("decode", q[:, 0], dec_lens)):
        launch = getattr(da, f"_flash_paged_{op}")
        plain = getattr(da, f"dense_paged_{op}_attention")
        outs[op] = launch(qq, k, v, n, tables, splits=splits, **sc)
        want = plain(qq, k, v, n, tables, **sc)
        dirty = launch(qq, kd, vd, n, tables, splits=splits, **sd)
        errs.append(held(f"paged {op} kernel {fmt or 'unquantized'} {what}",
                         outs[op], want, dirty, dtype))
    check(torch.equal(outs["verify"][:, 0], outs["decode"]),
          f"paged verify {fmt or 'unquantized'} {dtype} {what}: query 0 "
          "differs from the paged decode kernel")
    return tuple(errs)


def paged_edge_checks(gen, dtype, fmt=None) -> list:
    """``PAGED_EDGES`` through ``_paged_edge_case``: "grid" at T = 1..8 x
    splits 1..8, the others at T = VERIFY_T and the default split. fp32 q
    runs the CUDA-core kernels, which take no split (the count is
    ignored). Inputs from a generator of their own, so every later
    phase's inputs stay what they were without these."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    egen = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for label, (b, h, m, lens) in PAGED_EDGES.items():
        d, bs = 64, PAGED_BS
        n = b * m + 1
        k, v, sc = cache_pair(egen, (n, bs, h, d), dtype, fmt)
        perm = torch.randperm(n - 1, generator=egen, device="cuda") + 1
        tables = perm.view(b, m).to(torch.int32)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        dead = ~_used_positions(kv_len, tables, n)
        kd, vd, sd = poisoned(k, v, sc, dead)
        # q [B, 8, H, D]; tile T is its strided view q8[:, :T].
        q8 = torch.randn((b, da.MAX_VERIFY_TILE, h, d), generator=egen,
                         device="cuda").to(dtype)
        grid = label == "grid"
        cases = [(t, s) for t in range(1, da.MAX_VERIFY_TILE + 1)
                 for s in range(1, da.MAX_DECODE_SPLITS + 1)] if grid else [
            (VERIFY_T, None)]
        errs = [_paged_edge_case(dtype, fmt, q8[:, :t], k, v, kv_len, tables,
                                 sc, kd, vd, sd, s, f"{label} T={t} splits={s}")
                for t, s in cases]
        out.append({"format": fmt or "none", "edge": label,
                    "dtype": str(dtype).replace("torch.", ""),
                    "B": b, "H": h, "table_cols": m, "kv_len": lens,
                    "T": sorted({t for t, _ in cases}),
                    "splits": list(range(1, da.MAX_DECODE_SPLITS + 1))
                    if grid else da.paged_splits(b * h, m * bs, sms),
                    "cases": len(cases), "q_strided": True,
                    "verify_max_abs_err": max(e[0] for e in errs),
                    "decode_max_abs_err": max(e[1] for e in errs),
                    "tol": TOL[dtype], "dirty_equal": True,
                    "verify_query0_bit_equal_decode": True})
    return out


def paged_checks(gen, fmt=None) -> list:
    """The paged decode and verify kernels (over pools quantized to
    ``fmt``, or not) against their plain versions, bf16 and fp32; NaN in
    every pool position no row's occupancy reaches must leave the output
    bit-identical; verify query 0 must equal the paged decode kernel bit
    for bit. Then the split edges (``paged_edge_checks``)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, kv_len, tables, sc = paged_inputs(gen, dtype, fmt=fmt)
        qt = torch.randn((8, VERIFY_T, 16, 64), generator=gen,
                         device="cuda").to(dtype)
        q, k, v, sc = q[0], k[0], v[0], at(sc, 0)
        dead = ~_used_positions(kv_len, tables, k.shape[0])
        kd, vd, sd = poisoned(k, v, sc, dead)
        entry = {"format": fmt or "none",
                 "dtype": str(dtype).replace("torch.", ""),
                 "block_size": PAGED_BS, "table_cols": PAGED_COLS,
                 "pool_blocks": k.shape[0], "kv_len": kv_len.tolist(),
                 "tol": TOL[dtype]}
        for op, qq in (("decode", q), ("verify", qt)):
            router = getattr(da, f"paged_{op}_attention")
            plain = getattr(da, f"dense_paged_{op}_attention")
            got = router(qq, k, v, kv_len, tables, **sc)
            want = plain(qq, k, v, kv_len, tables, **sc)
            dirty = router(qq, kd, vd, kv_len, tables, **sd)
            entry[f"{op}_max_abs_err"] = held(
                f"paged {op} kernel {fmt or 'unquantized'}", got, want,
                dirty, dtype)
            entry[f"{op}_dirty_equal"] = True
        # Query 0 is the single-token step at occupancy n - T + 1.
        dec0 = da.paged_decode_attention(
            qt[:, 0].contiguous(), k, v, kv_len - (VERIFY_T - 1), tables,
            **sc)
        torch.cuda.synchronize()
        check(torch.equal(got[:, 0], dec0),
              f"paged verify {fmt or 'unquantized'} {dtype}: query 0 "
              "differs from the paged decode kernel")
        entry["verify_query0_bit_equal_decode"] = True
        checks.append(entry)
    for dtype in (torch.bfloat16, torch.float32):
        checks += paged_edge_checks(gen, dtype, fmt)
    return checks


def time_paged(gen, op: str, fmt=None) -> dict:
    """A paged kernel (over pools quantized to ``fmt``, or not) and its
    plain version at the path's shapes (bf16 q, 24 layers' pools per
    timed call)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as da

    layers, dtype = 24, torch.bfloat16
    t = VERIFY_T if op == "verify" else None
    q, k, v, kv_len, tables, sc = paged_inputs(gen, dtype, fmt=fmt, t=t,
                                               layers=layers)
    scs = [at(sc, i) for i in range(layers)]
    router = getattr(da, f"paged_{op}_attention")
    reference = getattr(da, f"dense_paged_{op}_attention")

    def kernel(i):
        router(q[i], k[i], v[i], kv_len, tables, **scs[i])

    def plain(i):
        reference(q[i], k[i], v[i], kv_len, tables, **scs[i])

    cap = PAGED_COLS * PAGED_BS
    n = kv_len.clamp(1, cap).long()
    blocks = int(((n - 1) // PAGED_BS + 1).sum())
    # The kernel alone at every split count (router clamp done), against
    # which paged_splits' choice is read.
    lens = kv_len.clamp_min(1)
    launch = getattr(da, f"_flash_paged_{op}")
    by_splits = {
        s: cuda_time_ms(lambda s=s: [
            launch(q[i], k[i], v[i], lens, tables, splits=s, **scs[i])
            for i in range(layers)], per_call=layers)
        for s in range(1, da.MAX_DECODE_SPLITS + 1)}
    return {
        "op": op, "format": fmt or "none", "T": t or 1,
        "kv_len": kv_len.tolist(), **timed(kernel, plain, layers=layers),
        "splits": da.paged_splits(
            q.shape[1] * q.shape[-2], cap,
            torch.cuda.get_device_properties(0).multi_processor_count),
        "ms_by_splits": by_splits,
        "library_note": QUANT_LIBRARY_NOTE if fmt else
        "no single PyTorch call reads K/V through a block table",
        **attention_bound(kv_len, cap, q, dtype, fmt, blocks),
    }


def paged_kernel_phase(gen) -> dict:
    checks = paged_checks(gen)
    emit("paged_kernel_checks", checks)
    timings = {op: time_paged(gen, op) for op in ("decode", "verify")}
    emit("paged_kernel_timings", timings)
    return {f"paged_{op}_attention": {
        "max_abs_err": _worst(checks, f"{op}_max_abs_err"),
        "timing": timings[op]} for op in ("decode", "verify")}


def quant_kernel_phase(gen) -> dict:
    """The three quantized kernels through the same checks, in every
    payload format and q dtype; then timed in the format its path runs
    (int8 contiguous, fp8_e4m3 paged)."""
    contiguous, paged = [], []
    for fmt in QUANT_FORMATS:
        contiguous += decode_checks(gen, fmt)
        paged += paged_checks(gen, fmt)
    emit("quant_kernel_checks", {"decode": contiguous, "paged": paged})
    timings = {
        "decode_attention_quant": time_decode(gen, 1024, "int8"),
        "paged_decode_attention_quant": time_paged(gen, "decode", "fp8_e4m3"),
        "paged_verify_attention_quant": time_paged(gen, "verify", "fp8_e4m3"),
    }
    emit("quant_kernel_timings", timings)
    worst = {"decode_attention_quant": _worst(contiguous, "max_abs_err")}
    for op in ("decode", "verify"):
        worst[f"paged_{op}_attention_quant"] = _worst(paged,
                                                      f"{op}_max_abs_err")
    return {name: {"max_abs_err": worst[name], "timing": timings[name]}
            for name in timings}


# --------------------------------------------------------------------- path


def requests(seed: int, vocab: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = np.linspace(16, 512, 16).astype(int)
    rng.shuffle(lens)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]


def serve(model, cfg, reqs, new_tokens: int):
    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    eng = build_engine(model, serving=cfg.serving, num_slots=8,
                       eos_id=50256, temperature=0.0)
    ids = [eng.submit(p, new_tokens) for p in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {c.id: c for c in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(done) == sorted(ids), "not every request completed")
    for rid, p in zip(ids, reqs):
        c = done[rid]
        check(c.finish_reason in ("eos", "length"),
              f"request {rid} finished {c.finish_reason}")
        n_new = len(c.tokens) - len(p)
        check(1 <= n_new <= new_tokens and (c.tokens[: len(p)] == p).all(),
              f"request {rid}: malformed completion")
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.model.vocab_size)).all()),
              f"request {rid}: token out of range")
    return eng, [done[i] for i in ids], wall


# Launch counters: (name in the kernels line, module under ops/, function,
# attribute).
COUNTERS = [
    ("decode_attention", "decode_attention", "decode_attention", "launches"),
    ("paged_decode_attention", "decode_attention", "paged_decode_attention",
     "launches"),
    ("paged_verify_attention", "decode_attention", "paged_verify_attention",
     "launches"),
    ("decode_attention_quant", "decode_attention", "decode_attention",
     "quant_launches"),
    ("paged_decode_attention_quant", "decode_attention",
     "paged_decode_attention", "quant_launches"),
    ("paged_verify_attention_quant", "decode_attention",
     "paged_verify_attention", "quant_launches"),
    ("flash_attention_fwd", "flash_attention", "flash_fwd", "launches"),
    ("flash_attention_bwd_dq", "flash_attention", "flash_bwd_dq", "launches"),
    ("flash_attention_bwd_dkv", "flash_attention", "flash_bwd_dkv",
     "launches"),
    ("bn_bwd_sums", "fused_bn", "bn_sums", "launches"),
    ("bn_bwd_dx", "fused_bn", "bn_dx", "launches"),
    ("fused_adamw", "fused_adamw", "adamw_kernel", "launches"),
]


def _counted(module: str, fn: str):
    import importlib

    mod = importlib.import_module(
        f"frl_distributed_ml_scaffold_tpu_torch.ops.{module}")
    return getattr(mod, fn)


def reset_launches() -> None:
    for _, module, fn, attr in COUNTERS:
        setattr(_counted(module, fn), attr, 0)


def read_launches() -> dict:
    return {name: getattr(_counted(module, fn), attr)
            for name, module, fn, attr in COUNTERS}


def check_launches(counts: dict, per_step: dict, layers: int, what: str):
    """Each kernel in ``per_step`` (name -> steps of its kind) launched
    once per layer per step and at least once; every other kernel
    never."""
    for name, n in counts.items():
        if name in per_step:
            steps = per_step[name]
            check(n == steps * layers and n > 0,
                  f"{what}: {name} launched {n} times in {steps} steps of "
                  f"{layers} layers")
        else:
            check(n == 0, f"{what}: {name} launched {n} times")


def _suffix(cfg) -> str:
    return "" if cfg.model.kv_cache_quant == "none" else "_quant"


def _latencies(comps, wall) -> dict:
    n_tok = sum(len(c.tokens) - c.prompt_len for c in comps)
    tpot = [x for c in comps for x in c.token_latencies_s[1:]]
    ttft = [c.ttft_s for c in comps]
    return {
        "generated_tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_mean_s": statistics.mean(ttft),
        "ttft_p50_s": statistics.median(ttft),
        "tpot_mean_s": statistics.mean(tpot),
        "tpot_p50_s": statistics.median(tpot),
    }


def path_phase(cfg, sd, seed: int, card: str) -> tuple:
    """The bucketed contiguous path of ``cfg`` (quantized cache or not):
    16 requests, 8 slots; the decode kernel of the cache's kind launches
    24 times per decode step and no other kernel runs; one decode step's
    logits through the kernel against ``impl="dense"``; a profiled
    window."""
    import dataclasses

    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    model = GPT(cfg.model, get_policy(cfg.precision), device="cuda")
    model.load_state_dict(sd)
    reqs = requests(seed, cfg.model.vocab_size)
    serve(model, cfg, reqs[:2], 4)  # warm-up: cuBLAS handles, kernel load
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng, comps, wall = serve(model, cfg, reqs, 64)
    counts = read_launches()
    steps, layers = eng.stats["decode_steps"], cfg.model.num_layers
    kernel = "decode_attention" + _suffix(cfg)
    check_launches(counts, {kernel: steps}, layers, "path")
    grows = {k: v for k, v in eng.stats.items() if k.startswith("grow_")}
    check(bool(grows), "the run crossed no bucket growth")
    slot_bytes = generation.cache_bytes_per_slot(eng.cache, eng.num_slots)
    est = generation.estimate_cache_bytes_per_slot(cfg.model, eng.bucket)
    check(slot_bytes == est,
          f"cache bytes per slot {slot_bytes} != estimate {est}")

    # One decode step's logits: kernel vs impl="dense", same weights.
    dense = GPT(dataclasses.replace(cfg.model, decode_attention="dense"),
                model.policy, device="cuda")
    dense.load_state_dict(sd)
    rng = np.random.default_rng(seed + 1)
    lens = torch.tensor([16, 100, 257, 512, 33, 480, 64, 300],
                        dtype=torch.int32, device="cuda")
    prompt = torch.from_numpy(
        rng.integers(0, cfg.model.vocab_size, (8, 512)).astype(np.int32)
    ).cuda()
    tok = torch.from_numpy(
        rng.integers(0, cfg.model.vocab_size, (8,)).astype(np.int32)
    ).cuda()
    out = {}
    for name, m in (("kernel", model), ("dense", dense)):
        _, cache = generation._prefill(m, prompt, lens, cache_len=1024)
        out[name] = generation._decode_step(m, cache, tok)[0].float()
    err = (out["kernel"] - out["dense"]).abs().max().item()
    scale = max(1.0, out["dense"].abs().max().item())
    tol = 8 * torch.finfo(torch.bfloat16).eps * scale
    check(err <= tol, f"decode-step logits kernel vs dense: {err} > {tol}")
    del dense
    profile = profile_phase(model, cfg, reqs)
    if _suffix(cfg):
        # bf16 q over a quantized contiguous cache: paged_tc.cuh's
        # contiguous mode (kPaged = false) is the only attention kernel.
        att = profile["attention_kernels_s"]
        ok = [re.search(r"paged_tc_kernel<\d+, true, false>", n) for n in att]
        check(bool(att) and all(ok),
              f"quant path: attention kernels {sorted(att)} in the "
              "profiled window")
    return {
        "card": card, "config": cfg.name, "policy": cfg.precision.policy,
        "kv_cache_quant": cfg.model.kv_cache_quant,
        "layers": layers, "d_model": cfg.model.hidden_dim,
        "slots": eng.num_slots, "requests": len(comps),
        "prompt_lens": [len(p) for p in reqs], "new_tokens_max": 64,
        "finish": {k: v for k, v in eng.stats.items() if k.startswith("finish_")},
        "decode_steps": steps, "kernel_launches": counts[kernel],
        "launches": counts,
        "bucket_growth": grows, "final_bucket": eng.bucket,
        **_latencies(comps, wall),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "cache_bytes_per_slot": slot_bytes,
        "estimate_cache_bytes_per_slot": est,
        "decode_logits_kernel_vs_dense": {"max_abs_err": err, "tol": tol},
    }, counts, profile


PAGED_OVERRIDES = ["serving.kv_block_size=16", "serving.speculate=ngram",
                   "serving.speculate_k=4"]
INT8_OVERRIDES = ["model.kv_cache_quant=int8"]
FP8_OVERRIDES = ["model.kv_cache_quant=fp8_e4m3"]
# GPT-2-medium's fp8 pool block of 16 positions: 24 layers x (K + V
# payloads 2*16*16*64 bytes + bf16 scales 2*16*16*2 bytes).
FP8_BLOCK_BYTES = 811008


def paged_requests(seed: int, vocab: int):
    """8 prompts sharing one 256-token system prompt with unique 16-256
    token tails, 2 repeating one 32-token pattern, 6 random of 16-512
    tokens, in a shuffled order."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    system = rng.integers(0, vocab, size=256)
    pattern = rng.integers(0, vocab, size=32)
    reqs = [np.concatenate([system, rng.integers(0, vocab, size=int(n))])
            for n in np.linspace(16, 256, 8).astype(int)]
    reqs += [np.tile(pattern, reps) for reps in (4, 8)]
    reqs += [rng.integers(0, vocab, size=int(n))
             for n in rng.integers(16, 513, size=6)]
    order = rng.permutation(len(reqs))
    return [reqs[i].astype(np.int32) for i in order]


def paged_path_phase(cfg, sd, seed: int, card: str) -> tuple:
    """The paged + ngram path of ``cfg`` (quantized pools or not): the
    paged decode and verify kernels of the pool's kind launch 24 times
    per step of their kind and no other kernel runs; prefix hits, block
    appends and drafts happen; every reservation unwinds; the live block
    bytes equal the estimate. Then a profiled window."""
    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides
    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    cfgp = apply_overrides(cfg, PAGED_OVERRIDES)
    model = GPT(cfgp.model, get_policy(cfgp.precision), device="cuda")
    model.load_state_dict(sd)
    reqs = paged_requests(seed, cfgp.model.vocab_size)
    serve(model, cfgp, reqs[:2], 4)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    eng, comps, wall = serve(model, cfgp, reqs, 64)
    counts = read_launches()
    st, layers = eng.stats, cfgp.model.num_layers
    sfx = _suffix(cfgp)
    check_launches(counts, {"paged_decode_attention" + sfx: st["decode_paged"],
                            "paged_verify_attention" + sfx: st["decode_verify"]},
                   layers, "paged path")
    for key in ("prefix_hits", "block_append", "spec_proposed"):
        check(st[key] > 0, f"paged path: stats[{key!r}] is 0")
    check(eng._reserved_future == 0 and not any(eng._slot_blocks),
          "paged path: reservations or slot blocks left after the run")
    est = generation.estimate_pool_block_bytes(cfgp.model, PAGED_BS)
    check(eng.block_bytes() == est,
          f"pool block bytes {eng.block_bytes()} != estimate {est}")
    if sfx:
        check(est == FP8_BLOCK_BYTES,
              f"quantized pool block {est} bytes, not {FP8_BLOCK_BYTES}")
    report = {
        "card": card, "config": cfgp.name,
        "overrides": PAGED_OVERRIDES + (
            [f"model.kv_cache_quant={cfgp.model.kv_cache_quant}"] if sfx else []),
        "policy": cfgp.precision.policy, "layers": layers,
        "d_model": cfgp.model.hidden_dim, "slots": eng.num_slots,
        "requests": len(comps), "prompt_lens": [len(p) for p in reqs],
        "new_tokens_max": 64,
        "finish": {k: v for k, v in st.items() if k.startswith("finish_")},
        "stats": dict(st),
        "launches": counts,
        **_latencies(comps, wall),
        "spec_accept_rate": st["spec_accepted"] / st["spec_proposed"],
        "tokens_per_slot_step": st["step_tokens"] / st["slot_steps"],
        "pool_blocks": eng.pool_blocks,
        "pool_peak_blocks": st["pool_peak_blocks"],
        "block_bytes": eng.block_bytes(),
        "estimate_pool_block_bytes": est,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    profile = profile_phase(model, cfgp, reqs)
    del model
    return report, counts, profile


def _short_kernel_name(name: str) -> str:
    """A CUDA kernel's name without its return type and parameter list,
    cut to 100 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    return name.split("(", 1)[0][:100]


def profile_phase(model, cfg, reqs, steps: int = 8) -> dict:
    """Where a decode step's time goes: ``steps`` steady decode steps of
    8 live slots under ``torch.profiler``; device busy time is the union
    of the CUDA events' intervals."""
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    eng = build_engine(model, serving=cfg.serving, num_slots=8,
                       temperature=0.0)
    for p in reqs[:8]:
        eng.submit(p, steps + 2)
    eng.step()  # admissions and the first decode, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"decode_steps": steps, "slots": 8, "step_s": wall / steps,
            **device_profile(prof, wall)}


def device_profile(prof, wall: float) -> dict:
    """Device busy time (the union of the CUDA events' intervals), idle
    share of ``wall``, the kernels that take the device time and the host
    operators by self CPU time, from a finished ``torch.profiler``."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        name = _short_kernel_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e6  # profiler times are microseconds
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    attention = {name: t for name, t in by_name.items()
                 if re.search(r"attention_kernel|paged_tc_kernel", name)}
    # The host side: operators and runtime calls by self CPU time.
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {
        "wall_s": wall,
        "device_busy_s": busy if spans else "not measured",
        "device_idle_share": 1 - busy / wall if spans else "not measured",
        "cuda_events": len(spans),
        "top_device_s": [[name, t] for name, t in top],
        "attention_kernels_s": attention,
        "top_host_self_s": [[a.key[:80], a.self_cpu_time_total / 1e6, a.count]
                            for a in host[:12]],
    }


def fp32_phase(cfg, sd, seed: int) -> dict:
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import PrecisionConfig
    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    cfg32 = cfg.replace(precision=PrecisionConfig(policy="fp32"))
    model = GPT(cfg32.model, get_policy("fp32"), device="cuda")
    model.load_state_dict(sd)
    reqs = requests(seed, cfg.model.vocab_size)
    _, comps, _ = serve(model, cfg32, reqs, 64)
    report = []
    # The first request admitted and the longest prompt (admitted into a
    # refilled slot after bucket growth).
    picks = [0, max(range(len(reqs)), key=lambda i: len(reqs[i]))]
    for i in picks:
        c = comps[i]
        n_new = len(c.tokens) - c.prompt_len
        ref = generation.generate(
            model, torch.from_numpy(reqs[i])[None].cuda(),
            max_new_tokens=n_new, temperature=0.0, device="cuda",
        )[0].cpu().numpy()
        diff = [j for j in range(len(ref)) if ref[j] != c.tokens[j]]
        entry = {"request": i, "prompt_len": c.prompt_len, "new": n_new,
                 "identical": not diff}
        if diff:
            j = diff[0]
            with torch.no_grad():
                ctx = torch.from_numpy(c.tokens[:j])[None].cuda()
                logits, _ = generation._prefill(
                    model, ctx, None,
                    cache_len=generation.next_cache_bucket(
                        cfg.model.seq_len, j),
                )
            top2 = torch.topk(logits[0].float(), 2).values
            gap = (top2[0] - top2[1]).item()
            entry.update(first_diff_step=j - c.prompt_len, top2_gap=gap,
                         gap_tol=FP32_GAP_TOL)
            check(gap <= FP32_GAP_TOL,
                  f"fp32 engine vs generate(): request {i} differs at step "
                  f"{j - c.prompt_len} with top-2 gap {gap}")
        report.append(entry)
    del model
    return {"policy": "fp32", "allow_tf32": False, "requests": report}


def _top2_gap(model, cfg, tokens) -> float:
    """fp32 top-2 logit gap of the greedy pick after ``tokens``."""
    from frl_distributed_ml_scaffold_tpu_torch.models import generation

    with torch.no_grad():
        ctx = torch.from_numpy(tokens)[None].cuda()
        logits, _ = generation._prefill(
            model, ctx, None,
            cache_len=generation.next_cache_bucket(cfg.model.seq_len,
                                                   len(tokens)),
        )
    top2 = torch.topk(logits[0].float(), 2).values
    return (top2[0] - top2[1]).item()


def fp32_paged_phase(cfg, sd, seed: int) -> dict:
    """The paged requests through the fp32 paged + ngram engine, held
    token for token against the fp32 contiguous engine."""
    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import PrecisionConfig
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    cfg32 = cfg.replace(precision=PrecisionConfig(policy="fp32"))
    cfg32p = apply_overrides(cfg32, PAGED_OVERRIDES)
    model = GPT(cfg32.model, get_policy("fp32"), device="cuda")
    model.load_state_dict(sd)
    reqs = paged_requests(seed, cfg.model.vocab_size)
    eng, paged, _ = serve(model, cfg32p, reqs, 64)
    _, contiguous, _ = serve(model, cfg32, reqs, 64)
    report = []
    for i, (a, b) in enumerate(zip(paged, contiguous)):
        n = min(len(a.tokens), len(b.tokens))
        diff = [j for j in range(n) if a.tokens[j] != b.tokens[j]]
        entry = {"request": i, "prompt_len": a.prompt_len,
                 "new": len(a.tokens) - a.prompt_len,
                 "identical": not diff and len(a.tokens) == len(b.tokens)}
        if diff:
            j = diff[0]
            gap = _top2_gap(model, cfg32, a.tokens[:j])
            entry.update(first_diff_step=j - a.prompt_len, top2_gap=gap,
                         gap_tol=FP32_GAP_TOL)
            check(gap <= FP32_GAP_TOL,
                  f"fp32 paged vs contiguous engine: request {i} differs at "
                  f"step {j - a.prompt_len} with top-2 gap {gap}")
        else:
            check(len(a.tokens) == len(b.tokens),
                  f"fp32 paged vs contiguous engine: request {i} lengths "
                  "differ with no differing token")
        report.append(entry)
    stats = {k: eng.stats[k] for k in ("decode_paged", "decode_verify",
                                       "prefix_hits", "spec_accepted",
                                       "spec_proposed")}
    del model
    return {"policy": "fp32", "allow_tf32": False, "engine_stats": stats,
            "identical": sum(e["identical"] for e in report),
            "requests": report}


# ------------------------------------------------ disaggregation and draft

DISAGG_OVERRIDES = ["serving.kv_block_size=16", "serving.disaggregate=true"]
DRAFT_OVERRIDES = ["serving.kv_block_size=16", "serving.speculate=draft",
                   "serving.speculate_k=4"]
# The disaggregated pass's fault drill: one prefill-worker failure and one
# handoff failure mid-burst (each re-queued once).
DISAGG_CHAOS = [dict(site="serve.prefill_worker", at=2, times=1),
                dict(site="serve.handoff", at=3, times=1)]
# Ticks of the disaggregated pass under the profiler: a prefill and a
# decode step each, inside the burst.
DISAGG_PROFILE_TICKS = 4


def disagg_workload(cfg, slots: int, seed: int, max_new: int = 64):
    """The mix the disaggregation A/B serves: a decode-heavy foreground
    (2 prompts of 4-8 tokens, budget ``min(2 max_new, seq_len / 8)``: 128
    new tokens at 1024 context) and a prefill-heavy burst (3 x ``slots``
    prompts of half the context less 0-7 tokens, budget 1)."""
    import numpy as np

    rng = np.random.default_rng(seed + 5)
    vocab = cfg.vocab_size
    budget = max(16, min(2 * max_new, cfg.seq_len // 8))
    dec = [(rng.integers(0, vocab, size=int(rng.integers(4, 9)))
            .astype(np.int32), budget) for _ in range(2)]
    half = cfg.seq_len // 2
    burst = [(rng.integers(0, vocab, size=half - int(rng.integers(0, 8)))
              .astype(np.int32), 1) for _ in range(3 * slots)]
    return dec, burst


def _gap_ms(comps) -> list:
    """Inter-token gaps (ms) of ``comps`` from their token arrival times:
    the TPOT a decoding tenant sees, inline prefills included."""
    import numpy as np

    gaps = []
    for c in comps:
        if len(c.token_times_s) > 1:
            gaps.extend((np.diff(np.asarray(c.token_times_s)) * 1e3).tolist())
    return gaps


def _tenant_slo(comps) -> dict:
    import numpy as np

    gaps = _gap_ms(comps)
    ttft = [c.ttft_s * 1e3 for c in comps]
    return {
        "requests": len(comps),
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "tpot_gap_ms_p50": float(np.percentile(gaps, 50)) if gaps else None,
        "tpot_gap_ms_p99": float(np.percentile(gaps, 99)) if gaps else None,
    }


def disagg_phase(cfg, sd, seed: int, card: str) -> dict:
    """``gpt2_medium_serve`` at full width and depth with
    ``serving.kv_block_size=16``, 8 slots: the colocated paged engine and
    the disaggregated one (``serving.disaggregate=true``, tenants fg
    latency and bg best_effort, ``prefill_max_per_tick=1``) serve
    ``disagg_workload`` each as a warm pass, ``reset_cache`` and a timed
    pass. Both timed passes must be token-identical; the paged decode
    kernel launches 24 times per decode step and no other kernel runs;
    the shared pool moves no bytes at handoff. Then a profiled pass of
    the disaggregated engine (idle share) and a chaos pass (one
    prefill-worker and one handoff failure) whose every request ends
    ``ok``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch import faults
    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.serving import (
        DisaggServingEngine,
        TenantSpec,
        build_engine,
    )

    cfgd = apply_overrides(cfg, DISAGG_OVERRIDES)
    cfgc = apply_overrides(cfg, DISAGG_OVERRIDES[:1])
    model = GPT(cfgd.model, get_policy(cfgd.precision), device="cuda")
    model.load_state_dict(sd)
    slots, layers = 8, cfgd.model.num_layers
    dec, burst = disagg_workload(cfgd.model, slots, seed)
    tenants = [TenantSpec("fg", "latency"), TenantSpec("bg", "best_effort")]

    def submit_all(eng, disagg):
        ids = []
        for group, work in (("fg", dec), ("bg", burst)):
            for p, n in work:
                kw = {"tenant": group} if disagg else {}
                ids.append((group, eng.submit(p, n, **kw)))
        return ids

    def timed(eng, disagg):
        submit_all(eng, disagg)  # warm pass
        eng.run()
        eng.reset_cache()
        ids = submit_all(eng, disagg)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = {c.id: c for c in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches()
        check(sorted(done) == sorted(i for _, i in ids),
              "disagg path: not every request completed")
        comps = [(g, done[i]) for g, i in ids]
        for g, c in comps:
            check(c.ok, f"disagg path: request {c.id} finished "
                  f"{c.finish_reason}")
        st = eng.stats
        check_launches(counts, {"paged_decode_attention": st["decode_paged"]},
                       layers, "disagg path")
        n_tok = sum(len(c.tokens) - c.prompt_len for _, c in comps)
        return comps, {
            "wall_s": wall, "generated_tokens": n_tok,
            "tokens_per_s": n_tok / wall,
            "fg": _tenant_slo([c for g, c in comps if g == "fg"]),
            "bg": _tenant_slo([c for g, c in comps if g == "bg"]),
            "decode_steps": st["decode_steps"], "launches": counts,
        }

    colo = build_engine(model, serving=cfgc.serving, num_slots=slots,
                        temperature=0.0)
    colo_comps, colo_rep = timed(colo, False)
    eng = build_engine(model, serving=cfgd.serving, num_slots=slots,
                       temperature=0.0, tenants=tenants)
    check(isinstance(eng, DisaggServingEngine),
          "build_engine did not dispatch to DisaggServingEngine")
    comps, rep = timed(eng, True)
    for (_, a), (_, b) in zip(colo_comps, comps):
        check(np.array_equal(a.tokens, b.tokens),
              f"disagg path: request {b.id} differs from the colocated run")
    st = dict(eng.stats)
    check(st["handoffs"] == len(comps) == st["handoff_splices"],
          "disagg path: a request did not cross by handoff")
    # Shared-pool mode has no transfer path: the handoff re-owns blocks,
    # so the transfer counter reads 0 by construction. What is checked is
    # that it is registered, still 0, and absent from the stats.
    transfer = eng.telemetry.snapshot().get(
        "serve_handoff_transfer_bytes_total")
    check(transfer == 0 and "handoff_transfer_bytes" not in st,
          "disagg path: the transfer counter is missing or moved in "
          f"shared-pool mode ({transfer})")
    check(st["prefill_deferred"] > 0, "disagg path: the burst never deferred")
    check(eng.decode._reserved_future == 0 and not any(
        eng.decode._slot_blocks), "disagg path: reservations left")
    handoff_h = eng.telemetry.histogram("serve_handoff_seconds")

    # Idle share: the burst's first DISAGG_PROFILE_TICKS ticks of one
    # more pass of the disaggregated engine, profiled.
    eng.reset_cache()
    submit_all(eng, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DISAGG_PROFILE_TICKS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_rep = device_profile(prof, wall)
    eng.run()

    # Chaos: each failure re-queues once, every request still serves.
    eng.reset_cache()
    plan = faults.FaultPlan(DISAGG_CHAOS, seed=seed)
    with faults.active(plan):
        ids = submit_all(eng, True)
        chaos = {c.id: c for c in eng.run()}
    cst = eng.stats
    check(sorted(chaos) == sorted(i for _, i in ids) and all(
        c.ok for c in chaos.values()),
        "disagg chaos: a request did not end ok")
    check(cst["prefill_worker_failures"] == 1 and cst["handoff_failures"] == 1,
          f"disagg chaos: failures {dict(cst)}")
    for (_, i), (_, c) in zip(ids, comps):
        check(np.array_equal(chaos[i].tokens, c.tokens),
              f"disagg chaos: request {i} differs from the fault-free run")
    # A separate prefill partition on this card: the worker's own params
    # replica, and each handoff's private-block window moved back,
    # counted.
    sep = build_engine(model, serving=cfgd.serving, num_slots=slots,
                       temperature=0.0, tenants=tenants,
                       prefill_env=torch.device("cuda:0"))
    check(sep.prefill_worker.separate, "disagg path: no separate partition")
    sep_ids = submit_all(sep, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sep_done = {c.id: c for c in sep.run()}
    torch.cuda.synchronize()
    sep_wall = time.perf_counter() - t0
    for (_, i), (_, c) in zip(sep_ids, comps):
        check(np.array_equal(sep_done[i].tokens, c.tokens),
              f"disagg partition: request {i} differs from the shared pool")
    bs = cfgd.serving.kv_block_size
    hd = cfgd.model.hidden_dim // cfgd.model.num_heads
    per_pos = (layers * 2 * cfgd.model.num_heads * hd
               * model.policy.compute_dtype.itemsize)

    def window(tok: int) -> int:  # K/V of tok positions + the cursors
        return per_pos * tok + layers * 4 + 4

    want = 0
    for c in sep_done.values():
        saved = c.prefill_tokens_saved
        want += window(-(-c.prompt_len // bs) * bs - saved)
        want += window(saved) if saved else 0
    sst = sep.stats
    moved = sst["handoff_transfer_bytes"]
    counter = sep.telemetry.snapshot()["serve_handoff_transfer_bytes_total"]
    check(moved == want == counter,
          f"disagg partition: moved {moved}, counter {counter}, the "
          f"windows {want}")
    partition = {"prefill_env": "cuda:0", "token_identical": True,
                 "handoffs": sst["handoffs"], "wall_s": sep_wall,
                 "handoff_transfer_bytes": moved,
                 "analytic_window_bytes": want,
                 "prefix_hits": sst.get("prefix_hits", 0)}
    del sep
    torch.cuda.empty_cache()
    fg_c, fg_d = colo_rep["fg"], rep["fg"]
    report = {
        "card": card, "config": cfgd.name, "overrides": DISAGG_OVERRIDES,
        "policy": cfgd.precision.policy, "layers": layers,
        "d_model": cfgd.model.hidden_dim, "slots": slots,
        "prefill_max_per_tick": eng.prefill_max_per_tick,
        "fg_requests": len(dec), "fg_budget": dec[0][1],
        "bg_requests": len(burst),
        "bg_prompt_lens": [len(p) for p, _ in burst],
        "colocated": colo_rep, "disaggregated": rep,
        "fg_tpot_gap_p99_ratio_colocated_over_disagg": (
            fg_c["tpot_gap_ms_p99"] / fg_d["tpot_gap_ms_p99"]),
        "tokens_per_s_ratio_disagg_over_colocated": (
            rep["tokens_per_s"] / colo_rep["tokens_per_s"]),
        "token_identical": True,
        "handoffs": st["handoffs"],
        "handoff_p50_ms": handoff_h.quantile(0.5) * 1e3,
        "prefill_deferred": st["prefill_deferred"],
        "admission_deferred": st.get("admission_deferred", 0),
        "preemptions": st.get("preemptions", 0),
        "parked": st.get("parked", 0), "resumed": st.get("resumed", 0),
        "handoff_transfer_bytes": transfer,
        "handoff_transfer_bytes_note": "0 by construction: one shared pool, "
                                       "no transfer path",
        "separate_partition": partition,
        "stats": st,
        "profile": {"ticks": DISAGG_PROFILE_TICKS, **{
            k: profile_rep[k] for k in (
                "wall_s", "device_busy_s", "device_idle_share",
                "cuda_events", "top_device_s")}},
        "chaos": {"injected": dict(plan.injected),
                  "prefill_worker_failures": cst["prefill_worker_failures"],
                  "handoff_failures": cst["handoff_failures"],
                  "requeued": cst["prefill_worker_requeued"]
                  + cst["handoff_requeued"],
                  "completed_ok": len(chaos)},
    }
    del model
    return report


def draft_phase(cfg, sd, seed: int, card: str) -> dict:
    """The paged engine with ``serving.speculate=draft
    serving.speculate_k=4`` and a seeded fp32 draft GPT of one layer,
    width ``hidden_dim / 8`` (128) and 2 heads, against the plain paged
    engine on 8 of the paged path's requests, 48 new tokens each. Each
    draft round is one ``generate`` of the draft that launches the
    contiguous decode kernel ``speculate_k - 1`` times; the target's
    verify and decode steps launch the paged kernels 24 times each;
    nothing else launches. Under the serving policy (bf16_mixed) it is
    timed, with its accept rate and tokens per slot-step (a random draft
    accepts little) and how many requests equal the plain engine's (the
    verify tile's products take other GEMM shapes than a decode step's,
    so a bf16 near-tie may flip). Under fp32 it is held to the plain
    engine token for token: a differing greedy pick passes only where the
    top-2 logit gap there is below ``FP32_GAP_TOL``."""
    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        GPTConfig,
        PrecisionConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    dcfg = GPTConfig(vocab_size=cfg.model.vocab_size, num_layers=1,
                     num_heads=2, hidden_dim=cfg.model.hidden_dim // 8,
                     seq_len=cfg.model.seq_len)
    draft = GPT(dcfg, get_policy("fp32"), device="cuda")
    draft.load_state_dict(init_params(
        dcfg, torch.Generator("cuda").manual_seed(seed + 11)))
    reqs = paged_requests(seed, cfg.model.vocab_size)[:8]
    new_tokens, layers = 48, cfg.model.num_layers

    def serve_all(eng):
        ids = [eng.submit(p, new_tokens) for p in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = {c.id: c for c in eng.run()}
        torch.cuda.synchronize()
        return [done[i] for i in ids], time.perf_counter() - t0

    def run(cfg_run):
        """Plain and draft engines over ``cfg_run``'s policy: warm
        passes, then one timed pass each (launches read over the draft
        engine's)."""
        model = GPT(cfg_run.model, get_policy(cfg_run.precision),
                    device="cuda")
        model.load_state_dict(sd)
        plain = build_engine(
            model, serving=apply_overrides(cfg_run, DRAFT_OVERRIDES[:1])
            .serving, num_slots=8, temperature=0.0)
        serve_all(plain)  # warm-up
        plain.reset_cache()
        want, plain_wall = serve_all(plain)
        eng = build_engine(
            model, serving=apply_overrides(cfg_run, DRAFT_OVERRIDES).serving,
            num_slots=8, temperature=0.0, draft_model=draft)
        rounds = [0]
        draft_fn = eng._draft_fn

        def counted(windows, lens):
            rounds[0] += 1
            return draft_fn(windows, lens)

        eng._draft_fn = counted
        serve_all(eng)  # warm-up
        eng.reset_cache()
        rounds[0] = 0
        reset_launches()
        got, wall = serve_all(eng)
        counts = read_launches()
        st = eng.stats
        what = f"draft path ({cfg_run.precision.policy})"
        b4 = counts.pop("decode_attention")
        check(b4 == rounds[0] * (eng.spec_k - 1) * dcfg.num_layers and b4 > 0,
              f"{what}: the draft's decode kernel launched {b4} times in "
              f"{rounds[0]} rounds")
        check(st["decode_verify"] > 0 and st["spec_proposed"] > 0,
              f"{what}: nothing was proposed")
        check_launches(counts, {n: s for n, s in (
            ("paged_decode_attention", st["decode_paged"]),
            ("paged_verify_attention", st["decode_verify"])) if s},
            layers, what)
        check(all(c.ok for c in got) and eng._reserved_future == 0
              and not any(eng._slot_blocks), f"{what}: reservations left")
        n_tok = sum(len(c.tokens) - c.prompt_len for c in got)
        report = {
            "tokens_per_s": n_tok / wall,
            "plain_paged_tokens_per_s": n_tok / plain_wall,
            "spec_accept_rate": st["spec_accepted"] / st["spec_proposed"],
            "tokens_per_slot_step": st["step_tokens"] / st["slot_steps"],
            "draft_rounds": rounds[0], "draft_decode_launches": b4,
            "launches": {**counts, "decode_attention": b4},
            "stats": dict(st),
        }
        diffs = []
        for i, (a, b) in enumerate(zip(got, want)):
            n = min(len(a.tokens), len(b.tokens))
            j = next((j for j in range(n) if a.tokens[j] != b.tokens[j]), None)
            if j is None:
                check(len(a.tokens) == len(b.tokens),
                      f"{what}: request {i} lengths differ")
                continue
            diffs.append({"request": i, "first_diff_step": j - a.prompt_len,
                          "top2_gap": _top2_gap(model, cfg_run,
                                                a.tokens[:j])})
        report["identical_to_plain_paged"] = len(got) - len(diffs)
        report["differing"] = diffs
        return report

    bf16 = run(apply_overrides(cfg, DRAFT_OVERRIDES[:1]))
    fp32 = run(cfg.replace(precision=PrecisionConfig(policy="fp32")))
    for d in fp32["differing"]:
        check(d["top2_gap"] <= FP32_GAP_TOL,
              f"draft path (fp32): request {d['request']} differs from the "
              f"plain paged engine at step {d['first_diff_step']} with "
              f"top-2 gap {d['top2_gap']}")
    del draft
    return {
        "card": card, "config": cfg.name, "overrides": DRAFT_OVERRIDES,
        "layers": layers,
        "draft": {"layers": dcfg.num_layers, "d_model": dcfg.hidden_dim,
                  "heads": dcfg.num_heads, "policy": "fp32"},
        "slots": 8, "requests": len(reqs), "new_tokens": new_tokens,
        "bf16_mixed": bf16, "fp32": fp32, "gap_tol": FP32_GAP_TOL,
    }


def serve_faults_phase(cfg, sd) -> dict:
    """The colocated engine's typed failures on the card, at full width:
    a queue bound of 2 sheds, a request queued past its deadline expires
    before its prefill, the ``serve.prefill`` site quarantines a request
    (paged: its reservation released) and ``serve.grow`` fails a bucket
    growth; each with its completion and its counter in the registry,
    and the other requests served."""
    import dataclasses

    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch import faults
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.serving import ServingEngine

    model = GPT(cfg.model, get_policy(cfg.precision), device="cuda")
    model.load_state_dict(sd)
    serving = cfg.serving
    p = np.arange(16, dtype=np.int32) + 100
    out = {}

    def engine(slots=2, **kw):
        return ServingEngine(model, num_slots=slots, temperature=0.0,
                             serving=dataclasses.replace(serving, **kw))

    eng = engine(slots=1, max_queue_depth=2)
    ids = [eng.submit(p + i, 3) for i in range(4)]
    done = {c.id: c for c in eng.run()}
    reasons = [done[i].finish_reason for i in ids]
    check(reasons == ["length", "length", "shed", "shed"],
          f"serve faults: shed {reasons}")
    out["shed"] = {"reasons": reasons, "serve_shed_total":
                   eng.telemetry.counter("serve_shed_total").value}
    check(out["shed"]["serve_shed_total"] == 2, "serve faults: shed counter")

    eng = engine(slots=1)
    ra = eng.submit(p, 6, deadline_s=1e-6)
    rb = eng.submit(p + 1, 3)
    time.sleep(0.01)
    done = {c.id: c for c in eng.run()}
    n = eng.telemetry.counter("serve_deadline_miss_total").value
    check(done[ra].finish_reason == "deadline" and done[rb].ok and n == 1,
          "serve faults: queued deadline")
    out["deadline"] = {"reasons": [done[ra].finish_reason,
                                   done[rb].finish_reason],
                       "serve_deadline_miss_total": n}

    for name, kw in (("quarantine", {}),
                     ("quarantine_paged", {"kv_block_size": 16})):
        eng = engine(**kw)
        ra, rb = eng.submit(p, 4), eng.submit(p + 1, 4)
        with faults.active(faults.FaultPlan(
                [dict(site="serve.prefill", key=str(ra))])):
            done = {c.id: c for c in eng.run()}
        n = eng.telemetry.counter("serve_quarantined_total").value
        check(done[ra].finish_reason == "error" and done[rb].ok and n == 1,
              f"serve faults: {name}")
        if kw:
            check(eng._reserved_future == 0, "serve faults: reservation left")
        out[name] = {"reasons": [done[ra].finish_reason,
                                 done[rb].finish_reason],
                     "serve_quarantined_total": n}

    eng = engine()
    ra = eng.submit(p[:4], 30)  # grows past the first bucket
    rb = eng.submit(p[:3] + 1, 4)
    with faults.active(faults.FaultPlan([dict(site="serve.grow")])):
        done = {c.id: c for c in eng.run()}
    n = eng.telemetry.counter("serve_grow_failures_total").value
    check(done[ra].finish_reason == "error" and done[rb].ok and n == 1
          and len(done[ra].tokens) > done[ra].prompt_len,
          "serve faults: grow")
    out["grow"] = {"reasons": [done[ra].finish_reason,
                               done[rb].finish_reason],
                   "serve_grow_failures_total": n,
                   "partial_tokens": len(done[ra].tokens)
                   - done[ra].prompt_len}
    del model
    return out


# ------------------------------------------------------------ flash kernels

# (B, T, H, D) of each check: the training path's attention, gpt2_long's,
# a T that is not a multiple of the kernels' 64-row tile, a T below one
# tile, and the other two head dims the kernels take.
FLASH_SHAPES = {
    "path": (8, 1024, 16, 64),
    "gpt2_long": (1, 8192, 16, 64),
    "ragged_T": (2, 1000, 4, 64),
    "short_T": (1, 40, 2, 64),
    "head_dim_32": (2, 256, 4, 32),
    "head_dim_128": (2, 256, 4, 128),
}
# Flash kernels vs their plain versions, as a fraction of
# max(1, max|plain|). bf16: both round each output to bf16 (ulp 2^-8
# relative) and round P (dS for dQ) to bf16 before a product, the kernel
# at its running max, the plain version at the row's global max; dK/dV's
# fp32 P and dS enter the tensor cores as bf16 hi + lo (about 16 bits).
# fp32 (and lse under both): every product is a full-fp32 FMA in the
# kernel and a full-fp32 matmul in the plain version (TF32 off), so only
# summation order differs, over up to 8192 terms; the bf16 kernels' exp
# is the special-function unit's 2^x of a log2(e)-prescaled score, a few
# fp32 ulps from exp.
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
FLASH_ENTRIES = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def flash_inputs(gen, shape, dtype, n: int = 4) -> list:
    """``n`` tensors made in the public (B, T, H, D) layout and returned
    as (B, H, T, D) views of it, so the kernels read through strides as
    the training path has them."""
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            .transpose(1, 2) for _ in range(n)]


def flash_held(what: str, got, want, tol: float) -> dict:
    torch.cuda.synchronize()
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= tol * scale,
          f"{what}: max abs err {err} > {tol} x {scale}")
    return {"max_abs_err": err, "scale": scale}


def flash_checks(gen) -> list:
    """Each flash entry against its plain version at every shape of
    ``FLASH_SHAPES``, bf16 and fp32, causal and not: O and lse from the
    forward; dQ, dK and dV from the plain forward's residuals."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    checks = []
    for label, shape in FLASH_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k, v, do = flash_inputs(gen, shape, dtype)
                o, lse = fa.flash_fwd(q, k, v, causal=causal)
                o_ref, lse_ref = fa.dense_fwd_lse(q, k, v, causal=causal)
                dq = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do,
                                     causal=causal)
                dk, dv = fa.flash_bwd_dkv(q, k, v, o_ref, lse_ref, do,
                                          causal=causal)
                want = fa.dense_bwd_lse(q, k, v, o_ref, lse_ref, do,
                                        causal=causal)
                tag = f"flash {label} {dtype} causal={causal}"
                entry = {"label": label, "shape_BTHD": list(shape),
                         "dtype": str(dtype).replace("torch.", ""),
                         "causal": causal, "tol": FLASH_TOL[dtype],
                         "lse_tol": FLASH_TOL[torch.float32]}
                for name, got, ref in (("o", o, o_ref), ("dq", dq, want[0]),
                                       ("dk", dk, want[1]),
                                       ("dv", dv, want[2])):
                    entry[name] = flash_held(f"{tag} {name}", got, ref,
                                             FLASH_TOL[dtype])
                entry["lse"] = flash_held(f"{tag} lse", lse, lse_ref,
                                          FLASH_TOL[torch.float32])
                checks.append(entry)
                del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, want
    return checks


def flash_autograd_checks(gen) -> list:
    """Gradients through the autograd Function (forward kernel, then dQ
    and dK/dV kernels) at the path shape, causal: fp32 against
    ``torch.autograd`` of the plain forward; bf16 against the plain
    backward (autograd of the plain forward rounds its intermediate
    gradients to bf16 at other places than the kernels' rules)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    out = []
    shape = FLASH_SHAPES["path"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, w = (x.transpose(1, 2) for x in flash_inputs(gen, shape,
                                                               dtype))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        before = fa.flash_attention.fallbacks
        o = fa.flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(o, leaves, w)
        check(fa.flash_attention.fallbacks == before,
              "flash_attention fell back at the path shape")
        ref_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        bhtd = [x.transpose(1, 2) for x in ref_leaves]
        o_ref, lse_ref = fa.dense_fwd_lse(*bhtd, causal=True)
        if dtype == torch.float32:
            ref = torch.autograd.grad(o_ref.transpose(1, 2), ref_leaves, w)
            against = "torch.autograd of dense_fwd_lse"
        else:
            with torch.no_grad():
                ref = [g.transpose(1, 2) for g in fa.dense_bwd_lse(
                    *bhtd, o_ref, lse_ref, w.transpose(1, 2), causal=True)]
            against = "dense_bwd_lse"
        entry = {"shape_BTHD": list(shape), "causal": True,
                 "dtype": str(dtype).replace("torch.", ""),
                 "against": against, "tol": FLASH_TOL[dtype]}
        entry["o"] = flash_held("autograd o", o.detach(), o_ref.transpose(1, 2),
                                FLASH_TOL[dtype])
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            entry[name] = flash_held(f"autograd {name} {dtype}", g, r,
                                     FLASH_TOL[dtype])
        out.append(entry)
        del q, k, v, w, leaves, o, grads, ref_leaves, bhtd, o_ref, ref
    return out


def flash_bound(shape, dtype, causal: bool, entry: str) -> dict:
    """The least time of one launch. Bytes: each input read once and each
    output written once (fwd: Q, K, V in, O and lse out; dQ: Q, K, V, O,
    dO, lse in, dQ out; dK/dV: the same in, dK and dV out). Operations:
    2 D per (query, key) pair the mask admits for each product (fwd: QK^T
    and PV; dQ: QK^T, dO V^T and dS K; dK/dV: QK^T, dO V^T, P^T dO and
    dS^T Q), plus delta = rowsum(dO O) once per row in the backward."""
    b, t, h, d = shape
    elem = torch.finfo(dtype).bits // 8
    rows = b * h * t
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor = rows * d * elem
    n_in, n_out, n_prod = {"flash_attention_fwd": (3, 1, 2),
                           "flash_attention_bwd_dq": (5, 1, 3),
                           "flash_attention_bwd_dkv": (5, 2, 4)}[entry]
    nbytes = (n_in + n_out) * tensor + 4 * rows
    flops = 2 * d * pairs * n_prod
    if entry != "flash_attention_fwd":
        flops += 2 * rows * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_flash(gen, shape, layers: int) -> dict:
    """The three entries, their plain versions and the library's
    ``scaled_dot_product_attention`` (forward; its backward for the two
    backward rows, one call computing dq, dk and dv) at ``shape``, bf16,
    causal, over ``layers`` input sets per timed call. The plain version
    of both backward rows is ``dense_bwd_lse``, which computes all three
    gradients."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    dtype = torch.bfloat16
    sets = [flash_inputs(gen, shape, dtype) for _ in range(layers)]
    res = [fa.dense_fwd_lse(q, k, v, causal=True) for q, k, v, _ in sets]
    lib_leaves = [[x.detach().requires_grad_() for x in st[:3]]
                  for st in sets]
    lib_out = [torch.nn.functional.scaled_dot_product_attention(
        *lv, is_causal=True) for lv in lib_leaves]

    def plain_bwd(i):
        fa.dense_bwd_lse(*sets[i][:3], *res[i], sets[i][3], causal=True)

    def library_bwd(i):
        torch.autograd.grad(lib_out[i], lib_leaves[i], sets[i][3],
                            retain_graph=True)

    ops = {
        "flash_attention_fwd": (
            lambda i: fa.flash_fwd(*sets[i][:3], causal=True),
            lambda i: fa.dense_fwd_lse(*sets[i][:3], causal=True),
            lambda i: torch.nn.functional.scaled_dot_product_attention(
                *sets[i][:3], is_causal=True)),
        "flash_attention_bwd_dq": (
            lambda i: fa.flash_bwd_dq(*sets[i][:3], *res[i], sets[i][3],
                                      causal=True),
            plain_bwd, library_bwd),
        "flash_attention_bwd_dkv": (
            lambda i: fa.flash_bwd_dkv(*sets[i][:3], *res[i], sets[i][3],
                                       causal=True),
            plain_bwd, library_bwd),
    }
    out = {}
    for name, (kernel, plain, library) in ops.items():
        out[name] = {"shape_BTHD": list(shape), "dtype": "bfloat16",
                     "causal": True,
                     **timed(kernel, plain, library, layers=layers),
                     **flash_bound(shape, dtype, True, name)}
    for name in FLASH_ENTRIES[1:]:
        out[name]["plain_note"] = "dense_bwd_lse: dq, dk and dv together"
        out[name]["library_note"] = ("scaled_dot_product_attention "
                                     "backward: dq, dk and dv together")
    return out


def flash_kernel_phase(gen) -> dict:
    torch.cuda.empty_cache()
    checks = flash_checks(gen)
    autograd = flash_autograd_checks(gen)
    emit("flash_kernel_checks", {"kernels_vs_plain": checks,
                                 "autograd": autograd})
    timings = {"path": time_flash(gen, FLASH_SHAPES["path"], layers=2),
               "gpt2_long": time_flash(gen, FLASH_SHAPES["gpt2_long"],
                                       layers=1)}
    emit("flash_kernel_timings", timings)
    torch.cuda.empty_cache()
    worst = {name: max(e[key]["max_abs_err"] for e in checks
                       if e["dtype"] == "bfloat16" and e["label"] == "path"
                       for key in keys)
             for name, keys in zip(FLASH_ENTRIES,
                                   (("o",), ("dq",), ("dk", "dv")))}
    return {name: {"max_abs_err": worst[name],
                   "timing": timings["path"][name]} for name in FLASH_ENTRIES}


# -------------------------------------------------------------------- train

TRAIN_OVERRIDES = ["model.attention=flash"]
# Optimizer steps timed after one warm-up step (step 0, lr 0 under the
# recipe's 2000-step warmup).
TRAIN_STEPS = 3
# offload_path: train_path's warm-up and first two timed steps with the
# optimizer state in pinned host memory.
OFFLOAD_OVERRIDES = ["trainer.offload_opt_state=true"]
OFFLOAD_STEPS = 3
H100_BF16_PEAK = PEAK_FLOPS[torch.bfloat16]


def _train_setup(cfg, sd, device="cuda"):
    """Model, optimizer, schedule, state and loss of ``cfg`` over the
    weights ``sd``."""
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
        make_optimizer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import make_lm_loss
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )

    policy = get_policy(cfg.precision)
    model = GPT(cfg.model, policy, device=device)
    model.load_state_dict(sd)
    tx, schedule = make_optimizer(cfg.optimizer, cfg.trainer, cfg.model)
    state = TrainState.create(dict(model.named_parameters()), tx,
                              with_ema=cfg.trainer.ema_decay > 0,
                              device=device)
    return model, policy, tx, schedule, state, make_lm_loss(model)


def _step_fn(cfg, loss_fn, tx, policy, device="cuda"):
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_train_step,
    )

    t = cfg.trainer
    return make_train_step(
        loss_fn, tx, policy, seed=t.seed, grad_accum=t.grad_accum,
        remat=t.remat, ema_decay=t.ema_decay,
        offload_opt_state=t.offload_opt_state, mesh=cfg.mesh,
        parallel=cfg.parallel, device=device)


def train_phase(sd, card: str) -> tuple:
    """``gpt2_medium_zero1`` with ``model.attention=flash`` at full width
    and depth: one warm-up step (step 0, lr 0: the params must not move)
    and ``TRAIN_STEPS`` timed steps of 64 x 1024 tokens in 8 microbatches
    under dots remat and bf16_mixed. The forward kernel launches twice per
    layer and microbatch (once in the forward, once when the checkpointed
    region reruns it in the backward), dQ and dK/dV once each; no serving
    kernel runs and nothing falls back. Then one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa
    from frl_distributed_ml_scaffold_tpu_torch.utils.flops import (
        gpt_train_flops,
    )

    cfg = apply_overrides(get_config("gpt2_medium_zero1"), TRAIN_OVERRIDES)
    model, policy, tx, schedule, state, loss_fn = _train_setup(cfg, sd)
    step = _step_fn(cfg, loss_fn, tx, policy)
    data = SyntheticLM(cfg.data, split="train")
    gb = cfg.data.global_batch_size
    batches = [data.batch(s, gb) for s in range(TRAIN_STEPS + 2)]
    layers, accum = cfg.model.num_layers, cfg.trainer.grad_accum
    per_step = {"flash_attention_fwd": 2 * layers * accum,
                "flash_attention_bwd_dq": layers * accum,
                "flash_attention_bwd_dkv": layers * accum}
    start = {k: p.clone() for k, p in state.params.items()}
    fallbacks = fa.flash_attention.fallbacks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps = []
    for s in range(1 + TRAIN_STEPS):
        before = read_launches()
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        launched = {k: after[k] - before[k] for k in after}
        for name, n in launched.items():
            check(n == per_step.get(name, 0),
                  f"train_path step {s}: {name} launched {n} times, want "
                  f"{per_step.get(name, 0)}")
        rec = {"step": s, "lr": schedule(s), "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "step_s": wall,
               "tokens_per_s": gb * cfg.model.seq_len / wall}
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"train_path step {s}: non-finite loss or grad_norm {rec}")
        steps.append(rec)
        if s == 0:
            check(rec["lr"] == 0.0, "step 0 lr is not 0 under warmup")
            check(all(torch.equal(state.params[k], p)
                      for k, p in start.items()),
                  "params moved at step 0 (lr 0)")
        elif s == 1:
            moved = sum(not torch.equal(state.params[k], p)
                        for k, p in start.items())
            check(moved > 0, "params did not move at step 1")
            del start
    counts = read_launches()
    check(fa.flash_attention.fallbacks == fallbacks,
          "flash_attention fell back on the training path")
    peak_mem = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state.params.values())
    flops = gpt_train_flops(cfg, n_params)
    timed_s = [r["step_s"] for r in steps[1:]]
    step_s = statistics.median(timed_s)
    report = {
        "card": card, "config": cfg.name, "overrides": TRAIN_OVERRIDES,
        "policy": cfg.precision.policy, "layers": layers,
        "d_model": cfg.model.hidden_dim, "heads": cfg.model.num_heads,
        "seq_len": cfg.model.seq_len, "global_batch": gb,
        "grad_accum": accum, "remat": cfg.trainer.remat,
        "optimizer": {"name": cfg.optimizer.name,
                      "lr": cfg.optimizer.learning_rate,
                      "warmup_steps": cfg.optimizer.warmup_steps,
                      "schedule": cfg.optimizer.schedule,
                      "clip": cfg.optimizer.grad_clip_norm},
        "steps": steps, "step_s_median": step_s,
        "tokens_per_s": flops["tokens"] / step_s,
        **flops,
        "model_tflops_per_s": flops["flops"] / step_s / 1e12,
        "share_of_bf16_peak": flops["flops"] / step_s / H100_BF16_PEAK,
        "max_memory_allocated_bytes": peak_mem,
        "opt_state_bytes": state_bytes(state.opt_state),
        "launches": counts,
        "launches_per_step": per_step,
        "fallbacks": fa.flash_attention.fallbacks - fallbacks,
        "params_unchanged_after_step0": True,
        "params_changed_after_step1": True,
        "params_checksum": params_checksum(state.params),
    }
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batches[-1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_report = {"steps": 1, "step_s": wall,
                      **device_profile(prof, wall)}
    del model, state, step, prof
    torch.cuda.empty_cache()
    return report, counts, profile_report


def params_checksum(params: dict) -> int:
    """An exact fingerprint of fp32 params: the int64 sum of their bit
    patterns, leaf by leaf in name order (equal params give equal sums;
    one flipped bit changes it)."""
    total = 0
    for k in sorted(params):
        total += int(params[k].detach().float().contiguous().view(
            torch.int32).to(torch.int64).sum())
    return total


def state_bytes(tree) -> int:
    """Device bytes of the tensor leaves of a nested dict."""
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def fp32_train_phase(sd) -> dict:
    """One ``grad_accum=2`` step of ``gpt2_medium_zero1`` at full width,
    depth cut to 2 layers, from the same weights and batch (16 x 1024
    tokens), once with ``attention=flash`` (the kernels) and once with
    ``attention=dense`` (the plain path), under the fp32 policy and then
    bf16_mixed; warmup off so the step's lr is the schedule's 3e-4.
    Losses, every gradient and the params after the step are compared.
    Tolerances: loss 1e-5 (fp32) / 2e-3 (bf16_mixed) relative; each
    gradient to ``tol * max|g| + floor * (largest |g| of any tensor)``,
    tol 1e-4 / 5e-2, floor 1e-6 / 1e-3 (the floor covers the key bias,
    whose exact gradient is 0, so both runs hold rounding noise there); params: at most 2 lr apart (one Adam step moves a param by at
    most lr past the shared weight decay), the mean at most 1e-3 lr /
    1e-1 lr (under bf16_mixed the two paths' bf16 gradients differ in
    sign where they are small, and Adam's first step is about sign(g)),
    except the key bias, whose Adam step normalises rounding
    noise in both runs (its mean is held to lr)."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    layers = 2
    base = apply_overrides(get_config("gpt2_medium_zero1"), [
        f"model.num_layers={layers}", "trainer.grad_accum=2",
        "optimizer.warmup_steps=0", "data.global_batch_size=16"])
    sd2 = {k: v for k, v in sd.items()
           if not k.startswith("blocks.") or int(k.split(".")[1]) < layers}
    batch = SyntheticLM(base.data, split="train").batch(0, 16)
    report = {"layers": layers, "cut": "depth 24 -> 2, full width",
              "global_batch": 16, "grad_accum": 2, "remat": "dots",
              "warmup_steps": 0, "allow_tf32": False}
    fallbacks = fa.flash_attention.fallbacks
    for pol in ("fp32", "bf16_mixed"):
        runs = {}
        for attention in ("flash", "dense"):
            cfg = apply_overrides(base, [f"model.attention={attention}",
                                         f"precision.policy={pol}"])
            model, policy, tx, schedule, state, loss_fn = _train_setup(cfg,
                                                                       sd2)
            grad_fn = make_grad_fn(loss_fn, policy, grad_accum=2,
                                   remat=cfg.trainer.remat, device="cuda")
            reset_launches()
            loss, _, _, grads = grad_fn(state.params, state.extras, batch)
            counts = read_launches()
            want_fwd = 2 * layers * 2 if attention == "flash" else 0
            check(counts["flash_attention_fwd"] == want_fwd,
                  f"fp32_train_check {pol} {attention}: forward kernel "
                  f"launched {counts['flash_attention_fwd']} times")
            state, m = _step_fn(cfg, loss_fn, tx, policy)(state, batch)
            runs[attention] = {"loss": float(loss), "grads": grads,
                               "params": state.params,
                               "grad_norm": float(m["grad_norm"]),
                               "lr": schedule(0)}
            del model, state
        check(fa.flash_attention.fallbacks == fallbacks,
              f"fp32_train_check {pol}: flash_attention fell back")
        k_run, d_run = runs["flash"], runs["dense"]
        lr = d_run["lr"]
        loss_rel = abs(k_run["loss"] - d_run["loss"]) / abs(d_run["loss"])
        loss_tol = 1e-5 if pol == "fp32" else 2e-3
        check(loss_rel <= loss_tol,
              f"fp32_train_check {pol}: loss {k_run['loss']} vs "
              f"{d_run['loss']}")
        floor = (1e-6 if pol == "fp32" else 1e-3) * max(
            g.abs().max().item() for g in d_run["grads"].values())
        worst_grad, worst_param, worst_mean = 0.0, 0.0, 0.0
        tol = 1e-4 if pol == "fp32" else 5e-2
        for name, g in d_run["grads"].items():
            err = (k_run["grads"][name] - g).abs().max().item()
            lim = tol * g.abs().max().item() + floor
            check(err <= lim, f"fp32_train_check {pol}: grad {name} "
                  f"differs by {err} > {lim}")
            worst_grad = max(worst_grad, err / max(lim, 1e-30))
            dp = (k_run["params"][name] - d_run["params"][name]).abs()
            mean_lim = (1e-3 if pol == "fp32" else 1e-1) * lr
            if name.endswith("attn.key.bias"):  # Adam-normalised noise
                mean_lim = lr
            check(dp.max().item() <= 2 * lr and dp.mean().item() <= mean_lim,
                  f"fp32_train_check {pol}: param {name} after the step "
                  f"differs by {dp.max().item()} (mean {dp.mean().item()})")
            worst_param = max(worst_param, dp.max().item())
            worst_mean = max(worst_mean, dp.mean().item())
        report[pol] = {
            "loss_flash": k_run["loss"], "loss_dense": d_run["loss"],
            "loss_rel_diff": loss_rel, "loss_tol": loss_tol,
            "grad_norm_flash": k_run["grad_norm"],
            "grad_norm_dense": d_run["grad_norm"],
            "grad_tol": tol, "grad_floor": floor,
            "worst_grad_err_over_limit": worst_grad,
            "lr": lr, "param_max_abs_diff": worst_param,
            "param_mean_abs_diff_worst_tensor": worst_mean,
            "tensors": len(d_run["grads"]),
        }
        del runs, k_run, d_run
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------- resnet

# loop_path, loop_resume_check and mlp_launch: the training loop as a user
# runs it, through the launcher's ``main`` on the card (no --device: the
# default). loop_path: gpt2_medium_zero1 + flash at full width and depth,
# 6 steps, a checkpoint every 3 (async, the recipe's default), a log
# record every step. The resumed steps 4-6 must equal the uninterrupted
# run's bit for bit: nothing on the path is nondeterministic (the flash
# kernels use no atomics; the products and reductions repeat their order).
LOOP_ARGS = ["--config=gpt2_medium_zero1", "model.attention=flash",
             "trainer.total_steps=6", "trainer.log_every=1",
             "checkpoint.enabled=true", "checkpoint.save_every=3"]
LOOP_STEPS, LOOP_SAVES = 6, [3, 6]
# The same launch with checkpoints off (the recipe's default) for 8
# steps: its median (steps 3-8) is the loop's own step, to hold beside
# train_path's.
LOOP_PLAIN_STEPS = 8
LOOP_RESUME_TOL = 0.0
# A checkpoint's tensors: fp32 params and both AdamW moments (12 bytes a
# parameter) and the int64 step; the directory may add at most 1 % (the
# torch.save container and meta.json).
LOOP_DIR_SLACK = 0.01
MLP_LAUNCH = ["--config=mnist_mlp", "trainer.total_steps=200",
              "trainer.log_every=10", "checkpoint.enabled=true",
              "checkpoint.save_every=1000"]
MLP_PREEMPT_STEP = 100


# ---------------------------------------------------------------- the mesh
# The mesh phases run in a process group of one NCCL rank, with the mesh's
# data / fsdp / model groups kept at size 1 (``build_mesh(unit_groups=
# True)``), so every collective of the step runs on the card (over one
# rank, a copy) and nothing of the layout is skipped.
MESH_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter",
                    "all_gather_into_tensor", "reduce_scatter_tensor",
                    "broadcast")
RN50_MESH_STEPS = 2
# sync-BN's statistics are (sum x, sum x^2) / M where the plain forward
# takes torch.mean: the losses agree to this, relative, not bit for bit.
RN50_MESH_LOSS_TOL = 1e-5
LAUNCH_MESH = ["--config=mnist_mlp", "--device=cuda", "--num-processes=1",
               "--process-id=0", "trainer.log_every=10",
               "trainer.eval_every=0", "checkpoint.enabled=true",
               "checkpoint.save_every=20"]
LAUNCH_MESH_STEPS = (20, 30)
# The two recipes this slice adds, one step each after a warm-up, at a
# batch that fits one card (cut from the recipes' 1024).
SCALEUP = {
    "rn101_path": ("imagenet_rn101_ddp",
                   ["model.fused_bn=true", "data.global_batch_size=128"]),
    "vitl_path": ("imagenet_vitl_fsdp", ["data.global_batch_size=64"]),
}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nccl_init() -> float:
    """Join a process group of one NCCL rank on card 0; its seconds."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    check(dist.get_backend() == "nccl", "the process group is not NCCL")
    return time.perf_counter() - t0


def nccl_close() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class CountCollectives:
    """Counts the ``torch.distributed`` collectives called inside the
    block (the port calls them through the module, so patching the
    module's names sees every call)."""

    def __init__(self, names=None):
        self.names = MESH_COLLECTIVES if names is None else names

    def __enter__(self):
        import torch.distributed as dist

        self.counts = dict.fromkeys(self.names, 0)
        self._real = {n: getattr(dist, n) for n in self.names}

        def wrap(name, fn):
            def counted(*a, **k):
                self.counts[name] += 1
                return fn(*a, **k)
            return counted

        for n, fn in self._real.items():
            setattr(dist, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self._real.items():
            setattr(dist, n, fn)
        return False


def device_events(prof, pattern: str) -> int:
    """Device events in a profiled window whose name matches ``pattern``
    (NCCL kernels: ``nccl``; copies: ``Memcpy DtoD``)."""
    from torch.autograd import DeviceType

    rx = re.compile(pattern, re.IGNORECASE)
    return sum(e.device_type == DeviceType.CUDA and bool(rx.search(e.name))
               for e in prof.events())


def mesh_setup(cfg, env, tx, policy, loss_fn, state, device="cuda"):
    """The mesh path of ``cfg`` over ``env`` from a one-device ``state``
    (whose params and extras it takes): the layout of the model's params
    (``parallel/layout.py``, the Trainer's rules), a state of this rank's
    shards with fp32 optimizer templates, and ``make_train_step`` over
    the layout. Returns (state, step, layout)."""
    from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import (
        StateLayout,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import (
        model_partition_rules,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_train_step,
    )

    whole = ()
    if cfg.model.family == "gpt":
        from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
            TP_COMPUTE_WHOLE as whole,
        )
    shapes = {k: tuple(p.shape) for k, p in state.params.items()}
    layout = StateLayout.build(env, cfg.model, cfg.parallel, shapes,
                               rules=model_partition_rules(cfg.model, env),
                               compute_whole=whole)
    params = {k: layout.shard(k, p, layout.param[k])
              for k, p in state.params.items()}
    mesh_state = TrainState.create(
        params, tx, state.extras, with_ema=cfg.trainer.ema_decay > 0,
        opt_template=layout.opt_template(torch.float32, device),
        device=device)
    t = cfg.trainer
    step = make_train_step(
        loss_fn, tx, policy, seed=t.seed, grad_accum=t.grad_accum,
        remat=t.remat, ema_decay=t.ema_decay, mesh=cfg.mesh,
        parallel=cfg.parallel, layout=layout, device=device)
    return mesh_state, step, layout


def mesh_path_phase(sd, card: str, train: dict) -> dict:
    """train_path again through the mesh path on one NCCL rank:
    ``gpt2_medium_zero1`` + flash at full width and depth, its mesh
    (``data=1 fsdp=-1`` -> 1) with the data / fsdp / model groups kept,
    ZeRO-1's specs (whole over an fsdp axis of 1), a state of plain
    shards with fp32 moments, the step over the layout. The same weights
    and batches as train_path: one warm-up and ``TRAIN_STEPS`` timed
    steps whose losses and grad_norms equal train_path's bit for bit and
    whose params' checksum equals train_path's (the collectives over one
    rank are copies; the sums are in train_path's order); 384 / 192 / 192
    flash launches a step; the collectives a step; then one profiled
    step for the NCCL kernels a step and the idle share. Step seconds
    beside train_path's: the mesh path's host cost."""
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import build_mesh

    cfg = apply_overrides(get_config("gpt2_medium_zero1"), TRAIN_OVERRIDES)
    env = build_mesh(cfg.mesh, unit_groups=True)
    check(env.num_devices == 1 and env.group(("data", "fsdp")) is not None,
          f"mesh_path: mesh {env.shape} without its unit groups")
    model, policy, tx, schedule, state, loss_fn = _train_setup(cfg, sd)
    state, step, layout = mesh_setup(cfg, env, tx, policy, loss_fn, state)
    check(layout.trivial,
          "mesh_path: the ZeRO-1 specs over fsdp=1 split something")
    data = SyntheticLM(cfg.data, split="train")
    gb = cfg.data.global_batch_size
    layers, accum = cfg.model.num_layers, cfg.trainer.grad_accum
    per_step = {"flash_attention_fwd": 2 * layers * accum,
                "flash_attention_bwd_dq": layers * accum,
                "flash_attention_bwd_dkv": layers * accum}
    torch.cuda.synchronize()
    reset_launches()
    rows, collectives = [], []
    for s in range(1 + TRAIN_STEPS):
        batch = data.batch(s, gb)
        before = read_launches()
        with CountCollectives() as cc:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        after = read_launches()
        for name in after:
            n = after[name] - before[name]
            check(n == per_step.get(name, 0),
                  f"mesh_path step {s}: {name} launched {n} times, want "
                  f"{per_step.get(name, 0)}")
        want = train["steps"][s]
        rec = {"step": s, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "step_s": wall,
               "train_path_step_s": want["step_s"]}
        check(rec["loss"] == want["loss"]
              and rec["grad_norm"] == want["grad_norm"],
              f"mesh_path step {s}: {rec} against train_path's {want}")
        rows.append(rec)
        collectives.append(cc.counts)
    checksum = params_checksum(state.params)
    check(checksum == train["params_checksum"],
          f"mesh_path: params checksum {checksum} != train_path's "
          f"{train['params_checksum']}")
    counts = read_launches()
    step_s = statistics.median(r["step_s"] for r in rows[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, data.batch(1 + TRAIN_STEPS, gb))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    nccl = device_events(prof, "nccl")
    dtod = device_events(prof, "Memcpy DtoD")
    prof_report = device_profile(prof, wall)
    # Every step all-reduces the loss and each gradient leaf over the
    # batch axes' group (of one rank): the collectives ran.
    want_ar = 1 + len(state.params)
    check(all(c["all_reduce"] == want_ar for c in collectives),
          f"mesh_path: all-reduces a step {collectives}, want {want_ar}")
    report = {
        "card": card, "config": cfg.name, "mesh": env.shape,
        "unit_groups": True, "backend": "nccl", "ranks": 1,
        "parallel": dataclasses.asdict(cfg.parallel),
        "steps": rows, "step_s_median": step_s,
        "train_path_step_s_median": train["step_s_median"],
        "step_ratio_to_train_path": step_s / train["step_s_median"],
        "losses_equal_train_path": True, "params_checksum_equal": True,
        "collectives_per_step": collectives[-1],
        "nccl_kernels_per_step": nccl,
        "memcpy_dtod_per_step": dtod,
        "profiled_step_s": wall,
        "device_idle_share": prof_report["device_idle_share"],
        "device_busy_s": prof_report["device_busy_s"],
        "launches": counts, "launches_per_step": per_step,
    }
    del model, state, step, prof
    torch.cuda.empty_cache()
    return report


def rn50_mesh_phase(gen, card: str, weights, batches, rn50: dict) -> dict:
    """rn50_path through the mesh path on one NCCL rank (unit groups):
    ``imagenet_rn50_ddp`` + ``model.fused_bn=true`` at rn50_path's batch,
    from rn50_path's weights and batches, sync-BN wired: each BatchNorm's
    statistics all-reduced over the batch axes' group, and in the
    backward one all-reduce of the two sums between the sums kernel and
    the dx kernel. 53 launches of each a step (and the all-reduces the
    count says), losses within ``RN50_MESH_LOSS_TOL`` of rn50_path's."""
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import build_mesh

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )

    cfg = apply_overrides(get_config("imagenet_rn50_ddp"), RN50_OVERRIDES)
    env = build_mesh(cfg.mesh, unit_groups=True)
    with CountCollectives() as cc:
        report, counts, _ = rn50_phase(gen, card, RN50_OVERRIDES,
                                       RN50_MESH_STEPS, batches, False,
                                       weights, env)
    steps = 1 + RN50_MESH_STEPS
    # Per step: two all-reduces a BatchNorm a microbatch (statistics,
    # sums), the loss and metrics, and one a gradient leaf.
    want_ar = steps * (2 * RN50_BNS + 1 + RN50_LEAVES)
    check(cc.counts["all_reduce"] == want_ar,
          f"rn50_mesh_path: {cc.counts['all_reduce']} all-reduces, want "
          f"{want_ar}")
    worst = 0.0
    for got, want in zip(report["steps"], rn50["steps"]):
        rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        worst = max(worst, rel)
    check(worst <= RN50_MESH_LOSS_TOL,
          f"rn50_mesh_path: losses {worst} from rn50_path's (relative)")
    report.update({
        "mesh": env.shape, "unit_groups": True, "backend": "nccl",
        "collectives": cc.counts,
        "all_reduces_per_step": cc.counts["all_reduce"] // steps,
        "loss_max_rel_diff_to_rn50_path": worst,
        "losses_bit_equal": all(g["loss"] == w["loss"] for g, w in zip(
            report["steps"], rn50["steps"])),
        "rn50_path_step_s_median": rn50["step_s_median"],
        "step_ratio_to_rn50_path":
            report["step_s_median"] / rn50["step_s_median"],
    })
    return report


def launch_mesh_phase(work: str) -> dict:
    """``mnist_mlp`` through ``launch.main`` with the distributed flags
    of a one-process run (``--num-processes=1 --process-id=0
    --coordinator=127.0.0.1:<free port>``: one process initialises no
    group, as in the JAX package) on the card: 20 steps with a checkpoint
    at 20, then a resume from it to 30 (saved at 30); the markers, the
    records (10, 20, 30) and the falling loss."""
    args = LAUNCH_MESH + [f"--coordinator=127.0.0.1:{free_port()}",
                          f"workdir={work}"]
    run_dir = os.path.join(work, "mnist_mlp")
    walls = []
    for total in LAUNCH_MESH_STEPS:
        rc, wall = launch_main(args + [f"trainer.total_steps={total}"])
        check(rc == 0, f"launch_mesh: the run to {total} exited {rc}")
        walls.append(wall)
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    markers = sorted(os.listdir(os.path.join(run_dir, "ckpt", "commits")))
    want = ["step_20", "step_30"]  # max_to_keep of the recipe aside
    check([r["step"] for r in recs] == [10, 20, 30]
          and all(m in markers for m in want),
          f"launch_mesh: records {[r['step'] for r in recs]}, markers "
          f"{markers}")
    check(recs[-1]["loss"] < recs[0]["loss"],
          f"launch_mesh: loss {recs[0]['loss']} -> {recs[-1]['loss']}")
    return {"args": args, "seconds": walls,
            "records": [{k: r[k] for k in ("step", "loss") if k in r}
                        for r in recs], "markers": markers}


def scaleup_phase(name: str, gen, card: str) -> dict:
    """One of ``SCALEUP``'s recipes at full width and depth, cut to a
    batch that fits one card: seeded weights, synthetic ImageNet on the
    card, one warm-up step and one timed step; the params, the loss, the
    step seconds, images/s, peak memory, and the kernels a step (the
    ResNet's BN kernels once per BatchNorm; the ViT none)."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )

    recipe, overrides = SCALEUP[name]
    cfg = apply_overrides(get_config(recipe), overrides)
    if cfg.model.family == "resnet":
        model, policy, tx, schedule, state, loss_fn = rn50_setup(cfg, gen)
        n_bn = len(model.batch_norms())
        per_step = {"bn_bwd_sums": n_bn, "bn_bwd_dx": n_bn}
    else:
        model, policy, tx, schedule, state, loss_fn = family_setup(cfg, gen)
        per_step = {}
    step = _step_fn(cfg, loss_fn, tx, policy)
    batches = rn50_batches(cfg, 2)
    gb = cfg.data.global_batch_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for s, batch in enumerate(batches):
        before = read_launches()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        for k in after:
            n = after[k] - before[k]
            check(n == per_step.get(k, 0),
                  f"{name} step {s}: {k} launched {n} times, want "
                  f"{per_step.get(k, 0)}")
        rec = {"step": s, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "step_s": wall}
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"{name} step {s}: {rec}")
        rows.append(rec)
    peak = torch.cuda.max_memory_allocated()
    report = {"card": card, "config": cfg.name, "overrides": overrides,
              "cut": f"global batch {gb} of the recipe's 1024; seeded "
                     "weights, synthetic ImageNet",
              "params": sum(p.numel() for p in state.params.values()),
              "policy": cfg.precision.policy, "remat": cfg.trainer.remat,
              "steps": rows, "step_s": rows[-1]["step_s"],
              "images_per_s": gb / rows[-1]["step_s"],
              "max_memory_allocated_bytes": peak,
              "launches_per_step": per_step}
    del model, state, step, batches
    torch.cuda.empty_cache()
    return report


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, files in os.walk(path) for name in files)


def quiet_loop_log() -> str:
    """Send the port's log lines (a config dump and a line a step per
    launch) to ``OUT_DIR/loop_phases.log``; stdout keeps its warnings."""
    import logging

    from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

    logger = get_logger()
    for handler in logger.handlers:
        handler.setLevel(logging.WARNING)
    path = os.path.join(OUT_DIR, "loop_phases.log")
    handler = logging.FileHandler(path, mode="w")
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s] %(message)s"))
    logger.addHandler(handler)
    return path


def launch_main(args: list, fault_plan=None) -> tuple:
    """``launch.main(args)`` with ``FRL_FAULT_PLAN`` set to ``fault_plan``
    (JSON) for the call; (exit code, seconds). Frees the run's memory
    after."""
    import gc

    from frl_distributed_ml_scaffold_tpu_torch.launcher import launch

    if fault_plan is not None:
        os.environ["FRL_FAULT_PLAN"] = json.dumps(fault_plan)
    try:
        t0 = time.perf_counter()
        rc = launch.main(args)
        return rc, time.perf_counter() - t0
    finally:
        os.environ.pop("FRL_FAULT_PLAN", None)
        gc.collect()
        torch.cuda.empty_cache()


def read_prom(path: str) -> dict:
    """The samples of a Prometheus text file, by series."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                out[name] = float(value)
    return out


def loop_phase(card: str, train_step_s: float, work: str) -> tuple:
    """loop_path: ``launch.main(LOOP_ARGS)`` on the card. Every flash
    kernel launches as in train_path (384 / 192 / 192 a step, nothing
    falls back, no other kernel); metrics.jsonl has a record a step; the
    commit markers are steps 3 and 6, each checkpoint's tensor payload is
    12 bytes a parameter plus the step and its directory within 1 % above
    that; telemetry.jsonl, metrics.prom and trace_events.json parse.
    Then the same launch with checkpoints off for ``LOOP_PLAIN_STEPS``
    steps: the loop's own median step beside train_path's."""
    from frl_distributed_ml_scaffold_tpu_torch.checkpoint.manager import (
        Checkpointer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models import create_model
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.utils.flops import (
        peak_flops_per_chip,
    )

    args = LOOP_ARGS + [f"workdir={work}"]
    cfg = apply_overrides(get_config("gpt2_medium_zero1"),
                          [a for a in args if not a.startswith("--")])
    run_dir = os.path.join(work, cfg.name)
    ckpt_dir = os.path.join(run_dir, "ckpt")
    n_params = sum(p.numel() for p in create_model(
        cfg.model, get_policy(cfg.precision), device="meta").parameters())
    layers, accum = cfg.model.num_layers, cfg.trainer.grad_accum
    per_step = {"flash_attention_fwd": 2 * layers * accum,
                "flash_attention_bwd_dq": layers * accum,
                "flash_attention_bwd_dkv": layers * accum}
    fallbacks = fa.flash_attention.fallbacks
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rc, wall = launch_main(args)
    counts = read_launches()
    check(rc == 0, f"loop_path: launch exited {rc}")
    for name, n in counts.items():
        check(n == per_step.get(name, 0) * LOOP_STEPS,
              f"loop_path: {name} launched {n} times in {LOOP_STEPS} steps, "
              f"want {per_step.get(name, 0)} a step")
    check(fa.flash_attention.fallbacks == fallbacks,
          "flash_attention fell back on the loop's path")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    check([r["step"] for r in recs] == list(range(1, LOOP_STEPS + 1)),
          f"loop_path: metrics.jsonl steps {[r['step'] for r in recs]}")
    for r in recs:
        check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
              f"loop_path: non-finite record {r}")
    last = recs[-1]
    if peak_flops_per_chip() is not None:
        check(last.get("flops_source") == "analytic" and last["mfu"] > 0,
              f"loop_path: no analytic MFU in {last}")
    ck = Checkpointer(ckpt_dir, cfg.checkpoint)
    markers = sorted(os.listdir(os.path.join(ckpt_dir, "commits")))
    check(ck.all_steps() == LOOP_SAVES and ck.uncommitted_steps() == []
          and markers == [f"step_{s}" for s in LOOP_SAVES],
          f"loop_path: committed {ck.all_steps()}, markers {markers}")
    with open(os.path.join(run_dir, "trace_events.json")) as f:
        events = json.load(f)["traceEvents"]
    blocked = {e["args"]["step"]: e["dur"] / 1e6 for e in events
               if e.get("name") == "checkpoint"}
    payload = 12 * n_params + 8
    saves = []
    for step in LOOP_SAVES:
        meta = ck.meta(step)
        size = dir_bytes(os.path.join(ckpt_dir, str(step)))
        check(meta["payload_bytes"] == payload,
              f"loop_path: step {step} payload {meta['payload_bytes']} != "
              f"12 x {n_params} + 8")
        check(payload <= size <= (1 + LOOP_DIR_SLACK) * payload,
              f"loop_path: step {step} directory {size} bytes for a "
              f"{payload}-byte payload")
        saves.append({"step": step, "payload_bytes": meta["payload_bytes"],
                      "dir_bytes": size, "snapshot_s": meta["snapshot_s"],
                      "write_s": meta["write_s"],
                      "loop_blocked_s": blocked.get(step)})
    telemetry = read_jsonl(os.path.join(run_dir, "telemetry.jsonl"))
    prom = read_prom(os.path.join(run_dir, "metrics.prom"))
    names = {e["name"] for e in events}
    check(prom.get("train_steps_total") == LOOP_STEPS
          and {"step", "load_batch", "dispatch", "checkpoint"} <= names
          and any(r.get("event") == "telemetry" for r in telemetry),
          f"loop_path: telemetry files: prom {prom.get('train_steps_total')},"
          f" spans {sorted(names)}")
    step_s = last["step_time_median_s"]
    plain_dir = os.path.join(work, "plain")
    rc, plain_wall = launch_main(
        [a.replace(f"total_steps={LOOP_STEPS}",
                   f"total_steps={LOOP_PLAIN_STEPS}")
         for a in LOOP_ARGS if not a.startswith("checkpoint.")]
        + [f"workdir={plain_dir}"])
    check(rc == 0, f"loop_path: the run without checkpoints exited {rc}")
    plain = read_jsonl(os.path.join(plain_dir, cfg.name, "metrics.jsonl"))
    check([r["step"] for r in plain] == list(range(1, LOOP_PLAIN_STEPS + 1)),
          f"loop_path: plain run steps {[r['step'] for r in plain]}")
    plain_step_s = plain[-1]["step_time_median_s"]
    report = {
        "card": card, "args": LOOP_ARGS, "wall_s": wall,
        "records": [{k: r.get(k) for k in (
            "step", "loss", "grad_norm", "lr", "data_wait_s", "compute_s",
            "step_time_median_s", "samples_per_sec_per_chip", "mfu")}
            for r in recs],
        "step_time_median_s": step_s,
        "samples_per_sec_per_chip": last["samples_per_sec_per_chip"],
        "tokens_per_s": last["samples_per_sec_per_chip"] * cfg.model.seq_len,
        "data_wait_s": [r["data_wait_s"] for r in recs],
        "data_wait_share": statistics.mean(
            r["data_wait_s"] for r in recs[2:]) / step_s,
        "mfu": last.get("mfu"), "flops_source": last.get("flops_source"),
        "train_path_step_s_median": train_step_s,
        "loop_over_train_path": step_s / train_step_s,
        "without_checkpoints": {
            "steps": LOOP_PLAIN_STEPS, "wall_s": plain_wall,
            "window_s": [r.get("compute_s", 0) + r["data_wait_s"]
                         for r in plain[2:]],
            "step_time_median_s": plain_step_s,
            "over_train_path": plain_step_s / train_step_s,
            "mfu": plain[-1].get("mfu")},
        "launches": counts, "launches_per_step": per_step,
        "params": n_params, "checkpoints": saves,
        "commit_markers": markers,
        "hbm_peak_gib": last.get("hbm_peak_gib"),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "telemetry_records": len(telemetry),
        "prom_series": len(prom), "trace_spans": len(events),
    }
    return report, counts


def loop_resume_phase(work: str) -> dict:
    """loop_resume_check, on loop_path's directory: a launch to step 7
    under ``FRL_FAULT_PLAN`` at ``checkpoint.torn_write`` (the save of
    step 7 is torn: its directory stays, no marker, the newest committed
    step is still 6); then step 6's marker is deleted and a launch to
    step 6 resumes: ``restore_or_init`` skips 6 and 7 and lands on 3, the
    last committed step, and steps 4-6 repeat the first run's loss and
    grad_norm. Returns the largest difference (``main`` holds it to
    ``LOOP_RESUME_TOL`` after printing)."""
    from frl_distributed_ml_scaffold_tpu_torch.checkpoint.manager import (
        Checkpointer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        CheckpointConfig,
    )

    run_dir = os.path.join(work, "gpt2_medium_zero1")
    ckpt_dir = os.path.join(run_dir, "ckpt")
    metrics = os.path.join(run_dir, "metrics.jsonl")
    first = {r["step"]: r for r in read_jsonl(metrics)}
    torn_args = [a.replace("total_steps=6", "total_steps=7")
                 for a in LOOP_ARGS] + [f"workdir={work}"]
    rc, torn_wall = launch_main(torn_args,
                                [{"site": "checkpoint.torn_write"}])
    check(rc == 0, f"loop_resume_check: the torn run exited {rc}")
    ck = Checkpointer(ckpt_dir, CheckpointConfig())
    torn = {"committed": ck.all_steps(), "uncommitted": ck.uncommitted_steps(),
            "latest_step": ck.latest_step(),
            "steps_run": [r["step"] for r in read_jsonl(metrics)[LOOP_STEPS:]]}
    check(torn == {"committed": [3, 6], "uncommitted": [7], "latest_step": 6,
                   "steps_run": [7]},
          f"loop_resume_check: torn write {torn}")
    os.remove(os.path.join(ckpt_dir, "commits", "step_6"))
    rc, resume_wall = launch_main(LOOP_ARGS + [f"workdir={work}"])
    check(rc == 0, f"loop_resume_check: the resumed run exited {rc}")
    resumed = read_jsonl(metrics)[LOOP_STEPS + 1:]
    check([r["step"] for r in resumed] == [4, 5, 6],
          f"loop_resume_check: resumed steps {[r['step'] for r in resumed]}")
    diff = {k: max(abs(r[k] - first[r["step"]][k]) for r in resumed)
            for k in ("loss", "grad_norm", "lr")}
    after = {"committed": ck.all_steps(), "uncommitted": ck.uncommitted_steps()}
    check(after == {"committed": [3], "uncommitted": [6, 7]},
          f"loop_resume_check: after the resume {after}")
    return {"torn_run": {**torn, "wall_s": torn_wall},
            "resume": {"restored_from": resumed[0]["step"] - 1,
                       "steps": [{k: r[k] for k in ("step", "loss",
                                                    "grad_norm")}
                                 for r in resumed],
                       "first_run": [{k: first[s][k] for k in (
                           "step", "loss", "grad_norm")} for s in (4, 5, 6)],
                       "max_abs_diff": diff, "tolerance": LOOP_RESUME_TOL,
                       "checkpoints_after": after, "wall_s": resume_wall}}


def mlp_launch_phase(work: str) -> dict:
    """``mnist_mlp`` through ``launch.main`` with no --device, 200 steps:
    ``FRL_FAULT_PLAN`` at ``trainer.preempt`` sends the process SIGTERM
    at step 100, the run checkpoints step 100 and exits 0; a second
    launch resumes there and finishes. The loss falls by half (first
    record to last), no kernel of the port launches."""
    args = MLP_LAUNCH + [f"workdir={work}"]
    run_dir = os.path.join(work, "mnist_mlp")
    reset_launches()
    rc, wall = launch_main(args, [{"site": "trainer.preempt",
                                   "key": str(MLP_PREEMPT_STEP - 1)}])
    check(rc == 0, f"mlp_launch: the preempted run exited {rc}")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    markers = sorted(os.listdir(os.path.join(run_dir, "ckpt", "commits")))
    check(recs[-1].get("event") == "preempted"
          and recs[-1]["step"] == MLP_PREEMPT_STEP
          and markers == [f"step_{MLP_PREEMPT_STEP}"],
          f"mlp_launch: preemption left {recs[-1]}, markers {markers}")
    rc, resume_wall = launch_main(args)
    check(rc == 0, f"mlp_launch: the resumed run exited {rc}")
    counts = read_launches()
    check(not any(counts.values()), f"mlp_launch: kernels launched {counts}")
    recs = read_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    markers = sorted(os.listdir(os.path.join(run_dir, "ckpt", "commits")))
    check(recs[-1]["step"] == 200 and markers == ["step_100", "step_200"],
          f"mlp_launch: ended at {recs[-1]['step']}, markers {markers}")
    first, last = recs[0]["loss"], recs[-1]["loss"]
    check(last < 0.5 * first, f"mlp_launch: loss {first} -> {last}")
    return {"args": MLP_LAUNCH, "preempted_at": MLP_PREEMPT_STEP,
            "steps_logged": [r["step"] for r in recs],
            "loss_first": first, "loss_last": last,
            "accuracy_last": recs[-1]["accuracy"],
            "step_time_median_s": recs[-1].get("step_time_median_s"),
            "commit_markers": markers, "wall_s": [wall, resume_wall]}


# (M, C) of the BatchNorm layers the rn50 path gives the backward kernels
# at batch 256: the stem, a stage-1 expansion and stage 4's widest; plus a
# ragged shape (M not a multiple of any row step, C not a multiple of the
# 16-byte vector, so the one-element path runs).
BN_SHAPES = {"stem": (3211264, 64), "stage1": (802816, 256),
             "stage4": (12544, 2048), "ragged": (12347, 100)}
BN_EPS = 1e-5
# BN kernels vs their plain versions, as a fraction of max(1, max|plain|).
# Both compute in fp32 from the same inputs; they differ in summation
# order (over up to 3.2M rows for the sums) and rsqrtf against
# torch.rsqrt. dx in bf16 may round the other way: one bf16 ulp is 2^-7
# relative at most.
BN_TOL = {"sums": 1e-5, torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
# The AdamW kernel vs adamw_math, absolute on p', m' and v' (values of
# order 1): IEEE operations in the same order; the plain version divides
# by a host scalar as a multiply by its reciprocal (PyTorch's rule), 1 ulp
# apart.
ADAMW_TOL = 1e-6
# Leaves of the path (numel): the stage-4 3x3 conv, the Dense head, the
# smallest that takes the kernel, and a ragged one (n % 4 != 0).
ADAMW_SIZES = {"stage4_conv3x3": 2359296, "dense": 2048000,
               "min_kernel": 65536, "ragged": 65539}
# Leaves checked again with a bf16 g (precision.policy=bf16's gradients),
# and with a bf16 p and g (a bf16 init from trainer.init_params_path).
ADAMW_BF16_G = ("stage4_conv3x3", "ragged")
# A bf16 p' is the plain version's fp32 result rounded to nearest even:
# within one bf16 ulp of it, and bit-equal to it in all but
# ADAMW_BF16_P_BIT_EQUAL of the elements (the fp32 results may differ by
# ~1e-7, which crosses a rounding boundary rarely; a kernel that
# truncates, or rounds any other way, stays within the ulp but is
# bit-equal in only about half), m' and v' to ADAMW_TOL.
ADAMW_BF16_P_ULPS = 1
ADAMW_BF16_P_BIT_EQUAL = 0.999
ADAMW_HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
RN50_OVERRIDES = ["model.fused_bn=true", "data.global_batch_size=256"]
RN50_ADAMW_OVERRIDES = RN50_OVERRIDES + ["optimizer.name=fused_adamw"]
# Timed steps after one warm-up step (step 0, lr 0 under the recipe's
# 1565-step warmup).
RN50_STEPS, RN50_ADAMW_STEPS = 3, 2
# Per step on the rn50 path: one sums and one dx launch per BatchNorm
# (53 in ResNet-50); the AdamW kernel once per leaf of >= 65536 elements
# (42 of the 161).
RN50_BNS, RN50_LEAVES, RN50_BIG_LEAVES = 53, 161, 42


def bn_inputs(gen, m: int, c: int, dtype):
    """x (per-channel offsets and spreads), dy, a random scale (gamma,
    some negative) in ``dtype`` and x's fp32 batch statistics, as the
    forward leaves them."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as fb

    shift = torch.randn(c, generator=gen, device="cuda")
    spread = torch.rand(c, generator=gen, device="cuda") * 2 + 0.5
    x = (torch.randn((m, c), generator=gen, device="cuda") * spread
         + shift).to(dtype)
    dy = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    scale = (torch.rand(c, generator=gen, device="cuda") * 2 - 0.5).to(dtype)
    bias = torch.zeros(c, device="cuda", dtype=dtype)
    _, mean, var = fb.bn_train_forward(x, scale, bias, BN_EPS, dtype)
    return x, dy, scale, mean, var


def bn_held(what: str, got, want, tol: float) -> float:
    torch.cuda.synchronize()
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    check(math.isfinite(err) and err <= tol * scale,
          f"{what}: max abs err {err} > {tol} x {scale}")
    return err


def bn_checks(gen) -> list:
    """Both BN kernels against their plain versions at ``BN_SHAPES``, bf16
    and fp32, random gamma; then both chained (dx from the kernel's own
    sums) against ``fallback_bwd``."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as fb

    out = []
    for label, (m, c) in BN_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, dy, scale, mean, var = bn_inputs(gen, m, c, dtype)
            dbeta, dgamma = fb.bn_sums(x, dy, mean, var, BN_EPS)
            ref_b, ref_g = fb.sums_plain(x, dy, mean, var, BN_EPS)
            dx = fb.bn_dx(x, dy, scale, mean, var, ref_g, ref_b, BN_EPS, m)
            ref_dx = fb.dx_plain(x, dy, scale, mean, var, ref_g, ref_b,
                                 BN_EPS, m)
            chained = fb.bn_dx(x, dy, scale, mean, var, dgamma, dbeta,
                               BN_EPS, m)
            want = fb.fallback_bwd(x, dy, scale, mean, var, BN_EPS)
            tag = f"bn {label} {dtype}"
            out.append({
                "label": label, "M": m, "C": c,
                "dtype": str(dtype).replace("torch.", ""),
                "sums_tol": BN_TOL["sums"], "dx_tol": BN_TOL[dtype],
                "dbeta_err": bn_held(f"{tag} dbeta", dbeta, ref_b,
                                     BN_TOL["sums"]),
                "dgamma_err": bn_held(f"{tag} dgamma", dgamma, ref_g,
                                      BN_TOL["sums"]),
                "dx_err": bn_held(f"{tag} dx", dx, ref_dx, BN_TOL[dtype]),
                "chained_dx_err": bn_held(f"{tag} chained dx", chained,
                                          want[0], BN_TOL[dtype]),
            })
            del x, dy, scale, mean, var, dbeta, dgamma, dx, ref_dx, chained
            del want
    return out


def bn_bound(m: int, c: int, dtype, entry: str) -> dict:
    """Bytes: x and dy read once (and dx written once, for dx), and the
    per-channel vectors. Operations: 4 (sums) or 6 (dx) flops an element
    on the fp32 CUDA cores."""
    elem = torch.finfo(dtype).bits // 8
    n = m * c
    n_tensors, per_elem = {"bn_bwd_sums": (2, 4), "bn_bwd_dx": (3, 6)}[entry]
    nbytes = n_tensors * n * elem + 6 * 4 * c
    flops = per_elem * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_bn(gen, m: int, c: int) -> dict:
    """Both kernels, their plain versions and the library's
    ``native_batch_norm_backward`` (both passes in one call) at (M, C),
    bf16 as the path runs them. Every input set is at least 100 MB, past
    the 50 MB L2, so one set per timed call finds it cold."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as fb

    x, dy, scale, mean, var = bn_inputs(gen, m, c, torch.bfloat16)
    dbeta, dgamma = fb.sums_plain(x, dy, mean, var, BN_EPS)
    invstd = torch.rsqrt(var + BN_EPS)
    weight = scale.float()

    def library(_):
        torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, None, None, mean, invstd, True, BN_EPS,
            [True, True, True])

    ops = {
        "bn_bwd_sums": (lambda _: fb.bn_sums(x, dy, mean, var, BN_EPS),
                        lambda _: fb.sums_plain(x, dy, mean, var, BN_EPS)),
        "bn_bwd_dx": (lambda _: fb.bn_dx(x, dy, scale, mean, var, dgamma,
                                         dbeta, BN_EPS, m),
                      lambda _: fb.dx_plain(x, dy, scale, mean, var, dgamma,
                                            dbeta, BN_EPS, m)),
    }
    out = {}
    for name, (kernel, plain) in ops.items():
        out[name] = {"M": m, "C": c, "dtype": "bfloat16",
                     **timed(kernel, plain, library, layers=1),
                     **bn_bound(m, c, torch.bfloat16, name),
                     "library_note": ("aten native_batch_norm_backward: dx, "
                                      "dgamma and dbeta together")}
    return out


def bn_kernel_phase(gen) -> dict:
    torch.cuda.empty_cache()
    checks = bn_checks(gen)
    emit("bn_kernel_checks", checks)
    timings = {label: time_bn(gen, *BN_SHAPES[label])
               for label in ("stem", "stage1", "stage4")}
    emit("bn_kernel_timings", timings)
    torch.cuda.empty_cache()
    path = [e for e in checks
            if e["dtype"] == "bfloat16" and e["label"] != "ragged"]
    # The row's time: the stem, the path's largest BatchNorm.
    return {
        "bn_bwd_sums": {"max_abs_err": max(max(e["dbeta_err"],
                                               e["dgamma_err"]) for e in path),
                        "timing": timings["stem"]["bn_bwd_sums"]},
        "bn_bwd_dx": {"max_abs_err": max(e["dx_err"] for e in path),
                      "timing": timings["stem"]["bn_bwd_dx"]},
    }


def adamw_leaf(gen, n: int):
    """g, m, v (> 0) and p of one leaf, fp32, at the scales of a step."""
    g = torch.randn(n, generator=gen, device="cuda") * 1e-2
    m = torch.randn(n, generator=gen, device="cuda") * 1e-2
    v = torch.rand(n, generator=gen, device="cuda") * 1e-4
    p = torch.randn(n, generator=gen, device="cuda") * 0.05
    return g, m, v, p


def adamw_scalars(count: int = 5, lr: float = 1e-3):
    """(lr, bc1, bc2) of the step taken at ``count``."""
    t = count + 1
    return lr, 1.0 - ADAMW_HYPER["b1"] ** t, 1.0 - ADAMW_HYPER["b2"] ** t


def adamw_checks(gen) -> list:
    """The AdamW kernel against ``adamw_math`` on the same leaf, at each
    of ``ADAMW_SIZES`` with an fp32 g and at ``ADAMW_BF16_G`` with a bf16
    g: p', m' and v'."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as fa

    out = []
    lr, bc1, bc2 = adamw_scalars()
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(label, n, f32, f32) for label, n in ADAMW_SIZES.items()]
    cases += [(label, ADAMW_SIZES[label], bf16, f32)
              for label in ADAMW_BF16_G]
    cases += [(label, ADAMW_SIZES[label], bf16, bf16)
              for label in ADAMW_BF16_G]
    for label, n, g_dtype, p_dtype in cases:
        g, m, v, p = adamw_leaf(gen, n)
        g, p = g.to(g_dtype), p.to(p_dtype)
        want = list(fa.adamw_math(g, m, v, p.float(), lr, bc1, bc2,
                                  **ADAMW_HYPER))
        fa.adamw_kernel(p, g, m, v, lr, bc1, bc2, **ADAMW_HYPER)
        torch.cuda.synchronize()
        errs = {name: (got.float() - ref).abs().max().item()
                for name, got, ref in zip(("m", "v"), (m, v), want[1:])}
        g_name = str(g_dtype).replace("torch.", "")
        p_name = str(p_dtype).replace("torch.", "")
        entry = {"label": label, "numel": n, "g_dtype": g_name,
                 "p_dtype": p_name, "tol": ADAMW_TOL}
        if p_dtype == bf16:
            check(p.dtype == bf16, f"adamw {label}: p left bf16")
            ref = want[0].to(bf16).float()
            ulp = torch.exp2(torch.floor(torch.log2(
                ref.abs().clamp_min(2.0 ** -126))) - 7)
            ulps = ((p.float() - ref).abs() / ulp).max().item()
            share = (p.float() == ref).float().mean().item()
            check(ulps <= ADAMW_BF16_P_ULPS,
                  f"adamw {label} bf16 p: {ulps} ulps from the plain p'")
            check(share >= ADAMW_BF16_P_BIT_EQUAL,
                  f"adamw {label} bf16 p: {share} of p' bit-equal to the "
                  f"plain p' rounded to nearest even, want >= "
                  f"{ADAMW_BF16_P_BIT_EQUAL}")
            entry.update(p_ulps=ulps, p_tol_ulps=ADAMW_BF16_P_ULPS,
                         p_bit_equal_share=share,
                         p_bit_equal_min=ADAMW_BF16_P_BIT_EQUAL,
                         p_abs_err=(p.float() - ref).abs().max().item())
        else:
            errs["p"] = (p - want[0]).abs().max().item()
        for name, err in errs.items():
            check(math.isfinite(err) and err <= ADAMW_TOL,
                  f"adamw {label} g {g_name} p {p_name} {name}: max abs err "
                  f"{err} > {ADAMW_TOL}")
        entry.update({f"{k}_err": e for k, e in errs.items()})
        out.append(entry)
    return out


def time_adamw(gen, n: int, layers: int = 8, bf16_p: bool = False) -> dict:
    """The kernel, ``adamw_math`` and the library's ``torch._fused_adamw_``
    on ``layers`` leaves of ``n`` elements per timed call (p read and
    written, g read, m and v read and written: 28 n bytes each in fp32,
    22 n with ``bf16_p``'s bf16 p and g; 8 leaves of the path's largest
    outrun the L2). Each call moves its leaf one step further."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as fa

    lr, bc1, bc2 = adamw_scalars()
    leaves = [adamw_leaf(gen, n) for _ in range(layers)]
    if bf16_p:
        leaves = [(g.bfloat16(), m, v, p.bfloat16()) for g, m, v, p in leaves]
    steps = [torch.tensor(6.0, device="cuda") for _ in range(layers)]
    hp = ADAMW_HYPER

    def kernel(i):
        g, m, v, p = leaves[i]
        fa.adamw_kernel(p, g, m, v, lr, bc1, bc2, **hp)

    def library(i):
        g, m, v, p = leaves[i]
        torch._fused_adamw_([p], [g], [m], [v], [], [steps[i]], lr=lr,
                            beta1=hp["b1"], beta2=hp["b2"],
                            weight_decay=hp["wd"], eps=hp["eps"],
                            amsgrad=False, maximize=False)

    def plain(i):
        g, m, v, p = leaves[i]
        fa.adamw_math(g, m, v, p.float(), lr, bc1, bc2, **hp)

    # No PyTorch call updates a bf16 p beside fp32 moments
    # (torch._fused_adamw_ takes one dtype for all four).
    t = timed(kernel, plain, None if bf16_p else library, layers=layers)
    g, m, v, p = leaves[0]
    nbytes = n * (2 * p.element_size() + g.element_size()
                  + 2 * m.element_size() + 2 * v.element_size())
    flops = 16 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return {"numel": n, **t, "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_note": ("none: no PyTorch call takes a bf16 p beside "
                             "fp32 moments" if bf16_p else
                             "torch._fused_adamw_ on the same leaf")}


def adamw_kernel_phase(gen) -> dict:
    torch.cuda.empty_cache()
    checks = adamw_checks(gen)
    emit("adamw_kernel_checks", checks)
    timings = {label: time_adamw(gen, ADAMW_SIZES[label])
               for label in ("stage4_conv3x3", "dense")}
    timings["stage4_conv3x3_bf16_p"] = time_adamw(
        gen, ADAMW_SIZES["stage4_conv3x3"], bf16_p=True)
    emit("adamw_kernel_timings", timings)
    torch.cuda.empty_cache()
    path = [e for e in checks
            if e["label"] in timings and e["g_dtype"] == "float32"]
    bf16_p = [e for e in checks if e["p_dtype"] == "bfloat16"]
    return {"fused_adamw": {
        "max_abs_err": max(max(e["p_err"], e["m_err"], e["v_err"])
                           for e in path),
        "timing": timings["stage4_conv3x3"],
        "bf16_p": {**timings["stage4_conv3x3_bf16_p"],
                   "max_abs_err": max(max(e["p_abs_err"], e["m_err"],
                                          e["v_err"]) for e in bf16_p),
                   "p_bit_equal_share": min(e["p_bit_equal_share"]
                                            for e in bf16_p)}}}


def rn50_setup(cfg, gen, weights=None):
    """Model, policy, optimizer, schedule, state and loss of a ResNet
    ``cfg`` on the card; weights ``(params, extras)`` from
    ``init_resnet_params`` on ``gen`` unless given."""
    from frl_distributed_ml_scaffold_tpu_torch.models import create_model
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_resnet_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
        make_optimizer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import make_loss_fn
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )

    policy = get_policy(cfg.precision)
    model = create_model(cfg.model, policy, in_channels=cfg.data.channels,
                         device="cuda")
    if weights is None:
        weights = init_resnet_params(cfg.model, gen,
                                     in_channels=cfg.data.channels)
    params, extras = weights
    model.load_state_dict({**params, **extras["batch_stats"]})
    tx, schedule = make_optimizer(cfg.optimizer, cfg.trainer, cfg.model)
    state = TrainState.create(params, tx, extras, device="cuda")
    return (model, policy, tx, schedule, state,
            make_loss_fn(model, cfg.data.name))


def rn50_batches(cfg, n: int) -> list:
    """``n`` synthetic ImageNet batches of the global batch, on the card
    before any timed window."""
    from frl_distributed_ml_scaffold_tpu_torch.data.imagenet import ImageNet

    data = ImageNet(cfg.data, split="train")
    gb = cfg.data.global_batch_size
    return [{k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch(s, gb).items()} for s in range(n)]


def flop_count(loss_fn, policy, state, batch) -> int:
    """FLOPs of one forward and backward (convolutions and products),
    counted by ``FlopCounterMode`` over one gradient pass without
    recompute: the port's ``utils/flops.py`` ``grad_flops``, the count
    the training loop's MFU uses for these families."""
    from frl_distributed_ml_scaffold_tpu_torch.utils.flops import grad_flops

    return grad_flops(loss_fn, policy, state.params, state.extras, batch,
                      "cuda")


def rn50_phase(gen, card: str, overrides: list, steps: int, batches: list,
               profiled: bool, weights=None, env=None) -> tuple:
    """``imagenet_rn50_ddp`` with ``overrides`` at full width and depth:
    one warm-up step (step 0, lr 0: params unchanged, every running
    statistic moved) and ``steps`` timed steps of 256 images. Each step
    launches each BN kernel 53 times, the AdamW kernel 42 times under
    fused_adamw, and no other kernel of the port. Then, if ``profiled``,
    one step under ``torch.profiler``. ``weights`` as ``rn50_setup``'s;
    with a mesh ``env`` the state and the step are the mesh path's
    (``mesh_setup``: sync-BN over the batch axes' group between the two
    BN kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )

    cfg = apply_overrides(get_config("imagenet_rn50_ddp"), overrides)
    model, policy, tx, schedule, state, loss_fn = rn50_setup(cfg, gen,
                                                             weights)
    if env is None:
        step = _step_fn(cfg, loss_fn, tx, policy)
    else:
        state, step, _ = mesh_setup(cfg, env, tx, policy, loss_fn, state)
    n_params = sum(p.numel() for p in state.params.values())
    big = sum(p.numel() >= 65536 for p in state.params.values())
    n_bn = len(model.batch_norms())
    check(len(state.params) == RN50_LEAVES and big == RN50_BIG_LEAVES
          and n_bn == RN50_BNS,
          f"rn50: {len(state.params)} leaves, {big} of >= 65536 elements, "
          f"{n_bn} BatchNorms")
    per_step = {"bn_bwd_sums": RN50_BNS, "bn_bwd_dx": RN50_BNS}
    if cfg.optimizer.name == "fused_adamw":
        per_step["fused_adamw"] = RN50_BIG_LEAVES
    flops = flop_count(loss_fn, policy, state, batches[0])
    start = {k: p.clone() for k, p in state.params.items()}
    stats0 = {k: s.clone() for k, s in state.extras["batch_stats"].items()}
    gb = cfg.data.global_batch_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for s in range(1 + steps):
        before = read_launches()
        t0 = time.perf_counter()
        state, m = step(state, batches[s % len(batches)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        for name in after:
            n = after[name] - before[name]
            check(n == per_step.get(name, 0),
                  f"{cfg.name} step {s}: {name} launched {n} times, want "
                  f"{per_step.get(name, 0)}")
        rec = {"step": s, "lr": schedule(s), "step_s": wall,
               "images_per_s": gb / wall,
               **{k: float(v) for k, v in m.items()}}
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"rn50 step {s}: non-finite loss or grad_norm {rec}")
        rows.append(rec)
        if s == 0:
            check(rec["lr"] == 0.0, "rn50 step 0 lr is not 0 under warmup")
            check(all(torch.equal(state.params[k], p)
                      for k, p in start.items()),
                  "rn50: params moved at step 0 (lr 0)")
            still = [k for k, v in stats0.items()
                     if torch.equal(state.extras["batch_stats"][k], v)]
            check(not still, f"rn50: batch_stats {still[:4]} did not move at "
                  "step 0")
        elif s == 1:
            check(any(not torch.equal(state.params[k], p)
                      for k, p in start.items()),
                  "rn50: params did not move at step 1")
            del start
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(peak < 80e9, f"rn50: {peak} bytes allocated at peak")
    step_s = statistics.median(r["step_s"] for r in rows[1:])
    report = {
        "card": card, "config": cfg.name, "overrides": overrides,
        "policy": cfg.precision.policy, "depth": cfg.model.depth,
        "image_size": cfg.data.image_size, "global_batch": gb,
        "optimizer": {"name": cfg.optimizer.name,
                      "lr": cfg.optimizer.learning_rate,
                      "warmup_steps": cfg.optimizer.warmup_steps,
                      "schedule": cfg.optimizer.schedule,
                      "momentum": cfg.optimizer.momentum,
                      "weight_decay": cfg.optimizer.weight_decay},
        "params": n_params, "leaves": len(state.params),
        "batch_norms": n_bn, "steps": rows, "step_s_median": step_s,
        "images_per_s": gb / step_s, "flops_per_step": flops,
        "flops_counted_by": "FlopCounterMode over one forward and backward",
        "model_tflops_per_s": flops / step_s / 1e12,
        "share_of_bf16_peak": flops / step_s / H100_BF16_PEAK,
        "max_memory_allocated_bytes": peak,
        "launches": counts, "launches_per_step": per_step,
        "params_unchanged_after_step0": True,
        "batch_stats_moved_at_step0": True,
        "params_changed_after_step1": True,
    }
    profile_report = None
    if profiled:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batches[-1])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_report = {"steps": 1, "step_s": wall,
                          **device_profile(prof, wall)}
        del prof
    del model, state, step
    torch.cuda.empty_cache()
    return report, counts, profile_report


class PlainFusedAdamW:
    """``FusedAdamW``'s update with every leaf through ``adamw_math``:
    the plain version of the optimizer, for ``fp32_rn50_check``."""

    def __init__(self, tx):
        self.tx, self.init = tx, tx.init

    def update(self, grads, state, params, norm=None):
        from frl_distributed_ml_scaffold_tpu_torch.ops.fused_adamw import (
            adamw_math,
        )

        tx = self.tx
        lr, bc1, bc2 = tx.scalars(state["count"])
        for k, p in params.items():
            mu, nu = state["mu"][k], state["nu"][k]
            new = adamw_math(grads[k], mu, nu, p, lr, bc1, bc2, b1=tx.b1,
                             b2=tx.b2, eps=tx.eps, wd=tx.weight_decay)
            for t, n in zip((p, mu, nu), new):
                t.copy_(n)
        state["count"] += 1
        return state


# fp32_rn50_check, kernels vs the plain path (autograd through the plain
# forward; adamw_math for fused_adamw). The loss is one forward of
# identical ops: 1e-6 / 1e-3 relative. A gradient is held to tol * max|g|
# of its tensor + floor * (largest |g| of any tensor): the two backward
# formulas round differently (the closed form against autograd through
# E[x^2] - E[x]^2) and the difference grows 53 BatchNorms deep; under
# bf16_mixed both round every dx to bf16, at other values. batch_stats
# come from identical forwards: 1e-6 relative. The optimizer kernel is
# held on the kernel run's own gradients against the plain optimizer on
# the same gradients: 1e-6 absolute (ADAMW_TOL). End to end, SGD's first
# step moves a param by lr (1 + momentum) times its gradient, so two
# params differ by at most 2 lr times the gradient limit; Adam's first
# step is about lr sign(g), and a small gradient's sign is rounding noise,
# so there only the 2 lr bound holds.
# Under bf16 the compute is bf16_mixed's and the gradients are rounded
# once more to bf16 (2^-8 relative) for the optimizer: bf16_mixed's limits.
RN50_CHECK_TOL = {
    "fp32": {"loss": 1e-6, "grad": 1e-3, "floor": 1e-5, "stats": 1e-6},
    "bf16_mixed": {"loss": 1e-3, "grad": 1e-1, "floor": 1e-2, "stats": 1e-6},
    "bf16": {"loss": 1e-3, "grad": 1e-1, "floor": 1e-2, "stats": 1e-6},
}
# (policy, optimizer) pairs of fp32_rn50_check; bf16 sends bf16 gradients
# into the AdamW kernel.
RN50_CHECK_RUNS = [("fp32", "sgd"), ("fp32", "fused_adamw"),
                   ("bf16_mixed", "sgd"), ("bf16_mixed", "fused_adamw"),
                   ("bf16", "fused_adamw")]
RN50_CHECK = ["data.image_size=64", "data.global_batch_size=8",
              "optimizer.warmup_steps=0"]


def _rel_check(tag: str, got: dict, want: dict, tol: float,
               floor: float = 0.0) -> float:
    """Each tensor of ``got`` within ``tol * max|want| + floor`` of
    ``want``'s; returns the worst error over its limit."""
    worst = 0.0
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        lim = tol * w.abs().max().item() + floor
        check(err <= lim, f"{tag} {name} differs by {err} > {lim}")
        worst = max(worst, err / max(lim, 1e-30))
    return worst


def fp32_rn50_phase(gen) -> dict:
    """One step of ResNet-50 (full width and depth, 64 px, batch 8,
    warmup off) from the same weights and batch through the kernels
    (``model.fused_bn=true``; the AdamW kernel) and through the plain
    path (``fused_bn=false``; ``adamw_math``), for each of
    ``RN50_CHECK_RUNS``: loss, every gradient, batch_stats, and the params
    after the update (``RN50_CHECK_TOL``)."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_resnet_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    base = apply_overrides(get_config("imagenet_rn50_ddp"), RN50_CHECK)
    weights = init_resnet_params(base.model, gen)
    batch = rn50_batches(base, 1)[0]
    report = {"cut": "224 -> 64 px, batch 8, full width and depth",
              "allow_tf32": False, "tol": RN50_CHECK_TOL,
              "optimizer_tol": ADAMW_TOL}
    for pol, opt in RN50_CHECK_RUNS:
        tol = RN50_CHECK_TOL[pol]
        runs = {}
        for fused in (True, False):
            cfg = apply_overrides(base, [
                f"precision.policy={pol}", f"optimizer.name={opt}",
                f"model.fused_bn={str(fused).lower()}"])
            model, policy, tx, schedule, state, loss_fn = rn50_setup(
                cfg, gen, weights)
            if opt == "fused_adamw" and not fused:
                tx = PlainFusedAdamW(tx)
            grad_fn = make_grad_fn(loss_fn, policy, device="cuda")
            reset_launches()
            loss, _, extras, grads = grad_fn(state.params, state.extras,
                                             batch)
            before = {k: p.clone() for k, p in state.params.items()}
            tx.update(grads, state.opt_state, state.params)
            counts = read_launches()
            want = {"bn_bwd_sums": RN50_BNS if fused else 0,
                    "bn_bwd_dx": RN50_BNS if fused else 0,
                    "fused_adamw": (RN50_BIG_LEAVES if fused
                                    and opt == "fused_adamw" else 0)}
            check(all(counts[k] == n for k, n in want.items()),
                  f"fp32_rn50_check {pol} {opt} fused={fused}: launches "
                  f"{counts}, want {want}")
            runs[fused] = {"loss": float(loss), "grads": grads,
                           "stats": extras["batch_stats"],
                           "params": state.params, "lr": schedule(0)}
            if fused and opt == "fused_adamw":
                # The plain optimizer on the kernel run's gradients.
                PlainFusedAdamW(tx).update(grads, tx.init(before),
                                           before)
                runs["optimizer_ref"] = before
            del model, state, before
        k_run, p_run = runs[True], runs[False]
        lr = p_run["lr"]
        loss_rel = abs(k_run["loss"] - p_run["loss"]) / abs(p_run["loss"])
        tag = f"fp32_rn50_check {pol} {opt}"
        check(loss_rel <= tol["loss"],
              f"{tag}: loss {k_run['loss']} vs {p_run['loss']}")
        floor = tol["floor"] * max(g.abs().max().item()
                                   for g in p_run["grads"].values())
        entry = {
            "loss_kernels": k_run["loss"], "loss_plain": p_run["loss"],
            "loss_rel_diff": loss_rel, "lr": lr,
            "worst_grad_err_over_limit": _rel_check(
                f"{tag}: grad", k_run["grads"], p_run["grads"],
                tol["grad"], floor),
            "worst_batch_stats_err_over_limit": _rel_check(
                f"{tag}: batch_stats", k_run["stats"], p_run["stats"],
                tol["stats"], tol["stats"]),
            "tensors": len(p_run["grads"]),
            "grad_dtypes": sorted({str(g.dtype).replace("torch.", "")
                                   for g in k_run["grads"].values()}),
        }
        if pol == "bf16":
            check(entry["grad_dtypes"] == ["bfloat16"],
                  f"{tag}: the optimizer got {entry['grad_dtypes']} "
                  "gradients, not bfloat16")
        worst = 0.0
        for name, p in p_run["params"].items():
            dp = (k_run["params"][name] - p).abs().max().item()
            g = p_run["grads"][name]
            lim = 2 * lr * (
                (tol["grad"] * g.abs().max().item() + floor)
                if opt == "sgd" else 1.0) + 1e-6
            check(dp <= lim, f"{tag}: param {name} after the update "
                  f"differs by {dp} > {lim}")
            worst = max(worst, dp)
        entry["param_max_abs_diff"] = worst
        if opt == "fused_adamw":
            ref = runs["optimizer_ref"]
            err = max((k_run["params"][k] - r).abs().max().item()
                      for k, r in ref.items())
            check(err <= ADAMW_TOL, f"{tag}: the AdamW kernel's params "
                  f"differ from adamw_math's by {err} on the same grads")
            entry["optimizer_vs_plain_same_grads"] = err
        report[f"{pol}_{opt}"] = entry
        del runs, k_run, p_run
        torch.cuda.empty_cache()
    return report


# --------------------------------------------------- ViT, video and MLP

# imagenet_vitb_fsdp at full width and depth, the batch cut as for RN50;
# ego4d_video_elastic at full width, batch 64 -> 16; mnist_mlp as
# published. No kernel of the port runs on these paths.
VIT_OVERRIDES = ["data.global_batch_size=256"]
VIDEO_OVERRIDES = ["data.global_batch_size=16"]
VIT_STEPS, VIDEO_STEPS, MLP_STEPS = 3, 2, 200
# The MLP's idle share is read over this many steps under the profiler.
MLP_PROFILE_STEPS = 20
FAMILY_PARAMS = {"vit": 86567656, "video": 87146128, "mlp": 535818}
# FlopCounterMode's count against the analytic model FLOPs (ViT and
# video): the count leaves out the patch / tubelet embedding's input
# gradient (the input is data), 0.22 % of ViT-B's step and 0.39 % of the
# video model's.
FLOPS_TOL = 0.01


def family_setup(cfg, gen, weights=None, device="cuda"):
    """Model, policy, optimizer, schedule, state and loss of a ViT,
    video or MLP ``cfg`` on ``device``; weights from the family's seeded
    init on ``gen`` unless given."""
    from frl_distributed_ml_scaffold_tpu_torch.models import convert
    from frl_distributed_ml_scaffold_tpu_torch.models import create_model
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
        make_optimizer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import make_loss_fn
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )

    d = cfg.data
    kw = ({"in_features": d.image_size * d.image_size * d.channels}
          if cfg.model.family == "mlp" else {"in_channels": d.channels})
    policy = get_policy(cfg.precision)
    model = create_model(cfg.model, policy, device=device, **kw)
    if weights is None:
        init = getattr(convert, f"init_{cfg.model.family}_params")
        weights = init(cfg.model, gen, **kw)
    model.load_state_dict(weights)
    tx, schedule = make_optimizer(cfg.optimizer, cfg.trainer, cfg.model)
    state = TrainState.create(weights, tx, device=device)
    return (model, policy, tx, schedule, state,
            make_loss_fn(model, cfg.data.name))


def family_flops(cfg) -> dict:
    """Model FLOPs of one optimizer step, no recompute counted: three
    times the forward's products. ViT / video: the patch or tubelet
    embedding, per layer the four projections and the MLP (2 (4 + 2 r)
    D^2 a token) and attention's QK^T and PV (4 N^2 D), the head. MLP:
    its Dense layers. ``not_computed``: the first product's input
    gradient, part of that count but never computed (the input is
    data), so ``FlopCounterMode`` counts ``flops - not_computed``."""
    m, d, b = cfg.model, cfg.data, cfg.data.global_batch_size
    if m.family == "mlp":
        widths = [d.image_size ** 2 * d.channels, *m.hidden_sizes,
                  m.num_classes]
        fwd = sum(2 * a * c for a, c in zip(widths[:-1], widths[1:]))
        first = 2 * widths[0] * widths[1]
        return {"flops": 3 * b * fwd, "not_computed": b * first,
                "forward_flops_per_sample": fwd}
    if m.family == "vit":
        patches = (m.image_size // m.patch_size) ** 2
        features = m.patch_size ** 2 * d.channels
        tokens = patches + (m.pool == "cls")
    else:
        tt, th, tw = m.tubelet_size
        patches = ((m.num_frames // tt) * (m.image_size // th)
                   * (m.image_size // tw))
        features = tt * th * tw * d.channels
        tokens = patches
    dm = m.hidden_dim
    first = 2 * patches * features * dm
    fwd = (first + m.num_layers * (2 * (4 + 2 * m.mlp_ratio) * dm * dm
                                   * tokens + 4 * tokens * tokens * dm)
           + 2 * dm * m.num_classes)
    return {"flops": 3 * b * fwd, "not_computed": b * first,
            "forward_flops_per_sample": fwd, "tokens": tokens}


def family_batches(cfg, n: int) -> list:
    """``n`` synthetic batches of the global batch on the card (MNIST's
    synthetic fallback, or video clips, whose source is dropped after)."""
    from frl_distributed_ml_scaffold_tpu_torch.data.mnist import MNIST
    from frl_distributed_ml_scaffold_tpu_torch.data.video import VideoClips

    source = {"mlp": MNIST, "video": VideoClips}[cfg.model.family]
    data = source(cfg.data, split="train")
    gb = cfg.data.global_batch_size
    return [{k: torch.from_numpy(v).to("cuda")
             for k, v in data.batch(s, gb).items()} for s in range(n)]


# Device time by kind of kernel (first match wins): the products (the
# attention's, over 197 or 784 positions, take cuBLAS's unaligned
# ``align1`` kernels), copies and casts, the rest.
KERNEL_KINDS = (("gemm_align1", r"gemm.*align1"),
                ("gemm", r"gemm|nvjet|xmma"),
                ("copy_or_cast", r"copy"),
                ("layer_norm", r"layer_norm"),
                ("softmax", r"softmax"),
                ("reduce", r"reduce_kernel"),
                ("elementwise", r"elementwise"))


def device_time_by_kind(prof) -> dict:
    """Seconds of CUDA kernel time in a finished ``torch.profiler`` run,
    summed by ``KERNEL_KINDS`` (``other`` for the rest)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k, pat in KERNEL_KINDS
                     if re.search(pat, e.name)), "other")
        t = (e.time_range.end - e.time_range.start) / 1e6
        out[kind] = out.get(kind, 0.0) + t
    return out


def family_phase(cfg, gen, card: str, batches: list, steps: int,
                 profile_steps: int) -> tuple:
    """``cfg`` (ViT, video or MLP) on the card: one warm-up step (step
    0, lr 0 under warmup: the params must not move) and ``steps`` timed
    steps, each synchronised; every launch count stays 0. FLOPs of one
    forward and backward without recompute by ``FlopCounterMode``: equal
    to ``family_flops``' count less what it never computes, and (ViT,
    video) within ``FLOPS_TOL`` of the model FLOPs. Then
    ``profile_steps`` more steps under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    model, policy, tx, schedule, state, loss_fn = family_setup(cfg, gen)
    step = _step_fn(cfg, loss_fn, tx, policy)
    family = cfg.model.family
    n_params = sum(p.numel() for p in state.params.values())
    check(n_params == FAMILY_PARAMS[family],
          f"{cfg.name}: {n_params} params, want {FAMILY_PARAMS[family]}")
    counted = flop_count(loss_fn, policy, state, batches[0])
    analytic = family_flops(cfg)
    rel = counted / analytic["flops"] - 1
    check(counted == analytic["flops"] - analytic["not_computed"],
          f"{cfg.name}: FlopCounterMode counts {counted}, the analytic "
          f"count is {analytic['flops']} less {analytic['not_computed']}")
    if family != "mlp":
        check(abs(rel) <= FLOPS_TOL, f"{cfg.name}: FlopCounterMode counts "
              f"{rel:+.2%} off the model FLOPs")
    start = {k: p.clone() for k, p in state.params.items()}
    gb = cfg.data.global_batch_size
    rate = "clips_per_s" if family == "video" else "images_per_s"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for s in range(1 + steps):
        t0 = time.perf_counter()
        state, m = step(state, batches[s % len(batches)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = {"step": s, "lr": schedule(s), "step_s": wall,
               rate: gb / wall,
               **{k: float(v) for k, v in m.items()}}
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"{cfg.name} step {s}: non-finite loss or grad_norm {rec}")
        rows.append(rec)
        if s == 0:
            check(rec["lr"] == 0.0, f"{cfg.name}: step 0 lr is not 0")
            check(all(torch.equal(state.params[k], p)
                      for k, p in start.items()),
                  f"{cfg.name}: params moved at step 0 (lr 0)")
        elif s == 1:
            check(any(not torch.equal(state.params[k], p)
                      for k, p in start.items()),
                  f"{cfg.name}: params did not move at step 1")
            del start
    counts = read_launches()
    check(not any(counts.values()),
          f"{cfg.name}: a kernel of the port launched: {counts}")
    peak = torch.cuda.max_memory_allocated()
    check(peak < 80e9, f"{cfg.name}: {peak} bytes allocated at peak")
    step_s = statistics.median(r["step_s"] for r in rows[1:])
    shown = rows if len(rows) <= 10 else rows[::20] + rows[-1:]
    report = {
        "card": card, "config": cfg.name, "family": family,
        "policy": cfg.precision.policy, "global_batch": gb,
        "remat": cfg.trainer.remat,
        "model": dataclasses.asdict(cfg.model),
        "optimizer": {"name": cfg.optimizer.name,
                      "lr": cfg.optimizer.learning_rate,
                      "weight_decay": cfg.optimizer.weight_decay,
                      "warmup_steps": cfg.optimizer.warmup_steps,
                      "schedule": cfg.optimizer.schedule,
                      "clip": cfg.optimizer.grad_clip_norm},
        "params": n_params, "steps_run": len(rows), "steps": shown,
        "step_s_median": step_s, rate: gb / step_s,
        "flops_per_step": counted,
        "flops_counted_by": "FlopCounterMode over one forward and backward "
                            "(no recompute)",
        "analytic_flops_per_step": analytic["flops"],
        "first_input_grad_flops_not_computed": analytic["not_computed"],
        "flops_counted_over_analytic_minus_1": rel,
        "model_tflops_per_s": counted / step_s / 1e12,
        "share_of_peak": counted / step_s / PEAK_FLOPS[policy.compute_dtype],
        "peak_used": f"{PEAK_FLOPS[policy.compute_dtype] / 1e12:g} TFLOP/s "
                     f"({str(policy.compute_dtype).replace('torch.', '')})",
        "max_memory_allocated_bytes": peak,
        "launches": counts, "launches_per_step": {},
        "params_unchanged_after_step0": True,
        "params_changed_after_step1": True,
    }
    if family != "mlp":
        report["embedding"] = ("patchify + one product (F.linear), not a "
                               "convolution")
    profile_report = None
    if profile_steps:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(profile_steps):
                state, m = step(state, batches[s % len(batches)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_report = {"steps": profile_steps,
                          "step_s": wall / profile_steps,
                          **device_profile(prof, wall),
                          "device_s_by_kind": device_time_by_kind(prof)}
        del prof
    del model, state, step
    torch.cuda.empty_cache()
    return report, rows, profile_report


def mlp_phase(gen, card: str) -> dict:
    """``mnist_mlp`` as published (batch 256, fp32, synthetic MNIST on
    the card): ``MLP_STEPS`` steps of the recipe's warmup and cosine,
    then ``MLP_PROFILE_STEPS`` under the profiler. The loss must fall:
    the mean of the last ten steps below half that of the first ten."""
    from frl_distributed_ml_scaffold_tpu_torch.config import get_config

    cfg = get_config("mnist_mlp")
    batches = family_batches(cfg, MLP_STEPS)
    report, rows, profile = family_phase(cfg, gen, card, batches,
                                         MLP_STEPS - 1, MLP_PROFILE_STEPS)
    first = statistics.mean(r["loss"] for r in rows[:10])
    last = statistics.mean(r["loss"] for r in rows[-10:])
    check(last < 0.5 * first, f"mnist_mlp: loss {first} -> {last} over "
          f"{len(rows)} steps")
    report.update({"loss_first10_mean": first, "loss_last10_mean": last,
                   "accuracy_last10_mean": statistics.mean(
                       r["accuracy"] for r in rows[-10:]),
                   "profile": profile})
    return report


# fp32_vit_check: one step of ViT-B at full width, depth cut to 2, batch
# 8, warmup off (lr 3e-3), on the card and through the port's CPU path
# (the one the tier-1 tests hold to the JAX package) from the same
# weights and batch. fp32 (TF32 off): only summation order differs, so
# loss 1e-5 relative, each gradient within 1e-4 of its tensor's largest
# |g| plus 1e-6 of the largest |g| of any tensor (the key bias's exact
# gradient is 0: its values are rounding noise on both sides). bf16_mixed:
# cuBLAS and the CPU round bf16 products at other values, as
# fp32_rn50_check's limits. Params after the step: AdamW's first step is
# about lr sign(g), and a gradient within rounding of 0 has no sign, so
# each param within 2 lr, and (fp32) their mean difference under 1 % of
# that.
VIT_CHECK = ["model.num_layers=2", "data.global_batch_size=8",
             "optimizer.warmup_steps=0"]
VIT_CHECK_TOL = {
    "fp32": {"loss": 1e-5, "grad": 1e-4, "floor": 1e-6, "param_mean": 0.01},
    "bf16_mixed": {"loss": 1e-3, "grad": 1e-1, "floor": 1e-2,
                   "param_mean": None},
}


def fp32_vit_phase(gen) -> dict:
    """One ``imagenet_vitb_fsdp`` step (``VIT_CHECK``) under fp32 and
    bf16_mixed on the card and on the CPU: loss, every gradient and the
    params after the update (``VIT_CHECK_TOL``)."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.imagenet import ImageNet
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_vit_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
        global_norm,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    base = apply_overrides(get_config("imagenet_vitb_fsdp"), VIT_CHECK)
    weights = init_vit_params(base.model, gen)
    batch = ImageNet(base.data, split="train").batch(
        0, base.data.global_batch_size)
    report = {"cut": "depth 12 -> 2, batch 8, warmup off; full width",
              "allow_tf32": False, "tol": VIT_CHECK_TOL,
              "cpu_threads": torch.get_num_threads()}
    for pol, tol in VIT_CHECK_TOL.items():
        cfg = apply_overrides(base, [f"precision.policy={pol}"])
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            w = {k: v.to(dev) for k, v in weights.items()}
            model, policy, tx, schedule, state, loss_fn = family_setup(
                cfg, gen, w, device=dev)
            grad_fn = make_grad_fn(loss_fn, policy, remat=cfg.trainer.remat,
                                   device=dev)
            reset_launches()
            loss, metrics, _, grads = grad_fn(state.params, {}, batch)
            tx.update(grads, state.opt_state, state.params,
                      norm=global_norm(grads.values()))
            counts = read_launches()
            check(not any(counts.values()),
                  f"fp32_vit_check {pol} {dev}: a kernel launched: {counts}")
            runs[dev] = {"loss": float(loss), "lr": schedule(0),
                         "grads": {k: g.cpu() for k, g in grads.items()},
                         "params": {k: p.cpu()
                                    for k, p in state.params.items()},
                         "seconds": time.perf_counter() - t0}
            del model, state, grads
        card, cpu = runs["cuda"], runs["cpu"]
        tag = f"fp32_vit_check {pol}"
        loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        check(loss_rel <= tol["loss"],
              f"{tag}: loss {card['loss']} on the card, {cpu['loss']} on "
              "the CPU")
        floor = tol["floor"] * max(g.abs().max().item()
                                   for g in cpu["grads"].values())
        lr = cpu["lr"]
        lim = 2 * lr + 1e-6
        worst, means = 0.0, []
        for name, p in cpu["params"].items():
            diff = (card["params"][name] - p).abs()
            check(diff.max().item() <= lim, f"{tag}: param {name} differs "
                  f"by {diff.max().item()} > {lim} after the step")
            worst = max(worst, diff.max().item())
            means.append(diff.mean().item())
        mean = statistics.mean(means)
        if tol["param_mean"] is not None:
            check(mean <= tol["param_mean"] * lim,
                  f"{tag}: params differ by {mean} on average")
        report[pol] = {
            "loss_card": card["loss"], "loss_cpu": cpu["loss"],
            "loss_rel_diff": loss_rel, "lr": lr,
            "worst_grad_err_over_limit": _rel_check(
                f"{tag}: grad", card["grads"], cpu["grads"], tol["grad"],
                floor),
            "param_max_abs_diff": worst, "param_mean_abs_diff": mean,
            "param_limit": lim, "tensors": len(cpu["grads"]),
            "card_seconds": card["seconds"], "cpu_seconds": cpu["seconds"],
        }
        del runs, card, cpu
        torch.cuda.empty_cache()
    return report


# --------------------------------------------------------------------- main


# ------------------------------------------ loaders and the native core

# Synthetic ImageNet-shaped shards of the real stored size: 2048 uint8
# images of 256 x 256 x 3 (0.4 GB) in shards of 512, seeded labels of
# 1000 classes. bench.py's headline RN50 point: the s2d stem, the mask
# pool, the BatchNorm kernels, batch 512.
SHARD_PX, SHARD_SIZE, SHARD_IMAGES = 256, 512, 2048
RN50_SHARD_OVERRIDES = ["model.stem=s2d", "model.pool_grad=mask",
                        "model.fused_bn=true", "data.global_batch_size=512"]
# Loop steps of each rn50 run (from the shards, and synthetic), the steps
# that run under the profiler at the end (idle share) and the first step
# of the median. The loop times the windows after the first two, and its
# MFU probe (FlopCounterMode, one forward and backward) delays step 4,
# which lets the prefetch queue (depth 2) fill: the shards run's median
# is taken from step 7, where that head start is spent.
RN50_SHARD_RUNS = {"shards": (12, 2, 7), "synthetic": (6, 1, 3),
                   "shards_conv7": (8, 0, 3)}
# The loader's host throughput alone: ImageNet.batch at batch 512.
LOADER_BATCHES = 4
# Native vs numpy at the path's shapes: 512 gathered rows of 256^2 x 3,
# augmented to 224; 64 windows of 1025 tokens.
NATIVE_ROWS, NATIVE_CROP, NATIVE_WINDOWS = 512, 224, (64, 1025)
# The s2d stem with s2d_stem_weights(w7) against the conv7 stem (fp32,
# TF32 off: the same products summed in another order), relative to
# max|conv7|; the mask pool's gradient against autodiff's on a tie-free
# input (sums of at most four terms in another order), relative to
# max|dy|.
STEM_TOL, POOL_TOL = 1e-5, 1e-6
# The token bin of lm_shards_path: 4M seeded uint16 tokens of the
# recipe's vocab; 3 steps of gpt2_medium_zero1 + flash through launch.
LM_TOKENS, LM_STEPS = 4 * 1024 * 1024, 3
# Clip shards of video_shards_path: 64 uint8 clips of 8 x 224^2 x 3.
VIDEO_CLIPS, VIDEO_SHARD_STEPS = 64, 6
# elastic_path: the pairs in the directory at the start and sealed after
# the first child logs step SEAL_AT_STEP; the fault step, the delay a
# step, the steps, and the kernels of one profiled step (B10 / B11).
ELASTIC_START_PAIRS, ELASTIC_SEALED_PAIRS, SEAL_AT_STEP = 2, 2, 2
ELASTIC_FAULT_STEP, ELASTIC_STEP_DELAY_S, ELASTIC_STEPS = 7, 0.5, 10
ELASTIC_OVERRIDES = [
    "data.streaming=true", "data.streaming_refresh_every=2",
    f"trainer.total_steps={ELASTIC_STEPS}", "trainer.log_every=2",
    "trainer.eval_every=0", "trainer.profile_steps=1",
    "trainer.profile_start_step=1", "checkpoint.save_every=2",
    "checkpoint.async_save=false", "elastic.backoff_s=0.1"]
ELASTIC_KERNELS = {"bn_bwd_sums": r"(^|[\s:])sums_kernel<",
                   "bn_bwd_dx": r"(^|[\s:])dx_kernel<"}
# sanitize_check: mnist_mlp through launch.main with and without the
# variable.
SANITIZE_MLP = ["--config=mnist_mlp", "--device=cuda",
                "trainer.total_steps=20", "trainer.log_every=1",
                "trainer.eval_every=0"]


def proc_threads() -> int:
    return len(os.listdir("/proc/self/task"))


def write_image_shards(root: str, seed: int) -> dict:
    """``SHARD_IMAGES`` seeded uint8 images and labels as sealed
    ``train_*`` shards under ``root``."""
    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.data.shards import sealed_save

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for i in range(SHARD_IMAGES // SHARD_SIZE):
        x = rng.integers(0, 256, (SHARD_SIZE, SHARD_PX, SHARD_PX, 3),
                         dtype=np.uint8)
        sealed_save(os.path.join(root, f"train_images_{i:03d}.npy"), x)
        sealed_save(os.path.join(root, f"train_labels_{i:03d}.npy"),
                    rng.integers(0, 1000, SHARD_SIZE).astype(np.int32))
    return {"dir_bytes": dir_bytes(root), "images": SHARD_IMAGES,
            "stored": [SHARD_PX, SHARD_PX, 3], "dtype": "uint8",
            "seconds": time.perf_counter() - t0}


def _host_ms(fn, repeats: int = 3) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def native_phase(shard_dir: str, seed: int) -> dict:
    """native_build: the port's C++ data core built with g++ on this host
    (seconds, the library's name), its pool's threads, every entry point
    against its numpy version bit for bit at the rn50 and GPT paths'
    shapes with both times, and ``ImageNet.batch`` at batch 512 over the
    shards alone (images/s, the gather and augment split)."""
    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data import native
    from frl_distributed_ml_scaffold_tpu_torch.data.imagenet import ImageNet
    from frl_distributed_ml_scaffold_tpu_torch.data.shards import (
        ShardedNpyCorpus,
    )

    path = native.library_path()
    existed = path.exists()
    t0 = time.perf_counter()
    check(native.native_available(), "native_build: the C++ data core did "
          "not build or load (g++)")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (NATIVE_ROWS, SHARD_PX, SHARD_PX, 3),
                      dtype=np.uint8)
    idx = np.sort(rng.integers(0, NATIVE_ROWS, NATIVE_ROWS))
    threads0 = proc_threads()
    rows = native.gather_rows(u8, idx)
    pool_threads = proc_threads() - threads0
    checks = {}

    def held(name, fast, plain):
        got, want = fast(), plain()
        check(got.dtype == want.dtype and np.array_equal(got, want),
              f"native_build: {name} differs from its numpy version")
        checks[name] = {"shape": list(got.shape), "bit_equal": True,
                        "native_ms": _host_ms(fast),
                        "numpy_ms": _host_ms(plain, repeats=1)}

    held("gather_rows_u8", lambda: native.gather_rows(u8, idx),
         lambda: native.gather_rows_numpy(u8, idx))
    f32 = native.gather_rows(u8, np.arange(NATIVE_ROWS))
    held("gather_rows_f32", lambda: native.gather_rows(f32, idx),
         lambda: native.gather_rows_numpy(f32, idx))
    del f32
    for train in (True, False):
        held(f"augment_{'train' if train else 'eval'}",
             lambda: native.augment_batch(rows, NATIVE_CROP, seed=seed + 1,
                                          train=train),
             lambda: native.augment_numpy(rows, NATIVE_CROP, seed=seed + 1,
                                          train=train))
    n, window = NATIVE_WINDOWS
    for dtype in (np.uint16, np.uint32):
        toks = rng.integers(0, 50257, LM_TOKENS).astype(dtype)
        starts = rng.integers(0, LM_TOKENS - window, n)
        held(f"gather_windows_{np.dtype(dtype).name}",
             lambda: native.gather_windows(toks, starts, window),
             lambda: native.gather_windows_numpy(toks, starts, window))
    del u8, rows
    # The loader alone: what the prefetch worker does per step.
    cfg = apply_overrides(
        get_config("imagenet_rn50_ddp"),
        RN50_SHARD_OVERRIDES + [f"data.data_dir={shard_dir}"])
    data = ImageNet(cfg.data, split="train")
    check(not data.is_synthetic, "native_build: ImageNet found no shards")
    gb = cfg.data.global_batch_size
    calls0 = dict(native.calls)
    # The batch's two parts, each through its own public call: the
    # corpus's gather (index draws as the loader's) and the augment.
    corpus = ShardedNpyCorpus(shard_dir, "train", "images")
    per_batch, gather_s, augment_s = [], [], []
    for step in range(LOADER_BATCHES):
        t0 = time.perf_counter()
        batch = data.batch(step, gb)
        per_batch.append(time.perf_counter() - t0)
        r = np.random.default_rng((seed, step))
        i = np.sort(r.integers(0, corpus.n, size=gb))
        t0 = time.perf_counter()
        x, _ = corpus.gather(i)
        gather_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        native.augment_batch(x, cfg.data.image_size, seed=step, train=True)
        augment_s.append(time.perf_counter() - t0)
    check(batch["image"].shape == (gb, 224, 224, 3)
          and np.isfinite(batch["image"]).all(),
          f"native_build: batch {batch['image'].shape}")
    check(native.calls["numpy"] == calls0["numpy"],
          "native_build: a loader call took the numpy path")
    return {"library": path.name, "built_now": not existed,
            "build_s": build_s, "flags": list(native.CXX_FLAGS),
            "host_cpus": os.cpu_count(), "pool_threads": pool_threads,
            "checks": checks,
            "imagenet_batch": {
                "batch": gb, "stored": [SHARD_PX, SHARD_PX, 3],
                "crop": cfg.data.image_size, "seconds": per_batch,
                "images_per_s": gb / statistics.median(per_batch),
                "gather_s": gather_s, "augment_s": augment_s,
                "gather_bytes": gb * SHARD_PX * SHARD_PX * 3 * 4,
                "augment_bytes": gb * 224 * 224 * 3 * 4},
            "calls": dict(native.calls)}


def stem_pool_phase(gen) -> dict:
    """On the card: the s2d stem with ``s2d_stem_weights(w7)`` against
    the conv7 stem on the same input, and the mask pool's gradient
    against autodiff's (scatter) on a tie-free input; then each timed,
    forward and backward, at batch 512 in bf16 (the stem's weight
    gradient only: the image needs none)."""
    from frl_distributed_ml_scaffold_tpu_torch.models import resnet
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        s2d_stem_weights,
    )

    x = torch.randn((16, 224, 224, 3), generator=gen, device="cuda")
    w7 = 0.1 * torch.randn((64, 3, 7, 7), generator=gen, device="cuda")
    conv7 = resnet.Conv(3, 64, 7, 2, device="cuda")
    conv4 = resnet.Conv(12, 64, 4, 1, device="cuda")
    with torch.no_grad():
        conv7.weight.copy_(w7)
        conv4.weight.copy_(s2d_stem_weights(w7))
        want = conv7(x)
        got = conv4(resnet.space_to_depth(x))
    stem_err = ((got - want).abs().max() / want.abs().max()).item()
    check(got.shape == want.shape and stem_err <= STEM_TOL,
          f"stem_pool: s2d stem differs from conv7 by {stem_err}")
    shape = (16, 112, 112, 64)  # 12845056 distinct values, exact in fp32
    n = math.prod(shape)
    xp = torch.randperm(n, generator=gen, device="cuda").float().reshape(
        shape).requires_grad_()
    dy = torch.randn((16, 56, 56, 64), generator=gen, device="cuda")
    g_mask, = torch.autograd.grad(resnet.max_pool_mask_grad(xp), xp, dy)
    g_scat, = torch.autograd.grad(resnet.max_pool_same(xp), xp, dy)
    pool_err = ((g_mask - g_scat).abs().max() / dy.abs().max()).item()
    check(pool_err <= POOL_TOL,
          f"stem_pool: mask gradient differs from scatter by {pool_err}")
    del x, want, got, xp, dy, g_mask, g_scat
    bf = torch.bfloat16
    xb = torch.randn((512, 224, 224, 3), generator=gen, device="cuda",
                     dtype=bf)
    gb = torch.randn((512, 112, 112, 64), generator=gen, device="cuda",
                     dtype=bf)
    timings = {}
    for name, conv, s2d in (("conv7", conv7, False), ("s2d", conv4, True)):
        conv.to(bf)

        def stem(conv=conv, s2d=s2d):
            y = conv(resnet.space_to_depth(xb) if s2d else xb)
            torch.autograd.grad(y, conv.weight, gb)

        timings[f"stem_{name}_ms"] = cuda_time_ms(stem, repeats=10)
    xq = torch.relu(gb).requires_grad_()
    dq = torch.randn((512, 56, 56, 64), generator=gen, device="cuda",
                     dtype=bf)
    for name, pool in (("scatter", resnet.max_pool_same),
                       ("mask", resnet.max_pool_mask_grad)):
        timings[f"pool_{name}_ms"] = cuda_time_ms(
            lambda pool=pool: torch.autograd.grad(pool(xq), xq, dq),
            repeats=10)
    del xb, gb, xq, dq
    torch.cuda.empty_cache()
    return {"stem_rel_err": stem_err, "stem_tol": STEM_TOL,
            "pool_rel_err": pool_err, "pool_tol": POOL_TOL,
            "timed_at": "batch 512, bf16, forward + backward, device time",
            **timings}


def loop_run(cfg, per_step: dict, profiled: int = 0, first: int = 3) -> dict:
    """``Trainer(cfg).fit()`` on the card with every launch count set to 0
    just before it: each kernel of ``per_step`` launches that many times a
    step, no other kernel, and no loader call takes numpy. The last
    ``profiled`` steps run under ``torch.profiler`` (idle share); the
    medians are over steps ``first`` (1-based, at least 3: the loop times
    from there) to the last unprofiled one. Returns the records' per-step
    numbers and the source's ``is_synthetic``."""
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.data import native
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    steps = cfg.trainer.total_steps
    trainer = Trainer(cfg)
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profiled else None)
    mark = {}

    def on_step(step, metrics):
        if prof is None:
            return
        if step == steps - 1 - profiled:
            mark["t0"] = time.perf_counter()
            prof.start()
        elif step == steps - 1:
            torch.cuda.synchronize()
            mark["wall"] = time.perf_counter() - mark["t0"]
            prof.stop()

    calls0 = dict(native.calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, last = trainer.fit(on_step=on_step)
    wall = time.perf_counter() - t0
    counts = read_launches()
    # FlopCounterMode's one forward and backward (the loop's MFU probe
    # for a family other than the GPT) runs the kernels once more.
    passes = steps + (last.get("flops_source") == "flop_counter")
    for name, n in counts.items():
        check(n == per_step.get(name, 0) * passes,
              f"{cfg.name}: {name} launched {n} times in {steps} steps and "
              f"{passes - steps} FLOP count, want {per_step.get(name, 0)} "
              "each")
    check(native.calls["numpy"] == calls0["numpy"],
          f"{cfg.name}: a loader call took the numpy path")
    recs = read_jsonl(os.path.join(cfg.workdir, cfg.name, "metrics.jsonl"))
    check([r["step"] for r in recs] == list(range(1, steps + 1)),
          f"{cfg.name}: metrics.jsonl steps {[r['step'] for r in recs]}")
    for r in recs:
        check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
              f"{cfg.name}: non-finite record {r}")
    # A timed window's step: its wait for the batch plus the rest.
    quiet = recs[first - 1: steps - profiled]
    med = statistics.median(r["data_wait_s"] + r["compute_s"] for r in quiet)
    out = {
        "config": cfg.name, "steps": steps, "wall_s": wall,
        "source_is_synthetic": trainer.pipeline.source.is_synthetic,
        "records": [{k: r.get(k) for k in (
            "step", "loss", "grad_norm", "data_wait_s", "compute_s")}
            for r in recs],
        "median_over_steps": [first, steps - profiled],
        "step_s_median": med,
        "samples_per_s": cfg.data.global_batch_size / med,
        "data_wait_s_median": statistics.median(
            r["data_wait_s"] for r in quiet),
        "compute_s_median": statistics.median(r["compute_s"] for r in quiet),
        "data_wait_share": statistics.median(r["data_wait_s"] for r in quiet)
        / med,
        "mfu": last.get("mfu"), "flops_source": last.get("flops_source"),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches": {k: n for k, n in counts.items() if n},
        "flop_count_passes": passes - steps,
        "native_calls": native.calls["native"] - calls0["native"],
    }
    if prof is not None:
        report = device_profile(prof, mark["wall"])
        out["profile"] = {"steps": profiled, **{k: report[k] for k in (
            "wall_s", "device_busy_s", "device_idle_share", "cuda_events",
            "top_device_s")}}
        out["device_idle_share"] = report["device_idle_share"]
    del trainer, state, prof
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return out


def rn50_shards_phase(shard_dir: str, work: str, card: str) -> dict:
    """rn50_shards_path: ``imagenet_rn50_ddp`` at bench.py's headline point
    (s2d stem, mask pool, fused BatchNorm, batch 512) through the port's
    ``Trainer`` from the uint8 shards; beside it, in this call, the same
    with ``data_dir`` unset (synthetic batches built per step on the host)
    and the shards run with the conv7 stem (its step without the data
    wait against the s2d run's)."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )

    per_step = {"bn_bwd_sums": RN50_BNS, "bn_bwd_dx": RN50_BNS}
    common = ["trainer.log_every=1", "trainer.eval_every=0",
              "checkpoint.enabled=false"]
    runs = {}
    for key, extra in (("shards", [f"data.data_dir={shard_dir}"]),
                       ("synthetic", []),
                       ("shards_conv7", [f"data.data_dir={shard_dir}",
                                         "model.stem=conv7"])):
        steps, profiled, first = RN50_SHARD_RUNS[key]
        cfg = apply_overrides(get_config("imagenet_rn50_ddp"),
                              RN50_SHARD_OVERRIDES + common + extra
                              + [f"trainer.total_steps={steps}",
                                 f"workdir={os.path.join(work, key)}"])
        runs[key] = loop_run(cfg, per_step, profiled, first)
        check(runs[key]["source_is_synthetic"] == (key == "synthetic"),
              f"rn50_shards_path {key}: is_synthetic "
              f"{runs[key]['source_is_synthetic']}")
        if key != "synthetic":
            check(runs[key]["native_calls"] > 0,
                  f"rn50_shards_path {key}: no native loader call")
    shards, synth = runs["shards"], runs["synthetic"]
    report = {"card": card, "overrides": RN50_SHARD_OVERRIDES,
              "corpus": {"images": SHARD_IMAGES, "dtype": "uint8",
                         "stored": [SHARD_PX, SHARD_PX, 3]},
              "launches_per_step": per_step, **runs,
              "shards_over_synthetic_images_per_s":
                  shards["samples_per_s"] / synth["samples_per_s"],
              "s2d_over_conv7_compute_s":
                  shards["compute_s_median"]
                  / runs["shards_conv7"]["compute_s_median"],
              "steps_profiled_first": {k: list(v)
                                       for k, v in RN50_SHARD_RUNS.items()}}
    return report


class _FdsTo:
    """Send this process's stdout and stderr (file descriptors 1 and 2,
    which child processes inherit) to ``path`` for the scope."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        sys.stdout.flush()
        sys.stderr.flush()
        self.saved = [os.dup(1), os.dup(2)]
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(fd)
        return self

    def __exit__(self, *exc):
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, saved in zip((1, 2), self.saved):
            os.dup2(saved, fd)
            os.close(saved)


_LOG_TIME = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) ")


def _log_lines(path: str) -> list:
    """(epoch seconds, text) of each timestamped line of a port log."""
    import datetime

    out = []
    with open(path, errors="replace") as f:
        for line in f:
            m = _LOG_TIME.match(line)
            if m:
                t = datetime.datetime.strptime(m.group(1),
                                               "%Y-%m-%d %H:%M:%S,%f")
                out.append((t.timestamp(), line.rstrip()))
    return out


def _first(lines: list, pattern: str, after: float = 0.0):
    rx = re.compile(pattern)
    return next(((t, line) for t, line in lines
                 if t >= after and rx.search(line)), (None, None))


def kernel_events(trace_path: str) -> dict:
    """Kernels of a ``torch.profiler`` Chrome trace whose name matches
    each ``ELASTIC_KERNELS`` pattern, and the whole window's kernels."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    out = {k: sum(bool(re.search(rx, n)) for n in names)
           for k, rx in ELASTIC_KERNELS.items()}
    out["kernels_in_window"] = len(names)
    return out


def elastic_phase(shard_dir: str, work: str, card: str) -> dict:
    """elastic_path: a supervised, streaming ``imagenet_rn50_ddp`` run on
    the card whose first child is killed after step 7 and resumed
    (module docstring, 36d)."""
    import threading

    data, staging = os.path.join(work, "data"), os.path.join(work, "staging")
    os.makedirs(data)
    os.makedirs(staging)
    pairs = ELASTIC_START_PAIRS + ELASTIC_SEALED_PAIRS
    for i in range(pairs):
        dst = data if i < ELASTIC_START_PAIRS else staging
        for kind in ("images", "labels"):
            name = f"train_{kind}_{i:03d}.npy"
            os.link(os.path.join(shard_dir, name), os.path.join(dst, name))
    run_dir = os.path.join(work, "imagenet_rn50_ddp")
    metrics = os.path.join(run_dir, "metrics.jsonl")
    seen, stop = {}, threading.Event()

    def watch():
        """Seal pairs 2-3 once step SEAL_AT_STEP is logged; note when
        each record first shows."""
        while not stop.wait(0.05):
            try:
                recs = read_jsonl(metrics)
            except (OSError, ValueError):
                continue
            for r in recs:
                seen.setdefault(r["step"], time.time())
            if SEAL_AT_STEP in seen and "sealed" not in seen:
                for i in range(ELASTIC_START_PAIRS, pairs):
                    for kind in ("images", "labels"):  # labels commit
                        name = f"train_{kind}_{i:03d}.npy"
                        os.replace(os.path.join(staging, name),
                                   os.path.join(data, name))
                seen["sealed"] = time.time()

    args = (["--config=imagenet_rn50_ddp", "--device=cuda", "--elastic"]
            + RN50_SHARD_OVERRIDES + ELASTIC_OVERRIDES
            + [f"data.data_dir={data}", f"workdir={work}"])
    log = os.path.join(OUT_DIR, "elastic_path.log")
    env = {"FRL_FAULT_AT_STEP": str(ELASTIC_FAULT_STEP),
           "FRL_STEP_DELAY_S": str(ELASTIC_STEP_DELAY_S)}
    os.environ.update(env)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the children's memory
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    t0 = time.time()
    try:
        with _FdsTo(log):
            rc, _ = launch_main(args)
    finally:
        stop.set()
        watcher.join()
        for k in env:
            os.environ.pop(k, None)
    wall = time.time() - t0
    check(rc == 0, f"elastic_path: the supervisor returned {rc} "
          f"(log: {log})")
    with open(os.path.join(run_dir, "supervisor_0_trace.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    runs = [e for e in spans if e["name"] == "child_run"]
    rcs = [e["args"]["rc"] for e in runs]
    waits = [e for e in spans if e["name"] == "restart_wait"]
    check(rcs == [43, 0] and len(waits) == 1,
          f"elastic_path: child rcs {rcs}, {len(waits)} restart waits")
    prom = read_prom(os.path.join(run_dir, "supervisor_0.prom"))
    check(prom.get("elastic_restarts_total") == 1.0,
          f"elastic_path: supervisor series {prom}")
    recs = read_jsonl(metrics)
    steps = [r["step"] for r in recs]
    check(steps == list(range(2, ELASTIC_STEPS + 1, 2)),
          f"elastic_path: metrics.jsonl steps {steps}")
    for r in recs:
        check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
              f"elastic_path: non-finite record {r}")
    lines = _log_lines(log)
    t_fault, _ = _first(lines, r"fault injection: hard-exit\(43\) after "
                        f"step {ELASTIC_FAULT_STEP}")
    check(t_fault is not None, "elastic_path: no fault line in the log")
    starts = [(t, line) for t, line in lines
              if "streaming: train/images view starts at" in line]
    widened = [(t, line) for t, line in lines
               if "streaming: widened train/images view" in line]
    images = ELASTIC_START_PAIRS * SHARD_SIZE
    check(len(starts) == 2
          and f"at {ELASTIC_START_PAIRS} shards ({images} items)"
          in starts[0][1] and starts[0][0] < t_fault
          and f"at {pairs} shards ({pairs * SHARD_SIZE} items)"
          in starts[1][1] and starts[1][0] > t_fault,
          f"elastic_path: views at the start {starts}")
    m = re.search(r"view (\d+) -> (\d+) shards \((\d+) items\) at step "
                  r"(\d+)", widened[0][1]) if len(widened) == 1 else None
    widen = ([int(g) for g in m.groups()] if m else None)
    check(widen is not None and widen[:3] == [
        ELASTIC_START_PAIRS, pairs, pairs * SHARD_SIZE]
          and widen[3] in (4, 6) and widened[0][0] < t_fault,
          f"elastic_path: widenings {widened}")
    # Both children traced their step 1 of the window; the file is the
    # restarted child's (written after the fault).
    trace_path = os.path.join(run_dir, "trace", "trace.json")
    traced = [t for t, line in lines if "profiler: trace written" in line]
    check(len(traced) == 2 and traced[1] > t_fault
          and os.path.getmtime(trace_path) > t_fault,
          f"elastic_path: profiler traces written at {traced}")
    kernels = kernel_events(trace_path)
    for name in ELASTIC_KERNELS:
        check(kernels[name] == RN50_BNS,
              f"elastic_path: {name} kernels {kernels[name]} in the "
              f"restarted child's profiled step, want {RN50_BNS}")
    launching = [t for t, line in lines
                 if "launching imagenet_rn50_ddp on cuda" in line]
    first_rec = {2: seen.get(2), 8: seen.get(8)}
    restart_ready = _first(lines, r"restored checkpoint step 6", t_fault)[0]
    by_step = {r["step"]: r for r in recs}
    report = {
        "card": card, "overrides": RN50_SHARD_OVERRIDES + ELASTIC_OVERRIDES,
        "fault": env, "rc": rc, "wall_s": wall, "child_rcs": rcs,
        "child_run_s": [e["dur"] / 1e6 for e in runs],
        "restart_wait_s": waits[0]["dur"] / 1e6,
        "supervisor_series": prom,
        "steps": steps,
        "records": [{k: r.get(k) for k in (
            "step", "loss", "grad_norm", "data_wait_s", "compute_s",
            "step_time_median_s")} for r in recs],
        # Host clock between records (polled every 0.05 s), a step: the
        # delay included; 4-6 also holds the loop's one FLOP-count pass.
        "record_gap_s_a_step": {
            f"{a}-{b}": (seen[b] - seen[a]) / (b - a)
            for a, b in ((2, 4), (4, 6), (8, 10)) if a in seen and b in seen},
        "step_time_median_s_first_child": by_step[6].get(
            "step_time_median_s"),
        "delay_s_a_step": ELASTIC_STEP_DELAY_S,
        "child_spawn_to_launch_s": [
            launching[0] - t0 if launching else None,
            launching[1] - (t_fault + waits[0]["dur"] / 1e6)
            if len(launching) == 2 else None],
        "first_record_after_spawn_s": (first_rec[2] - t0
                                       if first_rec[2] else None),
        "fault_to_restored_s": (restart_ready - t_fault
                                if restart_ready else None),
        "restart_wall_s": (first_rec[8] - t_fault if first_rec[8] else None),
        "sealed_at_s": seen.get("sealed", t0) - t0,
        "views": {"first_child": [ELASTIC_START_PAIRS, pairs],
                  "widened_at_step": widen[3],
                  "restarted_child": pairs},
        "profiled_step_kernels": kernels,
        "log": log,
    }
    return report


def sanitize_phase(work: str) -> dict:
    """sanitize_check (module docstring, 36e)."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention
    from frl_distributed_ml_scaffold_tpu_torch.utils import debugging

    traps = {}
    t0 = time.perf_counter()
    z = torch.zeros(4, device="cuda")
    try:
        with debugging.sanitize("nans"):
            z / z
        traps["div"] = None
    except FloatingPointError as e:
        traps["div"] = str(e)
    check(traps["div"] is not None and "aten.div.Tensor" in traps["div"],
          f"sanitize_check: 0 / 0 on the card: {traps['div']}")
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn(1, 16, 1024, 64, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    q[0, 3, 100] = float("nan")
    before = flash_attention.flash_fwd.launches
    outs = {}
    try:
        with debugging.sanitize("nans"):
            o, lse = flash_attention.flash_fwd(q, k, v, causal=True)
            outs["o"] = o
            o * 2
        traps["flash"] = None
    except FloatingPointError as e:
        traps["flash"] = str(e)
    torch.cuda.synchronize()
    launched = flash_attention.flash_fwd.launches - before
    flash_attention.flash_fwd.launches = before
    check(launched == 1 and "o" in outs
          and bool(torch.isnan(outs["o"]).any())
          and traps["flash"] is not None
          and "aten.mul.Tensor" in traps["flash"],
          f"sanitize_check: NaN q through B1 ({launched} launch): "
          f"{traps['flash']}")
    losses, seconds = {}, {"traps": time.perf_counter() - t0}
    for value in ("", "nans,infs"):
        os.environ["FRL_TPU_SANITIZE"] = value
        out = os.path.join(work, value.replace(",", "_") or "off")
        try:
            rc, seconds[value or "off"] = launch_main(
                SANITIZE_MLP + [f"workdir={out}"])
        finally:
            os.environ.pop("FRL_TPU_SANITIZE", None)
        check(rc == 0, f"sanitize_check: mnist_mlp exited {rc}")
        check(debugging.active_checks() == frozenset(),
              "sanitize_check: checks left on after launch.main")
        losses[value or "off"] = [r["loss"] for r in read_jsonl(
            os.path.join(out, "mnist_mlp", "metrics.jsonl"))]
    check(len(losses["off"]) == 20 and losses["nans,infs"] == losses["off"],
          f"sanitize_check: losses {losses}")
    return {"traps": traps, "flash_launches": launched,
            "mlp_losses_bit_equal": True, "mlp_steps": len(losses["off"]),
            "mlp_seconds": seconds}


def lm_shards_phase(work: str, seed: int) -> dict:
    """lm_shards_path: a seeded uint16 token bin written by
    ``write_token_bin``, then ``gpt2_medium_zero1`` with ``data.name=lm``
    and flash through ``launch.main``: 384 / 192 / 192 flash launches a
    step, the data wait per step, no loader call through numpy."""
    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data import native
    from frl_distributed_ml_scaffold_tpu_torch.data.lm import write_token_bin

    lm_dir = os.path.join(work, "tokens")
    vocab = get_config("gpt2_medium_zero1").data.vocab_size
    write_token_bin(os.path.join(lm_dir, "train.bin"),
                    np.random.default_rng(seed).integers(0, vocab, LM_TOKENS),
                    vocab_size=vocab)
    args = ["--config=gpt2_medium_zero1", "model.attention=flash",
            "data.name=lm", f"data.data_dir={lm_dir}",
            f"trainer.total_steps={LM_STEPS}", "trainer.log_every=1",
            "trainer.eval_every=0", f"workdir={work}"]
    cfg = apply_overrides(get_config("gpt2_medium_zero1"), args[1:])
    layers, accum = cfg.model.num_layers, cfg.trainer.grad_accum
    per_step = {"flash_attention_fwd": 2 * layers * accum,
                "flash_attention_bwd_dq": layers * accum,
                "flash_attention_bwd_dkv": layers * accum}
    calls0 = dict(native.calls)
    reset_launches()
    rc, wall = launch_main(args)
    counts = read_launches()
    check(rc == 0, f"lm_shards_path: launch exited {rc}")
    for name, n in counts.items():
        check(n == per_step.get(name, 0) * LM_STEPS,
              f"lm_shards_path: {name} launched {n} times in {LM_STEPS} "
              f"steps, want {per_step.get(name, 0)} a step")
    check(native.calls["numpy"] == calls0["numpy"]
          and native.calls["native"] > calls0["native"],
          f"lm_shards_path: loader calls {native.calls} (from {calls0})")
    recs = read_jsonl(os.path.join(work, cfg.name, "metrics.jsonl"))
    check([r["step"] for r in recs] == list(range(1, LM_STEPS + 1))
          and all(math.isfinite(r["loss"]) for r in recs),
          f"lm_shards_path: records {recs}")
    return {"args": args[:-1], "tokens": LM_TOKENS,
            "bin_bytes": os.path.getsize(os.path.join(lm_dir, "train.bin")),
            "wall_s": wall, "launches": counts,
            "launches_per_step": per_step,
            "loss": [r["loss"] for r in recs],
            "data_wait_s": [r["data_wait_s"] for r in recs],
            "step_time_median_s": recs[-1].get("step_time_median_s"),
            "native_calls": native.calls["native"] - calls0["native"]}


def video_shards_phase(work: str, seed: int, card: str) -> dict:
    """video_shards_path: ``ego4d_video_elastic`` (batch 16, as
    video_path) from seeded uint8 clip shards through the ``Trainer``."""
    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.shards import sealed_save

    clip_dir = os.path.join(work, "clips")
    os.makedirs(clip_dir)
    base = get_config("ego4d_video_elastic").data
    rng = np.random.default_rng(seed)
    half = VIDEO_CLIPS // 2
    for i in range(2):
        sealed_save(os.path.join(clip_dir, f"train_clips_{i:03d}.npy"),
                    rng.integers(0, 256, (half, base.num_frames,
                                          base.image_size, base.image_size,
                                          base.channels), dtype=np.uint8))
        sealed_save(os.path.join(clip_dir, f"train_labels_{i:03d}.npy"),
                    rng.integers(0, base.num_classes, half).astype(np.int32))
    cfg = apply_overrides(get_config("ego4d_video_elastic"), [
        *VIDEO_OVERRIDES, "data.name=video", f"data.data_dir={clip_dir}",
        f"trainer.total_steps={VIDEO_SHARD_STEPS}", "trainer.log_every=1",
        "trainer.eval_every=0", "checkpoint.enabled=false",
        f"workdir={work}"])
    out = loop_run(cfg, {})
    check(not out["source_is_synthetic"] and out["native_calls"] > 0,
          "video_shards_path: the clips did not come from the shards")
    return {"card": card, "clips": VIDEO_CLIPS, "dtype": "uint8",
            "clip": [base.num_frames, base.image_size, base.image_size,
                     base.channels], **out}


# ------------------------ remat modes, optimizers, dropout, params files, beams
# gpt2_long as published: one warm-up step (lr 0 under the recipe's
# warmup) and LONG_STEPS timed steps under trainer.remat=full, then each
# per-block mode on the same batches (LONG_MODE_STEPS steps: the first
# step's loss, then the others' seconds).
LONG_STEPS, LONG_MODE_STEPS = 3, 3
LONG_MODES = (("remat_full", []),
              ("block_remat_full", ["trainer.remat=none",
                                    "model.block_remat=full"]),
              ("block_remat_save_attn", ["trainer.remat=none",
                                         "model.block_remat=save_attn"]))
# The three modes run the same forward (bf16 products, fp32 LayerNorm,
# softmax and loss); only the backward's recompute differs. Their first
# step's loss, a mean over 65536 tokens, is held to 1e-3 relative (a
# tenth of a bf16 ulp at the loss).
LONG_LOSS_RTOL = 1e-3
# adafactor_path: gpt2_medium_adafactor cut as train_path, warmup off and
# one batch repeated, so the loss must fall within ADAFACTOR_STEPS steps.
ADAFACTOR_OVERRIDES = ["model.attention=flash", "optimizer.warmup_steps=0"]
ADAFACTOR_STEPS = 3
# optimizers_check: one step of each optimizer from the same state and
# gradients on the card and the CPU, leaves of GPT-2-medium's block
# shapes; fp32 elementwise math in another order (and adafactor's means
# and RMS reduced in another order): 1e-6 absolute on params of scale
# 0.05 (and their moments).
OPT_SHAPES = {"attn.query": (1024, 1024), "mlp.fc_in": (4096, 1024),
              "mlp.fc_out": (1024, 4096), "ln.weight": (1024,),
              "mlp.fc_in.bias": (4096,)}
OPT_NAMES = ("adam", "lion", "adafactor", "sgd")
OPT_TOL = 1e-6
# dropout_check: gpt2_medium_zero1 + flash with model.dropout=0.1, its
# steps in turns with the same recipe at dropout 0 (the first of each a
# warm-up at lr 0; the host's spread within one run is wider than the
# cost measured, so the two are timed side by side).
DROPOUT_RATE = 0.1
DROPOUT_TURNS = ("plain", "dropout", "dropout", "plain", "plain", "dropout",
                 "dropout", "plain")
DROPOUT_OVERRIDES = ["model.attention=flash", f"model.dropout={DROPOUT_RATE}"]
# Kept share at each site within this many binomial standard deviations
# (a false alarm has odds below 1e-8 a site).
DROPOUT_SIGMAS = 6
# trainer.remat=full and model.block_remat=full / save_attn against
# remat=none gradients at the same seed: the same masks make the same
# gradients up to the backward's reduction order
# (the flash kernels and cuBLAS are deterministic here, so bit-equal is
# expected); a mask drawn anew in the recompute moves a leaf's gradient
# by about its own norm. Held to 1e-3 of each leaf's norm.
DROPOUT_REMAT_RTOL = 1e-3
# beam_path: 4 ragged prompts, 4 beams, 64 new tokens, timed twice.
BEAM_PROMPTS, BEAM_WIDTH, BEAM_NEW, BEAM_CALLS = 4, 4, 64, 2
# Beam 0's fp32 score against the teacher-forced sum of its tokens'
# log-probabilities: a sum of 64 fp32 log-probs, decode steps against one
# dense forward (1e-5 a token apart).
BEAM_SCORE_TOL = 1e-2


def _gpt_steps(cfg, sd, batches, n_steps: int, per_step: dict, what: str):
    """``n_steps`` train steps of ``cfg`` from weights ``sd`` on
    ``batches`` (cycled); every step's launches held to ``per_step``.
    Returns (records, peak bytes, state's optimizer bytes)."""
    model, policy, tx, schedule, state, loss_fn = _train_setup(cfg, sd)
    step = _step_fn(cfg, loss_fn, tx, policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recs = []
    for s in range(n_steps):
        before = read_launches()
        t0 = time.perf_counter()
        state, m = step(state, batches[s % len(batches)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        for name in after:
            n = after[name] - before[name]
            check(n == per_step.get(name, 0),
                  f"{what} step {s}: {name} launched {n} times, want "
                  f"{per_step.get(name, 0)}")
        rec = {"step": s, "lr": schedule(s), "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "step_s": wall}
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"{what} step {s}: non-finite loss or grad_norm {rec}")
        recs.append(rec)
    peak = torch.cuda.max_memory_allocated()
    opt_bytes = state_bytes(state.opt_state)
    n_params = sum(p.numel() for p in state.params.values())
    del model, state, step, tx
    torch.cuda.empty_cache()
    return recs, peak, opt_bytes, n_params


def _flash_per_step(cfg, recompute: bool) -> dict:
    """Flash launches a step: dQ and dK/dV once a layer and microbatch,
    the forward once more where the backward recomputes it."""
    n = cfg.model.num_layers * cfg.trainer.grad_accum
    return {"flash_attention_fwd": (2 if recompute else 1) * n,
            "flash_attention_bwd_dq": n, "flash_attention_bwd_dkv": n}


def long_phase(gen, card: str) -> dict:
    """long_path: ``gpt2_long`` as published (24 layers, d 1024, T 8192,
    global batch 8 in 8 microbatches, ``trainer.remat=full``,
    ``lm_loss_chunk=256``, flash, bf16_mixed, AdamW with the clip) from
    seeded weights and synthetic batches: one warm-up step at lr 0 and
    ``LONG_STEPS`` timed steps; then ``trainer.remat=none`` with
    ``model.block_remat=full`` and ``=save_attn`` on the same batches.
    Each mode: step seconds, tokens/s, MFU (analytic, causal attention
    included, no recompute counted), peak memory, the first step's loss
    and the flash launches a step against the count the code implies
    (every mode reruns the flash forward once in the backward: the whole
    loss, each block, or each attention sublayer, whose internals the
    attention's backward needs)."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import init_params
    from frl_distributed_ml_scaffold_tpu_torch.utils.flops import (
        gpt_train_flops,
    )

    base = get_config("gpt2_long")
    sd = init_params(base.model, gen)
    gb = base.data.global_batch_size
    data = SyntheticLM(base.data, split="train")
    batches = [data.batch(s, gb) for s in range(1 + LONG_STEPS)]
    report = {"card": card, "config": base.name,
              "seq_len": base.model.seq_len, "global_batch": gb,
              "grad_accum": base.trainer.grad_accum,
              "lm_loss_chunk": base.model.lm_loss_chunk,
              "attention": base.model.attention,
              "policy": base.precision.policy, "modes": {}}
    for label, ov in LONG_MODES:
        cfg = apply_overrides(base, ov)
        n = 1 + LONG_STEPS if label == "remat_full" else LONG_MODE_STEPS
        per_step = _flash_per_step(cfg, recompute=True)
        recs, peak, _, n_params = _gpt_steps(cfg, sd, batches, n, per_step,
                                             f"long_path {label}")
        flops = gpt_train_flops(cfg, n_params)
        step_s = statistics.median(r["step_s"] for r in recs[1:])
        report["modes"][label] = {
            "overrides": ov, "steps": recs, "step_s": step_s,
            "tokens_per_s": flops["tokens"] / step_s,
            "model_flops": flops["flops"],
            "mfu": flops["flops"] / step_s / H100_BF16_PEAK,
            "max_memory_allocated_bytes": peak,
            "flash_launches_per_step": per_step}
    first = {k: v["steps"][0]["loss"] for k, v in report["modes"].items()}
    ref = first["remat_full"]
    for label, loss in first.items():
        check(abs(loss - ref) <= LONG_LOSS_RTOL * abs(ref),
              f"long_path: {label} first loss {loss} against {ref}")
    report.update(first_step_loss=first, loss_rtol=LONG_LOSS_RTOL)
    del sd
    torch.cuda.empty_cache()
    return report


def adafactor_phase(sd, card: str, adamw_state_bytes: int) -> dict:
    """adafactor_path: ``gpt2_medium_adafactor`` cut as train_path
    (flash, full width and depth, 64 x 1024 tokens in 8 microbatches,
    dots remat), warmup off and one batch repeated: the loss must fall
    over ``ADAFACTOR_STEPS`` steps. Step seconds, tokens/s, and the
    optimizer state's bytes beside train_path's AdamW state."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM

    cfg = apply_overrides(get_config("gpt2_medium_adafactor"),
                          ADAFACTOR_OVERRIDES)
    gb = cfg.data.global_batch_size
    batch = SyntheticLM(cfg.data, split="train").batch(0, gb)
    recs, peak, opt_bytes, n_params = _gpt_steps(
        cfg, sd, [batch], ADAFACTOR_STEPS, _flash_per_step(cfg, True),
        "adafactor_path")
    check(recs[-1]["loss"] < recs[0]["loss"],
          f"adafactor_path: the loss did not fall {recs}")
    step_s = statistics.median(r["step_s"] for r in recs[1:])
    return {"card": card, "config": cfg.name, "overrides": ADAFACTOR_OVERRIDES,
            "optimizer": {"name": cfg.optimizer.name,
                          "lr": cfg.optimizer.learning_rate,
                          "weight_decay": cfg.optimizer.weight_decay,
                          "clip": cfg.optimizer.grad_clip_norm},
            "steps": recs, "step_s": step_s,
            "tokens_per_s": gb * cfg.model.seq_len / step_s,
            "max_memory_allocated_bytes": peak,
            "opt_state_bytes": opt_bytes,
            "adamw_opt_state_bytes": adamw_state_bytes,
            "params": n_params,
            "opt_state_bytes_per_param": opt_bytes / n_params}


def optimizers_phase() -> dict:
    """optimizers_check: adam, lion, adafactor and sgd (lr 1e-3, weight
    decay 0.1, the clip at 1.0), two fp32 steps each on the card and on
    the CPU from the same params, zero state and gradients, over leaves
    of GPT-2-medium's block shapes: every param and state leaf after each
    step within ``OPT_TOL``."""
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        OptimizerConfig,
        TrainerConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
        make_optimizer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.utils.trees import tree_leaves

    cpu = torch.Generator().manual_seed(15)
    params = {k: 0.05 * torch.randn(s, generator=cpu)
              for k, s in OPT_SHAPES.items()}
    grads = [{k: 0.02 * torch.randn(s, generator=cpu)
              for k, s in OPT_SHAPES.items()} for _ in range(2)]
    out = {}
    for name in OPT_NAMES:
        cfg = OptimizerConfig(name=name, learning_rate=1e-3, warmup_steps=0,
                              weight_decay=0.1, grad_clip_norm=1.0,
                              momentum=0.9)
        runs = {}
        for dev in ("cuda", "cpu"):
            tx, _ = make_optimizer(cfg, TrainerConfig(total_steps=10), None)
            p = {k: v.to(dev, copy=True) for k, v in params.items()}
            st = tx.init(p)
            errs = []
            for g in grads:
                tx.update({k: v.to(dev) for k, v in g.items()}, st, p)
                errs.append([x.to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else x
                             for x in (*p.values(), *tree_leaves(st))])
            runs[dev] = errs
        worst = 0.0
        for step_c, step_g in zip(runs["cpu"], runs["cuda"]):
            for a, b in zip(step_c, step_g):
                if isinstance(a, torch.Tensor):
                    worst = max(worst, (a - b).abs().max().item())
                else:
                    check(a == b, f"optimizers_check {name}: {a} != {b}")
        check(worst <= OPT_TOL,
              f"optimizers_check {name}: card vs CPU max abs err {worst}")
        out[name] = {"max_abs_err": worst, "tol": OPT_TOL}
    return {"shapes": OPT_SHAPES, "steps": 2, "optimizers": out}


def dropout_phase(sd, card: str, train_step_s: float) -> dict:
    """dropout_check: ``gpt2_medium_zero1`` + flash with
    ``model.dropout=0.1``. One training forward of 8 x 1024 tokens with
    every mask recorded: one a site (the embedding and two a block), each
    kept share within ``DROPOUT_SIGMAS`` binomial standard deviations;
    the same seed gives the same loss; ``trainer.remat=full`` gradients,
    and those of ``model.block_remat=full`` and ``save_attn`` (each block
    checkpointed on its own, its sites' generators seeded inside the
    region), against ``remat=none`` at the same seed. Then steps at
    train_path's
    shape in turns with the same recipe at dropout 0
    (``DROPOUT_TURNS``: a warm-up each, then three timed each), and the
    host cost of the masks' generators."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.models import dropout as mdrop
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    cfg = apply_overrides(get_config("gpt2_medium_zero1"), DROPOUT_OVERRIDES)
    small = SyntheticLM(cfg.data, split="train").batch(0, 8)
    model, policy, tx, _, state, loss_fn = _train_setup(cfg, sd)
    masks = []
    real = mdrop.keep_mask

    def spy(shape, rate, seed, *site, device):
        m = real(shape, rate, seed, *site, device=device)
        masks.append((site, m.float().mean().item(), m.numel()))
        return m

    mdrop.keep_mask = spy
    try:
        with torch.no_grad():
            toks = torch.from_numpy(small["tokens"][:, :-1]).cuda()
            model(toks, train=True, rng=123)
    finally:
        mdrop.keep_mask = real
    layers = cfg.model.num_layers
    want_sites = {(layers, 0)} | {(i, s) for i in range(layers)
                                  for s in (0, 1)}
    check({site for site, _, _ in masks} == want_sites
          and len(masks) == len(want_sites),
          f"dropout_check: sites {[s for s, _, _ in masks]}")
    keep = 1.0 - DROPOUT_RATE
    shares = []
    for site, share, n in masks:
        bound = DROPOUT_SIGMAS * math.sqrt(DROPOUT_RATE * keep / n)
        check(abs(share - keep) <= bound,
              f"dropout_check: site {site} kept {share}, bound {bound}")
        shares.append(share)
    grads = {}
    for remat in ("none", "full", "none"):
        fn = make_grad_fn(loss_fn, policy, remat=remat, seed=7,
                          device="cuda")
        loss, _, _, g = fn(state.params, {}, small, 3)
        grads.setdefault(remat, []).append((float(loss), g))
    (l0, g0), (l1, _) = grads["none"]
    check(l0 == l1, f"dropout_check: one seed, two losses {l0} {l1}")
    lf, gf = grads["full"][0]
    rel = max(((gf[k] - g).norm() / g.norm().clamp_min(1e-30)).item()
              for k, g in g0.items())
    bit_equal = all(torch.equal(gf[k], g) for k, g in g0.items())
    check(rel <= DROPOUT_REMAT_RTOL,
          f"dropout_check: remat=full grads off by {rel} of their norm")
    del grads, gf, model, state, tx
    torch.cuda.empty_cache()
    block = {}
    for mode in ("full", "save_attn"):
        c = apply_overrides(cfg, ["trainer.remat=none",
                                  f"model.block_remat={mode}"])
        model, policy, tx, _, state, loss_fn = _train_setup(c, sd)
        fn = make_grad_fn(loss_fn, policy, remat="none", seed=7,
                          device="cuda")
        loss, _, _, g = fn(state.params, {}, small, 3)
        b_rel = max(((g[k] - g0k).norm() / g0k.norm().clamp_min(1e-30))
                    .item() for k, g0k in g0.items())
        check(b_rel <= DROPOUT_REMAT_RTOL,
              f"dropout_check: block_remat={mode} grads off by {b_rel} of "
              "their norm")
        block[mode] = {"loss": float(loss), "grad_rel_err": b_rel,
                       "grads_bit_equal": all(torch.equal(g[k], g0k)
                                              for k, g0k in g0.items())}
        del model, state, tx, g
        torch.cuda.empty_cache()
    del g0
    data = SyntheticLM(cfg.data, split="train")
    gb = cfg.data.global_batch_size
    batches = [data.batch(s, gb) for s in range(3)]
    per_step = _flash_per_step(cfg, True)
    runs = {}
    for label, c in (("plain", apply_overrides(get_config(
            "gpt2_medium_zero1"), TRAIN_OVERRIDES)), ("dropout", cfg)):
        model, policy, tx, _, state, loss_fn = _train_setup(c, sd)
        runs[label] = {"state": state, "model": model,
                       "step": _step_fn(c, loss_fn, tx, policy), "recs": []}
    for label in DROPOUT_TURNS:
        run = runs[label]
        s = len(run["recs"])
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run["state"], m = run["step"](run["state"], batches[s % 3])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_launches()
        for name in after:
            n = after[name] - before[name]
            check(n == per_step.get(name, 0),
                  f"dropout_check {label} step {s}: {name} launched {n}")
        check(math.isfinite(float(m["loss"])),
              f"dropout_check {label} step {s}: loss {float(m['loss'])}")
        run["recs"].append({"step": s, "loss": float(m["loss"]),
                            "step_s": wall})
    steps = {k: r["recs"] for k, r in runs.items()}
    step_s = {k: statistics.median(x["step_s"] for x in r[1:])
              for k, r in steps.items()}
    del runs
    torch.cuda.empty_cache()
    # Host cost: one generator made and seeded on the card per site.
    reps = 2000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        torch.Generator(device="cuda").manual_seed(mdrop.mix_seed(1, i, 0))
    gen_us = (time.perf_counter() - t0) / reps * 1e6
    # dots remat reruns each site in the backward: twice a microbatch.
    sites_per_step = 2 * len(want_sites) * cfg.trainer.grad_accum
    return {"card": card, "config": cfg.name, "overrides": DROPOUT_OVERRIDES,
            "sites": len(masks), "kept_share_min": min(shares),
            "kept_share_max": max(shares), "sigmas": DROPOUT_SIGMAS,
            "same_seed_same_loss": True, "loss_remat_none": l0,
            "loss_remat_full": lf, "remat_grad_rel_err": rel,
            "remat_grads_bit_equal": bit_equal, "block_remat": block,
            "remat_rtol": DROPOUT_REMAT_RTOL, "turns": DROPOUT_TURNS,
            "steps": steps, "step_s": step_s,
            "step_ratio": step_s["dropout"] / step_s["plain"],
            "train_path_step_s": train_step_s,
            "generator_us": gen_us, "sites_per_step": sites_per_step,
            "generator_ms_per_step": gen_us * sites_per_step / 1e3}


def init_params_phase(gen, sd, work: str) -> dict:
    """init_params_check: seeded ``imagenet_rn50_ddp`` params written
    with the port's flax msgpack writer, loaded by the ``Trainer`` under
    ``precision.policy=bf16`` (equal to the file's, cast to bf16), then
    trained through ``launch.main`` with ``trainer.init_params_path``,
    ``precision.policy=bf16`` and ``optimizer.name=fused_adamw`` (no
    clip, replicated state: the ``rn50_fused_opt`` point): 42 AdamW
    launches a step with a bf16 p, finite losses. Then ``gpt2_medium_zero1``
    at bf16_mixed from a file of the serving weights: the first step's
    loss equals the run from the same weights without a file."""
    from frl_distributed_ml_scaffold_tpu_torch.checkpoint import flax_msgpack
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.models import convert
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )

    rcfg = apply_overrides(get_config("imagenet_rn50_ddp"), RN50_OVERRIDES)
    params, extras = convert.init_resnet_params(rcfg.model, gen,
                                                in_channels=3)
    params = {k: v.cpu() for k, v in params.items()}
    extras = {"batch_stats": {k: v.cpu() for k, v in
                              extras["batch_stats"].items()}}
    path = os.path.join(work, "rn50.msgpack")
    t0 = time.perf_counter()
    with open(path, "wb") as fh:
        flax_msgpack.dump(convert.resnet_params_to_jax(params, extras,
                                                       rcfg.model)[0], fh)
    write_s = time.perf_counter() - t0
    ov = RN50_OVERRIDES + ["precision.policy=bf16",
                           "optimizer.name=fused_adamw",
                           f"trainer.init_params_path={path}",
                           "trainer.total_steps=2", "trainer.log_every=1",
                           "trainer.eval_every=0", f"workdir={work}"]
    cfg = apply_overrides(get_config("imagenet_rn50_ddp"), ov)
    t0 = time.perf_counter()
    state = Trainer(cfg, device="cuda").init_state()
    load_s = time.perf_counter() - t0
    for k, v in params.items():
        got = state.params[k]
        check(got.dtype == torch.bfloat16
              and torch.equal(got.cpu(), v.bfloat16()),
              f"init_params_check: {k} is not the file's leaf in bf16")
    del state
    torch.cuda.empty_cache()
    reset_launches()
    rc, run_s = launch_main([f"--config={cfg.name}", *ov])
    counts = read_launches()
    check(rc == 0, f"init_params_check: launch.main returned {rc}")
    per_step = RN50_BIG_LEAVES
    check(counts["fused_adamw"] == per_step * cfg.trainer.total_steps,
          f"init_params_check: fused_adamw launched {counts['fused_adamw']}"
          f" times in {cfg.trainer.total_steps} steps")
    recs = read_jsonl(os.path.join(work, cfg.name, "metrics.jsonl"))
    losses = [r["loss"] for r in recs if "loss" in r]
    check(len(losses) == cfg.trainer.total_steps
          and all(math.isfinite(x) for x in losses),
          f"init_params_check: losses {losses}")
    # GPT-2-medium at bf16_mixed (fp32 params) from a file of ``sd``.
    gpath = os.path.join(work, "gpt2_medium.msgpack")
    gov = TRAIN_OVERRIDES + ["data.global_batch_size=8",
                             "trainer.grad_accum=1"]
    base = apply_overrides(get_config("gpt2_medium_zero1"), gov)
    with open(gpath, "wb") as fh:
        flax_msgpack.dump(convert.params_to_jax(
            {k: v.cpu() for k, v in sd.items()}, base.model), fh)
    file_bytes = os.path.getsize(gpath)
    batch = SyntheticLM(base.data, split="train").batch(0, 8)
    first = {}
    for label, c in (("file", apply_overrides(
            base, [f"trainer.init_params_path={gpath}"])), ("seeded", base)):
        trainer = Trainer(c, device="cuda")
        st = (trainer.init_state() if label == "file" else
              TrainState.create(sd, trainer.tx, device="cuda"))
        _, m = trainer.train_step(st, batch)
        first[label] = float(m["loss"])
        del trainer, st
        torch.cuda.empty_cache()
    check(first["file"] == first["seeded"],
          f"init_params_check: first loss {first}")
    os.remove(gpath)
    return {"rn50": {"config": cfg.name, "overrides": ov, "file": path,
                     "file_bytes": os.path.getsize(path),
                     "write_s": write_s, "trainer_load_s": load_s,
                     "params_equal_file_bf16": True,
                     "launch_rc": rc, "launch_s": run_s,
                     "fused_adamw_launches": counts["fused_adamw"],
                     "fused_adamw_per_step": per_step, "losses": losses},
            "gpt2_medium": {"policy": base.precision.policy,
                            "file_bytes": file_bytes,
                            "first_loss": first}}


# tp_serve_path: two ranks on the one card, model=2 (8 of 16 heads a
# rank), 8 requests of each paths' kind, 32 new tokens.
TP_RANKS = 2
TP_REQUESTS = 8
TP_NEW = 32
TP_TIMEOUT_S = 300
# What a lock-stepped engine calls: the row-parallel all-reduces, the
# token broadcasts, the step's plan and the admission flag.
TP_COLLECTIVES = ("all_reduce", "all_gather", "broadcast",
                  "broadcast_object_list")
# bf16 logits of the first step, two ranks against one: the row-parallel
# products round each rank's partial sum to bf16 before the sum, once a
# sublayer, where one rank rounds the whole sum once; allow the logits
# gate of the serving paths, 8 bf16 ulps of the largest logit.
TP_BF16_LOGIT_ULPS = 8


def _tp_engine_run(eng, reqs, new: int) -> dict:
    """Serve ``reqs`` through ``eng`` with the launch counts and the
    collectives counted: tokens per request, stats, tokens/s."""
    ids = [eng.submit(p, new) for p in reqs]
    reset_launches()
    torch.cuda.synchronize()
    with CountCollectives(TP_COLLECTIVES) as cc:
        t0 = time.perf_counter()
        done = {c.id: c for c in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_launches()
    check(sorted(done) == sorted(ids), "tp_serve_path: a request is missing")
    comps = [done[i] for i in ids]
    check(all(c.ok for c in comps), "tp_serve_path: a request did not end ok")
    n_tok = sum(len(c.tokens) - c.prompt_len for c in comps)
    st = dict(eng.stats)
    return {"tokens": [c.tokens.tolist() for c in comps],
            "prompt_lens": [c.prompt_len for c in comps],
            "generated_tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall, "stats": st,
            "launches": {k: n for k, n in counts.items() if n},
            "collectives": cc.counts}


def _tp_kernel_watch(da) -> dict:
    """Wrap the contiguous decode, paged decode and verify launchers of
    ``ops/decode_attention.py`` (the routers call them by module name):
    while ``on``, each call records its q's head count, and the first
    call of each kernel and dtype holds the kernel's output against the
    plain version on the same inputs (these plain calls launch
    nothing)."""
    seen = {"decode_attention": [], "paged_decode_attention": [],
            "paged_verify_attention": []}
    state = {"on": False, "seen": seen, "err": {}}

    def watch(name, real, plain):
        def launch(q, *a, **k):
            out = real(q, *a, **k)
            if not state["on"]:
                return out
            seen[name].append(int(q.shape[-2]))
            key = f"{name} {str(q.dtype)[6:]}"
            if key not in state["err"]:
                ref = plain(q, *a)
                state["err"][key] = {
                    "heads": int(q.shape[-2]), "dtype": str(q.dtype),
                    "max_abs_err": (out.float() - ref.float())
                    .abs().max().item()}
            return out
        return launch

    def plain_decode(q, k, v, kv_len, *_):
        return da.dense_decode_attention(q, k, v, kv_len.clamp_min(1))

    def plain_paged(fn):
        def run(q, kp, vp, kv_len, tables, ks=None, vs=None, *_):
            return fn(q, kp, vp, kv_len, tables, ks, vs)
        return run

    da._flash_decode = watch("decode_attention", da._flash_decode,
                             plain_decode)
    da._flash_paged_decode = watch(
        "paged_decode_attention", da._flash_paged_decode,
        plain_paged(da.dense_paged_decode_attention))
    da._flash_paged_verify = watch(
        "paged_verify_attention", da._flash_paged_verify,
        plain_paged(da.dense_paged_verify_attention))
    return state


def _first_diff(a: list, b: list, start: int):
    """The first position at or past ``start`` where ``a`` and ``b``
    differ (None when they agree)."""
    for j in range(start, min(len(a), len(b))):
        if a[j] != b[j]:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def tp_serve_rank(rank: int, port: int, out: str, seed: int) -> int:
    """One rank of tp_serve_path (``--tp-rank``): joins a gloo group of
    ``TP_RANKS`` processes on the one card (NCCL refuses two ranks on one
    device; gloo carries the CUDA tensors through host copies, chosen
    here for that reason), builds the ``data=1 model=2`` mesh, and serves
    ``gpt2_medium_serve`` at full width and depth from seeded weights
    (the same on both ranks) through ``build_engine(rules=
    gpt_tp_rules())``: the contiguous engine and the paged + ngram engine,
    fp32 then bf16_mixed. Rank 0 also serves the same requests on one
    rank (no mesh) as the reference, holds the fp32 tokens to them (the
    top-2-gap rule where they differ) and measures the first step's
    logits two ranks against one. Writes ``out/tp_rank<rank>.json``."""
    import datetime

    import numpy as np
    import torch.distributed as dist

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        MeshConfig,
        PrecisionConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
        build_mesh,
        mesh_context,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
        GPT,
        gpt_tp_rules,
    )
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.serving import build_engine

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=TP_RANKS,
        rank=rank, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    env = build_mesh(MeshConfig(data=1, model=TP_RANKS))
    watch = _tp_kernel_watch(decode_attention)
    base = get_config("gpt2_medium_serve")
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    sd = init_params(base.model, gen)
    vocab, layers = base.model.vocab_size, base.model.num_layers
    reqs = {"contiguous": requests(seed, vocab)[:TP_REQUESTS],
            "paged": paged_requests(seed, vocab)[:TP_REQUESTS]}
    report = {"rank": rank, "backend": dist.get_backend(),
              "coords": env.coords, "policies": {}}
    for policy in ("fp32", "bf16_mixed"):
        cfgs = {"contiguous": base.replace(
            precision=PrecisionConfig(policy=policy))}
        cfgs["paged"] = apply_overrides(cfgs["contiguous"], PAGED_OVERRIDES)
        cfg = cfgs["contiguous"]
        entry = {}
        one = None
        if rank == 0:
            one = GPT(cfg.model, get_policy(cfg.precision), device="cuda")
            one.load_state_dict(sd)
            entry["one_rank"] = {
                kind: _tp_engine_run(build_engine(
                    one, serving=c.serving, num_slots=8, eos_id=50256,
                    temperature=0.0), reqs[kind], TP_NEW)
                for kind, c in cfgs.items()}
        model = GPT(cfg.model, get_policy(cfg.precision), device="cuda")
        model.load_state_dict(sd)
        with mesh_context(env):
            engines = {"contiguous": build_engine(
                model, serving=cfgs["contiguous"].serving,
                rules=gpt_tp_rules(), num_slots=8, eos_id=50256,
                temperature=0.0)}
            # The params are placed: the paged engine takes them as they
            # are.
            engines["paged"] = build_engine(
                model, serving=cfgs["paged"].serving, num_slots=8,
                eos_id=50256, temperature=0.0)
        report["heads_per_rank"] = model.local_heads()
        check(model.local_heads() == base.model.num_heads // TP_RANKS,
              f"tp_serve_path: {model.local_heads()} heads a rank")
        for kind, eng in engines.items():
            watch["on"] = True
            run = _tp_engine_run(eng, reqs[kind], TP_NEW)
            watch["on"] = False
            st, n = run["stats"], run["launches"]
            per = ({"decode_attention": st["decode_steps"]}
                   if kind == "contiguous" else
                   {"paged_decode_attention": st.get("decode_paged", 0),
                    "paged_verify_attention": st.get("decode_verify", 0)})
            check_launches(read_launches(), per, layers,
                           f"tp_serve_path {policy} {kind}")
            run["launches_per_step"] = {
                k: n.get(k, 0) / max(v, 1) for k, v in per.items()}
            run["collectives_per_step"] = {
                k: v / max(st["decode_steps"], 1)
                for k, v in run["collectives"].items()}
            entry[kind] = run
        # The first step's logits, two ranks against one.
        prompt = torch.from_numpy(reqs["contiguous"][0])[None].cuda()
        bucket = generation.next_cache_bucket(base.model.seq_len,
                                              prompt.shape[1])
        with mesh_context(env), torch.no_grad():
            tp_logits, _ = generation._prefill(model, prompt, None,
                                               cache_len=bucket)
        if rank == 0:
            with torch.no_grad():
                one_logits, _ = generation._prefill(one, prompt, None,
                                                    cache_len=bucket)
            diff = (tp_logits.float() - one_logits.float()).abs().max().item()
            top = one_logits.float().abs().max().item()
            entry["first_step_logits"] = {
                "max_abs_diff": diff, "max_abs_logit": top,
                "tol": (TP_BF16_LOGIT_ULPS * 2 ** -7 * top
                        if policy == "bf16_mixed" else None)}
            for kind in cfgs:
                div = []
                for i, (a, b) in enumerate(zip(
                        entry[kind]["tokens"],
                        entry["one_rank"][kind]["tokens"])):
                    start = entry[kind]["prompt_lens"][i]
                    j = _first_diff(a, b, start)
                    rec = {"request": i, "first_diff_step":
                           None if j is None else j - start}
                    if j is not None and policy == "fp32":
                        gap = _top2_gap(one, cfg, np.asarray(b[:j],
                                                             np.int32))
                        rec.update(top2_gap=gap, gap_tol=FP32_GAP_TOL)
                        check(gap <= FP32_GAP_TOL,
                              f"tp_serve_path fp32 {kind}: request {i} "
                              f"differs at step {j - start} with top-2 "
                              f"gap {gap}")
                    div.append(rec)
                entry[kind]["vs_one_rank"] = div
        del engines, model, one
        torch.cuda.empty_cache()
        report["policies"][policy] = entry
    report["kernel_heads"] = {k: sorted(set(v))
                              for k, v in watch["seen"].items()}
    report["kernel_vs_plain"] = watch["err"]
    with open(os.path.join(out, f"tp_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def tp_serve_phase(seed: int, card: str) -> dict:
    """tp_serve_path: ``TP_RANKS`` processes of this script
    (``tp_serve_rank``) on the one card. Both ranks end with the same
    tokens; fp32 they are the one-rank engine's (top-2-gap rule); B4, B5
    and B6 launch 24 times a step of their kind at 8 heads a rank and
    agree with their plain versions there; the first step's bf16 logits
    are within ``TP_BF16_LOGIT_ULPS`` ulps of one rank's. gloo copies
    every collective through the host, so its times are no measure of
    tensor-parallel serving over NVLink."""
    ranks = _spawn_ranks("--tp-rank", ["--seed", str(seed)], TP_RANKS,
                         TP_TIMEOUT_S, "tp_serve", "tp")
    return tp_report(ranks, card)


def tp_report(ranks: list, card: str) -> dict:
    """tp_serve_path's checks across the ranks' results, and its line."""
    r0 = ranks[0]
    for r in ranks[1:]:
        for policy, entry in r["policies"].items():
            for kind in ("contiguous", "paged"):
                check(entry[kind]["tokens"]
                      == r0["policies"][policy][kind]["tokens"],
                      f"tp_serve_path {policy} {kind}: rank {r['rank']} "
                      "differs from rank 0")
    heads = {k: v for r in ranks for k, v in r["kernel_heads"].items()}
    check(all(v == [r0["heads_per_rank"]] for v in heads.values())
          and len(heads) == 3, f"tp_serve_path: kernel heads {heads}")
    for r in ranks:
        for name, e in r["kernel_vs_plain"].items():
            check(e["max_abs_err"] <= TOL[getattr(torch, e["dtype"][6:])],
                  f"tp_serve_path: {name} vs plain {e}")
    bf16 = r0["policies"]["bf16_mixed"]["first_step_logits"]
    check(bf16["max_abs_diff"] <= bf16["tol"],
          f"tp_serve_path: bf16 first-step logits {bf16}")
    report = {"card": card, "config": "gpt2_medium_serve",
              "mesh": {"data": 1, "model": TP_RANKS},
              "backend": r0["backend"],
              "backend_note": "gloo over CUDA tensors, every collective "
                              "copied through the host: not a measure "
                              "of tensor-parallel serving speed",
              "requests": TP_REQUESTS, "new_tokens": TP_NEW,
              "heads_per_rank": r0["heads_per_rank"],
              "kernel_heads": heads,
              "kernel_vs_plain": {r["rank"]: r["kernel_vs_plain"]
                                  for r in ranks}}
    for policy, entry in r0["policies"].items():
        rep = {"first_step_logits": entry["first_step_logits"]}
        for kind in ("contiguous", "paged"):
            run, one = entry[kind], entry["one_rank"][kind]
            rep[kind] = {k: run[k] for k in (
                "generated_tokens", "wall_s", "tokens_per_s",
                "launches", "launches_per_step", "collectives",
                "collectives_per_step", "vs_one_rank")}
            rep[kind]["decode_steps"] = run["stats"]["decode_steps"]
            rep[kind]["one_rank_tokens_per_s"] = one["tokens_per_s"]
            rep[kind]["identical_to_one_rank"] = all(
                d["first_diff_step"] is None for d in run["vs_one_rank"])
        report[policy] = rep
    return report


def offload_phase(sd, card: str, train: dict) -> dict:
    """offload_path: train_path's first three steps (the warm-up and two
    timed ones, same weights and batches) with
    ``trainer.offload_opt_state=true``: the AdamW state lives in pinned
    host memory and each update streams it through the card a leaf at a
    time. Losses and grad_norms equal train_path's bit for bit; every
    state tensor is pinned; the peak memory of the steps against
    train_path's; the step against train_path's."""
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        offload_state,
    )

    cfg = apply_overrides(get_config("gpt2_medium_zero1"),
                          TRAIN_OVERRIDES + OFFLOAD_OVERRIDES)
    model, policy, tx, schedule, state, loss_fn = _train_setup(cfg, sd)
    step = _step_fn(cfg, loss_fn, tx, policy)
    offload_state(state.opt_state)
    data = SyntheticLM(cfg.data, split="train")
    gb = cfg.data.global_batch_size
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(OFFLOAD_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, data.batch(s, gb))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps.append({"step": s, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "step_s": wall})
    peak = torch.cuda.max_memory_allocated()
    for got, want in zip(steps, train["steps"]):
        check(got["loss"] == want["loss"]
              and got["grad_norm"] == want["grad_norm"],
              f"offload_path step {got['step']}: {got} against train_path's "
              f"{want}")
    tensors = [t for v in state.opt_state.values() if isinstance(v, dict)
               for t in v.values()]
    check(all(t.device.type == "cpu" and t.is_pinned() for t in tensors),
          "offload_path: an optimizer-state tensor is not pinned host memory")
    host_bytes = sum(t.numel() * t.element_size() for t in tensors)
    check(host_bytes == train["opt_state_bytes"],
          f"offload_path: {host_bytes} state bytes on the host, train_path "
          f"holds {train['opt_state_bytes']}")
    check(peak < train["max_memory_allocated_bytes"],
          f"offload_path: peak {peak} not below train_path's "
          f"{train['max_memory_allocated_bytes']}")
    timed_s = [r["step_s"] for r in steps[1:]]
    report = {"card": card, "config": cfg.name,
              "overrides": TRAIN_OVERRIDES + OFFLOAD_OVERRIDES,
              "steps": steps, "step_s_median": statistics.median(timed_s),
              "train_path_step_s_median": train["step_s_median"],
              "step_ratio": statistics.median(timed_s)
              / train["step_s_median"],
              "losses_bit_equal_to_train_path": True,
              "opt_state_host_bytes": host_bytes, "all_pinned": True,
              "max_memory_allocated_bytes": peak,
              "train_path_max_memory_allocated_bytes":
                  train["max_memory_allocated_bytes"],
              "peak_saved_bytes": train["max_memory_allocated_bytes"] - peak}
    del model, state, step
    torch.cuda.empty_cache()
    return report


def beam_phase(cfg, sd, seed: int, card: str) -> dict:
    """beam_path: ``gpt2_medium_serve`` (bf16_mixed, seeded weights),
    ``BEAM_PROMPTS`` ragged prompts of 32-64 tokens, ``BEAM_WIDTH``
    beams, ``BEAM_NEW`` new tokens: tokens/s, and the decode kernel 24
    times a decode step (24 x 63 a call) and no other kernel. In fp32:
    one beam equals greedy ``generate()`` under the top-2-gap rule, and
    beam 0's score equals the teacher-forced sum of its tokens'
    log-probabilities."""
    import numpy as np

    from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
        beam_search,
        generate,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    rng = np.random.default_rng(seed + 15)
    lens = np.linspace(32, 64, BEAM_PROMPTS).astype(int)
    width = int(lens.max())
    prompt = np.zeros((BEAM_PROMPTS, width), np.int32)
    for row, n in enumerate(lens):
        prompt[row, width - n:] = rng.integers(0, cfg.model.vocab_size, n)
    prompt_t = torch.from_numpy(prompt).cuda()
    lens_t = torch.from_numpy(lens).cuda()
    out = {"card": card, "config": cfg.name, "prompt_lens": lens.tolist(),
           "beams": BEAM_WIDTH, "new_tokens": BEAM_NEW}
    model = GPT(cfg.model, get_policy(cfg.precision), device="cuda")
    model.load_state_dict(sd)
    beam_search(model, prompt_t, max_new_tokens=2, num_beams=BEAM_WIDTH,
                prompt_lengths=lens_t)  # warm-up
    walls = []
    for _ in range(BEAM_CALLS):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        toks, scores = beam_search(model, prompt_t, max_new_tokens=BEAM_NEW,
                                   num_beams=BEAM_WIDTH, prompt_lengths=lens_t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_launches()
        check_launches(counts, {"decode_attention": BEAM_NEW - 1},
                       cfg.model.num_layers, "beam_path")
    check(bool(torch.isfinite(scores).all()) and toks.shape == (
        BEAM_PROMPTS, width + BEAM_NEW), "beam_path: malformed result")
    wall = statistics.median(walls)
    out.update(policy=cfg.precision.policy, wall_s=walls,
               tokens_per_s=BEAM_PROMPTS * BEAM_NEW / wall,
               launches=counts, scores=scores.tolist())
    del model
    m32 = GPT(cfg.model, get_policy("fp32"), device="cuda")
    m32.load_state_dict(sd)
    one, _ = beam_search(m32, prompt_t, max_new_tokens=BEAM_NEW,
                         num_beams=1, prompt_lengths=lens_t)
    greedy = generate(m32, prompt_t, max_new_tokens=BEAM_NEW,
                      temperature=0.0, prompt_lengths=lens_t)
    rows = []
    for row, n in enumerate(lens):
        a, b = one[row].cpu().numpy(), greedy[row].cpu().numpy()
        diff = np.flatnonzero(a != b)
        entry = {"row": row, "identical": not diff.size}
        if diff.size:
            j = int(diff[0])
            gap = _top2_gap(m32, cfg, a[width - n:j])
            entry.update(first_diff_step=j - width, top2_gap=gap)
            check(gap <= FP32_GAP_TOL,
                  f"beam_path: one beam differs from greedy in row {row} "
                  f"at a top-2 gap of {gap}")
        rows.append(entry)
    best, best_scores = beam_search(m32, prompt_t, max_new_tokens=BEAM_NEW,
                                    num_beams=BEAM_WIDTH,
                                    prompt_lengths=lens_t)
    forced = []
    with torch.no_grad():
        for row, n in enumerate(lens):
            seq = best[row, width - n:].long()[None]
            lp = torch.log_softmax(m32(seq[:, :-1]).float(), dim=-1)
            new = seq[0, n:]
            forced.append(lp[0, n - 1:].gather(1, new[:, None]).sum().item())
    err = max(abs(a - b) for a, b in zip(forced, best_scores.tolist()))
    check(err <= BEAM_SCORE_TOL,
          f"beam_path: beam 0's score against teacher forcing off by {err}")
    out["fp32"] = {"one_beam_vs_greedy": rows, "gap_tol": FP32_GAP_TOL,
                   "scores": best_scores.tolist(), "teacher_forced": forced,
                   "score_err": err, "score_tol": BEAM_SCORE_TOL}
    del m32
    torch.cuda.empty_cache()
    return out


# lowp_check: the scaled low-precision products of the rings
# (ops/quantization.py) at GPT-2-medium's four tensor-parallel products
# per rank at model=2 (q, k and v each; out; fc_in; fc_out), [K, N], on
# LOWP_ROWS rows of bf16 activations.
LOWP_SHAPES = {"qkv": (1024, 512), "out": (512, 1024),
               "fc_in": (1024, 2048), "fc_out": (2048, 1024)}
LOWP_ROWS = 8192
# qdot on the card against its plain version on the same card operands,
# relative to the largest value: int8 exact (integer products); fp8_e5m2
# (bf16 tensor cores, fp32 accumulation) the order of the sums; fp8_e4m3
# through cuBLASLt's fp8 product, whose tensor-core accumulation keeps
# fewer bits than fp32 between its promotions (2.2e-4 measured at K=1024
# on an H100).
LOWP_TOL = {"int8": 0.0, "fp8_e4m3": 1e-3, "fp8_e5m2": 1e-5}
# Published peaks (dense) of the routes' operand types, for the bound.
LOWP_PEAK = {"int8": 1979e12, "fp8_e4m3": 1979e12, "fp8_e5m2": 989e12}


def lowp_phase(gen, card: str) -> dict:
    """``qdot`` through each format's card route (``QDOT_ROUTES``) at
    the shapes above, held against ``raw_plain`` scaled the same way on
    the same operands, and timed beside bf16 ``torch.matmul`` at the
    same shape; ``quantized_matmul`` (quantize both operands, then the
    product) timed too, and its straight-through backward held against
    the plain matmul's gradients once per format."""
    from frl_distributed_ml_scaffold_tpu_torch.ops import quantization as q

    report = {"card": card, "rows": LOWP_ROWS, "routes": q.QDOT_ROUTES,
              "products": {}}
    for name, (k, n) in LOWP_SHAPES.items():
        x = torch.randn(LOWP_ROWS, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        entry = {"K": k, "N": n,
                 "bf16_matmul_ms": cuda_time_ms(lambda: torch.matmul(x, w))}
        for fmt in QUANT_FORMATS:
            route = q.QDOT_ROUTES[fmt]
            qx, sx = q.quantize(x, fmt)
            qw, sw = q.quantize(w, fmt, channel_axes=1)
            sx = sx.reshape(())
            before = q.qdot_calls[route]
            got = q.qdot(qx, sx, qw, sw[0])
            check(q.qdot_calls[route] == before + 1,
                  f"lowp_check {name} {fmt}: the {route} route did not run")
            want = q.raw_plain(qx, qw) * (sx * sw[0])
            top = want.abs().max().item()
            err = (got - want).abs().max().item() / top
            check(err <= LOWP_TOL[fmt],
                  f"lowp_check {name} {fmt}: {route} vs plain {err}")
            ms = cuda_time_ms(lambda: q.qdot(qx, sx, qw, sw[0]))
            ops = 2 * LOWP_ROWS * k * n
            moved = (LOWP_ROWS * k + k * n) * 1 + LOWP_ROWS * n * 4
            bound = max(ops / LOWP_PEAK[fmt], moved / HBM_BYTES_PER_S) * 1e3
            entry[fmt] = {
                "route": route, "max_rel_err": err, "qdot_ms": ms,
                "plain_ms": cuda_time_ms(
                    lambda: q.raw_plain(qx, qw) * (sx * sw[0]), repeats=5),
                "quantized_matmul_ms": cuda_time_ms(
                    lambda: q.quantized_matmul(x, w, fmt)),
                "bound_ms": bound,
                "bound_by": ("operations" if ops / LOWP_PEAK[fmt]
                             > moved / HBM_BYTES_PER_S else "bytes"),
                "vs_bf16_matmul": entry["bf16_matmul_ms"] / ms}
            if name == "qkv":
                xg = x[:256].float().requires_grad_()
                wg = w.float().requires_grad_()
                dy = torch.randn(256, n, generator=gen, device="cuda")
                q.quantized_matmul(xg, wg, fmt).backward(dy)
                dx_err = (xg.grad - dy @ w.float().t()).abs().max().item()
                dw_err = (wg.grad - x[:256].float().t() @ dy).abs().max().item()
                check(max(dx_err, dw_err) <= 1e-3,
                      f"lowp_check {fmt}: straight-through backward "
                      f"{dx_err} {dw_err}")
                entry[fmt]["ste_backward_max_abs_err"] = max(dx_err, dw_err)
        report["products"][name] = entry
    report["qdot_calls"] = dict(q.qdot_calls)
    return report


# overlap_path: two processes of this script on the one card, like
# tp_serve_path. Each run: one warm-up step (lr 0) and OVERLAP_STEPS timed
# steps of 8 x 1024 tokens in 2 microbatches (cut from the recipes' 64 in
# 8 to fit the phase's time: gloo stages every ring hop through the host),
# 4 of the 24 layers (cut to 12 to make room for the A12 phases in the
# script's time limit, to 6 for pp_path, then to 4 for elastic_path),
# bf16_mixed, flash attention, seeded weights.
OVERLAP_RANKS = 2
OVERLAP_STEPS = 2
OVERLAP_TIMEOUT_S = 600
OVERLAP_OVERRIDES = ["model.attention=flash", "data.global_batch_size=8",
                     "trainer.grad_accum=2", "checkpoint.enabled=false",
                     "model.num_layers=4"]
# name: (recipe, mesh and batch, the plain step's overrides: the Megatron
# pair, or FSDP gathered at the start of the step). The FSDP run takes
# its 8 rows in one microbatch: its gathers move every block's params
# once a microbatch, whatever its rows.
OVERLAP_RUNS = {
    "tp_overlap": ("gpt2_medium_tp_overlap", ["mesh.model=2"],
                   ["parallel.tp_overlap=false"]),
    "tp_overlap_int8": ("gpt2_medium_tp_overlap_int8", ["mesh.model=2"],
                        ["parallel.tp_overlap=false",
                         "parallel.low_precision=none"]),
    "fsdp_overlap": ("gpt2_medium_fsdp_overlap",
                     ["mesh.fsdp=2", "trainer.grad_accum=1"],
                     ["parallel.fsdp_overlap=false"]),
}
# The fp32 step of gpt2_medium_tp_overlap: one step of 2 x 1024 tokens.
OVERLAP_FP32 = ["precision.policy=fp32", "data.global_batch_size=2",
                "trainer.grad_accum=1"]
# Losses against the plain step from the same weights and batches:
# bf16 1e-2 relative, the int8 rings the reference's 5e-3 band, fp32
# 1e-4.
OVERLAP_RTOL = {"tp_overlap": 1e-2, "tp_overlap_int8": 5e-3,
                "fsdp_overlap": 1e-2, "fp32": 1e-4}


def ring_bytes_per_step(cfg, n: int) -> dict:
    """What each rank sends on the ``model`` rings in one step of
    ``cfg`` under dots remat, by dtype: per block and microbatch 8 gather
    passes (q / k / v and fc_in forward, again in the recompute, and the
    backward's four) and 6 rotating passes (out and fc_out forward, again
    in the recompute, and the backward's two), each n - 1 hops of the
    microbatch's chunk of the stream (both halves); under ``lowp`` a
    1-byte payload and a 4-byte scale beside each half."""
    from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
        lowp_dtype,
        resolve_lowp,
    )

    m, t = cfg.model, cfg.trainer
    rows = cfg.data.global_batch_size // t.grad_accum
    chunk = rows * (m.seq_len // n) * m.hidden_dim
    passes = (8 + 6) * (n - 1) * m.num_layers * t.grad_accum
    lowp = resolve_lowp(cfg.parallel.low_precision)
    if lowp is None:
        return {"bfloat16": passes * chunk * 2}
    return {str(lowp_dtype(lowp)).removeprefix("torch."): passes * chunk,
            "float32": passes * 2 * 4}


def _overlap_run(cfg, steps: int, flash) -> dict:
    """``steps`` steps of ``cfg`` through the ``Trainer`` on this rank,
    each with its loss, grad_norm, seconds, flash launches and the heads
    they ran at, ring hops and bytes, staged bytes and block gathers."""
    from frl_distributed_ml_scaffold_tpu_torch.dist import collectives
    from frl_distributed_ml_scaffold_tpu_torch.ops import collective_matmul
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state()
    hooks = trainer.model.param_hooks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    for s in range(steps):
        batch = trainer.pipeline.global_batch(s)
        collectives.reset_counters()
        collective_matmul.ring_stats["hops"] = 0
        flash["heads"].clear()
        before = {k: f.launches for k, f in flash["fns"].items()}
        g0 = 0 if hooks is None else hooks.gathers + hooks.regathers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out.append({
            "step": s, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "step_s": wall,
            "launches": {k: f.launches - before[k]
                         for k, f in flash["fns"].items()},
            "heads": sorted(set(flash["heads"])),
            "ring_hops": collective_matmul.ring_stats["hops"],
            "ring_bytes": dict(collectives.wire_bytes.get("model", {})),
            "staged_bytes": dict(collectives.staged_bytes),
            "block_gathers": (None if hooks is None else
                              hooks.gathers + hooks.regathers - g0)})
    peak = torch.cuda.max_memory_allocated()
    del trainer, state
    torch.cuda.empty_cache()
    return {"steps": out, "max_memory_allocated_bytes": peak}


def overlap_rank(rank: int, port: int, out: str, seed: int) -> int:
    """One rank of overlap_path (``--overlap-rank``): joins a gloo group
    of ``OVERLAP_RANKS`` processes on the one card (NCCL refuses two
    ranks on one device; gloo takes CUDA tensors through pinned host
    copies, ``dist/collectives.py``), then for each of ``OVERLAP_RUNS``
    trains the plain step and the recipe's overlap step from the
    same seeded weights and batches through the ``Trainer``, then one
    fp32 step of each of the tensor-parallel pair. Writes
    ``out/overlap_rank<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=OVERLAP_RANKS, rank=rank,
        timeout=datetime.timedelta(seconds=OVERLAP_TIMEOUT_S))
    fns = {"flash_attention_fwd": fa.flash_fwd,
           "flash_attention_bwd_dq": fa.flash_bwd_dq,
           "flash_attention_bwd_dkv": fa.flash_bwd_dkv}
    flash = {"fns": fns, "heads": []}
    dims = fa._dims

    def watched_dims(q, seq_dim, causal):
        # Each launch reads its dims once: (B, H, T, D, dtype, causal).
        out = dims(q, seq_dim, causal)
        flash["heads"].append(int(out[1]))
        return out

    fa._dims = watched_dims
    report = {"rank": rank, "backend": dist.get_backend(), "runs": {},
              "plain": {}}
    base = OVERLAP_OVERRIDES + [f"trainer.seed={seed}"]
    for name, (recipe, mesh, plain_ov) in OVERLAP_RUNS.items():
        cfg = apply_overrides(get_config(recipe), base + mesh)
        key = " ".join(mesh)
        if key not in report["plain"]:
            # The plain step at the warm-up: the same weights and batch.
            report["plain"][key] = _overlap_run(
                apply_overrides(cfg, plain_ov), 1, flash)
        run = _overlap_run(cfg, 1 + OVERLAP_STEPS, flash)
        run.update(plain=key, config=recipe, mesh=mesh,
                   heads=cfg.model.num_heads, layers=cfg.model.num_layers,
                   grad_accum=cfg.trainer.grad_accum,
                   rows=cfg.data.global_batch_size,
                   want_ring_bytes=(ring_bytes_per_step(cfg, 2)
                                    if "model" in key else {}))
        report["runs"][name] = run
    cfg = apply_overrides(get_config("gpt2_medium_tp_overlap"),
                          base + ["mesh.model=2"] + OVERLAP_FP32)
    report["fp32"] = {
        "plain": _overlap_run(apply_overrides(
            cfg, ["parallel.tp_overlap=false"]), 1, flash),
        "overlap": _overlap_run(cfg, 1, flash)}
    with open(os.path.join(out, f"overlap_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def overlap_phase(seed: int, card: str) -> dict:
    """overlap_path: ``OVERLAP_RANKS`` processes of this script
    (``overlap_rank``) on the one card, and the checks across their
    results. gloo copies every collective through the host, so the step
    seconds are no measure of how well the schedule overlaps."""
    ranks = _spawn_ranks("--overlap-rank", ["--seed", str(seed)],
                         OVERLAP_RANKS, OVERLAP_TIMEOUT_S, "overlap",
                         "overlap")
    return overlap_report(ranks, card)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def overlap_report(ranks: list, card: str) -> dict:
    """overlap_path's checks: the ranks agree (one global loss); each
    run's warm-up loss (the same weights and batch) within
    ``OVERLAP_RTOL`` of the plain step's; B1-B3
    launched as train_path's per microbatch (twice, once and once per
    layer) at 8 heads a rank under the rings (16 under FSDP); the ring
    bytes each step equal ``ring_bytes_per_step``; the fsdp run gathered
    its blocks."""
    r0 = ranks[0]
    for r in ranks[1:]:
        for name, run in r["runs"].items():
            check([s["loss"] for s in run["steps"]]
                  == [s["loss"] for s in r0["runs"][name]["steps"]],
                  f"overlap_path {name}: rank {r['rank']} differs")
    report = {"card": card, "backend": r0["backend"],
              "backend_note": "gloo over CUDA tensors, every collective "
                              "staged through pinned host memory: not a "
                              "measure of how well the schedule overlaps",
              "overrides": OVERLAP_OVERRIDES, "runs": {}}
    for name, run in r0["runs"].items():
        plain = r0["plain"][run["plain"]]
        layers, accum = run["layers"], run["grad_accum"]
        per = {"flash_attention_fwd": 2 * layers * accum,
               "flash_attention_bwd_dq": layers * accum,
               "flash_attention_bwd_dkv": layers * accum}
        heads = run["heads"] // (2 if "model" in run["plain"] else 1)
        a, b = run["steps"][0], plain["steps"][0]
        rel = _rel(a["loss"], b["loss"])
        check(rel <= OVERLAP_RTOL[name],
              f"overlap_path {name}: warm-up loss {a['loss']} vs plain "
              f"{b['loss']}")
        for a in run["steps"]:
            check(math.isfinite(a["loss"]) and math.isfinite(a["grad_norm"]),
                  f"overlap_path {name} step {a['step']}: {a}")
            check(a["launches"] == per,
                  f"overlap_path {name} step {a['step']}: flash launches "
                  f"{a['launches']}, want {per}")
            check(a["heads"] == [heads],
                  f"overlap_path {name}: flash heads {a['heads']}")
            check(a["ring_bytes"] == run["want_ring_bytes"],
                  f"overlap_path {name} step {a['step']}: ring bytes "
                  f"{a['ring_bytes']}, want {run['want_ring_bytes']}")
            if name == "fsdp_overlap":
                check(a["block_gathers"] > 0 and a["staged_bytes"]
                      ["all_gather"] > 0, f"overlap_path {name}: no gathers")
        timed = [s["step_s"] for s in run["steps"][1:]]
        report["runs"][name] = {
            "config": run["config"], "mesh": run["mesh"],
            "global_batch": run["rows"], "grad_accum": accum,
            "heads_per_rank": heads,
            "losses": [s["loss"] for s in run["steps"]],
            "plain_loss": plain["steps"][0]["loss"],
            "loss_rel_vs_plain": rel, "rtol": OVERLAP_RTOL[name],
            "grad_norms": [s["grad_norm"] for s in run["steps"]],
            "plain_grad_norm": plain["steps"][0]["grad_norm"],
            "grad_norm_rel_vs_plain": _rel(run["steps"][0]["grad_norm"],
                                           plain["steps"][0]["grad_norm"]),
            "flash_launches_per_step": run["steps"][-1]["launches"],
            "ring_hops_per_step": run["steps"][-1]["ring_hops"],
            "ring_bytes_per_step": run["steps"][-1]["ring_bytes"],
            "ring_bytes_analytic": run["want_ring_bytes"],
            "staged_bytes_per_step": run["steps"][-1]["staged_bytes"],
            "block_gathers_per_step": run["steps"][-1]["block_gathers"],
            "step_s": timed, "step_s_median": statistics.median(timed),
            "warmup_step_s": run["steps"][0]["step_s"],
            "plain_warmup_step_s": plain["steps"][0]["step_s"],
            "max_memory_allocated_bytes": run["max_memory_allocated_bytes"],
            "plain_max_memory_allocated_bytes":
                plain["max_memory_allocated_bytes"]}
    fp = r0["fp32"]
    a, b = fp["overlap"]["steps"][0], fp["plain"]["steps"][0]
    check(_rel(a["loss"], b["loss"]) <= OVERLAP_RTOL["fp32"],
          f"overlap_path fp32: loss {a['loss']} vs plain {b['loss']}")
    report["fp32_tp_overlap"] = {
        "overrides": OVERLAP_FP32, "loss": a["loss"], "plain_loss": b["loss"],
        "loss_rel": _rel(a["loss"], b["loss"]),
        "grad_norm": a["grad_norm"], "plain_grad_norm": b["grad_norm"],
        "rtol": OVERLAP_RTOL["fp32"]}
    return report


# ------------------------------------------------- A12: MoE and sequence
# parallelism. moe_path: gpt2_moe on this process (expert=1); ep_path and
# sp_path: two gloo processes of this script on the one card, like
# overlap_path. moe_path runs 6 of gpt2_moe's 12 layers (cut for
# elastic_path in the script's time limit).
MOE_OVERRIDES = ["model.attention=flash", "mesh.expert=1",
                 "model.num_layers=6"]
MOE_STEPS = 2  # timed steps a dispatch, after a warm-up (lr 0)
# The two dispatches' step-0 losses (the same weights and batch) in
# fp32, at 2 x 1024 tokens: the reference's own tolerance between them
# (tests/test_models.py test_moe_sorted_matches_einsum, an fp32 test:
# outputs to 1e-5, aux to 1e-6). In bf16 the einsum combine rounds once
# and the sort combine once a slot, so the bf16 steps agree to
# MOE_BF16_RTOL.
MOE_LOSS_TOL = {"rtol": 1e-5, "atol": 1e-5}
MOE_AUX_RTOL = 1e-6
MOE_FP32 = ["precision.policy=fp32", "data.global_batch_size=2",
            "trainer.grad_accum=1"]
MOE_BF16_RTOL = 1e-3
MOE_REQUESTS, MOE_NEW = 8, 32
# The decode-step logits, kernel against impl="dense", in fp32: routing
# is discrete, and bf16 noise between the two attention routes can flip a
# near-tied top-k pick (or a capacity seat) and with it a whole row.
MOE_LOGITS_TOL = 1e-4
A12_RANKS = 2
A12_TIMEOUT_S = 480
# ep_path: gpt2_moe at full width over expert=2 (4 experts a rank), 6 of
# its 12 layers (cut to make room for pp_path in the script's time
# limit), one microbatch of 8 x 1024 tokens (the recipe: 64 in 8).
EP_OVERRIDES = ["model.attention=flash", "data.global_batch_size=8",
                "trainer.grad_accum=1", "checkpoint.enabled=false",
                "model.num_layers=6"]
EP_MESH = ["mesh.expert=2"]
EP_STEPS = 1  # timed, after the warm-up
# The same step in fp32 at 2 of the 12 layers (the cut is the time):
# without bf16 rounding the two routes route alike.
EP_FP32 = ["precision.policy=fp32", "model.num_layers=2"]
# Step 0 against the one-rank step, relative, loss and grad_norm. bf16:
# the expert outputs summed over two ranks round once more than one
# rank's combine, and a later layer's router sees the difference (read
# on an H100: loss 2.5e-5, grad_norm 3.0e-3; in fp32 8.6e-8 and 0). The
# control, the one-rank step with the other rank's experts left out
# (rank 0's output unsummed), reads loss 3.7e-5 and grad_norm 0.129: at
# random init the loss cannot tell them apart, grad_norm and the layer
# check can.
EP_RTOL = {"ep": {"loss": 1e-4, "grad_norm": 1e-2},
           "ep_fp32": {"loss": 1e-5, "grad_norm": 1e-5}}
# One MoE layer alone at the path's shapes and policy (8 x 1024 tokens,
# bf16_mixed), the two ranks' against the whole layer on one rank:
# max |diff| / max |ref| of y, aux and the gradients of x, the router and
# the rank's experts, and of the router under ``aux`` alone (the term
# every rank computes whole). Controls: rank r's output unsummed (the
# other experts left out) and that router gradient summed over expert;
# each must read above the limit. (Under the whole loss the aux term's
# share of the router's gradient is too small for a control.) Read on
# an H100: y 3.9e-3, the rest 0; controls 0.92-1.0 and 1.0.
EP_LAYER_TOL = 2e-2
# sp_path: gpt2_ring at full width, T 8192, over seq=2; global batch 8 ->
# 4 (two ranks and the one-rank reference on one card), 4 of its 24
# layers (cut to 12 to make room for pp_path in the script's time limit,
# then to 4 for elastic_path).
SP_OVERRIDES = ["data.global_batch_size=4", "checkpoint.enabled=false",
                "model.num_layers=4"]
SP_MESH = ["mesh.seq=2"]
SP_PLAIN = ["mesh.seq=1", "model.attention=flash", "parallel.sequence=none"]
SP_RUNS = {"ring": [],
           "ulysses": ["model.attention=ulysses", "parallel.sequence=ulysses"]}
SP_STEPS = 1
# Step 0 against the one-rank flash step, relative, loss and grad_norm
# (bf16: the ring merges its hops in fp32 and rounds once, Ulysses
# attends over whole rows of half the heads; read on an H100: ring
# 1.7e-7 and 1.8e-4, Ulysses 0 and 4.3e-5). At random init attention
# is near uniform and moves the loss little, so the check below is what
# holds the hops and the exchange.
SP_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}
# The attention alone at the path's shapes (4 rows, T 8192, 16 heads of
# 64, bf16; q, k, v and the output's gradient drawn N(0, 1)), each
# rank's output and q/k/v gradients against one flash attention over
# all T: max |diff| / max |ref|. Control: the rank's block attending to
# itself alone (the ring with its live hops skipped, Ulysses without its
# exchange); it must read above the limit. Read on an H100: ring up to
# 6.5e-3, Ulysses 0; the control 0.081 on rank 0 (dK), 10-25 on rank 1.
SP_ATTN_TOL = 2e-2
FLASH_FNS = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")


def _flash_per_layer(fwd: int, bwd: int) -> dict:
    return {"flash_attention_fwd": fwd, "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dkv": bwd}


def moe_dispatch_ms(cfg, sd, tokens: int) -> dict:
    """Where one MoE layer's time goes, at the path's microbatch of
    ``tokens`` tokens (layer 0's weights, bf16_mixed, forward and
    backward, CUDA events): the whole layer, its router (fp32 product,
    softmax, top-k, seating) and its experts alone at the same capacity;
    the dispatch (the token exchange there and back) is the rest."""
    import dataclasses

    import torch.nn.functional as F

    from frl_distributed_ml_scaffold_tpu_torch.models.moe import (
        MoEMlp,
        route,
    )
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    m, policy = cfg.model, get_policy(cfg.precision)
    cd = policy.compute_dtype
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn((tokens // m.seq_len, m.seq_len, m.hidden_dim),
                    generator=gen, device="cuda").to(cd).requires_grad_()
    e, k = m.moe.num_experts, m.moe.top_k
    cap = max(1, int(m.moe.capacity_factor * tokens * k / e))
    layer = {n.removeprefix("blocks.0.moe."): t for n, t in sd.items()
             if n.startswith("blocks.0.moe.")}
    out = {}
    for dispatch in ("einsum", "sort"):
        mcfg = dataclasses.replace(m, moe=dataclasses.replace(
            m.moe, dispatch=dispatch))
        mlp = MoEMlp(mcfg, policy, device="cuda")
        mlp.load_state_dict(layer)

        def full():
            y, aux = mlp(x, train=True)
            (y.float().square().mean() + aux).backward()

        out[dispatch] = cuda_time_ms(full, repeats=10)
    wi = layer["wi"].to(cd).requires_grad_()
    wo = layer["wo"].to(cd).requires_grad_()
    xin = torch.randn((e, 1, cap, m.hidden_dim), generator=gen,
                      device="cuda").to(cd).requires_grad_()

    def experts():
        h = F.gelu(torch.einsum("egcd,edh->egch", xin, wi),
                   approximate="tanh")
        torch.einsum("egch,ehd->egcd", h, wo).float().square().mean(
        ).backward()

    wr = layer["router.weight"].to(cd).requires_grad_()
    br = layer["router.bias"].to(cd).requires_grad_()

    def router():
        logits = F.linear(x.reshape(1, tokens, -1).float(), wr.float(),
                          br.float())
        probs, gates, *_ = route(logits, k, cap)
        (gates.sum() + probs.mean()).backward()

    exp_ms, router_ms = cuda_time_ms(experts, 10), cuda_time_ms(router, 10)
    return {dispatch: {"layer_ms": out[dispatch], "experts_ms": exp_ms,
                       "router_ms": router_ms,
                       "dispatch_ms": out[dispatch] - exp_ms - router_ms,
                       "dispatch_share_of_layer":
                           (out[dispatch] - exp_ms - router_ms)
                           / out[dispatch]}
            for dispatch in out}


def moe_phase(gen, card: str, seed: int) -> dict:
    """moe_path: ``gpt2_moe`` at full width (6 of its 12 layers, width
    1024, 16 heads, T 1024, 8 experts top-2, cf 1.25, bf16_mixed) on one
    card (expert=1), flash attention: a warm-up and ``MOE_STEPS`` timed
    steps of the recipe's 64 x 1024 tokens in 8 microbatches under each
    dispatch from the same weights and batches. B1-B3 launch 2 / 1 / 1
    times a layer and microbatch (dots remat reruns the forward), nothing
    else launches and nothing falls back; the two dispatches' step-0
    losses agree within the reference's tolerance and ``aux_loss`` is
    finite and above 0 (in fp32, one step each at 2 x 1024 tokens; in
    bf16 to ``MOE_BF16_RTOL``). Then ``build_engine`` serves ``MOE_REQUESTS``
    requests on the same weights: B4 launches 12 times a decode step and
    no other kernel; one decode step's logits against ``impl="dense"``
    (fp32). Step time, peak memory, one microbatch's forward and backward
    under the profiler (device busy time, idle share, the kernels that
    take it), and the dispatch's share of a layer and of the step, from
    CUDA-event times of one layer alone (``moe_dispatch_ms``)."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
    from frl_distributed_ml_scaffold_tpu_torch.models import generation
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    cfg = apply_overrides(get_config("gpt2_moe"),
                          MOE_OVERRIDES + [f"trainer.seed={seed}"])
    m = cfg.model
    sd = init_params(m, gen)
    data = SyntheticLM(cfg.data, split="train")
    gb, accum, layers = (cfg.data.global_batch_size, cfg.trainer.grad_accum,
                         m.num_layers)
    batches = [data.batch(s, gb) for s in range(1 + MOE_STEPS)]
    per_step = {k: v * layers * accum
                for k, v in _flash_per_layer(2, 1).items()}
    fallbacks = fa.flash_attention.fallbacks
    runs = {}
    for dispatch in ("einsum", "sort"):
        c = apply_overrides(cfg, [f"model.moe.dispatch={dispatch}"])
        model, policy, tx, schedule, state, loss_fn = _train_setup(c, sd)
        step = _step_fn(c, loss_fn, tx, policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for s in range(1 + MOE_STEPS):
            reset_launches()
            t0 = time.perf_counter()
            state, met = step(state, batches[s])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            for name, n in counts.items():
                check(n == per_step.get(name, 0),
                      f"moe_path {dispatch} step {s}: {name} launched {n} "
                      f"times, want {per_step.get(name, 0)}")
            rec = {k: float(v) for k, v in met.items()}
            rec.update(step=s, step_s=wall,
                       tokens_per_s=gb * m.seq_len / wall)
            check(all(math.isfinite(v) for v in rec.values()),
                  f"moe_path {dispatch} step {s}: {rec}")
            check(rec["aux_loss"] > 0, f"moe_path {dispatch}: aux_loss "
                  f"{rec['aux_loss']}")
            steps.append(rec)
        timed = [r["step_s"] for r in steps[1:]]
        peak = torch.cuda.max_memory_allocated()
        # One microbatch's forward and backward (the step's without the
        # update) under the profiler: its device time by kernel. A whole
        # step's events take the profiler a minute to process.
        grad_fn = make_grad_fn(loss_fn, policy, remat=c.trainer.remat,
                               device="cuda")
        mb = {k: v[:gb // accum] for k, v in batches[0].items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            grad_fn(state.params, state.extras, mb)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        micro = device_profile(prof, wall)
        runs[dispatch] = {
            "steps": steps, "step_s_median": statistics.median(timed),
            "tokens_per_s": gb * m.seq_len / statistics.median(timed),
            "max_memory_allocated_bytes": peak,
            "launches_per_step": counts,
            "microbatch_profile": {k: micro[k] for k in (
                "wall_s", "device_busy_s", "device_idle_share",
                "top_device_s")}}
        del grad_fn, prof
        del model, state, step, tx
        torch.cuda.empty_cache()
    check(fa.flash_attention.fallbacks == fallbacks,
          "moe_path: flash attention fell back")
    a, b = runs["einsum"]["steps"][0], runs["sort"]["steps"][0]
    bf16_rel = _rel(a["loss"], b["loss"])
    check(bf16_rel <= MOE_BF16_RTOL, f"moe_path: bf16 step-0 loss einsum "
          f"{a['loss']} vs sort {b['loss']}")
    # The reference's tolerance, in fp32 (one step each from sd).
    fp32 = {}
    c32 = apply_overrides(cfg, MOE_FP32)
    batch32 = data.batch(0, c32.data.global_batch_size)
    for dispatch in ("einsum", "sort"):
        c = apply_overrides(c32, [f"model.moe.dispatch={dispatch}"])
        model, policy, tx, schedule, state, loss_fn = _train_setup(c, sd)
        _, met = _step_fn(c, loss_fn, tx, policy)(state, batch32)
        fp32[dispatch] = {k: float(v) for k, v in met.items()}
        del model, state, tx
        torch.cuda.empty_cache()
    a, b = fp32["einsum"], fp32["sort"]
    gap = abs(a["loss"] - b["loss"])
    tol = MOE_LOSS_TOL["atol"] + MOE_LOSS_TOL["rtol"] * abs(b["loss"])
    check(gap <= tol, f"moe_path: fp32 step-0 loss einsum {a['loss']} vs "
          f"sort {b['loss']}")
    aux_rel = abs(a["aux_loss"] - b["aux_loss"]) / b["aux_loss"]
    check(aux_rel <= MOE_AUX_RTOL, f"moe_path: fp32 aux_loss einsum "
          f"{a['aux_loss']} vs sort {b['aux_loss']}")
    share = moe_dispatch_ms(cfg, sd, gb // accum * m.seq_len)
    for dispatch, d in share.items():
        d["dispatch_share_of_step"] = (d["dispatch_ms"] * layers * accum
                                       / 1e3 / runs[dispatch]["step_s_median"])

    # Serving: the bucketed contiguous engine on the same weights.
    policy = get_policy(cfg.precision)
    model = GPT(m, policy, device="cuda")
    model.load_state_dict(sd)
    reqs = requests(seed, m.vocab_size)[:MOE_REQUESTS]
    serve(model, cfg, reqs[:2], 4)  # warm-up
    reset_launches()
    eng, comps, wall = serve(model, cfg, reqs, MOE_NEW)
    counts = read_launches()
    dsteps = eng.stats["decode_steps"]
    check_launches(counts, {"decode_attention": dsteps}, layers,
                   "moe_path serve")
    del model, eng
    # One decode step's logits, kernel against dense, fp32.
    rng = np.random.default_rng(seed + 19)
    lens = torch.tensor([16, 100, 257, 200, 33, 180, 64, 256],
                        dtype=torch.int32, device="cuda")
    prompt = torch.from_numpy(rng.integers(0, m.vocab_size, (8, 256))
                              .astype(np.int32)).cuda()
    tok = torch.from_numpy(rng.integers(0, m.vocab_size, (8,))
                           .astype(np.int32)).cuda()
    logits = {}
    for impl in ("flash", "dense"):
        mm = GPT(dataclasses.replace(m, decode_attention=impl),
                 get_policy("fp32"), device="cuda")
        mm.load_state_dict(sd)
        reset_launches()
        _, cache = generation._prefill(mm, prompt, lens, cache_len=512)
        logits[impl] = generation._decode_step(mm, cache, tok)[0].float()
        check(read_launches()["decode_attention"]
              == (layers if impl == "flash" else 0),
              f"moe_path: the fp32 {impl} decode step's B4 launches")
        del mm, cache
    err = (logits["flash"] - logits["dense"]).abs().max().item()
    scale = max(1.0, logits["dense"].abs().max().item())
    check(err <= MOE_LOGITS_TOL * scale,
          f"moe_path decode logits kernel vs dense: {err}")
    torch.cuda.empty_cache()
    return {
        "card": card, "config": cfg.name, "overrides": MOE_OVERRIDES,
        "policy": cfg.precision.policy, "layers": layers,
        "d_model": m.hidden_dim, "heads": m.num_heads, "seq_len": m.seq_len,
        "experts": m.moe.num_experts, "top_k": m.moe.top_k,
        "capacity_factor": m.moe.capacity_factor, "global_batch": gb,
        "grad_accum": accum, "remat": cfg.trainer.remat,
        "flash_launches_per_step": per_step,
        "runs": runs, "bf16_step0_loss_rel_gap": bf16_rel,
        "bf16_rtol": MOE_BF16_RTOL,
        "fp32_check": {"overrides": MOE_FP32, "steps": fp32,
                       "step0_loss_gap": gap, "step0_loss_tol": tol,
                       "aux_rel_gap": aux_rel, "aux_rtol": MOE_AUX_RTOL},
        "dispatch": share,
        "fallbacks": fa.flash_attention.fallbacks - fallbacks,
        "serve": {"requests": len(comps), "new_tokens_max": MOE_NEW,
                  "decode_steps": dsteps, "launches": counts,
                  **_latencies(comps, wall)},
        "decode_logits_kernel_vs_dense_fp32": {
            "max_abs_err": err, "tol": MOE_LOGITS_TOL * scale}}


def a12_bytes(cfg, rank: int, name: str) -> dict:
    """What rank ``rank`` of sp_path sends over ``seq`` in one step of
    ``cfg`` under dots remat, by dtype. Ring (2 ranks): rank 0 sends its
    K/V block a forward (twice: the recompute replays the hop) and again
    with its fp32 dK/dV in the backward; rank 1 sends rank 0's dK/dV
    home. Ulysses: 12 exchanges a layer (q, k, v and the output, forward,
    recompute and backward), half of each to the other rank."""
    m = cfg.model
    rows = cfg.data.global_batch_size // cfg.trainer.grad_accum
    block = rows * (m.seq_len // 2) * m.hidden_dim  # elements of K (or V)
    per = m.num_layers * cfg.trainer.grad_accum
    if name == "ulysses":
        return {"bfloat16": per * 12 * block * 2 // 2}
    if rank == 0:
        return {"bfloat16": per * 3 * 2 * block * 2,
                "float32": per * 2 * block * 4}
    return {"float32": per * 2 * block * 4}


def _a12_run(cfg, steps: int, flash, tweak=None) -> dict:
    """``steps`` steps of ``cfg`` through the ``Trainer`` on this rank:
    losses, grad_norms and metrics, seconds, every kernel's launches and
    the flash kernels' heads, bytes sent by axis and dtype, staged
    bytes, peak memory. ``tweak(params)`` edits the initial params."""
    from frl_distributed_ml_scaffold_tpu_torch.dist import collectives
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state()
    if tweak is not None:
        with torch.no_grad():
            tweak(state.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fallbacks = fa.flash_attention.fallbacks
    out = []
    for s in range(steps):
        batch = trainer.pipeline.global_batch(s)
        collectives.reset_counters()
        flash["heads"].clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out.append({
            "step": s, **{k: float(v) for k, v in met.items()},
            "step_s": wall, "launches": read_launches(),
            "heads": sorted(set(flash["heads"])),
            "wire_bytes": {a: dict(v) for a, v in
                           collectives.wire_bytes.items()},
            "staged_bytes": dict(collectives.staged_bytes)})
    peak = torch.cuda.max_memory_allocated()
    res = {"steps": out, "max_memory_allocated_bytes": peak,
           "fallbacks": fa.flash_attention.fallbacks - fallbacks,
           "coords": trainer.env.coords}
    del trainer, state
    torch.cuda.empty_cache()
    return res


def _a12_configs(phase: str, seed: int) -> dict:
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )

    ov = [f"trainer.seed={seed}"]
    if phase == "ep":
        cfg = apply_overrides(get_config("gpt2_moe"),
                              EP_OVERRIDES + EP_MESH + ov)
        return {"ep": cfg, "ep_fp32": apply_overrides(cfg, EP_FP32)}
    base = apply_overrides(get_config("gpt2_ring"), SP_OVERRIDES + ov)
    return {name: apply_overrides(base, SP_MESH + extra)
            for name, extra in SP_RUNS.items()}


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|."""
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def ep_layer_check(cfg, env, seed: int) -> dict:
    """One MoE layer of ``cfg`` alone on this rank of ``expert`` against
    the whole layer on one rank, at the path's tokens and policy (seeded
    weights ~ N(0, 0.02), input and output gradient ~ N(0, 1)): the loss
    ``sum(y * dy) + aux``, then ``aux`` alone (whose router gradient every
    rank computes whole). ``EP_LAYER_TOL`` errors and their controls."""
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import mesh_context
    from frl_distributed_ml_scaffold_tpu_torch.models.moe import MoEMlp
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    m = cfg.model
    r, n = env.axis_index("expert"), env.axis_size("expert")
    el = m.moe.num_experts // n
    mine = slice(r * el, (r + 1) * el)
    policy = get_policy(cfg.precision.policy)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1919)
    rows = cfg.data.global_batch_size // cfg.trainer.grad_accum

    def draw(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    full = MoEMlp(m, policy, "cuda")
    with torch.no_grad():
        for p in (full.router.weight, full.wi, full.wo):
            p.copy_(draw(p.shape, 0.02))
        full.router.bias.zero_()
    x = draw((rows, m.seq_len, m.hidden_dim))
    dy = draw(x.shape)

    def grads(mod, on, aux_only=False):
        xx = x.clone().requires_grad_()
        with mesh_context(on):
            y, aux = mod(xx, train=True)
            (aux if aux_only else (y.float() * dy).sum() + aux).backward()
        out = {"y": y.detach(), "aux": aux.detach(), "dx": xx.grad,
               "drouter": mod.router.weight.grad, "dwi": mod.wi.grad,
               "dwo": mod.wo.grad}
        mod.zero_grad(set_to_none=True)
        return out

    ref, ref_aux = grads(full, None), grads(full, None, True)
    local = MoEMlp(m, policy, "cuda")
    local.router.load_state_dict(full.router.state_dict())
    local.wi = torch.nn.Parameter(full.wi.detach()[mine].clone())
    local.wo = torch.nn.Parameter(full.wo.detach()[mine].clone())
    got, got_aux = grads(local, env), grads(local, env, True)
    errs = {k: _rel_err(got[k], ref[k]) for k in ("y", "aux", "dx",
                                                   "drouter")}
    errs["dwi"] = _rel_err(got["dwi"], ref["dwi"][mine])
    errs["dwo"] = _rel_err(got["dwo"], ref["dwo"][mine])
    errs["drouter_aux_only"] = _rel_err(got_aux["drouter"],
                                        ref_aux["drouter"])
    with torch.no_grad():
        full.wo[:mine.start].zero_()
        full.wo[mine.stop:].zero_()
    controls = {
        "y_unsummed": _rel_err(grads(full, None)["y"], ref["y"]),
        "drouter_aux_only_summed": _rel_err(n * ref_aux["drouter"],
                                            ref_aux["drouter"])}
    return {"rank": r, "tokens": rows * m.seq_len,
            "dispatch": m.moe.dispatch, "errs": errs, "controls": controls}


def sp_attention_check(name: str, cfg, env, seed: int) -> dict:
    """``name`` attention (ring or ulysses) alone on this rank of ``seq``
    at the path's shapes (``SP_ATTN_TOL``): its output and q/k/v
    gradients against one flash attention over all T, and the control,
    this rank's block attending to itself alone."""
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import mesh_context
    from frl_distributed_ml_scaffold_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from frl_distributed_ml_scaffold_tpu_torch.ops.ring_attention import (
        ring_attention,
    )
    from frl_distributed_ml_scaffold_tpu_torch.ops.ulysses import (
        ulysses_attention,
    )

    m = cfg.model
    r, n = env.axis_index("seq"), env.axis_size("seq")
    rows = cfg.data.global_batch_size // cfg.trainer.grad_accum
    t, h = m.seq_len, m.num_heads
    gen = torch.Generator(device="cuda").manual_seed(seed + 1917)
    q, k, v, do = (torch.randn((rows, t, h, m.hidden_dim // h),
                               generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    mine = slice(r * t // n, (r + 1) * t // n)

    def grads(fn, ins, dout, on):
        leaves = [a.detach().clone().requires_grad_() for a in ins]
        with mesh_context(on):
            o = fn(*leaves, causal=True)
            o.backward(dout)
        return [o.detach()] + [a.grad for a in leaves]

    ref = [a[:, mine] for a in grads(flash_attention, (q, k, v), do, None)]
    part = (q[:, mine], k[:, mine], v[:, mine])
    fn = ring_attention if name == "ring" else ulysses_attention
    got = grads(fn, part, do[:, mine], env)
    own = grads(flash_attention, part, do[:, mine], None)
    keys = ("o", "dq", "dk", "dv")
    return {"rank": r, "shape": list(q.shape),
            "errs": {key: _rel_err(a, b) for key, a, b in zip(keys, got, ref)},
            "control": {key: _rel_err(a, b)
                        for key, a, b in zip(keys, own, ref)}}


def a12_rank(phase: str, rank: int, port: int, out: str, seed: int) -> int:
    """One rank of ep_path or sp_path (``--a12-rank``): joins a gloo
    group of ``A12_RANKS`` processes on the one card and trains each of
    the phase's runs through the ``Trainer`` (a warm-up and one timed
    step). Writes ``out/a12_rank<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import build_mesh
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=A12_RANKS, rank=rank,
        timeout=datetime.timedelta(seconds=A12_TIMEOUT_S))
    flash = {"heads": []}
    dims = fa._dims

    def watched_dims(q, seq_dim, causal):
        # Each launch reads its dims once: (B, H, T, D, dtype, causal).
        got = dims(q, seq_dim, causal)
        flash["heads"].append(int(got[1]))
        return got

    fa._dims = watched_dims
    steps = 1 + (EP_STEPS if phase == "ep" else SP_STEPS)
    report = {"rank": rank, "backend": dist.get_backend(), "runs": {}}
    cfgs = _a12_configs(phase, seed)
    for name, cfg in cfgs.items():
        report["runs"][name] = _a12_run(cfg, steps, flash)
    env = build_mesh(next(iter(cfgs.values())).mesh)
    if phase == "ep":
        report["layer_check"] = ep_layer_check(cfgs["ep"], env, seed)
    else:
        report["attention_check"] = {
            name: sp_attention_check(name, cfg, env, seed)
            for name, cfg in cfgs.items()}
    with open(os.path.join(out, f"a12_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def _spawn_ranks(rank_flag: str, args: list, n: int, timeout: float,
                 tag: str, result: str, env: dict | None = None) -> list:
    """Start ``n`` processes of this script (``rank_flag r`` and ``args``
    after ``--tp-port`` and ``--tp-out``), wait for them up to
    ``timeout`` seconds, and stop them all when one fails (it leaves the
    others in a collective). Keeps their log in
    ``OUT_DIR/<tag>_ranks.log`` and returns each rank's
    ``<result>_rank<r>.json``."""
    out = tempfile.mkdtemp(prefix=f"{tag}_", dir=os.path.join(REPO, "build"))
    port = free_port()
    log_paths = [os.path.join(out, f"rank{r}.log") for r in range(n)]
    procs = []
    for r in range(n):
        with open(log_paths[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), rank_flag,
                 str(r), *args, "--tp-port", str(port), "--tp-out", out],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env))
    deadline = time.perf_counter() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.perf_counter() > deadline):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = []
    for path in log_paths:
        with open(path) as f:
            logs.append(f.read())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{tag}_ranks.log"), "w") as f:
        f.write("\n".join(logs))
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"{tag}_path: rank {r} exited "
              f"{p.returncode}: {logs[r][-3000:]}")
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"{result}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    return ranks


def _a12_spawn(phase: str, seed: int) -> list:
    """The ``A12_RANKS`` processes of ``phase`` (``a12_rank``)."""
    # Two ranks of ~35 GB each share the card: segments that grow keep
    # the allocator's reserve close to what is allocated.
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    return _spawn_ranks("--a12-rank", ["--seed", str(seed), "--a12-phase",
                                       phase], A12_RANKS, A12_TIMEOUT_S,
                        phase, "a12", env)


def _one_rank_step0(cfg, tweak=None) -> dict:
    """The one-rank step 0 of ``cfg`` on this process (the same seeded
    weights and batch as the ranks', edited by ``tweak``)."""
    run = _a12_run(cfg, 1, {"heads": []}, tweak)
    return {**run["steps"][0],
            "max_memory_allocated_bytes": run["max_memory_allocated_bytes"]}


def _a12_check_steps(what: str, run: dict, per_step: dict, heads: int):
    for s in run["steps"]:
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]),
              f"{what} step {s['step']}: {s}")
        for name, n in s["launches"].items():
            check(n == per_step.get(name, 0),
                  f"{what} step {s['step']}: {name} launched {n} times, "
                  f"want {per_step.get(name, 0)}")
        check(s["heads"] == [heads], f"{what}: flash heads {s['heads']}")
    check(run["fallbacks"] == 0, f"{what}: flash attention fell back")


def ep_phase(seed: int, card: str) -> dict:
    """ep_path: ``gpt2_moe`` at full width over ``expert=2`` (6 layers),
    two gloo processes on the one card, each holding 4 of the 8 experts,
    against the one-rank step (expert=1) on the same seeded weights and
    batch; then the same in fp32 at 2 layers. The ranks agree, their
    step-0 loss and grad_norm are within ``EP_RTOL`` of the one-rank
    step's, B1-B3 launch 2 / 1 / 1 a layer at 16 heads, and one layer
    alone is within ``EP_LAYER_TOL`` of one rank's while its controls
    are not. The control step (the other rank's experts left out of the
    one-rank step: rank 0's output unsummed) is recorded beside it."""
    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides

    cfgs = _a12_configs("ep", seed)
    one = {name: _one_rank_step0(apply_overrides(c, ["mesh.expert=1"]))
           for name, c in cfgs.items()}
    cfg = cfgs["ep"]
    el = cfg.model.moe.num_experts // A12_RANKS

    def unsummed(params):
        for key, p in params.items():
            if key.endswith("moe.wo"):
                p[el:].zero_()

    control = _one_rank_step0(apply_overrides(cfg, ["mesh.expert=1"]),
                              unsummed)
    ranks = _a12_spawn("ep", seed)
    report = {
        "card": card, "config": cfg.name, "mesh": EP_MESH,
        "overrides": EP_OVERRIDES, "backend": ranks[0]["backend"],
        "backend_note": "two gloo processes on one card: every all-reduce "
                        "over expert goes through the host",
        "experts_per_rank": el, "global_batch": cfg.data.global_batch_size,
        "runs": {}}
    for name, c in cfgs.items():
        per_step = {k: v * c.model.num_layers
                    for k, v in _flash_per_layer(2, 1).items()}
        runs = [r["runs"][name] for r in ranks]
        for r, run in enumerate(runs):
            _a12_check_steps(f"ep_path {name} rank {r}", run, per_step,
                             c.model.num_heads)
            check([s["loss"] for s in run["steps"]]
                  == [s["loss"] for s in runs[0]["steps"]],
                  f"ep_path {name}: rank {r}'s losses differ from rank 0's")
        a = runs[0]["steps"][0]
        gaps = {k: _rel(a[k], one[name][k]) for k in ("loss", "grad_norm")}
        for k, gap in gaps.items():
            check(gap <= EP_RTOL[name][k], f"ep_path {name}: step-0 {k} "
                  f"{a[k]} vs one rank {one[name][k]}")
        report["runs"][name] = {
            "layers": c.model.num_layers, "policy": c.precision.policy,
            "losses": [s["loss"] for s in runs[0]["steps"]],
            "aux_losses": [s["aux_loss"] for s in runs[0]["steps"]],
            "one_rank": {k: one[name][k] for k in ("loss", "grad_norm")},
            "rel_vs_one_rank": gaps, "rtol": EP_RTOL[name],
            "grad_norm": a["grad_norm"],
            "flash_launches_per_step": per_step,
            "step_s": [s["step_s"] for s in runs[0]["steps"][1:]],
            "warmup_step_s": a["step_s"],
            "one_rank_step_s": one[name]["step_s"],
            "staged_bytes_per_step": runs[0]["steps"][-1]["staged_bytes"],
            "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                           for r in runs],
            "one_rank_max_memory_allocated_bytes":
                one[name]["max_memory_allocated_bytes"]}
    report["control_unsummed"] = {
        k: {"value": control[k], "rel_vs_one_rank": _rel(control[k],
                                                         one["ep"][k])}
        for k in ("loss", "grad_norm")}
    layer = []
    for rep in ranks:
        lc = rep["layer_check"]
        for k, e in lc["errs"].items():
            check(e <= EP_LAYER_TOL, f"ep_path layer, rank {lc['rank']}: "
                  f"{k} {e} over {EP_LAYER_TOL}")
        for k, e in lc["controls"].items():
            check(e > EP_LAYER_TOL, f"ep_path layer, rank {lc['rank']}: "
                  f"control {k} {e} does not exceed {EP_LAYER_TOL}")
        layer.append(lc)
    report["layer_check"] = {"tol": EP_LAYER_TOL, "ranks": layer}
    return report


def sp_phase(seed: int, card: str) -> dict:
    """sp_path: ``gpt2_ring`` at full width (4 layers), T 8192, over
    ``seq=2`` (two gloo processes on the one card), first ring, then
    Ulysses, against the one-rank flash step on the same seeded weights
    and tokens: step-0 loss and grad_norm within ``SP_RTOL``, and the
    attention alone within ``SP_ATTN_TOL`` while its control is not; per
    rank and layer B1 twice (the recompute) and B2 / B3 once for every
    hop it computes (the ring: rank 0 once, rank 1 twice; Ulysses once
    at 8 heads); the bytes sent over seq at the send equal
    ``a12_bytes``."""
    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides

    cfgs = _a12_configs("sp", seed)
    one = _one_rank_step0(apply_overrides(cfgs["ring"], SP_PLAIN))
    ranks = _a12_spawn("sp", seed)
    m = cfgs["ring"].model
    layers = m.num_layers
    report = {"card": card, "config": cfgs["ring"].name, "mesh": SP_MESH,
              "overrides": SP_OVERRIDES,
              "cuts": {"global_batch": "8 -> 4 (two ranks and the one-rank "
                                       "reference on one card)"},
              "backend": ranks[0]["backend"],
              "backend_note": "two gloo processes on one card: every hop "
                              "and all_to_all is staged through the host",
              "seq_len": m.seq_len, "layers": layers,
              "one_rank_flash_loss": one["loss"],
              "one_rank_step_s": one["step_s"],
              "one_rank_max_memory_allocated_bytes":
                  one["max_memory_allocated_bytes"], "runs": {}}
    for name in SP_RUNS:
        runs = [r["runs"][name] for r in ranks]
        per_rank = {}
        for run in runs:
            r = run["coords"]["seq"]
            hops = r + 1 if name == "ring" else 1
            heads = m.num_heads if name == "ring" else m.num_heads // 2
            per_step = {k: v * layers for k, v in
                        _flash_per_layer(2 * hops, hops).items()}
            _a12_check_steps(f"sp_path {name} rank {r}", run, per_step,
                             heads)
            want = a12_bytes(cfgs[name], r, name)
            for s in run["steps"]:
                got = s["wire_bytes"].get("seq", {})
                check(got == want, f"sp_path {name} rank {r}: bytes {got}, "
                      f"want {want}")
            check([s["loss"] for s in run["steps"]]
                  == [s["loss"] for s in runs[0]["steps"]],
                  f"sp_path {name}: rank {r}'s losses differ")
            per_rank[r] = {
                "flash_launches_per_step": per_step, "heads": heads,
                "bytes_per_step": want,
                "staged_bytes_per_step": run["steps"][-1]["staged_bytes"],
                "step_s": [s["step_s"] for s in run["steps"][1:]],
                "warmup_step_s": run["steps"][0]["step_s"],
                "max_memory_allocated_bytes":
                    run["max_memory_allocated_bytes"]}
        a = runs[0]["steps"][0]
        gaps = {k: _rel(a[k], one[k]) for k in ("loss", "grad_norm")}
        for k, gap in gaps.items():
            check(gap <= SP_RTOL[k], f"sp_path {name}: step-0 {k} {a[k]} "
                  f"vs one-rank flash {one[k]}")
        attn = [rep["attention_check"][name] for rep in ranks]
        for ac in attn:
            for k, e in ac["errs"].items():
                check(e <= SP_ATTN_TOL, f"sp_path {name} attention, rank "
                      f"{ac['rank']}: {k} {e} over {SP_ATTN_TOL}")
            check(max(ac["control"].values()) > SP_ATTN_TOL,
                  f"sp_path {name} attention, rank {ac['rank']}: the "
                  f"control {ac['control']} does not exceed {SP_ATTN_TOL}")
        report["runs"][name] = {
            "losses": [s["loss"] for s in runs[0]["steps"]],
            "rel_vs_one_rank": gaps, "rtol": SP_RTOL,
            "grad_norm": a["grad_norm"],
            "one_rank_grad_norm": one["grad_norm"], "ranks": per_rank,
            "attention_check": {"tol": SP_ATTN_TOL, "ranks": attn}}
    return report


# pp_path: gpt2_pp, gpt2_pp_circular and gpt2_pipeline_mpmd as published
# but for depth: 8 of the 24 layers (cut for elastic_path in the script's
# time limit), 4 stages of 2 (circular: two groups of 1), D 1024, 16
# heads, vocab 50257, T 1024, bf16_mixed, global batch 64 in M = 8
# microbatches, trainer.remat=dots) with model.attention=flash, over
# pipe=4: four gloo processes on the one card, one stage each. A warm-up
# at lr 0, then full lr (warmup 1), PP_STEPS steps each.
PP_RANKS = 4
PP_STEPS = 3
PP_TIMEOUT_S = 600
PP_OVERRIDES = ["model.attention=flash", "optimizer.warmup_steps=1",
                "checkpoint.enabled=false", "model.num_layers=8"]
PP_RUNS = ("gpt2_pp", "gpt2_pp_circular", "gpt2_pipeline_mpmd")
# The one-process run each is held to (mesh.pipe=1, every stage in one
# process): the same recipe; the MPMD backend refuses mesh.pipe=1 (as
# the reference does), and gpt2_pipeline_mpmd is gpt2_pp's function of
# the same params and batches (M = 8, one CE mean a microbatch), so it
# is held to gpt2_pp's.
PP_REFERENCE = {"gpt2_pp": "gpt2_pp", "gpt2_pp_circular": "gpt2_pp_circular",
                "gpt2_pipeline_mpmd": "gpt2_pp"}
# The control: gpt2_pp with stage 2's input cotangent to stage 1 zeroed
# (a broken boundary), two steps. Its first loss equals the sound run's
# (the forward is whole); grad_norm and the params must fail PP_RTOL.
PP_CONTROL_STEPS = 2
# Every step's loss and grad_norm, relative to the one-process run's,
# and the params after the steps, |p - p_ref| / |p_ref - p_0| over the
# whole model (``_pp_gaps``). The stages run the same kernels on the
# same inputs as the one-process run, and only the order of some fp32
# sums differs (the tied embedding's two gradients summed over pipe,
# the norm's squares, the MPMD backward's microbatch order). Read on an
# H100: losses equal at every step, grad_norm 1.4e-7 (MPMD 6.7e-8),
# params 8.2e-10 (MPMD 4.4e-9); the control (a zeroed cotangent): loss
# equal, grad_norm 0.56, params 0.69. At random init the loss cannot
# tell a broken boundary; grad_norm and the params can.
PP_RTOL = {"loss": 1e-6, "grad_norm": 1e-5, "params": 1e-6}
PP_DECODE_NEW = 8


def _pp_configs(seed: int) -> dict:
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )

    ov = PP_OVERRIDES + [f"trainer.seed={seed}"]
    return {name: apply_overrides(get_config(name), ov) for name in PP_RUNS}


def _whole_copy(params: dict) -> dict:
    """A copy of whole params on the card (rank 0 compares there)."""
    return {k: v.detach().float().clone() for k, v in params.items()}


def _pp_run(cfg, steps: int, flash, *, rank0: bool, init=None,
            zero=None, snap_at=None) -> dict:
    """``steps`` steps of ``cfg`` through the ``Trainer`` on this process
    (every stage with mesh.pipe=1, its own with pipe ranks): per step the
    losses, grad_norms, seconds, kernel launches and flash heads, bytes
    sent over pipe and staged; the peak memory, the 1F1B counters, and,
    on rank 0, copies on the card of the whole params after the steps
    (and after ``snap_at`` steps) and of the initial ones (``init``).
    ``zero(frm, to)`` zeroes the matching cotangent handoffs (the
    control)."""
    from frl_distributed_ml_scaffold_tpu_torch.dist import collectives
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    # Rank 0 keeps the references' copies on the card: the peaks below
    # leave them (and this run's own copies) out.
    held = torch.cuda.memory_allocated()
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state()
    lay = trainer.layout
    p0 = _whole_copy(lay.whole_params(state.params)) if init else None
    copies = state_bytes(p0) if init else 0
    if zero is not None:
        bmail = trainer.grad_fn.schedule.bmail
        put = bmail.put

        def zeroed(t, frm, to, *, remote):
            return put(torch.zeros_like(t) if zero(frm, to) else t, frm, to,
                       remote=remote)

        bmail.put = zeroed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fallbacks = fa.flash_attention.fallbacks
    out = []
    for s in range(steps):
        batch = trainer.pipeline.global_batch(s)
        collectives.reset_counters()
        flash["heads"].clear()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out.append({
            "step": s, **{k: float(v) for k, v in met.items()},
            "step_s": wall, "launches": read_launches(),
            "heads": sorted(set(flash["heads"])),
            "wire_bytes": {a: dict(v) for a, v in
                           collectives.wire_bytes.items()},
            "staged_bytes": dict(collectives.staged_bytes)})
        if rank0 and s + 1 == snap_at:
            snap = _whole_copy(lay.whole_params(state.params))
            copies += state_bytes(snap)
    res = {"steps": out,
           "max_memory_allocated_bytes":
               torch.cuda.max_memory_allocated() - held - copies,
           "fallbacks": fa.flash_attention.fallbacks - fallbacks,
           "coords": trainer.env.coords}
    if snap_at:
        res["params_at_snap"] = snap
    runner = getattr(trainer, "_mpmd", None)
    if runner is not None:
        res["peak_live"] = runner.last_peak_live
        res["boundary_bytes"] = runner.last_boundary_bytes
        res["stage_idle_s"] = runner.last_stage_idle_s
    whole = lay.whole_params(state.params)
    if rank0:
        res["params"] = _whole_copy(whole)
        res["p0"] = p0
    del trainer, state, whole
    torch.cuda.empty_cache()
    return res


def _pp_gaps(run: dict, ref: dict) -> dict:
    """Each step's loss and grad_norm relative to the reference's; the
    params' difference over the reference's update, ``|p - p_ref| /
    |p_ref - p_0|`` over the whole model (L2: Adam turns the rounding
    noise of the exact-zero ``attn.key.bias`` gradients into full-size
    updates of either sign, ROADMAP C.7, a handful of elements a norm
    does not see), and the largest element's difference over the largest
    update beside it."""
    gaps = {k: max(_rel(a[k], b[k]) for a, b in zip(run["steps"],
                                                     ref["steps"]))
            for k in ("loss", "grad_norm")}
    diff = upd = 0.0
    dmax = umax = 0.0
    for k, p_ref in ref["params"].items():
        d = (run["params"][k] - p_ref).double()
        u = (p_ref - ref["p0"][k]).double()
        diff += float(d.square().sum())
        upd += float(u.square().sum())
        dmax = max(dmax, float(d.abs().max()))
        umax = max(umax, float(u.abs().max()))
    gaps["params"] = math.sqrt(diff / upd)
    gaps["params_max_element"] = dmax / umax
    return gaps


def pp_decode(params: dict, cfg, seed: int) -> dict:
    """Rank 0's decode of the gathered gpt2_pp params: ``generate`` on
    the pipelined model (its ``stages=1`` twin, B4 24 a decode step)
    against the plain model built from the same state dict."""
    from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
        generate,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    m = cfg.model
    policy = get_policy(cfg.precision.policy)
    gen = torch.Generator().manual_seed(seed + 20)
    prompt = torch.randint(0, m.vocab_size, (4, 16), generator=gen)
    toks, b4 = {}, {}
    for name, model_cfg in (("pipelined", m), ("plain", dataclasses.replace(
            m, pipeline_stages=1))):
        model = GPT(model_cfg, policy, device="cuda")
        model.load_state_dict(params)
        reset_launches()
        toks[name] = generate(model, prompt, max_new_tokens=PP_DECODE_NEW,
                              temperature=0.0, device="cuda").cpu()
        torch.cuda.synchronize()
        b4[name] = read_launches()["decode_attention"]
        del model
    check(torch.equal(toks["pipelined"], toks["plain"]),
          "pp_path decode: the pipelined model's tokens differ from the "
          "plain model's")
    want = m.num_layers * (PP_DECODE_NEW - 1)
    for name, n in b4.items():
        check(n == want, f"pp_path decode: B4 launched {n} times in the "
              f"{name} model's generate, want {want}")
    return {"prompt_shape": list(prompt.shape), "new": PP_DECODE_NEW,
            "decode_attention_launches": b4["pipelined"],
            "plain_decode_attention_launches": b4["plain"],
            "tokens_equal_plain": True,
            "tokens": toks["pipelined"][:, 16:].tolist()}


def pp_rank(rank: int, port: int, out: str, seed: int) -> int:
    """One rank of pp_path (``--a12-rank`` with ``--a12-phase pp``).
    Rank 0 first runs the one-process references (mesh.pipe=1), before
    the group exists; then the four processes join a gloo group and
    train each recipe, then the control; rank 0 holds each run against
    its reference and decodes the gathered gpt2_pp params. Writes
    ``out/a12_rank<rank>.json``."""
    import datetime

    import torch.distributed as dist

    from frl_distributed_ml_scaffold_tpu_torch.config import apply_overrides
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flash = {"heads": []}
    dims = fa._dims

    def watched_dims(q, seq_dim, causal):
        got = dims(q, seq_dim, causal)
        flash["heads"].append(int(got[1]))
        return got

    fa._dims = watched_dims
    cfgs = _pp_configs(seed)
    refs = {}
    if rank == 0:  # ranks 1-3 wait in init_process_group meanwhile
        for name in sorted(set(PP_REFERENCE.values())):
            refs[name] = _pp_run(apply_overrides(cfgs[name], ["mesh.pipe=1"]),
                                 PP_STEPS, flash, rank0=True, init=True,
                                 snap_at=PP_CONTROL_STEPS)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=PP_RANKS, rank=rank,
        timeout=datetime.timedelta(seconds=PP_TIMEOUT_S))
    report = {"rank": rank, "backend": dist.get_backend(), "runs": {}}
    for name in PP_RUNS:
        run = _pp_run(cfgs[name], PP_STEPS, flash, rank0=rank == 0)
        if rank == 0:
            ref = refs[PP_REFERENCE[name]]
            run["gaps"] = _pp_gaps(run, ref)
            run["reference"] = {
                "config": PP_REFERENCE[name],
                "steps": [{k: s[k] for k in ("loss", "grad_norm", "step_s",
                                             "launches")}
                          for s in ref["steps"]],
                "max_memory_allocated_bytes":
                    ref["max_memory_allocated_bytes"],
                "params_checksum": params_checksum(ref["params"])}
            run["params_checksum"] = params_checksum(run["params"])
            if name == "gpt2_pp":
                run["decode"] = pp_decode(run["params"], cfgs[name], seed)
            del run["params"], run["p0"]
        report["runs"][name] = run
    control = _pp_run(cfgs["gpt2_pp"], PP_CONTROL_STEPS, flash,
                      rank0=rank == 0,
                      zero=lambda frm, to: frm == 2 and to == 1)
    if rank == 0:
        ref = refs["gpt2_pp"]
        control["gaps"] = _pp_gaps(control, {
            **ref, "steps": ref["steps"][:PP_CONTROL_STEPS],
            "params": ref["params_at_snap"]})
        del control["params"], control["p0"]
    report["control"] = control
    with open(os.path.join(out, f"a12_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def pp_bytes(cfg, stage: int) -> dict:
    """What pipe rank ``stage`` sends over ``pipe`` in one step of
    ``cfg``, by dtype: each (non-final) output of its ticks and each
    cotangent of an input it received, one bf16 [mb, T, D] block each
    (GPipe: M and M; circular: the ring's v M less the final or first
    repeat's); under MPMD also the embedding mirror (bf16, stage 0) and
    the head's fp32 gradient of it (the last stage)."""
    m = cfg.model
    s, mt = m.pipeline_stages, m.pipeline_microbatches * cfg.trainer.grad_accum
    v = m.pipeline_circular_repeat
    blk = cfg.data.global_batch_size // mt * m.seq_len * m.hidden_dim * 2
    acts = v * mt if stage < s - 1 else (v - 1) * mt
    cots = v * mt if stage > 0 else (v - 1) * mt
    out = {"bfloat16": (acts + cots) * blk}
    if m.pipeline_impl == "mpmd":
        emb = m.vocab_size * m.hidden_dim
        if stage == 0:
            out["bfloat16"] += emb * 2
        if stage == s - 1:
            out["float32"] = emb * 4
    return out


def pp_phase(seed: int, card: str) -> dict:
    """pp_path: the three pipeline recipes over ``pipe=4`` (four gloo
    processes on the one card, ``pp_rank``), each held to its
    one-process run (``PP_REFERENCE``) on every step's loss and grad_norm
    and the params after the steps (``PP_RTOL``), beside the control (a
    zeroed cotangent) that must fail it; per rank and step B1-B3 at 16
    heads (the stage's 2 layers x M = 8: 2 / 1 / 1 a layer and
    microbatch under dots, the MPMD stages' forward then its recompute
    3 / 1 / 1, its last stage 2 / 1 / 1), every other kernel never, no
    fallback, the bytes over pipe at the send equal to ``pp_bytes``, the
    ranks' losses equal; the 1F1B stage peaks; rank 0's decode of the
    gathered gpt2_pp params. The ranks' log goes to
    ``OUT_DIR/pp_ranks.log``."""
    cfgs = _pp_configs(seed)
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    ranks = _spawn_ranks("--a12-rank", ["--seed", str(seed), "--a12-phase",
                                        "pp"], PP_RANKS, PP_TIMEOUT_S, "pp",
                         "a12", env)
    report = {"card": card, "overrides": PP_OVERRIDES,
              "backend": ranks[0]["backend"],
              "backend_note": "four gloo processes on one card: every "
                              "boundary handoff is staged through the host",
              "rtol": PP_RTOL, "runs": {}}
    for name in PP_RUNS:
        c = cfgs[name]
        m = c.model
        mpmd = m.pipeline_impl == "mpmd"
        lps = m.num_layers // m.pipeline_stages
        mt = m.pipeline_microbatches * c.trainer.grad_accum
        runs = [r["runs"][name] for r in ranks]
        per_rank = {}
        for run in runs:
            j = run["coords"]["pipe"]
            fwd = 3 if mpmd and j < m.pipeline_stages - 1 else 2
            per_step = {k: v * lps * mt
                        for k, v in _flash_per_layer(fwd, 1).items()}
            what = f"pp_path {name} rank {j}"
            _a12_check_steps(what, run, per_step, m.num_heads)
            want = pp_bytes(c, j)
            for st in run["steps"]:
                got = st["wire_bytes"].get("pipe", {})
                check(got == want, f"{what}: bytes {got}, want {want}")
            check([st["loss"] for st in run["steps"]]
                  == [st["loss"] for st in runs[0]["steps"]],
                  f"{what}: losses differ from rank 0's")
            per_rank[j] = {
                "flash_launches_per_step": per_step, "bytes_per_step": want,
                "staged_bytes_per_step": run["steps"][-1]["staged_bytes"],
                "step_s": [st["step_s"] for st in run["steps"]],
                "max_memory_allocated_bytes":
                    run["max_memory_allocated_bytes"]}
        r0 = runs[0]
        gaps = r0["gaps"]
        for k, tol in PP_RTOL.items():
            check(gaps[k] <= tol, f"pp_path {name}: {k} gap {gaps[k]} "
                  f"over {tol} against the one-process run")
        entry = {
            "stages": m.pipeline_stages, "microbatches": mt,
            "circular_repeat": m.pipeline_circular_repeat,
            "impl": m.pipeline_impl, "remat": c.trainer.remat,
            "losses": [st["loss"] for st in r0["steps"]],
            "grad_norms": [st["grad_norm"] for st in r0["steps"]],
            "gaps": gaps, "params_checksum": r0["params_checksum"],
            "reference": r0["reference"],
            "step_s_median": statistics.median(
                st["step_s"] for st in r0["steps"][1:]),
            "ranks": per_rank}
        if mpmd:
            s = m.pipeline_stages
            peak = r0["peak_live"]
            check(peak[:-1] == [min(s - j, mt) for j in range(s - 1)]
                  and max(peak) < mt,
                  f"pp_path {name}: 1F1B peaks {peak}")
            entry["peak_live"] = peak
            entry["stage_idle_s"] = r0["stage_idle_s"]
        if "decode" in r0:
            entry["decode"] = r0["decode"]
        report["runs"][name] = entry
    control = ranks[0]["control"]
    check(control["gaps"]["grad_norm"] > PP_RTOL["grad_norm"]
          and control["gaps"]["params"] > PP_RTOL["params"],
          f"pp_path control: a zeroed cotangent passes the gate "
          f"{control['gaps']}")
    report["control"] = {
        "what": "gpt2_pp, stage 2's input cotangent to stage 1 zeroed",
        "steps": PP_CONTROL_STEPS, "gaps": control["gaps"],
        "losses": [st["loss"] for st in control["steps"]],
        "grad_norms": [st["grad_norm"] for st in control["steps"]]}
    report["peak_rank0_gpipe_vs_1f1b_bytes"] = [
        report["runs"]["gpt2_pp"]["ranks"][0]["max_memory_allocated_bytes"],
        report["runs"]["gpt2_pipeline_mpmd"]["ranks"][0][
            "max_memory_allocated_bytes"]]
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # One rank of tp_serve_path (the script starts them itself).
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-out", help=argparse.SUPPRESS)
    # One rank of overlap_path (the script starts them itself).
    ap.add_argument("--overlap-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    # One rank of ep_path / sp_path (the script starts them itself).
    ap.add_argument("--a12-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--a12-phase", choices=("ep", "sp", "pp"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.tp_rank is not None:
        return tp_serve_rank(args.tp_rank, args.tp_port, args.tp_out,
                             args.seed)
    if args.overlap_rank is not None:
        return overlap_rank(args.overlap_rank, args.tp_port, args.tp_out,
                            args.seed)
    if args.a12_rank is not None and args.a12_phase == "pp":
        return pp_rank(args.a12_rank, args.tp_port, args.tp_out, args.seed)
    if args.a12_rank is not None:
        return a12_rank(args.a12_phase, args.a12_rank, args.tp_port,
                        args.tp_out, args.seed)
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_params,
        init_resnet_params,
    )
    from frl_distributed_ml_scaffold_tpu_torch.ops import _build

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(card, flush=True)
    emit("env", {"nvidia_smi": card, "device": torch.cuda.get_device_name(0),
                 "count": torch.cuda.device_count(),
                 "torch": torch.__version__, "cuda": torch.version.cuda,
                 "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    for name, rep in reports.items():
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(rep)
    emit("build", {"seconds": build_s, "sources": _build.sources(),
                   "built_now": sorted(reports),
                   "ptxas": ptxas_summary(reports)})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    seconds = {"build": build_s}

    def timed_phase(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t
        return out

    kern = {"decode_attention": timed_phase("kernel", kernel_phase, gen),
            **timed_phase("paged_kernel", paged_kernel_phase, gen)}
    cfg = get_config("gpt2_medium_serve")
    cfg_int8 = apply_overrides(cfg, INT8_OVERRIDES)
    cfg_fp8 = apply_overrides(cfg, FP8_OVERRIDES)
    # The weights come from the generator as the two phases above leave
    # it, so the paths serve the same model whatever phases follow.
    sd = init_params(cfg.model, gen)
    kern.update(timed_phase("quant_kernel", quant_kernel_phase, gen))
    # Each path runs with every launch count set to 0 just before it;
    # a kernel's count is that of the path that runs it.
    launches = {}
    for key, phase, c in (("path", path_phase, cfg),
                          ("paged_path", paged_path_phase, cfg),
                          ("quant_path", path_phase, cfg_int8),
                          ("quant_paged_path", paged_path_phase, cfg_fp8)):
        report, counts, profile = timed_phase(key, phase, c, sd, args.seed,
                                              card)
        launches.update({k: n for k, n in counts.items() if n})
        emit(key, report)
        emit(key.replace("path", "profile"), profile)
    emit("fp32_check", timed_phase("fp32_check", fp32_phase, cfg, sd,
                                   args.seed))
    emit("fp32_paged_check", timed_phase("fp32_paged_check", fp32_paged_phase,
                                         cfg, sd, args.seed))
    emit("fp32_quant_check", {
        "int8_contiguous_vs_generate": timed_phase(
            "fp32_quant_check_int8", fp32_phase, cfg_int8, sd, args.seed),
        "fp8_e4m3_paged_vs_contiguous": timed_phase(
            "fp32_quant_check_fp8", fp32_paged_phase, cfg_fp8, sd, args.seed),
    })
    # The disaggregated engine, the draft tier and the typed failures:
    # their launch counts are reported in their own lines (the kernels
    # line keeps the paths above).
    emit("disagg_path", timed_phase("disagg_path", disagg_phase, cfg, sd,
                                    args.seed, card))
    emit("draft_path", timed_phase("draft_path", draft_phase, cfg, sd,
                                   args.seed, card))
    emit("serve_faults_check", timed_phase("serve_faults_check",
                                           serve_faults_phase, cfg, sd))
    # Beam search over the same weights: its own launch counts.
    emit("beam_path", timed_phase("beam_path", beam_phase, cfg, sd,
                                  args.seed, card))
    # Tensor-parallel serving: two processes on the card, model=2.
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    emit("tp_serve_path", timed_phase("tp_serve_path", tp_serve_phase,
                                      args.seed, card))
    # The overlap schedule: the rings' low-precision products, then two
    # processes training the overlap recipes on the card.
    emit("lowp_check", timed_phase(
        "lowp_check", lowp_phase,
        torch.Generator(device="cuda").manual_seed(args.seed + 18), card))
    emit("overlap_path", timed_phase("overlap_path", overlap_phase,
                                     args.seed, card))
    # MoE on one card, then expert and sequence parallelism: two
    # processes each on the card.
    emit("moe_path", timed_phase(
        "moe_path", moe_phase,
        torch.Generator(device="cuda").manual_seed(args.seed + 19), card,
        args.seed))
    emit("ep_path", timed_phase("ep_path", ep_phase, args.seed, card))
    emit("sp_path", timed_phase("sp_path", sp_phase, args.seed, card))
    # Pipelines: four processes on the card, one stage each.
    emit("pp_path", timed_phase("pp_path", pp_phase, args.seed, card))
    kern.update(timed_phase("flash_kernel", flash_kernel_phase, gen))
    report, counts, profile = timed_phase("train_path", train_phase, sd, card)
    launches.update({k: n for k, n in counts.items() if n})
    emit("train_path", report)
    train_report = report
    train_step_s = report["step_s_median"]
    adamw_state_bytes = report["opt_state_bytes"]
    emit("train_profile", profile)
    emit("offload_path", timed_phase("offload_path", offload_phase, sd,
                                     card, train_report))
    emit("fp32_train_check", timed_phase("fp32_train_check",
                                         fp32_train_phase, sd))
    # The mesh path on one NCCL rank: train_path again through the
    # layout, the collectives and the mesh's groups.
    emit("nccl_init", {"seconds": timed_phase("nccl_init", nccl_init)})
    try:
        emit("mesh_path", timed_phase("mesh_path", mesh_path_phase, sd,
                                      card, train_report))
    finally:
        nccl_close()
    # The rest of the one-card training surface: gpt2_long end to end
    # under each remat mode, adafactor, the other optimizers, dropout.
    emit("long_path", timed_phase("long_path", long_phase, gen, card))
    emit("adafactor_path", timed_phase("adafactor_path", adafactor_phase, sd,
                                       card, adamw_state_bytes))
    emit("optimizers_check", timed_phase("optimizers_check",
                                         optimizers_phase))
    emit("dropout_check", timed_phase("dropout_check", dropout_phase, sd,
                                      card, train_step_s))
    # The loop through the launcher, as a user runs it: its checkpoints
    # go to a directory of the checkout that git ignores, removed after.
    emit("loop_log", quiet_loop_log())
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="loop_", dir=os.path.join(REPO, "build"))
    try:
        report, _ = timed_phase("loop_path", loop_phase, card, train_step_s,
                                work)
        emit("loop_path", report)
        report = timed_phase("loop_resume_check", loop_resume_phase, work)
        emit("loop_resume_check", report)
        worst = max(report["resume"]["max_abs_diff"].values())
        check(worst <= LOOP_RESUME_TOL,
              f"loop_resume_check: resumed steps 4-6 differ by {worst}")
        emit("mlp_launch", timed_phase("mlp_launch", mlp_launch_phase,
                                       os.path.join(work, "mlp")))
        init_work = os.path.join(work, "init_params")
        os.makedirs(init_work)
        emit("init_params_check", timed_phase(
            "init_params_check", init_params_phase, gen, sd, init_work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # The GPT weights are done with: the ResNet phases' peak memory is
    # their own.
    del sd
    torch.cuda.empty_cache()
    kern.update(timed_phase("bn_kernel", bn_kernel_phase, gen))
    kern.update(timed_phase("adamw_kernel", adamw_kernel_phase, gen))
    rn50_cfg = apply_overrides(get_config("imagenet_rn50_ddp"),
                               RN50_OVERRIDES)
    batches = timed_phase("rn50_data", rn50_batches, rn50_cfg,
                          RN50_STEPS + 2)
    # rn50_path's weights, drawn where rn50_setup would draw them, kept
    # for the mesh path.
    rn50_weights = init_resnet_params(rn50_cfg.model, gen,
                                      in_channels=rn50_cfg.data.channels)
    report, counts, profile = timed_phase(
        "rn50_path", rn50_phase, gen, card, RN50_OVERRIDES, RN50_STEPS,
        batches, True, rn50_weights)
    launches.update({k: counts[k] for k in ("bn_bwd_sums", "bn_bwd_dx")})
    emit("rn50_path", report)
    emit("rn50_profile", profile)
    rn50_report = report
    nccl_init()
    try:
        emit("rn50_mesh_path", timed_phase(
            "rn50_mesh_path", rn50_mesh_phase, gen, card, rn50_weights,
            batches, rn50_report))
    finally:
        nccl_close()
    del rn50_weights
    mesh_work = tempfile.mkdtemp(prefix="mesh_",
                                 dir=os.path.join(REPO, "build"))
    try:
        emit("launch_mesh", timed_phase("launch_mesh", launch_mesh_phase,
                                        mesh_work))
    finally:
        shutil.rmtree(mesh_work, ignore_errors=True)
    report, counts, _ = timed_phase(
        "rn50_adamw_path", rn50_phase, gen, card, RN50_ADAMW_OVERRIDES,
        RN50_ADAMW_STEPS, batches, False)
    launches["fused_adamw"] = counts["fused_adamw"]
    emit("rn50_adamw_path", report)
    emit("fp32_rn50_check", timed_phase("fp32_rn50_check", fp32_rn50_phase,
                                        gen))
    # ViT-B trains on the same synthetic ImageNet batches (the recipes'
    # data sections are the same), already on the card.
    vit_cfg = apply_overrides(get_config("imagenet_vitb_fsdp"),
                              VIT_OVERRIDES)
    check(vit_cfg.data == rn50_cfg.data,
          "imagenet_vitb_fsdp's data differs from imagenet_rn50_ddp's")
    report, _, profile = timed_phase("vit_path", family_phase, vit_cfg, gen,
                                     card, batches, VIT_STEPS, 1)
    emit("vit_path", report)
    emit("vit_profile", profile)
    del batches
    emit("fp32_vit_check", timed_phase("fp32_vit_check", fp32_vit_phase,
                                       gen))
    video_cfg = apply_overrides(get_config("ego4d_video_elastic"),
                                VIDEO_OVERRIDES)
    clips = timed_phase("video_data", family_batches, video_cfg,
                        1 + VIDEO_STEPS)
    report, _, profile = timed_phase("video_path", family_phase, video_cfg,
                                     gen, card, clips, VIDEO_STEPS, 1)
    emit("video_path", report)
    emit("video_profile", profile)
    del clips
    emit("mlp_path", timed_phase("mlp_path", mlp_phase, gen, card))
    # The two scale-up recipes, one step each at a batch one card holds.
    for name in SCALEUP:
        emit(name, timed_phase(name, scaleup_phase, name, gen, card))
    # The loaders, the native data core, the s2d stem and the mask pool:
    # seeded shards and token bins under a temporary directory of build/,
    # removed after.
    data_work = tempfile.mkdtemp(prefix="data_",
                                 dir=os.path.join(REPO, "build"))
    try:
        shard_dir = os.path.join(data_work, "imagenet")
        os.makedirs(shard_dir)
        emit("shards", timed_phase("shards", write_image_shards, shard_dir,
                                   args.seed))
        emit("native_build", timed_phase("native_build", native_phase,
                                         shard_dir, args.seed))
        emit("stem_pool_check", timed_phase("stem_pool_check",
                                            stem_pool_phase, gen))
        emit("rn50_shards_path", timed_phase(
            "rn50_shards_path", rn50_shards_phase, shard_dir,
            os.path.join(data_work, "rn50"), card))
        elastic_report = timed_phase(
            "elastic_path", elastic_phase, shard_dir,
            os.path.join(data_work, "elastic"), card)
        emit("elastic_path", elastic_report)
        sanitize_work = os.path.join(data_work, "sanitize")
        os.makedirs(sanitize_work)
        emit("sanitize_check", timed_phase("sanitize_check", sanitize_phase,
                                           sanitize_work))
        emit("lm_shards_path", timed_phase(
            "lm_shards_path", lm_shards_phase,
            os.path.join(data_work, "lm"), args.seed))
        emit("video_shards_path", timed_phase(
            "video_shards_path", video_shards_phase,
            os.path.join(data_work, "video"), args.seed, card))
    finally:
        shutil.rmtree(data_work, ignore_errors=True)
    # Where the script's time limit goes: each phase (a path's includes
    # its warm-up and profiled window) and the whole of main().
    seconds["main_total"] = time.perf_counter() - start
    emit("phase_seconds", seconds)

    src = "frl_distributed_ml_scaffold_tpu_torch/ops/csrc/"
    ref = "frl_distributed_ml_scaffold_tpu/ops/"
    rows = [("decode_attention", "decode_attention.cu",
             "decode_attention.py:346"),
            ("paged_decode_attention", "paged_attention.cu",
             "decode_attention.py:444"),
            ("paged_verify_attention", "paged_attention.cu",
             "decode_attention.py:545"),
            ("decode_attention_quant", "quant_attention.cu",
             "decode_attention.py:394"),
            ("paged_decode_attention_quant", "quant_attention.cu",
             "decode_attention.py:496"),
            ("paged_verify_attention_quant", "quant_attention.cu",
             "decode_attention.py:599"),
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:100"),
            ("flash_attention_bwd_dq", "flash_attention.cu",
             "flash_attention.py:188"),
            ("flash_attention_bwd_dkv", "flash_attention.cu",
             "flash_attention.py:222"),
            ("bn_bwd_sums", "fused_bn.cu", "fused_bn.py:115"),
            ("bn_bwd_dx", "fused_bn.cu", "fused_bn.py:140"),
            ("fused_adamw", "fused_adamw.cu", "fused_adamw.py:56")]
    emit("kernels", [{
        "name": name,
        "route": "cuda",
        "source": src + cu,
        "replaces": ref + line,
        "launches": launches.get(name, 0),
        "max_abs_err": kern[name]["max_abs_err"],
        "ms": kern[name]["timing"]["ms"],
        "plain_ms": kern[name]["timing"]["plain_ms"],
        "bound_ms": kern[name]["timing"]["bound_ms"],
        "bound_by": kern[name]["timing"]["bound_by"],
        "library_ms": kern[name]["timing"]["library_ms"],
        **({"elastic_path_launches":
            elastic_report["profiled_step_kernels"][name],
            "elastic_path_launches_in": "the restarted child's profiled "
                                        "step (its torch.profiler trace)"}
           if name in ELASTIC_KERNELS else {}),
        **({"bf16_p_max_abs_err": kern[name]["bf16_p"]["max_abs_err"],
            "bf16_p_bit_equal_share":
                kern[name]["bf16_p"]["p_bit_equal_share"],
            "bf16_p_ms": kern[name]["bf16_p"]["ms"],
            "bf16_p_plain_ms": kern[name]["bf16_p"]["plain_ms"],
            "bf16_p_bound_ms": kern[name]["bf16_p"]["bound_ms"],
            "bf16_p_library_ms": kern[name]["bf16_p"]["library_ms"]}
           if "bf16_p" in kern[name] else {}),
    } for name, cu, line in rows])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
