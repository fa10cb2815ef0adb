#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device      — require CUDA; the card's name and power limit (nvidia-smi).
2. build       — compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
                 for sm_90a, one nvcc per source, all at once (into
                 ``build/repro_torch/``), and load the library.
3. parity      — every kernel against its plain PyTorch version on the card
                 (integers bit-equal, floats rtol 1e-5, the bags bit-equal),
                 with three readings of each call (DeviceTimer): ``ms``, the
                 device time with the L2 flushed before each launch (a
                 calibrated spin keeps the device busy while the host
                 enqueues the flush and the call, so the CUDA events
                 bracket device work only), ``ms_enqueued`` (flush, event,
                 call, event: the reading of earlier versions of this
                 script, which holds the host's enqueue whenever it outlasts
                 the flush) and ``host_us`` (the median host time of one
                 call), and ``ahead_share``, the share of device readings
                 the host stayed ahead for: a kernel below 0.5 fails the
                 phase (its ``ms`` would hold host time).  Beside the
                 kernel: the plain version's and the fastest single
                 PyTorch library call's device time where there is one,
                 each with its ``ahead_share`` (a plain version that
                 synchronises inside has 0, and its time holds host work) (for the bags both F.embedding_bag forms: 0/1
                 per-sample weights over clamped ids, and the valid ids flat
                 with offsets), and the bytes/operations bound.  Inputs:
                 one 65536-row synthetic Criteo batch through Pipeline III at
                 vocab 524288 (grouped, optimize="off" and fuse="off" plans)
                 and at vocab 4194304 (its 16 MiB table is HBM-placed, so
                 the sparse output and the fit take the staged kernels).
                 The tables are fitted on the CPU through the plain versions,
                 so no kernel runs before it meets its plain version.  The
                 embedding bags at vocab 524289, dim 128: embedding_bag on
                 65536 x 8 Zipf(1.1) ids with 10 % -1 (the reference
                 bench_embed_cache.py's law and nnz); embedding_bag_cached
                 on a real lookahead plan (the port's planner on the batch
                 above, the lookahead_main config) stacked over its 26
                 features in one launch, as the main path runs it, and on
                 one feature of it (two levels, nnz 1); and the cache-only
                 variant on the first instance's ids with every distinct row
                 staged, which must equal the first instance's output bit
                 for bit.  The stacked launch must also equal the 26
                 single-feature launches stacked, bit for bit, and both are
                 timed.  The dataflow kernels' edge instances
                 (``dataflow_edges``, named ``edge:*``, timed like the rest
                 but never the kernels line's instance): a fit on all-equal
                 ids (one shared-table entry), all-distinct ids (more per
                 tile than the shared table holds) and negative, missing
                 and >= capacity ids; the main path's fit and group at 1,
                 7, 1000 and 65533 rows (tails off 16 bytes); its group with
                 the dense source a row view off a 16-byte boundary; the
                 tile program's byte copy into shared memory off a 4-byte
                 boundary (``edge:byte_copy``: a 1023-column hex output
                 whose tiles hold 2 rows).  The wider plans and dtypes
                 (``extra_instances``, never the kernels line's instance
                 either): ``criteo26_group``, one vocabulary per Criteo
                 feature (Vocab(65536) each: 26 tables, 6.8 MB) in one
                 group launch; ``criteo4_group``, the first four features'
                 (a program within the small struct), and
                 ``criteo4_group:wide``, the same program forced into the
                 wide struct; float16 outputs of the group kernel and of
                 the packer; a bfloat16 embedding bag on the Zipf ids
                 (bit-equal to its plain version, as every bag); the
                 staged build's fill alone (``fill_only``: no ids); and the
                 packer over 26 and over 128 one-column blocks
                 (``pack:26x1``, ``pack:128x1``).  The packer's other
                 instances are the plans': staged_main's sparse output
                 (["sparse"], int32 [B, 26] -> [B, 32]) and the
                 ``fuse="off"`` plan's dense (["dense"], float32 [B, 13] ->
                 [B, 16]) and sparse outputs.
4. main        — EtlJob(Pipeline III, Source.synth("I"), backend="cuda") ->
                 fit (one fit launch per chunk) -> 16 DLRM training steps at
                 DLRMConfig(vocab_size=524289) (1.75 B parameters; one group
                 launch per batch).  The first batch is checked against the
                 numpy oracle.
5. lookahead_main — the same job and model with
                 embed_cache=EmbedCacheConfig(rows=4096, window=4,
                 stage_max=2048, tables=range(26), refresh=True) and
                 train_loop(embed_cache=EmbedCache(...)): every step resolves
                 its 26 features through one embedding_bag_cached launch,
                 which writes the (B, 26, 128) embeddings in place.  Its 16
                 losses must be within rtol 1e-6 of main's; cache hits,
                 staged rows and table fall-through all > 0; two backward
                 passes of the cached lookup on the first planned batch give
                 bit-equal table gradients, equal to the uncached gather's.
6. ungrouped   — the same pipeline with optimize="off" on two batches:
                 three output launches per batch.
7. staged_main — the large-vocabulary path: Pipeline III at vocab 4194304
                 -> fit over 4 chunks (fused_stage + vocab_build_chunk per
                 chunk) -> 16 DLRM steps at facebookresearch/dlrm's Criteo
                 Kaggle width (d_emb 16, bottom MLP 13-512-256-64-16, top MLP
                 512-256-1; 1.75 B parameters), each batch one group launch
                 (dense + label) and fused_stage -> vocab_lookup -> packer
                 for sparse.  First batch against the numpy oracle.
8. staged_off  — vocab 524288 with fuse="off" (the stage-at-a-time
                 baseline) on two batches: staged fit bit-equal to the fused
                 fit, outputs against the numpy oracle, and one batch's apply
                 time grouped vs staged.

9. online_main  — the online continuous-training path at main's width:
                 a producer thread replays 16 Source.synth("I") batches
                 onto an EventBus at 20 events/s, faster than the trainer
                 steps; an OnlineTrainer (repro_torch.online) consumes
                 them through the executor (Pipeline III at vocab 524288,
                 one group launch per batch, on the executor's stream) into
                 16 steps of DLRMConfig(vocab_size=524289), refitting every
                 4 steps over a window of 4 events (fit_incremental: one fit
                 launch per event, on the trainer's stream, swapped in with
                 a version bump), with the freshness shedder on (0.5 s)
                 and every transformed batch traced.  Versions rise by one
                 per refit; each refit's tables equal a numpy merge of the
                 window's plain fit into the previous state, bit for bit;
                 every traced batch equals a fresh compile("cuda") at its
                 version, bit for bit; losses finite; the shedder dropped
                 events and the p95 event age at delivery is in bound.
10. online_ckpt — repro_torch.launch.online.build_service at its default
                 widths (vocab 4096, d_emb 32, B 256) for 16 steps with a
                 checkpoint every 4 (2 kept) and an EmbedCache (refresh;
                 invalidated at every refit): exactly 2 committed
                 checkpoints remain and resume_or_init restores the newest
                 into a fresh model bit for bit.
11. autotune_main — main's EtlJob with autotune=PipelineController([],
                 window_deliveries=2) over 32 batches: the row_tile and
                 fuse knobs swap compiled variants into the running
                 executor (a knob the search left alone by batch 12 is moved
                 there by its own actuator); every delivered batch equals
                 the untuned run's batch of the same index, bit for bit.
                 Then one batch's apply is timed at each declared row_tile
                 (the dataflow kernels' rows per tile beside it).

12. multitenant_main — PipelineManager(total_credits=8): three tenants at
                 B=65536 with weights 2:1:1 (Pipeline I; II at vocab 8192;
                 III at 524288, both fitted on 4 chunks by the fit kernel),
                 8 Source.synth("I") batches each, made beforehand, on
                 their executors' own streams under the weighted transform
                 service; every transformed batch equal to its tenant's
                 plain (CPU) compile (integers bit for bit, floats rtol
                 1e-5); the grants within +-1 of
                 2:1:1 in every window of 4 while all tenants had batches
                 left; then a hot swap of the stateless tenant (Pipeline I
                 at modulus 1024) and 2 more batches each, and one tenant
                 alone: rows/s per tenant, aggregate and solo, each
                 tenant's stream span (timed events on its executor's
                 stream around each transform call: its H2D copies and
                 kernel, and the gaps while the host stages the copies)
                 and, from one more run under torch.profiler, each
                 tenant's device time (its kernels and copies).
13. lm_ckpt     — repro_torch.launch.train at llama3_2_3b's reduced config:
                 a checkpoint at step 4 restores bit for bit, its leaves in
                 the JAX package's TrainState order, and the launcher
                 resumes from it.
14. lm_main     — repro_torch.launch.train.main in process at llama3_2_3b's
                 full width and depth (28 layers, 3.21 B parameters,
                 AdamW, microbatch 2), --batch 8 --seq 1024 --steps 4,
                 fed by lm_token_pipeline on the cuda backend (at seq
                 1024 one output launch per output a batch, as the
                 reference's planner lowers it): parameter count, every
                 batch bit-equal
                 to the plain compile, the first step against one
                 un-microbatched loss and gradient on its batch, finite
                 losses; tok/s, step ms, peak memory, trainer utilization,
                 the stage breakdown and an MFU estimate (6 N tokens / step
                 time / 989 TFLOP/s dense bf16).  On running out of memory
                 it reruns at --seq 512 and says so.

15. moe_ckpt    — lm_ckpt's checks at kimi_k2's reduced config (1 dense and
                 2 MoE layers, a shared expert, top-2; Adafactor with
                 bfloat16 state, microbatch 16): a checkpoint at step 2
                 restored bit for bit in the JAX order (Adafactor's vc / vr
                 after the parameters), resumed to step 4.
16. moe_main    — launch.train.main at mixtral_8x7b's full width, 2 of 32
                 layers (3,164,667,904 matrix parameters; AdamW float32,
                 microbatch 4, fsdp on one device), --batch 8 --seq 1024
                 --steps 4: parameter count, batches, finite losses, the
                 ETL launches; half the first batch un-microbatched against
                 two microbatches with the capacity factor raised to E / k
                 (nothing drops); the first MoE layer on the first
                 microbatch against a float32 loop over the experts' kept
                 pairs, and the share of routed slots dropped per expert;
                 step ms, tok/s, peak memory, an MFU estimate from
                 active_param_count() and one profiled step.
17. adafactor_main — launch.train.main at llama3_405b's full width, 1 of
                 126 layers (7,390,363,648 matrix parameters; Adafactor,
                 bfloat16 parameters, state and accumulation, microbatch
                 8), --batch 8 --seq 1024 --steps 6: parameter count,
                 batches, finite losses, the ETL launches, the state's
                 shapes (the reference's rule on the stacked leaves), one
                 leaf's update on the card against the CPU within one
                 bfloat16 ulp; the state's bytes against AdamW's, step ms,
                 tok/s, peak memory.
18. serve_main  — repro_torch.launch.serve.main in process at llama3_2_3b's
                 full width and depth (28 layers, float32 parameters, bf16
                 compute), --batch 8 --prompt-len 1024 --max-new 128,
                 greedy, its prompts from lm_token_pipeline on the cuda
                 backend (two output launches at 1024): the prompt batch
                 bit-equal to the plain compile; prefill s, decode tok/s and
                 step ms; the cache's bytes against 2 L B len n_kv hd 2
                 (+ pos); the decode step against its HBM bound (parameters
                 as stored plus the cache, over 3.35 TB/s); the GQA
                 repeat's and the weight casts' bytes a step (estimates);
                 one decode step under torch.profiler; a teacher-forced
                 check: one forward over the prompt and 16 generated tokens
                 against prefill + 16 decode steps fed the same tokens,
                 logits within 3e-2 x the largest, and each served token
                 the forward's argmax wherever its top-2 margin exceeds
                 that tolerance.
19. serve_moe   — serve_main's run at mixtral_8x7b's full width, 2 of 32
                 layers, --batch 4 --prompt-len 4064 --max-new 64: a
                 4096-slot ring (the window) that the decode steps wrap;
                 the check (40 tokens, 8 of them past the wrap) runs with
                 the capacity factor raised to E / k on the same
                 parameters (a prefill drops routed slots at 1.25, a decode
                 step of B tokens none) and the forward's expert choices
                 pinned (bf16 near-ties; at most 5 % of rows would choose
                 otherwise).  At 4064 tokens the prompt pipeline lowers to
                 the staged kernels (one fused_stage, two packers).  On
                 running out of memory it reruns at --batch 2 and says so.
20. ssm_main    — mamba2_370m at full width, 4 of 48 layers: the
                 launcher with its preset (AdamW, microbatch 4), --batch 8
                 --seq 1024 --steps 4 (lm_main's checks and readings), then
                 launch.serve.main at serve_main's sizes: the state's bytes
                 against L B ((d_conv - 1) (d_inner + 2 G N) 2 + H N P 4) at
                 every length, decode tok/s against its bound (parameters,
                 the state read and written), one profiled train step and
                 one profiled decode step, and the teacher-forced check at
                 float32 compute on the same parameters (at bf16 the
                 recurrence drifts from the chunked forward over depth:
                 recorded, not asserted).
21. vlm_main    — internvl2_2b at full width and depth (24 layers): the
                 launcher (text only, as the reference's launcher feeds it),
                 --batch 8 --seq 1024 --steps 4; one loss and backward on
                 random_batch with 256 patch embeddings and 768 text tokens
                 (the loss equal to the cross-entropy over the returned
                 logits' text positions, finite gradients); then
                 launch.serve.main --batch 4 --prompt-len 256 --max-new 32
                 (text only: the reference's prefill takes no patches) with
                 the teacher-forced check.
22. hybrid_main — zamba2_2_7b at full width, 9 of 54 Mamba2 layers
                 (one shared attention block applied after every 9: one
                 application; window 4096): the launcher with its preset (AdamW, microbatch 4,
                 full remat), --batch 8 --seq 1024 --steps 4 (two output
                 launches a batch), one profiled step; then
                 launch.serve.main --batch 4 --prompt-len 4096 --max-new
                 128 (the prompt through the staged kernels: one
                 fused_stage, two packers), every decode step past the
                 ring's wrap: the state's bytes (the SSM's, and a ring of
                 min(window, max_len) slots per application) against the
                 formula at two lengths, decode tok/s against its bound
                 (parameters, the SSM state read and written, the rings
                 read), one profiled decode step, and ssm_main's
                 teacher-forced checks (float32 asserted, bf16 a reading).
23. encdec_main — whisper_base at full width and depth (6 + 6 layers,
                 1500 frames).  Both launchers refuse it (no launcher feeds
                 frames, in either package); build_model and random_batch
                 (448 decoder tokens, 1500 frames a row, batch 8) train 4
                 steps with the preset (AdamW, microbatch 1), one profiled
                 step; then 128 greedy tokens from Model.prefill /
                 decode_step over 8 prompts of 64 tokens from the serve
                 launcher's make_prompt_job on the cuda backend (one group
                 launch) and random_batch's frames: the self and cross
                 caches' bytes against their formulas, decode tok/s against
                 its bound, one profiled decode step, prefill + 16 decode
                 steps against decode_train's logits at float32 compute
                 within 1e-4 x the largest (bf16 a reading).

24. dist_main  — ``launch.train --mesh host`` under ``WORLD_SIZE`` on one
                 spawned NCCL rank (the environment torchrun sets):
                 mixtral_8x7b at full width, 1 of 32 layers, its preset
                 (FSDP2 over a data mesh of 1, AdamW, microbatch 4),
                 --batch 8 --seq 1024, 2 steps; the same cut run without a
                 process group first, in this process: losses within
                 LM_CHECK_RTOL["loss"]; every delivered batch the rank's
                 rows of the plain compile's; step ms with and without the
                 group, tok/s, peak GB, one profiled step (idle share, the
                 NCCL kernels' share of busy, FSDP's annotated ranges).
25. dist_kimi  — the same at kimi_k2's full width (d_model 7,168, 64 heads
                 of 112, 8 kv heads, d_ff_expert 2,048, vocab 163,840,
                 bfloat16 parameters, the float32 router), 2 of 61 layers
                 (the leading dense layer and one MoE layer) and 64 of 384
                 experts (top-8 and the shared expert kept), its preset
                 (FSDP2 over a data mesh of 1, Adafactor with bfloat16
                 state and accumulation, microbatch 16), --batch 16 --seq
                 1024, 2 steps: losses within LM_CHECK_RTOL["loss"] of the
                 run without a group, each MoE block's router an FSDP
                 unit of its own in float32 beside its block's bfloat16
                 unit, every batch the plain compile's; step ms with and
                 without the group, peak GB, the Adafactor state's bytes.
26. dist_ranks2 — the same on two spawned ranks sharing the card, gloo over
                 CUDA tensors, at llama3_2_3b's full width, 2 of 28 layers,
                 its preset (replicated parameters, one gradient all-reduce
                 a step, microbatch 2; FSDP2 across gloo ranks runs in
                 dlrm_la_22 and serve_fsdp), 2 steps: each rank's rows, the
                 global losses against one process's, and
                 compressed_psum_mean over the first block's gradients
                 bit-equal card vs CPU.
27. tp_ranks2  — the "model" axis: two spawned ranks sharing the card, gloo
                 over CUDA tensors, ``make_host_mesh(model_axis=2)`` (a
                 (1, 2) mesh): ``launch.train --mesh host`` at
                 llama3_2_3b's full width (12 of 24 heads, 4 of 8 kv heads,
                 4096 of 8192 MLP columns, 64128 of 128256 tied vocabulary
                 rows a rank), 2 of 28 layers, its preset (microbatch 2),
                 --batch 8 --seq 1024, 2 steps; the same cut in this
                 process first: losses within TP_LOSS_RTOL; every batch
                 each rank's rows (the same on both); the leaves held whole
                 bit-equal across the ranks; step ms, tok/s, peak GB a
                 rank, the collectives' bytes a step, one profiled step's
                 idle share.
28. ep_ranks2  — the same at mixtral_8x7b's full width, 1 of 32 layers, 4
                 of 8 experts a rank, its preset (FSDP2 over a data degree
                 of 1, microbatch 4); the drop share of routed slots equal
                 on both ranks and within MOE_FLIP_SHARE of one process's.
29. dlrm_tp2   — DLRMConfig() (vocab 524288: 26 x 524288 x 128 float32
                 tables, 262144 rows a rank) fed by main's ETL
                 (EtlJob(mesh=), B 65536), 2 steps on the (1, 2) mesh
                 against one process: losses within DLRM_TP_RTOL; rows/s,
                 step ms, each rank's table bytes.
30. dlrm_la_22 — lookahead_main's path on four spawned ranks sharing the
                 card, gloo over CUDA tensors, a (2, 2) mesh with FSDP2
                 over the data axes: each rank holds 262144 rows and 64 of
                 the 128 columns of every table (1.74 GB);
                 EtlJob(mesh=, embed_cache=) plans each data shard's
                 32768 rows after place, each rank's EmbedCache holds the
                 whole rows in its range (zero elsewhere) of its own
                 plan, gathered from the data ranks' column shards (the
                 requests all-gathered, the parts reduce-scattered:
                 TRAFFIC["embed_cache_gather"], never the table whole),
                 one stacked embedding_bag_cached launch a step on its
                 row shard, the lookups' parts summed; 2 steps against
                 one process's lookahead path: losses within
                 DLRM_TP_RTOL, the cache's counters equal across the
                 model ranks of each data coordinate, the gather GB a
                 step, step ms, peak GB a rank, one profiled step.  The
                 parity phase holds the kernel on that shape too
                 (``stacked_half_table``: rank 1's half of the tables,
                 cold ids shifted into it, the rest outside).
31. ssm_tp2    — tp_ranks2's method at mamba2_370m's full width (16 of 32
                 heads of 64 and 64 of 128 state entries a rank), 4 of 48
                 layers, its preset (microbatch 4), --batch 8 --seq 1024,
                 2 steps.
32. hybrid_tp2 — the same at zamba2_2_7b's full width, 18 of 54 layers
                 (two applications of the shared block, the only phase
                 with two: both feed its gradients under full remat, and
                 serving writes and reads the second application's ring,
                 split on the model axis), its preset, --seq 256, 2
                 steps; shared_applications in its line.
33. encdec_tp2 — whisper_base at full width and depth (1,500 stub frames)
                 on the (1, 2) mesh: the decoder's tokens from the LM token
                 pipeline (448 a row), the frames from random_batch (no
                 launcher feeds frames), shard_train_step, 2 steps against
                 one process: losses within TP_LOSS_RTOL, the leaves held
                 whole bit-equal across the ranks.
34. serve_fsdp — four spawned ranks sharing the card, gloo over CUDA
                 tensors, a (2, 2) make_host_mesh(model_axis=2),
                 llama3_2_3b at full width, 2 of 28 layers, bfloat16
                 parameters and compute.  First they train as llama3_405b
                 trains (its preset: FSDP2 over the data axes, Adafactor
                 with bfloat16 state, sequence parallelism; microbatch
                 2): ``launch.train --mesh host`` --batch 8 --seq 1024, 2
                 steps from the LM token pipeline on the card, against
                 the same cut in this process: losses within
                 LM_CHECK_RTOL["loss"]; the model axis' traffic a step as
                 its shapes give it (each sequence-sharded entry's
                 backward one reduce-scatter, no whole-sequence
                 all-reduce but the embedding's); each rank's Adafactor
                 state bytes its param_specs share; step ms, peak GB a
                 rank and one profiled step's idle share beside one
                 process's.  Then weight-gathered serving (the serving
                 cells' serve_fsdp): a module from seed 0 through
                 shard_for_serving(fsdp=True) (each parameter's model
                 slice, then its data shard; each block gathered whole
                 over the data axes just before it runs), each data rank
                 its 4 of the 8 prompts of 256 tokens (the LM token
                 pipeline on the card), prefill and 8 decode steps fed
                 one process's greedy tokens (axis_serve): logits within
                 SERVE_TOL x the largest of one process's, the tokens of
                 one data coordinate's ranks identical, each rank's
                 resident parameter bytes its param_specs(fsdp=True)
                 share, its data-group gathers a decode step
                 (tensor_parallel.TRAFFIC) the data-sharded leaves' whole
                 bytes (the tied embedding twice); prefill ms, decode step
                 ms and peak GB a rank beside one process's; then one
                 more prefill (a cache of the prompt's length) counted by
                 hlo_cost.analyze.
35. dryrun     — launch.dryrun in one spawned process on fake CUDA tensors
                 (a fake default group of 256 or 512 ranks, nothing
                 allocated), started before dist_main and tracing on the
                 host while phases 24-34 run (so their readings share the
                 host's cores with it): kimi_k2 train_4k (FSDP2 with its
                 float32 routers in units of their own, Adafactor),
                 llama3_405b prefill_32k (weight-gathered) and
                 mixtral_8x7b decode_32k on 16 x 16,
                 mamba2_370m long_500k on 2 x 16 x 16: per-device GiB
                 (MemTracker's peak), flops, collective bytes and the
                 roofline terms (H100 data-sheet constants), beside the
                 card's name and power limit; then serve_fsdp's cell
                 traced on a fake world of 4 and held to rank 0's real
                 prefill: flops, collective count and bytes and parameter
                 bytes equal, MemTracker's peak beside
                 max_memory_allocated (a reading).

The five model-axis phases (tp_ranks2, ep_ranks2, ssm_tp2, hybrid_tp2,
encdec_tp2) then serve their cut on the same ranks (``axis_serve``): a
module from seed 0 sharded for serving (``shard_for_serving``: the KV
caches split by kv head, the SSM's states by head and channel), bf16
compute, the prompts from the LM token pipeline on the card (batch 8,
prompt 256; whisper's frames from random_batch), prefill and 32 decode
steps fed one process's greedy tokens, its MoE routing pinned to that
process's choices: the logits within SERVE_TOL x the largest of one
process's, the ranks' own greedy tokens identical on both and equal to one
process's wherever its top-2 margin exceeds that bound.  Each phase's
``serve`` holds prefill ms, decode step ms (one process's beside each
rank's) and each rank's HBM bound (its parameters as stored plus its
cache shard over HBM_BYTES_PER_S) and its share; the prompt jobs' dataflow
launches count in the phase's ``launches``.

Every phase line carries ``elapsed_s``, the seconds since the script
started.  Then the ``{"kernels": [...]}`` line (``launches_online_main``,
``launches_multitenant_main``, ``launches_lm_main``, ``launches_moe_ckpt``,
``launches_moe_main``, ``launches_adafactor_main``, ``launches_serve_main``,
``launches_serve_moe``, ``launches_ssm_main``, ``launches_vlm_main``,
``launches_hybrid_main``, ``launches_encdec_main``, ``launches_dist_main``,
``launches_dist_kimi``, ``launches_dist_ranks2``, ``launches_tp_ranks2``,
``launches_ep_ranks2``, ``launches_dlrm_tp2``, ``launches_dlrm_la_22``,
``launches_ssm_tp2``, ``launches_hybrid_tp2``, ``launches_encdec_tp2`` and
``launches_serve_fsdp`` (its four ranks' training and prompt jobs) (every
rank's; ``launches_<phase>_per_rank`` beside the ``*_tp2`` and
``dlrm_la_22`` phases') beside the
kernels those phases ran), the nvidia-smi line, and last the
``{"ok": true, "device": ...}`` line.

    python3 chip_smoke.py --wrappers DIR

builds the parity phase's instances from the checkout at DIR (its
``src/repro_torch``, built there) and times each instance's kernel wrapper
with the same timer, skipping a wrapper the checkout lacks, then the
forward of ``cached_embedding_lookup`` over the same lookahead plan, and
``floor``, a one-element torch op (what the timer reads for a launch that
does nothing): no plain versions, library calls or paths.  One JSON line each, with the
launches per call and a checksum of the output, so two checkouts (a parent
and its change) compare in one process each, on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B = 65536                     # rows per batch (paper_pipeline default)
LARGE_VOCAB = 4194304         # 16 MiB table: over the 4 MiB VMEM budget
DLRM_VOCAB = 524289          # DLRMConfig default d_emb 128 tables
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM, outside the tensor cores
REPEATS = 20
AHEAD_FLOOR = 0.5  # least ahead_share a kernel's device reading may have
SOURCES = {"group_dataflow": "dataflow.cu", "output_dataflow": "dataflow.cu",
           "fit_dataflow": "dataflow.cu", "fused_stage": "stage.cu",
           "packer": "stage.cu", "vocab_build_chunk": "vocab.cu",
           "vocab_lookup": "vocab.cu", "embedding_bag": "embedding_bag.cu",
           "embedding_bag_cached": "embedding_bag.cu"}
REPLACES = {"group_dataflow": "src/repro/kernels/dataflow.py:367",
            "output_dataflow": "src/repro/kernels/dataflow.py:299",
            "fit_dataflow": "src/repro/kernels/dataflow.py:440",
            "fused_stage": "src/repro/kernels/dataflow.py:93",
            "packer": "src/repro/kernels/dataflow.py:149",
            "vocab_build_chunk": "src/repro/kernels/vocab.py:86",
            "vocab_lookup": "src/repro/kernels/vocab.py:137",
            "embedding_bag": "src/repro/kernels/embedding_bag.py:113",
            "embedding_bag_cached": "src/repro/kernels/embedding_bag.py:187"}
# the instance the kernels line reports where the main path fixes one
PATH_INSTANCE = {"embedding_bag_cached": "stacked_plan"}
EDGE_ROWS = (1, 7, 1000, 65533)  # tail tiles that are not 16-byte multiples
DISTINCT_ROWS = 16384            # 425,984 distinct ids under capacity 524288
CRITEO_VOCAB = 65536             # per-feature vocabularies of criteo*_group
BYTE_COPY_COLS, BYTE_COPY_ROWS = 1023, 4096  # 2-row tiles, planes off 4 B
# instances that never stand for a kernel in the kernels line
EXTRA = ("stacked_half_table", "criteo26_group", "criteo4_group",
         "criteo4_group:wide",
         "out:float16", "bag:bfloat16", "fill_only", "pack:26x1",
         "pack:128x1")
ONLINE_STALENESS_S = 0.5  # online_main's shedder: event age at delivery
ONLINE_RATE_HZ = 20.0     # online_main's producer: ~4x the trainer's steps/s
LM_ARCH = "llama3_2_3b"
# lm_main, moe_main, ssm_main: 4 steps (the first compiles and warms the
# allocator; the median of the rest is the reading) keep the script inside
# its time limit
LM_BATCH, LM_SEQ, LM_STEPS = 8, 1024, 4
LM_OOM_SEQ = 512          # lm_main's --seq if the card runs out at LM_SEQ
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
# un-microbatched vs microbatched step on one batch, bf16 compute: the two
# split the GEMMs' rows differently, so sums round differently
LM_CHECK_RTOL = {"loss": 2e-3, "grad_norm": 2e-2}
MT_BATCHES = 8            # multitenant_main's batches per tenant
MOE_ARCH, MOE_LAYERS = "mixtral_8x7b", 2  # of 32: 3 layers would need 74 GB
# moe_main: the first MoE layer (bf16 compute) against a float32 loop over
# the experts, max abs error over the loop's largest magnitude (the LM
# tests' bf16 logits tolerance)
MOE_LOOP_TOL = 3e-2
AF_ARCH, AF_LAYERS, AF_STEPS = "llama3_405b", 1, 6  # 1 of 126 layers
AF_LEAF = "blocks/attn/wk"  # adafactor_main's leaf updated card vs CPU
MOE_CKPT_ARCH = "kimi_k2"  # moe_ckpt: MoE + shared expert + Adafactor
SERVE_ARCH = "llama3_2_3b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 1024, 128
SERVE_CHECK = 16          # generated tokens in the teacher-forced check
SERVE_TOL = 3e-2          # decode vs forward: the LM tests' bf16 tolerance
# serve_moe: 4064 + 64 tokens against mixtral's 4096-token window, so the
# ring wraps; its check runs 40 tokens, 8 of them past the wrap
SERVE_MOE_BATCH, SERVE_MOE_PROMPT, SERVE_MOE_NEW = 4, 4064, 64
SERVE_MOE_CHECK = 40
# teacher-forced MoE checks: share of routed rows whose own expert choice
# may differ from the forward's (bf16 near-ties; the card tests' bound)
MOE_FLIP_SHARE = 0.05
SSM_ARCH = "mamba2_370m"
VLM_ARCH, VLM_STEPS = "internvl2_2b", 4
VLM_SERVE_BATCH, VLM_PROMPT, VLM_NEW = 4, 256, 32
HYBRID_ARCH, HYBRID_STEPS = "zamba2_2_7b", 4
# 4096 + 128 = 33 SSD chunks of 128 (the teacher-forced forward runs whole
# chunks); every decode step is past the 4096-token window
HYBRID_SERVE_BATCH, HYBRID_PROMPT, HYBRID_NEW = 4, 4096, 128
# the script's time limit (1,200 s): ssm_main and hybrid_main train and
# serve a depth cut (at full depth they took 146 s and 179 s); hybrid_main
# applies its shared block once, hybrid_tp2 twice
SSM_MAIN_LAYERS, HYBRID_MAIN_LAYERS = 4, 9
ENCDEC_ARCH, ENCDEC_STEPS = "whisper_base", 4
ENCDEC_SEQ = 448          # Whisper's decoder context
ENCDEC_SERVE_BATCH, ENCDEC_PROMPT, ENCDEC_NEW = 8, 64, 128
FORCED_F32_TOL = 1e-4     # float32 teacher-forced checks: the LM tests' bound
# dist_main: mixtral_8x7b on one NCCL rank, 1 of 32 layers (FSDP2's
# unsharded copy sits beside moe_main's 2-layer state).  The phases on
# ranks take 2 steps (the first compiles, the second is the reading;
# each gloo step is seconds of host copies), for the script's time limit
DIST_ARCH, DIST_LAYERS, DIST_STEPS = "mixtral_8x7b", 1, 2
# dist_kimi: kimi_k2 at full width on one NCCL rank, 2 of 61 layers (the
# leading dense layer and one MoE layer) and 64 of its 384 experts (top-8
# and the shared expert kept): with all 384, one MoE layer's bf16 weights
# and gradients alone take ~68 GB.  Its preset's batch is the microbatch
# count, 16 rows of 1,024 tokens
KIMI_ARCH, KIMI_LAYERS, KIMI_EXPERTS, KIMI_STEPS = "kimi_k2", 2, 64, 2
KIMI_BATCH = 16
# dist_ranks2: llama3_2_3b on two gloo ranks sharing the card
DIST2_ARCH, DIST2_LAYERS, DIST2_STEPS = "llama3_2_3b", 2, 2
# the "model" axis: two gloo ranks sharing the card on a (1, 2) mesh
TP_ARCH, TP_LAYERS, TP_STEPS = "llama3_2_3b", 2, 2       # tp_ranks2
EP_ARCH, EP_LAYERS, EP_STEPS = "mixtral_8x7b", 1, 2      # ep_ranks2
DLRM_TP_STEPS, DLRM_TP_FIT = 2, 2                       # dlrm_tp2
# dlrm_la_22: four gloo ranks sharing the card, a (2, 2) mesh, FSDP.  A
# rank's step peaks at 17.65 GB allocated (NVIDIA H100 80GB HBM3): each
# rank's allocator is held under 19.5 GB, so that four of them and the
# processes' contexts fit the card
DLRM_LA_22_STEPS, DLRM_LA_22_RANK_GB = 2, 19.5
# the model axis for the SSM, hybrid and enc-dec families: mamba2_370m at
# 4 of 48 layers, zamba2_2_7b at 18 of 54 (two applications of the shared
# block: their gradients meet in one set of parameters under full remat,
# and serving reads the second application's ring, split on the model
# axis), whisper_base whole
SSM_TP_LAYERS, SSM_TP_STEPS = 4, 2                      # ssm_tp2
# hybrid_tp2 at seq 256 (512 until its ranks' steps set the script's end)
HYBRID_TP_LAYERS, HYBRID_TP_STEPS, HYBRID_TP_SEQ = 18, 2, 256
ENCDEC_TP_STEPS = 2                                     # encdec_tp2
# serving on the model axis inside the *_tp2 / *_ranks2 phases' ranks: the
# prompts from the LM token pipeline, greedy, bf16 compute
AXIS_SERVE_BATCH, AXIS_SERVE_PROMPT, AXIS_SERVE_NEW = 8, 256, 32
AXIS_F32_NEW = 8          # the SSM families' float32 serving check's steps
# two model ranks vs one process: bf16 compute sums the row-parallel
# products' halves in another order.  DLRM is float32, but its column
# halves and their summed input gradients round differently from the
# whole products, and 16 Adam steps grow that: within 2e-7 over the first
# 8 steps, 1.8e-5 by step 15 (NVIDIA H100 80GB HBM3, 700 W)
TP_LOSS_RTOL, DLRM_TP_RTOL = 5e-3, 1e-4
DLRM_TP_VOCAB = 524288    # DLRMConfig()'s: even, so the rows split
# weight-gathered serving: llama3_2_3b at full width, 2 of 28 layers,
# bfloat16 parameters (as the serving cells' llama3_405b and kimi_k2 hold
# theirs; every decode step gathers them over the data axes, through the
# host under gloo), on four gloo ranks sharing the card, a (2, 2) mesh
SERVE_FSDP_ARCH, SERVE_FSDP_LAYERS = "llama3_2_3b", 2
# serve_fsdp's ranks first train as llama3_405b trains (FSDP, Adafactor,
# sequence parallelism), 2 steps of 2 microbatches; its decode steps cut
# to 8 (a weight-gathered step is ~1.2 s of gathers through the host)
SERVE_FSDP_STEPS, SERVE_FSDP_MICRO, SERVE_FSDP_NEW = 2, 2, 8
# the dry run's production cells: (arch, shape, multi-pod).  kimi_k2
# train_4k (FSDP2 with float32 routers in units of their own, Adafactor,
# 16 microbatches) takes the place of llama3_2_3b train_4k, the one other
# train cell: its trace takes minutes on the host, so the dry run's
# process starts before the distribution phases and traces beside them
DRYRUN_CELLS = (("kimi_k2", "train_4k", False),
                ("llama3_405b", "prefill_32k", False),
                ("mixtral_8x7b", "decode_32k", False),
                ("mamba2_370m", "long_500k", True))


def pipeline_iii_dense_as(Pipeline, Schema, ops, Vocab, dtype):
    """Pipeline III at vocab 524288 with its dense output in ``dtype``."""
    import numpy as np
    p = Pipeline(Schema.criteo_kaggle(), name="pipeline_III_dense_dtype",
                 batch_size=B)
    d = (p.dense("dense_*") | ops.FillMissing(0.0) | ops.Clamp(0.0)
         | ops.Logarithm())
    s = (p.sparse("sparse_*") | ops.Hex2Int(8) | ops.Modulus(524288)
         | Vocab(524288))
    p.output("dense", [d], dtype=dtype, pad_cols_to=16)
    p.output("sparse", [s], dtype=np.int32, pad_cols_to=32)
    p.output("label", [p.label("label")], dtype=np.float32, squeeze=True)
    return p


def byte_copy_instance(df, core_ops):
    """``(kernel, "edge:byte_copy", runner, args)``: Hex2Int | Modulus over
    a 1023-column hex source into one int32 output.  A row needs so much
    shared memory that a tile holds 2 rows, so digit plane d of a tile lies
    2046 * d bytes into its stage: off a 4-byte boundary for odd d, the one
    case the kernel copies byte by byte."""
    import numpy as np
    import torch
    w = BYTE_COPY_COLS
    fn = df.make_output_dataflow(
        [df.StreamInput("h", w, np.dtype(np.uint8), 8)], (),
        [df.TileStep("map", "v", ("h",),
                     (core_ops.Hex2Int(8), core_ops.Modulus(1 << 20)))],
        [("v", w)], np.int32)
    tile = fn.program.tile_rows()
    if tile >= 4 or (tile * w) % 4 == 0:
        raise AssertionError(f"byte_copy: {tile}-row tiles reach no byte copy")
    rng = np.random.default_rng(17)
    vals = rng.integers(0, 1 << 32, size=(BYTE_COPY_ROWS, w), dtype=np.uint64)
    raw = hex_planes(vals.astype(np.uint32), rng.random(vals.shape) < 0.05)
    return ("output_dataflow", "edge:byte_copy", fn,
            [torch.tensor(raw, device="cuda")])


def hex_planes(vals, missing=None):
    """uint32 [rows, width] -> digit-major ASCII hex uint8 [8, rows, width];
    ``missing`` entries become all-zero strings."""
    import numpy as np
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    shifts = np.arange(28, -4, -4, dtype=np.uint64)
    planes = digits[(vals.astype(np.uint64)[None] >> shifts[:, None, None])
                    & 15]
    if missing is not None:
        planes[:, missing] = 0
    return np.ascontiguousarray(planes)


def dataflow_edges(df, core_ops, Source, grouped, raw) -> list:
    """Edge instances of the dataflow kernels, ``(kernel, "edge:...",
    runner, args)``: Hex2Int straight into a fit at capacity 524288 on
    every value equal (one shared-table entry), every value distinct (more
    per tile than the shared table holds: the probe-overflow path) and
    negative, missing and >= capacity values; the main path's fit and group
    at row counts whose tail tiles are not 16-byte multiples; its group
    with the dense source a contiguous row view off a 16-byte boundary."""
    import numpy as np
    import torch
    width, cap = 26, 524288
    fit = df.make_fit_dataflow(
        [df.StreamInput("h", width, np.dtype(np.uint8), 8)],
        [df.TileStep("map", "v", ("h",), (core_ops.Hex2Int(8),))], "v", cap)
    rng = np.random.default_rng(5)
    vals = rng.integers(0, cap, size=(B, width)).astype(np.uint32)
    pick = rng.random((B, width))
    neg, big = pick < 0.2, (pick >= 0.2) & (pick < 0.4)
    vals[neg] = rng.integers(0x80000000, 0xFFFFFFFF, size=int(neg.sum()),
                             dtype=np.uint32)
    vals[big] = rng.integers(cap, 1 << 30, size=int(big.sum()),
                             dtype=np.uint32)
    hexes = {"all_equal": hex_planes(np.full((B, width), 0x1ABC, np.uint32)),
             "all_distinct": hex_planes(np.arange(
                 DISTINCT_ROWS * width, dtype=np.uint32).reshape(-1, width)),
             "out_of_range": hex_planes(vals, rng.random((B, width)) < 0.1)}
    out = [("fit_dataflow", "edge:" + k, fit, [torch.tensor(h, device="cuda")])
           for k, h in hexes.items()]
    for n in EDGE_ROWS:
        raw_n = next(iter(Source.synth("I", rows=n, batch_size=n, seed=13)))
        for phase in ("fit", "apply"):
            out += [(k, f"edge:rows_{n}", fn, args)
                    for k, _, fn, args in grouped.dataflow_launches(raw_n,
                                                                    phase)]
    ((kname, _, fn, args),) = grouped.dataflow_launches(raw, "apply")
    (i,) = [i for i, s in enumerate(fn.program.slots[:fn.program.n_src])
            if s.kind == df.KIND_F32 and s.width == 13]
    buf = torch.empty(args[i].shape[0] + 1, 13, device="cuda")
    buf[1:] = args[i]
    args = list(args)
    args[i] = buf[1:]  # contiguous, 52 B past a 16-byte boundary
    if not args[i].is_contiguous() or args[i].data_ptr() % 16 == 0:
        raise AssertionError("the dense view is not off a 16-byte boundary")
    out.append((kname, "edge:dense_off_16B", fn, args))
    return out


def online_main(tmpl, state0, expect) -> dict:
    """The online path at main's width: a producer thread replays 16
    ``Source.synth("I")`` batches, made before it starts, onto an
    ``EventBus`` at ``ONLINE_RATE_HZ``, faster than the trainer takes them;
    an ``OnlineTrainer`` runs 16 DLRM steps (vocab 524289, d_emb 128) with a
    refit every 4 steps over a window of 4 events, the shedder on at
    ``ONLINE_STALENESS_S`` and every transformed batch traced.  Checks:
    versions rise by one per refit; each refit's tables are the numpy merge
    of its window's plain fit into the previous state, bit for bit; every
    traced batch (shed ones too) is bit-equal to a fresh compile("cuda") at
    its version; losses finite; the shedder dropped events (each counted in
    ``dropped_stale``) and the p95 event age at delivery is within the
    bound; one group launch per transformed batch and one fit launch per
    window event.  The drop order is reported, not held: the shedder drops
    the oldest *visible* event, and one in a stage's hands is not."""
    import threading

    import numpy as np
    import torch
    import torch_parity  # the numpy merge, apart from the port's
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.source import Source
    from repro_torch.kernels import dataflow as df
    from repro_torch.models import dlrm
    from repro_torch.online import EventBus, OnlineConfig, OnlineTrainer, replay
    from repro_torch.session import EtlJob
    from repro_torch.training.train_loop import TrainState, make_train_step

    bus = EventBus(capacity=64)
    job = EtlJob(tmpl, Source.events(bus, "events"), backend="cuda",
                 name="online")
    compiled = job.compiled
    compiled.state = state0  # fitted through the plain versions above
    refits: list = []
    fit_incremental = compiled.fit_incremental

    def recording(batch_iter):
        window, prev = list(batch_iter), compiled.state
        t0 = time.perf_counter()
        new = fit_incremental(iter(window))
        torch.cuda.synchronize()
        refits.append((prev, window, new, time.perf_counter() - t0))
        return new
    compiled.fit_incremental = recording

    cfg = dlrm.DLRMConfig(vocab_size=DLRM_VOCAB)
    model = dlrm.DLRM(cfg, generator=torch.Generator(device="cuda")
                      .manual_seed(0))
    tcfg = TrainConfig(lr=1e-3)
    step = make_train_step(dlrm.loss_fn, tcfg)
    losses: list = []

    def step_fn(st, batch):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        return st, m

    n_steps = 16
    ocfg = OnlineConfig(refit_every=4, window_batches=4,
                        shed_max_staleness_s=ONLINE_STALENESS_S,
                        get_timeout_s=0.5)
    tr = OnlineTrainer(job, TrainState.create(model, tcfg), step_fn, ocfg,
                       bus=bus, topic="events", trace_batches=256)
    stop = threading.Event()
    feed = list(Source.synth("I", rows=16 * B, batch_size=B, seed=100))

    def producer():
        try:
            replay(bus, "events", itertools.cycle(feed),
                   rate_hz=ONLINE_RATE_HZ, stop=stop)
        finally:
            bus.close()

    thread = threading.Thread(target=producer, name="online-producer")
    df.reset_launch_counts()
    t0 = time.perf_counter()
    thread.start()
    try:
        tr.run(max_steps=n_steps, deadline_s=300.0)
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join(timeout=60.0)
    wall = time.perf_counter() - t0
    launches = dict(df.LAUNCHES)
    if thread.is_alive():
        raise AssertionError("online_main: the producer did not stop")
    st = tr.stats
    # kernel calls of the job's program, launched or not: every transformed
    # batch (one a stopped executor dropped too) and every window event
    transformed = compiled.dataflow_calls["apply"]
    expect(launches, {"group_dataflow": transformed,
                      "fit_dataflow": st.refit_batches}, "online_main")
    if transformed < n_steps or compiled.dataflow_calls["fit"] != \
            st.refit_batches:
        raise AssertionError(f"online_main: calls {compiled.dataflow_calls}")
    if st.steps != n_steps or len(losses) != n_steps or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"online_main: {st.steps} steps, losses {losses}")
    v0 = state0.version
    if st.versions != list(range(v0 + 1, v0 + 1 + st.swaps)) or \
            st.swaps + st.refit_skipped != n_steps // 4 or st.swaps < 3:
        raise AssertionError(f"online_main: versions {st.versions}, "
                             f"{st.refit_skipped} refits skipped")
    plain = tmpl.compile("cuda", device="cpu")
    for prev, window, new, _ in refits:
        tables, n_unique = torch_parity.merge_refit(
            prev, plain._fit_tables(iter(window))[0])
        if new.n_unique != n_unique or new.version != prev.version + 1:
            raise AssertionError(f"refit to v{new.version}: n_unique "
                                 f"{new.n_unique}, merge {n_unique}")
        for vid, t in tables.items():
            np.testing.assert_array_equal(new.tables[vid], t,
                                          err_msg=f"refit v{new.version}")
    pct, shed = tr.staleness_percentiles(), tr.shed_stats()
    dropped_stale = tr.executor.stats.dropped_stale
    if shed.dropped < 1 or dropped_stale < shed.dropped or \
            not pct["p95"] <= ONLINE_STALENESS_S:
        raise AssertionError(f"online_main: shed {shed.dropped}, "
                             f"dropped_stale {dropped_stale}, p95 event age "
                             f"{pct['p95']} s (bound {ONLINE_STALENESS_S})")
    arrivals = list(shed.dropped_arrivals)
    inversions = sum(a < max(arrivals[:i])
                     for i, a in enumerate(arrivals) if i)
    fresh: dict = {}
    traced = list(tr.trace)
    if len(traced) != min(transformed, 256):
        raise AssertionError(f"online_main: {len(traced)} traced of "
                             f"{transformed} transformed")
    for version, raw, packed in traced:
        if version not in fresh:
            fresh[version] = tmpl.compile("cuda")
            fresh[version].state = tr.state_history[version]
        for k, v in fresh[version](raw).items():
            if not np.array_equal(packed[k], v.cpu().numpy()):
                raise AssertionError(f"online_main: a batch at v{version} "
                                     f"differs from a fresh compile ({k})")
    out = {"steps": st.steps, "swaps": st.swaps,
           "refit_skipped": st.refit_skipped, "versions": st.versions,
           "refit_batches": st.refit_batches,
           "refit_seconds": [r[3] for r in refits],
           "traced": len(traced),
           "traced_versions": sorted({v for v, _, _ in traced}),
           "transformed": transformed,
           "shed": shed.dropped, "dropped_stale": dropped_stale,
           "max_age_at_drop_s": shed.max_age_at_drop_s,
           "drop_order_inversions": inversions,
           "producer_rate_hz": ONLINE_RATE_HZ,
           "staleness_bound_s": ONLINE_STALENESS_S,
           "staleness_p50_s": pct["p50"], "staleness_p95_s": pct["p95"],
           "wall_seconds": wall, "rows_per_s": st.steps * B / wall,
           "launches": launches, "losses": losses,
           "params": cfg.param_count(), "bus": bus.counts()}
    del tr, model, job, compiled, plain, fresh, traced, refits, feed
    torch.cuda.empty_cache()
    return out


def online_ckpt(root: str, expect) -> dict:
    """``repro_torch.launch.online.build_service`` at its default widths
    (vocab 4096, d_emb 32, B 256) with checkpoints every 4 steps (2 kept)
    and an EmbedCache (refresh, invalidated at every refit) for 16 steps:
    exactly 2 committed checkpoints remain, and ``resume_or_init`` restores
    the newest into a fresh model bit for bit."""
    import shutil
    import threading

    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import dataflow as df
    from repro_torch.launch.online import build_parser, build_service
    from repro_torch.models import dlrm
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training.train_loop import TrainState, resume_or_init

    d = os.path.join(root, "build", "online_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    args = build_parser().parse_args([
        "--duration", "120", "--steps", "16", "--refit-every", "4",
        "--refit-window", "4", "--checkpoint-every", "4", "--keep-ckpts",
        "2", "--ckpt-dir", d, "--embed-cache-rows", "64", "--log-every", "0",
        "--shed-max-staleness", "2.0"])
    trainer, bus, producer = build_service(args)
    thread = threading.Thread(target=producer, name="online-producer")
    df.reset_launch_counts()
    thread.start()
    try:
        trainer.run(max_steps=args.steps, deadline_s=300.0)
        torch.cuda.synchronize()
    finally:
        producer.stop.set()
        thread.join(timeout=60.0)
    launches = dict(df.LAUNCHES)
    st = trainer.stats
    expect(launches, {"group_dataflow":
                      trainer.job.compiled.dataflow_calls["apply"],
                      "fit_dataflow": st.refit_batches,
                      "embedding_bag_cached": st.steps}, "online_ckpt")
    committed = sorted(int(p.split("_")[1]) for p in os.listdir(d)
                       if os.path.exists(os.path.join(d, p, "COMMITTED")))
    if st.steps != 16 or committed != [12, 16] or st.swaps < 1 or \
            trainer.embed_cache.generation != st.swaps:
        raise AssertionError(f"online_ckpt: {st.steps} steps, checkpoints "
                             f"{committed}, swaps {st.swaps}, cache "
                             f"generation {trainer.embed_cache.generation}")
    model = trainer.state.model
    tcfg = TrainConfig(lr=1e-3)
    restored = resume_or_init(lambda: TrainState.create(dlrm.DLRM(
        model.cfg, generator=torch.Generator(device="cuda").manual_seed(99)),
        tcfg), d)
    want = dlrm.state_to_jax_leaves(trainer.state)
    got = dlrm.state_to_jax_leaves(restored)
    equal = restored.step == trainer.state.step and all(
        torch.equal(a, b) for a, b in zip(want, got))
    if not equal:
        raise AssertionError("online_ckpt: the restored state differs")
    out = {"steps": st.steps, "swaps": st.swaps, "versions": st.versions,
           "checkpoints_written": st.checkpoints, "committed": committed,
           "latest": ckpt_lib.latest_step(d), "leaves": len(got),
           "restored_bit_equal": equal,
           "cache_generation": trainer.embed_cache.generation,
           "params": model.cfg.param_count(), "launches": launches}
    shutil.rmtree(d, ignore_errors=True)
    return out


def autotune_main(tmpl, state0, expect, n_batches: int = 32) -> dict:
    """Main's EtlJob with ``autotune=PipelineController([],
    window_deliveries=2)`` over 32 batches against the same job without it:
    every delivered batch bit-equal to the untuned run's batch of the same
    index.  A compile-time knob the search did not move by batch 12 is
    moved there by its own actuator (row_tile to another declared
    candidate, fuse off), so ``swap_pipeline`` runs on the card.  Every
    declared row_tile runs its dataflow kernels at rows per tile of its
    own; one batch's apply is timed at each (the base first and last)."""
    import numpy as np
    from repro_torch.data.source import Source
    from repro_torch.etl_runtime.controller import PipelineController
    from repro_torch.kernels import dataflow as df
    from repro_torch.session import EtlJob

    def run(ctl):
        job = EtlJob(tmpl, Source.synth("I", rows=n_batches * B,
                                        batch_size=B, seed=13),
                     backend="cuda", autotune=ctl)
        job.compiled.state = state0
        base = (job.compiled.plan.row_tile, True)
        out, forced = [], []
        df.reset_launch_counts()
        t0 = time.perf_counter()
        with job.batches() as ex:
            knobs = {k.name: k for k in ctl.knobs} if ctl else {}
            for i, batch in enumerate(ex):
                out.append({k: v.cpu().numpy() for k, v in batch.items()})
                if ctl is None or i != 12:
                    continue
                tiles = {t for t, _ in job.swap_log} | {base[0]}
                if len(tiles) == 1:
                    rt = knobs["row_tile"]
                    rt.set(next(c for c in rt.candidates if c != base[0]))
                    forced.append("row_tile")
                if all(f for _, f in job.swap_log):
                    knobs["fuse"].set(False)
                    forced.append("fuse")
        wall = time.perf_counter() - t0
        return job, out, forced, dict(df.LAUNCHES), wall, base

    _, want, _, _, plain_wall, _ = run(None)
    ctl = PipelineController([], window_deliveries=2)
    job, got, forced, launches, wall, base = run(ctl)
    if len(got) != len(want) or len(got) != n_batches:
        raise AssertionError(f"autotune_main: {len(got)} / {len(want)} "
                             "batches")
    for i, (w, g) in enumerate(zip(want, got)):
        for k in w:
            if not np.array_equal(w[k], g[k]):
                raise AssertionError(f"autotune_main: batch {i} ({k}) "
                                     "differs from the untuned run")
    prev, row_swaps, fuse_swaps = base, 0, 0
    for key in job.swap_log:
        row_swaps += key[0] != prev[0]
        fuse_swaps += key[1] != prev[1]
        prev = key
    if row_swaps < 1 or fuse_swaps < 1:
        raise AssertionError(f"autotune_main: swaps {job.swap_log}")
    off = launches.get("vocab_lookup", 0)
    expect(launches, {k: v for k, v in {
        "group_dataflow": n_batches - off, "fused_stage": 2 * off,
        "vocab_lookup": off, "packer": 2 * off}.items() if v},
        "autotune_main")
    tiles = next(k for k in ctl.knobs if k.name == "row_tile").candidates
    cp = job.compiled
    variants = {t: cp if t == base[0] else cp.with_knobs(row_tile=t)
                for t in tiles}
    kernel_tiles = {t: v.kernel_tiles() for t, v in variants.items()}
    if len(set(kernel_tiles.values())) != len(tiles):
        raise AssertionError(f"autotune_main: row tiles {kernel_tiles}")
    raw = next(iter(Source.synth("I", rows=B, batch_size=B, seed=13)))
    cols = cp._device_columns(raw)
    timer = DeviceTimer()
    tile_ms = []
    for t in (base[0], *(t for t in tiles if t != base[0]), base[0]):
        v = variants[t]
        tables = v._device_tables(cp.state)
        tile_ms.append({"row_tile": t, "kernel_tiles": list(kernel_tiles[t]),
                        **timer(lambda: v._apply_fn(tables, cols))})
    del timer
    return {"batches": len(got), "bit_equal": True,
            "swap_log": [list(k) for k in job.swap_log],
            "row_tile_swaps": row_swaps, "fuse_swaps": fuse_swaps,
            "forced": forced, "windows": ctl.window,
            "decision_counts": ctl.decision_counts(),
            "decisions": [list(d) for d in ctl.decision_log()],
            "knobs": {k: str(v) for k, v in ctl.knob_values().items()},
            "row_tile_candidates": list(tiles),
            "row_tile_apply_ms": tile_ms,
            "launches": launches, "wall_seconds": wall,
            "untuned_wall_seconds": plain_wall}


def profile_step(fn, top: int = 30) -> dict:
    """``fn()`` (one more train or decode step) under ``torch.profiler``
    (CPU and CUDA activities), synchronized: the wall time, the device's
    busy time (the sum of the kernels' and copies' device time: the rest of
    the wall is the device's idle share), the NCCL kernels' time, the
    device time of each annotated range (FSDP's, gloo's: spans over
    kernels counted already) and the ``top`` kernels and operators by self
    device time (an operator's is that of the kernels it launched itself).
    A profiler that records no device time returns that, not a reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev(e, total: bool = False) -> float:
        for k in (("device_time_total", "cuda_time_total") if total else
                  ("self_device_time_total", "self_cuda_time_total")):
            if hasattr(e, k):
                return getattr(e, k) / 1e3
        return 0.0

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        cuda = torch.autograd.DeviceType.CUDA
        # a range a library annotates (FSDP::*, gloo:*) shows on the device
        # too, spanning kernels already counted: kept apart
        host = {e.key for e in events if e.device_type != cuda}
        kernels = [e for e in events if e.device_type == cuda
                   and e.key not in host]
        ranges = [e for e in events if e.device_type == cuda
                  and e.key in host]
        ops = [e for e in events if e.device_type != cuda and dev(e) > 0]
        busy = sum(dev(e) for e in kernels)
    except Exception as e:  # a profiler without CUPTI access raises
        return {"error": repr(e)[:500]}
    if busy <= 0:
        return {"wall_ms": wall, "error": "no device time recorded"}

    def table(rows):
        rows = sorted(rows, key=dev, reverse=True)[:top]
        return [{"name": e.key[:120], "self_device_ms": dev(e),
                 "share_of_busy": dev(e) / busy, "calls": e.count}
                for e in rows]
    nccl = sum(dev(e) for e in kernels if "nccl" in e.key.lower())
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall),
            "kernels": len(kernels), "nccl_kernel_ms": nccl,
            "nccl_share_of_busy": nccl / busy,
            "annotated_ranges_device_ms": {e.key[:80]: dev(e)
                                           for e in ranges},
            "top_kernels": table(kernels), "top_ops": table(ops)}


class TappedPipeline:
    """A compiled pipeline that keeps each call's raw batch and output, so a
    caller can hold what a running executor transformed against a plain
    compile of the same raw batch.  With ``timing=True`` (CUDA) it also
    records a pair of timed events around each call on the calling thread's
    current stream (the executor's transform stream): ``span_ms`` sums the
    spans, which hold the call's H2D copies and kernels and any gap while
    the host stages them.  With ``marker`` set (a pinned host tensor of a
    size no other copy has), each call first copies it to the device on
    that stream, so a profiler trace shows which stream is this
    pipeline's.  Every other attribute is the wrapped pipeline's."""

    def __init__(self, pipeline, timing: bool = False):
        self.pipeline = pipeline
        self.timing = timing
        self.calls: list = []
        self.events: list = []
        self.marker = None  # a pinned host tensor, see __call__

    def __getattr__(self, name):
        return getattr(self.__dict__["pipeline"], name)

    def __call__(self, raw):
        import torch
        if self.marker is not None:  # tags this call's stream in a trace
            self.marker.to(self.pipeline.device, non_blocking=True)
        if self.timing:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        out = self.pipeline(raw)
        if self.timing:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((start, end))
        self.calls.append((raw, out))
        return out

    def span_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events)


def device_ms_by_stream(trace: dict, markers: dict) -> dict:
    """Device time of each named stream, from a ``torch.profiler`` Chrome
    trace: a stream is named by the marker copy found on it (``markers``:
    name -> bytes of a host-to-device copy no other copy has), and its
    kernels, copies and memsets are summed, the marker copies left out.
    Returns name -> ms, and "other" for every other stream."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    gpu = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    by_bytes = {b: name for name, b in markers.items()}
    stream_of = {}
    for e in gpu:
        args = e.get("args") or {}
        if e["cat"] == "gpu_memcpy" and args.get("bytes") in by_bytes:
            stream_of[args.get("stream")] = by_bytes[args["bytes"]]
    out = {name: 0.0 for name in markers}
    out["other"] = 0.0
    for e in gpu:
        args = e.get("args") or {}
        if e["cat"] == "gpu_memcpy" and args.get("bytes") in by_bytes:
            continue
        out[stream_of.get(args.get("stream"), "other")] += \
            e.get("dur", 0.0) / 1e3  # microseconds
    return out


def lm_launches(compiled, batches: int) -> dict:
    """The dataflow launches ``batches`` transforms of the LM token
    pipeline make: one group launch a batch where tokens and labels are
    grouped, one output launch per output where each fits a tile, and
    past that (a long prompt: its tile is over the budget) the staged
    kernels: one stage for the tokens' hash chain (the labels pass
    through) and one packer per output."""
    kinds = {v["path"] for v in compiled.lowering_report().values()}
    if kinds == {"grouped"}:
        return {"group_dataflow": batches}
    if kinds == {"fused"}:
        return {"output_dataflow": 2 * batches}
    if kinds == {"staged"}:
        return {"fused_stage": batches, "packer": 2 * batches}
    raise AssertionError(f"LM pipeline lowering {kinds}")


def run_launcher(argv: list, cfg=None, on_first=None) -> dict:
    """``repro_torch.launch.train.main(argv)`` in process, with the train
    step it builds wrapped (``make_train_step`` in the launcher's
    namespace, or ``shard_train_step`` under a process group; the step
    itself is ``tap["step"]``) to keep each delivered batch on the host,
    time each step
    (synchronized) and, before the first step, return ``on_first(state,
    batch, loss_fn)`` into ``tap["first"]``.  With ``cfg`` the launcher
    builds that config (``get_config`` and ``get_reduced`` in its namespace
    return it: a depth cut).  The launch counts and the peak memory are
    reset first.  Returns the launcher's summary with ``tap`` (``batches``,
    step ``ms``, ``metrics``: (loss, grad norm) a step, ``first``),
    ``wall``, ``launches`` and ``peak_mem_gb``."""
    import torch
    from repro_torch.kernels import dataflow as df
    from repro_torch.launch import train as launch

    real = (launch.make_train_step, launch.get_config, launch.get_reduced,
            launch.shard_train_step)
    tap: dict = {"batches": [], "ms": [], "metrics": [], "first": None}

    def tapped(loss_fn, tc):
        return tap_step(real[0](loss_fn, tc), loss_fn)

    def tapped_sharded(loss_fn, *a, **kw):  # under WORLD_SIZE
        step, state = real[3](loss_fn, *a, **kw)
        return tap_step(step, loss_fn), state

    def tap_step(step, loss_fn):
        tap["step"] = step

        def run(state, b):
            tap["batches"].append({k: v.cpu() for k, v in b.items()})
            if on_first is not None and not tap["ms"]:
                tap["first"] = on_first(state, b, loss_fn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            loss = float(m["loss"])
            tap["ms"].append((time.perf_counter() - t0) * 1e3)
            tap["metrics"].append((loss, float(m["grad_norm"])))
            return state, m
        return run

    launch.make_train_step = tapped
    launch.shard_train_step = tapped_sharded
    if cfg is not None:
        launch.get_config = launch.get_reduced = lambda arch: cfg
    try:
        torch.cuda.reset_peak_memory_stats()
        df.reset_launch_counts()
        t0 = time.perf_counter()
        summary = launch.main(argv)
        torch.cuda.synchronize()
        summary["wall"] = time.perf_counter() - t0
        summary["launches"] = dict(df.LAUNCHES)
        summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        (launch.make_train_step, launch.get_config, launch.get_reduced,
         launch.shard_train_step) = real
    summary["tap"] = tap
    return summary


def with_oom_rerun(attempt, seq: int) -> tuple:
    """``attempt(seq)``; if the card runs out of memory, ``attempt``
    again at ``LM_OOM_SEQ``.  Returns (summary, seq used, the OOM's first
    line or None)."""
    import gc

    import torch
    summary, oom = None, None
    try:
        summary = attempt(seq)
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    if summary is None:  # out of the except block: its frames are freed
        gc.collect()
        torch.cuda.empty_cache()
        seq = LM_OOM_SEQ
        summary = attempt(seq)
    return summary, seq, oom


def check_lm_run(name: str, summary: dict, cfg, batch: int, seq: int,
                 steps: int, expect) -> tuple:
    """The checks every launcher phase makes: the steps ran, finite
    losses, the dataflow launches of every transformed batch, and every
    delivered batch bit-equal to the plain (CPU) compile of its raw batch.
    Returns (losses, median step ms of steps 2 on)."""
    import torch
    from repro_torch.core.pipeline import lm_token_pipeline
    from repro_torch.data.source import Source

    tap, state = summary["tap"], summary["state"]
    if state.step != steps or len(tap["metrics"]) != steps:
        raise AssertionError(f"{name}: {state.step} steps")
    losses = [m[0] for m in tap["metrics"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: losses {losses}")
    transformed = summary["stats"].stages["transform"].items
    # at seq 1024 the planner (the reference's too) lowers tokens and
    # labels to one output kernel each: the grouped tile is over budget
    expect(summary["launches"], lm_launches(summary["job"].compiled,
                                            transformed), name)
    plain = lm_token_pipeline(seq, cfg.vocab_size,
                              batch_size=batch).compile("cuda", device="cpu")
    raws = Source.lm_events(seq, rows=batch * (steps + 4), batch_size=batch)
    for i, (got, raw) in enumerate(zip(tap["batches"], raws)):
        for k, w in plain(raw).items():
            if not torch.equal(got[k], w):
                raise AssertionError(f"{name}: batch {i} {k} differs from "
                                     "the plain compile")
    ms = sorted(tap["ms"][1:])
    return losses, ms[len(ms) // 2] if ms else float("nan")


def matrix_params(model, cfg) -> int:
    """The model's matrix parameters less the embedding's padded rows
    (``param_count``'s count)."""
    pad_rows = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    return sum(p.numel() for p in model.parameters() if p.dim() >= 2) \
        - pad_rows


def lm_main(root: str, expect, batch: int = LM_BATCH, seq: int = LM_SEQ,
            steps: int = LM_STEPS, extra_args=()) -> dict:
    """``repro_torch.launch.train.main`` in process (``run_launcher``):
    ``--arch llama3_2_3b`` at full width and depth (28 layers, 3.21 B
    parameters, the preset's ``microbatch=2``), fed by ``lm_token_pipeline``
    on the cuda backend (``lm_launches``: at seq 1024 one output launch per
    output a batch); before the first step, one un-microbatched
    loss-and-gradient on that step's batch.  Checks: parameter count,
    ``check_lm_run``, the un-microbatched loss and global gradient norm
    within ``LM_CHECK_RTOL`` of the first step's.  If the card runs out of
    memory at ``seq`` the phase reruns at ``LM_OOM_SEQ`` and says so."""
    import gc

    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.training.grad import microbatched_value_and_grad
    from repro_torch.training.optimizer import global_norm

    reduced = "--reduced" in extra_args
    cfg = get_reduced(LM_ARCH) if reduced else get_config(LM_ARCH)
    tcfg = launch.train_preset(LM_ARCH)

    def whole(state, b, loss_fn):
        loss1, g1 = microbatched_value_and_grad(loss_fn, 1)(state.model, b)
        out = (float(loss1), float(global_norm(g1)))
        del g1
        return out

    def attempt(s: int) -> dict:
        return run_launcher(
            ["--arch", LM_ARCH, "--batch", str(batch), "--seq", str(s),
             "--steps", str(steps), "--etl-backend", "cuda",
             "--max-restarts", "0", *extra_args], on_first=whole)

    summary, seq_used, oom = with_oom_rerun(attempt, seq)
    state, stats, tap = summary["state"], summary["stats"], summary["tap"]
    model = state.model
    n_total = sum(p.numel() for p in model.parameters())
    n_mats = matrix_params(model, cfg)
    if n_mats != cfg.param_count() or len(model.blocks) != cfg.n_layers:
        raise AssertionError(f"lm_main: {n_mats} matrix "
                             f"parameters in {len(model.blocks)} blocks, "
                             f"want {cfg.param_count()} in {cfg.n_layers}")
    losses, step_ms = check_lm_run("lm_main", summary, cfg, batch, seq_used,
                                   steps, expect)
    loss1, norm1 = tap["first"]
    first = {"loss": tap["metrics"][0][0], "grad_norm": tap["metrics"][0][1]}
    whole = {"loss": loss1, "grad_norm": norm1}
    for k, rtol in LM_CHECK_RTOL.items():
        if abs(whole[k] - first[k]) > rtol * abs(first[k]):
            raise AssertionError(f"lm_main: un-microbatched {k} {whole[k]} "
                                 f"vs microbatched {first[k]} (rtol {rtol})")
    last = {k: v.to(next(model.parameters()).device)
            for k, v in tap["batches"][-1].items()}
    step = launch.make_train_step(launch.build_model(cfg).loss, tcfg)
    profile = profile_step(lambda: step(state, last))
    tokens = batch * seq_used
    n = cfg.param_count()
    out = {"arch": LM_ARCH, "reduced": reduced, "layers": len(model.blocks),
           "params_matrix": n_mats, "params_total": n_total,
           "param_count": n, "batch": batch, "seq": seq_used,
           "seq_wanted": seq, "oom_at_seq": oom,
           "microbatch": tcfg.microbatch, "steps": len(tap["metrics"]),
           "losses": losses, "grad_norms": [m[1] for m in tap["metrics"]],
           "unmicrobatched_check": {"whole": whole, "microbatched": first,
                                    "rtol": LM_CHECK_RTOL},
           "batches_checked": len(tap["batches"]),
           "step_ms": tap["ms"], "step_ms_median_2_on": step_ms,
           "tok_per_s": summary["tok_per_s"],
           "tok_per_s_steps_2_on": tokens / (step_ms / 1e3),
           "peak_mem_gb": summary["peak_mem_gb"],
           "trainer_utilization": summary["trainer_utilization"],
           "consumer_wait_s": stats.consumer_wait_s,
           "producer_wait_s": stats.producer_wait_s,
           "mfu_estimate_6NT_vs_dense_bf16_peak":
               6 * n * tokens / (step_ms / 1e3) / BF16_PEAK_FLOPS,
           "wall_seconds": summary["wall"], "launches": summary["launches"],
           "transformed": stats.stages["transform"].items,
           "stages": stats.stage_breakdown(),
           "profile_one_more_step": profile}
    del summary, state, model, stats, last, tap
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_layer_check(model, cfg, tokens, n_micro: int) -> dict:
    """The first MoE layer on the first microbatch of ``tokens`` (its input
    from the model's own embedding and blocks before it, in the compute
    dtype) against a plain float32 loop over the experts, each on its kept
    (token, weight) pairs of the same routing (``moe.route``), summed back
    per token; and, over every microbatch, the share of each expert's routed
    slots that were dropped.  Max abs error within ``MOE_LOOP_TOL`` x the
    loop's largest magnitude."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib

    blk = model.moe_blocks[0]
    E, D = cfg.moe.n_experts, cfg.d_model
    per = tokens.shape[0] // n_micro
    routed = torch.zeros(E, dtype=torch.int64)
    dropped = torch.zeros(E, dtype=torch.int64)
    ex = {k: v.detach() for k, v in blk.moe.experts.items()}
    err = None
    with torch.no_grad():
        for i in range(n_micro):
            x = L.embed_lookup(model.embed, tokens[i * per:(i + 1) * per],
                               cfg.cdtype())
            for b in model.blocks:
                x = b(x)
            x = x + L.mha(blk.attn, L.norm_apply(x, blk.ln1, cfg.norm,
                                                  cfg.norm_eps), blk.spec)
            y = L.norm_apply(x, blk.ln2, cfg.norm, cfg.norm_eps)
            yf = y.reshape(-1, D)
            plan = moe_lib.route(blk.moe, yf, cfg,
                                 moe_lib.capacity(yf.shape[0], cfg))
            se, keep = plan["se"].cpu(), plan["keep"].cpu()
            routed += torch.bincount(se, minlength=E)
            dropped += torch.bincount(se[~keep], minlength=E)
            if i:
                continue
            got = moe_lib.moe_apply(blk.moe, y, cfg).reshape(-1, D).float()
            xs = yf.float()
            want = torch.zeros_like(xs)
            for e in range(E):
                sel = (plan["se"] == e) & plan["keep"]
                t, w = plan["st"][sel], plan["sw"][sel].float()
                xe = xs[t]
                h = F.silu(xe @ ex["w1"][e].float()) \
                    * (xe @ ex["w3"][e].float())
                want.index_add_(0, t, (h @ ex["w2"][e].float()) * w[:, None])
            if cfg.moe.n_shared_experts:
                want += L.mlp_apply({k: v.detach().float() for k, v in
                                     blk.moe.shared.items()}, xs, "swiglu")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            pairs = int(plan["keep"].sum())
    if not err <= MOE_LOOP_TOL * scale:
        raise AssertionError(f"moe layer: max abs error {err} against the "
                             f"loop (largest {scale}, tol {MOE_LOOP_TOL})")
    return {"max_abs_err": err, "largest": scale, "tol": MOE_LOOP_TOL,
            "kept_pairs_checked": pairs,
            "tokens_checked": per * tokens.shape[1],
            "routed_per_expert": routed.tolist(),
            "dropped_share_per_expert": (dropped / routed.clamp(min=1))
            .tolist(),
            "dropped_share": float(dropped.sum() / routed.sum())}


def moe_main(root: str, expect, batch: int = LM_BATCH, seq: int = LM_SEQ,
             steps: int = LM_STEPS, layers: int = MOE_LAYERS,
             extra_args=()) -> dict:
    """``launch.train.main`` at ``mixtral_8x7b``'s full width (d 4096, 32 /
    8 heads x 128, 8 experts top-2, d_ff_expert 14336, vocab 32000, window
    4096, untied), depth cut to ``layers`` (``run_launcher``'s ``cfg``), the
    preset's AdamW in float32, ``microbatch=4`` and ``fsdp`` on one device,
    bf16 compute, full remat.  Before the first step, with the capacity
    factor raised to E / k so that nothing drops (the capacity is per
    microbatch, so at 1.25 the dropped tokens differ), half the batch's
    loss and gradient norm un-microbatched against two microbatches of the
    preset's rows.  Checks: parameter count, ``check_lm_run``, that
    check within ``LM_CHECK_RTOL``, ``moe_layer_check`` on the first batch.
    Then one more step under the profiler.  Reruns at ``LM_OOM_SEQ`` if the
    card runs out of memory."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.models import moe as moe_lib
    from repro_torch.training.grad import microbatched_value_and_grad
    from repro_torch.training.optimizer import global_norm

    reduced = "--reduced" in extra_args
    base = get_reduced(MOE_ARCH) if reduced else get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, n_layers=layers)
    tcfg = launch.train_preset(MOE_ARCH)
    raised = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))

    def no_drop_check(state, b, loss_fn):
        per = b["tokens"].shape[0] // tcfg.microbatch
        half = {k: v[:2 * per] for k, v in b.items()}
        out = {}
        with config_swapped(state.model, raised):
            for label, n in (("whole", 1), ("microbatched", 2)):
                loss, g = microbatched_value_and_grad(
                    loss_fn, n, accum_dtype=tcfg.accum_dtype)(state.model,
                                                              half)
                out[label] = {"loss": float(loss),
                              "grad_norm": float(global_norm(g))}
                del g
        return out

    def attempt(s: int) -> dict:
        return run_launcher(
            ["--arch", MOE_ARCH, "--batch", str(batch), "--seq", str(s),
             "--steps", str(steps), "--etl-backend", "cuda",
             "--max-restarts", "0", *extra_args], cfg=cfg,
            on_first=no_drop_check)

    summary, seq_used, oom = with_oom_rerun(attempt, seq)
    state, stats, tap = summary["state"], summary["stats"], summary["tap"]
    model = state.model
    n_mats = matrix_params(model, cfg)
    if n_mats != cfg.param_count() or len(model.moe_blocks) != layers:
        raise AssertionError(f"moe_main: {n_mats} matrix parameters in "
                             f"{len(model.moe_blocks)} MoE blocks, want "
                             f"{cfg.param_count()} in {layers}")
    losses, step_ms = check_lm_run("moe_main", summary, cfg, batch, seq_used,
                                   steps, expect)
    check = tap["first"]
    for k, rtol in LM_CHECK_RTOL.items():
        w, m = check["whole"][k], check["microbatched"][k]
        if abs(w - m) > rtol * abs(m):
            raise AssertionError(f"moe_main: un-microbatched {k} {w} vs "
                                 f"microbatched {m} (rtol {rtol})")
    dev = next(model.parameters()).device
    layer = moe_layer_check(model, cfg, tap["batches"][0]["tokens"].to(dev),
                            tcfg.microbatch)
    last = {k: v.to(dev) for k, v in tap["batches"][-1].items()}
    step = launch.make_train_step(launch.build_model(cfg).loss, tcfg)
    profile = profile_step(lambda: step(state, last))
    tokens = batch * seq_used
    active = cfg.active_param_count()
    out = {"arch": MOE_ARCH, "reduced": reduced, "layers": layers,
           "layers_full": base.n_layers, "params_matrix": n_mats,
           "param_count": cfg.param_count(), "active_param_count": active,
           "params_total": sum(p.numel() for p in model.parameters()),
           "batch": batch, "seq": seq_used, "seq_wanted": seq,
           "oom_at_seq": oom, "microbatch": tcfg.microbatch,
           "fsdp": tcfg.fsdp, "optimizer": tcfg.optimizer,
           "capacity": {"per_microbatch": moe_lib.capacity(
               batch // tcfg.microbatch * seq_used, cfg),
                        "factor": cfg.moe.capacity_factor},
           "steps": len(tap["metrics"]), "losses": losses,
           "grad_norms": [m[1] for m in tap["metrics"]],
           "unmicrobatched_check_no_drops": {**check, "rtol": LM_CHECK_RTOL,
                                             "capacity_factor":
                                                 raised.moe.capacity_factor},
           "first_moe_layer": layer,
           "batches_checked": len(tap["batches"]),
           "step_ms": tap["ms"], "step_ms_median_2_on": step_ms,
           "tok_per_s": summary["tok_per_s"],
           "tok_per_s_steps_2_on": tokens / (step_ms / 1e3),
           "peak_mem_gb": summary["peak_mem_gb"],
           "trainer_utilization": summary["trainer_utilization"],
           "mfu_estimate_6_active_NT_vs_dense_bf16_peak":
               6 * active * tokens / (step_ms / 1e3) / BF16_PEAK_FLOPS,
           "wall_seconds": summary["wall"], "launches": summary["launches"],
           "transformed": stats.stages["transform"].items,
           "stages": stats.stage_breakdown(),
           "profile_one_more_step": profile}
    del summary, state, model, stats, last, tap
    gc.collect()
    torch.cuda.empty_cache()
    return out


def reference_factor_shapes(shape: tuple) -> dict:
    """The JAX package's ``adafactor_init`` rule on a leaf's (stacked)
    shape: ``vr`` / ``vc`` where the last two dims both exceed 1, else
    ``v``."""
    if len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1:
        return {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
    return {"v": shape}


def bf16_ulps(a, b, scale=None) -> float:
    """The largest distance between two bfloat16 tensors in units in the
    last place: of the larger of the two values, or of ``scale`` where it
    is larger (an update ``p - lr u`` that nearly cancels is rounded at the
    scale of its terms, not of its result)."""
    import torch
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    if scale is not None:
        mag = torch.maximum(mag, scale.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126)))
                     - 7)
    return float(((a - b).abs() / ulp).max())


def adafactor_main(root: str, expect, batch: int = LM_BATCH,
                   seq: int = LM_SEQ, steps: int = AF_STEPS,
                   layers: int = AF_LAYERS, extra_args=()) -> dict:
    """``launch.train.main`` at ``llama3_405b``'s full width (d 16384, 128
    / 8 heads x 128, d_ff 53248, vocab 128256, untied), depth cut to
    ``layers``, with the preset: Adafactor, bfloat16 parameters, state and
    gradient accumulation, ``microbatch=8``, ``fsdp`` on one device.
    Checks: parameter count, ``check_lm_run``, Adafactor's state shapes
    against the reference's rule on the stacked leaves, and one leaf's
    update (``AF_LEAF``, from the trained tensors and a seeded gradient
    inside the clip norm) on the card against the same update on the CPU:
    parameters and state within one bfloat16 unit in the last place (a
    parameter's at the larger of its old and new values).  Reruns at
    ``LM_OOM_SEQ`` if the card runs out of memory."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as ttr
    from repro_torch.training.optimizer import leaf_shape, opt_update

    reduced = "--reduced" in extra_args
    base = get_reduced(AF_ARCH) if reduced else get_config(AF_ARCH)
    cfg = dataclasses.replace(base, n_layers=layers)
    tcfg = launch.train_preset(AF_ARCH)

    def attempt(s: int) -> dict:
        return run_launcher(
            ["--arch", AF_ARCH, "--batch", str(batch), "--seq", str(s),
             "--steps", str(steps), "--etl-backend", "cuda",
             "--max-restarts", "0", *extra_args], cfg=cfg)

    summary, seq_used, oom = with_oom_rerun(attempt, seq)
    state, stats, tap = summary["state"], summary["stats"], summary["tap"]
    model = state.model
    n_mats = matrix_params(model, cfg)
    if n_mats != cfg.param_count() or len(model.blocks) != layers:
        raise AssertionError(f"adafactor_main: {n_mats} matrix parameters "
                             f"in {len(model.blocks)} blocks, want "
                             f"{cfg.param_count()} in {layers}")
    losses, step_ms = check_lm_run("adafactor_main", summary, cfg, batch,
                                   seq_used, steps, expect)
    opt = state.opt
    paths = [p for p, _ in ttr.jax_leaves(model.jax_tree())]
    params = list(model.parameters())
    for path, leaf, st in zip(paths, opt["leaves"], opt["f"]):
        got = {k: tuple(v.shape) for k, v in st.items()}
        if got != reference_factor_shapes(leaf_shape(leaf, params)) or any(
                v.dtype != getattr(torch, tcfg.opt_state_dtype)
                for v in st.values()):
            raise AssertionError(f"adafactor_main: {path} state {got}")
    state_bytes = sum(v.numel() * v.element_size() for st in opt["f"]
                      for v in st.values())
    adamw_bytes = 2 * sum(p.numel() for p in params) * torch.empty(
        (), dtype=getattr(torch, tcfg.opt_state_dtype)).element_size()
    # one leaf's update, card against CPU, from the same tensors
    i = paths.index(AF_LEAF)
    idx = opt["leaves"][i]
    idx = idx if isinstance(idx, list) else [idx]
    gen = torch.Generator(device=params[0].device).manual_seed(0)
    ps = [params[j].detach().clone() for j in idx]
    # inside the clip norm (~0.41 < max_grad_norm): the clip scale is a
    # float32 reduction over the whole gradient whose order differs between
    # the devices (2 B elements: 4.0947 vs 4.0929 measured), and it moves
    # the rounding of the clipped bfloat16 gradient
    gs = [torch.randn(p.shape, generator=gen, device=p.device,
                      dtype=torch.float32).mul_(1e-4).to(p.dtype) for p in ps]
    olds = [p.cpu() for p in ps]
    sub = {"f": [{k: v.clone() for k, v in opt["f"][i].items()}],
           "leaves": [list(range(len(ps)))]}
    host = {"f": [{k: v.cpu() for k, v in sub["f"][0].items()}],
            "leaves": sub["leaves"]}
    hps, hgs = [p.cpu() for p in ps], [g.cpu() for g in gs]
    opt_update(ps, gs, sub, state.step, tcfg)
    torch.cuda.synchronize()
    opt_update(hps, hgs, host, state.step, tcfg)
    leaf_ulps = {"params": max(bf16_ulps(a.cpu(), b, old)
                               for a, b, old in zip(ps, hps, olds))}
    for k, v in sub["f"][0].items():
        leaf_ulps[k] = bf16_ulps(v.cpu(), host["f"][0][k])
    if max(leaf_ulps.values()) > 1:
        raise AssertionError(f"adafactor_main: {AF_LEAF} update on the card "
                             f"vs the CPU: {leaf_ulps} ulps")
    tokens = batch * seq_used
    n = cfg.param_count()
    out = {"arch": AF_ARCH, "reduced": reduced, "layers": layers,
           "layers_full": base.n_layers, "params_matrix": n_mats,
           "param_count": n,
           "params_total": sum(p.numel() for p in params),
           "param_dtype": cfg.param_dtype, "batch": batch, "seq": seq_used,
           "seq_wanted": seq, "oom_at_seq": oom,
           "microbatch": tcfg.microbatch, "fsdp": tcfg.fsdp,
           "optimizer": tcfg.optimizer,
           "opt_state_dtype": tcfg.opt_state_dtype,
           "accum_dtype": tcfg.accum_dtype,
           "opt_state_bytes": state_bytes,
           "adamw_state_bytes_same_dtype": adamw_bytes,
           "state_shapes_match_reference_rule": True,
           "leaf_update_card_vs_cpu": {"leaf": AF_LEAF, "ulps": leaf_ulps,
                                       "tol_ulps": 1},
           "steps": len(tap["metrics"]), "losses": losses,
           "grad_norms": [m[1] for m in tap["metrics"]],
           "batches_checked": len(tap["batches"]),
           "step_ms": tap["ms"], "step_ms_median_2_on": step_ms,
           "tok_per_s": summary["tok_per_s"],
           "tok_per_s_steps_2_on": tokens / (step_ms / 1e3),
           "peak_mem_gb": summary["peak_mem_gb"],
           "trainer_utilization": summary["trainer_utilization"],
           "mfu_estimate_6NT_vs_dense_bf16_peak":
               6 * n * tokens / (step_ms / 1e3) / BF16_PEAK_FLOPS,
           "wall_seconds": summary["wall"], "launches": summary["launches"],
           "transformed": stats.stages["transform"].items,
           "stages": stats.stage_breakdown()}
    del summary, state, model, stats, tap, params, opt, ps, gs, sub
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_ckpt(root: str, expect, batch: int = 8, seq: int = 128,
            arch: str = LM_ARCH, every: int = 4,
            name: str = "lm_ckpt") -> dict:
    """``launch.train.main`` at ``arch``'s reduced config on the card with a
    checkpoint at step ``every``: ``resume_or_init`` restores it into a
    fresh model; every leaf bit-equal, the leaves in the JAX package's
    ``TrainState(params, opt, step)`` order (the manifest's shapes, blocks
    stacked ``[L, ...]``; Adafactor's factors after the parameters), and
    the launcher resumes from it to step ``every + 2``."""
    import json as json_lib
    import shutil

    import torch
    from repro_torch.kernels import dataflow as df
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as ttr
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training.train_loop import TrainState, resume_or_init

    d = os.path.join(root, "build", name)
    shutil.rmtree(d, ignore_errors=True)
    args = ["--arch", arch, "--reduced", "--batch", str(batch), "--seq",
            str(seq), "--ckpt-dir", d, "--ckpt-every", str(every),
            "--max-restarts", "0"]
    df.reset_launch_counts()
    first = launch.main(args + ["--steps", str(every)])
    torch.cuda.synchronize()
    launches = dict(df.LAUNCHES)
    expect(launches, lm_launches(
        first["job"].compiled, first["stats"].stages["transform"].items),
        name)
    trained = first["state"]
    if ckpt_lib.latest_step(d) != every:
        raise AssertionError(f"{name}: latest {ckpt_lib.latest_step(d)}")
    model = trained.model
    tcfg = launch.train_preset(arch)
    restored = resume_or_init(lambda: TrainState.create(
        launch.build_model(model.cfg).init(seed=7), tcfg), d)
    want = ttr.state_to_jax_leaves(trained)
    got = ttr.state_to_jax_leaves(restored)
    shapes = [list(ttr.stacked(x).shape) for x in want]
    with open(os.path.join(d, f"step_{every:08d}", "manifest.json")) as fh:
        manifest = json_lib.load(fh)
    order_ok = [e["shape"] for e in manifest["index"]] == shapes
    equal = restored.step == trained.step == every and \
        len(got) == len(want) and \
        all(torch.equal(ttr.stacked(a), ttr.stacked(b))
            for a, b in zip(want, got))
    if not (equal and order_ok):
        raise AssertionError(f"{name}: bit-equal {equal}, JAX leaf order "
                             f"{order_ok}")
    paths = [p for p, _ in ttr.jax_leaves(model.jax_tree())]
    resumed = launch.main(args + ["--steps", str(every + 2)])
    if resumed["state"].step != every + 2:
        raise AssertionError(f"{name}: resumed to {resumed['state'].step}")
    dtypes: dict = {}
    for e in manifest["index"]:
        dtypes[e["dtype"]] = dtypes.get(e["dtype"], 0) + 1
    out = {"arch": arch, "optimizer": tcfg.optimizer,
           "opt_state_dtype": tcfg.opt_state_dtype,
           "microbatch": tcfg.microbatch, "steps": trained.step,
           "leaves": len(got), "leaf_dtypes": dtypes,
           "param_leaves_jax_order": paths, "restored_bit_equal": equal,
           "manifest_shapes_in_jax_order": order_ok,
           "treedef": manifest["treedef"], "resumed_to": every + 2,
           "launches": launches, "params": model.cfg.param_count()}
    shutil.rmtree(d, ignore_errors=True)
    return out


def run_serve(argv: list, cfg=None) -> dict:
    """``repro_torch.launch.serve.main(argv)`` in process; with ``cfg`` the
    launcher builds that config (``get_config`` / ``get_reduced`` in its
    namespace return it: a depth cut).  The launch counts and the peak
    memory are reset first.  Returns the launcher's summary with
    ``wall``, ``launches`` (the prompt job's) and ``peak_mem_gb``."""
    import torch
    from repro_torch.kernels import dataflow as df
    from repro_torch.launch import serve as serve_launch

    real = (serve_launch.get_config, serve_launch.get_reduced)
    if cfg is not None:
        serve_launch.get_config = serve_launch.get_reduced = \
            lambda arch: cfg
    try:
        torch.cuda.reset_peak_memory_stats()
        df.reset_launch_counts()
        t0 = time.perf_counter()
        summary = serve_launch.main(argv)
        torch.cuda.synchronize()
        summary["wall"] = time.perf_counter() - t0
        summary["launches"] = dict(df.LAUNCHES)
        summary["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        serve_launch.get_config, serve_launch.get_reduced = real
    return summary


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a (nested dict of) tensors."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def check_prompts(name: str, summary: dict, expect) -> dict:
    """The serve launcher's prompt job: its dataflow launches (the LM
    pipeline's lowering at the prompt length) and its batch bit-equal to
    the plain (CPU) compile of the raw batch."""
    import torch
    from repro_torch.core.pipeline import lm_token_pipeline
    from repro_torch.data.source import Source

    B, S = summary["prompts"].shape
    cfg = summary["cfg"]
    expect(summary["launches"], lm_launches(
        summary["job"].compiled, summary["etl"].stages["transform"].items),
        name)
    raw = next(iter(Source.lm_events(S, rows=B, batch_size=B, seed=0)))
    plain = lm_token_pipeline(S, cfg.vocab_size, batch_size=B).compile(
        "cuda", device="cpu")(raw)
    if not torch.equal(summary["prompts"].cpu(), plain["tokens"]):
        raise AssertionError(f"{name}: prompts differ from the plain "
                             "compile")
    return summary["launches"]


def teacher_forced_check(name: str, summary: dict, n: int,
                         greedy: bool = True, tol: float = SERVE_TOL,
                         strict: bool = True) -> dict:
    """One forward on the card over the prompt and the first ``n``
    generated tokens against prefill + ``n`` decode steps fed the same
    tokens: the decode logits predicting positions ``S .. S + n`` within
    ``tol`` x the forward's largest magnitude, and the chosen token (the
    served one with ``greedy``, else the decode logits' argmax) equal to
    the forward's argmax wherever its top-2 margin exceeds ``tol`` x that
    magnitude.  An SSM's or a hybrid's forward runs over a whole number of
    SSD chunks (the tokens past ``S + n`` cannot move the earlier
    logits).  An MoE
    model's prefill and decode take the forward's expert choices for the
    same (row, position) (``moe.top_k`` pinned, as the card tests pin the
    CPU's): in bfloat16 the router's input differs in its last bits
    between a forward over B x S tokens and a step over B, so a token near
    a tie may pick another expert, which moves its logits by far more
    than the tolerance (2.0 of 4.6 seen); how many rows would have chosen
    otherwise is reported and held within ``MOE_FLIP_SHARE``.  With
    ``strict=False`` nothing is asserted (a reading).  Returns the
    readings, the cache after the last step and the next position (for a
    profiled decode step)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib

    model, module, prompts = summary["model"], summary["module"], \
        summary["prompts"]
    cfg = module.cfg
    B, S = prompts.shape
    served = torch.as_tensor(summary["tokens"], device=prompts.device)
    seq = torch.cat([prompts, served.to(prompts.dtype)], 1)
    F_len = S + n
    if cfg.ssm is not None and F_len > cfg.ssm.chunk:
        F_len += -F_len % cfg.ssm.chunk
    if F_len > seq.shape[1] or n >= served.shape[1]:
        raise AssertionError(f"{name}: {served.shape[1]} served tokens for "
                             f"a check over {n}")
    real_top_k = moe_lib.top_k
    choices, pins, flips = [], [], []

    def record(probs, k):
        vals, idx = real_top_k(probs, k)
        choices.append(idx)
        return vals, idx

    def pinned(probs, k):
        _, own = real_top_k(probs, k)
        idx = pins.pop(0)
        flips.append((own != idx).any(-1).sum())
        return probs.gather(-1, idx), idx

    try:
        with torch.inference_mode():
            moe_lib.top_k = record
            h = module.hidden_states(seq[:, :F_len])[:, S - 1:S + n]
            fwd = L.lm_logits(h, module.head(), cfg.tie_embeddings).float()
            del h
            by_pos = [c.view(B, F_len, -1) for c in choices]
            pins += [c[:, :S].reshape(B * S, -1) for c in by_pos]
            for i in range(n):
                pins += [c[:, S + i] for c in by_pos]
            moe_lib.top_k = pinned
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.prefill(module, {"tokens": prompts},
                                      summary["max_len"])
            torch.cuda.synchronize()
            warm_prefill_s = time.perf_counter() - t0
            dec = [lg[:, -1].float()]
            for i in range(n):
                lg, cache = model.decode_step(module, cache,
                                              seq[:, S + i:S + i + 1], S + i)
                dec.append(lg[:, -1].float())
            dec = torch.stack(dec, 1)
    finally:
        moe_lib.top_k = real_top_k
    if pins:
        raise AssertionError(f"{name}: {len(pins)} expert choices unused")
    with torch.inference_mode():
        largest = float(fwd.abs().max())
        err = (dec - fwd).abs().amax(dim=(0, 2))  # per position
        top2 = torch.topk(fwd, 2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > tol * largest
        chosen = served[:, :n + 1] if greedy else dec.argmax(-1)
        wrong = sure & (chosen != fwd.argmax(-1))
    out = {"positions": [S, S + n], "max_abs_err": float(err.max()),
           "largest": largest, "tol": tol,
           "max_abs_err_by_position": [float(e) for e in err],
           "tokens_checked": int(sure.sum()), "tokens_total": sure.numel(),
           "tokens_differing": int(wrong.sum()),
           "chosen": "served" if greedy else "decode argmax",
           # the serve's prefill is the model's first call (cold)
           "prefill_s_warm": warm_prefill_s}
    if choices:
        rows = B * (S + n) * len(choices)  # per MoE layer: prefill, steps
        out["routing_pinned"] = {
            "rows": rows, "own_choice_differs": int(sum(flips)),
            "bound_share": MOE_FLIP_SHARE}
        if strict and int(sum(flips)) > MOE_FLIP_SHARE * rows:
            raise AssertionError(f"{name}: routing {out['routing_pinned']}")
    if strict and (not out["max_abs_err"] <= tol * largest
                   or out["tokens_differing"]):
        raise AssertionError(f"{name}: decode vs forward {out}")
    return {"check": out, "cache": cache, "next": seq[:, S + n:S + n + 1],
            "next_pos": S + n}


@contextlib.contextmanager
def config_swapped(module, cfg):
    """``cfg`` on the module and every submodule that holds one, for the
    block (the parameters stay as they are)."""
    mods = [m for m in module.modules() if hasattr(m, "cfg")]
    old = [m.cfg for m in mods]
    for m in mods:
        m.cfg = cfg
    try:
        yield
    finally:
        for m, c in zip(mods, old):
            m.cfg = c


def decode_once(model, module, tf: dict):
    """One more decode step after ``teacher_forced_check``'s (its cache was
    made under inference mode, so the step runs there too)."""
    import torch
    with torch.inference_mode():
        return model.decode_step(module, tf["cache"], tf["next"],
                                 tf["next_pos"])


def serve_readings(summary: dict, bound_bytes: int) -> dict:
    """Prefill seconds, decode tok/s and step ms, and the decode step's
    HBM bound (``bound_bytes`` over ``HBM_BYTES_PER_S``)."""
    st = summary["stats"]
    steps = summary["tokens"].shape[1]
    B = summary["tokens"].shape[0]
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    step_ms = st.decode_s / steps * 1e3
    return {"batch": B, "prompt_len": summary["prompts"].shape[1],
            "max_new": steps, "prefill_s": st.prefill_s,
            "decode_s": st.decode_s, "decode_tok_per_s": st.tokens_per_s,
            "decode_step_ms": step_ms,
            "decode_step_bound_ms": bound_ms,
            "decode_tok_per_s_bound": B / (bound_ms / 1e3),
            "decode_share_of_bound": bound_ms / step_ms,
            "peak_mem_gb": summary["peak_mem_gb"],
            "wall_seconds": summary["wall"],
            "first_sequence": summary["tokens"][0][:16].tolist()}


def param_bytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def free_memory() -> None:
    """Collect what the last phase dropped and hand the card's cached
    blocks back, so the next phase starts from an empty allocator."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_main(root: str, expect, arch: str = SERVE_ARCH,
               batch: int = SERVE_BATCH, prompt: int = SERVE_PROMPT,
               new: int = SERVE_NEW, check: int = SERVE_CHECK,
               extra_args=()) -> dict:
    """``launch.serve.main`` at ``llama3_2_3b``'s full width and depth (28
    layers, float32 parameters, bf16 compute), greedy, its prompts from the
    ETL on the card.  Readings: prefill s, decode tok/s and step ms; the
    cache's bytes against ``2 L B len n_kv hd 2`` (+ ``pos``); the decode
    step against its HBM bound (the parameters as stored, read once, plus
    the cache); the GQA repeat's and the weight casts' bytes a step; one
    decode step under the profiler.  Checks: the prompt job's launches and
    batch, ``teacher_forced_check`` over ``check`` tokens."""
    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as ttr

    reduced = "--reduced" in extra_args
    cfg = get_reduced(arch) if reduced else get_config(arch)
    summary = run_serve(["--arch", arch, "--batch", str(batch),
                         "--prompt-len", str(prompt), "--max-new", str(new),
                         *extra_args])
    launches = check_prompts("serve_main", summary, expect)
    module = summary["module"]
    if len(module.blocks) != cfg.n_layers:
        raise AssertionError(f"serve_main: {len(module.blocks)} layers")
    tf = teacher_forced_check("serve_main", summary, check)
    cache = tf["cache"]
    length = ttr.cache_len(cfg, prompt + new)
    kv_bytes = 2 * cfg.n_layers * batch * length * cfg.n_kv_heads * \
        cfg.hd * 2
    cache_bytes = tensor_bytes(cache)
    if cache_bytes != kv_bytes + cfg.n_layers * length * 4:
        raise AssertionError(f"serve_main: cache {cache_bytes} B")
    pbytes = param_bytes(module)
    profile = profile_step(lambda: decode_once(summary["model"], module, tf))
    n_par = sum(p.numel() for p in module.parameters())
    out = {"arch": arch, "reduced": reduced, "layers": cfg.n_layers,
           "params_matrix": matrix_params(module, cfg),
           "param_count": cfg.param_count(), "param_bytes": pbytes,
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype,
           **serve_readings(summary, pbytes + cache_bytes),
           "cache_len": length, "cache_bytes": cache_bytes,
           "cache_kv_formula_bytes": kv_bytes,
           # K and V repeated to n_heads in bf16, every layer (written)
           "gqa_repeat_bytes_per_step_est": 2 * cfg.n_layers * batch
           * length * cfg.n_heads * cfg.hd * 2,
           "weight_cast_bytes_per_step_est": n_par * (4 + 2),
           "teacher_forced": tf["check"], "launches": launches,
           "profile_one_decode_step": profile}
    return out


def serve_moe(root: str, expect, arch: str = MOE_ARCH,
              layers: int = MOE_LAYERS, batch: int = SERVE_MOE_BATCH,
              prompt: int = SERVE_MOE_PROMPT, new: int = SERVE_MOE_NEW,
              check: int = SERVE_MOE_CHECK, extra_args=()) -> dict:
    """``launch.serve.main`` at ``mixtral_8x7b``'s full width, depth cut to
    ``layers``: a 4096-slot ring (the window), and prompt + new tokens
    past it, so the last decode steps write over wrapped slots.  The check
    runs with the capacity factor raised to E / k on the same parameters
    (a prefill over B x S tokens drops routed slots at 1.25, a decode step
    of B tokens none): ``teacher_forced_check`` over ``check`` tokens, the
    decode logits at the first decode position and past the wrap reported
    apart.  If the card runs out of memory the phase reruns at half the
    batch and says so."""
    import torch
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import transformer as ttr

    reduced = "--reduced" in extra_args
    base = get_reduced(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(base, n_layers=layers)
    raised = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))

    def attempt(b: int) -> dict:
        summary = run_serve(["--arch", arch, "--batch", str(b),
                             "--prompt-len", str(prompt), "--max-new",
                             str(new), *extra_args], cfg=cfg)
        launches = check_prompts("serve_moe", summary, expect)
        with config_swapped(summary["module"], raised):
            tf = teacher_forced_check("serve_moe", summary, check,
                                      greedy=False)
        return summary, launches, tf

    oom, used = None, batch
    try:
        summary, launches, tf = attempt(batch)
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    if oom is not None:
        free_memory()
        used = batch // 2
        summary, launches, tf = attempt(used)
    module, cache = summary["module"], tf["cache"]
    length = ttr.cache_len(cfg, prompt + new)
    pos = cache["moe_blocks"]["pos"][0]
    wrapped = int((pos >= length).sum())
    if length != cfg.sliding_window or prompt + check <= length or \
            wrapped != prompt + check - length:
        raise AssertionError(f"serve_moe: ring of {length}, {wrapped} "
                             "slots rewritten past the wrap")
    kv_bytes = 2 * layers * used * length * cfg.n_kv_heads * cfg.hd * 2
    cache_bytes = tensor_bytes(cache)
    errs = tf["check"]["max_abs_err_by_position"]
    wrap_at = 1 + length - prompt  # decode logits at position `length`
    out = {"arch": arch, "reduced": reduced, "layers": layers,
           "layers_full": base.n_layers,
           "params_matrix": matrix_params(module, cfg),
           "param_count": cfg.param_count(),
           "param_bytes": param_bytes(module), "batch_wanted": batch,
           "oom_at_batch": oom,
           **serve_readings(summary, param_bytes(module) + cache_bytes),
           "cache_len": length, "cache_bytes": cache_bytes,
           "cache_kv_formula_bytes": kv_bytes,
           "slots_rewritten_past_wrap": wrapped,
           "check_capacity_factor": raised.moe.capacity_factor,
           "teacher_forced": tf["check"],
           "max_abs_err_first_decode": errs[1],
           "max_abs_err_past_wrap": max(errs[wrap_at:]),
           "past_wrap_positions": [length, prompt + check - 1],
           "launches": launches}
    return out


def counted_params(model, cfg) -> int:
    """``param_count``'s count of the model: its matrices (an SSM's or a
    hybrid's projections, not their convolutions; the SSM's also each
    layer's ``norm_w``) less the embedding's padded rows."""
    if cfg.ssm is None:
        return matrix_params(model, cfg)
    pad_rows = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    norm_w = cfg.family == "ssm"
    return sum(p.numel() for n, p in model.named_parameters()
               if (p.dim() >= 2 and ".conv_" not in n)
               or (norm_w and n.endswith("norm_w"))) - pad_rows


def train_readings(name: str, summary: dict, cfg, batch: int, seq: int,
                   steps: int, expect) -> dict:
    """A launcher run's checks (``check_lm_run``, the parameter count) and
    readings: losses, step ms, tok/s, peak memory, an MFU estimate."""
    tap, model = summary["tap"], summary["state"].model
    n = counted_params(model, cfg)
    if n != cfg.param_count():
        raise AssertionError(f"{name}: {n} parameters counted, want "
                             f"{cfg.param_count()}")
    losses, step_ms = check_lm_run(name, summary, cfg, batch, seq, steps,
                                   expect)
    tokens = batch * seq
    stats = summary["stats"]
    return {"params_counted": n, "param_count": cfg.param_count(),
            "params_total": sum(p.numel() for p in model.parameters()),
            "batch": batch, "seq": seq, "steps": len(tap["metrics"]),
            "losses": losses, "grad_norms": [m[1] for m in tap["metrics"]],
            "batches_checked": len(tap["batches"]), "step_ms": tap["ms"],
            "step_ms_median_2_on": step_ms,
            "tok_per_s": summary["tok_per_s"],
            "tok_per_s_steps_2_on": tokens / (step_ms / 1e3),
            "peak_mem_gb": summary["peak_mem_gb"],
            "trainer_utilization": summary["trainer_utilization"],
            "mfu_estimate_6NT_vs_dense_bf16_peak":
                6 * n * tokens / (step_ms / 1e3) / BF16_PEAK_FLOPS,
            "wall_seconds": summary["wall"],
            "launches": summary["launches"],
            "transformed": stats.stages["transform"].items}


def add_launches(*counts) -> dict:
    out: dict = {}
    for c in counts:
        for k, v in c.items():
            if v:
                out[k] = out.get(k, 0) + v
    return out


def ssm_main(root: str, expect, batch: int = LM_BATCH, seq: int = LM_SEQ,
             steps: int = LM_STEPS, prompt: int = SERVE_PROMPT,
             new: int = SERVE_NEW, check: int = SERVE_CHECK,
             extra_args=(), layers: int = SSM_MAIN_LAYERS) -> dict:
    """``mamba2_370m`` at full width, ``layers`` of 48 deep: the launcher
    with its preset (AdamW, microbatch 4), then ``launch.serve.main``
    (greedy) with ``teacher_forced_check`` at float32 compute on the same
    parameters (the bf16 one is a reading); the decode state's bytes
    against ``L B ((d_conv - 1) (d_inner + 2 G N) 2 + H N P 4)``, constant
    in length, and decode tok/s against its HBM bound (the parameters as
    stored, read once, and the state read and written)."""
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.models import ssm as ssm_lib

    reduced = "--reduced" in extra_args
    base = get_reduced(SSM_ARCH) if reduced else get_config(SSM_ARCH)
    cfg = dataclasses.replace(base, n_layers=min(layers, base.n_layers))
    tcfg = launch.train_preset(SSM_ARCH)
    summary = run_launcher(
        ["--arch", SSM_ARCH, "--batch", str(batch), "--seq", str(seq),
         "--steps", str(steps), "--etl-backend", "cuda",
         "--max-restarts", "0", *extra_args], cfg=cfg)
    state = summary["state"]
    if len(state.model.blocks) != cfg.n_layers:
        raise AssertionError("ssm_main: layers")
    train = {"microbatch": tcfg.microbatch, "optimizer": tcfg.optimizer,
             **train_readings("ssm_main", summary, cfg, batch, seq, steps,
                              expect)}
    dev = next(state.model.parameters()).device
    last = {k: v.to(dev) for k, v in summary["tap"]["batches"][-1].items()}
    step = launch.make_train_step(launch.build_model(cfg).loss, tcfg)
    train["profile_one_more_step"] = profile_step(lambda: step(state, last))
    del summary, state, last
    free_memory()
    summary = run_serve(["--arch", SSM_ARCH, "--batch", str(batch),
                         "--prompt-len", str(prompt), "--max-new", str(new),
                         *extra_args], cfg=cfg)
    serve_launches = check_prompts("ssm_main serve", summary, expect)
    module = summary["module"]
    # bf16 decode drifts from the chunked forward with depth and steps (a
    # float32 difference between the recurrence and the SSD moves bf16
    # roundings, and 48 recurrent layers carry them on): a reading; the
    # check runs at float32 compute on the same parameters
    tf = teacher_forced_check("ssm_main", summary, check, strict=False)
    with config_swapped(module, dataclasses.replace(
            cfg, compute_dtype="float32")):
        tf32 = teacher_forced_check("ssm_main", summary, check,
                                    greedy=False)
    cache = tf["cache"]
    d_inner, H, G, N, P = ssm_lib.dims(cfg)
    formula = cfg.n_layers * batch * ((cfg.ssm.d_conv - 1)
                                      * (d_inner + 2 * G * N) * 2
                                      + H * N * P * 4)
    state_bytes = tensor_bytes(cache)
    if state_bytes != formula or tensor_bytes(module.init_cache(
            batch, 16 * (prompt + new))) != formula:
        raise AssertionError(f"ssm_main: state {state_bytes} B, want "
                             f"{formula} at every length")
    pbytes = param_bytes(module)
    profile = profile_step(lambda: decode_once(summary["model"], module, tf))
    out = {"arch": SSM_ARCH, "reduced": reduced, "layers": cfg.n_layers,
           "layers_full": base.n_layers, "train": train,
           "serve": {**serve_readings(summary, pbytes + 2 * state_bytes),
                     "param_bytes": pbytes, "state_bytes": state_bytes,
                     "state_formula_bytes": formula,
                     "teacher_forced_bf16_reading": tf["check"],
                     "teacher_forced_float32": tf32["check"],
                     "launches": serve_launches,
                     "profile_one_decode_step": profile},
           "launches": add_launches(train["launches"], serve_launches)}
    return out


def vlm_main(root: str, expect, batch: int = LM_BATCH, seq: int = LM_SEQ,
             steps: int = VLM_STEPS, serve_batch: int = VLM_SERVE_BATCH,
             prompt: int = VLM_PROMPT, new: int = VLM_NEW,
             check: int = SERVE_CHECK, extra_args=()) -> dict:
    """``internvl2_2b`` at full width and depth (24 layers): the launcher
    (text only, as the reference's launcher feeds it; the preset's
    microbatch 2); one loss and backward on ``random_batch`` with
    ``n_patches`` (256) patch embeddings and ``seq - n_patches`` text
    tokens, whose loss must equal the cross-entropy over the text
    positions of the returned logits (rtol 1e-5) and whose gradients must
    be finite; then ``launch.serve.main`` (text-only, greedy) with
    ``teacher_forced_check``."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.models import api
    from repro_torch.models import layers as L
    from repro_torch.training.optimizer import global_norm

    reduced = "--reduced" in extra_args
    cfg = get_reduced(VLM_ARCH) if reduced else get_config(VLM_ARCH)
    tcfg = launch.train_preset(VLM_ARCH)
    summary = run_launcher(
        ["--arch", VLM_ARCH, "--batch", str(batch), "--seq", str(seq),
         "--steps", str(steps), "--etl-backend", "cuda",
         "--max-restarts", "0", *extra_args])
    model = summary["state"].model
    if len(model.blocks) != cfg.n_layers:
        raise AssertionError("vlm_main: layers")
    train = {"microbatch": tcfg.microbatch, "optimizer": tcfg.optimizer,
             **train_readings("vlm_main", summary, cfg, batch, seq, steps,
                              expect)}
    dev = next(model.parameters()).device
    rows = max(batch // max(tcfg.microbatch, 1), 1)
    b = api.random_batch(cfg, ShapeCfg("vlm", seq, rows, "train"), seed=0,
                         device=dev)
    P = b["patch_embeds"].shape[1]
    for p in model.parameters():
        p.grad = None
    loss = model.loss_fn(b)
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    gnorm = float(global_norm(grads))
    with torch.no_grad():
        logits = model(b["tokens"], b["patch_embeds"])
        ce = float(L.cross_entropy(logits[:, P:], b["labels"],
                                   valid_vocab=cfg.vocab_size))
    del logits, grads
    for p in model.parameters():
        p.grad = None
    loss = float(loss.detach())
    prefix = {"rows": rows, "patches": P, "text": b["tokens"].shape[1],
              "loss": loss, "ce_text_positions": ce,
              "grads_finite": finite, "grad_norm": gnorm}
    if not (finite and abs(loss - ce) <= 1e-5 * abs(ce)):
        raise AssertionError(f"vlm_main: prefix check {prefix}")
    del summary, model, b
    free_memory()
    summary = run_serve(["--arch", VLM_ARCH, "--batch", str(serve_batch),
                         "--prompt-len", str(prompt), "--max-new", str(new),
                         *extra_args])
    serve_launches = check_prompts("vlm_main serve", summary, expect)
    tf = teacher_forced_check("vlm_main", summary, check)
    module = summary["module"]
    out = {"arch": VLM_ARCH, "reduced": reduced, "layers": cfg.n_layers,
           "train": train, "prefix_loss_and_backward": prefix,
           "serve": {**serve_readings(summary, param_bytes(module)
                                      + tensor_bytes(tf["cache"])),
                     "teacher_forced": tf["check"],
                     "launches": serve_launches},
           "launches": add_launches(train["launches"], serve_launches)}
    return out


def hybrid_state_bytes(cfg, batch: int, max_len: int) -> int:
    """The hybrid's decode state by formula: the SSM's ``L B ((d_conv - 1)
    (d_inner + 2 G N) 2 + H N P 4)`` (bf16 convolution inputs, float32
    SSD state) and, per application of the shared block, its ring of
    ``min(window, max_len)`` slots ``2 B kv_len n_kv hd 2`` (+ ``pos``)."""
    from repro_torch.models import hybrid, ssm as ssm_lib
    from repro_torch.models import transformer as ttr
    d_inner, H, G, N, P = ssm_lib.dims(cfg)
    kv_len = ttr.cache_len(cfg, max_len)
    return cfg.n_layers * batch * ((cfg.ssm.d_conv - 1)
                                   * (d_inner + 2 * G * N) * 2
                                   + H * N * P * 4) \
        + hybrid.n_shared_applications(cfg) * (
            2 * batch * kv_len * cfg.n_kv_heads * cfg.hd * 2 + kv_len * 4)


def hybrid_main(root: str, expect, batch: int = LM_BATCH, seq: int = LM_SEQ,
                steps: int = HYBRID_STEPS,
                serve_batch: int = HYBRID_SERVE_BATCH,
                prompt: int = HYBRID_PROMPT, new: int = HYBRID_NEW,
                check: int = SERVE_CHECK, extra_args=(),
                layers: int = HYBRID_MAIN_LAYERS) -> dict:
    """``zamba2_2_7b`` at full width, ``layers`` of its 54 Mamba2 layers
    (one shared attention block applied after every 9): the launcher with
    its preset
    (AdamW, microbatch 4, full remat), then ``launch.serve.main`` (greedy)
    with a prompt of ``prompt`` tokens (the staged prompt kernels at 4096)
    and ``new`` decode steps, every one past the 4096-token ring's wrap;
    ``teacher_forced_check`` at float32 compute on the same parameters
    (the bf16 one is a reading); the state's bytes against
    ``hybrid_state_bytes`` at two lengths, and decode tok/s against its
    HBM bound (the parameters as stored, read once, the SSM state read and
    written, the rings read)."""
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.models import hybrid
    from repro_torch.models import transformer as ttr

    reduced = "--reduced" in extra_args
    base = get_reduced(HYBRID_ARCH) if reduced else get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(base, n_layers=min(layers, base.n_layers))
    tcfg = launch.train_preset(HYBRID_ARCH)
    summary = run_launcher(
        ["--arch", HYBRID_ARCH, "--batch", str(batch), "--seq", str(seq),
         "--steps", str(steps), "--etl-backend", "cuda",
         "--max-restarts", "0", *extra_args], cfg=cfg)
    state = summary["state"]
    if not isinstance(state.model, hybrid.Hybrid) or \
            len(state.model.blocks) != cfg.n_layers:
        raise AssertionError("hybrid_main: layers")
    train = {"microbatch": tcfg.microbatch, "optimizer": tcfg.optimizer,
             "remat": cfg.remat, "compute_dtype": cfg.compute_dtype,
             "shared_applications": hybrid.n_shared_applications(cfg),
             **train_readings("hybrid_main", summary, cfg, batch, seq,
                              steps, expect)}
    dev = next(state.model.parameters()).device
    last = {k: v.to(dev) for k, v in summary["tap"]["batches"][-1].items()}
    step = launch.make_train_step(launch.build_model(cfg).loss, tcfg)
    train["profile_one_more_step"] = profile_step(lambda: step(state, last))
    del summary, state, last, step
    free_memory()
    summary = run_serve(["--arch", HYBRID_ARCH, "--batch", str(serve_batch),
                         "--prompt-len", str(prompt), "--max-new", str(new),
                         *extra_args], cfg=cfg)
    serve_launches = check_prompts("hybrid_main serve", summary, expect)
    module = summary["module"]
    # as ssm_main's: the bf16 recurrence drifts from the chunked forward
    # over 54 layers (a reading); the check runs at float32 compute
    tf = teacher_forced_check("hybrid_main", summary, check, strict=False)
    with config_swapped(module, dataclasses.replace(
            cfg, compute_dtype="float32")):
        tf32 = teacher_forced_check("hybrid_main", summary, check,
                                    greedy=False)
    cache = tf["cache"]
    state_bytes = tensor_bytes(cache)
    lengths = {n: tensor_bytes(module.init_cache(serve_batch, n))
               for n in (prompt + new, prompt // 4)}
    for n, got in [(prompt + new, state_bytes), *lengths.items()]:
        if got != hybrid_state_bytes(cfg, serve_batch, n):
            raise AssertionError(f"hybrid_main: state {got} B at max_len "
                                 f"{n}, want "
                                 f"{hybrid_state_bytes(cfg, serve_batch, n)}")
    ring = cache["shared_kv"]
    kv_len = ttr.cache_len(cfg, prompt + new)
    wrapped = int((ring["pos"][0] >= kv_len).sum())
    if kv_len != cfg.sliding_window or wrapped != min(
            kv_len, prompt + check - kv_len):
        raise AssertionError(f"hybrid_main: ring of {kv_len}, {wrapped} "
                             "slots past the wrap")
    ring_bytes = tensor_bytes(ring)
    ssm_bytes = state_bytes - ring_bytes
    pbytes = param_bytes(module)
    profile = profile_step(lambda: decode_once(summary["model"], module, tf))
    return {"arch": HYBRID_ARCH, "reduced": reduced,
            "layers": cfg.n_layers, "layers_full": base.n_layers,
            "train": train,
            "serve": {**serve_readings(summary, pbytes + 2 * ssm_bytes
                                       + ring_bytes),
                      "param_bytes": pbytes, "state_bytes": state_bytes,
                      "ssm_state_bytes": ssm_bytes,
                      "ring_bytes": ring_bytes,
                      "state_formula_bytes_by_max_len": {
                          str(n): hybrid_state_bytes(cfg, serve_batch, n)
                          for n in (prompt + new, prompt // 4)},
                      "ring_len": kv_len,
                      "slots_rewritten_past_wrap": wrapped,
                      "teacher_forced_bf16_reading": tf["check"],
                      "teacher_forced_float32": tf32["check"],
                      "launches": serve_launches,
                      "profile_one_decode_step": profile},
            "launches": add_launches(train["launches"], serve_launches)}


def encdec_generate(model, module, frames, prompts, new: int,
                    max_len: int) -> dict:
    """Greedy serving of an enc-dec model (no launcher feeds its frames):
    ``Model.prefill`` on the frames and prompts, then ``new`` decode
    steps, positions on the host; the tokens, the phases' seconds and the
    cache."""
    import torch
    from repro_torch.serving.decode import next_token
    B, S = prompts.shape
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(module, {"frames": frames,
                                               "tokens": prompts}, max_len)
        tok = next_token(logits[:, -1])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out = []
        t0 = time.perf_counter()
        for i in range(new):
            out.append(tok)
            logits, cache = model.decode_step(module, cache, tok, S + i)
            tok = next_token(logits[:, -1])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, 1), "prefill_s": prefill_s,
            "decode_s": decode_s, "cache": cache, "next": tok,
            "next_pos": S + new}


def encdec_forced(model, module, frames, seq, S: int, n: int,
                  tol: float) -> dict:
    """``decode_train``'s logits at positions ``S - 1 .. S + n - 1`` (the
    encoder run once) against prefill of ``S`` tokens and ``n`` decode
    steps fed the same tokens: the largest difference within ``tol`` x
    the forward's largest magnitude."""
    import torch
    with torch.inference_mode():
        enc = module.encode(frames)
        fwd = module.decode_train(enc, seq[:, :S + n])[:, S - 1:].float()
        lg, cache = model.prefill(module, {"frames": frames,
                                           "tokens": seq[:, :S]}, S + n)
        dec = [lg[:, -1].float()]
        for i in range(n):
            lg, cache = model.decode_step(module, cache,
                                          seq[:, S + i:S + i + 1], S + i)
            dec.append(lg[:, -1].float())
        dec = torch.stack(dec, 1)
        largest = float(fwd.abs().max())
        err = float((dec - fwd).abs().max())
        differ = int((dec.argmax(-1) != fwd.argmax(-1)).sum())
    return {"positions": [S, S + n], "max_abs_err": err, "largest": largest,
            "tol": tol, "ok": err <= tol * largest,
            "argmax_differing": differ, "tokens_total": dec.shape[0] * (n + 1)}


def encdec_main(root: str, expect, batch: int = LM_BATCH,
                seq: int = ENCDEC_SEQ, steps: int = ENCDEC_STEPS,
                serve_batch: int = ENCDEC_SERVE_BATCH,
                prompt: int = ENCDEC_PROMPT, new: int = ENCDEC_NEW,
                check: int = SERVE_CHECK, reduced: bool = False) -> dict:
    """``whisper_base`` at full width and depth (6 + 6 layers, 1500
    frames).  Neither launcher can feed its frames (the reference's cannot
    either): both are shown to refuse it, then ``build_model`` and
    ``random_batch`` (``seq`` 448 decoder tokens and 1500 frames a row)
    train it ``steps`` steps with the preset (AdamW, microbatch 1), and it
    serves ``new`` greedy tokens from ``Model.prefill`` over prompts from
    ``launch.serve.make_prompt_job`` on the cuda backend (the ETL still
    feeds the path) and ``random_batch``'s frames.  Checks: finite losses
    and gradient norms, the parameter count, the prompt job's launches and
    batch, prefill + ``check`` decode steps against ``decode_train`` at
    float32 compute within ``FORCED_F32_TOL`` (bf16: a reading), the self
    and cross caches' bytes against their formulas; decode tok/s against
    its HBM bound (the parameters, both caches read)."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.kernels import dataflow as df
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as launch
    from repro_torch.models import api, encdec
    from repro_torch.training.train_loop import TrainState

    cfg = get_reduced(ENCDEC_ARCH) if reduced else get_config(ENCDEC_ARCH)
    refused = {}
    for name, fn in (("train", launch.main), ("serve", serve_launch.main)):
        try:
            fn(["--arch", ENCDEC_ARCH, *(["--reduced"] if reduced else [])])
        except ValueError as e:
            refused[name] = str(e)
        else:
            raise AssertionError(f"encdec_main: launch.{name} ran")
    tcfg = launch.train_preset(ENCDEC_ARCH)
    model = api.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    module = model.init(seed=0)
    dev = next(module.parameters()).device
    if not isinstance(module, encdec.EncDec) or \
            counted_params(module, cfg) != cfg.param_count():
        raise AssertionError("encdec_main: parameters")
    state = TrainState.create(module, tcfg)
    step = launch.make_train_step(model.loss, tcfg)
    shape = ShapeCfg("encdec", seq, batch, "train")
    batches = [api.random_batch(cfg, shape, seed=i, device=dev)
               for i in range(steps + 1)]
    metrics, ms = [], []
    for b in batches[:steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append((loss, gnorm))
    if not all(math.isfinite(x) for m in metrics for x in m):
        raise AssertionError(f"encdec_main: losses / norms {metrics}")
    profile = profile_step(lambda: step(state, batches[-1]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = sorted(ms[1:])[len(ms[1:]) // 2] if len(ms) > 1 else ms[0]
    n = cfg.param_count()
    tokens = batch * seq
    train = {"microbatch": tcfg.microbatch, "optimizer": tcfg.optimizer,
             "batch": batch, "seq": seq, "frames": cfg.enc_seq,
             "steps": steps, "losses": [m[0] for m in metrics],
             "grad_norms": [m[1] for m in metrics], "step_ms": ms,
             "step_ms_median_2_on": med,
             "tok_per_s_steps_2_on": tokens / (med / 1e3),
             "peak_mem_gb": peak, "param_count": n,
             # decoder tokens only: the encoder's 1500 frames a row are
             # another 6 N_enc frames of work each, not counted here
             "mfu_estimate_6NT_vs_dense_bf16_peak":
                 6 * n * tokens / (med / 1e3) / BF16_PEAK_FLOPS,
             "profile_one_more_step": profile}
    del state, step, batches, profile
    free_memory()

    job = serve_launch.make_prompt_job(cfg, batch=serve_batch,
                                       prompt_len=prompt, backend="cuda",
                                       device=dev)
    df.reset_launch_counts()
    with job.batches() as it:
        prompts = next(iter(it))["tokens"]
    torch.cuda.synchronize()
    serve_launches = check_prompts(
        "encdec_main serve", {"prompts": prompts, "cfg": cfg,
                              "launches": dict(df.LAUNCHES), "job": job,
                              "etl": job.stats()}, expect)
    frames = api.random_batch(cfg, ShapeCfg("encdec", prompt, serve_batch,
                                            "prefill"), seed=7,
                              device=dev)["frames"]
    max_len = prompt + new
    torch.cuda.reset_peak_memory_stats()
    served = encdec_generate(model, module, frames, prompts, new, max_len)
    peak = torch.cuda.max_memory_allocated() / 1e9
    seq_all = torch.cat([prompts, served["tokens"].to(prompts.dtype)], 1)
    bf16 = encdec_forced(model, module, frames, seq_all, prompt, check,
                         SERVE_TOL)
    with config_swapped(module, dataclasses.replace(
            cfg, compute_dtype="float32")):
        f32 = encdec_forced(model, module, frames, seq_all, prompt, check,
                            FORCED_F32_TOL)
    if not f32["ok"]:
        raise AssertionError(f"encdec_main: decode vs forward {f32}")
    cache = served["cache"]
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    want = {"self": 2 * L * serve_batch * max_len * kv * hd * 2
            + L * max_len * 4,
            "cross": 2 * L * serve_batch * cfg.enc_seq * kv * hd * 2}
    got = {k: tensor_bytes(cache[k]) for k in want}
    if got != want:
        raise AssertionError(f"encdec_main: cache bytes {got}, want {want}")
    pbytes = param_bytes(module)
    bound_ms = (pbytes + sum(got.values())) / HBM_BYTES_PER_S * 1e3
    step_ms = served["decode_s"] / new * 1e3
    profile = profile_step(lambda: decode_once(model, module, served))
    return {"arch": ENCDEC_ARCH, "reduced": reduced,
            "layers": [cfg.enc_layers, cfg.n_layers],
            "launchers_refuse": refused, "train": train,
            "serve": {"batch": serve_batch, "prompt_len": prompt,
                      "max_new": new, "prefill_s": served["prefill_s"],
                      "decode_s": served["decode_s"],
                      "decode_tok_per_s": serve_batch * new
                      / served["decode_s"],
                      "decode_step_ms": step_ms,
                      "decode_step_bound_ms": bound_ms,
                      "decode_share_of_bound": bound_ms / step_ms,
                      "param_bytes": pbytes, "cache_bytes": got,
                      "peak_mem_gb": peak,
                      "first_sequence":
                          served["tokens"][0][:16].tolist(),
                      "teacher_forced_bf16_reading": bf16,
                      "teacher_forced_float32": f32,
                      "launches": serve_launches,
                      "profile_one_decode_step": profile},
            "launches": serve_launches}


def free_port() -> int:
    """A free TCP port on this host (the ranks' rendezvous)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_entry(rank, world, backend, port, fn, args, q) -> None:
    """One rank: the environment ``torchrun`` sets (every rank on card 0),
    a gloo group joined here (an NCCL one is the launcher's to make, as
    under ``torchrun``), ``fn(*args)``, and its result or traceback put on
    ``q``."""
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        if backend == "gloo":
            dist.init_process_group("gloo")
        q.put((rank, "ok", fn(*args)))
    except BaseException:  # reported, and the phase fails
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def alloc_conf(conf: str):
    """Within: ranks started (spawned) take ``conf`` as their CUDA
    allocator's settings (``PYTORCH_CUDA_ALLOC_CONF``); this process's
    allocator, set up already, keeps its own."""
    key = "PYTORCH_CUDA_ALLOC_CONF"
    prev = os.environ.get(key)
    os.environ[key] = conf
    try:
        yield
    finally:
        if prev is None:
            del os.environ[key]
        else:
            os.environ[key] = prev


def start_ranks(fn, world: int, backend: str, args: tuple) -> tuple:
    """``fn(*args)`` started on ``world`` spawned ranks (``rank_entry``);
    ``join_ranks`` takes what this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_entry,
                         args=(r, world, backend, port, fn, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    return fn, world, procs, q


def run_ranks(fn, world: int, backend: str, args: tuple,
              timeout: float) -> list:
    """``fn(*args)`` on ``world`` spawned ranks (``rank_entry``); their
    results by rank (``join_ranks``)."""
    return join_ranks(start_ranks(fn, world, backend, args), timeout)


def join_ranks(started: tuple, timeout: float) -> list:
    """The results by rank of ``start_ranks``' ranks.  Raises on a rank's
    error or after ``timeout`` seconds from now, and leaves no rank
    running."""
    import queue

    fn, world, procs, q = started
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world and time.monotonic() < deadline:
            try:
                r, status, out = q.get(timeout=1.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            (got if status == "ok" else errors)[r] = out
            if errors:  # the others would wait in a collective
                deadline = min(deadline, time.monotonic() + 10)
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or len(got) < world:
        raise AssertionError(f"{fn.__name__}: ranks {sorted(got)} done of "
                             f"{world}; " + "".join(
                                 f"\n--- rank {r} ---\n{e}"
                                 for r, e in sorted(errors.items())))
    return [got[r] for r in range(world)]


def launcher_readings(summary: dict, cfg, seq: int, n_micro: int,
                      profile: bool = True) -> dict:
    """What a dist phase reads from one rank's launcher run (on that
    rank): losses, steps, the launches its ETL made and those its
    lowering means, peak memory, one more step profiled (with
    ``profile``); and every delivered batch checked: the rank's rows
    (``put_packed``'s selection at ``n_micro`` microbatches) of the plain
    compile's batch."""
    import torch
    from repro_torch.core.pipeline import lm_token_pipeline
    from repro_torch.data.source import Source
    from repro_torch.distributed import sharding as shd
    from repro_torch.etl_runtime.transfer import batch_sharding, put_packed

    tap, state = summary["tap"], summary["state"]
    batch = tap["batches"][0]["tokens"].shape[0]
    transformed = summary["stats"].stages["transform"].items
    mesh = shd.get_active_mesh()
    full = batch * shd.data_degree(mesh)
    plain = lm_token_pipeline(seq, cfg.vocab_size,
                              batch_size=full).compile("cuda", device="cpu")
    raws = Source.lm_events(seq, rows=full * (len(tap["batches"]) + 4),
                            batch_size=full)
    for i, (got, raw) in enumerate(zip(tap["batches"], raws)):
        want = put_packed(plain(raw), batch_sharding(mesh),
                          microbatches=n_micro)
        for k, w in want.items():
            if not torch.equal(got[k], w):
                raise AssertionError(f"batch {i} {k}: not this rank's rows "
                                     "of the plain compile")
    last = {k: v.to(next(state.model.parameters()).device)
            for k, v in tap["batches"][-1].items()}
    steps, step = state.step, tap["step"]
    profiled = profile_step(lambda: step(state, last)) if profile else {}
    ms = sorted(tap["ms"][1:])
    return {"losses": [m[0] for m in tap["metrics"]],
            "grad_norms": [m[1] for m in tap["metrics"]],
            "steps": steps, "step_ms": tap["ms"],
            "step_ms_median_2_on": ms[len(ms) // 2] if ms else float("nan"),
            "tok_per_s": summary["tok_per_s"],
            "peak_mem_gb": summary["peak_mem_gb"],
            "launches": summary["launches"],
            "launches_want": lm_launches(summary["job"].compiled,
                                         transformed),
            "batches_checked": len(tap["batches"]),
            "profile_one_more_step": {k: v for k, v in profiled.items()
                                      if k != "top_ops"}}


def dist_main_rank(argv: list, cfg, seq: int, n_micro: int) -> dict:
    """``dist_main``'s rank: the launcher under ``WORLD_SIZE`` (NCCL)."""
    return launcher_readings(run_launcher(argv, cfg=cfg), cfg, seq, n_micro)


def dist_main(root: str, expect, batch: int = LM_BATCH, seq: int = LM_SEQ,
              steps: int = DIST_STEPS, layers: int = DIST_LAYERS,
              extra_args=()) -> dict:
    """``launch.train --mesh host`` on one spawned NCCL rank at
    ``mixtral_8x7b``'s full width, ``layers`` of 32 (the preset: FSDP,
    AdamW, microbatch 4): the launcher shards through ``shard_train_step``
    (FSDP2 over a data mesh of 1) and places through ``EtlJob(mesh=)``.
    The same cut run without a process group first, in this process: the
    rank's losses within ``LM_CHECK_RTOL["loss"]`` of it.  Readings: step
    ms at world 1 and without a group, tok/s, peak GB, one profiled step's
    idle share and the NCCL kernels' share of its device time."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch

    reduced = "--reduced" in extra_args
    base = get_reduced(DIST_ARCH) if reduced else get_config(DIST_ARCH)
    cfg = dataclasses.replace(base, n_layers=layers)
    tcfg = launch.train_preset(DIST_ARCH)
    argv = ["--arch", DIST_ARCH, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--etl-backend", "cuda",
            "--max-restarts", "0", "--mesh", "host", *extra_args]
    alone = run_launcher(argv, cfg=cfg)
    want = [m[0] for m in alone["tap"]["metrics"]]
    ms = sorted(alone["tap"]["ms"][1:])
    alone_ms = ms[len(ms) // 2] if ms else float("nan")
    del alone
    free_memory()
    (rank,) = run_ranks(dist_main_rank, 1, "nccl",
                        (argv, cfg, seq, tcfg.microbatch), timeout=600)
    expect(rank["launches"], rank["launches_want"], "dist_main")
    diff = [abs(a - b) / abs(b) for a, b in zip(rank["losses"], want)]
    if len(rank["losses"]) != steps or max(diff) > LM_CHECK_RTOL["loss"]:
        raise AssertionError(f"dist_main: losses {rank['losses']} vs "
                             f"{want} without a process group")
    return {"arch": DIST_ARCH, "reduced": reduced, "layers": layers,
            "layers_full": base.n_layers, "world": 1, "backend": "nccl",
            "fsdp": tcfg.fsdp, "microbatch": tcfg.microbatch,
            "batch": batch, "seq": seq, "losses_no_group": want,
            "loss_max_rel_diff": max(diff),
            "step_ms_median_2_on_no_group": alone_ms, **rank}


def dist_kimi_rank(argv: list, cfg, seq: int, n_micro: int) -> dict:
    """``dist_kimi``'s rank: the launcher under ``WORLD_SIZE`` (NCCL), then
    the dtype of each FSDP unit and the Adafactor state's bytes."""
    from repro_torch.training.train_loop import unit_dtypes

    summary = run_launcher(argv, cfg=cfg)
    state = summary["state"]
    out = launcher_readings(summary, cfg, seq, n_micro, profile=False)
    out["unit_dtypes"] = {k: str(v) for k, v in
                          unit_dtypes(state.model).items()}
    out["opt_state_bytes"] = sum(
        getattr(t, "to_local", lambda t=t: t)().numel() * t.element_size()
        for st in state.opt["f"] for t in st.values())
    return out


def dist_kimi(root: str, expect, batch: int = KIMI_BATCH,
              seq: int = LM_SEQ, steps: int = KIMI_STEPS,
              layers: int = KIMI_LAYERS, experts: int = KIMI_EXPERTS,
              extra_args=()) -> dict:
    """``launch.train --mesh host`` on one spawned NCCL rank at
    ``kimi_k2``'s full width (bfloat16 parameters, the float32 router),
    ``layers`` of 61 and ``experts`` of 384, its preset (FSDP2 over a data
    mesh of 1, Adafactor with bfloat16 state and accumulation, microbatch
    16): each block's float32 router an FSDP unit of its own beside the
    block's bfloat16 unit.  The same cut run without a process group
    first, in this process.  Checks: the rank's losses within
    ``LM_CHECK_RTOL["loss"]`` of it, every FSDP unit of one dtype and the
    routers' float32, the ETL's launches, every batch the plain compile's.
    Readings: step ms at world 1 and without a group, peak GB, the
    Adafactor state's bytes."""
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch

    reduced = "--reduced" in extra_args
    base = get_reduced(KIMI_ARCH) if reduced else get_config(KIMI_ARCH)
    cfg = dataclasses.replace(base, n_layers=layers, moe=dataclasses.replace(
        base.moe, n_experts=experts))
    tcfg = launch.train_preset(KIMI_ARCH)
    argv = ["--arch", KIMI_ARCH, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--etl-backend", "cuda",
            "--max-restarts", "0", "--mesh", "host", *extra_args]
    alone = run_launcher(argv, cfg=cfg)
    want = [m[0] for m in alone["tap"]["metrics"]]
    ms = sorted(alone["tap"]["ms"][1:])
    alone_ms = ms[len(ms) // 2] if ms else float("nan")
    alone_peak = alone["peak_mem_gb"]
    del alone
    free_memory()
    (rank,) = run_ranks(dist_kimi_rank, 1, "nccl",
                        (argv, cfg, seq, tcfg.microbatch), timeout=600)
    expect(rank["launches"], rank["launches_want"], "dist_kimi")
    diff = [abs(a - b) / abs(b) for a, b in zip(rank["losses"], want)]
    if len(rank["losses"]) != steps or max(diff) > LM_CHECK_RTOL["loss"]:
        raise AssertionError(f"dist_kimi: losses {rank['losses']} vs "
                             f"{want} without a process group")
    units = rank["unit_dtypes"]
    routers = {k for k in units if k.endswith("moe.gate")}
    if len(routers) != layers - cfg.moe.first_dense_layers or any(
            units[k] != "torch.float32" for k in routers) or any(
            v != "torch.bfloat16" for k, v in units.items()
            if k not in routers):
        raise AssertionError(f"dist_kimi: FSDP units {units}")
    return {"arch": KIMI_ARCH, "reduced": reduced, "layers": layers,
            "layers_full": base.n_layers, "experts": experts,
            "experts_full": base.moe.n_experts, "world": 1,
            "backend": "nccl", "fsdp": tcfg.fsdp,
            "optimizer": tcfg.optimizer,
            "opt_state_dtype": tcfg.opt_state_dtype,
            "accum_dtype": tcfg.accum_dtype, "microbatch": tcfg.microbatch,
            "param_dtype": cfg.param_dtype, "batch": batch, "seq": seq,
            "losses_no_group": want, "loss_max_rel_diff": max(diff),
            "step_ms_median_2_on_no_group": alone_ms,
            "peak_mem_gb_no_group": alone_peak, **rank}


def dist_ranks2_rank(argv: list, cfg, seq: int, n_micro: int) -> dict:
    """``dist_ranks2``'s rank: the launcher on a gloo world over CUDA
    tensors; before the first step, ``compressed_psum_mean`` over this
    rank's gradients of the first block (its own batch rows, no reduction)
    on the card and on the CPU (the same group: gloo takes both)."""
    import torch
    from repro_torch.training.grad import (compressed_psum_mean, ef_init,
                                           microbatched_value_and_grad)

    def int8_check(state, b, loss_fn):
        params = list(state.model.parameters())
        first = {id(p) for p in state.model.blocks[0].parameters()}
        idx = [i for i, p in enumerate(params) if id(p) in first]
        _, grads = microbatched_value_and_grad(
            loss_fn, n_micro, accum_dtype="float32")(state.model, b)
        g = [grads[i] for i in idx]
        del grads
        card = compressed_psum_mean(g, ef_init(g))
        cpu_in = [t.cpu() for t in g]
        cpu = compressed_psum_mean(cpu_in, ef_init(cpu_in))
        equal = all(torch.equal(a.cpu(), b) for x, y in zip(card, cpu)
                    for a, b in zip(x, y))
        return {"leaves": len(g), "elements": sum(t.numel() for t in g),
                "bit_equal": equal,
                "max_abs_diff_mean": max(float((a.cpu() - b).abs().max())
                                         for a, b in zip(card[0], cpu[0]))}

    summary = run_launcher(argv, cfg=cfg, on_first=int8_check)
    out = launcher_readings(summary, cfg, seq, n_micro)
    out["int8_mean_card_vs_cpu"] = summary["tap"]["first"]
    return out


def dist_ranks2(root: str, expect, batch: int = LM_BATCH, seq: int = LM_SEQ,
                steps: int = DIST2_STEPS, layers: int = DIST2_LAYERS,
                extra_args=()) -> dict:
    """``launch.train --mesh host`` on two spawned ranks on the one card,
    gloo over CUDA tensors, at ``llama3_2_3b``'s full width, ``layers``
    of 28 (the preset: replicated parameters, one gradient all-reduce a
    step, microbatch 2).  The same cut run
    without a process group first, in this process.  Checks: each rank's
    batches its rows of the plain compile's (put_packed's selection), the
    ranks' global losses within ``LM_CHECK_RTOL["loss"]`` of the run
    without a group, and ``compressed_psum_mean`` over the first block's
    gradients bit-equal card vs CPU."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch

    reduced = "--reduced" in extra_args
    base = get_reduced(DIST2_ARCH) if reduced else get_config(DIST2_ARCH)
    cfg = dataclasses.replace(base, n_layers=layers)
    tcfg = launch.train_preset(DIST2_ARCH)
    argv = ["--arch", DIST2_ARCH, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--etl-backend", "cuda",
            "--max-restarts", "0", "--mesh", "host", *extra_args]
    alone = run_launcher(argv, cfg=cfg)
    want = [m[0] for m in alone["tap"]["metrics"]]
    ms = sorted(alone["tap"]["ms"][1:])
    alone_ms = ms[len(ms) // 2] if ms else float("nan")
    del alone
    free_memory()
    ranks = run_ranks(dist_ranks2_rank, 2, "gloo",
                      (argv, cfg, seq, tcfg.microbatch), timeout=600)
    diff = 0.0
    for r, out in enumerate(ranks):
        expect(out["launches"], out["launches_want"], f"dist_ranks2 rank {r}")
        if len(out["losses"]) != steps:
            raise AssertionError(f"dist_ranks2: rank {r} ran "
                                 f"{len(out['losses'])} steps")
        diff = max([diff] + [abs(a - b) / abs(b)
                             for a, b in zip(out["losses"], want)])
        if not out["int8_mean_card_vs_cpu"]["bit_equal"]:
            raise AssertionError(f"dist_ranks2: rank {r} int8 mean card vs "
                                 f"CPU {out['int8_mean_card_vs_cpu']}")
    if diff > LM_CHECK_RTOL["loss"]:
        raise AssertionError(f"dist_ranks2: losses {ranks[0]['losses']} vs "
                             f"{want} without a process group")
    return {"arch": DIST2_ARCH, "reduced": reduced, "layers": layers,
            "layers_full": base.n_layers, "world": 2, "backend": "gloo",
            "fsdp": tcfg.fsdp, "microbatch": tcfg.microbatch,
            "batch": batch, "seq": seq, "losses_no_group": want,
            "loss_max_rel_diff": diff,
            "step_ms_median_2_on_no_group": alone_ms,
            "launches": add_launches(*(o["launches"] for o in ranks)),
            "ranks": ranks}


@contextlib.contextmanager
def counting_routes():
    """Within: every MoE routing's kept and routed (token, expert) pairs,
    summed on the device (``tally``)."""
    from repro_torch.models import moe

    real = moe.route
    tally: dict = {"kept": 0, "routed": 0}

    def counted(p, xf, cfg, cap):
        r = real(p, xf, cfg, cap)
        tally["kept"] = tally["kept"] + r["keep"].sum()
        tally["routed"] += r["keep"].numel()
        return r

    moe.route = counted
    try:
        yield tally
    finally:
        moe.route = real


def drop_share(tally: dict) -> float:
    return 1.0 - float(tally["kept"]) / max(tally["routed"], 1)


def leaf_digests(model) -> dict:
    """``{name: sha256 of its bytes}`` of each parameter held whole on
    this rank (no model shard; an FSDP parameter's local shard), and
    ``{name: shape}`` of the model shards."""
    import hashlib

    import torch
    from repro_torch.distributed import tensor_parallel as tp

    whole, shards = {}, {}
    for name, p in model.named_parameters():
        if tp.shard_of(p)[0] is not None:
            shards[name] = list(p.shape)
            continue
        t = (p.to_local() if hasattr(p, "to_local") else p).detach()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        whole[name] = hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    return {"whole": whole, "shards": shards}


def traffic_per_step(steps: int) -> dict:
    """The model axis' collectives since the last reset, per step: bytes
    and calls of each kind."""
    from repro_torch.distributed import tensor_parallel as tp
    return {k: {"bytes": b / steps, "calls": n / steps}
            for k, (b, n) in tp.TRAFFIC.items()}


@contextlib.contextmanager
def preset_with(tcfg):
    """Within: the launcher trains with ``tcfg`` whatever the arch's
    preset (None: the preset)."""
    from repro_torch.launch import train as launch

    real = launch.train_preset
    if tcfg is not None:
        launch.train_preset = lambda arch: tcfg
    try:
        yield
    finally:
        launch.train_preset = real


def weight_gathered_shares(module, mesh, cfg) -> dict:
    """Before ``shard_for_serving(fsdp=True)``: the bytes of ``module``'s
    parameters this rank's ``param_specs(fsdp=True)`` share holds, and
    those a decode step's data-group gathers carry: each data-sharded
    leaf's model-local whole bytes once, a tied embedding twice (the
    lookup and the head)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import jax_leaves

    sizes = shd.axis_sizes(mesh)
    moe = getattr(cfg, "moe", None)

    def share(shape, spec, axes):
        n = list(shape)
        for d, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a in axes:
                    n[d] //= sizes[a]
        return math.prod(n)

    held = gathered = 0
    for path, leaf in jax_leaves(module.jax_tree()):
        shape = shd.leaf_shape(leaf)
        size = (leaf[0] if isinstance(leaf, list) else leaf).element_size()
        spec = shd.param_spec(path, shape, sizes, fsdp=True,
                              n_experts=moe.n_experts if moe else 0)
        held += share(shape, spec, tuple(sizes)) * size
        if shd.data_dim(spec) is not None:
            tied = path == "embed" and cfg.tie_embeddings
            gathered += share(shape, spec, ("model",)) * size * (1 + tied)
    return {"param_bytes": held, "gathered_a_step": gathered}


def axis_serve(cfg, batch: int = AXIS_SERVE_BATCH,
               prompt: int = AXIS_SERVE_PROMPT, new: int = AXIS_SERVE_NEW,
               forced: dict = None, compute_dtype: str = None,
               tol: float = SERVE_TOL, strict: bool = True,
               fsdp: bool = False) -> dict:
    """Serve one prompt batch at ``cfg``: the prompts from the LM token
    pipeline (``launch.serve.make_prompt_job`` on the cuda backend; an
    enc-dec model's frames from ``random_batch``), a module from seed 0,
    sharded for serving (``tensor_parallel.shard_for_serving``) where the
    active mesh has a model axis, prefill and ``new`` decode steps, each
    timed to a synchronize.  On a data degree dp > 1 this rank serves its
    row shard (its ``batch // dp`` rows).

    ``fsdp``: weight-gathered serving on the active mesh
    (``shard_for_serving(fsdp=True)``): the rank must hold its
    ``param_specs(fsdp=True)`` share of the parameters, and its gathers
    over the data axes must carry ``weight_gathered_shares``' bytes a
    decode step; then ``hlo_cost.analyze`` of one more prefill (a cache of
    the prompt's length) and its peak memory, the numbers the dry run's
    trace of the same cell is held to.

    Without ``forced`` (one process) the steps are greedy; the readings
    carry ``forced``: the tokens fed, the last-token logits (on the host)
    and each MoE routing's expert choices.  With ``forced`` (another run's,
    e.g. one process's) the steps are fed its tokens and the routing takes
    its choices (a bf16 router input that differs in its last bits may
    pick another expert near a tie, which moves a token's logits by far
    more than the tolerance): the logits within ``tol`` x the largest of
    ``forced``'s, this run's own greedy tokens equal to ``forced``'s
    wherever its top-2 margin exceeds that bound, and the rows whose own
    choice differs within ``MOE_FLIP_SHARE`` (with ``strict=False`` a
    reading, nothing asserted).  ``compute_dtype`` replaces the config's.
    Readings:
    prefill ms, decode step ms (median), the step's HBM bound (this
    process's parameters as stored plus its cache, read once) and its
    share, the prompt job's launches and those its lowering means."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.distributed import hlo_cost
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import dataflow as df
    from repro_torch.launch.serve import make_prompt_job
    from repro_torch.models import api
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.decode import next_token

    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    model = api.build_model(cfg)
    module = model.init(seed=0)
    dev = next(module.parameters()).device
    mesh = shd.get_active_mesh()
    fsdp = fsdp and mesh is not None
    shares = weight_gathered_shares(module, mesh, cfg) if fsdp else None
    if tp.model_axis(mesh) is not None or fsdp:
        tp.shard_for_serving(module, mesh, fsdp=fsdp)
    dp, rows, data_rank = shd.data_degree(mesh), slice(None), 0
    if dp > 1 and batch % dp == 0:
        data_rank = tp.data_axis(mesh).rank
        rows = slice(data_rank * batch // dp, (data_rank + 1) * batch // dp)
    torch.cuda.reset_peak_memory_stats()
    df.reset_launch_counts()
    job = make_prompt_job(cfg, batch=batch, prompt_len=prompt,
                          backend="cuda", device=dev)
    with job.batches() as ex:
        inputs = {"tokens": next(iter(ex))["tokens"][rows].clone()}
    launches = dict(df.LAUNCHES)
    want = lm_launches(job.compiled, job.stats().stages["transform"].items)
    if cfg.family == "encdec":
        inputs["frames"] = api.random_batch(
            cfg, ShapeCfg("serve", prompt, batch, "prefill"), seed=0,
            device=dev)["frames"][rows]
    real_top_k = moe_lib.top_k
    pins = list(forced["choices"]) if forced else []
    choices, flips = [], []

    def record(probs, k):
        vals, idx = real_top_k(probs, k)
        choices.append(idx.cpu())
        return vals, idx

    def pinned(probs, k):
        _, own = real_top_k(probs, k)
        idx = pins.pop(0).to(own.device)
        flips.append(int((own != idx).any(-1).sum()))
        return probs.gather(-1, idx), idx

    logits, tokens, step_ms = [], [], []
    moe_lib.top_k = pinned if forced else record
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.prefill(module, inputs, prompt + new)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            tp.reset_traffic()
            logits.append(lg[:, -1])
            for i in range(new):
                tokens.append(next_token(lg[:, -1]))
                fed = forced["tokens"][rows, i:i + 1].to(dev) if forced \
                    else tokens[-1]
                t0 = time.perf_counter()
                lg, cache = model.decode_step(module, cache, fed, prompt + i)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(lg[:, -1])
    finally:
        moe_lib.top_k = real_top_k
    if pins:
        raise AssertionError(f"{cfg.name}: {len(pins)} expert choices unused")
    logits = torch.stack(logits, 1)
    tokens = torch.cat(tokens, 1)
    step = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    bound_bytes = param_bytes(module) + tensor_bytes(cache)
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    out = {"batch": batch, "prompt_len": prompt, "new": new,
           "rows": [rows.start or 0, rows.stop or batch],
           "data_rank": data_rank, "peak_gb":
           torch.cuda.max_memory_allocated() / 1e9,
           "compute_dtype": cfg.compute_dtype,
           "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
           "decode_step_ms_median_2_on": step,
           "param_bytes": param_bytes(module),
           "cache_bytes": tensor_bytes(cache),
           "decode_step_bound_ms": bound_ms,
           "decode_share_of_bound": bound_ms / step,
           "tokens": tokens.cpu().tolist(),
           "launches": launches, "launches_want": want}
    if fsdp:
        gathered = tp.TRAFFIC["data_all_gather"][0] / new
        held = param_bytes(module)
        out["weight_gathered"] = dict(
            param_bytes=held, param_bytes_want=shares["param_bytes"],
            gathered_a_step=gathered,
            gathered_a_step_want=shares["gathered_a_step"])
        if held != shares["param_bytes"] or \
                gathered != shares["gathered_a_step"]:
            raise AssertionError(f"{cfg.name}: weight-gathered "
                                 f"{out['weight_gathered']}")
        del cache, lg
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            cost = hlo_cost.analyze(model.prefill, module, inputs, prompt)
        torch.cuda.synchronize()
        out["analyzed_prefill"] = {
            "flops": cost["flops"], "bytes_accessed": cost["bytes_accessed"],
            "collective_bytes": cost["collective_bytes"],
            "n_collectives": cost["n_collectives"], "param_bytes": held,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if not forced:
        out["forced"] = {"tokens": tokens.cpu(), "logits": logits.cpu(),
                         "choices": choices}
        return out
    with torch.inference_mode():
        got = logits.float()
        ref = forced["logits"][rows].to(dev).float()
        largest = float(ref.abs().max())
        err = (got - ref).abs().amax(dim=(0, 2))  # per position
        top2 = torch.topk(ref[:, :new], 2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > tol * largest
        wrong = sure & (tokens != forced["tokens"][rows].to(dev))
    out["teacher_forced"] = {
        "max_abs_err": float(err.max()), "largest": largest,
        "tol": tol, "asserted": strict,
        "max_abs_err_by_position": [float(e) for e in err],
        "tokens_checked": int(sure.sum()), "tokens_total": sure.numel(),
        "tokens_differing": int(wrong.sum())}
    if flips:
        rows = sum(int(c.shape[0]) for c in forced["choices"])
        out["routing_pinned"] = {"rows": rows,
                                 "own_choice_differs": sum(flips),
                                 "bound_share": MOE_FLIP_SHARE}
        if strict and sum(flips) > MOE_FLIP_SHARE * rows:
            raise AssertionError(f"{cfg.name}: routing "
                                 f"{out['routing_pinned']}")
    if strict and (not float(err.max()) <= tol * largest
                   or int(wrong.sum())):
        raise AssertionError(f"{cfg.name}: served on the model axis vs one "
                             f"process {out['teacher_forced']}")
    return out


def serving_runs(cfg, serve_kw: dict) -> list:
    """A phase's ``axis_serve`` runs (keywords each): bf16 compute within
    ``SERVE_TOL``.  The SSM and hybrid families' bf16 recurrence drifts
    with depth between two orders of the row-parallel sums (zamba2's 18
    layers on an H100: 4.4 % of the largest logit against a bound of 3 %;
    mamba2's 8: 2.3 %), as ssm_main's and
    hybrid_main's decode does from their forward: that run is a reading,
    and a float32 run of ``AXIS_F32_NEW`` steps on the same parameters is
    held to ``FORCED_F32_TOL``, as their check is."""
    if cfg.ssm is None:
        return [dict(serve_kw)]
    return [dict(serve_kw, strict=False),
            dict(serve_kw, compute_dtype="float32", tol=FORCED_F32_TOL,
                 new=min(serve_kw.get("new", AXIS_SERVE_NEW), AXIS_F32_NEW))]


def axis_serve_alone(cfg, tmp: str, runs: list) -> tuple:
    """Each of ``runs`` (``serving_runs``) through ``axis_serve`` in this
    process (no model axis), its ``forced`` saved under ``tmp`` for the
    ranks: ``(readings, [(path, keywords)])``."""
    import torch
    from repro_torch.distributed import sharding as shd

    shd.set_active_mesh(None)
    readings, paths = [], []
    for i, kw in enumerate(runs):
        out = axis_serve(cfg, **kw)
        path = os.path.join(tmp, f"serve_{i}.pt")
        torch.save(out.pop("forced"), path)
        readings.append(out)
        paths.append((path, kw))
        free_memory()
    return readings, paths


def axis_serve_check(name: str, alone: list, ranks: list, expect) -> list:
    """The serving readings of one process and of the ranks, run by run:
    the greedy tokens of the ranks of one data coordinate identical, every
    run's prompt launches those its lowering means; the readings side by
    side."""
    out = []
    for i, one in enumerate(alone):
        serves = [r["serve"][i] for r in ranks]
        first = {}
        for s in serves:
            if first.setdefault(s["data_rank"], s["tokens"]) != s["tokens"]:
                raise AssertionError(f"{name}: the ranks of data "
                                     f"coordinate {s['data_rank']} chose "
                                     "different tokens")
        expect(one.pop("launches"), one.pop("launches_want"),
               f"{name} serve alone")
        for s in serves:
            s.pop("tokens")
        one.pop("tokens")
        out.append({"compute_dtype": one["compute_dtype"],
                    "one_process": one, "ranks": serves,
                    "tokens_identical_across_ranks": True,
                    "decode_step_ms_vs_one_process": [
                        s["decode_step_ms_median_2_on"]
                        / one["decode_step_ms_median_2_on"]
                        for s in serves]})
    for r in ranks:
        del r["serve"]
    return out


def serve_on_rank(out: dict, cfg, runs: list) -> dict:
    """``axis_serve`` on this rank fed each one-process run of ``runs``
    (``[(path, keywords)]``, ``axis_serve_alone``'s); the readings go to
    ``out["serve"]``, the prompt launches into ``out``'s."""
    import torch

    out["serve"] = []
    for path, kw in runs:
        free_memory()
        serve = axis_serve(cfg, forced=torch.load(path), **kw)
        out["launches"] = add_launches(out["launches"],
                                       serve.pop("launches"))
        out["launches_want"] = add_launches(out["launches_want"],
                                            serve.pop("launches_want"))
        out["serve"].append(serve)
    return out


def model_axis_train(argv: list, cfg, seq: int, tcfg, steps: int) -> dict:
    """The launcher under ``WORLD_SIZE`` (gloo over CUDA tensors) on
    ``make_host_mesh(model_axis=2)`` (two ranks: a (1, 2) mesh; four: (2,
    2)), training with ``tcfg``: its readings (``launcher_readings``),
    the collectives' traffic a step, the MoE drop share, the digests of
    the leaves it holds whole, and its train state (``"state"``)."""
    import torch
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import train as launch

    real = launch.make_host_mesh
    launch.make_host_mesh = lambda device=None: real(model_axis=2,
                                                     device=device)
    tp.reset_traffic()
    try:
        with counting_routes() as tally, preset_with(tcfg):
            summary = run_launcher(argv, cfg=cfg)
    finally:
        launch.make_host_mesh = real
    traffic = traffic_per_step(steps)
    digests = leaf_digests(summary["state"].model)
    out = launcher_readings(summary, cfg, seq, tcfg.microbatch)
    out.update(collectives_per_step=traffic, leaves=digests,
               drop_share=drop_share(tally) if tally["routed"] else None,
               device=torch.cuda.get_device_name(0),
               state=summary["state"])
    return out


def model_axis_rank(argv: list, cfg, seq: int, tcfg, steps: int,
                    serve_runs: list) -> dict:
    """``tp_ranks2`` / ``ep_ranks2``'s rank: ``model_axis_train``, then
    serving on the mesh (``serve_on_rank``)."""
    out = model_axis_train(argv, cfg, seq, tcfg, steps)
    del out["state"]
    return serve_on_rank(out, cfg, serve_runs)


def model_axis_phase(name: str, arch: str, layers: int, steps: int,
                     expect, batch: int, seq: int, extra_args=(),
                     fsdp=None, serve_kw=None) -> dict:
    """Two ranks on the one card, gloo over CUDA tensors, a (1, 2) mesh:
    ``launch.train --mesh host`` at ``arch``'s full width, ``layers`` deep,
    its preset (``fsdp`` overrides the preset's), against the same cut in
    this process without a group first: losses within ``TP_LOSS_RTOL``,
    every batch each rank's rows of the plain compile (the same on both),
    the leaves held whole bit-equal across the ranks, the ones whose spec
    names "model" sharded on both, the drop share of an MoE equal on both.
    Then the same cut serves on the mesh against one process
    (``axis_serve``; ``serve_kw`` its sizes)."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.models import hybrid

    reduced = "--reduced" in extra_args
    base = get_reduced(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(base, n_layers=layers)
    tcfg = launch.train_preset(arch)
    if fsdp is not None:
        tcfg = dataclasses.replace(tcfg, fsdp=fsdp)
    argv = ["--arch", arch, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--etl-backend", "cuda",
            "--max-restarts", "0", "--mesh", "host", *extra_args]
    with counting_routes() as tally, preset_with(tcfg):
        alone = run_launcher(argv, cfg=cfg)
    want = [m[0] for m in alone["tap"]["metrics"]]
    ms = sorted(alone["tap"]["ms"][1:])
    alone_ms = ms[len(ms) // 2] if ms else float("nan")
    alone_peak = alone["peak_mem_gb"]
    alone_drop = drop_share(tally) if tally["routed"] else None
    del alone
    free_memory()
    with tempfile.TemporaryDirectory() as tmp:
        served, runs = axis_serve_alone(cfg, tmp,
                                        serving_runs(cfg, serve_kw or {}))
        ranks = run_ranks(model_axis_rank, 2, "gloo",
                          (argv, cfg, seq, tcfg, steps, runs), timeout=900)
    serve = axis_serve_check(name, served, ranks, expect)
    diff = 0.0
    for r, out in enumerate(ranks):
        expect(out["launches"], out["launches_want"], f"{name} rank {r}")
        if len(out["losses"]) != steps:
            raise AssertionError(f"{name}: rank {r} ran "
                                 f"{len(out['losses'])} steps")
        diff = max([diff] + [abs(a - b) / abs(b)
                             for a, b in zip(out["losses"], want)])
    if diff > TP_LOSS_RTOL:
        raise AssertionError(f"{name}: losses {ranks[0]['losses']} vs "
                             f"{want} in one process")
    a, b = ranks[0]["leaves"], ranks[1]["leaves"]
    if a["whole"] != b["whole"] or not a["shards"] or \
            a["shards"] != b["shards"]:
        raise AssertionError(f"{name}: leaves held whole differ across the "
                             f"ranks, or none is sharded: {a} {b}")
    if ranks[0]["drop_share"] != ranks[1]["drop_share"]:
        raise AssertionError(f"{name}: drop shares "
                             f"{[o['drop_share'] for o in ranks]}")
    if alone_drop is not None and \
            abs(ranks[0]["drop_share"] - alone_drop) > MOE_FLIP_SHARE:
        raise AssertionError(f"{name}: drop share {ranks[0]['drop_share']} "
                             f"vs {alone_drop} in one process")
    for out in ranks:
        out["leaves"] = {"whole": len(out["leaves"]["whole"]),
                         "sharded": out["leaves"]["shards"]}
    return {"arch": arch, "reduced": reduced, "layers": layers,
            "layers_full": base.n_layers, "world": 2, "mesh": [1, 2],
            "backend": "gloo", "fsdp": tcfg.fsdp,
            "microbatch": tcfg.microbatch, "batch": batch, "seq": seq,
            "losses_one_process": want, "loss_max_rel_diff": diff,
            "loss_rtol": TP_LOSS_RTOL,
            "step_ms_median_2_on_one_process": alone_ms,
            "peak_mem_gb_one_process": alone_peak,
            "drop_share_one_process": alone_drop,
            "leaves_whole_bit_equal_across_ranks": True,
            **({"shared_applications": hybrid.n_shared_applications(cfg)}
               if cfg.family == "hybrid" else {}),
            "launches": add_launches(*(o["launches"] for o in ranks)),
            "serve": serve, "ranks": ranks}


def dlrm_la_config():
    """lookahead_main's cache: 4096 resident and 2048 staging rows a
    feature, a window of 4 batches, refreshed each batch (exact under
    training)."""
    from repro_torch.etl_runtime import lookahead as la
    return la.EmbedCacheConfig(rows=4096, window=4, stage_max=2048,
                               tables=tuple(range(26)), refresh=True,
                               row_bytes=4 * 128)


def dlrm_run(steps: int, n_fit: int, mesh=None, cache_cfg=None,
             fsdp: bool = False) -> dict:
    """``DLRMConfig()`` (vocab 524288) trained ``steps`` steps from main's
    ETL (Pipeline III, B rows a batch, fitted on ``n_fit`` chunks), on
    ``mesh`` through ``shard_train_step`` (``EtlJob(mesh=)``; ``fsdp``:
    FSDP2 over its data axes) or in one process, through the lookahead
    cache when ``cache_cfg`` is given (the executor plans each rank's rows
    after place; an ``EmbedCache`` on each rank holds its table rows,
    gathered over the data axes where FSDP shards the tables): losses,
    step ms, rows/s, this rank's table bytes, launches, peak GB, the
    collectives a step, the cache's counters and one profiled step."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.pipeline import paper_pipeline
    from repro_torch.data.source import Source
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.etl_runtime import lookahead as la
    from repro_torch.kernels import dataflow as df
    from repro_torch.models import dlrm
    from repro_torch.session import EtlJob
    from repro_torch.training import train_loop as ttl

    torch.backends.cuda.matmul.allow_tf32 = False
    job = EtlJob(paper_pipeline("III", batch_size=B),
                 Source.synth("I", rows=steps * B, batch_size=B, seed=11),
                 backend="cuda", mesh=mesh, embed_cache=cache_cfg,
                 fit_source=Source.synth("I", rows=n_fit * B, batch_size=B))
    df.reset_launch_counts()
    job.fit()
    fit_launches = dict(df.LAUNCHES)
    cfg = dlrm.DLRMConfig(vocab_size=DLRM_TP_VOCAB)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tcfg = TrainConfig(lr=1e-3)
    model = dlrm.DLRM(cfg, generator=gen)
    if mesh is None:
        state = ttl.TrainState.create(model, tcfg)
        step = ttl.make_train_step(dlrm.loss_fn, tcfg)
    else:  # the optimizer state is made for the rank's shards alone
        step, state = ttl.shard_train_step(dlrm.loss_fn, tcfg, mesh,
                                           ttl.TrainState(model, None),
                                           batch_rows=B, fsdp=fsdp)
        del model
        torch.cuda.empty_cache()  # the whole tables, four ranks on a card
    cache = None if cache_cfg is None else la.EmbedCache(
        cache_cfg, cfg.n_sparse, cfg.d_emb)
    losses, ms = [], []
    last: dict = {}

    def timed(st, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        last["batch"] = batch
        return st, m

    torch.cuda.reset_peak_memory_stats()
    df.reset_launch_counts()
    tp.reset_traffic()
    t0 = time.perf_counter()
    with job.batches() as ex:
        state = ttl.train_loop(state, timed, ex,
                               ttl.LoopConfig(total_steps=steps,
                                              log_every=0),
                               embed_cache=cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(df.LAUNCHES)
    traffic = traffic_per_step(steps)
    if state.step != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"dlrm: {state.step} steps, losses {losses}")
    tables = state.model.tables
    tables = tables.to_local() if hasattr(tables, "to_local") else tables
    out = {"losses": losses, "step_ms": ms,
           "step_ms_median_2_on": sorted(ms[1:])[len(ms[1:]) // 2],
           "rows_per_s": steps * B / wall, "wall_seconds": wall,
           "table_bytes": tables.numel() * tables.element_size(),
           "table_shape": list(tables.shape),
           "fit_launches": fit_launches, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "collectives_per_step": traffic}
    if cache_cfg is not None:
        stats = job.stats()
        out["cache"] = stats.cache.as_dict()
        out["lookahead_share_of_wall"] = \
            stats.stages["lookahead"].busy_s / wall
        # one more step on the last batch (its plan applied already)
        out["profile_one_more_step"] = {
            k: v for k, v in profile_step(
                lambda: step(state, last["batch"])).items()
            if k != "top_ops"}
    if mesh is not None:
        out["leaves"] = leaf_digests(state.model)
        out["device"] = torch.cuda.get_device_name(0)
    del state, job, cache, last
    torch.cuda.empty_cache()
    return out


def dlrm_tp2_rank(steps: int, n_fit: int) -> dict:
    """``dlrm_tp2``'s rank: ``dlrm_run`` on ``make_host_mesh(model_axis=
    2)`` (the gloo world ``rank_entry`` joined; two ranks: a (1, 2)
    mesh)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model_axis=2)
    shd.set_active_mesh(mesh)
    return dlrm_run(steps, n_fit, mesh=mesh)


def dlrm_la_22_rank(steps: int, n_fit: int) -> dict:
    """``dlrm_la_22``'s rank: ``dlrm_run`` through the lookahead cache on
    ``make_host_mesh(model_axis=2)`` of four ranks, a (2, 2) mesh, with
    FSDP over the data axes: each rank holds 262144 rows and 64 of the
    128 columns of every table, and its cache the whole rows its own data
    shard's plan asks for.  The rank's allocator is held to
    ``DLRM_LA_22_RANK_GB`` (it hands its cached blocks back before it
    passes that), so the four ranks' cached blocks leave the card room."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_per_process_memory_fraction(
        DLRM_LA_22_RANK_GB * 1e9 / torch.cuda.get_device_properties(0)
        .total_memory)
    mesh = make_host_mesh(model_axis=2)
    shd.set_active_mesh(mesh)
    return dlrm_run(steps, n_fit, mesh=mesh, cache_cfg=dlrm_la_config(),
                    fsdp=True)


def dlrm_ranks_phase(name: str, expect, alone: dict, ranks: list,
                     steps: int, n_fit: int, apply: dict,
                     mesh: tuple = (1, 2), fsdp: bool = False) -> dict:
    """One DLRM model-axis phase's checks: each rank's launches (the fit's
    and ``apply``, the training run's), losses within ``DLRM_TP_RTOL`` of
    ``alone``'s (one process), the leaves held whole bit-equal across the
    model ranks of each data coordinate (rank r is ``(r // m, r % m)`` of
    ``mesh``) and the tables sharded."""
    want = alone["losses"]
    diff = 0.0
    for r, out in enumerate(ranks):
        expect(out["fit_launches"], {"fit_dataflow": n_fit},
               f"{name} rank {r} fit")
        expect(out["launches"], apply, f"{name} rank {r} apply")
        out["loss_rel_diff"] = [abs(a - b) / abs(b)
                                for a, b in zip(out["losses"], want)]
        diff = max([diff] + out["loss_rel_diff"])
    if diff > DLRM_TP_RTOL or len(ranks[0]["losses"]) != steps:
        raise AssertionError(f"{name}: losses {ranks[0]['losses']} vs "
                             f"{want} in one process")
    m = mesh[1]
    for r in range(0, len(ranks), m):
        a = ranks[r]["leaves"]
        for b in (o["leaves"] for o in ranks[r + 1:r + m]):
            if a["whole"] != b["whole"] or "tables" not in a["shards"]:
                raise AssertionError(f"{name}: leaves {a} {b}")
    for out in ranks:
        out["leaves"] = {"whole": len(out["leaves"]["whole"]),
                         "sharded": out["leaves"]["shards"]}
    return {"vocab": DLRM_TP_VOCAB, "batch": B, "steps": steps,
            "world": len(ranks), "mesh": list(mesh), "backend": "gloo",
            "fsdp": fsdp, "losses_one_process": want,
            "loss_max_rel_diff": diff, "loss_rtol": DLRM_TP_RTOL,
            "one_process": {k: alone[k] for k in (
                "step_ms_median_2_on", "rows_per_s", "table_bytes",
                "peak_mem_gb") + (("cache",) if "cache" in alone else ())},
            "leaves_whole_bit_equal_across_model_ranks": True,
            "launches": add_launches(
                *(add_launches(o["fit_launches"], o["launches"])
                  for o in ranks)),
            "launches_per_rank": [add_launches(o["fit_launches"],
                                               o["launches"])
                                  for o in ranks],
            "ranks": ranks}


def dlrm_tp2(expect, steps: int = DLRM_TP_STEPS,
             n_fit: int = DLRM_TP_FIT,
             la_steps: int = DLRM_LA_22_STEPS) -> tuple:
    """``DLRMConfig()`` on two ranks sharing the card (gloo over CUDA
    tensors, a (1, 2) mesh): each rank's tables are its 262144 rows of
    every feature, the MLPs' output features split where 2 divides them;
    fed by main's ETL through ``EtlJob(mesh=)``; against one process on the
    same config and batches: losses within ``DLRM_TP_RTOL``, the leaves
    held whole bit-equal across the ranks.  Then ``dlrm_la_22`` on four
    ranks, a (2, 2) mesh, FSDP over the data axes: the lookahead path
    (``dlrm_la_config``; the executor plans each data shard's 32768 rows,
    each rank's cache holds the rows in its range, whole, gathered from the
    data ranks' column shards: ``TRAFFIC["embed_cache_gather"]``; one
    stacked ``embedding_bag_cached`` launch a step on each rank's table
    shard), against one process's lookahead path: losses within
    ``DLRM_TP_RTOL``, the cache's counters equal across the model ranks of
    each data coordinate.  Returns both phases."""
    import torch

    alone = dlrm_run(steps, n_fit)
    free_memory()
    alone_la = dlrm_run(la_steps, n_fit, cache_cfg=dlrm_la_config())
    free_memory()
    ranks = run_ranks(dlrm_tp2_rank, 2, "gloo", (steps, n_fit),
                      timeout=900)
    plain = dlrm_ranks_phase("dlrm_tp2", expect, alone, ranks, steps,
                             n_fit, {"group_dataflow": steps})
    free_memory()
    card_free = torch.cuda.mem_get_info()[0]
    parent_gb = torch.cuda.memory_allocated() / 1e9
    with alloc_conf("expandable_segments:True"):  # the ranks' allocators
        la_ranks = run_ranks(dlrm_la_22_rank, 4, "gloo", (la_steps, n_fit),
                             timeout=900)
    look = dlrm_ranks_phase("dlrm_la_22", expect, alone_la, la_ranks,
                            la_steps, n_fit,
                            {"group_dataflow": la_steps,
                             "embedding_bag_cached": la_steps},
                            mesh=(2, 2), fsdp=True)
    # (a data shard's 32768 rows stage every cold row of a feature within
    # its 2048 slots: no row falls through to the table, which the one
    # process's 65536 do; the parity phase holds that branch)
    caches = [o["cache"] for o in la_ranks]
    if caches[0] != caches[1] or caches[2] != caches[3] or \
            min(c[k] for c in caches for k in ("hits", "staged")) <= 0:
        raise AssertionError(f"dlrm_la_22: the ranks' caches {caches}")
    gathered = [o["collectives_per_step"]["embed_cache_gather"]
                for o in la_ranks]
    if min(g["bytes"] for g in gathered) <= 0:
        raise AssertionError(f"dlrm_la_22: no rows gathered over the data "
                             f"axes {gathered}")
    look["cache_counters_equal_across_model_ranks"] = True
    look["cache_config"] = dataclasses.asdict(dlrm_la_config())
    look["embed_cache_gather_gb_per_step"] = [g["bytes"] / 1e9
                                              for g in gathered]
    look["table_gb_per_rank"] = [o["table_bytes"] / 1e9 for o in la_ranks]
    look["step_ms_median_2_on"] = [o["step_ms_median_2_on"]
                                   for o in la_ranks]
    look["peak_mem_gb_per_rank"] = [o["peak_mem_gb"] for o in la_ranks]
    look["card_free_gb_before_ranks"] = card_free / 1e9
    look["this_process_allocated_gb"] = parent_gb
    look["rank_allocator_cap_gb"] = DLRM_LA_22_RANK_GB
    return plain, look


def encdec_run(steps: int, batch: int, seq: int, mesh=None,
               reduced: bool = False) -> dict:
    """``whisper_base`` (its preset: AdamW, microbatch 1) trained ``steps``
    steps, on ``mesh`` through ``shard_train_step`` or in one process: the
    decoder's tokens and labels (``seq`` a row) from the LM token pipeline
    on the cuda backend (``launch.train.make_job``), the encoder's frames
    from ``random_batch`` (no launcher feeds frames).  Losses, gradient
    norms, step ms, peak GB, the ETL's launches and those its lowering
    means, the model axis's collectives a step, one more step profiled,
    and (on a mesh) the digests of the leaves held whole."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import dataflow as df
    from repro_torch.launch import train as launch
    from repro_torch.models import api
    from repro_torch.training import train_loop as ttl

    cfg = get_reduced(ENCDEC_ARCH) if reduced else get_config(ENCDEC_ARCH)
    tcfg = launch.train_preset(ENCDEC_ARCH)
    model = api.build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    module = model.init(seed=0)
    dev = next(module.parameters()).device
    state = ttl.TrainState.create(module, tcfg)
    if mesh is None:
        step = ttl.make_train_step(model.loss, tcfg)
    else:
        step, state = ttl.shard_train_step(model.loss, tcfg, mesh, state,
                                           batch_rows=batch)
    shape = ShapeCfg("encdec", seq, batch, "train")
    job = launch.make_job(cfg, batch, seq, steps + 1, backend="cuda",
                          device=dev)
    df.reset_launch_counts()
    with job.batches() as ex:
        batches = [dict({k: v.clone() for k, v in b.items()},
                        frames=api.random_batch(cfg, shape, seed=i,
                                                device=dev)["frames"])
                   for i, b in zip(range(steps + 1), ex)]
    launches = dict(df.LAUNCHES)
    want = lm_launches(job.compiled, job.stats().stages["transform"].items)
    tp.reset_traffic()
    losses, norms, ms = [], [], []
    for b in batches[:steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    traffic = traffic_per_step(steps)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"encdec: losses {losses}, norms {norms}")
    profile = profile_step(lambda: step(state, batches[-1]))
    out = {"losses": losses, "grad_norms": norms, "step_ms": ms,
           "step_ms_median_2_on": sorted(ms[1:])[len(ms[1:]) // 2],
           "tok_per_s": steps * batch * seq / (sum(ms) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "collectives_per_step": traffic,
           "profile_one_more_step": {k: v for k, v in profile.items()
                                     if k != "top_ops"},
           "launches": launches, "launches_want": want}
    if mesh is not None:
        out["leaves"] = leaf_digests(state.model)
        out["device"] = torch.cuda.get_device_name(0)
    del state, module, batches, job
    torch.cuda.empty_cache()
    return out


def encdec_tp2_rank(steps: int, batch: int, seq: int, reduced: bool,
                    serve_runs: list) -> dict:
    """``encdec_tp2``'s rank: ``encdec_run`` on
    ``make_host_mesh(model_axis=2)``, then serving on it
    (``serve_on_rank``)."""
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model_axis=2)
    shd.set_active_mesh(mesh)
    out = encdec_run(steps, batch, seq, mesh=mesh, reduced=reduced)
    cfg = get_reduced(ENCDEC_ARCH) if reduced else get_config(ENCDEC_ARCH)
    return serve_on_rank(out, cfg, serve_runs)


def encdec_tp2(expect, steps: int = ENCDEC_TP_STEPS, batch: int = LM_BATCH,
               seq: int = ENCDEC_SEQ, reduced: bool = False,
               serve_kw=None) -> dict:
    """``whisper_base`` at full width and depth (1,500 frames) on two ranks
    sharing the card (gloo over CUDA tensors, a (1, 2) mesh: 4 of 8 heads
    of every self- and cross-attention, 1,024 of 2,048 MLP columns, 26,112
    of 52,224 tied vocabulary rows a rank; the encoder's output enters each
    cross-attention through ``copy_in``), against the same run in one
    process: losses within ``TP_LOSS_RTOL``, the leaves held whole
    bit-equal across the ranks.  Then serving on the mesh against one
    process (``axis_serve``; ``serve_kw`` its sizes)."""
    from repro_torch.configs.registry import get_config, get_reduced

    alone = encdec_run(steps, batch, seq, reduced=reduced)
    free_memory()
    cfg = get_reduced(ENCDEC_ARCH) if reduced else get_config(ENCDEC_ARCH)
    with tempfile.TemporaryDirectory() as tmp:
        served, runs = axis_serve_alone(cfg, tmp,
                                        serving_runs(cfg, serve_kw or {}))
        ranks = run_ranks(encdec_tp2_rank, 2, "gloo",
                          (steps, batch, seq, reduced, runs), timeout=600)
    serve = axis_serve_check("encdec_tp2", served, ranks, expect)
    diff = max(abs(a - b) / abs(b) for out in ranks
               for a, b in zip(out["losses"], alone["losses"]))
    if diff > TP_LOSS_RTOL or len(ranks[0]["losses"]) != steps:
        raise AssertionError(f"encdec_tp2: losses {ranks[0]['losses']} vs "
                             f"{alone['losses']} in one process")
    a, b = ranks[0]["leaves"], ranks[1]["leaves"]
    if a["whole"] != b["whole"] or not a["shards"] or \
            a["shards"] != b["shards"]:
        raise AssertionError(f"encdec_tp2: leaves held whole differ across "
                             f"the ranks, or none is sharded: {a} {b}")
    expect(alone["launches"], alone["launches_want"], "encdec_tp2 alone")
    for r, out in enumerate(ranks):
        expect(out["launches"], out["launches_want"], f"encdec_tp2 rank {r}")
    for out in ranks:
        out["leaves"] = {"whole": len(out["leaves"]["whole"]),
                         "sharded": out["leaves"]["shards"]}
    return {"arch": ENCDEC_ARCH, "reduced": reduced, "world": 2,
            "mesh": [1, 2], "backend": "gloo", "batch": batch, "seq": seq,
            "losses_one_process": alone["losses"],
            "loss_max_rel_diff": diff, "loss_rtol": TP_LOSS_RTOL,
            "one_process": {k: alone[k] for k in (
                "step_ms_median_2_on", "peak_mem_gb", "tok_per_s")},
            "leaves_whole_bit_equal_across_ranks": True,
            "launches": add_launches(*(o["launches"] for o in ranks)),
            "launches_per_rank": [o["launches"] for o in ranks],
            "serve": serve, "ranks": ranks}


def adafactor_share_bytes(model, data_degree: int, itemsize: int) -> int:
    """The bytes of Adafactor's state a rank holds by the reference's
    ``param_specs`` on the state under FSDP: each leaf's factors (``vr``,
    ``vc``; ``v`` unfactored) of its whole shape, whole over the model
    axis, the largest dim the data degree divides cut by it (no path rule
    names a factor)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.transformer import jax_leaves

    total = 0
    for _, leaf in jax_leaves(model.jax_tree()):
        shape = list(shd.leaf_shape(leaf))
        md, ax = tp.shard_of(leaf[0] if isinstance(leaf, list) else leaf)
        if md is not None:
            shape[md + isinstance(leaf, list)] *= ax.size
        factored = len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1
        for f in ([shape[:-1], shape[:-2] + shape[-1:]] if factored
                  else [shape]):
            cut = any(n % data_degree == 0 for n in f)
            total += math.prod(f) // (data_degree if cut else 1) * itemsize
    return total


def seq_parallel_traffic(cfg, rows: int, seq: int, n_micro: int) -> dict:
    """The model axis' collectives a step of a sequence-parallel dense LM
    under full remat (``tests/test_torch_tensor_parallel.py``'s count):
    per microbatch of ``rows`` rows a data rank, with L blocks and E = 2 L
    + 1 sequence-sharded entries (each block's attention and MLP, the
    head), reduce-scatters of the whole-sequence activations: E (each
    entry's backward) + 2 L (the blocks' outputs) + L (the attention's
    again, recomputed); all-gathers: E + 2 L (the entries recomputed) +
    2 L (the outputs' backward) + 1 (the residual's scatter backward); one
    all-reduce of them, the embedding's.  ``W``: one activation's bytes
    (the compute dtype)."""
    import torch

    layers, e = cfg.n_layers, 2 * cfg.n_layers + 1
    w = rows * seq * cfg.d_model * torch.empty(
        (), dtype=getattr(torch, cfg.compute_dtype)).element_size()
    return {"W": w, "reduce_scatter_calls": n_micro * (e + 3 * layers),
            "all_gather_calls": n_micro * (e + 4 * layers + 1),
            "whole_sequence_all_reduces": n_micro}


def serve_fsdp_rank(train: tuple, cfg, runs: list) -> dict:
    """``serve_fsdp``'s rank: ``model_axis_train`` on the (2, 2) mesh
    (``train``: its arguments), the Adafactor state's bytes against the
    reference's share; then ``serve_on_rank`` weight-gathered on the same
    mesh."""
    from repro_torch.distributed import sharding as shd

    out = model_axis_train(*train)
    state = out.pop("state")
    tcfg = train[3]
    out["opt_state_bytes"] = sum(
        getattr(t, "to_local", lambda t=t: t)().numel() * t.element_size()
        for st in state.opt["f"] for t in st.values())
    out["opt_state_share_bytes"] = adafactor_share_bytes(
        state.model, shd.data_degree(shd.get_active_mesh()),
        2 if tcfg.opt_state_dtype == "bfloat16" else 4)
    del state
    free_memory()
    out["launches_train"] = dict(out["launches"])
    return serve_on_rank(out, cfg, runs)


def serve_fsdp(expect, layers: int = SERVE_FSDP_LAYERS,
               serve_kw=None) -> dict:
    """Four ranks sharing the card, gloo over CUDA tensors, a (2, 2) mesh,
    ``SERVE_FSDP_ARCH`` at full width, ``layers`` deep, bfloat16.  First
    they train ``SERVE_FSDP_STEPS`` steps as ``llama3_405b`` trains (its
    preset: FSDP2 over the data axes, Adafactor with bfloat16 state,
    sequence parallelism; ``SERVE_FSDP_MICRO`` microbatches), fed the LM
    token pipeline on the card, against the same cut in this process:
    losses within ``LM_CHECK_RTOL["loss"]``; the model axis' traffic a
    step ``seq_parallel_traffic``'s (each sequence-sharded entry's
    backward one reduce-scatter, no whole-sequence all-reduce but the
    embedding's); each rank's Adafactor state its ``param_specs`` share;
    step ms, peak GB and one profiled step's idle share beside one
    process's.  Then weight-gathered serving (``shard_for_serving(fsdp=
    True)``), each data rank its 4 of the 8 prompts, against one process
    (``axis_serve``): logits within ``SERVE_TOL``, the tokens of one data
    coordinate's ranks identical, each rank's resident bytes its
    ``param_specs(fsdp=True)`` share and its gathers a decode step the
    data-sharded leaves' bytes."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as launch

    cfg = dataclasses.replace(get_config(SERVE_FSDP_ARCH), n_layers=layers,
                              param_dtype="bfloat16")
    train_cfg = dataclasses.replace(cfg, seq_parallel=True)
    tcfg = dataclasses.replace(launch.train_preset("llama3_405b"),
                               microbatch=SERVE_FSDP_MICRO)
    argv = ["--arch", SERVE_FSDP_ARCH, "--batch", str(LM_BATCH), "--seq",
            str(LM_SEQ), "--steps", str(SERVE_FSDP_STEPS), "--etl-backend",
            "cuda", "--max-restarts", "0", "--mesh", "host"]
    shd.set_active_mesh(None)
    with preset_with(tcfg):
        alone = run_launcher(argv, cfg=train_cfg)
    one = launcher_readings(alone, train_cfg, LM_SEQ, tcfg.microbatch)
    del alone
    free_memory()
    kw = dict(serve_kw or {}, fsdp=True)
    train = (argv, train_cfg, LM_SEQ, tcfg, SERVE_FSDP_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        served, runs = axis_serve_alone(cfg, tmp, [kw])
        ranks = run_ranks(serve_fsdp_rank, 4, "gloo", (train, cfg, runs),
                          timeout=900)
    for r, out in enumerate(ranks):
        expect(out["launches"], out["launches_want"], f"serve_fsdp rank {r}")
    analyzed = ranks[0]["serve"][0]["analyzed_prefill"]
    serve = axis_serve_check("serve_fsdp", served, ranks, expect)
    want = one["losses"]
    diff = max(abs(a - b) / abs(b) for o in ranks
               for a, b in zip(o["losses"], want))
    if diff > LM_CHECK_RTOL["loss"] or any(
            len(o["losses"]) != SERVE_FSDP_STEPS for o in ranks):
        raise AssertionError(f"serve_fsdp: losses "
                             f"{[o['losses'] for o in ranks]} vs {want} in "
                             "one process")
    sp = seq_parallel_traffic(train_cfg, LM_BATCH // 2 // tcfg.microbatch,
                              LM_SEQ, tcfg.microbatch)
    for r, out in enumerate(ranks):
        t = out["collectives_per_step"]
        got = {"reduce_scatter_calls": t["reduce_scatter"]["calls"],
               "reduce_scatter_bytes": t["reduce_scatter"]["bytes"],
               "all_gather_calls": t["all_gather"]["calls"],
               "all_reduce_bytes": t["all_reduce"]["bytes"]}
        if got["reduce_scatter_calls"] != sp["reduce_scatter_calls"] or \
                got["reduce_scatter_bytes"] != \
                sp["reduce_scatter_calls"] * sp["W"] or \
                got["all_gather_calls"] != sp["all_gather_calls"] or \
                got["all_reduce_bytes"] >= \
                (sp["whole_sequence_all_reduces"] + 1) * sp["W"]:
            raise AssertionError(f"serve_fsdp rank {r}: the model axis' "
                                 f"traffic a step {got} vs {sp}")
        if out["opt_state_bytes"] != out["opt_state_share_bytes"]:
            raise AssertionError(
                f"serve_fsdp rank {r}: Adafactor state "
                f"{out['opt_state_bytes']} B vs its param_specs share "
                f"{out['opt_state_share_bytes']} B")
        out["leaves"] = {"whole": len(out["leaves"]["whole"]),
                         "sharded": out["leaves"]["shards"]}
        del out["launches_want"]
    return {"arch": SERVE_FSDP_ARCH, "layers": layers,
            "layers_full": get_config(SERVE_FSDP_ARCH).n_layers,
            "world": 4, "mesh": [2, 2], "backend": "gloo",
            "compute_dtype": cfg.compute_dtype,
            "train": {"preset": "llama3_405b", "fsdp": tcfg.fsdp,
                      "optimizer": tcfg.optimizer,
                      "opt_state_dtype": tcfg.opt_state_dtype,
                      "seq_parallel": True, "microbatch": tcfg.microbatch,
                      "batch": LM_BATCH, "seq": LM_SEQ,
                      "steps": SERVE_FSDP_STEPS,
                      "losses_one_process": want, "loss_max_rel_diff": diff,
                      "loss_rtol": LM_CHECK_RTOL["loss"],
                      "seq_parallel_traffic_want": sp,
                      "one_process": {k: one[k] for k in (
                          "step_ms_median_2_on", "peak_mem_gb",
                          "profile_one_more_step")},
                      "ranks": [{k: o[k] for k in (
                          "losses", "step_ms", "step_ms_median_2_on",
                          "peak_mem_gb", "profile_one_more_step",
                          "collectives_per_step", "opt_state_bytes",
                          "opt_state_share_bytes", "leaves",
                          "launches_train")} for o in ranks]},
            "serve": serve, "rank0_prefill": analyzed,
            "launches": add_launches(*(o["launches"] for o in ranks)),
            "launches_per_rank": [o["launches"] for o in ranks]}


def dryrun_rank(cfg, batch: int, prompt: int) -> dict:
    """``dryrun``'s process: ``DRYRUN_CELLS`` through ``launch.dryrun
    .run_cell`` on fake CUDA tensors, then the trace of ``serve_fsdp``'s
    cell (``cfg``, ``batch`` prompts of ``prompt`` tokens, weight-gathered
    on a (2, 2) fake world) from rank 0's side."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import cells, dryrun

    out = {"cells": []}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape, multi_pod in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                                  out_dir=tmp, force=True, device="cuda")
            if not rec["ok"]:
                raise AssertionError(f"dryrun {rec['cell']}: {rec['error']}"
                                     f"\n{rec['traceback']}")
            out["cells"].append({
                "cell": rec["cell"], "kind": rec["kind"],
                "serve_fsdp": rec["serve_fsdp"],
                "per_device_gib": rec["memory"]["per_device_bytes"] / 2**30,
                "argument_gib":
                    rec["memory"]["argument_size_in_bytes"] / 2**30,
                "flops": rec["cost"]["flops"],
                "bytes_accessed": rec["cost"]["bytes_accessed"],
                "collective_bytes": rec["collectives"]["collective_bytes"],
                "n_collectives": rec["collectives"]["n_collectives"],
                "hlo_vs_model_flops": rec["hlo_vs_model_flops"],
                "roofline": rec["roofline"], "trace_s": rec["trace_s"]})
    shape = ShapeCfg("serve_fsdp", prompt, batch, "prefill")
    t0 = time.perf_counter()
    with dryrun.fake_world((2, 2), "cuda") as mesh:
        plan = cells.plan_cell(SERVE_FSDP_ARCH, shape, mesh, cfg=cfg,
                               serve_fsdp=True)
        traced = dryrun.trace_plan(plan)
    out["serve_fsdp_cell"] = {**traced, "trace_s": time.perf_counter() - t0}
    return out


def start_dryrun(layers: int = SERVE_FSDP_LAYERS,
                 batch: int = AXIS_SERVE_BATCH,
                 prompt: int = AXIS_SERVE_PROMPT) -> tuple:
    """``dryrun_rank`` started in one spawned process (fake tensors: it
    runs on the host beside the distribution phases and serve_fsdp's
    ranks); ``dryrun_phase`` joins it."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(SERVE_FSDP_ARCH), n_layers=layers,
                              param_dtype="bfloat16")
    return start_ranks(dryrun_rank, 1, "none", (cfg, batch, prompt))


@contextlib.contextmanager
def stopped_on_error(started: tuple):
    """Within: ``start_ranks``' processes are stopped if what runs
    raises."""
    try:
        yield
    except BaseException:
        with contextlib.suppress(AssertionError):
            join_ranks(started, timeout=0)  # stops them
        raise


def dryrun_phase(started: tuple, real: dict) -> dict:
    """``start_dryrun``'s process joined; the trace of serve_fsdp's cell
    held to rank 0's real prefill (``real``): flops, collective count and
    bytes, parameter bytes exactly; MemTracker's peak beside
    ``max_memory_allocated`` (a reading)."""
    (out,) = join_ranks(started, timeout=900)
    traced = out.pop("serve_fsdp_cell")
    got = {"flops": traced["cost"]["flops"],
           "collective_bytes": traced["collectives"]["collective_bytes"],
           "n_collectives": traced["collectives"]["n_collectives"],
           "param_bytes": traced["memory"]["param_bytes"]}
    bad = {k: (v, real[k]) for k, v in got.items() if v != real[k]}
    if bad:
        raise AssertionError(f"dryrun: the fake trace of serve_fsdp's cell "
                             f"vs rank 0's real prefill {bad}")
    peak = traced["memory"]["per_device_bytes"]
    return {**out, "serve_fsdp_cell": {
        "fake": got, "real_rank0": {k: real[k] for k in got},
        "equal": True, "trace_s": traced["trace_s"],
        "memtracker_peak_gb": peak / 1e9,
        "max_memory_allocated_gb": real["max_memory_allocated"] / 1e9,
        "bytes_accessed_fake": traced["cost"]["bytes_accessed"],
        "bytes_accessed_real": real["bytes_accessed"]}}


def multitenant_main(expect, rows: int = 0,
                     n_batches: int = MT_BATCHES) -> dict:
    """``PipelineManager(total_credits=8)`` with three tenants at B rows,
    weights 2:1:1, ``n_batches`` ``Source.synth("I")`` batches each (made
    before the run, so the read stage does not pace the tenants and their
    transforms contend for the service): ``stateless`` (Pipeline I),
    ``vocab8k`` (II at 8192) and ``vocab512k`` (III at 524288), the last
    two fitted on 4 chunks through the fit kernel.  Every transformed batch
    is kept (``TappedPipeline``, with timed events on the
    executor's stream around each call: each tenant's stream span) and
    held against the
    tenant's plain (CPU) compile (integer outputs bit for bit, floats
    within rtol 1e-5); the fitted tables bit for bit against the plain
    fit.  Then the stateless tenant is swapped for Pipeline I at
    modulus 1024 and every tenant runs 2 more batches (the swapped one held
    against the new pipeline's plain compile), and one tenant runs alone:
    rows/s of each tenant, the aggregate and the solo tenant (Fig 17),
    and each tenant's device time from one more run under
    ``torch.profiler`` (``device_ms_by_stream``).
    Launch counts exact (one group launch per transformed batch, one fit
    launch per chunk); the service's grants, while all three tenants had
    batches left, within +-1 of 2:1:1 in every window of 4."""
    import numpy as np
    import torch
    from repro_torch.core.pipeline import paper_pipeline
    from repro_torch.data.source import Source
    from repro_torch.etl_runtime.multitenant import (PipelineManager,
                                                     TransformService)
    from repro_torch.kernels import dataflow as df

    rows = rows or B
    fit_chunks = list(Source.synth("I", rows=4 * rows, batch_size=rows))
    specs = (("stateless", "I", 2.0), ("vocab8k", "II", 1.0),
             ("vocab512k", "III", 1.0))
    mgr = PipelineManager(total_credits=8)
    plain, fit_launches, feeds, taps = {}, {}, {}, {}
    for i, (name, which, w) in enumerate(specs):
        tmpl = paper_pipeline(which, small_vocab=8192, large_vocab=524288,
                              batch_size=rows)
        p = tmpl.compile("cuda")
        df.reset_launch_counts()
        p.fit(iter(fit_chunks) if which != "I" else iter(()))
        torch.cuda.synchronize()
        fit_launches[name] = {k: v for k, v in df.LAUNCHES.items() if v}
        expect(fit_launches[name], {"fit_dataflow": 4} if which != "I"
               else {}, f"multitenant_main fit {name}")
        plain[name] = tmpl.compile("cuda", device="cpu")
        if which != "I":
            plain[name].fit(iter(fit_chunks))
        for vid, t in plain[name].state.tables.items():
            np.testing.assert_array_equal(p.state.tables[vid], t,
                                          err_msg=f"{name} fit")
        batches = list(Source.synth("I", rows=n_batches * rows,
                                    batch_size=rows, seed=30 + i))
        feeds[name] = batches
        taps[name] = TappedPipeline(p, timing=True)
        mgr.add(name, taps[name], lambda b=batches: iter(b), weight=w)

    def held(what: str, tap_calls: dict) -> dict:
        """Every kept batch against its tenant's plain compile: integer
        outputs bit-equal, float outputs within rtol 1e-5 (the repo's
        policy: the card's log1pf and the CPU's log1p differ by ulps)."""
        n, err = 0, 0.0
        for name, calls in tap_calls.items():
            for raw, out in calls:
                for k, want in plain[name](raw).items():
                    got = out[k].cpu()
                    if want.dtype.is_floating_point:
                        torch.testing.assert_close(
                            got, want, rtol=1e-5, atol=0,
                            msg=f"multitenant_main {what}: {name}/{k}")
                        err = max(err, float((got - want).abs().max()))
                    elif not torch.equal(got, want):
                        raise AssertionError(f"multitenant_main {what}: "
                                             f"{name}/{k} differs from its "
                                             "plain compile")
                n += 1
        return {"batches": n, "float_max_abs_err": err}

    def run(n: int, label: str, manager) -> dict:
        """``manager.run(n)`` with the launches counted, every kept batch
        held and, where the manager gates its tenants, the service's picks
        logged with the tenants waiting at each."""
        svc, eligible = None, []
        if manager.service_weighted and len(manager.tenants) > 1:
            svc = TransformService(manager.weights)
            pick = svc._wrr.pick

            def logged(e=None):
                eligible.append(sorted(e) if e is not None else None)
                return pick(e)
            svc._wrr.pick = logged
        for t in taps.values():
            t.calls.clear()
            t.events.clear()
        df.reset_launch_counts()
        t0 = time.perf_counter()
        res = manager.run(n_batches=n, service=svc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(df.LAUNCHES)
        calls = {name: list(taps[name].calls) for name in manager.tenants}
        expect(launches, {"group_dataflow": sum(map(len, calls.values()))},
               f"multitenant_main {label}")
        if any(r.batches != n for r in res.values()):
            raise AssertionError(f"multitenant_main {label}: "
                                 f"{ {k: r.batches for k, r in res.items()} }")
        out = {"tenants": {name: {
            "rows_per_s": r.rows_per_s, "rows": r.rows, "seconds": r.seconds,
            "batches": r.batches, "transformed": len(calls[name]),
            "credits": r.credits, "weight": r.weight,
            "stream_span_ms": taps[name].span_ms(),
            "stages": r.stage_breakdown} for name, r in res.items()},
            "aggregate_rows_per_s": sum(r.rows for r in res.values()) / wall,
            "wall_seconds": wall, "launches": launches,
            "grants": list(svc.grants) if svc else [], "eligible": eligible}
        out["batches_held"] = held(label, calls)
        return out

    first = run(n_batches, "run", mgr)
    # the grants while every tenant still had batches: a window counts
    # only if no tenant ran out of batches inside it
    weights = dict(mgr.weights)
    total_w = sum(weights.values())
    left = {n: n_batches for n in weights}
    windows = []
    grants = first["grants"]
    for i in range(0, len(grants) - 3, 4):
        counts = {n: grants[i:i + 4].count(n) for n in weights}
        if any(left[n] - c < 1 for n, c in counts.items()):
            break
        windows.append(counts)
        for n, c in counts.items():
            left[n] -= c
            if abs(c - 4 * weights[n] / total_w) > 1:
                raise AssertionError(f"multitenant_main: grants "
                                     f"{grants[i:i + 4]} off 2:1:1")
    if not windows:
        raise AssertionError("multitenant_main: no window of 4 grants while "
                             "every tenant had batches left")
    contended = sum(1 for e in first["eligible"][:4 * len(windows)]
                    if e is not None and len(e) == len(weights))
    first["grant_windows"] = windows
    first["picks_with_all_waiting"] = contended
    del first["eligible"]

    # each tenant's device time: the same run once more under the profiler,
    # each executor's stream tagged by a marker copy of its own size
    markers = {name: 4096 + 4 * i for i, name in enumerate(taps)}
    try:
        for name, t in taps.items():
            t.marker = torch.zeros(markers[name], dtype=torch.uint8,
                                   pin_memory=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mgr.run(n_batches=n_batches)
            torch.cuda.synchronize()
        path = os.path.join(HERE, "build", "multitenant_trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
        os.remove(path)
        first["device_ms"] = device_ms_by_stream(trace, markers)
    except Exception as e:  # a profiler without CUPTI access raises
        first["device_ms"] = {"error": repr(e)[:500]}
    for t in taps.values():
        t.marker = None

    # hot swap: Pipeline I at modulus 1024 in place of the stateless tenant
    new_tmpl = paper_pipeline("I", modulus=1024, batch_size=rows)
    t0 = time.perf_counter()
    new_p = new_tmpl.compile("cuda")
    compile_ms = (time.perf_counter() - t0) * 1e3
    plain["stateless"] = new_tmpl.compile("cuda", device="cpu")
    taps["stateless"] = TappedPipeline(new_p, timing=True)
    t0 = time.perf_counter()
    mgr.swap("stateless", taps["stateless"],
             lambda b=feeds["stateless"][:2]: iter(b))
    swap_ms = (time.perf_counter() - t0) * 1e3
    swapped = run(2, "after swap", mgr)
    swapped.pop("eligible")

    # the same tenants without the transform service: what the gate costs
    ungated_mgr = PipelineManager(total_credits=8, service_weighted=False)
    for name, (p, src) in mgr.tenants.items():
        ungated_mgr.add(name, p, src, weight=mgr.weights[name])
    ungated_mgr.tenants["stateless"] = (taps["stateless"],
                                        lambda b=feeds["stateless"]: iter(b))
    ungated = run(n_batches, "ungated", ungated_mgr)
    ungated.pop("eligible")

    solo_mgr = PipelineManager(total_credits=8)
    solo_mgr.add("vocab512k", taps["vocab512k"],
                 lambda b=feeds["vocab512k"]: iter(b))
    solo = run(n_batches, "solo", solo_mgr)
    solo.pop("eligible")
    return {"rows": rows, "batches_per_tenant": n_batches,
            "fit_launches": fit_launches, "run": first,
            "swap": {"compile_ms": compile_ms, "swap_ms": swap_ms,
                     **swapped},
            "ungated": ungated, "solo_vocab512k": solo,
            "scaling_aggregate_over_solo":
                first["aggregate_rows_per_s"] /
                solo["aggregate_rows_per_s"]}


_START = time.monotonic()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.monotonic() - _START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


class DeviceTimer:
    """Three readings of a call ``fn()``, each launch with a cold L2 (a
    64 MiB buffer zeroed before it), as after an H2D copy:

    - ``ms``: device time.  Before each launch the stream runs a spin
      (``torch.cuda._sleep``) long enough to cover the host's enqueue of the
      flush and of ``fn``; an event recorded after the spin must still be
      pending when the host has enqueued the closing event, else the reading
      is dropped and the spin doubled.  ``ahead_share`` is the share of
      readings kept; if none is, ``ms`` is the mean of all of them and
      holds host time (the parity phase fails a kernel below
      ``AHEAD_FLOOR`` and records the share of every plain version and
      library call beside its time).
    - ``ms_enqueued``: flush, event, ``fn``, event, with no spin, as the
      earlier versions of this script timed: the host's enqueue of ``fn``
      falls inside it whenever it outlasts the flush.
    - ``host_us``: the median host time of one call, synchronised before
      the call, not after.
    """

    def __init__(self):
        import torch
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e0, e1 = self.ev[:2]
        torch.cuda._sleep(1000)
        e0.record()
        torch.cuda._sleep(10 ** 7)
        e1.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 10 ** 7 / e0.elapsed_time(e1)

    def __call__(self, fn) -> dict:
        torch = self.torch
        spun, e0, e1 = self.ev
        for _ in range(3):
            fn()
        host = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
        spin_ms = max(0.2, 2e3 * max(host))
        kept, dropped = [], []
        for _ in range(2 * REPEATS):
            torch.cuda._sleep(int(spin_ms * self.cycles_per_ms))
            spun.record()
            self.flush.zero_()
            e0.record()
            fn()
            e1.record()
            ahead = not spun.query()  # the device still spun
            torch.cuda.synchronize()
            (kept if ahead else dropped).append(e0.elapsed_time(e1))
            if len(kept) == REPEATS:
                break
            if not ahead:
                spin_ms = min(2 * spin_ms, 50.0)
        enqueued = []
        for _ in range(REPEATS):
            self.flush.zero_()
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            enqueued.append(e0.elapsed_time(e1))
        device = kept or dropped
        host.sort()
        return {"ms": sum(device) / len(device),
                "ms_enqueued": sum(enqueued) / REPEATS,
                "host_us": host[REPEATS // 2] * 1e6,
                "ahead_share": len(kept) / (len(kept) + len(dropped))}


def main(root: str = HERE, time_only: bool = False) -> int:
    """The phases above; with ``time_only`` (``--wrappers``), only the
    timing of the parity instances' wrappers of the checkout at ``root``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import operators as core_ops
    from repro_torch.core.dag import Vocab
    from repro_torch.core.pipeline import Pipeline, paper_pipeline
    from repro_torch.core.schema import Schema
    from repro_torch.data.source import Source
    from repro_torch.etl_runtime import lookahead as la
    from repro_torch.kernels import backend
    from repro_torch.kernels import dataflow as df
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ops as kops
    from repro_torch.models import dlrm
    from repro_torch.session import EtlJob
    from repro_torch.training.train_loop import (LoopConfig, TrainState,
                                                 make_train_step, train_loop)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_parity  # the per-feature Criteo plan the tests build too

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "checkout": root})

    # ---- build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = backend.build_library(verbose=True)
    backend.load_library()
    emit({"phase": "build", "library": os.path.relpath(lib_path, root),
          "seconds": time.perf_counter() - t0})

    # ---- parity + timing at full size ----------------------------------
    fit_chunks = list(Source.synth("I", rows=4 * B, batch_size=B))
    raw = next(iter(Source.synth("I", rows=B, batch_size=B, seed=11)))
    tmpl = paper_pipeline("III", batch_size=B)
    tmpl_large = paper_pipeline("III", large_vocab=LARGE_VOCAB, batch_size=B)
    states = {}
    for key, t in (("III", tmpl), ("large", tmpl_large)):
        host = t.compile("cuda", device="cpu")  # the plain versions
        host.fit(iter(fit_chunks))
        states[key] = host.state
        if key == "III":
            host_sparse = host(raw)["sparse"]  # packed on the CPU (plain)
    grouped = tmpl.compile("cuda")
    solo = tmpl.compile("cuda", optimize="off")
    off = tmpl.compile("cuda", fuse="off")
    large = tmpl_large.compile("cuda")
    for p in (grouped, solo, off):
        p.state = states["III"]
    large.state = states["large"]
    if large.lowering_report()["sparse"]["path"] != "staged":
        raise AssertionError(f"vocab {LARGE_VOCAB}: {large.lowering_report()}")
    timer = DeviceTimer()

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def tensor_bytes(xs) -> int:
        return sum(x.numel() * x.element_size() for x in xs
                   if isinstance(x, torch.Tensor))

    def bag_work(args, got) -> tuple:
        """Bytes and adds of an embedding bag: ids in, output out, one row
        (dim elements of the table's dtype) per distinct row read (a gather
        reads only the rows it needs)."""
        dim = got[0].shape[-1] * got[0].element_size() // 4
        if args[0].dim() == 3:  # stacked: a row is a (feature, row) pair
            tables, cache, slot, cold = args
            feat = torch.arange(slot.shape[1], device=slot.device)
            feat = feat.expand_as(slot).long()
            hit = (slot >= 0) & (slot < cache.shape[1])
            fall = (slot < 0) & (cold >= 0) & (cold < tables.shape[1])
            n_rows = int(torch.unique(feat[hit] * cache.shape[1]
                                      + slot[hit]).numel())
            n_rows += int(torch.unique(feat[fall] * tables.shape[1]
                                       + cold[fall]).numel())
            return (4 * (slot.numel() + cold.numel()) + tensor_bytes(got)
                    + 4 * dim * n_rows,
                    int(hit.sum() + fall.sum()) * got[0].shape[-1])
        if len(args) == 2:  # embedding_bag(table, ids)
            (table, ids), cold = args, None
            hit = (ids >= 0) & (ids < table.shape[0])
        else:               # embedding_bag_cached(table, cache, slot, [cold])
            table, ids, cold = args[0], args[2], (list(args) + [None])[3]
            hit = (ids >= 0) & (ids < args[1].shape[0])
        n_rows = int(torch.unique(ids[hit]).numel())
        n_entries = int(hit.sum())
        id_bytes = 4 * ids.numel()
        if cold is not None:
            fall = (ids < 0) & (cold >= 0) & (cold < table.shape[0])
            n_rows += int(torch.unique(cold[fall]).numel())
            n_entries += int(fall.sum())
            id_bytes += 4 * cold.numel()
        return (id_bytes + tensor_bytes(got) + 4 * dim * n_rows,
                n_entries * got[0].shape[-1])

    def work(kname, fn, args, got) -> tuple:
        """(bytes, operations) the function needs for these inputs."""
        if kname.startswith("embedding_bag"):
            return bag_work(args, got)
        if kname == "vocab_lookup":  # a gather reads the rows it needs
            ids, table = args[0], args[1]
            hit = ids[(ids >= 0) & (ids < table.numel())]
            n_rows = int(torch.unique(hit).numel())
            nbytes = tensor_bytes([ids] + list(got)) + 4 * n_rows
            return nbytes, ids.numel()
        nbytes = tensor_bytes(list(args) + list(got))
        if kname == "fused_stage":
            prog = fn.program
            per = len(prog.instrs) + prog.hex_width
            return nbytes, got[0].numel() * per
        if kname in ("packer", "vocab_build_chunk"):
            return nbytes, got[0].numel() if kname == "packer" \
                else args[0].numel()
        prog = fn.program  # the tile program of the dataflow kernels
        src = args[0]
        rows = src.shape[1] if prog.slots[0].hex_width else src.shape[0]
        n_ops = sum(rows * prog.slots[i.dst].width for i in prog.instrs)
        n_ops += rows * sum(prog.out_cols)
        if prog.value_slot >= 0:
            n_ops += 2 * rows * prog.slots[prog.value_slot].width
        return nbytes, n_ops

    def library_calls(kname, args) -> dict:
        """PyTorch calls that each compute the same function in one call,
        by form; the kernels line reports the fastest.  Empty if none."""
        if kname == "vocab_build_chunk":
            vals, cap = args
            # with no ids scatter_reduce_ fills nothing: not the same function
            if vals.numel() == 0 or bool(((vals < 0) | (vals >= cap)).any()):
                return {}
            idx = vals.long()
            pos = torch.arange(vals.numel(), dtype=torch.int32, device="cuda")
            out = torch.full((cap,), df.ABSENT32, dtype=torch.int32,
                             device="cuda")
            # amin is idempotent: repeating the call recomputes the same table
            return {"scatter_reduce_amin":
                    lambda: out.scatter_reduce_(0, idx, pos, "amin")}
        if kname == "vocab_lookup":
            ids, table, n = args
            resolved = torch.where(table >= 0, table, n)
            idx = ids.long()
            return {"take": lambda: torch.take(resolved, idx)}
        if kname == "embedding_bag" or (kname == "embedding_bag_cached"
                                        and len(args) == 3):
            weight, ids = (args[0], args[1]) if len(args) == 2 else args[1:]
            inp, w = ids.clamp(min=0).long(), (ids >= 0).to(weight.dtype)
            # the valid ids flat, each bag starting at its offset: the same
            # function with no weights (the ids here are -1 or in range)
            ok = ids >= 0
            flat, per_bag = ids[ok].long(), ok.sum(1)
            offsets = torch.cumsum(per_bag, 0) - per_bag
            # the weighted form is the same function while no row holds an
            # inf or a NaN
            return {"embedding_bag_weighted":
                    lambda: F.embedding_bag(inp, weight, mode="sum",
                                            per_sample_weights=w),
                    "embedding_bag_offsets":
                    lambda: F.embedding_bag(flat, weight, offsets,
                                            mode="sum")}
        return {}

    # ---- the embedding-bag instances ------------------------------------
    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    dim = 128
    prob = (np.arange(DLRM_VOCAB, dtype=np.float64) + 1.0) ** -1.1
    ids = np.random.default_rng(1234).permutation(DLRM_VOCAB)[rng.choice(
        DLRM_VOCAB, size=(B, 8), p=prob / prob.sum())].astype(np.int32)
    ids[rng.random(ids.shape) < 0.1] = -1
    table = torch.randn(DLRM_VOCAB, dim, generator=gen, device="cuda")
    uniq = np.unique(ids[ids >= 0])
    slot_of = np.full(DLRM_VOCAB, -1, np.int64)
    slot_of[uniq] = np.arange(len(uniq))
    staged_slot = torch.tensor(np.where(ids >= 0, slot_of[ids.clip(min=0)],
                                        -1).astype(np.int32), device="cuda")
    staged_cache = table[torch.tensor(uniq, device="cuda")].contiguous()
    ids = torch.tensor(ids, device="cuda")
    la_cfg = la.EmbedCacheConfig(rows=4096, window=4, stage_max=2048,
                                 tables=tuple(range(26)), refresh=True,
                                 row_bytes=4 * dim)
    planner = la.LookaheadPlanner(la_cfg, 26)
    planner.push(host_sparse[:, :26].numpy().astype(np.int64))
    _, plan = planner.pop_plan()
    all_tables = torch.randn(26, DLRM_VOCAB, dim, generator=gen, device="cuda")
    planned = la.EmbedCache(la_cfg, 26, dim).advance(all_tables,
                                                     plan.as_payload())
    half_tables = all_tables[:, DLRM_TP_VOCAB // 2:DLRM_TP_VOCAB].contiguous()
    outside = int(((plan.slot < 0) & (plan.cold >= 0)
                   & (plan.cold < DLRM_TP_VOCAB // 2)).sum())
    if outside <= 0:
        raise AssertionError("stacked_half_table: no cold id outside the "
                             "half")
    # the feature with the most table fall-through: every branch runs
    feat = int(np.argmax(((plan.slot < 0) & (plan.cold >= 0)).sum(axis=0)))
    bag_plan = {"feature": feat,
                "hot": int((plan.slot[:, feat] >= 0).sum()
                           - (plan.slot[:, feat] >= la_cfg.rows).sum()),
                "staged": int((plan.slot[:, feat] >= la_cfg.rows).sum()),
                "fall_through": int(((plan.slot[:, feat] < 0)
                                     & (plan.cold[:, feat] >= 0)).sum())}
    if min(bag_plan["hot"], bag_plan["staged"], bag_plan["fall_through"]) <= 0:
        raise AssertionError(f"plan misses a branch: {bag_plan}")

    # None in a checkout from before the stacked launch (--wrappers skips it)
    stacked = getattr(kbag, "_stacked_cached_bag", None)
    kernels: dict = {}
    chosen: dict = {}  # the kernels line's instance: (args, output)
    launches = []
    for p in (grouped, solo, large, off):
        launches += p.dataflow_launches(raw, "apply")
    for p in (grouped, large, off):
        launches += p.dataflow_launches(raw, "fit")
    launches += dataflow_edges(df, core_ops, Source, grouped, raw)
    launches.append(byte_copy_instance(df, core_ops))
    launches += extra_instances(
        time_only, fit_chunks, raw, table, ids,
        lambda k: torch_parity.criteo_per_feature(
            CRITEO_VOCAB, features=k)(torch_parity.PORT),
        lambda: pipeline_iii_dense_as(Pipeline, Schema, core_ops, Vocab,
                                      np.float16))
    launches += [
        ("embedding_bag", "zipf1.1_nnz8", kops.embedding_bag, (table, ids)),
        ("embedding_bag_cached", "stacked_plan", stacked,
         (all_tables, planned["emb_cache"], planned["emb_slot"],
          planned["emb_cold"])),
        ("embedding_bag_cached", "two_level_plan", kops.embedding_bag_cached,
         (all_tables[feat], planned["emb_cache"][feat],
          planned["emb_slot"][:, feat:feat + 1],
          planned["emb_cold"][:, feat:feat + 1])),
        ("embedding_bag_cached", "cache_only_staged",
         kops.embedding_bag_cached, (table, staged_cache, staged_slot)),
        # dlrm_la_22's shape (FSDP gathers a rank's columns whole for the
        # step): rank 1's half of a 524288-row table, its cold ids shifted
        # into its rows (the other half's fall outside)
        ("embedding_bag_cached", "stacked_half_table", stacked,
         (half_tables, planned["emb_cache"], planned["emb_slot"],
          planned["emb_cold"] - DLRM_TP_VOCAB // 2))]
    if time_only:
        look_args = (all_tables, planned["emb_cache"], planned["emb_slot"],
                     planned["emb_cold"], host_sparse[:, :26].long().to("cuda"))

        def lookup_forward():
            with torch.no_grad():
                return la.cached_embedding_lookup(*look_args)

        calls = [(k, w, (lambda f=f, a=a: f(*a))) for k, w, f, a in launches
                 if f is not None]
        calls.append(("cached_embedding_lookup", "forward", lookup_forward))
        one = torch.zeros(1, device="cuda")
        calls.append(("floor", "one-element add", lambda: one.add_(1)))
        return time_wrappers(root, timer, calls, backend.LAUNCHES)
    for kname, what, fn, args in launches:
        got = as_tuple(fn(*args))
        want = as_tuple(fn.plain(*args))
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{kname}/{what}: {g.dtype}{list(g.shape)}"
                                     f" vs plain {w.dtype}{list(w.shape)}")
            if g.dtype.is_floating_point:
                torch.testing.assert_close(g, w, rtol=1e-5, atol=0,
                                           equal_nan=True)
                both = torch.isfinite(g) & torch.isfinite(w)
                d = (g[both].double() - w[both].double()).abs()
                err = max(err, float(d.max()) if d.numel() else 0.0)
            elif not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{kname}/{what}: {bad} integer "
                                     "entries differ from the plain version")
        if kname.startswith("embedding_bag") and not all(
                torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{kname}/{what}: not bit-equal to the "
                                 "plain version")
        nbytes, ops = work(kname, fn, args, got)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        kernel_t = timer(lambda: fn(*args))
        if kernel_t["ahead_share"] < AHEAD_FLOOR:
            raise AssertionError(f"{kname}/{what}: the host was ahead for "
                                 f"{kernel_t['ahead_share']} of the device "
                                 f"readings, below {AHEAD_FLOOR}")
        plain_t = timer(lambda: fn.plain(*args))
        lib_t, lib_err = {}, {}
        for form, call in library_calls(kname, args).items():
            t = timer(call)
            lib_t[form] = {"ms": t["ms"], "ahead_share": t["ahead_share"]}
            if kname.startswith("embedding_bag"):
                lib_err[form] = float((call() - got[0]).abs().max())
        bound_ms = max(t_bytes, t_ops)
        rec = {"name": kname, "what": list(what) if isinstance(what, tuple)
               else what, "dtype": str(got[0].dtype).replace("torch.", ""),
               "shape": list(got[0].shape), "bytes": nbytes, "ops": ops,
               "max_abs_err": err, **kernel_t, "plain_ms": plain_t["ms"],
               "plain_ahead_share": plain_t["ahead_share"],
               "library_ms": min(t["ms"] for t in lib_t.values())
               if lib_t else None,
               "library_by_form": lib_t, "library_max_abs_diff": lib_err,
               "bound_ms": bound_ms,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_share": bound_ms / kernel_t["ms"],
               "gbytes_per_s": nbytes / (kernel_t["ms"] * 1e-3) / 1e9}
        emit({"phase": "parity", **rec})
        # one entry per kernel: the main path's instance where it fixes
        # one, else the largest instance on these plans (no edge or extra
        # instance)
        path = PATH_INSTANCE.get(kname)
        if str(what).startswith("edge:") or what in EXTRA:
            continue
        if (kname not in kernels or what == path
                or (kernels[kname]["what"] != path
                    and rec["bytes"] > kernels[kname]["bytes"])):
            kernels[kname] = rec
            chosen[kname] = (args, got)
    # the stacked launch against the main path's former forward: one
    # single-feature launch per feature, then torch.stack
    st_args, st_got = chosen["embedding_bag_cached"]
    tabs, cache_, slot_, cold_ = st_args

    def per_feature():
        return torch.stack([kops.embedding_bag_cached(
            tabs[t], cache_[t], slot_[:, t:t + 1], cold_[:, t:t + 1])
            for t in range(tabs.shape[0])], dim=1)

    if not torch.equal(per_feature(), st_got[0]):
        raise AssertionError("stacked cached bag != 26 single-feature "
                             "launches stacked")
    emit({"phase": "stacked_vs_per_feature", "bit_equal": True,
          "stacked": kernels["embedding_bag_cached"]["ms"],
          "per_feature_and_stack": timer(per_feature)})

    del timer
    # cached == uncached on the card: the cache-only bag over every
    # distinct row staged against the plain bag on the same ids
    cached_out = kops.embedding_bag_cached(table, staged_cache, staged_slot)
    uncached_out = kops.embedding_bag(table, ids)
    torch.cuda.synchronize()
    if not torch.equal(cached_out, uncached_out):
        raise AssertionError("cached bag != uncached bag on the card")
    emit({"phase": "bag_equal", "bit_equal": True, "plan": bag_plan,
          "distinct_rows": len(uniq)})
    parity_launches = dict(df.LAUNCHES)
    # (the instances' list and the loop's last names hold the 26 tables
    # too: 10.5 GB the model-axis phases' ranks need)
    del (table, staged_cache, staged_slot, ids, all_tables, planned,
         cached_out, uncached_out, chosen, st_args, st_got, tabs, cache_,
         slot_, cold_, half_tables, launches, args, got, want, g, w)
    torch.cuda.empty_cache()
    for k in df.LAUNCHES:
        if k not in kernels:
            raise AssertionError(f"kernel {k} was never held against its "
                                 "plain version")

    def check_against_oracle(t, state, raw_batch, got: dict, what: str):
        oracle = t.compile("numpy")
        oracle.state = state
        want = oracle(raw_batch)
        for k, w in want.items():
            g = got[k].cpu().numpy()
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           err_msg=f"{what}/{k}")

    def backward_check(model, batch: dict) -> dict:
        """Two backward passes of the cached lookup on one planned batch:
        bit-equal table gradients, equal to the uncached gather's."""
        n = model.cfg.n_sparse
        orig = batch["sparse"][:, :n].long()
        g = torch.randn(orig.shape[0], n, model.cfg.d_emb, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))

        def grad(cached: bool):
            out = (la.cached_embedding_lookup(
                model.tables, batch["emb_cache"][:n], batch["emb_slot"][:, :n],
                batch["emb_cold"][:, :n], orig) if cached
                else model.tables[model._feat, orig])
            return torch.autograd.grad(out, model.tables, g)[0]

        first = grad(True)
        repeat = torch.equal(first, grad(True))
        uncached = torch.equal(first, grad(False))
        torch.cuda.synchronize()
        if not (repeat and uncached):
            raise AssertionError(f"cached backward: repeat equal {repeat}, "
                                 f"uncached equal {uncached}")
        return {"bit_equal_repeat": repeat, "bit_equal_uncached": uncached}

    def train_phase(t, cfg, n_batches: int, n_fit: int,
                    cache_cfg=None) -> dict:
        """EtlJob -> fit -> n_batches DLRM steps (through the lookahead
        embedding cache when ``cache_cfg`` is given); launch counts of the
        fit and of the training run, each zeroed just before it."""
        job = EtlJob(t, Source.synth("I", rows=n_batches * B, batch_size=B,
                                     seed=11),
                     backend="cuda",
                     fit_source=Source.synth("I", rows=n_fit * B,
                                             batch_size=B),
                     embed_cache=cache_cfg)
        df.reset_launch_counts()
        t0 = time.perf_counter()
        job.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(df.LAUNCHES)
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = dlrm.DLRM(cfg, generator=gen)
        tcfg = TrainConfig(lr=1e-3)
        state = TrainState.create(model, tcfg)
        step = make_train_step(dlrm.loss_fn, tcfg)
        cache = (la.EmbedCache(cache_cfg, cfg.n_sparse, cfg.d_emb)
                 if cache_cfg else None)
        first: dict = {}
        losses: list = []

        def tapped_step(st, batch):
            if not first:
                first.update({k: v.clone() for k, v in batch.items()})
            return step(st, batch)

        torch.cuda.reset_peak_memory_stats()
        df.reset_launch_counts()
        t0 = time.perf_counter()
        with job.batches() as ex:
            state = train_loop(state, tapped_step, ex,
                               LoopConfig(total_steps=n_batches, log_every=1),
                               on_metrics=lambda m: losses.append(m["loss"]),
                               embed_cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        apply_launches = dict(df.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stats = job.stats()
        if not (stats.consumed == n_batches == state.step):
            raise AssertionError(f"delivered {stats.consumed}, steps "
                                 f"{state.step}, want {n_batches}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != n_batches:
            raise AssertionError(f"losses {losses}")
        check_against_oracle(t, job.state, raw, first, "first batch")
        train_s = wall - stats.consumer_wait_s
        out = {"rows": n_batches * B, "steps": state.step,
               "fit_seconds": fit_s, "fit_chunks": n_fit,
               "n_unique": max(job.state.n_unique.values()),
               "params": cfg.param_count(), "wall_seconds": wall,
               "rows_per_s": n_batches * B / wall,
               "trainer_utilization": stats.trainer_utilization(train_s),
               "consumer_wait_s": stats.consumer_wait_s,
               "peak_mem_gb": peak_gb,
               "loss_first": losses[0], "loss_last": losses[-1],
               "losses": losses,
               "fit_launches": fit_launches, "launches": apply_launches,
               "stages": stats.stage_breakdown()}
        if cache_cfg is not None:
            out["cache"] = stats.cache.as_dict()
            out["lookahead_share_of_wall"] = (
                stats.stages["lookahead"].busy_s / wall)
            out["backward"] = backward_check(model, first)
        del state, model, job, first, cache
        torch.cuda.empty_cache()
        return out

    def expect(launches: dict, want: dict, what: str) -> None:
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")

    # ---- main path: EtlJob -> fit -> DLRM training -----------------------
    n_batches, n_fit = 16, 4
    main = train_phase(tmpl, dlrm.DLRMConfig(vocab_size=DLRM_VOCAB), n_batches,
                       n_fit)
    expect(main["fit_launches"], {"fit_dataflow": n_fit}, "main fit")
    expect(main["launches"], {"group_dataflow": n_batches}, "main apply")
    emit({"phase": "main", **main})

    # ---- lookahead path: EmbedCache + two-level cached bag ---------------
    look = train_phase(tmpl, dlrm.DLRMConfig(vocab_size=DLRM_VOCAB),
                       n_batches, n_fit, cache_cfg=la_cfg)
    expect(look["fit_launches"], {"fit_dataflow": n_fit},
           "lookahead_main fit")
    expect(look["launches"], {"group_dataflow": n_batches,
                              "embedding_bag_cached": n_batches},
           "lookahead_main train")
    rel = max(abs(a - b) / abs(b) for a, b in zip(look["losses"],
                                                   main["losses"]))
    look["loss_max_rel_diff_vs_main"] = rel
    emit({"phase": "lookahead_main", **look})
    if rel > 1e-6:
        raise AssertionError(f"lookahead_main losses differ from main's by "
                             f"{rel} (relative)")
    c = look["cache"]
    if min(c["hits"], c["staged"], c["overflow_cold"]) <= 0:
        raise AssertionError(f"a cache branch never ran: {c}")

    # ---- ungrouped path: one output kernel per output --------------------
    job2 = EtlJob(tmpl, Source.synth("I", rows=2 * B, batch_size=B, seed=12),
                  backend="cuda", optimize="off")
    job2.compiled.state = states["III"]
    df.reset_launch_counts()
    with job2.batches() as ex:
        n2 = sum(1 for _ in ex)
    torch.cuda.synchronize()
    solo_launches = dict(df.LAUNCHES)
    if n2 != 2:
        raise AssertionError(f"ungrouped path: {n2} batches")
    expect(solo_launches, {"output_dataflow": 3 * n2}, "ungrouped")
    emit({"phase": "ungrouped", "batches": n2, "launches": solo_launches})

    # ---- staged main path: HBM-placed 4 M-entry vocabulary ---------------
    # facebookresearch/dlrm bench/dlrm_s_criteo_kaggle.sh widths
    cfg_kaggle = dlrm.DLRMConfig(vocab_size=LARGE_VOCAB + 1, d_emb=16,
                                 bot_mlp=(512, 256, 64, 16),
                                 top_mlp=(512, 256, 1))
    staged = train_phase(tmpl_large, cfg_kaggle, n_batches, n_fit)
    expect(staged["fit_launches"], {"fused_stage": n_fit,
                                    "vocab_build_chunk": n_fit},
           "staged_main fit")
    expect(staged["launches"], {k: n_batches for k in (
        "group_dataflow", "fused_stage", "vocab_lookup", "packer")},
        "staged_main apply")
    emit({"phase": "staged_main", **staged})

    # ---- staged_off: every output and the fit stage at a time ------------
    job3 = EtlJob(tmpl, Source.synth("I", rows=2 * B, batch_size=B, seed=12),
                  backend="cuda", fuse="off",
                  fit_source=Source.synth("I", rows=2 * B, batch_size=B))
    df.reset_launch_counts()
    job3.fit()
    torch.cuda.synchronize()
    off_fit = dict(df.LAUNCHES)
    expect(off_fit, {"fused_stage": 2, "vocab_build_chunk": 2},
           "staged_off fit")
    fused_fit = tmpl.compile("cuda")
    fused_fit.fit(iter(Source.synth("I", rows=2 * B, batch_size=B)))
    for vid, t in fused_fit.state.tables.items():
        np.testing.assert_array_equal(job3.state.tables[vid], t,
                                      err_msg="staged fit vs fused fit")
    first3: dict = {}
    df.reset_launch_counts()
    with job3.batches() as ex:
        for batch in ex:
            if not first3:
                first3 = {k: v.clone() for k, v in batch.items()}
    torch.cuda.synchronize()
    off_apply = dict(df.LAUNCHES)
    expect(off_apply, {"fused_stage": 4, "vocab_lookup": 2, "packer": 4},
           "staged_off apply")
    raw3 = next(iter(Source.synth("I", rows=B, batch_size=B, seed=12)))
    check_against_oracle(tmpl, job3.state, raw3, first3, "staged_off")
    staged_p = job3.compiled
    fused_fit.state = staged_p.state
    cols = staged_p._device_columns(raw3)
    timer = DeviceTimer()
    apply_ms = {}
    for label, p in (("grouped", fused_fit), ("staged", staged_p),
                     ("staged_again", staged_p), ("grouped_again", fused_fit)):
        tables = p._device_tables(p.state)
        apply_ms[label] = timer(lambda: p._apply_fn(tables, cols))
    del timer
    emit({"phase": "staged_off", "batches": 2, "fit_launches": off_fit,
          "launches": off_apply,
          "lowering": {k: v["path"]
                       for k, v in staged_p.lowering_report().items()},
          "apply_ms": apply_ms})

    # ---- the online path: bus -> OnlineTrainer (refits, shedder) ---------
    online = online_main(tmpl, states["III"], expect)
    emit({"phase": "online_main", **online})
    emit({"phase": "online_ckpt", **online_ckpt(root, expect)})
    emit({"phase": "autotune_main",
          **autotune_main(tmpl, states["III"], expect)})

    # ---- multitenancy, then the ETL-fed LM trainer -----------------------
    mt = multitenant_main(expect)
    emit({"phase": "multitenant_main", **mt})
    emit({"phase": "lm_ckpt", **lm_ckpt(root, expect)})
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_main(root, expect)
    emit({"phase": "lm_main", **lm})

    # ---- the MoE family and Adafactor ------------------------------------
    moe_ck = lm_ckpt(root, expect, batch=16, arch=MOE_CKPT_ARCH, every=2,
                     name="moe_ckpt")
    emit({"phase": "moe_ckpt", **moe_ck})
    moe = moe_main(root, expect)
    emit({"phase": "moe_main", **moe})
    af = adafactor_main(root, expect)
    emit({"phase": "adafactor_main", **af})

    # ---- serving, the SSM family and the VLM prefix ----------------------
    free_memory()
    srv = serve_main(root, expect)
    emit({"phase": "serve_main", **srv})
    free_memory()
    smoe = serve_moe(root, expect)
    emit({"phase": "serve_moe", **smoe})
    free_memory()
    ssm_ph = ssm_main(root, expect)
    emit({"phase": "ssm_main", **ssm_ph})
    free_memory()
    vlm = vlm_main(root, expect)
    emit({"phase": "vlm_main", **vlm})

    # ---- the hybrid and enc-dec families ---------------------------------
    free_memory()
    hyb = hybrid_main(root, expect)
    emit({"phase": "hybrid_main", **hyb})
    free_memory()
    ed = encdec_main(root, expect)
    emit({"phase": "encdec_main", **ed})

    # ---- the dry run's process: traces on the host from here on, beside
    # the distribution phases and weight-gathered serving ----------------
    free_memory()
    dry = start_dryrun()
    with stopped_on_error(dry):
        # ---- data-parallel distribution -------------------------------------
        free_memory()
        dist1 = dist_main(root, expect)
        emit({"phase": "dist_main", **dist1})
        free_memory()
        kimi = dist_kimi(root, expect)
        emit({"phase": "dist_kimi", **kimi})
        free_memory()
        dist2 = dist_ranks2(root, expect)
        emit({"phase": "dist_ranks2", **dist2})

        # ---- the "model" axis: tensor, expert and row parallelism -----------
        free_memory()
        tp2 = model_axis_phase("tp_ranks2", TP_ARCH, TP_LAYERS, TP_STEPS,
                               expect, LM_BATCH, LM_SEQ)
        emit({"phase": "tp_ranks2", **tp2})
        free_memory()
        ep2 = model_axis_phase("ep_ranks2", EP_ARCH, EP_LAYERS, EP_STEPS,
                               expect, LM_BATCH, LM_SEQ)
        emit({"phase": "ep_ranks2", **ep2})
        free_memory()
        dtp2, dla2 = dlrm_tp2(expect)
        emit({"phase": "dlrm_tp2", **dtp2})
        emit({"phase": "dlrm_la_22", **dla2})

        # ---- the model axis for the SSM, hybrid and enc-dec families --------
        free_memory()
        stp2 = model_axis_phase("ssm_tp2", SSM_ARCH, SSM_TP_LAYERS,
                                SSM_TP_STEPS, expect, LM_BATCH, LM_SEQ)
        emit({"phase": "ssm_tp2", **stp2})
        free_memory()
        htp2 = model_axis_phase("hybrid_tp2", HYBRID_ARCH,
                                HYBRID_TP_LAYERS, HYBRID_TP_STEPS, expect,
                                LM_BATCH, HYBRID_TP_SEQ)
        emit({"phase": "hybrid_tp2", **htp2})
        if htp2["shared_applications"] < 2:
            raise AssertionError("hybrid_tp2: the shared block is applied "
                                 "fewer than twice")
        free_memory()
        etp2 = encdec_tp2(expect)
        emit({"phase": "encdec_tp2", **etp2})

        # ---- weight-gathered serving ----------------------------------------
        free_memory()
        sfsdp = serve_fsdp(expect, serve_kw={"new": SERVE_FSDP_NEW})
    emit({"phase": "serve_fsdp", **sfsdp})
    emit({"phase": "dryrun", "card": smi,
          **dryrun_phase(dry, sfsdp["rank0_prefill"])})

    path_launches = {"group_dataflow": main["launches"]["group_dataflow"],
                     "fit_dataflow": main["fit_launches"]["fit_dataflow"],
                     "output_dataflow": solo_launches["output_dataflow"]}
    for k in ("fused_stage", "vocab_build_chunk", "vocab_lookup", "packer"):
        path_launches[k] = staged["fit_launches"][k] + staged["launches"][k]
    path_launches["embedding_bag_cached"] = \
        look["launches"]["embedding_bag_cached"]
    # no driven path runs embedding_bag (in the JAX package only tests and
    # a benchmark do): its count is the parity phase's
    path_launches["embedding_bag"] = parity_launches["embedding_bag"]
    out = []
    for name in REPLACES:
        r = kernels[name]
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/" + SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": path_launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "ms_enqueued": r["ms_enqueued"], "host_us": r["host_us"],
                    "ahead_share": r["ahead_share"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "what": r["what"]})
        if name == "embedding_bag":
            out[-1]["launches_from"] = "parity phase"
        if name in online["launches"]:
            out[-1]["launches_online_main"] = online["launches"][name]
        mt_n = (mt["run"]["launches"].get(name, 0)
                + sum(f.get(name, 0) for f in mt["fit_launches"].values()))
        if mt_n:
            out[-1]["launches_multitenant_main"] = mt_n
        for label, ph in (("lm_main", lm), ("moe_ckpt", moe_ck),
                          ("moe_main", moe), ("adafactor_main", af),
                          ("serve_main", srv), ("serve_moe", smoe),
                          ("ssm_main", ssm_ph), ("vlm_main", vlm),
                          ("hybrid_main", hyb), ("encdec_main", ed),
                          ("dist_main", dist1), ("dist_kimi", kimi),
                          ("dist_ranks2", dist2),
                          ("tp_ranks2", tp2), ("ep_ranks2", ep2),
                          ("dlrm_tp2", dtp2), ("dlrm_la_22", dla2),
                          ("ssm_tp2", stp2), ("hybrid_tp2", htp2),
                          ("encdec_tp2", etp2), ("serve_fsdp", sfsdp)):
            if ph["launches"].get(name):
                out[-1][f"launches_{label}"] = ph["launches"][name]
            per_rank = [c.get(name, 0) for c in ph.get(
                "launches_per_rank",
                [o["launches"] for o in ph.get("ranks", ())])]
            if label.endswith(("_tp2", "_22")) and any(per_rank):
                out[-1][f"launches_{label}_per_rank"] = per_rank
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def extra_instances(time_only: bool, fit_chunks, raw, table, ids,
                    criteo, dense_f16) -> list:
    """The wider plans' and dtypes' parity instances, ``(kernel, what,
    runner, args)``: ``criteo26_group`` and ``criteo4_group`` (fitted on
    the CPU through the plain versions, as the other plans are; ``criteo(k)``
    is the plan of the first k features), ``criteo4_group:wide``,
    ``out:float16`` for the group kernel and the packer, ``bag:bfloat16``,
    ``fill_only``, and the packer over 26 int32 [B, 1] blocks into int32
    [B, 32] (``pack:26x1``, the small struct) and over 128 float32 and
    int32 [B, 1] blocks in turn into int32 [B, 128] (``pack:128x1``, the
    wide struct at its maximum): ``fuse="off"``'s layout of per-column
    chains.  With ``time_only`` (``--wrappers`` on another
    checkout) an instance that checkout cannot build is skipped, with a
    line that says so; otherwise a failure is the phase's."""
    import torch

    fitted = {}  # k -> (the plan, its state), each fitted once

    def per_feature(k: int, forced_wide: bool = False):
        if k not in fitted:
            t = criteo(k)
            host = t.compile("cuda", device="cpu")
            host.fit(iter(fit_chunks))
            fitted[k] = t, host.state
        t, state = fitted[k]
        p = t.compile("cuda")
        p.state = state
        ((kname, _, fn, args),) = p.dataflow_launches(raw, "apply")
        if p.lowering_report()["sparse"]["path"] != "grouped":
            raise AssertionError(f"criteo{k}: {p.lowering_report()}")
        if forced_wide:
            if getattr(fn.program, "wide", None) is not False:
                raise NotImplementedError("no small program to force wide")
            fn.program.wide, fn.program.template = True, None
        return kname, fn, args

    def criteo26():
        kname, fn, args = per_feature(26)
        return [(kname, "criteo26_group", fn, args)]

    def criteo4():
        kname, fn, args = per_feature(4)
        return [(kname, "criteo4_group", fn, args)]

    def criteo4_wide():
        kname, fn, args = per_feature(4, forced_wide=True)
        return [(kname, "criteo4_group:wide", fn, args)]

    def out_f16():
        out = []
        for fuse, kname in (("auto", "group_dataflow"), ("off", "packer")):
            t = dense_f16()
            host = t.compile("cuda", device="cpu", fuse=fuse)
            host.fit(iter(fit_chunks[:1]))
            p = t.compile("cuda", fuse=fuse)
            p.state = host.state
            for k, _, fn, args in p.dataflow_launches(raw, "apply"):
                got = fn(*args)
                got = got if isinstance(got, tuple) else (got,)
                if k == kname and any(g.dtype == torch.float16 for g in got):
                    out.append((k, "out:float16", fn, args))
        if len(out) != 2:
            raise AssertionError(f"out:float16: {len(out)} instances")
        return out

    def bag_bf16():
        from repro_torch.kernels import ops as kops
        tb = table.to(torch.bfloat16)
        kops.embedding_bag(tb, ids[:1])  # refused by a checkout without it
        return [("embedding_bag", "bag:bfloat16", kops.embedding_bag,
                 (tb, ids))]

    def one_column_packers():  # fuse="off"'s layout of per-column chains
        import numpy as np
        from repro_torch.kernels import ops as kops
        gen = torch.Generator(device="cuda").manual_seed(17)
        out = []
        for what, dtypes, pad in (
                ("pack:26x1", [np.int32] * 26, 32),
                ("pack:128x1", [np.float32, np.int32] * 64, 128)):
            fn = kops.packer([1] * len(dtypes), dtypes, np.int32,
                             pad_cols_to=pad)
            blocks = [torch.randn(B, 1, generator=gen, device="cuda") * 300
                      if d is np.float32 else
                      torch.randint(0, 1 << 20, (B, 1), generator=gen,
                                    device="cuda", dtype=torch.int32)
                      for d in dtypes]
            out.append(("packer", what, fn, blocks))
        return out

    def fill_only():  # at the staged path's capacity
        from repro_torch.kernels import ops as kops
        return [("vocab_build_chunk", "fill_only", kops.vocab_build_chunk,
                 (torch.empty(0, dtype=torch.int32, device="cuda"),
                  LARGE_VOCAB))]

    out = []
    for make in (criteo26, criteo4, criteo4_wide, out_f16, bag_bf16,
                 fill_only, one_column_packers):
        try:
            out += make()
        except (NotImplementedError, ValueError) as e:
            if not time_only:
                raise
            emit({"phase": "wrappers", "skipped": make.__name__,
                  "error": f"{type(e).__name__}: {e}"[:300]})
    return out


def time_wrappers(root: str, timer: DeviceTimer, calls: list,
                  counts: dict) -> int:
    """``--wrappers``: one line per call ``(name, what, fn)`` of the
    checkout at ``root``: its launches, a checksum of its output and its
    timer readings."""
    import torch

    for kname, what, fn in calls:
        before = dict(counts)
        out = fn()
        out = out[0] if isinstance(out, tuple) else out
        torch.cuda.synchronize()
        emit({"phase": "wrappers", "checkout": root, "name": kname,
              "what": list(what) if isinstance(what, tuple) else what,
              "launches_per_call": {k: v - before[k] for k, v in
                                    counts.items() if v != before[k]},
              "shape": list(out.shape),
              "checksum": float(out.double().sum()), **timer(fn)})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--wrappers"] and len(sys.argv) == 3:
        sys.exit(main(os.path.abspath(sys.argv[2]), time_only=True))
    if len(sys.argv) > 1:
        print(f"usage: {sys.argv[0]} [--wrappers DIR]", file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
