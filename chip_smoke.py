#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --only kernels
    python3 chip_smoke.py --only placed   # the kernel checks, then 8e-8h

Phases, one summary line each (any failure exits non-zero, nothing is
caught):

1. require CUDA and the port's sources beside the script (run alone, the
   script fails here); print the card's name and power limit
   (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` each, in
   parallel) and print the build time and, per compiled kernel function
   (every dtype and head dim), ``ptxas``'s registers, spills and shared
   memory;
3. hold each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes, in bf16 and fp32: max error and tolerance, the
   kernel's device time, the plain version's time, the bound (the least time the
   card could take: bytes over 3.35 TB/s or flops over the dtype's peak,
   whichever is larger) and one PyTorch library call as a yardstick
   (SDPA for flash, ``torch.bmm`` for the grouped matmul; none exists for
   paged decode or the RG-LRU scan), and the host time of one call
   (``host_us``) for paged decode, flash and the grouped matmul.  Paged
   decode at qwen3's K=8 and qwen2-moe's K=16, with ragged row positions
   and at the served decode's (512-543), and at K=8 at phase 4d's decode
   step (16 rows of 100 pages, positions 1536-1599, two rows prefilling
   with all-trash tables), and its split count; flash at both K; the
   grouped matmul at qwen2-moe's prefill and decode shapes (gate/up and
   down), with routed group sizes, whose rows past each group must be
   exactly 0, and the variant that ran at each shape (wgmma for the bf16
   prefill, skinny for the decode step in both dtypes, fp32 for the fp32
   prefill), and at a chunked prefill's capacities (phase 4e's 8 rows x
   256 tokens: C 170, gate/up and down, wgmma in bf16; one row x 256
   tokens: C 21, wmma; phase 8a's rank of 32 local experts, 28 live, at
   C 341, bf16); the
   RG-LRU scan at recurrentgemma-9b's prefill shape (8, 512, 4096), a
   ragged (3, 300, 130) and a long decay (a = 0.999, S = 2048); and the
   modal families' shapes in bf16 (``FLASH_CASES``, ``PAGED_CASES``):
   flash non-causal at seamless's encoder (B8 H16 K16 S1,024 hd64), at its
   cross-attention (Sq 512 x Sk 1,024, also fp32) and causal at its
   decoder (S 512 hd64), causal at pixtral's B8 H32 K8 S1,536 hd128, paged
   decode at seamless's step (MHA K16 hd64) and glm4's (H32 K2 hd128, two
   head groups per KV head), flash causal at phase 8b's data-parallel
   rank (B4 H16 K8 S1,024), each with SDPA's time beside it where one
   exists; and the flash backward kernel at every training shape its
   phases launch it at (``FLASH_BWD_CASES``), with SDPA's backward alone
   as its library yardstick;
3b. the cost model's spec: bf16 ``torch.matmul`` device times over
   ``SPEC_SHAPES`` and the host time of launching one small op, each
   shape's measured time (device + launch) beside
   ``op_time(..., H100)``, which must agree within 3x; and the spec's
   four fitted constants refitted to this run's times
   (``repro_torch/core/costmodel.py`` holds one such fit);
3c. the planner on the serving path: full-width qwen3-0.6b serves the
   mix-shift trace of ``tests/test_torch_serving.py`` (three chat
   requests, a fourth inside the same quantized mix, a code request
   joining mid-trace and leaving, then the drain; prompts of 300 and 400
   tokens, so the prefill takes flash) with ``replan="off"`` (first: it
   carries the warm-up) and ``"mix"``: equal tokens, the replans full,
   full, hit for the first shifts and none for the churn, the launch
   counts of phase 4 in each run; each replan's ``planning_seconds`` and
   the plan's makespan;
4. serve full-width, full-depth qwen3-0.6b (random weights from a seed):
   8 requests, prompt 512, 32 new tokens, 8 slots, page size 16, bf16
   cache, through ``repro_torch.launch.serve.serve`` with its default
   ``replan="mix"``; the launch counters are zeroed just before and read
   just after, and flash launches must equal 28 x prefill calls, paged
   launches 28 x decode steps, and every other kernel 0; tok/s and
   ``planning_seconds`` (tok/s counts planning time);
4b. serve full-width, full-depth qwen2-moe-a2.7b the same way: flash
   launches must equal 24 x prefill calls, paged 24 x decode steps,
   grouped matmul 72 x (prefill calls + decode steps), the scan 0;
4c. serve full-width, full-depth recurrentgemma-9b the same way: RG-LRU
   scan launches must equal 26 (its rglru layers of 38) x prefill calls,
   and flash, paged and grouped matmul 0 (its 12 local-attention layers
   run no kernel);
4d. chunked prefill, prefix sharing and grow admission at full width:
   full qwen3-0.6b serves 16 requests in 16 slots, arriving at once, each
   a 1,536-token prompt (a 1,000-token shared prefix, not a multiple of
   the page size, and a 536-token private suffix) and 64 new tokens, in
   256-token chunks at duty 1.0 — (a) with sharing and grow admission,
   (b) without sharing, reserve admission, each after a 2-token warm-up
   run of its own (so neither carries the first calls at the chunks'
   shapes).  Flash launches 0 (every admission is a chunk job), paged 28
   x decode steps, the rest 0 in each run; in (a) chunk steps, interleaved chunks and grown pages > 0, the
   hit rate 15 x 1,000 / (16 x 1,536), 15 forks and the index's shared
   maps; (a)'s page high-water below (b)'s; tokens in the vocabulary;
4e. full qwen2-moe-a2.7b chunked through ``serve``: 8 requests x
   512-token prompts x 16 new tokens in 256-token chunks, one job (C 170):
   flash 0, paged 24 x decode steps, grouped matmul 72 x (chunk steps +
   decode steps), the scan 0 (run right after 4b, on 4b's model: the
   weights are drawn once);
4f. serve full seamless-m4t-medium (12 + 12 layers, d 1,024, MHA hd 64,
   vocab 256,206; bf16) through ``serve``: 8 requests at once, each 512
   prompt tokens and 1,024 frames (``enc_len`` 1,024), 32 new tokens, 8
   slots, page size 16: flash 36 (12 encoder + 12 self + 12 cross) x
   prefill calls, paged 12 x decode steps, the rest 0;
4g. full pixtral-12b (40 layers, d 5,120, GQA 32:8): each request carries
   1,024 patch embeddings (one image) before 512 prompt tokens: flash 40
   x prefill calls, paged 40 x decode steps, the rest 0;
4h. full glm4-9b (40 layers, d 4,096, 32 query heads over 2 KV heads) on
   8 x 512 x 32: flash 40 x prefill calls, paged 40 x decode steps; each
   of 4f-4h frees its model before the next phase loads;
4i. serve full xlstm-125m (12 layers, d 768: 9 mLSTM + 3 sLSTM, 4 heads of
   192, vocab 50,304; bf16 compute, fp32 states) on 8 x 512 x 32 with
   ``replan="mix"``, on ``kv_layout="paged"`` and on ``"slab"``: no kernel
   launched in either (the model has no attention), tokens equal between
   the layouts (both hold only slot-major state, so the arithmetic is the
   same); then one prefill and decode steps under ``launch/profile.py``'s
   ``profile_serve`` (device time by group, busy and idle shares, events
   per step);
4j. serve full qwen3-0.6b at phase 4's shape on ``kv_layout="slab"``: flash
   28 x prefill calls, paged decode 0 (slab decode is plain arithmetic, as
   in JAX), the share of greedy tokens equal to phase 4's paged run
   (reported: the slab path rounds the attention weights to bf16, the
   paged kernel keeps them fp32); then the slab decode step under
   ``profile_serve``;
5. serve the reduced qwen3 in fp32 from one seed on ``cuda`` and on ``cpu``
   and require identical tokens (the kernels against the plain path);
5b. the same for the reduced qwen2-moe (4 requests in 4 slots, all live);
5c. the same for the reduced recurrentgemma (prompt 300 > its 64-token
   window: the prefill's roll and the circular decode buffers run);
5d. the reduced qwen3 in fp32 on the shared-prefix bursty trace of
   ``tests/test_serving.py`` (two bursts of five chat and two code
   requests) with 8-token chunks, sharing and grow admission in a pool
   small enough to pause or preempt: identical tokens and identical chunk
   steps, forks, shared maps, grown pages, paused steps and preemptions
   on ``cuda`` and ``cpu``;
5e. the reduced qwen2-moe chunked (4 requests x 40-token prompts in one
   job of 16-token chunks): identical tokens on ``cuda`` and ``cpu``;
5f. the reduced seamless in fp32 (prompt 300 and 300 frames: the
   encoder, self- and cross-attention all take the fp32 flash kernel),
   identical tokens on ``cuda`` and ``cpu``;
5g. the same for the reduced pixtral (16 patch embeddings + 300 tokens);
5h. the same for the reduced qwen3 on the slab layout (the prefill's flash
   kernel at S 300, slab decode) and for the reduced xlstm on the paged and
   the slab layouts;
6. train full-width qwen3-0.6b (28 layers, d 1024, vocab 151,936; bf16
   compute, fp32 masters and moments, block remat) through
   ``repro_torch.launch.train.train``: batch 8 x seq 1,024 (so every
   layer's attention is the flash kernel), 8 steps on ``SyntheticLM``;
   per step the loss, ms and tok/s, and the peak device memory; flash
   launches must be 2 x 28 per step (forward and remat recompute), the
   flash backward's 28, and every other kernel 0; every loss finite, the last below the first;
   then the same steps with kernels off (plain attention on the card):
   per-step losses equal within 2^-7 relative (bf16 compute);
6b. reduced qwen3 in fp32, 3 train steps at seq 320 (the fp32 flash
   kernel and its fp32 backward kernel) on ``cuda`` against the plain
   path on ``cpu``: losses and final params within 1e-4;
6c. the wavefront training path: a bound ``SpindleSession`` over
   ``tiny_multitask_clip`` and over ``tiny_ofasys`` on ``cuda``: engine
   loss and gradients equal to autograd of ``reference_loss`` before and
   after a ``TaskCompleted`` replan, the loss history equal to the
   ``cpu`` run's within 1e-5 through the first step on the rebound
   engine and 1e-4 after the replan's restart of Adam's moments; then a
   wider clip (d 512, batch 16) through the same session, step times and
   waves;
6d. reduced seamless and pixtral in fp32, loss and every gradient at
   S 300 (frames 300; a 16-position stub) on ``cuda`` (flash forward and
   backward kernels) against ``cpu``: within 1e-4;
6e. train qwen2-moe-a2.7b at full width cut to 4 layers (3.04 B params;
   the full 15.1 B do not fit a card with gradients and moments): bf16
   params and compute as the config has them, fp32 moments, block remat,
   batch 4 x seq 1,024 (capacity 341: the grouped matmul at phase 3's
   prefill shape), 4 steps through ``make_train_state`` / ``train_step``,
   kernels on and off; launches per step derived from the layer kinds
   (``train_launches_per_step``: grouped matmul 9 per layer — forward,
   recompute, dx — flash 2 and its backward 1) and printed before the
   run, asserted
   exactly; losses finite and falling, on/off within 2^-7 relative, peak
   below 76 GB; then one more step under ``launch/profile.py``'s
   ``profile_train_step`` (device time by group);
6f. the same for recurrentgemma-9b cut to 5 layers (two remainder rglru
   layers, then one rglru, rglru, local_attn group: the full model's
   order; 3.22 B params): scan 10 per step (2 for each remainder layer,
   3 for each group layer: forward, recompute, reverse), no other kernel;
6g. reduced qwen2-moe and recurrentgemma in fp32: one loss and every
   gradient at S 320 on ``cuda`` (kernels, with the predicted launches)
   against ``cpu``, then 3 ``train`` steps at lr 1e-5: losses,
   gradients and params within 1e-4;
6h. reduced xlstm in fp32 the same way (no kernel: the cells are plain
   PyTorch): loss and params within 1e-4, gradients within 1e-4 plus 1e-3
   of each leaf's largest entry (the tied embedding's gradient is
   ill-conditioned through the mLSTM normaliser: on the CPU a 1e-7
   relative change of the params moves it by 4.9e-4); then 3 steps of
   full xlstm-125m (bf16 compute, fp32 masters and moments, block remat)
   at batch 4 x seq 256, the last step replaying the first batch: the
   loss must fall, no kernel launched; step ms and peak memory;
6i. checkpoints on the card: full xlstm-125m through ``train`` at batch 4
   x seq 128, one 6-step schedule run (a) through, (b) with
   ``ckpt_dir``, ``ckpt_every=3`` and ``stop_at_step=4`` (saves at steps 0
   and 3, no final save) and (c) resumed from step 3 (steps 4-5, the final
   save at 5): (c)'s losses equal (a)'s within 1e-5 relative (the
   reference's ``test_train_resume_exact``), the loss and final-param
   diffs printed with whether they are bitwise equal, no kernel launched;
   the bytes of one step on disk and the seconds of each save and of the
   restore (host clock); then an ``AsyncCheckpointManager`` snapshot of a
   live full xlstm state, timed on the step turn (the device-to-host
   copy) against the writer's time to durability, followed at once by an
   in-place train step: the restored snapshot equals the pre-step params
   and moments bit for bit; then reduced qwen2-moe in fp32 (the grouped
   matmul forward, recompute and dx) interrupted and resumed the same way
   at lr 1e-5: launches as ``train_launches_per_step`` predicts, (c)
   within 1e-4 of (a). Each checkpoint lives in its own
   ``tempfile.mkdtemp()`` directory, deleted at the end;
6j. crash recovery on the wavefront path: ``crash_smoke`` (a bound
   session planned for a simulated 8-device cluster of 4 hosts, the
   engine on the one card; host 1 killed after step 3 of 8, async
   snapshots every 2 steps) prints ``[crash] OK`` on ``cuda`` and on
   ``cpu`` (history equal to the uninterrupted run on the survivors within
   1e-6, rollback steps = 3 - restored step, the dead devices unplaced, a
   durable snapshot), the two histories within 1e-5; the cooperative
   straggler restore on ``cuda`` (mode ``"restore"`` at step 1, the next
   loss equal to ``reference_loss`` on the snapshot within 1e-6); a
   transient flap of host 1 (two restores, the cluster whole at the end);
   no kernel launched;
7. the fleet (``repro_torch.fleet.FleetScheduler``) on 8 hosts of 4
   cards under ``FleetConfig``'s defaults (the H100 spec, 80 GB): the
   smoke mix of ``launch/fleet.py`` (two duplicate multitask_clip train
   jobs) and a serve job of full-width, full-depth qwen3-0.6b passed in
   through ``model_cache`` (bf16; 8 requests, one admitted per serving
   step, prompt 512, 32 new tokens, 8 slots, cache 544, page size 16),
   host 7 flagged a straggler at tick 6: every job drains, the arbiter's
   invariants hold, at least one rebalance, post-rebalance steps for every
   survivor, a cross-job plan-cache hit; launches counted from 0 over the
   run: flash 28 x prefill calls, paged 28 x decode steps, the rest 0; wall
   seconds, the serve job's tok/s (output tokens over busy seconds), the
   virtual makespan, device idle share and ticks;
7b. the ``colocate`` policy at full width: one multitask_clip train job
   (24 steps) hosting phase 7's serve job as a co-resident tenant, whose
   first step (before it has a plan) is priced by its planner: at
   least one tenant step inside a training idle window, no grant held at
   any tenant step, its KV page high-water within the window headroom it
   was budgeted against, the launch rule, and its tokens equal to a solo
   ``ServingSession`` (``replan="off"``) on the same model and trace;
   windows seen and deferred, the KV budget in bytes;
7c. host loss: ``tests/test_faults.py:440``'s fleet (multitask_clip x 12,
   a reduced qwen3 fp32 serve job, hosts 4 and 5 killed at step 6) on
   ``cuda`` and on ``cpu``: one host failure, requests requeued, identical
   ``metrics()`` and tokens; then phase 7's mix with host 7 killed at tick
   6: the serve job requeues, and the share of its tokens equal to phase
   7's is reported (a re-prefill in another batch may flip a bf16 greedy
   token);
8. training on a mesh of ranks (``train(mesh=)``; ``parallel.mesh.
   run_ranks`` spawns the ranks, each counting its own launches from 0
   and reporting its step ms, peak memory, collective bytes and a
   sha256 of every parameter it holds after the run; in 8a-8c every
   replicated parameter must hash alike on all ranks): a world
   of one process on NCCL, a (1, 1) mesh, reduced qwen2-moe fp32 for 3
   steps, equal to ``train(mesh=None)`` bit for bit, and one NCCL
   all-reduce;
8a. expert parallelism at full width: 6e's qwen2-moe cut to 4 layers
   (bf16 params, 4 x 1,024, 2 steps) on two ranks that share the card
   through gloo, mesh (data 1, model 2): 32 experts a rank, the grouped
   matmul at E 32, C 341, 36 launches a step on each rank (9 a MoE
   layer) and flash 8; against one one-process run: the first loss
   bit-equal, each within 5e-3; the ranks' peaks together below 76 GB;
8b. data parallelism at full width: full qwen3-0.6b, phase 6's global
   batch 8 x 1,024 split over two ranks (data 2), 2 steps: flash 56
   and its backward 28 launches a rank and step, the losses within 1e-3 of one one-process
   run; then ``compress_grads=True`` (int8 sync): the first losses
   equal and the last within 0.05 (``tests/test_compressed_dp.py``);
8c. re-mesh across world sizes: reduced qwen2-moe fp32 on two ranks
   (model 2) for 2 of 4 steps, checkpointing the logical arrays; one
   process resumes (``restore_to_mesh``) and trains steps 2-3 equal to
   the uninterrupted 2-rank run's within 1e-5; the EP checkpoint's names
   and shapes equal the one-process checkpoint's;
8d. the distributed wavefront engine: four ranks share the card through
   gloo (each move staged through host memory), plan device ``d`` is rank
   ``d`` of ``ClusterSpec(n_devices=4, island_size=2, devices_per_host=1)``;
   (a) ``tiny_multitask_clip`` and ``tiny_ofasys`` (3 tasks, d 512, batch
   16) in fp32: every rank's loss and gradients equal autograd of
   ``reference_loss`` on the card within 1e-5 / 1e-4; (b) a distributed
   clip session with a checkpoint manager in a directory the ranks share
   and a scripted straggler on host 1 after step 2, 6 steps: one restore of
   step 2, no step on rank 1 after it, live mesh ``[0, 2, 3]`` (its
   3-rank groups run on their lowest rank), losses within 1e-4 of a
   one-process session on the card driven by the same events; (c) every
   parameter hashes alike on the live ranks; (d) the JAX CI gate's
   command, ``python -m repro_torch.launch.train --elastic-smoke --steps 8
   --straggler-at 3 --straggler-hosts 1 --ranks 4``, as a subprocess: its
   transcript holds ``replan mode=restore`` and ``loss <x>  (post-restore)``.
   Each rank's step ms, the plan steps and waves it ran, its bytes a step
   (moves and all-reduce apart) and peak memory are printed; no kernel is
   on this path (its launch counts must stay 0);
8e. the placed steps (``launch/steps.py``): four ranks share the card
   through gloo on (data 2, model 2); full qwen3-0.6b placed by the rules
   (FSDP over data; heads, FFN and vocab over model), 2 train steps at 8 x
   1,024 (each step's loss within ``PLACED_LOSS_TOL`` of one process's
   train steps on the same batches; flash 56 and its backward 28 launches
   a rank and step at B4 H8 K4 S1024), a prefill of 8 x 512 (flash 28 a rank; logits within
   ``PLACED_LOGITS_TOL`` of one process's, two controls above it) and 8
   greedy serve steps (a share of at least ``PLACED_TOKENS_MIN`` of the
   tokens equal to one process's); each rank's step
   ms, peak memory and bytes by collective kind are printed; then reduced
   fp32 qwen3, qwen2-moe (the grouped matmul on each rank's 4 local
   experts), llama3-405b (a decode cache split over the sequence),
   recurrentgemma (the scan on each rank's features, decoding past its
   window of 64: the circular buffer's writes wrap across the ranks'
   blocks of positions), xlstm and seamless on the card against the same
   four ranks on the CPU (one spawn), within ``TRAIN_PARITY_TOL``; with
   them (``PLACED_REDUCED``) the train steps of qwen3, qwen2-moe (expert
   parallelism under SP) and recurrentgemma at 4 layers (a remainder layer
   outside SP) with ``seq_parallel=True``, and the paper baseline's MoE
   (``shard_experts=False``): 8 unpadded experts (the expert-parallel
   branch re-lays the hidden-split stacks into each rank's experts), 5
   experts on a model-only (1, 4) mesh (the global batch, the grouped
   matmul on each rank's 16 of 64 hidden columns, partial sums over
   "model");
8h. Megatron-SP at full width, in 8e's spawn: full qwen3-0.6b on (data 2,
   model 2) from 8e's host draw (its file), 2 train steps at 8 x 1,024
   with ``seq_parallel=True`` (the residual stream and the remat carries
   split along the sequence over "model"; each sublayer all-gathers its
   normed input and reduce-scatters its output): each loss within
   ``PLACED_LOSS_TOL`` of 8e's one process's first two steps, flash 56
   and its backward 28 launches a rank and step at B4 H8 K4 S1,024 (each rank's heads over the
   gathered sequence), each rank's step ms, peak memory and bytes by
   collective kind printed beside 8e's;
8g. the placed steps of the hybrid, ssm and enc-dec families, in one spawn
   of four ranks sharing the card on (data 2, model 2), each arch drawn
   once on the host and read by the ranks from a file
   (``PLACED_FAMILIES``): recurrentgemma-9b at full width cut to one
   (rglru, rglru, local_attn) repetition (the RG-LRU scan on a rank's
   2,048 features; a 2,100-token prompt past its window of 2,048),
   xlstm-125m whole and seamless-m4t-medium at full width cut to 2 + 2
   layers (flash on a rank's 8 heads in its encoder, decoder self and
   cross attention); a train step, a prefill and greedy serve steps,
   each held against one process's run as 8e is (losses, prefill logits
   within ``PLACED_FAMILY_LOGITS_TOL`` with three controls above it: 8e's
   two and one process's prefill with two blocks of one "model"-split
   leaf swapped, ``PLACED_FAULT``; the share of equal greedy tokens),
   launches a rank as ``PLACED_FAMILY_LAUNCHES`` says, the reversed scans
   counted apart;
8f. the dry run (``launch/dryrun.py``) of 8e's, 8h's and 8g's cells,
   traced shape-only on the host as rank 0 of a fake (2, 2) group:
   collective bytes by kind a step, kernel launches and argument bytes
   exactly equal to their rank 0's; 8e's ranks' lowest measured train
   peak over the predicted one (the dry run's peak plus the copy of the
   initial blocks the run keeps) within ``PLACED_PEAK_RATIO`` (8h's and
   8g's peaks are printed beside their dry run's);
9. print a ``{"kernels": [...]}`` line (attention and grouped matmul at
   qwen2-moe's shapes with phase 4b's launches, the scan at recurrentgemma's
   fp32 prefill shape with phase 4c's, flash again at phase 6's
   training shape B8 H16 K8 S1024 with phase 6's launches, and at
   seamless's cross-attention shape with phase 4f's, at qwen3's prefill
   shape with phase 4j's slab launches, the grouped matmul's dx at 6e's
   shape with 6e's launches and the scan's reverse at 6f's with 6f's,
   paged decode at the served qwen3 shape with phase 7's fleet launches,
   the grouped matmul at 8a's E 32 x C 341 with 8a's launches over both
   ranks, ``path: "ep"``, flash at 8b's per-rank B4 S1,024 with 8b's,
   ``path: "dp"``, and at 8e's per-rank B4 H8 K4 S1,024 and S512 with
   8e's train and prefill launches over the four ranks, ``path:
   "tp_train"`` and ``"tp_prefill"``, and at 8h's (the same shape: a
   rank's heads over the gathered sequence) with 8h's train launches over
   the four ranks, ``path: "sp_train"``; the scan and flash at each shape
   8g's ranks launched them at, each with that shape's launches over the
   four ranks (``ops.launch_keys``): the scan forward at B2 D2,048 and S
   1,024 (train) and 2,100 (prefill), reversed at S 1,024, ``path:
   "tp_hybrid"``, ``"tp_hybrid_prefill"``, ``"tp_hybrid_reverse"``, and
   flash at seamless's encoder, decoder self and cross attention of a
   train row and of a prompt, ``path: "tp_encdec_encoder"``,
   ``"tp_encdec_prefill_cross"`` and so on), the ``nvidia-smi`` line, and
   last
   ``{"ok": true, "device": {...}}``.

Phase 3 also holds flash at the training shape (S 1,024) and the flash
backward kernel (no TPU kernel: the JAX package's ``custom_vjp``
recomputes its oracle) at phase 6's, 6e's, 8b's and 8e's training shapes,
bf16 (phase 6's also fp32), and 8g's seamless encoder, decoder self and
cross attention, fed the forward kernel's output and log-sum-exp: each
gradient's max error against the plain backward in fp32, relative to its
largest entry, at most twice SDPA's own bf16 backward error on the same
inputs (fp32: 1e-5), two calls bit-identical, and its device time beside
its plain version's, the plain recompute's it replaced, SDPA's backward
alone and SDPA's forward + backward; the grouped matmul's
gradient at 6e's expert shapes (E64 C341, gate/up and down, bf16: dx
through the kernel, dw one ``torch.bmm``) and the scan's at 6f's (B4
S1,024 D4,096, fp32: one launch of the kernel run backwards in time, also
equal bit for bit to the flipped copies through the forward kernel it
replaced) and at 8g's rank shape (B2 S1,024 D2,048) against autograd of
the plain versions, with the device time of the dx launch, w's transposed
copy, dw and the whole backward (``torch.bmm`` at the dx shape as the
library yardstick), and of the reverse launch and the whole scan
backward; the flash backward's time split by its CUDA kernels (in bf16
the dQ pass, which also forms D, and the dK/dV pass; in fp32 a D
pre-pass before them); and flash at 8g's seamless
rank's encoder (B2 H8 S320 hd64, non-causal), decoder self (S1,280,
causal) and cross attention (Sq1,280 Sk320) shapes.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's clocks: longer than enqueueing a timed run
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 off tensor cores
# (rtol, atol): a kernel passes where |kernel - plain| <= atol + rtol*|plain|.
# Both compute in fp32 from the same inputs and round once to the output
# dtype, so in bf16 they may differ by one output ulp (at most 2^-7 of the
# value) on top of fp32 summation-order noise; 2e-4 is the JAX kernel
# tests' fp32 tolerance.
TOL = {"bfloat16": (2.0 ** -7, 2e-4), "float32": (0.0, 2e-4)}
TOL_TEXT = {"bfloat16": "2e-4 + 2^-7*|plain|", "float32": "2e-4"}
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:151"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:142"),
    # no TPU kernel: JAX's custom_vjp backward recomputes its oracle in XLA
    "flash_attention_backward": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                 "src/repro/kernels/ops.py:42"),
    "grouped_matmul": ("src/repro_torch/csrc/grouped_matmul.cu",
                       "src/repro/kernels/moe_gmm.py:98"),
    "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:72"),
}
# qwen2-moe-a2.7b's expert products: (E, C, d, f, tokens routed) with C the
# capacity of one call's tokens: an 8 x 512-token prefill (341), an 8-slot
# decode step (4), phase 4e's chunk step of 8 rows x 256 tokens (170) and
# one row's 256-token chunk (21)
GMM_SHAPES = {
    "prefill_gate_up": (64, 341, 2048, 1408, 4096),
    "prefill_down": (64, 341, 1408, 2048, 4096),
    "decode": (64, 4, 2048, 1408, 8),
    "decode_down": (64, 4, 1408, 2048, 8),
    "chunk_gate_up": (64, 170, 2048, 1408, 2048),
    "chunk_down": (64, 170, 1408, 2048, 2048),
    "chunk_row": (64, 21, 2048, 1408, 256),
    # phase 8a's expert parallelism: model rank 1's 32 local experts (28
    # live of global experts 32-59, 4 dead) at the one-process capacity
    "ep_gate_up": (32, 341, 2048, 1408, 4096),
    # the paper baseline (``--baseline``: 60 unpadded experts, not sharded)
    # on a 16-way model axis: each rank's 1,408 / 16 = 88 hidden columns
    # of every expert, gate/up and down, at the 8 x 512 prefill's capacity
    "base_gate_up": (60, 341, 2048, 88, 4096),
    "base_down": (60, 341, 88, 2048, 4096),
}
# the first global expert of a GMM_SHAPES case that holds a rank's experts
GMM_EXPERT_BASE = {"ep_gate_up": 32}
# paged decode: (rows, pages per row, row positions, rows whose table is all
# trash, KV heads, query heads, head dim): phase 3's ragged set and the
# served decode (8 requests of 512-token prompts, 32 new tokens: positions
# 512-543) at qwen3's and qwen2-moe's K; phase 4d's decode step (16 rows of
# 1,536-token prompts and 64 new tokens: positions 1536-1599, two rows
# prefilling) at qwen3's; the served decode at seamless's MHA hd 64 and at
# glm4's 32 query heads over 2 KV heads
SERVED_POS = [512 + 31 * b // 7 for b in range(8)]
PAGED_CASES = {
    "ragged": (8, 34, [543, 530, 512, 400, 287, 100, 16, 0], (), (8, 16),
               16, 128),
    "served": (8, 34, SERVED_POS, (), (8, 16), 16, 128),
    "chunked": (16, 100, [1536 + 63 * b // 15 for b in range(16)], (5, 12),
                (8,), 16, 128),
    "seamless": (8, 34, SERVED_POS, (), (16,), 16, 64),
    "glm4": (8, 34, SERVED_POS, (), (2,), 32, 128),
}
# flash forward: (B, H, K, Sq, Sk, hd, causal, dtypes) — qwen3's and
# qwen2-moe's prefill, a 300-token one, phase 6's training shape; then
# seamless's encoder, its cross-attention (512 prompt positions against
# 1,024 frames) and decoder self-attention, and pixtral's 1,024 patches +
# 512 tokens
BOTH = ("bfloat16", "float32")
FLASH_CASES = {
    "qwen3": (8, 16, 8, 512, 512, 128, True, BOTH),
    "s300": (8, 16, 8, 300, 300, 128, True, BOTH),
    "moe": (8, 16, 16, 512, 512, 128, True, BOTH),
    "train": (8, 16, 8, 1024, 1024, 128, True, BOTH),
    "encoder": (8, 16, 16, 1024, 1024, 64, False, ("bfloat16",)),
    "cross": (8, 16, 16, 512, 1024, 64, False, BOTH),
    "dec_self": (8, 16, 16, 512, 512, 64, True, ("bfloat16",)),
    "pixtral": (8, 32, 8, 1536, 1536, 128, True, ("bfloat16",)),
    # phase 8b's data-parallel rank: half of phase 6's batch
    "dp": (4, 16, 8, 1024, 1024, 128, True, ("bfloat16",)),
    # phase 8e's (data 2, model 2) rank: half the batch and half the heads
    # of phase 6's training shape, and of an 8 x 512 prefill
    "tp": (4, 8, 4, 1024, 1024, 128, True, ("bfloat16",)),
    "tp_prefill": (4, 8, 4, 512, 512, 128, True, ("bfloat16",)),
    # phase 8g's seamless rank: half the batch and 8 of 16 heads of a
    # 4 x 1,280-token train batch with 320 frames: encoder, decoder self
    # and cross attention
    "tp_encoder": (2, 8, 8, 320, 320, 64, False, ("bfloat16",)),
    "tp_dec_self": (2, 8, 8, 1280, 1280, 64, True, ("bfloat16",)),
    "tp_cross": (2, 8, 8, 1280, 320, 64, False, ("bfloat16",)),
    # and of its 4 x 1,040-token prompt with 260 frames
    "tp_prefill_encoder": (2, 8, 8, 260, 260, 64, False, ("bfloat16",)),
    "tp_prefill_dec_self": (2, 8, 8, 1040, 1040, 64, True, ("bfloat16",)),
    "tp_prefill_cross": (2, 8, 8, 1040, 260, 64, False, ("bfloat16",)),
}
# the flash backward: (B, H, K, Sq, Sk, hd, causal, dtypes) at every shape
# a training phase launches it at — phase 6's (qwen3-0.6b, 8 x 1,024; also
# fp32), 6e's (qwen2-moe cut, 4 x 1,024, 16 KV heads), 8b's data-parallel
# rank, 8e's and 8h's (data 2, model 2) rank, and 8g's seamless rank:
# encoder, decoder self and cross attention
FLASH_BWD_CASES = {
    "train": (8, 16, 8, 1024, 1024, 128, True, BOTH),
    "moe_train": (4, 16, 16, 1024, 1024, 128, True, ("bfloat16",)),
    "dp": (4, 16, 8, 1024, 1024, 128, True, ("bfloat16",)),
    "tp": (4, 8, 4, 1024, 1024, 128, True, ("bfloat16",)),
    "tp_encoder": (2, 8, 8, 320, 320, 64, False, ("bfloat16",)),
    "tp_dec_self": (2, 8, 8, 1280, 1280, 64, True, ("bfloat16",)),
    "tp_cross": (2, 8, 8, 1280, 320, 64, False, ("bfloat16",)),
}
# the flash backward's tolerance: each gradient's max error against the
# plain backward in fp32 on the same inputs, relative to that gradient's
# largest entry; bf16 at most FLASH_BWD_SDPA_FACTOR times SDPA's own bf16
# backward error against the same reference (P and dS are rounded to bf16
# for their products in both, every gradient once on output), fp32 within
# FLASH_BWD_F32_TOL (sums in another order)
FLASH_BWD_SDPA_FACTOR = 2.0
FLASH_BWD_F32_TOL = 1e-5
# the RG-LRU scan: (B, S, D, decay) — recurrentgemma-9b's 8 x 512-token
# prefill at d 4096, a ragged shape, and a decay of 0.999 over 2048 steps
SCAN_SHAPES = {
    "prefill": (8, 512, 4096, None),
    "ragged": (3, 300, 130, None),
    "long_decay": (1, 2048, 4096, 0.999),
    # phase 8g's (data 2, model 2) rank: half of a 4 x 1,024 batch on half
    # of the 4,096 features (timed, and its reverse), and of its 4 x
    # 2,100-token prompt
    "tp": (2, 1024, 2048, None),
    "tp_prefill": (2, 2100, 2048, None),
}
#: the shapes whose forward scan is timed
SCAN_TIMED = ("prefill", "tp", "tp_prefill")
# the cost model's sweep: bf16 (M, K, N) products from a decode step's few
# rows to a long prefill's, at a small and a large model's widths
SPEC_SHAPES = [(m, k, n) for m in (16, 128, 1024, 8192)
               for k, n in ((1024, 1024), (1024, 4096), (4096, 4096),
                            (8192, 8192))]
SPEC_AGREE = 3.0  # op_time within 3x of each measured time
# the mix-shift trace of tests/test_torch_serving.py with prompts that take
# flash: (rid, prompt length, new tokens, family, step it is submitted at)
MIX_TRACE = [(0, 300, 40, "chat", 0), (1, 300, 40, "chat", 0),
             (2, 300, 40, "chat", 0), (3, 300, 40, "chat", 1),
             (4, 400, 4, "code", 2)]


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[smoke +{time.perf_counter() - T_START:.1f}s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, arg_sets, iters: int = 40, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, cycling through
    ``arg_sets`` (copies whose total exceeds the 50 MB L2, so each launch
    finds its inputs cold, as a layer of the served model does).  A spin
    kernel holds the device while the launches are enqueued, so they run
    back to back and a wrapper's host time (``host_us``) does not show."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_us(torch, fn, args, iters: int = 40) -> float:
    """Mean host time of one call of ``fn`` (checks, descriptors, the
    launch), without waiting for the device."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def _template_args(mangled: str) -> str:
    """The template arguments at the start of ``mangled`` (``I...E``), as
    text: types (``f``, ``13__nv_bfloat16``), integers (``Li4E``) and
    booleans (``Lb1E``)."""
    if not mangled.startswith("I"):
        return ""
    args, i = [], 1
    while i < len(mangled) and mangled[i] != "E":
        m = re.match(r"L([ib])(\d+)E", mangled[i:])
        if m:
            args.append(m.group(2) if m.group(1) == "i" else
                        ("true" if m.group(2) == "1" else "false"))
            i += m.end()
        elif mangled[i] == "f":
            args.append("float")
            i += 1
        elif mangled[i].isdigit():
            n = re.match(r"\d+", mangled[i:]).group(0)
            args.append(mangled[i + len(n):i + len(n) + int(n)])
            i += len(n) + int(n)
        else:
            return ""
    return "<" + ",".join(args) + ">"


def ptxas_lines(log: str):
    """(function, line) for ptxas's register and spill lines; the function
    is the kernel's name and its template arguments, read from the mangled
    name of the entry being compiled."""
    fn, out = "?", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN([^']+)'", line)
        if m:
            mangled, i, names = m.group(1), 0, []
            while i < len(mangled) and mangled[i].isdigit():
                j = i
                while mangled[j].isdigit():
                    j += 1
                names.append(mangled[j:j + int(mangled[i:j])])
                i = j + int(mangled[i:j])
            fn = names[-1] + _template_args(mangled[i:])
        elif "registers" in line or "spill" in line:
            out.append((fn, line.split(":", 1)[-1].strip()))
    return out


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


def check_close(what: str, got, want, dtype_name: str, tol=None) -> float:
    """Max abs error of ``got`` against ``want``; raises past ``tol``
    ((rtol, atol, text); ``TOL`` of the dtype by default)."""
    rtol, atol, text = tol or (*TOL[dtype_name], TOL_TEXT[dtype_name])
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    worst = float((diff - rtol * want.float().abs()).max())
    if not worst <= atol:
        raise AssertionError(f"{what} {dtype_name}: max err {err} exceeds "
                             f"{text} (by {worst - atol})")
    return err


def n_copies(torch, per_copy_bytes: int) -> int:
    return max(2, math.ceil(64e6 / max(per_copy_bytes, 1)) + 1)


def check_paged(torch, ops, ref, paged, dtype_name: str, K: int,
                shape: str) -> dict:
    """Paged decode at the serving paths' shapes: K (8 for qwen3, 16 for
    qwen2-moe and seamless, 2 for glm4), ps=16, and the rows, pages per
    row, positions, all-trash rows, query heads and head dim of
    ``PAGED_CASES[shape]``; non-contiguous pages, all-trash tails."""
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(11)
    B, n_pp, positions, trash_rows, _, H, hd = PAGED_CASES[shape]
    ps = 16
    P = B * n_pp + 1
    lengths = torch.tensor(positions, dtype=torch.int32)
    table = (torch.randperm(B * n_pp, generator=g) + 1).to(torch.int32)
    table = table.reshape(B, n_pp)
    for b in range(B):  # pages past the row's position are unmapped: trash
        table[b, int(lengths[b]) // ps + 1:] = 0
    table[list(trash_rows)] = 0  # prefilling rows: every page the trash page
    table, lengths = table.to(dev), lengths.to(dev)

    def make():
        q = torch.randn(B, H, hd, generator=g).to(dev, dt)
        kp = torch.randn(P, K, ps, hd, generator=g).to(dev, dt)
        vp = torch.randn(P, K, ps, hd, generator=g).to(dev, dt)
        return q, kp, vp, table, lengths

    first = make()
    got = ops.paged_attention(*first)
    want = ref.paged_attention_ref(*first)
    err = check_close("paged_attention", got, want, dtype_name)
    itemsize = first[1].element_size()
    sets = [first] + [make() for _ in range(
        n_copies(torch, 2 * first[1].numel() * itemsize) - 1)]
    ms = time_ms(torch, ops.paged_attention, sets)
    host = host_us(torch, ops.paged_attention, first)
    plain_ms = time_ms(torch, ref.paged_attention_ref, sets, iters=10)
    live = sum(min(int(x) + 1, n_pp * ps) for x in lengths.tolist())
    flops, nbytes = paged.work(B, H, K, hd, itemsize, live, table.numel())
    bms, bby = bound_ms(nbytes, flops, dtype_name)
    splits = paged.num_splits(B, K, n_pp, torch.cuda.get_device_properties(
        0).multi_processor_count, paged.head_groups(H, K))
    return dict(max_abs_err=err, tol=TOL_TEXT[dtype_name], ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=None, host_us=host, splits=splits)


def check_flash(torch, ops, ref, dtype_name: str, case: str) -> dict:
    """Flash forward at ``FLASH_CASES[case]``: (B, H, K, Sq, Sk, hd,
    causal).  The causal cases have Sq == Sk (top-left mask)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_k

    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    B, H, K, Sq, Sk, hd, causal, _ = FLASH_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(12 + Sq + Sk + hd)

    def make():
        q = torch.randn(B, H, Sq, hd, generator=g).to(dev, dt)
        k = torch.randn(B, K, Sk, hd, generator=g).to(dev, dt)
        v = torch.randn(B, K, Sk, hd, generator=g).to(dev, dt)
        return q, k, v

    def flash(q, k, v):
        return ops.flash_attention(q, k, v, causal=causal)

    def plain(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal)

    first = make()
    err = check_close(f"flash_attention {case}", flash(*first), plain(*first),
                      dtype_name)
    itemsize = first[0].element_size()
    per = (first[0].numel() + 2 * first[1].numel()) * itemsize
    sets = [first] + [make() for _ in range(n_copies(torch, per) - 1)]
    ms = time_ms(torch, flash, sets)
    host = host_us(torch, flash, first)
    plain_ms = time_ms(torch, plain, sets, iters=10)
    # the yardstick: one PyTorch call (never used by the port); KV heads
    # repeated outside the timed call
    rsets = [(q, k.repeat_interleave(H // K, 1), v.repeat_interleave(H // K, 1))
             for q, k, v in sets] if K != H else sets
    library_ms = time_ms(
        torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), rsets)
    flops, nbytes = flash_k.work(B, H, K, Sq, Sk, hd, causal, itemsize)
    bms, bby = bound_ms(nbytes, flops, dtype_name)
    return dict(max_abs_err=err, tol=TOL_TEXT[dtype_name], ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=library_ms, host_us=host)


def check_flash_backward(torch, ops, ref, dtype_name: str, case: str) -> dict:
    """The flash backward kernel at ``FLASH_BWD_CASES[case]``, fed the
    forward kernel's output and log-sum-exp: each gradient against the
    plain backward in fp32 on the same inputs within the stated tolerance
    (``FLASH_BWD_SDPA_FACTOR`` x SDPA's error in bf16,
    ``FLASH_BWD_F32_TOL`` in fp32), two calls bit-identical; the device
    time of one call (a layer), of its plain version
    (``ref.flash_attention_backward_ref``), of the plain recompute it
    replaced (autograd of the plain forward), of SDPA's backward alone
    (the library yardstick: the same function, one call) and of SDPA's
    forward + backward, KV heads repeated outside the timed calls."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as flash_k
    from repro_torch.kernels import flash_attention_bwd as bwd_k

    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    B, H, K, Sq, Sk, hd, causal, _ = FLASH_BWD_CASES[case]
    G = H // K
    g = torch.Generator(device="cpu").manual_seed(31 + Sq + Sk + hd)

    def make():
        q = torch.randn(B, H, Sq, hd, generator=g).to(dev, dt)
        k = torch.randn(B, K, Sk, hd, generator=g).to(dev, dt)
        v = torch.randn(B, K, Sk, hd, generator=g).to(dev, dt)
        do = torch.randn(B, H, Sq, hd, generator=g).to(dev, dt)
        o, lse = flash_k.flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
        return q, k, v, o, lse, do

    def kernel(*args):
        return ops.flash_attention_backward(*args, causal=causal)

    def rel(got, want):
        return [float((a.float() - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, want)]

    def sdpa_leaves(q, k, v):
        return [q.detach().requires_grad_()] + [
            t.repeat_interleave(G, 1).detach().requires_grad_()
            for t in (k, v)]

    first = make()
    q, k, v, o, lse, do = first
    got = kernel(*first)
    if not all(torch.equal(a, b) for a, b in zip(got, kernel(*first))):
        raise AssertionError(f"flash backward {case} {dtype_name}: two calls "
                             f"differ")
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    of, lf = ref.flash_attention_ref(qf, kf, vf, causal=causal,
                                     return_lse=True)
    want = ref.flash_attention_backward_ref(qf, kf, vf, of, lf, gf,
                                            causal=causal)
    errs = rel(got, want)
    err = max(float((a.float() - b).abs().max()) for a, b in zip(got, want))
    ins = sdpa_leaves(q, k, v)
    sd = torch.autograd.grad(F.scaled_dot_product_attention(
        *ins, is_causal=causal), ins, do)
    sd = [sd[0]] + [t.float().reshape(B, K, G, Sk, hd).sum(2)
                    for t in sd[1:]]
    sdpa_errs = rel(sd, want)
    del of, lf, want, sd, ins
    if dtype_name == "bfloat16":
        limits = [FLASH_BWD_SDPA_FACTOR * e for e in sdpa_errs]
        tol = f"{FLASH_BWD_SDPA_FACTOR} x SDPA's bf16 error, relative"
    else:
        limits = [FLASH_BWD_F32_TOL] * 3
        tol = f"{FLASH_BWD_F32_TOL} relative"
    if not all(e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError(f"flash backward {case} {dtype_name}: dq, dk, "
                             f"dv relative errors {errs} exceed {limits} "
                             f"(SDPA's {sdpa_errs})")
    itemsize = q.element_size()
    per = (3 * q.numel() + 2 * k.numel()) * itemsize
    sets = [first] + [make() for _ in range(n_copies(torch, per) - 1)]
    ms = time_ms(torch, kernel, sets)
    plain_ms = time_ms(torch, lambda *a: ref.flash_attention_backward_ref(
        *a, causal=causal), sets, iters=5)

    def recompute(q, k, v, o, lse, do):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(
                ref.flash_attention_ref(*ins, causal=causal), ins, do)

    recompute_ms = time_ms(torch, recompute, sets, iters=5)
    graphs = []
    for q, k, v, o, lse, do in sets:
        ins = sdpa_leaves(q, k, v)
        graphs.append((F.scaled_dot_product_attention(*ins, is_causal=causal),
                       ins, do))
    library_ms = time_ms(torch, lambda out, ins, do: torch.autograd.grad(
        out, ins, do, retain_graph=True), graphs)
    del graphs

    def sdpa_fwd_bwd(q, k, v, o, lse, do):
        ins = sdpa_leaves(q, k, v)
        out = F.scaled_dot_product_attention(*ins, is_causal=causal)
        return torch.autograd.grad(out, ins, do)

    fwd_bwd_ms = time_ms(torch, sdpa_fwd_bwd, sets)
    flops, nbytes = bwd_k.work(B, H, K, Sq, Sk, hd, causal, itemsize)
    bms, bby = bound_ms(nbytes, flops, dtype_name)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bby, library_ms=library_ms,
                recompute_ms=recompute_ms, sdpa_fwd_bwd_ms=fwd_bwd_ms,
                rel_errs=errs, sdpa_rel_errs=sdpa_errs,
                split_ms=kernel_split_ms(torch, kernel, sets, "flash_bwd_"))


def kernel_split_ms(torch, fn, arg_sets, prefix: str, iters: int = 10):
    """Device ms per call of each CUDA kernel named ``prefix...`` that
    ``fn`` launches (``torch.profiler``, ``iters`` calls cycling through
    ``arg_sets``), by kernel name without its template arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        at = e.name.find(prefix)
        if e.device_type == torch.autograd.DeviceType.CUDA and at >= 0:
            name = re.split(r"[<(]", e.name[at:])[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / (
                1e3 * iters)
    return out


def routed_sizes(E_live: int, E: int, C: int, tokens: int, top_k: int,
                 seed: int):
    """Group sizes as routing makes them: ``tokens`` rows pick their top-k
    of ``E_live`` experts from skewed random logits, each group capped at
    the capacity ``C``; the padded experts past ``E_live`` stay empty.
    Groups 0-3 are pinned to 0, 1, a partial tile and full capacity."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((tokens, E_live))
              + np.linspace(0.0, 1.0, E_live))
    idx = np.argsort(-logits, axis=1)[:, :top_k]
    sizes = np.zeros(E, np.int64)
    sizes[:E_live] = np.minimum(np.bincount(idx.ravel(), minlength=E_live), C)
    sizes[:4] = [0, 1, min(37, C - 1), C]
    return sizes


def check_gmm(torch, ops, ref, gmm, dtype_name: str, shape: str) -> dict:
    """The grouped matmul at one of qwen2-moe's shapes, with routed group
    sizes (60 live experts, 4 dead); rows past each group must be exactly
    0.  w is drawn as the model draws it, N(0, 1/d_in)."""
    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    E, C, d, f, tokens = GMM_SHAPES[shape]
    base = GMM_EXPERT_BASE.get(shape, 0)
    sizes_np = routed_sizes(60, base + E, C, tokens, 4, seed=13)[base:]
    sizes = torch.as_tensor(sizes_np, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(14 + C + d + base)

    def make():
        x = torch.randn(E, C, d, generator=g, device=dev).to(dt)
        w = (torch.randn(E, d, f, generator=g, device=dev)
             / math.sqrt(d)).to(dt)
        w[max(60 - base, 0):] = 0  # dead experts, as the model pads them
        return x, w, sizes

    first = make()
    got = ops.grouped_matmul(*first)
    want = ref.grouped_matmul_ref(*first)
    err = check_close(f"grouped_matmul {shape}", got, want, dtype_name)
    rows = torch.arange(C, device=dev)[None, :] >= sizes[:, None]
    if bool(got[rows].ne(0).any()):
        raise AssertionError(f"grouped_matmul {shape} {dtype_name}: rows past "
                             f"a group are not exactly 0")
    itemsize = first[0].element_size()
    per = (first[0].numel() + first[1].numel()) * itemsize
    sets = [first] + [make() for _ in range(n_copies(torch, per) - 1)]
    ms = time_ms(torch, ops.grouped_matmul, sets)
    host = host_us(torch, ops.grouped_matmul, first)
    plain_ms = time_ms(torch, ref.grouped_matmul_ref, sets, iters=10)
    library_ms = time_ms(torch, lambda x, w, _: torch.bmm(x, w), sets)
    live_rows = int(sizes_np.sum())
    nonempty = int((sizes_np > 0).sum())
    flops, nbytes = gmm.work(E, C, d, f, itemsize, live_rows=live_rows,
                             nonempty=nonempty)
    bms, bby = bound_ms(nbytes, flops, dtype_name)
    return dict(max_abs_err=err, tol=TOL_TEXT[dtype_name], ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=library_ms, live_rows=live_rows,
                nonempty=nonempty, host_us=host,
                variant=gmm.variant(first[0], first[1]))


def check_scan(torch, ops, ref, dtype_name: str, shape: str) -> dict:
    """The RG-LRU scan at one of ``SCAN_SHAPES``: decay gates sigmoid(N(0,
    1)) and N(0, 1) inputs, or a constant decay with inputs 0.01.  In fp32
    the JAX kernel tests' tolerances (1e-4; 1e-3 for the long decay), in
    bf16 the one-ulp rule; timed at ``SCAN_TIMED``'s shapes."""
    from repro_torch.kernels import rglru_scan as scan_k

    dt = getattr(torch, dtype_name)
    dev = torch.device("cuda")
    B, S, D, decay = SCAN_SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(15 + S)

    def make():
        if decay is not None:
            return (torch.full((B, S, D), decay, device=dev, dtype=dt),
                    torch.full((B, S, D), 0.01, device=dev, dtype=dt))
        a = torch.sigmoid(torch.randn(B, S, D, generator=g, device=dev))
        return a.to(dt), torch.randn(B, S, D, generator=g, device=dev).to(dt)

    first = make()
    got = ops.rglru_scan(*first)
    want = ref.rglru_scan_ref(*first)
    tol = None
    if dtype_name == "float32":
        atol = 1e-3 if decay is not None else 1e-4
        tol = (0.0, atol, f"{atol:g}")
    err = check_close(f"rglru_scan {shape}", got, want, dtype_name, tol)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"rglru_scan {shape} {dtype_name}: not finite")
    r = dict(max_abs_err=err, tol=tol[2] if tol else TOL_TEXT[dtype_name],
             max_abs_out=float(want.float().abs().max()))
    if shape not in SCAN_TIMED:
        return r
    itemsize = first[0].element_size()
    sets = [first] + [make() for _ in range(
        n_copies(torch, 2 * first[0].numel() * itemsize) - 1)]
    ms = time_ms(torch, ops.rglru_scan, sets)
    plain_ms = time_ms(torch, ref.rglru_scan_ref, sets, iters=10)
    flops, nbytes = scan_k.work(B, S, D, itemsize)
    bms, bby = bound_ms(nbytes, flops, dtype_name)
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
             library_ms=None)
    return r


def check_gmm_backward(torch, ops, ref, shape: str) -> dict:
    """The grouped matmul's gradient at one of qwen2-moe's prefill shapes
    (phase 6e's capacity: 4 x 1,024 tokens give C 341), bf16, routed group
    sizes: dx through the kernel and dw one ``torch.bmm``
    (``ops.grouped_matmul_backward``) against autograd of the plain
    version on the card (the bf16 rule), dx exactly 0 past each group.
    Device times: the dx launch (w's transposed copy made outside), that
    copy, dw's ``bmm`` and the whole backward; the plain version and
    ``torch.bmm`` at the dx shape."""
    from repro_torch.kernels import grouped_matmul as gmm_k

    dt = torch.bfloat16
    dev = torch.device("cuda")
    E, C, d, f, tokens = GMM_SHAPES[shape]
    sizes_np = routed_sizes(60, E, C, tokens, 4, seed=13)
    sizes = torch.as_tensor(sizes_np, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(18 + C + d)

    def make():
        x = torch.randn(E, C, d, generator=g, device=dev).to(dt)
        w = (torch.randn(E, d, f, generator=g, device=dev)
             / math.sqrt(d)).to(dt)
        w[60:] = 0
        return x, w, sizes, torch.randn(E, C, f, generator=g,
                                        device=dev).to(dt)

    first = make()
    x, w, _, gy = first
    ins = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    got = torch.autograd.grad(ops.grouped_matmul(*ins, sizes), ins, gy)
    ins = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    want = torch.autograd.grad(ref.grouped_matmul_ref(*ins, sizes), ins, gy)
    err = max(check_close(f"grouped_matmul backward d{n} {shape}", a, b,
                          "bfloat16") for n, a, b in zip("xw", got, want))
    rows = torch.arange(C, device=dev)[None, :] >= sizes[:, None]
    if bool(got[0][rows].ne(0).any()):
        raise AssertionError(f"grouped_matmul backward {shape}: dx rows past "
                             f"a group are not exactly 0")
    per = (x.numel() + w.numel() + gy.numel()) * 2
    sets = [first] + [make() for _ in range(n_copies(torch, per) - 1)]
    # dx alone: the kernel on (E, C, f) @ (E, f, d), w's transposed copy
    # made outside the timed launches
    tsets = [(gy, w.transpose(1, 2).contiguous(), s) for _, w, s, gy in sets]
    ms = time_ms(torch, ops.grouped_matmul, tsets)
    transpose_ms = time_ms(torch, lambda w: w.transpose(1, 2).contiguous(),
                           [(w,) for _, w, _, _ in sets])
    dw_ms = time_ms(torch, lambda x, gy: torch.bmm(x.transpose(1, 2), gy),
                    [(x, gy) for x, _, _, gy in sets])
    backward_ms = time_ms(torch, ops.grouped_matmul_backward, sets)
    plain_ms = time_ms(torch, ref.grouped_matmul_ref, tsets, iters=10)
    library_ms = time_ms(torch, lambda gy, wt, _: torch.bmm(gy, wt), tsets)
    # dx: the grouped product of the (E, C, f) cotangent with w transposed
    live_rows = int(sizes_np.sum())
    flops, nbytes = gmm_k.work(E, C, f, d, 2, live_rows=live_rows,
                               nonempty=int((sizes_np > 0).sum()))
    bms, bby = bound_ms(nbytes, flops, "bfloat16")
    return dict(max_abs_err=err, tol=TOL_TEXT["bfloat16"], ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=library_ms, transpose_ms=transpose_ms,
                dw_ms=dw_ms, backward_ms=backward_ms, live_rows=live_rows)


# the scan's gradient: phase 6f's rglru shape (4 x 1,024 tokens at d 4096)
SCAN_TRAIN = (4, 1024, 4096)


def check_scan_backward(torch, ops, ref, shape=SCAN_TRAIN) -> dict:
    """The RG-LRU scan's gradient at ``shape`` (B, S, D) in fp32 (the
    model's gates are fp32): one launch of the kernel run backwards in time
    (``ops.rglru_scan_backward``, reading a, the cotangent and h in place)
    against autograd of the plain version on the card, within 2e-4, and
    bit for bit against the flipped composition the port ran before it
    (the forward kernel on flipped, shifted copies, then the products).
    Device times: the reverse launch itself, the whole backward (the
    autograd function's), and the plain reverse loop
    (``ref.rglru_scan_backward_ref``)."""
    from repro_torch.kernels import rglru_scan as scan_k

    dev = torch.device("cuda")
    B, S, D = shape
    g = torch.Generator(device=dev).manual_seed(19)

    def make():  # a, h = rglru_scan(a, b), the cotangent; and b
        a = torch.sigmoid(torch.randn(B, S, D, generator=g, device=dev))
        b = torch.randn(B, S, D, generator=g, device=dev)
        gy = torch.randn(B, S, D, generator=g, device=dev)
        return (a, ops.rglru_scan(a, b), gy), b

    first, b = make()
    a, h, gy = first
    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    got = torch.autograd.grad(ops.rglru_scan(*ins), ins, gy)
    ins = [a.clone().requires_grad_(), b.clone().requires_grad_()]
    want = torch.autograd.grad(ref.rglru_scan_ref(*ins), ins, gy)
    tol = (0.0, 2e-4, "2e-4")
    err = max(check_close(f"rglru_scan backward d{n}", x, y, "float32", tol)
              for n, x, y in zip("ab", got, want))
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
    dh = scan_k.rglru_scan(a_next.flip(1).contiguous(),
                           gy.flip(1).contiguous()).flip(1)
    flipped = (dh * torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1), dh)
    if not all(torch.equal(x, y) for x, y in zip(got, flipped)):
        raise AssertionError(f"rglru_scan backward {shape}: the reverse "
                             f"launch differs from the flipped composition")
    del a_next, dh, flipped, ins, want
    sets = [first] + [make()[0] for _ in range(
        n_copies(torch, 3 * a.numel() * 4) - 1)]
    ms = time_ms(torch, scan_k.rglru_scan_backward, sets)
    backward_ms = time_ms(torch, ops.rglru_scan_backward, sets)
    plain_ms = time_ms(torch, ref.rglru_scan_backward_ref, sets, iters=3)
    flops, nbytes = scan_k.work(B, S, D, 4, reverse=True)
    bms, bby = bound_ms(nbytes, flops, "float32")
    return dict(max_abs_err=err, tol="2e-4", ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bby, library_ms=None,
                backward_ms=backward_ms)


def _line(r: dict) -> str:
    lib = ("null" if r["library_ms"] is None
           else f"{r['library_ms']:.5f}")
    return (f"max_err={r['max_abs_err']:.3e} (tol {r['tol']}) "
            f"ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) library_ms={lib}")


def phase_kernels(torch, ops, ref, gmm, paged) -> dict:
    results = {}
    for dtn in ("bfloat16", "float32"):
        for shape, (B, n_pp, _, trash_rows, Ks, H, hd) in PAGED_CASES.items():
            for K in Ks:
                r = check_paged(torch, ops, ref, paged, dtn, K, shape)
                log(f"paged_attention {dtn} {shape} B={B} H={H} K={K} "
                    f"hd={hd} ps=16 n_pp={n_pp} all_trash_rows="
                    f"{list(trash_rows)} splits={r['splits']}: {_line(r)} "
                    f"host_us={r['host_us']:.1f}")
                results[("paged_attention", dtn, shape, K)] = r
        for case, (B, H, K, Sq, Sk, hd, causal, dts) in FLASH_CASES.items():
            if dtn not in dts:
                continue
            r = check_flash(torch, ops, ref, dtn, case)
            log(f"flash_attention {dtn} {case} B={B} H={H} K={K} Sq={Sq} "
                f"Sk={Sk} hd={hd} {'causal' if causal else 'non-causal'}: "
                f"{_line(r)} host_us={r['host_us']:.1f}")
            results[("flash_attention", dtn, case)] = r
        for case, (B, H, K, Sq, Sk, hd, causal, dts) in (
                FLASH_BWD_CASES.items()):
            if dtn not in dts:
                continue
            r = check_flash_backward(torch, ops, ref, dtn, case)
            log(f"flash_attention_backward {dtn} {case} B={B} H={H} K={K} "
                f"Sq={Sq} Sk={Sk} hd={hd} "
                f"{'causal' if causal else 'non-causal'}, per layer: "
                f"{_line(r)} (library: SDPA's backward alone); relative "
                f"errors dq, dk, dv {r['rel_errs']} (SDPA's "
                f"{r['sdpa_rel_errs']}); plain_recompute_ms="
                f"{r['recompute_ms']:.5f} sdpa_fwd_bwd_ms="
                f"{r['sdpa_fwd_bwd_ms']:.5f}; device ms by kernel "
                f"{r['split_ms']}; two calls bit-identical")
            results[("flash_backward", dtn, case)] = r
        for shape, (E, C, d, f, tokens) in GMM_SHAPES.items():
            if dtn == "float32" and shape in GMM_EXPERT_BASE:
                continue  # the EP rank trains in bf16
            r = check_gmm(torch, ops, ref, gmm, dtn, shape)
            log(f"grouped_matmul {dtn} {shape} E={E} C={C} d={d} f={f} "
                f"({tokens} tokens routed: {r['live_rows']} live rows in {r['nonempty']} groups): "
                f"variant={r['variant']} {_line(r)} "
                f"host_us={r['host_us']:.1f}")
            results[("grouped_matmul", dtn, shape)] = r
        if dtn == "bfloat16":  # phase 6e's expert products, backward
            for shape in ("prefill_gate_up", "prefill_down"):
                E, C, d, f, _ = GMM_SHAPES[shape]
                r = check_gmm_backward(torch, ops, ref, shape)
                log(f"grouped_matmul backward {dtn} {shape} E={E} C={C} d={d} "
                    f"f={f} ({r['live_rows']} live rows): dx kernel "
                    f"{_line(r)} (library: bmm at the dx shape); "
                    f"w_transposed_copy_ms={r['transpose_ms']:.5f} "
                    f"dw_bmm_ms={r['dw_ms']:.5f} "
                    f"whole_backward_ms={r['backward_ms']:.5f}")
                results[("grouped_matmul_backward", dtn, shape)] = r
        for shape, (B, S, D, decay) in SCAN_SHAPES.items():
            r = check_scan(torch, ops, ref, dtn, shape)
            what = (f"rglru_scan {dtn} {shape} B={B} S={S} D={D}"
                    + (f" a={decay}" if decay is not None else ""))
            if "ms" in r:
                log(f"{what}: {_line(r)}")
            else:
                log(f"{what}: max_err={r['max_abs_err']:.3e} (tol {r['tol']}) "
                    f"max|h|={r['max_abs_out']:.4g}")
            results[("rglru_scan", dtn, shape)] = r
        if dtn == "float32":  # phase 6f's and 8g's recurrence, backward
            for key, shape in (((), SCAN_TRAIN),
                               (("tp",), SCAN_SHAPES["tp"][:3])):
                r = check_scan_backward(torch, ops, ref, shape)
                log(f"rglru_scan backward {dtn} {' '.join(key)} "
                    f"B={shape[0]} S={shape[1]} D={shape[2]}: the reverse "
                    f"launch {_line(r)} whole_backward_ms="
                    f"{r['backward_ms']:.5f}; equal to the flipped "
                    f"composition bit for bit")
                results[("rglru_scan_backward", dtn) + key] = r
    return results


def launch_probe_s(torch, iters: int = 2000) -> float:
    """Host time of launching one small op (an in-place add on one float),
    without waiting for the device."""
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        x.add_(1)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters


def fit_spec(points, peak_flops: float, hbm_bw: float):
    """(mxu_max_eff, mxu_knee_flops, token_knee) of the cost model's
    roofline that fit ``points`` ((flops, bytes, tokens, device seconds)
    per product) best in the least squares of log time, on a grid."""
    f, b, tok, t = (np.asarray(v, np.float64)[:, None] for v in zip(*points))
    effs = np.linspace(0.30, 1.00, 71)
    knees = np.logspace(6.0, 12.0, 61)
    tknees = np.logspace(0.0, 4.8, 49)
    grid = np.stack(np.meshgrid(effs, knees, tknees, indexing="ij"),
                    -1).reshape(-1, 3).T
    eff = np.maximum(grid[0] * f / (f + grid[1]) * tok / (tok + grid[2]),
                     1e-3)
    model = np.maximum(f / (peak_flops * eff), b / hbm_bw)
    err = ((np.log(model) - np.log(t)) ** 2).sum(0)
    return tuple(float(v) for v in grid[:, int(np.argmin(err))])


def phase_spec(torch, smi: str) -> None:
    """bf16 ``torch.matmul`` device times over ``SPEC_SHAPES`` and the
    launch probe, beside the cost model's ``op_time`` under ``H100``."""
    from repro_torch.core.contraction import MetaOp
    from repro_torch.core.costmodel import H100, op_time
    from repro_torch.core.estimator import ParallelConfig
    from repro_torch.core.graph import OpWorkload

    t_launch = launch_probe_s(torch)
    g = torch.Generator(device="cuda").manual_seed(16)
    points, rows = [], []
    for M, K, N in SPEC_SHAPES:
        def make():
            return (torch.randn(M, K, generator=g, device="cuda").to(
                        torch.bfloat16),
                    torch.randn(K, N, generator=g, device="cuda").to(
                        torch.bfloat16))
        per = 2 * (M * K + K * N)
        sets = [make() for _ in range(n_copies(torch, per))]
        dev_s = time_ms(torch, torch.matmul, sets) * 1e-3
        flops, nbytes = 2.0 * M * K * N, 2.0 * (M * K + K * N + M * N)
        points.append((flops, nbytes, M, dev_s))
        meta = MetaOp(meta_id=0, op_type="matmul", task="spec",
                      component="matmul", op_ids=[0],
                      workload=OpWorkload(flops=flops, bytes_hbm=nbytes,
                                          param_bytes=2.0 * K * N,
                                          act_bytes=2.0 * M * N),
                      batch_size=M, seq_len=1, param_group=None, max_tp=1)
        model_s = op_time(meta, ParallelConfig(1, 1), H100)
        ratio = model_s / (dev_s + t_launch)
        rows.append(((M, K, N), ratio))
        log(f"spec matmul bf16 M={M} K={K} N={N}: measured_ms="
            f"{(dev_s + t_launch) * 1e3:.5f} (device {dev_s * 1e3:.5f} + "
            f"launch) op_time_ms={model_s * 1e3:.5f} ratio={ratio:.3f} "
            f"tflops={flops / dev_s / 1e12:.1f}")
    eff, knee, tknee = fit_spec(points, H100.peak_flops, H100.hbm_bw)
    log(f"spec fit on {smi}: t_launch={t_launch:.3e} mxu_max_eff={eff:.2f} "
        f"mxu_knee_flops={knee:.3e} token_knee={tknee:.1f}; committed: "
        + " ".join(f"{k}={v:g}" for k, v in dataclasses.asdict(H100).items()))
    bad = [(shape, r) for shape, r in rows
           if not 1 / SPEC_AGREE <= r <= SPEC_AGREE]
    if bad:
        raise AssertionError(f"op_time(H100) off by more than {SPEC_AGREE}x "
                             f"at (M, K, N) {bad}")


def phase_planner(torch, ops, smi: str) -> None:
    """Full qwen3-0.6b through the mix-shift trace with ``replan="off"``
    and ``"mix"`` (in that order: the first run carries the model's
    warm-up): equal tokens, the expected replans, phase 4's launch rule in
    each run."""
    from repro_torch.config import default_sharding, get_arch
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingConfig, ServingSession

    arch = get_arch("qwen3-0.6b")
    model = build_model(arch, default_sharding(arch, use_kernels=True),
                        device="cuda").init(0)
    rng = np.random.default_rng(17)
    trace = [(rid, rng.integers(0, arch.vocab, (p,)), g, fam, at)
             for rid, p, g, fam, at in MIX_TRACE]
    _, per = SERVED["qwen3-0.6b"]
    tokens, runs = {}, {}
    for replan in ("off", "mix"):
        sess = ServingSession(ServingConfig(
            arch="qwen3-0.6b", reduced_cfg=False, device="cuda",
            max_slots=8, cache_len=448, page_size=16,
            cache_dtype="bfloat16", replan=replan), model=model)
        ops.reset_launch_counts()
        seen = []
        while sess.steps < 3 or sess.busy:
            for rid, toks, g, fam, at in trace:
                if at == sess.steps:
                    sess.submit(Request(rid=rid, tokens=toks,
                                        max_new_tokens=g, family=fam))
            sess.step()
            seen.append(len(sess.replans))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        m = sess.metrics()
        pf, ds = m["prefill_calls"], m["decode_steps"]
        want = {name: 0 for name in counts}
        want.update({name: n * (a * pf + b * ds)
                     for name, (n, a, b) in per.items()})
        if counts != want:
            raise AssertionError(f"planner phase replan={replan}: launch "
                                 f"counts {counts} != {want}")
        tokens[replan] = {r: res.tokens for r, res in sess.results.items()}
        runs[replan] = sess, m, seen
        log(f"planner qwen3-0.6b full replan={replan}: {m['requests']} "
            f"requests, prefill_calls={pf} decode_steps={ds} "
            f"launches={counts}; replans={m['replans']} "
            f"modes={m['replan_modes']} planning_seconds="
            f"{m['planning_seconds']} throughput_tok_s="
            f"{m['throughput_tok_s']} on {smi}")
    sess, m, seen = runs["mix"]
    for i, r in enumerate(sess.replans):
        log(f"planner replan {i}: mode={r.mode} event={r.event.kind} "
            f"({len(r.events)} events) planning_seconds="
            f"{r.planning_seconds}")
    log(f"planner plan: makespan_ms={m['planned_makespan_ms']} "
        f"steps={len(sess.current_plan.steps)} cache={m['cache']}")
    modes = [r.mode for r in sess.replans]
    if seen[:3] != [1, 1, 2] or modes[:3] != ["full", "full", "hit"] or (
            sess.replans[2].event.kind != "request_completed"):
        raise AssertionError(f"planner phase: replans after the first "
                             f"steps {seen[:3]}, modes {modes} (want 1, 1, "
                             f"2 and full, full, hit)")
    if tokens["mix"] != tokens["off"] or len(tokens["mix"]) != len(trace):
        raise AssertionError("planner phase: replan='mix' tokens differ "
                             "from replan='off'")


# arch: (what the log line calls it, {kernel: (layers that launch it,
# launches per such layer and prefill call, per layer and decode step)});
# every kernel not named must not be launched at all
SERVED = {
    "qwen3-0.6b": ("28L d1024, bf16",
                   {"flash_attention": (28, 1, 0),
                    "paged_attention": (28, 0, 1)}),
    "qwen2-moe-a2.7b": ("24L d2048, 60+4 experts top-4, bf16",
                        {"flash_attention": (24, 1, 0),
                         "paged_attention": (24, 0, 1),
                         "grouped_matmul": (24, 3, 3)}),
    "recurrentgemma-9b": ("38L d4096 (26 rglru + 12 local_attn, window "
                          "2048), MQA hd256, bf16",
                          {"rglru_scan": (26, 1, 0)}),
    # flash in the encoder, decoder self- and cross-attention (12 each)
    "seamless-m4t-medium": ("12+12L d1024 MHA hd64, vocab 256,206, 1,024 "
                            "frames per request, bf16",
                            {"flash_attention": (36, 1, 0),
                             "paged_attention": (12, 0, 1)}),
    "pixtral-12b": ("40L d5120 GQA 32:8 hd128, 1,024 patch embeddings per "
                    "request, bf16",
                    {"flash_attention": (40, 1, 0),
                     "paged_attention": (40, 0, 1)}),
    "glm4-9b": ("40L d4096 GQA 32:2 hd128, bf16",
                {"flash_attention": (40, 1, 0),
                 "paged_attention": (40, 0, 1)}),
    # no attention: no kernel on either layout
    "xlstm-125m": ("12L d768 (9 mlstm + 3 slstm) 4H hd192, vocab 50,304, "
                   "bf16 compute, fp32 states", {}),
}
# on the slab layout, full attention decodes without a kernel
SLAB_SERVED = {"qwen3-0.6b": {"flash_attention": (28, 1, 0)},
               "xlstm-125m": {}}
# what each modal arch's requests carry at full width (phases 4f, 4g)
FRONTEND = {"seamless-m4t-medium": dict(enc_len=1024),
            "pixtral-12b": dict(stub_len=1024)}


def built_model(torch, cfg):
    """The full ``cfg`` as ``launch.serve.serve`` builds it: kernels on,
    on the card, weights drawn from seed 0."""
    from repro_torch.config import default_sharding
    from repro_torch.models import build_model

    return build_model(cfg, default_sharding(cfg, use_kernels=True),
                       device="cuda").init(0)


def phase_serve_full(torch, ops, serve, get_arch, smi: str, arch: str,
                     kv_layout: str = "paged", model=None):
    """Serve the full ``arch`` on ``kv_layout``; every kernel of its path
    must have been launched, exactly layers x (per prefill call, per
    decode step) times, and every other kernel never.  The model (built
    by ``serve`` unless ``model`` gives it) is freed when ``serve``
    returns (the session holds no reference cycle).  Returns (the launch
    counts, the (8, 32) tokens)."""
    what, per = SERVED[arch]
    if kv_layout == "slab":
        per = SLAB_SERVED[arch]
    vocab = get_arch(arch).vocab
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve(arch, reduced_cfg=False, n_requests=8, prompt_len=512,
                gen_len=32, max_slots=8, page_size=16,
                cache_dtype="bfloat16", device="cuda", seed=0, verbose=True,
                kv_layout=kv_layout, model=model, **FRONTEND.get(arch, {}))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = out["tokens"]
    if tuple(toks.shape) != (8, 32):
        raise AssertionError(f"expected (8, 32) tokens, got {tuple(toks.shape)}")
    if not bool(((toks >= 0) & (toks < vocab)).all()):
        raise AssertionError(f"generated token ids out of the {vocab}-token "
                             f"vocabulary")
    pf, ds = out["prefill_calls"], out["decode_steps"]
    want = {name: 0 for name in counts}
    want.update({name: n * (a * pf + b * ds)
                 for name, (n, a, b) in per.items()})
    if counts != want or any(want[name] <= 0 for name in per):
        raise AssertionError(f"{arch} {kv_layout}: launch counts {counts} != "
                             f"{want} (prefill calls {pf}, decode steps "
                             f"{ds})")
    log(f"serve {arch} full ({what}) kv_layout={kv_layout}: "
        f"{out['requests']} requests "
        f"x 512 prompt x 32 new tokens; prefill_calls={pf} decode_steps={ds} "
        f"launches={counts}; init_seconds={out['init_seconds']} "
        f"throughput_tok_s={out['throughput_tok_s']} "
        f"planning_seconds={out['planning_seconds']} "
        f"replans={out['replans']} {out['replan_modes']} "
        f"prefill_seconds={out['prefill_seconds']} "
        f"decode_seconds={out['decode_seconds']} "
        f"peak_mem_bytes={peak} on {smi}")
    return counts, toks


def log_profile(arch: str, prof: dict, smi: str) -> None:
    """One line of ``launch/profile.py``'s ``profile_serve`` result."""
    log(f"profile {arch} (launch/profile.py profile_serve): prefill wall_s="
        f"{prof['prefill_wall_s']} device_s={prof['prefill_device_s']} busy="
        f"{prof['prefill_busy_share']:.4f} events="
        f"{prof['prefill_device_events']} device_us_by_group="
        f"{json.dumps(prof['prefill_device_us_by_group'])}; decode step "
        f"wall_s={prof['decode_step_wall_s']} device_s="
        f"{prof['decode_step_device_s']} idle="
        f"{prof['decode_idle_share']:.4f} events_per_step="
        f"{prof['decode_launches_per_step']} device_us_by_group="
        f"{json.dumps(prof['decode_step_device_us_by_group'])} "
        f"top_kernels_us={json.dumps(prof['decode_step_top_kernels_us'])} "
        f"on {smi}")


def phase_xlstm_serve(torch, ops, serve, get_arch, smi: str) -> None:
    """Phase 4i: full xlstm-125m on the paged and the slab layouts, no
    kernel launched, equal tokens; then one profiled prefill and decode
    steps (paged)."""
    from repro_torch.launch.profile import profile_serve

    _, paged = phase_serve_full(torch, ops, serve, get_arch, smi,
                                "xlstm-125m", "paged")
    _, slab = phase_serve_full(torch, ops, serve, get_arch, smi,
                               "xlstm-125m", "slab")
    if not torch.equal(paged, slab):
        raise AssertionError(f"xlstm-125m: paged and slab tokens differ:\n"
                             f"{paged.tolist()}\n{slab.tolist()}")
    log(f"serve xlstm-125m full: paged tokens == slab tokens "
        f"({paged.numel()} tokens)")
    gc.collect()
    ops.reset_launch_counts()
    prof = profile_serve("xlstm-125m")
    if any(ops.launch_counts().values()) or prof["decode_step_device_s"] <= 0:
        raise AssertionError(f"xlstm-125m profile: launches "
                             f"{ops.launch_counts()}, device time "
                             f"{prof['decode_step_device_s']}")
    log_profile("xlstm-125m", prof, smi)


def phase_slab_qwen3(torch, ops, serve, get_arch, smi: str,
                     paged_tokens) -> dict:
    """Phase 4j: full qwen3-0.6b at phase 4's shape on the slab layout
    (flash 28 x prefill calls, paged decode 0); the share of its greedy
    tokens equal to phase 4's paged run; then the slab decode step under
    ``profile_serve``.  Returns the launch counts."""
    from repro_torch.launch.profile import profile_serve

    counts, toks = phase_serve_full(torch, ops, serve, get_arch, smi,
                                    "qwen3-0.6b", "slab")
    same = float((toks == paged_tokens).float().mean())
    first = [int(row.ne(ref).nonzero()[0]) if bool(row.ne(ref).any())
             else len(row) for row, ref in zip(toks, paged_tokens)]
    log(f"serve qwen3-0.6b full slab vs phase 4's paged run: share of equal "
        f"greedy tokens {same} (first differing position per request "
        f"{first}; slab rounds the attention weights to bf16, the paged "
        f"kernel keeps them fp32)")
    gc.collect()
    prof = profile_serve("qwen3-0.6b", kv_layout="slab")
    log_profile("qwen3-0.6b slab", prof, smi)
    return counts


# phases 5f, 5g: what the reduced modal archs' requests carry (300 frames,
# the reduced 16-position stub), so every attention of the prefill has a
# query length past 256 and takes the fp32 flash kernel
REDUCED_FRONTEND = {"seamless-m4t-medium": dict(enc_len=300),
                    "pixtral-12b": dict(stub_len=16)}


def phase_cpu_parity(torch, serve, arch: str,
                     kv_layout: str = "paged") -> None:
    """Reduced ``arch`` in fp32 from one seed, 4 requests in 4 slots (all
    live at every step), on ``kv_layout``: the kernels on ``cuda`` give
    the plain path's tokens on ``cpu``."""
    front = REDUCED_FRONTEND.get(arch, {})
    kw = dict(reduced_cfg=True, n_requests=4, prompt_len=300, gen_len=16,
              max_slots=4, page_size=16, cache_dtype="float32", replan="off",
              seed=3, verbose=False, kv_layout=kv_layout, **front)
    gpu = serve(arch, device="cuda", **kw)["tokens"]
    cpu = serve(arch, device="cpu", **kw)["tokens"]
    if not torch.equal(gpu.cpu(), cpu.cpu()):
        raise AssertionError(f"reduced {arch} fp32 tokens differ cuda vs cpu:"
                             f"\n{gpu.tolist()}\n{cpu.tolist()}")
    log(f"reduced {arch} fp32 {kv_layout} (4 requests, prompt 300"
        f"{front or ''}, 16 new): cuda tokens == cpu tokens ({cpu.numel()} "
        f"tokens)")


def check_launches(what: str, counts: dict, per: dict, calls: dict) -> None:
    """``counts`` must be ``layers x (a x chunk steps + b x decode steps)``
    for each kernel ``name: (layers, a, b)`` of ``per`` (``calls`` holds the
    run's chunk and decode steps), at least one launch each, and 0 for
    every other kernel."""
    cs, ds = calls["chunk_steps"], calls["decode_steps"]
    want = {name: 0 for name in counts}
    want.update({name: n * (a * cs + b * ds)
                 for name, (n, a, b) in per.items()})
    if counts != want or min(want[name] for name in per) <= 0:
        raise AssertionError(f"{what}: launch counts {counts} != {want} "
                             f"(chunk steps {cs}, decode steps {ds})")


# phase 4d: the shared-prefix trace at full width
SHARED_TRACE = dict(n_requests=16, prompt_len=1536, shared_prefix=1000,
                    gen_len=64, prefill_chunk=256)


def phase_chunked_full(torch, ops, serve, get_arch, smi: str) -> None:
    """Full qwen3-0.6b on :data:`SHARED_TRACE`: (a) prefix sharing with grow
    admission, (b) no sharing, reserve admission.  Every admission is a
    chunk job: no flash launch, paged decode in every decode layer."""
    t = SHARED_TRACE
    vocab = get_arch("qwen3-0.6b").vocab
    configs = (("a", dict(prefix_sharing=True, kv_admission="grow")),
               ("b", dict(prefix_sharing=False, kv_admission="reserve")))
    # a warm-up of each run with 2 new tokens: the chunks' shapes reach the
    # process once before either measured run, so (a) does not carry them
    for _, kw in configs:
        serve("qwen3-0.6b", reduced_cfg=False, max_slots=16, page_size=16,
              prefill_duty=1.0, cache_dtype="bfloat16", device="cuda",
              seed=0, verbose=False, **{**t, "gen_len": 2}, **kw)
    runs = {}
    for name, kw in configs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = serve("qwen3-0.6b", reduced_cfg=False, max_slots=16,
                    page_size=16, prefill_duty=1.0, cache_dtype="bfloat16",
                    device="cuda", seed=0, verbose=True, **t, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_launches(f"4d ({name})", counts,
                       {"paged_attention": (28, 0, 1)}, out)
        toks = out["tokens"]
        if tuple(toks.shape) != (t["n_requests"], t["gen_len"]) or not bool(
                ((toks >= 0) & (toks < vocab)).all()):
            raise AssertionError(f"4d ({name}): tokens of shape "
                                 f"{tuple(toks.shape)} or out of the vocab")
        runs[name] = out
        log(f"chunked qwen3-0.6b full ({name}: {kw}): {out['requests']} "
            f"requests x {t['prompt_len']} prompt ({t['shared_prefix']} "
            f"shared) x {t['gen_len']} new; chunk_steps={out['chunk_steps']} "
            f"interleaved_chunks={out['interleaved_chunks']} prefill_calls="
            f"{out['prefill_calls']} decode_steps={out['decode_steps']} "
            f"launches={counts}; prefill_seconds={out['prefill_seconds']} "
            f"decode_seconds={out['decode_seconds']} planning_seconds="
            f"{out['planning_seconds']} throughput_tok_s="
            f"{out['throughput_tok_s']} kv_page_hw={out['kv_page_hw']} "
            f"kv_page_hw_tokens={out['kv_page_hw_tokens']} "
            f"kv_grow_allocs={out['kv_grow_allocs']} prefix_hit_rate="
            f"{out.get('prefix_hit_rate')} kv_cow_forks="
            f"{out.get('kv_cow_forks')} kv_shared_maps="
            f"{out.get('kv_shared_maps')} peak_mem_bytes={peak} "
            f"replans={out['replans']} {out['replan_modes']} on {smi}")
    a, b = runs["a"], runs["b"]
    n, ps = t["n_requests"], 16
    pages = t["prompt_len"] // ps  # the prompt's full pages
    matched = t["shared_prefix"] // ps  # whole shared pages per sharer
    # the index takes one hold per new node (the donor's prompt pages, then
    # each sharer's pages past the divergence), each a shared map, beside
    # the sharers' read-shared map-ins
    want_maps = (n - 1) * matched + pages + (n - 1) * (pages - matched)
    want_rate = (n - 1) * t["shared_prefix"] / (n * t["prompt_len"])
    if not (a["chunk_steps"] > 0 and a["interleaved_chunks"] > 0
            and a["kv_grow_allocs"] > 0
            and a["prefix_hit_rate"] == want_rate
            and a["kv_cow_forks"] == n - 1
            and a["kv_shared_maps"] == want_maps
            and a["kv_page_hw"] < b["kv_page_hw"]):
        raise AssertionError(
            f"4d: sharing run {a['chunk_steps']} chunk steps, "
            f"{a['interleaved_chunks']} interleaved, {a['kv_grow_allocs']} "
            f"grown, hit rate {a['prefix_hit_rate']} (want {want_rate}), "
            f"{a['kv_cow_forks']} forks (want {n - 1}), "
            f"{a['kv_shared_maps']} shared maps (want {want_maps}), page "
            f"high-water {a['kv_page_hw']} vs {b['kv_page_hw']} unshared")


def phase_moe_chunked(torch, ops, serve, get_arch, smi: str,
                      model=None) -> None:
    """Full qwen2-moe-a2.7b, 8 x 512-token prompts in 256-token chunks, all
    in one job: the grouped matmul at the chunks' capacity (``model``:
    phase 4b's, whose weights the same seed draws)."""
    vocab = get_arch("qwen2-moe-a2.7b").vocab
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    m = serve("qwen2-moe-a2.7b", reduced_cfg=False, n_requests=8,
              prompt_len=512, gen_len=16, prefill_chunk=256, page_size=16,
              cache_dtype="bfloat16", device="cuda", seed=0, verbose=True,
              model=model)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check_launches("4e", counts, {"paged_attention": (24, 0, 1),
                                  "grouped_matmul": (24, 3, 3)}, m)
    toks = m["tokens"]
    if tuple(toks.shape) != (8, 16) or not bool(
            ((toks >= 0) & (toks < vocab)).all()):
        raise AssertionError("4e: expected 8 x 16 tokens in the vocabulary")
    log(f"chunked qwen2-moe-a2.7b full: 8 requests x 512 prompt x 16 new, "
        f"chunk 256; chunk_steps={m['chunk_steps']} decode_steps="
        f"{m['decode_steps']} launches={counts}; init_seconds="
        f"{m['init_seconds']} "
        f"prefill_seconds={m['prefill_seconds']} decode_seconds="
        f"{m['decode_seconds']} planning_seconds={m['planning_seconds']} "
        f"throughput_tok_s={m['throughput_tok_s']} "
        f"peak_mem_bytes={torch.cuda.max_memory_allocated()} "
        f"replans={m['replans']} {m['replan_modes']} on {smi}")


def shared_prefix_trace(seed: int = 17):
    """The bursty shared-prefix trace of ``tests/test_serving.py``: two
    bursts, 10 steps apart, of five chat requests (a 16-token shared
    prefix and a 4-token suffix) and two code requests (a 20-token prefix,
    which ends mid-page, and 4), 10 new tokens each: (rid, tokens, new
    tokens, family, arrival)."""
    rng = np.random.default_rng(seed)
    chat, code = rng.integers(0, 256, (16,)), rng.integers(0, 256, (20,))
    out = []
    for burst in range(2):
        for fam, prefix in (("chat", chat),) * 5 + (("code", code),) * 2:
            out.append((len(out), np.concatenate(
                [prefix, rng.integers(0, 256, (4,))]), 10, fam,
                float(10 * burst)))
    return out


# what must agree between cuda and cpu in phases 5d and 5e
CHUNK_COUNTERS = ("chunk_steps", "interleaved_chunks", "decode_steps",
                  "kv_cow_forks", "kv_shared_maps", "kv_grow_allocs",
                  "kv_grow_defers", "kv_preemptions", "kv_page_hw")


def phase_chunk_parity(torch, arch: str) -> None:
    """Reduced ``arch`` in fp32 from one seed, chunked, on ``cuda`` and on
    ``cpu``: identical tokens and counters.  qwen3: the shared-prefix
    trace with sharing and grow admission in a pool of 12 pages, which
    pauses and preempts; qwen2-moe: four equal prompts in one job, so no
    row decodes while another prefills (MoE rows share expert capacity)."""
    from repro_torch.serving import Request, ServingConfig, ServingSession

    if arch == "qwen3-0.6b":
        trace = shared_prefix_trace()
        cfg = dict(max_slots=6, cache_len=48, page_size=8, prefill_chunk=8,
                   prefix_sharing=True, kv_admission="grow", kv_pages=12)
    else:
        rng = np.random.default_rng(19)
        trace = [(i, rng.integers(0, 256, (40,)), 8, "chat", 0.0)
                 for i in range(4)]
        cfg = dict(max_slots=4, cache_len=48, page_size=8, prefill_chunk=16)
    out = {}
    for dev in ("cuda", "cpu"):
        sess = ServingSession(ServingConfig(
            arch=arch, device=dev, seed=3, cache_dtype="float32",
            replan="off", **cfg))
        m = sess.run([Request(rid=r, tokens=t, max_new_tokens=g, family=f,
                              arrival=a) for r, t, g, f, a in trace],
                     max_steps=1000)
        out[dev] = ({r: res.tokens for r, res in sess.results.items()},
                    {k: m.get(k) for k in CHUNK_COUNTERS})
    if out["cuda"] != out["cpu"] or len(out["cpu"][0]) != len(trace):
        raise AssertionError(f"reduced {arch} chunked fp32 differs cuda vs "
                             f"cpu:\n{out['cuda']}\n{out['cpu']}")
    log(f"reduced {arch} fp32 chunked ({cfg}): cuda tokens == cpu tokens "
        f"({sum(map(len, out['cpu'][0].values()))} tokens), counters "
        f"{out['cpu'][1]}")


# phase 6: full qwen3-0.6b training (batch 8 x 1,024 tokens: S > 256, so
# every layer's attention is the flash kernel, forward and remat recompute)
TRAIN_CELL = dict(arch="qwen3-0.6b", steps=8, batch=8, seq=1024, lr=1e-3,
                  seed=0)
# kernels on and off compute in bf16 with fp32 masters: their per-step
# losses may differ by the compute dtype's relative precision (2^-7)
TRAIN_LOSS_RTOL = 2.0 ** -7
TRAIN_PARITY_TOL = 1e-4  # phase 6b: reduced fp32, cuda vs cpu
MT_TOL = 1e-5  # phase 6c: engine vs reference, cuda vs cpu (fp32)
# phase 6c, cuda vs cpu after the TaskCompleted: the replan restarts Adam's
# moments, and a first Adam step moves every entry by lr·g/(|g| + eps),
# which turns a cross-device gradient difference δ into lr·δ/eps (5e5·δ
# at lr 5e-3, eps 1e-8) where |g| is near eps
MT_RESTART_TOL = 1e-4


def train_param_count(cfg) -> int:
    """Parameters of a dense decoder of ``cfg`` (what training holds
    masters, gradients and two moments of)."""
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    H, K = cfg.n_heads, cfg.n_kv_heads
    layer = d * (H + 2 * K) * hd + H * hd * d + 3 * d * cfg.d_ff + 2 * d
    head = 0 if cfg.tie_embeddings else d * cfg.vocab
    return cfg.vocab * d + L * layer + d + head


def phase_train_full(torch, ops, train, get_arch, smi: str) -> dict:
    """Train full qwen3-0.6b through ``repro_torch.launch.train.train``:
    flash launches must be 2 x 28 per step (each layer's forward and its
    remat recompute), the flash backward's 28, and every other kernel 0;
    every loss finite and the last below the first; then the same steps
    with kernels off (plain attention on the card) give the same per-step
    losses within ``TRAIN_LOSS_RTOL``."""
    cfg = get_arch(TRAIN_CELL["arch"])
    B, S, steps = TRAIN_CELL["batch"], TRAIN_CELL["seq"], TRAIN_CELL["steps"]
    n = train_param_count(cfg)
    log(f"train {cfg.name} full: {n} params; masters + grads + 2 moments "
        f"(fp32) {16 * n} bytes; one ({B} x {min(S, 1024)} x {cfg.vocab}) "
        f"fp32 logits chunk {4 * B * min(S, 1024) * cfg.vocab} bytes")
    runs = {}
    for kernels in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = train(reduced_cfg=False, device="cuda", use_kernels=kernels,
                    verbose=True, log_every=1, **TRAIN_CELL)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        hist, secs = out["history"], out["step_seconds"]
        del out
        per = 2 * cfg.n_layers if kernels else 0
        want = {name: 0 for name in counts}
        want["flash_attention"] = per * steps
        want["flash_attention_backward"] = per // 2 * steps
        if counts != want:
            raise AssertionError(f"train kernels={kernels}: launch counts "
                                 f"{counts} != {want}")
        if not all(math.isfinite(x) for x in hist) or not hist[-1] < hist[0]:
            raise AssertionError(f"train kernels={kernels}: losses {hist} "
                                 f"not finite and decreasing")
        tok_s = [B * S / t for t in secs]
        log(f"train {cfg.name} full (28L d1024, bf16 compute, fp32 masters "
            f"and moments, block remat) kernels={kernels}: batch {B} x seq "
            f"{S}, {steps} steps; losses={hist} step_ms={[t * 1e3 for t in secs]} "
            f"tok_s={tok_s} flash launches {counts['flash_attention']} "
            f"({per} per step), flash backward "
            f"{counts['flash_attention_backward']} ({per // 2} per step) "
            f"peak_mem_bytes={peak} on {smi}")
        runs[kernels] = dict(history=hist, counts=counts, peak=peak,
                             step_s=secs)
    worst = max(abs(a - b) - TRAIN_LOSS_RTOL * abs(b)
                for a, b in zip(runs[True]["history"], runs[False]["history"]))
    if not worst <= 0:
        raise AssertionError(f"train: kernels on/off losses differ beyond "
                             f"2^-7 relative: {runs[True]['history']} vs "
                             f"{runs[False]['history']}")
    log(f"train: kernels on/off per-step losses agree within 2^-7 relative "
        f"(max |diff| {max(abs(a - b) for a, b in zip(runs[True]['history'], runs[False]['history']))})")
    return runs[True]


def phase_train_parity(torch, train) -> None:
    """Reduced qwen3 in fp32, 3 steps at seq 320 (the fp32 flash kernel)
    on cuda against the plain path on cpu: losses and final params within
    ``TRAIN_PARITY_TOL``.  Adam moves an entry whose gradient is near zero
    by up to lr whatever its size, so the lr (1e-3) keeps that spread
    (0.03·lr between the port and JAX on the CPU) under the tolerance."""
    kw = dict(reduced_cfg=True, steps=3, batch=2, seq=320, lr=1e-3, seed=5,
              verbose=False)
    gpu = train("qwen3-0.6b", device="cuda", **kw)
    cpu = train("qwen3-0.6b", device="cpu", **kw)
    dl = max(abs(a - b) for a, b in zip(gpu["history"], cpu["history"]))
    dp = max(float((gpu["params"][k].detach().cpu() - v.detach()).abs().max())
             for k, v in cpu["params"].items())
    if not (dl <= TRAIN_PARITY_TOL and dp <= TRAIN_PARITY_TOL):
        raise AssertionError(f"reduced train cuda vs cpu: loss diff {dl}, "
                             f"param diff {dp} > {TRAIN_PARITY_TOL}")
    log(f"reduced qwen3 fp32 train (3 steps, batch 2 x seq 320): cuda "
        f"losses {gpu['history']} == cpu {cpu['history']} (max diff {dl}); "
        f"final params max diff {dp} (tol {TRAIN_PARITY_TOL})")


def phase_modal_train_parity(torch, ops) -> None:
    """Reduced seamless and pixtral in fp32, one loss and every gradient at
    S 300 (300 frames; a 16-position stub) on ``cuda`` — the flash kernel
    forward in every attention and the flash backward kernel — against
    the plain path on ``cpu``, within ``TRAIN_PARITY_TOL``; the flash
    launches are the layers' attentions (enc-dec: encoder, self and cross,
    no remat; pixtral: forward and remat recompute), the backward's one
    for each attention (enc-dec: 3 a layer; pixtral: 1)."""
    from repro_torch.config import ShardingConfig, get_arch, reduced
    from repro_torch.models import build_model

    for arch, per_layer in (("seamless-m4t-medium", 3), ("pixtral-12b", 2)):
        cfg = reduced(get_arch(arch))
        rng = np.random.default_rng(23)
        toks = rng.integers(0, cfg.vocab, (2, 301))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_encdec:
            batch["frames"] = rng.standard_normal((2, 300, cfg.d_model),
                                                  dtype=np.float32)
        else:
            batch["embeds"] = rng.standard_normal(
                (2, cfg.frontend_stub_len, cfg.d_model), dtype=np.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            m = build_model(cfg, ShardingConfig(use_kernels=True), device=dev,
                            train=True).init(5)
            ops.reset_launch_counts()
            loss, _ = m.loss({k: torch.as_tensor(v, device=dev)
                              for k, v in batch.items()})
            named = list(m.impl.named_parameters())
            grads = torch.autograd.grad(loss, [p for _, p in named])
            counts = ops.launch_counts()
            out[dev] = (float(loss.detach()), {n: g.cpu() for (n, _), g in
                                      zip(named, grads)},
                        (counts["flash_attention"],
                         counts["flash_attention_backward"]))
        dl = abs(out["cuda"][0] - out["cpu"][0])
        dg = max(float((g - out["cpu"][1][n]).abs().max())
                 for n, g in out["cuda"][1].items())
        want = (per_layer * cfg.n_layers,
                (3 if cfg.is_encdec else 1) * cfg.n_layers)
        if not (dl <= TRAIN_PARITY_TOL and dg <= TRAIN_PARITY_TOL
                and out["cuda"][2] == want and out["cpu"][2] == (0, 0)):
            raise AssertionError(f"reduced {arch} train cuda vs cpu: loss "
                                 f"diff {dl}, grad diff {dg}, flash and "
                                 f"backward launches {out['cuda'][2]} (want "
                                 f"{want})")
        log(f"reduced {arch} fp32 loss + grads at S 300 (flash {want[0]} "
            f"and flash backward {want[1]} launches on cuda): loss cuda "
            f"{out['cuda'][0]} == cpu "
            f"{out['cpu'][0]} (diff {dl}); {len(out['cpu'][1])} gradient "
            f"leaves, max diff {dg} (tol {TRAIN_PARITY_TOL})")


# phases 6e, 6f: MoE and hybrid training at full width, depth cut so that
# params, gradients and two fp32 moments fit one card (the full models'
# 15.1 B and 10.45 B params would not): qwen2-moe at 4 layers, and
# recurrentgemma at 5 — its full order, two remainder rglru layers and one
# (rglru, rglru, local_attn) group
TRAIN_CUT = {"qwen2-moe-a2.7b": 4, "recurrentgemma-9b": 5}
TRAIN_CUT_RUN = dict(steps=4, batch=4, seq=1024, lr=1e-3, seed=0)
PEAK_LIMIT = 76e9  # bytes: the card's 80 GB less headroom


def train_launches_per_step(cfg) -> dict:
    """Kernel launches of one train step with kernels on, block remat and
    S > 256, derived from the layer kinds: a layer in a checkpointed group
    runs its forward twice (forward and recompute), a remainder layer
    once; each forward of an ``attn`` layer launches flash, of an MoE FFN
    three grouped matmuls, of an ``rglru`` layer one scan; backward adds
    one flash backward per ``attn`` layer, three grouped-matmul dx
    launches per MoE layer and one reverse scan per rglru layer (the
    windowed layers launch nothing)."""
    from repro_torch.models.transformer import layer_kinds, resolve_pattern

    n_rem = cfg.n_layers % len(resolve_pattern(cfg))
    out = {"flash_attention": 0, "flash_attention_backward": 0,
           "grouped_matmul": 0, "rglru_scan": 0, "paged_attention": 0}
    for i, kind in enumerate(layer_kinds(cfg)):
        runs = 1 if i < n_rem else 2
        if kind == "attn":
            out["flash_attention"] += runs
            out["flash_attention_backward"] += 1
        if kind == "rglru":
            out["rglru_scan"] += runs + 1
        if cfg.is_moe:
            out["grouped_matmul"] += 3 * runs + 3
    return out


def phase_train_cut(torch, ops, smi: str, arch: str) -> dict:
    """Train ``arch`` at full width and :data:`TRAIN_CUT` depth through
    ``make_train_state`` and ``train_step`` (what ``train`` calls): bf16
    compute, the arch's param dtype, fp32 moments, block remat,
    :data:`TRAIN_CUT_RUN`, kernels on and then off, the last step on the
    first step's batch.  Kernels on: the launches must equal
    :func:`train_launches_per_step` x steps; then one more step under
    ``launch/profile.py``'s :func:`profile_train_step`.  Each run: losses
    finite, the last (the first batch again) below the first, peak memory
    below :data:`PEAK_LIMIT`; kernels on/off per-step losses within
    ``TRAIN_LOSS_RTOL``.  Each model is freed before the next loads."""
    from functools import partial

    from repro_torch.config import default_sharding, get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.profile import profile_train_step
    from repro_torch.launch.train import make_train_state, train_step
    from repro_torch.models import build_model
    from repro_torch.models.layers import dtype_of
    from repro_torch.optim import AdamW, warmup_cosine

    r = TRAIN_CUT_RUN
    B, S, steps = r["batch"], r["seq"], r["steps"]
    cfg = dataclasses.replace(get_arch(arch), n_layers=TRAIN_CUT[arch])
    per_step = train_launches_per_step(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B, seed=r["seed"]))
    # the last step replays the first batch, so that "the last loss below
    # the first" compares one batch before and after the updates (from
    # batch to batch the loss moves by more than a few steps' progress)
    batches = [{k: v.to("cuda") for k, v in data.batch(i).items()}
               for i in list(range(steps - 1)) + [0, steps - 1]]
    log(f"train {arch} cut to {cfg.n_layers} layers (full width), batch {B} "
        f"x seq {S}, {steps} steps: predicted launches per step {per_step}; "
        f"one ({B} x {S} x {cfg.vocab}) fp32 logits chunk "
        f"{4 * B * S * cfg.vocab} bytes")
    runs = {}
    for kernels in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, default_sharding(cfg, use_kernels=kernels),
                            device="cuda", train=True)
        opt = AdamW(lr=partial(warmup_cosine, peak_lr=r["lr"],
                               warmup_steps=1, total_steps=steps),
                    moment_dtype=dtype_of(cfg.opt_dtype))
        params, state = make_train_state(model, opt, r["seed"])
        n = sum(p.numel() for p in params.values())
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        hist, secs = [], []
        for step in range(steps):
            t0 = time.perf_counter()
            state, loss = train_step(model, opt, params, state, batches[step])
            hist.append(float(loss))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        want = {name: per_step[name] * steps if kernels else 0
                for name in counts}
        if counts != want:
            raise AssertionError(f"train {arch} kernels={kernels}: launch "
                                 f"counts {counts} != {want}")
        prof = None
        if kernels:
            prof = profile_train_step(model, opt, params, state,
                                      batches[steps])
            if prof["launches"] != per_step or prof["step_device_s"] <= 0:
                raise AssertionError(f"train {arch} profiled step: launches "
                                     f"{prof['launches']} != {per_step}")
        peak = torch.cuda.max_memory_allocated()
        del model, opt, params, state
        if not all(math.isfinite(x) for x in hist) or not hist[-1] < hist[0]:
            raise AssertionError(f"train {arch} kernels={kernels}: losses "
                                 f"{hist} not finite and decreasing")
        if not peak < PEAK_LIMIT:
            raise AssertionError(f"train {arch} kernels={kernels}: peak "
                                 f"{peak} bytes >= {PEAK_LIMIT}")
        log(f"train {arch} cut to {cfg.n_layers} layers ({n} params, "
            f"{cfg.param_dtype} params, bf16 compute, fp32 moments, block "
            f"remat) kernels={kernels}: batch {B} x seq {S}, {steps} steps; "
            f"losses={hist} step_ms={[t * 1e3 for t in secs]} "
            f"tok_s={[B * S / t for t in secs]} launches={counts} "
            f"peak_mem_bytes={peak} on {smi}")
        if prof is not None:
            log(f"train {arch} profiled step (launch/profile.py "
                f"profile_train_step): wall_s={prof['step_wall_s']} "
                f"device_s={prof['step_device_s']} idle="
                f"{prof['step_idle_share']:.3f} events="
                f"{prof['step_device_events']} device_us_by_group="
                f"{json.dumps(prof['step_device_us_by_group'])} top_kernels_us="
                f"{json.dumps(prof['step_top_kernels_us'])} on {smi}")
        runs[kernels] = dict(history=hist, counts=counts, peak=peak,
                             step_s=secs, profile=prof, per_step=per_step)
    on, off = runs[True]["history"], runs[False]["history"]
    worst = max(abs(a - b) - TRAIN_LOSS_RTOL * abs(b) for a, b in zip(on, off))
    if not worst <= 0:
        raise AssertionError(f"train {arch}: kernels on/off losses differ "
                             f"beyond 2^-7 relative: {on} vs {off}")
    log(f"train {arch}: kernels on/off per-step losses agree within 2^-7 "
        f"relative (max |diff| {max(abs(a - b) for a, b in zip(on, off))})")
    return runs[True]


# phase 6g: Adam moves an entry whose gradient is near zero by up to lr
# whatever its size, so a sign that differs between devices at fp32 noise
# puts that entry up to 2·lr apart per step; at lr 1e-5 three steps stay
# inside TRAIN_PARITY_TOL whatever the signs
MOE_HYBRID_PARITY_LR = 1e-5


def phase_moe_hybrid_train_parity(torch, ops, train) -> None:
    """Reduced qwen2-moe and recurrentgemma in fp32 on ``cuda`` (kernels on)
    against the plain path on ``cpu``: one loss and every gradient at S
    320 (flash, the grouped matmul and its dx, the scan and its reverse),
    with the launches :func:`train_launches_per_step` predicts, then three
    ``train`` steps: losses, gradients and final params within
    ``TRAIN_PARITY_TOL``."""
    from repro_torch.config import ShardingConfig, get_arch, reduced
    from repro_torch.models import build_model

    for arch in ("qwen2-moe-a2.7b", "recurrentgemma-9b"):
        cfg = reduced(get_arch(arch))
        toks = np.random.default_rng(29).integers(0, cfg.vocab, (2, 321))
        out = {}
        for dev in ("cuda", "cpu"):
            m = build_model(cfg, ShardingConfig(use_kernels=True), device=dev,
                            train=True).init(5)
            ops.reset_launch_counts()
            loss, parts = m.loss({
                "tokens": torch.as_tensor(toks[:, :-1], device=dev),
                "labels": torch.as_tensor(toks[:, 1:], device=dev)})
            named = list(m.impl.named_parameters())
            grads = torch.autograd.grad(loss, [p for _, p in named])
            out[dev] = (float(loss.detach()), float(parts["aux"].detach()),
                        {n: g.cpu() for (n, _), g in zip(named, grads)},
                        ops.launch_counts())
        want = train_launches_per_step(cfg)
        dl = abs(out["cuda"][0] - out["cpu"][0])
        da = abs(out["cuda"][1] - out["cpu"][1])
        dg = max(float((g - out["cpu"][2][n]).abs().max())
                 for n, g in out["cuda"][2].items())
        if not (dl <= TRAIN_PARITY_TOL and da <= TRAIN_PARITY_TOL
                and dg <= TRAIN_PARITY_TOL and out["cuda"][3] == want
                and not any(out["cpu"][3].values())):
            raise AssertionError(f"reduced {arch} train cuda vs cpu: loss "
                                 f"diff {dl}, aux diff {da}, grad diff {dg}, "
                                 f"launches {out['cuda'][3]} (want {want})")
        kw = dict(reduced_cfg=True, steps=3, batch=2, seq=320,
                  lr=MOE_HYBRID_PARITY_LR, seed=5, verbose=False)
        gpu = train(arch, device="cuda", **kw)
        cpu = train(arch, device="cpu", **kw)
        sl = max(abs(a - b) for a, b in zip(gpu["history"], cpu["history"]))
        sp = max(float((gpu["params"][k].detach().cpu() - v.detach())
                       .abs().max()) for k, v in cpu["params"].items())
        if not (sl <= TRAIN_PARITY_TOL and sp <= TRAIN_PARITY_TOL):
            raise AssertionError(f"reduced {arch} train steps cuda vs cpu: "
                                 f"loss diff {sl}, param diff {sp}")
        log(f"reduced {arch} fp32 loss + grads at S 320 (launches on cuda "
            f"{out['cuda'][3]}): loss diff {dl}, aux diff {da} (aux "
            f"{out['cpu'][1]}), {len(out['cpu'][2])} gradient leaves max diff "
            f"{dg}; 3 train steps at lr {MOE_HYBRID_PARITY_LR}: cuda losses "
            f"{gpu['history']} vs cpu {cpu['history']} (max diff {sl}), "
            f"final params max diff {sp} (tol {TRAIN_PARITY_TOL})")


# phase 6h: the tied embedding's gradient of the reduced xlstm is
# ill-conditioned (the mLSTM normaliser max(|l|, e^-m) divides by a signed
# sum): on the CPU a 1e-7 relative change of the params moves it by 4.9e-4
# (largest entry 1.5), so each leaf is held within TRAIN_PARITY_TOL plus
# XLSTM_GRAD_RTOL of its largest entry
XLSTM_GRAD_RTOL = 1e-3
# 3 full xlstm-125m steps at seq 256: the sLSTM is a host loop over the
# tokens (a step at seq 1,024 took 8-14 s)
XLSTM_TRAIN = dict(steps=3, batch=4, seq=256, lr=1e-3, seed=0)


def phase_xlstm_train(torch, ops, train, smi: str) -> None:
    """Phase 6h: reduced xlstm in fp32, one loss and every gradient at S
    320 and three ``train`` steps at lr 1e-5 on ``cuda`` against ``cpu``;
    then full xlstm-125m for :data:`XLSTM_TRAIN` steps, the last on the
    first step's batch (its loss below the first), no kernel launched."""
    from functools import partial

    from repro_torch.config import ShardingConfig, default_sharding, \
        get_arch, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import make_train_state, train_step
    from repro_torch.models import build_model
    from repro_torch.models.layers import dtype_of
    from repro_torch.optim import AdamW, warmup_cosine

    arch = "xlstm-125m"
    cfg = reduced(get_arch(arch))
    toks = np.random.default_rng(29).integers(0, cfg.vocab, (2, 321))
    out = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, ShardingConfig(use_kernels=True), device=dev,
                        train=True).init(5)
        ops.reset_launch_counts()
        loss, _ = m.loss({"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                          "labels": torch.as_tensor(toks[:, 1:], device=dev)})
        named = list(m.impl.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
        out[dev] = (float(loss.detach()),
                    {n: g.cpu() for (n, _), g in zip(named, grads)},
                    ops.launch_counts())
    dl = abs(out["cuda"][0] - out["cpu"][0])
    excess = {n: float((g - out["cpu"][1][n]).abs().max())
              - XLSTM_GRAD_RTOL * float(out["cpu"][1][n].abs().max())
              for n, g in out["cuda"][1].items()}
    dg = max(float((g - out["cpu"][1][n]).abs().max())
             for n, g in out["cuda"][1].items())
    if not (dl <= TRAIN_PARITY_TOL and max(excess.values()) <= TRAIN_PARITY_TOL
            and not any(out["cuda"][2].values())):
        raise AssertionError(f"reduced {arch} train cuda vs cpu: loss diff "
                             f"{dl}, grad excess {max(excess.values())}, "
                             f"launches {out['cuda'][2]}")
    kw = dict(reduced_cfg=True, steps=3, batch=2, seq=320,
              lr=MOE_HYBRID_PARITY_LR, seed=5, verbose=False)
    gpu = train(arch, device="cuda", **kw)
    cpu = train(arch, device="cpu", **kw)
    sl = max(abs(a - b) for a, b in zip(gpu["history"], cpu["history"]))
    sp = max(float((gpu["params"][k].detach().cpu() - v.detach()).abs().max())
             for k, v in cpu["params"].items())
    if not (sl <= TRAIN_PARITY_TOL and sp <= TRAIN_PARITY_TOL):
        raise AssertionError(f"reduced {arch} train steps cuda vs cpu: loss "
                             f"diff {sl}, param diff {sp}")
    log(f"reduced {arch} fp32 loss + grads at S 320 (no kernel launched): "
        f"loss diff {dl}, {len(excess)} gradient leaves max diff {dg} (tol "
        f"{TRAIN_PARITY_TOL} + {XLSTM_GRAD_RTOL} x the leaf's largest "
        f"entry); 3 train steps at lr {MOE_HYBRID_PARITY_LR}: cuda losses "
        f"{gpu['history']} vs cpu {cpu['history']} (max diff {sl}), final "
        f"params max diff {sp} (tol {TRAIN_PARITY_TOL})")

    r = XLSTM_TRAIN
    B, S, steps = r["batch"], r["seq"], r["steps"]
    cfg = get_arch(arch)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                  seed=r["seed"]))
    batches = [{k: v.to("cuda") for k, v in data.batch(i).items()}
               for i in list(range(steps - 1)) + [0]]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, default_sharding(cfg, use_kernels=True),
                        device="cuda", train=True)
    # no warm-up step at lr 0: both steps before the replay update
    opt = AdamW(lr=partial(warmup_cosine, peak_lr=r["lr"], warmup_steps=0,
                           total_steps=steps),
                moment_dtype=dtype_of(cfg.opt_dtype))
    params, state = make_train_state(model, opt, r["seed"])
    n = sum(p.numel() for p in params.values())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    hist, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, loss = train_step(model, opt, params, state, b)
        hist.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del model, opt, params, state
    if any(counts.values()) or not all(math.isfinite(x) for x in hist) \
            or not hist[-1] < hist[0]:
        raise AssertionError(f"train {arch} full: losses {hist} not finite "
                             f"and falling, or launches {counts}")
    log(f"train {arch} full ({n} params, 12L d768, bf16 compute, fp32 "
        f"masters and moments, block remat): batch {B} x seq {S}, {steps} "
        f"steps (the last on the first batch); losses={hist} "
        f"step_ms={[t * 1e3 for t in secs]} "
        f"tok_s={[B * S / t for t in secs]} launches={counts} "
        f"peak_mem_bytes={peak} on {smi}")


# phase 6i: checkpoint and resume of full xlstm-125m through ``train``; one
# 6-step schedule run (a) through, (b) with saves every 3 steps and stopped
# after step 3, (c) resumed from step 3.  Batch 4 x 128: a checkpoint's size
# does not depend on seq, and the sLSTM's host loop runs over every token
CKPT_RUN = dict(steps=6, batch=4, seq=128, lr=1e-3, seed=0)
CKPT_EVERY, CKPT_STOP = 3, 4
RESUME_RTOL = 1e-5  # tests/test_train_serve_drivers.py:30


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _interrupt_and_resume(train, arch: str, **kw) -> tuple:
    """Runs (a), (b) and (c) of one schedule; (b) and (c) share a fresh
    ``tempfile.mkdtemp()`` directory, deleted at the end.  Returns the three
    results, the steps on disk after (b) and after (c), and the bytes of
    (b)'s last step."""
    import shutil
    import tempfile

    from repro_torch.ckpt import all_steps

    full = train(arch, **kw)
    ck = tempfile.mkdtemp(prefix="ckpt_")
    try:
        cut = train(arch, ckpt_dir=ck, ckpt_every=CKPT_EVERY,
                    stop_at_step=CKPT_STOP, **kw)
        after_cut = all_steps(ck)
        step_bytes = _dir_bytes(Path(ck) / f"step_{after_cut[-1]:09d}")
        resumed = train(arch, ckpt_dir=ck, ckpt_every=CKPT_EVERY,
                        **{**kw, "verbose": True})
        after_resume = all_steps(ck)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    want_cut = list(range(0, CKPT_STOP, CKPT_EVERY))
    last = kw["steps"] - 1
    if not (after_cut == want_cut and len(cut["history"]) == CKPT_STOP
            and resumed["resumed_from"] == want_cut[-1]
            and len(resumed["history"]) == kw["steps"] - CKPT_STOP
            and after_resume[-1] == last):
        raise AssertionError(f"{arch} interrupt/resume: steps on disk "
                             f"{after_cut} then {after_resume}, resumed "
                             f"from {resumed['resumed_from']}")
    return full, cut, resumed, after_cut, after_resume, step_bytes


def _resume_diffs(torch, full, resumed) -> tuple:
    """(max |loss diff| over the resumed steps, the worst excess over
    ``RESUME_RTOL`` relative, max |param diff|, losses bitwise, params
    bitwise)."""
    tail = full["history"][CKPT_STOP:]
    dl = max(abs(a - b) for a, b in zip(resumed["history"], tail))
    excess = max(abs(a - b) - RESUME_RTOL * abs(b)
                 for a, b in zip(resumed["history"], tail))
    dp = max(float((resumed["params"][k].detach() - v.detach()).abs().max())
             for k, v in full["params"].items())
    same_p = all(torch.equal(resumed["params"][k], v)
                 for k, v in full["params"].items())
    return dl, excess, dp, resumed["history"] == tail, same_p


def phase_ckpt_resume(torch, ops, train, smi: str) -> dict:
    """Phase 6i: full xlstm-125m interrupted and resumed through ``train``
    equals the uninterrupted run (losses within ``RESUME_RTOL`` relative),
    no kernel launched; the bytes of one step on disk and the seconds of a
    save and a restore.  Then an ``AsyncCheckpointManager`` snapshot of a
    live full xlstm state on the card, followed at once by an in-place
    train step, must restore bit for bit to the pre-step state.  Then
    reduced qwen2-moe in fp32 (the grouped matmul forward, recompute and
    dx) interrupted and resumed within ``TRAIN_PARITY_TOL``, with the
    launches :func:`train_launches_per_step` predicts."""
    import shutil
    import tempfile
    from functools import partial

    from repro_torch.ckpt import AsyncCheckpointManager
    from repro_torch.config import default_sharding, get_arch, reduced
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import make_train_state, train_step
    from repro_torch.models import build_model
    from repro_torch.models.layers import dtype_of
    from repro_torch.optim import AdamW, warmup_cosine

    arch = "xlstm-125m"
    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(reduced_cfg=False, device="cuda", verbose=False, **CKPT_RUN)
    ops.reset_launch_counts()
    full, cut, resumed, on_disk, after, step_bytes = _interrupt_and_resume(
        train, arch, **kw)
    counts = ops.launch_counts()
    dl, excess, dp, same_l, same_p = _resume_diffs(torch, full, resumed)
    n = sum(p.numel() for p in full["params"].values())
    if any(counts.values()) or not excess <= 0:
        raise AssertionError(f"{arch} resume: losses {resumed['history']} vs "
                             f"{full['history'][CKPT_STOP:]} (max diff {dl}, "
                             f"rel tol {RESUME_RTOL}), launches {counts}")
    log(f"ckpt {arch} full ({n} params, fp32 masters and moments, bf16 "
        f"compute), batch {CKPT_RUN['batch']} x seq {CKPT_RUN['seq']}, "
        f"{CKPT_RUN['steps']} steps: (b) saved steps {on_disk} and stopped, "
        f"(c) resumed from step {resumed['resumed_from']} and saved through "
        f"{after}; resumed losses {resumed['history']} vs uninterrupted "
        f"{full['history'][CKPT_STOP:]}: max loss diff {dl} (rel tol "
        f"{RESUME_RTOL}), losses bitwise equal {same_l}; final params max "
        f"diff {dp}, bitwise equal {same_p}; one step on disk "
        f"{step_bytes} bytes; save_s {cut['ckpt_save_seconds']} + "
        f"{resumed['ckpt_save_seconds']} (the last off the cadence), "
        f"restore_s {resumed['ckpt_restore_seconds']} (read + copy into the "
        f"live params and moments), host clock; launches {counts} on {smi}")
    out = dict(step_bytes=step_bytes,
               save_s=cut["ckpt_save_seconds"] + resumed["ckpt_save_seconds"],
               restore_s=resumed["ckpt_restore_seconds"], loss_diff=dl,
               param_diff=dp)
    del full, cut, resumed

    # the async snapshot on the step turn against an in-place step
    cfg = get_arch(arch)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=CKPT_RUN["seq"],
                                  global_batch=CKPT_RUN["batch"], seed=0))
    batches = [{k: v.to("cuda") for k, v in data.batch(i).items()}
               for i in range(2)]
    model = build_model(cfg, default_sharding(cfg, use_kernels=True),
                        device="cuda", train=True)
    opt = AdamW(lr=partial(warmup_cosine, peak_lr=1e-3, warmup_steps=0,
                           total_steps=2),
                moment_dtype=dtype_of(cfg.opt_dtype))
    params, state = make_train_state(model, opt, 0)
    state, _ = train_step(model, opt, params, state, batches[0])
    torch.cuda.synchronize()
    before = {"params": {k: v.detach().cpu().clone()
                         for k, v in params.items()},
              "mu": {k: v.cpu().clone() for k, v in state.mu.items()},
              "nu": {k: v.cpu().clone() for k, v in state.nu.items()}}
    d = tempfile.mkdtemp(prefix="async_")
    try:
        mgr = AsyncCheckpointManager(d, every=1)
        t0 = time.perf_counter()
        mgr.save(1, {"params": params, "opt": state})
        turn_s = time.perf_counter() - t0
        state, _ = train_step(model, opt, params, state, batches[1])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0 - turn_s
        restored, manifest = mgr.restore_latest({"params": params,
                                                 "opt": state})
        mgr.close()
        write_s = mgr.write_seconds
    finally:
        shutil.rmtree(d, ignore_errors=True)
    moved = sum(not torch.equal(params[k].detach().cpu(), v)
                for k, v in before["params"].items())
    equal = all(torch.equal(restored["params"][k], v)
                for k, v in before["params"].items()) and all(
        torch.equal(restored["opt"].mu[k], before["mu"][k])
        and torch.equal(restored["opt"].nu[k], before["nu"][k])
        for k in before["mu"])
    if not (equal and moved and manifest["step"] == 1
            and restored["opt"].count == 1 and len(write_s) == 1):
        raise AssertionError(f"async snapshot of {arch}: equal to the "
                             f"pre-step state {equal}, {moved} params moved "
                             f"by the next step, count "
                             f"{restored['opt'].count}")
    log(f"async snapshot {arch} full on cuda: save on the step turn "
        f"(device-to-host copy of params + 2 moments) {turn_s} s, the next "
        f"train step {step_s} s, the writer to durability {write_s[0]} s; "
        f"the in-place step moved {moved} of {len(params)} param leaves, "
        f"the snapshot restored bit for bit equal to the pre-step state "
        f"(host clock) on {smi}")
    out.update(async_turn_s=turn_s, async_write_s=write_s[0])
    del model, opt, params, state, restored, before
    gc.collect()
    torch.cuda.empty_cache()

    # reduced MoE in fp32: no kernel path keeps a stale copy of a weight
    arch = "qwen2-moe-a2.7b"
    per_step = train_launches_per_step(reduced(get_arch(arch)))
    kw = dict(reduced_cfg=True, device="cuda", verbose=False, steps=6,
              batch=2, seq=320, lr=MOE_HYBRID_PARITY_LR, seed=5)
    ops.reset_launch_counts()
    full, cut, resumed, on_disk, after, _ = _interrupt_and_resume(
        train, arch, **kw)
    counts = ops.launch_counts()
    # (a) runs every step, (b) and (c) share them between them
    want = {k: v * 2 * kw["steps"] for k, v in per_step.items()}
    dl, _, dp, same_l, same_p = _resume_diffs(torch, full, resumed)
    if not (counts == want and dl <= TRAIN_PARITY_TOL
            and dp <= TRAIN_PARITY_TOL):
        raise AssertionError(f"reduced {arch} resume: loss diff {dl}, param "
                             f"diff {dp}, launches {counts} (want {want})")
    log(f"ckpt reduced {arch} fp32 at lr {MOE_HYBRID_PARITY_LR}: saved "
        f"{on_disk}, resumed from {resumed['resumed_from']}, through "
        f"{after}; launches {counts} (per step {per_step}); resumed losses "
        f"{resumed['history']} vs {full['history'][CKPT_STOP:]}: max diff "
        f"{dl}, bitwise {same_l}; params max diff {dp}, bitwise {same_p} "
        f"(tol {TRAIN_PARITY_TOL})")
    return out


def phase_crash(torch, ops, smi: str) -> None:
    """Phase 6j: crash recovery on the wavefront path on ``cuda``:
    ``crash_smoke`` (kill host 1 after step 3 of 8, async snapshots every 2
    steps) prints ``[crash] OK`` (history equal to the uninterrupted run on
    the survivors within 1e-6, rollback steps = kill step - restored step,
    the dead devices unplaced, a durable snapshot) on ``cuda`` and on
    ``cpu``, the two histories within ``MT_TOL``; the cooperative
    straggler restore (mode "restore", restored step 1, the next loss equal
    to ``reference_loss`` on the snapshot within 1e-6); a transient flap of
    host 1 (two restores, the cluster whole at the end).  No kernel."""
    import shutil
    import tempfile

    from repro_torch.ckpt import (AsyncCheckpointManager, CheckpointManager,
                                  restore_checkpoint, restore_to_mesh)
    from repro_torch.ckpt.remesh import fresh_module
    from repro_torch.core import ClusterSpec
    from repro_torch.launch.events import StragglerDetected
    from repro_torch.launch.faults import FaultInjector, FaultScript
    from repro_torch.launch.train import CRASH_CLUSTER, crash_smoke
    from repro_torch.runtime import tiny_multitask_clip
    from repro_torch.session import (CheckpointCallbacks, SessionConfig,
                                     SpindleSession)

    kill_at = 3
    ops.reset_launch_counts()
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[device] = crash_smoke(device=device, steps=8, kill_at=kill_at,
                                   kill_hosts=(1,), ckpt_every=2,
                                   verbose=False)
        runs[device]["seconds"] = time.perf_counter() - t0
        rec = [r for r in runs[device]["replans"] if r.mode == "restore"][0]
        if rec.rollback_steps != kill_at - rec.restored_step:
            raise AssertionError(f"crash {device}: rollback "
                                 f"{rec.rollback_steps} from step "
                                 f"{rec.restored_step}")
    diff = max(abs(a - b) for a, b in zip(runs["cuda"]["history"],
                                          runs["cpu"]["history"]))
    if not diff <= MT_TOL:
        raise AssertionError(f"crash cuda vs cpu: histories differ by {diff}")

    cluster = ClusterSpec(**CRASH_CLUSTER)
    tasks = ("img_text", "audio_text", "audio_vision")

    def session(**kw):
        config = kw.pop("config", {})
        return SpindleSession(
            SessionConfig(cluster=cluster, device="cuda", **config),
            model_factory=lambda ts: tiny_multitask_clip(n_tasks=len(ts)),
            tasks=tasks, **kw).bind()

    d = tempfile.mkdtemp(prefix="straggler_")
    try:
        sess = session(config={"straggler_shrink": True},
                       callbacks=[CheckpointCallbacks(
                           CheckpointManager(d, every=0))])
        sess.run(2)
        sess.signal(StragglerDetected((1,)))
        rec = sess.replans[-1]
        ref, _ = restore_checkpoint(d, {"params": sess.params,
                                        "opt": sess.opt_state})
    finally:
        shutil.rmtree(d, ignore_errors=True)
    module = fresh_module(sess.params, restore_to_mesh(ref["params"], "cuda"))
    batches = {t: {k: v.to("cuda") for k, v in b.items()}
               for t, b in sess.batches.items()}
    ref_loss = float(sess.model.reference_loss(module, batches).detach())
    loss = sess.step()
    if not (rec.mode == "restore" and rec.restored_step == 1
            and abs(loss - ref_loss) <= 1e-6):
        raise AssertionError(f"straggler restore on cuda: {rec.mode} at "
                             f"{rec.restored_step}, loss {loss} vs "
                             f"reference {ref_loss}")

    d = tempfile.mkdtemp(prefix="flap_")
    try:
        mgr = AsyncCheckpointManager(d, every=1)
        inj = FaultInjector(cluster.n_hosts, retry_window=1, schedule=[
            FaultScript(step=1, hosts=(1,), down_for=4)])
        flap = session(callbacks=[CheckpointCallbacks(mgr)],
                       event_sources=[inj])
        flap.run(8)
        mgr.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    modes = [r.mode for r in flap.replans]
    counts = ops.launch_counts()
    if modes != ["restore", "restore"] or flap.cluster != cluster \
            or any(counts.values()):
        raise AssertionError(f"flap on cuda: replans {modes}, cluster whole "
                             f"{flap.cluster == cluster}, launches {counts}")
    g = runs["cuda"]
    log(f"crash recovery (wavefront session, simulated 8-device cluster, "
        f"engine on one card): kill host 1 after step {kill_at} of 8 -> "
        f"[crash] OK on cuda and cpu (rollback "
        f"{[(r.restored_step, r.rollback_steps) for r in g['replans']]}, "
        f"durable steps {g['durable_steps']}, max err vs the survivors' run "
        f"{g['max_err']}); cuda vs cpu histories max diff {diff} (tol "
        f"{MT_TOL}); {runs['cuda']['seconds']} s on cuda, "
        f"{runs['cpu']['seconds']} s on cpu (host clock); straggler restore "
        f"at step {rec.restored_step}: next loss {loss} vs reference "
        f"{ref_loss}; flap replans {modes}, cluster whole again; launches "
        f"{counts} on {smi}")


def _engine_delta(torch, session) -> tuple:
    """Engine loss and grads against autograd of ``reference_loss`` on the
    session's current params and batches."""
    dev = next(session.params.parameters()).device
    batches = {t: {k: v.to(dev) for k, v in b.items()}
               for t, b in session.batches.items()}
    ref_l, ref_g = session.model.reference_loss_and_grads(session.params,
                                                          batches)
    loss, grads = session.engine.loss_and_grads(session.params, batches)
    dg = max(float((grads[n] - g).abs().max()) for n, g in ref_g.items())
    return abs(float(loss) - float(ref_l)), dg


def phase_wavefront(torch, smi: str) -> None:
    """A bound SpindleSession over tiny_multitask_clip and tiny_ofasys on
    cuda: the engine equals the reference before and after a
    TaskCompleted replan, and the loss history equals the cpu run's
    (``MT_TOL`` through the first step on the rebound engine,
    ``MT_RESTART_TOL`` after the update that restarts Adam's moments);
    then a wider clip (d 512, batch 16) through the same session, step
    times and waves."""
    from repro_torch.core import ClusterSpec
    from repro_torch.launch.events import TaskCompleted
    from repro_torch.runtime import tiny_multitask_clip, tiny_ofasys
    from repro_torch.session import SessionConfig, SpindleSession

    cluster = ClusterSpec(n_devices=8, island_size=4, mem_bytes=80e9)
    cases = {"clip": (tiny_multitask_clip,
                      ("img_text", "audio_text", "audio_vision"),
                      "audio_vision"),
             "ofasys": (tiny_ofasys, ("caption", "asr", "summ"), "summ")}
    for name, (maker, tasks, done) in cases.items():
        hist, deltas, recs = {}, {}, {}
        for device in ("cuda", "cpu"):
            sess = SpindleSession(
                SessionConfig(cluster=cluster, device=device),
                model_factory=lambda ts, maker=maker: maker(n_tasks=len(ts)),
                tasks=tasks).bind()
            d = [_engine_delta(torch, sess)]
            sess.run(3)
            sess.signal(TaskCompleted(done))
            d.append(_engine_delta(torch, sess))
            sess.run(2)
            if max(max(x) for x in d) > MT_TOL:
                raise AssertionError(f"wavefront {name} {device}: engine vs "
                                     f"reference (loss, grad) {d}")
            hist[device], deltas[device] = sess.history, d
            recs[device] = sess.replans[-1]
        diffs = [abs(a - b) for a, b in zip(hist["cuda"], hist["cpu"])]
        diff = max(diffs)
        # history[3] is the first loss on the rebound engine; history[4]
        # follows the first update with restarted moments
        if not (max(diffs[:4]) <= MT_TOL and diff <= MT_RESTART_TOL):
            raise AssertionError(f"wavefront {name}: cuda losses "
                                 f"{hist['cuda']} != cpu {hist['cpu']}")
        rec = recs["cuda"]
        log(f"wavefront {name} (bound session, TaskCompleted({done}) after "
            f"step 3 -> {rec.mode}, {rec.closures_cached} closures kept): "
            f"engine == reference on cuda before and after (loss, grad "
            f"deltas {deltas['cuda']}); cuda losses == cpu within {MT_TOL} "
            f"through the rebind, {MT_RESTART_TOL} after the moment restart "
            f"(diffs {diffs}): {hist['cuda']}")
    sess = SpindleSession(
        SessionConfig(cluster=cluster, device="cuda"),
        model_factory=lambda ts: tiny_multitask_clip(n_tasks=len(ts), d=512,
                                                      batch=16),
        tasks=cases["clip"][1]).bind()
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        loss = sess.step()
        secs.append(time.perf_counter() - t0)
    if not math.isfinite(loss):
        raise AssertionError(f"wide clip: loss {loss}")
    log(f"wavefront wide clip (d 512, batch 16, 3 tasks) on cuda: "
        f"{len(sess.current_plan.waves())} waves, step_ms "
        f"{[t * 1e3 for t in secs]}, losses {sess.history} on {smi}")


# phases 7-7c: the fleet's serve job at phase 4's trace (one request
# admitted per serving step); phase 7b's train job runs long enough for the
# tenant to drain inside its idle windows (on the CPU, full width: 38 tenant
# steps ride 24 host steps); the host-failure scenario of
# tests/test_faults.py:440 on its cluster (:355)
FLEET_SERVE = dict(kind="serve", arch="qwen3-0.6b", requests=8,
                   prompt_len=512, gen_len=32, slots=8, cache_len=544)
COLOC_TRAIN_STEPS = 24
FAULTS_CLUSTER = dict(n_devices=32, island_size=4, devices_per_host=4,
                      mem_bytes=96e9)


def _fleet_tokens(fleet, name: str) -> dict:
    return {rid: list(r.tokens)
            for rid, r in fleet.jobs[name].session.results.items()}


def _check_fleet_launches(what: str, counts: dict, session) -> None:
    """Flash 28 x prefill calls and paged decode 28 x decode steps of the
    fleet's full qwen3 serve session; every other kernel 0."""
    sm = session.metrics()
    check_launches(what, counts, SERVED["qwen3-0.6b"][1],
                   {"chunk_steps": sm["prefill_calls"],
                    "decode_steps": sm["decode_steps"]})


def phase_fleet_full(torch, ops, model, smi: str):
    """Phase 7: ``launch/fleet.py``'s smoke mix (two duplicate
    multitask_clip train jobs) and a serve job of full qwen3-0.6b through
    ``model_cache``, on 8 hosts of 4 H100s (``FleetConfig``'s defaults: the
    H100 spec, 80 GB cards), a straggler flagged at tick 6: every job
    drains, the arbiter's invariants hold, a rebalance, post-rebalance steps
    for every survivor, a cross-job hit, the launch rule.  Returns (paged
    launches, the serve job's tokens per rid)."""
    from repro_torch.fleet import FleetConfig, FleetScheduler, JobSpec
    from repro_torch.launch.events import ScriptedEventSource, StragglerDetected
    from repro_torch.launch.fleet import FleetPrinter, smoke_jobs

    jobs = smoke_jobs()[:2] + [JobSpec(name="serve0", **FLEET_SERVE)]
    printer = FleetPrinter(verbose=False)
    fleet = FleetScheduler(
        FleetConfig(), jobs, callbacks=[printer],
        event_sources=[ScriptedEventSource([StragglerDetected((7,))],
                                           fire_at=[6])],
        model_cache={"qwen3-0.6b": model})
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    fleet.arbiter.check()
    stalled = [n for live in printer.survivors_at_rebalance for n in live
               if fleet.jobs[n].post_rebalance_steps < 1]
    if (any(r["state"] != "done" for r in m["jobs"]) or m["rebalances"] < 1
            or stalled or m["cross_job_hits"] < 1):
        raise AssertionError(f"fleet full: states "
                             f"{[(r['name'], r['state']) for r in m['jobs']]}"
                             f", rebalances {m['rebalances']}, stalled "
                             f"{stalled}, cross-job hits "
                             f"{m['cross_job_hits']}")
    sess = fleet.jobs["serve0"].session
    _check_fleet_launches("fleet serve0 (phase 7)", counts, sess)
    sm = sess.metrics()
    log(f"fleet (launch/fleet.py smoke mix + full qwen3-0.6b serve job, 8 x "
        f"512 prompt x 32 new, 8 slots; 8 hosts x 4 cards, hw=H100, "
        f"straggler host 7 at tick 6): wall_s={wall} serve0 "
        f"throughput_tok_s={sm['throughput_tok_s']} (output tokens "
        f"{sm['output_tokens']} / busy_s {sm['busy_seconds']}) "
        f"prefill_calls={sm['prefill_calls']} decode_steps="
        f"{sm['decode_steps']} launches={counts}; virtual makespan_s="
        f"{m['makespan_s']} device_idle_frac={m['device_idle_frac']} "
        f"ticks={m['ticks']} rebalances={m['rebalances']} cross_job_hits="
        f"{m['cross_job_hits']} lease={json.dumps(m['lease'])} on {smi}")
    return counts["paged_attention"], _fleet_tokens(fleet, "serve0")


def phase_colocate_full(torch, ops, model, smi: str) -> None:
    """Phase 7b: the ``colocate`` policy at full width: one multitask_clip
    train job and phase 7's serve job as its tenant, whose first step (taken
    before it has a plan) is priced by its planner
    (``launch.fleet.first_serve_step_dt``).  At least one tenant
    step inside a training window, the tenant holding no grant at any of
    its steps, its KV high-water within its window headroom, the launch
    rule, and its tokens equal to a solo ``ServingSession`` (``replan=
    "off"``) on the same model and trace."""
    from repro_torch.fleet import (FleetCallbacks, FleetConfig,
                                   FleetScheduler, JobSpec)
    from repro_torch.launch.fleet import (_tenant_kv_high_water_bytes,
                                          first_serve_step_dt)
    from repro_torch.serving import ServingConfig, ServingSession

    class GrantWatch(FleetCallbacks):
        held = 0  # tenant steps taken while the arbiter granted it hosts

        def on_job_step(self, fleet, handle, step, dt):
            if handle.name in fleet.arbiter.granted and \
                    handle.spec.kind == "serve":
                self.held += 1

    spec = JobSpec(name="tenant", **FLEET_SERVE)
    jobs = [JobSpec(name="train0", kind="train", workload="multitask_clip",
                    steps=COLOC_TRAIN_STEPS), spec]
    watch = GrantWatch()
    config = FleetConfig(policy="colocate")
    first_dt = first_serve_step_dt(spec, config, model.cfg)
    fleet = FleetScheduler(
        dataclasses.replace(config, serve_fallback_dt=first_dt), jobs,
        callbacks=[watch], model_cache={"qwen3-0.6b": model})
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    fleet.arbiter.check()
    tenant = fleet.jobs["tenant"]
    kv_hw = _tenant_kv_high_water_bytes(tenant)
    if (any(r["state"] != "done" for r in m["jobs"])
            or tenant.colocated_steps < 1 or tenant.co_host != "train0"
            or watch.held or "tenant" in fleet.arbiter.granted
            or not 0 < kv_hw <= tenant.window_headroom_bytes):
        raise AssertionError(f"colocate full: {tenant.summary()}, grant held "
                             f"at {watch.held} steps, kv high-water {kv_hw}")
    _check_fleet_launches("colocate tenant (phase 7b)", counts,
                          tenant.session)
    solo = ServingSession(ServingConfig(arch="qwen3-0.6b", device="cuda",
                                        max_slots=spec.slots,
                                        cache_len=spec.cache_len,
                                        replan="off"), model=model)
    pending = fleet._make_requests(spec)
    while pending or solo.busy:
        while pending and pending[0].arrival <= solo.steps:
            solo.submit(pending.pop(0))
        solo.step()
    got = _fleet_tokens(fleet, "tenant")
    want = {rid: list(r.tokens) for rid, r in solo.results.items()}
    if got != want:
        raise AssertionError(f"colocated tenant tokens != solo session's:\n"
                             f"{got}\n{want}")
    sm = tenant.session.metrics()
    widest = sorted(w.duration for w in fleet.jobs["train0"].session
                    .current_plan.timeline().gang_windows(k=1))[-3:]
    log(f"colocate full (multitask_clip x {COLOC_TRAIN_STEPS} steps hosting "
        f"the full qwen3-0.6b tenant): host plan's widest windows (k=1) "
        f"{widest} s, tenant's first step priced at {first_dt} s, its "
        f"planned decode step {fleet._serve_dt(tenant)} s (virtual); wall_s={wall} colocated_steps="
        f"{tenant.colocated_steps} of {tenant.steps_done} windows_seen="
        f"{tenant.windows_seen} deferred_windows={tenant.deferred_windows} "
        f"kv_budget_bytes={tenant.kv_budget_bytes} kv_high_water_bytes="
        f"{kv_hw} window_headroom_bytes={tenant.window_headroom_bytes}; "
        f"tokens == solo session's ({sum(map(len, got.values()))} tokens); "
        f"tenant throughput_tok_s={sm['throughput_tok_s']} launches={counts}"
        f"; virtual makespan_s={m['makespan_s']} device_idle_frac="
        f"{m['device_idle_frac']} ticks={m['ticks']} on {smi}")


def _host_failure_fleet(device: str):
    """tests/test_faults.py:440: multitask_clip x 12 and a reduced qwen3
    (fp32) serve job; a FaultInjector kills hosts 4 and 5 at step 6."""
    from repro_torch.core import ClusterSpec
    from repro_torch.fleet import FleetConfig, FleetScheduler, JobSpec
    from repro_torch.launch.faults import FaultInjector, FaultScript

    jobs = [JobSpec(name="t0", kind="train", workload="multitask_clip",
                    steps=12),
            JobSpec(name="s0", kind="serve", arch="qwen3-0.6b", requests=6,
                    prompt_len=8, gen_len=4, slots=2, cache_len=32)]
    inj = FaultInjector(8, schedule=[FaultScript(step=6, hosts=(4, 5))])
    fleet = FleetScheduler(
        FleetConfig(cluster=ClusterSpec(**FAULTS_CLUSTER), device=device),
        jobs, event_sources=[inj])
    m = fleet.run()
    fleet.arbiter.check()
    return m, _fleet_tokens(fleet, "s0")


def phase_fleet_faults(torch, ops, model, smi: str,
                       full_tokens: dict) -> None:
    """Phase 7c: the host-failure fleet on the card and on the CPU from
    the same seed: one host failure, requests requeued, identical
    ``metrics()`` and tokens.  Then phase 7's mix with host 7 (the serve
    job's) killed at tick 6 instead of flagged: the serve job requeues and
    re-prefills; the share of its tokens equal to phase 7's is reported (in
    bf16 a re-prefill in another batch may flip a greedy token)."""
    from repro_torch.fleet import FleetConfig, FleetScheduler, JobSpec
    from repro_torch.launch.faults import FaultInjector, FaultScript
    from repro_torch.launch.fleet import smoke_jobs

    t0 = time.perf_counter()
    (gm, gtok), (cm, ctok) = (_host_failure_fleet("cuda"),
                              _host_failure_fleet("cpu"))
    secs = time.perf_counter() - t0
    if not (gm["host_failures"] == 1 and gm["requeued_requests"] >= 1
            and gm == cm and gtok == ctok):
        raise AssertionError(f"host-failure fleet cuda vs cpu: metrics "
                             f"equal {gm == cm}, tokens equal {gtok == ctok}"
                             f", host_failures {gm['host_failures']}, "
                             f"requeued {gm['requeued_requests']}")
    jobs = smoke_jobs()[:2] + [JobSpec(name="serve0", **FLEET_SERVE)]
    inj = FaultInjector(8, schedule=[FaultScript(step=6, hosts=(7,))])
    fleet = FleetScheduler(FleetConfig(), jobs, event_sources=[inj],
                           model_cache={"qwen3-0.6b": model})
    ops.reset_launch_counts()
    m = fleet.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    fleet.arbiter.check()
    serve0 = fleet.jobs["serve0"]
    if (any(r["state"] != "done" for r in m["jobs"])
            or m["host_failures"] != 1 or serve0.requeued_requests < 1):
        raise AssertionError(f"full-width kill: {m['jobs']}, host failures "
                             f"{m['host_failures']}")
    _check_fleet_launches("full-width kill (phase 7c)", counts,
                          serve0.session)
    got = _fleet_tokens(fleet, "serve0")
    pairs = [(a, b) for rid in full_tokens
             for a, b in zip(got[rid], full_tokens[rid])]
    same = sum(a == b for a, b in pairs) / len(pairs)
    log(f"fleet host loss: reduced qwen3 fp32 (tests/test_faults.py:440, "
        f"hosts 4, 5 killed at step 6) on cuda and cpu: host_failures="
        f"{gm['host_failures']} requeued_requests="
        f"{gm['requeued_requests']}, metrics() identical, tokens identical "
        f"({sum(map(len, gtok.values()))} tokens; {secs} s both runs); "
        f"full qwen3 serve job with host 7 killed at tick 6: requeued "
        f"{serve0.requeued_requests}, prefill_calls="
        f"{serve0.session.metrics()['prefill_calls']} launches={counts}, "
        f"share of tokens equal to phase 7's {same} on {smi}")


def phases_fleet(torch, ops, smi: str) -> int:
    """Phases 7-7c on one full-width qwen3-0.6b (random weights, seed 0),
    freed at the end.  Returns phase 7's paged-decode launches."""
    from repro_torch.config import default_sharding, get_arch
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("qwen3-0.6b")
    model = build_model(cfg, default_sharding(cfg, use_kernels=True),
                        device="cuda").init(0)
    paged_launches, tokens = phase_fleet_full(torch, ops, model, smi)
    phase_colocate_full(torch, ops, model, smi)
    phase_fleet_faults(torch, ops, model, smi, tokens)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return paged_launches


# phases 8-8c: training on a mesh of ranks.  The ranks share the one card
# through gloo (NCCL refuses two ranks on one device: pick_backend);
# phase 8 starts NCCL on a world of one.  8a is 6e's cut (4 of 24
# layers) at 2 steps, 8b phase 6's model and global batch at 2
MESH_MOE_RUN = dict(reduced_cfg=False, steps=3, batch=4, seq=64, lr=1e-3,
                    seed=0)
EP_RUN = dict(reduced_cfg=False, steps=2, batch=4, seq=1024, lr=1e-3, seed=0)
DP_RUN = dict(reduced_cfg=False, steps=2, batch=8, seq=1024, lr=1e-3, seed=0)
# 8a, 8b: a mesh run against one process, per step (|diff| above it
# fails): about twice 8a's reading of 2.53e-3 and five times 8b's of
# 2.07e-4 (NVIDIA H100 80GB HBM3, 700 W; the same in three runs)
EP_LOSS_TOL = 5e-3
DP_LOSS_TOL = 1e-3
COMPRESS_LAST_TOL = 0.05  # tests/test_compressed_dp.py:41
REMESH_TOL = 1e-5  # 8c, reduced fp32


def _rank_train(rank: int, jobs) -> dict:
    """A spawned rank (``parallel.mesh.run_ranks``): each job (name, mesh
    shape over (data, model), arch config, ``train`` kwargs) through
    ``train(mesh=)`` on the card, its launch counts zeroed just before
    and read just after; its history, step seconds, peak memory, counts
    and a sha256 of each parameter this rank holds after the run (an
    expert stack: its shard).  Under NCCL one all-reduce shows that the
    backend carries a collective (a world of one runs none on the main
    path)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.parallel import collectives, make_mesh

    def sha(t):
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
        return hashlib.sha256(raw.numpy().tobytes()).hexdigest()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": dist.get_backend()}
    if out["backend"] == "nccl":
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        out["all_reduce"] = float(t)
    for name, shape, cfg, kw in jobs:
        mesh = make_mesh(shape, ("data", "model"), "cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        collectives.reset_traffic()
        r = train(cfg, device="cuda", verbose=False, mesh=mesh, **kw)
        torch.cuda.synchronize()
        out[name] = dict(history=r["history"], step_s=r["step_seconds"],
                         counts=ops.launch_counts(),
                         traffic=dict(collectives.TRAFFIC),
                         peak=torch.cuda.max_memory_allocated(),
                         coord=list(mesh.get_coordinate()),
                         sha={k: sha(v) for k, v in r["params"].items()})
        del r
    return out


def _one_process(torch, train, cfg, kw, runs: int) -> list:
    """``runs`` one-process ``train`` runs of ``cfg`` on the card: (history,
    step seconds, peak memory) each; the model freed after each."""
    out = []
    for _ in range(runs):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = train(cfg, device="cuda", verbose=False, **kw)
        torch.cuda.synchronize()
        out.append((r["history"], r["step_seconds"],
                    torch.cuda.max_memory_allocated()))
        del r
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _max_diff(a, b) -> float:
    return max(abs(x - y) for x, y in zip(a, b))


def phase_mesh_nccl(torch, smi: str) -> None:
    """Phase 8: a world of one process on NCCL, a (1, 1) mesh, reduced
    qwen2-moe in fp32 for 3 steps: the history equals ``train(mesh=None)``
    bit for bit."""
    from repro_torch.config import get_arch, reduced
    from repro_torch.launch.train import train
    from repro_torch.parallel.mesh import run_ranks

    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    ((one, _, _),) = _one_process(torch, train, cfg, MESH_MOE_RUN, 1)
    t0 = time.perf_counter()
    (r,) = run_ranks(_rank_train, 1, "cuda",
                     args=([("mesh", (1, 1), cfg, MESH_MOE_RUN)],))
    secs = time.perf_counter() - t0
    if r["backend"] != "nccl" or r["all_reduce"] != 1.0:
        raise AssertionError(f"phase 8: backend {r['backend']}, all-reduce "
                             f"{r.get('all_reduce')}")
    if r["mesh"]["history"] != one:
        raise AssertionError(f"phase 8: (1, 1) mesh on NCCL {r['mesh']} != "
                             f"one process {one}")
    log(f"mesh (1, 1) on a one-rank {r['backend']} group (reduced "
        f"qwen2-moe fp32, 3 steps): history {one} equal bit for bit to "
        f"train(mesh=None); launches {r['mesh']['counts']}; {secs} s with "
        f"the spawn, on {smi}")


def _check_replicas(what: str, ranks, name: str) -> int:
    """Every replicated parameter (all but the expert stacks, which a
    model axis shards) hashes alike on all ranks: the history is the loss
    already averaged over the ranks, so only the parameters show a faulty
    sync.  Returns the number of replicated parameters compared."""
    from repro_torch.models.moe import EXPERT_STACKS

    shas = [r[name]["sha"] for r in ranks]
    replicated = [k for k in shas[0]
                  if k.rsplit(".", 1)[-1] not in EXPERT_STACKS]
    apart = [k for k in replicated if any(h[k] != shas[0][k] for h in shas)]
    if apart:
        raise AssertionError(f"{what}: {len(apart)} of {len(replicated)} "
                             f"replicated parameters differ across ranks, "
                             f"e.g. {apart[:4]}")
    return len(replicated)


def _check_ranks(what: str, ranks, name: str, want_counts: dict) -> int:
    """Every rank reports one history and ``want_counts``, and the
    replicas agree (:func:`_check_replicas`, whose count it returns)."""
    hists = [r[name]["history"] for r in ranks]
    if any(h != hists[0] for h in hists):
        raise AssertionError(f"{what}: ranks report different histories "
                             f"{hists}")
    for r in ranks:
        if r["backend"] != "gloo":
            raise AssertionError(f"{what}: backend {r['backend']}")
        if r[name]["counts"] != want_counts:
            raise AssertionError(f"{what} rank {r[name]['coord']}: launch "
                                 f"counts {r[name]['counts']} != "
                                 f"{want_counts}")
    return _check_replicas(what, ranks, name)


def _rank_line(ranks, name: str) -> str:
    return "; ".join(
        f"rank {i} coord {r[name]['coord']}: step_ms="
        f"{[t * 1e3 for t in r[name]['step_s']]} peak_mem_bytes="
        f"{r[name]['peak']} launches={r[name]['counts']} "
        f"collective_bytes_per_step="
        f"{ {k: v / len(r[name]['step_s']) for k, v in r[name]['traffic'].items()} }"
        for i, r in enumerate(ranks))


def phase_ep_full(torch, smi: str) -> dict:
    """Phase 8a: qwen2-moe-a2.7b at full width cut to 4 layers (bf16
    params), 4 x 1,024, 2 steps on two ranks sharing the card through
    gloo, mesh (data 1, model 2): each rank holds experts 32·r..32·r+31
    and runs the grouped matmul at E 32, C 341, 9 times per MoE layer and
    step (forward, recompute, dx).  The first loss equals one one-process
    run's bit for bit (the partial outputs are summed in fp32 and rounded
    once), every later one within ``EP_LOSS_TOL`` (backward sums the
    ranks' bf16 partial gradients: another rounding order); every
    replicated parameter hashes alike on both ranks; the ranks' peaks sum
    below ``PEAK_LIMIT``."""
    from repro_torch.config import get_arch
    from repro_torch.launch.train import train
    from repro_torch.parallel.mesh import run_ranks

    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b"),
                              n_layers=TRAIN_CUT["qwen2-moe-a2.7b"])
    steps = EP_RUN["steps"]
    per_step = train_launches_per_step(cfg)
    want = {k: v * steps for k, v in per_step.items()}
    t0 = time.perf_counter()
    ones = _one_process(torch, train, cfg, EP_RUN, 1)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(_rank_train, 2, "cuda",
                      args=([("ep", (1, 2), cfg, EP_RUN)],))
    secs = time.perf_counter() - t0
    n_rep = _check_ranks("phase 8a", ranks, "ep", want)
    ep = ranks[0]["ep"]["history"]
    diff = _max_diff(ep, ones[0][0])
    peak = sum(r["ep"]["peak"] for r in ranks)
    if (ep[0] != ones[0][0][0] or not diff <= EP_LOSS_TOL
            or not peak < PEAK_LIMIT):
        raise AssertionError(f"phase 8a: EP losses {ep} vs one process "
                             f"{ones[0][0]} (max diff {diff}), peaks "
                             f"{peak} bytes")
    log(f"EP qwen2-moe-a2.7b full width cut to {cfg.n_layers} layers (64 "
        f"experts, 32 a rank; bf16 params; 4 x 1,024, {steps} steps) on 2 "
        f"ranks sharing the card through {ranks[0]['backend']}, mesh (data "
        f"1, model 2): losses {ep}; one process {ones[0][0]} "
        f"(one-process step_ms {[t * 1e3 for t in ones[0][1]]}, peak "
        f"{ones[0][2]}, {one_s} s); first loss bit-equal, EP vs one "
        f"process max |diff| "
        f"{diff} (limit {EP_LOSS_TOL}); {n_rep} replicated params "
        f"sha256-equal on both ranks; predicted launches per step and rank "
        f"{per_step}; ranks' peaks together {peak} bytes; {_rank_line(ranks, 'ep')}; "
        f"{secs} s with the spawn, on {smi}")
    return {"launches": sum(r["ep"]["counts"]["grouped_matmul"]
                            for r in ranks),
            "per_step": per_step["grouped_matmul"]}


def phase_dp_full(torch, smi: str) -> dict:
    """Phase 8b: full qwen3-0.6b, global batch 8 x 1,024 on two ranks
    sharing the card through gloo, mesh (data 2, model 1), 2 steps: 56
    flash launches per rank and step; the losses equal one one-process
    run over the global batch within ``DP_LOSS_TOL``.  Then
    ``compress_grads=True``: JAX's two conditions
    (``tests/test_compressed_dp.py:40-41``), the first losses equal and
    the last within ``COMPRESS_LAST_TOL``.  In both runs every parameter
    hashes alike on both ranks."""
    from repro_torch.config import get_arch
    from repro_torch.launch.train import train
    from repro_torch.parallel.mesh import run_ranks

    cfg = get_arch("qwen3-0.6b")
    steps = DP_RUN["steps"]
    per_rank = {k: 0 for k in ("paged_attention", "flash_attention",
                               "flash_attention_backward", "grouped_matmul",
                               "rglru_scan")}
    per_rank["flash_attention"] = 2 * cfg.n_layers * steps
    per_rank["flash_attention_backward"] = cfg.n_layers * steps
    t0 = time.perf_counter()
    ones = _one_process(torch, train, cfg, DP_RUN, 1)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(_rank_train, 2, "cuda", args=(
        [("dp", (2, 1), cfg, DP_RUN),
         ("int8", (2, 1), cfg, dict(DP_RUN, compress_grads=True))],))
    secs = time.perf_counter() - t0
    n_rep = _check_ranks("phase 8b", ranks, "dp", per_rank)
    _check_ranks("phase 8b int8", ranks, "int8", per_rank)
    dp, q = ranks[0]["dp"]["history"], ranks[0]["int8"]["history"]
    diff = _max_diff(dp, ones[0][0])
    if not diff <= DP_LOSS_TOL:
        raise AssertionError(f"phase 8b: DP losses {dp} vs one process "
                             f"{ones[0][0]} (max diff {diff})")
    if q[0] != dp[0] or not abs(q[-1] - dp[-1]) < COMPRESS_LAST_TOL:
        raise AssertionError(f"phase 8b: compressed {q} vs uncompressed "
                             f"{dp}: first equal and last within "
                             f"{COMPRESS_LAST_TOL} required")
    log(f"DP qwen3-0.6b full (28 layers) global batch 8 x 1,024, 4 x 1,024 "
        f"a rank, {steps} steps on 2 ranks sharing the card through "
        f"{ranks[0]['backend']}, mesh (data 2, model 1): losses {dp}; one "
        f"process {ones[0][0]} (one-process step_ms "
        f"{[t * 1e3 for t in ones[0][1]]}, peak {ones[0][2]}, {one_s} s); "
        f"DP vs one process max "
        f"|diff| {diff} (limit {DP_LOSS_TOL}); {n_rep} params sha256-equal "
        f"on both ranks in both runs; "
        f"{_rank_line(ranks, 'dp')}; int8-compressed gradients: losses {q} "
        f"(first equal, last {abs(q[-1] - dp[-1])} from the uncompressed "
        f"run, limit {COMPRESS_LAST_TOL}); {_rank_line(ranks, 'int8')}; "
        f"{secs} s with the spawn, on {smi}")
    return {"launches": sum(r["dp"]["counts"]["flash_attention"]
                            for r in ranks),
            "per_step": 2 * cfg.n_layers,
            "backward_launches": sum(
                r["dp"]["counts"]["flash_attention_backward"] for r in ranks),
            "backward_per_step": cfg.n_layers}


def phase_remesh(torch, smi: str) -> None:
    """Phase 8c: reduced qwen2-moe in fp32 on two ranks (model 2) for 2
    of 4 steps, a checkpoint of its logical arrays each step; then one
    process resumes from it (``train``'s restore places it through
    ``restore_to_mesh``) and trains steps 2-3: their losses equal an
    uninterrupted 2-rank run's within ``REMESH_TOL``, and the EP
    checkpoint's names and shapes equal the one-process checkpoint's."""
    import shutil
    import tempfile

    from repro_torch.ckpt.checkpoint import _read_manifest
    from repro_torch.config import get_arch, reduced
    from repro_torch.launch.train import train
    from repro_torch.parallel.mesh import run_ranks

    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    kw = dict(MESH_MOE_RUN, steps=4)
    d = tempfile.mkdtemp(prefix="remesh_")
    try:
        ck = dict(kw, ckpt_dir=f"{d}/ck", ckpt_every=1, stop_at_step=2)
        ranks = run_ranks(_rank_train, 2, "cuda", args=(
            [("cut", (1, 2), cfg, ck), ("whole", (1, 2), cfg, kw)],))
        whole = ranks[0]["whole"]["history"]
        n_rep = _check_replicas("phase 8c", ranks, "whole")
        res = train(cfg, device="cuda", verbose=False, ckpt_dir=f"{d}/ck",
                    ckpt_every=1, **kw)

        def layout(step):
            man = _read_manifest(f"{d}/ck", step)
            return {l["name"]: l["shape"] for l in man["leaves"]}

        ep, one = layout(1), layout(3)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    diff = _max_diff(res["history"], whole[2:])
    if (res["resumed_from"] != 1 or len(res["history"]) != 2
            or not diff <= REMESH_TOL or ep != one):
        raise AssertionError(f"phase 8c: resumed from {res['resumed_from']}"
                             f", losses {res['history']} vs {whole[2:]} "
                             f"(diff {diff}), layouts equal {ep == one}")
    log(f"re-mesh (reduced qwen2-moe fp32): 2 ranks (model 2) trained steps "
        f"0-1 {ranks[0]['cut']['history']} and saved the logical arrays; "
        f"one process restored step 1 through restore_to_mesh and trained "
        f"steps 2-3 {res['history']} == the uninterrupted 2-rank run's "
        f"{whole[2:]} (max diff {diff}, tol {REMESH_TOL}); the 2-rank "
        f"run's {n_rep} replicated params sha256-equal on both ranks; the EP "
        f"checkpoint's {len(ep)} names and shapes equal the one-process "
        f"checkpoint's, on {smi}")


# phase 8d: the distributed wavefront engine, four ranks sharing the card
WAVE_CLUSTER = dict(n_devices=4, island_size=2, devices_per_host=1,
                    mem_bytes=80e9)
WAVE_WIDTH = dict(n_tasks=3, d=512, batch=16)  # phase 6c's wide clip
WAVE_STEPS, WAVE_STRAGGLER_AT = 6, 2
WAVE_LOSS_TOL, WAVE_GRAD_TOL = 1e-5, 1e-4  # tests/test_engine_distributed.py
WAVE_HIST_TOL = 1e-4


def _wave_session(mesh, ckpt_dir: str):
    """The 8d straggler session: wide clip, a checkpoint manager in
    ``ckpt_dir``, host 1 flagged after step ``WAVE_STRAGGLER_AT``; on the
    ranks of ``mesh`` (None: one process)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core import ClusterSpec
    from repro_torch.launch.events import ScriptedEventSource, StragglerDetected
    from repro_torch.runtime import tiny_multitask_clip
    from repro_torch.session import (CheckpointCallbacks, SessionConfig,
                                     SpindleSession)

    kw = dict(WAVE_WIDTH)
    kw.pop("n_tasks")
    return SpindleSession(
        SessionConfig(cluster=ClusterSpec(**WAVE_CLUSTER),
                      straggler_shrink=True, mesh=mesh, device="cuda"),
        model_factory=lambda ts: tiny_multitask_clip(n_tasks=len(ts), **kw),
        tasks=("img_text", "audio_text", "audio_vision"),
        callbacks=[CheckpointCallbacks(CheckpointManager(ckpt_dir, every=0))],
        event_sources=[ScriptedEventSource([StragglerDetected((1,))],
                                           fire_at=[WAVE_STRAGGLER_AT])],
    ).bind()


def _rank_wavefront(rank: int, ckpt_dir: str) -> dict:
    """A spawned 8d rank: (a) the engine against the reference on both
    models, then (b) the straggler session; per step its host ms (ending
    in a device sync), the plan steps and waves it ran, its bytes sent
    (moves, all-reduce) and its peak memory; the launch counts over both."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.core import ClusterSpec, plan
    from repro_torch.kernels import ops
    from repro_torch.parallel import collectives, mesh_over_devices
    from repro_torch.runtime import WaveEngine, tiny_multitask_clip, tiny_ofasys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    mesh = mesh_over_devices(range(4), device="cuda")
    out = {"backend": dist.get_backend()}
    for name, maker in (("clip", tiny_multitask_clip),
                        ("ofasys", tiny_ofasys)):
        model, batches = maker(**WAVE_WIDTH)
        params = model.init(0, device="cuda")
        batches = {t: {k: v.cuda() for k, v in b.items()}
                   for t, b in batches.items()}
        eng = WaveEngine(model, plan(model.graph, ClusterSpec(**WAVE_CLUSTER)),
                         distributed=True, mesh=mesh)
        eng.loss_and_grads(params, batches)  # warm-up
        collectives.reset_traffic()
        eng.ran.update(steps=0, waves=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = eng.loss_and_grads(params, batches)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref_l, ref_g = model.reference_loss_and_grads(params, batches)
        out[name] = dict(
            dloss=abs(float(loss) - float(ref_l)),
            dgrad=max(float((grads[n] - g).abs().max())
                      for n, g in ref_g.items()),
            ms=ms, ran=dict(eng.ran), traffic=dict(collectives.TRAFFIC),
            peak=torch.cuda.max_memory_allocated(),
            steps=len(eng.plan.steps), waves=len(eng.plan.waves()))
        del params, grads, ref_g
    sess = _wave_session(mesh, ckpt_dir)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(WAVE_STEPS):
        collectives.reset_traffic()
        before = dict(sess.engine.ran)
        t0 = time.perf_counter()
        sess.step()
        torch.cuda.synchronize()
        steps.append(dict(
            ms=(time.perf_counter() - t0) * 1e3,
            ran={k: sess.engine.ran[k] - before[k] for k in before},
            traffic=dict(collectives.TRAFFIC)))
    restores = [r for r in sess.replans if r.mode == "restore"]
    out["session"] = dict(
        history=list(sess.history), steps=steps,
        restores=[r.restored_step for r in restores],
        live=list(sess.engine.live), peak=torch.cuda.max_memory_allocated(),
        sha={n: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
             for n, p in sess.params.named_parameters()})
    out["counts"] = ops.launch_counts()
    return out


def phase_wavefront_distributed(torch, smi: str) -> None:
    """Phase 8d (see the module docstring)."""
    import shutil
    import tempfile

    from repro_torch.parallel.mesh import run_ranks

    d = tempfile.mkdtemp(prefix="wave8d_")
    try:
        one = _wave_session(None, f"{d}/one")
        one.run(WAVE_STEPS)
        one_hist = list(one.history)
        del one
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_ranks(_rank_wavefront, 4, "cuda", args=(f"{d}/ranks",))
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for i, r in enumerate(ranks):
        if r["backend"] != "gloo":
            raise AssertionError(f"phase 8d rank {i}: backend {r['backend']}")
        for name in ("clip", "ofasys"):
            e = r[name]
            if not (e["dloss"] <= WAVE_LOSS_TOL and e["dgrad"] <= WAVE_GRAD_TOL):
                raise AssertionError(f"phase 8d (a) {name} rank {i}: engine "
                                     f"vs reference (loss, grad) "
                                     f"{e['dloss']}, {e['dgrad']}")
        if any(r["counts"].values()):
            raise AssertionError(f"phase 8d rank {i}: kernel launches "
                                 f"{r['counts']} on a path without kernels")
        got = r["session"]
        after = got["steps"][WAVE_STRAGGLER_AT + 1:]
        ran_after = sum(s["ran"]["steps"] for s in after)
        if (got["restores"] != [WAVE_STRAGGLER_AT] or got["live"] != [0, 2, 3]
                or (i == 1) != (ran_after == 0)):
            raise AssertionError(f"phase 8d (b) rank {i}: restores "
                                 f"{got['restores']}, live {got['live']}, "
                                 f"steps run after the restore {ran_after}")
        if got["history"] != ranks[0]["session"]["history"]:
            raise AssertionError(f"phase 8d (b): rank {i} history "
                                 f"{got['history']} != rank 0's")
    hist = ranks[0]["session"]["history"]
    diff = _max_diff(hist, one_hist)
    if not diff <= WAVE_HIST_TOL:
        raise AssertionError(f"phase 8d (b): losses {hist} vs one process "
                             f"{one_hist} (max diff {diff})")
    shas = [ranks[i]["session"]["sha"] for i in (0, 2, 3)]
    apart = [k for k in shas[0] if any(h[k] != shas[0][k] for h in shas)]
    if apart:
        raise AssertionError(f"phase 8d (c): {len(apart)} params differ "
                             f"across the live ranks, e.g. {apart[:4]}")
    for name in ("clip", "ofasys"):
        e = ranks[0][name]
        log(f"distributed wavefront (a) {name} (3 tasks, d 512, batch 16, "
            f"fp32; {e['steps']} plan steps in {e['waves']} waves) on 4 "
            f"ranks sharing the card through gloo: engine == reference on "
            f"every rank (loss, grad deltas "
            f"{[(r[name]['dloss'], r[name]['dgrad']) for r in ranks]}); "
            + "; ".join(
                f"rank {i}: loss_and_grads_ms={r[name]['ms']} "
                f"steps_run={r[name]['ran']['steps']} "
                f"waves_run={r[name]['ran']['waves']} "
                f"bytes_sent={r[name]['traffic']} "
                f"peak_mem_bytes={r[name]['peak']}"
                for i, r in enumerate(ranks))
            + f", on {smi}")
    log(f"distributed wavefront (b) clip session, straggler on host 1 after "
        f"step {WAVE_STRAGGLER_AT}: restored step "
        f"{ranks[0]['session']['restores']}, live ranks "
        f"{ranks[0]['session']['live']}; losses {hist} == one process "
        f"{one_hist} (max diff {diff}, limit {WAVE_HIST_TOL}); (c) "
        f"{len(shas[0])} params sha256-equal on ranks 0, 2, 3; "
        + "; ".join(
            f"rank {i}: step_ms={[s['ms'] for s in r['session']['steps']]} "
            f"steps_run={[s['ran']['steps'] for s in r['session']['steps']]} "
            f"waves_run={[s['ran']['waves'] for s in r['session']['steps']]} "
            f"moves_bytes={[s['traffic']['moves'] for s in r['session']['steps']]} "
            f"all_reduce_bytes="
            f"{[s['traffic']['all_reduce'] for s in r['session']['steps']]} "
            f"peak_mem_bytes={r['session']['peak']}"
            for i, r in enumerate(ranks))
        + f"; {secs} s with the spawn, on {smi}")
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--elastic-smoke",
         "--steps", "8", "--straggler-at", "3", "--straggler-hosts", "1",
         "--ranks", "4"], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=600)
    secs = time.perf_counter() - t0
    if (cli.returncode != 0
            or not re.search(r"replan mode=restore", cli.stdout)
            or not re.search(r"loss [0-9.]+ +\(post-restore\)", cli.stdout)):
        raise AssertionError(f"phase 8d (d): the elastic smoke exited "
                             f"{cli.returncode}: {cli.stdout[-2000:]} "
                             f"{cli.stderr[-3000:]}")
    ok = [line for line in cli.stdout.splitlines() if "replan mode=restore"
          in line or "[elastic] OK" in line]
    log(f"distributed wavefront (d) launch.train --elastic-smoke --ranks 4 "
        f"on the card: {ok}; {secs} s, on {smi}")


# phase 8e: the placed steps of launch/steps.py, four ranks sharing the card
PLACED_FULL = dict(arch="qwen3-0.6b", reduced_cfg=False, mesh_shape=(2, 2),
                   batch=8, seq=1024, steps=2, prompt_len=512, gen=8, seed=0)
# each train step's loss of the placed run against one process's on the
# same batches: both bf16 compute; the placed sums run over four ranks in
# another order (the vocab-parallel logsumexp, the row-parallel partial
# products summed by gloo), so they agree to bf16 noise, not bit for bit
PLACED_LOSS_TOL = 1e-2
# the prefill logits (fp32 out of bf16 compute, (8, 151,936)) against one
# process's: sound runs read 0.0703125 on the H100 (the same bits in every
# run); a wrong answer reads far above (the script's two controls:
# the logits with the vocab shards' order swapped, and another data
# group's rows)
PLACED_LOGITS_TOL = 0.25
# the share of greedy tokens equal to one process's: sound runs 102 of 144
# (a random-init qwen3's logits are nearly flat, so bf16 noise flips some
# argmaxes and a row then decodes its own continuation); the controls'
# wrong rows share next to none
PLACED_TOKENS_MIN = 0.5
# phase 8h: 8e's cell with Megatron-SP, in 8e's spawn from 8e's draw; its
# losses are held against 8e's one process's first two steps
PLACED_SP = dict(PLACED_FULL, steps=2, sharding={"seq_parallel": True},
                 serve=False)
# tag: (arch, sharding overrides, run overrides); a "moe" config override
# replaces fields of the reduced MoE config.  The SP runs stop after their
# train steps (SP never runs with a cache)
SP_RUN = ({"seq_parallel": True}, {"serve": False})
PLACED_REDUCED = {
    "qwen3-0.6b": ("qwen3-0.6b", {}, {}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {"grad_accum": 2}, {}),
    "llama3-405b": ("llama3-405b", {}, {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, {}),
    "xlstm-125m": ("xlstm-125m", {}, {}),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, {}),
    "qwen3-0.6b sp": ("qwen3-0.6b", SP_RUN[0], SP_RUN[1]),
    "qwen2-moe-a2.7b sp": ("qwen2-moe-a2.7b",
                           dict(SP_RUN[0], grad_accum=2), SP_RUN[1]),
    "recurrentgemma-9b sp": ("recurrentgemma-9b", SP_RUN[0],
                             dict(SP_RUN[1], cfg_overrides={"n_layers": 4})),
    "qwen2-moe-a2.7b base8": ("qwen2-moe-a2.7b", {"shard_experts": False},
                              {}),
    "qwen2-moe-a2.7b base5 1x4": ("qwen2-moe-a2.7b",
                                  {"shard_experts": False},
                                  {"cfg_overrides": {"moe": {"n_experts": 5}},
                                   "mesh_shape": (1, 4)}),
}
PLACED_REDUCED_RUN = dict(reduced_cfg=True, mesh_shape=(2, 2), batch=8,
                          seq=32, steps=2, prompt_len=64, gen=2, seed=0,
                          keep_params=True, cache_dtype="float32")
# reduced recurrentgemma decodes at positions 100-101 of its circular
# window of 64, split over "model" by positions: the writes wrap onto
# slots 36-37, model rank 1's block
PLACED_REDUCED_AT = {"recurrentgemma-9b": dict(prompt_len=100)}

# phase 8g: the placed steps of the hybrid, ssm and enc-dec families, four
# ranks sharing the card on (data 2, model 2) as in 8e; arch: (config
# overrides, run).  recurrentgemma-9b at full width cut to one (rglru,
# rglru, local_attn) repetition, its prompt of 2,100 past the window of
# 2,048 (the decode writes wrap onto model rank 0's block of positions);
# xlstm-125m whole; seamless-m4t-medium at full width cut to 2 + 2 layers,
# 1,280 tokens and 320 frames a train row and a 1,040-token prompt with 260
# frames (every attention longer than 256: the flash kernel)
PLACED_FAMILIES = {
    "recurrentgemma-9b": ({"n_layers": 3},
                          dict(batch=4, seq=1024, prompt_len=2100, gen=2)),
    "xlstm-125m": (None, dict(batch=4, seq=128, prompt_len=128, gen=4)),
    "seamless-m4t-medium": ({"n_layers": 2, "n_enc_layers": 2},
                            dict(batch=4, seq=1280, prompt_len=1040, gen=3)),
}
PLACED_FAMILY_RUN = dict(reduced_cfg=False, mesh_shape=(2, 2), steps=1,
                         seed=0)
# a rank's launches: {kernel: (a train step, a prefill, of a train step's
# those on inputs reversed in time)}.  recurrentgemma's two rglru layers run
# the scan forward, in remat recompute and reversed in backward; seamless's
# encoder, decoder self and cross attention (2 layers each, no remat: JAX's
# enc-dec has none) run flash forward and the flash backward
PLACED_FAMILY_LAUNCHES = {
    "recurrentgemma-9b": {"rglru_scan": (6, 2, 2)},
    "xlstm-125m": {},
    "seamless-m4t-medium": {"flash_attention": (6, 6, 0),
                            "flash_attention_backward": (6, 0, 0)}}
# the prefill logits' bound, PLACED_LOGITS_TOL unless named here.  xlstm:
# the placed run read 0.27734375 from one process in each of five runs on
# the H100 (the same bits); one process's own bf16 logits lie 0.605 from
# its fp32 run of the same draw (the exponential gates amplify bf16
# rounding); the controls read 3.19 and 3.33 (PERF.md, Findings)
PLACED_FAMILY_LOGITS_TOL = {"xlstm-125m": 0.5}
# the control nearest a real fault: one process's prefill with the first
# two blocks of a "model"-split leaf swapped (as if model rank 0 took its
# features or heads in the wrong order), against the sound prefill; arch:
# (leaf, the split axis, the block's width).  recurrentgemma: two 256-row
# blocks of the first Griffin block's w_out (its features); xlstm: two
# heads of the first mLSTM's query columns; seamless: two 64-column blocks
# of the first decoder layer's FFN up projection.  A query-head swap in
# recurrentgemma's local attention moved its logits by 0.1016 only, under
# the bound (PERF.md, Findings): with one KV head and near-uniform
# attention at random init every head's output is about the mean of V
PLACED_FAULT = {"recurrentgemma-9b": ("decoder.layers.0.mix.w_out", 0, 256),
                "xlstm-125m": ("decoder.layers.0.mix.wq", 1, 192),
                "seamless-m4t-medium": ("dec_blocks.0.ffn.w_up", 1, 64)}


def _placed_ranks(rank: int, kws) -> list:
    """A spawned 8e rank running several placed runs in turn (one spawn
    for the three reduced archs)."""
    from repro_torch.launch.steps import placed_run

    return [placed_run(rank, **kw) for kw in kws]


def _one_process_placed_reference(torch, cfg, kw, weights,
                                  fault=None) -> dict:
    """Phase 8e's and 8g's one-process run on the card: the unplaced
    training-layout model loaded from the placed run's draw ``weights``,
    with the kernels: a prefill of the same prompts (an encoder-decoder's
    with the same frames) with greedy decode steps (the placed run's
    logits and tokens are held against them), then the same train steps
    on the same global batches with the same optimizer (their losses,
    likewise).  With ``fault`` (a ``PLACED_FAULT`` entry), the prefill
    again with that leaf's first two blocks swapped: the logits
    ``logits_fault``, a control."""
    from repro_torch.config import default_sharding
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import (PROMPT_FRAMES, frames_for,
                                          make_optimizer)
    from repro_torch.launch.train import train_step
    from repro_torch.models import build_model

    model = build_model(cfg, default_sharding(cfg, use_kernels=True),
                        device="cuda", train=True)
    opt = make_optimizer(cfg)
    model.load_state(weights)
    params = dict(model.impl.named_parameters())
    state = opt.init(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=kw["seq"],
                                  global_batch=kw["batch"], seed=kw["seed"]))
    g = torch.Generator().manual_seed(kw["seed"])
    prompts = {"tokens": torch.randint(0, cfg.vocab,
                                       (kw["batch"], kw["prompt_len"]),
                                       generator=g).cuda()}
    if cfg.is_encdec:
        prompts["frames"] = frames_for(
            cfg, kw["batch"], kw["prompt_len"] + kw["gen"], kw["seed"],
            PROMPT_FRAMES).cuda()
    with torch.no_grad():
        logits, cache = model.prefill(
            prompts, cache_len=kw["prompt_len"] + kw["gen"])
        tok = logits.argmax(-1)
        first_logits, tokens = logits.float().cpu(), [tok]
        for i in range(kw["gen"]):
            logits, cache = model.decode_step(tok, cache, kw["prompt_len"] + i)
            tok = logits.argmax(-1)
            tokens.append(tok)
        del cache
        out = {"logits": first_logits, "tokens": torch.stack(tokens, 1).cpu()}
        if fault is not None:
            leaf, axis, n = fault
            w = params[leaf] if axis == 0 else params[leaf].t()
            blocks = w[:2 * n].clone()
            w[:n], w[n:2 * n] = blocks[n:], blocks[:n]
            logits, _ = model.prefill(
                prompts, cache_len=kw["prompt_len"] + kw["gen"])
            out["logits_fault"] = logits.float().cpu()
            w[:2 * n] = blocks
    losses = []
    for step in range(kw["steps"]):
        b = data.batch(step)
        if cfg.is_encdec:
            b["frames"] = frames_for(cfg, kw["batch"], kw["seq"], kw["seed"],
                                     step)
        b = {k: v.cuda() for k, v in b.items()}
        state, loss = train_step(model, opt, params, state, b)
        losses.append(float(loss))
    out["losses"] = losses
    del model, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _placed_rows(r, batch: int, ranks: int = 2):
    """The global rows a rank of a (data 2, model 2) mesh holds."""
    per = batch // ranks
    return slice(r["coord"][0] * per, (r["coord"][0] + 1) * per)


def _hold_placed(tag: str, cfg, ranks, one, kw, want,
                 bound: float = PLACED_LOGITS_TOL) -> dict:
    """8e's and 8g's checks of a placed run's ranks against one process's
    run ``one`` on the same batches: every rank's launch counts per part
    ``want``, the same losses on every rank (gloo), each step's loss within
    ``PLACED_LOSS_TOL`` of one process's, the prefill logits within
    ``bound`` with the controls above it (the vocab halves swapped,
    another data group's rows, and where ``one`` holds them, the logits
    of a prefill with two blocks of a split leaf swapped,
    ``logits_fault``), and a share
    of at least ``PLACED_TOKENS_MIN`` of the greedy tokens equal to one
    process's, above the other rows' share.  Returns the readings."""
    hist = ranks[0]["train"]["losses"]
    for i, r in enumerate(ranks):
        if r["backend"] != "gloo":
            raise AssertionError(f"{tag} rank {i}: backend {r['backend']}")
        for part, counts in want.items():
            if r[part]["counts"] != counts:
                raise AssertionError(f"{tag} rank {i} {part}: launch "
                                     f"counts {r[part]['counts']} != "
                                     f"{counts}")
        if r["train"]["losses"] != hist:
            raise AssertionError(f"{tag} rank {i}: losses "
                                 f"{r['train']['losses']} != rank 0's {hist}")
    if not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"{tag}: losses {hist}")
    dloss = max(abs(a - b) for a, b in zip(hist, one["losses"]))
    if not dloss <= PLACED_LOSS_TOL:
        raise AssertionError(f"{tag}: losses {hist} vs one process "
                             f"{one['losses']} (max diff {dloss} > "
                             f"{PLACED_LOSS_TOL})")
    ctl_fault = (float((one["logits_fault"] - one["logits"]).abs().max())
                 if "logits_fault" in one else math.inf)
    half = cfg.vocab // 2  # the vocab shard of model rank 0
    same, total, dlog, ctl_swap, ctl_rows, ctl_same = 0, 0, 0.0, 0.0, 0.0, 0
    for r in ranks:
        rows = _placed_rows(r, kw["batch"])
        other = _placed_rows({"coord": [1 - r["coord"][0]]}, kw["batch"])
        got, ref = r["serve"]["tokens"], one["tokens"][rows]
        if got.shape != ref.shape:
            raise AssertionError(f"{tag}: tokens {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)}")
        same += int((got == ref).sum())
        ctl_same += int((got == one["tokens"][other]).sum())
        total += got.numel()
        lg, ref_lg = r["prefill"]["logits"], one["logits"][rows]
        if tuple(lg.shape) != tuple(ref_lg.shape) or not bool(
                lg.isfinite().all()):
            raise AssertionError(f"{tag}: prefill logits {tuple(lg.shape)}"
                                 f" not finite or not {tuple(ref_lg.shape)}")
        dlog = max(dlog, float((lg - ref_lg).abs().max()))
        swapped = lg.roll(-half, dims=-1)  # [half:] then [:half]
        ctl_swap = max(ctl_swap, float((swapped - ref_lg).abs().max()))
        ctl_rows = max(ctl_rows,
                       float((lg - one["logits"][other]).abs().max()))
    if not dlog <= bound < min(ctl_swap, ctl_rows, ctl_fault):
        raise AssertionError(f"{tag}: prefill logits max |diff| {dlog} vs "
                             f"one process, limit {bound}, controls "
                             f"{ctl_swap} (vocab shards swapped), {ctl_rows}"
                             f" (other rows), {ctl_fault} (two blocks "
                             f"swapped)")
    if not same >= PLACED_TOKENS_MIN * total > ctl_same:
        raise AssertionError(f"{tag}: {same} of {total} greedy tokens "
                             f"equal to one process's (min share "
                             f"{PLACED_TOKENS_MIN}; other rows {ctl_same})")
    return dict(hist=hist, dloss=dloss, dlog=dlog, ctl_swap=ctl_swap,
                ctl_rows=ctl_rows, same=same, total=total,
                ctl_same=ctl_same, ctl_fault=ctl_fault)


def phase_placed(torch, smi: str) -> dict:
    """Phase 8e (see the module docstring).  Returns its flash launch
    records."""
    import tempfile

    from repro_torch.config import get_arch
    from repro_torch.launch.steps import draw_weights
    from repro_torch.parallel.mesh import run_ranks

    cfg = get_arch(PLACED_FULL["arch"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="placed_") as tmp:
        # one host draw: the one process loads it, the ranks read their
        # blocks of it from a file (8e's run, then 8h's, in one spawn)
        weights = draw_weights(cfg, PLACED_FULL["seed"])
        path = f"{tmp}/{cfg.name}.pt"
        torch.save(weights, path)
        one = _one_process_placed_reference(torch, cfg, PLACED_FULL, weights)
        del weights
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs = run_ranks(_placed_ranks, 4, "cuda", args=([
            dict(kw, device="cuda", weights=path)
            for kw in (PLACED_FULL, PLACED_SP)],))
        secs = time.perf_counter() - t0
    ranks, sp_ranks = [r[0] for r in runs], [r[1] for r in runs]
    L, steps = cfg.n_layers, PLACED_FULL["steps"]
    zero = {k: 0 for k in ranks[0]["train"]["counts"]}
    want = {"train": dict(zero, flash_attention=2 * L * steps,
                          flash_attention_backward=L * steps),
            "prefill": dict(zero, flash_attention=L), "serve": zero}
    h = _hold_placed("phase 8e", cfg, ranks, one, PLACED_FULL, want)
    hist, dloss, dlog = h["hist"], h["dloss"], h["dlog"]
    ctl_swap, ctl_rows = h["ctl_swap"], h["ctl_rows"]
    same, total, ctl_same = h["same"], h["total"], h["ctl_same"]
    log(f"placed steps (launch/steps.py) qwen3-0.6b full (28 layers, bf16 "
        f"compute, fp32 masters) on 4 ranks sharing the card through gloo, "
        f"mesh (data 2, model 2): FSDP over data, heads / FFN / vocab over "
        f"model; train 8 x 1,024 (4 x 1,024 a rank, 8 query and 4 KV heads "
        f"a rank), {steps} steps: losses {hist}; one process {one['losses']}"
        f" (max diff {dloss}, limit {PLACED_LOSS_TOL}); flash "
        f"{2 * L} and its backward {L} launches a rank and step, prefill 8 "
        f"x 512 {L} a rank; "
        f"prefill logits max |diff| {dlog} (limit {PLACED_LOGITS_TOL}; "
        f"controls: vocab shards swapped {ctl_swap}, other rows {ctl_rows}); "
        f"{PLACED_FULL['gen']} greedy serve steps: {same} of {total} tokens "
        f"equal to one process's (min share {PLACED_TOKENS_MIN}; other rows "
        f"{ctl_same}); "
        + "; ".join(
            f"rank {i} coord {r['coord']}: train step_ms="
            f"{[t * 1e3 for t in r['train']['step_s']]} peak_mem_bytes="
            f"{r['train']['peak']} collective_bytes_per_step="
            f"{r['train']['traffic_per_step']} prefill_ms="
            f"{r['prefill']['s'] * 1e3} prefill_bytes={r['prefill']['traffic']}"
            f" serve_ms_per_step={r['serve']['s'] * 1e3 / PLACED_FULL['gen']}"
            f" serve_bytes={r['serve']['traffic']}"
            for i, r in enumerate(ranks))
        + f"; host draw, save and one process {one_s} s, the ranks "
        f"(reading their blocks of the draw) {secs} s with the spawn, on "
        f"{smi}")
    sp_launches, sp_backward = _hold_sp(cfg, sp_ranks, ranks, one, zero, smi)
    rec = {"train_launches": sum(r["train"]["counts"]["flash_attention"]
                                 for r in ranks),
           "backward_launches": sum(
               r["train"]["counts"]["flash_attention_backward"]
               for r in ranks),
           "prefill_launches": sum(r["prefill"]["counts"]["flash_attention"]
                                   for r in ranks),
           "per_step": 2 * L, "per_prefill": L, "backward_per_step": L,
           "sp_launches": sp_launches, "sp_backward_launches": sp_backward}
    del one
    gc.collect()
    torch.cuda.empty_cache()
    rec["families"] = phase_placed_families(torch, smi)
    phase_placed_parity(torch, smi)
    phase_dryrun(torch, smi, ranks, rec["families"], sp_ranks)
    return rec


def _hold_sp(cfg, ranks, tp_ranks, one, zero, smi: str) -> int:
    """Phase 8h's checks (see the module docstring) of its ranks against
    8e's one process's first train steps; prints each rank's step ms, peak
    and bytes by kind beside 8e's (``tp_ranks``).  Returns its flash and
    flash backward launches over the four ranks."""
    L, steps = cfg.n_layers, PLACED_SP["steps"]
    want = dict(zero, flash_attention=2 * L * steps,
                flash_attention_backward=L * steps)
    hist = ranks[0]["train"]["losses"]
    for i, r in enumerate(ranks):
        if r["train"]["counts"] != want:
            raise AssertionError(f"phase 8h rank {i}: launch counts "
                                 f"{r['train']['counts']} != {want}")
        if r["train"]["losses"] != hist:
            raise AssertionError(f"phase 8h rank {i}: losses "
                                 f"{r['train']['losses']} != rank 0's {hist}")
    ref = one["losses"][:steps]
    if not all(math.isfinite(x) for x in hist):
        raise AssertionError(f"phase 8h: losses {hist}")
    dloss = max(abs(a - b) for a, b in zip(hist, ref))
    if not dloss <= PLACED_LOSS_TOL:
        raise AssertionError(f"phase 8h: losses {hist} vs one process {ref} "
                             f"(max diff {dloss} > {PLACED_LOSS_TOL})")
    log(f"Megatron-SP placed steps qwen3-0.6b full on 4 ranks sharing the "
        f"card through gloo, mesh (data 2, model 2), 8e's draw: train 8 x "
        f"1,024 with seq_parallel (the residual stream and remat carries "
        f"split along the sequence over model: 4 x 512 a rank), {steps} "
        f"steps: losses {hist}; one process {ref} (max diff {dloss}, limit "
        f"{PLACED_LOSS_TOL}); 8e's {tp_ranks[0]['train']['losses'][:steps]};"
        f" flash {2 * L} and its backward {L} launches a rank and step at "
        f"B4 H8 K4 S1024 (a "
        f"rank's heads over the gathered sequence); "
        + "; ".join(
            f"rank {i} coord {r['coord']}: SP train step_ms="
            f"{[t * 1e3 for t in r['train']['step_s']]} (8e "
            f"{[t * 1e3 for t in e['train']['step_s']]}) peak_mem_bytes="
            f"{r['train']['peak']} (8e {e['train']['peak']}) "
            f"collective_bytes_per_step={r['train']['traffic_per_step']} (8e "
            f"{e['train']['traffic_per_step'][:steps]})"
            for i, (r, e) in enumerate(zip(ranks, tp_ranks)))
        + f"; on {smi}")
    return tuple(sum(r["train"]["counts"][k] for r in ranks)
                 for k in ("flash_attention", "flash_attention_backward"))


def _reduced_run(tag: str) -> dict:
    """``placed_run``'s keywords of a ``PLACED_REDUCED`` entry (its "moe"
    override made a replaced reduced MoE config)."""
    import dataclasses

    from repro_torch.config import get_arch, reduced

    arch, over, run = PLACED_REDUCED[tag]
    run = dict(run)
    cfg_over = dict(run.pop("cfg_overrides", {}))
    if "moe" in cfg_over:
        cfg_over["moe"] = dataclasses.replace(
            reduced(get_arch(arch)).moe, **cfg_over["moe"])
    return dict(PLACED_REDUCED_RUN, arch=arch, sharding=over,
                cfg_overrides=cfg_over or None,
                **PLACED_REDUCED_AT.get(tag, {}), **run)


def phase_placed_parity(torch, smi: str) -> None:
    """Phase 8e's and 8g's reduced fp32 runs: placed qwen3, qwen2-moe (the
    grouped matmul on each rank's 4 local experts), llama3-405b (its one
    KV head split over "model", the decode cache over the sequence),
    recurrentgemma (the scan on each rank's features; decode past its
    window), xlstm and seamless, the Megatron-SP train steps of qwen3,
    qwen2-moe and recurrentgemma, and the paper baseline's MoE (see the
    module doc), four ranks on the card against the same four ranks on
    the CPU: losses, trained local blocks, prefill and serve logits within
    ``TRAIN_PARITY_TOL``, the greedy tokens equal."""
    from repro_torch.parallel.mesh import run_ranks

    kws = [_reduced_run(tag) for tag in PLACED_REDUCED]
    t0 = time.perf_counter()
    # one spawn: each rank runs every arch on the card, then on the CPU
    runs = run_ranks(_placed_ranks, 4, "cuda",
                     args=([dict(kw, device=d) for d in ("cuda", "cpu")
                            for kw in kws],))
    gpus = [r[:len(kws)] for r in runs]
    cpus = [r[len(kws):] for r in runs]
    secs = time.perf_counter() - t0
    for k, tag in enumerate(PLACED_REDUCED):
        arch, kw = kws[k]["arch"], kws[k]
        gpu, cpu = [r[k] for r in gpus], [r[k] for r in cpus]
        worst = 0.0
        for g, c in zip(gpu, cpu):
            if g["coord"] != c["coord"]:
                raise AssertionError(f"phase 8e {tag}: coords differ")
            diffs = [_max_diff(g["train"]["losses"], c["train"]["losses"])]
            diffs += [float((g["train"]["params"][n].float()
                             - c["train"]["params"][n].float()).abs().max())
                      for n in c["train"]["params"]]
            if kw.get("serve", True):  # the SP runs stop after training
                diffs.append(float((g["prefill"]["logits"]
                                    - c["prefill"]["logits"]).abs().max()))
                diffs += [float((a - b).abs().max()) for a, b in
                          zip(g["serve"]["logits"], c["serve"]["logits"])]
                if not torch.equal(g["serve"]["tokens"],
                                   c["serve"]["tokens"]):
                    raise AssertionError(f"phase 8e {tag}: greedy tokens "
                                         f"differ cuda vs cpu")
            worst = max(worst, max(diffs))
        if not worst <= TRAIN_PARITY_TOL:
            raise AssertionError(f"phase 8e {tag}: cuda vs cpu max diff "
                                 f"{worst} > {TRAIN_PARITY_TOL}")
        gmm = [r["train"]["counts"]["grouped_matmul"] for r in gpu]
        if ("moe" in arch) != all(n > 0 for n in gmm):
            raise AssertionError(f"phase 8e {tag}: grouped matmul launches "
                                 f"{gmm}")
        scans = [r["train"]["counts"]["rglru_scan"] for r in gpu]
        if (arch == "recurrentgemma-9b") != all(n > 0 for n in scans):
            raise AssertionError(f"phase 8e {tag}: scan launches {scans}")
        serves = kw.get("serve", True)
        held = ("losses, trained blocks, prefill and serve logits" if serves
                else "losses and trained blocks")
        served = (f"prompt {kw['prompt_len']} + {kw['gen']} decode steps, "
                  f"greedy tokens equal" if serves else "train steps only")
        config = (f", config {kw['cfg_overrides']}" if kw["cfg_overrides"]
                  else "")
        log(f"placed reduced {tag} fp32, fp32 cache (mesh "
            f"{tuple(kw['mesh_shape'])}, {kw['sharding'] or 'defaults'}"
            f"{config}, grad_accum {gpu[0]['train']['grad_accum']}): cuda "
            f"losses {gpu[0]['train']['losses']}, cpu "
            f"{cpu[0]['train']['losses']}; {held} max diff {worst} (tol "
            f"{TRAIN_PARITY_TOL}); grouped matmul launches a rank {gmm}, "
            f"scan {scans}, {served}, on {smi}")
    log(f"placed reduced runs: {secs} s with the spawn")


def phase_placed_families(torch, smi: str) -> dict:
    """Phase 8g (see the module docstring): each of ``PLACED_FAMILIES``
    drawn once on the host, held in one process on the card, then placed
    by the rules on four ranks sharing the card, all three in one spawn
    (each rank reads its blocks of the draw from a file).  Returns per
    arch its config, run and ranks, and its kernel's launches over the
    four ranks."""
    import tempfile

    from repro_torch.launch.steps import draw_weights, placed_config
    from repro_torch.parallel.mesh import run_ranks

    kws, ones, cfgs, host = [], {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="placed_") as tmp:
        for arch, (over, run) in PLACED_FAMILIES.items():
            kw = dict(PLACED_FAMILY_RUN, arch=arch, cfg_overrides=over,
                      **run)
            cfg = cfgs[arch] = placed_config(arch, kw["reduced_cfg"], over)
            t0 = time.perf_counter()
            weights = draw_weights(cfg, kw["seed"])
            path = f"{tmp}/{arch}.pt"
            torch.save(weights, path)
            t1 = time.perf_counter()
            ones[arch] = _one_process_placed_reference(
                torch, cfg, kw, weights, PLACED_FAULT[arch])
            host[arch] = (t1 - t0, time.perf_counter() - t1)
            del weights
            gc.collect()
            torch.cuda.empty_cache()
            kws.append(dict(kw, device="cuda", weights=path))
        t0 = time.perf_counter()
        runs = run_ranks(_placed_ranks, 4, "cuda", args=(kws,))
        secs = time.perf_counter() - t0
    out = {}
    for k, arch in enumerate(PLACED_FAMILIES):
        cfg, kw, ranks = cfgs[arch], kws[k], [r[k] for r in runs]
        kernels = PLACED_FAMILY_LAUNCHES[arch]
        zero = {n: 0 for n in ranks[0]["train"]["counts"]}
        want = {"train": dict(zero), "prefill": dict(zero), "serve": zero}
        for kernel, (per_step, per_prefill, _) in kernels.items():
            want["train"][kernel] = per_step * kw["steps"]
            want["prefill"][kernel] = per_prefill
        per_reverse = kernels.get("rglru_scan", (0, 0, 0))[2]
        h = _hold_placed(f"phase 8g {arch}", cfg, ranks, ones[arch], kw,
                         want, PLACED_FAMILY_LOGITS_TOL.get(
                             arch, PLACED_LOGITS_TOL))
        # each kernel's launches by key (shape, dtype and, for the scan,
        # whether its inputs were reversed), summed over the ranks' train
        # and prefill
        keys = {kernel: {} for kernel in kernels}
        for kernel, by_key in keys.items():
            for r in ranks:
                for p in ("train", "prefill"):
                    for key, n in r[p]["keys"][kernel].items():
                        by_key[key] = by_key.get(key, 0) + n
        reverse = [sum(n for key, n in r["train"]["keys"]["rglru_scan"].items()
                       if key[-1]) for r in ranks]
        if reverse != [per_reverse * kw["steps"]] * len(ranks):
            raise AssertionError(f"phase 8g {arch}: reversed scans a rank "
                                 f"{reverse} != {per_reverse} a step")
        out[arch] = dict(cfg=cfg, kw=kw, ranks=ranks, keys=keys)
        per = {k: v[0] for k, v in kernels.items()}
        log(f"placed steps {arch} full width ({cfg.n_layers} layers"
            f"{f' + {cfg.n_enc_layers} encoder' if cfg.is_encdec else ''}, "
            f"{cfg.compute_dtype} compute, {cfg.param_dtype} params) on 4 "
            f"ranks sharing the card through gloo, mesh (data 2, model 2), "
            f"the whole draw read from one file: train {kw['batch']} x "
            f"{kw['seq']}, {kw['steps']} steps: losses {h['hist']}; one "
            f"process {ones[arch]['losses']} (max diff {h['dloss']}, limit "
            f"{PLACED_LOSS_TOL}); launches a rank and step {per or 'none'} "
            f"({per_reverse} reversed), a prefill "
            f"{ {k: v[1] for k, v in kernels.items()} }; by key over the "
            f"ranks {keys}; "
            f"prefill {kw['batch']} x {kw['prompt_len']} logits max |diff| "
            f"{h['dlog']} (limit {PLACED_FAMILY_LOGITS_TOL.get(arch, PLACED_LOGITS_TOL)}; "
            f"controls: vocab shards swapped {h['ctl_swap']}, other rows "
            f"{h['ctl_rows']}, {PLACED_FAULT[arch][0]}'s first two blocks "
            f"swapped {h['ctl_fault']}); "
            f"{kw['gen']} greedy serve steps: {h['same']} of {h['total']} "
            f"tokens equal to one process's (min share {PLACED_TOKENS_MIN}; "
            f"other rows {h['ctl_same']}); "
            + "; ".join(
                f"rank {i} coord {r['coord']}: train step_ms="
                f"{[t * 1e3 for t in r['train']['step_s']]} peak_mem_bytes="
                f"{r['train'].get('peak')} collective_bytes_per_step="
                f"{r['train']['traffic_per_step']} prefill_ms="
                f"{r['prefill']['s'] * 1e3} prefill_bytes="
                f"{r['prefill']['traffic']} serve_ms_per_step="
                f"{r['serve']['s'] * 1e3 / kw['gen']} serve_bytes="
                f"{r['serve']['traffic']}"
                for i, r in enumerate(ranks))
            + f"; host draw and save {host[arch][0]} s, one process (with "
            f"its faulted prefill) {host[arch][1]} s, on {smi}")
    log(f"placed families: the ranks' spawn of all three {secs} s")
    return out


# phase 8f: 8e's cells dry-run on the host (launch/dryrun.py): full
# qwen3-0.6b as rank 0 of a fake (2, 2) group, shape-only.  8e's ranks
# hold a copy of their initial blocks through the train steps beside what
# the step's trace counts, so the measured peak is held against the dry
# run's peak plus those bytes; their ratio must lie in PLACED_PEAK_RATIO
# (PERF.md states the prediction and its reasons: the caching allocator
# rounds each block up to 512 bytes and may hand out a cached block up to
# 1 MB larger than asked, and cuBLAS's workspace is allocated on the card
# but never traced).  The measured peak is the lowest of the four ranks':
# they run one program on rows of one shape, and one rank's allocator can
# read above the program's peak by buffers held outside it (one of 32
# rank readings did, by 934,598,144 bytes: PERF.md, Findings)
PLACED_PEAK_RATIO = (0.9, 1.1)


def _dryrun_hold(tag: str, cfg, kw, r0) -> tuple:
    """8f's equalities of one placed run's three cells (its train cell
    alone when it stopped there, ``kw["serve"]`` false), under its
    sharding overrides: each traced by the dry run (rank 0 of a fake (2,
    2) group, shape-only on the host) must give rank 0's measured
    collective bytes by kind (each train step, the prefill, each serve
    step), its kernel launches and its argument bytes (params and
    moments, plus this rank's rows of tokens and labels as JAX's int32, an
    encoder-decoder's frames in the compute dtype, and the int32 step
    count).  Returns (the records, the params' and moments' bytes, the
    trace seconds)."""
    from repro_torch.config import ShapeConfig, default_sharding
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.op_analysis import KINDS
    from repro_torch.launch.steps import enc_len

    B, S, steps = (kw[k] for k in ("batch", "seq", "steps"))
    P, G = kw["prompt_len"], kw["gen"]
    t0 = time.perf_counter()
    cells = {"train": ShapeConfig("train", S, B, "train"),
             "prefill": ShapeConfig("prefill", P, B, "prefill"),
             "serve": ShapeConfig("decode", P + G, B, "decode")}
    if not kw.get("serve", True):
        cells = {"train": cells["train"]}
    shcfg = default_sharding(cfg, use_kernels=True, **(kw.get("sharding")
                                                        or {}))
    recs = {part: run_cell(cfg, shp, mesh_shape=(2, 2), verbose=False,
                           shcfg=shcfg)
            for part, shp in cells.items()}
    secs = time.perf_counter() - t0
    for part, rec in recs.items():
        if not rec["ok"]:
            raise AssertionError(f"{tag} {part}: {rec['error']}")

    def kinds(traffic, n=1):
        out = {k: 0.0 for k in recs["train"]["collectives"]}
        for key, v in traffic.items():
            out[KINDS[key]] += v / n
        return out

    # (measured, the number of steps it spans)
    measured = {"train": [(t, 1) for t in r0["train"]["traffic_per_step"]]}
    if "prefill" in recs:
        measured.update(prefill=[(r0["prefill"]["traffic"], 1)],
                        serve=[(r0["serve"]["traffic"], G)])
    runs = {"train": steps, "prefill": 1, "serve": G}
    for part, rec in recs.items():  # the cells of this run
        for traffic, n in measured[part]:
            if kinds(traffic, n) != rec["collectives"]:
                raise AssertionError(
                    f"{tag} {part}: dry-run collective bytes "
                    f"{rec['collectives']} != measured per step "
                    f"{kinds(traffic, n)}")
        want = {k: v * runs[part] for k, v in rec["launches"].items()}
        if want != r0[part]["counts"]:
            raise AssertionError(f"{tag} {part}: dry-run launches "
                                 f"{rec['launches']} x {runs[part]} != "
                                 f"measured {r0[part]['counts']}")
    mem = recs["train"]["memory"]
    rows = 2 * (B // 2) * S * 4 + 4
    if cfg.is_encdec:
        itemsize = 2 if cfg.compute_dtype == "bfloat16" else 4
        rows += (B // 2) * enc_len(S) * cfg.d_model * itemsize
    held = r0["train"]["param_bytes"] + r0["train"]["moment_bytes"]
    if mem["argument_size_in_bytes"] - rows != held:
        raise AssertionError(f"{tag}: dry-run argument bytes "
                             f"{mem['argument_size_in_bytes']} less {rows} "
                             f"(rows, frames, count) != rank 0's params and "
                             f"moments {held}")
    return recs, held, secs


def phase_dryrun(torch, smi: str, ranks: list, families=None,
                 sp_ranks=None) -> None:
    """Phase 8f: 8e's train, prefill and serve cells traced by the dry run
    must give rank 0's measured collective bytes by kind, its kernel
    launches and its argument bytes exactly, and the ranks' train peak
    within :data:`PLACED_PEAK_RATIO`; 8h's train cell (``sp_ranks``) and
    8g's cells (``families``, phase 8g's records) rank 0's bytes by kind,
    launches and argument bytes."""
    from repro_torch.config import get_arch

    r0 = ranks[0]
    cfg = get_arch(PLACED_FULL["arch"])
    recs, held, secs = _dryrun_hold("phase 8f", cfg, PLACED_FULL, r0)
    B, S = PLACED_FULL["batch"], PLACED_FULL["seq"]
    mem = recs["train"]["memory"]
    rows = 2 * (B // 2) * S * 4 + 4
    predicted = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                 + r0["train"]["param_bytes"])
    peaks = [r["train"]["peak"] for r in ranks]
    ratio = min(peaks) / predicted
    lo, hi = PLACED_PEAK_RATIO
    if not lo <= ratio <= hi:
        raise AssertionError(f"phase 8f: measured train peak {min(peaks)} "
                             f"(ranks {peaks}) / predicted {predicted} = "
                             f"{ratio} outside {PLACED_PEAK_RATIO}")
    log(f"dry run of 8e's cells (qwen3-0.6b full, rank 0 of a fake (2, 2) "
        f"group, shape-only on the host, {secs} s): collective bytes by "
        f"kind equal rank 0's measured (train per step "
        f"{recs['train']['collectives']}, prefill "
        f"{recs['prefill']['collectives']}, serve per step "
        f"{recs['serve']['collectives']}); launches equal (train "
        f"{recs['train']['launches']} a step, prefill "
        f"{recs['prefill']['launches']}); argument bytes "
        f"{mem['argument_size_in_bytes']} = rank 0's params and moments "
        f"{held} + rows and count {rows}; train peak measured "
        f"{min(peaks)} bytes (ranks {peaks}, ratios "
        f"{[p / predicted for p in peaks]}) vs predicted {predicted} (dry-run "
        f"peak {mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']} "
        f"+ the initial blocks' copy {r0['train']['param_bytes']}): ratio "
        f"{ratio} (bound {PLACED_PEAK_RATIO}); dry-run flops a step "
        f"{recs['train']['hlo_flops']}, bytes {recs['train']['hlo_bytes']};"
        f" measured on {smi}")
    if sp_ranks is not None:
        recs, held, secs = _dryrun_hold("phase 8f 8h", cfg, PLACED_SP,
                                        sp_ranks[0])
        mem = recs["train"]["memory"]
        peaks = [r["train"]["peak"] for r in sp_ranks]
        predicted = (mem["argument_size_in_bytes"]
                     + mem["temp_size_in_bytes"]
                     + sp_ranks[0]["train"]["param_bytes"])
        log(f"dry run of 8h's train cell (qwen3-0.6b full with "
            f"seq_parallel, rank 0 of a fake (2, 2) group, shape-only on the "
            f"host, {secs} s): collective bytes by kind equal rank 0's "
            f"measured (per step {recs['train']['collectives']}); launches "
            f"equal ({recs['train']['launches']} a step); argument bytes "
            f"{mem['argument_size_in_bytes']} = rank 0's params and moments "
            f"{held} + rows and count; train peak measured (ranks {peaks}, "
            f"ratios {[p / predicted for p in peaks]}) beside the dry run's "
            f"{mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']} "
            f"+ the initial blocks' copy "
            f"{sp_ranks[0]['train']['param_bytes']} = {predicted} (reported,"
            f" not held); dry-run flops a step {recs['train']['hlo_flops']};"
            f" measured on {smi}")
    for arch, fam in (families or {}).items():
        recs, held, secs = _dryrun_hold(f"phase 8f {arch}", fam["cfg"],
                                        fam["kw"], fam["ranks"][0])
        mem = recs["train"]["memory"]
        peaks = [r["train"].get("peak") for r in fam["ranks"]]
        log(f"dry run of 8g's {arch} cells (rank 0 of a fake (2, 2) group, "
            f"shape-only on the host, {secs} s): collective bytes by kind "
            f"equal rank 0's measured (train per step "
            f"{recs['train']['collectives']}, prefill "
            f"{recs['prefill']['collectives']}, serve per step "
            f"{recs['serve']['collectives']}); launches equal (train "
            f"{recs['train']['launches']} a step, prefill "
            f"{recs['prefill']['launches']}); argument bytes "
            f"{mem['argument_size_in_bytes']} = rank 0's params and moments "
            f"{held} + rows, frames and count; train peak measured "
            f"(ranks {peaks}) beside the dry run's "
            f"{mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']} "
            f"+ the initial blocks' copy {fam['ranks'][0]['train']['param_bytes']}"
            f" (reported, not held); dry-run flops a step "
            f"{recs['train']['hlo_flops']}; measured on {smi}")


def phases_mesh(torch, smi: str) -> tuple:
    """Phases 8-8e.  Returns 8a's, 8b's and 8e's launch records."""
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh_nccl(torch, smi)
    ep = phase_ep_full(torch, smi)
    dp = phase_dp_full(torch, smi)
    phase_remesh(torch, smi)
    phase_wavefront_distributed(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    tp = phase_placed(torch, smi)
    return ep, dp, tp


def _tp_family_check(kernel: str, key: tuple) -> tuple:
    """Phase 3's check of an 8g launch key (``ops.launch_keys``), and its
    kernels-line path: the scan's ``SCAN_SHAPES`` case (its reverse's
    check for a reversed scan), flash's ``FLASH_CASES`` case, the flash
    backward's ``FLASH_BWD_CASES`` case."""
    if kernel == "rglru_scan":
        B, S, D, dtn, reverse = key
        for case, shape in SCAN_SHAPES.items():
            if case.startswith("tp") and shape[:3] == (B, S, D):
                if reverse:
                    return (("rglru_scan_backward", dtn, case),
                            f"tp_hybrid{case[2:]}_reverse")
                return ("rglru_scan", dtn, case), f"tp_hybrid{case[2:]}"
    else:
        backward = kernel == "flash_attention_backward"
        cases = FLASH_BWD_CASES if backward else FLASH_CASES
        for case, spec in cases.items():
            if case.startswith("tp_") and spec[:7] == key[:7]:
                return (("flash_backward" if backward else "flash_attention",
                         key[7], case), f"tp_encdec{case[2:]}")
    raise AssertionError(f"phase 8g: {kernel} ran at {key}, which phase 3 "
                         f"does not check")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels", "placed"), default=None,
                    help="run the build and kernel checks only (and with "
                         "'placed', phases 8e-8h after them)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("[smoke] FAILED: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[smoke] FAILED: the port's sources are not beside the "
              f"script ({ROOT / 'src' / 'repro_torch'} is missing)",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import paged_attention as paged

    # fp32 products in full fp32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"gpu: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = build.build_all(ops.KERNELS.values())
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per kernel {secs})")
    for k in ops.KERNELS.values():
        for fn, line in ptxas_lines(k.ptxas_log):
            log(f"ptxas {k.name} {fn}: {line}")

    checks = phase_kernels(torch, ops, ref, gmm, paged)
    counts = {name: 0 for name in ops.KERNELS}
    tp_rec = None
    if args.only == "placed":
        tp_rec = phase_placed(torch, smi)
    if args.only is None:
        from repro_torch.config import get_arch
        from repro_torch.launch.serve import serve

        phase_spec(torch, smi)
        phase_planner(torch, ops, smi)

        _, qwen3_tokens = phase_serve_full(torch, ops, serve, get_arch, smi,
                                           "qwen3-0.6b")
        # full qwen2-moe-a2.7b is drawn once (15.1 B values on the host:
        # most of a serve phase's time) and served by 4b and 4e
        t0 = time.perf_counter()
        moe_model = built_model(torch, get_arch("qwen2-moe-a2.7b"))
        log(f"qwen2-moe-a2.7b full built for 4b and 4e in "
            f"{time.perf_counter() - t0} s")
        moe, _ = phase_serve_full(torch, ops, serve, get_arch, smi,
                                  "qwen2-moe-a2.7b", model=moe_model)
        phase_moe_chunked(torch, ops, serve, get_arch, smi, moe_model)
        del moe_model
        hybrid, _ = phase_serve_full(torch, ops, serve, get_arch, smi,
                                     "recurrentgemma-9b")
        counts.update({name: moe[name] for name in
                       ("paged_attention", "flash_attention",
                        "grouped_matmul")})
        counts["rglru_scan"] = hybrid["rglru_scan"]
        phase_chunked_full(torch, ops, serve, get_arch, smi)
        encdec, _ = phase_serve_full(torch, ops, serve, get_arch, smi,
                                     "seamless-m4t-medium")
        phase_serve_full(torch, ops, serve, get_arch, smi, "pixtral-12b")
        phase_serve_full(torch, ops, serve, get_arch, smi, "glm4-9b")
        gc.collect()
        torch.cuda.empty_cache()
        phase_xlstm_serve(torch, ops, serve, get_arch, smi)
        slab = phase_slab_qwen3(torch, ops, serve, get_arch, smi,
                                qwen3_tokens)
        gc.collect()
        torch.cuda.empty_cache()
        for arch in ("qwen3-0.6b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
                     "seamless-m4t-medium", "pixtral-12b"):
            phase_cpu_parity(torch, serve, arch)
        phase_cpu_parity(torch, serve, "qwen3-0.6b", "slab")
        phase_cpu_parity(torch, serve, "xlstm-125m", "paged")
        phase_cpu_parity(torch, serve, "xlstm-125m", "slab")
        phase_chunk_parity(torch, "qwen3-0.6b")
        phase_chunk_parity(torch, "qwen2-moe-a2.7b")

        from repro_torch.launch.train import train

        trained = phase_train_full(torch, ops, train, get_arch, smi)
        counts["flash_attention_backward"] = trained["counts"][
            "flash_attention_backward"]
        phase_train_parity(torch, train)
        phase_wavefront(torch, smi)
        phase_modal_train_parity(torch, ops)
        gc.collect()
        torch.cuda.empty_cache()
        moe_train = phase_train_cut(torch, ops, smi, "qwen2-moe-a2.7b")
        hybrid_train = phase_train_cut(torch, ops, smi, "recurrentgemma-9b")
        phase_moe_hybrid_train_parity(torch, ops, train)
        phase_xlstm_train(torch, ops, train, smi)
        phase_ckpt_resume(torch, ops, train, smi)
        phase_crash(torch, ops, smi)
        fleet_paged = phases_fleet(torch, ops, smi)
        ep_rec, dp_rec, tp_rec = phases_mesh(torch, smi)

    # one row per kernel: attention and the grouped matmul at qwen2-moe's
    # bf16 shapes (the grouped matmul at its decode shape, where most of
    # its launches are) with the launches of 4b; the scan at
    # recurrentgemma's fp32 prefill shape (the gates are fp32) with 4c's
    # and the flash backward at phase 6's training shape with phase 6's
    # launches
    keys = {"paged_attention": ("paged_attention", "bfloat16", "ragged", 16),
            "flash_attention": ("flash_attention", "bfloat16", "moe"),
            "flash_attention_backward": ("flash_backward", "bfloat16",
                                         "train"),
            "grouped_matmul": ("grouped_matmul", "bfloat16", "decode"),
            "rglru_scan": ("rglru_scan", "float32", "prefill")}
    rows = []

    def row(name, r, launches, **extra):
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **extra,
        })

    for name, key in keys.items():
        row(name, checks[key], counts[name])
    if args.only is None:
        # flash at phase 6's training shape, with its launches in that run
        row("flash_attention",
            checks[("flash_attention", "bfloat16", "train")],
            trained["counts"]["flash_attention"], path="train",
            launches_per_step=2 * get_arch("qwen3-0.6b").n_layers)
        # flash at seamless's cross-attention shape, with phase 4f's
        # launches (encoder, self- and cross-attention)
        row("flash_attention",
            checks[("flash_attention", "bfloat16", "cross")],
            encdec["flash_attention"], path="encdec")
        # flash at qwen3's prefill shape with phase 4j's slab launches
        row("flash_attention",
            checks[("flash_attention", "bfloat16", "qwen3")],
            slab["flash_attention"], path="slab")
        # the grouped matmul's dx and the scan's reverse scan at phases 6e
        # and 6f's shapes, with those phases' launches (forward, recompute
        # and backward together)
        row("grouped_matmul",
            checks[("grouped_matmul_backward", "bfloat16", "prefill_gate_up")],
            moe_train["counts"]["grouped_matmul"], path="train_dx",
            launches_per_step=moe_train["per_step"]["grouped_matmul"])
        row("rglru_scan", checks[("rglru_scan_backward", "float32")],
            hybrid_train["counts"]["rglru_scan"], path="train_reverse",
            launches_per_step=hybrid_train["per_step"]["rglru_scan"])
        # the flash backward at 6e's shape (16 KV heads) with 6e's launches
        row("flash_attention_backward",
            checks[("flash_backward", "bfloat16", "moe_train")],
            moe_train["counts"]["flash_attention_backward"], path="train_moe",
            launches_per_step=moe_train["per_step"][
                "flash_attention_backward"])
        # paged decode at the served qwen3 shape with phase 7's launches
        # (the fleet's full-width serve job)
        row("paged_attention",
            checks[("paged_attention", "bfloat16", "served", 8)],
            fleet_paged, path="fleet")
        # the grouped matmul at 8a's local experts (E 32, C 341) and flash
        # at 8b's per-rank batch, with those phases' launches over both
        # ranks
        row("grouped_matmul",
            checks[("grouped_matmul", "bfloat16", "ep_gate_up")],
            ep_rec["launches"], path="ep", ranks=2,
            launches_per_step_per_rank=ep_rec["per_step"])
        row("flash_attention", checks[("flash_attention", "bfloat16", "dp")],
            dp_rec["launches"], path="dp", ranks=2,
            launches_per_step_per_rank=dp_rec["per_step"])
        row("flash_attention_backward",
            checks[("flash_backward", "bfloat16", "dp")],
            dp_rec["backward_launches"], path="dp", ranks=2,
            launches_per_step_per_rank=dp_rec["backward_per_step"])
    if tp_rec is not None:
        # flash on a (data 2, model 2) rank's local heads, with 8e's
        # launches over the four ranks: its train steps and its prefill
        row("flash_attention", checks[("flash_attention", "bfloat16", "tp")],
            tp_rec["train_launches"], path="tp_train", ranks=4,
            launches_per_step_per_rank=tp_rec["per_step"])
        row("flash_attention",
            checks[("flash_attention", "bfloat16", "tp_prefill")],
            tp_rec["prefill_launches"], path="tp_prefill", ranks=4,
            launches_per_prefill_per_rank=tp_rec["per_prefill"])
        # 8h: flash at the same shape (a rank's heads over the sequence its
        # sublayer gathered) with 8h's train launches over the four ranks
        row("flash_attention", checks[("flash_attention", "bfloat16", "tp")],
            tp_rec["sp_launches"], path="sp_train", ranks=4,
            launches_per_step_per_rank=tp_rec["per_step"])
        # the flash backward at the same shape, 8e's and 8h's launches
        for path, n in (("tp_train", tp_rec["backward_launches"]),
                        ("sp_train", tp_rec["sp_backward_launches"])):
            row("flash_attention_backward",
                checks[("flash_backward", "bfloat16", "tp")], n, path=path,
                ranks=4, launches_per_step_per_rank=tp_rec[
                    "backward_per_step"])
        # 8g: the scan on a (data 2, model 2) rank's features of
        # recurrentgemma and flash on a rank's local heads of seamless, one
        # row for each key its launches took (shape, dtype, a reversed
        # scan), with the launches of that key over the four ranks
        for fam in tp_rec["families"].values():
            for kernel, by_key in fam["keys"].items():
                for key, n in sorted(by_key.items()):
                    check, path = _tp_family_check(kernel, key)
                    if check not in checks:
                        raise AssertionError(f"phase 8g: {kernel} ran at "
                                             f"{key}, which phase 3 does not "
                                             f"check")
                    row(kernel, checks[check], n, path=path, ranks=4)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
