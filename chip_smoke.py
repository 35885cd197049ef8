#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Vilamb on one GPU and check it.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with an sm_90a card (H100).
Phases, each of which must pass or the script exits non-zero:

1. device: the nvidia-smi name/power-limit line; a CUDA device is required;
2. build: every kernel under src/repro_torch/csrc compiles (nvcc, sm_90a);
   ptxas's registers, spills and notes for every kernel, the flash
   kernel's dynamic shared memory, and no spilled byte in the flash kernel;
3. kernels: each kernel is bitwise equal to its plain PyTorch version at
   small shapes (partial stripes, L in {128, 1024, 16384}, a block offset,
   zero/one/all-dirty leaves, NaN/Inf/zero/saturated payloads), and K3's
   grouped launch over a due group's mix (64 KiB and 4 KiB blocks, none,
   sparse and all dirty, stripe widths 1, 4 and 16, junk word bits past
   each leaf) against its plain version and one launch a leaf; K1 over a
   window of every shard of a leaf read in place at the leaf's shard
   stride (k in {1, 3, 8}, L in {128, 1024}, the first, a middle and the
   clamped last window);
4. main path: a ProtectedStore on the default, overlapped tick over an
   8 GiB vilamb heap of 4 KiB rows (2,097,152 blocks, 4+1 stripes, T=16,
   deadline 32) plus a 64 MiB sync params leaf, beside a blocking twin fed
   the same writes: attach, init, 64 steps of 4,096 random row writes with
   on_write + tick (due at 16, 32, 48 in both; every fused update of the
   overlapped store on its side stream), a settle after steps 20 and 52
   with the clean blocks' checksums and the clean stripes' parity equal to
   the twin's, flush with every field equal to the twin's, one corrupted
   lane found by scrub, recover_block, a clean rescrub and verify_meta;
   the kernel launch counts of the overlapped store alone (the twin's
   launches are not counted).  Timed, both stores: each due tick's host ms
   without a device sync; the wall time of the steps around each due tick
   (15-18, 31-34, 47-50); a profiler trace of steps 15-18 (the fused
   update's stream and its overlap with the foreground's kernels); one
   more due tick at step 64, synchronised before and after (its update
   included), before the flush;
5. each kernel at the main path's shapes against its plain version, timed,
   then a chunked plain recompute of all checksums and parity, bitwise;
6. the flash-attention kernel against its plain version at small shapes
   (S in {1, 17, 128, 129, 255, 383, 1000}: around the kernel's 128-row
   tiles; hd in {64, 128}, H/KV in {1, 3, 4, 7, 8, 16}, causal and full,
   bf16; and a key length of its own, (Sq, Sk) in {(1, 17), (129, 1000),
   (1000, 129), (4096, 6144)} at H/KV 1 and 7),
   held to |got - want| <= 4e-3 + 1e-2 |want| and a
   relative L2 error ||got - want|| / ||want|| <= 1e-2, with the mean
   |want| printed beside each case's errors;
7. serving: llama3.2-3b at full width and depth (random bf16 weights from
   the seed) through ``Server.generate``: batch 8, 4,096-token prompts, 64
   new tokens, the KV caches under a vilamb store on the overlapped tick
   (T=16, deadline 32, scrub every 16).  Checked: the launch counts of this
   run (flash once per layer of the prefill), tokens identical to runs with
   no store and with a blocking store, a clean scrub,
   one corrupted K-cache lane found by scrub and repaired bitwise, layer 0's
   prefill attention against the plain version at S = 4,096, and a chunked
   plain recompute of every cache checksum and parity row, bitwise;
   Timed: every step of that run and of one with no store, six more
   generate calls in turns (overlapped, none, blocking, then the same in
   reverse) with the ticks' host ms, a
   profiler trace of four decode steps with and without the store, and
   one of decode steps 16-19 (the due tick with its scrub) with the
   overlapped and the blocking store, with the fused update's stream
   overlap.  Then one more ``generate`` (phase 14d) with the caches under
   the same store with the scrub off, the scrub patroller at 64 MiB a tick
   and the health governor at its defaults: tokens identical to no store,
   the last health report HEALTHY, no patrol mismatch; its blocks patrolled
   and wall time;
8. the flash kernel at the prefill's shapes against its plain version,
   timed beside the plain version and torch's scaled_dot_product_attention,
   with its TFLOP/s and share of its bound;
9. training: llama3.2-3b at full width and depth (bf16 params, fp32 Adam
   moments, per-slot remat, random weights and the reference's zipf stream
   from the seed), batch 1 x 4,096 tokens, AdamW(warmup_cosine(1e-3, 10,
   24)), 16 steps through ``Trainer.run`` with params and both moments
   (32 GB) under a vilamb store on the overlapped tick (T=8, deadline 16,
   scrub every 16: due ticks at 8 and 16, a scrub at 16).  Checked: finite
   losses whose last four average below the first; every fused update on
   the store's side stream; the launch counts of this run; untouched
   embedding rows bit-identical in params, m and v, and blocks of only
   untouched rows never marked dirty; after flush every checksum and
   parity row against a chunked plain recompute, a clean scrub, one
   corrupted lane in an m/ and one in a params/ leaf found and rebuilt
   bitwise; three runs of 6 steps (overlapped store, blocking store, no
   store) with bitwise equal losses and final params checksums.  Timed:
   those three runs' step wall times, each due tick's host ms, a profiler
   trace of steps 7-9 (the fused update's device time, stream and overlap,
   the device-busy share), peak memory and the model-FLOP share.  Then,
   untimed, phase 26's counted step (below);
10. recovery: llama3.2-3b at full width with its depth cut to 2 layers
   (each checkpoint writes the whole state, 7.47 GB), phase 9's batch,
   data and store, a CheckpointManager(keep=2) in a temporary directory
   (free space checked first, removed at the end).  16 steps with a
   non-blocking save every 8 (each right after a due tick, ordered after
   its update by the store); a restore_verified of step 8 into a fresh
   trainer and 8 more steps whose losses and final params checksums equal
   the uninterrupted run's bitwise; the corruption demo on the live state
   (flush, a flipped lane, scrub, parity repair in place, a clean
   rescrub); four faulty checkpoints beside the good one (one lane:
   ok_repaired and the repaired leaves equal to the saved ones; two blocks
   of a stripe: unrecoverable, multi_corrupt, fall back; a checksum word:
   meta_checksum, fall back; a byte of state.npz: file_checksum or
   load_failed, fall back); SIGUSR1 and PreemptionHandler.drain (its
   flush_seconds against the store's estimate_flush, PERF.md section 2's
   limit of 2x, reported); the training launcher with --ckpt-dir,
   --ckpt-every, --inject-corruption and then --resume.  Timed: the save's
   file checksum, device-to-host copy and write, the restore's read and
   verify, each restore_verified, the demo's scrub and repair; the peak
   memory and the phase's wall time, with the card's name and power limit.
11. MoE serving: qwen3-moe-235b-a22b at full width (d 4,096, 64 query and
   4 KV heads of 64, 128 experts, top-8, expert width 1,536, vocab 151,936
   padded to 153,600, untied; random bf16 weights from the seed) with its
   depth cut to 12 of 94 layers, which one card holds (30.68 G params, 57.2
   GiB; 14 layers would leave under 8 GiB for the KV caches and the
   prefill), through ``Server.generate`` with phase 7's traffic and store
   (batch 8, 4,096-token prompts, 64 new tokens, the KV caches under
   vilamb T=16, deadline 32, scrub every 16).  Checked: the launch counts
   (flash once a layer), tokens identical with the overlapped store, the
   blocking store and no store, a clean scrub, one corrupted K-cache lane
   found and repaired, a chunked plain recompute of every cache checksum
   and parity row, and layer 0's attention (hd 64, 16 query heads a KV
   head) against its plain version.  Timed: prefill and decode, a traced
   decode (device ms and launches a token), flash at this prefill's shape
   beside its plain version and scaled_dot_product_attention, the peak;
12. MoE training: qwen3-moe-235b-a22b at full width with its depth cut to 2
   layers (6.16 G params; bf16 params and bf16 Adam moments, 37 GB, under
   vilamb T=8, deadline 16, scrub every 16: 9.2 GB of parity; three layers
   would need ~88 GB), phase 9's batch of 1 x 4,096, data and schedule
   (AdamW(warmup_cosine(1e-3, 10, 24))): 8 steps each with the overlapped,
   the blocking and no store, losses bitwise equal, and each step's share
   of expert slabs routed to (recorded: with random weights and the zipf
   stream, 30-50% of the slabs at 4,096 tokens).  Then one step of 1 x 16
   tokens after
   the due update is adopted: every slab no token was routed to keeps its
   params, m and v bit for bit, its blocks are never marked dirty, and the
   update that follows (the flush, K3 over the dirty stripes) processes
   exactly the routed slabs' stripes, the embedding rows' and the
   ALL-dirty leaves'; a scrub is clean.  Timed: the median step, the due
   ticks' host ms, a trace of steps 7-8 (the fused update's device time),
   the peak;
13. faults: the port's fault battery (``repro_torch.faults``) on phase 4's
   heap (8 GiB of 4 KiB rows beside the 64 MiB sync leaf, T=16, deadline
   32, the overlapped tick, 4,096 random row writes a step).  At the due
   tick of step 16, with its update held in flight behind a spin on the
   side stream (checked unresolved at injection): 64 clean-block faults
   from ``plan_clean_blocks`` (data bit flips and stale redundancy) and 16
   data bit flips on window blocks, one a stripe; a checksum and a meta
   flip on the live view caught by verify_meta; after ``settle`` the
   oracle (every outside-window fault detected, no false positive, no
   miss, the in-window ones classified so), every detected block rebuilt
   bitwise, a clean rescrub, and the stripe whose parity was flipped in a
   copy mid-flight rebuilt bitwise.  Settled after step 20: the same with
   a fresh plan, where a detected block whose stripe holds a window block
   must be refused as a stale stripe (and the rescrub flag exactly
   those); a checksum and a meta flip caught by verify_meta, a parity flip
   under which a repair fails the rescrub, a torn write across a stripe
   boundary flagged whole.  Then measure_detection_latency over 64 steps
   (scrub every 16; a fault on a never-written block and one on a block
   written that step, at steps 3, 10, 17, 33, 40, 58): the clean ones found
   at the next scrub, the in-window ones never; mttdl_measured beside the
   closed forms.  Then the crash-point sweep on that geometry **cut to 256
   MiB** plus a 16 MiB bf16 leaf (each replay saves and restores the whole
   state) with the reference smoke's schedule (period 2, deadline 3, a
   scrub at 5, held in flight at 3-4, 6 steps): every required phase
   fires, every outcome recovered bitwise or lost within the window with
   a clean scrub after flush, and the two crash-plus-corruption cases;
   checkpoints in a temporary directory (free space checked first,
   removed at the end).  Last, ``python -m repro_torch.faults --smoke`` in
   a process of its own on the card must exit 0 (its five passes, the
   scrub patroller's detection the fourth, the sharded battery on a
   simulated (2, 2, 2) mesh the fifth: its oracle and its seven crash
   points recovered bitwise, and its shard rebuilt bitwise from
   cross-shard parity).  Timed: planning, injection,
   scrub, repair, the step, each replay's drive, save and restore; the
   peak and the phase's wall time;
14. patrol and health, on phase 4's heap (8 GiB of 4 KiB rows beside the
   64 MiB sync leaf, vilamb T=16, deadline 32, the overlapped tick, 4,096
   random row writes a step, no scheduled scrub).  a. The scrub patroller
   at 64 MiB a probe (16,384 blocks, ~137 ticks a sweep) and at 512 MiB
   (~17): after 16 steps and a settle, 8 data bit flips from
   ``plan_clean_blocks`` on stripes the run never writes; ticks until each
   is detected by the patrol alone and rebuilt, and a sweep is done
   (within two sweeps plus 16 ticks): patrol mismatches equal the faults,
   every row bitwise, a clean scrub after flush, coverage 1.0.  Timed: the
   quiet tick's host ms with a probe and without the patroller, the
   repair ticks', K1 on a window against its bound, the latencies in
   ticks and seconds, and ``mttdl_measured`` at phase 13's V beside its
   scrub-every-16 figure.  b. The due update of step 16 held behind a
   spin on the side stream: the quiet tick of step 17 dispatches a probe
   over a window with a corrupted clean block and returns with the update
   still in flight; the next tick lands it and repairs the block (its
   host ms recorded: the repair's stripe check waits for the update); the
   probe's verdicts equal a plain recompute once the update finished.  c. The health governor (``dispatch_timeout_s`` 0.3 s,
   ``backpressure="error"``, ``violation_mode="report"``) beside a
   blocking twin, the update of step 16 held behind three spins: a
   forced resolve inside the margin (rung 2), retries then their
   exhaustion (rung 1), ``BackpressureError`` from ``on_write`` (rung 3),
   a blocking update every tick until HEALTHY again (rung 4), an excursion
   forced on the group's clock reported as a violation; verify_meta clean
   and every field equal to the twin's after flush.  The phase's launch
   counts and phase 14d's are the kernel line's "patrol" path;
15. hybrid serving: jamba-1.5-large-398b at its published widths (d 8,192,
   d_inner 16,384, d_state 16, d_conv 4, dt_rank 512; 64 query and 8 KV
   heads of 128; d_ff 24,576; vocab 65,536, untied; top-2 at capacity
   1.25; random bf16 weights from the seed) with its depth cut to one
   group of 8 layers (Mamba at slots 0-3 and 5-7, attention at 4, MoE at
   the odd slots) and its experts from 16 to 8 (48.27 GiB), through
   ``Server.generate`` with phase 7's traffic and store: the KV cache and
   the 7 Mamba slots' ``h`` and ``conv`` (ALL-dirty every step) under
   vilamb.  Checked: the launch counts (flash once a prefill), tokens and
   caches identical with the overlapped store, the blocking store and no
   store, no scrub mismatch, every field of the settled state equal to the
   blocking twin's, a chunked plain recompute after flush, K3 over the
   ALL-dirty leaves against its plain version, one flipped lane in an
   ``h`` leaf and one in the K cache (a padded copy: the rebuilt tensor is
   adopted as ``Server.generate`` adopts a repair, and the next decode step
   writes it in place) found and rebuilt bitwise, the attention layer's
   prefill against its plain version at S = 4,096.  Timed: prefill (the
   Mamba layers' share by CUDA events), decode, a traced decode and a
   traced due tick, K3 a due tick over the ALL-dirty leaves with its
   bound, flash at this prefill's shape (8 query heads a KV head) beside
   its plain version and SDPA, the peak and the phase's wall time;
16. xlstm serving: xlstm-1.3b at full width and depth (48 layers: 6 groups
   of 7 mLSTM and 1 sLSTM, d 2,048, 4 heads of 512, vocab 50,304, random
   bf16 weights) with phase 7's traffic and store over its recurrent
   caches alone (1.41 GB, every block dirty every token).  Checked as
   phase 15, the flipped lanes in an mLSTM ``C`` and in sLSTM's ``n`` (a
   padded copy).  Timed as phase 15 (prefill split between mLSTM and
   sLSTM), plus ``generate`` once with each store and without (blocking,
   none, overlapped) and the due ticks' host ms;
17. vlm serving: internvl2-1b at full width and depth (24 layers, d 896,
   14 / 2 heads of 64, d_ff 4,864, vocab 151,655 padded to 153,600;
   633,121,664 random bf16 params) with phase 7's traffic and store, its
   256 image patches (standard normals from the seed) in front of each
   4,096-token prompt: ``max_len`` 4,417, the KV caches (0.43 GB, a padded
   copy under the store) under vilamb.  Checked: the launch counts (flash
   once a layer), tokens and caches identical with the overlapped store,
   the blocking store and no store, no scrub mismatch, every field equal
   to the blocking twin's after settle and after a flush of both, a
   chunked plain recompute after flush, one flipped lane in a K cache found
   and rebuilt bitwise, layer 0's attention at S = 4,352 against its plain
   version.  Timed: prefill, decode, a traced decode and a traced due
   tick, the blocking twin's due ticks' host ms, flash at (8, 4,352, 14 /
   2, hd 64, causal) beside its plain version and SDPA, the peak and the
   phase's wall time;
18. enc-dec serving and training: seamless-m4t-medium at full width and
   depth (12 encoder and 12 decoder layers, d 1,024, 16 heads of 64, d_ff
   4,096, layernorm and gelu, vocab 256,206 padded to 258,048; 880,930,816
   random bf16 params).  Served as phase 17, the encoder reading 6,144
   frames beside the 4,096-token prompt, so every cross attention runs the
   flash kernel at Sk != Sq; the store covers the self caches (1.64 GB)
   and the cross caches ``ck``/``cv`` (2.42 GB), which no decode step
   marks dirty.  Checked as phase 17 (flash three times a layer), plus:
   every K3 job over a cross cache has no dirty word, one flipped lane in
   a ``ck`` leaf found by the scrub and rebuilt bitwise, the encoder's and
   the cross attention's layer 0 against their plain versions.  Timed as
   phase 17, plus the encoder's share of the prefill (CUDA events), K1
   over a ``ck`` leaf (what ``init`` launches for it) against its bound,
   and flash at the encoder's (8, 6,144, full), the decoder's (8, 4,096,
   causal) and the cross attention's (8, 4,096 x 6,144, full) shapes
   beside their plain versions and SDPA.  Then 4 training steps at batch
   1 x 4,096 (2,048 frames and 2,048 tokens, the reference's split) under
   phase 9's store and determinism settings, a flush and a clean scrub,
   and the same steps with the blocking and no store: losses and final
   params checksums bitwise equal; the median step and the peak;
19. xLSTM training: xlstm-1.3b at full width with its depth cut to 16 of
   its 48 layers (2 groups: 14 mLSTM and 2 sLSTM, 545,591,360 random bf16
   params; the script's time limit) through ``Trainer.run`` with
   phase 9's batch, data, schedule, store and determinism settings, each
   chunk of the scans checkpointed inside each slot's checkpoint: 8 steps
   under the overlapped store (the due tick at 8, traced), a flush and a
   clean scrub, a chunked plain recompute of every checksum and parity
   row, one flipped lane in an sLSTM params leaf and one in an mLSTM m/
   leaf found and rebuilt bitwise; K1, K2 and K3 launched, flash never.
   Then the blocking and no store: losses and params checksums bitwise
   equal to the overlapped run's, over 2 steps (the script's time limit).
   Timed: the median step, the due tick's host ms, K3 in the
   due tick against its bound, the trace of step 8 (device-busy share,
   launches, top kernels), one sLSTM and one mLSTM slot's forward and
   backward alone in turns (each kind's share of the mixers' time), the
   peak and the model-FLOP share;
20. hybrid training: jamba's Mamba mixer at full width (slot 0 of phase
   15's config: d 8,192, d_inner 16,384, dt_rank 512, random bf16 weights)
   on x (1, 4,096, 8,192) bf16 with a fixed random cotangent, forward and
   backward with the per-chunk checkpoint, without, and with again: every
   gradient finite and bitwise equal, each run's ms and peak (the
   unchecked run's 35 GiB fits the card); then jamba's smoke
   config (16 layers of d 64, 4 experts: Mamba, attention and MoE slots)
   trained 8 steps through ``Trainer.run`` with the overlapped store (the
   due tick at 8, a flush and a clean scrub), the blocking and no store:
   losses and params checksums bitwise equal;
21. the sharded heap: phase 4's store on a simulated (2, 2, 2) mesh (every
   shard on this card): the 8 GiB heap under P(("pod", "data", "model"),
   None), 8 shards of 262,144 blocks, the 64 MiB sync leaf under
   P(("pod", "data"), None), 4 shards replicated over "model"; 64 steps of
   4,096 random row writes on the overlapped tick beside a blocking twin
   on the same mesh.  Checked: init is one K1 and one K2 launch a leaf for
   all its shards, each due group one K3 launch (one job a shard), every
   field equal to the twin's after flush, each shard's fields equal to a
   machine-local store's over that shard's rows, a lane corrupted on shard
   5 found by scrub at its global block id and rebuilt bitwise by repair, a
   meta flip on shard 5 tripping verify_meta for the heap only, and the
   sharded oracle (64 clean-block faults across shards, every one found,
   no false positive).  Timed: K1 and K2 with the shard axis beside the
   one-leaf launches over the same 8 GiB, K3 in the sharded due tick,
   against their bounds; the due ticks' host ms, overlapped and blocking;
22. sharded serving: phase 7's llama3.2-3b and traffic with the KV caches
   (3.82 GB) under a store on the simulated (2, 2, 2) mesh with the specs
   of ``cache_specs`` (8 shards a leaf: batch over pod x data, KV heads
   over model; the shards are strided, so the engine stages each leaf into
   one (8, *local) copy for the kernels).  Checked: tokens identical to
   phase 7's (which equal no store's), clean scrubs, each due tick one K3
   launch over every shard of both cache leaves, after the settle each
   shard's clean checksums and stripes (after a flush, every field) equal
   to a machine-local store's over that shard's cache, after the flush K1
   and K2 over the staged (8, n_blocks, L) lanes against a chunked plain
   recompute and against the store's checksums and parity, bitwise, a
   corrupted K-cache lane found by scrub at its global block id, and
   repair on that leaf raising the reference's ValueError.  Timed:
   generate's wall time (the counted overlapped run, then blocking and
   overlapped in turns, beside phase 7's runs with no store), the due
   ticks' host ms, one due tick's update alone (traced), K3 over its 16
   shard jobs (device ms between CUDA events) against its bound, and the
   staging copies of both leaves.  23b. Then one more ``generate`` with the
   caches under that sharded store with the scrub patroller at 64 MiB a
   shard a probe and the scheduled scrub off (no cross-shard parity: the
   caches are not dim0-sharded; each probe stages its window of every
   shard alone): tokens identical to phase 7's, no patrol mismatch, every
   staged window at most 8 x 1,024 blocks; its wall time and a window's
   staging copy timed;
23. the sharded heap under the patroller: phase 21's store (the heap in 8
   row-range shards, the sync leaf in 4, T=16, deadline 32, the overlapped
   tick) with the scrub patroller at 64 MiB a shard a probe (16,384
   blocks, 16 probes a sweep) and so cross-shard parity (xpar) over the
   heap.  16 steps of phase 21's writes and a flush; quiet ticks until
   xpar covers the heap (two sweeps plus 16 ticks), xpar then equal to a
   fresh fold of the shards, and one quiet tick behind a 0.25 s spin on
   the foreground stream returning with the spin still running (no host
   wait); 64 rows of shard 5 written and left pending, shard 5 lost
   (``shard_loss``) and declared; ticks with 256 fresh rows of shard 5
   written each until the rebuild is done: 4 ticks, rebuilt + fresh + lost
   = 262,144, the lost blocks exactly the pending rows (``shard_loss``
   records at their global ids), after a flush a clean scrub and
   verify_meta, shard 5 outside the lost rows and the other 7 shards
   bitwise equal to the heap before the loss with the fresh writes; xpar
   covered again, shard 2 lost without a declaration and found by a
   probe, rebuilt bitwise in 4 ticks, a declaration of shard 6 meanwhile
   refused (``ShardLossConflictError``).  Timed: xpar's fold, a probe (K1
   over 8 x 16,384 blocks at the shard stride and the slab's fold), K1 on
   one shard's window, the quiet ticks' host ms and the write sample's
   share, the reconstruction image, each rebuild tick's host ms and device
   ms (CUDA events), the peak.  Its launches and 23b's are the kernel
   line's "sharded patrol" path.  23c. Degraded reads, right after the
   first tick of shard 5's rebuild: ``read_verified`` of 64 blocks of
   shard 5 no write touched since the loss (half pasted, half still
   scribbled and rebuilt from the rebuild's image), of 16 rows in flight
   at the loss (``UnrecoverableReadError``, ``read_timeout`` records at
   their global ids, 2 attempts, no sleep), of 64 rows written since the
   loss, and of a block of shard 2 with a flipped lane (rebuilt from its
   stripe): every row bitwise the heap's; the 64-block read timed on the
   host clock.  After 23b's ``generate``, ``Server.read_verified`` of 8
   K-cache blocks, one a shard, equal to the cache.  At the end, phase
   23's store (it has the sync leaf) refuses a remesh
   (``RemeshGeometryError``);
24. elastic remesh: phase 21's heap (8 row-range shards of 262,144
   blocks) in a store of its own with no sync leaf (vilamb, T=16, deadline
   32, the overlapped tick, the patroller at 64 MiB a shard, phase 14c's
   health governor); xpar covers the heap, then a second remesh while one
   is queued is refused (``RemeshInProgressError``).  Grown (2, 2, 2) ->
   (2, 2, 4) at 64 MiB a shard a window (16 shards of 131,072 blocks: 8
   window ticks) with 4,096 random rows written each step: at adoption
   ``geometry_version`` 1 and a fresh patroller; after a flush every field
   bitwise a store's attached fresh on (2, 2, 4), a clean scrub and
   verify_meta.  Shrunk -> (1, 2, 2) (4 shards of 524,288 blocks, 32
   windows): the deadline's margin expires mid-migration, the governor
   drains the remaining windows (``remesh_drain``, rung 2) and the
   adoption happens on that tick; after a flush every field bitwise a
   fresh (1, 2, 2) store's.  A flush during a third, short migration
   (back to (2, 2, 2)) drains it.  Timed: each window's K3 (CUDA events)
   against its bound, each window tick's host ms, the adoption ticks' host
   ms with the marks' translation's share, the peak and the wall time.
   Its launches are the kernel line's "remesh" path;
25. the chaos soak (``repro_torch.faults.chaos``): the reference's sharded
   smoke schedule over one fp32 leaf of 1,048,576 x 2,048 (8 GiB, the
   reference's row width) on a simulated (1, 2, 2) mesh (4 row-range
   shards) grown to (2, 2, 2), 4,096 random rows written a step and
   mirrored on the host, the patrol budget scaled from the reference's
   (256 MiB a shard a tick; rebuild and remesh windows 1 GiB), the
   reference's policy otherwise (vilamb, T=2, deadline 6, the overlapped
   tick, its health governor): 8 steps of traffic; 2 bitflips on clean
   blocks, quiet ticks until the patroller repaired both; traffic; a
   straggler storm; a crash (the live leaf and redundancy saved by a
   CheckpointManager in a temporary directory, free space checked first,
   ``restore_verified`` into a fresh store, the leaf equal to the mirror);
   traffic; a flush and quiet ticks until cross-shard parity covers the
   leaf; shard 2 wiped and declared lost, rebuilt under writes; a remesh to
   (2, 2, 2) queued mid-rebuild; traffic; the drain.  Every tick audited
   for a deadline excursion nothing reported, every fifth a
   ``read_verified`` of 2 random blocks against the mirror; blocks the
   rebuild names lost are rewritten from the mirror.  Checked: the soak's
   ``ok()``, every phase run, both bitflips repaired, one crash restore,
   the rebuild and the migration done, reads checked and none stale, no
   silent excursion, a clean final scrub, the leaf bitwise the mirror,
   verify_meta clean and no mark left after the final flush,
   ``geometry_version`` 1 and 8 shards, K1 and K2 over the final leaf's 8
   shards against a chunked plain recompute and the store's checksums and
   parity.  Timed: each storm phase's wall time and its ticks' median and
   largest host ms, the crash's save and ``restore_verified``, the rebuild's
   and the remesh's ticks, the peak and the phase's wall time; printed:
   the detection latencies and ``mttdl_live_s``.  Its launches are the
   kernel line's "chaos" path.  (Phase 13 also runs ``python -m
   repro_torch.faults --chaos --smoke`` in a process of its own: the
   reference's 512 KiB leaf, exit 0 and the OK summary.)
26. the dry run against the card (``repro_torch.launch``: the cost
   counter, the meta device, the memory model): (a) phase 7's serving cell
   (the prefill of batch 8 x 4,096 into caches of 4,161 positions; a
   vilamb store's init over them, one decode step at 4,096, a redundancy
   pass) and phase 9's training cell (batch 1 x 4,096: the store's init,
   one step, a redundancy pass) traced on the meta device under the
   counter, in a process of their own started after the build; (b) the
   same parts run once on the card under the counter, untimed, after
   phases 7's and 9's timed work: each part's FLOPs, bytes and per-kernel
   launches and work equal the trace's exactly, and each kernel's counted
   launches equal its wrapper's; (c) the memory model's params, moments,
   caches and redundancy equal the bytes phases 7 and 9 held, its totals
   printed beside their peaks, and ``HBM_BUDGET`` equal to the card's
   ``total_memory``; (d) the training step's roofline beside phase 9's
   median steps, with the counted-FLOP share, and the Algorithm-1 cell's
   bound (``run_redundancy_cell``, one card) beside phase 9's K3; (e)
   arctic-480b cut to 2 layers at phase 11's serving shapes, its itemised
   memory against the budget.  The counted runs' launches are the kernel
   line's "dry run check" path.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record.  All data comes from ``--seed``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# Deterministic cuBLAS for phase 9's train steps (determinism mode), read
# when cuBLAS first runs: set before torch touches the card.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.common import flatten_dict, replace_leaves  # noqa: E402
from repro_torch.configs import get_arch, get_smoke  # noqa: E402
from repro_torch.core import LeafPolicy, ProtectedStore, RedundancyPolicy  # noqa: E402
from repro_torch.core import bits, blocks  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.checksum import ops as ck_ops, ref as ck_ref  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa_ops, ref as fa_ref  # noqa: E402
from repro_torch.kernels.parity import ops as par_ops, ref as par_ref  # noqa: E402
from repro_torch.kernels.redundancy import ops as fu_ops, ref as fu_ref  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.dist import P, cache_specs  # noqa: E402
from repro_torch.launch import cost_analysis as CA, dryrun, memory_model  # noqa: E402
from repro_torch.launch.cost_analysis import bound, due_tick_bound  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.parallel import ParallelCtx  # noqa: E402
from repro_torch.models import Model, ShapeConfig, attention, build_model, layers  # noqa: E402
from repro_torch.models import mamba as mamba_mod, transformer as tfm  # noqa: E402
from repro_torch.models.transformer import slot_kinds  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.serve import Server  # noqa: E402
from repro_torch.serve import make_decode_step, make_prefill  # noqa: E402
from repro_torch.train import (Trainer, TrainState, protected_leaves,  # noqa: E402
                               protected_structs)
from repro_torch.train.train_loop import deterministic  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

# The card's peaks, each kernel's work and the bounds: launch/cost_analysis.py.

N_ROWS, ROW = 2_097_152, 1024           # 8 GiB of fp32, one 4 KiB block per row
STRIPE, PERIOD, DEADLINE = 4, 16, 32
STEPS, ROWS_PER_STEP = 64, 4096
CHUNK_BYTES = 256 << 20                 # data per chunk of the plain full check
DEVICE = "cuda"

# Serving (phase 7): the KV caches of llama3.2-3b, 28 x 4,161 positions x
# 8 x 8 x 128 bf16 each for k and v (3.8 GB), under vilamb.
SERVE_ARCH, SERVE_BATCH, PROMPT, GEN, SCRUB_EVERY = "llama3.2-3b", 8, 4096, 64, 16
# The flash kernel against its plain version: both round p to bf16 the same
# way, so only summation order and the output's bf16 rounding (one ulp:
# 2^-8 relative) separate them.  The relative L2 bound matters where the
# outputs are small (long causal rows average thousands of keys).
FLASH_ATOL, FLASH_RTOL, FLASH_REL_L2 = 4e-3, 1e-2, 1e-2
# Phase 6's (Sq, Sk) cases with a key length of its own: ragged on both
# sides of the 128-row tiles, and phase 18's decoder over its encoder.
FLASH_CROSS_LENGTHS = ((1, 17), (129, 1000), (1000, 129), (4096, 6144))

# Training (phase 9): llama3.2-3b at full size, batch 1 x train_4k's 4,096
# tokens, params and both Adam moments under vilamb (the launcher's T=8).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, OBS_STEPS = "llama3.2-3b", 1, 4096, 24, 8
TRAIN_PERIOD, TRAIN_DEADLINE, TRAIN_SCRUB = 8, 16, 16
TRAIN_TRACE = (7, 9)                    # the due tick at 8 and the step after it
TRAIN_CORRUPT = ("m/stack/slot_0/ffn/wi", "params/stack/slot_0/attn/wq")

# Recovery (phase 10): llama3.2-3b at full width with its depth cut to 2
# layers (each checkpoint writes the whole state: 7.5 GB at depth 2, 40.2 GB
# at 28), phase 9's batch, data and store; a checkpoint every 8 steps.
REC_LAYERS, REC_STEPS, REC_CKPT_EVERY, REC_PREEMPT_AT = 2, 16, 8, 3
REC_LEAF = "params/stack/slot_0/attn/wk"   # the leaf the checkpoint faults corrupt
REC_DISK_CKPTS = 3                          # at most on disk at once (keep=2, +1)

# MoE (phases 11 and 12): qwen3-moe-235b-a22b at full width, depth cut to
# what one card holds (serving 12 of 94 layers, training 2); one layer is
# 2,452,103,168 params, the embedding and the head 1,258,291,200.
MOE_ARCH, MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = "qwen3-moe-235b-a22b", 12, 2
MOE_LAYER_PARAMS, MOE_EMBED_HEAD_PARAMS = 2_452_103_168, 1_258_291_200
MOE_SPARSE_SEQ = 16                      # the sparse step's tokens (x top-8)
MOE_TRACE = (7, 8)                       # the due tick at 8

# Faults (phase 13): phase 4's heap (8 GiB of 4 KiB rows beside the 64 MiB
# sync leaf, T=16, deadline 32) for the oracle, the in-flight checks and the
# detection latency; the crash sweep on that geometry cut to 256 MiB plus a
# 16 MiB bf16 leaf, since each of its ~30 replays saves and restores the
# whole state (about 10 GB a replay at 8 GiB).
FAULT_STEPS, FAULT_DUE, FAULT_CLEAN, FAULT_IN_WINDOW = 20, 16, 64, 16
SIDE_SLEEP_CYCLES = 2_000_000_000       # about 1 s of one SM's clock
LAT_STEPS, LAT_SCRUB, LAT_INJECT = 64, 16, (3, 10, 17, 33, 40, 58)
MTTF_BLOCK_S = 1.0e9                    # benchmarks/mttdl_bench.py's figure
SWEEP_ROWS, SWEEP_BF16_ROWS = 65_536, 4096          # 256 MiB fp32, 16 MiB bf16
SWEEP_WRITE_ROWS, SWEEP_BF16_WRITE_ROWS = 4096, 64
SWEEP_DISK_GB = 15                      # ~31 checkpoints of 0.36 GB, with room

# Patrol and health (phase 14): phase 4's heap again; the patroller at two
# byte budgets (16,384 and 131,072 of its 4 KiB blocks a probe), 8 faults on
# stripes the run never writes; the governor's ladder with the update of
# step 16 held behind GOV_SPINS spins (~1 s each) and a dispatch timeout
# well inside them.
PATROL_BUDGETS = (64 << 20, 512 << 20)
PATROL_FAULTS, PATROL_SETTLE = 8, 16
GOV_TIMEOUT_S, GOV_SPINS, GOV_MAX_STEPS = 0.3, 3, 96

# Recurrent serving (phases 15 and 16), phase 7's traffic and store:
# jamba-1.5-large-398b at its published widths cut to one group of 8 layers
# and 8 of its 16 experts a MoE layer (a group's 64 experts alone are 77.3
# GB; the cut model is 48.27 GiB), and xlstm-1.3b at full width and depth.
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_EXPERTS = "jamba-1.5-large-398b", 8, 8
HYBRID_PARAMS = 25_910_730_752
HYBRID_CORRUPT = ("slot_0/h", "slot_4/k")       # a Mamba state, the K cache
XLSTM_ARCH, XLSTM_PARAMS = "xlstm-1.3b", 1_217_335_488
XLSTM_CORRUPT = ("slot_0/C", "slot_7/n")        # an mLSTM C, sLSTM's padded n

# Phases 17-18, phase 7's traffic and store: internvl2-1b (the vision front
# end: 256 patches in front of the 4,096-token prompt) and
# seamless-m4t-medium (12 encoder and 12 decoder layers; the encoder reads
# ENC_FRAMES frames, a length other than the prompt's, so the cross
# attention runs the flash kernel at Sk != Sq), both at full size; then
# ENCDEC_TRAIN_STEPS training steps of seamless at phase 9's batch.
VLM_ARCH, VLM_PARAMS, VLM_CORRUPT = "internvl2-1b", 633_121_664, ("slot_0/k",)
ENCDEC_ARCH, ENCDEC_PARAMS, ENC_FRAMES = "seamless-m4t-medium", 880_930_816, 6144
ENCDEC_CORRUPT = ("slot_0/k", "slot_0/ck")      # a self and a cross cache
ENCDEC_TRAIN_STEPS = 4

# Phases 19-20, training through the recurrent mixers: xlstm-1.3b at full
# width with phase 9's batch, data, schedule and store, XLSTM_TRAIN_STEPS
# with the overlapped store (the due tick at 8), then XLSTM_SHORT_STEPS
# each with the blocking and with no store; jamba's Mamba mixer at full width (slot
# 0 of hybrid_config()) on (1, MAMBA_SEQ, 8,192) bf16, with and without the
# per-chunk checkpoint; jamba's smoke config trained through Trainer.run.
XLSTM_TRAIN_STEPS, XLSTM_SHORT_STEPS = 8, 2
# Phase 19's depth: 2 of xlstm-1.3b's 6 groups of 8 layers (the script's
# time limit; a full-depth step took 10-16 s of host; 3 groups before phase 26).
XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_PARAMS = 16, 545_591_360
XLSTM_TRAIN_CORRUPT = ("params/stack/slot_7/slstm/wq", "m/stack/slot_0/mlstm/wq")
MAMBA_SEQ = 4096
HYBRID_SMOKE_STEPS, HYBRID_SMOKE_SEQ, HYBRID_SMOKE_BATCH = 8, 256, 2

# K3 before its Hopper redesign (PERF.md, PR 20's final chip run on the
# H100 80GB HBM3 at 700 W), printed beside this run's times: ms.
K3_BEFORE = {"heap": 0.5523, "xlstm all-dirty": 0.8963, "jamba all-dirty": 0.491,
             "train due tick": 12.82, "moe due tick": 14.48}

# Phases 21-22, the sharded store on a simulated (2, 2, 2) mesh, every
# shard on this card: phase 4's heap (8 shards of 262,144 blocks) and sync
# leaf (4 shards, replicated over "model"); phase 7's serving with the
# caches under cache_specs.  The oracle's clean-block faults, and the
# steps of writes after the flush that make its window.
MESH_SHAPE, MESH_AXES = (2, 2, 2), ("pod", "data", "model")
HEAP_SPECS = {"heap": P(("pod", "data", "model"), None), "params": P(("pod", "data"), None)}
SHARD_ORACLE_FAULTS, SHARD_WINDOW_STEPS = 64, 4

# Phase 23c, degraded reads on phase 23's heap after the first tick of
# shard 5's rebuild: READ_BLOCKS clean blocks of shard 5 (half pasted, half
# not yet), READ_PENDING rows in flight at the loss, READ_FRESH rows
# written since, at READ_RETRY_ATTEMPTS attempts with no sleep.  Phase 24:
# phase 21's heap remeshed online, grown to GROW_SHAPE and shrunk to
# SHRINK_SHAPE, at REMESH_BUDGET a shard a window.
READ_RETRY_ATTEMPTS, READ_BLOCKS, READ_PENDING, READ_FRESH = 2, 64, 16, 64
GROW_SHAPE, SHRINK_SHAPE, REMESH_BUDGET = (2, 2, 4), (1, 2, 2), 64 << 20

# Phase 25, the chaos soak (repro_torch.faults.chaos): the reference's
# sharded smoke schedule over one fp32 leaf of CHAOS_ROWS rows of the
# reference's width (2,048 words: 16 blocks of 128 lanes a row; 8 GiB) in 4
# row-range shards grown to 8, the patrol budget scaled with the leaf (256
# MiB a shard a tick; rebuild and remesh windows 1 GiB).  The one cut:
# CHAOS_ROWS_PER_STEP rows written a step (the reference's 3 of 64 rows
# would be 49,152 rows of host-drawn normals a step).  The crash's
# checkpoint is the leaf and its redundancy, 10.8 GB on disk.
CHAOS_ROWS, CHAOS_ROWS_PER_STEP = 1 << 20, 4096
CHAOS_DISK_GB = 16

# Phase 26, the dry run against the card: phase 7's serving cell (one
# prefill of the batch's 4,096-token prompts into caches of max_len, the
# store's init over them, one decode step at position 4,096 and a
# redundancy pass) and phase 9's training cell (the store's init, one step,
# a redundancy pass) traced on the meta device in a process of its own
# while the phases before run; the same steps counted on the card in
# phases 7 and 9 after their timed work.  Then arctic-480b cut to
# ARCTIC_DRY_LAYERS layers at phase 11's serving shapes, on the meta device
# (item 12 starts from its memory line).
ARCTIC_ARCH, ARCTIC_DRY_LAYERS = "arctic-480b", 2
# Phase 9's own run: TRAIN_MAIN_STEPS with the overlapped store (due ticks
# at 8 and 16), then OBS_TRAIN_STEPS each with the overlapped, blocking and
# no store (cut from 24 and 8 to make room for phase 26).
TRAIN_MAIN_STEPS, OBS_TRAIN_STEPS = 16, 6

SPIN_CYCLES = 20_000_000               # about 10 ms of one SM's clock

SPECIALS = [0x7FC00000, 0x7F800000, 0xFF800000, 0x7F800001, 0x00000000, 0xFFFFFFFF]


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def timed(fn):
    """(result, ms) of ``fn`` between CUDA events around a synchronised region."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def per_call_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls after a warm-up.
    Each call's output is dropped before the next, so the caching allocator
    reuses one buffer instead of allocating ``reps`` of them."""
    def run():
        for _ in range(reps):
            fn()
    fn()                                 # warm-up
    _, ms = timed(run)
    return ms / reps


def abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def rand_i32(g, *shape) -> torch.Tensor:
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=g,
                         device=DEVICE)


def specials(nb: int, L: int, offset: int) -> torch.Tensor:
    vals = torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in SPECIALS],
                        dtype=torch.int32, device=DEVICE)
    idx = (torch.arange(nb * L, device=DEVICE) + offset) % len(SPECIALS)
    return vals[idx].reshape(nb, L)


def stripe_mask(bd: torch.Tensor, P: int) -> torch.Tensor:
    ns = -(-bd.shape[0] // P)
    pad = torch.zeros(ns * P, dtype=torch.bool, device=bd.device)
    pad[: bd.shape[0]] = bd
    return pad.view(ns, P).any(dim=1)


def phase_kernels(g) -> dict:
    """Every kernel against its plain version at small shapes, bitwise."""
    err = {"checksum": 0, "parity": 0, "fused_update": 0}
    for nb, L, off, special in [(13, 128, 0, False), (37, 1024, 5, False),
                                (6, 16384, 1000, False), (13, 256, 3, True)]:
        lanes = specials(nb, L, off) if special else rand_i32(g, nb, L)
        got, want = ck_ops.block_checksums(lanes, off), ck_ref.block_checksums(lanes, off)
        check(torch.equal(got, want), f"checksum kernel != plain at {nb}x{L} off={off}")
        err["checksum"] = max(err["checksum"], abs_err(got, want))
    for nb, L, P, special in [(13, 128, 4, False), (37, 1024, 4, False),
                              (6, 16384, 4, False), (10, 128, 5, True), (9, 256, 2, False)]:
        lanes = specials(nb, L, 1) if special else rand_i32(g, nb, L)
        got, want = par_ops.stripe_parity(lanes, P), par_ref.stripe_parity(lanes, P)
        check(torch.equal(got, want), f"parity kernel != plain at {nb}x{L} P={P}")
        err["parity"] = max(err["parity"], abs_err(got, want))
    cases = [("zero dirty", 13, 128, lambda nb: torch.zeros(nb, dtype=torch.bool)),
             ("one dirty", 37, 1024, lambda nb: torch.arange(nb) == 17),
             ("all dirty", 12, 16384, lambda nb: torch.ones(nb, dtype=torch.bool)),
             ("partial last stripe", 38, 1024, lambda nb: torch.arange(nb) >= 36),
             ("random", 41, 128, lambda nb: torch.arange(nb) % 3 == 0),
             ("specials", 12, 256, lambda nb: torch.arange(nb) % 5 == 0)]
    for name, nb, L, mk in cases:
        lanes = specials(nb, L, 2) if name == "specials" else rand_i32(g, nb, L)
        bd = mk(nb).to(DEVICE)
        sd = stripe_mask(bd, STRIPE)
        old_c, old_p = rand_i32(g, nb), rand_i32(g, sd.shape[0], L)
        want = fu_ref.fused_update(lanes, old_c, old_p, bd, sd, STRIPE)
        got = fu_ops.fused_update(lanes, old_c.clone(), old_p.clone(), bd, sd, STRIPE)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"fused_update kernel != plain ({name}, {nb}x{L})")
        err["fused_update"] = max(err["fused_update"], abs_err(got[0], want[0]),
                                  abs_err(got[1], want[1]))
    # Grouped: one launch over a due group's mix (128 blocks of 64 KiB, a
    # 3-stripe leaf, the heap's 4 KiB rows; none, sparse and all dirty) at
    # stripe widths 1, 4 and 16, with every word bit past a leaf's last
    # block set (the kernel must ignore them): bitwise equal to the plain
    # version and to one launch a leaf.  Without the heap's rows the launch
    # has too few stripes to take them whole and splits them into runs of
    # tiles.
    for P, heap_rows in ((1, 4096), (4, 4096), (4, 0), (16, 4096)):
        jobs, plain, singles = [], [], []
        for nb, L, kind in ((128, 16384, "sparse"), (3 * P - (P > 1), 16384, "all"),
                            (heap_rows, 1024, "none"), (heap_rows, 1024, "sparse")):
            if nb == 0:
                continue
            lanes = rand_i32(g, nb, L)
            bd = {"none": torch.zeros(nb, dtype=torch.bool, device=DEVICE),
                  "all": torch.ones(nb, dtype=torch.bool, device=DEVICE),
                  "sparse": torch.rand(nb, generator=g, device=DEVICE) < 0.1}[kind]
            old_c, old_p = rand_i32(g, nb), rand_i32(g, -(-nb // P), L)
            words = bits.pack_mask(bd)
            junk = bits.pack_mask(torch.cat([bd, torch.ones(
                words.shape[0] * 32 - nb, dtype=torch.bool, device=DEVICE)]))
            jobs.append((lanes, old_c.clone(), old_p.clone(), junk))
            plain.append((lanes, old_c, old_p, words))
            singles.append(fu_ops.fused_update(lanes, old_c.clone(), old_p.clone(), bd,
                                               stripe_mask(bd, P), P))
        want = fu_ref.fused_update_many(plain, P)
        got = fu_ops.fused_update_many(jobs, P)
        for i, ((wc, wp), (gc, gp), (sc, sp), job) in enumerate(zip(want, got, singles, jobs)):
            check(gc is job[1] and gp is job[2], f"grouped K3 not in place (P={P}, leaf {i})")
            check(torch.equal(gc, wc) and torch.equal(gp, wp) and torch.equal(sc, wc)
                  and torch.equal(sp, wp), f"grouped K3 != plain or per leaf (P={P}, leaf {i})")
            err["fused_update"] = max(err["fused_update"], abs_err(gc, wc), abs_err(gp, wp))
    kernels_sharded(g, err)
    torch.cuda.synchronize()
    return err


def kernels_sharded(g, err: dict) -> None:
    """Phase 3, the sharded store's launches: K1 and K2 over a leading shard
    axis (k in 1, 3, 8; partial stripes; shards whose last block is partial,
    through their padded copy) in one launch each, K1 over a window of
    every shard at the leaf's shard stride, and K3 over a due group
    of sharded and unsharded leaves (one job a shard, the views of the
    global arrays at the shard's offsets) in one launch, in place: bitwise
    equal to the plain versions and to one launch a shard."""
    for k in (1, 3, 8):
        for nb, L, off, P_ in ((13, 128, 0, 4), (5, 1024, 7, 2), (2, 16384, 1, 4),
                               (3, 256, 0, 5)):
            lanes = rand_i32(g, k, nb, L)
            n = ck_ops.LAUNCHES
            got, want = ck_ops.block_checksums(lanes, off), ck_ref.block_checksums(lanes, off)
            check(ck_ops.LAUNCHES == n + 1 and torch.equal(got, want)
                  and torch.equal(got[-nb:], ck_ops.block_checksums(lanes[-1], off)),
                  f"checksum kernel != plain with {k} shards of {nb}x{L}")
            err["checksum"] = max(err["checksum"], abs_err(got, want))
            n = par_ops.LAUNCHES
            got, want = par_ops.stripe_parity(lanes, P_), par_ref.stripe_parity(lanes, P_)
            ns = -(-nb // P_)
            check(par_ops.LAUNCHES == n + 1 and torch.equal(got, want)
                  and torch.equal(got[-ns:], par_ops.stripe_parity(lanes[-1], P_)),
                  f"parity kernel != plain with {k} shards of {nb}x{L} P={P_}")
            err["parity"] = max(err["parity"], abs_err(got, want))
    # K1 over a patrol window of every row-range shard, read in place at the
    # leaf's shard stride (nb * L lanes from one shard's window to the
    # next): the first, a middle and the clamped last window.
    for k in (1, 3, 8):
        for L in (128, 1024):
            nb, w = 37, 11
            leaf = rand_i32(g, k * nb, L)
            meta = blocks.make_meta(blocks.ShapeDtype((nb, L), torch.int32), L, STRIPE)
            for start in (0, 13, nb - w):
                win = blocks.shard_window_lanes(leaf, meta, (k,), start, w)
                n = ck_ops.LAUNCHES
                got, want = ck_ops.block_checksums(win, start), ck_ref.block_checksums(win, start)
                check(win.data_ptr() == leaf[start].data_ptr() and ck_ops.LAUNCHES == n + 1
                      and torch.equal(got, want),
                      f"checksum kernel != plain over a strided window: {k} shards of "
                      f"{nb}x{L}, blocks {start}..{start + w}")
                err["checksum"] = max(err["checksum"], abs_err(got, want))
    leaf = torch.randn((8 * 5, 300), generator=g, device=DEVICE)
    meta = blocks.make_meta(blocks.ShapeDtype((5, 300), torch.float32), 512, STRIPE)
    lanes = blocks.shard_lanes(leaf, meta, (8, 1))
    check(lanes.shape == (8, meta.n_blocks, 512), "padded shard lanes' shape")
    for got, want in ((ck_ops.block_checksums(lanes), ck_ref.block_checksums(lanes)),
                      (par_ops.stripe_parity(lanes, STRIPE), par_ref.stripe_parity(lanes, STRIPE))):
        check(torch.equal(got, want), "a kernel != plain over padded shard copies")
    # K3: 8 shards of 13 blocks (partial last stripes) of 1,024 lanes, 4
    # shards of 40 blocks of 16,384 lanes, one unsharded leaf; sparse marks.
    jobs, plain, globals_ = [], [], []
    for k, nb, L in ((8, 13, 1024), (4, 40, 16384), (1, 37, 1024)):
        ns, nw = -(-nb // STRIPE), -(-nb // 32)
        lanes = rand_i32(g, k, nb, L)
        bd = torch.rand((k, nb), generator=g, device=DEVICE) < 0.3
        words = bits.pack_rows(bd)
        cks, par = rand_i32(g, k * nb), rand_i32(g, k * ns, L)
        globals_.append((cks, par, cks.clone(), par.clone()))
        for s_ in range(k):
            jobs.append((lanes[s_], cks[s_ * nb:(s_ + 1) * nb], par[s_ * ns:(s_ + 1) * ns],
                         words[s_ * nw:(s_ + 1) * nw]))
            plain.append((lanes[s_], cks[s_ * nb:(s_ + 1) * nb].clone(),
                          par[s_ * ns:(s_ + 1) * ns].clone(), words[s_ * nw:(s_ + 1) * nw]))
    want = fu_ref.fused_update_many(plain, STRIPE)
    n = fu_ops.LAUNCHES
    got = fu_ops.fused_update_many(jobs, STRIPE)
    check(fu_ops.LAUNCHES == n + 1, "K3 took more than one launch for a sharded group")
    for (gc, gp), (wc, wp), job in zip(got, want, jobs):
        check(gc is job[1] and gp is job[2] and torch.equal(gc, wc) and torch.equal(gp, wp),
              "sharded K3 job != plain or not in place")
        err["fused_update"] = max(err["fused_update"], abs_err(gc, wc), abs_err(gp, wp))
    i = 0
    for (cks, par, _, _), k in zip(globals_, (8, 4, 1)):
        check(torch.equal(cks, torch.cat([w[0] for w in want[i:i + k]]))
              and torch.equal(par, torch.cat([w[1] for w in want[i:i + k]])),
              "sharded K3 missed the global arrays")
        i += k


def words_stripes(words: torch.Tensor, nb: int, P: int) -> int:
    """Stripes holding a block marked in the packed ``words`` (a host wait:
    for a check only, off the timed path)."""
    return int(stripe_mask(bits.unpack(words, nb), P).sum())


def record_k3(count_stripes: bool = False):
    """Wrap K3's grouped entry so that every leaf of every call records the
    stream it was made on, its lanes' address, with ``count_stripes`` the
    stripes its words mark, and the call's number (one call a group's
    update, one launch); returns the records ``(stream, lanes address,
    stripes or None, call)`` and a function that puts the entry back."""
    calls: list = []
    launch = fu_ops.fused_update_many
    n_calls = [0]

    def record(jobs, stripe_width=STRIPE, **kw):
        jobs = list(jobs)
        for lanes, _, _, words in jobs:
            calls.append((torch.cuda.current_stream(), lanes.data_ptr(),
                          words_stripes(words, lanes.shape[0], stripe_width)
                          if count_stripes else None, n_calls[0]))
        n_calls[0] += 1
        return launch(jobs, stripe_width, **kw)

    def restore():
        fu_ops.fused_update_many = launch
    fu_ops.fused_update_many = record
    return calls, restore


def heap_policy(async_tick: bool) -> RedundancyPolicy:
    return RedundancyPolicy(
        default=LeafPolicy(mode="vilamb", period_steps=PERIOD,
                           max_vulnerable_steps=DEADLINE),
        rules=(("params*", LeafPolicy(mode="sync")),),
        lanes_per_block=ROW, stripe_data_blocks=STRIPE, async_tick=async_tick)


def stream_overlap(prof) -> dict:
    """From a profiler trace: the streams the fused update's kernel ran on,
    its device time, and the µs of it that overlap kernels on other streams
    (the foreground's), with the trace's kernel count and busy time."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    k3 = [e for e in kernels if "fused_update_kernel" in e.name]
    streams = {e.device_resource_id for e in k3}
    if not k3 or None in streams:
        return {"fused_update_launches": len(k3), "overlap_us": "not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels
                   if e.device_resource_id not in streams)
    merged: list = []
    for s0, s1 in spans:
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s1)
        else:
            merged.append([s0, s1])
    overlap = sum(max(0, min(e.time_range.end, m1) - max(e.time_range.start, m0))
                  for e in k3 for m0, m1 in merged)
    return {"fused_update_launches": len(k3), "fused_update_streams": sorted(streams),
            "foreground_streams": sorted({e.device_resource_id for e in kernels} - streams),
            "fused_update_us": sum(e.time_range.elapsed_us() for e in k3),
            "overlap_us": overlap, "kernels": len(kernels),
            "device_busy_us": sum(e.time_range.elapsed_us() for e in kernels)}


# Phase 4's schedule: the wall time of the steps around each due tick
# (16, 32, 48), synchronised only at both ends of each window; a profiler
# trace of the first window; a settle (then a check against the blocking
# twin) after steps 20 and 52, outside the windows.
WINDOWS = ((15, 18), (31, 34), (47, 50))
TRACE_STEPS = WINDOWS[0]
SEGMENTS = ((0, 20), (21, 52), (53, STEPS - 1))


def heap_steps(store, state, red, plan, steps, rec, k3_streams):
    """Steps of the heap workload on one store: each writes 4,096 rows,
    scales the params, records the writes and ticks.  Records every due
    tick's host ms (no device sync), each window's wall ms, the trace's
    stream overlap, and the stream of every fused-update launch
    (``k3_streams``)."""
    from torch.profiler import ProfilerActivity, profile
    heap, params = state["heap"], state["params"]
    prof = None
    for step in steps:
        if step == TRACE_STEPS[0]:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        if any(step == w[0] for w in WINDOWS):
            torch.cuda.synchronize()
            w0 = time.perf_counter()
        rows, vals = plan[step]
        # Writes that never block the host (``heap[rows] = vals`` and
        # ``ev[rows] = True`` wait for the stream's earlier work).
        heap.index_copy_(0, rows, vals)
        old_params = params.clone()
        params.mul_(0.999)
        ev = torch.zeros(N_ROWS, dtype=torch.bool, device=heap.device)
        ev.index_fill_(0, rows, True)
        red = store.on_write(red, events={"heap": ev}, old={"params": old_params},
                             new={"params": params})
        n = len(k3_streams)
        t = time.perf_counter()
        red, report = store.tick(state, red, step)
        host_ms = (time.perf_counter() - t) * 1e3
        if report.updated:
            rec["due_steps"].append(step)
            rec["due_tick_host_ms"].append(host_ms)
        else:
            check(len(k3_streams) == n, f"fused update launched on the quiet tick {step}")
        if any(step == w[1] for w in WINDOWS):
            torch.cuda.synchronize()
            rec["window_ms"].append((time.perf_counter() - w0) * 1e3)
        if step == TRACE_STEPS[1]:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            rec["trace_steps_15_18"] = stream_overlap(prof)
    return red


@contextlib.contextmanager
def uncounted():
    """Launches inside are not the main path's (the blocking twin's): the
    kernels' counts are put back as they were when the block ends."""
    saved = (ck_ops.LAUNCHES, par_ops.LAUNCHES, fu_ops.LAUNCHES, len(K3_CALLS))
    try:
        yield
    finally:
        ck_ops.LAUNCHES, par_ops.LAUNCHES, fu_ops.LAUNCHES = saved[:3]
        del K3_CALLS[saved[3]:]


def compare_clean(store, red, twin: dict, step: int) -> int:
    """After a settle: the clean blocks' checksums and the clean stripes'
    parity equal the blocking twin's bit for bit, and so do the bitmaps."""
    meta = store.metas["heap"]
    a, b = red["heap"], twin["heap"]
    check(torch.equal(a.dirty, b.dirty) and torch.equal(a.shadow, b.shadow),
          f"step {step}: dirty/shadow differ from the blocking twin's")
    live = bits.unpack(a.dirty | a.shadow, meta.n_blocks)
    clean_stripes = ~blocks.stripe_dirty_mask(meta, live)
    check(torch.equal(a.checksums[~live], b.checksums[~live]),
          f"step {step}: clean checksums differ from the blocking twin's")
    check(not bool(((a.parity != b.parity).any(dim=1) & clean_stripes).any()),
          f"step {step}: clean-stripe parity differs from the blocking twin's")
    for name in ("params",):
        for f in ("checksums", "parity", "meta_ck"):
            check(torch.equal(getattr(red[name], f), getattr(twin[name], f)),
                  f"step {step}: {name}.{f} differs from the blocking twin's")
    return int(live.sum())


def phase_main(g) -> dict:
    """The store lifecycle on the 8 GiB heap, on the default overlapped tick
    beside a blocking twin fed the same writes; returns state and timings."""
    dev = torch.device(DEVICE)
    heap = torch.randn((N_ROWS, ROW), generator=g, device=dev)
    params = torch.randn((16384, 1024), generator=g, device=dev)      # 64 MiB
    state = {"heap": heap, "params": params}
    twin_state = {k: v.clone() for k, v in state.items()}
    plan = [(torch.randperm(N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP],
             torch.randn((ROWS_PER_STEP, ROW), generator=g, device=dev))
            for _ in range(STEPS)]
    policy = heap_policy(async_tick=True)
    check(RedundancyPolicy().async_tick and policy.async_tick,
          "the overlapped tick is not the default")
    k3_streams, restore_k3 = record_k3()
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()

    store, init_ms = timed(lambda: ProtectedStore(policy).attach(state))
    red, ms = timed(lambda: store.init(state))
    init_ms += ms
    with uncounted():
        twin = ProtectedStore(heap_policy(async_tick=False)).attach(twin_state)
        twin_red = twin.init(twin_state)
    meta = store.metas["heap"]
    check((meta.n_blocks, meta.n_stripes) == (N_ROWS, N_ROWS // STRIPE),
          f"heap geometry {meta.n_blocks} blocks, {meta.n_stripes} stripes")
    side = store._side_stream()
    check(side is not None and side != torch.cuda.default_stream(),
          "the overlapped store has no side stream of its own")
    rec = {k: {"due_steps": [], "due_tick_host_ms": [], "window_ms": []}
           for k in ("async", "blocking")}
    settled_live = []
    for first, last in SEGMENTS:
        n = len(k3_streams)
        red = heap_steps(store, state, red, plan, range(first, last + 1), rec["async"],
                         k3_streams)
        check(all(c[0] == side for c in k3_streams[n:]),
              "a fused update of the overlapped store ran off its side stream")
        n = len(k3_streams)
        with uncounted():
            twin_red = heap_steps(twin, twin_state, twin_red, plan, range(first, last + 1),
                                  rec["blocking"], k3_streams)
        check(all(c[0] == torch.cuda.current_stream() for c in k3_streams[n:]),
              "a fused update of the blocking store ran off the caller's stream")
        if last < STEPS - 1:
            red = store.settle(red, state, step=last)
            check(all(grp.pending is None for grp in store.groups.values()),
                  f"settle after step {last} left an update in flight")
            settled_live.append(compare_clean(store, red, twin_red, last))
    for kind in rec:
        check(rec[kind]["due_steps"] == [16, 32, 48],
              f"{kind}: due ticks at {rec[kind]['due_steps']}")
    # One more due tick (step 64, over the writes of steps 49-63), timed
    # between device syncs: the overlapped store's includes its update on
    # the side stream, which the sync waits for.
    (red, rep), synced_ms = timed(lambda: store.tick(state, red, STEPS))
    with uncounted():
        (twin_red, twin_rep), twin_synced_ms = timed(
            lambda: twin.tick(twin_state, twin_red, STEPS))
    check(rep.updated and twin_rep.updated, f"step {STEPS} was not a due tick")
    stats = {k: int(v) for k, v in store.dirty_stats(red)["heap"].items()}
    est = store.estimate_flush(red)
    red, flush_ms = timed(lambda: store.flush(state, red, step=STEPS))
    with uncounted():
        twin_red, twin_flush_ms = timed(lambda: twin.flush(twin_state, twin_red, step=STEPS))
    restore_k3()
    check(all(torch.equal(state[k], twin_state[k]) for k in state),
          "the twins' leaves differ")
    for name in red:
        for f in ("checksums", "parity", "dirty", "shadow", "meta_ck"):
            check(torch.equal(getattr(red[name], f), getattr(twin_red[name], f)),
                  f"after flush {name}.{f} differs from the blocking twin's")
    del twin, twin_red, twin_state, plan
    torch.cuda.empty_cache()

    lanes = blocks.to_lanes(heap, meta)
    check(lanes.data_ptr() == heap.data_ptr(), "heap lane view is not a view")
    bad = int(torch.randint(0, N_ROWS, (1,), generator=g, device=dev))
    saved = lanes[bad].clone()
    lanes[bad, 99] ^= 0xBAD
    masks, scrub_ms = timed(lambda: store.scrub(state, red))
    flagged = torch.nonzero(masks["heap"]).flatten().tolist()
    check(flagged == [bad], f"scrub flagged {flagged[:8]}, expected [{bad}]")
    check(int(masks["params"].sum()) == 0, "scrub flagged params blocks")
    (fixed, ok), recover_ms = timed(
        lambda: store.recover_block(heap, red["heap"], "heap", bad))
    check(ok and fixed.data_ptr() == heap.data_ptr(), "recover_block refused or copied")
    check(torch.equal(lanes[bad], saved), "recovered block differs from the original")
    masks, rescrub_ms = timed(lambda: store.scrub(state, red))
    check(sum(int(m.sum()) for m in masks.values()) == 0,
          "scrub after repair still flags blocks")
    check(all(bool(v) for v in store.verify_meta(red).values()), "verify_meta failed")
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for name in ("checksum", "parity"):
        check(launches[name] > 0, f"{name} kernel never launched on the main path")
    # K3: attach's warm-up (an overlapped update and a blocking one of its
    # probe), the due ticks 16, 32, 48 and 64, and the flush: one launch
    # each, the heap group's one leaf each.
    check(launches["fused_update"] == 7 and K3_CALLS == [1] * 7,
          f"K3 launched {launches['fused_update']} times over {K3_CALLS} leaves on the "
          "main path, want 7 over one leaf each")
    return {
        "store": store, "state": state, "red": red, "launches": launches,
        "timings": {
            "init_ms": init_ms, "overlap": rec,
            "synced_due_tick_ms": {"async": synced_ms, "blocking": twin_synced_ms},
            "settled_live_blocks": dict(zip((s[1] for s in SEGMENTS), settled_live)),
            "flush_ms": flush_ms, "flush_ms_blocking": twin_flush_ms,
            "scrub_ms": scrub_ms,
            "rescrub_ms": rescrub_ms, "recover_ms": recover_ms, "peak_mem_gb": peak_gb,
            "flush_dirty_blocks": stats["dirty_blocks"],
            "flush_vulnerable_stripes": stats["vulnerable_stripes"],
            "flush_estimate_ms": est.seconds * 1e3,
            "copy_gb_per_s": store.copy_bytes_per_sec() / 1e9,
        },
    }


def phase_update_profile(g, main: dict) -> None:
    """A due tick's update, warm: time it with CUDA events, then trace the
    same work with torch.profiler for the device time by kernel.  Also time
    a repeat of init (its result is discarded)."""
    store, state = main["store"], main["state"]
    ev = torch.zeros(N_ROWS, dtype=torch.bool, device=DEVICE)
    for _ in range(PERIOD):
        ev[torch.randperm(N_ROWS, generator=g, device=DEVICE)[:ROWS_PER_STEP]] = True
    heap_engine = store.engine_for("heap")

    def mark(red):
        return dict(red, **heap_engine.mark_dirty({"heap": red["heap"]}, {"heap": ev}))

    red, update_ms = timed(lambda: store.flush(state, mark(main["red"])))
    red = mark(red)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        red = store.flush(state, red)
        torch.cuda.synchronize()
    launches = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel: dict = {}
    for e in launches:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    main["red"] = red
    _, init_ms = timed(lambda: store.init(state))
    main["timings"].update({
        "due_update_warm_ms": update_ms, "init_warm_ms": init_ms,
        "due_update_device_busy_ms": (sum(by_kernel.values()) if launches
                                      else "not measured"),
        "due_update_device_launches": len(launches),
        "due_update_top_kernels_ms": dict(sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:8]),
    })


def print_build_log(lib) -> None:
    """ptxas's report of each kernel (registers, spills, notes such as an
    injected wgmma fence) and the flash kernel's dynamic shared memory;
    fails if the flash kernel spills."""
    source, flash_spills = "", []
    for line in _build.build_log().splitlines():
        if line.startswith("=="):
            source = line
        if line.startswith("==") or any(w in line for w in (
                "entry function", "registers", "spill", "C7", "warning")):
            print("  " + line.strip())
        if "flash_attn" in source and "spill stores" in line:
            flash_spills.append(line.strip())
    print("  flash_attn dynamic shared memory: "
          f"{lib.vilamb_flash_smem_bytes(128)} bytes a CTA at hd 128, "
          f"{lib.vilamb_flash_smem_bytes(64)} at hd 64")
    check(flash_spills and all(l.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                            "0 bytes spill loads") for l in flash_spills),
          f"the flash kernel spills: {flash_spills}")


def phase_kernel_times(g, main: dict, err: dict) -> list:
    """Each kernel at the main path's shapes: bitwise against its plain
    version, its time, the plain version's time and the bound."""
    red = main["red"]["heap"]
    meta = main["store"].metas["heap"]
    lanes = blocks.to_lanes(main["state"]["heap"], meta)
    nb, L = lanes.shape
    ns = nb // STRIPE
    rows = []

    got, want = ck_ops.block_checksums(lanes), ck_ref.block_checksums(lanes)
    check(torch.equal(got, want), "checksum kernel != plain on the 8 GiB heap")
    err["checksum"] = max(err["checksum"], abs_err(got, want))
    del got, want
    rows.append(("checksum", "checksum.cu", "checksum/checksum.py:49",
                 per_call_ms(lambda: ck_ops.block_checksums(lanes), 10),
                 per_call_ms(lambda: ck_ref.block_checksums(lanes), 2),
                 *bound(*CA.checksum_work(nb, L))))

    got, want = par_ops.stripe_parity(lanes, STRIPE), par_ref.stripe_parity(lanes, STRIPE)
    check(torch.equal(got, want), "parity kernel != plain on the 8 GiB heap")
    err["parity"] = max(err["parity"], abs_err(got, want))
    del got, want
    rows.append(("parity", "parity.cu", "parity/parity.py:29",
                 per_call_ms(lambda: par_ops.stripe_parity(lanes, STRIPE), 10),
                 per_call_ms(lambda: par_ref.stripe_parity(lanes, STRIPE), 2),
                 *bound(*CA.parity_work(nb, ns, L))))

    # A due tick's queue: 16 steps of 4,096 random rows.
    bd = torch.zeros(nb, dtype=torch.bool, device=DEVICE)
    for _ in range(PERIOD):
        bd[torch.randperm(nb, generator=g, device=DEVICE)[:ROWS_PER_STEP]] = True
    sd = stripe_mask(bd, STRIPE)
    n_dirty, n_stripes = int(bd.sum()), int(sd.sum())
    old_c = red.checksums.clone()
    old_c[bd] ^= 0x5A5A5A5A
    old_p = red.parity.clone()
    old_p[sd] ^= 0x0F0F0F0F
    words = bits.pack_mask(bd)
    job = [(lanes, old_c.clone(), old_p.clone(), words)]
    want = fu_ref.fused_update_many([(lanes, old_c, old_p, words)], STRIPE)[0]
    got = fu_ops.fused_update_many(job, STRIPE)[0]
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "fused_update kernel != plain on the 8 GiB heap")
    err["fused_update"] = max(err["fused_update"], abs_err(got[0], want[0]),
                              abs_err(got[1], want[1]))
    del want
    # A due tick's call: the grouped entry over the heap's packed words.
    fu_ms = per_call_ms(lambda: fu_ops.fused_update_many(job, STRIPE), 20)
    plain_ms = per_call_ms(lambda: fu_ref.fused_update_many(job, STRIPE), 2)
    # The dirty stripes' members (read), their parity rows and the dirty
    # checksums (written), every packed word (read).  PR 20's kernel read
    # the bool masks, the ids and the count instead of the words.
    new_bytes, ops = CA.fused_update_work(n_stripes, STRIPE, L, words.numel(),
                                          checksums=n_dirty)
    old_bytes = (new_bytes - words.numel() * 4) + n_stripes * STRIPE + n_stripes * 4 + 4
    rows.append(("fused_update", "redundancy.cu", "redundancy/redundancy.py:93",
                 fu_ms, plain_ms, *bound(new_bytes, ops)))
    del old_c, old_p, got, job
    main["timings"]["fused_queue"] = {
        "dirty_blocks": n_dirty, "stripes": n_stripes, "ms": fu_ms,
        "bound_ms": bound(new_bytes, ops)[0], "pr20_bound_ms": bound(old_bytes, ops)[0],
        "pr20_ms": K3_BEFORE["heap"]}

    return [{"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
             "replaces": f"src/repro/kernels/{tpu}", "launches": main["launches"][name],
             "max_abs_err": err[name], "ms": ms, "plain_ms": pms, "bound_ms": bms,
             "bound_by": by, "library_ms": None}
            for name, src, tpu, ms, pms, bms, by in rows]


def phase_full_check(store, state: dict, red: dict) -> None:
    """Chunked plain recompute of every checksum and parity row, bitwise."""
    for name, leaf in state.items():
        meta = store.metas[name]
        lanes = blocks.to_lanes(leaf, meta)
        r = red[name]
        chunk = max(1, CHUNK_BYTES // meta.bytes_per_block // STRIPE) * STRIPE
        for s in range(0, meta.n_blocks, chunk):
            e = min(meta.n_blocks, s + chunk)
            check(torch.equal(ck_ref.block_checksums(lanes[s:e], s), r.checksums[s:e]),
                  f"{name}: checksums of blocks {s}..{e} differ from a plain recompute")
            check(torch.equal(par_ref.stripe_parity(lanes[s:e], STRIPE),
                              r.parity[s // STRIPE: -(-e // STRIPE)]),
                  f"{name}: parity of blocks {s}..{e} differs from a plain recompute")
    check(all(bool(v) for v in store.verify_meta(red).values()), "final verify_meta")


def flash_err(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """The kernel's max abs and relative L2 error against its plain
    version, beside the mean |want|; fails outside FLASH_ATOL + FLASH_RTOL
    |want| anywhere, above FLASH_REL_L2, or on a non-finite output."""
    g32, w32 = got.float(), want.float()
    diff = g32 - w32
    e = {"max_abs_err": float(diff.abs().max()),
         "rel_l2_err": float(diff.norm() / w32.norm().clamp_min(1e-30)),
         "mean_abs_want": float(w32.abs().mean())}
    check(bool(torch.isfinite(g32).all())
          and torch.allclose(g32, w32, rtol=FLASH_RTOL, atol=FLASH_ATOL)
          and e["rel_l2_err"] <= FLASH_REL_L2, f"flash kernel != plain ({what}): {e}")
    return e


def phase_flash_small(g) -> list:
    """The flash kernel against its plain version at small shapes, bf16;
    one [S, hd, H/KV, causal, max abs err, rel L2 err, mean |want|] a case,
    S an int (Sq = Sk) or [Sq, Sk] (a key length of its own: cross
    attention over an encoder memory)."""
    cases, KV = [], 2

    def case(Sq, Sk, hd, group, causal):
        q = torch.randn((2, Sq, KV * group, hd), generator=g, device=DEVICE).to(torch.bfloat16)
        k, v = (torch.randn((2, Sk, KV, hd), generator=g, device=DEVICE).to(torch.bfloat16)
                for _ in range(2))
        e = flash_err(fa_ops.flash_attention(q, k, v, causal=causal),
                      fa_ref.attention(q, k, v, causal=causal),
                      f"Sq={Sq} Sk={Sk} hd={hd} H/KV={group} causal={causal}")
        cases.append([Sq if Sq == Sk else [Sq, Sk], hd, group, causal, *e.values()])

    for S in (1, 17, 128, 129, 255, 383, 1000):
        for hd in (64, 128):
            for group in (1, 3, 4, 7, 8, 16):
                for causal in (True, False):
                    case(S, S, hd, group, causal)
    for Sq, Sk in FLASH_CROSS_LENGTHS:
        for hd in (64, 128):
            for group in (1, 7):
                for causal in (True, False):
                    case(Sq, Sk, hd, group, causal)
    torch.cuda.synchronize()
    return cases


def instrument(srv: Server, store=None) -> dict:
    """Time the server's prefill and decode steps and the store's ticks
    (synchronised host clock around each).  Before each tick due by the
    period, the dirty blocks it is about to refresh are counted."""
    rec: dict = {"prefill_ms": [], "decode_ms": [], "ticks": []}

    def wrap(fn, key):
        def inner(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t) * 1e3)
            return out
        return inner

    srv.prefill = wrap(srv.prefill, "prefill_ms")
    srv.decode = wrap(srv.decode, "decode_ms")
    if store is not None:
        tick = store.tick

        def timed_tick(leaves, red, step, **kw):
            dirty = None
            if step % PERIOD == 0:
                dirty = sum(int(v["dirty_blocks"]) for v in store.dirty_stats(red).values())
            torch.cuda.synchronize()
            t = time.perf_counter()
            red, report = tick(leaves, red, step, **kw)
            torch.cuda.synchronize()
            rec["ticks"].append({"step": step, "ms": (time.perf_counter() - t) * 1e3,
                                 "updated": bool(report.updated),
                                 "scrubbed": bool(report.scrubbed),
                                 "dirty_blocks": dirty})
            return red, report
        store.tick = timed_tick
    return rec


# The leaves of each call of K3's grouped entry (one call a group's
# update) since reset_launches(); kept by count_k3_calls().
K3_CALLS: list = []


def count_k3_calls() -> None:
    """Wrap K3's grouped entry (once) so that each call appends its number
    of leaves to K3_CALLS."""
    launch = fu_ops.fused_update_many

    def counted(jobs, *a, **kw):
        jobs = list(jobs)
        K3_CALLS.append(len(jobs))
        return launch(jobs, *a, **kw)
    fu_ops.fused_update_many = counted


def reset_launches() -> None:
    ck_ops.LAUNCHES = par_ops.LAUNCHES = fu_ops.LAUNCHES = fa_ops.LAUNCHES = 0
    K3_CALLS.clear()


def read_launches() -> dict:
    """The kernels' launches since reset_launches(); fails unless K3
    launched exactly once a group update (a group of more than max_jobs
    leaves takes as few launches as fit)."""
    want = sum(-(-n // fu_ops.max_jobs()) for n in K3_CALLS)
    check(fu_ops.LAUNCHES == want,
          f"K3 launched {fu_ops.LAUNCHES} times, want {want}: one a group update "
          f"({len(K3_CALLS)} updates over {sum(K3_CALLS)} leaves)")
    return {"checksum": ck_ops.LAUNCHES, "parity": par_ops.LAUNCHES,
            "fused_update": fu_ops.LAUNCHES, "flash_attn": fa_ops.LAUNCHES,
            "fused_update_leaves": sum(K3_CALLS),
            "fused_update_max_leaves": max(K3_CALLS, default=0)}


def host_timed_ticks(store) -> list:
    """Time each of the store's ticks on the host clock alone (no device
    sync: what the decode loop waits for), and inside it the update's
    dispatch and the scrub (whose mismatch count waits for the foreground
    stream); returns the record list."""
    rec: list = []
    parts = {"dispatch_ms": 0.0, "scrub_ms": 0.0}

    def timed(fn, key):
        def inner(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            parts[key] += (time.perf_counter() - t) * 1e3
            return out
        return inner

    store._dispatch_async_many = timed(store._dispatch_async_many, "dispatch_ms")
    store._dispatch_blocking = timed(store._dispatch_blocking, "dispatch_ms")
    store._scrub_group = timed(store._scrub_group, "scrub_ms")
    tick = store.tick

    def timed_tick(leaves, red, step, **kw):
        parts.update(dispatch_ms=0.0, scrub_ms=0.0)
        t = time.perf_counter()
        red, report = tick(leaves, red, step, **kw)
        rec.append({"step": step, "ms": (time.perf_counter() - t) * 1e3, **parts,
                    "updated": bool(report.updated), "scrubbed": bool(report.scrubbed)})
        return red, report
    store.tick = timed_tick
    return rec


def generate(model, params, batch, store=None, timed_steps=False,
             max_len=PROMPT + GEN + 1):
    """One ``Server.generate`` of GEN tokens; returns (tokens, stats, the
    per-step record, wall seconds).  ``timed_steps`` synchronises around
    each step to time it (``instrument``); otherwise only the store's ticks
    are timed, on the host clock."""
    srv = Server(model=model, store=store, max_len=max_len)
    if timed_steps:
        rec = instrument(srv, store)
    else:
        rec = {"ticks": host_timed_ticks(store) if store is not None else []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, stats = srv.generate(params, batch, GEN, scrub_every=SCRUB_EVERY)
    torch.cuda.synchronize()
    return tokens, stats, rec, time.perf_counter() - t0


def profile_decode(model, params, batch, store=None, steps=4, first=2,
                   max_len=PROMPT + GEN + 1) -> dict:
    """Trace ``steps`` warm decode steps from decode step ``first`` (with the
    store's on_write and tick when given) with torch.profiler: device busy
    time and kernel launches per token, the kernels that take the most
    device time, and the fused update's stream overlap."""
    from torch.profiler import ProfilerActivity, profile
    srv = Server(model=model, store=store, max_len=max_len)
    with torch.inference_mode():
        logits, caches, pos = srv.prefill(params, batch)
        red = srv.init_redundancy(caches)
        token = torch.argmax(logits, dim=-1).to(torch.int32)

        def step(t, red, token):
            _, _, red, token = srv.decode(params, caches, red, token, pos + t)
            if store is not None:
                red, _ = store.tick(lambda: flatten_dict(caches), red, t + 1,
                                    scrub_period=SCRUB_EVERY)
            return red, token

        for t in range(first):                  # warm
            red, token = step(t, red, token)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for t in range(first, first + steps):
                red, token = step(t, red, token)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_kernel.values())
    return {"device_busy_ms_per_token": busy / steps if kernels else "not measured",
            "launches_per_token": len(kernels) / steps,
            "top_kernels_ms_per_token": {k[:90]: v / steps for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])[:6]},
            "ticks": f"{first + 1}-{first + steps}", **stream_overlap(prof)}


def held_bytes(groups: dict, red: dict) -> dict:
    """Phase 26 (c): the bytes of the tensors a phase holds, by the memory
    model's terms (``groups`` maps a term to its flat tensors), and of its
    redundancy arrays (checksums, parity, dirty and shadow words); each
    leaf's 4-byte meta-checksum apart (``meta_ck``), which the model leaves
    out, as the reference's does."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    out = {k: nbytes(v.values()) for k, v in groups.items()}
    out["redundancy"] = sum(nbytes((r.checksums, r.parity, r.dirty, r.shadow))
                            for r in red.values())
    out["meta_ck"] = sum(r.meta_ck.numel() * 4 for r in red.values())
    return out


def costs_record(c) -> dict:
    """What phase 26 compares of a part's counts (picklable)."""
    return {"key": c.key(), "by_op": c.by_op, "copies": dict(c.copies),
            "total_flops": c.total_flops, "total_bytes": c.total_bytes, "aten_ops": c.n_ops}


def counted_parts(kind: str, step_fn, store, args, redundancy_fn=None) -> dict:
    """Phase 26 (b): one cell's parts (``dryrun.run_parts``) on the card
    under the cost counter, untimed, with the kernels' launches read
    around them; each kernel's counted launches must be its wrapper's
    (the card's path ran the kernels, not their plain versions)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    parts = dryrun.run_parts(kind, step_fn, store, args, redundancy_fn)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    counted = {}
    for c in parts.values():
        for n, k in c.kernels.items():
            counted[n] = counted.get(n, 0) + k.launches
    for n in ("checksum", "parity", "fused_update", "flash_attn"):
        check(counted.get(n, 0) == launches[n],
              f"{kind}: the counter saw {counted.get(n, 0)} {n} launches, its wrapper "
              f"launched {launches[n]}")
    return {"parts": {n: costs_record(c) for n, c in parts.items()}, "launches": launches,
            "seconds": seconds}


def counted_serving(model, params, batch, policy, tokens) -> dict:
    """Phase 26 (b) of phase 7's cell: the prefill, then a fresh store's
    init over caches of the same shapes, one decode step at the prompt's
    end and a redundancy pass, counted on the card."""
    max_len = PROMPT + GEN + 1
    pre = counted_parts("prefill", make_prefill(model, max_len), None, (params, batch))
    store = ProtectedStore(policy, device=DEVICE).attach(model.cache_shapes(SERVE_BATCH, max_len))
    caches = model.init_caches(SERVE_BATCH, max_len)
    dec = counted_parts("decode", make_decode_step(model, store), store,
                        (params, caches, {}, tokens[:, 0].contiguous(), PROMPT))
    del store, caches
    torch.cuda.empty_cache()
    return {"prefill": pre, "decode": dec}


def phase_serve(g) -> dict:
    """Serve llama3.2-3b at full width and depth with the KV caches under
    vilamb; check the run and time it.  Returns what phase 8 needs."""
    dev = torch.device(DEVICE)
    cfg = get_arch(SERVE_ARCH)
    model = build_model(cfg, dev)
    gen_state = g.get_state()           # phase 22 draws the same params and batch
    params = model.init(g)
    max_len = PROMPT + GEN + 1
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT),
                                     generator=g, device=dev, dtype=torch.int32)}
    policy = RedundancyPolicy.single("vilamb", period_steps=PERIOD,
                                     max_vulnerable_steps=DEADLINE)
    check(policy.async_tick, "the serving store is not on the overlapped tick")

    kinds = {"async": {}, "blocking": dict(async_tick=False)}

    def new_store(kind="async"):
        return ProtectedStore(dataclasses.replace(policy, **kinds[kind]),
                              device=dev).attach(model.cache_shapes(SERVE_BATCH, max_len))

    # Warm-up (no store, two tokens): first use of cuBLAS and the kernels.
    Server(model=model, max_len=max_len).generate(params, batch, 2)

    # The main path, with every step timed: the counts are read around it.
    store = new_store()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tokens, stats, rec, wall_s = generate(model, params, batch, store, True)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(launches["flash_attn"] == cfg.n_layers,
          f"flash launched {launches['flash_attn']} times in the prefill, want "
          f"{cfg.n_layers}")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched while serving")
    check(tuple(tokens.shape) == (SERVE_BATCH, GEN), f"tokens {tuple(tokens.shape)}")
    check(stats["mismatches"] == 0, f"scrub ticks found {stats['mismatches']} mismatches")
    # Due every PERIOD steps (16, 32, 48) unless the straggler governor
    # stretched the period; never more than DEADLINE steps apart.
    due = [t for t in rec["ticks"] if t["updated"]]
    steps = [0] + [t["step"] for t in due]
    check(due and all(b - a <= DEADLINE for a, b in zip(steps, steps[1:]))
          and GEN - 1 - steps[-1] < DEADLINE, f"due ticks at {steps[1:]}")

    # Redundancy is observational: the same tokens with no store.
    bare_tokens, _, bare_rec, bare_wall_s = generate(model, params, batch, None, True)
    check(torch.equal(tokens, bare_tokens), "tokens differ with and without the store")

    # End to end, untimed steps, in turns; the stores' ticks on the host
    # clock only.  Tokens equal for the overlapped store, the blocking store
    # and no store.
    walls = {"async": [], "none": [], "blocking": []}
    host_ticks = {"async": [], "blocking": []}
    for kind in ("async", "none", "blocking", "blocking", "none", "async"):
        st = None if kind == "none" else new_store(kind)
        toks, _, trec, wall = generate(model, params, batch, st)
        check(torch.equal(toks, tokens), f"tokens differ with the {kind} store")
        walls[kind].append(wall)
        if st is not None:
            host_ticks[kind].extend(trec["ticks"])

    patrol_serve = serve_patrolled(model, params, batch, policy, tokens)

    prof = {"store": profile_decode(model, params, batch, new_store()),
            "none": profile_decode(model, params, batch),
            "async_due": profile_decode(model, params, batch, new_store(), first=PERIOD - 1),
            "blocking_due": profile_decode(model, params, batch, new_store("blocking"),
                                           first=PERIOD - 1)}
    check(isinstance(prof["async_due"]["overlap_us"], str)
          or prof["async_due"]["fused_update_streams"]
          != prof["blocking_due"]["fused_update_streams"],
          "the overlapped store's fused update ran on the foreground's stream")

    out = {"model": model, "params": params, "batch": batch, "store": store,
           "caches": stats["caches"], "launches": launches, "patrolled": patrol_serve,
           "tokens": tokens, "gen_state": gen_state}
    with torch.inference_mode():
        out["red"], checks = serve_checks(g, store, flatten_dict(stats["caches"]),
                                          stats["red"])
        out["layer0_qkv"] = layer0_qkv(model, params, batch)
        out["layer0_err"] = layer0_err(*out["layer0_qkv"])
    decode_ms = sum(rec["decode_ms"]) + sum(t["ms"] for t in rec["ticks"])
    bare_decode_ms = sum(bare_rec["decode_ms"])
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    out["timings"] = {
        "prefill_ms": rec["prefill_ms"][0], "prefill_ms_no_store": bare_rec["prefill_ms"][0],
        "decode_ms_per_token": decode_ms / (GEN - 1),
        "decode_ms_per_token_no_store": bare_decode_ms / (GEN - 1),
        "decode_tokens_per_s": SERVE_BATCH * (GEN - 1) / (decode_ms / 1e3),
        "decode_tokens_per_s_no_store": SERVE_BATCH * (GEN - 1) / (bare_decode_ms / 1e3),
        "generate_s_timed_steps": wall_s, "generate_s_timed_steps_no_store": bare_wall_s,
        "generate_s": walls["async"], "generate_s_no_store": walls["none"],
        "generate_s_blocking": walls["blocking"],
        "generate_tokens_per_s": SERVE_BATCH * GEN / mean["async"],
        "generate_tokens_per_s_no_store": SERVE_BATCH * GEN / mean["none"],
        "generate_tokens_per_s_blocking": SERVE_BATCH * GEN / mean["blocking"],
        "store_overhead": mean["async"] / mean["none"] - 1,
        "store_overhead_blocking": mean["blocking"] / mean["none"] - 1,
        "due_tick_host_ms": {k: [t["ms"] for t in v if t["updated"]]
                             for k, v in host_ticks.items()},
        "due_tick_host_ms_median": {
            k: {part: statistics.median(t[part] for t in v if t["updated"])
                for part in ("ms", "dispatch_ms", "scrub_ms")}
            for k, v in host_ticks.items()},
        "quiet_tick_host_ms_mean": {k: sum(t["ms"] for t in v if not t["updated"])
                                    / max(1, sum(not t["updated"] for t in v))
                                    for k, v in host_ticks.items()},
        "decode_profile": prof["store"], "decode_profile_no_store": prof["none"],
        "decode_profile_due_async": prof["async_due"],
        "decode_profile_due_blocking": prof["blocking_due"],
        "due_tick_steps": steps[1:], "due_tick_ms": [t["ms"] for t in due],
        "due_tick_dirty_blocks": [t["dirty_blocks"] for t in due],
        "quiet_tick_ms_mean": (sum(t["ms"] for t in rec["ticks"] if not t["updated"])
                               / max(1, len(rec["ticks"]) - len(due))),
        "peak_mem_gb": peak_gb,
        "cache_gb": sum(m.data_bytes for m in store.metas.values()) / 1e9,
        "parity_gb": sum(r.parity.numel() * 4 for r in stats["red"].values()) / 1e9,
        **checks,
    }
    out["held"] = held_bytes({"params": flatten_dict(params),
                              "caches": flatten_dict(stats["caches"])}, stats["red"])
    out["counted"] = counted_serving(model, params, batch, policy, tokens)
    return out


def serve_patrolled(model, params, batch, policy, tokens) -> dict:
    """Phase 14d, inside phase 7: one more ``generate`` with the caches
    under ``policy`` with the scheduled scrub off, the patroller at 64 MiB
    a tick and the health governor at its defaults.  Tokens equal to the
    run with no store, the last health report HEALTHY, no patrol mismatch.
    Its launch counts are read around it (the kernel line's "patrol"
    path)."""
    from repro_torch.health import HEALTHY, HealthPolicy
    pol = dataclasses.replace(policy, patrol_bytes_per_tick=PATROL_BUDGETS[0],
                              health=HealthPolicy())
    store = ProtectedStore(pol, device=DEVICE).attach(
        model.cache_shapes(SERVE_BATCH, PROMPT + GEN + 1))
    mism: list = []
    tick = store.tick

    def counted(*a, **kw):
        red, report = tick(*a, **kw)
        mism.append(report.patrol_mismatches)
        return red, report
    store.tick = counted
    srv = Server(model=model, store=store, max_len=PROMPT + GEN + 1)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, stats = srv.generate(params, batch, GEN, scrub_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    pat = store.patroller
    check(torch.equal(toks, tokens), "tokens differ with the patrolled store")
    check(stats["health"] is not None and stats["health"].worst == HEALTHY
          and stats["health_actions"] == 0, f"serving health: {stats['health']}")
    check(sum(mism) == 0 and not pat.detections and not pat.unrecoverable,
          f"the patrol flagged {sum(mism)} blocks while serving")
    check(launches["checksum"] > 0 and launches["flash_attn"] == model.cfg.n_layers,
          f"patrolled serving launches {launches}")
    bpb = next(iter(store.metas.values())).bytes_per_block
    return {"generate_s": wall, "blocks_patrolled": pat.blocks_scanned,
            "bytes_patrolled_gb": pat.blocks_scanned * bpb / 1e9,
            "probe_ticks": len(mism), "launches": launches,
            "health": stats["health"].worst}


def serve_checks(g, store, leaves: dict, red: dict):
    """After generate: a clean scrub; flush; one corrupted K-cache lane found
    by scrub and rebuilt bitwise from parity; a clean rescrub."""
    masks, scrub_ms = timed(lambda: store.scrub(leaves, red))
    flagged = sum(int(m.sum()) for m in masks.values())
    check(flagged == 0, f"scrub after generate flagged {flagged} blocks")
    stats = {k: int(v) for k, v in store.dirty_stats(red)["slot_0/k"].items()}
    red, flush_ms = timed(lambda: store.flush(leaves, red, step=GEN))
    name = "slot_0/k"
    meta = store.metas[name]
    leaf = leaves[name]
    # The leaf's own words: its lane view where that is a view (llama's
    # caches fill whole blocks), its flat words otherwise (qwen3-moe's end
    # inside a block, so the store works on a padded copy).
    view = blocks.to_lanes(leaf, meta).data_ptr() == leaf.data_ptr()
    words = leaf.view(-1).view(torch.int32)
    L = meta.lanes_per_block
    bad = int(torch.randint(0, words.numel() // L, (1,), generator=g, device=DEVICE))
    saved = words[bad * L:(bad + 1) * L].clone()
    words[bad * L + 99] ^= 0xBAD
    masks, scrub2_ms = timed(lambda: store.scrub(leaves, red))
    flagged = {n: torch.nonzero(m).flatten().tolist() for n, m in masks.items()}
    check(flagged[name] == [bad] and all(not v for n, v in flagged.items() if n != name),
          f"scrub flagged {flagged}, expected [{bad}] in {name}")
    (fixed, ok), recover_ms = timed(lambda: store.recover_block(leaf, red[name], name, bad))
    check(ok and (fixed.data_ptr() == leaf.data_ptr()) == view,
          "recover_block refused, or copied a leaf whose lane view is a view")
    if not view:
        leaf.copy_(fixed)
    check(torch.equal(words[bad * L:(bad + 1) * L], saved),
          "recovered cache block differs from the original")
    masks, rescrub_ms = timed(lambda: store.scrub(leaves, red))
    check(sum(int(m.sum()) for m in masks.values()) == 0, "rescrub after repair flags blocks")
    check(all(bool(v) for v in store.verify_meta(red).values()), "verify_meta failed")
    return red, {"scrub_ms": scrub_ms, "flush_ms": flush_ms,
                 "flush_dirty_blocks_slot0_k": stats["dirty_blocks"],
                 "corrupted_block": bad, "cache_lane_view": view,
                 "scrub_flagged_ms": scrub2_ms,
                 "recover_ms": recover_ms, "rescrub_ms": rescrub_ms}


def layer0_qkv(model, params, batch):
    """Layer 0's prefill q, k, v of the whole batch (the prefill's shapes)."""
    p = params["stack"]["slot_0"]
    x = params["embed"][batch["tokens"].long()]
    h = layers.rmsnorm(x, p["mixer_norm"]["scale"][0])
    pos = torch.arange(PROMPT, device=DEVICE)[None, :]
    return attention._qkv({n: w[0] for n, w in p["attn"].items()}, h, model.cfg, pos)


def layer0_err(q, k, v, causal=True) -> dict:
    """A layer's prefill attention, kernel against plain, for one sequence
    at the prefill's lengths."""
    return flash_err(fa_ops.flash_attention(q[:1], k[:1], v[:1], causal=causal),
                     fa_ref.attention(q[:1], k[:1], v[:1], causal=causal),
                     f"one sequence, Sq={q.shape[1]} Sk={k.shape[1]} causal={causal}")


def flash_times(q, k, v, causal=True) -> dict:
    """The flash kernel at the prefill's shapes (a layer's q, k, v of all 8
    sequences): against its plain version, timed beside it and beside
    scaled_dot_product_attention (the library column; the port never calls
    it), with its bound, TFLOP/s and share of the bound."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    with torch.inference_mode():
        got, want = (fa_ops.flash_attention(q, k, v, causal=causal),
                     fa_ref.attention(q, k, v, causal=causal))
        prefill_err = flash_err(got, want, f"the prefill's shapes {[B, S, Sk, H, hd]}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        sdpa_err = float((sdpa().transpose(1, 2).float() - want.float()).abs().max())
        del got, want
        ms = per_call_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal), 10)
        plain_ms = per_call_ms(lambda: fa_ref.attention(q, k, v, causal=causal), 2)
        library_ms = per_call_ms(sdpa, 10)
    flops, nbytes = CA.flash_work(q, k, v, causal)
    bms, by = bound(nbytes, flops, CA.PEAK_BF16_FLOPS)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": [B, S, H, k.shape[2], hd],
            "Sk": Sk, "causal": causal,
            "tflops": flops / (ms / 1e3) / 1e12, "share_of_bound": bms / ms,
            "library_tflops": flops / (library_ms / 1e3) / 1e12,
            "err_vs_plain": prefill_err, "sdpa_max_abs_err_vs_plain": sdpa_err}


def phase_flash_time(serve: dict, err: float):
    """Phase 8: the flash kernel at llama3.2-3b's prefill shapes.  Returns
    the kernel's JSON row and the timing record."""
    t = flash_times(*serve["layer0_qkv"])
    err = max(err, t["err_vs_plain"]["max_abs_err"])
    return ({"name": "flash_attn", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attn.cu",
             "replaces": "src/repro/kernels/flash_attn/flash_attn.py:92",
             "launches": serve["launches"]["flash_attn"], "max_abs_err": err,
             **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}}, t)


def busy_union(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0, None
    for s0, s1 in sorted(spans):
        if end is None or s0 > end:
            busy, end = busy + (s1 - s0), s1
        elif s1 > end:
            busy, end = busy + (s1 - end), s1
    return busy


def busy_share(prof, window_us: float) -> dict:
    """The union of every kernel's device interval in a trace (all
    streams), over the traced window's wall time, and the kernels that take
    the most device time."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_union((e.time_range.start, e.time_range.end) for e in kernels)
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name[:90]] = by_kernel.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
    return {"window_ms": window_us / 1e3,
            "device_busy_union_ms": busy / 1e3 if kernels else "not measured",
            "device_busy_share": busy / window_us if kernels else "not measured",
            "kernels": len(kernels),
            "top_kernels_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10])}


def train_setup(seed: int):
    """llama3.2-3b for training on the card: model, data, AdamW, and the
    protected leaves' shapes (from ``Model.init``/``AdamW.init`` on the
    meta device)."""
    cfg = get_arch(TRAIN_ARCH)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size, cfg.padded_vocab, cfg.tie_embeddings, cfg.param_dtype,
           cfg.moment_dtype, cfg.remat)
    check(got == (28, 3072, 24, 8, 128, 8192, 128256, 129024, True, "bfloat16",
                  "float32", "full"), f"{TRAIN_ARCH} is not the full model: {got}")
    model = build_model(cfg, DEVICE)
    data = SyntheticPipeline(cfg, ShapeConfig("train_4k_batch1", TRAIN_SEQ, TRAIN_BATCH,
                                              "train"), seed=seed, device=DEVICE)
    opt = AdamW(lr=warmup_cosine(1e-3, 10, TRAIN_STEPS), moment_dtype=cfg.moment_dtype)
    meta = Model(cfg, torch.device("meta")).init()
    return model, data, opt, protected_structs(meta, opt.init(meta))


def train_trainer(model, opt, structs, kind: str) -> Trainer:
    """A Trainer whose store covers params/*, m/* and v/* with vilamb (T=8,
    deadline 16, scrub every 16) on the overlapped (``async``) or the
    blocking tick, or has no store (``none``)."""
    store = None
    if kind != "none":
        policy = RedundancyPolicy.single(
            "vilamb", period_steps=TRAIN_PERIOD, scrub_period_steps=TRAIN_SCRUB,
            max_vulnerable_steps=TRAIN_DEADLINE, async_tick=kind == "async")
        store = ProtectedStore(policy, device=DEVICE).attach(structs)
    return Trainer(model=model, opt=opt, store=store, scrub_period_steps=TRAIN_SCRUB)


def step_recorder(trainer, rec: dict, marked: dict = None):
    """An ``on_step`` callback keeping each step's loss tensor and wall ms
    (between consecutive callbacks: the step, its loss wait and its tick)
    and, for the names in ``marked``, OR-ing the blocks that are dirty or
    in flight into ``marked``."""
    rec.setdefault("losses", [])
    rec.setdefault("wall_ms", [])
    rec["last"] = time.perf_counter()

    def on_step(state, metrics):
        rec["losses"].append(metrics["loss"])
        for n, acc in (marked or {}).items():
            r = state.red[n]
            acc |= bits.unpack(r.dirty | r.shadow, trainer.store.metas[n].n_blocks)
        now = time.perf_counter()
        rec["wall_ms"].append((now - rec["last"]) * 1e3)
        rec["last"] = now
    return on_step


def phase_train(seed: int) -> dict:
    """Phase 9's main path (TRAIN_MAIN_STEPS with the overlapped store,
    traced at steps 7-9, then flush and a scrub), its checks, the three
    observational runs, and phase 26's counted step and held bytes."""
    from torch.profiler import ProfilerActivity, profile
    model, data, opt, structs = train_setup(seed)
    cfg = model.cfg
    embed_names = ("params/embed", "m/embed", "v/embed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k3_streams, restore_k3 = record_k3()
    reset_launches()
    try:
        trainer = train_trainer(model, opt, structs, "async")
        store = trainer.store
        check(store.policy.async_tick, "the training store is not on the overlapped tick")
        ticks = host_timed_ticks(store)
        state = trainer.init_state(torch.Generator(device=DEVICE).manual_seed(seed))
        embed0 = state.params["embed"].clone()
        marked = {n: torch.zeros(store.metas[n].n_blocks, dtype=torch.bool, device=DEVICE)
                  for n in embed_names}
        rec: dict = {}
        on_step = step_recorder(trainer, rec, marked)
        k3_first = len(k3_streams)            # attach's warmup and init before
        state = trainer.run(state, data, TRAIN_TRACE[0] - 1, on_step=on_step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rec["last"] = time.perf_counter()
            state = trainer.run(state, data, TRAIN_TRACE[1] - TRAIN_TRACE[0] + 1,
                                on_step=on_step)
            torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
        rec["last"] = time.perf_counter()
        state = trainer.run(state, data, TRAIN_MAIN_STEPS - TRAIN_TRACE[1], on_step=on_step)
        tick_k3 = k3_streams[k3_first:]       # the due ticks' updates
        state, flush_ms = timed(lambda: trainer.flush(state))
        scrub_mm, scrub_ms = timed(lambda: trainer.scrub_check(state))
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        restore_k3()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    losses = torch.stack(rec["losses"]).float()
    loss_list = losses.tolist()
    check(len(loss_list) == TRAIN_MAIN_STEPS and bool(torch.isfinite(losses).all()),
          f"losses {loss_list}")
    check(sum(loss_list[-4:]) / 4 < loss_list[0],
          f"the mean of the last four losses is not below the first: {loss_list}")
    due = [t["step"] for t in ticks if t["updated"]]
    scrubbed = [t["step"] for t in ticks if t["scrubbed"]]
    check(due == [8, 16] and scrubbed == [16], f"due ticks {due}, scrubs {scrubbed}")
    check(trainer.corruption_alarms == 0 and scrub_mm == 0,
          f"alarms {trainer.corruption_alarms}, scrub after flush {scrub_mm}")
    side = store._side_stream()
    check(tick_k3 and all(c[0] == side for c in tick_k3),
          "a fused update of a due tick ran off the training store's side stream")
    check(launches["flash_attn"] == 0, "training launched the forward-only flash kernel")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched while training")

    # Lazy rows: embedding rows no batch touched are bit-identical to their
    # initial values (moments: zero), and blocks of only such rows were
    # never marked dirty after init.
    rows = torch.zeros(cfg.padded_vocab, dtype=torch.bool, device=DEVICE)
    for step in range(TRAIN_MAIN_STEPS):
        rows.index_fill_(0, data.get(step)["tokens"].reshape(-1).long(), True)
    cold = ~rows
    check(torch.equal(state.params["embed"][cold].view(torch.int16),
                      embed0[cold].view(torch.int16)),
          "an untouched embedding row changed in params/embed")
    check(not torch.equal(state.params["embed"][rows], embed0[rows]),
          "no touched embedding row changed")
    for k in ("m", "v"):
        check(not bool(state.opt[k]["embed"][cold].view(torch.int32).any()),
              f"an untouched embedding row changed in {k}/embed")
    lazy = {"touched_rows": int(rows.sum()), "rows": cfg.padded_vocab}
    for n in embed_names:
        meta = store.metas[n]
        hot = blocks.row_mask_block_mask(meta, rows)
        check(not bool((marked[n] & ~hot).any()),
              f"{n}: a block of untouched rows was marked dirty")
        lazy[n] = {"blocks": meta.n_blocks, "cold_blocks": int((~hot).sum()),
                   "ever_marked": int(marked[n].sum())}
        check(lazy[n]["cold_blocks"] > 0, f"{n}: every block was touched")
    del embed0, marked, rows, cold

    leaves = protected_leaves(state.params, state.opt)
    phase_full_check(store, leaves, state.red)
    corrupt = train_corruption(store, leaves, state.red)
    red_gb = sum(r.parity.numel() * 4 for r in state.red.values()) / 1e9
    state_gb = sum(t.numel() * t.element_size() for t in leaves.values()) / 1e9
    n_params = sum(p.numel() for p in flatten_dict(state.params).values())
    params_gb = sum(p.numel() * p.element_size() for p in flatten_dict(state.params).values()) / 1e9
    main = {
        "losses": loss_list, "step_wall_ms": rec["wall_ms"], "launches": launches,
        "due_ticks": [{k: t[k] for k in ("step", "ms", "dispatch_ms", "scrub_ms",
                                          "scrubbed")} for t in ticks if t["updated"]],
        "quiet_tick_host_ms_mean": statistics.mean(t["ms"] for t in ticks if not t["updated"]),
        "trace_steps_7_9": {**stream_overlap(prof), **busy_share(prof, window_us)},
        "flush_ms": flush_ms, "scrub_check_ms": scrub_ms, "peak_mem_gb": peak_gb,
        "memory_gb": {"state": state_gb, "params": params_gb, "parity": red_gb,
                      "leaves": len(leaves),
                      "blocks": sum(m.n_blocks for m in store.metas.values())},
        "lazy_rows": lazy, "corruption": corrupt, "n_params": n_params,
        "held": held_bytes({"params": {n: t for n, t in leaves.items() if n.startswith("params/")},
                            "moments": {n: t for n, t in leaves.items()
                                        if not n.startswith("params/")}}, state.red),
        "k3_launches_on_side_stream": len({c[3] for c in tick_k3}),
        "k3_leaves_on_side_stream": len(tick_k3),
    }
    del trainer, store, state, leaves, prof, on_step
    gc.collect()
    torch.cuda.empty_cache()

    # The store is observational: three runs of OBS_TRAIN_STEPS from the
    # same seed, one after another, each freeing the last.
    obs = {}
    for kind in ("async", "blocking", "none"):
        obs[kind] = train_observe(model, data, opt, structs, seed, kind, OBS_TRAIN_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
    for kind in ("blocking", "none"):
        check(torch.equal(obs[kind]["loss_bits"], obs["async"]["loss_bits"]),
              f"losses differ between the overlapped store and {kind}: "
              f"{obs['async']['losses']} vs {obs[kind]['losses']}")
        check(obs[kind]["checksums"].keys() == obs["async"]["checksums"].keys()
              and all(torch.equal(v, obs["async"]["checksums"][n])
                      for n, v in obs[kind]["checksums"].items()),
              f"final params checksums differ between the overlapped store and {kind}")
    flops = CA.train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    for o in obs.values():
        step_s = o["median_step_ms"] / 1e3
        o["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / step_s
        o["model_flop_share"] = flops / step_s / CA.PEAK_BF16_FLOPS
        del o["loss_bits"], o["checksums"]
    none = obs["none"]
    # The profiler's own cost on each of a step's launches stretches the
    # traced window, so the busy share is also taken against the untraced
    # median step (no store: the foreground alone).
    trace = main["trace_steps_7_9"]
    if not isinstance(trace["device_busy_union_ms"], str):
        per_step = trace["device_busy_union_ms"] / (TRAIN_TRACE[1] - TRAIN_TRACE[0] + 1)
        trace["device_busy_ms_per_step"] = per_step
        trace["device_busy_share_of_untraced_step"] = per_step / none["median_step_ms"]
        trace["launches_per_step"] = trace["kernels"] / (TRAIN_TRACE[1] - TRAIN_TRACE[0] + 1)
    # Phase 26 (b): one step of this cell counted on the card, untimed.
    trainer = train_trainer(model, opt, structs, "async")
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed))
    state = TrainState.create(params, opt.init(params))
    counted = counted_parts("train", trainer.train_step, trainer.store, (state, data.get(0)),
                            trainer.redundancy_step)
    del trainer, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"main": main, "observe": obs, "model_flops_per_step": flops, "counted": counted,
            "store_overhead": {k: obs[k]["median_step_ms"] / none["median_step_ms"] - 1
                               for k in ("async", "blocking")},
            "store_overhead_drained": {k: obs[k]["drained_s"] / none["drained_s"] - 1
                                       for k in ("async", "blocking")}}


def train_observe(model, data, opt, structs, seed: int, kind: str,
                  steps: int = OBS_STEPS) -> dict:
    """``steps`` steps with the ``kind`` store from the seed: the losses (and
    their bits), each step's wall ms, the run's wall time before and after
    draining the device, the due ticks' host ms, and a K1 checksum of every
    final params leaf."""
    trainer = train_trainer(model, opt, structs, kind)
    ticks = host_timed_ticks(trainer.store) if trainer.store is not None else []
    state = trainer.init_state(torch.Generator(device=DEVICE).manual_seed(seed))
    rec: dict = {}
    on_step = step_recorder(trainer, rec)
    torch.cuda.synchronize()
    t0 = rec["last"] = time.perf_counter()
    state = trainer.run(state, data, steps, on_step=on_step)
    run_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    drained_s = time.perf_counter() - t0
    losses = torch.stack(rec["losses"])
    out = {"losses": losses.tolist(), "loss_bits": losses.view(torch.int32).clone(),
           "step_wall_ms": rec["wall_ms"],
           "median_step_ms": statistics.median(rec["wall_ms"][min(2, steps - 1):]),
           "run_s": run_s, "drained_s": drained_s,
           "due_tick_host_ms": [t["ms"] for t in ticks if t["updated"]],
           "checksums": {n: ck_ops.block_checksums(blocks.to_lanes(p, blocks.make_meta(p)))
                         for n, p in flatten_dict(state.params).items()}}
    del trainer, state
    return out


def train_corruption(store, leaves: dict, red: dict, names=None) -> dict:
    """One corrupted lane in each leaf of ``names`` (TRAIN_CORRUPT's m/ and
    params/ leaf by default): scrub flags exactly those blocks,
    ``recover_block`` (outside autograd) rebuilds each bitwise from parity
    in place, and a rescrub is clean."""
    g = torch.Generator(device=DEVICE).manual_seed(len(leaves))
    saved = {}
    for name in TRAIN_CORRUPT if names is None else names:
        meta = store.metas[name]
        lanes = blocks.to_lanes(leaves[name], meta)
        check(lanes.data_ptr() == leaves[name].data_ptr(), f"{name}: lane view is a copy")
        bad = int(torch.randint(0, meta.n_blocks, (1,), generator=g, device=DEVICE))
        saved[name] = (bad, lanes[bad].clone())
        lanes[bad, 99] ^= 0xBAD
    masks = store.scrub(leaves, red)
    flagged = {n: torch.nonzero(m).flatten().tolist() for n, m in masks.items() if m.any()}
    check(flagged == {n: [b] for n, (b, _) in saved.items()},
          f"scrub flagged {flagged}, expected {({n: [b] for n, (b, _) in saved.items()})}")
    with torch.no_grad():
        for name, (bad, want) in saved.items():
            fixed, ok = store.recover_block(leaves[name], red[name], name, bad)
            check(ok and fixed.data_ptr() == leaves[name].data_ptr(),
                  f"{name}: recover_block refused or copied")
            lanes = blocks.to_lanes(leaves[name], store.metas[name])
            check(torch.equal(lanes[bad], want), f"{name}: recovered block differs")
    masks = store.scrub(leaves, red)
    check(sum(int(m.sum()) for m in masks.values()) == 0, "rescrub after repair flags blocks")
    check(all(bool(v) for v in store.verify_meta(red).values()), "verify_meta failed")
    return {n: b for n, (b, _) in saved.items()}


def rec_state_bytes(structs: dict, store) -> int:
    """Bytes of one checkpoint of the recovery phase's TrainState: the
    protected leaves and every redundancy field."""
    leaf = sum(math.prod(s.shape) * s.dtype.itemsize for s in structs.values())
    red = sum(4 * (m.n_blocks + m.n_stripes * m.lanes_per_block + 2 * m.n_dirty_words + 1)
              for m in store.protected_metas.values())
    return leaf + red


def params_checksums(state) -> dict:
    """A K1 checksum of every params leaf (the resume's bitwise check)."""
    return {n: ck_ops.block_checksums(blocks.to_lanes(p, blocks.make_meta(p)))
            for n, p in flatten_dict(state.params).items()}


def leaves_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(blocks.to_lanes(v, blocks.make_meta(v)),
                    blocks.to_lanes(b[n], blocks.make_meta(b[n]))) for n, v in a.items())


def rec_save_times(ckpt) -> dict:
    """The latest save's parts (ms) and their rates (GB/s)."""
    r = ckpt.last_save
    gb = r["bytes"] / 1e9
    return {"gb": gb, **{f"{k}_ms": r[f"{k}_s"] * 1e3 for k in ("checksum", "copy", "write")},
            **{f"{k}_gb_per_s": gb / r[f"{k}_s"] for k in ("checksum", "copy", "write")}}


def rec_restore(ckpt, trainer_of, label: str, want: list, **kw):
    """``restore_verified`` into a fresh trainer (a new store, as a restart
    has); checks ``tried`` is one of the lists in ``want`` and returns the
    state, the trainer, the report and the times (the whole call, and the
    file read and verify of the candidate that was returned)."""
    tr = trainer_of()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)      # multi_corrupt's warning
        state = ckpt.restore_verified(tr.state_struct(), tr.store, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rep = ckpt.last_restore_report
    check(rep.tried in want, f"{label}: restore_verified tried {rep.tried}, expected "
                             f"one of {want}")
    check(state is not None, f"{label}: nothing restored")
    r = ckpt.last_restore
    gb = r["bytes"] / 1e9
    return state, tr, rep, {"restore_verified_ms": ms, "gb": gb,
                            "read_ms": r["read_s"] * 1e3, "verify_ms": r["verify_s"] * 1e3,
                            "read_gb_per_s": gb / r["read_s"],
                            "verify_gb_per_s": gb / r["verify_s"]}


def rec_fault(ckpt, state, step: int, case: str, g):
    """Save ``state`` as ``step`` with one fault: a lane of one block of
    REC_LEAF (``single``), two blocks of one stripe (``multi``), a word of
    that leaf's checksums (``meta``), or a byte in the middle of state.npz
    (``npz_byte``).  The live state is not touched (the faults go into
    clones).  Returns what was corrupted."""
    meta = blocks.make_meta(protected_leaves(state.params, state.opt)[REC_LEAF])
    leaf = flatten_dict(state.params)[REC_LEAF[len("params/"):]].clone()
    lanes = blocks.to_lanes(leaf, meta)
    check(lanes.data_ptr() == leaf.data_ptr(), f"{REC_LEAF}: lane view is a copy")
    stripe = int(torch.randint(0, meta.n_blocks // STRIPE, (1,), generator=g, device=DEVICE))
    b0 = stripe * STRIPE
    red = state.red
    if case == "single":
        lanes[b0 + 1, 7] ^= 0x1000
    elif case == "multi":
        lanes[b0, 7] ^= 0x1000
        lanes[b0 + 2, 99] ^= 0x1
    elif case == "meta":
        r = red[REC_LEAF]
        ck = r.checksums.clone()
        ck[b0] ^= 0x10000
        red = dict(red, **{REC_LEAF: dataclasses.replace(r, checksums=ck)})
    if case in ("single", "multi"):
        params = replace_leaves(state.params, {REC_LEAF[len("params/"):]: leaf})
    else:
        params = state.params
    faulty = dataclasses.replace(state, params=params, red=red)
    ckpt.save(step, faulty, blocking=True)
    if case == "npz_byte":
        f = Path(ckpt.dir) / f"step_{step}" / "state.npz"
        with open(f, "r+b") as fh:
            fh.seek(f.stat().st_size // 2)
            byte = fh.read(1)
            fh.seek(-1, 1)
            fh.write(bytes([byte[0] ^ 0xFF]))
    return {"case": case, "step": step, "stripe": stripe, "block": b0}


def phase_recovery(seed: int) -> dict:
    """Phase 10: the recovery path on llama3.2-3b at full width, 2 layers.

    Train 16 steps with a non-blocking save every 8 (each right after a
    due tick, its update on the side stream); resume from step 8 into a
    fresh trainer and check steps 9-16 bitwise; the corruption demo on the
    live state; four corrupted checkpoints classified by
    ``restore_verified``; an in-process preemption (SIGUSR1, drain); and
    the launcher itself with its recovery flags.  Returns the phase's
    record (its launch counts under ``launches``)."""
    import shutil
    import signal
    import tempfile
    from repro_torch.ckpt import CheckpointManager, PreemptionHandler
    from repro_torch.launch import train as launcher
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=REC_LAYERS)
    got = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.padded_vocab,
           cfg.param_dtype, cfg.moment_dtype)
    check(got == (3072, 24, 8, 8192, 129024, "bfloat16", "float32"),
          f"{TRAIN_ARCH} is not at full width: {got}")
    model = build_model(cfg, DEVICE)
    data = SyntheticPipeline(cfg, ShapeConfig("train_4k_batch1", TRAIN_SEQ, TRAIN_BATCH,
                                              "train"), seed=seed, device=DEVICE)
    opt = AdamW(lr=warmup_cosine(1e-3, 10, REC_STEPS), moment_dtype=cfg.moment_dtype)
    meta = Model(cfg, torch.device("meta")).init()
    structs = protected_structs(meta, opt.init(meta))

    def trainer_of():
        return train_trainer(model, opt, structs, "async")

    g = torch.Generator(device=DEVICE).manual_seed(seed + 10)
    d = tempfile.mkdtemp(prefix="vilamb_ckpt_")
    launch_dir = tempfile.mkdtemp(prefix="vilamb_launch_")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        trainer = trainer_of()
        ckpt_gb = rec_state_bytes(structs, trainer.store) / 1e9
        free_gb = shutil.disk_usage(d).free / 1e9
        check(free_gb > REC_DISK_CKPTS * ckpt_gb * 1.1,
              f"phase 10 needs {REC_DISK_CKPTS} checkpoints of {ckpt_gb:.2f} GB on disk "
              f"({REC_DISK_CKPTS * ckpt_gb * 1.1:.1f} GB with a tenth spare) in {d}; "
              f"{free_gb:.1f} GB are free")
        ckpt = CheckpointManager(d, keep=2, device=DEVICE)
        saves = {}

        # 1. Train REC_STEPS steps, saving every REC_CKPT_EVERY without blocking.
        losses: list = []

        def on_step(st, metrics):
            losses.append(metrics["loss"])
            if st.step % REC_CKPT_EVERY == 0:
                ckpt.save(st.step, st, blocking=False, store=trainer.store)
                saves[st.step] = ckpt.last_save
        state = trainer.init_state(torch.Generator(device=DEVICE).manual_seed(seed))
        state = trainer.run(state, data, REC_STEPS, on_step=on_step)
        ckpt.wait()
        save_ms = rec_save_times(ckpt)
        check(ckpt.steps() == [REC_CKPT_EVERY, REC_STEPS], f"checkpoints {ckpt.steps()}")
        loss_bits = torch.stack(losses).view(torch.int32).clone()
        check(bool(torch.isfinite(torch.stack(losses)).all()), "non-finite losses")
        want_sums = params_checksums(state)

        # 2. Resume from the step-8 checkpoint (saved right after a due tick).
        res, tr2, _, restore_ms = rec_restore(ckpt, trainer_of, "resume",
                                              [[(REC_CKPT_EVERY, "ok")]], step=REC_CKPT_EVERY)
        check(res.step == REC_CKPT_EVERY, f"resumed at step {res.step}")
        res_losses: list = []
        res = tr2.run(res, data, REC_STEPS - REC_CKPT_EVERY,
                      on_step=lambda st, m: res_losses.append(m["loss"]))
        check(torch.equal(torch.stack(res_losses).view(torch.int32),
                          loss_bits[REC_CKPT_EVERY:]),
              f"losses after the resume differ: {torch.stack(res_losses).tolist()} vs "
              f"{torch.stack(losses)[REC_CKPT_EVERY:].tolist()}")
        got_sums = params_checksums(res)
        check(all(torch.equal(v, want_sums[n]) for n, v in got_sums.items()),
              "final params checksums differ after the resume")
        del res, tr2, res_losses
        gc.collect()
        torch.cuda.empty_cache()

        # 3. The corruption demo on the live state, as --inject-corruption.
        store = trainer.store
        state = trainer.flush(state)
        leaves = protected_leaves(state.params, state.opt)
        name = sorted(store.protected_metas)[0]
        with torch.no_grad():
            lanes = blocks.to_lanes(leaves[name], store.metas[name])
            check(lanes.data_ptr() == leaves[name].data_ptr(), f"{name}: lane view is a copy")
            lanes[0, 0] += 0xDEAD
        mm, scrub_ms = timed(lambda: store.scrub(leaves, state.red))
        detected = sum(int(v.sum()) for v in mm.values())
        (repaired, fixed, lost), repair_ms = timed(
            lambda: store.repair(leaves, state.red, mm))
        residual = sum(int(v.sum()) for v in store.scrub(repaired, state.red).values())
        demo = {"leaf": name, "detected": detected, "repaired": fixed, "unrecoverable": lost,
                "residual": residual, "scrub_ms": scrub_ms, "repair_ms": repair_ms}
        check((detected, fixed, lost, residual) == (1, 1, 0, 0),
              f"corruption demo: {demo}")
        check(all(repaired[n] is leaves[n] for n in leaves), "repair did not work in place")

        # 4. Corrupted checkpoints, each beside the good step-16 one.
        live = protected_leaves(state.params, state.opt)
        faults = {}
        good = (REC_STEPS, "ok")
        cases = (("single", [[(REC_STEPS + 1, "ok_repaired")]]),
                 ("multi", [[(REC_STEPS + 2, "unrecoverable"), good]]),
                 ("meta", [[(REC_STEPS + 3, "meta_checksum"), good]]),
                 ("npz_byte", [[(REC_STEPS + 4, "file_checksum"), good],
                               [(REC_STEPS + 4, "load_failed"), good]]))
        for i, (case, want) in enumerate(cases, start=1):
            step = REC_STEPS + i
            fault = rec_fault(ckpt, state, step, case, g)
            rst, _, rep, times = rec_restore(ckpt, trainer_of, case, want)
            fault.update(tried=rep.tried, repaired_blocks=rep.repaired_blocks,
                         lost_blocks=rep.lost_blocks,
                         unrecoverable=[(u.leaf, u.stripe, list(u.blocks), u.reason)
                                        for u in rep.unrecoverable], **times)
            if case == "single":
                check(rep.repaired_blocks == 1, f"single: {rep.repaired_blocks} repaired")
                check(leaves_equal(protected_leaves(rst.params, rst.opt), live),
                      "single: the repaired restore differs from the saved leaves")
            if case == "multi":
                check(fault["unrecoverable"] == [(REC_LEAF, fault["stripe"],
                                                  [fault["block"], fault["block"] + 2],
                                                  "multi_corrupt")],
                      f"multi: {fault['unrecoverable']}")
            shutil.rmtree(Path(d) / f"step_{step}")
            faults[case] = fault
            del rst
            gc.collect()
            torch.cuda.empty_cache()

        # 5. Preemption in-process: SIGUSR1, then the drain.
        state = trainer.run(state, data, REC_PREEMPT_AT)
        handler = PreemptionHandler().install()
        os.kill(os.getpid(), signal.SIGUSR1)
        check(handler.requested, "SIGUSR1 did not request the drain")
        est = store.estimate_flush(state.red)
        state = handler.drain(trainer, state, ckpt)
        drain = {"flush_s": handler.flush_seconds, "estimate_s": est.seconds,
                 "ratio": handler.flush_seconds / est.seconds,
                 "dirty_bytes": est.dirty_bytes, "stripe_bytes": est.stripe_bytes,
                 "write_bytes": est.write_bytes,
                 "copy_gb_per_s": store.copy_bytes_per_sec() / 1e9,
                 "save": rec_save_times(ckpt)}
        check(ckpt.steps()[-1] == state.step, f"drain saved {ckpt.steps()}")
        check(sum(int(v.sum()) for v in trainer.scrub_fn(state).values()) == 0,
              "the drained state does not scrub clean")
        del trainer, store, state, leaves, repaired, live, mm
        gc.collect()
        torch.cuda.empty_cache()

        # 6. The launcher itself: checkpoints, the demo, then --resume.
        cli = ["--arch", TRAIN_ARCH, "--smoke", "--ckpt-dir", launch_dir, "--device", DEVICE,
               "--log-every", "4"]
        outs = []
        for extra in (["--steps", "8", "--ckpt-every", "4", "--inject-corruption", "6"],
                      ["--steps", "4", "--resume"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                launcher.main(cli + extra)
            outs.append(buf.getvalue())
        check("[vilamb] injected corruption: detected=1 repaired=1 unrecoverable=0 "
              "residual=0" in outs[0], f"launcher: {outs[0]}")
        check("[train] resumed from step 8" in outs[1] and "[train] step 12 loss" in outs[1],
              f"launcher --resume: {outs[1]}")
        torch.cuda.synchronize()
        launches = read_launches()
        for kname in ("checksum", "parity", "fused_update"):
            check(launches[kname] > 0, f"{kname} kernel never launched on the recovery path")
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(launch_dir, ignore_errors=True)
    return {"reduced": {"n_layers": [28, REC_LAYERS],
                        "why": "each checkpoint writes the whole state: "
                               f"{ckpt_gb:.2f} GB at depth {REC_LAYERS}, about 40 GB at 28; "
                               "phase 9 covers the full depth"},
            "checkpoint_gb": ckpt_gb, "disk_free_gb": free_gb,
            "losses": torch.stack(losses).tolist(), "save": save_ms,
            "saves_in_run": {s: {k: v for k, v in r.items() if k.endswith("_s")}
                             for s, r in saves.items()},
            "resume": restore_ms, "demo": demo, "faults": faults, "drain": drain,
            "launcher": [o.strip().splitlines() for o in outs], "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "wall_s": time.perf_counter() - t_phase}


def print_recovery(rec: dict) -> None:
    """Phase 10's lines: its times, checks and the card."""
    sv, rs, dr = rec["save"], rec["resume"], rec["drain"]
    print(f"recovery ({rec['wall_s']:.1f} s): {TRAIN_ARCH} at full width, depth cut to "
          f"{REC_LAYERS} ({rec['reduced']['why']}); launches {rec['launches']}; peak "
          f"{rec['peak_mem_gb']:.2f} GiB; losses {[round(x, 4) for x in rec['losses']]}")
    print(f"recovery: save of step {REC_STEPS} ({sv['gb']:.3f} GB): file checksum "
          f"{sv['checksum_ms']:.1f} ms ({sv['checksum_gb_per_s']:.1f} GB/s), device-to-host "
          f"{sv['copy_ms']:.1f} ms ({sv['copy_gb_per_s']:.2f} GB/s), write "
          f"{sv['write_ms']:.1f} ms ({sv['write_gb_per_s']:.2f} GB/s)")
    print(f"recovery: restore_verified of step {REC_CKPT_EVERY} {rs['restore_verified_ms']:.1f} "
          f"ms: read {rs['read_ms']:.1f} ms ({rs['read_gb_per_s']:.2f} GB/s), verify "
          f"{rs['verify_ms']:.1f} ms ({rs['verify_gb_per_s']:.1f} GB/s); steps "
          f"{REC_CKPT_EVERY + 1}-{REC_STEPS} after the resume bitwise equal to the "
          f"uninterrupted run (losses and final params checksums)")
    d = rec["demo"]
    print(f"recovery: injected corruption in {d['leaf']}: detected={d['detected']} "
          f"repaired={d['repaired']} unrecoverable={d['unrecoverable']} "
          f"residual={d['residual']}; scrub {d['scrub_ms']:.2f} ms, repair "
          f"{d['repair_ms']:.2f} ms")
    for case, f in rec["faults"].items():
        print(f"recovery: checkpoint fault {case}: tried {f['tried']}, repaired "
              f"{f['repaired_blocks']}, lost {f['lost_blocks']} {f['unrecoverable']}; "
              f"restore_verified {f['restore_verified_ms']:.1f} ms")
    print(f"recovery: drain after SIGUSR1: flush_seconds {dr['flush_s'] * 1e3:.3f} ms "
          f"against estimate_flush {dr['estimate_s'] * 1e3:.3f} ms (ratio "
          f"{dr['ratio']:.2f}: PERF.md section 2's limit of 2 "
          f"{'held' if dr['ratio'] <= 2 else 'MISSED'}; copy rate "
          f"{dr['copy_gb_per_s']:.1f} GB/s); "
          f"blocking save {dr['save']['checksum_ms'] + dr['save']['copy_ms'] + dr['save']['write_ms']:.1f} ms")
    print(f"recovery: launcher: {rec['launcher']}")


def moe_config(n_layers: int):
    """qwen3-moe-235b-a22b at its published widths, ``n_layers`` deep."""
    cfg = get_arch(MOE_ARCH)
    got = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_experts, cfg.top_k,
           cfg.expert_d_ff, cfg.vocab_size, cfg.padded_vocab, cfg.tie_embeddings,
           cfg.param_dtype, cfg.moment_dtype, cfg.remat)
    check(got == (4096, 64, 4, 64, 128, 8, 1536, 151936, 153600, False, "bfloat16",
                  "bfloat16", "full"), f"{MOE_ARCH} is not at full width: {got}")
    return dataclasses.replace(cfg, n_layers=n_layers)


def n_params_of(params) -> int:
    return sum(p.numel() for p in flatten_dict(params).values())


def phase_serve_moe(g) -> dict:
    """Phase 11: serve qwen3-moe at full width, 12 layers, with the KV
    caches under vilamb; check the run and time it, then flash at this
    prefill's shape (after the weights are freed: the plain version's fp32
    scores of one sequence are 4.3 GB)."""
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    cfg = moe_config(MOE_SERVE_LAYERS)
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = n_params_of(params)
    check(n_params == MOE_SERVE_LAYERS * MOE_LAYER_PARAMS + MOE_EMBED_HEAD_PARAMS
          + cfg.d_model, f"{n_params} params")
    max_len = PROMPT + GEN + 1
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT),
                                     generator=g, device=dev, dtype=torch.int32)}
    policy = RedundancyPolicy.single("vilamb", period_steps=PERIOD,
                                     max_vulnerable_steps=DEADLINE)

    def new_store(async_tick=True):
        return ProtectedStore(dataclasses.replace(policy, async_tick=async_tick),
                              device=dev).attach(model.cache_shapes(SERVE_BATCH, max_len))

    Server(model=model, max_len=max_len).generate(params, batch, 2)     # warm-up

    # The main path, every step timed, with the counts read around it.
    store = new_store()
    check(store.policy.async_tick, "the MoE serving store is not on the overlapped tick")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tokens, stats, rec, wall_s = generate(model, params, batch, store, True)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(launches["flash_attn"] == cfg.n_layers,
          f"flash launched {launches['flash_attn']} times in the prefill, want {cfg.n_layers}")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched while serving the MoE model")
    check(tuple(tokens.shape) == (SERVE_BATCH, GEN), f"tokens {tuple(tokens.shape)}")
    check(stats["mismatches"] == 0, f"scrub ticks found {stats['mismatches']} mismatches")
    due = [t["step"] for t in rec["ticks"] if t["updated"]]
    check(due and all(b - a <= DEADLINE for a, b in zip([0] + due, due)),
          f"due ticks at {due}")

    # Observational: the same tokens with the blocking store and no store.
    walls = {"async": wall_s}
    for kind in ("blocking", "none"):
        toks, _, _, walls[kind] = generate(model, params, batch,
                                           None if kind == "none" else new_store(False))
        check(torch.equal(toks, tokens), f"MoE tokens differ with the {kind} store")
    prof = profile_decode(model, params, batch, new_store())
    with torch.inference_mode():
        leaves = flatten_dict(stats["caches"])
        red, checks = serve_checks(g, store, leaves, stats["red"])
        phase_full_check(store, leaves, red)
        qkv = tuple(t.clone() for t in layer0_qkv(model, params, batch))
    decode_ms = sum(rec["decode_ms"]) + sum(t["ms"] for t in rec["ticks"])
    out = {"launches": launches, "n_params": n_params, "init_s": init_s,
           "params_gib": sum(p.numel() * p.element_size()
                             for p in flatten_dict(params).values()) / 2**30,
           "cache_gb": sum(m.data_bytes for m in store.metas.values()) / 1e9,
           "prefill_ms": rec["prefill_ms"][0],
           "decode_ms_per_token": decode_ms / (GEN - 1),
           "decode_tokens_per_s": SERVE_BATCH * (GEN - 1) / (decode_ms / 1e3),
           "generate_s": walls, "due_tick_steps": due,
           "due_tick_ms": [t["ms"] for t in rec["ticks"] if t["updated"]],
           "decode_profile": {k: v for k, v in prof.items()
                              if k != "top_kernels_ms_per_token"},
           "decode_top_kernels_ms_per_token": prof["top_kernels_ms_per_token"],
           "peak_mem_gib": peak_gb, **checks}
    del model, params, store, stats, leaves, red, batch, tokens
    gc.collect()
    torch.cuda.empty_cache()
    out["layer0_err"] = layer0_err(*qkv)
    out["flash"] = flash_times(*qkv)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


class _Recorder:
    """Wraps ``model.dirty_events_train``: keeps each step's expert-slab
    mask of slot 0 (which ``(G, E)`` slabs the step routed tokens to)."""

    def __init__(self, model):
        self.model, self.fn, self.masks = model, model.dirty_events_train, []
        model.dirty_events_train = self

    def __call__(self, batch, aux):
        events = self.fn(batch, aux)
        self.masks.append(events["stack/slot_0/moe/wi"].clone())
        return events

    def close(self):
        self.model.dirty_events_train = self.fn


def moe_sparse_step(trainer, state, data, rec: _Recorder) -> tuple:
    """The step of MOE_SPARSE_SEQ tokens after the due update is adopted:
    the slabs it routes no token to are copied to the host before it and
    held bit for bit after it; the expert leaves' dirty blocks are exactly
    the routed slabs'; the flush that follows hands K3 exactly the routed
    slabs' stripes, the embedding rows' and the ALL-dirty leaves'; a scrub
    is clean, and every checksum and parity row equals a plain recompute.
    Returns the state and the step's record."""
    store = trainer.store
    state = trainer.settle(state)
    check(all(not bool((r.dirty | r.shadow).any()) for r in state.red.values()),
          "blocks are dirty or in flight after the due update was adopted")
    batch = data.get(state.step)
    with torch.no_grad():
        _, aux = trainer.model.loss(state.params, batch)
    routed = aux["expert_counts"][:, 0, :] > 0                     # (G, E)
    cold = (~routed).nonzero().tolist()
    leaves = protected_leaves(state.params, state.opt)
    slab_names = [n for n in leaves if "/moe/w" in n]
    hot = tuple(routed.nonzero()[0].tolist())
    before = {(n, gi, e): leaves[n][gi, e].to("cpu", copy=True)
              for n in slab_names for gi, e in cold}
    hot_before = {n: leaves[n][hot].to("cpu", copy=True) for n in slab_names}
    state = trainer.run(state, data, 1)
    check(torch.equal(rec.masks[-1], routed),
          "the step's routing differs from its forward's without gradients")
    events = rec.fn(batch, aux)
    leaves = protected_leaves(state.params, state.opt)
    for (n, gi, e), t in before.items():
        check(torch.equal(leaves[n][gi, e].cpu().view(torch.int16), t.view(torch.int16)),
              f"{n}: slab ({gi}, {e}), routed no token, changed")
    for n, t in hot_before.items():
        check(not torch.equal(leaves[n][hot].cpu().view(torch.int16), t.view(torch.int16)),
              f"{n}: slab {hot}, routed tokens, did not change")
    want_stripes, marked_ok = {}, True
    expanded = store.expand_events(events)
    for n, meta in store.metas.items():
        r = state.red[n]
        ev = expanded[n]
        want = (torch.ones(meta.n_blocks, dtype=torch.bool, device=DEVICE)
                if isinstance(ev, str) else
                blocks.row_mask_block_mask(meta, ev, row_dims=ev.dim()))
        marked = bits.unpack(r.dirty | r.shadow, meta.n_blocks)
        marked_ok &= torch.equal(marked, want)
        want_stripes[n] = int(blocks.stripe_dirty_mask(meta, want).sum())
    check(marked_ok, "the dirty blocks after the sparse step are not exactly its events'")
    ptrs = {blocks.to_lanes(leaves[n], store.metas[n]).data_ptr(): n for n in slab_names}
    calls, restore = record_k3(count_stripes=True)
    try:
        state, flush_ms = timed(lambda: trainer.flush(state))
    finally:
        restore()
    got = {}
    for _, ptr, count, _ in calls:
        if ptr in ptrs:
            got[ptrs[ptr]] = got.get(ptrs[ptr], 0) + count
    check(all(got.get(n, 0) == want_stripes[n] for n in slab_names),
          f"K3's stripes of the expert leaves {got} != the routed slabs' "
          f"{ {n: want_stripes[n] for n in slab_names} }")
    check(sum(c[2] for c in calls) == sum(want_stripes.values()),
          f"K3 processed {sum(c[2] for c in calls)} stripes, want "
          f"{sum(want_stripes.values())}")
    mm = trainer.scrub_check(state)
    check(mm == 0, f"scrub after the sparse step's update: {mm} mismatches")
    with uncounted():
        phase_full_check(store, protected_leaves(state.params, state.opt), state.red)
    meta = store.metas[slab_names[0]]
    return state, {
        "tokens": MOE_SPARSE_SEQ, "slabs": routed.numel(),
        "slabs_routed": int(routed.sum()), "slabs_untouched": len(cold),
        "untouched_share": len(cold) / routed.numel(),
        "stripes_per_slab": meta.n_stripes // routed.numel(),
        "k3_launches": len({c[3] for c in calls}), "k3_leaves": len(calls),
        "k3_stripes": sum(c[2] for c in calls),
        "stripes_total": sum(m.n_stripes for m in store.metas.values()),
        "slab_leaf_stripes": {n: want_stripes[n] for n in slab_names},
        "flush_ms": flush_ms, "host_copy_gb": sum(t.numel() * 2 for t in before.values()) / 1e9}


def phase_train_moe(seed: int) -> dict:
    """Phase 12: train qwen3-moe at full width, 2 layers: the main path
    (the overlapped store, 8 steps traced at 7-8, then the sparse step),
    then 8 steps each with the blocking and no store."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    cfg = moe_config(MOE_TRAIN_LAYERS)
    model = build_model(cfg, DEVICE)
    data = SyntheticPipeline(cfg, ShapeConfig("train_4k_batch1", TRAIN_SEQ, TRAIN_BATCH,
                                              "train"), seed=seed, device=DEVICE)
    sparse = SyntheticPipeline(cfg, ShapeConfig("sparse", MOE_SPARSE_SEQ, 1, "train"),
                               seed=seed + 1, device=DEVICE)
    opt = AdamW(lr=warmup_cosine(1e-3, 10, TRAIN_STEPS), moment_dtype=cfg.moment_dtype)
    meta = Model(cfg, torch.device("meta")).init()
    structs = protected_structs(meta, opt.init(meta))
    n_params = n_params_of(meta)
    check(n_params == MOE_TRAIN_LAYERS * MOE_LAYER_PARAMS + MOE_EMBED_HEAD_PARAMS
          + cfg.d_model, f"{n_params} params")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k3_streams, restore_k3 = record_k3()
    reset_launches()
    rec = _Recorder(model)
    try:
        trainer = train_trainer(model, opt, structs, "async")
        store = trainer.store
        ticks = host_timed_ticks(store)
        state = trainer.init_state(torch.Generator(device=DEVICE).manual_seed(seed))
        steps: dict = {}
        on_step = step_recorder(trainer, steps)
        k3_first = len(k3_streams)
        state = trainer.run(state, data, MOE_TRACE[0] - 1, on_step=on_step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps["last"] = time.perf_counter()
            state = trainer.run(state, data, MOE_TRACE[1] - MOE_TRACE[0] + 1,
                                on_step=on_step)
            torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
        tick_k3 = k3_streams[k3_first:]
        restore_k3()
        with uncounted():
            main_sums = params_checksums(state)
        state, sparse_rec = moe_sparse_step(trainer, state, sparse, rec)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        restore_k3()
        rec.close()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = torch.stack(steps["losses"]).float()
    check(len(steps["losses"]) == OBS_STEPS and bool(torch.isfinite(losses).all()),
          f"losses {losses.tolist()}")
    due = [t["step"] for t in ticks if t["updated"]]
    check(due == [8], f"due ticks {due}")
    check(trainer.corruption_alarms == 0, f"alarms {trainer.corruption_alarms}")
    side = store._side_stream()
    check(tick_k3 and all(c[0] == side for c in tick_k3),
          "a fused update of a due tick ran off the MoE training store's side stream")
    check(launches["flash_attn"] == 0, "training launched the forward-only flash kernel")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched while training the MoE model")
    leaves = protected_leaves(state.params, state.opt)
    main = {
        "losses": losses.tolist(), "loss_bits": losses.view(torch.int32).clone(),
        "step_wall_ms": steps["wall_ms"],
        "median_step_ms": statistics.median(steps["wall_ms"][2:MOE_TRACE[0] - 1]),
        "slabs_routed_share": [float(m.float().mean()) for m in rec.masks],
        "due_ticks": [{k: t[k] for k in ("step", "ms", "dispatch_ms", "scrub_ms")}
                      for t in ticks if t["updated"]],
        "trace_steps_7_8": {**stream_overlap(prof), **busy_share(prof, window_us)},
        "launches": launches, "peak_mem_gib": peak_gib, "n_params": n_params,
        "memory_gb": {"state": sum(t.numel() * t.element_size() for t in leaves.values()) / 1e9,
                      "parity": sum(r.parity.numel() * 4 for r in state.red.values()) / 1e9,
                      "leaves": len(leaves)},
        "sparse_step": sparse_rec, "k3_launches_on_side_stream": len({c[3] for c in tick_k3}),
        "k3_leaves_on_side_stream": len(tick_k3)}
    del trainer, store, state, leaves, prof, on_step
    gc.collect()
    torch.cuda.empty_cache()

    obs = {}
    for kind in ("blocking", "none"):
        obs[kind] = train_observe(model, data, opt, structs, seed, kind)
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.equal(obs[kind]["loss_bits"], main["loss_bits"]),
              f"MoE losses differ between the overlapped store and {kind}: "
              f"{main['losses']} vs {obs[kind]['losses']}")
        check(obs[kind]["checksums"].keys() == main_sums.keys()
              and all(torch.equal(v, main_sums[n]) for n, v in obs[kind]["checksums"].items()),
              f"final MoE params checksums differ between the overlapped store and {kind}")
        obs[kind]["median_step_ms"] = statistics.median(obs[kind]["step_wall_ms"][2:MOE_TRACE[0] - 1])
        del obs[kind]["loss_bits"], obs[kind]["checksums"]
    del main["loss_bits"]
    return {"main": main, "observe": obs, "phase_s": time.perf_counter() - t_phase}


def print_serve_moe(r: dict) -> None:
    f = r["flash"]
    print(f"serve moe ({r['phase_s']:.1f} s): {MOE_ARCH} full width, {MOE_SERVE_LAYERS} "
          f"layers, {r['n_params']} params ({r['params_gib']:.2f} GiB, drawn in "
          f"{r['init_s']:.1f} s), KV caches {r['cache_gb']:.3f} GB; launches "
          f"{r['launches']}; peak {r['peak_mem_gib']:.2f} GiB")
    print(f"serve moe: prefill {r['prefill_ms']:.1f} ms; decode "
          f"{r['decode_ms_per_token']:.2f} ms/token ({r['decode_tokens_per_s']:.1f} "
          f"tokens/s); traced decode {r['decode_profile']['launches_per_token']:.0f} "
          f"launches and {r['decode_profile']['device_busy_ms_per_token']} ms of device "
          f"time a token; generate s {r['generate_s']}; due ticks {r['due_tick_steps']} "
          f"{[round(x, 2) for x in r['due_tick_ms']]} ms")
    print(f"serve moe: tokens identical with the overlapped, blocking and no store; "
          f"scrub clean; block {r['corrupted_block']} of slot_0/k corrupted, found and "
          f"repaired; full check passed; layer-0 attention within bounds of plain: "
          f"{r['layer0_err']}")
    print(f"flash at the MoE prefill's shape {f['shape']}: {f['ms']:.4f} ms, "
          f"{f['tflops']:.1f} TFLOP/s, {100 * f['share_of_bound']:.1f}% of its "
          f"{f['bound_ms']:.4f} ms bound ({f['bound_by']}); "
          f"scaled_dot_product_attention {f['library_ms']:.4f} ms; plain "
          f"{f['plain_ms']:.2f} ms", flush=True)


def print_train_moe(r: dict) -> None:
    m, sp = r["main"], r["main"]["sparse_step"]
    print(f"train moe ({r['phase_s']:.1f} s): {MOE_ARCH} full width, {MOE_TRAIN_LAYERS} "
          f"layers, {m['n_params']} params, batch {TRAIN_BATCH} x {TRAIN_SEQ}; "
          f"{m['memory_gb']['leaves']} protected leaves ({m['memory_gb']['state']:.2f} GB, "
          f"{m['memory_gb']['parity']:.2f} GB parity); launches {m['launches']}; peak "
          f"{m['peak_mem_gib']:.2f} GiB")
    print(f"train moe: losses {[round(x, 4) for x in m['losses']]}, bitwise equal with "
          f"the blocking and no store; share of expert slabs routed to, each step: "
          f"{m['slabs_routed_share']}")
    print(f"train moe: median step (3-6) overlapped {m['median_step_ms']:.1f} ms, "
          + ", ".join(f"{k} {o['median_step_ms']:.1f} ms" for k, o in r["observe"].items())
          + f"; due ticks {m['due_ticks']}")
    tr = {k: v for k, v in m["trace_steps_7_8"].items() if k != "top_kernels_ms"}
    print(f"train moe: trace of steps 7-8: {tr}")
    print(f"train moe: K3 in the traced due tick: {tr.get('fused_update_us', 'not measured')} "
          f"µs over {tr['fused_update_launches']} launches (PR 20, one launch a leaf: "
          f"{K3_BEFORE['moe due tick']} ms)")
    print(f"train moe: the {sp['tokens']}-token step routed {sp['slabs_routed']} of "
          f"{sp['slabs']} slabs ({sp['slabs_untouched']} untouched: params, m and v "
          f"bit-identical, never marked dirty); its update's K3: {sp['k3_launches']} "
          f"launches over {sp['k3_stripes']} of {sp['stripes_total']} stripes (the "
          f"routed slabs', the embedding rows' and the ALL-dirty leaves'; expert "
          f"leaves {sp['slab_leaf_stripes']}), flush {sp['flush_ms']:.2f} ms; scrub "
          f"clean; full check passed", flush=True)


# ------------------------------------------------------------------ phase 13
def hold_side_stream(store) -> None:
    """Queue a spin of ``SIDE_SLEEP_CYCLES`` on the store's side stream: the
    next due tick's update waits behind it, so it is still in flight on the
    device while the host injects."""
    with torch.cuda.stream(store._side_stream()):
        torch.cuda._sleep(SIDE_SLEEP_CYCLES)


def heap_write(store, state, red, rows, g):
    """The writes of one step of phase 4's heap workload on ``state``:
    ``rows`` of the heap rewritten in place with values from ``g``, the
    params scaled, both recorded.  Returns ``red``."""
    heap, params = state["heap"], state["params"]
    heap.index_copy_(0, rows, torch.randn((rows.numel(), ROW), generator=g,
                                          device=heap.device))
    old = params.clone()
    params.mul_(0.999)
    ev = torch.zeros(N_ROWS, dtype=torch.bool, device=heap.device)
    ev.index_fill_(0, rows, True)
    return store.on_write(red, events={"heap": ev}, old={"params": old},
                          new={"params": params})


def fault_step(store, state, red, rows, g, step):
    """One step of phase 4's heap workload: its writes, then the tick.
    Returns ``(red, report)``."""
    return store.tick(state, heap_write(store, state, red, rows, g), step)


def in_window_specs(window, taken, n: int, rng) -> list:
    """``n`` data bit flips on heap blocks inside ``window``, one a stripe,
    in stripes none of the ``taken`` specs touches."""
    from repro_torch.faults import FaultSpec
    used = {b // STRIPE for s in taken if s.leaf == "heap" for b in s.touched_blocks}
    out = []
    for b in rng.permutation(np.flatnonzero(window.blocks["heap"])):
        if len(out) == n:
            break
        if b // STRIPE not in used:
            used.add(b // STRIPE)
            out.append(FaultSpec("data_bitflip", "heap", block=int(b),
                                 lane=int(rng.integers(ROW)), bit=int(rng.integers(32))))
    check(len(out) == n, f"only {len(out)} window stripes free for in-window faults")
    return out


def flagged(masks) -> set:
    """``{(leaf, block)}`` of every block a scrub's masks flag."""
    return {(k, b) for k, m in masks.items() for b in torch.nonzero(m).flatten().tolist()}


def saved_rows(store, state, specs) -> dict:
    """``{leaf: (block ids, their pre-fault lanes)}`` for every block the
    specs touch."""
    out = {}
    for leaf in sorted({s.leaf for s in specs}):
        ids = torch.tensor(sorted({b for s in specs if s.leaf == leaf
                                   for b in s.touched_blocks}), device=DEVICE)
        out[leaf] = (ids, blocks.to_lanes(state[leaf], store.metas[leaf])[ids].clone())
    return out


def oracle_checks(store, leaves, red, specs, window, saved, label: str) -> dict:
    """Scrub and audit the injected ``leaves`` (the oracle), then repair
    every detected block from parity and rescrub.  A detected block whose
    stripe holds a window block cannot be rebuilt (its parity is stale):
    the repair must refuse it as ``vulnerable_stripe`` and the rescrub
    flag exactly those.  Every rebuilt block equals its pre-fault lanes."""
    from repro_torch.faults import check_detection
    n = lambda d: sum(len(v) for v in d.values())
    report, oracle_ms = timed(lambda: check_detection(store, leaves, red, specs,
                                                      window=window))
    outside = {(s.leaf, b) for s in specs for b in s.touched_blocks
               if not window.contains(s.leaf, b)}
    check(report.ok and n(report.expected) == len(outside),
          f"{label}: oracle {report.summary()}")
    masks, scrub_ms = timed(lambda: store.scrub(leaves, red))
    details: list = []
    (fixed_lv, fixed, lost), repair_ms = timed(
        lambda: store.repair(leaves, red, masks, details=details))
    refused = {(u.leaf, b) for u in details for b in u.blocks}
    check(all(u.reason == "vulnerable_stripe" and window.stripes[u.leaf][u.stripe]
              for u in details),
          f"{label}: a repair refused for another reason than a stale stripe: {details}")
    check(fixed + lost == n(report.detected), f"{label}: fixed {fixed} + lost {lost} "
          f"!= detected {n(report.detected)}")
    for leaf, (ids, want) in saved.items():
        got = blocks.to_lanes(fixed_lv[leaf], store.metas[leaf])[ids]
        same = (got == want).all(dim=1).tolist()
        for b, ok in zip(ids.tolist(), same):
            if b in report.detected.get(leaf, set()) and (leaf, b) not in refused:
                check(ok, f"{label}: {leaf} block {b} not rebuilt bitwise")
    left = flagged(store.scrub(fixed_lv, red))
    check(left == refused, f"{label}: rescrub flags {sorted(left)[:8]}, refused "
          f"{sorted(refused)[:8]}")
    return {"oracle": report.summary(), "detected": n(report.detected),
            "outside": len(outside), "in_window": n(report.in_window),
            "in_window_detected": sum(len(report.detected.get(k, set()) & v)
                                      for k, v in report.in_window.items()),
            "fixed": fixed, "refused_stale_stripe": lost,
            "oracle_ms": oracle_ms, "scrub_ms": scrub_ms, "repair_ms": repair_ms}


def redundancy_faults(store, state, red, window) -> dict:
    """The reference's redundancy-side cases on clean stripes: a checksum
    flip and a meta flip caught by verify_meta (the checksum flip's block
    flagged by scrub, nothing for the meta flip), a parity flip under which
    a repair through its stripe fails the rescrub, and a torn write across
    a stripe boundary with every touched block flagged."""
    from repro_torch.faults import FaultSpec
    clean = np.flatnonzero(~window.stripes["heap"][:-1] & ~window.stripes["heap"][1:])
    s_ck, s_par, s_torn = (int(s) for s in clean[:3])
    ck = FaultSpec("checksum_bitflip", "heap", block=s_ck * STRIPE, bit=31)
    _, red_ck = store.inject(state, red, ck)
    check(not bool(store.verify_meta(red_ck)["heap"]), "checksum flip passed verify_meta")
    check(flagged(store.scrub(state, red_ck)) == {("heap", ck.block)},
          "scrub did not flag exactly the checksum flip's block")
    _, red_mc = store.inject(state, red, FaultSpec("meta_bitflip", "heap", bit=17))
    check(not bool(store.verify_meta(red_mc)["heap"]), "meta flip passed verify_meta")
    check(not flagged(store.scrub(state, red_mc)), "a meta flip made scrub flag blocks")
    b = s_par * STRIPE + 1
    _, red_par = store.inject(state, red, FaultSpec("parity_bitflip", "heap", block=b,
                                                   lane=5, bit=9))
    lv_bad, _ = store.inject(state, red_par, FaultSpec("data_bitflip", "heap", block=b,
                                                      lane=3, bit=2))
    mm = store.scrub(lv_bad, red_par)
    check(flagged(mm) == {("heap", b)}, "scrub did not flag the parity case's block")
    repaired, fixed, lost = store.repair(lv_bad, red_par, mm)
    check((fixed, lost) == (1, 0), f"parity case repair {(fixed, lost)}")
    check(flagged(store.scrub(repaired, red_par)) == {("heap", b)},
          "a repair through a flipped parity row passed the rescrub")
    torn = FaultSpec("torn_write", "heap", block=s_torn * STRIPE + 2,
                     blocks=tuple(range(s_torn * STRIPE + 2, s_torn * STRIPE + 6)))
    lv_t, _ = store.inject(state, red, torn)
    check(flagged(store.scrub(lv_t, red)) == {("heap", x) for x in torn.blocks},
          "the torn write's blocks were not all flagged")
    return {"checksum_block": ck.block, "parity_block": b, "torn_blocks": list(torn.blocks)}


def inflight_redundancy(store, state, red, window) -> dict:
    """While the update is in flight: a checksum flip and a meta flip on
    the live view are caught by verify_meta.  Returns the record and a
    clean stripe whose parity is flipped in a copy of the live view."""
    from repro_torch.faults import FaultSpec
    clean = np.flatnonzero(~window.stripes["heap"])
    s_ck, s_par = int(clean[0]), int(clean[1])
    _, red_ck = store.inject(state, red, FaultSpec("checksum_bitflip", "heap",
                                                  block=s_ck * STRIPE, bit=31))
    _, red_mc = store.inject(state, red, FaultSpec("meta_bitflip", "heap", bit=17))
    _, red_par = store.inject(state, red, FaultSpec("parity_bitflip", "heap",
                                                   block=s_par * STRIPE, lane=5, bit=9))
    caught = [not bool(store.verify_meta(r)["heap"]) for r in (red_ck, red_mc)]
    check(all(caught), f"in flight: verify_meta missed a flip {caught}")
    check(not torch.equal(red_par["heap"].parity[s_par], red["heap"].parity[s_par]),
          "in flight: the parity flip did not land in its copy")
    return {"caught_by_verify_meta": caught, "parity_stripe": s_par}


def adopted_parity(store, state, red, s: int) -> None:
    """After adoption: stripe ``s``'s parity row (flipped in a copy of the
    live view while the update was in flight) equals its plain parity, and
    a data fault in the stripe is rebuilt from it bitwise."""
    from repro_torch.faults import FaultSpec
    meta = store.metas["heap"]
    lanes = blocks.to_lanes(state["heap"], meta)
    check(torch.equal(red["heap"].parity[s],
                      par_ref.stripe_parity(lanes[s * STRIPE:(s + 1) * STRIPE], STRIPE)[0]),
          "the adopted parity row differs from its plain parity")
    b = s * STRIPE + 2
    lv, _ = store.inject(state, red, FaultSpec("data_bitflip", "heap", block=b, lane=3, bit=2))
    fixed_lv, fixed, lost = store.repair(lv, red, store.scrub(lv, red))
    check((fixed, lost) == (1, 0)
          and torch.equal(blocks.to_lanes(fixed_lv["heap"], meta)[b], lanes[b]),
          "a repair through the in-flight parity flip's stripe was not bitwise")


def latency_run(seed: int, state: dict) -> dict:
    """measure_detection_latency over 64 steps of the heap workload on a
    fresh store over ``state``, a scrub every 16: one fault on a block the
    run never writes and one on a block written that step, at each of
    LAT_INJECT.  Then mttdl_measured beside the closed forms at the run's
    time-averaged vulnerable stripes."""
    from repro_torch.core import mttdl
    from repro_torch.faults import FaultSpec
    from repro_torch.faults.oracle import measure_detection_latency
    store = ProtectedStore(heap_policy(async_tick=True)).attach(state)
    meta = store.metas["heap"]
    g = torch.Generator(device=DEVICE).manual_seed(seed + 14)
    plan = [torch.randperm(N_ROWS, generator=g, device=DEVICE)[:ROWS_PER_STEP]
            for _ in range(LAT_STEPS + 1)]
    written = np.zeros(N_ROWS, bool)
    for rows in plan[1:]:
        written[rows.cpu().numpy()] = True
    never = np.flatnonzero(~written)
    rng = np.random.default_rng(seed + 14)
    inject_at = {s: [FaultSpec("data_bitflip", "heap", block=int(rng.choice(never)),
                               lane=int(rng.integers(ROW)), bit=int(rng.integers(32))),
                     FaultSpec("data_bitflip", "heap", block=int(plan[s][0]),
                               lane=int(rng.integers(ROW)), bit=int(rng.integers(32)))]
                 for s in LAT_INJECT}
    vuln, step_s = [], []

    def drive(step, leaves, red):
        if step == 0:
            return state, store.init(state)
        t = time.perf_counter()
        red, _ = fault_step(store, leaves, red, plan[step], g, step)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        vuln.append(int(store.dirty_stats(red)["heap"]["vulnerable_stripes"]))
        return leaves, red

    records = measure_detection_latency(store, drive, inject_at, LAT_STEPS, LAT_SCRUB)
    sec = statistics.median(step_s)
    never_set = set(never.tolist())
    clean = [r for r in records if r.spec.block in never_set]
    hot = [r for r in records if r not in clean]
    for r in clean:
        want = -(-r.injected_step // LAT_SCRUB) * LAT_SCRUB
        check(not r.in_window_at_injection and r.detected_step == want,
              f"clean-block fault at {r.injected_step}: detected at {r.detected_step}, "
              f"want {want}")
    for r in hot:
        check(r.in_window_at_injection and r.detected_step is None,
              f"in-window fault at {r.injected_step}: in window "
              f"{r.in_window_at_injection}, detected at {r.detected_step}")
    lat = mttdl.detection_latency_stats([r.latency_steps for r in clean], step_seconds=sec)
    v_avg = sum(vuln) / len(vuln)
    return {
        "latency_steps": [r.latency_steps for r in clean],
        "latency_s": [r.latency_steps * sec for r in clean],
        "in_window_detected": sum(r.detected_step is not None for r in hot),
        "step_ms_median": sec * 1e3, "vulnerable_stripes_avg": v_avg,
        "total_stripes": meta.n_stripes, "mean_latency_s": lat["mean_s"],
        "mttdl_no_red_s": mttdl.mttdl_no_red(MTTF_BLOCK_S, meta.n_blocks),
        "mttdl_vilamb_s": mttdl.mttdl_vilamb(MTTF_BLOCK_S, v_avg, STRIPE + 1),
        "mttdl_measured_s": mttdl.mttdl_measured(MTTF_BLOCK_S, v_avg, STRIPE + 1,
                                                 meta.n_stripes, lat["mean_s"]),
    }


def sweep_policy() -> RedundancyPolicy:
    """The reference smoke's schedule (period 2, deadline 3) on 4 KiB rows."""
    return RedundancyPolicy.single("vilamb", period_steps=2, max_vulnerable_steps=3,
                                   lanes_per_block=ROW, stripe_data_blocks=STRIPE,
                                   work_queue_frac=0.5, async_tick=True,
                                   precompile=False)


def sweep_leaves(seed: int) -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(seed + 15)
    return {"heap": torch.randn((SWEEP_ROWS, ROW), generator=g, device=DEVICE),
            "e": torch.randn((SWEEP_BF16_ROWS, 2 * ROW), generator=g,
                             device=DEVICE).to(torch.bfloat16)}


def sweep_mutate(rng, step: int, leaves: dict):
    """4,096 random heap rows rewritten and 64 bf16 rows shifted a step (of
    copies), the rows and values drawn from the machine's seeded rng."""
    g = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    out, events = dict(leaves), {}
    for name, n, k in (("heap", SWEEP_ROWS, SWEEP_WRITE_ROWS),
                       ("e", SWEEP_BF16_ROWS, SWEEP_BF16_WRITE_ROWS)):
        idx = torch.as_tensor(np.sort(rng.choice(n, size=k, replace=False)), device=DEVICE)
        v = leaves[name].clone()
        if name == "heap":
            v.index_copy_(0, idx, torch.randn((k, ROW), generator=g, device=DEVICE))
        else:
            v[idx] += 0.25 * step
        out[name] = v
        events[name] = torch.zeros(n, dtype=torch.bool, device=DEVICE).index_fill_(0, idx, True)
    return out, events


def crash_sweep_cut(seed: int, d: str) -> dict:
    """The crash-point sweep on the cut heap (256 MiB + 16 MiB bf16) with
    the reference smoke's schedule, then its two crash-plus-corruption
    cases at the last dispatch crash."""
    from repro_torch.faults import CrashPlan, CrashPointMachine, FaultSpec
    from repro_torch.faults.__main__ import REQUIRED_PHASES
    machine = CrashPointMachine(lambda: ProtectedStore(sweep_policy()).attach(
                                    sweep_leaves(seed)),
                                lambda: sweep_leaves(seed), d, seed=seed, steps=6,
                                scrub_every=5, hold_inflight_steps=(3, 4),
                                mutate=sweep_mutate)
    outcomes = machine.sweep(require_phases=REQUIRED_PHASES)
    bad = [(o.plan, o.classification, o.scrub_after_flush) for o in outcomes
           if not o.ok or o.scrub_after_flush != 0]
    check(not bad, f"crash sweep: {bad}")
    for o in outcomes:
        if o.plan.phase in ("dispatch", "coalesce"):
            check(o.classification != "rejected", f"{o.plan}: restored meta_ck failed")
    plan = [o.plan for o in outcomes if o.plan.phase == "dispatch"][-1]
    window = next(o for o in outcomes if o.plan == plan).window.get("heap", set())
    check(window, "the last dispatch crash holds no window blocks")
    stripes = {b // STRIPE for b in window}
    clean = next(b for b in range(SWEEP_ROWS) if b // STRIPE not in stripes)
    cases = {}
    for where, b in (("outside", clean), ("inside", min(window))):
        o = machine.run_crash(plan, faults=(FaultSpec("data_bitflip", "heap", block=b,
                                                      lane=3, bit=7),))
        want = "recovered_bitwise" if where == "outside" else "lost_within_window"
        check(o.classification == want and o.scrub_after_flush == 0,
              f"crash+corruption {where} the window: {o.classification}")
        cases[where] = o.classification
    by: dict = {}
    for o in outcomes:
        by[o.classification] = by.get(o.classification, 0) + 1
    secs = {k: [o.seconds[k] for o in outcomes] for k in ("drive_s", "save_s", "restore_s")}
    return {"crash_points": len(outcomes), "phases": sorted({o.plan.phase for o in outcomes}),
            "outcomes": by, "corruption": cases,
            "replay_s": {k: {"mean": statistics.mean(v), "max": max(v)}
                         for k, v in secs.items()}}


def phase_faults(seed: int) -> dict:
    """Phase 13: the fault battery on the card (see the module docstring).
    Returns the phase's record (its launch counts under ``launches``)."""
    import shutil
    import tempfile
    from repro_torch.faults import FaultInjector, vulnerability_window
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    rng = np.random.default_rng(seed + 13)
    kinds = ("data_bitflip", "stale_redundancy")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rec: dict = {}
    state = {"heap": torch.randn((N_ROWS, ROW), generator=g, device=dev),
             "params": torch.randn((16384, 1024), generator=g, device=dev)}
    store = ProtectedStore(heap_policy(async_tick=True)).attach(state)
    red = store.init(state)
    group = next(grp for grp in store.groups.values() if "heap" in grp.names)

    def rows():
        return torch.randperm(N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP]

    # b. at the due tick of step 16, with its update held in flight.
    for step in range(1, FAULT_DUE):
        red, _ = fault_step(store, state, red, rows(), g, step)
    hold_side_stream(store)
    red, rep = fault_step(store, state, red, rows(), g, FAULT_DUE)
    pending = group.pending
    check(rep.updated and pending is not None and pending.done is not None
          and not pending.done.query(),
          f"step {FAULT_DUE}: no update in flight after the due tick")
    window = vulnerability_window(store, red)
    inj = FaultInjector(store, seed=seed)
    t = time.perf_counter()
    specs = inj.plan_clean_blocks(red, FAULT_CLEAN, kinds=kinds)
    plan_ms = (time.perf_counter() - t) * 1e3
    specs += in_window_specs(window, specs, FAULT_IN_WINDOW, rng)
    # The injection is issued while the update runs on the side stream and
    # is ordered after it on the device (ProtectedStore.inject); the store
    # must not have adopted it.  (The host may wait for the update inside
    # the injections: PERF.md, section 7.)
    in_flight = pending.done is not None and not pending.done.query()
    check(in_flight, "the update finished before the faults were injected")
    t = time.perf_counter()
    lv2, red2 = inj.inject_many(state, red, specs)
    inject_host_ms = (time.perf_counter() - t) * 1e3
    check(group.pending is pending, "the injection resolved the in-flight update")
    saved = saved_rows(store, state, specs)       # the injection wrote copies
    flight = inflight_redundancy(store, state, red, window)
    red = store.settle(red2, lv2, step=FAULT_DUE)
    check(all(bool(v) for v in store.verify_meta(red).values()),
          "after settle the adopted view fails verify_meta")
    rec["inflight"] = oracle_checks(store, lv2, red, specs, window, saved, "in flight")
    check(rec["inflight"]["in_window_detected"] == FAULT_IN_WINDOW
          and rec["inflight"]["refused_stale_stripe"] == 0,
          f"in flight: {rec['inflight']}")
    adopted_parity(store, state, red, flight["parity_stripe"])
    rec["inflight"].update(flight, plan_clean_ms=plan_ms, inject_host_ms=inject_host_ms,
                           specs=len(specs), pending_unresolved_at_injection=in_flight)
    del lv2, red2

    # a. settled, after step 20.
    for step in range(FAULT_DUE + 1, FAULT_STEPS + 1):
        red, _ = fault_step(store, state, red, rows(), g, step)
    red = store.settle(red, state, step=FAULT_STEPS)
    window = vulnerability_window(store, red)
    inj = FaultInjector(store, seed=seed + 1)
    specs = inj.plan_clean_blocks(red, FAULT_CLEAN, kinds=kinds)
    specs += in_window_specs(window, specs, FAULT_IN_WINDOW, rng)
    (lv2, _), inject_ms = timed(lambda: inj.inject_many(state, red, specs))
    saved = saved_rows(store, state, specs)
    rec["settled"] = oracle_checks(store, lv2, red, specs, window, saved, "settled")
    check(rec["settled"]["in_window_detected"] == 0, f"settled: {rec['settled']}")
    rec["settled"].update(inject_ms_per_fault=inject_ms / len(specs), specs=len(specs),
                          window_blocks=int(window.blocks["heap"].sum()),
                          window_stripes=window.n_vulnerable_stripes())
    del lv2
    rec["redundancy"] = redundancy_faults(store, state, red, window)
    del store, red, saved
    torch.cuda.empty_cache()

    # c. detection latency and MTTDL.
    rec["latency"] = latency_run(seed, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # d. the crash sweep on the cut heap.
    d = tempfile.mkdtemp(prefix="vilamb_crash_")
    try:
        free_gb = shutil.disk_usage(d).free / 1e9
        check(free_gb > SWEEP_DISK_GB, f"phase 13 needs {SWEEP_DISK_GB} GB on disk "
              f"in {d}; {free_gb:.1f} GB are free")
        rec["sweep"] = crash_sweep_cut(seed, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    rec["launches"] = read_launches()
    for name in ("checksum", "parity", "fused_update"):
        check(rec["launches"][name] > 0, f"{name} kernel never launched in phase 13")
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30

    # e. the battery's entry point, on the card, in a process of its own.
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.faults", "--smoke"],
                         capture_output=True, text=True, env=env, timeout=600,
                         cwd=str(Path(__file__).resolve().parent))
    rec["cli"] = {"rc": cli.returncode, "s": time.perf_counter() - t,
                  "lines": cli.stdout.strip().splitlines()}
    check(cli.returncode == 0 and "fault battery OK" in cli.stdout,
          f"python -m repro_torch.faults --smoke exited {cli.returncode}: "
          f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    sharded = [ln for ln in rec["cli"]["lines"] if ln.startswith("  sharded ")]
    check(len(sharded) == 9 and "OK" in sharded[0]
          and all(ln.endswith("recovered_bitwise OK") for ln in sharded[1:8])
          and sharded[8].startswith("  sharded shard-loss rebuild seed=0: status=")
          and sharded[8].endswith("clean=True bitwise=True OK"),
          f"the battery's sharded pass printed {sharded}")
    # The chaos soak's entry point at the reference's size, likewise.
    t = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.faults", "--chaos", "--smoke"],
                         capture_output=True, text=True, env=env, timeout=600,
                         cwd=str(Path(__file__).resolve().parent))
    lines = cli.stdout.strip().splitlines()
    rec["chaos_cli"] = {"rc": cli.returncode, "s": time.perf_counter() - t,
                        "lines": [ln for ln in lines if not ln.startswith("  chaos phase ")]}
    soak = [ln for ln in lines if ln.startswith("  chaos soak: ")]
    check(cli.returncode == 0 and len(soak) == 1 and soak[0].endswith(" OK")
          and lines[-1].startswith("== chaos soak OK in "),
          f"python -m repro_torch.faults --chaos --smoke exited {cli.returncode}: "
          f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


def print_faults(rec: dict) -> None:
    """Phase 13's lines."""
    print(f"faults ({rec['wall_s']:.1f} s): launches {rec['launches']}; peak "
          f"{rec['peak_mem_gb']:.2f} GiB")
    for key in ("inflight", "settled"):
        r = {k: (round(v, 3) if isinstance(v, float) else v) for k, v in rec[key].items()}
        print(f"faults: 8 GiB heap, {key}: {r}")
    print(f"faults: redundancy-side (settled): {rec['redundancy']}")
    lat = rec["latency"]
    print(f"faults: detection latency (scrub every {LAT_SCRUB}): "
          f"{lat['latency_steps']} steps = {[round(x, 4) for x in lat['latency_s']]} s at "
          f"{lat['step_ms_median']:.2f} ms a step; in-window faults detected "
          f"{lat['in_window_detected']} of {len(LAT_INJECT)}")
    print(f"faults: MTTDL at V = {lat['vulnerable_stripes_avg']:.1f} of "
          f"{lat['total_stripes']} stripes (MTTF_block {MTTF_BLOCK_S:g} s): measured "
          f"{lat['mttdl_measured_s']:.6g} s, vilamb {lat['mttdl_vilamb_s']:.6g} s, no "
          f"redundancy {lat['mttdl_no_red_s']:.6g} s (uplift "
          f"{lat['mttdl_measured_s'] / lat['mttdl_no_red_s']:.1f}x measured, "
          f"{lat['mttdl_vilamb_s'] / lat['mttdl_no_red_s']:.1f}x closed form)")
    sw = rec["sweep"]
    print(f"faults: crash sweep on 256 MiB + 16 MiB bf16: {sw['crash_points']} crash "
          f"points over {len(sw['phases'])} phases, outcomes {sw['outcomes']}, with "
          f"corruption {sw['corruption']}; per replay (s) {sw['replay_s']}")
    for line in rec["cli"]["lines"]:
        print(f"faults: cli | {line}")
    print(f"faults: chaos cli ({rec['chaos_cli']['s']:.1f} s)")
    for line in rec["chaos_cli"]["lines"]:
        print(f"faults: chaos cli | {line}")


def patrol_plan(g, steps: int) -> tuple:
    """``steps + 1`` steps of 4,096 random heap rows from ``g`` (index 0
    unused), and the host mask of the stripes none of them touches."""
    dev = torch.device(DEVICE)
    plan = [torch.randperm(N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP]
            for _ in range(steps + 1)]
    touched = torch.zeros(N_ROWS // STRIPE, dtype=torch.bool, device=dev)
    for rows in plan[1:]:
        touched.index_fill_(0, rows // STRIPE, True)
    return plan, (~touched).cpu().numpy()


def patrol_run(seed: int, state: dict, budget: int, g) -> dict:
    """Phase 14a at one byte budget: the heap workload under a store whose
    patroller checksums ``budget`` bytes a probe (no scheduled scrub).
    After PATROL_SETTLE steps and a settle, PATROL_FAULTS data bit flips
    from ``plan_clean_blocks`` on stripes the run never writes; ticks until
    the patrol alone has detected and repaired each one and finished a
    sweep, within two sweeps plus 16 ticks.  Every probe is compared in
    its tick's report: no mismatch but the faults'.  Then 8 steps with the
    patroller set aside (the quiet tick without a probe), a flush, a clean
    scrub and every faulted row equal to its pre-fault bytes."""
    from repro_torch.faults import FaultInjector
    dev = torch.device(DEVICE)
    store = ProtectedStore(dataclasses.replace(heap_policy(async_tick=True),
                                               patrol_bytes_per_tick=budget)).attach(state)
    red = store.init(state)
    pat, meta = store.patroller, store.metas["heap"]
    w = pat.window["heap"]
    check(pat.targets == ["heap"] and w == budget // (ROW * 4),
          f"patrol targets {pat.targets}, window {w}")
    # A sweep in ticks: two a probe (its dispatch, then the tick its masks
    # land on: the foreground's queue holds the probe's event past the
    # next tick), none on the busy tick of each period.
    sweep_ticks = math.ceil(2 * -(-meta.n_blocks // w) * PERIOD / (PERIOD - 1))
    budget_ticks = 2 * sweep_ticks + 16
    plan, never = patrol_plan(g, PATROL_SETTLE + budget_ticks + 8)
    ticks: list = []

    def step_(step):
        nonlocal red
        red = heap_write(store, state, red, plan[step], g)
        t = time.perf_counter()
        red, rep = store.tick(state, red, step)
        ticks.append({"step": step, "ms": (time.perf_counter() - t) * 1e3,
                      "updated": bool(rep.updated), "probe": bool(rep.patrolled),
                      "repaired": bool(rep.repaired), "mismatches": rep.patrol_mismatches})
        state.update(rep.repaired)
        return rep

    for step in range(1, PATROL_SETTLE + 1):
        step_(step)
    red = store.settle(red, state, step=PATROL_SETTLE)
    inj = FaultInjector(store, seed=seed)
    # A whole budget of writes leaves ~1% of the stripes untouched: plan
    # enough candidates to find PATROL_FAULTS among them.
    specs = [s for s in inj.plan_clean_blocks(red, 4096, kinds=("data_bitflip",))
             if s.leaf == "heap" and never[s.block // STRIPE]][:PATROL_FAULTS]
    check(len(specs) == PATROL_FAULTS, f"only {len(specs)} clean blocks on stripes "
          "the run never writes")
    ids = torch.tensor([s.block for s in specs], device=dev)
    saved = state["heap"][ids].clone()
    lv, red = inj.inject_many(state, red, specs)
    state.update(lv)
    del lv
    check(not torch.equal(state["heap"][ids], saved), "the faults did not land")
    for s in specs:
        pat.expect_injection("heap", s.block, PATROL_SETTLE)
    cursor0 = pat.cursor["heap"]
    k1_before = ck_ops.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = PATROL_SETTLE
    while not (len(pat.latencies) == PATROL_FAULTS and not pat._repair_queue
               and pat.coverage()["heap"] == 1.0):
        step += 1
        check(step <= PATROL_SETTLE + budget_ticks,
              f"patrol at {budget >> 20} MiB: {len(pat.latencies)} of {PATROL_FAULTS} "
              f"faults detected, {len(pat._repair_queue)} queued, coverage "
              f"{pat.coverage()['heap']:.3f} after {budget_ticks} ticks "
              f"({sum(t['probe'] for t in ticks[PATROL_SETTLE:])} probes; cursor "
              f"{cursor0} at injection, {pat.cursor['heap']} now; undetected "
              f"{sorted(b for _, b in pat._expected)})")
        step_(step)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop = ticks[PATROL_SETTLE:]
    k1 = ck_ops.LAUNCHES - k1_before
    probes = sum(t["probe"] for t in loop)
    mism = sum(t["mismatches"] for t in loop)
    check(mism == PATROL_FAULTS, f"patrol at {budget >> 20} MiB: {mism} mismatches for "
          f"{PATROL_FAULTS} faults")
    check(not pat.unrecoverable, f"unrecoverable: {pat.unrecoverable}")
    check(k1 >= probes > 0, f"{k1} checksum launches for {probes} probes")
    aside, store.patroller = store.patroller, None
    for _ in range(8):
        step += 1
        step_(step)
    store.patroller = aside
    red = store.flush(state, red, step)
    check(store.scrub_check(state, red) == 0, "scrub after the patrol's repairs not clean")
    check(torch.equal(state["heap"][ids], saved), "a faulted row was not rebuilt bitwise")
    step_s = loop_s / len(loop)
    lat = pat.latency_stats(step_seconds=step_s)
    quiet = lambda pred: [t["ms"] for t in pred]
    probe_ms = quiet(t for t in loop if t["probe"] and not t["updated"] and not t["repaired"])
    bare_ms = quiet(t for t in ticks[-8:] if not t["updated"])
    repair_ms = quiet(t for t in loop if t["repaired"])
    # K1 on one window at the main path's shape, outside the counts.
    lanes = state["heap"].view(torch.int32)
    start = meta.n_blocks - w
    win = lanes[start:]
    with uncounted():
        got = ck_ops.block_checksums(win, start)
        check(torch.equal(got, ck_ref.block_checksums(win, start))
              and torch.equal(got, red["heap"].checksums[start:]),
              "the probe window's checksums differ from the plain version's")
        k1_ms = per_call_ms(lambda: ck_ops.block_checksums(win, start), 20)
        plain_ms = per_call_ms(lambda: ck_ref.block_checksums(win, start), 2)
    k1_bound, k1_by = bound(*CA.checksum_work(w, ROW))
    del store, red, aside, saved
    return {"budget_mib": budget >> 20, "window_blocks": w, "sweep_ticks_est": sweep_ticks,
            "tick_budget": budget_ticks, "ticks": len(loop), "probes": probes,
            "cursor_at_injection": cursor0,
            "k1_launches": k1, "blocks_patrolled": pat.blocks_scanned,
            "mismatches": mism, "latency_ticks": list(pat.latencies),
            "latency_s": [x * step_s for x in pat.latencies], "step_ms": step_s * 1e3,
            "mean_latency_s": lat["mean_s"], "max_latency_s": lat["max_s"],
            "quiet_tick_probe_host_ms_median": statistics.median(probe_ms),
            "quiet_tick_no_patrol_host_ms_median": statistics.median(bare_ms),
            "repair_tick_host_ms": repair_ms,
            "k1_window_ms": k1_ms, "k1_window_plain_ms": plain_ms,
            "k1_window_bound_ms": k1_bound, "k1_window_bound_by": k1_by}


def held_probe(seed: int, state: dict, g) -> dict:
    """Phase 14b: the due update of step 16 held behind a spin on the side
    stream; the quiet tick of step 17 dispatches a probe of a window that
    holds a corrupted clean block.  The tick must return without waiting
    for the update (still in flight after it).  The tick of step 18 lands
    the probe and repairs the block: the repair's stripe check reads on the
    host after ordering the stream after the update, so that tick waits
    for it (recorded).  The probe's verdicts equal a plain recompute of the
    window (its lanes copied before the repair) against the checksums once
    the update finished, and the row is rebuilt bitwise."""
    from repro_torch.faults import FaultSpec
    store = ProtectedStore(dataclasses.replace(
        heap_policy(async_tick=True), patrol_bytes_per_tick=PATROL_BUDGETS[0])).attach(state)
    red = store.init(state)
    pat, meta = store.patroller, store.metas["heap"]
    w = pat.window["heap"]
    plan, _ = patrol_plan(g, FAULT_DUE + 2)
    written = torch.zeros(N_ROWS, dtype=torch.bool, device=DEVICE)
    for rows in plan[1:]:
        written.index_fill_(0, rows, True)
    for step in range(1, FAULT_DUE):
        red, _ = fault_step(store, state, red, plan[step], g, step)
    # A block of the probe's window whose whole stripe the run never
    # writes: its repair at step 18 must not be refused as vulnerable.
    start = min(pat.cursor["heap"], meta.n_blocks - w)
    quiet = (~stripe_mask(written, STRIPE)).repeat_interleave(STRIPE)[:N_ROWS]
    blk = start + int(torch.nonzero(quiet[start:start + w])[0])
    before = state["heap"][blk].clone()
    lv, red = store.inject(state, red, FaultSpec("data_bitflip", "heap", block=blk,
                                                 lane=5, bit=13))
    state.update(lv)
    del lv
    red = heap_write(store, state, red, plan[FAULT_DUE], g)
    hold_side_stream(store)
    red, rep = store.tick(state, red, FAULT_DUE)
    pending = next(grp for grp in store.groups.values() if "heap" in grp.names).pending

    def held():
        return pending is not None and pending.done is not None and not pending.done.query()
    check(rep.updated and held(), "no update held in flight at the due tick")
    red = heap_write(store, state, red, plan[FAULT_DUE + 1], g)
    t = time.perf_counter()
    red, rep = store.tick(state, red, FAULT_DUE + 1)
    tick_ms = (time.perf_counter() - t) * 1e3
    in_flight = held()
    check(rep.patrolled == ("heap",), f"no probe at step {FAULT_DUE + 1}: {rep}")
    check(in_flight, "the probe tick returned after the held update had finished")
    _, p_start, p_w, masks, done, _, _ = pat._probe
    if done is not None:
        done.synchronize()                # the probe's own event, on the tick's stream
    check(held(), "the probe's masks landed after the held update")
    got = masks.clone()
    window = state["heap"][p_start:p_start + p_w].clone()
    view = red["heap"]
    red = heap_write(store, state, red, plan[FAULT_DUE + 2], g)
    t = time.perf_counter()
    red, rep = store.tick(state, red, FAULT_DUE + 2)
    repair_ms = (time.perf_counter() - t) * 1e3
    repair_in_flight = held()
    found = [(d.leaf, d.block, d.step) for d in pat.detections]
    check(list(rep.repaired) == ["heap"] and found == [("heap", blk, FAULT_DUE + 2)],
          f"step {FAULT_DUE + 2}: repaired {list(rep.repaired)}, detections {found}")
    torch.cuda.synchronize()
    clean = ~bits.unpack(view.dirty | view.shadow, meta.n_blocks)[p_start:p_start + p_w]
    fresh = ck_ref.block_checksums(window.view(torch.int32), p_start)
    mism = clean & (fresh != view.checksums[p_start:p_start + p_w])
    check(p_start == start and torch.equal(got[0], mism.cpu())
          and torch.equal(got[1], clean.cpu()),
          "the probe's verdicts under the held update differ from the plain recompute")
    flagged_blocks = (torch.nonzero(got[0]).flatten() + p_start).tolist()
    check(flagged_blocks == [blk], f"the probe flagged {flagged_blocks}, want [{blk}]")
    check(torch.equal(state["heap"][blk], before), "the probed row was not rebuilt bitwise")
    red = store.settle(red, state, step=FAULT_DUE + 2)
    check(all(bool(v) for v in store.verify_meta(red).values()),
          "verify_meta after the held probe")
    return {"probe_tick_host_ms": tick_ms, "update_in_flight_after": in_flight,
            "repair_tick_host_ms": repair_ms,
            "update_in_flight_after_repair_tick": repair_in_flight,
            "window": [start, start + w], "corrupted_block": blk,
            "clean_in_window": int(got[1].sum())}


def governor_ladder(seed: int, g) -> dict:
    """Phase 14c: the health governor on the 8 GiB heap (vilamb T=16,
    deadline 32, the overlapped tick) beside a blocking twin fed the same
    admitted writes, with the update of step 16 held behind GOV_SPINS spins
    on the side stream.  Steps 17-47 run fast: the held update coalesces
    the due tick of 32, and the margin at 47 forces its resolve (rung 2).
    Each of the next ticks comes after a host sleep longer than
    ``dispatch_timeout_s``: the still-held re-dispatch is abandoned and
    retried (rung 1) until the retries run out, and then the breaker goes
    CRITICAL, ``on_write`` raises BackpressureError (rung 3, the step's
    write is skipped in both stores) and the group runs a blocking update
    every tick (rung 4) until it is HEALTHY again.  Then an excursion forced
    on the group's clock must show on the report's violations.  verify_meta
    holds after every tick from step 47 on (earlier it would order the
    foreground after the held update) and at the end, and after flush every
    field and the heap equal the twin's bitwise."""
    from repro_torch.core.store import TickReport
    from repro_torch.health import (CRITICAL, HEALTHY, BackpressureError,
                                    HealthPolicy)
    dev = torch.device(DEVICE)
    hp = HealthPolicy(dispatch_timeout_s=GOV_TIMEOUT_S, backpressure="error",
                      violation_mode="report")
    pol = RedundancyPolicy.single("vilamb", period_steps=PERIOD,
                                  max_vulnerable_steps=DEADLINE, lanes_per_block=ROW,
                                  stripe_data_blocks=STRIPE, health=hp)
    heap = torch.randn((N_ROWS, ROW), generator=g, device=dev)
    state, twin_state = {"heap": heap}, {"heap": heap.clone()}
    store = ProtectedStore(pol).attach(state)
    twin = ProtectedStore(dataclasses.replace(pol, async_tick=False, health=None)
                          ).attach(twin_state)
    with uncounted():
        tred = twin.init(twin_state)
    red = store.init(state)
    hg, group = store._health, next(iter(store.groups.values()))
    label = group.label
    rec: dict = {"actions": [], "states": [], "rejected": [], "blocking": [],
                 "sleeps_s": []}
    metas = []
    sleepy = False
    step = 0
    while True:
        step += 1
        check(step <= GOV_MAX_STEPS, f"the ladder did not recover in {GOV_MAX_STEPS} "
              f"steps: {rec['states'][-8:]}")
        rows = torch.randperm(N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP]
        vals = torch.randn((ROWS_PER_STEP, ROW), generator=g, device=dev)
        ev = torch.zeros(N_ROWS, dtype=torch.bool, device=dev).index_fill_(0, rows, True)
        try:
            red = store.on_write(red, events={"heap": ev})
        except BackpressureError as e:
            check(label in e.groups, f"backpressure names {e.groups}")
            rec["rejected"].append(step)
        else:
            state["heap"].index_copy_(0, rows, vals)
            twin_state["heap"].index_copy_(0, rows, vals)
            with uncounted():
                tred = twin.on_write(tred, events={"heap": ev})
        if step == FAULT_DUE:
            for _ in range(GOV_SPINS):
                hold_side_stream(store)
        if sleepy:
            time.sleep(GOV_TIMEOUT_S * 1.2)
            rec["sleeps_s"].append(GOV_TIMEOUT_S * 1.2)
        escalated = hg.is_sync_escalated(label)
        red, rep = store.tick(state, red, step)
        with uncounted():
            tred, _ = twin.tick(twin_state, tred, step)
        kinds = [a.kind for a in rep.health.actions]
        rec["actions"] += [(step, a.rung, a.kind) for a in rep.health.actions]
        rec["states"].append(rep.health.states[label])
        if escalated:
            check(label in rep.updated, f"step {step}: sync-escalated without an update")
            rec["blocking"].append(step)
        if "forced_resolve" in kinds:
            sleepy = True                 # rung 1 from here: ticks after the timeout
        if "retry_exhausted" in kinds:
            sleepy = False
        if step >= FAULT_DUE + DEADLINE - 1:
            metas.append(torch.stack([v.reshape(()) for v in store.verify_meta(red).values()]))
        if rec["blocking"] and rep.health.states[label] == HEALTHY and step % PERIOD == 0:
            break
    kinds = {k for _, _, k in rec["actions"]}
    for want in ("forced_resolve", "retry_timeout", "retry_exhausted", "backpressure_on",
                 "sync_escalate", "backpressure_off"):
        check(want in kinds, f"the ladder never fired {want}: {rec['actions']}")
    check(rec["rejected"], "on_write never raised BackpressureError")
    check(CRITICAL in rec["states"] and rec["states"][-1] == HEALTHY,
          f"breaker states {rec['states']}")
    # An excursion forced on the clock: the age audit must report it.
    now = time.monotonic()
    group.last_update_step = step - DEADLINE - 1
    hg.begin_tick(step, now)
    audit = TickReport(step=step)
    hg.end_tick(audit, step, now)
    v = audit.health.violations
    check(len(v) == 1 and v[0].group == label and v[0].age_steps == DEADLINE + 1
          and audit.health.states[label] == CRITICAL,
          f"the forced excursion was not reported: {audit.health}")
    rec["violation"] = {"age_steps": v[0].age_steps, "deadline_steps": v[0].deadline_steps}
    red = store.flush(state, red, step)
    with uncounted():
        tred = twin.flush(twin_state, tred, step)
    metas.append(torch.stack([v.reshape(()) for v in store.verify_meta(red).values()]))
    check(bool(torch.stack(metas).all()), "verify_meta alarmed during the ladder")
    check(torch.equal(state["heap"], twin_state["heap"]), "the heap differs from the twin's")
    for f in ("checksums", "parity", "dirty", "shadow", "meta_ck"):
        check(torch.equal(getattr(red["heap"], f), getattr(tred["heap"], f)),
              f"after flush heap.{f} differs from the blocking twin's")
    rec.update(steps=step, verify_meta_checks=len(metas), alarms=store.corruption_alarms)
    return rec


def phase_patrol(seed: int, faults: dict) -> dict:
    """Phase 14: the scrub patroller and the health governor (see the
    module docstring).  ``faults`` is phase 13's record: its latency run's
    V and scheduled-scrub MTTDL sit beside the patrol's.  Returns the
    phase's record (its launch counts under ``launches``)."""
    from repro_torch.core import mttdl
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state = {"heap": torch.randn((N_ROWS, ROW), generator=g, device=dev),
             "params": torch.randn((16384, 1024), generator=g, device=dev)}
    rec: dict = {"runs": [patrol_run(seed, state, b, g) for b in PATROL_BUDGETS]}
    rec["held"] = held_probe(seed, state, g)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    rec["ladder"] = governor_ladder(seed, g)
    torch.cuda.synchronize()
    rec["launches"] = read_launches()
    for name in ("checksum", "parity", "fused_update"):
        check(rec["launches"][name] > 0, f"{name} kernel never launched in phase 14")
    lat = faults["latency"]
    n_stripes = lat["total_stripes"]
    rec["scrub_every_16"] = {"mean_latency_s": lat["mean_latency_s"],
                             "mean_latency_steps": statistics.mean(lat["latency_steps"]),
                             "mttdl_measured_s": lat["mttdl_measured_s"],
                             "vulnerable_stripes_avg": lat["vulnerable_stripes_avg"]}
    for r in rec["runs"]:
        r["mttdl_measured_s"] = mttdl.mttdl_measured(
            MTTF_BLOCK_S, lat["vulnerable_stripes_avg"], STRIPE + 1, n_stripes,
            r["mean_latency_s"])
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


def print_patrol(rec: dict) -> None:
    """Phase 14's lines."""
    print(f"patrol ({rec['wall_s']:.1f} s): launches {rec['launches']}; peak "
          f"{rec['peak_mem_gb']:.2f} GiB")
    s16 = rec["scrub_every_16"]
    for r in rec["runs"]:
        print(f"patrol at {r['budget_mib']} MiB a probe ({r['window_blocks']} blocks, "
              f"~{r['sweep_ticks_est']} ticks a sweep): {PATROL_FAULTS} faults detected and "
              f"rebuilt bitwise in {r['ticks']} ticks ({r['probes']} probes, {r['k1_launches']} "
              f"checksum launches, {r['mismatches']} mismatches); latency "
              f"{r['latency_ticks']} ticks, mean {r['mean_latency_s'] * 1e3:.2f} ms at "
              f"{r['step_ms']:.3f} ms a step (scrub every 16: mean "
              f"{s16['mean_latency_steps']:.1f} steps, {s16['mean_latency_s'] * 1e3:.2f} ms)")
        print(f"patrol at {r['budget_mib']} MiB: quiet tick host ms with a probe "
              f"{r['quiet_tick_probe_host_ms_median']:.4f}, without "
              f"{r['quiet_tick_no_patrol_host_ms_median']:.4f}; repair ticks "
              f"{[round(x, 3) for x in r['repair_tick_host_ms']]}; K1 on a window "
              f"{r['k1_window_ms']:.4f} ms against a {r['k1_window_bound_ms']:.4f} ms bound "
              f"({r['k1_window_bound_by']}), plain {r['k1_window_plain_ms']:.3f} ms; MTTDL at "
              f"V = {s16['vulnerable_stripes_avg']:.1f}: patrol {r['mttdl_measured_s']:.6g} "
              f"s, scrub every 16 {s16['mttdl_measured_s']:.6g} s")
    print(f"patrol: probe under the held update: {rec['held']}")
    lad = rec["ladder"]
    print(f"governor: {lad['steps']} steps; actions {lad['actions']}; rejected writes "
          f"{lad['rejected']}; blocking updates {lad['blocking']}; forced excursion "
          f"{lad['violation']}; {lad['verify_meta_checks']} verify_meta checks, all clean; "
          f"fields equal to the blocking twin's after flush")


# ----------------------------------------------------------- phases 15-16
def hybrid_config():
    """jamba-1.5-large-398b at its published widths, cut to one group of
    HYBRID_LAYERS layers and HYBRID_EXPERTS experts a MoE layer."""
    cfg = get_arch(HYBRID_ARCH)
    got = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv, cfg.dt_rank, cfg.n_heads,
           cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.padded_vocab,
           cfg.tie_embeddings, cfg.n_experts, cfg.top_k, cfg.capacity_factor,
           cfg.group_size, cfg.param_dtype)
    check(got == (8192, 16384, 16, 4, 512, 64, 8, 128, 24576, 65536, 65536, False, 16, 2,
                  1.25, 8, "bfloat16"), f"{HYBRID_ARCH} is not at full width: {got}")
    return dataclasses.replace(cfg, n_layers=HYBRID_LAYERS, n_experts=HYBRID_EXPERTS)


def xlstm_config():
    """xlstm-1.3b as published: full width and depth."""
    cfg = get_arch(XLSTM_ARCH)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size, cfg.padded_vocab,
           cfg.group_size, cfg.slstm_every, cfg.tie_embeddings, cfg.param_dtype)
    check(got == (48, 2048, 4, 50304, 51200, 8, 8, False, "bfloat16"),
          f"{XLSTM_ARCH} is not at full size: {got}")
    return cfg


def capture_flash(keep=None):
    """Wrap the flash wrapper so that each call keeps clones of its q, k and
    v and its ``causal`` flag (the launch count is the wrapper's own), or
    None for a call whose index is not in ``keep`` (default: every call);
    returns the list and a function that puts the wrapper back."""
    calls: list = []
    launch = fa_ops.flash_attention

    def record(q, k, v, causal=True, **kw):
        calls.append((q.clone(), k.clone(), v.clone(), causal)
                     if keep is None or len(calls) in keep else None)
        return launch(q, k, v, causal=causal, **kw)

    def restore():
        fa_ops.flash_attention = launch
    fa_ops.flash_attention = record
    return calls, restore


def mixer_split(model, params, batch) -> dict:
    """One prefill with CUDA events around every recurrent mixer's call:
    ms by mixer kind (the calls of a launch-bound mixer include the host's
    time between its launches), beside the prefill's total."""
    from repro_torch.models import transformer as tfm
    saved = dict(tfm.RECURRENT)
    spans: dict = {k: [] for k in saved}

    def wrap(kind, fn):
        def inner(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            spans[kind].append((s, e))
            return out
        return inner

    for k, (init, apply, decode) in saved.items():
        tfm.RECURRENT[k] = (init, wrap(k, apply), decode)
    try:
        with torch.inference_mode():
            _, total_ms = timed(lambda: model.prefill(params, batch, PROMPT + GEN + 1))
        torch.cuda.synchronize()
    finally:
        tfm.RECURRENT.update(saved)
    out = {f"{k}_ms": sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items() if v}
    out.update({f"{k}_calls": len(v) for k, v in spans.items() if v})
    out["prefill_ms"] = total_ms
    return out


def fields_equal(red: dict, twin: dict, what: str) -> None:
    """Every field of every leaf bitwise equal (read on the current stream,
    which ``settle`` or ``flush`` ordered after any update)."""
    check(set(red) == set(twin), f"{what}: leaves differ")
    for n in red:
        for f in ("checksums", "parity", "dirty", "shadow", "meta_ck"):
            check(torch.equal(getattr(red[n], f), getattr(twin[n], f)),
                  f"{what}: {n}.{f} differs from the blocking twin's")


def k3_all_dirty(store, leaves: dict, red: dict, names: list, before_ms: float) -> dict:
    """K3 over every block of the ALL-dirty leaves ``names`` (a due tick's
    update of them: one grouped launch), after a flush: bitwise equal to
    its plain version and to the flushed checksums and parity, timed,
    beside the plain version's time, the bound and ``before_ms`` (PR 20's
    16 or 14 launches, one a leaf)."""
    jobs, plain, n_bytes, ops, stripes = [], [], 0, 0, 0
    for n in names:
        meta = store.metas[n]
        lanes = blocks.to_lanes(leaves[n], meta)
        nb, L = lanes.shape
        words = bits.pack_mask(torch.ones(nb, dtype=torch.bool, device=DEVICE))
        ns = -(-nb // STRIPE)
        jobs.append((lanes, red[n].checksums.clone(), red[n].parity.clone(), words))
        plain.append((lanes, red[n].checksums.clone(), red[n].parity.clone(), words))
        # Every stripe's members read, its parity row written, every
        # checksum written, the packed words read.
        b, o = CA.fused_update_work(ns, STRIPE, L, words.numel(), checksums=nb)
        n_bytes, ops = n_bytes + b, ops + o
        stripes += ns
    want = fu_ref.fused_update_many(plain, STRIPE)
    got = fu_ops.fused_update_many(jobs, STRIPE)
    for n, (gc, gp), (wc, wp) in zip(names, got, want):
        check(torch.equal(gc, wc) and torch.equal(gp, wp) and torch.equal(gc, red[n].checksums)
              and torch.equal(gp, red[n].parity),
              f"K3 over the ALL-dirty {n} differs from its plain version or the flush")
    del want, plain

    def tick_k3():
        fu_ops.fused_update_many(jobs, STRIPE)

    def tick_plain():
        fu_ref.fused_update_many(jobs, STRIPE)
    ms, plain_ms = per_call_ms(tick_k3, 10), per_call_ms(tick_plain, 2)
    # The launch's own device time: CUDA events around one tick's call
    # queued behind a spin, so that the wrapper's host work (which can
    # outlast the kernel at these sizes) is done before the first event
    # fires; the median of five.  It includes the wrapper's zero-fill of
    # the launch's ticket.
    want_launches = -(-len(jobs) // fu_ops.max_jobs())
    device = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        tick_k3()
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b))
    device_ms = statistics.median(device)
    bms, by = bound(n_bytes, ops)
    return {"leaves": len(names), "stripes": stripes, "gb": n_bytes / 1e9,
            "wrapper_ms": ms, "device_ms": device_ms, "device_ms_runs": device,
            "launches": want_launches, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "share_of_bound": bms / device_ms, "pr20_ms": before_ms}


def corrupt_and_repair(g, store, caches: dict, red: dict, names: list):
    """After a flush: one flipped lane in each leaf of ``names``, found by a
    scrub there and nowhere else, each block rebuilt from parity bitwise; a
    leaf whose lane view is a padded copy is rebuilt into a new tensor,
    adopted into the caches as ``Server.generate`` adopts a repair
    (``Server._adopt``); a clean rescrub.  Returns the caches and a record."""
    leaves = flatten_dict(caches)
    saved, bad = {}, {}
    for name in names:
        L = store.metas[name].lanes_per_block
        words = leaves[name].view(-1).view(torch.int32)
        b = int(torch.randint(0, max(1, words.numel() // L), (1,), generator=g, device=DEVICE))
        lane = int(torch.randint(0, min(L, words.numel() - b * L), (1,), generator=g,
                                 device=DEVICE))
        saved[name] = words[b * L:(b + 1) * L].clone()
        words[b * L + lane] ^= 0xBAD
        bad[name] = b
    masks, scrub_ms = timed(lambda: store.scrub(leaves, red))
    flagged = {n: torch.nonzero(m).flatten().tolist() for n, m in masks.items()}
    check(all(flagged[n] == ([bad[n]] if n in bad else []) for n in flagged),
          f"scrub flagged { {n: v for n, v in flagged.items() if v} }, expected {bad}")
    out = {"corrupted_blocks": bad, "scrub_ms": scrub_ms, "recover_ms": {},
           "adopted": []}
    for name, b in bad.items():
        leaf = leaves[name]
        (fixed, ok), out["recover_ms"][name] = timed(
            lambda: store.recover_block(leaf, red[name], name, b))
        check(ok, f"recover_block refused block {b} of {name}")
        if fixed.data_ptr() != leaf.data_ptr():
            caches = Server._adopt(caches, {name: fixed})
            check(flatten_dict(caches)[name] is fixed, f"{name}: the repair not adopted")
            out["adopted"].append(name)
        L = store.metas[name].lanes_per_block
        words = flatten_dict(caches)[name].view(-1).view(torch.int32)
        check(torch.equal(words[b * L:(b + 1) * L], saved[name]),
              f"the rebuilt block {b} of {name} differs from the original")
    leaves = flatten_dict(caches)
    masks, out["rescrub_ms"] = timed(lambda: store.scrub(leaves, red))
    check(sum(int(m.sum()) for m in masks.values()) == 0, "rescrub after repair flags blocks")
    check(all(bool(v) for v in store.verify_meta(red).values()), "verify_meta failed")
    return caches, out


def phase_serve_recurrent(g, cfg, n_params_want: int, corrupt: list,
                          turns: bool) -> dict:
    """Phases 15 and 16: serve ``cfg`` with every cache under vilamb on the
    overlapped tick (phase 7's traffic and store); check the run against a
    blocking twin and no store, and time it (see the module docstring).
    Returns the phase's record."""
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = n_params_of(params)
    check(n_params == n_params_want, f"{n_params} params, want {n_params_want}")
    max_len = PROMPT + GEN + 1
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT),
                                     generator=g, device=dev, dtype=torch.int32)}
    policy = RedundancyPolicy.single("vilamb", period_steps=PERIOD,
                                     max_vulnerable_steps=DEADLINE)

    def new_store(async_tick=True):
        return ProtectedStore(dataclasses.replace(policy, async_tick=async_tick),
                              device=dev).attach(model.cache_shapes(SERVE_BATCH, max_len))

    # Warm-up (no store, two tokens), keeping the attention layers' q, k, v.
    calls, restore = capture_flash()
    try:
        Server(model=model, max_len=max_len).generate(params, batch, 2)
    finally:
        restore()
    qkv = calls[0] if calls else None
    del calls

    # The main path, every step timed, with the counts read around it.
    store = new_store()
    check(store.policy.async_tick, f"the {cfg.name} serving store is not overlapped")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tokens, stats, rec, wall_s = generate(model, params, batch, store, True)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_attn = cfg.n_groups * sum(m == "attn" for m, _ in slot_kinds(cfg))
    check(launches["flash_attn"] == n_attn,
          f"flash launched {launches['flash_attn']} times in the prefill, want {n_attn}")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched serving {cfg.name}")
    check(tuple(tokens.shape) == (SERVE_BATCH, GEN), f"tokens {tuple(tokens.shape)}")
    check(stats["mismatches"] == 0, f"scrub ticks found {stats['mismatches']} mismatches")
    due = [t["step"] for t in rec["ticks"] if t["updated"]]
    check(due and all(b - a <= DEADLINE for a, b in zip([0] + due, due)),
          f"due ticks at {due}")
    events = model.dirty_events_decode(stats["caches"], stats["pos"])
    all_dirty = sorted(n for n, e in events.items() if isinstance(e, str))
    check(all_dirty and set(all_dirty) <= set(store.metas),
          "the recurrent leaves are not ALL-dirty under the store")

    # The blocking twin and no store: the same tokens and caches; after the
    # final settle every field of the twin's state equals the overlapped one.
    walls = {"async": [], "none": [], "blocking": []}
    host_ticks = {"async": [], "blocking": []}
    # One generate a store (xlstm's turns were two a store, cut so that a
    # run on a slow host stays well inside the script's time limit): the
    # store overheads below are single samples in this fixed order, so the
    # blocking store always runs first after the main path.
    kinds = ("blocking", "none", "async") if turns else ("blocking", "none")
    leaves = flatten_dict(stats["caches"])
    with torch.inference_mode():
        for i, kind in enumerate(kinds):
            st = None if kind == "none" else new_store(kind == "async")
            toks, ost, trec, wall = generate(model, params, batch, st)
            check(torch.equal(toks, tokens), f"{cfg.name} tokens differ with the {kind} store")
            walls[kind].append(wall)
            if st is not None:
                host_ticks[kind].extend(trec["ticks"])
            if i < 2:
                for n, t in flatten_dict(ost["caches"]).items():
                    check(torch.equal(t, leaves[n]),
                          f"{cfg.name} cache {n} differs with the {kind} store")
            if kind == "blocking" and i == 0:
                check(ost["mismatches"] == 0, "the blocking twin's scrubs found mismatches")
                fields_equal(stats["red"], ost["red"], f"{cfg.name} after settle")
            del ost

    split = mixer_split(model, params, batch)
    prof = profile_decode(model, params, batch, new_store())
    prof_due = profile_decode(model, params, batch, new_store(), first=PERIOD - 1)

    with torch.inference_mode():
        red = stats["red"]
        masks, scrub_ms = timed(lambda: store.scrub(leaves, red))
        check(sum(int(m.sum()) for m in masks.values()) == 0, "scrub after generate flags blocks")
        red, flush_ms = timed(lambda: store.flush(leaves, red, step=GEN))
        phase_full_check(store, leaves, red)
        k3 = k3_all_dirty(store, leaves, red, all_dirty, K3_BEFORE[
            "xlstm all-dirty" if "xlstm" in cfg.name else "jamba all-dirty"])
        caches, repairs = corrupt_and_repair(g, store, stats["caches"], red, corrupt)
        # A decode step on the adopted caches writes the adopted tensors in
        # place (what generate does after adopting a patroller's repair).
        adopted = {n: flatten_dict(caches)[n] for n in repairs["adopted"]}
        before = {n: t.clone() for n, t in adopted.items()}
        model.decode_step(params, caches, tokens[:, -1], stats["pos"] + 1)
        for n, t in adopted.items():
            check(flatten_dict(caches)[n] is t and not torch.equal(t, before[n]),
                  f"the decode step did not write the adopted {n} in place")
    decode_ms = sum(rec["decode_ms"]) + sum(t["ms"] for t in rec["ticks"])
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "n_experts": cfg.n_experts,
           "launches": launches, "n_params": n_params, "init_s": init_s,
           "params_gib": sum(p.numel() * p.element_size()
                             for p in flatten_dict(params).values()) / 2**30,
           "protected_gb": sum(m.data_bytes for m in store.metas.values()) / 1e9,
           "all_dirty_gb": sum(store.metas[n].data_bytes for n in all_dirty) / 1e9,
           "all_dirty_leaves": len(all_dirty),
           "prefill_ms": rec["prefill_ms"][0], "prefill_split": split,
           "decode_ms_per_token": decode_ms / (GEN - 1),
           "decode_tokens_per_s": SERVE_BATCH * (GEN - 1) / (decode_ms / 1e3),
           "generate_s_timed_steps": wall_s, "generate_s": walls,
           "due_tick_steps": due, "due_tick_ms": [t["ms"] for t in rec["ticks"] if t["updated"]],
           "due_tick_host_ms": {k: [t["ms"] for t in v if t["updated"]]
                                for k, v in host_ticks.items()},
           "decode_profile": {k: v for k, v in prof.items()
                              if k != "top_kernels_ms_per_token"},
           "decode_top_kernels_ms_per_token": prof["top_kernels_ms_per_token"],
           "decode_profile_due": {k: v for k, v in prof_due.items()
                                  if k != "top_kernels_ms_per_token"},
           "k3_all_dirty": k3, "scrub_ms": scrub_ms, "flush_ms": flush_ms,
           "repairs": repairs, "peak_mem_gib": peak_gb}
    if turns:
        mean = {k: sum(v) / len(v) for k, v in walls.items()}
        out["store_overhead"] = mean["async"] / mean["none"] - 1
        out["store_overhead_blocking"] = mean["blocking"] / mean["none"] - 1
    del model, params, store, stats, leaves, red, caches, batch, tokens, adopted, before
    gc.collect()
    torch.cuda.empty_cache()
    if qkv is not None:
        # The attention layer's prefill against its plain version, after the
        # weights are freed (the plain fp32 scores of one sequence are 4.3 GB
        # at 64 heads).
        out["attn_err"] = layer0_err(*qkv)
        out["flash"] = flash_times(*qkv)
        del qkv
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def print_serve_recurrent(label: str, r: dict) -> None:
    k3, rp, sp = r["k3_all_dirty"], r["repairs"], r["prefill_split"]
    print(f"{label} ({r['phase_s']:.1f} s): {r['arch']}, {r['n_layers']} layers"
          + (f", {r['n_experts']} experts a MoE layer" if r["n_experts"] else "")
          + f", {r['n_params']} params ({r['params_gib']:.2f} GiB, drawn in "
          f"{r['init_s']:.1f} s); protected caches {r['protected_gb']:.3f} GB, of which "
          f"{r['all_dirty_gb']:.3f} GB in {r['all_dirty_leaves']} ALL-dirty leaves; "
          f"launches {r['launches']}; peak {r['peak_mem_gib']:.2f} GiB")
    print(f"{label}: prefill {r['prefill_ms']:.1f} ms; split (CUDA events around each "
          f"mixer call): {sp}; decode {r['decode_ms_per_token']:.2f} ms/token "
          f"({r['decode_tokens_per_s']:.1f} tokens/s); traced decode "
          f"{r['decode_profile']['launches_per_token']:.0f} launches and "
          f"{r['decode_profile']['device_busy_ms_per_token']} ms of device time a token; "
          f"due ticks {r['due_tick_steps']} {[round(x, 2) for x in r['due_tick_ms']]} ms")
    print(f"{label}: generate s {r['generate_s']}; due ticks' host ms (no device sync) "
          f"{r['due_tick_host_ms']}"
          + (f"; store overhead (one generate each, blocking first) async "
             f"{100 * r['store_overhead']:.2f}%, blocking "
             f"{100 * r['store_overhead_blocking']:.2f}%" if "store_overhead" in r else ""))
    print(f"{label}: trace of the due tick's decode steps {r['decode_profile_due']}")
    due = r["decode_profile_due"]
    print(f"{label}: K3 over the {k3['leaves']} ALL-dirty leaves ({k3['stripes']} stripes, "
          f"{k3['gb']:.3f} GB moved), a due tick's {k3['launches']} launch(es): "
          f"{k3['device_ms']:.4f} ms of device time (median of {k3['device_ms_runs']}), "
          f"wrappers {k3['wrapper_ms']:.4f} ms; "
          f"bound {k3['bound_ms']:.4f} ms ({k3['bound_by']}, share {k3['share_of_bound']}); "
          f"plain {k3['plain_ms']:.2f} ms; PR 20 (one launch a leaf): {k3['pr20_ms']} ms "
          f"of device time; in the traced due tick (every leaf's K3) "
          f"{due.get('fused_update_us', 'not measured')} µs over "
          f"{due['fused_update_launches']} launches")
    print(f"{label}: tokens and caches identical with the overlapped, blocking and no "
          f"store; every field equal to the blocking twin's after settle; scrub clean; "
          f"full check passed after flush ({r['flush_ms']:.2f} ms); blocks "
          f"{rp['corrupted_blocks']} corrupted, found and rebuilt bitwise (adopted "
          f"{rp['adopted']}, then written in place by a decode step)", flush=True)
    if "flash" in r:
        f = r["flash"]
        print(f"{label}: attention layer within bounds of plain at S = {PROMPT}: "
              f"{r['attn_err']}")
        print(f"flash at the {label} prefill's shape {f['shape']}: {f['ms']:.4f} ms, "
              f"{f['tflops']:.1f} TFLOP/s, {100 * f['share_of_bound']:.1f}% of its "
              f"{f['bound_ms']:.4f} ms bound ({f['bound_by']}); "
              f"scaled_dot_product_attention {f['library_ms']:.4f} ms; plain "
              f"{f['plain_ms']:.2f} ms", flush=True)


# ----------------------------------------------------------- phases 17-18
def vlm_config():
    """internvl2-1b as published: full width and depth."""
    cfg = get_arch(VLM_ARCH)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size, cfg.padded_vocab, cfg.frontend, cfg.frontend_len,
           cfg.tie_embeddings, cfg.param_dtype)
    check(got == (24, 896, 14, 2, 64, 4864, 151655, 153600, "vision", 256, False,
                  "bfloat16"), f"{VLM_ARCH} is not at full size: {got}")
    return cfg


def encdec_config():
    """seamless-m4t-medium as published: 12 encoder and 12 decoder layers
    at full width."""
    cfg = get_arch(ENCDEC_ARCH)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size, cfg.padded_vocab, cfg.norm, cfg.activation, cfg.enc_dec,
           cfg.param_dtype)
    check(got == (12, 1024, 16, 16, 64, 4096, 256206, 258048, "layernorm", "gelu", True,
                  "bfloat16"), f"{ENCDEC_ARCH} is not at full size: {got}")
    return cfg


def record_k3_words():
    """Wrap K3's grouped entry so that every job keeps its lanes' address
    and a clone of the packed dirty words it was given (on the launching
    stream: no host wait); returns the records and a function that puts
    the entry back."""
    jobs_seen: list = []
    launch = fu_ops.fused_update_many

    def record(jobs, *a, **kw):
        jobs = list(jobs)
        jobs_seen.extend((lanes.data_ptr(), words.clone()) for lanes, _, _, words in jobs)
        return launch(jobs, *a, **kw)

    def restore():
        fu_ops.fused_update_many = launch
    fu_ops.fused_update_many = record
    return jobs_seen, restore


def encoder_split(model, params, batch, max_len: int) -> dict:
    """One prefill with CUDA events around the encoder: its ms beside the
    prefill's total."""
    spans: list = []
    encode = model._encode

    def timed_encode(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = encode(*a, **kw)
        e.record()
        spans.append((s, e))
        return out

    model._encode = timed_encode
    try:
        with torch.inference_mode():
            _, total_ms = timed(lambda: model.prefill(params, batch, max_len))
        torch.cuda.synchronize()
    finally:
        del model._encode
    enc_ms = sum(s.elapsed_time(e) for s, e in spans)
    return {"encoder_ms": enc_ms, "prefill_ms": total_ms, "encoder_share": enc_ms / total_ms}


def k1_on(store, leaves: dict, name: str) -> dict:
    """K1 over one leaf's blocks (what ``init`` launches for it), against
    its plain version bitwise, timed beside it, with its bound."""
    lanes = blocks.to_lanes(leaves[name], store.metas[name])
    nb, L = lanes.shape
    got, want = ck_ops.block_checksums(lanes), ck_ref.block_checksums(lanes)
    check(torch.equal(got, want), f"checksum kernel != plain over {name}")
    del got, want
    bms, by = bound(*CA.checksum_work(nb, L))
    ms = per_call_ms(lambda: ck_ops.block_checksums(lanes), 10)
    return {"leaf": name, "gb": nb * L * 4 / 1e9, "blocks": nb, "ms": ms,
            "plain_ms": per_call_ms(lambda: ck_ref.block_checksums(lanes), 2),
            "bound_ms": bms, "bound_by": by, "share_of_bound": bms / ms}


def phase_serve_multimodal(g, cfg, n_params_want: int, corrupt: list) -> dict:
    """Phases 17 and 18's serving: ``cfg`` at full size with phase 7's
    traffic and store over every cache, internvl2-1b's 256 patches in front
    of the prompt, seamless-m4t-medium's encoder over ENC_FRAMES frames
    (its cross caches ``ck``/``cv`` under the store too); checked against a
    blocking twin and no store, and timed (see the module docstring).
    Returns the phase's record."""
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = n_params_of(params)
    check(n_params == n_params_want, f"{n_params} params, want {n_params_want}")
    patches = cfg.frontend_len if cfg.frontend == "vision" else 0
    enc_len = ENC_FRAMES if cfg.enc_dec else 0
    max_len = patches + PROMPT + GEN + 1
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT),
                                     generator=g, device=dev, dtype=torch.int32)}
    if patches:
        batch["frontend"] = torch.randn((SERVE_BATCH, patches, cfg.d_model), generator=g,
                                        device=dev)
    if enc_len:
        batch["enc_input"] = torch.randn((SERVE_BATCH, enc_len, cfg.d_model), generator=g,
                                         device=dev)
    policy = RedundancyPolicy.single("vilamb", period_steps=PERIOD,
                                     max_vulnerable_steps=DEADLINE)

    def new_store(async_tick=True):
        return ProtectedStore(dataclasses.replace(policy, async_tick=async_tick),
                              device=dev).attach(model.cache_shapes(SERVE_BATCH, max_len,
                                                                    enc_len))

    # Warm-up (no store, two tokens), keeping layer 0's attention inputs:
    # the decoder's self attention, and with an encoder the encoder's and
    # the decoder's cross attention (calls 0, n_layers and n_layers + 1).
    layer0 = {"self": 0} if not cfg.enc_dec else {
        "encoder": 0, "self": cfg.n_layers, "cross": cfg.n_layers + 1}
    calls, restore = capture_flash(set(layer0.values()))
    try:
        Server(model=model, max_len=max_len).generate(params, batch, 2)
    finally:
        restore()
    qkv = {k: calls[i] for k, i in layer0.items()}
    del calls

    # The main path, every step timed, with the counts read around it; K3's
    # jobs keep their dirty words.
    store = new_store()
    check(store.policy.async_tick, f"the {cfg.name} serving store is not overlapped")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    k3_jobs, restore_k3 = record_k3_words()
    try:
        tokens, stats, rec, wall_s = generate(model, params, batch, store, True, max_len)
    finally:
        restore_k3()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_flash = cfg.n_layers * (3 if cfg.enc_dec else 1)     # encoder, self, cross
    check(launches["flash_attn"] == n_flash,
          f"flash launched {launches['flash_attn']} times in the prefill, want {n_flash}")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched serving {cfg.name}")
    check(tuple(tokens.shape) == (SERVE_BATCH, GEN), f"tokens {tuple(tokens.shape)}")
    check(stats["mismatches"] == 0, f"scrub ticks found {stats['mismatches']} mismatches")
    check(stats["pos"] == patches + PROMPT + GEN - 1, f"pos {stats['pos']}")
    due = [t["step"] for t in rec["ticks"] if t["updated"]]
    check(due and all(b - a <= DEADLINE for a, b in zip([0] + due, due)),
          f"due ticks at {due}")
    leaves = flatten_dict(stats["caches"])
    memory = sorted(n for n in leaves if n.endswith(("/ck", "/cv")))
    check(bool(memory) == cfg.enc_dec and set(memory) <= set(store.metas),
          f"cross caches {memory} under the store")
    events = model.dirty_events_decode(stats["caches"], stats["pos"])
    check(not set(memory) & set(events), "a decode step marks the cross caches dirty")
    # K3 never touches a cross cache: every job over one has no dirty word.
    ptrs = {leaves[n].data_ptr(): n for n in memory}
    mem_jobs = [(ptrs[p], w) for p, w in k3_jobs if p in ptrs]
    check(all(not bool(w.any()) for _, w in mem_jobs),
          f"K3 was given dirty cross-cache blocks: {[n for n, w in mem_jobs if w.any()]}")
    k3_record = {"jobs": len(k3_jobs), "cross_cache_jobs": len(mem_jobs),
                 "cross_cache_dirty_words": sum(int(w.count_nonzero()) for _, w in mem_jobs)}
    del k3_jobs, mem_jobs

    # The blocking twin, no store and the overlapped store again (its ticks
    # on the host clock alone): the same tokens and caches; every field of
    # the twin's state equals the main run's after the final settle and
    # after a flush of both.
    walls = {"async": [], "none": [], "blocking": []}
    host_ticks = {"blocking": [], "async": []}
    with torch.inference_mode():
        twin = None
        for kind in ("blocking", "none", "async"):
            st = None if kind == "none" else new_store(kind == "async")
            toks, ost, trec, wall = generate(model, params, batch, st, max_len=max_len)
            check(torch.equal(toks, tokens), f"{cfg.name} tokens differ with the {kind} store")
            walls[kind].append(wall)
            for n, t in flatten_dict(ost["caches"]).items():
                check(torch.equal(t, leaves[n]), f"{cfg.name} cache {n} differs with the "
                      f"{kind} store")
            if st is not None:
                host_ticks[kind].extend(trec["ticks"])
                check(ost["mismatches"] == 0, f"the {kind} store's scrubs found mismatches")
            if kind == "blocking":
                fields_equal(stats["red"], ost["red"], f"{cfg.name} after settle")
                twin = (st, flatten_dict(ost["caches"]), ost["red"])
            del ost

    split = encoder_split(model, params, batch, max_len) if cfg.enc_dec else None
    prof = profile_decode(model, params, batch, new_store(), max_len=max_len)
    prof_due = profile_decode(model, params, batch, new_store(), first=PERIOD - 1,
                              max_len=max_len)

    with torch.inference_mode():
        red = stats["red"]
        masks, scrub_ms = timed(lambda: store.scrub(leaves, red))
        check(sum(int(m.sum()) for m in masks.values()) == 0, "scrub after generate flags blocks")
        red, flush_ms = timed(lambda: store.flush(leaves, red, step=GEN))
        tst, tleaves, tred = twin
        fields_equal(red, tst.flush(tleaves, tred, step=GEN), f"{cfg.name} after flush")
        del twin, tst, tleaves, tred
        phase_full_check(store, leaves, red)
        k1 = k1_on(store, leaves, memory[0]) if memory else None
        caches, repairs = corrupt_and_repair(g, store, stats["caches"], red, corrupt)
    decode_ms = sum(rec["decode_ms"]) + sum(t["ms"] for t in rec["ticks"])
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "launches": launches,
           "n_params": n_params, "init_s": init_s,
           "params_gib": sum(p.numel() * p.element_size()
                             for p in flatten_dict(params).values()) / 2**30,
           "max_len": max_len, "enc_len": enc_len, "patches": patches,
           "protected_gb": sum(m.data_bytes for m in store.metas.values()) / 1e9,
           "cross_cache_gb": sum(store.metas[n].data_bytes for n in memory) / 1e9,
           "k3_jobs": k3_record, "prefill_ms": rec["prefill_ms"][0], "encoder_split": split,
           "decode_ms_per_token": decode_ms / (GEN - 1),
           "decode_tokens_per_s": SERVE_BATCH * (GEN - 1) / (decode_ms / 1e3),
           "generate_s_timed_steps": wall_s, "generate_s": walls, "due_tick_steps": due,
           "due_tick_ms": [t["ms"] for t in rec["ticks"] if t["updated"]],
           "due_tick_host_ms": {k: [t["ms"] for t in v if t["updated"]]
                                for k, v in host_ticks.items()},
           "decode_profile": {k: v for k, v in prof.items()
                              if k != "top_kernels_ms_per_token"},
           "decode_top_kernels_ms_per_token": prof["top_kernels_ms_per_token"],
           "decode_profile_due": {k: v for k, v in prof_due.items()
                                  if k != "top_kernels_ms_per_token"},
           "scrub_ms": scrub_ms, "flush_ms": flush_ms, "k1_cross_cache": k1,
           "repairs": repairs, "peak_mem_gib": peak_gb}
    del model, params, store, stats, leaves, red, caches, batch, tokens
    gc.collect()
    torch.cuda.empty_cache()
    # Layer 0's prefill attention against its plain version and timed
    # beside it and SDPA, after the weights are freed.
    out["attn_err"], out["flash"] = {}, {}
    for k, (q, kk, v, causal) in qkv.items():
        out["attn_err"][k] = layer0_err(q, kk, v, causal)
        out["flash"][k] = flash_times(q, kk, v, causal)
    del qkv, q, kk, v
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def phase_train_encdec(seed: int) -> dict:
    """Phase 18's training: seamless-m4t-medium at full size, batch 1 x
    4,096 (2,048 encoder frames and 2,048 tokens), phase 9's store (params
    and both moments under vilamb T=8, deadline 16, scrub every 16) and
    determinism settings; ENCDEC_TRAIN_STEPS steps with the overlapped
    store, then a flush (K3 over every dirty stripe), a clean scrub, and
    the same steps with the blocking and no store: losses and final params
    checksums bitwise equal."""
    t_phase = time.perf_counter()
    cfg = encdec_config()
    model = build_model(cfg, DEVICE)
    data = SyntheticPipeline(cfg, ShapeConfig("train_4k_batch1", TRAIN_SEQ, TRAIN_BATCH,
                                              "train"), seed=seed, device=DEVICE)
    b0 = data.get(0)
    check({k: tuple(v.shape) for k, v in b0.items()} == {
        "enc_input": (TRAIN_BATCH, TRAIN_SEQ // 2, cfg.d_model),
        "tokens": (TRAIN_BATCH, TRAIN_SEQ // 2), "labels": (TRAIN_BATCH, TRAIN_SEQ // 2)},
        f"the enc-dec batch {[(k, tuple(v.shape)) for k, v in b0.items()]}")
    del b0
    opt = AdamW(lr=warmup_cosine(1e-3, 10, TRAIN_STEPS), moment_dtype=cfg.moment_dtype)
    meta = Model(cfg, torch.device("meta")).init()
    structs = protected_structs(meta, opt.init(meta))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer = train_trainer(model, opt, structs, "async")
    store = trainer.store
    ticks = host_timed_ticks(store)
    state = trainer.init_state(torch.Generator(device=DEVICE).manual_seed(seed))
    steps: dict = {}
    on_step = step_recorder(trainer, steps)
    torch.cuda.synchronize()
    steps["last"] = time.perf_counter()
    state = trainer.run(state, data, ENCDEC_TRAIN_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    leaves = protected_leaves(state.params, state.opt)
    red, flush_ms = timed(lambda: store.flush(leaves, state.red, step=ENCDEC_TRAIN_STEPS))
    check(store.scrub_check(leaves, red) == 0, "scrub after the enc-dec training flush")
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with uncounted():
        main_sums = params_checksums(state)
    losses = torch.stack(steps["losses"]).float()
    check(len(steps["losses"]) == ENCDEC_TRAIN_STEPS and bool(torch.isfinite(losses).all()),
          f"losses {losses.tolist()}")
    check(trainer.corruption_alarms == 0, f"alarms {trainer.corruption_alarms}")
    check(launches["flash_attn"] == 0, "training launched the forward-only flash kernel")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched training {cfg.name}")
    main = {"losses": losses.tolist(), "loss_bits": losses.view(torch.int32).clone(),
            "step_wall_ms": steps["wall_ms"],
            "median_step_ms": statistics.median(steps["wall_ms"][1:]),
            "due_tick_host_ms": [t["ms"] for t in ticks if t["updated"]],
            "flush_ms": flush_ms, "launches": launches, "peak_mem_gib": peak_gib,
            "memory_gb": {"state": sum(t.numel() * t.element_size()
                                       for t in leaves.values()) / 1e9,
                          "parity": sum(r.parity.numel() * 4 for r in red.values()) / 1e9,
                          "leaves": len(leaves)}}
    del trainer, store, state, leaves, red, on_step
    gc.collect()
    torch.cuda.empty_cache()
    obs = {}
    for kind in ("blocking", "none"):
        o = train_observe(model, data, opt, structs, seed, kind, steps=ENCDEC_TRAIN_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.equal(o["loss_bits"], main["loss_bits"]),
              f"enc-dec losses differ between the overlapped store and {kind}: "
              f"{main['losses']} vs {o['losses']}")
        check(o["checksums"].keys() == main_sums.keys()
              and all(torch.equal(v, main_sums[n]) for n, v in o["checksums"].items()),
              f"final enc-dec params checksums differ between the overlapped store and {kind}")
        o["median_step_ms"] = statistics.median(o["step_wall_ms"][1:])
        del o["loss_bits"], o["checksums"]
        obs[kind] = o
    del main["loss_bits"]
    return {"main": main, "observe": obs, "phase_s": time.perf_counter() - t_phase}


def print_serve_multimodal(label: str, r: dict) -> None:
    rp, k3 = r["repairs"], r["k3_jobs"]
    print(f"{label} ({r['phase_s']:.1f} s): {r['arch']}, {r['n_layers']} layers"
          + (" (and as many encoder layers)" if r["enc_len"] else "")
          + f", {r['n_params']} params ({r['params_gib']:.2f} GiB, drawn in "
          f"{r['init_s']:.1f} s); max_len {r['max_len']} ({r['patches']} patches), encoder "
          f"frames {r['enc_len']}; protected caches {r['protected_gb']:.3f} GB, of which "
          f"{r['cross_cache_gb']:.3f} GB cross caches; launches {r['launches']}; peak "
          f"{r['peak_mem_gib']:.2f} GiB")
    print(f"{label}: prefill {r['prefill_ms']:.1f} ms"
          + (f" (encoder {r['encoder_split']})" if r["encoder_split"] else "")
          + f"; decode {r['decode_ms_per_token']:.2f} ms/token "
          f"({r['decode_tokens_per_s']:.1f} tokens/s); traced decode "
          f"{r['decode_profile']['launches_per_token']:.0f} launches and "
          f"{r['decode_profile']['device_busy_ms_per_token']} ms of device time a token; "
          f"due ticks {r['due_tick_steps']} {[round(x, 2) for x in r['due_tick_ms']]} ms "
          f"(synchronised); due ticks' host ms (no device sync) "
          f"{ {k: [round(x, 3) for x in v] for k, v in r['due_tick_host_ms'].items()} }; "
          f"generate s {r['generate_s']} (untimed steps)")
    print(f"{label}: trace of the due tick's decode steps {r['decode_profile_due']}")
    print(f"{label}: tokens and caches identical with the overlapped, blocking and no "
          f"store; every field equal to the blocking twin's after settle and after flush; "
          f"scrub clean; full check passed after flush ({r['flush_ms']:.2f} ms); K3 jobs "
          f"{k3}; blocks {rp['corrupted_blocks']} corrupted, found and rebuilt bitwise "
          f"(adopted {rp['adopted']})", flush=True)
    if r["k1_cross_cache"]:
        k = r["k1_cross_cache"]
        print(f"{label}: K1 over {k['leaf']} ({k['gb']:.3f} GB, {k['blocks']} blocks): "
              f"{k['ms']:.4f} ms against its {k['bound_ms']:.4f} ms bound ({k['bound_by']}, "
              f"{100 * k['share_of_bound']:.1f}%); plain {k['plain_ms']:.2f} ms")
    for k, f in r["flash"].items():
        print(f"{label}: layer 0's {k} attention within bounds of plain: "
              f"{r['attn_err'][k]}")
        print(f"flash at the {label} {k} attention's shape {f['shape']}, Sk {f['Sk']}, "
              f"causal {f['causal']}: {f['ms']:.4f} ms, {f['tflops']:.1f} TFLOP/s, "
              f"{100 * f['share_of_bound']:.1f}% of its {f['bound_ms']:.4f} ms bound "
              f"({f['bound_by']}); scaled_dot_product_attention {f['library_ms']:.4f} ms; "
              f"plain {f['plain_ms']:.2f} ms", flush=True)


def print_train_encdec(r: dict) -> None:
    m = r["main"]
    print(f"train enc-dec ({r['phase_s']:.1f} s): {ENCDEC_ARCH} full size, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} ({TRAIN_SEQ // 2} frames, {TRAIN_SEQ // 2} tokens), "
          f"{ENCDEC_TRAIN_STEPS} steps under the overlapped vilamb store over "
          f"{m['memory_gb']['leaves']} leaves ({m['memory_gb']['state']:.2f} GB, "
          f"{m['memory_gb']['parity']:.2f} GB parity); launches {m['launches']}; peak "
          f"{m['peak_mem_gib']:.2f} GiB")
    print(f"train enc-dec: losses {[round(x, 4) for x in m['losses']]}; median step "
          f"{m['median_step_ms']:.2f} ms (overlapped), "
          + ", ".join(f"{k} {o['median_step_ms']:.2f} ms" for k, o in r["observe"].items())
          + f"; flush {m['flush_ms']:.2f} ms; losses and final params checksums bitwise "
          f"equal for the overlapped, blocking and no store", flush=True)


# ----------------------------------------------------------- phases 19-20
def kernel_events(prof) -> list:
    """``(name, stream, start ns, end ns)`` of every device activity in a
    trace, read from kineto's records directly: a traced xLSTM step holds
    some 340,000 kernels besides their runtime calls, too many to build
    ``prof.events()`` from in the script's time."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        return []
    return [(e.name(), e.device_resource_id(), e.start_ns(), e.end_ns())
            for e in res.events() if e.device_type() == torch.autograd.DeviceType.CUDA]


def kernels_summary(kernels: list, window_ms: float) -> dict:
    """The union of the device intervals over the traced window, the
    launches, K3's device time, and the kernels that take the most time."""
    busy = busy_union((k[2], k[3]) for k in kernels)
    by_kernel: dict = {}
    for name, _, s0, s1 in kernels:
        by_kernel[name[:90]] = by_kernel.get(name[:90], 0.0) + (s1 - s0) / 1e6
    k3 = [k for k in kernels if "fused_update_kernel" in k[0]]
    if not kernels:
        return {"window_ms": window_ms, "kernels": 0, "device_busy_ms": "not measured",
                "device_busy_share": "not measured", "fused_update_ms": "not measured"}
    return {"window_ms": window_ms, "kernels": len(kernels), "device_busy_ms": busy / 1e6,
            "device_busy_share": busy / 1e6 / window_ms,
            "fused_update_launches": len(k3),
            "fused_update_ms": sum(k[3] - k[2] for k in k3) / 1e6,
            "top_kernels_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10])}


def slots_alone_ms(cfg, params, slots: dict, g, reps: int = 4) -> dict:
    """Host ms (synchronised) of one slot's forward and backward alone at
    the training batch's shape, as training runs it (the per-slot
    checkpoint around the mixer's per-chunk ones, under the deterministic
    mode), for each named slot of ``slots``: the slots in turns, ``reps``
    rounds after a warm-up, the median of each (the host is shared, so
    turns keep a slow stretch from landing on one slot alone)."""
    runs: dict = {}
    for name, slot in slots.items():
        mixer, ffn = slot_kinds(cfg)[slot]
        p = tfm._unbind(params["stack"][f"slot_{slot}"], cfg.n_groups)[0]
        alias = {n: t.detach().requires_grad_() for n, t in flatten_dict(p).items()}
        x = torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, generator=g,
                        device=DEVICE).to(torch.bfloat16).requires_grad_()
        ct = torch.randn(x.shape, generator=g, device=DEVICE).to(torch.bfloat16)
        runs[name] = (replace_leaves(p, alias), alias, x, ct, mixer, ffn)
    times: dict = {name: [] for name in slots}
    for _ in range(reps + 1):
        for name, (p, alias, x, ct, mixer, ffn) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with deterministic():
                y, _, _ = checkpoint(tfm._slot_train, p, x, None, cfg, mixer, ffn, True,
                                     use_reentrant=False)
                torch.autograd.grad(y, [x, *alias.values()], ct, materialize_grads=True)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t[1:]) for name, t in times.items()}


def phase_train_xlstm(seed: int) -> dict:
    """Phase 19: xlstm-1.3b trained at full width, XLSTM_TRAIN_LAYERS deep,
    through ``Trainer.run`` (see the module docstring).  Returns the
    phase's record."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(xlstm_config(), n_layers=XLSTM_TRAIN_LAYERS)
    model = build_model(cfg, DEVICE)
    data = SyntheticPipeline(cfg, ShapeConfig("train_4k_batch1", TRAIN_SEQ, TRAIN_BATCH,
                                              "train"), seed=seed, device=DEVICE)
    opt = AdamW(lr=warmup_cosine(1e-3, 10, TRAIN_STEPS), moment_dtype=cfg.moment_dtype)
    meta = Model(cfg, torch.device("meta")).init()
    structs = protected_structs(meta, opt.init(meta))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k3_streams, restore_k3 = record_k3()
    reset_launches()
    try:
        trainer = train_trainer(model, opt, structs, "async")
        store = trainer.store
        check(store.policy.async_tick, "the training store is not on the overlapped tick")
        ticks = host_timed_ticks(store)
        state = trainer.init_state(torch.Generator(device=DEVICE).manual_seed(seed))
        n_params = n_params_of(state.params)
        check(n_params == XLSTM_TRAIN_PARAMS, f"{n_params} params, want {XLSTM_TRAIN_PARAMS}")
        k3_first = len(k3_streams)            # attach's warmup and init before
        rec: dict = {}
        sums: dict = {}
        snapshot: dict = {}
        recorder = step_recorder(trainer, rec)

        def on_step(st, metrics):
            recorder(st, metrics)
            if st.step == XLSTM_SHORT_STEPS:   # the short runs' comparison point
                with uncounted():
                    sums[st.step] = params_checksums(st)
                rec["last"] = time.perf_counter()
            if st.step == XLSTM_TRAIN_STEPS:   # the due tick's snapshot, in flight
                snapshot.update({n: r.shadow.clone() for n, r in st.red.items()})
        torch.cuda.synchronize()
        rec["last"] = time.perf_counter()
        state = trainer.run(state, data, XLSTM_TRAIN_STEPS - 1, on_step=on_step)
        torch.cuda.synchronize()
        t0 = rec["last"] = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state = trainer.run(state, data, 1, on_step=on_step)   # step 8, due
            torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        kernels = kernel_events(prof)
        del prof
        tick_k3 = k3_streams[k3_first:]
        with uncounted():
            sums[XLSTM_TRAIN_STEPS] = params_checksums(state)
        state, flush_ms = timed(lambda: trainer.flush(state))
        scrub_mm, scrub_ms = timed(lambda: trainer.scrub_check(state))
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        restore_k3()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    trace = kernels_summary(kernels, window_ms)
    del kernels
    losses = torch.stack(rec["losses"]).float()
    loss_list = losses.tolist()
    check(len(loss_list) == XLSTM_TRAIN_STEPS and bool(torch.isfinite(losses).all()),
          f"losses {loss_list}")
    due = [t["step"] for t in ticks if t["updated"]]
    scrubbed = [t["step"] for t in ticks if t["scrubbed"]]
    check(due == [XLSTM_TRAIN_STEPS] and not scrubbed, f"due ticks {due}, scrubs {scrubbed}")
    check(trainer.corruption_alarms == 0 and scrub_mm == 0,
          f"alarms {trainer.corruption_alarms}, scrub after flush {scrub_mm}")
    check(tick_k3 and all(c[0] == store._side_stream() for c in tick_k3),
          "the due tick's fused update ran off the training store's side stream")
    check(launches["flash_attn"] == 0, "training xLSTM launched the flash kernel")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched training {cfg.name}")
    k3_due = due_tick_bound(store, snapshot)
    del snapshot
    leaves = protected_leaves(state.params, state.opt)
    phase_full_check(store, leaves, state.red)
    corrupt = train_corruption(store, leaves, state.red, XLSTM_TRAIN_CORRUPT)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n_slstm = sum(k == "slstm" for k in map(cfg.layer_kind, range(cfg.n_layers)))
    slot_ms = slots_alone_ms(cfg, state.params, {"slstm": cfg.slstm_every - 1, "mlstm": 0}, g)
    mixers_ms = {"slstm": n_slstm * slot_ms["slstm"],
                 "mlstm": (cfg.n_layers - n_slstm) * slot_ms["mlstm"]}
    median_ms = statistics.median(rec["wall_ms"][1:XLSTM_TRAIN_STEPS - 1])
    main = {
        "losses": loss_list, "loss_bits": losses.view(torch.int32).clone(),
        "step_wall_ms": rec["wall_ms"], "median_step_ms": median_ms,
        "launches": launches, "n_params": n_params,
        "due_ticks": [{k: t[k] for k in ("step", "ms", "dispatch_ms", "scrub_ms")}
                      for t in ticks if t["updated"]],
        "quiet_tick_host_ms_mean": statistics.mean(t["ms"] for t in ticks
                                                   if not t["updated"]),
        "trace_step_8": trace, "k3_due_tick": {**k3_due, "ms": trace["fused_update_ms"]},
        "flush_ms": flush_ms, "scrub_check_ms": scrub_ms, "peak_mem_gib": peak_gib,
        "memory_gb": {"state": sum(t.numel() * t.element_size() for t in leaves.values()) / 1e9,
                      "parity": sum(r.parity.numel() * 4 for r in state.red.values()) / 1e9,
                      "leaves": len(leaves),
                      "blocks": sum(m.n_blocks for m in store.metas.values())},
        "corruption": corrupt,
        "slot_alone_ms": slot_ms,
        # Each kind's share of the mixers' time (every slot of a kind timed
        # as the one alone), and that time over the median step.
        "slstm_share": mixers_ms["slstm"] / sum(mixers_ms.values()),
        "mlstm_share": mixers_ms["mlstm"] / sum(mixers_ms.values()),
        "mixers_over_step": sum(mixers_ms.values()) / median_ms,
    }
    if not isinstance(trace["fused_update_ms"], str) and trace["fused_update_ms"] > 0:
        main["k3_due_tick"]["share_of_bound"] = k3_due["bound_ms"] / trace["fused_update_ms"]
    del trainer, store, state, leaves, on_step, recorder
    gc.collect()
    torch.cuda.empty_cache()
    steps = XLSTM_SHORT_STEPS
    want_bits, want_sums = main["loss_bits"][:steps], sums[steps]
    obs = {}
    for kind in ("blocking", "none"):
        o = train_observe(model, data, opt, structs, seed, kind, steps=steps)
        gc.collect()
        torch.cuda.empty_cache()
        check(torch.equal(o["loss_bits"], want_bits),
              f"xLSTM losses differ between the overlapped store and {kind}: "
              f"{loss_list[:steps]} vs {o['losses']}")
        check(o["checksums"].keys() == want_sums.keys()
              and all(torch.equal(v, want_sums[n]) for n, v in o["checksums"].items()),
              f"final xLSTM params checksums differ between the overlapped store and {kind}")
        o["median_step_ms"] = statistics.median(o["step_wall_ms"][1:])
        del o["loss_bits"], o["checksums"]
        obs[kind] = o
    del main["loss_bits"]
    flops = CA.xlstm_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    main["model_flops_per_step"] = flops
    main["model_flop_share"] = flops / (median_ms / 1e3) / CA.PEAK_BF16_FLOPS
    if not isinstance(trace["device_busy_ms"], str):
        trace["device_busy_share_of_untraced_step"] = trace["device_busy_ms"] / median_ms
    return {"main": main, "observe": obs, "compared_steps": steps,
            "phase_s": time.perf_counter() - t_phase}


def mamba_layer_run(params, x, ct, cfg, remat: str):
    """One forward and backward of the Mamba mixer on ``x`` with the
    cotangent ``ct`` under the deterministic mode: ``(y, grads of x and
    every parameter, host ms synchronised, peak GiB above what was
    allocated before)``."""
    cfg = dataclasses.replace(cfg, remat=remat)
    alias = {k: v.detach().requires_grad_() for k, v in params.items()}
    xa = x.detach().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with deterministic():
        y, _ = mamba_mod.mamba_apply(alias, xa, cfg)
        grads = torch.autograd.grad(y, [xa, *alias.values()], ct)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return y.detach(), grads, ms, (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_train_hybrid(seed: int) -> dict:
    """Phase 20: jamba's Mamba mixer at full width, forward and backward
    with and without the per-chunk checkpoint (bitwise equal gradients),
    then jamba's smoke config trained through ``Trainer.run`` with each
    store (see the module docstring).  Returns the phase's record."""
    t_phase = time.perf_counter()
    cfg = hybrid_config()
    check(cfg.layer_kind(0) == "mamba", f"slot 0 of {cfg.name} is {cfg.layer_kind(0)}")
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    params = mamba_mod.mamba_init(g, cfg, torch.bfloat16, DEVICE)
    n_params = sum(p.numel() for p in params.values())
    x = torch.randn(1, MAMBA_SEQ, cfg.d_model, generator=g, device=DEVICE).to(torch.bfloat16)
    ct = torch.randn(x.shape, generator=g, device=DEVICE).to(torch.bfloat16)
    runs = [mamba_layer_run(params, x, ct, cfg, r) for r in ("full", "none", "full")]
    (y0, g0, _, _), (y1, g1, ms_none, peak_none), (y2, g2, ms_full, peak_full) = runs
    check(torch.equal(y0, y1) and torch.equal(y0, y2), "the Mamba layer's output differs "
          "with and without the per-chunk checkpoint")
    for n, a, b, c in zip(["x"] + list(params), g0, g1, g2):
        check(bool(torch.isfinite(a).all()), f"the Mamba gradient of {n} is not finite")
        check(torch.equal(a, b) and torch.equal(a, c),
              f"the Mamba gradient of {n} differs with and without the per-chunk checkpoint")
    layer = {"seq": MAMBA_SEQ, "d_model": cfg.d_model, "n_params": n_params,
             "ms_checkpointed": ms_full, "ms_unchecked": ms_none, "ms_first": runs[0][2],
             "peak_gib_checkpointed": peak_full, "peak_gib_unchecked": peak_none,
             "inputs_gib": (n_params * 2 + 2 * x.numel() * 2) / 2**30}
    del runs, y0, y1, y2, g0, g1, g2
    del params, x, ct
    gc.collect()
    torch.cuda.empty_cache()

    smoke = get_smoke(HYBRID_ARCH)
    model = build_model(smoke, DEVICE)
    data = SyntheticPipeline(smoke, ShapeConfig("hybrid_smoke", HYBRID_SMOKE_SEQ,
                                                HYBRID_SMOKE_BATCH, "train"),
                             seed=seed, device=DEVICE)
    opt = AdamW(lr=warmup_cosine(1e-3, 10, TRAIN_STEPS), moment_dtype=smoke.moment_dtype)
    meta = Model(smoke, torch.device("meta")).init()
    structs = protected_structs(meta, opt.init(meta))
    reset_launches()
    trainer = train_trainer(model, opt, structs, "async")
    ticks = host_timed_ticks(trainer.store)
    state = trainer.init_state(torch.Generator(device=DEVICE).manual_seed(seed))
    rec: dict = {}
    torch.cuda.synchronize()
    rec["last"] = time.perf_counter()
    state = trainer.run(state, data, HYBRID_SMOKE_STEPS, on_step=step_recorder(trainer, rec))
    state = trainer.flush(state)
    check(trainer.scrub_check(state) == 0, "scrub after the jamba smoke's flush")
    launches = read_launches()
    with uncounted():
        want_sums = params_checksums(state)
    losses = torch.stack(rec["losses"]).float()
    check(len(rec["losses"]) == HYBRID_SMOKE_STEPS and bool(torch.isfinite(losses).all()),
          f"jamba smoke losses {losses.tolist()}")
    check([t["step"] for t in ticks if t["updated"]] == [HYBRID_SMOKE_STEPS],
          f"due ticks {[t['step'] for t in ticks if t['updated']]}")
    check(trainer.corruption_alarms == 0, f"alarms {trainer.corruption_alarms}")
    check(launches["flash_attn"] == 0, "training the jamba smoke launched the flash kernel")
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched training the jamba smoke")
    kinds = {m for m, _ in slot_kinds(smoke)} | {f for _, f in slot_kinds(smoke)}
    check({"mamba", "attn", "moe"} <= kinds, f"the jamba smoke's slots {kinds}")
    smoke_rec = {"losses": losses.tolist(), "launches": launches,
                 "median_step_ms": statistics.median(rec["wall_ms"][1:])}
    del trainer, state
    for kind in ("blocking", "none"):
        o = train_observe(model, data, opt, structs, seed, kind, steps=HYBRID_SMOKE_STEPS)
        check(torch.equal(o["loss_bits"], losses.view(torch.int32)),
              f"jamba smoke losses differ between the overlapped store and {kind}: "
              f"{losses.tolist()} vs {o['losses']}")
        check(o["checksums"].keys() == want_sums.keys()
              and all(torch.equal(v, want_sums[n]) for n, v in o["checksums"].items()),
              f"final jamba smoke params checksums differ between the overlapped store "
              f"and {kind}")
        smoke_rec[f"median_step_ms_{kind}"] = statistics.median(o["step_wall_ms"][1:])
    gc.collect()
    torch.cuda.empty_cache()
    return {"mamba_layer": layer, "smoke": smoke_rec, "launches": launches,
            "phase_s": time.perf_counter() - t_phase}


def print_train_xlstm(r: dict) -> None:
    m, tr = r["main"], r["main"]["trace_step_8"]
    print(f"train xlstm ({r['phase_s']:.1f} s): {XLSTM_ARCH} at full width, "
          f"{XLSTM_TRAIN_LAYERS} of 48 layers ({m['n_params']} params), batch {TRAIN_BATCH} x {TRAIN_SEQ}, {XLSTM_TRAIN_STEPS} steps under the "
          f"overlapped vilamb store over {m['memory_gb']['leaves']} leaves "
          f"({m['memory_gb']['state']:.2f} GB, {m['memory_gb']['parity']:.2f} GB parity); "
          f"launches {m['launches']}; peak {m['peak_mem_gib']:.2f} GiB")
    print(f"train xlstm: losses {[round(x, 4) for x in m['losses']]}; median step "
          f"{m['median_step_ms']:.1f} ms (steps 2-7), model-FLOP share "
          f"{100 * m['model_flop_share']:.3f}%; one slot's forward and backward alone "
          f"{ {k: round(v, 1) for k, v in m['slot_alone_ms'].items()} } ms: of the mixers' "
          f"time (all slots, each as the one alone: {100 * m['mixers_over_step']:.0f}% of "
          f"the median step) the sLSTM {100 * m['slstm_share']:.1f}%, the mLSTM "
          f"{100 * m['mlstm_share']:.1f}%")
    print(f"train xlstm: due tick's host ms (no device sync) "
          f"{[(t['step'], round(t['ms'], 3)) for t in m['due_ticks']]}; quiet ticks "
          f"{m['quiet_tick_host_ms_mean']:.4f} ms; flush {m['flush_ms']:.2f} ms; scrub "
          f"{m['scrub_check_ms']:.2f} ms; K3 in the due tick {m['k3_due_tick']}")
    print(f"train xlstm: trace of step 8 (with its due tick): "
          f"{ {k: v for k, v in tr.items() if k != 'top_kernels_ms'} }; top kernels "
          f"{tr.get('top_kernels_ms')}")
    print(f"train xlstm: {r['compared_steps']} steps each with the blocking and no store: "
          + ", ".join(f"{k} median {o['median_step_ms']:.1f} ms" for k, o in r["observe"].items())
          + "; losses and params checksums bitwise equal to the overlapped run's; scrub "
          "clean; full check and the repair of "
          f"{list(m['corruption'])} passed", flush=True)


def print_train_hybrid(r: dict) -> None:
    lay, sm = r["mamba_layer"], r["smoke"]
    print(f"train hybrid ({r['phase_s']:.1f} s): {HYBRID_ARCH}'s Mamba mixer at full width "
          f"({lay['n_params']} params), x (1, {lay['seq']}, {lay['d_model']}) bf16: checkpointed "
          f"{lay['ms_checkpointed']:.1f} ms, peak {lay['peak_gib_checkpointed']:.2f} GiB above "
          f"the inputs ({lay['inputs_gib']:.2f} GiB); unchecked {lay['ms_unchecked']:.1f} ms, "
          f"peak {lay['peak_gib_unchecked']:.2f} GiB; gradients bitwise equal")
    print(f"train hybrid: the jamba smoke, {HYBRID_SMOKE_STEPS} steps at "
          f"{HYBRID_SMOKE_BATCH} x {HYBRID_SMOKE_SEQ}: losses "
          f"{[round(x, 4) for x in sm['losses']]}, median step {sm['median_step_ms']:.1f} ms "
          f"(blocking {sm['median_step_ms_blocking']:.1f}, none "
          f"{sm['median_step_ms_none']:.1f}); launches {sm['launches']}; losses and params "
          f"checksums bitwise equal for the overlapped, blocking and no store", flush=True)


def shard_fields_equal_local(store, name: str, leaf, r, live_only: bool = False) -> int:
    """Each shard's fields of ``name`` against a machine-local engine's init
    over that shard's local tensor (uncounted): every field, or with
    ``live_only`` (a settled, not flushed, state) the clean blocks'
    checksums and the clean stripes' parity.  Returns the shards checked."""
    from repro_torch.core import RedundancyEngine
    eng = store.engine_for(name)
    meta = store.metas[name]
    nb, ns = meta.n_blocks, meta.n_stripes
    parts = blocks.shard_view(leaf, eng._splits[name])
    k = parts.shape[0]
    with uncounted():
        for s_ in range(k):
            part = parts[s_].contiguous()
            local = RedundancyEngine({"x": part}, eng.config, device=part.device)
            lr = local.init({"x": part})["x"]
            got = eng._shard_red(name, r, s_)
            if live_only:
                live = bits.unpack(got.dirty | got.shadow, nb)
                clean_stripes = ~blocks.stripe_dirty_mask(meta, live)
                check(torch.equal(got.checksums[~live], lr.checksums[~live])
                      and torch.equal(got.parity[clean_stripes], lr.parity[clean_stripes]),
                      f"{name} shard {s_}: clean fields differ from a machine-local store's")
            else:
                check(all(torch.equal(getattr(got, f), getattr(lr, f))
                          for f in ("checksums", "parity", "dirty", "shadow"))
                      and int(got.meta_ck) == int(lr.meta_ck),
                      f"{name} shard {s_}: fields differ from a machine-local store's")
            check(got.checksums.shape == (nb,) and got.parity.shape[0] == ns,
                  f"{name} shard {s_}: shard geometry")
            del part, local, lr
    return k


def phase_sharded_heap(g) -> dict:
    """Phase 21: phase 4's heap and sync leaf under a store on a simulated
    (2, 2, 2) mesh, beside a blocking twin on the same mesh."""
    from repro_torch.faults import (FaultInjector, FaultSpec, check_detection,
                                    vulnerability_window)
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    heap = torch.randn((N_ROWS, ROW), generator=g, device=dev)
    params = torch.randn((16384, 1024), generator=g, device=dev)      # 64 MiB
    state = {"heap": heap, "params": params}
    twin_state = {k: v.clone() for k, v in state.items()}
    plan = [(torch.randperm(N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP],
             torch.randn((ROWS_PER_STEP, ROW), generator=g, device=dev))
            for _ in range(STEPS)]
    store = ProtectedStore(heap_policy(async_tick=True), mesh=mesh).attach(
        state, specs=HEAP_SPECS)
    with uncounted():
        twin = ProtectedStore(heap_policy(async_tick=False), mesh=mesh).attach(
            twin_state, specs=HEAP_SPECS)
        twin_red = twin.init(twin_state)
    meta = store.metas["heap"]
    nb = meta.n_blocks
    check((store.shard_factor("heap"), store.shard_factor("params"), nb)
          == (8, 4, N_ROWS // 8), f"sharded geometry {store.shard_factor('heap')}, "
          f"{store.shard_factor('params')}, {nb} blocks a shard")
    k3_streams, restore_k3 = record_k3()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    red, init_ms = timed(lambda: store.init(state))
    init_launches = {"checksum": ck_ops.LAUNCHES, "parity": par_ops.LAUNCHES}
    check(init_launches == {"checksum": 2, "parity": 2},
          f"init launched {init_launches}: want one K1 and one K2 a leaf, every shard in it")
    check(tuple(red["heap"].meta_ck.shape) == (8,) and tuple(red["params"].meta_ck.shape)
          == (4,), "one meta-checksum a shard")
    side = store._side_stream()
    rec = {k: {"due_steps": [], "due_tick_host_ms": [], "window_ms": []}
           for k in ("async", "blocking")}
    red = heap_steps(store, state, red, plan, range(STEPS), rec["async"], k3_streams)
    check(all(c[0] == side for c in k3_streams), "a sharded fused update ran off the side "
          "stream")
    n = len(k3_streams)
    with uncounted():
        twin_red = heap_steps(twin, twin_state, twin_red, plan, range(STEPS),
                              rec["blocking"], k3_streams)
    del k3_streams[n:]
    for kind in rec:
        check(rec[kind]["due_steps"] == [16, 32, 48],
              f"sharded {kind}: due ticks at {rec[kind]['due_steps']}")
    red, flush_ms = timed(lambda: store.flush(state, red, step=STEPS))
    with uncounted():
        twin_red, twin_flush_ms = timed(lambda: twin.flush(twin_state, twin_red, step=STEPS))
    restore_k3()
    check(all(torch.equal(state[k], twin_state[k]) for k in state), "the twins' leaves differ")
    for name in red:
        for f in ("checksums", "parity", "dirty", "shadow", "meta_ck"):
            check(torch.equal(getattr(red[name], f), getattr(twin_red[name], f)),
                  f"sharded: after flush {name}.{f} differs from the blocking twin's")
    del twin, twin_red, twin_state, plan
    torch.cuda.empty_cache()
    # Each due group one K3 launch: the heap group's 8 shards, one job each.
    check(K3_CALLS == [8] * 4, f"sharded K3 calls {K3_CALLS}: want 3 due ticks and the "
          "flush, 8 jobs each")
    shards = {n_: shard_fields_equal_local(store, n_, state[n_], red[n_])
              for n_ in ("heap", "params")}

    # A lane corrupted on shard 5: scrub flags its global block id, repair
    # rebuilds it bitwise (in place: the heap's rows are the shard's view).
    words = heap.view(torch.int32)                 # row = global block id
    bad = 5 * nb + int(torch.randint(0, nb, (1,), generator=g, device=dev))
    saved = words[bad].clone()
    words[bad, 99] ^= 0xBAD
    masks, scrub_ms = timed(lambda: store.scrub(state, red))
    flagged_ = {k: torch.nonzero(m).flatten().tolist() for k, m in masks.items()}
    check(flagged_["heap"] == [bad] and not flagged_["params"],
          f"scrub flagged {flagged_}, want heap block {bad}")
    (fixed_lv, fixed, lost), repair_ms = timed(lambda: store.repair(state, red, masks))
    check(fixed == 1 and lost == 0 and fixed_lv["heap"].data_ptr() == heap.data_ptr()
          and torch.equal(words[bad], saved), "repair did not rebuild shard 5's block bitwise")
    _, red_m = store.inject(state, red, FaultSpec("meta_bitflip", "heap", block=5 * nb + 2,
                                                  bit=7))
    ok = store.verify_meta(red_m)
    diff = torch.nonzero(red_m["heap"].meta_ck != red["heap"].meta_ck).flatten().tolist()
    check(not bool(ok["heap"]) and bool(ok["params"]) and diff == [5],
          f"a meta flip on shard 5: verify_meta {ok}, shards changed {diff}")
    check(all(bool(v) for v in store.verify_meta(red).values()), "verify_meta failed")

    # The sharded oracle: a window from a few steps of writes, then clean-
    # block faults across shards, every one found, no false positive.
    for step in range(STEPS + 1, STEPS + 1 + SHARD_WINDOW_STEPS):
        red, _ = fault_step(store, state, red, torch.randperm(
            N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP], g, step)
    red = store.settle(red, state, step=STEPS + SHARD_WINDOW_STEPS)
    window = vulnerability_window(store, red)
    inj = FaultInjector(store, seed=21)
    specs, plan_ms = timed(lambda: inj.plan_clean_blocks(red, SHARD_ORACLE_FAULTS,
                                                         kinds=("data_bitflip",)))
    hit = sorted({sp.block // nb for sp in specs if sp.leaf == "heap"})
    (lv2, _), inject_ms = timed(lambda: inj.inject_many(state, red, specs))
    report, oracle_ms = timed(lambda: check_detection(store, lv2, red, specs, window=window))
    n_ = lambda d: sum(len(v) for v in d.values())
    check(len(specs) == SHARD_ORACLE_FAULTS and len(hit) >= 2 and report.ok
          and n_(report.expected) == n_(report.detected) == SHARD_ORACLE_FAULTS,
          f"sharded oracle: {len(specs)} specs on shards {hit}: {report.summary()}")
    del lv2
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for name in ("checksum", "parity", "fused_update"):
        check(launches[name] > 0, f"{name} kernel never launched on the sharded heap")

    # Timed, uncounted: K1 and K2 over the 8 shards beside the one-leaf
    # launches over the same 8 GiB; K3 over a due tick's marks, 8 jobs.
    times = {}
    with uncounted():
        lanes3 = store.engine_for("heap").lanes_by_shard(heap, "heap")
        lanes2 = heap.view(torch.int32)
        check(lanes3.data_ptr() == heap.data_ptr(), "the shard lanes are not a view")
        L = ROW
        # The store's checksums and parity are current outside the window.
        live = store.vulnerable_masks(red)["heap"]
        clean_stripes = ~live.view(-1, STRIPE).any(dim=1)
        got, want = ck_ops.block_checksums(lanes3), ck_ref.block_checksums(lanes3)
        check(torch.equal(got, want) and torch.equal(got[~live], red["heap"].checksums[~live]),
              "sharded K1 != plain or the store's clean checksums")
        del got, want
        k1_bound = bound(*CA.checksum_work(N_ROWS, L))
        times["checksum"] = {
            "ms": per_call_ms(lambda: ck_ops.block_checksums(lanes3), 10),
            "one_leaf_ms": per_call_ms(lambda: ck_ops.block_checksums(lanes2), 10),
            "plain_ms": per_call_ms(lambda: ck_ref.block_checksums(lanes3), 2),
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1]}
        got, want = par_ops.stripe_parity(lanes3, STRIPE), par_ref.stripe_parity(lanes3, STRIPE)
        check(torch.equal(got, want)
              and torch.equal(got[clean_stripes], red["heap"].parity[clean_stripes]),
              "sharded K2 != plain or the store's clean parity")
        del got, want
        ns_all = N_ROWS // STRIPE
        k2_bound = bound(*CA.parity_work(N_ROWS, ns_all, L))
        times["parity"] = {
            "ms": per_call_ms(lambda: par_ops.stripe_parity(lanes3, STRIPE), 10),
            "one_leaf_ms": per_call_ms(lambda: par_ops.stripe_parity(lanes2, STRIPE), 10),
            "plain_ms": per_call_ms(lambda: par_ref.stripe_parity(lanes3, STRIPE), 2),
            "bound_ms": k2_bound[0], "bound_by": k2_bound[1]}
        bd = torch.zeros(N_ROWS, dtype=torch.bool, device=dev)
        for _ in range(PERIOD):
            bd[torch.randperm(N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP]] = True
        sd = stripe_mask(bd, STRIPE)
        n_dirty, n_stripes = int(bd.sum()), int(sd.sum())
        words_all = bits.pack_rows(bd.view(8, nb))
        check(torch.equal(words_all, bits.pack_mask(bd)), "shard words != one leaf's words")
        old_c = red["heap"].checksums.clone()
        old_c[bd] ^= 0x5A5A5A5A
        old_p = red["heap"].parity.clone()
        old_p[sd] ^= 0x0F0F0F0F
        nw, nsh = nb // 32, nb // STRIPE
        cks, par = old_c.clone(), old_p.clone()
        jobs = [(lanes3[i], cks[i * nb:(i + 1) * nb], par[i * nsh:(i + 1) * nsh],
                 words_all[i * nw:(i + 1) * nw]) for i in range(8)]
        want = fu_ref.fused_update_many([(a, b.clone(), c.clone(), w) for a, b, c, w in jobs],
                                        STRIPE)
        fu_ops.fused_update_many(jobs, STRIPE)
        check(torch.equal(cks, torch.cat([w[0] for w in want]))
              and torch.equal(par, torch.cat([w[1] for w in want])),
              "sharded K3 != plain on the 8 GiB heap")
        del want
        one = [(lanes2, old_c.clone(), old_p.clone(), words_all)]
        k3_bound = bound(*CA.fused_update_work(n_stripes, STRIPE, L, words_all.numel(),
                                               checksums=n_dirty))
        times["fused_update"] = {
            "ms": per_call_ms(lambda: fu_ops.fused_update_many(jobs, STRIPE), 20),
            "one_leaf_ms": per_call_ms(lambda: fu_ops.fused_update_many(one, STRIPE), 20),
            "plain_ms": per_call_ms(lambda: fu_ref.fused_update_many(jobs, STRIPE), 2),
            "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "stripes": n_stripes,
            "dirty_blocks": n_dirty, "jobs": len(jobs)}
        del jobs, one, cks, par, old_c, old_p, lanes3, lanes2
    torch.cuda.empty_cache()
    return {"launches": launches, "init_launches": init_launches, "init_ms": init_ms,
            "shards_checked": shards, "overlap": rec, "flush_ms": flush_ms,
            "flush_ms_blocking": twin_flush_ms, "scrub_ms": scrub_ms, "repair_ms": repair_ms,
            "corrupted_block": bad, "oracle": report.summary(), "oracle_shards_hit": hit,
            "oracle_plan_ms": plan_ms, "oracle_inject_ms": inject_ms,
            "oracle_scrub_ms": oracle_ms, "times": times, "peak_mem_gb": peak_gb,
            "wall_s": time.perf_counter() - t_phase}


def print_sharded_heap(r: dict) -> None:
    print(f"sharded heap ({r['wall_s']:.1f} s): launches {r['launches']} (init "
          f"{r['init_launches']}); peak {r['peak_mem_gb']:.2f} GiB; init {r['init_ms']:.2f} ms")
    for kind in ("async", "blocking"):
        o = r["overlap"][kind]
        print(f"sharded heap {kind}: due ticks {o['due_steps']} host "
              f"{[round(x, 3) for x in o['due_tick_host_ms']]} ms (no device sync); steps "
              f"15-18, 31-34, 47-50 wall {[round(x, 3) for x in o['window_ms']]} ms; trace "
              f"of steps 15-18: {o['trace_steps_15_18']}")
    print(f"sharded heap: every field equals the blocking twin's after flush ("
          f"{r['flush_ms']:.2f} ms, blocking {r['flush_ms_blocking']:.2f} ms); shards equal to "
          f"machine-local stores: {r['shards_checked']}; block {r['corrupted_block']} "
          f"(shard 5) flagged by scrub ({r['scrub_ms']:.2f} ms) and repaired "
          f"({r['repair_ms']:.2f} ms); a meta flip on shard 5 trips the heap only; oracle "
          f"{r['oracle']} over shards {r['oracle_shards_hit']} (plan {r['oracle_plan_ms']:.1f} "
          f"ms, inject {r['oracle_inject_ms']:.1f} ms, scrub {r['oracle_scrub_ms']:.1f} ms)")
    for name, t in r["times"].items():
        print(f"sharded heap {name}: {t['ms']:.4f} ms over 8 shards in one launch, "
              f"{t['one_leaf_ms']:.4f} ms as one leaf, bound {t['bound_ms']:.4f} ms "
              f"({100 * t['bound_ms'] / t['ms']:.1f}%), plain {t['plain_ms']:.2f} ms")


def sharded_full_check(store, caches: dict, red: dict, names: list) -> dict:
    """K1 and K2 over each leaf's staged ``(k, n_blocks, L)`` lanes (the
    shapes phase 22 gives them) against a chunked plain recompute, shard
    by shard, and against the store's flushed checksums and parity,
    bitwise.  The launches here are not counted.  Returns each leaf's
    shards, blocks and stripes checked."""
    out = {}
    with uncounted():
        for n in names:
            meta = store.metas[n]
            nb, ns = meta.n_blocks, meta.n_stripes
            lanes = store.engine_for(n).lanes_by_shard(caches[n], n)
            k = lanes.shape[0]
            cks = ck_ops.block_checksums(lanes)
            par = par_ops.stripe_parity(lanes, STRIPE)
            check(torch.equal(cks, red[n].checksums) and torch.equal(par, red[n].parity),
                  f"{n}: K1/K2 over the staged shards != the store's checksums/parity")
            chunk = max(1, CHUNK_BYTES // meta.bytes_per_block // STRIPE) * STRIPE
            for s_ in range(k):
                for a in range(0, nb, chunk):
                    e = min(nb, a + chunk)
                    check(torch.equal(ck_ref.block_checksums(lanes[s_, a:e], a),
                                      cks[s_ * nb + a:s_ * nb + e]),
                          f"{n} shard {s_}: K1 over blocks {a}..{e} != plain")
                    check(torch.equal(par_ref.stripe_parity(lanes[s_, a:e], STRIPE),
                                      par[s_ * ns + a // STRIPE:s_ * ns - (-e // STRIPE)]),
                          f"{n} shard {s_}: K2 over blocks {a}..{e} != plain")
            out[n] = {"shards": k, "blocks": k * nb, "stripes": k * ns,
                      "partial_last_stripe": nb % STRIPE != 0}
            del lanes, cks, par
    return out


def flip_shard_element(leaf, splits, s_: int, local_index: tuple, bit: int) -> None:
    """XOR one bit of the 16-bit element at ``local_index`` of shard ``s_``
    of a strided leaf, in place (the shard's chunk coordinates are the
    row-major digits of ``s_`` over ``splits``)."""
    coords, rest = [], s_
    for n in reversed(splits):
        rest, c = divmod(rest, n)
        coords.append(c)
    coords.reverse()
    local = [d // n for d, n in zip(leaf.shape, splits)]
    idx = tuple(c * l + i for c, l, i in zip(coords, local, local_index))
    leaf.view(torch.int16)[idx] ^= 1 << bit


def phase_serve_sharded(gen_state, tokens7, none_s7: list) -> dict:
    """Phase 22: phase 7's llama3.2-3b, batch and traffic with the KV caches
    under a store on a simulated (2, 2, 2) mesh with ``cache_specs``.
    ``tokens7`` and ``none_s7`` are phase 7's tokens and its no-store
    ``generate`` wall times."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = get_arch(SERVE_ARCH)
    model = build_model(cfg, dev)
    g = torch.Generator(device=dev)
    g.set_state(gen_state)              # phase 7's params and batch, drawn again
    params = model.init(g)
    max_len = PROMPT + GEN + 1
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT),
                                     generator=g, device=dev, dtype=torch.int32)}
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    shapes = model.cache_shapes(SERVE_BATCH, max_len)
    specs, log = cache_specs(cfg, flatten_dict(shapes), ParallelCtx(mesh), SERVE_BATCH)
    want_spec = (None, None, ("pod", "data"), "model", None)
    check(not log and all(tuple(v) == want_spec for v in specs.values()),
          f"cache_specs gave {specs} (log {log})")
    policy = RedundancyPolicy.single("vilamb", period_steps=PERIOD,
                                     max_vulnerable_steps=DEADLINE)
    kinds = {"async": {}, "blocking": dict(async_tick=False)}

    def new_store(kind="async"):
        return ProtectedStore(dataclasses.replace(policy, **kinds[kind]), mesh=mesh).attach(
            shapes, specs=specs)

    store = new_store()
    names = sorted(store.metas)
    check(all(store.shard_factor(n) == 8 for n in names), "cache leaves not in 8 shards")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tokens, stats, rec, wall = generate(model, params, batch, store)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    calls = list(K3_CALLS)
    check(torch.equal(tokens, tokens7), "sharded serving's tokens differ from phase 7's")
    check(stats["mismatches"] == 0, f"sharded scrubs found {stats['mismatches']} mismatches")
    check(launches["flash_attn"] == cfg.n_layers and launches["checksum"] > 0
          and launches["parity"] > 0, f"sharded serving launches {launches}")
    due = [t for t in rec["ticks"] if t["updated"]]
    check(len(due) == len(calls) and calls and all(n == 8 * len(names) for n in calls),
          f"K3 calls {calls} over {len(due)} due ticks: want one launch a due tick over "
          f"every shard of every cache leaf")
    # After the counted run (overlapped), the blocking and the overlapped
    # sharded store in turns, untimed steps (the stores' ticks on the host
    # clock): tokens equal.  No store's wall time is phase 7's (the same
    # model, batch and card, in this process).
    walls = {"async": [wall], "blocking": []}
    host_ticks = {"async": [], "blocking": []}
    with uncounted():
        for kind in ("blocking", "async"):
            toks, _, trec, w = generate(model, params, batch, new_store(kind))
            check(torch.equal(toks, tokens), f"sharded serving's tokens differ with {kind}")
            walls[kind].append(w)
            host_ticks[kind].extend(trec["ticks"])
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    none_s = statistics.mean(none_s7)
    out = {"launches": launches, "k3_calls": calls, "peak_mem_gb": peak_gb,
           "generate_s": walls, "generate_s_no_store_phase7": none_s7,
           "store_overhead": {k: mean[k] / none_s - 1 for k in ("async", "blocking")},
           "due_tick_host_ms": {k: [t["ms"] for t in v if t["updated"]]
                                for k, v in host_ticks.items()},
           "due_steps": [t["step"] for t in due],
           "cache_gb": sum(m.data_bytes for m in store.metas.values()) * 8 / 1e9}
    with torch.inference_mode(), uncounted():
        caches = flatten_dict(stats["caches"])
        red = stats["red"]
        out["shards_checked_settled"] = {
            n: shard_fields_equal_local(store, n, caches[n], red[n], live_only=True)
            for n in names}
        masks = store.scrub(caches, red)
        check(sum(int(m.sum()) for m in masks.values()) == 0, "sharded scrub flagged blocks")
        red = store.flush(caches, red, step=GEN)
        for n in names:
            shard_fields_equal_local(store, n, caches[n], red[n])
        out["plain_check"] = sharded_full_check(store, caches, red, names)
        # A corrupted K-cache lane on shard 5: found at its global block id;
        # repair on this leaf (not dim0-sharded) raises the reference's error.
        name = "slot_0/k"
        meta = store.metas[name]
        nb, L = meta.n_blocks, meta.lanes_per_block
        b_loc = int(torch.randint(0, nb - 1, (1,), generator=g, device=dev))
        local_idx = np.unravel_index((b_loc * L + 99) * 2, meta.shape)
        splits = store.engine_for(name)._splits[name]
        flip_shard_element(caches[name], splits, 5, tuple(int(i) for i in local_idx), 8)
        masks = store.scrub(caches, red)
        flagged_ = {k: torch.nonzero(m).flatten().tolist() for k, m in masks.items()}
        check(flagged_[name] == [5 * nb + b_loc]
              and all(not v for k, v in flagged_.items() if k != name),
              f"sharded scrub flagged {flagged_}, want {name} block {5 * nb + b_loc}")
        try:
            store.repair(caches, red, masks)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None and "dim0-only sharding" in raised,
              f"repair on a strided leaf: {raised!r}")
        flip_shard_element(caches[name], splits, 5, tuple(int(i) for i in local_idx), 8)
        check(sum(int(m.sum()) for m in store.scrub(caches, red).values()) == 0,
              "sharded rescrub flagged blocks")
        out.update(corrupted_block=5 * nb + b_loc, repair_error=raised)

        # One due tick's update, alone: the decode's marks of PERIOD
        # positions, then the group's blocking update, traced and timed.
        eng = store.engine_for(names[0])
        pos = int(stats["pos"]) - PERIOD
        marked = dict(red)
        for t in range(PERIOD):
            ev = model.dirty_events_decode(stats["caches"], pos + t)
            marked = eng.mark_dirty(marked, {n: ev[n] for n in names})
        words = {n: marked[n].dirty | marked[n].shadow for n in names}
        out["due_bound"] = due_tick_bound(store, words)
        sub = {n: caches[n] for n in names}
        traced = {n: dataclasses.replace(marked[n], checksums=marked[n].checksums.clone(),
                                         parity=marked[n].parity.clone()) for n in names}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.redundancy_step(sub, traced)
            torch.cuda.synchronize()
        del traced
        kernels = kernel_events(prof) or [
            (e.name, e.device_resource_id, e.time_range.start * 1000, e.time_range.end * 1000)
            for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kernel: dict = {}
        for k_ in kernels:
            by_kernel[k_[0][:90]] = by_kernel.get(k_[0][:90], 0.0) + (k_[3] - k_[2]) / 1e6
        k3 = [k for k in kernels if "fused_update_kernel" in k[0]]
        # The staging copy of each leaf into its (8, *local) layout, and the
        # zero fill of the layout's padded tail.
        staging = [k for k in kernels if "copy" in k[0].lower() or "fill" in k[0].lower()]
        out["due_trace"] = {
            "kernels": len(kernels), "fused_update_launches": len(k3),
            "fused_update_ms": sum(k[3] - k[2] for k in k3) / 1e6 if k3 else "not measured",
            "staging_ms": sum(k[3] - k[2] for k in staging) / 1e6 if kernels
            else "not measured",
            "device_busy_ms": busy_union((k[2], k[3]) for k in kernels) / 1e6 if kernels
            else "not measured",
            "staging_launches": len(staging),
            "top_kernels_ms": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])}
        # K3 over the same marks, alone: one launch of 16 jobs against its
        # plain version, its device time between CUDA events behind a spin
        # (the trace above does not always hold the kernel: PERF.md §7).
        lanes = {n: eng.lanes_by_shard(caches[n], n) for n in names}
        jobs, plain = [], []
        for n in names:
            m = store.metas[n]
            nb_, ns_, nw_ = m.n_blocks, m.n_stripes, m.n_dirty_words
            c, p_ = marked[n].checksums.clone(), marked[n].parity.clone()
            for s_ in range(store.shard_factor(n)):
                job = (lanes[n][s_], c[s_ * nb_:(s_ + 1) * nb_], p_[s_ * ns_:(s_ + 1) * ns_],
                       words[n][s_ * nw_:(s_ + 1) * nw_])
                jobs.append(job)
                plain.append((job[0], job[1].clone(), job[2].clone(), job[3]))
        want = fu_ref.fused_update_many(plain, STRIPE)
        n_launch = fu_ops.LAUNCHES
        got = fu_ops.fused_update_many(jobs, STRIPE)
        check(fu_ops.LAUNCHES == n_launch + 1 and all(
            torch.equal(gc, wc) and torch.equal(gp, wp) for (gc, gp), (wc, wp) in zip(got, want)),
              "phase 22's K3 over 16 shard jobs != plain or not one launch")
        del want, got
        device = []
        for _ in range(5):
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fu_ops.fused_update_many(jobs, STRIPE)
            b.record()
            b.synchronize()
            device.append(a.elapsed_time(b))
        out["k3"] = {"jobs": len(jobs), "device_ms": statistics.median(device),
                     "device_ms_runs": device,
                     "wrapper_ms": per_call_ms(lambda: fu_ops.fused_update_many(jobs, STRIPE), 10),
                     "plain_ms": per_call_ms(lambda: fu_ref.fused_update_many(plain, STRIPE), 1)}
        del jobs, plain, lanes
        out["staging_copy_ms"] = per_call_ms(
            lambda: [eng.lanes_by_shard(caches[n], n) for n in names], 5)
        stage_bytes = sum(2 * caches[n].numel() * caches[n].element_size() for n in names)
        out["staging_bound_ms"] = stage_bytes / CA.HBM_BW * 1e3
        jobs_marked = {n: dataclasses.replace(marked[n], checksums=marked[n].checksums.clone(),
                                              parity=marked[n].parity.clone())
                       for n in names}
        out["due_update_ms"] = per_call_ms(lambda: eng.redundancy_step(sub, jobs_marked), 5)
        del marked, jobs_marked, sub, caches, red
    out["wall_s"] = time.perf_counter() - t_phase
    del store, stats
    gc.collect()
    torch.cuda.empty_cache()
    out["patrolled"] = serve_sharded_patrolled(model, params, batch, policy, mesh, shapes,
                                               specs, tokens7)
    del params, model
    return out


def serve_sharded_patrolled(model, params, batch, policy, mesh, shapes, specs,
                            tokens7) -> dict:
    """Phase 23b, after phase 22 (its model, batch and sharded specs): one
    more ``generate`` with the caches under the sharded store with the
    scheduled scrub off and the scrub patroller at 64 MiB a shard a probe.
    The caches are not dim0-sharded, so there is no cross-shard parity, and
    each probe stages its window of every shard alone.  Tokens equal to
    phase 7's, no patrol mismatch, every staged window at most ``k *
    window`` blocks.  Its launch counts are read around it (with phase
    23's, the kernel line's "sharded patrol" path)."""
    t_phase = time.perf_counter()
    store = ProtectedStore(dataclasses.replace(
        policy, patrol_bytes_per_tick=PATROL_BUDGETS[0]), mesh=mesh).attach(shapes,
                                                                            specs=specs)
    pat = store.patroller
    names = sorted(store.metas)
    check(sorted(pat.targets) == names and not pat.xpar,
          f"sharded serving's patroller: targets {pat.targets}, xpar {sorted(pat.xpar)}")
    mism: list = []
    tick = store.tick

    def counted(*a, **kw):
        red, report = tick(*a, **kw)
        mism.append(report.patrol_mismatches)
        return red, report
    store.tick = counted
    staged: list = []
    window_lanes = blocks.shard_window_lanes

    def recording(x, meta, splits, start, n):
        out = window_lanes(x, meta, splits, start, n)
        staged.append((out.shape[0] * out.shape[1],
                       out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()))
        return out
    srv = Server(model=model, store=store, max_len=PROMPT + GEN + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    blocks.shard_window_lanes = recording
    try:
        t0 = time.perf_counter()
        toks, stats = srv.generate(params, batch, GEN, scrub_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        blocks.shard_window_lanes = window_lanes
    check(torch.equal(toks, tokens7), "tokens differ with the patrolled sharded store")
    check(sum(mism) == 0 and not pat.detections and not pat.unrecoverable,
          f"the patrol flagged {sum(mism)} blocks while serving")
    k, w = 8, pat.window[names[0]]
    check(staged and all(n <= k * w and not view for n, view in staged)
          and len(staged) == pat.blocks_scanned // w,
          f"probe windows staged {staged[:4]}... for {pat.blocks_scanned} blocks patrolled")
    # Phase 23c's cache read: 8 blocks of the K cache, one a shard, through
    # Server.read_verified, against the cache's own lane rows (one staging
    # copy of the leaf, no kernel).
    name = names[0]
    nb0 = store.metas[name].n_blocks
    ids = [s_ * nb0 + (s_ * 97 + 13) % nb0 for s_ in range(8)]
    with torch.inference_mode():
        store.await_inflight()
        live = pat.fetch_live_rows(name, stats["red"][name]).reshape(-1)
        n_clean = int((~live[ids]).sum())          # K1 checks these alone
        n0 = ck_ops.LAUNCHES
        t0 = time.perf_counter()
        got = srv.read_verified(stats["caches"], stats["red"], name, ids)
        kv_read_ms = (time.perf_counter() - t0) * 1e3
        kv_read_k1 = ck_ops.LAUNCHES - n0
        lanes = store.engine_for(name).lanes_by_shard(flatten_dict(stats["caches"])[name], name)
        want = lanes.reshape(-1, lanes.shape[-1])[torch.as_tensor(ids, device=lanes.device)]
        want = want.cpu().numpy().view(np.uint32)
        del lanes
    check(sorted(got) == sorted(ids) and all((got[b] == want[i]).all()
                                             for i, b in enumerate(ids)),
          "Server.read_verified's cache rows differ from the cache")
    check(kv_read_k1 == n_clean, f"Server.read_verified launched K1 {kv_read_k1} times "
          f"for {n_clean} blocks outside the window")
    launches = read_launches()
    check(launches["checksum"] >= len(staged) + n_clean
          and launches["flash_attn"] == model.cfg.n_layers,
          f"patrolled sharded serving launches {launches}")
    caches = flatten_dict(stats["caches"])
    meta = store.metas[names[0]]
    splits = store.engine_for(names[0])._splits[names[0]]
    with torch.inference_mode(), uncounted():
        stage_ms = per_call_ms(lambda: window_lanes(caches[names[0]], meta, splits, 0, w), 10)
    out = {"generate_s": wall, "blocks_patrolled": pat.blocks_scanned,
           "probes": len(staged), "window_blocks": w,
           "staged_blocks_max": max(n for n, _ in staged),
           "window_stage_ms": stage_ms,
           "window_stage_bound_ms": 2 * k * w * meta.bytes_per_block / CA.HBM_BW * 1e3,
           "kv_read_ms": kv_read_ms, "kv_read_blocks": len(ids), "kv_read_k1": kv_read_k1,
           "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    out["wall_s"] = time.perf_counter() - t_phase
    del store, srv, stats, caches
    return out


def print_serve_sharded_patrolled(r: dict) -> None:
    print(f"sharded serving with patrol (phase 23b, {r['wall_s']:.1f} s): generate "
          f"{r['generate_s']:.4f} s, tokens identical to phase 7's, no patrol mismatch; "
          f"{r['probes']} probes over {r['blocks_patrolled']} blocks, each staging at most "
          f"{r['staged_blocks_max']} blocks (8 x {r['window_blocks']}); a window's "
          f"staging {r['window_stage_ms']:.4f} ms (bound {r['window_stage_bound_ms']:.4f}); "
          f"Server.read_verified of {r['kv_read_blocks']} K-cache blocks (phase 23c) equal "
          f"to the cache, {r['kv_read_ms']:.3f} ms of host, {r['kv_read_k1']} K1 launches; "
          f"launches {r['launches']}; peak {r['peak_mem_gb']:.2f} GiB")


def print_serve_sharded(r: dict) -> None:
    print(f"sharded serving ({r['wall_s']:.1f} s): launches {r['launches']}, K3 calls "
          f"{r['k3_calls']} (jobs each) at due steps {r['due_steps']}; caches "
          f"{r['cache_gb']:.2f} GB in 8 shards a leaf; peak {r['peak_mem_gb']:.2f} GiB")
    print(f"sharded serving: generate s, in turns (async counted, blocking, async) "
          f"{({k: [round(x, 4) for x in v] for k, v in r['generate_s'].items()})}; "
          f"overhead against phase 7's no-store runs "
          f"{[round(x, 4) for x in r['generate_s_no_store_phase7']]} s "
          f"{({k: round(100 * v, 2) for k, v in r['store_overhead'].items()})}%; due ticks' host ms "
          f"{ {k: [round(x, 3) for x in v] for k, v in r['due_tick_host_ms'].items()} }")
    print(f"sharded serving: tokens identical to phase 7's (equal to no store's); shards equal to "
          f"machine-local stores (settled: clean fields; flushed: all) "
          f"{r['shards_checked_settled']}; K1/K2 over the staged shards == chunked plain "
          f"== the store's, bitwise: {r['plain_check']}; block {r['corrupted_block']} "
          f"flagged; repair "
          f"raised {r['repair_error']!r}")
    b, t, k = r["due_bound"], r["due_trace"], r["k3"]
    print(f"sharded serving: K3 over a due tick's {k['jobs']} shard jobs, one launch: "
          f"{k['device_ms']:.4f} ms of device time ({k['wrapper_ms']:.4f} ms with the "
          f"wrapper) against its {b['bound_ms']:.4f} ms bound over {b['stripes']} stripes "
          f"({100 * b['bound_ms'] / k['device_ms']:.1f}%); plain {k['plain_ms']:.2f} ms")
    print(f"sharded serving: one due tick's update {r['due_update_ms']:.4f} ms; staging "
          f"copies {r['staging_copy_ms']:.4f} ms timed (one read and one write of both "
          f"leaves: bound {r['staging_bound_ms']:.4f} ms); trace: K3 {t['fused_update_ms']} ms "
          f"({t['fused_update_launches']} launch), staging {t['staging_ms']} ms over "
          f"{t['staging_launches']} launches, top kernels {t['top_kernels_ms']}")


def quiet_ticks(store, state, red, step: int, until, limit: int, rec: list,
                sample_ms: list):
    """Ticks with no write until ``until()`` holds, at most ``limit``; each
    tick's host ms (no device sync) goes to ``rec`` with whether it was
    busy and probed, and ``sample_ms`` collects the write sample's host ms
    of each.  Returns ``(red, step)``."""
    for _ in range(limit):
        if until():
            return red, step
        step += 1
        n = len(sample_ms)
        t = time.perf_counter()
        red, rep = store.tick(state, red, step)
        rec.append({"ms": (time.perf_counter() - t) * 1e3, "busy": bool(rep.updated),
                    "probe": bool(rep.patrolled),
                    "sample_ms": sum(sample_ms[n:])})
        check(not rep.patrol_mismatches, f"a quiet tick's probe flagged "
              f"{rep.patrol_mismatches} blocks")
        state.update(rep.repaired)
    check(until(), f"xpar did not cover the heap within {limit} quiet ticks")
    return red, step


def rebuild_ticks(store, state, red, step: int, g, shard_rows, old, rec: list,
                  on_first=None):
    """Ticks until the active (or queued) shard rebuild is done, each after
    writing rows of ``shard_rows`` (global heap rows, the fresh set; none
    when empty), which ``old`` (the heap's pre-loss tensor) also takes.
    Records each tick's host ms and its device ms between CUDA events;
    ``on_first(red)`` runs after the first tick of the rebuild.  Returns
    ``(red, step, status, written rows)``."""
    pat = store.patroller
    written = []
    for i in range(4 * 64):
        step += 1
        rows = shard_rows[i] if i < len(shard_rows) else None
        if rows is not None:
            red = heap_write(store, state, red, rows, g)
            old.index_copy_(0, rows, state["heap"][rows])
            written.append(rows)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t = time.perf_counter()
        red, rep = store.tick(state, red, step)
        host = (time.perf_counter() - t) * 1e3
        b.record()
        state.update(rep.repaired)
        rec.append({"step": step, "host_ms": host, "events": (a, b),
                    "status": None if rep.rebuild is None else dataclasses.asdict(rep.rebuild)})
        if on_first is not None and pat.rebuild is not None:
            on_first(red)
            on_first = None
        if rep.rebuild is not None and rep.rebuild.done:
            torch.cuda.synchronize()
            for r in rec:
                if "events" in r:
                    x, y = r.pop("events")
                    r["device_ms"] = x.elapsed_time(y)
            return red, step, rep.rebuild, written
    raise SmokeError("the shard rebuild never finished")


def lane_rows(t: torch.Tensor, rows) -> np.ndarray:
    """uint32 lane rows of the heap's global ``rows`` (one 4 KiB block a
    row), on the host."""
    idx = torch.as_tensor(list(rows), device=t.device)
    return t[idx].view(torch.int32).cpu().numpy().view(np.uint32)


def read_breakdown(store, state, red, ids) -> dict:
    """One ``read_verified`` of ``ids`` with each of its stages (the window
    bits, the rows with their checksums, the reconstructions) and each K1
    launch behind a device sync on both sides: host ms a stage (K1 is inside
    the other two), the rest (``other``: the host's own loop) and the
    synced read's total."""
    from repro_torch.core import checksum as ck_mod
    spent = {"live": 0.0, "rows": 0.0, "candidates": 0.0, "k1": 0.0}

    def timed_call(key, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    k1 = ck_mod.block_checksums
    for key in ("live", "rows", "candidates"):
        setattr(store, f"_read_{key}", timed_call(key, getattr(store, f"_read_{key}")))
    ck_mod.block_checksums = timed_call("k1", k1)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.read_verified(state, red, "heap", ids)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        ck_mod.block_checksums = k1
        for key in ("live", "rows", "candidates"):
            delattr(store, f"_read_{key}")
    spent["other"] = total - spent["live"] - spent["rows"] - spent["candidates"]
    spent["total"] = total
    return spent


def degraded_reads(store, state, red, old, pre_rows, fresh_rows) -> dict:
    """Phase 23c, right after the first tick of shard 5's rebuild:
    ``read_verified`` of READ_BLOCKS blocks of shard 5 no write touched
    since the loss (half already pasted, half still scribbled and so
    rebuilt from the rebuild's image),
    READ_PENDING rows in flight at the loss (``UnrecoverableReadError``
    with ``read_timeout`` records at their global ids), READ_FRESH rows
    written since the loss (in the window: the current data), and one
    block of shard 2 with a flipped lane (rebuilt from its stripe; the flip
    is put back after).  Every row returned equals the heap's known bytes
    (``old``, the pre-loss heap with the fresh writes) bit for bit.  The
    first read is timed on the host clock.  Returns the record."""
    from repro_torch.core import UnrecoverableReadError
    pat, meta = store.patroller, store.metas["heap"]
    reb, nb = pat.rebuild, meta.n_blocks
    check(reb is not None and reb.shard == 5 and 0 < reb.cur < nb,
          f"phase 23c: the rebuild is not under way ({None if reb is None else reb.status})")
    heap = state["heap"]
    taken = set(pre_rows.tolist()) | set(fresh_rows.tolist())
    rng = np.random.default_rng(2323)
    live = pat.fetch_live_rows("heap", red["heap"])              # (8, nb), a host wait

    def pick(shard, lo, hi, n, clean=True, stripe_clean=False):
        out = []
        for b in rng.permutation(np.arange(lo, hi)):
            gid = shard * nb + int(b)
            sid = int(b) // STRIPE
            if gid in taken or (clean and live[shard, b]) or (
                    stripe_clean and live[shard, sid * STRIPE:(sid + 1) * STRIPE].any()):
                continue
            out.append(gid)
            if len(out) == n:
                return out
        raise SmokeError(f"phase 23c: fewer than {n} clean blocks in [{lo}, {hi})")

    rec: dict = {"pasted_to": int(reb.cur)}
    # 1. Blocks of shard 5 no write touched since the loss: half pasted (so
    #    marked dirty by the paste: the current data comes back), half not
    #    yet (still scribbled: rebuilt from the rebuild's image).
    ids = (pick(5, 0, reb.cur, READ_BLOCKS // 2, clean=False)
           + pick(5, reb.cur, nb, READ_BLOCKS // 2))
    unpasted = ids[READ_BLOCKS // 2:]
    check(bool((lane_rows(heap, unpasted) != lane_rows(old, unpasted)).any(axis=1).all()),
          "phase 23c: an unpasted block of shard 5 is not scribbled")
    n0 = ck_ops.LAUNCHES
    t0 = time.perf_counter()
    got = store.read_verified(state, red, "heap", ids)
    rec["read_ms"] = (time.perf_counter() - t0) * 1e3
    rec["read_k1_launches"] = ck_ops.LAUNCHES - n0
    want = lane_rows(old, ids)
    check(all((got[b] == want[i]).all() for i, b in enumerate(ids)),
          "phase 23c: shard 5's clean blocks read back other bytes than the heap's")
    # K1 runs on the blocks outside the window (the unpasted half) and on
    # their reconstructions from the image: none on the pasted half.
    check(rec["read_k1_launches"] == READ_BLOCKS,
          f"phase 23c: {rec['read_k1_launches']} K1 launches for {READ_BLOCKS} blocks, "
          f"{READ_BLOCKS // 2} of them in the window and {READ_BLOCKS // 2} rebuilt "
          f"from the image")
    # The same read again (it writes nothing), then once more with each
    # stage behind a device sync on both sides: the breakdown.
    t0 = time.perf_counter()
    store.read_verified(state, red, "heap", ids)
    rec["read_again_ms"] = (time.perf_counter() - t0) * 1e3
    rec["read_breakdown_ms"] = read_breakdown(store, state, red, ids)
    # 2. Rows in flight at the loss: unrecoverable, never the scribble.
    pend = [int(r) for r in pre_rows[:READ_PENDING].tolist()]
    try:
        store.read_verified(state, red, "heap", pend)
        raise SmokeError("phase 23c: a read of rows in flight at the loss returned data")
    except UnrecoverableReadError as e:
        recs = sorted((r.blocks, r.stripe, r.reason) for r in e.records)
    check(recs == sorted(((b,), blocks.global_stripe_id(meta, b), "read_timeout")
                         for b in pend),
          f"phase 23c: the pending rows' records {recs[:3]}...")
    # 3. Rows written since the loss: in the window, the current data.
    ids3 = [int(r) for r in fresh_rows[:READ_FRESH].tolist()]
    got3 = store.read_verified(state, red, "heap", ids3)
    want3 = lane_rows(old, ids3)
    check(all((got3[b] == want3[i]).all() for i, b in enumerate(ids3)),
          "phase 23c: rows written since the loss read back other bytes")
    # 4. A flipped lane on shard 2: rebuilt from its stripe.
    gid = pick(2, 0, nb, 1, stripe_clean=True)[0]
    flip = torch.tensor(1 << 9, dtype=torch.int32, device=heap.device)
    heap.view(torch.int32)[gid, 7] ^= flip
    check(bool((lane_rows(heap, [gid]) != lane_rows(old, [gid])).any()), "the flip did not land")
    got4 = store.read_verified(state, red, "heap", [gid])
    heap.view(torch.int32)[gid, 7] ^= flip
    check(bool((got4[gid] == lane_rows(old, [gid])[0]).all()),
          "phase 23c: the flipped block of shard 2 was not rebuilt bitwise")
    rec.update({"blocks": len(ids), "pending": len(pend), "fresh": len(ids3),
                "flipped_block": gid})
    return rec


def phase_sharded_patrol(g) -> dict:
    """Phase 23: phase 21's sharded heap under the scrub patroller at 64 MiB
    a shard a probe: cross-shard parity over the heap's 8 shards, a shard
    lost and declared (rebuilt while the foreground writes into it), a
    shard lost and found by a probe, and a second loss refused."""
    from repro_torch.faults import FaultSpec
    from repro_torch.scrub import ShardLossConflictError
    from repro_torch.scrub import rebuild as rebuild_mod
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    state = {"heap": torch.randn((N_ROWS, ROW), generator=g, device=dev),
             "params": torch.randn((16384, 1024), generator=g, device=dev)}
    pol = dataclasses.replace(heap_policy(async_tick=True),
                              patrol_bytes_per_tick=PATROL_BUDGETS[0],
                              read_retry_attempts=READ_RETRY_ATTEMPTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    store = ProtectedStore(pol, mesh=mesh).attach(state, specs=HEAP_SPECS)
    pat, meta = store.patroller, store.metas["heap"]
    nb, w, R = meta.n_blocks, pat.window["heap"], N_ROWS // 8
    check(pat.targets == ["heap"] and sorted(pat.xpar) == ["heap"] and nb == R
          and w == PATROL_BUDGETS[0] // (ROW * 4) == 16384,
          f"patroller: targets {pat.targets}, xpar {sorted(pat.xpar)}, window {w}")
    sample_ms: list = []
    dispatch_sample = pat._dispatch_sample

    def timed_sample(out):
        t = time.perf_counter()
        dispatch_sample(out)
        sample_ms.append((time.perf_counter() - t) * 1e3)
    pat._dispatch_sample = timed_sample
    red = store.init(state)
    rec: dict = {"window_blocks": w, "rebuild_window_blocks": 4 * w}

    # 1. Phase 21's write traffic for 16 steps (the first tick folds xpar),
    #    then a flush.
    step = 0
    for step in range(1, 17):
        red = heap_write(store, state, red, torch.randperm(
            N_ROWS, generator=g, device=dev)[:ROWS_PER_STEP], g)
        red, rep = store.tick(state, red, step)
        state.update(rep.repaired)
    red = store.flush(state, red, step)
    xp = pat.xpar["heap"]
    check(xp.xpar is not None and tuple(xp.xpar.shape) == (nb, ROW), "xpar not folded")

    # 2. Quiet ticks until xpar covers the heap: two sweeps plus 16 ticks.
    sweep_ticks = math.ceil(2 * -(-nb // w) * PERIOD / (PERIOD - 1))
    quiet: list = []
    covered = lambda: bool(xp.xvalid.all())
    red, step = quiet_ticks(store, state, red, step, covered, 2 * sweep_ticks + 16,
                            quiet, sample_ms)
    rec["cover_ticks"] = len(quiet)
    lanes3 = store.engine_for("heap").lanes_by_shard(state["heap"], "heap")
    check(lanes3.data_ptr() == state["heap"].data_ptr(), "the heap's shard lanes are a copy")
    with uncounted():
        check(torch.equal(xp.xpar, rebuild_mod.xor_fold(lanes3)),
              "xpar != the fold of the heap's shards after coverage")
    # A quiet tick must not wait for the device: one behind a spin on this
    # stream (~0.25 s) returns with the spin still running.
    torch.cuda.synchronize()
    torch.cuda._sleep(SIDE_SLEEP_CYCLES // 4)
    spin = torch.cuda.Event()
    spin.record()
    step += 1
    t = time.perf_counter()
    red, rep = store.tick(state, red, step)
    spin_tick_ms = (time.perf_counter() - t) * 1e3
    check(not spin.query(), f"a quiet tick waited for the device ({spin_tick_ms:.3f} ms)")
    torch.cuda.synchronize()
    target = len(quiet) + 32                     # 32 more quiet ticks, timed
    red, step = quiet_ticks(store, state, red, step, lambda: len(quiet) >= target, 33,
                            quiet, sample_ms)
    probe_ticks = [q for q in quiet if q["probe"] and not q["busy"]]
    rec["quiet"] = {
        "ticks": len(quiet), "probe_ticks": len(probe_ticks),
        "host_ms_median": statistics.median(q["ms"] for q in probe_ticks),
        "sample_ms_median": statistics.median(q["sample_ms"] for q in probe_ticks),
        "host_ms_median_without_sample": statistics.median(
            q["ms"] - q["sample_ms"] for q in probe_ticks),
        "behind_spin_ms": spin_tick_ms}

    # 3. Rows of shard 5 written and left pending (the pre-loss set), then
    #    shard 5 lost and declared.
    perm = torch.randperm(R, generator=g, device=dev) + 5 * R
    pre_rows = perm[:64]
    fresh = [perm[64 + 256 * i:64 + 256 * (i + 1)] for i in range(8)]
    red = heap_write(store, state, red, pre_rows, g)
    old = state["heap"]                          # pre-loss data; inject copies
    lv, red = store.inject(state, red, FaultSpec("shard_loss", "heap", block=5))
    state.update(lv)
    del lv
    store.declare_shard_lost("heap", 5, red)
    check(not torch.equal(state["heap"][5 * R:5 * R + 8], old[5 * R:5 * R + 8]),
          "the shard loss did not land")

    # 4. Ticks with writes into shard 5 (the fresh set) until it is rebuilt;
    #    after the first, phase 23c's degraded reads.
    ticks5: list = []

    def reads(red_now):
        rec["reads"] = degraded_reads(store, state, red_now, old, pre_rows, fresh[0])
    red, step, st, _ = rebuild_ticks(store, state, red, step, g, fresh, old, ticks5,
                                     on_first=reads)
    lost_ids = sorted(b for u in pat.unrecoverable if u.reason == "shard_loss"
                      for b in u.blocks)
    check(st.shard == 5 and st.ticks == -(-nb // (4 * w)) == 4
          and st.rebuilt + st.fresh + st.lost == nb
          and st.lost == 64 and lost_ids == sorted(pre_rows.tolist()),
          f"shard 5's rebuild: {st}; lost ids {lost_ids[:8]}...")
    red = store.flush(state, red, step)
    check(store.scrub_check(state, red) == 0 and all(
        bool(v) for v in store.verify_meta(red).values()),
          "after shard 5's rebuild: scrub or verify_meta not clean")
    keep = torch.ones(R, dtype=torch.bool, device=dev)
    keep[pre_rows - 5 * R] = False
    new, was = state["heap"].view(torch.int32), old.view(torch.int32)
    check(torch.equal(new[5 * R:6 * R][keep], was[5 * R:6 * R][keep]),
          "shard 5 outside the pre-loss set differs from its copy before the loss")
    check(all(torch.equal(new[s_ * R:(s_ + 1) * R], was[s_ * R:(s_ + 1) * R])
              for s_ in range(8) if s_ != 5), "a surviving shard changed")
    del new, was
    rec["declared"] = {"status": dataclasses.asdict(st), "ticks": ticks5,
                       "fresh_blocks": st.fresh}
    del old, keep

    # 5. xpar covered again; shard 2 lost without a declaration: a probe
    #    finds it.  6. Declaring shard 6 meanwhile is refused.
    red, step = quiet_ticks(store, state, red, step, covered, 2 * sweep_ticks + 16,
                            quiet, sample_ms)
    old = state["heap"]
    lv, red = store.inject(state, red, FaultSpec("shard_loss", "heap", block=2))
    state.update(lv)
    del lv
    conflict = []

    def second_loss(red):
        try:
            store.declare_shard_lost("heap", 6, red)
        except ShardLossConflictError as e:
            conflict.append((e.active_shard, e.new_shard))
    ticks2: list = []
    red, step, st2, _ = rebuild_ticks(store, state, red, step, g, [], old, ticks2,
                                      on_first=second_loss)
    check(st2.shard == 2 and st2.ticks == 4 and st2.rebuilt == nb and st2.lost == 0
          and not pat._pending_loss and conflict == [(2, 6)],
          f"the probe-found loss: {st2}; conflict {conflict}")
    red = store.flush(state, red, step)
    check(store.scrub_check(state, red) == 0, "after shard 2's rebuild: scrub not clean")
    check(torch.equal(state["heap"].view(torch.int32), old.view(torch.int32)),
          "the heap differs bitwise after shard 2's rebuild")
    rec["found"] = {"status": dataclasses.asdict(st2), "ticks": ticks2}
    del old
    # Phase 24's first refusal: this store's sync leaf cannot remesh online.
    from repro_torch.remesh import RemeshGeometryError
    try:
        store.remesh(make_mesh(GROW_SHAPE, MESH_AXES, device=dev))
        check(False, "a store with a sync leaf accepted a remesh")
    except RemeshGeometryError as e:
        check("sync" in str(e) and not store.remeshing, f"the sync refusal: {e}")
    torch.cuda.synchronize()
    rec["launches"] = read_launches()
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    for name in ("checksum", "parity", "fused_update"):
        check(rec["launches"][name] > 0, f"{name} kernel never launched in phase 23")

    # Timed, uncounted: xpar's fold (the first tick's), a probe (K1 over 8 x
    # 16,384 blocks at the shard stride, then the slab fold), the
    # reconstruction image, the paste window's copy.
    heap = state["heap"]
    lanes3 = store.engine_for("heap").lanes_by_shard(heap, "heap")
    fn = store.engine_for("heap").verify_window_fn("heap", w, want_slab=True)
    start = nb - w
    win = blocks.shard_window_lanes(heap, meta, (8,), start, w)
    hb = CA.HBM_BW
    with uncounted():
        check(win.data_ptr() == lanes3[0, start].data_ptr() and win.stride(0) == nb * ROW,
              "the probe window is not a view at the shard stride")
        got = ck_ops.block_checksums(win, start)
        check(torch.equal(got, ck_ref.block_checksums(win, start))
              and torch.equal(got.view(8, w), red["heap"].checksums.view(8, nb)[:, start:]),
              "K1 over the strided window != plain or the store's checksums")
        xp = pat.xpar["heap"].xpar

        def recon():
            r = xp.clone()
            for s_ in range(8):
                if s_ != 2:
                    r ^= lanes3[s_]
            return r
        check(torch.equal(recon(), lanes3[2]), "the reconstruction image != shard 2")
        k1_b = bound(*CA.checksum_work(8 * w, ROW))
        rec["times"] = {
            "fold_ms": per_call_ms(lambda: rebuild_mod.xor_fold(lanes3), 5),
            "fold_bound_ms": (N_ROWS + nb) * ROW * 4 / hb * 1e3,
            "probe_ms": per_call_ms(lambda: rebuild_mod.xor_fold(
                fn(heap, red["heap"], start)[2]), 10),
            "probe_bound_ms": 8 * w * ROW * 4 / hb * 1e3,
            "k1_window_ms": per_call_ms(lambda: ck_ops.block_checksums(win, start), 20),
            "k1_window_plain_ms": per_call_ms(lambda: ck_ref.block_checksums(win, start), 2),
            "k1_window_bound_ms": k1_b[0], "k1_window_bound_by": k1_b[1],
            "slab_fold_ms": per_call_ms(lambda: rebuild_mod.xor_fold(win), 10),
            "recon_ms": per_call_ms(recon, 5),
            "recon_bound_ms": (N_ROWS + nb) * ROW * 4 / hb * 1e3,
            "paste_bound_ms": 3 * 4 * w * ROW * 4 / hb * 1e3}
        one = lanes3[0, start:]                         # the one-shard window
        rec["times"]["k1_one_window_ms"] = per_call_ms(
            lambda: ck_ops.block_checksums(one, start), 20)
    del lanes3, win, fn, heap
    pat._dispatch_sample = dispatch_sample
    rec["wall_s"] = time.perf_counter() - t_phase
    del store, red, state
    return rec


def print_sharded_patrol(r: dict) -> None:
    q, t = r["quiet"], r["times"]
    print(f"sharded patrol ({r['wall_s']:.1f} s): launches {r['launches']}; peak "
          f"{r['peak_mem_gb']:.2f} GiB; xpar covered the heap in {r['cover_ticks']} quiet "
          f"ticks (window {r['window_blocks']} blocks a shard, rebuild window "
          f"{r['rebuild_window_blocks']})")
    print(f"sharded patrol: quiet probe ticks' host ms median {q['host_ms_median']:.4f} "
          f"(write sample {q['sample_ms_median']:.4f}; without it "
          f"{q['host_ms_median_without_sample']:.4f}) over {q['probe_ticks']} ticks; a "
          f"tick behind a 0.25 s spin returned in {q['behind_spin_ms']:.3f} ms, the spin "
          f"still running")
    for key, label in (("declared", "declared loss of shard 5"),
                       ("found", "probe-found loss of shard 2")):
        d = r[key]
        ticks = [x for x in d["ticks"] if x["status"] is not None]
        print(f"sharded patrol: {label}: {d['status']}; rebuild ticks host ms "
              f"{[round(x['host_ms'], 3) for x in ticks]}, device ms "
              f"{[round(x['device_ms'], 3) for x in ticks]}")
    rd = r["reads"]
    print(f"degraded reads (phase 23c, after the first rebuild tick, {rd['pasted_to']} blocks "
          f"pasted): {rd['blocks']} blocks of shard 5 (half rebuilt from the image) in "
          f"{rd['read_ms']:.3f} ms of host with {rd['read_k1_launches']} K1 launches "
          f"(again {rd['read_again_ms']:.3f} ms; stages behind syncs, host ms "
          f"{({k: round(v, 3) for k, v in rd['read_breakdown_ms'].items()})}); "
          f"{rd['pending']} rows in flight at the loss raised UnrecoverableReadError "
          f"(read_timeout); {rd['fresh']} rows written since the loss; shard 2's flipped block "
          f"{rd['flipped_block']} rebuilt from its stripe; every row bitwise the heap's; a "
          f"store with a sync leaf refused a remesh (RemeshGeometryError)")
    print(f"sharded patrol: xpar fold {t['fold_ms']:.4f} ms (bound {t['fold_bound_ms']:.4f}); "
          f"probe {t['probe_ms']:.4f} ms (bound {t['probe_bound_ms']:.4f}): K1 over 8 x "
          f"{r['window_blocks']} blocks at the shard stride {t['k1_window_ms']:.4f} ms "
          f"(bound {t['k1_window_bound_ms']:.4f}, {100 * t['k1_window_bound_ms'] / t['k1_window_ms']:.1f}%; "
          f"one shard's window {t['k1_one_window_ms']:.4f}; plain "
          f"{t['k1_window_plain_ms']:.2f}), slab fold {t['slab_fold_ms']:.4f}; "
          f"reconstruction image {t['recon_ms']:.4f} ms (bound {t['recon_bound_ms']:.4f}); "
          f"a paste window's bound {t['paste_bound_ms']:.4f} ms")


def remesh_write(store, state, red, g):
    """One step of phase 21's heap writes: ROWS_PER_STEP random rows
    rewritten in place, recorded.  Returns ``red``."""
    heap = state["heap"]
    rows = torch.randperm(N_ROWS, generator=g, device=heap.device)[:ROWS_PER_STEP]
    heap.index_copy_(0, rows, torch.randn((ROWS_PER_STEP, ROW), generator=g,
                                          device=heap.device))
    ev = torch.zeros(N_ROWS, dtype=torch.bool, device=heap.device).index_fill_(0, rows, True)
    return store.on_write(red, events={"heap": ev})


def remesh_ticks(store, state, red, step: int, g, k3: list) -> tuple:
    """Ticks of heap writes until the queued or active migration is
    adopted.  Each tick's host ms (no device sync), its status and health
    actions are recorded, and each K3 call between CUDA events, marked
    ``window`` when a migration window made it (the group loop and the
    patroller are skipped while a migration runs, so the others are the
    blocking update after a drain).  A spin queued before the first event
    keeps the otherwise idle device busy while the host prepares the
    launch, so the events time the kernel, not the host's enqueue; the
    device is synchronised after each tick's host time is taken, so the
    spin never reaches the next tick's.  Returns ``(red, step, ticks)``."""
    ticks = []
    launch = fu_ops.fused_update_many

    def timed_k3(jobs, *a, **kw):
        jobs = list(jobs)
        a_, b_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a_.record()
        out = launch(jobs, *a, **kw)
        b_.record()
        k3.append({"events": (a_, b_), "jobs": len(jobs), "tick": len(ticks),
                   "window": store._remesh is not None})
        return out
    while store.remeshing:
        check(len(ticks) < 64, "the migration was not adopted within 64 ticks")
        step += 1
        red = remesh_write(store, state, red, g)
        fu_ops.fused_update_many = timed_k3
        try:
            t0 = time.perf_counter()
            red, rep = store.tick(state, red, step)
            host = (time.perf_counter() - t0) * 1e3
        finally:
            fu_ops.fused_update_many = launch
        torch.cuda.synchronize()
        state.update(rep.repaired)
        ticks.append({"step": step, "host_ms": host,
                      "status": None if rep.remesh is None else dataclasses.asdict(rep.remesh),
                      "actions": [] if rep.health is None else
                      [(a.group, a.rung, a.kind) for a in rep.health.actions],
                      "updated": list(rep.updated), "patrolled": list(rep.patrolled)})
    torch.cuda.synchronize()
    for r in k3:
        if "events" in r:
            x, y = r.pop("events")
            r["ms"] = x.elapsed_time(y)
    return red, step, ticks


def remesh_fresh_equal(store, state, red, what: str) -> None:
    """After a flush: every field of the heap's redundancy equals a store
    attached fresh on the store's (new) mesh over the same heap; the scrub
    is clean and verify_meta holds."""
    twin = ProtectedStore(dataclasses.replace(store.policy, patrol_bytes_per_tick=0,
                                              health=None, precompile=False),
                          mesh=store.mesh).attach(state, specs=store._specs)
    with uncounted():
        tred = twin.init(state)
        fields_equal(red, tred, what)
    del twin, tred
    check(store.scrub_check(state, red) == 0 and all(
        bool(v) for v in store.verify_meta(red).values()),
          f"{what}: scrub or verify_meta not clean")


def phase_remesh(g) -> dict:
    """Phase 24: phase 21's heap (8 row-range shards of 262,144 blocks) in a
    store of its own with no sync leaf (vilamb, T=16, deadline 32, the
    overlapped tick, the patroller at 64 MiB a shard, phase 14c's health
    governor): xpar covers the heap; grown (2, 2, 2) -> (2, 2, 4) and shrunk
    -> (1, 2, 2) online at REMESH_BUDGET a shard a window under writes of
    ROWS_PER_STEP rows a step, the shrink drained by the governor when the
    deadline's margin expires; a flush mid-way through a third, short
    migration drains it.  Returns the phase's record."""
    from repro_torch.health import HealthPolicy
    from repro_torch.remesh import RemeshInProgressError
    from repro_torch.remesh import migrate as migrate_mod
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    hp = HealthPolicy(dispatch_timeout_s=GOV_TIMEOUT_S, backpressure="error",
                      violation_mode="report")
    pol = RedundancyPolicy.single(
        "vilamb", period_steps=PERIOD, max_vulnerable_steps=DEADLINE, lanes_per_block=ROW,
        stripe_data_blocks=STRIPE, patrol_bytes_per_tick=PATROL_BUDGETS[0],
        remesh_bytes_per_tick=REMESH_BUDGET, health=hp)
    state = {"heap": torch.randn((N_ROWS, ROW), generator=g, device=dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    store = ProtectedStore(pol, mesh=make_mesh(MESH_SHAPE, MESH_AXES, device=dev)).attach(
        state, specs={"heap": HEAP_SPECS["heap"]})
    red = store.init(state)
    rec: dict = {}
    # 1. xpar covers the heap: a few steps of writes, a flush, quiet ticks.
    step = 0
    for step in range(1, 5):
        red, rep = store.tick(state, remesh_write(store, state, red, g), step)
        state.update(rep.repaired)
    red = store.flush(state, red, step)
    pat = store.patroller
    xp = pat.xpar["heap"]
    nb8, w = store.metas["heap"].n_blocks, pat.window["heap"]
    sweep_ticks = math.ceil(2 * -(-nb8 // w) * PERIOD / (PERIOD - 1))
    red, step = quiet_ticks(store, state, red, step, lambda: bool(xp.xvalid.all()),
                            2 * sweep_ticks + 16, [], [])
    red = store.flush(state, red, step)

    # 2. The grow, with its refusal of a second request.
    adopt_ms: list = []
    translate = migrate_mod.translate_words

    def timed_translate(*a, **kw):
        t0 = time.perf_counter()
        out = translate(*a, **kw)
        adopt_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    migrate_mod.translate_words = timed_translate
    try:
        store.remesh(make_mesh(GROW_SHAPE, MESH_AXES, device=dev))
        try:
            store.remesh(make_mesh(SHRINK_SHAPE, MESH_AXES, device=dev))
            raise SmokeError("a second remesh was accepted while one was queued")
        except RemeshInProgressError:
            pass
        k3_grow: list = []
        red, step, grow = remesh_ticks(store, state, red, step, g, k3_grow)
        st = grow[-1]["status"]
        nb16 = store.metas["heap"].n_blocks
        check(st["done"] and st["ticks"] == len(grow) == -(-nb16 // (REMESH_BUDGET // (4 * ROW)))
              == 8 and st["overflowed"] == 0 and st["migrated"] == nb16
              and store.shard_factor("heap") == 16 and store.geometry_version == 1
              and store.patroller is not pat and store.patroller.geometry_version == 1,
              f"the grow: {st}, {len(grow)} ticks, gv {store.geometry_version}")
        check(len(k3_grow) == len(grow) and all(r["jobs"] == 16 and r["tick"] == i
                                                 and r["window"]
                                                 for i, r in enumerate(k3_grow)),
              f"the grow's windows: {[(r['tick'], r['jobs']) for r in k3_grow]}")
        check(not any(t["actions"] for t in grow), f"the grow drew health actions {grow}")
        rec["grow_adopt_translate_ms"] = adopt_ms[-1]
        red = store.flush(state, red, step)
        remesh_fresh_equal(store, state, red, "after the grow")

        # 3. The shrink, with the governor's drain.
        store.remesh(make_mesh(SHRINK_SHAPE, MESH_AXES, device=dev))
        k3_shrink: list = []
        red, step, shrink = remesh_ticks(store, state, red, step, g, k3_shrink)
        st2 = shrink[-1]["status"]
        nb4 = store.metas["heap"].n_blocks
        drains = [i for i, t in enumerate(shrink) if any(a[2] == "remesh_drain"
                                                         for a in t["actions"])]
        check(st2["done"] and drains == [len(shrink) - 1] and len(shrink) < 32
              and st2["ticks"] == -(-nb4 // (REMESH_BUDGET // (4 * ROW))) == 32
              and st2["overflowed"] == 0 and store.shard_factor("heap") == 4
              and store.geometry_version == 2
              and sum(r["window"] for r in k3_shrink) == 32
              and all(r["jobs"] == 4 for r in k3_shrink),
              f"the shrink: {st2}, {len(shrink)} ticks, drains at {drains}, K3 calls "
              f"{[(r['tick'], r['jobs'], r['window']) for r in k3_shrink]}")
        rec["shrink_adopt_translate_ms"] = adopt_ms[-1]
        red = store.flush(state, red, step)
        remesh_fresh_equal(store, state, red, "after the shrink")

        # 4. A flush during a short third migration (back to (2, 2, 2))
        #    drains it.
        store.remesh(make_mesh(MESH_SHAPE, MESH_AXES, device=dev))
        step += 1
        red, rep = store.tick(state, remesh_write(store, state, red, g), step)
        check(rep.remesh is not None and not rep.remesh.done and store.remeshing,
              f"the third migration: {rep.remesh}")
        state.update(rep.repaired)
        red = store.flush(state, red, step)
        drained = store.take_repaired()
        check(not store.remeshing and store.geometry_version == 3
              and store.shard_factor("heap") == 8 and all(
                  t is state[n] for n, t in drained.items()),
              f"the flush did not drain the third migration ({sorted(drained)})")
        remesh_fresh_equal(store, state, red, "after the drained migration")
    finally:
        migrate_mod.translate_words = translate
    torch.cuda.synchronize()
    rec["launches"] = read_launches()
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    for name in ("checksum", "parity", "fused_update"):
        check(rec["launches"][name] > 0, f"{name} kernel never launched in phase 24")
    wb = REMESH_BUDGET // (4 * ROW)
    for name, ticks, k3, k in (("grow", grow, k3_grow, 16), ("shrink", shrink, k3_shrink, 4)):
        # A window's K3 reads the window's data and every shard's dirty words
        # once, and writes the window's checksums and its stripes' parity.
        b = bound(k * wb * ROW * 4 + N_ROWS // 8 + k * wb * 4 + k * wb // STRIPE * ROW * 4,
                  k * wb * ROW * 12)
        rec[name] = {"ticks": ticks, "k3_ms": [r["ms"] for r in k3 if r["window"]],
                     "other_k3_ms": [r["ms"] for r in k3 if not r["window"]],
                     "k3_bound_ms": b[0], "k3_bound_by": b[1], "window_blocks": wb,
                     "shards": k, "window_tick_host_ms": [t["host_ms"] for t in ticks[:-1]],
                     "adopt_tick_host_ms": ticks[-1]["host_ms"]}
    rec["wall_s"] = time.perf_counter() - t_phase
    del store, red, state
    return rec


def print_remesh(r: dict) -> None:
    print(f"remesh (phase 24, {r['wall_s']:.1f} s): launches {r['launches']}; peak "
          f"{r['peak_mem_gb']:.2f} GiB")
    for name in ("grow", "shrink"):
        x = r[name]
        k3 = x["k3_ms"]
        print(f"remesh {name}: {len(x['ticks'])} ticks to adoption ({x['shards']} shards, "
              f"windows of {x['window_blocks']} blocks a shard); a window's K3 median "
              f"{statistics.median(k3):.4f} ms over {len(k3)} windows "
              f"{[round(v, 4) for v in k3]} (bound {x['k3_bound_ms']:.4f} ms, "
              f"{x['k3_bound_by']}, {100 * x['k3_bound_ms'] / statistics.median(k3):.1f}%); "
              f"window ticks' host ms {[round(v, 3) for v in x['window_tick_host_ms']]}; "
              f"adoption tick {x['adopt_tick_host_ms']:.3f} ms, of it translating marks "
              f"{r[name + '_adopt_translate_ms']:.3f} ms; health actions "
              f"{[t['actions'] for t in x['ticks'] if t['actions']]}")


def chaos_tick_stats(ticks: list) -> dict:
    """Median and largest host ms of a list of the soak's ticks."""
    ms = [t["host_ms"] for t in ticks]
    return {"ticks": len(ms), "median_ms": statistics.median(ms) if ms else None,
            "max_ms": max(ms, default=None)}


def phase_chaos(g, seed: int) -> dict:
    """Phase 25: the chaos soak (``repro_torch.faults.chaos``) with the
    reference's sharded smoke schedule over an 8 GiB leaf on a simulated
    (1, 2, 2) mesh grown to (2, 2, 2): bitflips repaired by the patroller,
    a straggler storm, a crash restored by ``restore_verified`` into a fresh
    store, a shard lost and rebuilt from cross-shard parity under writes, a
    remesh queued mid-rebuild, the drain; every tick audited for silent
    deadline excursions, every fifth a ``read_verified`` spot check against
    the host mirror.  Checked against the invariants, the mirror, and a
    plain recompute of the final fields from the final leaf.  Returns the
    phase's record."""
    import shutil
    import tempfile
    from repro_torch.faults import ChaosSchedule
    from repro_torch.faults.chaos import N_COLS, _ChaosRunner
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    free_gb = shutil.disk_usage(tempfile.gettempdir()).free / 1e9
    check(free_gb > CHAOS_DISK_GB, f"phase 25 needs {CHAOS_DISK_GB} GB on disk in "
          f"{tempfile.gettempdir()}; {free_gb:.1f} GB are free")
    sched = ChaosSchedule.default(seed, sharded=True, smoke=True)
    t0 = time.perf_counter()
    initial = np.empty((CHAOS_ROWS, N_COLS), np.float32)
    buf = torch.empty((CHAOS_ROWS // 32, N_COLS), pin_memory=dev.type == "cuda")
    for a in range(0, CHAOS_ROWS, len(buf)):      # through pinned memory
        buf.copy_(torch.randn(buf.shape, generator=g, device=dev))
        initial[a:a + len(buf)] = buf.numpy()
    del buf
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # The runner keeps ``initial`` as its mirror (no second host copy).
    runner = _ChaosRunner(sched, sharded=True, device=dev, initial=initial,
                          n_rows=CHAOS_ROWS, rows_per_step=CHAOS_ROWS_PER_STEP)
    del initial
    torch.cuda.synchronize()
    rec: dict = {"setup_s": time.perf_counter() - t0}
    st = runner.store
    # The reference's 16 KiB a shard a tick over its 512 KiB leaf, scaled.
    patrol = (16 << 10) * CHAOS_ROWS // 64
    check(st.shard_factor("w") == 4 and st.policy.patrol_bytes_per_tick == patrol
          and st.patroller.window["w"] == patrol // (128 * 4),
          f"phase 25's store: {st.shard_factor('w')} shards, patrol "
          f"{st.policy.patrol_bytes_per_tick} B")
    del st
    t0 = time.perf_counter()
    res = runner.run()
    torch.cuda.synchronize()
    rec["run_s"] = time.perf_counter() - t0
    rec["launches"] = read_launches()
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    rec["summary"] = res.summary()
    rec["result"] = dataclasses.asdict(res)
    kinds = tuple(p.kind for p in sched.phases)
    check(res.ok() and res.phases_run == kinds, f"the soak: {res.summary()}")
    check(res.bitflips_injected > 0 and res.bitflips_repaired == res.bitflips_injected
          and res.crash_restores == 1 and res.rebuild_done and res.remesh_done,
          f"the storms: {res}")
    check(res.reads_checked > 0 and res.reads_stale == 0 and res.silent_violations == 0
          and res.final_clean and res.final_bitwise, f"the invariants: {res}")
    store, leaves, red = runner.store, runner.leaves, runner.red
    check(store.geometry_version == 1 and store.shard_factor("w") == 8,
          f"after the remesh: geometry_version {store.geometry_version}, "
          f"{store.shard_factor('w')} shards")
    check(all(bool(v) for v in store.verify_meta(red).values()),
          "verify_meta after the final flush")
    check(res.named_lost_rows_restored <= res.named_lost_blocks,
          f"named losses: {res.named_lost_blocks} blocks, "
          f"{res.named_lost_rows_restored} rows restored")
    check(not bool((red["w"].dirty | red["w"].shadow).any()),
          "marks left after the final flush")
    rec["full_check"] = sharded_full_check(store, leaves, red, ["w"])
    for name in ("checksum", "parity", "fused_update"):
        check(rec["launches"][name] > 0, f"{name} kernel never launched in phase 25")
    phases = []
    for p in runner.timings["phases"]:
        phases.append({"kind": p["kind"], "wall_s": p["wall_s"],
                       **chaos_tick_stats(p["ticks"])})
    every = [t for p in runner.timings["phases"] for t in p["ticks"]]
    rec["phases"] = phases
    rec["crash"] = runner.timings["crash"]
    rec["final_check_s"] = runner.timings["final_check_s"]
    rec["rebuild_ticks"] = chaos_tick_stats([t for t in every if t["rebuild"]])
    rec["remesh_ticks"] = chaos_tick_stats([t for t in every if t["remesh"]])
    rec["quiesce_ticks"] = next(p["ticks"] for p in phases if p["kind"] == "quiesce")
    rec["leaf_gib"] = CHAOS_ROWS * N_COLS * 4 / 2**30
    del runner, store, leaves, red
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


def print_chaos(r: dict) -> None:
    x = r["result"]
    print(f"chaos (phase 25, {r['wall_s']:.1f} s: set-up {r['setup_s']:.1f}, soak "
          f"{r['run_s']:.1f}, of it the final settle, flush, scrub and comparison "
          f"{r['final_check_s']:.1f}): {r['leaf_gib']:.0f} GiB leaf; launches "
          f"{r['launches']}; peak {r['peak_mem_gb']:.2f} GiB")
    print(f"chaos: {r['summary']}")
    print(f"chaos: bitflips {x['bitflips_injected']} injected, {x['bitflips_repaired']} "
          f"repaired; crash restores {x['crash_restores']}; named losses "
          f"{x['named_lost_blocks']} blocks, {x['named_lost_rows_restored']} rows restored "
          f"from the mirror; reads {x['reads_checked']} (typed {x['reads_typed_errors']}, "
          f"stale {x['reads_stale']}); detect_latency_stats {x['detect_latency_stats']}; "
          f"mttdl_live_s {x['mttdl_live_s']:.6g}")
    for p in r["phases"]:
        med = "-" if p["median_ms"] is None else f"{p['median_ms']:.3f}"
        mx = "-" if p["max_ms"] is None else f"{p['max_ms']:.3f}"
        print(f"chaos phase {p['kind']}: {p['wall_s']:.3f} s, {p['ticks']} ticks, host ms "
              f"median {med} max {mx}")
    c = r["crash"]
    print(f"chaos crash: save {c['save_s']:.2f} s ({c['bytes'] / 1e9:.2f} GB), "
          f"restore_verified {c['restore_s']:.2f} s ({c['tried']}); quiesce took "
          f"{r['quiesce_ticks']} ticks; rebuild ticks {r['rebuild_ticks']}; remesh ticks "
          f"{r['remesh_ticks']}; full check {r['full_check']}")



def traced_cell(cfg, shape, **kw) -> dict:
    """One cell traced on the meta device (``dryrun.trace_cell``, one card:
    no mesh): its parts' counts, the memory model's terms, the seconds."""
    setup, parts, secs = dryrun.trace_cell(cfg, shape, None, "vilamb", accum=1, **kw)
    return {"parts": {n: costs_record(c) for n, c in parts.items()}, "seconds": secs,
            "hbm": memory_model.analytic_hbm(cfg, shape, None, setup, "vilamb", 1)}


def dry_run_traces() -> dict:
    """Phase 26 (a), (d) and (e) on the meta device, in a process of its
    own (it needs no card): phase 7's serving cell (the prefill into
    caches of max_len; the store's init, one decode step at the prompt's
    end, a redundancy pass), phase 9's training cell (the store's init,
    one step, a redundancy pass), the training step's roofline, the
    Algorithm-1 cell of llama3.2-3b on one card, and arctic-480b cut to
    ARCTIC_DRY_LAYERS layers at phase 11's serving shapes."""
    t0 = time.perf_counter()
    max_len = PROMPT + GEN + 1
    serve_cfg, train_cfg = get_arch(SERVE_ARCH), get_arch(TRAIN_ARCH)
    train_shape = ShapeConfig("train_4k_batch1", TRAIN_SEQ, TRAIN_BATCH, "train")
    out = {"prefill": traced_cell(serve_cfg, ShapeConfig("serve_prefill", PROMPT, SERVE_BATCH,
                                                         "prefill"), max_len=max_len),
           "decode": traced_cell(serve_cfg, ShapeConfig("serve_decode", max_len, SERVE_BATCH,
                                                        "decode"), pos=PROMPT),
           "train": traced_cell(train_cfg, train_shape)}
    step = out["train"]["parts"]["step"]
    out["train"]["roofline"] = CA.roofline_terms(
        step["total_flops"], step["total_bytes"], 0.0, 1,
        dryrun.model_flops(train_cfg, train_shape)).as_dict()
    red = dryrun.run_redundancy_cell(TRAIN_ARCH, multi_pod=None,
                                     out_dir=Path(__file__).resolve().parent / "build" / "dryrun")
    out["redundancy_cell"] = {k: red[k] for k in ("bound_ms", "bound_by", "trace_s",
                                                  "state_bytes_per_chip", "memory_efficiency")}
    arctic = dataclasses.replace(get_arch(ARCTIC_ARCH), n_layers=ARCTIC_DRY_LAYERS)
    out["arctic"] = {
        "prefill": traced_cell(arctic, ShapeConfig("serve_prefill", PROMPT, SERVE_BATCH,
                                                   "prefill"), max_len=max_len),
        "decode": traced_cell(arctic, ShapeConfig("serve_decode", max_len, SERVE_BATCH,
                                                  "decode"), pos=PROMPT)}
    out["seconds"] = time.perf_counter() - t0
    return out


def op_diff(card: dict, meta: dict) -> dict:
    """The aten ops whose counts differ between two records' ``by_op``."""
    return {k: (card.get(k), meta.get(k)) for k in sorted(set(card) | set(meta))
            if card.get(k) != meta.get(k)}


def phase_dry_run(traces: dict, serve: dict, train: dict) -> dict:
    """Phase 26: the dry run against the card.  (b) each part of phases 7's
    and 9's counted steps equals its meta trace's FLOPs, bytes and
    per-kernel launches and work exactly; (c) the memory model's params,
    moments, caches and redundancy equal the bytes the phases held, its
    totals beside their peaks, and its budget the card's total memory;
    (d) the training step's roofline beside phase 9's median step, and the
    Algorithm-1 cell's bound beside phase 9's K3; (e) arctic-480b's
    itemised totals against the budget."""
    t0 = time.perf_counter()
    rec: dict = {"trace_s": {k: traces[k]["seconds"] for k in ("prefill", "decode", "train")},
                 "traces_s": traces["seconds"]}
    cells = {"prefill": serve["counted"]["prefill"], "decode": serve["counted"]["decode"],
             "train": train["counted"]}
    rec["counts"] = {}
    for kind, card in cells.items():
        meta = traces[kind]["parts"]
        check(list(card["parts"]) == list(meta), f"{kind}: parts {list(card['parts'])} on the "
              f"card, {list(meta)} traced")
        for part, c in card["parts"].items():
            m = meta[part]
            check(c["key"] == m["key"], f"{kind} {part}: the card counted {c['key']}, the meta "
                  f"trace {m['key']}; ops that differ (card, meta): "
                  f"{op_diff(c['by_op'], m['by_op'])}")
            rec["counts"][f"{kind}/{part}"] = {
                "flops": c["key"]["flops"], "bytes": c["key"]["bytes"],
                "kernels": c["key"]["kernels"], "aten_ops": c["aten_ops"],
                "card_copies": c["copies"], "meta_copies": m["copies"]}
    rec["launches"] = {k: v["launches"] for k, v in cells.items()}
    rec["counted_s"] = {k: v["seconds"] for k, v in cells.items()}

    # (c) memory: the model's terms against the bytes held.
    want = {("decode", "params"): serve["held"]["params"],
            ("decode", "caches"): serve["held"]["caches"],
            ("decode", "redundancy"): serve["held"]["redundancy"],
            ("train", "params"): train["held"]["params"],
            ("train", "moments"): train["held"]["moments"],
            ("train", "redundancy"): train["held"]["redundancy"]}
    for (cell, term), held in want.items():
        got = traces[cell]["hbm"][term]
        check(got == held, f"memory model {cell}/{term} {got} B, the phase held {held} B")
    total = torch.cuda.get_device_properties(0).total_memory
    check(total == memory_model.HBM_BUDGET,
          f"HBM_BUDGET {memory_model.HBM_BUDGET} != the card's total_memory {total}")
    peak = {"prefill": serve["peak_gb"], "decode": serve["peak_gb"], "train": train["peak_gb"]}
    rec["memory"] = {
        "held": {"serving": serve["held"], "training": train["held"]},
        "model": {k: traces[k]["hbm"] for k in ("prefill", "decode", "train")},
        "total_vs_peak": {k: {"model_gib": traces[k]["hbm"]["total"] / 2**30,
                              "peak_gib": peak[k],
                              "ratio": traces[k]["hbm"]["total"] / 2**30 / peak[k]}
                          for k in peak},
        "hbm_budget": memory_model.HBM_BUDGET, "total_memory": total}

    # (d) rooflines against phase 9's times.
    rl = traces["train"]["roofline"]
    step_flops = train["counted"]["parts"]["step"]["total_flops"]
    rec["roofline"] = {
        "train_step": rl, "roofline_s": max(rl["compute_s"], rl["memory_s"]),
        "median_step_s": {k: v / 1e3 for k, v in train["median_step_ms"].items()},
        "counted_flop_share": {k: step_flops / (v / 1e3) / CA.PEAK_BF16_FLOPS
                               for k, v in train["median_step_ms"].items()},
        "model_flop_share": train["model_flop_share"],
        "redundancy_cell": traces["redundancy_cell"], "k3_due_tick_ms": train["k3_ms"]}

    # (e) arctic-480b at ARCTIC_DRY_LAYERS layers on one card.
    rec["arctic"] = {kind: {"hbm": c["hbm"], "trace_s": c["seconds"],
                            "fits": c["hbm"]["fits_hbm_analytic"],
                            "budget": memory_model.HBM_BUDGET * memory_model.HEADROOM,
                            "kernels": {p: v["key"]["kernels"] for p, v in c["parts"].items()}}
                     for kind, c in traces["arctic"].items()}
    rec["phase_s"] = time.perf_counter() - t0
    return rec


def print_dry_run(r: dict) -> None:
    for name, c in r["counts"].items():
        k = ", ".join(f"{n} {v[0]}" for n, v in c["kernels"].items()) or "no kernel"
        print(f"dry run {name}: card == meta trace: {c['flops']} FLOP, {c['bytes']} B, "
              f"{c['aten_ops']} aten ops, launches {k}; named copies card "
              f"{c['card_copies']} meta {c['meta_copies']}")
    print(f"dry run: meta traces {r['trace_s']} s (all traces {r['traces_s']:.1f} s, in a "
          f"process of their own); the counted runs on the card {r['counted_s']} s (inside "
          f"phases 7 and 9); phase 26 itself {r['phase_s']:.2f} s")
    m = r["memory"]
    print(f"dry run memory: the model's params, moments, caches and redundancy equal the "
          f"bytes held: serving {m['held']['serving']}, training {m['held']['training']}; "
          f"HBM_BUDGET {m['hbm_budget']} == total_memory {m['total_memory']}")
    for k, v in m["total_vs_peak"].items():
        print(f"dry run memory {k}: model total {v['model_gib']:.2f} GiB, the phase's peak "
              f"{v['peak_gib']:.2f} GiB, ratio {v['ratio']:.3f} ({m['model'][k]})")
    rl = r["roofline"]
    print(f"dry run roofline: training step {rl['roofline_s'] * 1e3:.1f} ms (compute "
          f"{rl['train_step']['compute_s'] * 1e3:.1f} ms, memory "
          f"{rl['train_step']['memory_s'] * 1e3:.1f} ms) against phase 9's median steps "
          f"{ {k: round(v * 1e3, 1) for k, v in rl['median_step_s'].items()} } ms; counted-FLOP "
          f"share { {k: round(100 * v, 2) for k, v in rl['counted_flop_share'].items()} }%, "
          f"model-FLOP share { {k: round(100 * v, 2) for k, v in rl['model_flop_share'].items()} }%")
    rc = rl["redundancy_cell"]
    print(f"dry run Algorithm 1 over llama3.2-3b's params and moments (full pass): bound "
          f"{rc['bound_ms']:.3f} ms ({rc['bound_by']}) against phase 9's K3 in its traced due "
          f"tick {rl['k3_due_tick_ms']} ms")
    for kind, a in r["arctic"].items():
        print(f"dry run arctic-480b at {ARCTIC_DRY_LAYERS} layers, {kind} (batch {SERVE_BATCH}, "
              f"prompt {PROMPT}, max_len {PROMPT + GEN + 1}): itemised {a['hbm']} against "
              f"the budget {a['budget'] / 2**30:.2f} GiB ({memory_model.HBM_BUDGET} x "
              f"{memory_model.HEADROOM}): fits {a['fits']}")


def k3_trace_ms(trace: dict):
    """K3's device ms in a traced window (``stream_overlap``'s
    ``fused_update_us``), or "not measured" where the trace has none."""
    us = trace.get("fused_update_us")
    return us / 1e3 if isinstance(us, (int, float)) else "not measured"


def clock(name: str, t_start: float) -> None:
    """The script's clock at the end of a phase (the time limit is the
    whole script's)."""
    print(f"clock: {name} done at {time.perf_counter() - t_start:.1f} s", flush=True)

def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    print(smi_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    count_k3_calls()
    print_build_log(lib)
    # Phase 26's meta traces need no card: they run in a process of their
    # own while the phases before them run.
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        return run_phases(args, t_start, pool.apply_async(dry_run_traces))
    finally:
        pool.terminate()
        pool.join()


def run_phases(args, t_start: float, traces) -> int:
    """Phases 3-26 (``traces``: phase 26's meta traces, running)."""

    # The plain versions' fp32 products stay in full fp32 (torch's default,
    # stated here): no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    err = phase_kernels(g)
    print(f"kernels == plain at small shapes: {err}", flush=True)

    t0 = time.perf_counter()
    main_run = phase_main(g)
    print(f"main path ({time.perf_counter() - t0:.1f} s): launches "
          f"{main_run['launches']}", flush=True)
    ov = main_run["timings"]["overlap"]
    for kind in ("async", "blocking"):
        r = ov[kind]
        print(f"heap {kind}: due ticks {r['due_steps']} host "
              f"{[round(x, 3) for x in r['due_tick_host_ms']]} ms (no device sync; "
              f"16 traced); steps 15-18, 31-34, 47-50 wall "
              f"{[round(x, 3) for x in r['window_ms']]} ms (15-18 traced); due tick "
              f"{STEPS} synchronised {main_run['timings']['synced_due_tick_ms'][kind]:.3f} "
              f"ms; trace of steps 15-18: {r['trace_steps_15_18']}")
    print("heap: the overlapped store equals its blocking twin on clean blocks and "
          "stripes after each settle and everywhere after flush; its fused updates "
          "ran on its side stream", flush=True)
    phase_update_profile(g, main_run)
    kernels = phase_kernel_times(g, main_run, err)
    fq = main_run["timings"]["fused_queue"]
    print(f"K3 on the heap's due tick ({fq['stripes']} dirty stripes, one launch): "
          f"{fq['ms']:.4f} ms against its {fq['bound_ms']:.4f} ms bound "
          f"({100 * fq['bound_ms'] / fq['ms']:.1f}%; PR 20's bound, which counted the "
          f"bool masks and ids, {fq['pr20_bound_ms']:.4f} ms); PR 20: {fq['pr20_ms']} ms "
          f"(wrapper, one launch a leaf)", flush=True)
    phase_full_check(main_run["store"], main_run["state"], main_run["red"])
    print("full check: checksums and parity of every block match a chunked plain "
          "recompute")
    print(json.dumps({"main": main_run["timings"]}), flush=True)
    clock("main", t_start)
    heap_launches = main_run["launches"]
    del main_run
    torch.cuda.empty_cache()

    flash_cases = phase_flash_small(g)
    print(json.dumps({"flash_small": flash_cases}))
    clock("flash_small", t_start)
    print(f"flash == plain at small shapes: max abs err "
          f"{max(c[4] for c in flash_cases)}, max rel L2 err "
          f"{max(c[5] for c in flash_cases)}", flush=True)
    t0 = time.perf_counter()
    serve = phase_serve(g)
    tm = serve["timings"]
    print(f"serve ({time.perf_counter() - t0:.1f} s): launches {serve['launches']}")
    print(f"serve: prefill {tm['prefill_ms']:.1f} ms; decode "
          f"{tm['decode_ms_per_token']:.2f} ms/token, {tm['decode_tokens_per_s']:.1f} "
          f"tokens/s ({tm['decode_ms_per_token_no_store']:.2f} ms/token, "
          f"{tm['decode_tokens_per_s_no_store']:.1f} tokens/s with no store); "
          f"generate {tm['generate_tokens_per_s']:.1f} tokens/s end to end "
          f"({tm['generate_tokens_per_s_no_store']:.1f} with no store, overhead "
          f"{100 * tm['store_overhead']:.2f}%); due "
          f"ticks {[round(x, 2) for x in tm['due_tick_ms']]} ms over "
          f"{tm['due_tick_dirty_blocks']} dirty blocks; peak {tm['peak_mem_gb']:.2f} GiB")
    for key, label in (("decode_profile", "with"), ("decode_profile_no_store", "without")):
        p = tm[key]
        print(f"serve: decode {label} the store, traced: {p['launches_per_token']:.0f} "
              f"launches and {p['device_busy_ms_per_token']} ms of device time a token")
    print(f"serve: generate in turns (async, none, blocking, blocking, none, async): "
          f"async {[round(x, 4) for x in tm['generate_s']]} s, none "
          f"{[round(x, 4) for x in tm['generate_s_no_store']]} s, blocking "
          f"{[round(x, 4) for x in tm['generate_s_blocking']]} s; overhead async "
          f"{100 * tm['store_overhead']:.2f}%, blocking "
          f"{100 * tm['store_overhead_blocking']:.2f}%; tokens identical for all")
    print(f"serve: due ticks' host ms (no device sync): "
          f"{ {k: [round(x, 3) for x in v] for k, v in tm['due_tick_host_ms'].items()} }; "
          f"quiet ticks { {k: round(v, 4) for k, v in tm['quiet_tick_host_ms_mean'].items()} }")
    print("serve: due ticks' host ms, medians (tick, its dispatch, its scrub): "
          + "; ".join(f"{k} {v['ms']:.3f}, {v['dispatch_ms']:.3f}, {v['scrub_ms']:.3f}"
                      for k, v in tm["due_tick_host_ms_median"].items()))
    for key in ("decode_profile_due_async", "decode_profile_due_blocking"):
        p = {k: v for k, v in tm[key].items() if k != "top_kernels_ms_per_token"}
        print(f"serve: {key} (ticks {p['ticks']}): {p}")
    print(f"serve: tokens identical with and without the store; scrub clean; block "
          f"{tm['corrupted_block']} of slot_0/k corrupted, found and repaired; layer-0 "
          f"attention within bounds of plain: {serve['layer0_err']}")
    with torch.inference_mode():
        phase_full_check(serve["store"], flatten_dict(serve["caches"]), serve["red"])
    print("serve full check: every cache checksum and parity row matches a chunked "
          "plain recompute")
    row, flash = phase_flash_time(serve, max([c[4] for c in flash_cases]
                                             + [serve["layer0_err"]["max_abs_err"]]))
    kernels.append(row)
    print(f"flash at the prefill's shapes {flash['shape']}: {row['ms']:.4f} ms, "
          f"{flash['tflops']:.1f} TFLOP/s, {100 * flash['share_of_bound']:.1f}% of its "
          f"{row['bound_ms']:.4f} ms bound; scaled_dot_product_attention "
          f"{row['library_ms']:.4f} ms; plain {row['plain_ms']:.2f} ms")
    print(json.dumps({"flash": flash}))
    print(json.dumps({"serve": tm}))
    print(json.dumps({"serve_launches": serve["launches"]}))
    clock("serve", t_start)
    serve_dry = {"counted": serve["counted"], "held": serve["held"],
                 "peak_gb": tm["peak_mem_gb"]}
    serve_launches = serve["launches"]
    patrol_serve = serve["patrolled"]
    serve_tokens, serve_gen_state = serve["tokens"], serve["gen_state"]
    serve_none_s = tm["generate_s_no_store"]
    del serve
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train = phase_train(args.seed)
    m = train["main"]
    train_dry = {"counted": train.pop("counted"), "held": m["held"], "peak_gb": m["peak_mem_gb"],
                 "median_step_ms": {k: o["median_step_ms"] for k, o in train["observe"].items()},
                 "model_flop_share": {k: o["model_flop_share"]
                                      for k, o in train["observe"].items()},
                 "k3_ms": k3_trace_ms(m["trace_steps_7_9"])}
    print(f"train ({time.perf_counter() - t0:.1f} s): {TRAIN_ARCH} full size, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MAIN_STEPS} steps under the overlapped vilamb "
          f"store over {m['memory_gb']['leaves']} leaves ({m['memory_gb']['state']:.2f} GB, "
          f"{m['memory_gb']['blocks']} blocks, {m['memory_gb']['parity']:.2f} GB parity); "
          f"launches {m['launches']}; peak {m['peak_mem_gb']:.2f} GiB")
    print(f"train: losses {[round(x, 4) for x in m['losses']]}")
    print(f"train: due ticks' host ms (no device sync): "
          f"{[(t['step'], round(t['ms'], 3)) for t in m['due_ticks']]}; quiet ticks "
          f"{m['quiet_tick_host_ms_mean']:.4f} ms; flush {m['flush_ms']:.2f} ms; scrub "
          f"{m['scrub_check_ms']:.2f} ms")
    tr = {k: v for k, v in m["trace_steps_7_9"].items() if k != "top_kernels_ms"}
    print(f"train: trace of steps 7-9: {tr}")
    print(f"train: K3 in the traced due tick: {tr.get('fused_update_us', 'not measured')} µs "
          f"over {tr['fused_update_launches']} launches (PR 20, one launch a leaf: "
          f"{K3_BEFORE['train due tick']} ms over 33 launches)")
    for kind, o in train["observe"].items():
        print(f"train: {kind} store, {OBS_TRAIN_STEPS} steps: median step "
              f"{o['median_step_ms']:.2f} ms (steps 3-{OBS_TRAIN_STEPS}), {o['tokens_per_s']:.1f} tokens/s, model-FLOP share "
              f"{100 * o['model_flop_share']:.2f}%; run {o['run_s']:.3f} s, drained "
              f"{o['drained_s']:.3f} s; due ticks' host ms {o['due_tick_host_ms']}")
    print(f"train: store overhead on a step (median) "
          f"{ {k: round(100 * v, 3) for k, v in train['store_overhead'].items()} }%, "
          f"on the drained run "
          f"{ {k: round(100 * v, 3) for k, v in train['store_overhead_drained'].items()} }%; "
          f"losses and final params checksums bitwise equal for the overlapped, blocking "
          f"and no store; lazy embedding rows bit-identical; full check, scrub and "
          f"recovery passed")
    print(json.dumps({"train": train}))
    clock("train", t_start)
    train_launches = m["launches"]
    del train
    gc.collect()
    torch.cuda.empty_cache()

    rec = phase_recovery(args.seed)
    print_recovery(rec)
    print(smi_line())
    print(json.dumps({"recovery": rec}))
    clock("recovery", t_start)
    gc.collect()
    torch.cuda.empty_cache()

    moe_serve = phase_serve_moe(g)
    print_serve_moe(moe_serve)
    print(json.dumps({"serve_moe": moe_serve}))
    moe_train = phase_train_moe(args.seed)
    print_train_moe(moe_train)
    print(smi_line())
    print(json.dumps({"train_moe": moe_train}))
    clock("train_moe", t_start)
    gc.collect()
    torch.cuda.empty_cache()

    fl = phase_faults(args.seed)
    print_faults(fl)
    print(smi_line())
    print(json.dumps({"faults": fl}))
    clock("faults", t_start)
    gc.collect()
    torch.cuda.empty_cache()

    pt = phase_patrol(args.seed, fl)
    print_patrol(pt)
    print(f"serve with patrol (phase 14d): {patrol_serve}")
    print(smi_line())
    print(json.dumps({"patrol": pt, "serve_patrolled": patrol_serve}))
    clock("patrol", t_start)
    gc.collect()
    torch.cuda.empty_cache()

    hy = phase_serve_recurrent(g, hybrid_config(), HYBRID_PARAMS, list(HYBRID_CORRUPT),
                               turns=False)
    print_serve_recurrent("serve hybrid", hy)
    print(smi_line())
    print(json.dumps({"serve_hybrid": hy}))
    clock("serve_hybrid", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    xl = phase_serve_recurrent(g, xlstm_config(), XLSTM_PARAMS, list(XLSTM_CORRUPT),
                               turns=True)
    print_serve_recurrent("serve xlstm", xl)
    print(smi_line())
    print(json.dumps({"serve_xlstm": xl}))
    clock("serve_xlstm", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    vl = phase_serve_multimodal(g, vlm_config(), VLM_PARAMS, list(VLM_CORRUPT))
    print_serve_multimodal("serve vlm", vl)
    print(json.dumps({"serve_vlm": vl}))
    clock("serve_vlm", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    ed = phase_serve_multimodal(g, encdec_config(), ENCDEC_PARAMS, list(ENCDEC_CORRUPT))
    print_serve_multimodal("serve enc-dec", ed)
    print(json.dumps({"serve_encdec": ed}))
    clock("serve_encdec", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    te = phase_train_encdec(args.seed)
    print_train_encdec(te)
    print(smi_line())
    print(json.dumps({"train_encdec": te}))
    clock("train_encdec", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    tx = phase_train_xlstm(args.seed)
    print_train_xlstm(tx)
    print(smi_line())
    print(json.dumps({"train_xlstm": tx}))
    clock("train_xlstm", t_start)
    th = phase_train_hybrid(args.seed)
    print_train_hybrid(th)
    print(smi_line())
    print(json.dumps({"train_hybrid": th}))
    clock("train_hybrid", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    sh = phase_sharded_heap(g)
    print_sharded_heap(sh)
    print(smi_line())
    print(json.dumps({"sharded_heap": sh}))
    clock("sharded_heap", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    ss = phase_serve_sharded(serve_gen_state, serve_tokens, serve_none_s)
    print_serve_sharded(ss)
    print_serve_sharded_patrolled(ss["patrolled"])
    print(smi_line())
    print(json.dumps({"serve_sharded": ss}))
    clock("serve_sharded", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    sp = phase_sharded_patrol(g)
    print_sharded_patrol(sp)
    print(smi_line())
    print(json.dumps({"sharded_patrol": sp}))
    clock("sharded_patrol", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    rm = phase_remesh(g)
    print_remesh(rm)
    print(smi_line())
    print(json.dumps({"remesh": rm}))
    clock("remesh", t_start)
    gc.collect()
    torch.cuda.empty_cache()
    ch = phase_chaos(g, args.seed)
    print_chaos(ch)
    print(smi_line())
    print(json.dumps({"chaos": ch}))
    clock("chaos", t_start)
    dr = phase_dry_run(traces.get(timeout=900), serve_dry, train_dry)
    print_dry_run(dr)
    print(smi_line())
    print(json.dumps({"dry_run": dr}))
    clock("dry_run", t_start)
    for row in kernels:
        by_path = {"heap": heap_launches.get(row["name"], 0),
                   "serving": serve_launches[row["name"]],
                   "training": train_launches[row["name"]],
                   "recovery": rec["launches"][row["name"]],
                   "serving_moe": moe_serve["launches"][row["name"]],
                   "training_moe": moe_train["main"]["launches"][row["name"]],
                   "faults": fl["launches"][row["name"]],
                   "patrol": pt["launches"][row["name"]]
                   + patrol_serve["launches"][row["name"]],
                   "hybrid serving": hy["launches"][row["name"]],
                   "xlstm serving": xl["launches"][row["name"]],
                   "vlm serving": vl["launches"][row["name"]],
                   "enc-dec serving": ed["launches"][row["name"]],
                   "enc-dec training": te["main"]["launches"][row["name"]],
                   "xlstm training": tx["main"]["launches"][row["name"]],
                   "hybrid training": th["launches"][row["name"]],
                   "sharded heap": sh["launches"][row["name"]],
                   "sharded serving": ss["launches"][row["name"]],
                   "sharded patrol": sp["launches"][row["name"]]
                   + ss["patrolled"]["launches"][row["name"]],
                   "remesh": rm["launches"][row["name"]],
                   "chaos": ch["launches"][row["name"]],
                   "dry run check": sum(c["launches"][row["name"]]
                                        for c in (serve_dry["counted"]["prefill"],
                                                  serve_dry["counted"]["decode"],
                                                  train_dry["counted"]))}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
