#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:

1. print the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; build the kernels from ``mxnet_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, the
   forward kernels at the serving path's shapes and every kernel, forward
   and backward, at the training path's, with the tolerance stated beside
   each check, and time the kernel, the plain version and one PyTorch
   library call that computes the same function (a yardstick the port
   never calls) with CUDA events, beside the least time the card could
   take; the bf16 flash forward and backward (tensor cores) are held
   against the plain versions in float32 on the same bf16 operands, must
   give bit-identical results twice, and report their TFLOP/s, their
   share of the bound and ptxas's spill bytes; the float32 flash forward
   and backward (tensor cores, 3xTF32) must give bit-identical results
   twice too, their bound the 3xTF32 one with the CUDA-core bound beside
   it; the forward in both dtypes, and the bf16 backward, also on a k
   whose rows the kernels cannot copy 16 bytes at a time (the wrappers'
   aligned copy); flash
   attention at head widths 16 (the plain route), 32, 48, 80, 96 and 160
   (zero-padded to the kernels' widths), 192 (padded to 256) and 256,
   causal and not, and 320 (padded to 384), forward and backward, float32 and
   bf16, on all four kernel routes, each on its route's counters and
   twice bit for bit; and LayerNorm, forward and backward, each twice bit
   for bit, in every layout and vector width its plans pick (N = 30 in
   bf16, 768, 1000, 1024, 8192, rows wider than its registers hold at
   12300 and 16384, a view one element past a 16-byte boundary, and the
   decode shape (8, 768)), at the training shape (32768, 768) timed with
   its inputs warm in L2 and cold, beside the bytes bound, with ptxas's
   registers and spills of the kernels that ran;
3. serve 16 requests at GPT-2-small widths through the default (paged)
   `ServingEngine`, count each kernel's launches, and check the logits
   of two finished requests against the plain float32 path;
4. serve 4 long-prompt requests through the slot-cache engine, whose
   prefill runs the flash-attention kernel;
4b. serving, shared prefix and request contract: on the default engine's
   own thread (`start`, prefix caching on), 15 requests of one 512-token
   system prompt plus a 16-256-token suffix (odd ones sampled), the
   first alone until its first token, then the rest and the bare prompt
   (a full-cover bootstrap); the same through ``prefix=False`` and
   through a pool of 87 blocks that must preempt.  Tokens must agree
   request by request, or part only where the plain float32 path's
   choice was within 1e-3; the prefix counters must show every later
   request sharing the prompt, a bootstrap and a copy-on-write, and no
   block may leak after `drain`.  Then the request contract: a deadline
   and a cancel behind a full batch, ``queue_max=2`` under ``shed`` and
   ``degrade``, and `stop`, each resolving typed;
5. profile a few decode steps, and one long slot-cache prefill, to see
   where the eager loop's time goes;
6. train the GPT-2-small parity configuration of
   ``tools/benchmark_transformer.py`` (bhsd attention, bf16 compute,
   Adam) at full width for 7 steps through `SPMDTrainer`, counting each
   kernel's launches per step, timing and profiling the steps, and
   checking that the loss falls;
7. check one step's float32 gradients of the same model (batch 2) through
   the kernels against the same step through their plain versions;
8. train the transposeless configuration (6 heads of 128, 'bsd'
   attention, no biases) at full width for 3 steps, and check one f32
   step's gradients of it (batch 2); then the parity configuration in
   float32, the trainer's default dtype, for 3 steps (its flash forward
   and backward run the 3xTF32 kernels);
9. hold the four fused CE kernels (stats forward, single-pass forward,
   dW/db, dx) and the 5-pass backward against their plain versions, in
   float32 (tensor cores, 3xTF32) and bf16 (tensor cores, against the
   plain version in bf16), each twice bit for bit, at the training
   head's shape (32768 tokens, 768, vocab 32768; timed beside `F.linear`
   + `F.cross_entropy`, with TFLOP/s, share of the bound, in float32 the
   3xTF32 bound with the CUDA-core one beside it, and ptxas's registers
   and spills) and at ragged ones with ignored and
   out-of-range labels, no bias and grad_scale 1.7: 1000 tokens at 768
   and vocab 50257, GPT-2 medium's width (8192 tokens, 1024, 50257),
   GPT-2 XL's (1000, 1600, 50257: past the widest float32 cluster, in
   windows), LLaMA-7B's 4096 (300 tokens, vocab 5000: past the widest
   cluster in both dtypes, in windows), in bf16 (333, 772, 1000), whose
   d the wrapper zero-pads to 776 and counts, and (333, 30, 1000) in both
   dtypes, zero-padded to 32 and counted;
10. train bench.py's ``fused_`` configuration (the parity configuration
   with the fused CE head, Adam's second moment in bf16 with stochastic
   rounding) at full width for 5 steps, with exact launches per step and
   the rounding's cost; then 2 steps of the 5-pass structure
   (``MXNET_CE_SINGLE_PASS=0``) and one `SPMDTrainer.forward`, each with
   its launches; the same configuration in float32 with the trainer's
   default float32 v (the float32 kernels B and C) for 3 steps, its
   `forward` (A), and 2 steps of its 5-pass structure (A, D and C), each
   with its launches, step time and the CE kernels' time by mode; one
   f32 step's gradients of the fused configuration
   through the kernels against their plain versions; and the fused head
   at GPT-2 medium's widths (2 layers, embed 1024, 16 heads, vocab
   50257): one f32 step's gradients at batch 1 against the plain path,
   and 2 bf16 steps at batch 4 with exact launches;
11. hold the dS route's kernels and the grid-streamed bsd route's against
   their plain versions (bf16 as in phase 2), in float32 and bf16, at the
   long-context training shapes ((8, 6, 4096, 128) and (4, 6, 8192,
   128), causal, timed beside SDPA) and at ragged ones with offsets and
   head 64, and check the plain pins (``MXNET_FLASH_IMPL=jnp``,
   ``MXNET_FLASH_BWD=jnp``) and a mistyped ``MXNET_FLASH_BSD_KERNEL``;
12. train `scripts/diag_round5.py`'s long-context configurations (6
   heads of 128, biases, bf16 Adam v) at full width for 5 steps each:
   S=4096 B=8 under ``MXNET_FLASH_LAYOUT=ds`` and S=8192 B=4 under
   ``MXNET_FLASH_BSD_KERNEL=stream``, with exact launches on the route's
   own counters; and one f32 step's gradients of each configuration at
   batch 1 through the kernels against their plain versions;
13. the reference training API on `BASELINE.json`'s first configuration:
   `tools/make_mnist.py` writes 20000 training and 4000 test images, and
   `model.FeedForward(models.get_mlp())` trains on `io.MNISTIter` (batch
   128, SGD lr 0.1 momentum 0.9, `Xavier`) for 2 epochs on the card, with
   ms a batch, images/s, the train and validation accuracy and peak
   memory; the same on the CPU, whose parameters after 10 batches and
   after the first epoch must match the card's to 1e-4 of max|w| and
   whose validation accuracy after the first epoch must be within 0.01;
   the same CPU run on 1, 2 and 4 threads measures how far rounding
   alone moves the end of training, and the card's final train and
   validation accuracy must lie within the larger of 0.01 and twice that
   spread of the CPU run's (`MNIST_SPREAD_MULT`); the card's checkpoint
   must load on the CPU, save the same bytes again and score the same;
14. the parity configuration in float32 at batch 8 through
   `Symbol.simple_bind` (``grad_req='write'``) and Adam through
   `optimizer.get_fused_updater`: step 1's gradients against
   `SPMDTrainer(dtype='float32')` on the same parameters and batch
   (1e-4), 6 steps each with exactly 25/25 LayerNorm and 12/12/12 float32
   flash launches, the loss finite and falling, ms a step and tokens/s
   beside the trainer's own steps at the same batch, and peak memory;
15. ResNet-50 at `bench.py`'s headline geometry (224 pixels, 1000
   classes, 'valid' pooling, bf16, batch 128, SGD lr 0.1 momentum 0.9 wd
   1e-4) through `SPMDTrainer` on one synthetic batch staged on the card:
   10 steps, ms a step by CUDA events (median of steps 2 on), images/s
   and MFU (`bench.py`'s 3 x 2 x 4.089e9 flops an image over 989
   TFLOP/s), one profiled step (idle share, device ms of convolutions and
   products against the rest, top ops), peak memory; the mean NLL must
   fall below the first step's by the last, every aux state be finite
   and have moved from 0 and 1, and no kernel of the table launch; then
   a float32 convolution (ResNet-50's stem, a bottleneck's 3x3 and 1x1,
   FCN-8s's 16x upscore), forward and backward through the op with
   ``cudnn.allow_tf32 = True``, within 1e-5 of float64 on the card, where
   the raw cuDNN call under that flag must miss the bar;
16. ResNet-50 in the reference's 'full' geometry at batch 4 in float32,
   ``cudnn.allow_tf32 = True`` around it: `SPMDTrainer.forward` and
   `gradients` on the card against the same on the CPU from the card's
   initial parameters (forward 1e-4 of the largest output, moving
   statistics 1e-5, gradients 1e-4 of each parameter's largest or twice
   the spread of the same CPU run on 1, 2 and 4 threads against all,
   where larger: this BatchNorm network amplifies rounding through its
   backward, `CONV_SPREAD_MULT`);
17. ResNet-50 through `model.FeedForward` as `examples/train_imagenet.py
   --trainer feedforward` runs it ('full' pooling, SGD lr 0.1,
   `Xavier(gaussian, 2)`, kvstore 'device', float32) on an `NDArrayIter`
   of 8 synthetic batches of 64 (cut from 256): ms a batch, images/s,
   the running cross-entropy finite;
18. the other `BASELINE.json` configurations, 2 steps each through
   `SPMDTrainer` (ms a step, the mean NLL finite, no kernel of the table
   launched) and the check of phase 16 at a small size: Inception-BN at
   224 (bf16, batch 32; checked at batch 2), the LSTM LM at
   `examples/lstm_bucketing.py`'s defaults (2 layers, hidden and embed
   64, vocab 64, batch 32, bucket 32, Adam; checked at batch 4) and
   FCN-8s at `examples/fcn_xs.py`'s (21 classes, 64x64, batch 4, SGD,
   bilinear upscore kernels; checked at batch 1 with its Dropouts at
   p = 0);
19. the Module API: (a) the parity configuration in float32 at batch 8
   through `mx.mod.Module.fit` (Adam lr 1e-3, kvstore 'local', an
   `NDArrayIter` of 6 seeded batches, ``MXNET_DEVICE_PREFETCH=2``,
   ``MXNET_METRIC_INTERVAL=3``): its parameters bit for bit those of
   phase 14's `simple_bind` loop on the same batches from the same
   parameters, exactly 25/25 LayerNorm and 12/12/12 float32 flash
   launches a step, 2 blocking metric fetches and 6 staged batches; the
   same under ``MXNET_DEVICE_PREFETCH=0`` (bit for bit again), with ms a
   step and one profiled step of each; (b) the fused configuration in
   bf16 at batch 32 through `mx.mod.SPMDModule.fit` (Adam, 5 batches):
   bit for bit `SPMDTrainer.step` on the same batches, rows 1-4 and
   13-14 launched as in phase 10; (c) (a)'s fit interrupted after batch
   4 with ``auto_checkpoint``, ``checkpoint_every=3``, finished by a
   fresh module with ``resume="auto"``: parameters and Adam states bit
   for bit the straight fit's, the checkpoint's bytes and write ms;
   (d) `examples/lstm_bucketing.py`'s defaults (buckets 8/16/24/32, 2
   layers, hidden and embed 64, batch 32, Adam lr 0.01) through
   `mx.mod.BucketingModule` for one epoch of its synthetic sentences:
   every bucket on the default bucket's parameter tensors, the
   parameters within 1e-4 of max|w| of the same fit on the CPU;
20. fault tolerance, on phase 19 (a)'s fit: (a) ``MXNET_NONFINITE_GUARD=1``
   with ``MXNET_CHAOS=nan_grad:3:inf``: the parameters after batch 3 bit
   for bit those after batch 2, the final parameters and Adam states bit
   for bit a guarded fit over the same batches without batch 3, exactly
   25/25 LayerNorm and 12/12/12 float32 flash launches every step (the
   skipped one too), every `update_multi` under
   ``torch.cuda.set_sync_debug_mode("error")``, 2 blocking fetches; (b)
   the same with ``MXNET_NONFINITE_BACKOFF=0.5``: lr 5e-4 at the end, one
   ``lr_backoff`` event, ``train.nonfinite_steps`` 1, 8 blocking fetches
   (the JAX package's count for this fit on the CPU,
   `tests/test_torch_nonfinite.py`); (c) ms a step with the guard on and
   off over the 6 clean batches (off, on, on, off) and the relative
   drift of the parameters between the two; (d) an `Embedding` at
   ``input_dim`` 8 with indices [[0, 3, 7, 9], [-1, 2, 8, 1]] on the card
   (NaN rows for 9 and 8, row 7 for -1), then a LayerNorm and a flash
   check against their plain versions, and a GPT-2-small paged engine
   serving a prompt with a token past the vocabulary and then two normal
   prompts, whose tokens must equal a fresh engine's; (e) storage: the
   card's memory counters, a freed pool buffer handed back by the next
   alloc of its size, the ``storage`` collector in a step report;
21. image records: (a) build the port's native library with g++ (its
   seconds, and whether libjpeg was found) and write a RecordIO pack of
   512 uint8 3x256x256 .npy records from ``RandomState(3)`` (labels in
   [0, 1000)) into a temporary directory, with 64 JPEG records beside it
   where the machine has libjpeg; (b) one epoch of `io.ImageRecordIter`
   without augmentation on the native loader (4 threads) and on the
   Python path, on the host: the same batches, labels and pads bit for
   bit, two shards covering the pack once each, images/s of each; (c) one
   augmented batch of 64 at 3x224x224 on the card against the same on the
   CPU from the same seed: random crop, mirror and scale bit for bit, and
   with the affine warp and the HSL jitter within 1e-4 of max|ref|
   (elements differing counted); (d) ResNet-50 through `model.FeedForward`
   as in phase 17 but fed from the pack by `ImageRecordIter` (random crop
   and mirror on the card, 8 batches of 64): ms a batch and images/s
   beside phase 17's, the device prefetcher's waits and input-wait
   share, the running cross-entropy finite, every batch's data on
   ``cuda:0`` before the loop staged it, no decode failure and no kernel
   of the table launched; (e) the threaded, naive and native host
   engines on the JAX package's random workload (`tests/test_engine.py`,
   20 vars, seeds 0-2) against serial execution, with ops/s;
22. head 256 and the rematerialization pins: (a) the four flash kernels
   at head 256, forward and backward, both dtypes, on every route at
   (4, 8, 2048, 2048, causal), timed beside SDPA with ptxas's numbers
   (phase 2 holds 160, 192 and 256 on every route, causal and not, with a
   key length of 333); (b) the LM at Gemma-2B's attention widths (embed
   2048, 8 heads of 256, ffn 16384, no biases; 2 of its 18 layers, vocab
   32768) at S 2048, batch 4, bf16, 3 steps in each layout with exact
   launches (5/5 LayerNorm, 2/2/2 flash on the layout's route, no padded
   call), ms a step, tokens/s, MFU, idle share and peak memory, and one
   f32 step's gradients at batch 1 against the plain path; (c) slot-cache
   serving of a 2-layer model at those widths in float32, 4 requests,
   each one's teacher-forced logits within 1e-3 of the plain path; (d)
   the parity configuration (bf16, batch 32) through `SPMDTrainer` under
   ``MXNET_BACKWARD_MIRROR_POLICY`` none, dots, attn, streams and nothing
   and ``MXNET_BACKWARD_MIRROR_STEP=block``: gradients bit for bit the
   plain step's, the flash forward's launches a step as predicted (12
   where its out and lse are kept, 24 where they are recomputed), peak
   memory (lower than none's under attn and nothing), the median ms of 6
   steps and one profiled step (device busy ms by kind of kernel beside
   none's, the idle share); then `examples/memcost.py`'s deep net at its
   defaults through `simple_bind` plain, with ``MXNET_BACKWARD_DO_MIRROR=1``
   and with ``MXNET_BACKWARD_MIRROR_POLICY=nothing``: the same gradients
   bit for bit, the three peaks (lower than plain's under both) and ms a
   step; and one differentiable flash call, forward and backward, through
   the custom op beside a plain `torch.autograd.Function` over the same
   work: the host's microseconds to issue it, and ms with the device's;
23. wide heads and serving faults: (a) the wide flash kernels (head_dim
   above 256, `csrc/flash_attention_wide.cu` and
   `csrc/flash_attention_wide_f32.cu`) against their plain versions at
   384 and 512 on every route and at 320 (padded to 384) and 1024, both
   dtypes, causal with both offsets and not, each twice bit for bit, then
   (2, 8, 1024, 1024, 512) causal timed in both dtypes beside SDPA (its
   backend named) with the bound of the function and that of the work the
   kernels do (the score products once per column block of 128) and
   ptxas's numbers; the LM of phase 22 with 4 heads of 512 for 3 bf16
   steps with exact launches (every flash launch a wide one) and one f32
   step's gradients against the plain path; (b) GPT-2 small in f32,
   paged and slot, 16 requests each: one prefill quarantined
   (`ServeQuarantined`, the other 15 the fault-free engine's tokens under
   the 1e-3 margin rule), a decode that writes the cache and raises (the
   8 admitted requests `ServeCacheInvalidated`, one cache rebuild, the 8
   queued served, no block leaked), and, paged, a ``CUDA error:`` that
   kills the engine and ``MXNET_CHAOS=launch_error:0.2`` (with
   ``MXNET_SERVE_LAUNCH_RETRIES=8``) ending with the scheduler alive,
   telemetry's ``serve.*`` counters the record; (c) two GPT-2 replicas
   (replica0 on the slot cache, replica1 paged) under `ReplicaRouter`,
   16 requests fault-free and then under
   ``MXNET_CHAOS=engine_crash:6:replica0``: every request resolves, the
   migrated ones with the fault-free tokens, one failover, a respawn,
   the tail served, then a drain of replica0 under load with no failure;
   tokens/s of both runs, and exact LayerNorm and flash launches (2L + 1
   LayerNorm per program, L flash per slot prefill, warmups included);
24. speculative and megastep serving: GPT-2 small in f32 on the paged
   engine, phase 3's 16 prompts (32-768 tokens, 32 new, four of them
   sampled at T=0.8 and top_k 40) served plain, with speculation (the
   n-gram drafter at k=4; the model drafter self-drafting at k=4, twice,
   bit for bit; and under ``MXNET_CHAOS=draft_junk:0.5``), with megastep
   m=4 and m=8, and with speculation and megastep m=4 together: each
   mode's tokens equal plain's request by request under the 1e-3 margin
   rule, self-drafting accepts at least 0.9 of its proposals, no block
   leaks after `drain`, and the LayerNorm launches are exactly 2L + 1 per
   prefill chunk, decode step, verify, megastep step, draft step and
   draft prefill chunk; tokens/s, TTFT median and p99, LayerNorm launches
   per generated token, accept rates and peak memory of each; one
   profiled decode step of a full batch of 8 against one megastep (m=4):
   wall, device busy and idle share; then `stream()` and ``on_token`` on
   4 requests of a megastep engine on its own thread, and two megastep
   replicas under `ReplicaRouter` with ``engine_crash:3:replica0`` and
   every request streamed: each stream equal to its ``on_token`` calls
   and to ``result()``, no token delivered twice across the failover,
   the tokens plain's under the margin rule, exact launches (the dead
   replica's megastep in flight at the crash included);
25. the host tier, sessions and quantization: GPT-2 small in f32 on the
   paged engine (block size 16), phase 4b's shared-prefix requests in
   rounds (the first alone, 7 together, 4 unrelated 992-token prompts
   one by one that evict what they parked, then the 9th alone and the
   last 7 together) through a 193-block pool with the host tier, the
   same pool without it, a 1024-block pool that never evicts, and the
   tier under ``MXNET_CHAOS=spill_fail:0.5``: the tier's tokens equal the
   roomy pool's bit for bit, the prompt's 32 blocks are on the host after
   the fillers and, restored, hold the bytes they held, fewer prefill
   tokens than without the tier, the other runs' tokens under the 1e-3
   margin rule, no block leaked on the card or the host; one restore
   copy (32 blocks from pinned memory) timed alone and staged before a
   decode step of 8 rows (the share of it under the decode); 4 sessions
   x 3 turns, on
   the card and through the tier, each turn's tokens those of an engine
   without a prefix cache given the whole history (margin rule), each
   follow-up prefilling at most its new tokens and the history's partial
   blocks; phase 3's 16 prompts in f32 and with weights int8 and K/V
   int8, weights int8, weights fp8 and K/V int8 alone: each quantized
   mode's kernel path teacher-forced against its own plain-LayerNorm path
   within 1e-3 (greedy tokens its argmax within 1e-3), `parity_report`
   against the f32 model, the int8 modes within the JAX gate (relative
   logit error <= 0.05, token match >= 0.75) and fp8's reported beside
   it, ``allow_tf32`` off; int8 blocks at the
   f32 pool's bytes; then ``MXNET_CHAOS=scale_corrupt:0.3`` on weights
   and K/V int8: only `ServeQuantError` failures, the survivors the clean
   tokens (margin rule), the engine alive; every run's LayerNorm launches
   exactly 2L + 1 per prefill chunk and decode step (a restore launches
   none); tokens/s, TTFT median and p99 and peak memory of each run;
26. MoE, the disaggregated fleet and the gateway: (a) GPT-2 small's
   widths with Switch-Base-8's 8 experts, top-1 in every layer (0.56 G
   parameters, f32, drawn on the card from seed 0), phase 3's 16 prompts
   on the paged engine, with megastep m=4, with the n-gram drafter at k=4
   and on the slot engine: each mode's tokens the paged run's under the
   1e-3 margin rule, the kernel path teacher-forced within 1e-3 of the
   plain-LayerNorm path, `expert_load()` summing to L x the rows its
   launches routed and equal to its gauges, exactly 2L + 1 LayerNorm a
   program and L flash a slot prefill, no block leaked, and a MoE
   megastep, its count's copy and the scheduler's drain under
   ``set_sync_debug_mode("error")``; tokens/s, TTFT and peak memory
   beside dense GPT-2 small on the same prompts; (b) two GPT-2 small
   replicas on the card, colocated and then prefill + decode: the same
   tokens (margin rule), 16 handoffs, no prefill chunk on the decode
   replica, the first two landings read back from the pool byte for
   byte against their tickets' packed runs; under
   ``MXNET_CHAOS=handoff_fail:0.5`` every request the fault-free tokens
   by exact replay; a decode replica added (sharing the parameters) and
   removed under load with none failed; handoffs, bytes, the handoff
   wait's p50 and p99 and tokens/s against colocated; (c) the gateway on
   127.0.0.1, port 0, over (b)'s fleet: 4 SSE streams equal to their
   requests' ``result()``, a client that hangs up after one token has
   its request cancelled and no block leaked; TTFB p50 beside the
   engine's TTFT;
27. sub-mesh replicas and request tracing: (a) GPT-2 small in f32 at
   V 50257 unsharded and as 2 shards on ``[cuda:0, cuda:0]`` (heads and
   FFN split, the odd vocabulary replicated), paged, slot and with int8
   weights and K/V, and at nanoGPT's padded V 50304 unsharded and as 4
   shards (embedding and head split by vocabulary too), paged and slot,
   phase 3's 16 requests each: tokens the unsharded engine's under the
   1e-3 margin rule, the paged shards' kernel path teacher-forced within
   1e-3 of the unsharded plain-LayerNorm path, exactly 2L + 1 LayerNorm a
   program and L flash a slot prefill per shard's heads, per-device bytes
   below the unsharded engine's with the total conserved, no block
   leaked; (b) phase 26's MoE model unsharded and as 4 shards (2 experts
   each): tokens under the margin rule and, where all agree, the expert
   load equal; (c) `ReplicaRouter.from_mesh(devices_per_replica=2,
   n_replicas=2)` over four entries of the card under
   ``engine_crash:3:replica0``: every request the fault-free tokens
   (margin rule), a flight-recorder dump of the dead replica, the
   respawn at its width; (d) tracing on, off, on, off over phase 3's
   requests: the same tokens, launches and host syncs, and the host
   time of every tracing call; a prefill and a decode replica unsharded
   and as 2-shard replicas, every trace across both, the handoff bytes
   equal; the gateway over the sharded pair with its ``gateway_send``
   spans; one traced megastep iteration (``ServingEngine.step``) under
   ``set_sync_debug_mode("error")``, its ``host_sweep`` and ``megastep``
   spans the engine's; the records written to
   ``chiprun_out/trace_phase27.jsonl`` and rendered by
   ``tools/trace_report.py``; tokens/s, TTFT, memory footprint and peak
   memory of every run.

It prints each phase's seconds, a ``kernels`` JSON line (launches,
errors, times, bounds; the float32 flash forward's and backward's routes
and float32 fused CE functions as entries of their own, launched on the
float32 paths; a kernel launched on no path fails the run), the card's
name and power limit, and as its last line ``{"ok": true, "device":
{"platform": "gpu", ...}}``.  It writes the full
results to ``chiprun_out/chip_smoke.json``.  It exits non-zero without a
result when no CUDA device is present or the package is missing.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import gc
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import attention as attention_mod
from mxnet_tpu_torch.ops import loss as loss_mod
from mxnet_tpu_torch.ops.pallas_kernels import _build
from mxnet_tpu_torch.ops.pallas_kernels import flash_attention as fam
from mxnet_tpu_torch.ops.pallas_kernels import fused_ce as fce
from mxnet_tpu_torch.ops.pallas_kernels import layer_norm as lnm
from mxnet_tpu_torch.ops.pallas_kernels.flash_attention import (
    _delta, _flash_bwd_cuda, _flash_bwd_plain, _flash_fwd_cuda,
    _flash_fwd_plain, _to_ds, flash_attention, flash_attention_bsd,
    flash_attention_bsd_plain, flash_attention_plain)
from mxnet_tpu_torch.ops.pallas_kernels.layer_norm import (
    _bwd_plain as layer_norm_bwd_plain, _fwd_plain as layer_norm_fwd_plain,
    layer_norm_bwd, layer_norm_fwd, layer_norm_plain)
from mxnet_tpu_torch.serving import (ReplicaRouter, ServingEngine,
                                     TransformerKVModel, pool_bytes)
from mxnet_tpu_torch.parallel.mesh import make_mesh, submeshes
from mxnet_tpu_torch.serving import decode as decode_mod

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 on the
# CUDA cores, bf16 on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# TF32 on the tensor cores: the float32 flash forward's and backward's
# and the fused CE head's products run there in 3xTF32, three TF32
# products for each float32 one, so their least time is 3x their
# operations at this rate
PEAK_TF32 = 495e12

# GPT-2 small's published widths (vocab 50257, context 1024, 12 layers,
# 12 heads, embed 768, ffn 3072, biases on)
GPT2 = dict(vocab_size=50257, seq_len=1024, num_layers=12, num_heads=12,
            num_embed=768, num_ffn_hidden=3072, use_bias=True)

# Tolerances of the kernel checks, as (rtol, atol) on |kernel - plain|:
# * float32: kernel and plain version do the same float32 arithmetic and
#   differ only in the order of their sums (block tree vs torch reduction,
#   32-key vs 256-key softmax blocks) and in rsqrtf's last bit, a few ulp
#   (~1e-7 relative), and the flash forward's products run in 3xTF32
#   (~2**-22 of each, ~1e-6 of the output); 1e-5 still catches any wrong
#   formula, mask or offset;
# * bfloat16 LayerNorm: both round the same float32 result to bf16, so an
#   element may land one bf16 ulp apart, at most 2**-7 of its value;
# * bfloat16 flash attention: ``REL_TOL`` below.
# The bf16 flash forward and backward (phases 2 and 11) are held to
# ``REL_TOL`` (7e-3 of max|ref|) against the plain versions run in
# float32 on float32 copies of the same bf16 operands and residuals: the
# tensor-core kernels round p (and ds) to bf16 as the mma's operand where
# the plain version does not, and the plain version's own bf16 output
# rounding (~2.8e-3 of max|ref|) would take most of the bar; the bf16
# plain comparison is printed beside it.  lse is float32 in both and held
# at the float32 tolerance.
TOL = {("layer_norm", torch.float32): (1e-5, 1e-5),
       ("layer_norm", torch.bfloat16): (2 ** -7, 1e-5),
       ("flash_attention", torch.float32): (1e-5, 1e-5)}

# Logit check of the served requests (phase 3): the engine's kernel path
# in float32 against the plain versions in float32.  The two differ only
# in summation order (LayerNorm reductions, GEMM blocking for one row vs
# many, chunked vs blockwise softmax), ~1e-6 relative per op, which 12
# layers keep far below 1e-3 on logits of magnitude ~1; bfloat16 keeps 8
# mantissa bits, so the same path in bf16 moves the logits by ~1e-2 and
# fails it (printed beside it).
LOGIT_TOL = 1e-3

# Tolerances of the training-shape checks (phase 2), as a bound on
# max |kernel - plain| over max |plain|, per output:
# * float32: the same float32 arithmetic summed in another order (over up
#   to 1024 keys or 32768 rows), ~1e-6 of the largest value; the float32
#   flash and fused CE products run in 3xTF32 (each operand split into two
#   TF32 terms; the dropped lo * lo term and lo's rounding cost ~2**-22 of
#   each product), which keeps it near that; 1e-4 leaves 100x headroom;
# * bfloat16: the 7e-3 bar the JAX package's Pallas kernels held against
#   their jnp twins (BENCH_r05.json pallas_parity, flash_bwd_bsd_full_dq
#   0.007143).
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 7e-3}

# Gradient check (phase 7): one step's float32 gradients through the
# kernels against the plain versions, max |dg| / max |g| per parameter.
# The two differ in summation order (LayerNorm reductions, attention
# blocks, and the embedding's scatter-add, whose atomics add in another
# order on every run) and in the flash kernels' 3xTF32 products (~2**-22
# of each): ~1e-6.  The key-projection biases' true gradient is
# exactly zero (q.b_k is the same for every key of a query, and the
# softmax cancels it), so theirs is rounding noise in both paths; they are
# held to the same bound against the largest gradient of the model
# instead of their own.  The bf16 kernel path's error (8 mantissa bits) is
# printed beside the bound and must exceed it.
GRAD_TOL = 1e-4

# H100 dense bf16 tensor-core peak (NVIDIA data sheet), the MFU yardstick
MFU_PEAK = PEAK_FLOPS[torch.bfloat16]

# The kernels line: one entry per TPU function ported, with the counters
# whose launches it reports (the first is its ``launches``).  The line
# reports bf16, so the flash and fused CE rows name the bf16 tensor-core
# sources; their float32 launches run the sources of `F32_SOURCE` (the
# float32 flash forward and backward and fused CE head, on the tensor
# cores in 3xTF32), which have entries of their own (`F32_ROWS`).
TPU = "mxnet_tpu/ops/pallas_kernels/"
KERNEL_ROWS = [
    ("layer_norm", "layer_norm.cu", TPU + "layer_norm.py:93",
     ["layer_norm"]),
    ("layer_norm_bwd", "layer_norm.cu", TPU + "layer_norm.py:119",
     ["layer_norm_bwd"]),
    ("flash_attention", "flash_attention_fwd.cu",
     TPU + "flash_attention.py:155",
     ["flash_attention"]),
    ("flash_attention_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:372",
     ["flash_attention_dq", "flash_attention_dkv"]),
    ("flash_attention_bsd", "flash_attention_fwd.cu",
     TPU + "flash_attention.py:988", ["flash_attention_bsd"]),
    ("flash_attention_bsd_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:1158",
     ["flash_attention_bsd_dq", "flash_attention_bsd_dkv"]),
    # the dS layout: the kernels' S-contiguous orientation
    ("flash_attention_ds", "flash_attention_fwd.cu",
     TPU + "flash_attention.py:623", ["flash_attention_ds"]),
    ("flash_attention_ds_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:794",
     ["flash_attention_ds_dq", "flash_attention_ds_dkv"]),
    # the grid-streamed bsd structure: rows 7 and 8's kernels on their
    # own counters
    ("flash_attention_bsd_stream", "flash_attention_fwd.cu",
     TPU + "flash_attention.py:1342", ["flash_attention_bsd_stream"]),
    ("flash_attention_bsd_stream_bwd", "flash_attention_bwd.cu",
     TPU + "flash_attention.py:1510",
     ["flash_attention_bsd_stream_dq", "flash_attention_bsd_stream_dkv"]),
    # the 5-pass backward (row 12) is kernels D and C; its launches are
    # D's, on the 5-pass run
    ("fused_ce_fwd", "fused_ce_bf16.cu", TPU + "fused_ce.py:155",
     ["fused_ce_fwd"]),
    ("fused_ce_bwd", "fused_ce_bf16.cu", TPU + "fused_ce.py:289",
     ["fused_ce_bwd_dx", "fused_ce_bwd_dw"]),
    ("fused_ce_fwd_sp", "fused_ce_bf16.cu", TPU + "fused_ce.py:520",
     ["fused_ce_fwd_sp"]),
    ("fused_ce_bwd_dw_rs", "fused_ce_bf16.cu", TPU + "fused_ce.py:700",
     ["fused_ce_bwd_dw"]),
    ("fused_ce_bwd_dx_rs", "fused_ce_bf16.cu", TPU + "fused_ce.py:744",
     ["fused_ce_bwd_dx"]),
]
F32_SOURCE = {"layer_norm.cu": "layer_norm.cu",
              "flash_attention_fwd.cu": "flash_attention_fwd_f32.cu",
              "flash_attention_bwd.cu": "flash_attention_bwd_f32.cu",
              "fused_ce_bf16.cu": "fused_ce_f32.cu"}
# every launch counter, by name: (wrapper, attribute)
COUNTERS = {
    "layer_norm": (layer_norm_fwd, "launches"),
    "layer_norm_bwd": (layer_norm_bwd, "launches"),
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_dq": (flash_attention, "dq_launches"),
    "flash_attention_dkv": (flash_attention, "dkv_launches"),
    "flash_attention_bsd": (flash_attention_bsd, "launches"),
    "flash_attention_bsd_dq": (flash_attention_bsd, "dq_launches"),
    "flash_attention_bsd_dkv": (flash_attention_bsd, "dkv_launches"),
    "flash_attention_ds": (flash_attention, "ds_launches"),
    "flash_attention_ds_dq": (flash_attention, "ds_dq_launches"),
    "flash_attention_ds_dkv": (flash_attention, "ds_dkv_launches"),
    "flash_attention_bsd_stream": (flash_attention_bsd, "stream_launches"),
    "flash_attention_bsd_stream_dq": (flash_attention_bsd,
                                      "stream_dq_launches"),
    "flash_attention_bsd_stream_dkv": (flash_attention_bsd,
                                       "stream_dkv_launches"),
    "fused_ce_fwd": (fce.fused_ce_fwd, "launches"),
    "fused_ce_fwd_sp": (fce.fused_ce_fwd_sp, "launches"),
    "fused_ce_bwd_dw": (fce.fused_ce_bwd_dw, "launches"),
    "fused_ce_bwd_dx": (fce.fused_ce_bwd_dx, "launches"),
}
# each flash route's calls whose head width was zero-padded to the
# kernels' or sent to the plain versions (below 32)
for _name, _fn, _prefix in (
        ("flash_attention", flash_attention, ""),
        ("flash_attention_ds", flash_attention, "ds_"),
        ("flash_attention_bsd", flash_attention_bsd, ""),
        ("flash_attention_bsd_stream", flash_attention_bsd, "stream_")):
    COUNTERS[_name + "_padded"] = (_fn, _prefix + "padded_calls")
    COUNTERS[_name + "_narrow"] = (_fn, _prefix + "narrow_calls")
    # the launches of the wide kernels (head_dim above 256), counted again
    for _kind, _attr in (("_wide", "wide_launches"),
                         ("_wide_dq", "wide_dq_launches"),
                         ("_wide_dkv", "wide_dkv_launches")):
        COUNTERS[_name + _kind] = (_fn, _prefix + _attr)
# the bf16 fused CE calls whose d was zero-padded to a multiple of 8
for _name in ("fused_ce_fwd", "fused_ce_fwd_sp", "fused_ce_bwd_dw",
              "fused_ce_bwd_dx"):
    COUNTERS[_name + "_padded"] = (COUNTERS[_name][0], "padded_calls")
del _name, _fn, _prefix, _kind, _attr


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def pinned(**env):
    """Set the ``MXNET_*`` pins in ``env`` for the block and restore each
    as it was after it, as `scripts/diag_round5.py` does around a
    configuration."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


# each flash layout of the training checks: its route's pins, its name in
# the checks and the kernels line, and the route its kernels count on
FLASH_LAYOUTS = {
    "bhsd": ({}, "flash_attention", "hsd"),
    "bsd": ({}, "flash_attention_bsd", "bsd_loop"),
    "ds": ({"MXNET_FLASH_LAYOUT": "ds"}, "flash_attention_ds", "ds"),
    "stream": ({"MXNET_FLASH_BSD_KERNEL": "stream"},
               "flash_attention_bsd_stream", "bsd_stream"),
}


def card_state():
    """The card's SM and memory clocks, power draw and temperature now, as
    nvidia-smi reads them: sampled right after each timed window."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()


@functools.cache
def spin_cycles_per_ms():
    """Clock cycles `torch.cuda._sleep` spins per millisecond, measured
    once with CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def time_ms(fn, reps=25, per=10, warm=3):
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    samples, each ``per`` back-to-back calls between two CUDA events,
    divided by ``per``.  A spin kernel runs before each sample for twice
    as long as the host takes to enqueue the sample's calls, so the events
    bracket device work alone, not the host's launch latency.  Inputs stay
    warm in L2, as on the serving path, where each call reads what the op
    before it wrote."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(max(0.5, 2 * host_ms) * spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def time_with_launch_ms(fn, reps=25, warm=3):
    """Median time of one call of ``fn`` from an idle card, host launch
    included: what an eager caller waits for a tiny kernel."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes, flops, dtype, peak=None):
    """The least time for ``nbytes`` of memory traffic and ``flops``
    operations at ``peak`` (the dtype's `PEAK_FLOPS` unless given), and
    which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_auto(fn, budget_ms=600.0):
    """`time_ms` with its sample count fitted to the call's length: 10
    calls a sample below half a millisecond, else one, and as many
    samples (3 to 25) as fit ``budget_ms``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = 1e3 * (time.perf_counter() - t0)
    per = 10 if one < 0.5 else 1
    reps = int(min(25, max(3, budget_ms / (one * per))))
    return time_ms(fn, reps=reps, per=per, warm=1)


def ptxas_info(name):
    """ptxas's registers and spill bytes per kernel of source ``name``, from
    its build log: {mangled kernel name: {"registers": n, "spill_bytes":
    (stores, loads)}}."""
    out, kernel = {}, None
    for ln in _build.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
            out[kernel] = {}
        elif "spill stores" in ln and kernel is not None:
            words = ln.split()
            out[kernel]["spill_bytes"] = (
                int(words[words.index("spill") - 2]),
                int(words[words.index("loads") - 3]))
        elif "Used" in ln and "registers" in ln and kernel is not None:
            out[kernel]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


# the wide kernels' source (head_dim above 256) of each flash source
WIDE_SOURCE = {"flash_attention_fwd": "flash_attention_wide",
               "flash_attention_bwd": "flash_attention_wide",
               "flash_attention_fwd_f32": "flash_attention_wide_f32",
               "flash_attention_bwd_f32": "flash_attention_wide_f32"}


def mma_ptxas(source, d, layout):
    """ptxas's registers and spill bytes of the tensor-core flash kernels of
    ``source`` at head_dim ``d`` in ``layout`` (0 or 1), by kernel: 'fwd',
    or the backward's 'bwd_dq' and 'bwd_dkv' (bf16 `wgmma`, or the float32
    ones in 3xTF32); above 256 the wide kernels of `WIDE_SOURCE`."""
    if d > 256:
        kinds = ("fwd",) if "fwd" in source else ("bwd_dq", "bwd_dkv")
        out = {}
        for k, v in ptxas_info(WIDE_SOURCE[source]).items():
            m = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_wide_(tf32_)?kernel"
                          r"ILb%dE" % layout, k)
            if m and m.group(1) in kinds:
                out[m.group(1)] = v
        return out
    # the templates at (d, layout), and the float32 forward's head-256
    # kernel, a template of the layout alone
    tags = ["ILi%dELb%dE" % (d, layout)]
    if d == 256:
        tags.append("_wide_kernelILb%dE" % layout)
    out = {}
    for k, v in ptxas_info(source).items():
        m = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_(mma|tf32)(_wide)?_kernel",
                      k)
        if m and any(tag in k for tag in tags):
            out[m.group(1)] = v
    return out


def ce_ptxas(dtype, mode, d):
    """ptxas's registers and spill bytes of the fused CE kernel that runs
    ``mode`` (0 A, 1 B, 2 C, 3 D) at width ``d``: the tensor-core template
    at the cluster size and warpgroup width that `launch_d` picks, in
    `csrc/fused_ce_bf16.cu` (chunks of 64 columns a warpgroup) or
    `csrc/fused_ce_f32.cu` (64 or 96 columns a warpgroup)."""
    if dtype == torch.bfloat16:
        chunks = -(-(d + d % 8) // 64)
        cl = next((c for c in (1, 2, 4, 8) if 6 * c >= chunks), 8)
        tag = "fused_ce_mma_kernelILi%dELi%dELi%dELb%dE" % (
            mode, cl, min(3, -(-chunks // (2 * cl))), chunks > 48)
        source = "fused_ce_bf16"
    else:
        cl = next((c for c in (1, 2, 4, 8) if 192 * c >= d), 8)
        tag = "fused_ce_tf32_kernelILi%dELi%dELi%dELb%dE" % (
            mode, cl, 64 if 128 * cl >= d else 96, d > 1536)
        source = "fused_ce_f32"
    return next(v for k, v in ptxas_info(source).items() if tag in k)


def check(name, dtype, got, ref):
    rtol, atol = TOL[(name, dtype)]
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return float(err.max()), ok, (rtol, atol)


def rel_check(dtype, pairs):
    """(max abs error, its share of the largest reference value, ok) over
    the (got, ref) pairs, each held to ``REL_TOL[dtype]`` of its own
    reference's largest magnitude."""
    err, rel, ok = 0.0, 0.0, True
    for got, ref in pairs:
        got, ref = got.detach(), ref.detach()
        e = float((got.float() - ref.float()).abs().max())
        r = e / max(float(ref.float().abs().max()), 1e-30)
        err, rel, ok = max(err, e), max(rel, r), ok and r <= REL_TOL[dtype]
    return err, rel, ok


# -- phase 2: kernel checks ------------------------------------------------


def layer_norm_case(rows, dtype, gen, n=768):
    x = torch.randn(rows, n, device="cuda", generator=gen).to(dtype)
    gamma = (1 + 0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    beta = (0.1 * torch.randn(n, device="cuda", generator=gen)).to(dtype)
    y, mean, rstd = layer_norm_fwd(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    ry, rmean, rrstd = layer_norm_fwd_plain(x, gamma, beta, 1e-5)
    err, ok, tol = check("layer_norm", dtype, y, ry)
    # the statistics are float32 in both: held at the float32 tolerance
    for got, ref in ((mean, rmean), (rstd, rrstd)):
        e2, ok2, _ = check("layer_norm", torch.float32, got, ref)
        err, ok = max(err, e2), ok and ok2
    isz = x.element_size()
    nbytes = 2 * rows * n * isz + 2 * n * isz + 2 * rows * 4
    bnd, by = bound_ms(nbytes, 8 * rows * n, dtype)
    return {
        "kernel": "layer_norm", "shape": [rows, n], "dtype": str(dtype),
        "max_abs_err": err, "ok": ok, "rtol": tol[0], "atol": tol[1],
        "ms": time_ms(lambda: layer_norm_fwd(x, gamma, beta, 1e-5)),
        "ms_with_launch": time_with_launch_ms(
            lambda: layer_norm_fwd(x, gamma, beta, 1e-5)),
        "plain_ms": time_ms(lambda: layer_norm_fwd_plain(x, gamma, beta,
                                                         1e-5)),
        "library_ms": time_ms(lambda: F.layer_norm(x, (n,), gamma, beta,
                                                   1e-5)),
        "bound_ms": bnd, "bound_by": by}


def visible_pairs(sq, skv, causal, q_off, k_off):
    """(query, key) pairs the mask lets through: the work this input
    needs."""
    if not causal:
        return sq * skv
    qpos = q_off + np.arange(sq)
    return int(np.clip(qpos - k_off + 1, 0, skv).sum())


def flash_case(sq, skv, causal, q_off, k_off, dtype, gen, heads=12, d=64,
               batch=1, strided=False, misaligned=False):
    """One flash check; ``strided`` passes (batch, seq, heads, d) tensors
    transposed to (batch, heads, seq, d) views, as the serving prefill
    does; ``misaligned`` hands over a k whose sequence stride (d + 2) is
    no multiple of 16 bytes, which the float32 wrapper copies.  Every
    kernel must give the same bits twice."""
    def make(s):
        t = torch.randn(batch, s, heads, d, device="cuda", generator=gen)
        t = t.to(dtype).transpose(1, 2)
        return t if strided else t.contiguous()
    q, k, v = make(sq), make(skv), make(skv)
    if misaligned:
        k = torch.zeros(batch, heads, skv, d + 2, device="cuda",
                        dtype=dtype)[..., :d].copy_(k)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    out, lse = flash_attention(q, k, v, with_lse=True, **kw)
    again = flash_attention(q, k, v, with_lse=True, **kw)
    torch.cuda.synchronize()
    rout, rlse = flash_attention_plain(q, k, v, with_lse=True, **kw)
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    if dtype == torch.bfloat16:
        # held against the plain version in float32 on the same operands
        # (see REL_TOL); the bf16 plain one printed beside it
        r32, rlse = flash_attention_plain(q.float(), k.float(), v.float(),
                                          with_lse=True, **kw)
        err, rel, ok = rel_check(dtype, [(out, r32)])
        extra = {"rel_err": rel, "rel_tol": REL_TOL[dtype],
                 "reference": "plain float32 on the bf16 operands",
                 "bf16_plain_rel_err": rel_check(dtype, [(out, rout)])[1]}
    else:
        err, ok, tol = check("flash_attention", dtype, out, rout)
        extra = {"rtol": tol[0], "atol": tol[1]}
    extra["bit_identical"] = same
    ok = ok and same
    e2, ok2, _ = check("flash_attention", torch.float32, lse, rlse)
    err, ok = max(err, e2), ok and ok2
    lk = k.contiguous() if misaligned else k  # SDPA refuses such rows
    if causal and (q_off, k_off) == (0, 0) and sq == skv:
        lib = lambda: F.scaled_dot_product_attention(q, lk, v, is_causal=True)
    elif causal:
        qpos = q_off + torch.arange(sq, device="cuda")[:, None]
        mask = qpos >= k_off + torch.arange(skv, device="cuda")[None, :]
        lib = lambda: F.scaled_dot_product_attention(q, lk, v, attn_mask=mask)
    else:
        lib = lambda: F.scaled_dot_product_attention(q, lk, v)
    isz = q.element_size()
    nbytes = batch * heads * (2 * sq * d + 2 * skv * d) * isz
    flops = 4 * d * batch * heads * visible_pairs(sq, skv, causal, q_off,
                                                  k_off)
    bnd, by = bound_ms(nbytes, flops, dtype)
    if dtype == torch.float32:
        # 3xTF32 on the tensor cores, the CUDA-core bound beside it
        extra["bound_cuda_core_ms"] = bnd
        bnd, by = bound_ms(nbytes, 3 * flops, dtype, PEAK_TF32)
    return {
        "kernel": "flash_attention", "shape": [batch, heads, sq, skv, d],
        "causal": causal, "q_offset": q_off, "k_offset": k_off,
        "strided": strided, "misaligned": misaligned,
        "dtype": str(dtype), "max_abs_err": err, "ok": ok, **extra,
        "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
        "ms_with_launch": time_with_launch_ms(
            lambda: flash_attention(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, **kw)),
        "library_ms": time_ms(lib), "bound_ms": bnd, "bound_by": by}


def kernel_checks():
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (8, 1024, 4096):
            cases.append(layer_norm_case(rows, dtype, gen))
        for s in (64, 1024):
            cases.append(flash_case(s, s, True, 0, 0, dtype, gen))
        cases.append(flash_case(300, 700, False, 400, 100, dtype, gen))
    # a chunk of a long prompt: causal, Sq != Skv, offsets cut the K loop
    cases.append(flash_case(256, 768, True, 512, 0, torch.float32, gen))
    # the kernel's other head width, with ragged tiles
    cases.append(flash_case(200, 200, True, 0, 0, torch.float32, gen, d=128))
    # batch and head strides of transposed views
    cases.append(flash_case(150, 150, True, 0, 0, torch.float32, gen,
                            batch=3, strided=True))
    # a k whose rows the float32 kernel cannot copy 16 bytes at a time: the
    # wrapper's aligned copy, at head 128 with an offset
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(flash_case(200, 260, True, 60, 0, dtype, gen, heads=4,
                                d=128, misaligned=True))
    # row widths off the 256-thread grid, up to the register kernels' widest
    for rows, n in ((64, 1000), (16, 8192)):
        cases.append(layer_norm_case(rows, torch.float32, gen, n=n))
    for c in cases:
        log(describe(c))
    log("card after the kernel checks (sm clock, mem clock, power, temp): "
        "%s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("kernel checks failed: %s" % bad)
    return cases


def _record(kernel, shape, dtype, err, timed, **times):
    """One training-shape check: its error against ``REL_TOL`` and, when
    timed, the kernel, plain, library and bound times."""
    e, rel, ok = err
    rec = {"kernel": kernel, "shape": shape, "dtype": str(dtype),
           "max_abs_err": e, "rel_err": rel, "rel_tol": REL_TOL[dtype],
           "ok": ok}
    if timed:
        rec.update(times)
    return rec


def _library_bwd_ms(fwd, leaves, cot):
    """Time of a library call's backward: its forward and backward through
    autograd, minus its forward."""
    def both():
        torch.autograd.grad(fwd(), leaves, cot)
    with torch.enable_grad():
        return time_auto(both) - time_auto(fwd)


def time_cold_ms(fn, reps=25, scratch_mb=128):
    """Device time of one call of ``fn`` from a cold L2: before each call
    a ``scratch_mb`` MB buffer (over twice the H100's 50 MB L2) is written,
    then a spin kernel covers the host's enqueue of the call, which runs
    alone between two CUDA events; the median over ``reps`` calls."""
    scratch = torch.empty(scratch_mb << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(max(0.2, 2 * host_ms) * spin_cycles_per_ms())
    times = []
    for i in range(reps):
        scratch.fill_(i)
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del scratch
    return statistics.median(times)


def ln_plans(x, gamma, dy):
    """The forward's and backward's launch plans for these operands, as
    the wrappers make them."""
    rows, n = x.shape
    sms = lnm._sm_count(x.device.index)
    align = lnm._alignment(x.data_ptr(), gamma.data_ptr(), dy.data_ptr())
    fwd = lnm._plan_fwd(rows, n, x.dtype, align, sms)
    bwd = lnm._bwd_plan_on(rows, n, x.dtype, align, x.device.index)
    return {"fwd": fwd._asdict(), "bwd": bwd._asdict()}


def ln_ptxas(dtype, plan, kind):
    """ptxas's registers and spill bytes of the LayerNorm kernel that runs
    ``plan`` (a dict of `ln_plans`) for ``kind`` ('fwd' or 'bwd')."""
    t = "f" if dtype == torch.float32 else "13__nv_bfloat16"
    vw = plan["vec_bytes"] // (4 if dtype == torch.float32 else 2)
    tag = ("ln_%s_wide_kernelI%sLi%dEE" % (kind, t, vw)
           if plan["layout"] == "wide" else
           "ln_%s_kernelI%sLi%dELi%dEE" % (kind, t, vw, plan["ept"]))
    return next(v for k, v in ptxas_info("layer_norm").items() if tag in k)


def layer_norm_train_case(rows, dtype, gen, n=768, timed=True, offset=0):
    """LayerNorm forward and backward at (rows, n): kernels against plain
    versions (the backward from the same statistics), each launched twice
    on the same inputs and required to give the same bits, with the plans
    they ran; ``offset`` starts x and dy that many elements past a 16-byte
    boundary (a sliced view: a narrower vector).  When timed, both
    passes' times with inputs warm in L2 and cold (`time_cold_ms`), each
    beside the bytes bound, `F.layer_norm`'s and the plain version's, and
    the ptxas numbers of the kernels that ran."""
    def rnd(*shape, scale=1.0, shift=0.0):
        t = torch.randn(*shape, device="cuda", generator=gen)
        return (t * scale + shift).to(dtype)

    def view(t):
        # the rows of a buffer ``offset`` elements longer, from element
        # ``offset`` on
        if not offset:
            return t
        out = torch.empty(rows * n + offset, device="cuda", dtype=dtype)
        out = out[offset:].view(rows, n)
        return out.copy_(t)
    x, dy = view(rnd(rows, n)), view(rnd(rows, n))
    gamma, beta = rnd(n, scale=0.1, shift=1.0), rnd(n, scale=0.1)
    y, mean, rstd = layer_norm_fwd(x, gamma, beta, 1e-5)
    dx, dg, db = layer_norm_bwd(x, gamma, mean, rstd, dy)
    fwd2 = layer_norm_fwd(x, gamma, beta, 1e-5)
    bwd2 = layer_norm_bwd(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    same_f = all(torch.equal(a, b) for a, b in zip((y, mean, rstd), fwd2))
    same_b = all(torch.equal(a, b) for a, b in zip((dx, dg, db), bwd2))
    del fwd2, bwd2
    ry, rmean, rrstd = layer_norm_fwd_plain(x, gamma, beta, 1e-5)
    rdx, rdg, rdb = layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    f_err = rel_check(dtype, [(y, ry)])
    stats = rel_check(torch.float32, [(mean, rmean), (rstd, rrstd)])
    f_err = (max(f_err[0], stats[0]), max(f_err[1], stats[1]),
             f_err[2] and stats[2] and same_f)
    b_err = rel_check(dtype, [(dx, rdx), (dg, rdg), (db, rdb)])
    b_err = (b_err[0], b_err[1], b_err[2] and same_b)
    plans = ln_plans(x, gamma, dy)
    extra = [{"bit_identical": same_f, "plan": plans["fwd"]},
             {"bit_identical": same_b, "plan": plans["bwd"]}]
    if offset:
        extra[0]["offset"] = extra[1]["offset"] = offset
    if not timed:
        return [dict(_record("layer_norm", [rows, n], dtype, f_err, False),
                     **extra[0]),
                dict(_record("layer_norm_bwd", [rows, n], dtype, b_err,
                             False), **extra[1])]
    isz = x.element_size()
    fb = bound_ms(2 * rows * n * isz + 2 * n * isz + 2 * rows * 4,
                  8 * rows * n, dtype)
    bb = bound_ms(3 * rows * n * isz + 3 * n * isz + 2 * rows * 4,
                  13 * rows * n, dtype)
    leaves = [t.detach().clone().requires_grad_() for t in (x, gamma, beta)]
    lib_fwd = lambda: F.layer_norm(leaves[0], (n,), leaves[1], leaves[2],
                                   1e-5)
    fwd = lambda: layer_norm_fwd(x, gamma, beta, 1e-5)
    bwd = lambda: layer_norm_bwd(x, gamma, mean, rstd, dy)
    recs = [
        _record("layer_norm", [rows, n], dtype, f_err, True,
                ms=time_auto(fwd), cold_ms=time_cold_ms(fwd),
                plain_ms=time_auto(
                    lambda: layer_norm_fwd_plain(x, gamma, beta, 1e-5)),
                library_ms=time_auto(
                    lambda: F.layer_norm(x, (n,), gamma, beta, 1e-5)),
                bound_ms=fb[0], bound_by=fb[1]),
        _record("layer_norm_bwd", [rows, n], dtype, b_err, True,
                ms=time_auto(bwd), cold_ms=time_cold_ms(bwd),
                plain_ms=time_auto(
                    lambda: layer_norm_bwd_plain(x, gamma, mean, rstd, dy)),
                library_ms=_library_bwd_ms(lib_fwd, leaves, dy),
                bound_ms=bb[0], bound_by=bb[1])]
    for rec, more, kind in zip(recs, extra, ("fwd", "bwd")):
        rec.update(more)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["cold_bound_share"] = rec["bound_ms"] / rec["cold_ms"]
        rec["ptxas"] = ln_ptxas(dtype, more["plan"], kind)
    if n == 768:
        # the backward's two kernels: the row kernel and the column sums
        # of the blocks' partial rows, from one profiled call
        _, _, device, _ = profiled(bwd)
        recs[1]["kernel_split_ms"] = {
            "rows": kernel_ms(device, "ln_bwd_kernel"),
            "column_sums": kernel_ms(device, "ln_bwd_reduce_kernel")}
    return recs


def layer_norm_layout_checks(gen):
    """LayerNorm forward and backward in each layout and vector width the
    plans pick, each against the plain version and twice bit for bit: N
    = 30 in bf16 (4-byte vectors; a prefill's 1000 rows take 4 warps a
    row), 1000 in float32 (64 rows: 8 warps a row), GPT-2 medium's 1024 in
    both dtypes (a warp a row, 32 elements a lane), 8192 (a block of 8
    warps a row) in both, 12300 in bf16 (the wide loop at 8-byte vectors,
    in `training_kernel_checks`), and x and dy one element past a 16-byte
    boundary (single elements) at 768; decode's (8, 768) takes 8 warps a
    row (`training_kernel_checks`)."""
    cases = []
    for rows, n, dtype, offset in (
            (1000, 30, torch.bfloat16, 0), (64, 1000, torch.float32, 0),
            (2048, 1024, torch.float32, 0), (2048, 1024, torch.bfloat16, 0),
            (256, 8192, torch.float32, 0), (256, 8192, torch.bfloat16, 0),
            (2000, 768, torch.bfloat16, 1), (2000, 768, torch.float32, 1)):
        cases += layer_norm_train_case(rows, dtype, gen, n=n, timed=False,
                                       offset=offset)
    return cases


def flash_train_case(layout, batch, heads, d, dtype, gen, sq=1024,
                     skv=1024, causal=True, q_off=0, k_off=0, timed=True,
                     misaligned=False):
    """Flash attention forward and backward as training runs it: (B, H, S,
    D) views of (B, S, H, D) projections ('bhsd', the graph's transposes;
    'ds', the same through the dS route) or (B, S, E) operands through
    `flash_attention_bsd` ('bsd'; 'stream', the grid-streamed route's
    pin).  Out, lse, dq, dk and dv of the kernels (lse cotangent
    included) against the plain versions, with the launches counted on
    the layout's route alone; when timed, each pass's time beside
    `scaled_dot_product_attention`'s.  On 'ds' the kernels' times are
    those of the kernels on the dS operands; ``route_ms`` adds the
    route's boundary copies.  ``misaligned`` ('bhsd') hands over a k whose
    sequence stride (d + 2) is no multiple of 16 bytes, which the
    wrappers copy before both passes."""
    pins, name, route = FLASH_LAYOUTS[layout]
    with pinned(**pins):
        bsd = layout in ("bsd", "stream")
        fn = flash_attention_bsd if bsd else flash_attention
        plain = flash_attention_bsd_plain if bsd else flash_attention_plain
        extra = (heads,) if bsd else ()
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)

        def make(s):
            t = torch.randn(batch, s, heads, d, device="cuda", generator=gen)
            t = t.to(dtype)
            return t.reshape(batch, s, heads * d) if bsd else t.transpose(1, 2)

        def heads_view(t):
            return t.reshape(batch, t.shape[1], heads, d).transpose(1, 2) \
                if bsd else t

        q, k, v = make(sq), make(skv), make(skv)
        if misaligned:
            k = torch.zeros(batch, heads, skv, d + 2, device="cuda",
                            dtype=dtype)[..., :d].copy_(k)
        g = make(sq)
        glse = torch.randn(batch, heads, sq, device="cuda", generator=gen)

        def through(f):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out, lse = f(*leaves, *extra, with_lse=True, **kw)
            torch.autograd.backward((out, lse), (g, glse))
            return out, lse, [t.grad for t in leaves]

        reset_counts()
        out, lse, grads = through(fn)
        torch.cuda.synchronize()
        launched = {k: n for k, n in read_counts().items() if n}
        want = {k: 1 for k in (name, name + "_dq", name + "_dkv")}
        if wide_width(d):
            want.update({name + k: 1
                         for k in ("_wide", "_wide_dq", "_wide_dkv")})
        if launched != want:
            raise SystemExit("%s %s: launches %s, expected %s"
                             % (name, dtype, launched, want))
        rout, rlse, rgrads = through(plain)
        shape = [batch, heads, sq, skv, d]
        # the kernel path's own residuals, (B, H, S, D) and in the
        # kernels' layout
        q4, k4, v4, g4, o4 = (heads_view(t.detach())
                              for t in (q, k, v, g, out))
        lse = lse.detach()
        scale = 1.0 / math.sqrt(d)
        args = (q_off, k_off, scale, causal)
        if layout == "ds":
            kq, kk, kv, ko, kg = (_to_ds(t) for t in (q4, k4, v4, o4, g4))
        else:
            kq, kk, kv, ko, kg = q4, k4, v4, o4, g4
        extra_fwd, extra_bwd = {}, {}
        if dtype == torch.bfloat16:
            # held against the plain forward in float32 on float32 copies
            # of the same operands (see REL_TOL); the bf16 plain one printed
            out32, lse32 = _flash_fwd_plain(
                *(t.float() for t in (q4, k4, v4)), *args)
            f_err = combine(rel_check(dtype, [(o4, out32)]),
                            rel_check(torch.float32, [(lse, lse32)]))
            del out32, lse32
            extra_fwd = {"reference": "plain float32 on the bf16 operands",
                         "bf16_plain_rel_err": rel_check(
                             dtype, [(out, rout)])[1]}
        else:
            f_err = combine(rel_check(dtype, [(out, rout)]),
                            rel_check(torch.float32, [(lse, rlse)]))
        # two launches on the same inputs: bit-identical out and lse (no
        # atomics, in either dtype)
        once = _flash_fwd_cuda(kq, kk, kv, *args, True, route)
        again = _flash_fwd_cuda(kq, kk, kv, *args, True, route)
        same = all(torch.equal(a, b) for a, b in zip(once, again))
        del once, again
        f_err = (f_err[0], f_err[1], f_err[2] and same)
        extra_fwd["bit_identical"] = same
        if dtype == torch.bfloat16:
            # held against the plain backward in float32 on float32 copies
            # of the same operands (see REL_TOL); the bf16 plain one printed
            ref32 = _flash_bwd_plain(*(t.float() for t in (q4, k4, v4, o4)),
                                     lse, g4.float(), glse, *args)
            b_err = rel_check(dtype, [(heads_view(a), r)
                                      for a, r in zip(grads, ref32)])
            del ref32
            plain16 = rel_check(dtype, list(zip(grads, rgrads)))
            # two launches on the same inputs: bit-identical gradients
            once = _flash_bwd_cuda(kq, kk, kv, ko, lse, kg, glse, *args,
                                   route)
            again = _flash_bwd_cuda(kq, kk, kv, ko, lse, kg, glse, *args,
                                    route)
            same = all(torch.equal(a, b) for a, b in zip(once, again))
            del once, again
            b_err = (b_err[0], b_err[1], b_err[2] and same)
            extra_bwd = {"reference": "plain float32 on the bf16 operands",
                         "bf16_plain_rel_err": plain16[1],
                         "bit_identical": same}
        else:
            b_err = rel_check(dtype, list(zip(grads, rgrads)))
            # two launches of the 3xTF32 kernels on the same inputs:
            # bit-identical gradients (no atomics)
            once = _flash_bwd_cuda(kq, kk, kv, ko, lse, kg, glse, *args,
                                   route)
            again = _flash_bwd_cuda(kq, kk, kv, ko, lse, kg, glse, *args,
                                    route)
            same = all(torch.equal(a, b) for a, b in zip(once, again))
            del once, again
            b_err = (b_err[0], b_err[1], b_err[2] and same)
            extra_bwd = {"bit_identical": same}
        if misaligned:
            extra_fwd["misaligned"] = extra_bwd["misaligned"] = True
        if not timed:
            return [dict(_record(name, shape, dtype, f_err, False),
                         **extra_fwd),
                    dict(_record(name + "_bwd", shape, dtype, b_err, False),
                         **extra_bwd)]
        isz = q.element_size()
        pairs = visible_pairs(sq, skv, causal, q_off, k_off) * batch * heads
        # operations per visible pair: 2·d for each product the function
        # needs, Q Kᵀ and P V forward; Q Kᵀ once, dO Vᵀ, dV, dQ and dK
        # backward (the two-pass kernels' recompute of Q Kᵀ and dO Vᵀ is
        # not work the function needs)
        fwd_bytes = (batch * heads * d * (2 * sq + 2 * skv) * isz
                     + batch * heads * sq * 4)
        fb = bound_ms(fwd_bytes, 4 * d * pairs, dtype)
        bwd_bytes = (batch * heads * d * (4 * sq + 4 * skv) * isz
                     + 2 * batch * heads * sq * 4)
        bb = bound_ms(bwd_bytes, 10 * d * pairs, dtype)
        if dtype == torch.float32:
            # the float32 kernels' products run in 3xTF32 on the tensor
            # cores, three TF32 products for each: their least time is at
            # that rate; the CUDA-core bounds are kept beside them
            fb_cuda_core, bb_cuda_core = fb[0], bb[0]
            fb = bound_ms(fwd_bytes, 3 * 4 * d * pairs, dtype, PEAK_TF32)
            bb = bound_ms(bwd_bytes, 3 * 10 * d * pairs, dtype, PEAK_TF32)
        leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
        sdpa = lambda: F.scaled_dot_product_attention(*leaves,
                                                      is_causal=causal)
        route_fwd = lambda: fn(q, k, v, *extra, with_lse=True, **kw)
        if layout == "ds":
            kernel_fwd = lambda: _flash_fwd_cuda(kq, kk, kv, *args, True,
                                                 route)
        else:
            kernel_fwd = route_fwd
        fwd = _record(name, shape, dtype, f_err, True,
                      ms=time_auto(kernel_fwd),
                      plain_ms=time_auto(lambda: plain(q, k, v, *extra,
                                                       with_lse=True, **kw)),
                      library_ms=time_auto(
                          lambda: F.scaled_dot_product_attention(
                              q4, k4, v4, is_causal=causal)),
                      bound_ms=fb[0], bound_by=fb[1], **extra_fwd)
        if layout == "ds":
            fwd["route_ms"] = time_auto(route_fwd)
        # the rate the function's 4·d operations a visible pair reach
        fwd["tflops"] = 4 * d * pairs / (fwd["ms"] * 1e-3) / 1e12
        fwd["bound_share"] = fwd["bound_ms"] / fwd["ms"]
        if dtype == torch.bfloat16:
            fwd["ptxas"] = mma_ptxas("flash_attention_fwd", d,
                                     int(layout == "ds"))
        else:
            fwd["bound_cuda_core_ms"] = fb_cuda_core
            fwd["ptxas"] = mma_ptxas("flash_attention_fwd_f32", d,
                                     int(layout == "ds"))
        bwd = _record(name + "_bwd", shape, dtype, b_err, True,
                      ms=time_auto(lambda: _flash_bwd_cuda(
                          kq, kk, kv, ko, lse, kg, glse, *args, route)),
                      plain_ms=time_auto(lambda: _flash_bwd_plain(
                          q4, k4, v4, o4, lse, g4, glse, *args)),
                      library_ms=_library_bwd_ms(sdpa, leaves, g4),
                      bound_ms=bb[0], bound_by=bb[1], **extra_bwd)
        # the part of ``ms`` spent on delta = rowsum(dO * O) - glse, which
        # the wrapper computes in torch before the kernels
        bwd["delta_ms"] = time_auto(lambda: _delta(ko, kg, glse,
                                                   2 if layout == "ds" else 3))
        # the rate the function's 10·d operations a visible pair reach
        bwd["tflops"] = 10 * d * pairs / (bwd["ms"] * 1e-3) / 1e12
        bwd["bound_share"] = bwd["bound_ms"] / bwd["ms"]
        if dtype == torch.bfloat16:
            bwd["ptxas"] = mma_ptxas("flash_attention_bwd", d,
                                     int(layout == "ds"))
        else:
            bwd["bound_cuda_core_ms"] = bb_cuda_core
            bwd["ptxas"] = mma_ptxas("flash_attention_bwd_f32", d,
                                     int(layout == "ds"))
        return [fwd, bwd]


def describe(c):
    """One check's line: its error against its tolerance and its times."""
    if "rel_tol" in c:
        tol = "rel err %.2e (tol %.0e of max|ref|)" % (c["rel_err"],
                                                        c["rel_tol"])
    else:
        tol = "(rtol %.1e atol %.1e)" % (c["rtol"], c["atol"])
    line = "check %-23s %-26s %-14s err %.3e %s %s" % (
        c["kernel"], c["shape"], c["dtype"], c["max_abs_err"], tol,
        "ok" if c["ok"] else "FAIL")
    if "ms" in c:
        line += (" | kernel %.4f ms  plain %.4f ms  library %.4f ms  bound "
                 "%.5f ms (%s)" % (c["ms"], c["plain_ms"], c["library_ms"],
                                   c["bound_ms"], c["bound_by"]))
    if "cold_ms" in c:
        line += ("; cold L2 %.4f ms; bound share warm %.3f, cold %.3f"
                 % (c["cold_ms"], c["bound_share"], c["cold_bound_share"]))
    if "kernel_split_ms" in c:
        line += "; kernels %s" % c["kernel_split_ms"]
    if "plan" in c:
        line += "; plan %s" % c["plan"]
    if "ms_with_launch" in c:
        line += "; kernel with launch %.4f ms" % c["ms_with_launch"]
    if "route_ms" in c:
        line += "; route with its boundary copies %.4f ms" % c["route_ms"]
    if "tflops" in c and c["kernel"].startswith("fused_ce"):
        line += ("; %.1f TFLOP/s (2·n·V·d a logit pass), %.3f of the bound"
                 % (c["tflops"], c["bound_share"]))
    elif "tflops" in c:
        line += ("; %.1f TFLOP/s (%s·d a visible pair), %.3f of the bound"
                 % (c["tflops"], 10 if "delta_ms" in c else 4,
                    c["bound_share"]))
    if "bound_cuda_core_ms" in c:
        line += ("; the bound is 3xTF32's, the CUDA-core one %.4f ms"
                 % c["bound_cuda_core_ms"])
    if "delta_ms" in c:
        line += "; the wrapper's delta %.4f ms of it" % c["delta_ms"]
    if "bf16_plain_rel_err" in c:
        line += ("; vs the plain f32 version on the bf16 operands, beside "
                 "it the bf16 plain one %.2e; bit-identical twice: %s"
                 % (c["bf16_plain_rel_err"], c["bit_identical"]))
    if c.get("reference") == "plain bf16" or (
            "bit_identical" in c and "bf16_plain_rel_err" not in c):
        line += "; bit-identical twice: %s" % c["bit_identical"]
    if any(c.get("padded_calls", {}).values()):
        line += "; padded calls %s" % c["padded_calls"]
    if "ptxas" in c:
        line += "; ptxas registers, spill (stores, loads) bytes %s" % c[
            "ptxas"]
    return line


def wide_width(d):
    """Whether head_dim ``d`` is a width of the wide kernels unpadded."""
    return d > 256 and d % 128 == 0


def width_case(d, dtype, layout, gen, batch=2, heads=3, s=200, q_off=24,
               causal=True, skv=None, k_off=0):
    """Flash attention at head_dim ``d`` through the public function and
    route of ``layout`` (a key of `FLASH_LAYOUTS`), forward and backward
    (lse cotangent included), against the plain versions: float32 against
    float32 at ``REL_TOL``; bf16 against the plain versions in float32 on
    the same bf16 operands, as the kernels' own checks.  ``skv`` keys (s
    by default).  The call must count on its route: below 32 one
    plain-route call and no launch; a kernel width (64, 128, 256, or a
    multiple of 128 above 256) one forward, dq and dk/dv launch; any other
    width those and one padded call; above 256 the launches also count on
    the route's wide counters.  On the kernel routes a second call must give the same
    bits (no atomics in either dtype)."""
    pins, name, route = FLASH_LAYOUTS[layout]
    skv = s if skv is None else skv
    bsd = layout in ("bsd", "stream")
    fn = flash_attention_bsd if bsd else flash_attention
    plain = flash_attention_bsd_plain if bsd else flash_attention_plain
    extra = (heads,) if bsd else ()

    def make(n):
        t = torch.randn(batch, n, heads, d, device="cuda", generator=gen)
        t = t.to(dtype)
        return t.reshape(batch, n, heads * d) if bsd else t.transpose(1, 2)

    q, k, v, g = make(s), make(skv), make(skv), make(s)
    glse = torch.randn(batch, heads, s, device="cuda", generator=gen)

    def through(f, ts):
        leaves = [t.detach().clone().requires_grad_() for t in ts]
        out, lse = f(*leaves, *extra, causal=causal, q_offset=q_off,
                     k_offset=k_off, with_lse=True)
        torch.autograd.backward((out, lse), (g.to(out.dtype), glse))
        return [out, lse] + [t.grad for t in leaves]

    with pinned(**pins):
        reset_counts()
        got = through(fn, (q, k, v))
        torch.cuda.synchronize()
        launched = {c: n for c, n in read_counts().items() if n}
        same = d < 32 or all(torch.equal(a, b) for a, b in
                             zip(got, through(fn, (q, k, v))))
    want = {name + "_narrow": 1} if d < 32 else \
        {name: 1, name + "_dq": 1, name + "_dkv": 1}
    if d >= 32 and d not in (64, 128, 256) and not wide_width(d):
        want[name + "_padded"] = 1
    if d > 256:
        want.update({name + k: 1 for k in ("_wide", "_wide_dq", "_wide_dkv")})
    ref = through(plain, [t.float() for t in (q, k, v)])
    err = combine(rel_check(dtype, [(got[0], ref[0])] + list(zip(got[2:],
                                                                  ref[2:]))),
                  rel_check(torch.float32, [(got[1], ref[1])]))
    rec = _record("flash_attention width %d (%s%s%s)"
                  % (d, layout, "" if causal else ", not causal",
                     ", k_offset %d" % k_off if k_off else ""),
                  [batch, heads, s, skv, d], dtype,
                  (err[0], err[1], err[2] and launched == want and same),
                  False)
    rec["launches"] = launched
    if d >= 32:
        rec["bit_identical"] = same
    return rec


def width_checks(gen):
    """The head widths the kernels do not take natively, on every route in
    both dtypes; the head-256 kernels at 256 and at 160 and 192 padded to
    it, causal and not, with a key length no multiple of 8 (333); and a
    head of 320, padded to the wide kernels' 384."""
    cases = [width_case(d, dtype, layout, gen)
             for d in (16, 32, 48, 80, 96, 160)
             for dtype in (torch.float32, torch.bfloat16)
             for layout in FLASH_LAYOUTS]
    cases += [width_case(d, dtype, layout, gen, skv=333, causal=causal,
                         q_off=133 if causal else 24)
              for d in (192, 256)
              for dtype in (torch.float32, torch.bfloat16)
              for layout in FLASH_LAYOUTS
              for causal in (True, False)]
    # above 256: 320 zero-padded to the wide kernels' 384 (phase 23 holds
    # their own widths)
    cases += [width_case(320, dtype, layout, gen, skv=333)
              for dtype in (torch.float32, torch.bfloat16)
              for layout in FLASH_LAYOUTS]
    return cases


def training_kernel_checks():
    """Every kernel of the training path against its plain version, forward
    and backward, at the shapes the training phases give them (timed) and
    at the smaller and odd shapes of the backward's own checks."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += layer_norm_train_case(32768, dtype, gen)
        cases += layer_norm_train_case(8, dtype, gen, timed=False)
        cases += flash_train_case("bhsd", 4, 12, 64, dtype, gen, timed=False)
        cases += flash_train_case("bsd", 4, 6, 128, dtype, gen, timed=False)
        # not causal, Sq != Skv, offsets: the lse cotangent reaches every row
        cases += flash_train_case("bhsd", 2, 4, 64, dtype, gen, sq=300,
                                  skv=700, causal=False, q_off=400,
                                  k_off=100, timed=False)
        # the training shapes, timed
        cases += flash_train_case("bhsd", 32, 12, 64, dtype, gen)
        cases += flash_train_case("bsd", 32, 6, 128, dtype, gen)
    # causal with offsets: the dk/dv loop's first query tile moves
    cases += flash_train_case("bsd", 1, 2, 128, torch.float32, gen, sq=256,
                              skv=768, q_off=512, timed=False)
    # the bf16 kernels' ragged tiles at head 128, in both layouts: the
    # causal diagonal 37 positions into a 64-position tile, a 13-position
    # tail (333 = 5 * 64 + 13, not a multiple of 8: the dS copies pad their
    # rows), and rows that see no key (k_off 50)
    for layout in ("bhsd", "ds"):
        cases += flash_train_case(layout, 2, 3, 128, torch.bfloat16, gen,
                                  sq=333, skv=333, q_off=37, timed=False)
        cases += flash_train_case(layout, 2, 2, 128, torch.bfloat16, gen,
                                  sq=200, skv=333, k_off=50, timed=False)
    # a bf16 k the kernels cannot read in place (sequence stride d + 2):
    # copied by the wrappers before the forward and both backward passes
    cases += flash_train_case("bhsd", 2, 4, 128, torch.bfloat16, gen,
                              sq=200, skv=260, q_off=60, timed=False,
                              misaligned=True)
    cases += width_checks(gen)
    # rows wider than the LayerNorm register kernels hold: the wide-row
    # kernels, at a power of two (timed) and a ragged width
    for dtype in (torch.float32, torch.bfloat16):
        cases += layer_norm_train_case(1024, dtype, gen, n=16384)
        cases += layer_norm_train_case(64, dtype, gen, n=12300, timed=False)
    cases += layer_norm_layout_checks(gen)
    for c in cases:
        log(describe(c))
    log("card after the training kernel checks (sm clock, mem clock, power, "
        "temp): %s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("training kernel checks failed: %s" % bad)
    return cases


def longctx_kernel_checks():
    """The dS route's kernels (rows 5 and 6) and the grid-streamed bsd
    route's (rows 9 and 10) against the plain versions, in float32 and
    bf16: at the long-context training shapes, timed, and at ragged ones
    with offsets and at head 64."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += flash_train_case("ds", 1, 2, 128, dtype, gen, sq=1000,
                                  skv=1000, q_off=24, timed=False)
        cases += flash_train_case("ds", 2, 4, 64, dtype, gen, sq=520,
                                  skv=520, timed=False)
        cases += flash_train_case("ds", 2, 4, 64, dtype, gen, sq=300,
                                  skv=700, causal=False, q_off=400,
                                  k_off=100, timed=False)
        cases += flash_train_case("stream", 1, 2, 128, dtype, gen, sq=1000,
                                  skv=1000, q_off=24, timed=False)
        cases += flash_train_case("stream", 2, 4, 64, dtype, gen, sq=520,
                                  skv=520, timed=False)
        # the training shapes, timed
        cases += flash_train_case("ds", 8, 6, 128, dtype, gen, sq=4096,
                                  skv=4096)
        cases += flash_train_case("stream", 4, 6, 128, dtype, gen, sq=8192,
                                  skv=8192)
    cases += route_pin_checks(gen)
    for c in cases:
        log(describe(c))
    log("card after the long-context kernel checks (sm clock, mem clock, "
        "power, temp): %s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("long-context kernel checks failed: %s" % bad)
    return cases


def route_pin_checks(gen):
    """The plain pins on the card: ``MXNET_FLASH_IMPL=jnp`` launches no
    kernel in either layout and gives the plain versions' result bit for
    bit; ``MXNET_FLASH_BWD=jnp`` launches the forward kernel alone and
    agrees with the plain versions to the float32 tolerance; a mistyped
    ``MXNET_FLASH_BSD_KERNEL`` raises."""
    x = torch.randn(2, 256, 4, 128, device="cuda", generator=gen)
    g = torch.randn(2, 256, 4, 128, device="cuda", generator=gen)
    cases = []
    for label, pins, fn, want, exact in (
            ("jnp", {"MXNET_FLASH_IMPL": "jnp"}, flash_attention, {}, True),
            ("jnp", {"MXNET_FLASH_IMPL": "jnp"}, flash_attention_bsd, {},
             True),
            ("bwd jnp", {"MXNET_FLASH_BWD": "jnp",
                         "MXNET_FLASH_LAYOUT": "ds"}, flash_attention,
             {"flash_attention_ds": 1}, False)):
        bsd = fn is flash_attention_bsd
        args = [t.reshape(2, 256, 512) if bsd else t.transpose(1, 2)
                for t in (x, x, x)]
        cot = g.reshape(2, 256, 512) if bsd else g.transpose(1, 2)
        extra = (4,) if bsd else ()
        plain = flash_attention_bsd_plain if bsd else flash_attention_plain

        def through(f):
            leaves = [t.detach().clone().requires_grad_() for t in args]
            out = f(*leaves, *extra, causal=True)
            out.backward(cot)
            return [out] + [t.grad for t in leaves]

        with pinned(**pins):
            reset_counts()
            got = through(fn)
            torch.cuda.synchronize()
            launched = {k: n for k, n in read_counts().items() if n}
        ref = through(plain)
        err, rel, ok = rel_check(torch.float32, list(zip(got, ref)))
        if exact:
            ok = all(torch.equal(a, b) for a, b in zip(got, ref))
        cases.append(_record("pin %s, %s" % (label, fn.__name__),
                             [2, 4, 256, 256, 128], torch.float32,
                             (err, rel, ok and launched == want), False))
        cases[-1]["launches"] = launched
    with pinned(MXNET_FLASH_BSD_KERNEL="streamed"):
        y = x.reshape(2, 256, 512)
        try:
            flash_attention_bsd(y, y, y, 4, causal=True)
            raised = False
        except mx.MXNetError:
            raised = True
    cases.append(_record("pin streamed raises", [2, 4, 256, 256, 128],
                         torch.float32, (0.0, 0.0, raised), False))
    return cases


# -- phase 9: the fused CE head's kernels ---------------------------------

# the training head's shape: 32 x 1024 tokens, embed 768, vocab 32768
CE_TRAIN = (32768, 768, 32768)
# ragged ones: no multiple of the tiles in tokens or vocabulary (GPT-2's),
# at GPT-2 small's, medium's and XL's widths (1600: past the widest float32
# cluster's 1536 columns), at 4096 (past the widest bf16 cluster's 3072),
# and one whose bf16 d the wrapper zero-pads from 772 to 776
CE_RAGGED = (1000, 768, 50257)
CE_MEDIUM = (8192, 1024, 50257)
CE_XL = (1000, 1600, 50257)
CE_WIDE = (300, 4096, 5000)
CE_PADDED = (333, 772, 1000)
# d = 30 (`get_transformer_lm(num_embed=30)`'s head): no multiple of either
# granule, zero-padded to 32 in both dtypes
CE_NARROW = (333, 30, 1000)
# the op's default tiles: a pin the kernels take (multiples of 32); the
# plain versions tile the vocabulary by block_v as the jnp twins do
CE_BLOCKS = (512, 2048)
# each checked function's kernel modes (0 A, 1 B, 2 C, 3 D)
CE_MODES = {"fused_ce_fwd": (0,), "fused_ce_fwd_sp": (1,),
            "fused_ce_bwd_dw_rs": (2,), "fused_ce_bwd_dx_rs": (3,),
            "fused_ce_bwd": (3, 2)}


def ce_operands(n, d, v, dtype, gen, ragged):
    """x, W, b, int32 labels, the loss-head arguments and r = grad_scale *
    valid.  ``ragged``: no bias (zeros), every 7th label -1 and every 11th
    past V (out of range), every 5th the ignore label 5 under use_ignore,
    grad_scale 1.7."""
    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (0.05 * torch.randn(v, d, device="cuda", generator=gen)).to(dtype)
    b = torch.zeros(v, device="cuda", dtype=dtype) if ragged else \
        (0.1 * torch.randn(v, device="cuda", generator=gen)).to(dtype)
    label = torch.randint(0, v, (n,), device="cuda", generator=gen,
                          dtype=torch.int32)
    head = (1.0, -1.0, False)
    if ragged:
        label[::7] = -1
        label[3::11] = v + 5
        label[1::5] = 5
        head = (1.7, 5.0, True)
    r, _ = fce._valid_coef(label, *head)
    return x, w, b, label, head, r


def combine(*errs):
    """One (max abs error, max rel error, ok) over several `rel_check`s."""
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs))


def ce_case(shape, dtype, gen, ragged=False, timed=False):
    """Kernels A, B, C, D and the 5-pass backward (D + C) against their
    plain versions on the same inputs, in the same dtype.  Outputs that
    are float32 by contract (nll, lse, the picked logit) are held to the
    float32 tolerance; dxp (p rounded to W's dtype before p @ W), dx, dW
    and db to the dtype's.  Every kernel runs twice and must give the
    same bits, and a bf16 d of 4 more than a multiple of 8 must be counted
    as padded on every wrapper.  When timed: each beside its bound (in
    float32 the 3xTF32 one, the CUDA-core one beside it) and the
    library's `F.linear` + `F.cross_entropy`, forward for A and B,
    backward for the rest, with its TFLOP/s, share of the bound and
    ptxas's registers and spills."""
    n, d, v = shape
    x, w, b, label, head, r = ce_operands(n, d, v, dtype, gen, ragged)
    gs, ign, use = head
    bv = CE_BLOCKS[1]
    kernels = {
        "fused_ce_fwd": lambda: fce.fused_ce_fwd(x, w, b, label, ign, use,
                                                 *CE_BLOCKS),
        "fused_ce_fwd_sp": lambda: fce.fused_ce_fwd_sp(x, w, b, label,
                                                       *CE_BLOCKS)}
    reset_counts()
    got = {k: fn() for k, fn in kernels.items()}
    torch.cuda.synchronize()
    ref = {"fused_ce_fwd": fce._fwd_plain(x, w, b, label, ign, use, bv),
           "fused_ce_fwd_sp": fce._fwd_sp_plain(x, w, b, label, bv)}
    lse = ref["fused_ce_fwd"][1]
    kernels.update({
        "fused_ce_bwd_dw_rs": lambda: fce.fused_ce_bwd_dw(
            x, w, b, label, lse, r, *CE_BLOCKS),
        "fused_ce_bwd_dx_rs": lambda: (fce.fused_ce_bwd_dx(
            x, w, b, label, lse, r, *CE_BLOCKS),),
        "fused_ce_bwd": lambda: fce.fused_ce_bwd(x, w, b, label, lse, *head,
                                                 *CE_BLOCKS)})
    got.update({k: kernels[k]() for k in ("fused_ce_bwd_dw_rs",
                                          "fused_ce_bwd_dx_rs",
                                          "fused_ce_bwd")})
    torch.cuda.synchronize()
    padded = {k: n for k, n in read_counts().items()
              if k.startswith("fused_ce") and k.endswith("_padded")}
    ref.update({
        "fused_ce_bwd_dw_rs": fce._bwd_dw_rs_plain(x, w, b, label, lse, r,
                                                   bv),
        "fused_ce_bwd_dx_rs": (fce._bwd_dx_rs_plain(x, w, b, label, lse, r,
                                                    bv),),
        "fused_ce_bwd": fce._bwd_plain(x, w, b, label, lse, *head, bv)})
    # every wrapper pads a d off the kernels' 16-byte granule (4 float32
    # or 8 bf16 columns), each call (the 5-pass backward calls D and C once
    # more), and no other
    want_pad = 1 if d % (8 if dtype == torch.bfloat16 else 4) else 0
    pad_ok = padded == {"fused_ce_fwd_padded": want_pad,
                        "fused_ce_fwd_sp_padded": want_pad,
                        "fused_ce_bwd_dw_padded": 2 * want_pad,
                        "fused_ce_bwd_dx_padded": 2 * want_pad}
    f32_outputs = {"fused_ce_fwd": 2, "fused_ce_fwd_sp": 2}
    recs = []
    for name, outs in got.items():
        k = f32_outputs.get(name, 0)
        pairs = list(zip(outs, ref[name]))
        err = combine(rel_check(torch.float32, pairs[:k]),
                      rel_check(dtype, pairs[k:]))
        # a second launch on the same inputs: the same bits
        again = kernels[name]()
        same = all(torch.equal(a, c) for a, c in zip(outs, again))
        del again
        extra = {"padded_calls": padded, "padded_ok": pad_ok,
                 "bit_identical": same}
        if dtype == torch.bfloat16:
            extra["reference"] = "plain bf16"
        err = (err[0], err[1], err[2] and same and pad_ok)
        recs.append(dict(_record(name, list(shape), dtype, err, False),
                         **extra))
    if not timed:
        return recs
    isz = x.element_size()
    # one pass over the logit tiles; each kernel recomputes its scores, but
    # the 5-pass backward as a function needs them once, then dl @ W and
    # dl^T @ x: 3 passes, not D's 2 plus C's 2
    ops = 2 * n * v * d
    passes = {"fused_ce_fwd": 1, "fused_ce_fwd_sp": 2,
              "fused_ce_bwd_dw_rs": 2, "fused_ce_bwd_dx_rs": 2,
              "fused_ce_bwd": 3}
    operands = (n * d + v * d + v) * isz + 4 * n
    nbytes = {"fused_ce_fwd": operands + 8 * n,
              "fused_ce_fwd_sp": operands + 8 * n + 4 * n * d,
              "fused_ce_bwd_dw_rs": operands + 8 * n + (v * d + v) * isz,
              "fused_ce_bwd_dx_rs": operands + 8 * n + n * d * isz,
              "fused_ce_bwd": operands + 4 * n + (n * d + v * d + v) * isz}
    bounds = {k: bound_ms(b, passes[k] * ops, dtype)
              for k, b in nbytes.items()}
    if dtype == torch.float32:
        # the float32 kernels' products run in 3xTF32 on the tensor cores,
        # three TF32 products for each: their least time is at that rate;
        # the CUDA-core bound is kept beside it
        cuda_core = {k: b[0] for k, b in bounds.items()}
        bounds = {k: bound_ms(b, 3 * passes[k] * ops, dtype, PEAK_TF32)
                  for k, b in nbytes.items()}
    plains = {
        "fused_ce_fwd": lambda: fce._fwd_plain(x, w, b, label, ign, use,
                                               bv),
        "fused_ce_fwd_sp": lambda: fce._fwd_sp_plain(x, w, b, label, bv),
        "fused_ce_bwd_dw_rs": lambda: fce._bwd_dw_rs_plain(x, w, b, label,
                                                           lse, r, bv),
        "fused_ce_bwd_dx_rs": lambda: fce._bwd_dx_rs_plain(x, w, b, label,
                                                           lse, r, bv),
        "fused_ce_bwd": lambda: fce._bwd_plain(x, w, b, label, lse, *head,
                                               bv)}
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    lab64 = label.long()
    lib_fwd = lambda: F.cross_entropy(F.linear(*leaves), lab64,  # noqa
                                      reduction="none")
    with torch.no_grad():
        lib = {"fwd": time_auto(lib_fwd)}
    lib["bwd"] = _library_bwd_ms(lib_fwd, leaves,
                                 torch.ones(n, device="cuda", dtype=dtype))
    del leaves
    for rec in recs:
        name = rec["kernel"]
        bnd, by = bounds[name]
        rec.update(ms=time_auto(kernels[name]),
                   plain_ms=time_auto(plains[name]),
                   library_ms=lib["fwd" if "fwd" in name else "bwd"],
                   bound_ms=bnd, bound_by=by)
        # the rate the function's passes over the logit tiles reach
        rec["tflops"] = passes[name] * ops / (rec["ms"] * 1e-3) / 1e12
        rec["bound_share"] = bnd / rec["ms"]
        if dtype == torch.float32:
            rec["bound_cuda_core_ms"] = cuda_core[name]
        rec["ptxas"] = {m: ce_ptxas(dtype, m, d) for m in CE_MODES[name]}
    return recs


def fused_ce_checks():
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += ce_case(CE_RAGGED, dtype, gen, ragged=True)
        cases += ce_case(CE_TRAIN, dtype, gen, timed=True)
        torch.cuda.empty_cache()
        cases += ce_case(CE_MEDIUM, dtype, gen, ragged=True)
        cases += ce_case(CE_XL, dtype, gen, ragged=True)
        cases += ce_case(CE_WIDE, dtype, gen, ragged=True)
        torch.cuda.empty_cache()
    cases += ce_case(CE_PADDED, torch.bfloat16, gen, ragged=True)
    # a d off the granule in both dtypes: zero-padded to 32
    for dtype in (torch.float32, torch.bfloat16):
        cases += ce_case(CE_NARROW, dtype, gen, ragged=True)
    for c in cases:
        log(describe(c))
    log("card after the fused CE checks (sm clock, mem clock, power, temp): "
        "%s" % card_state())
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("fused CE kernel checks failed: %s" % bad)
    return cases


# -- phases 3 and 4: the serving path --------------------------------------


def reset_counts():
    for w, attr in COUNTERS.values():
        setattr(w, attr, 0)


def read_counts():
    return {k: getattr(w, attr) for k, (w, attr) in COUNTERS.items()}


# the module globals through which the serving programs and the training
# ops call the kernels, and the plain version of each
_PLAIN = [(decode_mod, "layer_norm", layer_norm_plain),
          (decode_mod, "flash_attention", flash_attention_plain),
          (attention_mod, "layer_norm", layer_norm_plain),
          (attention_mod, "flash_attention", flash_attention_plain),
          (attention_mod, "flash_attention_bsd", flash_attention_bsd_plain),
          (loss_mod, "fused_softmax_ce", fce.fused_softmax_ce_plain)]


@contextlib.contextmanager
def plain_kernels():
    """Run the model's programs and ops through the kernels' plain
    versions: the reference the served logits and the training gradients
    are held against."""
    saved = [getattr(mod, name) for mod, name, _ in _PLAIN]
    for mod, name, plain in _PLAIN:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(_PLAIN, saved):
            setattr(mod, name, fn)


def serve(engine, requests):
    """Submit every (prompt, kwargs) pair at once, run the engine to idle
    and return the requests and the numbers phase 3/4 print."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, **kw) for p, kw in requests]
    steps = engine.run_until_idle(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    state = card_state()
    if not all(r.done for r in reqs):
        raise SystemExit("not every request finished")
    ttft = sorted(r.ttft_ms for r in reqs)
    gen_tokens = sum(len(r.tokens) for r in reqs)
    return reqs, {
        "requests": len(reqs), "completed": engine.stats["completed"],
        "generated_tokens": gen_tokens, "wall_s": wall, "steps": steps,
        "tokens_per_s": gen_tokens / wall,
        "ttft_ms_median": statistics.median(ttft),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "card_after": state, "stats": dict(engine.stats)}


def teacher_forced_kernel_logits(model, params, prompt, gen, block_size,
                                 dev=None):
    """Logits at each generated position through the engine's own kind
    of launches: one paged prefill chunk over the prompt, then one paged
    decode per generated token (kernels on).  ``dev`` defaults to the
    parameters' device (a sub-mesh model's shards name their own)."""
    dev = params["embed_weight"].device if dev is None else dev
    n_table = -(-model.seq_len // block_size)
    pool = model.init_block_pool(n_table + 1, block_size, device=dev)
    table = torch.arange(1, n_table + 1, device=dev)[None, :]
    bucket = 1 << max(4, (len(prompt) - 1).bit_length())
    toks = torch.zeros((1, min(bucket, model.seq_len)), dtype=torch.long,
                       device=dev)
    toks[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    zero = torch.zeros((1,), dtype=torch.long, device=dev)
    logits, _ = model.prefill_paged(params, pool, toks, zero,
                                    zero + len(prompt), table)
    rows = [logits[0]]
    for j, t in enumerate(gen[:-1]):
        pos = torch.tensor([len(prompt) + j], device=dev)
        logits, _ = model.decode_paged(params, pool,
                                       torch.tensor([t], device=dev), pos,
                                       table)
        rows.append(logits[0])
    return torch.stack(rows).float()


def reference_logits(model, params, prompt, gen):
    """Plain float32 logits at each generated position: one slot-cache
    prefill of prompt + generated with one row per position, row j cut
    at length len(prompt) + j."""
    dev = params["embed_weight"].device
    seq = list(prompt) + list(gen[:-1])
    n = len(gen)
    toks = torch.tensor([seq] * n, device=dev)
    length = torch.arange(len(prompt), len(prompt) + n, device=dev)
    with plain_kernels():
        logits, _ = model.prefill(params, toks, length)
    return logits.float()


def logit_check(model, params, reqs, block_size):
    out = []
    bf16_model = copy.copy(model)
    bf16_model.dtype = torch.bfloat16
    bf16_params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    for r in reqs:
        ref = reference_logits(model, params, r.prompt, r.tokens)
        got = teacher_forced_kernel_logits(model, params, r.prompt,
                                           r.tokens, block_size)
        err = float((got - ref).abs().max())
        bf16 = teacher_forced_kernel_logits(bf16_model, bf16_params,
                                            r.prompt, r.tokens, block_size)
        err_bf16 = float((bf16 - ref).abs().max())
        # the token the engine emitted is a near-argmax of the reference
        # logits wherever it decoded greedily
        picked = ref.gather(1, torch.tensor(r.tokens,
                                            device=ref.device)[:, None])
        gap = float((ref.max(dim=1).values - picked[:, 0]).max())
        res = {"request": r.id, "prompt_len": len(r.prompt),
               "positions": len(r.tokens), "temperature": r.temperature,
               "max_abs_err": err, "tol": LOGIT_TOL,
               "bf16_max_abs_err": err_bf16,
               "greedy_argmax_gap": gap if r.temperature == 0 else None}
        log("logits request %d (prompt %d, %d positions, T=%.1f): f32 kernel "
            "path vs plain f32 err %.3e (tol %.0e); same path in bf16 err "
            "%.3e%s" % (r.id, len(r.prompt), len(r.tokens), r.temperature,
                        err, LOGIT_TOL, err_bf16,
                        "" if r.temperature else "; greedy argmax gap %.2e"
                        % gap))
        if not err <= LOGIT_TOL:
            raise SystemExit("served logits disagree with the plain path")
        if not err_bf16 > LOGIT_TOL:
            raise SystemExit("logit tolerance does not separate bf16 from f32")
        if r.temperature == 0 and not gap <= LOGIT_TOL:
            raise SystemExit("a greedy token is not the reference argmax")
        out.append(res)
    return out


def print_serving(label, res):
    log("%s: %d/%d requests, %d tokens in %.3f s = %.1f tok/s, ttft median "
        "%.1f ms p99 %.1f ms, %d steps, launches %s, max_memory_allocated "
        "%d B; card after (sm clock, mem clock, power, temp): %s"
        % (label, res["completed"], res["requests"], res["generated_tokens"],
           res["wall_s"], res["tokens_per_s"], res["ttft_ms_median"],
           res["ttft_ms_p99"], res["steps"], res["launches"],
           res["max_memory_allocated"], res["card_after"]))


def paged_path(model, params):
    engine = ServingEngine(model, params, max_batch=8)
    t0 = time.perf_counter()
    warm = engine.warmup()
    warm_s = time.perf_counter() - t0
    log("paged engine: %s, warmup %.2f s" % (warm, warm_s))
    rng = np.random.RandomState(0)
    lens = rng.randint(32, 769, size=16)
    requests = []
    for i, n in enumerate(lens):
        prompt = rng.randint(0, model.vocab_size, size=int(n)).tolist()
        kw = dict(max_new_tokens=32, seed=i)
        if i % 2:
            kw.update(temperature=0.8, top_k=50, top_p=0.95)
        requests.append((prompt, kw))
    reqs, res = serve(engine, requests)
    res["warmup_s"] = warm_s
    res["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in params.values())
    res["pool_bytes"] = pool_bytes(model.num_layers, engine.n_blocks,
                                   engine.block_size, model.num_embed,
                                   params["embed_weight"].element_size())
    print_serving("paged path (default engine)", res)
    log("paged memory: weights %d B, K/V pool %d B (%d blocks of %d), "
        "peak allocated %d B" % (res["weight_bytes"], res["pool_bytes"],
                                 engine.n_blocks, engine.block_size,
                                 res["max_memory_allocated"]))
    if res["launches"]["layer_norm"] == 0:
        raise SystemExit("the paged path launched no LayerNorm kernel")
    res["logit_checks"] = logit_check(model, params, reqs[:2],
                                      engine.block_size)
    return engine, res


def slot_path(model, params):
    engine = ServingEngine(model, params, max_batch=8, paged=False)
    t0 = time.perf_counter()
    warm = engine.warmup()
    warm_s = time.perf_counter() - t0
    log("slot engine: %s, warmup %.2f s" % (warm, warm_s))
    rng = np.random.RandomState(1)
    requests = [(rng.randint(0, model.vocab_size, size=int(n)).tolist(),
                 dict(max_new_tokens=32))
                for n in rng.randint(520, 1001, size=4)]
    _, res = serve(engine, requests)
    res["warmup_s"] = warm_s
    print_serving("slot path (paged=False)", res)
    if res["launches"]["flash_attention"] < 4 * model.num_layers:
        raise SystemExit("the slot path's prefills did not run the flash "
                         "kernel (%d launches)"
                         % res["launches"]["flash_attention"])
    if res["launches"]["layer_norm"] == 0:
        raise SystemExit("the slot path launched no LayerNorm kernel")
    return engine, res


# -- phase 4b: serving, shared prefix and request contract -----------------

# the shared system prompt: 512 tokens, 32 blocks of 16
SYSTEM_LEN = 512
# the pressure engine's pool: the trash block, the shared prompt, and the
# private blocks of three requests at the longest suffix (256 + 32 new
# tokens = 18 blocks); one request's worst case is 50 blocks
PRESSURE_BLOCKS = 1 + SYSTEM_LEN // 16 + 3 * 18


def prefix_traffic(vocab):
    """The system prompt and 16 (prompt, kwargs): 15 of the prompt plus
    a 16-256-token suffix, odd ones sampled, then the prompt alone (the
    full-cover bootstrap)."""
    rng = np.random.RandomState(2)
    system = rng.randint(0, vocab, size=SYSTEM_LEN).tolist()
    out = []
    for i in range(15):
        suffix = rng.randint(0, vocab, size=int(rng.randint(16, 257)))
        kw = dict(max_new_tokens=32, seed=100 + i)
        if i % 2:
            kw.update(temperature=0.8, top_k=50, top_p=0.95)
        out.append((system + suffix.tolist(), kw))
    out.append((list(system), dict(max_new_tokens=32, seed=115)))
    return system, out


def serve_threaded(engine, requests):
    """Serve ``requests`` on the engine's own thread: the first alone
    until its first token (its prefill registers the shared prompt), then
    the rest at once; drain; return the requests and their numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    first = engine.submit(*requests[0][:1], **requests[0][1])
    while not first.tokens:
        if first.done or time.perf_counter() - t0 > 120:
            raise SystemExit("the first shared-prefix request produced no "
                             "token")
        time.sleep(0.0005)
    reqs = [first] + [engine.submit(p, **kw) for p, kw in requests[1:]]
    outs = [r.result(timeout=600) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    stragglers = engine.drain()
    if stragglers:
        raise SystemExit("drain left %d stragglers" % len(stragglers))
    ttft = sorted(r.ttft_ms for r in reqs)
    gen = sum(len(o) for o in outs)
    return reqs, {
        "requests": len(reqs), "generated_tokens": gen, "wall_s": wall,
        "tokens_per_s": gen / wall, "ttft_ms_median": statistics.median(ttft),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "ttft_ms_first": first.ttft_ms, "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "leaked_blocks": engine.leaked_blocks(), "stats": dict(engine.stats)}


def decision_margin(model, params, prompt, gen, j, kw):
    """The margin of the choice of generated token ``j`` on the plain
    float32 path: top-1 minus top-2 of the logits for a greedy request,
    of the sampler's scores (Gumbel noise plus the masked, tempered
    logits) for a sampled one."""
    from mxnet_tpu_torch.serving import sampling
    dev = params["embed_weight"].device
    seq = list(prompt) + list(gen[:j])
    with plain_kernels():
        logits, _ = model.prefill(params, torch.tensor([seq], device=dev),
                                  torch.tensor([len(seq)], device=dev))
    score = logits.float()
    t = kw.get("temperature", 0.0)
    if t > 0:
        masked = sampling._mask_top_k_top_p(
            score / t, torch.tensor([kw.get("top_k", 0)], device=dev),
            torch.tensor([kw.get("top_p", 1.0)], device=dev))
        noise = -torch.log(-torch.log(sampling.uniform(
            torch.tensor([kw["seed"]], device=dev),
            torch.tensor([len(seq)], device=dev), score.shape[-1])))
        score = noise + masked
    top = torch.topk(score[0], 2).values
    return float(top[0] - top[1])


def same_tokens(label, model, params, requests, want, got):
    """Tokens of two runs, request by request: where one parts from the
    other, the choice there must have been within LOGIT_TOL on the plain
    float32 path (a near-tie that rounding may break either way)."""
    parted = []
    for (prompt, kw), a, b in zip(requests, want, got):
        if a.tokens == b.tokens:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), min(len(a.tokens), len(b.tokens)))
        margin = decision_margin(model, params, prompt, a.tokens, j, kw)
        log("%s: request %d parts at generated position %d (%s vs %s), "
            "plain f32 margin %.3e (bar %.0e)"
            % (label, a.id, j, a.tokens[j:j + 1], b.tokens[j:j + 1],
               margin, LOGIT_TOL))
        parted.append({"request": a.id, "position": j, "margin": margin})
        if not margin < LOGIT_TOL:
            raise SystemExit("%s: tokens part where the choice was clear"
                             % label)
    log("%s: %d of %d requests equal token for token"
        % (label, len(requests) - len(parted), len(requests)))
    return parted


def print_prefix(label, res):
    log("%s: %d requests, %d tokens in %.3f s = %.1f tok/s, ttft first %.1f "
        "ms, median %.1f ms, p99 %.1f ms, max_memory_allocated %d B, "
        "leaked blocks %d, launches %s, stats %s"
        % (label, res["requests"], res["generated_tokens"], res["wall_s"],
           res["tokens_per_s"], res["ttft_ms_first"], res["ttft_ms_median"],
           res["ttft_ms_p99"], res["max_memory_allocated"],
           res["leaked_blocks"], res["launches"], res["stats"]))


def contract_cases(model, params):
    """The request contract on the card, at small cost: a deadline and a
    cancel behind a full batch, shed and degrade on an engine that
    nothing drains, and stop; no block leaks after any."""
    out = {}
    eng = ServingEngine(model, params, max_batch=8, n_blocks=512)
    eng.start()
    rng = np.random.RandomState(4)
    full = [eng.submit(rng.randint(0, model.vocab_size, size=64).tolist())
            for _ in range(8)]
    t0 = time.perf_counter()
    while not all(r.tokens for r in full):   # the batch is full
        if time.perf_counter() - t0 > 60:
            raise SystemExit("the contract batch was not admitted")
        time.sleep(0.0005)
    late = eng.submit([1, 2, 3], deadline_ms=1)
    queued = eng.submit([4, 5, 6])
    queued.cancel()
    for r, cls in ((late, "ServeDeadlineExceeded"),
                   (queued, "ServeCancelled")):
        try:
            r.result(timeout=60)
        except Exception as e:  # the typed error is the expected outcome
            out[cls] = type(e).__name__
        if out.get(cls) != cls:
            raise SystemExit("expected %s, got %s" % (cls, out.get(cls)))
    if not all(len(r.result(timeout=120)) == 32 for r in full):
        raise SystemExit("the full batch did not finish")
    eng.stop()
    out["deadline_cancel_stats"] = {k: eng.stats[k] for k in (
        "expired", "cancelled", "completed", "prefills")}
    leaks = [eng.leaked_blocks()]
    for policy in ("shed", "degrade"):
        eng = ServingEngine(model, params, max_batch=8, n_blocks=64,
                            queue_max=2, overload=policy)
        reqs = [eng.submit([7, 8]) for _ in range(2)]
        try:
            third = eng.submit([9])
        except Exception as e:  # shed must refuse the third submit
            third = e
        if policy == "shed" and type(third).__name__ != "ServeOverload":
            raise SystemExit("shed did not refuse the third submit")
        if policy == "degrade" and third.max_new_tokens != 8:
            raise SystemExit("degrade did not cap max_new_tokens at 8")
        if policy == "degrade":
            reqs.append(third)
        eng.stop()
        for r in reqs:
            try:
                r.result(timeout=5)
                got = None
            except Exception as e:  # stop resolves each one typed
                got = type(e).__name__
            if got != "ServeEngineDead":
                raise SystemExit("stop left a request %s" % got)
        out[policy] = {k: eng.stats[k] for k in ("shed", "degraded")}
        leaks.append(eng.leaked_blocks())
    out["leaked_blocks"] = leaks
    if any(leaks):
        raise SystemExit("the contract cases leaked blocks: %s" % leaks)
    log("contract: %s" % out)
    return out


def prefix_phase(model, params):
    """Phase 4b: the shared-prefix traffic through the default engine
    (prefix caching on), the same through ``prefix=False`` and through an
    engine whose pool must preempt, then the contract cases."""
    system, requests = prefix_traffic(model.vocab_size)
    res = {}
    runs = {}
    for label, kw in (("prefix on", {}), ("prefix off", {"prefix": False}),
                      ("prefix on, pool %d" % PRESSURE_BLOCKS,
                       {"n_blocks": PRESSURE_BLOCKS})):
        engine = ServingEngine(model, params, max_batch=8, **kw)
        engine.warmup()
        engine.start()
        reqs, r = serve_threaded(engine, requests)
        print_prefix(label, r)
        if r["leaked_blocks"]:
            raise SystemExit("%s leaked %d blocks" % (label,
                                                      r["leaked_blocks"]))
        if r["launches"]["layer_norm"] == 0:
            raise SystemExit("%s launched no LayerNorm kernel" % label)
        runs[label] = reqs
        res[label] = r
        del engine
        torch.cuda.empty_cache()
    on, off, tight = (res[k] for k in res)
    son, soff, stight = on["stats"], off["stats"], tight["stats"]
    n = len(requests) - 1
    checks = {
        "prefix_hits >= 15": son["prefix_hits"] >= n,
        "prefix_tokens = 15 x 512": son["prefix_tokens"] == n * SYSTEM_LEN,
        "prefix_bootstraps >= 1": son["prefix_bootstraps"] >= 1,
        "cow_copies >= 1": son["cow_copies"] >= 1,
        "prefill_tokens saved = 15 x 512": bool(
            son["preemptions"] or soff["preemptions"]
            or soff["prefill_tokens"] - son["prefill_tokens"]
            == n * SYSTEM_LEN),
        "pressure preempts": stight["preemptions"] > 0}
    log("shared prefix checks: %s; pressure engine: preemptions %d, stalls "
        "%d, thrash_trips %d, prefix_evictions %d, cow_copies %d, "
        "blocks_free_min %d"
        % (checks, stight["preemptions"], stight["stalls"],
           stight["thrash_trips"], stight["prefix_evictions"],
           stight["cow_copies"], stight["blocks_free_min"]))
    if not all(checks.values()):
        raise SystemExit("shared prefix checks failed: %s" % checks)
    labels = list(runs)
    res["parted_off"] = same_tokens("prefix off vs on", model, params,
                                    requests, runs[labels[0]],
                                    runs[labels[1]])
    res["parted_pressure"] = same_tokens("pressure vs roomy", model, params,
                                         requests, runs[labels[0]],
                                         runs[labels[2]])
    res["checks"] = checks
    res["contract"] = contract_cases(model, params)
    return res


def profiled(fn):
    """Run ``fn`` under `torch.profiler` and return the window's wall
    seconds, its device busy seconds (the sum of kernel and copy times),
    the device ops by name ``[(name, count, total ms)]`` largest first,
    and the host ops with the most self time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    device = sorted(((k[:60], n, us / 1e3) for k, (n, us) in
                     by_name.items()), key=lambda t: -t[2])
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host = [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in host[:10]]
    busy = sum(t[2] for t in device) / 1e3
    return wall, busy, device, host


def kernel_ms(device, name):
    """Total device ms of the ops whose name contains ``name``."""
    return sum(ms for k, _, ms in device if name in k)


def ce_mode_ms(device):
    """Device ms of the fused CE kernels by mode (A, B, C, D), from the
    template's first argument in each kernel's name."""
    out = {}
    for k, _, ms in device:
        m = re.search(r"fused_ce_(?:\w+_)?kernel<(\d)", k)
        if m:
            mode = "ABCD"[int(m.group(1))]
            out[mode] = out.get(mode, 0.0) + ms
    return out


def decode_profile(engine, model, steps=10):
    """Profile ``steps`` decode iterations of a full batch of 8 on the
    paged engine: wall time per step, device busy time, kernel launches
    per step, the device ops that take the most time and the host-side
    ops that cost most."""
    rng = np.random.RandomState(2)
    for _ in range(8):
        engine.submit(rng.randint(0, model.vocab_size, size=64).tolist(),
                      max_new_tokens=2 * steps + 4)
    for _ in range(4):
        engine.step()
    if len(engine._active) != 8:
        raise SystemExit("the profiled batch did not fill")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def run():
        for _ in range(steps):
            engine.step()
    wall_profiled, busy, device, host = profiled(run)
    engine.run_until_idle(timeout=120)
    n_dev = sum(n for _, n, _ in device)
    res = {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
           "profiled_wall_ms_per_step": 1e3 * wall_profiled / steps,
           "device_busy_ms_per_step": 1e3 * busy / steps,
           # the profiler slows the host; the idle share is of its window
           "device_idle_share": 1 - busy / wall_profiled if busy else None,
           "device_ops_per_step": n_dev / steps,
           "layer_norm_kernel_ms_per_step":
               kernel_ms(device, "ln_fwd_kernel") / steps,
           "top_device_ops_ms": device[:8], "top_host_ops_ms": host}
    log("decode profile (batch 8, %d steps): %.3f ms/step wall (%.3f under "
        "the profiler), device busy %.3f ms/step (idle share %s), %.1f "
        "device ops/step, LayerNorm kernel %.4f ms/step; top device ops "
        "(name, count, ms): %s; top host ops (name, calls, self cpu ms): %s"
        % (steps, res["wall_ms_per_step"], res["profiled_wall_ms_per_step"],
           res["device_busy_ms_per_step"],
           "not measured" if res["device_idle_share"] is None
           else "%.3f" % res["device_idle_share"],
           res["device_ops_per_step"],
           res["layer_norm_kernel_ms_per_step"], device[:8], host))
    return res


def prefill_profile(engine, model, n=1000):
    """Profile one slot-cache admission of an ``n``-token prompt (the
    1024 bucket's prefill and the first token): wall time, device busy
    time and the share of the flash and LayerNorm kernels in it."""
    rng = np.random.RandomState(3)
    req = engine.submit(rng.randint(0, model.vocab_size, size=n).tolist(),
                        max_new_tokens=1)
    wall, busy, device, host = profiled(engine.step)
    if not req.done:
        raise SystemExit("the profiled prefill did not finish")
    res = {"prompt": n, "wall_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy,
           "flash_kernel_ms": kernel_ms(device, "flash_fwd_"),
           "layer_norm_kernel_ms": kernel_ms(device, "ln_fwd_kernel"),
           "top_device_ops_ms": device[:8], "top_host_ops_ms": host}
    log("prefill profile (slot engine, prompt %d): %.3f ms wall, device "
        "busy %.3f ms, flash kernel %.3f ms, LayerNorm kernel %.3f ms; top "
        "device ops (name, count, ms): %s"
        % (n, res["wall_ms"], res["device_busy_ms"], res["flash_kernel_ms"],
           res["layer_norm_kernel_ms"], device[:8]))
    return res


# -- phases 6 to 8: the training path --------------------------------------

# `tools/benchmark_transformer.py`'s defaults: vocab 32768, context 1024,
# 12 layers, embed 768, batch 32
TRAIN = dict(vocab_size=32768, seq_len=1024, num_layers=12, num_embed=768)
TRAIN_BATCH = 32
# the GPT-2-small parity configuration: 12 heads of 64, biases on, dense
# head, head-split ('bhsd') attention
PARITY = dict(TRAIN, num_heads=12, use_bias=True, attn_layout="bhsd")
# bench.py's tpu_geom_fast_ configuration: 6 heads of 128, no biases,
# transposeless ('bsd') attention
GEOM_FAST = dict(TRAIN, num_heads=6, use_bias=False, attn_layout="bsd")
# bench.py's fused_ configuration (`TBENCH_FUSED_HEAD=1`): the parity
# configuration with the fused CE head; its Adam keeps v in bf16 with
# stochastic rounding (`tools/benchmark_transformer.py:76`)
FUSED = dict(PARITY, fused_head=True)
FUSED_TRAINER = dict(adam_v_dtype="bfloat16")
# scripts/diag_round5.py's stage_longctx (`_make_lm_trainer(H=6, S, B)`,
# :73-101 and :393-403): 12 layers, embed 768, 6 heads of 128, vocab
# 32768, biases, dense head; bf16, Adam lr 1e-3 wd 0, v in bf16 (the
# ``FUSED_TRAINER`` keyword); S=4096 B=8 through the dS route ('bhsd'
# under MXNET_FLASH_LAYOUT=ds) and S=8192 B=4 through the grid-streamed
# route ('bsd' under MXNET_FLASH_BSD_KERNEL=stream): 32768 tokens a step,
# as the parity configuration
LONGCTX_DS = dict(TRAIN, seq_len=4096, num_heads=6, use_bias=True,
                  attn_layout="bhsd")
LONGCTX_DS_BATCH = 8
LONGCTX_STREAM = dict(LONGCTX_DS, seq_len=8192, attn_layout="bsd")
LONGCTX_STREAM_BATCH = 4
# the fused head at GPT-2 medium's published widths (vocab 50257, context
# 1024, embed 1024, 16 heads of 64, biases), cut to 2 of its 24 layers:
# the width the CE kernels refused before
MEDIUM_FUSED = dict(vocab_size=50257, seq_len=1024, num_layers=2,
                    num_embed=1024, num_heads=16, use_bias=True,
                    attn_layout="bhsd", fused_head=True)
MEDIUM_BATCH = 4


def lm_trainer(cfg, batch, dtype, seed=0, **kw):
    """`SPMDTrainer` over `get_transformer_lm(**cfg)` as the benchmark
    builds it: Adam at lr 1e-3, wd 0, on the card, from `random.seed`."""
    mx.random.seed(seed)
    net = mx.models.get_transformer_lm(**cfg)
    shape = (batch, cfg["seq_len"])
    return mx.SPMDTrainer(net, data_shapes={"data": shape,
                                            "softmax_label": shape},
                          optimizer="adam", lr=1e-3, wd=0.0, dtype=dtype,
                          **kw)


def lm_batch(batch, cfg):
    """The benchmark's batch: tokens and next-token labels from
    `RandomState(0)`."""
    rng = np.random.RandomState(0)
    shape = (batch, cfg["seq_len"])
    return {"data": rng.randint(0, cfg["vocab_size"], shape).astype(np.int32),
            "softmax_label": rng.randint(0, cfg["vocab_size"],
                                         shape).astype(np.float32)}


def mean_nll(out, labels):
    """Mean negative log-likelihood of the labels: under the softmax
    head's output rows, or the fused head's per-token NLL itself."""
    if out.dim() == 1:
        return float(out.float().mean())
    p = out.gather(1, labels.reshape(-1, 1).long()).float()
    return float(-torch.log(p).mean())


def flops_per_token(cfg):
    """`tools/benchmark_transformer.py`'s count: 6 per matmul parameter
    (the embedding lookup is a gather, not a matmul) plus causal
    attention's 12 * L * D * S / 2."""
    l, d = cfg["num_layers"], cfg["num_embed"]
    f = cfg.get("num_ffn_hidden") or 4 * d
    n_matmul = l * (4 * d * d + 2 * d * f) + d * cfg["vocab_size"]
    return 6 * n_matmul + 12 * l * d * cfg["seq_len"] // 2


def train_path(label, cfg, steps, expect, trainer_kw=None, falls=True,
               after=None, batch=TRAIN_BATCH, pins=None, dtype="bfloat16"):
    """Train ``cfg`` at full width, in ``dtype`` (bf16 unless given), at
    ``batch`` (32 unless given) under the ``MXNET_*`` ``pins`` (set for
    the path and restored after): ``steps`` steps (the first a warm-up,
    left out of the timing) with the counts set to 0 before and read
    after, then one profiled step.  ``expect`` maps each counter to the
    launches it must show per step (every other counter must show none);
    ``falls`` asks for the last loss below the first.  ``after(trainer,
    batch)`` runs last, on the trained model, and its result joins the
    record."""
    with pinned(**(pins or {})):
        trainer = lm_trainer(cfg, batch, dtype, **(trainer_kw or {}))
        dev = trainer.shard_batch(lm_batch(batch, cfg))
        labels = dev["softmax_label"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_ms, wall_ms = [], [], []
        for _ in range(steps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            outs = trainer.step(dev)
            b.record()
            b.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            step_ms.append(a.elapsed_time(b))
            losses.append(mean_nll(outs[0], labels))
            del outs
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        state = card_state()
        wall, busy, device, host = profiled(lambda: trainer.step(dev))
        extra = after(trainer, dev) if after else {}
        del trainer, dev, labels
        torch.cuda.empty_cache()

        timed = step_ms[1:]
        step = statistics.median(timed)
        tokens = batch * cfg["seq_len"]
        fpt = flops_per_token(cfg)
        res = {
            "config": cfg, "batch": batch, "dtype": dtype,
            "optimizer": "adam lr 1e-3 wd 0", "trainer_kw": trainer_kw or {},
            "pins": pins or {}, "steps": steps,
            "losses": losses, "step_ms": step_ms, "wall_ms": wall_ms,
            "step_ms_median": step, "tokens_per_s": tokens / (step / 1e3),
            "flops_per_token": fpt,
            "mfu": fpt * tokens / (step / 1e3) / MFU_PEAK,
            "launches": launches,
            "launches_per_step": {k: n / steps for k, n in launches.items()},
            "max_memory_allocated": peak, "card_after": state,
            "profiled_step_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy,
            "device_idle_share": 1 - busy / wall,
            "kernel_ms": {k: kernel_ms(device, k) for k in (
                "ln_fwd_kernel", "ln_bwd_kernel", "ln_bwd_reduce_kernel",
                "flash_fwd_tf32_kernel", "flash_fwd_mma_kernel",
                "flash_bwd_dq_tf32_kernel", "flash_bwd_dkv_tf32_kernel",
                "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel",
                "flash_fwd_wide_kernel", "flash_bwd_dq_wide_kernel",
                "flash_bwd_dkv_wide_kernel", "flash_fwd_wide_tf32_kernel",
                "flash_bwd_dq_wide_tf32_kernel",
                "flash_bwd_dkv_wide_tf32_kernel",
                "fused_ce_kernel", "fused_ce_mma_kernel",
                "fused_ce_tf32_kernel")},
            "ce_mode_ms": ce_mode_ms(device),
            "top_device_ops_ms": device[:10], "top_host_ops_ms": host}
        res.update(extra)
        log("%s: %d steps of batch %d x %d tokens, %s, Adam; step ms (CUDA "
            "events) %s; median of the last %d %.2f ms = %.1f tokens/s, MFU "
            "%.4f (%.4g flops/token over the %.0f TFLOP/s dense bf16 peak); "
            "host wall ms %s"
            % (label, steps, batch, cfg["seq_len"], dtype,
               ["%.2f" % t for t in step_ms], len(timed), step,
               res["tokens_per_s"], res["mfu"], fpt, MFU_PEAK / 1e12,
               ["%.1f" % t for t in wall_ms]))
        log("%s: mean NLL per step %s" % (label, ["%.4f" % x for x in losses]))
        log("%s: launches per step %s; max_memory_allocated %d B; card after "
            "(sm clock, mem clock, power, temp): %s"
            % (label, {k: v for k, v in res["launches_per_step"].items() if v},
               peak, state))
        log("%s: profiled step %.2f ms wall, device busy %.2f ms (idle share "
            "%.4f); kernel ms %s; fused CE kernel ms by mode %s; top device "
            "ops (name, count, ms): %s"
            % (label, res["profiled_step_ms"], res["device_busy_ms"],
               res["device_idle_share"],
               {k: round(v, 3) for k, v in res["kernel_ms"].items()},
               res["ce_mode_ms"], device[:10]))
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit("%s: a loss is not finite: %s" % (label, losses))
        if falls and not losses[-1] < losses[0]:
            raise SystemExit("%s: the loss did not fall: %s" % (label, losses))
        off = {k: n for k, n in launches.items()
               if n != expect.get(k, 0) * steps}
        if off:
            raise SystemExit("%s: launches %s in %d steps, expected %s a step"
                             % (label, off, steps, expect))
        return res


def grad_check(cfg, required, label="parity config", size=2, pins=None):
    """One step's float32 gradients of ``cfg`` at batch ``size`` through the
    kernels, under the ``MXNET_*`` ``pins``, against the same step through
    their plain versions, and the bf16 kernel path's distance from the
    same reference.  Each counter of ``required`` must show a launch."""
    with pinned(**(pins or {})):
        batch = lm_batch(size, cfg)
        trainer = lm_trainer(cfg, size, "float32")
        reset_counts()
        got = trainer.gradients(batch)
        launched = read_counts()
        with plain_kernels():
            reset_counts()
            ref = trainer.gradients(batch)
            if any(read_counts().values()):
                raise SystemExit("the plain path launched a kernel")
        trainer16 = lm_trainer(cfg, size, "bfloat16")
        mx.load_params(trainer16, *trainer.get_params())
        got16 = trainer16.gradients(batch)
        del trainer, trainer16
        gmax = max(float(g.abs().max()) for g in ref.values())

        def worst(grads):
            out = {}
            for n, r in ref.items():
                scale = gmax if n.endswith("_k_bias") else \
                    max(float(r.abs().max()), 1e-30)
                out[n] = float((grads[n].float() - r).abs().max()) / scale
            return out

        f32, bf16 = worst(got), worst(got16)
        name32 = max(f32, key=f32.get)
        res = {"config": label, "batch": size, "params": len(ref),
               "max_abs_grad": gmax,
               "worst_f32": f32[name32], "worst_f32_param": name32,
               "worst_bf16": max(bf16.values()), "tol": GRAD_TOL,
               "launches": launched, "per_param_f32": f32}
        log("gradients (%s, batch %d, %d parameters): f32 kernel path vs "
            "plain max |dg|/max |g| %.3e at %s (tol %.0e); bf16 kernel path "
            "%.3e; kernel launches %s"
            % (label, size, len(ref), res["worst_f32"], name32, GRAD_TOL,
               res["worst_bf16"], {k: v for k, v in launched.items() if v}))
        if not res["worst_f32"] <= GRAD_TOL:
            raise SystemExit("gradients through the kernels disagree with the "
                             "plain path")
        if not res["worst_bf16"] > GRAD_TOL:
            raise SystemExit("gradient tolerance does not separate bf16 "
                             "from f32")
        for k in required:
            if not launched[k]:
                raise SystemExit("the gradient step launched no %s kernel" % k)
        return res


# the fused CE kernels: counters and their launches per training step
CE_COUNTERS = ("fused_ce_fwd", "fused_ce_fwd_sp", "fused_ce_bwd_dw",
               "fused_ce_bwd_dx")


def rounding_cost(trainer):
    """The bf16 second moment's stochastic rounding alone: one
    `_store_v_bf16` over every parameter's float32 v (copies made first;
    rounding a bf16 value again leaves it as it is), as device ms (CUDA
    events) and host wall ms to the end of its work."""
    v32 = [t.float() for t in trainer._adam_v]
    dev_ms = time_auto(lambda: trainer._store_v_bf16(v32), budget_ms=2000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._store_v_bf16(v32)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    n = sum(t.numel() for t in v32)
    return {"elements": n, "device_ms": dev_ms, "wall_ms": wall_ms,
            "groups": len({tuple(t.shape) for t in v32})}


def forward_check(trainer, dev):
    """One `SPMDTrainer.forward` (no gradient, labels zeros): the fused
    head runs the statistics kernel alone."""
    torch.cuda.synchronize()
    reset_counts()
    out = trainer.forward({"data": dev["data"]})[0]
    torch.cuda.synchronize()
    launched = read_counts()
    tokens = TRAIN_BATCH * TRAIN["seq_len"]
    ok = tuple(out.shape) == (tokens,) and bool(torch.isfinite(out).all())
    want = {k: 0 for k in CE_COUNTERS}
    want["fused_ce_fwd"] = 1
    log("forward (fused config, no gradient): output %s finite %s, launches "
        "%s" % (tuple(out.shape), ok, {k: v for k, v in launched.items()
                                       if v}))
    if not ok:
        raise SystemExit("forward: the fused head's NLL is not finite or "
                         "not one per token")
    off = {k: launched[k] for k in want if launched[k] != want[k]}
    if off or not launched["layer_norm"]:
        raise SystemExit("forward: launches %s, expected %s and LayerNorm"
                         % (launched, want))
    return {"launches": launched, "shape": list(out.shape)}


def fused_extras(trainer, dev):
    res = {"rounding": rounding_cost(trainer),
           "forward": forward_check(trainer, dev)}
    log("bf16 second moment's stochastic rounding: %s" % res["rounding"])
    return res


def five_pass_path(expect, dtype="bfloat16", after=None):
    """2 steps of the fused configuration in the 5-pass structure,
    ``MXNET_CE_SINGLE_PASS=0`` set for them and restored after; in bf16
    with `FUSED_TRAINER`'s bf16 v, in float32 with the trainer's default
    float32 v."""
    bf16 = dtype == "bfloat16"
    return train_path("train fused, 5-pass" + ("" if bf16 else " f32"),
                      FUSED, 2, expect, FUSED_TRAINER if bf16 else None,
                      falls=False, pins={"MXNET_CE_SINGLE_PASS": "0"},
                      dtype=dtype, after=after)


# --- the reference training API (phases 13 and 14) -------------------------

# BASELINE.json's first configuration, `examples/train_mnist.py`: the MLP
# (784-128-64-10) on MNIST at batch 128, SGD lr 0.1 momentum 0.9, Xavier,
# 2 epochs, on idx files `tools/make_mnist.py` writes (20000 train, 4000
# test; no network here, so rendered digits in place of MNIST's)
MNIST = dict(train=20000, test=4000, batch=128, epochs=2, lr=0.1,
             momentum=0.9)
# its bars, the card against the CPU: max |dw| over max |w| after the
# first 10 batches and after the first epoch (float32 on both, cuBLAS and
# the CPU's GEMM summing in another order: ~1e-7 after 10 batches, ~5e-7
# after 157; TF32 stays off), and the validation accuracy after the first
# epoch within MNIST_ACC_TOL.  In the second epoch two runs part in one
# batch where a ReLU input within rounding of zero lands on either side
# of it (the JAX package's runs too: `scripts/mnist_spread.py`), and CPU
# runs that differ only in their thread count end as far apart as the
# card and the CPU.  So the end of training is held to what rounding
# alone does in the same call: the CPU run on 1, 2 and 4 threads beside
# the one on all, and the card's final train and validation accuracy
# within the larger of MNIST_ACC_TOL and MNIST_SPREAD_MULT times the
# spread (max - min) over those CPU runs of the all-threads run's
MNIST_PARAM_TOL = 1e-4
MNIST_ACC_TOL = 0.01
MNIST_SPREAD_THREADS = (1, 2, 4)
MNIST_SPREAD_MULT = 2.0
# the LM through `simple_bind`: the parity configuration in float32 at
# batch 8, Adam lr 1e-3 through `get_fused_updater`
API_LM_BATCH = 8


def mnist_fit(mx_ctx, files, epochs, epoch_size=None):
    """`README.md`'s quickstart on the MNIST files: FeedForward(get_mlp())
    fit on `MNISTIter` with the validation iterator.  Returns the model,
    the wall seconds of each batch (in the callback, after the batch's
    metric update read its outputs back), the train and validation
    metric at each epoch's end, the parameters after each epoch and the
    validation iterator."""
    mx.random.seed(0)
    train = mx.io.MNISTIter(image=files["train-images"],
                            label=files["train-labels"],
                            batch_size=MNIST["batch"], flat=True)
    val = mx.io.MNISTIter(image=files["t10k-images"],
                          label=files["t10k-labels"],
                          batch_size=MNIST["batch"], flat=True,
                          shuffle=False)
    model = mx.model.FeedForward(
        mx.models.get_mlp(), ctx=mx_ctx, num_epoch=epochs,
        epoch_size=epoch_size, optimizer="sgd", learning_rate=MNIST["lr"],
        momentum=MNIST["momentum"], initializer=mx.init.Xavier())
    ticks, train_acc, val_acc, snaps = [time.perf_counter()], {}, {}, []

    def on_batch(p):
        ticks.append(time.perf_counter())
        train_acc[p.epoch] = p.eval_metric.get()[1]

    def on_eval(p):
        val_acc[p.epoch] = p.eval_metric.get()[1]

    def on_epoch(epoch, sym, arg, aux):
        snaps.append({k: v.asnumpy() for k, v in arg.items()})

    model.fit(train, eval_data=None if epoch_size else val,
              batch_end_callback=on_batch, eval_batch_end_callback=on_eval,
              epoch_end_callback=on_epoch)
    return model, np.diff(ticks), train_acc, val_acc, snaps, val


def _param_gap(a, b):
    """max |a - b| over max |b|, over every parameter."""
    wmax = max(float(np.abs(w).max()) for w in b.values())
    return max(float(np.abs(a[k] - w).max()) for k, w in b.items()) / wmax


def mnist_api_path():
    """The MLP on MNIST through `FeedForward` on the card: 2 epochs timed,
    held against the same run on the CPU; the checkpoint saved from the
    card loads on the CPU and saves the same bytes again."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "tools/make_mnist.py", "--out", tmp,
                        "--train", str(MNIST["train"]), "--test",
                        str(MNIST["test"])], check=True, capture_output=True)
        made_s = time.perf_counter() - t0
        files = {k: os.path.join(tmp, "%s-idx%d-ubyte"
                                 % (k, 3 if k.endswith("images") else 1))
                 for k in ("train-images", "train-labels", "t10k-images",
                           "t10k-labels")}
        # the first 10 batches on each device
        first = [mnist_fit(c, files, 1, epoch_size=10)[4][0]
                 for c in (mx.gpu(0), mx.cpu())]
        gap_10 = _param_gap(*first)
        # 2 epochs on the card, counts and peak memory from 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        gpu, batch_s, train_acc, val_acc, snaps, val = mnist_fit(
            mx.gpu(0), files, MNIST["epochs"])
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        state = card_state()
        cpu_model, _, cpu_train, cpu_val, cpu_snaps, cpu_val_iter = \
            mnist_fit(mx.cpu(), files, MNIST["epochs"])
        gaps = [_param_gap(a, b) for a, b in zip(snaps, cpu_snaps)]
        acc_gpu = gpu.score(val)
        acc_cpu = cpu_model.score(cpu_val_iter)
        # the same CPU run on fewer threads: how far apart rounding alone
        # puts runs of this configuration by its end
        threads = torch.get_num_threads()
        spread_runs = {}
        try:
            for n in MNIST_SPREAD_THREADS:
                if n == threads:
                    continue
                torch.set_num_threads(n)
                run = mnist_fit(mx.cpu(), files, MNIST["epochs"])
                spread_runs[n] = {
                    "val_acc": run[0].score(run[5]),
                    "train_acc": run[2][MNIST["epochs"] - 1],
                    "param_gap_by_epoch": [_param_gap(a, b) for a, b in
                                           zip(run[4], cpu_snaps)]}
        finally:
            torch.set_num_threads(threads)
        last = MNIST["epochs"] - 1
        cpu_vals = [acc_cpu] + [r["val_acc"] for r in spread_runs.values()]
        cpu_trains = [cpu_train[last]] + [r["train_acc"]
                                          for r in spread_runs.values()]
        val_bar = max(MNIST_ACC_TOL,
                      MNIST_SPREAD_MULT * (max(cpu_vals) - min(cpu_vals)))
        train_bar = max(MNIST_ACC_TOL, MNIST_SPREAD_MULT
                        * (max(cpu_trains) - min(cpu_trains)))
        # the checkpoint from the card, loaded on the CPU
        prefix = os.path.join(tmp, "mlp")
        gpu.save(prefix)
        back = mx.model.FeedForward.load(prefix, MNIST["epochs"],
                                         ctx=mx.cpu())
        mx.model.save_checkpoint(prefix + "-again", MNIST["epochs"],
                                 back.symbol, back.arg_params,
                                 back.aux_params)
        name = "-%04d.params" % MNIST["epochs"]
        same_bytes = Path(prefix + name).read_bytes() == \
            Path(prefix + "-again" + name).read_bytes()
        on_cpu = all(v.context == mx.cpu() for v in back.arg_params.values())
        val.reset()
        pred_gap = float(np.abs(back.predict(val) - gpu.predict(val)).max())
        acc_loaded = back.score(val)
    # steady state: the batches after each epoch's first
    per_epoch = len(batch_s) // MNIST["epochs"]
    steady = [t for i, t in enumerate(batch_s) if i % per_epoch]
    ms = 1e3 * statistics.median(steady)
    res = {"config": dict(MNIST, net="get_mlp() 784-128-64-10",
                          source="BASELINE.json configs[0]; README.md:19-41"),
           "mnist_files_s": made_s, "fit_s": fit_s,
           "batches": len(batch_s), "ms_per_batch_median": ms,
           "images_per_s": MNIST["batch"] / (ms / 1e3),
           "train_acc_by_epoch": train_acc, "val_acc_by_epoch": val_acc,
           "cpu_train_acc_by_epoch": cpu_train,
           "cpu_val_acc_by_epoch": cpu_val, "val_acc": acc_gpu,
           "val_acc_cpu_run": acc_cpu, "val_acc_card_model_on_cpu":
           acc_loaded, "param_gap_10_batches": gap_10,
           "param_gap_by_epoch": gaps, "param_tol": MNIST_PARAM_TOL,
           "cpu_threads": threads, "cpu_runs_by_threads": spread_runs,
           "acc_tol": MNIST_ACC_TOL, "spread_mult": MNIST_SPREAD_MULT,
           "final_val_bar": val_bar, "final_train_bar": train_bar,
           "checkpoint_same_bytes_on_cpu": same_bytes,
           "checkpoint_loaded_on_cpu": on_cpu,
           "predict_gap_card_vs_cpu_load": pred_gap,
           "launches": launches, "max_memory_allocated": peak,
           "card_after": state}
    log("api mnist: FeedForward(get_mlp()) on the card, %d batches of %d in "
        "%.2f s: median %.3f ms a batch (host clock, metric read each "
        "batch) = %.1f images/s; train acc by epoch %s, validation %s (CPU "
        "run %s, %s); card vs CPU max|dw|/max|w| after 10 batches %.3e, "
        "after each epoch %s (tol %.0e after 10 batches and epoch 1); "
        "final validation acc %.4f on the card, %.4f in the CPU run, %.4f "
        "for the card's model loaded on the CPU; the CPU run on other "
        "thread counts than %d (threads: final validation acc, final "
        "train acc, max|dw|/max|w| by epoch) %s; final bars: validation "
        "%.4f, train %.4f; checkpoint loads on the "
        "CPU (%s) and saves the same bytes (%s), predictions within %.2e; "
        "max_memory_allocated %d B; launches %s; card after %s; idx files "
        "made in %.2f s"
        % (len(batch_s), MNIST["batch"], fit_s, ms, res["images_per_s"],
           train_acc, val_acc, cpu_train, cpu_val, gap_10,
           ["%.3e" % g for g in gaps], MNIST_PARAM_TOL, acc_gpu, acc_cpu,
           acc_loaded, threads,
           {n: ("%.4f" % r["val_acc"], "%.4f" % r["train_acc"],
                ["%.3e" % g for g in r["param_gap_by_epoch"]])
            for n, r in spread_runs.items()}, val_bar, train_bar, on_cpu, same_bytes, pred_gap, peak,
           {k: v for k, v in launches.items() if v}, state, made_s))
    if not (gap_10 <= MNIST_PARAM_TOL and gaps[0] <= MNIST_PARAM_TOL):
        raise SystemExit("api mnist: the card's parameters disagree with the "
                         "CPU's")
    if not abs(val_acc[0] - cpu_val[0]) <= MNIST_ACC_TOL:
        raise SystemExit("api mnist: validation accuracy after epoch 1 %.4f "
                         "on the card, %.4f on the CPU"
                         % (val_acc[0], cpu_val[0]))
    if not (abs(acc_gpu - acc_cpu) <= val_bar and
            abs(train_acc[last] - cpu_train[last]) <= train_bar):
        raise SystemExit("api mnist: final accuracy on the card (validation "
                         "%.4f, train %.4f) beyond what rounding alone moves "
                         "on the CPU (%.4f, %.4f; bars %.4f, %.4f)"
                         % (acc_gpu, train_acc[last], acc_cpu,
                            cpu_train[last], val_bar, train_bar))
    if not (same_bytes and on_cpu and pred_gap < 1e-4 and
            abs(acc_loaded - acc_gpu) <= MNIST_ACC_TOL):
        raise SystemExit("api mnist: the card's checkpoint does not load on "
                         "the CPU as saved")
    if any(launches.values()):
        raise SystemExit("api mnist: the MLP launched a kernel of the table")
    if not min(acc_gpu, acc_cpu) > 0.5:
        raise SystemExit("api mnist: validation accuracy %.4f / %.4f, not "
                         "learning" % (acc_gpu, acc_cpu))
    return res


def api_lm_path(expect, steps=6):
    """The parity configuration in float32 through `simple_bind`: step 1's
    gradients held against `SPMDTrainer(dtype='float32')` on the same
    parameters and batch, then ``steps`` steps of forward, backward and
    Adam through `get_fused_updater`, each with exact launches, and the
    trainer's own steps at the same batch for comparison (the median of
    steps 2 on; the first allocates the optimizer state)."""
    cfg, batch = PARITY, API_LM_BATCH
    shapes = {"data": (batch, cfg["seq_len"]),
              "softmax_label": (batch, cfg["seq_len"])}
    mx.random.seed(0)
    net = mx.models.get_transformer_lm(**cfg)
    exe = net.simple_bind(mx.gpu(0), grad_req="write", **shapes)
    init = mx.init.Uniform(0.07)
    names = [n for n in net.list_arguments() if n not in shapes]
    for n in names:
        init(n, exe.arg_dict[n])
    host = lm_batch(batch, cfg)
    labels = torch.as_tensor(host["softmax_label"]).cuda()

    # the trainer on the same parameters and batch
    trainer = lm_trainer(cfg, batch, "float32")
    mx.load_params(trainer, {n: exe.arg_dict[n].data for n in names})
    ref = trainer.gradients(host)
    dev = trainer.shard_batch(host)
    trainer_ms = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        trainer.step(dev)
        b.record()
        b.synchronize()
        trainer_ms.append(a.elapsed_time(b))
    t_wall, t_busy, _, _ = profiled(lambda: trainer.step(dev))
    del trainer, dev
    torch.cuda.empty_cache()

    updater = mx.optimizer.get_fused_updater(
        mx.optimizer.Adam(learning_rate=1e-3, rescale_grad=1.0 / batch))
    idx = [net.list_arguments().index(n) for n in names]
    weights = [exe.arg_arrays[i] for i in idx]
    grads = [exe.grad_arrays[i] for i in idx]

    def step():
        outs = exe.forward(is_train=True, data=host["data"],
                           softmax_label=host["softmax_label"])
        exe.backward()
        updater(list(range(len(idx))), grads, weights)
        return outs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, wall_ms, per_step = [], [], [], []
    got = None
    for i in range(steps):
        reset_counts()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        if i == 0:
            # step 1's gradients, before the update
            outs = exe.forward(is_train=True, data=host["data"],
                               softmax_label=host["softmax_label"])
            exe.backward()
            got = {n: exe.grad_dict[n].data.clone() for n in names}
            updater(list(range(len(idx))), grads, weights)
        else:
            outs = step()
        b.record()
        b.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        step_ms.append(a.elapsed_time(b))
        per_step.append(read_counts())
        losses.append(mean_nll(outs[0].data, labels))
    peak = torch.cuda.max_memory_allocated()
    state = card_state()
    wall, busy, device, _ = profiled(step)
    gmax = max(float(g.abs().max()) for g in ref.values())
    worst = {}
    for n, r in ref.items():
        scale = gmax if n.endswith("_k_bias") else \
            max(float(r.abs().max()), 1e-30)
        worst[n] = float((got[n] - r).abs().max()) / scale
    name = max(worst, key=worst.get)
    del exe, got, ref, outs
    torch.cuda.empty_cache()

    ms = statistics.median(step_ms[1:])
    tms = statistics.median(trainer_ms[1:])
    tokens = batch * cfg["seq_len"]
    launches = {k: sum(s[k] for s in per_step) for k in per_step[0]}
    res = {"config": cfg, "batch": batch, "dtype": "float32",
           "optimizer": "Adam lr 1e-3 (get_fused_updater)",
           "losses": losses, "step_ms": step_ms, "wall_ms": wall_ms,
           "step_ms_median": ms, "tokens_per_s": tokens / (ms / 1e3),
           "trainer_step_ms": trainer_ms, "trainer_step_ms_median": tms,
           "executor_over_trainer": ms / tms,
           "profiled_step_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy,
           "device_idle_share": 1 - busy / wall,
           "trainer_profiled_step_ms": 1e3 * t_wall,
           "trainer_device_busy_ms": 1e3 * t_busy,
           "trainer_device_idle_share": 1 - t_busy / t_wall,
           "grad_worst": worst[name], "grad_worst_param": name,
           "grad_tol": GRAD_TOL, "launches": launches,
           "launches_by_step": per_step, "max_memory_allocated": peak,
           "card_after": state, "top_device_ops_ms": device[:10]}
    log("api lm: simple_bind of the parity configuration, float32, batch "
        "%d, Adam through get_fused_updater: step ms (CUDA events) %s, "
        "median of the last %d %.2f ms = %.1f tokens/s (SPMDTrainer f32 at "
        "the same batch %s, median %.2f ms: ratio %.3f); profiled step "
        "%.2f ms wall, device busy %.2f ms (idle share %.4f; trainer's "
        "%.4f); mean NLL per step %s; step 1 gradients vs SPMDTrainer max "
        "|dg|/max |g| %.3e at %s (tol %.0e); launches per step %s; "
        "max_memory_allocated %d B; card after %s"
        % (batch, ["%.2f" % t for t in step_ms], steps - 1, ms,
           res["tokens_per_s"], ["%.2f" % t for t in trainer_ms], tms,
           ms / tms, res["profiled_step_ms"], res["device_busy_ms"],
           res["device_idle_share"], res["trainer_device_idle_share"],
           ["%.4f" % x for x in losses], worst[name], name, GRAD_TOL,
           [{k: v for k, v in s.items() if v} for s in per_step], peak,
           state))
    if not worst[name] <= GRAD_TOL:
        raise SystemExit("api lm: the executor's gradients disagree with "
                         "SPMDTrainer's")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise SystemExit("api lm: the loss is not finite or did not fall: "
                         "%s" % losses)
    for i, counts in enumerate(per_step):
        off = {k: n for k, n in counts.items() if n != expect.get(k, 0)}
        if off:
            raise SystemExit("api lm: step %d launched %s, expected %s"
                             % (i + 1, off, expect))
    return res


# -- phase 19: the Module API ------------------------------------------------

# (a) and (c): the parity configuration in float32 at batch 8 through
# `mx.mod.Module`, Adam lr 1e-3, over 6 seeded batches; (b) the fused
# configuration in bf16 at batch 32 through `mx.mod.SPMDModule`, 5 batches
MODULE_BATCHES = 6
SPMD_MODULE_BATCHES = 5
MODULE_PINS = {"MXNET_DEVICE_PREFETCH": "2", "MXNET_METRIC_INTERVAL": "3"}
# (d) `examples/lstm_bucketing.py`'s defaults on its synthetic sentences
# (`data/ptb.train.txt` is not in the repo): buckets 8/16/24/32, 2 layers,
# hidden and embed 64, batch 32, Adam lr 0.01, `Xavier`, one epoch
LSTM_BUCKETS = (8, 16, 24, 32)
LSTM_BUCKET = dict(num_layers=2, num_hidden=64, num_embed=64, batch=32,
                   lr=0.01, sentences=400, vocab=64)
BUCKET_TOL = 1e-4


_WINDOW_OPEN, _WINDOW_CLOSE = "step_window_open", "step_window_close"


def _read_window(prof):
    """The profiled window between `_StepWatch`'s two marks: its length,
    the device's busy time (the union of its kernel and copy intervals
    clipped to the window, so a side stream's copy under a kernel counts
    once) and idle share, and the largest device and host items."""
    events = prof.events()
    marks = {e.name: e.time_range.start for e in events
             if e.name in (_WINDOW_OPEN, _WINDOW_CLOSE)}
    t0, t1 = marks[_WINDOW_OPEN], marks[_WINDOW_CLOSE]
    spans, by_name = [], {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if b <= a:
            continue
        spans.append((a, b))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (b - a))
    busy, end = 0.0, t0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = t1 - t0
    host = sorted(prof.key_averages(),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    return {"profiled_step_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / wall,
            "device_items": len(spans),
            "top_device_ops_ms": sorted(
                ((k[:60], n, us / 1e3) for k, (n, us) in by_name.items()),
                key=lambda t: -t[2])[:6],
            "top_host_ops_ms": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                                for e in host]}


def _step_spread(runs):
    """Steps 2 on of each run of one setting: each run's median, and the
    pooled median, range and standard deviation."""
    steps = [t for r in runs for t in r[1:]]
    return {"run_medians": [statistics.median(r[1:]) for r in runs],
            "median": statistics.median(steps), "min": min(steps),
            "max": max(steps), "sd": statistics.stdev(steps),
            "steps": len(steps)}


class _StepWatch:
    """A ``batch_end_callback`` of `BaseModule.fit` on the card: each
    step's launches (read, then set to 0), a CUDA event at its end, and
    optionally one profiled step.  The profiler opens at the end of batch
    ``profile_at - 2`` with no sync, so the device keeps the queue the loop
    built, and batch ``profile_at - 1`` runs under it unread; the window is
    batch ``profile_at`` alone, from the host's end of batch
    ``profile_at - 1`` to the end of batch ``profile_at``, and the device
    is busy for the union of its kernels and copies inside it."""

    def __init__(self, profile_at=None, then=None):
        self.counts, self.events, self.metric = [], [], []
        self.profile_at = profile_at
        self.then = then
        self.prof = None
        self.window = None

    def start(self):
        torch.cuda.synchronize()
        reset_counts()
        self._event()

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def __call__(self, p):
        self.counts.append(read_counts())
        reset_counts()
        self._event()
        self.metric.append(p.eval_metric.get_name_value())
        if self.profile_at is not None and p.nbatch == self.profile_at - 2:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif self.prof is not None and p.nbatch == self.profile_at - 1:
            with torch.profiler.record_function(_WINDOW_OPEN):
                pass
        elif self.prof is not None and p.nbatch == self.profile_at:
            torch.cuda.synchronize()
            with torch.profiler.record_function(_WINDOW_CLOSE):
                pass
            self.prof.__exit__(None, None, None)
            self.window = _read_window(self.prof)
            self.prof = None
        if self.then is not None:
            self.then(p)

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                 self.events[1:])]


def module_batches(n, batch, cfg, seed):
    """``n`` batches of token ids and labels from `RandomState(seed)`."""
    rng = np.random.RandomState(seed)
    shape = (n * batch, cfg["seq_len"])
    return (rng.randint(0, cfg["vocab_size"], shape).astype(np.int32),
            rng.randint(0, cfg["vocab_size"], shape).astype(np.float32))


def _host_params(arrays):
    """Float32 copies on the host (never views of the arrays)."""
    return {n: (a.data if isinstance(a, mx.nd.NDArray) else a).detach()
            .to("cpu", torch.float32, copy=True) for n, a in arrays.items()}


def _max_gap(got, want):
    """(max |got - want| over every tensor, its name)."""
    gaps = {n: float((got[n] - want[n]).abs().max()) for n in want}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def _adam_states(updater):
    return {"%s.%d" % (k, j): s.data.detach().to("cpu", copy=True)
            for k, v in updater.states.items() for j, s in enumerate(v)}


class _Stop(Exception):
    pass


def module_lm_path(expect):
    """(a) and (c): the parity LM in float32 at batch 8 through
    `mx.mod.Module.fit` (Adam lr 1e-3, kvstore 'local', an `NDArrayIter`
    of 6 seeded batches, ``MXNET_DEVICE_PREFETCH=2``,
    ``MXNET_METRIC_INTERVAL=3``) against phase 14's `simple_bind` loop on
    the same batches from the same parameters: bit for bit, exactly 25/25
    LayerNorm and 12/12/12 float32 flash launches a step, 2 blocking
    fetches; the same fit under ``MXNET_DEVICE_PREFETCH=0``, both timed
    twice more (2, 0, 0, 2) for the spread and profiled once each; then the fit interrupted after batch 4 with
    ``auto_checkpoint``/``checkpoint_every=3`` and finished by a fresh
    module with ``resume="auto"``: parameters and Adam states bit for bit
    the straight fit's."""
    import shutil
    import tempfile

    cfg, batch = PARITY, API_LM_BATCH
    shapes = {"data": (batch, cfg["seq_len"]),
              "softmax_label": (batch, cfg["seq_len"])}
    X, Y = module_batches(MODULE_BATCHES, batch, cfg, seed=1)
    mx.random.seed(0)
    net = mx.models.get_transformer_lm(**cfg)
    names = [n for n in net.list_arguments() if n not in shapes]

    # phase 14's loop on these batches
    exe = net.simple_bind(mx.gpu(0), grad_req="write", **shapes)
    init = mx.init.Uniform(0.07)
    for n in names:
        init(n, exe.arg_dict[n])
    initial = {n: mx.nd.NDArray(t, mx.cpu())
               for n, t in _host_params(
                   {n: exe.arg_dict[n] for n in names}).items()}
    updater = mx.optimizer.get_fused_updater(
        mx.optimizer.Adam(learning_rate=1e-3, rescale_grad=1.0 / batch))
    idx = [net.list_arguments().index(n) for n in names]
    weights = [exe.arg_arrays[i] for i in idx]
    grads = [exe.grad_arrays[i] for i in idx]
    loop_ms = []
    for i in range(MODULE_BATCHES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        exe.forward(is_train=True, data=X[i * batch:(i + 1) * batch],
                    softmax_label=Y[i * batch:(i + 1) * batch])
        exe.backward()
        updater(list(range(len(idx))), grads, weights)
        b.record()
        b.synchronize()
        loop_ms.append(a.elapsed_time(b))
    loop = _host_params({n: exe.arg_dict[n] for n in names})
    del exe, updater, weights, grads
    torch.cuda.empty_cache()

    def fit(pins, profile_at=None, then=None, **kw):
        mod = mx.mod.Module(net, context=mx.gpu(0))
        watch = _StepWatch(profile_at, then)
        it = mx.io.NDArrayIter(X, Y, batch_size=batch)
        with pinned(**pins):
            watch.start()
            t0 = time.perf_counter()
            try:
                mod.fit(it, num_epoch=1, optimizer="adam",
                        optimizer_params={"learning_rate": 1e-3},
                        kvstore="local", arg_params=initial,
                        eval_metric="acc", batch_end_callback=watch, **kw)
            except _Stop:
                pass
            wall = time.perf_counter() - t0
        return mod, watch, wall

    pins0 = dict(MODULE_PINS, MXNET_DEVICE_PREFETCH="0")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod, watch, fit_s = fit(MODULE_PINS)
    peak = torch.cuda.max_memory_allocated()
    straight = _host_params(mod.get_params()[0])
    straight_states = _adam_states(mod._updater)
    stats = dict(mod.stats)
    del mod
    torch.cuda.empty_cache()
    gap, gap_name = _max_gap(straight, loop)

    mod0, watch0, _ = fit(pins0)
    gap0, _ = _max_gap(_host_params(mod0.get_params()[0]), straight)
    stats0 = dict(mod0.stats)
    del mod0
    torch.cuda.empty_cache()
    # prefetch 2, 0, 0, 2 with no profiler: the step times and their
    # spread; then one profiled step of each, read with the device's queue
    # full (`_StepWatch`)
    runs = {"2": [watch.step_ms()], "0": [watch0.step_ms()]}
    for key, pins in (("0", pins0), ("2", MODULE_PINS)):
        m, w, _ = fit(pins)
        runs[key].append(w.step_ms())
        del m
        torch.cuda.empty_cache()
    windows = {}
    for key, pins in (("2", MODULE_PINS), ("0", pins0)):
        m, w, _ = fit(pins, profile_at=MODULE_BATCHES - 1)
        windows[key] = w.window
        del m
        torch.cuda.empty_cache()
    spread = {k: _step_spread(v) for k, v in runs.items()}
    step_ms, step_ms0 = runs["2"][0], runs["0"][0]

    # (c): a crash after batch 4 (0-based 3), its checkpoint at 3
    tmp = tempfile.mkdtemp(dir=os.environ.get("TMPDIR"))
    try:
        prefix = os.path.join(tmp, "lm")

        def crash(p):
            if p.nbatch == 3:
                raise _Stop()

        # every auto-checkpoint fit writes, timed (bytes, ms)
        writes = []
        save_auto = mx.checkpoint.save_auto

        def timed_save(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = save_auto(*args, **kw)
            writes.append((nbytes, 1e3 * (time.perf_counter() - t0)))
            return nbytes

        mx.checkpoint.save_auto = timed_save
        first, _, first_s = fit(MODULE_PINS, then=crash,
                                auto_checkpoint=prefix, checkpoint_every=3)
        first_stats = dict(first.stats)
        del first
        torch.cuda.empty_cache()
        resumed, _, resumed_s = fit(MODULE_PINS, auto_checkpoint=prefix,
                                    checkpoint_every=3, resume="auto")
        resumed_stats = dict(resumed.stats)
        rgap, rgap_name = _max_gap(_host_params(resumed.get_params()[0]),
                                   straight)
        sgap, sgap_name = _max_gap(_adam_states(resumed._updater),
                                   straight_states)
        del resumed
        torch.cuda.empty_cache()
    finally:
        mx.checkpoint.save_auto = save_auto
        shutil.rmtree(tmp, ignore_errors=True)
    nbytes = writes[0][0]
    write_ms = statistics.median(w[1] for w in writes)

    ms, ms0 = spread["2"]["median"], spread["0"]["median"]
    # staging's gain counts only beyond twice the larger per-step spread
    staging_ms = ms0 - ms
    resolved = abs(staging_ms) > 2 * max(spread["2"]["sd"],
                                         spread["0"]["sd"])
    tokens = batch * cfg["seq_len"]
    launches = {k: sum(s[k] for s in watch.counts) for k in watch.counts[0]}
    res = {"config": cfg, "batch": batch, "dtype": "float32",
           "batches": MODULE_BATCHES, "pins": MODULE_PINS,
           "optimizer": "Adam lr 1e-3 (Module.init_optimizer, kvstore "
                        "'local' on one device: get_fused_updater)",
           "step_ms": step_ms, "step_ms_runs": runs["2"],
           "step_ms_median": ms, "step_ms_spread": spread["2"],
           "tokens_per_s": tokens / (ms / 1e3),
           "simple_bind_loop_step_ms": loop_ms,
           "simple_bind_loop_step_ms_median": statistics.median(loop_ms[1:]),
           "fit_s": fit_s, "stats": stats, "launches": launches,
           "launches_by_step": watch.counts,
           "metric_by_step": watch.metric,
           "profiled": windows["2"], "max_memory_allocated": peak,
           "vs_simple_bind_loop_max_abs": gap,
           "vs_simple_bind_loop_worst": gap_name,
           "prefetch0": {"step_ms": step_ms0, "step_ms_runs": runs["0"],
                         "step_ms_median": ms0,
                         "step_ms_spread": spread["0"],
                         "tokens_per_s": tokens / (ms0 / 1e3),
                         "stats": stats0, "profiled": windows["0"],
                         "vs_prefetch2_max_abs": gap0},
           "staging_ms_saved": staging_ms,
           "staging_resolved": resolved,
           "resume": {"first_leg_stats": first_stats,
                      "resumed_stats": resumed_stats,
                      "first_leg_s": first_s, "resumed_leg_s": resumed_s,
                      "params_max_abs": rgap, "params_worst": rgap_name,
                      "adam_states_max_abs": sgap,
                      "adam_states_worst": sgap_name,
                      "checkpoint_bytes": nbytes,
                      "checkpoint_write_ms": write_ms,
                      "checkpoint_writes": writes}}

    def brief(w):
        return ("%.2f ms, device busy %.2f ms, idle share %.4f, %d device "
                "items" % (w["profiled_step_ms"], w["device_busy_ms"],
                           w["device_idle_share"], w["device_items"]))

    log("module lm: mx.mod.Module.fit of the parity configuration, float32, "
        "batch %d, %d batches, Adam, prefetch 2, metric interval 3: step ms "
        "(CUDA events, no profiler) %s; stats %s; launches per step %s; "
        "params vs the simple_bind loop max |d| %.3e (%s); "
        "max_memory_allocated %d B; phase 14's loop on the same batches %s"
        % (batch, MODULE_BATCHES, ["%.2f" % t for t in step_ms], stats,
           [{k: v for k, v in s.items() if v} for s in watch.counts], gap,
           gap_name, peak, ["%.2f" % t for t in loop_ms]))
    log("module lm, MXNET_DEVICE_PREFETCH=0: step ms %s; stats %s; params "
        "vs prefetch 2 max |d| %.3e"
        % (["%.2f" % t for t in step_ms0], stats0, gap0))
    for key in ("2", "0"):
        sp = spread[key]
        log("module lm, prefetch %s over runs in the order 2, 0, 0, 2: run "
            "medians (steps 2-%d) %s ms; pooled median %.3f ms (%.1f "
            "tokens/s), range %.3f-%.3f, sd %.3f over %d steps; profiled "
            "step (queue full at the window's start): %s; top device %s; "
            "top host %s"
            % (key, MODULE_BATCHES, ["%.3f" % t for t in sp["run_medians"]],
               sp["median"], tokens / (sp["median"] / 1e3), sp["min"],
               sp["max"], sp["sd"], sp["steps"], brief(windows[key]),
               windows[key]["top_device_ops_ms"],
               windows[key]["top_host_ops_ms"]))
    log("module lm: staging (prefetch 2 against 0) %.3f ms a step, %s (bar: "
        "twice the larger per-step sd, %.3f ms)"
        % (staging_ms, "resolved" if resolved else "unresolved",
           2 * max(spread["2"]["sd"], spread["0"]["sd"])))
    log("module lm resume: interrupted after batch 4 (stats %s), resumed "
        "(stats %s): params vs the straight fit max |d| %.3e (%s), Adam "
        "states %.3e (%s); checkpoint %d B, writes (B, ms) %s"
        % (first_stats, resumed_stats, rgap, rgap_name, sgap, sgap_name,
           nbytes, writes))
    if gap != 0 or gap0 != 0:
        raise SystemExit("module lm: Module.fit's parameters differ from the "
                         "simple_bind loop's (%.3e at %s) or between prefetch "
                         "2 and 0 (%.3e)" % (gap, gap_name, gap0))
    if stats["train.host_blocking_fetches"] != 2 or \
            stats["io.device_batches"] != MODULE_BATCHES or \
            stats0["io.device_batches"] != 0:
        raise SystemExit("module lm: stats %s, %s: expected 2 blocking "
                         "fetches and %d staged batches (0 with prefetch 0)"
                         % (stats, stats0, MODULE_BATCHES))
    for i, counts in enumerate(watch.counts):
        off = {k: n for k, n in counts.items() if n != expect.get(k, 0)}
        if off:
            raise SystemExit("module lm: step %d launched %s, expected %s"
                             % (i + 1, off, expect))
    if rgap != 0 or sgap != 0 or resumed_stats["train.resumes"] != 1 or \
            first_stats["train.auto_checkpoints"] != 1:
        raise SystemExit("module lm resume: params %.3e (%s), Adam states "
                         "%.3e (%s) from the straight fit; stats %s, %s"
                         % (rgap, rgap_name, sgap, sgap_name, first_stats,
                            resumed_stats))
    return res


def fault_tolerance_path(expect):
    """Phase 20 (a)-(c): the nonfinite guard, chaos's ``nan_grad`` and
    the lr backoff on `module_lm_path`'s fit (the parity LM in float32 at
    batch 8, Adam lr 1e-3, 6 seeded batches, prefetch 2, metric interval
    3), and the guard's cost and drift on the clean batches."""
    cfg, batch = PARITY, API_LM_BATCH
    X, Y = module_batches(MODULE_BATCHES, batch, cfg, seed=1)
    mx.random.seed(0)
    net = mx.models.get_transformer_lm(**cfg)
    shapes = {"data": (batch, cfg["seq_len"]),
              "softmax_label": (batch, cfg["seq_len"])}
    # the initial parameters drawn once on the card (a fit's own
    # init_params draws on the host), as module_lm_path does
    exe = net.simple_bind(mx.gpu(0), grad_req="null", **shapes)
    names = [n for n in net.list_arguments() if n not in shapes]
    init = mx.init.Uniform(0.07)
    for n in names:
        init(n, exe.arg_dict[n])
    initial = {n: mx.nd.NDArray(t, mx.cpu()) for n, t in _host_params(
        {n: exe.arg_dict[n] for n in names}).items()}
    del exe
    torch.cuda.empty_cache()
    skip = 2  # 0-based: the 3rd update is poisoned
    keep = np.r_[0:skip * batch, (skip + 1) * batch:len(X)]
    update_multi = mx.optimizer.Optimizer.update_multi

    def no_sync_update(self, *args, **kw):
        # the guard decides on the device: a host sync in the update
        # raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            return update_multi(self, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def fit(pins, x=X, y=Y, snap=()):
        mx.chaos.reset()
        mx.telemetry.reset()
        mx.random.seed(0)
        mod = mx.mod.Module(net, context=mx.gpu(0))
        snaps = {}

        def then(p):
            # a copy on the card: no sync inside the timed steps
            if p.nbatch in snap:
                snaps[p.nbatch] = {
                    n: a[0].data.clone() for n, a in zip(
                        mod._param_names, mod._exec_group.param_arrays)}
        watch = _StepWatch(then=then)
        with pinned(**dict(MODULE_PINS, **pins)):
            mx.optimizer.Optimizer.update_multi = no_sync_update
            try:
                watch.start()
                mod.fit(mx.io.NDArrayIter(x, y, batch_size=batch),
                        num_epoch=1, optimizer="adam",
                        optimizer_params={"learning_rate": 1e-3},
                        kvstore="local", arg_params=initial,
                        eval_metric="acc", batch_end_callback=watch)
                step_ms = watch.step_ms()
            finally:
                mx.optimizer.Optimizer.update_multi = update_multi
        reg = mx.telemetry.registry()
        return {"watch": watch,
                "snaps": {k: _host_params(v) for k, v in snaps.items()},
                "step_ms": step_ms, "stats": dict(mod.stats),
                "params": _host_params(mod.get_params()[0]),
                "states": _adam_states(mod._updater),
                "lr": mod._optimizer.lr,
                "counters": {k: v for k, v in reg._counters.items()},
                "lr_backoff": mx.telemetry.events("lr_backoff")}

    guard = {"MXNET_NONFINITE_GUARD": "1"}
    chaos = dict(guard, MXNET_CHAOS="nan_grad:3:inf")
    a = fit(chaos, snap=(skip - 1, skip))
    skipped_same = _max_gap(a["snaps"][skip], a["snaps"][skip - 1])[0] == 0
    a_ref = fit(guard, X[keep], Y[keep])
    gap, gap_name = _max_gap(a["params"], a_ref["params"])
    sgap, sgap_name = _max_gap(a["states"], a_ref["states"])
    launches = {k: sum(s[k] for s in a["watch"].counts)
                for k in a["watch"].counts[0]}
    b = fit(dict(chaos, MXNET_NONFINITE_BACKOFF="0.5"))
    # (c): the same clean batches, guard off, on, on, off
    runs = {"off": [], "on": []}
    first, finals = {}, {}
    for key in ("off", "on", "on", "off"):
        r = fit(guard if key == "on" else {}, snap=(0,))
        runs[key].append(r["step_ms"])
        first[key], finals[key] = r["snaps"][0], r["params"]
        del r
        torch.cuda.empty_cache()
    spread = {k: _step_spread(v) for k, v in runs.items()}
    scale = max(float(w.abs().max()) for w in finals["off"].values())
    # after one step the gradients are the same bits, so the runs differ
    # by the float32 fold of lr_t alone; later, a weight whose gradient
    # is rounding noise (the key biases) takes lr-sized steps that a
    # one-ulp difference anywhere turns around
    drift1, drift1_name = _max_gap(first["on"], first["off"])
    drift, drift_name = _max_gap(finals["on"], finals["off"])
    drift1, drift = drift1 / scale, drift / scale
    res = {"config": cfg, "batch": batch, "dtype": "float32",
           "batches": MODULE_BATCHES, "pins": MODULE_PINS,
           "skip": {"spec": "nan_grad:3:inf",
                    "after_3_equals_after_2": skipped_same,
                    "vs_fit_without_batch_3_params_max_abs": gap,
                    "params_worst": gap_name,
                    "vs_fit_without_batch_3_adam_max_abs": sgap,
                    "adam_worst": sgap_name, "stats": a["stats"],
                    "counters": a["counters"], "launches": launches,
                    "launches_by_step": a["watch"].counts,
                    "step_ms": a["step_ms"]},
           "backoff": {"lr": b["lr"], "lr_backoff": b["lr_backoff"],
                       "counters": b["counters"], "stats": b["stats"],
                       "step_ms": b["step_ms"]},
           "guard_cost": {"runs": runs, "spread": spread,
                          "guard_ms": spread["on"]["median"]
                          - spread["off"]["median"],
                          "drift_rel_after_step_1": drift1,
                          "drift_worst_after_step_1": drift1_name,
                          "drift_rel": drift, "drift_worst": drift_name},
           "launches": launches}
    log("fault tolerance (a): nan_grad:3:inf under the guard: params after "
        "batch 3 %s those after batch 2; vs the guarded fit without batch 3 "
        "params max |d| %.3e (%s), Adam states %.3e (%s); stats %s; "
        "launches per step %s"
        % ("==" if skipped_same else "!=", gap, gap_name, sgap, sgap_name,
           a["stats"], [{k: v for k, v in c.items() if v}
                        for c in a["watch"].counts]))
    log("fault tolerance (b): backoff 0.5: lr %g, lr_backoff events %d, "
        "counters %s" % (b["lr"], len(b["lr_backoff"]), b["counters"]))
    log("fault tolerance (c): ms a step over runs off, on, on, off (steps "
        "2-%d): guard off median %.3f (sd %.3f), on %.3f (sd %.3f): the "
        "guard costs %.3f ms a step; max|w_on - w_off| / max|w| after "
        "step 1 %.3e (%s), after step %d %.3e (%s)"
        % (MODULE_BATCHES, spread["off"]["median"], spread["off"]["sd"],
           spread["on"]["median"], spread["on"]["sd"],
           res["guard_cost"]["guard_ms"], drift1, drift1_name,
           MODULE_BATCHES, drift, drift_name))
    if not skipped_same or gap != 0 or sgap != 0:
        raise SystemExit("fault tolerance (a): the skipped step moved the "
                         "parameters, or the run differs from the fit "
                         "without batch 3 (%.3e, %.3e)" % (gap, sgap))
    for i, counts in enumerate(a["watch"].counts):
        off = {k: n for k, n in counts.items() if n != expect.get(k, 0)}
        if off:
            raise SystemExit("fault tolerance (a): step %d launched %s, "
                             "expected %s" % (i + 1, off, expect))
    if a["stats"]["train.host_blocking_fetches"] != 2 or \
            a["counters"].get("train.nonfinite_steps", 0) != 0:
        raise SystemExit("fault tolerance (a): counters %s: expected 2 "
                         "blocking fetches and no drained health"
                         % a["counters"])
    if b["lr"] != 1e-3 * 0.5 or len(b["lr_backoff"]) != 1 or \
            b["counters"].get("train.nonfinite_steps") != 1 or \
            b["counters"]["train.host_blocking_fetches"] != 8:
        raise SystemExit("fault tolerance (b): lr %r, %d lr_backoff events, "
                         "counters %s" % (b["lr"], len(b["lr_backoff"]),
                                          b["counters"]))
    if not drift1 <= 1e-6 or not math.isfinite(drift):
        raise SystemExit("fault tolerance (c): after one step guarded Adam "
                         "is %.3e of max|w| from unguarded Adam (bar 1e-6: "
                         "the float32 fold of lr_t)" % drift1)
    return res


def out_of_range_checks(gen):
    """Phase 20 (d): an out-of-range `Embedding` on the card, then
    kernels still launching and matching; a served prompt with a token
    past the vocabulary, then normal prompts with a fresh engine's
    tokens."""
    from mxnet_tpu_torch.ops import registry

    op = registry.get("Embedding")
    w = torch.randn(8, 5, device="cuda", generator=gen)
    idx = torch.tensor([[0, 3, 7, 9], [-1, 2, 8, 1]], device="cuda")
    out = op.apply(registry.OpCtx(), op.parse_params(
        {"input_dim": 8, "output_dim": 5}), [idx, w], [])[0][0]
    nan_rows = torch.isnan(out).all(dim=-1).cpu().tolist()
    emb_ok = nan_rows == [[False, False, False, True],
                          [False, False, True, False]] and \
        torch.equal(out[1, 0], w[7]) and torch.equal(out[0, 1], w[3])
    after = [layer_norm_case(8, torch.float32, gen),
             flash_case(64, 64, True, 0, 0, torch.float32, gen)]
    model = TransformerKVModel(**GPT2)
    params = model.params_from_jax(
        model.init_params(np.random.RandomState(0)), "cuda")
    rng = np.random.RandomState(5)
    bad = rng.randint(0, model.vocab_size, 40).tolist()
    bad[17] = model.vocab_size + 123
    good = [(rng.randint(0, model.vocab_size, 60).tolist(), {}),
            (rng.randint(0, model.vocab_size, 90).tolist(),
             dict(temperature=0.8, top_k=50, seed=3))]
    engine = ServingEngine(model, params, max_batch=8)
    r_bad = engine.submit(bad, max_new_tokens=8, temperature=0.8, seed=1)
    engine.run_until_idle(timeout=300)
    got = [engine.submit(p, max_new_tokens=16, **kw) for p, kw in good]
    engine.run_until_idle(timeout=300)
    fresh = ServingEngine(model, params, max_batch=8)
    want = [fresh.submit(p, max_new_tokens=16, **kw) for p, kw in good]
    fresh.run_until_idle(timeout=300)
    res = {"embedding_nan_rows": nan_rows, "embedding_ok": emb_ok,
           "after": [{k: c[k] for k in ("kernel", "shape", "dtype",
                                        "max_abs_err", "ok")}
                     for c in after],
           "bad_prompt_tokens": r_bad.result(1),
           "good_tokens": [r.result(1) for r in got],
           "fresh_tokens": [r.result(1) for r in want],
           "completed": engine.stats["completed"]}
    del engine, fresh, params
    torch.cuda.empty_cache()
    log("fault tolerance (d): Embedding [[0,3,7,9],[-1,2,8,1]] at "
        "input_dim 8 on the card: NaN rows %s; then %s; a served prompt "
        "with token %d (vocab %d): tokens %s; the next two prompts %s, a "
        "fresh engine's %s" % (
            nan_rows, [(c["kernel"], c["max_abs_err"], c["ok"])
                       for c in after], bad[17], model.vocab_size,
            res["bad_prompt_tokens"], res["good_tokens"],
            res["fresh_tokens"]))
    if not emb_ok or not all(c["ok"] for c in after):
        raise SystemExit("fault tolerance (d): the out-of-range Embedding "
                         "or a kernel after it is wrong: %s" % res)
    if res["bad_prompt_tokens"] != [0] * 8 or \
            res["good_tokens"] != res["fresh_tokens"] or \
            res["completed"] != 3:
        raise SystemExit("fault tolerance (d): the engine after an "
                         "out-of-range prompt: %s" % res)
    return res


def storage_checks():
    """Phase 20 (e): the card's memory counters, the pool's reuse of a
    freed buffer, the ``storage`` collector of a step report."""
    mem = mx.storage.device_memory_stats()
    st = mx.storage.Storage.get()
    h = st.alloc(1 << 20, mx.gpu(0))
    ptr = h.data.data_ptr()
    st.free(h)
    h2 = st.alloc(1 << 20, mx.gpu(0))
    reused = h2.data.data_ptr() == ptr
    pool = st.pool_stats()
    st.free(h2)
    st.release_all()
    report = mx.telemetry.step_report()["storage"]
    res = {"device_memory_stats": mem, "reused": reused, "pool": pool,
           "step_report_storage": report}
    log("fault tolerance (e): device_memory_stats %s; alloc/free/alloc of "
        "1 MiB reused the buffer: %s; step report storage %s"
        % (mem, reused, report))
    if not mem.get("bytes_in_use") or not reused or \
            not report.get("hbm", {}).get("bytes_in_use"):
        raise SystemExit("fault tolerance (e): storage %s" % res)
    return res


def spmd_module_path(expect):
    """(b): the fused configuration in bf16 at batch 32 through
    `mx.mod.SPMDModule.fit` (Adam lr 1e-3, 5 seeded batches), against
    `SPMDTrainer.step` on the same batches from the same seed (Adam's v in
    float32): bit for bit, with rows 1-4 (bf16) and 13-14 launched as in
    phase 10."""
    cfg, batch = FUSED, TRAIN_BATCH
    X, Y = module_batches(SPMD_MODULE_BATCHES, batch, cfg, seed=2)
    mx.random.seed(0)
    net = mx.models.get_transformer_lm(**cfg)
    mod = mx.mod.SPMDModule(net, dtype="bfloat16")
    watch = _StepWatch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    watch.start()
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=batch), num_epoch=1,
            optimizer="adam", optimizer_params={"learning_rate": 1e-3},
            initializer=mx.init.Uniform(0.07), eval_metric="torch",
            batch_end_callback=watch)
    step_ms = watch.step_ms()
    peak = torch.cuda.max_memory_allocated()
    got = _host_params(mod._trainer.params)
    stats = dict(mod.stats)
    del mod
    torch.cuda.empty_cache()

    trainer = lm_trainer(cfg, batch, "bfloat16")
    for i in range(SPMD_MODULE_BATCHES):
        trainer.step({"data": X[i * batch:(i + 1) * batch],
                      "softmax_label": Y[i * batch:(i + 1) * batch]})
    gap, gap_name = _max_gap(got, _host_params(trainer.params))
    del trainer
    torch.cuda.empty_cache()

    ms = statistics.median(step_ms[1:])
    launches = {k: sum(s[k] for s in watch.counts) for k in watch.counts[0]}
    res = {"config": cfg, "batch": batch, "dtype": "bfloat16",
           "batches": SPMD_MODULE_BATCHES, "optimizer": "adam lr 1e-3",
           "step_ms": step_ms, "step_ms_median": ms,
           "tokens_per_s": batch * cfg["seq_len"] / (ms / 1e3),
           "stats": stats, "launches": launches,
           "launches_by_step": watch.counts,
           "mean_nll_by_step": watch.metric, "max_memory_allocated": peak,
           "vs_trainer_max_abs": gap, "vs_trainer_worst": gap_name}
    log("spmd module: mx.mod.SPMDModule.fit of the fused configuration, "
        "bf16, batch %d, %d batches, Adam: step ms %s, median %.2f ms = %.1f "
        "tokens/s; running mean NLL %s; launches per step %s; params vs "
        "SPMDTrainer.step max |d| %.3e (%s); max_memory_allocated %d B"
        % (batch, SPMD_MODULE_BATCHES, ["%.2f" % t for t in step_ms], ms,
           res["tokens_per_s"], [m[0][1] for m in watch.metric],
           [{k: v for k, v in s.items() if v} for s in watch.counts], gap,
           gap_name, peak))
    if gap != 0:
        raise SystemExit("spmd module: parameters differ from SPMDTrainer's "
                         "(%.3e at %s)" % (gap, gap_name))
    if not all(math.isfinite(m[0][1]) for m in watch.metric):
        raise SystemExit("spmd module: a loss is not finite")
    for i, counts in enumerate(watch.counts):
        off = {k: n for k, n in counts.items() if n != expect.get(k, 0)}
        if off:
            raise SystemExit("spmd module: step %d launched %s, expected %s"
                             % (i + 1, off, expect))
    return res


def synthetic_sentences(n, vocab, seed=0):
    """`examples/lstm_bucketing.py`'s synthetic sentences: lengths 4-32,
    each a run of consecutive token ids."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = rng.randint(4, LSTM_BUCKETS[-1] + 1)
        start = rng.randint(0, vocab)
        out.append([(start + i) % vocab for i in range(ln)])
    return out


class BucketSentenceIter(mx.io.DataIter):
    """`examples/lstm_bucketing.py`'s iterator over the port, its batches
    on the host: each sentence padded into the smallest bucket that holds
    it, each bucket's rows cut into batches, the batches shuffled at
    every reset."""

    def __init__(self, sentences, batch_size, init_states):
        super().__init__()
        self.batch_size = batch_size
        self.init_states = list(init_states)
        self._init_arrays = [mx.nd.zeros(s, mx.cpu()) for _, s in
                             self.init_states]
        self.default_bucket_key = LSTM_BUCKETS[-1]
        self.data = {b: [] for b in LSTM_BUCKETS}
        for s in sentences:
            for b in LSTM_BUCKETS:
                if len(s) <= b:
                    pad = np.zeros(b, np.float32)
                    pad[:len(s)] = s
                    self.data[b].append(pad)
                    break
        self.reset()

    @property
    def provide_data(self):
        return [("data", (self.batch_size, self.default_bucket_key))] + \
            self.init_states

    @property
    def provide_label(self):
        return [("softmax_label", (self.batch_size,
                                   self.default_bucket_key))]

    def reset(self):
        self._plan = []
        for b, rows in self.data.items():
            rows = np.asarray(rows)
            for i in range(0, len(rows) - self.batch_size + 1,
                           self.batch_size):
                self._plan.append((b, rows[i:i + self.batch_size]))
        np.random.shuffle(self._plan)
        self._idx = 0

    def next(self):
        if self._idx >= len(self._plan):
            raise StopIteration
        b, rows = self._plan[self._idx]
        self._idx += 1
        labels = np.roll(rows, -1, axis=1)
        labels[:, -1] = 0
        return mx.io.DataBatch(
            data=[mx.nd.array(rows, ctx=mx.cpu())] + self._init_arrays,
            label=[mx.nd.array(labels, ctx=mx.cpu())], bucket_key=b,
            provide_data=[("data", (self.batch_size, b))] + self.init_states,
            provide_label=[("softmax_label", (self.batch_size, b))])


def bucketing_path():
    """(d): `examples/lstm_bucketing.py` through `mx.mod.BucketingModule`
    for one epoch on the card and on the CPU: every bucket binds the
    default bucket's parameter and gradient tensors (the same
    ``data_ptr``), and the card's parameters after the epoch lie within
    1e-4 of max|w| of the CPU's."""
    c = LSTM_BUCKET
    sentences = synthetic_sentences(c["sentences"], c["vocab"])
    init_states = [("l%d_init_%s" % (i, t), (c["batch"], c["num_hidden"]))
                   for i in range(c["num_layers"]) for t in ("c", "h")]
    data_names = ("data",) + tuple(n for n, _ in init_states)

    def sym_gen(key):
        return (mx.models.lstm_unroll(c["num_layers"], key, c["vocab"],
                                      c["num_hidden"], c["num_embed"],
                                      c["vocab"]),
                data_names, ("softmax_label",))

    def run(ctx):
        mx.random.seed(0)
        it = BucketSentenceIter(sentences, c["batch"], init_states)
        mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=LSTM_BUCKETS[-1],
                                     context=ctx)
        seen = []
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": c["lr"]},
                initializer=mx.init.Xavier(), eval_metric="ce",
                batch_end_callback=lambda p: seen.append(
                    p.eval_metric.get()[1]))
        return mod, seen, time.perf_counter() - t0

    card, card_ce, card_s = run(mx.gpu(0))
    shared = {}
    default = card._buckets[LSTM_BUCKETS[-1]]._exec_group.train_execs[0]
    names = default._symbol.list_arguments()
    params = [n for n in card._buckets[LSTM_BUCKETS[-1]]._param_names]
    for b, mod in card._buckets.items():
        exe = mod._exec_group.train_execs[0]
        shared[b] = all(
            exe.arg_dict[n].data.data_ptr() ==
            default.arg_dict[n].data.data_ptr() and
            exe.grad_dict[n].data.data_ptr() ==
            default.grad_dict[n].data.data_ptr() for n in params)
    got = _host_params(card.get_params()[0])
    del card
    torch.cuda.empty_cache()
    host, host_ce, host_s = run(mx.cpu())
    want = _host_params(host.get_params()[0])
    worst = {n: float((got[n] - want[n]).abs().max()) /
             max(float(want[n].abs().max()), 1e-30) for n in want}
    name = max(worst, key=worst.get)
    res = {"config": dict(c, buckets=LSTM_BUCKETS),
           "buckets_bound": sorted(shared), "shares_default": shared,
           "params": len(params), "arguments": len(names),
           "batches": len(card_ce), "card_ce_by_step": card_ce,
           "cpu_ce_by_step": host_ce, "card_fit_s": card_s,
           "cpu_fit_s": host_s, "worst_rel": worst[name],
           "worst_param": name, "tol": BUCKET_TOL}
    log("bucketing: lstm_bucketing's defaults through BucketingModule, one "
        "epoch of %d batches over buckets %s: every bucket on the default "
        "bucket's tensors %s; card vs CPU max |dw|/max |w| %.3e at %s (tol "
        "%.0e); running CE card %s, CPU %s; fit s card %.2f, CPU %.2f"
        % (len(card_ce), sorted(shared), shared, worst[name], name,
           BUCKET_TOL, ["%.4f" % x for x in card_ce],
           ["%.4f" % x for x in host_ce], card_s, host_s))
    if sorted(shared) != list(LSTM_BUCKETS) or not all(shared.values()):
        raise SystemExit("bucketing: buckets %s, shared %s" % (
            sorted(shared), shared))
    if not worst[name] <= BUCKET_TOL:
        raise SystemExit("bucketing: card vs CPU %.3e at %s" % (worst[name],
                                                               name))
    return res


# the entries of the kernels line for the float32 kernels on the tensor
# cores (the flash forward and backward, the fused CE head): the bf16 row
# each one shares its TPU function with
F32_ROWS = ("flash_attention", "flash_attention_bwd", "flash_attention_bsd",
            "flash_attention_bsd_bwd", "flash_attention_ds",
            "flash_attention_ds_bwd", "flash_attention_bsd_stream",
            "flash_attention_bsd_stream_bwd", "fused_ce_fwd", "fused_ce_bwd",
            "fused_ce_fwd_sp", "fused_ce_bwd_dw_rs", "fused_ce_bwd_dx_rs")


# -- the conv nets (phases 15-18) ---------------------------------------------

# bench.py's headline (`bench.py:126-173`, `BASELINE.json` configs[1]):
# ResNet-50, 1000 classes, 224 pixels, 'valid' pooling (stages of
# 56/28/14/7), bf16 compute, batch 128, SGD lr 0.1 momentum 0.9 wd 1e-4
# through `SPMDTrainer` (its default Uniform(0.07) initializer), one
# batch from `RandomState(0)` staged on the card once
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
              pooling_convention="valid")
RESNET_BATCH = 128
RESNET_STEPS = 10
RESNET_SGD = dict(optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-4)
# `bench.py:196-201`: 4.089 G multiply-accumulates an image forward
# (torchvision's count), 2 operations each, training ~3x forward
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.089e9
# The card-vs-CPU checks of the conv nets (phases 15 and 17): float32
# on both, the card's convolutions on cuDNN (TF32 off inside the ops
# whatever the flag says), the CPU's on oneDNN, each summing in its own
# order.  Forward outputs and moving statistics are held to
# CONV_FWD_TOL and CONV_AUX_TOL of their largest magnitude.  Gradients
# are held to GRAD_TOL of each parameter's largest, or to
# CONV_SPREAD_MULT times the rounding spread, where that is larger: the
# distance between CPU runs that differ only in their thread count
# (CONV_SPREAD_THREADS against all) or in float64 (`grads_f64`), and
# between the card's float32 and float64 gradients.  At initialization
# these BatchNorm networks amplify rounding in their backward (a
# convolution before a BatchNorm has a gradient orthogonal to its
# filters, a difference of two large terms), and a ReLU input within
# rounding of zero lands on either side in two runs.  ResNet-50 at batch
# 4 on the CPU: float32 against float64 parts by 0.21 of some
# parameter's largest gradient, 1 thread against 8 by 0.14; Inception-BN
# at batch 2 by 0.18 (`tests/test_torch_zoo_resnet.py` measures the same
# effect against the JAX package).  At this level the check cannot tell
# TF32 from float32 (its ~3e-4 a product is rounding beside 0.1-0.2):
# CONV_F32_CASES hold the convolutions to float64 directly
CONV_FWD_TOL = 1e-4
CONV_AUX_TOL = 1e-5
CONV_SPREAD_THREADS = (1, 2, 4)
CONV_SPREAD_MULT = 2.0
# the direct check that a float32 convolution keeps float32 products
# with ``cudnn.allow_tf32 = True``: forward, dx and dw against float64
# on the card, within CONV_F32_TOL of the largest (a weight gradient
# sums up to 12544 products, batch 4 x 56 x 56: ~1e-5 of rounding in
# float32); TF32 (10 mantissa bits) errs ~3e-4 and must exceed it.
# Shapes: ResNet-50's stem and a bottleneck's 3x3 and 1x1 at batch 4,
# FCN-8s's 16x upscore
CONV_F32_TOL = 5e-5
CONV_F32_CASES = [
    ("Convolution", (4, 3, 224, 224),
     dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=64,
          no_bias=True)),
    ("Convolution", (4, 64, 56, 56),
     dict(kernel=(3, 3), pad=(1, 1), num_filter=64, no_bias=True)),
    ("Convolution", (4, 256, 56, 56),
     dict(kernel=(1, 1), num_filter=64, no_bias=True)),
    ("Deconvolution", (4, 21, 8, 8),
     dict(kernel=(16, 16), stride=(8, 8), pad=(4, 4), num_filter=21)),
]
# `examples/train_imagenet.py --trainer feedforward` (:77-97): ResNet-50
# ('full' pooling, the model's default), FeedForward, SGD lr 0.1 (no
# momentum), Xavier(gaussian, magnitude 2), kvstore 'device', 8
# synthetic batches from RandomState(0) in one NDArrayIter, float32; the
# batch cut from 256 to 64 to keep the script inside its time limit
FF_BATCH = 64
FF_BATCHES = 8
FF_IMAGE = (3, 224, 224)
# the other `BASELINE.json` configurations, trained a few steps each
# through `SPMDTrainer` and checked card against CPU at a small size:
# (build function, data shapes at the training size, at the check size,
# dtype, optimizer, initializer, steps, kind of head)
OTHER_NETS = {
    # `examples/train_imagenet.py --network inception-bn` at 224, bf16
    "inception_bn": (
        lambda: mx.models.get_inception_bn(num_classes=1000,
                                           image_shape=(3, 224, 224)),
        {"data": (32, 3, 224, 224), "softmax_label": (32,)},
        {"data": (2, 3, 224, 224), "softmax_label": (2,)}, "bfloat16",
        dict(optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-4),
        lambda: mx.init.Xavier(rnd_type="gaussian", magnitude=2.0), 2,
        "image"),
    # `examples/lstm_bucketing.py`'s defaults: 2 layers, hidden 64, embed
    # 64, batch 32, vocab 64 (its synthetic sentences), Adam lr 0.01, at
    # its largest bucket (32)
    "lstm": (
        lambda: mx.models.lstm_unroll(2, 32, 64, 64, 64, 64),
        dict({"data": (32, 32), "softmax_label": (32, 32)},
             **{"l%d_init_%s" % (i, t): (32, 64) for i in range(2)
                for t in "ch"}),
        dict({"data": (4, 32), "softmax_label": (4, 32)},
             **{"l%d_init_%s" % (i, t): (4, 64) for i in range(2)
                for t in "ch"}), "float32",
        dict(optimizer="adam", lr=0.01, wd=0.0),
        lambda: mx.init.Xavier(), 2, "lstm"),
    # `examples/fcn_xs.py`'s defaults: FCN-8s, 21 classes, 64x64, batch
    # 4, SGD lr 1e-2 momentum 0.9 wd 5e-4, Xavier(magnitude 2) with
    # bilinear upscore kernels; checked with its Dropouts at p = 0 (the
    # card's and the CPU's generators draw different masks) and from
    # Xavier for every weight: with one bilinear kernel on every (input,
    # output) channel pair the scores are the same for every class, and
    # every gradient is zero in exact arithmetic (rounding noise in
    # float32, ~1e-14 in float64)
    "fcn8s": (
        lambda: mx.models.get_fcn_xs(num_classes=21, variant="fcn8s"),
        {"data": (4, 3, 64, 64), "softmax_label": (4, 64, 64)},
        {"data": (1, 3, 64, 64), "softmax_label": (1, 64, 64)}, "float32",
        dict(optimizer="sgd", lr=1e-2, momentum=0.9, wd=5e-4),
        lambda: mx.init.Mixed(["upscore|score2_|score4_", ".*"],
                              [mx.init.Bilinear(),
                               mx.init.Xavier(magnitude=2.0)]), 2,
        "pixels"),
}


def net_batch(shapes, kind, classes, seed=0):
    """Synthetic inputs for ``shapes`` from ``RandomState(seed)``: images
    and labels as `bench.py` draws them, token ids whose label is the next
    id (`examples/lstm_bucketing.py`'s grammar) and zero LSTM states,
    per-pixel labels."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in shapes.items():
        if n == "data" and kind == "lstm":
            out[n] = rng.randint(0, classes, s).astype(np.float32)
        elif n == "data":
            out[n] = rng.randn(*s).astype(np.float32)
        elif n.endswith("label"):
            out[n] = (out["data"] + 1) % classes if kind == "lstm" else \
                rng.randint(0, classes, s).astype(np.float32)
        else:
            out[n] = np.zeros(s, np.float32)
    return out


def head_nll(out, labels, kind):
    """Mean negative log-likelihood of the labels under a SoftmaxOutput's
    rows: (batch, classes), the LSTM's time-major (seq * batch, vocab), or
    per pixel (batch, classes, h, w); a probability that underflowed to 0
    counts as 1e-30 (NLL 69)."""
    if kind == "lstm":
        labels = labels.t().reshape(-1)
    if kind == "pixels":
        p = out.gather(1, labels.long().unsqueeze(1)).float()
    else:
        p = out.gather(1, labels.reshape(-1, 1).long()).float()
    return float(-torch.log(p.clamp_min(1e-30)).mean())


def by_kind(device):
    """Device ms of the profiled ops: cuDNN/cuBLAS convolutions and
    products (by kernel name) and the rest (elementwise, reductions,
    copies)."""
    keys = ("conv", "implicit", "wgrad", "dgrad", "fprop", "xmma", "gemm",
            "cutlass", "sm90_", "sm80_", "cudnn")
    mat = sum(ms for k, _, ms in device if any(s in k.lower() for s in keys))
    return {"conv_and_gemm_ms": mat,
            "other_ms": sum(ms for _, _, ms in device) - mat}


def resnet_path():
    """ResNet-50 at bench.py's geometry, bf16, batch 128, SGD through
    `SPMDTrainer`: RESNET_STEPS steps (the first a warm-up, left out of
    the timing) with the counts set to 0 before and read after, then one
    profiled step; the loss must fall, the aux states be finite and have
    moved from 0 and 1, and no kernel of the table launch."""
    mx.random.seed(0)
    shapes = {"data": (RESNET_BATCH,) + RESNET["image_shape"],
              "softmax_label": (RESNET_BATCH,)}
    t0 = time.perf_counter()
    trainer = mx.SPMDTrainer(mx.models.get_resnet(**RESNET),
                             data_shapes=shapes, dtype="bfloat16",
                             **RESNET_SGD)
    build_s = time.perf_counter() - t0
    dev = trainer.shard_batch(net_batch(shapes, "image",
                                        RESNET["num_classes"]))
    labels = dev["softmax_label"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms, wall_ms = [], [], []
    for _ in range(RESNET_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        outs = trainer.step(dev)
        b.record()
        b.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        step_ms.append(a.elapsed_time(b))
        losses.append(head_nll(outs[0], labels, "image"))
        del outs
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    state = card_state()
    wall, busy, device, host = profiled(lambda: trainer.step(dev))
    aux = {n: a.float() for n, a in trainer.aux.items()}
    finite = all(bool(torch.isfinite(a).all()) for a in aux.values())
    moved = {n: bool((a != (1.0 if n.endswith("moving_var") else 0.0))
                     .any()) for n, a in aux.items()}
    del trainer, dev, labels, aux
    torch.cuda.empty_cache()
    step = statistics.median(step_ms[1:])
    ips = RESNET_BATCH / (step / 1e3)
    res = {"config": dict(RESNET, batch=RESNET_BATCH, dtype="bfloat16",
                          optimizer="sgd lr 0.1 momentum 0.9 wd 1e-4",
                          source="bench.py:126-173; BASELINE.json "
                                 "configs[1]"),
           "steps": RESNET_STEPS, "trainer_build_s": build_s,
           "losses": losses, "step_ms": step_ms, "wall_ms": wall_ms,
           "step_ms_median": step, "images_per_s": ips,
           "flops_per_image": RESNET_FLOPS_PER_IMAGE,
           "mfu": RESNET_FLOPS_PER_IMAGE * ips / MFU_PEAK,
           "launches": launches, "max_memory_allocated": peak,
           "card_after": state, "profiled_step_ms": 1e3 * wall,
           "device_busy_ms": 1e3 * busy,
           "device_idle_share": 1 - busy / wall,
           "device_ms_by_kind": by_kind(device),
           "top_device_ops_ms": device[:12], "top_host_ops_ms": host,
           "aux_finite": finite, "aux_moved": sum(moved.values()),
           "aux_states": len(moved)}
    log("resnet50: %d steps of batch %d at 224, bf16, SGD; step ms (CUDA "
        "events) %s; median of the last %d %.2f ms = %.1f images/s, MFU "
        "%.4f (%.4g flops an image over %.0f TFLOP/s); host wall ms %s"
        % (RESNET_STEPS, RESNET_BATCH, ["%.2f" % t for t in step_ms],
           len(step_ms) - 1, step, ips, res["mfu"], RESNET_FLOPS_PER_IMAGE,
           MFU_PEAK / 1e12, ["%.1f" % t for t in wall_ms]))
    log("resnet50: mean NLL per step %s; max_memory_allocated %d B; card "
        "after %s; aux states finite %s, moved from 0/1 %d of %d"
        % (["%.4f" % x for x in losses], peak, state, finite,
           res["aux_moved"], res["aux_states"]))
    log("resnet50: profiled step %.2f ms wall, device busy %.2f ms (idle "
        "share %.4f), by kind %s; top device ops (name, count, ms): %s"
        % (res["profiled_step_ms"], res["device_busy_ms"],
           res["device_idle_share"],
           {k: round(v, 3) for k, v in res["device_ms_by_kind"].items()},
           device[:12]))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit("resnet50: a loss is not finite: %s" % losses)
    if not losses[-1] < losses[0]:
        raise SystemExit("resnet50: the loss did not fall: %s" % losses)
    if not (finite and all(moved.values())):
        raise SystemExit("resnet50: aux states not finite or not moved")
    if any(launches.values()):
        raise SystemExit("resnet50: launched a kernel of the table: %s"
                         % {k: v for k, v in launches.items() if v})
    return res


def conv_f32_checks():
    """Each of CONV_F32_CASES through the op, forward and backward, in
    float32 with ``cudnn.allow_tf32 = True``, against float64 on the card;
    the raw cuDNN call under the same flag (TF32) beside it must miss the
    bar."""
    from mxnet_tpu_torch.ops import registry

    out = []
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, shape, params in CONV_F32_CASES:
            op = registry.get(name)
            p = op.parse_params(params)
            shapes = op.infer_shape(p, [shape] + [None] * (
                len(op.list_arguments(p)) - 1))[0]
            gen = torch.Generator(device="cuda").manual_seed(0)
            ins = [torch.randn(s, device="cuda", dtype=torch.float64,
                               generator=gen) for s in shapes]
            res = {}
            for dt in (torch.float32, torch.float64):
                leaves = [t.detach().to(dt).clone().requires_grad_()
                          for t in ins]
                y = op.apply(mx.ops.OpCtx(), p, leaves, [])[0][0]
                cot = torch.ones_like(y)
                y.backward(cot)
                res[dt] = [y.detach()] + [t.grad for t in leaves[:2]]
            raw_fn = F.conv_transpose2d if name == "Deconvolution" else \
                F.conv2d
            raw = raw_fn(ins[0].float(), ins[1].float(), stride=p["stride"],
                         padding=p["pad"])
            ref = res[torch.float64]
            errs = [float((a.double() - r).abs().max() / r.abs().max())
                    for a, r in zip(res[torch.float32], ref)]
            y0 = ref[0] - (ins[2].reshape(1, -1, 1, 1)
                           if len(ins) > 2 else 0)
            tf32 = float((raw.double() - y0).abs().max() / y0.abs().max())
            out.append({"op": name, "shape": shape, "params": params,
                        "f32_err_y_dx_dw": errs, "tf32_raw_err_y": tf32,
                        "tol": CONV_F32_TOL})
            log("conv f32 check %s %s %s: op in float32 vs float64, max "
                "|err|/max (y, dx, dw) %s (tol %.0e); raw cuDNN under "
                "allow_tf32 %.3e"
                % (name, shape, params, ["%.2e" % e for e in errs],
                   CONV_F32_TOL, tf32))
            if not max(errs) <= CONV_F32_TOL:
                raise SystemExit("conv f32 check: %s in float32 is off by "
                                 "%s" % (name, errs))
    finally:
        torch.backends.cudnn.allow_tf32 = old
    # cuDNN takes TF32 only where its heuristics pick a tensor-core
    # algorithm (not for the 21-channel upscore): at least one raw call
    # must miss the bar, or the check could not tell the two apart
    if not max(c["tf32_raw_err_y"] for c in out) > CONV_F32_TOL:
        raise SystemExit("conv f32 check: no raw TF32 call misses the bar, "
                         "so the check does not separate them")
    return out


def grads_f64(t, batch):
    """The gradients and aux updates of trainer ``t``'s training step on
    ``batch`` with every floating argument in float64 (through the
    symbol's graph function; the trainer itself computes in float32 or
    bf16), as float32 host tensors."""
    dev = t.shard_batch(batch)
    leaves = {n: p.detach().double().requires_grad_()
              for n, p in t.params.items()}
    args = [leaves[n] if n not in dev else
            dev[n].double() if dev[n].is_floating_point() and
            "label" not in n else dev[n] for n in t.arg_names]
    fn = mx.executor._build_graph_fn(t.symbol)
    with torch.enable_grad():
        outs, new_aux = fn(args, [t.aux[n] for n in t.aux_names], None, True)
        grads = torch.autograd.grad(
            outs, [leaves[n] for n in t.param_names],
            [torch.ones_like(o) for o in outs], allow_unused=True)
    return ({n: (torch.zeros_like(leaves[n]) if g is None else g).float()
             .cpu() for n, g in zip(t.param_names, grads)},
            {n: a.detach().float().cpu()
             for n, a in zip(t.aux_names, new_aux)})


def card_cpu_check(label, build, shapes, batch, trainer_kw=None,
                   init=None):
    """One `SPMDTrainer.forward` and one `gradients` of ``build()`` in
    float32 on the card (``cudnn.allow_tf32 = True`` around it) and on the
    CPU from the card's initial parameters (`init.Load`), at ``shapes``:
    forward outputs within CONV_FWD_TOL of their largest, the moving
    statistics after the gradient step within CONV_AUX_TOL (or twice their
    CPU thread spread), and every gradient within the larger of GRAD_TOL
    and CONV_SPREAD_MULT times the network's CPU thread spread, of its
    largest.  The thread spread is measured by the same CPU trainer on
    CONV_SPREAD_THREADS threads and in float64 (`grads_f64`) against the
    float32 one on all threads, and by the card's float32 gradients
    against its own float64 ones.  A parameter whose float64 gradient is
    below 1e-4 of the model's largest (a convolution's bias before a
    BatchNorm, zero in exact arithmetic: both devices compute rounding
    noise there) is left out of the network's spread and held against
    the model's largest gradient, as the LM's key biases are.  The card's
    bf16 gradients' distance is printed beside."""

    def trainer(ctx, initializer, dtype="float32"):
        mx.random.seed(0)
        return mx.SPMDTrainer(build(), data_shapes=shapes, ctx=ctx,
                              dtype=dtype, initializer=initializer,
                              **(trainer_kw or {}))

    def run(t):
        fwd = [o.float().cpu() for o in t.forward(batch)]
        grads = {n: g.float().cpu() for n, g in t.gradients(batch).items()}
        return fwd, grads, {n: a.float().cpu() for n, a in t.aux.items()}

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        t = trainer(None, init() if init else None)
        start = {n: p.detach().cpu().numpy() for n, p in t.params.items()}
        aux0 = dict(t.aux)
        card = run(t)
        t.aux = aux0
        card64 = grads_f64(t, batch)
        del t
        card16 = run(trainer(None, mx.init.Load(start), "bfloat16"))
        card_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = old
    threads = torch.get_num_threads()
    t0 = time.perf_counter()
    t = trainer("cpu", mx.init.Load(start))
    aux0 = dict(t.aux)
    cpu = run(t)
    spread_runs = {}
    try:
        for n in CONV_SPREAD_THREADS:
            if n < threads:
                torch.set_num_threads(n)
                t.aux = dict(aux0)
                spread_runs[n] = run(t)
    finally:
        torch.set_num_threads(threads)
    t.aux = dict(aux0)
    spread_runs["f64"] = (None,) + grads_f64(t, batch)
    del t
    cpu_s = time.perf_counter() - t0

    def dist(a, b):
        return float((a.double() - b.double()).abs().max())

    fwd_err = max(dist(a, b) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(card[0], cpu[0]))
    gmax = max(float(g.abs().max()) for g in cpu[1].values())
    noise = sorted(n for n, g in spread_runs["f64"][1].items()
                   if float(g.abs().max()) < 1e-4 * gmax)
    size = {n: gmax if n in noise else max(float(g.abs().max()), 1e-30)
            for n, g in cpu[1].items()}
    own = {n: max(dist(r[1][n], g) for r in spread_runs.values())
           for n, g in cpu[1].items()}
    # the card's own rounding: its float32 gradients against its float64
    card_own = max([dist(card[1][n], card64[0][n]) / size[n]
                    for n in size if n not in noise] or [0.0])
    spread = max([own[n] / size[n] for n in size if n not in noise]
                 + [card_own])
    bar = {n: max(max(GRAD_TOL, CONV_SPREAD_MULT * spread) * size[n],
                  CONV_SPREAD_MULT * own[n]) for n in size}
    ratio = {n: dist(card[1][n], g) / bar[n] for n, g in cpu[1].items()}
    worst = max(ratio, key=ratio.get)
    g16 = max(dist(card16[1][n], g) / size[n] for n, g in cpu[1].items()
              if n not in noise)
    aux_size = {n: max(float(a.abs().max()), 1e-30)
                for n, a in cpu[2].items()}
    aux_err = max([dist(card[2][n], a) / aux_size[n]
                   for n, a in cpu[2].items()] or [0.0])
    aux_spread = max([dist(r[2][n], a) / aux_size[n]
                      for r in spread_runs.values()
                      for n, a in cpu[2].items()] or [0.0])
    aux_bar = max(CONV_AUX_TOL, CONV_SPREAD_MULT * aux_spread)
    res = {"config": label, "shapes": shapes, "params": len(size),
           "forward_err": fwd_err, "forward_tol": CONV_FWD_TOL,
           "cpu_threads": threads,
           "spread_runs": sorted(str(k) for k in spread_runs),
           "rounding_spread": spread, "card_f32_vs_f64": card_own,
           "zero_gradient_params": noise,
           "grad_bar_rel": max(GRAD_TOL, CONV_SPREAD_MULT * spread),
           "worst_grad_param": worst,
           "worst_grad_err_rel": dist(card[1][worst], cpu[1][worst])
           / size[worst], "worst_grad_err_over_bar": ratio[worst],
           "aux_err": aux_err, "aux_spread": aux_spread, "aux_bar": aux_bar,
           "worst_bf16_grad_err": g16, "card_s": card_s, "cpu_s": cpu_s,
           "per_param_err_rel": {n: dist(card[1][n], g) / size[n]
                                 for n, g in cpu[1].items()}}
    log("card vs CPU (%s, data %s): forward max |d|/max %.3e (tol %.0e); "
        "CPU runs on %s threads and in float64 against %d threads, and "
        "the card's float32 against its float64 (%.3e), part by up to "
        "%.3e of a gradient's largest (%d parameters of zero gradient "
        "held against the largest), so gradients "
        "are held to %.3e; worst %s at %.3e (%.3f of its bar); moving "
        "statistics %.3e (spread %.3e, bar %.3e); bf16 gradients %.3e; "
        "card %.1f s, CPU %.1f s"
        % (label, shapes["data"], fwd_err, CONV_FWD_TOL,
           sorted(k for k in spread_runs if k != "f64"), threads,
           card_own, spread, len(noise),
           res["grad_bar_rel"], worst, res["worst_grad_err_rel"],
           ratio[worst], aux_err, aux_spread, aux_bar, g16, card_s, cpu_s))
    if not (fwd_err <= CONV_FWD_TOL and ratio[worst] <= 1.0
            and aux_err <= aux_bar):
        raise SystemExit("%s: the card disagrees with the CPU" % label)
    return res


def resnet_grad_check():
    """ResNet-50 in the reference's default 'full' geometry (57/29/15/8)
    at batch 4, card against CPU (`card_cpu_check`)."""
    shapes = {"data": (4,) + RESNET["image_shape"], "softmax_label": (4,)}
    return card_cpu_check(
        "resnet50 full, batch 4",
        lambda: mx.models.get_resnet(
            **dict(RESNET, pooling_convention="full")), shapes,
        net_batch(shapes, "image", RESNET["num_classes"], seed=1),
        trainer_kw=RESNET_SGD)


def resnet_feedforward_path():
    """ResNet-50 through `FeedForward` as `examples/train_imagenet.py
    --trainer feedforward` runs it, on the card, float32: ms a batch (host
    clock between batch ends, each reading its metric back), images/s,
    the running cross-entropy finite."""
    mx.random.seed(0)
    rng = np.random.RandomState(0)
    n = FF_BATCH * FF_BATCHES
    X = rng.randn(n, *FF_IMAGE).astype(np.float32)
    y = rng.randint(0, 1000, n).astype(np.float32)
    model = mx.model.FeedForward(
        mx.models.get_resnet(num_classes=1000, num_layers=50),
        ctx=mx.gpu(0), num_epoch=1, optimizer="sgd", learning_rate=0.1,
        initializer=mx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
    ticks, ce = [], []

    def on_batch(p):
        ce.append(p.eval_metric.get()[1])
        ticks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model.fit(mx.io.NDArrayIter(X, y, batch_size=FF_BATCH), kvstore="device",
              eval_metric="ce", batch_end_callback=on_batch)
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    state = card_state()
    del model, X, y
    torch.cuda.empty_cache()
    batch_ms = [1e3 * b for b in np.diff([t0] + ticks)]
    ms = statistics.median(batch_ms[1:])
    res = {"config": dict(net="get_resnet(num_layers=50), 'full'",
                          batch=FF_BATCH, batches=FF_BATCHES,
                          dtype="float32", optimizer="sgd lr 0.1",
                          initializer="Xavier(gaussian, 2)",
                          kvstore="device", reduced="batch 256 -> 64",
                          source="examples/train_imagenet.py:77-97"),
           "fit_s": fit_s, "batch_ms": batch_ms, "ms_per_batch_median": ms,
           "images_per_s": FF_BATCH / (ms / 1e3), "cross_entropy": ce,
           "launches": launches, "max_memory_allocated": peak,
           "card_after": state}
    log("resnet50 FeedForward: %d batches of %d, float32, kvstore device, "
        "in %.2f s; ms a batch (host clock) %s; median of the last %d "
        "%.2f ms = %.1f images/s; running cross-entropy %s; "
        "max_memory_allocated %d B; card after %s"
        % (FF_BATCHES, FF_BATCH, fit_s, ["%.1f" % t for t in batch_ms],
           len(batch_ms) - 1, ms, res["images_per_s"],
           ["%.4f" % c for c in ce], peak, state))
    if len(ce) != FF_BATCHES or not all(math.isfinite(c) for c in ce):
        raise SystemExit("resnet50 FeedForward: a loss is not finite or a "
                         "batch is missing: %s" % ce)
    if any(launches.values()):
        raise SystemExit("resnet50 FeedForward: launched a kernel of the "
                         "table")
    return res


def _without_dropout(sym):
    """``sym`` with every Dropout at p = 0 (identity in training too)."""
    import re

    return mx.sym.loads(re.sub(r'"p": "[0-9.]+"', '"p": "0.0"',
                               sym.tojson()))


def other_net_path(name):
    """One of OTHER_NETS: its steps through `SPMDTrainer` on the card (the
    first a warm-up; step ms of the rest by CUDA events), the loss finite
    and no kernel of the table launched, then the card-vs-CPU check at
    its check size."""
    build, shapes, check_shapes, dtype, opt, init, steps, kind = \
        OTHER_NETS[name]
    classes = {"image": 1000, "lstm": 64, "pixels": 21}[kind]
    mx.random.seed(0)
    trainer = mx.SPMDTrainer(build(), data_shapes=shapes, dtype=dtype,
                             initializer=init(), **opt)
    dev = trainer.shard_batch(net_batch(shapes, kind, classes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        outs = trainer.step(dev)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(head_nll(outs[0], dev["softmax_label"], kind))
        del outs
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    del trainer, dev
    torch.cuda.empty_cache()
    log("%s: %d steps, %s, shapes %s: step ms %s, mean NLL %s, "
        "max_memory_allocated %d B"
        % (name, steps, dtype, shapes["data"], ["%.2f" % t for t in step_ms],
           ["%.4f" % x for x in losses], peak))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit("%s: a loss is not finite: %s" % (name, losses))
    if any(launches.values()):
        raise SystemExit("%s: launched a kernel of the table" % name)
    check_build, check_init = build, init
    if kind == "pixels":
        check_build = lambda: _without_dropout(build())  # noqa: E731
        check_init = lambda: mx.init.Xavier(magnitude=2.0)  # noqa: E731
    check = card_cpu_check(name, check_build, check_shapes,
                           net_batch(check_shapes, kind, classes, seed=1),
                           trainer_kw=opt, init=check_init)
    return {"shapes": shapes, "dtype": dtype, "optimizer": opt,
            "steps": steps, "step_ms": step_ms, "losses": losses,
            "launches": launches, "max_memory_allocated": peak,
            "check": check}


# Phase 21, image records: `examples/train_imagenet.py`'s feedforward
# path fed from a RecordIO pack (:77-82), at phase 17's settings; the
# records stored at ImageNet's usual 3x256x256 and cut to data_shape
# (3, 224, 224) by the random crop, with random mirrors
REC_N = 512  # one epoch of 8 batches of 64
REC_SHAPE = (3, 256, 256)
REC_JPEG_N = 64
# the card's augmented batch against the CPU's from the same seed: crops
# and mirrors move whole pixels (bit for bit); the affine warp differs in
# float32 rounding (cos/sin, a reciprocal for a division by a scalar on
# the card), ~1e-5 of max|ref| on noise images, held to 1e-4.  The HSL
# pass divides by vmax - vmin: a pixel within rounding of grey gets its
# hue from the rounding, and the saturation jitter then shows it, up to
# ~15 of 255 between float32 and float64 on the CPU alone (on the
# 3x256x256 noise records here).  So with the HSL pass the card is held
# by how many elements stray past 1e-4 of max|ref| from the same batch
# augmented in float64: no more than twice the CPU float32's, plus 16.
AUG_TOL = 1e-4


class _DeviceWatch(mx.io.DataIter):
    """Pass ``inner``'s batches through, noting each data tensor's device
    before the training loop stages or copies it."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.batch_size = inner.batch_size
        self.devices = []

    @property
    def provide_data(self):
        return self.inner.provide_data

    @property
    def provide_label(self):
        return self.inner.provide_label

    def reset(self):
        self.inner.reset()

    def next(self):
        batch = self.inner.next()
        self.devices.append(str(batch.data[0].data.device))
        return batch


def _random_workload(num_vars=20, num_ops=200, seed=0):
    """`tests/test_engine.py:13-25`: each op reads some vars and writes
    others."""
    import random

    rng = random.Random(seed)
    ops = []
    for i in range(num_ops):
        reads = rng.sample(range(num_vars), rng.randint(0, 3))
        writes = rng.sample(range(num_vars), rng.randint(1, 2))
        writes = [w for w in writes if w not in reads]
        if writes:
            ops.append((i, reads, writes))
    return ops


def _engine_run(engine, ops, num_vars):
    """`tests/test_engine.py:37-56`: push every op, wait for all."""
    mem = [0] * num_vars
    vars_ = [engine.new_variable() for _ in range(num_vars)]

    def make_fn(i, reads, writes):
        def fn():
            s = sum(mem[r] for r in reads)
            time.sleep(0.0001 * (i % 3))  # jitter to expose races
            for w in writes:
                mem[w] = mem[w] * 2 + s + i + 1
        return fn

    for i, reads, writes in ops:
        engine.push(make_fn(i, reads, writes),
                    const_vars=[vars_[r] for r in reads],
                    mutable_vars=[vars_[w] for w in writes])
    engine.wait_for_all()
    return mem


def engine_checks():
    """Phase 21 (e): the threaded, naive and native engines on the JAX
    package's random workload (20 vars, seeds 0-2) against serial
    execution; ops/s of each."""
    from mxnet_tpu_torch import engine as eng

    out = {}
    for name, make in (("ThreadedEngine", lambda: eng.Engine(4)),
                       ("NaiveEngine", eng.NaiveEngine),
                       ("NativeEngine", lambda: eng.NativeEngine(4))):
        n_ops, secs, same = 0, 0.0, True
        for seed in (0, 1, 2):
            ops = _random_workload(seed=seed)
            serial = [0] * 20
            for i, reads, writes in ops:
                t = sum(serial[r] for r in reads)
                for w in writes:
                    serial[w] = serial[w] * 2 + t + i + 1
            engine = make()
            t0 = time.perf_counter()
            got = _engine_run(engine, ops, 20)
            secs += time.perf_counter() - t0
            engine.shutdown()
            same &= got == serial
            n_ops += len(ops)
        out[name] = {"ops": n_ops, "seconds": secs,
                     "ops_per_s": n_ops / secs, "matches_serial": same}
        log("engine %s: %d ops over 3 seeds in %.3f s = %.0f ops/s "
            "(each op sleeps 0-0.2 ms, as the JAX test's do), serial "
            "result %s" % (name, n_ops, secs, n_ops / secs,
                           "matched" if same else "MISSED"))
        if not same:
            raise SystemExit("engine %s: result differs from serial" % name)
    return out


def _rows(it):
    """One epoch of ``it``: the valid rows of data and labels (pad cut),
    and the pads."""
    data, labels, pads = [], [], []
    for b in it:
        n = it.batch_size - b.pad
        data.append(b.data[0].data[:n].clone())
        labels.append(b.label[0].data[:n].clone())
        pads.append(b.pad)
    it.reset()
    return torch.cat(data), torch.cat(labels), pads


def image_records_path(ff):
    """Phase 21: the native library, a RecordIO pack at ImageNet's record
    size, `ImageRecordIter` on its native and Python paths, augmentation
    on the card against the CPU, ResNet-50 through `FeedForward` from the
    pack beside phase 17's `NDArrayIter` run (``ff``), and the engines."""
    import shutil
    import tempfile

    from mxnet_tpu_torch import _native

    res = {}
    # (a) build and pack
    info = _native.build()
    res["build"] = info
    log("image records (a): g++ build of the native library %.2f s "
        "(built %s), libjpeg %s; %s"
        % (info["seconds"], info["built"],
           "found" if info["jpeg"] else "NOT found (jpeglib.h missing): "
           "the native loader decodes no JPEG on this machine",
           info["path"]))
    tmp = tempfile.mkdtemp(dir=os.environ.get("TMPDIR"))
    try:
        path = os.path.join(tmp, "train.rec")
        rng = np.random.RandomState(3)
        labels = rng.randint(0, 1000, REC_N)
        t0 = time.perf_counter()
        w = mx.recordio.MXRecordIO(path, "w")
        for i in range(REC_N):
            img = rng.randint(0, 256, REC_SHAPE, dtype=np.uint8)
            w.write(mx.recordio.pack_img((0, float(labels[i]), i, 0), img))
        w.close()
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        res["pack"] = {"records": REC_N, "shape": REC_SHAPE,
                       "payload": "uint8 CHW .npy", "bytes": nbytes,
                       "write_s": write_s}
        log("image records (a): %d records of uint8 %s .npy from "
            "RandomState(3), labels in [0, 1000): %d B in %.3f s (%.1f MB/s)"
            % (REC_N, "x".join(map(str, REC_SHAPE)), nbytes, write_s,
               nbytes / write_s / 1e6))
        if info["jpeg"]:
            from PIL import Image  # noqa: F401  (pack_img's JPEG encoder)

            jpath = os.path.join(tmp, "jpeg.rec")
            w = mx.recordio.MXRecordIO(jpath, "w")
            for i in range(REC_JPEG_N):
                img = rng.randint(0, 256, REC_SHAPE[1:] + (3,),
                                  dtype=np.uint8)
                w.write(mx.recordio.pack_img((0, float(i), i, 0), img,
                                             img_fmt=".jpg"))
            w.close()
            res["jpeg_pack"] = {"records": REC_JPEG_N,
                                "bytes": os.path.getsize(jpath)}
            log("image records (a): %d JPEG records with PIL: %d B"
                % (REC_JPEG_N, res["jpeg_pack"]["bytes"]))
        else:
            res["jpeg_pack"] = None
            log("image records (a): no JPEG records: libjpeg is not on "
                "this machine, so the native loader cannot decode them "
                "(a JPEG pack raises MXNetError naming libjpeg)")

        # (b) the native and Python paths, host only, one epoch each
        kw = dict(path_imgrec=path, data_shape=REC_SHAPE, batch_size=FF_BATCH)
        got, rates = {}, {}
        with mx.cpu():
            for name, native in (("native", True), ("python", False)):
                it = mx.io.ImageRecordIter(use_native=native,
                                           preprocess_threads=4, **kw)
                _rows(it)  # warm: first pass through the page cache
                t0 = time.perf_counter()
                got[name] = _rows(it)
                rates[name] = REC_N / (time.perf_counter() - t0)
                it.close()
            shards = {}
            for name, native in (("native", True), ("python", False)):
                parts = []
                for part in (0, 1):
                    it = mx.io.ImageRecordIter(use_native=native,
                                               part_index=part, num_parts=2,
                                               **kw)
                    parts.append(_rows(it))
                    it.close()
                shards[name] = (
                    torch.equal(torch.cat([parts[0][0], parts[1][0]]),
                                got[name][0])
                    and torch.equal(torch.cat([parts[0][1], parts[1][1]]),
                                    got[name][1]),
                    [len(p[1]) for p in parts])
        same = (torch.equal(got["native"][0], got["python"][0])
                and torch.equal(got["native"][1], got["python"][1])
                and got["native"][2] == got["python"][2])
        want = torch.as_tensor(labels.astype(np.float32))
        res["iterators"] = {
            "native_images_per_s": rates["native"],
            "python_images_per_s": rates["python"],
            "bit_for_bit": same,
            "labels_are_the_pack": torch.equal(got["native"][1], want),
            "pads": got["native"][2], "shards": shards}
        log("image records (b): one epoch, no augmentation, host only: "
            "native (preprocess_threads 4) %.1f images/s, Python %.1f "
            "images/s; batches, labels and pads bit for bit %s; two "
            "shards cover the pack once each, in order: native %s, "
            "Python %s (records %s / %s)"
            % (rates["native"], rates["python"], same, shards["native"][0],
               shards["python"][0], shards["native"][1],
               shards["python"][1]))
        if not (same and res["iterators"]["labels_are_the_pack"]
                and shards["native"][0] and shards["python"][0]):
            raise SystemExit("image records (b): the paths or shards differ")

        # (c) augmentation on the card against the CPU, one batch
        res["augment"] = {}
        with mx.cpu():
            it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=REC_SHAPE,
                                       batch_size=FF_BATCH)
            raw = it.next().data[0].data  # the records the batch augments
            it.close()
        warp = dict(max_rotate_angle=10, max_shear_ratio=0.1,
                    max_random_scale=1.1, min_random_scale=0.9)
        hsl = dict(random_h=10, random_s=20, random_l=20)
        for name, extra in (("crop_mirror_scale", dict(scale=1 / 255)),
                            ("affine", warp),
                            ("affine_hsl", dict(warp, **hsl))):
            akw = dict(path_imgrec=path, data_shape=FF_IMAGE,
                       record_shape=REC_SHAPE, batch_size=FF_BATCH,
                       rand_crop=True, rand_mirror=True, **extra)
            it = mx.io.ImageRecordIter(**akw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = it.next().data[0].data
            torch.cuda.synchronize()
            card_ms = 1e3 * (time.perf_counter() - t0)
            it.close()
            with mx.cpu():
                it = mx.io.ImageRecordIter(**akw)
                t0 = time.perf_counter()
                cpu = it.next().data[0].data
                cpu_ms = 1e3 * (time.perf_counter() - t0)
                aug = it._augmenter
                it.close()
            card = card.cpu()
            scale = float(cpu.abs().max())
            diff = (card - cpu).abs()
            entry = {"max_abs_err": float(diff.max()),
                     "rel_err": float(diff.max()) / scale,
                     "elements_differing": int((diff > 0).sum()),
                     "elements": diff.numel(), "card_ms": card_ms,
                     "cpu_ms": cpu_ms}
            if name == "crop_mirror_scale":
                ok = entry["max_abs_err"] == 0
                bar = "bit for bit"
            else:
                # the same draws, warped and jittered in float64 on the CPU:
                # how far float32 rounding alone moves this batch
                ref = aug._augment(raw.double(), mx.random.fold_in(aug._key, 1),
                                   FF_IMAGE[1:]).float()
                tau = AUG_TOL * scale
                n_card = int(((card - ref).abs() > tau).sum())
                n_cpu = int(((cpu - ref).abs() > tau).sum())
                entry.update(
                    beyond_bar_card_vs_cpu=int((diff > tau).sum()),
                    beyond_bar_card_vs_f64=n_card,
                    beyond_bar_cpu_vs_f64=n_cpu,
                    rel_err_card_vs_f64=float((card - ref).abs().max())
                    / scale,
                    rel_err_cpu_vs_f64=float((cpu - ref).abs().max()) / scale)
                if name == "affine":
                    ok = entry["rel_err"] <= AUG_TOL
                    bar = "max |d| <= %g of max|ref|" % AUG_TOL
                else:
                    ok = n_card <= 2 * n_cpu + 16
                    bar = ("elements past %g of max|ref| from float64 <= 2 x "
                           "the CPU float32's + 16" % AUG_TOL)
            entry["bar"] = bar
            res["augment"][name] = entry
            log("image records (c) %s: batch %s on the card vs the CPU from "
                "the same seed: max |d| %.4g = %.4g of max|ref|, %d of %d "
                "elements differ%s [bar: %s]; one batch (read + augment) "
                "%.1f ms on the card, %.1f ms on the CPU"
                % (name, tuple(card.shape), entry["max_abs_err"],
                   entry["rel_err"], entry["elements_differing"],
                   entry["elements"],
                   "" if name == "crop_mirror_scale" else
                   "; past %g of max|ref|: card vs CPU %d, card vs float64 "
                   "%d, CPU vs float64 %d (max %.4g and %.4g of max|ref|)"
                   % (AUG_TOL, entry["beyond_bar_card_vs_cpu"],
                      entry["beyond_bar_card_vs_f64"],
                      entry["beyond_bar_cpu_vs_f64"],
                      entry["rel_err_card_vs_f64"],
                      entry["rel_err_cpu_vs_f64"]),
                   bar, card_ms, cpu_ms))
            if not ok:
                raise SystemExit("image records (c) %s: card vs CPU fails "
                                 "its bar (%s)" % (name, bar))

        # (d) ResNet-50 through FeedForward from the pack
        mx.random.seed(0)
        it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=FF_IMAGE,
                                   record_shape=REC_SHAPE,
                                   batch_size=FF_BATCH, rand_crop=True,
                                   rand_mirror=True, preprocess_threads=4)
        watch = _DeviceWatch(it)
        model = mx.model.FeedForward(
            mx.models.get_resnet(num_classes=1000, num_layers=50),
            ctx=mx.gpu(0), num_epoch=1, optimizer="sgd", learning_rate=0.1,
            initializer=mx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
        ticks, ce, wait_frac = [], [], []
        reg = mx.telemetry.registry()

        def on_batch(p):
            ce.append(p.eval_metric.get()[1])
            wait_frac.append(reg._gauges.get("io.input_wait_frac"))
            ticks.append(time.perf_counter())

        mx.telemetry.reset()
        reg = mx.telemetry.registry()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        model.fit(watch, kvstore="device", eval_metric="ce",
                  batch_end_callback=on_batch)
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        waits = list(reg._hists.get("io.device_wait_ms", []))
        host_waits = list(reg._hists.get("io.wait_ms", []))
        failures = it.decode_failures
        it.close()
        del model
        torch.cuda.empty_cache()
        batch_ms = [1e3 * b for b in np.diff([t0] + ticks)]
        ms = statistics.median(batch_ms[1:])
        res["resnet50_feedforward"] = {
            "config": dict(net="get_resnet(num_layers=50), 'full'",
                           batch=FF_BATCH, batches=REC_N // FF_BATCH,
                           dtype="float32", optimizer="sgd lr 0.1",
                           initializer="Xavier(gaussian, 2)",
                           kvstore="device",
                           data="ImageRecordIter, 3x256x256 records, "
                                "rand_crop to 3x224x224, rand_mirror",
                           reduced="batch 256 -> 64; 512 synthetic records",
                           source="examples/train_imagenet.py:77-97"),
            "fit_s": fit_s, "batch_ms": batch_ms,
            "ms_per_batch_median": ms, "images_per_s": FF_BATCH / (ms / 1e3),
            "phase17_images_per_s": ff["images_per_s"],
            "phase17_ms_per_batch_median": ff["ms_per_batch_median"],
            "cross_entropy": ce, "io.device_wait_ms": waits,
            "io.wait_ms": host_waits, "io.input_wait_frac": wait_frac,
            "data_devices": watch.devices, "decode_failures": failures,
            "launches": launches}
        log("image records (d): ResNet-50 FeedForward from the pack, %d "
            "batches of %d, float32, kvstore device, in %.2f s; ms a batch "
            "(host clock) %s; median of the last %d %.2f ms = %.1f "
            "images/s, beside phase 17's NDArrayIter %.2f ms = %.1f "
            "images/s; io.device_wait_ms %s; io.wait_ms %s; "
            "io.input_wait_frac by batch %s; running cross-entropy %s; "
            "data on %s before staging; decode_failures %d"
            % (len(batch_ms), FF_BATCH, fit_s,
               ["%.1f" % t for t in batch_ms], len(batch_ms) - 1, ms,
               FF_BATCH / (ms / 1e3), ff["ms_per_batch_median"],
               ff["images_per_s"], ["%.2f" % t for t in waits],
               host_waits or "not recorded (no PrefetchingIter on this "
               "path)", ["%.3f" % f if f is not None else None
                         for f in wait_frac],
               ["%.4f" % c for c in ce], sorted(set(watch.devices)),
               failures))
        if (len(ce) != REC_N // FF_BATCH
                or not all(math.isfinite(c) for c in ce)):
            raise SystemExit("image records (d): a loss is not finite or a "
                             "batch is missing: %s" % ce)
        if set(watch.devices) != {"cuda:0"} or failures:
            raise SystemExit("image records (d): data on %s, %d decode "
                             "failures" % (set(watch.devices), failures))
        if any(launches.values()):
            raise SystemExit("image records (d): launched a kernel of the "
                             "table")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) the host engines
    res["engines"] = engine_checks()
    return res


# -- phase 22: head 256 and the rematerialization pins ----------------------

# Gemma-2B's attention widths (its published config: embed 2048, 8 heads
# of 256, ffn 16384, no biases), cut from its 18 layers to 2, at the
# repo's training vocabulary (32768, not Gemma's 256000) and S = 2048
HEAD256 = dict(vocab_size=32768, seq_len=2048, num_layers=2, num_embed=2048,
               num_heads=8, num_ffn_hidden=16384, use_bias=False,
               attn_layout="bhsd")
HEAD256_BATCH = 4
# the settings of phase 22 (d), and the flash forward's launches a step
# each should give, in layers: once where the policy keeps the kernel's
# out and lse (attn_out), twice where the backward recomputes it (a flash
# launch is not a matrix product to `dots`)
REMAT_SETTINGS = (("none", {}),
                  ("dots", {"MXNET_BACKWARD_MIRROR_POLICY": "dots"}),
                  ("attn", {"MXNET_BACKWARD_MIRROR_POLICY": "attn"}),
                  ("streams", {"MXNET_BACKWARD_MIRROR_POLICY": "streams"}),
                  ("nothing", {"MXNET_BACKWARD_MIRROR_POLICY": "nothing"}),
                  ("block", {"MXNET_BACKWARD_MIRROR_STEP": "block"}))
REMAT_FLASH = {"none": 1, "dots": 2, "attn": 1, "streams": 1, "nothing": 2,
               "block": 2}
# the parity configuration's peak memory without remat, in an earlier
# run of phase 6 (`PERF.md`, run 11E), printed beside this run's
NONE_PEAK_RUN_11E = 17328565248


def head256_kernel_checks():
    """The four flash kernels at head 256 on every route, at the training
    shape of phase 22 (B 4, H 8, S 2048, causal), timed beside SDPA, in
    both dtypes; the checks at 256 and at 160 and 192 padded to it are
    phase 2's (`width_checks`)."""
    gen = torch.Generator(device="cuda").manual_seed(22)
    cases = []
    for layout in FLASH_LAYOUTS:
        for dtype in (torch.bfloat16, torch.float32):
            cases += flash_train_case(layout, HEAD256_BATCH,
                                      HEAD256["num_heads"], 256, dtype, gen,
                                      sq=HEAD256["seq_len"],
                                      skv=HEAD256["seq_len"])
    for c in cases:
        log(describe(c))
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("head-256 kernel checks failed: %s" % bad)
    return cases


def head256_paths():
    """The head-256 LM trained on the card: 3 bf16 steps in each attention
    layout with exact launches (2L+1 LayerNorm each way; L flash forward,
    dq and dk/dv on the layout's route; no padded call), and one f32 step's
    gradients at batch 1 against the plain path."""
    layers = HEAD256["num_layers"]
    per_layer = {"layer_norm": 2 * layers + 1,
                 "layer_norm_bwd": 2 * layers + 1}
    out = {}
    for layout, name in (("bhsd", "flash_attention"),
                         ("bsd", "flash_attention_bsd")):
        out[layout] = train_path(
            "train head 256 %s" % layout, dict(HEAD256, attn_layout=layout),
            3, dict(per_layer, **{name + k: layers
                                  for k in ("", "_dq", "_dkv")}),
            batch=HEAD256_BATCH)
    out["gradients"] = grad_check(
        HEAD256, ("layer_norm_bwd", "flash_attention_dq",
                  "flash_attention_dkv"), "head 256 config", size=1)
    return out


def head256_serving():
    """Slot-cache serving of a 2-layer head-256 model in float32 (the
    float32 flash forward at D = 256 in every prefill): 4 requests of 32
    tokens, then each request's teacher-forced logits (one prefill of
    prompt and generated tokens, a row cut at each position) through the
    kernels against the plain float32 path, within ``LOGIT_TOL``."""
    cfg = {k: HEAD256[k] for k in ("vocab_size", "seq_len", "num_layers",
                                   "num_heads", "num_embed",
                                   "num_ffn_hidden", "use_bias")}
    model = TransformerKVModel(**cfg)
    params = model.params_from_jax(
        model.init_params(np.random.RandomState(0)), "cuda")
    engine = ServingEngine(model, params, max_batch=8, paged=False)
    t0 = time.perf_counter()
    warm = engine.warmup()
    warm_s = time.perf_counter() - t0
    log("head-256 slot engine: %s, warmup %.2f s" % (warm, warm_s))
    rng = np.random.RandomState(22)
    requests = [(rng.randint(0, model.vocab_size, size=int(n)).tolist(),
                 dict(max_new_tokens=32))
                for n in rng.randint(520, 1001, size=4)]
    reqs, res = serve(engine, requests)
    res["warmup_s"] = warm_s
    print_serving("head-256 slot path (f32)", res)
    if res["launches"]["flash_attention"] < 4 * model.num_layers or \
            res["launches"]["flash_attention_padded"]:
        raise SystemExit("the head-256 prefills did not run the head-256 "
                         "kernel: %s" % res["launches"])
    dev = params["embed_weight"].device
    checks = []
    for r in reqs:
        seq = list(r.prompt) + list(r.tokens[:-1])
        n = len(r.tokens)
        toks = torch.tensor([seq] * n, device=dev)
        length = torch.arange(len(r.prompt), len(r.prompt) + n, device=dev)
        got, _ = model.prefill(params, toks, length)
        ref = reference_logits(model, params, r.prompt, r.tokens)
        err = float((got.float() - ref).abs().max())
        checks.append({"request": r.id, "prompt_len": len(r.prompt),
                       "positions": n, "max_abs_err": err, "tol": LOGIT_TOL})
        log("head-256 logits request %d (prompt %d, %d positions): f32 "
            "kernel path vs plain f32 err %.3e (tol %.0e)"
            % (r.id, len(r.prompt), n, err, LOGIT_TOL))
        if not err <= LOGIT_TOL:
            raise SystemExit("head-256 served logits disagree with the "
                             "plain path")
    res["logit_checks"] = checks
    del engine, params
    torch.cuda.empty_cache()
    return res


def device_by_kind(device):
    """Device ms of a profiled window by kind of kernel: the flash
    kernels, LayerNorm's, matrix products (cuBLAS and CUTLASS names) and
    the rest (elementwise ops, copies, reductions, the fused CE head)."""
    out = {"flash": 0.0, "layer_norm": 0.0, "matmul": 0.0, "other": 0.0}
    for name, _, ms in device:
        low = name.lower()
        kind = "flash" if "flash_" in low else "layer_norm" if \
            low.startswith("ln_") else "matmul" if any(
                k in low for k in ("gemm", "nvjet", "xmma", "cutlass",
                                   "sm90_")) else "other"
        out[kind] += ms
    return out


def remat_path(steps=6):
    """The parity configuration in bf16 at batch 32 through `SPMDTrainer`
    under each of `REMAT_SETTINGS`: one step's gradients bit for bit the
    plain step's, the flash launches of that step as `REMAT_FLASH` says,
    then ``steps`` steps (their median ms and peak memory) and one
    profiled step (device busy ms by kind of kernel, beside ``none``'s,
    and the idle share); the peak must fall under ``attn`` and
    ``nothing``."""
    layers = PARITY["num_layers"]
    batch = lm_batch(TRAIN_BATCH, PARITY)
    ref, out = None, {}
    for label, pins in REMAT_SETTINGS:
        with pinned(**pins):
            trainer = lm_trainer(PARITY, TRAIN_BATCH, "bfloat16")
            dev = trainer.shard_batch(batch)
            torch.cuda.synchronize()
            reset_counts()
            grads = trainer.gradients(dev)
            torch.cuda.synchronize()
            launches = {k: n for k, n in read_counts().items() if n}
            if ref is None:
                ref = grads
            same = all(torch.equal(grads[k], ref[k]) for k in ref)
            del grads
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_ms = []
            for _ in range(steps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                trainer.step(dev)
                b.record()
                b.synchronize()
                step_ms.append(a.elapsed_time(b))
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.synchronize()
            wall, busy, device, host = profiled(lambda: trainer.step(dev))
            del trainer, dev
            torch.cuda.empty_cache()
        kinds = device_by_kind(device)
        rec = {"pins": pins, "bit_identical_to_none": same,
               "launches_one_step": launches, "step_ms": step_ms,
               "step_ms_median": statistics.median(step_ms),
               "max_memory_allocated": peak,
               "predicted_flash_forward": REMAT_FLASH[label] * layers,
               "profiled_step_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy,
               "device_idle_share": 1 - busy / wall,
               "device_ms_by_kind": kinds, "top_device_ops_ms": device[:12],
               "top_host_ops_ms": host}
        if "none" in out:
            base = out["none"]
            rec["recompute_device_ms"] = rec["device_busy_ms"] - \
                base["device_busy_ms"]
            rec["recompute_device_ms_by_kind"] = {
                k: kinds[k] - base["device_ms_by_kind"][k] for k in kinds}
        out[label] = rec
        log("remat %s %s: gradients bit for bit the plain step's: %s; one "
            "step's launches %s (flash forward predicted %d); step ms %s, "
            "median %.2f; max_memory_allocated %d B (none, run 11E: %d B); "
            "profiled step %.2f ms wall, device busy %.2f ms (idle share "
            "%.4f), busy ms by kind %s, over none's %s; top host ops (name, "
            "count, self ms) %s"
            % (label, pins, same, launches, rec["predicted_flash_forward"],
               ["%.2f" % t for t in step_ms], rec["step_ms_median"], peak,
               NONE_PEAK_RUN_11E, rec["profiled_step_ms"],
               rec["device_busy_ms"], rec["device_idle_share"],
               {k: round(v, 3) for k, v in kinds.items()},
               {k: round(v, 3) for k, v in
                rec.get("recompute_device_ms_by_kind", {}).items()},
               host[:6]))
        want = {"flash_attention": REMAT_FLASH[label] * layers,
                "flash_attention_dq": layers, "flash_attention_dkv": layers}
        if not same or any(launches.get(k) != n for k, n in want.items()):
            raise SystemExit("remat %s: bit for bit %s, launches %s, "
                             "expected %s" % (label, same, launches, want))
    for label in ("attn", "nothing"):
        if not out[label]["max_memory_allocated"] < \
                out["none"]["max_memory_allocated"]:
            raise SystemExit("remat %s: peak memory did not fall: %s"
                             % (label, {k: v["max_memory_allocated"]
                                        for k, v in out.items()}))
    return out


def memcost_net(depth, width):
    """`examples/memcost.py`'s `deep_net`, in the port."""
    x = mx.sym.Variable("data")
    for i in range(depth):
        x = mx.sym.Convolution(data=x, kernel=(3, 3), pad=(1, 1),
                               num_filter=width, name="conv%d" % i)
        x = mx.sym.Activation(data=x, act_type="relu", name="relu%d" % i)
    x = mx.sym.Pooling(data=x, pool_type="avg", kernel=(8, 8), name="gap")
    x = mx.sym.Flatten(data=x)
    x = mx.sym.FullyConnected(data=x, num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(data=x, name="softmax")


class _FlashFunction(torch.autograd.Function):
    """The flash forward and backward of `fam._forward` and `fam._backward`
    as a plain `torch.autograd.Function`, with no dispatcher: only to time
    the port's custom op ``mxt::flash_attention`` against it."""

    @staticmethod
    def forward(ctx, q, k, v, args, route, block):
        out, lse, res = fam._forward(q, k, v, args, True, route, block)
        ctx.save_for_backward(*res, lse)
        ctx.args, ctx.route, ctx.block = args, route, block
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, glse):
        *res, lse = ctx.saved_tensors
        grads = fam._backward(res, lse, g, glse, ctx.args, ctx.route,
                              ctx.block)
        return tuple(grads) + (None,) * 3


def flash_grad_call_ms(reps=40):
    """A differentiable flash call, forward and backward, through the
    port's custom op (`fam._flash_op`, what `flash_attention` calls once
    it has resolved the route) and through `_FlashFunction` (the same
    work with no dispatcher), in turns, bf16, causal, hsd: at
    the parity shape (32, 12, 1024, 64) and at (1, 1, 64, 64), where the
    host is all of it.  For each, the host's microseconds to issue one
    call (``reps`` calls, then one sync) and the ms a call with the
    device's work (a sync each call), medians of 5 rounds."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    args = (0, 0, 0.125, True)
    out = {}
    for label, shape in (("parity", (32, 12, 1024, 64)),
                         ("tiny", (1, 1, 64, 64))):
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        for t in (q, k, v):
            t.requires_grad_()

        def op():
            o = fam._flash_op(q, k, v, *args, "hsd", 0, "attn_out")[0]
            return torch.autograd.grad(o, (q, k, v), g)

        def fn():
            o, _ = _FlashFunction.apply(q, k, v, args, "hsd", 0)
            return torch.autograd.grad(o, (q, k, v), g)

        want = fn()
        if not all(torch.equal(a, b) for a, b in zip(op(), want)):
            raise SystemExit("flash op and Function differ at %s" % label)
        rounds = {"op": ([], []), "function": ([], [])}
        for _ in range(5):
            for name, f in (("op", op), ("function", fn)):
                for _ in range(3):
                    f()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    f()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                rounds[name][0].append(1e6 * (t1 - t0) / reps)
                t0 = time.perf_counter()
                for _ in range(reps):
                    f()
                    torch.cuda.synchronize()
                rounds[name][1].append(
                    1e3 * (time.perf_counter() - t0) / reps)
        res = {name: {"host_us_to_issue": statistics.median(h),
                      "ms_per_call_synced": statistics.median(m),
                      "rounds_host_us": h, "rounds_ms": m}
               for name, (h, m) in rounds.items()}
        res["op_minus_function_host_us"] = \
            res["op"]["host_us_to_issue"] - \
            res["function"]["host_us_to_issue"]
        out[label] = res
        log("flash call with gradient, %s %s bf16 causal: op %.1f us to "
            "issue, %.4f ms synced; Function %.1f us, %.4f ms; op - "
            "Function %.1f us a call"
            % (label, shape, res["op"]["host_us_to_issue"],
               res["op"]["ms_per_call_synced"],
               res["function"]["host_us_to_issue"],
               res["function"]["ms_per_call_synced"],
               res["op_minus_function_host_us"]))
    return out


MEMCOST_SETTINGS = (("plain", {"MXNET_BACKWARD_DO_MIRROR": "0"}),
                    ("mirror", {"MXNET_BACKWARD_DO_MIRROR": "1"}),
                    ("nothing", {"MXNET_BACKWARD_MIRROR_POLICY": "nothing"}))


def memcost_path(depth=24, width=64, batch=32, steps=6):
    """`examples/memcost.py` at its defaults through the port's
    `simple_bind` on the card, plain, with ``MXNET_BACKWARD_DO_MIRROR=1``
    (``dots``) and with ``MXNET_BACKWARD_MIRROR_POLICY=nothing``: float32
    with cuDNN's deterministic algorithms, the gradients of all three bit
    for bit, and each one's peak memory and ms a step (median of
    ``steps``).  The peak must fall under ``dots`` and ``nothing``."""
    out, ref = {}, None
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, pins in MEMCOST_SETTINGS:
            with pinned(**pins):
                exe = memcost_net(depth, width).simple_bind(
                    mx.gpu(0), grad_req="write", data=(batch, 3, 8, 8))
                rng = np.random.RandomState(0)
                for name, arr in exe.arg_dict.items():
                    if name not in ("data", "softmax_label"):
                        arr[:] = (rng.randn(*arr.shape) * 0.05).astype(
                            np.float32)
                exe.arg_dict["data"][:] = rng.randn(batch, 3, 8, 8).astype(
                    np.float32)
                exe.arg_dict["softmax_label"][:] = rng.randint(
                    0, 10, batch).astype(np.float32)
                exe.forward(is_train=True)
                exe.backward()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(steps):
                    t0 = time.perf_counter()
                    exe.forward(is_train=True)
                    exe.backward()
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                peak = torch.cuda.max_memory_allocated()
                grads = {n: g.data.clone() for n, g in exe.grad_dict.items()
                         if g is not None}
                del exe
                torch.cuda.empty_cache()
            if ref is None:
                ref = grads
            same = all(torch.equal(grads[k], ref[k]) for k in ref)
            ms = statistics.median(times)
            out[label] = {"pins": pins, "max_memory_allocated": peak,
                          "ms_per_step": ms, "step_ms": times,
                          "bit_identical_to_plain": same}
            log("memcost deep_net (depth %d, width %d, batch %d), %s: "
                "max_memory_allocated %d B, %.2f ms a step (median of %s), "
                "gradients bit for bit the plain bind's: %s"
                % (depth, width, batch, pins, peak, ms,
                   ["%.2f" % t for t in times], same))
            if not same:
                raise SystemExit("memcost %s: the gradients differ" % label)
    finally:
        torch.backends.cudnn.deterministic = saved
    for label in ("mirror", "nothing"):
        if not out[label]["max_memory_allocated"] < \
                out["plain"]["max_memory_allocated"]:
            raise SystemExit("memcost: the peak did not fall under %s: %s"
                             % (label, {k: v["max_memory_allocated"]
                                        for k, v in out.items()}))
    return out


# -- phase 23: wide heads and serving faults -----------------------------------

# the LM of phase 22 with 4 heads of 512: the wide kernels on a training
# path (2 of its layers, as phase 22 cuts it)
WIDE = dict(HEAD256, num_heads=4)
WIDE_BATCH = 2
# the timed wide shape: (batch, heads, sequence, head_dim), causal
WIDE_TIMED = (2, 8, 1024, 512)
# the kernels line's wide entries: (name, source, TPU function, counters,
# dtype); their launches are those of the wide-head LM's paths
WIDE_ROWS = [
    ("flash_attention_wide", "flash_attention_wide.cu",
     TPU + "flash_attention.py:155", ["flash_attention_wide"],
     torch.bfloat16),
    ("flash_attention_wide_bwd", "flash_attention_wide.cu",
     TPU + "flash_attention.py:372",
     ["flash_attention_wide_dq", "flash_attention_wide_dkv"],
     torch.bfloat16),
    ("flash_attention_wide_f32", "flash_attention_wide_f32.cu",
     TPU + "flash_attention.py:155", ["flash_attention_wide"],
     torch.float32),
    ("flash_attention_wide_bwd_f32", "flash_attention_wide_f32.cu",
     TPU + "flash_attention.py:372",
     ["flash_attention_wide_dq", "flash_attention_wide_dkv"],
     torch.float32),
]


def sdpa_backend(q, k, v, causal):
    """The backend `scaled_dot_product_attention` picks for these inputs
    (PyTorch's own choice, `torch._fused_sdp_choice`)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0,
                                              causal)).name


def wide_kernel_checks():
    """Phase 23 (a): the wide kernels against their plain versions at head
    widths 384 and 512 on every route and 320 (padded to 384) and 1024 on
    hsd, both dtypes, causal with both offsets and not, each twice bit
    for bit; then (2, 8, 1024, 1024, 512) causal timed in both dtypes
    beside SDPA, with the bound of the function and the bound of the work
    the kernels do (the score products recomputed once per column block
    of 128)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    cases = []
    plan = [(d, layout) for d in (384, 512) for layout in FLASH_LAYOUTS]
    plan += [(320, "bhsd"), (1024, "bhsd")]
    for d, layout in plan:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                cases.append(width_case(
                    d, dtype, layout, gen, heads=2, skv=333, causal=causal,
                    q_off=133 if causal else 24, k_off=20 if causal else 8))
    for c in cases:
        log(describe(c))
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("wide kernel checks failed: %s" % bad)
    b, h, s, d = WIDE_TIMED
    pairs = visible_pairs(s, s, True, 0, 0) * b * h
    ncb = d // 128
    for dtype in (torch.bfloat16, torch.float32):
        fwd, bwd = flash_train_case("bhsd", b, h, d, dtype, gen, sq=s, skv=s)
        q = torch.randn(b, h, s, d, device="cuda", dtype=dtype)
        backend = sdpa_backend(q, q, q, True)
        # the kernels' work: S (and dP) once per column block; the float32
        # dk/dv pass computes S^T in both of its warpgroups
        fwd_ops = (2 * d * ncb + 2 * d) * pairs
        bwd_ops = ((8 if dtype == torch.bfloat16 else 10) * d * ncb
                   + 6 * d) * pairs
        for rec, ops in ((fwd, fwd_ops), (bwd, bwd_ops)):
            nbytes = b * h * d * (2 * s + 2 * s) * q.element_size() * (
                1 if rec is fwd else 2)
            if dtype == torch.float32:
                rec["bound_recompute_ms"] = bound_ms(nbytes, 3 * ops, dtype,
                                                     PEAK_TF32)[0]
            else:
                rec["bound_recompute_ms"] = bound_ms(nbytes, ops, dtype)[0]
            rec["library_backend"] = backend
            log("%s | bound of the kernels' work (S recomputed for each of "
                "%d column blocks) %.5f ms; SDPA backend %s"
                % (describe(rec), ncb, rec["bound_recompute_ms"], backend))
        cases += [fwd, bwd]
        del q
    torch.cuda.empty_cache()
    return cases


def wide_paths():
    """Phase 23 (a): the wide-head LM (`WIDE`) trained on the card: 3 bf16
    steps with exact launches (2L+1 LayerNorm each way; L flash forward,
    dq and dk/dv, every one a wide launch), and one f32 step's gradients
    at batch 1 against the plain path (the float32 wide kernels)."""
    layers = WIDE["num_layers"]
    expect = {"layer_norm": 2 * layers + 1, "layer_norm_bwd": 2 * layers + 1}
    expect.update({"flash_attention" + k: layers for k in (
        "", "_dq", "_dkv", "_wide", "_wide_dq", "_wide_dkv")})
    out = {"bhsd": train_path("train wide heads (4 of 512)", WIDE, 3, expect,
                              batch=WIDE_BATCH)}
    out["gradients"] = grad_check(
        WIDE, ("layer_norm_bwd", "flash_attention_wide",
               "flash_attention_wide_dq", "flash_attention_wide_dkv"),
        "wide-head config", size=1)
    return out


# phase 23 (b) and (c): GPT-2 small in float32 under faults
FAULT_REQUESTS = 16
FAULT_NEW = 16


def fault_traffic(vocab, seed, n=FAULT_REQUESTS):
    """``n`` greedy requests of 16 to 199 prompt tokens and 16 new ones."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=int(m)).tolist(),
             dict(max_new_tokens=FAULT_NEW))
            for m in rng.randint(16, 200, size=n)]


def arm(engine, program, action, skip=0, n=1):
    """Engine ``engine``'s ``program`` ('prefill' or 'decode') runs
    ``action(engine)`` (which raises) in place of launches skip+1 ..
    skip+n."""
    name = {"prefill": "_prefill_chunk" if engine._paged else "_prefill_slot",
            "decode": "_decode"}[program]
    real = getattr(engine, name)
    seen = [0]

    def launch(*a):
        seen[0] += 1
        if skip < seen[0] <= skip + n:
            action(engine)
        return real(*a)
    setattr(engine, name, launch)


def poison(engine):
    raise RuntimeError("a poisoned launch raised before writing the cache")


def write_then_raise(engine):
    """A program that writes the cache in place and raises: its write mark
    set, NaN over the first usable block (paged) or slot (slot cache)."""
    engine.model._mark(engine._cache)
    engine._cache[:, :, 1 if engine._paged else 0] = float("nan")
    raise RuntimeError("the launch failed after writing the cache")


def cuda_error(engine):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


def serve_counted(engine, requests, thread=False):
    """Serve ``requests`` (all submitted at once) to the end, on the
    caller's thread or the engine's own; the requests and the serve.*
    telemetry counters of the run."""
    mx.telemetry.reset()
    reset_counts()
    reqs = [engine.submit(p, **kw) for p, kw in requests]
    if thread:
        engine.start()
        for r in reqs:
            try:
                r.result(timeout=300)
            except mx.serving.ServeError:
                pass
        engine.stop()
    else:
        engine.run_until_idle(timeout=600)
    torch.cuda.synchronize()
    counters = {k: v for k, v in mx.telemetry.registry()._counters.items()
                if k.startswith("serve.") and ".replica" not in k}
    return reqs, counters


def outcomes(reqs):
    return [None if r.error is None else type(r.error).__name__
            for r in reqs]


def fault_cases(model, params):
    """Phase 23 (b): GPT-2 small in f32 under scoped faults, paged and
    slot: a quarantined prefill, a write-then-raise decode, a ``CUDA
    error:`` that kills the engine, and ``MXNET_CHAOS=launch_error:0.2``;
    telemetry's counters are the record, tokens are held against a
    fault-free engine's under the 1e-3 margin rule."""
    out = {}
    requests = fault_traffic(model.vocab_size, 23)
    for paged in (True, False):
        mode = "paged" if paged else "slot"

        def engine():
            eng = ServingEngine(model, params, max_batch=8, paged=paged)
            eng.warmup()
            return eng
        clean, _ = serve_counted(engine(), requests)
        # one quarantined prefill: the third admission's launch raises
        # before it writes
        eng = engine()
        arm(eng, "prefill", poison, skip=2)
        reqs, counters = serve_counted(eng, requests)
        got = outcomes(reqs)
        ok = [i for i, o in enumerate(got) if o is None]
        parted = same_tokens("faults %s quarantine" % mode, model, params,
                             [requests[i] for i in ok],
                             [clean[i] for i in ok], [reqs[i] for i in ok])
        rec = {"outcomes": got, "counters": counters, "parted": parted,
               "leaked_blocks": eng.leaked_blocks(), "launches":
               {k: v for k, v in read_counts().items() if v}}
        log("faults %s quarantine: outcomes %s; counters %s; launches %s"
            % (mode, got, counters, rec["launches"]))
        if got != [None, None, "ServeQuarantined"] + [None] * (
                len(requests) - 3) or counters.get("serve.quarantined") != 1 \
                or eng._dead is not None or eng.leaked_blocks():
            raise SystemExit("faults %s: the quarantine was not scoped: %s"
                             % (mode, rec))
        out[mode + "_quarantine"] = rec
        # a decode that writes the cache and raises: the admitted requests
        # fail typed, the cache is rebuilt once, the queue is served
        eng = engine()
        arm(eng, "decode", write_then_raise, skip=2)
        reqs, counters = serve_counted(eng, requests)
        got = outcomes(reqs)
        lost = [i for i, o in enumerate(got) if o == "ServeCacheInvalidated"]
        ok = [i for i, o in enumerate(got) if o is None]
        parted = same_tokens("faults %s cache rebuild" % mode, model, params,
                             [requests[i] for i in ok],
                             [clean[i] for i in ok], [reqs[i] for i in ok])
        rec = {"outcomes": got, "counters": counters, "parted": parted,
               "leaked_blocks": eng.leaked_blocks(),
               "cache_finite": bool(torch.isfinite(eng._cache).all())}
        log("faults %s write-then-raise decode: %d invalidated, %d served; "
            "counters %s; leaked blocks %d; rebuilt cache finite %s"
            % (mode, len(lost), len(ok), counters, rec["leaked_blocks"],
               rec["cache_finite"]))
        if len(lost) != 8 or len(ok) != len(requests) - 8 or \
                counters.get("serve.cache_rebuilds") != 1 or \
                eng._dead is not None or eng.leaked_blocks() or \
                not rec["cache_finite"]:
            raise SystemExit("faults %s: the cache rebuild went wrong: %s"
                             % (mode, rec))
        out[mode + "_cache_rebuild"] = rec
        if not paged:
            continue
        # a CUDA error past out of memory is a dead device: the engine dies
        eng = engine()
        arm(eng, "decode", cuda_error, skip=1)
        reqs, counters = serve_counted(eng, requests, thread=True)
        got = outcomes(reqs)
        rec = {"outcomes": got, "counters": counters, "dead": eng._dead}
        log("faults paged CUDA error: outcomes %s; dead: %s; counters %s"
            % (sorted(set(got), key=str), eng._dead, counters))
        if set(got) != {"ServeEngineDead"} or "CUDA error" not in \
                str(eng._dead) or counters.get("serve.engine_failures") != 1:
            raise SystemExit("faults: the CUDA error did not kill the "
                             "engine: %s" % rec)
        out["cuda_error"] = rec
        # launch_error:0.2 over 16 requests: prefill hits quarantine their
        # request, decode hits retry (8 in a row would kill the engine)
        with pinned(MXNET_CHAOS="launch_error:0.2",
                    MXNET_SERVE_LAUNCH_RETRIES="8"):
            mx.chaos.reset()
            eng = engine()
            reqs, counters = serve_counted(eng, requests)
        mx.chaos.reset()
        got = outcomes(reqs)
        ok = [i for i, o in enumerate(got) if o is None]
        parted = same_tokens("faults launch_error", model, params,
                             [requests[i] for i in ok],
                             [clean[i] for i in ok], [reqs[i] for i in ok])
        rec = {"outcomes": got, "counters": counters, "parted": parted,
               "alive": eng._dead is None,
               "leaked_blocks": eng.leaked_blocks()}
        log("faults launch_error:0.2: outcomes %s; counters %s; scheduler "
            "alive %s" % (got, counters, rec["alive"]))
        if eng._dead is not None or set(got) - {None, "ServeQuarantined"} \
                or counters.get("serve.quarantined", 0) != got.count(
                    "ServeQuarantined") or eng.leaked_blocks():
            raise SystemExit("faults: launch_error was not scoped: %s" % rec)
        out["launch_error"] = rec
    return out


# each served program's launches of the table's kernels: LayerNorm 2L + 1
# in every program, the flash forward L in a slot-cache prefill
def expected_launches(engines, warmups, layers):
    """The LayerNorm and flash launches that ``engines`` (every engine
    object of a run) and ``warmups`` (the engines warmed inside the
    counted window) made: 2L + 1 LayerNorm per slot prefill, paged chunk,
    decode step and warmup program, L flash per slot prefill and slot
    warmup prefill."""
    programs = flash = 0
    for e in engines:
        prefills = e.stats["prefills"] if not e._paged else \
            e.stats["prefill_chunks"]
        programs += prefills + e.stats["decode_steps"]
        if not e._paged:
            flash += e.stats["prefills"]
    for e in warmups:
        programs += len(e.prefill_buckets) + len(e.decode_buckets)
        if not e._paged:
            flash += len(e.prefill_buckets)
    return {"layer_norm": (2 * layers + 1) * programs,
            "flash_attention": layers * flash}


def router_run(model, params, requests, spec=None, respawn=False,
               drain_after=None):
    """Two GPT-2 replicas (replica0 on the slot cache, whose prefills run
    the flash kernel; replica1 paged, where a migrated request's exact
    replay lands) under `ReplicaRouter`, ``requests`` submitted at once
    under ``MXNET_CHAOS=spec``; after a crash, the respawn awaited and 4
    tail requests served; with ``drain_after``, those requests again and
    replica0 drained mid-flight.  The counts are set to 0 after the
    warmups and read at the end."""
    fleet = [ServingEngine(model, params, max_batch=8, paged=False,
                           name="replica0"),
             ServingEngine(model, params, max_batch=8, name="replica1")]
    for e in fleet:
        e.warmup()
    router = ReplicaRouter(fleet, respawn=respawn)
    mx.telemetry.reset()
    seen = list(fleet)
    with pinned(**({"MXNET_CHAOS": spec} if spec else {})):
        mx.chaos.reset()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        router.start()
        try:
            reqs = [router.submit(p, **kw) for p, kw in requests]
            for r in reqs:
                try:
                    r.result(timeout=300)
                except mx.serving.ServeError:
                    pass
            wall = time.perf_counter() - t0
            tail, drained = [], []
            if spec:
                t1 = time.perf_counter()
                while mx.telemetry.registry().counter(
                        "serve.respawns").value < 1:
                    if time.perf_counter() - t1 > 120:
                        raise SystemExit("the dead replica never respawned")
                    time.sleep(0.05)
                tail = [router.submit(p, **kw) for p, kw in requests[:4]]
                for r in tail:
                    r.result(timeout=300)
            if drain_after:
                drained = [router.submit(p, **kw) for p, kw in drain_after]
                while not any(r.tokens for r in drained):
                    time.sleep(0.001)
                seen += [e for e in router.engines if e not in seen]
                router.drain("replica0", deadline_ms=1)
                for r in drained:
                    try:
                        r.result(timeout=300)
                    except mx.serving.ServeError:
                        pass
            seen += [e for e in router.engines if e not in seen]
        finally:
            router.stop()
        torch.cuda.synchronize()
    mx.chaos.reset()
    launches = read_counts()
    counters = {k: v for k, v in mx.telemetry.registry()._counters.items()
                if k.startswith("serve.")}
    # a migration replays only what the journal holds: a request moved
    # before its first token re-dispatches from the prompt (its event's
    # pos is 0), no replay
    replaying = sum(1 for e in mx.telemetry.registry().events("serve_migrate")
                    if e.get("pos"))
    warmed = [e for e in seen if e not in fleet]
    return {"requests": reqs, "tail": tail, "drained": drained,
            "wall_s": wall, "tokens": sum(len(r.tokens) for r in reqs),
            "counters": counters, "replaying_migrations": replaying,
            "launches": launches,
            "expected": expected_launches(seen, warmed, model.num_layers),
            "replicas_seen": len(seen),
            "leaked_blocks": [e.leaked_blocks() for e in router.engines]}


def failover_path(model, params):
    """Phase 23 (c): the router's failover on the card.  A fault-free run
    of 16 requests, then the same under ``engine_crash:6:replica0``
    (every request resolves, the migrated T = 0 requests give the
    fault-free tokens, one failover, a respawn, the tail served), then a
    drain of replica0 under load with no failure; exact LayerNorm and
    flash launches in each run."""
    requests = fault_traffic(model.vocab_size, 24)
    clean = router_run(model, params, requests)
    crash = router_run(model, params, requests, spec="engine_crash:6:replica0",
                       respawn=True, drain_after=requests)
    out = {}
    for label, run in (("fault-free", clean), ("engine_crash", crash)):
        got = outcomes(run["requests"] + run["tail"] + run["drained"])
        launched = {k: run["launches"][k] for k in run["expected"]}
        log("failover %s: %d requests, %d tokens in %.3f s = %.1f tok/s; "
            "outcomes %s; counters %s; launches %s (expected %s); leaked "
            "blocks %s" % (label, len(run["requests"]), run["tokens"],
                           run["wall_s"], run["tokens"] / run["wall_s"],
                           sorted(set(got), key=str), run["counters"],
                           launched, run["expected"], run["leaked_blocks"]))
        if set(got) != {None}:
            raise SystemExit("failover %s: a request failed: %s"
                             % (label, got))
        if launched != run["expected"] or any(run["leaked_blocks"]):
            raise SystemExit("failover %s: launches %s, expected %s; leaked "
                             "%s" % (label, launched, run["expected"],
                                     run["leaked_blocks"]))
        out[label] = {
            "wall_s": run["wall_s"], "tokens": run["tokens"],
            "tokens_per_s": run["tokens"] / run["wall_s"],
            "counters": run["counters"], "launches": run["launches"],
            "expected_launches": run["expected"],
            "replicas_seen": run["replicas_seen"]}
    c = crash["counters"]
    if c.get("serve.failovers") != 1 or c.get("serve.respawns", 0) < 1 or \
            c.get("serve.migrated", 0) < 1 or \
            c.get("serve.replays") != crash["replaying_migrations"]:
        raise SystemExit("failover: counters %s, migrations with tokens "
                         "to replay %d" % (c, crash["replaying_migrations"]))
    out["parted"] = same_tokens("failover migrated vs fault-free", model,
                                params, requests, clean["requests"],
                                crash["requests"])
    out["parted_drain"] = same_tokens("failover drained vs fault-free",
                                      model, params, requests,
                                      clean["requests"], crash["drained"])
    return out


def serving_faults_phase():
    """Phase 23 (b) and (c) on GPT-2 small in float32."""
    model = TransformerKVModel(**GPT2)
    params = model.params_from_jax(
        model.init_params(np.random.RandomState(0)), "cuda")
    out = {"faults": fault_cases(model, params),
           "failover": failover_path(model, params)}
    del params
    torch.cuda.empty_cache()
    return out


# -- phase 24: speculative and megastep serving -------------------------------

SPEC_K = 4
CARD = None


def card_name():
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, queried once."""
    global CARD
    if CARD is None:
        CARD = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    return CARD


def spec_traffic(vocab):
    """Phase 3's 16 prompts (the same draws: 32-768 tokens), 32 new
    tokens each, greedy but for four sampled at T=0.8, top_k 40."""
    rng = np.random.RandomState(0)
    lens = rng.randint(32, 769, size=16)
    out = []
    for i, n in enumerate(lens):
        prompt = rng.randint(0, vocab, size=int(n)).tolist()
        kw = dict(max_new_tokens=32, seed=i)
        if i % 4 == 1:
            kw.update(temperature=0.8, top_k=40)
        out.append((prompt, kw))
    return out


def draft_counts(engine):
    """A model drafter's (steps, prefill chunks) so far; (0, 0) for none."""
    d = engine._drafter
    return (getattr(d, "steps", 0), getattr(d, "prefill_chunks", 0))


def programs_run(engine, drafted=(0, 0)):
    """The programs ``engine`` ran, each 2L + 1 LayerNorm launches: its
    prefill chunks, decode steps, verifies and megastep steps, and its
    drafter's steps and prefill chunks since ``drafted``."""
    st = engine.stats
    steps, chunks = draft_counts(engine)
    return (st["prefill_chunks"] + st["decode_steps"] + st["verify_steps"]
            + st["megasteps"] * engine._mega_m + steps - drafted[0]
            + chunks - drafted[1])


def accept_rate(stats):
    return stats["spec_accepted"] / stats["spec_proposed"] \
        if stats["spec_proposed"] else None


def serve_mode(label, model, params, requests, kw, fault=None):
    """One engine of ``kw`` serving ``requests`` to the end (counts set to
    0 after its warmup) under ``MXNET_CHAOS=fault``, then drained: its
    requests and numbers, with the LayerNorm launches held to
    `programs_run`'s count."""
    engine = ServingEngine(model, params, max_batch=8, **kw)
    t0 = time.perf_counter()
    warm = engine.warmup()
    warm_s = time.perf_counter() - t0
    drafted = draft_counts(engine)
    with pinned(**({"MXNET_CHAOS": fault} if fault else {})):
        mx.chaos.reset()
        reqs, res = serve(engine, requests)
    mx.chaos.reset()
    stragglers = engine.drain()
    st = res["stats"] = dict(engine.stats)
    res.update(
        label=label, warmup=warm, warmup_s=warm_s,
        leaked_blocks=engine.leaked_blocks(),
        expected_layer_norm=(2 * model.num_layers + 1)
        * programs_run(engine, drafted),
        layer_norm_per_token=res["launches"]["layer_norm"]
        / res["generated_tokens"],
        accept_rate=accept_rate(st), chaos=fault)
    log("%s (%s): %d tokens in %.3f s = %.1f tok/s, ttft median %.1f ms p99 "
        "%.1f ms, LayerNorm launches %d (expected %d) = %.2f a generated "
        "token, accept rate %s (%d of %d; %d verifies, %d junk rounds), "
        "%d decode steps, %d megasteps (%d tokens, %d retired on the "
        "card), host_frac %s, max_memory_allocated %d B, leaked blocks %d"
        % (label, card_name(), res["generated_tokens"], res["wall_s"],
           res["tokens_per_s"], res["ttft_ms_median"], res["ttft_ms_p99"],
           res["launches"]["layer_norm"], res["expected_layer_norm"],
           res["layer_norm_per_token"],
           "none" if res["accept_rate"] is None
           else "%.4f" % res["accept_rate"], st["spec_accepted"],
           st["spec_proposed"], st["verify_steps"], st["spec_junk_rounds"],
           st["decode_steps"], st["megasteps"], st["megastep_tokens"],
           st["ingraph_retired"],
           "%.4f" % (st["host_s"] / st["wall_s"]) if st["wall_s"] else None,
           res["max_memory_allocated"], res["leaked_blocks"]))
    others = {k: n for k, n in res["launches"].items()
              if k != "layer_norm" and n}
    if stragglers or res["leaked_blocks"] or others or \
            res["launches"]["layer_norm"] != res["expected_layer_norm"]:
        raise SystemExit("%s: stragglers %d, leaked %d, LayerNorm %d "
                         "(expected %d), other launches %s"
                         % (label, len(stragglers), res["leaked_blocks"],
                            res["launches"]["layer_norm"],
                            res["expected_layer_norm"], others))
    del engine
    gc.collect()   # a drafter and its engine point at each other
    torch.cuda.empty_cache()
    return reqs, res


def step_profile(model, params, label, kw):
    """Scheduler steps of a full batch of 8 (64-token prompts): three
    timed on the host clock (ms a generated token), then one under the
    profiler (wall, device busy, idle share, tokens, device ops)."""
    engine = ServingEngine(model, params, max_batch=8, **kw)
    engine.warmup()
    rng = np.random.RandomState(2)
    for _ in range(8):
        engine.submit(rng.randint(0, model.vocab_size, size=64).tolist(),
                      max_new_tokens=40)
    for _ in range(3):
        engine.step()
    if len(engine._active) != 8:
        raise SystemExit("%s: the profiled batch did not fill" % label)
    torch.cuda.synchronize()
    tokens = engine.stats["tokens"]
    t0 = time.perf_counter()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    timed_ms = 1e3 * (time.perf_counter() - t0) / (engine.stats["tokens"]
                                                    - tokens)
    tokens = engine.stats["tokens"]
    wall, busy, device, _ = profiled(engine.step)
    tokens = engine.stats["tokens"] - tokens
    engine.run_until_idle(timeout=120)
    res = {"ms_per_token": timed_ms,
           "wall_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy,
           "device_idle_share": 1 - busy / wall if busy else None,
           "tokens": tokens, "device_ops": sum(n for _, n, _ in device),
           "wall_ms_per_token": 1e3 * wall / tokens,
           "top_device_ops_ms": device[:6]}
    log("steps, %s (%s): %.3f ms a generated token over 3 steps; one "
        "profiled: %.3f ms wall, device busy %.3f ms (idle share %s), %d "
        "tokens (%.3f ms a token), %d device ops; top device ops (name, "
        "count, ms): %s"
        % (label, card_name(), timed_ms, res["wall_ms"], res["device_busy_ms"],
           "not measured" if res["device_idle_share"] is None
           else "%.3f" % res["device_idle_share"], tokens,
           res["wall_ms_per_token"], res["device_ops"], device[:6]))
    del engine
    gc.collect()   # a drafter and its engine point at each other
    torch.cuda.empty_cache()
    return res


def sync_free_check(model, params):
    """A megastep (m=4) and a self-draft round (k=4) over 8 sampled rows
    enqueue under ``torch.cuda.set_sync_debug_mode("error")``: no host
    sync between their steps (the one fetch comes after)."""
    engine = ServingEngine(model, params, max_batch=8, spec=True,
                           spec_drafter="model", spec_k=SPEC_K,
                           megastep=True, megastep_steps=4)
    engine.warmup()
    token, pos, tables = engine._decode_inputs(8, [], [])
    left = engine._put(np.full((8,), 4, np.int64))
    eos = engine._put(np.full((8,), -1, np.int64))
    reqs = [mx.serving.ServeRequest([1], 4, temperature=0.8, top_k=40,
                                    seed=i) for i in range(8)]
    samp = engine._samp_device(reqs, 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grid = engine._megastep(token, pos, left, eos, tables, samp)
        drafts = engine._drafter._draft(token, pos, tables, samp)
        host, done = engine._to_host(grid)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    grid = engine._fetch(host, done)
    drafts = drafts.cpu().numpy()
    ok = grid.shape == (8, 4) and drafts.shape == (8, SPEC_K) and \
        (grid >= 0).all() and (drafts >= 0).all()
    log("no host sync (%s): a megastep m=4 and a draft round k=4 over 8 "
        "sampled rows enqueued under set_sync_debug_mode('error'); grid "
        "%s, drafts %s" % (card_name(), grid.shape, drafts.shape))
    if not ok:
        raise SystemExit("the sync-free megastep or draft gave %s, %s"
                         % (grid, drafts))
    del engine
    gc.collect()   # a drafter and its engine point at each other
    torch.cuda.empty_cache()
    return True


def consume(reqs):
    """Start a thread per request that collects its `stream()`."""
    got = [[] for _ in reqs]

    def run(r, out):
        for t in r.stream(timeout=300):
            out.append(t)
    threads = [threading.Thread(target=run, args=(r, g), daemon=True)
               for r, g in zip(reqs, got)]
    for t in threads:
        t.start()
    return threads, got


def check_streams(label, reqs, streamed, seen):
    """Each request's stream equals its ``on_token`` calls and its
    ``result()``: every token once, in order."""
    for r, a, b in zip(reqs, streamed, seen):
        if not (a == b == r.result(timeout=1)):
            raise SystemExit("%s: request %d streamed %d, on_token %d, "
                             "result %d tokens" % (label, r.id, len(a),
                                                   len(b), len(r.tokens)))


def stream_path(model, params, requests):
    """Four requests on a megastep engine's own thread, each streamed
    and called back."""
    engine = ServingEngine(model, params, max_batch=8, megastep=True,
                           megastep_steps=4)
    engine.warmup()
    engine.start()
    seen = [[] for _ in range(4)]
    t0 = time.perf_counter()
    reqs = [engine.submit(p, on_token=seen[i].append, **kw)
            for i, (p, kw) in enumerate(requests[:4])]
    threads, streamed = consume(reqs)
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if engine.drain():
        raise SystemExit("stream: drain left stragglers")
    check_streams("stream", reqs, streamed, seen)
    res = {"requests": 4, "tokens": sum(len(s) for s in streamed),
           "wall_s": wall, "leaked_blocks": engine.leaked_blocks()}
    log("stream (%s): 4 requests on the engine's thread, %d tokens "
        "streamed in %.3f s, each equal to its on_token calls and result(); "
        "leaked blocks %d" % (card_name(), res["tokens"], wall,
                              res["leaked_blocks"]))
    if res["leaked_blocks"]:
        raise SystemExit("stream: leaked blocks")
    return reqs, res


def stream_failover_path(model, params, requests):
    """Two megastep replicas (m=4) under `ReplicaRouter`, every request
    submitted through it with ``on_token`` and streamed, replica0 killed
    at its 3rd decode-bearing step with a megastep in flight."""
    fleet = [ServingEngine(model, params, max_batch=8, megastep=True,
                           megastep_steps=4, name="replica%d" % i)
             for i in range(2)]
    for e in fleet:
        e.warmup()
    router = ReplicaRouter(fleet, respawn=False)
    mx.telemetry.reset()
    seen = [[] for _ in requests]
    with pinned(MXNET_CHAOS="engine_crash:3:replica0"):
        mx.chaos.reset()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        router.start()
        try:
            reqs = [router.submit(p, on_token=seen[i].append, **kw)
                    for i, (p, kw) in enumerate(requests)]
            threads, streamed = consume(reqs)
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
        finally:
            router.stop()
        torch.cuda.synchronize()
    mx.chaos.reset()
    launches = read_counts()
    counters = {k: v for k, v in mx.telemetry.registry()._counters.items()
                if k.startswith("serve.") and ".replica" not in k}
    failed = [type(r.error).__name__ for r in reqs if r.error is not None]
    if failed or not fleet[0]._dead:
        raise SystemExit("stream failover: failed %s, replica0 dead %s"
                         % (failed, fleet[0]._dead))
    check_streams("stream failover", reqs, streamed, seen)
    # the dead replica's last megastep launched and was never fetched
    programs = sum(programs_run(e) for e in fleet) + fleet[0]._mega_m
    expected = (2 * model.num_layers + 1) * programs
    res = {"requests": len(reqs), "tokens": sum(len(s) for s in streamed),
           "wall_s": wall, "counters": counters, "launches": launches,
           "expected_layer_norm": expected,
           "leaked_blocks": fleet[1].leaked_blocks()}
    res["tokens_per_s"] = res["tokens"] / wall
    log("stream failover (%s): %d requests through ReplicaRouter, replica0 "
        "killed mid-megastep; %d tokens streamed in %.3f s = %.1f tok/s, "
        "each stream equal to its on_token calls and result(); counters "
        "%s; LayerNorm launches %d (expected %d); leaked blocks %d"
        % (card_name(), len(reqs), res["tokens"], wall, res["tokens_per_s"],
           counters, launches["layer_norm"], expected,
           res["leaked_blocks"]))
    if counters.get("serve.failovers") != 1 or \
            counters.get("serve.migrated", 0) < 1 or \
            launches["layer_norm"] != expected or res["leaked_blocks"]:
        raise SystemExit("stream failover: counters %s, LayerNorm %d "
                         "(expected %d), leaked %d"
                         % (counters, launches["layer_norm"], expected,
                            res["leaked_blocks"]))
    return reqs, res


SPEC_MODES = [
    ("plain", {}, None),
    ("spec ngram k=4", dict(spec=True, spec_drafter="ngram",
                            spec_k=SPEC_K), None),
    ("spec model k=4", dict(spec=True, spec_drafter="model",
                            spec_k=SPEC_K), None),
    ("spec model k=4, again", dict(spec=True, spec_drafter="model",
                                   spec_k=SPEC_K), None),
    ("spec model k=4, draft_junk:0.5", dict(spec=True, spec_drafter="model",
                                            spec_k=SPEC_K), "draft_junk:0.5"),
    ("megastep m=4", dict(megastep=True, megastep_steps=4), None),
    ("megastep m=8", dict(megastep=True, megastep_steps=8), None),
    ("spec ngram k=4 + megastep m=4", dict(
        spec=True, spec_drafter="ngram", spec_k=SPEC_K, megastep=True,
        megastep_steps=4), None),
]


def spec_megastep_phase():
    """Phase 24 on GPT-2 small in float32."""
    model = TransformerKVModel(**GPT2)
    params = model.params_from_jax(
        model.init_params(np.random.RandomState(0)), "cuda")
    requests = spec_traffic(model.vocab_size)
    runs, out = {}, {"card": card_name()}
    for label, kw, fault in SPEC_MODES:
        runs[label], out[label] = serve_mode(label, model, params, requests,
                                             kw, fault)
    plain = runs["plain"]
    for label, _, _ in SPEC_MODES[1:]:
        out[label]["parted"] = same_tokens(label + " vs plain", model,
                                           params, requests, plain,
                                           runs[label])
    a, b = (runs["spec model k=4"], runs["spec model k=4, again"])
    again = [out[k]["stats"] for k in ("spec model k=4",
                                       "spec model k=4, again")]
    keys = ("spec_accepted", "spec_proposed", "verify_steps")
    identical = [x.tokens for x in a] == [y.tokens for y in b] and \
        all(again[0][k] == again[1][k] for k in keys)
    rates = {k: out[k]["accept_rate"] for k in (
        "spec ngram k=4", "spec model k=4",
        "spec model k=4, draft_junk:0.5", "spec ngram k=4 + megastep m=4")}
    log("accept rates (%s): %s; self-draft bit for bit across two runs: %s"
        % (card_name(), rates, identical))
    if not identical:
        raise SystemExit("the model drafter differs between two runs")
    if not rates["spec model k=4"] >= 0.9:
        raise SystemExit("self-drafting accepts %.4f < 0.9 of its proposals"
                         % rates["spec model k=4"])
    if not out["spec model k=4, draft_junk:0.5"]["stats"][
            "spec_junk_rounds"]:
        raise SystemExit("draft_junk:0.5 corrupted no round")
    if not out["spec ngram k=4 + megastep m=4"]["stats"]["megasteps"]:
        raise SystemExit("speculation with megastep ran no megastep")
    out["accept_rates"] = rates
    out["self_draft_identical"] = identical
    out["sync_free"] = sync_free_check(model, params)
    out["profile"] = {
        "plain decode step": step_profile(model, params, "plain decode", {}),
        "megastep m=4": step_profile(model, params, "megastep m=4",
                                     dict(megastep=True, megastep_steps=4))}
    sreqs, out["stream"] = stream_path(model, params, requests)
    out["stream"]["parted"] = same_tokens(
        "stream vs plain", model, params, requests[:4], plain[:4], sreqs)
    freqs, out["stream_failover"] = stream_failover_path(model, params,
                                                         requests)
    out["stream_failover"]["parted"] = same_tokens(
        "stream failover vs plain", model, params, requests, plain, freqs)
    launches = {}
    for label, _, _ in SPEC_MODES:
        for k, n in out[label]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    for k, n in out["stream_failover"]["launches"].items():
        launches[k] += n
    out["launches"] = launches
    del params
    gc.collect()   # the router and its engines point at each other
    torch.cuda.empty_cache()
    return out


# -- phase 25: the host tier, sessions and quantization ---------------------

# the tight pool of the tier runs: the trash block, the shared prompt and
# one wave's 8 requests at the longest suffix (18 blocks each), with 16 to
# spare; FILLER_LEN-token prompts (63 blocks with their 16 new tokens)
# served one by one through it evict everything a wave parked
TIER_BLOCKS = 1 + SYSTEM_LEN // 16 + 8 * 18 + 16
FILLER_LEN = 992
FILLERS = 4
# the roomy pool, which never evicts in these runs
ROOMY_BLOCKS = 1024
TIER_HOST_BLOCKS = 1024
# the quantized modes of (c), each beside the f32 engine
QUANT_MODES = [
    ("w8 kv8", dict(quant="int8", kv_quant="int8")),
    ("w8", dict(quant="int8", kv_quant="0")),
    ("fp8", dict(quant="fp8", kv_quant="0")),
    ("kv8", dict(quant="0", kv_quant="int8")),
]
# the JAX package's parity gate (tests/test_serve_quant.py, for int8
# weights and K/V): the first decision's logit error relative to the
# oracle's largest logit, and the greedy streams' mean leading agreement.
# The int8 modes are held to it; fp8 weights (3 mantissa bits, up to
# 2**-4 of each weight) are measured and reported beside it, as the JAX
# package gates no fp8 run either
PARITY_REL_MAX = 0.05
PARITY_MATCH_MIN = 0.75
SESSIONS = 4
TURNS = 3


def tier_rounds(vocab):
    """The tier runs' traffic as rounds, each served to the end before
    the next: phase 4b's first shared-prefix request alone (its prefill
    registers the 512-token prompt), its next 7 together, FILLERS long
    unrelated prompts one by one (they evict, and with a tier spill,
    everything the first wave parked), then request 8 alone (a host hit:
    the prompt restored) and the last 7 together (device hits, the last
    the prompt alone: a full-cover bootstrap)."""
    system, requests = prefix_traffic(vocab)
    rng = np.random.RandomState(25)
    fillers = [(rng.randint(0, vocab, size=FILLER_LEN).tolist(),
                dict(max_new_tokens=16, seed=200 + i)) for i in range(FILLERS)]
    return system, requests, ([requests[:1], requests[1:8]]
                              + [[f] for f in fillers]
                              + [requests[8:9], requests[9:]])


def serve_rounds(engine, rounds, after=None):
    """Serve ``rounds`` in order (counts set to 0 first), ``after(i)``
    called after round i; the requests of every round, and the numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reqs = []
    t0 = time.perf_counter()
    for i, rnd in enumerate(rounds):
        got = [engine.submit(p, **kw) for p, kw in rnd]
        engine.run_until_idle(timeout=600)
        reqs.extend(got)
        if after is not None:
            after(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if not all(r.done for r in reqs):
        raise SystemExit("not every request finished")
    outs = [r.result(1) for r in reqs]
    ttft = sorted(r.ttft_ms for r in reqs)
    gen = sum(len(o) for o in outs)
    return reqs, {
        "requests": len(reqs), "generated_tokens": gen, "wall_s": wall,
        "tokens_per_s": gen / wall, "ttft_ms_median": statistics.median(ttft),
        "ttft_ms_p99": float(np.percentile(ttft, 99)), "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "stats": dict(engine.stats)}


def exact_launches(label, engine, res, model):
    """LayerNorm launches exactly 2L + 1 per program the engine ran, and
    no other kernel: a restore scatter launches none."""
    want = (2 * model.num_layers + 1) * programs_run(engine)
    others = {k: n for k, n in res["launches"].items()
              if k != "layer_norm" and n}
    res["expected_layer_norm"] = want
    res["leaked_blocks"] = engine.leaked_blocks()
    res["leaked_host_blocks"] = engine.leaked_host_blocks()
    if res["launches"]["layer_norm"] != want or others or \
            res["leaked_blocks"] or res["leaked_host_blocks"]:
        raise SystemExit("%s: LayerNorm %d (expected %d), other launches %s, "
                         "leaked blocks %d, host %d"
                         % (label, res["launches"]["layer_norm"], want,
                            others, res["leaked_blocks"],
                            res["leaked_host_blocks"]))


def block_bytes(engine, blocks):
    """The pool rows of ``blocks`` (every layer, K and V) on the host."""
    idx = torch.tensor(blocks, device="cuda")
    data = engine.model.slice_block(engine._cache, idx)
    leaves = data if isinstance(data, tuple) else (data,)
    return [t.cpu() for t in leaves]


def tier_run(label, model, params, rounds, system, kw, fault=None):
    """One engine of ``kw`` through the tier rounds under
    ``MXNET_CHAOS=fault``; with a tier, the prompt's blocks are read
    after the first wave, must be on the host after the fillers and, once
    restored, must hold the bytes they held."""
    engine = ServingEngine(model, params, max_batch=8, restore_ahead=8,
                           host_blocks=TIER_HOST_BLOCKS, **kw)
    engine.warmup()
    seen = {}
    # the host time of every spill (the eviction hook, the copy and the
    # tier's bookkeeping), read by nothing but this record
    spills = {"calls": 0, "s": 0.0}
    hook = engine._prefix.spill_hook

    def timed_spill(*args):
        t0 = time.perf_counter()
        try:
            return hook(*args)
        finally:
            spills["s"] += time.perf_counter() - t0
            spills["calls"] += 1

    if hook is not None:
        engine._prefix.spill_hook = timed_spill

    def after(i):
        # a lookup moves the matched blocks up the LRU: only at these three
        if engine._tier is None or i not in (1, 1 + FILLERS,
                                             len(rounds) - 1):
            return
        dev, host = engine._prefix.lookup_plan(system)
        if i == 1:
            seen["blocks"] = block_bytes(engine, dev)
            seen["n"] = len(dev)
        elif i == 1 + FILLERS:
            seen["after_fillers"] = (len(dev), len(host))
        elif i == len(rounds) - 1:
            seen["restored_equal"] = len(dev) == seen["n"] and all(
                torch.equal(a, b) for a, b in zip(
                    block_bytes(engine, dev), seen["blocks"]))

    with pinned(**({"MXNET_CHAOS": fault} if fault else {})):
        mx.chaos.reset()
        reqs, res = serve_rounds(engine, rounds, after)
    mx.chaos.reset()
    if engine.drain():
        raise SystemExit("%s: drain left stragglers" % label)
    exact_launches(label, engine, res, model)
    res["tier_blocks"] = {k: v for k, v in seen.items() if k != "blocks"}
    res["spill_calls"] = spills["calls"]
    res["spill_host_ms"] = 1e3 * spills["s"]
    waits = list(mx.telemetry.registry()._hists.get(
        "serve.restore_wait_ms", []))
    res["restore_wait_ms"] = (statistics.median(waits) if waits else None)
    st = res["stats"]
    log("tier %s (%s): %d tokens in %.3f s = %.1f tok/s, ttft median %.1f "
        "ms p99 %.1f ms, prefill_tokens %d, spilled %d, restored %d (%d "
        "tokens), spill_fails %d, prefix_hits %d, preemptions %d, "
        "max_memory_allocated %d B, prompt blocks %s; %d spill calls took "
        "%.3f ms of host time"
        % (label, card_name(), res["generated_tokens"], res["wall_s"],
           res["tokens_per_s"], res["ttft_ms_median"], res["ttft_ms_p99"],
           st["prefill_tokens"], st["spilled"], st["restored"],
           st["restored_tokens"], st["spill_fails"], st["prefix_hits"],
           st["preemptions"], res["max_memory_allocated"],
           res["tier_blocks"], res["spill_calls"], res["spill_host_ms"]))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return reqs, res


def restore_copy_check(model, params):
    """A 32-block run (the shared prompt, f32) staged from pinned memory
    by the engine's own restore copy (`_stage_run`): its ms and GB/s
    alone; then staged as the engine stages it, just before a decode step
    of 8 rows at 600-token contexts: the share of the copy's time on the
    card that ran while the decode did (events on both streams, from one
    origin)."""
    engine = ServingEngine(model, params, max_batch=8, tier=True)
    engine.warmup()
    kb = SYSTEM_LEN // 16
    data = model.block_run_placeholder(kb, 16, pin=True)
    data.normal_()
    nbytes = data.numel() * data.element_size()
    token = engine._put(np.zeros((8,), np.int64))
    pos = engine._put(np.full((8,), 600, np.int64))
    blocks = [list(range(1 + 40 * i, 41 + 40 * i)) for i in range(8)]
    tables = engine._table(8, blocks)
    main = torch.cuda.current_stream()

    def copy_only():
        staged, ready = engine._stage_run(data)
        engine._await_staged(staged, ready)

    def decode_only():
        engine._decode(token, pos, tables)

    times = {}
    for name, fn in (("copy", copy_only), ("decode", decode_only)):
        fn()
        runs = []
        for _ in range(10):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(True), torch.cuda.Event(True)
            start.record(main)
            fn()
            end.record(main)
            end.synchronize()
            runs.append(start.elapsed_time(end))
        times[name] = statistics.median(runs)
    shares = []
    for _ in range(10):
        torch.cuda.synchronize()
        origin, d0, d1 = (torch.cuda.Event(True) for _ in range(3))
        origin.record(main)
        staged, ready = engine._stage_run(data)
        # behind the copy on the side stream (`ready` does not time)
        copied = torch.cuda.Event(True)
        copied.record(engine._side)
        d0.record(main)
        engine._decode(token, pos, tables)
        d1.record(main)
        engine._await_staged(staged, ready)
        torch.cuda.synchronize()
        # the copy starts at the origin (its stream waits on an idle main)
        c1 = origin.elapsed_time(copied)
        a, b = origin.elapsed_time(d0), origin.elapsed_time(d1)
        shares.append(max(0.0, min(c1, b) - max(0.0, a)) / c1)
    res = {"bytes": nbytes, "copy_ms": times["copy"],
           "copy_gb_s": nbytes / times["copy"] / 1e6,
           "decode_ms": times["decode"],
           "overlap": statistics.median(shares)}
    log("restore copy (%s): %d B (32 blocks, f32) in %.3f ms = %.2f GB/s "
        "from pinned memory; a decode step of 8 rows %.3f ms; staged just "
        "before it, %.2f of the copy's time ran under the decode"
        % (card_name(), nbytes, res["copy_ms"], res["copy_gb_s"],
           res["decode_ms"], res["overlap"]))
    del engine
    torch.cuda.empty_cache()
    return res


def spill_cost_check(model, n=64):
    """What one spill's host time is made of, outside any engine: a fresh
    page-locked allocation of one block (every layer, K and V, f32), and
    a non-blocking copy of a pool block into a page-locked slot already
    held, with its event; the median host ms of ``n`` each.  Run before
    any engine of the phase, so no freed page-locked block of this size
    is cached yet."""
    pool = model.init_block_pool(n + 1, 16, "cuda")
    shape, dtype = pool[:, :, 0].shape, pool.dtype
    held, alloc, copy = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        held.append(torch.empty(shape, dtype=dtype, pin_memory=True))
        alloc.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    for b, dst in enumerate(held, 1):
        t0 = time.perf_counter()
        dst.copy_(pool[:, :, b], non_blocking=True)
        torch.cuda.Event().record()
        copy.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    res = {"block_bytes": held[0].numel() * held[0].element_size(),
           "alloc_ms_median": statistics.median(alloc),
           "copy_ms_median": statistics.median(copy),
           "alloc_ms_sum": sum(alloc), "copy_ms_sum": sum(copy)}
    log("spill cost (%s): %d B a block; a fresh page-locked allocation "
        "%.3f ms host median (%d: %.1f ms), a non-blocking copy into a "
        "held page-locked slot %.3f ms host median (%d: %.1f ms)"
        % (card_name(), res["block_bytes"], res["alloc_ms_median"], n,
           res["alloc_ms_sum"], res["copy_ms_median"], n,
           res["copy_ms_sum"]))
    del held, pool
    torch.cuda.empty_cache()
    return res


def tier_part(model, params):
    """(a): the tight pool with the tier, without it, the roomy pool, and
    the tier under ``spill_fail:0.5``."""
    system, requests, rounds = tier_rounds(model.vocab_size)
    order = [r for rnd in rounds for r in rnd]
    runs, out = {}, {"spill_cost": spill_cost_check(model)}
    for label, kw, fault in (
            ("on", dict(n_blocks=TIER_BLOCKS, tier=True), None),
            ("off", dict(n_blocks=TIER_BLOCKS, tier=False), None),
            ("roomy", dict(n_blocks=ROOMY_BLOCKS, tier=False), None),
            ("on, spill_fail:0.5", dict(n_blocks=TIER_BLOCKS, tier=True),
             "spill_fail:0.5")):
        runs[label], out[label] = tier_run(label, model, params, rounds,
                                           system, kw, fault)
    on, off, roomy, sf = (out[k]["stats"] for k in runs)
    bitwise = [r.tokens for r in runs["on"]] == \
        [r.tokens for r in runs["roomy"]]
    checks = {
        "tier tokens = roomy tokens, bit for bit": bitwise,
        "prompt blocks on the host after the fillers":
            out["on"]["tier_blocks"].get("after_fillers")
            == (0, SYSTEM_LEN // 16),
        "restored bytes = spilled bytes":
            bool(out["on"]["tier_blocks"].get("restored_equal")),
        "spilled >= 1": on["spilled"] >= 1,
        "restored >= 1": on["restored"] >= 1,
        "prefill_tokens below tier off": on["prefill_tokens"]
        < off["prefill_tokens"],
        "roomy never evicts": roomy["prefix_evictions"] == 0,
        "no preemption": not (on["preemptions"] or off["preemptions"]
                              or roomy["preemptions"]),
        "spill_fail hit a spill": sf["spill_fails"] >= 1}
    log("tier checks (%s): %s" % (card_name(), checks))
    if not all(checks.values()):
        raise SystemExit("tier checks failed: %s" % checks)
    out["parted_off"] = same_tokens("tier off vs roomy", model, params,
                                    order, runs["roomy"], runs["off"])
    out["parted_spill_fail"] = same_tokens(
        "tier on spill_fail:0.5 vs on", model, params, order, runs["on"],
        runs["on, spill_fail:0.5"])
    out["checks"] = checks
    out["restore_copy"] = restore_copy_check(model, params)
    launches = {}
    for label in runs:
        for k, n in out[label]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    return out


def session_turns(vocab):
    """4 sessions x 3 turns of 48-96 new tokens each, 16 generated."""
    rng = np.random.RandomState(26)
    return [[(rng.randint(0, vocab, size=int(rng.randint(48, 97))).tolist(),
              dict(max_new_tokens=16, seed=300 + 10 * s + t))
             for t in range(TURNS)] for s in range(SESSIONS)]


def session_run(label, model, params, turns, through_tier):
    """The sessions' turns, each turn of the 4 together; between turns
    ``through_tier`` evicts every parked block (to the host tier).  Each
    follow-up prefills at most its new tokens and the history's partial
    blocks."""
    engine = ServingEngine(model, params, max_batch=8, tier=True,
                           host_blocks=TIER_HOST_BLOCKS,
                           restore_ahead=SESSIONS)
    engine.warmup()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    reqs = []
    bound_ok = True
    t0 = time.perf_counter()
    for t in range(TURNS):
        before = engine.stats["prefill_tokens"]
        got = [engine.submit(turns[s][t][0], session="s%d" % s,
                             **turns[s][t][1]) for s in range(SESSIONS)]
        engine.run_until_idle(timeout=600)
        for r in got:
            r.result(1)
        reqs.append(got)
        fresh = engine.stats["prefill_tokens"] - before
        if t and fresh > sum(len(turns[s][t][0]) + 2 * 16 - 1
                             for s in range(SESSIONS)):
            bound_ok = False
        if through_tier:
            engine._alloc.reclaim(engine._prefix.evict(
                engine._alloc.capacity))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"stats": dict(engine.stats), "launches": read_counts(),
           "wall_s": wall, "suffix_only": bound_ok,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if engine.drain():
        raise SystemExit("sessions %s: drain left stragglers" % label)
    exact_launches("sessions " + label, engine, res, model)
    st = res["stats"]
    log("sessions %s (%s): %d turns in %.3f s, session_hits %d, "
        "session_turns %d, prefill_tokens %d, prefix_tokens %d, spilled %d, "
        "restored %d, suffix-only prefill %s"
        % (label, card_name(), SESSIONS * TURNS, wall, st["session_hits"],
           st["session_turns"], st["prefill_tokens"], st["prefix_tokens"],
           st["spilled"], st["restored"], bound_ok))
    ok = bound_ok and st["session_hits"] == SESSIONS * (TURNS - 1) and \
        st["session_turns"] == SESSIONS * TURNS and \
        (st["restored"] > 0 if through_tier else True)
    if not ok:
        raise SystemExit("sessions %s failed: %s" % (label, st))
    del engine
    torch.cuda.empty_cache()
    return reqs, res


def session_part(model, params):
    """(b): each turn's tokens against a fresh engine (no prefix cache)
    given the whole history, under the 1e-3 margin rule."""
    turns = session_turns(model.vocab_size)
    out = {}
    fresh = ServingEngine(model, params, max_batch=8, prefix=False)
    fresh.warmup()
    for label, through in (("on the card", False), ("through the tier",
                                                    True)):
        reqs, out[label] = session_run(label, model, params, turns, through)
        parted = []
        for t in range(TURNS):
            want = [fresh.submit(r.prompt, **turns[s][t][1])
                    for s, r in enumerate(reqs[t])]
            fresh.run_until_idle(timeout=600)
            parted += same_tokens(
                "session turn %d %s vs fresh" % (t + 1, label), model,
                params, [(r.prompt, turns[s][t][1])
                         for s, r in enumerate(reqs[t])], want, reqs[t])
        out[label]["parted"] = parted
    del fresh
    torch.cuda.empty_cache()
    return out


def quant_logit_check(label, qmodel, qparams, reqs):
    """The quantized model's kernel path against its own plain-LayerNorm
    path, teacher-forced on two served greedy requests: logits within
    LOGIT_TOL, and each greedy token the plain path's argmax within it."""
    out = []
    for r in [r for r in reqs if r.temperature == 0][:2]:
        got = teacher_forced_kernel_logits(qmodel, qparams, r.prompt,
                                           r.tokens, 16)
        with plain_kernels():
            ref = teacher_forced_kernel_logits(qmodel, qparams, r.prompt,
                                               r.tokens, 16)
        err = float((got - ref).abs().max())
        picked = ref.gather(1, torch.tensor(r.tokens,
                                            device=ref.device)[:, None])
        gap = float((ref.max(dim=1).values - picked[:, 0]).max())
        log("%s logits request %d (prompt %d, %d positions): kernel path "
            "vs plain-LayerNorm path err %.3e (tol %.0e), greedy argmax gap "
            "%.2e" % (label, r.id, len(r.prompt), len(r.tokens), err,
                      LOGIT_TOL, gap))
        if not (err <= LOGIT_TOL and gap <= LOGIT_TOL):
            raise SystemExit("%s: the kernel path parts from the plain "
                             "path" % label)
        out.append({"request": r.id, "max_abs_err": err, "argmax_gap": gap})
    return out


def bytes_apart(a, b):
    """How many bytes two tensors differ in (fp8 and f32 alike); all of
    them when their dtypes or shapes differ."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return max(a.nbytes, b.nbytes, 1)
    return int((a.view(torch.uint8) != b.view(torch.uint8)).sum())


def codec_on_card_check(model, params, qmodel, qparams):
    """The card's quantized weights, and one pool block's K/V rows
    quantized on the card (int8 and fp8), bit for bit what the same codec
    gives on the CPU, which the CPU tests hold bit-equal to the JAX
    package's: a wrong cast, clamp or rounding on the card fails here."""
    qd = qparams
    qc = qmodel.quantize_params({k: v.cpu() for k, v in params.items()})
    out = {"weights": sum(bytes_apart(qd[k], qc[k]) for k in qc)
           if sorted(qd) == sorted(qc) else -1}
    g = torch.Generator().manual_seed(25)
    rows = 3 * torch.randn((model.num_layers, 2, 16, model.num_embed),
                           generator=g)
    rows[0, 0, 3] = 0                      # a zero row takes scale 1
    for spec in ("int8", "fp8"):
        q_card, s_card = mx.quant.quantize_rows(rows.cuda(), spec)
        q_cpu, s_cpu = mx.quant.quantize_rows(rows, spec)
        out["kv rows " + spec] = bytes_apart(q_card, q_cpu) + \
            bytes_apart(s_card, s_cpu)
    return out


def pool_block_bytes(model, kv_quant):
    """Bytes of one pool block (every layer, K and V) under ``kv_quant``."""
    pool = model.with_quant(None, kv_quant).init_block_pool(1, 16, "cuda")
    leaves = pool if isinstance(pool, tuple) else (pool,)
    return sum(t.numel() * t.element_size() for t in leaves)


def scale_corrupt_run(model, params, requests, clean):
    """(d): ``scale_corrupt:0.3`` on weights int8 with KV int8: the
    requests the logit gate tripped twice fail with `ServeQuantError`,
    every other one gets the fault-free tokens (margin rule), the engine
    lives on and nothing leaks."""
    engine = ServingEngine(model, params, max_batch=8, quant="int8",
                           kv_quant="int8")
    engine.warmup()
    with pinned(MXNET_CHAOS="scale_corrupt:0.3"):
        mx.chaos.reset()
        reset_counts()
        reqs = [engine.submit(p, **kw) for p, kw in requests]
        engine.run_until_idle(timeout=600)
        res = {"launches": read_counts()}
    mx.chaos.reset()
    failed, kinds, done = [], set(), []
    for i, r in enumerate(reqs):
        try:
            r.result(1)
            done.append(i)
        except Exception as e:  # typed failures are the point here
            failed.append(i)
            kinds.add(type(e).__name__)
    res["stats"] = st = dict(engine.stats)
    if engine.drain():
        raise SystemExit("scale_corrupt: drain left stragglers")
    exact_launches("scale_corrupt:0.3", engine, res, model)
    res.update(failed=failed, error_types=sorted(kinds),
               alive=engine._dead is None)
    res["parted"] = same_tokens(
        "scale_corrupt:0.3 survivors vs clean", model, params,
        [requests[i] for i in done], [clean[i] for i in done],
        [reqs[i] for i in done])
    log("scale_corrupt:0.3 (%s): %d of %d requests failed (%s), %d scale "
        "corruptions, %d gate trips, engine alive %s"
        % (card_name(), len(failed), len(reqs), sorted(kinds),
           st["scale_corrupts"], st["quant_trips"], res["alive"]))
    if kinds - {"ServeQuantError"} or not st["scale_corrupts"] or \
            not st["quant_trips"] or not res["alive"]:
        raise SystemExit("scale_corrupt: %s" % res)
    del engine
    torch.cuda.empty_cache()
    return res


def quant_part(model, params):
    """(c) and (d): the f32 engine and each quantized mode on phase 3's
    16 prompts, in one process."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("allow_tf32 is on: the scaled matmuls would run "
                         "in TF32")
    requests = spec_traffic(model.vocab_size)
    out = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    plain_reqs, out["f32"] = serve_mode("f32", model, params, requests, {})
    prompts = [p[:64] for p, _ in requests[:4]]
    for label, kw in QUANT_MODES:
        reqs, res = serve_mode(label, model, params, requests, kw)
        qmodel = model.with_quant(kw["quant"], kw["kv_quant"])
        qparams = qmodel.quantize_params(params)
        res["logit_checks"] = quant_logit_check(label, qmodel, qparams, reqs)
        res["bytes_apart_cpu"] = codec_on_card_check(model, params, qmodel,
                                                    qparams)
        log("%s codec on the card vs the CPU (%s), bytes apart (0: bit "
            "for bit): %s" % (label, card_name(), res["bytes_apart_cpu"]))
        if any(res["bytes_apart_cpu"].values()):
            raise SystemExit("%s: the card's codec parts from the CPU's"
                             % label)
        rep = mx.quant.parity_report(model, params, qmodel, qparams, prompts,
                                     max_new=8, block_size=16)
        res["parity"] = {k: rep[k] for k in ("logit_err_max",
                                             "logit_err_rel",
                                             "token_match_rate")}
        res["weight_bytes"] = sum(t.numel() * t.element_size()
                                  for t in qparams.values())
        gated = kw["quant"] != "fp8"
        res["parity"]["gated"] = gated
        log("%s parity vs f32 (%s): %s (%s: rel <= %.2f, match >= %.2f)"
            % (label, card_name(), res["parity"],
               "gate" if gated else "reported beside the int8 gate",
               PARITY_REL_MAX, PARITY_MATCH_MIN))
        if not np.isfinite(rep["logit_err_max"]) or gated and not (
                rep["logit_err_rel"] <= PARITY_REL_MAX
                and rep["token_match_rate"] >= PARITY_MATCH_MIN):
            raise SystemExit("%s fails the parity gate" % label)
        out[label] = res
        if label == "w8 kv8":
            clean = reqs
        del qparams
    f32_block = pool_block_bytes(model, None)
    int8_block = pool_block_bytes(model, "int8")
    # the default engine's pool: (max_batch + 1) rows of the cache depth
    f32_pool = f32_block * (8 + 1) * -(-model.seq_len // 16)
    out["pool"] = {"f32_block_bytes": f32_block,
                   "int8_block_bytes": int8_block,
                   "f32_pool_bytes": f32_pool,
                   "n_blocks_f32": f32_pool // f32_block,
                   "n_blocks_int8_at_equal_bytes": f32_pool // int8_block}
    log("pool at equal bytes (%s): %s" % (card_name(), out["pool"]))
    out["scale_corrupt"] = scale_corrupt_run(model, params, requests, clean)
    launches = {}
    for label in ["f32"] + [m for m, _ in QUANT_MODES] + ["scale_corrupt"]:
        for k, n in out[label]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    return out


def tier_session_quant_phase():
    """Phase 25 on GPT-2 small in float32."""
    model = TransformerKVModel(**GPT2)
    params = model.params_from_jax(
        model.init_params(np.random.RandomState(0)), "cuda")
    out = {"card": card_name(), "tier": tier_part(model, params),
           "sessions": session_part(model, params),
           "quant": quant_part(model, params)}
    launches = {}
    for part in ("tier", "quant"):
        for k, n in out[part]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    for res in out["sessions"].values():
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 26: MoE serving, the disaggregated fleet and the gateway ---------

# Switch-Base-8's expert count and top-1 router (Fedus, Zoph and Shazeer
# 2021, "Switch Transformers") on GPT-2 small's widths, every layer MoE
MOE_EXPERTS = 8
MOE_MODES = [
    ("moe paged", {}),
    ("moe megastep m=4", dict(megastep=True, megastep_steps=4)),
    ("moe ngram k=4", dict(spec=True, spec_drafter="ngram", spec_k=SPEC_K)),
    ("moe slot", dict(paged=False)),
]
GATEWAY_REQUESTS = 4


def card_params(model, seed):
    """Random float32 weights for ``model`` drawn on the card from
    ``seed`` by the JAX package's rule (gammas 1, betas and biases 0, the
    rest N(0, 0.02)): the MoE model's 2.1 GB would take longer to draw on
    the host than the phase has."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = {}
    for name, shape in model.param_shapes().items():
        if name.endswith("_gamma"):
            out[name] = torch.ones(shape, device="cuda")
        elif name.endswith(("_beta", "_bias")):
            out[name] = torch.zeros(shape, device="cuda")
        else:
            out[name] = torch.randn(shape, generator=g, device="cuda") * 0.02
    return out


def count_rows(engine):
    """Wrap ``engine``'s programs to count the rows each launch routes
    (its bucket's rows, padding included): what the MoE tape must sum to,
    layer by layer.  Call after warmup."""
    rows = [0]
    m = engine._mega_m
    per = {"_prefill_chunk": 1, "_prefill_slot": 1, "_decode": 1,
           "_verify": 1, "_megastep": m}
    for name, k in per.items():
        fn = getattr(engine, name)

        def run(*a, _fn=fn, _k=k, **kw):
            rows[0] += _k * a[0].numel()
            return _fn(*a, **kw)
        setattr(engine, name, run)
    return rows


def expert_gauges(engine):
    reg = mx.telemetry.registry()
    return [reg.gauge("%sexpert_load.%d" % (engine._gauge, i)).value
            for i in range(engine.model.moe_experts)]


def moe_serve(label, model, params, requests, kw):
    """One MoE engine of ``kw`` serving ``requests`` to the end: its
    requests and numbers, held to `expert_load` = L x the rows its
    launches routed, the gauges = `expert_load`, exactly 2L + 1
    LayerNorm a program and L flash a slot prefill, nothing leaked."""
    engine = ServingEngine(model, params, max_batch=8, **kw)
    engine.warmup()
    rows = count_rows(engine)
    reqs, res = serve(engine, requests)
    load = engine.expert_load()
    gauges = expert_gauges(engine)
    stragglers = engine.drain()
    st = engine.stats
    L = model.num_layers
    programs = programs_run(engine) + (0 if engine._paged
                                       else st["prefills"])
    want = {"layer_norm": (2 * L + 1) * programs,
            "flash_attention": 0 if engine._paged else L * st["prefills"]}
    got = {k: res["launches"][k] for k in want}
    others = {k: n for k, n in res["launches"].items()
              if k not in want and n}
    res.update(label=label, expert_load=load.tolist(), gauges=gauges,
               rows_routed=rows[0], expected=want,
               leaked_blocks=engine.leaked_blocks())
    log("%s (%s): %d tokens in %.3f s = %.1f tok/s, ttft median %.1f ms p99 "
        "%.1f ms, max_memory_allocated %d B, expert load %s (sum %d = L x "
        "%d routed rows), launches %s (expected %s), %d decode steps, %d "
        "megasteps, %d verifies, leaked blocks %d"
        % (label, card_name(), res["generated_tokens"], res["wall_s"],
           res["tokens_per_s"], res["ttft_ms_median"], res["ttft_ms_p99"],
           res["max_memory_allocated"], res["expert_load"], int(load.sum()),
           rows[0], got, want, st["decode_steps"], st["megasteps"],
           st["verify_steps"], res["leaked_blocks"]))
    if int(load.sum()) != L * rows[0] or gauges != load.tolist():
        raise SystemExit("%s: expert load %s (sum %d), L x routed rows %d, "
                         "gauges %s" % (label, load.tolist(), load.sum(),
                                        L * rows[0], gauges))
    if got != want or others or stragglers or res["leaked_blocks"]:
        raise SystemExit("%s: launches %s (expected %s), other launches %s, "
                         "stragglers %d, leaked %d"
                         % (label, got, want, others, len(stragglers),
                            res["leaked_blocks"]))
    del engine
    torch.cuda.empty_cache()
    return reqs, res


def moe_sync_free_check(model, params):
    """A MoE megastep (m=4) over 8 sampled rows, its routing count's copy
    and the scheduler's drain of the counts enqueue under
    ``torch.cuda.set_sync_debug_mode("error")``; the count, waited for
    after, is L x 8 rows x 4 steps."""
    engine = ServingEngine(model, params, max_batch=8, megastep=True,
                           megastep_steps=4)
    engine.warmup()
    token, pos, tables = engine._decode_inputs(8, [], [])
    left = engine._put(np.full((8,), 4, np.int64))
    eos = engine._put(np.full((8,), -1, np.int64))
    reqs = [mx.serving.ServeRequest([1], 4, temperature=0.8, top_k=40,
                                    seed=i) for i in range(8)]
    samp = engine._samp_device(reqs, 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grid = engine._megastep(token, pos, left, eos, tables, samp)
        host, done = engine._to_host(grid)
        engine._drain_moe()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    grid = engine._fetch(host, done)
    load = engine.expert_load()
    want = model.num_layers * 8 * 4
    log("no host sync, MoE (%s): a megastep m=4 over 8 sampled rows, its "
        "count and the drain enqueued under set_sync_debug_mode('error'); "
        "grid %s, expert load %s (sum %d, want %d)"
        % (card_name(), grid.shape, load.tolist(), load.sum(), want))
    if grid.shape != (8, 4) or not (grid >= 0).all() or load.sum() != want:
        raise SystemExit("the sync-free MoE megastep gave %s, load %s"
                         % (grid, load))
    del engine
    torch.cuda.empty_cache()
    return {"grid": list(grid.shape), "expert_load": load.tolist()}


def moe_part(requests):
    """(a): the MoE model through every mode, beside dense GPT-2 small."""
    model = TransformerKVModel(moe_experts=MOE_EXPERTS, **GPT2)
    params = card_params(model, 0)
    n_params = sum(p.numel() for p in params.values())
    n_bank = sum(p.numel() for k, p in params.items() if "moe_w" in k)
    out = {"params": n_params, "expert_bank_params": n_bank,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in params.values())}
    log("MoE model (%s): GPT-2 small widths, %d experts top-1 every layer: "
        "%d parameters (%d in the expert banks), %d B in float32"
        % (card_name(), MOE_EXPERTS, n_params, n_bank, out["weight_bytes"]))
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("allow_tf32 is on: the MoE einsums would run in "
                         "TF32")
    runs, launches = {}, {}
    for label, kw in MOE_MODES:
        runs[label], out[label] = moe_serve(label, model, params, requests,
                                            kw)
        for k, n in out[label]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    plain = runs["moe paged"]
    for label, _ in MOE_MODES[1:]:
        out[label]["parted"] = same_tokens(label + " vs moe paged", model,
                                           params, requests, plain,
                                           runs[label])
    # the plain-LayerNorm path, teacher-forced (no count: launches of the
    # check are not the path's)
    out["logit_checks"] = logit_check(model, params, plain[:2], 16)
    out["sync_free"] = moe_sync_free_check(model, params)
    out["launches"] = launches
    del params, runs, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_router(router, requests, timeout=600):
    """Submit every (prompt, kwargs) through a started router and wait for
    each: (requests, wall seconds, generated tokens)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [router.submit(p, **kw) for p, kw in requests]
    for r in reqs:
        try:
            r.result(timeout=timeout)
        except mx.serving.ServeError as e:
            raise SystemExit("request %d failed: %s" % (r.id, e))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen = sum(len(r.tokens) for r in reqs)
    return reqs, wall, gen


def fleet(model, params, disagg, names=("replica0", "replica1")):
    engines = [ServingEngine(model, params, max_batch=8, name=n)
               for n in names]
    router = ReplicaRouter(engines, respawn=False, disagg=disagg,
                           prefill_replicas=1 if disagg else None)
    router.warmup()
    return engines, router


def fleet_numbers(label, engines, reqs, wall, gen, launches):
    ttft = sorted(r.ttft_ms for r in reqs)
    hist = sorted(mx.telemetry.registry()._hists.get(
        "serve.handoff_wait_ms", []))
    res = {"label": label, "generated_tokens": gen, "wall_s": wall,
           "tokens_per_s": gen / wall,
           "ttft_ms_median": statistics.median(ttft),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "handoffs": sum(e.stats["handoffs"] for e in engines),
           "handoffs_in": sum(e.stats["handoffs_in"] for e in engines),
           "handoff_fails": sum(e.stats["handoff_fails"] for e in engines),
           "handoff_bytes": mx.telemetry.registry().counter(
               "serve.handoff_bytes").value,
           "handoff_wait_ms_p50": float(np.percentile(hist, 50))
           if hist else None,
           "handoff_wait_ms_p99": float(np.percentile(hist, 99))
           if hist else None,
           "prefill_chunks": [e.stats["prefill_chunks"] for e in engines],
           "leaked_blocks": [e.leaked_blocks() for e in engines],
           "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log("%s (%s): %d tokens in %.3f s = %.1f tok/s, ttft median %.1f ms p99 "
        "%.1f ms, handoffs %d out / %d in (%d failed), %d B, handoff wait "
        "p50 %s ms p99 %s ms, prefill chunks by replica %s, leaked %s"
        % (label, card_name(), gen, wall, res["tokens_per_s"],
           res["ttft_ms_median"], res["ttft_ms_p99"], res["handoffs"],
           res["handoffs_in"], res["handoff_fails"], res["handoff_bytes"],
           res["handoff_wait_ms_p50"], res["handoff_wait_ms_p99"],
           res["prefill_chunks"], res["leaked_blocks"]))
    if any(res["leaked_blocks"]):
        raise SystemExit("%s leaked blocks %s" % (label,
                                                  res["leaked_blocks"]))
    return res


def landing_bytes_probe(engine, n=2):
    """Wrap a decode replica's landing: for its first ``n`` tickets, the
    landed blocks read back from the pool against the ticket's packed
    host run, byte for byte."""
    seen = []
    land = engine._complete_landing

    def check(ld):
        t = ld.ticket
        land(ld)
        if len(seen) < n and engine._active.get(ld.row) is not None:
            blocks = torch.tensor(ld.blocks[:t.k], device="cuda")
            got = engine._cache[:, :, blocks].cpu()
            seen.append({"request": t.req.id, "blocks": t.k, "pos": t.pos,
                         "nbytes": int(got.nbytes),
                         "equal": bool(torch.equal(got,
                                                   t.data[:, :, :t.k]))})
    engine._complete_landing = check
    return seen


def sse(port, obj, timeout=120, hangup_after=None):
    """POST /v1/generate and read its event stream: (status, tokens, [DONE]
    seen, ms to the first token frame)."""
    body = json.dumps(obj).encode()
    t0 = time.perf_counter()
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    s.settimeout(timeout)
    first = None
    try:
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        buf, toks, done, status = b"", [], False, None
        while True:
            while b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                line = line.strip()
                if status is None and line.startswith(b"HTTP/1.1"):
                    status = int(line.split()[1])
                elif line == b"data: [DONE]":
                    done = True
                elif line.startswith(b"data: "):
                    payload = json.loads(line[6:])
                    if "token" in payload:
                        if first is None:
                            first = 1e3 * (time.perf_counter() - t0)
                        toks.append(payload["token"])
                if hangup_after is not None and len(toks) >= hangup_after:
                    s.shutdown(socket.SHUT_RDWR)
                    return status, toks, done, first
            d = s.recv(65536)
            if not d:
                return status, toks, done, first
            buf += d
    finally:
        s.close()


def gateway_part(router, requests):
    """(c): the gateway on 127.0.0.1, port 0, over a started fleet: each
    of 4 SSE streams equals its request's `result()`, and a client that
    hangs up after one token has its request cancelled and its blocks
    freed."""
    submitted = []
    submit = router.submit

    def recording(prompt, **kw):
        req = submit(prompt, **kw)
        submitted.append(req)
        return req
    router.submit = recording
    cancelled = threading.Event()

    def tap(ev):
        if ev.get("kind") == "serve_gateway_cancel":
            cancelled.set()
    mx.telemetry.add_event_tap(tap)
    with pinned(MXNET_SERVE_GATEWAY="1"):
        gw = mx.serving.ServeGateway(router, host="127.0.0.1", port=0)
    gw.start()
    try:
        got = [None] * GATEWAY_REQUESTS

        def client(i):
            p, kw = requests[i]
            got[i] = sse(gw.port, {"prompt": p,
                                   "max_new_tokens": kw["max_new_tokens"]})
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(GATEWAY_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or None in got:
            raise SystemExit("a gateway client did not finish")
        by_prompt = {tuple(r.prompt): r for r in submitted}
        streams_equal = all(
            g[0] == 200 and g[2] and g[1] == by_prompt[tuple(
                requests[i][0])].result(timeout=60)
            for i, g in enumerate(got))
        ttfb = sorted(g[3] for g in got)
        engine_ttft = statistics.median(
            by_prompt[tuple(requests[i][0])].ttft_ms
            for i in range(GATEWAY_REQUESTS))
        hang = sse(gw.port, {"prompt": requests[4][0],
                             "max_new_tokens": 512}, hangup_after=1)
        if not cancelled.wait(timeout=120):
            raise SystemExit("the hung-up client's request was not "
                             "cancelled")
        victim = submitted[-1]
        try:
            victim.result(timeout=120)
        except mx.serving.ServeCancelled:
            pass
        router.run_until_idle(timeout=120)
        leaked = [e.leaked_blocks() for e in router.engines]
    finally:
        gw.stop()
        mx.telemetry.remove_event_tap(tap)
        router.submit = submit
    hist = sorted(mx.telemetry.registry()._hists.get(
        "serve.gateway.ttfb_ms", []))
    res = {"streams_equal": streams_equal, "client_ttfb_ms": ttfb,
           "client_ttfb_ms_p50": statistics.median(ttfb),
           "engine_ttft_ms_median": engine_ttft,
           "gateway_ttfb_ms_p50": statistics.median(hist) if hist else None,
           "hangup_tokens": len(hang[1]),
           "hangup_cancelled": type(victim.error).__name__,
           "hangup_generated": len(victim.tokens), "leaked_blocks": leaked}
    log("gateway (%s): %d SSE streams equal to result(): %s, ttfb p50 %.1f "
        "ms at the client (%s ms by the gateway; the engine's ttft median "
        "%.1f ms); a hang-up after %d token cancelled (%s after %d tokens), "
        "leaked blocks %s"
        % (card_name(), GATEWAY_REQUESTS, streams_equal,
           res["client_ttfb_ms_p50"], res["gateway_ttfb_ms_p50"],
           engine_ttft,
           res["hangup_tokens"], res["hangup_cancelled"],
           res["hangup_generated"], leaked))
    if not streams_equal or res["hangup_cancelled"] != "ServeCancelled" \
            or any(leaked):
        raise SystemExit("gateway: streams equal %s, hang-up %s, leaked %s"
                         % (streams_equal, res["hangup_cancelled"], leaked))
    return res


def disagg_part(requests):
    """(b) and (c): GPT-2 small as a prefill and a decode replica on the
    card against two colocated replicas, under ``handoff_fail:0.5``, with
    a decode replica added and removed under load, then the gateway."""
    model = TransformerKVModel(**GPT2)
    params = card_params(model, 0)
    out = {"card": card_name()}
    launches, last = {}, {}

    def counted(run):
        """``run()``, its kernel launches in ``last`` and the phase's."""
        reset_counts()
        res = run()
        last.clear()
        last.update(read_counts())
        for k, n in last.items():
            launches[k] = launches.get(k, 0) + n
        return res

    mx.telemetry.reset()
    engines, router = fleet(model, params, disagg=False)
    router.start()
    try:
        colo, wall, gen = counted(lambda: run_router(router, requests))
    finally:
        router.stop()
    out["colocated"] = fleet_numbers("colocated x2", engines, colo, wall,
                                     gen, dict(last))
    del engines, router
    torch.cuda.empty_cache()

    mx.telemetry.reset()
    torch.cuda.reset_peak_memory_stats()
    engines, router = fleet(model, params, disagg=True)
    probe = landing_bytes_probe(engines[1])
    router.start()
    try:
        dis, wall, gen = counted(lambda: run_router(router, requests))
    finally:
        router.stop()
    res = out["disaggregated"] = fleet_numbers(
        "disaggregated 1+1", engines, dis, wall, gen, dict(last))
    res["landing_bytes"] = probe
    res["parted"] = same_tokens("disaggregated vs colocated", model, params,
                                requests, colo, dis)
    log("handoff landings read back (%s): %s" % (card_name(), probe))
    if res["handoffs"] != len(requests) or res["prefill_chunks"][1] or \
            len(probe) < 2 or not all(p["equal"] for p in probe):
        raise SystemExit("disaggregated: %d handoffs, decode replica "
                         "prefill chunks %d, landed bytes %s"
                         % (res["handoffs"], res["prefill_chunks"][1],
                            probe))
    del engines, router
    torch.cuda.empty_cache()

    mx.telemetry.reset()
    engines, router = fleet(model, params, disagg=True)
    with pinned(MXNET_CHAOS="handoff_fail:0.5"):
        mx.chaos.reset()
        router.start()
        try:
            lossy, wall, gen = counted(lambda: run_router(router, requests))
        finally:
            router.stop()
    mx.chaos.reset()
    res = out["handoff_fail"] = fleet_numbers(
        "disaggregated, handoff_fail:0.5", engines, lossy, wall, gen,
        dict(last))
    res["parted"] = same_tokens("handoff_fail:0.5 vs fault-free", model,
                                params, requests, dis, lossy)
    if not res["handoff_fails"] or res["handoff_fails"] + \
            res["handoffs"] != len(requests):
        raise SystemExit("handoff_fail:0.5: %d failed, %d handed off"
                         % (res["handoff_fails"], res["handoffs"]))
    del engines, router
    torch.cuda.empty_cache()

    mx.telemetry.reset()
    engines, router = fleet(model, params, disagg=True)
    router.start()
    try:
        def scale():
            reqs = [router.submit(p, **kw) for p, kw in requests]
            added = router.add_replica(role="decode")
            gone = router.remove_replica(role="decode")
            failed = 0
            for r in reqs:
                try:
                    r.result(timeout=600)
                except mx.serving.ServeError:
                    failed += 1
            return reqs, added, gone, failed
        scaled, added, gone, failed = counted(scale)
        out["scale"] = {
            "added": added.name, "removed": gone, "failed": failed,
            "roles": [e.role for e in router.engines],
            "shares_params": all(
                added._params[k] is engines[0]._params[k]
                for k in added._params),
            "leaked_blocks": [e.leaked_blocks() for e in router.engines]}
        out["scale"]["parted"] = same_tokens(
            "decode replica added and removed vs colocated", model, params,
            requests, colo, scaled)
        log("scale (%s): added %s (parameters shared: %s), removed %s under "
            "load, %d failed, roles %s, leaked %s"
            % (card_name(), added.name, out["scale"]["shares_params"], gone,
               failed, out["scale"]["roles"],
               out["scale"]["leaked_blocks"]))
        if failed or any(out["scale"]["leaked_blocks"]) or \
                not out["scale"]["shares_params"]:
            raise SystemExit("scale under load: %s" % out["scale"])
        out["gateway"] = counted(lambda: gateway_part(router, requests))
    finally:
        router.stop()
    out["launches"] = launches
    del engines, router, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_disagg_gateway_phase():
    """Phase 26: MoE serving at GPT-2 small's widths with Switch-Base-8's
    experts, then GPT-2 small disaggregated, scaled and behind the
    gateway."""
    requests = spec_traffic(GPT2["vocab_size"])
    out = {"card": card_name(), "moe": moe_part(requests)}
    dense = TransformerKVModel(**GPT2)
    dparams = card_params(dense, 0)
    engine = ServingEngine(dense, dparams, max_batch=8)
    engine.warmup()
    _, dres = serve(engine, requests)
    out["dense paged"] = dres
    del engine, dparams
    torch.cuda.empty_cache()
    moe = out["moe"]["moe paged"]
    log("MoE vs dense GPT-2 small, paged (%s): %.1f vs %.1f tok/s, ttft "
        "median %.1f vs %.1f ms, p99 %.1f vs %.1f ms, peak memory %d vs %d B; "
        "expert load %s"
        % (card_name(), moe["tokens_per_s"], dres["tokens_per_s"],
           moe["ttft_ms_median"], dres["ttft_ms_median"], moe["ttft_ms_p99"],
           dres["ttft_ms_p99"], moe["max_memory_allocated"],
           dres["max_memory_allocated"], moe["expert_load"]))
    out["disagg"] = disagg_part(requests)
    launches = {}
    for part in (out["moe"], out["disagg"], dres):
        for k, n in part["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
    return out


# -- phase 27: sub-mesh serving replicas and request tracing ---------------

# nanoGPT's padded GPT-2 vocabulary: 50304 = 2^7 x 393 splits 2 and 4 ways,
# where GPT-2's own 50257 (odd) keeps the embedding and the head
# replicated
PADDED_VOCAB = 50304
SHARD_LOGIT_REQUESTS = 2


def phase3_traffic(vocab):
    """Phase 3's 16 requests (32-768-token prompts, 32 new tokens, odd
    ones sampled at T=0.8, top_k 50, top_p 0.95), drawn for ``vocab``."""
    rng = np.random.RandomState(0)
    out = []
    for i, n in enumerate(rng.randint(32, 769, size=16)):
        prompt = rng.randint(0, vocab, size=int(n)).tolist()
        kw = dict(max_new_tokens=32, seed=i)
        if i % 2:
            kw.update(temperature=0.8, top_k=50, top_p=0.95)
        out.append((prompt, kw))
    return out


def card_group(k):
    """A k-shard group on the one card: ``[cuda:0] * k``."""
    return submeshes([torch.device("cuda", 0)] * k, k)[0]


def shard_serve(label, model, params, requests, shards, kw):
    """One engine of ``kw`` over ``shards`` entries of the card (1: the
    unsharded engine) serving ``requests`` to the end: its requests and
    numbers, with its memory accounting, exactly 2L LayerNorm a program
    per distinct device of the group plus the final one (per distinct
    device before a vocab-split head) and, on the slot cache, L
    flash launches a prefill per attention unit (a shard's heads), no
    block leaked."""
    ctx = None if shards == 1 else card_group(shards)
    engine = ServingEngine(model, params, ctx=ctx, max_batch=8, **kw)
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    mf = engine.memory_footprint()
    reqs, res = serve(engine, requests)
    stragglers = engine.drain()
    st = engine.stats
    L = model.num_layers
    plan = engine.model.plan
    devs, units = len(plan.devs), len(plan.units)
    # the final LayerNorm runs per distinct device only before a
    # vocab-split head
    final = devs if plan.groups["vocab"] else 1
    programs = programs_run(engine) + (0 if engine._paged
                                       else st["prefills"])
    want = {"layer_norm": (2 * L * devs + final) * programs,
            "flash_attention": 0 if engine._paged
            else L * units * st["prefills"]}
    got = {k: res["launches"].get(k, 0) for k in want}
    others = {k: n for k, n in res["launches"].items()
              if k not in want and n}
    res.update(label=label, shards=shards, warmup_s=warm_s,
               memory_footprint=mf, expected=want,
               groups=plan.groups,
               attention_units=units,
               leaked_blocks=engine.leaked_blocks() if engine._paged else 0)
    log("%s (%s): %d tokens in %.3f s = %.1f tok/s, ttft median %.1f ms p99 "
        "%.1f ms, memory_footprint total %d B, per device (by shard "
        "position) %d B, per shard %s, physical %s, max_memory_allocated "
        "%d B, split groups %s, launches %s (expected %s)"
        % (label, card_name(), res["generated_tokens"], res["wall_s"],
           res["tokens_per_s"], res["ttft_ms_median"], res["ttft_ms_p99"],
           mf["total_bytes"], mf["per_device_bytes"], mf["per_shard_bytes"],
           mf["physical_device_bytes"], res["max_memory_allocated"],
           res["groups"], got, want))
    if got != want or others or stragglers or res["leaked_blocks"]:
        raise SystemExit("%s: launches %s (expected %s), other launches %s, "
                         "stragglers %d, leaked %d"
                         % (label, got, want, others, len(stragglers),
                            res["leaked_blocks"]))
    return engine, reqs, res


def shard_logit_check(label, engine, model, params, reqs):
    """A sub-mesh engine's kernel path, teacher-forced through its
    partitioned paged programs, against the unsharded plain-LayerNorm
    path on the same tokens: within LOGIT_TOL."""
    out = []
    for r in reqs[:SHARD_LOGIT_REQUESTS]:
        ref = reference_logits(model, params, r.prompt, r.tokens)
        got = teacher_forced_kernel_logits(engine.model, engine._params,
                                           r.prompt, r.tokens,
                                           engine.block_size,
                                           dev=engine.device)
        err = float((got - ref).abs().max())
        out.append({"request": r.id, "positions": len(r.tokens),
                    "max_abs_err": err, "tol": LOGIT_TOL})
        log("%s logits, request %d (%d positions): sharded kernel path vs "
            "unsharded plain f32 err %.3e (tol %.0e)"
            % (label, r.id, len(r.tokens), err, LOGIT_TOL))
        if not err <= LOGIT_TOL:
            raise SystemExit("%s: sharded logits disagree with the plain "
                             "path" % label)
    return out


def add_launches(total, launches):
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def dense_shard_part(vocab, shard_counts, launches):
    """(a): GPT-2 small at ``vocab`` unsharded and at each shard count,
    paged and slot (and w8 + kv8 at 2 shards for V 50257): tokens equal
    under the 1e-3 margin rule, the kernel path within 1e-3 of the plain
    one, per-device bytes below the unsharded engine's with the total
    conserved."""
    model = TransformerKVModel(**dict(GPT2, vocab_size=vocab))
    params = card_params(model, 0)
    requests = phase3_traffic(vocab)
    out = {}
    modes = [("paged", {}), ("slot", dict(paged=False))]
    if 2 in shard_counts:
        modes.append(("w8+kv8", dict(quant="int8", kv_quant="int8")))
    for mode, kw in modes:
        quant = "quant" in kw
        # the margin rule's plain path: the quantized model's own
        ref_model = model.with_quant("int8", "int8") if quant else model
        ref_params = ref_model.quantize_params(params) if quant else params
        base_engine, base, out["%s 1 shard" % mode] = shard_serve(
            "V %d %s, 1 shard" % (vocab, mode), model, params, requests, 1,
            kw)
        add_launches(launches, out["%s 1 shard" % mode]["launches"])
        one = out["%s 1 shard" % mode]["memory_footprint"]
        del base_engine
        for k in shard_counts:
            key = "%s %d shards" % (mode, k)
            engine, reqs, out[key] = shard_serve(
                "V %d %s, %d shards" % (vocab, mode, k), model, params,
                requests, k, kw)
            add_launches(launches, out[key]["launches"])
            mf = out[key]["memory_footprint"]
            if mf["total_bytes"] != one["total_bytes"] or \
                    not mf["per_device_bytes"] < one["per_device_bytes"] \
                    or mf["devices"] != k:
                raise SystemExit("%s: memory footprint %s against the "
                                 "unsharded %s" % (key, mf, one))
            out[key]["parted"] = same_tokens(
                key + " vs 1 shard", ref_model, ref_params, requests, base,
                reqs)
            if mode == "paged":
                out[key]["logit_checks"] = shard_logit_check(
                    "V %d %d shards" % (vocab, k), engine, model, params,
                    reqs)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_routing(model, params, seqs, dev):
    """Per-expert routed rows of ``seqs`` teacher-forced through one paged
    prefill each (whole blocks of real tokens: no padding row, no trash
    block), every layer summed."""
    total = None
    for seq in seqs:
        n = min(16 * (len(seq) // 16), model.seq_len)
        if n == 0:
            continue
        pool = model.init_block_pool(n // 16 + 1, 16, device=dev)
        table = torch.arange(1, n // 16 + 1, device=dev)[None, :]
        zero = torch.zeros((1,), dtype=torch.long, device=dev)
        tape = []
        model.prefill_paged(params, pool, torch.tensor([seq[:n]], device=dev),
                            zero, zero + n, table, moe_tape=tape)
        cnt = torch.stack(tape).sum(dim=0)
        total = cnt if total is None else total + cnt
    return total.tolist()


def moe_shard_part(launches):
    """(b): GPT-2 small's widths with 8 experts top-1, unsharded (twice)
    and over 4 shards (2 experts each): tokens under the margin rule, the
    engines' routed totals equal, and the routing of the requests' real
    rows, teacher-forced through both models, equal expert by expert.
    The engines' per-expert loads are logged beside: they count padding
    rows, whose context is the trash block that duplicate-index writes
    fill in any order on the card."""
    model = TransformerKVModel(moe_experts=MOE_EXPERTS, **GPT2)
    params = card_params(model, 0)
    requests = phase3_traffic(model.vocab_size)
    out = {}
    runs = {}
    sharded = None
    for key, k in (("1 shard", 1), ("1 shard, again", 1), ("4 shards", 4)):
        engine, runs[key], res = shard_serve(
            "MoE paged, %s" % key, model, params, requests, k, {})
        add_launches(launches, res["launches"])
        res["expert_load"] = engine.expert_load().tolist()
        out[key] = res
        if k == 4:
            sharded = engine
        del engine
        torch.cuda.empty_cache()
    parted = same_tokens("MoE 4 shards vs 1 shard", model, params, requests,
                         runs["1 shard"], runs["4 shards"])
    loads = {k: out[k]["expert_load"] for k in out}
    seqs = [r.prompt + r.tokens for r in runs["1 shard"][:4]]
    want = moe_routing(model, params, seqs, torch.device("cuda", 0))
    got = moe_routing(sharded.model, sharded._params, seqs,
                      torch.device("cuda", 0))
    out.update(parted=parted, engine_loads=loads,
               routing_unsharded=want, routing_4_shards=got)
    log("MoE expert load (%s): engines (padding rows included) unsharded "
        "%s, again %s, 4 shards %s; real rows of 4 requests teacher-forced: "
        "unsharded %s, 4 shards %s, equal %s"
        % (card_name(), loads["1 shard"], loads["1 shard, again"],
           loads["4 shards"], want, got, want == got))
    if want != got or len({sum(v) for v in loads.values()}) != 1:
        raise SystemExit("MoE: routing %s vs %s, engine totals %s"
                         % (want, got, [sum(v) for v in loads.values()]))
    del params, sharded
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fleet_shard_part(model, params, requests, want, launches, records):
    """(c): `from_mesh(devices_per_replica=2, n_replicas=2)` over four
    entries of the card under ``engine_crash:3:replica0``: every request
    resolves with the fault-free tokens (margin rule), a flight-recorder
    dump names the dead replica, the respawn keeps its group."""
    grid = make_mesh((4,), ("model",),
                     devices=[torch.device("cuda", 0)] * 4)
    router = ReplicaRouter.from_mesh(model, params, mesh=grid,
                                     devices_per_replica=2, n_replicas=2,
                                     respawn=True, max_batch=8)
    widths = [e._mesh.devices.shape[0] for e in router.engines]
    router.warmup()
    with pinned(MXNET_CHAOS="engine_crash:3:replica0"):
        mx.chaos.reset()
        router.start()
        try:
            reset_counts()
            reqs, wall, gen = run_router(router, requests)
            add_launches(launches, read_counts())
        finally:
            router.stop()
    mx.chaos.reset()
    dumps = [r for r in records if r.get("type") == "flight_recorder"
             and r.get("reason") == "scheduler_death"]
    live = [e for e in router.engines if e._dead is None]
    res = {"widths": widths, "wall_s": wall, "generated_tokens": gen,
           "tokens_per_s": gen / wall,
           "failovers": mx.telemetry.registry().counter(
               "serve.failovers").value,
           "dumps": [(d["replica"], d["n"]) for d in dumps],
           "live_widths": [e._mesh.devices.shape[0] for e in live
                           if e._mesh is not None]}
    res["parted"] = same_tokens("from_mesh 2x2 under engine_crash vs 1 shard",
                                model, params, requests, want, reqs)
    log("from_mesh fleet (%s): replicas of %s shards, %d tokens in %.3f s = "
        "%.1f tok/s under engine_crash:3:replica0, failovers %d, "
        "flight-recorder dumps %s, live replicas' widths %s"
        % (card_name(), widths, gen, wall, res["tokens_per_s"],
           res["failovers"], res["dumps"], res["live_widths"]))
    if widths != [2, 2] or not res["failovers"] or not any(
            d[0] == "replica0" and d[1] > 0 for d in res["dumps"]) or \
            any(w != 2 for w in res["live_widths"]):
        raise SystemExit("from_mesh fleet: %s" % res)
    del router
    gc.collect()
    torch.cuda.empty_cache()
    return res


def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing CUDA operations it made (the engine's
    host syncs: each fetch of picked tokens)."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in seen)


# the `mx.tracing` functions the serving stack calls
TRACE_SITES = ("open_trace", "phase", "add_span", "on_finish", "context",
               "adopt", "dump")


@contextlib.contextmanager
def timed_tracing(acc):
    """Every call the serving stack makes into `mx.tracing` timed on the
    host's clock while the block runs: their seconds and their number
    summed into ``acc`` (the telemetry tap that feeds the flight
    recorder is not among them)."""
    saved = {n: getattr(mx.tracing, n) for n in TRACE_SITES}

    def wrap(fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc["s"] += time.perf_counter() - t0
                acc["calls"] += 1
        return timed
    for n, fn in saved.items():
        setattr(mx.tracing, n, wrap(fn))
    try:
        yield acc
    finally:
        for n, fn in saved.items():
            setattr(mx.tracing, n, fn)


def tracing_on_off(model, params, requests, launches):
    """(d): phase 3's requests through the default engine with tracing
    on, off, on, off in one process, after one untraced run whose
    requests are the phase's fault-free reference (a process's first
    serve makes one synchronizing call the later ones do not): the same
    tokens bit for bit, the same LayerNorm and flash launches, the same
    host syncs."""
    runs, first = [], None
    for on in (False, True, False, True, False):
        with pinned(MXNET_SERVE_TRACING="1" if on else "0"):
            mx.tracing.reset()
            engine = ServingEngine(model, params, max_batch=8)
            engine.warmup()
            acc = {"s": 0.0, "calls": 0}
            with timed_tracing(acc):
                (reqs, res), syncs = count_syncs(
                    lambda: serve(engine, requests))
            add_launches(launches, res["launches"])
            if first is None:
                first = reqs
                continue
            runs.append({"tracing": on, "tokens": [r.tokens for r in reqs],
                         "tokens_per_s": res["tokens_per_s"],
                         "ttft_ms_median": res["ttft_ms_median"],
                         "launches": res["launches"], "syncs": syncs,
                         "tracing_calls": acc["calls"],
                         "tracing_host_s": acc["s"],
                         "tracing_host_share": acc["s"] / res["wall_s"]})
            del engine
    mx.tracing.reset()
    same = [r.tokens for r in first] == runs[0]["tokens"] and all(
        r["tokens"] == runs[0]["tokens"]
        and r["launches"] == runs[0]["launches"]
        and r["syncs"] == runs[0]["syncs"] for r in runs)
    log("tracing on/off/on/off (%s): tok/s %s, ttft median %s ms, "
        "LayerNorm launches %s, host syncs %s; tracing calls %s, their "
        "host seconds %s, share of the serve's wall %s; tokens, launches "
        "and syncs equal: %s"
        % (card_name(), [r["tokens_per_s"] for r in runs],
           [r["ttft_ms_median"] for r in runs],
           [r["launches"]["layer_norm"] for r in runs],
           [r["syncs"] for r in runs], [r["tracing_calls"] for r in runs],
           [r["tracing_host_s"] for r in runs],
           [r["tracing_host_share"] for r in runs], same))
    if not same:
        raise SystemExit("tracing changed the tokens, the launches or the "
                         "host syncs")
    for r in runs:
        del r["tokens"]
    return runs, first


def disagg_shard_part(model, params, requests, want, launches, records):
    """(d): a prefill and a decode replica, unsharded and as 2-shard
    sub-mesh replicas, traced: every request one trace across both
    replicas, the handoff bytes equal to the unsharded pair's, tokens
    under the margin rule; then the gateway over the sharded pair, each
    SSE stream closing a ``gateway_send`` span."""
    out = {}
    fleets = {}
    for label, ctxs in (("unsharded", [None, None]),
                        ("2 shards", [card_group(2), card_group(2)])):
        before = mx.telemetry.registry().counter("serve.handoff_bytes").value
        engines = [ServingEngine(model, params, ctx=c, max_batch=8,
                                 name="%s%d" % ("replica" if i == 0 else
                                                "decode", i))
                   for i, c in enumerate(ctxs)]
        router = ReplicaRouter(engines, respawn=False, disagg=True,
                               prefill_replicas=1)
        router.warmup()
        router.start()
        reset_counts()
        reqs, wall, gen = run_router(router, requests)
        add_launches(launches, read_counts())
        nbytes = mx.telemetry.registry().counter(
            "serve.handoff_bytes").value - before
        ids = {r.id for r in reqs}
        spans = mx.tracing.spans(records)
        crossed = sum(1 for t in ids if {s["replica"] for s in spans.get(
            t, ())} >= {e.name for e in engines})
        out[label] = {"handoffs": engines[0].stats["handoffs"],
                      "handoff_bytes": nbytes, "wall_s": wall,
                      "tokens_per_s": gen / wall, "traces_across": crossed,
                      "parted": same_tokens(
                          "disagg %s vs 1 shard" % label, model, params,
                          requests, want, reqs)}
        log("disagg %s (%s): %d handoffs, %d B, %d tokens in %.3f s = %.1f "
            "tok/s, %d of %d traces across both replicas"
            % (label, card_name(), out[label]["handoffs"], nbytes, gen, wall,
               gen / wall, crossed, len(reqs)))
        if out[label]["handoffs"] != len(requests) or crossed != len(reqs):
            raise SystemExit("disagg %s: %s" % (label, out[label]))
        fleets[label] = router
    if out["2 shards"]["handoff_bytes"] != out["unsharded"]["handoff_bytes"]:
        raise SystemExit("the sharded pair handed off %d B, the unsharded "
                         "%d B" % (out["2 shards"]["handoff_bytes"],
                                   out["unsharded"]["handoff_bytes"]))
    fleets["unsharded"].stop()
    n_send = sum(1 for r in records if r.get("phase") == "gateway_send")
    out["gateway"] = gateway_part(fleets["2 shards"], requests)
    fleets["2 shards"].stop()
    sends = [r for r in records if r.get("phase") == "gateway_send"]
    out["gateway"]["gateway_send_spans"] = len(sends) - n_send
    if len(sends) - n_send < GATEWAY_REQUESTS:
        raise SystemExit("the gateway closed %d gateway_send spans"
                         % (len(sends) - n_send))
    del fleets
    gc.collect()
    torch.cuda.empty_cache()
    return out


def traced_megastep_sync_free(model, params, records):
    """A megastep engine with tracing on: 8 sampled rows admitted, then
    one scheduler iteration (`ServingEngine.step`: growth, the megastep
    launch and its token-grid copy, the host sweep and its
    ``host_sweep`` span, the event wait and the ``megastep`` span) under
    ``set_sync_debug_mode("error")``.  The spans must come from that
    iteration, on the engine's replica."""
    engine = ServingEngine(model, params, max_batch=8,
                           megastep=True, megastep_steps=4,
                           name="traced_mega")
    engine.warmup()
    rng = np.random.RandomState(3)
    reqs = [engine.submit(rng.randint(0, model.vocab_size, 16).tolist(),
                          max_new_tokens=16, temperature=0.8, top_k=40,
                          seed=i) for i in range(8)]
    while len(engine._active) < 8 or engine._pending_work():
        engine.step()
    torch.cuda.synchronize()

    def mine():
        return [r["phase"] for r in records if r.get("type") == "span"
                and r.get("replica") == engine.name and r.get("trace") == 0]
    n0 = len(mine())
    mega0 = engine.stats["megasteps"]
    errs0 = engine.stats.get("launch_errors", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    spans = mine()[n0:]
    iteration = {"megasteps": engine.stats["megasteps"] - mega0,
                 "launch_errors": engine.stats.get("launch_errors", 0)
                 - errs0, "spans": spans}
    engine.run_until_idle(timeout=120)
    ok = iteration["megasteps"] == 1 and iteration["launch_errors"] == 0 \
        and sorted(spans) == ["host_sweep", "megastep"] \
        and all(len(r.tokens) == 16 for r in reqs)
    log("no host sync, traced (%s): one engine.step() of megastep m=4 over "
        "8 sampled rows under set_sync_debug_mode('error'): %s"
        % (card_name(), iteration))
    if not ok:
        raise SystemExit("the traced megastep: %s, tokens %s"
                         % (iteration, [len(r.tokens) for r in reqs]))
    del engine
    torch.cuda.empty_cache()
    return iteration


def sharded_tracing_phase():
    """Phase 27: sub-mesh serving replicas and request tracing on GPT-2
    small in float32."""
    out = {"card": card_name()}
    launches = {}
    out["dense 50257"] = dense_shard_part(GPT2["vocab_size"], (2,), launches)
    out["dense 50304"] = dense_shard_part(PADDED_VOCAB, (4,), launches)
    out["moe"] = moe_shard_part(launches)
    model = TransformerKVModel(**GPT2)
    params = card_params(model, 0)
    requests = phase3_traffic(model.vocab_size)
    path = Path("chiprun_out") / "trace_phase27.jsonl"
    path.parent.mkdir(exist_ok=True)
    if path.exists():
        path.unlink()
    mem = mx.telemetry.add_sink(mx.telemetry.MemorySink())
    jsonl = mx.telemetry.add_sink(mx.telemetry.JsonlSink(str(path)))
    try:
        # the first traced run's requests are the fault-free reference
        out["tracing"], want = tracing_on_off(model, params, requests,
                                              launches)
        mx.tracing.reset()
        out["fleet"] = fleet_shard_part(model, params, requests, want,
                                        launches, mem.records)
        out["disagg"] = disagg_shard_part(model, params, requests, want,
                                          launches, mem.records)
        out["sync_free"] = traced_megastep_sync_free(model, params,
                                                     mem.records)
    finally:
        mx.telemetry.remove_sink(mem)
        mx.telemetry.remove_sink(jsonl)
        mx.tracing.reset()
    kinds = {}
    for r in mem.records:
        kinds[r.get("type")] = kinds.get(r.get("type"), 0) + 1
    chrome = Path("chiprun_out") / "trace_phase27_chrome.json"
    rep = subprocess.run([sys.executable, "tools/trace_report.py", str(path),
                          "--chrome", str(chrome)], capture_output=True,
                         text=True, timeout=300)
    out["trace_report"] = {"rc": rep.returncode, "records": kinds,
                           "bytes": path.stat().st_size,
                           "head": rep.stdout[:2000]}
    log("trace records (%s): %s, %d B of JSONL; tools/trace_report.py rc %d:"
        "\n%s" % (card_name(), kinds, out["trace_report"]["bytes"],
                  rep.returncode, rep.stdout[:1500]))
    if rep.returncode != 0 or "queue_wait" not in rep.stdout or \
            not json.loads(chrome.read_text()):
        raise SystemExit("tools/trace_report.py failed: %s" % rep.stderr)
    out["launches"] = launches
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kernels_line(cases, paths, f32_paths, wide_paths):
    """One entry per ported TPU function: launches on each path, and the
    error and times of its check at the training shape, in bf16; then one
    entry per route of the float32 flash forward and backward
    (`flash_attention_fwd_f32.cu`, `flash_attention_bwd_f32.cu`) and per
    float32 fused CE function (`fused_ce_f32.cu`), their launches those of
    the float32 paths ``f32_paths``; then the four wide kernels (head_dim
    above 256, `WIDE_ROWS`), their launches those of the paths
    ``wide_paths[dtype]``, their times those of `WIDE_TIMED`."""
    train = {"layer_norm": [32768, 768], "layer_norm_bwd": [32768, 768],
             "flash_attention": [32, 12, 1024, 1024, 64],
             "flash_attention_bwd": [32, 12, 1024, 1024, 64],
             "flash_attention_bsd": [32, 6, 1024, 1024, 128],
             "flash_attention_bsd_bwd": [32, 6, 1024, 1024, 128],
             "flash_attention_ds": [8, 6, 4096, 4096, 128],
             "flash_attention_ds_bwd": [8, 6, 4096, 4096, 128],
             "flash_attention_bsd_stream": [4, 6, 8192, 8192, 128],
             "flash_attention_bsd_stream_bwd": [4, 6, 8192, 8192, 128]}
    train.update({name: list(CE_TRAIN) for name, src, _, _ in KERNEL_ROWS
                  if src == "fused_ce_bf16.cu"})
    serving = {"layer_norm": [8, 768],
               "flash_attention": [1, 12, 1024, 1024, 64]}

    def serving_ms(name):
        # the served f32 path's check at its shape
        s = next(c for c in cases if c["kernel"] == name
                 and c["shape"] == serving[name]
                 and c["dtype"] == "torch.float32" and "rtol" in c)
        return {"shape": s["shape"], "dtype": s["dtype"], "ms": s["ms"],
                "ms_with_launch": s.get("ms_with_launch")}

    out = []
    for name, src, replaces, counters in KERNEL_ROWS:
        at = next(c for c in cases if c["kernel"] == name
                  and c["shape"] == train[name] and "ms" in c
                  and c["dtype"] == "torch.bfloat16")
        by_path = {p: {k: launches[k] for k in counters}
                   for p, launches in paths.items()}
        entry = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + src,
            "source_f32": "mxnet_tpu_torch/csrc/" + F32_SOURCE[src],
            "replaces": replaces,
            "launches": sum(v[counters[0]] for v in by_path.values()),
            "launches_by_path": by_path, "shape": at["shape"],
            "dtype": at["dtype"], "max_abs_err": at["max_abs_err"],
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "route_ms": at.get("route_ms"),
            **{k: at[k] for k in ("tflops", "bound_share", "ptxas",
                                  "bit_identical", "bf16_plain_rel_err",
                                  "cold_ms", "cold_bound_share", "plan",
                                  "kernel_split_ms")
               if k in at},
            "checks": [{k: c.get(k) for k in (
                "shape", "dtype", "max_abs_err", "rel_err", "rel_tol",
                "rtol", "atol")} for c in cases if c["kernel"] == name]}
        if name in serving:
            entry["serving_shape_ms"] = serving_ms(name)
        out.append(entry)
    for name, src, replaces, counters in KERNEL_ROWS:
        if name not in F32_ROWS:
            continue
        at = next(c for c in cases if c["kernel"] == name
                  and c["shape"] == train[name] and "ms" in c
                  and c["dtype"] == "torch.float32")
        by_path = {p: {k: launches[k] for k in counters}
                   for p, launches in f32_paths.items()}
        entry = {
            "name": name + "_f32", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + F32_SOURCE[src],
            "replaces": replaces,
            "launches": sum(v[counters[0]] for v in by_path.values()),
            "launches_by_path": by_path, "shape": at["shape"],
            "dtype": at["dtype"],
            **{k: at[k] for k in (
                "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "tflops", "bound_share",
                "bound_cuda_core_ms", "bit_identical", "ptxas")},
            "route_ms": at.get("route_ms")}
        if name in serving:
            entry["serving_shape_ms"] = serving_ms(name)
        out.append(entry)
    b, h, sq, d = WIDE_TIMED
    for name, src, replaces, counters, dtype in WIDE_ROWS:
        kernel = "flash_attention_bwd" if "bwd" in name else "flash_attention"
        at = next(c for c in cases if c["kernel"] == kernel
                  and c["shape"] == [b, h, sq, sq, d] and "ms" in c
                  and c["dtype"] == str(dtype))
        by_path = {p: {k: launches[k] for k in counters}
                   for p, launches in wide_paths[dtype].items()}
        out.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": sum(v[counters[0]] for v in by_path.values()),
            "launches_by_path": by_path, "shape": at["shape"],
            "dtype": at["dtype"],
            **{k: at.get(k) for k in (
                "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_backend",
                "bound_recompute_ms", "tflops", "bound_share",
                "bound_cuda_core_ms", "bit_identical", "ptxas")}})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    log("card: %s" % card)
    log("python %s, torch %s, CUDA %s, devices %d"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    phases = {}

    @contextlib.contextmanager
    def phase(name):
        t0 = time.perf_counter()
        yield
        phases[name] = time.perf_counter() - t0
        log("phase %s: %.2f s" % (name, phases[name]))

    with phase("build"):
        took = _build.build()
    log("kernel build: per source %s"
        % {k: round(v, 2) for k, v in took.items()})
    for name in _build.KERNELS:
        regs = [ln.split(":", 1)[1].strip()
                for ln in _build.build_log(name).splitlines()
                if "registers" in ln]
        log("ptxas %s: %s" % (name, regs))
    for name in ("layer_norm", "flash_attention_fwd",
                 "flash_attention_fwd_f32", "flash_attention_bwd",
                 "flash_attention_bwd_f32", "flash_attention_wide",
                 "flash_attention_wide_f32", "fused_ce_bf16", "fused_ce_f32"):
        log("ptxas registers, spill (stores, loads) bytes, %s: %s"
            % (name, ptxas_info(name)))

    with phase("kernel checks"):
        cases = kernel_checks() + training_kernel_checks()

    with phase("serving"):
        model = TransformerKVModel(**GPT2)
        t0 = time.perf_counter()
        params = model.params_from_jax(
            model.init_params(np.random.RandomState(0)), "cuda")
        log("GPT-2 small weights (seed 0) on the card in %.2f s"
            % (time.perf_counter() - t0))
        engine, paged = paged_path(model, params)
        profile = decode_profile(engine, model)
        del engine
        torch.cuda.empty_cache()
        engine, slot = slot_path(model, params)
        prefill_prof = prefill_profile(engine, model)
        del engine
        torch.cuda.empty_cache()

    with phase("serving, shared prefix and request contract"):
        prefix = prefix_phase(model, params)
        del params
        torch.cuda.empty_cache()

    per_layer = {"layer_norm": 2 * TRAIN["num_layers"] + 1,
                 "layer_norm_bwd": 2 * TRAIN["num_layers"] + 1}

    def flash(prefix):
        return {prefix + k: TRAIN["num_layers"] for k in ("", "_dq", "_dkv")}

    with phase("train bhsd and bsd"):
        hsd = train_path("train bhsd (parity)", PARITY, 7,
                         dict(per_layer, **flash("flash_attention")))
        grads = grad_check(PARITY, ("layer_norm_bwd", "flash_attention_dq",
                                    "flash_attention_dkv"))
        bsd = train_path("train bsd (geom fast)", GEOM_FAST, 3,
                         dict(per_layer, **flash("flash_attention_bsd")))
        bsd_grads = grad_check(
            GEOM_FAST, ("layer_norm_bwd", "flash_attention_bsd_dq",
                        "flash_attention_bsd_dkv"), "bsd config")

    with phase("train bhsd f32"):
        # the trainer's default dtype: every flash forward, dq and dk/dv
        # runs the float32 kernels
        hsd32 = train_path("train bhsd (parity) f32", PARITY, 3,
                           dict(per_layer, **flash("flash_attention")),
                           dtype="float32")

    with phase("fused CE"):
        ce_cases = fused_ce_checks()
        cases += ce_cases
        hsd_flash = flash("flash_attention")
        fused = train_path(
            "train fused (bench fused_)", FUSED, 5,
            dict(per_layer, **hsd_flash, fused_ce_fwd_sp=1,
                 fused_ce_bwd_dw=1), FUSED_TRAINER, after=fused_extras)
        five = five_pass_path(dict(per_layer, **hsd_flash, fused_ce_fwd=1,
                                   fused_ce_bwd_dx=1, fused_ce_bwd_dw=1))
        # the fused head in the trainer's default dtype with its default
        # float32 v: kernels B and C (5-pass: A, D and C; `forward`: A) run
        # the float32 source
        fused32 = train_path(
            "train fused f32", FUSED, 3,
            dict(per_layer, **hsd_flash, fused_ce_fwd_sp=1,
                 fused_ce_bwd_dw=1), dtype="float32",
            after=lambda t, d: {"forward": forward_check(t, d)})
        five32 = five_pass_path(dict(per_layer, **hsd_flash, fused_ce_fwd=1,
                                     fused_ce_bwd_dx=1, fused_ce_bwd_dw=1),
                                dtype="float32")
        fused_grads = grad_check(
            FUSED, ("layer_norm_bwd", "flash_attention_dq",
                    "flash_attention_dkv", "fused_ce_fwd_sp",
                    "fused_ce_bwd_dw"), "fused config")
        medium_grads = grad_check(
            MEDIUM_FUSED, ("layer_norm_bwd", "flash_attention_dq",
                           "flash_attention_dkv", "fused_ce_fwd_sp",
                           "fused_ce_bwd_dw"),
            "fused head at GPT-2 medium widths", size=1)
        medium_layers = MEDIUM_FUSED["num_layers"]
        medium = train_path(
            "train fused GPT-2 medium widths", MEDIUM_FUSED, 2,
            {"layer_norm": 2 * medium_layers + 1,
             "layer_norm_bwd": 2 * medium_layers + 1,
             "flash_attention": medium_layers,
             "flash_attention_dq": medium_layers,
             "flash_attention_dkv": medium_layers,
             "fused_ce_fwd_sp": 1, "fused_ce_bwd_dw": 1},
            FUSED_TRAINER, falls=False, batch=MEDIUM_BATCH)

    with phase("long-context kernel checks"):
        cases += longctx_kernel_checks()
    with phase("train longctx"):
        ds = train_path(
            "train longctx ds", LONGCTX_DS, 5,
            dict(per_layer, **flash("flash_attention_ds")), FUSED_TRAINER,
            batch=LONGCTX_DS_BATCH, pins={"MXNET_FLASH_LAYOUT": "ds"})
        stream = train_path(
            "train longctx stream", LONGCTX_STREAM, 5,
            dict(per_layer, **flash("flash_attention_bsd_stream")),
            FUSED_TRAINER, batch=LONGCTX_STREAM_BATCH,
            pins={"MXNET_FLASH_BSD_KERNEL": "stream"})
        stream_grads = grad_check(
            LONGCTX_STREAM, ("layer_norm_bwd",
                             "flash_attention_bsd_stream_dq",
                             "flash_attention_bsd_stream_dkv"),
            "longctx stream config", size=1,
            pins={"MXNET_FLASH_BSD_KERNEL": "stream"})
        ds_grads = grad_check(
            LONGCTX_DS, ("layer_norm_bwd", "flash_attention_ds_dq",
                         "flash_attention_ds_dkv"),
            "longctx ds config", size=1, pins={"MXNET_FLASH_LAYOUT": "ds"})

    with phase("reference API"):
        api_mnist = mnist_api_path()
        api_lm = api_lm_path(dict(per_layer, **flash("flash_attention")))

    with phase("conv nets"):
        resnet = resnet_path()
        conv_f32 = conv_f32_checks()
        resnet_grads = resnet_grad_check()
        resnet_ff = resnet_feedforward_path()
        others = {n: other_net_path(n) for n in OTHER_NETS}

    with phase("module API"):
        module_lm = module_lm_path(dict(per_layer, **flash("flash_attention")))
        spmd_module = spmd_module_path(
            dict(per_layer, **flash("flash_attention"), fused_ce_fwd_sp=1,
                 fused_ce_bwd_dw=1))
        bucketing = bucketing_path()

    with phase("fault tolerance"):
        faults = fault_tolerance_path(
            dict(per_layer, **flash("flash_attention")))
        faults["out_of_range"] = out_of_range_checks(
            torch.Generator(device="cuda").manual_seed(20))
        faults["storage"] = storage_checks()

    with phase("image records"):
        records = image_records_path(resnet_ff)

    with phase("head 256 and remat"):
        cases += head256_kernel_checks()
        head256 = head256_paths()
        head256["serving"] = head256_serving()
        remat_runs = remat_path()
        remat_runs["flash_grad_call"] = flash_grad_call_ms()
        memcost = memcost_path()

    with phase("wide heads and serving faults"):
        cases += wide_kernel_checks()
        wide = wide_paths()
        faults = dict(faults, serving=serving_faults_phase())

    with phase("speculative and megastep serving"):
        spec = spec_megastep_phase()
    with phase("host tier, sessions and quantization"):
        tiers = tier_session_quant_phase()
    with phase("MoE, disaggregated fleet and gateway"):
        moe = moe_disagg_gateway_phase()
    with phase("sub-mesh replicas and request tracing"):
        sharded = sharded_tracing_phase()
    crash = faults["serving"]["failover"]["engine_crash"]
    # the LM's LayerNorm launches join the LayerNorm rows; its float32
    # flash launches the float32 flash rows
    api_lm_ln = {k: (n if k.startswith("layer_norm") else 0)
                 for k, n in api_lm["launches"].items()}
    module_lm_ln = {k: (n if k.startswith("layer_norm") else 0)
                    for k, n in module_lm["launches"].items()}
    guarded_ln = {k: (n if k.startswith("layer_norm") else 0)
                  for k, n in faults["launches"].items()}

    kernels = kernels_line(cases, {
        "paged": paged["launches"], "slot": slot["launches"],
        **{"prefix " + k: v["launches"] for k, v in prefix.items()
           if isinstance(v, dict) and "launches" in v},
        "train_bhsd": hsd["launches"], "train_bsd": bsd["launches"],
        "train_fused": fused["launches"],
        "train_fused_5pass": five["launches"],
        "forward_fused": fused["forward"]["launches"],
        "train_fused_medium": medium["launches"],
        "train_longctx_ds": ds["launches"],
        "train_longctx_stream": stream["launches"],
        "api_lm_simple_bind": api_lm_ln,
        "module_lm_fit": module_lm_ln,
        "module_lm_fit_guarded": guarded_ln,
        "spmd_module_fit_fused": spmd_module["launches"],
        "train_head256_bhsd": head256["bhsd"]["launches"],
        "train_head256_bsd": head256["bsd"]["launches"],
        "train_wide_bhsd": wide["bhsd"]["launches"],
        "serving_failover_f32": {
            k: (n if k.startswith("layer_norm") else 0)
            for k, n in crash["launches"].items()},
        "serving_spec_megastep_f32": {
            k: (n if k.startswith("layer_norm") else 0)
            for k, n in spec["launches"].items()},
        "serving_tier_session_quant_f32": {
            k: (n if k.startswith("layer_norm") else 0)
            for k, n in tiers["launches"].items()},
        "serving_moe_disagg_gateway_f32": {
            k: (n if k.startswith("layer_norm") else 0)
            for k, n in moe["launches"].items()},
        "serving_sharded_tracing_f32": {
            k: (n if k.startswith("layer_norm") else 0)
            for k, n in sharded["launches"].items()}}, {
        "slot": slot["launches"],
        "train_bhsd_f32": hsd32["launches"],
        "train_fused_f32": fused32["launches"],
        "train_fused_5pass_f32": five32["launches"],
        "forward_fused_f32": fused32["forward"]["launches"],
        "gradients_parity": grads["launches"],
        "gradients_bsd": bsd_grads["launches"],
        "gradients_fused": fused_grads["launches"],
        "gradients_fused_medium": medium_grads["launches"],
        "gradients_longctx_ds": ds_grads["launches"],
        "gradients_longctx_stream": stream_grads["launches"],
        "api_lm_simple_bind_f32": api_lm["launches"],
        "module_lm_fit_f32": module_lm["launches"],
        "module_lm_fit_guarded_f32": faults["launches"],
        "gradients_head256": head256["gradients"]["launches"],
        "slot_head256_f32": head256["serving"]["launches"],
        "gradients_wide": wide["gradients"]["launches"],
        "serving_failover_f32": crash["launches"],
        "serving_spec_megastep_f32": spec["launches"],
        "serving_tier_session_quant_f32": tiers["launches"],
        "serving_moe_disagg_gateway_f32": moe["launches"],
        "serving_sharded_tracing_f32": sharded["launches"]}, {
        torch.bfloat16: {"train_wide_bhsd": wide["bhsd"]["launches"]},
        torch.float32: {"gradients_wide": wide["gradients"]["launches"]}})
    idle = [e["name"] for e in kernels if not e["launches"]]
    if idle:
        raise SystemExit("kernels launched on no path: %s" % idle)
    log("phase seconds: %s" % {k: round(v, 2) for k, v in phases.items()})
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": took,
         "ptxas": {name: ptxas_info(name) for name in _build.KERNELS},
         "phase_s": phases, "cases": cases, "paged": paged,
         "slot": slot, "prefix": prefix, "decode_profile": profile,
         "prefill_profile": prefill_prof, "train_bhsd": hsd,
         "gradients": grads, "train_bsd": bsd, "gradients_bsd": bsd_grads,
         "train_bhsd_f32": hsd32,
         "train_fused": fused,
         "train_fused_5pass": five, "train_fused_f32": fused32,
         "train_fused_5pass_f32": five32, "gradients_fused": fused_grads,
         "train_fused_medium": medium,
         "gradients_fused_medium": medium_grads,
         "train_longctx_ds": ds, "train_longctx_stream": stream,
         "gradients_longctx_stream": stream_grads,
         "gradients_longctx_ds": ds_grads, "api_mnist": api_mnist,
         "api_lm": api_lm, "resnet50": resnet, "conv_f32": conv_f32,
         "resnet50_gradients": resnet_grads,
         "resnet50_feedforward": resnet_ff, "other_nets": others,
         "module_lm": module_lm, "spmd_module": spmd_module,
         "bucketing": bucketing, "fault_tolerance": faults,
         "image_records": records, "head256": head256,
         "remat": remat_runs, "memcost": memcost, "wide": wide,
         "spec_megastep": spec, "tier_session_quant": tiers,
         "moe_disagg_gateway": moe, "sharded_tracing": sharded,
         "kernels": kernels},
        indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
