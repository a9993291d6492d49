#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py            # needs one CUDA card

Phases, each reported on its own line:

1. build     nvcc builds every kernel of the port from ``csrc/``, one
             process per source, all at once.
2. kernels   each kernel against its plain PyTorch version on the card, at
             the shapes its path gives it (phi4-mini-3.8b serving widths,
             ``paged_attention`` at the serve cell's decode and the ring
             cell's, 4 slots of up to 16000 tokens, with inactive rows and
             odd widths, and no host sync a call; mamba2-780m training
             widths for ``ssd_scan`` and the int8 projections;
             phi4-mini-3.8b training at 2 x 4096 tokens for
             ``flash_attention``, plus window + softcap + GQA, stride-2
             perforation, ragged Sq != Skv cases, hd 64 and a caller
             grid of 48 x 80 that leaves rows fully masked, each in fp32
             and in bf16 and through the design ``select_flash_design``
             names, the tiled one for fp32 and tc for bf16 at hd 64, 80,
             128 and 256 (ragged cases at hd 80 and 256), and "simple" at
             the smoke configs' hd 16 (GQA and MQA, causal, and gemma2's
             smoke window and softcap), with the transcendentals' floor
             beside the bound), fp32 and bf16, with
             its time beside the plain version's, a library call's where one
             computes the same function, and its bound. Then the training
             path's gradients: ``ssd_scan``'s backward kernels against
             the closed form in plain PyTorch (a small and the training
             shape, fp32 and bf16, bit-equal from run to run), ``SSDScan``
             (forward and backward kernels) against autograd through
             ``ssd_chunked_ref`` on the CPU, the backward's time at the
             training shape,
             ``FlashAttention`` against the plain version's VJP on the CPU,
             one layer's attention core at phi4-mini's training cell timed
             through the kernel and through ``_causal_chunked`` at stride
             1 and 2, and the differentiable ``quantized_matmul``'s gradients (zero
             pattern included) against the CPU plain path. ``int8_matmul``
             at every shape a path launches (decode M 1 and 8 with L2 cold,
             admission M 128 and 2048, mamba2 and phi4-mini training,
             gemma2-27b's MLP on the serve-dense cell at M 8, 104, 512),
             bit for bit in each of its three designs, beside
             ``torch._int_mm`` on both layouts of the weight, and
             ``quantize_rows`` forward and backward at the shapes the
             int8 paths quantise, bit for bit. ``ring_hop``
             at the ring cell's hop (phi4-mini heads, Cl 512 of a 2048-token
             chunk over 4 shards, Ll 4096) with bf16, fp32 and int8 K/V,
             carried state, position holes and rows that see nothing, plus
             window + softcap + GQA, each through the design
             ``select_hop_design`` names (tensor-core "tc" for bf16
             queries, "simt" for fp32), the cell cases also as one
             4-shard ``ring_hop_step``, timed beside
             ``scaled_dot_product_attention``; then the whole
             ``ring_chunk_attention`` at the cell's chunk (C 2048, L 16384,
             bf16) against the single-device path, timed beside it and
             beside ``scaled_dot_product_attention``, with its host syncs
             counted (one).
3. parity    phi4-mini-3.8b-smoke served in fp32 twice from the same seeded
             weights, on the card and on the CPU: the greedy token streams
             of each serving rung must be equal. mamba2-780m-smoke (4 x 32
             tokens, no remat) and phi4-mini-3.8b-smoke (2 x 1024 tokens,
             remat "full"; 2 x 4096 until its CPU run's ~45 s was cut to
             keep the script in its time limit) trained in fp32 three steps on each training
             rung, on the card (each rung's step one CUDA graph, its first
             step the eager warm-up) and on the CPU (eager) from the same
             weights: the losses must agree. phi4-mini-3.8b-smoke served in
             fp32 under a 4x1 mesh on every serving rung: the ring engine
             on the card, the same engine on the CPU and the single-device
             engine on the card give the same greedy streams.
4. serve     the serving slice at full width: ``repro_torch.launch.serve``
             on phi4-mini-3.8b (16 of its 32 layers, bf16, random
             weights) under a QoS
             target tight enough that the Pliant runtime swaps variants,
             launch counters zeroed just before and read just after; then a
             ``request_variant`` walk timing decode steps per rung.
   megastep  the same weights under the megastep (K 8; each megastep K
             replays of one CUDA graph of the decode step): ``sample_token``
             at temperature 0.7 on the card against the CPU on (8, 200064)
             logits, the same tokens; on every rung the per-step and the
             megastep engine serve the same 8 prompts of 128 tokens with
             equal greedy streams, then a profiled window of each (wall and
             device busy a token, busy share), one replayed body's time,
             graphs captured and their seconds, dispatches a token; host
             syncs in one replay, in the body run eagerly and in a steady
             round (0 each); a swap precise -> int8+kvq8 with a megastep
             in flight, streams equal to the per-step engine's under the
             same swap; K 1 against K 8 at temperature 0.7; and the serve
             run again under ``--megastep 8``, its launches counted as each
             graph's capture times its replays.
5. profile   ``torch.profiler`` over decode steps of a full batch per rung.
6. train     the training slice at full width: ``repro_torch.launch.train``
             on mamba2-780m (24 of its 48 layers, fp32 params, batch 4 x
             1024 tokens, random weights) under ``--pliant``, each rung's
             step one CUDA graph (captured at its first step, which runs
             eagerly), launch counters zeroed just before and read just
             after, each graph's replays counted in; then, from one state,
             three steps over a rung switch (precise, int8, int8+drop50%)
             through the graphs and through the eager steps they wrap:
             losses, grad norms, parameters and AdamW moments equal bit
             for bit; then each training rung pinned, replayed and eager
             (median step time, peak memory, the graph's capture seconds
             and pool, host syncs in a replayed step: none), and one
             profiled step per rung each way (device-busy share, largest
             kernels, device time between CUDA events).
7. train-attn  the dense-attention training slice at full width:
             ``repro_torch.launch.train.main(..., remat="full")`` on
             phi4-mini-3.8b (8 of its 32 layers, fp32 params and AdamW,
             batch 2 x 4096 tokens, random weights) under ``--pliant``,
             as phase 6 (graphs, launches, the bit-for-bit witness over
             precise, int8 and int8+drop50%); then each rung pinned,
             replayed and eager, the int8 rung again with its causal
             attention through ``_causal_chunked`` at stride 1 (the stride
             rung less its perforation; eager, since the patch cannot
             reach a graph captured before it), and one profiled replayed
             step per rung.
8. serve-ring  ring-attention admission at full width: phi4-mini-3.8b
             (32 layers, bf16, random weights) served under a 4x1 mesh on
             the one card (4 sequence shards run in turn), 4 slots, max_len
             16384, chunk 2048, prompts of 16000, 12000, 9000 and 8194
             tokens, on precise and int8+kvq8, launch counters zeroed just
             before and read just after each ring run; each rung again on
             the single-device engine: admission ms a chunk on both paths,
             the mean decode step on both engines and ``paged_attention``'s
             share of a profiled one, hops run and skipped, one
             ``ring_hop`` launch a ring step, all of design "tc", the
             first-token logits gate, and a ``torch.profiler`` summary of
             the deepest full chunk on both paths.

9. colocate  the colocation harness at full width,
             ``repro_torch.launch.colocate``: phi4-mini-3.8b serving (32
             layers, bf16, 8 slots, max_len 1024, page 16, 4 requests of
             128 prompt and 16 new tokens, Poisson arrivals at 1.0 req/s;
             16 requests before serve-ssm was added, 12 before serve-moe,
             6 before train-encdec; 32 new tokens until train-encdec ran
             over the script's time limit)
             and mamba2-780m training (24 of its 48 layers, fp32 params
             and AdamW,
             1 x 512 tokens, 8 duty-cycle quanta, a decision every 1 s)
             on the one card, serially on one stream, the train steps one
             CUDA graph a rung; first each training rung's step time at
             that shape, replayed and eager. Four runs on the same
             weights, requests and seeds: (a) serve alone in a loop of
             this script's, (b) precise colocation (QoS target 1000 s, no
             action), (c) Pliant with the interference-aware arbiter and
             (d) with round-robin, both at the geometric mean of (a)'s
             and (b)'s p99. A line a run: token gaps p50 / p99 and
             violation rate at that target, tok/s, wall, decode steps,
             admission times, train steps, rungs, quality loss and final
             loss, actions and what the monitor read, final variants,
             pages and quanta reclaimed, int8 weight cache drops and
             misses, the train graphs (captures, seconds, replays),
             device memory before, at peak and after; the streams
             of (b) equal to (a)'s; launch counters zeroed just before
             and read just after (c), the train graphs' replays counted
             in. Checks: every request done, train
             steps in (b)-(d), no action in (b), in (c) and (d) decisions
             made and an action for every one that read a violation,
             the int8 kernels launched where (c) ran an int8 rung, the
             four runs under ``COLO_BUDGET_S``.

10. serve-dense  the dense serving engine (per-slot rings, synchronous
             chunked admission with a slot insert; the engine's default):
             gemma2-27b-smoke in fp32 on every serving rung, prompts past
             its 32-token window, the greedy streams on the card equal to
             the CPU's and to the paged engine's on the card; then
             ``repro_torch.launch.serve`` on gemma2-27b cut to 4 of its
             46 layers (bf16, random weights, 8 slots, max_len 8192, chunks
             of 512, 12 requests of 4200-7600 prompt tokens, so every local
             ring wraps, 32 new tokens, greedy) under a QoS target tight
             enough that the runtime swaps variants, launch counters zeroed
             just before and read just after (``int8_matmul`` and
             ``quantize_rows`` launched where an int8 rung ran,
             ``paged_attention`` not at all); a ``request_variant`` walk,
             the dense and the paged engine on each rung serving the same
             8 prompts: admission ms a chunk, the mean decode step, a
             profiled window's busy share and decode attention's share of
             the device time, no host sync in the dense decode step;
             ``prefill_with_cache`` on one 7600-token prompt (one bf16
             ``flash_attention`` a layer, each call timed), its first-token
             logits against chunked admission's within 0.5 of their rms,
             both handoffs' rings holding the same positions with their
             cursors at the next slot and K/V within 0.5 of their rms, then
             32 decode steps teacher-forced through both, each step's
             logits within 0.15 of their rms, its ``flash_attention``
             launches (one a layer) all of design tc, its time beside the
             614.6 ms the simple design took on an H100 at 16 layers;
             ``flash_attention`` at that shape
             (causal and window 4096, softcap 50, and causal without it)
             beside its plain version and ``scaled_dot_product_attention``
             without the softcap; device memory before, at peak and after.

11. serve-ssm  Mamba serving and the zamba2 hybrid: ``ssd_scan`` with the
             state in and out (``ssd_scan_state``: a ragged length padded
             to the kernels' chunks) at zamba2-2.7b's admission chunks (H
             80, P 64, N 64; 128 tokens, the 16 between two registered
             boundaries, a ragged 44 and 45) and its 2048-token
             ``prefill_with_cache``, and at mamba2-780m's (H 48, N 128),
             fp32 and bf16, against the plain version unpadded at the JAX
             package's chunk, y and the final state, timed beside the
             plain version and the bound; ``flash_attention`` at the
             handoff's shape (MHA, 32 heads of 80, 2048 tokens, causal),
             bf16 through tc and fp32 through tiled, beside cuDNN and
             ``scaled_dot_product_attention`` and the bound;
             ``paged_attention`` at zamba2's
             shared-attention decode (MHA, R 1, hd 80, page 16, M 256, bf16
             and int8 K/V), ``int8_matmul`` and ``quantize_rows`` at its
             int8 products (2560 -> 5120, 5120 -> 2560, 2560 -> 10240,
             10240 -> 2560 at M 8, 16 and 128, and the weights' rows),
             each against its plain version as in the kernels phase;
             zamba2-2.7b-smoke and
             mamba2-780m-smoke in fp32 on every serving rung, the card's
             dense, paged and megastep streams equal to the CPU's; then
             ``repro_torch.launch.serve --paged`` on zamba2-2.7b at full
             width cut to 24 of its 54 layers (20 Mamba2 and 4 calls of
             the one shared attention block; bf16, random weights, 8 slots,
             max_len 4096, page 16, chunk 128, 6 requests of 512-3072
             prompt tokens, 32 new tokens, greedy) under a QoS target
             tight enough that the runtime swaps variants, launch counters
             zeroed just before and read just after (``ssd_scan`` 4 a
             Mamba layer an admission chunk, ``paged_attention``, and
             ``int8_matmul`` on an int8 rung); its prompts register more
             SSM snapshots than the engine's byte budget holds: the prefix
             index evicts to stay under it, and the snapshots, in pinned
             host memory, keep the card's peak under ``SSM_PEAK_GIB``; a
             ``request_variant`` walk,
             the dense and the paged engine on each rung serving 8 prompts
             of 32 tokens: admission ms a chunk and a token, the mean
             decode step, a profiled window's busy share, on precise the
             shares of Mamba decode and attention decode and no host sync
             in the paged decode step; the megastep (K 8) on precise and
             int8+kvq8 (8 prompts of 64 tokens), streams equal to the
             per-step engine's, the decode step beside the megastep's wall
             a token; a prefix hit (256 tokens, 192 shared) that restores
             an SSM snapshot, its stream equal to a cold run's, no host
             sync in taking a snapshot; ``prefill_with_cache`` on a
             2048-token prompt against chunked admission (one
             ``flash_attention`` a shared-attention call, tc in bf16 and
             tiled in fp32, none simple): in bf16 the
             first-token logits within 0.5 of their rms and the Mamba
             states within 0.1 (relative Frobenius norm, worst layer), and
             on the same weights in fp32 logits within 1e-3 of their rms
             and states within 1e-4 (worst layer and worst head: the
             handoff is exact up to fp32 sums); device memory before, at
             peak and after.

12. serve-moe  MoE serving: ``int8_matmul`` with the experts on its grid
             (one launch for 64 experts) at olmoe-1b-7b's expert products
             (K 2048 -> N 1024 for ``wi_gate`` and ``wi_up``, 1024 -> 2048
             for ``wo``) at decode's capacity (8 rows an expert, design B,
             the weights L2 cold) and a 128-token chunk's (24 rows, design
             A), bit for bit against its plain version, timed beside it and
             the bound (library null: no single PyTorch call computes the
             batched product); ``quantize_rows`` at the stacked weights'
             rows and the experts' activations; ``paged_attention`` at
             olmoe's decode (MHA, hd 128, page 16, bf16 and int8 K/V); the
             precise gate product's fp32 output against the fp32 upcast;
             olmoe-1b-7b-smoke in fp32 on precise, int8, int8+kvq8 and a
             topk1 rung, the card's dense, paged and megastep streams
             equal to the CPU's; then ``repro_torch.launch.serve --paged``
             on olmoe-1b-7b at full width cut to 8 of its 16 layers (d_model
             2048, 16 heads of 128, 64 experts of d_ff 1024, top-8; bf16,
             random weights, 8 slots, max_len 4096, page 16, chunk 128, 12
             requests of 256-2048 prompt tokens, 32 new tokens, greedy)
             under a QoS target tight enough that the runtime swaps
             variants, launch counters zeroed just before and read just
             after (3 ``int8_matmul`` launches a MoE layer a forward on an
             int8 rung); a ``request_variant`` walk over precise, int8,
             int8+kvq8 and topk4 (the explorer's table with that rung
             appended), the dense and the paged engine serving the same 8
             prompts of 128 tokens: admission ms a chunk, the mean decode
             step, a profiled window's busy share, on precise MoE's share
             of the device time, no host sync in the paged decode step, and
             topk4's decode step beside precise's next to the explorer's
             price; the megastep (K 8) on precise and int8+kvq8, streams
             equal to the per-step engine's, no host sync in a replay;
             ``prefill_with_cache`` on a 2048-token prompt at capacity
             factor 16 against chunked admission: in bf16 the first-token
             logits and 16 teacher-forced decode steps within 0.5 of their
             rms, the tokens routed to another expert set counted; on the
             same weights in fp32, logits, steps and ring K/V within 1e-3
             (the handoff is exact up to fp32 sums); device memory before,
             at peak and after.

13. train-encdec  training every family: ``flash_attention`` at
             whisper-large-v3's shapes (its encoder, non-causal over 1500
             frames, 20 heads of 64; the decoder's causal 448 tokens; the
             cross attention, 448 queries over 1500 frames; the decode
             step's cross attention, one query a row over 1500 frames) and
             paligemma-3b's (MQA, 8 heads of 256 over one K/V head, 512
             tokens, design tiled in fp32 and tc in bf16), beside
             ``scaled_dot_product_attention`` and the bound;
             ``int8_matmul`` and ``quantize_rows`` at their int8 MLP
             products (whisper 6000 and 1792 rows of 1280 <-> 5120,
             paligemma 1024 rows of 2048 <-> 16384), bit for bit; the
             experts' stacked int8 product under autograd at olmoe's
             expert shapes against the CPU plain path (zero pattern
             included) and its backward's exact sums (one stacked
             launch) bit for bit, timed; flash's backward at paligemma's
             shape, its gradients and peak memory. whisper-large-v3-smoke
             and paligemma-3b-smoke trained in fp32 three steps a rung on
             the card (graphs) and on the CPU from the same weights: the
             losses agree. Then ``repro_torch.launch.train`` on
             whisper-large-v3 at full width and depth (32 + 32 layers,
             d_model 1280, fp32 and AdamW, 4 x 448 tokens over 1500
             frames, random weights)
             under ``--pliant``, remat "full", each rung's step one CUDA
             graph, launch counters zeroed just before and read just
             after, the replays counted in; each rung
             pinned (median step, peak memory); its decode (8 rows, 64
             teacher-forced steps, the cross K/V recomputed every step)
             against the full forward in bf16 and, as the witness, fp32
             (16 steps); at full width cut to 2 + 2 layers, 8 steps with
             ``--ckpt-dir`` and ``--ckpt-period 4`` (the step-4
             checkpoint written on a thread while steps 5-8 run, then step
             8's; each manifest's leaf count, shapes and step, and its
             stored optimizer step, held), then ``--resume`` from step 4
             to 8, the losses equal; then
             paligemma-3b at full width and depth (18 layers, 2 x (256 +
             256) tokens, remat "full"): one step through the driver, 3
             steps a rung pinned, and ``make_prefill_fn`` in bf16 (one
             tc flash launch a layer; the training's are tiled, none
             simple); device memory before, at peak and after each run.

14. serve-elastic  (run after serve-ring) elastic serving with the paged
             decode sharded by slot affinity: ``paged_attention`` as the
             sharded decode launches it at the cell's shape (8 slots of
             512-2048 tokens in a 4-shard pool of 3,080 pages of 16, bf16
             and int8 K/V): one launch a shard (2 slots, the shard's pages
             as a view, the block table rebased, the whole pool's page
             split) bit-equal to one whole-pool launch, both timed beside
             the plain version and the bound; then
             ``repro_torch.launch.serve --paged --mesh 4x2 --chaos
             "revoke@6+2:2,restore@30"`` on phi4-mini-3.8b at full width
             cut to 8 of its 32 layers (bf16, random weights, 8 slots,
             max_len 4096, page 16, chunk 512, 8 requests of 512-2048
             prompt and 24 new tokens, a 1 ms target so the runtime walks
             to the int8 rungs), launch counters zeroed just before and
             read just after: the mesh shrinks to 2x2 at step 8 with
             admissions and decodes in flight and grows back at step 30,
             every request done, none rejected, 2 re-homes, the pool
             consistent, decode through one launch a shard and never the
             gather path; each re-home's mesh, pages migrated, cutover and
             recovery; the same weights and prompts on precise and
             int8+kvq8, per step and under the megastep (K 8), unfaulted
             and faulted (a megastep run, ~20 rounds, restores at two
             thirds of its unfaulted rounds), the bf16 streams equal and
             the first index where they differ; the sharded decode step
             beside the single-device engine's; and, as the witness, the
             same at 4 layers in fp32: the faulted run's tokens equal the
             unfaulted run's and the single-device engine's.

15. serve-gemma3  (run after serve-dense) gemma3-12b's prefill:
             ``flash_attention`` at its shapes over one 8192-token prompt
             (16 heads of 256 over 8 KV heads, bf16, causal for the global
             layer and window 1024 for the local ones) through tc, beside
             its plain version, the bound and
             ``scaled_dot_product_attention`` with cuDNN forced; then
             gemma3-12b at full width cut to 6 of its 48 layers (one 5:1
             period; bf16, random weights): ``prefill_with_cache`` on one
             8192-token prompt, launch counters zeroed just before and read
             just after (one tc ``flash_attention`` a layer, none simple,
             each timed by CUDA events), its first-token logits and the
             rings it hands to decode against chunked admission's (chunks
             of 512) within 0.5 of their rms; device memory before, at
             peak and after.

16. train-pod  (run after train-rungs) the colocated approximate
             co-runner trained data-parallel across pods: mamba2-780m at
             full width (24 of its 48 layers, fp32 and AdamW, 4 x 1024
             tokens) on a (pod 2, data 2) mesh of 4 positions of the card,
             every step's gradients through the owned gradient-sync region
             (``dist.collectives.grad_sync``: the in-pod mean, then the pod
             mean, over the int8 wire on ``gint8``), each rung one CUDA
             graph with the region inside it, 6 steps from one state: the
             explorer's four rungs and ``gint8`` and ``sync/2`` forced by
             name; precise also without the mesh (8 steps). Gates:
             precise on the mesh equal to the single-device step (losses
             equal, params within 1e-6 relative); ``sync/2``'s graph holds
             no pod collective (``WIRE``) and its params after
             ``pod_sync`` at step 2 equal precise's within 1e-6;
             ``gint8``'s params after a step within the JAX test's rtol
             0.02 / atol 1e-4 of precise's and within 1e-6 of the update
             from the same gradients through the general per-position form
             of the int8 pod mean (``collectives.compressed_pmean`` on
             each position's blocks); no host sync in a replay. Each rung's replayed ms a step against
             the single-device step, its wire bytes a step by axis, and
             ``gint8``'s and ``sync/2``'s ratios to precise beside the
             explorer's 0.3 and 0.5, capture seconds and pool; launch
             counters zeroed just before and read just after. Then
             ``repro_torch.launch.train --pod-mesh --positions 4 --chaos
             "revoke@3:2,restore@6"`` (8 steps, precise): the mesh shrinks
             to 1x2 and grows back, each re-home's seconds printed, its
             losses equal to the unfaulted mesh run's within 1e-6.

17. train-ep  (run after serve-moe) MoE training with the experts spread
             over the model axis: olmoe-1b-7b at full width (64 experts,
             top-8, d_model 2048, expert d_ff 1024) cut to 2 of its 16
             layers, fp32, on a (data 2, model 4) mesh, ``ep_axis`` model,
             8 x 512 tokens (512 a position). Gates: at capacity factor 8
             EP's cross-entropy and its gradients equal the local MoE's
             within the JAX test's rtol 2e-4 / atol 2e-5, and on the int8
             rung the cross-entropy within 1e-4 and the gradients within
             1e-4 relative / 2e-4 absolute but for at most a millionth of
             the entries (upstream sums in another order flip a few int8
             codes of the second layer's inputs); on one MoE
             layer's equal inputs the experts' int8 backward a shard
             within 1e-4 relative / 2e-4 absolute of the local int8
             MoE's; at the config's capacity factor one
             MoE layer's keep masks a position equal to a plain version's
             written from the definition (``plain_ep``: its own routing,
             capacity and aux loss, each expert applied to its kept rows,
             no buffers and no exchange, independent of
             ``models/moe.py``), its output within 1e-5, its aux loss
             within 1e-5 relative, and the gradients of the output's
             projection plus 0.01 x the aux loss (the train step's
             coefficient) to the input, the router and the experts within
             2e-5 of the plain version's (max |diff| over max |plain|); on
             the int8 rung one ``int8_matmul`` launch an expert shard a
             product in a forward (48 at 2 layers). The train step local and EP,
             precise and int8, each one CUDA graph: ms a step, tokens
             dropped a shard, the exchange's bytes.

18. dryrun  (run after train-pod) the dry-run (``repro_torch.launch
             .dryrun``): one position's program traced on ``meta`` tensors
             under the counting mode (``repro_torch.cost``), the traces
             run in two spawned worker processes (no CUDA) from the build
             on, beside the card's phases. The production cells'
             one-line summaries and trace seconds: mamba2-780m train_4k on
             pod, precise and int8; phi4-mini-3.8b decode_32k on pod;
             olmoe-1b-7b train_4k on pod (the expert exchange);
             mamba2-780m's pod sync on multipod, full precision and over
             the int8 wire. The train phase's cell (mamba2-780m, 24 of 48
             layers, 4 x 1024, fp32 + AdamW, one position) traced on meta
             and counted around one eager step on the card (the same
             program, precise and int8): FLOPs, bytes, kernel records and
             the op table equal, argument bytes equal to the card's
             params, moments, batch and step counter, the traced peak
             within ``DRY_PEAK_REL`` of ``max_memory_allocated`` over the
             step, ``roofline_fraction`` predicted beside the model FLOPs
             at the fp32 peak over phase 6's replayed step; the step's
             launches equal ``mamba_launches``. The train-pod cell's owned
             wire bytes a position from the trace equal to ``WIRE``'s in
             phase 16 (precise, ``gint8``, ``sync/2`` and its
             ``pod_sync``). ``decode_kv_share`` of the serve cell
             (phi4-mini-3.8b at 16 layers, 8 slots, max_len 1024) beside
             the paged driver's table priced from it and at the 0.5
             fallback.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``. Any
failure raises: the script then exits non-zero without the result line, as
it does when CUDA is unavailable or the repository's sources are missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# NVIDIA H100 SXM published peaks (dense, 700 W): device memory bytes/s and
# the operation rates for the kernels' input types.
HBM_BW = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# transcendentals (MUFU: ex2, rcp, tanh, ...) a second: 16 an SM a clock,
# 132 SMs at the 1980 MHz boost clock
SFU_OPS = 16 * 132 * 1.98e9

# bf16 rounds to 8 significant bits: kernel and plain version sum in other
# orders, so their bf16 outputs may differ by one bf16 step (2^-7 relative;
# the attention outputs here stay below 4 in magnitude).
BF16_ATOL = 2 ** -7 * 4
FP32_ATOL = 2e-5        # fp32 attention: reassociated sums of ~1e3 terms
# bf16 flash attention, per element: one bf16 step (2^-7 |ref|) plus
# BF16_ROW times the rms of the element's output row (see check_flash).
BF16_ROW = 2 ** -6


def timed(fn, device, iters=20, warmup=3):
    """Mean milliseconds of ``fn()`` over ``iters`` calls (CUDA events on
    the card, after ``warmup`` calls). The card first spins for about as
    long as the host took to enqueue the warm-up calls (at most 50 ms), so
    the timed calls queue up behind it: a kernel shorter than its launch's
    host work is timed on the card, not at the host's pace."""
    import torch
    if device.type != "cuda":
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda._sleep(int(2e9 * min(1.5 * host_s * iters, 0.05)))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def dev_us(e):
    """A profiler event's own device time, us."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------- int8_matmul --

def int8_case(M, K, N, device, seed=0):
    """Operands of the (K, N) signature: x_q (M, K), xs (M, 1), w_q (K, N),
    ws (1, N)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    x_q = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    xs = torch.rand((M, 1), generator=g) * 1e-2 + 1e-4
    ws = torch.rand((1, N), generator=g) * 1e-2 + 1e-4
    return [t.to(device) for t in (x_q, xs, w_q, ws)]


def bound_ms(ops, nbytes, peak):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int8_bound_ms(M, K, N, out_bytes=2):
    from repro_torch.kernels import int8_matmul
    return bound_ms(*int8_matmul.work(M, K, N, out_bytes), INT8_OPS)


COLD_BYTES = 100e6      # > twice the H100's 50 MB L2


def rotating(fn, args_list):
    """``fn`` over ``args_list`` in turn, one entry a call: with enough
    weight copies each call finds its weight out of L2."""
    it = itertools.cycle(args_list)
    return lambda: fn(*next(it))


def check_int8(device, shapes, iters=20):
    """The int8 kernel against its plain version at each (M, K, N): the
    int32 sums are exact in every design and the epilogue rounds as the
    oracle does, so ``int8_matmul_t`` on ``w_t`` (N, K) and ``int8_matmul``
    on ``w_q`` (K, N) must both equal ``int8_matmul_plain`` bit for bit
    (tolerance 0), in bf16 and fp32, and the design ``select_design`` names
    must be the one that launched. Timed: the kernel on ``w_t``, bf16 out
    (the serving paths) and fp32 (training); the plain version;
    ``torch._int_mm`` with the scaling epilogue, and alone, on both layouts
    of B, ``w_q`` row-major and ``w_t.t()`` K-contiguous (rows <= 16 padded
    to 32 with zeros, as ``_int_mm`` needs M > 16), the faster one reported
    with its layout. Shapes of at most 16 rows are bound by bytes, and the
    decode path finds its weight out of L2: they rotate over weight copies
    of more than ``COLD_BYTES`` in all, the library too."""
    import torch
    from repro_torch.kernels import int8_matmul as mod
    rows = []
    for M, K, N in shapes:
        x_q, xs, w_q, ws = int8_case(M, K, N, device)
        w_t, ws_t = w_q.t().contiguous(), ws.reshape(N, 1)
        design = mod.select_design(M, N, K)
        err = 0.0
        for dt in (torch.bfloat16, torch.float32):
            ref = mod.int8_matmul_plain(x_q, xs, w_q, ws, dt)
            before = dict(mod.design_launches)
            outs = (mod.int8_matmul_t(x_q, xs, w_t, ws_t, out_dtype=dt),
                    mod.int8_matmul(x_q, xs, w_q, ws, out_dtype=dt))
            torch.cuda.synchronize()
            assert mod.design_launches[design] == before[design] + 2, \
                (M, K, N, design, before, mod.design_launches)
            for out in outs:
                err = max(err, max_err(out, ref))
                assert torch.equal(out, ref), (M, K, N, dt, design, err)
        cold = M <= 16
        copies = max(1, -(-int(COLD_BYTES) // (K * N))) if cold else 1
        w_ts = [w_t] + [w_t.clone() for _ in range(copies - 1)]

        def kernel(dt):
            return timed(rotating(
                lambda w: mod.int8_matmul_t(x_q, xs, w, ws_t, out_dtype=dt),
                [(w,) for w in w_ts]), device, iters)
        kern, kern32 = kernel(torch.bfloat16), kernel(torch.float32)
        plain = timed(lambda: mod.int8_matmul_plain(
            x_q, xs, w_q, ws, torch.bfloat16), device, iters)
        lib, lib_layout = None, None
        if K % 8 == 0 and N % 8 == 0:
            xp, xsp = x_q, xs
            if M <= 16:
                xp = torch.zeros((32, K), dtype=torch.int8, device=device)
                xp[:M] = x_q
                xsp = torch.zeros((32, 1), device=device)
                xsp[:M] = xs

            def int_mm(b):
                return (torch._int_mm(xp, b)[:M].float() * xsp[:M]
                        * ws).to(torch.bfloat16)
            for layout, bs in (
                    ("w row-major", [w_q] + [w.t().contiguous()
                                             for w in w_ts[1:]]),
                    ("w_t.t() K-contiguous", [w.t() for w in w_ts])):
                args = [(b,) for b in bs]
                ms = timed(rotating(int_mm, args), device, iters)
                bare = timed(rotating(lambda b: torch._int_mm(xp, b), args),
                             device, iters)
                print(f"  _int_mm M={M} K={K} N={N} {layout}"
                      f"{' (padded to M 32)' if M <= 16 else ''}"
                      f"{' (L2 cold)' if cold else ''}: {ms:.4f} ms with "
                      f"the scaling epilogue, {bare:.4f} ms int32 sums "
                      "alone")
                if lib is None or ms < lib:
                    lib, lib_layout = ms, layout + (
                        ", padded to M 32" if M <= 16 else "")
        del w_ts
        bound, by = int8_bound_ms(M, K, N)
        rows.append(dict(M=M, K=K, N=N, design=design, max_abs_err=err,
                         ms=kern, ms_fp32=kern32, plain_ms=plain,
                         library_ms=lib,
                         library_layout=lib_layout, bound_ms=bound,
                         bound_by=by, cold_l2=cold))
        print(f"int8_matmul M={M} K={K} N={N} design {design}"
              f"{' tile_n ' + str(mod.tile_n(M, N)) if design == 'A' else ''}"
              f"{f' (L2 cold, {copies} weight copies)' if cold else ''}"
              f": max_abs_err={err} ms={kern:.4f} (fp32 out {kern32:.4f}) "
              f"plain_ms={plain:.4f} "
              f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
              f"({lib_layout}) bound_ms={bound:.4f} ({by}) "
              f"share of bound {bound / kern:.3f}")
    return rows


def int8_shapes():
    """The products the paths launch: serving decode (M 1 and 8, L2 cold)
    and admission chunks (M 128; the ring cell's M 2048) over phi4-mini's
    MLP (K 3072 -> N 8192 and K 8192 -> N 3072), a ragged shape the
    fallback takes, mamba2-780m training (4 x 1024 tokens), phi4-mini
    training (2 x 4096 tokens), and the serve-dense cell over gemma2-27b's
    MLP (K 4608 -> N 36864 and K 36864 -> N 4608): decode (M 8, L2 cold),
    its 512-token admission chunks and a ragged last chunk (M 104)."""
    shapes = [(m, k, n) for m in (1, 8, 128, 2048)
              for k, n in ((3072, 8192), (8192, 3072))] + [(5, 3000, 1000)]
    shapes += [(4096, 1536, 3072), (4096, 3072, 1536)]
    shapes += [(8192, 3072, 8192), (8192, 8192, 3072)]
    shapes += [(m, k, n) for m in (8, 104, DENSE_CHUNK)
               for k, n in ((4608, 36864), (36864, 4608))]
    return shapes


def quantize_bound_ms(M, K, esize, backward=False):
    """``quantize_rows.work``'s bytes over the memory rate (its operations
    are a few a byte)."""
    from repro_torch.kernels import quantize_rows
    _, nbytes = quantize_rows.work(M, K, esize, backward)
    return 1e3 * nbytes / HBM_BW, "bytes"


def check_quantize(device, shapes, iters=20):
    """``quantize_rows`` and ``quantize_rows_backward`` against their plain
    versions (``quantize_rowwise`` and autograd's rules through it, op for
    op) at each (M, K, dtype): the same fp32 operations in the same order
    on the same values, so q, s and d x must be equal bit for bit
    (tolerance 0). Each x has a row of zeros and a row whose largest
    magnitude appears twice. Timed beside the plain versions (about ten
    launches forward and a dozen backward)."""
    import torch
    from repro_torch.kernels import quantize_rows as mod
    rows = []
    for M, K, dt in shapes:
        g = torch.Generator(device="cpu").manual_seed(M + K)
        x = torch.randn((M, K), generator=g)
        x[0] = 0.0
        x[-1, 0], x[-1, K - 1] = 9.0, -9.0
        x = x.to(device=device, dtype=dt)
        d_s = torch.randn((M, 1), generator=g).to(device)
        err = 0
        for got, want in ((mod.quantize_rows(x),
                           mod.quantize_rows_plain(x)),
                          ((mod.quantize_rows_backward(x, d_s),),
                           (mod.quantize_rows_backward_plain(x, d_s),))):
            for a, b in zip(got, want):
                err = max(err, max_err(a, b))
                assert torch.equal(a, b), (M, K, dt, err)
        fwd = timed(lambda: mod.quantize_rows(x), device, iters)
        bwd = timed(lambda: mod.quantize_rows_backward(x, d_s), device,
                    iters)
        fwd_plain = timed(lambda: mod.quantize_rows_plain(x), device, iters)
        bwd_plain = timed(lambda: mod.quantize_rows_backward_plain(x, d_s),
                          device, iters)
        bound, by = quantize_bound_ms(M, K, x.element_size())
        bwd_bound, _ = quantize_bound_ms(M, K, x.element_size(), True)
        rows.append(dict(M=M, K=K, dtype=str(dt)[6:], max_abs_err=err,
                         ms=fwd, plain_ms=fwd_plain, bound_ms=bound,
                         bound_by=by, library_ms=None, backward_ms=bwd,
                         backward_plain_ms=bwd_plain,
                         backward_bound_ms=bwd_bound))
        print(f"quantize_rows M={M} K={K} {str(dt)[6:]}: max_abs_err={err} "
              f"ms={fwd:.4f} plain_ms={fwd_plain:.4f} bound_ms={bound:.4f}"
              f" ({by}); backward ms={bwd:.4f} plain_ms={bwd_plain:.4f} "
              f"bound_ms={bwd_bound:.4f}; library_ms=null (no PyTorch call "
              "quantises rows)")
    return rows


def quantize_shapes():
    """What the int8 paths quantise: decode (8 rows) and admission (2048)
    activations in bf16 over phi4-mini's MLP widths; in fp32 mamba2-780m's
    training activations (4096 rows of 1536 and 3072) and phi4-mini's (8192
    rows of 3072 and 8192), and its weights as rows of ``w.t()`` (8192 x
    3072 for ``wi``, 3072 x 8192 for ``wo``); in bf16 the serve-dense
    cell's activations over gemma2-27b's MLP widths (8, 104 and 512 rows of
    4608 and 36864) and its weights as rows of ``w.t()`` (36864 x 4608 for
    ``wi_gate`` and ``wi_up``, 4608 x 36864 for ``wo``)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    return [(8, 3072, bf16), (8, 8192, bf16), (2048, 3072, bf16),
            (4096, 1536, f32), (4096, 3072, f32), (8192, 3072, f32),
            (8192, 8192, f32), (3072, 8192, f32)] + [
        (m, k, bf16) for m in (8, 104, DENSE_CHUNK) for k in (4608, 36864)
    ] + [(36864, 4608, bf16), (4608, 36864, bf16)]


# -------------------------------------------------------------- ssd_scan --

def ssd_case(B, S, H, P, N, dtype, device, seed=0):
    """Inputs at the model's scales: x and b, c unit-ish, dt a softplus of
    a shifted normal (as ``softplus(x @ in_dt + dt_bias)``), a = -exp(A_log)
    with A_log = log(uniform[1, 16])."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(B, S, H, P)), dtype=torch.float32)
    dt = torch.nn.functional.softplus(torch.tensor(
        rng.normal(size=(B, S, H)) - 3.0, dtype=torch.float32))
    a = -torch.tensor(rng.uniform(1.0, 16.0, size=(H,)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(B, S, N)) * N ** -0.5,
                     dtype=torch.float32)
    c = torch.tensor(rng.normal(size=(B, S, N)) * N ** -0.5,
                     dtype=torch.float32)
    x, b, c = (t.to(device=device, dtype=dtype) for t in (x, b, c))
    return [x, dt.to(device), a.to(device), b, c]


def ssd_bound_ms(B, S, H, P, N, Q, esize):
    """``ssd_scan.work`` at the fp32 peak (the CUDA cores)."""
    from repro_torch.kernels import ssd_scan
    return bound_ms(*ssd_scan.work(B, S, H, P, N, Q, esize), FP32_FLOPS)


def check_ssd(device, shapes, iters=10, dtypes=None):
    """``ssd_scan`` against ``ssd_scan_plain`` on the card, fp32 and bf16.
    Both compute in fp32 from the same (exactly upcast) inputs and differ
    only in the order of their sums: fp32 outputs within 1e-5 of the
    largest |y| (~1e-6 measured on the CPU against the Pallas kernel), bf16
    outputs within one bf16 step (2^-8 relative) of the largest |y|."""
    import torch
    from repro_torch.kernels import ssd_scan as mod
    rows = []
    for B, S, H, P, N, Q in shapes:
        for dtype in dtypes or (torch.float32, torch.bfloat16):
            x, dt, a, b, c = ssd_case(B, S, H, P, N, dtype, device)
            out = mod.ssd_scan(x, dt, a, b, c, chunk=Q)
            ref = mod.ssd_scan_plain(x, dt, a, b, c, chunk=Q)
            torch.cuda.synchronize()
            scale = float(ref.float().abs().max())
            tol = (1e-5 if dtype == torch.float32 else 2 ** -8) * scale
            err = max_err(out, ref)
            assert torch.isfinite(out).all() and err <= tol, \
                (B, S, H, P, N, Q, dtype, err, tol)
            kern = timed(lambda: mod.ssd_scan(x, dt, a, b, c, chunk=Q),
                         device, iters)
            plain = timed(lambda: mod.ssd_scan_plain(x, dt, a, b, c,
                                                     chunk=Q), device, iters)
            bound, by = ssd_bound_ms(B, S, H, P, N, Q, x.element_size())
            name = "fp32" if dtype == torch.float32 else "bf16"
            rows.append(dict(shape=(B, S, H, P, N, Q), dtype=name,
                             max_abs_err=err, tol=tol, ms=kern,
                             plain_ms=plain, library_ms=None,
                             bound_ms=bound, bound_by=by))
            print(f"ssd_scan {name} B={B} S={S} H={H} P={P} N={N} Q={Q}: "
                  f"max_abs_err={err:.3g} (tol {tol:.3g}) ms={kern:.4f} "
                  f"plain_ms={plain:.4f} library_ms=null "
                  f"bound_ms={bound:.5f} ({by})")
    return rows


def ssd_bwd_bound_ms(B, S, H, P, N, Q, esize):
    """``ssd_scan.work_backward`` at the fp32 peak."""
    from repro_torch.kernels import ssd_scan
    return bound_ms(*ssd_scan.work_backward(B, S, H, P, N, Q, esize),
                    FP32_FLOPS)


def check_ssd_backward(device, shapes, iters=5):
    """``ssd_scan_backward`` (the backward kernels) against
    ``ssd_scan_backward_plain`` (the closed form in plain PyTorch) on the
    card, on the same inputs and cotangent, fp32 and bf16. Both sum in fp32
    but in other orders, and the gradients of dt and a sum decays over
    every token and chunk pair, with cancellation (~1e-5 of their largest
    entry on the CPU's emulation of the kernels, ~3e-4 under a decay
    stronger than the model's): each gradient within 1e-3 of its largest
    entry; in bf16 dx, db and dc are rounded to bf16 after, so they are
    held to one bf16 step (2^-7 relative) of their largest entry."""
    import torch
    from repro_torch.kernels import ssd_scan as mod
    rows = []
    for B, S, H, P, N, Q in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, b, c = ssd_case(B, S, H, P, N, dtype, device, seed=4)
            gy = torch.randn(x.shape, device=device,
                             generator=torch.Generator(device).manual_seed(5)
                             ).to(dtype)
            got = mod.ssd_scan_backward(x, dt, a, b, c, gy, chunk=Q)
            want = mod.ssd_scan_backward_plain(x, dt, a, b, c, gy, chunk=Q)
            again = mod.ssd_scan_backward(x, dt, a, b, c, gy, chunk=Q)
            torch.cuda.synchronize()
            rel, errs = {}, {}
            for name, g, w, g2 in zip(("x", "dt", "a", "b", "c"), got, want,
                                      again):
                assert g.dtype == w.dtype and g.shape == w.shape, name
                assert torch.isfinite(g).all(), name
                # no float atomics: a second run gives the same bits
                assert torch.equal(g, g2), name
                errs[name] = max_err(g, w)
                rel[name] = errs[name] / float(w.float().abs().max())
                tol = 2 ** -7 if dtype == torch.bfloat16 and name in "xbc" \
                    else 1e-3
                assert rel[name] <= tol, (B, S, H, P, N, Q, dtype, name,
                                          rel[name], tol)
            kern = timed(lambda: mod.ssd_scan_backward(x, dt, a, b, c, gy,
                                                       chunk=Q),
                         device, iters, warmup=1)
            plain = timed(lambda: mod.ssd_scan_backward_plain(
                x, dt, a, b, c, gy, chunk=Q), device, iters, warmup=1)
            bound, by = ssd_bwd_bound_ms(B, S, H, P, N, Q, x.element_size())
            name = "fp32" if dtype == torch.float32 else "bf16"
            rows.append(dict(shape=(B, S, H, P, N, Q), dtype=name,
                             max_abs_err=max(errs.values()), rel=rel,
                             ms=kern, plain_ms=plain, library_ms=None,
                             bound_ms=bound, bound_by=by))
            print(f"ssd_scan_backward {name} B={B} S={S} H={H} P={P} N={N} "
                  f"Q={Q}: max_abs_err / max|plain| "
                  + " ".join(f"{k}={v:.3g}" for k, v in rel.items())
                  + f" ms={kern:.4f} plain_ms={plain:.4f} library_ms=null "
                  f"bound_ms={bound:.5f} ({by})")
    return rows


def check_ssd_grads(device, shape=(2, 256, 4, 64, 128, 128)):
    """``SSDScan`` on the card (forward and backward kernels) against
    autograd through the ``ssd_chunked_ref`` twin on the CPU, fp32.
    The decays are exps of differences of fp32 cumulative sums that reach
    ~10^2 over a chunk of 128 here, and the two devices sum them in other
    orders: y agrees to ~1e-5 of its largest entry (measured 1e-5), so y is
    held to 1e-4 and each gradient, which sums such terms over every token
    and chunk pair, to 1e-3 of its largest entry."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as mod
    B, S, H, P, N, Q = shape
    ins = ssd_case(B, S, H, P, N, torch.float32, torch.device("cpu"), seed=1)
    gy = torch.tensor(np.random.default_rng(2).normal(size=(B, S, H, P)),
                      dtype=torch.float32)
    cpu = [t.clone().requires_grad_(True) for t in ins]
    want = ref.ssd_chunked_ref(*cpu, chunk=Q)
    want_g = torch.autograd.grad(want, cpu, gy)
    dev = [t.to(device).requires_grad_(True) for t in ins]
    before = mod.backward_launches
    got = mod.SSDScan.apply(*dev, Q)
    got_g = torch.autograd.grad(got, dev, gy.to(device))
    assert mod.backward_launches == before + mod.BWD_PASSES
    rel = {"y": max_err(got.detach().cpu(), want.detach())
           / float(want.detach().abs().max())}
    for name, g, w in zip(("x", "dt", "a", "b", "c"), got_g, want_g):
        rel[name] = max_err(g.cpu(), w) / float(w.abs().max())
        assert torch.isfinite(g).all(), name
    print(f"ssd_scan grads B={B} S={S} H={H} P={P} N={N} Q={Q}: card vs "
          f"cpu ssd_chunked_ref, max_abs_err / max|ref| "
          + " ".join(f"{k}={v:.3g}" for k, v in rel.items()))
    assert rel.pop("y") <= 1e-4 and max(rel.values()) <= 1e-3, rel


def time_ssd_backward(device, shape=(4, 1024, 48, 64, 128, 128), iters=5):
    """Milliseconds of one ``ssd_scan_backward`` (the backward kernels) at
    the training shape, fp32, and its peak extra memory."""
    import torch
    from repro_torch.kernels import ssd_scan as mod
    B, S, H, P, N, Q = shape
    x, dt, a, b, c = ssd_case(B, S, H, P, N, torch.float32, device, seed=3)
    gy = torch.randn_like(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = timed(lambda: mod.ssd_scan_backward(x, dt, a, b, c, gy, chunk=Q),
               device, iters, warmup=1)
    extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"ssd_scan_backward B={B} S={S} H={H} P={P} N={N} Q={Q}: "
          f"ms={ms:.3f} (x48 layers = {48 * ms:.1f} ms a step) "
          f"peak extra {extra:.2f} GiB")
    return ms


def check_int8_grads(device, M=256, K=1536, N=3072):
    """The differentiable ``quantized_matmul`` on the card against the CPU
    plain path: the forward bit for bit (exact int32 sums, identical
    quantisation), the gradients of x and w with the same zero pattern
    (only each row's / column's arg-max entry is reached) and within 1e-4
    of their largest entry (sums over N = 3072 or M terms in other
    orders)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(M, K)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(K, N)) * K ** -0.5, dtype=torch.float32)
    g0 = torch.tensor(rng.normal(size=(M, N)), dtype=torch.float32)
    out = []
    for d in (torch.device("cpu"), device):
        xs, ws = x.to(d).requires_grad_(True), w.to(d).requires_grad_(True)
        y = ops.quantized_matmul(xs, ws)
        gx, gw = torch.autograd.grad((y * g0.to(d)).sum(), (xs, ws))
        out.append([t.detach().cpu() for t in (y, gx, gw)])
    (yc, gxc, gwc), (yd, gxd, gwd) = out
    assert torch.equal(yc, yd), max_err(yc, yd)
    for name, a, b in (("x", gxd, gxc), ("w", gwd, gwc)):
        assert torch.equal(a != 0, b != 0), name
        err = max_err(a, b)
        assert err <= 1e-4 * float(b.abs().max()), (name, err)
    print(f"quantized_matmul grads M={M} K={K} N={N}: y bit-equal, "
          f"nonzero x-grads {int((gxd != 0).sum())}/{M * K} "
          f"w-grads {int((gwd != 0).sum())}/{K * N} (patterns equal), "
          f"max_abs_err x={max_err(gxd, gxc):.3g} w={max_err(gwd, gwc):.3g}")


# ------------------------------------------------------- flash_attention --

def flash_case(B, H, KVH, Sq, Skv, hd, dtype, device, seed=0, q_scale=1.0):
    """q, k, v at unit scale (the model's RoPE'd projections are O(1)):
    scores q.k / sqrt(hd) of unit spread, or of ``q_scale`` spread with q
    scaled by it (a power of 2 scales bf16 exactly)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, H, Sq, hd), (B, KVH, Skv, hd), (B, KVH, Skv, hd)):
        out.append(torch.tensor(rng.normal(size=shape), dtype=torch.float32
                                ).to(device=device, dtype=dtype))
    out[0] *= q_scale
    return out


def flash_kept(Sq, Skv, kw, device, rows=None, grid=(128, 128)):
    """(rows, Skv) bool: the (query, key) pairs whose score the function
    needs, entries of the running blocks that survive the mask, on the
    caller's block ``grid`` (the default (128, 128))."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    qpos = torch.arange(Sq, device=device) if rows is None else rows
    kpos = torch.arange(Skv, device=device)
    bq, bk = min(grid[0], Sq), min(grid[1], Skv)
    return fa.block_runs(qpos, kpos, causal=kw["causal"], window=kw["window"],
                         kv_keep_stride=kw["kv_keep_stride"], bq=bq,
                         bk=bk) \
        & fa.entry_mask(qpos, kpos, causal=kw["causal"], window=kw["window"],
                        n_kv=Skv)


def flash_kept_pairs(Sq, Skv, kw, device, grid=(128, 128)):
    """How many (query, key) pairs the function needs on the caller's
    block ``grid`` (``flash_attention.kept_pairs``, counted on the
    host)."""
    from repro_torch.kernels import flash_attention as fa
    return fa.kept_pairs(Sq, Skv, causal=bool(kw["causal"]),
                         window=int(kw["window"]),
                         kv_keep_stride=int(kw["kv_keep_stride"]),
                         bq=grid[0], bk=grid[1])


def flash_bound_ms(B, H, KVH, Sq, Skv, hd, esize, pairs):
    """``flash_attention.work`` at the input type's peak."""
    from repro_torch.kernels import flash_attention as fa
    peak = FP32_FLOPS if esize == 4 else BF16_FLOPS
    return bound_ms(*fa.work(B, H, KVH, Sq, Skv, hd, esize, pairs), peak)


def flash_sfu_ms(B, H, pairs, cap):
    """The transcendentals' floor: one exp a needed pair and head, and one
    tanh more under a softcap, at ``SFU_OPS``. Printed beside the bound,
    which it does not enter."""
    return 1e3 * B * H * pairs * (2 if cap else 1) / SFU_OPS


def cuda_kernel_names(fn):
    """Names of the CUDA kernels one call of ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def host_syncs(fn):
    """The host's waits for the stream (``cudaStreamSynchronize`` calls, a
    device-to-host copy's or a pageable host-to-device copy's) in one call
    of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key == "cudaStreamSynchronize")


def bf16_row_excess(out, ref):
    """The largest amount by which an element of ``out`` strays from
    ``ref`` beyond one bf16 step (2^-7 |ref|), in units of the rms of its
    row of ``ref`` (over hd)."""
    o, r = out.float(), ref.float()
    rms = r.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((o - r).abs() - 2 ** -7 * r.abs()).clamp_min(0)
                 .div_(rms).max())


def check_flash(device, cases, iters=10):
    """``flash_attention`` against ``flash_attention_plain`` on the card.
    Both compute the scores, the softmax and P.V in fp32 from the same
    (exactly upcast) inputs and differ in the order of their sums (the
    kernel's online softmax over key tiles against one pass over all
    keys): fp32 outputs (|o| <= ~4) within FP32_ATOL. In bf16, p is also
    rounded to bf16, against a running max in the kernel and the final max
    in the plain version, each rounding off by up to 2^-8 of p and
    typically under 2^-9: as o_d sums p_j v_jd of random sign, that moves
    an output element by a small multiple of 2^-9 of its row's rms, and the
    output's own rounding by up to one bf16 step. So each bf16 element is
    held to ``|out - ref| <= 2^-7 |ref| + BF16_ROW * rms(ref's row)``,
    BF16_ROW = 2^-6 = 8 * 2^-9 (the excess measured is printed). The
    output is small: at unit-scale q, k, v a causal row r averages ~r/e
    keys, so |o| ~ sqrt(e / r), ~0.03 at the median row of S 4096 (the
    median |ref| is printed), and an absolute tolerance would pass a
    few-percent fault; this one does not (a 2% scaling of every element
    fails it).
    ``library_ms``: ``F.scaled_dot_product_attention`` on the same inputs
    where one call computes the same function (is_causal for causal
    attention, no mask for non-causal attention, a boolean mask of the
    kept entries for window, stride and causal Sq != Skv; no softcap, no
    caller grid), with the kernels it ran. A case may name
    the caller's block ``grid`` (bq, bk), the ``design`` it must take and
    a ``q_scale`` (``flash_case``: at unit scale cap tanh(s / cap) ~ s for
    the caps here, so a softcap is only tested where q is scaled up), and
    its inputs ``qkv`` where the caller has drawn them;
    the design ``select_flash_design`` gives is asserted in any case, the
    tiled one for fp32 and tc for bf16 at hd 64, 80, 128 and 256."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for c in cases:
        B, H, KVH, Sq, Skv, hd = c["shape"]
        grid = c.get("grid", (128, 128))
        kw = dict(causal=c.get("causal", True), window=c.get("window", 0),
                  cap=c.get("cap", 0.0),
                  kv_keep_stride=c.get("stride", 1))
        kwg = dict(kw, bq=grid[0], bk=grid[1])
        q, k, v = c.get("qkv") or flash_case(
            B, H, KVH, Sq, Skv, hd, c["dtype"], device,
            q_scale=c.get("q_scale", 1.0))
        design = fa.select_flash_design(c["dtype"], hd)
        for key in fa.design_launches:
            fa.design_launches[key] = 0
        out = fa.flash_attention(q, k, v, **kwg)
        assert fa.design_launches[design] == 1, (c["name"], design,
                                                fa.design_launches)
        if hd in fa.FAST_HD and c["dtype"] in (torch.float32,
                                               torch.bfloat16):
            want = "tiled" if c["dtype"] == torch.float32 else "tc"
            assert design == want, (c["name"], design)
        assert design == c.get("design", design), (c["name"], design)
        ref = fa.flash_attention_plain(q, k, v, **kwg)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        assert torch.isfinite(out).all(), c["name"]
        if c["dtype"] == torch.float32:
            tol, excess = FP32_ATOL, None
            assert err <= tol, (c["name"], err, tol)
            tol_s = f"{tol:.3g}"
        else:
            tol, excess = BF16_ROW, bf16_row_excess(out, ref)
            assert excess <= tol, (c["name"], excess, tol)
            tol_s = (f"2^-7 |ref| + {tol:.3g} row rms: excess {excess:.3g} "
                     f"row rms, median |ref| "
                     f"{float(ref.float().abs().median()):.3g}")
        kern = timed(lambda: fa.flash_attention(q, k, v, **kwg), device,
                     iters)
        plain = timed(lambda: fa.flash_attention_plain(q, k, v, **kwg),
                      device, 3, warmup=1)
        lib, backend = None, "none: no single call computes a softcap"
        if "grid" in c:
            backend = "none: no single call computes another block grid"
        elif not kw["cap"]:
            if kw["causal"] and not kw["window"] and kw["kv_keep_stride"] \
                    == 1 and Sq == Skv:
                sdpa_kw = dict(is_causal=True)
            elif not kw["causal"] and not kw["window"]:
                sdpa_kw = {}            # every entry kept: no mask
            else:
                sdpa_kw = dict(attn_mask=flash_kept(Sq, Skv, kw, device))

            def lib_call():
                return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                      **sdpa_kw)
            lib_err = max_err(lib_call(), ref)
            lib = timed(lib_call, device, iters)
            backend = ",".join(cuda_kernel_names(lib_call))[:160] \
                + f" (max_abs_err vs plain {lib_err:.3g})"
        pairs = flash_kept_pairs(Sq, Skv, kw, device, grid)
        bound, by = flash_bound_ms(B, H, KVH, Sq, Skv, hd, q.element_size(),
                                   pairs)
        sfu = flash_sfu_ms(B, H, pairs, kw["cap"])
        rows.append(dict(name=c["name"], shape=c["shape"], design=design,
                         dtype=str(c["dtype"]).split(".")[-1],
                         max_abs_err=err, tol=tol, row_excess=excess,
                         ms=kern, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by=by, sfu_ms=sfu))
        print(f"flash_attention {c['name']} B={B} H={H} KVH={KVH} Sq={Sq} "
              f"Skv={Skv} hd={hd} {rows[-1]['dtype']}, design {design}: "
              f"max_abs_err={err:.3g} "
              f"(tol {tol_s}) ms={kern:.4f} plain_ms={plain:.4f} "
              f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={bound:.4f} ({by}, {pairs} pairs) "
              f"sfu_floor_ms={sfu:.4f} library: {backend}")
    return rows


def phi4_flash_cases():
    import torch
    cell = (2, 24, 8, 4096, 4096, 128)      # phi4-mini training, 2 x 4096
    return [
        dict(name="cell-fp32", shape=cell, dtype=torch.float32),
        dict(name="cell-bf16", shape=cell, dtype=torch.bfloat16,
             design="tc"),
        dict(name="cell-b1-fp32", shape=(1,) + cell[1:],
             dtype=torch.float32),            # int8+drop50% keeps 1 row
        dict(name="window+softcap+gqa", shape=(2, 24, 4, 2048, 2048, 128),
             dtype=torch.float32, window=512, cap=50.0),
        dict(name="stride2", shape=(2, 24, 8, 2048, 2048, 128),
             dtype=torch.float32, stride=2),
        # hd 80 (the tiled hd-128 instance, dims past 80 zero-filled) and
        # hd 256 (tc's blocks of one head, R 4 over a small grid)
        dict(name="ragged", shape=(2, 8, 2, 1000, 1500, 80),
             dtype=torch.float32, causal=True, window=300, design="tiled"),
        dict(name="ragged-bf16-hd256", shape=(1, 4, 1, 777, 333, 256),
             dtype=torch.bfloat16, causal=False, design="tc"),
        # "simple", which every other head size still runs: the smoke
        # configs' (4 heads of 16 over 2 KV heads, or 1) as their training
        # on the card gives it (2 x 1024 tokens, causal; gemma2's smoke
        # window 32 and softcap 50, q x 16 so that the cap bites)
        dict(name="smoke-gqa-fp32", shape=(2, 4, 2, 1024, 1024, 16),
             dtype=torch.float32, design="simple"),
        dict(name="smoke-gqa-bf16", shape=(2, 4, 2, 1024, 1024, 16),
             dtype=torch.bfloat16, design="simple"),
        dict(name="smoke-mqa-fp32", shape=(2, 4, 1, 1024, 1024, 16),
             dtype=torch.float32, design="simple"),
        dict(name="smoke-mqa-bf16", shape=(2, 4, 1, 1024, 1024, 16),
             dtype=torch.bfloat16, design="simple"),
        dict(name="smoke-gqa-window-softcap-q16-fp32",
             shape=(2, 4, 2, 1024, 1024, 16), dtype=torch.float32,
             window=32, cap=50.0, q_scale=16.0, design="simple"),
        # the tiled design off its cell: ragged Sq != Skv both ways, a
        # window over the KV tail, and hd 64
        dict(name="ragged-hd128", shape=(2, 6, 2, 1000, 1500, 128),
             dtype=torch.float32, causal=True, window=300, cap=30.0),
        dict(name="full-ragged-hd64", shape=(1, 4, 1, 777, 333, 64),
             dtype=torch.float32, causal=False),
        dict(name="stride2-hd64", shape=(1, 6, 3, 1100, 1100, 64),
             dtype=torch.float32, stride=2),
        # the tc design (bf16, hd 64 and 128) on the same edges: GQA R 6
        # over two blocks of 3 heads, R 2 and 4, hd 64, perforation,
        # ragged Sq != Skv both ways over the KV tail, and a caller grid
        # whose rows past Skv + window keep nothing (each the mean of V
        # over its running blocks' masked entries)
        dict(name="window+softcap+gqa-bf16", shape=(2, 24, 4, 2048, 2048,
                                                    128),
             dtype=torch.bfloat16, window=512, cap=50.0, design="tc"),
        dict(name="stride2-bf16", shape=(2, 24, 8, 2048, 2048, 128),
             dtype=torch.bfloat16, stride=2, design="tc"),
        dict(name="ragged-hd128-bf16", shape=(2, 6, 2, 1000, 1500, 128),
             dtype=torch.bfloat16, causal=True, window=300, cap=30.0,
             design="tc"),
        dict(name="ragged-q-long-bf16", shape=(1, 8, 4, 1500, 1000, 128),
             dtype=torch.bfloat16, causal=True, window=300, design="tc"),
        dict(name="full-ragged-hd64-bf16", shape=(1, 4, 1, 777, 333, 64),
             dtype=torch.bfloat16, causal=False, design="tc"),
        dict(name="stride2-hd64-bf16", shape=(1, 6, 3, 1100, 1100, 64),
             dtype=torch.bfloat16, stride=2, design="tc"),
        dict(name="grid48x80-bf16", shape=(1, 8, 2, 700, 500, 128),
             dtype=torch.bfloat16, causal=True, window=97, cap=20.0,
             grid=(48, 80), design="tc"),
        # the softcap where it bites (q x 16: scores of ~16 rms, past caps
        # 30 and 20) and the GQA splits not above: R 1, one head a block
        # (128-key tiles), and R 8 in blocks of 3 + 3 + 2 (64-key tiles, one
        # consumer idle in the last)
        dict(name="r1-softcap-q16-bf16", shape=(1, 4, 4, 1000, 1000, 128),
             dtype=torch.bfloat16, cap=30.0, q_scale=16.0, design="tc"),
        dict(name="r8-window-softcap-q16-hd64-bf16",
             shape=(1, 16, 2, 900, 1300, 64), dtype=torch.bfloat16,
             window=200, cap=20.0, q_scale=16.0, design="tc"),
    ]


def check_flash_grads(device, shape=(2, 8, 2, 1100, 1100, 64)):
    """``FlashAttention`` on the card (kernel forward, the plain version's
    VJP recomputed per block of 1024 query rows) against autograd through
    ``flash_attention_plain`` on the CPU, fp32, causal with perforation
    (stride 2) over two row blocks. The card's forward is held to
    FP32_ATOL, each gradient to 1e-5 of its largest entry (sums over up to
    1100 terms in other orders)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, H, KVH, S, _, hd = shape
    ins = flash_case(B, H, KVH, S, S, hd, torch.float32,
                     torch.device("cpu"), seed=5)
    go = torch.tensor(np.random.default_rng(6).normal(size=(B, H, S, hd)),
                      dtype=torch.float32)
    kw = (True, 0, 0.0, 2)
    cpu = [t.clone().requires_grad_(True) for t in ins]
    want = fa.flash_attention_plain(*cpu, causal=True, kv_keep_stride=2)
    want_g = torch.autograd.grad(want, cpu, go)
    dev = [t.to(device).requires_grad_(True) for t in ins]
    got = fa.FlashAttention.apply(*dev, *kw)
    got_g = torch.autograd.grad(got, dev, go.to(device))
    err = max_err(got.detach().cpu(), want.detach())
    rel = {n: max_err(g.cpu(), w) / float(w.abs().max())
           for n, g, w in zip("qkv", got_g, want_g)}
    print(f"flash_attention grads B={B} H={H} KVH={KVH} S={S} hd={hd} "
          f"stride 2: card vs cpu plain, out max_abs_err={err:.3g}, "
          f"grads max_abs_err / max|ref| "
          + " ".join(f"{k}={v:.3g}" for k, v in rel.items()))
    assert err <= FP32_ATOL and max(rel.values()) <= 1e-5, (err, rel)


# ------------------------------------------------------- paged_attention --

def paged_case(lengths, *, G, R, hd, P, M, dtype, quantized, device,
               seed=0, speculative=2, blind=False):
    """A paged pool holding ``lengths[b]`` resident tokens per slot (ragged
    page counts, partial last pages), the decode query at position
    ``lengths[b]``, plus ``speculative`` mapped-but-future pages per slot
    filled with large values that must not matter. With ``blind``, two
    inactive slots follow: one with no running page (zeros) and one whose
    two running pages hold no valid entry (the mean of their V)."""
    import torch
    from repro_torch.models.attention import quantize_kv
    kp, vp, ppos, block, positions, q = paged_pool(
        tuple(lengths), G, R, hd, P, M, seed, speculative, blind)
    if quantized:
        kp, vp = quantize_kv(kp.clamp(-6, 6)), quantize_kv(vp.clamp(-6, 6))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q = torch.tensor(q, dtype=dtype)
    pos = torch.tensor(positions)
    return [t.to(device) for t in (q, kp, vp, torch.tensor(ppos),
                                   torch.tensor(block), pos)]


@functools.lru_cache(maxsize=1)
def paged_pool(lengths, G, R, hd, P, M, seed, speculative, blind):
    """``paged_case``'s fp32 pool on the host, its page positions, block
    table, decode positions and query (float64), kept for the next case
    that differs only in its dtypes (the cases of one shape come in a row).
    The tensors are read, never written, by their users."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    B = len(lengths) + 2 * blind
    n_pages = 1 + B * M
    kp = torch.tensor(rng.normal(size=(n_pages, P, G, hd)) * 0.3,
                      dtype=torch.float32)
    vp = torch.tensor(rng.normal(size=(n_pages, P, G, hd)),
                      dtype=torch.float32)
    block = np.zeros((B, M), np.int32)
    ppos = np.full((n_pages, P), -1, np.int32)
    pid = 1
    for b, L in enumerate(lengths):
        live = -(-(L + 1) // P)
        for lp in range(min(live + speculative, M)):
            block[b, lp] = pid
            if lp < live:
                top = min(L + 1, (lp + 1) * P)
                ppos[pid, : max(top - lp * P, 0)] = np.arange(lp * P, top)
            else:                                  # future page: scrambled
                kp[pid] = 1e3
                vp[pid] = -1e3
            pid += 1
    positions = list(lengths)
    if blind:
        block[B - 1, :2] = (pid, pid + 1)
        positions += [7, 2 * P]
    q = rng.normal(size=(B, G, R, hd))
    return kp, vp, ppos, block, np.asarray(positions, np.int32), q


def check_paged(device, cases, iters=20):
    """Each case against its plain version (``FP32_ATOL`` in fp32,
    ``BF16_ATOL`` otherwise), timed beside it and the bound; the host's
    waits for the stream counted over one call of every case (one profiled
    window, not one a case): the decode step is host-bound, so a call must
    not wait for the card."""
    import torch
    from repro_torch.kernels import paged_attention as mod
    from repro_torch.models.attention import KV_SCALE
    rows, calls = [], []
    for c in cases:
        G, R, hd, P = c["G"], c["R"], c["hd"], c["P"]
        lengths, M = c["lengths"], c["M"]
        q, kp, vp, ppos, block, pos = paged_case(
            lengths, G=G, R=R, hd=hd, P=P, M=M, dtype=c["dtype"],
            quantized=c["int8"], device=device, blind=c.get("blind", False))
        kw = dict(window=c.get("window", 0), cap=c.get("cap", 0.0),
                  kv_scale=KV_SCALE if c["int8"] else 0.0)
        out = mod.paged_attention(q, kp, vp, ppos, block, pos, **kw)
        ref = mod.paged_attention_plain(q, kp, vp, ppos, block, pos, **kw)
        # pages a range (a block's 4 warps take them in turn) and rows of a
        # page a warp stages at a time
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        pps = mod.page_splits(q.shape[0], G, M, n_sm)
        pt = mod.tile_rows(P, hd, kp.element_size())
        tol = FP32_ATOL if c["dtype"] == torch.float32 else BF16_ATOL
        err = max_err(out, ref)
        assert err <= tol, (c["name"], err, tol)
        calls.append(functools.partial(mod.paged_attention, q, kp, vp, ppos,
                                       block, pos, **kw))
        kern = timed(lambda: mod.paged_attention(q, kp, vp, ppos, block, pos,
                                                 **kw), device, iters)
        plain = timed(lambda: mod.paged_attention_plain(
            q, kp, vp, ppos, block, pos, **kw), device, iters)
        live, tokens = mod.live_pages(block, pos, P, kw["window"])
        peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
        bound, by = bound_ms(*mod.work(
            live, tokens, P, G, R, hd, kv_bytes=kp.element_size(),
            batch=len(lengths), q_bytes=q.element_size(), max_pages=M), peak)
        rows.append(dict(name=c["name"], max_abs_err=err, tol=tol, ms=kern,
                         plain_ms=plain, library_ms=None, bound_ms=bound,
                         bound_by=by, live_pages=live, pages_a_range=pps,
                         tile_rows=pt))
        print(f"paged_attention {c['name']} B={len(lengths)} M={M}: "
              f"max_abs_err={err:.3g} (tol {tol:.3g}) ms={kern:.4f} "
              f"plain_ms={plain:.4f} library_ms=null bound_ms={bound:.5f} "
              f"({by}, {live} live pages), "
              f"{pps} pages a range, tiles of {pt} of {P} rows")
    syncs = host_syncs(lambda: [f() for f in calls])
    print(f"paged_attention: host syncs {syncs} over one call of each of "
          f"the {len(calls)} cases")
    assert syncs == 0, syncs
    return rows


def phi4_paged_cases(dtype_main):
    """The serve cell's decode (8 ragged slots, M 64) and the ring cell's
    ("ring-decode": its 4 slots at the prompts' lengths, M 1024 of a
    16384-token max_len; also in fp32, held to FP32_ATOL, where each warp
    folds ~15 pages through its two stages)."""
    import torch
    lengths = [0, 15, 16, 17, 100, 255, 400, 1000]     # 8 slots, ragged
    base = dict(G=8, R=3, hd=128, P=16, M=64, lengths=lengths)
    ring = dict(base, M=RING_CTX // 16, lengths=list(RING_PROMPTS))
    return [
        dict(base, name="bf16", dtype=dtype_main, int8=False),
        dict(base, name="int8", dtype=dtype_main, int8=True),
        dict(base, name="fp32", dtype=torch.float32, int8=False),
        dict(base, name="fp32-int8", dtype=torch.float32, int8=True),
        dict(base, name="softcap+window", dtype=torch.float32, int8=False,
             cap=50.0, window=128),
        dict(ring, name="ring-decode", dtype=dtype_main, int8=False),
        dict(ring, name="ring-decode-int8", dtype=dtype_main, int8=True),
        dict(ring, name="ring-decode-fp32", dtype=torch.float32, int8=False),
        # ranges of 16 pages: 4 a warp, in fp32
        dict(base, name="fp32-4-pages-a-warp", M=256,
             lengths=[4000, 3000, 2100, 2049], dtype=torch.float32,
             int8=False),
        # the smoke serving width; a GQA group of 8 (two blocks of 4 query
        # heads); rows of 24 bytes (no 16-byte copies); hd 256 in fp32
        # (pages in tiles of 8 rows), and pages of 100 rows (tiles of 13, the
        # last of 9); each with the two inactive rows
        dict(name="smoke+blind", G=2, R=2, hd=16, P=4, M=12,
             lengths=[0, 5, 9, 30], dtype=torch.float32, int8=False,
             blind=True),
        dict(name="smoke-int8+blind", G=2, R=2, hd=16, P=4, M=12,
             lengths=[0, 5, 9, 30], dtype=dtype_main, int8=True, blind=True),
        dict(name="gqa8+window+blind", G=2, R=8, hd=64, P=16, M=24,
             lengths=[3, 40, 170, 300], dtype=dtype_main, int8=False,
             window=100, cap=30.0, blind=True),
        dict(name="hd12+blind", G=3, R=3, hd=12, P=4, M=16,
             lengths=[2, 21, 50], dtype=dtype_main, int8=False, blind=True),
        dict(name="hd256-fp32+blind", G=2, R=3, hd=256, P=16, M=12,
             lengths=[15, 70, 160], dtype=torch.float32, int8=False,
             blind=True),
        dict(name="hd256-fp32-P100+blind", G=2, R=3, hd=256, P=100, M=8,
             lengths=[150, 420, 790], dtype=torch.float32, int8=False,
             window=500, cap=30.0, blind=True),
    ]


# ---------------------------------------------------------------- parity --

def engine_streams(cfg, params, table, device, rung, prompts, max_new,
                   mesh=None, prefill_chunk=4, n_pages=24, paged=True, **kw):
    """Greedy streams of ``prompts`` served on rung ``rung`` by a 2-slot
    engine (max_len 64), paged (page 4, ``n_pages`` pages) or dense;
    ``kw`` goes to the engine (``megastep_k``, say)."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, batch_slots=2, max_len=64, params=params,
                      table=table, prefill_chunk=prefill_chunk, paged=paged,
                      page_size=4, n_pages=n_pages, device=device, mesh=mesh,
                      **kw)
    eng.request_variant(rung)
    reqs = [Request(i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def check_parity(device):
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_table
    from repro_torch.models.lm import init_lm
    cfg = get_config("phi4-mini-3.8b-smoke")
    cpu_params = init_lm(cfg, 0, torch.float32, "cpu")
    dev_params = copy.deepcopy(cpu_params).to(device)
    table = serving_table(cfg, slots=2, max_len=64, page_occupancy=0.5)
    rng = np.random.default_rng(3)
    prefix = list(rng.integers(1, cfg.vocab_size, 8))
    prompts = [prefix + list(rng.integers(1, cfg.vocab_size, n))
               for n in (3, 9, 5, 13)]
    for rung, v in enumerate(table.variants):
        a = engine_streams(cfg, dev_params, table, device, rung, prompts, 6)
        b = engine_streams(cfg, cpu_params, table, torch.device("cpu"), rung,
                           prompts, 6)
        assert a == b, (v.name, a, b)
        print(f"parity {v.name}: {device} streams == cpu streams "
              f"({sum(map(len, a))} tokens)")


COUNTERS = ("flash_attention", "int8_matmul", "paged_attention",
            "quantize_rows", "ring_hop", "ssd_scan", "ssd_scan_backward")


def _kernel_mods():
    from repro_torch.kernels import flash_attention, int8_matmul, \
        paged_attention, quantize_rows, ring_attention, ssd_scan
    return {"flash_attention": flash_attention, "int8_matmul": int8_matmul,
            "paged_attention": paged_attention,
            "quantize_rows": quantize_rows, "ring_hop": ring_attention,
            "ssd_scan": ssd_scan}


def reset_launches():
    """Zero every kernel's launch count (and the ring's hop and step counts,
    ``paged_attention``'s merge launches, ``ssd_scan``'s backward launches,
    and ``flash_attention``'s, ``int8_matmul``'s and ``ring_hop``'s counts
    per design)."""
    from repro_torch.kernels import flash_attention, int8_matmul, \
        paged_attention, ring_attention, ssd_scan
    for mod in _kernel_mods().values():
        mod.launches = 0
    ssd_scan.backward_launches = 0
    paged_attention.merge_launches = 0
    ring_attention.hops_run = ring_attention.hops_skipped = 0
    ring_attention.steps_run = 0
    for mod in (flash_attention, int8_matmul, ring_attention):
        for k in mod.design_launches:
            mod.design_launches[k] = 0


def read_launches():
    """Launch counts since the last reset; ``paged_attention`` counts its
    wrapper's calls, each of which also launched the merge pass once, and
    ``ssd_scan_backward`` the launches of ``ssd_scan``'s backward passes."""
    from repro_torch.kernels import paged_attention, ssd_scan
    out = {name: mod.launches for name, mod in _kernel_mods().items()}
    out["ssd_scan_backward"] = ssd_scan.backward_launches
    assert paged_attention.merge_launches == out["paged_attention"], \
        (paged_attention.merge_launches, out)
    return out


def graph_marks(steps):
    """Over the train steps ``steps`` (a table's executables), each train
    graph's launches counted at its capture, and at its capture times its
    replays so far (``train.step.replayed_launches``)."""
    from repro_torch.train.step import replayed_launches
    cap = dict.fromkeys(COUNTERS, 0)
    for s in steps:
        for k, n in getattr(s, "stats", {}).get("launches", {}).items():
            cap[k] += n
    return cap, replayed_launches(steps)


def card_launches(steps, marks=None):
    """The kernel launches that ran on the card since the last
    ``reset_launches``: the wrappers' counts, with each train graph of
    ``steps`` captured since then taken out (a capture launches nothing)
    and its replays since then put in (a replay calls no wrapper);
    ``marks``: ``graph_marks(steps)`` at the reset (None: no graph of
    ``steps`` existed then)."""
    out = read_launches()
    cap, rep = graph_marks(steps)
    cap0, rep0 = marks or ({}, {})
    for k in cap:
        out[k] += rep.get(k, 0) - rep0.get(k, 0) - cap[k] + cap0.get(k, 0)
    return out


def graph_line(steps):
    """The train graphs of ``steps``: how many, capture and warm-up
    seconds, replays, and what the captures added to the reserved device
    memory (the shared pool)."""
    st = [s.stats for s in steps if getattr(s, "graph", None) is not None]
    return (f"{len(st)} graphs, capture "
            f"{[round(g['capture_s'], 3) for g in st]} s (warm-up step "
            f"{[round(g['warmup_s'], 3) for g in st]} s), replays "
            f"{[g['replays'] for g in st]}, pool "
            f"{[gib(g['pool_bytes']) for g in st]} GiB")


def int8_designs(tag):
    """``int8_matmul``'s launches per design since the last reset, printed
    under ``tag``: a model path must take designs A and B only, never the
    fallback kernel."""
    from repro_torch.kernels import int8_matmul
    d = dict(int8_matmul.design_launches)
    print(f"{tag}: int8_matmul launches by design {d}")
    assert d["fallback"] == 0, (tag, d)
    return d


def flash_designs(tag, cfg):
    """``flash_attention``'s launches per design since the last reset,
    printed under ``tag``: a training path (fp32) must take the design
    ``select_flash_design`` gives its head size, the tiled one at
    phi4-mini's hd 128."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    d = dict(fa.design_launches)
    want = fa.select_flash_design(torch.float32, cfg.resolved_head_dim)
    print(f"{tag}: flash_attention launches by design {d}")
    assert sum(d.values()) == d[want], (tag, d, want)
    return d


def drop_int8_weights():
    """Empty the int8 weight cache, so that a run that follows pays for its
    own quantisation and no dead model's int8 weights stay on the card."""
    from repro_torch.kernels import ops
    ops.clear_weight_cache()


def mamba_launches(cfg, knobs):
    """Kernel launches of one mamba2 training step without remat: every
    layer's ``ssd_scan`` forward once (``FWD_PASSES`` launches) and its
    backward once (``BWD_PASSES``); on the int8 rungs each of its three
    int8 projections once forward and once backward (the exact int32 sums
    the scales' gradients need), and ``quantize_rows`` forward for its
    input and weight and backward for both."""
    from repro_torch.kernels import ssd_scan
    L = cfg.n_layers
    int8 = knobs.matmul_precision == "int8"
    return {"ssd_scan": ssd_scan.FWD_PASSES * L,
            "ssd_scan_backward": ssd_scan.BWD_PASSES * L,
            "flash_attention": 0, "paged_attention": 0,
            "ring_hop": 0, "int8_matmul": 6 * L if int8 else 0,
            "quantize_rows": 12 * L if int8 else 0}


def attn_launches(cfg, knobs):
    """Kernel launches of one dense-attention training step under remat
    "full": the attention runs forward once and again in the recompute, on
    the kernel unless the stride knob perforates it (``_causal_chunked``
    in plain PyTorch); on the int8 rungs each of the MLP's three products
    runs forward, again in the recompute and once in the backward, with
    ``quantize_rows`` for its input and weight in both forwards and for
    both in the backward."""
    L = cfg.n_layers
    int8 = knobs.matmul_precision == "int8"
    return {"ssd_scan": 0, "ssd_scan_backward": 0, "paged_attention": 0,
            "ring_hop": 0, "flash_attention": 2 * L if knobs.kv_keep_stride <= 1 else 0,
            "int8_matmul": 9 * L if int8 else 0,
            "quantize_rows": 18 * L if int8 else 0}


def check_train_parity(device, arch="mamba2-780m-smoke", steps=3,
                       batch=4, seq=32, remat="none", per_step=None):
    """``arch`` trained in fp32 from the same seeded weights, once on the
    card (CUDA kernels, forward and backward) and once on the CPU (plain
    versions), ``steps`` steps on each rung of the training ladder, on the
    same batches (whisper's frames and paligemma's patch embeddings drawn
    on the CPU as ``launch/train.py`` draws them): every step's loss
    within 1e-4 relative (fp32 sums in other orders, carried through
    three AdamW steps). The card run's launches must be
    ``per_step(cfg, knobs)`` a step. The card runs each rung's step as
    the training driver does, one CUDA graph (``graphed_train_step``; its
    first step the eager warm-up), the CPU the eager step."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.explorer import explore
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import extra_inputs
    from repro_torch.models import api
    from repro_torch.train import optim
    from repro_torch.train.step import graphed_train_step, make_train_step
    cfg = get_config(arch)
    table = explore(cfg, ShapeConfig("cli", seq, batch, "train"),
                    serving=False, max_variants=4)
    cpu_params = api.init(cfg, 0, torch.float32, "cpu")
    src = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    opt_cfg = optim.OptConfig(lr=1e-3, warmup=2, total_steps=10)
    worst = 0.0
    for v in table.variants:
        losses = []
        for d in (device, torch.device("cpu")):
            params = copy.deepcopy(cpu_params).to(d)
            opt = optim.init_opt(params)
            step = graphed_train_step(make_train_step(
                cfg, v.knobs, opt_cfg=opt_cfg, remat=remat), d)
            losses.append([])
            reset_launches()
            for i in range(steps):
                tokens = torch.as_tensor(src.batch(i), device=d)
                params, opt, m = step(params, opt, {
                    "tokens": tokens, **extra_inputs(cfg, batch, 0, i, d)})
                losses[-1].append(float(m["loss"]))
            if d == device:
                launches = card_launches([step])
                assert step.stats["replays"] == steps - 1, step.stats
                int8_designs(f"train parity {arch} {v.name}")
                flash_designs(f"train parity {arch} {v.name}", cfg)
        want = {k: steps * n for k, n in per_step(cfg, v.knobs).items()}
        rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        worst = max(worst, rel)
        print(f"train parity {arch} {v.name}: {device} losses "
              f"{[round(x, 6) for x in losses[0]]} vs cpu "
              f"{[round(x, 6) for x in losses[1]]} (max rel {rel:.3g}), "
              f"card launches {launches}")
        assert rel <= 1e-4, (v.name, losses)
        assert launches == want, (v.name, launches, want)
    return worst


# ------------------------------------------------------------- full width --

# phi4-mini-3.8b's serving depth in the serve, megastep and profile phases:
# 16 of its 32 layers at full width (32 until the train-encdec phase ran
# over the script's time limit; its decode step is host-bound, ~1.5 ms of
# host work a layer on an H100's host)
SERVE_LAYERS = 16

def serve_full(device, arch="phi4-mini-3.8b", requests=12, slots=8,
               megastep=0, layers=SERVE_LAYERS):
    """The serving slice at full width, cut to ``layers`` layers, through
    ``launch/serve.py``; with ``megastep`` K under ``--megastep K``.
    Returns ``serve.main``'s result and
    the launches: the wrappers' counts, and under a megastep also the
    replayed ones (each graph's launches at its capture times its
    replays; the wrappers count the capture only)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    argv = ["--arch", arch, "--paged", "--dtype", "bf16",
            "--device", str(device), "--slots", str(slots),
            "--max-len", "1024", "--page-size", "16",
            "--prefill-chunk", "128", "--requests", str(requests),
            "--prompt-len", "64", "--prompt-len-max", "400",
            "--max-new", "16", "--qos-target", "0.001",
            "--decision-interval", "0", "--min-samples", "4"]
    tag = f"serve {arch} ({layers} layers)"
    if megastep:
        argv += ["--megastep", str(megastep)]
        tag += f" --megastep {megastep}"
    drop_int8_weights()
    reset_launches()
    res = serve.main(argv, cfg=cfg)
    launches = read_launches()
    int8_designs(tag)
    eng, reqs = res["engine"], res["requests"]
    assert eng.cfg.n_layers == layers
    vocab = eng.cfg.vocab_size
    assert all(r.done and len(r.out) == r.max_new for r in reqs), \
        [(r.uid, r.done, len(r.out)) for r in reqs]
    assert all(0 <= t < vocab for r in reqs for t in r.out)
    visited = {0} | {v for _, v in eng.swaps}
    names = res["names"]
    assert names == ["precise", "int8", "int8+kvq8"], names
    assert {0, len(names) - 1} <= visited, (eng.swaps, names)
    assert launches["int8_matmul"] > 0 and launches["paged_attention"] > 0 \
        and launches["flash_attention"] == launches["ssd_scan"] \
        == launches["ssd_scan_backward"] == launches["ring_hop"] == 0, \
        launches
    print(f"{tag}: {res['tokens']} tokens, "
          f"tok_s={res['tok_s']:.2f} p50_ms={1e3 * res['p50_s']:.3f} "
          f"p99_ms={1e3 * res['p99_s']:.3f} swaps={eng.swaps} "
          f"launches={launches}")
    if not megastep:
        return res, launches
    # the card's launches: the wrappers' eager ones (admission, warm-ups),
    # and each graph's launches at its capture times its replays in place
    # of the capture itself
    replayed = eng.replayed_launches()
    on_card = dict(launches)
    for k, n in replayed.items():
        captured = sum(g["launches"][k] for g in eng.graph_log)
        assert n > 0 and captured > 0, (k, replayed, eng.graph_log)
        on_card[k] += n - captured
    print(f"{tag}: graphs {len(eng.graph_log)} (variants "
          f"{[g['variant'] for g in eng.graph_log]}), capture "
          f"{sum(g['capture_s'] for g in eng.graph_log):.3f} s, replays "
          f"{sum(g['replays'] for g in eng.graph_log)}, launches replayed "
          f"(captured x replays) {replayed}, launches on the card "
          f"{on_card}")
    return res, on_card


def rung_walk(res, device, batch=8, prompt_len=128, max_new=16):
    """Explicit ``request_variant`` walk over the ladder on the full-width
    weights: each rung serves ``batch`` requests; the median decode step
    is reported per rung."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    src = res["engine"]
    rng = np.random.default_rng(1)
    out = {}
    for rung, name in enumerate(res["names"]):
        eng = ServeEngine(src.cfg, batch_slots=batch, max_len=1024,
                          params=src.params, table=src.table,
                          prefill_chunk=128, paged=True, page_size=16,
                          cache_dtype=src.cache_dtype, device=device)
        eng.request_variant(rung)
        assert eng.active_variant == rung
        reqs = [Request(i, prompt=list(rng.integers(
            1, src.cfg.vocab_size, prompt_len)), max_new=max_new)
            for i in range(batch)]
        for r in reqs:
            eng.submit(r)
        drop_int8_weights()
        reset_launches()
        eng.run()
        designs = int8_designs(f"rung {name}")
        if eng.active_knobs.matmul_precision == "int8":
            # admission chunks of prompt_len rows, decode steps of batch
            assert designs["A"] > 0 and designs["B"] > 0, designs
        assert all(r.done for r in reqs)
        step_ms = 1e3 * float(np.median(eng.step_latencies))
        out[name] = step_ms
        print(f"rung {name}: median decode step {step_ms:.3f} ms "
              f"({batch} slots, prompt {prompt_len}, "
              f"{len(eng.step_latencies)} steps)")
    return out


def profile_rungs(res, device, batch=8, prompt_len=128, steps=8):
    """``torch.profiler`` over ``steps`` decode steps of a full batch on each
    rung of the full-width model: wall and device-busy time per step, and
    the kernels that took the most device time. Only the card's activity is
    traced (host-side tracing of every operator costs more than the step)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request, ServeEngine

    src = res["engine"]
    rng = np.random.default_rng(2)
    for rung, name in enumerate(res["names"]):
        eng = ServeEngine(src.cfg, batch_slots=batch, max_len=1024,
                          params=src.params, table=src.table,
                          prefill_chunk=128, paged=True, page_size=16,
                          cache_dtype=src.cache_dtype, device=device)
        eng.request_variant(rung)
        for i in range(batch):
            eng.submit(Request(i, prompt=list(rng.integers(
                1, src.cfg.vocab_size, prompt_len)), max_new=steps + 32))
        while not all(s is not None for s in eng.slots):
            eng.step()
        eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in kern) / 1e3 / steps
        print(f"profile {name}: {batch} slots, {steps} decode steps, "
              f"wall {1e3 * wall / steps:.3f} ms/step, device busy "
              f"{busy:.3f} ms/step ({busy / (1e3 * wall / steps):.3f})")
        for e in sorted(kern, key=dev_us, reverse=True)[:10]:
            print(f"  {dev_us(e) / 1e3 / steps:9.3f} ms/step "
                  f"{e.count / steps:6.1f} calls/step  {e.key[:90]}")
        paged = sum(dev_us(e) for e in kern if "paged" in e.key)
        print(f"profile {name}: paged_attention's kernels "
              f"{paged / 1e3 / steps:.3f} ms/step "
              f"({paged / 1e3 / steps / busy:.3f} of busy)")


# ------------------------------------------------------------- megastep --

MEGA_K = 8                    # the megastep phase's K
ATTN_LAYERS = 8               # the train-attn cell's depth (phi4-mini: 32)
# the train cell's depth: 24 of mamba2-780m's 48 layers at full width (48
# until the train-encdec phase ran over the script's time limit)
TRAIN_LAYERS = 24


def mega_engine(src, device, rung, k=MEGA_K, **kw):
    """An engine on the full-width weights of the serve run's engine ``src``
    (8 slots, max_len 1024, page 16, chunk 128, all 8 admissions in one
    step) on rung ``rung``: megastep K ``k``, per-step for 0."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(src.cfg, batch_slots=8, max_len=1024,
                      params=src.params, table=src.table, prefill_chunk=128,
                      paged=True, page_size=16, cache_dtype=src.cache_dtype,
                      device=device, max_admission_chunks=8, megastep_k=k,
                      **kw)
    eng.request_variant(rung)
    return eng


def mega_prompts(vocab, n=8, length=128, seed=4):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, length))) for _ in range(n)]


def serve_streams(eng, prompts, max_new, swap=None, clear_at=0):
    """Serve ``prompts`` to the end; ``swap`` = (tokens, rung): ask for
    ``rung`` once every request holds ``tokens`` tokens, counting those of
    a megastep in flight (the swap lands it first), and nothing is
    admitting; asserted, so the swap lands at the same token on every
    engine. ``clear_at`` > 0: empty the int8 weight cache after that step,
    as a swap of another engine on the same weights does (a megastep
    engine must recapture). Returns the streams."""
    from repro_torch.serve.engine import Request
    reqs = [Request(i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while not eng.idle:
        eng.step()
        steps += 1
        if steps == clear_at:
            drop_int8_weights()
        flying = eng._inflight["k"] if eng._inflight else 0
        if swap and all(r.out for r in reqs) \
                and min(len(r.out) for r in reqs) + flying >= swap[0]:
            assert not eng._admissions and not eng._await_admit
            assert bool(eng.megastep_k) == bool(flying)
            eng.request_variant(swap[1])
            assert [len(r.out) for r in reqs] == [swap[0]] * len(reqs), \
                [len(r.out) for r in reqs]
            swap = None
    assert all(r.done and len(r.out) == max_new for r in reqs)
    return [r.out for r in reqs]


def decode_window(eng, rounds):
    """``rounds`` engine steps of a full batch under ``torch.profiler`` (the
    card's activity only): wall and device-busy ms a token of a row (a
    decode step's worth), stream syncs, and tokens emitted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tokens0 = sum(len(r.out) for r in eng.slots if r is not None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = (sum(len(r.out) for r in eng.slots if r is not None)
             - tokens0) / eng.batch_slots
    assert steps > 0 and all(r is not None for r in eng.slots), steps
    busy = sum(dev_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(wall_ms=1e3 * wall / steps, busy_ms=busy / steps,
                share=busy / (1e3 * wall), steps=steps)


def check_sampling(device, vocab=200064, B=8):
    """``lm.sample_token`` at temperature 0.7 on the card and on the CPU on
    the same (B, vocab) fp32 logits and (seed, uid, draw): the same tokens
    (threefry is integer arithmetic and ``xla_log`` fp32 / fp64 IEEE ops,
    so both devices compute the same Gumbels); greedy too. Also the
    sampler's time on the card a call."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(
        (rng.standard_normal((B, vocab)) * 3).astype(np.float32))
    uids = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, B).astype(np.int32))
    draws = torch.tensor([0, 1, 2, 7, 15, 2 ** 16, 99_999, 3][:B],
                         dtype=torch.int32)
    on_card = [t.to(device) for t in (logits, uids, draws)]
    for temperature in (0.7, 0.0):
        got = lm.sample_token(*on_card, temperature=temperature, seed=11)
        want = lm.sample_token(logits, uids, draws, temperature=temperature,
                               seed=11)
        assert got.cpu().tolist() == want.tolist(), (temperature, got, want)
    ms = timed(lambda: lm.sample_token(*on_card, temperature=0.7, seed=11),
               device)
    print(f"megastep sampling: sample_token on {device} == cpu at "
          f"temperature 0.7 and greedy ({B} x {vocab}); threefry draw "
          f"{ms:.3f} ms a call")


def check_megastep_syncs(eng):
    """Host waits for the stream (``host_syncs``) in one replay of the
    engine's captured body, in the body run eagerly on rows that are all
    dead, and in one steady megastep round: 0 each."""
    import torch
    g = eng._graph
    step = eng._megastep_fn(1)
    dead = [torch.zeros_like(t) for t in eng._state]
    eng._col.zero_()
    syncs = dict(replay=host_syncs(lambda: g.graph.replay()),
                 eager_body=host_syncs(
                     lambda: step(eng.params, *dead, eng.caches)),
                 round=host_syncs(eng.step))
    print(f"megastep host syncs: {syncs}")
    assert syncs == dict(replay=0, eager_body=0, round=0), syncs
    return syncs


def megastep_rungs(res, device, max_new=33, rounds=3):
    """On every rung: the per-step engine and the megastep engine (K 8, a
    replayed CUDA graph) serve the same 8 prompts of 128 tokens; their
    greedy streams must be equal token for token, the int8 weight cache
    emptied after the megastep engine's third round with a megastep in
    flight (on the int8 rungs its graph is recaptured: two captures; the
    precise graph holds no int8 weight, the cache is empty, one capture).
    Then a full batch of
    each, profiled over a window of decode (wall and device busy a token,
    busy share), the graphs captured and their seconds, dispatches a
    token. Returns the rows."""
    import numpy as np
    src = res["engine"]
    prompts = mega_prompts(src.cfg.vocab_size)
    rows = {}
    for rung, name in enumerate(res["names"]):
        drop_int8_weights()
        per = mega_engine(src, device, rung, k=0)
        a = serve_streams(per, prompts, max_new)
        mega = mega_engine(src, device, rung)
        b = serve_streams(mega, prompts, max_new, clear_at=3)
        assert a == b, (name, [sum(x != y for x, y in zip(p, q))
                               for p, q in zip(a, b)])
        int8 = mega.active_knobs.matmul_precision == "int8"
        assert len(mega.graph_log) == 1 + int8, mega.graph_log
        full = [w for w in mega.step_latencies[1:]]
        step_ms = 1e3 * float(np.median(per.step_latencies))
        tok_ms = 1e3 * float(np.median(full)) / MEGA_K
        # profiled windows of a full batch, past admission and capture
        win = {}
        for kind, k in (("per-step", 0), ("megastep", MEGA_K)):
            eng = mega_engine(src, device, rung, k=k)
            from repro_torch.serve.engine import Request
            for i, p in enumerate(prompts):
                eng.submit(Request(i, prompt=list(p), max_new=8 * MEGA_K))
            while not (all(s is not None for s in eng.slots)
                       and (not k or eng._inflight is not None)):
                eng.step()
            eng.step()
            win[kind] = decode_window(eng, rounds * (MEGA_K if not k else 1))
            if k:
                # a megastep's device work alone: K replays back to back
                # (the token column reset first, as a dispatch does)
                g = eng._graph

                def flight():
                    eng._col.zero_()
                    for _ in range(MEGA_K):
                        g.graph.replay()
                win["graph_ms"] = timed(flight, device) / MEGA_K
                if rung == 0:
                    check_megastep_syncs(eng)
        cap = mega.graph_log
        rows[name] = dict(
            per_step_ms=step_ms, mega_tok_ms=tok_ms, win=win,
            graphs=len(cap), capture_s=sum(g["capture_s"] for g in cap),
            dispatches_a_token=mega.row_dispatches / mega.row_tokens,
            tokens=sum(map(len, b)))
        print(f"megastep {name}: streams equal ({rows[name]['tokens']} "
              f"tokens); median per-step {step_ms:.3f} ms a token, megastep "
              f"{tok_ms:.3f} ms a token (flight wall / {MEGA_K}); window "
              f"per-step wall {win['per-step']['wall_ms']:.3f} / busy "
              f"{win['per-step']['busy_ms']:.3f} ms ({win['per-step']['share']:.3f}), "
              f"megastep wall {win['megastep']['wall_ms']:.3f} / busy "
              f"{win['megastep']['busy_ms']:.3f} ms ({win['megastep']['share']:.3f}), "
              f"replayed alone {win['graph_ms']:.3f} ms a token; "
              f"graphs {len(cap)}, capture {rows[name]['capture_s']:.3f} s, "
              f"dispatches/token {rows[name]['dispatches_a_token']:.3f}")
    return rows


def megastep_swap(res, device, max_new=20, at=9):
    """A swap across ``kv_quant`` (and off the bf16 matmuls: precise ->
    int8+kvq8) asked for with a megastep in flight, when every request
    holds ``at`` tokens: the megastep engine's streams equal the per-step
    engine's under the same swap."""
    src = res["engine"]
    prompts = mega_prompts(src.cfg.vocab_size, seed=5)
    last = len(res["names"]) - 1
    drop_int8_weights()
    a = serve_streams(mega_engine(src, device, 0, k=0), prompts, max_new,
                      swap=(at, last))
    mega = mega_engine(src, device, 0)
    b = serve_streams(mega, prompts, max_new, swap=(at, last))
    assert a == b, [sum(x != y for x, y in zip(p, q)) for p, q in zip(a, b)]
    assert mega.active_variant == last and \
        {g["variant"] for g in mega.graph_log} == {0, last}, mega.graph_log
    print(f"megastep swap precise -> {res['names'][last]} at token {at} "
          f"with a megastep in flight: streams equal "
          f"({sum(map(len, b))} tokens), graphs {len(mega.graph_log)}")


def megastep_temperature(res, device, max_new=17):
    """Temperature 0.7 on the full-width engine: K 1 and K 8 give the same
    streams (the (seed, uid, draw) key does not see K)."""
    src = res["engine"]
    prompts = mega_prompts(src.cfg.vocab_size, seed=6)
    outs = [serve_streams(mega_engine(src, device, 0, k=k, temperature=0.7,
                                      seed=11), prompts, max_new)
            for k in (1, MEGA_K)]
    assert outs[0] == outs[1]
    print(f"megastep temperature 0.7: K 1 == K {MEGA_K} streams "
          f"({sum(map(len, outs[0]))} tokens)")


@contextlib.contextmanager
def depth_cut(arch, driver="train", **fields):
    """``repro_torch.launch.<driver>`` building ``arch`` with ``fields`` of
    its config replaced (a depth cut at full width), through the driver's
    own ``get_config``, patched. Yields the cut config."""
    import importlib
    from unittest import mock

    from repro_torch.configs import get_config
    mod = importlib.import_module(f"repro_torch.launch.{driver}")
    cut = dataclasses.replace(get_config(arch), **fields)
    with mock.patch.object(mod, "get_config",
                           lambda name: cut if name == arch
                           else get_config(name)):
        yield cut


def train_full(device, arch, steps, batch, seq, names, per_step,
               remat="none", extra=()):
    """A training slice at full width and depth:
    ``repro_torch.launch.train.main`` on ``arch`` (fp32 params, random
    weights from a seed) under ``--pliant``, decisions every step, so the
    burst in the middle of the run walks the ladder ``names`` down and
    back; ``extra`` appended to its arguments. Each rung's step is one
    CUDA graph, captured at the rung's first step. The kernels' launch
    counters are zeroed just before and read just after, the graphs'
    replays counted in (``card_launches``), and must equal
    ``per_step(cfg, knobs)`` summed over the rungs the run took."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.train.step import GraphedTrainStep
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--pliant", "--decision-interval", "0",
            "--device", str(device), *extra]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = train.main(argv, remat=remat)
    launches = card_launches(res["steps"])
    int8_designs(f"train {arch}")
    cfg, table = res["cfg"], res["table"]
    flash_designs(f"train {arch}", cfg)
    assert res["names"] == names, res["names"]
    assert set(res["variants"]) == set(range(len(names))), res["variants"]
    assert all(np.isfinite(res["losses"])), res["losses"]
    want = dict.fromkeys(COUNTERS, 0)
    for v in res["variants"]:
        for k, n in per_step(cfg, table.variants[v].knobs).items():
            want[k] += n
    walk = [names[v] for v in res["variants"]]
    print(f"train {arch}: {steps} steps batch {batch} seq {seq} remat "
          f"{remat}, losses {[round(x, 4) for x in res['losses']]}, rungs "
          f"{walk}, step_s {[round(x, 3) for x in res['step_s']]}, data "
          f"wait s {[round(x, 4) for x in res['wait_s']]}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"allocated, {torch.cuda.max_memory_reserved() / 2 ** 30:.2f} "
          f"reserved, launches={launches}")
    print(f"train {arch} graphs: {graph_line(res['steps'])}")
    assert all(isinstance(s, GraphedTrainStep) for s in res["steps"])
    assert launches == want, (launches, want)
    return res, launches


def train_rung_walk(res, device, steps=8, per_step=None, skip=1,
                    rungs=None, tag="", eager=0, syncs=False):
    """Each rung (or those named in ``rungs``) pinned on the full-width
    state: ``steps`` steps of ``table.executable(i)`` (the rung's CUDA
    graph) and then ``eager`` steps of the eager ``TrainStep`` it wraps,
    called directly; for each, the median of all but the first ``skip``
    (and their spread), the peak device memory (allocated; with the
    graphs also reserved, which holds their pool), and the kernel launches
    a step (held to ``per_step``; the graph's replays counted in). With
    ``syncs``, one more replayed step runs under ``host_syncs``, which
    must find no wait for the stream in it (a profiler session: seconds
    at whisper's depth). ``tag`` follows the rung's name in the
    report."""
    import numpy as np
    import torch
    from repro_torch.launch.train import extra_inputs
    table, src, cfg = res["table"], res["source"], res["cfg"]
    params, opt = res["params"], res["opt"]
    execs = list(table.executables.values())
    out = {}
    k = 0

    def run(step, n):
        nonlocal params, opt, k
        times = []
        for _ in range(n):
            tokens = torch.as_tensor(src.batch(100 + k), device=device)
            batch = {"tokens": tokens, **extra_inputs(
                cfg, tokens.shape[0], 0, 100 + k, device)}
            k += 1
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        return times

    def median(times):
        kept = times[skip:]
        return 1e3 * float(np.median(kept)), kept

    for i, name in enumerate(res["names"]):
        if rungs is not None and name not in rungs:
            continue
        label = f"train rung {cfg.name} {name}{tag}"
        want = {key: n for key, n in per_step(cfg, table.variants[i].knobs
                                              ).items() if n}
        graph = table.executable(i)
        row = {}
        for kind, step, n in (("captured", graph, steps),
                              ("eager", getattr(graph, "step", graph),
                               eager)):
            if not n:
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks = graph_marks(execs)
            reset_launches()
            times = run(step, n)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            reserved = torch.cuda.max_memory_reserved() / 2 ** 30
            per = {key: c / n for key, c in card_launches(execs, marks
                                                          ).items() if c}
            int8_designs(f"{label} {kind}")
            flash_designs(f"{label} {kind}", cfg)
            ms, kept = median(times)
            row[kind] = dict(step_ms=ms, peak_gib=peak, reserved_gib=reserved,
                             launches=per)
            print(f"{label} {kind}: median step {ms:.1f} ms over "
                  f"{len(kept)} steps (range {1e3 * min(kept):.1f}-"
                  f"{1e3 * max(kept):.1f}, first {1e3 * times[0]:.1f} ms), "
                  f"peak {peak:.2f} GiB allocated, {reserved:.2f} reserved, "
                  f"launches a step {per}")
            assert per == want, (name, kind, per, want)
        if steps and syncs:
            # one replayed step from the batch's copy to the loss's read:
            # the batch already on the card, the loss read after
            tokens = torch.as_tensor(src.batch(100 + k), device=device)
            batch = {"tokens": tokens, **extra_inputs(
                cfg, tokens.shape[0], 0, 100 + k, device)}
            k += 1
            got = []
            n = host_syncs(lambda: got.append(graph(params, opt, batch)))
            params, opt, m = got[0]
            float(m["loss"])
            st = graph.stats
            row.update(syncs=n, capture_s=st["capture_s"],
                       pool_gib=st["pool_bytes"] / 2 ** 30)
            ratio = ""
            if "eager" in row:
                r = row["eager"]["step_ms"] / row["captured"]["step_ms"]
                ratio = f"; eager / captured {r:.3f}"
            print(f"{label}: graph captured in {st['capture_s']:.3f} s "
                  f"after a {st['warmup_s']:.3f} s warm-up step, its pool "
                  f"{st['pool_bytes'] / 2 ** 30:.2f} GiB, {st['replays']} "
                  f"replays so far; host syncs in a replayed step {n}"
                  + ratio)
            assert n == 0, (name, n)
        out[name] = row
    res["params"], res["opt"] = params, opt
    return out


def chunked_causal_attention():
    """A context in which the model's causal attention at stride 1 runs
    ``_causal_chunked`` at stride 1 (plain PyTorch: what the perforated
    rung runs, less the perforation) in place of the kernel, so that the
    stride rung's change of step time splits into the swap of kernel for
    plain PyTorch and the perforation itself."""
    from unittest import mock
    from repro_torch.kernels import ops
    from repro_torch.models import attention as am
    flash = ops.flash

    def chunked(q, k, v, *, causal=True, window=0, cap=0.0,
                kv_keep_stride=1):
        if not causal or window or kv_keep_stride > 1:
            return flash(q, k, v, causal=causal, window=window, cap=cap,
                         kv_keep_stride=kv_keep_stride)
        B, H, S, hd = q.shape
        G = k.shape[1]
        o = am._causal_chunked(
            q.transpose(1, 2).reshape(B, S, G, H // G, hd),
            k.transpose(1, 2), v.transpose(1, 2),
            q_chunk=am.default_q_chunk(S), kv_keep_stride=1, cap=cap)
        return o.reshape(B, S, H, hd).transpose(1, 2)
    return mock.patch.object(ops, "flash", chunked)


def time_attention_paths(device, B=2, S=4096, H=24, KVH=8, hd=128,
                         layers=32, iters=3):
    """One layer's attention core at phi4-mini's training cell (fp32,
    causal), from the model's (B, S, H, hd) layout, three ways: the kernel
    through ``ops.flash`` (the precise and int8 rungs), and
    ``_causal_chunked`` at stride 1 and at stride 2 (int8+kvstride2). Each
    is timed forward alone (remat's first pass, which saves nothing) and
    forward with backward (the recompute and the VJP): a step spends
    ``layers`` x (forward + forward-and-backward). Kernel against chunked
    stride 1 is the stride rung's swap of kernel for plain PyTorch;
    chunked stride 1 against stride 2 its perforation. The kernel's and
    chunked stride 1's outputs are held to each other (FP32_ATOL)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import attention as am
    q, k, v = (t.transpose(1, 2).contiguous() for t in flash_case(
        B, H, KVH, S, S, hd, torch.float32, device, seed=1))
    go = torch.randn(B, S, H, hd, device=device,
                     generator=torch.Generator(device=device).manual_seed(2))

    def kernel(q, k, v):
        return ops.flash(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True).transpose(1, 2)

    def chunked(stride):
        return lambda q, k, v: am._causal_chunked(
            q.reshape(B, S, KVH, H // KVH, hd), k, v,
            q_chunk=am.default_q_chunk(S), kv_keep_stride=stride,
            cap=0.0).reshape(B, S, H, hd)

    paths = {"kernel": kernel, "chunked stride 1": chunked(1),
             "chunked stride 2": chunked(2)}
    with torch.no_grad():
        err = max_err(kernel(q, k, v), paths["chunked stride 1"](q, k, v))
    assert err <= FP32_ATOL, err
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = {}
    for name, fn in paths.items():
        def fwd():
            with torch.no_grad():
                fn(q, k, v)

        def fwd_bwd():
            fn(*leaves).backward(go)
        f, fb = timed(fwd, device, iters, 1), timed(fwd_bwd, device, iters, 1)
        out[name] = dict(fwd_ms=f, fwd_bwd_ms=fb,
                         step_ms=layers * (f + fb))
        print(f"attention core {name}: forward {f:.3f} ms, forward+backward "
              f"{fb:.3f} ms, {layers} layers under remat "
              f"{layers * (f + fb):.1f} ms a step")
    print(f"attention core: kernel vs chunked stride 1 max_abs_err "
          f"{err:.3g} (tol {FP32_ATOL:.3g})")
    return out


def profile_train(res, device, eager=True):
    """``torch.profiler`` over one training step per rung at full width,
    the card's activity only, once replayed (the rung's CUDA graph) and,
    with ``eager``, once eager (the ``TrainStep`` it wraps): wall and
    device-busy time
    (the kernels' sum), busy share, the largest kernels; beside them the
    device time between CUDA events recorded around the step, which does
    not rest on the profiler seeing the kernels inside a replayed graph.
    Returns {rung: {kind: (wall ms, busy ms, events ms)}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    table, src = res["table"], res["source"]
    params, opt = res["params"], res["opt"]
    out = {}
    for i, name in enumerate(res["names"]):
        graph = table.executable(i)
        kinds = [("captured", graph)] + ([("eager", graph.step)]
                                         if eager else [])
        for kind, step in kinds:
            tokens = torch.as_tensor(src.batch(200 + i), device=device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ev[0].record()
                params, opt, m = step(params, opt, {"tokens": tokens})
                ev[1].record()
                float(m["loss"])
                wall = 1e3 * (time.perf_counter() - t0)
            kern = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and dev_us(e) > 0]
            busy = sum(dev_us(e) for e in kern) / 1e3
            span = ev[0].elapsed_time(ev[1])
            out.setdefault(name, {})[kind] = (wall, busy, span)
            print(f"train profile {res['cfg'].name} {name} {kind}: wall "
                  f"{wall:.1f} ms, device busy {busy:.1f} ms "
                  f"({busy / wall:.3f}), events {span:.1f} ms, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
            for e in sorted(kern, key=dev_us, reverse=True)[:8]:
                print(f"  {dev_us(e) / 1e3:9.3f} ms {e.count:6d} calls  "
                      f"{e.key[:90]}")
    res["params"], res["opt"] = params, opt
    return out


def train_graph_witness(res, device, rungs=(0, 1, -1)):
    """The captured steps held to the eager step on the card: from one
    state (the run's, and a copy of it), one step on each rung of
    ``rungs`` in turn (a rung switch at every step), once through the
    table's CUDA graphs and once through the eager ``TrainStep``s they
    wrap (``make_train_step``'s, called directly) on the same batches:
    every step's metrics (loss, grad norm, learning rate, the loss's
    parts) and, after every step, the parameters and both AdamW moments
    equal bit for bit. Reports the first tensor that differs, if any."""
    import copy

    import torch
    from repro_torch.launch.train import extra_inputs
    from repro_torch.train import optim
    from repro_torch.train.step import state_tensors
    table, src, cfg = res["table"], res["source"], res["cfg"]
    params, opt = res["params"], res["opt"]
    torch.cuda.synchronize()
    eparams = copy.deepcopy(params)
    eopt = optim.OptState(opt.step, {k: v.clone() for k, v in opt.m.items()},
                          {k: v.clone() for k, v in opt.v.items()})
    names = [n for n, _ in params.named_parameters()]
    where = ([f"param {n}" for n in names] + [f"m {n}" for n in opt.m]
             + [f"v {n}" for n in opt.v])
    idx = [r % len(table) for r in rungs]
    diffs, losses = [], []
    for k, i in enumerate(idx):
        tokens = torch.as_tensor(src.batch(300 + k), device=device)
        batch = {"tokens": tokens, **extra_inputs(
            cfg, tokens.shape[0], 0, 300 + k, device)}
        graph = table.executable(i)
        params, opt, gm = graph(params, opt, batch)
        eparams, eopt, em = graph.step(eparams, eopt, batch)
        assert opt.step == eopt.step, (opt.step, eopt.step)
        losses.append((float(gm["loss"]), float(em["loss"])))
        for key in em:
            a, b = gm[key], em[key]
            same = torch.equal(a, b) if torch.is_tensor(a) else a == b
            if not same:
                diffs.append((k, res["names"][i], f"metric {key}",
                              float(a), float(b)))
        for w, a, b in zip(where, state_tensors(params, opt),
                           state_tensors(eparams, eopt)):
            if not torch.equal(a, b):
                diffs.append((k, res["names"][i], w,
                              float((a - b).abs().max())))
    steps = [res["names"][i] for i in idx]
    print(f"train graphs vs eager {cfg.name}: {len(idx)} steps over "
          f"{steps} from one state, losses (captured, eager) {losses}; "
          f"{len(where)} state tensors and every metric compared after "
          f"each step: {len(diffs)} differ"
          + (f", first {diffs[:4]}" if diffs else " (bit for bit)"))
    del eparams, eopt
    torch.cuda.empty_cache()
    res["params"], res["opt"] = params, opt
    assert not diffs, diffs[:8]


# -------------------------------------------------------------- ring_hop --

RING_N = 4                    # the ring cell's mesh 4x1: 4 sequence shards
RING_CHUNK = 2048             # its prefill chunk
RING_CTX = 16384              # its max_len: the gathered block row
# fp32 hop state and ring outputs: kernel and plain version compute in fp32
# from the same (exactly upcast) inputs and differ in the order of their
# sums (online softmax over 64-key tiles against one pass over the hop;
# dot products of 128 terms), ~1e-7 relative: held to RING_REL of the
# largest |acc|, l, |m| or |o| of the reference.
RING_REL = 1e-5


def ring_hop_case(c, device, seed=0):
    """One hop as the cell's ring gives it: shard 0's resident queries,
    striped from a chunk of ``RING_N * Cl`` positions starting at
    ``chunk_start`` (rows chunk_start, +n, +2n, ...), against a K/V shard
    of Ll positions from ``kv_start``; entries at or past the chunk's end
    are not written yet (-1). q, k unit-scale (the model's RoPE'd
    projections are O(1)), v unit-scale, int8 K/V quantised with the
    engine's ``quantize_kv``. ``holes``: unmapped runs of -1 in the K/V
    positions; ``dead``: query rows at -1 and rows before every key (they
    see nothing and must keep their state); ``carried``: the state a plain
    hop over the diagonal shard left (else the initial state)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.models.attention import KV_SCALE, quantize_kv
    B, H, KVH, Cl, Ll, hd = c["shape"]
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)

    q = normal(B, H, Cl, hd).to(c["q_dtype"])
    k, v = normal(B, KVH, Ll, hd), normal(B, KVH, Ll, hd)
    kv_scale = 0.0
    if c["kv_dtype"] == torch.int8:
        k, v, kv_scale = quantize_kv(k), quantize_kv(v), KV_SCALE
    else:
        k, v = k.to(c["kv_dtype"]), v.to(c["kv_dtype"])
    start, end = c["chunk_start"], c["chunk_start"] + RING_N * Cl
    qp = torch.arange(start, end, RING_N, dtype=torch.int32).expand(
        B, Cl).clone()
    kvp = torch.arange(c["kv_start"], c["kv_start"] + Ll,
                       dtype=torch.int32).expand(B, Ll).clone()
    kvp[kvp >= end] = -1
    if c.get("holes"):
        kvp[:, Ll // 8: Ll // 8 + 48] = -1
        kvp[:, Ll // 2: Ll // 2 + 16] = -1
    if c.get("dead"):
        qp[:, :5] = -1
        qp[:, 5:9] = c["kv_start"] - 1 - torch.arange(4, dtype=torch.int32)
    m = torch.full((B, H, Cl, 1), ra.NEG_INF)
    l, acc = torch.zeros(B, H, Cl, 1), torch.zeros(B, H, Cl, hd)
    args = [t.to(device) for t in (q, k, v, qp, kvp, m, l, acc)]
    kw = dict(window=c.get("window", 0), cap=c.get("cap", 0.0),
              kv_scale=kv_scale)
    if c.get("carried"):
        kd = args[1][:, :, :Ll // 2]
        vd = args[2][:, :, :Ll // 2]
        kpd = torch.arange(start, start + Ll // 2, dtype=torch.int32,
                           device=device).expand(B, Ll // 2).contiguous()
        ra.ring_hop_plain(args[0], kd.contiguous(), vd.contiguous(),
                          args[3], kpd, *args[5:], **kw)
    return args, kw


def ring_hop_bound_ms(args, kw):
    """``ring_attention.work`` over the pairs this hop's positions make
    visible, at the query type's peak (the fp32 peak for fp32 queries, the
    bf16 one otherwise: the int8 K/V are dequantised to the products'
    type). Returns (ms, bound by, pairs)."""
    import torch
    from repro_torch.kernels import ring_attention as ra
    q, k, v, qp, kvp, m, l, acc = args
    B, H, Cl, hd = q.shape
    KVH, Ll = k.shape[1], k.shape[2]
    pairs = int(ra.visible(qp, kvp, kw["window"]).sum())
    peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    ms, by = bound_ms(*ra.work(B, H, KVH, Cl, Ll, hd, q.element_size(),
                               k.element_size(), pairs), peak)
    return ms, by, pairs


def state_errors(got, ref):
    """(m, l, acc) differences, each over the reference's largest entry (m
    over its rows that saw a key; rows still at -1e30 must stay there)."""
    import torch
    from repro_torch.kernels import ring_attention as ra
    (gm, gl, ga), (rm, rl, ra_) = got, ref
    live = rm > ra.NEG_INF / 10
    assert torch.equal(gm[~live], rm[~live]), "untouched rows moved"
    scale_m = float(rm[live].abs().max()) if live.any() else 1.0
    return dict(
        m=max_err(gm[live], rm[live]) / max(scale_m, 1.0) if live.any()
        else 0.0,
        l=max_err(gl, rl) / max(float(rl.abs().max()), 1e-30),
        acc=max_err(ga, ra_) / max(float(ra_.abs().max()), 1e-30))


def hop_library(args, kw):
    """One ``scaled_dot_product_attention`` call computing a fresh-state hop
    on the same inputs (bf16 queries only: the hop's visibility as a
    boolean ``attn_mask``, GQA by ``enable_gqa``, int8 K/V dequantised to
    bf16 beforehand; the soft cap has no counterpart). Merging its output
    into a carried (m, l, acc) would take three more elementwise passes.
    Returns the call, or None for fp32 queries."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ring_attention as ra
    q, k, v, qp, kvp = args[:5]
    if q.dtype != torch.bfloat16:
        return None
    if kw["kv_scale"]:
        k, v = (t.to(torch.bfloat16) * kw["kv_scale"] for t in (k, v))
    mask = ra.visible(qp, kvp, kw["window"])[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def ring_step_case(c, device):
    """The cell case ``c`` as a ring step over RING_N shards: shard d's
    inputs are ``ring_hop_case(c, seed=d)`` (shard 0 the case itself), and
    shard d meets K/V shard (d - 1) mod RING_N, as at hop 1."""
    import torch
    cases = [ring_hop_case(c, device, seed=d) for d in range(RING_N)]
    stacks = [torch.stack([a[i] for a, _ in cases]) for i in range(8)]
    pairs = [(d, (d - 1) % RING_N) for d in range(RING_N)]
    return stacks, pairs, cases[0][1]


def check_ring_step(c, device, iters):
    """``ring_hop_step`` (one launch for the RING_N shards of a hop step)
    against ``ring_hop_step_plain`` at RING_REL, blind rows kept exactly,
    the launch counted once in the design ``select_hop_design`` names;
    returns its time."""
    import torch
    from repro_torch.kernels import ring_attention as ra
    stacks, pairs, kw = ring_step_case(c, device)
    state = stacks[5:]
    design = ra.select_hop_design(stacks[0].dtype, stacks[1].dtype,
                                  stacks[0].shape[-1])
    before = (ra.launches, ra.design_launches[design])
    got = ra.ring_hop_step(*stacks[:5], *[t.clone() for t in state], pairs,
                           **kw)
    assert (ra.launches, ra.design_launches[design]) == \
        (before[0] + 1, before[1] + 1), (c["name"], ra.design_launches)
    ref = ra.ring_hop_step_plain(*stacks[:5], *[t.clone() for t in state],
                                 pairs, **kw)
    torch.cuda.synchronize()
    for d, src in pairs:
        err = state_errors([t[d] for t in got], [t[d] for t in ref])
        assert max(err.values()) <= RING_REL, (c["name"], d, err)
        seen = ra.visible(stacks[3][d], stacks[4][src], kw["window"]).any(-1)
        blind = ~seen[:, None, :].expand(stacks[0].shape[1:4])
        assert torch.equal(got[2][d][blind], state[2][d][blind]), c["name"]
    work = [t.clone() for t in state]
    return timed(lambda: ra.ring_hop_step(*stacks[:5], *work, pairs, **kw),
                 device, iters)


def check_ring_hop(device, cases, iters=10):
    """``ring_hop`` against ``ring_hop_plain`` on the card, each updating
    its own copy of the state, held to RING_REL (both compute in fp32 from
    the same inputs up to the order of the sums: design "tc" takes bf16
    products, exact in fp32, and splits P into two bf16 halves for P.V).
    Rows that see nothing keep their state exactly. bf16 queries (bf16 or
    int8 K/V) must launch design "tc", fp32 ones "simt". The cell cases
    also run as a ``ring_hop_step`` of RING_N shards. Times: the kernel,
    the plain version, the bound, the step, and the library yardstick
    ``hop_library`` for bf16 queries."""
    import torch
    from repro_torch.kernels import ring_attention as ra
    rows = []
    for c in cases:
        args, kw = ring_hop_case(c, device)
        state = args[5:]
        design = ra.select_hop_design(args[0].dtype, args[1].dtype,
                                      args[0].shape[-1])
        assert design == ("tc" if c["q_dtype"] == torch.bfloat16
                          else "simt"), (c["name"], design)
        before = dict(ra.design_launches)
        got = ra.ring_hop(*args[:5], *[t.clone() for t in state], **kw)
        assert ra.design_launches[design] == before[design] + 1, \
            (c["name"], before, ra.design_launches)
        ref = ra.ring_hop_plain(*args[:5], *[t.clone() for t in state],
                                **kw)
        torch.cuda.synchronize()
        assert all(torch.isfinite(t).all() for t in got[1:]), c["name"]
        err = state_errors(got, ref)
        seen = ra.visible(args[3], args[4], kw["window"]).any(-1)
        blind = ~seen[:, None, :].expand(args[0].shape[:3])
        assert torch.equal(got[2][blind], state[2][blind]), c["name"]
        assert max(err.values()) <= RING_REL, (c["name"], err)
        work = [t.clone() for t in state]
        kern = timed(lambda: ra.ring_hop(*args[:5], *work, **kw), device,
                     iters)
        plain = timed(lambda: ra.ring_hop_plain(*args[:5], *work, **kw),
                      device, 3, warmup=1)
        lib = hop_library(args, kw)
        lib_ms = timed(lib, device, iters) if lib else None
        step_ms = (check_ring_step(c, device, iters)
                   if c["name"].startswith("cell") else None)
        bound, by, pairs = ring_hop_bound_ms(args, kw)
        rows.append(dict(name=c["name"], shape=c["shape"], design=design,
                         max_abs_err=max_err(got[2], ref[2]), rel=err,
                         ms=kern, plain_ms=plain, library_ms=lib_ms,
                         step_ms=step_ms, bound_ms=bound, bound_by=by,
                         pairs=pairs))
        lib_s = "null" if lib_ms is None else f"{lib_ms:.4f}" + (
            " (no cap)" if kw["cap"] else "")
        step_s = "" if step_ms is None else (
            f" step_ms={step_ms:.4f} ({RING_N} shards, one launch; "
            f"{step_ms / kern:.2f}x one hop)")
        print(f"ring_hop {c['name']} (B,H,KVH,Cl,Ll,hd)={c['shape']} q "
              f"{str(args[0].dtype)[6:]} kv {str(args[1].dtype)[6:]} design "
              f"{design}: rel err m={err['m']:.3g} l={err['l']:.3g} "
              f"acc={err['acc']:.3g} (tol {RING_REL:g}), blind rows "
              f"{int(blind.sum())} kept, ms={kern:.4f} plain_ms="
              f"{plain:.4f} library_ms={lib_s} bound_ms={bound:.4f} ({by}, "
              f"{pairs} visible pairs){step_s}")
        if lib is not None and c["name"] == "cell-bf16":
            print("  library kernels: "
                  + ",".join(cuda_kernel_names(lib))[:160])
    return rows


def phi4_ring_hop_cases():
    """The cell's hop (phi4-mini-3.8b: H 24, KVH 8, hd 128; Cl 512 of a
    2048-token chunk over 4 shards, Ll 4096 of a 16384-token block row) in
    bf16, fp32 and int8 K/V, carried state, holes and dead rows; then
    window + softcap with GQA at a small shape, and GQA groups wider than
    a "tc" block holds."""
    import torch
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    cell = dict(shape=(1, 24, 8, 512, 4096, 128), chunk_start=14336)
    small = dict(shape=(2, 8, 2, 100, 300, 64), chunk_start=250,
                 kv_start=200, window=64, cap=30.0)
    return [
        dict(cell, name="cell-bf16", q_dtype=bf16, kv_dtype=bf16,
             kv_start=0, carried=True),
        dict(cell, name="cell-bf16-diagonal", q_dtype=bf16, kv_dtype=bf16,
             kv_start=12288, holes=True),
        dict(cell, name="cell-fp32", q_dtype=f32, kv_dtype=f32, kv_start=0,
             carried=True),
        dict(cell, name="cell-int8", q_dtype=bf16, kv_dtype=i8, kv_start=0,
             carried=True),
        dict(cell, name="cell-int8-diagonal-dead", q_dtype=bf16,
             kv_dtype=i8, kv_start=12288, holes=True, dead=True,
             carried=True),
        dict(cell, name="cell-fp32-dead-rows", q_dtype=f32, kv_dtype=f32,
             kv_start=14400, holes=True, dead=True),
        dict(small, name="window-cap-gqa-fp32", q_dtype=f32, kv_dtype=f32),
        dict(small, name="window-cap-gqa-bf16-carried", q_dtype=bf16,
             kv_dtype=bf16, carried=True),
        # query heads a KV head beyond the tc design's 3 a block: R 4 in
        # two blocks of 2, R 8 in three of 3 (the last with idle warps)
        dict(name="gqa4-bf16", shape=(1, 8, 2, 128, 320, 128),
             chunk_start=600, kv_start=400, q_dtype=bf16, kv_dtype=bf16,
             holes=True, dead=True, carried=True),
        dict(name="gqa8-int8-ragged", shape=(2, 8, 1, 70, 200, 128),
             chunk_start=300, kv_start=150, q_dtype=bf16, kv_dtype=i8,
             window=96, carried=True),
    ]


def ring_chunk_case(device, *, prompt_done=14336, seed=0):
    """The cell's admission chunk: a slot whose block row maps 1024 pages
    of 16 (the 16384-token context), written through ``prompt_done``
    (the chunk's last position + 1, the chunk the last 2048 of them), -1
    beyond; a 2048-token query chunk; phi4-mini heads; bf16."""
    import numpy as np
    import torch
    from repro_torch.models.attention import PagedKVCache
    G, R, hd, P = 8, 3, 128, 16
    M = RING_CTX // P
    rng = np.random.default_rng(seed)
    kp = torch.tensor(rng.normal(size=(M + 1, P, G, hd)),
                      dtype=torch.bfloat16)
    vp = torch.tensor(rng.normal(size=(M + 1, P, G, hd)),
                      dtype=torch.bfloat16)
    ppos = torch.full((M + 1, P), -1, dtype=torch.int32)
    pos = torch.arange(RING_CTX, dtype=torch.int32).reshape(M, P)
    ppos[1:] = torch.where(pos < prompt_done, pos, -1)
    block = torch.arange(1, M + 1, dtype=torch.int32)[None]
    q = torch.tensor(rng.normal(size=(1, RING_CHUNK, G, R, hd)),
                     dtype=torch.bfloat16)
    q_pos = torch.arange(prompt_done - RING_CHUNK, prompt_done,
                         dtype=torch.int32)[None]
    cache = PagedKVCache(kp.to(device), vp.to(device), ppos.to(device),
                         block.to(device))
    return q.to(device), q_pos.to(device), cache


def check_ring_chunk(device, iters=3):
    """The chunk cell's ring branch (``ring_attend``: the block row's gather
    and ``ring_chunk_attention``, the kernel over 4 shards in turn) on the
    cell's chunk against the single-device path of the same admission cell,
    ``_gather_pages`` + ``_sdpa`` (p rounded to bf16 before P.V), and
    against ``_sdpa`` in fp32: bf16 outputs per element within 2^-7 |ref|
    + BF16_ROW x the row's rms (``bf16_row_excess``). Times the ring, the
    single-device path, and one ``scaled_dot_product_attention`` call over
    the gathered context with the boolean mask (the path's yardstick: per
    chunk and layer)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import prefill_plan
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import _gather_pages, _sdpa, ring_attend
    out = {}
    mesh = make_mesh((RING_N, 1), ("data", "model"), device)
    plan, reason = prefill_plan(get_config("phi4-mini-3.8b"), mesh,
                                RING_CHUNK)
    assert plan is not None and plan.n_shards == RING_N, reason
    for done in (14336, 10240):
        q, q_pos, cache = ring_chunk_case(device, prompt_done=done)
        B, C, G, R, hd = q.shape

        def ring():
            return ring_attend(q, cache, cache.block[0], q_pos, mesh=mesh,
                               plan=plan)

        def single(dtype=torch.bfloat16):
            kk, vv, _, valid = _gather_pages(cache, cache.block, q_pos,
                                             window=0)
            return _sdpa(q.to(dtype), kk.to(dtype), vv.to(dtype),
                         mask=valid[:, None, None])

        reset_launches()
        o = ring()
        hops = (ra.hops_run, ra.hops_skipped, ra.launches)
        assert ra.launches == ra.steps_run == ra.design_launches["tc"], \
            (ra.launches, ra.steps_run, ra.design_launches)
        ref, ref32 = single(), single(torch.float32)
        torch.cuda.synchronize()
        assert torch.isfinite(o.float()).all()
        ex, ex32 = bf16_row_excess(o, ref), bf16_row_excess(o, ref32)
        assert max(ex, ex32) <= BF16_ROW, (done, ex, ex32)
        kk, vv, _, valid = _gather_pages(cache, cache.block, q_pos, window=0)
        qh = q.reshape(B, C, G * R, hd).transpose(1, 2)
        kh, vh = kk.transpose(1, 2), vv.transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=valid[:, None], enable_gqa=True)
        lib_ex = bf16_row_excess(lib().transpose(1, 2).reshape(o.shape),
                                 ref32)
        row = dict(ring_ms=timed(ring, device, iters, warmup=1),
                   single_ms=timed(single, device, iters, warmup=1),
                   sdpa_ms=timed(lib, device, iters),
                   hops=hops, excess=ex, excess32=ex32,
                   syncs=host_syncs(ring))
        # the whole-hop skips are decided on the host after ONE copy of the
        # shards' position bounds: no other wait for the stream
        assert row["syncs"] == 1, row["syncs"]
        out[done] = row
        print(f"ring_chunk_attention C={C} L={RING_CTX} bf16 {RING_N} "
              f"shards, context written through {done}: excess vs "
              f"single-device path {ex:.3g} row rms, vs fp32 {ex32:.3g} "
              f"(tol 2^-7 |ref| + {BF16_ROW:g} row rms), hops run/skipped/"
              f"launched {hops}, host syncs {row['syncs']}, ring_ms="
              f"{row['ring_ms']:.3f} "
              f"single_device_ms={row['single_ms']:.3f} sdpa_ms (library "
              f"yardstick, boolean mask; excess vs fp32 {lib_ex:.3g}) "
              f"{row['sdpa_ms']:.3f} a chunk and layer; kernels: "
              + ",".join(cuda_kernel_names(lib))[:120])
        del cache, ref, ref32, kk, vv, valid
    return out


def check_ring_parity(device):
    """phi4-mini-3.8b-smoke in fp32, mesh 4x1, every serving rung: the
    greedy streams of the ring engine on the card (``ring_hop``), the same
    engine on the CPU (``ring_hop_plain``) and the single-device engine on
    the card must be identical. Prompts of 11-35 tokens over chunks of 8
    share an 8-token prefix; tails of 3 and 2 tokens take the single-device
    path."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serving_table
    from repro_torch.models.lm import init_lm
    cfg = get_config("phi4-mini-3.8b-smoke")
    cpu = torch.device("cpu")
    cpu_params = init_lm(cfg, 0, torch.float32, "cpu")
    dev_params = copy.deepcopy(cpu_params).to(device)
    table = serving_table(cfg, slots=2, max_len=64, page_occupancy=0.5)
    rng = np.random.default_rng(4)
    prefix = list(rng.integers(1, cfg.vocab_size, 8))
    prompts = [prefix + list(rng.integers(1, cfg.vocab_size, n))
               for n in (3, 19, 27, 10)]
    kw = dict(max_new=6, prefill_chunk=8, n_pages=40)
    for rung, v in enumerate(table.variants):
        ra.launches = 0
        a = engine_streams(cfg, dev_params, table, device, rung, prompts,
                           mesh=make_mesh((RING_N, 1), ("data", "model"),
                                          device), **kw)
        launched = ra.launches
        b = engine_streams(cfg, cpu_params, table, cpu, rung, prompts,
                           mesh=make_mesh((RING_N, 1), ("data", "model"),
                                          cpu), **kw)
        c = engine_streams(cfg, dev_params, table, device, rung, prompts,
                           **kw)
        assert launched > 0
        assert a == b == c, (v.name, a, b, c)
        print(f"ring parity {v.name}: ring on {device} == ring on cpu == "
              f"single device on {device} ({sum(map(len, a))} tokens, "
              f"{launched} ring_hop launches)")


class AdmissionTrace:
    """Records every admission chunk of an engine run: its length and its
    wall time, the card synchronised before and after (so the chunk's
    device work is inside), and the last-token logits of each prompt's
    final chunk (its first token's logits), keyed by prompt length. With
    ``profile_at``, the first full chunk starting there runs under
    ``torch.profiler`` (the card's activity only): ``profile`` keeps its
    wall, device-busy time and kernels by device time, and the chunk stays
    out of ``summary``'s mean."""

    def __init__(self, prompt_lens, profile_at=None):
        self.ends = set(prompt_lens)
        self.chunks, self.first_logits = [], {}
        self.profile_at, self.profile = profile_at, None

    def __enter__(self):
        import torch
        from repro_torch.serve import prefill as prefill_mod
        self._mod, self._orig = prefill_mod, prefill_mod.paged_prefill_chunk

        def traced(params, tokens, start, *a, **kw):
            C = tokens.shape[1]
            profiling = self.profile is None and start == self.profile_at \
                and C == RING_CHUNK
            prof = (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
                if profiling else contextlib.nullcontext())
            torch.cuda.synchronize()
            with prof:
                t0 = time.perf_counter()
                logits, caches = self._orig(params, tokens, start, *a, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if profiling:
                self.profile = profile_summary(prof, wall)
            # a profiled chunk is kept out of the mean by its sign
            self.chunks.append((-C if profiling else C, wall))
            if start + C in self.ends:
                self.first_logits[start + C] = logits[0].float().cpu()
            return logits, caches
        prefill_mod.paged_prefill_chunk = traced
        return self

    def __exit__(self, *exc):
        self._mod.paged_prefill_chunk = self._orig

    def summary(self):
        import numpy as np
        full = [t for c, t in self.chunks if c == RING_CHUNK]
        tails = sorted((c, round(1e3 * t, 3)) for c, t in self.chunks
                       if abs(c) != RING_CHUNK)
        return 1e3 * float(np.mean(full)), len(full), tails


class DecodeTrace:
    """Times every decode step of an engine run (``ServeEngine._decode``,
    the card synchronised before and after, so its device work is inside)
    and profiles the first step in which every slot decodes under
    ``torch.profiler`` (the card's activity only): wall, device-busy time
    and the part of it spent in ``paged_attention``'s kernels. The
    profiled step stays out of ``mean_ms``."""

    def __init__(self, eng):
        self.eng, self.steps, self.profile = eng, [], None

    def __enter__(self):
        import torch
        orig = self.eng._decode

        def traced(rows_active):
            profiling = self.profile is None and bool(rows_active.all())
            prof = (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
                if profiling else contextlib.nullcontext())
            torch.cuda.synchronize()
            with prof:
                t0 = time.perf_counter()
                out = orig(rows_active)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if profiling:
                self.profile = profile_summary(prof, wall, match="paged")
            else:
                self.steps.append(wall)
            return out
        self.eng._decode = traced
        return self

    def __exit__(self, *exc):
        del self.eng._decode

    def mean_ms(self):
        return 1e3 * sum(self.steps) / max(len(self.steps), 1)


def profile_summary(prof, wall, top=10, match=None):
    """Wall ms, device-busy ms and the ``top`` kernels by device time (ms,
    calls) of one profiled region; with ``match``, also the device ms of
    the kernels whose name holds it (``match_ms``)."""
    import torch

    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and dev_us(e) > 0]
    out = dict(wall_ms=1e3 * wall,
               busy_ms=sum(dev_us(e) for e in kern) / 1e3,
               kernels=[(round(dev_us(e) / 1e3, 3), e.count, e.key[:80])
                        for e in sorted(kern, key=dev_us,
                                        reverse=True)[:top]])
    if match:
        out["match_ms"] = sum(dev_us(e) for e in kern
                              if match in e.key) / 1e3
    return out


# ring cell traffic: prompts of 16000, 12000, 9000 and 8194 tokens (tails of
# 1664, 1760, 808 and 2: the last shorter than the 4 shards)
RING_PROMPTS = (16000, 12000, 9000, 8194)
# first-token logits, ring against single device: max |diff| over the rms of
# the single-device logits. The two paths differ in rounding only: the ring
# keeps p in fp32, the single-device `_sdpa` rounds p to bf16 (2^-9
# relative, random sign) before P.V; in bf16 the residual stream rounds
# again at every layer, so each of the 32 layers adds an O(2^-9) relative
# perturbation that the next ones carry and amplify, and on int8+kvq8 a K/V
# entry whose two versions straddle a rounding boundary takes another int8
# code (a 1/0.05 = 20x coarser step). Over ~2e5 logits the largest lands
# several sigma out. A fault (a hop dropped, a shard's positions shifted, a
# mask turned) replaces a share of every layer's attention and moves the
# logits by several times their rms. Held to 0.5.
RING_LOGIT_TOL = 0.5
# the ring cell with the hop of one launch a shard hop, fp32 FMAs on the
# CUDA cores (H100 80GB HBM3, 700 W), printed beside each run
RING_CELL_BEFORE = {"precise": dict(chunk_ms=526.5, wall=20.40, same=4),
                    "int8+kvq8": dict(chunk_ms=522.5, wall=20.24, same=2)}
# the ring engine's decode step (ms) while its decode ran single-device,
# one paged_attention launch a layer over the 4 slots (H100 80GB HBM3,
# 700 W), printed beside the sharded decode's (one launch a shard)
RING_DECODE_BEFORE = {"precise": 53.792, "int8+kvq8": 77.206}


def ring_cell(device, rungs=("precise", "int8+kvq8")):
    """The ring admission cell at full width: phi4-mini-3.8b (32 layers,
    random bf16 weights from seed 0), 4 slots, max_len 16384, page 16,
    prefill chunk 2048, a pool of 65,664 tokens (8.6 GB of bf16 K/V), mesh
    4x1; 4 greedy requests of RING_PROMPTS tokens, 16 new tokens each, on
    each rung of ``rungs``: once on the ring engine (launch counters zeroed
    just before and read just after) and once on the single-device engine.
    Per rung: admission ms per chunk on each path, ring_hop launches and
    hops run and skipped, host syncs per ring chunk (one a layer: the
    wrapper decides whole-hop skips on the host), the first-token logits
    gate and the streams that are identical."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serving_table
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("phi4-mini-3.8b")
    params = init_lm(cfg, 0, torch.bfloat16, device)
    table = serving_table(cfg, slots=4, max_len=RING_CTX,
                          page_occupancy=0.7)
    names = [v.name for v in table.variants]
    mesh = make_mesh((RING_N, 1), ("data", "model"), device)
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, cfg.vocab_size, n)) for n in
               RING_PROMPTS]
    total = dict.fromkeys(COUNTERS, 0)
    report = {}
    for name in rungs:
        rung = names.index(name)
        res = {}
        for path, m in (("ring", mesh), ("single", None)):
            eng = ServeEngine(cfg, batch_slots=4, max_len=RING_CTX,
                              params=params, table=table,
                              prefill_chunk=RING_CHUNK, paged=True,
                              page_size=16, n_pages=4 * RING_CTX // 16 + 8,
                              cache_dtype=torch.bfloat16, device=device,
                              mesh=m)
            eng.request_variant(rung)
            assert eng.sharded_prefill == (m is not None)
            # decode: one paged_attention launch a slot-affinity shard
            assert eng.sharded_kernel == (m is not None)
            reqs = [Request(i, prompt=p, max_new=16)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            torch.cuda.synchronize()
            drop_int8_weights()
            reset_launches()
            attn_mod.mesh_fallbacks = 0
            t0 = time.perf_counter()
            deep = (max(RING_PROMPTS) - RING_CHUNK) // RING_CHUNK * RING_CHUNK
            with AdmissionTrace(RING_PROMPTS, profile_at=deep) as tr, \
                    DecodeTrace(eng) as dec:
                eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            int8_designs(f"ring cell {name} {path}")
            assert all(r.done and len(r.out) == 16 for r in reqs)
            assert dec.profile is not None and dec.steps, path
            res[path] = dict(trace=tr, decode=dec, launches=launches,
                             wall=wall,
                             streams=[r.out for r in reqs],
                             hops=(ra.hops_run, ra.hops_skipped),
                             steps=ra.steps_run,
                             designs=dict(ra.design_launches),
                             fallbacks=attn_mod.mesh_fallbacks)
            if m is not None:
                for k in total:
                    total[k] += launches[k]
            del eng
            torch.cuda.empty_cache()
        ring, single = res["ring"], res["single"]
        run, skipped = ring["hops"]
        ring_chunks = sum(abs(c) >= RING_N for c, _ in ring["trace"].chunks)
        short = sum(abs(c) < RING_N for c, _ in ring["trace"].chunks)
        # one launch a ring step with a running shard, every one design tc
        assert ring["launches"]["ring_hop"] == ring["steps"] > 0, \
            (ring["launches"], ring["steps"])
        assert ring["designs"] == {"tc": ring["steps"], "simt": 0}, \
            ring["designs"]
        assert run + skipped == RING_N ** 2 * cfg.n_layers * ring_chunks
        assert short == 1 and ring["fallbacks"] == cfg.n_layers, \
            (short, ring["fallbacks"])
        assert single["launches"]["ring_hop"] == 0
        diffs = []
        for n in RING_PROMPTS:
            a, b = ring["trace"].first_logits[n], single["trace"].first_logits[n]
            assert torch.isfinite(a).all() and a.shape == (cfg.vocab_size,)
            diffs.append(float((a - b).abs().max() / b.pow(2).mean().sqrt()))
        same = sum(x == y for x, y in zip(ring["streams"], single["streams"]))
        r_ms, r_n, r_tails = ring["trace"].summary()
        s_ms, s_n, s_tails = single["trace"].summary()
        was = RING_CELL_BEFORE[name]
        print(f"ring cell {name}: admission ms a {RING_CHUNK}-token chunk "
              f"(32 layers) ring {r_ms:.1f} vs single device {s_ms:.1f} "
              f"({r_n} chunks each); tails (tokens, ms) ring {r_tails} vs "
              f"single {s_tails}; run wall ring {ring['wall']:.2f}s single "
              f"{single['wall']:.2f}s (fp32 SIMT hop, a launch a hop: ring "
              f"chunk {was['chunk_ms']} ms, run wall {was['wall']} s)")
        print(f"ring cell {name}: ring_hop launches {ring['steps']} (one a "
              f"ring step, by design {ring['designs']}), hops run {run} "
              f"skipped {skipped} over {ring_chunks} ring chunks, host syncs "
              f"{cfg.n_layers} a ring chunk (one per layer: whole-hop skips "
              f"decided on the host), short tail on the single-device path "
              f"{short} chunk ({ring['fallbacks']} layer calls); launches "
              f"ring {ring['launches']} single {single['launches']}")
        print(f"ring cell {name}: first-token logits max|ring - single| / "
              f"rms {[round(d, 4) for d in diffs]} (tol {RING_LOGIT_TOL}); "
              f"streams identical {same}/4 (fp32 SIMT hop: "
              f"{was['same']}/4)")
        for path in ("ring", "single"):
            dec = res[path]["decode"]
            pr = dec.profile
            sharded = (f" (sharded: {RING_N} launches a layer; "
                       "single-device decode before: "
                       f"{RING_DECODE_BEFORE[name]} ms)"
                       if path == "ring" else "")
            print(f"ring cell {name} {path}: decode step {dec.mean_ms():.3f} "
                  f"ms{sharded} (mean of {len(dec.steps)}, the card "
                  f"synchronised around each); profiled step, all 4 slots "
                  f"decoding: wall "
                  f"{pr['wall_ms']:.3f} ms, device busy {pr['busy_ms']:.3f} "
                  f"ms, paged_attention {pr['match_ms']:.3f} ms "
                  f"({pr['match_ms'] / pr['busy_ms']:.3f} of busy)")
            for ms, n, key in pr["kernels"][:5]:
                print(f"  {ms:9.3f} ms {n:6d} calls  {key}")
        for path in ("ring", "single"):
            pr = res[path]["trace"].profile
            print(f"ring cell {name} {path}: profiled chunk at "
                  f"{res[path]['trace'].profile_at} ({RING_CHUNK} tokens): "
                  f"wall {pr['wall_ms']:.1f} ms, device busy "
                  f"{pr['busy_ms']:.1f} ms "
                  f"({pr['busy_ms'] / pr['wall_ms']:.3f})")
            for ms, n, key in pr["kernels"]:
                print(f"  {ms:9.3f} ms {n:6d} calls  {key}")
        assert max(diffs) <= RING_LOGIT_TOL, diffs
        report[name] = dict(ring_ms=r_ms, single_ms=s_ms,
                            decode_ms={p: res[p]["decode"].mean_ms()
                                       for p in res}, hops_run=run,
                            hops_skipped=skipped, steps=ring["steps"],
                            logit_diff=max(diffs), same=same,
                            wall=ring["wall"])
    del params
    drop_int8_weights()
    torch.cuda.empty_cache()
    return report, total


# ---------------------------------------------------------- serve-elastic --

# Elastic serving: phi4-mini-3.8b at full width (d_model 3072, 24 heads, 8
# KV heads of 128, vocab 200064), cut to 8 of its 32 layers, random bf16
# weights from seed 0, under mesh 4x2 (4 slot-affinity shards over
# "data", KV heads over "model" in the plan; every position the one card);
# 8 slots, max_len 4096, page 16, chunk 512; 8 greedy requests of 512-2048
# prompt tokens, 24 new each; the capacity script revokes 2 positions with
# a 2-step grace at step 6 (cutover at step 8, admissions and decodes in
# flight: the mesh shrinks to 2x2, 2 shards) and restores them at step 30.
ELASTIC_ARCH = "phi4-mini-3.8b"
ELASTIC_LAYERS = 8
ELASTIC_WITNESS_LAYERS = 4        # the fp32 witness's depth
ELASTIC_MESH = (4, 2)
ELASTIC_SLOTS = 8
ELASTIC_CTX = 4096
ELASTIC_PAGE = 16
ELASTIC_CHUNK = 512
ELASTIC_PROMPTS = (512, 2048)
ELASTIC_NEW = 24
ELASTIC_SCRIPT = "revoke@6+2:2,restore@30"
ELASTIC_KEY_RMS = 3.0           # the kernel check's keys: sharp scores


def elastic_script(rounds):
    """``ELASTIC_SCRIPT`` for a run whose unfaulted twin took ``rounds``
    engine steps: as it is when the restore lands with decodes in flight,
    else the restore moved to two thirds of the run (a megastep run ends
    in ~20 rounds: K falls to 1 while prompts admit, then 8 tokens a
    round)."""
    if rounds > 34:
        return ELASTIC_SCRIPT
    return f"revoke@6+2:2,restore@{2 * rounds // 3}"


def elastic_argv(device, chaos=ELASTIC_SCRIPT, mesh=ELASTIC_MESH):
    """``launch/serve.py``'s command line of the cell (the QoS target tight
    enough that the runtime walks to the int8 rungs)."""
    argv = ["--arch", ELASTIC_ARCH, "--paged", "--dtype", "bf16",
            "--device", str(device), "--slots", str(ELASTIC_SLOTS),
            "--max-len", str(ELASTIC_CTX), "--page-size", str(ELASTIC_PAGE),
            "--prefill-chunk", str(ELASTIC_CHUNK), "--requests", "8",
            "--prompt-len", str(ELASTIC_PROMPTS[0]),
            "--prompt-len-max", str(ELASTIC_PROMPTS[1]),
            "--max-new", str(ELASTIC_NEW), "--qos-target", "0.001",
            "--decision-interval", "0", "--min-samples", "4"]
    if mesh:
        argv += ["--mesh", "x".join(map(str, mesh))]
    return argv + (["--chaos", chaos] if chaos else [])


def elastic_pool(lengths, device, int8, seed=0):
    """The cell's pool in its slot-affinity layout (``PagePool`` over
    ``spec_for(8, 4096, 16, n_shards=4)``: 3,080 pages, 770 a shard): slot
    ``s`` holds ``lengths[s]`` tokens plus its reserved decode pages on its
    own shard, the decode query at position ``lengths[s]``. Keys of rms
    ``ELASTIC_KEY_RMS`` make the scores sharp, so each output is a mix of a
    few V rows, of size ~1, and a page dropped or read twice moves it by
    about as much; every page that holds no running entry (null pages,
    reserved decode pages, free pages) is filled with K 1e3 and V -1e3,
    which must not matter. Returns (q, kp, vp, ppos, block, position,
    n_shards)."""
    import numpy as np
    import torch
    from repro_torch.models.attention import quantize_kv
    from repro_torch.serve import pages
    n_sh = ELASTIC_MESH[0]
    spec = pages.spec_for(ELASTIC_SLOTS, ELASTIC_CTX, ELASTIC_PAGE,
                          n_shards=n_sh)
    pool = pages.PagePool(spec, ELASTIC_SLOTS)
    for s, L in enumerate(lengths):
        assert pool.admit(s, list(range(1, L + 1)), "t",
                          reserve_tokens=ELASTIC_NEW) is not None
    pool.assert_consistent()
    P, G, hd = ELASTIC_PAGE, 8, 128
    ppos = np.full((spec.n_pages, P), -1, np.int32)
    for s, L in enumerate(lengths):
        for lp, pid in enumerate(pool.slot_pages[s]):
            top = min(L + 1, (lp + 1) * P)
            ppos[pid, : max(top - lp * P, 0)] = np.arange(lp * P, top)
    g = torch.Generator(device="cpu").manual_seed(seed)
    kp = torch.randn((spec.n_pages, P, G, hd), generator=g) * ELASTIC_KEY_RMS
    vp = torch.randn((spec.n_pages, P, G, hd), generator=g)
    idle = torch.from_numpy((ppos < 0).all(axis=1))
    kp[idle], vp[idle] = 1e3, -1e3
    if int8:
        kp, vp = quantize_kv(kp.clamp(-6, 6)), quantize_kv(vp.clamp(-6, 6))
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    q = torch.randn((ELASTIC_SLOTS, G, 3, hd), generator=g).to(
        torch.bfloat16)
    return [t.to(device) for t in (
        q, kp, vp, torch.tensor(ppos), torch.tensor(pool.blocks),
        torch.tensor(lengths, dtype=torch.int32))] + [n_sh]


def check_paged_sharded(device, lengths, iters=20):
    """``paged_attention`` as the sharded decode launches it at the cell's
    shape (``paged_attention_sharded``: one launch per slot-affinity shard,
    2 slots, the shard's 770 pages as a view, the block table rebased, the
    page split of the whole pool's batch) against one launch over the
    whole pool: bit for bit, in bf16 and with int8 K/V; the whole launch
    against the plain version, scaled to the outputs' size: every element
    within one bf16 step of the largest output (2^-7 max|plain|), and the
    error's norm within 2^-7 of the plain output's. Timed: the 4 launches,
    the whole launch, the plain version, beside the bound (the live pages'
    bytes)."""
    import torch
    from repro_torch.kernels import paged_attention as mod
    from repro_torch.models.attention import KV_SCALE
    rows = []
    for int8 in (False, True):
        q, kp, vp, ppos, block, pos, n_sh = elastic_pool(lengths, device,
                                                         int8)
        B, G, R, hd = q.shape
        n_pages, P = ppos.shape
        M = block.shape[1]
        chunk = n_pages // n_sh
        pps = mod.device_page_splits(device, B, G, M)
        kv = dict(kv_scale=KV_SCALE if int8 else 0.0)

        def shards():
            return mod.paged_attention_sharded(q, kp, vp, ppos, block, pos,
                                               n_sh, **kv)

        def whole():
            return mod.paged_attention(q, kp, vp, ppos, block, pos,
                                       pages_per_range=pps, **kv)
        before = mod.launches
        out = shards()
        assert mod.launches - before == n_sh, (mod.launches, before)
        ref = whole()
        assert torch.equal(out, ref), ("sharded != whole", int8,
                                       max_err(out, ref))
        plain = mod.paged_attention_plain(q, kp, vp, ppos, block, pos, **kv)
        err = max_err(ref, plain)
        scale = float(plain.float().abs().max())
        rel = float((ref.float() - plain.float()).norm()
                    / plain.float().norm())
        tol = 2 ** -7 * scale
        assert 0.5 < scale < 100 and err <= tol and rel <= 2 ** -7, \
            (int8, err, tol, rel)
        ms_sh = timed(shards, device, iters)
        ms = timed(whole, device, iters)
        plain_ms = timed(lambda: mod.paged_attention_plain(
            q, kp, vp, ppos, block, pos, **kv), device, 3)
        live, tokens = mod.live_pages(block, pos, P, 0)
        esize = kp.element_size()
        shard_bytes = mod.sharded_decode_hbm_bytes(
            live, P, G, hd, n_shards=n_sh, kv_bytes=esize, batch=B,
            n_heads=G * R, q_bytes=2, max_pages=M)
        bound, by = bound_ms(*mod.work(
            live, tokens, P, G, R, hd, kv_bytes=esize, batch=B, q_bytes=2,
            max_pages=M), BF16_FLOPS)
        name = "elastic-int8" if int8 else "elastic-bf16"
        rows.append(dict(name=name, ms=ms_sh, whole_ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bound, bound_by=by,
                         max_abs_err=err, tol=tol, rel_err=rel,
                         max_abs_plain=scale, live_pages=live,
                         pages_a_range=pps, shards=n_sh))
        print(f"paged_attention {name}: q {tuple(q.shape)}, pool "
              f"({n_pages}, {P}, {G}, {hd}) {kp.dtype}, M {M}, {live} live "
              f"pages; {n_sh} shard launches (2 slots, {chunk} pages each) "
              f"bit-equal to the whole-pool launch; ms {ms_sh:.4f} for the "
              f"{n_sh} (whole {ms:.4f}), plain_ms {plain_ms:.4f}, "
              f"library_ms null, bound_ms {bound:.5f} ({by}; a shard's "
              f"{shard_bytes / 1e6:.2f} MB, {1e3 * shard_bytes / HBM_BW:.5f}"
              f" ms), max_abs_err vs plain {err:.3g} (tol {tol:.3g} = 2^-7 "
              f"x max|plain| {scale:.3g}), error norm / plain norm "
              f"{rel:.3g} (tol {2 ** -7:.3g}), {pps} pages a range")
    return rows


def elastic_engine(cfg, params, table, device, rung, *, mesh=True, k=0,
                   dtype=None):
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, batch_slots=ELASTIC_SLOTS, max_len=ELASTIC_CTX,
                      params=params, table=table,
                      prefill_chunk=ELASTIC_CHUNK, paged=True,
                      page_size=ELASTIC_PAGE,
                      cache_dtype=dtype or torch.bfloat16, device=device,
                      megastep_k=k,
                      mesh=(make_mesh(ELASTIC_MESH, ("data", "model"),
                                      device) if mesh else None))
    eng.request_variant(rung)
    assert eng.sharded_kernel == mesh
    return eng


def elastic_run(eng, prompts, script, trace=False):
    """The driver loop of ``launch/serve.py`` on ``eng`` (the injector
    polled each step), every prompt at t=0. Returns (streams, wall s, the
    ``DecodeTrace`` or None, launches, ``paged_attention`` launches a
    sharded layer call, engine steps)."""
    import torch
    from repro_torch.dist.elastic import FaultInjector
    from repro_torch.models import attention as attn_mod
    from repro_torch.serve.engine import Request
    reqs = [Request(i, prompt=list(p), max_new=ELASTIC_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    inj = FaultInjector.parse(script) if script else None
    torch.cuda.synchronize()
    reset_launches()
    attn_mod.DISPATCH_COUNTS.clear()
    steps = 0
    t0 = time.perf_counter()
    with (DecodeTrace(eng) if trace else contextlib.nullcontext()) as dec:
        while not eng.idle:
            if inj is not None:
                for ev in inj.due(steps):
                    eng.inject(ev)
            eng.step()
            steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    counts = dict(attn_mod.DISPATCH_COUNTS)
    check_elastic(eng, reqs, script, counts)
    per_call = (launches["paged_attention"]
                / max(counts.get("kernel_sharded", 0), 1))
    return [r.out for r in reqs], wall, dec, launches, per_call, steps


def check_elastic(eng, reqs, script, counts):
    """The phase's gates: every request done and none rejected, exactly 2
    re-homes under the script (none without), the pool consistent, the
    megastep pipeline empty, decode through the sharded path only (on a
    mesh)."""
    vocab = eng.cfg.vocab_size
    assert all(r.done and len(r.out) == ELASTIC_NEW for r in reqs), \
        [(r.uid, r.done, len(r.out)) for r in reqs]
    assert not eng.rejected and all(0 <= t < vocab for r in reqs
                                    for t in r.out)
    assert eng.stats["rehomes"] == (2 if script else 0), eng.elastic_log
    eng.pool.assert_consistent()
    assert eng._inflight is None and eng._carry is None
    if eng._base_mesh is not None:
        assert counts.get("kernel_sharded", 0) > 0 and \
            counts.get("gather_mesh", 0) == 0, counts


def rehome_lines(tag, eng):
    for e in eng.elastic_log:
        if "mesh_shape" not in e:
            continue
        print(f"{tag}: re-home at step {e['step']} ({e['kind']}, revoked "
              f"{e['revoked']}): mesh -> {e['mesh_shape']} ({e['why']}), "
              f"shards {e['n_shards'][0]} -> {e['n_shards'][1]}, pages "
              f"migrated {e['pages_migrated']}, cutover_s "
              f"{e['cutover_s']:.4f}, recovery_steps {e['recovery_steps']}, "
              f"recovery_s {e.get('recovery_s', float('nan')):.4f}, graph "
              f"capture_s {e.get('capture_s', 0.0):.4f}")


def first_diff(a, b):
    """(streams equal, first differing token index of each pair)."""
    same, where = 0, []
    for x, y in zip(a, b):
        same += x == y
        where.append(next((i for i, (s, t) in enumerate(zip(x, y))
                           if s != t), None))
    return same, where


def elastic_serve(device):
    """The main path: ``launch/serve.py --paged --mesh 4x2 --chaos`` on the
    cut config, launch counters zeroed just before and read just after;
    the runtime walks to the int8 rungs under the 1 ms target and the
    capacity pressure."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn_mod
    cfg = dataclasses.replace(get_config(ELASTIC_ARCH),
                              n_layers=ELASTIC_LAYERS)
    drop_int8_weights()
    reset_launches()
    attn_mod.DISPATCH_COUNTS.clear()
    res = serve.main(elastic_argv(device), cfg=cfg)
    launches = read_launches()
    counts = dict(attn_mod.DISPATCH_COUNTS)
    eng, reqs = res["engine"], res["requests"]
    tag = f"serve-elastic {ELASTIC_ARCH} ({ELASTIC_LAYERS} layers)"
    int8_designs(tag)
    check_elastic(eng, reqs, ELASTIC_SCRIPT, counts)
    assert eng.cfg.n_layers == ELASTIC_LAYERS
    visited = {0} | {v for _, v in eng.swaps}
    assert launches["paged_attention"] > 0 and launches["ring_hop"] > 0 \
        and launches["int8_matmul"] > 0 and launches["quantize_rows"] > 0 \
        and launches["flash_attention"] == launches["ssd_scan"] == 0, \
        (launches, visited)
    print(f"{tag}: dispatch {eng.explain_dispatch()}")
    print(f"{tag}: {res['tokens']} tokens, tok_s {res['tok_s']:.2f}, p50_ms "
          f"{1e3 * res['p50_s']:.3f}, p99_ms {1e3 * res['p99_s']:.3f}, "
          f"rungs visited {sorted(visited)}, kernel_sharded layer calls "
          f"{counts.get('kernel_sharded', 0)}, gather_mesh "
          f"{counts.get('gather_mesh', 0)}, paged_attention launches "
          f"{launches['paged_attention']} "
          f"({launches['paged_attention'] / counts['kernel_sharded']:.3f} "
          f"a layer call: one a shard, 4 before the cutover, 2 after), "
          f"launches {launches}")
    rehome_lines(tag, eng)
    return res, launches


def elastic_runs(res, device):
    """Rungs precise and int8+kvq8, per step and under the megastep
    (MEGA_K), each unfaulted and under ``ELASTIC_SCRIPT`` on the main run's
    weights and prompts; on precise the single-device engine too, its
    decode step beside the sharded one's."""
    src = res["engine"]
    names = res["names"]
    prompts = [r.prompt for r in res["requests"]]
    out = {}
    for rung in ("precise", "int8+kvq8"):
        for k in (0, MEGA_K):
            runs, script = {}, ""
            for faulted in (False, True):
                drop_int8_weights()
                eng = elastic_engine(src.cfg, src.params, src.table, device,
                                     names.index(rung), k=k)
                streams, wall, dec, launches, per_call, steps = elastic_run(
                    eng, prompts, script, trace=not k and rung == "precise")
                tag = (f"serve-elastic {rung} "
                       + (f"megastep {k}" if k else "per-step")
                       + (f" faulted ({script})" if script
                          else " unfaulted"))
                graphs = (f", graphs captured {len(eng.graph_log)} "
                          f"({sum(g['capture_s'] for g in eng.graph_log):.3f}"
                          f" s)" if k else "")
                print(f"{tag}: wall {wall:.2f} s, {steps} steps, "
                      f"paged_attention {per_call:.3f} launches a sharded "
                      f"layer call{graphs}, launches {launches}")
                rehome_lines(tag, eng)
                runs[faulted] = streams
                if dec is not None and not faulted:
                    out["sharded_decode_ms"] = dec.mean_ms()
                del eng
                script = elastic_script(steps)
            same, where = first_diff(runs[False], runs[True])
            print(f"serve-elastic {rung} "
                  + (f"megastep {k}" if k else "per-step")
                  + f": bf16 faulted vs unfaulted streams equal {same}/8, "
                  f"first differing index {where} (the ring re-plans from "
                  f"4 sequence shards to 2 at the cutover)")
            out[(rung, k)] = same
    drop_int8_weights()
    eng = elastic_engine(src.cfg, src.params, src.table, device, 0,
                         mesh=False)
    single, wall, dec, _, _, _ = elastic_run(eng, prompts, "", trace=True)
    del eng
    out["single_decode_ms"] = dec.mean_ms()
    print(f"serve-elastic precise: decode step {out['sharded_decode_ms']:.3f}"
          f" ms sharded (mesh 4x2, 4 launches a layer) vs "
          f"{out['single_decode_ms']:.3f} ms single device, 8 slots, the "
          f"card synchronised around each step")
    return out


def elastic_witness(device):
    """The fp32 witness at ELASTIC_WITNESS_LAYERS layers, same width: the
    faulted run's greedy tokens equal the unfaulted run's and the
    single-device engine's, token for token."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_table
    from repro_torch.models.lm import init_lm
    cfg = dataclasses.replace(get_config(ELASTIC_ARCH),
                              n_layers=ELASTIC_WITNESS_LAYERS)
    params = init_lm(cfg, 0, torch.float32, device)
    table = serving_table(cfg, slots=ELASTIC_SLOTS, max_len=ELASTIC_CTX,
                          page_occupancy=0.4)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, int(n))))
               for n in rng.integers(ELASTIC_PROMPTS[0],
                                     ELASTIC_PROMPTS[1] + 1, ELASTIC_SLOTS)]
    streams, script = {}, ""
    for name, mesh in (("unfaulted", True), ("faulted", True),
                       ("single", False)):
        eng = elastic_engine(cfg, params, table, device, 0, mesh=mesh,
                             dtype=torch.float32)
        streams[name], wall, _, _, _, steps = elastic_run(
            eng, prompts, script if name == "faulted" else "")
        if name == "faulted":
            rehome_lines(f"serve-elastic fp32 witness ({script})", eng)
        script = elastic_script(steps)
        del eng
    same = [first_diff(streams["faulted"], streams[o])
            for o in ("unfaulted", "single")]
    print(f"serve-elastic fp32 witness ({ELASTIC_WITNESS_LAYERS} layers): "
          f"faulted vs unfaulted equal {same[0][0]}/8, vs single device "
          f"{same[1][0]}/8")
    assert streams["faulted"] == streams["unfaulted"] == streams["single"], \
        same
    del params
    torch.cuda.empty_cache()


def elastic_cell(device):
    """Phase serve-elastic. Returns (the main path's launches, the
    ``paged_attention`` rows of the sharded check)."""
    import gc

    import numpy as np
    import torch
    secs, t = {}, time.perf_counter()
    rng = np.random.default_rng(1)
    lengths = [int(n) for n in rng.integers(ELASTIC_PROMPTS[0],
                                            ELASTIC_PROMPTS[1] + 1,
                                            ELASTIC_SLOTS)]
    rows = check_paged_sharded(device, lengths)
    secs["kernels"] = round(time.perf_counter() - t, 1)
    res, launches = elastic_serve(device)
    secs["serve"] = round(time.perf_counter() - t - sum(secs.values()), 1)
    elastic_runs(res, device)
    secs["runs"] = round(time.perf_counter() - t - sum(secs.values()), 1)
    del res
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    elastic_witness(device)
    secs["witness"] = round(time.perf_counter() - t - sum(secs.values()), 1)
    print(f"serve-elastic seconds: {secs}")
    return launches, rows


# -------------------------------------------------------------- colocate --

# The colocation cell: phi4-mini-3.8b serving (bf16, 8 slots) and
# mamba2-780m training (fp32, AdamW) on the one card under one arbiter,
# through ``repro_torch.launch.colocate``. 1.0 req/s of 32-token requests
# offers 32 tok/s, ~0.75 of the per-step serve run's rate. A lower rate
# does not bring the serve-alone p99 near a decode step (it is a
# first-token gap at any rate: a 128-token prompt admits in 8 chunks of
# 16, one a step while decoders run), and the colocated runs are
# admission-bound at every rate tried (0.3-1.0: ~110-160 turns, each with
# a train step), so a lower rate only lengthens the runs.
COLO_SERVE = ["--serve-arch", "phi4-mini-3.8b", "--dtype", "bf16",
              "--slots", "8", "--max-len", "1024", "--page-size", "16",
              "--prompt-len", "128", "--max-new", "16", "--requests", "4"]
# (--requests: 12 until serve-moe was added, 6 until the train-encdec
# phase's full-depth checkpoints; --max-new 32 until the train-encdec phase
# ran over the script's time limit: cut to keep the script in it)
COLO_RATE = 1.0
# A loop turn with a train step takes ~0.3-0.4 s, so a decision every
# 0.1 s consumes the monitor's window every turn, before it holds
# ``--slots`` samples (the batch runs ~4 rows): the monitor abstains and
# the arbiter never acts. A 1 s interval (the simulator's) spans ~3 turns.
COLO_TRAIN = ["--train-arch", "mamba2-780m", "--train-groups", "8",
              "--decision-interval", "1.0"]
# the train tenant's depth: 24 of mamba2-780m's 48 layers at full width (48
# until the train-encdec phase ran over the script's time limit). Its step
# is host-bound, so it follows the depth, and each colocated turn carries
# one
COLO_TRAIN_LAYERS = 24
# The step is host-bound at ~260-380 ms on every shape from 1 x 128 to
# 2 x 512 tokens (7-11 serve decode steps), so the smallest shape that
# still trains on full sequences is kept
COLO_TRAIN_SHAPE = (1, 512)       # batch, seq
COLO_BUDGET_S = 420.0             # the four runs together: 160-220 s on
                                  # an H100, each colocated turn carrying
                                  # a 0.26-0.54 s train step


def colo_opt(flag):
    """The value of ``flag`` in the cell's harness arguments."""
    args = COLO_SERVE + COLO_TRAIN
    return args[args.index(flag) + 1]


def colocate_sizing(device, cfg, shapes, steps=4):
    """Median ms of the train tenant's training step (``cfg``, fp32, seeded
    weights) at each (batch, seq) of ``shapes`` on each rung of the ladder
    the harness builds (``max_variants=3``), twice: through the table's
    step (the rung's CUDA graph, its first step the warm-up and capture)
    and through the eager ``TrainStep`` it wraps, each over the last
    ``steps - 1`` of ``steps`` steps: what a colocated token waits for
    when a train step runs before it. Also warms the kernels and cuBLAS
    for the train tenant's shapes. Returns {shape: {"captured": {rung:
    ms}, "eager": {rung: ms}, "capture_s": {rung: s}}}; prints each rung's
    replayed step's device-busy share and largest kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.explorer import explore
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import build_variant_steps
    from repro_torch.models.lm import init_lm
    from repro_torch.train import optim
    out = {}
    for batch, seq in shapes:
        params = init_lm(cfg, 1, torch.float32, device)
        opt = optim.init_opt(params)
        table = explore(cfg, ShapeConfig("cli", seq, batch, "train"),
                        serving=False, max_variants=3)
        build_variant_steps(cfg, table, optim.OptConfig(
            lr=1e-3, warmup=5, total_steps=1000), device=device)
        src = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=0))
        rows = {"captured": {}, "eager": {}, "capture_s": {}}
        k = 0
        for i, v in enumerate(table.variants):
            graph = table.executable(i)
            for kind, step in (("captured", graph), ("eager", graph.step)):
                times = []
                for _ in range(steps):
                    tokens = torch.as_tensor(src.batch(k), device=device)
                    k += 1
                    t0 = time.perf_counter()
                    params, opt, m = step(params, opt, {"tokens": tokens})
                    float(m["loss"])
                    times.append(time.perf_counter() - t0)
                rows[kind][v.name] = 1e3 * float(np.median(times[1:]))
            rows["capture_s"][v.name] = graph.stats["capture_s"]
            # where a replayed step's device time goes
            tokens = torch.as_tensor(src.batch(k), device=device)
            k += 1
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, m = graph(params, opt, {"tokens": tokens})
                float(m["loss"])
                wall = 1e3 * (time.perf_counter() - t0)
            kern = sorted((e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and dev_us(e) > 0), key=dev_us, reverse=True)
            busy = sum(dev_us(e) for e in kern) / 1e3
            print(f"colocate sizing: {v.name} replayed step wall {wall:.1f} "
                  f"ms, device busy {busy:.1f} ms ({busy / wall:.3f}); "
                  f"largest: " + "; ".join(
                      f"{dev_us(e) / 1e3:.2f} ms {e.count} x {e.key[:48]}"
                      for e in kern[:6]))
        out[(batch, seq)] = rows
        for kind in ("eager", "captured"):
            print(f"colocate sizing: {cfg.name} ({cfg.n_layers} layers) "
                  f"train step at {batch} x {seq} tokens, {kind}, median ms "
                  f"a rung "
                  f"{ {n: round(x, 1) for n, x in rows[kind].items()} }")
        print(f"colocate sizing: graphs "
              f"{graph_line(table.executables.values())}")
        del params, opt, table
        torch.cuda.empty_cache()
    return out


def serve_alone(device, sparams, rate):
    """Run (a): the harness's engine and requests, in the harness's loop
    without the train tenant and without a runtime (no control)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import colocate
    from repro_torch.launch.serve import serving_table
    from repro_torch.launch.serve import DTYPES
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(colo_opt("--serve-arch"))
    slots, max_len = int(colo_opt("--slots")), int(colo_opt("--max-len"))
    plen, max_new = int(colo_opt("--prompt-len")), int(colo_opt("--max-new"))
    table = serving_table(cfg, slots=slots, max_len=max_len,
                          page_occupancy=min(1.0, (plen + max_new)
                                             / max_len))
    eng = ServeEngine(cfg, batch_slots=slots, max_len=max_len,
                      params=sparams, table=table, paged=True,
                      page_size=int(colo_opt("--page-size")), seed=0,
                      cache_dtype=DTYPES[colo_opt("--dtype")],
                      device=device)
    # the harness's requests and arrivals, drawn as it draws them (every
    # run's prompts are checked equal to these)
    n = int(colo_opt("--requests"))
    rng = np.random.default_rng(0)
    reqs = [Request(i, prompt=list(rng.integers(1, cfg.vocab_size, plen)),
                    max_new=max_new) for i in range(n)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    t0 = time.perf_counter()
    nxt = 0
    while not all(r.done for r in reqs):
        now = time.perf_counter() - t0
        while nxt < len(reqs) and arrivals[nxt] <= now:
            reqs[nxt].t_arrival = t0 + arrivals[nxt]
            eng.submit(reqs[nxt])
            nxt += 1
        if not eng.idle:
            eng.step()
        if eng.idle and nxt < len(reqs):
            time.sleep(max(0.0, min(arrivals[nxt]
                                    - (time.perf_counter() - t0), 0.005)))
    wall = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    return {"requests_done": sum(r.done for r in reqs), "tokens": toks,
            "wall_s": wall, "tok_per_s": toks / wall,
            "run": dict(engine=eng, requests=reqs,
                        token_latencies=colocate.token_latencies(reqs))}


def colocate_run(name, fn):
    """One run of the cell with its device memory: allocated before, the
    peak (reset first), and allocated once the run's objects are dropped,
    with the int8 weight cache and after emptying it, and the cache's drops
    and misses (quantisations) during the run. Keeps what the report
    needs: streams, prompts, every token gap, and what the harness's
    monitor was fed (each decode step's time, each admission's time from
    its first chunk to its first token)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    drops, misses = ops.weight_cache_drops, ops.weight_cache_misses
    s = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    cache = (ops.weight_cache_drops - drops,
             ops.weight_cache_misses - misses)
    run = s.pop("run")
    eng, reqs = run["engine"], run["requests"]
    ttable = run.get("train_table")
    train_steps = list(ttable.executables.values()) if ttable else []
    history = list(run["runtime"].history) if "runtime" in run else []
    keep = dict(cache=cache,
                streams={r.uid: list(map(int, r.out)) for r in reqs},
                prompts=[list(map(int, r.prompt)) for r in reqs],
                lat=np.asarray(run["token_latencies"]),
                admit=np.asarray([r.t_admit - r.t_admit_start
                                  for r in reqs]),
                steps=np.asarray(eng.step_latencies), swaps=list(eng.swaps),
                train_variants=run.get("train_variants", []),
                decisions=len(history),
                violated=sum(bool(h["violated"]) for h in history),
                # a window under the monitor's min_samples reads no p99:
                # no violation and a slack of exactly 0
                abstained=sum(not h["violated"] and h["slack"] == 0.0
                              for h in history),
                actions=[(h["action"], h["victim"]) for h in history
                         if h["action"] != "hold"],
                graphs=graph_marks(train_steps),
                graph_line=graph_line(train_steps) if ttable else "")
    del run, eng, reqs, ttable, train_steps
    gc.collect()
    after = torch.cuda.memory_allocated()
    drop_int8_weights()
    keep.update(name=name, summary=s, mem=dict(
        before=before, peak=peak, after=after,
        after_clear=torch.cuda.memory_allocated()))
    return keep


def colocate_runs(device, sparams, rate, shape):
    """The cell's runs in order: (a) serve alone, (b) precise
    colocation (``--qos-target 1000``: the arbiter never acts), (c) Pliant
    with ``--arbiter interference`` and (d) with ``--arbiter round_robin``,
    (c) and (d) at the geometric mean of (a)'s and (b)'s p99. The same
    weights, requests, arrivals and seeds in every run; the launch
    counters zeroed just before and read just after (c), and the int8
    weight cache's drops and misses around it."""
    import math

    import numpy as np
    from repro_torch.launch import colocate
    batch, seq = shape
    argv = COLO_SERVE + COLO_TRAIN + [
        "--rate", str(rate), "--train-batch", str(batch), "--train-seq",
        str(seq), "--device", str(device)]

    def harness(*extra):
        return lambda: colocate.main(argv + list(extra),
                                     serve_params=sparams)

    t0 = time.perf_counter()
    runs, out = {}, dict(rate=rate, shape=shape)
    runs["a"] = colocate_run("serve alone",
                             lambda: serve_alone(device, sparams, rate))
    runs["b"] = colocate_run("precise colocation",
                             harness("--qos-target", "1000"))
    out["target"] = math.sqrt(np.percentile(runs["a"]["lat"], 99)
                              * np.percentile(runs["b"]["lat"], 99))
    q = ["--qos-target", repr(out["target"])]
    reset_launches()
    runs["c"] = colocate_run("Pliant interference",
                             harness(*q, "--arbiter", "interference"))
    # the train graphs' replays in, their captures out (``card_launches``)
    cap, rep = runs["c"]["graphs"]
    out["launches"] = {k: n + rep.get(k, 0) - cap.get(k, 0)
                       for k, n in read_launches().items()}
    int8_designs("colocate (c)")
    runs["d"] = colocate_run("Pliant round_robin",
                             harness(*q, "--arbiter", "round_robin"))
    out["seconds"] = time.perf_counter() - t0
    out["runs"] = runs
    colocate_report(out)
    return out


def colocate_report(out):
    """One line a run: token gaps (p50, p99, violation rate at the Pliant
    target), tok/s, wall, decode steps; for the colocated runs the train
    tenant, the arbiter and what its monitor saw; device memory."""
    import numpy as np
    runs, target = out["runs"], out["target"]
    n = int(colo_opt("--requests"))
    gib = 2.0 ** 30
    print(f"colocate: rate {out['rate']} req/s, train {out['shape'][0]} x "
          f"{out['shape'][1]} tokens, QoS target of (c) and (d) "
          f"{1e3 * target:.1f} ms (geometric mean of the p99 of (a) and "
          f"(b)), four runs in {out['seconds']:.1f} s")
    for key, r in runs.items():
        s, lat, m = r["summary"], r["lat"], r["mem"]
        line = (f"colocate ({key}) {r['name']}: {s['requests_done']}/{n} "
                f"done, p50 {1e3 * np.percentile(lat, 50):.1f} ms p99 "
                f"{1e3 * np.percentile(lat, 99):.1f} ms, violation rate at "
                f"the target {float(np.mean(lat > target)):.3f}, "
                f"{s['tok_per_s']:.2f} tok/s, wall {s['wall_s']:.2f} s, "
                f"{len(r['steps'])} decode steps (median "
                f"{1e3 * np.median(r['steps']):.1f} ms, max "
                f"{1e3 * r['steps'].max():.1f}), admission to first token "
                f"median {1e3 * np.median(r['admit']):.1f} ms max "
                f"{1e3 * r['admit'].max():.1f}")
        if key != "a":
            line += (f"; train {s['train_steps']} steps, "
                     f"{s['train_skipped']} yielded turns, rungs "
                     f"{np.bincount(r['train_variants'], minlength=3).tolist()}"
                     f", mean qloss {s['train_mean_quality_loss']:.4f}, "
                     f"final loss {s['train_final_loss']:.4f}; "
                     f"{s['actions']} actions in {r['decisions']} decisions "
                     f"({r['violated']} read a violation, {r['abstained']} "
                     f"abstained), victims "
                     f"{s['victims']}, final variants serve "
                     f"{s['serve_variant']} train {s['train_variant']}, "
                     f"pool reclaimed {s['serve_reclaimed_pages']}, train "
                     f"quanta yielded {s['train_yielded_quanta']}, serve "
                     f"swaps {r['swaps']}, int8 weight cache {r['cache'][0]} "
                     f"drops {r['cache'][1]} misses")
        if r["graph_line"]:
            line += f"; train {r['graph_line']}"
        line += (f"; memory before {m['before'] / gib:.2f} GiB, peak "
                 f"{m['peak'] / gib:.2f}, after {m['after'] / gib:.2f} "
                 f"({m['after_clear'] / gib:.2f} with the int8 weight cache "
                 f"emptied)")
        print(line)
        if r["actions"]:
            print(f"colocate ({key}) actions: {r['actions'][:16]}")
    same = sum(runs["b"]["streams"][u] == runs["a"]["streams"][u]
               for u in runs["a"]["streams"])
    print(f"colocate: greedy streams of (b) equal to (a)'s: {same}/{n}")
    print(f"colocate (c) launches {out['launches']}")


def colocate_cell(device):
    """The colocation cell at full width: the train tenant's step timed per
    rung (``colocate_sizing``), then runs (a)-(d) (``colocate_runs``) and
    their checks. Returns (c)'s launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import DTYPES
    from repro_torch.models.lm import init_lm
    shape = COLO_TRAIN_SHAPE
    with depth_cut(colo_opt("--train-arch"), "colocate",
                   n_layers=COLO_TRAIN_LAYERS) as tcfg:
        sizes = colocate_sizing(device, tcfg, [shape])[shape]
        sizing = sizes["captured"]
        sparams = init_lm(get_config(colo_opt("--serve-arch")), 0,
                          DTYPES[colo_opt("--dtype")], device)
        out = colocate_runs(device, sparams, COLO_RATE, shape)
    del sparams
    drop_int8_weights()
    torch.cuda.empty_cache()
    runs, launches = out["runs"], out["launches"]
    serve_step = 1e3 * float(np.median(runs["a"]["steps"]))
    print(f"colocate: precise train step {sizing['precise']:.1f} ms = "
          f"{sizing['precise'] / serve_step:.2f} serve-alone decode steps "
          f"(median {serve_step:.1f} ms); the rungs "
          f"{ {k: round(x, 1) for k, x in sizing.items()} } ms captured, "
          f"{ {k: round(x, 1) for k, x in sizes['eager'].items()} } eager")
    n = int(colo_opt("--requests"))
    for key, r in runs.items():
        assert r["prompts"] == runs["a"]["prompts"], key
        assert r["summary"]["requests_done"] == n, (key, r["summary"])
        if key != "a":
            assert r["summary"]["train_steps"] > 0, (key, r["summary"])
    assert runs["b"]["summary"]["actions"] == 0, runs["b"]["summary"]
    for key in "cd":
        # the arbiter acts on every window that reads a violation; whether
        # any window does is the measurement: the monitor is fed decode
        # steps and admissions, not the token gaps the target is set from
        r = runs[key]
        assert r["decisions"] > 0, (key, r["summary"])
        assert r["summary"]["actions"] >= r["violated"], (key, r["actions"])
        if not r["violated"]:
            print(f"colocate ({key}): no decision read a violation: the "
                  f"monitor's samples (decode steps, median "
                  f"{1e3 * np.median(r['steps']):.1f} ms; admissions, max "
                  f"{1e3 * r['admit'].max():.1f} ms) stayed under the "
                  f"target {1e3 * out['target']:.1f} ms, or their window "
                  f"held fewer than --slots samples")
    assert launches["flash_attention"] == launches["ring_hop"] == 0, launches
    assert launches["paged_attention"] > 0 and launches["ssd_scan"] > 0 \
        and launches["ssd_scan_backward"] > 0, launches
    c = runs["c"]
    int8_served = any(v > 0 and at < len(c["steps"]) for at, v in c["swaps"])
    int8_trained = any(v > 0 for v in c["train_variants"])
    if int8_served or int8_trained:
        assert launches["int8_matmul"] > 0 and \
            launches["quantize_rows"] > 0, launches
    else:
        print("colocate (c): no int8 rung ran a step (serve swaps "
              f"{c['swaps']}, train rungs {set(c['train_variants'])}), so "
              "int8_matmul and quantize_rows launched "
              f"{launches['int8_matmul']} and {launches['quantize_rows']}")
    assert out["seconds"] < COLO_BUDGET_S, out["seconds"]
    return launches

# ------------------------------------------------------------ serve-dense --

DENSE_ARCH = "gemma2-27b"
# 4 of its 46 layers (2 local/global pairs): at 46 the bf16 weights (54.4
# GB), the int8 rungs' MLP weight cache (23.4 GB) and the rings (~18.5 GB)
# do not fit in 80 GB; 16 until serve-moe was added and 8 until the
# train-encdec phase ran over the script's time limit, cut to keep the
# script in it
DENSE_LAYERS = 4
DENSE_SLOTS = 8
DENSE_CTX = 8192              # max_len: a global layer's ring
DENSE_CHUNK = 512             # prefill chunk
DENSE_PROMPTS = (4200, 7600)  # prompt lengths, drawn uniformly: past the
DENSE_NEW = 32                # 4096 window, so every local ring wraps
DENSE_REQUESTS = 12
# first-token logits, prefill_with_cache against chunked admission (bf16
# sums in other orders over its layers): max |diff| over the rms of the
# chunked logits, the ring phase's gate
DENSE_LOGIT_TOL = 0.5
# each teacher-forced decode step's logits from the two handoffs' rings, the
# same measure: three times the first token's reading on an H100 (0.054)
DENSE_STEP_TOL = 0.15


def dense_prompts(vocab, n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = DENSE_PROMPTS
    return [list(map(int, rng.integers(1, vocab, int(length))))
            for length in rng.integers(lo, hi + 1, n)]


def n_chunks(prompts):
    return sum(-(-len(p) // DENSE_CHUNK) for p in prompts)


def dense_parity(device):
    """gemma2-27b-smoke in fp32 on the dense engine (2 slots, max_len 64,
    chunks of 8), every serving rung, four prompts, two of them past the
    32-token window so the local rings wrap: the card's greedy streams
    equal the CPU's, and equal the paged engine's on the card."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_table
    from repro_torch.models.lm import init_lm
    cfg = get_config("gemma2-27b-smoke")
    cpu_params = init_lm(cfg, 0, torch.float32, "cpu")
    dev_params = copy.deepcopy(cpu_params).to(device)
    table = serving_table(cfg, slots=2, max_len=64)
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, cfg.vocab_size, n))
               for n in (7, 36, 20, 40)]
    kw = dict(prefill_chunk=8, n_pages=32)
    for rung, v in enumerate(table.variants):
        card = engine_streams(cfg, dev_params, table, device, rung, prompts,
                              6, paged=False, **kw)
        cpu = engine_streams(cfg, cpu_params, table, torch.device("cpu"),
                             rung, prompts, 6, paged=False, **kw)
        paged = engine_streams(cfg, dev_params, table, device, rung, prompts,
                               6, **kw)
        assert card == cpu == paged, (v.name, card, cpu, paged)
        print(f"serve-dense parity {v.name}: dense {device} streams == "
              f"dense cpu streams == paged {device} streams "
              f"({sum(map(len, card))} tokens)")


def dense_serve(device):
    """The cell through ``launch/serve.py``: gemma2-27b cut to
    ``DENSE_LAYERS`` layers, bf16, the dense engine (no ``--paged``),
    ``DENSE_REQUESTS`` requests at t = 0 under a QoS target tight enough
    that the runtime swaps variants; launch counters zeroed just before and
    read just after. Returns (``serve.main``'s result, launches)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    lo, hi = DENSE_PROMPTS
    cfg = dataclasses.replace(get_config(DENSE_ARCH), n_layers=DENSE_LAYERS)
    argv = ["--dtype", "bf16", "--device", str(device),
            "--slots", str(DENSE_SLOTS), "--max-len", str(DENSE_CTX),
            "--prefill-chunk", str(DENSE_CHUNK),
            "--requests", str(DENSE_REQUESTS), "--prompt-len", str(lo),
            "--prompt-len-max", str(hi), "--max-new", str(DENSE_NEW),
            "--qos-target", "0.001", "--decision-interval", "0",
            "--min-samples", "4"]
    tag = f"serve-dense {DENSE_ARCH} ({DENSE_LAYERS} layers)"
    drop_int8_weights()
    reset_launches()
    res = serve.main(argv, cfg=cfg)
    launches = read_launches()
    int8_designs(tag)
    eng, reqs, names = res["engine"], res["requests"], res["names"]
    assert not eng.paged and eng.pool is None
    assert eng.cfg.n_layers == DENSE_LAYERS
    assert all(r.done and len(r.out) == DENSE_NEW for r in reqs), \
        [(r.uid, r.done, len(r.out)) for r in reqs]
    assert all(0 <= t < eng.cfg.vocab_size for r in reqs for t in r.out)
    assert names == ["precise", "int8", "int8+kvq8"], names
    visited = {0} | {v for _, v in eng.swaps}
    assert len(visited) > 1, eng.swaps
    assert launches["paged_attention"] == launches["flash_attention"] \
        == launches["ring_hop"] == launches["ssd_scan"] \
        == launches["ssd_scan_backward"] == 0, launches
    if visited - {0}:       # every rung past precise runs the int8 matmuls
        assert launches["int8_matmul"] > 0 and \
            launches["quantize_rows"] > 0, launches
    chunks = n_chunks([r.prompt for r in reqs])
    print(f"{tag}: {res['tokens']} tokens, tok_s={res['tok_s']:.2f} "
          f"p50_ms={1e3 * res['p50_s']:.3f} p99_ms={1e3 * res['p99_s']:.3f} "
          f"wall={res['wall_s']:.2f}s swaps={eng.swaps} admission "
          f"{1e3 * sum(eng.admit_latencies) / chunks:.2f} ms a "
          f"{DENSE_CHUNK}-token chunk ({chunks} chunks, "
          f"{len(eng.admit_latencies)} admissions), mean decode step "
          f"{1e3 * sum(eng.step_latencies) / len(eng.step_latencies):.3f} "
          f"ms ({len(eng.step_latencies)} steps), launches={launches}")
    return res, launches


def range_device_us(prof, name):
    """Device time (us) of the kernels launched inside every
    ``record_function(name)`` range of a host + device profile."""
    import torch
    total = 0.0
    for e in prof.events():
        if e.name != name or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        stack = [e]
        while stack:
            x = stack.pop()
            total += sum(k.duration for k in x.kernels)
            stack.extend(x.cpu_children)
    return total


def busy_window(eng, steps):
    """``steps`` engine steps profiled for the card's activity alone:
    (wall ms, device-busy ms) a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    busy = sum(dev_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / steps
    return wall, busy


def fn_share(eng, steps, module, fn):
    """Two profiled windows of ``steps`` engine steps: the card's activity
    alone (wall and device busy a step, its busy share), then host and
    card with every call of ``module.<fn>`` in a ``record_function`` range
    of that name (the function's share of the device time). Returns (wall
    ms, busy ms, share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    wall, busy = busy_window(eng, steps)
    orig = getattr(module, fn)

    def ranged(*a, **kw):
        with record_function(fn):
            return orig(*a, **kw)
    setattr(module, fn, ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
    finally:
        setattr(module, fn, orig)
    total = sum(dev_us(e) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.key != fn)
    share = range_device_us(prof, fn)
    assert 0 < share < total, (fn, share, total)
    return wall, busy, share / total


def dense_walk(res, device, decode_steps=8, prof_steps=4):
    """``request_variant`` walk over the ladder on the cell's weights: on
    each rung the dense engine, then the paged engine (page 16, every
    admission in one step), serve the same ``DENSE_SLOTS`` prompts. Each
    reports admission ms a chunk, the mean decode step over
    ``decode_steps`` steps with every slot live, and a profiled window's
    busy share and decode attention's share of the device time (dense:
    ``decode_attention``, ``_sdpa`` over the rings; paged:
    ``paged_decode_attention``, the ``paged_attention`` kernel). The dense
    decode step makes no host sync."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    src = res["engine"]
    prompts = dense_prompts(src.cfg.vocab_size, DENSE_SLOTS, seed=11)
    chunks = n_chunks(prompts)
    for rung, name in enumerate(res["names"]):
        for paged in (False, True):
            drop_int8_weights()
            eng = ServeEngine(src.cfg, batch_slots=DENSE_SLOTS,
                              max_len=DENSE_CTX, params=src.params,
                              table=src.table, prefill_chunk=DENSE_CHUNK,
                              paged=paged, page_size=16,
                              max_admission_chunks=chunks,
                              cache_dtype=src.cache_dtype, device=device)
            eng.request_variant(rung)
            for i, p in enumerate(prompts):
                eng.submit(Request(i, prompt=p, max_new=2 * prof_steps
                                   + decode_steps + 4))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while not all(s is not None for s in eng.slots):
                eng.step()
            torch.cuda.synchronize()
            admit = (sum(eng.admit_latencies) if not paged
                     else time.perf_counter() - t0)
            eng.step()
            n0 = len(eng.step_latencies)
            for _ in range(decode_steps):
                eng.step()
            step = 1e3 * sum(eng.step_latencies[n0:]) / decode_steps
            wall, busy, share = fn_share(
                eng, prof_steps, attn_mod,
                "paged_decode_attention" if paged else "decode_attention")
            kind = "paged" if paged else "dense"
            syncs = ""
            if not paged:
                toks = torch.tensor(eng.cur_tokens, dtype=torch.long,
                                    device=device)[:, None]
                pos = torch.tensor(eng.positions, device=device)
                n = host_syncs(lambda: lm.decode_step(
                    eng.params, toks, pos, eng.caches, eng.cfg,
                    eng.active_knobs))
                assert n == 0, n
                syncs = ", host syncs in a decode step 0"
            print(f"serve-dense walk {name} {kind}: admission "
                  f"{1e3 * admit / chunks:.2f} ms a {DENSE_CHUNK}-token "
                  f"chunk ({chunks} chunks), mean decode step {step:.3f} "
                  f"ms ({DENSE_SLOTS} slots, {decode_steps} steps); "
                  f"profiled {prof_steps} steps: wall {wall:.3f} ms, busy "
                  f"{busy:.3f} ms ({busy / wall:.3f}), decode attention "
                  f"{share:.3f} of the device time{syncs}")
            del eng
            torch.cuda.empty_cache()


def ring_order(caches, length):
    """Each dense ring after ``length`` tokens holds positions
    ``[length - n, length)``, ``n = min(length, W)``, once each, the other
    slots empty, and its cursor names the slot written next: the oldest
    entry of a full ring, an empty slot otherwise. Asserted exactly;
    returns each stacked cache's slot order by position (the empty slots
    first) with its count of empty slots, so two handoffs' K/V can be
    compared entry by entry."""
    import torch
    order = []
    for c in caches:            # pos (groups, B, W); cursor (groups,), mod W
        W = c.pos.shape[-1]
        n = min(length, W)
        got, idx = c.pos.long().sort(-1)
        want = torch.arange(length - n, length, device=got.device)
        assert (got[..., :W - n] == -1).all(), (length, W)
        assert torch.equal(got[..., W - n:], want.expand_as(got[..., W - n:])), \
            (length, W, got[..., W - n:W - n + 4], got[..., -4:])
        cur = (c.cursor.long() % W).view(-1, 1, 1).expand(
            *c.pos.shape[:-1], 1)
        at = c.pos.long().gather(-1, cur)
        assert (at == (length - W if n == W else -1)).all(), \
            (length, W, c.cursor, at)
        order.append((idx, W - n))
    return order


def ring_kv_err(caches_a, caches_b, length):
    """max |a - b| over the rms of b, over every ring entry of two
    handoffs' caches at the same positions (``ring_order`` asserted on
    both)."""
    worst = 0.0
    for a, b, (ia, skip), (ib, _) in zip(caches_a, caches_b,
                                         ring_order(caches_a, length),
                                         ring_order(caches_b, length)):
        for x, y in ((a.k, b.k), (a.v, b.v)):
            shape = ia.shape + x.shape[3:]
            xa = x.gather(2, ia.view(*ia.shape, 1, 1).expand(shape))
            yb = y.gather(2, ib.view(*ib.shape, 1, 1).expand(shape))
            xa, yb = xa[:, :, skip:].float(), yb[:, :, skip:].float()
            worst = max(worst, float((xa - yb).abs().max()
                                     / yb.pow(2).mean().sqrt()))
    return worst


def dense_handoff(res, device):
    """``prefill_with_cache`` on one prompt of ``DENSE_PROMPTS[1]`` tokens
    at the cell's width (bf16, precise): its attention through
    ``ops.flash`` (one ``flash_attention`` launch a layer, all of design
    tc, each timed by CUDA events around the call), its first-token logits
    against chunked
    admission's (``_chunked_prefill``, chunks of ``DENSE_CHUNK``) within
    ``DENSE_LOGIT_TOL`` of their rms. The rings each hands to decode hold
    the same positions in ``ring_order`` and the same K/V within
    ``DENSE_LOGIT_TOL`` of their rms; then ``DENSE_NEW`` decode steps
    teacher-forced with chunked admission's greedy tokens through both,
    each step's logits within ``DENSE_STEP_TOL`` of their rms, and the
    rings in ``ring_order`` again after the last."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.serve import prefill as prefill_mod
    from repro_torch.serve.engine import ServeEngine
    src = res["engine"]
    cfg, params = src.cfg, src.params
    drop_int8_weights()
    S = DENSE_PROMPTS[1]
    prompt = list(map(int, np.random.default_rng(13).integers(
        1, cfg.vocab_size, S)))
    calls, flash = [], kops.flash

    def timed_flash(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        o = flash(*a, **kw)
        ev[1].record()
        calls.append((ev, kw.get("window", 0)))
        return o
    reset_launches()
    kops.flash = timed_flash
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_pf, caches_pf = prefill_mod.prefill_with_cache(
            params, torch.tensor([prompt], device=device), cfg, DENSE_CTX)
        torch.cuda.synchronize()
        pf_s = time.perf_counter() - t0
    finally:
        kops.flash = flash
    launches = read_launches()
    designs = {k: n for k, n in fa.design_launches.items() if n}
    assert launches["flash_attention"] == cfg.n_layers == len(calls), \
        (launches, len(calls))
    assert designs == {"tc": cfg.n_layers}, designs
    ms = [(w, a.elapsed_time(b)) for (a, b), w in calls]
    eng = ServeEngine(cfg, batch_slots=1, max_len=DENSE_CTX, params=params,
                      prefill_chunk=DENSE_CHUNK, cache_dtype=src.cache_dtype,
                      device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_ck, caches_ck = eng._chunked_prefill(prompt)
    torch.cuda.synchronize()
    ck_s = time.perf_counter() - t0

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.pow(2).mean().sqrt())
    gate = rel(logits_pf, logits_ck)
    assert gate <= DENSE_LOGIT_TOL, gate
    kv_err = ring_kv_err(caches_pf, caches_ck, S)
    assert kv_err <= DENSE_LOGIT_TOL, kv_err
    steps, same = [], 0
    cur = logits_ck.argmax(-1)
    pos = torch.full((1,), S, dtype=torch.int32, device=device)
    for _ in range(DENSE_NEW):
        same += int(logits_pf.argmax(-1) == cur)
        logits_pf, caches_pf = lm.decode_step(params, cur[:, None], pos,
                                              caches_pf, cfg)
        logits_ck, caches_ck = lm.decode_step(params, cur[:, None], pos,
                                              caches_ck, cfg)
        assert torch.isfinite(logits_pf).all()
        steps.append(rel(logits_pf, logits_ck))
        cur = logits_ck.argmax(-1)
        assert 0 <= int(cur) < cfg.vocab_size
        pos += 1
    assert max(steps) <= DENSE_STEP_TOL, steps
    kv_after = ring_kv_err(caches_pf, caches_ck, S + DENSE_NEW)
    assert kv_after <= DENSE_LOGIT_TOL, kv_after
    print(f"serve-dense prefill_with_cache: {S} tokens in {1e3 * pf_s:.1f} "
          f"ms (at 16 layers 614.6 ms through bf16 flash \"simple\", "
          f"265.0 through tc, on an H100 80GB HBM3 at 700 W; chunked "
          f"admission "
          f"{1e3 * ck_s:.1f} ms), flash_attention "
          f"launches {launches['flash_attention']} by design {designs}; "
          f"first-token logits max |diff| {gate:.4f} of their rms (tol "
          f"{DENSE_LOGIT_TOL}); rings hold the same positions, cursors at "
          f"the next slot, K/V max |diff| {kv_err:.4f} of their rms "
          f"({kv_after:.4f} after {DENSE_NEW} steps); {DENSE_NEW} "
          f"teacher-forced decode steps: logits max |diff| worst "
          f"{max(steps):.4f} of their rms (tol {DENSE_STEP_TOL}), mean "
          f"{sum(steps) / len(steps):.4f}; greedy tokens equal "
          f"{same}/{DENSE_NEW}")
    for kind in sorted({w for w, _ in ms}):
        each = [t for w, t in ms if w == kind]
        print(f"serve-dense prefill_with_cache flash_attention "
              f"{'window ' + str(kind) if kind else 'causal'}: "
              f"{len(each)} calls, ms {[round(t, 3) for t in each]}")


def gemma2_flash_cases():
    """``flash_attention`` at the cell's ``prefill_with_cache`` shape: one
    prompt of ``DENSE_PROMPTS[1]`` tokens, gemma2-27b's heads, bf16,
    softcap 50, causal (global layers) and window 4096 (local layers),
    causal without the softcap (the function the library column computes),
    and causal with q scaled by 16 so that the softcap bites (scores of
    ~16 rms against cap 50; at unit scale cap tanh(s / cap) ~ s)."""
    import torch
    S = DENSE_PROMPTS[1]
    shape = (1, 32, 16, S, S, 128)
    return [dict(name="gemma2-global-bf16", shape=shape,
                 dtype=torch.bfloat16, cap=50.0, design="tc"),
            dict(name="gemma2-local-bf16", shape=shape, dtype=torch.bfloat16,
                 window=4096, cap=50.0, design="tc"),
            # the same function as the library column's
            dict(name="gemma2-global-bf16-nocap", shape=shape,
                 dtype=torch.bfloat16, design="tc"),
            dict(name="gemma2-global-bf16-q16", shape=shape,
                 dtype=torch.bfloat16, cap=50.0, q_scale=16.0, design="tc")]


def flash_cudnn(device, cases, iters=5):
    """``check_flash`` at ``cases`` (causal or windowed), then the same
    shapes through ``scaled_dot_product_attention`` without a softcap (no
    single library call computes one): the library column, with the
    backend PyTorch picks and with cuDNN's forced (None where cuDNN refuses
    the call). Each case's inputs are drawn once for both. Returns
    ``check_flash``'s rows, each with ``cudnn_ms``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rows = []
    for c in cases:
        B, H, KVH, Sq, Skv, hd = c["shape"]
        q, k, v = flash_case(B, H, KVH, Sq, Skv, hd, c["dtype"], device,
                             q_scale=c.get("q_scale", 1.0))
        r, = check_flash(device, [dict(c, qkv=(q, k, v))], iters=iters)
        rows.append(r)
        r["cudnn_ms"] = None
        if "q_scale" in c:           # the unscaled case's library column
            continue
        kw = (dict(attn_mask=flash_kept(Sq, Skv, dict(
            causal=True, window=c["window"], kv_keep_stride=1), device))
              if c.get("window") else dict(is_causal=True))

        def lib_call():
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)
        lib, cudnn = timed(lib_call, device, iters), None
        try:
            with sdpa_kernel(SDPBackend.CUDNN_ATTENTION):
                cudnn = timed(lib_call, device, iters)
        except RuntimeError as e:
            print(f"flash_attention {c['name']}: cuDNN refuses: "
                  f"{str(e).splitlines()[0][:160]}")
        r["cudnn_ms"] = cudnn
        print(f"flash_attention {c['name']}: scaled_dot_product_attention "
              f"without the softcap {lib:.4f} ms (cuDNN forced: "
              f"{'null' if cudnn is None else f'{cudnn:.4f} ms'}), kernel "
              f"{r['ms']:.4f} ms ({r['ms'] / lib:.2f}x)")
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def dense_cell(device):
    """Phase ``serve-dense``: parity, the cell's serve run, the rung walk,
    the ``prefill_with_cache`` handoff and ``flash_attention`` at its
    shape; device memory before, at peak and after. Returns the serve
    run's launches."""
    import gc

    import torch
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, t = {}, time.perf_counter()

    def done(name):
        nonlocal t
        secs[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
    dense_parity(device)
    done("parity")
    res, launches = dense_serve(device)
    done("serve")
    dense_walk(res, device)
    done("walk")
    dense_handoff(res, device)
    done("handoff")
    del res                  # the engine and its runtime hold a cycle
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    flash_cudnn(device, gemma2_flash_cases())
    gc.collect()
    torch.cuda.empty_cache()
    done("flash")
    print(f"serve-dense seconds: {secs}")
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    print(f"serve-dense memory: before {before / 2 ** 30:.2f} GiB, peak "
          f"{peak / 2 ** 30:.2f} GiB, after {after / 2 ** 30:.2f} GiB")
    return launches


# ----------------------------------------------------------- serve-gemma3 --

GEMMA3_ARCH = "gemma3-12b"
# 6 of its 48 layers: one 5:1 period, five local layers (window 1024) and
# one global, at full width (16 heads of 256 over 8 KV heads); cut to keep
# the phase in ~30 s of the script's time limit
GEMMA3_LAYERS = 6
GEMMA3_LEN = 8192             # prefill_with_cache's prompt, and max_len
GEMMA3_CHUNK = 512            # chunked admission's chunk


def gemma3_flash_cases():
    """``flash_attention`` at the handoff's shapes: gemma3-12b's heads over
    one ``GEMMA3_LEN``-token prompt in bf16, causal (the global layer) and
    window 1024 (the local ones); gemma3 has no softcap."""
    import torch
    shape = (1, 16, 8, GEMMA3_LEN, GEMMA3_LEN, 256)
    return [dict(name="gemma3-global-bf16", shape=shape,
                 dtype=torch.bfloat16, design="tc"),
            dict(name="gemma3-local-bf16", shape=shape, dtype=torch.bfloat16,
                 window=1024, design="tc")]


def gemma3_handoff(device):
    """gemma3-12b cut to ``GEMMA3_LAYERS`` layers at full width, bf16,
    random weights from seed 0: ``prefill_with_cache`` on one prompt of
    ``GEMMA3_LEN`` tokens, its attention through ``ops.flash`` (one
    ``flash_attention`` launch a layer, all of design tc, none simple, each
    timed by CUDA events around the call), launch counters zeroed just
    before and read just after; its first-token logits against chunked
    admission's (``_chunked_prefill``, chunks of ``GEMMA3_CHUNK``) within
    ``DENSE_LOGIT_TOL`` of their rms, and the rings each hands to decode
    within the same of theirs. Returns the launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import prefill as prefill_mod
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config(GEMMA3_ARCH),
                              n_layers=GEMMA3_LAYERS)
    t0 = time.perf_counter()
    params = init_lm(cfg, 0, torch.bfloat16, device)
    S = GEMMA3_LEN
    prompt = list(map(int, np.random.default_rng(13).integers(
        1, cfg.vocab_size, S)))
    calls, flash = [], kops.flash

    def timed_flash(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        o = flash(*a, **kw)
        ev[1].record()
        calls.append((ev, kw.get("window", 0)))
        return o
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_launches()
    kops.flash = timed_flash
    try:
        t0 = time.perf_counter()
        logits_pf, caches_pf = prefill_mod.prefill_with_cache(
            params, torch.tensor([prompt], device=device), cfg, S)
        torch.cuda.synchronize()
        pf_s = time.perf_counter() - t0
    finally:
        kops.flash = flash
    launches = read_launches()
    designs = {k: n for k, n in fa.design_launches.items() if n}
    assert launches["flash_attention"] == cfg.n_layers == len(calls), \
        (launches, len(calls))
    assert designs == {"tc": cfg.n_layers}, designs
    assert torch.isfinite(logits_pf).all()
    assert logits_pf.shape == (1, cfg.vocab_size), logits_pf.shape
    ms = [(w, a.elapsed_time(b)) for (a, b), w in calls]
    eng = ServeEngine(cfg, batch_slots=1, max_len=S, params=params,
                      prefill_chunk=GEMMA3_CHUNK, cache_dtype=torch.bfloat16,
                      device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_ck, caches_ck = eng._chunked_prefill(prompt)
    torch.cuda.synchronize()
    ck_s = time.perf_counter() - t0
    a, b = logits_pf.float(), logits_ck.float()
    gate = float((a - b).abs().max() / b.pow(2).mean().sqrt())
    assert gate <= DENSE_LOGIT_TOL, gate
    kv_err = ring_kv_err(caches_pf, caches_ck, S)
    assert kv_err <= DENSE_LOGIT_TOL, kv_err
    print(f"serve-gemma3 {GEMMA3_ARCH} ({GEMMA3_LAYERS} layers) "
          f"prefill_with_cache: {S} tokens in {1e3 * pf_s:.1f} ms (init "
          f"{init_s:.1f} s; chunked admission {1e3 * ck_s:.1f} ms), "
          f"launches {launches}, flash_attention by design {designs}; "
          f"first-token logits max |diff| {gate:.4f} of their rms (tol "
          f"{DENSE_LOGIT_TOL}); rings hold the same positions, K/V max "
          f"|diff| {kv_err:.4f} of their rms; greedy first tokens equal "
          f"{int(logits_pf.argmax(-1) == logits_ck.argmax(-1))}")
    for kind in sorted({w for w, _ in ms}):
        each = [t for w, t in ms if w == kind]
        print(f"serve-gemma3 prefill_with_cache flash_attention "
              f"{'window ' + str(kind) if kind else 'causal'}: "
              f"{len(each)} calls, ms {[round(t, 4) for t in each]}")
    return launches


def gemma3_cell(device):
    """Phase ``serve-gemma3``: ``flash_attention`` at gemma3-12b's prefill
    shapes (with cuDNN's time beside it), then the ``prefill_with_cache``
    handoff; device memory before, at peak and after. Returns the
    handoff's launches and the flash rows."""
    import gc

    import torch
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    rows = flash_cudnn(device, gemma3_flash_cases())
    flash_s = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    launches = gemma3_handoff(device)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve-gemma3 seconds: flash {flash_s:.1f}, handoff "
          f"{time.perf_counter() - t - flash_s:.1f}")
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    print(f"serve-gemma3 memory: before {before / 2 ** 30:.2f} GiB, peak "
          f"{peak / 2 ** 30:.2f} GiB, after {after / 2 ** 30:.2f} GiB")
    return launches, rows


# -------------------------------------------------------------- serve-ssm --

SSM_ARCH = "zamba2-2.7b"      # full width; 54 layers at full depth
# 24 of its 54 layers (4 periods: 20 Mamba2 blocks and 4 calls of the
# shared attention block; 54 until the train-encdec phase ran over the
# script's time limit). Admission and decode are host-bound, so the cell's
# time follows the depth; at 24 the serve run's snapshots (358 of 25.6 MiB)
# still pass the engine's 8 GiB snapshot budget, so the prefix index evicts
SSM_LAYERS = 24
SSM_SLOTS = 8
SSM_CTX = 4096                # max_len
SSM_PAGE = 16
SSM_CHUNK = 128               # prefill chunk
SSM_PROMPTS = (512, 3072)     # prompt lengths, drawn uniformly
SSM_NEW = 32
SSM_REQUESTS = 6               # 12 until serve-moe was added: cut to keep
                              # the whole script under 1100 s
# the walk's, the megastep's and the prefix hit's prompts: admission is
# host-bound (~100-150 ms a chunk at this depth on an H100) and pauses
# at every registered 16-token boundary, so they are short
SSM_WALK_LEN = 32             # 64 until serve-moe was added
SSM_MEGA_LEN = 64
SSM_PREFIX_LEN = 256
SSM_HANDOFF_LEN = 2048        # prefill_with_cache's prompt
# first-token logits, prefill_with_cache against chunked admission (bf16
# sums in other orders and other chunkings over its layers): max |diff| over
# the rms of the chunked logits, as the serve-dense phase's gate
SSM_LOGIT_TOL = 0.5
# the Mamba states the two handoffs give decode, relative Frobenius norm of
# the worst layer: in bf16 (0.049 on an H100 80GB, 700 W), and on the same
# weights in fp32, where only fp32 sums in other orders part them, also the
# worst head (1.6e-5 and 2.7e-5 there); and the fp32 first-token logits,
# max |diff| over their rms (4.5e-5 there)
SSM_STATE_BF16 = 0.1
# the serve run's device peak: bf16 weights 5.0 GiB, the int8 weights, the
# page pool (2,305 pages) 3.2 GiB, 8 slots' Mamba rows 0.5 GiB and the
# activations of 16-token chunks: 14.8 GiB on an H100 (54.0 GiB with the
# snapshots on the card)
SSM_PEAK_GIB = 20.0
SSM_STATE_FP32 = 1e-4
SSM_LOGIT_FP32 = 1e-3


def jax_chunk(S, chunk=128):
    """The JAX package's ``mamba_prefill`` chunk: the largest divisor of S
    that is at most ``chunk``."""
    q = min(chunk, S)
    while S % q:
        q -= 1
    return q


def ssd_state_cases():
    """(B, S, H, P, N) of ``ssd_scan`` with a state in and out on the
    serve-ssm path: zamba2-2.7b's admission chunk (H 80, P 64, N 64) of 128
    tokens, the 16 tokens between two registered boundaries (most of the
    paged engine's chunks), a ragged 44 (one chunk of 44) and 45 (padded
    to 48), and its ``prefill_with_cache`` at ``SSM_HANDOFF_LEN`` tokens;
    mamba2-780m's (H 48, P 64, N 128) chunk of 128 and ragged 44 and
    45."""
    return [(1, 128, 80, 64, 64), (1, SSM_PAGE, 80, 64, 64),
            (1, 44, 80, 64, 64), (1, 45, 80, 64, 64),
            (1, SSM_HANDOFF_LEN, 80, 64, 64), (1, 128, 48, 64, 128),
            (1, 44, 48, 64, 128), (1, 45, 48, 64, 128)]


def ssd_state_bound_ms(B, S, H, P, N, Q, esize):
    """``ssd_scan.work_state`` (S real tokens at chunk Q, the state in and
    out) at the fp32 peak."""
    from repro_torch.kernels import ssd_scan
    return bound_ms(*ssd_scan.work_state(B, S, H, P, N, Q, esize),
                    FP32_FLOPS)


def check_ssd_state(device, cases, iters=10):
    """``ssd_scan_state`` (the kernels with a state in and out, the
    sequence padded to the kernels' chunks) on the card against the plain
    version unpadded at the JAX package's chunk (``jax_chunk``), from the
    same initial state, fp32 and bf16: y within ``check_ssd``'s tolerances,
    the final state within 1e-5 x sqrt(chunks) of its largest entry (fp32
    sums in other orders and other chunkings, from the same exactly upcast
    inputs). Times
    the kernel path beside the plain version and the bound."""
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_scan as mod
    rows = []
    for B, S, H, P, N in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, b, c = ssd_case(B, S, H, P, N, dtype, device)
            init = torch.tensor(np.random.default_rng(1).normal(
                size=(B, H, P, N)), dtype=torch.float32, device=device)
            n0 = mod.launches
            y, st = mod.ssd_scan_state(x, dt, a, b, c, chunk=SSM_CHUNK,
                                       init_state=init)
            assert mod.launches - n0 == mod.FWD_PASSES
            q = jax_chunk(S, SSM_CHUNK)
            yr, sr = mod.ssd_scan_plain(x, dt, a, b, c, chunk=q,
                                        init_state=init, return_state=True)
            torch.cuda.synchronize()
            scale = float(yr.float().abs().max())
            tol = (1e-5 if dtype == torch.float32 else 2 ** -8) * scale
            err = max_err(y, yr)
            # each chunk's carried state adds its own rounding: the
            # errors add like a random walk over the chunks
            s_tol = 1e-5 * (-(-S // q)) ** 0.5 * float(sr.abs().max())
            s_err = max_err(st, sr)
            assert torch.isfinite(y).all() and err <= tol, \
                (B, S, H, P, N, dtype, err, tol)
            assert torch.isfinite(st).all() and s_err <= s_tol, \
                (B, S, H, P, N, dtype, s_err, s_tol)
            kern = timed(lambda: mod.ssd_scan_state(
                x, dt, a, b, c, chunk=SSM_CHUNK, init_state=init), device,
                iters)
            plain = timed(lambda: mod.ssd_scan_plain(
                x, dt, a, b, c, chunk=q, init_state=init,
                return_state=True), device, iters)
            Q, S_pad = mod.state_chunk(S, SSM_CHUNK)
            bound, by = ssd_state_bound_ms(B, S, H, P, N, Q,
                                           x.element_size())
            name = "fp32" if dtype == torch.float32 else "bf16"
            rows.append(dict(shape=(B, S, H, P, N), dtype=name,
                             max_abs_err=err, state_err=s_err, ms=kern,
                             plain_ms=plain, library_ms=None,
                             bound_ms=bound, bound_by=by))
            print(f"ssd_scan state {name} B={B} S={S} H={H} P={P} N={N} "
                  f"(kernel Q={Q}, {S_pad - S} padded; plain Q={q}): "
                  f"max_abs_err={err:.3g} (tol {tol:.3g}) state "
                  f"max_abs_err={s_err:.3g} (tol {s_tol:.3g}) ms={kern:.4f} "
                  f"plain_ms={plain:.4f} library_ms=null "
                  f"bound_ms={bound:.5f} ({by})")
    return rows


def zamba2_flash_cases():
    """``flash_attention`` at the handoff's shape: zamba2-2.7b's shared
    attention (MHA, 32 heads of 80) over one ``SSM_HANDOFF_LEN``-token
    prompt, causal, in bf16 ("tc") and fp32 ("tiled", the witness's
    dtype)."""
    import torch
    shape = (1, 32, 32, SSM_HANDOFF_LEN, SSM_HANDOFF_LEN, 80)
    return [dict(name="zamba2-handoff-bf16", shape=shape,
                 dtype=torch.bfloat16, design="tc"),
            dict(name="zamba2-handoff-fp32", shape=shape,
                 dtype=torch.float32, design="tiled")]


def zamba2_paged_cases():
    """``paged_attention`` at zamba2-2.7b's shared-attention decode on the
    cell: MHA (G 32, R 1), hd 80, page 16, M 256 of a 4096-token max_len,
    6 ragged live slots up to the longest prompt and its new tokens plus
    the two inactive rows (8 slots), bf16 and int8 K/V."""
    import torch
    base = dict(G=32, R=1, hd=80, P=SSM_PAGE, M=SSM_CTX // SSM_PAGE,
                lengths=[15, 16, 17, 700, 2047, SSM_PROMPTS[1] + SSM_NEW - 1],
                dtype=torch.bfloat16, blind=True)
    return [dict(base, name="zamba2-bf16", int8=False),
            dict(base, name="zamba2-int8", int8=True)]


ZAMBA2_PRODUCTS = ((2560, 5120), (5120, 2560), (2560, 10240), (10240, 2560))


def zamba2_int8_shapes():
    """zamba2-2.7b's int8 products on the serve-ssm path: a Mamba layer's
    ``in_z`` and ``in_x`` (K 2560 -> N 5120) and ``out_proj`` (5120 ->
    2560), the shared block's MLP (2560 -> 10240, 10240 -> 2560), at
    decode (M 8), the paged engine's 16-token chunks and the dense
    engine's 128-token ones."""
    return [(m, k, n) for m in (SSM_SLOTS, SSM_PAGE, SSM_CHUNK)
            for k, n in ZAMBA2_PRODUCTS]


def zamba2_quantize_shapes():
    """What zamba2-2.7b's int8 rungs quantise on that path, bf16: the
    products' activations (8, 16 and 128 rows of 2560, 5120 and 10240)
    and their weights as rows of ``w.t()``."""
    import torch
    acts = [(m, k, torch.bfloat16) for m in (SSM_SLOTS, SSM_PAGE, SSM_CHUNK)
            for k in (2560, 5120, 10240)]
    return acts + [(n, k, torch.bfloat16) for k, n in ZAMBA2_PRODUCTS]


def ssm_parity(device):
    """zamba2-2.7b-smoke and mamba2-780m-smoke in fp32 on every serving
    rung, prompts sharing an 8-token prefix (later ones restore its SSM
    snapshot on the paged engine): the greedy streams of the dense engine,
    the paged engine and the paged engine under a 4-step megastep (a
    replayed CUDA graph of the decode step) on the card all equal the
    CPU's dense engine's."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_table
    from repro_torch.models.lm import init_lm
    for arch in ("zamba2-2.7b-smoke", "mamba2-780m-smoke"):
        cfg = get_config(arch)
        cpu_params = init_lm(cfg, 0, torch.float32, "cpu")
        dev_params = copy.deepcopy(cpu_params).to(device)
        table = serving_table(cfg, slots=2, max_len=64)
        rng = np.random.default_rng(3)
        prefix = list(rng.integers(1, cfg.vocab_size, 8))
        prompts = [prefix + list(rng.integers(1, cfg.vocab_size, n))
                   for n in (3, 9, 5, 13)]
        for rung, v in enumerate(table.variants):
            cpu = engine_streams(cfg, cpu_params, table, torch.device("cpu"),
                                 rung, prompts, 6, paged=False)
            runs = {kind: engine_streams(cfg, dev_params, table, device,
                                         rung, prompts, 6, **kw)
                    for kind, kw in (("dense", dict(paged=False)),
                                     ("paged", {}),
                                     ("megastep", dict(megastep_k=4)))}
            assert all(r == cpu for r in runs.values()), (arch, v.name, cpu,
                                                          runs)
            print(f"serve-ssm parity {arch} {v.name}: {device} dense == "
                  f"paged == megastep 4 == cpu dense streams "
                  f"({sum(map(len, cpu))} tokens)")


def host_rss_gib():
    """The process's resident host memory (pinned pages included)."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f
                  if line.startswith("VmRSS:"))
    return kb / 2 ** 20


def ssm_prompts(vocab, n, seed, length=None):
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = SSM_PROMPTS
    lengths = [length] * n if length else rng.integers(lo, hi + 1, n)
    return [list(map(int, rng.integers(1, vocab, int(k)))) for k in lengths]


def ssm_chunks(eng):
    """Admission chunks the paged engine has run: its chunk budget's
    spend."""
    return sum(used for used, _ in eng.step_admission_chunks)


def ssm_serve(device):
    """The cell through ``launch/serve.py``: zamba2-2.7b at full width,
    ``SSM_LAYERS`` layers, bf16, the paged engine, ``SSM_REQUESTS`` requests at t = 0
    under a QoS target tight enough that the runtime swaps variants;
    launch counters zeroed just before and read just after: every
    admission chunk launches ``ssd_scan`` (``FWD_PASSES`` a Mamba layer),
    decode ``paged_attention`` (the shared-attention layers) and an int8
    rung ``int8_matmul``. The prompts register more SSM snapshots (60 MB a
    16-token boundary) than the engine's ``snapshot_budget`` holds: the
    prefix index evicts to stay under it, and the snapshots, held in
    pinned host memory, leave the card's peak at the engine's own tensors
    (below ``SSM_PEAK_GIB``). Returns (``serve.main``'s result,
    launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models.mamba2 import MambaCache
    lo, hi = SSM_PROMPTS
    argv = ["--arch", SSM_ARCH, "--paged", "--dtype", "bf16",
            "--device", str(device), "--slots", str(SSM_SLOTS),
            "--max-len", str(SSM_CTX), "--page-size", str(SSM_PAGE),
            "--prefill-chunk", str(SSM_CHUNK),
            "--requests", str(SSM_REQUESTS), "--prompt-len", str(lo),
            "--prompt-len-max", str(hi), "--max-new", str(SSM_NEW),
            "--qos-target", "0.001", "--decision-interval", "0",
            "--min-samples", "4"]
    tag = f"serve-ssm {SSM_ARCH} ({SSM_LAYERS} layers)"
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_LAYERS)
    drop_int8_weights()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss0 = host_rss_gib()
    reset_launches()
    res = serve.main(argv, cfg=cfg)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    int8_designs(tag)
    eng, reqs, names = res["engine"], res["requests"], res["names"]
    cfg = eng.cfg
    n_mamba = sum(k == MAMBA for k in cfg.kinds())
    assert eng.paged and cfg.n_layers == SSM_LAYERS \
        and n_mamba == SSM_LAYERS * 5 // 6
    assert all(r.done and len(r.out) == SSM_NEW for r in reqs), \
        [(r.uid, r.done, len(r.out)) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    assert names == ["precise", "int8", "int8+kvq8"], names
    visited = {0} | {v for _, v in eng.swaps}
    assert len(visited) > 1, eng.swaps
    chunks = ssm_chunks(eng)
    assert launches["ssd_scan"] == ssd_scan.FWD_PASSES * n_mamba * chunks, \
        (launches, chunks)
    assert launches["paged_attention"] > 0, launches
    assert launches["flash_attention"] == launches["ring_hop"] \
        == launches["ssd_scan_backward"] == 0, launches
    if visited - {0}:       # every rung past precise runs the int8 matmuls
        assert launches["int8_matmul"] > 0 and \
            launches["quantize_rows"] > 0, launches
    pool, s = eng.pool, eng.pool.stats
    assert pool.snapshot_evicted > 0 and \
        pool.peak_snapshot_bytes <= pool.snapshot_budget, \
        (pool.snapshot_evicted, pool.peak_snapshot_bytes)
    assert peak <= SSM_PEAK_GIB, peak
    snap = sum(x[:, 0].nbytes for c in eng.caches
               if isinstance(c, MambaCache) for x in c)
    print(f"{tag} memory: SSM snapshots registered "
          f"{s['prefix_registered']} of {snap / 2 ** 20:.1f} MiB "
          f"({s['prefix_registered'] * snap / 2 ** 30:.2f} GiB), budget {pool.snapshot_budget / 2 ** 30:.2f} GiB, held at most "
          f"{pool.peak_snapshot_bytes / 2 ** 30:.2f} GiB, "
          f"{pool.snapshot_evicted} evicted by the budget; device peak "
          f"{peak:.2f} GiB (tol {SSM_PEAK_GIB}); host resident "
          f"{rss0:.2f} -> {host_rss_gib():.2f} GiB")
    print(f"{tag}: {res['tokens']} tokens, tok_s={res['tok_s']:.2f} "
          f"p50_ms={1e3 * res['p50_s']:.3f} p99_ms={1e3 * res['p99_s']:.3f} "
          f"wall={res['wall_s']:.2f}s swaps={eng.swaps} admission chunks "
          f"{chunks} ({sum(len(r.prompt) for r in reqs)} prompt tokens; "
          f"prefill pauses at every registered {SSM_PAGE}-token boundary), "
          f"mean decode step "
          f"{1e3 * sum(eng.step_latencies) / len(eng.step_latencies):.3f} "
          f"ms ({len(eng.step_latencies)} steps), prefixes registered "
          f"{s['prefix_registered']} evicted {s['prefix_evicted']}, "
          f"launches={launches}")
    return res, launches


def ssm_engine(src, device, rung, paged=True, k=0, slots=0):
    """An engine on the cell's weights (``slots`` slots, ``SSM_SLOTS`` for
    0, max_len ``SSM_CTX``, page ``SSM_PAGE``, chunk ``SSM_CHUNK``, every
    admission in one step) on rung ``rung``; megastep K ``k``."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(src.cfg, batch_slots=slots or SSM_SLOTS,
                      max_len=SSM_CTX,
                      params=src.params, table=src.table,
                      prefill_chunk=SSM_CHUNK, paged=paged,
                      page_size=SSM_PAGE, max_admission_chunks=1 << 20,
                      cache_dtype=src.cache_dtype, device=device,
                      megastep_k=k)
    eng.request_variant(rung)
    return eng


def ssm_walk(res, device, decode_steps=4, prof_steps=2):
    """``request_variant`` walk over the ladder on the cell's weights: on
    each rung the dense engine, then the paged engine serve the same
    ``SSM_SLOTS`` prompts of ``SSM_WALK_LEN`` tokens. Each reports
    admission ms a chunk and a token (the paged engine pauses at every
    16-token boundary it registers), the mean decode step over
    ``decode_steps`` steps with every slot live and a profiled window's
    busy share; on precise also the shares of the device time of the
    Mamba decode (``mamba2.mamba_decode``) and of the attention decode
    (host and card profiled: slow at this op count), and that the paged
    decode step makes no host sync."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm
    from repro_torch.models import mamba2 as mamba_mod
    from repro_torch.serve.engine import Request
    src = res["engine"]
    prompts = ssm_prompts(src.cfg.vocab_size, SSM_SLOTS, 11, SSM_WALK_LEN)
    tokens = SSM_SLOTS * SSM_WALK_LEN
    for rung, name in enumerate(res["names"]):
        for paged in (False, True):
            drop_int8_weights()
            eng = ssm_engine(src, device, rung, paged)
            for i, p in enumerate(prompts):
                eng.submit(Request(i, prompt=p, max_new=4 * prof_steps
                                   + decode_steps + 4))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while not all(s is not None for s in eng.slots):
                eng.step()
            torch.cuda.synchronize()
            admit = time.perf_counter() - t0
            chunks = (ssm_chunks(eng) if paged
                      else SSM_SLOTS * -(-SSM_WALK_LEN // SSM_CHUNK))
            eng.step()
            n0 = len(eng.step_latencies)
            for _ in range(decode_steps):
                eng.step()
            step = 1e3 * sum(eng.step_latencies[n0:]) / decode_steps
            wall, busy = busy_window(eng, prof_steps)
            kind = "paged" if paged else "dense"
            extra = ""
            if rung == 0:
                attn_fn = "paged_decode_attention" if paged else \
                    "decode_attention"
                _, _, attn = fn_share(eng, prof_steps, attn_mod, attn_fn)
                _, _, mamba = fn_share(eng, prof_steps, mamba_mod,
                                       "mamba_decode")
                extra = (f", Mamba decode {mamba:.3f} and attention "
                         f"{attn:.3f} of the device time")
            if paged and rung == 0:
                toks = torch.tensor(eng.cur_tokens, dtype=torch.long,
                                    device=device)[:, None]
                pos = torch.tensor(eng.positions, device=device)
                act = torch.ones(SSM_SLOTS, dtype=torch.bool, device=device)
                n = host_syncs(lambda: lm.decode_step(
                    eng.params, toks, pos, eng.caches, eng.cfg,
                    eng.active_knobs, active=act))
                assert n == 0, n
                extra += ", host syncs in a decode step 0"
            print(f"serve-ssm walk {name} {kind}: admission "
                  f"{1e3 * admit / chunks:.2f} ms a chunk ({chunks} chunks),"
                  f" {1e3 * admit / tokens:.4f} ms a token; mean decode "
                  f"step {step:.3f} ms ({SSM_SLOTS} slots, {decode_steps} "
                  f"steps); profiled {prof_steps} steps: wall {wall:.3f} "
                  f"ms, busy {busy:.3f} ms ({busy / wall:.3f}){extra}")
            del eng
            torch.cuda.empty_cache()


def ssm_megastep(res, device, max_new=17):
    """On precise and the most approximate rung: the per-step paged engine
    and the megastep engine (K ``MEGA_K``, a replayed CUDA graph whose
    Mamba rows update in place) serve the same ``SSM_SLOTS`` prompts of
    ``SSM_MEGA_LEN`` tokens with equal greedy streams; dispatches a token
    and the graphs' replays, the median per-step decode and the megastep's
    median flight wall a token."""
    import numpy as np
    src = res["engine"]
    prompts = ssm_prompts(src.cfg.vocab_size, SSM_SLOTS, 4, SSM_MEGA_LEN)
    for rung in (0, len(res["names"]) - 1):
        name = res["names"][rung]
        drop_int8_weights()
        per = ssm_engine(src, device, rung)
        a = serve_streams(per, prompts, max_new)
        mega = ssm_engine(src, device, rung, k=MEGA_K)
        b = serve_streams(mega, prompts, max_new)
        assert a == b, (name, [sum(x != y for x, y in zip(p, q))
                               for p, q in zip(a, b)])
        # a full batch's steps: past admission (the first decode) and, on
        # the megastep, its K-token flights past the capture
        step_ms = 1e3 * float(np.median(per.step_latencies[1:]))
        tok_ms = 1e3 * float(np.median(mega.step_latencies[1:])) / MEGA_K
        print(f"serve-ssm megastep {name}: streams equal "
              f"({sum(map(len, b))} tokens), median per-step decode "
              f"{step_ms:.3f} ms, megastep {tok_ms:.3f} ms a token (flight "
              f"wall / {MEGA_K}), dispatches/token "
              f"{mega.row_dispatches / mega.row_tokens:.3f}, graphs "
              f"{len(mega.graph_log)}, replays "
              f"{sum(g['replays'] for g in mega.graph_log)}, launches a "
              f"replay {[g['launches'] for g in mega.graph_log]}")
        del mega


def ssm_prefix_hit(res, device, max_new=16):
    """A prefix hit that restores an SSM snapshot: on a one-slot paged
    engine a request of ``SSM_PREFIX_LEN`` tokens registers its 16-token
    boundaries (each with a snapshot of the slot's Mamba rows), then a
    second request sharing its first three quarters maps those pages,
    starts from that boundary's snapshot and skips those chunks; its
    greedy stream equals the same request's on a fresh engine (cold).
    Taking a snapshot (copies into pinned host memory) makes no host
    sync."""
    src = res["engine"]
    first, tail = ssm_prompts(src.cfg.vocab_size, 2, 7, SSM_PREFIX_LEN)
    shared = 3 * SSM_PREFIX_LEN // 4
    second = first[:shared] + tail[shared:]
    drop_int8_weights()
    cold_eng = ssm_engine(src, device, 0, slots=1)
    cold = serve_streams(cold_eng, [second], max_new)
    eng = ssm_engine(src, device, 0, slots=1)
    serve_streams(eng, [first], max_new)
    c0 = ssm_chunks(eng)
    warm = serve_streams(eng, [second], max_new)
    s = eng.pool.stats
    assert s["prefix_hits"] == 1 and s["tokens_skipped"] == shared, s
    assert warm == cold, (warm, cold)
    syncs = host_syncs(lambda: eng._mamba_snapshot(0))
    assert syncs == 0, syncs
    print(f"serve-ssm prefix hit: {shared} of {SSM_PREFIX_LEN} tokens "
          f"skipped from an SSM snapshot, {ssm_chunks(eng) - c0} chunks "
          f"(cold {ssm_chunks(cold_eng)}), stream equal to the cold run's "
          f"({max_new} tokens); host syncs in taking a snapshot {syncs}")


def state_gaps(caches_a, caches_b):
    """The Mamba states two handoffs give decode, layer by layer (each
    cache's n_groups rows): the largest |diff| over the layer's rms and
    over its largest |entry|, the relative Frobenius norm, and the worst
    head's relative Frobenius norm. Returns the worst layer's of each."""
    from repro_torch.models.mamba2 import MambaCache
    worst = [0.0, 0.0, 0.0, 0.0]
    for a, b in zip(caches_a, caches_b):
        if not isinstance(a, MambaCache):
            continue
        for x, y in zip(a.state.float(), b.state.float()):   # a layer
            d = (x - y).abs()
            head = ((x - y).pow(2).sum((-1, -2)).sqrt()
                    / y.pow(2).sum((-1, -2)).sqrt())
            got = (float(d.max() / y.pow(2).mean().sqrt()),
                   float(d.max() / y.abs().max()),
                   float((x - y).norm() / y.norm()), float(head.max()))
            worst = [max(w, g) for w, g in zip(worst, got)]
    return worst


def ssm_handoff(res, device):
    """``prefill_with_cache`` on one prompt of ``SSM_HANDOFF_LEN`` tokens at
    the cell's width (precise): an ``ssd_scan`` call with the final state
    out a Mamba layer and a ``flash_attention`` call (hd 80: design tc in
    bf16, tiled in fp32, none simple) a shared-attention layer, against
    chunked admission (the dense engine's ``_chunked_prefill``). In bf16
    (the cell's weights): the first-token logits within ``SSM_LOGIT_TOL``
    of their rms, the Mamba states each hands to decode within
    ``SSM_STATE_BF16`` (relative Frobenius norm, worst layer). The same
    weights in fp32 are the witness that the handoff itself is exact,
    that bf16 rounding over the layers makes the bf16 gap: states within
    ``SSM_STATE_FP32`` (relative Frobenius, worst layer and worst head)
    and logits within ``SSM_LOGIT_FP32`` of their rms. ``state_gaps``'
    other readings are printed beside them."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs.base import SHARED_ATTN
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    from repro_torch.serve import prefill as prefill_mod
    from repro_torch.serve.engine import ServeEngine
    src = res["engine"]
    cfg = src.cfg
    drop_int8_weights()
    prompt = list(map(int, np.random.default_rng(13).integers(
        1, cfg.vocab_size, SSM_HANDOFF_LEN)))

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.pow(2).mean().sqrt())

    def handoffs(params, cache_dtype, tag):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_pf, caches_pf = prefill_mod.prefill_with_cache(
            params, torch.tensor([prompt], device=device), cfg, SSM_CTX)
        torch.cuda.synchronize()
        pf_s = time.perf_counter() - t0
        launches = read_launches()
        designs = {k: n for k, n in fa.design_launches.items() if n}
        n_attn = sum(k == SHARED_ATTN for k in cfg.kinds())
        assert launches["ssd_scan"] == ssd_scan.FWD_PASSES * (
            cfg.n_layers - n_attn), launches
        want = "tiled" if cache_dtype == torch.float32 else "tc"
        assert launches["flash_attention"] == n_attn \
            and designs == {want: n_attn}, (launches, designs)
        eng = ServeEngine(cfg, batch_slots=1, max_len=SSM_CTX,
                          params=params, prefill_chunk=SSM_CHUNK,
                          cache_dtype=cache_dtype, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_ck, caches_ck = eng._chunked_prefill(prompt)
        torch.cuda.synchronize()
        ck_s = time.perf_counter() - t0
        logit = rel(logits_pf, logits_ck)
        gaps = state_gaps(caches_pf, caches_ck)
        print(f"serve-ssm prefill_with_cache {tag}: {SSM_HANDOFF_LEN} "
              f"tokens in {1e3 * pf_s:.1f} ms (chunked admission "
              f"{1e3 * ck_s:.1f} ms), launches ssd_scan "
              f"{launches['ssd_scan']} flash_attention "
              f"{launches['flash_attention']} by design {designs}; "
              f"first-token logits max |diff| {logit:.4g} of their rms; "
              f"Mamba states, worst layer: max |diff| {gaps[0]:.4g} of its "
              f"rms, {gaps[1]:.4g} of its largest |entry|, relative "
              f"Frobenius {gaps[2]:.4g} (worst head {gaps[3]:.4g}); greedy "
              f"first tokens equal "
              f"{int(logits_pf.argmax(-1) == logits_ck.argmax(-1))}")
        del eng, caches_pf, caches_ck
        return logit, gaps
    logit16, gaps16 = handoffs(src.params, src.cache_dtype, "bf16")
    params32 = copy.deepcopy(src.params).float()
    logit32, gaps32 = handoffs(params32, torch.float32, "fp32")
    del params32
    torch.cuda.empty_cache()
    assert logit16 <= SSM_LOGIT_TOL, logit16
    assert gaps16[2] <= SSM_STATE_BF16, gaps16
    assert logit32 <= SSM_LOGIT_FP32, logit32
    assert max(gaps32[2], gaps32[3]) <= SSM_STATE_FP32, gaps32


def ssm_cell(device):
    """Phase ``serve-ssm``: ``ssd_scan`` with the state in and out,
    ``flash_attention``, ``paged_attention``, ``int8_matmul`` and
    ``quantize_rows`` at the path's zamba2-2.7b shapes, small-config
    parity, the cell's serve run, the rung walk, the megastep, a prefix hit
    and the ``prefill_with_cache`` handoff; device memory before, at peak
    and after. Returns (the serve run's launches, the ``ssd_scan`` rows,
    the ``paged_attention`` rows, the ``flash_attention`` rows)."""
    import gc

    import torch
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, t = {}, time.perf_counter()

    def done(name):
        nonlocal t
        secs[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
    rows = check_ssd_state(device, ssd_state_cases())
    fa_rows = check_flash(device, zamba2_flash_cases(), iters=5)
    pa_rows = check_paged(device, zamba2_paged_cases())
    check_int8(device, zamba2_int8_shapes())
    check_quantize(device, zamba2_quantize_shapes())
    done("kernels")
    ssm_parity(device)
    done("parity")
    res, launches = ssm_serve(device)
    done("serve")
    ssm_walk(res, device)
    done("walk")
    ssm_megastep(res, device)
    done("megastep")
    ssm_prefix_hit(res, device)
    done("prefix")
    ssm_handoff(res, device)
    done("handoff")
    print(f"serve-ssm seconds: {secs}")
    del res                  # the engine and its runtime hold a cycle
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    print(f"serve-ssm memory: before {before / 2 ** 30:.2f} GiB, peak "
          f"{peak / 2 ** 30:.2f} GiB, after {after / 2 ** 30:.2f} GiB")
    return launches, rows, pa_rows, fa_rows


# -------------------------------------------------------------- serve-moe --

MOE_ARCH = "olmoe-1b-7b"      # full width: 64 experts; 16 layers at full
# depth, cut to 8 (16 until the train-encdec phase ran over the script's
# time limit: admission and decode are host-bound, so the cell's time
# follows the depth)
MOE_LAYERS = 8
MOE_SLOTS = 8
MOE_CTX = 4096                # max_len
MOE_PAGE = 16
MOE_CHUNK = 128               # prefill chunk
MOE_PROMPTS = (256, 2048)     # prompt lengths, drawn uniformly
MOE_NEW = 32
MOE_REQUESTS = 12
MOE_WALK_LEN = 128            # the walk's and the megastep's prompts
MOE_WALK_TOPK = 4             # the walk's expert-perforation rung
MOE_HANDOFF_LEN = 2048        # prefill_with_cache's prompt
# routing 2048 tokens at once drops other entries than 128-token chunks
# do at the config's capacity factor 1.25; at 16 neither drops
# (tests/test_prefill.py's olmoe case)
MOE_HANDOFF_CF = 16.0
MOE_HANDOFF_STEPS = 16        # teacher-forced decode steps after it
# bf16 first-token logits and each teacher-forced step's, max |diff| over
# their rms (the serve-dense phase's first-token gate); and in fp32 on the
# same weights, logits, steps and ring K/V
MOE_LOGIT_TOL = 0.5
MOE_FP32_TOL = 1e-3
# the experts' products: wi_gate and wi_up (K 2048 -> N 1024), wo (1024 ->
# 2048), 64 experts
OLMOE_EXPERTS = 64
OLMOE_PRODUCTS = ((2048, 1024), (1024, 2048))


def moe_capacity(tokens, cfg_top_k=8, n_experts=OLMOE_EXPERTS, cf=1.25):
    """Rows an expert takes from a call of ``tokens`` tokens
    (``models/moe.py`` ``_capacity``)."""
    from repro_torch.models.moe import _capacity
    return _capacity(tokens, cfg_top_k, n_experts, cf)


def olmoe_int8_shapes():
    """(E, M, K, N) of olmoe-1b-7b's batched expert products on the
    serve-moe path: decode (8 slots route 8 tokens: capacity 8 rows an
    expert, design B) and a 128-token admission chunk (capacity 24, design
    A)."""
    return [(OLMOE_EXPERTS, m, k, n)
            for m in (moe_capacity(MOE_SLOTS), moe_capacity(MOE_CHUNK))
            for k, n in OLMOE_PRODUCTS]


def check_int8_batched(device, shapes, iters=20):
    """The batched ``int8_matmul`` (the experts on the grid, one launch)
    against its plain version at each (E, M, K, N): ``int8_matmul_t`` on
    ``w_t`` (E, N, K) and ``int8_matmul`` on ``w_q`` (E, K, N) must both
    equal ``int8_matmul_plain`` bit for bit (tolerance 0), in bf16 and
    fp32, each ONE launch of the design ``select_design(M, N, K)`` names.
    Timed (bf16 out) beside the plain version and the bound: E times one
    expert's ``int8_bound_ms``. The experts' weights (134 MB at olmoe's
    widths) are more than twice L2, so every call reads them cold. No
    single PyTorch call computes the batched product (``torch._int_mm`` is
    2-D): the library column is null."""
    import torch
    from repro_torch.kernels import int8_matmul as mod
    rows = []
    for E, M, K, N in shapes:
        g = torch.Generator(device="cpu").manual_seed(E + M + K)
        x_q = torch.randint(-127, 128, (E, M, K), generator=g,
                            dtype=torch.int8)
        w_t = torch.randint(-127, 128, (E, N, K), generator=g,
                            dtype=torch.int8)
        xs = torch.rand((E, M, 1), generator=g) * 1e-2 + 1e-4
        ws = torch.rand((E, N, 1), generator=g) * 1e-2 + 1e-4
        x_q, w_t, xs, ws = (t.to(device) for t in (x_q, w_t, xs, ws))
        w_q = w_t.transpose(1, 2).contiguous()
        ws_row = ws.transpose(1, 2).contiguous()
        design = mod.select_design(M, N, K)
        err = 0.0
        for dt in (torch.bfloat16, torch.float32):
            ref = mod.int8_matmul_plain(x_q, xs, w_q, ws_row, dt)
            n0, d0 = mod.launches, mod.design_launches[design]
            outs = (mod.int8_matmul_t(x_q, xs, w_t, ws, out_dtype=dt),
                    mod.int8_matmul(x_q, xs, w_q, ws_row, out_dtype=dt))
            torch.cuda.synchronize()
            assert mod.launches == n0 + 2 and \
                mod.design_launches[design] == d0 + 2, \
                (E, M, K, N, design, mod.design_launches)
            for out in outs:
                assert out.shape == (E, M, N), out.shape
                err = max(err, max_err(out, ref))
                assert torch.equal(out, ref), (E, M, K, N, dt, design, err)
        kern = timed(lambda: mod.int8_matmul_t(x_q, xs, w_t, ws), device,
                     iters)
        plain = timed(lambda: mod.int8_matmul_plain(
            x_q, xs, w_q, ws_row, torch.bfloat16), device, iters)
        bound, by = int8_bound_ms(M, K, N)
        bound *= E
        rows.append(dict(E=E, M=M, K=K, N=N, design=design,
                         max_abs_err=err, ms=kern, plain_ms=plain,
                         library_ms=None, bound_ms=bound, bound_by=by))
        print(f"int8_matmul batched E={E} M={M} K={K} N={N} design {design}"
              f" (one launch, weights {E * K * N / 1e6:.0f} MB, L2 cold): "
              f"max_abs_err={err} ms={kern:.4f} plain_ms={plain:.4f} "
              f"library_ms=null (torch._int_mm is 2-D: no single PyTorch "
              f"call computes the batched product) bound_ms={bound:.4f} "
              f"({by}) share of bound {bound / kern:.3f}")
        del x_q, w_t, w_q
    return rows


def olmoe_quantize_shapes():
    """What olmoe-1b-7b's int8 rungs quantise on that path, bf16: the
    experts' activations (64 experts x 8 or 24 rows of 2048 and 1024) and
    the stacked weights as rows of ``w.transpose(1, 2)`` (64 x 1024 rows of
    2048 for ``wi_gate`` and ``wi_up``, 64 x 2048 rows of 1024 for
    ``wo``)."""
    import torch
    acts = [(OLMOE_EXPERTS * m, k, torch.bfloat16)
            for m in (moe_capacity(MOE_SLOTS), moe_capacity(MOE_CHUNK))
            for k, _ in OLMOE_PRODUCTS]
    return acts + [(OLMOE_EXPERTS * n, k, torch.bfloat16)
                   for k, n in OLMOE_PRODUCTS]


def olmoe_paged_cases():
    """``paged_attention`` at olmoe-1b-7b's decode on the cell: MHA (G 16,
    R 1), hd 128, page 16, M 256 of a 4096-token max_len, 6 ragged live
    slots up to the longest prompt and its new tokens plus the two
    inactive rows (8 slots), bf16 and int8 K/V."""
    import torch
    base = dict(G=16, R=1, hd=128, P=MOE_PAGE, M=MOE_CTX // MOE_PAGE,
                lengths=[255, 256, 257, 700, 1500,
                         MOE_PROMPTS[1] + MOE_NEW - 1],
                dtype=torch.bfloat16, blind=True)
    return [dict(base, name="olmoe-bf16", int8=False),
            dict(base, name="olmoe-int8", int8=True)]


def check_moe_gate(device, iters=10):
    """The precise gate product at olmoe's widths in bf16 (64 experts, the
    24 rows a 128-token chunk gives each, 2048 x 1024): ``moe._bmm_f32``
    must write the fp32 sums unrounded, as the JAX package's
    ``preferred_element_type=float32`` does. Against the fp32 product of
    the exactly upcast operands on the card: within 2^-16 of its largest
    |entry| (fp32 sums in another order), where a bf16 output cast to fp32
    is off by about 2^-9 of it (printed, and asserted to be 8 times
    larger). Timed beside the bf16-out product."""
    import torch
    from repro_torch.models import moe as moe_mod
    g = torch.Generator(device="cpu").manual_seed(2)
    E, C = OLMOE_EXPERTS, moe_capacity(MOE_CHUNK)
    K, N = OLMOE_PRODUCTS[0]
    xe = torch.randn((E, C, K), generator=g).to(device, torch.bfloat16)
    w = (torch.randn((E, K, N), generator=g) / K ** 0.5).to(
        device, torch.bfloat16)
    got = moe_mod._bmm_f32(xe, w)
    ref = torch.bmm(xe.float(), w.float())
    rounded = torch.bmm(xe, w).float()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (E, C, N)
    scale = float(ref.abs().max())
    err, err_bf16 = max_err(got, ref), max_err(rounded, ref)
    assert err <= 2 ** -16 * scale and err_bf16 > 8 * err, \
        (err, err_bf16, scale)
    ms = timed(lambda: moe_mod._bmm_f32(xe, w), device, iters)
    ms16 = timed(lambda: torch.bmm(xe, w), device, iters)
    print(f"serve-moe precise gate product E={E} C={C} K={K} N={N} bf16 in, "
          f"fp32 out: max |diff| {err:.3g} against the fp32 upcast "
          f"({err / scale:.3g} of its largest |entry|; a bf16 output would "
          f"be off by {err_bf16:.3g}, {err_bf16 / scale:.3g}); {ms:.4f} ms "
          f"(bf16 out {ms16:.4f} ms)")


def moe_table(cfg, slots, max_len, topk, occupancy=None):
    """The explorer's serving table for ``cfg`` with a ``topk<topk>`` rung
    (expert perforation) appended at the explorer's own price for it (the
    explorer's table for olmoe holds precise, int8 and int8+kvq8 only)."""
    from repro_torch.approx.knobs import ApproxKnobs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.explorer import analytic_cost, analytic_quality_loss
    from repro_torch.core.variants import Variant, VariantTable
    from repro_torch.launch.serve import serving_table
    table = serving_table(cfg, slots=slots, max_len=max_len,
                          page_occupancy=occupancy)
    knobs = ApproxKnobs(topk_override=topk)
    rel, pressure = analytic_cost(
        cfg, ShapeConfig("serve", max_len, slots, "decode"), knobs,
        page_occupancy=occupancy)
    return VariantTable(table.variants + [Variant(
        knobs, rel, analytic_quality_loss(cfg, knobs), pressure)])


def moe_parity(device):
    """olmoe-1b-7b-smoke in fp32 on precise, int8, int8+kvq8 and a topk1
    rung, prompts sharing an 8-token prefix: the greedy streams of the
    dense engine, the paged engine and the paged engine under a 4-step
    megastep (a replayed CUDA graph of the decode step, routing included)
    on the card all equal the CPU's dense engine's."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm
    cfg = get_config("olmoe-1b-7b-smoke")
    cpu_params = init_lm(cfg, 0, torch.float32, "cpu")
    dev_params = copy.deepcopy(cpu_params).to(device)
    table = moe_table(cfg, 2, 64, 1)
    assert [v.name for v in table.variants] == \
        ["precise", "int8", "int8+kvq8", "topk1"], table.variants
    rng = np.random.default_rng(3)
    prefix = list(rng.integers(1, cfg.vocab_size, 8))
    prompts = [prefix + list(rng.integers(1, cfg.vocab_size, n))
               for n in (3, 9, 5, 13)]
    for rung, v in enumerate(table.variants):
        cpu = engine_streams(cfg, cpu_params, table, torch.device("cpu"),
                             rung, prompts, 6, paged=False)
        runs = {kind: engine_streams(cfg, dev_params, table, device, rung,
                                     prompts, 6, **kw)
                for kind, kw in (("dense", dict(paged=False)),
                                 ("paged", {}),
                                 ("megastep", dict(megastep_k=4)))}
        assert all(r == cpu for r in runs.values()), (v.name, cpu, runs)
        print(f"serve-moe parity olmoe-1b-7b-smoke {v.name}: {device} dense "
              f"== paged == megastep 4 == cpu dense streams "
              f"({sum(map(len, cpu))} tokens)")


@contextlib.contextmanager
def expert_calls():
    """Count ``models.moe._expert_ffn`` calls by precision: each is one MoE
    layer's experts in one forward (a decode step or an admission
    chunk)."""
    from repro_torch.models import moe as moe_mod
    calls = {"bf16": 0, "int8": 0}
    orig = moe_mod._expert_ffn

    def counted(xe, *a):
        calls[a[-1]] += 1
        return orig(xe, *a)
    moe_mod._expert_ffn = counted
    try:
        yield calls
    finally:
        moe_mod._expert_ffn = orig


def moe_serve(device):
    """The cell through ``launch/serve.py``: olmoe-1b-7b at full width,
    ``MOE_LAYERS`` layers, bf16, the paged engine, ``MOE_REQUESTS`` requests at t = 0 under
    a QoS target tight enough that the runtime swaps variants; launch
    counters zeroed just before and read just after: decode launches
    ``paged_attention``, and every MoE layer of a forward on an int8 rung
    exactly 3 ``int8_matmul`` (one for each of the three products, all 64
    experts in it; a host loop over the experts would show 192) and 3
    ``quantize_rows`` for its activations, beside one ``quantize_rows``
    for each stacked weight the cache quantised. Returns
    (``serve.main``'s result, launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    lo, hi = MOE_PROMPTS
    argv = ["--arch", MOE_ARCH, "--paged", "--dtype", "bf16",
            "--device", str(device), "--slots", str(MOE_SLOTS),
            "--max-len", str(MOE_CTX), "--page-size", str(MOE_PAGE),
            "--prefill-chunk", str(MOE_CHUNK),
            "--requests", str(MOE_REQUESTS), "--prompt-len", str(lo),
            "--prompt-len-max", str(hi), "--max-new", str(MOE_NEW),
            "--qos-target", "0.001", "--decision-interval", "0",
            "--min-samples", "4"]
    tag = f"serve-moe {MOE_ARCH} ({MOE_LAYERS} layers)"
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    drop_int8_weights()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    misses = kops.weight_cache_misses
    reset_launches()
    with expert_calls() as calls:
        res = serve.main(argv, cfg=cfg)
    launches = read_launches()
    quantised = kops.weight_cache_misses - misses
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    designs = int8_designs(tag)
    eng, reqs, names = res["engine"], res["requests"], res["names"]
    cfg = eng.cfg
    assert eng.paged and cfg.n_layers == MOE_LAYERS \
        and cfg.d_model == 2048 and cfg.moe.n_experts == 64 \
        and cfg.moe.top_k == 8, cfg
    assert all(r.done and len(r.out) == MOE_NEW for r in reqs), \
        [(r.uid, r.done, len(r.out)) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    assert names == ["precise", "int8", "int8+kvq8"], names
    visited = {0} | {v for _, v in eng.swaps}
    assert len(visited) > 1, eng.swaps
    assert calls["int8"] > 0 and calls["int8"] % cfg.n_layers == 0 \
        and calls["bf16"] % cfg.n_layers == 0, calls
    assert launches["int8_matmul"] == 3 * calls["int8"], (launches, calls)
    assert launches["quantize_rows"] == 3 * calls["int8"] + quantised, \
        (launches, calls, quantised)
    assert launches["paged_attention"] > 0, launches
    assert launches["ring_hop"] == launches["ssd_scan"] \
        == launches["ssd_scan_backward"] == 0, launches
    print(f"{tag}: {res['tokens']} tokens, tok_s={res['tok_s']:.2f} "
          f"p50_ms={1e3 * res['p50_s']:.3f} p99_ms={1e3 * res['p99_s']:.3f} "
          f"wall={res['wall_s']:.2f}s swaps={eng.swaps}; MoE forwards: "
          f"{calls['bf16'] // cfg.n_layers} bf16, "
          f"{calls['int8'] // cfg.n_layers} int8 (decode steps and "
          f"admission chunks); int8_matmul launches "
          f"{launches['int8_matmul'] / calls['int8']:.1f} a MoE layer a "
          f"forward on an int8 rung (by design {designs}); quantize_rows "
          f"{launches['quantize_rows']} ({quantised} stacked weights); mean "
          f"decode step "
          f"{1e3 * sum(eng.step_latencies) / len(eng.step_latencies):.3f} "
          f"ms ({len(eng.step_latencies)} steps); device peak {peak:.2f} "
          f"GiB; launches={launches}")
    return res, launches


def moe_engine(src, device, rung, table, paged=True, k=0):
    """An engine on the cell's weights (``MOE_SLOTS`` slots, max_len
    ``MOE_CTX``, page ``MOE_PAGE``, chunk ``MOE_CHUNK``, every admission in
    one step) on rung ``rung`` of ``table``; megastep K ``k``."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(src.cfg, batch_slots=MOE_SLOTS,
                      max_len=MOE_CTX, params=src.params, table=table,
                      prefill_chunk=MOE_CHUNK, paged=paged,
                      page_size=MOE_PAGE, max_admission_chunks=1 << 20,
                      cache_dtype=src.cache_dtype, device=device,
                      megastep_k=k)
    if table is not None:
        eng.request_variant(rung)
    return eng


def moe_walk(res, device, decode_steps=4, prof_steps=2):
    """``request_variant`` walk over precise, int8, int8+kvq8 and
    ``topk<MOE_WALK_TOPK>`` (the explorer's table with that rung appended)
    on the cell's weights: on each rung the dense engine, then the paged
    engine serve the same ``MOE_SLOTS`` prompts of ``MOE_WALK_LEN``
    tokens. Each reports admission ms a chunk, the mean decode step over
    ``decode_steps`` steps with every slot live and a profiled window's
    busy share; on precise also MoE's share of the device time (every
    ``models.moe.moe`` call in a ``record_function`` range); the paged
    decode step makes no host sync on any rung. Then the topk rung's
    decode step beside precise's, next to the explorer's price for the
    rung (printed, not gated)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import Request
    src = res["engine"]
    table = moe_table(src.cfg, MOE_SLOTS, MOE_CTX, MOE_WALK_TOPK)
    names = [v.name for v in table.variants]
    prompts = ssm_prompts(src.cfg.vocab_size, MOE_SLOTS, 11, MOE_WALK_LEN)
    chunks = MOE_SLOTS * -(-MOE_WALK_LEN // MOE_CHUNK)
    steps = {}
    for rung, name in enumerate(names):
        for paged in (False, True):
            drop_int8_weights()
            eng = moe_engine(src, device, rung, table, paged)
            for i, p in enumerate(prompts):
                eng.submit(Request(i, prompt=p, max_new=4 * prof_steps
                                   + decode_steps + 4))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while not all(s is not None for s in eng.slots):
                eng.step()
            torch.cuda.synchronize()
            admit = (sum(eng.admit_latencies) if not paged
                     else time.perf_counter() - t0)
            eng.step()
            n0 = len(eng.step_latencies)
            for _ in range(decode_steps):
                eng.step()
            step = 1e3 * sum(eng.step_latencies[n0:]) / decode_steps
            steps[name, paged] = step
            kind = "paged" if paged else "dense"
            if rung == 0:
                wall, busy, share = fn_share(eng, prof_steps, moe_mod, "moe")
                extra = f", MoE {share:.3f} of the device time"
            else:
                wall, busy = busy_window(eng, prof_steps)
                extra = ""
            if paged:
                toks = torch.tensor(eng.cur_tokens, dtype=torch.long,
                                    device=device)[:, None]
                pos = torch.tensor(eng.positions, device=device)
                act = torch.ones(MOE_SLOTS, dtype=torch.bool, device=device)
                n = host_syncs(lambda: lm.decode_step(
                    eng.params, toks, pos, eng.caches, eng.cfg,
                    eng.active_knobs, active=act))
                assert n == 0, (name, n)
                extra += ", host syncs in a decode step 0"
            print(f"serve-moe walk {name} {kind}: admission "
                  f"{1e3 * admit / chunks:.2f} ms a {MOE_CHUNK}-token chunk "
                  f"({chunks} chunks); mean decode step {step:.3f} ms "
                  f"({MOE_SLOTS} slots, {decode_steps} steps); profiled "
                  f"{prof_steps} steps: wall {wall:.3f} ms, busy {busy:.3f} "
                  f"ms ({busy / wall:.3f}){extra}")
            del eng
            torch.cuda.empty_cache()
    topk = names[-1]
    price = table.variants[-1].rel_time
    for paged in (False, True):
        kind = "paged" if paged else "dense"
        print(f"serve-moe walk {topk} against precise ({kind}): decode step "
              f"{steps[topk, paged]:.3f} / {steps['precise', paged]:.3f} ms "
              f"= {steps[topk, paged] / steps['precise', paged]:.3f}; the "
              f"explorer prices the rung at {price:.3f} of precise")
    return table


def moe_megastep(res, device, max_new=17):
    """On precise and int8+kvq8: the per-step paged engine and the
    megastep engine (K ``MEGA_K``, a replayed CUDA graph with the routing
    in it) serve the same ``MOE_SLOTS`` prompts of ``MOE_WALK_LEN`` tokens
    with equal greedy streams; the median per-step decode and the
    megastep's median flight wall a token; then, on a full batch of a
    fresh megastep engine, no host sync in a replay, in the body run
    eagerly or in a steady round (``check_megastep_syncs``)."""
    import numpy as np
    from repro_torch.serve.engine import Request
    src = res["engine"]
    prompts = ssm_prompts(src.cfg.vocab_size, MOE_SLOTS, 4, MOE_WALK_LEN)
    for rung in (0, len(res["names"]) - 1):
        name = res["names"][rung]
        drop_int8_weights()
        per = moe_engine(src, device, rung, src.table)
        a = serve_streams(per, prompts, max_new)
        mega = moe_engine(src, device, rung, src.table, k=MEGA_K)
        b = serve_streams(mega, prompts, max_new)
        assert a == b, (name, [sum(x != y for x, y in zip(p, q))
                               for p, q in zip(a, b)])
        step_ms = 1e3 * float(np.median(per.step_latencies[1:]))
        tok_ms = 1e3 * float(np.median(mega.step_latencies[1:])) / MEGA_K
        print(f"serve-moe megastep {name}: streams equal "
              f"({sum(map(len, b))} tokens), median per-step decode "
              f"{step_ms:.3f} ms, megastep {tok_ms:.3f} ms a token (flight "
              f"wall / {MEGA_K}), dispatches/token "
              f"{mega.row_dispatches / mega.row_tokens:.3f}, graphs "
              f"{len(mega.graph_log)}, capture "
              f"{sum(g['capture_s'] for g in mega.graph_log):.3f} s, "
              f"launches a replay {[g['launches'] for g in mega.graph_log]}")
        del per, mega
        if rung == 0:
            eng = moe_engine(src, device, rung, src.table, k=MEGA_K)
            for i, p in enumerate(prompts):
                eng.submit(Request(i, prompt=list(p), max_new=4 * MEGA_K))
            while not (all(s is not None for s in eng.slots)
                       and eng._inflight is not None):
                eng.step()
            eng.step()
            check_megastep_syncs(eng)
            del eng


@contextlib.contextmanager
def expert_choices():
    """Record each ``models.moe._top_k`` call's expert ids (T, k), in call
    order."""
    from repro_torch.models import moe as moe_mod
    ids = []
    orig = moe_mod._top_k

    def recorded(probs, k):
        out = orig(probs, k)
        ids.append(out[1])
        return out
    moe_mod._top_k = recorded
    try:
        yield ids
    finally:
        moe_mod._top_k = orig


def routing_flips(whole, chunked, n_layers):
    """Tokens whose expert set differs between one call a layer over the
    whole prompt (``whole``: n_layers calls) and the chunked calls
    (``chunked``: n_layers calls a chunk, chunk by chunk): per layer, and
    in any layer."""
    import torch
    flips, any_flip = [], None
    for layer in range(n_layers):
        a = whole[layer].sort(-1).values
        b = torch.cat(chunked[layer::n_layers]).sort(-1).values
        d = (a != b).any(-1)
        flips.append(int(d.sum()))
        any_flip = d if any_flip is None else any_flip | d
    return flips, int(any_flip.sum())


def moe_handoff(res, device):
    """``prefill_with_cache`` on one prompt of ``MOE_HANDOFF_LEN`` tokens at
    the cell's width (precise, capacity factor ``MOE_HANDOFF_CF`` on both
    sides, so neither drops): every MoE layer routes the 2048 tokens at
    once, each layer's attention one ``flash_attention`` launch of design
    tc; against chunked admission (``_chunked_prefill``, chunks of
    ``MOE_CHUNK``): the first-token logits, the rings in ``ring_order``
    and their K/V, then ``MOE_HANDOFF_STEPS`` decode steps teacher-forced
    with chunked admission's greedy tokens through both, each step's
    logits against the other's; and the tokens whose expert set differs
    between the two in some layer. In bf16 (the cell's weights) the
    first-token logits and every step within ``MOE_LOGIT_TOL`` of their
    rms: router logits rounded to bf16 flip near-tied experts between the
    two paths' roundings, and a flipped token's K/V differ by O(1) from
    there on. The same weights in fp32 are the witness that the handoff
    itself is exact: logits, steps and K/V within ``MOE_FP32_TOL`` of
    their rms."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.serve import prefill as prefill_mod
    from repro_torch.serve.engine import ServeEngine
    src = res["engine"]
    m = src.cfg.moe
    cfg = dataclasses.replace(src.cfg, moe=MoEConfig(
        m.n_experts, m.top_k, capacity_factor=MOE_HANDOFF_CF))
    drop_int8_weights()
    S = MOE_HANDOFF_LEN
    prompt = list(map(int, np.random.default_rng(13).integers(
        1, cfg.vocab_size, S)))

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.pow(2).mean().sqrt())

    def handoffs(params, cache_dtype, tag):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with expert_choices() as whole:
            logits_pf, caches_pf = prefill_mod.prefill_with_cache(
                params, torch.tensor([prompt], device=device), cfg, MOE_CTX)
        torch.cuda.synchronize()
        pf_s = time.perf_counter() - t0
        launches = read_launches()
        designs = {k: n for k, n in fa.design_launches.items() if n}
        assert launches["flash_attention"] == cfg.n_layers, launches
        want = "tc" if cache_dtype == torch.bfloat16 else "tiled"
        assert designs == {want: cfg.n_layers}, designs
        eng = ServeEngine(cfg, batch_slots=1, max_len=MOE_CTX,
                          params=params, prefill_chunk=MOE_CHUNK,
                          cache_dtype=cache_dtype, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with expert_choices() as chunked:
            logits_ck, caches_ck = eng._chunked_prefill(prompt)
        torch.cuda.synchronize()
        ck_s = time.perf_counter() - t0
        flips, flipped = routing_flips(whole, chunked, cfg.n_layers)
        logit = rel(logits_pf, logits_ck)
        kv = ring_kv_err(caches_pf, caches_ck, S)
        steps, same = [], 0
        cur = logits_ck.argmax(-1)
        pos = torch.full((1,), S, dtype=torch.int32, device=device)
        for _ in range(MOE_HANDOFF_STEPS):
            same += int(logits_pf.argmax(-1) == cur)
            logits_pf, caches_pf = lm.decode_step(params, cur[:, None], pos,
                                                  caches_pf, cfg)
            logits_ck, caches_ck = lm.decode_step(params, cur[:, None], pos,
                                                  caches_ck, cfg)
            assert torch.isfinite(logits_pf).all()
            steps.append(rel(logits_pf, logits_ck))
            cur = logits_ck.argmax(-1)
            assert 0 <= int(cur) < cfg.vocab_size
            pos += 1
        print(f"serve-moe prefill_with_cache {tag} (capacity factor "
              f"{MOE_HANDOFF_CF}): {S} tokens in {1e3 * pf_s:.1f} ms "
              f"(chunked admission {1e3 * ck_s:.1f} ms), flash_attention "
              f"launches {launches['flash_attention']} by design {designs};"
              f" first-token logits max |diff| {logit:.4g} of their rms; "
              f"ring K/V max |diff| {kv:.4g} of their rms; "
              f"{MOE_HANDOFF_STEPS} teacher-forced decode steps: logits "
              f"max |diff| worst {max(steps):.4g} of their rms, mean "
              f"{sum(steps) / len(steps):.4g}; greedy tokens equal "
              f"{same}/{MOE_HANDOFF_STEPS}; tokens routed to another "
              f"expert set: {flipped} of {S} in some layer, by layer "
              f"{flips}")
        del eng, caches_pf, caches_ck
        return logit, kv, max(steps)
    logit16, _, step16 = handoffs(src.params, src.cache_dtype, "bf16")
    params32 = copy.deepcopy(src.params).float()
    got32 = handoffs(params32, torch.float32, "fp32")
    del params32
    torch.cuda.empty_cache()
    assert logit16 <= MOE_LOGIT_TOL and step16 <= MOE_LOGIT_TOL, \
        (logit16, step16)
    assert max(got32) <= MOE_FP32_TOL, got32


def moe_cell(device):
    """Phase ``serve-moe``: the batched ``int8_matmul``, ``quantize_rows``
    and ``paged_attention`` at the path's olmoe-1b-7b shapes, the precise
    gate product's fp32 output, small-config parity, the cell's serve run,
    the rung walk, the megastep and the ``prefill_with_cache`` handoff;
    device memory before, at peak and after. Returns (the serve run's
    launches, the batched ``int8_matmul`` rows)."""
    import gc

    import torch
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, t = {}, time.perf_counter()

    def done(name):
        nonlocal t
        secs[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
    i8_rows = check_int8_batched(device, olmoe_int8_shapes())
    assert [r["design"] for r in i8_rows] == ["B", "B", "A", "A"], i8_rows
    check_quantize(device, olmoe_quantize_shapes())
    check_paged(device, olmoe_paged_cases())
    check_moe_gate(device)
    done("kernels")
    moe_parity(device)
    done("parity")
    res, launches = moe_serve(device)
    done("serve")
    moe_walk(res, device)
    done("walk")
    moe_megastep(res, device)
    done("megastep")
    moe_handoff(res, device)
    done("handoff")
    print(f"serve-moe seconds: {secs}")
    del res                  # the engine and its runtime hold a cycle
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    print(f"serve-moe memory: before {before / 2 ** 30:.2f} GiB, peak "
          f"{peak / 2 ** 30:.2f} GiB, after {after / 2 ** 30:.2f} GiB")
    return launches, i8_rows


# ---------------------------------------------------------- train-encdec --

ENC_ARCH = "whisper-large-v3"     # full width and depth: 32 + 32 layers
ENC_BATCH, ENC_SEQ = 4, 448       # 4 x 448 decoder tokens over 1500 frames
ENC_STEPS = 8                     # the --pliant run and the resume check
ENC_PERIOD = 4                    # --ckpt-period
ENC_RUNGS = ["precise", "int8", "int8+kvstride2", "int8+drop50%"]
ENC_DECODE_ROWS, ENC_DECODE_LEN = 8, 64
ENC_WITNESS_LEN = 16              # the fp32 witness's steps
ENC_DECODE_TOL = {"bfloat16": 0.15, "float32": 1e-3}   # of the logits' rms
VLM_ARCH = "paligemma-3b"         # full width and depth: 18 layers
VLM_BATCH, VLM_TEXT = 2, 256      # 256 patch embeddings + 256 text tokens
VLM_STEPS = 3                     # steps a rung
RESUME_REL = 1e-6
# the checkpoints' depth: 2 encoder + 2 decoder layers at full width (4 +
# 4 until the train-encdec phase ran over the script's time limit). At
# full depth a checkpoint is 23.4 GB: two of them took ~80 s to copy and
# write on an H100's host, and a restore ~70 s more, which the script's
# time limit does not hold
RESUME_LAYERS = 2


def encdec_launches(remat):
    """Kernel launches of one training step of an encoder-decoder or a
    decoder-only config under ``remat``, as ``per_step(cfg, knobs)``: a
    forward runs every attention sublayer through ``flash_attention``
    (whisper's encoder, the decoder's self-attention and its cross
    attention), except a causal one under the stride knob
    (``_causal_chunked`` in plain PyTorch), and each MLP's three products
    on the int8 rungs; remat runs the forward again in the backward, and
    the backward takes each int8 product's sums once more, with
    ``quantize_rows`` for its two operands in each forward and for both in
    the backward."""
    fwd = 1 if remat == "none" else 2

    def per_step(cfg, knobs):
        causal = 0 if knobs.kv_keep_stride > 1 else 1
        if cfg.family == "encdec":
            mlps = cfg.n_encoder_layers + cfg.n_layers
            flash = cfg.n_encoder_layers + cfg.n_layers * (1 + causal)
        else:
            mlps, flash = cfg.n_layers, cfg.n_layers * causal
        int8 = knobs.matmul_precision == "int8"
        return {"ssd_scan": 0, "ssd_scan_backward": 0, "paged_attention": 0,
                "ring_hop": 0, "flash_attention": fwd * flash,
                "int8_matmul": 3 * mlps * (fwd + 1) if int8 else 0,
                "quantize_rows": 6 * mlps * (fwd + 1) if int8 else 0}
    return per_step


def encdec_flash_cases():
    """``flash_attention`` at the phase's shapes: whisper-large-v3's
    encoder (non-causal, 1500 frames = 11 x 128 + 92, 20 heads of 64), its
    decoder's causal self-attention (448 tokens) and cross attention (448
    queries over 1500 frames), the decode step's cross attention (8 rows,
    one query over 1500 frames), and paligemma-3b's MQA (8 heads of 256
    over one K/V head, 512 tokens), each in fp32 ("tiled") and bf16
    ("tc")."""
    import torch
    B, H = ENC_BATCH, 20
    F, T = 1500, ENC_SEQ
    out = []
    for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        tc = "tiled" if dt == torch.float32 else "tc"
        out += [dict(name=f"whisper-enc-{tag}", shape=(B, H, H, F, F, 64),
                     dtype=dt, causal=False, design=tc),
                dict(name=f"whisper-dec-{tag}", shape=(B, H, H, T, T, 64),
                     dtype=dt, design=tc),
                dict(name=f"whisper-cross-{tag}", shape=(B, H, H, T, F, 64),
                     dtype=dt, causal=False, design=tc),
                dict(name=f"whisper-cross-decode-{tag}",
                     shape=(ENC_DECODE_ROWS, H, H, 1, F, 64), dtype=dt,
                     causal=False, design=tc),
                dict(name=f"paligemma-{tag}",
                     shape=(VLM_BATCH, 8, 1, 2 * VLM_TEXT, 2 * VLM_TEXT, 256),
                     dtype=dt, design=tc)]
    return out


def encdec_int8_shapes():
    """The int8 rungs' MLP products: whisper-large-v3's encoder (4 x 1500
    rows, 1280 -> 5120 and 5120 -> 1280) and decoder (4 x 448 rows), and
    paligemma-3b's (2 x 512 rows, 2048 -> 16384 and 16384 -> 2048)."""
    return [(m, k, n) for m in (ENC_BATCH * 1500, ENC_BATCH * ENC_SEQ)
            for k, n in ((1280, 5120), (5120, 1280))] + [
        (2 * VLM_BATCH * VLM_TEXT, k, n)
        for k, n in ((2048, 16384), (16384, 2048))]


def encdec_quantize_shapes():
    """What those products quantise, fp32: the activations' rows and the
    weights as rows of ``w.t()``."""
    import torch
    f32 = torch.float32
    return [(m, k, f32) for m, k, _ in encdec_int8_shapes()] + [
        (n, k, f32) for _, k, n in encdec_int8_shapes()[:2]] + [
        (n, k, f32) for _, k, n in encdec_int8_shapes()[4:]]


def stacked_bound_ms(E, M, K, N, out_bytes=4):
    """The stacked product's bound: ``int8_matmul.work`` of E products
    without scales (the int32 sums as fp32)."""
    from repro_torch.kernels import int8_matmul
    return bound_ms(*int8_matmul.work(M, K, N, out_bytes, E=E,
                                      scales=False), INT8_OPS)


def check_int8_bmm_grads(device, E=OLMOE_EXPERTS, M=None, iters=10,
                         grad_experts=8):
    """The experts' stacked int8 product under autograd (``_QuantizedMatmul``)
    at olmoe-1b-7b's expert products (2048 -> 1024 and 1024 -> 2048, M = a
    256-token batch's capacity), ``grad_experts`` of them on the card
    against the CPU plain path (which takes seconds an expert): the
    forward bit for bit, the gradients of x and w with the same zero
    pattern and within 1e-4 of their largest entry (sums over N or M terms
    in other orders). The backward's exact sums for all ``E`` experts
    (``int8_acc``: one stacked ``int8_matmul`` launch, unit scales, fp32
    out) bit for bit against the plain version, timed beside it and the
    bound (library null: no single PyTorch call computes the stacked int8
    product)."""
    import numpy as np
    import torch
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ops
    M = M or moe_capacity(256)
    rows = []
    for K, N in OLMOE_PRODUCTS:
        rng = np.random.default_rng(K)
        x = torch.tensor(rng.normal(size=(E, M, K)), dtype=torch.float32)
        w = torch.tensor(rng.normal(size=(E, K, N)) * K ** -0.5,
                         dtype=torch.float32)
        g0 = torch.tensor(rng.normal(size=(grad_experts, M, N)),
                          dtype=torch.float32)
        out = []
        for d in (torch.device("cpu"), device):
            xs = x[:grad_experts].to(d).requires_grad_(True)
            ws = w[:grad_experts].to(d).requires_grad_(True)
            launches = i8.launches
            y = ops.quantized_matmul(xs, ws)
            gx, gw = torch.autograd.grad((y * g0.to(d)).sum(), (xs, ws))
            if d == device:
                assert i8.launches == launches + 2, i8.launches - launches
            out.append([t.detach().cpu() for t in (y, gx, gw)])
        (yc, gxc, gwc), (yd, gxd, gwd) = out
        assert torch.equal(yc, yd), max_err(yc, yd)
        errs = {}
        for name, a, b in (("x", gxd, gxc), ("w", gwd, gwc)):
            assert torch.equal(a != 0, b != 0), name
            errs[name] = max_err(a, b) / float(b.abs().max())
            assert errs[name] <= 1e-4, (name, errs[name])
        x_q, _ = ops.quantize_rows(x.to(device).reshape(E * M, K))
        w_t, _ = ops.quantize_weight(w.to(device))
        x_q = x_q.view(E, M, K)
        acc = ops.int8_acc(x_q, w_t)
        want = i8.int8_matmul_plain(x_q, 1.0, w_t.transpose(1, 2), 1.0,
                                    torch.float32)
        assert torch.equal(acc, want), max_err(acc, want)
        ms = timed(lambda: ops.int8_acc(x_q, w_t), device, iters)
        plain = timed(lambda: i8.int8_matmul_plain(
            x_q, 1.0, w_t.transpose(1, 2), 1.0, torch.float32), device, 3,
            warmup=1)
        bound, by = stacked_bound_ms(E, M, K, N)
        design = i8.select_design(M, N, K)
        rows.append(dict(E=E, M=M, K=K, N=N, design=design, ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by=by,
                         library_ms=None, max_abs_err=max_err(acc, want)))
        G = grad_experts
        print(f"stacked int8 backward E={E} M={M} K={K} N={N}: y "
              f"bit-equal ({G} experts), nonzero x-grads "
              f"{int((gxd != 0).sum())}/{G * M * K} w-grads "
              f"{int((gwd != 0).sum())}/{G * K * N} "
              f"(patterns equal), max_abs_err / max|ref| x={errs['x']:.3g} "
              f"w={errs['w']:.3g}; acc (design {design}) bit-equal, "
              f"ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bound:.4f} ({by})"
              f" library_ms=null")
    return rows


def check_flash_grads_memory(device, shape):
    """``FlashAttention``'s backward (the plain version's VJP, recomputed
    per block of 1024 query rows) at ``shape``, fp32 causal: its gradients
    against autograd through the plain version on the card, and the peak
    device memory the backward takes above its inputs."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, H, KVH, S, _, hd = shape
    ins = [t.requires_grad_(True) for t in flash_case(
        B, H, KVH, S, S, hd, torch.float32, device, seed=7)]
    go = torch.tensor(np.random.default_rng(8).normal(size=(B, H, S, hd)),
                      dtype=torch.float32, device=device)
    want = torch.autograd.grad(fa.flash_attention_plain(*ins), ins, go)
    out = fa.FlashAttention.apply(*ins, True, 0, 0.0, 1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = torch.autograd.grad(out, ins, go)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    rel = {n: max_err(g, w) / float(w.abs().max())
           for n, g, w in zip("qkv", got, want)}
    print(f"flash_attention backward B={B} H={H} KVH={KVH} S={S} hd={hd}: "
          f"grads vs autograd of the plain version, max_abs_err / max|ref| "
          + " ".join(f"{k}={v:.3g}" for k, v in rel.items())
          + f"; peak {extra:.1f} MiB above its inputs")
    assert max(rel.values()) <= 1e-5, rel
    return extra


def gib(nbytes):
    return round(nbytes / 2 ** 30, 2)


def memory_line(tag, before):
    import torch
    print(f"{tag} memory: before {gib(before)} GiB, peak "
          f"{gib(torch.cuda.max_memory_allocated())} GiB, after "
          f"{gib(torch.cuda.memory_allocated())} GiB")


def encdec_train(device):
    """whisper-large-v3 at full width and depth through
    ``launch/train.py`` under ``--pliant``, remat "full", launch counters
    zeroed just before and read just after, then each rung pinned. No
    ``--ckpt-dir``: the checkpoints are held in ``encdec_resume``, at full
    width and cut depth. Returns the run's result and launches."""
    import torch
    t = time.perf_counter()
    res, launches = train_full(
        device, ENC_ARCH, ENC_STEPS, ENC_BATCH, ENC_SEQ, ENC_RUNGS,
        encdec_launches("full"), remat="full")
    print(f"train {ENC_ARCH}: {time.perf_counter() - t:.1f}s for "
          f"{ENC_STEPS} steps (init included)")
    # one replayed step a rung, timed: every rung's graph is warm from
    # the run (2 eager steps a rung until the graphs)
    train_rung_walk(res, device, steps=1, skip=0,
                    per_step=encdec_launches("full"))
    torch.cuda.synchronize()
    return res, launches


def check_manifests(d, res, steps):
    """The checkpoints under ``d`` are those of ``steps``, and each
    manifest holds the state's leaf count and shapes and its step, and its
    stored optimizer step is its own."""
    import numpy as np
    from repro_torch.ckpt import checkpoint as ck
    assert ck.all_steps(d) == steps, (ck.all_steps(d), steps)
    like = ck.state_like((res["params"], res["opt"]), res["cfg"])
    leaves, n_params = ck.flatten(like), len(ck.flatten(like[0]))
    for step in steps:
        m = json.loads((d / f"step_{step}" / "manifest.json").read_text())
        assert m["step"] == step and m["n_leaves"] == len(leaves), m
        assert [tuple(x) for x in m["shapes"]] == \
            [x.shape for x in leaves], step
        with np.load(d / f"step_{step}" / "shard0.npz") as z:
            assert int(z[f"a{n_params}"]) == step, step


def encdec_resume(device, layers=RESUME_LAYERS):
    """A run of ``ENC_STEPS`` precise steps with ``--ckpt-dir`` and
    ``--ckpt-period ENC_PERIOD`` (the step-4 checkpoint written on a thread
    while steps 5-8 update the state in place; its manifests held by
    ``check_manifests``), then, its step-8
    checkpoint removed, ``--resume`` to ``ENC_STEPS`` from step 4 (both
    runs from the same seed), on whisper-large-v3 at full width cut to
    ``layers`` encoder and decoder layers (``depth_cut``; None: full
    depth): the resumed
    steps' losses within RESUME_REL relative of the uninterrupted run's;
    reported whether they are bit-equal, with each save's host copy and
    write and the restore's seconds."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.launch import train
    d2 = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    argv = ["--arch", ENC_ARCH, "--batch", str(ENC_BATCH), "--seq",
            str(ENC_SEQ), "--device", str(device), "--steps", str(ENC_STEPS),
            "--ckpt-dir", str(d2)]
    runs, secs, ckpt = [], [], []
    try:
        cut = dict(n_layers=layers, n_encoder_layers=layers) if layers \
            else {}
        with depth_cut(ENC_ARCH, **cut) as cfg:
            for extra in (["--ckpt-period", str(ENC_PERIOD)], ["--resume"]):
                if extra == ["--resume"]:
                    shutil.rmtree(d2 / f"step_{ENC_STEPS}")
                t = time.perf_counter()
                res = train.main(argv + extra, remat="full")
                secs.append(round(time.perf_counter() - t, 1))
                if extra != ["--resume"]:
                    check_manifests(d2, res, list(range(
                        ENC_STEPS, 0, -ENC_PERIOD)))
                runs.append((res["start_step"], list(res["losses"])))
                ckpt += res["ckpt_timings"]
                del res
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d2, ignore_errors=True)
    whole, resumed = runs
    assert resumed[0] == ENC_PERIOD, resumed[0]
    want = np.array(whole[1][ENC_PERIOD:])
    got = np.array(resumed[1])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"resume {ENC_ARCH} ({cfg.n_encoder_layers} + {cfg.n_layers} "
          f"layers, {gib(4 * 3 * cfg.param_count())} GiB of checkpoint): "
          f"uninterrupted losses "
          f"{[round(x, 6) for x in whole[1]]}, resumed from step "
          f"{resumed[0]}: {[round(x, 6) for x in resumed[1]]}, max rel "
          f"{rel:.3g}, bit-equal {bool(np.array_equal(got, want))}; run "
          f"seconds {secs} ({ENC_STEPS} steps + saves at {ENC_PERIOD} "
          f"and {ENC_STEPS}, restore + {ENC_STEPS - ENC_PERIOD} steps + "
          f"save); checkpoint seconds "
          f"{[{k: round(v, 1) for k, v in t.items()} for t in ckpt]}")
    assert rel <= RESUME_REL, (rel, got, want)
    return rel


def encdec_decode(device, params):
    """whisper-large-v3's one-token decode (``make_serve_step``: dense
    rings, the cross attention recomputed from ``enc_out`` every step) on
    ``ENC_DECODE_ROWS`` rows, teacher-forced over ``ENC_DECODE_LEN``
    tokens, against ``decode_hidden``'s full forward on the same tokens:
    each step's logits within ``ENC_DECODE_TOL`` of the full forward's rms
    at that position, in bf16 (a copy of ``params``) and, over the first
    ``ENC_WITNESS_LEN`` steps, in fp32 on ``params`` themselves (the
    witness: the step is exact up to fp32 sums). Each step timed with CUDA events around it (the host's launch
    gaps included: the step is synchronised by its check), the median of
    the bf16 steps beside the bound: the cross K/V of every layer over
    every frame are most of the work."""
    import numpy as np
    import torch
    from repro_torch.models import api, encdec
    from repro_torch.models.lm import logits_fn
    from repro_torch.configs import get_config
    from repro_torch.train.step import make_serve_step
    cfg = get_config(ENC_ARCH)
    B, T, F = ENC_DECODE_ROWS, ENC_DECODE_LEN, cfg.encoder_seq
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g).to(device)
    frames = torch.randn((B, F, cfg.d_model), generator=g).to(device)
    step = make_serve_step(cfg)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        if dt == torch.float32:
            p = params
        else:
            p = api.init(cfg, 0, dt, device)
            with torch.no_grad():
                for a, b in zip(p.parameters(), params.parameters()):
                    a.copy_(b)
        with torch.no_grad():
            enc_out = encdec.encode(p, frames, cfg, remat="none")
            full = logits_fn(p, encdec.decode_hidden(
                p, toks, enc_out, cfg, remat="none"), cfg)
            caches = encdec.init_caches(cfg, B, T, dtype=dt, device=device)
            worst, ms = 0.0, []
            for t in range(T if dt == torch.bfloat16 else ENC_WITNESS_LEN):
                pos = torch.full((B,), t, dtype=torch.int32, device=device)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                logits, caches = step(p, toks[:, t:t + 1], pos, caches,
                                      enc_out)
                b.record()
                ref = full[:, t]
                rms = float(ref.pow(2).mean().sqrt())
                err = max_err(logits, ref) / rms
                worst = max(worst, err)
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
        assert torch.isfinite(full).all() and worst <= ENC_DECODE_TOL[name], \
            (name, worst)
        out[name] = dict(worst=worst, ms=float(np.median(ms[1:])))
        print(f"decode {ENC_ARCH} {name}: {B} rows x {len(ms)} teacher-forced "
              f"steps, worst max|step - full| / rms {worst:.3g} (tol "
              f"{ENC_DECODE_TOL[name]}), median step {out[name]['ms']:.3f} "
              f"ms (first {ms[0]:.3f})")
        del p, enc_out, full, caches
        torch.cuda.empty_cache()
    L, d = cfg.n_layers, cfg.d_model
    flops = 2.0 * B * L * (2 * F * d * cfg.kv_dim       # cross K/V
                           + 2 * d * (cfg.q_dim + cfg.kv_dim) + 2 * d * d
                           + 3 * d * cfg.d_ff) + 2.0 * B * d * cfg.vocab_size
    nbytes = 2 * (L * (4 * d * d + 4 * d * cfg.kv_dim + 3 * d * cfg.d_ff)
                  + cfg.vocab_size * d) + 2 * L * B * F * d
    bound = 1e3 * max(flops / BF16_FLOPS, nbytes / HBM_BW)
    by = "operations" if flops / BF16_FLOPS > nbytes / HBM_BW else "bytes"
    out["bound_ms"], out["bound_by"] = bound, by
    print(f"decode {ENC_ARCH} bf16: {flops / 1e12:.3f} TFLOP a step, bound "
          f"{bound:.3f} ms ({by}), measured {out['bfloat16']['ms']:.3f} ms, "
          f"share of bound {bound / out['bfloat16']['ms']:.3f}")
    return out


def vlm_train(device):
    """paligemma-3b at full width and depth: ``launch/train.py`` one
    precise step at 2 x (256 + 256) tokens, remat "full", launch counters
    zeroed just before and read just after; then ``VLM_STEPS`` steps on
    each rung pinned by ``table.executable(i)`` (median step time, peak
    memory, launches a step); then ``make_prefill_fn`` in bf16 on the same
    batch shape: logits finite, one ``flash_attention`` launch of design
    "tc" a layer (hd 256), none "simple". Returns the run's launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.launch.train import extra_inputs
    from repro_torch.models import api
    from repro_torch.train.step import make_prefill_fn
    per_step = encdec_launches("full")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    res = train.main(["--arch", VLM_ARCH, "--steps", "1", "--batch",
                      str(VLM_BATCH), "--seq", str(VLM_TEXT), "--device",
                      str(device)], remat="full")
    launches = card_launches(res["steps"])
    cfg = res["cfg"]
    int8_designs(f"train {VLM_ARCH}")
    flash_designs(f"train {VLM_ARCH}", cfg)
    assert np.isfinite(res["losses"]).all(), res["losses"]
    assert launches == per_step(cfg, res["table"].variants[0].knobs), \
        launches
    print(f"train {VLM_ARCH}: 1 step batch {VLM_BATCH} x ({cfg.n_prefix_tokens}"
          f" + {VLM_TEXT}) remat full in {time.perf_counter() - t:.1f}s "
          f"(init included), loss {res['losses']}, peak "
          f"{gib(torch.cuda.max_memory_allocated())} GiB, launches "
          f"{launches}")
    walk = train_rung_walk(res, device, steps=VLM_STEPS, per_step=per_step)
    params = res["params"]
    del res
    p16 = api.init(cfg, 0, torch.bfloat16, device)
    with torch.no_grad():
        for a, b in zip(p16.parameters(), params.parameters()):
            a.copy_(b)
    del params
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (VLM_BATCH, VLM_TEXT + 1),
                                     generator=g).to(device),
             **{k: v.to(torch.bfloat16) for k, v in extra_inputs(
                 cfg, VLM_BATCH, 0, 0, device).items()}}
    prefill = make_prefill_fn(cfg, remat="none")
    with torch.no_grad():
        reset_launches()
        logits = prefill(p16, batch)
        torch.cuda.synchronize()
        n = read_launches()["flash_attention"]
        designs = dict(fa.design_launches)
        ms = timed(lambda: prefill(p16, batch), device, 3, warmup=1)
    assert logits.shape == (VLM_BATCH, cfg.vocab_size), logits.shape
    assert torch.isfinite(logits).all()
    assert n == cfg.n_layers and designs["tc"] == n \
        and designs["simple"] == 0, (n, designs)
    print(f"prefill {VLM_ARCH} bf16: logits {tuple(logits.shape)} finite, "
          f"{n} flash_attention launches by design {designs}, {ms:.2f} ms")
    del p16
    torch.cuda.empty_cache()
    return launches, walk


def encdec_cell(device):
    """Phase ``train-encdec``: ``flash_attention``, ``int8_matmul`` and
    ``quantize_rows`` at the phase's shapes, the experts' stacked int8
    backward, flash's backward memory at hd 256, whisper and paligemma
    smoke parity on the card against the CPU, whisper-large-v3 training
    and its rungs, its decode, the checkpoints and the resume check, then
    paligemma-3b training and prefill; device memory before, at peak and
    after each run. Returns (whisper's launches, paligemma's launches,
    flash rows, int8 rows, stacked backward rows)."""
    import gc

    import torch
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    secs, t = {}, time.perf_counter()

    def done(name):
        nonlocal t
        secs[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
    fa_rows = check_flash(device, encdec_flash_cases(), iters=5)
    done("flash")
    i8_rows = check_int8(device, encdec_int8_shapes(), iters=10)
    check_quantize(device, encdec_quantize_shapes(), iters=10)
    done("int8")
    bmm_rows = check_int8_bmm_grads(device)
    check_flash_grads_memory(device, (VLM_BATCH, 8, 1, 2 * VLM_TEXT,
                                      2 * VLM_TEXT, 256))
    done("grads")
    check_train_parity(device, "whisper-large-v3-smoke",
                       per_step=encdec_launches("none"))
    check_train_parity(device, "paligemma-3b-smoke",
                       per_step=encdec_launches("none"))
    done("parity")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, enc_launches = encdec_train(device)
    memory_line(f"train {ENC_ARCH}", before)
    done("train")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    encdec_decode(device, res["params"])
    memory_line(f"decode {ENC_ARCH}", before)
    done("decode")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    encdec_resume(device)
    memory_line(f"resume {ENC_ARCH}", before)
    done("resume")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vlm_launches, _ = vlm_train(device)
    memory_line(f"train {VLM_ARCH}", before)
    done("vlm")
    drop_int8_weights()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train-encdec seconds: {secs}")
    return enc_launches, vlm_launches, fa_rows, i8_rows, bmm_rows


# ------------------------------------------------------------------ main --

# ------------------------------------------------------------- train-pod --

POD_ARCH = "mamba2-780m"          # full width, TRAIN_LAYERS of its 48 layers
POD_MESH = (2, 2)                 # (pod, data): 4 positions on the card
POD_SHAPE = (4, 1024)             # batch, seq
POD_STEPS = 6                     # steps a rung (precise: POD_CHAOS_STEPS)
POD_CHAOS = "revoke@3:2,restore@6"
POD_CHAOS_STEPS = 8
POD_REL = 1e-6                    # mesh vs single device, and the syncs
POD_REF_REL = 1e-6                # the graph's region vs the per-position form
# the explorer's collective-term factors (core/explorer.py analytic_cost):
# gint8 f_coll *= 0.3, sync/k f_coll /= k
POD_PRICE = {"gint8": 0.3, "sync/2": 0.5}


def rel_gap(a, b):
    """max |a - b| over max |b| (0 where both are 0)."""
    den = float(b.abs().max())
    num = float((a.float() - b.float()).abs().max())
    return num / den if den else num


def worst_rel(got, want):
    return max(rel_gap(a, b) for a, b in zip(got, want))


def pod_rungs(cfg):
    """The train-pod rungs: the explorer's training table at
    ``POD_SHAPE`` (precise, int8, int8+drop12%, int8+drop50%), then
    ``gint8`` and ``sync/2``, forced by name as the JAX dry-run resolves
    them: the analytic explorer prices the collective term at 0.3 of the
    compute term, so its tables never hold them."""
    from repro_torch.approx.knobs import ApproxKnobs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.explorer import explore
    table = explore(cfg, ShapeConfig("cli", POD_SHAPE[1], POD_SHAPE[0],
                                     "train"), serving=False, max_variants=4)
    knobs = [v.knobs for v in table.variants] + [
        ApproxKnobs(grad_compress="int8"), ApproxKnobs(sync_period=2)]
    names = [k.describe() for k in knobs]
    assert names == ["precise", "int8", "int8+drop12%", "int8+drop50%",
                     "gint8", "sync/2"], names
    return list(zip(names, knobs))


def pod_int8_reference(grads, cfg, mesh):
    """``grads`` through the int8 pod mean in its general per-position
    form: the leaves stacked over the layer groups as the JAX package
    stacks them (``convert.jax_path``: one scale a stacked leaf), cut into
    each position's blocks (``collectives.shard``), each position's int8
    payload and scale materialised and the group's dequantised mean taken
    (``compressed_pmean``), then reassembled and unstacked. The reference
    for ``gint8``'s update: ``grad_sync`` computes that mean once a leaf,
    from the copies being alike."""
    import torch
    from repro_torch.convert import jax_path
    from repro_torch.dist import collectives
    groups = {}
    for k in grads:
        path, i = jax_path(k, cfg)
        groups.setdefault("/".join(path), []).append((i or 0, k))
    stacked = {p: torch.stack([grads[k] for _, k in sorted(m)])
               for p, m in groups.items()}
    got = collectives.unshard(collectives.compressed_pmean(
        collectives.shard(stacked, mesh), mesh, "pod"), mesh, stacked)
    out = {k: got[p][j] for p, m in groups.items()
           for j, (_, k) in enumerate(sorted(m))}
    return {k: out[k] for k in grads}


def train_pod(device):
    """The colocated approximate co-runner trained data-parallel across
    pods: mamba2-780m at full width (``TRAIN_LAYERS`` layers), fp32 and
    AdamW, 4 x 1024 tokens, on a (pod 2, data 2) mesh of the card. Each
    rung one CUDA graph (the gradient-sync region inside it), ``POD_STEPS``
    steps from the same state and batches; precise also without the mesh.
    Gates: (a) precise on the mesh equals the single-device step (losses
    equal, params within ``POD_REL``); (b) sync/2's graph holds no pod
    collective and its params after ``pod_sync`` at step 2 equal
    precise's; (c) gint8's params after a step within the JAX test's rtol
    0.02 / atol 1e-4 of precise's, and within ``POD_REF_REL`` of the
    update from the same gradients through ``pod_int8_reference``; (d)
    no host sync in a replay. Then ``launch/train.main --pod-mesh --chaos
    POD_CHAOS``: its losses equal the mesh run's. Returns the launches and
    the wire bytes a position of ``DRY_POD``'s rungs sends a step, and of
    the pod sync, by axis (the dryrun phase's gate)."""
    import numpy as np
    import torch
    from repro_torch.approx.knobs import PRECISE
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.train import optim
    from repro_torch.train import step as step_mod

    base = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(POD_ARCH), n_layers=TRAIN_LAYERS)
    B, S = POD_SHAPE
    mesh = make_mesh(POD_MESH, ("pod", "data"), device)
    # launch/train.main's schedule at --steps POD_CHAOS_STEPS
    opt_cfg = optim.OptConfig(lr=1e-3, warmup=20,
                              total_steps=POD_CHAOS_STEPS)
    params = api.init(cfg, 0, torch.float32, device)
    opt = optim.init_opt(params)
    state = step_mod.state_tensors(params, opt)
    pristine = [t.detach().clone() for t in state]
    src = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=0))
    batches = [{"tokens": torch.as_tensor(src.batch(i), device=device)}
               for i in range(POD_CHAOS_STEPS)]
    pool = torch.cuda.graph_pool_handle()
    runs, steps = {}, []

    def reset():
        with torch.no_grad():
            for t, t0 in zip(state, pristine):
                t.copy_(t0)
        return opt._replace(step=0)

    def snap():
        return [p.detach().clone() for p in params.parameters()]

    def run(name, knobs, m, n, keep=()):
        nonlocal opt
        opt = reset()
        step = step_mod.graphed_train_step(step_mod.make_train_step(
            cfg, knobs, opt_cfg=opt_cfg, remat="none", mesh=m), device, pool)
        steps.append(step)
        losses, times, snaps, sync_s, sync_wire = [], [], {}, [], {}
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, opt, met = step(params, opt, batches[i])
            losses.append(float(met["loss"]))
            times.append(time.perf_counter() - t0)
            if knobs.sync_period > 1 and (i + 1) % knobs.sync_period == 0:
                mark = collectives.WIRE.mark()
                t0 = time.perf_counter()
                step_mod.pod_sync(params, m)
                torch.cuda.synchronize()
                sync_s.append(time.perf_counter() - t0)
                sync_wire = collectives.WIRE.by_axis(mark)
            if i + 1 in keep:
                snaps[i + 1] = snap()
        runs[name] = dict(step=step, losses=losses, times=times, snaps=snaps,
                          ms=1e3 * float(np.median(times[1:])),
                          sync_ms=1e3 * float(np.median(sync_s))
                          if sync_s else 0.0, sync_wire=sync_wire,
                          n=n, knobs=knobs)
        return runs[name]

    # (c)'s reference is built from the first step's gradients (the eager
    # step, which the graphs equal bit for bit) after the rungs
    eager = step_mod.make_train_step(cfg, PRECISE, opt_cfg=opt_cfg,
                                     remat="none")
    params.requires_grad_(True)
    out = eager._grad(params, batches[0])
    params.requires_grad_(False)
    grads = out[2]
    del out     # its metrics hold the autograd graph, which a capture
    # must not find alive

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run("single-device precise", PRECISE, None, POD_CHAOS_STEPS,
        keep=(1, 2, POD_CHAOS_STEPS))
    for name, knobs in pod_rungs(cfg):
        n = POD_CHAOS_STEPS if name == "precise" else POD_STEPS
        keep = {"precise": (1, 2, n), "gint8": (1,), "sync/2": (2,)}
        run(name, knobs, mesh, n, keep.get(name, ()))
    # (d) one more replayed step of each new path under the profiler
    syncs = {}
    for name in ("precise", "gint8", "sync/2"):
        got = []
        syncs[name] = host_syncs(lambda: got.append(
            runs[name]["step"](params, opt, batches[0])))
        float(got[0][2]["loss"])
        runs[name]["n"] += 1
    del got
    launches = card_launches(steps)
    want = dict.fromkeys(COUNTERS, 0)
    for r in runs.values():
        for k, c in mamba_launches(cfg, r["knobs"]).items():
            want[k] += r["n"] * c
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30

    one, prec = runs["single-device precise"], runs["precise"]
    # (a) the region is the identity on gradients of the whole batch
    gap_a = worst_rel(prec["snaps"][POD_CHAOS_STEPS],
                      one["snaps"][POD_CHAOS_STEPS])
    # (b) sync/2: no pod collective in its graph; the sync restores
    # precise's params
    wire = {n: r["step"].stats["wire"] for n, r in runs.items()}
    gap_b = worst_rel(runs["sync/2"]["snaps"][2], prec["snaps"][2])
    # (c) gint8 after one step: within the JAX test's bound of precise,
    # and the update from the region computed on the CPU
    close_c = all(torch.allclose(a, b, rtol=0.02, atol=1e-4) for a, b in
                  zip(runs["gint8"]["snaps"][1], prec["snaps"][1]))
    gap_c_prec = worst_rel(runs["gint8"]["snaps"][1], prec["snaps"][1])
    runs_sync_wire = runs["sync/2"]["sync_wire"]
    for name in runs:
        runs[name]["step"].release()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reduced = pod_int8_reference(grads, cfg, mesh)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    opt = reset()
    optim.adamw_update(reduced, opt, params, opt_cfg)
    del reduced, grads
    gap_c_ref = worst_rel(runs["gint8"]["snaps"][1], snap())

    for name, r in runs.items():
        st = r["step"].stats
        extra = (f", pod_sync {r['sync_ms']:.2f} ms every "
                 f"{r['knobs'].sync_period} steps, its wire "
                 f"{r['sync_wire']}" if r["sync_ms"] else "")
        print(f"train-pod {name}: replayed {r['ms']:.1f} ms a step "
              f"(range {1e3 * min(r['times'][1:]):.1f}-"
              f"{1e3 * max(r['times'][1:]):.1f}, first "
              f"{1e3 * r['times'][0]:.1f}); {r['ms'] / one['ms']:.3f}x the "
              f"single-device step; wire a step {st['wire']} bytes a "
              f"position; capture {st['capture_s']:.3f} s after a "
              f"{st['warmup_s']:.3f} s warm-up, pool "
              f"{gib(st['pool_bytes'])} GiB; losses "
              f"{[round(x, 6) for x in r['losses']]}{extra}")

    def total(w):
        return sum(w.values())
    p_pod, p_all = wire["precise"]["pod"], total(wire["precise"])
    g_pod = wire["gint8"]["pod"]
    s_pod = runs["sync/2"]["sync_wire"]["pod"] / 2
    ratios = {"gint8": (g_pod / p_pod, (total(wire["gint8"])) / p_all),
              "sync/2": (s_pod / p_pod,
                         (total(wire["sync/2"]) + s_pod) / p_all)}
    for name, (pod_r, all_r) in ratios.items():
        print(f"train-pod {name}: pod wire {pod_r:.4f}x precise's, all "
              f"collectives {all_r:.4f}x (the explorer prices "
              f"{POD_PRICE[name]})")
    print(f"train-pod gates: (a) mesh vs single device max rel "
          f"{gap_a:.3g}, losses equal "
          f"{prec['losses'] == one['losses']}; (b) sync/2 wire {wire['sync/2']}"
          f", after pod_sync at step 2 max rel {gap_b:.3g}; (c) gint8 vs "
          f"precise after one step max rel {gap_c_prec:.3g} (within rtol "
          f"0.02 / atol 1e-4: {close_c}), vs the per-position form's "
          f"update {gap_c_ref:.3g} (that form {ref_s:.2f} s); (d) host "
          f"syncs in "
          f"a replay {syncs}; peak {peak:.2f} GiB allocated, {reserved:.2f} "
          f"reserved; launches {launches}")
    assert prec["losses"] == one["losses"], (prec["losses"], one["losses"])
    assert gap_a <= POD_REL, gap_a
    assert set(wire["precise"]) == {"data", "pod"}, wire
    assert "pod" not in wire["sync/2"] and "data" in wire["sync/2"], wire
    assert gap_b <= POD_REL, gap_b
    assert close_c, gap_c_prec
    assert gap_c_ref <= POD_REF_REL, gap_c_ref
    assert all(n == 0 for n in syncs.values()), syncs
    assert launches == want, (launches, want)
    mesh_losses = prec["losses"]
    del runs, one, prec, r, steps, state, pristine, params, opt
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < base + 2 ** 30, \
        (torch.cuda.memory_allocated(), base)

    # the driver's elastic restore on the same mesh, precise
    from repro_torch.launch import train
    argv = ["--arch", POD_ARCH, "--steps", str(POD_CHAOS_STEPS), "--batch",
            str(B), "--seq", str(S), "--pod-mesh", "--positions",
            str(POD_MESH[0] * POD_MESH[1]), "--chaos", POD_CHAOS,
            "--device", str(device)]
    reset_launches()
    with depth_cut(POD_ARCH, n_layers=TRAIN_LAYERS):
        res = train.main(argv)
    chaos_launches = card_launches(res["all_steps"])
    gap = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                   mesh_losses))
    print(f"train-pod chaos {POD_CHAOS}: re-homes "
          + ", ".join(f"{r['mesh']} in {r['seconds']:.3f} s" for r in
                      res["rehomes"])
          + f"; final mesh {dict(res['mesh'].shape)}; step_s "
          f"{[round(x, 3) for x in res['step_s']]}; losses "
          f"{[round(x, 6) for x in res['losses']]} against the unfaulted "
          f"mesh run's (max rel {gap:.3g}); launches {chaos_launches}")
    assert [r["mesh"] for r in res["rehomes"]] == ["1x2", "2x2"], \
        res["rehomes"]
    assert gap <= POD_REL, (res["losses"], mesh_losses)
    want = {k: sum(mamba_launches(cfg, PRECISE)[k] for _ in range(
        POD_CHAOS_STEPS)) for k in COUNTERS}
    assert chaos_launches == want, (chaos_launches, want)
    del res
    torch.cuda.empty_cache()
    pod_wire = {"steps": {n: wire[n] for n in DRY_POD},
                "sync": runs_sync_wire}
    return {k: launches[k] + chaos_launches[k] for k in COUNTERS}, pod_wire


# ---------------------------------------------------------------- dryrun --

# the production cells traced on meta (the JAX package's dry-run cells)
DRY_CELLS = (("mamba2-780m", "train_4k", "pod", "precise"),
             ("mamba2-780m", "train_4k", "pod", "int8"),
             ("phi4-mini-3.8b", "decode_32k", "pod", "precise"),
             ("olmoe-1b-7b", "train_4k", "pod", "precise"))
DRY_RUNGS = ("precise", "int8")        # the card-held cell's rungs
DRY_POD = ("precise", "gint8", "sync/2")
DRY_PEAK_REL = 0.02     # predicted peak vs max_memory_allocated (see
#                         CHANGES.md: set from the first card run)
DRY_WORKERS = 2         # processes tracing on meta beside the card phases


def dry_cell():
    """The train phase's cell: mamba2-780m at ``TRAIN_LAYERS`` of its 48
    layers, 4 x 1024 tokens (fp32 + AdamW, remat none, one position)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    return (dataclasses.replace(get_config("mamba2-780m"),
                                n_layers=TRAIN_LAYERS),
            ShapeConfig("train-cell", 1024, 4, "train"))


def dry_knobs(name):
    from repro_torch.approx.knobs import ApproxKnobs
    from repro_torch.launch import dryrun
    if name == "sync/2":
        return ApproxKnobs(sync_period=2)
    return dryrun.VARIANTS[name]


def dry_job(kind, *args):
    """One meta trace of the dryrun phase, run in a worker process
    (nothing in it touches CUDA); returns what it measured and the lines
    it printed."""
    import io
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if kind == "cell":
            res = dryrun.run_cell(*args, write=False)
        elif kind == "podsync":
            res = dryrun.run_pod_sync(args[0], compress=args[1],
                                      write=False)
        elif kind == "card":
            cfg, shape = dry_cell()
            res = dryrun.trace_cell(
                cfg, shape, make_mesh((1, 1), ("data", "model"), "meta"),
                dry_knobs(args[0]), remat="none", dtype=torch.float32)
        elif kind == "pod":
            cfg, shape = dry_cell()
            mesh = make_mesh(POD_MESH, ("pod", "data"), "meta")
            res = dryrun.trace_cell(cfg, shape, mesh, dry_knobs(args[0]),
                                    policy="replicated", remat="none",
                                    dtype=torch.float32)
            if args[0] == "sync/2":
                res["pod_sync"] = dryrun.run_pod_sync(
                    cfg.name, compress=False, cfg=cfg, mesh=mesh,
                    policy="replicated", dtype=torch.float32,
                    write=False)["wire"]
        else:       # the serve cell's pricing
            from repro_torch.configs import get_config
            from repro_torch.core.explorer import decode_kv_share, explore
            from repro_torch.configs.base import ShapeConfig
            cfg = dataclasses.replace(get_config("phi4-mini-3.8b"),
                                      n_layers=SERVE_LAYERS)
            slots, max_len, occ = args
            t0 = time.time()
            share = decode_kv_share(cfg, slots, max_len)
            secs = time.time() - t0
            shape = ShapeConfig("serve", max_len, slots, "decode")
            res = dict(kv_share=share, trace_s=secs, tables={
                name: [(v.name, v.rel_time) for v in explore(
                    cfg, shape, serving=True, page_occupancy=occ,
                    kv_share=ks).variants]
                for name, ks in (("priced", share), ("fallback", None))})
    return res, out.getvalue()


def dry_start():
    """Start the dryrun phase's meta traces in ``DRY_WORKERS`` spawned
    processes, to run beside the card's phases: (pool, {key: future})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    # the serve phase's paged driver: occupancy (prompt 64 + 16 new) / 1024
    keys = ([("cell",) + c for c in DRY_CELLS]
            + [("podsync", "mamba2-780m", False),
               ("podsync", "mamba2-780m", True)]
            + [("card", r) for r in DRY_RUNGS]
            + [("pod", r) for r in DRY_POD]
            + [("serve", 8, 1024, min(1.0, (64 + 16) / 1024))])
    pool = ProcessPoolExecutor(
        DRY_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return pool, {k: pool.submit(dry_job, *k) for k in keys}


def dry_card_step(device, rung):
    """One eager step of the card-held cell on the card under the counting
    mode, the dry-run's own program (``dryrun.train_step``) on a (1, 1)
    mesh of the card: (mode, argument bytes, peak bytes over the step,
    launches)."""
    import torch
    from repro_torch import cost
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.train import optim
    cfg, shape = dry_cell()
    cell = dryrun.Cell(cfg, shape, make_mesh((1, 1), ("data", "model"),
                                             device),
                       dry_knobs(rung), remat="none", dtype=torch.float32)
    params = api.init(cfg, 0, torch.float32, device)
    opt = optim.init_opt(params)
    batch = cell.inputs(device)
    step = dryrun.train_step(cell)
    sched = optim.schedule_on(step.opt_cfg, 0, device)
    state = (list(params.parameters()) + list(opt.m.values())
             + list(opt.v.values()) + list(batch.values()))
    args = cost.storage_bytes(state) + 4       # + the int32 step counter
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    mode = dryrun.count_train(cell, step, params, opt, batch, sched)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    float(mode.metrics["loss"])
    del mode.metrics, params, opt, batch, state
    return mode, args, peak, launches


def dryrun_cell(device, futs, walk, pod_wire):
    """The dry-run on the card's machine: the production cells traced on
    meta (their one-line summaries and trace seconds); the train phase's
    cell traced on meta and counted around one eager step on the card,
    precise and int8, held equal (FLOPs, bytes, kernel records, the op
    table, argument bytes) and the predicted peak within ``DRY_PEAK_REL``
    of ``max_memory_allocated``, with ``roofline_fraction`` against the
    train phase's replayed step (``walk``); the train-pod cell's owned
    wire bytes equal to what ``WIRE`` recorded there (``pod_wire``); the
    serve cell's ``decode_kv_share`` beside its table's rel_times. Returns
    the card steps' launches."""
    import torch
    from repro_torch import roofline
    from repro_torch.launch import dryrun
    got = {}
    for key, fut in futs.items():
        res, text = fut.result()
        got[key] = res
        if key[0] in ("cell", "podsync"):
            print(f"dryrun {text.strip()}")
    launches = dict.fromkeys(COUNTERS, 0)
    cfg, shape = dry_cell()
    for rung in DRY_RUNGS:
        meta = got[("card", rung)]
        mode, args, peak, ran = dry_card_step(device, rung)
        for k, n in ran.items():
            launches[k] += n
        want = mamba_launches(cfg, dry_knobs(rung))
        card_ops = {k: list(v) for k, v in sorted(mode.by_op.items())}
        card_k = [list(k) for k in mode.kernels]
        diff = sorted(k for k in set(card_ops) | set(meta["ops"])
                      if card_ops.get(k) != meta["ops"].get(k))
        knobs = dry_knobs(rung)
        mf = roofline.model_flops(cfg, shape, knobs)
        terms = roofline.terms_from_artifact(
            meta, mf, 1, dryrun.compute_kind(knobs, torch.float32))
        step_ms = walk[rung]["captured"]["step_ms"]
        measured = mf / roofline.PEAK_FP32_FLOPS / (step_ms / 1e3)
        rel = abs(meta["temp_bytes"] - peak) / peak
        print(f"dryrun card {cfg.name} ({cfg.n_layers} layers) {rung}: "
              f"flops meta {meta['flops']:.6e} card {mode.flops:.6e}; "
              f"bytes meta {meta['bytes_accessed']:.6e} card "
              f"{mode.bytes_accessed:.6e}; kernels {mode.kernel_summary()}"
              f" ({len(card_k)} records, equal "
              f"{card_k == meta['kernel_records']}); ops differing "
              f"{diff}; argument bytes meta {meta['argument_bytes']} card "
              f"{args}; peak over the step meta {gib(meta['temp_bytes'])} "
              f"GiB, card max_memory_allocated {gib(peak)} GiB (rel "
              f"{rel:.4f}, the counting mode's own {gib(mode.peak_bytes)});"
              f" roofline_fraction predicted {terms.roofline_fraction:.4f}"
              f" ({terms.dominant}-bound, {1e3 * terms.bound_s:.1f} ms), "
              f"measured {measured:.4f} (model flops {mf:.4e} at the fp32 "
              f"peak over the replayed {step_ms:.1f} ms); trace "
              f"{meta['trace_s']} s; launches {ran}")
        assert mode.flops == meta["flops"] and \
            mode.bytes_accessed == meta["bytes_accessed"], rung
        assert card_k == meta["kernel_records"] and not diff, (rung, diff)
        assert args == meta["argument_bytes"], (args, meta["argument_bytes"])
        assert rel <= DRY_PEAK_REL, (meta["temp_bytes"], peak)
        assert ran == want, (ran, want)
        del mode
        torch.cuda.empty_cache()
    for rung in DRY_POD:
        meta = got[("pod", rung)]
        card = pod_wire["steps"][rung]
        wire = {}
        for key, b in meta["wire"].items():
            axis = key.split("/")[0]
            wire[axis] = wire.get(axis, 0.0) + b
        line = (f"dryrun train-pod {rung}: wire a position meta {wire}, "
                f"WIRE in the train-pod phase {card}")
        assert wire == card, (rung, wire, card)
        if rung == "sync/2":
            sync = {k.split("/")[0]: b for k, b in meta["pod_sync"].items()}
            line += (f"; pod_sync meta {sync}, WIRE "
                     f"{pod_wire['sync']}")
            assert sync == pod_wire["sync"], (sync, pod_wire["sync"])
        print(line)
    serve = got[("serve", 8, 1024, min(1.0, (64 + 16) / 1024))]
    print(f"dryrun serve phi4-mini-3.8b ({SERVE_LAYERS} layers, 8 slots, "
          f"max_len 1024): decode_kv_share {serve['kv_share']:.4f} (traced "
          f"in {serve['trace_s']:.2f} s); the paged driver's table priced "
          f"from it {serve['tables']['priced']}, at the 0.5 fallback "
          f"{serve['tables']['fallback']}")
    return launches


# -------------------------------------------------------------- train-ep --

EP_ARCH = "olmoe-1b-7b"           # full width: 64 experts, top-8
EP_LAYERS = 2                     # of its 16 layers
EP_MESH = (2, 4)                  # (data, model): experts over model
EP_SHAPE = (8, 512)               # batch, seq: 4096 tokens, 512 a position
EP_STEPS = 4                      # steps a path: warm-up, capture, replays
EP_CF8 = 8.0                      # the JAX test's capacity factor
EP_OUT_ATOL = 1e-5                # EP against the plain EP version
EP_AUX_REL = 1e-5                 # its aux loss
EP_GRAD_REL = 2e-5                # its gradients (max |diff| / max |plain|)
# the whole model's int8 gradients, EP against local: the share of entries
# that may miss rtol 1e-4 / atol 2e-4. The first layer's outputs differ in
# their last bits (its sums run in another order), which flips a few int8
# codes of the second layer's inputs and moves that layer's gradients by
# an int8 step; the layer-level gate, on equal inputs, holds the experts'
# int8 backward a shard to every entry
EP_INT8_OUTSIDE = 1e-6


def plain_ep(params, x2, cfg, mesh_shape):
    """Expert parallelism's function written plainly from its definition,
    independent of ``models/moe.py``: the tokens cut into one equal block
    a position; each block routed on its own (the softmax of x @ wg in
    fp32, the top k, the gates renormalised; each expert's entries kept in
    token order up to the block's capacity, ``int(cf * T_block * k / E)``
    rounded up to 8); each kept entry's expert applied to its token's row,
    gate-weighted; a block's aux loss E * sum(mean probability x share of
    the entries), averaged over the blocks. No buffers and no exchange;
    differentiable. Returns (y (T, D), keep masks a position, aux)."""
    import math

    import torch
    import torch.nn.functional as F
    n = math.prod(mesh_shape)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    T, D = x2.shape
    t_loc = T // n
    c = int(cfg.moe.capacity_factor * t_loc * k / E)
    C = max(8, -(-c // 8) * 8)
    ys, keeps, auxes = [], [], []
    for p in range(n):
        xp = x2[p * t_loc:(p + 1) * t_loc]
        probs = torch.softmax((xp @ params.wg).float(), dim=-1)
        top, ids = torch.topk(probs, k, dim=-1)
        gate = (top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
                ).to(xp.dtype)
        keep = torch.zeros(ids.shape, dtype=torch.bool, device=xp.device)
        yp = torch.zeros_like(xp)
        for e in range(E):
            tok, j = torch.nonzero(ids == e, as_tuple=True)   # token order
            tok, j = tok[:C], j[:C]
            if not len(tok):
                continue
            keep[tok, j] = True
            rows = xp[tok]
            h = F.silu(rows @ params.wi_gate[e]) * (rows @ params.wi_up[e])
            yp = yp.index_add(0, tok, (h @ params.wo[e]) * gate[tok, j, None])
        share = torch.bincount(ids.reshape(-1), minlength=E).float() / ids.numel()
        auxes.append(E * torch.sum(probs.mean(0) * share))
        ys.append(yp)
        keeps.append(keep)
    return torch.cat(ys), keeps, torch.stack(auxes).mean()


def train_ep(device):
    """MoE training with the experts spread over the model axis:
    olmoe-1b-7b at full width, ``EP_LAYERS`` layers, fp32, on a (data 2,
    model 4) mesh of the card, ``ep_axis="model"``, 8 x 512 tokens (512 a
    position). Gates: (a) at capacity factor 8 EP's cross-entropy and its
    gradients equal the local MoE's within the JAX test's rtol 2e-4 / atol
    2e-5 (the aux term left out: under EP the aux loss is a per-shard
    statistic, which (b) holds), and on the int8 rung the cross-entropy
    within 1e-4 and the gradients within 1e-4 relative / 2e-4 absolute
    but for a share ``EP_INT8_OUTSIDE`` of the entries; (b) on one MoE layer's inputs at capacity factor 8, the int8
    gradients (the experts' int8 backward a shard) within 1e-4 relative /
    2e-4 absolute of the local int8 MoE's; at the
    config's capacity factor one MoE layer's keep masks equal those of
    ``plain_ep`` on the same inputs, its output within ``EP_OUT_ATOL``,
    its aux loss within ``EP_AUX_REL``, and the gradients of the output's
    projection plus 0.01 x the aux loss to the input, the router and the
    experts within ``EP_GRAD_REL`` of ``plain_ep``'s; (c) on the int8 rung
    one ``int8_matmul`` launch an expert shard a product in a forward. Then
    the train step local and EP, precise and int8, each one CUDA graph
    (``EP_STEPS`` steps): ms a step, tokens dropped a shard, the
    exchange's bytes. Returns the launches of those steps."""
    import numpy as np
    import torch
    from repro_torch.approx.knobs import PRECISE, ApproxKnobs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import optim
    from repro_torch.train import step as step_mod

    cfg = dataclasses.replace(get_config(EP_ARCH), n_layers=EP_LAYERS)
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=EP_CF8))
    B, S = EP_SHAPE
    mesh = make_mesh(EP_MESH, ("data", "model"), device)
    n_pos = EP_MESH[0] * EP_MESH[1]
    params = api.init(cfg, 0, torch.float32, device)
    src = SyntheticLM(DataConfig(cfg.vocab_size, S, B, seed=0))
    batches = [{"tokens": torch.as_tensor(src.batch(i), device=device)}
               for i in range(EP_STEPS + 1)]
    named = dict(params.named_parameters())

    int8 = ApproxKnobs(matmul_precision="int8")

    # (a) cross-entropy and gradients at capacity factor 8, precise and
    # int8
    def ce_grads(c, knobs, **kw):
        params.requires_grad_(True)
        loss, m = lm.lm_loss(params, batches[0], c, knobs, remat="none",
                             aux_coef=0.0, **kw)
        g = torch.autograd.grad(loss, list(named.values()))
        params.requires_grad_(False)
        return float(loss.detach()), float(m["aux"].detach()), dict(
            zip(named, g))
    torch.cuda.reset_peak_memory_stats()
    n_entries = sum(p.numel() for p in named.values())
    gates_a = {}
    for rung, knobs, rtol, atol in (("precise", PRECISE, 2e-4, 2e-5),
                                    ("int8", int8, 1e-4, 2e-4)):
        ce_l, aux_l, g_l = ce_grads(cfg8, knobs)
        ce_e, aux_e, g_e = ce_grads(cfg8, knobs, ep_axis="model", mesh=mesh)
        outside = {k: int((~torch.isclose(g_e[k], g_l[k], rtol=rtol,
                                          atol=atol)).sum()) for k in named}
        outside = {k: n for k, n in outside.items() if n}
        allowed = 0 if rung == "precise" else EP_INT8_OUTSIDE * n_entries
        gates_a[rung] = dict(
            ce_e=ce_e, ce_l=ce_l, rel_ce=abs(ce_e - ce_l) / abs(ce_l),
            rtol=rtol, atol=atol, aux_e=aux_e, aux_l=aux_l, outside=outside,
            bad=list(outside) if sum(outside.values()) > allowed else [],
            worst=max(float((g_e[k] - g_l[k]).abs().max()) for k in named))
        del g_l, g_e
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    drop_int8_weights()
    torch.cuda.empty_cache()

    # (b) one MoE layer at the config's capacity factor against plain_ep:
    # outputs, keep masks, the aux loss, and the gradients of the output's
    # projection on r plus 0.01 x the aux loss
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn((B * S, cfg.d_model), generator=g).to(device)
    r = torch.randn((B * S, cfg.d_model), generator=g).to(device)
    mp = params.layers[0].moe
    wrt = [mp.wg, mp.wi_gate, mp.wi_up, mp.wo]
    params.requires_grad_(True)
    x.requires_grad_(True)
    routing = []
    mark = collectives.WIRE.mark()
    y, aux = moe_mod.moe(mp, x.view(B, S, -1), cfg, ep_axis="model",
                         mesh=mesh, routing=routing)
    exch = sum(b for (_, c), (_, b) in collectives.WIRE.since(mark).items()
               if c == "all_to_all")
    g_ep = torch.autograd.grad((y.view(-1, cfg.d_model) * r).sum()
                               + 0.01 * aux, [x] + wrt)
    y_plain, keep_plain, aux_plain = plain_ep(mp, x, cfg, EP_MESH)
    g_plain = torch.autograd.grad((y_plain * r).sum() + 0.01 * aux_plain,
                                  [x] + wrt)
    params.requires_grad_(False)
    x.requires_grad_(False)
    keep = [k for _, k in routing]
    keep_equal = all(torch.equal(a, b) for a, b in zip(keep, keep_plain))
    err_b = max_err(y.detach().view(-1, cfg.d_model), y_plain.detach())
    aux, aux_plain = float(aux.detach()), float(aux_plain.detach())
    rel_aux = abs(aux - aux_plain) / abs(aux_plain)
    grad_rel = dict(zip(("x", "wg", "wi_gate", "wi_up", "wo"),
                        (rel_gap(a, b) for a, b in zip(g_ep, g_plain))))
    del g_ep, g_plain, y, y_plain
    # (b, int8) the experts' int8 backward a shard against the local int8
    # MoE's on the same layer inputs, at capacity factor 8 (nothing drops
    # either way): the gradients of the output's projection
    g_i8 = []
    params.requires_grad_(True)
    x.requires_grad_(True)
    for kw in ({}, dict(ep_axis="model", mesh=mesh)):
        y, aux_i8 = moe_mod.moe(mp, x.view(B, S, -1), cfg8,
                                precision="int8", **kw)
        g_i8.append(torch.autograd.grad(
            (y.view(-1, cfg.d_model) * r).sum(), [x] + wrt))
    params.requires_grad_(False)
    x.requires_grad_(False)
    names_b = ("x", "wg", "wi_gate", "wi_up", "wo")
    i8_rel = dict(zip(names_b, (rel_gap(a, b) for a, b in zip(*g_i8[::-1]))))
    i8_bad = [n for n, a, b in zip(names_b, g_i8[1], g_i8[0])
              if not torch.allclose(a, b, rtol=1e-4, atol=2e-4)]
    del g_i8, y, aux_i8     # a live autograd graph breaks a later capture
    dropped = [int((~k).sum()) for k in keep]
    C = moe_mod._capacity(B * S // n_pos, cfg.moe.top_k, cfg.moe.n_experts,
                          cfg.moe.capacity_factor)

    # (c) the int8 rung's forward: one launch an expert shard a product
    reset_launches()
    with torch.no_grad():
        lm.forward_hidden(params, batches[0]["tokens"][:, :-1], cfg, int8,
                          ep_axis="model", mesh=mesh, remat="none")
    torch.cuda.synchronize()
    fwd = read_launches()
    want_i8 = 3 * n_pos * EP_LAYERS

    # the train step, local and EP, precise and int8, one graph each
    opt = optim.init_opt(params)
    state = step_mod.state_tensors(params, opt)
    pristine = [t.detach().clone() for t in state]
    pool = torch.cuda.graph_pool_handle()
    steps, rows = [], {}
    reset_launches()
    for rung, knobs in (("precise", PRECISE), ("int8", int8)):
        for path, kw in (("local", {}), ("EP", dict(ep_axis="model",
                                                    mesh=mesh))):
            with torch.no_grad():
                for t, t0 in zip(state, pristine):
                    t.copy_(t0)
            opt = opt._replace(step=0)
            step = step_mod.graphed_train_step(step_mod.make_train_step(
                cfg, knobs, remat="none", **kw), device, pool)
            steps.append(step)
            times, losses = [], []
            for i in range(EP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, opt, m = step(params, opt, batches[i])
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t0)
            rows[(rung, path)] = dict(
                ms=1e3 * float(np.median(times[1:])), losses=losses,
                capture_s=step.stats["capture_s"],
                pool=gib(step.stats["pool_bytes"]))
    launches = card_launches(steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    for (rung, path), r in rows.items():
        print(f"train-ep {rung} {path}: replayed {r['ms']:.1f} ms a step "
              f"({r['ms'] / rows[(rung, 'local')]['ms']:.3f}x local), "
              f"capture {r['capture_s']:.3f} s, pool {r['pool']} GiB, "
              f"losses {[round(x, 5) for x in r['losses']]}")
    for rung, a in gates_a.items():
        print(f"train-ep gate (a) {rung}, capacity factor {EP_CF8}: "
              f"cross-entropy EP {a['ce_e']:.6f} local {a['ce_l']:.6f} (rel "
              f"{a['rel_ce']:.3g}), gradients max |diff| {a['worst']:.3g}, "
              f"entries outside rtol {a['rtol']} / atol {a['atol']} "
              f"{a['outside']} of {n_entries}, failing leaves {a['bad']}; "
              f"aux EP {a['aux_e']:.5f} local "
              f"{a['aux_l']:.5f}")
    print(f"train-ep gates: (a) peak {peak_a:.2f} GiB; "
          f"(b) capacity factor {cfg.moe.capacity_factor} (C {C} a "
          f"position): keep masks equal to plain_ep's {keep_equal}, output "
          f"max |diff| {err_b:.3g}, aux {aux:.7f} against plain_ep's "
          f"{aux_plain:.7f} (rel {rel_aux:.3g}), gradients of y.r + 0.01 "
          f"aux max |diff| / max |plain| {grad_rel}; int8 at capacity "
          f"factor {EP_CF8}, EP against local on these inputs, gradients "
          f"of y.r max |diff| / max |local| {i8_rel}, outside rtol 1e-4 / "
          f"atol 2e-4: {i8_bad}; dropped a shard "
          f"{dropped} of {B * S // n_pos * cfg.moe.top_k}, exchange "
          f"{exch:.0f} bytes a position a layer (there and back); (c) "
          f"int8 forward "
          f"int8_matmul {fwd['int8_matmul']} launches (want {want_i8}: 3 a "
          f"shard a layer), quantize_rows {fwd['quantize_rows']}; steps' "
          f"launches {launches}, peak {peak:.2f} GiB")
    for rung, a in gates_a.items():
        assert a["rel_ce"] <= a["rtol"] and not a["bad"], (rung, a)
        assert np.isfinite(a["aux_e"]), (rung, a)
    assert keep_equal and err_b <= EP_OUT_ATOL, (keep_equal, err_b)
    assert rel_aux <= EP_AUX_REL, (aux, aux_plain)
    assert max(grad_rel.values()) <= EP_GRAD_REL, grad_rel
    assert not i8_bad, i8_rel
    assert fwd["int8_matmul"] == want_i8, fwd
    assert launches["flash_attention"] > 0 and launches["int8_matmul"] > 0
    del params, opt, state, pristine, steps
    drop_int8_weights()
    torch.cuda.empty_cache()
    return launches


def main():
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the repository's src/repro_torch is missing",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {secs:.2f}s for "
          + ", ".join(f"{n} {_build.build_seconds[n]:.2f}s"
                      if n in _build.build_seconds else n
                      for n in _build.SOURCES))
    for name, log in _build.ptxas_log.items():
        seen = dict.fromkeys(line.split(":", 1)[-1].strip()
                             for line in log.splitlines()
                             if "registers" in line or "spill" in line)
        for line in seen:
            print(f"  {name}: {line}")

    # the dryrun phase's meta traces run beside the card's phases
    dry_pool, dry_futs = dry_start()
    t = t_lap = time.perf_counter()
    laps = {}

    def lap(name):
        """The seconds since the last lap or phase, under ``name``."""
        nonlocal t_lap
        laps[name] = round(time.perf_counter() - t_lap, 1)
        t_lap = time.perf_counter()

    def phase_done(name):
        nonlocal t, t_lap
        print(f"phase {name}: {time.perf_counter() - t:.1f}s"
              + (f" {laps}" if laps else ""))
        t = t_lap = time.perf_counter()
        laps.clear()

    i8_rows = check_int8(device, int8_shapes())
    lap("int8")
    assert {r["design"] for r in i8_rows} == {"A", "B", "fallback"}
    q_rows = check_quantize(device, quantize_shapes())
    lap("quantize")
    pa_rows = check_paged(device, phi4_paged_cases(torch.bfloat16))
    lap("paged")
    ssd_full = (4, 1024, 48, 64, 128, 128)      # mamba2-780m training
    ssd_rows = check_ssd(device, [(2, 64, 8, 16, 16, 16), ssd_full])
    # the token-drop rungs' batch rows: int8+drop12% keeps 3, int8+drop50% 2
    check_ssd(device, [(3,) + ssd_full[1:], (2,) + ssd_full[1:]],
              dtypes=(torch.float32,))
    ssd_bwd_rows = check_ssd_backward(device, [(2, 64, 8, 16, 16, 16),
                                               ssd_full])
    check_ssd_grads(device)
    lap("ssd")
    ssd_bwd_ms = time_ssd_backward(device, ssd_full)
    lap("ssd_backward")
    check_int8_grads(device)
    lap("int8_grads")
    fa_rows = check_flash(device, phi4_flash_cases())
    lap("flash")
    check_flash_grads(device)
    lap("flash_grads")
    time_attention_paths(device)
    lap("attention_paths")
    rh_rows = check_ring_hop(device, phi4_ring_hop_cases())
    lap("ring_hop")
    check_ring_chunk(device)
    lap("ring_chunk")
    kernels = {"flash_attention": next(r for r in fa_rows
                                       if r["name"] == "cell-fp32"),
               "int8_matmul": next(r for r in i8_rows
                                   if (r["M"], r["K"], r["N"])
                                   == (8, 3072, 8192)),
               "paged_attention": next(r for r in pa_rows
                                       if r["name"] == "bf16"),
               "quantize_rows": next(r for r in q_rows
                                     if (r["M"], r["K"]) == (8, 3072)),
               "ring_hop": next(r for r in rh_rows
                                if r["name"] == "cell-bf16"),
               "ssd_scan": next(r for r in ssd_rows
                                if r["shape"] == ssd_full
                                and r["dtype"] == "fp32"),
               "ssd_scan_backward": next(r for r in ssd_bwd_rows
                                         if r["shape"] == ssd_full
                                         and r["dtype"] == "fp32")}
    phase_done("kernels")
    check_parity(device)
    lap("serve")
    check_ring_parity(device)
    lap("ring")
    check_train_parity(device, per_step=mamba_launches)
    lap("train_mamba2")
    check_train_parity(device, "phi4-mini-3.8b-smoke", batch=2, seq=1024,
                       remat="full", per_step=attn_launches)
    phase_done("parity")
    res, serve_launches = serve_full(device)
    rung_walk(res, device)
    phase_done("serve")
    check_sampling(device)
    lap("sampling")
    megastep_rungs(res, device)
    lap("rungs")
    megastep_swap(res, device)
    lap("swap")
    megastep_temperature(res, device)
    lap("temperature")
    drop_int8_weights()
    mres, mega_launches = serve_full(device, megastep=MEGA_K)
    print(f"serve under --megastep {MEGA_K}: tok_s {mres['tok_s']:.2f} "
          f"(per-step {res['tok_s']:.2f}), p50 {1e3 * mres['p50_s']:.3f} ms "
          f"(per-step {1e3 * res['p50_s']:.3f}), p99 "
          f"{1e3 * mres['p99_s']:.3f} ms (per-step "
          f"{1e3 * res['p99_s']:.3f}), rungs visited "
          f"{sorted({0} | {v for _, v in mres['engine'].swaps})} (per-step "
          f"{sorted({0} | {v for _, v in res['engine'].swaps})})")
    del mres
    drop_int8_weights()
    torch.cuda.empty_cache()
    phase_done("megastep")
    profile_rungs(res, device)
    phase_done("profile")
    del res
    drop_int8_weights()
    torch.cuda.empty_cache()
    # mamba2-780m at 4 x 1024 tokens, full width cut to TRAIN_LAYERS layers
    with depth_cut("mamba2-780m", n_layers=TRAIN_LAYERS):
        tres, train_launches = train_full(
            device, "mamba2-780m", 12, 4, 1024,
            ["precise", "int8", "int8+drop12%", "int8+drop50%"],
            mamba_launches)
    lap("run")
    train_graph_witness(tres, device)
    phase_done("train")
    train_walk = train_rung_walk(tres, device, steps=3,
                                 per_step=mamba_launches, eager=2,
                                 syncs=True)
    lap("walk")
    profile_train(tres, device)
    phase_done("train-rungs")
    print(f"ssd_scan_backward: {48 * ssd_bwd_ms:.1f} ms a training step "
          f"at mamba2-780m's full depth (48 layers x {ssd_bwd_ms:.3f} ms)")
    del tres
    torch.cuda.empty_cache()
    pod_launches, pod_wire = train_pod(device)
    phase_done("train-pod")
    dry_launches = dryrun_cell(device, dry_futs, train_walk, pod_wire)
    dry_pool.shutdown()
    phase_done("dryrun")
    # phi4-mini-3.8b at 2 x 4096 tokens, full width cut to ATTN_LAYERS
    # layers (32 until the train-encdec phase was added); at full depth its
    # 61.5 GB of fp32 params, grads and AdamW moments leave the layers'
    # activations room only under remat
    with depth_cut("phi4-mini-3.8b", n_layers=ATTN_LAYERS):
        ares, attn_train_launches = train_full(
            device, "phi4-mini-3.8b", 8, 2, 4096,
            ["precise", "int8", "int8+kvstride2", "int8+drop50%"],
            attn_launches, remat="full")
    lap("run")
    train_graph_witness(ares, device)
    phase_done("train-attn")
    # one step a rung each way, timed (the graph is warm from the run, and
    # the eager step's kernels and cuBLAS): cut from 4 with the serve-ring
    # phase added, from 3 with serve-ssm and from 2 with the graphs, to
    # keep the whole script under 1100 s
    train_rung_walk(ares, device, steps=1, skip=0, per_step=attn_launches,
                    eager=1, syncs=True)
    lap("walk")
    # the patch reaches only steps traced after it: the rung's graph,
    # captured before, would replay the kernel, so this walk runs the
    # eager step
    with chunked_causal_attention():
        train_rung_walk(ares, device, steps=0, eager=1, skip=0,
                        rungs=["int8"],
                        tag=" (attention chunked, stride 1)",
                        per_step=lambda cfg, knobs: {
                            **attn_launches(cfg, knobs),
                            "flash_attention": 0})
    lap("chunked")
    # the replayed step only: eager, the step is device-bound as well
    # (busy 0.983-0.992 on an H100 80GB HBM3 at 700 W)
    profile_train(ares, device, eager=False)
    phase_done("train-attn-rungs")
    del ares
    torch.cuda.empty_cache()
    _, ring_launches = ring_cell(device)
    phase_done("serve-ring")
    elastic_launches, elastic_rows = elastic_cell(device)
    phase_done("serve-elastic")
    colo_launches = colocate_cell(device)
    phase_done("colocate")
    dense_launches = dense_cell(device)
    phase_done("serve-dense")
    gemma3_launches, gemma3_fa_rows = gemma3_cell(device)
    phase_done("serve-gemma3")
    ssm_launches, ssm_rows, ssm_pa_rows, ssm_fa_rows = ssm_cell(device)
    phase_done("serve-ssm")
    moe_launches, moe_i8_rows = moe_cell(device)
    phase_done("serve-moe")
    ep_launches = train_ep(device)
    phase_done("train-ep")
    enc_launches, vlm_launches, enc_fa_rows, enc_i8_rows, bmm_rows = \
        encdec_cell(device)
    phase_done("train-encdec")

    src_of = {"flash_attention": (
                  "src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:89"),
              "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                              "src/repro/kernels/int8_matmul.py:40"),
              "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                  "src/repro/kernels/paged_attention.py:98"),
              # jnp ops in the JAX package (XLA fuses them), no Pallas call
              "quantize_rows": ("src/repro_torch/csrc/quantize_rows.cu",
                                "src/repro/kernels/ref.py:11"),
              "ring_hop": ("src/repro_torch/csrc/ring_hop.cu",
                           "src/repro/kernels/ring_attention.py:113"),
              "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                           "src/repro/kernels/ssd_scan.py:62"),
              # no Pallas call: the JAX package takes jax.grad of the
              # chunked twin on its CPU path (the Pallas call has no VJP)
              "ssd_scan_backward": ("src/repro_torch/csrc/ssd_scan.cu",
                                    "src/repro/kernels/ref.py:99")}
    by_path = {name: {"serve": serve_launches[name],
                      "serve-megastep": mega_launches[name],
                      "train": train_launches[name],
                      "train-attn": attn_train_launches[name],
                      "serve-ring": ring_launches[name],
                      "serve-elastic": elastic_launches[name],
                      "colocate": colo_launches[name],
                      "serve-dense": dense_launches[name],
                      "serve-gemma3": gemma3_launches[name],
                      "serve-ssm": ssm_launches[name],
                      "serve-moe": moe_launches[name],
                      "train-encdec": enc_launches[name],
                      "train-vlm": vlm_launches[name],
                      "train-pod": pod_launches[name],
                      "dryrun": dry_launches[name],
                      "train-ep": ep_launches[name]}
               for name in kernels}
    # the experts' batched product (one launch for 64 experts) at decode
    i8_batched = {"serve_moe": [{k: r[k] for k in (
        "E", "M", "K", "N", "design", "ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by", "max_abs_err")} for r in moe_i8_rows],
        "train_backward_acc": bmm_rows}
    # the train-encdec phase's shapes
    i8_encdec = [{k: r[k] for k in (
        "M", "K", "N", "design", "ms", "ms_fp32", "plain_ms", "library_ms",
        "bound_ms", "bound_by", "max_abs_err")} for r in enc_i8_rows]
    fa_encdec = [{k: r[k] for k in (
        "name", "shape", "design", "ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by", "max_abs_err")} for r in enc_fa_rows]
    # hd 80 (zamba2's handoff) and hd 256 (gemma3-12b's prefill)
    fa_hd = [{k: r.get(k) for k in (
        "name", "shape", "design", "ms", "plain_ms", "library_ms",
        "cudnn_ms", "bound_ms", "bound_by", "max_abs_err")}
        for r in ssm_fa_rows + gemma3_fa_rows]
    # "simple" at the smoke configs' hd 16
    fa_simple = [{k: r[k] for k in (
        "name", "shape", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "max_abs_err")} for r in fa_rows
        if r["design"] == "simple"]
    # ssd_scan with the state in and out at zamba2's admission chunk
    ssm_row = next(r for r in ssm_rows if r["shape"] == (1, 128, 80, 64, 64)
                   and r["dtype"] == "bf16")
    ssd_state = {"serve_ssm": {k: ssm_row[k] for k in (
        "shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
        "max_abs_err", "state_err")}}
    zamba_row = next(r for r in ssm_pa_rows if r["name"] == "zamba2-bf16")
    ring_row = next(r for r in pa_rows if r["name"] == "ring-decode")
    tc_row = next(r for r in fa_rows if r["name"] == "cell-bf16")
    paged_ring = {"ring_decode_ms": ring_row["ms"],
                  "ring_decode_plain_ms": ring_row["plain_ms"],
                  "ring_decode_bound_ms": ring_row["bound_ms"],
                  "serve_elastic": [{k: r[k] for k in (
                      "name", "ms", "whole_ms", "plain_ms", "bound_ms",
                      "bound_by", "max_abs_err", "tol", "rel_err",
                      "max_abs_plain", "shards")}
                      for r in elastic_rows],
                  "serve_ssm": {k: zamba_row[k] for k in (
                      "name", "ms", "plain_ms", "bound_ms", "bound_by",
                      "max_abs_err")}}
    line = []
    for name, r in kernels.items():
        line.append(dict(name=name, route="cuda", source=src_of[name][0],
                         replaces=src_of[name][1],
                         launches=sum(by_path[name].values()),
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"],
                         launches_by_path=by_path[name],
                         **({**{k: r[k] for k in ("design",
                                                   "library_layout")},
                             "batched": i8_batched, "encdec": i8_encdec}
                            if name == "int8_matmul" else {}),
                         **({k: r[k] for k in ("design", "step_ms")}
                            if name == "ring_hop" else {}),
                         **(paged_ring if name == "paged_attention"
                            else {}),
                         **(ssd_state if name == "ssd_scan" else {}),
                         **({"design": r["design"],
                             "tc_source": "src/repro_torch/csrc/flash_tc.cu",
                             "tc": {
                             k: tc_row[k] for k in (
                                 "name", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "sfu_ms", "max_abs_err")},
                             "encdec": fa_encdec, "hd80_256": fa_hd,
                             "simple": fa_simple}
                            if name == "flash_attention" else {})))
    print(f"chip_smoke: {time.perf_counter() - t0:.1f}s by its own clock")
    print(json.dumps({"kernels": line}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
