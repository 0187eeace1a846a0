#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
     (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, at the
     solve service's main-path shapes and at ragged, tiny and bf16 shapes:
     the sampler (B1) at fp32 rtol 1e-4 / atol 1e-5 and bf16 2e-2, also at
     the GAN trainer's shapes u [8192, 100, C] (C 2 for proxy1d, 3 for
     proxy2d, 4 for linear_blur) and one proc worker's u [1024, 100, 2]
     (phases 34-35), at C 1, 3 and 5 and on views that start
     1 or 3 elements into their buffer, and through the 2-D entry at
     imaging training's readout noise u [512, 32] (and one proc worker's
     [64, 32]); the mask (B2) bitwise
     over a sweep of threads per block; the blur (B3) at rtol/atol 1e-6
     over a sweep of band heights (bitwise the same at each), also at
     [16, 256, 256] and [3, 130, 77] and on views 1 element into their
     buffer (the scalar path); B2 and B3 also at imaging training's
     shapes (x [512, 1024] and [512, 32, 32]; B3 also at one proc
     worker's [64, 32, 32]), forward and backward (the
     backward against autograd through the plain version, at 1e-6);
  4. time each kernel, its plain version and, where one exists, the one
     PyTorch call that computes the same function, at the main-path shape
     (CUDA events, median of 50 samples of 20 calls each after warm-up; the
     card's time with the stream held while the host enqueues, and the time
     per call back to back with host launch included), beside the least
     time the card could take (its byte or operation bound); B1 also at
     u [8192, 100, C] for C 2, 3 and 4 and B3 at [16, 256, 256], and the
     launch floor: an empty kernel on B1's grid at the main-path shape;
  5. serve proxy1d: `SolveService(DEFAULT)` on the card, with a 16-rank
     generator stack at the paper's widths (random weights from a seed)
     written in the JAX package's checkpoint layout and loaded through
     `load_generator_stack`; warm every bucket, serve 24 requests across
     the three buckets, check the results and that every solve launched the
     sampler kernel and none took the plain version; per-bucket p50/p99;
  6. solve one proxy1d batch on the card and on the CPU with the same draws
     and compare, as tests/test_torch_serving.py compares the port with JAX;
  7. profile 8 served proxy1d requests: the card's busy share and where its
     time goes, by kernel;
  8. serve imaging and imaging_blur the same way, each with a 16-rank stack
     of the full-width conv generator (292,545 parameters a rank, random
     weights from a seed) carried in from numpy by
     `conv_generator_from_numpy` and registered with `gen_stack=`; every
     solver call must launch the sampler once and the mask (imaging) or the
     blur (imaging_blur) once, and nothing must take a plain version;
  9. one DEFAULT batch per imaging problem on the card and on the CPU;
 10. profile 8 served requests per imaging problem;
 11. hold flash attention (B4) against its plain version on the card,
     both routes (bf16: the tensor-core kernel `flash_attention_tc.cu`;
     fp32: the FMA kernel `flash_attention.cu`): at tinyllama-1.1b's
     prefill shape (q [8, 32, 1024, 64], k/v [8, 4, 1024, 64]) in bf16
     and fp32 at each route's model-path tiles, each main path's own call
     (`flash_attention_model` on the model layout [B, S, KV, G, hd], bf16,
     the wgmma route: tinyllama-1.1b's prefill [8, 1024, 4, 8, 64],
     qwen2-moe-a2.7b's prefill [8, 1024, 16, 1, 128], granite-moe-3b-a800m's
     training step [8, 256, 8, 3, 64]; the largest error is the kernels
     line's), and over a sweep of GQA
     groups (1, 3 (granite-moe-3b-a800m's), 4, 8), head dims (32, 64, 80
     (hubert-xlarge's), 128), and G 7 (internvl2-1b's 14 heads over 2) at
     head dim 64, masks (causal, full, window 64 and 256),
     ragged lengths (1, 100, 1000) and tiles (block_q, block_k in 32,
     64, 128), at fp32 rtol 1e-4 / atol 1e-5 and bf16 2e-2; in fp32
     every pair of tiles within rtol 1e-5 / atol 1e-6 of the first, in
     bf16 within 2e-2; each dtype counted under its route; the bf16
     route's strided model layout (q, k, v as views of one fused
     projection) against the plain version;
 12. time B4 at the prefill shape in bf16 as in phase 4: the prefill's
     call checked in phase 11 (the kernels line's time), the same kernel
     in the [B, H, S, hd] layout, its plain version (median of 10 samples
     of 3 calls, as phases 50 and 53 time theirs),
     `scaled_dot_product_attention` (causal, GQA;
     timed, never used by the port) and the bound (the causal half's
     FLOPs at the bf16 tensor-core peak, or its bytes); the model-layout
     call without copies against the transposing copies it replaced; the
     fp32 route at the same shape (10 samples of 5 calls, as phase 17
     times B5's fp32 route);
 13. serve tinyllama-1.1b at full size (22 layers, d_model 2048, bf16,
     random weights from a seed) through `serving.engine.generate`: batch
     8, prompt 1024, 64 greedy tokens, then again with a sliding window of
     256 (the window mask and the ring buffer's wrap), each after an
     uncounted warm-up run at the same shapes (the prefill and 4 greedy
     tokens at the same context); 22 B4 launches per prefill,
     all on the bf16 route, and no plain call; prefill ms, decode ms a
     step, tok/s;
 14. the same model at full width, depth 2, fp32 (TF32 off), batch 1,
     prompt 256, 8 greedy tokens, on the card and on the CPU with the same
     weights, with and without a window of 64: logits within 1e-3, token
     ids equal unless the CPU's top-2 gap is below 1e-4;
 15. profile one tinyllama prefill, then 8 decode steps: the card's busy
     share and its time by kernel (B4, the cuBLAS GEMMs, the rest), and
     B4's share of the card's time;
 16. hold the SSD scan (B5) against its plain version on the card, both
     routes (bf16: the tensor-core kernels `ssd_scan_tc.cu`; fp32: the
     FMA kernel `ssd_scan.cu`): at mamba2-130m's training shape (x [8,
     256, 24, 64], N 128, chunk 512) and a multi-chunk shape (S 2048,
     four chunks of 512), in bf16 and fp32, at every tile (32, 64, 128),
     and over a sweep of ragged S (1, 100, 1000), chunks (16, 64, 128,
     512), N (16, 128) and P (32, 64), each case in both dtypes, at
     fp32 rtol/atol 1e-3 and bf16 2e-2; in fp32 every chunk and tile within 1e-4 of the first; once
     against the sequential recurrence; each dtype counted under its
     route;
 17. time B5 at both shapes in bf16 as in phase 4: the bf16 route, its
     plain version and the bound (no single PyTorch call computes it);
     the fp32 route at the training shape;
 18. the gradients of every kernel wrapper (B1-B5) on the card against
     the CPU's at small fp32 shapes; the blur's backward is one launch of
     the blur kernel;
 19. train mamba2-130m at full size (24 layers, d_model 768, bf16,
     128,983,488 parameters, random weights from a seed) through
     `training.Trainer` at the `launch/train` defaults: batch 8, seq 256,
     lr 3e-4, warmup 7, 30 steps (phase 59 drives its train step again,
     and the train CLI); 48 B5 calls a step (24 layers,
     forward and remat recompute), all on the bf16 route, and no plain
     call; every loss finite,
     and the loss of 4 held-out batches lower after training than before
     (each step's batch is new random tokens, and the spread between
     batches is larger than what 30 steps at lr 3e-4 take off, so a
     step's loss against another's is not the test); step time p50/p99,
     tokens/s, peak memory; then profile PROFILED_STEPS (1) step: the
     card's busy share and B5's share of its time;
 20. one training step on the card and on the CPU from the same weights
     and batch, at full width, depth 2, fp32, TF32 off: mamba2-130m at
     batch 1, seq 1024 (two chunks, so the state carries across chunks)
     and tinyllama-1.1b at batch 1, seq 256 (B4 and its backward): the
     loss at rtol 1e-5, every gradient leaf within 1e-3 in relative norm,
     and the card's new parameters against the CPU's optimizer applied to
     the card's gradients at rtol 1e-6 / atol 1e-9, every entry; the new
     parameters against the CPU's own step are reported (where |g| is
     near Adam's eps, the gradients' last bits move an entry by up to
     lr_t);
 21. serve mamba2-130m (batch 8, prompt 1024, 64 greedy tokens, after a
     warm-up of 4) through
     `serving.engine.generate`: SSM prefill and decode are plain PyTorch,
     so no kernel launches; prefill ms, decode ms a step;
 22. train the paper's GAN at full width through `core.workflow
     .train_stacked`: the `PAPER` preset (1024 x 100 events a rank, lr
     1e-5 / 1e-4, h 1000), 8 ranks as 2 x 4, random weights and 50,000
     reference events from a seed, 200 epochs in `rma_arar_arar` and in
     `conv_arar`, history every 20, fp32 with TF32 off, after an
     uncounted 2-epoch warm-up; each mode must meet the bars of
     tests/test_system.py::test_workflow_end_to_end_healthy (every state
     leaf finite, the ensemble in (0, 1), the last recorded d_loss below
     the first and its minimum below 1.42), with B1 launched once an
     epoch at u [8192, 100, 2], its backward once an epoch and no plain
     call; epoch p50/p99, generated events/s, peak memory, final mean|r̂|;
 23. one epoch on the card and on the CPU from the same state (a non-zero
     RMA mailbox) and draws, full width, REDUCED batch sizes, 4 ranks as
     2 x 2, h 1, fp32, TF32 off, in both ring modes: losses at rtol 1e-5,
     every generator gradient leaf within 1e-5 in relative norm against
     the CPU's computed at the card's Leaky ReLU signs, as phase 27 (the
     gap without pinning and the number of flips are reported), the
     CPU's exchange of the card's gradients bitwise the card's, and the
     card's new generator and Adam state against the CPU's optimizer
     applied to the card's synced gradients at rtol 1e-6 / atol 1e-9;
 24. profile 5 PAPER epochs: the card's busy share, its time by kernel
     (GEMMs, B1, the exchange's rolls, the rest), B1's share, device ops
     an epoch;
 25. serve proxy2d and linear_blur as phase 5 serves proxy1d (16-rank
     stacks of the MLP at 135->128->128->128->10 and ->8, random weights
     from a seed, in the JAX checkpoint layout through
     `load_generator_stack`; every solver call launches B1 once on
     u [R·M, E, 3] or [R·M, E, 4], and nothing takes a plain version;
     p50/p99 per bucket), then one batch on the card against the CPU as
     phase 6;
 26. train proxy2d, linear_blur, imaging and imaging_blur at full width
     through `core.workflow.train_stacked` at `for_problem(name, PAPER)`
     (the flat problems 1024 x 100 events a rank, the image problems 64 x
     32 with the capped generator step and the conv generator at
     CONV_CHANNELS (32, 32, 16)), 8 ranks as 2 x 4, rma_arar_arar, h
     1000, fp32 with TF32 off, imaging for 200 epochs and the others
     for 50 (phase 46 trains imaging_blur for 200; phases 40, 42 and 48
     train the stacked trainer at PAPER's widths for 200) after an
     uncounted 2-epoch
     warm-up, history every 20: every state leaf finite, the ensemble in
     (0, 1), every recorded d_loss finite and its minimum below the
     first; B1 launched once an epoch (u [8192, 100, 3] / [8192, 100, 4],
     or [512, 32] of readout noise) with its backward once an epoch for
     the flat problems, B2 (x [512, 1024], backward in PyTorch) or B3
     (x [512, 32, 32], backward one B3 launch) once an epoch for the image
     problems, and no plain call; epoch p50/p99, generated events/s, peak
     memory, the d_loss trajectory, final mean|r̂| (no bar: linear_blur's
     near-zero truth pixel keeps it O(1) by design);
 27. one epoch on the card and on the CPU for proxy2d, linear_blur and
     imaging as phase 23 (full width, REDUCED batch sizes, 4 ranks as
     2 x 2, h 1, fp32, TF32 off, both ring modes), with phase 23's bars:
     the generator's gradient leaves held at 1e-5 in relative norm
     against the CPU's computed at the card's Leaky ReLU signs: a
     pre-activation within rounding of 0 that takes the other sign on
     the CPU moves an upstream leaf by up to ~5e-3 (see
     scripts/imaging_grad_gap.py); the gap without pinning and the number
     of such flips are reported;
 28. profile 5 imaging epochs at `for_problem("imaging", PAPER)`: the
     card's busy share, its time by kernel (cuDNN's grouped conv forward
     and backward, GEMMs, B1-B3, the exchange's rolls, the rest), device
     ops an epoch;
 29. the MoE layer (`models.moe.run_moe`) on the card and on the CPU at
     qwen2-moe-a2.7b's widths (D 2048, 60 experts of 1408, 4 shared,
     top-4) and granite-moe-3b-a800m's (D 1536, 40 experts of 512,
     top-8), T 512, fp32, TF32 off, once at the default capacity and once
     with drops forced by a router biased towards experts 0 and 2: y on
     the card and on the CPU each within rtol 1e-4 and atol 1e-5 x max |y|
     of the layer's float64 run (its sums run over 2048 to 5632 terms:
     fp32 missed float64 by up to 1.6e-5 where |y| reaches 13, ~1e-5 of
     the output's scale, on an NVIDIA H100 80GB HBM3 at 700 W and on its
     host's CPU alike; card against CPU, which adds both errors, is
     reported), aux card against CPU at rtol 1e-6, the same drops, the
     card's top-k choices the CPU's (where they differ, the CPU's gap
     between its k-th and (k+1)-th probability must be under 1e-6, and
     the CPU runs again at the card's choices, as Leaky ReLU signs are
     pinned in phase 27); the same layer on the card with TF32 matmuls
     and in bf16, at the card's fp32 choices, must fail y's bar (its
     readings printed); then two bf16 runs on the card bitwise equal;
 30. serve qwen2-moe-a2.7b at full size (24 layers, d_model 2048, bf16,
     14.0 B parameters, random weights from a seed) through
     `serving.engine.generate`: batch 8, prompt 1024, 64 greedy tokens
     after an uncounted warm-up (the prefill and 4 greedy tokens at the
     same context, which counts the drops); 24 B4 launches a prefill
     (head dim 128, GQA group 1), all on the bf16 route, and no plain
     call; prefill ms, decode ms a step p50/p99, tok/s, peak memory, the
     (token, expert) assignments dropped by capacity, and the bounds: the
     prefill's operations at the bf16 peak, a decode step's weight and
     KV-cache reads at the memory rate;
 31. qwen2-moe-a2.7b at full width, depth 2, fp32 (TF32 off), batch 1,
     prompt 256, 8 greedy tokens, on the card and on the CPU with the same
     weights: logits within 1e-3, token ids equal unless the CPU's top-2
     gap is below 1e-4, routing pinned as in phase 29;
 32. train granite-moe-3b-a800m at full size (32 layers, d_model 1536,
     bf16, 3.3 B parameters, random weights from a seed) through
     `training.Trainer` (its donating step) at the `launch/train`
     defaults: batch 8, seq 256, lr 3e-4, warmup 4, MOE_TRAIN_STEPS (15;
     phase 33 steps it again, and phase 60 drives its forward, backward
     and donating step at full size) steps after an uncounted forward and
     backward; 64 B4 launches a step
     (32 layers, forward and remat recompute), all on the bf16 route, 32
     backward passes through the plain VJP, no plain call; every loss
     finite, and the loss of 4 held-out batches lower after training than
     before; step p50/p99, tokens/s, peak memory, the aux loss, the drops;
     then profile PROFILED_STEPS (1) step: the card's busy share and the
     shares of the
     expert GEMMs, the routing and dispatch (sort, scatter, gather,
     forward and backward) and B4;
 33. one granite-moe-3b-a800m training step on the card and on the CPU as
     phase 20 (full width, depth 2, fp32, TF32 off, batch 1, seq 256):
     the loss at rtol 1e-5, every gradient leaf (the router's included)
     within 1e-3 in relative norm, the card's new parameters against the
     CPU's optimizer on the card's gradients at rtol 1e-6 / atol 1e-9,
     routing pinned as in phase 29;
 34. the paper's GAN as 8 worker processes on the one card
     (`runtime.launch.run_proc`, the proc runtime over the mmap mailbox
     fabric): `PAPER`, proxy1d, 2 x 4, fp32 with TF32 off, 10 epochs,
     lock-step, once in `rma_arar_arar` with h 2 (the outer ring due on
     alternate epochs) and once in `conv_arar`: the stacked final state
     (gen, gen_opt, disc, disc_opt, sync, epoch) bitwise the per-rank
     reference computed in this process on the card
     (`lockstep_reference`); B1 launched 10 times and its backward run 10
     times in every worker, no plain call; the gap to `train_stacked`'s
     10 epochs printed;
 35. the paper's workflow: `PAPER` (`rma_arar_arar`, h 1000) as 8 worker
     processes, 2 x 4, 50 epochs lock-step (phase 41 runs 200) and 50
     free-running with rank r sleeping r x 1 ms an epoch (phase 43 runs
     such a free run again, at depth 2): phase 22's bars on the
     history (every state leaf finite, the ensemble in (0, 1), the last
     d_loss (mean over ranks) below the first and its minimum below
     1.42), B1 once an epoch in every worker with its backward and no
     plain call; per-rank epoch p50/p99 and peak memory, generated
     events/s, the wall time from spawn to result and the workers'
     start-up, the summed B1 counts, beside phase 22's stacked epoch p50;
 36. the bf16 ring payload (`payload_precision="bf16"`, fp32 master
     state), stacked: `PAPER` at R 8 in `rma_arar_arar` (h 1000) and in
     `conv_arar` for 50 epochs each (phase 42 trains the bf16 payload for
     200, phase 40 `conv_arar` for 200) with phase 22's bars and counts,
     each epoch p50/p99 and events/s beside phase 22's fp32 p50 of the
     same run;
     `for_problem("imaging_blur", PAPER)` at bf16 for 50 epochs (phase
     46 trains imaging_blur for 200, phases 41-42 the bf16 payload) with
     phase 26's bars and counts (B1 on u [512, 32], B3 on [512, 32, 32]
     and as its backward); one bf16 epoch card vs CPU as phase 23 (the
     CPU's exchange of the card's gradients bitwise the card's).  Every
     trained state must hold the mailbox's weights and the outer mailbox
     in the payload's dtype and the master state in fp32 (phases 22, 26
     and 34-35 check the same at fp32);
 37. the bf16 payload on the proc runtime: phase 34's bitwise runs at
     bf16 (the deposit 101,632 B, half of fp32's, read off the ring's
     window from rank 0 to rank 1); phase 41 trains bf16 lock-step
     workers at h 1000 for 200 epochs, with phase 35's bars;
 38. the chunked ring (`SyncConfig(ring_chunking=N)`: the fused payload
     crosses as ceil(bytes / N) segments, one `torch.roll` each), stacked:
     `PAPER` at R 8 at 65,536 B (4 segments) in both ring modes, for 50
     epochs each (phase 42 trains the ring at 65,536 B for 200), with
     phase 22's bars and counts, each epoch p50 and events/s beside
     phase 22's; the
     first 10 epochs of each mode bitwise an unchunked run from the same
     seed; imaging_blur at 524,288 B (3 segments) for 50 epochs (phase
     46 trains it for 200 with overlap) with phase 26's bars and counts;
     `PAPER` at bf16 and 65,536 B (2 segments) for 50 epochs
     (phase 42 trains that payload for 200) with phase 22's bars, beside
     phase 36's bf16 p50;
 39. the chunked ring on the proc runtime: phase 34's bitwise runs at
     65,536 B (4 mmap windows a deposit, counted off the run directory),
     each bitwise `lockstep_reference` and phase 34's unchunked state;
     imaging_blur as 8 workers at 524,288 B (3 windows, 1,161,792 B a
     deposit; a lock-step run on the card picks deterministic cuDNN
     algorithms): 10 epochs bitwise `lockstep_reference`, then 50
     lock-step epochs (phase 46 trains imaging_blur at 524,288 B for 200,
     phase 41 lock-step workers) with phase 26's bars, B1 on u [64, 32]
     and B3 on
     [64, 32, 32] and as its backward in every worker, epoch p50 a rank,
     start-up and peak memory a worker (phase 49 runs these workers
     free-running, adaptive, at 524,288 B);
 40. the update cadences (`disc_every`, `gen_every`: the discriminator
     updates on epochs e with e % disc_every == 0, the generator with its
     exchange and Adam step on e % gen_every == 0; a skipped half launches
     nothing), stacked: `throughput(PAPER)` (the bf16 payload and
     disc_every 2) in `rma_arar_arar` for 50 epochs (phase 42 trains it
     for 200) and `PAPER` at disc_every 2, gen_every 3 in `conv_arar`
     for 200, with phase 22's bars
     read on the recorded epochs where the discriminator ran (the skipped
     halves' losses must be NaN), imaging_blur at (2, 3) for 50 epochs
     (phase 46 trains it for 200) with phase 26's
     bars; B1 (and B3) launched once on each epoch where a half runs and
     backward on the generator's epochs, no plain call; the epoch p50 of
     each combination of halves and the mean epoch beside phase 22's
     (26's) p50; one epoch card vs CPU for each skipped combination
     (disc only, gen only, neither) as phase 23, the signs pinned, the
     skipped state unchanged; 4 `throughput(PAPER)` epochs under one
     profiler, each in a range of its own: device ops and GEMMs of due
     and off epochs, an off epoch must launch fewer GEMMs;
 41. the update cadences on the proc runtime: `PAPER` at (2, 3) as 8
     workers, 10 lock-step epochs in `rma_arar_arar` h 2, bitwise
     `lockstep_reference`; `throughput(PAPER)` for 200 lock-step epochs
     with phase 35's bars read on the discriminator's epochs, the
     workers' B1 counts as phase 40 counts them, epoch p50 a rank by the
     halves that ran, start-up (phase 43 runs `throughput(PAPER)`
     workers free-running, at depth 2 and 65,536 B);
 42. the depth-k RMA mailbox (`staleness` k: epoch e reads its ring
     predecessor's deposit of epoch e - k from slot e % k of an [R, k,
     ...] mailbox, zeros before epoch k), stacked: `PAPER` at k 2 (the
     JAX `depth_k` row) for 50 epochs (phase 44 trains it for 200) with
     phase 22's bars and counts, its mailbox [8, 2, ...], epoch p50
     beside phase 22's;
     `throughput(PAPER)` at k 2 and 65,536 B (bf16, chunked, disc_every
     2 and depth together) with phase 40's bars and counts; imaging_blur
     at k 2 for 50 epochs (phase 46 trains it for 200) with phase 26's
     bars and counts (B1 on u [512, 32], B3 on
     [512, 32, 32] and as its backward); 8 epochs of the exchange at k 3,
     h 2, 2 x 4 ranks, at fp32 and bf16, whole and at 65,536 B, on
     gradients drawn on the card: outputs and sync state bitwise the
     CPU's exchange of the card's gradients, each read the deposit of
     e - k, every rank off the outer ring's synced gradient its own plus
     that read; the exchange alone at depth 1 and 3 in turns;
 43. the depth-k mailbox on the proc runtime: `PAPER` at k 3, h 2 as 8
     workers, 10 lock-step epochs bitwise `lockstep_reference` (the [8,
     3, ...] mailbox included; the wire is the depth-1 one); a free run
     of 50 epochs of phase 42's `throughput(PAPER)` at k 2 and 65,536 B
     (the bf16 payload, disc_every 2, 2 windows a deposit) with phase
     35's lag, which must end finite, epoch p50 a rank;
 44. the telemetry (`ObsConfig`), stacked: `PAPER` at k 2 with metrics
     and a metrics file for 50 epochs in chunks of 20 (phase 48 trains
     `PAPER` with metrics for 200), with phase 22's bars and
     counts: 1 header (schedule `sync`, payload_bytes 203,264) and 3
     rows, each k_eff 2 and exchange_count its epoch, epoch p50 beside
     phase 22's; 20 epochs with metrics on and off from one seed,
     every leaf outside "obs" bitwise; 20 epochs at disc_every 2,
     gen_every 3, exchange_count the generator's 7 epochs; imaging_blur
     for 20 epochs with a metrics file (payload_bytes 1,161,792), B1 and
     B3 at `due_counts`; 10 epochs under `profile_dir`, whose Chrome
     trace holds one device event of B1's `icdf_kernel` a launch after
     the profiler's first epoch (where it has dropped events);
 45. the telemetry as 8 workers with `trace_dir`: `PAPER` free-running
     (phase 35's lag) for 50 epochs and lock-step for 20, each summary's
     obs entry (an exchange an epoch of 203,264 B), the 8 rank traces
     merged (`obs.trace.merge_traces`), and each rank's epochs after the
     first broken down by span (`obs.trace.epoch_breakdown`:
     compute.grads, exchange and the waits inside it, compute.apply,
     jitter.sleep), epoch p50 a rank beside phase 35's untraced one;
 46. the overlapped pod boundary (`overlap`: the epoch before a due one
     ships its inner-synced payload across the pod boundary into the
     outer mailbox, and the due epoch adds it, one epoch old), stacked:
     `PAPER` with overlap at h 10 in `arar_arar` and `rma_arar_arar` for
     50 epochs each (phase 48 trains the overlap, with the adaptive
     schedule, for 200), with metrics and a metrics file, with phase 22's
     bars and counts: the header's schedule `overlap`, a row's ship_count
     its epoch / 10, the final ship_count 5 and exchange_count 50 on
     every rank; imaging_blur with overlap at h 10
     and 524,288 B with phase 26's bars and counts (B3 and its backward
     an epoch), beside phase 26's p50; 6 epochs of the exchange at h 2,
     depth 2, 2 x 4 ranks, at fp32 whole and at 65,536 B and at bf16, on
     gradients drawn on the card: outputs and sync state bitwise the
     CPU's exchange of the card's gradients, the outer mailbox rewritten
     on the ship epochs only, by the outer ring's shift of the synced
     payload; `PAPER` under sync and overlap at h 10 in turns
     (`scripts/payload_ab.py --lane overlap`, 50 epochs a turn);
 47. the overlapped pod boundary as 8 workers: `PAPER` with overlap at
     h 2 in `rma_arar_arar`, 10 lock-step epochs bitwise
     `lockstep_reference`, every rank's ship window holding one deposit
     a ship epoch and no outer-ring window; 50 free-running epochs at h
     10 with phase 35's lag, traced, under sync and under overlap (which
     must end finite): each rank's span shares and epoch p50 side by
     side, the overlap traces' `exchange.ship` spans on the ship epochs
     only and no `exchange.outer`, the sync traces' `exchange.outer` on
     every epoch;
 48. adaptive staleness (`adaptive`: a controller moves the RMA read
     depth k_eff in [1, k_max] on the skew the deposits' epoch tags show,
     and under overlap opens the ship gate up to k_eff epochs before a
     due one, once a cycle), stacked: `PAPER` adaptive at k_max 3 in
     `rma_arar_arar` (h 1000) with metrics for 200 epochs, with phase
     22's bars and counts, every epoch's obs row k_eff 1, skew 0 and
     deposit age 0, and the final state bitwise phase 22's static depth-1
     run from the same seed; `adaptive-overlap` at k_max 3, h 10 for 200
     epochs with phase 22's bars, ship_count 20 on every rank;
     imaging_blur adaptive at k_max 3 and 524,288 B for 50 epochs with
     phase 26's bars and counts (B3 and its backward an epoch); 20 epochs
     of the exchange with overlap at h 2, 2 x 4 ranks, at fp32 and bf16,
     whole and at 65,536 B, on gradients drawn on the card, with tags set
     3-5 epochs old before epochs 4-6: outputs, sync state (payload,
     tags, controller) and obs rows bitwise the CPU's exchange of the
     card's gradients, k_eff 1 -> 3 -> 1, one ship a cycle, some opened
     early by the stretched gate; static depth 1 and adaptive in turns
     (`scripts/payload_ab.py --lane adaptive`, 25 epochs a turn), with the
     exchange alone a call;
 49. adaptive staleness as 8 workers: `adaptive-overlap` at k_max 3, h
     2, 10 lock-step epochs bitwise `lockstep_reference`, every rank's
     max_skew_ema 0 and max_k_eff 1, the inner deposit its payload and
     tag in one window; 50 free-running epochs of phase 48's
     imaging_blur adaptive at k_max 4 and 524,288 B (B3 and its backward
     in every worker, 3 windows a deposit) with rank r sleeping 5r ms an
     epoch: every leaf and d_loss finite, some rank's max_skew_ema > 0
     and max_k_eff > 1, every k_eff in [1, 4], epoch p50 a rank;
 50. B4 at hubert-xlarge's calls (16 heads of 80, G 1, no mask, row
     stride 2,560 B): `flash_attention_model` on q [8, 1024, 16, 1, 80]
     (the encode pass) and [8, 256, 16, 1, 80] (a training step) bf16,
     the wgmma route, against its plain version at 2e-2 (the largest
     error joins the kernels line's); each timed as phase 12 times
     tinyllama's, beside the plain version,
     `scaled_dot_product_attention(is_causal=False)` (timed, never used
     by the port) and the bound (4·B·H·hd·S² FLOP at the bf16 peak, or
     q, k, v and o's bytes);
 51. hubert-xlarge's encode pass at full size (48 layers, bf16, random
     weights from a seed, `param_count` 1,259,715,840), batch 8 x 1024
     frames under `torch.no_grad`: 48 B4 launches a pass, all wgmma, no
     plain call, logits [8, 1024, 504] finite; pass p50 / p99 over 20
     counted passes after an uncounted one, frames/s, peak memory, a
     profile of one pass; then full width, depth 2, fp32 with TF32 off,
     batch 1, 256 frames on the card and on the CPU from one seed's
     weights: logits within 1e-3;
 52. hubert-xlarge trained at full size by `training.Trainer` through
     `TokenStream` at the `launch/train` defaults (batch 8, 256 frames,
     lr 3e-4) for 30 steps: 96 B4 launches (forward and remat
     recompute) and 48 plain-VJP backward passes a step, no plain
     forward, every loss finite, the loss of 4 held-out batches lower
     after than before; step p50 / p99, frames/s, peak memory, a profile
     of PROFILED_STEPS (1) step;
 53. B4 at internvl2-1b's calls (14 heads over 2: GQA group 7, hd 64,
     causal, row stride 1,792 B): `flash_attention_model` on q [8, 1024,
     2, 7, 64] (the prefill) and [8, 512, 2, 7, 64] (a training step)
     bf16, the wgmma route, against its plain version at 2e-2 (the
     largest error joins the kernels line's); each timed as phase 12
     times tinyllama's, beside the plain version,
     `scaled_dot_product_attention(is_causal=True)` with GQA (timed,
     never used by the port) and the bound (2·B·H·hd·S(S+1) FLOP at the
     bf16 peak, or q, k, v and o's bytes);
 54. internvl2-1b served at full size (24 layers, bf16, random weights
     from a seed, `param_count` 494,698,496): the image-plus-prompt batch
     of `data.make_batch` (8 requests of 256 patch embeddings and 768
     prompt tokens) through `serving.make_prefill_fn` at context 1024 +
     64 with last logits only, 10 counted prefills after an uncounted
     one, then 64 greedy steps of `make_serve_step`: 24 B4 launches a
     prefill, all wgmma, none in decode, no plain call, the cache's pos
     1024 after the prefill, every logit finite; prefill p50 / p99,
     decode step p50 / p99, tok/s including the prefill, peak memory;
     then full width, depth 2, fp32 with TF32 off, batch 1, 16 patches
     and 16 tokens, prefill and 4 greedy steps on the card and on the CPU
     from one seed's weights: logits within 1e-3, greedy ids equal;
 55. internvl2-1b trained at full size by `training.Trainer` through
     `TokenStream` at batch 8 and seq 512 (the whole 256-patch image and
     256 text tokens a sequence; lr 3e-4) for 30 steps: 48 B4 launches
     (forward and remat recompute) and 24 plain-VJP backward passes a
     step, no plain forward, every loss finite, the loss of 4 held-out
     batches lower after than before; step p50 / p99, text tokens/s and
     positions/s, peak memory, a profile of PROFILED_STEPS (1) step;
 56. B4 and B5 at jamba-1.5-large-398b's calls: `flash_attention_model`
     on q [8, 1024, 8, 8, 128] bf16 causal (64 heads over 8: GQA group 8,
     hd 128, row stride 16,384 B), timed as phase 53 times internvl2's
     beside the plain version, `scaled_dot_product_attention` with GQA
     (timed, never used by the port) and the bound; `ssd_scan` on x [8,
     1024, 256, 64] bf16, N 128, chunk 256 (four chunks: the chunk-state
     pass), timed as phase 17 times B5 beside the plain version and the
     bound; each against its plain version at 2e-2 (the largest errors
     join the kernels line's);
 57. jamba-1.5-large-398b served at full width with two cuts, one period
     of 8 layers and 8 of its 16 experts (bf16, random weights from a
     seed, `param_count` 25,817,044,992; the init's peak memory at most
     the model plus one leaf's fp32 draw and bf16 copy: the one-period
     stack is views of its draws): 8 prompts of 1024 tokens through
     `serving.make_prefill_fn` at context 1024 + 64 with last logits
     only, 10 counted prefills after an uncounted one, then 64 greedy
     steps of `make_serve_step`, a `moe.Tap` counting the capacity drops:
     one B4 launch a prefill, all wgmma, no B5 call (the prefill's scan is
     plain, as in the JAX package), no plain call, the cache's pos 1024
     after the prefill, every logit finite; prefill p50 / p99, decode
     step p50 / p99, tok/s including the prefill, the drops, peak memory;
 58. the same model's scoring pass, `loss_fn` without gradients on
     `make_batch(cfg, 8, 1024)`, 5 counted passes after an uncounted one:
     1 B4 and 7 B5 launches a pass, all wgmma, no plain call, the loss
     finite; pass p50 / p99, positions/s, peak memory; then a narrow
     hybrid at jamba's period (8 layers, attention at offset 4, MoE on
     the odd layers) and kernel widths (8 heads over 1 of 128; 32
     Mamba-2 heads of P 64, N 128, chunk 256; d_model 1024, d_ff and
     moe_d_ff 1024, 4 experts, vocab 257), fp32 with TF32 off, on the
     card and on the CPU from one seed's weights: forward logits at batch
     2 x 512 within 1e-3, a 1 x 512 prefill and 4 greedy steps with equal
     tokens, and one `Trainer` step at 1 x 300 (two chunks) through
     `step_card_vs_cpu` (routing pinned at near-ties);
 59. the remat policy "dots" (keep every matmul output without batch
     dimensions, recompute the rest) against "full" on mamba2-130m at
     full size (bf16, batch 8 x 256, random weights from a seed): one
     forward and backward under no remat, "dots" and "full" from one set
     of weights and one batch: "dots" against "full" at phase 20's bars
     (loss, every gradient leaf; whether bitwise), the backward's
     `aten.mm`/`aten.addmm` and `aten.bmm` beyond the backward without
     remat (`REMAT_RERUN`: 120 and 0 under "full", 0 and 0 under "dots"),
     48 B5 launches, all wgmma, under either policy, the memory held
     after the forward ("dots" above "full" by at least the outputs the
     policy kept) and each run's peak; 3 donating train steps a policy in
     turns on one state (`REMAT_STEPS`): step p50 and peak memory by
     policy; then `launch.train --steps 3 --ckpt-dir` in this process
     writes one checkpoint, its bytes and write seconds, and
     `restore_checkpoint` reads it back onto the card, every leaf equal;
 60. the same for granite-moe-3b-a800m at full size (B4 at G 3; the
     router's matmul kept, the experts' batched GEMMs recomputed; the
     routing of "full" pinned to the choices of "dots"): 160 and 96
     re-run under "full", 0 and 96 under "dots", 64 B4 launches a step,
     all wgmma, the memory held after the forward, 2 train steps a
     policy in turns.

`python3 chip_smoke.py --times` runs phases 1, 2 and 4 alone, to compare
two checkouts on one card: copy this script into the root of the other
(a `git archive` of an earlier commit, say) and run it there too, in
turns.  An earlier checkout's kernel that has no launch-floor entry or
refuses [16, 256, 256] is reported there, not failed.

Each served path runs with every kernel count set to 0 just before it and
read just after it; the worker processes of phases 34-35, 37, 39, 41, 43,
45, 47 and 49 count their own launches and report them (the kernels line
adds them).  The last lines are the `kernels` JSON line, the card's
nvidia-smi line, and `{"ok": true, "device": {...}}`.  Without CUDA, or
without the repo's `src/repro_torch` beside it, the script exits non-zero
and prints no result.  It imports nothing of JAX.
"""
import contextlib
import ctypes
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BLUR = dict(rtol=1e-6, atol=1e-6)
TIE_GAP = 1e-5                  # kept sets may differ only within this
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12      # H100 SXM bf16 dense tensor cores
MAIN_SHAPE = (2048, 64, 2)      # sampler u at DEFAULT with 16 ranks
MASK_SHAPE = (2048, 1024)       # mask x at DEFAULT: 16 ranks x 128 cands
BLUR_SHAPE = (2048, 32, 32)     # blur x at DEFAULT
BLUR_BIG_SHAPE = (16, 256, 256)   # large images: 8.4 MB, half BLUR_SHAPE's
BLUR_ROWS = (None, 1, 3, 4, 32, 64, 1000)   # band heights (None: the plan)
TRAIN_ICDF_SHAPE = (8192, 100, 2)   # u of the GAN trainer's PAPER preset:
                                    # 8 ranks x 1024 samples, 100 events
PROC_ICDF_SHAPE = (1024, 100, 2)    # ... one rank's, a proc worker's call
TRAIN_ICDF_C3 = (8192, 100, 3)      # ... for proxy2d (3 channels)
TRAIN_ICDF_C4 = (8192, 100, 4)      # ... for linear_blur (4 channels)
TRAIN_IMAGES = 512                  # imaging training: 8 ranks x 64 samples
TRAIN_READOUT_SHAPE = (TRAIN_IMAGES, 32)    # B1's u: the readout's noise
TRAIN_MASK_SHAPE = (TRAIN_IMAGES, 1024)     # B2's x training imaging
TRAIN_BLUR_SHAPE = (TRAIN_IMAGES, 32, 32)   # B3's x training imaging_blur
PROC_IMAGES = 64                    # ... one rank's, a proc worker's calls
PROC_READOUT_SHAPE = (PROC_IMAGES, 32)
PROC_BLUR_SHAPE = (PROC_IMAGES, 32, 32)
L2_ROTATION = 8                 # B2/B3 input sets cycled: 67 MB > the 50 MB L2
SPIN_CYCLES = 20_000_000        # ~10 ms at 1.98 GHz: outlasts 20 enqueues
MARK_CYCLES = 1_000             # phase 44's marker kernel, ~0.5 us
RANKS = 16
LLM_ARCH = "tinyllama-1.1b"
LLM_BATCH, LLM_PROMPT, LLM_NEW = 8, 1024, 64
WARM_NEW = 4                    # phases 13, 21, 30: the warm-up's tokens
LLM_WINDOW = 256
FLASH_Q = (8, 32, 1024, 64)     # B4 q at the prefill shape; k/v have 4 heads
FLASH_KV_HEADS = 4
TILES = [(bq, bk) for bq in (32, 64, 128) for bk in (32, 64, 128)]
TILE_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_ATOL = 1e-3               # phase 14, card against CPU (fp32)
TOP2_GAP = 1e-4                 # below this a greedy pick may differ
SSD_TRAIN = (8, 256, 24, 64, 128)    # B5 x [B, S, H, P] and N, training
SSD_MULTI = (8, 2048, 24, 64, 128)   # four chunks of 512
SSD_FP32 = dict(rtol=1e-3, atol=1e-3)          # tests/test_kernels.py
SSD_INVARIANCE = dict(rtol=1e-4, atol=1e-4)
TRAIN_ARCH = "mamba2-130m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 30   # phase 19 (59 again)
MAMBA_PARAMS = 128_983_488
CARD_VS_CPU_STEPS = (("mamba2-130m", 1, 1024), ("tinyllama-1.1b", 1, 256))
HELD_OUT_SEED, HELD_OUT_BATCHES = 10_000, 4   # phases 19, 32: loss check
STEP_LOSS_RTOL = 1e-5           # phase 20, card against CPU (fp32)
STEP_GRAD_REL = 1e-3            # each gradient leaf, in relative norm
KINK_GRAD_REL = 1e-5            # phase 27: ... with the CPU at the card's
                                # Leaky ReLU signs (`leaky_kinks`)
UPDATE_TOL = dict(rtol=1e-6, atol=1e-9)   # the optimizer, card vs CPU
GAN_MODES = ("rma_arar_arar", "conv_arar")   # test_system.py's two modes
GAN_OUTER, GAN_INNER = 2, 4     # R 8: 2 nodes of 4 GPUs (Tab. I)
GAN_EPOCHS, GAN_EVERY = 200, 20     # phase 22: epochs, history cadence
GAN_REF_EVENTS = 50_000         # reference events, as the example CLI
GAN_D_MIN = 1.42                # the healthy bar on min d_loss
GAN_PROFILED = 5                # phase 24's and 28's epochs
PROBLEMS_SERVED = ("proxy2d", "linear_blur")    # phase 25
PROBLEMS_TRAINED = ("proxy2d", "linear_blur", "imaging", "imaging_blur")
# phase 26: the kernel each problem's forward model runs beside B1
TRAINED_FORWARD = {"proxy2d": None, "linear_blur": None,
                   "imaging": "mask_apply", "imaging_blur": "blur2d"}
MOE_SERVE_ARCH = "qwen2-moe-a2.7b"       # phases 29-31
MOE_SERVE_SIZE = (24, 2048)              # its layers and d_model
MOE_TRAIN_ARCH = "granite-moe-3b-a800m"  # phases 29, 32, 33
MOE_TRAIN_SIZE = (32, 1536)
MOE_LAYER_T = 512               # phase 29's tokens
MOE_FORCED = (0, 2)             # phase 29: experts the biased router favours
MOE_FORCED_LOGIT = 3.0          # ... by this much on average (x's mean 0.5)
MOE_Y = dict(rtol=1e-4, atol=1e-5)   # phase 29: y (fp32) against float64,
                                     # atol in units of max |y|
AUX_RTOL = 1e-6                 # phase 29, the aux loss
ROUTE_GAP = 1e-6                # a top-k choice may differ below this gap
MOE_TRAIN_STEPS = 15            # phase 32 (33 and 60 step it again)
PROFILED_STEPS = 1              # phases 19, 32, 52: steps under the profiler
                                # (reading a step's events back takes ~6 s)
MOE_RANGES = ("moe.dispatch", "moe.experts", "moe.combine")  # models.moe's
PROC_BITWISE = (("rma_arar_arar", 2), ("conv_arar", 2))   # phase 34: mode, h
PROC_BITWISE_EPOCHS = 10        # phase 34
PROC_LAG_MS = 1.0               # phase 35's free run: rank r sleeps r ms
PROC_TIMEOUT_S = 600            # a proc run, spawn to result
RING_CHUNK = 65_536             # phases 38-39: PAPER's 50,816 scalars in 4
IMAGE_RING_CHUNK = 524_288      # ... the conv generator's 290,448 in 3
CHUNK_BITWISE_EPOCHS = 10       # phase 38: chunked = unchunked, stacked
PROC_FREE_EPOCHS = 50           # free runs (35, 43, 45, 47, 49)
CUT_EPOCHS = 50                 # paths a later phase drives again for
                                # GAN_EPOCHS: 35's lock-step run (41's),
                                # 38's chunked runs (42's), 42's
                                # PAPER at staleness 2 (44's), 36's, 38's
                                # and 39's imaging_blur (46's), 46's
                                # overlap (48's)
CADENCE = (2, 3)                # phases 40-41: disc_every, gen_every (the
#                                 JAX package's fp32_cadence row)
CADENCE_PROFILED = 4            # phase 40's profiled epochs
STALENESS = 2                   # phases 42-43: the RMA mailbox's depth k
                                # (JAX's `depth_k` row), and for the
STALENESS_BITWISE = 3           # ... exchange on the card and 8 workers
DEPTH_EXCHANGE_EPOCHS = 8       # phase 42: the exchange card vs CPU
EXCHANGE_CALLS = 200            # phase 42: exchanges a timed turn
OBS_EPOCHS = 20                 # phases 44-45: the shorter obs runs
OVERLAP_H = 10                  # phases 46-47: a ship and a due combine
#                                 every 10 epochs (20 of each in 200)
OVERLAP_BITWISE_H = 2           # ... the card-vs-CPU exchange, 8 workers
OVERLAP_EXCHANGE_EPOCHS = 6     # phase 46: the exchange card vs CPU
OVERLAP_AB_EPOCHS = 25          # phase 46: epochs a turn, sync vs overlap
OBS_PROFILED = 10               # phase 44's epochs under profile_dir
ADAPTIVE_K = 3                  # phases 48-49: the adaptive k_max
ADAPTIVE_FREE_K = 4             # phase 49's free run (tests/test_runtime.py)
ADAPTIVE_LAG_MS = 5.0           # ... rank r sleeps r x this an epoch
ADAPTIVE_EXCHANGE_EPOCHS = 20   # phase 48: the exchange card vs CPU
ADAPTIVE_DRIVE = {4: 3, 5: 4, 6: 5}   # ... tags set this much older
                                # before the epoch: k_eff 1 -> 3 -> 1
AUDIO_ARCH = "hubert-xlarge"    # phases 50-52
HUBERT_PARAMS = 1_259_715_840   # the JAX init's leaves
ENCODE_BATCH, ENCODE_FRAMES = 8, 1024   # phase 51: the encoder's prefill
ENCODE_PASSES = 20              # phase 51's counted passes
AUDIO_TRAIN_STEPS = 30          # phase 52
VLM_ARCH = "internvl2-1b"       # phases 53-55
INTERNVL2_PARAMS = 494_698_496  # the JAX init's leaves
VLM_BATCH, VLM_SEQ, VLM_NEW = 8, 1024, 64   # phase 54: 256 patches + 768
VLM_PREFILLS = 10               # ... prompt tokens; counted prefills
VLM_CHECK_SEQ, VLM_CHECK_NEW = 32, 4   # phase 54's depth-2 card vs CPU
VLM_TRAIN_SEQ = 512             # phase 55: 256 patches + 256 text tokens
VLM_TRAIN_STEPS = 30            # phase 55, as phase 52's hubert
HYBRID_ARCH = "jamba-1.5-large-398b"   # phases 56-58
HYBRID_CUT = dict(num_layers=8, num_experts=8)   # one period, 8 of 16
HYBRID_PARAMS = 25_817_044_992  # ... experts: the JAX init's leaves
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = 8, 1024, 64   # phase 57
HYBRID_PREFILLS = 10            # ... counted prefills
HYBRID_PASSES = 5               # phase 58's counted scoring passes
HYBRID_NARROW = dict(d_model=1024, num_heads=8, num_kv_heads=1, d_ff=1024,
                     num_experts=4, moe_d_ff=1024, vocab_size=257,
                     dtype="float32")   # phase 58: hd 128, G 8; ssm as cut
HYBRID_CHECK_BATCH, HYBRID_CHECK_SEQ = 2, 512   # ... its forward
HYBRID_CHECK_NEW = 4            # ... greedy steps after a 1 x 512 prefill
HYBRID_STEP_SEQ = 300           # ... its step: two chunks, 256 and 44
REMAT_RERUN = {"mamba2-130m": (5, 0),          # phases 59-60: aten.mm/addmm
               "granite-moe-3b-a800m": (5, 3)}  # and aten.bmm the backward
# re-runs a layer under "full" (the SSM's five in-projections; q, k, v, o
# and the router, and the three expert GEMMs); the recompute stops once
# the backward has what it reads, before a product only the residual add
# reads (the SSM's out_proj)
REMAT_STEPS = {"mamba2-130m": 3,           # phases 59-60: train steps a
               "granite-moe-3b-a800m": 2}  # policy, in turns
CKPT_STEPS = 3                  # phase 59: the CLI's steps before its write
FLAG_NAMES = {(True, True): "both halves", (True, False): "disc only",
              (False, True): "gen only", (False, False): "neither"}


def gemm_kernel(low):
    """Whether a kernel (its lower-case name) is a GEMM of cuBLAS or
    CUTLASS, as every profile here groups them."""
    return any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet",
                                  "sm90_"))


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def close(a, b, rtol, atol):
    """(ok, max |a - b|) with NaN where both are NaN counted as equal."""
    a, b = a.float(), b.float()
    nan_a, nan_b = a.isnan(), b.isnan()
    if not bool((nan_a == nan_b).all()):
        return False, float("nan")
    a, b = a[~nan_a], b[~nan_b]
    err = (a - b).abs()
    worst = float(err.max()) if err.numel() else 0.0
    return bool((err <= atol + rtol * b.abs()).all()), worst


def cuda_ms(fn, device_only, inner=20, samples=50, warmup=20):
    """Median milliseconds of one call of `fn`, by CUDA events.

    device_only: a spin kernel holds the stream while the host enqueues
    the `inner` calls, so the events time the card's work alone, not the
    host's launch overhead; else calls run back to back as a caller
    issues them, and a host-bound call shows its host time."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rotating(call, arg_sets):
    """A no-argument call that takes the next of `arg_sets` each time."""
    it = itertools.cycle(arg_sets)
    return lambda: call(*next(it))


def bound(n_bytes, n_ops, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and operations over the card's peak rate for their type (fp32
    outside the tensor cores unless `ops_per_s` says otherwise)."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def write_stack(directory, widths, ranks, step=1):
    """A random [ranks, ...] generator stack in the JAX package's store
    layout (step_<n>/arrays.npz + meta.json), written with numpy."""
    rng = np.random.default_rng(SEED)
    arrays = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        arrays[f"gen/{i}/w"] = (rng.standard_normal((ranks, a, b))
                                * np.sqrt(2.0 / a)).astype(np.float32)
        arrays[f"gen/{i}/b"] = (0.01 * rng.standard_normal((ranks, b))
                                ).astype(np.float32)
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays),
                   "dtypes": {k: str(v.dtype) for k, v in arrays.items()}}, f)
    return arrays


def conv_stack_arrays(leaf_shapes, ranks):
    """A random [ranks, ...] conv generator stack as the JAX package's
    path-flattened numpy arrays ("proj/w", "convs/0/w", ...): Kaiming-normal
    weights (fan-in = all but the last axis) and small non-zero biases."""
    rng = np.random.default_rng(SEED + 2)
    arrays = {}
    for key, shape in leaf_shapes.items():
        if key.endswith("/w"):
            fan_in = int(np.prod(shape[:-1]))
            a = rng.standard_normal((ranks,) + shape) * np.sqrt(2.0 / fan_in)
        else:
            a = 0.01 * rng.standard_normal((ranks,) + shape)
        arrays[key] = a.astype(np.float32)
    return arrays


def flash_phases(dev):
    """Phases 11 and 12: B4 against its plain version, then its times.
    Returns (the largest |kernel - plain| over the main paths' calls, the
    model layout in bf16, and the timing of tinyllama-1.1b's prefill call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    g = torch.Generator(device="cpu").manual_seed(SEED + 3)

    def qkv(B, H, KV, S, hd, dtype):
        return tuple(torch.randn(shape, generator=g).to(dev, dtype)
                     for shape in ((B, H, S, hd), (B, KV, S, hd),
                                   (B, KV, S, hd)))

    def check(tag, q, k, v, causal, window, bq=fa.BLOCK_Q, bk=fa.BLOCK_K):
        o = fa.flash_attention(q, k, v, causal, window, bq, bk)
        torch.cuda.synchronize()
        tol = FP32 if q.dtype == torch.float32 else BF16
        ok, err = close(o, flash_attention_ref(q, k, v, causal, window),
                        **tol)
        if not ok or o.dtype != q.dtype or o.shape != q.shape:
            fail(f"flash_attention kernel disagrees with its plain version "
                 f"at {tag} (max {err:.3e})")
        return o, err

    B, H, S, hd = FLASH_Q
    KVh, G = FLASH_KV_HEADS, H // FLASH_KV_HEADS
    # the tiles each route runs on the model path
    main_tiles = {torch.bfloat16: (fa.TC_BLOCK_Q, fa.TC_BLOCK_K),
                  torch.float32: (fa.BLOCK_Q, fa.BLOCK_K)}
    prefill = {}
    for dtype, (bq, bk) in main_tiles.items():
        prefill[dtype] = qkv(B, H, KVh, S, hd, dtype)
        _, err = check(f"the prefill shape {dtype}", *prefill[dtype], True,
                       None, bq, bk)
        print(f"[11] flash_attention q[{B}, {H}, {S}, {hd}] k/v[{B}, {KVh}, "
              f"{S}, {hd}] {str(dtype)[6:]} causal, tiles {bq}x{bk}: "
              f"max |kernel - plain| = {err:.3e} ok")
    del prefill[torch.float32]
    # each main path's own call: the model layout [B, S, KV, G, hd] at the
    # bf16 route's tiles, at the prefill's (served) or the step's (trained)
    # shape; tinyllama's from the inputs above, which phase 12 times
    q, k, v = prefill[torch.bfloat16]
    qm = q.transpose(1, 2).reshape(B, S, KVh, G, hd).contiguous()
    km, vm = (x.transpose(1, 2).contiguous() for x in (k, v))
    del q, k, v
    main_err = 0.0
    for arch, (b, s) in ((LLM_ARCH, (LLM_BATCH, LLM_PROMPT)),
                         (MOE_SERVE_ARCH, (LLM_BATCH, LLM_PROMPT)),
                         (MOE_TRAIN_ARCH, (TRAIN_BATCH, TRAIN_SEQ))):
        c = get_config(arch)
        kv, d = c.num_kv_heads, c.resolved_head_dim
        shape = (b, s, kv, c.num_heads // kv, d)
        if arch == LLM_ARCH:
            args = (qm, km, vm)
        else:
            args = tuple(torch.randn(sh, generator=g).to(dev, torch.bfloat16)
                         for sh in (shape, (b, s, kv, d), (b, s, kv, d)))
        if args[0].shape != shape:
            fail(f"phase 11: {arch}'s model layout {list(shape)} is not "
                 f"{list(args[0].shape)}")
        fa.counts.reset()
        om = fa.flash_attention_model(*args, True, None)
        torch.cuda.synchronize()
        ok, err = close(om, fa._plain_model(*args, True, None), **BF16)
        if (not ok or om.dtype != args[0].dtype or om.shape != shape
                or fa.counts.routes != {"fma": 0, "wgmma": 1}):
            fail(f"flash_attention_model disagrees with its plain version at "
                 f"{arch}'s call q{list(shape)} bf16 (max {err:.3e}, routes "
                 f"{fa.counts.routes})")
        main_err = max(main_err, err)
        print(f"[11] flash_attention_model q{list(shape)} "
              f"k/v{list(args[1].shape)} bf16 causal ({arch}'s "
              f"{'step' if arch == MOE_TRAIN_ARCH else 'prefill'} call, "
              f"wgmma route, tiles {fa.TC_BLOCK_Q}x{fa.TC_BLOCK_K}): max "
              f"|kernel - plain| = {err:.3e} ok")
        del args, om
    masks = {"causal": (True, None), "full": (False, None),
             "window64": (True, 64), "window256": (True, 256)}
    worst, n = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0
    # every group at every head dim, and G 7 (internvl2-1b's 14 heads over
    # 2, odd and not a power of two) at its head dim 64
    sweep = [(G, d) for G in (1, 3, 4, 8) for d in (32, 64, 80, 128)]
    for (G, d), (mname, (causal, window)), L, dtype in itertools.product(
            sweep + [(7, 64)], masks.items(), (1, 100, 1000),
            (torch.float32, torch.bfloat16)):
        bq, bk = TILES[n % len(TILES)]
        n += 1
        _, err = check(f"G={G} hd={d} {mname} S={L} {dtype} tiles {bq}x{bk}",
                       *qkv(2, 2 * G, 2, L, d, dtype), causal, window, bq, bk)
        worst[dtype] = max(worst[dtype], err)
    print(f"[11] flash_attention sweep: {n} cases (G 1/3/4/8 (3: "
          f"granite-moe-3b-a800m's) at hd 32/64/80/128 "
          f"(80: hubert-xlarge's 1280 / 16), and G 7 (internvl2-1b's 14 "
          f"heads over 2) at hd 64; causal/full/window 64/window "
          f"256, S 1/100/1000, fp32 and bf16, all 9 tile pairs in turn) "
          f"within fp32 rtol 1e-4 / atol 1e-5 and bf16 2e-2; max |kernel - "
          f"plain| fp32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e}")
    for L, window in ((1000, 64), (1024, None), (300, 8)):
        q, k, v = qkv(1, 8, 2, L, 64, torch.float32)
        outs = [check(f"S={L} window {window} tiles {bq}x{bk}", q, k, v,
                      True, window, bq, bk)[0] for bq, bk in TILES]
        spread = max(float((o - outs[0]).abs().max()) for o in outs)
        for (bq, bk), o in zip(TILES, outs):
            ok, err = close(o, outs[0], **TILE_TOL)
            if not ok:
                fail(f"flash_attention tiles {bq}x{bk} differ from "
                     f"{TILES[0]} by {err:.3e} at S={L}, window {window}")
        print(f"[11] flash_attention S={L} window {window} fp32: all 9 tile "
              f"pairs within rtol 1e-5 / atol 1e-6 of 32x32 (max spread "
              f"{spread:.3e})")
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        outs = [check(f"S={L} window {window} bf16 tiles {bq}x{bk}", q, k, v,
                      True, window, bq, bk)[0] for bq, bk in TILES]
        spread = max(float((o.float() - outs[0].float()).abs().max())
                     for o in outs)
        for (bq, bk), o in zip(TILES, outs):
            ok, err = close(o, outs[0], **BF16)
            if not ok:
                fail(f"flash_attention bf16 tiles {bq}x{bk} differ from "
                     f"{TILES[0]} by {err:.3e} at S={L}, window {window}")
        print(f"[11] flash_attention S={L} window {window} bf16: all 9 tile "
              f"pairs (kernel tiles {sorted(set(map(fa.tc_tiles, *zip(*TILES))))}"
              f") within 2e-2 of 32x32 (max spread {spread:.3e})")
    for dtype, rt in ((torch.float32, "fma"), (torch.bfloat16, "wgmma")):
        fa.counts.reset()
        check(f"the {rt} route", *qkv(1, 4, 2, 64, 64, dtype), True, None)
        if fa.counts.launches != 1 or fa.counts.routes[rt] != 1:
            fail(f"flash_attention {dtype}: routes {fa.counts.routes}, "
                 f"expected one launch on the {rt} route")
    # the strided model layout: q, k, v as views of one fused projection
    fused = torch.randn((2, 1024, 4, 10, 64), generator=g).to(
        dev, torch.bfloat16)
    fq, fk, fv = fused[:, :, :, :8], fused[:, :, :, 8], fused[:, :, :, 9]
    fa.counts.reset()
    fo = fa.flash_attention_model(fq, fk, fv, True, None)
    torch.cuda.synchronize()
    ok, err = close(fo, fa._plain_model(fq, fk, fv, True, None), **BF16)
    if not ok or fa.counts.routes != {"fma": 0, "wgmma": 1}:
        fail(f"flash_attention_model on strided bf16 views: max err "
             f"{err:.3e}, routes {fa.counts.routes}")
    print(f"[11] flash_attention routes: fp32 -> fma (flash_attention.cu), "
          f"bf16 -> wgmma (flash_attention_tc.cu), one launch each; "
          f"flash_attention_model on non-contiguous bf16 views of a fused "
          f"[2, 1024, 4, 10, 64] projection: max |kernel - plain| "
          f"{err:.3e}, no copies")
    del fused, fq, fk, fv, fo

    # -- 12. time at the prefill shape, bf16 ---------------------------------
    q, k, v = prefill.pop(torch.bfloat16)

    def library(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    try:
        library(q[:1, :, :8], k[:1, :, :8], v[:1, :, :8])
        lib_args, lib_note = (q, k, v), "enable_gqa=True"
    except TypeError:          # no enable_gqa: repeat the KV heads first
        lib_args = (q, k.repeat_interleave(G, 1).contiguous(),
                    v.repeat_interleave(G, 1).contiguous())
        lib_note = "KV heads repeated before the call"

        def library(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    ok, err = close(library(*lib_args),
                    flash_attention_ref(q, k, v, True, None), **BF16)
    if not ok:
        fail(f"scaled_dot_product_attention computes another function than "
             f"the plain version (max err {err:.3e})")
    tq, tk = fa.TC_BLOCK_Q, fa.TC_BLOCK_K       # the prefill's bf16 tiles
    # the prefill's call, checked in phase 11: the model layout by strides
    t = dict(ms=cuda_ms(lambda: fa.flash_attention_model(qm, km, vm), True),
             plain_ms=cuda_ms(lambda: flash_attention_ref(q, k, v), True,
                              inner=3, samples=10, warmup=3),
             library_ms=cuda_ms(lambda: library(*lib_args), True))
    public_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, True, None, tq,
                                                   tk), True)
    n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    n_ops = 4 * B * H * hd * (S * (S + 1) // 2)      # QK^T and PV, causal
    t["bound_ms"], t["bound_by"] = bound(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    print(f"[12] flash_attention_model q{list(qm.shape)} bf16 causal (the "
          f"prefill's call), card time: kernel (bf16 route, wgmma, tiles "
          f"{tq}x{tk}) {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
          f"scaled_dot_product_attention {t['library_ms']:.5f} ms "
          f"({lib_note}, on [B, H, S, hd]; max err against the plain "
          f"version {err:.3e}); bound {t['bound_ms']:.6f} ms by "
          f"{t['bound_by']} ({n_bytes} B, {n_ops} FLOP at the bf16 "
          f"tensor-core peak; at the fp32 peak "
          f"{n_ops / FP32_OPS_PER_S * 1e3:.5f} ms); kernel at "
          f"{n_ops / t['ms'] / 1e9:.2f} TFLOP/s; flash_attention on "
          f"q{list(q.shape)} (the same kernel on strided views) "
          f"{public_ms:.5f} ms")
    tiles = {}
    for bq, bk in TILES:
        tiles[(bq, bk)] = cuda_ms(
            lambda: fa.flash_attention(q, k, v, True, None, bq, bk), True,
            inner=3, samples=5, warmup=2)
    print("[12] flash_attention bf16 card ms by tiles (block_q x block_k): "
          + ", ".join(f"{bq}x{bk} {ms:.4f}" for (bq, bk), ms in
                      tiles.items()))

    def with_copies():
        o = fa.flash_attention(
            qm.reshape(B, S, H, hd).transpose(1, 2).contiguous(),
            km.transpose(1, 2).contiguous(), vm.transpose(1, 2).contiguous(),
            True, None, tq, tk)
        return o.transpose(1, 2).reshape(qm.shape).contiguous()
    copies_ms = cuda_ms(with_copies, True)
    print(f"[12] flash_attention_model q{list(qm.shape)} bf16: "
          f"{t['ms']:.5f} ms reading the model layout by strides, against "
          f"{copies_ms:.5f} ms for three transposing copies, the kernel and "
          f"the output's copy")
    q32, k32, v32 = (x.float() for x in (q, k, v))
    ms32 = cuda_ms(lambda: fa.flash_attention(q32, k32, v32), True,
                   inner=5, samples=10, warmup=2)
    print(f"[12] flash_attention fp32 at the same shape: fp32 route "
          f"(flash_attention.cu) {ms32:.5f} ms")
    return main_err, t


def llm_phases(dev, all_counts):
    """Phases 13-15: tinyllama-1.1b served at full size, the card against
    the CPU at full width and depth 2, and a profile.  Returns B4's
    launches over the counted runs of phase 13."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import generate

    cfg = get_config(LLM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init(gen, cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = M.param_count(params)
    want = cfg.param_counts()["total"] + (2 * cfg.num_layers + 1) \
        * cfg.d_model
    if n_params != want or cfg.num_layers != 22 or cfg.d_model != 2048:
        fail(f"{LLM_ARCH}: {n_params} parameters, {cfg.num_layers} layers, "
             f"d_model {cfg.d_model}; expected {want}, 22, 2048")
    print(f"[13] {LLM_ARCH}: {n_params:,} parameters ({cfg.dtype}, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads over {cfg.num_kv_heads} KV heads, attn_impl "
          f"{cfg.attn_impl}) made on the card from seed {SEED} in "
          f"{time.perf_counter() - t0:.2f}s")
    launches = 0
    for window in (None, LLM_WINDOW):
        c = cfg.replace(sliding_window=window)
        # warm-up at the same shapes, not counted: the first call at a
        # shape grows the allocator's pool and picks the GEMMs' kernels
        # (the same context, so the same cache; a decode step's shapes do
        # not change from step to step)
        generate(params, c, prompts, WARM_NEW,
                 context_len=LLM_PROMPT + LLM_NEW)
        events, finite = [], []

        def on_logits(i, lg):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            finite.append(torch.isfinite(lg).all())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats(dev)
        for cnt in all_counts.values():
            cnt.reset()                # --- the counted main-path run ---
        t0 = time.perf_counter()
        start.record()
        out = generate(params, c, prompts, LLM_NEW, on_logits=on_logits)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        got = {k: (cnt.launches, cnt.plain_calls)
               for k, cnt in all_counts.items()}
        # ------------------------------------------------------------------
        expect = {k: ((c.num_layers if k == "flash_attention" else 0), 0)
                  for k in all_counts}
        if got != expect:
            fail(f"{LLM_ARCH} window {window}: (kernel launches, plain "
                 f"calls) {got}; expected {expect} (one B4 launch per layer "
                 f"of the prefill)")
        routes = dict(all_counts["flash_attention"].routes)
        if routes != {"fma": 0, "wgmma": c.num_layers}:
            fail(f"{LLM_ARCH} window {window}: B4 routes {routes}; expected "
                 f"every launch on the bf16 (wgmma) route")
        launches += got["flash_attention"][0]
        new = out[:, LLM_PROMPT:]
        if out.shape != (LLM_BATCH, LLM_PROMPT + LLM_NEW) \
                or not torch.equal(out[:, :LLM_PROMPT], prompts) \
                or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
            fail(f"{LLM_ARCH}: generated ids of shape {tuple(out.shape)} "
                 f"outside [0, {cfg.vocab_size})")
        if not bool(torch.stack(finite).all()):
            fail(f"{LLM_ARCH} window {window}: non-finite logits")
        prefill_ms = start.elapsed_time(events[0])
        steps = np.array([a.elapsed_time(b)
                          for a, b in zip(events[:-1], events[1:])])
        total_ms = start.elapsed_time(end)
        print(f"[13] {LLM_ARCH} window {window}: batch {LLM_BATCH}, prompt "
              f"{LLM_PROMPT}, {LLM_NEW} greedy tokens; B4 launches "
              f"{got['flash_attention'][0]}, plain calls "
              f"{got['flash_attention'][1]}, by route {routes}; no other "
              f"kernel; logits finite")
        print(f"[13] {LLM_ARCH} window {window}: prefill {prefill_ms:.3f} ms "
              f"({LLM_BATCH * LLM_PROMPT / prefill_ms * 1e3:.0f} prompt "
              f"tok/s), decode step p50 {np.percentile(steps, 50):.3f} ms, "
              f"p99 {np.percentile(steps, 99):.3f} ms over {len(steps)} "
              f"steps of {LLM_BATCH} tokens, "
              f"{LLM_BATCH * LLM_NEW / total_ms * 1e3:.1f} "
              f"tok/s generated including prefill ({total_ms:.1f} ms on the "
              f"card's clock, {wall * 1e3:.1f} ms on the host's); peak "
              f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        print(f"[13]   request 0, first 12 new ids: {new[0, :12].tolist()}")

    # -- 14. the card against the CPU, full width, depth 2, fp32 -------------
    for window in (None, 64):
        c = cfg.replace(num_layers=2, dtype="float32", sliding_window=window)
        small = M.init(torch.Generator().manual_seed(SEED + 4), c, "cpu")
        tok = torch.randint(0, c.vocab_size, (1, 256),
                            generator=torch.Generator().manual_seed(SEED + 5))
        runs = {}
        for d in ("cpu", dev):
            logits = []
            p = M.map_params(lambda x: x.to(d), small)
            out = generate(p, c, tok.to(d), 8,
                           on_logits=lambda i, lg: logits.append(lg.cpu()))
            runs[str(d)] = (out.cpu(), torch.cat(logits, 1))
        (out_c, lg_c), (out_g, lg_g) = runs["cpu"], runs[str(dev)]
        err = float((lg_g - lg_c).abs().max())
        if err > LOGIT_ATOL:
            fail(f"phase 14 window {window}: card logits differ from the "
                 f"CPU's by {err:.3e} (> {LOGIT_ATOL})")
        top2 = torch.topk(lg_c, 2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1])[0]
        for i in range(8):
            if out_c[0, 256 + i] != out_g[0, 256 + i]:
                if float(gaps[i]) >= TOP2_GAP:
                    fail(f"phase 14 window {window}: token {i} differs "
                         f"(CPU top-2 gap {float(gaps[i]):.3e})")
                break                       # the sequences part here
        same = bool(torch.equal(out_c, out_g))
        print(f"[14] {LLM_ARCH} full width, depth 2, fp32, window {window}: "
              f"batch 1, prompt 256, 8 greedy tokens; logits card vs CPU max "
              f"|diff| {err:.3e} (<= {LOGIT_ATOL}); token ids "
              f"{'identical' if same else 'differ only after a near-tie'}; "
              f"smallest CPU top-2 gap {float(gaps.min()):.3e}")
    # -- 15. profile one prefill, then 8 decode steps -------------------------
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.serving import make_prefill_fn, make_serve_step

    def profiled(what, fn):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not on_card:
            print(f"[15] {what}: the profiler recorded no device events: the "
                  f"card's busy share is not measured")
            return out
        busy, groups = {}, {}
        for e in on_card:
            us = e.time_range.elapsed_us()
            busy[e.name] = busy.get(e.name, 0.0) + us
            low = e.name.lower()
            grp = ("B4 flash_kernel" if "flash_kernel" in low else
                   "GEMM (cuBLAS/CUTLASS)" if gemm_kernel(low) else
                   "other (elementwise, norms, copies, softmax, argmax)")
            groups[grp] = groups.get(grp, 0.0) + us
        total = sum(busy.values())
        print(f"[15] {what}: {wall_us / 1e3:.2f} ms on the host clock under "
              f"the profiler, card busy {total / 1e3:.2f} ms "
              f"({100 * total / wall_us:.1f}%), {len(on_card)} device ops")
        for grp, us in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"[15]   {us / 1e3:9.3f} ms ({100 * us / total:5.1f}%)  "
                  f"{grp}")
        b4 = groups.get("B4 flash_kernel", 0.0)
        print(f"[15] {what}: B4's share of the card's time "
              f"{100 * b4 / total:.1f}% ({b4 / 1e3:.3f} ms)")
        for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[15]   {us / 1e3:9.3f} ms ({100 * us / total:5.1f}%)  "
                  f"{name[:90]}")
        return out

    _, cache = profiled(
        f"{LLM_ARCH} prefill (batch {LLM_BATCH}, prompt {LLM_PROMPT})",
        lambda: make_prefill_fn(cfg)(params, {"tokens": prompts},
                                     LLM_PROMPT + LLM_NEW,
                                     last_logits_only=True))
    step = make_serve_step(cfg)

    def eight_steps():
        tok = prompts[:, -1:]
        for _ in range(8):
            lg, _ = step(params, tok, cache)
            tok = torch.argmax(lg, dim=-1)
    profiled(f"{LLM_ARCH} 8 decode steps (batch {LLM_BATCH}, from "
             f"{LLM_PROMPT} cached tokens)", eight_steps)
    return launches


def ssd_phases(dev):
    """Phases 16 and 17: the SSD scan (B5) against its plain version, then
    its times.  Returns (max |kernel - plain| at the training shape in
    bf16, timing at the training shape)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_chunked_ref, ssd_scan_ref

    g = torch.Generator(device="cpu").manual_seed(SEED + 6)

    def inputs(B, S, H, P, N, dtype):
        x = torch.randn((B, S, H, P), generator=g)
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
        A = -torch.exp(torch.randn((H,), generator=g))
        Bc, Cc = (torch.randn((B, S, N), generator=g) for _ in range(2))
        return [x.to(dev, dtype), dt.to(dev), A.to(dev), Bc.to(dev, dtype),
                Cc.to(dev, dtype)]

    def check(tag, xs, chunk, tile, want=None):
        y = ssd.ssd_scan(*xs, chunk=chunk, tile=tile)
        torch.cuda.synchronize()
        if want is None:
            want = ssd_chunked_ref(*xs, chunk)[0]
        tol = SSD_FP32 if xs[0].dtype == torch.float32 else BF16
        ok, err = close(y, want, **tol)
        if not ok or y.dtype != xs[0].dtype or y.shape != xs[0].shape:
            fail(f"ssd_scan kernel disagrees with its plain version at {tag} "
                 f"(max {err:.3e})")
        return y, err

    # -- 16. against the plain version ---------------------------------------
    main_err = {}
    for tag, (B, S, H, P, N), chunk in (("training", SSD_TRAIN, 512),
                                        ("multi-chunk", SSD_MULTI, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            xs = inputs(B, S, H, P, N, dtype)
            want = ssd_chunked_ref(*xs, chunk)[0]
            errs = [check(f"the {tag} shape {dtype} tile {t}", xs, chunk, t,
                          want)[1] for t in ssd.TILES]
            main_err[(tag, dtype)] = errs[ssd.TILES.index(ssd.TILE)]
            print(f"[16] ssd_scan {tag} x{[B, S, H, P]} N {N} chunk {chunk} "
                  f"{str(dtype)[6:]}: max |kernel - plain| by tile "
                  + ", ".join(f"{t} {e:.3e}" for t, e in zip(ssd.TILES, errs))
                  + " ok")
            del xs, want
    worst, n = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0
    for S, chunk, N, P, dtype in itertools.product(
            (1, 100, 1000), (16, 64, 128, 512), (16, 128), (32, 64),
            (torch.float32, torch.bfloat16)):
        xs = inputs(2, S, 2, P, N, dtype)
        want = ssd_chunked_ref(*xs, chunk)[0]
        for t in ssd.TILES:
            worst[dtype] = max(worst[dtype], check(
                f"S={S} chunk {chunk} N {N} P {P} {dtype} tile {t}", xs,
                chunk, t, want)[1])
        n += 1
    print(f"[16] ssd_scan sweep: {n} cases (S 1/100/1000, chunk "
          f"16/64/128/512, N 16/128, P 32/64, each in fp32 and bf16, every "
          f"tile {list(ssd.TILES)}) within fp32 rtol/atol 1e-3 and bf16 2e-2; "
          f"max |kernel - plain| fp32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e}")
    xs = inputs(1, 100, 2, 16, 8, torch.float32)
    _, err = check("the sequential recurrence", xs, 32, ssd.TILE,
                   ssd_scan_ref(*xs))
    print(f"[16] ssd_scan x[1, 100, 2, 16] N 8 fp32 against the sequential "
          f"recurrence ssd_scan_ref: max {err:.3e} ok")
    for dtype, rt in ((torch.float32, "fma"), (torch.bfloat16, "wgmma")):
        ssd.counts.reset()
        check(f"the {rt} route", inputs(1, 200, 2, 64, 128, dtype), 64,
              ssd.TILE)
        if ssd.counts.launches != 1 or ssd.counts.routes[rt] != 1:
            fail(f"ssd_scan {dtype}: routes {ssd.counts.routes}, expected "
                 f"one call on the {rt} route")
    print("[16] ssd_scan routes: fp32 -> fma (ssd_scan.cu), bf16 -> wgmma "
          "(ssd_scan_tc.cu: seg, then y for one chunk; seg, chunk states, "
          "the pass and y for more), one call each")
    # the shape of tests/test_kernels.py::test_ssd_chunk_invariance (P 16,
    # N 8), at a ragged S
    xs = inputs(1, 300, 2, 16, 8, torch.float32)
    outs = [ssd.ssd_scan(*xs, chunk=c, tile=t)
            for c in (16, 64, 128, 512) for t in ssd.TILES]
    torch.cuda.synchronize()
    spread = max(float((o - outs[0]).abs().max()) for o in outs)
    for o in outs:
        ok, err = close(o, outs[0], **SSD_INVARIANCE)
        if not ok:
            fail(f"ssd_scan: a chunk or tile differs from chunk 16, tile "
                 f"{ssd.TILES[0]} by {err:.3e}")
    print(f"[16] ssd_scan x[1, 300, 2, 16] N 8 fp32: chunks 16/64/128/512 x "
          f"tiles "
          f"{list(ssd.TILES)} all within 1e-4 of chunk 16, tile "
          f"{ssd.TILES[0]} (max spread {spread:.3e})")

    # -- 17. time at the training and multi-chunk shapes ---------------------
    timing = {}
    for tag, (B, S, H, P, N) in (("training", SSD_TRAIN),
                                 ("multi-chunk", SSD_MULTI)):
        xs = inputs(B, S, H, P, N, torch.bfloat16)
        Q = min(512, S)
        L = [min(Q, S - c0) for c0 in range(0, S, Q)]
        # per (b, h) and chunk of length l: C B^T and (.)x over the causal
        # half, the state's read-out and its update
        n_ops = B * H * sum(2 * (N + P) * l * (l + 1) // 2 + 4 * l * N * P
                            for l in L)
        n_bytes = sum(t.numel() * t.element_size() for t in xs) \
            + xs[0].numel() * xs[0].element_size()
        t = dict(ms=cuda_ms(lambda: ssd.ssd_scan(*xs, chunk=512), True,
                            inner=5, samples=20, warmup=3),
                 plain_ms=cuda_ms(lambda: ssd_chunked_ref(*xs, 512), True,
                                  inner=2, samples=10, warmup=2),
                 library_ms=None)
        t["bound_ms"], t["bound_by"] = bound(n_bytes, n_ops,
                                             BF16_TC_OPS_PER_S)
        tiles = {tl: cuda_ms(lambda: ssd.ssd_scan(*xs, chunk=512, tile=tl),
                             True, inner=3, samples=5, warmup=2)
                 for tl in ssd.TILES}
        timing[tag] = t
        if tag == "training":
            x32 = [t_.float() for t_ in xs]
            t["fp32_ms"] = cuda_ms(lambda: ssd.ssd_scan(*x32, chunk=512), True,
                                   inner=5, samples=10, warmup=2)
            del x32
        print(f"[17] ssd_scan {tag} x{[B, S, H, P]} N {N} chunk 512 bf16, "
              f"card time: kernel (bf16 route, wgmma) {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms, no single PyTorch call computes it "
              f"(library_ms null); bound {t['bound_ms']:.6f} ms by "
              f"{t['bound_by']} ({n_bytes} B, {n_ops} FLOP at the bf16 "
              f"tensor-core peak; at the fp32 peak "
              f"{n_ops / FP32_OPS_PER_S * 1e3:.5f} ms); kernel at "
              f"{n_ops / t['ms'] / 1e9:.3f} TFLOP/s; by tile: "
              + ", ".join(f"{tl} {ms:.4f}" for tl, ms in tiles.items())
              + " (every tile runs as 64 rows)")
        if "fp32_ms" in t:
            print(f"[17] ssd_scan {tag} fp32 at the same shape: fp32 route "
                  f"(ssd_scan.cu, tile {ssd.TILE}) {t['fp32_ms']:.5f} ms")
        del xs
    return main_err[("training", torch.bfloat16)], timing


def grad_phase(dev, all_counts):
    """Phase 18: every wrapper's gradients on the card against the CPU's,
    at small shapes in fp32; the blur's backward is the blur kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import imaging as kimaging
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.inverse_cdf import inverse_cdf_channels

    g = torch.Generator().manual_seed(SEED + 7)
    u = torch.rand((6, 9, 2), generator=g)
    prm = [torch.rand((6, 2), generator=g) for _ in range(3)]
    dt = torch.nn.functional.softplus(torch.randn((2, 40, 2), generator=g))
    cases = {
        "inverse_cdf": (inverse_cdf_channels,
                        [u, prm[0], prm[1] + 0.1, prm[2] - 0.5]),
        "mask_apply": (kimaging.mask_apply,
                       [torch.randn((8, 40), generator=g),
                        (torch.rand(40, generator=g) > 0.4).float()]),
        "blur2d": (kimaging.blur2d, [torch.randn((3, 8, 12), generator=g)]),
        "flash_attention": (
            lambda *a: fa.flash_attention_model(*a, window=16),
            [torch.randn((2, 40, 2, 2, 32), generator=g),
             torch.randn((2, 40, 2, 32), generator=g),
             torch.randn((2, 40, 2, 32), generator=g)]),
        "ssd_scan": (lambda *a: ssd.ssd_scan(*a, chunk=16),
                     [torch.randn((2, 40, 2, 16), generator=g), dt,
                      -torch.exp(torch.randn((2,), generator=g)),
                      torch.randn((2, 40, 8), generator=g),
                      torch.randn((2, 40, 8), generator=g)]),
    }
    for name, (fn, inputs) in cases.items():
        w = torch.randn(fn(*inputs).shape, generator=g)
        grads, got = {}, None
        for d in ("cpu", dev):
            xs = [t.detach().to(d).requires_grad_() for t in inputs]
            cnt = all_counts[name]
            cnt.reset()
            y = fn(*xs)
            if y.grad_fn is None:
                fail(f"{name}: the output on {d} has no grad_fn")
            (y * w.to(d)).sum().backward()
            torch.cuda.synchronize()
            grads[str(d)] = [x.grad.cpu() for x in xs]
            got = (cnt.launches, cnt.plain_calls, cnt.backward_launches,
                   cnt.backward_plain)
        want = (1, 0, 1, 0) if name == "blur2d" else (1, 0, 0, 1)
        if got != want:
            fail(f"{name} on the card: (launches, plain calls, backward "
                 f"launches, backward plain) {got}; expected {want}")
        tol = SSD_INVARIANCE if name == "ssd_scan" else FP32
        worst = 0.0
        for a, b in zip(grads[str(dev)], grads["cpu"]):
            ok, err = close(a, b, **tol)
            worst = max(worst, err)
            if not ok:
                fail(f"{name}: a gradient on the card differs from the CPU's "
                     f"by {err:.3e}")
        print(f"[18] {name}: gradients of {len(inputs)} inputs, card vs CPU "
              f"max |diff| {worst:.3e} (rtol {tol['rtol']}, atol "
              f"{tol['atol']}); on the card (launches, plain calls, "
              f"backward launches, backward plain) {got}")


def train_phases(dev, all_counts):
    """Phases 19-21: mamba2-130m trained at full size, one step on the
    card against the CPU (mamba2-130m and tinyllama-1.1b at full width,
    depth 2), and mamba2-130m served.  Returns B5's launches over the
    counted training run."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_batch
    from repro_torch.models import model as M
    from repro_torch.serving import generate
    from repro_torch.training import trainer as T

    # -- 19. train mamba2-130m at full size ----------------------------------
    cfg = get_config(TRAIN_ARCH)
    tcfg = T.TrainConfig(lr=3e-4, warmup=min(20, TRAIN_STEPS // 5 + 1),
                         total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    trainer = T.Trainer(cfg, tcfg, SEED, device=dev)
    n_params = M.param_count(trainer.state["params"])
    if n_params != MAMBA_PARAMS or cfg.num_layers != 24 \
            or cfg.d_model != 768:
        fail(f"{TRAIN_ARCH}: {n_params} parameters, {cfg.num_layers} layers, "
             f"d_model {cfg.d_model}; expected {MAMBA_PARAMS}, 24, 768")
    print(f"[19] {TRAIN_ARCH}: {n_params:,} parameters ({cfg.dtype}, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, d_inner "
          f"{cfg.ssm_d_inner}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, "
          f"N {cfg.ssm_state}, ssm_chunk {cfg.ssm_chunk}, vocab "
          f"{cfg.vocab_size}, tied, remat {cfg.remat}) made on the card from "
          f"seed {SEED} in {time.perf_counter() - t0:.2f}s; batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, lr {tcfg.lr}, warmup "
          f"{tcfg.warmup}, {TRAIN_STEPS} steps")
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=dev)
    held_out = [make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=HELD_OUT_SEED + i,
                           device=dev) for i in range(HELD_OUT_BATCHES)]

    def held_out_loss():
        """The mean loss of the held-out batches under the current
        parameters (not counted: run outside the counted window)."""
        with torch.no_grad():
            return float(torch.stack([M.loss_fn(trainer.state["params"], b,
                                                cfg)[0]
                                      for b in held_out]).mean())
    before = held_out_loss()
    # one warm-up step, not counted, its new state dropped: the first call
    # at these shapes compiles PyTorch's runtime kernels and grows the
    # allocator's pool (a step that builds a new state: the Trainer's own
    # step donates, and would train the state)
    T.make_train_step(cfg, tcfg, donate=False)[0](
        trainer.state, next(TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                        seed=SEED + 11, device=dev)))
    torch.cuda.synchronize()
    events, losses = [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(metrics["loss"])
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats(dev)
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted main-path run ---
    start.record()
    trainer.run(stream, TRAIN_STEPS, log_every=TRAIN_STEPS,
                log=lambda s: print(f"[19]   {s}"), on_step=on_step)
    events[-1].synchronize()
    got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
    routes = dict(all_counts["ssd_scan"].routes)
    backward = all_counts["ssd_scan"].backward_plain
    # ----------------------------------------------------------------------
    expect = {k: ((2 * cfg.num_layers * TRAIN_STEPS if k == "ssd_scan"
                   else 0), 0) for k in all_counts}
    if got != expect:
        fail(f"{TRAIN_ARCH} training: (kernel launches, plain calls) {got}; "
             f"expected {expect} (B5 twice a layer a step: the forward and "
             f"the remat recompute)")
    if routes != {"fma": 0, "wgmma": got["ssd_scan"][0]}:
        fail(f"{TRAIN_ARCH} training: B5 routes {routes}; expected every "
             f"call on the bf16 (wgmma) route")
    loss = torch.stack(losses).float().cpu().numpy()
    after = held_out_loss()
    if not np.isfinite(loss).all() or not np.isfinite([before, after]).all():
        fail(f"{TRAIN_ARCH}: non-finite loss {loss}, held out {before} -> "
             f"{after}")
    if not after < before:
        fail(f"{TRAIN_ARCH}: the loss did not fall: held-out loss "
             f"{before:.4f} before training, {after:.4f} after")
    steps = np.array([a.elapsed_time(b) for a, b in
                      zip([start] + events[:-1], events)])
    p50 = float(np.percentile(steps, 50))
    print(f"[19] {TRAIN_ARCH} training: B5 calls {got['ssd_scan'][0]} "
          f"({got['ssd_scan'][0] // TRAIN_STEPS} a step; by route {routes}), "
          f"plain calls "
          f"{got['ssd_scan'][1]}, B5 backward passes (the VJP of the plain "
          f"version) {backward}; no other kernel")
    print(f"[19] {TRAIN_ARCH} loss on the {HELD_OUT_BATCHES} held-out batches: "
          f"{before:.4f} before training, {after:.4f} after (fell by "
          f"{before - after:.4f}); every step's loss finite")
    print(f"[19] {TRAIN_ARCH} training loss by step (each a new random "
          f"batch): " + " ".join(f"{v:.4f}" for v in loss))
    print(f"[19] {TRAIN_ARCH} first step {loss[0]:.4f}, mean of the last 5 "
          f"{loss[-5:].mean():.4f}: batch against batch, so the batches' "
          f"spread (std {loss.std():.4f} over the run) is in it")
    print(f"[19] {TRAIN_ARCH} step time p50 {p50:.3f} ms, p99 "
          f"{float(np.percentile(steps, 99)):.3f} ms, first "
          f"{steps[0]:.3f} ms (on the card's clock, from one step's end to "
          f"the next); {TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.0f} tokens/s at "
          f"p50; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(stream, PROFILED_STEPS, log_every=PROFILED_STEPS,
                    log=lambda s: None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_prof = PROFILED_STEPS
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        print(f"[19] {TRAIN_ARCH} {n_prof} profiled step(s): the profiler "
              f"recorded no device events: the card's busy share is not "
              f"measured")
    else:
        busy, groups = {}, {}
        for e in on_card:
            us = e.time_range.elapsed_us()
            busy[e.name] = busy.get(e.name, 0.0) + us
            low = e.name.lower()
            grp = ("B5 ssd_kernel" if "ssd_kernel" in low else
                   "GEMM (cuBLAS/CUTLASS)" if gemm_kernel(low) else
                   "other (elementwise, reductions, copies, the plain "
                   "backward of B5)")
            groups[grp] = groups.get(grp, 0.0) + us
        total = sum(busy.values())
        print(f"[19] {TRAIN_ARCH} {n_prof} profiled step(s): "
              f"{wall_us / n_prof / 1e3:.2f} ms a step on the host clock "
              f"under the profiler, card busy {total / n_prof / 1e3:.2f} ms "
              f"a step ({100 * total / wall_us:.1f}%), "
              f"{len(on_card) // n_prof} device ops a step")
        for grp, us in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"[19]   {us / n_prof / 1e3:9.3f} ms a step "
                  f"({100 * us / total:5.1f}"
                  f"%)  {grp}")
        b5 = groups.get("B5 ssd_kernel", 0.0)
        print(f"[19] {TRAIN_ARCH}: B5's share of the card's time "
              f"{100 * b5 / total:.1f}% ({b5 / n_prof / 1e3:.3f} ms a step)")
        for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:10]:
            print(f"[19]   {us / n_prof / 1e3:9.3f} ms a step "
                  f"({100 * us / total:5.1f}"
                  f"%)  {name[:90]}")
    launches = got["ssd_scan"][0]
    del trainer, stream, events, losses, prof
    torch.cuda.empty_cache()

    # -- 20. one step on the card against the CPU, full width, depth 2 -------
    for arch, batch, seq in CARD_VS_CPU_STEPS:
        step_card_vs_cpu("20", dev, get_config(arch).replace(
            num_layers=2, dtype="float32"), batch, seq)

    # -- 21. serve mamba2-130m -----------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init(gen, cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT),
                            generator=gen, device=dev)
    generate(params, cfg, prompts, WARM_NEW,       # warm-up, not counted
             context_len=LLM_PROMPT + LLM_NEW)
    events, finite = [], []

    def on_logits(i, lg):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        finite.append(torch.isfinite(lg).all())
    start = torch.cuda.Event(enable_timing=True)
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted serving run ---
    start.record()
    out = generate(params, cfg, prompts, LLM_NEW, on_logits=on_logits)
    events[-1].synchronize()
    got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
    # ----------------------------------------------------------------------
    if any(v != (0, 0) for v in got.values()):
        fail(f"{TRAIN_ARCH} serving: (kernel launches, plain calls) {got}; "
             f"expected none: SSM prefill and decode are plain PyTorch")
    new = out[:, LLM_PROMPT:]
    if out.shape != (LLM_BATCH, LLM_PROMPT + LLM_NEW) \
            or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size \
            or not bool(torch.stack(finite).all()):
        fail(f"{TRAIN_ARCH} serving: ids of shape {tuple(out.shape)} or "
             f"non-finite logits")
    steps = np.array([a.elapsed_time(b)
                      for a, b in zip(events[:-1], events[1:])])
    print(f"[21] {TRAIN_ARCH} served: batch {LLM_BATCH}, prompt {LLM_PROMPT}, "
          f"{LLM_NEW} greedy tokens; prefill {start.elapsed_time(events[0]):.3f}"
          f" ms, decode step p50 {np.percentile(steps, 50):.3f} ms, p99 "
          f"{np.percentile(steps, 99):.3f} ms; no kernel launch and no "
          f"wrapper call (SSM prefill and decode are plain PyTorch, as "
          f"jnp in the JAX package); first ids {new[0, :8].tolist()}")
    return launches


def routing_diff(card, cpu, label):
    """Compare the top-k choices that two `models.moe.Tap`s recorded
    (their `routes`) call by call:
    (rows whose expert sets differ, the smallest of the CPU's gaps between
    its k-th and (k+1)-th probability on those rows, or None).  Fails
    unless every such gap is below ROUTE_GAP."""
    import torch
    if len(card) != len(cpu):
        fail(f"{label}: {len(card)} router calls on the card, {len(cpu)} on "
             f"the CPU")
    n, gaps = 0, []
    for (_, ig), (pc, ic) in zip(card, cpu):
        k = ic.shape[-1]
        diff = (torch.sort(ig, -1).values != torch.sort(ic, -1).values
                ).any(-1)
        if bool(diff.any()):
            top = torch.topk(pc[diff], k + 1, dim=-1).values
            gaps += (top[:, k - 1] - top[:, k]).tolist()
            n += int(diff.sum())
    if gaps and max(gaps) >= ROUTE_GAP:
        fail(f"{label}: the card's top-k choices differ from the CPU's in "
             f"{n} rows, at a CPU gap of up to {max(gaps):.3e} (>= "
             f"{ROUTE_GAP})")
    return n, (min(gaps) if gaps else None)


def moe_flops(cfg, B, S, last_only=True):
    """The operations of one prefill of B x S tokens, by part (2 per
    multiply-add): the expert buffers as run (E x C rows each), the shared
    experts, the projections and router, causal attention, the LM head
    (the last position's logits only)."""
    from repro_torch.models.moe import moe_capacity
    T, D, L = B * S, cfg.d_model, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    F, E = cfg.moe_d_ff, cfg.num_experts
    C = moe_capacity(T, cfg)
    return {
        "experts": L * 6 * E * C * D * F,
        "shared experts": L * 6 * T * D * F * cfg.num_shared_experts,
        "projections and router": L * 2 * T * D * (2 * H * hd + 2 * KV * hd
                                                    + E),
        "attention": L * 4 * B * H * hd * (S * (S + 1) // 2),
        "LM head": 2 * (B if last_only else T) * D * cfg.vocab_size}


def moe_phases(dev, all_counts):
    """Phases 29-33: the MoE layer card against CPU, qwen2-moe-a2.7b
    served at full size and held against the CPU at full width, depth 2,
    granite-moe-3b-a800m trained at full size and one of its steps held
    against the CPU.  Returns B4's launches over the counted runs of
    phases 30 and 32."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving import generate
    from repro_torch.training import trainer as T

    # -- 29. the MoE layer, card against CPU ---------------------------------
    for arch in (MOE_SERVE_ARCH, MOE_TRAIN_ARCH):
        cfg = get_config(arch).replace(dtype="float32")
        g = torch.Generator().manual_seed(SEED + 29)
        p = moe.init_moe(g, cfg, torch.float32, "cpu")
        x = torch.randn((1, MOE_LAYER_T, cfg.d_model), generator=g)
        forced = dict(p, router=p["router"].clone())
        forced["router"][:, list(MOE_FORCED)] += MOE_FORCED_LOGIT / (
            0.5 * cfg.d_model)

        def run(d, params, xs, choices=None):
            tap = moe.Tap(record=True, choices=choices)
            y, aux = moe.run_moe(M.map_params(lambda t: t.to(d), params),
                                 xs.to(d), cfg, tap)
            return (y.cpu(), float(aux), tap.dropped), tap.routes
        for case, params, xs in (("default capacity", p, x),
                                 ("drops forced", forced, x + 0.5)):
            (yg, ag, dg), rec_g = run(dev, params, xs)
            (yc, ac, dc), rec_c = run("cpu", params, xs)
            n_diff, gap = routing_diff(rec_g, rec_c, f"phase 29 {arch}")
            card_choices = [i for _, i in rec_g]
            if n_diff:
                (yc, ac, dc), _ = run("cpu", params, xs, card_choices)
            # the exact answer: float64 on the CPU at the card's choices
            (y64, _, _), _ = run("cpu", M.map_params(torch.Tensor.double,
                                                     params),
                                 xs.double(), card_choices)
            scale = float(y64.abs().max())
            tol = dict(rtol=MOE_Y["rtol"], atol=MOE_Y["atol"] * scale)
            ok, err = close(yg, y64, **tol)
            ok_c, err_c = close(yc, y64, **tol)
            aux_rel = abs(ag - ac) / abs(ac)
            if not ok or not ok_c or aux_rel > AUX_RTOL or dg != dc \
                    or (case == "drops forced" and dg == 0):
                fail(f"phase 29 {arch} {case}: y off the float64 run's by "
                     f"{err:.3e} on the card, {err_c:.3e} on the CPU "
                     f"({tol}), aux card vs CPU by {aux_rel:.3e} (rel, "
                     f"{AUX_RTOL}), drops {dg} on the card, {dc} on the CPU")
            C = moe.moe_capacity(MOE_LAYER_T, cfg)
            print(f"[29] {arch} MoE layer (D {cfg.d_model}, {cfg.num_experts}"
                  f" experts of {cfg.moe_d_ff}, {cfg.num_shared_experts} "
                  f"shared, top-{cfg.top_k}), T {MOE_LAYER_T}, C {C}, fp32, "
                  f"TF32 off, {case}: {dg} of {MOE_LAYER_T * cfg.top_k} "
                  f"assignments dropped on both; y against float64 max "
                  f"|diff| {err:.3e} on the card, {err_c:.3e} on the CPU "
                  f"(rtol {MOE_Y['rtol']}, atol {MOE_Y['atol']} x max |y| "
                  f"{scale:.3f}), card vs CPU "
                  f"{float((yg - yc).abs().max()):.3e} (reported); aux "
                  f"{ag:.6f} vs {ac:.6f} (rel {aux_rel:.2e} <= {AUX_RTOL}); "
                  f"top-k choices "
                  + ("identical" if not n_diff else
                     f"differ in {n_diff} rows at CPU gaps down to "
                     f"{gap:.2e}: the CPU at the card's choices"))
        # the bar against runs it must refuse: the same layer on the card
        # with TF32 matmuls, and in bf16 (router fp32), at the card's
        # fp32 choices
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            (y_tf, _, _), _ = run(dev, params, xs, card_choices)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        low = M.map_params(lambda t: t.to(torch.bfloat16), params)
        low["router"] = params["router"]
        tap = moe.Tap(choices=card_choices)
        y_bf, _ = moe.run_moe(M.map_params(lambda t: t.to(dev), low),
                              xs.to(dev, torch.bfloat16),
                              cfg.replace(dtype="bfloat16"), tap)
        readings = {"TF32": close(y_tf, y64, **tol),
                    "bf16": close(y_bf.float().cpu(), y64, **tol)}
        if any(ok for ok, _ in readings.values()):
            fail(f"phase 29 {arch} {case}: a lower-precision run meets y's "
                 f"bar ({readings}): the bar cannot tell it from fp32")
        print(f"[29] {arch} {case}: the bar refuses lower precision: y "
              f"against float64 max |diff| "
              + ", ".join(f"{k} {err:.3e}" for k, (_, err) in
                          readings.items())
              + f" (atol {tol['atol']:.3e}), at the card's fp32 choices")
        bf = M.map_params(lambda t: t.to(dev, torch.bfloat16), forced)
        bf["router"] = forced["router"].to(dev)      # fp32 in a bf16 model
        cb = cfg.replace(dtype="bfloat16")
        xb = (x + 0.5).to(dev, torch.bfloat16)
        runs = [moe.run_moe(bf, xb, cb) for _ in range(2)]
        torch.cuda.synchronize()
        if not (torch.equal(runs[0][0], runs[1][0])
                and torch.equal(runs[0][1], runs[1][1])) \
                or runs[0][0].dtype != torch.bfloat16:
            fail(f"phase 29 {arch}: two bf16 runs on the card differ")
        print(f"[29] {arch} MoE layer bf16 (router fp32), drops forced: two "
              f"card runs bitwise equal (y and aux)")
        del p, forced, bf, runs

    # -- 30. serve qwen2-moe-a2.7b at full size ------------------------------
    cfg = get_config(MOE_SERVE_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init(gen, cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT),
                            generator=gen, device=dev)
    torch.cuda.synchronize()
    L, D, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    n_params = M.param_count(params)
    want = cfg.param_counts()["total"] + (2 * L + 1) * D \
        + L * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd      # qkv biases
    if n_params != want or (L, D) != MOE_SERVE_SIZE:
        fail(f"{MOE_SERVE_ARCH}: {n_params} parameters, {L} layers, d_model "
             f"{D}; expected {want} and {MOE_SERVE_SIZE}")
    weight_bytes = sum(t.numel() * t.element_size() for t in M.leaves(params))
    print(f"[30] {MOE_SERVE_ARCH}: {n_params:,} parameters ({cfg.dtype}, "
          f"{weight_bytes / 1e9:.2f} GB; {L} layers, d_model {D}, "
          f"{cfg.num_heads} heads of {hd} over {cfg.num_kv_heads} KV heads, "
          f"qkv bias, {cfg.num_experts} experts of {cfg.moe_d_ff} top-"
          f"{cfg.top_k} and {cfg.num_shared_experts} shared, vocab "
          f"{cfg.vocab_size}, tied) made on the card from seed {SEED} in "
          f"{time.perf_counter() - t0:.2f}s")
    # the warm-up, not counted, counts the dropped assignments: the counted
    # run takes the same inputs, so the same routes, without the count.
    # WARM_NEW tokens at the same context: every drop is the prefill's (a
    # decode step's buffers of C 8 rows hold all 8 tokens of an expert)
    tap = moe.Tap()
    generate(params, cfg, prompts, WARM_NEW, context_len=LLM_PROMPT + LLM_NEW,
             tap=tap)
    events, finite = [], []

    def on_logits(i, lg):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        finite.append(torch.isfinite(lg).all())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats(dev)
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted main-path run ---
    t0 = time.perf_counter()
    start.record()
    out = generate(params, cfg, prompts, LLM_NEW, on_logits=on_logits)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
    routes = dict(all_counts["flash_attention"].routes)
    # ----------------------------------------------------------------------
    expect = {k: ((L if k == "flash_attention" else 0), 0)
              for k in all_counts}
    if got != expect or routes != {"fma": 0, "wgmma": L}:
        fail(f"{MOE_SERVE_ARCH}: (kernel launches, plain calls) {got}, B4 "
             f"routes {routes}; expected {expect}, every launch on the bf16 "
             f"(wgmma) route")
    new = out[:, LLM_PROMPT:]
    if out.shape != (LLM_BATCH, LLM_PROMPT + LLM_NEW) \
            or not torch.equal(out[:, :LLM_PROMPT], prompts) \
            or int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size \
            or not bool(torch.stack(finite).all()):
        fail(f"{MOE_SERVE_ARCH}: generated ids of shape {tuple(out.shape)} "
             f"outside [0, {cfg.vocab_size}) or non-finite logits")
    launches = got["flash_attention"][0]
    prefill_ms = start.elapsed_time(events[0])
    steps = np.array([a.elapsed_time(b)
                      for a, b in zip(events[:-1], events[1:])])
    total_ms = start.elapsed_time(end)
    W = LLM_PROMPT + LLM_NEW
    cache_bytes = 2 * L * LLM_BATCH * W * cfg.num_kv_heads * hd * 2
    flops = moe_flops(cfg, LLM_BATCH, LLM_PROMPT)
    n_ops = sum(flops.values())
    print(f"[30] {MOE_SERVE_ARCH}: batch {LLM_BATCH}, prompt {LLM_PROMPT}, "
          f"{LLM_NEW} greedy tokens; B4 launches {launches} (by route "
          f"{routes}), plain calls {got['flash_attention'][1]}; no other "
          f"kernel; logits finite; {tap.dropped} (token, expert) "
          f"assignments dropped by capacity over {tap.calls} run_moe calls "
          f"of the warm-up run (the prefill and {WARM_NEW} steps), the same "
          f"inputs (C "
          f"{moe.moe_capacity(LLM_BATCH * LLM_PROMPT, cfg)} in the "
          f"prefill, {moe.moe_capacity(LLM_BATCH, cfg)} a decode step)")
    print(f"[30] {MOE_SERVE_ARCH}: prefill {prefill_ms:.3f} ms "
          f"({LLM_BATCH * LLM_PROMPT / prefill_ms * 1e3:.0f} prompt tok/s; "
          f"bound {n_ops / BF16_TC_OPS_PER_S * 1e3:.3f} ms: {n_ops:.3e} FLOP "
          f"at the bf16 peak, of which "
          + ", ".join(f"{k} {v:.2e}" for k, v in flops.items())
          + f"), decode step p50 {np.percentile(steps, 50):.3f} ms, p99 "
          f"{np.percentile(steps, 99):.3f} ms over {len(steps)} steps of "
          f"{LLM_BATCH} tokens (bound "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms reading every "
          f"weight once, "
          f"{(weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"with the {cache_bytes / 1e9:.2f} GB KV cache), "
          f"{LLM_BATCH * LLM_NEW / total_ms * 1e3:.1f} tok/s generated "
          f"including prefill ({total_ms:.1f} ms on the card's clock, "
          f"{wall * 1e3:.1f} ms on the host's); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"[30]   request 0, first 12 new ids: {new[0, :12].tolist()}")
    del params, out, prompts, events, finite
    torch.cuda.empty_cache()

    # -- 31. qwen2-moe-a2.7b card against CPU, full width, depth 2, fp32 ----
    c = cfg.replace(num_layers=2, dtype="float32")
    small = M.init(torch.Generator().manual_seed(SEED + 31), c, "cpu")
    tok = torch.randint(0, c.vocab_size, (1, 256),
                        generator=torch.Generator().manual_seed(SEED + 32))

    def serve(d, choices=None):
        logits, tap = [], moe.Tap(record=True, choices=choices)
        out = generate(M.map_params(lambda x: x.to(d), small), c, tok.to(d),
                       8, on_logits=lambda i, lg: logits.append(lg.cpu()),
                       tap=tap)
        return (out.cpu(), torch.cat(logits, 1)), tap.routes
    (out_g, lg_g), rec_g = serve(dev)
    (out_c, lg_c), rec_c = serve("cpu")
    n_diff, gap = routing_diff(rec_g, rec_c, "phase 31")
    if n_diff:
        (out_c, lg_c), _ = serve("cpu", [i for _, i in rec_g])
    err = float((lg_g - lg_c).abs().max())
    if err > LOGIT_ATOL:
        fail(f"phase 31: card logits differ from the CPU's by {err:.3e} (> "
             f"{LOGIT_ATOL})")
    top2 = torch.topk(lg_c, 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1])[0]
    for i in range(8):
        if out_c[0, 256 + i] != out_g[0, 256 + i]:
            if float(gaps[i]) >= TOP2_GAP:
                fail(f"phase 31: token {i} differs (CPU top-2 gap "
                     f"{float(gaps[i]):.3e})")
            break                           # the sequences part here
    same = bool(torch.equal(out_c, out_g))
    print(f"[31] {MOE_SERVE_ARCH} full width, depth 2, fp32, TF32 off: batch "
          f"1, prompt 256, 8 greedy tokens; logits card vs CPU max |diff| "
          f"{err:.3e} (<= {LOGIT_ATOL}); token ids "
          f"{'identical' if same else 'differ only after a near-tie'}; "
          f"smallest CPU top-2 gap {float(gaps.min()):.3e}; top-k choices of "
          f"{len(rec_g)} router calls "
          + ("identical" if not n_diff else
             f"differ in {n_diff} rows at CPU gaps down to {gap:.2e}: the "
             f"CPU at the card's choices"))
    del small

    # -- 32. train granite-moe-3b-a800m at full size -------------------------
    cfg = get_config(MOE_TRAIN_ARCH)
    L = cfg.num_layers
    tcfg = T.TrainConfig(lr=3e-4, warmup=min(20, MOE_TRAIN_STEPS // 5 + 1),
                         total_steps=MOE_TRAIN_STEPS)
    t0 = time.perf_counter()
    tap = moe.Tap()
    trainer = T.Trainer(cfg, tcfg, SEED, device=dev, tap=tap)
    n_params = M.param_count(trainer.state["params"])
    want = cfg.param_counts()["total"] + (2 * L + 1) * cfg.d_model
    if n_params != want or (L, cfg.d_model) != MOE_TRAIN_SIZE:
        fail(f"{MOE_TRAIN_ARCH}: {n_params} parameters, {L} layers, d_model "
             f"{cfg.d_model}; expected {want} and {MOE_TRAIN_SIZE}")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in M.leaves(trainer.state))
    print(f"[32] {MOE_TRAIN_ARCH}: {n_params:,} parameters ({cfg.dtype}; "
          f"{L} layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim} over {cfg.num_kv_heads} KV heads, "
          f"{cfg.num_experts} experts of {cfg.moe_d_ff} top-{cfg.top_k}, "
          f"vocab {cfg.vocab_size}, tied, remat {cfg.remat}; the train state "
          f"with fp32 moments {state_bytes / 1e9:.2f} GB) made on the card "
          f"from seed {SEED} in {time.perf_counter() - t0:.2f}s; batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, lr {tcfg.lr}, warmup "
          f"{tcfg.warmup}, {MOE_TRAIN_STEPS} steps")
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=dev)
    held_out = [make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=HELD_OUT_SEED + i,
                           device=dev) for i in range(HELD_OUT_BATCHES)]

    def held_out_loss():
        with torch.no_grad():
            return float(torch.stack([M.loss_fn(trainer.state["params"], b,
                                                cfg)[0]
                                      for b in held_out]).mean())
    before = held_out_loss()
    # warm-up, not counted: one forward and backward at these shapes (the
    # donating step would train the state; a step that builds a new state
    # beside it would not fit)
    T._compute_grads(trainer.state["params"], next(TokenStream(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 11, device=dev)), cfg, tcfg)
    torch.cuda.synchronize()
    events, losses, auxes = [], [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(metrics["loss"])
        auxes.append(metrics["aux"])
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats(dev)
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted main-path run ---
    start.record()
    trainer.run(stream, MOE_TRAIN_STEPS, log_every=MOE_TRAIN_STEPS,
                log=lambda s: print(f"[32]   {s}"), on_step=on_step)
    events[-1].synchronize()
    got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
    routes = dict(all_counts["flash_attention"].routes)
    backward = all_counts["flash_attention"].backward_plain
    # ----------------------------------------------------------------------
    expect = {k: ((2 * L * MOE_TRAIN_STEPS if k == "flash_attention"
                   else 0), 0) for k in all_counts}
    if got != expect or backward != L * MOE_TRAIN_STEPS \
            or routes != {"fma": 0, "wgmma": 2 * L * MOE_TRAIN_STEPS}:
        fail(f"{MOE_TRAIN_ARCH} training: (kernel launches, plain calls) "
             f"{got}, B4 routes {routes}, B4 backward passes {backward}; "
             f"expected {expect}, all on the bf16 route, and "
             f"{L * MOE_TRAIN_STEPS} backward passes (B4 twice a layer a "
             f"step: the forward and the remat recompute)")
    loss = torch.stack(losses).float().cpu().numpy()
    aux = torch.stack(auxes).float().cpu().numpy()
    after = held_out_loss()
    if not np.isfinite(loss).all() or not np.isfinite([before, after]).all():
        fail(f"{MOE_TRAIN_ARCH}: non-finite loss {loss}, held out {before} -> "
             f"{after}")
    if not after < before:
        fail(f"{MOE_TRAIN_ARCH}: the loss did not fall: held-out loss "
             f"{before:.4f} before training, {after:.4f} after")
    launches += got["flash_attention"][0]
    steps = np.array([a.elapsed_time(b) for a, b in
                      zip([start] + events[:-1], events)])
    p50 = float(np.percentile(steps, 50))
    b4 = got["flash_attention"][0]
    print(f"[32] {MOE_TRAIN_ARCH} training: B4 launches {b4} "
          f"({b4 // MOE_TRAIN_STEPS} a step; by route {routes}), plain calls "
          f"{got['flash_attention'][1]}, B4 backward passes (the VJP of the "
          f"plain version) {backward}; no other kernel; "
          f"{tap.dropped} (token, expert) assignments dropped by "
          f"capacity over {tap.calls} run_moe calls (forward and remat "
          f"recompute; C {moe.moe_capacity(TRAIN_BATCH * TRAIN_SEQ, cfg)})")
    print(f"[32] {MOE_TRAIN_ARCH} loss on the {HELD_OUT_BATCHES} held-out "
          f"batches: {before:.4f} before training, {after:.4f} after (fell "
          f"by {before - after:.4f}); every step's loss finite")
    print(f"[32] {MOE_TRAIN_ARCH} training loss by step (each a new random "
          f"batch): " + " ".join(f"{v:.4f}" for v in loss))
    print(f"[32] {MOE_TRAIN_ARCH} aux loss (summed over layers) first "
          f"{aux[0]:.4f}, last {aux[-1]:.4f}, min {aux.min():.4f}, max "
          f"{aux.max():.4f} ({L} layers: {L}.0 at perfect balance)")
    print(f"[32] {MOE_TRAIN_ARCH} step time p50 {p50:.3f} ms, p99 "
          f"{float(np.percentile(steps, 99)):.3f} ms, first "
          f"{steps[0]:.3f} ms (on the card's clock, from one step's end to "
          f"the next); {TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:.0f} tokens/s at "
          f"p50; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(stream, PROFILED_STEPS, log_every=PROFILED_STEPS,
                    log=lambda s: None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile("32", MOE_TRAIN_ARCH, prof, wall_us, PROFILED_STEPS,
                   "step", step_part)
    del trainer, stream, events, losses, auxes, prof, held_out
    torch.cuda.empty_cache()

    # -- 33. one granite step on the card against the CPU --------------------
    step_card_vs_cpu("33", dev, cfg.replace(num_layers=2, dtype="float32"),
                     1, 256, pin_routing=True)
    return launches


def report_profile(tag, what, prof, wall_us, n, unit, label):
    """Print the profile `prof` of `n` `unit`s that took `wall_us` on the
    host's clock (phases 24, 28, 32, 51, 52 and 55): the card's busy share,
    device ops a unit, the card's time by `label(lower kernel name, the
    profiler's CPU op that launched the kernel)` with the share of it so
    traced, and the ten longest kernels.  Returns (label -> us, busy us), or None when
    the profiler recorded no device events."""
    import torch
    kind = torch.autograd.DeviceType
    a = "an" if unit[0] in "aeiou" else "a"
    # the MoE's profiler ranges show on the device's timeline too, as
    # spans over their kernels: not kernels, so not busy time
    on_card = [e for e in prof.events()
               if e.device_type == kind.CUDA and e.name not in MOE_RANGES]
    if not on_card:
        print(f"[{tag}] {what} {n} profiled {unit}s: the profiler recorded "
              f"no device events: the card's busy share is not measured")
        return None
    busy, groups = {}, {}
    for e in on_card:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(busy.values())
    for e in prof.events():
        if e.device_type == kind.CPU:
            for k in e.kernels:
                key = label(k.name.lower(), e)
                groups[key] = groups.get(key, 0.0) + k.duration
    print(f"[{tag}] {what} {n} profiled {unit}s: {wall_us / n / 1e3:.2f} ms "
          f"{a} {unit} on the host clock under the profiler, card busy "
          f"{total / n / 1e3:.2f} ms {a} {unit} ({100 * total / wall_us:.1f}"
          f"%), {len(on_card) // n} device ops {a} {unit}; "
          f"{100 * sum(groups.values()) / total:.1f}% of the card's time "
          f"traced to its launching op")
    for grp, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {us / n / 1e3:9.3f} ms {a} {unit} "
              f"({100 * us / total:5.1f}%)  {grp}")
    for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[{tag}]   {us / n / 1e3:9.3f} ms {a} {unit} "
              f"({100 * us / total:5.1f}%)  {name[:90]}")
    return groups, total


def step_part(low, op):
    """Phases 32's, 51's, 52's and 55's label of a kernel: B4 by its name; else
    by the outermost labelled range or autograd node it was launched from:
    the MoE ranges of `models.moe` ("moe.experts"; "moe.dispatch" and
    "moe.combine") and the backward nodes of the expert matmuls
    (BmmBackward) and of the dispatch's sorts, scatters and gathers; B4's
    backward is the node of its wrapper (the VJP of the plain version);
    the rest by kernel name."""
    def part(name):
        if name == MOE_RANGES[1] or "BmmBackward" in name:
            return "expert GEMMs and SwiGLU (forward, recompute, backward)"
        if name in MOE_RANGES[::2] or any(
                w in name for w in ("IndexBackward", "IndexPutBackward",
                                    "GatherBackward", "SortBackward",
                                    "TopkBackward")):
            return ("routing, dispatch and combine (sort, scatter, gather; "
                    "forward, recompute, backward)")
        if "FlashAttention" in name:
            return "B4 backward (the VJP of the plain version)"
        return None
    if "flash_kernel" in low:
        return "B4 flash_kernel"
    grp = None
    while op is not None:                 # the outermost label wins
        grp = part(op.name) or grp
        op = op.cpu_parent
    return grp or ("other GEMMs (projections, dense MLPs, LM head)" if any(
        w in low for w in ("gemm", "xmma", "cutlass", "nvjet", "sm90_"))
        else "other (elementwise, norms, loss, optimizer, copies)")


def step_card_vs_cpu(tag, dev, c, batch, seq, pin_routing=False):
    """One training step on the card and on the CPU from the same weights
    and batch, of the fp32 config `c` (phases 20 and 33: an arch's full
    width at depth 2; phase 58: a narrow hybrid at jamba's period), TF32
    off: the loss at rtol STEP_LOSS_RTOL, every gradient leaf within
    STEP_GRAD_REL in relative norm, the card's new parameters against the
    CPU's optimizer on the card's gradients at UPDATE_TOL, every entry;
    the new parameters against the CPU's own step are reported (where |g|
    is near Adam's eps, the gradients' last bits move an entry by up to
    lr_t).  `pin_routing`: a MoE's top-k choices are compared call by
    call and, where they differ at a near-tie, the CPU's step is taken
    again at the card's choices (a `models.moe.Tap`)."""
    import torch
    from repro_torch.data import make_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.training import trainer as T

    arch = c.name
    tc = T.TrainConfig(lr=3e-4, warmup=11, total_steps=TRAIN_STEPS)
    small = M.init(torch.Generator().manual_seed(SEED + 8), c, "cpu")
    data = make_batch(c, batch, seq, seed=SEED + 9, device="cpu")

    def run(d, choices=None):
        state = T.train_state_from_params(
            M.map_params(lambda t: t.to(d), small), tc)
        tap = moe.Tap(record=True, choices=choices)
        loss, _, grads = T._compute_grads(
            state["params"], {"tokens": data["tokens"].to(d)}, c, tc, tap)
        new, gnorm = T._apply(state, grads, tc)
        return (float(loss), M.map_params(lambda t: t.float().cpu(), grads),
                M.map_params(lambda t: t.float().cpu(), new["params"]),
                float(gnorm)), tap.routes
    out, records = {}, {}
    for d in ("cpu", dev):
        out[str(d)], records[str(d)] = run(d)
    routing = ""
    if pin_routing:
        n_diff, gap = routing_diff(records[str(dev)], records["cpu"],
                                   f"phase {tag} {arch}")
        if n_diff:
            out["cpu"], _ = run("cpu", [i for _, i in records[str(dev)]])
        routing = (f"; top-k choices of {len(records['cpu'])} router calls "
                   + (f"identical on the card and the CPU" if not n_diff else
                      f"differ in {n_diff} rows at CPU gaps down to "
                      f"{gap:.2e} (< {ROUTE_GAP}): the CPU at the card's "
                      f"choices"))
    (lc, gc, pc, nc), (lg, gg, pg, ng) = out["cpu"], out[str(dev)]
    grad_rel = max(float((a - b).norm() / max(float(b.norm()), 1e-30))
                   for a, b in zip(M.leaves(gg), M.leaves(gc)))
    # the card's update against the CPU's optimizer arithmetic on the
    # card's own gradients: every entry, no exceptions
    want, _ = T._apply(T.train_state_from_params(small, tc), gg, tc)
    update_err = max(float((a - b).abs().max()) for a, b in
                     zip(M.leaves(pg), M.leaves(want["params"])))
    update_ok = all(torch.allclose(a, b, **UPDATE_TOL) for a, b in
                    zip(M.leaves(pg), M.leaves(want["params"])))
    # card against CPU end to end: Adam's first step moves an entry by
    # lr_t g/(|g| + eps), so where |g| is near eps (1e-8) the gradients'
    # last bits move it by up to lr_t; reported, not held
    lr_t = tc.lr / tc.warmup
    diffs = [(a - b).abs() for a, b in zip(M.leaves(pg), M.leaves(pc))]
    end_err = max(float(d.max()) for d in diffs)
    n_far = sum(int((d > 0.01 * lr_t).sum()) for d in diffs)
    n_all = sum(d.numel() for d in diffs)
    if abs(lg - lc) > STEP_LOSS_RTOL * abs(lc) \
            or grad_rel > STEP_GRAD_REL or not update_ok:
        fail(f"phase {tag} {arch}: loss card {lg} CPU {lc}, worst gradient "
             f"leaf off by {grad_rel:.3e} in relative norm, the card's "
             f"update off the CPU's arithmetic by {update_err:.3e} (bars "
             f"{STEP_LOSS_RTOL}, {STEP_GRAD_REL}, {UPDATE_TOL}){routing}")
    print(f"[{tag}] {arch} at d_model {c.d_model}, depth {c.num_layers}, "
          f"fp32, TF32 off, batch "
          f"{batch}, seq {seq}: one step card vs CPU from the same "
          f"weights and batch: loss {lg:.6f} vs {lc:.6f} (rel "
          f"{abs(lg - lc) / abs(lc):.2e} <= {STEP_LOSS_RTOL}), grad norm "
          f"{ng:.6f} vs {nc:.6f}, worst gradient leaf {grad_rel:.3e} in "
          f"relative norm (<= {STEP_GRAD_REL}) over {len(diffs)} leaves; "
          f"the card's new parameters against the CPU's optimizer on the "
          f"card's gradients: max |diff| {update_err:.3e} (rtol "
          f"{UPDATE_TOL['rtol']}, atol {UPDATE_TOL['atol']}, every "
          f"entry); against the CPU's own step: max |diff| "
          f"{end_err:.3e}, {n_far} of {n_all} entries above 0.01 lr_t "
          f"({0.01 * lr_t:.2e}){routing}")


def gan_phases(dev, all_counts):
    """Phases 22-24: the paper's GAN trained at full width (PAPER, R 8),
    one epoch on the card against the CPU, and a profile of PAPER epochs.
    Returns B1's launches over the counted training runs and, by ring
    mode, phase 22's (epoch p50 in ms, final generator stack on the CPU,
    final ensemble mean|r̂|, final state outside "sync" on the CPU)."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER, REDUCED
    from repro_torch.problems import get_problem

    prob = get_problem("proxy1d")
    data = prob.make_reference_data(torch.Generator(device=dev).manual_seed(
        99), GAN_REF_EVENTS, device=dev)

    def paper(mode):
        return dataclasses.replace(
            PAPER, sync=dataclasses.replace(PAPER.sync, mode=mode))

    # -- 22. train PAPER at full width in both ring modes --------------------
    launches, finals = 0, {}
    for mode in GAN_MODES:
        got, p50, final = train_and_check(
            "22", f"GAN PAPER {mode}", dev, paper(mode), data, all_counts,
            gan_expect(paper(mode), GAN_EPOCHS, all_counts), gan_healthy)
        launches += got["inverse_cdf"][0]
        finals[mode] = (p50, final["gen"], final["residual"],
                        final["state"])

    # -- 23. one epoch on the card against the CPU ---------------------------
    for mode in GAN_MODES:
        epoch_card_vs_cpu("23", f"GAN {mode}", dev, dataclasses.replace(
            PAPER, n_param_samples=REDUCED.n_param_samples,
            events_per_sample=REDUCED.events_per_sample,
            sync=dataclasses.replace(PAPER.sync, mode=mode, h=1)),
            pin_kinks=True)

    # -- 24. profile PAPER epochs --------------------------------------------
    def group(low):
        return ("B1 icdf_kernel" if "icdf_kernel" in low else
                "GEMM (cuBLAS/CUTLASS)" if gemm_kernel(low) else
                "the exchange's rolls" if "roll" in low else
                "reductions" if "reduce" in low else
                "other (elementwise: activations, losses, Adam, B1's "
                "backward; copies, draws)")
    prof = profile_epochs("24", f"GAN PAPER {GAN_MODES[0]}", dev,
                          paper(GAN_MODES[0]), data, group, SEED + 24)
    if prof is not None:
        groups, total, wall_us = prof
        b1 = groups.get("B1 icdf_kernel", 0.0)
        n = GAN_PROFILED
        print(f"[24] GAN PAPER: B1's share of the card's time "
              f"{100 * b1 / total:.2f}% ({b1 / n / 1e3:.4f} ms an epoch), of "
              f"the epoch's host-clock time {100 * b1 / wall_us:.2f}%")
    return launches, finals


def problem_phases(dev, all_counts):
    """Phases 26-28: proxy2d, linear_blur, imaging and imaging_blur
    trained at full width (`for_problem(name, PAPER)`, R 8), one epoch of
    three of them on the card against the CPU, and a profile of imaging
    epochs.  Returns each kernel's launches over the counted runs and each
    trained problem's epoch p50 (ms)."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER, REDUCED, for_problem
    from repro_torch.problems import get_problem

    launches = {k: 0 for k in all_counts}
    datas, p50s = {}, {}

    # -- 26. train every other problem at full width -------------------------
    for name in PROBLEMS_TRAINED:
        datas[name] = data = get_problem(name).make_reference_data(
            torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
            device=dev)
        wcfg = for_problem(name, PAPER)
        # imaging_blur cut to CUT_EPOCHS: phase 46 trains it for GAN_EPOCHS;
        # proxy2d and linear_blur too: their forward models run the same
        # calls every epoch, and phases 40, 42 and 48 train the stacked
        # trainer at PAPER's widths (proxy1d) for GAN_EPOCHS
        n = GAN_EPOCHS if name == "imaging" else CUT_EPOCHS
        got, p50s[name], _ = train_and_check(
            "26", f"{name} for_problem(PAPER)", dev, wcfg, data, all_counts,
            gan_expect(wcfg, n, all_counts), gan_improving, n_epochs=n)
        for k in launches:
            launches[k] += got[k][0]

    # -- 27. one epoch on the card against the CPU ---------------------------
    for name in ("proxy2d", "linear_blur", "imaging"):
        base = for_problem(name, REDUCED)
        for mode in GAN_MODES:
            epoch_card_vs_cpu("27", f"{name} {mode}", dev, dataclasses.replace(
                for_problem(name, PAPER),
                n_param_samples=base.n_param_samples,
                events_per_sample=base.events_per_sample,
                sync=dataclasses.replace(PAPER.sync, mode=mode, h=1)),
                pin_kinks=True)

    # -- 28. profile imaging epochs ------------------------------------------
    def group(low):
        return ("B1 icdf_kernel" if "icdf_kernel" in low else
                "B2 mask_kernel" if "mask_kernel" in low else
                "B3 blur_kernel" if "blur_kernel" in low else
                "conv backward (cuDNN dgrad/wgrad)" if any(
                    w in low for w in ("dgrad", "wgrad", "backward_data",
                                       "backward_filter")) else
                "conv forward (cuDNN)" if any(
                    w in low for w in ("fprop", "convolve", "conv2d",
                                       "cudnn", "implicit")) else
                "GEMM (cuBLAS/CUTLASS)" if gemm_kernel(low) else
                "the exchange's rolls" if "roll" in low else
                "reductions" if "reduce" in low else
                "other (elementwise: activations, upsampling, losses, "
                "Adam, gathers; copies, draws)")
    wcfg = for_problem("imaging", PAPER)
    prof = profile_epochs("28", "imaging for_problem(PAPER) "
                          f"{wcfg.sync.mode}", dev, wcfg, datas["imaging"],
                          group, SEED + 28)
    if prof is not None:
        groups, total, _ = prof
        conv = sum(us for k, us in groups.items() if k.startswith("conv"))
        kern = sum(groups.get(k, 0.0) for k in (
            "B1 icdf_kernel", "B2 mask_kernel", "B3 blur_kernel"))
        print(f"[28] imaging: the generator's convs take "
              f"{100 * conv / total:.1f}% of the card's time, B1-B3 "
              f"{100 * kern / total:.2f}%")
    return launches, p50s


def gan_expect(wcfg, n_epochs, kernels):
    """Each of `kernels`' (launches, plain calls, backward launches,
    backward plain) over epochs 0..n_epochs-1 of `wcfg`, the one count
    of every GAN run here: B1 once on each epoch where a half runs, its
    closed-form backward on the generator's epochs where the gradient
    reaches it (not the imaging readout's noise), and B2 (backward in
    PyTorch) or B3 (backward B3) the same way for the image problems
    (`workflow.due_counts`; at the every-epoch cadence, once an epoch);
    every other kernel 0."""
    from repro_torch.core.workflow import due_counts
    n_half, n_gen = due_counts(wcfg, n_epochs)
    forward = TRAINED_FORWARD.get(wcfg.problem)
    want = {k: (0, 0, 0, 0) for k in kernels}
    want["inverse_cdf"] = (n_half, 0, 0, n_gen if forward is None else 0)
    if forward == "mask_apply":
        want[forward] = (n_half, 0, 0, n_gen)
    elif forward == "blur2d":
        want[forward] = (n_half, 0, n_gen, 0)
    return want


def proc_expect(wcfg, n_epochs):
    """Each worker's counts by GAN kernel over `n_epochs` (`gan_expect`),
    as lists, the way the workers' summaries hold them."""
    from repro_torch.runtime.launch import GAN_KERNELS
    return {k: list(v) for k, v in
            gan_expect(wcfg, n_epochs, GAN_KERNELS).items()}


def proc_counted(label, dev, wcfg, data, all_counts, n_epochs, **kw):
    """One proc run of `wcfg` as R 8 worker processes (GAN_OUTER x
    GAN_INNER) with every count set to 0 just before it: each worker must
    count `proc_expect(wcfg, n_epochs)`; the parent nothing."""
    from repro_torch.runtime.launch import run_proc
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted main-path run ---
    out = run_proc(wcfg, GAN_OUTER, GAN_INNER, n_epochs, data, seed=SEED,
                   device=dev, timeout=PROC_TIMEOUT_S, **kw)
    parent = [k for k, c in all_counts.items()
              if c.launches or c.plain_calls or c.backward_launches
              or c.backward_plain]
    # ----------------------------------------------------------------------
    want = proc_expect(wcfg, n_epochs)
    bad = {s["rank"]: s["counts"] for s in out["summaries"]
           if s["counts"] != want}
    if bad or parent:
        fail(f"{label}: workers' (launches, plain calls, backward "
             f"launches, backward plain) {bad}, expected {want} in each; "
             f"the parent counted {parent}")
    return out


def preset_name(wcfg):
    """`PAPER`, or `for_problem(name, PAPER)` for the other problems, and
    the update cadence where it is not every epoch."""
    name = ("PAPER" if wcfg.problem == "proxy1d"
            else f"{wcfg.problem} for_problem(PAPER)")
    if (wcfg.disc_every, wcfg.gen_every) != (1, 1):
        name += (f" at disc_every {wcfg.disc_every}, gen_every "
                 f"{wcfg.gen_every}")
    if wcfg.sync.adaptive:
        name += f", adaptive at k_max {wcfg.sync.staleness}"
    elif wcfg.sync.staleness > 1:
        name += f", staleness {wcfg.sync.staleness}"
    if wcfg.sync.overlap:
        name += ", overlap"
    return name


def check_dtypes(label, state, wcfg):
    """Fails unless the master state (gen, disc and their Adam states) is
    fp32 (int32 steps), the mailbox's masked leaves and the flat outer
    mailbox are in the payload's dtype, its biases fp32, and every mailbox
    leaf is its generator leaf's shape with the depth axis [R, k, ...]
    where `staleness` k > 1; under `adaptive`, the sync state is the flat
    [R, k_max, D] payload in the payload's dtype, its int32 [R, k_max]
    tags, the outer mailbox and the controller, as JAX's."""
    import torch
    from repro_torch.core import gan
    from repro_torch.core import workflow as W
    from repro_torch.core.sync import payload_dtype_of
    from repro_torch.core.tree import tree_leaves, tree_paths
    wire = payload_dtype_of(wcfg.sync.payload_precision)
    k = wcfg.sync.staleness
    bad = [f"{top}/{key} {t.dtype}" for top in ("gen", "gen_opt", "disc",
                                                "disc_opt")
           for key, t in tree_paths(state[top])
           if t.dtype not in (torch.float32, torch.int32)]
    if wcfg.sync.adaptive:
        # the max-depth flat mailbox [R, k_max, D], its int32 tags and the
        # controller: JAX's layout
        R = state["epoch"].shape[0]
        D = W.make_schedule(wcfg).spec.total
        want = {"mailbox/payload": ((R, k, D), wire),
                "mailbox/tag": ((R, k), torch.int32),
                "outer_mailbox": ((R, D), wire),
                "ctrl/skew_ema": ((R,), torch.float32),
                "ctrl/k_eff": ((R,), torch.int32),
                "ctrl/shipped_for": ((R,), torch.int32)}
        got = {key: (tuple(t.shape), t.dtype)
               for key, t in tree_paths(state["sync"])}
        bad += [f"sync/{key} {got.get(key)}, not {v}"
                for key, v in want.items() if got.get(key) != v]
        bad += [f"sync/{key}" for key in set(got) - set(want)]
        if bad:
            fail(f"{label}: leaves of the wrong dtype or shape {bad[:6]} "
                 f"(master state fp32, the adaptive sync state as JAX's)")
        return
    mb = state["sync"]["mailbox"]
    bad += [f"sync/mailbox/{key} {t.dtype}" for m, (key, t) in zip(
        tree_leaves(gan.weight_mask(mb)), tree_paths(mb))
        if t.dtype != (wire if m else torch.float32)]
    if state["sync"]["outer_mailbox"].dtype != wire:
        bad.append(f"sync/outer_mailbox {state['sync']['outer_mailbox'].dtype}")
    for (key, t), g in zip(tree_paths(mb), tree_leaves(state["gen"])):
        want = tuple(g.shape[:1]) + ((k,) if k > 1 else ()) + \
            tuple(g.shape[1:])
        if tuple(t.shape) != want:
            bad.append(f"sync/mailbox/{key} {tuple(t.shape)}, not {want}")
    if bad:
        fail(f"{label}: leaves of the wrong dtype or shape {bad[:6]} (master "
             f"state fp32, the mailbox's weights and the outer mailbox "
             f"{wire}, the mailbox at depth {k})")


def proc_bitwise(tag, dev, wcfg, data, all_counts, twin=None):
    """Phases 34, 37 and 39: PROC_BITWISE_EPOCHS lock-step epochs as 8
    workers, the stacked final state bitwise `lockstep_reference` on the
    card (and `twin`, a state on the CPU, where given), its dtypes as the
    config says, the gap to `train_stacked` printed, and the bytes a
    deposit read off the ring's windows 0 -> 1: one window, or one a
    ring segment under `ring_chunking`.  Returns the workers' counts and
    the final state on the CPU."""
    import glob
    import shutil
    import tempfile
    import torch
    from repro_torch.core import workflow as W
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
    from repro_torch.runtime.launch import lockstep_reference
    from repro_torch.runtime.mailbox import _MBX_HDR

    t0 = time.perf_counter()
    R = GAN_OUTER * GAN_INNER
    prec, chunk = wcfg.sync.payload_precision, wcfg.sync.ring_chunking
    label = (f"[{tag}] {preset_name(wcfg)} {wcfg.sync.mode} h {wcfg.sync.h},"
             f" {prec} payload{f', ring_chunking {chunk:,} B' if chunk else ''}"
             f", {R} workers")
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_proc_")
    try:
        out = proc_counted(label, dev, wcfg, data, all_counts,
                           PROC_BITWISE_EPOCHS, run_dir=run_dir)
        channel = "all" if wcfg.sync.mode == "conv_arar" else "inner"
        files = sorted(glob.glob(os.path.join(
            run_dir, f"mbx_0to1_{channel}w*.bin")), key=lambda p: int(
            p.rsplit("w", 1)[1].split(".")[0])) or [os.path.join(
            run_dir, f"mbx_0to1_{channel}.bin")]
        windows = [os.path.getsize(f) - _MBX_HDR.size for f in files]
        ships = ship_windows(run_dir, wcfg) if wcfg.sync.overlap else None
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    ref = lockstep_reference(SEED, wcfg, GAN_OUTER, GAN_INNER,
                             PROC_BITWISE_EPOCHS, data, device=dev)
    state = tree_map(lambda t: t.cpu(), out["state"])
    for what, want in (("the per-rank reference", ref), ("phase 34's "
                       "unchunked run", twin)):
        if want is None:
            continue
        diff = {k: float((a.float() - b.float().cpu()).abs().max())
                for (k, a), b in zip(tree_paths(state), tree_leaves(want))
                if a.dtype != b.dtype or not torch.equal(a, b.cpu())}
        if diff:
            fail(f"{label}: the workers' final state is not bitwise {what}:"
                 f" max |diff| by leaf {diff}")
    check_dtypes(label, out["state"], wcfg)
    spec = W.make_schedule(wcfg).spec
    deposit = spec.total * spec.payload_dtype.itemsize
    # the adaptive deposit carries its int32 epoch tag in the same
    # transfer, windowed as one payload
    wire = deposit + (4 if wcfg.sync.adaptive else 0)
    n_windows = spec.n_segments if not wcfg.sync.adaptive else (
        -(-wire // chunk) if 0 < chunk < wire else 1)
    if sum(windows) != wire or len(windows) != n_windows:
        fail(f"{label}: the ring's windows 0 -> 1 hold {windows} B, a "
             f"deposit of {spec.total} scalars in {spec.payload_dtype}"
             f"{' and its tag' if wcfg.sync.adaptive else ''} is {wire} B "
             f"in {n_windows} windows")
    if wcfg.sync.adaptive:
        skew = [(s["max_skew_ema"], s["max_k_eff"]) for s in out["summaries"]]
        if skew != [(0.0, 1)] * R:
            fail(f"{label}: (max_skew_ema, max_k_eff) by rank {skew}; "
                 f"lock-step workers deposit at the same epoch, so every "
                 f"rank must read skew 0 and keep k_eff 1")
        print(f"{label}: every rank's max_skew_ema 0.0 and max_k_eff 1 "
              f"(lock-step: each deposit's tag is exactly k_eff = 1 epoch "
              f"old); the inner deposit {wire:,} B, its payload and its "
              f"int32 tag in one transfer")
    if ships is not None:
        want = [e for e in range(PROC_BITWISE_EPOCHS)
                if (e + 1) % wcfg.sync.h == 0]
        bad = {r: v for r, v in ships["by_rank"].items()
               if v != (len(want), want[-1], deposit)}
        if bad or ships["outer_files"]:
            fail(f"{label}: the ship windows (entries, last tag, bytes) by "
                 f"rank {bad}, want ({len(want)}, {want[-1]}, {deposit}) "
                 f"each: a deposit on each ship epoch {want}; outer-ring "
                 f"windows {ships['outer_files']}, want none")
        print(f"{label}: every rank's ship window holds {len(want)} entries "
              f"of {deposit:,} B, one a ship epoch {want} (the last tagged "
              f"epoch {want[-1]}), and no outer-ring window exists: the pod "
              f"boundary is crossed on the ship epochs only")
    stacked, _ = W.train_stacked(SEED, wcfg, GAN_OUTER, GAN_INNER,
                                 PROC_BITWISE_EPOCHS, data, device=dev)
    gap = {top: max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(stacked[top]), tree_leaves(out["state"][top])))
        for top in ("gen", "disc")}
    also = " and phase 34's unchunked run" if twin is not None else ""
    sync_what = ("the adaptive mailbox and its tags, the controller" if
                 wcfg.sync.adaptive else "the mailbox's weights")
    runs = ", ".join(f"{k} {n[0]} times (backward {n[2]} launches, {n[3]} "
                     f"in PyTorch)" for k, n in
                     proc_expect(wcfg, PROC_BITWISE_EPOCHS).items() if n[0])
    print(f"{label} ({GAN_OUTER} x {GAN_INNER}) on one card, lock-step, "
          f"{PROC_BITWISE_EPOCHS} epochs, fp32 compute (TF32 off): the "
          f"final state (gen, gen_opt, disc, disc_opt, sync, epoch) bitwise "
          f"the per-rank reference computed in this process{also}, "
          f"{sync_what} and the outer mailbox in "
          f"{spec.payload_dtype}, the master state fp32; {deposit:,} B a "
          f"deposit ({spec.total:,} scalars) in {len(windows)} window(s) "
          f"0 -> 1 of {', '.join(f'{w:,}' for w in windows)} B; in each "
          f"worker {runs}, no plain call; against train_stacked's "
          f"{PROC_BITWISE_EPOCHS} epochs max |diff| gen {gap['gen']:.3e}, "
          f"disc {gap['disc']:.3e} (batched against per-rank GEMMs); "
          f"start-up {out['startup_s']:.1f} s, spawn to result "
          f"{out['wall_s']:.1f} s; phase {time.perf_counter() - t0:.1f} s")
    counts = out["counts"]
    del out, stacked, ref
    torch.cuda.empty_cache()
    return counts, state


def ship_windows(run_dir, wcfg):
    """The overlap schedule's ship windows of a proc run of R 8 workers:
    each rank's (entries, last tag, bytes) in its window toward its
    outer-ring successor (`ProcComm`'s "ship" channel, one window
    unchunked), and the outer-ring windows that exist (none under
    overlap: the pod boundary is crossed by the ships alone)."""
    import glob
    from repro_torch.runtime.mailbox import _MBX_HDR
    by_rank = {}
    for r in range(GAN_OUTER * GAN_INNER):
        succ = ((r // GAN_INNER + 1) % GAN_OUTER) * GAN_INNER + r % GAN_INNER
        with open(os.path.join(run_dir, f"mbx_{r}to{succ}_ship.bin"),
                  "rb") as f:
            wseq, _, tag, nbytes = _MBX_HDR.unpack(f.read(_MBX_HDR.size))
        by_rank[r] = (wseq, tag, nbytes)
    outer = glob.glob(os.path.join(run_dir, "mbx_*_outer*.bin"))
    return {"by_rank": by_rank, "outer_files": sorted(
        os.path.basename(p) for p in outer)}


def gan_healthy(d):
    """Phase 22's bars on the d_loss (mean over ranks) by epoch."""
    return (d[-1] < d[0] and d.min() < GAN_D_MIN,
            f"last < first and min {d.min():.4f} < {GAN_D_MIN}")


def gan_improving(d):
    """Phase 26's bar for the other problems."""
    return (d.min() < d[0], f"min {d.min():.4f} < first {d[0]:.4f}")


def proc_workflow(tag, label, dev, wcfg, data, all_counts, stacked_p50,
                  d_bar=gan_healthy, n_epochs=None, inspect=None, **kw):
    """Phases 35, 37, 39 and 41: `wcfg` for `n_epochs` (None:
    GAN_EPOCHS) epochs as 8 workers: every state leaf and d_loss finite,
    the ensemble in (0, 1) and `d_bar(d_loss by epoch)` (under an update
    cadence, by the discriminator's epochs: `disc_due_losses`); per-rank
    epoch p50/p99 (and under a cadence, p50 by the halves that ran) and
    peak memory, events/s, start-up and wall time beside `stacked_p50`
    (ms).  `inspect(out)`, where given, then reads `run_proc`'s result.
    Returns (the workers' counts, each rank's epoch p50 in ms)."""
    import torch
    from repro_torch.core import gan
    from repro_torch.core.ensemble import ensemble_response
    from repro_torch.core.tree import tree_paths

    t0 = time.perf_counter()
    n_epochs = n_epochs or GAN_EPOCHS
    R = GAN_OUTER * GAN_INNER
    K, E = wcfg.n_param_samples, wcfg.events_per_sample
    prob = wcfg.problem_obj
    noise = torch.randn((64, gan.NOISE_DIM), generator=torch.Generator(
        ).manual_seed(7)).to(dev)
    chunk = wcfg.sync.ring_chunking
    tag = (f"[{tag}] {preset_name(wcfg)} {wcfg.sync.mode} h {wcfg.sync.h}, "
           f"{wcfg.sync.payload_precision} payload"
           f"{f', ring_chunking {chunk:,} B' if chunk else ''}, {label}")
    out = proc_counted(tag, dev, wcfg, data, all_counts, n_epochs, **kw)
    state, hist = out["state"], out["history"]
    bad = [k for k, t in tree_paths(state)
           if not bool(torch.isfinite(t.float()).all())]
    p_hat, _ = ensemble_response(state["gen"], noise)
    d, _ = disc_due_losses(tag, wcfg, range(n_epochs), hist)
    ok, bar = d_bar(d) if np.isfinite(d).all() else (False, "")
    if bad or not ok or not (
            0 < float(p_hat.min()) and float(p_hat.max()) < 1):
        fail(f"{tag}: non-finite leaves {bad[:4]}, ensemble in "
             f"({float(p_hat.min())}, {float(p_hat.max())}), d_loss "
             f"first {d[0]}, last {d[-1]}, min {d.min()}: the bars are "
             f"finite state and d_loss, the ensemble in (0, 1), {bar}")
    check_dtypes(tag, state, wcfg)
    ms = hist["epoch_s"].numpy() * 1e3                   # [T, R]
    p50 = np.percentile(ms, 50, axis=0)
    cadenced = (wcfg.disc_every, wcfg.gen_every) != (1, 1)
    on = (f" on the discriminator's epochs (disc_every {wcfg.disc_every}, "
          f"gen_every {wcfg.gen_every}; the skipped halves' losses NaN)"
          if cadenced else "")
    print(f"{tag}: {R} workers ({GAN_OUTER} x {GAN_INNER}) on one card, "
          f"{n_epochs} epochs, fp32 compute (TF32 off); d_loss (mean over "
          f"ranks){on} first {d[0]:.4f}, last {d[-1]:.4f}, min "
          f"{d.min():.4f}; "
          f"{bar}; every state leaf finite; ensemble in "
          f"({float(p_hat.min()):.4f}, {float(p_hat.max()):.4f}); final "
          f"mean|r̂| {float(prob.mean_abs_residual(p_hat)):.4f}")
    for r, (s, a, b) in enumerate(zip(out["summaries"], p50,
                                      np.percentile(ms, 99, axis=0))):
        halves = ("; " + flags_text(p50_by_flags(wcfg, range(n_epochs),
                                                  ms[:, r]))
                  if cadenced else "")
        print(f"{tag}: rank {s['rank']} on {s['device']}: epoch p50 "
              f"{a:.3f} ms, p99 {b:.3f} ms (host clock after "
              f"torch.cuda.synchronize){halves}, {s['wall_s']:.2f} s for "
              f"its epochs, peak memory "
              f"{s['peak_memory_bytes'] / 2**30:.3f} GiB")
    counted = ", ".join(f"{k} {tuple(n)}" for k, n in out["counts"].items()
                        if any(n))
    print(f"{tag}: {K * E * (1e3 / p50).sum():,.0f} generated events/s "
          f"(each rank's {K} x {E} events at its epoch p50, summed); "
          f"spawn to result {out['wall_s']:.1f} s, start-up (spawn to "
          f"the last worker through the run-start barrier) "
          f"{out['startup_s']:.1f} s; summed over the workers (launches, "
          f"plain, backward launches, backward plain): {counted}; the "
          f"stacked epoch p50 in the same run {stacked_p50:.3f} ms "
          f"({R * K * E / stacked_p50 * 1e3:,.0f} events/s); phase "
          f"{time.perf_counter() - t0:.1f} s")
    if inspect is not None:
        inspect(out)
    counts = out["counts"]
    del out, state, hist
    torch.cuda.empty_cache()
    return counts, p50


def add_launches(launches, counts):
    """Add each kernel's launches in `counts` (kernel -> (launches, ...))
    to `launches`."""
    for k, n in counts.items():
        launches[k] = launches.get(k, 0) + n[0]


def proc_phases(dev, all_counts, stacked_p50):
    """Phases 34-35: the paper's GAN as R 8 worker processes on the card
    (`runtime.launch.run_proc`, 2 x 4): lock-step runs bitwise their
    per-rank reference, then PAPER for CUT_EPOCHS epochs lock-step and
    PROC_FREE_EPOCHS free-running, with phase 22's bars.  `stacked_p50` is
    phase 22's epoch p50 by mode.  Returns each kernel's launches in the
    workers over the counted runs, the lock-step run's epoch p50 by rank
    (ms), the bitwise runs' final states on the CPU by mode and the free
    run's epoch p50 by rank (ms)."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.problems import get_problem
    from repro_torch.runtime import JitterConfig

    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    launches, states = {}, {}
    # -- 34. lock-step, bitwise its per-rank reference -----------------------
    for mode, h in PROC_BITWISE:
        counts, states[mode] = proc_bitwise("34", dev, dataclasses.replace(
            PAPER, sync=dataclasses.replace(PAPER.sync, mode=mode, h=h)),
            data, all_counts)
        add_launches(launches, counts)

    # -- 35. the paper's workflow: lock-step and free-running ---------------
    p50 = {}
    for label, kw in (
            ("lock-step", {"n_epochs": CUT_EPOCHS}),
            ("free", {"lockstep": False, "n_epochs": PROC_FREE_EPOCHS,
                      "jitter": JitterConfig(seed=SEED,
                                             rank_lag_ms=PROC_LAG_MS)})):
        counts, p50[label] = proc_workflow(
            "35", "lock-step" if label == "lock-step" else
            f"free-running, rank r sleeps r x {PROC_LAG_MS} ms an epoch",
            dev, PAPER, data, all_counts, stacked_p50[PAPER.sync.mode], **kw)
        add_launches(launches, counts)
    return launches, p50["lock-step"], states, p50["free"]


def bf16_phases(dev, all_counts, fp32, imaging_blur_p50):
    """Phases 36-37: the bf16 ring payload (`payload_precision="bf16"`) on
    the card.  36: PAPER stacked at R 8 in both ring modes for CUT_EPOCHS
    with phase 22's bars and counts, beside phase 22's fp32 runs (`fp32`:
    mode -> (p50 ms, ...)); imaging_blur for CUT_EPOCHS with phase 26's
    bars and counts beside its fp32 p50; one epoch card vs CPU.  37: the
    proc runtime, lock-step bitwise its reference in both modes (phase 41
    trains bf16 lock-step workers for 200 epochs).  Returns each kernel's
    launches over the counted runs and phase 36's PAPER epoch p50 (ms) by
    mode."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER, REDUCED, for_problem
    from repro_torch.problems import get_problem

    def bf16(wcfg, **sync):
        return dataclasses.replace(wcfg, sync=dataclasses.replace(
            wcfg.sync, payload_precision="bf16", **sync))
    launches, p50s = {k: 0 for k in all_counts}, {}
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)

    # -- 36. stacked: PAPER in both ring modes, imaging_blur, card vs CPU ---
    # both modes cut to CUT_EPOCHS: phase 42 trains the bf16 payload in
    # rma_arar_arar (throughput(PAPER), chunked, at depth 2) for
    # GAN_EPOCHS, and phase 40 trains conv_arar (at disc_every 2,
    # gen_every 3) for GAN_EPOCHS
    for mode in GAN_MODES:
        wcfg = bf16(PAPER, mode=mode)
        got, p50, _ = train_and_check(
            "36", f"GAN PAPER {mode} bf16 payload", dev, wcfg, data,
            all_counts, gan_expect(wcfg, CUT_EPOCHS, all_counts),
            gan_healthy, n_epochs=CUT_EPOCHS)
        launches["inverse_cdf"] += got["inverse_cdf"][0]
        p50s[mode] = p50
        p50_32 = fp32[mode][0]
        print(f"[36] GAN PAPER {mode} bf16 payload: epoch p50 {p50:.3f} ms "
              f"beside phase 22's fp32 {p50_32:.3f} ms in the same run "
              f"({p50 / p50_32:.3f}x); {CUT_EPOCHS} epochs (phase 22 trains "
              f"{GAN_EPOCHS}: no generator gap printed)")

    name = "imaging_blur"
    wcfg = bf16(for_problem(name, PAPER))
    blur_data = get_problem(name).make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    # cut to CUT_EPOCHS: phase 46 trains imaging_blur for GAN_EPOCHS, and
    # phases 41 and 42 the bf16 payload
    got, p50, _ = train_and_check("36", f"{name} for_problem(PAPER) bf16 "
                                  "payload", dev, wcfg, blur_data,
                                  all_counts,
                                  gan_expect(wcfg, CUT_EPOCHS, all_counts),
                                  gan_improving, n_epochs=CUT_EPOCHS)
    for k in launches:
        launches[k] += got[k][0]
    from repro_torch.core import workflow as W
    spec = W.make_schedule(wcfg).spec
    print(f"[36] {name} bf16 payload: epoch p50 {p50:.3f} ms beside phase "
          f"26's fp32 {imaging_blur_p50:.3f} ms in the same run; "
          f"{spec.total:,} scalars a rank, "
          f"{spec.total * spec.payload_dtype.itemsize:,} B in bf16 "
          f"({spec.total * 4:,} B in fp32)")
    del blur_data
    epoch_card_vs_cpu("36", "GAN rma_arar_arar bf16 payload", dev, bf16(
        dataclasses.replace(PAPER, n_param_samples=REDUCED.n_param_samples,
                            events_per_sample=REDUCED.events_per_sample),
        mode="rma_arar_arar", h=1), pin_kinks=True)

    # -- 37. the proc runtime at bf16 ----------------------------------------
    for mode, h in PROC_BITWISE:
        counts, _ = proc_bitwise("37", dev, bf16(PAPER, mode=mode, h=h),
                                 data, all_counts)
        add_launches(launches, counts)
    return launches, p50s


def chunked_phases(dev, all_counts, fp32, bf16_p50, imaging_blur_p50,
                   proc_states, proc_p50):
    """Phases 38-39: the chunked ring (`ring_chunking`) on the card.  38:
    PAPER stacked at R 8 in both ring modes at RING_CHUNK for CUT_EPOCHS
    with phase 22's bars and counts beside phase 22's runs (`fp32`: mode
    -> (p50 ms, ...)), CHUNK_BITWISE_EPOCHS epochs of
    each bitwise an unchunked run; imaging_blur at IMAGE_RING_CHUNK for
    CUT_EPOCHS with phase 26's bars and counts beside its p50
    (`imaging_blur_p50`); PAPER
    at bf16 and RING_CHUNK for CUT_EPOCHS beside phase 36's (`bf16_p50`
    by mode).  39:
    the proc runtime, phase 34's bitwise runs chunked, bitwise their
    reference and phase 34's states (`proc_states` by mode);
    imaging_blur as 8 workers, bitwise its reference, then CUT_EPOCHS
    lock-step epochs with phase 26's bars beside its stacked p50 (phase
    49 runs these workers free at IMAGE_RING_CHUNK); PAPER's lock-step
    epoch a rank is phase 35's (`proc_p50`).  Returns each kernel's
    launches over the counted runs."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER, for_problem
    from repro_torch.core import workflow as W
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.problems import get_problem

    def chunked(wcfg, chunk=RING_CHUNK, **sync):
        return dataclasses.replace(wcfg, sync=dataclasses.replace(
            wcfg.sync, ring_chunking=chunk, **sync))

    def paper(mode, **sync):
        return dataclasses.replace(PAPER, sync=dataclasses.replace(
            PAPER.sync, mode=mode, **sync))
    launches = {k: 0 for k in all_counts}
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    t0 = time.perf_counter()

    # -- 38. stacked ----------------------------------------------------------
    for mode in GAN_MODES:
        wcfg = chunked(paper(mode))
        nseg = W.make_schedule(wcfg).spec.n_segments
        states = [W.train_stacked(SEED, c, GAN_OUTER, GAN_INNER,
                                  CHUNK_BITWISE_EPOCHS, data, device=dev)[0]
                  for c in (paper(mode), wcfg)]
        diff = [k for (k, a), b in zip(tree_paths(states[1]),
                                       tree_leaves(states[0]))
                if not torch.equal(a, b)]
        if diff or nseg != 4:
            fail(f"[38] GAN PAPER {mode}, {nseg} segments: after "
                 f"{CHUNK_BITWISE_EPOCHS} epochs the chunked state differs "
                 f"from the unchunked one in {diff[:6]}")
        print(f"[38] GAN PAPER {mode} at ring_chunking {RING_CHUNK:,} B "
              f"({nseg} segments): {CHUNK_BITWISE_EPOCHS} epochs from seed "
              f"{SEED} bitwise an unchunked run on the card (the whole "
              f"state)")
        del states
        # both modes cut to CUT_EPOCHS: phase 42 trains the ring at 65,536 B
        # (throughput(PAPER), at depth 2) for GAN_EPOCHS, phase 46 the
        # image problem's at 524,288 B
        got, p50, _ = train_and_check(
            "38", f"GAN PAPER {mode} ring_chunking {RING_CHUNK:,} B", dev,
            wcfg, data, all_counts, gan_expect(wcfg, CUT_EPOCHS, all_counts),
            gan_healthy, n_epochs=CUT_EPOCHS)
        launches["inverse_cdf"] += got["inverse_cdf"][0]
        p50_32 = fp32[mode][0]
        R, K, E = GAN_OUTER * GAN_INNER, PAPER.n_param_samples, \
            PAPER.events_per_sample
        print(f"[38] GAN PAPER {mode} chunked: epoch p50 {p50:.3f} ms "
              f"({R * K * E / p50 * 1e3:,.0f} events/s) beside phase 22's "
              f"unchunked {p50_32:.3f} ms ({R * K * E / p50_32 * 1e3:,.0f} "
              f"events/s) in the same run ({p50 / p50_32:.3f}x); "
              f"{CUT_EPOCHS} epochs (phase 22 trains {GAN_EPOCHS}: no "
              f"generator gap printed)")

    name = "imaging_blur"
    wcfg = chunked(for_problem(name, PAPER), IMAGE_RING_CHUNK)
    spec = W.make_schedule(wcfg).spec
    if spec.n_segments != 3:
        fail(f"[38] {name}: {spec.n_segments} segments at "
             f"{IMAGE_RING_CHUNK} B, expected 3")
    blur_data = get_problem(name).make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    got, blur_p50, _ = train_and_check(
        "38", f"{name} for_problem(PAPER) ring_chunking "
        f"{IMAGE_RING_CHUNK:,} B", dev, wcfg, blur_data, all_counts,
        gan_expect(wcfg, CUT_EPOCHS, all_counts), gan_improving,
        n_epochs=CUT_EPOCHS)
    for k in launches:
        launches[k] += got[k][0]
    print(f"[38] {name} chunked: epoch p50 {blur_p50:.3f} ms beside phase "
          f"26's unchunked {imaging_blur_p50:.3f} ms in the same run; "
          f"{spec.total:,} scalars a rank ({spec.total * 4:,} B) in "
          f"{spec.n_segments} segments of at most {IMAGE_RING_CHUNK:,} B")

    wcfg = chunked(paper("rma_arar_arar"), payload_precision="bf16")
    nseg = W.make_schedule(wcfg).spec.n_segments
    got, p50, _ = train_and_check(
        "38", f"GAN PAPER rma_arar_arar bf16 payload, ring_chunking "
        f"{RING_CHUNK:,} B ({nseg} segments)", dev, wcfg, data, all_counts,
        gan_expect(wcfg, CUT_EPOCHS, all_counts), gan_healthy,
        n_epochs=CUT_EPOCHS)
    if nseg != 2:
        fail(f"[38] bf16 at {RING_CHUNK} B: {nseg} segments, expected 2")
    launches["inverse_cdf"] += got["inverse_cdf"][0]
    print(f"[38] GAN PAPER rma_arar_arar bf16 chunked: epoch p50 {p50:.3f} "
          f"ms beside phase 36's bf16 unchunked "
          f"{bf16_p50['rma_arar_arar']:.3f} ms in the same run; phase 38 "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 39. the proc runtime ---------------------------------------------------
    t0 = time.perf_counter()
    for mode, h in PROC_BITWISE:
        counts, _ = proc_bitwise("39", dev, chunked(paper(mode, h=h)), data,
                                 all_counts, twin=proc_states[mode])
        add_launches(launches, counts)
    wcfg = chunked(for_problem(name, PAPER), IMAGE_RING_CHUNK)
    counts, _ = proc_bitwise("39", dev, dataclasses.replace(
        wcfg, sync=dataclasses.replace(wcfg.sync, h=2)), blur_data,
        all_counts)
    add_launches(launches, counts)
    # cut to CUT_EPOCHS: phase 46 trains imaging_blur at 524,288 B for
    # GAN_EPOCHS, phase 41 lock-step workers
    counts, lock = proc_workflow("39", "lock-step", dev, wcfg, blur_data,
                                 all_counts, blur_p50, d_bar=gan_improving,
                                 n_epochs=CUT_EPOCHS)
    add_launches(launches, counts)
    print(f"[39] {name} as 8 workers at ring_chunking {IMAGE_RING_CHUNK:,} "
          f"B, lock-step: epoch p50 a rank {np.min(lock):.3f}-"
          f"{np.max(lock):.3f} ms (median {np.median(lock):.3f}) beside "
          f"PAPER's unchunked fp32 {np.min(proc_p50):.3f}-"
          f"{np.max(proc_p50):.3f} ms (phase 35, same run); phase 39 "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def disc_due_losses(label, wcfg, epochs, hist):
    """The d_loss (mean over ranks) of the recorded epochs `epochs` on
    which the discriminator ran, and those epochs: what the bars read.
    Fails unless, on every recorded epoch whose half the cadence skipped
    (`workflow.due`), that half's loss is NaN for every rank, and g_loss
    is finite on the generator's epochs."""
    from repro_torch.core.workflow import due
    flags = np.array([due(wcfg, e) for e in epochs], bool).reshape(-1, 2)
    d, g = (hist[k].float().cpu().numpy() for k in ("d_loss", "g_loss"))
    if not (np.isnan(d[~flags[:, 0]]).all()
            and np.isnan(g[~flags[:, 1]]).all()
            and np.isfinite(g[flags[:, 1]]).all()):
        fail(f"{label}: at disc_every {wcfg.disc_every}, gen_every "
             f"{wcfg.gen_every} a skipped half's loss is not NaN, or g_loss "
             f"is not finite where the generator ran (epochs {epochs})")
    return d.mean(1)[flags[:, 0]], [e for e, f in zip(epochs, flags) if f[0]]


def p50_by_flags(wcfg, epochs, ms):
    """{(disc_due, gen_due): (p50, count)} of `ms` [T, ...] over epochs
    `epochs` (axis 0), one entry a flag combination that occurs."""
    from repro_torch.core.workflow import due
    flags = [due(wcfg, e) for e in epochs]
    return {f: (float(np.percentile(ms[np.array([x == f for x in flags])],
                                    50)), flags.count(f))
            for f in FLAG_NAMES if f in flags}


def flags_text(by_flags):
    return ", ".join(f"{FLAG_NAMES[f]} p50 {v:.3f} ms ({n} epochs)"
                     for f, (v, n) in by_flags.items())


def train_and_check(tag, label, dev, wcfg, data, all_counts, expect,
                    d_bar, n_epochs=None, watch=None):
    """Train `wcfg` at R 8 (GAN_OUTER x GAN_INNER) for `n_epochs` (None:
    GAN_EPOCHS) epochs after an uncounted 2-epoch warm-up (phases 22 and
    26).  Fails unless
    each kernel's (launches, plain calls, backward launches, backward
    plain calls) over the counted run equal `expect`, every state leaf is
    finite, the ensemble lies in (0, 1), every recorded d_loss is finite
    and `d_bar(d_loss by recorded epoch)` gives (True, its text).  Prints
    the run, the d_loss trajectory, epoch p50/p99 (CUDA events), events/s,
    peak memory and the final mean|r̂|; fails unless the state's dtypes
    are as the config says (`check_dtypes`).  Returns the counts, the
    epoch p50 (ms) and {"gen": the final generator stack on the CPU,
    "residual": the final ensemble's mean|r̂|, "mean": the mean epoch
    (ms), "by_flags": `p50_by_flags` of the epochs, "obs": the final obs
    tree on the CPU, None without metrics, "state": every leaf outside
    "sync" and "obs" on the CPU}.  `watch(e, metrics)`, where given, sees
    each epoch's metrics as the run enqueues them.  Under an update
    cadence the bars read the discriminator's recorded epochs
    (`disc_due_losses`), and the epoch p50 of each combination of
    halves that ran is printed beside the mean."""
    import torch
    from repro_torch.core import gan
    from repro_torch.core import workflow as W
    from repro_torch.core.ensemble import ensemble_response
    from repro_torch.core.tree import tree_map, tree_paths

    R = GAN_OUTER * GAN_INNER
    n_epochs = n_epochs or GAN_EPOCHS
    K, E = wcfg.n_param_samples, wcfg.events_per_sample
    prob = wcfg.problem_obj
    noise = torch.randn((64, gan.NOISE_DIM), generator=torch.Generator(
        ).manual_seed(7)).to(dev)
    # the warm-up: PyTorch's runtime kernels, cuDNN's plans and the
    # allocator's pool at these shapes
    W.train_stacked(SEED + int(tag), wcfg, GAN_OUTER, GAN_INNER, 2, data,
                    device=dev)
    torch.cuda.synchronize()
    events = []

    def on_epoch(e, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if watch is not None:
            watch(e, metrics)
    torch.cuda.reset_peak_memory_stats(dev)
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted main-path run ---
    state, hist = W.train_stacked(SEED, wcfg, GAN_OUTER, GAN_INNER,
                                  n_epochs, data,
                                  checkpoint_every=GAN_EVERY, device=dev,
                                  on_epoch=on_epoch)
    events[-1].synchronize()
    got = {k: (c.launches, c.plain_calls, c.backward_launches,
               c.backward_plain) for k, c in all_counts.items()}
    # ----------------------------------------------------------------------
    if got != expect:
        fail(f"training {label}: (launches, plain calls, backward launches, "
             f"backward plain calls) {got}; expected {expect}")
    bad = [k for k, t in tree_paths(state)
           if not bool(torch.isfinite(t.float()).all())]
    p_hat, _ = ensemble_response(state["gen"], noise)
    d, d_epochs = disc_due_losses(f"training {label}", wcfg, [
        e for e in range(n_epochs)
        if e % GAN_EVERY == 0 or e == n_epochs - 1], hist)
    ok, bar = d_bar(d) if np.isfinite(d).all() else (False, "")
    if bad or not (0 < float(p_hat.min()) and float(p_hat.max()) < 1) \
            or not ok:
        fail(f"training {label}: non-finite leaves {bad[:4]}, ensemble in "
             f"({float(p_hat.min())}, {float(p_hat.max())}), d_loss by "
             f"recorded epoch {d.tolist()}: the bars are finite state, the "
             f"ensemble in (0, 1), every recorded d_loss finite, {bar}")
    check_dtypes(f"training {label}", state, wcfg)
    steps = np.array([a.elapsed_time(b)
                      for a, b in zip(events[:-1], events[1:])])
    p50 = float(np.percentile(steps, 50))
    by_flags = p50_by_flags(wcfg, range(1, n_epochs), steps)
    last_batch = next(r for r in reversed(hist["residuals"])
                      if not bool(r.isnan().all()))
    cadenced = (wcfg.disc_every, wcfg.gen_every) != (1, 1)
    runs = ", ".join(f"{k} {n[0]} (backward {n[2]} launches, {n[3]} in "
                     f"PyTorch)" for k, n in got.items() if n[0])
    print(f"[{tag}] {label}: {R} ranks ({GAN_OUTER} x {GAN_INNER}), {K} x "
          f"{E} events a rank an epoch, {gan.param_count(state['gen']) // R:,}"
          f" generator parameters a rank, h {wcfg.sync.h}, lr gen "
          f"{wcfg.gen_lr} disc {wcfg.disc_lr}, {wcfg.sync.mode}, {n_epochs} "
          f"epochs from seed {SEED}, fp32 compute (TF32 off), "
          f"{wcfg.sync.payload_precision} ring payload; kernel launches: "
          f"{runs}; no plain call")
    at = (f"the discriminator's recorded epochs {d_epochs} (the skipped "
          f"halves' losses NaN, g_loss finite where the generator ran)"
          if cadenced else f"epochs 0, {GAN_EVERY}, ...")
    print(f"[{tag}] {label}: d_loss (mean over ranks) at {at}: "
          + " ".join(f"{v:.4f}" for v in d)
          + f"; all finite, {bar}; every state leaf finite; ensemble in "
          f"({float(p_hat.min()):.4f}, {float(p_hat.max()):.4f})")
    print(f"[{tag}] {label}: epoch p50 {p50:.3f} ms, p99 "
          f"{float(np.percentile(steps, 99)):.3f} ms (CUDA events, epoch "
          f"end to epoch end, {len(steps)} epochs); "
          f"{R * K * E / p50 * 1e3:,.0f} generated events/s at p50; peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"final mean|r̂| {float(prob.mean_abs_residual(p_hat)):.4f} "
          f"(ensemble of the {R} generators), "
          f"{float(last_batch.abs().mean()):.4f} (the last recorded batch "
          f"a half ran on, mean over ranks)")
    if cadenced:
        print(f"[{tag}] {label}: at disc_every {wcfg.disc_every}, gen_every "
              f"{wcfg.gen_every} the epochs are bimodal: "
              f"{flags_text(by_flags)}; mean epoch {steps.mean():.3f} ms "
              f"({R * K * E / steps.mean() * 1e3:,.0f} events/s)")
    final = {"gen": tree_map(lambda t: t.cpu(), state["gen"]),
             "residual": float(prob.mean_abs_residual(p_hat)),
             "mean": float(steps.mean()), "by_flags": by_flags,
             "obs": (tree_map(lambda t: t.cpu(), state["obs"])
                     if "obs" in state else None),
             "state": tree_map(lambda t: t.cpu(), {
                 k: v for k, v in state.items() if k not in ("sync", "obs")})}
    del state, hist
    torch.cuda.empty_cache()
    return got, p50, final


def metrics_rows(path):
    """A metrics file's header and its rows."""
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return lines[0], lines[1:]


def row_epochs(n_epochs):
    """The epochs at which a metrics file of `train_and_check`'s runs
    gets a row: the end of each chunk of GAN_EVERY epochs."""
    return [min(e + GAN_EVERY, n_epochs)
            for e in range(0, n_epochs, GAN_EVERY)]


@contextlib.contextmanager
def leaky_kinks(record, signs=None):
    """Inside, every Leaky ReLU of the generators and the discriminator
    (`F.leaky_relu` in `core.gan` and `models.convgen`) appends its
    pre-activation to `record`; given `signs`, bool tensors in the same
    call order, each takes its slope from them (x where True, 0.01·x
    elsewhere) instead of from the sign of its own x."""
    import types
    import torch
    import torch.nn.functional as F
    from repro_torch.core import gan
    from repro_torch.models import convgen
    signs = None if signs is None else iter(signs)

    def leaky_relu(x, slope=0.01):
        record.append(x.detach())
        if signs is None:
            return F.leaky_relu(x, slope)
        return torch.where(next(signs).to(x.device), x, slope * x)
    shim = types.SimpleNamespace(**dict(
        {k: getattr(F, k) for k in dir(F) if not k.startswith("_")},
        leaky_relu=leaky_relu))
    saved = gan.F, convgen.F
    gan.F = convgen.F = shim
    try:
        yield record
    finally:
        gan.F, convgen.F = saved


def epoch_card_vs_cpu(tag, label, dev, wcfg, pin_kinks=False,
                      flags=(True, True)):
    """One epoch on the card and on the CPU from the same state (a
    non-zero RMA mailbox) and draws, 4 ranks as 2 x 2 (phases 23, 27, 36
    and 40): losses at rtol STEP_LOSS_RTOL, each generator gradient leaf
    within STEP_GRAD_REL in relative norm, the CPU's exchange of the
    card's gradients bitwise the card's, and the card's new generator and
    Adam state against the CPU's optimizer on the card's synced gradients.

    `pin_kinks` holds the gradient leaves at KINK_GRAD_REL instead,
    against the CPU's gradients at the card's Leaky ReLU signs
    (`leaky_kinks`), and reports the gap without pinning and the number
    of pre-activations whose sign differs between the card and the CPU.

    `flags` (disc_due, gen_due) runs `rank_grads` with those halves, as a
    cadenced epoch does (phase 40).  A skipped half's loss must be NaN on
    both, its state unchanged on the card (the discriminator and its Adam
    state; or the generator, its Adam state and the sync state, the epoch
    counter advanced), and an epoch with neither half must run no Leaky
    ReLU and report NaN parameters.  Without the generator there is no
    exchange and the gradient held is the discriminator's: its first Adam
    moment after one step from zero, 0.1 x the gradient."""
    import torch
    from repro_torch.core import workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_leaves, tree_map

    ud, ug = flags
    prob = wcfg.problem_obj
    g = torch.Generator().manual_seed(SEED + 23)
    cpu_data = prob.make_reference_data(g, 5_000, device="cpu")
    state0, per_rank = W.init_run(g, 4, wcfg, cpu_data, "cpu")
    state0["sync"]["mailbox"] = tree_map(
        lambda t: torch.randn(t.shape, generator=g).to(t.dtype),
        state0["sync"]["mailbox"])
    draws0 = W.make_draws(g, wcfg, 4, per_rank.shape[1])
    sched = W.make_schedule(wcfg)
    out, pre = {}, {}
    for d_ in ("cpu", dev):
        move = lambda tree: tree_map(lambda t: t.to(d_), tree)  # noqa
        with leaky_kinks([]) as pre[str(d_)]:
            part, grads, met = W.rank_grads(move(state0), per_rank.to(d_),
                                            move(draws0), wcfg, ud, ug)
        if ug:
            synced, ns = sched.exchange(VmapComm(2, 2), grads, part["sync"],
                                        part["epoch"][0])
            new = W.rank_apply(part, synced, ns, wcfg)
        else:
            synced, new = {}, W.bump_epoch(part)
        out[str(d_)] = tree_map(lambda t: t.cpu(),
                                (part, grads, met, synced, new))
    (pc, gc, mc, sc, nc), (pg, gg, mg, sg, ng) = out["cpu"], out[str(dev)]
    ran = {"d_loss": ud, "g_loss": ug}
    loss_rel = max([abs(float(a) - float(b)) / abs(float(b))
                    for k in ran if ran[k]
                    for a, b in zip(mg[k], mc[k])] or [0.0])

    def held(part, grads):
        return grads if ug else part["disc_opt"]["mu"]

    def worst(a, b):
        return max(float((x - y).norm() / y.norm())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))
    grad_rel = unpinned = worst(held(pg, gg), held(pc, gc)) \
        if ud or ug else 0.0
    bar = STEP_GRAD_REL
    if pin_kinks and (ud or ug):
        signs = [t.cpu() > 0 for t in pre[str(dev)]]
        flips = sum(int((a != (b > 0)).sum())
                    for a, b in zip(signs, pre["cpu"]))
        with leaky_kinks([], signs):
            pp, gp, _ = W.rank_grads(state0, per_rank, draws0, wcfg, ud, ug)
        grad_rel, bar = worst(held(pg, gg), held(pp, gp)), KINK_GRAD_REL
    ring_same, update_ok, update_err = True, True, 0.0
    if ug:
        s2, ns2 = sched.exchange(VmapComm(2, 2), gg, pg["sync"],
                                 pg["epoch"][0])
        ring_same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves((s2, ns2)), tree_leaves((sg, ng["sync"]))))
        want = W.rank_apply(pg, sg, ns2, wcfg)
        pairs = list(zip(tree_leaves((ng["gen"], ng["gen_opt"])),
                         tree_leaves((want["gen"], want["gen_opt"]))))
        update_ok = all(torch.allclose(a.float(), b.float(), **UPDATE_TOL)
                        for a, b in pairs)
        update_err = max(float((a.float() - b.float()).abs().max())
                         for a, b in pairs)
    # the skipped halves: NaN losses, unchanged state, no forward at all
    frozen = ([] if ud else ["disc", "disc_opt"]) + \
        ([] if ug else ["gen", "gen_opt", "sync"])
    moved = [k for k in frozen if not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ng[k]), tree_leaves(state0[k])))]
    if not ug and not torch.equal(ng["epoch"], state0["epoch"] + 1):
        moved.append("epoch")
    skipped_ok = not moved and all(
        bool(m[k].isnan().all()) for m in (mg, mc) for k in ran
        if not ran[k])
    if not (ud or ug):
        skipped_ok = skipped_ok and not pre[str(dev)] and bool(
            mg["pred_params"].isnan().all())
    disc_err = max(float((a - b).abs().max()) for a, b in
                   zip(tree_leaves(ng["disc"]), tree_leaves(nc["disc"])))
    pinned = (f" at the card's Leaky ReLU signs ({flips} of the CPU's "
              f"differ; {unpinned:.3e} without pinning)"
              if pin_kinks and (ud or ug) else "")
    which = ("generator gradient leaf" if ug else
             "discriminator gradient leaf (its first Adam moment)" if ud
             else "gradient leaf (none: neither half ran)")
    if loss_rel > STEP_LOSS_RTOL or grad_rel > bar \
            or not ring_same or not update_ok or not skipped_ok:
        fail(f"phase {tag} {label}: losses off by {loss_rel:.3e} (rel), "
             f"worst {which} {grad_rel:.3e} in relative norm{pinned}, "
             f"the exchange bitwise the CPU's: {ring_same}, the generator's "
             f"update off the CPU's optimizer by {update_err:.3e} (bars "
             f"{STEP_LOSS_RTOL}, {bar}, {UPDATE_TOL}); halves "
             f"{FLAG_NAMES[flags]}: skipped state that moved {moved}, "
             f"the skipped losses NaN and nothing run where nothing is due: "
             f"{skipped_ok}")
    halves = ("" if flags == (True, True) else
              f"; {FLAG_NAMES[flags]} (the skipped half's loss NaN on both, "
              f"{', '.join(frozen)} unchanged on the card"
              f"{', the epoch counter advanced' if not ug else ''}"
              f"{'' if ud or ug else ', no Leaky ReLU run, NaN parameters'})")
    ring = ("; the CPU's exchange of the card's gradients bitwise the "
            f"card's; the card's new generator and Adam state against the "
            f"CPU's optimizer on the card's synced gradients: max |diff| "
            f"{update_err:.3e} ({UPDATE_TOL})" if ug else
            "; no exchange and no generator step")
    print(f"[{tag}] {label} one epoch card vs CPU (full width, K "
          f"{wcfg.n_param_samples}, E {wcfg.events_per_sample}, R 4 as 2 "
          f"x 2, h 1, fp32 compute with TF32 off, "
          f"{wcfg.sync.payload_precision} ring payload, the same state with "
          f"a non-zero "
          f"mailbox and the same draws): losses that ran within "
          f"{loss_rel:.2e} (rel, <= {STEP_LOSS_RTOL}), worst {which} "
          f"{grad_rel:.3e} in relative norm (<= {bar}){pinned}{ring}; the "
          f"new discriminator against the CPU's own step: max |diff| "
          f"{disc_err:.3e} (reported){halves}")


def profile_epochs(tag, label, dev, wcfg, data, group, seed):
    """Profile GAN_PROFILED epochs of `wcfg` at R 8 after one warm epoch
    (phases 24 and 28), reported by `report_profile` with the kernels
    grouped by `group(lower kernel name)`.  Returns (group -> us, busy
    us, host-clock us), or None when the profiler recorded no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.core import workflow as W

    R = GAN_OUTER * GAN_INNER
    epoch = W.make_epoch_fn(GAN_OUTER, GAN_INNER, wcfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    state, per_rank = W.init_run(g, R, wcfg, data, dev)
    draws = [W.make_draws(g, wcfg, R, per_rank.shape[1])
             for _ in range(GAN_PROFILED + 1)]
    state, _ = epoch(state, per_rank, draws[0], 0)   # warm, not profiled
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e, dr in enumerate(draws[1:], 1):
            state, _ = epoch(state, per_rank, dr, e)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = report_profile(tag, label, prof, wall_us, GAN_PROFILED, "epoch",
                         lambda low, op: group(low))
    return None if out is None else (*out, wall_us)




def profile_cadence(tag, label, dev, wcfg, data):
    """Phase 40: CADENCE_PROFILED epochs of `wcfg` at R 8 after one warm
    epoch under one profiler, each epoch in a range of its own with the
    card idle at its start and end: its halves (`workflow.due`), device
    ops, card time and GEMM launches and time, each kernel counted in
    the epoch whose range holds the op that launched it.  The profiler's
    first epoch is not reported: late in the whole script the profiler
    dropped device events at its start (an off epoch read 0.5 ms busy
    beside 9.6 in the next).  Fails unless
    an epoch without the discriminator launches fewer GEMMs than one
    with it (the card's evidence that the skipped half is not launched).
    Prints "not measured" when the profiler records no device events."""
    import torch
    from torch.profiler import (ProfilerActivity, profile as tprofile,
                                record_function)
    from repro_torch.core import workflow as W

    R = GAN_OUTER * GAN_INNER
    epoch = W.make_epoch_fn(GAN_OUTER, GAN_INNER, wcfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    state, per_rank = W.init_run(g, R, wcfg, data, dev)
    draws = [W.make_draws(g, wcfg, R, per_rank.shape[1])
             for _ in range(CADENCE_PROFILED + 2)]
    state, _ = epoch(state, per_rank, draws[0], 0)   # warm, not profiled
    wall = {}
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        state, _ = epoch(state, per_rank, draws[1], 1)   # not reported
        for e in range(2, CADENCE_PROFILED + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(f"cadence epoch {e}"):
                state, _ = epoch(state, per_rank, draws[e], e)
            torch.cuda.synchronize()
            wall[e] = (time.perf_counter() - t0) * 1e3
    kind = torch.autograd.DeviceType
    events = prof.events()
    spans = {int(ev.name.rsplit(" ", 1)[1]): ev.time_range for ev in events
             if ev.device_type == kind.CPU
             and ev.name.startswith("cadence epoch ")}
    kernels = {e: [] for e in spans}
    for ev in events:
        if ev.device_type == kind.CPU and ev.kernels:
            for e, span in spans.items():
                if span.start <= ev.time_range.start <= span.end:
                    kernels[e] += ev.kernels
    on_card = sum(ev.time_range.elapsed_us() for ev in events
                  if ev.device_type == kind.CUDA
                  and not ev.name.startswith("cadence epoch "))
    if not on_card:
        print(f"[{tag}] {label}: the profiler recorded no device events: "
              f"the due and off epochs' device ops are not measured")
        return None
    rows = {}
    for e, ks in kernels.items():
        gemms = [k for k in ks if gemm_kernel(k.name.lower())]
        rows[e] = (W.due(wcfg, e), len(ks), len(gemms),
                   sum(k.duration for k in ks) / 1e3,
                   sum(k.duration for k in gemms) / 1e3)
        print(f"[{tag}] {label} epoch {e} ({FLAG_NAMES[rows[e][0]]}): "
              f"{rows[e][1]} device ops, card busy {rows[e][3]:.3f} ms, "
              f"{rows[e][2]} GEMM launches taking {rows[e][4]:.3f} ms, "
              f"{wall[e]:.3f} ms on the host clock under the profiler")
    traced = sum(r[3] for r in rows.values()) * 1e3
    print(f"[{tag}] {label}: {100 * traced / on_card:.1f}% of the card's "
          f"time in the profile (the unreported first epoch's too) traced "
          f"to a reported epoch's launching ops")
    with_d = [r[2] for r in rows.values() if r[0][0]]
    without = [r[2] for r in rows.values() if not r[0][0]]
    if with_d and without and not max(without) < min(with_d):
        fail(f"[{tag}] {label}: an epoch without the discriminator launched "
             f"{max(without)} GEMMs, one with it {min(with_d)}: the skipped "
             f"half's GEMMs still run")
    return rows


def cadence_phases(dev, all_counts, fp32, imaging_blur_p50, proc_p50):
    """Phases 40-41: the update cadences (`disc_every`, `gen_every`) on
    the card.  40: `throughput(PAPER)` (bf16 payload, disc_every 2) in
    `rma_arar_arar` and PAPER at CADENCE in `conv_arar`, R 8, with phase
    22's bars read on the discriminator's epochs and `gan_expect`'s
    counts, the epoch p50 of each combination of halves and the mean
    beside phase 22's p50 (`fp32`: mode -> (p50 ms, ...)); imaging_blur
    at CADENCE with phase 26's bars beside its p50 (`imaging_blur_p50`);
    one epoch card vs CPU for each skipped combination; a profile of
    `throughput(PAPER)` epochs one at a time.  41: the proc runtime,
    PAPER at CADENCE bitwise `lockstep_reference`, `throughput(PAPER)`
    for GAN_EPOCHS lock-step epochs with phase 35's bars beside phase
    35's epoch p50 a rank (`proc_p50`; phase 43 runs these workers free,
    chunked, at depth 2).  Returns each kernel's launches over the counted
    runs."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import (PAPER, REDUCED, for_problem,
                                                throughput)
    from repro_torch.problems import get_problem

    D, G = CADENCE

    def cadenced(wcfg, **sync):
        return dataclasses.replace(
            wcfg, disc_every=D, gen_every=G,
            sync=dataclasses.replace(wcfg.sync, **sync))
    launches = {k: 0 for k in all_counts}
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    R, K, E = GAN_OUTER * GAN_INNER, PAPER.n_param_samples, \
        PAPER.events_per_sample
    t0 = time.perf_counter()

    # -- 40. stacked ----------------------------------------------------------
    # throughput(PAPER) cut to CUT_EPOCHS: phase 42 trains it (at depth 2,
    # chunked) for GAN_EPOCHS
    for label, wcfg, n in (
            ("throughput(PAPER)", throughput(PAPER), CUT_EPOCHS),
            (f"PAPER conv_arar at disc_every {D}, gen_every {G}",
             cadenced(PAPER, mode="conv_arar"), GAN_EPOCHS)):
        got, p50, final = train_and_check(
            "40", f"GAN {label}", dev, wcfg, data, all_counts,
            gan_expect(wcfg, n, all_counts), gan_healthy, n_epochs=n)
        add_launches(launches, got)
        p50_22 = fp32[wcfg.sync.mode][0]
        print(f"[40] GAN {label}: mean epoch {final['mean']:.3f} ms "
              f"({R * K * E / final['mean'] * 1e3:,.0f} events/s), "
              f"{final['mean'] / p50_22:.3f}x phase 22's every-epoch "
              f"{wcfg.sync.mode} p50 {p50_22:.3f} ms in the same run; "
              f"{flags_text(final['by_flags'])}")
    name = "imaging_blur"
    wcfg = cadenced(for_problem(name, PAPER))
    blur_data = get_problem(name).make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    got, _, final = train_and_check(          # phase 46 trains it for 200
        "40", f"{name} for_problem(PAPER) at disc_every {D}, gen_every {G}",
        dev, wcfg, blur_data, all_counts,
        gan_expect(wcfg, CUT_EPOCHS, all_counts), gan_improving,
        n_epochs=CUT_EPOCHS)
    add_launches(launches, got)
    print(f"[40] {name} at disc_every {D}, gen_every {G}: mean epoch "
          f"{final['mean']:.3f} ms beside phase 26's every-epoch p50 "
          f"{imaging_blur_p50:.3f} ms in the same run; "
          f"{flags_text(final['by_flags'])}")
    del blur_data
    small = cadenced(dataclasses.replace(
        PAPER, n_param_samples=REDUCED.n_param_samples,
        events_per_sample=REDUCED.events_per_sample), h=1)
    for flags in ((True, False), (False, True), (False, False)):
        epoch_card_vs_cpu("40", f"GAN rma_arar_arar {FLAG_NAMES[flags]}",
                          dev, small, pin_kinks=True, flags=flags)
    profile_cadence("40", "throughput(PAPER)", dev, throughput(PAPER), data)
    print(f"[40] phase {time.perf_counter() - t0:.1f} s")

    # -- 41. the proc runtime ------------------------------------------------
    t0 = time.perf_counter()
    counts, _ = proc_bitwise("41", dev, cadenced(PAPER, h=2), data,
                             all_counts)
    add_launches(launches, counts)
    counts, lock = proc_workflow("41", "lock-step", dev, throughput(PAPER),
                                 data, all_counts, fp32[PAPER.sync.mode][0])
    add_launches(launches, counts)
    print(f"[41] throughput(PAPER) as 8 workers, lock-step: epoch p50 a "
          f"rank {np.min(lock):.3f}-{np.max(lock):.3f} ms (median "
          f"{np.median(lock):.3f}) beside PAPER's every-epoch fp32 "
          f"{np.min(proc_p50):.3f}-{np.max(proc_p50):.3f} ms (phase 35, "
          f"same run); phase 41 {time.perf_counter() - t0:.1f} s")
    return launches


def depth_exchange(dev):
    """Phase 42's exchange on the card: DEPTH_EXCHANGE_EPOCHS epochs of
    `StaticSchedule.exchange` at staleness STALENESS_BITWISE, 2 x 4 ranks,
    h 2, at fp32 and bf16, whole and at RING_CHUNK, on gradients drawn on
    the card.  Fails unless the outputs and the SyncState are bitwise the
    same exchange run on the CPU from the card's gradients, and each
    epoch e reads the deposit of e - k: the slot e % k held before it is
    zero for e < k, else epoch e - k's gradient ring-shifted in the
    payload's dtype, and the synced gradient of every rank off the outer
    ring is its own plus that read.  Then the exchange alone, depth 1
    and depth k in turns (1, k, k, 1), EXCHANGE_CALLS calls back to back
    a turn, CUDA events around each turn."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.core import workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.sync import payload_dtype_of
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths

    t0 = time.perf_counter()
    R, k, n = GAN_OUTER * GAN_INNER, STALENESS_BITWISE, DEPTH_EXCHANGE_EPOCHS
    comm = VmapComm(GAN_OUTER, GAN_INNER)

    def wcfg_of(prec, chunk, depth):
        return dataclasses.replace(PAPER, sync=dataclasses.replace(
            PAPER.sync, h=2, staleness=depth, payload_precision=prec,
            ring_chunking=chunk))
    example = W.make_schedule(PAPER).spec.zeros(None, "cpu")
    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    grads = [tree_map(lambda t: torch.randn((R,) + tuple(t.shape),
                                            generator=g, device=dev),
                      example) for _ in range(n)]
    off_outer = [r for r in range(R) if r % GAN_INNER]   # inner index != 0

    def ring(x):                # the inner ring's shift of a [R, ...] leaf
        return x.reshape(GAN_OUTER, GAN_INNER, *x.shape[1:]).roll(
            1, 1).reshape(x.shape)
    for prec in ("fp32", "bf16"):
        wire = payload_dtype_of(prec)
        for chunk in (0, RING_CHUNK):
            sched = W.make_schedule(wcfg_of(prec, chunk, k))
            runs = []               # the card's, then the CPU's
            for d in (dev, torch.device("cpu")):
                st, outs = sched.init_state(R, d), []
                for e in range(n):
                    synced, new = sched.exchange(
                        comm, tree_map(lambda t: t.to(d), grads[e]), st,
                        torch.tensor(e, dtype=torch.int32, device=d))
                    outs.append(tree_map(lambda t: t.cpu(),
                                         (st["mailbox"], synced, new)))
                    st = new
                runs.append(outs)
            label = (f"[42] the exchange at staleness {k}, {prec} payload, "
                     f"ring_chunking {chunk:,} B")
            for e, (card, cpu) in enumerate(zip(*runs)):
                diff = [key for (key, a), b in zip(
                    tree_paths(card[1:]), tree_leaves(cpu[1:]))
                    if a.dtype != b.dtype or not torch.equal(a, b)]
                if diff:
                    fail(f"{label}, epoch {e}: the card's outputs or sync "
                         f"state differ from the CPU's exchange of the "
                         f"card's gradients in {diff[:6]}")
                before, synced, _ = card
                for i, (layer, gl, sl) in enumerate(zip(
                        before, grads[e], synced)):
                    read = layer["w"][:, e % k]
                    want = (torch.zeros_like(read) if e < k else
                            ring(grads[e - k][i]["w"].cpu()).to(wire))
                    mine = (gl["w"].cpu().to(wire) + read).float()
                    if not torch.equal(read, want) or not torch.equal(
                            sl["w"][off_outer], mine[off_outer]):
                        fail(f"{label}, epoch {e}, layer {i}: the read is "
                             f"not epoch {e - k}'s deposit (zeros before "
                             f"epoch {k}), or the synced gradient off the "
                             f"outer ring is not the rank's own plus it")
            print(f"{label}: {n} epochs on 2 x 4 ranks at h 2 bitwise the "
                  f"CPU's exchange of the card's gradients (outputs, the "
                  f"[{R}, {k}, ...] mailbox in {wire}, the outer mailbox); "
                  f"each epoch e read slot e % {k}: zeros before epoch {k}, "
                  f"then epoch e - {k}'s ring-shifted gradient; every rank "
                  f"off the outer ring's synced gradient its own plus that "
                  f"read")
    # the exchange alone, depth 1 and depth k in turns
    ms = {}
    epoch = torch.zeros((), dtype=torch.int32, device=dev)
    for depth in (1, k, k, 1):
        sched = W.make_schedule(wcfg_of("fp32", 0, depth))
        st = sched.init_state(R, dev)
        for _ in range(20):
            _, st = sched.exchange(comm, grads[0], st, epoch)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for i in range(EXCHANGE_CALLS):
            _, st = sched.exchange(comm, grads[i % n], st, epoch + i)
        b.record()
        b.synchronize()
        ms.setdefault(depth, []).append(a.elapsed_time(b) / EXCHANGE_CALLS)
    print(f"[42] the exchange alone, PAPER (2 x 4, fp32 payload, h 2), in "
          f"turns 1, {k}, {k}, 1 of {EXCHANGE_CALLS} calls back to back "
          f"(CUDA events): depth 1 {', '.join(f'{v:.4f}' for v in ms[1])} "
          f"ms a call, depth {k} {', '.join(f'{v:.4f}' for v in ms[k])} ms "
          f"a call; {time.perf_counter() - t0:.1f} s")
    return ms


def depth_phases(dev, all_counts, fp32, imaging_blur_p50, proc_p50):
    """Phases 42-43: the depth-k RMA mailbox (`staleness`) on the card.
    42: PAPER at STALENESS in `rma_arar_arar` (R 8, h 1000) with phase 22's
    bars and counts, its mailbox [8, k, ...], beside phase 22's p50
    (`fp32`: mode -> (p50 ms, ...)); `throughput(PAPER)` at STALENESS and
    RING_CHUNK (bf16, chunked, disc_every 2 and depth together) with
    phase 40's bars; imaging_blur at STALENESS with phase 26's bars
    beside its p50 (`imaging_blur_p50`); the exchange card vs CPU and
    timed (`depth_exchange`).  43: the proc runtime, PAPER at
    STALENESS_BITWISE h 2 bitwise `lockstep_reference`, and a free run of
    PROC_FREE_EPOCHS of 42's `throughput(PAPER)` at STALENESS and
    RING_CHUNK with phase 35's lag (finite) beside phase 35's epoch p50 a
    rank (`proc_p50`).  Returns each kernel's
    launches over the counted runs and the epoch p50 (ms) of PAPER at
    STALENESS."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER, for_problem, throughput
    from repro_torch.problems import get_problem
    from repro_torch.runtime import JitterConfig

    def deep(wcfg, k=STALENESS, **sync):
        return dataclasses.replace(wcfg, sync=dataclasses.replace(
            wcfg.sync, staleness=k, **sync))
    launches = {k: 0 for k in all_counts}
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    R, K, E = GAN_OUTER * GAN_INNER, PAPER.n_param_samples, \
        PAPER.events_per_sample
    t0 = time.perf_counter()

    # -- 42. stacked ----------------------------------------------------------
    p50s = []
    for label, wcfg, n in (
            (f"PAPER at staleness {STALENESS}", deep(PAPER), CUT_EPOCHS),
            (f"throughput(PAPER) at staleness {STALENESS}, ring_chunking "
             f"{RING_CHUNK:,} B", deep(throughput(PAPER),
                                      ring_chunking=RING_CHUNK), GAN_EPOCHS)):
        got, p50, final = train_and_check(
            "42", f"GAN {label}", dev, wcfg, data, all_counts,
            gan_expect(wcfg, n, all_counts), gan_healthy, n_epochs=n)
        add_launches(launches, got)
        p50s.append(p50)
        p50_22 = fp32[wcfg.sync.mode][0]
        print(f"[42] GAN {label}: epoch p50 {p50:.3f} ms, mean "
              f"{final['mean']:.3f} ms ({R * K * E / final['mean'] * 1e3:,.0f}"
              f" events/s), beside phase 22's depth-1 {wcfg.sync.mode} p50 "
              f"{p50_22:.3f} ms in the same run ({p50 / p50_22:.3f}x)")
    name = "imaging_blur"
    wcfg = deep(for_problem(name, PAPER))
    blur_data = get_problem(name).make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    got, p50, _ = train_and_check(            # phase 46 trains it for 200
        "42", f"{name} for_problem(PAPER) at staleness {STALENESS}", dev,
        wcfg, blur_data, all_counts,
        gan_expect(wcfg, CUT_EPOCHS, all_counts), gan_improving,
        n_epochs=CUT_EPOCHS)
    add_launches(launches, got)
    print(f"[42] {name} at staleness {STALENESS}: epoch p50 {p50:.3f} ms "
          f"beside phase 26's depth-1 p50 {imaging_blur_p50:.3f} ms in the "
          f"same run")
    del blur_data
    depth_exchange(dev)
    print(f"[42] phase {time.perf_counter() - t0:.1f} s")

    # -- 43. the proc runtime ------------------------------------------------
    t0 = time.perf_counter()
    counts, _ = proc_bitwise("43", dev, deep(PAPER, STALENESS_BITWISE, h=2),
                             data, all_counts)
    add_launches(launches, counts)
    # phase 42's throughput(PAPER) at depth 2 and 65,536 B: a free-running
    # read may meet one of the deposit's windows still empty
    counts, p50 = proc_workflow(
        "43", f"free-running, rank r sleeps r x {PROC_LAG_MS} ms an epoch",
        dev, deep(throughput(PAPER), ring_chunking=RING_CHUNK), data,
        all_counts, p50s[1], d_bar=lambda d: (True, "finite"),
        n_epochs=PROC_FREE_EPOCHS, lockstep=False,
        jitter=JitterConfig(seed=SEED, rank_lag_ms=PROC_LAG_MS))
    add_launches(launches, counts)
    print(f"[43] throughput(PAPER) at staleness {STALENESS}, ring_chunking "
          f"{RING_CHUNK:,} B as 8 free-running workers: epoch p50 a rank "
          f"{np.min(p50):.3f}-{np.max(p50):.3f} ms (median "
          f"{np.median(p50):.3f}) beside phase 35's PAPER lock-step depth-1 "
          f"{np.min(proc_p50):.3f}-{np.max(proc_p50):.3f} ms (same run); "
          f"phase 43 {time.perf_counter() - t0:.1f} s")
    return launches, p50s[0]


def obs_phases(dev, all_counts, fp32, depth_p50, proc_p50, proc_free_p50):
    """Phases 44-45: the telemetry (`ObsConfig`) on the card.  44, stacked:
    PAPER at STALENESS with metrics and a metrics file for CUT_EPOCHS in
    chunks of GAN_EVERY (phase 22's bars and counts; 1 header and a row a
    chunk, each row k_eff STALENESS and exchange_count its epoch), beside
    phase 22's p50 (`fp32`: mode -> (p50 ms, ...)) and phase 42's p50 of
    the same config without metrics (`depth_p50`); OBS_EPOCHS with
    metrics on and off from one seed, bitwise outside "obs"; OBS_EPOCHS at
    CADENCE, exchange_count the generator's epochs; imaging_blur with a
    metrics file (its payload_bytes, B1 and B3 counted); OBS_PROFILED
    epochs under `profile_dir`, the Chrome trace holding one device event
    of B1's kernel a launch after the profiler's first epoch.  45, as 8 workers with `trace_dir`: PAPER
    free-running PROC_FREE_EPOCHS with phase 35's lag and OBS_EPOCHS
    lock-step, each summary's obs entry, the 8 rank traces merged, and
    each rank's epoch broken down by span, beside phase 35's p50 a rank
    (`proc_free_p50`, `proc_p50`).  Returns each kernel's launches over
    the counted runs."""
    import dataclasses
    import glob
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.sagips_gan import PAPER, for_problem
    from repro_torch.core import workflow as W
    from repro_torch.core.tree import tree_paths
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.trace import (EPOCH_PARTS, epoch_breakdown,
                                       merge_traces, write_chrome_trace)
    from repro_torch.problems import get_problem
    from repro_torch.runtime import JitterConfig

    def metered(wcfg, k=1, **obs):
        return dataclasses.replace(wcfg, obs=ObsConfig(metrics=True, **obs),
                                   sync=dataclasses.replace(wcfg.sync,
                                                            staleness=k))

    def counted(label, wcfg, data, n, **kw):
        for cnt in all_counts.values():
            cnt.reset()                # --- the counted main-path run ---
        state, hist = W.train_stacked(SEED, wcfg, GAN_OUTER, GAN_INNER, n,
                                      data, device=dev, **kw)
        torch.cuda.synchronize()
        got = {k: (c.launches, c.plain_calls, c.backward_launches,
                   c.backward_plain) for k, c in all_counts.items()}
        # ------------------------------------------------------------------
        if got != gan_expect(wcfg, n, all_counts):
            fail(f"{label}: (launches, plain calls, backward launches, "
                 f"backward plain calls) {got}; expected "
                 f"{gan_expect(wcfg, n, all_counts)}")
        add_launches(launches, got)
        return state, hist

    launches = {k: 0 for k in all_counts}
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    R = GAN_OUTER * GAN_INNER
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    t0 = time.perf_counter()
    try:
        # -- 44. stacked ------------------------------------------------------
        out = os.path.join(tmp, "paper.jsonl")
        wcfg = metered(PAPER, STALENESS, metrics_out=out)
        label = f"GAN PAPER at staleness {STALENESS}, metrics on"
        got, p50, final = train_and_check(
            "44", label, dev, wcfg, data, all_counts,
            gan_expect(wcfg, CUT_EPOCHS, all_counts), gan_healthy,
            n_epochs=CUT_EPOCHS)
        add_launches(launches, got)
        header, rows = metrics_rows(out)
        want = {"schema": 1, "kind": "header", "problem": "proxy1d",
                "schedule": "sync", "payload_bytes": 203_264, "n_ranks": R,
                "n_epochs": CUT_EPOCHS}
        if header != want or [(r["epoch"], r["k_eff"], r["exchange_count"])
                              for r in rows] != [
                (e, STALENESS, e) for e in row_epochs(CUT_EPOCHS)]:
            fail(f"[44] {label}: the metrics file's header {header} (want "
                 f"{want}) or rows (epoch, k_eff, exchange_count) "
                 f"{[(r['epoch'], r['k_eff'], r['exchange_count']) for r in rows]}"
                 f" are not a row a chunk of {GAN_EVERY}, k_eff "
                 f"{STALENESS}, an exchange an epoch")
        p50_22 = fp32[PAPER.sync.mode][0]
        print(f"[44] {label}: the metrics file holds its header ({header}) "
              f"and {len(rows)} rows, one a chunk of {GAN_EVERY} epochs, "
              f"each k_eff {STALENESS} and exchange_count its epoch; epoch "
              f"p50 {p50:.3f} ms beside, in the same run, phase 42's "
              f"metrics-off p50 at staleness {STALENESS} {depth_p50:.3f} ms "
              f"({p50 / depth_p50:.3f}x) and phase 22's at depth 1 "
              f"{p50_22:.3f} ms ({p50 / p50_22:.3f}x)")

        on = metered(PAPER, STALENESS)
        states = {}
        for tag, w in (("on", on), ("off", dataclasses.replace(
                on, obs=ObsConfig()))):
            states[tag], _ = counted(f"[44] metrics {tag}", w, data,
                                     OBS_EPOCHS)
        on_leaves = dict(tree_paths(states["on"]))
        diff = [k for k, t in tree_paths(states["off"])
                if on_leaves[k].dtype != t.dtype
                or not torch.equal(on_leaves[k], t)]
        if diff or "obs" in states["off"] or \
                set(states["on"]) != set(states["off"]) | {"obs"}:
            fail(f"[44] PAPER at staleness {STALENESS}, {OBS_EPOCHS} "
                 f"epochs: metrics on differs from off outside 'obs' in "
                 f"{diff[:6]}, or the state keys are {sorted(states['on'])} "
                 f"and {sorted(states['off'])}")
        print(f"[44] PAPER at staleness {STALENESS}, {OBS_EPOCHS} epochs "
              f"from seed {SEED} with metrics on and off: every leaf outside "
              f"'obs' bitwise equal; the off run's state has no 'obs'")
        del states

        w = dataclasses.replace(metered(PAPER), disc_every=CADENCE[0],
                                gen_every=CADENCE[1])
        state, _ = counted(f"[44] metrics at {CADENCE}", w, data, OBS_EPOCHS)
        n_half, n_gen = W.due_counts(w, OBS_EPOCHS)
        got = state["obs"]["exchange_count"].tolist()
        if got != [n_gen] * R:
            fail(f"[44] PAPER at disc_every {CADENCE[0]}, gen_every "
                 f"{CADENCE[1]}: exchange_count {got}, the generator ran "
                 f"{n_gen} of {OBS_EPOCHS} epochs")
        print(f"[44] PAPER at disc_every {CADENCE[0]}, gen_every "
              f"{CADENCE[1]}, {OBS_EPOCHS} epochs: exchange_count {n_gen} on "
              f"every rank, the generator's epochs; B1 {n_half} launches "
              f"(backward {n_gen}) at `due_counts`")
        del state

        name = "imaging_blur"
        out = os.path.join(tmp, f"{name}.jsonl")
        w = metered(for_problem(name, PAPER), metrics_out=out)
        blur_data = get_problem(name).make_reference_data(
            torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
            device=dev)
        counted(f"[44] {name}", w, blur_data, OBS_EPOCHS,
                checkpoint_every=OBS_EPOCHS)
        header, rows = metrics_rows(out)
        if header["payload_bytes"] != 1_161_792 or header["problem"] != name \
                or [r["exchange_count"] for r in rows] != [OBS_EPOCHS]:
            fail(f"[44] {name}: the metrics file's header {header}, rows "
                 f"{rows}: want payload_bytes 1,161,792 and {OBS_EPOCHS} "
                 f"exchanges")
        print(f"[44] {name} for_problem(PAPER), {OBS_EPOCHS} epochs with "
              f"metrics: header payload_bytes {header['payload_bytes']:,} "
              f"(ProcComm's deposit), exchange_count {OBS_EPOCHS}; B1 and "
              f"B3 at `due_counts`")
        del blur_data

        # the profiler's first epoch is not held to the count: it drops
        # device events at its start (phase 40, and here epoch 0's B1
        # event in each whole run of this script so far).  Epoch 0 ends in a synchronize() and a
        # marker kernel on the stream, and every B1 launch after it must
        # have its device event after the marker's.  Both times are the
        # device's: a host op's time beside a kernel's is on another clock
        # (one run placed epoch 1's B1 event before a host marker).
        prof_dir = os.path.join(tmp, "profile")
        w = dataclasses.replace(PAPER, obs=ObsConfig(profile_dir=prof_dir))
        first = []

        def on_epoch(e, metrics):
            if e == 0:
                torch.cuda.synchronize()
                first.append(all_counts["inverse_cdf"].launches)
                torch.cuda._sleep(MARK_CYCLES)
        counted("[44] profile_dir", w, data, OBS_PROFILED, on_epoch=on_epoch)
        n = all_counts["inverse_cdf"].launches - first[0]
        with open(os.path.join(prof_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        t_mark = [e["ts"] for e in kernels
                  if "spin_kernel" in e.get("name", "")]
        b1 = [e["ts"] for e in kernels if "icdf_kernel" in e.get("name", "")]
        later = sum(ts > t_mark[0] for ts in b1) if t_mark else -1
        if not kernels:
            print(f"[44] profile_dir: the profiler recorded no device "
                  f"events; B1's device events: not measured")
        elif later != n or len(t_mark) != 1:
            fail(f"[44] profile_dir, {OBS_PROFILED} epochs: the Chrome "
                 f"trace holds {later} device events of icdf_kernel after "
                 f"epoch 0's marker kernel ({len(t_mark)} marker events), "
                 f"the wrapper counted {n} launches there")
        else:
            print(f"[44] profile_dir, {OBS_PROFILED} epochs of PAPER: "
                  f"trace.json holds {len(kernels)} device events; after "
                  f"epoch 0, {later} of B1's icdf_kernel, one a launch the "
                  f"wrapper counted ({n}); in epoch 0, {len(b1) - later} of "
                  f"{first[0]} (the profiler's first epoch)")
        print(f"[44] phase {time.perf_counter() - t0:.1f} s")

        # -- 45. as 8 worker processes with the tracer -------------------------
        t0 = time.perf_counter()
        for label, n, ref, kw in (
                (f"free-running, rank r sleeps r x {PROC_LAG_MS} ms an "
                 f"epoch", PROC_FREE_EPOCHS, proc_free_p50,
                 {"lockstep": False, "jitter": JitterConfig(
                     seed=SEED, rank_lag_ms=PROC_LAG_MS)}),
                ("lock-step", OBS_EPOCHS, proc_p50, {})):
            run_dir = os.path.join(tmp, f"proc_{n}")
            w = metered(PAPER, trace_dir="trace")
            counts, p50 = proc_workflow(
                "45", f"{label}, traced", dev, w, data, all_counts,
                fp32[PAPER.sync.mode][0], d_bar=lambda d: (True, "finite"),
                n_epochs=n, run_dir=run_dir, **kw)
            add_launches(launches, counts)
            summaries = []
            for r in range(R):
                with open(os.path.join(run_dir,
                                       f"summary_rank{r}.json")) as f:
                    summaries.append(json.load(f)["obs"])
            paths = sorted(glob.glob(os.path.join(run_dir, "trace",
                                                  "trace_rank*.jsonl")))
            bad = [s for s in summaries if s["exchange_count"] != n
                   or s["payload_bytes"] != 203_264]
            if bad or len(paths) != R:
                fail(f"[45] {label}: summaries' obs {bad[:2]} (want {n} "
                     f"exchanges of 203,264 B), {len(paths)} rank traces")
            merged = merge_traces(paths)
            write_chrome_trace(os.path.join(run_dir, "trace",
                                            "merged_trace.json"), merged)
            shares = epoch_breakdown(merged["traceEvents"])
            if sorted(shares) != list(range(R)) or any(
                    sh["epochs"] != n - 1 for sh in shares.values()):
                fail(f"[45] {label}: the merged trace's epochs by rank "
                     f"{ {r: sh['epochs'] for r, sh in shares.items()} }")
            print(f"[45] PAPER as 8 workers, {label}, {n} epochs, metrics "
                  f"and trace_dir: every summary's obs {n} exchanges of "
                  f"203,264 B; {len(paths)} rank traces merged into one "
                  f"Chrome trace ({len(merged['traceEvents']):,} events)")
            for r, sh in sorted(shares.items()):
                print(f"[45] {label}: rank {r}, epochs 1-{n - 1} (epoch 0 "
                      f"holds the worker's CUDA set-up): epoch span p50 "
                      f"{1e3 * sh['epoch_p50_s']:.3f} ms, mean "
                      f"{1e3 * sh['epoch_s'] / (n - 1):.3f} ms; "
                      + ", ".join(f"{k} {100 * sh[k]:.1f}%" for k in
                                  EPOCH_PARTS[:2] + ("exchange.wait",)
                                  + EPOCH_PARTS[2:] + ("other",))
                      + " (exchange.wait: the wait spans inside the "
                      "exchange)")
            print(f"[45] {label}, traced: epoch p50 a rank "
                  f"{np.min(p50):.3f}-{np.max(p50):.3f} ms (median "
                  f"{np.median(p50):.3f}) beside phase 35's untraced "
                  f"{np.min(ref):.3f}-{np.max(ref):.3f} ms (median "
                  f"{np.median(ref):.3f}; {np.median(p50) / np.median(ref):.3f}"
                  f"x): the tracer's torch.cuda.synchronize() after the "
                  f"gradients")
        print(f"[45] phase {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def overlap_exchange(dev):
    """Phase 46's exchange on the card: OVERLAP_EXCHANGE_EPOCHS epochs of
    `StaticSchedule.exchange` with overlap at h OVERLAP_BITWISE_H, depth
    STALENESS, 2 x 4 ranks, at fp32 whole and at RING_CHUNK and at bf16,
    on gradients drawn on the card: ships on the odd epochs, due combines
    on the even ones.  Fails unless the outputs and the SyncState are
    bitwise the same exchange run on the CPU from the card's gradients,
    the outer mailbox is unchanged on the other epochs and, on a ship
    epoch (no due combine then), the outer ring's shift of that epoch's
    synced payload."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.core import workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths

    t0 = time.perf_counter()
    R, n, h = GAN_OUTER * GAN_INNER, OVERLAP_EXCHANGE_EPOCHS, \
        OVERLAP_BITWISE_H
    comm = VmapComm(GAN_OUTER, GAN_INNER)
    example = W.make_schedule(PAPER).spec.zeros(None, "cpu")
    g = torch.Generator(device=dev).manual_seed(SEED + 46)
    grads = [tree_map(lambda t: torch.randn((R,) + tuple(t.shape),
                                            generator=g, device=dev),
                      example) for _ in range(n)]
    for prec, chunk in (("fp32", 0), ("fp32", RING_CHUNK), ("bf16", 0)):
        sched = W.make_schedule(dataclasses.replace(
            PAPER, sync=dataclasses.replace(
                PAPER.sync, h=h, staleness=STALENESS, overlap=True,
                payload_precision=prec, ring_chunking=chunk)))
        runs = []                   # the card's, then the CPU's
        for d in (dev, torch.device("cpu")):
            st, outs = sched.init_state(R, d), []
            for e in range(n):
                synced, new = sched.exchange(
                    comm, tree_map(lambda t: t.to(d), grads[e]), st,
                    torch.tensor(e, dtype=torch.int32, device=d))
                outs.append(tree_map(lambda t: t.cpu(), (
                    st["outer_mailbox"], synced, new)))
                st = new
            runs.append(outs)
        label = (f"[46] the exchange with overlap at h {h}, staleness "
                 f"{STALENESS}, {prec} payload, ring_chunking {chunk:,} B")
        for e, (card, cpu) in enumerate(zip(*runs)):
            diff = [key for (key, a), b in zip(
                tree_paths(card[1:]), tree_leaves(cpu[1:]))
                if a.dtype != b.dtype or not torch.equal(a, b)]
            if diff:
                fail(f"{label}, epoch {e}: the card's outputs or sync state "
                     f"differ from the CPU's exchange of the card's "
                     f"gradients in {diff[:6]}")
            before, synced, new = card
            after = new["outer_mailbox"]
            flat = sched.spec.flatten(synced, True)
            shipped = flat.reshape(GAN_OUTER, GAN_INNER, -1).roll(
                1, 0).reshape(flat.shape)
            ship = (e + 1) % h == 0
            if not torch.equal(after, shipped if ship else before):
                fail(f"{label}, epoch {e}: the outer mailbox is not "
                     f"{'the outer shift of the synced payload (a ship)' if ship else 'the one before (no ship)'}")
        print(f"{label}: {n} epochs on 2 x 4 ranks bitwise the CPU's "
              f"exchange of the card's gradients (outputs, the mailbox, the "
              f"[{R}, {sched.spec.total:,}] outer mailbox in "
              f"{sched.spec.payload_dtype}); the outer mailbox rewritten on "
              f"the ship epochs 1, 3, 5 only, each time by the outer ring's "
              f"shift of that epoch's synced payload")
    print(f"[46] the exchange card vs CPU: {time.perf_counter() - t0:.1f} s")


def overlap_phases(dev, all_counts, fp32, imaging_blur_p50, proc_p50):
    """Phases 46-47: the overlapped pod boundary (`overlap`) on the card.
    46, stacked: PAPER with overlap at OVERLAP_H in `arar_arar` and
    `rma_arar_arar` for CUT_EPOCHS with metrics and a metrics file (phase
    22's bars and
    counts; the header's schedule, the rows' and the final ship and
    exchange counts), beside phase 22's p50 (`fp32`: mode -> (p50 ms,
    ...)); imaging_blur with overlap at OVERLAP_H and IMAGE_RING_CHUNK
    (phase 26's bars and counts) beside phase 26's p50
    (`imaging_blur_p50`); the exchange card vs CPU (`overlap_exchange`);
    PAPER under sync and overlap at OVERLAP_H in turns
    (`scripts/payload_ab.py --lane overlap`).  47, 8 workers: PAPER with
    overlap at OVERLAP_BITWISE_H bitwise `lockstep_reference` with one
    ship deposit a ship epoch; PROC_FREE_EPOCHS free-running with phase
    35's lag, traced, at OVERLAP_H under sync and overlap (finite): the
    ship and outer-ring spans by epoch, span shares and p50 side by side
    beside phase 35's p50 a rank (`proc_p50`).  Returns each kernel's
    launches over the counted runs."""
    import dataclasses
    import glob
    import importlib.util
    import io
    import tempfile
    import shutil
    import torch
    from repro_torch.configs.sagips_gan import PAPER, for_problem
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.trace import (EPOCH_PARTS, epoch_breakdown,
                                       load_events, merge_traces)
    from repro_torch.problems import get_problem
    from repro_torch.runtime import JitterConfig

    def overlapped(wcfg, h=OVERLAP_H, on=True, **sync):
        return dataclasses.replace(wcfg, sync=dataclasses.replace(
            wcfg.sync, h=h, overlap=on, **sync))

    launches = {k: 0 for k in all_counts}
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    R, n, h = GAN_OUTER * GAN_INNER, GAN_EPOCHS, OVERLAP_H
    tmp = tempfile.mkdtemp(prefix="chip_smoke_overlap_")
    t0 = time.perf_counter()
    try:
        # -- 46. stacked ------------------------------------------------------
        # both modes cut to CUT_EPOCHS: phase 48 trains the overlap at h
        # 10 (with the adaptive schedule) for GAN_EPOCHS
        for mode, m in (("arar_arar", CUT_EPOCHS),
                        ("rma_arar_arar", CUT_EPOCHS)):
            out = os.path.join(tmp, f"{mode}.jsonl")
            ships = [e for e in range(m) if (e + 1) % h == 0]
            wcfg = dataclasses.replace(
                overlapped(PAPER, mode=mode),
                obs=ObsConfig(metrics=True, metrics_out=out))
            label = (f"GAN PAPER {mode} with overlap at h {h}, metrics on, "
                     f"{m} epochs")
            got, p50, final = train_and_check(
                "46", label, dev, wcfg, data, all_counts,
                gan_expect(wcfg, m, all_counts), gan_healthy, n_epochs=m)
            add_launches(launches, got)
            header, rows = metrics_rows(out)
            want = {"schema": 1, "kind": "header", "problem": "proxy1d",
                    "schedule": "overlap", "payload_bytes": 203_264,
                    "n_ranks": R, "n_epochs": m}
            got_rows = [(r["epoch"], r["ship_count"], r["exchange_count"])
                        for r in rows]
            want_rows = [(e, e // h, e) for e in row_epochs(m)]
            obs = final["obs"]
            if header != want or got_rows != want_rows or \
                    obs["ship_count"].tolist() != [len(ships)] * R or \
                    obs["exchange_count"].tolist() != [m] * R:
                fail(f"[46] {label}: the metrics file's header {header} "
                     f"(want {want}), its rows (epoch, ship_count, "
                     f"exchange_count) {got_rows} (want {want_rows}), or "
                     f"the final ship_count {obs['ship_count'].tolist()} "
                     f"and exchange_count {obs['exchange_count'].tolist()}"
                     f" (want {len(ships)} and {m} on every rank)")
            p50_22 = fp32.get(mode, (float("nan"),))[0]
            print(f"[46] {label}: header schedule 'overlap', "
                  f"{len(rows)} rows, each ship_count its epoch / {h}; "
                  f"ship_count {len(ships)} (epochs {ships[0]}, "
                  f"{ships[1]}, ..., {ships[-1]}) and exchange_count {m} "
                  f"on every rank; epoch p50 {p50:.3f} ms beside phase "
                  f"22's sync p50 at h 1000 in {mode} {p50_22:.3f} ms "
                  f"(same run; nan where phase 22 trains no {mode})")
        name = "imaging_blur"
        wcfg = overlapped(for_problem(name, PAPER),
                          ring_chunking=IMAGE_RING_CHUNK)
        blur_data = get_problem(name).make_reference_data(
            torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
            device=dev)
        got, p50, _ = train_and_check(
            "46", f"{name} for_problem(PAPER) with overlap at h {h}, "
            f"ring_chunking {IMAGE_RING_CHUNK:,} B", dev, wcfg, blur_data,
            all_counts, gan_expect(wcfg, n, all_counts), gan_improving)
        add_launches(launches, got)
        print(f"[46] {name} with overlap at h {h}, {IMAGE_RING_CHUNK:,} B "
              f"segments: epoch p50 {p50:.3f} ms beside phase 26's sync "
              f"p50 at h 1000, whole, {imaging_blur_p50:.3f} ms (same run)")
        del blur_data
        overlap_exchange(dev)
        spec = importlib.util.spec_from_file_location(
            "payload_ab", os.path.join(ROOT, "scripts", "payload_ab.py"))
        payload_ab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(payload_ab)
        argv = ["--lane", "overlap", "--h", str(h), "--epochs",
                str(OVERLAP_AB_EPOCHS), "--device", dev.type]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            p50s, ex_ms = payload_ab.run(argv)
        for line in buf.getvalue().splitlines():
            print(f"[46] payload_ab {' '.join(argv)}: {line}")
        ratio = statistics.median(p50s["overlap"]) / statistics.median(
            p50s["sync"])
        print(f"[46] PAPER rma_arar_arar at h {h}, in turns sync, overlap, "
              f"overlap, sync: epoch p50 sync "
              + ", ".join(f"{v:.3f}" for v in p50s["sync"]) + " ms, overlap "
              + ", ".join(f"{v:.3f}" for v in p50s["overlap"])
              + f" ms (overlap / sync {ratio:.3f}x); the exchange alone "
              f"{ex_ms['sync']:.4f} / {ex_ms['overlap']:.4f} ms a call")
        print(f"[46] phase {time.perf_counter() - t0:.1f} s")

        # -- 47. as 8 worker processes -------------------------------------------
        t0 = time.perf_counter()
        counts, _ = proc_bitwise("47", dev, overlapped(
            PAPER, h=OVERLAP_BITWISE_H), data, all_counts)
        add_launches(launches, counts)
        # traced free runs with phase 35's lag, sync then overlap at h 10:
        # the overlap run is also the free run that must end finite
        n = PROC_FREE_EPOCHS
        want_ships = [e for e in range(n) if (e + 1) % h == 0]
        shares, p50 = {}, {}
        for sched in ("sync", "overlap"):
            run_dir = os.path.join(tmp, f"proc_{sched}")
            w = dataclasses.replace(
                overlapped(PAPER, on=sched == "overlap"),
                obs=ObsConfig(metrics=True, trace_dir="trace"))
            counts, p50[sched] = proc_workflow(
                "47", f"free-running, rank r sleeps r x {PROC_LAG_MS} ms an "
                f"epoch, traced, {sched} at h {h}", dev, w, data,
                all_counts, fp32[PAPER.sync.mode][0],
                d_bar=lambda d: (True, "finite"), n_epochs=n,
                run_dir=run_dir, lockstep=False, jitter=JitterConfig(
                    seed=SEED, rank_lag_ms=PROC_LAG_MS))
            add_launches(launches, counts)
            paths = sorted(glob.glob(os.path.join(run_dir, "trace",
                                                  "trace_rank*.jsonl")))
            shares[sched] = epoch_breakdown(
                merge_traces(paths)["traceEvents"])
            want = ({"exchange.ship": want_ships, "exchange.outer": []}
                    if sched == "overlap" else
                    {"exchange.ship": [], "exchange.outer": list(range(n))})
            for r, path in enumerate(paths):
                evs = [e for e in load_events(path)[0] if e.get("ph") == "X"]
                by = {k: sorted(e["args"]["epoch"] for e in evs
                                if e["name"] == k) for k in want}
                if by != want or sorted(shares[sched]) != list(range(R)):
                    fail(f"[47] {sched}: rank {r}'s trace has ship spans at "
                         f"epochs {by['exchange.ship']} and outer-ring "
                         f"spans at {by['exchange.outer']}; want {want}")
            summaries = []
            for r in range(R):
                with open(os.path.join(run_dir,
                                       f"summary_rank{r}.json")) as f:
                    summaries.append(json.load(f)["obs"])
            ships = len(want_ships) if sched == "overlap" else 0
            bad = [s for s in summaries if s["ship_count"] != ships
                   or s["exchange_count"] != n]
            if bad:
                fail(f"[47] {sched}: summaries' obs {bad[:2]}, want "
                     f"{ships} ships and {n} exchanges")
            print(f"[47] {sched} at h {h}, traced: every rank's trace holds "
                  + (f"an `exchange.ship` span on epochs {want_ships} only "
                     f"and no `exchange.outer`"
                     if sched == "overlap" else
                     f"an `exchange.outer` span on each of the {n} epochs "
                     f"and no `exchange.ship`")
                  + f"; every summary's obs {ships} ships, {n} exchanges")
        parts = EPOCH_PARTS[:2] + ("exchange.wait",) + EPOCH_PARTS[2:] + (
            "other",)
        for r in range(R):
            a, b = shares["sync"][r], shares["overlap"][r]
            print(f"[47] rank {r}, epochs 1-{n - 1}, sync | overlap at h "
                  f"{h}: epoch span p50 {1e3 * a['epoch_p50_s']:.3f} | "
                  f"{1e3 * b['epoch_p50_s']:.3f} ms; "
                  + ", ".join(f"{k} {100 * a[k]:.1f}% | {100 * b[k]:.1f}%"
                              for k in parts))
        med = {k: float(np.median([100 * sh["exchange"] for sh in
                                   shares[k].values()])) for k in shares}
        print(f"[47] free-running, traced, at h {h}: epoch p50 a rank sync "
              f"{np.min(p50['sync']):.3f}-{np.max(p50['sync']):.3f} ms "
              f"(median {np.median(p50['sync']):.3f}), overlap "
              f"{np.min(p50['overlap']):.3f}-{np.max(p50['overlap']):.3f} ms"
              f" (median {np.median(p50['overlap']):.3f}; every state leaf "
              f"finite); the exchange's share, median over ranks, sync "
              f"{med['sync']:.1f}%, overlap {med['overlap']:.1f}%; phase "
              f"35's untraced lock-step p50 a rank "
              f"{np.min(proc_p50):.3f}-{np.max(proc_p50):.3f} ms; phase "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def adaptive_exchange(dev):
    """Phase 48's exchange on the card: ADAPTIVE_EXCHANGE_EPOCHS epochs of
    `AdaptiveSchedule.exchange_with_obs` at k_max ADAPTIVE_K with overlap
    at h OVERLAP_BITWISE_H, 2 x 4 ranks, at fp32 and bf16, whole and at
    RING_CHUNK, on gradients drawn on the card, with skew driven in: the
    tags of every written slot set ADAPTIVE_DRIVE[e] epochs old on the
    card (and on the CPU) before epoch e.  Fails unless the outputs, the
    SyncState (payload, tags, controller, outer mailbox) and the obs rows
    are bitwise the same exchange run on the CPU from the card's
    gradients, k_eff widens to k_max and narrows back to 1, and the
    stretched ship gate ships once in each cycle of h."""
    import dataclasses
    import torch
    from repro_torch.configs.sagips_gan import PAPER
    from repro_torch.core import workflow as W
    from repro_torch.core.ring import VmapComm
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths

    t0 = time.perf_counter()
    R, n, h, k = GAN_OUTER * GAN_INNER, ADAPTIVE_EXCHANGE_EPOCHS, \
        OVERLAP_BITWISE_H, ADAPTIVE_K
    comm = VmapComm(GAN_OUTER, GAN_INNER)
    example = W.make_schedule(PAPER).spec.zeros(None, "cpu")
    g = torch.Generator(device=dev).manual_seed(SEED + 48)
    grads = [tree_map(lambda t: torch.randn((R,) + tuple(t.shape),
                                            generator=g, device=dev),
                      example) for _ in range(n)]
    for prec in ("fp32", "bf16"):
        for chunk in (0, RING_CHUNK):
            sched = W.make_schedule(dataclasses.replace(
                PAPER, sync=dataclasses.replace(
                    PAPER.sync, h=h, staleness=k, adaptive=True,
                    overlap=True, payload_precision=prec,
                    ring_chunking=chunk)))
            runs = []               # the card's, then the CPU's
            for d in (dev, torch.device("cpu")):
                st, outs = sched.init_state(R, d), []
                for e in range(n):
                    if e in ADAPTIVE_DRIVE:
                        tags = st["mailbox"]["tag"]
                        st["mailbox"]["tag"] = torch.where(
                            tags >= 0, tags - ADAPTIVE_DRIVE[e], tags)
                    synced, st, row = sched.exchange_with_obs(
                        comm, tree_map(lambda t: t.to(d), grads[e]), st,
                        torch.tensor(e, dtype=torch.int32, device=d))
                    outs.append(tree_map(lambda t: t.cpu(),
                                         (synced, st, row)))
                runs.append(outs)
            label = (f"[48] the adaptive exchange at k_max {k}, overlap at "
                     f"h {h}, {prec} payload, ring_chunking {chunk:,} B, "
                     f"skew driven in")
            for e, (card, cpu) in enumerate(zip(*runs)):
                diff = [key for (key, a), b in zip(
                    tree_paths(card), tree_leaves(cpu))
                    if a.dtype != b.dtype or not torch.equal(a, b)]
                if diff:
                    fail(f"{label}, epoch {e}: the card's outputs, sync "
                         f"state or obs row differ from the CPU's exchange "
                         f"of the card's gradients in {diff[:6]}")
            rows = [c[2] for c in runs[0]]
            ks = [int(r["k_eff"][0]) for r in rows]
            ships = [int(r["shipped"][0]) for r in rows]
            cycles = [sum(ships[c:c + h]) for c in range(0, n, h)]
            early = [e for e in range(n) if ships[e] and (e + 1) % h]
            if max(ks) != k or ks[-1] != 1 or cycles != [1] * (n // h) \
                    or not early:
                fail(f"{label}: k_eff by epoch {ks} (want it to widen to "
                     f"{k} and narrow back to 1), ships by epoch {ships} "
                     f"(want one a cycle of {h}, some opened early by the "
                     f"stretched gate)")
            ema = [round(float(r["skew_ema"][0]), 3) for r in rows]
            print(f"{label} ({ADAPTIVE_DRIVE}: epoch -> epochs older): {n} "
                  f"epochs on 2 x 4 ranks bitwise the CPU's exchange of the "
                  f"card's gradients (outputs, the [{R}, {k}, "
                  f"{sched.spec.total:,}] payload in "
                  f"{sched.spec.payload_dtype}, the int32 tags, the "
                  f"controller, the outer mailbox, the obs rows); k_eff by "
                  f"epoch {ks}, skew EMA {ema}; ships at epochs "
                  f"{[e for e in range(n) if ships[e]]}, one a cycle of "
                  f"{h}, {early} opened {h - 1} epoch(s) before the "
                  f"static gate")
    print(f"[48] the adaptive exchange card vs CPU: "
          f"{time.perf_counter() - t0:.1f} s")


def adaptive_phases(dev, all_counts, fp32, imaging_blur_p50):
    """Phases 48-49: adaptive staleness (`adaptive`) on the card.  48,
    stacked: PAPER adaptive at ADAPTIVE_K in `rma_arar_arar` (h 1000)
    with metrics, phase 22's bars and counts, every epoch's obs row k_eff
    1, skew 0 and deposit age 0, and the final state bitwise phase 22's
    static run (`fp32`: mode -> (p50 ms, gen, residual, state)); PAPER
    `adaptive-overlap` at ADAPTIVE_K and OVERLAP_H with phase 22's bars,
    ship_count GAN_EPOCHS / OVERLAP_H on every rank; imaging_blur adaptive
    at ADAPTIVE_K and IMAGE_RING_CHUNK for CUT_EPOCHS with phase 26's
    bars and counts beside phase 26's p50 (`imaging_blur_p50`); the
    exchange card vs CPU under driven skew (`adaptive_exchange`); static
    depth 1 and adaptive in turns (`scripts/payload_ab.py --lane
    adaptive`).  49, 8 workers: `adaptive-overlap` at ADAPTIVE_K, h
    OVERLAP_BITWISE_H, bitwise `lockstep_reference` with skew 0 and k_eff
    1 on every rank; PROC_FREE_EPOCHS of 48's imaging_blur free-running
    at ADAPTIVE_FREE_K and IMAGE_RING_CHUNK, rank r ADAPTIVE_LAG_MS x r
    late an epoch: finite, skew measured and k_eff widened, beside 48's
    stacked p50.  Returns
    each kernel's launches over the counted runs."""
    import dataclasses
    import importlib.util
    import io
    import torch
    from repro_torch.configs.sagips_gan import PAPER, for_problem
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths
    from repro_torch.obs import ObsConfig
    from repro_torch.problems import get_problem
    from repro_torch.runtime import JitterConfig

    def adaptive(wcfg, k=ADAPTIVE_K, metrics=False, **sync):
        out = dataclasses.replace(wcfg, sync=dataclasses.replace(
            wcfg.sync, staleness=k, adaptive=True, **sync))
        return dataclasses.replace(out, obs=ObsConfig(metrics=True)) \
            if metrics else out

    launches = {k: 0 for k in all_counts}
    data = get_problem("proxy1d").make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    R, n = GAN_OUTER * GAN_INNER, GAN_EPOCHS
    t0 = time.perf_counter()

    # -- 48. stacked ----------------------------------------------------------
    # (a) PAPER adaptive, h 1000: zero skew, so bitwise phase 22's depth 1
    wcfg = adaptive(PAPER, metrics=True)
    off = []                    # an epoch whose row is not (1, 0, 0), on device

    def watch(e, metrics):
        o = metrics["obs"]
        off.append((o["k_eff"] != 1).any() | (o["skew_ema"] != 0).any()
                   | (o["deposit_age"] != 0).any())
    label = f"GAN PAPER adaptive at k_max {ADAPTIVE_K}, metrics on"
    got, p50, final = train_and_check(
        "48", label, dev, wcfg, data, all_counts,
        gan_expect(wcfg, n, all_counts), gan_healthy, watch=watch)
    add_launches(launches, got)
    bad_epochs = torch.nonzero(torch.stack(off)).flatten().tolist()
    if bad_epochs or final["obs"]["exchange_count"].tolist() != [n] * R:
        fail(f"[48] {label}: epochs {bad_epochs[:8]} have an obs row with "
             f"k_eff != 1, skew != 0 or deposit age != 0, or the final "
             f"exchange_count is {final['obs']['exchange_count'].tolist()} "
             f"(want {n} on every rank)")
    p50_22, _, _, state_22 = fp32[PAPER.sync.mode]

    def differs(a, b):
        return [k for (k, x), y in zip(tree_paths(a), tree_leaves(b))
                if x.dtype != y.dtype or not torch.equal(x, y)]
    diff = differs(final["state"], state_22)
    if diff:
        # is it the adaptive schedule, or does the card not repeat even
        # phase 22's static run from the same seed?
        from repro_torch.core import workflow as W
        again, _ = W.train_stacked(SEED, PAPER, GAN_OUTER, GAN_INNER, n,
                                   data, checkpoint_every=GAN_EVERY,
                                   device=dev)
        again = {k: v for k, v in again.items() if k != "sync"}
        repeat = differs(tree_map(lambda t: t.cpu(), again), state_22)
        fail(f"[48] {label}: the final state differs from phase 22's static "
             f"rma_arar_arar run from the same seed in {diff[:6]}; phase "
             f"22's static run again from that seed "
             + (f"differs from phase 22's in {repeat[:6]}: the card does "
                f"not repeat phase 22's run bitwise" if repeat else
                "is bitwise phase 22's: the adaptive run is not"))
    print(f"[48] {label}: every one of the {n} epochs' obs rows reads k_eff "
          f"1, skew EMA 0, deposit age 0 (every rank deposits at the same "
          f"epoch); the final state (gen, gen_opt, disc, disc_opt, epoch) "
          f"bitwise phase 22's static depth-1 rma_arar_arar run from seed "
          f"{SEED}; epoch p50 {p50:.3f} ms beside phase 22's {p50_22:.3f} "
          f"ms in the same run ({p50 / p50_22:.3f}x)")
    # (b) adaptive-overlap at h 10: phase 22's bars, a ship a cycle
    h = OVERLAP_H
    wcfg = adaptive(PAPER, metrics=True, overlap=True, h=h)
    label = (f"GAN PAPER adaptive-overlap at k_max {ADAPTIVE_K}, h {h}, "
             f"metrics on")
    got, p50, final = train_and_check(
        "48", label, dev, wcfg, data, all_counts,
        gan_expect(wcfg, n, all_counts), gan_healthy)
    add_launches(launches, got)
    obs = final["obs"]
    if obs["ship_count"].tolist() != [n // h] * R or \
            obs["k_eff"].tolist() != [1] * R:
        fail(f"[48] {label}: final ship_count {obs['ship_count'].tolist()}"
             f" and k_eff {obs['k_eff'].tolist()}, want {n // h} and 1 on "
             f"every rank")
    print(f"[48] {label}: ship_count {n // h} and k_eff 1 on every rank; "
          f"epoch p50 {p50:.3f} ms beside phase 22's {p50_22:.3f} ms")
    # (c) imaging_blur adaptive, chunked
    name = "imaging_blur"
    wcfg = adaptive(for_problem(name, PAPER), ring_chunking=IMAGE_RING_CHUNK)
    blur_data = get_problem(name).make_reference_data(
        torch.Generator(device=dev).manual_seed(99), GAN_REF_EVENTS,
        device=dev)
    got, blur_p50, _ = train_and_check(
        "48", f"{name} for_problem(PAPER) adaptive at k_max {ADAPTIVE_K}, "
        f"ring_chunking {IMAGE_RING_CHUNK:,} B", dev, wcfg, blur_data,
        all_counts, gan_expect(wcfg, CUT_EPOCHS, all_counts), gan_improving,
        n_epochs=CUT_EPOCHS)
    add_launches(launches, got)
    print(f"[48] {name} adaptive, {IMAGE_RING_CHUNK:,} B segments: epoch "
          f"p50 {blur_p50:.3f} ms beside phase 26's static whole p50 "
          f"{imaging_blur_p50:.3f} ms (same run)")
    # (d) the exchange alone, card vs CPU, skew driven in
    adaptive_exchange(dev)
    # (e) static depth 1 against adaptive, in turns
    spec = importlib.util.spec_from_file_location(
        "payload_ab", os.path.join(ROOT, "scripts", "payload_ab.py"))
    payload_ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(payload_ab)
    argv = ["--lane", "adaptive", "--staleness", str(ADAPTIVE_K),
            "--epochs", str(OVERLAP_AB_EPOCHS), "--device", dev.type]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p50s, ex_ms = payload_ab.run(argv)
    for line in buf.getvalue().splitlines():
        print(f"[48] payload_ab {' '.join(argv)}: {line}")
    ratio = statistics.median(p50s["adaptive"]) / statistics.median(
        p50s["static"])
    print(f"[48] PAPER rma_arar_arar, in turns static depth 1, adaptive at "
          f"k_max {ADAPTIVE_K}, adaptive, static: epoch p50 static "
          + ", ".join(f"{v:.3f}" for v in p50s["static"]) + " ms, adaptive "
          + ", ".join(f"{v:.3f}" for v in p50s["adaptive"])
          + f" ms (adaptive / static {ratio:.3f}x); the exchange alone "
          f"{ex_ms['static']:.4f} / {ex_ms['adaptive']:.4f} ms a call "
          f"(+{ex_ms['adaptive'] - ex_ms['static']:.4f} ms)")
    print(f"[48] phase {time.perf_counter() - t0:.1f} s")

    # -- 49. as 8 worker processes -------------------------------------------
    t0 = time.perf_counter()
    counts, _ = proc_bitwise("49", dev, adaptive(
        PAPER, overlap=True, h=OVERLAP_BITWISE_H), data, all_counts)
    add_launches(launches, counts)
    k_free, lag = ADAPTIVE_FREE_K, ADAPTIVE_LAG_MS
    seen = {}

    def inspect(out):
        seen["skew"] = [s["max_skew_ema"] for s in out["summaries"]]
        seen["k"] = [s["max_k_eff"] for s in out["summaries"]]
        seen["hist"] = out["history"]["k_eff"]
    # 48's imaging_blur at 524,288 B: B3 and its backward in free-running
    # workers, and reads across 3 windows a deposit
    counts, p50 = proc_workflow(
        "49", f"free-running adaptive at k_max {k_free}, rank r sleeps r x "
        f"{lag} ms an epoch", dev,
        adaptive(for_problem(name, PAPER), k=k_free,
                 ring_chunking=IMAGE_RING_CHUNK), blur_data, all_counts,
        blur_p50, d_bar=lambda d: (True, "finite"),
        n_epochs=PROC_FREE_EPOCHS, inspect=inspect, lockstep=False,
        jitter=JitterConfig(seed=SEED, rank_lag_ms=lag))
    add_launches(launches, counts)
    del blur_data
    ks = seen["hist"]
    if not (max(seen["skew"]) > 0 and max(seen["k"]) > 1
            and float(ks.min()) >= 1 and float(ks.max()) <= k_free):
        fail(f"[49] free-running adaptive, rank r {lag} ms x r late: "
             f"max_skew_ema by rank {seen['skew']}, max_k_eff by rank "
             f"{seen['k']}, k_eff in [{float(ks.min())}, {float(ks.max())}]"
             f"; want some rank's skew > 0 and k_eff > 1, every k_eff in "
             f"[1, {k_free}]")
    first = [int(np.argmax(ks[:, r].numpy() > 1)) if bool((ks[:, r] > 1)
             .any()) else None for r in range(R)]
    print(f"[49] {name} free-running adaptive at k_max {k_free}, "
          f"{IMAGE_RING_CHUNK:,} B segments, rank r {lag} ms x r late, "
          f"{PROC_FREE_EPOCHS} epochs: max_skew_ema by rank "
          + ", ".join(f"{v:.3f}" for v in seen["skew"])
          + f"; max_k_eff by rank {seen['k']} (first epoch above 1 by rank "
          f"{first}); every k_eff in [1, {k_free}]; epoch p50 a rank "
          f"{np.min(p50):.3f}-{np.max(p50):.3f} ms (median "
          f"{np.median(p50):.3f}) beside phase 48's stacked {blur_p50:.3f} "
          f"ms; phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches


def hubert_phases(dev, all_counts):
    """Phases 50-52: B4 at hubert-xlarge's shapes (non-causal, head dim
    80, G 1) against its plain version and timed; hubert-xlarge's encode
    pass at full size, and at full width and depth 2 on the card against
    the CPU; hubert-xlarge trained at full size.  Returns (B4's launches
    over the counted runs of phases 51 and 52, the largest |kernel -
    plain| of phase 50's calls)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import model as M
    from repro_torch.training import trainer as T

    cfg = get_config(AUDIO_ARCH)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    if hd != 80 or cfg.num_kv_heads != H or cfg.causal:
        fail(f"{AUDIO_ARCH}: {H} heads over {cfg.num_kv_heads}, head dim "
             f"{hd}, causal {cfg.causal}; expected G 1, hd 80, non-causal")

    # -- 50. B4 at hubert's shapes, bf16, non-causal -------------------------
    t_phase = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(SEED + 50)
    worst, inputs = 0.0, {}
    for what, (b, s) in (("encode pass", (ENCODE_BATCH, ENCODE_FRAMES)),
                         ("training step", (TRAIN_BATCH, TRAIN_SEQ))):
        q = torch.randn((b, s, H, 1, hd), generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn((b, s, H, hd), generator=g).to(dev, torch.bfloat16)
                for _ in range(2))
        fa.counts.reset()
        o = fa.flash_attention_model(q, k, v, False, None)
        torch.cuda.synchronize()
        ok, err = close(o, fa._plain_model(q, k, v, False, None), **BF16)
        if (not ok or o.dtype != q.dtype or o.shape != q.shape
                or fa.counts.routes != {"fma": 0, "wgmma": 1}):
            fail(f"phase 50: flash_attention_model disagrees with its plain "
                 f"version at {AUDIO_ARCH}'s {what} call q{list(q.shape)} "
                 f"bf16 non-causal (max {err:.3e}, routes "
                 f"{fa.counts.routes})")
        worst = max(worst, err)
        inputs[what] = (q, k, v)
        print(f"[50] flash_attention_model q{list(q.shape)} "
              f"k/v{list(k.shape)} bf16 non-causal ({AUDIO_ARCH}'s {what} "
              f"call, wgmma route, tiles {fa.TC_BLOCK_Q}x{fa.TC_BLOCK_K}, "
              f"row stride {H * hd * 2} B): max |kernel - plain| = "
              f"{err:.3e} (bf16 2e-2) ok")
        del o
    for what, (q, k, v) in inputs.items():
        B, S = q.shape[:2]
        qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
        kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=False)
        ok, err = close(library(), flash_attention_ref(qh, kh, vh, False,
                                                       None), **BF16)
        if not ok:
            fail(f"phase 50: scaled_dot_product_attention computes another "
                 f"function than the plain version (max err {err:.3e})")
        ms = cuda_ms(lambda: fa.flash_attention_model(q, k, v, False, None),
                     True)
        plain_ms = cuda_ms(lambda: flash_attention_ref(qh, kh, vh, False,
                                                       None), True,
                           inner=3, samples=10, warmup=3)
        lib_ms = cuda_ms(library, True)
        n_bytes = 4 * q.numel() * q.element_size()
        n_ops = 4 * B * H * hd * S * S            # QK^T and PV, no mask
        bound_ms, bound_by = bound(n_bytes, n_ops, BF16_TC_OPS_PER_S)
        print(f"[50] flash_attention_model q{list(q.shape)} bf16 non-causal "
              f"({what}), card time: kernel {ms:.5f} ms "
              f"({n_ops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.1%} of its "
              f"bound), plain {plain_ms:.5f} ms, "
              f"scaled_dot_product_attention(is_causal=False) {lib_ms:.5f} "
              f"ms (on [B, H, S, hd]; max err against the plain version "
              f"{err:.3e}); bound {bound_ms:.6f} ms by {bound_by} "
              f"({n_bytes} B, {n_ops:.4g} FLOP at the bf16 tensor-core "
              f"peak)")
        del qh, kh, vh
    del inputs, q, k, v
    torch.cuda.empty_cache()
    print(f"[50] phase 50 {time.perf_counter() - t_phase:.1f} s")

    # -- 51. the encode pass at full size ------------------------------------
    t0 = t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init(gen, cfg, dev)
    n_params = M.param_count(params)
    if n_params != HUBERT_PARAMS or "embed" in params:
        fail(f"{AUDIO_ARCH}: {n_params} parameters (expected "
             f"{HUBERT_PARAMS}), keys {sorted(params)}")
    batch = make_batch(cfg, ENCODE_BATCH, ENCODE_FRAMES, seed=SEED,
                       device=dev)
    torch.cuda.synchronize()
    print(f"[51] {AUDIO_ARCH}: param_count {n_params:,} ({cfg.dtype}, {L} "
          f"layers, d_model {cfg.d_model}, {H} heads of {hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, frame features "
          f"{M.AUDIO_FEAT_DIM}, non-causal) made on the card from seed "
          f"{SEED} in {time.perf_counter() - t0:.2f}s; batch {ENCODE_BATCH} "
          f"x {ENCODE_FRAMES} frames, {ENCODE_PASSES} counted passes")
    with torch.no_grad():
        M.forward(params, batch, cfg)        # warm-up, not counted
        torch.cuda.synchronize()
        events, finite = [], []
        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats(dev)
        for cnt in all_counts.values():
            cnt.reset()                # --- the counted main-path run ---
        start.record()
        for _ in range(ENCODE_PASSES):
            logits, _ = M.forward(params, batch, cfg)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            finite.append(torch.isfinite(logits).all())
        events[-1].synchronize()
        got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
        routes = dict(all_counts["flash_attention"].routes)
        # ------------------------------------------------------------------
    n = L * ENCODE_PASSES
    expect = {k: ((n if k == "flash_attention" else 0), 0)
              for k in all_counts}
    if got != expect or routes != {"fma": 0, "wgmma": n}:
        fail(f"{AUDIO_ARCH} encode: (kernel launches, plain calls) {got}, B4 "
             f"routes {routes}; expected {expect} ({L} B4 launches a pass), "
             f"all on the bf16 route")
    shape = (ENCODE_BATCH, ENCODE_FRAMES, cfg.vocab_size)
    if tuple(logits.shape) != shape or not bool(torch.stack(finite).all()):
        fail(f"{AUDIO_ARCH} encode: logits {tuple(logits.shape)} (expected "
             f"{shape}) or non-finite")
    launches = n
    passes = np.array([a.elapsed_time(b) for a, b in
                       zip([start] + events[:-1], events)])
    p50 = float(np.percentile(passes, 50))
    print(f"[51] {AUDIO_ARCH} encode: B4 launches {n} ({n // ENCODE_PASSES} "
          f"a pass; by route {routes}), plain calls "
          f"{got['flash_attention'][1]}; no other kernel; logits "
          f"{list(logits.shape)} {str(logits.dtype)[6:]} finite")
    print(f"[51] {AUDIO_ARCH} encode pass p50 {p50:.3f} ms, p99 "
          f"{float(np.percentile(passes, 99)):.3f} ms, first "
          f"{passes[0]:.3f} ms (on the card's clock, pass end to pass end); "
          f"{ENCODE_BATCH * ENCODE_FRAMES / p50 * 1e3:,.0f} frames/s at p50 "
          f"({2 * n_params * ENCODE_BATCH * ENCODE_FRAMES / p50 / 1e9:.1f} "
          f"TFLOP/s in the matmuls of the parameters); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    with torch.no_grad(), tprofile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.forward(params, batch, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile("51", f"{AUDIO_ARCH} encode", prof, wall_us, 1, "forward",
                   step_part)
    del params, batch, logits, finite, prof
    torch.cuda.empty_cache()

    c = cfg.replace(num_layers=2, dtype="float32")
    small = M.init(torch.Generator().manual_seed(SEED + 4), c, "cpu")
    b1 = make_batch(c, 1, 256, seed=SEED + 5, device="cpu")
    runs = {}
    for d in ("cpu", dev):
        fa.counts.reset()
        with torch.no_grad():
            lg, _ = M.forward(M.map_params(lambda x: x.to(d), small),
                              {k: v.to(d) for k, v in b1.items()}, c)
        runs[str(d)] = (lg.cpu(), fa.counts.launches, fa.counts.plain_calls)
    (lg_c, l_c, p_c), (lg_g, l_g, p_g) = runs["cpu"], runs[str(dev)]
    err = float((lg_g - lg_c).abs().max())
    if (l_c, p_c, l_g, p_g) != (0, 2, 2, 0) or err > LOGIT_ATOL:
        fail(f"phase 51: {AUDIO_ARCH} depth 2 fp32 card logits differ from "
             f"the CPU's by {err:.3e} (> {LOGIT_ATOL}), or B4 (launches, "
             f"plain calls) card {(l_g, p_g)}, CPU {(l_c, p_c)}")
    print(f"[51] {AUDIO_ARCH} full width, depth 2, fp32 (TF32 off), batch "
          f"1, 256 frames, from one seed's weights: logits card vs CPU max "
          f"|diff| {err:.3e} (<= {LOGIT_ATOL}; |logits| up to "
          f"{float(lg_c.abs().max()):.2f}); B4 2 launches on the card (fp32 "
          f"route), 2 plain calls on the CPU")
    del small, runs, lg
    print(f"[51] phase 51 {time.perf_counter() - t_phase:.1f} s")

    # -- 52. train hubert-xlarge at full size --------------------------------
    tcfg = T.TrainConfig(lr=3e-4, warmup=min(20, AUDIO_TRAIN_STEPS // 5 + 1),
                         total_steps=AUDIO_TRAIN_STEPS)
    t0 = t_phase = time.perf_counter()
    trainer = T.Trainer(cfg, tcfg, SEED, device=dev)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in M.leaves(trainer.state))
    print(f"[52] {AUDIO_ARCH}: the train state ({n_params:,} bf16 "
          f"parameters, fp32 moments) {state_bytes / 1e9:.2f} GB made on "
          f"the card from seed {SEED} in {time.perf_counter() - t0:.2f}s; "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ} frames, lr {tcfg.lr}, warmup "
          f"{tcfg.warmup}, {AUDIO_TRAIN_STEPS} steps")
    stream = TokenStream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED, device=dev)
    held_out = [make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=HELD_OUT_SEED + i,
                           device=dev) for i in range(HELD_OUT_BATCHES)]

    def held_out_loss():
        with torch.no_grad():
            return float(torch.stack([M.loss_fn(trainer.state["params"], b,
                                                cfg)[0]
                                      for b in held_out]).mean())
    before = held_out_loss()
    # warm-up, not counted: one forward and backward at these shapes (the
    # donating step would train the state)
    T._compute_grads(trainer.state["params"], next(TokenStream(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 11, device=dev)), cfg, tcfg)
    torch.cuda.synchronize()
    events, losses = [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(metrics["loss"])
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats(dev)
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted main-path run ---
    start.record()
    trainer.run(stream, AUDIO_TRAIN_STEPS, log_every=AUDIO_TRAIN_STEPS,
                log=lambda s: print(f"[52]   {s}"), on_step=on_step)
    events[-1].synchronize()
    got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
    routes = dict(all_counts["flash_attention"].routes)
    backward = all_counts["flash_attention"].backward_plain
    # ----------------------------------------------------------------------
    n = 2 * L * AUDIO_TRAIN_STEPS
    expect = {k: ((n if k == "flash_attention" else 0), 0)
              for k in all_counts}
    if got != expect or backward != L * AUDIO_TRAIN_STEPS \
            or routes != {"fma": 0, "wgmma": n}:
        fail(f"{AUDIO_ARCH} training: (kernel launches, plain calls) {got}, "
             f"B4 routes {routes}, B4 backward passes {backward}; expected "
             f"{expect}, all on the bf16 route, and {L * AUDIO_TRAIN_STEPS} "
             f"backward passes (B4 twice a layer a step: the forward and the "
             f"remat recompute)")
    loss = torch.stack(losses).float().cpu().numpy()
    after = held_out_loss()
    if not np.isfinite(loss).all() or not np.isfinite([before, after]).all():
        fail(f"{AUDIO_ARCH}: non-finite loss {loss}, held out {before} -> "
             f"{after}")
    if not after < before:
        fail(f"{AUDIO_ARCH}: the loss did not fall: held-out loss "
             f"{before:.4f} before training, {after:.4f} after")
    launches += n
    steps = np.array([a.elapsed_time(b) for a, b in
                      zip([start] + events[:-1], events)])
    p50 = float(np.percentile(steps, 50))
    print(f"[52] {AUDIO_ARCH} training: B4 launches {n} "
          f"({n // AUDIO_TRAIN_STEPS} a step; by route {routes}), plain "
          f"calls {got['flash_attention'][1]}, B4 backward passes (the VJP "
          f"of the plain version) {backward}; no other kernel")
    print(f"[52] {AUDIO_ARCH} loss on the {HELD_OUT_BATCHES} held-out "
          f"batches: {before:.4f} before training, {after:.4f} after (fell "
          f"by {before - after:.4f}; ln {cfg.vocab_size} = "
          f"{np.log(cfg.vocab_size):.4f}: the labels are random); every "
          f"step's loss finite")
    print(f"[52] {AUDIO_ARCH} training loss by step (each a new random "
          f"batch): " + " ".join(f"{v:.4f}" for v in loss))
    print(f"[52] {AUDIO_ARCH} step time p50 {p50:.3f} ms, p99 "
          f"{float(np.percentile(steps, 99)):.3f} ms, first "
          f"{steps[0]:.3f} ms (on the card's clock, from one step's end to "
          f"the next); {TRAIN_BATCH * TRAIN_SEQ / p50 * 1e3:,.0f} frames/s "
          f"at p50; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(stream, PROFILED_STEPS, log_every=PROFILED_STEPS,
                    log=lambda s: None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile("52", f"{AUDIO_ARCH} training", prof, wall_us,
                   PROFILED_STEPS, "step", step_part)
    del trainer, stream, events, losses, prof, held_out
    torch.cuda.empty_cache()
    print(f"[52] phase 52 {time.perf_counter() - t_phase:.1f} s")
    return launches, worst


def vlm_phases(dev, all_counts):
    """Phases 53-55: B4 at internvl2-1b's shapes (causal, GQA group 7, head
    dim 64) against its plain version and timed; internvl2-1b's
    image-plus-prompt prefill and greedy decode at full size, and at full
    width and depth 2 on the card against the CPU; internvl2-1b trained at
    full size.  Returns (B4's launches over the counted runs of phases 54
    and 55, the largest |kernel - plain| of phase 53's calls)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import model as M
    from repro_torch.serving import make_prefill_fn, make_serve_step
    from repro_torch.training import trainer as T

    cfg = get_config(VLM_ARCH)
    L, H, KV, hd = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    G = H // KV
    if (G, hd) != (7, 64) or not cfg.causal or cfg.family != "vlm":
        fail(f"{VLM_ARCH}: {H} heads over {KV}, head dim {hd}, causal "
             f"{cfg.causal}, family {cfg.family}; expected G 7, hd 64, a "
             f"causal vlm")
    n_vis = min(cfg.num_vision_tokens, VLM_SEQ // 2)

    # -- 53. B4 at internvl2's shapes, bf16, causal, G 7 ---------------------
    t_phase = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(SEED + 53)
    worst, inputs = 0.0, {}
    for what, (b, s) in (("prefill", (VLM_BATCH, VLM_SEQ)),
                         ("training step", (VLM_BATCH, VLM_TRAIN_SEQ))):
        q = torch.randn((b, s, KV, G, hd), generator=g).to(dev,
                                                           torch.bfloat16)
        k, v = (torch.randn((b, s, KV, hd), generator=g).to(dev,
                                                            torch.bfloat16)
                for _ in range(2))
        fa.counts.reset()
        o = fa.flash_attention_model(q, k, v, True, None)
        torch.cuda.synchronize()
        ok, err = close(o, fa._plain_model(q, k, v, True, None), **BF16)
        if (not ok or o.dtype != q.dtype or o.shape != q.shape
                or fa.counts.routes != {"fma": 0, "wgmma": 1}):
            fail(f"phase 53: flash_attention_model disagrees with its plain "
                 f"version at {VLM_ARCH}'s {what} call q{list(q.shape)} "
                 f"bf16 causal (max {err:.3e}, routes {fa.counts.routes})")
        worst = max(worst, err)
        inputs[what] = (q, k, v)
        print(f"[53] flash_attention_model q{list(q.shape)} "
              f"k/v{list(k.shape)} bf16 causal ({VLM_ARCH}'s {what} call, "
              f"GQA group {G}, wgmma route, tiles "
              f"{fa.TC_BLOCK_Q}x{fa.TC_BLOCK_K}, row stride {H * hd * 2} "
              f"B): max |kernel - plain| = {err:.3e} (bf16 2e-2) ok")
        del o
    for what, (q, k, v) in inputs.items():
        B, S = q.shape[:2]
        qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
        kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  enable_gqa=True)
        ok, err = close(library(), flash_attention_ref(qh, kh, vh, True,
                                                       None), **BF16)
        if not ok:
            fail(f"phase 53: scaled_dot_product_attention computes another "
                 f"function than the plain version (max err {err:.3e})")
        ms = cuda_ms(lambda: fa.flash_attention_model(q, k, v, True, None),
                     True)
        plain_ms = cuda_ms(lambda: flash_attention_ref(qh, kh, vh, True,
                                                       None), True,
                           inner=3, samples=10, warmup=3)
        lib_ms = cuda_ms(library, True)
        n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
        n_ops = 4 * B * H * hd * (S * (S + 1) // 2)    # QK^T and PV, causal
        bound_ms, bound_by = bound(n_bytes, n_ops, BF16_TC_OPS_PER_S)
        print(f"[53] flash_attention_model q{list(q.shape)} bf16 causal "
              f"({what}), card time: kernel {ms:.5f} ms "
              f"({n_ops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.1%} of its "
              f"bound), plain {plain_ms:.5f} ms, "
              f"scaled_dot_product_attention(is_causal=True) {lib_ms:.5f} ms "
              f"(enable_gqa=True, on [B, H, S, hd]; max err against the "
              f"plain version {err:.3e}); bound {bound_ms:.6f} ms by "
              f"{bound_by} "
              f"({n_bytes} B, {n_ops:.4g} FLOP at the bf16 tensor-core "
              f"peak)")
        del qh, kh, vh
    del inputs, q, k, v
    torch.cuda.empty_cache()
    print(f"[53] phase 53 {time.perf_counter() - t_phase:.1f} s")

    # -- 54. the image-plus-prompt prefill and greedy decode -----------------
    t0 = t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init(gen, cfg, dev)
    n_params = M.param_count(params)
    if n_params != INTERNVL2_PARAMS or "lm_head" in params \
            or tuple(params["frontend"]["proj"].shape) != (
                M.VISION_EMB_DIM, cfg.d_model):
        fail(f"{VLM_ARCH}: {n_params} parameters (expected "
             f"{INTERNVL2_PARAMS}), keys {sorted(params)}")
    batch = make_batch(cfg, VLM_BATCH, VLM_SEQ, seed=SEED, device=dev)
    n_text = batch["tokens"].shape[1]
    if tuple(batch["vision"].shape) != (VLM_BATCH, n_vis, M.VISION_EMB_DIM):
        fail(f"{VLM_ARCH}: vision {tuple(batch['vision'].shape)}, expected "
             f"{(VLM_BATCH, n_vis, M.VISION_EMB_DIM)}")
    torch.cuda.synchronize()
    print(f"[54] {VLM_ARCH}: param_count {n_params:,} ({cfg.dtype}, {L} "
          f"layers, d_model {cfg.d_model}, {H} heads over {KV} KV heads of "
          f"{hd}, qkv bias, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied, "
          f"patch embeddings {M.VISION_EMB_DIM}) made on the card from seed "
          f"{SEED} in {time.perf_counter() - t0:.2f}s; batch {VLM_BATCH} x "
          f"({n_vis} patches + {n_text} prompt tokens), context "
          f"{VLM_SEQ + VLM_NEW}, {VLM_PREFILLS} counted prefills, then "
          f"{VLM_NEW} greedy decode steps")
    prefill_fn, step = make_prefill_fn(cfg), make_serve_step(cfg)
    ctx = VLM_SEQ + VLM_NEW

    def serve(n_prefills, n_steps, mark):
        """n_prefills prefills, then n_steps greedy decode steps from the
        last one's cache; `mark()` after each.  Returns (the tokens picked,
        the last cache, every logits tensor's finiteness)."""
        finite = []
        for _ in range(n_prefills):
            last, cache = prefill_fn(params, batch, ctx,
                                     last_logits_only=True)
            mark()
            finite.append(torch.isfinite(last).all())
        pos = cache["pos"]
        toks = [torch.argmax(last, dim=-1)]
        for _ in range(n_steps):
            last, cache = step(params, toks[-1], cache)
            mark()
            finite.append(torch.isfinite(last).all())
            toks.append(torch.argmax(last, dim=-1))
        return torch.cat(toks, 1), pos, cache, finite

    with torch.no_grad():
        serve(1, 4, lambda: None)           # warm-up, not counted
        torch.cuda.synchronize()
        events = []

        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats(dev)
        for cnt in all_counts.values():
            cnt.reset()                # --- the counted main-path run ---
        start.record()
        toks, pos, cache, finite = serve(VLM_PREFILLS, VLM_NEW, mark)
        events[-1].synchronize()
        got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
        routes = dict(all_counts["flash_attention"].routes)
        # ------------------------------------------------------------------
    n = L * VLM_PREFILLS
    expect = {k: ((n if k == "flash_attention" else 0), 0)
              for k in all_counts}
    if got != expect or routes != {"fma": 0, "wgmma": n}:
        fail(f"{VLM_ARCH} serving: (kernel launches, plain calls) {got}, B4 "
             f"routes {routes}; expected {expect} ({L} B4 launches a "
             f"prefill, none in decode), all on the bf16 route")
    if pos != VLM_SEQ or cache["pos"] != VLM_SEQ + VLM_NEW:
        fail(f"{VLM_ARCH}: the cache's pos {pos} after the prefill and "
             f"{cache['pos']} after {VLM_NEW} steps; expected {VLM_SEQ} "
             f"({n_vis} patches + {n_text} tokens) and {VLM_SEQ + VLM_NEW}")
    if not bool(torch.stack(finite).all()) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        fail(f"{VLM_ARCH}: non-finite logits or token ids outside the vocab")
    launches = n
    times = np.array([a.elapsed_time(b) for a, b in
                      zip([start] + events[:-1], events)])
    prefill, steps = times[:VLM_PREFILLS], times[VLM_PREFILLS:]
    p50 = float(np.percentile(prefill, 50))
    total_ms = p50 + float(steps.sum())
    print(f"[54] {VLM_ARCH} serving: B4 launches {n} ({L} a prefill; by "
          f"route {routes}), plain calls {got['flash_attention'][1]}; no "
          f"other kernel; the cache's pos {pos} after the prefill, "
          f"{cache['pos']} after {VLM_NEW} steps; every logit finite")
    print(f"[54] {VLM_ARCH} image-plus-prompt prefill (batch {VLM_BATCH}, "
          f"{n_vis} + {n_text} positions, last logits only) p50 {p50:.3f} "
          f"ms, p99 {float(np.percentile(prefill, 99)):.3f} ms over "
          f"{VLM_PREFILLS} ({VLM_BATCH * VLM_SEQ / p50 * 1e3:,.0f} positions "
          f"/s at p50; {2 * n_params * VLM_BATCH * VLM_SEQ / p50 / 1e9:.1f} "
          f"TFLOP/s in the matmuls of the parameters); decode step p50 "
          f"{float(np.percentile(steps, 50)):.3f} ms, p99 "
          f"{float(np.percentile(steps, 99)):.3f} ms over {VLM_NEW} steps of "
          f"{VLM_BATCH} tokens; {VLM_BATCH * VLM_NEW / total_ms * 1e3:.1f} "
          f"tok/s generated including the p50 prefill; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (on the "
          f"card's clock, each prefill and step end to end)")
    print(f"[54]   request 0, first 12 greedy ids: {toks[0, :12].tolist()}")
    del params, batch, cache, finite, toks
    torch.cuda.empty_cache()

    c = cfg.replace(num_layers=2, dtype="float32")
    small = M.init(torch.Generator().manual_seed(SEED + 4), c, "cpu")
    b1 = make_batch(c, 1, VLM_CHECK_SEQ, seed=SEED + 5, device="cpu")
    runs = {}
    for d in ("cpu", dev):
        p = M.map_params(lambda x: x.to(d), small)
        fa.counts.reset()
        with torch.no_grad():
            lg, cache = make_prefill_fn(c)(
                p, {k: v.to(d) for k, v in b1.items()},
                VLM_CHECK_SEQ + VLM_CHECK_NEW)
            seen, picks = [lg.cpu()], []
            for _ in range(VLM_CHECK_NEW):
                picks.append(torch.argmax(seen[-1][:, -1:], dim=-1))
                lg, cache = make_serve_step(c)(p, picks[-1].to(d), cache)
                seen.append(lg.cpu())
        runs[str(d)] = (seen, torch.cat(picks, 1), fa.counts.launches,
                        fa.counts.plain_calls)
    (lg_c, tk_c, l_c, p_c), (lg_g, tk_g, l_g, p_g) = runs["cpu"], \
        runs[str(dev)]
    err = max(float((a - b).abs().max()) for a, b in zip(lg_g, lg_c))
    top2 = torch.stack([torch.topk(x[0, -1], 2).values for x in lg_c])
    gap = float((top2[:, 0] - top2[:, 1]).min())
    if (l_c, p_c, l_g, p_g) != (0, 2, 2, 0) or err > LOGIT_ATOL \
            or not torch.equal(tk_c, tk_g):
        fail(f"phase 54: {VLM_ARCH} depth 2 fp32 card logits differ from "
             f"the CPU's by {err:.3e} (> {LOGIT_ATOL}), or greedy tokens "
             f"card {tk_g.tolist()}, CPU {tk_c.tolist()} (smallest CPU top-2 "
             f"gap {gap:.3e}), or B4 (launches, plain calls) card "
             f"{(l_g, p_g)}, CPU {(l_c, p_c)}")
    print(f"[54] {VLM_ARCH} full width, depth 2, fp32 (TF32 off), batch 1, "
          f"{b1['vision'].shape[1]} patches + {b1['tokens'].shape[1]} "
          f"tokens, from one seed's weights: prefill and {VLM_CHECK_NEW} "
          f"decode steps' logits card vs CPU max |diff| {err:.3e} (<= "
          f"{LOGIT_ATOL}; |logits| up to {float(lg_c[0].abs().max()):.2f}); "
          f"greedy ids {tk_g[0].tolist()} identical (smallest CPU top-2 gap "
          f"{gap:.3e}); B4 2 launches on the card (fp32 route), 2 plain "
          f"calls on the CPU")
    del small, runs, lg, cache
    print(f"[54] phase 54 {time.perf_counter() - t_phase:.1f} s")

    # -- 55. train internvl2-1b at full size ---------------------------------
    tcfg = T.TrainConfig(lr=3e-4, warmup=min(20, VLM_TRAIN_STEPS // 5 + 1),
                         total_steps=VLM_TRAIN_STEPS)
    t0 = t_phase = time.perf_counter()
    trainer = T.Trainer(cfg, tcfg, SEED, device=dev)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in M.leaves(trainer.state))
    n_vis_t = min(cfg.num_vision_tokens, VLM_TRAIN_SEQ // 2)
    n_text_t = VLM_TRAIN_SEQ - n_vis_t
    print(f"[55] {VLM_ARCH}: the train state ({n_params:,} bf16 parameters, "
          f"fp32 moments) {state_bytes / 1e9:.2f} GB made on the card from "
          f"seed {SEED} in {time.perf_counter() - t0:.2f}s; batch "
          f"{VLM_BATCH} x ({n_vis_t} patches + {n_text_t} text tokens), lr "
          f"{tcfg.lr}, warmup {tcfg.warmup}, {VLM_TRAIN_STEPS} steps")
    stream = TokenStream(cfg, VLM_BATCH, VLM_TRAIN_SEQ, seed=SEED, device=dev)
    held_out = [make_batch(cfg, VLM_BATCH, VLM_TRAIN_SEQ,
                           seed=HELD_OUT_SEED + i, device=dev)
                for i in range(HELD_OUT_BATCHES)]

    def held_out_loss():
        with torch.no_grad():
            return float(torch.stack([M.loss_fn(trainer.state["params"], b,
                                                cfg)[0]
                                      for b in held_out]).mean())
    before = held_out_loss()
    # warm-up, not counted: one forward and backward at these shapes (the
    # donating step would train the state)
    T._compute_grads(trainer.state["params"], next(TokenStream(
        cfg, VLM_BATCH, VLM_TRAIN_SEQ, seed=SEED + 11, device=dev)), cfg,
        tcfg)
    torch.cuda.synchronize()
    events, losses = [], []

    def on_step(i, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(metrics["loss"])
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats(dev)
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted main-path run ---
    start.record()
    trainer.run(stream, VLM_TRAIN_STEPS, log_every=VLM_TRAIN_STEPS,
                log=lambda s: print(f"[55]   {s}"), on_step=on_step)
    events[-1].synchronize()
    got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
    routes = dict(all_counts["flash_attention"].routes)
    backward = all_counts["flash_attention"].backward_plain
    # ----------------------------------------------------------------------
    n = 2 * L * VLM_TRAIN_STEPS
    expect = {k: ((n if k == "flash_attention" else 0), 0)
              for k in all_counts}
    if got != expect or backward != L * VLM_TRAIN_STEPS \
            or routes != {"fma": 0, "wgmma": n}:
        fail(f"{VLM_ARCH} training: (kernel launches, plain calls) {got}, B4 "
             f"routes {routes}, B4 backward passes {backward}; expected "
             f"{expect}, all on the bf16 route, and {L * VLM_TRAIN_STEPS} "
             f"backward passes (B4 twice a layer a step: the forward and the "
             f"remat recompute)")
    loss = torch.stack(losses).float().cpu().numpy()
    after = held_out_loss()
    if not np.isfinite(loss).all() or not np.isfinite([before, after]).all():
        fail(f"{VLM_ARCH}: non-finite loss {loss}, held out {before} -> "
             f"{after}")
    if not after < before:
        fail(f"{VLM_ARCH}: the loss did not fall: held-out loss "
             f"{before:.4f} before training, {after:.4f} after")
    launches += n
    steps = np.array([a.elapsed_time(b) for a, b in
                      zip([start] + events[:-1], events)])
    p50 = float(np.percentile(steps, 50))
    print(f"[55] {VLM_ARCH} training: B4 launches {n} "
          f"({n // VLM_TRAIN_STEPS} a step; by route {routes}), plain calls "
          f"{got['flash_attention'][1]}, B4 backward passes (the VJP of the "
          f"plain version) {backward}; no other kernel")
    print(f"[55] {VLM_ARCH} loss on the {HELD_OUT_BATCHES} held-out batches "
          f"(text positions only): {before:.4f} before training, "
          f"{after:.4f} after (fell by {before - after:.4f}; ln "
          f"{cfg.vocab_size} = {np.log(cfg.vocab_size):.4f}: the tokens are "
          f"random); every step's loss finite")
    print(f"[55] {VLM_ARCH} training loss by step (each a new random "
          f"batch): " + " ".join(f"{v:.4f}" for v in loss))
    print(f"[55] {VLM_ARCH} step time p50 {p50:.3f} ms, p99 "
          f"{float(np.percentile(steps, 99)):.3f} ms, first {steps[0]:.3f} ms "
          f"(on the card's clock, from one step's end to the next); "
          f"{VLM_BATCH * n_text_t / p50 * 1e3:,.0f} text tokens/s and "
          f"{VLM_BATCH * VLM_TRAIN_SEQ / p50 * 1e3:,.0f} positions/s at p50; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB")
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(stream, PROFILED_STEPS, log_every=PROFILED_STEPS,
                    log=lambda s: None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    def part(low, op):      # a dense model's gathers are not routing
        grp = step_part(low, op)
        return ("gathers and their backward (the embedding lookup, the "
                "loss's label gather)" if grp.startswith("routing") else grp)
    report_profile("55", f"{VLM_ARCH} training", prof, wall_us,
                   PROFILED_STEPS, "step", part)
    del trainer, stream, events, losses, prof, held_out
    torch.cuda.empty_cache()
    print(f"[55] phase 55 {time.perf_counter() - t_phase:.1f} s")
    return launches, worst


def hybrid_phases(dev, all_counts):
    """Phases 56-58: B4 (causal, G 8, head dim 128) and B5 (256 heads,
    P 64, N 128, chunk 256) at jamba-1.5-large-398b's shapes against their
    plain versions and timed; jamba at full width with two cuts (one
    period of 8 layers, 8 of its 16 experts; `HYBRID_CUT`) served: the
    prefill of 8 x 1024 tokens and 64 greedy decode steps; its scoring
    pass (`loss_fn` without gradients); a narrow hybrid at jamba's period
    and kernel widths on the card against the CPU.  Returns (B4's and B5's
    launches over the counted runs of phases 57 and 58, the largest |kernel
    - plain| of phase 56's B4 and B5 calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import flash_attention_ref, ssd_chunked_ref
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving import generate, make_prefill_fn, make_serve_step

    cfg = get_config(HYBRID_ARCH).replace(**HYBRID_CUT)
    n_periods, plen, kinds, mlp_kinds = M.period_structure(cfg)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // KV
    SH, P, N, Q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                   cfg.ssm_chunk)
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    if (G, hd, SH, P, N, Q, n_periods, plen, n_attn, n_ssm) != (
            8, 128, 256, 64, 128, 256, 1, 8, 1, 7) or cfg.family != "hybrid" \
            or mlp_kinds != ("dense", "moe") * 4 or cfg.d_model != 8192:
        fail(f"{HYBRID_ARCH} cut {HYBRID_CUT}: G {G}, hd {hd}, {SH} SSM "
             f"heads of P {P}, N {N}, chunk {Q}, {n_periods} periods of "
             f"{plen} ({kinds}, {mlp_kinds}); expected one period of 8 at "
             f"G 8, hd 128, 256 heads of 64, N 128, chunk 256")
    B, S = HYBRID_BATCH, HYBRID_PROMPT
    errs = {}

    # -- 56. B4 and B5 at jamba's shapes, bf16 -------------------------------
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 56)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q = randn(B, S, KV, G, hd).to(torch.bfloat16)
    k, v = (randn(B, S, KV, hd).to(torch.bfloat16) for _ in range(2))
    fa.counts.reset()
    o = fa.flash_attention_model(q, k, v, True, None)
    torch.cuda.synchronize()
    ok, err = close(o, fa._plain_model(q, k, v, True, None), **BF16)
    if (not ok or o.dtype != q.dtype or o.shape != q.shape
            or fa.counts.routes != {"fma": 0, "wgmma": 1}):
        fail(f"phase 56: flash_attention_model disagrees with its plain "
             f"version at {HYBRID_ARCH}'s call q{list(q.shape)} bf16 causal "
             f"(max {err:.3e}, routes {fa.counts.routes})")
    errs["flash_attention"] = err
    del o
    print(f"[56] flash_attention_model q{list(q.shape)} k/v{list(k.shape)} "
          f"bf16 causal ({HYBRID_ARCH}'s prefill and scoring call, GQA "
          f"group {G}, head dim {hd}, wgmma route, tiles "
          f"{fa.TC_BLOCK_Q}x{fa.TC_BLOCK_K}, row stride {H * hd * 2} B): "
          f"max |kernel - plain| = {err:.3e} (bf16 2e-2) ok")
    qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)
    ok, err = close(library(), flash_attention_ref(qh, kh, vh, True, None),
                    **BF16)
    if not ok:
        fail(f"phase 56: scaled_dot_product_attention computes another "
             f"function than the plain version (max err {err:.3e})")
    ms = cuda_ms(lambda: fa.flash_attention_model(q, k, v, True, None), True)
    plain_ms = cuda_ms(lambda: flash_attention_ref(qh, kh, vh, True, None),
                       True, inner=3, samples=10, warmup=3)
    lib_ms = cuda_ms(library, True)
    n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    n_ops = 4 * B * H * hd * (S * (S + 1) // 2)    # QK^T and PV, causal
    bound_ms, bound_by = bound(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    print(f"[56] flash_attention_model q{list(q.shape)} bf16 causal, card "
          f"time: kernel {ms:.5f} ms ({n_ops / ms / 1e9:.2f} TFLOP/s, "
          f"{bound_ms / ms:.1%} of its bound), plain {plain_ms:.5f} ms, "
          f"scaled_dot_product_attention(is_causal=True) {lib_ms:.5f} ms "
          f"(enable_gqa=True, on [B, H, S, hd]; max err against the plain "
          f"version {err:.3e}); bound {bound_ms:.6f} ms by {bound_by} "
          f"({n_bytes} B, {n_ops:.4g} FLOP at the bf16 tensor-core peak)")
    del q, k, v, qh, kh, vh

    xs = [randn(B, S, SH, P).to(torch.bfloat16), F.softplus(randn(B, S, SH)),
          -torch.exp(randn(SH)), randn(B, S, N).to(torch.bfloat16),
          randn(B, S, N).to(torch.bfloat16)]
    ssd.counts.reset()
    y = ssd.ssd_scan(*xs, chunk=Q)
    torch.cuda.synchronize()
    want = ssd_chunked_ref(*xs, Q)[0]
    ok, err = close(y, want, **BF16)
    y_max = float(want.float().abs().max())
    if (not ok or y.dtype != xs[0].dtype or y.shape != xs[0].shape
            or ssd.counts.routes != {"fma": 0, "wgmma": 1}):
        fail(f"phase 56: ssd_scan disagrees with its plain version at "
             f"{HYBRID_ARCH}'s call x{list(xs[0].shape)} N {N} chunk {Q} "
             f"bf16 (max {err:.3e}, routes {ssd.counts.routes})")
    errs["ssd_scan"] = err
    del y, want
    nc = -(-S // Q)
    print(f"[56] ssd_scan x{list(xs[0].shape)} N {N} chunk {Q} bf16 "
          f"({HYBRID_ARCH}'s scoring call, 7 a pass; {nc} chunks, so the "
          f"chunk-state pass runs on {B * (nc - 1) * SH} blocks; wgmma "
          f"route, x row stride {SH * P * 2} B): max |kernel - plain| = "
          f"{err:.3e} at |y| up to {y_max:.1f}, where a bf16 ulp is "
          f"{2.0 ** (np.floor(np.log2(y_max)) - 7):.3g} (bf16 rtol/atol "
          f"2e-2) ok")
    L = [min(Q, S - c0) for c0 in range(0, S, Q)]
    n_ops = B * SH * sum(2 * (N + P) * l * (l + 1) // 2 + 4 * l * N * P
                         for l in L)
    n_bytes = sum(t.numel() * t.element_size() for t in xs) \
        + xs[0].numel() * xs[0].element_size()
    ms = cuda_ms(lambda: ssd.ssd_scan(*xs, chunk=Q), True, inner=5,
                 samples=20, warmup=3)
    plain_ms = cuda_ms(lambda: ssd_chunked_ref(*xs, Q), True, inner=1,
                       samples=5, warmup=1)
    bound_ms, bound_by = bound(n_bytes, n_ops, BF16_TC_OPS_PER_S)
    print(f"[56] ssd_scan x{list(xs[0].shape)} N {N} chunk {Q} bf16, card "
          f"time: kernel (bf16 route, wgmma) {ms:.5f} ms "
          f"({n_ops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.1%} of its "
          f"bound), plain {plain_ms:.5f} ms, no single PyTorch call computes "
          f"it (library_ms null); bound {bound_ms:.6f} ms by {bound_by} "
          f"({n_bytes} B, {n_ops:.4g} FLOP at the bf16 tensor-core peak)")
    del xs
    torch.cuda.empty_cache()
    print(f"[56] phase 56 {time.perf_counter() - t_phase:.1f} s")

    # -- 57. serving jamba at full width: prefill, then greedy decode --------
    t0 = t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init(gen, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = M.param_count(params)
    model_bytes = sum(t.numel() * t.element_size() for t in M.leaves(params))
    biggest = max(t.numel() for t in M.leaves(params))
    init_peak = torch.cuda.max_memory_allocated(dev) - before
    # one leaf's transient on top of the model: kaiming's fp32 draw and its
    # bf16 copy (3 x 2 B an entry) of the largest leaf, drawn last but two
    held_once = model_bytes + 6 * biggest
    if n_params != HYBRID_PARAMS or "lm_head" not in params:
        fail(f"{HYBRID_ARCH} cut {HYBRID_CUT}: {n_params} parameters "
             f"(expected {HYBRID_PARAMS}), keys {sorted(params)}")
    if init_peak > held_once or not all(
            t._is_view() for t in M.leaves(params["periods"])):
        fail(f"{HYBRID_ARCH}: the init's peak {init_peak / 2**30:.2f} GiB "
             f"over the {before / 2**30:.2f} GiB held before it, above the "
             f"model ({model_bytes / 2**30:.2f} GiB) and one leaf's draw "
             f"({held_once / 2**30:.2f} GiB), or a stacked leaf that is not "
             f"a view of its draw: the one-period stack holds the model "
             f"twice")
    print(f"[57] {HYBRID_ARCH} cut to one period and {cfg.num_experts} of "
          f"its 16 experts: param_count {n_params:,} ({cfg.dtype}, "
          f"{model_bytes / 2**30:.2f} GiB; {plen} layers: {n_ssm} Mamba-2 "
          f"mixers of {SH} heads, attention at offset {cfg.attn_offset} with "
          f"{H} heads over {KV} of {hd}, dense MLPs of {cfg.d_ff} and "
          f"{cfg.num_experts} experts of {cfg.moe_d_ff} top-{cfg.top_k} on "
          f"the odd layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"untied) made on the card from seed {SEED} in {init_s:.2f}s; "
          f"peak memory of the init {init_peak / 2**30:.2f} GiB over the "
          f"{before / 2**30:.2f} GiB held before it (<= the model plus one "
          f"leaf's fp32 draw and bf16 copy, {held_once / 2**30:.2f} GiB: the "
          f"stack is views of its draws); batch {B} x {S} prompt tokens, "
          f"context {S + HYBRID_NEW}, {HYBRID_PREFILLS} counted prefills, "
          f"then {HYBRID_NEW} greedy decode steps")
    batch = make_batch(cfg, B, S, seed=SEED, device=dev)
    ctx = S + HYBRID_NEW

    def serve(tap, n_prefills, n_steps, mark):
        """n_prefills prefills, then n_steps greedy decode steps from the
        last one's cache, every MoE layer reporting to `tap`; `mark()`
        after each."""
        prefill_fn = make_prefill_fn(cfg, tap)
        step = make_serve_step(cfg, tap)
        finite = []
        for _ in range(n_prefills):
            last, cache = prefill_fn(params, batch, ctx,
                                     last_logits_only=True)
            mark()
            finite.append(torch.isfinite(last).all())
        pos = cache["pos"]
        toks = [torch.argmax(last, dim=-1)]
        for _ in range(n_steps):
            last, cache = step(params, toks[-1], cache)
            mark()
            finite.append(torch.isfinite(last).all())
            toks.append(torch.argmax(last, dim=-1))
        return torch.cat(toks, 1), pos, cache, finite

    with torch.no_grad():
        serve(None, 1, 4, lambda: None)     # warm-up, not counted
        torch.cuda.synchronize()
        events = []

        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats(dev)
        tap = moe.Tap()                # counts the capacity drops
        for cnt in all_counts.values():
            cnt.reset()                # --- the counted main-path run ---
        start.record()
        toks, pos, cache, finite = serve(tap, HYBRID_PREFILLS, HYBRID_NEW,
                                         mark)
        events[-1].synchronize()
        got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
        routes = dict(all_counts["flash_attention"].routes)
        # ------------------------------------------------------------------
    n = n_attn * HYBRID_PREFILLS
    expect = {k: ((n if k == "flash_attention" else 0), 0)
              for k in all_counts}
    if got != expect or routes != {"fma": 0, "wgmma": n}:
        fail(f"{HYBRID_ARCH} serving: (kernel launches, plain calls) {got}, "
             f"B4 routes {routes}; expected {expect} (one B4 launch a "
             f"prefill, none in decode; no B5 call: the prefill's scan is "
             f"plain, as in the JAX package), all on the bf16 route")
    if pos != S or cache["pos"] != S + HYBRID_NEW:
        fail(f"{HYBRID_ARCH}: the cache's pos {pos} after the prefill and "
             f"{cache['pos']} after {HYBRID_NEW} steps; expected {S} and "
             f"{S + HYBRID_NEW}")
    if not bool(torch.stack(finite).all()) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        fail(f"{HYBRID_ARCH}: non-finite logits or token ids outside the "
             f"vocab")
    launches = {"flash_attention": n, "ssd_scan": 0}
    times = np.array([a.elapsed_time(b) for a, b in
                      zip([start] + events[:-1], events)])
    prefill, steps = times[:HYBRID_PREFILLS], times[HYBRID_PREFILLS:]
    p50 = float(np.percentile(prefill, 50))
    total_ms = p50 + float(steps.sum())
    active = cfg.param_counts()["active"]
    print(f"[57] {HYBRID_ARCH} serving: B4 launches {n} ({n_attn} a "
          f"prefill; by route {routes}), plain calls "
          f"{got['flash_attention'][1]}; B5 launches and plain calls 0 (the "
          f"prefill's scan is the plain chunked scan); the cache's pos {pos} "
          f"after the prefill, {cache['pos']} after {HYBRID_NEW} steps; "
          f"every logit finite; {tap.dropped} (token, expert) assignments "
          f"dropped by capacity over {tap.calls} run_moe calls (C "
          f"{moe.moe_capacity(B * S, cfg)} in a prefill, "
          f"{moe.moe_capacity(B, cfg)} a decode step)")
    print(f"[57] {HYBRID_ARCH} prefill (batch {B}, {S} tokens, last logits "
          f"only) p50 {p50:.3f} ms, p99 "
          f"{float(np.percentile(prefill, 99)):.3f} ms over {HYBRID_PREFILLS} ({B * S / p50 * 1e3:,.0f} prompt tok/s "
          f"at p50; {2 * active * B * S / p50 / 1e9:.1f} TFLOP/s in the "
          f"matmuls of the {active:,} parameters a token uses); decode step "
          f"p50 {float(np.percentile(steps, 50)):.3f} ms, p99 "
          f"{float(np.percentile(steps, 99)):.3f} ms over {HYBRID_NEW} steps "
          f"of {B} tokens (bound {model_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms"
          f" reading every weight once); {B * HYBRID_NEW / total_ms * 1e3:.1f}"
          f" tok/s generated including the p50 prefill; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (on the "
          f"card's clock, each prefill and step end to end)")
    print(f"[57]   request 0, first 12 greedy ids: {toks[0, :12].tolist()}")
    del batch, cache, finite, toks
    torch.cuda.empty_cache()
    print(f"[57] phase 57 {time.perf_counter() - t_phase:.1f} s")

    # -- 58. the scoring pass; a narrow hybrid on the card against the CPU --
    t_phase = time.perf_counter()
    batch = make_batch(cfg, B, S, seed=SEED + 58, device=dev)
    with torch.no_grad():
        M.loss_fn(params, batch, cfg)       # warm-up, not counted
        torch.cuda.synchronize()
        events, losses = [], []
        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats(dev)
        for cnt in all_counts.values():
            cnt.reset()                # --- the counted main-path run ---
        start.record()
        for _ in range(HYBRID_PASSES):
            loss, _ = M.loss_fn(params, batch, cfg)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            losses.append(loss)
        events[-1].synchronize()
        got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
        routes = {k: dict(all_counts[k].routes)
                  for k in ("flash_attention", "ssd_scan")}
        # ------------------------------------------------------------------
    per = {"flash_attention": n_attn, "ssd_scan": n_ssm}
    expect = {k: (per.get(k, 0) * HYBRID_PASSES, 0) for k in all_counts}
    if got != expect or routes != {
            k: {"fma": 0, "wgmma": m * HYBRID_PASSES} for k, m in per.items()}:
        fail(f"{HYBRID_ARCH} scoring pass: (kernel launches, plain calls) "
             f"{got}, routes {routes}; expected {expect} ({n_attn} B4 and "
             f"{n_ssm} B5 launches a pass), all on the bf16 routes")
    loss = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(loss).all():
        fail(f"{HYBRID_ARCH}: non-finite scoring loss {loss}")
    for k_, m in per.items():
        launches[k_] += m * HYBRID_PASSES
    times = np.array([a.elapsed_time(b) for a, b in
                      zip([start] + events[:-1], events)])
    p50 = float(np.percentile(times, 50))
    print(f"[58] {HYBRID_ARCH} scoring pass (loss_fn without gradients, "
          f"batch {B} x {S}): B4 launches {got['flash_attention'][0]}, B5 "
          f"launches {got['ssd_scan'][0]} ({n_attn} and {n_ssm} a pass; by "
          f"route {routes}), plain calls 0; loss {loss[0]:.4f} (ln "
          f"{cfg.vocab_size} = {np.log(cfg.vocab_size):.4f}: random tokens), "
          f"finite in every pass")
    print(f"[58] {HYBRID_ARCH} scoring pass p50 {p50:.3f} ms, p99 "
          f"{float(np.percentile(times, 99)):.3f} ms over {HYBRID_PASSES} "
          f"({B * S / p50 * 1e3:,.0f} positions/s at p50); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (on the "
          f"card's clock)")
    del params, batch, losses, events
    torch.cuda.empty_cache()

    c = get_config(HYBRID_ARCH).replace(num_layers=8, **HYBRID_NARROW)
    if (c.num_heads // c.num_kv_heads, c.resolved_head_dim, c.ssm_head_dim,
            c.ssm_state, c.ssm_chunk) != (8, 128, 64, 128, 256):
        fail(f"phase 58's narrow hybrid: {c}")
    small = M.init(torch.Generator().manual_seed(SEED + 58), c, "cpu")
    cb = make_batch(c, HYBRID_CHECK_BATCH, HYBRID_CHECK_SEQ, seed=SEED + 59,
                    device="cpu")

    def forward(d, choices=None):
        tap_ = moe.Tap(record=True, choices=choices)
        fa.counts.reset()
        ssd.counts.reset()
        with torch.no_grad():
            lg, _ = M.forward(M.map_params(lambda x: x.to(d), small),
                              {k: x.to(d) for k, x in cb.items()}, c, tap_)
        counts = ((fa.counts.launches, fa.counts.plain_calls),
                  (ssd.counts.launches, ssd.counts.plain_calls))
        return (lg.cpu(), counts), tap_.routes
    (lg_g, n_g), rec_g = forward(dev)
    (lg_c, n_c), rec_c = forward("cpu")
    n_diff, gap = routing_diff(rec_g, rec_c, "phase 58 forward")
    if n_diff:
        (lg_c, n_c), _ = forward("cpu", [i for _, i in rec_g])
    err = float((lg_g - lg_c).abs().max())
    if err > LOGIT_ATOL or n_g != ((1, 0), (7, 0)) \
            or n_c != ((0, 1), (0, 7)):
        fail(f"phase 58: the narrow hybrid's fp32 card logits differ from "
             f"the CPU's by {err:.3e} (> {LOGIT_ATOL}), or (launches, plain "
             f"calls) of B4 and B5 card {n_g}, CPU {n_c}")
    print(f"[58] narrow hybrid at jamba's period (8 layers: attention at "
          f"offset 4 with {c.num_heads} heads over {c.num_kv_heads} of "
          f"{c.resolved_head_dim}, 7 Mamba-2 mixers of {c.ssm_heads} heads, "
          f"P {c.ssm_head_dim}, N {c.ssm_state}, chunk {c.ssm_chunk}; d_model "
          f"{c.d_model}, d_ff {c.d_ff}, {c.num_experts} experts on the odd "
          f"layers, vocab {c.vocab_size}), fp32 (TF32 off), batch "
          f"{HYBRID_CHECK_BATCH} x {HYBRID_CHECK_SEQ}: forward logits card "
          f"vs CPU max |diff| {err:.3e} (<= {LOGIT_ATOL}; |logits| up to "
          f"{float(lg_c.abs().max()):.2f}); B4 1 and B5 7 launches on the "
          f"card (fp32 routes), as many plain calls on the CPU; top-k "
          f"choices of {len(rec_g)} router calls "
          + ("identical" if not n_diff else
             f"differ in {n_diff} rows at CPU gaps down to {gap:.2e}: the "
             f"CPU at the card's choices"))

    prompt = cb["tokens"][:1]

    def serve_small(d, choices=None):
        seen, tap_ = [], moe.Tap(record=True, choices=choices)
        out = generate(M.map_params(lambda x: x.to(d), small), c,
                       prompt.to(d), HYBRID_CHECK_NEW,
                       on_logits=lambda i, lg: seen.append(lg.cpu()),
                       tap=tap_)
        return (out.cpu(), torch.cat(seen, 1)), tap_.routes
    (out_g, lg_g), rec_g = serve_small(dev)
    (out_c, lg_c), rec_c = serve_small("cpu")
    n_diff, gap = routing_diff(rec_g, rec_c, "phase 58 serving")
    if n_diff:
        (out_c, lg_c), _ = serve_small("cpu", [i for _, i in rec_g])
    err = float((lg_g - lg_c).abs().max())
    top2 = torch.topk(lg_c, 2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    if err > LOGIT_ATOL or not torch.equal(out_g, out_c):
        fail(f"phase 58: the narrow hybrid's prefill and "
             f"{HYBRID_CHECK_NEW} greedy steps: logits card vs CPU max "
             f"|diff| {err:.3e} (> {LOGIT_ATOL}?), greedy ids card "
             f"{out_g[:, HYBRID_CHECK_SEQ:].tolist()}, CPU "
             f"{out_c[:, HYBRID_CHECK_SEQ:].tolist()} (smallest CPU top-2 "
             f"gap {float(gaps.min()):.3e})")
    print(f"[58] narrow hybrid: prefill of 1 x {HYBRID_CHECK_SEQ} tokens "
          f"and {HYBRID_CHECK_NEW} greedy steps "
          f"(the SSM state and the k/v ring side by side): logits card vs "
          f"CPU max |diff| {err:.3e} (<= {LOGIT_ATOL}); greedy ids "
          f"{out_g[:, HYBRID_CHECK_SEQ:].tolist()} identical (smallest CPU "
          f"top-2 gap {float(gaps.min()):.3e}); top-k choices of "
          f"{len(rec_g)} router calls "
          + ("identical" if not n_diff else
             f"differ in {n_diff} rows at CPU gaps down to {gap:.2e}: the "
             f"CPU at the card's choices"))
    del small, cb
    step_card_vs_cpu("58", dev, c, 1, HYBRID_STEP_SEQ, pin_routing=True)
    print(f"[58] phase 58 {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


def remat_phase(tag, dev, arch, kernel, all_counts):
    """Phase 59 (mamba2-130m, B5) or 60 (granite-moe-3b-a800m, B4): the
    remat policy "dots" against "full" at full size, bf16.  From one set
    of parameters and one batch, a forward and backward under no remat,
    "dots" and "full" (a MoE's routing under "full" pinned to the choices
    "dots" made): the loss and every gradient leaf of "dots" against
    "full" at phase 20's bars, the products (`aten.mm`/`aten.addmm`, and
    the batched `aten.bmm`) each policy's backward runs beyond the
    backward without remat (`REMAT_RERUN` a layer under "full"; none of
    the first kind under "dots"), the kernel's launches (twice a layer
    under either policy, all wgmma), the memory each forward adds to what
    was held before it ("dots" above "full" by the outputs `keep_dots`
    kept) and each forward and backward's peak above it.  Then `REMAT_STEPS` donating train steps a policy in turns on
    one train state: step ms and peak memory by policy.  Returns the
    kernel's launches over the counted runs."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.training import trainer as T

    class Products(TorchDispatchMode):
        """Counts the matmuls dispatched: aten.mm and aten.addmm (no batch
        dimensions), aten.bmm (batched)."""

        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.n["mm"] += 1
            elif func is torch.ops.aten.bmm.default:
                self.n["bmm"] += 1
            return func(*args, **(kwargs or {}))

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    L = cfg.num_layers
    cfgs = {"none": cfg.replace(remat=False),
            "full": cfg.replace(remat_policy="full"),
            "dots": cfg.replace(remat_policy="dots")}
    t0 = time.perf_counter()
    params = M.init(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    init_s = time.perf_counter() - t0
    batch = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + int(tag),
                       device=dev)
    ctr = all_counts[kernel]
    kept_bytes = []
    keep = M.keep_dots

    def spy(ctx, op, *args, **kwargs):        # the outputs "dots" keeps
        policy = keep(ctx, op, *args, **kwargs)
        if policy == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2:]
            kept_bytes.append(a.shape[0] * b.shape[1] * a.element_size())
        return policy
    out, launches, taps = {}, 0, {}
    t0 = time.perf_counter()
    M.keep_dots = spy
    try:
        for name in ("none", "dots", "full"):
            taps[name] = (moe.Tap(record=True) if name == "dots" else
                          moe.Tap(choices=[i for _, i in
                                           taps["dots"].routes])
                          if name == "full" else moe.Tap())
            for cnt in all_counts.values():
                cnt.reset()            # --- a counted forward and backward ---
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            ps = M.map_params(lambda t: t.detach().requires_grad_(), params)
            loss, _ = M.loss_fn(ps, batch, cfgs[name], taps[name])
            held = torch.cuda.memory_allocated(dev) - base
            forward = ctr.launches
            with Products() as prod:
                grads = torch.autograd.grad(loss, list(M.leaves(ps)))
            torch.cuda.synchronize()
            got = {k: (c.launches, c.plain_calls)
                   for k, c in all_counts.items()}
            routes = dict(ctr.routes)
            # --------------------------------------------------------------
            want = L if name == "none" else 2 * L
            expect = {k: ((want if k == kernel else 0), 0)
                      for k in all_counts}
            if got != expect or forward != L \
                    or routes != {"fma": 0, "wgmma": want} \
                    or ctr.backward_plain != L:
                fail(f"phase {tag} {arch} under {name}: (kernel launches, "
                     f"plain calls) {got}, {forward} in the forward, routes "
                     f"{routes}, {ctr.backward_plain} backward passes; "
                     f"expected {expect}, {L} in the forward, all wgmma, "
                     f"{L} backward passes")
            launches += got[kernel][0]
            out[name] = (loss.detach(), None if name == "none" else grads,
                         dict(prod.n), held,
                         torch.cuda.max_memory_allocated(dev) - base)
            del ps, loss, grads
    finally:
        M.keep_dots = keep
    parity_s = time.perf_counter() - t0
    rerun = {p: {k: out[p][2][k] - out["none"][2][k] for k in ("mm", "bmm")}
             for p in ("full", "dots")}
    mm, bmm = REMAT_RERUN[arch]
    if rerun != {"full": {"mm": mm * L, "bmm": bmm * L},
                 "dots": {"mm": 0, "bmm": bmm * L}}:
        fail(f"phase {tag} {arch}: the backward re-ran {rerun} products "
             f"beyond the backward without remat; expected {mm * L} "
             f"aten.mm/addmm and {bmm * L} aten.bmm under 'full', no "
             f"aten.mm/addmm and {bmm * L} aten.bmm under 'dots'")
    (lf, gf, _, held_f, _), (ld, gd, _, held_d, _) = out["full"], out["dots"]
    kept = sum(kept_bytes)
    if not kept > 0 or not held_d - held_f >= 0.99 * kept:
        fail(f"phase {tag} {arch}: the forward under 'dots' added "
             f"{held_d - held_f:,} B more than under 'full'; the policy "
             f"kept {len(kept_bytes)} outputs of {kept:,} B")
    loss_rel = abs(float(ld) - float(lf)) / abs(float(lf))
    grad_rel = max(float((a.float() - b.float()).norm()
                         / max(float(b.float().norm()), 1e-30))
                   for a, b in zip(gd, gf))
    bitwise = torch.equal(ld, lf) and all(torch.equal(a, b)
                                          for a, b in zip(gd, gf))
    if not loss_rel <= STEP_LOSS_RTOL or not grad_rel <= STEP_GRAD_REL:
        fail(f"phase {tag} {arch}: 'dots' against 'full': loss {float(ld)} "
             f"vs {float(lf)} (rel {loss_rel:.3e}), worst gradient leaf "
             f"{grad_rel:.3e} in relative norm (bars {STEP_LOSS_RTOL}, "
             f"{STEP_GRAD_REL})")
    gib = {p: out[p][4] / 2**30 for p in out}
    print(f"[{tag}] {arch} at full size ({M.param_count(params):,} "
          f"parameters, {cfg.dtype}, {L} layers, made on the card in "
          f"{init_s:.2f} s), batch {TRAIN_BATCH} x {TRAIN_SEQ}, one forward "
          f"and backward from one set of weights and one batch: 'dots' vs "
          f"'full' loss {float(ld):.6f} vs {float(lf):.6f} (rel "
          f"{loss_rel:.2e} <= {STEP_LOSS_RTOL}), worst gradient leaf "
          f"{grad_rel:.3e} in relative norm (<= {STEP_GRAD_REL}) over "
          f"{len(gd)} leaves; "
          + ("bitwise equal" if bitwise else "not bitwise equal")
          + (f"; routing of 'full' pinned to the {len(taps['dots'].routes)} "
             f"router calls of 'dots'" if taps["dots"].routes else ""))
    print(f"[{tag}] {arch} products the backward re-ran beyond the backward "
          f"without remat (aten.mm/addmm, aten.bmm): 'full' "
          f"{rerun['full']['mm']}, {rerun['full']['bmm']}; 'dots' "
          f"{rerun['dots']['mm']}, {rerun['dots']['bmm']}; {kernel} "
          f"launches {2 * L} under each policy ({L} under no remat), all "
          f"wgmma; 'dots' kept {len(kept_bytes)} matmul outputs of "
          f"{kept:,} B ({kept / 2**30:.3f} GiB), and its forward added "
          f"{held_d - held_f:,} B more than 'full''s ({held_f / 2**30:.3f} "
          f"GiB); peak of the forward and backward above what was held "
          f"before it: no remat {gib['none']:.3f} GiB, 'full' "
          f"{gib['full']:.3f} GiB, 'dots' {gib['dots']:.3f} GiB; "
          f"{parity_s:.1f} s for the three")
    del out, gf, gd

    # -- the train step under each policy, in turns, on one state ----------
    t0 = time.perf_counter()
    tcfg = T.TrainConfig(lr=3e-4, warmup=min(20, TRAIN_STEPS // 5 + 1),
                         total_steps=TRAIN_STEPS)
    state = T.train_state_from_params(params, tcfg)
    del params
    steps = {p: T.make_train_step(cfgs[p], tcfg)[0] for p in ("full", "dots")}
    n = REMAT_STEPS[arch]
    order = (["full", "dots", "dots", "full"] * n)[:2 * n]
    ms, peak, losses = ({p: [] for p in steps} for _ in range(3))
    for i, p in enumerate(order):
        b = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 100 + i,
                       device=dev)
        for cnt in all_counts.values():
            cnt.reset()                # --- a counted train step ---
        torch.cuda.reset_peak_memory_stats(dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, metrics = steps[p](state, b)
        e1.record()
        e1.synchronize()
        got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
        # ------------------------------------------------------------------
        expect = {k: ((2 * L if k == kernel else 0), 0) for k in all_counts}
        if got != expect or dict(ctr.routes) != {"fma": 0, "wgmma": 2 * L}:
            fail(f"phase {tag} {arch} train step under {p}: (kernel "
                 f"launches, plain calls) {got}, routes {dict(ctr.routes)}; "
                 f"expected {expect}, all wgmma")
        launches += got[kernel][0]
        ms[p].append(e0.elapsed_time(e1))
        peak[p].append(torch.cuda.max_memory_allocated(dev) / 2**30)
        losses[p].append(float(metrics["loss"]))
    if not np.isfinite(losses["full"] + losses["dots"]).all():
        fail(f"phase {tag} {arch}: non-finite loss in the train steps "
             f"{losses}")
    p50 = {p: float(np.percentile(v, 50)) for p, v in ms.items()}
    top = {p: max(v) for p, v in peak.items()}
    print(f"[{tag}] {arch} train step (AdamW, donating) in turns on one "
          f"state ({' '.join(order)}), each step's own batch: 'full' p50 "
          f"{p50['full']:.3f} ms (" + ", ".join(f"{v:.3f}" for v in
                                                ms["full"])
          + f"), 'dots' p50 {p50['dots']:.3f} ms ("
          + ", ".join(f"{v:.3f}" for v in ms["dots"])
          + f"); dots / full {p50['dots'] / p50['full']:.4f}; peak memory "
          f"'full' {top['full']:.3f} GiB, 'dots' {top['dots']:.3f} GiB "
          f"({top['dots'] - top['full']:+.3f}); {kernel} {2 * L} launches a "
          f"step, all wgmma; every loss finite; "
          f"{time.perf_counter() - t0:.1f} s")
    del state, steps
    torch.cuda.empty_cache()
    print(f"[{tag}] phase {tag} {time.perf_counter() - t_phase:.1f} s")
    return launches


def ckpt_phase(dev, all_counts):
    """Phase 59's checkpoint: `launch.train` (the CLI's `main`, in this
    process) trains mamba2-130m at full size for CKPT_STEPS steps with
    `--ckpt-dir` and writes one checkpoint; `restore_checkpoint` reads it
    back into the returned state's structure, every leaf equal.  Returns
    B5's launches over the CLI's run."""
    import shutil
    import torch
    from repro_torch.checkpoint.store import restore_checkpoint
    from repro_torch.launch import train as train_cli
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    ckpt = os.path.join(ROOT, "build", "repro_torch", "smoke_ckpt_llm")
    shutil.rmtree(ckpt, ignore_errors=True)
    write = train_cli.save_checkpoint
    written = {}

    def timed_write(*args, **kwargs):
        t0 = time.perf_counter()
        path = write(*args, **kwargs)
        written["s"] = time.perf_counter() - t0
        return path
    train_cli.save_checkpoint = timed_write
    for cnt in all_counts.values():
        cnt.reset()                    # --- the counted CLI run ---
    try:
        state = train_cli.main(["--arch", TRAIN_ARCH, "--steps",
                                str(CKPT_STEPS), "--ckpt-dir", ckpt])
    finally:
        train_cli.save_checkpoint = write
    torch.cuda.synchronize()
    got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
    # ----------------------------------------------------------------------
    L = len(state["params"]["periods"]["sub0"]["ssm"]["wz"])
    expect = {k: ((2 * L * CKPT_STEPS if k == "ssd_scan" else 0), 0)
              for k in all_counts}
    path = os.path.join(ckpt, f"step_{CKPT_STEPS:08d}")
    if got != expect or os.listdir(ckpt) != [os.path.basename(path)]:
        fail(f"phase 59 checkpoint: (kernel launches, plain calls) {got}, "
             f"expected {expect}; {ckpt} holds {os.listdir(ckpt)}")
    n_bytes = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path))
    t0 = time.perf_counter()
    back = restore_checkpoint(ckpt, CKPT_STEPS, state)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    pairs = list(zip(M.leaves(back), M.leaves(state)))
    same = all(a.device == b.device and a.dtype == b.dtype
               and torch.equal(a, b) for a, b in pairs)
    if not same or int(back["step"]) != CKPT_STEPS:
        fail(f"phase 59 checkpoint: the restored state differs from the "
             f"one the CLI returned (step {int(back['step'])})")
    print(f"[59] checkpoint: `launch.train --arch {TRAIN_ARCH} --steps "
          f"{CKPT_STEPS} --ckpt-dir` wrote {path} ({n_bytes:,} B: bf16 "
          f"parameters, fp32 moments, int32 steps) in {written['s']:.3f} s "
          f"(the page cache warm); `restore_checkpoint` read it back onto "
          f"the card in {read_s:.3f} s, all {len(pairs)} leaves equal "
          f"(dtype, device, every bit); B5 {got['ssd_scan'][0]} launches "
          f"over the CLI's {CKPT_STEPS} steps, all wgmma")
    shutil.rmtree(ckpt)
    print(f"[59] checkpoint {time.perf_counter() - t_phase:.1f} s")
    return got["ssd_scan"][0]


def time_phase(dev, strict):
    """Phase 4: each kernel, its plain version and the library call timed
    at the main-path shapes, B1 also at the trainer's and B3 at large
    images, and the launch floor.  Returns name -> times.  strict=False
    (`--times` in an earlier checkout) reports a kernel that lacks the
    launch-floor entry or refuses BLUR_BIG_SHAPE instead of failing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import imaging as kimaging
    from repro_torch.kernels.inverse_cdf import inverse_cdf_channels
    from repro_torch.kernels.ref import (BLUR_W0, BLUR_W1, blur2d_ref,
                                         inverse_cdf_ref, mask_apply_ref)

    g = torch.Generator(device="cpu").manual_seed(SEED + 3)

    def sampler_inputs(K, E, C):
        u = torch.rand((K, E, C), generator=g).to(dev)
        mu = (torch.rand((K, C), generator=g) * 4 - 2).to(dev)
        s = (torch.rand((K, C), generator=g) * 0.95 + 0.05).to(dev)
        k = (torch.rand((K, C), generator=g) * 2 - 1).to(dev)
        return u, mu, s, k

    def timed(kernel, plain, library, arg_sets, n_bytes, n_ops):
        """Card and back-to-back times of the kernel, its plain version and
        the library call (None: there is none), cycling `arg_sets`."""
        k, p = rotating(kernel, arg_sets), rotating(plain, arg_sets)
        t = dict(ms=cuda_ms(k, device_only=True),
                 plain_ms=cuda_ms(p, device_only=True),
                 library_ms=None if library is None else cuda_ms(
                     rotating(library, arg_sets), device_only=True),
                 call_ms=cuda_ms(k, device_only=False),
                 plain_call_ms=cuda_ms(p, device_only=False),
                 bytes=n_bytes, ops=n_ops)
        t["bound_ms"], t["bound_by"] = bound(n_bytes, n_ops)
        return t

    def sampler_bytes_ops(u, mu):
        # u in, y out, mu/s/k in; clamp 2, 1-u, divide, log, s*, +, u-0.5,
        # k*, + per element
        return 4 * u.numel() * 2 + 3 * 4 * mu.numel(), 10 * u.numel()

    timing = {}
    u, mu, s, k = sampler_inputs(*MAIN_SHAPE)
    timing["inverse_cdf"] = timed(
        inverse_cdf_channels, inverse_cdf_ref, None, [(u, mu, s, k)],
        *sampler_bytes_ops(u, mu))
    # the launch floor: an empty kernel of csrc/inverse_cdf.cu on the grid
    # the sampler takes at the main-path shape, timed as the kernels are
    try:
        floor_fn = build.load("inverse_cdf").repro_inverse_cdf_floor
    except AttributeError:
        if strict:
            raise
        floor_fn = None
    floor_ms = None
    if floor_fn is not None:
        floor_fn.restype = ctypes.c_int
        floor_fn.argtypes = [ctypes.c_int64, ctypes.c_void_p]

        def empty_kernel():
            if floor_fn(MAIN_SHAPE[0],
                        torch.cuda.current_stream().cuda_stream):
                fail("the empty kernel did not launch")

        floor_ms = cuda_ms(empty_kernel, device_only=True)
    for key, shape in (("inverse_cdf_train", TRAIN_ICDF_SHAPE),
                       ("inverse_cdf_train_c3", TRAIN_ICDF_C3),
                       ("inverse_cdf_train_c4", TRAIN_ICDF_C4)):
        sets = [sampler_inputs(*shape) for _ in range(L2_ROTATION)]
        timing[key] = timed(inverse_cdf_channels, inverse_cdf_ref, None, sets,
                            *sampler_bytes_ops(sets[0][0], sets[0][1]))
        del sets

    m = (torch.rand(MASK_SHAPE[1], generator=g) > 0.4).to(dev, torch.float32)
    sets = [(torch.randn(MASK_SHAPE, generator=g).to(dev), m)
            for _ in range(L2_ROTATION)]
    # x in, y out, m in; one product per element
    timing["mask_apply"] = timed(
        kimaging.mask_apply, mask_apply_ref, lambda x, m: x * m[None], sets,
        2 * 4 * sets[0][0].numel() + 4 * m.numel(), sets[0][0].numel())

    x = torch.randn(BLUR_SHAPE, generator=g).to(dev)
    taps = torch.tensor([BLUR_W1, BLUR_W0, BLUR_W1], device=dev)
    stencil = torch.outer(taps, taps)[None, None]
    cudnn = torch.backends.cudnn

    def library_blur(x):
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            return F.conv2d(x[:, None], stencil, padding=1)[:, 0]

    ok, err = close(library_blur(x), blur2d_ref(x), **FP32)
    if not ok:
        fail(f"the library blur computes another function than the plain "
             f"version (max err {err:.3e})")
    print(f"[4] the library blur (cuDNN conv2d, TF32 off) against the plain "
          f"version: max err {err:.3e} (rtol 1e-4, atol 1e-5; it is timed "
          f"only, never called by the port)")
    # x in, y out; per pixel 2 adds and 2 products in each pass
    for key, shape in (("blur2d", BLUR_SHAPE), ("blur2d_big", BLUR_BIG_SHAPE)):
        sets = [(torch.randn(shape, generator=g).to(dev),)
                for _ in range(L2_ROTATION)]
        try:
            timing[key] = timed(
                kimaging.blur2d, blur2d_ref, library_blur, sets,
                2 * 4 * sets[0][0].numel(), 8 * sets[0][0].numel())
        except RuntimeError as e:
            if strict:
                raise
            print(f"[4] blur2d x{list(shape)}: this checkout's kernel "
                  f"refuses it ({e})")
        del sets

    shapes = {"inverse_cdf": f"inverse_cdf u{list(MAIN_SHAPE)}",
              "inverse_cdf_train": f"inverse_cdf u{list(TRAIN_ICDF_SHAPE)}",
              "inverse_cdf_train_c3": f"inverse_cdf u{list(TRAIN_ICDF_C3)}",
              "inverse_cdf_train_c4": f"inverse_cdf u{list(TRAIN_ICDF_C4)}",
              "mask_apply": f"mask_apply x{list(MASK_SHAPE)}",
              "blur2d": f"blur2d x{list(BLUR_SHAPE)}",
              "blur2d_big": f"blur2d x{list(BLUR_BIG_SHAPE)}"}
    for name, t in timing.items():
        lib = (f"one PyTorch call {t['library_ms']:.5f} ms"
               if t["library_ms"] is not None
               else "no single PyTorch call computes it (library_ms null)")
        print(f"[4] {shapes[name]} fp32, card time: kernel "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, {lib}; bound "
              f"{t['bound_ms']:.6f} ms by {t['bound_by']} ({t['bytes']} B, "
              f"{t['ops']} fp32 ops); {t['bound_ms'] / t['ms']:.1%} of the "
              f"bound reached")
        print(f"[4] {shapes[name]} per call back to back, host launch "
              f"included: kernel wrapper {t['call_ms']:.5f} ms, plain "
              f"{t['plain_call_ms']:.5f} ms")
    if floor_ms is None:
        print("[4] launch floor: this checkout has no empty kernel")
    else:
        print(f"[4] launch floor: an empty kernel of csrc/inverse_cdf.cu on "
              f"the sampler's grid at u{list(MAIN_SHAPE)}: {floor_ms:.5f} ms;"
              f" the sampler there is "
              f"{timing['inverse_cdf']['ms'] - floor_ms:.5f} ms above it")
    print(f"[4] u{list(TRAIN_ICDF_SHAPE)} (and C 3, 4), mask_apply and "
          f"blur2d cycle "
          f"{L2_ROTATION} input sets (a working set above the 50 MB L2); "
          f"inverse_cdf at u{list(MAIN_SHAPE)} reuses one, as the service "
          f"does")

    return timing


def main():
    import torch
    times_only = sys.argv[1:] == ["--times"]
    if sys.argv[1:] and not times_only:
        print(f"usage: {sys.argv[0]} [--times]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.checkpoint.store import (conv_generator_from_numpy,
                                              load_generator_stack)
    from repro_torch.configs.serving import DEFAULT
    from repro_torch.core import gan
    from repro_torch.core.workflow import make_solver, solve_draws
    from repro_torch.kernels import build
    from repro_torch.kernels import imaging as kimaging
    from repro_torch.kernels.inverse_cdf import (counts, inverse_cdf,
                                                 inverse_cdf_channels)
    from repro_torch.kernels.ref import (blur2d_ref, inverse_cdf_ref,
                                         mask_apply_ref)
    from repro_torch.models import convgen
    from repro_torch.problems import get_problem
    from repro_torch.problems.imaging import SIGMA as IMAGING_SIGMA
    from repro_torch.serving import SolveService

    dev = torch.device("cuda")
    t_script = time.perf_counter()

    def clock(phases):
        print(f"[t] phases {phases} done, {time.perf_counter() - t_script:.1f}"
              f" s into the script", flush=True)
    # fp32 matmuls in full fp32 (TF32 off, PyTorch's default), as the CPU
    # comparison needs.  cuDNN's TF32 flag is left as it stands: the conv
    # generator switches it off around its own call, and phase 8 checks
    # that the flag is unchanged afterwards.
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ssd_scan as kssd
    all_counts = {"inverse_cdf": counts, "mask_apply": kimaging.mask_counts,
                  "blur2d": kimaging.blur_counts,
                  "flash_attention": kflash.counts, "ssd_scan": kssd.counts}

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"
    cap = torch.cuda.get_device_capability(0)
    print(f"[1] card: {smi_line} | capability sm_{cap[0]}{cap[1]} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | python "
          f"{sys.version.split()[0]} | cudnn.allow_tf32 {cudnn_tf32}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[2] built {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
          f"(nvcc: {build.build_seconds})")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[2]   {name}: {line.strip()}")

    if times_only:
        time_phase(dev, strict=False)
        print(smi_line)
        return 0

    # -- 3. kernels against their plain versions -----------------------------
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def sampler_inputs(K, E, C, udtype, pdtype=torch.float32):
        u = torch.rand((K, E, C), generator=g).to(dev, udtype)
        mu = (torch.rand((K, C), generator=g) * 4 - 2).to(dev, pdtype)
        s = (torch.rand((K, C), generator=g) * 0.95 + 0.05).to(dev, pdtype)
        k = (torch.rand((K, C), generator=g) * 2 - 1).to(dev, pdtype)
        return u, mu, s, k

    def unaligned(t, offset):
        """t's values in a contiguous view `offset` elements into a new
        buffer: its rows are not 16-byte aligned."""
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        buf[offset:] = t.flatten()
        return buf[offset:].view(t.shape)

    # (shape, u dtype, param dtype, elements u lies into its buffer)
    cases = [(MAIN_SHAPE, torch.float32, torch.float32, 0),
             (MAIN_SHAPE, torch.bfloat16, torch.float32, 0),
             ((2048, 64, 1), torch.float32, torch.float32, 0),
             (TRAIN_ICDF_SHAPE, torch.float32, torch.float32, 0),
             (TRAIN_ICDF_SHAPE, torch.bfloat16, torch.bfloat16, 0),
             (TRAIN_ICDF_SHAPE, torch.float32, torch.float32, 1),
             (PROC_ICDF_SHAPE, torch.float32, torch.float32, 0),
             (TRAIN_ICDF_SHAPE, torch.bfloat16, torch.float32, 3),
             ((8192, 100, 1), torch.float32, torch.float32, 0),
             (TRAIN_ICDF_C3, torch.float32, torch.float32, 0),
             (TRAIN_ICDF_C3, torch.bfloat16, torch.float32, 1),
             (TRAIN_ICDF_C4, torch.float32, torch.float32, 0),
             (TRAIN_ICDF_C4, torch.float32, torch.float32, 3),
             ((300, 7, 3), torch.float32, torch.float32, 0),
             ((300, 7, 3), torch.bfloat16, torch.float32, 1),
             ((64, 100, 5), torch.float32, torch.bfloat16, 0),
             ((1000, 77, 1), torch.float32, torch.float32, 0),
             ((1000, 77, 1), torch.bfloat16, torch.float32, 0),
             ((3, 5, 2), torch.float32, torch.float32, 0),
             ((3, 5, 2), torch.bfloat16, torch.bfloat16, 0)]
    max_err = {}
    for shape, udtype, pdtype, offset in cases:
        u, mu, s, k = sampler_inputs(*shape, udtype, pdtype)
        if shape == (3, 5, 2):      # the clamp's edges and NaN
            u[0, :, 0] = torch.tensor([0.0, 1.0, -1.0, 2.0, float("nan")])
        if offset:
            u = unaligned(u, offset)
        y = inverse_cdf_channels(u, mu, s, k)
        torch.cuda.synchronize()
        ref = inverse_cdf_ref(u, mu, s, k)
        tol = FP32 if udtype == torch.float32 else BF16
        ok, err = close(y, ref, **tol)
        at = f", {offset} elements into its buffer" if offset else ""
        print(f"[3] inverse_cdf u{list(shape)} {str(udtype)[6:]} (params "
              f"{str(pdtype)[6:]}{at}): max |kernel - plain| = {err:.3e} "
              f"(rtol {tol['rtol']}, atol {tol['atol']}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok or y.dtype != udtype or y.shape != u.shape:
            fail(f"inverse_cdf kernel disagrees with its plain version at "
                 f"{shape} {udtype}{at}")
        if shape == MAIN_SHAPE and udtype == torch.float32:
            max_err["inverse_cdf"] = err
    # the imaging readout's call in training: the 2-D entry on the noise
    # channel of u [512, 32, 2], mu = k = 0, s = SIGMA; [64, 32] in one
    # proc worker (phase 39)
    for shape in (TRAIN_READOUT_SHAPE, PROC_READOUT_SHAPE):
        u = torch.rand(shape + (2,), generator=g).to(dev)
        u = u[..., 1].contiguous()
        zeros = torch.zeros(shape[0], device=dev)
        s = torch.full((shape[0],), IMAGING_SIGMA, device=dev)
        y = inverse_cdf(u, zeros, s, zeros)
        torch.cuda.synchronize()
        ok, err = close(y, inverse_cdf_ref(u, zeros, s, zeros), **FP32)
        if not ok or y.shape != u.shape:
            fail(f"inverse_cdf kernel disagrees with its plain version at "
                 f"the imaging readout's u{list(u.shape)} (max {err:.3e})")
        print(f"[3] inverse_cdf u{list(u.shape)} float32 through the 2-D "
              f"entry (imaging training's readout noise, s "
              f"{IMAGING_SIGMA}): max |kernel - plain| = {err:.3e} (rtol "
              f"1e-4, atol 1e-5) ok")

    for shape, dtype, mdtype in [(MASK_SHAPE, torch.float32, torch.float32),
                                 (MASK_SHAPE, torch.bfloat16, torch.float32),
                                 (TRAIN_MASK_SHAPE, torch.float32,
                                  torch.float32),
                                 ((257, 130), torch.float32, torch.bfloat16),
                                 ((7, 100), torch.bfloat16, torch.bfloat16),
                                 ((1, 32), torch.float32, torch.float32)]:
        x = torch.randn(shape, generator=g).to(dev, dtype)
        m = (torch.rand(shape[1], generator=g) > 0.4).to(dev, mdtype)
        want = mask_apply_ref(x, m)
        for threads in (32, 96, 256, 1024):
            y = kimaging.mask_apply(x, m, threads=threads)
            torch.cuda.synchronize()
            if y.dtype != dtype or not torch.equal(y, want):
                fail(f"mask_apply kernel is not bitwise its plain version at "
                     f"{shape} {dtype} (mask {mdtype}), {threads} threads")
        print(f"[3] mask_apply x{list(shape)} {str(dtype)[6:]} (mask "
              f"{str(mdtype)[6:]}): bitwise equal to the plain version at "
              f"32, 96, 256 and 1024 threads per block")
        if shape == MASK_SHAPE and dtype == torch.float32:
            max_err["mask_apply"] = float((y - want).abs().max())

    # (shape, dtype, elements x lies into its buffer)
    for shape, dtype, offset in [(BLUR_SHAPE, torch.float32, 0),
                                 (BLUR_SHAPE, torch.bfloat16, 0),
                                 (TRAIN_BLUR_SHAPE, torch.float32, 0),
                                 (PROC_BLUR_SHAPE, torch.float32, 0),
                                 (BLUR_BIG_SHAPE, torch.float32, 0),
                                 (BLUR_BIG_SHAPE, torch.bfloat16, 0),
                                 (BLUR_BIG_SHAPE, torch.float32, 1),
                                 ((3, 130, 77), torch.float32, 0),
                                 ((3, 130, 77), torch.bfloat16, 0),
                                 (BLUR_SHAPE, torch.float32, 1),
                                 ((33, 64, 48), torch.float32, 0),
                                 ((20, 16, 24), torch.bfloat16, 0),
                                 ((1, 8, 8), torch.float32, 0)]:
        x = torch.randn(shape, generator=g).to(dev, dtype)
        if offset:
            x = unaligned(x, offset)
        want = blur2d_ref(x)
        worst, first = 0.0, None
        for rows in BLUR_ROWS:
            y = kimaging.blur2d(x, rows=rows)
            torch.cuda.synchronize()
            ok, err = close(y, want, **BLUR)
            worst = max(worst, err)
            first = y if first is None else first
            if not ok or y.dtype != dtype or not torch.equal(y, first):
                fail(f"blur2d kernel disagrees with its plain version, or "
                     f"with itself at another band height, at {shape} "
                     f"{dtype}, {rows} rows per band (max {err:.3e})")
        at = f", {offset} element into its buffer" if offset else ""
        print(f"[3] blur2d x{list(shape)} {str(dtype)[6:]}{at}: max |kernel "
              f"- plain| = {worst:.3e} over band heights {BLUR_ROWS} "
              f"(rtol/atol 1e-6; bitwise the same at each) ok")
        if shape == BLUR_SHAPE and dtype == torch.float32 and not offset:
            max_err["blur2d"] = worst

    # the backward of B2 (PyTorch's x·m on the cotangent) and B3 (the blur
    # kernel on the cotangent) at the training shapes, against autograd
    # through the plain versions
    m = (torch.rand(TRAIN_MASK_SHAPE[1], generator=g) > 0.4).to(dev)
    for name, fn, ref, shape in (
            ("mask_apply", lambda x: kimaging.mask_apply(x, m.float()),
             lambda x: mask_apply_ref(x, m.float()), TRAIN_MASK_SHAPE),
            ("blur2d", kimaging.blur2d, blur2d_ref, TRAIN_BLUR_SHAPE),
            ("blur2d", kimaging.blur2d, blur2d_ref, PROC_BLUR_SHAPE)):
        x = torch.randn(shape, generator=g).to(dev)
        ct = torch.randn(shape, generator=g).to(dev)
        cnt = all_counts[name]
        before = cnt.backward_launches
        got, = torch.autograd.grad(fn(x.requires_grad_()), x, ct)
        torch.cuda.synchronize()
        want, = torch.autograd.grad(ref(x), x, ct)
        ok, err = close(got, want, **BLUR)
        launched = cnt.backward_launches - before
        if not ok or launched != (name == "blur2d"):
            fail(f"{name}'s backward at x{list(shape)} differs from autograd "
                 f"through the plain version by {err:.3e}, or launched the "
                 f"kernel {launched} times")
        print(f"[3] {name} backward x{list(shape)} float32 (training's "
              f"shape; {'the blur kernel' if launched else 'PyTorch'} on the "
              f"cotangent): max |kernel - autograd of plain| = {err:.3e} "
              f"(rtol/atol 1e-6) ok")

    # -- 4. time at the main-path shapes -------------------------------------
    timing = time_phase(dev, strict=True)
    clock("1-4")

    # -- the served paths ----------------------------------------------------
    def make_requests(problem):
        """8 requests per bucket, made on the card before the counted run."""
        rng = np.random.default_rng(SEED)
        gdata = torch.Generator(device="cpu").manual_seed(SEED + 1)
        out = []
        for lo, hi in zip((0,) + DEFAULT.buckets[:-1], DEFAULT.buckets):
            for _ in range(8):
                n_ev = int(rng.integers(lo + 1, hi + 1))
                out.append(problem.make_reference_data(
                    gdata, n_ev, device=dev).cpu().numpy())
        torch.cuda.synchronize()
        return out

    def serve(tag, name, requests, forward, **registration):
        """Serve `requests` through a fresh DEFAULT service, with every
        kernel count set to 0 just before and read just after.  Fails
        unless each solver call launched the sampler and `forward` (None:
        no other kernel) once and nothing took a plain version."""
        for c in all_counts.values():
            c.reset()                  # --- the counted main-path run ---
        t0 = time.perf_counter()
        svc = SolveService(DEFAULT, device=dev)
        step = svc.register_problem(name, **registration)
        svc.warm(name)
        warm_s = time.perf_counter() - t0
        lat, results, batches = {}, [], 0
        for y in requests:
            t1 = time.perf_counter()
            ticket = svc.submit(name, y)
            while svc.step():
                batches += 1
            results.append(ticket.result(timeout=60))
            lat.setdefault(ticket.bucket, []).append(
                time.perf_counter() - t1)
        got = {k: (c.launches, c.plain_calls) for k, c in all_counts.items()}
        # ------------------------------------------------------------------
        calls = svc.cache.stats["compiles"] + batches
        want = {k: ((calls if k in ("inverse_cdf", forward) else 0), 0)
                for k in all_counts}
        if got != want:
            fail(f"{name}: (kernel launches, plain calls) {got} for {calls} "
                 f"solver calls; expected {want}")
        problem = get_problem(name)
        for r in results:
            if not all(np.isfinite(v).all() for v in r.values()):
                fail(f"{name}: non-finite solve result")
            if r["params"].shape != (problem.n_params,) \
                    or not ((r["params"] > 0) & (r["params"] < 1)).all() \
                    or (r["sigma"] < 0).any():
                fail(f"{name}: params outside (0, 1), of the wrong shape, "
                     f"or negative sigma")
        print(f"[{tag}] {name}: served {svc.served} requests in {batches} "
              f"batches; warm pool of {len(svc.cache)} built in "
              f"{warm_s:.2f}s")
        print(f"[{tag}] {name} on the main path, per kernel (launches, plain "
              f"calls) for {calls} solver calls: {got}")
        first = problem.mean_abs_residual(
            torch.from_numpy(results[0]["params"]))
        print(f"[{tag}] {name} first solve: residual {float(first):.3f} "
              f"(random weights), score {float(results[0]['score']):.3f}")
        for b in DEFAULT.buckets:
            xs_ms = np.asarray(lat[b]) * 1e3
            print(f"[{tag}] {name} bucket {b:5d}: {len(xs_ms)} requests, "
                  f"request latency p50 {np.percentile(xs_ms, 50):.3f} ms, "
                  f"p99 {np.percentile(xs_ms, 99):.3f} ms")
        return svc, step, lat, got

    def card_vs_cpu(tag, name, stack, requests):
        """One DEFAULT batch (bucket 256) on the card and on the CPU with
        the same draws: scores at fp32 tolerance, kept sets equal up to
        near-ties, params/sigma/score at fp32 tolerance where equal."""
        problem = get_problem(name)
        cfg = DEFAULT.solve
        noise, u_draw = solve_draws(cfg, RANKS, problem, "cpu")
        bucket, B = DEFAULT.buckets[1], DEFAULT.max_batch
        ys = np.zeros((B, bucket, problem.obs_dim), np.float32)
        mask = np.zeros((B, bucket), bool)
        for i in range(B):
            y = requests[8 + i]
            ys[i, :len(y)], mask[i, :len(y)] = y, True
        outs = {}
        for d in ("cpu", "cuda"):
            solver = make_solver(problem, cfg, (noise.to(d), u_draw.to(d)))
            st = gan.map_leaves(lambda t: t.to(d), stack)
            ys_d = torch.from_numpy(ys).to(d)
            m_d = torch.from_numpy(mask).to(d)
            _, scores = solver.scores(st, ys_d, m_d)
            kept = torch.topk(scores, solver.keep(RANKS), dim=1).indices
            outs[d] = (scores.cpu(), kept.cpu(), {
                k: v.cpu() for k, v in solver(st, ys_d, m_d).items()})
        (s_cpu, k_cpu, o_cpu), (s_gpu, k_gpu, o_gpu) = outs["cpu"], outs["cuda"]
        ok, err = close(s_gpu, s_cpu, **FP32)
        if not ok:
            fail(f"{name}: candidate scores differ between card and CPU "
                 f"(max {err:.3e})")
        same_rows = []
        for b in range(B):
            diff = set(k_cpu[b].tolist()) ^ set(k_gpu[b].tolist())
            kth = torch.sort(s_cpu[b], descending=True).values[
                k_cpu.shape[1] - 1]
            if any(abs(float(s_cpu[b, i] - kth)) >= TIE_GAP for i in diff):
                fail(f"{name} request {b}: kept sets differ beyond "
                     f"near-ties")
            if not diff:
                same_rows.append(b)
        worst = 0.0
        for key in ("params", "sigma", "score"):
            ok, err = close(o_gpu[key][same_rows], o_cpu[key][same_rows],
                            **FP32)
            worst = max(worst, err)
            if not ok:
                fail(f"{name}: {key} differs between card and CPU (max "
                     f"{err:.3e})")
        print(f"[{tag}] {name}: one DEFAULT batch (B={B}, bucket {bucket}, "
              f"R={RANKS}) on the card vs the CPU: scores max err "
              f"{float((s_gpu - s_cpu).abs().max()):.3e}, params/sigma/score "
              f"max err {worst:.3e} on {len(same_rows)}/{B} requests with "
              f"identical kept sets (the rest differ only at near-ties "
              f"< {TIE_GAP})")

    def profile(tag, svc, name, requests, lat):
        """Where the card's time goes over 8 bucket-256 requests."""
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for y in requests[8:16]:
                ticket = svc.submit(name, y)
                svc.run_until_empty()
                ticket.result(timeout=60)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not on_card:
            print(f"[{tag}] {name}: the profiler recorded no device events: "
                  f"the card's busy share is not measured")
            return
        busy = {}
        for e in on_card:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
        total = sum(busy.values())
        p50_us = float(np.percentile(lat[DEFAULT.buckets[1]], 50)) * 1e6
        print(f"[{tag}] {name}, 8 bucket-256 requests: {wall_us / 8:.1f} us "
              f"each on the host clock under the profiler, card busy "
              f"{total / 8:.1f} us each ({100 * total / wall_us:.1f}% of the "
              f"profiled time, {100 * total / 8 / p50_us:.1f}% of the "
              f"unprofiled p50 {p50_us:.1f} us; {len(on_card) / 8:.0f} device "
              f"ops per request)")
        for kname in ("icdf_kernel", "mask_kernel", "blur_kernel"):
            us = [e.time_range.elapsed_us() for e in on_card
                  if kname in e.name]
            if us:
                print(f"[{tag}]   {kname}: {statistics.median(us):.2f} us "
                      f"per launch ({len(us)} launches)")
        for kname, us in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[{tag}]   {us / 8:8.2f} us/request "
                  f"({100 * us / total:4.1f}%)  {kname[:90]}")

    # -- 5-7. proxy1d --------------------------------------------------------
    problem = get_problem("proxy1d")
    ckpt = os.path.join(ROOT, "build", "repro_torch", "smoke_ckpt")
    written = write_stack(ckpt, gan.gen_widths(problem.n_params), RANKS)
    requests = make_requests(problem)
    svc, step, lat, got = serve("5", "proxy1d", requests, None,
                                checkpoint_dir=ckpt)
    launches = {"inverse_cdf": got["inverse_cdf"][0]}
    stack, _ = load_generator_stack(ckpt, dev)
    for i, layer in enumerate(stack):
        if not np.array_equal(layer["w"].cpu().numpy(), written[f"gen/{i}/w"]):
            fail(f"layer {i} of the loaded stack differs from the stored one")
    if step != 1 or gan.param_count(stack) != RANKS * 51206:
        fail(f"loaded step {step}, {gan.param_count(stack)} parameters")
    print(f"[5] proxy1d stack {RANKS}x{gan.param_count(stack) // RANKS} "
          f"params from checkpoint step {step}")
    card_vs_cpu("6", "proxy1d", stack, requests)
    profile("7", svc, "proxy1d", requests, lat)

    # -- 8-10. imaging and imaging_blur --------------------------------------
    for name, forward in (("imaging", "mask_apply"),
                          ("imaging_blur", "blur2d")):
        problem = get_problem(name)
        shapes_one = convgen.leaf_shapes(problem.param_shape, gan.NOISE_DIM)
        arrays = conv_stack_arrays(shapes_one, RANKS)
        stack = conv_generator_from_numpy(arrays, dev)
        if gan.param_count(stack) != RANKS * 292545:
            fail(f"{name}: conv stack of {gan.param_count(stack)} parameters")
        requests = make_requests(problem)
        svc, _, lat, got = serve("8", name, requests, forward,
                                 gen_stack=stack)
        launches["inverse_cdf"] += got["inverse_cdf"][0]
        launches[forward] = got[forward][0]
        if torch.backends.cudnn.allow_tf32 != cudnn_tf32:
            fail(f"{name}: the solve changed cudnn.allow_tf32 to "
                 f"{torch.backends.cudnn.allow_tf32}")
        print(f"[8] {name}: stack {RANKS}x292545 conv params from numpy; "
              f"cudnn.allow_tf32 still {cudnn_tf32} after serving")
        card_vs_cpu("9", name, stack, requests)
        profile("10", svc, name, requests, lat)

    clock("5-10")
    # -- 11-15. flash attention and the LLM engine ---------------------------
    max_err["flash_attention"], timing["flash_attention"] = flash_phases(dev)
    launches["flash_attention"] = llm_phases(dev, all_counts)

    clock("11-15")
    # -- 16-21. the SSD scan, gradients, and LLM training --------------------
    max_err["ssd_scan"], ssd_timing = ssd_phases(dev)
    timing["ssd_scan"] = ssd_timing["training"]
    grad_phase(dev, all_counts)
    launches["ssd_scan"] = train_phases(dev, all_counts)

    clock("16-21")
    # -- 22-24. the paper's GAN training -------------------------------------
    n, gan_fp32 = gan_phases(dev, all_counts)
    launches["inverse_cdf"] += n

    clock("22-24")
    # -- 25. serve proxy2d and linear_blur -----------------------------------
    for name in PROBLEMS_SERVED:
        problem = get_problem(name)
        widths = gan.gen_widths(problem.n_params)
        ckpt = os.path.join(ROOT, "build", "repro_torch", f"smoke_ckpt_{name}")
        written = write_stack(ckpt, widths, RANKS)
        requests = make_requests(problem)
        _, step, _, got = serve("25", name, requests, None,
                                checkpoint_dir=ckpt)
        launches["inverse_cdf"] += got["inverse_cdf"][0]
        stack, _ = load_generator_stack(ckpt, dev)
        per_rank = sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
        for i, layer in enumerate(stack):
            if not np.array_equal(layer["w"].cpu().numpy(),
                                  written[f"gen/{i}/w"]):
                fail(f"{name}: layer {i} of the loaded stack differs from "
                     f"the stored one")
        if step != 1 or gan.param_count(stack) != RANKS * per_rank:
            fail(f"{name}: loaded step {step}, {gan.param_count(stack)} "
                 f"parameters")
        print(f"[25] {name} stack {RANKS}x{per_rank} params (widths "
              f"{widths}) from checkpoint step {step}")
        card_vs_cpu("25", name, stack, requests)

    # -- 26-28. every other problem trained ----------------------------------
    problem_launches, problem_p50 = problem_phases(dev, all_counts)
    for k, n in problem_launches.items():
        launches[k] = launches.get(k, 0) + n

    clock("25-28")
    # -- 29-33. the MoE family -----------------------------------------------
    launches["flash_attention"] += moe_phases(dev, all_counts)

    clock("29-33")
    # -- 34-35. the GAN as worker processes (B1: the workers' launches) -----
    n, proc_p50, proc_states, proc_free_p50 = proc_phases(
        dev, all_counts, {m: v[0] for m, v in gan_fp32.items()})
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v

    clock("34-35")
    # -- 36-37. the bf16 ring payload, stacked and as worker processes ------
    n, bf16_p50 = bf16_phases(dev, all_counts, gan_fp32,
                              problem_p50["imaging_blur"])
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v

    clock("36-37")
    # -- 38-39. the chunked ring, stacked and as worker processes -----------
    n = chunked_phases(dev, all_counts, gan_fp32, bf16_p50,
                       problem_p50["imaging_blur"], proc_states, proc_p50)
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v

    clock("38-39")
    # -- 40-41. the update cadences, stacked and as worker processes -------
    n = cadence_phases(dev, all_counts, gan_fp32,
                       problem_p50["imaging_blur"], proc_p50)
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v

    clock("40-41")
    # -- 42-43. the depth-k RMA mailbox, stacked and as worker processes ----
    n, depth_p50 = depth_phases(dev, all_counts, gan_fp32,
                                problem_p50["imaging_blur"], proc_p50)
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v

    clock("42-43")
    # -- 44-45. the telemetry, stacked and as worker processes -------------
    n = obs_phases(dev, all_counts, gan_fp32, depth_p50, proc_p50,
                   proc_free_p50)
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v

    clock("44-45")
    # -- 46-47. the overlapped pod boundary, stacked and as workers --------
    n = overlap_phases(dev, all_counts, gan_fp32,
                       problem_p50["imaging_blur"], proc_p50)
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v

    clock("46-47")
    # -- 48-49. adaptive staleness, stacked and as workers -----------------
    n = adaptive_phases(dev, all_counts, gan_fp32,
                        problem_p50["imaging_blur"])
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v

    clock("48-49")
    # -- 50-52. the audio family: hubert-xlarge encoded and trained ---------
    n, err = hubert_phases(dev, all_counts)
    launches["flash_attention"] += n
    max_err["flash_attention"] = max(max_err["flash_attention"], err)

    clock("50-52")
    # -- 53-55. the vlm family: internvl2-1b served and trained ------------
    n, err = vlm_phases(dev, all_counts)
    launches["flash_attention"] += n
    max_err["flash_attention"] = max(max_err["flash_attention"], err)

    clock("53-55")
    # -- 56-58. the hybrid family: jamba-1.5-large-398b served and scored ---
    n, err = hybrid_phases(dev, all_counts)
    for k, v in n.items():
        launches[k] += v
        max_err[k] = max(max_err[k], err[k])

    clock("56-58")
    # -- 59-60. the remat policy "dots" and the LLM trainer's checkpoint ----
    launches["ssd_scan"] += remat_phase("59", dev, TRAIN_ARCH, "ssd_scan",
                                        all_counts)
    launches["ssd_scan"] += ckpt_phase(dev, all_counts)
    launches["flash_attention"] += remat_phase(
        "60", dev, MOE_TRAIN_ARCH, "flash_attention", all_counts)

    clock("59-60")
    # -- the kernels ---------------------------------------------------------
    sources = {"inverse_cdf": ("src/repro_torch/kernels/csrc/inverse_cdf.cu",
                               "src/repro/kernels/inverse_cdf.py:23"),
               "mask_apply": ("src/repro_torch/kernels/csrc/imaging.cu",
                              "src/repro/kernels/imaging.py:45"),
               "blur2d": ("src/repro_torch/kernels/csrc/imaging.cu",
                          "src/repro/kernels/imaging.py:87"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                   "src/repro/kernels/flash_attention.py:34"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
                            "src/repro/kernels/ssd_scan.py:25")}
    kernels = []
    for name, (source, replaces) in sources.items():
        if launches.get(name, 0) < 1:
            fail(f"{name} was launched no time on the main paths")
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
