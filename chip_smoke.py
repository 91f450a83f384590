#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--wide-parent DIR]

Phases (each prints its own lines; any failure exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a, one process per source, all started together) and report the
   build time;
3. training, the first main path, at the paper's full width (GCN, hidden
   128, 3 layers, k 1024, f_prod 4) on a 169,343-node ogbn-arxiv
   look-alike: ``train_vq`` for 70 epochs of 5 batches of 42,335 nodes
   (``paper_batch_size``; the fifth is the wrap-padded tail) from seed
   0, the kernels' launch counters reset before and read after and
   checked exactly; per-step loss and VQ error, epoch seconds, val/test
   accuracy; the losses must be finite and fall on average, and no
   layer's codebook may end collapsed; then 8 timed steps (step ms
   p50/p99) and a torch.profiler window over 2 steps;
4. hold every kernel against its plain PyTorch version on the card at
   every shape the main paths give it, on operands taken from the
   trained model: vq_update on the whitened (X || G) rows of a training
   batch at both branch geometries (its sums also exact on rows rounded
   so that fp32 sums are exact in any order), the w_t form of
   context_ell and spmm_ell_t on that batch's reverse-edge and
   intra-batch operands, spmm_ell on that batch's intra-batch operands
   and, forced, on the full graph (the evaluation's SpMM, whose 86.7 MB
   source the dispatch sends to the staged kernel, phase 12), the plain
   form of
   context_ell on that batch's forward operands, and the serving shapes
   of vq_assign (its ``want_min`` output too), spmm_ell and
   context_ell; timing kernel, plain version
   and -- where one PyTorch call computes the same function -- that
   call, with CUDA events; spmm_ell bit for bit at every shape, and
   timed also with every slot gathered (its padding not skipped);
   vq_assign's index and ``want_min`` bit for bit (agreement 1.0), with
   the bounds of its 3xTF32 products and compare-selects; spmm_ell_t
   within the scatter-order bound, with its operands' live-slot share and
   largest in-degree, and also checked and timed with half the live
   slots moved onto one hub row;
5. one training step at batch 4,096 on the card and the same step on the
   CPU plain path from the trained state copied over: loss, params,
   optimizer and codebook state must agree;
6. serving, the second main path, with the trained weights:
   ``GNNServer.refresh``, then ``warmup`` and ``drain_requests`` over 200
   requests of U[1, 64] nodes, launch counters checked exactly;
7. copy the served state to the CPU and serve the same requests through
   the plain versions there; the served rows must agree;
8. a torch.profiler window over 20 serve steps: the device's busy share
   of the wall time and the kernels that take it;
9. sampler-train, the sampling baselines: ``train_scenario`` with
   ``ns_sage``, ``labor``, ``cluster`` and ``saint`` on the same graph and
   model (Adam 1e-3, the reference's scenario defaults: seed batches of
   42,335, fanout 5 a layer, walk length 3, 32 parts with 4 a batch), 2
   epochs each and one full-graph evaluation; every SpMM of the sampled
   subgraphs runs the staged kernel (spmm_ell_hbm: NS-SAGE and LABOR at
   262,144 padded rows, GraphSAINT at 131,072) except Cluster-GCN's
   (32,768 rows, the resident spmm_ell), the counts exact; the losses
   must be finite and the last epoch's mean loss under the first's; the
   host's sampling seconds apart from the device steps';
10. hybrid-train, the VQ/sampling hybrid: ``train_scenario`` with
   ``hybrid`` (42,335 seeds plus 42,335 LABOR-sampled context slots a
   batch, whose 43.3 MB intra-batch source stays resident) for 2 epochs,
   counts exact, losses finite and the last epoch's mean under the
   first's (the collapse gate needs phase 3's 70 epochs); then one
   hybrid step (4,096 seeds, 4,096 context slots) card vs CPU as in
   phase 5, and every step kernel against its plain version on one
   hybrid batch of 84,670 rows, and spmm_ell_t (and Cluster-GCN's
   resident spmm_ell) on the first NS-SAGE, GraphSAINT and Cluster-GCN
   subgraphs;
11. sampler-parity: one NS-SAGE step at n 20,000 on the card, the staged
   kernel forced by a 1 MiB budget, and on the CPU plain path from the
   same params: loss, params and Adam moments ``rtol=1e-4, atol=1e-5``;
12. staged-kernel: spmm_ell_hbm at the full graph (169,343 x 128, with
   the host-built index the main path's operands carry) and at the first
   NS-SAGE (262,144 rows) and GraphSAINT (131,072 rows) subgraphs (the
   index built on the device in the call, as their steps build it), f32,
   and with int8 and fp8 sources at the full graph: bit for bit against
   its plain version, timed beside the resident kernel forced onto the
   same operands and ``torch.sparse.mm``, with the index builds' times
   and the bytes the function needs at the achieved rate;
13. tier-train, the third main path: the same model with k = 256 (the
   paper's alternative codebook size, the largest a uint8 table holds)
   trained by ``train_vq`` under the int8 tier for the same 70 epochs --
   uint8 tables, int8 codeword snapshots requantized after every update,
   the quantized forms of context_ell and its w_t epilogue in place of
   the f32 ones, launch counts exact, the same gates as phase 3, the
   states ending in the tier's storage -- and one step at batch 4,096
   card vs CPU under int8 and under fp8 (the state converted by
   ``quantize_vq_states``), the requantized snapshots within two quanta;
14. tier-serve: the tier-trained state served as trained (int8) and
   converted to fp8, each with refresh, the 200 requests (counts exact),
   CPU parity and ``vq_inference`` over every node agreeing with the
   fp32 inference of the same state on >= 95 % of the argmaxes;
15. a4-serve: k = 16 from the seed's initial state (no training) under
   int8, int8+a4 and fp8+a4, each with refresh, the requests (counts
   exact) and CPU parity; the packed tables must be the int8 tables
   packed and the int8+a4 rows bit-equal to the int8 rows;
16. every quantized kernel form against its plain version, bit for bit,
   and timed: context_ell and its w_t form with int8 / fp8 codewords over
   uint8, packed and int32 tables at the serving and the training batch,
   spmm_ell's int8 / fp8 source, vq_update's uint8 emit;
17. lm-serve, the LM decode path: ``repro_torch.launch.serve``'s
   functions at the full width of llama3.2-3b (28 layers, d 3072, bf16,
   random weights from a seeded generator on the card), batch 4: 192
   greedy steps with VQ-Attention (k 128, window 64: evictions from
   position 64 on fill the codebook), then 64 with the exact cache at
   context 1024; finite logits, ``vq_attention`` launched exactly 28
   times per VQ step and never on the exact path, every head's codebook
   mass equal to its evictions; tok/s, step p50/p99 and cache bytes on a
   ``{"lm_serve": ...}`` line, and a torch.profiler window over 4 VQ
   steps;
18. lm-parity: the same width at 2 layers in f32, the weights copied to
   the CPU, 96 teacher-forced VQ steps (32 evictions) on the card and on
   the CPU plain path: logits ``rtol=1e-4, atol=1e-4`` and codebook
   counts equal at every step, TF32 off;
19. lm-kernels: ``vq_attention`` at the path's shape on the path's own
   cache (bf16 and f32) and at the config defaults (n 1024, k 1024, w
   512), ``flash_attention`` at llama3.2-3b's ``[1, 24, 4096, 128]``
   causal and ``[1, 24, 1024, 128]`` non-causal on both routes: bf16 on
   the tensor-core kernel, f32 on the FMA kernel; bf16 outputs within 2
   bf16 ulps of the plain version, f32 ``rtol=1e-5, atol=1e-6``; timed
   with SDPA as the library call, vq_attention at the path's shape also
   at other counts of blocks a group (``splits``);
20. gat-train: GAT (heads 4) at the same width on the same graph,
   ``train_vq`` for 10 epochs of 5 batches of 42,335 from seed 0 with the
   Eq. 7 injection on and one full-graph evaluation: every codebook
   update on the wide build of vq_update (branches of 65 and 43), no
   spmm_ell, context_ell or spmm_ell_hbm launch, counts exact; losses
   finite (with the injection on the loss rises over these epochs in the
   reference too, tests/test_torch_backbones.py); then the same run with
   the injection off, whose last epoch's mean loss must be under the
   first's and whose val accuracy must beat chance; 8 timed steps and a
   torch.profiler window over 2;
21. gat-parity: one GAT step (Eq. 7 on) at batch 4,096 card vs CPU as in
   phase 5, from the state trained with Eq. 7 off (with it on the logits
   grow to ~1e4, in the reference too, and a near-zero logit's rounding
   then exceeds any elementwise tolerance);
22. gat-serve: that trained GAT served: refresh (vq_assign at [4, n, 32]
   a layer), warm-up and the 200 requests with counts exact (no counted
   kernel while serving), then CPU parity as in phase 7;
23. transformer-train: the Graph Transformer (heads 4, a full-width
   codebook: branches of 256 and 168) on a 20,000-node graph -- reduced
   from 169,343: its full-graph evaluation builds [H, n, n] scores, 6.4
   GB a tensor here and 459 GB at 169,343 -- batch 5,000, 10 epochs,
   one full-graph evaluation, the counts of phase 20, Eq. 7 on and off
   (finite losses: at depth 3 the reference learns in neither), then at
   depth 1 with Eq. 7 on (branch 168), where the reference learns: its
   last epoch's mean loss must be under the first's and its val accuracy
   must beat chance; 8 timed steps and a profile of 2; from the depth-3
   Eq. 7-off state one step at batch 1,024 card vs CPU (the cluster
   sums' tolerance in this step and in phase 21 widened by what the
   order of a codeword's adds may move it; the params compared in parts,
   ``split_step_check``: the step's gradients, each side's RMSprop of the
   card's gradients, and the params themselves where RMSprop's gain
   lr / (sqrt(v) + eps) does not carry a gradient difference within
   STEP_TOL past the param's STEP_TOL -- near v = 0 that gain magnified
   the card's order of adds across a score clip to 3.4x STEP_TOL in ~1
   run of 24), refresh (vq_assign's wide
   build at [1, n, 128]) and 200 requests with counts exact, then CPU
   parity;
24. wide-kernels: the wide build of vq_update and vq_assign against their
   plain versions (idx, qerr and want_min bit for bit, counts equal,
   sums within the scatter bound) and timed beside their bounds, on the
   trained states' operands: vq_update at GAT's [4, 42335, 65] and [4,
   42335, 43] and the Transformer's [1, 5000, 256] and [1, 5000, 168]
   (each also with 64- and 128-row tiles), at [1, 42335, 256] on rows
   near the Transformer's codewords, the uint8 emit at [4, 42335, 65]
   with 256 codewords, near-tie codebooks at f 65 and f 256; vq_assign at
   [1, 20000, 128] and [1, 169343, 128]; each with the share of rows the
   kernel queues for its second pass (its scratch counter, beside the
   estimate of its rule on the plain distances) and its scratch bytes;
   with ``--wide-parent DIR`` also an earlier tree's wide kernel (built
   from DIR) timed beside each, in turns; then a probe of the wgmma
   accumulation over 67 M distances (the largest error as a share of
   the bound's allowance); the build phase prints ptxas' registers and
   spills of the wide kernels;
25. link-train, the link task's main path: an ogbl-collab look-alike at
   ogbl-collab's 235,868 nodes (``synthetic_collab``, seed 4) with SAGE
   at the paper's width (hidden 128, 3 layers, k 1024, f_prod 4: 32
   branches of 8 a layer), ``train_vq`` -- its host-stepped loop, each
   batch packed and its positive pairs mined on the host -- for 10 epochs
   of 4 batches of 58,967 nodes from seed 0 and one Hits@50 evaluation,
   counts exact; finite losses, the last epoch's mean loss under the
   first's and val Hits@50 above 10x chance (the reference learns at
   this width, ``PERF.md`` §6); then 8 host-loop iterations timed (host
   packing and pair mining apart from the step) and a profile of 2 (the
   device's busy share of the loop);
26. link-full: ``train_full`` on the link task, 5 epochs (one step over
   every message edge each) and a Hits@50 evaluation, the full graph's
   SpMMs staged, counts exact, finite losses;
27. link-sampler: ``train_scenario``'s Cluster-GCN on the link task, 1
   epoch (the host loop, pairs capped at 4,096 a subgraph), counts exact,
   finite losses;
28. link-parity: one link step at batch 4,096 from the link-train state,
   card vs CPU with the same pairs, held as phase 5 holds its step;
29. link-kernels: every kernel of the link path against its plain
   version at the link batch's operands (vq_update at [32, 58967, 8],
   SAGE's spmm_ell, spmm_ell_t and both context_ell forms) and
   spmm_ell_hbm at the full graph's SAGE operands, timed beside their
   bounds;
30. host-loop: on phase 3's graph and model, one epoch of ``train_vq``
   with ``REPRO_EPOCH_EXECUTOR=0`` (each batch packed on the host)
   against one on the executor from the same seed (counts exact, step
   losses within STEP_TOL), then ``vq_inference`` with
   ``REPRO_INFER_EXECUTOR=0`` (the eager loop) against the executor
   (rows within SERVE_TOL);
31. dispatch, on phase 3's trained state (its launches counted apart
   from the main paths'): the per-branch context loop
   (``REPRO_CONTEXT_VARIANT=loop``: one spmm_ell a branch on its [k,
   f_blk] codewords, the ``w_t`` product a matmul) against the fused
   kernel and the plain version at the training batch (forward and
   ``w_t``), the link batch, the int8 tier and the serving batch -- the
   plain form bit for bit, ``w_t`` within the bound on its matmul's
   order, both timed -- and at [32, n] int32 tables under and above the
   50 MiB L2 (21.7, 64, 128, 256 and 512 MB); one step at batch 4,096
   under the loop card vs CPU, no context_ell launch and one spmm_ell a
   branch; the tuner
   (``REPRO_AUTOTUNE=1``, a temporary cache) cold at the main paths'
   sources, tables and wide shapes, every candidate's time and the
   winner printed, then warm (no measurement, no launch), and one arxiv
   epoch tuned against the same epoch untuned (step losses within
   STEP_TOL, counts as the tuned choices give them);
   ``codebook.assign`` on vq_assign at [32, 42335, 8] (and the wide
   build at GAT's [4, 42335, 65]) bit-equal and timed beside its bound;
   ``relative_error`` per layer and ``kmeanspp_init`` from a CUDA
   generator, card vs CPU within TOL;
32. mesh, the multi-device paths on torch.distributed, on phase 3's
   graph and model: (a) a one-rank NCCL group in this process, ``train_vq``
   for 2 epochs without a mesh (twice: the card's steps add in no fixed
   order, so two runs drift apart), with ``mesh=`` and with ``mesh=,
   shard_graph=True`` (the same launches in every run, finite losses, the
   free-running differences printed beside the run-to-run spread), then
   the same batches in lockstep, each step of the data-parallel and the
   row-sharded epoch from the plain step's state and within STEP_TOL of
   it; (b) two ranks on the one card over gloo
   (``share_device=True``: the machine has one H100), batch 42,336 (21,168
   a rank): one data-parallel epoch and one row-sharded epoch stepped
   in lockstep, a batch at a time from the data-parallel state, each step
   timed with its collectives (the sharded step within STEP_TOL of the
   data-parallel one, and the data-parallel step within STEP_TOL of a
   one-process oracle: the two column halves through
   ``vq_loss_and_grads`` one after the other, gradients summed, the
   codebook updated on their rows in rank order), then from the
   data-parallel state the
   inductive sharded inference at batch 42,335 and the sharded serving of
   48 ids, array-equal to the unsharded executors run here (which run
   twice first: a run that is not bit-stable is printed and the check
   falls back to STEP_TOL), every rank's results equal, launches counted
   exactly per rank, graph state at most 0.6x the replicated bytes a
   rank; epoch seconds, step p50, the collectives' share of the step time
   and the launches of each rank printed; (c) ``serve_gnn --mesh 2
   --shard-graph --share-device`` against ``serve_gnn --mesh 1`` at the
   full width and a micro-batch of 1,024, 200 requests: equal
   ``rows_sha256``, graph state at most 0.6x a rank; a rank that fails or
   a collective that times out fails the script;
33. lm-train, LM training at llama3.2-3b's full published width (d 3072,
   24 heads, 8 kv heads, d_ff 8192, vocab 128,256, bf16, remat on) cut to
   14 of its 28 layers for the script's time (random weights from a
   seeded generator on the card) through
   ``repro_torch.train.loop.make_train_step`` with the launcher's
   optimizer (Adam, bf16 moments, ``warmup_cosine(3e-4, 10, steps)``,
   ``clip_norm=1.0``), batches of 4 x 2,049 tokens from the port's token
   stream: 20 steps with VQ-Attention at the config defaults (k 1024, W
   512: 4 windows, codewords read from block 2 on), the full state saved
   with ``train/checkpoint.py`` after step 10 and restored equal (phase
   36), a profile of 2 more steps, then 8 exact-attention steps
   (``gqa_attend``, two query chunks of 1,024) from the same weights;
   finite losses and gradient norms, the mean of the last 5 VQ losses
   under the first step's, and no hand-written kernel launched (the
   reference's training path calls none); step p50 / p99 (host clock to
   the loss), tok/s, peak memory, the model-FLOPs share of the bf16 peak
   and layer 0's live codewords per head (W of k: queue 3 of
   ROADMAP.md);
34. lm-prefill: ``lm.prefill`` at the full width and depth under no_grad,
   VQ and exact, [4, 2048] tokens: finite [4, 128256] logits, ms a call,
   tok/s;
35. lm-train-parity: 2 layers of the same width in f32, TF32 off, the
   weights copied to the CPU, batch 2 x 192 tokens, VQ-Attention k 64, W
   64: loss and every gradient from the same state, then 3 steps of
   ``make_train_step`` (the launcher's optimizer) carried on each device,
   and one exact step, card vs CPU (loss, gradients, gradient norms
   ``rtol=1e-4, atol=1e-5``; params within ``rtol=1e-5`` and twice the
   steps' summed Adam step size, moments within a bf16 ulp);
36. lm-checkpoint: phase 33's state at step 10 (params and both bf16
   moments, ~26 GB as the reference's f32 npz at 14 layers) saved and
   restored, every leaf equal, the seconds of each; then ``train``'s failure drill on the
   card at 2 layers of the example's ``100m`` preset (d 768, vocab
   32,768): a failure before step 5, between the checkpoints of steps 4
   and 6, restores step 4, and the run ends at step 6 with the
   undisturbed run's losses within ``rtol=1e-4, atol=1e-5``;
37. families-serve, the moe, ssm and hybrid LM families through the
   serve launcher's configurations and ``decode`` at batch 4 (random
   weights from a seeded generator on the card): qwen3-moe-30b-a3b at full
   width and depth (48 layers, 128 experts top-8, 60.2 GB in bf16) for 72
   VQ steps past the 64-token window (k 128: every layer evicting,
   ``vq_attention`` launched exactly 48 a step, codebook mass =
   evictions), a profile of 2 VQ steps, 8 exact steps and one prefill of
   [4, 2048]; the step's weight-bytes bound, the experts' bytes (at
   capacity 1 every expert runs for the batch's 4 tokens, as in the
   reference) and the routed experts' most; phi3.5-moe-42b-a6.6b cut to 8
   of 32 layers (83.75 GB at full depth), 72 VQ steps; xlstm-350m (no
   attention: no launch) and zamba2-2.7b (VQ in its shared block: 9
   launches a step, one a group of 6 Mamba2 layers) at full width and
   depth, 72 steps and one prefill each; tok/s, step p50 / p99, cache
   bytes, peak memory; ``vq_attention`` against its plain version and
   timed at each new path shape (n 16 g 8 d 64, n 32 g 4 d 128, n 128 g
   1 d 80) on the layer-0 cache those decodes left;
38. families-train: 3 steps of the train launcher's ``make_step`` and
   optimizer (Adam, bf16 moments, ``clip_norm=1.0``) on the token stream:
   the MoE at qwen3-moe's full width cut to 4 layers (batch 2 x 1,024),
   xlstm-350m (16 x 128: the sLSTM steps through time one token at a
   time) and zamba2-2.7b (2 x 256) at full width and depth; finite losses
   and gradient norms, no counted kernel, step ms, tok/s, peak memory;
39. families-parity: each family at full width in f32, TF32 off, the
   weights copied to the CPU -- the MoE at 2 layers, xLSTM at 2 pairs,
   zamba2 at one group of 6 Mamba2 layers and its shared block -- 72
   teacher-forced decode steps card vs CPU (VQ for the MoE and zamba2:
   logits ``rtol=1e-4, atol=1e-4``, codebook counts equal at every step),
   then ``loss_and_grads`` on one batch of 1 x 96 and the launcher's
   Adam update from those gradients on each device (loss and gradients
   ``rtol=1e-4, atol=1e-5``, params and moments as in phase 35);
40. xattn-serve, the cross-attention LM families through the serve
   launcher's configurations and ``decode`` at batch 4 (random weights
   from a seeded generator on the card; the fresh caches' cross keys and
   values zeros, as the launcher serves them): whisper-tiny at full width
   and depth (4 encoder and 4 decoder layers, d 384, vocab 51,865) and
   llama-3.2-vision-11b at full width and depth (40 text layers and 8
   gated cross layers, 23.0 GB in bf16): 72 VQ steps past the 64-token
   window (``vq_attention`` exactly 4 / 40 a step, codebook mass =
   evictions), 8 exact steps, one prefill with the stub context (whisper
   [4, 448] over 1,500 frames, 448 its decoder context; the vision model
   [4, 2048] over 1,024 patches), a profile of 2 of the vision model's VQ
   steps; the step's bound from the tree's bytes (the weights a step
   reads and the cross caches); tok/s, step p50 / p99, cache bytes, peak
   memory; ``vq_attention`` against its plain version and timed at each
   path shape (n 24 g 1 d 64, n 32 g 4 d 128) on the layer-0 cache the
   VQ decode left;
41. xattn-train: 3 steps of the train launcher's optimizer and
   ``make_step`` with stub contexts from a seeded generator in the model
   dtype: whisper-tiny at full width and depth, 8 x 448; the vision model
   at full width, 2 x 1,024, cut to the deepest whole number of groups
   whose step fits 70 GB (14 bytes a parameter while Adam holds the old
   and new params and moments, plus 8 GB of activations): 2 groups, 10
   text layers; finite losses and gradient norms, no counted kernel, step
   ms, tok/s, peak memory;
42. xattn-parity: f32, TF32 off, the weights copied to the CPU,
   whisper-tiny at full width and depth and the vision model at full
   width and one group (5 text layers and their cross block), every gate
   nonzero and the cross caches filled from a seeded generator (both zero
   at init, which would hide a wrong cross path): 28 teacher-forced VQ
   decode steps at k 16, W 4 (24 past the window; logits ``rtol=1e-4,
   atol=1e-4``, counts equal), then ``loss_and_grads`` with a stub context
   on 1 x 96 and the launcher's Adam update, as in phase 39;
43. lm-mesh, the LM mesh on torch.distributed (no hand-written kernel,
   as in the reference): four gloo ranks sharing the card
   (``share_device``), each building a (2, 2) ("data", "model") host mesh
   and taking LM_MESH_STEPS bf16 steps of ``launch.train.
   build_sharded_step`` (llama3.2-3b at full width, tp_fsdp on this mesh,
   cut to LM_MESH_LAYERS of 28 layers, 4 x 256 tokens from the stream,
   the launcher's optimizer): finite losses, falling or flat (the last
   within 1 % over the first), step p50 ms and each rank's
   ``max_memory_allocated``; then one f32 step at 2 layers on the mesh,
   and each rank in turn the same step unsharded on the card from the
   same weights: loss, gradient norm, and its own shard of every
   gradient (``loss_and_grads`` on the mesh) and of both moments within
   LM_TRAIN_TOL and with an error norm within LM_MESH_REL of the norm
   (LM_MESH_REL_BF16 for the bf16 moments),
   of every param at rtol 1e-5, atol 1e-6 where the update is
   well-conditioned (``split_step_check``'s rule) or both gradients are
   0, the shards waiting on the host during the other ranks' turns;
   DTensor's
   collectives synchronous within the ranks' part
   (``ranks.sync_functional_collectives``); every counted kernel 0 on
   every rank; beside the ranks, on the host in a subprocess that sees no
   card, the fake-rank dry-run of granite-3-8b's prefill_32k cell at 2
   layers on (16, 16) (``launch.dryrun``; its JSON line); then the
   analytic roofline terms of llama3.2-3b's train_4k cell
   (``launch.roofline``);
44. analysis, the static contract checker (``repro_torch.analysis``):
   (a) its CLI on the card with all four passes (the AST lint, the
   dispatch contracts with the card's launch counters held against the
   recorder, shared memory against the card's opt-in limit and plans,
   and no host synchronization in any hot entry), failing on any
   finding; (b) each pinned entry and the single-device training entries
   run on the card with the kernels' launch counters reset, their
   launches by kernel and form equal to what the dispatch recorder
   predicts for the same entry on the CPU, and to the pinned table;
   (c) the card's opt-in shared memory a block equals ``SMEM_LIMIT``, and
   the wide scan's plan on the card equals ``vq_update.wide_plan`` at the
   registry's widths; (d) REPRO102 fires on a seeded ``.item()``.  Its
   launches are counted apart from the main paths' (its JSON line);
45. a ``{"kernels": [...]}`` line (the quantized and wide forms, the
   link shapes and the dispatch phase's shapes under each kernel's
   ``also``, each with its launches on the main paths -- a wide form's
   at its operand shape, as the wrapper counts them, every wide shape's
   under ``wide_launches_by_shape``, a link shape's form on the link
   paths under ``launches_link_paths``, a dispatch shape's on the
   dispatch phase's paths; the mesh paths' launches added), each phase's
   seconds, then the ``{"ok": true, ...}`` line.

The script needs a CUDA card: without one (or outside a checkout of the
repository) it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

T_START = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_NODES = 169343          # ogbn-arxiv's node count
BATCH = 256
REQUESTS = 200
MAX_REQUEST = 64
SEED = 0
DEVICE = "cuda"
TRAIN_EPOCHS = 70             # 350 steps: past the revival at step ~300
EVAL_EVERY = 5
MAX_CLUSTER_SHARE = 0.5       # of a layer's nodes on one codeword, at the end
TIMED_STEPS = 8
PARITY_BATCH = 4096
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
U32 = 2.0 ** -24              # fp32 unit roundoff
TIER_PRECISION = "int8"       # the tier the tier-train path trains under
TIER_K = 256                  # the paper's alternative codebook size, the
#                               largest a uint8 table holds
A4_K = 16                     # the '+a4' tiers pack tables only for k <= 16
TIER_AGREEMENT = 0.95         # argmax agreement with fp32 serving
TIER_INFER_BATCH = 42335      # vq_inference batch of the agreement check
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 dense tensor-core peak
TF32_FLOP_PER_S = 495e12      # H100 SXM tf32 dense tensor-core peak
LM_ARCH = "llama3.2-3b"
LM_BATCH = 4
LM_CONTEXT = 1024
LM_VQ_TOKENS = 192            # evictions from position 64 on fill k = 128
LM_EXACT_TOKENS = 64
LM_PARITY_LAYERS = 2
LM_PARITY_STEPS = 96          # 32 evictions past the 64-token window
LM_TOL = dict(rtol=1e-4, atol=1e-4)
# LM training and prefill at llama3.2-3b's full width
LM_TRAIN_BATCH = 4
LM_TRAIN_SEQ = 2048           # 4 windows of the config's W 512
LM_TRAIN_LAYERS = 14          # of 28: the script's time (prefill: all 28)
LM_TRAIN_VQ_STEPS = 20
LM_TRAIN_EXACT_STEPS = 8
LM_TRAIN_LR = 3e-4            # the launcher's default
LM_CKPT_STEP = 10             # the full state saved and restored here
LM_PREFILL_REPS = 3
LM_TRAIN_PARITY_LAYERS = 2
LM_TRAIN_PARITY_BATCH = 2
LM_TRAIN_PARITY_SEQ = 192     # 3 windows of 64: codewords read at block 2
LM_TRAIN_PARITY_K = 64
LM_TRAIN_PARITY_W = 64
LM_TRAIN_PARITY_STEPS = 3
LM_TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
LM_DRILL_STEPS = 6            # checkpoints at steps 2, 4 and 6
LM_DRILL_AT = 5               # the failure: restored from step 4
# the moe, ssm and hybrid LM families
MOE_ARCH = "qwen3-moe-30b-a3b"    # full width and depth: 60.2 GB in bf16
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 8                # of 32: 83.75 GB at full depth
SSM_ARCH = "xlstm-350m"
HYBRID_ARCH = "zamba2-2.7b"
FAMILY_VQ_TOKENS = 72         # 73 steps with the warm-up: 9 evictions
FAMILY_EXACT_TOKENS = 8
FAMILY_TRAIN_STEPS = 3
MOE_TRAIN_LAYERS = 4          # of 48
MOE_TRAIN_BATCH = 2
MOE_TRAIN_SEQ = 1024
SSM_TRAIN_BATCH = 16          # the sLSTM steps through time one at a
SSM_TRAIN_SEQ = 128           # time: its cost follows the sequence
HYBRID_TRAIN_BATCH = 2        # the Mamba2 scan moves 1.31 MB a token a
HYBRID_TRAIN_SEQ = 256        # layer each level
FAMILY_PARITY_STEPS = 72      # 8 evictions past the 64-token window
FAMILY_PARITY_BATCH = 1
FAMILY_PARITY_SEQ = 96        # a Mamba2 scan chunk of 64 and part of one
AUDIO_ARCH = "whisper-tiny"        # 4 + 4 layers, 1,500 stub frames
VLM_ARCH = "llama-3.2-vision-11b"  # 40 text + 8 gated cross layers
WHISPER_DEC_CTX = 448         # whisper's decoder context (arXiv:2212.04356)
WHISPER_TRAIN_BATCH = 8
VLM_TRAIN_BATCH = 2
VLM_TRAIN_SEQ = 1024
XATTN_TRAIN_BUDGET = 70e9     # bytes the vlm's launcher step may peak at
XATTN_ACT_BYTES = 8e9         # its activations, logits, embedding copies
XATTN_PARITY_STEPS = 28       # 24 evictions past the 4-token window
XATTN_PARITY_K = 16
XATTN_PARITY_W = 4
SAMPLER_METHODS = ("ns_sage", "labor", "cluster", "saint")
SAMPLER_EPOCHS = 2
HYBRID_EPOCHS = 2
SAMPLER_PARITY_N = 20000
SAMPLER_PARITY_BUDGET_MB = 1.0    # below the 16 MiB source: staged
ATTN_EPOCHS = 10              # gat-train and transformer-train
ATTN_HEADS = 4
# the Graph Transformer's full_apply builds [H, n, n] scores: 6.4 GB a
# tensor at n 20,000, 459 GB at 169,343
TRANSFORMER_N = 20000
TRANSFORMER_PARITY_BATCH = 1024
CHANCE = 1.0 / 40             # val accuracy of a uniform guess, 40 classes
# the link task: an ogbl-collab look-alike at ogbl-collab's node count
LINK_N = 235868
LINK_SEED = 4                 # synthetic_collab's default seed
LINK_EPOCHS = 10              # 40 steps of 58,967 nodes
LINK_FULL_EPOCHS = 5
LINK_SAMPLER_EPOCHS = 1
LINK_HITS_K = 50              # Hits@50, the paper's ogbl-collab metric
LINK_CHANCE_FACTOR = 10       # val Hits@50 must beat 10x a random scorer's
# the edge values and the context kernels' weight of the fixed
# convolutions the main paths train
FIXED_CONV = {"gcn": ("gcn", "w"), "sage": ("mean", "w2")}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, inner: int = 20) -> tuple[float, float]:
    """(device ms, call ms) of ``fn``, medians over ``reps`` CUDA-event
    timings after a warm-up.

    device ms: ``inner`` calls queued behind a ``torch.cuda._sleep`` that
    outlasts their enqueueing, so they run back to back and the events see
    device time only.  call ms: one call on an idle device, host launch
    overhead included -- what a caller waiting on one result pays."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # cycles at 2.5 GHz (above the card's top clock) x 1.5: the sleep lasts
    # longer than the host takes to enqueue the inner calls
    cycles = int(host_s * 2.5e9 * 1.5) + 100_000
    dev, call = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b) / inner)
        a.record()
        fn()
        b.record()
        b.synchronize()
        call.append(a.elapsed_time(b))
    return float(np.median(dev)), float(np.median(call))


def bound(bytes_: float, flops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_b, t_f = bytes_ / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def check_close(name: str, got, want, tol: dict) -> float:
    g, w = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    if g.shape != w.shape or not np.all(np.isfinite(g)):
        raise SystemExit(f"{name}: bad output shape {g.shape} vs {w.shape} "
                         f"or non-finite values")
    err = float(np.abs(g - w).max()) if g.size else 0.0
    if not np.allclose(g, w, **tol):
        raise SystemExit(f"{name}: kernel disagrees with its plain version "
                         f"(max abs err {err})")
    return err


def check_scatter(name: str, got, want, abs_sum, terms) -> float:
    """A scatter-add against its plain version: two fp32 sums of the same
    ``terms`` terms in different orders differ by at most
    ``2 * terms * 2^-24 * sum |term|`` per element."""
    import torch
    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise SystemExit(f"{name}: bad output shape {tuple(g.shape)} vs "
                         f"{tuple(w.shape)} or non-finite values")
    err = (g - w).abs()
    tol = 2 * terms.detach().cpu().double() * U32 \
        * abs_sum.detach().cpu().double()
    if bool((err > tol).any()):
        raise SystemExit(f"{name}: {int((err > tol).sum())} elements beyond "
                         f"the scatter-order bound (max abs err "
                         f"{float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


def phase_card() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


def phase_build() -> float:
    import re
    from repro_torch.kernels import _build
    t0 = time.time()
    path = _build.build()
    _build.library()
    dt = time.time() - t0
    log(f"build: {path.relative_to(ROOT)} in {dt:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    # ptxas' registers and spills of the wide scan's kernels
    for src in ("vq_update", "vq_update_u8", "vq_assign"):
        text = _build.build_log(src)
        for m in re.finditer(
                r"Function properties for (\S*(?:vq_wide_kernel|"
                r"wide_prep_kernel)\S*)\n\s*(\d+) bytes stack frame, (\d+) "
                r"bytes spill stores, (\d+) bytes spill loads\n.*?Used (\d+) "
                r"registers", text, re.S):
            log(f"ptxas {src}.cu {m.group(1)}: {m.group(5)} registers, "
                f"{m.group(2)} bytes stack, {m.group(3)} / {m.group(4)} "
                f"bytes spill stores / loads")
    return dt


class Model:
    """The graph's device tables for the training phases."""

    def __init__(self, g, cfg, batch: int, dev):
        import torch
        from repro_torch.graph.batching import build_epoch_plan, full_operands
        self.g, self.cfg, self.batch, self.dev = g, cfg, batch, dev
        self.ops = full_operands(g, device=dev, stripe_index=True)
        self.plan = build_epoch_plan(g, full_ops=self.ops, device=dev)
        self.x = torch.from_numpy(g.features).to(dev)
        self.labels = torch.from_numpy(g.labels).to(dev)
        mask = np.zeros(g.n, np.float32)
        mask[g.train_idx] = 1.0
        self.train_mask = torch.from_numpy(mask).to(dev)

    def batch_inputs(self, bids_np: np.ndarray,
                     smask_np: np.ndarray | None = None):
        """(pack, x_b, labels_b, loss mask) of one batch of node ids, as
        ``vq_train_epoch`` builds them; ``smask_np`` is the batch's slot
        mask (the hybrid's: 0 on its context slots).  For the link task a
        fifth item: the batch's pairs (``pos_pairs`` / ``neg_pairs``, as
        ``train_vq``'s host loop mines them, the negatives drawn from a
        fixed seed, so every device gets the same)."""
        import torch
        from repro_torch.graph.batching import plan_batch
        bids = torch.from_numpy(bids_np.astype(np.int32)).to(self.dev)
        i = bids.long()
        if smask_np is None:
            out = (plan_batch(self.plan, bids), self.x[i], self.labels[i],
                   self.train_mask[i])
        else:
            smask = torch.from_numpy(smask_np).to(self.dev)
            out = (plan_batch(self.plan, bids, smask), self.x[i],
                   self.labels[i], self.train_mask[i] * smask)
        if self.cfg.task != "link":
            return out
        from repro_torch.train.gnn_trainer import _batch_pairs
        pos, neg = _batch_pairs(
            self.g, bids_np, np.ones(len(bids_np), np.float32)
            if smask_np is None else smask_np,
            np.random.default_rng(SEED + 17))
        return out + ({"pos_pairs": torch.from_numpy(pos).to(self.dev),
                       "neg_pairs": torch.from_numpy(neg).to(self.dev)},)


def _loss_grads(m: Model, params, vq, inputs):
    """``vq_loss_and_grads`` of one batch of ``Model.batch_inputs``, with
    its pairs on the link task."""
    from repro_torch.models.gnn import vq_loss_and_grads
    pack, x_b, y_b, lm = inputs[:4]
    return vq_loss_and_grads(params, vq, pack, x_b, y_b, m.ops.degrees,
                             m.cfg, lm, **(inputs[4] if len(inputs) > 4
                                           else {}))


def largest_cluster_share(vq_states) -> list[float]:
    """Per layer: the largest share of the nodes that one codeword of one
    branch holds in the assignment table (1.0 is a collapsed codebook)."""
    import torch
    from repro_torch.distributed.quantization import PackedAssignment
    out = []
    for st in vq_states:
        a = st.assignment
        if isinstance(a, PackedAssignment):
            a = a.unpack()
        nb, n = a.shape
        k = st.codebook.k
        flat = a.long() + k * torch.arange(nb, device=a.device)[:, None]
        counts = torch.bincount(flat.reshape(-1), minlength=nb * k)
        out.append(float(counts.max()) / n)
    return out


def check_tier_storage(what: str, vq_states, precision: str) -> None:
    """Every layer state in the storage of ``precision``: uint8 tables
    (nibble-packed under '+a4') and int8 / fp8 codeword snapshots."""
    import torch
    from repro_torch.distributed.quantization import PackedAssignment
    cw = torch.float8_e4m3fn if precision.startswith("fp8") else torch.int8
    for l, st in enumerate(vq_states):
        a = st.assignment
        packed = isinstance(a, PackedAssignment)
        ok = (packed == precision.endswith("+a4")
              and (a.packed if packed else a).dtype == torch.uint8
              and st.qcw is not None and st.qcw.feat.q.dtype == cw
              and st.qcw.grad.q.dtype == cw)
        if not ok:
            raise SystemExit(f"{what}: layer {l} is not in the {precision} "
                             f"tier's storage")


def phase_train(g, cfg, batch: int, tier: str | None = None,
                method: str = "vq", epochs: int = TRAIN_EPOCHS
                ) -> tuple[dict, dict]:
    """A training main path: ``train_vq`` at the paper's batch size for
    ``epochs`` epochs, paper-faithful (Eq. 7 injection on), with the
    launch counts of every step and of the full-graph evaluations checked
    exactly and every step's loss and VQ error printed (each epoch's under
    a tier or for the hybrid).  Under ``tier`` the run is ``train_vq`` with
    that tier configured: uint8 tables, int8 snapshots requantized every
    step, the quantized forms of context_ell in place of the f32 ones.
    With ``method="hybrid"`` it is ``train_scenario``'s hybrid: each batch
    widened by as many LABOR-sampled context nodes, the same kernels a
    step.

    Gates: every loss and VQ error finite; the mean loss of the last 5
    epochs under that of the first 5 (of the last epoch under the first's
    in a run of fewer than 10); a tier's states end in its storage; and
    in a run of TRAIN_EPOCHS, no layer's codebook collapsed at the end (at
    most MAX_CLUSTER_SHARE of the nodes on one codeword).  That run is
    long enough for the uncollapsed codebooks: while the injection reads
    the random initial gradient codewords the loss rises and the last
    layer's codebook collapses -- the reference does the same
    (tests/test_torch_train.py) -- until the codewords nobody picks have
    decayed under ``revive_threshold`` (0.99^t < 0.05 at step ~300) and
    are re-seeded from the worst-quantized rows."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.train.gnn_trainer import train_scenario, train_vq
    tag = "train" if tier is None else f"tier-train {tier}"
    if method == "hybrid":
        tag = "hybrid-train"
    n_layers = cfg.n_layers
    steps = epochs * -(-g.n // batch)
    inject = n_layers - 1 if cfg.grad_inject else 0
    reset_counts()
    t0 = time.time()
    kops.configure_kernel_precision(tier or "fp32")
    try:
        if method == "hybrid":
            r = train_scenario(g, cfg, "hybrid", epochs=epochs,
                               batch_size=batch, seed=SEED,
                               eval_every=EVAL_EVERY, device=DEVICE)
        else:
            r = train_vq(g, cfg, epochs=epochs, batch_size=batch,
                         seed=SEED, eval_every=EVAL_EVERY, device=DEVICE)
    finally:
        kops.configure_kernel_precision(reset=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    # per step: every layer's forward runs spmm_ell and context_ell and its
    # codebook update vq_update; the backward of every layer but the first
    # (whose input needs no gradient) runs spmm_ell_t and, with the Eq. 7
    # injection, the w_t form of context_ell -- each context_ell launch in
    # its quantized form under a tier.  Each full-graph evaluation runs
    # the staged spmm_ell_hbm once per layer: its 86.7 MB source is above
    # the 50 MiB L2 budget of the dispatch; the training batch's source
    # (21.7 MB; the hybrid's 43.3 MB) stays resident.
    evals = -(-epochs // EVAL_EVERY)
    q = tier is not None
    expect_counts(tag, counts, {
        "vq_assign": 0, "vq_update": n_layers * steps,
        "spmm_ell": n_layers * steps, "spmm_ell_hbm": n_layers * evals,
        "spmm_ell_t": (n_layers - 1) * steps,
        "context_ell": (n_layers + inject) * steps,
        "context_ell_wt": inject * steps,
        "context_ell_q": (n_layers + inject) * steps if q else 0,
        "context_ell_q_wt": inject * steps if q else 0})
    losses, errs = r["step_losses"], r["step_vq_errs"]
    if losses.shape != (steps,) or errs.shape != (steps, n_layers):
        raise SystemExit(f"{tag}: {losses.shape} losses, {errs.shape} VQ "
                         f"errors for {steps} steps")
    if tier is None and method == "vq":
        for i, (loss, e) in enumerate(zip(losses, errs)):
            log(f"train step {i}: loss {loss:.6f} vq_err "
                f"{' '.join(f'{v:.4f}' for v in e)}")
    for h in r["history"]:
        log(f"{tag} epoch {h['epoch']}: {r['epoch_s'][h['epoch'] - 1]:.3f} "
            f"s, val {h['val']:.4f} test {h['test']:.4f} vq_err "
            f"{h['vq_err']:.4f}")
    epoch_loss = losses.reshape(epochs, -1).mean(1)
    share = largest_cluster_share(r["vq_states"])
    r.update(wall_s=wall, epoch_loss=epoch_loss.tolist(),
             epoch_vq_err=errs.reshape(epochs, -1).mean(1).tolist(),
             largest_cluster_share=share)
    log(f"{tag}: {steps} steps of {batch} nodes in {wall:.3f} s (incl. "
        f"{evals} full-graph evaluations); mean loss per epoch "
        f"{[round(v, 4) for v in r['epoch_loss']]}; largest cluster share "
        f"per layer at the end {[round(v, 4) for v in share]}")
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(errs))):
        raise SystemExit(f"{tag}: non-finite loss or VQ error")
    w = min(5, epochs // 2)
    first, last = float(epoch_loss[:w].mean()), float(epoch_loss[-w:].mean())
    if not last < first:
        raise SystemExit(f"{tag}: mean loss of the last {w} epochs {last} "
                         f"not under that of the first {w} {first}")
    if epochs == TRAIN_EPOCHS and max(share) > MAX_CLUSTER_SHARE:
        raise SystemExit(f"{tag}: a codebook collapsed, largest cluster "
                         f"share per layer {share} (cap "
                         f"{MAX_CLUSTER_SHARE})")
    if tier is not None:
        check_tier_storage(tag, r["vq_states"], tier)
    return r, counts


def phase_step_timing(m: Model, params, vq, ost) -> dict:
    """Host-clock time of single training steps, each synchronised, on
    fresh batches from the trained state (outside the counted main path;
    the states they produce are dropped)."""
    import torch
    from repro_torch.graph.batching import epoch_slices
    from repro_torch.models.gnn import vq_train_step
    from repro_torch.train.optimizer import rmsprop
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    opt = rmsprop(PAPER_LR)
    rng = np.random.default_rng(SEED + 11)
    ids = np.concatenate([epoch_slices(rng.permutation(m.g.n), m.batch)[0]
                          for _ in range(-(-TIMED_STEPS * m.batch // m.g.n)
                                         + 1)])[:TIMED_STEPS]
    times = []
    for bids in ids:
        pack, x_b, y_b, lm = m.batch_inputs(bids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, vq, ost, loss, _, _ = vq_train_step(
            params, vq, ost, pack, x_b, y_b, m.ops.degrees, m.cfg, opt,
            loss_mask=lm)
        float(loss)                              # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    t = np.sort(times)
    rep = {"steps": len(t), "step_p50_ms": float(np.percentile(t, 50)),
           "step_p99_ms": float(np.percentile(t, 99)),
           "step_ms": [float(v) for v in times]}
    log(f"train step timing: {len(t)} steps of {m.batch} nodes, p50 "
        f"{rep['step_p50_ms']:.3f} ms p99 {rep['step_p99_ms']:.3f} ms")
    return rep


def _vq_update_row(name, vw, cw, generic: bool = False,
                   emit=None) -> dict:
    """vq_update against its plain version on one layer's rows; with
    ``generic`` also the kernel's generic-width instantiation, which must
    give the same result, timed beside the fixed-width build; ``emit``
    (uint8) checks and times that emit of the assignment."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.vq_update import (vq_assign_update_cuda,
                                               vq_assign_update_generic_cuda)
    emit = torch.int32 if emit is None else emit
    got = vq_assign_update_cuda(vw, cw, emit)
    want = ref.vq_assign_update(vw, cw, emit)
    torch.cuda.synchronize()
    nb, b, f = vw.shape
    k = cw.shape[1]
    if not torch.equal(got[0], want[0]):
        raise SystemExit(f"{name}: assignment differs from the plain version "
                         f"({int((got[0] != want[0]).sum())} rows)")
    if not torch.equal(got[1], want[1]):
        raise SystemExit(f"{name}: qerr not bit-equal to the plain version "
                         f"(max abs err {float((got[1] - want[1]).abs().max())})")
    if not torch.equal(got[2], want[2]):
        raise SystemExit(f"{name}: counts differ from the plain version")
    flat = (want[0].long() + k * torch.arange(nb, device=vw.device)[:, None]
            ).reshape(-1)
    abs_sum = torch.zeros((nb * k, f), device=vw.device).index_add_(
        0, flat, vw.abs().reshape(-1, f)).reshape(nb, k, f)
    err = check_scatter(f"{name} sums", got[3], want[3], abs_sum,
                        want[2][..., None])
    # The bound above grows with a codeword's row count and is loose on a
    # codeword thousands of rows share.  On rows rounded to multiples of
    # 2^-s within [-4, 4], every partial sum of at most b rows is a
    # multiple of 2^-s under 4b; with 4b * 2^s <= 2^24 that is at most 24
    # significant bits, exact in fp32 in any order, so there the sums must
    # equal the float64 sums bit for bit (s = 6 up to b = 2^16, 5 at the
    # hybrid's 84,670 rows).
    q = 2.0 ** min(6, 24 - math.ceil(math.log2(4 * b)))
    vq_ = ((vw * q).round().clamp(-4 * q, 4 * q) / q).contiguous()
    gq = vq_assign_update_cuda(vq_, cw)
    wq = ref.vq_assign_update(vq_, cw)
    flat_q = (gq[0].long() + k * torch.arange(nb, device=vw.device)[:, None]
              ).reshape(-1)
    exact = torch.zeros((nb * k, f), dtype=torch.float64,
                        device=vw.device).index_add_(
        0, flat_q, vq_.double().reshape(-1, f)).reshape(nb, k, f)
    if not (torch.equal(gq[0], wq[0]) and torch.equal(gq[2], wq[2])
            and torch.equal(gq[3].double(), exact)):
        raise SystemExit(f"{name}: on rows with exact fp32 sums the kernel's "
                         f"assignment, counts or sums are not exact")
    byt = 4 * nb * b * f + 4 * nb * k * f + 8 * nb * b + 4 * nb * k * (f + 1)
    bms, by = bound(byt, 2 * nb * b * k * f)
    # the bounds of the kernel's own units: its 3xTF32 products (f padded
    # to a multiple of 8) on the tensor cores, and one compare-select a
    # distance at the fp32 issue rate (half the FMA-counted fp32 peak)
    tc_ms = 3 * 2 * nb * b * k * 8 * -(-f // 8) / TF32_FLOP_PER_S * 1e3
    sel_ms = nb * b * k / (FP32_FLOP_PER_S / 2) * 1e3
    ms, call_ms = cuda_ms(lambda: vq_assign_update_cuda(vw, cw, emit), 5,
                          inner=4)
    row = dict(max_abs_err=err, ms=ms, call_ms=call_ms, bound_ms=bms,
               bound_by=by, tensor_bound_ms=tc_ms, select_bound_ms=sel_ms,
               plain_ms=cuda_ms(lambda: ref.vq_assign_update(vw, cw, emit),
                                3, inner=1)[0],
               hot_share=float(want[2].max()) / b,
               at=f"x=[{nb}, {b}, {f}] cw=[{nb}, {k}, {f}]")
    if generic:
        gen = vq_assign_update_generic_cuda(vq_, cw)
        if not all(torch.equal(u, v) for u, v in zip(gen, gq)):
            raise SystemExit(f"{name}: the generic-width instantiation "
                             f"differs from the fixed-width build")
        row["generic_ms"] = cuda_ms(
            lambda: vq_assign_update_generic_cuda(vw, cw), 5, inner=4)[0]
        log(f"{name}: generic-width instantiation {row['generic_ms']:.4f} "
            f"ms against the fixed-width build's {ms:.4f} ms")
    log(f"{name} {row['at']}: idx/qerr/counts equal, sums max_abs_err "
        f"{err:.3g} (exact on grid rows)  kernel {ms:.4f} ms (one call {call_ms:.4f} ms)  plain "
        f"{row['plain_ms']:.4f} ms  bound {bms:.4f} ms ({by}; 3xTF32 "
        f"products {tc_ms:.4f} ms, compare-selects {sel_ms:.4f} ms)  largest "
        f"cluster {row['hot_share']:.4f} of the rows  library none")
    return row


def _vq_update_rows(m: Model, params, vq, inputs, tag: str,
                    hot: bool = False) -> list[dict]:
    """vq_update on layers 0 and L-1 with the whitened (X || G) rows of one
    batch; with ``hot`` also the generic-width build and the hot spot."""
    from repro_torch.core import codebook as cbm
    cfg = m.cfg
    cb = cfg.layer_codebook_cfg()
    _, _, acts, _, gprobes = _loss_grads(m, params, vq, inputs)
    rows = []
    for layer in (0, cfg.n_layers - 1):
        st = vq[layer].codebook
        vw = cbm.whitened_rows(st, acts[layer], gprobes[layer], cb)[0]
        cw = st.codewords_w.contiguous()
        row = _vq_update_row(f"vq_update layer {layer} {tag}", vw, cw,
                             generic=hot)
        row["at"] += f" layer {layer} {tag}"
        rows.append(row)
        if hot:
            # the hot spot: every row of a branch on one codeword, as in a
            # collapsed codebook (each branch's first row repeated)
            hot_vw = vw[:, :1].expand_as(vw).contiguous()
            row = _vq_update_row(f"vq_update layer {layer} hot spot", hot_vw,
                                 cw)
            row["at"] += f" layer {layer} hot spot (rows all alike)"
            rows.append(row)
    return rows


def _near_tie_rows(m: Model, params, vq, inputs) -> list[dict]:
    """vq_update on a near-tie codebook at the training shape, layers 0 and
    L-1, bit-equal to its plain version: the trained codewords with every
    fourth duplicated (1::4 = 0::4) and the next one ulp above it in its
    first coordinate (2::4); a third of the batch's whitened rows moved
    onto a codeword, a third halfway between two.  A scan bound that is
    too tight shows here first."""
    import torch
    from repro_torch.core import codebook as cbm
    cfg = m.cfg
    cb = cfg.layer_codebook_cfg()
    _, _, acts, _, gprobes = _loss_grads(m, params, vq, inputs)
    gen = torch.Generator(device=m.dev).manual_seed(SEED + 23)
    rows = []
    for layer in (0, cfg.n_layers - 1):
        st = vq[layer].codebook
        vw = cbm.whitened_rows(st, acts[layer], gprobes[layer], cb)[0]
        nb, b, f = vw.shape
        c = st.codewords_w.clone()
        k = c.shape[1]
        c[:, 1::4] = c[:, 0::4][:, :c[:, 1::4].shape[1]]
        c2 = c[:, 0::4][:, :c[:, 2::4].shape[1]].clone()
        c2[..., 0] = torch.nextafter(c2[..., 0],
                                     torch.full_like(c2[..., 0], math.inf))
        c[:, 2::4] = c2
        pick = torch.randint(0, k, (nb, b), generator=gen, device=m.dev)
        on = torch.gather(c, 1, pick[..., None].expand(nb, b, f))
        other = torch.gather(c, 1, ((pick + 1) % k)[..., None]
                             .expand(nb, b, f))
        x = vw.clone()
        x[:, 0::3] = on[:, 0::3]
        x[:, 1::3] = (0.5 * (on + other))[:, 1::3]
        row = _vq_update_row(f"vq_update layer {layer} near-tie codebook",
                             x.contiguous(), c.contiguous())
        row["at"] += (f" layer {layer} near-tie codebook (duplicates, 1-ulp "
                      f"neighbours, rows on and halfway between codewords)")
        rows.append(row)
    return rows


def _spmm_t_check(idx, val, gr, n_src: int, at: str):
    """spmm_ell_t against its plain version within the scatter-order bound:
    (kernel result, max abs err, live slots, largest live in-degree)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmm_ell import spmm_ell_t_cuda
    got = spmm_ell_t_cuda(idx, val, gr, n_src)
    want = ref.spmm_ell_t(idx, val, gr, n_src)
    nz = val != 0
    in_deg = torch.zeros(n_src, dtype=torch.int64, device=idx.device)
    in_deg.index_add_(0, idx.long().clamp(0, n_src - 1)[nz],
                      torch.ones_like(idx, dtype=torch.int64)[nz])
    err = check_scatter(f"spmm_ell_t {at}", got, want,
                        ref.spmm_ell_t(idx, val.abs(), gr.abs(), n_src),
                        in_deg[:, None].float())
    return want, err, int(nz.sum()), int(in_deg.max())


def _spmm_t_row(idx, val, gr, n_src: int, at: str) -> dict:
    """spmm_ell_t (the SpMM's backward in x) against its plain version and
    ``torch.sparse.mm`` on one set of operands: idx/val [b, D], the output
    gradient gr [b, f], an ``n_src``-row source.  Also the share of live
    slots (val != 0), the largest in-degree an output row takes, and the
    same operands with half the live slots moved onto one hub row, checked
    and timed beside them (``hub_ms``): the kernel's reductions into one
    row serialize in the L2."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmm_ell import spmm_ell_t_cuda
    b, deg = idx.shape
    f = gr.shape[1]
    want, err, nnz, max_in = _spmm_t_check(idx, val, gr, n_src, at)
    nz = val != 0
    bms, by = bound(8 * b * deg + 4 * b * f + 4 * n_src * f, 2 * nnz * f)
    rows_i = torch.arange(b, device=idx.device)[:, None].expand(b, deg)
    coo_t = torch.sparse_coo_tensor(
        torch.stack([idx.long()[nz], rows_i[nz]]), val[nz], (n_src, b),
        check_invariants=True).coalesce()
    check_close(f"spmm_ell_t library call {at}", torch.sparse.mm(coo_t, gr),
                want, SERVE_TOL)
    ms, call_ms = cuda_ms(lambda: spmm_ell_t_cuda(idx, val, gr, n_src), 10)
    hub = idx.clone()
    live = nz.nonzero(as_tuple=True)
    half = torch.arange(live[0].numel(), device=idx.device) % 2 == 0
    hub[live[0][half], live[1][half]] = n_src // 2
    _, hub_err, _, hub_in = _spmm_t_check(hub, val, gr, n_src,
                                          f"{at} hub-heavy")
    hub_ms = cuda_ms(lambda: spmm_ell_t_cuda(hub, val, gr, n_src), 5)[0]
    # every live slot adds f floats to an output row: 32-byte sectors
    # reduced in the L2, which the kernel issues 16 bytes a lane at a time
    sectors = nnz * -(-4 * f // 32)
    row = dict(max_abs_err=max(err, hub_err), ms=ms, call_ms=call_ms,
               plain_ms=cuda_ms(lambda: ref.spmm_ell_t(idx, val, gr, n_src),
                                5, inner=2)[0],
               bound_ms=bms, bound_by=by,
               library_ms=cuda_ms(lambda: torch.sparse.mm(coo_t, gr), 10)[0],
               live_share=nnz / max(1, b * deg), max_in_degree=max_in,
               reduced_sectors_per_s=sectors / (ms * 1e-3),
               hub_ms=hub_ms, hub_max_in_degree=hub_in,
               at=f"b={b} D={deg} f={f} nnz={nnz} n_src={n_src} {at}")
    log(f"spmm_ell_t {row['at']}: max_abs_err {err:.3g}  kernel {ms:.5f} ms "
        f"(one call {call_ms:.5f} ms)  plain {row['plain_ms']:.5f} ms  "
        f"sparse.mm {row['library_ms']:.5f} ms  bound {bms:.6f} ms ({by})  "
        f"live slots {row['live_share']:.4f}, largest in-degree {max_in}, "
        f"{row['reduced_sectors_per_s']:.4g} reduced 32-byte sectors/s;  "
        f"hub-heavy (half the live slots on one row, in-degree {hub_in}): "
        f"{hub_ms:.5f} ms, max_abs_err {hub_err:.3g}")
    return row


def _step_rows(m: Model, params, vq, inputs, tag: str,
               hot: bool = False) -> dict[str, list[dict]]:
    """Every kernel of one VQ training step against its plain version on
    one batch (``inputs`` from ``Model.batch_inputs``), by kernel name:
    vq_update (layers 0 and L-1; ``hot`` as in ``_vq_update_rows``), the
    w_t form of context_ell (the Eq. 7 backward of layers 1..L-1) and its
    plain form (layers 0 and L-1), spmm_ell's intra-batch term and its
    backward spmm_ell_t -- on the operands of the model's fixed
    convolution (GCN's, or SAGE's mean aggregator)."""
    import torch
    from repro_torch.core import codebook as cbm
    from repro_torch.core.conv import fixed_conv_operands
    from repro_torch.kernels import ref
    from repro_torch.kernels.context_ell import context_ell_cuda
    cfg, dev = m.cfg, m.dev
    cb = cfg.layer_codebook_cfg()
    pack, x_b = inputs[:2]
    kind, w_key = FIXED_CONV[cfg.backbone]
    ops_, _ = fixed_conv_operands(kind, pack, m.ops.degrees)
    b = ops_.in_pos.shape[0]
    out = {"vq_update": _vq_update_rows(m, params, vq, inputs, tag, hot)}

    # --- context_ell w_t: the Eq. 7 backward of layers 1..L-1 ---
    wt = []
    ids, vals = ops_.rev_ids.contiguous(), ops_.rev_vals.contiguous()
    dr = ids.shape[1]
    for layer in range(1, cfg.n_layers):
        fi = cfg.layer_dims()[layer][0]
        gcw = cbm.gradient_codewords(vq[layer].codebook, fi, cb)
        w_t = params[layer][w_key].t().contiguous()
        a = vq[layer].assignment
        layout, other = _layouts(a, f"w_t layer {layer} {tag}", False)
        want = ref.context_ell(ids, vals, a, gcw, w_t)
        _bit_equal(f"context_ell w_t layer {layer} {tag}",
                   context_ell_cuda(ids, vals, a, gcw, w_t), want)
        _bit_equal(f"context_ell w_t layer {layer} {tag} (other layout)",
                   context_ell_cuda(ids, vals, other, gcw, w_t), want)
        err = 0.0
        nb, k, gb = gcw.shape
        f_out = w_t.shape[1]
        uid = torch.unique(ids.long())
        pairs = torch.unique(a[:, uid].long()
                             + k * torch.arange(nb, device=dev)[:, None])
        byt = 8 * b * dr + 4 * nb * uid.numel() + 4 * gb * pairs.numel() \
            + 4 * nb * gb * f_out + 4 * b * f_out
        bms, by = bound(byt, 2 * b * dr * nb * gb + 2 * b * nb * gb * f_out)
        ms, call_ms = cuda_ms(lambda: context_ell_cuda(ids, vals, a, gcw,
                                                       w_t), 5)
        wt.append(dict(
            form="w_t", max_abs_err=err, bound_ms=bms, bound_by=by, ms=ms,
            call_ms=call_ms, library_ms=None, layout=layout,
            ms_other_layout=cuda_ms(lambda: context_ell_cuda(
                ids, vals, other, gcw, w_t), 5)[0],
            plain_ms=cuda_ms(lambda: ref.context_ell(ids, vals, a, gcw, w_t),
                             3, inner=2)[0],
            at=f"b={b} Dr={dr} n={a.shape[1]} nb={nb} k={k} fb={gb} "
               f"f_out={f_out} (layer {layer} backward, {tag})"))
        c = wt[-1]
        log(f"context_ell w_t {c['at']}: bit-equal  kernel {ms:.5f} ms (one "
            f"call {call_ms:.5f} ms; table {layout}, the other layout "
            f"{c['ms_other_layout']:.5f} ms)  plain {c['plain_ms']:.5f} ms  "
            f"bound {bms:.6f} ms ({by})  library none")

    # --- spmm_ell's intra-batch term and its backward spmm_ell_t ---
    idx = torch.clamp(ops_.in_pos, min=0).contiguous()
    val = ops_.in_vals.contiguous()
    gr = torch.randn((b, cfg.hidden), generator=torch.Generator(device=dev)
                     .manual_seed(SEED), device=dev)
    out["spmm_ell_t"] = [_spmm_t_row(idx, val, gr, b, f"({tag})")]
    out["spmm_ell"] = [_spmm_row(idx, val, x_b.contiguous(),
                                 f"({tag} forward, intra-batch)")]
    ctx = []
    for layer in (0, cfg.n_layers - 1):
        fi = cfg.layer_dims()[layer][0]
        ctx.append(_context_row(
            ops_.out_ids.contiguous(), ops_.out_vals.contiguous(),
            vq[layer].assignment,
            cbm.feature_codewords(vq[layer].codebook, fi, cb),
            f"({tag} forward, layer {layer})"))
    out["context_ell"] = wt + ctx
    return out


def phase_train_kernels(m: Model, params, vq) -> tuple[list[dict], dict]:
    """Every kernel of the training path against its plain version at the
    shapes training gives it, on one training batch of the trained model
    (``_step_rows``, with vq_update also on the untrained model's rows --
    early training, the atomic hot spot of rows crowding few codewords),
    and spmm_ell on the full graph (the evaluation's source, which the
    main path stages: ``spmm_ell_hbm``).  Returns the vq_update and
    spmm_ell_t rows and, by kernel name, the rows that go under the
    spmm_ell and context_ell rows' ``also``."""
    import torch
    from repro_torch.models.gnn import init_gnn, init_vq_states
    from repro_torch.nn.gnn_layers import _gcn_edge_vals
    cfg, dev = m.cfg, m.dev
    rng = np.random.default_rng(SEED + 5)
    inputs = m.batch_inputs(rng.permutation(m.g.n)[:m.batch])
    step = _step_rows(m, params, vq, inputs, "training batch", hot=True)
    init = (init_gnn(cfg, torch.Generator().manual_seed(SEED), device=dev),
            init_vq_states(cfg, m.g.n, torch.Generator().manual_seed(
                SEED + 1), device=dev))
    upd = step["vq_update"] + _vq_update_rows(m, *init, inputs, "untrained") \
        + _near_tie_rows(m, params, vq, inputs)
    rows = [dict(name="vq_update", route="cuda",
                 source="src/repro_torch/kernels/csrc/vq_update.cuh",
                 replaces="src/repro/kernels/vq_update.py:106",
                 **{k: upd[0][k] for k in upd[0] if k != "max_abs_err"},
                 max_abs_err=max(c["max_abs_err"] for c in upd),
                 library_ms=None, also=upd[1:]),
            dict(name="spmm_ell_t", route="cuda",
                 source="src/repro_torch/kernels/csrc/spmm_ell.cu",
                 replaces="src/repro/kernels/spmm_ell.py:56 (backward in x; "
                          "JAX autodiff, no Pallas kernel)",
                 **step["spmm_ell_t"][0], also=[])]
    spmm = step["spmm_ell"] + [_spmm_row(
        m.ops.nbr_ids.contiguous(), _gcn_edge_vals(m.ops)[0].contiguous(),
        m.x, "(full-graph evaluation)")]
    # both sources exceed the reference's 8 MB VMEM budget, which sends
    # them to its HBM kernel (src/repro/kernels/ops.py:241); the port's
    # 50 MiB L2 budget keeps the batch's 21.7 MB resident and stages the
    # full graph's 86.7 MB (spmm_ell_hbm, phase 12): here the resident
    # kernel is forced onto both
    spmm[0]["replaces"] = ("src/repro/kernels/spmm_ell.py:56 (the "
                           "reference's dispatch sends this source to "
                           "spmm_ell_hbm.py:168)")
    spmm[1]["replaces"] = ("src/repro/kernels/spmm_ell.py:56 (forced; the "
                           "main path stages this source: spmm_ell_hbm)")
    return rows, {"spmm_ell": spmm, "context_ell": step["context_ell"]}


def _dense_table(a):
    """An assignment table as a plain [nb, n] tensor (a packed one
    unpacked)."""
    from repro_torch.distributed.quantization import PackedAssignment
    return a.unpack() if isinstance(a, PackedAssignment) else a


def _codeword_mismatch(a, b, slack=None) -> "torch.Tensor":
    """[nb, k] mask of codewords whose state differs between two layer
    states beyond STEP_TOL; with ``slack`` (sums, codewords: [nb, k, f]
    each, what adding the batch's rows in another order, rows that
    themselves differ by STEP_TOL, may move them) the cluster sums and
    codewords beyond STEP_TOL plus that slack."""
    import torch
    cb_a, cb_b = a.codebook, b.codebook
    bad = torch.zeros(cb_a.cluster_size.shape, dtype=torch.bool)
    if slack is None:
        for fa, fb in ((cb_a.codewords_w, cb_b.codewords_w),
                       (cb_a.cluster_sum, cb_b.cluster_sum)):
            bad |= ~torch.isclose(fa, fb, **STEP_TOL).all(-1)
    else:
        for fa, fb, sl in ((cb_a.codewords_w, cb_b.codewords_w, slack[1]),
                           (cb_a.cluster_sum, cb_b.cluster_sum, slack[0])):
            tol = STEP_TOL["atol"] + STEP_TOL["rtol"] * fb.abs() + sl
            bad |= ((fa - fb).abs() > tol).any(-1)
    for fa, fb in ((cb_a.cluster_size, cb_b.cluster_size),
                   (a.counts, b.counts)):
        bad |= ~torch.isclose(fa, fb, **STEP_TOL)
    return bad


def _check_snapshots(tag: str, a, b, agree_cw) -> None:
    """Quantize-on-update snapshots of a card step and a CPU step: on the
    codewords whose state agrees (``agree_cw`` [nb, k]) every dequantized
    value within two quanta of the other's (each is its codeword rounded
    to its own grid: half a quantum apart at most, plus the STEP_TOL the
    codewords may differ by) -- 1 for int8, 2^-3 of the value (2^-9 near
    zero) for fp8 e4m3 -- and the storage dtypes equal."""
    import torch
    for name in ("feat", "grad"):
        qa, qb = getattr(a.qcw, name), getattr(b.qcw, name)
        if qa.q.dtype != qb.q.dtype:
            raise SystemExit(f"{tag}: {name} snapshot dtypes differ")
        va, vb = qa.q.float(), qb.q.float()
        step = 1.0 if qa.q.dtype == torch.int8 \
            else torch.maximum(va.abs(), vb.abs()) / 8 + 2.0 ** -9
        da, db = va * qa.scale, vb * qb.scale
        tol = 2 * step * torch.maximum(qa.scale, qb.scale) \
            + STEP_TOL["atol"] + STEP_TOL["rtol"] * db.abs()
        bad = ((da - db).abs() > tol) & agree_cw[..., None]
        if bool(bad.any()):
            raise SystemExit(f"{tag}: {int(bad.sum())} {name} snapshot "
                             f"values beyond two quanta")


def split_step_check(tag: str, p0, ost0, grads_a, grads_b, upd_a,
                     params_a, params_b, opt, lr: float,
                     alpha: float = 0.99, eps: float = 1e-8) -> dict:
    """An RMSprop step of side a (the card) against side b (the CPU), each
    part compared where it is well-conditioned, all on the CPU, all within
    STEP_TOL:

    (a) the step's gradients, ``grads_a`` against ``grads_b``;
    (b) side a's RMSprop update of its own gradients (``upd_a``: params
        and ``nu``, from ``p0`` / ``ost0``) against the CPU's RMSprop
        applied to the same gradients;
    (c) side a's new params against side b's (``params_a`` /
        ``params_b``, each from its own whole step) on every element where
        lr / (sqrt(v^) + eps) -- RMSprop's gain from a gradient to its
        param, v^ side b's new ``nu`` -- times the gradient's STEP_TOL is
        within the param's STEP_TOL.  Where v^ nears 0 that gain reaches
        ~1e2 and a gradient difference inside STEP_TOL (the card's order of
        adds) becomes a param difference outside it: (a) and (b) hold those
        elements instead.  The count outside the mask and the worst gain
        ratio among them are returned and printed.

    The lists are per layer dicts (CPU tensors) as ``vq_loss_and_grads``
    returns them."""
    import torch
    worst = 0.0
    for l in range(len(grads_b)):
        for k in grads_b[l]:
            worst = max(worst, check_close(f"{tag} grad {l}.{k}",
                                           grads_a[l][k], grads_b[l][k],
                                           STEP_TOL))
    ref_p, ref_o = opt.update(grads_a, ost0, p0)
    for l in range(len(grads_b)):
        for k in grads_b[l]:
            worst = max(worst, check_close(
                f"{tag} rmsprop of its own grads {l}.{k}", upd_a[0][l][k],
                ref_p[l][k], STEP_TOL))
            worst = max(worst, check_close(
                f"{tag} rmsprop nu of its own grads {l}.{k}",
                upd_a[1].nu[l][k], ref_o.nu[l][k], STEP_TOL))
    at, rt = STEP_TOL["atol"], STEP_TOL["rtol"]
    outside, ratio_max, n_all = 0, 0.0, 0
    for l in range(len(grads_b)):
        for k in grads_b[l]:
            g, pb = grads_b[l][k].float(), params_b[l][k].float()
            v = alpha * ost0.nu[l][k].float() + (1 - alpha) * g * g
            gain = lr / (torch.sqrt(v) + eps)
            ratio = gain * (at + rt * g.abs()) / (at + rt * pb.abs())
            ok = ratio <= 1.0
            err = (params_a[l][k].float() - pb).abs()
            bad = ok & (err > at + rt * pb.abs())
            if bool(bad.any()):
                raise SystemExit(
                    f"{tag} param {l}.{k}: {int(bad.sum())} well-conditioned "
                    f"elements beyond STEP_TOL (max abs err "
                    f"{float(err[ok].max())})")
            if bool(ok.any()):
                worst = max(worst, float(err[ok].max()))
            outside += int((~ok).sum())
            n_all += ok.numel()
            if bool((~ok).any()):
                ratio_max = max(ratio_max, float(ratio[~ok].max()))
    log(f"{tag}: gradients and each side's RMSprop of the card's gradients "
        f"within STEP_TOL; params within STEP_TOL on {n_all - outside} of "
        f"{n_all} elements, {outside} ill-conditioned (worst gain ratio "
        f"{ratio_max:.4g}) held by the gradients alone")
    return {"max_abs_err": worst, "ill_conditioned": outside,
            "elements": n_all, "worst_gain_ratio": ratio_max}


def phase_train_parity(m: Model, params, vq, ost, cpu: Model,
                       tag: str = "train parity",
                       hybrid: bool = False,
                       batch: int = PARITY_BATCH,
                       sum_slack: bool = False,
                       split_params: bool = False) -> dict:
    """One training step at batch PARITY_BATCH on the card and on the CPU
    plain path from the same (trained) state; with ``hybrid`` the batch is
    the hybrid's, PARITY_BATCH seeds widened by as many LABOR-sampled
    context slots (loss-masked).  Loss, output, params,
    optimizer state, VQ errors and whitening moments agree within
    STEP_TOL; the refreshed assignments agree on >= 99.9 % of the batch's
    entries and every mismatch is a near-tie; codeword statistics agree
    except on codewords a flipped row touched or that were revived; under
    a tier the requantized snapshots agree within two quanta.

    ``sum_slack`` (the attention backbones' parity only) widens the cluster
    sums' and codewords' tolerance by what the order of a codeword's adds
    may move them where its rows cancel; every other caller holds them to
    STEP_TOL alone.  ``split_params`` (the Graph Transformer's parity
    only) compares the params in the parts of ``split_step_check`` (the
    step's gradients; each side's RMSprop of the card's gradients; the
    params where RMSprop does not magnify a gradient difference past
    STEP_TOL); every other caller holds the params to STEP_TOL
    directly."""
    import torch
    from repro_torch.convert import to_device
    from repro_torch.core import codebook as cbm
    from repro_torch.models.gnn import vq_train_step
    from repro_torch.train.optimizer import rmsprop
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    opt = rmsprop(PAPER_LR)
    rng = np.random.default_rng(SEED + 3)
    bids, smask = rng.choice(m.g.n, batch, replace=False), None
    if hybrid:
        from repro_torch.graph.sampling import hybrid_epoch_batches
        ids, sm = hybrid_epoch_batches(m.g, PARITY_BATCH,
                                       [5] * m.cfg.n_layers, rng,
                                       n_ctx=PARITY_BATCH, idx_pool=bids)
        bids, smask = ids[0], sm[0]
    state_c = to_device((params, vq, ost), "cpu")
    res = {}
    for side, mm, (p, v, o) in (("cuda", m, (params, vq, ost)),
                                ("cpu", cpu, state_c)):
        pack, x_b, y_b, lm, *pairs = mm.batch_inputs(bids, smask)
        t0 = time.time()
        out = vq_train_step(p, v, o, pack, x_b, y_b, mm.ops.degrees, m.cfg,
                            opt, loss_mask=lm, **(pairs[0] if pairs else {}))
        out = to_device(out, "cpu")
        res[side] = (out, time.time() - t0)
    (pg, vg, og, lg, yg, eg), t_gpu = res["cuda"]
    (pc, vc, oc, lc, yc, ec), t_cpu = res["cpu"]
    if not np.isfinite(float(lg)):
        raise SystemExit(f"{tag}: non-finite loss")
    worst = 0.0
    for name, a, b in [("loss", lg, lc), ("output", yg, yc),
                       ("vq_errs", eg, ec)] + ([] if split_params else [
            (f"param {l}.{k}", pg[l][k], pc[l][k])
            for l in range(len(pg)) for k in pg[l]]) + [
            (f"rmsprop nu {l}.{k}", og.nu[l][k], oc.nu[l][k])
            for l in range(len(pg)) for k in pg[l]]:
        worst = max(worst, check_close(f"{tag} {name}", a, b, STEP_TOL))
    split = None
    cb = m.cfg.layer_codebook_cfg()
    bids_t = torch.from_numpy(bids).long()
    outside = ~torch.isin(torch.arange(m.g.n), bids_t)
    vw_c, acts = None, None
    if sum_slack or split_params:
        # the card step's own whitened rows, for the cluster sums' slack:
        # each side adds a codeword's rows in its own order, and the rows
        # differ by STEP_TOL, so a sum of c rows may move by
        # (rtol + 2 c 2^-24) sum |row| + c atol (times 1 - gamma through
        # the EMA; over the cluster size for the codeword) -- beyond
        # STEP_TOL of the sum where the rows cancel
        _, _, acts_g, grads_g, gpr_g = _loss_grads(
            m, params, vq, m.batch_inputs(bids, smask))
    if split_params:
        upd_g = to_device(opt.update(grads_g, ost, params), "cpu")
        _, _, acts, grads_c, gpr = _loss_grads(
            cpu, state_c[0], state_c[1], cpu.batch_inputs(bids, smask))
        split = split_step_check(f"{tag} split step", state_c[0], state_c[2],
                                 to_device(grads_g, "cpu"), grads_c, upd_g,
                                 pg, pc, opt, PAPER_LR)
        worst = max(worst, split["max_abs_err"])
        del upd_g, grads_g, grads_c
    summary = []
    for l, (a, b) in enumerate(zip(vg, vc)):
        for name in ("mean", "var"):
            check_close(f"{tag} layer {l} {name}",
                        getattr(a.codebook, name), getattr(b.codebook, name),
                        STEP_TOL)
        if int(a.codebook.step) != int(b.codebook.step):
            raise SystemExit(f"{tag} layer {l}: codebook step")
        ta, tb_ = _dense_table(a.assignment), _dense_table(b.assignment)
        ag, ac = ta[:, bids_t], tb_[:, bids_t]
        flip = ag != ac
        agree = 1.0 - float(flip.float().mean())
        if not torch.equal(ta[:, outside], tb_[:, outside]):
            raise SystemExit(f"{tag} layer {l}: assignments outside "
                             f"the batch changed")
        if bool(flip.any()):
            if vw_c is None:     # the CPU step's own whitened rows
                if acts is None:
                    _, _, acts, _, gpr = _loss_grads(
                        cpu, state_c[0], state_c[1],
                        cpu.batch_inputs(bids, smask))
                vw_c = [cbm.whitened_rows(state_c[1][i].codebook, acts[i],
                                          gpr[i], cb)[0]
                        for i in range(len(acts))]
            c = state_c[1][l].codebook.codewords_w.double()
            x = vw_c[l].double()
            beta = torch.arange(c.shape[0])[:, None]

            def dist(idx):
                cr = c[beta, idx.long()]
                return (cr * cr).sum(-1) - 2 * (x * cr).sum(-1)
            dg, dc = dist(ag), dist(ac)
            far = flip & ((dg - dc).abs() > 1e-5 * (1 + dc.abs()))
            if bool(far.any()):
                raise SystemExit(f"{tag} layer {l}: {int(far.sum())} "
                                 f"assignment mismatches are not near-ties")
        if agree < 0.999:
            raise SystemExit(f"{tag} layer {l}: assignment agreement "
                             f"{agree:.6f} < 0.999")
        k = a.codebook.k
        touched = torch.zeros((ag.shape[0], k), dtype=torch.bool)
        rows_b = torch.arange(ag.shape[0])[:, None].expand_as(ag)
        touched[rows_b[flip], ag[flip].long()] = True
        touched[rows_b[flip], ac[flip].long()] = True
        revived = (a.codebook.cluster_size == 1.0) | \
            (b.codebook.cluster_size == 1.0)
        slack = None
        if sum_slack:
            vw_g = cbm.whitened_rows(vq[l].codebook, acts_g[l], gpr_g[l],
                                     cb)[0].cpu()
            nb_, _, f_ = vw_g.shape
            flat = (ag.long() + k * torch.arange(nb_)[:, None]).reshape(-1)
            abs_sum = torch.zeros((nb_ * k, f_)).index_add_(
                0, flat, vw_g.abs().reshape(-1, f_)).reshape(nb_, -1, f_)
            rows_in = torch.bincount(flat, minlength=nb_ * k
                                     ).reshape(nb_, -1, 1)
            sl_sum = (1 - cb.gamma) * (
                (STEP_TOL["rtol"] + 2 * rows_in * U32) * abs_sum
                + rows_in * STEP_TOL["atol"])
            slack = (sl_sum, sl_sum / torch.clamp(
                b.codebook.cluster_size, min=cb.eps)[..., None])
        bad = _codeword_mismatch(a, b, slack)
        if bool((bad & ~(touched | revived)).any()):
            raise SystemExit(f"{tag} layer {l}: "
                             f"{int((bad & ~(touched | revived)).sum())} "
                             f"codewords differ that no flipped or revived "
                             f"row explains")
        if int(bad.sum()) > max(4, 0.001 * bad.numel()):
            raise SystemExit(f"{tag} layer {l}: {int(bad.sum())} "
                             f"codewords differ")
        if a.qcw is not None or b.qcw is not None:
            _check_snapshots(f"{tag} layer {l}", a, b, ~bad)
        summary.append(dict(layer=l, agreement=agree, flips=int(flip.sum()),
                            codewords_differ=int(bad.sum()),
                            revived=int(revived.sum())))
        log(f"{tag} layer {l}: assignment agreement {agree:.6f} "
            f"({int(flip.sum())} near-tie flips), {int(bad.sum())} of "
            f"{bad.numel()} codewords differ (flipped or revived rows), "
            f"{int(revived.sum())} revived")
    log(f"{tag}: one step at batch {len(bids)}, card vs CPU plain "
        f"path: loss {float(lg):.6f} vs {float(lc):.6f}, max abs err "
        f"{worst:.3g} (rtol 1e-4, atol 1e-5); card {t_gpu:.3f} s, CPU "
        f"{t_cpu:.3f} s")
    rep = {"layers": summary, "max_abs_err": worst}
    if split is not None:
        rep["split"] = {k: v for k, v in split.items() if k != "max_abs_err"}
    return rep


def _spmm_row(idx, val, x, at: str) -> dict:
    """spmm_ell against its plain version (bit for bit: the kernel adds
    the slots in the plain version's order and leaves out the padding,
    which adds +-0 to a finite source) and ``torch.sparse.mm`` on one set
    of operands: idx/val [b, D], source x [n_src, f].  Also timed with
    every zero value replaced by the smallest subnormal
    (``ms_padding_loaded``): the same kernel gathering every slot, the
    other choice for padding."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmm_ell import spmm_ell_cuda
    got, want = spmm_ell_cuda(idx, val, x), ref.spmm_ell(idx, val, x)
    _bit_equal(f"spmm_ell {at}", got, want)
    err = 0.0
    b, deg = idx.shape
    f = x.shape[1]
    n_rows = int(torch.unique(idx).numel())
    bms, by = bound(8 * b * deg + 4 * n_rows * f + 4 * b * f, 2 * b * deg * f)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.arange(b, device=x.device).repeat_interleave(deg),
                     idx.reshape(-1).long()]), val.reshape(-1),
        (b, x.shape[0]), check_invariants=True).coalesce()
    check_close(f"spmm_ell library call {at}", torch.sparse.mm(coo, x), want,
                SERVE_TOL)
    big = b * deg * f > 1e7              # fewer repetitions of the big ones
    ms, call_ms = cuda_ms(lambda: spmm_ell_cuda(idx, val, x), 5 if big else 10)
    every = torch.where(val == 0, torch.full_like(val, 1e-45), val)
    ms_padding_loaded = cuda_ms(lambda: spmm_ell_cuda(idx, every, x),
                                5 if big else 10)[0]
    row = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
               ms_padding_loaded=ms_padding_loaded,
               padding_share=float((val == 0).float().mean()),
               plain_ms=cuda_ms(lambda: ref.spmm_ell(idx, val, x),
                                3 if big else 5, inner=1 if big else 20)[0],
               bound_ms=bms, bound_by=by,
               library_ms=cuda_ms(lambda: torch.sparse.mm(coo, x),
                                  5 if big else 10)[0],
               at=f"b={b} D={deg} f={f} n_src={x.shape[0]} "
                  f"({4 * x.shape[0] * f / 1e6:.1f} MB source) {at}")
    log(f"spmm_ell {row['at']}: bit-equal  kernel {ms:.5f} ms (one call "
        f"{call_ms:.5f} ms; every slot gathered {ms_padding_loaded:.5f} ms, "
        f"padding {row['padding_share']:.4f} of the slots)  plain "
        f"{row['plain_ms']:.5f} ms  sparse.mm {row['library_ms']:.5f} ms  "
        f"bound {bms:.6f} ms ({by})")
    return row


def _layouts(a, at: str, tier: bool):
    """The layout the main path holds table ``a`` in -- failing unless it
    is ``core.conv.hold_table``'s: node-major for a tier state's table on
    the card, row-major for an fp32 state's -- and the same table in the
    other layout, to time against it."""
    from repro_torch.distributed.quantization import PackedAssignment
    from repro_torch.kernels.context_ell import is_node_major
    packed = isinstance(a, PackedAssignment)
    buf = a.packed if packed else a
    nm = is_node_major(buf)
    if nm != tier or not (nm or buf.is_contiguous()):
        raise SystemExit(f"context_ell {at}: the table is not held in "
                         f"core.conv.hold_table's layout")
    other = buf.contiguous() if nm else buf.t().contiguous().t()
    return ("node-major" if nm else "row-major",
            PackedAssignment(other, a.n) if packed else other)


def _bit_equal(name: str, got, want) -> None:
    import torch
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"{name}: not bit-equal to its plain version (max "
                         f"abs err {float((got - want).abs().max())})")


def _context_row(ids, vals, a, cw, at: str) -> dict:
    """The plain form of context_ell against its plain version on one set
    of operands, bit for bit: ids/vals [b, D], assignment a [nb, n],
    codewords cw [nb, k, fb]; timed on the table as the main path holds it
    (``ms``) and in the other layout (``ms_other_layout``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.context_ell import context_ell_cuda
    layout, other = _layouts(a, at, False)
    want = ref.context_ell(ids, vals, a, cw)
    _bit_equal(f"context_ell {at}", context_ell_cuda(ids, vals, a, cw), want)
    _bit_equal(f"context_ell {at} (other layout)",
               context_ell_cuda(ids, vals, other, cw), want)
    err = 0.0
    b, deg = ids.shape
    nb, k, fb = cw.shape
    uid = torch.unique(ids.long())
    pairs = torch.unique(a[:, uid].long()
                         + k * torch.arange(nb, device=a.device)[:, None])
    byt = 8 * b * deg + 4 * nb * uid.numel() + 4 * fb * pairs.numel() \
        + 4 * b * nb * fb
    bms, by = bound(byt, 2 * b * deg * nb * fb)
    big = b * deg * nb * fb > 1e7
    ms, call_ms = cuda_ms(lambda: context_ell_cuda(ids, vals, a, cw),
                          5 if big else 10)
    row = dict(max_abs_err=err, bound_ms=bms, bound_by=by, ms=ms,
               call_ms=call_ms, library_ms=None, layout=layout,
               ms_other_layout=cuda_ms(lambda: context_ell_cuda(
                   ids, vals, other, cw), 5 if big else 10)[0],
               plain_ms=cuda_ms(lambda: ref.context_ell(ids, vals, a, cw), 3
                                if big else 5, inner=2 if big else 20)[0],
               at=f"b={b} D={deg} n={a.shape[1]} nb={nb} k={k} fb={fb} {at}")
    log(f"context_ell {row['at']}: bit-equal  kernel {ms:.5f} ms (one call "
        f"{call_ms:.5f} ms; table {layout}, the other layout "
        f"{row['ms_other_layout']:.5f} ms)  plain {row['plain_ms']:.5f} ms  "
        f"bound {bms:.6f} ms ({by})  library none")
    return row


def phase_kernels(server) -> list[dict]:
    """Each kernel vs its plain version on the served model's operands."""
    import torch
    from repro_torch.core import codebook as cbm
    from repro_torch.core.conv import fixed_conv_operands
    from repro_torch.graph.batching import plan_batch
    from repro_torch.kernels import ref
    from repro_torch.kernels.vq_assign import kstep, vq_assign_cuda

    dev = server.device
    cfg = server.cfg.codebook
    rng = np.random.default_rng(SEED + 7)
    bids = torch.from_numpy(rng.choice(server.g.n, BATCH, replace=False)
                            .astype(np.int32)).to(dev)
    pack = plan_batch(server.plan, bids)
    ops_, _ = fixed_conv_operands("gcn", pack, server.ops.degrees)
    rows = []

    # --- spmm_ell: the intra-batch term of one serve step ---
    x_b = server.x[bids.long()].contiguous()
    row = _spmm_row(torch.clamp(ops_.in_pos, min=0).contiguous(),
                    ops_.in_vals.contiguous(), x_b, "(serve step)")
    rows.append(dict(name="spmm_ell", route="cuda",
                     source="src/repro_torch/kernels/csrc/spmm_ell.cu",
                     replaces="src/repro/kernels/spmm_ell.py:56", **row))

    # --- context_ell: the codeword context of layer 0 and layer 2 ---
    ctx = []
    for layer in (0, len(server.vq) - 1):
        vq = server.vq[layer]
        fi = server.cfg.layer_dims()[layer][0]
        ctx.append(_context_row(
            ops_.out_ids.contiguous(), ops_.out_vals.contiguous(),
            vq.assignment, cbm.feature_codewords(vq.codebook, fi, cfg),
            f"(serve step, layer {layer})"))
    rows.append(dict(name="context_ell", route="cuda",
                     source="src/repro_torch/kernels/csrc/context_ell.cu",
                     replaces="src/repro/kernels/context_ell.py:138",
                     **{k: v for k, v in ctx[0].items() if k != "max_abs_err"},
                     max_abs_err=max(c["max_abs_err"] for c in ctx),
                     also=ctx[1:]))

    # --- vq_assign: the inductive refresh over every node ---
    asg = []
    for layer in (0, len(server.vq) - 1):
        st = server.vq[layer].codebook
        nb = st.n_branches
        fb = server.x.shape[1] // nb
        v = server.x.reshape(server.g.n, nb, fb)
        v = cbm._whiten(v, st.mean[:, :fb], st.var[:, :fb], cfg.eps)
        x = v.transpose(0, 1)
        cw = st.codewords_w[:, :, :fb].contiguous()
        got, gmin = vq_assign_cuda(x, cw, want_min=True)
        want, wmin = ref.vq_assign(x, cw, want_min=True)
        torch.cuda.synchronize()
        if not torch.equal(got, vq_assign_cuda(x, cw)):
            raise SystemExit("vq_assign: want_min changed the assignment")
        # the scan rescores every codeword that can win in the plain
        # version's arithmetic: index and minimum are bit-equal everywhere
        rate = float((got == want).float().mean())
        if rate != 1.0 or not torch.equal(gmin, wmin):
            raise SystemExit(
                f"vq_assign: agreement {rate:.6f}, want_min "
                f"{int((gmin != wmin).sum())} rows not bit-equal to the "
                f"plain version")
        err = float((gmin - wmin).abs().max())
        n, k = x.shape[1], cw.shape[1]
        byt = 4 * nb * n * fb + 4 * nb * k * fb + 4 * nb * n
        bms, by = bound(byt, 2 * nb * n * k * fb)
        # the bounds of the kernel's own units: its 3xTF32 products (f
        # padded to the mma's depth, 4 at f 4, else 8) on the tensor cores,
        # and one compare-select a distance at the fp32 issue rate
        ks = kstep(fb)
        tc_ms = 3 * 2 * nb * n * k * ks * -(-fb // ks) / TF32_FLOP_PER_S * 1e3
        sel_ms = nb * n * k / (FP32_FLOP_PER_S / 2) * 1e3
        ms, call_ms = cuda_ms(lambda: vq_assign_cuda(x, cw), 5, inner=2)
        min_ms = cuda_ms(lambda: vq_assign_cuda(x, cw, want_min=True), 5,
                         inner=2)[0]
        # the scan's band follows the norms of the codewords that can win;
        # the branch's largest and the rows' mean norm show the spread
        cmax = float(cw.norm(dim=2).max())
        x_norm = float(x.norm(dim=2).mean())
        asg.append(dict(
            max_abs_err=err, agreement=rate, bound_ms=bms, bound_by=by,
            cmax=cmax, x_norm_mean=x_norm,
            tensor_bound_ms=tc_ms, select_bound_ms=sel_ms,
            ms=ms, call_ms=call_ms, want_min_ms=min_ms,
            want_min_max_abs_err=err,
            plain_ms=cuda_ms(lambda: ref.vq_assign(x, cw), 3, inner=1)[0],
            at=f"x=[{nb}, {n}, {fb}] cw=[{nb}, {k}, {fb}]"))
        c = asg[-1]
        log(f"vq_assign {c['at']}: idx and want_min bit-equal (agreement "
            f"{rate:.6f})  kernel {ms:.4f} ms (one call {call_ms:.4f} ms; "
            f"with want_min {min_ms:.4f} ms)  plain {c['plain_ms']:.4f} ms  "
            f"bound {bms:.4f} ms ({by}; 3xTF32 products {tc_ms:.4f} ms, "
            f"compare-selects {sel_ms:.4f} ms)  library none  largest "
            f"codeword norm {cmax:.4g}, mean row norm {x_norm:.4g}")
    rows.append(dict(name="vq_assign", route="cuda",
                     source="src/repro_torch/kernels/csrc/vq_assign.cu",
                     replaces="src/repro/kernels/vq_assign.py:83",
                     max_abs_err=max(c["max_abs_err"] for c in asg),
                     agreement=min(c["agreement"] for c in asg),
                     want_min_max_abs_err=max(c["want_min_max_abs_err"]
                                              for c in asg),
                     want_min_ms=asg[0]["want_min_ms"],
                     ms=asg[0]["ms"], plain_ms=asg[0]["plain_ms"],
                     bound_ms=asg[0]["bound_ms"],
                     bound_by=asg[0]["bound_by"],
                     tensor_bound_ms=asg[0]["tensor_bound_ms"],
                     select_bound_ms=asg[0]["select_bound_ms"],
                     library_ms=None,
                     call_ms=asg[0]["call_ms"], at=asg[0]["at"],
                     also=asg[1:]))
    return rows


def _counters() -> dict:
    """Kernel name -> (wrapper module, counter attribute)."""
    from repro_torch.kernels import (context_ell, flash_attention, spmm_ell,
                                     spmm_ell_hbm, vq_assign, vq_attention,
                                     vq_update)
    return {"vq_attention": (vq_attention, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_tc": (flash_attention, "launches_tc"),
            "flash_attention_fma": (flash_attention, "launches_fma"),
            "vq_assign": (vq_assign, "launches"),
            "vq_assign_wide": (vq_assign, "launches_wide"),
            "vq_update": (vq_update, "launches"),
            "vq_update_u8": (vq_update, "launches_u8"),
            "vq_update_wide": (vq_update, "launches_wide"),
            "spmm_ell": (spmm_ell, "launches"),
            "spmm_ell_q": (spmm_ell, "launches_q"),
            "spmm_ell_t": (spmm_ell, "launches_t"),
            "spmm_ell_hbm": (spmm_ell_hbm, "launches"),
            "spmm_ell_hbm_q": (spmm_ell_hbm, "launches_q"),
            "context_ell": (context_ell, "launches"),
            "context_ell_wt": (context_ell, "launches_wt"),
            "context_ell_q": (context_ell, "launches_q"),
            "context_ell_q_wt": (context_ell, "launches_q_wt")}


# the keyed counters read_counts adds beside the plain ones
KEYED = ("entries", "shapes")


def shape_key(kernel: str, nb: int, n: int, k: int, f: int,
              emit: str | None = None) -> str:
    """The name of one wide-build operand shape in ``read_counts()
    ["shapes"]``, as its wrapper keys it."""
    return f"{kernel} x=[{nb}, {n}, {f}] k={k}" + \
        ("" if emit is None else f" {emit}")


def reset_counts() -> None:
    from repro_torch.kernels import context_ell, vq_assign, vq_update
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
    context_ell.launches_by_entry.clear()
    vq_update.launches_wide_by_shape.clear()
    vq_assign.launches_wide_by_shape.clear()


def read_counts() -> dict:
    """The counters, context_ell's launches by library entry under
    ``"entries"``, and the wide build's launches by operand shape (as the
    vq_update and vq_assign wrappers count them) under ``"shapes"``."""
    from repro_torch.kernels import context_ell, vq_assign, vq_update
    got = {k: getattr(mod, attr) for k, (mod, attr) in _counters().items()}
    got["entries"] = dict(context_ell.launches_by_entry)
    got["shapes"] = {
        **{shape_key("vq_update", *key): v
           for key, v in vq_update.launches_wide_by_shape.items()},
        **{shape_key("vq_assign", *key): v
           for key, v in vq_assign.launches_wide_by_shape.items()}}
    return got


def add_counts(a: dict, b: dict) -> dict:
    out = {k: a[k] + b[k] for k in a if k not in KEYED}
    for key in KEYED:
        out[key] = {e: a[key].get(e, 0) + b[key].get(e, 0)
                    for e in {**a[key], **b[key]}}
    return out


def expect_counts(what: str, got: dict, want: dict) -> None:
    """The counters against ``want`` (a counter it does not name must be
    0); the keyed counts are printed, and the wide build's by shape must
    add up to its total of each kernel."""
    want = {k: want.get(k, 0) for k in got if k not in KEYED}
    log(f"{what} launches: {got}")
    if {k: v for k, v in got.items() if k not in KEYED} != want:
        raise SystemExit(f"{what}: launch counts {got}, expected {want}")
    for kernel in ("vq_update", "vq_assign"):
        by_shape = sum(v for key, v in got["shapes"].items()
                       if key.startswith(kernel + " "))
        if by_shape != got[f"{kernel}_wide"]:
            raise SystemExit(f"{what}: {kernel}'s wide launches by shape "
                             f"add to {by_shape}, not "
                             f"{got[f'{kernel}_wide']}")


def phase_main_path(server, requests, tag: str = "serve"
                    ) -> tuple[dict, dict]:
    """A serving main path: refresh, warm-up and the drain of
    ``requests``, launch counts checked exactly (the quantized forms of
    context_ell in place of the f32 one when the states carry codeword
    snapshots)."""
    from repro_torch.launch.serve_gnn import drain_requests
    n_layers = server.cfg.n_layers
    steps_per_layer = -(-server.g.n // server.batch)
    q = server.vq[0].qcw is not None
    reset_counts()
    t_refresh = server.refresh()
    refresh_counts = read_counts()
    expect_counts(f"{tag} refresh", refresh_counts, {
        "vq_assign": n_layers,
        "spmm_ell": n_layers * steps_per_layer,
        "context_ell": n_layers * steps_per_layer,
        "context_ell_q": n_layers * steps_per_layer if q else 0})
    log(f"{tag} refresh: {t_refresh:.3f} s for {server.g.n} nodes x "
        f"{n_layers} layers ({steps_per_layer} batches of {server.batch} "
        f"per layer)")
    reset_counts()
    t_warm = server.warmup()
    rep = drain_requests(server, requests)
    serve_counts = read_counts()
    steps = rep["steps"] + 1                      # + the warm-up step
    expect_counts(tag, serve_counts, {
        "spmm_ell": n_layers * steps, "context_ell": n_layers * steps,
        "context_ell_q": n_layers * steps if q else 0})
    rep.update(refresh_s=t_refresh, warmup_s=t_warm)
    log(f"{tag}: {rep['nodes']} nodes / {rep['requests']} requests in "
        f"{rep['steps']} steps, {rep['wall_s']:.4f} s -> "
        f"{rep['nodes_per_s']:.1f} nodes/s; step p50 "
        f"{rep['step_p50_ms']:.4f} ms p99 {rep['step_p99_ms']:.4f} ms; "
        f"request p50 {rep['request_p50_ms']:.4f} ms p99 "
        f"{rep['request_p99_ms']:.4f} ms; warmup {t_warm:.4f} s")
    return rep, add_counts(refresh_counts, serve_counts)


def phase_cpu_parity(server, requests, tag: str = "cpu parity") -> None:
    """The GPU server's state on the CPU, served through the plain
    versions: the same rows must come out."""
    from repro_torch.convert import to_device
    from repro_torch.launch.serve_gnn import GNNServer
    cpu = GNNServer(server.g, server.cfg, to_device(server.params, "cpu"),
                    to_device(server.vq, "cpu"), server.batch, device="cpu")
    batches = [np.concatenate(requests[:6]),
               np.arange(server.batch) % 100,       # duplicate ids
               np.asarray(requests[6])]
    worst = 0.0
    for i, ids in enumerate(batches):
        got, want = server.serve(ids), cpu.serve(ids)
        if got.shape != (len(ids), server.f_out) or \
                not np.all(np.isfinite(got)):
            raise SystemExit(f"served rows: shape {got.shape} or non-finite")
        if not np.allclose(got, want, **SERVE_TOL):
            raise SystemExit(f"{tag} batch {i}: GPU rows disagree with "
                             f"the CPU plain path (max abs err "
                             f"{np.abs(got - want).max()})")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"{tag}: {sum(len(b) for b in batches)} served rows agree with "
        f"the CPU plain path, max abs err {worst:.3g} (rtol 1e-4, atol 1e-5)")


# kernel-name groups of a training step's device time, first match wins
LM_KERNEL_GROUPS = (
    ("f32 GEMM", ("sgemm", "f32f32_f32f32")),
    ("other GEMM (bf16)", ("gemm", "nvjet", "xmma", "cutlass")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("index / scatter / gather / cat", ("index", "scatter", "gather",
                                        "cat")),
    ("elementwise", ("elementwise",)),
)


def _profile(what: str, steps: list, run, groups=None,
             cpu: bool = True) -> dict:
    """Device busy share and kernel time by name over ``run(s)`` for each
    of ``steps`` (only device-side events count: an aten op's row repeats
    its kernels'); with ``groups`` also the device ms of each group of
    kernel names (``(label, substrings)``, first match wins; the rest
    under "other").  ``cpu=False`` records the device's activity only: a
    window of ~65 k kernels then takes seconds to summarise, not a
    minute."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for s in steps:
            run(s)
        torch.cuda.synchronize()
        wall = time.time() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    if not evs:
        raise SystemExit(f"{what}: profiler recorded no device time")
    dev_us = sum(e.self_device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    rep = {"what": what, "steps": len(steps), "wall_ms": wall * 1e3,
           "device_ms": dev_us / 1e3,
           "device_busy_share": dev_us / 1e3 / (wall * 1e3),
           "kernels_per_step": sum(e.count for e in evs) / len(steps),
           "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                   for e in top]}
    if groups is not None:
        by = {label: 0.0 for label, _ in groups} | {"other": 0.0}
        for e in evs:
            key = e.key.lower()
            label = next((lb for lb, subs in groups
                          if any(x in key for x in subs)), "other")
            by[label] += e.self_device_time_total / 1e3 / len(steps)
        rep["device_ms_per_step_by_group"] = by
    log(json.dumps({"profile": rep}))
    return rep


def phase_profile(server, requests) -> None:
    """The profile of 20 serve steps."""
    flat = np.concatenate(requests)[:20 * server.batch]
    steps = [flat[i:i + server.batch] for i in range(0, len(flat),
                                                      server.batch)]
    _profile("serve", [s for s in steps if len(s) == server.batch],
             server.step)


def phase_train_profile(m: Model, params, vq, ost) -> None:
    """The profile of 2 training steps from the trained state (their
    results are dropped), of ``m.cfg``'s backbone."""
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    from repro_torch.models.gnn import vq_train_step
    from repro_torch.train.optimizer import rmsprop
    opt = rmsprop(PAPER_LR)
    rng = np.random.default_rng(SEED + 13)
    batches = [rng.permutation(m.g.n)[:m.batch] for _ in range(2)]

    def step(bids):
        pack, x_b, y_b, lm = m.batch_inputs(bids)
        vq_train_step(params, vq, ost, pack, x_b, y_b, m.ops.degrees, m.cfg,
                      opt, loss_mask=lm)
    step(batches[0])                      # warm: allocator, first launches
    _profile(f"train {m.cfg.backbone}", batches, step)


# ---------------------------------------------------------------------------
# the sampling baselines, the hybrid and the staged SpMM
# ---------------------------------------------------------------------------

def _spmm_split(cfg, rows: int, steps: int) -> tuple[int, int]:
    """(staged, resident) SpMM launches of ``steps`` exact-message-passing
    steps over an ``rows``-row source: one a layer, on the kernel
    ``spmm_ell_variant`` picks for the layer's input width."""
    from repro_torch.kernels import ops as kops
    staged = sum(kops.spmm_ell_variant(rows, fi, 4) == "hbm"
                 for fi, _ in cfg.layer_dims())
    return staged * steps, (cfg.n_layers - staged) * steps


def phase_sampler_train(g, cfg, batch: int) -> tuple[dict, dict]:
    """The sampling baselines' main path: ``train_scenario`` for each of
    SAMPLER_METHODS, SAMPLER_EPOCHS epochs at the reference's scenario
    defaults, then one full-graph evaluation.  Per step every layer runs
    the SpMM over the padded subgraph (the staged kernel above the L2
    budget) and every layer but the first its backward spmm_ell_t; the
    evaluation stages the full graph's SpMM once a layer.  The counts are
    checked exactly, and NS-SAGE, LABOR and GraphSAINT must stage every
    step's SpMMs, Cluster-GCN none.  Gates: finite losses, the last
    epoch's mean loss under the first's."""
    import torch
    from repro_torch.train.gnn_trainer import train_scenario
    reps, total = {}, None
    for method in SAMPLER_METHODS:
        reset_counts()
        t0 = time.time()
        r = train_scenario(g, cfg, method, epochs=SAMPLER_EPOCHS,
                           batch_size=batch, seed=SEED, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        per_epoch = [len(ls) for ls in r["losses"]]
        staged = resident = 0
        for s, rows in zip(per_epoch, r["subgraph_rows"]):
            st, re_ = _spmm_split(cfg, rows, s)
            staged, resident = staged + st, resident + re_
        if (resident if method != "cluster" else staged) != 0:
            raise SystemExit(f"sampler-train {method}: {staged} staged and "
                             f"{resident} resident SpMMs over "
                             f"{r['subgraph_rows']} rows")
        evals = len(r["history"])
        ev_staged, ev_resident = _spmm_split(cfg, g.n, evals)
        steps = sum(per_epoch)
        expect_counts(f"sampler-train {method}", counts, {
            "spmm_ell_hbm": staged + ev_staged,
            "spmm_ell": resident + ev_resident,
            "spmm_ell_t": (cfg.n_layers - 1) * steps})
        total = counts if total is None else add_counts(total, counts)
        losses = np.concatenate(r["losses"])
        epoch_loss = [float(np.mean(ls)) for ls in r["losses"]]
        if not np.all(np.isfinite(losses)):
            raise SystemExit(f"sampler-train {method}: non-finite loss")
        if not epoch_loss[-1] < epoch_loss[0]:
            raise SystemExit(f"sampler-train {method}: mean loss of the "
                             f"last epoch {epoch_loss[-1]} not under the "
                             f"first's {epoch_loss[0]}")
        rep = dict(steps=steps, subgraph_rows=r["subgraph_rows"],
                   wall_s=wall, sample_s=r["sample_s"], pack_s=r["pack_s"],
                   train_s=r["train_s"], epoch_loss=epoch_loss,
                   step_loss=losses.tolist(), final=r["final"],
                   mem_bytes=r["mem_bytes"], messages=r["messages"])
        reps[method] = rep
        log(f"sampler-train {method}: {steps} steps over "
            f"{r['subgraph_rows']} padded rows in {wall:.3f} s -- host "
            f"sampling {sum(r['sample_s']):.3f} s, packing "
            f"{sum(r['pack_s']):.3f} s, device steps "
            f"{sum(r['train_s']):.3f} s; mean loss per epoch "
            f"{[round(v, 4) for v in epoch_loss]}; val "
            f"{r['final']['val']:.4f} test {r['final']['test']:.4f}")
    return reps, total


def phase_sampler_parity() -> dict:
    """One NS-SAGE step at n SAMPLER_PARITY_N on the card, the staged
    kernel forced by a budget under its source, and on the CPU plain path
    from the same params: loss, params and Adam moments within
    STEP_TOL, and the card's SpMMs all staged."""
    import torch
    from repro_torch import convert
    from repro_torch.configs.vq_gnn_paper import (paper_batch_size,
                                                  paper_config)
    from repro_torch.graph.batching import pack_sampler_epoch
    from repro_torch.graph.datasets import synthetic_arxiv
    from repro_torch.graph.sampling import ns_sage_batches
    from repro_torch.kernels import ops as kops
    from repro_torch.models.gnn import init_gnn, sampler_train_epoch
    from repro_torch.train.optimizer import adam
    g = synthetic_arxiv(n=SAMPLER_PARITY_N, seed=SEED)
    cfg = paper_config(g, full_scale=True)
    batch = next(ns_sage_batches(g, paper_batch_size(g),
                                 [5] * cfg.n_layers,
                                 np.random.default_rng(SEED), g.train_idx))
    params = init_gnn(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    opt = adam(1e-3)
    out, secs = {}, {}
    kops.configure_spmm_dispatch(l2_budget_mb=SAMPLER_PARITY_BUDGET_MB,
                                 reset=True)
    try:
        for dev in (DEVICE, "cpu"):
            p = convert.to_device(params, dev)
            splan = pack_sampler_epoch([batch], g.max_degree(), device=dev)
            x = torch.from_numpy(g.features).to(dev)
            y = torch.from_numpy(g.labels).to(dev)
            reset_counts()
            t0 = time.time()
            out[dev] = sampler_train_epoch(p, opt.init(p), splan, x, y, cfg,
                                           opt)
            secs[dev] = time.time() - t0
            if dev == DEVICE:
                torch.cuda.synchronize()
                expect_counts("sampler-parity", read_counts(), {
                    "spmm_ell_hbm": cfg.n_layers,
                    "spmm_ell_t": cfg.n_layers - 1})
    finally:
        kops.configure_spmm_dispatch(reset=True)
    (pg, og, lg), (pc, oc, lc) = out[DEVICE], out["cpu"]
    worst = check_close("sampler-parity loss", lg, lc, STEP_TOL)
    for tree_g, tree_c, what in ((pg, pc, "params"), (og.mu, oc.mu, "mu"),
                                 (og.nu, oc.nu, "nu")):
        for lg_, lc_ in zip(tree_g, tree_c):
            for k in lg_:
                worst = max(worst, check_close(
                    f"sampler-parity {what} {k}", lg_[k], lc_[k], STEP_TOL))
    log(f"sampler-parity: one NS-SAGE step over {splan.p} padded rows at "
        f"n {g.n}, card (staged SpMM) vs CPU plain path: loss "
        f"{float(lg[0]):.6f} vs {float(lc[0]):.6f}, max abs err "
        f"{worst:.3g} (rtol 1e-4, atol 1e-5); card {secs[DEVICE]:.3f} s, "
        f"CPU {secs['cpu']:.3f} s")
    return {"n": g.n, "rows": splan.p, "loss": float(lg[0]),
            "max_abs_err": worst}


def _staged_row(idx, val, x, sc, at: str, si=None) -> dict:
    """spmm_ell_hbm on one set of operands, bit-equal to its plain version
    and timed beside the resident kernel forced onto the same operands and
    (f32) ``torch.sparse.mm``.  ``si``: the host-built index the main path
    passes (the full graph's); without it the call takes none, as the
    sampled subgraphs' steps do (every touched stripe listed: the same
    bits as with the index built on the device).  ``ms`` is the kernel
    with an index, ``call_ms`` one call as the main path makes it,
    ``index_ms`` the device build of the index (and ``host_index_s`` the
    host build where the path has one)."""
    import torch
    from repro_torch.graph.batching import make_stripe_index
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmm_ell import spmm_ell_cuda
    from repro_torch.kernels.spmm_ell_hbm import (spmm_ell_hbm_cuda,
                                                  stripe_index_torch)
    b, deg = idx.shape
    n_src, f = x.shape
    item = x.element_size()
    dev_si = stripe_index_torch(idx, val, n_src)
    host_index_s = None
    if si is not None:
        if not torch.equal(si.counts, dev_si.counts):
            raise SystemExit(f"spmm_ell_hbm {at}: host and device indices "
                             f"disagree")
        t = time.perf_counter()
        make_stripe_index(idx.cpu().numpy(), n_src,
                          mask=val.cpu().numpy() != 0, device=x.device)
        host_index_s = time.perf_counter() - t
    path_si = si
    si = dev_si if si is None else si
    got = spmm_ell_hbm_cuda(idx, val, x, si, sc)
    want = ref.spmm_ell_hbm(idx, val, x, si, sc)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"spmm_ell_hbm {at}: not bit-equal to its plain "
                         f"version (max abs err "
                         f"{float((got - want).abs().max())})")
    if not torch.allclose(got, spmm_ell_cuda(idx, val, x, sc), **TOL):
        raise SystemExit(f"spmm_ell_hbm {at}: disagrees with spmm_ell")
    # the bound counts what the function needs, as spmm_ell's row does on
    # the same operands: idx and val, the distinct source rows, the output
    # (and the scale); not the stripe index
    n_rows = int(torch.unique(idx).numel())
    needed = 8 * b * deg + item * n_rows * f + 4 * b * f \
        + (4 * f if sc is not None else 0)
    bms, by = bound(needed, 2 * b * deg * f
                    + (b * f if sc is not None else 0))
    ms = cuda_ms(lambda: spmm_ell_hbm_cuda(idx, val, x, si, sc), 5)[0]
    call_ms = cuda_ms(lambda: spmm_ell_hbm_cuda(idx, val, x, path_si, sc),
                      5)[1]
    index_ms = cuda_ms(lambda: stripe_index_torch(idx, val, n_src), 5)[0]
    resident_ms = cuda_ms(lambda: spmm_ell_cuda(idx, val, x, sc), 5)[0]
    plain_ms = cuda_ms(lambda: ref.spmm_ell_hbm(idx, val, x, si, sc), 2,
                       inner=1)[0]
    library_ms = None
    if sc is None:
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.arange(b, device=x.device)
                         .repeat_interleave(deg), idx.reshape(-1).long()]),
            val.reshape(-1), (b, n_src), check_invariants=True).coalesce()
        check_close(f"spmm_ell_hbm library call {at}",
                    torch.sparse.mm(coo, x), want, SERVE_TOL)
        library_ms = cuda_ms(lambda: torch.sparse.mm(coo, x), 5)[0]
    row = dict(max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=library_ms,
               resident_ms=resident_ms, index_ms=index_ms,
               host_index_s=host_index_s,
               index="host-built" if path_si is not None
               else "no",
               bb=si.bb, stripe=si.stripe, tiles=int(si.counts.numel()),
               needed_bytes=needed, achieved_bytes_per_s=needed / ms * 1e3,
               at=f"b={b} D={deg} f={f} n_src={n_src} "
                  f"({item * n_src * f / 1e6:.1f} MB {x.dtype} source) "
                  f"{at}")
    log(f"spmm_ell_hbm {row['at']}: bit-equal  kernel {ms:.5f} ms (one "
        f"call {call_ms:.5f} ms, {row['index']} index passed; device "
        f"index build {index_ms:.5f} ms, host build {host_index_s} s)  "
        f"resident spmm_ell {resident_ms:.5f} ms  plain {plain_ms:.5f} ms  "
        f"sparse.mm {library_ms}  bound {bms:.6f} ms ({by}); "
        f"{needed / 1e6:.1f} MB needed at "
        f"{row['achieved_bytes_per_s'] / 1e12:.3f} TB/s; tiles of {si.bb} "
        f"rows, {si.stripe}-row stripes")
    return row


def first_subgraphs(m: Model, batch: int) -> list[tuple]:
    """(name, operands, layer-0 source) of the first subgraph that the
    NS-SAGE, GraphSAINT and Cluster-GCN steps of sampler-train draw (the
    same rng stream, the reference's scenario defaults), padded as their
    plans pad it: 262,144, 131,072 and 32,768 rows."""
    from repro_torch.graph.batching import (FullGraphOperands,
                                            pack_sampler_epoch)
    from repro_torch.graph.sampling import (cluster_gcn_batches,
                                            graphsaint_rw_batches,
                                            ns_sage_batches, partition_graph)
    g = m.g
    rng = np.random.default_rng(SEED)
    part = partition_graph(g, 32, rng)
    subs = []
    for name, it in (("NS-SAGE", ns_sage_batches(
                          g, batch, [5] * m.cfg.n_layers,
                          np.random.default_rng(SEED), g.train_idx)),
                     ("GraphSAINT", graphsaint_rw_batches(
                          g, batch, 3, np.random.default_rng(SEED),
                          g.train_idx)),
                     ("Cluster-GCN", cluster_gcn_batches(g, part, 4, rng))):
        splan = pack_sampler_epoch([next(it)], g.max_degree(), device=m.dev)
        subs.append((name, FullGraphOperands(
            splan.nbr_ids[0], splan.nbr_mask[0], splan.degrees[0]),
            m.x[splan.node_ids[0].long()].contiguous()))
    return subs


def phase_path_kernels(m: Model, hybrid: dict, subs: list
                       ) -> dict[str, list[dict]]:
    """The kernels at the further shapes that the hybrid and the samplers
    give them, against their plain versions, by kernel name (rows that go
    under the kernels line's ``also``): every step kernel on one hybrid
    batch (84,670 rows: 42,335 seeds and as many LABOR context nodes) with
    the hybrid-train phase's trained state; spmm_ell_t on the first
    NS-SAGE, GraphSAINT and Cluster-GCN subgraphs, and the resident
    spmm_ell on the Cluster-GCN one (the others' forward is staged:
    phase_staged_kernel)."""
    import torch
    from repro_torch.graph.sampling import hybrid_epoch_batches
    from repro_torch.nn.gnn_layers import _gcn_edge_vals
    ids, smask = hybrid_epoch_batches(m.g, m.batch, [5] * m.cfg.n_layers,
                                      np.random.default_rng(SEED),
                                      n_ctx=m.batch)
    out = _step_rows(m, hybrid["params"], hybrid["vq_states"],
                     m.batch_inputs(ids[0], smask[0]), "hybrid batch")
    gen = torch.Generator(device=m.dev).manual_seed(SEED)
    for name, ops_, x_sub in subs:
        idx = ops_.nbr_ids.contiguous()
        val = _gcn_edge_vals(ops_)[0].contiguous()
        at = f"(first {name} subgraph)"
        if name == "Cluster-GCN":
            out["spmm_ell"].append(_spmm_row(idx, val, x_sub, at))
        p = idx.shape[0]
        gr = torch.randn((p, m.cfg.hidden), generator=gen, device=m.dev)
        out["spmm_ell_t"].append(_spmm_t_row(idx, val, gr, p, at))
    return out


def phase_staged_kernel(m: Model, subs: list) -> dict:
    """spmm_ell_hbm against its plain version and timed at the main paths'
    staged shapes: the full-graph evaluation's first layer, and the first
    layer of the first NS-SAGE and GraphSAINT subgraphs (f32), and the
    full graph with int8 and fp8 sources.  Returns the kernels line's row
    (the other shapes and forms under ``also``)."""
    import torch
    from repro_torch.distributed.quantization import quantize_codewords
    from repro_torch.nn.gnn_layers import _gcn_edge_vals
    rows = [_staged_row(m.ops.nbr_ids.contiguous(),
                        _gcn_edge_vals(m.ops)[0].contiguous(), m.x, None,
                        "(full-graph evaluation)", m.ops.stripe_index)]
    for name, ops_, x_sub in subs:
        if name != "Cluster-GCN":        # its 16 MiB source stays resident
            rows.append(_staged_row(
                ops_.nbr_ids.contiguous(),
                _gcn_edge_vals(ops_)[0].contiguous(), x_sub, None,
                f"(first {name} subgraph)"))
    for name, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        qx = quantize_codewords(m.x[None], dtype=dt)
        rows.append(_staged_row(
            m.ops.nbr_ids.contiguous(), _gcn_edge_vals(m.ops)[0].contiguous(),
            qx.q[0].contiguous(), qx.scale[0].contiguous(),
            f"(full graph, {name} source)", m.ops.stripe_index))
        rows[-1]["form"] = f"{name} source"
    top = rows[0]
    return dict(name="spmm_ell_hbm", route="cuda",
                source="src/repro_torch/kernels/csrc/spmm_ell_hbm.cu",
                replaces="src/repro/kernels/spmm_ell_hbm.py:168",
                **top, also=rows[1:])


# ---------------------------------------------------------------------------
# the precision tiers
# ---------------------------------------------------------------------------

def tier_agreement(server, tag: str) -> float:
    """``vq_inference`` over every node with the server's tier state
    against the fp32 inference of the same codebooks, tables and weights
    (the snapshots dropped, the tables widened to int32): the share of
    nodes whose argmax agrees, gated at TIER_AGREEMENT (the reference's
    own gate)."""
    from repro_torch.core.conv import hold_table
    from repro_torch.train.gnn_trainer import vq_inference
    dense = []
    for st in server.vq:
        a = _dense_table(st.assignment).int()
        dense.append(hold_table(st._replace(assignment=a, qcw=None)))
    t0 = time.time()
    yq = vq_inference(server.params, server.vq, server.g, server.cfg,
                      TIER_INFER_BATCH)
    y32 = vq_inference(server.params, dense, server.g, server.cfg,
                       TIER_INFER_BATCH)
    if yq.shape != y32.shape or not np.all(np.isfinite(yq)):
        raise SystemExit(f"{tag}: inference rows {yq.shape} or non-finite")
    agree = float((np.argmax(yq, -1) == np.argmax(y32, -1)).mean())
    log(f"{tag}: vq_inference over {yq.shape[0]} nodes, argmax agreement "
        f"with the fp32 inference of the same state {agree:.6f} (gate "
        f"{TIER_AGREEMENT}), max abs diff {float(np.abs(yq - y32).max()):.4g}"
        f" ({time.time() - t0:.2f} s)")
    if agree < TIER_AGREEMENT:
        raise SystemExit(f"{tag}: argmax agreement {agree} with fp32 under "
                         f"{TIER_AGREEMENT}")
    return agree


def phase_tier_serve(g, cfg, params, vq, requests) -> tuple[dict, dict,
                                                             dict]:
    """Serving main paths of the tier-trained state: as trained (int8) and
    converted to fp8 by ``quantize_vq_states``.  Each: refresh, the 200
    requests with exact launch counts, CPU parity, and the inference
    agreement with fp32 serving.  Returns the reports, the summed counts
    and the servers by tier."""
    from repro_torch.launch.serve_gnn import GNNServer, vq_state_bytes
    from repro_torch.models.gnn import quantize_vq_states
    reps, total, servers = {}, None, {}
    for tier in ("int8", "fp8"):
        tag = f"tier-serve {tier}"
        st = vq if tier == TIER_PRECISION \
            else quantize_vq_states(vq, cfg, precision=tier)
        check_tier_storage(tag, st, tier)
        server = GNNServer(g, cfg, params, st, BATCH, device=DEVICE)
        rep, counts = phase_main_path(server, requests, tag)
        phase_cpu_parity(server, requests, f"{tag} cpu parity")
        rep["agreement"] = tier_agreement(server, tag)
        rep["vq_state_bytes"] = vq_state_bytes(server.vq)
        reps[tier], servers[tier] = rep, server
        total = counts if total is None else add_counts(total, counts)
    return reps, total, servers


def phase_a4_serve(g, cfg, requests) -> tuple[dict, dict, dict]:
    """Serving at k = A4_K from the seed's initial state (no training, the
    reference's default) under int8, int8+a4 and fp8+a4, each built as
    ``serve_gnn`` builds it (the tier configured, ``init_gnn`` /
    ``init_vq_states``, ``quantize_vq_states``): refresh, the requests
    with exact counts, CPU parity.  The packed tables after refresh must
    be ``pack_nibbles`` of the int8 tier's uint8 tables, and the int8+a4
    rows bit-equal to the int8 rows (packing changes storage only)."""
    import torch
    from repro_torch.distributed.quantization import pack_nibbles
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve_gnn import GNNServer, vq_state_bytes
    from repro_torch.models.gnn import (init_gnn, init_vq_states,
                                        quantize_vq_states)
    reps, total, servers = {}, None, {}
    for tier in ("int8", "int8+a4", "fp8+a4"):
        tag = f"a4-serve {tier}"
        kops.configure_kernel_precision(tier)
        try:
            gen = torch.Generator().manual_seed(SEED)
            params = init_gnn(cfg, gen, device=DEVICE)
            vq = quantize_vq_states(init_vq_states(cfg, g.n, gen,
                                                   device=DEVICE),
                                    cfg, precision=tier)
        finally:
            kops.configure_kernel_precision(reset=True)
        check_tier_storage(tag, vq, tier)
        server = GNNServer(g, cfg, params, vq, BATCH, device=DEVICE)
        rep, counts = phase_main_path(server, requests, tag)
        phase_cpu_parity(server, requests, f"{tag} cpu parity")
        rep["vq_state_bytes"] = vq_state_bytes(server.vq)
        reps[tier], servers[tier] = rep, server
        total = counts if total is None else add_counts(total, counts)
    for l, (a, b) in enumerate(zip(servers["int8+a4"].vq,
                                   servers["int8"].vq)):
        if not torch.equal(a.assignment.packed, pack_nibbles(b.assignment)):
            raise SystemExit(f"a4-serve: layer {l}'s packed table is not "
                             f"the int8 tier's table packed")
    ids = np.concatenate(requests[:12])
    got, want = servers["int8+a4"].serve(ids), servers["int8"].serve(ids)
    if not np.array_equal(got, want):
        raise SystemExit(f"a4-serve: int8+a4 rows differ from int8 rows "
                         f"(max abs err {np.abs(got - want).max()})")
    log(f"a4-serve: packed tables == pack_nibbles(int8 tables) in every "
        f"layer; {len(ids)} int8+a4 rows bit-equal to the int8 rows; vq "
        f"operand bytes {reps['int8']['vq_state_bytes']} (int8) -> "
        f"{reps['int8+a4']['vq_state_bytes']} (int8+a4)")
    return reps, total, servers


def _table_bytes(a) -> float:
    """Bytes an assignment entry takes in a table's storage."""
    from repro_torch.distributed.quantization import PackedAssignment
    return 0.5 if isinstance(a, PackedAssignment) else a.element_size()


def _ctx_q_row(ids, vals, a, qt, w_t, at: str) -> dict:
    """A quantized form of context_ell against its plain version on one
    set of operands (bit-equal), timed: ids/vals [b, D], table a (int32,
    uint8 or packed), codewords qt (QTensor), optional w_t; timed on the
    table as the main path holds it (``ms``) and in the other layout
    (``ms_other_layout``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.context_ell import context_ell_cuda
    layout, other = _layouts(a, at, True)
    want = ref.context_ell(ids, vals, a, qt.q, w_t, qt.scale)
    _bit_equal(f"context_ell {at}", context_ell_cuda(
        ids, vals, a, qt.q, w_t, qt.scale), want)
    _bit_equal(f"context_ell {at} (other layout)",
               context_ell_cuda(ids, vals, other, qt.q, w_t, qt.scale), want)
    b, deg = ids.shape
    nb, k, fb = qt.q.shape
    dense = _dense_table(a)
    uid = torch.unique(ids.long())
    pairs = torch.unique(dense[:, uid].long()
                         + k * torch.arange(nb, device=ids.device)[:, None])
    f_out = nb * fb if w_t is None else w_t.shape[1]
    byt = 8 * b * deg + _table_bytes(a) * nb * uid.numel() \
        + fb * pairs.numel() + 4 * nb * fb + 4 * b * f_out
    ops_ = 2 * b * deg * nb * fb + b * nb * fb
    if w_t is not None:
        byt += 4 * nb * fb * f_out
        ops_ += 2 * b * nb * fb * f_out
    bms, by = bound(byt, ops_)
    big = b > 10000
    ms, call_ms = cuda_ms(lambda: context_ell_cuda(ids, vals, a, qt.q, w_t,
                                                   qt.scale),
                          3 if big else 5, inner=4 if big else 20)
    other_ms = cuda_ms(lambda: context_ell_cuda(ids, vals, other, qt.q, w_t,
                                                qt.scale),
                       3 if big else 5, inner=4 if big else 20)[0]
    plain_ms = cuda_ms(lambda: ref.context_ell(ids, vals, a, qt.q, w_t,
                                               qt.scale),
                       2, inner=1 if big else 5)[0]
    row = dict(max_abs_err=0.0, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=None,
               layout=layout, ms_other_layout=other_ms,
               at=f"b={b} D={deg} n={dense.shape[1]} nb={nb} k={k} fb={fb}"
                  + ("" if w_t is None else f" f_out={f_out}") + f" {at}")
    log(f"context_ell {row['at']}: bit-equal  kernel {ms:.5f} ms (one call "
        f"{call_ms:.5f} ms; table {layout}, the other layout {other_ms:.5f} "
        f"ms)  plain {plain_ms:.5f} ms  bound {bms:.6f} ms ({by})  library "
        f"none")
    return row


def phase_tier_kernels(m: Model, params, vq, servers: dict) -> dict:
    """Every quantized form against its plain version, bit for bit, at the
    shapes the tier paths give it: context_ell and its w_t form with int8
    and fp8 codewords over uint8 (k 256), nibble-packed (k 16) and int32
    tables at the serving batch (256) and the training batch (42,335);
    spmm_ell's int8 / fp8 source at the training batch from the
    169,343-row feature table; vq_update's uint8 emit on the tier-trained
    model's whitened rows.  Returns the rows by kernel name (they go
    under that kernel's ``also``), each with its ``form``."""
    import torch
    from repro_torch.core import codebook as cbm
    from repro_torch.core.conv import fixed_conv_operands
    from repro_torch.distributed.quantization import quantize_codewords
    from repro_torch.graph.batching import plan_batch
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmm_ell import spmm_ell_cuda
    from repro_torch.kernels.vq_update import vq_assign_update_cuda
    from repro_torch.models.gnn import vq_loss_and_grads
    dev = m.dev
    rng = np.random.default_rng(SEED + 17)
    shapes = {"serve": rng.choice(m.g.n, BATCH, replace=False),
              "train": rng.permutation(m.g.n)[:m.batch]}
    rows = {"context_ell": [], "spmm_ell": [], "vq_update": []}
    # codewords of the plain form: layer 0's feature snapshot; of the w_t
    # form: layer 1's gradient snapshot with W^T of layer 1
    w_t = params[1]["w"].t().contiguous()
    for shape, bids_np in shapes.items():
        bids = torch.from_numpy(bids_np.astype(np.int32)).to(dev)
        ops_, _ = fixed_conv_operands("gcn", plan_batch(m.plan, bids),
                                      m.ops.degrees)
        fwd = (ops_.out_ids.contiguous(), ops_.out_vals.contiguous())
        rev = (ops_.rev_ids.contiguous(), ops_.rev_vals.contiguous())
        for cw_name, src in (("i8", "int8"), ("f8", "fp8")):
            for tab in ("u8", "a4", "i32"):
                srv = servers[src if tab != "a4" else f"{src}+a4"]
                st0, st1 = srv.vq[0], srv.vq[1]
                a0, a1 = st0.assignment, st1.assignment
                if tab == "i32":       # widened, still node-major
                    a0, a1 = a0.int(), a1.int()
                for form, (ids, vals), a, qt, wt in (
                        ("q", fwd, a0, st0.qcw.feat, None),
                        ("q_wt", rev, a1, st1.qcw.grad, w_t)):
                    at = f"({shape} batch, {cw_name} codewords, {tab} table)"
                    row = _ctx_q_row(ids, vals, a, qt, wt, at)
                    row["form"] = f"{form} {cw_name} {tab}"
                    row["entry"] = ("repro_context_ell_" + (
                        "wt_" if wt is not None else "") + f"{cw_name}_{tab}")
                    rows["context_ell"].append(row)

    # spmm_ell's quantized source: the training batch's in-edges into the
    # 169,343-row feature table, quantized per channel
    bids = torch.from_numpy(shapes["train"].astype(np.int32)).to(dev)
    pack = plan_batch(m.plan, bids)
    ops_, _ = fixed_conv_operands("gcn", pack, m.ops.degrees)
    idx = ops_.out_ids.contiguous()
    val = (ops_.in_vals + ops_.out_vals).contiguous()
    for cw_name, dt in (("i8", torch.int8), ("f8", torch.float8_e4m3fn)):
        qx = quantize_codewords(m.x[None], dtype=dt)
        q, sc = qx.q[0].contiguous(), qx.scale[0].contiguous()
        got = spmm_ell_cuda(idx, val, q, sc)
        want = ref.spmm_ell(idx, val, q, sc)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"spmm_ell {cw_name} source: not bit-equal")
        b, deg = idx.shape
        f = q.shape[1]
        n_rows = int(torch.unique(idx).numel())
        bms, by = bound(8 * b * deg + n_rows * f + 4 * f + 4 * b * f,
                        2 * b * deg * f + b * f)
        ms, call_ms = cuda_ms(lambda: spmm_ell_cuda(idx, val, q, sc), 5)
        every = torch.where(val == 0, torch.full_like(val, 1e-45), val)
        ms_padding_loaded = cuda_ms(lambda: spmm_ell_cuda(idx, every, q, sc),
                                    5)[0]
        # the same slots gathered from the f32 table: 4x the bytes
        ms_f32_source = cuda_ms(lambda: spmm_ell_cuda(idx, val, m.x), 5)[0]
        plain_ms = cuda_ms(lambda: ref.spmm_ell(idx, val, q, sc), 2,
                           inner=1)[0]
        row = dict(form=f"q {cw_name}", max_abs_err=0.0, ms=ms,
                   call_ms=call_ms, ms_padding_loaded=ms_padding_loaded,
                   ms_f32_source=ms_f32_source,
                   padding_share=float((val == 0).float().mean()),
                   plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=None,
                   at=f"b={b} D={deg} f={f} n_src={q.shape[0]} "
                      f"({q.shape[0] * f / 1e6:.1f} MB {cw_name} source, "
                      f"training batch)")
        rows["spmm_ell"].append(row)
        log(f"spmm_ell {row['at']}: bit-equal  kernel {ms:.5f} ms (one call "
            f"{call_ms:.5f} ms; every slot gathered {ms_padding_loaded:.5f} "
            f"ms; from the f32 table {ms_f32_source:.5f} ms)  plain "
            f"{plain_ms:.5f} ms  bound {bms:.6f} ms ({by})  library none")

    # vq_update's uint8 emit on the tier-trained model's rows
    pack, x_b, y_b, lm = m.batch_inputs(shapes["train"])
    _, _, acts, _, gprobes = vq_loss_and_grads(params, vq, pack, x_b, y_b,
                                               m.ops.degrees, m.cfg, lm)
    cb = m.cfg.layer_codebook_cfg()
    for layer in (0, m.cfg.n_layers - 1):
        st = vq[layer].codebook
        vw = cbm.whitened_rows(st, acts[layer], gprobes[layer], cb)[0]
        cw = st.codewords_w.contiguous()
        got = vq_assign_update_cuda(vw, cw, torch.uint8)
        wide = vq_assign_update_cuda(vw, cw)
        want = ref.vq_assign_update(vw, cw, torch.uint8)
        torch.cuda.synchronize()
        if got[0].dtype != torch.uint8 or not (
                torch.equal(got[0], want[0])
                and torch.equal(got[0].int(), wide[0])
                and torch.equal(got[1], want[1])
                and torch.equal(got[2], want[2])):
            raise SystemExit(f"vq_update uint8 emit layer {layer}: ids, "
                             f"qerr or counts differ")
        nb, b, f = vw.shape
        k = cw.shape[1]
        bms, by = bound(4 * nb * b * f + 4 * nb * k * f + 5 * nb * b
                        + 4 * nb * k * (f + 1), 2 * nb * b * k * f)
        ms, call_ms = cuda_ms(lambda: vq_assign_update_cuda(
            vw, cw, torch.uint8), 5, inner=4)
        int32_ms = cuda_ms(lambda: vq_assign_update_cuda(vw, cw), 5,
                           inner=4)[0]
        plain_ms = cuda_ms(lambda: ref.vq_assign_update(vw, cw, torch.uint8),
                           2, inner=1)[0]
        row = dict(form="uint8 emit", max_abs_err=0.0, ms=ms,
                   call_ms=call_ms, int32_emit_ms=int32_ms,
                   plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=None,
                   at=f"x=[{nb}, {b}, {f}] cw=[{nb}, {k}, {f}] layer {layer} "
                      f"tier-trained")
        rows["vq_update"].append(row)
        log(f"vq_update uint8 emit {row['at']}: ids equal to the int32 "
            f"emit and the plain version  kernel {ms:.4f} ms (one call "
            f"{call_ms:.4f} ms, int32 emit {int32_ms:.4f} ms)  plain "
            f"{plain_ms:.4f} ms  bound {bms:.4f} ms ({by})  library none")
    return rows


# ---------------------------------------------------------------------------
# the LM decode path
# ---------------------------------------------------------------------------

def _bf16_close(name: str, got, want, ulps: int = 2) -> float:
    """bf16 results within ``ulps`` bf16 units in the last place of the
    plain version's (an ulp taken at no less than 2^-10, below which the
    f32 sums' own rounding dominates)."""
    g = got.detach().float().cpu().numpy()
    w = want.detach().float().cpu().numpy()
    if g.shape != w.shape or not np.all(np.isfinite(g)):
        raise SystemExit(f"{name}: bad output shape {g.shape} vs {w.shape} "
                         f"or non-finite values")
    mag = np.maximum(np.abs(w), 2.0 ** -10)
    tol = ulps * 2.0 ** (np.floor(np.log2(mag)) - 7)
    err = float(np.abs(g - w).max())
    if (np.abs(g - w) > tol).any():
        raise SystemExit(f"{name}: kernel beyond {ulps} bf16 ulps of its "
                         f"plain version (max abs err {err})")
    return err


def _lm_cfg(vq: bool, arch: str = LM_ARCH, **replace):
    """The serve launcher's configuration of ``arch`` at full width
    (VQ-Attention at k 128, W 64 under ``vq``), fields replaced."""
    import dataclasses
    from repro_torch.launch import serve as lm_serve
    argv = ["--arch", arch, "--batch", str(LM_BATCH), "--context",
            str(LM_CONTEXT)] + (["--vq"] if vq else [])
    cfg = lm_serve.config(lm_serve.parser().parse_args(argv))
    return dataclasses.replace(cfg, **replace)


def phase_lm_serve() -> tuple[dict, dict, object, object]:
    """Full-width llama3.2-3b decode through the launcher's functions: VQ
    for LM_VQ_TOKENS steps, then exact for LM_EXACT_TOKENS; launch counts
    exact.  Returns the report, the VQ path's counts, its cache and its
    config."""
    import torch
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import lm
    cfg_vq, cfg_x = _lm_cfg(True), _lm_cfg(False)
    t0 = time.time()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = lm.init_lm(cfg_x, gen, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    blocks = params["blocks"]
    leaves = [params["embed"], params["ln_f"], params["head"], blocks["ln1"],
              blocks["ln2"], *blocks["attn"], *blocks["mlp"]]
    n_params = sum(t.numel() for t in leaves)
    p_bytes = sum(t.numel() * t.element_size() for t in leaves)
    # bytes one step must read: every weight but the embedding table
    step_bytes = p_bytes - params["embed"].numel() * 2
    log(f"lm init: {cfg_x.name} {n_params} parameters ({p_bytes} bytes, "
        f"param_count {cfg_x.param_count()} + the qk norms) in {init_s:.2f} s")

    reset_counts()
    logits, cache, vq_rep = lm_serve.decode(
        params, cfg_vq, batch=LM_BATCH, context=LM_CONTEXT,
        tokens=LM_VQ_TOKENS, device=DEVICE)
    torch.cuda.synchronize()
    vq_counts = read_counts()
    steps = LM_VQ_TOKENS + 1                       # the warm-up step too
    expect_counts("lm-serve vq", vq_counts,
                  {"vq_attention": cfg_vq.n_layers * steps})
    if tuple(logits.shape) != (LM_BATCH, cfg_vq.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"lm-serve vq: logits {tuple(logits.shape)} not "
                         f"finite or of the wrong shape")
    kv = cache["kv"]
    evictions = steps - cfg_vq.vq_window
    mass = kv.count.sum(-1)
    if not bool((mass == evictions).all()) or int(kv.pos[0]) != steps:
        raise SystemExit(f"lm-serve vq: codebook mass {mass.unique()} "
                         f"(want {evictions} per head), pos {kv.pos[0]}")
    live = (kv.count > 0).sum(-1)
    vq_rep.update(
        live_codewords_min=int(live.min()), live_codewords_max=int(live.max()),
        largest_cluster=float(kv.count.max()),
        cache_bytes_per_layer=vq_rep["cache_bytes"] // cfg_vq.n_layers)
    log(f"lm-serve vq: {steps} steps, {evictions} evictions per head, live "
        f"codewords {vq_rep['live_codewords_min']}-"
        f"{vq_rep['live_codewords_max']} of {cfg_vq.vq_k}, "
        f"{vq_rep['tok_per_s']:.1f} tok/s, step p50 "
        f"{vq_rep['step_p50_ms']:.3f} ms p99 {vq_rep['step_p99_ms']:.3f} ms, "
        f"cache {vq_rep['cache_bytes']} bytes")

    # a profile of 4 VQ steps past the window (every layer evicting)
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=DEVICE)
    cache_p = lm.init_serve_cache(cfg_vq, LM_BATCH, LM_CONTEXT,
                                  device=DEVICE)
    for _ in range(cfg_vq.vq_window + 2):
        lm.serve_step(params, tok, cache_p, cfg_vq)
    _profile("lm-serve vq decode step", list(range(4)),
             lambda _: lm.serve_step(params, tok, cache_p, cfg_vq))
    del cache_p

    reset_counts()
    logits, _, x_rep = lm_serve.decode(
        params, cfg_x, batch=LM_BATCH, context=LM_CONTEXT,
        tokens=LM_EXACT_TOKENS, device=DEVICE)
    torch.cuda.synchronize()
    expect_counts("lm-serve exact", read_counts(), {})
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("lm-serve exact: non-finite logits")
    x_rep["cache_bytes_per_layer"] = x_rep["cache_bytes"] // cfg_x.n_layers
    log(f"lm-serve exact: {LM_EXACT_TOKENS + 1} steps, "
        f"{x_rep['tok_per_s']:.1f} tok/s, step p50 "
        f"{x_rep['step_p50_ms']:.3f} ms p99 {x_rep['step_p99_ms']:.3f} ms, "
        f"cache {x_rep['cache_bytes']} bytes")
    bms = step_bytes / HBM_BYTES_PER_S * 1e3
    rep = {"arch": cfg_x.name, "batch": LM_BATCH, "params": n_params,
           "param_bytes": p_bytes, "init_s": init_s,
           "step_weight_bytes": step_bytes, "step_bound_ms": bms,
           "vq": vq_rep, "exact": x_rep}
    del params
    torch.cuda.empty_cache()
    return rep, vq_counts, kv, cfg_vq


def phase_lm_parity() -> dict:
    """2 layers at full width in f32: LM_PARITY_STEPS teacher-forced VQ
    steps on the card and on the CPU from the same weights."""
    import dataclasses

    import torch
    from repro_torch import convert
    from repro_torch.models import lm
    cfg = dataclasses.replace(_lm_cfg(True), n_layers=LM_PARITY_LAYERS,
                              dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    params = lm.init_lm(cfg, gen, device=DEVICE)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("lm-parity: TF32 is on")
    cpu_params = convert.to_device(params, "cpu")
    caches = [lm.init_serve_cache(cfg, LM_BATCH, LM_CONTEXT, device=d)
              for d in (DEVICE, "cpu")]
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_PARITY_STEPS, LM_BATCH, 1)))
    worst, t_card, t_cpu = 0.0, 0.0, 0.0
    for s in range(LM_PARITY_STEPS):
        t0 = time.time()
        got, caches[0] = lm.serve_step(params, tokens[s].to(DEVICE),
                                       caches[0], cfg)
        got = got.cpu()
        t_card += time.time() - t0
        t0 = time.time()
        want, caches[1] = lm.serve_step(cpu_params, tokens[s], caches[1], cfg)
        t_cpu += time.time() - t0
        worst = max(worst, check_close(f"lm-parity step {s}", got, want,
                                       LM_TOL))
        if not torch.equal(caches[0]["kv"].count.cpu(), caches[1]["kv"].count):
            raise SystemExit(f"lm-parity step {s}: codebook counts differ")
    count = caches[1]["kv"].count
    rep = {"layers": cfg.n_layers, "steps": LM_PARITY_STEPS,
           "evictions": LM_PARITY_STEPS - cfg.vq_window,
           "max_abs_err": worst, "card_s": t_card, "cpu_s": t_cpu,
           "live_codewords_max": int((count > 0).sum(-1).max())}
    log(f"lm-parity: {LM_PARITY_STEPS} teacher-forced VQ steps of "
        f"{cfg.name} at {cfg.n_layers} layers f32, logits agree (max abs err "
        f"{worst:.3g}, rtol 1e-4 atol 1e-4), counts equal at every step; "
        f"card {t_card:.2f} s, CPU {t_cpu:.2f} s")
    return rep


def _vq_attn_row(args, at: str) -> dict:
    """vq_attention against its plain version (and SDPA with the log-mass
    bias as its float mask over the concatenated keys) on one set of
    operands."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.vq_attention import (MAX_SPLITS, split_count,
                                                  vq_attention_decode_cuda)
    q, cbk, cbv, mass, wk, wv, wm = args
    got = vq_attention_decode_cuda(*args)
    want = ref.vq_attention_decode(*args)
    if q.dtype == torch.bfloat16:
        err = _bf16_close(f"vq_attention {at}", got, want)
    else:
        err = check_close(f"vq_attention {at}", got, want, TOL)
    n, g, d = q.shape
    kcb, w = cbk.shape[1], wk.shape[1]
    es = q.element_size()
    byt = es * (2 * n * g * d + 2 * n * kcb * d + 2 * n * w * d) \
        + 4 * n * (kcb + w)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    bms, by = bound(byt, 4.0 * n * g * (kcb + w) * d, peak)
    big = byt > 1e8
    ms, call_ms = cuda_ms(lambda: vq_attention_decode_cuda(*args),
                          5 if big else 10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = split_count(n, kcb, w, sms)
    # the kernel at other split counts: blocks a group against the work
    # and the merge each block adds
    by_splits = {} if n >= sms else {
        s: cuda_ms(lambda: vq_attention_decode_cuda(*args, splits=s), 10)[0]
        for s in sorted({1, 2, splits, 2 * splits, 12}) if s <= MAX_SPLITS}
    plain_ms = cuda_ms(lambda: ref.vq_attention_decode(*args), 3,
                       inner=2 if big else 20)[0]
    keys = torch.cat([cbk, wk], 1)
    vals = torch.cat([cbv, wv], 1)
    bias = torch.cat([
        torch.log(torch.clamp_min(mass, 1e-9)).masked_fill(mass <= 0,
                                                           -float("inf")),
        torch.zeros_like(wm).masked_fill(wm <= 0, -float("inf"))],
        1)[:, None, :].to(q.dtype)

    def lib():
        return F.scaled_dot_product_attention(q, keys, vals, attn_mask=bias)
    lib_err = float((lib().float() - want.float()).abs().max())
    lib_ms = cuda_ms(lib, 5 if big else 10)[0]
    row = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=lib_ms,
               library_max_abs_err=lib_err, splits=splits,
               ms_by_splits=by_splits,
               at=f"n={n} g={g} d={d} k={kcb} w={w} {q.dtype} {at}")
    log(f"vq_attention {row['at']}: max_abs_err {err:.3g}  kernel {ms:.5f} ms "
        f"(one call {call_ms:.5f} ms; {splits} blocks a group; by split "
        f"count {by_splits})  plain {plain_ms:.5f} ms  sdpa "
        f"{lib_ms:.5f} ms (max abs err {lib_err:.3g})  bound {bms:.6f} ms "
        f"({by})")
    return row


def _flash_row(shape, causal: bool, dtype) -> dict:
    """flash_attention at one shape and dtype, on the route its wrapper
    picks (bf16: the tensor-core kernel; f32: the FMA kernel), against its
    plain version, the one-call time and SDPA on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ref
    b, h, s, d = shape
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + s)
    q, k, v = (torch.randn(shape, generator=gen, device=DEVICE, dtype=dtype)
               for _ in "qkv")
    kroute = tfa.route(q, k, v)
    got = tfa.flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    name = f"flash_attention {shape} {dtype}"
    err = _bf16_close(name, got, want) if dtype == torch.bfloat16 \
        else check_close(name, got, want, TOL)
    del want
    pairs = s * (s + 1) // 2 if causal else s * s
    item = torch.finfo(dtype).bits // 8
    bms, by = bound(4 * item * b * h * s * d, 4.0 * b * h * pairs * d,
                    BF16_FLOP_PER_S if dtype == torch.bfloat16
                    else FP32_FLOP_PER_S)
    ms, call_ms = cuda_ms(lambda: tfa.flash_attention_cuda(
        q, k, v, causal=causal), 3, inner=2 if kroute == "fma" else 10)
    plain_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, causal=causal),
                       3, inner=1)[0]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), 5, inner=10)[0]
    row = dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=lib_ms,
               form=f"{kroute} route",
               at=f"[{b}, {h}, {s}, {d}] {str(dtype)[6:]} "
                  f"{'causal' if causal else 'non-causal'}")
    log(f"flash_attention {row['at']} ({kroute} route): max_abs_err "
        f"{err:.3g}  kernel {ms:.4f} ms (one call {call_ms:.4f} ms)  plain "
        f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bms:.5f} ms "
        f"({by})")
    return row


def _vq_path_args(kv, cfg, gen) -> list:
    """vq_attention's operands as layer 0 of a served VQ cache gives them
    to the kernel (f32; random queries from ``gen``): q [n, g, d], the
    centroids and masses, the window and a full window mask."""
    import torch
    from repro_torch.nn.vq_attention import _centroids
    b, hkv, kcb, d = kv.sum_k.shape[1:]
    w = kv.win_k.shape[2]
    g = cfg.n_heads // cfg.n_kv_heads
    n = b * hkv
    cent_k, cent_v = _centroids(kv.sum_k[0], kv.sum_v[0], kv.count[0])
    return [torch.randn((n, g, d), generator=gen, device=DEVICE),
            cent_k.reshape(n, kcb, d), cent_v.reshape(n, kcb, d),
            kv.count[0].reshape(n, kcb),
            kv.win_k[0].transpose(1, 2).reshape(n, w, d).float(),
            kv.win_v[0].transpose(1, 2).reshape(n, w, d).float(),
            torch.ones((n, w), device=DEVICE)]


def phase_lm_kernels(kv, cfg) -> list[dict]:
    """The two LM kernels against their plain versions, timed: vq_attention
    on layer 0 of the served VQ cache (the path's shape) in bf16 and f32
    and at the config defaults; flash_attention at llama3.2-3b's shapes."""
    import torch
    from repro_torch.configs.registry import get_arch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    path = _vq_path_args(kv, cfg, gen)
    g, d = path[0].shape[1:]
    bf = [t.to(torch.bfloat16) if i in (0, 1, 2, 4, 5) else t
          for i, t in enumerate(path)]
    rows = [_vq_attn_row(bf, "(decode path, layer 0 of the served cache)"),
            _vq_attn_row(path, "(decode path, f32)")]
    defaults = get_arch(LM_ARCH)                 # vq_k 1024, vq_window 512
    n2, k2, w2 = 1024, defaults.vq_k, defaults.vq_window
    big = [torch.randn(s, generator=gen, device=DEVICE).to(torch.bfloat16)
           for s in ((n2, g, d), (n2, k2, d), (n2, k2, d))]
    mass = torch.rand((n2, k2), generator=gen, device=DEVICE) * 64
    mass[:, ::7] = 0.0
    big += [mass] + [torch.randn((n2, w2, d), generator=gen, device=DEVICE)
                     .to(torch.bfloat16) for _ in "kv"]
    big.append(torch.ones((n2, w2), device=DEVICE))
    rows.append(_vq_attn_row(big, "(config defaults k 1024, w 512 at "
                                  "decode_32k's batch 128)"))
    vq_row = dict(name="vq_attention", route="cuda",
                  source="src/repro_torch/kernels/csrc/vq_attention.cu",
                  replaces="src/repro/kernels/vq_attention.py:61",
                  **{k: v for k, v in rows[0].items() if k != "max_abs_err"},
                  max_abs_err=max(r["max_abs_err"] for r in rows),
                  also=rows[1:])
    fl = [_flash_row((1, cfg.n_heads, s, d), causal, dt)
          for dt in (torch.bfloat16, torch.float32)
          for s, causal in ((4096, True), (1024, False))]
    fl_row = dict(name="flash_attention", route="cuda",
                  source="src/repro_torch/kernels/csrc/flash_attention.cu",
                  replaces="src/repro/kernels/flash_attention.py:70",
                  **{k: v for k, v in fl[0].items() if k != "max_abs_err"},
                  max_abs_err=max(r["max_abs_err"] for r in fl),
                  main_path="none: no model path of the reference calls it",
                  also=fl[1:])
    return [vq_row, fl_row]


# ---------------------------------------------------------------------------
# the learnable and dense backbones: GAT and the Graph Transformer, their
# codebooks on the wide build of the vq_update / vq_assign scan
# ---------------------------------------------------------------------------

def phase_attention_train(g, cfg, batch: int, tag: str,
                          learn: bool = False) -> tuple[dict, dict]:
    """``train_vq`` of a GAT or Graph Transformer for ATTN_EPOCHS epochs at
    ``batch`` with one full-graph evaluation at the end, the launch counts
    checked exactly: every codebook update on the wide build of vq_update
    (the branches are 43-256 wide), no other counted kernel (the layers
    read dense codewords and gather, score and attend in plain PyTorch).

    Gates: finite losses and VQ errors; with ``learn`` also the last
    epoch's mean loss under the first's and a val accuracy above chance.
    The ``learn`` runs are the settings in which the reference learns at
    this width (tests/test_torch_backbones.py::
    test_full_width_reference_curves, n 2,000, 10 epochs): GAT with Eq. 7
    off (mean epoch loss 3.56 -> 0.70, val 0.81) and the Transformer at
    depth 1 (2.44 -> 0.0018, val 1.0).  The 3-layer runs with Eq. 7 on,
    and the Transformer's with it off, gate on finite values only: the
    reference's curves there (GAT 5.55 -> 104.02, the Transformer 5.09 ->
    42759.67 with Eq. 7 on, 3.82 -> 4.86 with it off) are recorded, not
    a gate."""
    import torch
    from repro_torch.train.gnn_trainer import train_vq
    epochs, n_layers = ATTN_EPOCHS, cfg.n_layers
    steps = epochs * -(-g.n // batch)
    reset_counts()
    t0 = time.time()
    r = train_vq(g, cfg, epochs=epochs, batch_size=batch, seed=SEED,
                 eval_every=epochs, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    expect_counts(tag, counts, {"vq_update": n_layers * steps,
                                "vq_update_wide": n_layers * steps})
    losses, errs = r["step_losses"], r["step_vq_errs"]
    if losses.shape != (steps,) or errs.shape != (steps, n_layers):
        raise SystemExit(f"{tag}: {losses.shape} losses, {errs.shape} VQ "
                         f"errors for {steps} steps")
    for i, (loss, e) in enumerate(zip(losses, errs)):
        log(f"{tag} step {i}: loss {loss:.6f} vq_err "
            f"{' '.join(f'{v:.4f}' for v in e)}")
    epoch_loss = losses.reshape(epochs, -1).mean(1)
    h = r["history"][-1]
    r.update(wall_s=wall, epoch_loss=epoch_loss.tolist(),
             epoch_vq_err=errs.reshape(epochs, -1).mean(1).tolist(),
             largest_cluster_share=largest_cluster_share(r["vq_states"]))
    log(f"{tag}: {steps} steps of {batch} nodes in {wall:.3f} s (epochs "
        f"{[round(v, 3) for v in r['epoch_s']]} s, the last with the "
        f"full-graph evaluation); mean loss per epoch "
        f"{[round(v, 4) for v in r['epoch_loss']]}; val {h['val']:.4f} "
        f"test {h['test']:.4f} vq_err {h['vq_err']:.4f}; largest cluster "
        f"share per layer {[round(v, 4) for v in r['largest_cluster_share']]}")
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(errs))):
        raise SystemExit(f"{tag}: non-finite loss or VQ error")
    if learn and not (epoch_loss[-1] < epoch_loss[0] and h["val"] > CHANCE):
        raise SystemExit(f"{tag}: last epoch's mean loss {epoch_loss[-1]} "
                         f"not under the first's {epoch_loss[0]}, or val "
                         f"{h['val']} not above chance {CHANCE}")
    return r, counts


def phase_attention_serve(server, requests, tag: str) -> tuple[dict, dict]:
    """Serving a GAT or Graph Transformer: the refresh launches vq_assign
    once a layer (the wide build where the feature half is wider than 32:
    the Transformer's 128), warm-up and the requests launch no counted
    kernel; counts checked exactly."""
    from repro_torch.kernels.vq_assign import uses_wide
    from repro_torch.launch.serve_gnn import drain_requests
    from repro_torch.models.gnn import _layer_out_dims
    n_layers = server.cfg.n_layers
    wide = sum(uses_wide(st.codebook.k, fi // st.codebook.n_branches)
               for st, (fi, _) in zip(server.vq,
                                      _layer_out_dims(server.cfg)))
    reset_counts()
    t_refresh = server.refresh()
    refresh_counts = read_counts()
    expect_counts(f"{tag} refresh", refresh_counts,
                  {"vq_assign": n_layers, "vq_assign_wide": wide})
    reset_counts()
    t_warm = server.warmup()
    rep = drain_requests(server, requests)
    serve_counts = read_counts()
    expect_counts(tag, serve_counts, {})
    rep.update(refresh_s=t_refresh, warmup_s=t_warm)
    log(f"{tag}: refresh {t_refresh:.3f} s; {rep['nodes']} nodes / "
        f"{rep['requests']} requests in {rep['steps']} steps, "
        f"{rep['wall_s']:.4f} s -> {rep['nodes_per_s']:.1f} nodes/s; step "
        f"p50 {rep['step_p50_ms']:.4f} ms p99 {rep['step_p99_ms']:.4f} ms; "
        f"request p50 {rep['request_p50_ms']:.4f} ms p99 "
        f"{rep['request_p99_ms']:.4f} ms")
    return rep, add_counts(refresh_counts, serve_counts)


def _queued(vw, cw, launch) -> dict:
    """The share of rows the wide build queues for its second pass: counted
    by the kernel (its scratch counter, read after one more launch and a
    synchronize) beside the estimate of its rule on the plain distances."""
    import torch
    from repro_torch.kernels import vq_update as tvu
    launch()
    torch.cuda.synchronize()
    rows = vw.shape[0] * vw.shape[1]
    return dict(queued_share=tvu.wide_queued_rows() / rows,
                queued_share_est=tvu.queued_rows_est(vw, cw) / rows,
                scratch_bytes=4 * tvu.last_wide_scratch.numel())


class _ParentWide:
    """The parent tree's wide kernel (``--wide-parent DIR``: its sources
    built into DIR/build by its own ``_build``), called as its wrappers
    called it, for timing it beside this tree's in the same call."""

    def __init__(self, root: str):
        import importlib.util
        path = os.path.join(root, "src", "repro_torch", "kernels",
                            "_build.py")
        spec = importlib.util.spec_from_file_location("parent_build", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.time()
        self.lib = mod.library()
        log(f"parent's kernels built from {root} in {time.time() - t0:.2f} s")

    def update(self, x, cw, emit=None):
        import torch
        nb, n, f = x.shape
        k = cw.shape[1]
        u8 = emit == torch.uint8
        idx = torch.empty((nb, n), dtype=torch.uint8 if u8 else torch.int32,
                          device=x.device)
        qerr = torch.empty((nb, n), device=x.device)
        counts = torch.zeros((nb, k), device=x.device)
        sums = torch.zeros((nb, k, f), device=x.device)
        cn2 = torch.empty((nb, k), device=x.device)
        entry = self.lib.repro_vq_update_wide_u8_f32 if u8 \
            else self.lib.repro_vq_update_wide_f32
        err = entry(x.data_ptr(), cw.data_ptr(), cn2.data_ptr(),
                    idx.data_ptr(), qerr.data_ptr(), counts.data_ptr(),
                    sums.data_ptr(), nb, n, k, f,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"parent's wide vq_update failed: {err}")
        return idx, qerr, counts, sums

    def assign(self, x, cw):
        import torch
        nb, n, f = x.shape
        k = cw.shape[1]
        out = torch.empty((nb, n), dtype=torch.int32, device=x.device)
        mind = torch.empty((nb, n), device=x.device)
        cn2 = torch.empty((nb, k), device=x.device)
        err = self.lib.repro_vq_assign_wide_f32(
            x.data_ptr(), x.stride(0), x.stride(1), cw.data_ptr(),
            cn2.data_ptr(), out.data_ptr(), mind.data_ptr(), nb, n, k, f,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"parent's wide vq_assign failed: {err}")
        return out, mind


WIDE_PARENT: "_ParentWide | None" = None


def _beside_parent(row: dict, name: str, kernel, parent, same) -> None:
    """Time the parent's kernel beside this one, in turns (parent, kernel,
    kernel, parent), after checking that both give the same assignment."""
    import torch
    if WIDE_PARENT is None:
        return
    if not same(kernel(), parent()):
        raise SystemExit(f"{name}: the parent's wide kernel gives another "
                         f"assignment")
    torch.cuda.synchronize()
    p1 = cuda_ms(parent, 5, inner=4)[0]
    k1 = cuda_ms(kernel, 5, inner=4)[0]
    k2 = cuda_ms(kernel, 5, inner=4)[0]
    p2 = cuda_ms(parent, 5, inner=4)[0]
    row.update(parent_ms=[p1, p2], ms_beside_parent=[k1, k2])
    log(f"{name}: parent's kernel {p1:.4f} / {p2:.4f} ms, this one "
        f"{k1:.4f} / {k2:.4f} ms (parent, kernel, kernel, parent)")


def _wide_update_row(name: str, vw, cw, emit=None, tiles: bool = False
                     ) -> dict:
    """A vq_update row of the wide build: ``_vq_update_row``'s checks and
    times, the share of rows queued for the second pass (counted and
    estimated), the scratch bytes, the parent's kernel timed beside it
    (``--wide-parent``), with ``tiles`` both row tilings timed, and its
    operand shape's key in ``read_counts()["shapes"]``, by which the
    kernels line gives it the launches the main paths made at that
    shape."""
    import torch
    from repro_torch.kernels import vq_update as tvu
    vw, cw = vw.contiguous(), cw.contiguous()
    row = _vq_update_row(name, vw, cw, emit=emit)
    nb, n, f = vw.shape
    emit_ = torch.int32 if emit is None else emit
    row.update(form="wide" if emit is None else "wide uint8 emit",
               shape=shape_key("vq_update", nb, n, cw.shape[1], f,
                               "uint8" if emit == torch.uint8 else "int32"),
               **_queued(vw, cw,
                         lambda: tvu.vq_assign_update_cuda(vw, cw, emit_)))
    if tiles:
        row["ms_by_row_tile"] = {
            64 * wgs: cuda_ms(lambda: tvu.vq_assign_update_wide_tiles_cuda(
                vw, cw, wgs), 5, inner=4)[0] for wgs in (1, 2)}
        log(f"{name}: 64-row tiles {row['ms_by_row_tile'][64]:.4f} ms, "
            f"128-row tiles {row['ms_by_row_tile'][128]:.4f} ms")
    _beside_parent(row, name, lambda: tvu.vq_assign_update_cuda(vw, cw, emit_),
                   lambda: WIDE_PARENT.update(vw, cw, emit_),
                   lambda a, b: torch.equal(a[0], b[0])
                   and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))
    log(f"{name}: {row['queued_share']:.4f} of the rows queued for the "
        f"second pass (counted; {row['queued_share_est']:.4f} estimated "
        f"from the plain distances), scratch {row['scratch_bytes']} bytes")
    return row


def _wide_assign_row(name: str, x, cw) -> dict:
    """vq_assign's wide build against its plain version (index and
    want_min bit for bit), timed, with its bounds, queued share (counted
    and estimated), the parent's kernel beside it and operand shape's key
    in ``read_counts()["shapes"]``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.vq_assign import vq_assign_cuda
    got, gmin = vq_assign_cuda(x, cw, want_min=True)
    want, wmin = ref.vq_assign(x, cw, want_min=True)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(gmin, wmin)
            and torch.equal(vq_assign_cuda(x, cw), got)):
        raise SystemExit(f"{name}: index or want_min not bit-equal to the "
                         f"plain version ({int((got != want).sum())} rows)")
    nb, n, f = x.shape
    k = cw.shape[1]
    bms, by = bound(4 * nb * n * f + 4 * nb * k * f + 8 * nb * n,
                    2 * nb * n * k * f)
    tc_ms = 3 * 2 * nb * n * k * 8 * -(-f // 8) / TF32_FLOP_PER_S * 1e3
    ms, call_ms = cuda_ms(lambda: vq_assign_cuda(x, cw, want_min=True), 5,
                          inner=2)
    row = dict(form="wide", max_abs_err=0.0, agreement=1.0, ms=ms,
               call_ms=call_ms, bound_ms=bms, bound_by=by,
               tensor_bound_ms=tc_ms,
               plain_ms=cuda_ms(lambda: ref.vq_assign(x, cw, want_min=True),
                                3, inner=1)[0],
               library_ms=None,
               **_queued(x, cw, lambda: vq_assign_cuda(x, cw, want_min=True)),
               shape=shape_key("vq_assign", nb, n, k, f),
               at=f"x=[{nb}, {n}, {f}] cw=[{nb}, {k}, {f}] {name}")
    _beside_parent(row, f"vq_assign wide {name}",
                   lambda: vq_assign_cuda(x, cw, want_min=True),
                   lambda: WIDE_PARENT.assign(x, cw),
                   lambda a, b: torch.equal(a[0], b[0])
                   and torch.equal(a[1], b[1]))
    log(f"vq_assign wide {row['at']}: idx and want_min bit-equal  kernel "
        f"{ms:.4f} ms (one call {call_ms:.4f} ms)  plain "
        f"{row['plain_ms']:.4f} ms  bound {bms:.4f} ms ({by}; 3xTF32 "
        f"products {tc_ms:.4f} ms)  library none  "
        f"{row['queued_share']:.4f} of the rows queued (counted; "
        f"{row['queued_share_est']:.4f} estimated), scratch "
        f"{row['scratch_bytes']} bytes")
    return row


def _wgmma_probe(gen) -> dict:
    """The tensor cores' accumulation on the wide scan's wgmma path: d~ of
    4 x 16,384 rows x 1,024 codewords at f 65 (67 M distances: random,
    mixed-magnitude, large-row and |c|^2-dominated inputs) against the
    exact (float64) |c|^2 + lo*hi + hi*lo + hi*hi of the same TF32 parts;
    the largest |d~ - exact| as a share of 2^-20 (cmax^2 + 4 |x| |c|), the
    header's (ii) allowance for one accumulation."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.vq_assign import wide_probe_cuda

    def split(v):
        hi = (v.contiguous().view(torch.int32) & -8192).view(torch.float32)
        return hi, ((v - hi).view(torch.int32) & -8192).view(torch.float32)
    n, k, f = 16384, 1024, 65
    worst = {}
    for kind in ("random", "mixed", "large rows", "|c|^2-dominated"):
        x = torch.randn((1, n, f), generator=gen, device=DEVICE)
        cw = torch.randn((1, k, f), generator=gen, device=DEVICE)
        if kind == "mixed":
            x = x * torch.exp2(torch.randint(-8, 9, x.shape, generator=gen,
                                             device=DEVICE).float())
            cw = cw * torch.exp2(torch.randint(-8, 9, cw.shape, generator=gen,
                                               device=DEVICE).float())
        elif kind == "large rows":
            x = x * 1e3
        elif kind == "|c|^2-dominated":
            x, cw = x * 1e-2, cw * 30.0
        d = wide_probe_cuda(x, cw)[..., :k].double()
        ah, al = split(-2.0 * x)
        bh, bl = split(cw)
        cn2 = ref._sq_norms(cw)

        def mm(a, b):
            return torch.einsum("bnf,bkf->bnk", a.double(), b.double())
        exact = cn2[:, None, :].double() + mm(al, bh) + mm(ah, bl) \
            + mm(ah, bh)
        xn = x.double().norm(dim=2)[..., None]
        cn = cn2.double().sqrt()[:, None, :]
        cmax = cn.max()
        scale = 2.0 ** -20 * (cmax * cmax + 4 * xn * cn)
        worst[kind] = float(((d - exact).abs() / scale).max())
        del d, exact, scale
    worst["distances"] = 4 * n * k
    log(f"wgmma accumulation probe ({4 * n * k} distances at f {f}): "
        f"largest |d~ - exact| / (2^-20 (cmax^2 + 4 |x| |c|)) "
        + ", ".join(f"{kk} {v:.4f}" for kk, v in worst.items()
                    if kk != "distances"))
    return worst


def _whitened_batch(m: Model, params, vq, bids):
    """Each layer's whitened (X || G) rows of one batch, as the codebook
    update sees them."""
    from repro_torch.core import codebook as cbm
    from repro_torch.models.gnn import vq_loss_and_grads
    pack, x_b, y_b, lm = m.batch_inputs(bids)
    _, _, acts, _, gprobes = vq_loss_and_grads(
        params, vq, pack, x_b, y_b, m.ops.degrees, m.cfg, lm)
    cb = m.cfg.layer_codebook_cfg()
    return [cbm.whitened_rows(st.codebook, acts[l], gprobes[l], cb)[0]
            for l, st in enumerate(vq)]


def _near_tie(vw, cw, gen):
    """A near-tie codebook from trained codewords (1::4 duplicates 0::4,
    2::4 one ulp above in the first coordinate) and rows a third on a
    codeword, a third halfway between two."""
    import torch
    nb, b, f = vw.shape
    c = cw.clone()
    k = c.shape[1]
    c[:, 1::4] = c[:, 0::4][:, :c[:, 1::4].shape[1]]
    c2 = c[:, 0::4][:, :c[:, 2::4].shape[1]].clone()
    c2[..., 0] = torch.nextafter(c2[..., 0],
                                 torch.full_like(c2[..., 0], math.inf))
    c[:, 2::4] = c2
    pick = torch.randint(0, k, (nb, b), generator=gen, device=vw.device)
    on = torch.gather(c, 1, pick[..., None].expand(nb, b, f))
    other = torch.gather(c, 1, ((pick + 1) % k)[..., None].expand(nb, b, f))
    x = vw.clone()
    x[:, 0::3] = on[:, 0::3]
    x[:, 1::3] = (0.5 * (on + other))[:, 1::3]
    return x.contiguous(), c.contiguous()


def _near_codewords(cw, rows: int, gen, scale: float = 0.1):
    """``rows`` rows drawn near the codewords: a random codeword each, plus
    Gaussian noise of ``scale`` a coordinate."""
    import torch
    nb, k, f = cw.shape
    pick = torch.randint(0, k, (nb, rows), generator=gen, device=cw.device)
    x = torch.gather(cw, 1, pick[..., None].expand(nb, rows, f))
    noise = torch.randn((nb, rows, f), generator=gen, device=cw.device)
    return (x + scale * noise).contiguous()


def phase_wide_kernels(gat: tuple, tr: tuple, tr_server) -> dict:
    """The wide build of vq_update and vq_assign against their plain
    versions, on operands from the trained GAT and Graph Transformer, and
    timed: vq_update at GAT's [4, 42335, 65] and [4, 42335, 43] (k 1024)
    and the Transformer's [1, 5000, 256] and [1, 5000, 168] (the training
    batches' whitened rows), at [1, 42335, 256] on rows near the trained
    codewords, its uint8 emit at [4, 42335, 65] with the first 256
    codewords, on near-tie codebooks at f 65 and f 256; vq_assign with
    want_min at the Transformer's refresh shape [1, 20000, 128] and at
    [1, 169343, 128] on rows near its codewords.  Returns the ``also`` rows
    of vq_update and vq_assign."""
    import torch
    from repro_torch.core import codebook as cbm
    m_g, params_g, vq_g = gat
    m_r, params_r, vq_r = tr
    gen = torch.Generator(device=m_g.dev).manual_seed(SEED + 29)
    rng = np.random.default_rng(SEED + 31)
    upd, asg = [], []
    vw_g = _whitened_batch(m_g, params_g, vq_g,
                           rng.permutation(m_g.g.n)[:m_g.batch])
    for l in (0, len(vq_g) - 1):
        cw = vq_g[l].codebook.codewords_w
        upd.append(_wide_update_row(
            f"vq_update wide gat layer {l}", vw_g[l], cw, tiles=True))
        upd[-1]["at"] += f" gat-train layer {l}"
    cw0 = vq_g[0].codebook.codewords_w
    upd.append(_wide_update_row("vq_update wide uint8 emit gat layer 0",
                                vw_g[0], cw0[:, :256], torch.uint8))
    upd[-1]["at"] += " gat layer 0, the first 256 codewords"
    x, c = _near_tie(vw_g[0], cw0, gen)
    upd.append(_wide_update_row("vq_update wide near-tie f 65", x, c))
    upd[-1]["at"] += " near-tie codebook from gat layer 0"
    del vw_g, x, c
    vw_r = _whitened_batch(m_r, params_r, vq_r,
                           rng.permutation(m_r.g.n)[:m_r.batch])
    for l in (0, len(vq_r) - 1):
        cw = vq_r[l].codebook.codewords_w
        upd.append(_wide_update_row(
            f"vq_update wide transformer layer {l}", vw_r[l], cw,
            tiles=True))
        upd[-1]["at"] += f" transformer-train layer {l}"
    cw0 = vq_r[0].codebook.codewords_w
    x, c = _near_tie(vw_r[0], cw0, gen)
    upd.append(_wide_update_row("vq_update wide near-tie f 256", x, c))
    upd[-1]["at"] += " near-tie codebook from transformer layer 0"
    x = _near_codewords(cw0, m_g.batch, gen)
    upd.append(_wide_update_row("vq_update wide arxiv-scale batch", x, cw0))
    upd[-1]["at"] += " rows near the transformer's layer-0 codewords"
    del vw_r, x, c
    # vq_assign: the Transformer's refresh, and a full arxiv-size table
    st = tr_server.vq[0].codebook
    cfg = tr_server.cfg.layer_codebook_cfg()
    fb = tr_server.x.shape[1]
    v = cbm._whiten(tr_server.x.reshape(tr_server.g.n, 1, fb),
                    st.mean[:, :fb], st.var[:, :fb], cfg.eps)
    cwf = st.codewords_w[:, :, :fb].contiguous()
    asg.append(_wide_assign_row("transformer refresh layer 0",
                                v.transpose(0, 1), cwf))
    x = _near_codewords(cwf, N_NODES, gen)
    asg.append(_wide_assign_row("rows near the transformer's codewords", x,
                                cwf))
    upd[0]["wgmma_probe"] = _wgmma_probe(gen)
    return {"vq_update": upd, "vq_assign": asg}


# ---------------------------------------------------------------------------
# the link task (ogbl-collab look-alike, Hits@50) and the host-stepped loops
# ---------------------------------------------------------------------------

def _step_counts(cfg, batch: int, steps: int, n_eval: int,
                 evals: int) -> dict:
    """The launches of ``steps`` VQ steps at ``batch`` rows of a fixed
    convolution and ``evals`` full-graph evaluations over ``n_eval``
    nodes: per step every layer's forward runs spmm_ell (the intra-batch
    term, on the kernel ``spmm_ell_variant`` picks for its source) and
    context_ell and its codebook update vq_update; the backward of every
    layer but the first runs spmm_ell_t and, with Eq. 7, context_ell's w_t
    form.  Each evaluation runs one SpMM a layer over the whole graph."""
    inject = cfg.n_layers - 1 if cfg.grad_inject else 0
    intra_staged, intra_resident = _spmm_split(cfg, batch, steps)
    ev_staged, ev_resident = _spmm_split(cfg, n_eval, evals)
    return {"vq_update": cfg.n_layers * steps,
            "spmm_ell": intra_resident + ev_resident,
            "spmm_ell_hbm": intra_staged + ev_staged,
            "spmm_ell_t": (cfg.n_layers - 1) * steps,
            "context_ell": (cfg.n_layers + inject) * steps,
            "context_ell_wt": inject * steps}


def phase_link_train(m: Model) -> tuple[dict, dict]:
    """The link task's main path: ``train_vq`` (its host loop: each batch
    packed on the host and its positive pairs mined there) for
    LINK_EPOCHS epochs at ``paper_batch_size``, one Hits@50 evaluation at
    the end, counts exact.  Gates: finite losses and VQ errors, the last
    epoch's mean loss under the first's, and val Hits@50 above
    LINK_CHANCE_FACTOR times chance (50 / the val negatives).  The
    reference learns at this width (SAGE, hidden 128, 3 layers, k 1024)
    on the CPU at n 4,000 over 10 epochs with Eq. 7 on and off
    (``PERF.md`` §6)."""
    import torch
    from repro_torch.train.gnn_trainer import train_vq
    g, cfg, batch = m.g, m.cfg, m.batch
    per_epoch = -(-g.n // batch)
    steps = LINK_EPOCHS * per_epoch
    reset_counts()
    t0 = time.time()
    r = train_vq(g, cfg, epochs=LINK_EPOCHS, batch_size=batch, seed=SEED,
                 eval_every=LINK_EPOCHS, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    expect_counts("link-train", counts,
                  _step_counts(cfg, batch, steps, g.n, len(r["history"])))
    losses, errs = r["step_losses"], r["step_vq_errs"]
    if losses.shape != (steps,) or errs.shape != (steps, cfg.n_layers):
        raise SystemExit(f"link-train: {losses.shape} losses, {errs.shape} "
                         f"VQ errors for {steps} steps")
    epoch_loss = losses.reshape(LINK_EPOCHS, -1).mean(1)
    chance = LINK_HITS_K / len(g.val_neg_edges)
    h = r["history"][-1]
    r.update(wall_s=wall, epoch_loss=epoch_loss.tolist(),
             epoch_vq_err=errs.reshape(LINK_EPOCHS, -1).mean(1).tolist(),
             chance=chance,
             largest_cluster_share=largest_cluster_share(r["vq_states"]))
    log(f"link-train: {steps} steps of {batch} nodes and one full-graph "
        f"evaluation in {wall:.3f} s (epochs "
        f"{[round(v, 3) for v in r['epoch_s']]} s, of which host packing "
        f"and pair mining {[round(v, 3) for v in r['pack_s']]} s); mean "
        f"loss per epoch "
        f"{[round(v, 4) for v in r['epoch_loss']]}; val Hits@50 "
        f"{h['val']:.4f} test {h['test']:.4f} (chance {chance:.6f}) vq_err "
        f"{h['vq_err']:.4f}; largest cluster share per layer "
        f"{[round(v, 4) for v in r['largest_cluster_share']]}")
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(errs))):
        raise SystemExit("link-train: non-finite loss or VQ error")
    if not (epoch_loss[-1] < epoch_loss[0]
            and h["val"] > LINK_CHANCE_FACTOR * chance):
        raise SystemExit(f"link-train: last epoch's mean loss "
                         f"{epoch_loss[-1]} not under the first's "
                         f"{epoch_loss[0]}, or val Hits@50 {h['val']} not "
                         f"above {LINK_CHANCE_FACTOR} x chance {chance}")
    return r, counts


def phase_link_timing(m: Model, params, vq, ost) -> dict:
    """The link host loop's iterations from the trained state (outside
    the counted main path; their states are dropped): TIMED_STEPS of them,
    each the host's packing and pair mining, then the step, synchronised;
    then a torch.profiler window over 2, whose device busy share is the
    device's share of the loop."""
    import torch
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    from repro_torch.graph.batching import epoch_slices, make_pack
    from repro_torch.models.gnn import vq_train_step
    from repro_torch.train.gnn_trainer import _batch_pairs
    from repro_torch.train.optimizer import rmsprop
    opt = rmsprop(PAPER_LR)
    rng = np.random.default_rng(SEED + 11)
    ids = np.concatenate([epoch_slices(rng.permutation(m.g.n), m.batch)[0]
                          for _ in range(-(-TIMED_STEPS * m.batch // m.g.n)
                                         + 1)])[:TIMED_STEPS]
    ones = np.ones(m.batch, np.float32)

    def host(bids):
        pack = make_pack(m.g, bids, device=m.dev)
        pos, neg = _batch_pairs(m.g, bids, ones, rng)
        return pack, {"pos_pairs": torch.from_numpy(pos).to(m.dev),
                      "neg_pairs": torch.from_numpy(neg).to(m.dev)}

    def step(pack, pairs):
        i = pack.batch_ids.long()
        return vq_train_step(params, vq, ost, pack, m.x[i], m.labels[i],
                             m.ops.degrees, m.cfg, opt, **pairs)[3]

    pack_ms, step_ms = [], []
    for bids in ids:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = host(bids)
        t1 = time.perf_counter()
        float(step(*inputs))                     # synchronises
        pack_ms.append((t1 - t0) * 1e3)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    it = np.asarray(pack_ms) + np.asarray(step_ms)
    rep = {"steps": len(it), "iter_p50_ms": float(np.percentile(it, 50)),
           "iter_p99_ms": float(np.percentile(it, 99)),
           "pack_p50_ms": float(np.percentile(pack_ms, 50)),
           "step_p50_ms": float(np.percentile(step_ms, 50)),
           "step_p99_ms": float(np.percentile(step_ms, 99)),
           "pack_ms": pack_ms, "step_ms": step_ms}
    prof = _profile("link-train host loop", list(ids[:2]),
                    lambda bids: step(*host(bids)))
    rep["device_busy_share"] = prof["device_busy_share"]
    log(f"link-train timing: {len(it)} host-loop iterations of {m.batch} "
        f"nodes, p50 {rep['iter_p50_ms']:.3f} ms p99 "
        f"{rep['iter_p99_ms']:.3f} ms: host packing and pair mining p50 "
        f"{rep['pack_p50_ms']:.3f} ms, the step p50 "
        f"{rep['step_p50_ms']:.3f} ms p99 {rep['step_p99_ms']:.3f} ms; "
        f"device busy {rep['device_busy_share']:.3f} of the loop's wall "
        f"time")
    return rep


def phase_link_full(m: Model) -> tuple[dict, dict]:
    """``train_full`` on the link task for LINK_FULL_EPOCHS epochs (each
    one step over every message edge and as many uniform negatives) and
    one Hits@50 evaluation, counts exact: every layer's SpMM over the
    full graph stages its source (spmm_ell_hbm), every layer's but the
    first backward runs spmm_ell_t.  Gate: finite losses."""
    import torch
    from repro_torch.train.gnn_trainer import train_full
    g, cfg = m.g, m.cfg
    reset_counts()
    t0 = time.time()
    r = train_full(g, cfg, epochs=LINK_FULL_EPOCHS, seed=SEED,
                   eval_every=LINK_FULL_EPOCHS, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    staged, resident = _spmm_split(cfg, g.n,
                                   LINK_FULL_EPOCHS + len(r["history"]))
    expect_counts("link-full", counts, {
        "spmm_ell_hbm": staged, "spmm_ell": resident,
        "spmm_ell_t": (cfg.n_layers - 1) * LINK_FULL_EPOCHS})
    losses = r["step_losses"]
    h = r["final"]
    r["wall_s"] = wall
    log(f"link-full: {LINK_FULL_EPOCHS} full-graph steps over "
        f"{len(g.train_edges)} positive pairs in {wall:.3f} s; losses "
        f"{[round(float(v), 4) for v in losses]}; val Hits@50 "
        f"{h['val']:.4f} test {h['test']:.4f}")
    if losses.shape != (LINK_FULL_EPOCHS,) or \
            not np.all(np.isfinite(losses)):
        raise SystemExit(f"link-full: losses {losses}")
    return r, counts


def phase_link_sampler(m: Model) -> tuple[dict, dict]:
    """``train_scenario``'s Cluster-GCN on the link task for
    LINK_SAMPLER_EPOCHS epoch (the host loop: each subgraph's pairs mined
    on the host, at most 4,096, a subgraph with fewer than two skipped)
    and one Hits@50 evaluation, counts exact: the subgraphs' SpMMs stay
    resident, the evaluation stages the full graph's.  Gate: finite
    losses."""
    import torch
    from repro_torch.train.gnn_trainer import train_scenario
    from repro_torch.kernels import ops as kops
    g, cfg = m.g, m.cfg
    reset_counts()
    t0 = time.time()
    r = train_scenario(g, cfg, "cluster", epochs=LINK_SAMPLER_EPOCHS,
                       batch_size=m.batch, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    steps = sum(len(ls) for ls in r["losses"])
    rows = max(r["subgraph_rows"])
    if any(kops.spmm_ell_variant(rows, fi, 4) != "resident"
           for fi, _ in cfg.layer_dims()):
        raise SystemExit(f"link-sampler: {rows}-row subgraphs are staged; "
                         f"the count check assumes resident SpMMs")
    ev_staged, ev_resident = _spmm_split(cfg, g.n, len(r["history"]))
    expect_counts("link-sampler", counts, {
        "spmm_ell": cfg.n_layers * steps + ev_resident,
        "spmm_ell_hbm": ev_staged,
        "spmm_ell_t": (cfg.n_layers - 1) * steps})
    losses = np.concatenate(r["losses"])
    h = r["final"]
    r["wall_s"] = wall
    log(f"link-sampler: Cluster-GCN, {steps} steps over subgraphs of up to "
        f"{rows} padded rows in {wall:.3f} s -- host sampling "
        f"{sum(r['sample_s']):.3f} s, packing and pair mining "
        f"{sum(r['pack_s']):.3f} s, device steps {sum(r['train_s']):.3f} "
        f"s; losses {[round(float(v), 4) for v in losses]}; val Hits@50 "
        f"{h['val']:.4f} test {h['test']:.4f}")
    if steps < 1 or not np.all(np.isfinite(losses)):
        raise SystemExit(f"link-sampler: {steps} steps, losses {losses}")
    return r, counts


def phase_link_kernels(m: Model, params, vq) -> dict[str, list[dict]]:
    """Every kernel of the link path against its plain version at the
    link batch's own operands (``_step_rows`` on one batch of the trained
    model: vq_update at [32, b, 8], SAGE's spmm_ell, spmm_ell_t and both
    context_ell forms) and spmm_ell_hbm at the full graph's SAGE operands,
    timed beside their bounds.  Returns the rows by kernel name (under
    each kernel's ``also``)."""
    import torch
    rng = np.random.default_rng(SEED + 5)
    out = _step_rows(m, params, vq,
                     m.batch_inputs(rng.permutation(m.g.n)[:m.batch]),
                     "link batch")
    # SAGE's full-graph SpMM: the mean over each node's in-edges
    vals = m.ops.nbr_mask / torch.clamp(m.ops.degrees, min=1.0)[:, None]
    out["spmm_ell_hbm"] = [_staged_row(
        m.ops.nbr_ids.contiguous(), vals.contiguous(), m.x, None,
        "(link full-graph evaluation)", m.ops.stripe_index)]
    for rows in out.values():
        for row in rows:
            row["path"] = "link"
    return out


def phase_host_loop(m: Model) -> tuple[dict, dict]:
    """The host-stepped loops on the arxiv graph and model of phase 3: one
    epoch of ``train_vq`` with ``REPRO_EPOCH_EXECUTOR=0`` (each batch
    packed on the host) against one on the epoch executor, from the same
    seed -- counts exact and equal, step losses within STEP_TOL -- then
    ``vq_inference`` with ``REPRO_INFER_EXECUTOR=0`` (the eager per-batch
    loop) against the executor on the host-trained state: rows within
    SERVE_TOL, the same launches."""
    import torch
    from repro_torch.train.gnn_trainer import train_vq, vq_inference
    g, cfg, batch = m.g, m.cfg, m.batch
    steps = -(-g.n // batch)
    runs, counts = {}, {}
    try:
        for name, value in (("executor", "1"), ("host loop", "0")):
            os.environ["REPRO_EPOCH_EXECUTOR"] = value
            reset_counts()
            t0 = time.time()
            runs[name] = train_vq(g, cfg, epochs=1, batch_size=batch,
                                  seed=SEED, device=DEVICE)
            torch.cuda.synchronize()
            runs[name]["wall_s"] = time.time() - t0
            counts[name] = read_counts()
            expect_counts(f"host-loop train {name}", counts[name],
                          _step_counts(cfg, batch, steps, g.n, 1))
        os.environ.pop("REPRO_EPOCH_EXECUTOR")
        ex, host = runs["executor"], runs["host loop"]
        err = check_close("host-loop step losses",
                          torch.from_numpy(host["step_losses"]),
                          torch.from_numpy(ex["step_losses"]), STEP_TOL)
        acts = {}
        for name, value in (("executor", "1"), ("eager", "0")):
            os.environ["REPRO_INFER_EXECUTOR"] = value
            reset_counts()
            t0 = time.time()
            acts[name] = vq_inference(host["params"], host["vq_states"], g,
                                      cfg, batch)
            counts[f"infer {name}"] = read_counts()
            log(f"host-loop inference {name}: {time.time() - t0:.3f} s")
            expect_counts(f"host-loop inference {name}",
                          counts[f"infer {name}"], {
                              "spmm_ell": cfg.n_layers * steps,
                              "context_ell": cfg.n_layers * steps})
    finally:
        os.environ.pop("REPRO_EPOCH_EXECUTOR", None)
        os.environ.pop("REPRO_INFER_EXECUTOR", None)
    rows_err = check_close("host-loop inference rows",
                           torch.from_numpy(acts["eager"]),
                           torch.from_numpy(acts["executor"]), SERVE_TOL)
    rep = {"steps": steps, "max_abs_err": err,
           "inference_max_abs_err": rows_err,
           "pack_s": host["pack_s"], "epoch_s": {
               "executor": ex["epoch_s"][0], "host loop": host["epoch_s"][0]},
           "step_losses": host["step_losses"].tolist()}
    log(f"host-loop: one epoch of {steps} steps, host loop vs executor: "
        f"step losses max abs err {err:.3g} (rtol 1e-4, atol 1e-5); epoch "
        f"{host['epoch_s'][0]:.3f} s (host packing {host['pack_s'][0]:.3f} "
        f"s) vs {ex['epoch_s'][0]:.3f} s; eager inference vs executor: "
        f"rows max abs err {rows_err:.3g} (rtol 1e-4, atol 1e-5)")
    total = add_counts(counts["host loop"], counts["infer eager"])
    return rep, total


# ---------------------------------------------------------------------------
# dispatch: the context loop, the L2 budget, the tuner, the rest of the core
# ---------------------------------------------------------------------------

# [32, n] int32 tables timed fused against loop: arxiv's (21.7 MB, under
# the 50 MiB L2), then 64, 128, 256 and 512 MB above it
DISPATCH_TABLES = (169343, 500000, 1000000, 2000000, 4000000)
DISPATCH_NB = 32
EPOCH_STEPS = 5               # one arxiv epoch at paper_batch_size


def _loop_row(ids, vals, a, cw, w_t, at: str, cw_scale=None) -> dict:
    """The per-branch context loop (``ops._context_ell_loop``) against the
    fused kernel and the plain version on one set of operands: the plain
    form bit for bit, the ``w_t`` form (its product a ``torch.matmul``)
    within the bound on summing its products in another order
    (``check_scatter``); its launches (one spmm_ell a branch, nothing
    else) counted exactly; both variants timed."""
    import torch
    from repro_torch.kernels import ops as kops, ref
    from repro_torch.kernels.context_ell import context_ell_cuda
    nb = cw.shape[0]
    reset_counts()
    got = kops._context_ell_loop(ids, vals, a, cw, w_t, cw_scale)
    torch.cuda.synchronize()
    expect_counts(f"context loop {at}", read_counts(), {
        "spmm_ell": nb, "spmm_ell_q": nb if cw_scale is not None else 0})
    fused = context_ell_cuda(ids, vals, a, cw, w_t, cw_scale)
    plain = ref.context_ell(ids, vals, a, cw, w_t, cw_scale)
    if w_t is None:
        _bit_equal(f"context loop {at}", got, plain)
        _bit_equal(f"context_ell fused {at}", fused, plain)
        err = 0.0
    else:
        # the loop's product is a torch.matmul: its nb * f_blk products
        # summed in another order than the plain version's
        ctx = ref.context_ell(ids, vals, a, cw, None, cw_scale)
        abs_sum = ctx.abs() @ w_t.abs()
        terms = torch.full_like(abs_sum, float(ctx.shape[1]))
        err = check_scatter(f"context loop {at}", got, plain, abs_sum, terms)
        check_close(f"context_ell fused {at}", fused, plain, TOL)
    loop_ms = cuda_ms(lambda: kops._context_ell_loop(ids, vals, a, cw, w_t,
                                                     cw_scale), 3, inner=4)[0]
    fused_ms = cuda_ms(lambda: context_ell_cuda(ids, vals, a, cw, w_t,
                                                cw_scale), 3, inner=10)[0]
    b, deg = ids.shape
    row = dict(at=f"b={b} D={deg} n={a.shape[1]} nb={nb} k={cw.shape[1]} "
                  f"fb={cw.shape[2]}" + ("" if w_t is None else
                                         f" f_out={w_t.shape[1]}")
                  + f" {at}", loop_ms=loop_ms, fused_ms=fused_ms,
               max_abs_err=err, spmm_launches=nb)
    log(f"context loop {row['at']}: "
        f"{'bit-equal' if w_t is None else f'max abs err {err:.3g}'} "
        f"({nb} spmm_ell launches)  loop {loop_ms:.5f} ms  fused "
        f"{fused_ms:.5f} ms")
    return row


def _tuned(name: str, fn, *args, **kw) -> dict:
    """One tuner query, cold or warm: its config, seconds and whether it
    measured."""
    from repro_torch.kernels import autotune
    n0 = len(autotune.measured)
    t0 = time.time()
    cfg = fn(*args, **kw)
    dt = time.time() - t0
    cold = len(autotune.measured) > n0
    ms = cfg.get("ms", {}) if cfg else {}
    win = {k: v for k, v in cfg.items() if k != "ms"} if cfg else None
    log(f"tuner {name}: {'measured' if cold else 'cache hit'} in {dt:.3f} "
        f"s -> {win}; " + ", ".join(f"{k} {v:.5f} ms" for k, v in
                                    sorted(ms.items(), key=lambda kv: kv[1])))
    return {"query": name, "winner": win, "ms": ms, "seconds": dt,
            "measured": cold}


def _expected_epoch_counts(cfg, vq, batch: int, n: int) -> dict:
    """The launches of one ``train_vq`` epoch (EPOCH_STEPS steps and one
    evaluation) under the dispatch as it stands -- tuned or not: each
    SpMM on the variant ``spmm_ell_variant`` picks, each layer's context
    on the fused kernel or, where ``context_ell_variant`` picks the loop,
    as one spmm_ell a branch."""
    import torch
    from repro_torch.kernels import ops as kops
    want = _step_counts(cfg, batch, EPOCH_STEPS, n, 1)
    for l, st in enumerate(vq):
        nb = st.codebook.n_branches
        if kops.context_ell_variant(n, nb, 4, torch.int32) == "loop":
            wt = EPOCH_STEPS * (cfg.grad_inject and l > 0)
            want["context_ell"] -= EPOCH_STEPS + wt
            want["context_ell_wt"] -= wt
            want["spmm_ell"] += (EPOCH_STEPS + wt) * nb
    return want


def _assign_rows(st, feats, grads, cb):
    """``codebook.assign``'s operand: the (X || G) rows split into
    branches and whitened with the state's moments, [nb, b, f_blk]."""
    from repro_torch.core import codebook as cbm
    v = cbm._concat_rows(st, feats, grads)
    return cbm._whiten(v, st.mean[:, None, :], st.var[:, None, :], cb.eps) \
        if cb.whiten else v


def phase_dispatch(m: Model, params, vq, ost, cpu: Model, server,
                   link: tuple, tier: tuple, gat: tuple
                   ) -> tuple[dict, dict]:
    """The dispatch layer and the rest of the VQ core on phase 3's trained
    state (``link``, ``tier``, ``gat``: (model, params, states) of the
    link, int8-tier and GAT runs): (a) the per-branch context loop against
    the fused kernel and the plain version at the training batch (forward
    and ``w_t``), the link batch, the serving batch and the int8 tier; (b)
    both variants at [32, n] int32 tables under and above the L2; (c) one
    step at PARITY_BATCH under ``REPRO_CONTEXT_VARIANT=loop``, card vs CPU,
    its launches exact; (d) the tuner cold at the main paths' sources,
    tables and wide shapes; (e) warm: no measurement and no launch, then
    one arxiv epoch tuned against the same epoch untuned; (f)
    ``codebook.assign`` on vq_assign, bit-equal; (g) ``relative_error`` per
    layer, card vs CPU; (h) ``kmeanspp_init`` from a CUDA generator, card
    vs CPU.  Returns its report and the rows for the kernels line's
    ``also``."""
    import tempfile
    import torch
    from repro_torch.convert import to_device
    from repro_torch.core import codebook as cbm
    from repro_torch.core.conv import fixed_conv_operands
    from repro_torch.graph.batching import plan_batch
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.vq_assign import kstep, vq_assign_cuda
    from repro_torch.train.gnn_trainer import train_vq
    cfg, dev = m.cfg, m.dev
    cb = cfg.layer_codebook_cfg()
    rep: dict = {}
    also: dict[str, list] = {"vq_assign": [], "spmm_ell": [],
                             "context_ell": []}

    # --- (a) the loop against the fused kernel and the plain version ---
    rng = np.random.default_rng(SEED + 5)
    bids_np = rng.permutation(m.g.n)[:m.batch]
    inputs = m.batch_inputs(bids_np)
    loop_rows = []

    def step_operands(mm, pp, vv, inp, tag, layers_fwd, layers_wt):
        kind, w_key = FIXED_CONV[mm.cfg.backbone]
        ops_, _ = fixed_conv_operands(kind, inp[0], mm.ops.degrees)
        ccb = mm.cfg.layer_codebook_cfg()
        for layer in layers_fwd:
            fi = mm.cfg.layer_dims()[layer][0]
            st = vv[layer]
            if st.qcw is not None:
                cw, sc = st.qcw.feat.q, st.qcw.feat.scale
            else:
                cw, sc = cbm.feature_codewords(st.codebook, fi, ccb), None
            loop_rows.append(_loop_row(
                ops_.out_ids.contiguous(), ops_.out_vals.contiguous(),
                st.assignment, cw, None, f"({tag} forward, layer {layer})",
                sc))
        for layer in layers_wt:
            fi = mm.cfg.layer_dims()[layer][0]
            loop_rows.append(_loop_row(
                ops_.rev_ids.contiguous(), ops_.rev_vals.contiguous(),
                vv[layer].assignment,
                cbm.gradient_codewords(vv[layer].codebook, fi, ccb),
                pp[layer][w_key].t().contiguous(),
                f"({tag} backward, layer {layer})"))
        return ops_

    ops_train = step_operands(m, params, vq, inputs, "training batch",
                              (0, cfg.n_layers - 1),
                              range(1, cfg.n_layers))
    m_l, params_l, vq_l = link
    step_operands(m_l, params_l, vq_l, m_l.batch_inputs(
        np.random.default_rng(SEED + 5).permutation(m_l.g.n)[:m_l.batch]),
        "link batch", (0,), (1,))
    m_t, params_t, vq_t = tier
    step_operands(m_t, params_t, vq_t, inputs, "int8 tier training batch",
                  (0,), ())
    sbids = torch.from_numpy(np.random.default_rng(SEED + 7).choice(
        server.g.n, BATCH, replace=False).astype(np.int32)).to(dev)
    sops, _ = fixed_conv_operands("gcn", plan_batch(server.plan, sbids),
                                  server.ops.degrees)
    st0 = server.vq[0]
    loop_rows.append(_loop_row(
        sops.out_ids.contiguous(), sops.out_vals.contiguous(),
        st0.assignment, cbm.feature_codewords(
            st0.codebook, server.cfg.layer_dims()[0][0], cfg.codebook),
        None, "(serve step, layer 0)"))
    rep["loop"] = loop_rows
    # one branch's SpMM of the loop: [b, D] slots into a [k, f_blk] table
    ids0, vals0 = ops_train.out_ids.contiguous(), \
        ops_train.out_vals.contiguous()
    fcw0 = cbm.feature_codewords(vq[0].codebook, cfg.layer_dims()[0][0], cb)
    bid0 = vq[0].assignment[:, ids0.long()].to(torch.int32)[0].contiguous()
    srow = _spmm_row(bid0, vals0, fcw0[0].contiguous(),
                     "(context loop, branch 0 of layer 0, training batch)")
    srow["form"] = "context loop branch"
    also["spmm_ell"].append(srow)

    # --- (b) both variants under and above the L2 ---
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    above = []
    for n in DISPATCH_TABLES:
        table = torch.randint(0, fcw0.shape[1], (DISPATCH_NB, n),
                              generator=gen, device=dev, dtype=torch.int32)
        ids = torch.randint(0, n, tuple(ids0.shape), generator=gen,
                            device=dev, dtype=torch.int32)
        row = _loop_row(ids, vals0, table, fcw0, None,
                        f"(table [{DISPATCH_NB}, {n}] int32, "
                        f"{4 * DISPATCH_NB * n / 1e6:.1f} MB)")
        row["table_mb"] = 4 * DISPATCH_NB * n / 2 ** 20
        row["auto"] = kops.context_ell_variant(n, DISPATCH_NB, 4)
        row["faster"] = "fused" if row["fused_ms"] <= row["loop_ms"] \
            else "loop"
        # the dispatch's own path at this table: ops.context_ell under
        # 'auto', its launches counted and its result the plain version's
        reset_counts()
        got = kops.context_ell(ids, vals0, table, fcw0)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"context_ell auto {row['at']}", counts,
                      {"context_ell": 1} if row["auto"] == "fused"
                      else {"spmm_ell": DISPATCH_NB})
        _bit_equal(f"context_ell auto {row['at']}", got,
                   ref.context_ell(ids, vals0, table, fcw0))
        row["auto_launches"] = {c: counts[c] for c in
                                ("context_ell", "spmm_ell")}
        log(f"context dispatch at {row['table_mb']:.1f} MiB: the faster "
            f"variant {row['faster']}, auto picks {row['auto']} "
            f"(launches {row['auto_launches']})")
        above.append(row)
        if n > DISPATCH_TABLES[0]:
            also["context_ell"].append(dict(
                form="table above the L2", at=row["at"],
                ms=row["fused_ms"], loop_ms=row["loop_ms"],
                max_abs_err=0.0, launches=counts["context_ell"],
                launches_on="ops.context_ell under auto, dispatch phase",
                main_path="none: no main path holds a table above the L2"))
        del table, ids, got
    rep["tables"] = above

    # --- (c) one step under the loop, card against CPU ---
    os.environ["REPRO_CONTEXT_VARIANT"] = "loop"
    try:
        reset_counts()
        parity = phase_train_parity(m, params, vq, ost, cpu,
                                    "dispatch loop parity")
        counts = read_counts()
    finally:
        os.environ.pop("REPRO_CONTEXT_VARIANT")
    nbs = [st.codebook.n_branches for st in vq]
    inject = cfg.grad_inject
    loop_spmm = sum(nbs) + (sum(nbs[1:]) if inject else 0)
    expect_counts("dispatch loop step", counts, {
        "vq_update": cfg.n_layers, "spmm_ell_t": cfg.n_layers - 1,
        "spmm_ell": cfg.n_layers + loop_spmm})
    rep["loop_step"] = {"parity": parity, "spmm_ell_loop": loop_spmm}
    # the loop's launches in that step: every spmm_ell but the layers' own
    srow["launches"] = counts["spmm_ell"] - cfg.n_layers
    srow["launches_on"] = "REPRO_CONTEXT_VARIANT=loop step, dispatch phase"

    # --- (d) the tuner, cold ---
    tmp = tempfile.mkdtemp(prefix="repro_autotune_")
    os.environ["REPRO_AUTOTUNE"] = "1"
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
    autotune.clear(memory_only=True)
    queries = [
        ("spmm 42335 x 128 f32", autotune.tuned_spmm, (42335, 128, 4),
         {"dtype": torch.float32}),
        ("spmm 84670 x 128 f32", autotune.tuned_spmm, (84670, 128, 4),
         {"dtype": torch.float32}),
        ("spmm 169343 x 128 f32", autotune.tuned_spmm, (169343, 128, 4),
         {"dtype": torch.float32}),
        ("spmm 235868 x 128 f32", autotune.tuned_spmm, (235868, 128, 4),
         {"dtype": torch.float32}),
        ("spmm 169343 x 128 int8", autotune.tuned_spmm, (169343, 128, 1),
         {"dtype": torch.int8}),
        ("context [32, 169343] int32", autotune.tuned_context,
         (169343, 32, 4), {"dtype": torch.int32}),
        ("context [32, 169343] uint8", autotune.tuned_context,
         (169343, 32, 1), {"dtype": torch.uint8}),
        ("context [32, 169343] packed", autotune.tuned_context,
         (169343, 32, 0.5), {"dtype": "uint4"}),
        ("context [32, 235868] int32", autotune.tuned_context,
         (235868, 32, 4), {"dtype": torch.int32})]
    # the rest of what one arxiv epoch asks: the last layer's table (the
    # loop's per-branch SpMMs call the resident kernel, no dispatch)
    for st in vq[1:]:
        c = st.codebook
        if c.n_branches != 32:
            queries.append((f"context [{c.n_branches}, {m.g.n}] int32",
                            autotune.tuned_context,
                            (m.g.n, c.n_branches, 4), {"dtype": torch.int32}))
    for nb_, k_, f_ in sorted({(st.codebook.n_branches, st.codebook.k,
                                st.codebook.f_blk) for st in gat[2]}):
        queries.append((f"vq_update wide [{nb_}, {m.batch}, {f_}] k {k_}",
                        autotune.tuned_vq_update, (m.batch, k_, f_),
                        {"nb": nb_}))
        # the uint8 emit's row tile: its own entries, raced as launched
        queries.append((f"vq_update wide [{nb_}, {m.batch}, {f_}] k "
                        f"{TIER_K} uint8 emit", autotune.tuned_vq_update,
                        (m.batch, TIER_K, f_),
                        {"nb": nb_, "emit_dtype": torch.uint8}))
    for f in (256, 168):
        queries.append((f"vq_update wide [1, 5000, {f}] k {cfg.codebook.k}",
                        autotune.tuned_vq_update,
                        (5000, cfg.codebook.k, f), {"nb": 1}))
    try:
        rep["tuner_cold"] = [_tuned(q, fn, *a, **kw)
                             for q, fn, a, kw in queries]
        # --- (e) warm: a hit measures nothing and launches nothing ---
        reset_counts()
        warm = [_tuned(q, fn, *a, **kw) for q, fn, a, kw in queries]
        got = read_counts()
        if any(w["measured"] for w in warm):
            raise SystemExit("tuner: a warm query measured again")
        expect_counts("tuner warm lookups", got, {})
        # one arxiv epoch tuned against the same epoch untuned
        epochs = {}
        for name in ("untuned", "tuned"):
            os.environ["REPRO_AUTOTUNE"] = "1" if name == "tuned" else "0"
            reset_counts()
            t0 = time.time()
            run = train_vq(m.g, cfg, epochs=1, batch_size=m.batch, seed=SEED,
                           device=DEVICE)
            torch.cuda.synchronize()
            wall = time.time() - t0
            got = read_counts()
            want = _expected_epoch_counts(cfg, vq, m.batch, m.g.n)
            expect_counts(f"dispatch epoch {name}", got, want)
            epochs[name] = (run, wall, got)
        err = check_close("tuned epoch step losses",
                          torch.from_numpy(epochs["tuned"][0]["step_losses"]),
                          torch.from_numpy(
                              epochs["untuned"][0]["step_losses"]), STEP_TOL)
        rep["tuned_epoch"] = {
            "max_abs_err": err, "wall_s": {k: v[1] for k, v in
                                           epochs.items()},
            "step_losses": epochs["tuned"][0]["step_losses"].tolist(),
            "counts": {k: {c: n for c, n in v[2].items()
                           if c not in KEYED and n}
                       for k, v in epochs.items()}}
        log(f"dispatch epoch: tuned vs untuned step losses max abs err "
            f"{err:.3g} (rtol 1e-4, atol 1e-5); wall "
            f"{epochs['tuned'][1]:.3f} s vs {epochs['untuned'][1]:.3f} s")
        rep["cache_entries"] = len(autotune._load())
    finally:
        for var in ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE"):
            os.environ.pop(var, None)
        autotune.clear(memory_only=True)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    # --- (f) codebook.assign on vq_assign, (g) relative_error, (h)
    # kmeanspp_init, on the training batch's rows ---
    _, _, acts, _, gpr = _loss_grads(m, params, vq, inputs)
    st = vq[0].codebook
    reset_counts()
    got = cbm.assign(st, acts[0], gpr[0], cb)
    torch.cuda.synchronize()
    assign_counts = read_counts()
    expect_counts("codebook.assign", assign_counts, {"vq_assign": 1})
    v = _assign_rows(st, acts[0], gpr[0], cb)
    cw = st.codewords_w.contiguous()
    _bit_equal("codebook.assign", got, ref.vq_assign(v, cw))
    nb, n, f = v.shape
    k = cw.shape[1]
    bms, by = bound(4 * nb * n * f + 4 * nb * k * f + 4 * nb * n,
                    2 * nb * n * k * f)
    # the bounds of the kernel's own units, as vq_assign's own rows give
    # them: its 3xTF32 products on the tensor cores, and one
    # compare-select a distance at the fp32 issue rate
    ks = kstep(f)
    tc_ms = 3 * 2 * nb * n * k * ks * -(-f // ks) / TF32_FLOP_PER_S * 1e3
    sel_ms = nb * n * k / (FP32_FLOP_PER_S / 2) * 1e3
    ms, call_ms = cuda_ms(lambda: cbm.assign(st, acts[0], gpr[0], cb), 5,
                          inner=4)
    kern_ms = cuda_ms(lambda: vq_assign_cuda(v, cw), 5, inner=4)[0]
    arow = dict(form="codebook.assign", at=f"x=[{nb}, {n}, {f}] cw=[{nb}, "
                f"{k}, {f}] (training batch, layer 0, whitened X || G)",
                ms=kern_ms, assign_ms=ms, call_ms=call_ms,
                plain_ms=cuda_ms(lambda: ref.vq_assign(v, cw), 3,
                                 inner=1)[0],
                bound_ms=bms, bound_by=by, tensor_bound_ms=tc_ms,
                select_bound_ms=sel_ms, library_ms=None, max_abs_err=0.0,
                launches=assign_counts["vq_assign"],
                launches_on="codebook.assign, dispatch phase")
    log(f"codebook.assign {arow['at']}: bit-equal  vq_assign "
        f"{kern_ms:.4f} ms (assign with its whitening {ms:.4f} ms, one call "
        f"{call_ms:.4f} ms)  plain {arow['plain_ms']:.4f} ms  bound "
        f"{bms:.4f} ms ({by}; 3xTF32 products {tc_ms:.4f} ms, "
        f"compare-selects {sel_ms:.4f} ms)")
    also["vq_assign"].append(arow)
    m_g, params_g, vq_g = gat
    _, _, acts_g, _, gpr_g = _loss_grads(m_g, params_g, vq_g, inputs)
    stg = vq_g[0].codebook
    reset_counts()
    got = cbm.assign(stg, acts_g[0], gpr_g[0], m_g.cfg.layer_codebook_cfg())
    torch.cuda.synchronize()
    assign_counts = read_counts()
    expect_counts("codebook.assign (GAT)", assign_counts, {
        "vq_assign": 1, "vq_assign_wide": 1})
    vg = _assign_rows(stg, acts_g[0], gpr_g[0], m_g.cfg.layer_codebook_cfg())
    _bit_equal("codebook.assign (GAT, wide build)", got,
               ref.vq_assign(vg, stg.codewords_w.contiguous()))
    also["vq_assign"].append(dict(
        form="codebook.assign, wide build",
        at=f"x={list(vg.shape)} cw={list(stg.codewords_w.shape)} (GAT "
           f"training batch, layer 0)",
        ms=cuda_ms(lambda: vq_assign_cuda(vg, stg.codewords_w.contiguous()),
                   3, inner=4)[0], max_abs_err=0.0,
        launches=assign_counts["vq_assign_wide"],
        launches_on="codebook.assign, dispatch phase"))
    del acts_g, gpr_g, vg
    rel = []
    for l, s in enumerate(vq):
        fi = cfg.layer_dims()[l][0]
        a = cbm.assign(s.codebook, acts[l], gpr[l], cb)
        e_card = cbm.relative_error(s.codebook, acts[l], gpr[l], a, fi, cb)
        e_cpu = cbm.relative_error(to_device(s.codebook, "cpu"),
                                   acts[l].cpu(), gpr[l].cpu(), a.cpu(), fi,
                                   cb)
        check_close(f"relative_error layer {l}", e_card, e_cpu, TOL)
        rel.append(float(e_card))
    log(f"relative_error per layer (card, CPU within TOL): {rel}")
    rep["relative_error"] = rel
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seeded = cbm.kmeanspp_init(st, acts[0], gpr[0], cb, generator=gen)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.randint(0, n, (nb, k), generator=gen, device=dev)
    noise = torch.randn((nb, k, f), generator=gen, device=dev)
    if int(rows.min()) < 0 or int(rows.max()) >= n:
        raise SystemExit("kmeanspp_init: rows out of range")
    v_raw = cbm._concat_rows(st, acts[0], gpr[0])
    on_cpu = cbm._kmeanspp_seed(to_device(st, "cpu"), v_raw.cpu(),
                                rows.cpu(), noise.cpu(), cb)
    for name in ("codewords_w", "cluster_sum", "mean", "var"):
        check_close(f"kmeanspp_init {name}", getattr(seeded, name),
                    getattr(on_cpu, name), TOL)
    log(f"kmeanspp_init: [{nb}, {k}, {f}] seeds from a CUDA generator, "
        f"card vs CPU within TOL")
    return rep, also


# ---------------------------------------------------------------------------
# mesh: the multi-device paths on torch.distributed
# ---------------------------------------------------------------------------

MESH_EPOCHS = 2               # (a): train_vq with and without a mesh
MESH_RANKS = 2                # (b) and (c): ranks sharing the one card
MESH_BATCH = 42336            # (b): the training batch, divisible by 2 and 4
MESH_SERVE_IDS = 48           # (b): 40 strided ids and 8 repeats of id 0
# (c): serve_gnn's micro-batch, also its refresh's batch: 166 sharded
# batches a layer (at 256, 662 of them took 19.4 s of staged collectives)
MESH_SERVE_BATCH = 1024


def _mesh_close(name: str, got, want, tol: dict | None) -> float:
    """Max abs difference of two numpy trees' leaves; equal bits when
    ``tol`` is None, else within it."""
    err = 0.0
    for a, b in zip(_np_leaves(got), _np_leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or (a.dtype.kind == "f"
                                  and not np.all(np.isfinite(a))):
            raise SystemExit(f"mesh {name}: shape {a.shape} vs {b.shape} "
                             f"or non-finite values")
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        err = max(err, float(d.max()) if d.size else 0.0)
        ok = np.array_equal(a, b) if tol is None else np.allclose(a, b,
                                                                  **tol)
        if not ok:
            raise SystemExit(f"mesh {name}: max abs err {err}, wanted "
                             f"{'equal bits' if tol is None else tol}")
    return err


def _max_abs_diff(got, want) -> float:
    """Largest abs difference over two numpy trees' leaves."""
    return max((float(np.abs(np.asarray(a, np.float64)
                             - np.asarray(b, np.float64)).max())
                for a, b in zip(_np_leaves(got), _np_leaves(want))
                if np.asarray(a).size), default=0.0)


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _np_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _np_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _np_leaves(v)
    else:
        yield tree


def _digest(tree) -> str:
    import hashlib
    h = hashlib.sha256()
    for a in _np_leaves(tree):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _init_state(cfg, n: int, dev):
    """``train_vq``'s starting state from seed SEED: params, VQ states,
    the RMSprop state, and the optimizer."""
    import torch
    from repro_torch.configs.vq_gnn_paper import PAPER_LR
    from repro_torch.models.gnn import init_gnn, init_vq_states
    from repro_torch.train.optimizer import rmsprop
    opt = rmsprop(PAPER_LR)
    params = init_gnn(cfg, torch.Generator().manual_seed(SEED), device=dev)
    vq = init_vq_states(cfg, n, torch.Generator().manual_seed(SEED + 1),
                        device=dev)
    return (params, vq, opt.init(params)), opt


def _step_diff(got, want) -> dict:
    """One step of two paths from the same state (``vq_train_epoch``'s
    returns over one batch): the loss, every param and the optimizer's
    second moment within STEP_TOL; the refreshed assignment tables equal
    but for near-tie flips (at most 1e-4 of the entries a layer), and
    the codebooks of a layer without a flip within STEP_TOL.  Returns the
    largest abs error, the largest flipped share and whether it passed."""
    import torch
    out = {"err": 0.0, "flips": 0.0, "ok": True}

    def close(a, b):
        a, b = a.double(), b.double()
        d = (a - b).abs()
        out["err"] = max(out["err"], float(d.max()) if d.numel() else 0.0)
        out["ok"] &= bool(torch.all(
            d <= STEP_TOL["atol"] + STEP_TOL["rtol"] * b.abs()))

    close(got[3], want[3])
    for pa, pb in ((got[0], want[0]), (got[2].nu, want[2].nu)):
        for a, b in zip(pa, pb):
            for k in a:
                close(a[k], b[k])
    for sa, sb in zip(got[1], want[1]):
        flips = float((sa.assignment != sb.assignment).float().mean())
        out["flips"] = max(out["flips"], flips)
        if flips > 1e-4:
            out["ok"] = False
        elif flips == 0:
            for f in ("codewords_w", "cluster_size", "cluster_sum", "mean",
                      "var"):
                close(getattr(sa.codebook, f), getattr(sb.codebook, f))
    return out


def _require_steps(what: str, diffs: list[dict]) -> dict:
    bad = [i for i, d in enumerate(diffs) if not d["ok"]]
    rep = {"steps": len(diffs), "max_abs_err": max(d["err"] for d in diffs),
           "max_flipped_share": max(d["flips"] for d in diffs)}
    if bad:
        raise SystemExit(f"mesh {what}: steps {bad} beyond STEP_TOL "
                         f"(or more than 1e-4 of a table flipped): {diffs}")
    return rep


def phase_mesh_one_rank(m: Model) -> tuple[dict, dict]:
    """(a) A one-rank NCCL group in this process, at phase 3's full width.
    ``train_vq`` for MESH_EPOCHS epochs from seed 0 without a mesh (twice:
    the card's run-to-run spread, since ``spmm_ell_t`` and the cluster
    sums add in no fixed order and the steps amplify it), with ``mesh=``
    and with ``mesh=, shard_graph=True``: the same counted launches in
    every run, finite losses, the differences printed beside the spread.
    Then the same batches in lockstep: every step, from the state of the
    run without a mesh, through ``vq_train_epoch``,
    ``vq_train_epoch_dp`` and ``vq_train_epoch_sharded``, the two mesh
    steps held to the plain one within STEP_TOL (``_step_diff``)."""
    import tempfile
    import torch
    from repro_torch.distributed import data_parallel as dp
    from repro_torch.distributed.parity_jobs import np_params
    from repro_torch.distributed.ranks import process_group
    from repro_torch.graph.batching import epoch_slices
    from repro_torch.models.gnn import vq_train_epoch
    from repro_torch.train.gnn_trainer import train_vq
    g, cfg, batch = m.g, m.cfg, m.batch
    steps = MESH_EPOCHS * -(-g.n // batch)
    runs, counts = {}, {}
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp, process_group(
            backend, 1, 0, os.path.join(tmp, "store"), device=DEVICE,
            timeout_s=300) as mesh:
        mesh.time_collectives = True
        for name, kw in (("no mesh", {}), ("no mesh again", {}),
                         ("mesh", {"mesh": mesh}),
                         ("mesh sharded", {"mesh": mesh,
                                           "shard_graph": True})):
            mesh.collective_s, mesh.collective_calls = 0.0, 0
            reset_counts()
            t0 = time.time()
            r = train_vq(g, cfg, epochs=MESH_EPOCHS, batch_size=batch,
                         seed=SEED, eval_every=MESH_EPOCHS, device=DEVICE,
                         **kw)
            _sync(DEVICE)
            wall = time.time() - t0
            counts[name] = read_counts()
            expect_counts(f"mesh (a) {name}", counts[name],
                          _step_counts(cfg, batch, steps, g.n, 1))
            if not np.all(np.isfinite(r["step_losses"])):
                raise SystemExit(f"mesh (a) {name}: non-finite losses")
            runs[name] = {
                "wall_s": wall, "epoch_s": r["epoch_s"],
                "collective_s": mesh.collective_s,
                "collective_calls": mesh.collective_calls,
                "losses": r["step_losses"], "params": np_params(r["params"]),
                "final": r["final"]}
            log(f"mesh (a) {name}: {steps} steps of {batch} in {wall:.3f} s "
                f"(epochs {[round(v, 4) for v in r['epoch_s']]} s, "
                f"collectives {mesh.collective_calls} calls "
                f"{mesh.collective_s:.4f} s), val {r['final']['val']:.4f}")
        # lockstep over the same batches (train_vq's rng stream)
        mesh.time_collectives = False
        sstate = dp.ShardedGraphState(mesh, m.plan, m.x, m.ops.degrees,
                                      labels=m.labels,
                                      train_mask=m.train_mask)
        st, opt = _init_state(cfg, g.n, m.dev)
        rng = np.random.default_rng(SEED)
        diffs = {"mesh": [], "mesh sharded": []}
        for _ in range(MESH_EPOCHS):
            ids, sm = epoch_slices(rng.permutation(np.arange(g.n)), batch)
            ids = torch.from_numpy(ids.astype(np.int32)).to(m.dev)
            sm = torch.from_numpy(sm).to(m.dev)
            for s in range(ids.shape[0]):
                b_ids, b_sm = ids[s:s + 1], sm[s:s + 1]
                plain = vq_train_epoch(*st, m.plan, b_ids, b_sm, m.x,
                                       m.labels, m.train_mask,
                                       m.ops.degrees, cfg, opt)
                diffs["mesh"].append(_step_diff(dp.vq_train_epoch_dp(
                    mesh, *st, m.plan, b_ids, b_sm, m.x, m.labels,
                    m.train_mask, m.ops.degrees, cfg, opt), plain))
                diffs["mesh sharded"].append(_step_diff(
                    dp.vq_train_epoch_sharded(sstate, *st, b_ids, b_sm, cfg,
                                              opt), plain))
                st = plain[:3]
    ref, again = runs["no mesh"], runs["no mesh again"]
    rep = {"world_size": 1, "backend": backend, "steps": steps,
           "batch": batch, "no mesh": {"epoch_s": ref["epoch_s"],
                                       "wall_s": ref["wall_s"]},
           "run_to_run": {
               "losses_max_abs_diff": _max_abs_diff(again["losses"],
                                                    ref["losses"]),
               "params_max_abs_diff": _max_abs_diff(again["params"],
                                                    ref["params"])}}
    for name in ("mesh", "mesh sharded"):
        r = runs[name]
        if counts[name] != counts["no mesh"]:
            raise SystemExit(f"mesh (a) {name}: launches {counts[name]} "
                             f"differ from the run without a mesh")
        rep[name] = {
            "lockstep": _require_steps(f"(a) lockstep {name}",
                                       diffs[name]),
            "losses_max_abs_diff": _max_abs_diff(r["losses"],
                                                 ref["losses"]),
            "params_max_abs_diff": _max_abs_diff(r["params"],
                                                 ref["params"]),
            "epoch_s": r["epoch_s"], "wall_s": r["wall_s"],
            "collective_calls": r["collective_calls"],
            "collective_share": r["collective_s"] / sum(r["epoch_s"])}
    log(f"mesh (a): one {backend} rank, {steps} steps: launches equal to "
        f"the unsharded runs'; lockstep within STEP_TOL; free-running max "
        f"abs differences beside the card's run-to-run spread: "
        f"{json.dumps(rep)}")
    total = counts["no mesh"]
    for name in ("no mesh again", "mesh", "mesh sharded"):
        total = add_counts(total, counts[name])
    return rep, total


def _dp_step_oracle(st, plan, ids, sm, x, labels, tm, degrees, cfg, opt,
                    ndev: int):
    """One data-parallel step of ``ndev`` ranks in this process, without a
    collective or a mesh: the batch's ``ndev`` column blocks (each rank's
    share) run forward with zero probes one after the other, each lane's
    loss its masked numerator over the whole batch's denominator (not a
    rescaled local mean: the Eq. 7 injection adds a gradient that does
    not scale with the loss), one ``torch.autograd.grad`` a lane for the
    params and the probes, the param grads summed before the optimizer;
    each
    layer's ``codebook.update`` without a mesh on the lanes' rows
    concatenated in rank order (the whole batch's moments, counts and
    sums; the revival candidates in rank order), and the refresh of the
    concatenated ids.  Returns (params, vq_states, opt_state, loss [1]) as
    ``vq_train_epoch_dp`` over the one batch ``ids`` / ``sm`` [1, b]."""
    import torch
    from repro_torch.core import codebook as cbm
    from repro_torch.core.conv import LayerVQState, refresh_assignment
    from repro_torch.graph.batching import plan_batch
    from repro_torch.models.gnn import (node_loss_terms, probe_shapes,
                                        vq_forward)
    params, states, ost = st
    b_loc = ids.shape[1] // ndev
    lanes = []
    for r in range(ndev):
        bids, smask = (a[0, r * b_loc:(r + 1) * b_loc] for a in (ids, sm))
        ids64 = bids.long()
        lanes.append((plan_batch(plan, bids, smask), x[ids64],
                      labels[ids64], tm[ids64] * smask))
    den = torch.clamp(sum(lane[3].sum() for lane in lanes), min=1.0)
    loss, gsum = 0.0, None
    feats = [[] for _ in states]
    grads = [[] for _ in states]
    for pack, x_b, labels_b, lmask in lanes:
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in params]
        probes = [torch.zeros(shape, device=x_b.device, requires_grad=True)
                  for shape in probe_shapes(cfg, pack.b)]
        with torch.enable_grad():
            out, acts = vq_forward(leaves, x_b, probes, pack, states,
                                   degrees, cfg)
            num, _ = node_loss_terms(out, labels_b, cfg.multilabel, lmask)
            l_loss = num / den
            flat = [v for p in leaves for v in p.values()]
            got = torch.autograd.grad(l_loss, flat + probes,
                                      allow_unused=True)
        got = [torch.zeros_like(t) if d is None else d
               for t, d in zip(flat + probes, got)]
        it = iter(got[:len(flat)])
        g = [{k: next(it) for k in p} for p in leaves]
        loss = loss + l_loss.detach()
        gsum = g if gsum is None else [{k: a[k] + d[k] for k in a}
                                       for a, d in zip(gsum, g)]
        for l, gp in enumerate(got[len(flat):]):
            feats[l].append(acts[l].detach().float())
            grads[l].append(gp.reshape(pack.b, -1).float())
    with torch.no_grad():
        new_params, new_ost = opt.update(gsum, ost, params)
        ids_all = torch.cat([lane[0].batch_ids for lane in lanes])
        new_states = []
        for l, vq in enumerate(states):
            cb, stats = cbm.update(vq.codebook, torch.cat(feats[l]),
                                   torch.cat(grads[l]),
                                   cfg.layer_codebook_cfg())
            new_states.append(refresh_assignment(
                LayerVQState(cb, vq.assignment, vq.counts, vq.qcw), ids_all,
                stats.assignment))
    return new_params, new_states, new_ost, torch.reshape(loss, (1,))


def _mesh_rank(mesh, g, train_batch: int, infer_batch: int) -> dict:
    """(b), one rank's part: from seed 0, one epoch of
    ``vq_train_epoch_dp`` and one of ``vq_train_epoch_sharded`` in
    lockstep, a batch at a time, both steps from the data-parallel state
    (each synchronised and timed, its collectives timed; the sharded step
    held to the data-parallel one by ``_step_diff``, and the data-parallel
    step held the same way to ``_dp_step_oracle`` from the same state, run
    after the timed steps), then from the data-parallel state the
    inductive
    ``vq_infer_epoch_sharded`` and ``vq_serve_batch_sharded`` of
    MESH_SERVE_IDS ids, each part's launches counted.  Rank 0 returns the
    arrays, every rank their digests."""
    import torch
    from repro_torch.configs.vq_gnn_paper import paper_config
    from repro_torch.distributed import data_parallel as dp
    from repro_torch.distributed.parity_jobs import np_params, np_states
    from repro_torch.distributed.sharding import per_device_bytes
    from repro_torch.graph.batching import (build_epoch_plan, epoch_slices,
                                            full_operands, inference_slices)
    dev = mesh.device
    cfg = paper_config(g, full_scale=True)
    ops = full_operands(g, device=dev)
    plan = build_epoch_plan(g, full_ops=ops)
    x = torch.from_numpy(g.features).to(dev)
    labels = torch.from_numpy(g.labels).to(dev)
    tm_np = np.zeros(g.n, np.float32)
    tm_np[g.train_idx] = 1.0
    tm = torch.from_numpy(tm_np).to(dev)
    _, opt = _init_state(cfg, g.n, dev)
    ids, sm = epoch_slices(np.random.default_rng(SEED).permutation(g.n),
                           train_batch)
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    sm = torch.from_numpy(sm).to(dev)
    sstate = dp.ShardedGraphState(mesh, plan, x, ops.degrees, labels=labels,
                                  train_mask=tm)
    replicated = per_device_bytes([plan, x, ops.degrees, labels, tm])
    epochs = {
        "dp": lambda st, s: dp.vq_train_epoch_dp(
            mesh, *st, plan, ids[s:s + 1], sm[s:s + 1], x, labels, tm,
            ops.degrees, cfg, opt),
        "sharded": lambda st, s: dp.vq_train_epoch_sharded(
            sstate, *st, ids[s:s + 1], sm[s:s + 1], cfg, opt)}
    out = {"rank": mesh.rank, "diffs": [], "oracle_diffs": []}
    for name in epochs:
        out[name] = {"step_ms": [], "collective_ms": [],
                     "collective_calls": 0, "counts": None}
    losses = []
    st, _ = _init_state(cfg, g.n, dev)
    mesh.time_collectives = True
    for s in range(ids.shape[0]):
        res = {}
        for name, epoch in epochs.items():
            o = out[name]
            mesh.collective_s, mesh.collective_calls = 0.0, 0
            reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            res[name] = epoch(st, s)
            _sync(dev)
            o["step_ms"].append((time.perf_counter() - t0) * 1e3)
            o["collective_ms"].append(mesh.collective_s * 1e3)
            o["collective_calls"] += mesh.collective_calls
            c = read_counts()
            o["counts"] = c if o["counts"] is None else add_counts(
                o["counts"], c)
        out["diffs"].append(_step_diff(res["sharded"], res["dp"]))
        out["oracle_diffs"].append(_step_diff(res["dp"], _dp_step_oracle(
            st, plan, ids[s:s + 1], sm[s:s + 1], x, labels, tm, ops.degrees,
            cfg, opt, mesh.world_size)))
        losses.append(float(res["dp"][3][0]))
        st = res["dp"][:3]
    mesh.time_collectives = False
    out["losses"] = losses
    arrays = {"dp": {"params": np_params(st[0]), "states": np_states(st[1])}}
    trained = st
    params, vq = trained[0], trained[1]
    iids, ism = inference_slices(g.n, infer_batch)
    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    acts, states = dp.vq_infer_epoch_sharded(sstate, params, vq, iids, ism,
                                             cfg, inductive=True)
    _sync(dev)
    out["infer"] = {"s": time.perf_counter() - t0, "counts": read_counts()}
    arrays["infer"] = {"acts": sstate.unshard(acts),
                       "states": np_states(states)}
    bids = np.concatenate([(np.arange(MESH_SERVE_IDS - 8) * 7919) % g.n,
                           np.zeros(8, np.int64)]).astype(np.int32)
    reset_counts()
    rows = dp.vq_serve_batch_sharded(sstate, params, vq, bids, cfg)
    out["serve"] = {"counts": read_counts()}
    arrays["serve"] = {"ids": bids, "rows": rows.cpu().numpy()}
    out["bytes"] = {"sharded": sstate.per_device_bytes(),
                    "replicated": replicated}
    out["digests"] = {k: _digest(v) for k, v in arrays.items()}
    if mesh.rank == 0:
        out["arrays"] = arrays
    return out


def phase_mesh_ranks(g, infer_batch: int, ranks: int = MESH_RANKS,
                     backend: str = "gloo") -> tuple[dict, dict]:
    """(b) ``ranks`` ranks sharing the one card over gloo
    (``share_device=True``; on NCCL, ``tools/mesh_cards.py``, a card a
    rank): the data-parallel epoch and the row-sharded
    one at batch MESH_BATCH from seed 0, in lockstep (each sharded step
    within STEP_TOL of the data-parallel step from the same state: the
    card's steps are not bit-reproducible, phase (a)), each data-parallel
    step within STEP_TOL of the one-process oracle ``_dp_step_oracle``
    from the same state, on every rank, the inductive
    sharded inference at ``infer_batch``
    and the sharded serving of MESH_SERVE_IDS ids equal to the unsharded
    executors run here from the data-parallel state (the unsharded
    inference twice first: if two runs differ, both are held to
    STEP_TOL), every rank's results the same, launches counted exactly,
    per-rank graph state at most 1.2/ranks of the replicated bytes
    (0.6x at two)."""
    import torch
    from repro_torch import convert
    from repro_torch.configs.vq_gnn_paper import paper_config
    from repro_torch.distributed.parity_jobs import np_states
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.graph.batching import (build_epoch_plan, full_operands,
                                            inference_slices)
    from repro_torch.models.gnn import vq_infer_epoch, vq_serve_batch
    from repro_torch.distributed.parity_jobs import state_namespace
    cfg = paper_config(g, full_scale=True)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    share = backend == "gloo" and DEVICE == "cuda"
    outs = run_ranks(_mesh_rank, ranks, backend, DEVICE, g, MESH_BATCH,
                     infer_batch, share_device=share, timeout_s=600,
                     threads=2)
    wall = time.time() - t0
    for o in outs[1:]:
        if o["digests"] != outs[0]["digests"]:
            raise SystemExit(f"mesh (b): rank {o['rank']}'s results differ "
                             f"from rank 0's: {o['digests']} vs "
                             f"{outs[0]['digests']}")
    arr = outs[0]["arrays"]
    n_layers = cfg.n_layers
    b_loc = MESH_BATCH // ranks
    steps = -(-g.n // MESH_BATCH)
    s_loc = -(-(-(-g.n // infer_batch)) // ranks)
    total = None
    for o in outs:
        for name in ("dp", "sharded"):
            expect_counts(f"mesh (b) rank {o['rank']} {name}",
                          o[name]["counts"],
                          _step_counts(cfg, b_loc, steps, g.n, 0))
        expect_counts(f"mesh (b) rank {o['rank']} inference",
                      o["infer"]["counts"],
                      {"vq_assign": n_layers, "spmm_ell": n_layers * s_loc,
                       "context_ell": n_layers * s_loc})
        expect_counts(f"mesh (b) rank {o['rank']} serve",
                      o["serve"]["counts"],
                      {"spmm_ell": n_layers, "context_ell": n_layers})
        for c in (o["dp"]["counts"], o["sharded"]["counts"],
                  o["infer"]["counts"], o["serve"]["counts"]):
            total = c if total is None else add_counts(total, c)
    lockstep = {o["rank"]: _require_steps(
        f"(b) rank {o['rank']} lockstep sharded vs dp", o["diffs"])
        for o in outs}
    oracle = {o["rank"]: _require_steps(
        f"(b) rank {o['rank']} dp vs the one-process oracle",
        o["oracle_diffs"]) for o in outs}
    # the unsharded executors here, from rank 0's data-parallel state
    dev = torch.device(DEVICE)
    params = convert.params_from_numpy(arr["dp"]["params"], dev)
    vq = convert.vq_states_from_numpy(
        [state_namespace({f: d[f] for f in d
                          if f not in ("assignment", "counts")},
                         d["assignment"], d["counts"])
         for d in arr["dp"]["states"]], dev)
    ops = full_operands(g, device=dev)
    plan = build_epoch_plan(g, full_ops=ops)
    x = torch.from_numpy(g.features).to(dev)
    iids, ism = inference_slices(g.n, infer_batch)
    runs = []
    for _ in range(2):
        acts, states = vq_infer_epoch(
            params, vq, plan, torch.from_numpy(iids.astype(np.int32)).to(dev),
            torch.from_numpy(ism).to(dev), x, ops.degrees, cfg,
            inductive=True)
        runs.append({"acts": acts.cpu().numpy(),
                     "states": np_states(states)})
    stable = _digest(runs[0]) == _digest(runs[1])
    tol = None if stable else STEP_TOL
    if not stable:
        log(f"mesh (b): the unsharded inference is not bit-stable from run "
            f"to run (max abs diff {_max_abs_diff(runs[1], runs[0]):.3g}); "
            f"the sharded inference is held to STEP_TOL")
    infer_err = _mesh_close("(b) sharded vs unsharded inference",
                            arr["infer"], runs[0], tol)
    rows = vq_serve_batch(params, vq, plan,
                          torch.from_numpy(arr["serve"]["ids"]).to(dev), x,
                          ops.degrees, cfg).cpu().numpy()
    serve_err = _mesh_close("(b) sharded vs unsharded serving",
                            arr["serve"]["rows"], rows, tol)
    b = outs[0]["bytes"]
    ratio = b["sharded"] / b["replicated"]
    if ratio > 1.2 / ranks:
        raise SystemExit(f"mesh (b): per-rank graph state {b['sharded']} B "
                         f"is {ratio:.3f}x the replicated {b['replicated']} "
                         f"B (cap {1.2 / ranks:.2f}x)")
    rep = {"world_size": ranks, "backend": backend,
           "share_device": share, "batch": MESH_BATCH,
           "steps": steps,
           "infer_batch": infer_batch, "wall_s": wall,
           "sharded_vs_dp_lockstep": lockstep,
           "dp_vs_one_process_oracle": oracle,
           "dp_losses": outs[0]["losses"],
           "unsharded_inference_bit_stable": stable,
           "inference_max_abs_err": infer_err,
           "serve_max_abs_err": serve_err,
           "graph_state_bytes": b, "graph_state_ratio": ratio,
           "ranks": []}
    for o in outs:
        r = {"rank": o["rank"], "infer_s": o["infer"]["s"]}
        for name in ("dp", "sharded"):
            ms, cms = o[name]["step_ms"], o[name]["collective_ms"]
            # the first step absorbs the ranks' start-up skew (and NCCL's
            # set-up) in its first collective: the share is the later ones'
            r[name] = {"epoch_s": sum(ms) / 1e3,
                       "step_p50_ms": float(np.percentile(ms, 50)),
                       "step_ms": ms, "collective_ms": cms,
                       "collective_calls": o[name]["collective_calls"],
                       "collective_share": sum(cms[1:]) / sum(ms[1:]),
                       "launches": {k: v for k, v in o[name][
                           "counts"].items() if k not in KEYED and v}}
            log(f"mesh (b) rank {o['rank']} {name}: epoch "
                f"{r[name]['epoch_s']:.4f} s, step p50 "
                f"{r[name]['step_p50_ms']:.3f} ms, collectives "
                f"{r[name]['collective_calls']} calls, "
                f"{r[name]['collective_share']:.3f} of the step time after "
                f"the first, "
                f"launches {r[name]['launches']}")
        rep["ranks"].append(r)
    log(f"mesh (b): {ranks} ranks on {DEVICE} over {backend} "
        f"(share_device={share}), batch {MESH_BATCH} ({b_loc} "
        f"a rank): "
        f"sharded vs data-parallel in lockstep {json.dumps(lockstep)}; "
        f"data-parallel vs the one-process oracle {json.dumps(oracle)}; "
        f"unsharded inference bit-stable {stable}; sharded "
        f"inference vs unsharded {infer_err:.3g}, serving {serve_err:.3g}; "
        f"graph state {b['sharded']} / {b['replicated']} B a rank "
        f"({ratio:.3f}x); {wall:.2f} s with the spawn")
    return rep, total


def phase_mesh_serve() -> dict:
    """(c) ``serve_gnn --mesh 2 --shard-graph --share-device`` at the full
    width against ``serve_gnn --mesh 1`` (one NCCL rank), micro-batch
    MESH_SERVE_BATCH: 200 requests,
    the served rows' digests equal, the per-rank graph state at most 0.6x
    the one rank's."""
    from repro_torch.launch import serve_gnn
    base = ["--n", str(N_NODES), "--hidden", "128", "--layers", "3",
            "--k", "1024", "--batch", str(MESH_SERVE_BATCH), "--requests",
            str(REQUESTS), "--max-request", str(MAX_REQUEST), "--seed",
            str(SEED), "--device", DEVICE]
    reps = {}
    for name, extra in (("mesh 1", ["--mesh", "1"]),
                        ("mesh 2 sharded", ["--mesh", str(MESH_RANKS),
                                            "--shard-graph"]
                         + (["--share-device"] if DEVICE == "cuda"
                            else []))):
        t0 = time.time()
        reps[name] = serve_gnn.main(base + extra)
        reps[name]["wall_s"] = time.time() - t0
    one, two = reps["mesh 1"], reps["mesh 2 sharded"]
    if one["rows_sha256"] != two["rows_sha256"]:
        raise SystemExit(f"mesh (c): --mesh {MESH_RANKS} --shard-graph "
                         f"served other rows than --mesh 1")
    ratio = two["graph_state_bytes_per_device"] \
        / one["graph_state_bytes_per_device"]
    if ratio > 0.6:
        raise SystemExit(f"mesh (c): graph state a rank {ratio:.3f}x")
    keep = ("refresh_s", "warmup_s", "nodes", "steps", "step_p50_ms",
            "step_p99_ms", "nodes_per_s", "graph_state_bytes_per_device",
            "rows_sha256", "wall_s")
    rep = {k: {f: r[f] for f in keep} for k, r in reps.items()}
    log(f"mesh (c): serve_gnn --mesh {MESH_RANKS} --shard-graph "
        f"--share-device served the rows of --mesh 1 (sha256 "
        f"{one['rows_sha256'][:16]}...), graph state {ratio:.3f}x a rank: "
        f"{json.dumps(rep)}")
    return rep


# ---------------------------------------------------------------------------
# LM training and prefill
# ---------------------------------------------------------------------------

def _lm_train_cfg(vq: bool, arch: str = LM_ARCH):
    """The train launcher's configuration of ``arch`` at full width (bf16,
    remat on), VQ-Attention at the config defaults (k 1024, W 512) when
    ``vq``."""
    from repro_torch.launch import train as tlaunch
    args = tlaunch.parser().parse_args([
        "--arch", arch, "--batch", str(LM_TRAIN_BATCH), "--seq",
        str(LM_TRAIN_SEQ)])
    cfg = tlaunch.config(args)
    return cfg.with_vq() if vq else cfg


def _lm_batches(cfg, batch: int, seq: int, steps: int) -> list:
    """The port's token stream, seed SEED: ``steps`` batches of [batch,
    seq + 1] on the host."""
    import torch
    from repro_torch.data.tokens import TokenStreamConfig, batch_shard
    ds = TokenStreamConfig(vocab=cfg.vocab, seq_len=seq + 1,
                           global_batch=batch, seed=SEED)
    return [torch.from_numpy(batch_shard(ds, s, 0, 1)) for s in range(steps)]


def _lm_model_flops(cfg, tokens: int, n_matmul: int) -> float:
    """Model FLOPs of one training step (PaLM's count, remat not counted):
    6 N T for the N matmul parameters (every weight but the embedding
    table and the norms), plus 12 L Hq dh C T for the attention's two
    products, C the keys a query scores: S for exact attention, k + 2W
    for VQ-Attention."""
    ctx = (cfg.vq_k + 2 * cfg.vq_window) if cfg.vq_attn else LM_TRAIN_SEQ
    return 6.0 * n_matmul * tokens \
        + 12.0 * cfg.n_layers * cfg.n_heads * cfg.hd * ctx * tokens


def _live_codewords(params, cfg, tokens) -> list:
    """Live codewords per (batch, kv head) that layer 0's VQ-Attention
    ends a sequence with: ``vq_attention_train``'s codebook masses on
    ``tokens`` under ``params``."""
    import torch
    from repro_torch.models import lm
    from repro_torch.nn.attention import qkv
    from repro_torch.nn.layers import rmsnorm
    from repro_torch.nn.vq_attention import VQAttnConfig, train_blocks
    with torch.no_grad():
        bp = lm.per_layer(params["blocks"])[0]
        x = lm.embed_lookup(params["embed"], tokens, cfg.vocab)
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
        q, k, v = qkv(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                      cfg.n_heads, cfg.n_kv_heads, cfg.hd, pos,
                      qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
        _, count = train_blocks(q, k, v, VQAttnConfig(cfg.vq_k,
                                                      cfg.vq_window))
    return (count > 0).sum(-1).flatten().tolist()


def _lm_state_bytes(state) -> int:
    return _tree_bytes((state.params, state.opt.mu, state.opt.nu))[1]


def phase_lm_checkpoint_full(state) -> dict:
    """The full training state through the port's ``checkpoint.save``
    (streamed a leaf at a time) and ``restore`` into a fresh state of
    expanded 0-d leaves (no memory of their own), every leaf equal."""
    import shutil
    import tempfile

    import torch
    from repro_torch.train import checkpoint as tckpt
    from repro_torch.train.optimizer import tree_map
    n_bytes = sum(t.numel() * (4 if t.dtype == torch.bfloat16
                               else t.element_size())
                  for _, t in tckpt._paths(state))
    root = tempfile.mkdtemp(prefix="lm_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        log(f"lm-checkpoint: {n_bytes} bytes to write under {root} "
            f"({free} bytes free)")
        if free < 1.1 * n_bytes:
            raise SystemExit(f"lm-checkpoint: {free} bytes free under "
                             f"{root}, the checkpoint needs {n_bytes}")
        torch.cuda.synchronize()
        t0 = time.time()
        tckpt.save(root, int(state.step), state, {"seed": SEED})
        save_s = time.time() - t0
        fresh = tree_map(lambda t: torch.zeros(
            (), dtype=t.dtype, device=t.device).expand(t.shape), state)
        t0 = time.time()
        got, manifest = tckpt.restore(root, fresh)
        torch.cuda.synchronize()
        restore_s = time.time() - t0
        if manifest["step"] != int(state.step):
            raise SystemExit(f"lm-checkpoint: manifest {manifest}")
        want = dict(tckpt._paths(state))
        for key, leaf in tckpt._paths(got):
            w = want[key]
            if leaf.dtype != w.dtype or leaf.device != w.device \
                    or not torch.equal(leaf, w):
                raise SystemExit(f"lm-checkpoint: {key} not restored equal")
        del got
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rep = {"step": int(state.step), "file_bytes": n_bytes,
           "leaves": len(want), "save_s": save_s, "restore_s": restore_s}
    log(f"lm-checkpoint: step {rep['step']}, {len(want)} leaves, "
        f"{n_bytes} bytes saved in {save_s:.2f} s, restored equal in "
        f"{restore_s:.2f} s")
    return rep


def phase_lm_train() -> tuple[dict, dict]:
    """llama3.2-3b at full width and LM_TRAIN_LAYERS layers through
    ``make_train_step`` with the launcher's optimizer: LM_TRAIN_VQ_STEPS
    VQ-Attention steps (the full state checkpointed and restored after
    step LM_CKPT_STEP), a profile of 2 more, then LM_TRAIN_EXACT_STEPS
    exact steps from the same initial weights; no hand-written kernel
    launched.  Returns the report and the checkpoint's."""
    import dataclasses

    import torch
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import lm
    from repro_torch.train.loop import TrainState
    from repro_torch.train.optimizer import tree_leaves
    cfg_vq, cfg_x = (dataclasses.replace(_lm_train_cfg(vq),
                                         n_layers=LM_TRAIN_LAYERS)
                     for vq in (True, False))
    t0 = time.time()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = lm.init_lm(cfg_x, gen, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    blocks = params["blocks"]
    n_matmul = params["head"].numel() + sum(
        t.numel() for t in (*blocks["attn"][:4], *blocks["mlp"]))
    del params, blocks
    steps_max = max(LM_TRAIN_VQ_STEPS + 2, LM_TRAIN_EXACT_STEPS)
    batches = _lm_batches(cfg_x, LM_TRAIN_BATCH, LM_TRAIN_SEQ, steps_max)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    rep = {"arch": cfg_x.name, "layers": LM_TRAIN_LAYERS,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "params": n_params, "matmul_params": n_matmul, "init_s": init_s,
           "lr": LM_TRAIN_LR, "moment_dtype": "bfloat16"}
    ckpt_rep = None

    def run(cfg, steps, tag):
        """``steps`` steps from the seed's weights (drawn again for each
        run: the generator gives the same weights every time)."""
        nonlocal ckpt_rep
        opt = tlaunch.optimizer(LM_TRAIN_LR, steps)
        step_fn = tlaunch.make_step(cfg, opt, 1)
        params = lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(
            SEED), device=DEVICE)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device=DEVICE))
        losses, gnorms, ms = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        del params
        for s in range(steps):
            tok = batches[s].to(DEVICE)
            t = time.perf_counter()
            state, m = step_fn(state, tok)
            losses.append(float(m["loss"]))           # host clock to the loss
            ms.append((time.perf_counter() - t) * 1e3)
            gnorms.append(float(m["grad_norm"]))
            log(f"lm-train {tag} step {s + 1}: loss {losses[-1]:.5f} grad "
                f"norm {gnorms[-1]:.5f} {ms[-1]:.1f} ms")
            if tag == "vq" and s + 1 == LM_CKPT_STEP:
                ckpt_rep = phase_lm_checkpoint_full(state)
        counts = read_counts()
        expect_counts(f"lm-train {tag}", counts, {})
        peak = torch.cuda.max_memory_allocated()
        if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(gnorms))):
            raise SystemExit(f"lm-train {tag}: non-finite loss or gradient "
                             f"norm: {losses} {gnorms}")
        warm = np.asarray(ms[1:])          # the first step allocates
        mf = _lm_model_flops(cfg, tokens, n_matmul)
        p50 = float(np.percentile(warm, 50))
        out = {"steps": steps, "losses": losses, "grad_norms": gnorms,
               "step_ms": ms, "step_p50_ms": p50,
               "step_p99_ms": float(np.percentile(warm, 99)),
               "tok_per_s": tokens / (p50 / 1e3),
               "max_memory_allocated": int(peak),
               "state_bytes": _lm_state_bytes(state),
               "model_flops": mf,
               "model_flops_share_bf16_peak": mf / (p50 / 1e3)
               / BF16_FLOP_PER_S}
        log(f"lm-train {tag}: {steps} steps, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, step p50 {p50:.1f} ms p99 "
            f"{out['step_p99_ms']:.1f} ms, {out['tok_per_s']:.1f} tok/s, "
            f"peak {peak} bytes, model-FLOPs share "
            f"{out['model_flops_share_bf16_peak']:.4f} of the bf16 peak")
        return state, step_fn, out

    state, step_fn, rep["vq"] = run(cfg_vq, LM_TRAIN_VQ_STEPS, "vq")
    losses = rep["vq"]["losses"]
    if not np.mean(losses[-5:]) < losses[0]:
        raise SystemExit(f"lm-train vq: the last 5 losses' mean "
                         f"{np.mean(losses[-5:])} is not under the first "
                         f"step's {losses[0]}")
    live = _live_codewords(state.params, cfg_vq, batches[0].to(DEVICE)[:, :-1])
    rep["vq"]["live_codewords_layer0"] = sorted(set(live))
    log(f"lm-train vq: layer 0's live codewords per (batch, kv head) "
        f"{sorted(set(live))} of k {cfg_vq.vq_k} (W {cfg_vq.vq_window})")
    holder = [state]

    def prof_step(s):
        holder[0] = step_fn(holder[0], batches[LM_TRAIN_VQ_STEPS + s].to(
            DEVICE))[0]
    t0 = time.time()
    rep["vq"]["profile"] = _profile("lm-train vq step", [0, 1], prof_step,
                                    LM_KERNEL_GROUPS, cpu=False)
    rep["vq"]["profile"]["seconds"] = time.time() - t0
    del state, holder, step_fn
    torch.cuda.empty_cache()
    _, _, rep["exact"] = run(cfg_x, LM_TRAIN_EXACT_STEPS, "exact")
    torch.cuda.empty_cache()
    return rep, ckpt_rep


def phase_lm_prefill() -> dict:
    """``lm.prefill`` at full width under no_grad, VQ and exact, batch
    LM_TRAIN_BATCH x LM_TRAIN_SEQ: finite [B, vocab] logits, ms a call."""
    import torch
    from repro_torch.models import lm
    cfg_x = _lm_train_cfg(False)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = lm.init_lm(cfg_x, gen, device=DEVICE)
    tok = _lm_batches(cfg_x, LM_TRAIN_BATCH, LM_TRAIN_SEQ, 1)[0][:, :-1].to(
        DEVICE)
    rep = {}
    reset_counts()
    for tag, cfg in (("vq", _lm_train_cfg(True)), ("exact", cfg_x)):
        ms = []
        with torch.no_grad():
            for _ in range(LM_PREFILL_REPS + 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits = lm.prefill(params, tok, cfg)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
        if tuple(logits.shape) != (LM_TRAIN_BATCH, cfg.vocab) \
                or not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"lm-prefill {tag}: logits "
                             f"{tuple(logits.shape)} not finite or of the "
                             f"wrong shape")
        p50 = float(np.median(ms[1:]))
        rep[tag] = {"ms": ms[1:], "ms_p50": p50, "first_ms": ms[0],
                    "tok_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / (p50 / 1e3)}
        log(f"lm-prefill {tag}: [{LM_TRAIN_BATCH}, {LM_TRAIN_SEQ}] in "
            f"{p50:.2f} ms ({rep[tag]['tok_per_s']:.1f} tok/s)")
    expect_counts("lm-prefill", read_counts(), {})
    del params
    torch.cuda.empty_cache()
    return rep


def _tree_close(what: str, got, want, rtol: float, atol: float) -> float:
    """Every leaf of ``got`` (card) within ``atol + rtol |want|`` of
    ``want`` (CPU), compared on the card; returns the largest abs error."""
    import torch
    from repro_torch.train import checkpoint as tckpt
    want_d = dict(tckpt._paths(want))
    worst = 0.0
    for key, g in tckpt._paths(got):
        w = want_d[key].to(g.device).float()
        g = g.float()
        if not bool(torch.isfinite(g).all()):
            raise SystemExit(f"{what} {key}: non-finite values")
        err = (g - w).abs()
        bad = err > atol + rtol * w.abs()
        if bool(bad.any()):
            raise SystemExit(f"{what} {key}: {int(bad.sum())} elements beyond "
                             f"rtol {rtol} atol {atol} (max abs err "
                             f"{float(err.max())})")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def phase_lm_train_parity() -> dict:
    """2 layers at full width in f32, TF32 off, the weights copied to the
    CPU: loss and gradients from the same state, then
    LM_TRAIN_PARITY_STEPS steps of ``make_train_step`` (VQ-Attention k 64,
    W 64; the launcher's optimizer) carried on each device, and one exact
    step; card vs CPU."""
    import dataclasses

    import torch
    from repro_torch import convert
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import lm
    from repro_torch.train.loop import TrainState, loss_and_grads
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit("lm-train-parity: TF32 is on")
    base = dataclasses.replace(_lm_train_cfg(False),
                               n_layers=LM_TRAIN_PARITY_LAYERS,
                               dtype="float32")
    cfg = base.with_vq(k=LM_TRAIN_PARITY_K, window=LM_TRAIN_PARITY_W)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    params = lm.init_lm(cfg, gen, device=DEVICE)
    batches = _lm_batches(cfg, LM_TRAIN_PARITY_BATCH, LM_TRAIN_PARITY_SEQ,
                          LM_TRAIN_PARITY_STEPS)
    steps = LM_TRAIN_PARITY_STEPS
    opt = tlaunch.optimizer(LM_TRAIN_LR, steps)
    states = [TrainState(p, opt.init(p), torch.zeros(
        (), dtype=torch.int32, device=p["embed"].device))
        for p in (params, convert.to_device(params, "cpu"))]
    t_card = t_cpu = 0.0
    rep = {"layers": cfg.n_layers, "batch": LM_TRAIN_PARITY_BATCH,
           "seq": LM_TRAIN_PARITY_SEQ, "k": cfg.vq_k, "window": cfg.vq_window,
           "cpu_s_by_call": []}

    def both(fn, *args_by_dev):
        nonlocal t_card, t_cpu
        t = time.time()
        a = fn(*args_by_dev[0])
        torch.cuda.synchronize()
        t_card += time.time() - t
        t = time.time()
        b = fn(*args_by_dev[1])
        t_cpu += time.time() - t
        rep["cpu_s_by_call"].append(time.time() - t)
        return a, b

    (lc, gc), (lh, gh) = both(
        lambda st, tk: loss_and_grads(st.params, tk, cfg),
        (states[0], batches[0].to(DEVICE)), (states[1], batches[0]))
    rep["loss_err"] = check_close("lm-train-parity loss", lc.reshape(1),
                                  lh.reshape(1), LM_TRAIN_TOL)
    rep["grad_err"] = _tree_close("lm-train-parity grad", gc, gh,
                                  **LM_TRAIN_TOL)
    del gc, gh
    step_fn = tlaunch.make_step(cfg, opt, 1)
    lr_sum, rep["steps"] = 0.0, []
    for s in range(steps):
        (states[0], mc), (states[1], mh) = both(
            step_fn, (states[0], batches[s].to(DEVICE)),
            (states[1], batches[s]))
        lr_sum += _lm_lr_t(s + 1, steps)
        row = {"loss": [float(mc["loss"]), float(mh["loss"])],
               "grad_norm": [float(mc["grad_norm"]), float(mh["grad_norm"])]}
        for k_ in ("loss", "grad_norm"):
            check_close(f"lm-train-parity step {s + 1} {k_}",
                        mc[k_].reshape(1), mh[k_].reshape(1), LM_TRAIN_TOL)
        # params: Adam moves an element by lr_t m / (sqrt(v) + eps), about
        # lr_t sign(g) early on, so a gradient within rounding of 0 whose
        # sign differs between the devices moves it 2 lr_t apart
        row["param_err"] = _tree_close(
            f"lm-train-parity step {s + 1} params", states[0].params,
            states[1].params, rtol=1e-5, atol=2.0 * lr_sum + 1e-6)
        # moments in bf16: one bf16 ulp (2^-7 relative at most) from f32
        # moments that agree to LM_TRAIN_TOL
        row["moment_err"] = max(
            _tree_close(f"lm-train-parity step {s + 1} {n}",
                        getattr(states[0].opt, n), getattr(states[1].opt, n),
                        rtol=2.0 ** -7, atol=at)
            for n, at in (("mu", 1e-6), ("nu", 1e-10)))
        rep["steps"].append(row)
        log(f"lm-train-parity step {s + 1}: loss {row['loss']}, grad norm "
            f"{row['grad_norm']}, params max abs err {row['param_err']:.3g}, "
            f"moments {row['moment_err']:.3g}")
    # one exact-attention step from the initial weights
    fresh = [TrainState(p, opt.init(p), torch.zeros(
        (), dtype=torch.int32, device=p["embed"].device))
        for p in (params, convert.to_device(params, "cpu"))]
    xstep = tlaunch.make_step(base, opt, 1)
    (_, mc), (_, mh) = both(xstep, (fresh[0], batches[0].to(DEVICE)),
                            (fresh[1], batches[0]))
    rep["exact_loss"] = [float(mc["loss"]), float(mh["loss"])]
    check_close("lm-train-parity exact loss", mc["loss"].reshape(1),
                mh["loss"].reshape(1), LM_TRAIN_TOL)
    check_close("lm-train-parity exact grad norm", mc["grad_norm"].reshape(1),
                mh["grad_norm"].reshape(1), LM_TRAIN_TOL)
    rep.update(card_s=t_card, cpu_s=t_cpu)
    log(f"lm-train-parity: {cfg.name} at {cfg.n_layers} layers f32, loss and "
        f"gradients within rtol 1e-4 atol 1e-5, {steps} VQ steps and one "
        f"exact step agree; card {t_card:.2f} s, CPU {t_cpu:.2f} s")
    del states, fresh, params
    torch.cuda.empty_cache()
    return rep


def _lm_lr_t(step: int, total: int) -> float:
    """The launcher's Adam step size at ``step``: warmup_cosine(lr, 10,
    total)(step) * sqrt(1 - b2^t) / (1 - b1^t)."""
    import torch
    from repro_torch.train.optimizer import warmup_cosine
    lr = float(warmup_cosine(LM_TRAIN_LR, 10, total)(torch.tensor(step)))
    return lr * math.sqrt(1 - 0.999 ** step) / (1 - 0.9 ** step)


def phase_lm_drill() -> dict:
    """``train``'s failure drill on the card: 2 layers of the example's
    ``100m`` preset (d 768, vocab 32,768: a checkpoint of 0.8 GB), a
    failure before step 5 between the checkpoints of steps 4 and 6; the
    same step count as an undisturbed run, its losses from the restored
    step on within LM_TRAIN_TOL."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.examples.train_lm import PRESETS
    from repro_torch.train.loop import train
    cfg = dataclasses.replace(PRESETS["100m"], n_layers=2)
    kw = dict(steps=LM_DRILL_STEPS, batch=4, seq_len=256, ckpt_every=2,
              log_every=1, device=DEVICE)
    root = tempfile.mkdtemp(prefix="lm_drill_")
    try:
        t0 = time.time()
        clean = train(cfg, ckpt_dir=os.path.join(root, "a"), **kw)["history"]
        drill = train(cfg, ckpt_dir=os.path.join(root, "b"),
                      inject_failure_at=LM_DRILL_AT, **kw)["history"]
        dt = time.time() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = {h["step"]: h["loss"] for h in clean}
    steps = [h["step"] for h in drill]
    if max(steps) != LM_DRILL_STEPS or steps.count(LM_DRILL_AT) != 2:
        raise SystemExit(f"lm-checkpoint drill: logged steps {steps}")
    got = np.asarray([h["loss"] for h in drill])
    ref = np.asarray([want[s] for s in steps])
    if not np.allclose(got, ref, **LM_TRAIN_TOL):
        raise SystemExit(f"lm-checkpoint drill: losses {got.tolist()} vs "
                         f"the undisturbed run's {ref.tolist()}")
    rep = {"steps": steps, "losses": got.tolist(),
           "max_abs_err": float(np.abs(got - ref).max()), "seconds": dt}
    log(f"lm-checkpoint drill: {cfg.name} at 2 layers, failure at step "
        f"{LM_DRILL_AT} restored from step {LM_DRILL_AT - 1}, logged steps "
        f"{steps}, losses within rtol 1e-4 atol 1e-5 of the undisturbed "
        f"run (max abs err {rep['max_abs_err']:.3g}) in {dt:.2f} s")
    return rep


# ---------------------------------------------------------------------------
# the moe, ssm and hybrid LM families: their MoE dispatch, xLSTM cells and
# Mamba2 scan are plain PyTorch (plain XLA in the reference, no Pallas
# kernel); their attention decodes through vq_attention under VQ
# ---------------------------------------------------------------------------

def _attn_layers(cfg) -> int:
    """Attention layers a decode step runs: every layer of the moe
    family, one a group in the hybrid (its shared block), none in the
    ssm."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period
    return cfg.n_layers


def _attn_cache(cfg, cache):
    return cache["attn" if cfg.family == "hybrid" else "kv"]


def _tree_bytes(tree) -> tuple[int, int]:
    """(elements, bytes) of a tree's tensors."""
    from repro_torch.train.optimizer import tree_leaves
    leaves = tree_leaves(tree)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def _family_init(cfg, seed: int = SEED):
    import torch
    from repro_torch.models import lm
    torch.cuda.synchronize()
    t0 = time.time()
    params = lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                        device=DEVICE)
    torch.cuda.synchronize()
    n, byt = _tree_bytes(params)
    log(f"{cfg.name} init: {cfg.n_layers} layers, {n} parameters ({byt} "
        f"bytes, param_count {cfg.param_count()}) in {time.time() - t0:.2f}"
        f" s")
    return params, {"layers": cfg.n_layers, "params": n, "param_bytes": byt,
                    "init_s": time.time() - t0}


def _family_decode(params, cfg, tokens: int, tag: str
                   ) -> tuple[dict, dict, object]:
    """``launch/serve.decode``: a warm-up step and ``tokens`` greedy steps
    at batch LM_BATCH; finite logits; ``vq_attention`` launched once an
    attention layer and step under VQ and never else; under VQ every
    head's codebook mass equals its evictions.  Returns the report (with
    the peak memory), the counts and the cache."""
    import torch
    from repro_torch.launch import serve as lm_serve
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits, cache, rep = lm_serve.decode(
        params, cfg, batch=LM_BATCH, context=LM_CONTEXT, tokens=tokens,
        device=DEVICE)
    torch.cuda.synchronize()
    counts = read_counts()
    steps = tokens + 1
    n_attn = _attn_layers(cfg)
    expect_counts(tag, counts, {"vq_attention": n_attn * steps
                                if cfg.vq_attn else 0})
    if tuple(logits.shape) != (LM_BATCH, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{tag}: logits {tuple(logits.shape)} not finite "
                         f"or of the wrong shape")
    rep["max_memory_allocated"] = int(torch.cuda.max_memory_allocated())
    rep["vq_attention_launches"] = counts["vq_attention"]
    if cfg.vq_attn and n_attn:
        kv = _attn_cache(cfg, cache)
        evictions = steps - cfg.vq_window
        mass = kv.count.sum(-1)
        if not bool((mass == evictions).all()) or int(kv.pos[0]) != steps:
            raise SystemExit(f"{tag}: codebook mass {mass.unique()} (want "
                             f"{evictions} per head), pos {kv.pos[0]}")
        rep.update(evictions=evictions,
                   live_codewords_max=int((kv.count > 0).sum(-1).max()))
    log(f"{tag}: {steps} steps, {rep['tok_per_s']:.1f} tok/s, step p50 "
        f"{rep['step_p50_ms']:.3f} ms p99 {rep['step_p99_ms']:.3f} ms, cache "
        f"{rep['cache_bytes']} bytes, peak {rep['max_memory_allocated']} "
        f"bytes, vq_attention {counts['vq_attention']}")
    return rep, counts, cache


def _family_prefill(params, cfg, tag: str, batch: int = LM_TRAIN_BATCH,
                    seq: int = LM_TRAIN_SEQ, aux=None) -> dict:
    """``lm.prefill`` of [batch, seq] tokens (with the cross-attention
    families' stub context ``aux``) under no_grad, once: finite [B,
    vocab] logits, no counted kernel."""
    import torch
    from repro_torch.models import lm
    tok = _lm_batches(cfg, batch, seq, 1)[0][:, :-1].to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = lm.prefill(params, tok, cfg, aux)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    expect_counts(tag, read_counts(), {})
    if tuple(logits.shape) != (batch, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{tag}: logits {tuple(logits.shape)} not finite "
                         f"or of the wrong shape")
    rep = {"batch": batch, "seq": seq, "ms": ms,
           "tok_per_s": batch * seq / (ms / 1e3),
           "max_memory_allocated": int(torch.cuda.max_memory_allocated())}
    ctx = ""
    if aux is not None:
        rep["context"] = list(aux.shape)
        ctx = f" over a context of {rep['context']}"
    log(f"{tag}: [{batch}, {seq}]{ctx} in {ms:.2f} ms (one call; "
        f"{rep['tok_per_s']:.1f} tok/s), peak "
        f"{rep['max_memory_allocated']} bytes")
    return rep


def _family_train(arch: str, batch: int, seq: int, steps: int, tag: str,
                  cfg=None, **replace) -> dict:
    """``steps`` steps of the train launcher's ``make_step`` with its
    optimizer (Adam, bf16 moments, ``clip_norm=1.0``) on the token
    stream, from random weights of seed SEED: finite losses and gradient
    norms, no counted kernel; step ms (host clock to the loss), tok/s,
    peak memory.  ``cfg`` (default: the launcher's configuration of
    ``arch``) with ``replace``; a cross-attention family's step takes
    ``aux_embeds`` [batch, context, d] in the model dtype, drawn for each
    step from a generator seeded SEED + 7 on the card."""
    import dataclasses

    import torch
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import lm
    from repro_torch.train.loop import TrainState
    cfg = dataclasses.replace(cfg or _lm_train_cfg(False, arch), **replace)
    aux_gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    opt = tlaunch.optimizer(LM_TRAIN_LR, steps)
    step_fn = tlaunch.make_step(cfg, opt, 1)
    batches = _lm_batches(cfg, batch, seq, steps)
    params = lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                        device=DEVICE)
    n_params = _tree_bytes(params)[0]
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=DEVICE))
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, gnorms, ms = [], [], []
    for s in range(steps):
        tok = batches[s].to(DEVICE)
        aux = _stub_context(cfg, batch, aux_gen) \
            if cfg.family in lm.CROSS_FAMILIES else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, tok, aux)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        log(f"{tag} step {s + 1}: loss {losses[-1]:.5f} grad norm "
            f"{gnorms[-1]:.5f} {ms[-1]:.1f} ms")
    expect_counts(tag, read_counts(), {})
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(gnorms))):
        raise SystemExit(f"{tag}: non-finite loss or gradient norm: "
                         f"{losses} {gnorms}")
    p50 = float(np.median(ms[1:]))
    rep = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch,
           "seq": seq, "params": n_params, "losses": losses,
           "grad_norms": gnorms, "step_ms": ms, "step_p50_ms": p50,
           "tok_per_s": batch * seq / (p50 / 1e3),
           "max_memory_allocated": int(torch.cuda.max_memory_allocated()),
           "state_bytes": _lm_state_bytes(state)}
    log(f"{tag}: {cfg.name} at {cfg.n_layers} layers, {steps} steps of "
        f"{batch} x {seq}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, step "
        f"p50 {p50:.1f} ms ({rep['tok_per_s']:.1f} tok/s), peak "
        f"{rep['max_memory_allocated']} bytes")
    del state
    torch.cuda.empty_cache()
    return rep


def _stub_context(cfg, batch: int, gen):
    """The cross-attention families' stub input from ``gen`` (on the
    card), in the model dtype: [batch, enc_seq, d] frame embeddings
    (audio) or [batch, n_patches, d] patch embeddings (vlm)."""
    import torch
    from repro_torch.models.lm import _dtype
    f = cfg.enc_seq if cfg.family == "audio" else cfg.n_patches
    return torch.randn((batch, f, cfg.d_model), generator=gen,
                       device=DEVICE).to(_dtype(cfg))


def _moe_bytes(cfg) -> dict:
    """A decode step's expert bytes at batch LM_BATCH: every expert's
    weights (what the reference's capacity gather reads: each expert runs
    its C slots), the most the routed experts could need (B x top_k of
    them a layer), and the f32 copies the expert products make (each
    bf16 weight read, written as f32 and read again)."""
    from repro_torch.nn.ffn import moe_capacity
    per_expert = 3 * cfg.d_model * cfg.d_ff * 2
    routed = min(cfg.n_experts, LM_BATCH * cfg.top_k)
    allb = cfg.n_layers * cfg.n_experts * per_expert
    return {"capacity": moe_capacity(LM_BATCH, cfg.top_k, cfg.n_experts),
            "expert_bytes": allb,
            "routed_expert_bytes_max": cfg.n_layers * routed * per_expert,
            "f32_copy_bytes": allb * 5,
            "expert_bound_ms": allb / HBM_BYTES_PER_S * 1e3,
            "routed_bound_ms": cfg.n_layers * routed * per_expert
            / HBM_BYTES_PER_S * 1e3}


def _kernel_shape_row(cache, cfg, tag: str) -> dict:
    """vq_attention at the decode path's shape of ``cfg`` (bf16, from
    layer 0 of the cache a VQ decode left, past the window), against its
    plain version and timed."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    path = _vq_path_args(_attn_cache(cfg, cache), cfg, gen)
    bf = [t.to(torch.bfloat16) if i in (0, 1, 2, 4, 5) else t
          for i, t in enumerate(path)]
    return _vq_attn_row(bf, f"({tag} decode path, layer 0 of a served "
                            f"cache)")


def phase_families_serve() -> tuple[dict, dict, list[dict]]:
    """Decode and prefill of the moe, ssm and hybrid families through the
    serve launcher's configurations and ``decode``: qwen3-moe-30b-a3b at
    full width and depth (FAMILY_VQ_TOKENS VQ steps past the 64-token
    window, FAMILY_EXACT_TOKENS exact steps, a profile of 2 VQ steps, one
    prefill), phi3.5-moe-42b-a6.6b cut to PHI_LAYERS layers (a VQ
    decode), xlstm-350m and zamba2-2.7b at full width and depth (decode,
    VQ for zamba2's shared block, and prefill); vq_attention at each new
    path shape.  Returns the report, the VQ paths' counts and the kernel
    rows."""
    import torch
    counts_all = None
    rep, rows = {}, []

    def add(c):
        nonlocal counts_all
        counts_all = c if counts_all is None else add_counts(counts_all, c)

    # qwen3-moe-30b-a3b, full width and depth: 60 GB of bf16 weights
    cfg_vq, cfg_x = _lm_cfg(True, MOE_ARCH), _lm_cfg(False, MOE_ARCH)
    params, r = _family_init(cfg_x)
    emb = params["embed"].numel() * params["embed"].element_size()
    r["step_weight_bytes"] = r["param_bytes"] - emb
    r["step_bound_ms"] = r["step_weight_bytes"] / HBM_BYTES_PER_S * 1e3
    r.update(_moe_bytes(cfg_x))
    r["vq"], c, cache = _family_decode(params, cfg_vq, FAMILY_VQ_TOKENS,
                                       f"families-serve {MOE_ARCH} vq")
    add(c)
    rows.append(_kernel_shape_row(cache, cfg_vq, MOE_ARCH))
    del cache
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=DEVICE)
    from repro_torch.models import lm
    cache = lm.init_serve_cache(cfg_vq, LM_BATCH, LM_CONTEXT, device=DEVICE)
    for _ in range(cfg_vq.vq_window + 2):
        lm.serve_step(params, tok, cache, cfg_vq)
    r["vq"]["profile"] = _profile(
        f"{MOE_ARCH} vq decode step", [0, 1],
        lambda _: lm.serve_step(params, tok, cache, cfg_vq),
        LM_KERNEL_GROUPS, cpu=False)
    del cache
    r["exact"], _, _ = _family_decode(params, cfg_x, FAMILY_EXACT_TOKENS,
                                      f"families-serve {MOE_ARCH} exact")
    r["prefill"] = _family_prefill(params, cfg_x,
                                   f"families-prefill {MOE_ARCH}")
    log(f"families-serve {MOE_ARCH}: step p50 {r['vq']['step_p50_ms']:.3f} "
        f"ms (VQ) / {r['exact']['step_p50_ms']:.3f} (exact) against the "
        f"weight-bytes bound {r['step_bound_ms']:.3f} ms; capacity "
        f"{r['capacity']} a expert at batch {LM_BATCH}: every expert's "
        f"{r['expert_bytes']} bytes read a step, the routed experts' at "
        f"most {r['routed_expert_bytes_max']} ({r['routed_bound_ms']:.3f} "
        f"ms)")
    rep[MOE_ARCH] = r
    del params
    torch.cuda.empty_cache()

    # phi3.5-moe-42b-a6.6b: 83.75 GB at full depth, cut to PHI_LAYERS
    cfg_vq = _lm_cfg(True, PHI_ARCH, n_layers=PHI_LAYERS)
    params, r = _family_init(cfg_vq)
    r["full_layers"] = _lm_cfg(False, PHI_ARCH).n_layers
    r.update(_moe_bytes(cfg_vq))
    r["vq"], c, cache = _family_decode(params, cfg_vq, FAMILY_VQ_TOKENS,
                                       f"families-serve {PHI_ARCH} vq")
    add(c)
    rows.append(_kernel_shape_row(cache, cfg_vq, PHI_ARCH))
    del cache
    rep[PHI_ARCH] = r
    del params
    torch.cuda.empty_cache()

    # xlstm-350m (no attention: --vq has nothing to act on) and zamba2-2.7b
    for arch in (SSM_ARCH, HYBRID_ARCH):
        cfg = _lm_cfg(arch == HYBRID_ARCH, arch)
        params, r = _family_init(cfg)
        r["vq" if cfg.vq_attn else "decode"], c, cache = _family_decode(
            params, cfg, FAMILY_VQ_TOKENS, f"families-serve {arch}")
        add(c)
        if cfg.vq_attn:
            rows.append(_kernel_shape_row(cache, cfg, arch))
        del cache
        r["prefill"] = _family_prefill(
            params, _lm_cfg(False, arch), f"families-prefill {arch}")
        rep[arch] = r
        del params
        torch.cuda.empty_cache()
    return rep, counts_all, rows


def phase_families_train() -> dict:
    """Launcher training steps: the MoE at qwen3-moe-30b-a3b's full width
    cut to MOE_TRAIN_LAYERS layers, xlstm-350m and zamba2-2.7b at full
    width and depth."""
    return {MOE_ARCH: _family_train(
                MOE_ARCH, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, FAMILY_TRAIN_STEPS,
                f"families-train {MOE_ARCH}", n_layers=MOE_TRAIN_LAYERS),
            SSM_ARCH: _family_train(
                SSM_ARCH, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, FAMILY_TRAIN_STEPS,
                f"families-train {SSM_ARCH}"),
            HYBRID_ARCH: _family_train(
                HYBRID_ARCH, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ,
                FAMILY_TRAIN_STEPS, f"families-train {HYBRID_ARCH}")}


def _family_parity(arch: str, layers: int, vq: bool, tag: str,
                   steps: int = FAMILY_PARITY_STEPS, **vq_replace) -> dict:
    """``arch`` at full width and ``layers`` layers in f32, TF32 off, the
    weights copied to the CPU: ``steps`` teacher-forced decode steps card
    vs CPU (logits LM_TOL, codebook counts equal at every step under VQ,
    the decode configuration's fields ``vq_replace`` replaced), then
    ``loss_and_grads`` on one batch of FAMILY_PARITY_BATCH x
    FAMILY_PARITY_SEQ (exact attention) and the launcher's Adam update
    from those gradients on each device: loss and gradients LM_TRAIN_TOL,
    params within ``rtol=1e-5`` and twice the step's Adam step size,
    moments within a bf16 ulp.

    The cross-attention families first get what their init leaves at
    zero, the same on both devices: every vlm ``gate`` drawn from U[0.4,
    1.2] (tanh(0) = 0 at init) and the caches' ``cross_k`` / ``cross_v``
    from a seeded generator (zeros in a fresh cache) -- otherwise the
    cross output is 0 and a wrong cross path would pass -- and their
    training step reads a stub context from a seeded generator."""
    import torch
    from repro_torch import convert
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import lm
    from repro_torch.train.loop import loss_and_grads
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise SystemExit(f"{tag}: TF32 is on")
    cfg_d = _lm_cfg(vq, arch, n_layers=layers, dtype="float32",
                    **vq_replace)
    cfg_t = _lm_cfg(False, arch, n_layers=layers, dtype="float32")
    cross = cfg_t.family in lm.CROSS_FAMILIES
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    params = lm.init_lm(cfg_t, gen, device=DEVICE)
    if cfg_t.family == "vlm":
        params["cross_blocks"]["gate"].uniform_(0.4, 1.2, generator=gen)
    cpu_params = convert.to_device(params, "cpu")
    card_cache = lm.init_serve_cache(cfg_d, LM_BATCH, LM_CONTEXT,
                                     device=DEVICE)
    if cross:
        for name in ("cross_k", "cross_v"):
            card_cache[name].normal_(generator=gen)
    caches = [card_cache, convert.to_device(card_cache, "cpu")]
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg_d.vocab, (steps, LM_BATCH, 1)))
    n_attn = _attn_layers(cfg_d) if cfg_d.vq_attn else 0
    worst, t_card, t_cpu = 0.0, 0.0, 0.0
    reset_counts()
    for s in range(steps):
        t0 = time.time()
        got, caches[0] = lm.serve_step(params, tokens[s].to(DEVICE),
                                       caches[0], cfg_d)
        got = got.cpu()
        t_card += time.time() - t0
        t0 = time.time()
        want, caches[1] = lm.serve_step(cpu_params, tokens[s], caches[1],
                                        cfg_d)
        t_cpu += time.time() - t0
        worst = max(worst, check_close(f"{tag} step {s}", got, want, LM_TOL))
        if n_attn and not torch.equal(_attn_cache(cfg_d, caches[0]).count
                                      .cpu(),
                                      _attn_cache(cfg_d, caches[1]).count):
            raise SystemExit(f"{tag} step {s}: codebook counts differ")
    expect_counts(tag, read_counts(), {"vq_attention": n_attn * steps})
    del caches, card_cache
    rep = {"layers": layers, "decode_steps": steps,
           "vq": cfg_d.vq_attn, "decode_max_abs_err": worst,
           "decode_card_s": t_card, "decode_cpu_s": t_cpu}
    if cfg_d.vq_attn:
        rep.update(vq_k=cfg_d.vq_k, vq_window=cfg_d.vq_window)
    tok = _lm_batches(cfg_t, FAMILY_PARITY_BATCH, FAMILY_PARITY_SEQ, 1)[0]
    aux = _stub_context(cfg_t, FAMILY_PARITY_BATCH, gen) if cross else None
    t0 = time.time()
    lc, gc_ = loss_and_grads(params, tok.to(DEVICE), cfg_t, aux)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    lh, gh = loss_and_grads(cpu_params, tok, cfg_t,
                            None if aux is None else aux.cpu())
    t_cpu = time.time() - t0
    rep["loss"] = [float(lc), float(lh)]
    rep["loss_err"] = check_close(f"{tag} loss", lc.reshape(1),
                                  lh.reshape(1), LM_TRAIN_TOL)
    rep["grad_err"] = _tree_close(f"{tag} grad", gc_, gh, **LM_TRAIN_TOL)
    opt = tlaunch.optimizer(LM_TRAIN_LR, 1)
    t0 = time.time()
    new_c, opt_c = opt.update(gc_, opt.init(params), params)
    torch.cuda.synchronize()
    t_adam_card = time.time() - t0
    t0 = time.time()
    new_h, opt_h = opt.update(gh, opt.init(cpu_params), cpu_params)
    t_adam_cpu = time.time() - t0
    del gc_, gh
    rep["param_err"] = _tree_close(f"{tag} params", new_c, new_h, rtol=1e-5,
                                   atol=2.0 * _lm_lr_t(1, 1) + 1e-6)
    rep["moment_err"] = max(
        _tree_close(f"{tag} {n}", getattr(opt_c, n), getattr(opt_h, n),
                    rtol=2.0 ** -7, atol=at)
        for n, at in (("mu", 1e-6), ("nu", 1e-10)))
    rep.update(train_card_s=t_card, train_cpu_s=t_cpu,
               adam_card_s=t_adam_card, adam_cpu_s=t_adam_cpu)
    log(f"{tag}: {arch} at {layers} layers f32, {steps} "
        f"teacher-forced {'VQ ' if cfg_d.vq_attn else ''}decode steps agree "
        f"(max abs err {worst:.3g}, rtol 1e-4 atol 1e-4"
        f"{', counts equal at every step' if n_attn else ''}); one train "
        f"step: loss {rep['loss']}, gradients max abs err "
        f"{rep['grad_err']:.3g} (rtol 1e-4 atol 1e-5), params "
        f"{rep['param_err']:.3g}, moments {rep['moment_err']:.3g}; "
        f"decode card {rep['decode_card_s']:.2f} s CPU "
        f"{rep['decode_cpu_s']:.2f} s, train step card {t_card:.2f} s CPU "
        f"{t_cpu:.2f} s, Adam card {t_adam_card:.2f} s CPU "
        f"{t_adam_cpu:.2f} s")
    del params, cpu_params, new_c, new_h, opt_c, opt_h
    torch.cuda.empty_cache()
    return rep


def phase_families_parity() -> dict:
    """Card vs CPU for each new family at full width in f32: the MoE at 2
    layers (VQ decode), xLSTM at 2 pairs, zamba2 at one group of 6 Mamba2
    layers and the shared block (VQ decode)."""
    return {MOE_ARCH: _family_parity(MOE_ARCH, 2, True,
                                     "families-parity moe"),
            SSM_ARCH: _family_parity(SSM_ARCH, 4, False,
                                     "families-parity ssm"),
            HYBRID_ARCH: _family_parity(HYBRID_ARCH, 6, True,
                                        "families-parity hybrid")}


# ---------------------------------------------------------------------------
# the cross-attention LM families: whisper-tiny's encoder-decoder and
# llama-3.2-vision-11b's gated image layers (their encoder and cross
# attention plain PyTorch, plain XLA in the reference); their decoder
# self-attention decodes through vq_attention under VQ
# ---------------------------------------------------------------------------

def _xattn_step_bytes(params, cfg) -> dict:
    """A decode step's bytes at batch LM_BATCH: every weight it reads
    (the tree's bytes less the embedding table, of which it reads one row
    a sequence, and whisper's encoder, which no decode step runs) and the
    cross caches' keys and values, both over the card's HBM rate."""
    skip = ("embed", "enc_blocks", "enc_ln_f")
    w = sum(_tree_bytes(v)[1] for k, v in params.items() if k not in skip)
    n, f = ((cfg.n_layers // cfg.cross_attn_period, cfg.n_patches)
            if cfg.family == "vlm" else (cfg.n_layers, cfg.enc_seq))
    item = 2 if cfg.dtype == "bfloat16" else 4
    cross = 2 * n * LM_BATCH * f * cfg.n_kv_heads * cfg.hd * item
    return {"step_weight_bytes": w, "cross_cache_bytes": cross,
            "step_bound_ms": (w + cross) / HBM_BYTES_PER_S * 1e3}


def phase_xattn_serve() -> tuple[dict, dict, list[dict]]:
    """Decode and prefill of the audio and vlm families through the serve
    launcher's configurations and ``decode`` at batch LM_BATCH, at full
    width and depth (random weights from a seeded generator on the card,
    the fresh caches' cross keys and values zeros, as the launcher serves
    them): FAMILY_VQ_TOKENS VQ steps past the 64-token window
    (``vq_attention`` once a decoder layer and step), FAMILY_EXACT_TOKENS
    exact steps, one prefill with the stub context (whisper [4, 448] over
    1,500 frames, the vision model [4, 2048] over 1,024 patches), a
    profile of 2 of the vision model's VQ steps, and ``vq_attention`` at
    each path shape on the layer-0 cache the VQ decode left.  Returns the
    report, the VQ decodes' counts and the kernel rows."""
    import torch
    from repro_torch.models import lm
    counts_all, rep, rows = None, {}, []
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    for arch, seq in ((AUDIO_ARCH, WHISPER_DEC_CTX),
                      (VLM_ARCH, LM_TRAIN_SEQ)):
        cfg_vq, cfg_x = _lm_cfg(True, arch), _lm_cfg(False, arch)
        params, r = _family_init(cfg_x)
        r.update(_xattn_step_bytes(params, cfg_x))
        r["vq"], c, cache = _family_decode(params, cfg_vq, FAMILY_VQ_TOKENS,
                                           f"xattn-serve {arch} vq")
        counts_all = c if counts_all is None else add_counts(counts_all, c)
        rows.append(_kernel_shape_row(cache, cfg_vq, arch))
        if arch == VLM_ARCH:
            tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=DEVICE)
            r["vq"]["profile"] = _profile(
                f"{arch} vq decode step", [0, 1],
                lambda _: lm.serve_step(params, tok, cache, cfg_vq),
                LM_KERNEL_GROUPS, cpu=False)
        del cache
        r["exact"], _, _ = _family_decode(params, cfg_x, FAMILY_EXACT_TOKENS,
                                          f"xattn-serve {arch} exact")
        r["prefill"] = _family_prefill(params, cfg_x, f"xattn-prefill {arch}",
                                       LM_BATCH, seq,
                                       _stub_context(cfg_x, LM_BATCH, gen))
        log(f"xattn-serve {arch}: step p50 {r['vq']['step_p50_ms']:.3f} ms "
            f"(VQ) / {r['exact']['step_p50_ms']:.3f} (exact) against the "
            f"bound {r['step_bound_ms']:.3f} ms ({r['step_weight_bytes']} "
            f"weight bytes and {r['cross_cache_bytes']} cross-cache bytes a "
            f"step)")
        rep[arch] = r
        del params
        torch.cuda.empty_cache()
    return rep, counts_all, rows


def _vlm_train_groups(cfg) -> dict:
    """The deepest whole number of the vision model's groups (period text
    layers and their cross block) whose launcher step fits
    XATTN_TRAIN_BUDGET: the step holds the bf16 params, their bf16
    gradients and two bf16 Adam moments, and while Adam writes the new
    params and moments the old ones too -- 14 bytes a parameter at its
    peak -- plus XATTN_ACT_BYTES of activations, logits and the embedding
    table's f32 copy and gradient; at least 2 groups."""
    d, hd = cfg.d_model, cfg.hd
    block = 2 * d + d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 2 * hd + 3 * d * cfg.d_ff
    group = cfg.cross_attn_period * block + block + 1
    base = 2 * cfg.vocab * d + d

    def peak(g):
        return 14 * (base + g * group) + XATTN_ACT_BYTES
    groups = max([2] + [g for g in range(
        2, cfg.n_layers // cfg.cross_attn_period + 1)
        if peak(g) <= XATTN_TRAIN_BUDGET])
    return {"groups": groups, "layers": groups * cfg.cross_attn_period,
            "full_layers": cfg.n_layers, "params": base + groups * group,
            "estimated_peak_bytes": peak(groups),
            "next_group_peak_bytes": peak(groups + 1)}


def phase_xattn_train() -> dict:
    """FAMILY_TRAIN_STEPS steps of the train launcher's optimizer and
    ``make_step`` with the stub context (the launcher itself refuses
    these families: it makes no context, as the reference's does not):
    whisper-tiny at full width and depth, 8 x 448; the vision model at
    full width, 2 x 1,024, cut to ``_vlm_train_groups`` groups."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    full = get_arch(VLM_ARCH)
    cut = _vlm_train_groups(full)
    log(f"xattn-train {VLM_ARCH}: {cut['groups']} groups ({cut['layers']} of "
        f"{cut['full_layers']} text layers and their cross blocks, "
        f"{cut['params']} parameters): estimated peak "
        f"{cut['estimated_peak_bytes']:.4g} bytes; one group more "
        f"{cut['next_group_peak_bytes']:.4g} against the "
        f"{XATTN_TRAIN_BUDGET:.4g}-byte budget")
    rep = {AUDIO_ARCH: _family_train(
               AUDIO_ARCH, WHISPER_TRAIN_BATCH, WHISPER_DEC_CTX,
               FAMILY_TRAIN_STEPS, f"xattn-train {AUDIO_ARCH}",
               cfg=get_arch(AUDIO_ARCH)),
           VLM_ARCH: _family_train(
               VLM_ARCH, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, FAMILY_TRAIN_STEPS,
               f"xattn-train {VLM_ARCH}",
               cfg=dataclasses.replace(full, n_layers=cut["layers"]))}
    rep[VLM_ARCH]["cut"] = cut
    return rep


def phase_xattn_parity() -> dict:
    """Card vs CPU for the audio and vlm families in f32: whisper-tiny at
    full width and depth, the vision model at full width and one group (5
    text layers and their gated cross block); every gate nonzero and the
    cross caches filled (``_family_parity``); XATTN_PARITY_STEPS
    teacher-forced VQ decode steps at k XATTN_PARITY_K, W XATTN_PARITY_W,
    then one launcher step's loss, gradients, params and moments."""
    kw = dict(steps=XATTN_PARITY_STEPS, vq_k=XATTN_PARITY_K,
              vq_window=XATTN_PARITY_W)
    return {AUDIO_ARCH: _family_parity(AUDIO_ARCH, 4, True,
                                       "xattn-parity audio", **kw),
            VLM_ARCH: _family_parity(VLM_ARCH, 5, True, "xattn-parity vlm",
                                     **kw)}


# ---------------------------------------------------------------------------
# the LM mesh
# ---------------------------------------------------------------------------

LM_MESH_RANKS = 4             # gloo ranks sharing the one card
LM_MESH_MODEL = 2             # the host mesh (2, 2): ("data", "model")
LM_MESH_LAYERS = 4            # of llama3.2-3b's 28
LM_MESH_BATCH = 4
LM_MESH_SEQ = 256
LM_MESH_STEPS = 3
LM_MESH_PARITY_LAYERS = 2
# a shard's error norm over its norm, for each gradient leaf: a flipped
# sign or a misplaced shard gives ~1, rounding ~1e-7 -- the check that
# holds gradients too small for LM_TRAIN_TOL's atol; the bf16 moments'
# own rounding (their values one ulp apart) bounds theirs by 2^-7
LM_MESH_REL = 1e-4
LM_MESH_REL_BF16 = 2.0 ** -7


def _offload(tree) -> list:
    """Every DTensor leaf of ``tree`` as (path, this rank's shard on the
    host, its mesh, its placements): what a rank keeps while another
    rank has the shared card."""
    from repro_torch.distributed.sharding import leaf_paths
    return [(key, t.to_local().cpu(), t.device_mesh, t.placements)
            for key, t in leaf_paths(tree)]


def _local_of(full, mesh, placements):
    """This rank's slice of the plain tensor ``full`` in the layout
    ``placements`` on ``mesh`` (cut here, no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, mesh, placements,
                             src_data_rank=None).to_local()


def _shard_close(what: str, held: list, plain, rtol: float, atol: float,
                 rel_max: float = LM_MESH_REL) -> tuple[float, float, int]:
    """Each shard of ``held`` (``_offload``) within ``atol + rtol |want|``
    of the same slice of ``plain``'s leaf, on ``plain``'s device, element
    by element, and its error norm within ``rel_max`` of the slice's norm
    (a slice of zeros: the shard all zeros); (largest abs error, largest
    relative error norm, elements and shards beyond the tolerances,
    non-finite ones included)."""
    import torch
    from repro_torch.distributed.sharding import leaf_paths
    want = dict(leaf_paths(plain))
    worst, worst_rel, bad = 0.0, 0.0, 0
    for key, loc, dm, pl in held:
        w = _local_of(want[key], dm, pl).float()
        err = loc.to(w.device).float() - w
        norm, enorm = float(torch.linalg.vector_norm(w)), \
            float(torch.linalg.vector_norm(err))
        rel = enorm / norm if norm > 0 else (0.0 if enorm == 0 else math.inf)
        err = err.abs()
        n_bad = int((~(err <= atol + rtol * w.abs())).sum())
        if n_bad or not rel <= rel_max:
            log(f"{what} {key}: {n_bad} elements beyond rtol {rtol} atol "
                f"{atol} (max abs err {float(err.max())}), error norm "
                f"{rel:.3g} of the norm")
        bad += n_bad + int(not rel <= rel_max)
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        worst_rel = max(worst_rel, rel)
    return worst, worst_rel, bad


def _lm_mesh_params_close(what: str, held: list, plain, grads,
                          held_grads: list, nu, scale: float, lr_t: float
                          ) -> tuple[float, int, int, int]:
    """Each param shard of ``held`` (``_offload`` of the mesh's step)
    against the same slice of ``plain`` (the unsharded step) at rtol 1e-5,
    atol 1e-6 (a tenth of the step-1 lr_t), on every element where the
    update is well-conditioned, by ``split_step_check``'s rule (phase 23)
    for the launcher's Adam: lr_t (1 - b1) s / (sqrt(v) + eps), the gain
    from a gradient to its param (s the clip scale, v the unsharded
    step's new ``nu``), times the gradient's LM_TRAIN_TOL is within the
    param's tolerance; and where both steps' gradients are exactly 0
    (the first moment 0: neither step moves the param).  Where the
    gradient is within rounding of 0 the gain reaches ~1e2 and a sign
    that differs moves the param 2 lr_t apart: the gradients hold those
    (``_shard_close``).  ``grads`` are the unsharded step's gradients and
    ``held_grads`` the mesh's (``_offload``), in ``held``'s order.
    (largest abs error on the well-conditioned elements, those beyond the
    tolerance, elements left to the gradients, all elements)."""
    import torch
    from repro_torch.distributed.sharding import leaf_paths
    at, rt = 1e-6, 1e-5
    ag, rg = LM_TRAIN_TOL["atol"], LM_TRAIN_TOL["rtol"]
    want, gd, vd = (dict(leaf_paths(x)) for x in (plain, grads, nu))
    worst, bad, outside, n_all = 0.0, 0, 0, 0
    mesh_g = {key: loc for key, loc, _, _ in held_grads}
    for key, loc, dm, pl in held:
        p, g, v = (_local_of(x[key], dm, pl).float() for x in (want, gd, vd))
        gain = lr_t * 0.1 * scale / (torch.sqrt(v) + 1e-8)
        ok = (gain * (ag + rg * g.abs()) <= at + rt * p.abs()) | (
            (g == 0) & (mesh_g[key].to(g.device) == 0))
        err = (loc.to(p.device).float() - p).abs()
        n_bad = int((ok & ~(err <= at + rt * p.abs())).sum())
        if n_bad:
            log(f"{what} {key}: {n_bad} well-conditioned elements beyond "
                f"rtol {rt} atol {at} (max abs err {float(err[ok].max())})")
        bad += n_bad
        if bool(ok.any()):
            worst = max(worst, float(err[ok].max()))
        outside += int((~ok).sum())
        n_all += ok.numel()
    return worst, bad, outside, n_all


def _lm_mesh_rank(mesh, cfg) -> dict:
    """lm-mesh, one rank's part (phase 43) on ``cfg`` (the train
    launcher's configuration, cut in depth), with DTensor's collectives
    synchronous where the ranks share the card (gloo): the bf16 steps
    timed, then the f32 step against the unsharded step, which each rank
    runs in turn."""
    import contextlib

    from repro_torch.distributed.ranks import sync_functional_collectives
    with sync_functional_collectives(mesh.device.type) \
            if mesh.share_device else contextlib.nullcontext():
        return _lm_mesh_rank_steps(mesh, cfg)


def _lm_mesh_rank_steps(mesh, cfg) -> dict:
    import dataclasses

    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.train.loop import TrainState, loss_and_grads
    from repro_torch.train.optimizer import global_norm
    dev = mesh.device
    reset_counts()
    cuda = dev.type == "cuda"
    dmesh = make_host_mesh(model=LM_MESH_MODEL, device=dev)

    def sharded_state(cfg_, opt, sh, seed):
        # the same weights on every rank from the seed; each keeps its shard
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = lm.init_lm(cfg_, gen, device=dev)
        dparams = shd.distribute(params, sh.params, src_data_rank=None)
        state = TrainState(dparams, opt.init(dparams),
                           torch.zeros((), dtype=torch.int32, device=dev))
        return shd.distribute(state, sh, src_data_rank=None), params

    opt = tlaunch.optimizer(LM_TRAIN_LR, LM_MESH_STEPS)
    step, sh = tlaunch.build_sharded_step(cfg, dmesh, opt, 1)
    strategy = shd.strategy_for(cfg, dmesh)
    state, params = sharded_state(cfg, opt, sh, SEED)
    del params
    local = {k: list(t.to_local().shape) for k, t in
             shd.leaf_paths(state.params)
             if k in ("['blocks']['mlp'].w1", "['embed']")}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    batches = _lm_batches(cfg, LM_MESH_BATCH, LM_MESH_SEQ, LM_MESH_STEPS)
    losses, ms = [], []
    for tok in batches:
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, tok.to(dev))
        losses.append(float(m["loss"]))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del state
    if cuda:
        torch.cuda.empty_cache()

    # one f32 step at 2 layers on the mesh, and its gradients as the step
    # takes them; then each rank in turn runs it unsharded from the same
    # weights and holds its own shards to it: gradients, both moments and
    # the well-conditioned params
    import torch.distributed as dist
    cfg32 = dataclasses.replace(cfg, n_layers=LM_MESH_PARITY_LAYERS,
                                dtype="float32")
    opt32 = tlaunch.optimizer(LM_TRAIN_LR, 1)
    step32, sh32 = tlaunch.build_sharded_step(cfg32, dmesh, opt32, 1)
    strategy32 = shd.strategy_for(cfg32, dmesh)
    st32, params = sharded_state(cfg32, opt32, sh32, SEED + 5)
    del params                       # drawn again in this rank's turn
    tok = batches[0].to(dev)
    with tlaunch.on_mesh(dmesh, cfg32, strategy32, tok.shape[0]):
        _, g32 = loss_and_grads(st32.params, tlaunch.place_batch(
            tok, dmesh, cfg32, strategy32), cfg32)
    new32, m32 = step32(st32, tok)
    # each rank's shards wait on the host while the ranks take the card in
    # turn for the unsharded step
    held = {"grad": _offload(g32), "mu": _offload(new32.opt.mu),
            "nu": _offload(new32.opt.nu), "params": _offload(new32.params)}
    del st32, new32, g32
    if cuda:
        torch.cuda.empty_cache()
    par = {"loss": float(m32["loss"]), "grad_norm": float(m32["grad_norm"])}
    errs = torch.zeros(8, dtype=torch.float64, device=dev)
    counts = torch.zeros(2, dtype=torch.float64, device=dev)
    for r in range(mesh.world_size):
        dist.barrier()
        if r != mesh.rank:
            continue
        if cuda:
            par["card_bytes_at_turn"] = [torch.cuda.memory_allocated(dev),
                                         torch.cuda.memory_reserved(dev),
                                         torch.cuda.mem_get_info(dev)[0]]
        # the unsharded step as ``make_train_step`` takes it at accum 1,
        # its gradients kept: the same weights from the seed
        params = lm.init_lm(cfg32, torch.Generator(device=dev).manual_seed(
            SEED + 5), device=dev)
        lp, gp = loss_and_grads(params, tok, cfg32)
        mp = {"loss": lp, "grad_norm": global_norm(gp)}
        new_p, new_o = opt32.update(gp, opt32.init(params), params)
        del params
        plain = TrainState(new_p, new_o, None)
        for k_ in ("loss", "grad_norm"):
            check_close(f"lm-mesh f32 {k_}", m32[k_].reshape(1),
                        mp[k_].reshape(1), LM_TRAIN_TOL)
            par[f"{k_}_unsharded"] = float(mp[k_])
        tag = f"lm-mesh f32 rank {mesh.rank}"
        worst_g, rel_g, bad_g = _shard_close(f"{tag} grad", held["grad"],
                                             gp, **LM_TRAIN_TOL)
        worst_mu, rel_mu, bad_mu = _shard_close(
            f"{tag} mu", held["mu"], plain.opt.mu, **LM_TRAIN_TOL,
            rel_max=LM_MESH_REL_BF16)
        worst_nu, rel_nu, bad_nu = _shard_close(
            f"{tag} nu", held["nu"], plain.opt.nu, **LM_TRAIN_TOL,
            rel_max=LM_MESH_REL_BF16)
        scale = min(1.0, 1.0 / max(float(mp["grad_norm"]), 1e-9))
        worst_p, bad_p, outside, n_all = _lm_mesh_params_close(
            f"{tag} params", held["params"], plain.params, gp,
            held["grad"], plain.opt.nu, scale, _lm_lr_t(1, 1))
        errs = torch.tensor([worst_g, worst_mu, worst_nu, worst_p,
                             float(bad_g + bad_mu + bad_nu + bad_p),
                             rel_g, rel_mu, rel_nu],
                            dtype=torch.float64, device=dev)
        counts = torch.tensor([float(outside), float(n_all)],
                              dtype=torch.float64, device=dev)
        del plain, gp
        if cuda:
            torch.cuda.empty_cache()
    del held
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    dist.all_reduce(counts)
    if float(errs[4]) > 0:
        raise SystemExit(f"lm-mesh f32 step: shards beyond tolerance on a "
                         f"rank (max abs errs: grad {float(errs[0])}, mu "
                         f"{float(errs[1])}, nu {float(errs[2])}, params "
                         f"{float(errs[3])})")
    par.update(grad_err=float(errs[0]), mu_err=float(errs[1]),
               nu_err=float(errs[2]), param_err=float(errs[3]),
               grad_rel=float(errs[5]), mu_rel=float(errs[6]),
               nu_rel=float(errs[7]),
               params_held_by_gradients=int(counts[0]),
               param_elements=int(counts[1]))
    if cuda:
        torch.cuda.empty_cache()
    counts = read_counts()
    return {"rank": mesh.rank, "strategy": strategy, "losses": losses,
            "step_ms": ms, "step_p50_ms": float(np.percentile(ms, 50)),
            "max_memory_allocated": int(peak), "local_shapes": local,
            "parity": par,
            "launches": {k: v for k, v in counts.items()
                         if k not in KEYED and v}}


def phase_lm_mesh() -> dict:
    """Phase 43 (module docstring)."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch import roofline
    import dataclasses
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(_lm_train_cfg(False), n_layers=LM_MESH_LAYERS)
    # the fake-rank dry-run on the host, beside the ranks: a subprocess
    # that sees no card
    out_dir = os.path.join(ROOT, "build", "dryrun_torch")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.time()
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-8b", "--shape", "prefill_32k", "--layers", "2",
         "--out", out_dir], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        outs = run_ranks(_lm_mesh_rank, LM_MESH_RANKS, "gloo", DEVICE, cfg,
                         share_device=DEVICE == "cuda", timeout_s=600)
        wall = time.time() - t0
        _, err = dry.communicate(timeout=300)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    dry_s = time.time() - t0
    for o in outs:
        if not all(math.isfinite(x) for x in o["losses"]):
            raise SystemExit(f"lm-mesh: rank {o['rank']}'s losses "
                             f"{o['losses']} are not finite")
        if o["losses"] != outs[0]["losses"]:
            raise SystemExit(f"lm-mesh: ranks disagree on the losses: "
                             f"{[x['losses'] for x in outs]}")
        if o["launches"]:
            raise SystemExit(f"lm-mesh: rank {o['rank']} launched counted "
                             f"kernels {o['launches']}; the LM mesh path "
                             f"has none")
        log(f"lm-mesh rank {o['rank']}: losses {o['losses']}, step ms "
            f"{[round(x, 3) for x in o['step_ms']]} (p50 "
            f"{o['step_p50_ms']:.3f}), max_memory_allocated "
            f"{o['max_memory_allocated']} B, local shapes "
            f"{o['local_shapes']}, card bytes allocated / reserved / free "
            f"at its unsharded turn "
            f"{o['parity'].get('card_bytes_at_turn')}")
    losses = outs[0]["losses"]
    if losses[-1] > losses[0] * 1.01:
        raise SystemExit(f"lm-mesh: the loss rose: {losses}")
    par = outs[0]["parity"]
    log(f"lm-mesh f32 step at {LM_MESH_PARITY_LAYERS} layers, the mesh vs "
        f"each rank's unsharded step on the card: {par}")
    if dry.returncode != 0:
        raise SystemExit("lm-mesh dry-run failed:\n" + err[-3000:])
    with open(os.path.join(out_dir, "granite-3-8b__prefill_32k__pod16x16__"
                           "l2.json")) as f:
        cell = json.load(f)
    if not (cell["cost"]["flops"] > 0 and cell["memory"]["argument_bytes"]
            == cell["memory"]["spec_argument_bytes"]
            and sum(cell["collectives"]["by_axis"]["model"].values()) > 0):
        raise SystemExit(f"lm-mesh dry-run: {cell}")
    log(json.dumps({"lm_mesh_dryrun": cell}))
    cfg = ARCHS["llama3.2-3b"]
    strategy = "fsdp"          # strategy_for on (16, 16): 24 heads
    terms = {"model_flops": roofline.model_flops(cfg, "train_4k"),
             "hbm_bytes": roofline.model_hbm_bytes(cfg, "train_4k", 256, 8,
                                                   strategy),
             "coll_bytes": roofline.model_collective_bytes(
                 cfg, "train_4k", 256, 16, 16, 8, strategy)}
    terms.update(compute_s=terms["model_flops"] / (256 * roofline.PEAK_FLOPS),
                 memory_s=terms["hbm_bytes"] / roofline.HBM_BW,
                 collective_s=terms["coll_bytes"] / roofline.LINK_BW)
    log(f"lm-mesh roofline, llama3.2-3b train_4k on 256 H100s ({strategy}, "
        f"accum 8): {terms}")
    return {"ranks": LM_MESH_RANKS, "mesh": [LM_MESH_RANKS // LM_MESH_MODEL,
                                             LM_MESH_MODEL],
            "layers": LM_MESH_LAYERS, "batch": LM_MESH_BATCH,
            "seq": LM_MESH_SEQ, "strategy": outs[0]["strategy"],
            "losses": losses, "wall_s": wall,
            "step_p50_ms": [o["step_p50_ms"] for o in outs],
            "max_memory_allocated": [o["max_memory_allocated"] for o in outs],
            "parity": par, "dryrun_s": dry_s,
            "dryrun_trace_s": cell["trace_s"],
            "roofline_llama3.2-3b_train_4k": terms}


def phase_analysis() -> dict:
    """Phase 44: the contract checker on the card (the docstring's (a) to
    (d)); every launch here is counted apart from the main paths'."""
    import contextlib
    import io
    import torch
    from repro_torch.analysis import (dispatch_checks, registry, smem_checks,
                                      trace_count)
    from repro_torch.analysis.__main__ import main as analysis_main
    t0 = time.time()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = analysis_main(["--device", "cuda"])
    findings = out.getvalue().splitlines()
    for line in findings:
        log(f"analysis finding: {line}")
    if rc != 0:
        raise SystemExit(f"analysis: the checker exits {rc} on the card "
                         f"with {len(findings)} finding(s)")
    cli_s = time.time() - t0
    launches = {}
    entries = [e for e in registry.entries()
               if e.dispatch_count is not None
               or e.name in ("vq_train_epoch", "sampler_train_epoch")]
    for e in entries:
        want = dispatch_checks.dispatch_counts(
            dispatch_checks.recorded(e, "cpu").records)
        reset_counts()
        e.run("cuda")
        torch.cuda.synchronize()
        got = trace_count.launch_counts()
        launches[e.name] = {f"{k} {f}": v for (k, f), v in sorted(got.items())}
        if got != want:
            raise SystemExit(f"analysis: {e.name} launched {got} on the "
                             f"card, the CPU recorder predicted {want}")
        if e.dispatch_count is not None and \
                sum(got.values()) != e.dispatch_count * e.steps:
            raise SystemExit(f"analysis: {e.name} launched {got}, not the "
                             f"pinned {e.dispatch_count} a step over "
                             f"{e.steps} steps")
    reset_counts()
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    from repro_torch.kernels import context_ell, vq_assign, vq_update
    optin_lib = context_ell.smem_optin()
    if optin_lib != smem_checks.SMEM_LIMIT or \
            (optin is not None and int(optin) != optin_lib):
        raise SystemExit(f"analysis: opt-in shared memory {optin} (torch) / "
                         f"{optin_lib} (the kernels), the wrappers size "
                         f"blocks for {smem_checks.SMEM_LIMIT}")
    widths = sorted({d.shapes[0][-1] for e in entries
                     for d in dispatch_checks.recorded(e, "cpu").records
                     if d.kernel in ("vq_update", "vq_assign")})
    plans = {}
    for f in widths:
        for wgs in (1, 2):
            card = vq_assign.wide_plan_card(f, wgs)
            if card != vq_update.wide_plan(f, wgs):
                raise SystemExit(f"analysis: wide plan at f={f}, wgs={wgs}: "
                                 f"card {card}, host "
                                 f"{vq_update.wide_plan(f, wgs)}")
            plans[f"f={f} wgs={wgs}"] = list(card)
    x = torch.ones(8, device="cuda")
    seeded = registry.Entry("fixture:item", make=lambda dev: (x,),
                            call=lambda t: float((t * 2).sum().item()))
    sync = dispatch_checks.sync_findings(seeded, "cuda")
    if [f.rule for f in sync] != ["REPRO102"]:
        raise SystemExit(f"analysis: a seeded .item() gave {sync}, not one "
                         f"REPRO102")
    rep = {"findings": len(findings), "cli_s": cli_s,
           "launches": launches, "smem_optin": optin_lib,
           "smem_optin_torch": optin, "wide_plans": plans,
           "seeded_sync": sync[0].message, "seconds": time.time() - t0}
    log(f"analysis: clean on the card, {len(entries)} entries' launches "
        f"equal to the CPU recorder's, opt-in shared memory {optin_lib} B, "
        f"{time.time() - t0:.2f} s")
    return rep


def main() -> int:
    import argparse
    import torch
    global WIDE_PARENT
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--wide-parent", default=None, metavar="DIR",
                    help="a checkout of an earlier tree whose wide VQ scan "
                         "phase 24 times beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.vq_gnn_paper import (paper_batch_size,
                                                  paper_config)
    from repro_torch.graph.datasets import synthetic_arxiv, synthetic_collab
    from repro_torch.launch import serve_gnn
    from repro_torch.models.gnn import quantize_vq_states

    phase_card()
    build_s = phase_build()
    seconds = {"build": build_s}
    if args.wide_parent is not None:
        WIDE_PARENT = _ParentWide(args.wide_parent)

    def timed(name, fn, *a):
        t = time.time()
        out = fn(*a)
        seconds[name] = seconds.get(name, 0.0) + time.time() - t
        log(f"phase {name}: {seconds[name]:.2f} s")
        return out

    t0 = time.time()
    g = synthetic_arxiv(n=N_NODES, seed=SEED)
    cfg = paper_config(g, full_scale=True)
    batch = paper_batch_size(g)
    m = Model(g, cfg, batch, torch.device(DEVICE))
    cpu = Model(g, cfg, PARITY_BATCH, "cpu")
    seconds["setup"] = time.time() - t0
    log(f"setup: {g.n} nodes, {g.m} edges, deg_cap "
        f"{m.plan.nbr_ids.shape[1]}, config {cfg}, training batch {batch} "
        f"in {seconds['setup']:.2f} s")

    # --- fp32: training, then serving the trained model ---
    r, train_counts = timed("train", phase_train, g, cfg, batch)
    params, vq, ost = r["params"], r["vq_states"], r["opt_state"]
    timing = timed("train timing", phase_step_timing, m, params, vq, ost)
    timed("train profile", phase_train_profile, m, params, vq, ost)
    train_rows, train_also = timed("train kernels", phase_train_kernels, m,
                                   params, vq)
    parity = timed("train parity", phase_train_parity, m, params, vq, ost,
                   cpu)
    server = serve_gnn.GNNServer(g, cfg, params, vq, BATCH, device=DEVICE)
    serve_rows = timed("serve kernels", phase_kernels, server)
    requests = serve_gnn.make_requests(g.n, REQUESTS, MAX_REQUEST, SEED)
    rep, serve_counts = timed("serve", phase_main_path, server, requests)
    rep["vq_state_bytes"] = serve_gnn.vq_state_bytes(server.vq)
    timed("serve cpu parity", phase_cpu_parity, server, requests)
    timed("serve profile", phase_profile, server, requests)

    # --- the sampling baselines, the hybrid, the staged SpMM ---
    sampler_reps, sampler_counts = timed("sampler-train",
                                         phase_sampler_train, g, cfg, batch)
    rh, hybrid_counts = timed("hybrid-train", phase_train, g, cfg, batch,
                              None, "hybrid", HYBRID_EPOCHS)
    hybrid_parity = timed("hybrid-train parity", phase_train_parity, m,
                          rh["params"], rh["vq_states"], rh["opt_state"],
                          cpu, "hybrid-train parity", True)
    sampler_parity = timed("sampler-parity", phase_sampler_parity)
    subs = first_subgraphs(m, batch)
    path_also = timed("path kernels", phase_path_kernels, m, rh, subs)
    staged_row = timed("staged-kernel", phase_staged_kernel, m, subs)
    del subs

    # --- the precision tiers: int8 training at k = TIER_K, its serving
    # under int8 and fp8, and the '+a4' tiers at k = A4_K ---
    cfg_t = cfg._replace(codebook=cfg.codebook._replace(k=TIER_K))
    m_t, cpu_t = copy.copy(m), copy.copy(cpu)
    m_t.cfg = cpu_t.cfg = cfg_t
    rt, tier_train_counts = timed("tier-train", phase_train, g, cfg_t,
                                  batch, TIER_PRECISION)
    params_t, vq_t, ost_t = rt["params"], rt["vq_states"], rt["opt_state"]
    tier_parity = {TIER_PRECISION: timed(
        "tier-train parity", phase_train_parity, m_t, params_t, vq_t, ost_t,
        cpu_t, f"tier-train parity {TIER_PRECISION}")}
    tier_parity["fp8"] = timed(
        "tier-train parity", phase_train_parity, m_t, params_t,
        quantize_vq_states(vq_t, cfg_t, precision="fp8"), ost_t, cpu_t,
        "tier-train parity fp8")
    tier_reps, tier_serve_counts, tier_servers = timed(
        "tier-serve", phase_tier_serve, g, cfg_t, params_t, vq_t, requests)
    cfg_a4 = cfg._replace(codebook=cfg.codebook._replace(k=A4_K))
    a4_reps, a4_counts, a4_servers = timed("a4-serve", phase_a4_serve, g,
                                           cfg_a4, requests)
    tier_rows = timed("tier kernels", phase_tier_kernels, m_t, params_t,
                      vq_t, {"int8": tier_servers["int8"],
                             "fp8": tier_servers["fp8"],
                             "int8+a4": a4_servers["int8+a4"],
                             "fp8+a4": a4_servers["fp8+a4"]})

    # --- the LM decode path: full-width serving, card vs CPU, kernels ---
    lm_rep, lm_counts, lm_kv, lm_cfg = timed("lm-serve", phase_lm_serve)
    lm_rep["parity"] = timed("lm-parity", phase_lm_parity)
    lm_rows = timed("lm-kernels", phase_lm_kernels, lm_kv, lm_cfg)
    del lm_kv
    torch.cuda.empty_cache()

    # --- GAT and the Graph Transformer, their codebooks on the wide build
    # of the vq_update / vq_assign scan ---
    cfg_g = cfg._replace(backbone="gat", heads=ATTN_HEADS)
    m_g, cpu_g = copy.copy(m), copy.copy(cpu)
    m_g.cfg = cpu_g.cfg = cfg_g
    rg, gat_train_counts = timed("gat-train", phase_attention_train, g,
                                 cfg_g, batch, "gat-train")
    params_g, vq_g, ost_g = rg["params"], rg["vq_states"], rg["opt_state"]
    rg0, gat_train_counts0 = timed(
        "gat-train", phase_attention_train, g,
        cfg_g._replace(grad_inject=False), batch, "gat-train without Eq. 7",
        True)
    gat_timing = timed("gat-train", phase_step_timing, m_g, params_g, vq_g,
                       ost_g)
    timed("gat-train profile", phase_train_profile, m_g, params_g, vq_g,
          ost_g)
    # the card-vs-CPU step and serving from the state trained with Eq. 7
    # off: with it on the logits grow to ~1e4 (the reference's too), and a
    # near-zero logit's rounding then exceeds any elementwise tolerance
    gat_parity = timed("gat-parity", phase_train_parity, m_g, rg0["params"],
                       rg0["vq_states"], rg0["opt_state"], cpu_g,
                       "gat-parity", False, PARITY_BATCH, True)
    server_g = serve_gnn.GNNServer(g, cfg_g, rg0["params"],
                                   rg0["vq_states"], BATCH, device=DEVICE)
    gat_rep, gat_serve_counts = timed("gat-serve", phase_attention_serve,
                                      server_g, requests, "gat-serve")
    timed("gat-serve", phase_cpu_parity, server_g, requests,
          "gat-serve cpu parity")
    del server_g
    t = time.time()
    g_r = synthetic_arxiv(n=TRANSFORMER_N, seed=SEED)
    cfg_r = paper_config(g_r, full_scale=True)._replace(
        backbone="transformer", heads=ATTN_HEADS)
    batch_r = paper_batch_size(g_r)
    m_r = Model(g_r, cfg_r, batch_r, torch.device(DEVICE))
    cpu_r = Model(g_r, cfg_r, TRANSFORMER_PARITY_BATCH, "cpu")
    seconds["transformer setup"] = time.time() - t
    rr, tr_train_counts = timed("transformer-train", phase_attention_train,
                                g_r, cfg_r, batch_r, "transformer-train")
    params_r, vq_r, ost_r = rr["params"], rr["vq_states"], rr["opt_state"]
    rr0, tr_train_counts0 = timed(
        "transformer-train", phase_attention_train, g_r,
        cfg_r._replace(grad_inject=False), batch_r,
        "transformer-train without Eq. 7")
    # the learning gate: at depth 1 the reference's Transformer learns
    rr1, tr_train_counts1 = timed(
        "transformer-train", phase_attention_train, g_r,
        cfg_r._replace(n_layers=1), batch_r, "transformer-train depth 1",
        True)
    tr_timing = timed("transformer-train", phase_step_timing, m_r,
                      params_r, vq_r, ost_r)
    timed("transformer-train profile", phase_train_profile, m_r, params_r,
          vq_r, ost_r)
    tr_parity = timed("transformer-train parity", phase_train_parity, m_r,
                      rr0["params"], rr0["vq_states"], rr0["opt_state"],
                      cpu_r, "transformer-train parity", False,
                      TRANSFORMER_PARITY_BATCH, True, True)
    server_r = serve_gnn.GNNServer(g_r, cfg_r, rr0["params"],
                                   rr0["vq_states"], BATCH, device=DEVICE)
    requests_r = serve_gnn.make_requests(g_r.n, REQUESTS, MAX_REQUEST, SEED)
    tr_rep, tr_serve_counts = timed("transformer-serve",
                                    phase_attention_serve, server_r,
                                    requests_r, "transformer-serve")
    timed("transformer-serve", phase_cpu_parity, server_r, requests_r,
          "transformer-serve cpu parity")
    wide_also = timed("wide-kernels", phase_wide_kernels,
                      (m_g, params_g, vq_g), (m_r, params_r, vq_r),
                      server_r)
    del server_r

    # --- the link task on an ogbl-collab look-alike (SAGE at the paper's
    # width), then the host-stepped loops on the arxiv model ---
    t = time.time()
    g_l = synthetic_collab(n=LINK_N, seed=LINK_SEED)
    cfg_l = paper_config(g_l, "sage", full_scale=True)
    batch_l = paper_batch_size(g_l)
    m_l = Model(g_l, cfg_l, batch_l, torch.device(DEVICE))
    cpu_l = Model(g_l, cfg_l, PARITY_BATCH, "cpu")
    seconds["link setup"] = time.time() - t
    log(f"link setup: {g_l.n} nodes, {g_l.m} message edges "
        f"({len(g_l.train_edges)} positive pairs), {len(g_l.val_edges)} val "
        f"/ {len(g_l.test_edges)} test positives and as many negatives, "
        f"deg_cap {m_l.plan.nbr_ids.shape[1]}, config {cfg_l}, training "
        f"batch {batch_l} in {seconds['link setup']:.2f} s")
    rl, link_train_counts = timed("link-train", phase_link_train, m_l)
    link_timing = timed("link-train", phase_link_timing, m_l, rl["params"],
                        rl["vq_states"], rl["opt_state"])
    rlf, link_full_counts = timed("link-full", phase_link_full, m_l)
    rls, link_sampler_counts = timed("link-sampler", phase_link_sampler, m_l)
    link_parity = timed("link-parity", phase_train_parity, m_l,
                        rl["params"], rl["vq_states"], rl["opt_state"],
                        cpu_l, "link-parity")
    link_also = timed("link-kernels", phase_link_kernels, m_l, rl["params"],
                      rl["vq_states"])
    del cpu_l
    host_rep, host_counts = timed("host-loop", phase_host_loop, m)

    # --- the dispatch layer: the context loop, the L2 budget, the tuner,
    # and the rest of the VQ core (counted apart from the main paths) ---
    dispatch_rep, dispatch_also = timed(
        "dispatch", phase_dispatch, m, params, vq, ost, cpu, server,
        (m_l, rl["params"], rl["vq_states"]), (m_t, params_t, vq_t),
        (m_g, params_g, vq_g))
    del m_l

    # --- the multi-device paths: one NCCL rank here, two gloo ranks on
    # the one card, the sharded serving CLI ---
    mesh_rep = {}
    mesh_rep["one_rank"], mesh_counts_a = timed(
        "mesh", phase_mesh_one_rank, m)
    mesh_rep["ranks"], mesh_counts_b = timed("mesh", phase_mesh_ranks, g,
                                             batch)
    mesh_rep["serve"] = timed("mesh", phase_mesh_serve)
    mesh_rep["launches"] = {
        k: v for k, v in add_counts(mesh_counts_a, mesh_counts_b).items()
        if k not in KEYED and v}
    log(f"mesh paths' launches (both ranks of (b) added): "
        f"{mesh_rep['launches']}")

    # --- LM training and prefill at llama3.2-3b's full width (no
    # hand-written kernel on these paths, as in the reference) ---
    del server, tier_servers, a4_servers, m_t, m_g, m_r
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm-train: {torch.cuda.memory_allocated()} bytes held on the card "
        f"by the earlier phases")
    lm_train_rep, lm_ckpt_rep = timed("lm-train", phase_lm_train)
    ckpt_s = lm_ckpt_rep["save_s"] + lm_ckpt_rep["restore_s"]
    seconds["lm-train"] -= ckpt_s
    seconds["lm-checkpoint"] = ckpt_s
    log(f"phase lm-train without its checkpoint: {seconds['lm-train']:.2f} s")
    lm_prefill_rep = timed("lm-prefill", phase_lm_prefill)
    lm_train_parity = timed("lm-train-parity", phase_lm_train_parity)
    lm_ckpt_rep["drill"] = timed("lm-checkpoint", phase_lm_drill)

    # --- the moe, ssm and hybrid LM families: serving, prefill, training
    # and card-vs-CPU parity (their attention on vq_attention) ---
    gc.collect()
    torch.cuda.empty_cache()
    fam_rep, fam_counts, fam_rows = timed("families-serve",
                                          phase_families_serve)
    fam_train = timed("families-train", phase_families_train)
    fam_parity = timed("families-parity", phase_families_parity)
    vq_row = lm_rows[0]
    vq_row["also"] += fam_rows
    vq_row["max_abs_err"] = max(vq_row["max_abs_err"],
                                *(r["max_abs_err"] for r in fam_rows))
    vq_row["launches_lm_families"] = fam_counts["vq_attention"]

    # --- the cross-attention LM families: whisper-tiny and
    # llama-3.2-vision-11b serving, prefill, training and parity ---
    gc.collect()
    torch.cuda.empty_cache()
    xa_rep, xa_counts, xa_rows = timed("xattn-serve", phase_xattn_serve)
    xa_train = timed("xattn-train", phase_xattn_train)
    xa_parity = timed("xattn-parity", phase_xattn_parity)
    xa_s = sum(seconds[k] for k in ("xattn-serve", "xattn-train",
                                    "xattn-parity"))
    log(f"the cross-attention families' phases: {xa_s:.2f} s")
    vq_row["also"] += xa_rows
    vq_row["max_abs_err"] = max(vq_row["max_abs_err"],
                                *(r["max_abs_err"] for r in xa_rows))
    vq_row["launches_lm_xattn"] = xa_counts["vq_attention"]

    # --- the LM mesh: four gloo ranks sharing the card, the fake-rank
    # dry-run and the roofline on the host ---
    lm_mesh = timed("lm-mesh", phase_lm_mesh)

    # --- the static contract checker, its launches counted apart ---
    analysis_rep = timed("analysis", phase_analysis)

    # --- launches on the main paths, and the kernels line ---
    launches = train_counts
    link_counts = add_counts(add_counts(link_train_counts, link_full_counts),
                             link_sampler_counts)
    for c in (serve_counts, sampler_counts, hybrid_counts, tier_train_counts,
              tier_serve_counts, a4_counts, lm_counts, gat_train_counts,
              gat_train_counts0, gat_serve_counts, tr_train_counts,
              tr_train_counts0, tr_train_counts1, tr_serve_counts,
              link_counts, host_counts, mesh_counts_a, mesh_counts_b,
              fam_counts, xa_counts):
        launches = add_counts(launches, c)
    entries = launches["entries"]
    by_name = {row["name"]: row for row in serve_rows + train_rows}
    by_name["spmm_ell"].setdefault("also", [])
    for also in (train_also, path_also):
        for name, extra in also.items():
            by_name[name]["also"] += extra
    for name, extra in tier_rows.items():
        by_name[name]["also"] += extra
    for name, extra in wide_also.items():
        by_name[name]["also"] += extra
    by_name["spmm_ell_hbm"] = staged_row
    for c in staged_row["also"]:
        if "form" in c:          # the quantized forms: no main-path caller
            c["launches"] = launches["spmm_ell_hbm_q"]
    # the link paths' shapes, each with its form's launches on those paths
    link_form = {"vq_update": link_counts["vq_update"],
                 "spmm_ell": link_counts["spmm_ell"],
                 "spmm_ell_t": link_counts["spmm_ell_t"],
                 "spmm_ell_hbm": link_counts["spmm_ell_hbm"]}
    for name, extra in link_also.items():
        for c in extra:
            c["launches_link_paths"] = link_form.get(name) \
                if name != "context_ell" else link_counts["entries"].get(
                    "repro_context_ell_wt_f32_i32" if c.get("form") == "w_t"
                    else "repro_context_ell_f32_i32", 0)
        by_name[name]["also"] += extra
    for name, extra in dispatch_also.items():
        by_name[name]["also"] += extra
    kernels = [by_name[n] for n in ("vq_assign", "spmm_ell", "spmm_ell_hbm",
                                    "spmm_ell_t", "context_ell",
                                    "vq_update")] + lm_rows
    # each row and form with its own count: the top rows are the f32 /
    # int32-emit forms, the quantized forms sit under ``also``
    form_launches = {
        "vq_assign": launches["vq_assign"] - launches["vq_assign_wide"],
        "spmm_ell": launches["spmm_ell"] - launches["spmm_ell_q"],
        "spmm_ell_hbm": launches["spmm_ell_hbm"] - launches["spmm_ell_hbm_q"],
        "spmm_ell_t": launches["spmm_ell_t"],
        "context_ell": entries.get("repro_context_ell_f32_i32", 0),
        "vq_update": launches["vq_update"] - launches["vq_update_u8"]
        - launches["vq_update_wide"],
        "vq_attention": launches["vq_attention"],
        "flash_attention": launches["flash_attention_tc"]}
    for row in kernels:
        row["launches"] = form_launches[row["name"]]
        # flash_attention is on no main path (the reference's models call
        # gqa_attend): held against its plain version only
        if row["launches"] < 1 and "main_path" not in row:
            raise SystemExit(f"{row['name']} never launched on the main path")
        if row["name"] in ("vq_update", "vq_assign"):
            # every wide-build launch of the main paths, by operand shape
            row["wide_launches_by_shape"] = {
                key: v for key, v in sorted(launches["shapes"].items())
                if key.startswith(row["name"] + " ")}
        for c in row.get("also", []):
            form = c.get("form", "")
            if row["name"] == "spmm_ell_hbm":
                continue
            if "shape" in c:     # a wide form: the launches at its shape
                c["launches"] = launches["shapes"].get(c["shape"], 0)
            elif "entry" in c:
                c["launches"] = entries.get(c["entry"], 0)
            elif form == "w_t":
                c["launches"] = entries.get("repro_context_ell_wt_f32_i32", 0)
            elif form.startswith("q "):
                c["launches"] = launches["spmm_ell_q"]
            elif form == "uint8 emit":
                c["launches"] = launches["vq_update_u8"]
            elif form in ("tc route", "fma route"):
                route = form.split()[0]
                c["launches"] = launches[f"flash_attention_{route}"]
    for entry in ("repro_context_ell_wt_f32_i32", "repro_context_ell_i8_u8",
                  "repro_context_ell_wt_i8_u8", "repro_context_ell_f8_u8",
                  "repro_context_ell_i8_a4", "repro_context_ell_f8_a4"):
        if entries.get(entry, 0) < 1:
            raise SystemExit(f"{entry} never launched on the main paths")
    log(f"main-path launches by context_ell entry: {entries}")

    log(json.dumps({"train": {
        "steps": int(r["step_losses"].shape[0]), "batch": batch,
        "wall_s": r["wall_s"], "epoch_s": r["epoch_s"],
        "epoch_loss": r["epoch_loss"], "epoch_vq_err": r["epoch_vq_err"],
        "step_loss": r["step_losses"].tolist(),
        "largest_cluster_share": r["largest_cluster_share"],
        "history": r["history"], "final": r["final"], **{k: timing[k] for k in (
            "step_p50_ms", "step_p99_ms", "step_ms")},
        "parity": parity}}))
    log(json.dumps({"sampler_train": sampler_reps,
                    "sampler_parity": sampler_parity}))
    log(json.dumps({"hybrid_train": {
        "steps": int(rh["step_losses"].shape[0]), "wall_s": rh["wall_s"],
        "epoch_s": rh["epoch_s"], "epoch_loss": rh["epoch_loss"],
        "epoch_vq_err": rh["epoch_vq_err"],
        "largest_cluster_share": rh["largest_cluster_share"],
        "history": rh["history"], "final": rh["final"],
        "parity": hybrid_parity}}))
    log(json.dumps({"tier_train": {
        "precision": TIER_PRECISION, "k": TIER_K, "wall_s": rt["wall_s"],
        "epoch_s": rt["epoch_s"], "epoch_loss": rt["epoch_loss"],
        "epoch_vq_err": rt["epoch_vq_err"],
        "largest_cluster_share": rt["largest_cluster_share"],
        "history": rt["history"], "final": rt["final"],
        "mem_bytes": rt["mem_bytes"], "parity": tier_parity}}))
    keep = ("refresh_s", "warmup_s", "nodes", "requests", "steps", "wall_s",
            "nodes_per_s", "step_p50_ms", "step_p99_ms", "request_p50_ms",
            "request_p99_ms")
    log(json.dumps({"serve": {k: rep[k] for k in keep + ("vq_state_bytes",)},
                    "build_s": build_s}))
    log(json.dumps({"tier_serve": {
        f"{t} k={TIER_K}": {k: v for k, v in x.items()
                            if k in keep + ("agreement", "vq_state_bytes")}
        for t, x in tier_reps.items()} | {
        f"{t} k={A4_K}": {k: v for k, v in x.items()
                          if k in keep + ("vq_state_bytes",)}
        for t, x in a4_reps.items()}}))
    log(json.dumps({"lm_serve": lm_rep}))
    for tag, r_, r0_, r1_, tim, par, srv in (
            ("gat", rg, rg0, None, gat_timing, gat_parity, gat_rep),
            ("transformer", rr, rr0, rr1, tr_timing, tr_parity, tr_rep)):
        depth_1 = {} if r1_ is None else {"depth_1": {
            "epoch_loss": r1_["epoch_loss"], "final": r1_["final"]}}
        log(json.dumps({f"{tag}_train": {
            "steps": int(r_["step_losses"].shape[0]), "wall_s": r_["wall_s"],
            "epoch_s": r_["epoch_s"], "epoch_loss": r_["epoch_loss"],
            "epoch_vq_err": r_["epoch_vq_err"],
            "largest_cluster_share": r_["largest_cluster_share"],
            "history": r_["history"], "final": r_["final"],
            "without_eq7": {"epoch_loss": r0_["epoch_loss"],
                            "final": r0_["final"]}, **depth_1,
            **{k: tim[k] for k in ("step_p50_ms", "step_p99_ms")},
            "parity": par}, f"{tag}_serve": {k: srv[k] for k in keep}}))
    log(json.dumps({"link_train": {
        "steps": int(rl["step_losses"].shape[0]), "batch": batch_l,
        "wall_s": rl["wall_s"], "epoch_s": rl["epoch_s"],
        "pack_s": rl["pack_s"], "epoch_loss": rl["epoch_loss"],
        "epoch_vq_err": rl["epoch_vq_err"], "chance": rl["chance"],
        "largest_cluster_share": rl["largest_cluster_share"],
        "history": rl["history"], "final": rl["final"],
        **{k: link_timing[k] for k in (
            "iter_p50_ms", "iter_p99_ms", "pack_p50_ms", "step_p50_ms",
            "step_p99_ms", "device_busy_share")},
        "parity": link_parity},
        "link_full": {"wall_s": rlf["wall_s"],
                      "losses": rlf["step_losses"].tolist(),
                      "final": rlf["final"]},
        "link_sampler": {"wall_s": rls["wall_s"], "losses": [
            ls.tolist() for ls in rls["losses"]], "sample_s": rls["sample_s"],
            "pack_s": rls["pack_s"], "train_s": rls["train_s"],
            "subgraph_rows": rls["subgraph_rows"], "final": rls["final"]},
        "host_loop": host_rep}))
    log(json.dumps({"dispatch": dispatch_rep}))
    log(json.dumps({"mesh": mesh_rep}))
    log(json.dumps({"lm_train": lm_train_rep}))
    log(json.dumps({"lm_prefill": lm_prefill_rep}))
    log(json.dumps({"lm_train_parity": lm_train_parity}))
    log(json.dumps({"lm_checkpoint": lm_ckpt_rep}))
    log(json.dumps({"lm_families_serve": fam_rep}))
    log(json.dumps({"lm_families_train": fam_train}))
    log(json.dumps({"lm_families_parity": fam_parity}))
    log(json.dumps({"lm_xattn_serve": xa_rep}))
    log(json.dumps({"lm_xattn_train": xa_train}))
    log(json.dumps({"lm_xattn_parity": xa_parity}))
    log(json.dumps({"lm_mesh": lm_mesh}))
    log(json.dumps({"analysis": analysis_rep}))
    seconds["total"] = time.time() - T_START
    log(json.dumps({"seconds": seconds}))
    log(f"chip_smoke: {seconds['total']:.1f} s from start to the "
        f"result lines, the kernels' build included")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: r[k] for k in r if k not in keys}} for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
