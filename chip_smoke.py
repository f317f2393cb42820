#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line:

1. card: its name and power limit, as nvidia-smi reports them.
2. build: the seven CUDA kernel libraries, compiled by nvcc for sm_90a
   from the sources in this checkout (one nvcc per source, in parallel);
   ptxas's register and spill report of each, and the tensor-core
   instructions in the prefill kernels' SASS (cuobjdump): dense HMMA and
   the sparse HMMA.SP that the sparse path runs; and in the bf16
   bs_attention kernel's (HMMA.*BF16). A line for each of that kernel's
   instantiations, <128, 128> and MLA's <192, 128> (dk, dv), with its
   registers, spills (none allowed at <192, 128>), shared memory per CTA
   and CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at
   G' = 1 and 2 q heads a CTA, and the f32 kernel's at dk 128 and 192.
   The gather kernels' SASS must hold no tensor-core instruction, and a
   line per tile of GATHER_SHAPES gives
   its shared memory per CTA and CTAs per SM. A line per decode kernel
   instantiation (x type, value type, rows) gives its registers, spills
   (local memory, which must be 0), shared memory per CTA and CTAs per SM
   (cudaFuncGetAttributes, the occupancy call), which must equal the
   host's padding.decode_smem / decode_ctas_per_sm; the decode
   libraries' SASS must hold one kernel a call (no finishing pass).
3. kernels: each kernel against its plain PyTorch version at the GEMM
   shapes of full-width yi-9b (K x N = 4096x4096, 4096x512, 4096x11008,
   11008x4096; M = 512 for prefill, M = 4 for decode with and without
   bias + SiLU; x in bf16 and f32; in bf16 also M = 1 and 8 at wk/wv and
   w_up/w_gate, and nm_spmm at the train phase's M = 2048 at every
   shape), within the stated tolerance, each decode case with its
   launch from the host rule (padding.decode_plan: columns a CTA, splits,
   CTAs) and two calls bit-identical (the fixed-order split-K sum). The
   float kernels take vals in x's dtype, the int8 kernels int8 vals and
   f32 scales from quantize_nm of the same random 2:4 weights. Integer-
   lattice cases per shape must be bit-exact (f32 x for the float
   kernels; f32 and bf16 x for the int8 kernels). Times (CUDA events, L2
   flushed before every launch) of the kernel, its plain version and
   torch.matmul on the decompressed dense weight (for int8: the int8
   weight cast to x's dtype, exact; the matmul alone, without the scale
   multiply); the bound. Then nm_spmm and nm_spmm_q in f32 (the dense
   3xTF32 path the CNNs run) at two ResNet-50 GEMMs of batch 8
   (s2b1_3x3 M 25088 K 576 N 64, s4b1_3x3 M 1568 K 2304 N 256), timed
   against their plain versions and torch.matmul in f32 (TF32 off).
4. reference: reduced yi-9b in f32 on the card, with f32 weights and
   then with int8 weights (quantize="int8"): logits through the kernels
   against logits through the reference (prefill and decode).
5. serve: full-width yi-9b (48 layers, random 2:4 weights from seed 0,
   bf16 activations) serves 8 requests through ServeEngine (4 slots,
   prefill 128, 32 new tokens each), first with bf16 weights, then, the
   bf16 model freed, with int8 weights. The engine captures its prefill
   and its decode step once each as CUDA graphs and replays them. Launch
   counts and dispatch counts are zeroed just before each serve and read
   just after, each graph's capture counts multiplied by its replays
   (``serving.engine.ran_counts``: the counters are Python and do not
   run on replay); the kernels of that path must have launched, the
   other family's kernels not, and the reference must have run zero
   times, nor been captured; every prefill launch must have run the
   sparse (mma.sp) path; one graph a step kind, holding one launch a
   compressed Linear (336). Then the same requests through the same
   engine run eagerly (no graphs): equal greedy streams. ITL p50 / p99,
   TTFT and tok/s of both beside the ITL floor (the bytes of the
   weights a decode step reads at HBM rate), and the card time of one
   decode-graph and one prefill-graph replay (CUDA events; the card is
   busy for all of it).
6. gather: the gather kernels (the paper's Algorithm 3) against their
   plain versions at four ResNet-50 layer GEMMs in the paper's
   orientation (s2b1_3x3 Mr 64 K 576 Nc 3136, s4b1_3x3 256 x 2304 x 196,
   s5b1_1x1b 2048 x 512 x 49, s5b1_3x3 512 x 4608 x 49, the deepest
   split), at 1:4 and 2:4, B in f32 and bf16 (vals in B's dtype; the
   int8 kernel with int8 vals and per-row scales), each with its launch
   from the host rule (tile, K steps, splits), two calls bit-identical
   (the fixed-order split-K sum), and bit-exact on the integer lattice;
   times of the kernel, its plain version and torch.matmul of the
   decompressed f32 A and f32 B; the bound.
7. cnn: full-width ResNet-50 and DenseNet-121 (224x224, batch 8, random
   2:4 weights from seed 0, f32), with f32 and then int8 conv weights,
   kernels on (policy "auto"). Counts are zeroed just before one forward
   and read just after: 52 (ResNet-50) or 119 (DenseNet-121) prefill
   kernel calls, all on the dense (3xTF32) path, no reference and no
   decode call. Then the forward captured as a CUDA graph
   (``SparseCNN.graphed``; counts zeroed before its first call): the
   graph holds the same 52 / 119 launches and no reference dispatch,
   and its replayed logits are bit-equal to the eager forward's. Logits
   through the kernels against logits through the plain path on the card
   (policy "off", the same weights), max|diff| <= 1e-3 * max|logits|;
   images/s and ms per forward, eager and graphed, peak memory.
8. sweep: every ResNet-50 layer GEMM (K rounded up to a multiple of m,
   the stem's 147 -> 148) at 1:4 and 2:4 in f32, as the JAX package's
   measured fig4 runs them: the conv-orientation nm_matmul kernel
   (patches (N, K) @ W (K, C_out)), Row-Wise-SpMM (Algorithm 2, plain
   torch), the gather kernels (Algorithm 3, f32 and int8), torch.matmul
   of the dense f32 A and f32 B (TF32 off; the yardstick) and the
   paper's cycle model's speedup. Counts are zeroed before an untimed
   pass over the 53 layers of a pattern and read after it: each kernel
   launched 53 times, no reference; then a timed pass, whose totals line
   gives the gather's worst factor against torch.matmul.
9. attention: the block-sparse attention kernel against masked_reference
   (the dense torch.where oracle) and against blocksparse_mma (the plain
   twin of the bf16 kernel's rounding), within TOL, at the full-width yi-9b
   shape (B 2, Sq = Skv = 1024, Hq 32, Hkv 4, head dim 128) for
   local(window 192, block 64) and causal(block 64), and at a ragged
   Sq = Skv = 1000 for strided(stride 4, block 64), a blockwise spec and
   local(window 192, block 128), in bf16 and f32. Times of the kernel,
   masked_reference, torch_bs_attention (the block-gather lowering, the
   kernel's plain version) and scaled_dot_product_attention with the
   plan's dense boolean mask (the yardstick, used nowhere in the port);
   the bound.
10. masked reference: reduced yi-9b in f32 with MaskSpec("local", block 8,
   window 12): prefill and decode logits through the kernel against the
   same weights with mask=None, window=12 (within 1e-4), and greedy
   streams equal to the dense-window engine's.
11. masked serve: full-width yi-9b (48 layers, bf16, random 2:4 weights
   from seed 0) with MaskSpec("local", block 64, window 192) on every
   block serves 4 requests of 1024 tokens, 16 new tokens each, 2 slots,
   prefill 1024. Counts zeroed just before and read just after: 48
   cuda_bs_attention dispatches per prefill, 48 masked_decode per decode
   step, no masked_reference or torch_bs_attention, the N:M kernels as
   in the serve phase (prefill all on the sparse path), through the
   captured graphs (counts as in phase 5). Then the prefill time against
   the same weights with mask=None, window=192 (for information), and
   the kernel's calls in one more masked prefill, each at the model's
   (dk, dv).
12. paged serve: full-width yi-9b (bf16) serves 8 requests whose prompts
   share their first 64 tokens through the paged engine: 4 slots,
   prefill 128 in chunks of 64, pages of 32 tokens, 16 pages in the pool
   (fewer than the 20 that 4 slots at 160 tokens need), 32 new tokens.
   Every request finishes, decode preempts at least once, the prefix
   cache serves at least one page, no reference dispatch; the greedy
   streams equal those of the slot engine with the same chunks (whose
   cache is as long: 5 x 32 = 160 tokens).

13. autotune: full-width yi-9b cut to 8 layers (bf16, random 2:4 weights
   from seed 0). The autotuner sweeps, into a cache file of its own in a
   temporary directory, the four projections at prefill M = 512 and
   decode M = 4 with bf16 and then int8 values (bf16 x), and the masked
   serve's bs_attention case (local block 64 window 192, Sq = Skv = 1024,
   B 2, 32 / 4 heads, dk 128): per shape the rule's launch and ms, the
   tuned launch and ms, and the bound; every candidate's output is held
   to the rule's (bit-equal on the integer lattice; attention within
   TOL). Then a graphed serve (the serve phase's requests) with
   ``autotune_blocks=True`` reading that file: the file unchanged (no
   sweep), no reference dispatch, the dispatch records naming the tuned
   blocks; and one prefill step's logits (a replay) within TOL of the
   same step with the rules' launches.
14. obs: the paged serve of phase 12 on that model, graphed, with
   observability on and then off: equal streams, one graph a step kind,
   a trace and metrics that ``python -m repro_torch.obs.check
   --require-subsystems engine,scheduler,paging,dispatch,autotune``
   passes, ``kernel_dispatch_total`` equal to what ran; ITL p50 on and
   off.
15. fp8 cache: on that model, one prefill (128 tokens, 4 slots) and one
   decode with an e4m3 KV cache against a bf16 one, on the slot path and
   the paged path (pages of 32), eagerly and through captured graphs
   (replayed): relative logit error below 0.15 (the JAX package's
   bound), top-1 equal in every row where the fp8 error cannot reorder
   bf16's top two (their margin above twice the row's largest logit
   change; random weights leave near-ties), cache bytes halved.
16. attention MLA: phase 9 at full-width deepseek-v2-lite-16b's MLA shape
   (B 2, Sq = Skv = 1024, Hq = Hkv = 16, dk 192, dv 128, scale 192^-0.5)
   for local(window 192, block 64) and causal(block 64), bf16 and f32.
17. deepseek kernels and reference: the four N:M kernels against their
   plain versions at every projection of full-width deepseek-v2-lite-16b
   (K x N = 2048x1408, 1408x2048 of the experts, 2048x2816, 2816x2048 of
   the shared FFN, 2048x3072 wq, 2048x512 wkv_a, 2048x64 wk_rope,
   2048x2048 wo, 2048x10944 and 10944x2048 of layer 0: a ragged K) at
   every M its serves give (prefill 2048, 512, 256, 240, 64, 32; decode 8,
   4, 2), x in bf16 and f32, float and int8 values, within TOL (their
   worst error joins the kernels line) and bit-exact on the integer
   lattice; then reduced deepseek-v2-lite-16b (MLA + MoE) in f32, f32 and
   then int8 weights: prefill and decode logits through the
   kernels against the reference (1e-4); with MaskSpec("causal", block
   8) on every MLA layer, masked logits equal the dense causal ones
   (1e-4), the prefill through cuda_bs_attention, the decode with the
   predicate inline.
18. deepseek serve: full-width deepseek-v2-lite-16b at full depth (27
   layers, 2:4 weights from seed 0, bf16) serves phase 5's requests
   through the captured steps: every request finishes in the vocabulary,
   no reference dispatch, one graph a step kind, and each graph holds one
   launch a compressed Linear (5,181: 27 x 4 MLA projections, layer 0's
   FFN, 26 x (64 experts x 3 + the shared FFN's 3), checked against the
   config's arithmetic); ITL, TTFT, tok/s beside the ITL floor (the
   weights' bytes at HBM rate: every expert, as the padded buffers run
   them all) and the routed floor (only the experts 4 tokens can route
   to, at most 4 x 6 a layer), and the card time of one decode-graph and
   one prefill-graph replay. The yi serve phases run this gate too (336).
19. deepseek, cut to 4 layers (layer 0 dense, 3 MoE layers; every GEMM
   and cache shape the full model's): phase 5 (graphed and eager, equal
   streams) with bf16 and with int8 weights; phase 12's paged engine
   against the slot engine with every MoE layer dropless (capacity
   factor E / k: equal streams, a preemption, prefix hits; at the
   config's 1.25 an expert keeps at most C of a step's assignments, so a
   preemption, which changes what shares a step, may change the tokens
   that follow); phase 15's fp8 cache; and phase 11's
   masked serve (2 slots, 1024-token prompts, 16 new tokens) whose
   prefill runs 4 cuda_bs_attention calls at dk 192, dv 128 (checked on
   the calls themselves) and whose decode dispatches nothing (MLA
   applies the mask inline).
20. train: full-width yi-9b cut to 8 layers (random 2:4 weights from
   seed 0, f32 weights, bf16 compute, AdamW lr 1e-3, warm-up 10 of 30
   steps, batch 8 x seq 256: nm_spmm at M = 2048) through
   ``launch/train.py``'s ``build_trainer`` and ``make_train_step``. Step
   1's loss and grad_norm through the kernels against the same step
   under policy "off" (TRAIN_TOL, no update); then 30 steps with the
   counts zeroed just before and read just after: every loss finite, the
   mean of the last 5 below that of the first 5, 56 nm_spmm launches a
   forward (8 layers x 7 projections), all on the sparse path, and no
   other dispatch (the backward is the reference composition in f32 and
   dispatches nothing). ms a step, tokens/s, one more step's forward /
   backward / optimizer split (CUDA events) and peak memory.
21. resilient: reduced yi-9b on the card (f32 weights, bf16 compute,
   kernels on) through ``run_resilient``, 8 steps, a checkpoint every 2,
   failures injected at steps 1, 4 and 5, against an uninterrupted run:
   the final loss, every parameter and both AdamW moments bitwise equal.
22. recurrent kernels: the four N:M kernels against their plain versions
   at every projection of full-width rwkv6-3b and jamba-v0.1-52b
   (RECURRENT_SHAPES, K x N: rwkv 2560x2560, 2560x8960, 8960x2560; jamba
   4096x16384 w_in, 8192x288 w_x, a ragged N, 8192x4096 w_out,
   4096x14336 / 14336x4096 of the FFNs and experts, 4096x4096 and
   4096x1024 of its attention) at the M its serves give (prefill 512 and
   the experts' capacity 80; decode 4 and the experts' 8), as phase 17
   (within TOL, lattice bit-exact); then each at prefill M = 512 and
   decode M = 4, bf16 x, bf16 and int8 values, timed beside its plain
   version, torch.matmul and the bound.
23. recurrent reference: reduced rwkv6-3b and jamba-v0.1-52b in f32, f32
   and int8 weights: prefill and 4 decode steps through the kernels
   against the reference (1e-4), as phase 4.
24. rwkv serve: full-width rwkv6-3b at full depth (32 layers, random 2:4
   weights from seed 0, bf16 activations) serves phase 5's requests,
   bf16 weights and then int8: phase 5's gates (graphed and eager,
   equal streams; 256 N:M launches a step in each graph; zero reference
   dispatches; the prefill on the sparse path), and each request served
   alone in a fresh engine gives its stream in the serve (the engine
   zeroes a slot's recurrent state at its prefill). Then the f32
   witness: the served model's prefill and 4 decode steps, through the
   kernels, under policy "off" in bf16 and under policy "off" in f32 on
   the same weights; every layer (on the kernel path's input) and the
   logits of every call through the kernels lie at most WITNESS_C times
   as far from f32 (root mean square over the output: a largest
   entry's distance halves or doubles with one rounding flip) as the
   plain bf16 path's (bf16 roundings grow through
   32 random recurrent layers, so the kernels are not held to the plain
   bf16 logits themselves). The ITL floor adds the WKV state and token
   shifts 4 slots read and write.
25. jamba serve: full-width jamba-v0.1-52b cut to one period (8 layers: 7
   Mamba, 1 attention, 4 MoE of 16 experts top-2, 4 FFN; bf16) as phase
   24 with every MoE layer dropless (229 N:M launches a step); then at
   the config's capacity factor 1.25, its streams counted against the
   dropless ones.
26. whisper reference: reduced whisper-medium in f32, f32 and then int8
   weights: the encoder's output, a prefill with random frames and 4
   decode steps (the cross K/V written at prefill, read at decode)
   through the kernels against policy "off" (1e-4), as phase 4. Then
   rows 1-4 at every projection shape of the new configs (WHISPER_SHAPES
   at M = 6000, the encoder's 4 x 1500 frames, and 512; GEMMA_SHAPES at
   2304, 768, 512 and decode 4, 2; GQA_SHAPES at 512 and 4), as phase
   17 (within TOL, lattice bit-exact), each timed at M = 512 and 4 beside
   its plain version, torch.matmul and the bound, and the whisper shapes'
   prefill kernels at M = 6000.
27. whisper serve: full-width, full-depth whisper-medium (24 encoder + 24
   decoder layers, d_model 1024, 16 heads of 64, GELU 4096, vocab
   51,865, 1500 frames; random 2:4 weights from seed 0), bf16 and then
   int8, served through ``make_serve_steps`` (``ServeEngine`` has no
   encoder input, as the JAX engine has none): 4 slots of 128-token
   prompts, each with random frames (4, 1500, 1024), 32 greedy tokens,
   through the captured prefill and decode graphs; then other prompts
   and frames through the same graphs (replayed), then both eagerly:
   equal streams. One graph a step kind; the prefill graph holds 384 N:M
   launches (encoder 24 x 6, decoder 24 x 10), the decode graph 192 (24
   x 8: the cross wk / wv do not run at decode); no reference dispatch;
   replay ms of both graphs, ms a token and the ITL floor (the decoder's
   weights, the f32 head and the 4 x 24 x 2 x 1500 x 1024 bf16 cross K/V
   a decode step reads, at HBM rate). Then the f32 witness at full depth
   (every encoder and decoder layer, each decoder layer on the kernel
   path's encoder output).
28. whisper train: full width and depth, f32 weights, bf16 compute,
   batch 4 of random frames (seed 0) and 128 text tokens, 12 steps, as
   phase 20: step 1 against policy "off" (TRAIN_TOL), the loss falls,
   384 nm_spmm launches a forward (the encoder's at M = 6000) and no
   reference dispatch; ms a step, tokens/s, peak memory.
29. gemma3 serve: full-width gemma3-27b at full depth (62 layers: 10 x (5
   local of window 1024, theta 1e4, + 1 global, theta 1e6) + 2 local;
   d_model 5376; GQA 32/16 of 128 with qk-norm; GeGLU 21,504; tied vocab
   262,144; bf16): the tied head against the f32 product (1e-4), timed;
   phase 5's requests, then 2 slots of 1152-token prompts with 16 new
   tokens (the window cuts positions in prefill and decode), each
   graphed and eagerly (equal streams, 434 N:M launches in each graph,
   no reference dispatch, peak memory). Then cut to 8 layers (a period
   and the tail): int8 weights through both request sets; bf16 through
   the paged engine with the long prompts (chunks of 384, pages of 32, a
   72-page pool: preemptions, prefix hits, streams equal to the slot
   engine's) and the f32 witness on 2 x 1152 prompts (a full-depth f32
   copy does not fit beside the bf16 model).
30. GQA configs: chameleon-34b, codeqwen1.5-7b and internlm2-20b at full
   width cut to 2 layers, bf16: phase 5's requests through the captured
   steps, the graphs holding one launch a compressed Linear, no
   reference dispatch.
31. shard and 236b shapes: rows 1-4 against their plain versions at the
   shapes a rank of the sharded serves runs (yi-9b's wq, wk / wv, wo,
   w_up / w_gate, w_down at tp 2 and 4: w_down at tp 4 is 2752 x 4096,
   Kc 1376, its ragged edge masked) and at full-width deepseek-v2-236b's
   (MLA wq_a 5120x1536, wq_b 1536x24576, wkv_a, wk_rope, wo 16384x5120,
   the experts' 5120x1536 / 1536x5120 at their capacity rows, the shared
   experts', layer 0's 5120x12288 / 12288x5120), within TOL, lattice
   bit-exact; then timed beside torch.matmul and the bound.
32. sharded serve f32: ShardedServeEngine on gloo ranks sharing the card
   (launch.mesh.spawn, start method spawn, a FileStore rendezvous) at
   meshes 1x2 and 2x2, full-width yi-9b cut to 4 layers, f32: the JAX
   package's sharded matrix (float 2:4, chunked, int8, the local mask on
   2 x 1024-token prompts, sampled at temperature 0.8, paged at 2x2)
   against the single-card ServeEngine: equal streams, last-position
   logits within 1e-4 * max|logits|, on every rank no reference dispatch
   and one N:M launch a compressed Linear a step at the shard's shapes;
   paged: one page sub-pool a data shard and prefix hits.
33. sharded serve bf16: full-width yi-9b cut to 12 layers
   (SHARDED_BF16), phase 5's requests at 1x2 and 2x2: every request
   finishes in the vocabulary, the f32 witness on the sharded logits
   (WITNESS_C against the single card's plain bf16 path), the launch
   gates; ITL p50, tok/s and peak memory of each rank beside the
   single-card eager engine's.
34. deepseek-v2-236b: full width cut to 1 dense + 3 MoE layers (21.5 GB
   bf16), served by one process through the captured steps, dropless
   (N:M launches a graph = its compressed Linears); then LM.forward under
   expert parallelism at 1x2 and 2x2 (a prefill of 4 x 128 and 4 decode
   steps), each rank making only its 80 or 160 / model experts: its
   launches only its own experts' GEMMs, the logits through the f32
   witness against the single process's, the aux within 1e-3; the drops
   at capacity factor 1.25 printed.
35. sharded train: full-width yi-9b cut to 1 layer (random 2:4 weights
   from seed 0, f32 weights), batch 8 x 256 from the data pipeline,
   TRAIN's lr and warmup, on gloo ranks sharing the card
   (training.sharded through launch.sharded.train_rank). f32 compute,
   TF32 off, 3 steps at 2x1, 1x2, 2x2 "fsdp" and 2x2 "tp_only": every
   rank's loss, nll, lr and grad_norm within 1e-5 of the single process's
   steps on the card, and its slices of both moments and every parameter
   within 2e-5 of the single process's state after step 3 (kept whole
   in host shared memory, launch.sharded.Reference, each rank copying
   out its regions; at most 2 entries
   a rank in AdamW's eps regime beyond 2e-5, none beyond 8e-5,
   SHARDED_TRAIN_TOL); on each rank of 2x2 fsdp step 1 through the
   kernels within TRAIN_TOL of policy "off"; on every rank one nm_spmm
   launch a compressed Linear a forward and no reference dispatch. bf16
   compute at 2x2 fsdp, 12 steps: every loss finite, the last 5 below
   the first 5; ms a step, tokens/s and peak a rank beside
   the single process's. Elastic resume: the 2x2 run's state saved whole
   at step 2 resumes at 1x2 (step 3 within the f32 tolerances of the
   uninterrupted run and the single process) and restores in one
   process (its step 3 within 1e-5 of the single process's).
36. moe/recurrent/encoder-decoder sharded train: full-width rwkv6-3b
   cut to 2 layers, deepseek-v2-lite-16b to its dense layer 0 and its
   first MoE layer (64 experts top-6, 2 shared, MLA), jamba-v0.1-52b to
   its period's layers 3 (Mamba + MoE of 16 x 14336) and 4 (GQA + FFN) and
   whisper-medium to its encoder's and decoder's blocks 0 and 1
   (TRAIN_CUTS; random 2:4 weights from seed 0, f32 weights and
   compute, TF32 off), batch 4 x 64 (whisper's with 4 x 1500 random
   frames from FRAMES_SEED), 2 steps on gloo ranks sharing the card
   under the training plan (train_tp_plan: the MoE expert-parallel,
   Mamba's d_inner, RWKV's heads, the encoder's and the cross blocks'
   heads tensor-parallel) at 1x2 and 1x4 against one process on the
   whole batch and at 2x2 fsdp against one process running each data
   shard's rows on its own (make_shardwise_train_step: the MoE's
   capacity and aux per data shard, as JAX's expert-parallel MoE
   computes them; whisper's against the whole batch's, the same
   function without an MoE): every rank's loss, nll, aux and lr of both steps
   and grad_norm of step 1 within 1e-5 of the reference's (step 2's
   grad_norm within 1e-2), its slices of both moments and every
   parameter after step 1 within 2e-5 of the reference's (every 4th
   entry of a last dim, REFERENCE_EVERY, in host shared memory: whole,
   they would not all fit the host beside the ranks, and three at a
   time took the phase past 500 s), AdamW's eps
   regime held by what its two sides' moments do not
   explain, at most 2 entries a rank beyond 2e-5 and none beyond 8e-5
   (MOE_RECURRENT_TOL: SHARDED_TRAIN_TOL); the distance of the whole
   batch's one process from the shard-wise one printed beside; on each
   rank of every 2x2 run step 1 through the kernels within TRAIN_TOL of
   policy "off"; on every rank one nm_spmm launch a compressed Linear a
   forward (its own experts' only; whisper's 2 x 6 + 2 x 10 = 32) and
   no reference dispatch; deepseek's and whisper's 2x2 states saved
   whole after step 1 resume at 1x2 (whisper's step 2 within the
   tolerances of the whole batch's), and deepseek's restored in one
   process gives the uninterrupted 2x2 run's shard-wise step 2 and the
   resumed 1x2 run's whole-batch step 2; ms a step by part, tokens/s
   and peak a rank beside one process's.
37. dry-run against the card: the dry-run layer (``launch.specs``,
   ``roofline.step_cost``) held to what the card just did. (a) Gates:
   yi-9b's serve cell (phase 5's depth, slots and cache length) made on
   a 1 x 1 ``MetaMesh`` dispatches the N:M GEMMs a decode step of phase
   5 launched (336); its meta model's and cache's bytes equal those of
   the model and engine built on the card, and its
   ``argument_size_in_bytes`` is within 1 % of the card's
   ``memory_allocated()`` growth over building them; phase 20's 8-layer
   f32 train cell: params + AdamW's m and v likewise; the bounds of the
   kernels line, now from ``core.cost_model``, equal BOUNDS_BEFORE.
   (b) Printed: the model FLOPs of phase 5's decode step and phase 20's
   train step over their measured times, as a share of the bf16 peak,
   beside the card's name and power limit, and the dry-run's bound of
   each step. (c) Printed: the single-mesh production rows
   (``roofline.report.fmt_table``) of DRYRUN_ARCHS, made on the host by
   a process started after the build (``launch.dryrun``, no card).
Each of phases 26-37 prints its seconds ("phase seconds"). A rank that
fails or hangs fails the run: its spawn raises, the ranks left are
killed.
The autotune cache of every phase is a file in a temporary directory
(``REPRO_TORCH_AUTOTUNE_CACHE``), removed at the end.

Then one JSON line naming the kernels, then the result line. A kernel's
``launches`` there is what ran on the card in the serves of yi-9b
(phase 5), rwkv6-3b and jamba (phases 24-25), whisper, gemma3 and the
GQA configs (phases 27, 29, 30), the ranks of the sharded serves and
the expert-parallel forwards (phases 32-34, every rank's launches
summed), the ranks' sharded train steps (phases 35-36) and the sweep and
masked serve (phases 8, 11): the launches of steps run eagerly plus,
for each captured graph, the launches it holds times its replays: the
count an eager serve gives. nm_spmm's launches on the single-process
train path are printed on a line of their own before it.
"""
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SHAPES = {  # projection -> (K, N) of full-width yi-9b
    "wq/wo": (4096, 4096),
    "wk/wv": (4096, 512),
    "w_up/w_gate": (4096, 11008),
    "w_down": (11008, 4096),
}
PREFILL_M, DECODE_M = 512, 4
# bf16 decode cases also timed at these M, beside DECODE_M
DECODE_M_SWEEP = {"wk/wv": (1, 8), "w_up/w_gate": (1, 8)}
# stated tolerance (rtol = atol) of kernel vs plain version: both sum in
# f32, in other orders; bf16 outputs round those sums and may differ by
# one bf16 step (2^-7 relative)
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
SERVE = dict(layers=48, requests=8, slots=4, prefill_len=128, max_new=32)
REPORTED = "w_up/w_gate"  # the shape whose numbers the kernels line carries
# the bounds (ms) the kernels line carried before the rates moved into
# repro_torch.core.cost_model: the same seeded data gives the same bounds
BOUNDS_BEFORE = {"nm_spmm": 0.024805865074626867,
                 "nm_spmm_decode": 0.020225069850746267,
                 "nm_spmm_q": 0.023342127627906977,
                 "nm_spmm_decode_q": 0.013508546865671642,
                 "indexmac_gather": 0.0024239761194029853,
                 "indexmac_gather_q": 0.0024075462686567167,
                 "bs_attention": 0.011339195223880598}
# phase 37: the production cells printed, and the argument bytes' limit
DRYRUN_ARCHS = ("yi-9b", "deepseek-v2-236b")
DRYRUN_TOL = 0.01
# what the phases measured that phase 37 reads, by the phase's ``what``
MEASURED: dict = {}
KERNELS = ("nm_spmm", "nm_spmm_decode", "nm_spmm_q", "nm_spmm_decode_q",
           "indexmac_gather", "indexmac_gather_q", "bs_attention")
# ResNet-50 layer GEMMs of the gather phase: name -> (Mr, K, Nc), paper
# orientation C = A_sp @ B; the first, at 2:4 with f32 B, is reported
GATHER_SHAPES = {
    "s2b1_3x3": (64, 576, 3136),
    "s4b1_3x3": (256, 2304, 196),
    "s5b1_1x1b": (2048, 512, 49),
    "s5b1_3x3": (512, 4608, 49),
}
CNN = dict(batch=8, iters=5)
# block-sparse attention: (B, Hq, Hkv, head dim) of full-width yi-9b; the
# masks, each with its Sq = Skv; the first, in bf16, is reported
ATTN_HEADS = (2, 32, 4, 128)
ATTN_CASES = (
    (1024, dict(kind="local", block=64, window=192)),
    (1024, dict(kind="causal", block=64)),
    (1000, dict(kind="strided", block=64, stride=4)),
    (1000, dict(kind="blockwise", block=64, blocks=tuple(
        (i, j) for i in range(16) for j in {0, i, max(i - 3, 0)}))),
    (1000, dict(kind="local", block=128, window=192)),
)
MASKED_SERVE = dict(layers=48, requests=4, slots=2, prefill_len=1024,
                    max_new=16)
PAGED_SERVE = dict(layers=48, requests=8, slots=4, prefill_len=128,
                   prefill_chunk=64, page_size=32, pool_pages=16,
                   max_new=32, shared_prefix=64)
# dispatches of one full-width forward: every conv but the dense stem
CNN_DISPATCHES = {"resnet50": 52, "densenet121": 119}
# ResNet-50 layer GEMMs at batch 8 in the conv orientation, timed in f32
# on the prefill kernels: name -> (M, K, N)
CNN_GEMMS = {"s2b1_3x3": (25088, 576, 64), "s4b1_3x3": (1568, 2304, 256)}
PREFILL = ("nm_spmm", "nm_spmm_q")
# the autotune, obs and fp8 phases: full-width yi-9b cut to this depth
TUNED = dict(layers=8)
# the tuned bs_attention case: the masked serve's prefill
TUNED_ATTN = dict(spec=dict(kind="local", block=64, window=192), s=1024,
                  dk=128, heads=(32, 4), batch=2)
FP8 = dict(slots=4, prefill_len=128, page_size=32)
DEEPSEEK = "deepseek-v2-lite-16b"
# MLA-shaped block-sparse attention: (B, Hq, Hkv, dk, dv) of full-width
# deepseek-v2-lite-16b (per-head K = [nope 128 | rope 64], V 128), the masks
# of the masked deepseek serve and of JAX's mla-causal test at full width
MLA_ATTN_HEADS = (2, 16, 16, 192, 128)
MLA_ATTN_CASES = ATTN_CASES[:2]
# projection -> (K, N) of full-width deepseek-v2-lite-16b's N:M GEMMs
DS_SHAPES = {
    "expert up/gate": (2048, 1408),
    "expert down": (1408, 2048),
    "shared up/gate": (2048, 2816),
    "shared down": (2816, 2048),
    "wq": (2048, 3072),
    "wkv_a": (2048, 512),
    "wk_rope": (2048, 64),
    "wo": (2048, 2048),
    "layer 0 up/gate": (2048, 10944),
    "layer 0 down": (10944, 2048),
}
# the M its serves give the kernels. Prefill (nm_spmm): 2 x 1024 (masked),
# 4 x 128 and 4 chunks of 64 rows of attention and dense FFN; the experts
# at capacity 240, 64 and 32 (factor 1.25), dropless 512 and 256. Decode
# (M <= 8, nm_spmm_decode): the experts at capacity 8, 4 and 2 slots
DS_PREFILL_M = (2048, 512, 256, 240, 64, 32)
DS_DECODE_M = (8, 4, 2)
# the deepseek serve at full depth; the cut-depth phases' depth: layer 0
# (dense FFN) and 3 MoE layers, every GEMM and cache shape the full model's
DS_LAYERS, DS_CUT_LAYERS = 27, 4
# the train phase: full-width yi-9b cut to TUNED's depth, f32 weights, bf16
# compute, AdamW; batch x seq rows are nm_spmm's M (2048)
TRAIN = dict(layers=TUNED["layers"], batch=8, seq=256, steps=30, lr=1e-3,
             warmup=10)
# step 1 through the kernels against the same step under policy "off" on
# the card (relative): both round bf16 activations, the kernel's f32 sums
# and cuBLAS's run in another order, and the gradients' norm goes through
# 8 layers of those roundings. About 10x the readings on the H100 (loss
# 4.7e-6, grad_norm 6.4e-5); the kernel itself is held within TOL at the
# train shapes (M = batch x seq) in kernel_phase
TRAIN_TOL = {"loss": 5e-5, "grad_norm": 1e-3}
# decode steps after the prefill in every kernels-against-plain logits check
REF_DECODE_STEPS = 4
# witness_phase: through the kernels, a served bf16 model's layers and
# logits lie at most this many times as far (root mean square) from the
# same weights' f32 answer as the plain bf16 path's do. On the H100, token
# seeds 4-6 (python -m repro_torch.launch.witness --seeds 4 5 6): full
# whisper-medium, rwkv6-3b (bf16, int8), a jamba period and gemma3 at 8
# layers, worst layer 1.007-1.223, worst logits 0.990-1.062. A kernel
# product 1 + 2^-6 off reads 3.8-6.9 (median) on the reduced models
WITNESS_C = 2.0
RWKV, JAMBA = "rwkv6-3b", "jamba-v0.1-52b"
# jamba cut to one period: every block kind (7 Mamba, 1 attention, 4 MoE,
# 4 FFN); its 4 periods (about 78 GB at 2:4) do not fit one card
JAMBA_LAYERS = 8
# projection -> (K, N) of the recurrent models' N:M GEMMs at full width
RECURRENT_SHAPES = {
    "rwkv r/k/v/g/o/cm_r": (2560, 2560),
    "rwkv cm_k": (2560, 8960),
    "rwkv cm_v": (8960, 2560),
    "jamba w_in": (4096, 16384),
    "jamba w_x": (8192, 288),
    "jamba w_out": (8192, 4096),
    "jamba ffn/expert up/gate": (4096, 14336),
    "jamba ffn/expert down": (14336, 4096),
    "jamba wq/wo": (4096, 4096),
    "jamba wk/wv": (4096, 1024),
}
# the M the recurrent serves give the kernels: prefill 4 x 128 rows, and
# jamba's experts at capacity 80 (factor 1.25); decode 4 slots, and the
# experts' capacity 8
RECURRENT_PREFILL_M, RECURRENT_DECODE_M = (512, 80), (4, 8)
# run_resilient of reduced yi-9b on the card: steps, checkpoint interval,
# the steps whose start fails
RESILIENT = dict(steps=8, ckpt_every=2, failures=(1, 4, 5), lr=1e-3)
WHISPER, GEMMA = "whisper-medium", "gemma3-27b"
GQA_ARCHS = ("chameleon-34b", "codeqwen1.5-7b", "internlm2-20b")
# whisper served through make_serve_steps: 4 slots of 128-token prompts,
# each with its 1500 random frames, 32 greedy tokens
WHISPER_SERVE = dict(slots=4, prefill_len=128, max_new=32)
# whisper trained at full width and depth: f32 weights, bf16 compute,
# batch 4 x 128 text tokens (the encoder's nm_spmm at M = 4 x 1500)
WHISPER_TRAIN = dict(layers=None, batch=4, seq=128, steps=12, lr=1e-3,
                     warmup=2)
# gemma3's second request set: prompts longer than the local layers'
# window (1024), so the window cuts positions in prefill and in decode
GEMMA_LONG = dict(requests=2, slots=2, prefill_len=1152, max_new=16)
# gemma3 cut to one period (5 local + 1 global) and the 2-local tail: the
# int8, paged and f32-witness runs (a full-depth f32 copy does not fit
# beside the bf16 model)
GEMMA_CUT = 8
# the paged engine on the cut with the long prompts: chunks of 384, pages
# of 32, 72 pages (2 slots at 1184 tokens take 74): 2 preemptions and 48
# prefix-hit pages, as the scheduler plans it on the CPU
GEMMA_PAGED = dict(layers=GEMMA_CUT, requests=4, slots=2, prefill_len=1152,
                   prefill_chunk=384, page_size=32, pool_pages=72,
                   max_new=32, shared_prefix=64)
GQA_LAYERS = 2  # the three plain-GQA configs: full width, 2 layers
# projection -> (K, N) of the new configs' N:M GEMMs at full width
WHISPER_SHAPES = {
    "whisper wq/wk/wv/wo": (1024, 1024),
    "whisper w_up": (1024, 4096),
    "whisper w_down": (4096, 1024),
}
GEMMA_SHAPES = {
    "gemma3 wq": (5376, 4096),
    "gemma3 wk/wv": (5376, 2048),
    "gemma3 wo": (4096, 5376),
    "gemma3 w_up/w_gate": (5376, 21504),
    "gemma3 w_down": (21504, 5376),
}
GQA_SHAPES = {
    "chameleon wq/wo": (8192, 8192),
    "chameleon wk/wv": (8192, 1024),
    "chameleon w_up/w_gate": (8192, 22016),
    "chameleon w_down": (22016, 8192),
    "codeqwen w_up/w_gate": (4096, 13440),
    "codeqwen w_down": (13440, 4096),
    "internlm2 wq/wo": (6144, 6144),
    "internlm2 wk/wv": (6144, 1024),
    "internlm2 w_up/w_gate": (6144, 16384),
    "internlm2 w_down": (16384, 6144),
}
# the M their paths give the kernels: whisper's encoder at 4 x 1500 rows
# and its decoder prefill at 4 x 128; gemma3's long prefill 2 x 1152, its
# paged chunks 2 x 384 and the serve's 4 x 128, decode 4 and 2 slots; the
# GQA configs' serve 4 x 128 and 4 slots
WHISPER_M, GEMMA_M, GQA_M = ((6000, 512), (4,)), ((2304, 768, 512),
                                                   (4, 2)), ((512,), (4,))
ENCODER_M = WHISPER_M[0][0]
# phases 31-34: multi-rank serving, the ranks gloo processes sharing the
# card (launch.mesh.spawn; NCCL refuses two ranks on one GPU)
MESHES = ((1, 2), (2, 2))
RANK_TIMEOUT_S = 600  # a spawn's limit: a rank that hangs fails the run
# yi-9b's projections as a rank of tp 2 and tp 4 holds them: columns (wq,
# wk / wv, w_up / w_gate) and rows (wo, w_down; Kc / tp on N:M groups)
YI_SHARD_SHAPES = {
    f"yi tp{tp} {proj}": shape for tp in (2, 4) for proj, shape in (
        ("wq", (4096, 4096 // tp)), ("wk/wv", (4096, 512 // tp)),
        ("wo", (4096 // tp, 4096)), ("w_up/w_gate", (4096, 11008 // tp)),
        ("w_down", (11008 // tp, 4096)))}
# the M the sharded serves give them: 4 x 128 rows (1x2), 2 x 128 (2x2), 2
# and 1 slots of 8-token prompts; decode 4, 2 and 1 slots
YI_SHARD_M = ((512, 256, 16), (8, 4, 2, 1))
DS236 = "deepseek-v2-236b"
# projection -> (K, N) of full-width deepseek-v2-236b's N:M GEMMs
DS236_SHAPES = {
    "236b wq_a": (5120, 1536),
    "236b wq_b": (1536, 24576),
    "236b wkv_a": (5120, 512),
    "236b wk_rope": (5120, 64),
    "236b wo": (16384, 5120),
    "236b expert up/gate": (5120, 1536),
    "236b expert down": (1536, 5120),
    "236b shared up/gate": (5120, 3072),
    "236b shared down": (3072, 5120),
    "236b layer 0 up/gate": (5120, 12288),
    "236b layer 0 down": (12288, 5120),
}
# 4 x 128 and 2 x 128 rows (attention, dense FFN; the experts dropless),
# the experts at capacity 24 and 16 (factor 1.25, one and two data
# shards); decode 4 slots, the experts at capacity 8
DS236_M = ((512, 256, 24, 16), (8, 4))
# deepseek-v2-236b cut to layer 0 (dense FFN) and 3 MoE layers at full
# width: 21.5 GB in bf16; with its experts split over 2 ranks, 12.9 GB a
# rank
DS236_LAYERS = 4
# phase 32: full-width yi-9b cut to 4 layers, f32 weights and activations;
# the JAX package's sharded matrix (tests/test_serving_sharded.py): 5
# prompts of 8 tokens, 2 slots, max_new 4 + i
SHARDED_F32 = dict(layers=4, requests=5, slots=2, prefill_len=8,
                   max_seq=64)
# its masked variant at the masked serve's sizes: 2 x 1024-token prompts
SHARDED_MASKED = dict(requests=2, slots=2, prefill_len=1024, max_seq=1032)
SAMPLED_T = 0.8
# phases 33, 35 and 36's deepseek cut are cut in depth so that the
# script, with whisper-medium in phase 36, keeps inside its time on a
# slow host too (gloo's sums run on the host's cores)
# phase 33: the sharded bf16 serve at 12 of yi-9b's 48 layers
SHARDED_BF16 = dict(SERVE, layers=12)
# phase 35: full-width yi-9b cut to 1 layer
# trained on gloo ranks: f32 compute at 2x1, 1x2, 2x2 (fsdp) and 2x2
# (tp_only), 3 steps against the single process
# (tests/test_torch_training.py's f32 tolerances), bf16 compute at 2x2
# fsdp for 12 steps; batch x seq rows, TRAIN's lr, warmup
SHARDED_TRAIN = dict(layers=1, batch=8, seq=256, steps=3, bf16_steps=12,
                     lr=TRAIN["lr"], warmup=TRAIN["warmup"])
# tests/test_torch_training.py's f32 tolerances: metrics relative, the
# moments and every parameter entry absolute. An entry whose gradient lies
# under AdamW's eps (sqrt(v-hat) < eps by the single process's v) moves
# lr / eps (3e4) times its gradient's rounding: at most "eps_entries" such
# entries a rank may lie beyond "state", none beyond "eps_state" (H100,
# 700 W: one embedding entry of 870 M, gradient under 1e-9, 2.03e-5 from
# the single process at 2x2 on every run; every other entry within 7.0e-6)
SHARDED_TRAIN_TOL = {"metrics": 1e-5, "state": 2e-5, "eps_entries": 2,
                     "eps_state": 8e-5}
# phase 36: the MoE, recurrent and encoder-decoder configs trained on
# gloo ranks sharing the card at full width, depth cut to TRAIN_CUTS'
# blocks: f32 compute, TF32 off, 2 steps at 1x2, 1x4 (against the single
# process) and 2x2 fsdp (against the shard-wise single process, but
# WHOLE_BATCH_ORACLE's); batch x seq rows
MOE_RECURRENT_TRAIN = dict(batch=4, seq=64, steps=2, lr=TRAIN["lr"],
                           warmup=TRAIN["warmup"])
# the blocks kept (one period of them): rwkv6-3b's first 2 (0.42 B
# trained floats), deepseek-v2-lite-16b's dense layer 0 and its first
# MoE layer of 64 experts top-6 with 2 shared (0.75 B), a jamba-v0.1-52b
# period's layers 3 (Mamba + MoE of 16 x 14336) and 4 (GQA + FFN) (2.1 B),
# whisper-medium's encoder blocks and decoder blocks 0 and 1 (0.17 B)
TRAIN_CUTS = {RWKV: (0, 1), DEEPSEEK: (0, 1), JAMBA: (3, 4),
              WHISPER: (0, 1)}
# the cuts held at 2x2 to one process on the whole batch: no MoE, so the
# mesh changes nothing of the function (rwkv6-3b's 2x2 run is held to
# the shard-wise one, the same function in another order)
WHOLE_BATCH_ORACLE = (WHISPER,)
FRAMES_SEED = 0  # whisper's random frames (launch.sharded.with_frames)
# the references of phase 36 keep every 4th entry of a tensor's last dim
# (a Reference's sample in host shared memory): whole, the six of them
# hold 86 GB of the host's 101, and held three at a time they took phase
# 36 to 505.6 s and 653.5 s (H100 80GB HBM3, 700 W; 213 s with a sample)
REFERENCE_EVERY = 4
# phase 36's gates: SHARDED_TRAIN_TOL, on the state after step 1
# (launch.sharded._diff_to). There an entry in AdamW's eps regime (its
# step-1 gradient under 10 eps) is held by what its two sides' own
# moments do not explain, |p - p_ref + lr (u - u_ref)|: such a gradient is
# mostly cancellation and lies on either side of zero in two summation
# orders (rwkv6-3b's w_cm_v: m 1.20e-9 against -2.12e-10, its update
# 0.72 lr apart), while a missing or reversed update counts in full.
# grad_norm after step 1 within 1e-2: it is taken where such entries lie
# up to 2 lr apart, and the phase prints the distance of two one-process
# orders of the same function (rwkv6-3b, the whole batch and two data
# shards: 1.06e-3 on an H100 80GB HBM3 at 700 W)
MOE_RECURRENT_TOL = dict(SHARDED_TRAIN_TOL, later={"grad_norm": 1e-2})


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def template_args(entry: str) -> str:
    """The template arguments of a mangled kernel name, short: the
    activation / B type, the value type, then the decode kernels' rows
    and columns per thread (``bf16/bf16/4/8``)."""
    m = re.search(r"kernelI(.+?)EEv", entry)
    if m is None:
        return entry
    names = []
    for tok in re.finditer(r"13__nv_bfloat16|S\d*_|Li(\d+)E|[fa]",
                           m.group(1)):
        t = tok.group(0)
        names.append(tok.group(1) if tok.group(1) else
                     {"f": "f32", "a": "i8"}.get(t, "bf16"))
    return "/".join(names)


def ptxas_summary(log: str) -> str:
    """Registers per thread of each main kernel in an ``-Xptxas -v``
    report (by template arguments), and every spill of any entry
    function."""
    regs, spills, entry = [], [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            spills.append(f"{entry}: {line.strip()}")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(f"{template_args(entry)}={m.group(1)}")
            entry = None
    return ("registers " + ", ".join(regs) + "; spills: "
            + ("; ".join(spills) if spills else "none"))


def port():
    """The port's modules, imported from ``src`` of this checkout."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py; run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.launch.serve  # noqa: F401  (pulls in the whole path)

    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port imported jax or the JAX package")


def time_ms(fn, iters: int, flush) -> float:
    """Median ms of one call: L2 flushed before each (``flush`` zeroed),
    CUDA events around the call alone."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(m, k, n, dtype, vals, bias=False, scales=False):
    """Least time (ms) for the work, and what sets it
    (``cost_model.indexmac_cost``): the bytes the function must move (x,
    vals + 1 idx byte per kept value, the f32 scales and bias, y, each
    once) over HBM bandwidth, or the multiply-adds this data needs (its
    non-zeros only) over the dense peak rate of x's type."""
    from fractions import Fraction

    from repro_torch.core import cost_model
    from repro_torch.core.sparsity import NMConfig

    kept = Fraction(vals.shape[0], k)  # the pattern's density
    cost = cost_model.indexmac_cost(
        m, k, n, NMConfig(kept.numerator, kept.denominator),
        dtype_bytes=dtype.itemsize, w_value_bytes=vals.element_size(),
        scale_bytes=4 * n * int(scales), bias_bytes=4 * n * int(bias),
        nnz=int((vals != 0).sum()), dtype=dtype)
    return cost.bound_ms()


def gather_bound_ms(vals, b, scales=False):
    """Least time of C[Mr, Nc] = A_sp @ B (``cost_model.gather_cost``):
    the bytes (vals + 1 idx byte per kept value, B, C, the f32 row
    scales) over HBM bandwidth, or the multiply-adds of the kept
    non-zeros over the dense peak of B's type."""
    from fractions import Fraction

    from repro_torch.core import cost_model
    from repro_torch.core.sparsity import NMConfig

    k, nc = b.shape
    kept = Fraction(vals.shape[1], k)
    cost = cost_model.gather_cost(
        vals.shape[0], k, nc, NMConfig(kept.numerator, kept.denominator),
        b_bytes=b.element_size(), w_value_bytes=vals.element_size(),
        quantized=scales, nnz=int((vals != 0).sum()), dtype=b.dtype)
    return cost.bound_ms()


def compressed_linears(lm) -> int:
    """Compressed Linear modules of ``lm``: a step launches one GEMM for
    each."""
    from repro_torch.models.common import Linear

    return sum(1 for m in lm.modules()
               if isinstance(m, Linear) and m.nm is not None)


def gemms_per_step(cfg, decode=False) -> int:
    """The N:M GEMMs one step of ``cfg`` issues, from its shapes, a period
    counting each of its blocks: an attention's projections (MLA: wq or
    wq_a / wq_b, wkv_a, wk_rope, wo), Mamba's three (w_in, w_x, w_out;
    w_dt is dense), RWKV's eight (r, k, v, g, o and the channel-mix's k,
    v, r; its FFNConfig is the channel-mix), an FFN's two or three
    (swiglu, geglu), an MoE's three for each routed expert and for the
    shared experts' FFN. An encoder-decoder's prefill also runs every
    encoder block and each cross-attention's four projections; its
    ``decode`` step runs no encoder block and only wq and wo of each
    cross-attention (its K/V come from the cache)."""
    from repro_torch.configs.base import MambaConfig, MoEConfig, RWKVConfig

    total = 0
    blocks = cfg.blocks() + ([] if decode else cfg.encoder_blocks())
    for blk in blocks:
        mx, mlp = blk.mixer, blk.mlp
        if isinstance(mx, RWKVConfig):
            total += 8
            continue
        if isinstance(mx, MambaConfig):
            n = 3
        else:
            n = 4 + (1 if mx.kind == "mla" and mx.q_lora_rank else 0)
        if blk.cross_attn:
            n += 2 if decode else 4
        ffn = 3 if mlp is not None and mlp.act in ("swiglu", "geglu") else 2
        if isinstance(mlp, MoEConfig):
            n += ffn * (mlp.n_experts + (1 if mlp.n_shared else 0))
        elif mlp is not None:
            n += ffn
        total += n
    return total


def floor_ms(lm, tokens=None, slots=SERVE["slots"]) -> float:
    """ITL floor: the bytes of every weight a decode step reads (all but
    the embedding table, of which it reads B rows; every expert, whose
    buffer runs padded whether routed or not) and of the recurrent state
    of ``slots`` slots, read and written, at HBM bandwidth; with
    ``tokens``, only the experts that many tokens can route to count
    (``profile_decode.decode_weight_bytes``)."""
    from repro_torch.core.cost_model import HBM_BYTES_PER_S
    from repro_torch.launch.profile_decode import decode_weight_bytes

    return (decode_weight_bytes(lm, tokens, slots=slots) / HBM_BYTES_PER_S
            * 1e3)


def all_kernels() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels.blocksparse_attn import kernel as attn
    from repro_torch.kernels.indexmac import decode_kernel, kernel
    from repro_torch.kernels.indexmac_gather import kernel as gather

    return {k.name: k for k in (kernel.KERNEL, kernel.KERNEL_Q,
                                decode_kernel.KERNEL, decode_kernel.KERNEL_Q,
                                gather.KERNEL, gather.KERNEL_Q, attn.KERNEL)}


def zero_counts() -> dict:
    """Clear the dispatch counters and every launch count (the prefill
    kernels' per-path counts too); returns the kernels by name, to read
    the counts back."""
    from repro_torch.kernels import registry

    registry.clear_history()
    kernels = all_kernels()
    for kern in kernels.values():
        kern.reset()
    return kernels


def path_launches(kernels) -> dict:
    """{prefill kernel: {path: launches}} of the counts just read."""
    return {name: dict(kernels[name].path_launches) for name in PREFILL}


def check_paths(what, paths, only, on_card) -> None:
    """Every prefill launch in ``paths`` ran on ``only``."""
    other = {n: v for n, c in paths.items() for p, v in c.items()
             if p != only and v}
    if on_card and other:
        fail(f"{what}: prefill launches off the {only} path: {paths}")


def ran(eng, kernels, counts) -> tuple:
    """(dispatches, launches) that ran on the card in ``eng``'s serve,
    from the counters read just after it (zeroed just before)."""
    from repro_torch.serving.engine import ran_counts

    return ran_counts(eng, counts,
                      {name: kern.launches for name, kern in kernels.items()})


def check_graphs(what, eng, on_card) -> None:
    """One graph a step kind on the card, replayed, none with a
    reference dispatch captured in it; prints each graph's counts."""
    sizes = eng.compiled_cache_sizes()
    recs = eng.captured()
    if on_card and (sizes != {"prefill": 1, "decode": 1} or any(
            not r for r in recs.values())):
        fail(f"{what}: graphs captured {sizes}, expected one a step kind")
    for kind, rs in recs.items():
        for r in rs:
            ref = {k: v for k, v in r.dispatches.items()
                   if "reference" in k[1]}
            if ref:
                fail(f"{what}: reference dispatches captured in the {kind} "
                     f"graph: {ref}")
            print(f"{what}: {kind} graph {r.signature}: replayed "
                  f"{r.replays} times, holds {sum(r.launches.values())} "
                  f"kernel launches {r.launches}", flush=True)
    print(f"{what}: compiled_cache_sizes() {sizes}", flush=True)


def replay_ms(step, iters=10) -> float:
    """Median card ms of one replay of ``step``'s captured graph (CUDA
    events around the replay alone, on its last inputs)."""
    graph, = step.graphs
    graph.replay()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        a.record()
        graph.replay()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def forward_ms(fwd, x) -> float:
    """Card ms of one ``fwd(x)``: CUDA events around CNN["iters"] calls
    in a row (the card idles while the host lags, so host time shows)."""
    fwd(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CNN["iters"]):
        fwd(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CNN["iters"]


def serve_line(stats, dt) -> str:
    return (f"{stats['requests']} requests, {stats['tokens']} tokens in "
            f"{dt:.4f}s = {stats['tokens'] / dt:.3f} tok/s; TTFT mean "
            f"{stats['ttft_s'] * 1e3:.3f} ms p50 "
            f"{stats['ttft_p50_s'] * 1e3:.3f} ms; ITL p50 "
            f"{stats['itl_p50_s'] * 1e3:.3f} ms p99 "
            f"{stats['itl_p99_s'] * 1e3:.3f} ms; decode steps "
            f"{stats['decode_steps']}")


def streams(done) -> dict:
    return {r.rid: list(r.out) for r in done}


def sass(name: str) -> str:
    """The SASS of kernel library ``name`` (cuobjdump)."""
    from repro_torch.kernels import build

    tool = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump {name}: {out.stderr.strip()}")
    return out.stdout


def sass_tensor_ops() -> None:
    """Count the tensor-core instructions in the prefill kernels' SASS;
    fail if the sparse HMMA.SP or the dense HMMA is missing."""
    for name in PREFILL:
        ops = re.findall(r"\b(HMMA\.[A-Z0-9.]+)", sass(name))
        counts = {op: ops.count(op) for op in sorted(set(ops))}
        if not any(op.startswith("HMMA.SP") for op in counts) or not any(
                not op.startswith("HMMA.SP") for op in counts):
            fail(f"{name}: no sparse and dense HMMA in the SASS: {counts}")
        print(f"build: {name} SASS tensor-core instructions {counts}",
              flush=True)


def attention_build(built) -> None:
    """Fail if the bf16 bs_attention kernel's SASS has no bf16 tensor-core
    instruction (HMMA.*BF16 or HGMMA); print its registers and spills
    (ptxas, when built in this run), shared memory per CTA and CTAs per
    SM, and the f32 kernel's."""
    from repro_torch.kernels.blocksparse_attn import kernel as bk

    funcs = re.split(r"\n\s*Function : ", sass("bs_attention"))
    body = "".join(f for f in funcs if f.startswith(
        "_ZN3nmk23bs_attention_mma_kernel"))
    ops = re.findall(r"\b(HMMA\.[A-Z0-9.]*BF16[A-Z0-9.]*|HGMMA\.[A-Z0-9.]+)",
                     body)
    counts = {op: ops.count(op) for op in sorted(set(ops))}
    if not counts:
        fail(f"bs_attention: no bf16 tensor-core instruction in the bf16 "
             f"kernel's SASS (functions: {len(funcs) - 1})")
    print(f"build: bs_attention bf16 SASS tensor-core instructions {counts}",
          flush=True)
    regs = {}
    entry = None
    for line in built.get("bs_attention", "").splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            dims = re.search(r"mma_kernelILi(\d+)ELi(\d+)E", m.group(1))
            entry = (f"bf16 {dims.group(1)}/{dims.group(2)}" if dims
                     else "f32")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            regs.setdefault(entry, {})["spills"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs.setdefault(entry, {})["registers"] = int(m.group(1))
    for dt, name, groups, dk, dv in (
            (torch.bfloat16, "bf16 128/128", (1, 2), 128, 128),
            (torch.float32, "f32", (1,), 128, 128),
            (torch.bfloat16, "bf16 192/128", (1, 2), 192, 128),
            (torch.float32, "f32", (1,), 192, 128)):
        r = regs.get(name, {})
        if dk == 192 and r.get("spills", 0):
            fail(f"bs_attention {name}: {r['spills']} bytes of spill "
                 "stores")
        occ = ", ".join(
            f"G'={g}: {o['threads']} threads, {o['smem_bytes']} bytes of "
            f"shared memory per CTA, {o['ctas_per_sm']} CTAs per SM"
            for g in groups for o in [bk.occupancy(dt, g, dk, dv)])
        print(f"build: bs_attention {name} (dk {dk}, dv {dv}): registers "
              f"{r.get('registers', 'not rebuilt')}, spills "
              f"{r.get('spills', 'not rebuilt')} bytes; {occ}", flush=True)


def gather_build() -> None:
    """Fail if the gather kernels' SASS holds a tensor-core instruction
    (their MACs are FFMAs on indexed shared-memory reads); print the
    shared memory per CTA and CTAs per SM of each tile that
    GATHER_SHAPES launches, and fail where the host's mirrors of them
    (padding.gather_smem, padding.gather_ctas_per_sm, which plans the
    splits) differ from the kernel's, there and at the patterns with the
    most shared memory."""
    from repro_torch.core.sparsity import NMConfig
    from repro_torch.kernels.indexmac_gather import kernel as gk
    from repro_torch.kernels.padding import (
        GATHER_TILES,
        gather_ctas_per_sm,
        gather_smem,
        gather_tile,
    )

    for name in ("indexmac_gather", "indexmac_gather_q"):
        ops = re.findall(r"\b(H[G]?MMA\.[A-Z0-9.]+)", sass(name))
        if ops:
            fail(f"{name}: tensor-core instructions in the SASS: "
                 f"{sorted(set(ops))}")
    for cfg in (NMConfig(1, 4), NMConfig(2, 4), NMConfig(33, 48),
                NMConfig(63, 64)):
        shown = ({gather_tile(mr, nc, cfg)
                  for mr, _, nc in GATHER_SHAPES.values()}
                 if cfg.m == 4 else set())
        for tile in GATHER_TILES:
            occ = []
            for b_dt, v_dt in ((torch.float32, torch.float32),
                               (torch.bfloat16, torch.bfloat16),
                               (torch.float32, torch.int8)):
                o = gk.occupancy(b_dt, v_dt, cfg, tile)
                host = (gather_smem(tile, cfg, b_dt, v_dt),
                        gather_ctas_per_sm(tile, cfg, b_dt, v_dt))
                if (o["smem_bytes"], o["ctas_per_sm"]) != host:
                    fail(f"gather {tile} {cfg.tag} B {b_dt} vals {v_dt}: "
                         f"shared memory and CTAs per SM "
                         f"{(o['smem_bytes'], o['ctas_per_sm'])} != the "
                         f"host's {host}")
                occ.append(f"B {str(b_dt)[6:]} vals {str(v_dt)[6:]}: "
                           f"{o['smem_bytes']} bytes, {o['ctas_per_sm']} "
                           f"CTAs per SM")
            if tile in shown:
                print(f"build: gather tile {tile} {cfg.tag}, "
                      f"{o['threads']} threads: " + "; ".join(occ),
                      flush=True)
    print("build: gather SASS: no tensor-core instruction; shared memory "
          "and CTAs per SM as the host plans them (1:4, 2:4, 33:48, 63:64)",
          flush=True)


def decode_build() -> None:
    """Fail if a decode library's SASS holds more than its one kernel
    template (a finishing pass), where an instantiation's shared memory
    per CTA and CTAs per SM differ from the host's padding.decode_smem /
    decode_ctas_per_sm (which plan the splits), or where one takes local
    memory; print each one's registers, local memory, shared memory and
    CTAs per SM."""
    from repro_torch.kernels.indexmac import decode_kernel as dk
    from repro_torch.kernels.padding import (
        DECODE_ROWS,
        decode_ctas_per_sm,
        decode_smem,
    )

    for name in (dk.KERNEL.name, dk.KERNEL_Q.name):
        funcs = set(re.findall(r"Function : (\w+)", sass(name)))
        if not funcs or any("nm_spmm_decode_kernel" not in f for f in funcs):
            fail(f"{name}: the SASS holds functions other than the decode "
                 f"kernel: {sorted(funcs)}")
    for x_dt, v_dt in ((torch.float32, torch.float32),
                       (torch.bfloat16, torch.bfloat16),
                       (torch.float32, torch.int8),
                       (torch.bfloat16, torch.int8)):
        for rows in DECODE_ROWS:
            o = dk.occupancy(x_dt, v_dt, rows)
            host = (decode_smem(v_dt.itemsize),
                    decode_ctas_per_sm(v_dt.itemsize))
            tag = f"{str(x_dt)[6:]}/{str(v_dt)[6:]}/{rows}"
            if (o["smem_bytes"], o["ctas_per_sm"]) != host:
                fail(f"decode {tag}: shared memory and CTAs per SM "
                     f"{(o['smem_bytes'], o['ctas_per_sm'])} != the host's "
                     f"{host}")
            if o["local_bytes"]:
                fail(f"decode {tag}: {o['local_bytes']} bytes of local "
                     f"memory a thread (spills or an indexed register "
                     f"array)")
            print(f"build: decode {tag}: {o['registers']} registers, "
                  f"{o['local_bytes']} bytes of local memory (spills), "
                  f"{o['smem_bytes']} bytes of shared memory per CTA, "
                  f"{o['ctas_per_sm']} CTAs per SM of {o['threads']} "
                  f"threads (= the host's)", flush=True)
    print("build: decode SASS: one kernel a call, no finishing pass",
          flush=True)


def nm_weights(gen, k, n, cfg, lattice):
    """(vals f32, idx) of random N:M weights on ``gen``'s device, and
    their int8 form (vals, idx, scales): quantize_nm of the same weights,
    or on the integer lattice random int8 values with random scales."""
    from repro_torch.core.nmweight import NMWeight
    from repro_torch.core.sparsity import (
        apply_mask,
        compress_nm,
        prune_mask_nm,
    )
    from repro_torch.quant import quantize_nm

    dev = gen.device
    if lattice:
        sign = torch.randint(0, 2, (k, n), generator=gen, device=dev)
        w = (torch.randint(1, 5, (k, n), generator=gen, device=dev)
             * (2 * sign - 1)).float()
    else:
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
    vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, cfg)), cfg)
    if lattice:
        q = torch.randint(-127, 128, vals.shape, generator=gen,
                          device=dev, dtype=torch.int8)
        q = torch.where(vals == 0, torch.zeros_like(q), q)
        sc = torch.rand(n, generator=gen, device=dev) * 0.09 + 0.01
        return (vals, idx), (q, idx, sc)
    qw = quantize_nm(NMWeight(vals, idx, cfg))
    return (vals, idx), (qw.vals, qw.idx, qw.scales)


def nm_inputs(gen, m, k, n, dtype, lattice):
    """(x (M, K) in ``dtype``, an f32 bias (N,)): integers on the lattice,
    else normal."""
    dev = gen.device
    if lattice:
        x = torch.randint(-4, 5, (m, k), generator=gen, device=dev)
        b = torch.randint(-8, 9, (n,), generator=gen, device=dev).float()
        return x.to(dtype), b
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    return x, torch.randn(n, generator=gen, device=dev)


def kernel_phase(dev):
    """Each kernel against its plain version at the served shapes; the
    lattice cases; times. Returns (worst |err| per kernel, the numbers of
    the REPORTED shape per kernel)."""
    from repro_torch.core.sparsity import NMConfig, decompress_nm
    from repro_torch.kernels.indexmac import decode_kernel, kernel
    from repro_torch.kernels.padding import decode_plan, sm_count

    cfg = NMConfig(2, 4)
    sms = sm_count(dev.index or 0) if dev.type == "cuda" else 132
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # 1 GiB: zeroing it evicts the 50 MB L2 and keeps the card busy
    # (~0.3 ms) while the host enqueues the timed launch, so the event
    # pair holds the kernel and not the wrapper's host time
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)

    worst = dict.fromkeys(KERNELS, 0.0)
    report = {}
    print("kernel                 x     proj           M  max|err|   "
          "kernel_ms   plain_ms  matmul_ms   bound_ms (by)", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for proj, (k, n) in SHAPES.items():
            (fv, fi), (qv, qi, qs) = nm_weights(gen, k, n, cfg, lattice=False)
            fv = fv.to(dtype)
            dense = decompress_nm(fv, fi, cfg)
            dense8 = decompress_nm(qv, qi, cfg).to(dtype)  # exact
            cases = [("nm_spmm", PREFILL_M, None),
                     ("nm_spmm_decode", DECODE_M, None),
                     ("nm_spmm_decode", DECODE_M, "silu"),
                     ("nm_spmm_q", PREFILL_M, None),
                     ("nm_spmm_decode_q", DECODE_M, None),
                     ("nm_spmm_decode_q", DECODE_M, "silu")]
            if dtype == torch.bfloat16:  # the train phase's forward
                cases.append(("nm_spmm", TRAIN["batch"] * TRAIN["seq"],
                              None))
            if dtype == torch.bfloat16 and proj in DECODE_M_SWEEP:
                cases += [(name, m, None) for m in DECODE_M_SWEEP[proj]
                          for name in ("nm_spmm_decode", "nm_spmm_decode_q")]
            for name, m, act in cases:
                x, b = nm_inputs(gen, m, k, n, dtype, lattice=False)
                b = b if act else None
                quantized = name.endswith("_q")
                w_args = (qv, qi, qs) if quantized else (fv, fi)
                if name.startswith("nm_spmm_decode"):
                    args = (x, *w_args, b, cfg, act)
                    mod = decode_kernel
                    if act is None:
                        plan = decode_plan(m, k, n, cfg,
                                           w_args[0].element_size(), sms)
                        print(f"decode plan {name} {proj} M={m}: "
                              f"{plan.cols} columns a CTA, {plan.splits} "
                              f"splits of {plan.span} rows of K, "
                              f"{plan.ctas} CTAs on {sms} SMs", flush=True)
                else:
                    args = (x, *w_args, cfg)
                    mod = kernel
                run, plain = getattr(mod, name), getattr(mod, name + "_plain")
                got, want = run(*args).float(), plain(*args).float()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = TOL[dtype]
                if not torch.allclose(got, want, rtol=tol, atol=tol):
                    fail(f"{name} {dtype} {proj} M={m} act={act}: "
                         f"max|kernel - plain| = {err} beyond {tol}")
                worst[name] = max(worst[name], err)
                if mod is decode_kernel and not torch.equal(run(*args),
                                                            run(*args)):
                    fail(f"{name} {dtype} {proj} M={m} act={act}: two calls "
                         f"differ")
                label = name + ("+bias+silu" if act else "")
                dt = "bf16" if dtype == torch.bfloat16 else "f32"
                line = f"{label:22s} {dt:5s} {proj:11s} {m:4d}  {err:.3e}"
                if dtype == torch.bfloat16:  # the served dtype is timed
                    w_dense = dense8 if quantized else dense
                    ms = time_ms(lambda: run(*args), 20, flush)
                    plain_ms = time_ms(lambda: plain(*args), 5, flush)
                    lib_ms = (None if act else
                              time_ms(lambda: torch.matmul(x, w_dense), 20,
                                      flush))
                    bms, by = bound_ms(m, k, n, dtype, w_args[0],
                                       bias=bool(act), scales=quantized)
                    lib = "-" if lib_ms is None else f"{lib_ms:10.5f}"
                    line += (f" {ms:10.5f} {plain_ms:10.5f} {lib:>10s} "
                             f"{bms:10.5f} ({by})")
                    if proj == REPORTED and not act and m in (PREFILL_M,
                                                              DECODE_M):
                        report[name] = dict(ms=ms, plain_ms=plain_ms,
                                            bound_ms=bms, bound_by=by,
                                            library_ms=lib_ms)
                print(line, flush=True)
            # integer lattice: every order of the sums is exact
            (fv, fi), (qv, qi, qs) = nm_weights(gen, k, n, cfg, lattice=True)
            lattice_cases = [(torch.float32, "float", (fv, fi))]
            lattice_cases += [(dt, "int8", (qv, qi, qs))
                              for dt in (torch.float32, torch.bfloat16)]
            for xdt, fam, w_args in lattice_cases:
                if dtype != xdt:
                    continue
                sfx = "_q" if fam == "int8" else ""
                pk, pp = (getattr(kernel, "nm_spmm" + sfx),
                          getattr(kernel, "nm_spmm" + sfx + "_plain"))
                dk, dp = (getattr(decode_kernel, "nm_spmm_decode" + sfx),
                          getattr(decode_kernel,
                                  "nm_spmm_decode" + sfx + "_plain"))
                x, _ = nm_inputs(gen, PREFILL_M, k, n, xdt, lattice=True)
                same = torch.equal(pk(x, *w_args, cfg), pp(x, *w_args, cfg))
                x, b = nm_inputs(gen, DECODE_M, k, n, xdt, lattice=True)
                same &= torch.equal(dk(x, *w_args, b, cfg, "relu"),
                                    dp(x, *w_args, b, cfg, "relu"))
                dt = "bf16" if xdt == torch.bfloat16 else "f32"
                if not same:
                    fail(f"integer lattice not bit-exact: {fam} kernels, "
                         f"x {dt}, {proj}")
                print(f"lattice {fam} x {dt} {proj}: bit-exact "
                      f"(M={PREFILL_M}; M={DECODE_M} with bias + relu)",
                      flush=True)
    return worst, report


def shape_kernel_phase(dev, shapes=DS_SHAPES, prefill_ms=DS_PREFILL_M,
                       decode_ms=DS_DECODE_M, what="deepseek kernels",
                       seed=1) -> dict:
    """The four N:M kernels against their plain versions at every
    projection shape of a full-width model and every M its serves give
    (deepseek-v2-lite-16b's by default: a ragged K of 10944, an N of 64;
    the recurrent models' RECURRENT_SHAPES: jamba's w_x N of 288): x in
    bf16 and f32, the
    float kernels with vals in x's dtype, the int8 kernels with int8 vals
    and scales; decode with and without bias + SiLU, within TOL, two
    decode calls bit-identical; then on the integer lattice bit-exact (f32
    x for the float kernels, f32 and bf16 x for the int8 ones; decode
    with bias + relu). Returns the worst |err| per kernel."""
    from repro_torch.core.sparsity import NMConfig
    from repro_torch.kernels.indexmac import decode_kernel, kernel

    cfg = NMConfig(2, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    names = ("nm_spmm", "nm_spmm_q", "nm_spmm_decode", "nm_spmm_decode_q")
    worst = dict.fromkeys(names, 0.0)
    for proj, (k, n) in shapes.items():
        for lattice in (False, True):
            fw, qw = nm_weights(gen, k, n, cfg, lattice)
            errs = dict.fromkeys(names, 0.0)
            for dtype in (torch.bfloat16, torch.float32):
                for name in names:
                    quantized = name.endswith("_q")
                    if lattice and dtype != torch.float32 and not quantized:
                        continue  # bf16 vals round the lattice weights
                    decode = name.startswith("nm_spmm_decode")
                    mod = decode_kernel if decode else kernel
                    run, plain = (getattr(mod, name),
                                  getattr(mod, name + "_plain"))
                    w_args = qw if quantized else (fw[0].to(dtype), fw[1])
                    acts = (("relu",) if lattice else (None, "silu")) \
                        if decode else (None,)
                    for m in decode_ms if decode else prefill_ms:
                        for act in acts:
                            x, b = nm_inputs(gen, m, k, n, dtype, lattice)
                            args = ((x, *w_args, b if act else None, cfg,
                                     act) if decode else (x, *w_args, cfg))
                            got, want = run(*args), plain(*args)
                            case = (f"{what}: {name} x {dtype} "
                                    f"{proj} ({k}x{n}) M={m} act={act}"
                                    f"{' lattice' if lattice else ''}")
                            if got.shape != (m, n) or not bool(
                                    torch.isfinite(got).all()):
                                fail(f"{case}: shape {tuple(got.shape)} or "
                                     "non-finite values")
                            if lattice:
                                if not torch.equal(got, want):
                                    fail(f"{case}: not bit-exact")
                                continue
                            got, want = got.float(), want.float()
                            err = float((got - want).abs().max())
                            tol = TOL[dtype]
                            if not torch.allclose(got, want, rtol=tol,
                                                  atol=tol):
                                fail(f"{case}: max|kernel - plain| = {err} "
                                     f"beyond {tol}")
                            if decode and not torch.equal(run(*args),
                                                          run(*args)):
                                fail(f"{case}: two calls differ")
                            errs[name] = max(errs[name], err)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if lattice:
                print(f"{what} {proj} ({k}x{n}): integer lattice "
                      f"bit-exact, prefill M={list(prefill_ms)}, decode "
                      f"M={list(decode_ms)} with bias + relu", flush=True)
                continue
            for name in names:
                worst[name] = max(worst[name], errs[name])
            print(f"{what} {proj} ({k}x{n}): max|kernel - plain| "
                  + ", ".join(f"{nm} {e:.3e}" for nm, e in errs.items())
                  + f" (bf16 and f32 x; M {list(prefill_ms)} prefill, "
                  f"{list(decode_ms)} decode, with and without bias + SiLU; "
                  f"tolerance {TOL[torch.bfloat16]} bf16, "
                  f"{TOL[torch.float32]} f32)", flush=True)
    return worst


def shape_timing_phase(dev, shapes=RECURRENT_SHAPES, what="recurrent",
                       prefill_m=PREFILL_M, decode=True):
    """Times of the four N:M kernels at ``shapes``, bf16 x (bf16 or int8
    values, no epilogue) at ``prefill_m`` and DECODE_M (the prefill
    kernels only without ``decode``), beside their plain
    versions, ``torch.matmul`` on the dense weight (the int8 weight cast
    to bf16, exact) and the bound; L2 flushed before every launch. One
    line a case."""
    from repro_torch.core.sparsity import NMConfig, decompress_nm
    from repro_torch.kernels.indexmac import decode_kernel, kernel

    cfg, dtype = NMConfig(2, 4), torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    flush = torch.empty(2**30 if dev.type == "cuda" else 1,
                        dtype=torch.uint8, device=dev)
    print(f"{what} times: kernel x bf16, proj (K x N), M, kernel_ms, "
          "plain_ms, matmul_ms, bound_ms (by)", flush=True)
    for proj, (k, n) in shapes.items():
        (fv, fi), (qv, qi, qs) = nm_weights(gen, k, n, cfg, lattice=False)
        fv = fv.to(dtype)
        dense = {False: decompress_nm(fv, fi, cfg),
                 True: decompress_nm(qv, qi, cfg).to(dtype)}
        for name in ("nm_spmm", "nm_spmm_decode", "nm_spmm_q",
                     "nm_spmm_decode_q")[::1 if decode else 2]:
            quantized = name.endswith("_q")
            is_decode = name.startswith("nm_spmm_decode")
            m = DECODE_M if is_decode else prefill_m
            x, _ = nm_inputs(gen, m, k, n, dtype, lattice=False)
            w_args = (qv, qi, qs) if quantized else (fv, fi)
            mod = decode_kernel if is_decode else kernel
            args = (x, *w_args, None, cfg, None) if is_decode else (
                x, *w_args, cfg)
            run, plain = getattr(mod, name), getattr(mod, name + "_plain")
            ms = time_ms(lambda: run(*args), 20, flush)
            plain_ms = time_ms(lambda: plain(*args), 5, flush)
            w_dense = dense[quantized]
            lib_ms = time_ms(lambda: torch.matmul(x, w_dense), 20, flush)
            bms, by = bound_ms(m, k, n, dtype, w_args[0], scales=quantized)
            print(f"{what} times: {name:16s} {proj:24s} ({k}x{n}) M={m:4d} "
                  f"{ms:10.5f} {plain_ms:10.5f} {lib_ms:10.5f} {bms:10.5f} "
                  f"({by})", flush=True)


def cnn_gemm_phase(dev, gemms=CNN_GEMMS) -> dict:
    """nm_spmm and nm_spmm_q in f32, the dense 3xTF32 path the CNNs run, at
    ``gemms`` (2:4): against their plain versions within TOL[f32]; times of
    the kernel, its plain version and torch.matmul in f32 (TF32 off) on the
    dense weight; the bound. Returns the worst |err| per kernel."""
    from repro_torch.core.nmweight import NMWeight
    from repro_torch.core.sparsity import (
        NMConfig,
        apply_mask,
        compress_nm,
        decompress_nm,
        prune_mask_nm,
    )
    from repro_torch.kernels.indexmac import kernel
    from repro_torch.quant import quantize_nm

    on_card = dev.type == "cuda"
    cfg = NMConfig(2, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    flush = torch.empty(2**30 if on_card else 1, dtype=torch.uint8,
                        device=dev)
    worst = dict.fromkeys(PREFILL, 0.0)
    print("cnn gemm kernel  x    layer      M x K x N              max|err|"
          "   kernel_ms   plain_ms  matmul_ms   bound_ms (by)  path",
          flush=True)
    for layer, (m, k, n) in gemms.items():
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, cfg)), cfg)
        qw = quantize_nm(NMWeight(vals, idx, cfg))
        x = torch.randn(m, k, generator=gen, device=dev)
        for name, args, dense in (
                ("nm_spmm", (x, vals, idx, cfg),
                 decompress_nm(vals, idx, cfg)),
                ("nm_spmm_q", (x, qw.vals, qw.idx, qw.scales, cfg),
                 decompress_nm(qw.vals, qw.idx, cfg).float())):
            run = getattr(kernel, name)
            plain = getattr(kernel, name + "_plain")
            kern = getattr(kernel, "KERNEL_Q" if name.endswith("_q")
                           else "KERNEL")
            before = dict(kern.path_launches)
            got, want = run(*args), plain(*args)
            if on_card:
                torch.cuda.synchronize()
            ran = {p: v - before[p] for p, v in kern.path_launches.items()}
            if on_card and ran != {"dense": 1, "sparse": 0}:
                fail(f"{name} f32 {layer}: paths {ran}, expected dense")
            err = float((got - want).abs().max())
            tol = TOL[torch.float32]
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                fail(f"{name} f32 {layer}: max|kernel - plain| = {err} "
                     f"beyond {tol}")
            worst[name] = max(worst[name], err)
            ms = time_ms(lambda: run(*args), 20, flush)
            plain_ms = time_ms(lambda: plain(*args), 5, flush)
            lib_ms = time_ms(lambda: torch.matmul(x, dense), 20, flush)
            bms, by = bound_ms(m, k, n, torch.float32, args[1],
                               scales=name.endswith("_q"))
            print(f"cnn gemm {name:9s} f32  {layer:10s} {m:5d} x {k:4d} x "
                  f"{n:4d}  {err:.3e} {ms:10.5f} {plain_ms:10.5f} "
                  f"{lib_ms:10.5f} {bms:10.5f} ({by})  dense", flush=True)
    return worst


def set_policy(lm, mode) -> None:
    """Every compressed Linear of ``lm`` under kernel policy ``mode``."""
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.models.common import Linear

    for mod in lm.modules():
        if isinstance(mod, Linear) and mod.nm is not None:
            mod.kernel_policy = KernelPolicy(mode)


def kernels_vs_off(lm, toks, *, steps=REF_DECODE_STEPS, max_seq,
                   last_only=False):
    """A prefill of ``toks`` and ``steps`` decode steps through the
    kernels (policy "auto"), then the same under policy "off" (the plain
    versions) on the same weights; every decode step feeds both the same
    token (drawn from a generator, not from either's logits). An
    encoder-decoder prefills with random frames from that generator,
    and its encoder's output is compared first ("encode"). Returns
    ([(call, kernel logits, plain logits)], the kernels' dispatch
    counts)."""
    from repro_torch.kernels import registry
    from repro_torch.models.cache import CacheView

    b, s = toks.shape
    gen = torch.Generator(device=toks.device)
    gen.manual_seed(2)
    feed = torch.randint(0, lm.cfg.vocab_size, (steps, b, 1), generator=gen,
                         device=toks.device)
    enc = None
    if lm.cfg.encoder_plan is not None:  # frames of every slot
        enc = torch.randn(b, lm.cfg.encoder_seq, lm.cfg.d_model,
                          generator=gen, device=toks.device).to(lm.dtype)

    def calls():
        cache = lm.init_cache(b, max_seq)
        out = [] if enc is None else [lm.encode(enc)]
        out.append(lm(toks, view=CacheView.prefill(), caches=cache,
                      last_only=last_only, enc_input=enc)[0])
        for i in range(steps):
            out.append(lm(feed[i], view=CacheView.decode(
                torch.full((b,), s + i)), caches=cache)[0])
        return out

    with torch.inference_mode():
        registry.clear_history()
        set_policy(lm, "auto")
        got = calls()
        counts = registry.dispatch_counts()
        set_policy(lm, "off")
        want = calls()
        set_policy(lm, "auto")
    names = (["encode"] if enc is not None else []) + ["prefill"] + [
        f"decode {i + 1}" for i in range(steps)]
    return list(zip(names, got, want)), counts


def reference_phase(dev, quantize=None, arch="yi-9b") -> None:
    """Reduced ``arch`` in f32 (int8 weights with ``quantize="int8"``):
    logits through the kernels against logits through the reference on
    the same weights (prefill, then REF_DECODE_STEPS decode steps)."""
    from repro_torch.launch.serve import build_model

    small, lm = build_model(arch, full=False, kernels=True,
                            dtype=torch.float32, seed=1, device=dev,
                            quantize=quantize)
    kinds = ({"nm_spmm_q", "nm_spmm_decode_q"} if quantize
             else {"nm_spmm", "nm_spmm_decode"})
    what_w = "int8" if quantize else "f32"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    toks = torch.randint(0, small.vocab_size, (2, 16), generator=gen,
                         device=dev)
    pairs, counts = kernels_vs_off(lm, toks, max_seq=32)
    if set(k[1] for k in counts) != kinds:
        fail(f"reference check: the {what_w} kernels did not serve: "
             f"{counts}")
    for what, a, b in pairs:
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            fail(f"reference check {what}: shape {tuple(a.shape)} or "
                 "non-finite logits")
        err = float((a - b).abs().max())
        if err > 1e-4:
            fail(f"reference check {arch} {what_w} {what}: max|kernels - "
                 f"reference| = {err}")
        print(f"reference: reduced {arch} f32, {what_w} weights, {what} "
              f"logits {tuple(a.shape)} max|kernels - reference| = "
              f"{err:.3e} (tolerance 1e-4)", flush=True)


def serve_phase(dev, *, full=True, layers=SERVE["layers"], quantize=None,
                arch="yi-9b", eager=True, what="serve", model=None,
                alone=False, sizes=SERVE):
    """Serve ``sizes["requests"]`` requests (SERVE's by default: their
    slots, prompt length and new tokens) of ``arch`` with bf16 weights, or
    int8 ones with ``quantize="int8"``, through the captured steps, then
    (``eager``) the same requests eagerly; each graph holds one launch a
    compressed Linear, as many as the config's shapes give. ``model`` (a
    (cfg, lm) pair) serves in place of a model made here. ``alone``: each
    request served alone in a fresh engine (eagerly) gives the stream it
    had in the serve. Returns the launches of each kernel and the
    dispatch counts of the captured serve (what ran on the card), and
    its greedy streams."""
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_model, serve

    on_card = dev.type == "cuda"
    served = ({"nm_spmm_q", "nm_spmm_decode_q"} if quantize
              else {"nm_spmm", "nm_spmm_decode"})
    weights = "int8" if quantize else "bf16"
    what = f"{what} {weights}"
    t0 = time.perf_counter()
    if model is None:
        model = build_model(arch, full=full, layers=layers, kernels=True,
                            dtype=torch.bfloat16, seed=0, device=dev,
                            quantize=quantize)
    cfg, lm = model
    if on_card:
        torch.cuda.synchronize()
    print(f"{what}: {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"bf16 activations, {weights} weights, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    per_step = compressed_linears(lm)
    if per_step != gemms_per_step(cfg):
        fail(f"{what}: {per_step} compressed Linears, the config's shapes "
             f"give {gemms_per_step(cfg)} GEMMs a step")
    kw = dict(slots=sizes["slots"], prefill_len=sizes["prefill_len"],
              max_seq=sizes["prefill_len"] + sizes["max_new"])
    serve(lm, requests=1, max_new=2, graphs=False,
          **kw)  # warm-up: cuBLAS, allocator
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels = zero_counts()
    eng, done, dt = serve(lm, requests=sizes["requests"],
                          max_new=sizes["max_new"], **kw)
    counts, launches = ran(eng, kernels, registry.dispatch_counts())
    paths = path_launches(kernels)
    if len(done) != sizes["requests"] or any(
            len(r.out) != sizes["max_new"] for r in done):
        fail(f"{what}: {len(done)} of {sizes['requests']} "
             "requests finished")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        fail(f"{what}: a token outside the vocabulary")
    wrong = {k: v for k, v in counts.items() if k[1] not in served}
    idle = [name for name in served if launches[name] == 0]
    stray = {name: v for name, v in launches.items()
             if name not in served and v}
    if wrong or stray or (on_card and idle):
        fail(f"{what}: dispatches outside {sorted(served)}: "
             f"{wrong}; launches {launches}")
    check_paths(what, paths, "sparse", on_card)
    check_graphs(what, eng, on_card)
    for kind, rs in eng.captured().items():
        fam = ("nm_spmm" if kind == "prefill" else "nm_spmm_decode") + (
            "_q" if quantize else "")
        for r in rs:
            if r.launches != {fam: per_step}:
                fail(f"{what}: the {kind} graph holds {r.launches}, the "
                     f"model's shapes give {{{fam!r}: {per_step}}}")
    print(f"{what}: {per_step} N:M GEMM launches a step (the config's "
          f"shapes give {gemms_per_step(cfg)}); each graph holds exactly "
          "those", flush=True)
    stats = eng.throughput_stats()
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
            if on_card else "not measured")
    decode_ms = replay_ms(eng._decode) if on_card else None
    MEASURED[what] = dict(decode_ms=decode_ms, per_step=per_step)
    busy = f"{decode_ms:.3f} ms" if on_card else "not measured"
    busy_prefill = (f"{replay_ms(eng._prefill, iters=3):.3f} ms" if on_card
                    else "not measured")
    floor = floor_ms(lm, slots=sizes["slots"])
    routed = floor_ms(lm, tokens=sizes["slots"], slots=sizes["slots"])
    state = floor - floor_ms(lm, slots=0)
    floors = (f"floor {floor:.3f} ms (the weights' bytes at HBM rate"
              + (f", {state:.3f} ms of it the recurrent state of "
                 f"{sizes['slots']} slots read and written" if state else "")
              + ")")
    if routed != floor:
        floors = (f"floor {floor:.3f} ms (every weight's bytes at HBM rate, "
                  f"each expert read), routed floor {routed:.3f} ms (at most "
                  f"{sizes['slots']} tokens x top-k experts a MoE layer "
                  f"read)")
    print(f"{what}: graphs: {serve_line(stats, dt)}; "
          f"max_memory_allocated {peak}", flush=True)
    eager_itl = "not run"
    if eager:
        eng_e, edone, edt = serve(lm, requests=sizes["requests"],
                                  max_new=sizes["max_new"], graphs=False,
                                  **kw)
        if streams(edone) != streams(done):
            fail(f"{what}: greedy streams of the captured steps differ "
                 f"from the eager steps': {streams(done)} vs "
                 f"{streams(edone)}")
        print(f"{what}: eager:  "
              f"{serve_line(eng_e.throughput_stats(), edt)}; greedy streams "
              "equal to the graphs'", flush=True)
        eager_itl = (f"{eng_e.throughput_stats()['itl_p50_s'] * 1e3:.3f} "
                     "ms")
    if alone:
        got = alone_streams(lm, sizes["requests"], sizes["max_new"], kw)
        if got != streams(done):
            fail(f"{what}: a request served alone gives another stream "
                 f"than in the serve: {got} vs {streams(done)}")
        print(f"{what}: each of the {sizes['requests']} requests served "
              "alone in a fresh engine (eager) gives its stream in the "
              "serve", flush=True)
    print(f"{what}: ITL p50 graphs "
          f"{stats['itl_p50_s'] * 1e3:.3f} ms, eager {eager_itl}, "
          f"{floors}; one "
          f"decode-graph replay {busy}, one prefill-graph replay "
          f"{busy_prefill} of card time (CUDA events)", flush=True)
    print(f"{what}: dispatch counts "
          + ", ".join(f"{op}/{impl}/{be}={v}"
                      for (op, impl, be), v in sorted(counts.items()))
          + f"; launches {launches} (one kernel launch a wrapper call of "
          f"at most 8 rows; a graph's counted once per replay); prefill "
          f"launches by path, eager and captured {paths}", flush=True)
    return launches, counts, streams(done)


def alone_streams(lm, requests, max_new, kw) -> dict:
    """The greedy stream of each of ``launch.serve.serve``'s first
    ``requests`` prompts served alone, each in a fresh engine (eager)."""
    import numpy as np

    from repro_torch.serving.engine import Request, ServeEngine

    prompts = np.random.default_rng(0).integers(
        0, lm.cfg.vocab_size, size=(requests, kw["prefill_len"])).astype(
            np.int32)
    out = {}
    for rid, prompt in enumerate(prompts):
        eng = ServeEngine(lm, graphs=False, **kw)
        eng.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        out[rid] = list(eng.run()[0].out)
    return out


def paged_serve_phase(dev, *, full=True, sizes=PAGED_SERVE, arch="yi-9b",
                      what="paged serve", lm=None):
    """Chunked prefill and the paged cache at full width: prefix hits and
    preemption, streams equal to the slot engine's with the same chunks.
    ``lm`` serves in place of a model made here."""
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import build_model, serve

    on_card = dev.type == "cuda"
    if lm is None:
        t0 = time.perf_counter()
        cfg, lm = build_model(arch, full=full, layers=sizes["layers"],
                              kernels=True, dtype=torch.bfloat16, seed=0,
                              device=dev)
        if on_card:
            torch.cuda.synchronize()
        print(f"{what}: {cfg.name} d_model={cfg.d_model} layers="
              f"{cfg.n_layers} bf16, made in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    kw = dict(slots=sizes["slots"], prefill_len=sizes["prefill_len"],
              max_seq=sizes["prefill_len"] + sizes["max_new"],
              prefill_chunk=sizes["prefill_chunk"],
              shared_prefix=sizes["shared_prefix"],
              requests=sizes["requests"], max_new=sizes["max_new"])
    kernels = zero_counts()
    eng, done, dt = serve(lm, paged=True, page_size=sizes["page_size"],
                          pool_pages=sizes["pool_pages"], **kw)
    counts, launches = ran(eng, kernels, registry.dispatch_counts())
    stats = eng.throughput_stats()
    served = {"nm_spmm", "nm_spmm_decode"}
    if len(done) != sizes["requests"] or any(
            len(r.out) != sizes["max_new"] for r in done):
        fail(f"{what}: {len(done)} of {sizes['requests']} requests "
             "finished")
    if stats["preemptions"] < 1 or stats["prefix_hit_pages"] < 1:
        fail(f"{what}: preemptions {stats['preemptions']}, prefix hit "
             f"pages {stats['prefix_hit_pages']}; expected at least one "
             "of each")
    wrong = {k: v for k, v in counts.items() if k[1] not in served}
    stray = {n: v for n, v in launches.items() if n not in served and v}
    if wrong or stray or (on_card and any(launches[n] == 0
                                          for n in served)):
        fail(f"{what}: dispatches {counts}, launches {launches}")
    check_graphs(what, eng, on_card)
    print(f"{what}: {serve_line(stats, dt)}; {stats['preemptions']} "
          f"preemptions, {stats['prefix_hit_pages']} of "
          f"{stats['prefix_lookup_pages']} prompt pages from the prefix "
          f"cache, {stats['page_evictions']} evictions, pool utilization "
          f"mean {stats['page_util_mean']:.3f} max "
          f"{stats['page_util_max']:.3f}; launches {launches}", flush=True)
    slot, sdone, sdt = serve(lm, **kw)
    paged, slotted = streams(done), streams(sdone)
    if paged != slotted:
        fail(f"{what}: greedy streams differ from the slot engine's: "
             f"{paged} vs {slotted}")
    check_graphs(f"{what}, slot engine", slot, on_card)
    print(f"{what}: slot engine, same chunks: "
          f"{serve_line(slot.throughput_stats(), sdt)}; greedy streams "
          "equal to the paged engine's", flush=True)


def gather_phase(dev):
    """The gather kernels against their plain versions at GATHER_SHAPES,
    1:4 and 2:4, B in f32 and bf16; the lattice cases; times. Returns
    (worst |err| per kernel, the numbers of the reported case)."""
    from repro_torch.core.nmweight import NMWeight
    from repro_torch.core.sparsity import (
        NMConfig,
        apply_mask,
        compress_nm,
        decompress_nm,
        prune_mask_nm,
    )
    from repro_torch.kernels.indexmac_gather import kernel as gk
    from repro_torch.kernels.padding import gather_plan, sm_count
    from repro_torch.quant import quantize_nm

    sms = sm_count(dev.index or 0) if dev.type == "cuda" else 132
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    flush = torch.empty(2**30, dtype=torch.uint8, device=dev)
    first = next(iter(GATHER_SHAPES))
    worst = {"indexmac_gather": 0.0, "indexmac_gather_q": 0.0}
    report = {}

    def row_compressed(a, cfg):
        return compress_nm(apply_mask(a, prune_mask_nm(a, cfg, axis=1)), cfg,
                           axis=1)

    print("gather kernel       nm  B     layer      Mr x K x Nc          "
          "max|err|   kernel_ms   plain_ms  matmul_ms   bound_ms (by)",
          flush=True)
    for cfg in (NMConfig(1, 4), NMConfig(2, 4)):
        for layer, (mr, k, nc) in GATHER_SHAPES.items():
            plan = gather_plan(mr, k, nc, cfg, torch.float32,
                               torch.float32, sms)
            print(f"gather plan {cfg.tag} {layer}: tile {plan.tile}, K "
                  f"steps of {plan.k_rows} rows: {plan.steps} in "
                  f"{plan.splits} splits of {plan.per}, {plan.blocks} "
                  f"CTAs on {sms} SMs", flush=True)
            a = torch.randn(mr, k, generator=gen, device=dev) * k ** -0.5
            vals, idx = row_compressed(a, cfg)
            q = quantize_nm(NMWeight(vals, idx, cfg, axis=1))
            a_dense = decompress_nm(vals, idx, cfg, axis=1)  # f32
            b32 = torch.randn(k, nc, generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                b = b32.to(dtype)
                for name, args in (
                        ("indexmac_gather", (vals.to(dtype), idx, b, cfg)),
                        ("indexmac_gather_q",
                         (q.vals, q.idx, q.scales, b, cfg))):
                    run = getattr(gk, name)
                    plain = getattr(gk, name + "_plain")
                    got, want = run(*args).float(), plain(*args).float()
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    tol = TOL[dtype]
                    dt = "bf16" if dtype == torch.bfloat16 else "f32"
                    if not torch.allclose(got, want, rtol=tol, atol=tol):
                        fail(f"{name} {cfg.tag} B {dt} {layer}: max|kernel "
                             f"- plain| = {err} beyond {tol}")
                    worst[name] = max(worst[name], err)
                    if not torch.equal(run(*args), run(*args)):
                        fail(f"{name} {cfg.tag} B {dt} {layer}: two calls "
                             f"differ")
                    ms = time_ms(lambda: run(*args), 20, flush)
                    plain_ms = time_ms(lambda: plain(*args), 5, flush)
                    lib_ms = time_ms(lambda: torch.matmul(a_dense, b32), 20,
                                     flush)
                    bms, by = gather_bound_ms(args[0], b,
                                              scales=name.endswith("_q"))
                    print(f"{name:19s} {cfg.tag} {dt:5s} {layer:10s} "
                          f"{mr:4d} x {k:4d} x {nc:4d}  {err:.3e} "
                          f"{ms:10.5f} {plain_ms:10.5f} {lib_ms:10.5f} "
                          f"{bms:10.5f} ({by})", flush=True)
                    if (layer, cfg.tag, dtype) == (first, "2:4",
                                                   torch.float32):
                        report[name] = dict(ms=ms, plain_ms=plain_ms,
                                            bound_ms=bms, bound_by=by,
                                            library_ms=lib_ms)
            # integer lattice: every order of the sums is exact, and the
            # int8 kernel's row scale multiplies once
            sign = torch.randint(0, 2, (mr, k), generator=gen, device=dev)
            a = (torch.randint(1, 5, (mr, k), generator=gen, device=dev)
                 * (2 * sign - 1)).float()
            vals, idx = row_compressed(a, cfg)
            b = torch.randint(-8, 9, (k, nc), generator=gen,
                              device=dev).float()
            same = torch.equal(gk.indexmac_gather(vals, idx, b, cfg),
                               gk.indexmac_gather_plain(vals, idx, b, cfg))
            q8 = torch.randint(-127, 128, vals.shape, generator=gen,
                               device=dev, dtype=torch.int8)
            q8 = torch.where(vals == 0, torch.zeros_like(q8), q8)
            sc = torch.rand(mr, generator=gen, device=dev) * 0.09 + 0.01
            for bb in (b, b.to(torch.bfloat16)):
                same &= torch.equal(
                    gk.indexmac_gather_q(q8, idx, sc, bb, cfg),
                    gk.indexmac_gather_q_plain(q8, idx, sc, bb, cfg))
            if not same:
                fail(f"gather lattice not bit-exact: {cfg.tag} {layer}")
            print(f"lattice gather {cfg.tag} {layer}: bit-exact (float B "
                  "f32; int8 B f32 and bf16); two calls bit-identical at "
                  "every case", flush=True)
    return worst, report


def cnn_phase(dev, name, *, full=True, quantize=None):
    """One CNN forward through the kernels (counts zeroed just before,
    read just after), its time, and its logits against the plain path's
    on the same weights; then the forward as a CUDA graph
    (``SparseCNN.graphed``): the graph holds the eager forward's launches,
    its replayed logits are bit-equal to the eager forward's, and its
    time beside the eager one. Returns the launches of the eager
    forward."""
    import dataclasses

    from repro_torch.configs import get_cnn_config, get_cnn_reduced
    from repro_torch.core.cost_model import PEAK_OPS_PER_S
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.kernels import capture, registry
    from repro_torch.models.conv import SparseCNN

    on_card = dev.type == "cuda"
    cfg = get_cnn_config(name) if full else get_cnn_reduced(name)
    cfg = dataclasses.replace(cfg, sparsity=dataclasses.replace(
        cfg.sparsity, use_kernel=True))
    weights = quantize or "f32"
    t0 = time.perf_counter()
    model = SparseCNN.init(cfg, seed=0, dtype=torch.float32, device=dev,
                           quantize=quantize)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(CNN["batch"], cfg.input_hw, cfg.input_hw, 3,
                    generator=gen, device=dev)
    sparse = sum(c.nm is not None for c in model.convs.values())
    # floor of the compressed convs: the multiply-adds of their kept
    # non-zeros over the f32 (3xTF32) peak (their bytes take less)
    ops = sum(2 * CNN["batch"] * layer.h_out * layer.w_out
              * int((model.convs[layer.spec.name].vals != 0).sum())
              for layer in model.layers
              if model.convs[layer.spec.name].nm is not None)
    floor_ms = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    if full and sparse != CNN_DISPATCHES[name]:
        fail(f"cnn {name}: {sparse} compressed convs, expected "
             f"{CNN_DISPATCHES[name]}")
    op, impl = (("nm_matmul_q", "nm_spmm_q") if quantize
                else ("nm_matmul", "nm_spmm"))
    with torch.inference_mode():
        model(x)  # warm-up: cuBLAS, allocator
        if on_card:
            torch.cuda.synchronize()
        made = time.perf_counter() - t0
        kernels = zero_counts()
        got = model(x)
        if on_card:
            torch.cuda.synchronize()
        counts = registry.dispatch_counts()
        launches = {n: k.launches for n, k in kernels.items()}
        paths = path_launches(kernels)
        ms = peak = "not measured"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            ms = forward_ms(model, x)
            peak = torch.cuda.max_memory_allocated() / 2**30
        # the graphed forward: counts zeroed just before its first call
        # (the warm-up and the capture) and read after two replays
        kernels = zero_counts()
        model.graphed(x)
        replayed = model.graphed(x).clone()
        model.graphed(x)
        g_counts, g_launches = capture.ran_counts(
            model.graphs_captured(), registry.dispatch_counts(),
            {n: k.launches for n, k in kernels.items()})
        recs = model.graphs_captured()
        g_ms = forward_ms(model.graphed, x) if on_card else "not measured"
        for conv in model.convs.values():
            if conv.nm is not None:
                conv.kernel_policy = KernelPolicy("off")
        want = model(x)
    if counts != {(op, impl, dev.type): sparse}:
        fail(f"cnn {name} {weights}: dispatch counts {counts}, expected "
             f"{sparse} of {op}/{impl} and nothing else")
    stray = {n: v for n, v in launches.items() if n != impl and v}
    if stray or (on_card and launches[impl] != sparse):
        fail(f"cnn {name} {weights}: launches {launches}")
    check_paths(f"cnn {name} {weights}", paths, "dense", on_card)
    if on_card:
        rec, = recs
        if rec.launches != {impl: sparse} or rec.dispatches != {
                (op, impl, "cuda"): sparse}:
            fail(f"cnn {name} {weights}: the graph holds launches "
                 f"{rec.launches} and dispatches {rec.dispatches}, "
                 f"expected {sparse} of {impl} and nothing else")
        want_ran = {(op, impl, "cuda"): 3 * sparse}  # warm-up + 2 replays
        if g_counts != want_ran or g_launches[impl] != 3 * sparse:
            fail(f"cnn {name} {weights}: graphed forwards ran {g_counts}, "
                 f"launches {g_launches}, expected {want_ran}")
    if not torch.equal(replayed, got):
        fail(f"cnn {name} {weights}: graphed logits differ from the eager "
             f"forward's: max|diff| = "
             f"{float((replayed - got).abs().max())}")
    if got.shape != (CNN["batch"], cfg.num_classes) or not bool(
            torch.isfinite(got).all()):
        fail(f"cnn {name} {weights}: logits {tuple(got.shape)} or "
             "non-finite")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if err > 1e-3 * scale:
        fail(f"cnn {name} {weights}: max|kernels - plain| = {err} beyond "
             f"1e-3 * max|logits| = {1e-3 * scale}")
    rate = (f"eager {CNN['batch'] / ms * 1e3:.3f} images/s, {ms:.4f} ms per "
            f"forward; graphed {CNN['batch'] / g_ms * 1e3:.3f} images/s, "
            f"{g_ms:.4f} ms per forward (CUDA events over {CNN['iters']} "
            f"forwards each, this call); max_memory_allocated {peak:.3f} GiB"
            if on_card else "time not measured")
    rate += (f"; compressed convs {ops / 1e9:.3f} GFLOP of kept non-zeros, "
             f"floor {floor_ms:.4f} ms at the 3xTF32 peak")
    print(f"cnn {cfg.name} {weights} weights, batch {CNN['batch']} at "
          f"{cfg.input_hw}x{cfg.input_hw}: made and warmed in {made:.1f}s; "
          f"{op}/{impl} dispatches {sparse} (paths {paths[impl]}), "
          f"reference 0; graphed: {len(recs)} graph holding "
          f"{sum(sum(r.launches.values()) for r in recs)} launches, replayed "
          f"logits bit-equal to eager; logits "
          f"{tuple(got.shape)} max|kernels - plain| = {err:.3e} (max|logits| "
          f"{scale:.3e}, tolerance 1e-3 relative); {rate}", flush=True)
    return launches


def sweep_phase(dev, limit=None):
    """The measured fig4 mirror over the ResNet-50 layer GEMMs (the first
    ``limit`` of them when given). Returns the launches of the untimed
    passes, summed over both patterns."""
    from repro_torch.configs import get_cnn_config
    from repro_torch.core.cost_model import VectorCoreModel
    from repro_torch.core.nmweight import KernelPolicy, NMWeight
    from repro_torch.core.sparse_matmul import rowwise_spmm
    from repro_torch.core.sparsity import (
        NMConfig,
        apply_mask,
        compress_nm,
        decompress_nm,
        prune_mask_nm,
    )
    from repro_torch.kernels import registry
    from repro_torch.kernels.indexmac.ops import nm_matmul
    from repro_torch.kernels.indexmac_gather import kernel as gk
    from repro_torch.kernels.indexmac_gather.ops import indexmac_gather
    from repro_torch.models.conv import cnn_layer_gemms
    from repro_torch.quant import quantize_nm

    on_card = dev.type == "cuda"
    layers = cnn_layer_gemms(get_cnn_config("resnet50"))[:limit]
    model = VectorCoreModel()
    flush = torch.empty(2**30 if on_card else 1, dtype=torch.uint8,
                        device=dev)
    fams = {"nm_matmul": "nm_spmm", "indexmac_gather": "indexmac_gather",
            "indexmac_gather_q": "indexmac_gather_q"}

    def operands(m, k, n, cfg, seed):
        """W (k_run, C_out) in the conv orientation and its patches
        x (N, k_run); the same weight as the paper's A (C_out, k_run),
        compressed along its rows, float and int8; B = x^T."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        k_run = -(-k // cfg.m) * cfg.m
        w = torch.randn(k_run, m, generator=gen, device=dev) * k_run ** -0.5
        vals, idx = compress_nm(apply_mask(w, prune_mask_nm(w, cfg)), cfg)
        sw = NMWeight(vals, idx, cfg, 0, KernelPolicy("force"))
        a = decompress_nm(vals, idx, cfg).t().contiguous()
        gw = NMWeight(*compress_nm(a, cfg, axis=1), cfg, 1,
                      KernelPolicy("force"))
        x = torch.randn(n, k_run, generator=gen, device=dev)
        return k_run, x, sw, gw, quantize_nm(gw), x.t().contiguous()

    launches = dict.fromkeys(all_kernels(), 0)
    print("sweep layer         nm   C_out x K x N         nm_spmm_ms  "
          "rowwise_ms  gather_ms  gather_q_ms  matmul_ms  gather/rowwise  "
          "gather/matmul  model speedup", flush=True)
    for cfg in (NMConfig(1, 4), NMConfig(2, 4)):
        kernels = zero_counts()
        for i, (name, m, k, n) in enumerate(layers):
            _, x, sw, gw, qw, bt = operands(m, k, n, cfg, seed=i)
            y = nm_matmul(x, sw)
            c2 = rowwise_spmm(gw.vals, gw.idx, bt, cfg)
            c3 = indexmac_gather(gw, bt)
            c3q = indexmac_gather(qw, bt)
            want_q = gk.indexmac_gather_q_plain(qw.vals, qw.idx, qw.scales,
                                                bt, cfg)
            tol = TOL[torch.float32]
            for what, got, want in (("nm_matmul", y.t(), c2),
                                    ("gather", c3, c2),
                                    ("gather_q", c3q, want_q)):
                if not torch.allclose(got, want, rtol=tol, atol=tol):
                    fail(f"sweep {name} {cfg.tag}: {what} max|diff| "
                         f"{float((got - want).abs().max())} beyond {tol}")
        if on_card:
            torch.cuda.synchronize()
        counts = registry.dispatch_counts()
        want = {(op, impl, dev.type): len(layers)
                for op, impl in fams.items()}
        done = {name: kern.launches for name, kern in kernels.items()}
        if counts != want or (on_card and any(
                done[impl] != len(layers) for impl in fams.values())):
            fail(f"sweep {cfg.tag}: dispatch counts {counts}, launches "
                 f"{done}; expected {len(layers)} of each kernel")
        check_paths(f"sweep {cfg.tag}", path_launches(kernels), "dense",
                    on_card)
        for name, v in done.items():
            launches[name] += v
        total = dict.fromkeys(("nm", "row", "g", "gq", "mm"), 0.0)
        worst_f = (0.0, "")
        for i, (name, m, k, n) in enumerate(layers):
            k_run, x, sw, gw, qw, bt = operands(m, k, n, cfg, seed=i)
            a = decompress_nm(gw.vals, gw.idx, cfg, axis=1)  # f32 dense A
            t = dict(nm=time_ms(lambda: nm_matmul(x, sw), 10, flush),
                     row=time_ms(lambda: rowwise_spmm(gw.vals, gw.idx, bt,
                                                      cfg), 3, flush),
                     g=time_ms(lambda: indexmac_gather(gw, bt), 10, flush),
                     gq=time_ms(lambda: indexmac_gather(qw, bt), 10, flush),
                     mm=time_ms(lambda: torch.matmul(a, bt), 10, flush))
            for key, v in t.items():
                total[key] += v
            worst_f = max(worst_f, (t["g"] / t["mm"], name))
            print(f"sweep {name:13s} {cfg.tag} {m:5d} x {k_run:4d} x "
                  f"{n:5d} {t['nm']:11.5f} {t['row']:11.5f} "
                  f"{t['g']:10.5f} {t['gq']:12.5f} {t['mm']:10.5f} "
                  f"{t['row'] / t['g']:15.3f} {t['g'] / t['mm']:14.3f} "
                  f"{model.speedup(m, k_run, n, cfg):13.3f}", flush=True)
        print(f"sweep total {cfg.tag} ({len(layers)} layers): nm_spmm "
              f"{total['nm']:.5f} ms, rowwise {total['row']:.5f} ms, gather "
              f"{total['g']:.5f} ms, gather_q {total['gq']:.5f} ms, "
              f"matmul {total['mm']:.5f} ms; rowwise/gather "
              f"{total['row'] / total['g']:.3f}, gather/matmul "
              f"{total['g'] / total['mm']:.3f} (worst layer {worst_f[1]} "
              f"{worst_f[0]:.3f}); dispatches {len(layers)} of each kernel, "
              f"reference 0", flush=True)
    return launches


def attention_bound_ms(q, k, v, plan):
    """Least time of block-sparse attention (``cost_model.attention_cost``):
    the bytes (q, k, v and the output once each, the plan's mask tiles at
    a byte a token pair) over HBM bandwidth, or the operations of the
    live token pairs (2 (Dk + Dv) a pair and q head) over the dense peak
    of q's type."""
    from repro_torch.core import cost_model

    b, sq, hq, dk = q.shape
    _, skv, hkv, dv = v.shape
    return cost_model.attention_cost(
        b, sq, hq, dk, skv, hkv, dv, plan, dtype_bytes=q.element_size(),
        dtype=q.dtype).bound_ms()


def attention_phase(dev, cases=ATTN_CASES, heads=ATTN_HEADS,
                    what="attention"):
    """The block-sparse attention kernel against masked_reference at
    ``cases``, bf16 and f32; times. ``heads`` is (B, Hq, Hkv, dk[, dv]),
    the scale dk^-0.5. Returns (worst |err|, the numbers of the first
    case in bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels.blocksparse_attn import kernel as bk
    from repro_torch.kernels.blocksparse_attn.mask import (
        MaskSpec,
        compile_mask,
    )
    from repro_torch.kernels.blocksparse_attn.ref import (
        blocksparse_mma,
        blocksparse_torch,
        masked_reference,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    flush = torch.empty(2**30 if dev.type == "cuda" else 1,
                        dtype=torch.uint8, device=dev)
    b, hq, hkv, d = heads[:4]
    dv = heads[4] if len(heads) > 4 else d
    worst, report = 0.0, None
    print(f"{what} (B {b}, Hq {hq}, Hkv {hkv}, dk {d}, dv {dv}) mask  "
          "dtype  Sq    density  max|err|   kernel_ms  masked_ref_ms  "
          "gather_ms    sdpa_ms   bound_ms (by)", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for sq, args in cases:
            spec = MaskSpec(**args)
            plan = compile_mask(spec, sq, sq)
            if plan is None:
                fail(f"attention: {spec.tag} does not tile at {sq}")
            q, k, v = (torch.randn(b, sq, h, w, generator=gen,
                                   device=dev).to(dtype)
                       for h, w in ((hq, d), (hkv, d), (hkv, dv)))
            got = bk.bs_attention(q, k, v, plan).float()
            want = masked_reference(q, k, v, spec=spec).float()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = TOL[dtype]
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            if got.shape != want.shape or not torch.allclose(
                    got, want, rtol=tol, atol=tol):
                fail(f"{what} {spec.tag} {dt} Sq={sq}: max|kernel - "
                     f"masked_reference| = {err} beyond {tol}")
            twin = blocksparse_mma(q, k, v, plan=plan).float()
            twin_err = float((got - twin).abs().max())
            if not torch.allclose(got, twin, rtol=tol, atol=tol):
                fail(f"{what} {spec.tag} {dt} Sq={sq}: max|kernel - "
                     f"blocksparse_mma| = {twin_err} beyond {tol}")
            del twin
            worst = max(worst, err)
            allowed = torch.as_tensor(plan.tokens[:sq, :sq], device=dev)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=allowed, scale=d ** -0.5,
                    enable_gqa=True)

            sdpa_err = float((sdpa().transpose(1, 2).float() - want)
                             .abs().max())
            ms = time_ms(lambda: bk.bs_attention(q, k, v, plan), 20, flush)
            ref_ms = time_ms(lambda: masked_reference(q, k, v, spec=spec), 3,
                             flush)
            plain_ms = time_ms(lambda: blocksparse_torch(
                q, k, v, plan=plan), 5, flush)
            lib_ms = time_ms(sdpa, 20, flush)
            bms, by = attention_bound_ms(q, k, v, plan)
            print(f"{what} {spec.tag:26s} {dt:5s} {sq:5d} "
                  f"{plan.density:7.4f}  {err:.3e} {ms:10.5f} {ref_ms:14.5f} "
                  f"{plain_ms:10.5f} {lib_ms:10.5f} {bms:10.5f} ({by}); "
                  f"{plan.n_live} live pairs of {plan.nqb * plan.nkb}, "
                  f"{plan.live_tokens} live token pairs, waste "
                  f"{plan.waste:.4f}; max|kernel - blocksparse_mma| "
                  f"{twin_err:.3e}; sdpa max|err| {sdpa_err:.3e}",
                  flush=True)
            if report is None:
                report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              bound_by=by, library_ms=lib_ms)
    return worst, report


def masked_reference_phase(dev) -> None:
    """Reduced yi-9b in f32 with a local mask: logits through the
    block-sparse path against the same weights with the dense window
    (prefill, decode), and greedy streams equal to the dense window's."""
    import dataclasses

    from repro_torch.kernels import registry
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
    from repro_torch.launch.serve import build_model, serve
    from repro_torch.models.cache import CacheView

    spec = MaskSpec("local", block=8, window=12)
    small, lm = build_model("yi-9b", full=False, kernels=True,
                            dtype=torch.float32, seed=1, device=dev,
                            mask=spec)
    gqa = [layer.mixer for layer in lm.layers]
    masked = [g.cfg for g in gqa]
    dense = [dataclasses.replace(c, mask=None, window=12) for c in masked]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    toks = torch.randint(0, small.vocab_size, (2, 16), generator=gen,
                         device=dev)

    def run(cfgs):
        for g, c in zip(gqa, cfgs):
            g.cfg = c
        cache = lm.init_cache(2, 32)
        lp, cache = lm(toks, view=CacheView.prefill(), caches=cache)
        ld, _ = lm(lp[:, -1].argmax(-1, keepdim=True),
                   view=CacheView.decode(torch.tensor([16, 16])),
                   caches=cache)
        _, done, _ = serve(lm, requests=4, slots=2, prefill_len=16,
                           max_new=8, max_seq=24)
        return lp, ld, {r.rid: r.out for r in done}

    with torch.inference_mode():
        registry.clear_history()
        mp, md, mstream = run(masked)
        counts = registry.dispatch_counts("bs_attention")
        dp, dd, dstream = run(dense)
    impl = "cuda_bs_attention" if dev.type == "cuda" else "torch_bs_attention"
    if not counts.get(("bs_attention", impl, dev.type)) or any(
            k[1] not in (impl, "masked_decode") for k in counts):
        fail(f"masked reference: the block-sparse path did not serve: "
             f"{counts}")
    for what, a, b in (("prefill", mp, dp), ("decode", md, dd)):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            fail(f"masked reference {what}: shape {tuple(a.shape)} or "
                 "non-finite logits")
        err = float((a - b).abs().max())
        if err > 1e-4:
            fail(f"masked reference {what}: max|masked - dense window| = "
                 f"{err}")
        print(f"masked reference: reduced yi-9b f32, {spec.tag}, {what} "
              f"logits {tuple(a.shape)} max|masked - dense window 12| = "
              f"{err:.3e} (tolerance 1e-4)", flush=True)
    if mstream != dstream:
        fail(f"masked reference: greedy streams differ: {mstream} vs "
             f"{dstream}")
    print(f"masked reference: greedy streams of {len(mstream)} requests "
          f"equal to the dense window's; dispatches {counts}", flush=True)


def masked_serve_phase(dev, *, full=True, sizes=MASKED_SERVE, arch="yi-9b",
                       what="masked serve"):
    """Full-width ``arch`` with a local mask on every block serves
    ``sizes["requests"]`` requests; the dispatch and launch counts of that
    serve; then one prefill against the dense window (for information),
    whose bs_attention calls must run at the model's head dims. MLA's
    decode applies the mask inline (no bs_attention_decode dispatch).
    Returns the launches of each kernel in the serve."""
    import dataclasses

    from repro_torch.kernels import registry
    from repro_torch.kernels.blocksparse_attn import ops as bs_ops
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
    from repro_torch.launch.serve import build_model, serve
    from repro_torch.models.cache import CacheView

    on_card = dev.type == "cuda"
    be = dev.type
    spec = MaskSpec("local", block=64, window=192)
    impl = "cuda_bs_attention" if on_card else "torch_bs_attention"
    t0 = time.perf_counter()
    cfg, lm = build_model(arch, full=full, layers=sizes["layers"],
                          kernels=True, dtype=torch.bfloat16, seed=0,
                          device=dev, mask=spec)
    mx = cfg.plan[0][0].mixer
    mla = mx.kind == "mla"
    dk = mx.nope_head_dim + mx.rope_head_dim if mla else mx.head_dim
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    print(f"{what}: {cfg.name} d_model={cfg.d_model} layers="
          f"{cfg.n_layers} bf16, {spec.tag}, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    slots, plen = sizes["slots"], sizes["prefill_len"]
    kw = dict(slots=slots, prefill_len=plen, max_seq=plen + sizes["max_new"])
    kernels = zero_counts()
    eng, done, dt = serve(lm, requests=sizes["requests"],
                          max_new=sizes["max_new"], **kw)
    counts, launches = ran(eng, kernels, registry.dispatch_counts())
    paths = path_launches(kernels)
    stats = eng.throughput_stats()
    if len(done) != sizes["requests"] or any(
            len(r.out) != sizes["max_new"] for r in done):
        fail(f"{what}: {len(done)} of {sizes['requests']} requests "
             "finished")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out):
        fail(f"{what}: a token outside the vocabulary")
    layers = cfg.n_layers
    prefills = -(-sizes["requests"] // slots)
    want = {("nm_matmul", "nm_spmm", be), ("nm_matmul_decode",
                                           "nm_spmm_decode", be),
            ("bs_attention", impl, be)}
    if not mla:
        want.add(("bs_attention_decode", "masked_decode", be))
    served = {"nm_spmm", "nm_spmm_decode", "bs_attention"}
    stray = {n: v for n, v in launches.items() if n not in served and v}
    idle = [n for n in served if launches[n] == 0]
    if (set(counts) != want
            or counts[("bs_attention", impl, be)] != layers * prefills
            or counts.get(("bs_attention_decode", "masked_decode", be), 0)
            != (0 if mla else layers * stats["decode_steps"])
            or stray or (on_card and (idle or launches["bs_attention"]
                                      != layers * prefills))):
        fail(f"{what}: dispatch counts {counts}, launches {launches}; "
             f"expected {layers} {impl} per prefill ({prefills}), "
             f"{0 if mla else layers} masked_decode per decode step "
             f"({stats['decode_steps']}) and the N:M kernels, nothing else")
    check_paths(what, paths, "sparse", on_card)
    check_graphs(what, eng, on_card)
    if on_card:
        print(f"{what}: one decode-graph replay "
              f"{replay_ms(eng._decode):.3f} ms, one prefill-graph replay "
              f"{replay_ms(eng._prefill, iters=3):.3f} ms of card time "
              "(CUDA events)", flush=True)
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
            if on_card else "not measured")
    print(f"{what}: {stats['requests']} requests of {plen} tokens, "
          f"{stats['tokens']} tokens in {dt:.4f}s = {stats['tokens'] / dt:.3f}"
          f" tok/s; TTFT mean {stats['ttft_s'] * 1e3:.3f} ms p50 "
          f"{stats['ttft_p50_s'] * 1e3:.3f} ms; ITL p50 "
          f"{stats['itl_p50_s'] * 1e3:.3f} ms p99 "
          f"{stats['itl_p99_s'] * 1e3:.3f} ms; decode steps "
          f"{stats['decode_steps']}; max_memory_allocated {peak}", flush=True)
    print(f"{what}: dispatch counts "
          + ", ".join(f"{op}/{i}/{b}={v}"
                      for (op, i, b), v in sorted(counts.items()))
          + f"; launches {launches}; prefill launches by path {paths}",
          flush=True)
    # one prefill of the same weights with the mask, then with the dense
    # window it encodes (host clock around a synchronised call)
    gqa = [layer.mixer for layer in lm.layers]
    masked = [g.cfg for g in gqa]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (slots, plen), generator=gen,
                         device=dev)
    times = {}
    with torch.inference_mode():
        for label, cfgs in (
                ("masked", masked),
                ("dense window", [dataclasses.replace(
                    c, mask=None, window=spec.window) for c in masked])):
            for g, c in zip(gqa, cfgs):
                g.cfg = c
            cache = lm.init_cache(slots, kw["max_seq"])
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm(toks, view=CacheView.prefill(), caches=cache)
            if on_card:
                torch.cuda.synchronize()
            times[label] = (time.perf_counter() - t0) * 1e3
        # the kernel's calls in one masked prefill, with their head dims
        calls, real = [], bs_ops._bs_kernel

        def spy(q, k, v, plan, scale=None):
            calls.append((q.shape[1], k.shape[1], q.shape[-1], v.shape[-1]))
            return real(q, k, v, plan, scale)

        for g, c in zip(gqa, masked):
            g.cfg = c
        bs_ops._bs_kernel = spy
        try:
            lm(toks, view=CacheView.prefill(),
               caches=lm.init_cache(slots, kw["max_seq"]))
        finally:
            bs_ops._bs_kernel = real
    dv = mx.v_head_dim if mla else dk
    if on_card and calls != [(plen, plen, dk, dv)] * layers:
        fail(f"{what}: the kernel's calls in a masked prefill at (Sq, Skv, "
             f"dk, dv) {calls}, expected {layers} at {(plen, plen, dk, dv)}")
    print(f"{what}: one ({slots}, {plen}) prefill, masked "
          f"{times['masked']:.3f} ms, dense window {spec.window} "
          f"{times['dense window']:.3f} ms (host clock, for information); "
          f"its {len(calls)} bs_attention kernel calls at dk {dk}, dv {dv}",
          flush=True)
    return launches


def mla_masked_reference_phase(dev) -> None:
    """Reduced deepseek in f32 with MaskSpec("causal", block=8) on every
    MLA layer: prefill and decode logits through the block-sparse kernel
    (prefill) and the inline predicate (decode) against the same weights
    with dense causal attention, within 1e-4."""
    import dataclasses

    from repro_torch.kernels import registry
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
    from repro_torch.launch.serve import build_model
    from repro_torch.models.cache import CacheView

    spec = MaskSpec("causal", block=8)
    small, lm = build_model(DEEPSEEK, full=False, kernels=True,
                            dtype=torch.float32, seed=1, device=dev)
    mixers = [layer.mixer for layer in lm.layers]
    dense = [m.cfg for m in mixers]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    toks = torch.randint(0, small.vocab_size, (2, 16), generator=gen,
                         device=dev)

    def run(cfgs):
        for m, c in zip(mixers, cfgs):
            m.cfg = c
        cache = lm.init_cache(2, 32)
        lp, cache = lm(toks, view=CacheView.prefill(), caches=cache)
        ld, _ = lm(lp[:, -1].argmax(-1, keepdim=True),
                   view=CacheView.decode(torch.tensor([16, 16])),
                   caches=cache)
        return lp, ld

    with torch.inference_mode():
        dp, dd = run(dense)
        registry.clear_history()
        mp, md = run([dataclasses.replace(c, mask=spec, window=None)
                      for c in dense])
        counts = registry.dispatch_counts("bs_attention")
    impl = "cuda_bs_attention" if dev.type == "cuda" else "torch_bs_attention"
    if counts != {("bs_attention", impl, dev.type): small.n_layers}:
        fail(f"mla masked reference: dispatches {counts}, expected "
             f"{small.n_layers} {impl} (decode applies the mask inline)")
    for what, a, b in (("prefill", mp, dp), ("decode", md, dd)):
        err = float((a - b).abs().max())
        if a.shape != b.shape or not bool(torch.isfinite(a).all()) or \
                err > 1e-4:
            fail(f"mla masked reference {what}: shape {tuple(a.shape)}, "
                 f"max|masked - dense causal| = {err}")
        print(f"mla masked reference: reduced {DEEPSEEK} f32, {spec.tag}, "
              f"{what} logits {tuple(a.shape)} max|masked - dense causal| "
              f"= {err:.3e} (tolerance 1e-4); dispatches {counts}",
              flush=True)


def moe_capacity(lm, factor) -> None:
    """Set every MoE layer's capacity factor (None: the config's)."""
    import dataclasses

    from repro_torch.models.moe import MoE

    for layer in lm.layers:
        mlp = layer.mlp
        if isinstance(mlp, MoE):
            mlp.cfg = dataclasses.replace(
                mlp.cfg, capacity_factor=layer.block.mlp.capacity_factor
                if factor is None else factor)


def deepseek_cut_phase(dev, *, full=True, layers=DS_CUT_LAYERS) -> None:
    """deepseek at full width cut to ``layers`` layers: the serve's
    requests graphed and eagerly (bf16, then int8 weights); the paged
    engine against the slot engine; the fp8 cache against bf16; and a
    masked serve of 1024-token prompts (bs_attention at dk 192, dv 128).

    Paged against slot: an expert keeps at most C (capacity) of a step's
    assignments, so a token's output depends on which requests share its
    step once an expert overflows, and a preemption changes that for the
    requests served after it. So the paged run makes every MoE layer
    dropless (capacity factor E / k: C >= the step's tokens), and its
    streams must equal the slot engine's."""
    from repro_torch.launch.serve import build_model

    for quantize in (None, "int8"):
        serve_phase(dev, full=full, layers=layers, quantize=quantize,
                    arch=DEEPSEEK, what=f"deepseek {layers}L serve")
        gc.collect()
    t0 = time.perf_counter()
    cfg, lm = build_model(DEEPSEEK, full=full, layers=layers, kernels=True,
                          dtype=torch.bfloat16, seed=0, device=dev)
    print(f"deepseek {layers}L: {cfg.name} d_model={cfg.d_model} layers="
          f"{cfg.n_layers} bf16, made in {time.perf_counter() - t0:.1f}s",
          flush=True)
    moe = cfg.plan[-1][0].mlp
    moe_capacity(lm, moe.n_experts / moe.top_k)
    paged = dict(PAGED_SERVE, layers=layers)
    paged_serve_phase(dev, sizes=paged, lm=lm,
                      what=f"deepseek {layers}L paged serve, dropless")
    moe_capacity(lm, None)
    fp8_phase(dev, lm, label=f"deepseek {layers}L fp8")
    del lm
    gc.collect()
    masked_serve_phase(dev, full=full, sizes=dict(MASKED_SERVE, layers=layers),
                       arch=DEEPSEEK, what=f"deepseek {layers}L masked serve")


def witness_phase(lm, what, c=WITNESS_C, slots=SERVE["slots"],
                  prefill_len=SERVE["prefill_len"]) -> None:
    """``repro_torch.launch.witness.f32_witness`` on the served model
    (``slots`` x ``prefill_len``, SERVE's by default, REF_DECODE_STEPS
    decode steps): through the kernels, every layer (an encoder's too)
    and the logits of every call lie at most ``c`` times as far (root
    mean square) from the same weights' f32 answer as the plain bf16
    path's do."""
    from repro_torch.launch.witness import f32_witness, ratio, worst

    try:
        rows = f32_witness(lm, slots=slots, prefill_len=prefill_len,
                           steps=REF_DECODE_STEPS)
    except ValueError as e:
        fail(f"{what}: {e}")
    for _, where, kern, base in rows:
        if ratio(kern, base) > c:
            fail(f"{what} {where}: rms(kernels - f32) = {kern:.3e} is "
                 f"{ratio(kern, base):.3f}x the plain bf16 path's "
                 f"{base:.3e}, beyond {c}")
    w = worst(rows)
    print(f"{what}: rms(kernels - f32) / rms(plain bf16 - f32) on the same "
          f"weights, worst layer {w['layer'][0]:.3f} ({w['layer'][1]}), "
          f"worst logits {w['logits'][0]:.3f} ({w['logits'][1]}); held "
          f"within {c}, {len(lm.layers)} layers"
          + (f" and {len(lm.enc_layers)} encoder layers" if lm.enc_layers
             else "")
          + f", a prefill of {slots} x {prefill_len} and "
          f"{REF_DECODE_STEPS} decode steps", flush=True)


def recurrent_phase(dev, arch, *, full=True, layers=None,
                    quantizes=(None,)) -> dict:
    """Full-width ``arch`` (cut to ``layers``), bf16 activations, each of
    ``quantizes`` (bf16 or int8 weights): the serve phase's requests
    graphed and eagerly, each request also served alone (the state reset
    makes a slot's occupant irrelevant), its launches checked as there;
    then ``witness_phase``. An MoE model serves with
    every MoE layer dropless (capacity factor E / k), then once more at
    the config's factor, whose streams are reported against the
    dropless ones. Returns the launches of each kernel, summed."""
    import collections

    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.serve import build_model, serve

    total = collections.Counter()
    label = {RWKV: "rwkv", JAMBA: "jamba"}[arch]
    for quantize in quantizes:
        t0 = time.perf_counter()
        cfg, lm = build_model(arch, full=full, layers=layers, kernels=True,
                              dtype=torch.bfloat16, seed=0, device=dev,
                              quantize=quantize)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"{label} serve: {cfg.name}, {cfg.n_layers} layers, "
              f"{quantize or 'bf16'} weights, made in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        moe = next((b.mlp for b in cfg.blocks()
                    if isinstance(b.mlp, MoEConfig)), None)
        what = f"{label} serve"
        if moe is not None:
            moe_capacity(lm, moe.n_experts / moe.top_k)
            what += " dropless"
        launches, _, got = serve_phase(
            dev, quantize=quantize, arch=arch, model=(cfg, lm), alone=True,
            what=what)
        total.update(launches)
        witness_phase(lm, f"{what} {quantize or 'bf16'} f32 witness")
        if moe is not None:
            moe_capacity(lm, None)
            eng, done, dt = serve(
                lm, requests=SERVE["requests"], max_new=SERVE["max_new"],
                slots=SERVE["slots"], prefill_len=SERVE["prefill_len"],
                max_seq=SERVE["prefill_len"] + SERVE["max_new"])
            same = sum(streams(done)[r] == got[r] for r in got)
            print(f"{label} serve at capacity factor "
                  f"{moe.capacity_factor}: {same} of {len(got)} greedy "
                  f"streams equal to the dropless serve's; "
                  f"{serve_line(eng.throughput_stats(), dt)}", flush=True)
        del lm
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return dict(total)


def whisper_serve_phase(dev, *, full=True, quantize=None,
                        sizes=WHISPER_SERVE) -> dict:
    """Whisper (full width and depth unless ``full`` is False) with random
    2:4 weights from seed 0, bf16 or int8, served through
    ``make_serve_steps``: one prefill (encoder, cross K/V written) and
    ``max_new - 1`` greedy decode steps of ``sizes["slots"]`` prompts with
    random frames, through the captured graphs; then new prompts and
    frames through the same graphs (replayed), then both eagerly: equal
    streams. One graph a step kind, the prefill graph holding one launch
    a compressed Linear of the encoder and decoder, the decode graph one
    a decoder Linear but the cross wk / wv; no reference dispatch; the
    prefill on the sparse path. Then the f32 witness. Returns the
    launches of each kernel (what ran on the card, counted from zero)."""
    from repro_torch.core.cost_model import HBM_BYTES_PER_S
    from repro_torch.kernels import capture, registry
    from repro_torch.launch.profile_decode import cross_bytes
    from repro_torch.launch.serve import (
        build_model,
        encdec_inputs,
        serve_encdec,
    )

    on_card = dev.type == "cuda"
    weights = quantize or "bf16"
    what = f"whisper serve {weights}"
    t0 = time.perf_counter()
    cfg, lm = build_model(WHISPER, full=full, kernels=True,
                          dtype=torch.bfloat16, seed=0, device=dev,
                          quantize=quantize)
    if on_card:
        torch.cuda.synchronize()
    print(f"{what}: {cfg.name} d_model={cfg.d_model} {len(lm.enc_layers)} "
          f"encoder + {cfg.n_layers} decoder layers, {cfg.encoder_seq} "
          f"frames, bf16 activations, {weights} weights, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    pre_n, dec_n = gemms_per_step(cfg), gemms_per_step(cfg, decode=True)
    if compressed_linears(lm) != pre_n:
        fail(f"{what}: {compressed_linears(lm)} compressed Linears, the "
             f"config's shapes give {pre_n}")
    b, s, new = sizes["slots"], sizes["prefill_len"], sizes["max_new"]
    inputs = [encdec_inputs(lm, slots=b, prefill_len=s, seed=seed)
              for seed in (1, 2)]
    serve_encdec(lm, *inputs[0], max_new=2, graphs=False)  # warm-up
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    caches = lm.init_cache(b, s + new)  # the graphs write them by address
    kernels = zero_counts()
    got, t_pre, times, steps = serve_encdec(lm, *inputs[0], max_new=new,
                                            caches=caches)
    got2, t_pre2, times2, _ = serve_encdec(lm, *inputs[1], max_new=new,
                                           steps=steps, caches=caches)
    prefill, decode = steps
    counts, launches = capture.ran_counts(
        prefill.captured + decode.captured, registry.dispatch_counts(),
        {name: kern.launches for name, kern in kernels.items()})
    paths = path_launches(kernels)
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
            if on_card else "not measured")
    q = "_q" if quantize else ""
    if on_card and (len(prefill.built), len(decode.built)) != (1, 1):
        fail(f"{what}: graphs built prefill {len(prefill.built)}, decode "
             f"{len(decode.built)}; expected one a step kind")
    for kind, step, fam, n in (("prefill", prefill, "nm_spmm", pre_n),
                               ("decode", decode, "nm_spmm_decode", dec_n)):
        for r in step.captured:
            ref = {k: v for k, v in r.dispatches.items()
                   if "reference" in k[1]}
            if ref or r.launches != {fam + q: n}:
                fail(f"{what}: the {kind} graph holds {r.launches} and "
                     f"reference dispatches {ref}; the model's shapes give "
                     f"{{{fam + q!r}: {n}}} and none")
            print(f"{what}: {kind} graph {r.signature}: replayed "
                  f"{r.replays} times, holds {r.launches}", flush=True)
    wrong = {k: v for k, v in counts.items() if "reference" in k[1]}
    if wrong:
        fail(f"{what}: reference dispatches {wrong}")
    check_paths(what, paths, "sparse", on_card)
    for out in (got, got2):
        if out.shape != (b, new) or not ((0 <= out) & (
                out < cfg.vocab_size)).all():
            fail(f"{what}: streams of shape {out.shape} or outside the "
                 "vocabulary")
    for i, out in enumerate((got, got2)):
        eager, _, etimes, _ = serve_encdec(lm, *inputs[i], max_new=new,
                                           graphs=False)
        if not (eager == out).all():
            fail(f"{what}: greedy streams of the graphs (frames {i + 1}) "
                 f"differ from the eager steps': {out.tolist()} vs "
                 f"{eager.tolist()}")
    busy = (f"{replay_ms(decode):.3f} ms" if on_card else "not measured")
    busy_pre = (f"{replay_ms(prefill, iters=3):.3f} ms" if on_card
                else "not measured")
    floor = floor_ms(lm, slots=b)
    cross = cross_bytes(lm, b) / HBM_BYTES_PER_S * 1e3
    itl = statistics.median(times[1:] + times2[1:]) * 1e3
    print(f"{what}: {b} slots x {s} tokens, {cfg.encoder_seq} frames "
          f"each, {new} tokens each; the second prompts and frames through "
          "the same two graphs; greedy streams equal to the eager steps' "
          f"(both frame sets); prefill {t_pre2 * 1e3:.3f} ms (replayed, to "
          f"the sampled ids on the host), decode step p50 {itl:.3f} ms a "
          f"token; one decode-graph replay {busy}, one prefill-graph "
          f"replay {busy_pre} of card time (CUDA events); ITL floor "
          f"{floor:.3f} ms (the decoder's weights, the f32 head and "
          f"{cross:.3f} ms of cross K/V of {b} slots at HBM rate); "
          f"max_memory_allocated {peak}; launches {launches}", flush=True)
    witness_phase(lm, f"{what} f32 witness", slots=b, prefill_len=s)
    del lm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return launches


def gemma3_phase(dev, *, full=True, layers=None, cut=GEMMA_CUT,
                 paged=GEMMA_PAGED) -> dict:
    """gemma3-27b at full width, its full depth (``layers`` cuts it),
    bf16: the serve phase's requests, then GEMMA_LONG's (prompts longer
    than the window), each graphed and eagerly (serve_phase's gates: one
    launch a compressed Linear in each graph, 434 at full depth; no
    reference dispatch; equal streams; peak memory). Then cut to ``cut``
    layers: int8 weights through both request sets, and bf16 through the
    paged engine with the long prompts against the slot engine, and the
    f32 witness on the long prompts. Returns the launches of each kernel
    of the serves."""
    import collections

    from repro_torch.launch.serve import build_model

    on_card = dev.type == "cuda"
    total = collections.Counter()
    t0 = time.perf_counter()
    cfg, lm = build_model(GEMMA, full=full, layers=layers, kernels=True,
                          dtype=torch.bfloat16, seed=0, device=dev)
    if on_card:
        torch.cuda.synchronize()
    print(f"gemma3 serve: {cfg.name} d_model={cfg.d_model} "
          f"layers={cfg.n_layers}, vocab {cfg.vocab_size} (tied), bf16, "
          f"made in {time.perf_counter() - t0:.1f}s", flush=True)
    head_phase(lm, SERVE["slots"])
    for sizes, label in ((SERVE, "serve"), (GEMMA_LONG, "long prompts")):
        launches, _, _ = serve_phase(dev, arch=GEMMA, model=(cfg, lm),
                                     sizes=sizes,
                                     what=f"gemma3 {label}")
        total.update(launches)
    del lm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    for quantize in ("int8", None):
        ccfg, clm = build_model(GEMMA, full=full, layers=cut, kernels=True,
                                dtype=torch.bfloat16, seed=0, device=dev,
                                quantize=quantize)
        if quantize:
            for sizes, label in ((SERVE, "serve"),
                                 (GEMMA_LONG, "long prompts")):
                launches, _, _ = serve_phase(
                    dev, arch=GEMMA, model=(ccfg, clm), sizes=sizes,
                    quantize=quantize, what=f"gemma3 {cut}L {label}")
                total.update(launches)
        else:
            paged_serve_phase(dev, sizes=paged, lm=clm,
                              what=f"gemma3 {cut}L paged serve")
            witness_phase(clm, f"gemma3 {cut}L f32 witness",
                          slots=GEMMA_LONG["slots"],
                          prefill_len=GEMMA_LONG["prefill_len"])
        del clm
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return dict(total)


def head_phase(lm, rows: int) -> None:
    """The tied head (``Embedding.attend``) on ``rows`` random bf16 rows
    against x.float() @ table.float().T, taken in chunks of 32,768 table
    rows (1e-4: the same exact products, summed in another order); its
    card ms beside the bound (the table read once) and beside the f32
    product of one chunk scaled to the whole table."""
    from repro_torch.core import cost_model

    emb = lm.embed
    vocab, d = emb.table.shape
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(9)
    x = torch.randn(rows, d, generator=gen, device=lm.device).to(lm.dtype)
    with torch.inference_mode():
        got = emb.attend(x)
        want = torch.cat([x.float() @ emb.table[v:v + 32768].float().t()
                          for v in range(0, vocab, 32768)], -1)
    err = float((got - want).abs().max())
    if got.shape != (rows, vocab) or got.dtype != torch.float32 or not (
            torch.allclose(got, want, rtol=1e-4, atol=1e-4)):
        fail(f"tied head: {tuple(got.shape)} {got.dtype}, max|head - f32| "
             f"{err} beyond 1e-4")
    if lm.device.type != "cuda":
        print(f"tied head: ({rows}, {d}) x ({vocab}, {d})^T, max|head - "
              f"f32| {err:.3e} (tolerance 1e-4)", flush=True)
        return
    flush = torch.empty(2**30, dtype=torch.uint8, device=lm.device)
    ms = time_ms(lambda: emb.attend(x), 10, flush)
    chunk = emb.table[:32768]
    f32_ms = time_ms(lambda: x.float() @ chunk.float().t(), 10,
                     flush) * vocab / 32768
    bms, by = cost_model.roofline_ms(
        emb.table.numel() * emb.table.element_size()
        + rows * (d * 2 + vocab * 4), 2 * rows * vocab * d, torch.bfloat16)
    print(f"tied head: ({rows}, {d}) x ({vocab}, {d})^T, max|head - f32| "
          f"{err:.3e} (tolerance 1e-4); {ms:.5f} ms a call, bound "
          f"{bms:.5f} ms ({by}); the f32 product through an f32 copy of "
          f"the table, by chunks of 32,768 rows, {f32_ms:.5f} ms",
          flush=True)


def gqa_configs_phase(dev, *, full=True, layers=GQA_LAYERS) -> dict:
    """The three plain-GQA configs at full width cut to ``layers``, bf16:
    the serve phase's requests through the captured steps (serve_phase's
    gates: one launch a compressed Linear in each graph, no reference
    dispatch). Returns the launches of each kernel."""
    import collections

    total = collections.Counter()
    for arch in GQA_ARCHS:
        launches, _, _ = serve_phase(dev, full=full, layers=layers,
                                     arch=arch, eager=False,
                                     what=f"{arch} {layers}L serve")
        total.update(launches)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return dict(total)


def train_phase(dev, *, full=True, sizes=TRAIN, arch="yi-9b",
                what="train") -> int:
    """Train ``arch`` (full width, ``sizes["layers"]`` deep (None: its
    full depth), random 2:4 weights from seed 0, f32 weights, bf16
    compute) through the train entry point's ``build_trainer`` /
    ``make_train_step``; an encoder-decoder's batches carry the same
    random frames (batch, encoder_seq, d_model) from seed 0. Step 1's loss
    and grad_norm through the kernels against the same step under policy
    "off" (no update). Then ``sizes["steps"]`` steps with the counts
    zeroed just before and read just after: every loss finite, the mean
    of the last 5 below the first 5, one nm_spmm launch (sparse path) a
    compressed Linear a forward and no other dispatch. ms a step,
    tokens/s, one more step's forward / backward / optimizer split (CUDA
    events) and peak memory. Returns nm_spmm's launches."""
    from repro_torch.core.nmweight import KernelPolicy
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.kernels import registry
    from repro_torch.launch.train import (
        build_trainer,
        step_split,
        with_enc_input,
    )
    from repro_torch.models.common import Linear
    from repro_torch.optim.optimizer import AdamWConfig, global_norm
    from repro_torch.training.train_loop import (
        TrainConfig,
        param_grads,
        to_device,
        trainable,
    )

    on_card = dev.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(opt=AdamWConfig(lr=sizes["lr"],
                                       warmup_steps=sizes["warmup"],
                                       total_steps=sizes["steps"]),
                       remat="none")
    t0 = time.perf_counter()
    cfg, lm, opt, step = build_trainer(
        arch, full=full, layers=sizes["layers"], device=dev, tcfg=tcfg)
    params = trainable(lm)
    frames = None
    if cfg.encoder_plan is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        frames = torch.randn(sizes["batch"], cfg.encoder_seq, cfg.d_model,
                             generator=gen, device=dev)
    if on_card:
        torch.cuda.synchronize()
    rows = sizes["batch"] * sizes["seq"]
    enc_rows = f", encoder M = {sizes['batch'] * cfg.encoder_seq}" if (
        frames is not None) else ""
    print(f"{what}: {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers}"
          + (f" + {len(lm.enc_layers)} encoder" if frames is not None
             else "")
          + f", {sum(p.numel() for p in params.values())} f32 params, bf16 "
          f"compute, batch {sizes['batch']} x seq {sizes['seq']} (nm_spmm "
          f"M = {rows}{enc_rows}), made in {time.perf_counter() - t0:.1f}s",
          flush=True)
    per_fwd = compressed_linears(lm)

    class Pipe:  # the data pipeline, an encoder-decoder's frames added
        def __init__(self):
            self.inner = DataPipeline(PipelineConfig(
                vocab_size=cfg.vocab_size, seq_len=sizes["seq"],
                global_batch=sizes["batch"]))

        def next(self):
            return with_enc_input(self.inner.next(), cfg, frames)

    def pipeline():
        return Pipe()

    first = to_device(pipeline().next(), dev)

    def loss_and_norm():
        loss, _ = lm.loss(first)
        return (float(loss.detach()),
                float(global_norm(param_grads(loss, params))))

    linears = [m for m in lm.modules()
               if isinstance(m, Linear) and m.nm is not None]
    registry.clear_history()
    kern = loss_and_norm()
    for m in linears:
        m.kernel_policy = KernelPolicy("off")
    plain = loss_and_norm()
    for m in linears:
        m.kernel_policy = KernelPolicy("auto")
    used = {k[1] for k in registry.dispatch_counts()}
    if used != {"nm_spmm", "reference"}:
        fail(f"{what} step-1 parity: dispatched {sorted(used)}")
    for i, key in enumerate(("loss", "grad_norm")):
        rel = abs(kern[i] - plain[i]) / abs(plain[i])
        if not rel <= TRAIN_TOL[key]:
            fail(f"{what} step 1: {key} {kern[i]} through the kernels, "
                 f"{plain[i]} under policy off: {rel:.2e} > "
                 f"{TRAIN_TOL[key]}")
    print(f"{what} step 1 (no update): loss {kern[0]!r} (kernels) vs "
          f"{plain[0]!r} (policy off), grad_norm {kern[1]!r} vs "
          f"{plain[1]!r}; tolerance {TRAIN_TOL}", flush=True)

    pipe = pipeline()
    kernels = zero_counts()
    losses, times = [], []
    for _ in range(sizes["steps"]):
        t1 = time.perf_counter()
        lm, opt, metrics = step(lm, opt, pipe.next())
        losses.append(float(metrics["loss"]))  # waits for the step
        times.append(time.perf_counter() - t1)
    counts = registry.dispatch_counts()
    launches = {name: k.launches for name, k in kernels.items()}
    paths = path_launches(kernels)
    n = per_fwd * sizes["steps"]
    be = "cuda" if on_card else "cpu"
    if counts != {("nm_matmul", "nm_spmm", be): n}:
        fail(f"{what}: dispatches {counts}, expected {n} nm_spmm on {be} "
             f"({per_fwd} a forward) and nothing else")
    if on_card and launches != {**{k: 0 for k in launches}, "nm_spmm": n}:
        fail(f"{what}: launches {launches}, expected {n} nm_spmm")
    check_paths(what, paths, "sparse", on_card)
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        fail(f"{what}: a loss is not finite: {losses}")
    head, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not tail < head:
        fail(f"{what}: the loss did not fall: first 5 mean {head}, last 5 "
             f"mean {tail}")
    ms = statistics.median(times[1:]) * 1e3
    MEASURED[what] = dict(step_ms=ms)
    print(f"{what}: {sizes['steps']} steps, losses {losses[0]:.4f} ... "
          f"{losses[-1]:.4f} (first 5 mean {head:.4f}, last 5 mean "
          f"{tail:.4f}); {launches['nm_spmm']} nm_spmm launches ({per_fwd} a "
          f"forward), dispatches {counts}; {ms:.1f} ms a step (median of "
          f"steps 2-{sizes['steps']}, first {times[0] * 1e3:.1f}), "
          f"{rows / ms * 1e3:.0f} tokens/s", flush=True)
    split = step_split(lm, opt, pipe.next(), tcfg)
    line = ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if on_card else "not measured (CPU)")
    print(f"{what} split: {line} (total {sum(split.values()):.2f} ms); peak "
          f"memory {peak}", flush=True)
    return launches["nm_spmm"]


def resilient_phase(dev, tmp: Path, *, sizes=RESILIENT) -> None:
    """Reduced yi-9b (f32 weights, bf16 compute, kernels on) trained
    through ``run_resilient`` with a checkpoint every
    ``sizes["ckpt_every"]`` steps, once uninterrupted and once with a
    failure injected at each step of ``sizes["failures"]``: the same
    number of steps run, and the final loss, every parameter and both
    AdamW moments bitwise equal to the uninterrupted run's: a restart
    restores the state and the data cursor exactly, and on one card the
    steps are deterministic (the embedding's backward sums a row's
    gradients in a fixed order). A resume that dropped the moments, or
    replayed, skipped or restored a stale step, fails."""
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.fault_tolerance import (
        SimulatedFailure,
        run_resilient,
    )
    from repro_torch.training.train_loop import TrainConfig

    steps = sizes["steps"]
    tcfg = TrainConfig(opt=AdamWConfig(lr=sizes["lr"], warmup_steps=2,
                                       total_steps=steps), remat="none")

    def init_state():
        _, lm, opt, _ = build_trainer("yi-9b", full=False, device=dev,
                                      tcfg=tcfg)
        return {"params": lm, "opt": opt}

    step = build_trainer("yi-9b", full=False, device=dev, tcfg=tcfg)[3]

    def train_step(state, batch):
        lm, opt, metrics = step(state["params"], state["opt"], batch)
        return {"params": lm, "opt": opt}, metrics

    def run(name, failures):
        left = set(failures)

        def hook(s):
            if s in left:
                left.discard(s)
                raise SimulatedFailure(f"lost at step {s}")

        pipe = DataPipeline(PipelineConfig(vocab_size=512, seq_len=16,
                                           global_batch=4))
        return run_resilient(
            train_step=train_step, init_state=init_state, pipeline=pipe,
            ckpt=Checkpointer(str(tmp / name)), total_steps=steps,
            ckpt_every=sizes["ckpt_every"], failure_hook=hook)

    ref = run("resilient_ref", ())
    res = run("resilient_flaky", sizes["failures"])
    if res["restarts"] != len(sizes["failures"]) or res["steps_run"] != steps:
        fail(f"resilient: {res['restarts']} restarts, {res['steps_run']} "
             "steps")
    a, b = float(ref["metrics"]["loss"]), float(res["metrics"]["loss"])
    sa, sb = ref["final_state"], res["final_state"]
    pairs = [(f"param {n}", p.detach(), q.detach()) for (n, p), (_, q) in
             zip(sa["params"].named_parameters(),
                 sb["params"].named_parameters())]
    pairs += [(f"{part} {n}", t, sb["opt"][part][n])
              for part in ("m", "v") for n, t in sa["opt"][part].items()]
    pairs.append(("step", sa["opt"]["step"], sb["opt"]["step"]))
    differ = [what for what, p, q in pairs if not torch.equal(p, q)]
    diff = max(float((p.float() - q.float()).abs().max())
               for _, p, q in pairs)
    if a != b or differ:
        fail(f"resilient: final loss {b!r} vs {a!r} uninterrupted; "
             f"{len(differ)} of {len(pairs)} tensors differ (e.g. "
             f"{differ[:3]}), at most {diff!r} apart")
    print(f"resilient: {steps} steps, {res['restarts']} injected failures, "
          f"checkpoint every {sizes['ckpt_every']}: final loss {b!r}, "
          f"bitwise equal to the uninterrupted run, as are all {len(pairs)} "
          f"parameters, moments and the step", flush=True)


def tuned_model(dev, *, full=True, layers=TUNED["layers"]):
    """The bf16 yi-9b (full width, ``layers`` deep) of the autotune, obs
    and fp8 phases."""
    from repro_torch.launch.serve import build_model

    t0 = time.perf_counter()
    cfg, lm = build_model("yi-9b", full=full, layers=layers, kernels=True,
                          dtype=torch.bfloat16, seed=0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"tuned model: {cfg.name} d_model={cfg.d_model} layers="
          f"{cfg.n_layers} bf16, made in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return lm


def autotune_phase(dev, lm, tmp: Path, *, shapes=SHAPES,
                   attn=TUNED_ATTN) -> None:
    """Sweep the yi-9b projections (prefill M = 512, decode M = 4; bf16
    and int8 values, bf16 x) and the local-mask bs_attention case into a
    cache file of its own; each winner's output held to the rule's (the
    sweep raises otherwise); then a graphed serve with
    ``autotune_blocks=True`` that reads the file: no sweep, no reference
    dispatch, records carrying the tuned blocks, and one prefill step's
    logits within TOL of a rule-plan engine's."""
    import numpy as np

    from repro_torch.core.sparsity import NMConfig
    from repro_torch.kernels import autotune, registry
    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
    from repro_torch.launch.serve import serve
    from repro_torch.serving.engine import make_serve_steps

    on_card = dev.type == "cuda"
    cfg = NMConfig(2, 4)
    tuned_file = tmp / "autotune.json"
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tuned_file)
    autotune.clear_memory_cache()
    tuned = {}
    print("autotune family  vals  proj           M  candidates  rule "
          "(ms)  ->  tuned (ms)  bound_ms (by)", flush=True)
    for dtype in (torch.bfloat16, torch.int8):
        for proj, (k, n) in shapes.items():
            for m, fam in ((PREFILL_M, "prefill"), (DECODE_M, "decode")):
                t0 = time.perf_counter()
                sw = autotune.sweep(m, n, k, cfg, dtype, family=fam,
                                    x_dtype=torch.bfloat16, device=dev)
                if sw is None:  # the CPU: nothing to time
                    continue
                autotune.store(sw)
                tuned[(fam, dtype, k, n)] = sw.best
                kept = torch.ones(k // 2, n, dtype=dtype, device=dev)
                bms, by = bound_ms(m, k, n, torch.bfloat16, kept,
                                   scales=dtype == torch.int8)
                dt = "int8" if dtype == torch.int8 else "bf16"
                print(f"autotune {fam:7s} {dt:5s} {proj:11s} {m:4d}  "
                      f"{len(sw.times):10d}  {sw.rule} ({sw.rule_ms:.5f})  "
                      f"->  {sw.best} ({sw.best_ms:.5f})  {bms:.5f} ({by}); "
                      f"every candidate bit-equal to the rule's on the "
                      f"lattice; swept in {time.perf_counter() - t0:.2f}s",
                      flush=True)
    spec = MaskSpec(**attn["spec"])
    sa = autotune.sweep_attn(attn["s"], attn["s"], attn["dk"], spec,
                             torch.bfloat16, heads=attn["heads"],
                             batch=attn["batch"], device=dev)
    if sa is not None:
        autotune.store(sa)
        print(f"autotune bs_attn {spec.tag} bf16 B {attn['batch']} Sq = Skv "
              f"= {attn['s']} heads {attn['heads']} dk {attn['dk']}: "
              f"{len(sa.times)} tiles {sorted(sa.times)}; rule {sa.rule} "
              f"({sa.rule_ms:.5f} ms) -> tuned {sa.best} ({sa.best_ms:.5f} "
              f"ms); every tile within {autotune.ATTN_TOL[torch.bfloat16]} "
              f"of the rule tile's output", flush=True)
    if on_card and len(tuned) != 4 * len(shapes):
        fail(f"autotune: {len(tuned)} sweeps stored")
    before = tuned_file.read_text() if tuned_file.exists() else ""
    kw = dict(slots=SERVE["slots"], prefill_len=SERVE["prefill_len"],
              max_seq=SERVE["prefill_len"] + SERVE["max_new"])
    registry.clear_history()
    eng, done, dt = serve(lm, requests=SERVE["requests"],
                          max_new=SERVE["max_new"], autotune_blocks=True,
                          **kw)
    after = tuned_file.read_text() if tuned_file.exists() else ""
    counts = registry.dispatch_counts()
    ref = {k: v for k, v in counts.items() if "reference" in k[1]}
    if ref or after != before or len(done) != SERVE["requests"]:
        fail(f"autotune serve: reference dispatches {ref}, cache file "
             f"changed {after != before}, {len(done)} requests finished")
    check_graphs("autotune serve", eng, on_card)
    wrong, checked = [], 0
    for rec in registry.dispatch_history():
        if rec.op.startswith("nm_matmul"):
            fam = "decode" if "decode" in rec.op else "prefill"
            dtype = torch.int8 if rec.op.endswith("_q") else torch.bfloat16
            want = tuned.get((fam, dtype, rec.shape[1], rec.shape[2]))
            checked += want is not None
            if want is not None and tuple(rec.block) != tuple(want):
                wrong.append((rec.op, rec.shape, rec.block, want))
    if on_card and not checked:
        fail("autotune serve: no dispatch record of a tuned shape")
    if wrong:
        fail(f"autotune serve: records name other blocks than the tuned "
             f"ones: {wrong[:4]}")
    print(f"autotune serve (autotune_blocks=True, the tuned file): "
          f"{serve_line(eng.throughput_stats(), dt)}; cache file unchanged "
          f"(no sweep), reference dispatches 0, the {checked} dispatch "
          f"records of tuned shapes name the tuned blocks", flush=True)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, lm.cfg.vocab_size,
                          (SERVE["slots"], SERVE["prefill_len"]))
    mask = np.ones(SERVE["slots"], bool)

    def prefill_logits():
        step, _ = make_serve_steps(lm)
        caches = lm.init_cache(SERVE["slots"], kw["max_seq"])
        with torch.inference_mode():
            step(caches, tokens=tokens.astype(np.int32), mask=mask)
            return step(caches, tokens=tokens.astype(np.int32),
                        mask=mask).clone()  # a replay (graphed on the card)

    got = prefill_logits()
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp / "rules.json")
    want = prefill_logits()
    tol = TOL[torch.bfloat16]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"autotune: a prefill step's logits with the tuned blocks are "
             f"{err} from the rule's beyond {tol}")
    print(f"autotune: prefill step logits {tuple(got.shape)}, tuned against "
          f"the rule's launches: max|diff| = {err:.3e} (tolerance {tol}, "
          f"the kernel phase's)", flush=True)


def obs_phase(dev, lm, tmp: Path, *, sizes=PAGED_SERVE) -> None:
    """A graphed, paged serve with observability on against the same
    serve with it off: equal streams, one graph a step kind, a trace and
    metrics that ``repro_torch.obs.check`` passes for all five
    subsystems, ``kernel_dispatch_total`` equal to what ran; ITL p50 of
    both."""
    import repro_torch.obs as obs
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import serve

    on_card = dev.type == "cuda"
    kw = dict(slots=sizes["slots"], prefill_len=sizes["prefill_len"],
              max_seq=sizes["prefill_len"] + sizes["max_new"],
              prefill_chunk=sizes["prefill_chunk"],
              shared_prefix=sizes["shared_prefix"],
              requests=sizes["requests"], max_new=sizes["max_new"],
              paged=True, page_size=sizes["page_size"],
              pool_pages=sizes["pool_pages"])
    obs.reset_for_tests()
    obs.disable()
    off, off_done, off_dt = serve(lm, **kw)
    bundle = obs.enable(obs.Obs.create())
    try:
        kernels = zero_counts()
        eng, done, dt = serve(lm, **kw)
        counts, _ = ran(eng, kernels, registry.dispatch_counts())
    finally:
        obs.disable()
    if streams(done) != streams(off_done):
        fail("obs: greedy streams with obs on differ from obs off")
    check_graphs("obs serve", eng, on_card)
    trace, prom = tmp / "trace.json", tmp / "metrics.prom"
    events = bundle.tracer.export_chrome(str(trace))
    prom.write_text(bundle.metrics.to_prometheus())
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.check", str(trace),
         str(prom), "--require-subsystems",
         "engine,scheduler,paging,dispatch,autotune"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if out.returncode != 0:
        fail(f"obs: repro_torch.obs.check: {out.stdout} {out.stderr}")
    metric = {k: bundle.metrics.counter_value(
        "kernel_dispatch_total", op=k[0], impl=k[1], backend=k[2])
        for k in counts}
    total = sum(v for key, v in bundle.metrics.snapshot()["counters"].items()
                if key.startswith("kernel_dispatch_total"))
    if metric != {k: float(v) for k, v in counts.items()} or total != sum(
            counts.values()):
        fail(f"obs: kernel_dispatch_total {metric} (total {total}) differs "
             f"from what ran {counts}")
    on_s, off_s = eng.throughput_stats(), off.throughput_stats()
    print(f"obs: {out.stdout.strip()}; {events} events", flush=True)
    print(f"obs serve: streams equal with obs on and off; "
          f"kernel_dispatch_total equal to ran_counts "
          f"({int(total)} dispatches); ITL p50 obs on "
          f"{on_s['itl_p50_s'] * 1e3:.3f} ms, off "
          f"{off_s['itl_p50_s'] * 1e3:.3f} ms (p99 "
          f"{on_s['itl_p99_s'] * 1e3:.3f} / {off_s['itl_p99_s'] * 1e3:.3f}); "
          f"on: {serve_line(on_s, dt)}; off: {serve_line(off_s, off_dt)}",
          flush=True)


def fp8_phase(dev, lm, *, sizes=FP8, label="fp8") -> None:
    """One prefill and one decode with an fp8 (e4m3) KV cache against a
    bf16 one, on the slot path and the paged path, eagerly and through
    captured graphs (replayed): top-1 equal, relative logit error below
    0.15 (the JAX package's bound), cache bytes halved."""
    import numpy as np

    from repro_torch.serving.engine import make_serve_steps

    b, p, ps = sizes["slots"], sizes["prefill_len"], sizes["page_size"]
    pps = (p + ps) // ps  # pages a slot: the prompt and the decode token
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, lm.cfg.vocab_size, (b, p)).astype(np.int32)
    mask = np.ones(b, bool)
    table = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)

    def run(dtype, paged, graphs, nxt=None):
        """(prefill logits, decode logits, the decoded tokens), cache
        bytes; the decode takes ``nxt``, else the prefill's top-1."""
        prefill, decode = make_serve_steps(lm, graphs=graphs)
        caches = (lm.init_cache(1 + b * pps, ps, dtype=dtype) if paged
                  else lm.init_cache(b, p + ps, dtype=dtype))
        extra = (dict(cache_len=np.zeros(b, np.int32), table=table)
                 if paged else {})
        dec_extra = dict(table=table) if paged else {}
        out = None
        with torch.inference_mode():
            for _ in range(2 if graphs else 1):  # graphs: capture, replay
                for c in caches:
                    for t in c.values():
                        t.view(torch.uint8).zero_()
                lp = prefill(caches, tokens=tokens, mask=mask,
                             **extra).clone()
                tok = nxt if nxt is not None else (
                    lp.argmax(-1).cpu().numpy().astype(np.int32)[:, None])
                ld = decode(caches, tokens=tok, mask=mask,
                            cache_len=np.full(b, p, np.int32),
                            **dec_extra).clone()
                out = (lp, ld, tok)
        nbytes = sum(t.numel() * t.element_size() for c in caches
                     for t in c.values())
        if graphs and dev.type == "cuda":
            if [len(s.built) for s in (prefill, decode)] != [1, 1] or any(
                    r.replays != 1 for s in (prefill, decode)
                    for r in s.captured):
                fail(f"{label}: {dtype} paged={paged}: graphs "
                     f"{[s.captured for s in (prefill, decode)]}")
        return out, nbytes

    for paged in (False, True):
        for graphs in (False, True):
            # both decodes take bf16's next tokens: the decode compares
            # the caches, not a prefill top-1 that fp8 noise moved
            (b16p, b16d, nxt), n16 = run(torch.bfloat16, paged, graphs)
            (f8p, f8d, _), n8 = run(torch.float8_e4m3fn, paged, graphs, nxt)
            what = (f"{'paged' if paged else 'slot'} "
                    f"{'graphed' if graphs else 'eager'}")
            for step, a, f in (("prefill", b16p, f8p), ("decode", b16d, f8d)):
                rel = float((a - f).abs().max() / (a.abs().max() + 1e-9))
                # a row's top-1 may change only where the fp8 error can
                # reorder bf16's top two: their margin within twice the
                # row's largest logit change
                top2 = a.topk(2, dim=-1).values
                margin = top2[:, 0] - top2[:, 1]
                near = margin <= 2 * (a - f).abs().amax(-1)
                flip = a.argmax(-1) != f.argmax(-1)
                if (rel >= 0.15 or bool((flip & ~near).any())
                        or not torch.isfinite(f).all()):
                    fail(f"{label} {what} {step}: relative logit error {rel}, "
                         f"top-1 changed in rows {flip.nonzero().tolist()} "
                         f"(bf16 top-2 margins {margin.tolist()}, rows "
                         f"where fp8 can reorder them {near.tolist()})")
                print(f"{label} {what} {step}: logits {tuple(f.shape)}, "
                      f"relative error against the bf16 cache {rel:.4f} "
                      f"(bound 0.15); top-1 equal in "
                      f"{int((~flip).sum())} of {len(flip)} rows, changed "
                      f"only where the bf16 top-2 margin is within twice "
                      f"the row's fp8 change ({int(flip.sum())} changed, "
                      f"{int(near.sum())} such rows; margins "
                      f"{[round(float(v), 4) for v in margin]})", flush=True)
            if n8 * 2 != n16:
                fail(f"{label} {what}: cache bytes {n8} vs bf16 {n16}")
            print(f"{label} {what}: cache {n8} bytes, bf16 {n16} (halved)",
                  flush=True)


NM_KERNELS = KERNELS[:4]  # nm_spmm, nm_spmm_decode and their int8 twins


def shard_shapes_phase(dev, shapes=(YI_SHARD_SHAPES, DS236_SHAPES),
                       ms=(YI_SHARD_M, DS236_M)) -> dict:
    """Phase 31: rows 1-4 against their plain versions at the shapes a
    rank of the sharded serves runs (yi-9b's projections at tp 2 and 4)
    and at full-width deepseek-v2-236b's, at the M their paths give
    (``shape_kernel_phase``: within TOL, lattice bit-exact), then timed
    beside ``torch.matmul`` and the bound (``shape_timing_phase``).
    Returns the worst |err| per kernel."""
    worst = dict.fromkeys(NM_KERNELS, 0.0)
    for (group, (pre, dec)), (what, seed) in zip(
            zip(shapes, ms), (("shard kernels", 14), ("236b kernels", 15))):
        for name, err in shape_kernel_phase(dev, group, pre, dec, what=what,
                                            seed=seed).items():
            worst[name] = max(worst[name], err)
    shape_timing_phase(dev, {k: v for g in shapes for k, v in g.items()},
                       what="shard and 236b")
    return worst


def rank_counts(what, res, calls, linears, on_card=True) -> dict:
    """One rank's counts of a run: no reference dispatch, and its N:M
    launches one a compressed Linear a call (``calls`` step calls or
    forwards of a model holding ``linears``, at the shard's shapes; on
    the CPU, where no kernel launches, its N:M dispatches). Returns its
    launches."""
    counts = res["dispatches"]
    ref = {k: v for k, v in counts.items() if "reference" in k[1]}
    launched = (sum(res["launches"][k] for k in NM_KERNELS) if on_card
                else sum(v for k, v in counts.items()
                         if k[0].startswith("nm_matmul")))
    if ref or launched != linears * calls:
        fail(f"{what}: reference dispatches {ref}; {launched} N:M launches "
             f"for {calls} calls of {linears} compressed Linears")
    return res["launches"]


def _ranks_line(what, per_rank) -> None:
    print(f"{what}: " + "; ".join(per_rank), flush=True)


def sharded_f32_phase(dev, *, full=True, sizes=SHARDED_F32,
                      masked_sizes=SHARDED_MASKED, meshes=MESHES) -> dict:
    """Phase 32: ``ShardedServeEngine`` on gloo ranks sharing the card,
    at each mesh of ``meshes``, against the single-card ``ServeEngine``
    on the same weights: full-width yi-9b cut to ``sizes["layers"]``, f32
    weights and activations, the JAX package's sharded matrix (5 prompts
    of 8 tokens, 2 slots, max_new 4 + i). Variants: float 2:4, chunked
    (4), int8, the local mask (``bs_attention`` at the rank's heads, on
    2 x 1024-token prompts), sampled at temperature 0.8 from a fixed
    seed, and paged at 2x2 (chunks and pages of 4, prompts sharing their
    first page; against the slot engine). Every rank builds its shard a
    layer at a time (``init_sharded``). Gates on every rank: the streams
    equal the single card's; the last-position logits of a prefill of
    the first 2 prompts within 1e-4 * max|logits|; no reference
    dispatch, one N:M launch a compressed Linear a step call (the
    shard's), int8 only on the int8 kernels, the masked variant through
    bs_attention; paged: one page sub-pool a data shard, prefix hits.
    Returns the ranks' launches by kernel."""
    import collections
    import dataclasses

    import numpy as np

    from repro_torch.kernels.blocksparse_attn.mask import MaskSpec
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import build_model
    from repro_torch.launch.sharded import prefill_logits, serve_rank
    from repro_torch.serving.engine import Request, ServeEngine

    total = collections.Counter()
    rng = np.random.default_rng(5)
    n, plen = sizes["requests"], sizes["prefill_len"]
    kw = dict(slots=sizes["slots"], prefill_len=plen,
              max_seq=sizes["max_seq"])
    from repro_torch.configs import get_config, get_reduced

    vocab = (get_config if full else get_reduced)("yi-9b").vocab_size

    def prompts(count, length, shared=0):
        ps = [rng.integers(0, vocab, length).astype(np.int32)
              for _ in range(count)]
        for p in ps[1:]:
            p[:shared] = ps[0][:shared]
        return ps

    mkw = dict(slots=masked_sizes["slots"],
               prefill_len=masked_sizes["prefill_len"],
               max_seq=masked_sizes["max_seq"])
    variants = [  # name, build kw, engine kw (single, sharded), prompts
        ("float", {}, kw, kw, prompts(n, plen)),
        ("chunked", {}, dict(kw, prefill_chunk=4),
         dict(kw, prefill_chunk=4), prompts(n, plen)),
        ("int8", dict(quantize="int8"), kw, kw, prompts(n, plen)),
        ("masked", dict(mask=MaskSpec("local", block=64, window=192)), mkw,
         mkw, prompts(masked_sizes["requests"], masked_sizes["prefill_len"])),
        ("sampled", {}, dict(kw, temperature=SAMPLED_T, seed=7),
         dict(kw, temperature=SAMPLED_T, seed=7), prompts(n, plen)),
        ("paged", {}, dict(kw, prefill_chunk=4),
         dict(kw, prefill_chunk=4, paged=True, page_size=4),
         prompts(n, plen, shared=4)),
    ]
    refs, cases = {}, {}
    for name, bkw, single_kw, rank_kw, ps in variants:
        cfg, lm = build_model("yi-9b", full=full, layers=sizes["layers"],
                              kernels=True, dtype=torch.float32, seed=0,
                              device=dev, **bkw)
        max_new = [4 + i for i in range(len(ps))]
        eng = ServeEngine(lm, **single_kw)
        for i, (p, m) in enumerate(zip(ps, max_new)):
            eng.submit(Request(rid=i, prompt=p, max_new=m))
        done = eng.run()
        first = np.stack(ps[:2])
        refs[name] = (streams(done), prefill_logits(
            lm, mesh_mod.make_serve_mesh(backend="gloo", device=dev.type),
            first))
        cases[name] = dict(cfg=cfg, seed=0, dtype=torch.float32,
                           shard_init=True, quantize=bkw.get("quantize"),
                           engine=rank_kw, prompts=ps, max_new=max_new,
                           logits_prompts=first)
        del eng, lm
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for mesh in meshes:
        names = [v[0] for v in variants if v[0] != "paged" or mesh[0] > 1]
        t0 = time.perf_counter()
        res = mesh_mod.spawn(serve_rank, *mesh, backend="gloo",
                             device=dev.type, timeout_s=RANK_TIMEOUT_S,
                             args=([cases[v] for v in names],))
        label = f"sharded f32 {mesh[0]}x{mesh[1]}"
        print(f"{label}: {len(res)} ranks, {len(names)} variants in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        for i, name in enumerate(names):
            want, ref = refs[name]
            tol = 1e-4 * float(np.abs(ref).max())
            lines = []
            for rank, rr in enumerate(res):
                got = rr[i]
                what = f"{label} {name} rank {rank}"
                if got["streams"] != want:
                    fail(f"{what}: streams {got['streams']} differ from the "
                         f"single card's {want}")
                err = float(np.abs(got["logits"] - ref).max())
                if err > tol:
                    fail(f"{what}: max|logits - single card| {err} beyond "
                         f"1e-4 * max|logits| = {tol}")
                calls = sum(got["step_calls"].values())
                launches = rank_counts(what, got["counts"], calls,
                                       got["linears"], dev.type == "cuda")
                fams = {k for k in NM_KERNELS if launches[k]}
                if fams and (name == "int8") != all(k.endswith("_q")
                                                    for k in fams):
                    fail(f"{what}: N:M launches {launches}")
                if name == "masked" and not launches["bs_attention"] \
                        and dev.type == "cuda":
                    fail(f"{what}: no bs_attention launch")
                if name == "paged" and (
                        got["groups"] != mesh[0]
                        or got["stats"]["prefix_hit_pages"] < 1):
                    fail(f"{what}: page groups {got['groups']}, prefix hit "
                         f"pages {got['stats']['prefix_hit_pages']}")
                total.update(launches)
                peak = (f"{got['peak'] / 2**30:.3f} GiB" if got["peak"]
                        else "not measured")
                lines.append(
                    f"rank {rank} {got['plan']} logits err {err:.3e}, "
                    f"{calls} step calls x {got['linears']} Linears = "
                    f"{sum(launches[k] for k in NM_KERNELS)} N:M launches, "
                    f"bs_attention {launches['bs_attention']}, serve "
                    f"{got['serve_s']:.2f}s, peak {peak}")
            _ranks_line(f"{label} {name}: streams equal to the single "
                        f"card's ({len(want)} requests), plan (attn, kv, "
                        f"ffn)", lines)
    return dict(total)


def sharded_bf16_phase(dev, *, full=True, sizes=SERVE,
                       meshes=MESHES) -> dict:
    """Phase 33: full-width yi-9b at ``sizes["layers"]`` (48), bf16,
    SERVE's requests through ``ShardedServeEngine`` at each mesh (eager
    steps), beside the single-card engine served eagerly. Gates: every
    request finishes with tokens in the vocabulary; on every rank no
    reference dispatch and one N:M launch a compressed Linear a step;
    the f32 witness: the sharded logits of a prefill of SERVE's shape
    and REF_DECODE_STEPS decode steps at most WITNESS_C times as far
    (root mean square) from the same weights computed in f32 on the
    single card as the single card's plain bf16 path. Greedy streams
    are not gated (the sums over ranks change the order of bf16 sums).
    Prints ITL p50, tok/s and peak memory of each rank and of the single
    card. Returns the ranks' launches by kernel."""
    import collections

    import numpy as np

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import build_model, serve
    from repro_torch.launch.sharded import serve_rank
    from repro_torch.launch.witness import (
        _rms,
        ratio,
        witness_calls,
        witness_inputs,
    )

    on_card = dev.type == "cuda"
    total = collections.Counter()
    t0 = time.perf_counter()
    cfg, lm = build_model("yi-9b", full=full, layers=sizes["layers"],
                          kernels=True, dtype=torch.bfloat16, seed=0,
                          device=dev)
    print(f"sharded bf16: {cfg.name} {cfg.n_layers} layers bf16, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    kw = dict(slots=sizes["slots"], prefill_len=sizes["prefill_len"],
              max_seq=sizes["prefill_len"] + sizes["max_new"])
    serve(lm, requests=1, max_new=2, graphs=False, **kw)  # warm-up
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    eng, done, dt = serve(lm, requests=sizes["requests"],
                          max_new=sizes["max_new"], graphs=False, **kw)
    st = eng.throughput_stats()
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on_card
            else float("nan"))
    print(f"sharded bf16: single card eager: {serve_line(st, dt)}; peak "
          f"{peak:.3f} GiB", flush=True)
    toks, feed, _ = witness_inputs(lm, slots=sizes["slots"],
                                   prefill_len=sizes["prefill_len"],
                                   steps=REF_DECODE_STEPS)
    with torch.inference_mode():
        set_policy(lm, "off")
        plain = [c[:, -1].float() for c in witness_calls(lm, toks, feed)]
        lm.set_compute_dtype(torch.float32)
        ref = [c[:, -1].float() for c in witness_calls(lm, toks, feed)]
        lm.set_compute_dtype(None)
        set_policy(lm, "auto")
    base = [_rms(p - r) for p, r in zip(plain, ref)]
    ref = [r.cpu().numpy() for r in ref]
    toks, feed = toks.cpu().numpy(), feed.cpu().numpy()
    del eng, lm, plain
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(0)  # launch.serve.serve's prompts
    prompts = list(rng.integers(0, cfg.vocab_size, size=(
        sizes["requests"], sizes["prefill_len"])).astype(np.int32))
    case = dict(cfg=cfg, seed=0, dtype=torch.bfloat16, shard_init=True,
                engine=kw, prompts=prompts,
                max_new=[sizes["max_new"]] * sizes["requests"],
                witness=(toks, feed))
    for mesh in meshes:
        label = f"sharded bf16 {mesh[0]}x{mesh[1]}"
        t0 = time.perf_counter()
        res = mesh_mod.spawn(serve_rank, *mesh, backend="gloo",
                             device=dev.type, timeout_s=RANK_TIMEOUT_S,
                             args=([case],))
        lines = []
        for rank, rr in enumerate(res):
            got = rr[0]
            what = f"{label} rank {rank}"
            outs = got["streams"]
            if len(outs) != sizes["requests"] or any(
                    len(o) != sizes["max_new"] for o in outs.values()):
                fail(f"{what}: {len(outs)} of {sizes['requests']} requests "
                     "finished")
            if not all(0 <= t < cfg.vocab_size for o in outs.values()
                       for t in o):
                fail(f"{what}: a token outside the vocabulary")
            calls = sum(got["step_calls"].values())
            total.update(rank_counts(what, got["counts"], calls,
                                     got["linears"], on_card))
            ratios = [ratio(_rms(torch.from_numpy(g - r)), b)
                      for g, r, b in zip(got["witness"], ref, base)]
            if max(ratios) > WITNESS_C:
                fail(f"{what}: rms(sharded - f32) / rms(plain bf16 - f32) "
                     f"{[round(x, 3) for x in ratios]} beyond {WITNESS_C}")
            s = got["stats"]
            peak_r = (f"{got['peak'] / 2**30:.3f} GiB" if got["peak"]
                      else "not measured")
            lines.append(
                f"rank {rank}: ITL p50 {s['itl_p50_s'] * 1e3:.3f} ms, "
                f"{s['tokens'] / got['serve_s']:.3f} tok/s, peak {peak_r}, "
                f"made in {got['built_s']:.1f}s, witness ratios "
                f"{[round(x, 3) for x in ratios]}")
        _ranks_line(f"{label} ({time.perf_counter() - t0:.1f}s; single "
                    f"card eager ITL p50 {st['itl_p50_s'] * 1e3:.3f} ms, "
                    f"{st['tokens'] / dt:.3f} tok/s, peak {peak:.3f} GiB)",
                    lines)
    return dict(total)


def ds236_phase(dev, *, full=True, layers=DS236_LAYERS, sizes=SERVE,
                meshes=MESHES) -> dict:
    """Phase 34: deepseek-v2-236b at full width cut to ``layers`` (1
    dense + 3 MoE), bf16. One process serves it through ``ServeEngine``
    with graphs, every MoE layer dropless (serve_phase's gates: N:M
    launches a graph = its compressed Linears). Then ``LM.forward`` under
    expert parallelism on gloo ranks sharing the card, at each mesh: a
    prefill of SERVE's shape and REF_DECODE_STEPS decode steps, each rank
    making only its E / model experts (``init_expert_parallel``). Gates,
    dropless: each rank holds and launches only its own experts' GEMMs
    (its N:M launches a call = its compressed Linears); no reference
    dispatch; the logits pass the f32 witness against the single
    process's plain bf16 and f32 paths on the same weights (at full
    depth of the cut: the f32 path casts each weight for its product, no
    f32 copy is held); the prefill's aux within 1e-3 of the single
    process's over as many data shards (the mean of each shard's rows'
    aux, as the JAX package's GShard groups compute it). Then the same
    calls at the config's capacity factor 1.25,
    whose dropped assignments are printed. Returns the launches by
    kernel."""
    import collections

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import build_model
    from repro_torch.launch.sharded import ep_rank
    from repro_torch.launch.witness import (
        _rms,
        ratio,
        witness_calls,
        witness_inputs,
    )
    from repro_torch.models.cache import CacheView

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    cfg, lm = build_model(DS236, full=full, layers=layers, kernels=True,
                          dtype=torch.bfloat16, seed=0, device=dev)
    if on_card:
        torch.cuda.synchronize()
    moe = cfg.plan[-1][0].mlp
    dropless = moe.n_experts / moe.top_k
    nbytes = sum(t.numel() * t.element_size() for t in
                 list(lm.parameters()) + list(lm.buffers()))
    print(f"{DS236} {layers}L: {cfg.name} d_model={cfg.d_model} "
          f"{moe.n_experts} experts top-{moe.top_k}, made in "
          f"{time.perf_counter() - t0:.1f}s, {nbytes / 1e9:.3f} GB",
          flush=True)
    moe_capacity(lm, dropless)
    total = collections.Counter()
    launches, _, _ = serve_phase(dev, model=(cfg, lm), eager=False,
                                 sizes=dict(sizes, layers=layers),
                                 what=f"{DS236} {layers}L serve, dropless")
    total.update(launches)
    toks, feed, _ = witness_inputs(lm, slots=sizes["slots"],
                                   prefill_len=sizes["prefill_len"],
                                   steps=REF_DECODE_STEPS)
    b, s = toks.shape

    def prefill_aux(rows):
        return float(lm(toks[rows], view=CacheView.prefill(),
                        caches=lm.init_cache(rows.stop - rows.start, s),
                        last_only=True, with_aux=True)[2])

    with torch.inference_mode():
        kern = [c[:, -1].float() for c in witness_calls(lm, toks, feed)]
        # the aux loss is per data shard (GShard groups): averaged over
        # the shards, each a prefill of its rows alone (dropless, a
        # token's routing does not depend on the others')
        aux = {d: sum(prefill_aux(slice(i * b // d, (i + 1) * b // d))
                      for i in range(d)) / d
               for d in sorted({m[0] for m in meshes})}
        set_policy(lm, "off")
        plain = [c[:, -1].float() for c in witness_calls(lm, toks, feed)]
        lm.set_compute_dtype(torch.float32)
        ref = [c[:, -1].float() for c in witness_calls(lm, toks, feed)]
        lm.set_compute_dtype(None)
        set_policy(lm, "auto")
    base = [_rms(p - r) for p, r in zip(plain, ref)]
    single = [ratio(_rms(k - r), bb) for k, r, bb in zip(kern, ref, base)]
    print(f"{DS236} {layers}L single process: rms(kernels - f32) / "
          f"rms(plain bf16 - f32) of the logits "
          f"{[round(x, 3) for x in single]}, prefill aux by data shards "
          f"{aux}", flush=True)
    ref = [r.cpu().numpy() for r in ref]
    case = dict(cfg=cfg, seed=0, dtype=torch.bfloat16,
                toks=toks.cpu().numpy(), feed=feed.cpu().numpy(),
                capacity_factors=[dropless, None], drops=True)
    del lm, kern, plain
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    n_moe = sum(1 for blk in cfg.blocks() if blk.mlp == moe)
    for mesh in meshes:
        label = f"{DS236} {layers}L EP {mesh[0]}x{mesh[1]}"
        t0 = time.perf_counter()
        res = mesh_mod.spawn(ep_rank, *mesh, backend="gloo",
                             device=dev.type, timeout_s=RANK_TIMEOUT_S,
                             args=(case,))
        per = moe.n_experts // mesh[1]
        lines, drops = [], collections.Counter()
        for rank, got in enumerate(res):
            what = f"{label} rank {rank}"
            own = [((rank % mesh[1]) * per, per)] * n_moe
            if got["experts"] != own:
                fail(f"{what}: holds experts {got['experts']}, not {own}")
            for run in got["runs"]:
                for call in run["calls"]:
                    total.update(rank_counts(what, call, 1, got["linears"],
                                             on_card))
            run = got["runs"][0]
            if abs(run["aux"] - aux[mesh[0]]) > 1e-3:
                fail(f"{what}: aux {run['aux']} against the single "
                     f"process's {aux[mesh[0]]} over {mesh[0]} data "
                     "shards, beyond 1e-3")
            if rank == 0:
                ratios = [ratio(_rms(torch.from_numpy(c["logits"] - r)), bb)
                          for c, r, bb in zip(run["calls"], ref, base)]
                if max(ratios) > WITNESS_C:
                    fail(f"{what}: rms(EP - f32) / rms(plain bf16 - f32) "
                         f"{[round(x, 3) for x in ratios]} beyond "
                         f"{WITNESS_C}")
            if rank % mesh[1] == 0:  # a data shard's tokens, counted once
                for layer, n, of in got["runs"][1]["drops"]:
                    drops[layer] += n
            peak_r = (f"{run['peak'] / 2**30:.3f} GiB" if run["peak"]
                      else "not measured")
            lines.append(
                f"rank {rank}: experts {got['experts'][0][0]}.."
                f"{got['experts'][0][0] + per - 1}, {got['linears']} "
                f"compressed Linears launched a call, made in "
                f"{got['built_s']:.1f}s, call seconds "
                f"{[round(x, 4) for x in run['seconds']]}, peak {peak_r}, "
                f"aux {run['aux']:.6f}")
        _ranks_line(f"{label} ({time.perf_counter() - t0:.1f}s), dropless: "
                    f"logits witness ratios {[round(x, 3) for x in ratios]}",
                    lines)
        print(f"{label}: at capacity factor {moe.capacity_factor} the "
              f"prefill and decode calls dropped, by MoE layer, "
              f"{dict(sorted(drops.items()))} of {toks.numel() * moe.top_k}"
              f" prefill assignments (and 4 x {b * moe.top_k} decode)",
              flush=True)
    return dict(total)


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def f32_train_gates(what, r, ref, first, steps, bad,
                    keys=("loss", "nll", "lr", "grad_norm"),
                    tol=SHARDED_TRAIN_TOL) -> str:
    """Phases 35-36's f32 gates of one rank: its metrics (``keys``)
    within ``tol`` of the reference's steps from ``first`` (a key of
    ``tol["later"]`` after the first step within that), its state's
    distance from the reference's after ``steps`` (``r["diff"]``,
    ``launch.sharded._diff_to``: AdamW's eps regime at most
    ``tol["eps_entries"]`` entries beyond ``tol["state"]``, none beyond
    ``tol["eps_state"]``); every failure appended to ``bad``. Returns the
    text of its readings."""
    worst = 0.0
    for j, m in enumerate(r["metrics"]):
        for key in keys:
            d = _rel(m[key], ref[first + j][key])
            worst = max(worst, d)
            lim = (tol.get("later", {}).get(key, tol["metrics"])
                   if first + j else tol["metrics"])
            if not d <= lim:
                bad.append(f"{what}: step {first + j + 1} {key} {m[key]!r}, "
                           f"the reference {ref[first + j][key]!r}: "
                           f"{d:.2e} > {lim}")
    if "diff" not in r:
        return f", metrics worst {worst:.1e}"
    for part in ("m", "v"):
        d, leaf, over = r["diff"][part]
        if not d <= tol["state"]:
            bad.append(f"{what}: {part} {leaf} {d:.3e} from the reference's "
                       f"after step {steps} > {tol['state']} ({over} entries "
                       "beyond it)")
    n_eps, eps_max, rest, raw_n, raw_max = r["diff"]["eps"]
    if not (rest <= tol["state"] and eps_max <= tol["eps_state"]
            and n_eps <= tol["eps_entries"]):
        bad.append(f"{what}: parameters {rest:.3e} from the reference's "
                   f"after step {steps} (> {tol['state']}?); in AdamW's eps "
                   f"regime {n_eps} entries beyond {tol['state']} (> "
                   f"{tol['eps_entries']}?), at most {eps_max:.3e} (> "
                   f"{tol['eps_state']}?)")
    text = f", metrics worst {worst:.1e}, state " + ", ".join(
        f"{p} {r['diff'][p][0]:.2e} ({r['diff'][p][2]} over)"
        for p in ("params", "m", "v"))
    text += (f" (params outside AdamW's eps regime {rest:.2e}; in it "
             f"{n_eps} over, at most {eps_max:.2e} of "
             f"{tol['eps_state']:.2e}" + (
                 f", their differences {raw_n} over, at most "
                 f"{raw_max:.2e}" if steps == 1 else "") + ")")
    at_name, at, entry = r["diff"]["at"]
    return text + (f" [worst {at_name}[{at}]: " + ", ".join(
        f"{p} {a:.6e}/{b:.6e}" for p, (a, b) in entry.items())
        + " rank/reference]")


def train_rank_line(r, launches, rows, gates, bad, what) -> str:
    """One rank's line of a sharded train case: its losses, the gates'
    readings, its step-1 kernels / off gate (a failure appended to
    ``bad``), launches, ms a step by part, tokens/s, peak and seconds."""
    losses = [m["loss"] for m in r["metrics"]]
    gate = ""
    if r.get("gate"):
        kl, kn = r["metrics"][0]["loss"], r["metrics"][0]["grad_norm"]
        pl, pn = r["gate"]["off"]
        for key, a, b in (("loss", kl, pl), ("grad_norm", kn, pn)):
            if not _rel(a, b) <= TRAIN_TOL[key]:
                bad.append(f"{what}: step 1 {key} {a!r} through the "
                           f"kernels, {b!r} under policy off")
        gate = (f", step 1 kernels/off loss {_rel(kl, pl):.1e} grad_norm "
                f"{_rel(kn, pn):.1e} ({r['gate']['seconds']:.1f}s)")
    ms = statistics.median(r["seconds"][1:] or r["seconds"]) * 1e3
    split = {k: statistics.median(sp[k] for sp in r["splits"][1:]
                                  or r["splits"]) * 1e3
             for k in r["splits"][0]}
    peak = f"{r['peak'] / 2**30:.3f} GiB" if r["peak"] else "not measured"
    n = len(losses)
    return ("losses " + " ".join(f"{v:.5f}" for v in losses[:3])
            + (" ..." if n > 3 else "") + gates + gate
            + f", {launches['nm_spmm']} nm_spmm ({r['linears']} a forward), "
            f"{ms:.1f} ms a step (" + ", ".join(
                f"{k} {v:.1f}" for k, v in split.items())
            + f"), {rows / ms * 1e3:.0f} tokens/s, peak {peak}; case "
            f"{r['case_s']:.1f}s (built {r['built_s']:.1f}s"
            + (f", saved {r['save_s']:.1f}s" if "save_s" in r else "")
            + (f", compared {r['diff_s']:.1f}s" if "diff_s" in r else "")
            + ")")


def sharded_train_phase(dev, tmp: Path, *, full=True,
                        sizes=SHARDED_TRAIN) -> dict:
    """Phase 35 (module docstring): yi-9b trained on gloo ranks sharing
    the card against the single process on the same weights and batches.
    Returns the ranks' launches by kernel (the steps of every case)."""
    import collections

    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import build_model
    from repro_torch.launch.sharded import Reference, train_rank
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    on_card = dev.type == "cuda"
    steps, bsteps = sizes["steps"], sizes["bf16_steps"]
    rows = sizes["batch"] * sizes["seq"]
    ckpt_dir = str(tmp / "train_2x2")

    def tcfg(n):
        return TrainConfig(opt=AdamWConfig(lr=sizes["lr"],
                                           warmup_steps=sizes["warmup"],
                                           total_steps=n), remat="none")

    def model(seed=0):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        return build_model("yi-9b", full=full, layers=sizes["layers"],
                           kernels=True, dtype=torch.float32, seed=seed,
                           device=dev)

    cfg, lm = model()
    linears = compressed_linears(lm)
    pipe_kw = dict(vocab_size=cfg.vocab_size, seq_len=sizes["seq"],
                   global_batch=sizes["batch"])
    print(f"sharded train: {cfg.name} d_model={cfg.d_model} layers="
          f"{cfg.n_layers}, {sum(p.numel() for p in lm.parameters())} f32 "
          f"params, batch {sizes['batch']} x seq {sizes['seq']}, "
          f"{linears} compressed Linears", flush=True)
    del lm

    def single(compute, n, save_at=None):
        """The single process's n steps: metrics, seconds, peak, the
        steps' launches and its state after ``save_at`` in host shared
        memory (a ``Reference``)."""
        _, lm_ = model()
        if compute == "bf16":
            lm_.set_compute_dtype(torch.bfloat16)
        tc = tcfg(n)
        lm_, opt = init_train_state(lm_, tc)
        step = make_train_step(lm_, tc)
        pipe = DataPipeline(PipelineConfig(**pipe_kw))
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        kernels = zero_counts()
        metrics, times, saved = [], [], None
        for i in range(n):
            t0 = time.perf_counter()
            lm_, opt, mt = step(lm_, opt, pipe.next())
            metrics.append({k: float(v) for k, v in mt.items()})
            times.append(time.perf_counter() - t0)
            if save_at == i + 1:
                t0 = time.perf_counter()
                saved = Reference(lm_, opt)
                print(f"sharded train: single {compute} state of step "
                      f"{i + 1} kept whole in host shared memory in "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
        launches = {k: kern.launches for k, kern in kernels.items()}
        counts = {"dispatches": dict(registry_counts()),
                  "launches": launches}
        peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        del lm_, opt, step
        return metrics, times, peak, counts, saved

    ref, ref_s, ref_peak, counts, state = single("f32", steps,
                                                  save_at=steps)
    rank_counts(f"sharded train single f32", counts, steps, linears,
                on_card)
    bref, bref_s, bref_peak, counts, _ = single("bf16", bsteps)
    rank_counts(f"sharded train single bf16", counts, bsteps, linears,
                on_card)

    base = dict(cfg=cfg, seed=0, pipeline=pipe_kw,
                compute="f32", mode="fsdp", tcfg=tcfg(steps), steps=steps,
                reference=state.names, tol=SHARDED_TRAIN_TOL["state"])
    four = {"2x2 fsdp f32": dict(base, gate=True, save=(ckpt_dir, 2)),
            "2x2 tp_only f32": dict(base, mode="tp_only"),
            "2x2 fsdp bf16": dict(base, compute="bf16", tcfg=tcfg(bsteps),
                                  steps=bsteps, reference=None)}
    two = {"2x1 fsdp f32": dict(base, mesh=(2, 1)),
           "1x2 fsdp f32": dict(base, mesh=(1, 2)),
           "1x2 resumed at step 2 from 2x2": dict(
               base, mesh=(1, 2), resume=(ckpt_dir, 2))}
    results = {}
    try:
        for world, cases in (((2, 2), four), ((1, 2), two)):
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            res = mesh_mod.spawn(train_rank, *world, backend="gloo",
                                 device=dev.type, timeout_s=RANK_TIMEOUT_S,
                                 args=(list(cases.values()),))
            print(f"sharded train: {len(res)} ranks, {len(cases)} cases in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            for i, name in enumerate(cases):
                results[name] = [r[i] for r in res]
    finally:
        state.close()

    tol = SHARDED_TRAIN_TOL
    total = collections.Counter()
    bad = []  # every gate is read and printed before the phase fails
    unbroken = results["2x2 fsdp f32"][0]["metrics"]
    for name, ranks in results.items():
        case = {**four, **two}[name]
        bf16 = case["compute"] == "bf16"
        first = case["resume"][1] if case.get("resume") else 0
        lines = []
        for rank, r in enumerate(ranks):
            what = f"sharded train {name} rank {rank} {r['coords']}"
            n = len(r["metrics"])
            launches = rank_counts(what, r, n, r["linears"], on_card)
            if on_card and launches["nm_spmm"] != r["linears"] * n:
                fail(f"{what}: launches {launches}")
            total.update(launches)
            losses = [m["loss"] for m in r["metrics"]]
            gates = ""
            if bf16:
                if not all(abs(v) != float("inf") and v == v
                           for v in losses):
                    bad.append(f"{what}: a loss is not finite: {losses}")
                head = statistics.mean(losses[:5])
                tail = statistics.mean(losses[-5:])
                if not tail < head:
                    bad.append(f"{what}: the loss did not fall: first 5 "
                               f"mean {head}, last 5 mean {tail}")
            else:
                gates = f32_train_gates(what, r, ref, first, steps, bad)
            if first:
                for key in ("loss", "grad_norm"):
                    d = _rel(r["metrics"][0][key], unbroken[first][key])
                    if not d <= tol["metrics"]:
                        bad.append(f"{what}: step {first + 1} {key} "
                                   f"{r['metrics'][0][key]!r}, the "
                                   "uninterrupted 2x2 run "
                                   f"{unbroken[first][key]!r}")
            lines.append(f"rank {rank} {r['coords']}: " + train_rank_line(
                r, launches, rows, gates, bad, what))
        _ranks_line(f"sharded train {name}", lines)

    def single_line(label, times, peak):
        ms = statistics.median(times[1:]) * 1e3
        p = f"{peak / 2**30:.3f} GiB" if peak else "not measured"
        print(f"sharded train: single process {label}: {ms:.1f} ms a step, "
              f"{rows / ms * 1e3:.0f} tokens/s, peak {p}", flush=True)

    single_line(f"f32 ({steps} steps)", ref_s, ref_peak)
    single_line(f"bf16 ({bsteps} steps)", bref_s, bref_peak)

    # the 2x2 checkpoint restores in one process, and its step 3 is the
    # single process's
    _, lm = model(seed=1)
    tc = tcfg(steps)
    lm, opt = init_train_state(lm, tc)
    state, meta = Checkpointer(ckpt_dir).restore({"params": lm, "opt": opt},
                                                 step=2)
    pipe = DataPipeline(PipelineConfig(**pipe_kw))
    batches = [pipe.next() for _ in range(3)]
    lm, opt, mt = make_train_step(lm, tc)(lm, state["opt"], batches[2])
    for key in ("loss", "grad_norm"):
        d = _rel(float(mt[key]), ref[2][key])
        if meta["format"] != 3 or not d <= tol["metrics"]:
            fail(f"sharded train: the 2x2 checkpoint restored in one "
                 f"process (format {meta['format']}): step 3 {key} "
                 f"{float(mt[key])!r}, the single process's {ref[2][key]!r}")
    print(f"sharded train: the 2x2 checkpoint of step 2 (format "
          f"{meta['format']}) restored in one process: step 3 loss "
          f"{float(mt['loss'])!r} (single process {ref[2]['loss']!r})",
          flush=True)
    del lm, opt, state
    if bad:
        fail("; ".join(bad))
    return dict(total)


def train_cut(arch, full=True):
    """``arch`` cut to its TRAIN_CUTS blocks (one period; an encoder's to
    the same blocks), every width full, the compressed weights on the
    kernels."""
    import dataclasses

    from repro_torch.configs import get_config, get_reduced

    cfg = (get_config if full else get_reduced)(arch)
    keep = TRAIN_CUTS[arch]

    def cut(blocks):
        return ((tuple(blocks[i] for i in keep), 1),)

    enc = cut(cfg.encoder_blocks()) if cfg.encoder_plan else None
    return dataclasses.replace(
        cfg, plan=cut(cfg.blocks()), encoder_plan=enc,
        sparsity=dataclasses.replace(cfg.sparsity, use_kernel=True))


def moe_recurrent_train_phase(dev, tmp: Path, *, full=True,
                              sizes=MOE_RECURRENT_TRAIN,
                              archs=(RWKV, DEEPSEEK, JAMBA,
                                     WHISPER)) -> dict:
    """Phase 36 (module docstring): the MoE, recurrent and
    encoder-decoder cuts trained on gloo ranks sharing the card against
    one process on the same weights and batches. Returns the ranks'
    launches by kernel."""
    import collections
    import copy
    import shutil

    from repro_torch.configs.base import MoEConfig
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.sharded import (
        Reference,
        make_shardwise_train_step,
        train_rank,
        with_frames,
    )
    from repro_torch.models.transformer import LM
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    on_card = dev.type == "cuda"
    steps, rows = sizes["steps"], sizes["batch"] * sizes["seq"]
    tcfg = TrainConfig(opt=AdamWConfig(lr=sizes["lr"],
                                       warmup_steps=sizes["warmup"],
                                       total_steps=steps), remat="none")
    saved = (DEEPSEEK, WHISPER)  # the 2x2 runs saved and resumed at 1x2
    ckpt_dirs = {arch: str(tmp / f"train36_{arch}") for arch in saved}
    keys = ("loss", "nll", "aux", "lr", "grad_norm")

    def model(cfg, seed=0):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        return LM.init(cfg, seed=seed, dtype=torch.float32, device=dev)

    def batches(arch):
        pipe = DataPipeline(PipelineConfig(**pipes[arch]))
        out = [pipe.next() for _ in range(steps)]
        if cfgs[arch].encoder_plan is not None:
            out = with_frames(out, cfgs[arch], FRAMES_SEED)
        return out

    def single(arch, data):
        """One process's steps on the arch's model: on the whole batch
        (``data`` 1) or the shard-wise step over ``data`` data shards;
        its state after step 1 kept in host shared memory (a
        ``Reference`` of REFERENCE_EVERY). (metrics, seconds, peak,
        trained floats, compressed Linears, the Reference)."""
        lm = model(cfgs[arch])
        sizes_ = (sum(p.numel() for p in lm.parameters()),
                  compressed_linears(lm))
        lm, opt = init_train_state(lm, tcfg)
        step = (make_train_step(lm, tcfg) if data == 1
                else make_shardwise_train_step(lm, tcfg, data))
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        metrics, times, state = [], [], None
        try:
            for b in batches(arch):
                t0 = time.perf_counter()
                lm, opt, mt = step(lm, opt, b)
                metrics.append({k: float(v) for k, v in mt.items()})
                times.append(time.perf_counter() - t0)
                if len(metrics) == 1:
                    state = Reference(lm, opt, every=REFERENCE_EVERY)
        except BaseException:
            if state is not None:
                state.close()
            raise
        peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        del lm, opt, step
        return (metrics, times, peak) + sizes_ + (state,)

    cfgs = {arch: train_cut(arch, full) for arch in archs}
    pipes = {arch: dict(vocab_size=cfg.vocab_size, seq_len=sizes["seq"],
                        global_batch=sizes["batch"])
             for arch, cfg in cfgs.items()}
    refs = {}  # (arch, data) -> single()

    def oracle(arch, data):
        """The data shards of the reference a run of ``data`` data ranks
        is held to."""
        return 1 if arch in WHOLE_BATCH_ORACLE else data

    four, two, results = {}, {}, {}
    # the ranks of jamba's cut hold 15-17 GiB each of the card's 80: their
    # allocator maps segments as it grows them, so freed blocks of one
    # size serve another (the environment of the spawned ranks only)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for arch, cfg in cfgs.items():
            t0 = time.perf_counter()
            for data in sorted({oracle(arch, 1), oracle(arch, 2)}):
                refs[(arch, data)] = single(arch, data)
            print(f"moe/recurrent train: {cfg.name} one process's "
                  f"references in {time.perf_counter() - t0:.1f}s",
                  flush=True)

        def base(arch, data, **kw):
            frames = FRAMES_SEED if cfgs[arch].encoder_plan else None
            return dict(cfg=cfgs[arch], seed=0, pipeline=pipes[arch],
                        frames=frames, compute="f32", mode="fsdp",
                        tcfg=tcfg, steps=steps, reference_at=1,
                        tol=MOE_RECURRENT_TOL["state"],
                        reference=refs[(arch, oracle(arch, data))][-1].names,
                        **kw)

        for arch in archs:
            four[(arch, "1x4")] = base(arch, 1, mesh=(1, 4))
            four[(arch, "2x2 fsdp")] = base(
                arch, 2, mesh=(2, 2), gate=True,
                save=(ckpt_dirs[arch], 1) if arch in saved else None)
            two[(arch, "1x2")] = base(arch, 1, mesh=(1, 2))
            if arch in saved:
                two[(arch, "1x2 resumed at step 1 from 2x2")] = dict(
                    base(arch, 1, mesh=(1, 2), resume=(ckpt_dirs[arch], 1)),
                    reference=None)
        for world, cases in (((2, 2), four), ((1, 2), two)):
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            res = mesh_mod.spawn(train_rank, *world, backend="gloo",
                                 device=dev.type, timeout_s=RANK_TIMEOUT_S,
                                 args=(list(cases.values()),))
            print(f"moe/recurrent train: {len(res)} ranks, {len(cases)} "
                  f"cases in {time.perf_counter() - t0:.1f}s", flush=True)
            for i, name in enumerate(cases):
                results[name] = [r[i] for r in res]
    finally:
        for ref in refs.values():
            ref[-1].close()
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    for arch, cfg in cfgs.items():
        moe = any(isinstance(b.mlp, MoEConfig) for b in cfg.blocks())
        order = ("per-shard MoE, another function" if moe
                 else "the same function in another order")
        text = (f"moe/recurrent train: {cfg.name} cut to blocks "
                f"{TRAIN_CUTS[arch]}" + (" of the encoder and the decoder"
                                         if cfg.encoder_plan else "")
                + f" d_model={cfg.d_model}, {refs[(arch, 1)][3]} f32 "
                f"params, {refs[(arch, 1)][4]} compressed Linears, batch "
                f"{sizes['batch']} x seq {sizes['seq']}")
        if (arch, 2) in refs:
            text += (f"; whole batch against two data shards ({order}): "
                     + ", ".join(
                         f"step {j + 1} {k} {_rel(a[k], b[k]):.2e}"
                         for j, (a, b) in enumerate(zip(refs[(arch, 1)][0],
                                                        refs[(arch, 2)][0]))
                         for k in ("loss", "grad_norm")))
        print(text, flush=True)

    total = collections.Counter()
    bad = []  # every gate is read and printed before the phase fails
    for (arch, name), ranks in results.items():
        case = {**four, **two}[(arch, name)]
        data = case["mesh"][0]
        first = case["resume"][1] if case.get("resume") else 0
        ref = refs[(arch, oracle(arch, data))][0]
        whole = arch in WHOLE_BATCH_ORACLE
        lines = []
        for rank, r in enumerate(ranks):
            what = f"moe/recurrent train {arch} {name} rank {rank} " \
                   f"{r['coords']}"
            n = len(r["metrics"])
            launches = rank_counts(what, r, n, r["linears"], on_card)
            if on_card and launches["nm_spmm"] != r["linears"] * n:
                fail(f"{what}: launches {launches}")
            if whole and r["linears"] != refs[(arch, 1)][4]:
                # no experts to split: a rank keeps every compressed Linear
                fail(f"{what}: {r['linears']} compressed Linears, the "
                     f"model {refs[(arch, 1)][4]}")
            total.update(launches)
            # a resumed run: deepseek's checked below; one whose oracle
            # is the whole batch continues its reference's steps
            gates = ("" if first and not whole else
                     f32_train_gates(what, r, ref, first, 1, bad, keys,
                                     MOE_RECURRENT_TOL))
            lines.append(f"rank {rank} {r['coords']}: " + train_rank_line(
                r, launches, rows, gates, bad, what))
        _ranks_line(f"moe/recurrent train {arch} {name}", lines)
    for (arch, data), (_, times, peak, *_) in refs.items():
        ms = statistics.median(times[1:] or times) * 1e3
        p = f"{peak / 2**30:.3f} GiB" if peak else "not measured"
        print(f"moe/recurrent train: {arch} one process "
              f"{'whole batch' if data == 1 else 'shard-wise over 2'}: "
              f"{ms:.1f} ms a step, {rows / ms * 1e3:.0f} tokens/s, "
              f"peak {p}", flush=True)

    if DEEPSEEK in archs:
        # the 2x2 checkpoint of step 1 restored in one process: its
        # shard-wise step 2 is the uninterrupted 2x2 run's, its
        # whole-batch step 2 the 1x2 run resumed from it
        lm = model(cfgs[DEEPSEEK], seed=1)
        lm, opt = init_train_state(lm, tcfg)
        state, meta = Checkpointer(ckpt_dirs[DEEPSEEK]).restore(
            {"params": lm, "opt": opt}, step=1)
        b = batches(DEEPSEEK)[1]
        twin, twin_opt = copy.deepcopy(lm), copy.deepcopy(state["opt"])
        _, _, sw = make_shardwise_train_step(lm, tcfg, 2)(lm, state["opt"],
                                                          b)
        del lm
        _, _, whole = make_train_step(twin, tcfg)(twin, twin_opt, b)
        del twin, twin_opt, state
        for what, got, want in (
                ("shard-wise step 2 / the uninterrupted 2x2 run's", sw,
                 results[(DEEPSEEK, "2x2 fsdp")][0]["metrics"][1]),
                *(("whole-batch step 2 / the resumed 1x2 run's rank "
                   f"{i}", whole, r["metrics"][0]) for i, r in enumerate(
                    results[(DEEPSEEK, "1x2 resumed at step 1 from 2x2")]))):
            for key in keys:
                d = _rel(float(got[key]), want[key])
                if meta["format"] != 3 or not d <= SHARDED_TRAIN_TOL[
                        "metrics"]:
                    bad.append(f"moe/recurrent train: the deepseek 2x2 "
                               f"checkpoint (format {meta['format']}) "
                               f"restored in one process: {what} {key} "
                               f"{float(got[key])!r} / {want[key]!r}")
            print(f"moe/recurrent train: the deepseek 2x2 checkpoint of "
                  f"step 1 restored in one process: {what}: loss "
                  f"{float(got['loss'])!r} / {want['loss']!r}", flush=True)
    for directory in ckpt_dirs.values():
        shutil.rmtree(directory, ignore_errors=True)
    if bad:
        fail("; ".join(bad))
    return dict(total)


def registry_counts() -> dict:
    from repro_torch.kernels import registry

    return registry.dispatch_counts()


def family_totals(counts) -> tuple:
    """(prefill, decode) dispatches of a serve, whatever the family."""
    pre = sum(v for k, v in counts.items() if "decode" not in k[0])
    dec = sum(v for k, v in counts.items() if "decode" in k[0])
    return pre, dec


def start_dryrun(out: Path):
    """Phase 37 (c)'s host work: the single-mesh production cells of
    DRYRUN_ARCHS made and run on meta by ``launch.dryrun`` in a process
    of its own that cannot see the card; returns (the process, its log).
    The caller kills it if it is still running at the end."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else [])))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
           "single", "--out", str(out / "dryrun")]
    for arch in DRYRUN_ARCHS:
        cmd += ["--arch", arch]
    log = open(out / "dryrun.log", "w")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            env=env, cwd=ROOT), log


def _grown(dev, before):
    """Bytes allocated on the card since ``before`` (None off the card)."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev) - before


def _held_to(what, cell_bytes, grown, parts) -> str:
    """Gate ``cell_bytes`` to within DRYRUN_TOL of ``grown`` (not measured
    off the card); ``parts`` {name: (meta bytes, real bytes)} must be
    equal. Returns the line's text."""
    for name, (meta, real) in parts.items():
        if meta != real:
            fail(f"dry-run {what}: the meta cell's {name} {meta} B, the "
                 f"real model's {real} B")
    if grown is None:
        return (f"{cell_bytes / 2**30:.4f} GiB; the card's allocation not "
                "measured (CPU)")
    rel = abs(cell_bytes - grown) / grown
    if not rel <= DRYRUN_TOL:
        fail(f"dry-run {what}: argument bytes {cell_bytes} against "
             f"{grown} allocated on the card: {rel:.4%} > {DRYRUN_TOL:.0%}")
    return (f"{cell_bytes / 2**30:.4f} GiB against {grown / 2**30:.4f} GiB "
            f"allocated on the card ({rel:.4%}, limit {DRYRUN_TOL:.0%})")


def bounds_unchanged(report: dict) -> None:
    """The kernels line's bounds, now from ``core.cost_model``, equal the
    ones it carried before (BOUNDS_BEFORE)."""
    for name, before in BOUNDS_BEFORE.items():
        got = report[name]["bound_ms"]
        if abs(got - before) > 1e-12 * before:
            fail(f"dry-run: {name}'s bound {got!r} ms, before {before!r}")
    print(f"dry-run 37 (a): the kernels line's {len(BOUNDS_BEFORE)} bounds "
          "equal the ones before the rates moved into core.cost_model",
          flush=True)


def dryrun_phase(dev, *, full=True, serve=SERVE, train=TRAIN,
                 report=None, proc=None, out=None) -> None:
    """Phase 37 (module docstring): (a) the serve and train cells against
    the card (and ``report``'s bounds against BOUNDS_BEFORE), (b) the
    model-FLOP share of phases 5 and 20's measured steps, (c) the
    production rows ``proc`` wrote under ``out``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import MetaMesh
    from repro_torch.launch.serve import build_model, served_config
    from repro_torch.launch.specs import make_cell, model_bytes, tree_bytes
    from repro_torch.launch.train import build_trainer
    from repro_torch.roofline import analysis
    from repro_torch.roofline.report import fmt_table, load
    from repro_torch.roofline.step_cost import step_cost
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.train_loop import TrainConfig

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()

    def base():
        gc.collect()
        if not on_card:
            return None
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(dev)

    def analyzed(cell, cost):
        return analysis.analyze(cell.name, cost, 1, cell.model_flops,
                                cell.memory,
                                mesh_shape={"data": 1, "model": 1})

    # (a) the serve cell: phase 5's model, slots and cache length
    max_seq = serve["prefill_len"] + serve["max_new"]
    cfg = served_config("yi-9b", full=full, layers=serve["layers"],
                        kernels=True)
    cell = make_cell("yi-9b", "serve_decode", MetaMesh(1, 1, 0),
                     cfg_override=cfg, shape_override=ShapeConfig(
                         "serve_decode", max_seq, serve["slots"], "decode"))
    cost = step_cost(cell.fn, *cell.args)
    nm = sum(n for (op, _), n in cost["dispatches"].items()
             if op.startswith("nm_matmul"))
    served = MEASURED.get("serve bf16", {}).get("per_step")
    if nm != gemms_per_step(cfg) or (served is not None and nm != served):
        fail(f"dry-run serve: {nm} N:M dispatches a decode step "
             f"({cost['dispatches']}); the serve launched {served} a step, "
             f"the config's shapes give {gemms_per_step(cfg)}")
    before = base()
    _, lm = build_model("yi-9b", full=full, layers=serve["layers"],
                        kernels=True, dtype=torch.bfloat16, seed=0,
                        device=dev)
    eng = ServeEngine(lm, slots=serve["slots"], max_seq=max_seq,
                      prefill_len=serve["prefill_len"], graphs=on_card)
    line = _held_to("serve", cell.memory["argument_size_in_bytes"],
                    _grown(dev, before) if on_card else None, {
                        "params": (cell.memory["params_bytes"],
                                   model_bytes(lm)),
                        "cache": (cell.memory["cache_bytes"],
                                  tree_bytes(eng.caches))})
    del lm, eng
    serve_rep = analyzed(cell, cost)
    print(f"dry-run 37 (a): yi-9b serve cell, {cfg.n_layers} layers, "
          f"{serve['slots']} slots x {max_seq} positions: {nm} N:M "
          f"dispatches a decode step (the serve: {served}); arguments "
          f"{line}", flush=True)

    # (a) phase 20's train cell: params and AdamW's m and v
    tcfg = served_config("yi-9b", full=full, layers=train["layers"],
                         kernels=True)
    tcell = make_cell("yi-9b", "train", MetaMesh(1, 1, 0),
                      cfg_override=tcfg, shape_override=ShapeConfig(
                          "train", train["seq"], train["batch"], "train"),
                      microbatches=1, remat="none")
    state = (tcell.memory["params_bytes"]
             + tcell.memory["optimizer_bytes"])
    before = base()
    _, lm, opt, _ = build_trainer("yi-9b", full=full,
                                  layers=train["layers"], device=dev,
                                  tcfg=TrainConfig(remat="none"))
    line = _held_to("train", state, _grown(dev, before), {
        "params": (tcell.memory["params_bytes"], model_bytes(lm)),
        "m and v": (tcell.memory["optimizer_bytes"], tree_bytes(opt))})
    del lm, opt
    base()
    tcost = step_cost(tcell.fn, *tcell.args)
    train_rep = analyzed(tcell, tcost)
    print(f"dry-run 37 (a): yi-9b train cell, {tcfg.n_layers} layers, f32 "
          f"weights, batch {train['batch']} x {train['seq']}: params + m + "
          f"v {line}", flush=True)
    if report is not None:
        bounds_unchanged(report)

    # (b) the model FLOPs of the measured steps at the bf16 peak
    for what, rep, ms in (
            ("decode step (phase 5, graphed)", serve_rep,
             MEASURED.get("serve bf16", {}).get("decode_ms")),
            ("train step (phase 20)", train_rep,
             MEASURED.get("train", {}).get("step_ms"))):
        share = ("not measured" if ms is None else
                 f"{rep.model_flops / (ms / 1e3) / analysis.PEAK_FLOPS:.4%}")
        took = "not measured" if ms is None else f"{ms:.3f} ms"
        print(f"dry-run 37 (b): {what}: model FLOPs {rep.model_flops:.6g} "
              f"in {took}: {share} of the bf16 peak "
              f"({analysis.PEAK_FLOPS / 1e12:.0f} TFLOP/s); the dry-run's "
              f"bound {rep.t_bound * 1e3:.3f} ms ({rep.bottleneck}: "
              f"compute {rep.t_compute * 1e3:.3f}, memory "
              f"{rep.t_memory * 1e3:.3f} ms); card: "
              f"{card_line() if on_card else 'none (CPU)'}", flush=True)

    # (c) the production rows, made on the host
    t1 = time.perf_counter()
    print(f"dry-run 37: (a) and (b) in {t1 - t0:.1f}s", flush=True)
    if proc is not None:
        try:
            code = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            fail("dry-run 37 (c): the production cells did not finish")
        if code != 0:
            fail(f"dry-run 37 (c): launch.dryrun exited {code}:\n"
                 + (out / "dryrun.log").read_text()[-3000:])
        print(f"dry-run 37 (c): waited {time.perf_counter() - t1:.1f}s "
              "for the single-mesh (16 x 16) production rows, analytic on "
              "the H100's spec-sheet peaks (not measured):\n"
              + fmt_table(load(str(out / "dryrun")), "single"), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    port()
    # the autotune cache of every phase lives here, never in the home
    # directory: an empty file until the autotune phase fills its own
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
            Path(tmp) / "empty.json")
        run(Path(tmp))


def run(tmp: Path) -> None:
    from repro_torch.core.dots import strict_f32
    from repro_torch.kernels import build

    strict_f32()
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    try:
        built = build.build_all()
    except RuntimeError as e:
        fail(str(e))
    print(f"build: {sorted(build.SOURCES)} ready in "
          f"{time.perf_counter() - t0:.1f}s (compiled now: {sorted(built)})",
          flush=True)
    for name, log in sorted(built.items()):
        print(f"build: {name}: {ptxas_summary(log)}", flush=True)
    dry, dry_log = start_dryrun(tmp)
    try:
        phases(dev, tmp, card, built, dry)
    finally:
        if dry.poll() is None:
            dry.kill()
        dry.wait()
        dry_log.close()


def phases(dev, tmp: Path, card: str, built: dict, dry) -> None:
    """Phases 2 (the build's checks) to 37 and the last lines; ``dry`` is
    phase 37 (c)'s process."""
    sass_tensor_ops()
    attention_build(built)
    gather_build()
    decode_build()

    worst, report = kernel_phase(dev)
    for name, err in cnn_gemm_phase(dev).items():
        worst[name] = max(worst[name], err)
    gworst, greport = gather_phase(dev)
    worst.update(gworst)
    report.update(greport)
    reference_phase(dev)
    reference_phase(dev, quantize="int8")
    launches, counts, _ = serve_phase(dev)
    gc.collect()  # the bf16 model is freed before the int8 one is made
    torch.cuda.empty_cache()
    launches_q, counts_q, _ = serve_phase(dev, quantize="int8")
    if family_totals(counts_q) != family_totals(counts):
        fail(f"serve int8: (prefill, decode) dispatches "
             f"{family_totals(counts_q)} differ from the bf16 serve's "
             f"{family_totals(counts)}")
    launches.update({k: launches_q[k] for k in KERNELS if k.endswith("_q")})
    gc.collect()  # the int8 LM is freed before the next model is made
    torch.cuda.empty_cache()
    paged_serve_phase(dev)
    gc.collect()  # the paged phase's LM is freed before the CNNs are made
    torch.cuda.empty_cache()
    for name in CNN_DISPATCHES:
        for quantize in (None, "int8"):
            cnn_phase(dev, name, quantize=quantize)
            gc.collect()
    swept = sweep_phase(dev)
    launches.update({k: swept[k] for k in KERNELS if "gather" in k})
    worst["bs_attention"], report["bs_attention"] = attention_phase(dev)
    masked_reference_phase(dev)
    gc.collect()  # the CNNs and the sweep's operands are freed
    torch.cuda.empty_cache()
    launches["bs_attention"] = masked_serve_phase(dev)["bs_attention"]
    gc.collect()  # the masked model is freed
    torch.cuda.empty_cache()
    lm = tuned_model(dev)
    autotune_phase(dev, lm, tmp)
    obs_phase(dev, lm, tmp)
    fp8_phase(dev, lm)
    del lm
    gc.collect()  # the tuned model is freed before deepseek's are made
    torch.cuda.empty_cache()
    mla_worst, _ = attention_phase(dev, MLA_ATTN_CASES, MLA_ATTN_HEADS,
                                   what="attention MLA")
    worst["bs_attention"] = max(worst["bs_attention"], mla_worst)
    for name, err in shape_kernel_phase(dev).items():
        worst[name] = max(worst[name], err)
    reference_phase(dev, arch=DEEPSEEK)
    reference_phase(dev, quantize="int8", arch=DEEPSEEK)
    mla_masked_reference_phase(dev)
    serve_phase(dev, layers=DS_LAYERS, arch=DEEPSEEK, eager=False,
                what="deepseek serve")
    gc.collect()  # the full-depth model is freed
    torch.cuda.empty_cache()
    deepseek_cut_phase(dev)
    gc.collect()  # the deepseek models are freed before training
    torch.cuda.empty_cache()
    train_launches = train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    resilient_phase(dev, tmp)
    print(f"train: nm_spmm launches on the train path {train_launches}, on "
          f"the serve path {launches['nm_spmm']}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    for name, err in shape_kernel_phase(
            dev, RECURRENT_SHAPES, RECURRENT_PREFILL_M, RECURRENT_DECODE_M,
            what="recurrent kernels", seed=5).items():
        worst[name] = max(worst[name], err)
    shape_timing_phase(dev)
    for arch in (RWKV, JAMBA):
        reference_phase(dev, arch=arch)
        reference_phase(dev, quantize="int8", arch=arch)
    serves = {"yi-9b serves, sweep and masked serve": dict(launches)}
    serves[RWKV] = recurrent_phase(dev, RWKV, quantizes=(None, "int8"))
    serves[JAMBA] = recurrent_phase(dev, JAMBA, layers=JAMBA_LAYERS)

    def timed(label, fn, *args, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"phase seconds: {label} {time.perf_counter() - t1:.1f}s",
              flush=True)
        return out

    def new_shapes():
        for shapes, (pre_m, dec_m), what, seed in (
                (WHISPER_SHAPES, WHISPER_M, "whisper kernels", 11),
                (GEMMA_SHAPES, GEMMA_M, "gemma3 kernels", 12),
                (GQA_SHAPES, GQA_M, "gqa kernels", 13)):
            for name, err in shape_kernel_phase(dev, shapes, pre_m, dec_m,
                                                what=what,
                                                seed=seed).items():
                worst[name] = max(worst[name], err)
        shape_timing_phase(dev, {**WHISPER_SHAPES, **GEMMA_SHAPES,
                                 **GQA_SHAPES}, what="new configs")
        shape_timing_phase(dev, WHISPER_SHAPES, what="whisper encoder",
                           prefill_m=ENCODER_M, decode=False)

    def whisper_reference():
        for quantize in (None, "int8"):
            reference_phase(dev, quantize=quantize, arch=WHISPER)

    timed("26 whisper reference", whisper_reference)
    timed("new shapes", new_shapes)
    serves[WHISPER] = timed("27 whisper serve bf16", whisper_serve_phase,
                            dev)
    wq = timed("27 whisper serve int8", whisper_serve_phase, dev,
               quantize="int8")
    serves[WHISPER] = {k: serves[WHISPER].get(k, 0) + wq.get(k, 0)
                       for k in KERNELS}
    timed("28 whisper train", train_phase, dev, sizes=WHISPER_TRAIN,
          arch=WHISPER, what="whisper train")
    serves[GEMMA] = timed("29 gemma3", gemma3_phase, dev)
    serves["chameleon, codeqwen, internlm2"] = timed(
        "30 gqa configs", gqa_configs_phase, dev)
    for name, err in timed("31 shard and 236b shapes", shard_shapes_phase,
                           dev).items():
        worst[name] = max(worst[name], err)
    serves["yi-9b sharded f32, all ranks"] = timed(
        "32 sharded serve f32", sharded_f32_phase, dev)
    serves["yi-9b sharded bf16, all ranks"] = timed(
        "33 sharded serve bf16", sharded_bf16_phase, dev,
        sizes=SHARDED_BF16)
    serves[DS236] = timed("34 deepseek-v2-236b", ds236_phase, dev)
    serves["yi-9b sharded train, all ranks"] = timed(
        "35 sharded train", sharded_train_phase, dev, tmp)
    print(f"sharded train: nm_spmm launches on the ranks' train steps "
          f"{serves['yi-9b sharded train, all ranks'].get('nm_spmm', 0)}",
          flush=True)
    moe_train = serves["MoE and recurrent sharded train, all ranks"] = timed(
        "36 moe/recurrent sharded train", moe_recurrent_train_phase, dev,
        tmp)
    print(f"moe/recurrent train: nm_spmm launches on the ranks' train "
          f"steps {moe_train.get('nm_spmm', 0)}", flush=True)
    timed("37 dry-run", dryrun_phase, dev, report=report, proc=dry, out=tmp)
    for name in KERNELS:
        launches[name] = sum(v.get(name, 0) for v in serves.values())
    print("serve launches by model: " + "; ".join(
        f"{arch} {dict((k, v) for k, v in counts.items() if v)}"
        for arch, counts in serves.items()), flush=True)

    src = "src/repro_torch/kernels/indexmac/csrc/"
    gsrc = "src/repro_torch/kernels/indexmac_gather/csrc/"
    rows = [
        dict(name="nm_spmm", route="cuda", source=src + "nm_spmm.cu",
             replaces="src/repro/kernels/indexmac/kernel.py:217"),
        dict(name="nm_spmm_decode", route="cuda",
             source=src + "nm_spmm_decode.cu",
             replaces="src/repro/kernels/indexmac/decode_kernel.py:202"),
        dict(name="nm_spmm_q", route="cuda", source=src + "nm_spmm_q.cu",
             replaces="src/repro/kernels/indexmac/kernel.py:155"),
        dict(name="nm_spmm_decode_q", route="cuda",
             source=src + "nm_spmm_decode_q.cu",
             replaces="src/repro/kernels/indexmac/decode_kernel.py:202"),
        dict(name="indexmac_gather", route="cuda",
             source=gsrc + "indexmac_gather.cu",
             replaces="src/repro/kernels/indexmac_gather/kernel.py:175"),
        dict(name="indexmac_gather_q", route="cuda",
             source=gsrc + "indexmac_gather_q.cu",
             replaces="src/repro/kernels/indexmac_gather/kernel.py:127"),
        dict(name="bs_attention", route="cuda",
             source="src/repro_torch/kernels/blocksparse_attn/csrc/"
                    "bs_attention.cu",
             replaces="src/repro/kernels/blocksparse_attn/kernel.py:98"),
    ]
    for r in rows:
        r.update(launches=launches[r["name"]], max_abs_err=worst[r["name"]],
                 **report[r["name"]])
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
