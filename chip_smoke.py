#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase, on one CUDA device
    python3 chip_smoke.py --profile  # also B1/B2 under every decode split; then
                                     # torch.profiler: decode steps (short and
                                     # long contexts), a long prefill

Phases, in order; any failure raises and the script exits non-zero:

1. device   -- the card's name and power limit; TF32 off for matmul/cuDNN.
2. build    -- nvcc builds the seven kernel sources (eight kernels) from
               src/repro_torch/csrc, one process per source, all at once.
3. kernels  -- each kernel against its plain PyTorch version on the card at
               the shapes its main path gives it: B1-B4 at full-width
               tinyllama-1.1b (decode batches, prompt lengths at prefill
               up to M 2032, and the M edges of B1/B2's two regimes: 1,
               63-65, 127-129; B1 and B2 also launched twice on the same
               operands, which must give the same bits; B4 also equal to
               B1 bit for bit, on an fp32 payload and on a column that
               keeps no block), B6's bf16 kernel at lengths 1-2048 around
               its tile edges for G = 8, 1 and 4, causal, non-causal and
               under a 256-token window, then at a 2048-token causal
               prefill (twice for the same bits) and an 1100-token int8-K/V one, B3
               also at the long phase's contexts (40-2032 tokens, B 8 and 4) and
               twice for the same bits, and at the spec phase's verify step
               (B 8, T 5: 40 rows per KV head), B5 at the int8 head (2048x32000, M 8
               and 40) and 2048x5632 (M 8, 40 and 2032), each call's regime
               logged and launched twice for the same bits,
               B7/B8 at HAR-6's widest layer (2000x1500, B 1, 16 and 32;
               B7 also twice for the same bits) and ragged shapes, each
               call's stream plan logged, B8 also on saturated codes that
               force the int32 wrap; the card's resident clusters of 1..8
               CTAs, which the stream plan rests on.  Timings are CUDA
               events, median of single launches after an L2 flush, with
               the bound and a PyTorch library call as a yardstick (B8's:
               the fp64 matmul with both casts, and on pre-converted
               operands); B7/B8 also the kernel's own time from
               torch.profiler (flushed and warm L2), which leaves out the
               events' floor (a one-element add_, logged), beside one
               torch.sum over the same weight bytes (the memory's floor
               under the same flush); also the host's time per B1 and B4
               call at decode.  With --profile, then B1/B2 at
               decode batches under every regime their C entry takes
               (the split sweep ``launch_plan`` rests on), and B3 at
               decode under every (split, groups) (what ``paged_split``
               and ``paged_groups`` rest on).  Then the dense families'
               shapes (``phase_family_kernels``): B6 at hd 128 (glm4-9b's
               32/2 heads) and hd 256 (gemma3-4b's 8/4, causal and under
               its 1024-token window) at 2048 tokens, B3 at hd 128 and 256
               at the serve step (T 1) and the verify step (T 5), B2 with
               the gelu_glu epilogue at gemma3's 2560x10240 pair; each held
               to its plain version, launched twice for the same bits, and
               timed beside its plain version and its library call; each
               is a row of its kernel in the summary line, with the
               launches the families phase counts at that shape.  Then
               the MoE family's shapes (``phase_moe_kernels``): B2 and B1
               over a stack of experts (one launch, gridDim.z = E) at
               granite-moe's 32 x 1024 x 512 / 32 x 512 x 1024 and
               qwen2-moe's 64 x 2048 x 1408 / 64 x 1408 x 2048 stacks at M 8
               an expert, each equal bit for bit to E single-expert
               launches in the stack's regime and timed beside torch.bmm on
               the dequantized stack; stacked B4 equal to stacked B1; B3 at
               qwen2-moe's 16/16 heads, hd 128 (T 1, T 5), B6 at its
               2048-token prefill, B5 at its 2048 x 151936 head.  Then
               the enc-dec and VLM shapes (``phase_encdec_kernels``): B3
               non-causal over whisper-tiny's 1500 frames in 94 bf16 pages
               of 16 (B 8, 6/6 heads, hd 64), B6 non-causal at whisper's
               encoder (1500 x 1500) and its prefill's cross-attention (40
               queries x 1500 keys), B3 at internvl2-2b's 16/8 heads (hd
               128, int8 pages, after its 256 patches), B6 at internvl's
               16/8 heads at 2032 positions, B5 at its 2048 x 92553 head
               (the dense_tile regime: its rows are no multiple of 16
               bytes).  Then the recurrent families' and the mixed run's
               shapes (``phase_recurrent_kernels``): B6 at recurrentgemma's
               10/1 heads (G 10), hd 256, window 2048, at 2048 and 4096
               tokens (the window bites), B2 gelu_glu at its 2560 x 7680
               pair, B1 at both families' projections (summed, M 8), B5 in
               dense_tile at xlstm-350m's ragged leaves (1024 x 8, 1024 x
               2730, 1365 x 1024) and in wgmma at its 1024 x 50304 head, B3
               over bf16 pages at tinyllama's 32/4 heads.  The logit
               softcap (30, queries scaled by 20 so the cap bends the
               scores): B6 at hd 64 (32/4), 128 (32/2), 256 (8/4) causal and
               256 under its 1024-token window at 2048 tokens, B3 at
               tinyllama's heads at T 1 and T 5, each held to its plain
               version, twice for the same bits, timed beside one capped
               ``flex_attention`` call (SDPA has no cap), also held to the
               plain version.
4. fcnet    -- the paper's four FC nets (Table 2) at published widths,
               random weights from a seed: forward_fp32 / forward_pruned
               (B7) held to the plain path, forward_q78 (B8) equal to it
               bit for bit and forward_q78_sectioned equal to forward_q78;
               B7/B8 launch counts equal layers x forwards, and every
               layer's stream plan (strip, split, copy width) and the
               launches by copy width are logged; then the batch sweep
               1..32 (ms per sample, fp32 and Q7.8 paths).
5. serve    -- full-width tinyllama-1.1b (22 layers, d 2048, random weights
               from a seed) with the quickstart flags: quant_sparse
               q_prune 0.5, 128-blocks, paged int8 KV, prefix sharing.
               Every request must finish, the page audit must be clean,
               prefix pages must be shared, and the launch counters of B1,
               B2, B3 and B5 (the int8 head) must rise during the run; B4
               must not launch (every served leaf carries its walk), and every
               B5 launch must be in its wgmma regime.
6. plancache -- the serve flags with --plan-cache in a temporary
               directory: the first boot packs and saves, the second hits,
               restores every leaf bit for bit and serves the serve
               phase's greedy tokens through B1 (B4 not launched).  Then
               the same plan saved without its walks: a third boot serves
               the 8 requests through B4 (5 x 22 launches per model step,
               prefill or decode; B1 none; B2, B3, B5 as in the serve
               phase) with a clean page audit and the walk plan's greedy
               tokens, every one (B4 equals B1 bit for bit), and its
               teacher-forced
               logits are held to the plain path as in the parity phase.
               Logs the directory's size and the boot times (pack vs load).
7. long     -- the serve flags with --max-len 2048: prompts of 40, 1100,
               1536 and 2032 tokens, 16 new tokens each.  Every prefill
               past 1024 tokens runs its attention through B6 (exactly
               22 x 3 launches); B1, B2, B3 and B5 (wgmma only) must launch too, every
               request must finish and the page audit must be clean; each
               prefill is timed on the card's clock, the 2032-token one
               also against the last measurement before B1/B2 ran on wgmma.
8. parity   -- prefill of the serve phase's prompt lengths and of 2032
               tokens, then teacher-forced decode, through the kernels and
               through the plain versions (with_use_kernel(False),
               prefill(use_kernel=False)) on the same tokens, for the
               served plan and for a --compress quant plan (every
               projection through B5, every launch in its wgmma regime); the
               logits must agree within the stated bf16 tolerance.
8b. softcap -- the serve phase's model and plan with logit_softcap = 30 (no
               config sets one): the 8 requests through the kernels (B1, B2,
               capped B3, B5; B4 not) and the plain versions, streams by the
               near-tie rule; ``_path_parity`` at 36, 40 and 2032 tokens (the
               2032-token prefill runs capped B6 once a layer); teacher-
               forced verify steps (capped B3 at T = 5) against the plain
               versions.  The families phase also prefills glm4-9b and
               gemma3-4b capped at 2032 tokens (B6 at hd 128, hd 256 and
               its window, against the plain versions).
9. spec     -- the serve flags with --draft-config tinyllama-1.1b --spec-k 4
               (a dense bf16 draft from seed + 1): every request finishes,
               the audit is clean, B1, B2, B3 and B5 launch (B3 at T = 5,
               counted by query positions), B4 does not, the ladder stays
               untouched, and the streams match the serve phase's by the
               near-tie rule (equal, or the plain path's top-2 logit gap at
               the first difference within PATH_RTOL of its largest
               logit); each tick's wall time split into the draft steps,
               the verify step and the rest.  Then the target's own plan as
               the draft: accept rate over 0.5, more than one committed
               token a sequence a tick, streams by the same rule, and
               teacher-forced verify logits (T = 5) within PATH_RTOL of the
               plain versions' and of one position a step.
10. chunked -- the long phase's prompts (40-2032 tokens) with --prefill-chunk
               256 --prefill-budget 512, arriving by seeded Poisson arrivals
               on a TickClock (loadgen.run_open_loop: an audit every tick):
               every request finishes, chunks reach B1, B2, B5 and never
               B6; the 40-token request's largest inter-token gap (in
               prefill + decode tokens between its commits) is smaller than
               in the same trace without chunks; each first token matches
               the long phase's by the near-tie rule; LoadReport.summary()
               is printed.
11. faults  -- run_chaos under a seeded_schedule of all six kinds (nan_logits,
               alloc_fail, drop_tick, dead_draft, slow_tick, kernel_fault) at
               the serve flags with --spec-k 2 and a watchdog: every request
               terminal, no page leaked, rung 1 taken exactly at the
               dead_draft tick and rung 2 at the kernel_fault tick, B3's
               counter flat after rung 2, and the requests no fault touched
               keep the fault-free run's streams by the near-tie rule; the
               fault-free run leaves ``degraded`` empty.
12. families -- llama3.2-1b (hd 64, tied head), glm4-9b (hd 128, 16 query
               heads a KV head, an untied int8 head at vocab 151552) and
               gemma3-4b (hd 256, 5:1 local:global layers, window 1024,
               tied head) at full width, glm4 cut to 10 of its 40 layers
               and gemma3 to 12 of 34 (DEPTH_CUTS), random weights from a
               seed, with
               the serve phase's flags and requests: every request
               finishes with a clean audit and shared prefix pages; B1, B2
               and B3 launch, B5 only on glm4's untied head, B4 never; tok/s
               and the median decode step; the same requests through the
               plain versions, the streams held to each other by the
               near-tie rule; then ``_path_parity`` (prefills of 36, 40 and
               2032 tokens, teacher-forced decode, within PATH_RTOL); for
               glm4 and gemma3 a served 2032-token prompt (max_len 2048)
               whose prefill runs B6 once a layer (gemma3: windowed on its
               local layers), timed on the card's clock; for gemma3 its
               own plan as the draft (k 4: rings widened by k, B3 at T = 5,
               accept rate over 0.5, streams by the near-tie rule) and
               chunked prefill (chunks of 256, 512 a tick) of prompts of
               40, 600 and 1000 tokens against the same prompts prefilled
               whole (within the window a chunk sees every key a whole
               prefill sees), never reaching B6.
13. moe      -- granite-moe-1b-a400m (d 1024, 32 experts top-8) and
               qwen2-moe-a2.7b (d 2048, 60 experts padded to 64, top-4, 4
               shared, untied head) at full width, cut to 8 and 4 of their
               24 layers (DEPTH_CUTS: also in the mesh and train phases),
               random weights from a seed, the serve phase's flags and
               requests, each through the kernels and the plain versions
               (streams by the near-tie rule; the build's peak memory
               logged); every stacked B1/B2 launch covers all Ep experts and
               a decode step launches each once a layer; ``_path_parity``
               (prefills of 36, 40 and 2032 tokens -- the last past full
               capacity -- and teacher-forced decode); granite's plan saved
               without walks and booted from --plan-cache (stacked B4, the
               walk plan's tokens exactly) and its self-draft speculation;
               qwen2-moe's served 2032-token prompt (B6 at hd 128, stacked
               B2 at M 172 an expert) and its self-draft speculation (B3 at
               T 5).  Every kernel row must carry launches from a served
               run.
14. encdec_vlm -- whisper-tiny (4 encoder + 4 decoder layers, d 384, 1500
               frames, tied 51865 head) and internvl2-2b (12 of its 24
               layers, DEPTH_CUTS, d 2048, 16/8 heads, hd 128, 256
               patches, untied 92553 head) at full width, whisper at full
               depth, random weights from a seed, the serve
               phase's flags and prompts with random frames or patches
               (whisper: --pool-pages 785, its 94 frame pages a request
               included; internvl: --max-len 320): the engine's warnings
               (int8 KV ignored by the enc-dec, prefix sharing off), each
               through the kernels and the plain versions (streams by the
               near-tie rule), launches exact: whisper's B6 non-causal
               (enc_layers + n_layers) a prefill, B3 non-causal n_layers a
               decode step, B1 only for its projections; internvl's B5 one
               a prefill and a step, all dense_tile.  whisper's prefill and
               paged decode held to the plain versions; internvl's
               ``_path_parity`` with 1776-token prompts (B6 at 2032
               positions) and its served long prompt.
15. recurrent -- recurrentgemma-2b (13 of its 26 layers, DEPTH_CUTS: 9
               RG-LRU + 4 local of window 2048, d 2560, 10/1 heads, hd 256,
               tied 256000 head) and xlstm-350m (12 of 24, DEPTH_CUTS: 6
               mLSTM + 6 sLSTM, d 1024, untied 50304 head) at full width,
               random weights from a seed, the
               serve phase's flags and requests (a contiguous cache: neither
               pages; xlstm serves int8 KV as fp; the warnings logged), each
               through the kernels and the plain versions (streams by the
               near-tie rule), launches by (kernel, K, N) exactly the plan's
               leaves a pass (B5's dense_tile / wgmma split included; B3,
               B4, B6 none), ``_path_parity`` (xlstm's long prefill 512
               tokens: its sLSTM prefill is a loop over the tokens),
               recurrentgemma's served 2032- and 4080-token prompts (B6
               windowed once a local layer each, by (Sq, Sk)), and a timed
               long prefill each, the recurrent cells and the RG-LRU scan
               timed apart.
15b. mesh   -- sharded serving, after the recurrent phase (whose streams,
               with the serve, long, spec, chunked and moe phases', it
               holds its cases to): full-width tinyllama-1.1b with the serve
               flags and --mesh 1x2, 2x2 and 1x8 (kv fallback: 4 KV heads
               on 8 ranks, wk/wv split within a KV head), ranks sharing the
               one card over gloo (--share-card; one process a rank, the
               serve CLI's own ``spawn_ranks``); at 1x2 also --compress
               quant (wo and w_down split on their contraction: an
               all-reduce after B5), the long phase's 2032-token prompt
               (B6 over a rank's 16 q heads), speculative decode (--spec-k
               4, a seed + 1 dense draft on the rank's shards: B3's verify
               at T = 5 on the rank's KV heads; also at 2x2), chunked
               prefill (the long phase's prompts, CHUNK_FLAGS: the chunk
               steps on the rank's shards over its private batch-1 cache),
               granite-moe-1b-a400m (8 layers, DEPTH_CUTS; 16 experts a
               rank; also 1x4, 8 a rank:
               stacked B1/B2 over the rank's experts, one all-reduce a MoE
               layer), qwen2-moe-a2.7b (4 layers; 32 experts a rank; its ranks build
               in turn, as two fp32 inits do not fit the card at once, and
               each logs its peak memory), recurrentgemma-2b (the RG-LRU's
               1280 channels and 5 of 10 q heads a rank) and
               recurrentgemma-2b --compress quant (w_out's partial sums
               all-reduced).  Each rank holds its
               streams to the unsharded ones (the earlier phases', or its
               own unsharded engine's on the same plan for the two quant
               cases) by the near-tie rule, one decode step's logits to the
               unsharded engine's (PATH_RTOL of the largest logit), its
               B1, B2 and B5 launches on its shards (and a MoE layer's
               stacked B2 and B1 on its experts) to the matching columns
               (experts) of the whole leaf's launch and to the plain
               versions (KERNEL_RTOL), B3's
               first launch of its run (its q heads against the pools, at
               1x8 one KV head at an offset into pools that hold all 4; a
               spec run's at T = 5) and
               B6's (the long prompt, its q and KV heads) replayed on the
               same inputs against their plain versions (KERNEL_RTOL); the
               launches of its case's kernels during its run above zero
               and equal across the ranks of a data
               replica; a clean page audit; gloo's all_gather and
               all_reduce on CUDA tensors of every dtype the model path
               sends, exact.  Logs each rank's weight bytes, its
               all-reduces a decode step, its max_memory_allocated, and
               rank 0's median decode tick ("ranks sharing one card over
               gloo: not a multi-card speed").
16. mixed   -- ``--workload-mix tinyllama-1.1b:2,recurrentgemma-2b:1,
               whisper-tiny:1 --compress none --page-size 16`` at full width:
               one shared pool of 881 pages for the two paged families,
               audited every tick; every request finishes, B3 runs causal
               once a global layer a step (bf16 pages) and non-causal once a
               whisper decoder layer a step, B6 non-causal once a whisper
               layer a prefill, the weight kernels never; each member's
               streams equal it served alone.
17. autotune -- the offline autotuner at full width (tinyllama-1.1b at 8 of
               its 22 layers from here on, TAIL_CUTS: autotune, train and
               train_mesh and their ranks; random weights from seed 0):
               (a) ``python -m repro_torch.launch.autotune``'s
               main with the default space, calibration task and
               constraints, anneal, 64 trials, seed 0, into a temporary
               directory with --plan-cache (the search's seconds, every
               oracle run, the winner, its predicted tok/s against the
               uniform candidate's; H100 data-sheet constants, not
               measurements); (b) the winner served through
               ``serve.build_engine`` with --autotune-plan (the serve
               phase's 8 requests, the per-leaf summary logged): the
               kernels its kinds imply launch and no other (B1's wgmma and
               FMA bodies counted apart, B2 only for a gate/up pair of one
               kind, B5 for int8 projections and the head, B3 when paged,
               B4 never), streams held to the same plan's plain versions by
               the near-tie rule, and ``predict_plan_stats`` equal to
               ``compress()`` at full width; (c) the same for a hand-made
               artifact giving every representation a group (w_gate/w_up
               quant_sparse: B2; wq block_sparse: B1's FMA body; wo
               quant_sparse; wk/wv/head/tok quant; w_down dense; int8
               pages); (d) the winner and the uniform candidate each at its
               artifact's max_batch requests of 32 tokens, 10 new: the
               median decode tick at full occupancy, tok/s and the measured
               against the predicted speedup; B1 on an fp32 payload at the
               winner's block_sparse shapes and batch, held to its plain
               version and timed (a row of the kernels line); (e) a boot
               from the CLI's plan cache (a hit) giving (b)'s streams.
18. train   -- training, no kernel of its own (no Pallas kernel lies on the
               reference's training path; B6 has no backward and must not
               launch here): a 2-layer full-width tinyllama in fp32 compute,
               one synthetic batch's loss and gradients on the card against
               the port's CPU run (1e-4 / 1e-3 of each leaf's max), then
               apply_updates on identical gradients on both (1e-6); the
               flash Function's dq/dk/dv against dense_attention's autograd
               (S 2048, 32/4 heads, hd 64, causal and window 256; 1e-4);
               full-width tinyllama-1.1b (fp32 params, bf16 compute) through
               launch.train.run: 4 steps at B 8 x 128, 3 at B 1 x 2048 (the
               flash Function, 22 forward and 22 backward calls a step), 3
               with --accum 2 and 3 with --compression int8 (step 0's loss
               equal to the B 8 x 128 run's), 3 at B 8 x 512 with and
               without --remat (losses to 1e-4, the peak lower); every loss,
               the median step after step 1, tok/s, max_memory_allocated,
               0 restarts; then the other families: each at full width
               with the fewest layers that hold its kinds (granite-moe 2,
               recurrentgemma rec/rec/local, xlstm mLSTM/sLSTM, whisper 1
               encoder + 1 decoder layer at 1500 frames, internvl 2 after
               256 patches) in fp32 compute, one B 2 x 64 batch's loss and
               gradients on the card against the CPU (1e-4 / 1e-3), MoE
               routing compared token for token (flips logged with their
               top-k gap); then granite-moe-1b-a400m (B 8 x 128: two
               dispatch groups of 512, the dropped share logged),
               recurrentgemma-2b (B 4 x 128), xlstm-350m (B 8 x 128; the
               sLSTM cells' share of a step), whisper-tiny (B 8 x 128 text
               tokens over 1500 frames: one flash Function forward and
               backward an encoder layer and a cross-attention a step) and
               internvl2-2b (B 4 x 128 after 256 patches) through
               launch.train.run at full width, 2 steps each, as above;
               B6 unchanged over the phase; a smoke run restarted after a RuntimeError at
               step 4 equal to the uninterrupted one; mnist-4 and har-4 at
               published widths trained and pruned as Table 4 does (400 base
               steps, 4 stages of 200), base and pruned accuracy, q, the
               1.5% objective, B7's pruned accuracy against the plain
               version's, Q7.8's through B8.
18b. analysis -- the dry run (``launch/dryrun.py``) on the card's host:
               tinyllama-1.1b's train step at B 8 x 128 traced for rank 0
               of a 1 x 1 mesh over meta tensors; its matmul FLOPs equal to
               FlopCounterMode's count of the same step on the card, its
               arguments + temporaries within 0.75-1.33x of the step's
               max_memory_allocated; then ``python -m
               repro_torch.launch.dryrun --arch whisper-tiny --shape
               decode_32k`` (16 x 16, full width) exits 0 and its record
               is read back.
19. train_mesh -- meshed training, ranks sharing the card over gloo:
               full-width tinyllama-1.1b through launch.train.run(mesh=)
               at 1x2 and 2x2 (B 8 x 128, 3 steps, seed 0; tensor parallel
               over model, data parallel over data, ZeRO-1 moments): every
               rank's losses, grad norms and gradient leaf norms the same,
               rank 0's held to a one-card run of the same flags (losses
               5e-4, grad norms 5e-3, each leaf's norm 2e-2 relative, every
               step); each rank's param, gradient and moment bytes equal to
               its share by the placement's specs, and that share 0.5
               (1x2) or 0.375 (2x2) of the whole state; max_memory_allocated
               per rank and rank 0's median step.  The 2x2 run writes one
               whole-leaf checkpoint after step 3 (8 layers, TAIL_CUTS), and
               a 1x2 mesh (``elastic.replan_mesh`` of two ranks) resumes it
               for step 4, held to the one-card run's; rank 0's gather
               time and host peak RSS, each restore's time and card peak.
               Every meshed step's loss is the vocab-parallel cross
               entropy (``shardlib.vocab_nll``: the rank's vocabulary
               columns, never gathered).  The 1x2 spawn also runs the
               reference's production layouts: 2 steps at B 8 x 128 under
               sequence parallelism (``seq_sp``), held to the one-card run
               with the same limits; and ``api.decode_step`` over a
               contiguous cache of B 8 x 4096 positions cut along its
               sequence over "model" (``cache_seq``, decode_32k's rule)
               after a 3000-token prefill, 8 steps teacher-forced, with a
               bf16, an int8 and an e4m3 cache, each call's logits within
               PATH_RTOL of the same run unsharded and within LAYOUT_SEQ_RTOL
               of the run on the same mesh with ``cache_seq`` off, the
               prompt's slots bit-equal to that run's cache after every
               step, a rank holding half the slots and bytes (its seconds
               logged); one more step with the ranks' partial outputs left
               unsummed must read past LAYOUT_SEQ_RTOL.
               Then the train CLI under torchrun at the smoke size
               (--nproc-per-node 2 --mesh host --share-card, 2 steps), its
               losses held to a one-card run's.
20. train_mesh_families -- the other families on a training mesh, ranks
               sharing the card over gloo: granite-moe-1b-a400m (8
               layers), recurrentgemma-2b (13), xlstm-350m (12), whisper-
               tiny (1500 frames) and internvl2-2b (12; DEPTH_CUTS) at
               full width
               through launch.train.run(mesh=) at 1x2 (one spawn for the
               five), granite-moe also at 2x2 (two replicas of 512 tokens
               beside its 32 experts split over model), each with its
               train phase batch and sequence for 2 steps, held to the
               train phase's one-card run of the same flags with the
               train_mesh limits (losses 5e-4, grad norms 5e-3, each
               gradient leaf's norm 2e-2, every step); granite's dropped
               assignments step by step equal to one card's, or at most 2
               apart for each assignment whose expert choice flipped in
               the bf16 router; each rank's param, gradient and moment
               bytes equal to its placement's share (logged with the
               fraction of the whole state and max_memory_allocated); each
               family's whole state (16 bytes a param) reckoned against
               the card first.  qwen2-moe-a2.7b is not run: 121 GB a rank
               at 1x2.
21. summary -- one JSON line of per-kernel numbers, then the result line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense, 700 W): the bound of each kernel is the larger
# of bytes over the memory rate and operations over the rate of their type:
# the bf16 tensor cores for B1-B3 and B5, fp32 on the CUDA cores for B7
# (it must not run in TF32), and for B8's int16 MACs the int8 tensor rate
# over 4 (an int16 product is four int8 partial products: hi/lo bytes).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
INT16_MAC_OPS = 1979e12 / 4

# Kernel vs plain version: both accumulate in fp32 and round to bf16 at
# the output, in a different order, so outputs differ by about one bf16 ulp
# (2^-8 relative).  Held to max |kernel - plain| <= KERNEL_RTOL * max |plain|.
KERNEL_RTOL = 1e-2
# Whole path: those one-ulp differences enter the residual stream of every
# layer and compound over 22 layers; held to max |dlogit| <= PATH_RTOL *
# max |logit| at every teacher-forced step.
PATH_RTOL = 5e-2
# the longest prompt of the long-prefill phase (prompt + 16 new = 2048)
LONG_M = 2032
# draft tokens a tick of the spec phase: its verify step runs B3 at T = 5
# (40 rows per KV head) and B1, B2, B5 at M = 8 * 5
SPEC_K = 4
WHISPER, INTERNVL = "whisper-tiny", "internvl2-2b"
# whisper-tiny's pool: the null page, and for each of the 8 requests 4
# decoder pages (40 + 16 tokens) and 94 frame pages (1500 frames).  The
# CLI's own sizing leaves the frame pages out, as the reference's does
# (ROADMAP C5): such a pool admits no request at full width
WHISPER_POOL = 1 + 8 * (4 + 94)
# internvl2-2b's sequences: 256 patches + 40 prompt + 16 new tokens
INTERNVL_MAX_LEN = 320
# internvl2-2b's long prompt: 256 patches + 1776 tokens = LONG_M positions
INTERNVL_LONG = LONG_M - 256
# B1 and B2 switch from the decode regime (one 64-row tile, a cluster split)
# to the prefill regime (128-row tiles) above 64 rows: the rows each regime
# and tile edge meet, besides the main path's decode batches and prompts
M_EDGES = (1, 63, 64, 65, 127, 128, 129)
# the 2032-token prefill on the card's clock before B1/B2 ran on wgmma
# (NVIDIA H100 80GB HBM3, 700 W; fp32 CUDA-core B1/B2 with 16-row tiles)
LONG_PREFILL_MS_BEFORE = 117.722
# the logit softcap the capped runs set on a config (none of the registry
# sets one): cap * tanh(score / cap) on attention scores and final logits.
# A capped kernel row scales its queries by CAP_Q_SCALE, so that its scaled
# scores (std ~20) reach past the cap and the tanh bends them
SOFTCAP = 30.0
CAP_Q_SCALE = 20.0
# the analysis phase: the dry run's memory peak (arguments + temporaries) is
# held to max_memory_allocated of the same step on the card within this band
ANALYSIS_PEAK_BAND = (0.75, 1.33)
# B5/B7 in fp32: kernel and plain version both sum in fp32, in another
# order, over K <= 2048; held to max |kernel - plain| <= FP32_RTOL * max
# |plain|.  B8 is integer arithmetic: exact equality, no tolerance.
FP32_RTOL = 1e-4

KERNEL_META = {
    "block_sparse_matmul": ("src/repro_torch/csrc/block_sparse.cu",
                            "src/repro/kernels/block_sparse.py:221"),
    "block_sparse_matmul_col": ("src/repro_torch/csrc/block_sparse_col.cu",
                                "src/repro/kernels/block_sparse.py:84"),
    "fused_gate_up": ("src/repro_torch/csrc/fused_gate_up.cu",
                      "src/repro/kernels/fused_gate_up.py:91"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/flash_attention.py:273"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:105"),
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:59"),
    "batched_ffn": ("src/repro_torch/csrc/batched_ffn.cu",
                    "src/repro/kernels/batched_ffn.py:66"),
    "q78_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                   "src/repro/kernels/quant_matmul.py:122"),
}
# the tolerance each kernel's max_rel_err is held to (None: exact)
KERNEL_TOL = {"block_sparse_matmul": KERNEL_RTOL, "block_sparse_matmul_col": KERNEL_RTOL,
              "fused_gate_up": KERNEL_RTOL,
              "paged_decode_attention": KERNEL_RTOL, "flash_attention": KERNEL_RTOL,
              "quant_matmul": KERNEL_RTOL,
              "batched_ffn": FP32_RTOL, "q78_matmul": None}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def token_digest(tokens) -> str:
    """A short digest of a nested list of greedy tokens, to compare two runs
    (two trees, or two kernels) by their logs."""
    return hashlib.sha256(json.dumps(tokens).encode()).hexdigest()[:16]


def bound(nbytes: float, ops: float, rate: float = BF16_FLOPS) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median device time of single launches, each after an L2 flush (the
    main path streams its weights cold: 50 MB of L2 hold none of them).
    A spin kernel queued before the start event keeps the card busy while
    the host enqueues the call, so the events bracket device work only,
    not the wrapper's Python."""

    SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's clocks

    def __init__(self, torch, reps: int = 25, spin_cycles: int = SPIN_CYCLES):
        self.torch = torch
        self.reps = reps
        self.spin_cycles = spin_cycles
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.spin_cycles)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_ms(torch, fn, key: str, flush=None, reps: int = 25):
    """Median device time (ms) of the kernels named ``key`` that ``reps``
    calls of ``fn`` launch, from torch.profiler (CUPTI): the kernel's own
    time, without the CUDA events' floor.  ``flush`` (a uint8 tensor) is
    zeroed before each call, as Timer does; None keeps L2 warm.  None when
    the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if key in e.name and e.time_range.elapsed_us() > 0]
    return statistics.median(times) / 1e3 if times else None


def rel_err(torch, got, want) -> tuple:
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi.splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    out = build.build()
    log(f"build: {time.perf_counter() - t0:.1f}s wall for {len(out)} kernels "
        + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in out.items()))
    for name, info in out.items():
        regs = sorted(set(re.findall(r"Used (\d+) registers", info["log"])), key=int)
        spill = max(map(int, re.findall(r"(\d+) bytes spill stores", info["log"])), default=0)
        stack = max(map(int, re.findall(r"(\d+) bytes stack frame", info["log"])), default=0)
        log(f"ptxas {name}: registers per thread {', '.join(regs)}; "
            f"largest spill {spill} bytes, largest stack frame {stack} bytes")


def _packed(torch, K, N, gen, q=0.5):
    from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse

    w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
    return pack_block_sparse(w, PlanConfig(q_prune=q), quant=True)


def _dense_bf16(torch, p):
    """The dequantized dense weight of a packed leaf (library yardstick)."""
    from repro_torch.core.sparse_format import block_sparse_to_dense

    w = block_sparse_to_dense(p.to_block_sparse()) * p.scales[None, :]
    return w.to(torch.bfloat16)


def _b4_edges(torch, gen) -> None:
    """B4 off the served pair: an fp32 payload (--compress block_sparse)
    under bf16 and fp32 x, fp32 x on an int8 payload, and a weight whose
    second block-column keeps no block (its outputs must be zeros)."""
    from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse
    from repro_torch.kernels import block_sparse as BS

    K, N = 2048, 2048
    w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
    w[:, 128:256] = 0.0
    for quant in (False, True):
        p = pack_block_sparse(w, PlanConfig(q_prune=0.5), quant=quant)
        if int(p.counts[1]) != 0:
            raise AssertionError("B4 edge case: block-column 1 kept a block")
        args = (p.blocks, p.block_rows, p.counts, p.scales)
        for M, dt in ((8, torch.bfloat16), (37, torch.float32), (100, torch.bfloat16)):
            x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            y = BS.block_sparse_matmul_col(x, *args)
            tol = FP32_RTOL if dt == torch.float32 else KERNEL_RTOL
            _held(torch, f"B4 {'int8' if quant else 'fp32'} payload, {dt} x, M={M}", y,
                  BS.block_sparse_matmul_col(x, *args, use_kernel=False), tol)
            if not bool((y[:, 128:256] == 0).all()):
                raise AssertionError("B4 wrote nonzero outputs for a column with no block")


def _deterministic(torch, label: str, first, second) -> None:
    """Two launches on the same operands must give the same bits (B1 and
    B2 sum in a fixed order: no float atomics)."""
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError(f"{label}: two launches on the same operands differ")
    log(f"{label}: two launches bit for bit equal")


def _host_cost(torch, gen) -> None:
    """The host's time per call of the B1 and B4 wrappers at decode (wq,
    M = 8): B1 also encodes a TMA tensor map for x and picks its regime on
    every call.  Host clock over 200 back-to-back calls; the card finishes
    each call faster than the host issues the next."""
    from repro_torch.kernels import block_sparse as BS

    p = _packed(torch, 2048, 2048, gen)
    x = torch.randn((8, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    args = (p.blocks, p.block_rows, p.counts, p.scales)
    for name, fn in (("B1", BS.block_sparse_matmul), ("B4", BS.block_sparse_matmul_col)):
        for _ in range(20):
            fn(x, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(x, *args)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        log(f"host cost of one {name} call (wq, M=8): {host_us:.2f} us")


def phase_kernels(torch, results: dict) -> None:
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_gate_up as FG

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # B1 and B4 at every K x N of one tinyllama layer (wq, wk, wv, wo,
    # w_down) at M = 8 and 12 (decode batches), 37 (a ragged prefill), 40
    # (the serve phase's prefill), 2032 (the longest prefill of the long
    # phase) and the regime edges M_EDGES, each against its plain version
    # and B4 also against B1, bit for bit (the same column body in the same
    # regime); B1 launched twice at M = 8 and 2032 must give
    # the same bits; timed at M = 8 (the summary line) and at M = 2032,
    # beside the plain version and torch.matmul on the dequantized weight
    shapes = {"wq": (2048, 2048), "wk": (2048, 256), "wv": (2048, 256),
              "wo": (2048, 2048), "w_down": (5632, 2048)}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bytes", "flops")
    sums = {(b, M): dict.fromkeys(keys, 0.0) for b in ("B1", "B4") for M in (8, LONG_M)}
    err = {"B1": [0.0, 0.0], "B4": [0.0, 0.0]}
    kern = {"B1": BS.block_sparse_matmul, "B4": BS.block_sparse_matmul_col}
    for name, (K, N) in shapes.items():
        p = _packed(torch, K, N, gen)
        wd = _dense_bf16(torch, p)
        args = (p.blocks, p.block_rows, p.counts, p.scales)
        for M in sorted((8, 12, 37, 40, LONG_M) + M_EDGES):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            ref = BS.block_sparse_matmul(x, *args, use_kernel=False)
            ys = {b: f(x, *args) for b, f in kern.items()}
            if M in (8, LONG_M):
                _deterministic(torch, f"B1 {name} M={M}", ys["B1"], kern["B1"](x, *args))
            for b, y in ys.items():
                d, r = _held(torch, f"{b} {name} {K}x{N} M={M}", y, ref, KERNEL_RTOL)
                err[b] = [max(err[b][0], d), max(err[b][1], r)]
            _held(torch, f"B4 {name} M={M} vs B1", ys["B4"], ys["B1"], None)
            if M not in (8, LONG_M):
                continue
            surv = int(p.counts.sum())
            nbytes = (M * K * 2 + surv * 128 * 128 + surv * 4 + p.counts.numel() * 4
                      + N * 4 + M * N * 2)
            flops = 2.0 * M * surv * 128 * 128
            b_ms, _ = bound(nbytes, flops)
            lib_ms = timer(lambda: torch.matmul(x, wd))
            for b, f in kern.items():
                ms = timer(lambda: f(x, *args))
                plain_ms = timer(lambda: f(x, *args, use_kernel=False))
                log(f"{b} {name} M={M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"torch.matmul(dense bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                    f"({surv} of {(K // 128) * (N // 128)} blocks)")
                for k, v in zip(keys, (ms, plain_ms, b_ms, lib_ms, nbytes, flops)):
                    sums[b, M][k] += v
    for M in (8, LONG_M):
        t1, t4 = sums["B1", M], sums["B4", M]
        log(f"one layer's five at M={M}: B4 {t4['ms']:.4f} ms, B1 {t1['ms']:.4f} ms, plain "
            f"{t4['plain_ms']:.4f} / {t1['plain_ms']:.4f} ms, torch.matmul "
            f"{t4['library_ms']:.4f} ms, bound {bound(t4['bytes'], t4['flops'])[0]:.4f} ms "
            f"({bound(t4['bytes'], t4['flops'])[1]})")
    _b4_edges(torch, gen)
    _host_cost(torch, gen)
    for b, fn in kern.items():
        t = sums[b, 8]
        results[fn.__name__] = {
            "max_abs_err": err[b][0], "max_rel_err": err[b][1],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": bound(t["bytes"], t["flops"])[1],
            "shape": "sum of one layer's wq, wk, wv, wo, w_down at M=8"}

    # B2: gate/up 2048 x 5632 at M = 2032 and 40 (prefill), the regime
    # edges, then M = 8 (decode); launched twice at M = 2032 and 8 (the
    # same bits); timed at M = 2032 and at M = 8 (the summary line)
    K, N = 2048, 5632
    g, u = _packed(torch, K, N, gen), _packed(torch, K, N, gen)
    wgu = torch.cat([_dense_bf16(torch, g), _dense_bf16(torch, u)], dim=1)
    ga, ua = (g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts)
    b2_err = b2_rel = 0.0
    surv = int(g.counts.sum() + u.counts.sum())
    for M in (LONG_M, 40, *M_EDGES, 8):
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        y = FG.fused_gate_up(x, ga, ua, g.scales, u.scales)
        ref = FG.fused_gate_up(x, ga, ua, g.scales, u.scales, use_kernel=False)
        if M in (8, LONG_M):
            _deterministic(torch, f"B2 M={M}", y, FG.fused_gate_up(x, ga, ua, g.scales, u.scales))
        torch.cuda.synchronize()
        diff, rel = rel_err(torch, y, ref)
        log(f"B2 {K}x{N} M={M}: max|diff| {diff:.3e} rel {rel:.3e}")
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"B2 M={M}: rel err {rel:.3e} > {KERNEL_RTOL}")
        b2_err, b2_rel = max(b2_err, diff), max(b2_rel, rel)
        if M == LONG_M:
            nbytes = (M * K * 2 + surv * (128 * 128 + 4) + 2 * (N // 128) * 4 + 2 * N * 4
                      + M * N * 2)
            b_ms, b_by = bound(nbytes, 2.0 * M * surv * 128 * 128)
            ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales))
            plain_ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales,
                                                      use_kernel=False))
            lib_ms = timer(lambda: torch.matmul(x, wgu))
            log(f"B2 M={M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul(dense "
                f"[Wg|Wu] bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    nbytes = M * K * 2 + surv * (128 * 128 + 4) + 2 * (N // 128) * 4 + 2 * N * 4 + M * N * 2
    b_ms, b_by = bound(nbytes, 2.0 * M * surv * 128 * 128)
    ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales))
    plain_ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales, use_kernel=False))
    lib_ms = timer(lambda: torch.matmul(x, wgu))
    log(f"B2 M=8: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul(dense "
        f"[Wg|Wu] bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms")
    results["fused_gate_up"] = {
        "max_abs_err": b2_err, "max_rel_err": b2_rel, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms, "shape": "2048x5632 gate+up at M=8"}

    # B3: B = 8 sequences, 32 heads over 4 KV heads (G = 8), hd 64, 16-token
    # pages, 8 pages per sequence; positions straddle page boundaries and
    # sequences 1-3 read sequence 0's first physical page (a shared prefix)
    B, H, KVH, hd, ps, P = 8, 32, 4, 64, 16, 8
    num_pages = 1 + B * P
    pos = torch.tensor([15, 16, 17, 31, 32, 47, 63, 100], dtype=torch.int32, device="cuda")
    table = (1 + torch.randperm(B * P, generator=gen, device="cuda")).reshape(B, P)
    table[1:4, 0] = table[0, 0]
    table = table.to(torch.int32).contiguous()
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    b3_err = b3_rel = 0.0
    for kv in ("int8", "bf16"):
        if kv == "int8":
            kp = torch.randint(-127, 128, (num_pages, ps, KVH, hd), generator=gen,
                               device="cuda", dtype=torch.int8)
            vp = torch.randint(-127, 128, kp.shape, generator=gen, device="cuda",
                               dtype=torch.int8)
            ks = torch.rand((num_pages, ps, KVH), generator=gen, device="cuda") * 0.02 + 0.005
            vs = torch.rand(ks.shape, generator=gen, device="cuda") * 0.02 + 0.005
            elem, scale_bytes = 1, 4
        else:
            kp = torch.randn((num_pages, ps, KVH, hd), generator=gen,
                             device="cuda").to(torch.bfloat16)
            vp = torch.randn(kp.shape, generator=gen, device="cuda").to(torch.bfloat16)
            ks = vs = None
            elem, scale_bytes = 2, 0
        kw = dict(k_scale_pages=ks, v_scale_pages=vs)
        o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
        ref = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
        _deterministic(torch, f"B3 {kv} pools", o,
                       FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
        diff, rel = rel_err(torch, o, ref)
        log(f"B3 {kv} pools: max|diff| {diff:.3e} rel {rel:.3e}")
        if not rel <= KERNEL_RTOL:
            raise AssertionError(f"B3 {kv}: rel err {rel:.3e} > {KERNEL_RTOL}")
        b3_err, b3_rel = max(b3_err, diff), max(b3_rel, rel)
        if kv != "int8":
            continue
        b_ms, b_by = _b3_bound(q, table, pos, ps, KVH, hd, H, elem, scale_bytes)
        ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
        plain_ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos,
                                                           use_kernel=False, **kw))
        lib_ms = timer(_sdpa_gathered(torch, q, kp, vp, ks, vs, table, pos))
        log(f"B3 int8 B=8: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA(gathered bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms")
        results["paged_decode_attention"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "shape": "B=8 T=1 H=32 KVH=4 hd=64 int8 pages of 16, pos 15..100"}
    rows, d, r = b3_long_rows(torch, timer, gen)
    row, dv, rv = b3_verify_row(torch, timer, gen)
    results["paged_decode_attention"].update(max_abs_err=max(b3_err, d, dv),
                                             max_rel_err=max(b3_rel, r, rv), rows=rows + [row])
    # B3 capped, at the serve step and the verify step of tinyllama's
    # attention (the softcap phase serves a capped model: its launches)
    for key, T in (("cap30 serve", 1), ("cap30 verify", SPEC_K + 1)):
        _b3_row(torch, timer, gen, results, key, 32, 4, 64, T, softcap=SOFTCAP)


def _gathered_bf16(torch, kp, vp, ks, vs, table) -> tuple:
    """Each sequence's pages gathered and dequantized to bf16 K and V (B,
    S, KVH, hd); ``ks``/``vs`` None: bf16 pages, no scales."""
    from repro_torch.models import layers as L

    kd, vd = L.gather_pages(kp, table).float(), L.gather_pages(vp, table).float()
    if ks is not None:
        kd = kd * L.gather_pages(ks, table)[..., None]
        vd = vd * L.gather_pages(vs, table)[..., None]
    return kd.to(torch.bfloat16), vd.to(torch.bfloat16)


def _sdpa_gathered(torch, q, kp, vp, ks, vs, table, pos):
    """B3's yardstick: scaled_dot_product_attention on the gathered,
    dequantized bf16 K/V (expanded to the query heads) under the causal
    mask of the T new tokens at pos .. pos + T - 1; returns a thunk for the
    timer.  ``ks``/``vs`` None: bf16 pages, no scales."""
    T, H, KVH = q.shape[1], q.shape[2], kp.shape[2]
    kd, vd = _gathered_bf16(torch, kp, vp, ks, vs, table)
    kd = kd.repeat_interleave(H // KVH, dim=2).transpose(1, 2)
    vd = vd.repeat_interleave(H // KVH, dim=2).transpose(1, 2)
    S = kd.shape[2]
    q_pos = pos[:, None] + torch.arange(T, device="cuda")[None]
    mask = (torch.arange(S, device="cuda")[None, None, :] <= q_pos[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kd, vd, attn_mask=mask)


def _flex_capped(torch, q, k, v, cap: float, q_pos=None, window=None):
    """The capped attention's yardstick: one ``flex_attention`` call (eager:
    SDPA has no softcap) whose score_mod caps each scaled score and masks it
    causally (query i of row b at q_pos[b] + i, or at i) and under
    ``window``; q (B, Sq, H, hd), k/v (B, Sk, KVH, hd) bf16.  Returns a
    thunk (B, Sq, H, hd)."""
    from torch.nn.attention.flex_attention import flex_attention

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    base = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device) if q_pos is None \
        else q_pos

    def score_mod(score, b, h, q_idx, kv_idx):
        qp = base[b] + q_idx
        keep = kv_idx <= qp
        if window:
            keep = keep & (kv_idx > qp - window)
        return torch.where(keep, cap * torch.tanh(score / cap), -float("inf"))

    return lambda: flex_attention(qt, kt, vt, score_mod=score_mod,
                                  enable_gqa=True).transpose(1, 2)


def _b3_bound(q, table, pos, ps, KVH, hd, H, elem=1, scale_bytes=4) -> tuple:
    """B3's least time: the live (page, KV head) tiles' K and V payload and
    scales (read once for all T query positions), q and o, the table and
    pos over the memory rate; 4 * hd flops per (query head, visible key) on
    the bf16 tensor cores."""
    T = q.shape[1]
    n_pages = ((pos + T - 1) // ps + 1).clamp(max=table.shape[1])
    tiles = int(n_pages.sum()) * KVH
    nbytes = (tiles * ps * (2 * hd * elem + 2 * scale_bytes) + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + pos.numel() * 4)
    visible = T * int((pos + 1).sum()) + pos.numel() * T * (T - 1) // 2
    return bound(nbytes, 4.0 * visible * H * hd)


def _b3_case(torch, gen, ctx, P: int) -> tuple:
    """One B3 call at tinyllama-1.1b's attention (32 query heads over 4 KV
    heads, hd 64, int8 pages of 16): a sequence per context in ``ctx`` (one
    new token each, after ctx - 1 cached ones), ``P`` pages per sequence in
    a shuffled table.  Returns (q, k_pages, v_pages, table, pos, scales)."""
    B, H, KVH, hd, ps = len(ctx), 32, 4, 64, 16
    pos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32, device="cuda")
    table = (1 + torch.randperm(B * P, generator=gen, device="cuda")).reshape(B, P)
    table = table.to(torch.int32).contiguous()
    shape = (1 + B * P, ps, KVH, hd)
    kp = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    vp = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand(shape[:3], generator=gen, device="cuda") * 0.02 + 0.005
    vs = torch.rand(shape[:3], generator=gen, device="cuda") * 0.02 + 0.005
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    return q, kp, vp, table, pos, dict(k_scale_pages=ks, v_scale_pages=vs)


# the long phase's contexts (its prompts of 40-2032 tokens, each followed by
# the first new token), at its batch of 4 and at the serve batch of 8
B3_LONG_CONTEXTS = (40, 1100, 1536, LONG_M)


def b3_long_rows(torch, timer, gen) -> tuple:
    """B3 at long contexts: B = 4 and 8 sequences (32 query heads over 4 KV
    heads, hd 64, int8 pages of 16, 128 pages per sequence), one new token
    each at the contexts of B3_LONG_CONTEXTS; each held to its plain version,
    launched twice for the same bits, timed with SDPA on gathered bf16 as
    the yardstick.  Only the kernel's Python signature is used.  Returns
    (rows, max abs err, max rel err)."""
    from repro_torch.kernels import flash_attention as FA

    H, KVH, hd, ps = 32, 4, 64, 16
    rows, err, rel = [], 0.0, 0.0
    for B in (4, 8):
        ctx = B3_LONG_CONTEXTS * (B // len(B3_LONG_CONTEXTS))
        q, kp, vp, table, pos, kw = _b3_case(torch, gen, ctx, 128)
        ks, vs = kw["k_scale_pages"], kw["v_scale_pages"]
        label = f"B3 int8 B={B} contexts {','.join(map(str, ctx))}"
        o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
        d, r = _held(torch, label, o,
                     FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw),
                     KERNEL_RTOL)
        err, rel = max(err, d), max(rel, r)
        _deterministic(torch, label, o, FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
        b_ms, b_by = _b3_bound(q, table, pos, ps, KVH, hd, H)
        ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
        plain_ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos,
                                                           use_kernel=False, **kw))
        lib_ms = timer(_sdpa_gathered(torch, q, kp, vp, ks, vs, table, pos))
        log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA(gathered bf16) "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows.append({"shape": f"B={B} T=1 H=32 KVH=4 hd=64 int8 pages of 16, contexts "
                              f"{'/'.join(map(str, B3_LONG_CONTEXTS))}",
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    return rows, err, rel


def b3_verify_row(torch, timer, gen) -> tuple:
    """B3 at the spec phase's verify step: B = 8 sequences, T = SPEC_K + 1
    query positions each (40 rows per KV head at G = 8), 32 query heads over
    4 KV heads, hd 64, int8 pages of 16, 8 pages per sequence, at the serve
    phase's contexts (prompts of 36-40 tokens, 8 tokens into generation);
    sequences 1-3 share sequence 0's first page.  Held to its plain version,
    launched twice for the same bits, timed with SDPA on gathered bf16 as
    the yardstick.  Returns (row, max abs err, max rel err)."""
    from repro_torch.kernels import flash_attention as FA

    B, T, H, KVH, hd, ps, P = 8, SPEC_K + 1, 32, 4, 64, 16, 8
    ctx = (36, 40, 40, 40, 40, 40, 40, 40)
    q, kp, vp, table, pos, kw = _b3_case(torch, gen, [c + 8 for c in ctx], P)
    table[1:4, 0] = table[0, 0]
    q = torch.randn((B, T, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    label = f"B3 int8 verify B={B} T={T} pos {pos.tolist()}"
    o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    d, r = _held(torch, label, o,
                 FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw),
                 KERNEL_RTOL)
    _deterministic(torch, label, o, FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
    b_ms, b_by = _b3_bound(q, table, pos, ps, KVH, hd, H)
    ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
    plain_ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos,
                                                       use_kernel=False, **kw))
    lib_ms = timer(_sdpa_gathered(torch, q, kp, vp, kw["k_scale_pages"], kw["v_scale_pages"],
                                  table, pos))
    log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA(gathered bf16) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    row = {"shape": f"verify B={B} T={T} H=32 KVH=4 hd=64 int8 pages of 16, pos "
                    f"{'/'.join(map(str, pos.tolist()))}",
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by}
    return row, d, r


def _visible_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs a flash attention call scores: key j is visible
    to query i if j < Sk, j <= i when causal, and j > i - window."""
    n = 0
    for i in range(Sq):
        hi = min(Sk, i + 1) if causal else Sk
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


# B6's bf16 kernel (128 folded rows per CTA in two 64-row warpgroups,
# 128-key tiles): lengths around those edges and the long prefills, at G =
# 8, 1 and 4, so that the 128-row tile cuts positions at different places
B6_LENGTHS = (1, 63, 64, 65, 127, 129, 1100, 2048)
B6_HEADS = ((32, 4), (8, 8), (16, 4))


def _flash_operands(torch, gen, B: int, S: int, H: int, KVH: int, int8: bool) -> tuple:
    """q, k, v, k_scale, v_scale of one B6 call (hd 64), random from ``gen``."""
    hd = 64
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    if not int8:
        k = torch.randn((B, S, KVH, hd), generator=gen, device="cuda").to(torch.bfloat16)
        return q, k, torch.randn(k.shape, generator=gen, device="cuda").to(torch.bfloat16), \
            None, None
    k = torch.randint(-127, 128, (B, S, KVH, hd), generator=gen, device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, k.shape, generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((B, S, KVH), generator=gen, device="cuda") * 0.02 + 0.002
    vs = torch.rand((B, S, KVH), generator=gen, device="cuda") * 0.02 + 0.002
    return q, k, v, ks, vs


def phase_flash(torch, results: dict) -> None:
    """B6 against its plain version: the bf16 kernel at B6_LENGTHS x
    B6_HEADS for two sequences, causal and not, and under a 256-token
    window; then at tinyllama-1.1b's long prefill (32 query heads over 4 KV
    heads, hd 64): a 2048-token causal bf16 prefill (launched twice for the
    same bits, timed with SDPA as the yardstick) and an 1100-token one over
    int8 K/V (the first port's kernel, timed)."""
    from repro_torch.kernels import flash_attention as FA

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    err = rel = 0.0

    def check(label, q, k, v, **kw):
        nonlocal err, rel
        got = FA.flash_attention(q, k, v, **kw)
        d, r = _held(torch, label, got, FA.flash_attention(q, k, v, use_kernel=False, **kw),
                     KERNEL_RTOL)
        err, rel = max(err, d), max(rel, r)
        return got

    for H, KVH in B6_HEADS:
        for S in B6_LENGTHS:
            q, k, v, _, _ = _flash_operands(torch, gen, 2, S, H, KVH, False)
            for causal in (True, False):
                check(f"B6 bf16 B=2 S={S} H={H}/{KVH} causal={causal}", q, k, v, causal=causal)
            if S > 128:
                check(f"B6 bf16 B=2 S={S} H={H}/{KVH} window 256", q, k, v, causal=True,
                      window=256)

    S, H, KVH, hd = 2048, 32, 4, 64
    q, k, v, _, _ = _flash_operands(torch, gen, 1, S, H, KVH, False)
    first = check(f"B6 S={S} causal bf16", q, k, v)
    _deterministic(torch, f"B6 S={S} causal bf16", first, FA.flash_attention(q, k, v))
    # bound: q, k, v read once and o written once; 4 * hd flops (QK^T and
    # PV) per visible (query head, key) pair, on the bf16 tensor cores
    nbytes = 2 * (q.numel() * 2 + k.numel() * 2)
    flops = 4.0 * hd * H * _visible_pairs(S, S, True, None)
    b_ms, b_by = bound(nbytes, flops)
    ms = timer(lambda: FA.flash_attention(q, k, v))
    plain_ms = timer(lambda: FA.flash_attention(q, k, v, use_kernel=False))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    log(f"B6 S={S} causal bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA(is_causal, enable_gqa) {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
    results["flash_attention"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "shape": "B=1 S=2048 H=32 KVH=4 hd=64 causal bf16"}
    # where the time goes: the same grid against one key (each CTA streams
    # one key tile: the cost of its CTAs, the loop aside), and the long
    # phase's 1100-token prefill
    one = (k[:, :1].contiguous(), v[:, :1].contiguous())
    fixed_ms = timer(lambda: FA.flash_attention(q, *one))
    q11, k11, v11 = q[:, :1100].contiguous(), k[:, :1100].contiguous(), v[:, :1100].contiguous()
    ms_1100 = timer(lambda: FA.flash_attention(q11, k11, v11))
    lib_1100 = timer(lambda: sdpa(q11.transpose(1, 2), k11.transpose(1, 2), v11.transpose(1, 2),
                                  is_causal=True, enable_gqa=True))
    log(f"B6 S={S} against one key: {fixed_ms:.4f} ms; S=1100 causal bf16: kernel "
        f"{ms_1100:.4f} ms, SDPA {lib_1100:.4f} ms")

    S = 1100
    q, k, v, ks, vs = _flash_operands(torch, gen, 1, S, H, KVH, True)
    kw = dict(k_scale=ks, v_scale=vs)
    check(f"B6 S={S} causal int8 K/V", q, k, v, **kw)
    i8_ms = timer(lambda: FA.flash_attention(q, k, v, **kw))
    log(f"B6 S={S} causal int8 K/V: kernel {i8_ms:.4f} ms")
    results["flash_attention"].update(max_abs_err=err, max_rel_err=rel)
    # B6 capped at 2048 tokens: tinyllama's hd 64, glm4's hd 128 (32/2),
    # gemma3's hd 256 (8/4) causal and under its 1024-token window; the
    # softcap phase and the families' capped prefills launch their shapes
    for key, H, KVH, hd, window in (("cap30 hd64", 32, 4, 64, None),
                                    ("cap30 hd128", 32, 2, 128, None),
                                    ("cap30 hd256", 8, 4, 256, None),
                                    ("cap30 hd256 window", 8, 4, 256, 1024)):
        _b6_row(torch, timer, gen, results, key, H, KVH, hd, window=window, softcap=SOFTCAP)


def _held(torch, label: str, got, want, tol) -> tuple:
    """max |got - want| and its share of max |want|; raises unless within
    ``tol`` (None: the two must be equal)."""
    diff, rel = rel_err(torch, got, want)
    log(f"{label}: max|diff| {diff:.3e} rel {rel:.3e}")
    ok = bool(torch.equal(got, want)) if tol is None else rel <= tol
    if not ok:
        raise AssertionError(f"{label}: kernel differs from its plain version (rel {rel:.3e}, "
                             f"tolerance {'exact' if tol is None else tol})")
    return diff, rel


def phase_dense_kernels(torch, results: dict) -> None:
    """B5, B7 and B8 against their plain versions, timed at the shapes of
    their main paths: B5 at the served int8 head and a --compress quant
    leaf (``b5_rows``), B7/B8 at the FC nets' widest layer."""
    from repro_torch.kernels import batched_ffn as BF
    from repro_torch.kernels import quant_matmul as QM

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows, err, rel = b5_rows(torch, timer, gen)
    results["quant_matmul"] = {**rows[0], "max_abs_err": err, "max_rel_err": rel,
                               "rows": rows[1:]}

    # B7 and B8 at HAR-6's widest layer (2000 x 1500) at Table 2's B = 1, 16
    # and 32, at a ragged layer (561 x 300, B = 5) and at an output layer
    # (300 x 6); the 2000 x 1500 rows timed (B = 16 is the headline row)
    b7 = {"err": 0.0, "rel": 0.0, "rows": []}
    b8 = {"err": 0.0, "rows": []}
    keys = ("ms", "kernel_ms", "kernel_warm_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    clusters = BF.resident_clusters(torch.device("cuda"))
    log(f"stream: resident clusters of 1..8 CTAs on this card {list(clusters)}")
    one = torch.zeros(1, device="cuda")
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    log(f"timer floor (a one-element add_): event {timer(lambda: one.add_(1.0)):.4f} ms, "
        f"kernel only {fmt(kernel_ms(torch, lambda: one.add_(1.0), 'elementwise'))}")
    for K, N, B, act in ((2000, 1500, 1, "relu"), (2000, 1500, 16, "relu"),
                         (2000, 1500, 32, "relu"), (561, 300, 5, "relu"), (300, 6, 16, "sigmoid")):
        w = randn(K, N) * (2.0 / K) ** 0.5
        b = randn(N) * 0.1
        x = torch.rand((B, K), generator=gen, device="cuda")
        d, r = _held(torch, f"B7 {K}x{N} B={B} {act} fp32", BF.batched_ffn(x, w, b, activation=act),
                     BF.batched_ffn(x, w, b, activation=act, use_kernel=False), FP32_RTOL)
        b7["err"], b7["rel"] = max(b7["err"], d), max(b7["rel"], r)
        _deterministic(torch, f"B7 {K}x{N} B={B} fp32", BF.batched_ffn(x, w, b, activation=act),
                       BF.batched_ffn(x, w, b, activation=act))
        xb = x.to(torch.bfloat16)
        _held(torch, f"B7 {K}x{N} B={B} {act} bf16 x", BF.batched_ffn(xb, w, b, activation=act),
              BF.batched_ffn(xb, w, b, activation=act, use_kernel=False), KERNEL_RTOL)
        a_q = torch.randint(-2048, 2048, (B, K), generator=gen, device="cuda", dtype=torch.int16)
        w_q = torch.randint(-512, 512, (K, N), generator=gen, device="cuda", dtype=torch.int16)
        d8, _ = _held(torch, f"B8 {K}x{N} B={B}", QM.q78_matmul(a_q, w_q),
                      QM.q78_matmul(a_q, w_q, use_kernel=False), None)
        b8["err"] = max(b8["err"], d8)
        p7 = BF.stream_plan("fp32", B, K, N, N, w.data_ptr(), clusters)
        p8 = BF.stream_plan("q78", B, K, N, N, w_q.data_ptr(), clusters)
        log(f"B7 {K}x{N} B={B}: plan {p7._asdict()}; B8: plan {p8._asdict()}")
        if N != 1500:
            continue
        a_d, w_d = a_q.double(), w_q.double()
        f7 = lambda: BF.batched_ffn(x, w, b, activation=act)
        f8 = lambda: QM.q78_matmul(a_q, w_q)
        t7 = (timer(f7), kernel_ms(torch, f7, "batched_ffn_kernel", timer.flush),
              kernel_ms(torch, f7, "batched_ffn_kernel"),
              timer(lambda: BF.batched_ffn(x, w, b, activation=act, use_kernel=False)),
              timer(lambda: torch.relu(torch.addmm(b, x, w))),
              *bound(4 * (B * K + K * N + N + B * N), 2.0 * B * K * N, FP32_FLOPS))
        t8 = (timer(f8), kernel_ms(torch, f8, "q78_stream_kernel", timer.flush),
              kernel_ms(torch, f8, "q78_stream_kernel"),
              timer(lambda: QM.q78_matmul(a_q, w_q, use_kernel=False)),
              timer(lambda: a_q.double() @ w_q.double()),
              *bound(2 * B * K + 2 * K * N + 4 * B * N, 2.0 * B * K * N, INT16_MAC_OPS))
        pre = timer(lambda: a_d @ w_d)
        # a plain read of the same weight bytes under the same flush (one
        # torch.sum): the memory system's floor for this stream
        reads = (kernel_ms(torch, lambda: w.sum(), "reduce_kernel", timer.flush),
                 kernel_ms(torch, lambda: w_q.sum(), "reduce_kernel", timer.flush))
        for name, what, t in (("B7", "fp32 weight", reads[0]), ("B8", "int16 weight", reads[1])):
            log(f"{name} {K}x{N}: torch.sum over the {what} (L2 flushed) {fmt(t)} kernel only")
        for name, lib, t in (("B7", "relu(addmm) fp32", t7),
                             ("B8", "fp64 matmul with both casts", t8)):
            log(f"{name} {K}x{N} B={B}: kernel {t[0]:.4f} ms (events), {fmt(t[1])} (kernel only, "
                f"L2 flushed), {fmt(t[2])} (kernel only, L2 warm); plain {t[3]:.4f} ms, "
                f"{lib} {t[4]:.4f} ms, bound {t[5]:.4f} ms ({t[6]})")
        log(f"B8 {K}x{N} B={B}: fp64 matmul on pre-converted operands {pre:.4f} ms")
        b7["rows"].append({"shape": f"fp32 {K}x{N} at B={B}, {act}", **dict(zip(keys, t7)),
                           "weight_read_ms": reads[0]})
        b8["rows"].append({"shape": f"int16 {K}x{N} at B={B}", **dict(zip(keys, t8)),
                           "library_preconverted_ms": pre, "weight_read_ms": reads[1]})

    # B8 on saturated codes: the partial sums leave int32 within a few
    # terms, so only an accumulator that wraps modulo 2^32 matches
    a_q = torch.full((4, 3000), 32767, dtype=torch.int16, device="cuda")
    a_q[1::2] = -32768
    w_q = torch.where(torch.rand((3000, 64), generator=gen, device="cuda") < 0.5,
                      32767, -32768).to(torch.int16)
    w_q[:, 0] = 32767
    y = QM.q78_matmul(a_q, w_q)
    d8, _ = _held(torch, "B8 saturated 3000x64 B=4", y, QM.q78_matmul(a_q, w_q, use_kernel=False),
                  None)
    if int(y[0, 0]) != -196605000:  # 3000 * 32767^2 mod 2^32, as int32
        raise AssertionError(f"B8 does not wrap like int32: {int(y[0, 0])} != -196605000")
    b8["err"] = max(b8["err"], d8)
    head7 = next(r for r in b7["rows"] if "B=16" in r["shape"])
    head8 = next(r for r in b8["rows"] if "B=16" in r["shape"])
    results["batched_ffn"] = {
        "max_abs_err": b7["err"], "max_rel_err": b7["rel"], **head7,
        "rows": [r for r in b7["rows"] if r is not head7]}
    results["q78_matmul"] = {
        "max_abs_err": b8["err"], "max_rel_err": b8["err"], **head8,
        "rows": [r for r in b8["rows"] if r is not head8]}


# B5's rows: the int8 head at decode and at the serve phase's prefill, and
# a --compress quant gate/up leaf at decode, prefill and the long prefill
B5_ROWS = (((2048, 32000), (8, 40)), ((2048, 5632), (8, 40, LONG_M)))


def b5_rows(torch, timer, gen) -> tuple:
    """B5 against its plain version at B5_ROWS, bf16 activations as served:
    each call's regime logged, launched twice for the same bits, timed beside
    its plain version and torch.matmul on the dequantized bf16 weight; the
    head at M = 8 also under fp32 x (the CUDA-core regime).  Returns (rows,
    the first the head at M = 8; max abs err; max rel err)."""
    from repro_torch.core.weight_plan import quantize_leaf
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import quant_matmul as QM

    rows, err, rel = [], 0.0, 0.0
    for (K, N), Ms in B5_ROWS:
        leaf = quantize_leaf(torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5)
        wq, sc = leaf.q, leaf.s
        wd = (wq.float() * sc).to(torch.bfloat16)
        for M in Ms:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            label = f"B5 {K}x{N} M={M} bf16"
            log(f"{label}: regime {QM.regime(x.dtype, M, K, N, K, N, BS.sm_count(x.device))}")
            y = QM.quant_matmul(x, wq, sc)
            d, r = _held(torch, label, y, QM.quant_matmul(x, wq, sc, use_kernel=False),
                         KERNEL_RTOL)
            err, rel = max(err, d), max(rel, r)
            _deterministic(torch, label, y, QM.quant_matmul(x, wq, sc))
            if (N, M) == (32000, 8):
                _held(torch, f"B5 {K}x{N} M={M} fp32", QM.quant_matmul(x.float(), wq, sc),
                      QM.quant_matmul(x.float(), wq, sc, use_kernel=False), FP32_RTOL)
            b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + M * N * 2, 2.0 * M * K * N,
                               BF16_FLOPS)
            ms = timer(lambda: QM.quant_matmul(x, wq, sc))
            plain_ms = timer(lambda: QM.quant_matmul(x, wq, sc, use_kernel=False))
            lib_ms = timer(lambda: torch.matmul(x, wd))
            log(f"B5 {K}x{N} M={M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"torch.matmul(dequantized bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            rows.append({"shape": f"int8 {K}x{N}, bf16 x at M={M}", "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by})
        del wd
    return rows, err, rel


def phase_sweep(torch) -> None:
    """B1 (wq, wk, w_down) and B2 at decode batches M = 1, 8, 40 and 64
    under each regime the C entry takes -- (128, 1) and (64, split) for
    split 1..8 -- in place of the one ``launch_plan`` picks; each result is
    held to the plain version first.  What ``launch_plan``'s split rule
    rests on."""
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import fused_gate_up as FG

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    shapes = {"wq": (2048, 2048), "wk": (2048, 256), "w_down": (5632, 2048)}
    packs = {n: _packed(torch, K, N, gen) for n, (K, N) in shapes.items()}
    g, u = _packed(torch, 2048, 5632, gen), _packed(torch, 2048, 5632, gen)
    regimes = [(128, 1)] + [(64, c) for c in range(1, BS.MAX_SPLIT + 1)]
    plan, n_sm = BS.launch_plan, BS.sm_count(torch.device("cuda"))
    try:  # the wrappers take the regime from BS.launch_plan: swap it per run
        for M in (1, 8, 40, 64):
            calls = {}
            for name, (K, N) in shapes.items():
                p = packs[name]
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                args = (x, p.blocks, p.block_rows, p.counts, p.scales)
                calls[f"B1 {name}"] = (BS.block_sparse_matmul, args,
                                       plan(M, *p.block_rows.shape, n_sm))
            x = torch.randn((M, 2048), generator=gen, device="cuda").to(torch.bfloat16)
            args = (x, (g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts),
                    g.scales, u.scales)
            mb = max(g.block_rows.shape[1], u.block_rows.shape[1])
            calls["B2"] = (FG.fused_gate_up, args, plan(M, g.block_rows.shape[0], mb, n_sm))
            for label, (fn, args, chosen) in calls.items():
                ref = fn(*args, use_kernel=False)
                row = []
                for regime in regimes:
                    BS.launch_plan = lambda *a, regime=regime: regime
                    _, r = rel_err(torch, fn(*args), ref)
                    if not r <= KERNEL_RTOL:
                        raise AssertionError(f"sweep {label} M={M} {regime}: rel err {r:.3e}")
                    row.append(f"{regime[0]}/{regime[1]} {timer(lambda: fn(*args)) * 1e3:.1f}")
                log(f"sweep {label} M={M} (bm/split us; launch_plan picks "
                    f"{chosen[0]}/{chosen[1]}): " + ", ".join(row))
    finally:
        BS.launch_plan = plan


def phase_b3_sweep(torch) -> None:
    """B3 under each (split, groups) its C entry takes, in place of the pair
    ``paged_split`` and ``paged_groups`` pick, at the serve phase's decode
    (8 sequences, 8 pages each, contexts 16-101), the long phase's (4 and 8
    sequences, 128 pages, contexts 40-2032), one sequence at 2032 and four
    at 1 (the launch's fixed cost); each result held to the plain version
    first.  What the two host rules rest on; a one-element add_ gives the
    timer's floor."""
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import flash_attention as FA

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    one = torch.zeros(1, device="cuda")
    log(f"b3 sweep: the timer's floor (a one-element add_) {timer(lambda: one.add_(1.0)) * 1e3:.2f} us")
    cases = {"serve B=8": ((16, 17, 18, 32, 33, 48, 64, 101), 8),
             "long B=4": (B3_LONG_CONTEXTS, 128), "long B=8": (B3_LONG_CONTEXTS * 2, 128),
             "one at 2032": ((LONG_M,), 128), "four at 1": ((1, 1, 1, 1), 128)}
    plan = (FA.paged_split, FA.paged_groups)
    n_sm = BS.sm_count(torch.device("cuda"))
    try:  # the wrapper takes split and groups from these two: swap them per run
        for label, (ctx, P) in cases.items():
            q, kp, vp, table, pos, kw = _b3_case(torch, gen, ctx, P)
            ref = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
            split = plan[0](len(ctx), 4, P, n_sm)
            groups = plan[1](8, 64, 16, torch.int8, -(-P // split), len(ctx) * 4 * split, n_sm)
            row = []
            for sp in (1, 2, 4, 8):
                for g in (1, 2, 4):
                    FA.paged_split = lambda *a, sp=sp: sp
                    FA.paged_groups = lambda *a, g=g: g
                    _, r = rel_err(torch, FA.paged_decode_attention(q, kp, vp, table, pos, **kw),
                                   ref)
                    if not r <= KERNEL_RTOL:
                        raise AssertionError(f"b3 sweep {label} split {sp} groups {g}: rel err "
                                             f"{r:.3e}")
                    us = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
                    row.append(f"{sp}/{g} {us * 1e3:.1f}")
            log(f"b3 sweep {label} (split/groups us; the host picks {split}/{groups}): "
                + ", ".join(row))
    finally:
        FA.paged_split, FA.paged_groups = plan


def _fcnet_launches(cfg, kind: str, batch: int, m: int = 114) -> int:
    """Kernel launches of one forward: one per layer, or for the sectioned
    Q7.8 forward (one group of ``batch`` samples) one per section of m."""
    if kind == "q78_sectioned":
        return sum(-(-n // m) for n in cfg.sizes[1:])
    return len(cfg.sizes) - 1


def phase_fcnet(torch, results: dict) -> None:
    """The paper's FC nets end to end on the card (see the module doc)."""
    import numpy as np

    from repro_torch.core import quantization as Q
    from repro_torch.core.pruning import update_masks
    from repro_torch.kernels import batched_ffn as BF
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.models import fcnet as F

    rng = np.random.default_rng(0)
    nets = {}
    for name, cfg in F.PAPER_FCNETS.items():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = F.init_params(cfg, gen)
        x = torch.from_numpy(rng.random((32, cfg.sizes[0])).astype(np.float32)).cuda()
        nets[name] = (cfg, params, update_masks(params, 0.9), x)
    torch.cuda.synchronize()

    # the stream plan of every layer (B = 32): strip, split and the copy
    # width its weight's address and row stride allow (the Q7.8 codes are a
    # fresh tensor per call; sections are read in place at 228 i bytes)
    clusters = BF.resident_clusters(torch.device("cuda"))
    for name, (cfg, params, _, _) in nets.items():
        for kind in ("fp32", "q78"):
            plans = []
            for p in params:
                w = p["w"] if kind == "fp32" else Q.q78_encode(p["w"])
                K, N = w.shape
                plan = BF.stream_plan(kind, 32, K, N, w.stride(0), w.data_ptr(), clusters)
                plans.append(f"{K}x{N}: sb {plan.sb} split {plan.split} width {plan.width}")
            log(f"fcnet {name} {kind} B=32 layers: " + "; ".join(plans))

    # correctness and launch counts: the main path is run from zeroed counters
    BF.batched_ffn.launches = QM.q78_matmul.launches = 0
    widths = {"b7": dict(BF.batched_ffn.width_launches), "b8": dict(QM.q78_matmul.width_launches)}
    want = {"b7": 0, "b8": 0}
    err = rel = 0.0
    for name, (cfg, params, masks, x) in nets.items():
        for B in (4, 32):
            xb = x[:B]
            for kind, fn in (("fp32", lambda k: F.forward_fp32(cfg, params, xb, use_kernel=k)),
                             ("pruned", lambda k: F.forward_pruned(cfg, params, masks, xb,
                                                                   use_kernel=k))):
                got, ref = fn(True), fn(False)
                want["b7"] += _fcnet_launches(cfg, kind, B)
                if not (got.shape == (B, cfg.sizes[-1]) and torch.isfinite(got).all()):
                    raise AssertionError(f"fcnet {name} {kind}: bad output {tuple(got.shape)}")
                d, r = _held(torch, f"fcnet {name} {kind} B={B}", got, ref, FP32_RTOL)
                err, rel = max(err, d), max(rel, r)
            q = F.forward_q78(cfg, params, xb)
            want["b8"] += _fcnet_launches(cfg, "q78", B)
            _held(torch, f"fcnet {name} q78 B={B} vs plain path", q,
                  F.forward_q78(cfg, params, xb, use_kernel=False), None)
            sec = F.forward_q78_sectioned(cfg, params, xb, m=114, n=B)
            want["b8"] += _fcnet_launches(cfg, "q78_sectioned", B)
            _held(torch, f"fcnet {name} q78_sectioned(m=114, n={B}) vs forward_q78", sec, q, None)
    got = {"b7": BF.batched_ffn.launches, "b8": QM.q78_matmul.launches}
    log(f"fcnet: launches {got}, expected layers x forwards {want}")
    for key, fn in (("b7", BF.batched_ffn), ("b8", QM.q78_matmul)):
        by = {w: n - widths[key][w] for w, n in fn.width_launches.items()}
        log(f"fcnet: {key} launches by copy width (bytes) {by}")
        if sum(by.values()) != got[key]:
            raise AssertionError(f"fcnet {key}: width counts {by} do not add up to {got[key]}")
    if got != want:
        raise AssertionError(f"fcnet launch counts {got} != layers x forwards {want}")
    results.setdefault("batched_ffn", {})["launches"] = got["b7"]
    results.setdefault("q78_matmul", {})["launches"] = got["b8"]
    log(f"fcnet: fp32 and pruned paths within {FP32_RTOL} of the plain path "
        f"(max rel {rel:.3e}); Q7.8 paths bit-exact on all four nets")

    # where a forward's device time goes: HAR-6 at B = 32 under
    # torch.profiler, the B7 / B8 kernels against everything else
    from torch.profiler import ProfilerActivity, profile

    cfg, params, _, x = nets["har-6layer"]
    for kind, fn, key in (("fp32", lambda: F.forward_fp32(cfg, params, x), "batched_ffn_kernel"),
                          ("q78", lambda: F.forward_q78(cfg, params, x), "q78_stream_kernel")):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = _device_rows(torch, prof)
        dev = sum(r[0] for r in rows)
        ms = sum(r[0] for r in rows if key in r[2])
        n = sum(r[1] for r in rows if key in r[2])
        log(f"fcnet profile har-6layer {kind} B=32: device busy {dev:.4f} ms in "
            f"{sum(r[1] for r in rows)} kernels; {key} {ms:.4f} ms in {n} launches "
            f"({ms / dev:.3f} of device time)")
        for t, c, name in rows[:6]:
            log(f"fcnet profile:   {t:8.4f} ms  {c:4d} calls  {name[:80]}")

    # Table 2's batch sweep on this card: device ms per forward (CUDA events
    # around the forward, L2 flushed before each; a long spin kernel covers
    # the host's enqueue of the forward's ~10-30 eager ops per layer) and
    # wall ms (host clock around forward + synchronize); the Q7.8 forward
    # includes the per-call encode of the fp32 weights, as the reference's
    timer = Timer(torch, reps=15, spin_cycles=20_000_000)
    for name, (cfg, params, _, x) in nets.items():
        for B in (1, 2, 4, 8, 16, 32):
            xb = x[:B].contiguous()
            for kind, fn in (("fp32", lambda: F.forward_fp32(cfg, params, xb)),
                             ("q78", lambda: F.forward_q78(cfg, params, xb))):
                dev_ms = timer(fn)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 100.0
                log(f"fcnet sweep {name} {kind} B={B}: device {dev_ms:.4f} ms "
                    f"({dev_ms / B:.5f} ms/sample), wall {wall_ms:.4f} ms "
                    f"({wall_ms / B:.5f} ms/sample)")


def _serve_args(extra=()):
    """The serve CLI's parser and the quickstart flags (``extra`` flags
    override them)."""
    from repro_torch.launch import serve

    ap = serve.build_parser()
    args = ap.parse_args([
        "--arch", "tinyllama-1.1b", "--requests", "8", "--max-new", "16",
        "--prompt-len", "40", "--max-batch", "8", "--max-len", "128",
        "--compress", "quant_sparse", "--q-prune", "0.5", "--block", "128",
        "--kv-dtype", "int8", "--page-size", "16", "--share-prefix", *extra])
    return serve, ap, args


def _serve_requests(cfg, max_new: int) -> list:
    """The serve phase's 8 requests: requests 0-3 share a prefix (request
    0's 36-token prompt, which requests 1-3 extend: 2 full pages shared by
    refcount, the partial third page copied on write); requests 4-7 are
    independent."""
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, size=36).astype(np.int32)
    prompts = [prefix] + [np.concatenate([prefix, rng.integers(0, cfg.vocab, 4)
                                          .astype(np.int32)]) for _ in range(3)]
    prompts += [rng.integers(0, cfg.vocab, size=40).astype(np.int32) for _ in range(4)]
    return [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]


def _served_kernels():
    """The launch counters of the serving path: B1, B4, B2, B3, B5."""
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_gate_up as FG
    from repro_torch.kernels import quant_matmul as QM

    return (BS.block_sparse_matmul, BS.block_sparse_matmul_col, FG.fused_gate_up,
            FA.paged_decode_attention, QM.quant_matmul)


def _zero_launches(counters) -> None:
    """Set the launch counters of ``counters`` to 0, B5's per-regime ones,
    B1/B2/B4's stacked and FMA-body ones and B3's by query positions too."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_matmul as QM

    for c in counters:
        c.launches = 0
        if hasattr(c, "stacked_launches"):  # B1, B2, B4: a stack of experts' launches
            c.stacked_launches = c.stacked_experts = c.fma_launches = 0
    QM.quant_matmul.wgmma_launches = QM.quant_matmul.dense_tile_launches = 0
    FA.paged_decode_attention.launches_by_t.clear()
    FA.flash_attention.launches_by_window.clear()
    FA.paged_decode_attention.launches_noncausal = FA.flash_attention.launches_noncausal = 0


def _b5_all_wgmma(label: str, regime: str = "wgmma") -> None:
    """Every B5 launch since ``_zero_launches`` ran in the wgmma regime (the
    served model's int8 leaves are all TMA-addressable bf16 products), or
    every one in ``regime`` where the caller names another (internvl2-2b's
    head, whose 92553-byte rows TMA cannot address, runs ``dense_tile``);
    ``regime`` None only logs the split."""
    from repro_torch.kernels import quant_matmul as QM

    f = QM.quant_matmul
    log(f"{label}: B5 launches {f.launches}: wgmma {f.wgmma_launches}, dense_tile "
        f"{f.dense_tile_launches}")
    if regime is None:  # both regimes (xlstm-350m): the caller checks them by shape
        return
    n = f.wgmma_launches if regime == "wgmma" else f.dense_tile_launches
    if n != f.launches:
        raise AssertionError(f"{label}: a B5 launch left the {regime} regime ({n} of "
                             f"{f.launches})")


def _run_ticks(torch, engine, reqs, ticks: list) -> float:
    """Submit ``reqs`` and drive the engine's ``step()`` until every request
    is terminal, appending (seconds, prefills, decode steps) of each tick to
    ``ticks`` (host clock, the card synchronized after the tick).  Returns
    wall seconds, as ``serve.run_requests`` does."""
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize(engine.device)
    s, t_all = engine.stats, time.perf_counter()
    while not all(r.terminal for r in reqs):
        p0, d0, t0 = s.prefills, s.decode_steps, time.perf_counter()
        engine.step()
        torch.cuda.synchronize(engine.device)
        ticks.append((time.perf_counter() - t0, s.prefills - p0, s.decode_steps - d0))
    return time.perf_counter() - t_all


def _decode_tick_ms(ticks: list) -> tuple:
    """(median ms, count) of the ticks that ran one decode step and no
    prefill."""
    dec = [t for t, p, d in ticks if p == 0 and d == 1]
    return 1e3 * statistics.median(dec), len(dec)


def _serve_and_check(serve, engine, cfg, max_new: int, label: str, reqs=None,
                     ticks=None, b5_regime: str = "wgmma") -> tuple:
    """Serve the 8 requests (or ``reqs``) from zeroed launch counters; every
    request must finish with in-vocabulary tokens, no page may leak and the
    degradation ladder must stay untouched.  With a list ``ticks`` the run
    is driven tick by tick and each tick's time is appended (``_run_ticks``).
    Returns (the requests' outputs, {kernel: launches}, wall seconds)."""
    import torch

    from repro_torch.serving.engine import RequestState

    reqs = _serve_requests(cfg, max_new) if reqs is None else reqs
    counters = _served_kernels()
    _zero_launches(counters)
    if ticks is None:
        dt = serve.run_requests(engine, reqs)
    else:
        dt = _run_ticks(torch, engine, reqs, ticks)
    launches = {c.__name__: c.launches for c in counters}
    serve.report(engine, dt)
    log(f"{label}: launches during the run {launches}")
    _b5_all_wgmma(label, b5_regime)
    engine.audit_pages()
    bad = [r.uid for r in reqs if r.state is not RequestState.FINISHED
           or len(r.output) != max_new]
    if bad:
        raise AssertionError(f"{label}: requests not finished with {max_new} tokens: {bad}")
    if any(not (0 <= t < cfg.vocab) for r in reqs for t in r.output):
        raise AssertionError(f"{label}: a sampled token is outside the vocabulary")
    if engine.pages_in_use != 0:
        raise AssertionError(f"{label}: {engine.pages_in_use} pages leaked")
    if engine.degraded:
        raise AssertionError(f"{label}: the degradation ladder triggered: {engine.degraded}")
    outputs = [[int(t) for t in r.output] for r in reqs]
    log(f"{label}: greedy tokens {token_digest(outputs)} (sha256 of {sum(map(len, outputs))})")
    return outputs, launches, dt


def phase_serve(torch, results: dict):
    serve, ap, args = _serve_args()
    t0 = time.perf_counter()
    cfg, engine, _ = serve.build_engine(args, ap)
    torch.cuda.synchronize()
    log(f"serve: model + plan + engine built in {time.perf_counter() - t0:.1f}s "
        f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.compute_dtype})")
    outputs, launches, dt = _serve_and_check(serve, engine, cfg, args.max_new, "serve")
    if engine.stats.pages_shared <= 0:
        raise AssertionError("no prefix page was shared")
    if launches.pop("block_sparse_matmul_col"):
        raise AssertionError("serve: B4 launched, but every served leaf carries its walk (B1)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        results.setdefault(name, {})["launches"] = n
    log(f"serve: {engine.stats.prefills} prefills and {engine.stats.decode_steps} decode steps; "
        f"B3 {launches['paged_decode_attention']} and B5 {launches['quant_matmul']} launches")
    tok_s = engine.stats.decode_tokens / dt
    log(f"serve: {engine.stats.completed}/8 FINISHED, audit clean, "
        f"{engine.stats.pages_shared} pages shared, {engine.stats.cow_copies} COW copies, "
        f"{tok_s:.1f} tok/s on {torch.cuda.get_device_name(0)}")
    return cfg, engine, outputs, launches


class _Tee:
    """Copies what is printed to a buffer (to read the CLI's messages)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _boot(torch, serve, ap, args) -> tuple:
    """build_engine under a tee; returns (printed text, cfg, engine, plan,
    wall seconds to a ready engine)."""
    import contextlib

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        cfg, engine, plan = serve.build_engine(args, ap)
    torch.cuda.synchronize()
    return "".join(tee.text), cfg, engine, plan, time.perf_counter() - t0


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_plancache(torch, results: dict, serve_outputs: list, serve_launches: dict,
                    card: str) -> None:
    """--plan-cache on the serve phase's model and flags (see the module
    doc): miss, hit, then a walk-less copy of the plan served through B4."""
    import shutil
    import tempfile

    from repro_torch.core import weight_plan as W
    from repro_torch.checkpoint import store

    tmp = tempfile.mkdtemp(prefix="chip_smoke_plan_")
    try:
        d_walk, d_bare = os.path.join(tmp, "walk"), os.path.join(tmp, "walkless")
        serve, ap, args = _serve_args(["--plan-cache", d_walk])
        out, cfg, engine, plan, pack_s = _boot(torch, serve, ap, args)
        if not ("plan cache missing" in out and "plan cached to" in out):
            raise AssertionError("plancache: the first boot did not miss, pack and save")
        packed = [t.cpu() for t in W.flatten_leaves(plan.params)]
        del engine, plan
        torch.cuda.empty_cache()

        out, cfg, engine, plan, load_s = _boot(torch, serve, ap, args)
        if "plan cache hit" not in out:
            raise AssertionError("plancache: the second boot did not hit the cache")
        restored = W.flatten_leaves(plan.params)
        same = len(restored) == len(packed) and all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b) for a, b in zip(restored, packed))
        if not same:
            raise AssertionError("plancache: a restored leaf differs from the packed one")
        n_packed = sum(isinstance(n, W.PackedLinear) for n in plan._by_path.values())
        log(f"plancache: {len(packed)} leaves ({n_packed} packed, with walks) restored bit "
            f"for bit; {_dir_bytes(d_walk) / 1e6:.1f} MB on disk; boot {pack_s:.2f}s packing "
            f"and saving vs {load_s:.2f}s loading (init, plan, engine; {card})")
        outputs, launches, _ = _serve_and_check(serve, engine, cfg, args.max_new,
                                                "plancache hit")
        if outputs != serve_outputs:
            raise AssertionError("plancache: the hit plan's greedy tokens differ from the "
                                 "serve phase's")
        if launches["block_sparse_matmul"] <= 0 or launches["block_sparse_matmul_col"]:
            raise AssertionError(f"plancache: the walk plan must run B1, not B4: {launches}")
        log("plancache: the hit plan serves the serve phase's greedy tokens through B1")

        bare = W.map_tree(lambda _, n: dataclasses.replace(n, walk=None)
                          if isinstance(n, W.PackedLinear) else n, plan.params)
        W.save_plan(d_bare, dataclasses.replace(plan, params=bare))
        meta = store.restore_flat(d_bare)[1]["metadata"]["packed"]
        if any(m["has_walk"] for m in meta.values() if m["repr"] == "packed"):
            raise AssertionError("plancache: the walk-less directory holds a walk")
        del engine, plan, bare
        torch.cuda.empty_cache()

        serve, ap, args = _serve_args(["--plan-cache", d_bare])
        out, cfg, engine, plan, bare_s = _boot(torch, serve, ap, args)
        if "plan cache hit" not in out:
            raise AssertionError("plancache: the walk-less boot did not hit the cache")
        # apply_linear's packed leaves per model step (wq, wk, wv, wo, w_down
        # of every layer; gate/up go to B2 as a fused pair)
        per_step = []
        W.map_tree(lambda path, n: per_step.append(path) if isinstance(n, W.PackedLinear)
                   and not path.endswith(("w_gate", "w_up")) else None, engine.params)
        bare_out, launches, dt = _serve_and_check(serve, engine, cfg, args.max_new,
                                                  "plancache walk-less")
        steps = engine.stats.prefills + engine.stats.decode_steps
        want = len(per_step) * steps
        log(f"plancache walk-less: {steps} model steps ({engine.stats.prefills} prefills, "
            f"{engine.stats.decode_steps} decode steps) x {len(per_step)} packed projections "
            f"({cfg.n_layers} layers): B4 launches {launches['block_sparse_matmul_col']} "
            f"(expected {want}), boot {bare_s:.2f}s")
        if launches["block_sparse_matmul_col"] != want or launches["block_sparse_matmul"]:
            raise AssertionError(f"plancache: the walk-less plan must run every projection "
                                 f"through B4 and none through B1: {launches}")
        for name in ("fused_gate_up", "paged_decode_attention", "quant_matmul"):
            if launches[name] != serve_launches[name]:
                raise AssertionError(f"plancache: {name} launched {launches[name]} times, "
                                     f"{serve_launches[name]} in the serve phase")
        results.setdefault("block_sparse_matmul_col", {})["launches"] = \
            launches["block_sparse_matmul_col"]
        # B4 equals B1 bit for bit, so every token equals the walk plan's
        if bare_out != serve_outputs:
            agree = sum(a == b for o, so in zip(bare_out, serve_outputs) for a, b in zip(o, so))
            raise AssertionError(f"plancache: the walk-less plan's greedy tokens differ from "
                                 f"the walk plan's ({agree} of {sum(map(len, serve_outputs))} "
                                 f"equal)")
        log(f"plancache walk-less: 8/8 FINISHED, audit clean, all "
            f"{sum(map(len, serve_outputs))} greedy tokens equal the walk plan's "
            f"({engine.stats.decode_tokens / dt:.1f} tok/s on {card})")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        _path_parity(torch, cfg, engine.params, "walk-less quant_sparse (B4)", gen)
        del engine, plan
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_long(torch, results: dict) -> tuple:
    """Long-prompt prefill at full width through B6 (see the module doc).
    Returns (the prompts, the greedy tokens) for the chunked phase."""
    import numpy as np

    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_gate_up as FG
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.serving.engine import Request, RequestState

    serve, ap, args = _serve_args(["--requests", "4", "--prompt-len", str(LONG_M),
                                   "--max-len", "2048"])
    t0 = time.perf_counter()
    cfg, engine, _ = serve.build_engine(args, ap)
    torch.cuda.synchronize()
    log(f"long: model + plan + engine built in {time.perf_counter() - t0:.1f}s "
        f"(max_len {engine.max_len}, {engine.num_pages} pages of {engine.page_size})")
    rng = np.random.default_rng(1)
    lens = (40, 1100, 1536, LONG_M)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                    max_new_tokens=args.max_new) for i, n in enumerate(lens)]
    # each batch-1 prefill on the card's clock: CUDA events around the
    # engine's prefill call (idle gaps while the host enqueues included)
    timed = []
    prefill = engine._prefill_request

    def timed_prefill(req, tokens):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = prefill(req, tokens)
        end.record()
        timed.append((req.uid, len(tokens), start, end))
        return out

    engine._prefill_request = timed_prefill
    counters = (BS.block_sparse_matmul, FG.fused_gate_up, FA.paged_decode_attention,
                QM.quant_matmul, FA.flash_attention)
    _zero_launches(counters)
    dt = serve.run_requests(engine, reqs)
    launches = {c.__name__: c.launches for c in counters}
    serve.report(engine, dt)
    log(f"long: launches during the run {launches}")
    _b5_all_wgmma("long")
    engine.audit_pages()
    bad = [r.uid for r in reqs if r.state is not RequestState.FINISHED
           or len(r.output) != args.max_new]
    if bad:
        raise AssertionError(f"long: requests not finished with {args.max_new} tokens: {bad}")
    if any(not (0 <= t < cfg.vocab) for r in reqs for t in r.output):
        raise AssertionError("long: a sampled token is outside the vocabulary")
    if engine.pages_in_use != 0:
        raise AssertionError(f"long: {engine.pages_in_use} pages leaked")
    outputs = [[int(t) for t in r.output] for r in reqs]
    log(f"long: greedy tokens {token_digest(outputs)} (sha256 of {sum(map(len, outputs))})")
    want = cfg.n_layers * sum(n > 1024 for n in lens)  # the 40-token prompt stays dense
    if launches["flash_attention"] != want:
        raise AssertionError(f"long: B6 launched {launches['flash_attention']} times, "
                             f"expected {want}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"long: kernel {name} was not launched on the long path")
    results.setdefault("flash_attention", {})["launches"] = launches["flash_attention"]
    torch.cuda.synchronize()
    for uid, n, start, end in timed:
        ms = start.elapsed_time(end)
        log(f"long: request {uid} prefill of {n} tokens {ms:.3f} ms on the card's clock")
        if n == LONG_M:
            log(f"long: the {LONG_M}-token prefill {ms:.3f} ms against {LONG_PREFILL_MS_BEFORE} "
                f"ms before B1/B2 ran on wgmma ({LONG_PREFILL_MS_BEFORE / ms:.2f}x)")
    log(f"long: {engine.stats.completed}/{len(reqs)} FINISHED, audit clean, "
        f"{engine.stats.decode_tokens / dt:.1f} tok/s on {torch.cuda.get_device_name(0)}")
    del engine
    torch.cuda.empty_cache()
    return [r.prompt for r in reqs], outputs


def _prefill_logits(torch, cfg, params, tokens, extras=None):
    """Last-position logits (fp32) of a batch-1 prefill over ``tokens`` (and
    a request's ``extras``: a VLM's patches, an enc-dec's frames) through
    the served kernels: the plain, non-speculative path teacher-forced.
    ``tokens`` may also be a list of equal-length token lists without
    extras: one batched prefill, logits (B, vocab)."""
    import numpy as np

    from repro_torch.models.api import get_api

    api = get_api(cfg)
    dev = params["final_norm"]["scale"].device
    rows = tokens if tokens and isinstance(tokens[0], (list, tuple)) else [tokens]
    t = torch.as_tensor([[int(x) for x in r] for r in rows], device=dev)
    batch = {"tokens": t}
    for k, v in (extras or {}).items():
        batch[k] = torch.as_tensor(np.asarray(v), device=dev)[None]
    cache = api.init_cache(cfg, len(rows), t.shape[1] + api.prefix_len(cfg),
                           getattr(torch, cfg.compute_dtype), kv_dtype=torch.int8, device=dev)
    lg = api.prefill(cfg, params, batch, cache)[0][:, -1].float()
    return lg if rows is tokens else lg[0]


def _first_diff(label: str, want, got):
    """(first differing position or None, differing tokens) of two streams
    of one length."""
    if len(want) != len(got):
        raise AssertionError(f"{label}: streams of {len(want)} and {len(got)} tokens")
    diff = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    return (diff[0] if diff else None), len(diff)


def _tie_at(torch, label: str, lg, want, got, j: int, n_diff: int) -> int:
    """The near-tie rule at the first differing token j, from the plain
    path's logits ``lg`` there; returns n_diff or raises."""
    top = torch.topk(lg, 2).values
    gap = float(top[0] - top[1])
    pair = float((lg[want[j]] - lg[got[j]]).abs())
    tol = PATH_RTOL * float(lg.abs().max())
    log(f"{label}: streams differ from token {j} on ({n_diff} of {len(want)} tokens "
        f"differ); plain logits there: top-2 gap {gap:.4e}, |dlogit| of the two tokens "
        f"{pair:.4e}, tolerance {tol:.4e}")
    if not gap <= tol:
        raise AssertionError(f"{label}: streams differ at token {j} where the plain path has "
                             f"no near-tie (top-2 gap {gap:.4e} > {tol:.4e})")
    return n_diff


def near_tie(torch, cfg, params, label: str, prompt, want, got, extras=None) -> int:
    """The near-tie rule: streams ``got`` and ``want`` (the plain path's) are
    equal, or at the first position j where they differ the top-2 gap of
    the plain path's logits there (teacher-forced over prompt + want[:j]) is
    at most PATH_RTOL of their largest magnitude: the two paths' logits may
    differ that much (the parity phase's tolerance), so such a token flips on
    a near-tie.  Returns the count of differing tokens; raises otherwise."""
    j, n_diff = _first_diff(label, want, got)
    if j is None:
        return 0
    lg = _prefill_logits(torch, cfg, params, list(prompt) + list(want[:j]), extras)
    return _tie_at(torch, label, lg, want, got, j, n_diff)


def _streams_near_tie(torch, cfg, params, label, prompts, want, got, extras=None) -> int:
    """near_tie over every request (with its ``extras``, where given); the
    requests without extras whose teacher-forced prefixes have one length
    share one batched prefill.  Logs and returns the differing tokens."""
    extras = extras or [None] * len(prompts)
    n, by_len = 0, {}
    for i, (p, w, g, e) in enumerate(zip(prompts, want, got, extras)):
        if e is not None:
            n += near_tie(torch, cfg, params, f"{label} request {i}", p, w, g, e)
            continue
        j, n_diff = _first_diff(f"{label} request {i}", w, g)
        if j is not None:
            by_len.setdefault(len(p) + j, []).append((i, j, n_diff))
    for length, reqs in sorted(by_len.items()):
        lg = _prefill_logits(torch, cfg, params,
                             [list(prompts[i]) + list(want[i][:j]) for i, j, _ in reqs])
        for row, (i, j, n_diff) in enumerate(reqs):
            n += _tie_at(torch, f"{label} request {i}", lg[row], want[i], got[i], j, n_diff)
    log(f"{label}: {n} of {sum(map(len, want))} tokens differ from the plain path's "
        f"(near-tie rule, tolerance {PATH_RTOL} of the largest logit)")
    return n


def _spec_log(label: str, engine, dt: float, card: str) -> float:
    """Logs a speculative run's counters; returns committed tokens per
    sequence per verify step."""
    s, k = engine.stats, engine.spec_k
    per_seq = s.decode_tokens / max(1, s.verified_positions // (k + 1))
    log(f"{label}: accept rate {s.accept_rate:.4f} ({s.draft_accepted}/{s.draft_proposed}), "
        f"verified_positions {s.verified_positions}, {s.decode_steps} verify ticks, "
        f"{s.decode_tokens} committed tokens ({s.mean_batch:.3f} a tick, {per_seq:.3f} a "
        f"sequence a tick), {s.decode_tokens / dt:.1f} tok/s on {card}; degraded "
        f"{engine.degraded}")
    return per_seq


def _timed_spec_ticks(engine) -> dict:
    """Wall time of each speculative tick and of its draft chain and verify
    step (host clock; each ends in a device-to-host fetch, so it covers the
    device work it waits on).  Returns the lists it fills."""
    times = {"tick": [], "draft": [], "verify": []}

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times[key].append(time.perf_counter() - t0)
            return out
        return run

    engine._spec_step = timed(engine._spec_step, "tick")
    engine._draft_chain = timed(engine._draft_chain, "draft")
    engine._run_decode = timed(engine._run_decode, "verify")
    return times


def _verify_parity(torch, cfg, params, gen, label: str = "spec") -> None:
    """Teacher-forced verify steps at the spec phase's shape (8 sequences,
    T = SPEC_K + 1 positions a step, paged int8 KV from position 0): the
    kernels (B1, B2, B5 at M = 40, B3 at T = 5) against the plain versions on
    the same tokens, and against the kernels one position at a time; logits
    within PATH_RTOL at every position."""
    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.models import transformer as T

    B, T_, steps, ps = 8, SPEC_K + 1, 5, 16
    n = T_ * steps
    dev = gen.device
    tokens = torch.randint(0, cfg.vocab, (B, n), generator=gen, device=dev)
    P = -(-n // ps)

    def run(p, use_kernel, width):
        cache = T.init_cache(cfg, B, P * ps, getattr(torch, cfg.compute_dtype),
                             kv_dtype=torch.int8, page_size=ps, num_pages=1 + B * P, device=dev)
        cache["page_table"].copy_(1 + torch.arange(B * P, device=dev).reshape(B, P))
        out = []
        for t in range(0, n, width):
            pos = torch.full((B,), t, dtype=torch.int32, device=dev)
            lg, cache = T.decode_step(cfg, p, cache, tokens[:, t:t + width], pos,
                                      use_kernel=use_kernel)
            out.append(lg.float())
        return torch.cat(out, dim=1)

    verify = run(params, True, T_)
    others = {"plain versions": run(with_use_kernel(params, False), False, T_),
              "kernels one position a step": run(params, True, 1)}
    torch.cuda.synchronize()
    for name, b in others.items():
        if not (torch.isfinite(verify).all() and torch.isfinite(b).all()):
            raise AssertionError("verify parity: non-finite logits")
        worst = float(((verify - b).abs().amax(dim=-1) / b.abs().amax(dim=-1)).max())
        agree = float((verify.argmax(-1) == b.argmax(-1)).float().mean())
        log(f"{label}: teacher-forced verify (B={B}, T={T_}, {n} positions) vs {name}: max "
            f"|dlogit| / max |logit| = {worst:.3e} (tolerance {PATH_RTOL}), greedy agreement "
            f"{agree:.4f}")
        if not worst <= PATH_RTOL:
            raise AssertionError(f"verify logits differ from the {name}: {worst:.3e}")


def phase_spec(torch, results: dict, serve_outputs: list, card: str) -> list:
    """Speculative decode at full width through the serve CLI (see the
    module doc): a seed + 1 draft, then the target's own plan as the draft.
    Returns the seed + 1 draft's streams."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.config import SpecConfig
    from repro_torch.serving.engine import ServingEngine

    serve, ap, args = _serve_args(["--draft-config", "tinyllama-1.1b", "--spec-k", str(SPEC_K)])
    t0 = time.perf_counter()
    cfg, engine, plan = serve.build_engine(args, ap)
    torch.cuda.synchronize()
    log(f"spec: model + plan + dense bf16 draft + engine built in "
        f"{time.perf_counter() - t0:.1f}s")
    times = _timed_spec_ticks(engine)
    outputs, launches, dt = _serve_and_check(serve, engine, cfg, args.max_new, "spec")
    by_t = dict(FA.paged_decode_attention.launches_by_t)
    log(f"spec: B3 launches by query positions {by_t}")
    if launches.pop("block_sparse_matmul_col"):
        raise AssertionError("spec: B4 launched, but every served leaf carries its walk")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"spec: kernel {name} was not launched")
    if by_t.get(SPEC_K + 1, 0) <= 0:
        raise AssertionError(f"spec: B3 never launched at T = {SPEC_K + 1}: {by_t}")
    for row in results.get("paged_decode_attention", {}).get("rows", []):
        if row["shape"].startswith("verify"):
            row["launches"] = by_t[SPEC_K + 1]
    _spec_log("spec (seed + 1 draft)", engine, dt, card)
    n_ticks = len(times["tick"])
    draft_ms, verify_ms, tick_ms = (1e3 * sum(times[k]) / max(1, n_ticks)
                                    for k in ("draft", "verify", "tick"))
    log(f"spec: a tick's wall time {tick_ms:.2f} ms over {n_ticks} ticks: {SPEC_K + 1} draft "
        f"steps {draft_ms:.2f} ms, verify step {verify_ms:.2f} ms, the rest (acceptance, "
        f"table, bookkeeping) {tick_ms - draft_ms - verify_ms:.2f} ms ({card})")
    prompts = [r.prompt for r in _serve_requests(cfg, args.max_new)]
    _streams_near_tie(torch, cfg, engine.params, "spec vs serve", prompts, serve_outputs,
                      outputs)

    params, dev = engine.params, engine.device
    conf = dataclasses.replace(engine.config, spec=SpecConfig(
        draft_cfg=cfg, draft_params=params, spec_k=SPEC_K))
    del engine
    torch.cuda.empty_cache()
    self_eng = ServingEngine(cfg, params, plan=plan, device=dev, config=conf)
    out_self, _, dt = _serve_and_check(serve, self_eng, cfg, args.max_new, "spec self-draft")
    per_seq = _spec_log("spec self-draft", self_eng, dt, card)
    if not self_eng.stats.accept_rate > 0.5:
        raise AssertionError(f"spec self-draft: accept rate {self_eng.stats.accept_rate:.4f} "
                             f"<= 0.5")
    if not per_seq > 1.0:
        raise AssertionError(f"spec self-draft: {per_seq:.3f} committed tokens a sequence a "
                             f"tick, not more than 1")
    _streams_near_tie(torch, cfg, params, "spec self-draft vs serve", prompts, serve_outputs,
                      out_self)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    _verify_parity(torch, cfg, params, gen)
    del self_eng, params, plan
    torch.cuda.empty_cache()
    return outputs


# the chunked phase: the long phase's prompts, arriving by a seeded Poisson
# process at this many requests a tick, prefilled in chunks of 256 under a
# budget of 512 prompt tokens a tick
CHUNK_FLAGS = ("--prefill-chunk", "256", "--prefill-budget", "512")
ARRIVAL_RATE = 0.5


def _open_loop(torch, flags, prompts, label: str):
    """The long phase's prompts (16 new tokens each) under open-loop
    arrivals on the engine's TickClock; returns (engine, LoadReport,
    {kernel: launches}, wall seconds)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving import loadgen as LG
    from repro_torch.serving.engine import Request

    serve, ap, args = _serve_args(["--requests", str(len(prompts)), "--prompt-len", str(LONG_M),
                                   "--max-len", "2048", "--arrival-rate", str(ARRIVAL_RATE),
                                   *flags])
    cfg, engine, _ = serve.build_engine(args, ap)
    one = LG.LengthMixture(((1.0, (1, 1), (args.max_new, args.max_new)),))
    arrivals = [dataclasses.replace(a, prompt_len=len(p)) for a, p in
                zip(LG.poisson_trace(ARRIVAL_RATE, len(prompts), one, seed=0), prompts)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=args.max_new) for i, p in enumerate(prompts)]
    counters = _served_kernels() + (FA.flash_attention,)
    _zero_launches(counters)
    # the host clock at the end of each tick (a tick ends in device-to-host
    # fetches): the wall time between a request's commits
    walls, step = [], engine.step

    def timed_step():
        out = step()
        walls.append(time.perf_counter())
        return out

    engine.step = timed_step
    rep, dt = serve.run_open_loop_timed(engine, arrivals, reqs)
    rep.tick_wall_s = walls
    launches = {c.__name__: c.launches for c in counters}
    serve.report(engine, dt, rep)
    log(f"{label}: arrivals at ticks {[round(a.t, 3) for a in arrivals]}; launches {launches}")
    log(f"{label}: summary {json.dumps(rep.summary(), sort_keys=True)}")
    bad = [r.uid for r in reqs if r.state.value != "FINISHED" or len(r.output) != args.max_new]
    if bad or not rep.all_terminal or rep.leaked_pages:
        raise AssertionError(f"{label}: unfinished requests {bad}, {rep.leaked_pages} pages leaked")
    if engine.degraded:
        raise AssertionError(f"{label}: the degradation ladder triggered: {engine.degraded}")
    return cfg, engine, rep, launches


def _wall_gap_ms(rep, uid: int) -> float:
    """Largest host-clock gap (ms) between two consecutive commits of
    request ``uid``: ticks from ``rep.token_ticks``, times from the end of
    each tick (``rep.tick_wall_s``)."""
    ticks = rep.token_ticks[uid]
    return max((rep.tick_wall_s[b - 1] - rep.tick_wall_s[a - 1]) * 1e3
               for a, b in zip(ticks, ticks[1:]))


def phase_chunked(torch, long_prompts: list, long_outputs: list, card: str) -> list:
    """Chunked prefill under open-loop arrivals (see the module doc).
    Returns the chunked run's streams, in the prompts' order."""
    cfg, engine, rep, launches = _open_loop(torch, CHUNK_FLAGS, long_prompts, "chunked")
    for name in ("block_sparse_matmul", "fused_gate_up", "quant_matmul",
                 "paged_decode_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"chunked: kernel {name} was not launched")
    if launches["flash_attention"] or launches["block_sparse_matmul_col"]:
        raise AssertionError(f"chunked: a chunk reached B6 or B4: {launches}")
    log(f"chunked: {engine.stats.prefill_chunks} chunks, {engine.stats.prefill_tokens} prompt "
        f"tokens, {engine.stats.decode_steps} decode steps, {rep.wall_s:.2f}s wall on {card}")
    gap = {u: rep.max_intertoken_gap([0], unit=u) for u in ("work", "tick")}
    gap["ms"] = _wall_gap_ms(rep, 0)
    firsts = [o[0] for o in rep.outputs.values()]
    streams = [[int(t) for t in rep.outputs[i]] for i in range(len(long_prompts))]
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    _, sync, srep, _ = _open_loop(torch, (), long_prompts, "chunked, synchronous")
    sgap = {u: srep.max_intertoken_gap([0], unit=u) for u in ("work", "tick")}
    sgap["ms"] = _wall_gap_ms(srep, 0)
    del sync
    torch.cuda.empty_cache()
    log(f"chunked: the 40-token request's largest inter-token gap {gap['work']} work units "
        f"({gap['tick']} ticks, {gap['ms']:.2f} ms wall) with chunks, {sgap['work']} "
        f"({sgap['tick']} ticks, {sgap['ms']:.2f} ms wall) without ({card})")
    if not gap["work"] < sgap["work"]:
        raise AssertionError("chunked: chunks did not shrink the short request's largest gap")
    n = sum(near_tie(torch, cfg, params, f"chunked first token, request {i}", p, [w[0]], [f])
            for i, (p, w, f) in enumerate(zip(long_prompts, long_outputs, firsts)))
    log(f"chunked: {len(firsts) - n} of {len(firsts)} first tokens equal the long phase's, "
        f"the rest near-ties")
    return streams


def _chaos_schedule(FI, n_ticks: int, uids: list) -> tuple:
    """The first seed whose ``seeded_schedule`` holds all six kinds, with the
    first dead_draft at tick 3-8, the first kernel_fault after it by tick 10,
    neither on a dropped tick (so that both meet a decode step)."""
    rates = {"nan_logits": 0.08, "alloc_fail": 0.08, "drop_tick": 0.06, "slow_tick": 0.06,
             "dead_draft": 0.05, "kernel_fault": 0.05}
    for seed in range(10000):
        sched = FI.seeded_schedule(seed, n_ticks=n_ticks, uids=uids, rates=rates,
                                   slow_delay_s=2.0)
        first = {k: min((f.tick for f in sched if f.kind == k), default=0) for k in FI.KINDS}
        drops = {f.tick for f in sched if f.kind == "drop_tick"}
        dd, kf = first["dead_draft"], first["kernel_fault"]
        if all(first.values()) and 3 <= dd < kf <= 10 and not {dd, kf} & drops:
            return seed, rates, sched
    raise AssertionError("no chaos schedule found")


def phase_faults(torch, card: str) -> None:
    """run_chaos under a seeded schedule of all six kinds (see the module doc)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving import faultinject as FI
    from repro_torch.serving.config import FaultConfig
    from repro_torch.serving.engine import ServingEngine

    serve, ap, args = _serve_args(["--draft-config", "tinyllama-1.1b", "--spec-k", "2",
                                   "--max-retries", "3"])
    cfg, base, plan = serve.build_engine(args, ap)
    n = args.requests

    def chaos(faults):
        clock = FI.TickClock()
        fi = FI.FaultInjector(faults, clock=clock) if faults else None
        conf = dataclasses.replace(base.config, fault=FaultConfig(
            clock=clock, fault_injector=fi, watchdog_timeout_s=3.0))
        eng = ServingEngine(cfg, base.params, plan=plan, device=base.device, config=conf)
        trail, step = [], eng.step

        def traced():
            out = step()
            trail.append((eng.tick, FA.paged_decode_attention.launches, sorted(eng.degraded)))
            return out

        eng.step = traced
        reqs = _serve_requests(cfg, args.max_new)
        _zero_launches(_served_kernels())
        t0 = time.perf_counter()
        rep = FI.run_chaos(eng, [(1, r) for r in reqs])
        torch.cuda.synchronize()
        return eng, reqs, rep, trail, time.perf_counter() - t0

    clean, creqs, crep, _, dt = chaos(None)
    if not crep.all_terminal or crep.leaked_pages or clean.degraded:
        raise AssertionError(f"faults: the fault-free run: {crep.states}, {crep.leaked_pages} "
                             f"pages leaked, degraded {clean.degraded}")
    log(f"faults: fault-free run {crep.ticks} ticks, degraded {clean.degraded}, {dt:.2f}s")
    seed, rates, sched = _chaos_schedule(FI, 16, list(range(n)))
    log(f"faults: seeded_schedule seed {seed}, rates {rates}: "
        + ", ".join(f"{f.kind}@{f.tick}" + (f"(uid {f.uid})" if f.uid is not None else "")
                    for f in sched))
    eng, reqs, rep, trail, dt = chaos(sched)
    fired = eng.fault_injector.fired
    kinds = sorted({k for _, k, _ in fired})
    log(f"faults: fired {fired}")
    log(f"faults: {rep.ticks} ticks in {dt:.2f}s; states {rep.states}; stats failed "
        f"{eng.stats.failed} retried {eng.stats.retried} evicted {eng.stats.evicted} timed out "
        f"{eng.stats.timed_out} fallback ticks {eng.stats.fallback_ticks}; degraded "
        f"{eng.degraded}; watchdog silence {eng.watchdog.silence_s():.1f}s, dead hosts "
        f"{eng.watchdog.dead_hosts()}")
    if not rep.all_terminal or rep.leaked_pages:
        raise AssertionError(f"faults: {rep.states}, {rep.leaked_pages} pages leaked")
    if kinds != sorted(FI.KINDS):
        raise AssertionError(f"faults: kinds that fired {kinds}, not all six")
    for rung, kind in (("speculative", "dead_draft"), ("attention_kernel", "kernel_fault")):
        at = min(t for t, k, _ in fired if k == kind)
        taken = min((t for t, _, d in trail if rung in d), default=None)
        log(f"faults: rung {rung} taken at tick {taken}; first {kind} fired at tick {at}")
        if taken != at:
            raise AssertionError(f"faults: rung {rung} at tick {taken}, {kind} at tick {at}")
    if sorted(eng.degraded) != ["attention_kernel", "speculative"]:
        raise AssertionError(f"faults: degraded {eng.degraded}")
    kf = min(t for t, k, _ in fired if k == "kernel_fault")
    before = [b3 for t, b3, _ in trail if t < kf][-1]
    after = sorted({b3 for t, b3, _ in trail if t >= kf})
    log(f"faults: B3 launches {before} before the kernel_fault tick {kf}, {after} after")
    if after != [before]:
        raise AssertionError("faults: B3 launched after rung 2 switched this engine off it")
    touched = {u for _, k, u in fired if k == "nan_logits" and u is not None}
    touched |= {r.uid for r in reqs if r.retries or r.evictions}
    if any(k == "nan_logits" and u is None for _, k, u in fired):
        touched = set(range(n))  # a poisoning of every live slot
    diff = rep.diff_streams(crep.outputs)
    log(f"faults: requests touched by a fault {sorted(touched)}; streams that differ from the "
        f"fault-free run {diff}")
    prompts = [r.prompt for r in creqs]
    for uid in sorted(set(range(n)) - touched):
        near_tie(torch, cfg, base.params, f"faults request {uid}", prompts[uid],
                 crep.outputs[uid], rep.outputs[uid])
    del eng, clean, base, plan
    torch.cuda.empty_cache()


class _SharedRouting:
    """A MoE model's plain pass replays its kernel pass's routing.

    The kernel pass records every ``moe.route`` call (expert choices,
    slots, kept assignments); the plain pass that follows on the same
    tokens takes them back in the same order, with gate values from its
    own router probabilities.  A top-k choice is discontinuous: a one-ulp
    difference upstream sends a token to another expert wherever two
    router probabilities nearly tie (common under random weights: 60
    experts' logits lie close), which moves its output far more than the
    kernels' rounding does.  With the choices shared the comparison holds
    the kernels' arithmetic to PATH_RTOL; ``flips`` counts the assignments
    the plain pass would have routed elsewhere.  A replaying pass that
    outlasts the recording routes on its own from there (the mesh phase
    shares only its compared ticks).  A dense model runs both passes
    untouched."""

    def __init__(self, cfg):
        self.moe = cfg.moe is not None
        self.calls, self.flips, self.total = [], 0, 0

    @contextlib.contextmanager
    def run(self, record: bool):
        """A pass that records (the kernels') or replays (the plain one's)."""
        if not self.moe:
            yield
            return
        from repro_torch.models import moe as MOE

        inner = MOE.route
        if record:
            self.calls = []
        replay = iter(self.calls)

        def route(cfg, xg, router, **kw):
            r = inner(cfg, xg, router, **kw)
            if record:
                self.calls.append(r)
                return r
            k = next(replay, None)
            if k is None:
                return r
            self.flips += int((r.idx != k.idx).sum())
            self.total += r.idx.numel()
            gates = r.probs.gather(-1, k.idx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return dataclasses.replace(k, probs=r.probs, gates=gates)

        MOE.route = route
        try:
            yield
        finally:
            MOE.route = inner


def _path_parity(torch, cfg, params, label: str, gen, lengths=(36, 40, LONG_M)) -> None:
    """Prefill at the serve phase's prompt lengths and at LONG_M (past the
    dense threshold: B6), or at ``lengths``, then teacher-forced paged
    int8-KV decode, through the kernels and through the plain versions
    (``with_use_kernel(params, False)``, ``prefill(use_kernel=False)``) on
    the same tokens; the logits must agree within PATH_RTOL at every step.
    A VLM's prompts follow random patches (n_patches more positions).  A
    MoE model's plain pass takes the kernel pass's expert choices
    (``_SharedRouting``)."""
    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.models import transformer as T
    from repro_torch.models import vlm as V

    B, steps, ps = 4, 24, 16
    tokens = torch.randint(0, cfg.vocab, (steps, B), generator=gen, device="cuda")
    paths = {"kernels": (params, True), "plain": (with_use_kernel(params, False), False)}
    shared = _SharedRouting(cfg)
    patches = None
    if cfg.family == "vlm":
        patches = torch.randn((1, cfg.n_patches, cfg.d_model), generator=gen, device="cuda")

    greedy = []  # the kernel path's greedy tokens: each prefill's, then each step's
    for S in lengths:
        prompt = torch.randint(0, cfg.vocab, (1, S), generator=gen, device="cuda")
        lg = {}
        for name, (p, use_kernel) in paths.items():
            n = S + (0 if patches is None else cfg.n_patches)
            cache = T.init_cache(cfg, 1, n, torch.bfloat16, kv_dtype=torch.int8, device="cuda")
            with shared.run(record=use_kernel):
                if patches is None:
                    out = T.prefill(cfg, p, prompt, cache, use_kernel=use_kernel)
                else:
                    out = V.prefill(cfg, p, prompt, patches, cache, use_kernel=use_kernel)
                lg[name] = out[0][0, -1].float()
        torch.cuda.synchronize()
        a, b = lg["kernels"], lg["plain"]
        greedy.append(int(a.argmax()))
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{label}: non-finite prefill logits")
        worst = float((a - b).abs().max() / b.abs().max())
        log(f"parity {label}: prefill of {n} positions, max |dlogit| / max |logit| = {worst:.3e} "
            f"(tolerance {PATH_RTOL}), same greedy token {bool(a.argmax() == b.argmax())}")
        if not worst <= PATH_RTOL:
            raise AssertionError(f"{label}: kernel prefill logits differ from the plain path: "
                                 f"{worst:.3e}")

    logits = {}
    for name, (p, use_kernel) in paths.items():
        P = -(-steps // ps)
        cache = T.init_cache(cfg, B, P * ps, torch.bfloat16, kv_dtype=torch.int8,
                             page_size=ps, num_pages=1 + B * P, device="cuda")
        cache["page_table"].copy_(1 + torch.arange(B * P, device="cuda").reshape(B, P))
        out = []
        with shared.run(record=use_kernel):
            for t in range(steps):
                pos = torch.full((B,), t, dtype=torch.int32, device="cuda")
                lg, cache = T.decode_step(cfg, p, cache, tokens[t][:, None], pos,
                                          use_kernel=use_kernel)
                out.append(lg[:, 0].float())
        logits[name] = torch.stack(out)
    torch.cuda.synchronize()
    a, b = logits["kernels"], logits["plain"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{label}: non-finite logits")
    diff = (a - b).abs().amax(dim=(1, 2))
    scale = b.abs().amax(dim=(1, 2))
    worst = float((diff / scale).max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    greedy.append(a.argmax(-1).tolist())
    log(f"parity {label}: {steps} teacher-forced steps x {B} sequences, max |dlogit| / "
        f"max |logit| = {worst:.3e} (tolerance {PATH_RTOL}), greedy agreement {agree:.4f}, "
        f"kernel path's greedy tokens {token_digest(greedy)}")
    if shared.moe:
        log(f"parity {label}: the plain pass, given the kernel pass's routing, would have "
            f"sent {shared.flips} of {shared.total} (token, k) assignments to another expert")
    if not worst <= PATH_RTOL:
        raise AssertionError(f"{label}: kernel path logits differ from the plain path: "
                             f"{worst:.3e}")


# --mesh runs of the mesh phase: (mesh, the cases its ranks serve)
MESH_RUNS = (("1x2", ("serve", "long", "quant", "spec", "chunked", "granite", "rg", "rg quant",
                      "qwen2-moe", "xlstm", "whisper", "internvl", "mix")),
             ("2x2", ("serve", "spec")), ("1x4", ("granite", "xlstm", "whisper")),
             ("1x8", ("serve",)))
MESH_KERNELS = ("block_sparse_matmul", "fused_gate_up", "paged_decode_attention",
                "quant_matmul")
# a case's serve flags (over the quickstart ones)
MESH_FLAGS = {
    "quant": ("--compress", "quant"),
    "spec": ("--draft-config", "tinyllama-1.1b", "--spec-k", str(SPEC_K)),
    "chunked": CHUNK_FLAGS + ("--prompt-len", str(LONG_M), "--max-len", "2048"),
    "granite": ("--arch", "granite-moe-1b-a400m"),
    "qwen2-moe": ("--arch", "qwen2-moe-a2.7b"),
    "rg": ("--arch", "recurrentgemma-2b"),
    "rg quant": ("--arch", "recurrentgemma-2b", "--compress", "quant"),
    "xlstm": ("--arch", "xlstm-350m"),
    "whisper": ("--arch", "whisper-tiny", "--pool-pages", str(WHISPER_POOL)),
    "internvl": ("--arch", "internvl2-2b", "--max-len", str(INTERNVL_MAX_LEN)),
}
# the cases whose requests carry frames or patches (``_extras_requests``)
MESH_EXTRAS = ("whisper", "internvl")
# the kernels a case's run must launch (above zero on every rank)
MESH_CASE_KERNELS = {
    "long": MESH_KERNELS + ("flash_attention",),
    "quant": ("paged_decode_attention", "quant_matmul"),
    "granite": ("block_sparse_matmul", "fused_gate_up", "paged_decode_attention"),
    "rg": ("block_sparse_matmul", "fused_gate_up"),
    "rg quant": ("quant_matmul",),
    "xlstm": ("block_sparse_matmul", "quant_matmul"),
    "whisper": ("block_sparse_matmul", "paged_decode_attention", "flash_attention"),
    "internvl": MESH_KERNELS,
    # --compress none: the attention kernels only (B6: whisper's 1500 frames)
    "mix": ("paged_decode_attention", "flash_attention"),
}
# the attention launches a case's run replays (recurrentgemma's contiguous
# rings and short prompts reach neither B3 nor B6, nor does xlstm-350m,
# which has no attention; whisper's first non-causal B3 launch reads its
# frame pages and its first B6 launch is the encoder's)
MESH_CASE_ATTENTION = {"long": ("paged_decode_attention", "flash_attention"), "rg": (),
                       "rg quant": (), "xlstm": (),
                       "whisper": ("paged_decode_attention", "paged_decode_attention",
                                   "flash_attention")}
# cases held to the rank's own unsharded engine's streams (no earlier
# phase served their plan)
MESH_OWN = ("quant", "rg quant")


def _first_decode_logits(engine, snap=None) -> list:
    """Records (the input tokens, the logits (fp32, host), the slots then
    decoding, ``snap(engine)`` after the step or None) of ``engine``'s first
    decode step into the returned list."""
    rec, real = [], engine._decode

    def spy(tokens, pos, poison):
        lg = real(tokens, pos, poison)
        if not rec:
            rec.append((tokens[:, 0].cpu(), lg[:, 0].float().cpu(), engine._decoding_slots(),
                        None if snap is None else snap(engine)))
        return lg

    engine._decode = spy
    return rec


@contextlib.contextmanager
def _decode_reduces(engine, counts: list):
    """Appends to ``counts`` the all-reduces (``shardlib.all_reduce``) each
    of ``engine``'s decode (or verify) steps issues."""
    from repro_torch.distributed import shardlib as sl

    real_reduce, real_decode, n = sl.all_reduce, engine._decode, [0]

    def reduce(x, axis, *op):
        n[0] += 1
        return real_reduce(x, axis, *op)

    def decode(tokens, pos, poison):
        before = n[0]
        lg = real_decode(tokens, pos, poison)
        counts.append(n[0] - before)
        return lg

    sl.all_reduce, engine._decode = reduce, decode
    try:
        yield
    finally:
        sl.all_reduce, engine._decode = real_reduce, real_decode


def _first_with(layers: list, key: str) -> int:
    """The first layer holding ``key`` (its kind's block), or -1."""
    return next((i for i, layer in enumerate(layers) if key in layer), -1)


def _shard_checks(torch, cfg, whole, engine) -> dict:
    """The first layer's projections of each kind on this rank's shards
    (attention wq/wo, the RG-LRU's w_x/w_out, the mLSTM's w_u/w_down, the
    sLSTM's w_gates/w_up, a gated MLP's w_gate/w_up pair -- B2 where packed
    -- and an untied head) against the matching columns of
    the whole leaf's launch and against the plain versions, on one seeded
    (8, K) input in the compute dtype; a MoE layer's stacks on the rank's
    experts (``_expert_checks``).  ``whole``: the unstacked whole tree.
    {name: (kernel, max rel err vs the whole launch's columns or None for a
    split contraction, max rel err vs plain)}."""
    from repro_torch.core import weight_plan as WP
    from repro_torch.distributed import shardlib as sl

    mine = engine.params
    dev = engine.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dt = getattr(torch, cfg.compute_dtype)
    out = {}

    def x_for(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    def kernel_of(w):
        if isinstance(w, WP.QuantLinear):
            return "quant_matmul"
        return "block_sparse_matmul" if isinstance(w, WP.PackedLinear) else "dense"

    with engine._on_mesh():
        m, M = sl.axis_index("model"), sl.axis_size("model")
        leaves = []
        for block, names in (("attn", ("wq", "wo")), ("rec", ("w_x", "w_out"))):
            i = _first_with(whole["layers"], block)
            if i >= 0:
                leaves += [(name if block == "attn" else f"rec {name}",
                            whole["layers"][i][block][name], mine["layers"][i][block][name])
                           for name in names]
        # xLSTM: the mLSTM's up and down projections, the sLSTM's gates and
        # its w_up (at 1x2 B5's dense_tile on 1365 of its 2730 columns)
        for kind, names in (("mlstm", ("w_u", "w_down")), ("slstm", ("w_gates", "w_up"))):
            if kind in cfg.layer_kinds:
                i = cfg.layer_kinds.index(kind)
                leaves += [(f"{kind} {name}", whole["layers"][i]["cell"][name],
                            mine["layers"][i]["cell"][name]) for name in names]
        if "head" in whole["embed"]:
            leaves.append(("head", whole["embed"]["head"], mine["embed"]["head"]))
        for name, w, loc in leaves:
            K = WP.contraction(w)
            x = x_for(8, K)
            split = isinstance(loc, WP.ShardedLeaf)
            local = loc.local if split else loc
            xl = x[:, m * K // M:(m + 1) * K // M] if split and loc.k_split else x
            y = WP.apply_linear(xl, local)
            plain = WP.apply_linear(xl, WP.with_use_kernel(local, False))
            ref = None
            if not (split and loc.k_split):
                full = WP.apply_linear(x, w)
                n = y.shape[-1]
                ref = rel_err(torch, y, full[:, m * n:(m + 1) * n] if split else full)[1]
            out[name] = (kernel_of(local), ref, rel_err(torch, y, plain)[1])
        i = _first_with(whole["layers"], "mlp")
        if i >= 0 and "w_gate" in whole["layers"][i]["mlp"]:
            g, u = whole["layers"][i]["mlp"]["w_gate"], whole["layers"][i]["mlp"]["w_up"]
            lg, lu = mine["layers"][i]["mlp"]["w_gate"], mine["layers"][i]["mlp"]["w_up"]
            x = x_for(8, WP.contraction(g))
            split = isinstance(lg, WP.ShardedLeaf)
            lg, lu = (lg.local, lu.local) if split else (lg, lu)
            y = WP.apply_gate_up(x, lg, lu, cfg.activation)
            full = WP.apply_gate_up(x, g, u, cfg.activation)
            n = y.shape[-1]
            plain = WP.apply_gate_up(x, WP.with_use_kernel(lg, False),
                                     WP.with_use_kernel(lu, False), cfg.activation)
            out["gate_up"] = ("fused_gate_up" if isinstance(lg, WP.PackedLinear)
                              else "quant_matmul",
                              rel_err(torch, y, full[:, m * n:(m + 1) * n] if split else full)[1],
                              rel_err(torch, y, plain)[1])
        i = _first_with(whole["layers"], "moe")
        if i >= 0:
            out.update(_expert_checks(torch, cfg, whole["layers"][i]["moe"],
                                      mine["layers"][i]["moe"], x_for))
    return out


def _expert_checks(torch, cfg, whole: dict, mine: dict, x_for) -> dict:
    """A MoE layer's expert stacks on the rank's experts: one stacked B2 over
    its gate/up sub-stacks and one stacked B1 over its w_down sub-stack, on
    seeded (Ep, 8, K) rows, each against its plain version and against the
    whole stack's launch on the same rows (the rank's experts' rows of it)."""
    from repro_torch.core import weight_plan as WP
    from repro_torch.models import moe as MOE

    Ep = cfg.moe.n_experts_padded
    e0, ne = MOE.expert_range(mine, Ep)
    mine = {k: v.local if isinstance(v, WP.ShardedLeaf) else v for k, v in mine.items()}
    sel = slice(e0, e0 + ne)
    x = x_for(Ep, 8, cfg.d_model)
    h = WP.apply_gate_up(x[sel], mine["w_gate"], mine["w_up"], cfg.activation)
    plain = WP.apply_gate_up(x[sel], WP.with_use_kernel(mine["w_gate"], False),
                             WP.with_use_kernel(mine["w_up"], False), cfg.activation)
    full = WP.apply_gate_up(x, whole["w_gate"], whole["w_up"], cfg.activation)[sel]
    out = {f"experts [{e0}, {e0 + ne}) gate_up": ("fused_gate_up", rel_err(torch, h, full)[1],
                                                  rel_err(torch, h, plain)[1])}
    xd = x_for(Ep, 8, cfg.moe.expert_d_ff)
    y = WP.apply_linear(xd[sel], mine["w_down"])
    plain = WP.apply_linear(xd[sel], WP.with_use_kernel(mine["w_down"], False))
    full = WP.apply_linear(xd, whole["w_down"])[sel]
    out[f"experts [{e0}, {e0 + ne}) w_down"] = ("block_sparse_matmul", rel_err(torch, y, full)[1],
                                                rel_err(torch, y, plain)[1])
    return out


@contextlib.contextmanager
def _first_attention_inputs(first: dict):
    """Records into ``first`` the inputs of the first B3 launch
    ("paged_decode_attention") and the first B6 launch ("flash_attention")
    that the model path makes through ``ops``, cloned: (args, kwargs); a
    non-causal launch (an enc-dec's frames) under its own key, "<name>
    non-causal"."""
    from repro_torch.kernels import ops

    inner = {name: getattr(ops, name) for name in ("paged_decode_attention",
                                                   "flash_attention")}

    def spy(name):
        def call(*args, **kw):
            key = name if kw.get("causal", True) else f"{name} non-causal"
            if key not in first and kw.get("use_kernel", True):
                first[key] = ([a.clone() if hasattr(a, "clone") else a for a in args],
                              {k: v.clone() if hasattr(v, "clone") else v
                               for k, v in kw.items()})
            return inner[name](*args, **kw)
        return call

    for name in inner:
        setattr(ops, name, spy(name))
    try:
        yield
    finally:
        for name, f in inner.items():
            setattr(ops, name, f)


def _attention_checks(torch, first: dict) -> dict:
    """B3's and B6's recorded launches (``_first_attention_inputs``)
    replayed through the kernel and through the plain version on the same
    inputs: {name: (kernel, None, max rel err vs plain, heads)}, heads
    (q heads, kv_heads or None, the pools' KV heads) for B3 and (q heads,
    KV heads) for B6.  These launches come after the run's counts are
    read."""
    from repro_torch.kernels import flash_attention as FA

    fns = {"paged_decode_attention": FA.paged_decode_attention,
           "flash_attention": FA.flash_attention}
    out = {}
    for key, (args, kw) in first.items():
        name = key.split()[0]
        kw = dict(kw, use_kernel=True)
        got = fns[name](*args, **kw)
        want = fns[name](*args, **dict(kw, use_kernel=False))
        heads = [args[0].shape[2], args[1].shape[2]]
        if name == "paged_decode_attention":
            kv = kw.get("kv_heads")
            heads.insert(1, None if kv is None else list(kv))
        causal = "" if key == name else " non-causal"
        out[f"{name} {list(args[0].shape)}{causal}"] = (name, None,
                                                        rel_err(torch, got, want)[1], heads)
    return out


def _gloo_cuda_probe(torch, rank: int, world: int) -> list:
    """gloo's all_gather and all_reduce over the world on CUDA tensors of
    each dtype the model path sends (bf16 activations and logits, fp32
    logits, int32/int64 positions), checked exactly; returns the dtypes."""
    import torch.distributed as dist

    names = []
    for dtype in (torch.bfloat16, torch.float32, torch.int32, torch.int64):
        # small integers: every partial sum is exact in bf16, in any order
        want = [(torch.arange(12, device="cuda").reshape(3, 4) % 4 + r).to(dtype)
                for r in range(world)]
        x = want[rank]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        total = x.clone()
        dist.all_reduce(total)
        if not (all(p.is_cuda and torch.equal(p, w) for p, w in zip(parts, want))
                and total.is_cuda and torch.equal(total, sum(w.float() for w in want).to(dtype))):
            raise AssertionError(f"mesh rank {rank}: gloo's collectives on CUDA {dtype} are "
                                 f"wrong")
        names.append(str(dtype).replace("torch.", ""))
    return names


def _build_in_turn(torch, serve, args, state: dict):
    """(cfg, plan) of a model too large for every rank to build on the
    shared card at once (qwen2-moe-a2.7b: its whole fp32 draw is 57 GB,
    and ``serve.build_engine`` peaks at 73.7 GiB): the ranks take turns,
    each drawing the params leaf by leaf on the card in ``init_params``'s
    order (the same bits), packing each as ``compress`` does and moving it
    to the host at once; the card holds one fp32 leaf and its packing at a
    time.  The engines then place their pieces (and the unsharded engine
    the whole plan) from the host copy."""
    import torch.distributed as dist

    import repro_torch.configs as C
    from repro_torch.core import weight_plan as WP
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api

    cfg = C.get_config(args.arch, smoke=args.smoke)
    pc = serve.PlanConfig(default=args.compress, q_prune=args.q_prune, bk=args.block,
                          bn=args.block)
    ax_of = WP._axes_by_path(get_api(cfg).param_axes(cfg))
    leaves, by_path, plan = {}, {}, None

    def pack(path, leaf):
        packed, leaves[path] = WP.compress_leaf(path, leaf, pc, ax_of.get(path))
        by_path[path] = WP.tree_to(packed, "cpu")
        return by_path[path]

    for turn in range(dist.get_world_size()):
        if turn == state["rank"]:
            free = torch.cuda.mem_get_info()[0]
            params = T.make_params(T.param_shapes(cfg), args.seed, state["device"],
                                   leaf_fn=pack)
            plan = WP.WeightPlan(cfg=pc, leaves=leaves, params=params, _by_path=by_path)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            state["build"] = (free, torch.cuda.max_memory_allocated())
        dist.barrier()
    return cfg, plan


def _mesh_case(torch, serve, job: dict, case: str, state: dict) -> dict:
    """One case of a rank (see the module doc): builds (or reuses) the
    meshed engine and an unsharded one on the same plan, checks and serves,
    and returns what the parent compares."""
    import numpy as np

    from repro_torch.core import weight_plan as WP
    from repro_torch.core.perf_model import paged_pool_pages
    from repro_torch.distributed import shardlib as sl
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import mesh as M
    from repro_torch.serving.engine import Request, RequestState, ServingEngine

    if case == "mix":
        return _mesh_mix_case(torch, serve, job, state)
    torch.cuda.reset_peak_memory_stats()
    extra = ["--mesh", job["mesh"], "--share-card", *MESH_FLAGS.get(case, ())]
    if case == "tuned":  # the autotune phase's one-card artifact, its flags
        serve, ap, args = _tuned_args(job["tuned"], "--requests", "8", "--max-new", "16",
                                      "--prompt-len", "40", "--share-prefix", "--mesh",
                                      job["mesh"], "--share-card")
    elif case in ("long", "chunked"):
        _, ap, args = _serve_args(extra + ["--prompt-len", str(LONG_M), "--max-len", "2048"])
        args.pool_pages = 1 + paged_pool_pages(args.max_batch, LONG_M + args.max_new,
                                               args.page_size)
    else:
        _, ap, args = _serve_args(extra)
    if case == "long":
        cfg, plan, mesh, rules = state["cfg"], state["plan"], state["mesh"], state["rules"]
        engine = ServingEngine(cfg, None, plan=plan, device=state["device"],
                               config=serve.config_from_args(args, mesh=mesh, rules=rules))
    elif case == "qwen2-moe":
        cfg, plan = _build_in_turn(torch, serve, args, state)
        engine = ServingEngine(cfg, None, plan=plan, device=state["device"],
                               config=serve.config_from_args(
                                   args, mesh=state["mesh"],
                                   rules=M.rules_for(cfg, None, mesh=state["mesh"])))
    else:
        cfg, engine, plan = serve.build_engine(args, ap)
        state.update(mesh=engine.mesh, device=engine.device)
        if case == "serve":
            state.update(cfg=cfg, plan=plan, rules=engine.rules)
    extras = None
    if case in ("long", "chunked"):
        prompts = [np.asarray(p, np.int32) for p in job["long_prompts"]]
        if case == "long":
            prompts = prompts[-1:]
    elif case in MESH_EXTRAS:
        reqs0 = _extras_requests(serve, cfg, args.max_new)
        prompts, extras = [r.prompt for r in reqs0], [r.extras for r in reqs0]
    else:
        prompts = [r.prompt for r in _serve_requests(cfg, args.max_new)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the dense init's blocks: the other ranks share the card
    solo = ServingEngine(cfg, None, plan=plan, device=engine.device,
                         config=serve.config_from_args(args, draft_cfg=engine.draft_cfg,
                                                       draft_params=engine.config.spec
                                                       .draft_params))
    whole = solo.params
    if case == "qwen2-moe":
        del plan  # the host copy: both engines hold theirs on the card

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=args.max_new,
                        extras=None if extras is None else extras[i])
                for i, p in enumerate(prompts)]

    res = {"case": case, "coords": sl.mesh_coords(engine.mesh),
           "weight_bytes": engine.weight_bytes(), "whole_bytes": solo.weight_bytes()}
    if engine.slot_xpages is not None:  # the frame pages a request, the rank's frame pools
        res["xpages"] = [engine.xpages_per_seq,
                         sum(t.nbytes for pools in engine.cache["x"] for t in pools.values()),
                         sum(t.nbytes for pools in solo.cache["x"] for t in pools.values())]
    if case not in ("long", "chunked", "spec"):
        res["shards"] = _shard_checks(torch, cfg, whole, engine)
    layers = engine.params["layers"]
    i = _first_with(layers, "rec")
    if i >= 0:
        w = layers[i]["rec"]["w_out"]
        res["w_out"] = ("k_split" if isinstance(w, WP.ShardedLeaf) and w.k_split else
                        "n_split" if isinstance(w, WP.ShardedLeaf) else "whole")
        res["rec_layers"] = sum(k == "rec" for k in cfg.layer_kinds)
    i = _first_with(layers, "moe")
    if i >= 0:
        from repro_torch.models import moe as MOE

        res["experts"] = [*MOE.expert_range(layers[i]["moe"], cfg.moe.n_experts_padded),
                          cfg.moe.n_experts_padded]
        res["moe_layers"] = sum("moe" in layer for layer in layers)
    # one decode step's logits: the unsharded engine's first step, then the
    # meshed engine's, over the same admitted requests
    # a MoE model's meshed engine takes the unsharded one's expert choices
    # for the ticks compared (``_SharedRouting``: its prefills and that
    # step), then routes on its own
    # xLSTM: the first mLSTM layer's C after the first decode step
    snap = None
    if "mlstm" in cfg.layer_kinds:
        i_m = cfg.layer_kinds.index("mlstm")

        def snap(e):
            return e.cache["layers"][i_m]["C"].to("cpu", torch.float32, copy=True)
    want_lg = _first_decode_logits(solo, snap)
    routing = _SharedRouting(cfg)
    solo_reqs = requests()
    for r in solo_reqs:
        solo.submit(r)
    if case in MESH_OWN:
        solo.run_until_done()
        want = [[int(t) for t in r.output] for r in solo_reqs]
    else:
        with routing.run(record=True):
            for _ in range(10000):
                if want_lg:
                    break
                solo.step()
        want = job["want"][case]
    del solo
    got_lg = _first_decode_logits(engine, snap)
    counters = (*_served_kernels(), FA.flash_attention)
    _zero_launches(counters)
    reqs, ticks, first, reduces = requests(), [], {}, []
    with routing.run(record=False), _first_attention_inputs(first), \
            _decode_reduces(engine, reduces):
        _run_ticks(torch, engine, reqs, ticks)
    res["launches"] = {c.__name__: c.launches for c in counters}
    res["stacked"] = {c.__name__: [c.stacked_launches, c.stacked_experts]
                      for c in counters if hasattr(c, "stacked_launches")}
    res["by_t"] = {str(t): n for t, n in FA.paged_decode_attention.launches_by_t.items()}
    res["reduces"] = sorted(set(reduces))
    res["chunks"] = engine.stats.prefill_chunks
    res["attention"] = _attention_checks(torch, first)
    engine.audit_pages()
    res["finished"] = all(r.state is RequestState.FINISHED for r in reqs) \
        and engine.pages_in_use == 0 and not engine.degraded
    got = [[int(t) for t in r.output] for r in reqs]
    # teacher-forced: the rows of the slots decoding in that step whose
    # input token (the first sampled token) is the same in both engines (a
    # first token that flipped on a near-tie is held by the stream check)
    live = torch.as_tensor(want_lg[0][2], dtype=torch.long)
    same = live[got_lg[0][0][live] == want_lg[0][0][live]]
    res["logit_err"] = float("inf")  # no row to hold: fails the check
    if len(same):
        diff = (got_lg[0][1][same] - want_lg[0][1][same]).abs().max().item()
        res["logit_err"] = diff / want_lg[0][1][same].abs().max().item()
    res["logit_rows"] = [len(same), len(live)]
    if snap is not None and len(same):  # the rank's heads of the unsharded engine's C
        mine, whole_c = got_lg[0][3][same], want_lg[0][3][same]
        nh = mine.shape[1]
        h0 = sl.mesh_coords(engine.mesh)["model"] * nh if nh < whole_c.shape[1] else 0
        ref_c = whole_c[:, h0:h0 + nh]
        res["mlstm_c"] = [h0, nh, (mine - ref_c).abs().max().item() / ref_c.abs().max().item()]
    res["route_flips"] = [routing.flips, routing.total]
    res["n_diff"] = _streams_near_tie(torch, cfg, whole,
                                      f"mesh {job['mesh']} {case} rank {state['rank']}",
                                      prompts, want, got, extras)
    res["digest"] = token_digest(got)
    res["tick_ms"] = _decode_tick_ms(ticks)
    res["max_mem"] = torch.cuda.max_memory_allocated()
    if case == "qwen2-moe":  # its build, in the rank's turn, before the engines
        res["build"] = state.pop("build")
    del engine, whole
    torch.cuda.empty_cache()
    return res


def _mesh_mix_case(torch, serve, job: dict, state: dict) -> dict:
    """The mixed phase's ``--workload-mix`` on the mesh: this rank's mixed
    engine (every member on the mesh, one shared allocator on the host)
    serves the phase's requests tick by tick, every member auditing every
    tick and the union audit every tick; returns each member's streams
    (held to the mixed phase's by the near-tie rule), the free list's
    digest after every tick, the launches, bytes, memory and rank 0's
    tick."""
    import hashlib
    import warnings

    from repro_torch.distributed import shardlib as sl
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.engine import RequestState

    torch.cuda.reset_peak_memory_stats()
    ap, args = _mix_args("--mesh", job["mesh"], "--share-card")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the contiguous member's paging warning
        mix, apis, engine = serve.build_mixed(args, ap)
    for e in engine.engines.values():
        e.audit_every_step = True
    engine._audit_every_step = True
    first = next(iter(engine.engines.values()))
    reqs = serve.mixed_requests(args, mix, apis, engine)
    counters = (*_served_kernels(), FA.flash_attention)
    _zero_launches(counters)
    for arch, r in reqs:
        engine.submit(arch, r)
    torch.cuda.synchronize()
    ticks, frees = [], hashlib.sha256()
    while engine._busy():
        s0 = engine.aggregate_stats()
        t = time.perf_counter()
        engine.step()  # with the union audit
        torch.cuda.synchronize()
        s1 = engine.aggregate_stats()
        ticks.append((time.perf_counter() - t, s1.prefills - s0.prefills,
                      s1.decode_steps - s0.decode_steps))
        frees.update(repr(engine.allocator._free).encode())
    got = {}
    for arch, r in reqs:
        got.setdefault(arch, []).append([int(t) for t in r.output])
    n_diff = {}
    for arch, eng in engine.engines.items():
        want = job["want"]["mix"][arch]
        mine = [r for a, r in reqs if a == arch]
        if got[arch] != want:  # the member's whole weights for the near-tie rule
            cfg = eng.cfg
            whole = apis[arch][1].unstack(cfg, apis[arch][1].init_params(cfg, args.seed,
                                                                         device=eng.device))
            n_diff[arch] = _streams_near_tie(
                torch, cfg, whole, f"mesh {job['mesh']} mix {arch} rank {state['rank']}",
                [r.prompt for r in mine], want, got[arch], [r.extras for r in mine])
            del whole
        else:
            n_diff[arch] = 0
    dec = [t for t, p, d in ticks if p == 0 and d > 0]
    res = {"case": "mix", "coords": sl.mesh_coords(first.mesh),
           "weight_bytes": sum(e.weight_bytes() for e in engine.engines.values()),
           "kv": {a: e.kv_parallel for a, e in engine.engines.items()},
           "launches": {c.__name__: c.launches for c in counters},
           "finished": all(r.state is RequestState.FINISHED for _, r in reqs)
           and engine.allocator.used_pages == 0,
           "n_diff": n_diff, "frees": frees.hexdigest(), "ticks": engine.tick,
           "tick_ms": [1e3 * statistics.median(dec), len(dec)],
           "digest": token_digest([got[a] for a in sorted(got)]),
           "max_mem": torch.cuda.max_memory_allocated()}
    del engine
    torch.cuda.empty_cache()
    return res


def _mesh_rank(rank: int, job: dict) -> None:
    """A rank of the mesh phase: its cases, its results to ``job["out"]``."""
    import io

    import torch

    from repro_torch.launch import serve

    _cut_depths(job.get("cuts"))  # the configs the earlier phases served

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.distributed as dist

    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext()
    state: dict = {"rank": rank}
    results = []
    with quiet:
        gloo = _gloo_cuda_probe(torch, rank, dist.get_world_size())
        for case in job["cases"]:
            results.append(_mesh_case(torch, serve, job, case, state))
            # a case's engines sit in reference cycles (the spies on their
            # steps): free them before the next case builds on the shared card
            gc.collect()
            torch.cuda.empty_cache()
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"gloo_cuda": gloo, "cases": results}, f)


def phase_mesh(torch, want: dict, long_prompts: list, card: str) -> None:
    """Sharded serving (see the module doc): each of MESH_RUNS spawns its
    ranks on the card over gloo and checks what they return.  ``want``:
    the earlier phases' streams of each case (serve, long, spec, chunked,
    granite, qwen2-moe, rg, xlstm, whisper, internvl, mix)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    if len(long_prompts[-1]) != LONG_M:
        raise AssertionError("mesh: the long phase's last prompt is not the LONG_M one")
    log(f"mesh: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB of the "
        f"card ({torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free) as the ranks start")
    for spec, cases in MESH_RUNS:
        job = {"want": want, "long_prompts": [[int(t) for t in p] for p in long_prompts]}
        for ci, rows in enumerate(_mesh_run(torch, spec, cases, job)):
            _check_mesh_case(spec, cases[ci], rows, card)
    log(f"mesh: phase {time.perf_counter() - t_phase:.1f}s")


def _mesh_run(torch, spec: str, cases: tuple, job: dict) -> list:
    """Spawns the ranks of mesh ``spec`` on the card over gloo, each serving
    ``cases`` (``job`` adds what they need); returns each case's rows, one
    a rank."""
    import tempfile

    from repro_torch.launch import mesh as M

    d, m = M.parse_mesh(spec, "cuda")
    world = d * m
    backend = M.choose_backend(world, "cuda", share_card=True)
    with tempfile.TemporaryDirectory() as out:
        job = dict(job, mesh=spec, cases=cases, out=out)
        t0 = time.perf_counter()
        M.spawn_ranks(_mesh_rank, (job,), world, backend)
        runs, gloo = [], []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                got = json.load(f)
            runs.append(got["cases"])
            gloo.append(got["gloo_cuda"])
    log(f"mesh {spec}: {world} ranks over {backend} (ranks sharing one card) ran "
        f"{', '.join(cases)} in {time.perf_counter() - t0:.1f}s; {backend}'s all_gather "
        f"and all_reduce on CUDA {', '.join(gloo[0])} exact on every rank")
    return [[run[ci] for run in runs] for ci in range(len(cases))]


def _check_mesh_mix(spec: str, rows: list, card: str) -> None:
    """Logs and checks the mix case's rows (one a rank): every request
    finished with the pool empty and every audit clean, each member's
    streams the mixed phase's (near-tie rule), the same free list after
    every tick and the same tick count on every rank, launches equal
    within a data replica."""
    label = f"mesh {spec} mix"
    for r, row in enumerate(rows):
        log(f"{label} rank {r} {row['coords']}: weight bytes {row['weight_bytes']:,} (its "
            f"members' shards; kv shard degree {row['kv']}); stream tokens that differ "
            f"(near-tie rule) {row['n_diff']}; launches {row['launches']}; "
            f"max_memory_allocated {row['max_mem'] / 2**30:.2f} GiB; union audit clean every "
            f"one of {row['ticks']} ticks; free lists {row['frees'][:16]}; tokens "
            f"{row['digest']}")
        if not row["finished"]:
            raise AssertionError(f"{label} rank {r}: a request did not finish or a page leaked")
        for k in MESH_CASE_KERNELS["mix"]:
            if row["launches"][k] <= 0:
                raise AssertionError(f"{label} rank {r}: {k} was not launched")
    if len({(row["frees"], row["ticks"]) for row in rows}) != 1:
        raise AssertionError(f"{label}: the ranks' free lists or tick counts differ")
    for data in {row["coords"]["data"] for row in rows}:
        peers = [row["launches"] for row in rows if row["coords"]["data"] == data]
        if any(p != peers[0] for p in peers):
            raise AssertionError(f"{label}: launches differ within data replica {data}: "
                                 f"{peers}")
    ms, n = rows[0]["tick_ms"]
    log(f"{label}: rank 0's median mixed tick {ms:.3f} ms over {n} ticks with no prefill "
        f"(ranks sharing one card over gloo: not a multi-card speed) ({card})")


def _check_mesh_case(spec: str, case: str, rows: list, card: str, kernels=None,
                     attention=None) -> None:
    """Logs and checks one case's rows (one a rank); raises on any miss.
    ``kernels`` / ``attention``: the kernels the run must launch and the
    attention launches it replays, where MESH_CASE_KERNELS /
    MESH_CASE_ATTENTION do not say (a tuned plan's)."""
    if case == "mix":
        return _check_mesh_mix(spec, rows, card)
    label = f"mesh {spec} {case}"
    M = int(spec.split("x")[1])
    for r, row in enumerate(rows):
        log(f"{label} rank {r} {row['coords']}: weight bytes {row['weight_bytes']:,} "
            f"of {row['whole_bytes']:,} whole; step logits max |d| "
            f"{row['logit_err']:.3e} of the largest over {row['logit_rows'][0]} of "
            f"{row['logit_rows'][1]} rows"
            + (f" (its first tick took the unsharded one's expert choices, "
               f"{row['route_flips'][0]} of {row['route_flips'][1]} its own routing would "
               f"have sent elsewhere)" if row["route_flips"][1] else "")
            + f"; {row['n_diff']} stream tokens "
            f"differ (near-tie rule); launches {row['launches']}; stacked (launches, "
            f"experts) {row['stacked']}; B3 by T {row['by_t']}; all-reduces a decode step "
            f"{row['reduces']}; max_memory_allocated {row['max_mem'] / 2**30:.2f} GiB"
            + (f" (its build in its turn: {row['build'][1] / 2**30:.2f} GiB, the card "
               f"{row['build'][0] / 2**30:.2f} GiB free at its start)"
               if "build" in row else "") + "; "
            f"tokens {row['digest']}")
        if "xpages" in row:
            n, mine, whole = row["xpages"]
            log(f"{label} rank {r}: {n} frame pages a request; its frame pools {mine:,} of "
                f"{whole:,} bytes whole")
        if "mlstm_c" in row:
            h0, nh, err = row["mlstm_c"]
            log(f"{label} rank {r}: the first mLSTM layer's C after the first decode step, "
                f"heads [{h0}, {h0 + nh}), max |d| {err:.3e} of the largest against the "
                f"one-card engine's")
            if not err <= PATH_RTOL:
                raise AssertionError(f"{label} rank {r}: the mLSTM's C differs by {err:.3e}")
        for name, (kern, vs_whole, vs_plain) in row.get("shards", {}).items():
            log(f"{label} rank {r} {name}: {kern} on its shard, max rel err vs the "
                f"whole leaf's columns {vs_whole if vs_whole is None else f'{vs_whole:.3e}'}"
                f", vs plain {vs_plain:.3e}")
            if max(vs_plain, vs_whole or 0.0) > KERNEL_RTOL:
                raise AssertionError(f"{label} rank {r}: {name} on its shard disagrees")
        for name, (kern, _, vs_plain, heads) in row["attention"].items():
            log(f"{label} rank {r} {name}: {kern} on its heads "
                + (f"({heads[0]} q, kv_heads {heads[1]} of the pools' {heads[2]})"
                   if kern == "paged_decode_attention"
                   else f"({heads[0]} q, {heads[1]} KV)")
                + f", its run's first launch replayed: max rel err vs plain "
                f"{vs_plain:.3e}")
            if not vs_plain <= KERNEL_RTOL:
                raise AssertionError(f"{label} rank {r}: {kern} on its heads disagrees "
                                     f"with plain")
            # 1x8: a rank's 4 q heads read KV head m // 2 of the 4 in its pools
            if (spec == "1x8" and kern == "paged_decode_attention"
                    and heads[1] != [row["coords"]["model"] // 2, 1]):
                raise AssertionError(f"{label} rank {r}: B3 read kv_heads {heads}")
            # spec: the first B3 launch is a verify step's, T = k + 1
            if case == "spec" and kern == "paged_decode_attention" \
                    and json.loads(name.split(" ", 1)[1])[1] != SPEC_K + 1:
                raise AssertionError(f"{label} rank {r}: the first B3 launch is {name}")
        want_attn = attention if attention is not None else \
            MESH_CASE_ATTENTION.get(case, ("paged_decode_attention",))
        if sorted(v[0] for v in row["attention"].values()) != sorted(want_attn):
            raise AssertionError(f"{label} rank {r}: replayed {row['attention'].keys()}, "
                                 f"want {want_attn}")
        if not row["finished"]:
            raise AssertionError(f"{label} rank {r}: a request did not finish, a page "
                                 f"leaked or the ladder triggered")
        if row["logit_err"] > PATH_RTOL:
            raise AssertionError(f"{label} rank {r}: the step's logits differ from the "
                                 f"unsharded step's by {row['logit_err']:.3e}")
        for k in kernels or MESH_CASE_KERNELS.get(case, MESH_KERNELS):
            if row["launches"][k] <= 0:
                raise AssertionError(f"{label} rank {r}: {k} was not launched")
        if case == "spec" and row["by_t"].get(str(SPEC_K + 1), 0) <= 0:
            raise AssertionError(f"{label} rank {r}: B3 never launched at T = {SPEC_K + 1}")
        if case == "chunked" and (row["chunks"] <= 0 or row["launches"]["flash_attention"]):
            raise AssertionError(f"{label} rank {r}: {row['chunks']} chunks, a chunk reached "
                                 f"B6: {row['launches']}")
        if "experts" in row:
            e0, ne, Ep = row["experts"]
            if ne * M != Ep or e0 != row["coords"]["model"] * ne:
                raise AssertionError(f"{label} rank {r}: experts [{e0}, {e0 + ne}) of {Ep}")
            for name in ("block_sparse_matmul", "fused_gate_up"):
                n, covered = row["stacked"][name]
                if n <= 0 or covered != n * ne:
                    raise AssertionError(f"{label} rank {r}: {n} stacked {name} launches over "
                                         f"{covered} experts (each over the rank's {ne})")
            # at least one all-reduce a MoE layer: its experts' partial sums
            # (with the shared experts' partial product, where it is one)
            if not row["reduces"] or min(row["reduces"]) < row["moe_layers"]:
                raise AssertionError(f"{label} rank {r}: all-reduces a step {row['reduces']} "
                                     f"for {row['moe_layers']} MoE layers")
        if case == "rg quant":
            if row["w_out"] != "k_split" or min(row["reduces"]) < row["rec_layers"]:
                raise AssertionError(f"{label} rank {r}: w_out {row['w_out']}, all-reduces a "
                                     f"step {row['reduces']} for {row['rec_layers']} RG-LRU "
                                     f"layers")
    for data in {row["coords"]["data"] for row in rows}:
        peers = [row["launches"] for row in rows if row["coords"]["data"] == data]
        if any(p != peers[0] for p in peers):
            raise AssertionError(f"{label}: launches differ within data replica {data}: "
                                 f"{peers}")
    if "w_out" in rows[0]:
        log(f"{label}: the RG-LRU's w_out on every rank: {rows[0]['w_out']} "
            f"({'its partial sum all-reduced' if rows[0]['w_out'] == 'k_split' else 'a packed leaf splits block columns only (C1): the channels are gathered first'})")
    ms, n = rows[0]["tick_ms"]
    log(f"{label}: rank 0's median decode tick {ms:.3f} ms over {n} ticks (ranks "
        f"sharing one card over gloo: not a multi-card speed) ({card})")


def phase_parity(torch, cfg, engine) -> None:
    """The served quant_sparse plan, then a --compress quant plan of the same
    model whose every projection and head is a 2-D int8 leaf (kernel B5)."""
    from repro_torch.core.weight_plan import PlanConfig, QuantLinear, compress, map_tree
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_gate_up as FG
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    _path_parity(torch, cfg, engine.params, "quant_sparse", gen)

    dense = get_api(cfg).init_params(cfg, 0, device="cuda")
    params = T.unstack(cfg, compress(dense, PlanConfig(default="quant")).params)
    del dense
    quant_leaves = []
    map_tree(lambda path, n: quant_leaves.append(path)
             if isinstance(n, QuantLinear) and not path.endswith("tok") else None, params)
    packed = (BS.block_sparse_matmul, FG.fused_gate_up)
    _zero_launches((*packed, QM.quant_matmul, FA.flash_attention))
    _path_parity(torch, cfg, params, "quant", gen)
    _b5_all_wgmma("parity quant")
    # kernels path only: 3 prefills + 24 decode steps, each leaf once per
    # call; B6 once per layer in the LONG_M prefill
    want = len(quant_leaves) * (3 + 24)
    log(f"parity quant: {len(quant_leaves)} int8 matmul leaves; B5 launches "
        f"{QM.quant_matmul.launches} (expected {want}), B1/B2 "
        f"{[c.launches for c in packed]}, B6 {FA.flash_attention.launches} "
        f"(expected {cfg.n_layers})")
    if QM.quant_matmul.launches != want or any(c.launches for c in packed):
        raise AssertionError("the --compress quant plan did not run every projection through B5")
    if FA.flash_attention.launches != cfg.n_layers:
        raise AssertionError("the long prefill did not run every layer's attention through B6")
    torch.cuda.empty_cache()


def phase_softcap(torch, results: dict, cfg, engine, card: str) -> None:
    """The serve cell's model and plan with ``logit_softcap`` = SOFTCAP (no
    config of the registry sets one; the weights are the serve phase's): the
    8 requests through the kernels -- B1, B2, B3 (capped) and B5 must launch,
    B4 not -- and through the plain versions, streams by the near-tie rule;
    ``_path_parity`` at 36, 40 and LONG_M tokens, whose LONG_M prefill runs
    capped B6 once a layer; teacher-forced verify steps (B3 capped at T =
    SPEC_K + 1) against the plain versions.  The capped B3 and hd-64 B6 rows
    take these launches."""
    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.engine import ServingEngine

    serve, _, args = _serve_args()
    capped = dataclasses.replace(cfg, logit_softcap=SOFTCAP)
    eng = ServingEngine(capped, engine.params, plan=engine.plan, device=engine.device,
                        config=engine.config)
    outputs, launches, dt = _serve_and_check(serve, eng, capped, args.max_new, "softcap")
    by_t = dict(FA.paged_decode_attention.launches_by_t)
    if launches.pop("block_sparse_matmul_col"):
        raise AssertionError("softcap: B4 launched, but every served leaf carries its walk")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"softcap: kernel {name} was not launched on the capped path")
    _row(results, "paged_decode_attention", "cap30 serve")["launches"] = by_t.get(1, 0)
    log(f"softcap {SOFTCAP:g}: {eng.stats.completed}/8 FINISHED, B3 launches by query "
        f"positions {by_t}, {eng.stats.decode_tokens / dt:.1f} tok/s on {card}")

    plain = _engine_like(eng, engine.plan, params=with_use_kernel(engine.params, False))
    plain.attention_kernel = False
    p_out, p_launches, _ = _serve_and_check(serve, plain, capped, args.max_new, "softcap plain")
    if any(p_launches.values()):
        raise AssertionError(f"softcap plain: a kernel launched on the plain path: {p_launches}")
    prompts = [r.prompt for r in _serve_requests(capped, args.max_new)]
    _streams_near_tie(torch, capped, plain.params, "softcap kernels vs plain", prompts, p_out,
                      outputs)
    del plain, eng

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    _zero_launches((*_served_kernels(), FA.flash_attention))
    _path_parity(torch, capped, engine.params, f"softcap {SOFTCAP:g} quant_sparse", gen)
    by_w = dict(FA.flash_attention.launches_by_window)
    log(f"softcap: B6 launches {FA.flash_attention.launches}, by window {by_w}")
    if FA.flash_attention.launches != capped.n_layers or by_w != {0: capped.n_layers}:
        raise AssertionError(f"softcap: the capped LONG_M prefill did not run every layer's "
                             f"attention through B6 ({by_w})")
    _row(results, "flash_attention", "cap30 hd64")["launches"] = FA.flash_attention.launches
    FA.paged_decode_attention.launches_by_t.clear()
    _verify_parity(torch, capped, engine.params, gen, label="softcap")
    n5 = FA.paged_decode_attention.launches_by_t.get(SPEC_K + 1, 0)
    if n5 <= 0:
        raise AssertionError(f"softcap: B3 never launched at T = {SPEC_K + 1}")
    _row(results, "paged_decode_attention", "cap30 verify")["launches"] = n5
    torch.cuda.empty_cache()


def _profile_steps(torch, cfg, params, steps: int, B: int = 8, start: int = 0) -> tuple:
    """``steps`` decode steps at batch ``B`` (paged int8 KV, positions from
    ``start`` + 2) timed on the host clock, then as many under
    torch.profiler.  Returns (wall ms per step, profiled wall ms per step,
    [(device ms, calls, kernel name)])."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    ps = 16
    P = -(-(start + 2 + 2 * steps) // ps)
    cache = T.init_cache(cfg, B, P * ps, torch.bfloat16, kv_dtype=torch.int8,
                         page_size=ps, num_pages=1 + B * P, device="cuda")
    cache["page_table"].copy_(1 + torch.arange(B * P, device="cuda").reshape(B, P))
    tok = torch.zeros((B, 1), dtype=torch.long, device="cuda")

    def step(t):
        pos = torch.full((B,), start + t, dtype=torch.int32, device="cuda")
        return T.decode_step(cfg, params, cache, tok, pos)[0]

    for t in range(2):
        step(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(2, 2 + steps):
        step(t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2 + steps, 2 + 2 * steps):
            step(t)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms / steps, prof_wall_ms / steps, _device_rows(torch, prof)


def _device_rows(torch, prof) -> list:
    """[(device ms, calls, kernel name)] of a profile, largest first:
    kernels only, since operator rows would count their kernels twice."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def _profile_prefill(torch, cfg, params) -> None:
    """Where a LONG_M-token prefill's device time goes, kernels on: B6's
    share against B1 and B2."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    prompt = torch.randint(0, cfg.vocab, (1, LONG_M), generator=gen, device="cuda")

    def run():
        cache = T.init_cache(cfg, 1, LONG_M, torch.bfloat16, kv_dtype=torch.int8, device="cuda")
        return T.prefill(cfg, params, prompt, cache)[0]

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = _device_rows(torch, prof)
    dev = sum(r[0] for r in rows)
    log(f"profile: prefill of {LONG_M} tokens: wall {wall:.3f} ms, device busy {dev:.3f} ms "
        f"({dev / wall:.3f} of the unprofiled wall)")
    for ms, n, name in rows[:12]:
        log(f"profile:   {ms:9.4f} ms  {n:5d} calls  {name[:90]}")
    for label, key in (("B1", "bsmm_kernel"), ("B2", "fused_gate_up_kernel"),
                       ("B6", "flash_fwd")):
        ms = sum(r[0] for r in rows if key in r[2])
        log(f"profile: prefill share of {label}: {ms:.3f} ms, {ms / dev:.4f} of device time")


def phase_profile(torch, cfg, engine, steps: int = 6) -> None:
    """Where a decode step's time goes, kernels on; then the same steps with
    the int8 head on its plain version (fp32 cast + matmul), so that the
    head's device time before and after B5 is the difference; then the
    plan without its walks (every projection through B4); then 4 sequences
    at contexts past LONG_M - 16 (B3 over ~127 pages each).  The device-busy
    share is the profiled device time over the unprofiled wall time (the
    profiler slows the host, not the kernels).  Last, one LONG_M-token
    prefill's breakdown."""
    from repro_torch.core import weight_plan as W

    embed = engine.params["embed"]
    head = dataclasses.replace(embed["head"], use_kernel=False)
    plain_head = {**engine.params, "embed": {**embed, "head": head}}
    walkless = W.map_tree(lambda _, n: dataclasses.replace(n, walk=None)
                          if isinstance(n, W.PackedLinear) else n, engine.params)
    busy = {}
    runs = (("B5 head", engine.params, 8, 0), ("plain head", plain_head, 8, 0),
            ("walk-less, B4", walkless, 8, 0),
            (f"contexts {LONG_M - 16}+", engine.params, 4, LONG_M - 16))
    for label, params, B, start in runs:
        wall, prof_wall, rows = _profile_steps(torch, cfg, params, steps, B, start)
        dev = sum(r[0] for r in rows) / steps
        busy[label] = dev
        log(f"profile ({label}): {steps} decode steps at batch {B}: wall {wall:.3f} ms/step "
            f"({prof_wall:.3f} under the profiler), device busy {dev:.3f} ms/step "
            f"({dev / wall:.3f} of the unprofiled wall)")
        for ms, n, name in rows[:12]:
            log(f"profile:   {ms / steps:9.4f} ms/step  {n // steps:5d} calls/step  {name[:90]}")
        for kname, key in (("B3", "paged_decode_kernel"), ("B5", "quant_matmul")):
            ms = sum(r[0] for r in rows if key in r[2])
            n = sum(r[1] for r in rows if key in r[2])
            log(f"profile ({label}): {kname} {ms / steps:.4f} ms/step in {n // steps} calls/step")
    log(f"profile: the head costs {busy['plain head'] - busy['B5 head']:.4f} ms/step more "
        f"device time on its plain version than through B5")
    log(f"profile: the walk-less plan (B4) takes {busy['walk-less, B4']:.4f} ms/step of "
        f"device time, the walk plan (B1) {busy['B5 head']:.4f}")
    _profile_prefill(torch, cfg, engine.params)


# ---------------------------------------------------------------------------
# the dense families: llama3.2-1b (hd 64, tied), glm4-9b (hd 128, G 16, an
# untied int8 head at vocab 151552), gemma3-4b (hd 256, G 2, 5:1 local:global
# layers with window 1024, tied)
# ---------------------------------------------------------------------------

FAMILIES = ("llama3.2-1b", "glm4-9b", "gemma3-4b")
# the families whose 2032-token prompt runs B6 at a new head dim, and whose
# self-draft speculation runs B3's verify step at a new head dim
FAMILY_LONG = ("glm4-9b", "gemma3-4b")
# the chunked run on gemma3-4b: prompts within the 1024-token window (a ring
# that never wraps, so a chunk sees every key a synchronous prefill sees)
GEMMA_CHUNK_PROMPTS = (40, 600, 1000)
GEMMA_CHUNK_FLAGS = dict(prefill_chunk=256, prefill_budget=512)


def _row(results: dict, name: str, key: str) -> dict:
    """The kernel row of ``results[name]`` tagged ``key``."""
    return next(r for r in results[name]["rows"] if r.get("key") == key)


def _add_row(results: dict, name: str, row: dict, err: float, rel: float) -> None:
    """Append ``row`` to kernel ``name``'s rows and fold its errors into
    the kernel's maxima.  Its launches stay None until the phase that runs
    its shape on a served path counts them (``_check_family_rows``)."""
    r = results.setdefault(name, {})
    r.setdefault("rows", []).append(dict(row, max_abs_err=err, max_rel_err=rel, launches=None))
    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
    r["max_rel_err"] = max(r.get("max_rel_err", 0.0), rel)


def _b6_row(torch, timer, gen, results, key, H, KVH, hd, window=None, S=2048,
            softcap: float = 0.0) -> None:
    """B6 at one family's long prefill (B 1, S = 2048 tokens, causal, bf16):
    held to its plain version, launched twice for the same bits, timed
    beside the plain version and SDPA on the same inputs.  ``softcap`` > 0:
    the capped kernel on queries scaled by CAP_Q_SCALE (the cap bends the
    scores), its yardstick one capped ``flex_attention`` call (also held to
    the plain version within PATH_RTOL: it scores in bf16)."""
    from repro_torch.kernels import flash_attention as FA

    q = torch.randn((1, S, H, hd), generator=gen, device="cuda")
    q = (q * (CAP_Q_SCALE if softcap else 1.0)).to(torch.bfloat16)
    k = torch.randn((1, S, KVH, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(k.shape, generator=gen, device="cuda").to(torch.bfloat16)
    cap = f" cap {softcap:g}" if softcap else ""
    label = (f"B6 hd {hd} S={S} H={H}/{KVH} causal{f' window {window}' if window else ''}"
             f"{cap} bf16")
    kw = dict(window=window, softcap=softcap)
    o = FA.flash_attention(q, k, v, **kw)
    want = FA.flash_attention(q, k, v, use_kernel=False, **kw)
    d, r = _held(torch, label, o, want, KERNEL_RTOL)
    _deterministic(torch, label, o, FA.flash_attention(q, k, v, **kw))
    nbytes = 2 * (q.numel() * 2 + k.numel() * 2)
    # the cap's tanh, a division and a product a score, is not a tensor-core
    # operation: the bound counts the products only
    flops = 4.0 * hd * H * _visible_pairs(S, S, True, window)
    b_ms, b_by = bound(nbytes, flops)
    ms = timer(lambda: FA.flash_attention(q, k, v, **kw))
    plain_ms = timer(lambda: FA.flash_attention(q, k, v, use_kernel=False, **kw))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if softcap:
        flex = _flex_capped(torch, q, k, v, softcap, window=window)
        _held(torch, f"{label}: flex_attention (the yardstick)", flex(), want, PATH_RTOL)
        lib_ms = timer(flex)
        lib = "flex_attention(capped score_mod, eager)"
    elif window is None:
        lib_ms = timer(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
        lib = "SDPA(is_causal, enable_gqa)"
    else:
        i = torch.arange(S, device="cuda")
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        lib_ms = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
        lib = "SDPA(boolean band mask, enable_gqa)"
    log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib} {lib_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
    _add_row(results, "flash_attention", {
        "key": key, "shape": f"B=1 S={S} H={H} KVH={KVH} hd={hd} causal"
                             f"{f' window {window}' if window else ''}{cap} bf16",
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by}, d, r)


def _b3_row(torch, timer, gen, results, key, H, KVH, hd, T, prefix=0, P=8,
            int8=True, B=8, softcap: float = 0.0) -> None:
    """B3 at one family's serve step (T 1) or verify step (T 5): B (8)
    sequences at the serve phase's contexts (after ``prefix`` positions of
    a VLM's patches; the 8 repeat past the eighth), int8 pages of 16 (bf16
    where ``int8`` is False), ``P`` pages a sequence, sequences 1-3 sharing
    sequence 0's first page; held to its plain version, twice for the same
    bits, timed beside SDPA on the gathered bf16 K/V.  ``softcap`` > 0: the
    capped kernel on queries scaled by CAP_Q_SCALE, its yardstick one capped
    ``flex_attention`` call on the gathered bf16 K/V (held to the plain
    version within PATH_RTOL: K/V rounded to bf16, scores in bf16)."""
    from repro_torch.kernels import flash_attention as FA

    ps = 16
    ctx = [(36, 40, 40, 40, 40, 40, 40, 40)[i % 8] + 8 + prefix for i in range(B)]
    pos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32, device="cuda")
    table = (1 + torch.randperm(B * P, generator=gen, device="cuda")).reshape(B, P)
    table[1:4, 0] = table[0, 0]
    table = table.to(torch.int32).contiguous()
    shape = (1 + B * P, ps, KVH, hd)
    if int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        kw = dict(
            k_scale_pages=torch.rand(shape[:3], generator=gen, device="cuda") * 0.02 + 0.005,
            v_scale_pages=torch.rand(shape[:3], generator=gen, device="cuda") * 0.02 + 0.005)
    else:
        kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        kw = {}
    q = torch.randn((B, T, H, hd), generator=gen, device="cuda")
    q = (q * (CAP_Q_SCALE if softcap else 1.0)).to(torch.bfloat16)
    kind = "int8" if int8 else "bf16"
    cap = f" cap {softcap:g}" if softcap else ""
    label = f"B3 {kind} hd {hd} B={B} T={T} H={H}/{KVH}{cap}"
    if softcap:
        kw["softcap"] = softcap
    o = FA.paged_decode_attention(q, kp, vp, table, pos, **kw)
    want = FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False, **kw)
    d, r = _held(torch, label, o, want, KERNEL_RTOL)
    _deterministic(torch, label, o, FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
    b_ms, b_by = (_b3_bound(q, table, pos, ps, KVH, hd, H) if int8 else
                  _b3_bound(q, table, pos, ps, KVH, hd, H, elem=2, scale_bytes=0))
    ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, **kw))
    plain_ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, use_kernel=False,
                                                       **kw))
    if softcap:
        flex = _flex_capped(torch, q, *_gathered_bf16(torch, kp, vp, kw.get("k_scale_pages"),
                                                      kw.get("v_scale_pages"), table),
                            softcap, q_pos=pos)
        _held(torch, f"{label}: flex_attention (the yardstick)", flex(), want, PATH_RTOL)
        lib_ms, lib = timer(flex), "flex_attention(capped score_mod, gathered bf16)"
    else:
        lib_ms = timer(_sdpa_gathered(torch, q, kp, vp, kw.get("k_scale_pages"),
                                      kw.get("v_scale_pages"), table, pos))
        lib = "SDPA(gathered bf16)"
    log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib} "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    pos_s = ("/".join(map(str, pos.tolist())) if B <= 8 else
             f"{int(pos.min())}..{int(pos.max())}")
    _add_row(results, "paged_decode_attention", {
        "key": key, "shape": f"B={B} T={T} H={H} KVH={KVH} hd={hd} {kind} pages of 16, pos "
                             f"{pos_s}{' (verify)' if T > 1 else ''}{cap}",
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by}, d, r)


def _b2_row(torch, timer, gen, results, key="gelu", K=2560, N=10240, act="gelu_glu",
            Ms=(40, 8), q=0.5) -> None:
    """B2 with the ``act`` epilogue at a gate/up pair at q ``q``: gemma3's
    2560 x 10240 (80 block-columns) with gelu_glu by default,
    recurrentgemma's 2560 x 7680; at each M of ``Ms`` (the default: a
    40-token prefill and the serve batch of 8) held to its plain version,
    twice for the same bits, timed at the last beside one torch.matmul on
    the dequantized [Wg | Wu]."""
    from repro_torch.kernels import fused_gate_up as FG

    g, u = _packed(torch, K, N, gen, q), _packed(torch, K, N, gen, q)
    ga, ua = (g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts)
    err = rel = 0.0
    for M in Ms:
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        y = FG.fused_gate_up(x, ga, ua, g.scales, u.scales, activation=act)
        d, r = _held(torch, f"B2 {act} {K}x{N} M={M}", y,
                     FG.fused_gate_up(x, ga, ua, g.scales, u.scales, activation=act,
                                      use_kernel=False), KERNEL_RTOL)
        err, rel = max(err, d), max(rel, r)
        _deterministic(torch, f"B2 {act} M={M}", y,
                       FG.fused_gate_up(x, ga, ua, g.scales, u.scales, activation=act))
    surv = int(g.counts.sum() + u.counts.sum())
    nbytes = M * K * 2 + surv * (128 * 128 + 4) + 2 * (N // 128) * 4 + 2 * N * 4 + M * N * 2
    b_ms, b_by = bound(nbytes, 2.0 * M * surv * 128 * 128)
    wgu = torch.cat([_dense_bf16(torch, g), _dense_bf16(torch, u)], dim=1)
    ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales, activation=act))
    plain_ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales,
                                              activation=act, use_kernel=False))
    lib_ms = timer(lambda: torch.matmul(x, wgu))
    log(f"B2 {act} {K}x{N} M={M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul("
        f"dense [Wg|Wu] bf16) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    _add_row(results, "fused_gate_up", {
        "key": key, "shape": f"{K}x{N} gate+up {act} at M={M}" + (f" q {q}" if q != 0.5 else ""),
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by}, err, rel)


def phase_family_kernels(torch, results: dict) -> None:
    """The kernels at the dense families' new shapes, each against its plain
    version: B6 at hd 128 (glm4-9b's 32/2 heads) and hd 256 (gemma3-4b's
    8/4, causal and under its 1024-token window), B3 at hd 128 and 256 at
    the serve and verify steps, B2 with gelu_glu at gemma3's gate/up."""
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    _b6_row(torch, timer, gen, results, "hd128", 32, 2, 128)
    _b6_row(torch, timer, gen, results, "hd256", 8, 4, 256)
    _b6_row(torch, timer, gen, results, "hd256 window", 8, 4, 256, window=1024)
    for hd, H, KVH in ((128, 32, 2), (256, 8, 4)):
        _b3_row(torch, timer, gen, results, f"hd{hd} serve", H, KVH, hd, 1)
        _b3_row(torch, timer, gen, results, f"hd{hd} verify", H, KVH, hd, SPEC_K + 1)
    _b2_row(torch, timer, gen, results)


def _engine_like(engine, plan, params=None, **changes):
    """A new engine over ``engine``'s plan (or ``params``) with its config
    changed by ``changes``: top-level fields, ``cache``/``scheduler``/
    ``spec`` fields by their flat names (``EngineConfig.of``), and a pool
    sized for the new max_batch x max_len (and an enc-dec's frame pages)
    unless ``changes`` sets ``num_pages``."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.core.perf_model import paged_pool_pages

    flat = engine.config.flat()
    flat.update(changes)
    if "num_pages" not in changes:
        frames = engine.xpages_per_seq * flat["page_size"]
        flat["num_pages"] = 1 + paged_pool_pages(flat["max_batch"], flat["max_len"] + frames,
                                                 flat["page_size"])
    return ServingEngine(engine.cfg, params if params is not None else engine.params,
                         plan=plan, device=engine.device, config=EngineConfig.of(**flat))


def _family_serve(torch, arch: str, card: str):
    """One family at full width with the quickstart flags: the kernel path's
    streams, its launches (B1, B2, B3; B5 only for an untied head; no B4),
    tok/s and step time, then the plain path's streams, held to each other
    by the near-tie rule.  Returns (serve, cfg, engine, plan, outputs, the
    kernel run's {"launches", "by_t": B3's launches by query positions,
    "stacked": B1/B2/B4's (stacked launches, experts covered)})."""
    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.kernels import flash_attention as FA

    serve, ap, args = _serve_args(["--arch", arch])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, engine, plan = serve.build_engine(args, ap)
    torch.cuda.synchronize()
    log(f"{arch}: model + plan + engine built in {time.perf_counter() - t0:.1f}s "
        f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
        f"hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied {cfg.tie_embeddings}"
        f"{_moe_label(cfg)}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB during the build)")
    ticks = []
    outputs, launches, dt = _serve_and_check(serve, engine, cfg, args.max_new, arch,
                                             ticks=ticks)
    run = {"launches": dict(launches), "by_t": dict(FA.paged_decode_attention.launches_by_t),
           "stacked": {c.__name__: (c.stacked_launches, c.stacked_experts)
                       for c in _served_kernels() if hasattr(c, "stacked_launches")}}
    if launches.pop("block_sparse_matmul_col"):
        raise AssertionError(f"{arch}: B4 launched, but every served leaf carries its walk")
    for name in ("block_sparse_matmul", "fused_gate_up", "paged_decode_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"{arch}: kernel {name} was not launched on its path")
    if cfg.tie_embeddings and launches["quant_matmul"]:
        raise AssertionError(f"{arch}: the tied head reached B5")
    if not cfg.tie_embeddings and launches["quant_matmul"] <= 0:
        raise AssertionError(f"{arch}: the untied int8 head did not launch B5")
    step_ms, n_steps = _decode_tick_ms(ticks)
    log(f"{arch}: {engine.stats.completed}/8 FINISHED, audit clean, {engine.stats.pages_shared} "
        f"pages shared, {engine.stats.decode_tokens / dt:.1f} tok/s, decode tick "
        f"{step_ms:.2f} ms (median of {n_steps}, batch {engine.stats.mean_batch:.2f}) on "
        f"{card}")

    plain = _engine_like(engine, plan, params=with_use_kernel(engine.params, False))
    plain.attention_kernel = False
    p_out, p_launches, p_dt = _serve_and_check(serve, plain, cfg, args.max_new, f"{arch} plain")
    if any(p_launches.values()):
        raise AssertionError(f"{arch} plain: a kernel launched on the plain path: {p_launches}")
    prompts = [r.prompt for r in _serve_requests(cfg, args.max_new)]
    _streams_near_tie(torch, cfg, plain.params, f"{arch} kernels vs plain", prompts, p_out,
                      outputs)
    log(f"{arch} plain: {plain.stats.decode_tokens / p_dt:.1f} tok/s on {card}")
    del plain
    torch.cuda.empty_cache()
    return serve, cfg, engine, plan, outputs, run


def _family_long(torch, results, serve, cfg, engine, plan, card: str, key=None) -> dict:
    """One 2032-token prompt (16 new tokens, max_len 2048) served through
    the family's engine: every layer's prefill attention runs B6 at the
    family's head dim (gemma3: windowed on its local layers), counted by
    window at the launch site into B6's row ``key`` (default "hd<hd>"); the
    first tick (the prefill and one decode step) timed; the first token held
    to the plain path's by the near-tie rule (``_path_parity`` holds the
    logits).  Returns the run's launches."""
    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.engine import Request

    arch = cfg.name
    eng = _engine_like(engine, plan, max_len=2048, max_batch=1)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=LONG_M).astype(np.int32)
    reqs = [Request(uid=0, prompt=prompt, max_new_tokens=16)]
    ticks = []
    FA.flash_attention.launches = 0
    outputs, launches, dt = _serve_and_check(serve, eng, cfg, 16, f"{arch} long", reqs,
                                             ticks=ticks)
    b6 = FA.flash_attention.launches
    by_w = dict(FA.flash_attention.launches_by_window)
    first_ms = 1e3 * ticks[0][0]
    log(f"{arch} long: B6 launches {b6}, by window {by_w} ({cfg.layer_kinds.count('local')} "
        f"local layers, window {cfg.local_window}), first tick (prefill of {LONG_M} tokens + "
        f"one decode step) {first_ms:.3f} ms, {eng.stats.decode_tokens / dt:.1f} tok/s on "
        f"{card}")
    want = {}
    for kind in cfg.layer_kinds:
        w = cfg.local_window if kind == "local" else 0
        want[w] = want.get(w, 0) + 1
    if by_w != want or b6 != cfg.n_layers:
        raise AssertionError(f"{arch} long: B6 launches by window {by_w}, expected {want}")
    for name in ("block_sparse_matmul", "fused_gate_up", "paged_decode_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"{arch} long: kernel {name} was not launched")
    _row(results, "flash_attention", key or f"hd{cfg.hd}")["launches"] = by_w.get(0, 0)
    if "local" in cfg.layer_kinds:
        _row(results, "flash_attention", f"hd{cfg.hd} window")["launches"] = \
            by_w.get(cfg.local_window, 0)
    del eng
    torch.cuda.empty_cache()
    return launches


def _capped_prefill(torch, results, cfg, params, gen) -> None:
    """A LONG_M-token prefill of the family with ``logit_softcap`` =
    SOFTCAP through capped B6 (once a layer; gemma3 windowed on its local
    layers) and through the plain versions: the last logits within
    PATH_RTOL.  B6's capped rows at the family's head dim take its launches
    by window."""
    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    capped = dataclasses.replace(cfg, logit_softcap=SOFTCAP)
    prompt = torch.randint(0, cfg.vocab, (1, LONG_M), generator=gen, device="cuda")
    FA.flash_attention.launches = 0
    FA.flash_attention.launches_by_window.clear()
    lg = {}
    for name, p, use_kernel in (("kernels", params, True),
                                ("plain", with_use_kernel(params, False), False)):
        cache = T.init_cache(capped, 1, LONG_M, torch.bfloat16, kv_dtype=torch.int8,
                             device="cuda")
        lg[name] = T.prefill(capped, p, prompt, cache, use_kernel=use_kernel)[0][0, -1].float()
    torch.cuda.synchronize()
    a, b = lg["kernels"], lg["plain"]
    worst = float((a - b).abs().max() / b.abs().max())
    by_w = dict(FA.flash_attention.launches_by_window)
    want = {}
    for kind in cfg.layer_kinds:
        w = cfg.local_window if kind == "local" else 0
        want[w] = want.get(w, 0) + 1
    log(f"{cfg.name} softcap {SOFTCAP:g}: prefill of {LONG_M} tokens, max |dlogit| / max "
        f"|logit| = {worst:.3e} (tolerance {PATH_RTOL}), B6 by window {by_w}")
    if not (torch.isfinite(a).all() and worst <= PATH_RTOL):
        raise AssertionError(f"{cfg.name} softcap: capped prefill logits differ from the plain "
                             f"path: {worst:.3e}")
    if by_w != want:
        raise AssertionError(f"{cfg.name} softcap: B6 launches by window {by_w}, expected {want}")
    _row(results, "flash_attention", f"cap30 hd{cfg.hd}")["launches"] = by_w.get(0, 0)
    if "local" in cfg.layer_kinds:
        _row(results, "flash_attention", f"cap30 hd{cfg.hd} window")["launches"] = \
            by_w[cfg.local_window]


def _family_spec(torch, results, serve, cfg, engine, plan, outputs, card: str,
                 key="") -> dict:
    """The family with its own plan as the draft (k = SPEC_K; a model with
    local layers widens their rings by k): B3 at T = 5 on the global layers
    at the family's head dim, counted into B3's row ``key`` (default
    "hd<hd> verify"; None: no row), accept rate over 0.5, streams held to
    the serve run's by the near-tie rule.  Returns the run's launches."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.config import SpecConfig
    from repro_torch.serving.engine import ServingEngine

    arch = cfg.name
    conf = dataclasses.replace(engine.config, spec=SpecConfig(
        draft_cfg=cfg, draft_params=engine.params, spec_k=SPEC_K))
    spec = ServingEngine(cfg, engine.params, plan=plan, device=engine.device, config=conf)
    rings = {c["k"].shape[1] for k, c in zip(cfg.layer_kinds, spec.cache["layers"])
             if k == "local"}
    out_spec, launches, dt = _serve_and_check(serve, spec, cfg, 16, f"{arch} spec self-draft")
    by_t = dict(FA.paged_decode_attention.launches_by_t)
    per_seq = _spec_log(f"{arch} spec self-draft", spec, dt, card)
    log(f"{arch} spec: local rings of {sorted(rings)} slots (max_len {spec.max_len}, window "
        f"{cfg.local_window} + k {SPEC_K}); B3 launches by query positions {by_t}")
    if by_t.get(SPEC_K + 1, 0) <= 0:
        raise AssertionError(f"{arch} spec: B3 never launched at T = {SPEC_K + 1}")
    if not spec.stats.accept_rate > 0.5 or not per_seq > 1.0:
        raise AssertionError(f"{arch} spec: accept rate {spec.stats.accept_rate:.4f}, "
                             f"{per_seq:.3f} tokens a sequence a tick")
    if key is not None:
        _row(results, "paged_decode_attention", key or f"hd{cfg.hd} verify")["launches"] = \
            by_t[SPEC_K + 1]
    prompts = [r.prompt for r in _serve_requests(cfg, 16)]
    _streams_near_tie(torch, cfg, engine.params, f"{arch} spec vs serve", prompts, outputs,
                      out_spec)
    del spec
    torch.cuda.empty_cache()
    return launches


def _gemma_chunked(torch, serve, cfg, engine, plan, card: str) -> None:
    """gemma3-4b's chunked prefill (256-token chunks, 512 a tick) of prompts
    within the window, held to the same prompts prefilled whole by the
    near-tie rule; no chunk reaches B6."""
    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(4)
    lens = GEMMA_CHUNK_PROMPTS
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens]
    runs = {}
    for label, flags in (("whole", {}), ("chunked", GEMMA_CHUNK_FLAGS)):
        eng = _engine_like(engine, plan, max_len=1024, max_batch=len(lens), **flags)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
        FA.flash_attention.launches = 0
        out, launches, dt = _serve_and_check(serve, eng, cfg, 16, f"gemma3-4b {label}", reqs)
        log(f"gemma3-4b {label}: prompts {lens}, {eng.stats.prefill_chunks} chunks of "
            f"{eng.prefill_chunk}, B6 launches {FA.flash_attention.launches}, "
            f"{dt:.2f}s wall on {card}")
        if FA.flash_attention.launches:
            raise AssertionError(f"gemma3-4b {label}: a prompt within the window reached B6")
        runs[label] = (out, eng.stats.prefill_chunks)
        del eng
        torch.cuda.empty_cache()
    if runs["chunked"][1] <= len(lens):
        raise AssertionError("gemma3-4b chunked: no prompt was split into chunks")
    _streams_near_tie(torch, cfg, engine.params, "gemma3-4b chunked vs whole", prompts,
                      runs["whole"][0], runs["chunked"][0])


def _check_family_rows(results: dict) -> None:
    """Every kernel row of the families, MoE and encdec_vlm phases carries
    the launches that a served run at its shape counted (checked once all
    three have run)."""
    for name, r in results.items():
        for row in r.get("rows", []):
            if "key" in row and not (row["launches"] or 0) > 0:
                raise AssertionError(f"{name} row {row['key']}: no served run launched its "
                                     f"shape ({row['launches']})")


def phase_families(torch, results: dict, card: str) -> None:
    """The dense families at full width (random weights from a seed, the
    quickstart flags): for each, the serve run and the plain path's
    (``_family_serve``), then ``_path_parity`` (prefills of 36, 40 and 2032
    tokens and teacher-forced decode, kernels vs plain versions), then for
    glm4-9b and gemma3-4b a served 2032-token prompt (``_family_long``) and
    self-draft speculation (``_family_spec``), and for gemma3-4b chunked
    prefill.  Its kernel rows are checked after the MoE phase."""
    for arch in FAMILIES:
        serve, cfg, engine, plan, outputs, run = _family_serve(torch, arch, card)
        if cfg.hd != 64:  # the rows of B3 at the new head dims
            _row(results, "paged_decode_attention", f"hd{cfg.hd} serve")["launches"] = \
                run["by_t"].get(1, 0)
        if arch == "gemma3-4b":
            _row(results, "fused_gate_up", "gelu")["launches"] = run["launches"]["fused_gate_up"]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(11)
        _path_parity(torch, cfg, engine.params, f"{arch} quant_sparse", gen)
        if arch in FAMILY_LONG:
            _family_long(torch, results, serve, cfg, engine, plan, card)
            _capped_prefill(torch, results, cfg, engine.params, gen)
            _family_spec(torch, results, serve, cfg, engine, plan, outputs, card)
        if arch == "gemma3-4b":
            _gemma_chunked(torch, serve, cfg, engine, plan, card)
        del engine, plan
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the MoE family: stacked experts through B1, B2 and B4
# ---------------------------------------------------------------------------

MOE_ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")
# earlier paths cut in depth (full width kept) so that the script stays
# within its time limit: {arch: the first layers kept}.  Every phase sees
# the cut configs: families, moe, encdec_vlm, recurrent, mixed, the mesh
# cases, and the train and train_mesh_families runs of these archs.
DEPTH_CUTS = {"glm4-9b": 10, "gemma3-4b": 12, "granite-moe-1b-a400m": 8,
              "qwen2-moe-a2.7b": 4, "recurrentgemma-2b": 13, "xlstm-350m": 12,
              "internvl2-2b": 12}


# tinyllama-1.1b's depth in the autotune, train and train_mesh phases (and
# their ranks): their runs are held to each other, not to the serving
# phases' streams, and at 22 layers these three take about 480 s on a slower
# host (NVIDIA H100 80GB HBM3, 700 W), which then pushes the script past its
# 1200 s; full width, 8 of 22 layers
TAIL_CUTS = {"tinyllama-1.1b": 8}


def _cut_depths(extra=None) -> dict:
    """Replace each DEPTH_CUTS arch's config (and ``extra``'s: {arch:
    layers}) in this process's registry by its first layers
    (``configs.get_config(arch)`` returns the cut one).  Returns the
    configs it replaced, by arch."""
    import importlib

    from repro_torch import configs

    replaced = {}
    for arch, n in {**DEPTH_CUTS, **(extra or {})}.items():
        mod = importlib.import_module(f"repro_torch.configs.{configs._MODULES[arch]}")
        cfg = mod.CONFIG
        if cfg.n_layers != n:
            replaced[arch] = cfg
            mod.CONFIG = dataclasses.replace(
                cfg, n_layers=n, pattern=None if cfg.pattern is None else tuple(cfg.pattern[:n]))
    return replaced


@contextlib.contextmanager
def _tail_cuts():
    """TAIL_CUTS in this process's registry, the full configs back after."""
    import importlib

    from repro_torch import configs

    replaced = _cut_depths(TAIL_CUTS)
    try:
        yield
    finally:
        for arch, cfg in replaced.items():
            importlib.import_module(f"repro_torch.configs.{configs._MODULES[arch]}").CONFIG = cfg


def _moe_label(cfg) -> str:
    """The MoE part of a model's description (empty for a dense model)."""
    m = cfg.moe
    if m is None:
        return ""
    return (f", MoE {m.n_experts} experts ({m.n_experts_padded} stacked) top-{m.top_k}, "
            f"expert d_ff {m.expert_d_ff}, {m.n_shared_experts} shared")


def _expert(p, e: int):
    """Expert ``e`` of a packed stack as a 2-D PackedLinear (views)."""
    return dataclasses.replace(p, blocks=p.blocks[e], block_rows=p.block_rows[e],
                               counts=p.counts[e], scales=p.scales[e], walk=None)


def _packed_stack(torch, E: int, K: int, N: int, gen):
    """A stack of E random (K, N) experts, int8 block-sparse at q 0.5 (each
    pruned on its own, one mb), as compress packs a layer's expert leaf."""
    from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse

    w = torch.randn((E, K, N), generator=gen, device="cuda") / K ** 0.5
    return pack_block_sparse(w, PlanConfig(q_prune=0.5), quant=True)


def _stack_bytes(E: int, M: int, K: int, N: int, packs) -> float:
    """Bytes a stacked launch must move: x and y once, and per packed
    operand its surviving payload with one row index a block, its counts
    and its scales."""
    nbytes = E * M * K * 2 + E * M * N * 2
    for p in packs:
        nbytes += (int(p.counts.sum()) * (128 * 128 + 4) + p.counts.numel() * 4
                   + p.scales.numel() * 4)
    return nbytes


def _per_expert_equal(torch, label: str, E: int, y, one) -> None:
    """A stacked launch equals E single-expert launches (``one(e)``) bit for
    bit, in the stack's regime: the split orders a column's partial sums,
    so the single launches take the split ``launch_plan`` gives the stack."""
    from repro_torch.kernels import block_sparse as BS

    plan = BS.launch_plan
    BS.launch_plan = lambda M, n_cols, mb, n_sm, n_stack=1: plan(M, n_cols, mb, n_sm, E)
    try:
        ys = torch.stack([one(e) for e in range(E)])
    finally:
        BS.launch_plan = plan
    torch.cuda.synchronize()
    if not torch.equal(ys, y):
        raise AssertionError(f"{label}: the stacked launch differs from {E} single-expert "
                             f"launches")
    log(f"{label}: one stacked launch equals {E} single-expert launches bit for bit")


def _moe_pair_row(torch, timer, gen, results, key: str, E: int, K: int, N: int,
                  M: int = 8) -> None:
    """Stacked B2 at one arch's expert gate/up stacks (E x K x N, silu):
    held to its plain version (the 2-D plain version over each expert),
    twice for the same bits, equal to E single-expert launches, timed beside
    the plain version and one torch.bmm on the dequantized bf16 [Wg | Wu]
    stack plus the gate."""
    from repro_torch.kernels import fused_gate_up as FG

    g, u = _packed_stack(torch, E, K, N, gen), _packed_stack(torch, E, K, N, gen)
    ga, ua = (g.blocks, g.block_rows, g.counts), (u.blocks, u.block_rows, u.counts)
    x = torch.randn((E, M, K), generator=gen, device="cuda").to(torch.bfloat16)
    label = f"stacked B2 {E}x{K}x{N} M={M}"

    def fn():
        return FG.fused_gate_up(x, ga, ua, g.scales, u.scales)

    y = fn()
    d, r = _held(torch, label, y, FG.fused_gate_up(x, ga, ua, g.scales, u.scales,
                                                   use_kernel=False), KERNEL_RTOL)
    _deterministic(torch, label, y, fn())
    _per_expert_equal(torch, label, E, y, lambda e: FG.fused_gate_up(
        x[e], [t[e] for t in ga], [t[e] for t in ua], g.scales[e], u.scales[e]))
    surv = int(g.counts.sum() + u.counts.sum())
    b_ms, b_by = bound(_stack_bytes(E, M, K, N, (g, u)), 2.0 * M * surv * 128 * 128)
    wgu = torch.stack([torch.cat([_dense_bf16(torch, _expert(g, e)),
                                  _dense_bf16(torch, _expert(u, e))], dim=1) for e in range(E)])
    silu = torch.nn.functional.silu

    def library():
        h = torch.bmm(x, wgu)
        return silu(h[..., :N]) * h[..., N:]

    ms = timer(fn)
    plain_ms = timer(lambda: FG.fused_gate_up(x, ga, ua, g.scales, u.scales, use_kernel=False))
    lib_ms = timer(library)
    log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm(dense [Wg|Wu] bf16) "
        f"+ gate {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {surv} surviving blocks)")
    _add_row(results, "fused_gate_up", {
        "key": key, "shape": f"stack of {E} experts {K}x{N} gate+up silu at M={M} an expert",
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by}, d, r)


def _moe_down_rows(torch, timer, gen, results, key: str, E: int, K: int, N: int,
                   M: int = 8, b4: bool = False) -> None:
    """Stacked B1 at one arch's expert down-projection stack (E x K x N):
    held to its plain version, twice for the same bits, equal to E
    single-expert launches, timed beside the plain version and torch.bmm on
    the dequantized bf16 stack; with ``b4`` also stacked B4 on the same
    operands, equal to stacked B1 bit for bit, as B4's row."""
    from repro_torch.kernels import block_sparse as BS

    p = _packed_stack(torch, E, K, N, gen)
    args = (p.blocks, p.block_rows, p.counts, p.scales)
    x = torch.randn((E, M, K), generator=gen, device="cuda").to(torch.bfloat16)
    wd = torch.stack([_dense_bf16(torch, _expert(p, e)) for e in range(E)])
    surv = int(p.counts.sum())
    b_ms, b_by = bound(_stack_bytes(E, M, K, N, (p,)), 2.0 * M * surv * 128 * 128)
    lib_ms = timer(lambda: torch.bmm(x, wd))
    plain_ms = timer(lambda: BS.block_sparse_matmul(x, *args, use_kernel=False))
    want = BS.block_sparse_matmul(x, *args, use_kernel=False)
    kernels = [("B1", BS.block_sparse_matmul)]
    if b4:
        kernels.append(("B4", BS.block_sparse_matmul_col))
    y1 = None
    for tag, fn in kernels:
        label = f"stacked {tag} {E}x{K}x{N} M={M}"
        y = fn(x, *args)
        d, r = _held(torch, label, y, want, KERNEL_RTOL)
        _deterministic(torch, label, y, fn(x, *args))
        if y1 is None:
            y1 = y
            _per_expert_equal(torch, label, E, y, lambda e: fn(x[e], *[t[e] for t in args]))
        elif not torch.equal(y, y1):
            raise AssertionError(f"{label}: stacked B4 differs from stacked B1")
        else:
            log(f"{label}: equals stacked B1 bit for bit")
        ms = timer(lambda: fn(x, *args))
        log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm(dense bf16) "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {surv} surviving blocks)")
        _add_row(results, fn.__name__, {
            "key": key, "shape": f"stack of {E} experts {K}x{N} at M={M} an expert",
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by}, d, r)


def _b5_head_row(torch, timer, gen, results, key: str, K: int, N: int, M: int = 8,
                 regime=None) -> None:
    """B5 at an untied int8 head, or any int8 leaf (K x N, M rows): held to
    its plain version, twice for the same bits, timed beside torch.matmul
    on the dequantized bf16 weight; its regime must be ``regime`` where
    given."""
    from repro_torch.core.weight_plan import quantize_leaf
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import quant_matmul as QM

    leaf = quantize_leaf(torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5)
    wq, sc = leaf.q, leaf.s
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    label = f"B5 {K}x{N} M={M} bf16"
    plan = QM.regime(x.dtype, M, K, N, K, N, BS.sm_count(x.device))
    log(f"{label}: regime {plan}")
    if regime is not None and plan[0] != regime:
        raise AssertionError(f"{label}: regime {plan[0]}, expected {regime}")
    y = QM.quant_matmul(x, wq, sc)
    d, r = _held(torch, label, y, QM.quant_matmul(x, wq, sc, use_kernel=False), KERNEL_RTOL)
    _deterministic(torch, label, y, QM.quant_matmul(x, wq, sc))
    b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + M * N * 2, 2.0 * M * K * N)
    wd = (wq.float() * sc).to(torch.bfloat16)
    ms = timer(lambda: QM.quant_matmul(x, wq, sc))
    plain_ms = timer(lambda: QM.quant_matmul(x, wq, sc, use_kernel=False))
    lib_ms = timer(lambda: torch.matmul(x, wd))
    log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul(dequantized bf16) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    _add_row(results, "quant_matmul", {
        "key": key, "shape": f"int8 {K}x{N}, bf16 x at M={M}", "ms": ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}, d, r)


def phase_moe_kernels(torch, results: dict) -> None:
    """The kernels at the MoE family's shapes, each against its plain
    version: stacked B2 and B1 at granite-moe's 32 x 1024 x 512 / 32 x 512
    x 1024 and qwen2-moe's 64 x 2048 x 1408 / 64 x 1408 x 2048 expert stacks
    at M 8 (each also equal to its single-expert launches), stacked B4 at
    granite's down stack (equal to stacked B1), B3 at qwen2-moe's 16/16
    heads at hd 128 (serve and verify steps), B6 at its 2048-token prefill,
    B5 at its 2048 x 151936 head."""
    from repro_torch.configs import get_config

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        d, E, f = cfg.d_model, cfg.moe.n_experts_padded, cfg.moe.expert_d_ff
        _moe_pair_row(torch, timer, gen, results, arch, E, d, f)
        _moe_down_rows(torch, timer, gen, results, arch, E, f, d,
                       b4=arch == "granite-moe-1b-a400m")
        torch.cuda.empty_cache()
    q = get_config("qwen2-moe-a2.7b")
    _b3_row(torch, timer, gen, results, "qwen2-moe serve", q.n_heads, q.n_kv_heads, q.hd, 1)
    _b3_row(torch, timer, gen, results, "qwen2-moe verify", q.n_heads, q.n_kv_heads, q.hd,
            SPEC_K + 1)
    _b6_row(torch, timer, gen, results, "qwen2-moe", q.n_heads, q.n_kv_heads, q.hd)
    _b5_head_row(torch, timer, gen, results, "qwen2-moe head", q.d_model, q.vocab)
    torch.cuda.empty_cache()


def _step_launches(torch, cfg, params) -> dict:
    """Each served kernel's (launches, stacked launches) in one batch-8
    decode step (paged int8 KV at 40-token contexts)."""
    from repro_torch.models import transformer as T

    B, ps, ctx = 8, 16, 40
    P = -(-(ctx + 1) // ps)
    cache = T.init_cache(cfg, B, P * ps, torch.bfloat16, kv_dtype=torch.int8, page_size=ps,
                         num_pages=1 + B * P, device="cuda")
    cache["page_table"].copy_(1 + torch.arange(B * P, device="cuda").reshape(B, P))
    tokens = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    pos = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    counters = _served_kernels()
    _zero_launches(counters)
    T.decode_step(cfg, params, cache, tokens, pos)
    torch.cuda.synchronize()
    return {c.__name__: (c.launches, getattr(c, "stacked_launches", 0)) for c in counters}


def _moe_checks(torch, results, arch: str, cfg, engine, run) -> None:
    """A MoE serve run reached every expert stack through the stacked
    kernels: stacked B1 (down) and B2 (gate/up) launches, each over all
    ``Ep`` experts, counted into the rows keyed ``arch``; and one decode
    step launches each once a layer."""
    Ep = cfg.moe.n_experts_padded
    for name in ("block_sparse_matmul", "fused_gate_up"):
        n, experts = run["stacked"][name]
        if n <= 0 or experts != n * Ep:
            raise AssertionError(f"{arch}: {n} stacked {name} launches over {experts} experts "
                                 f"(each must cover all {Ep})")
        _row(results, name, arch)["launches"] = n
    log(f"{arch}: stacked launches in the served run (launches, experts covered): B1 "
        f"{run['stacked']['block_sparse_matmul']}, B2 {run['stacked']['fused_gate_up']}")
    step = _step_launches(torch, cfg, engine.params)
    log(f"{arch}: one decode step at batch 8 launches (all, stacked) {step}")
    for name in ("block_sparse_matmul", "fused_gate_up"):
        if step[name][1] != cfg.n_layers:
            raise AssertionError(f"{arch}: a decode step launched stacked {name} "
                                 f"{step[name][1]} times, not once a layer ({cfg.n_layers})")


def _moe_walkless(torch, results, arch: str, plan, outputs, card: str) -> None:
    """The served plan saved without walks and booted from --plan-cache: every
    packed leaf runs B4 (the expert stacks as stacked B4), none B1, and B4
    equals B1 bit for bit, so the greedy tokens equal the walk plan's,
    every one."""
    import shutil
    import tempfile

    from repro_torch.core import weight_plan as W
    from repro_torch.kernels import block_sparse as BS

    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_plan_")
    try:
        bare = W.map_tree(lambda _, n: dataclasses.replace(n, walk=None)
                          if isinstance(n, W.PackedLinear) else n, plan.params)
        W.save_plan(tmp, dataclasses.replace(plan, params=bare))
        del bare
        serve, ap, args = _serve_args(["--arch", arch, "--plan-cache", tmp])
        out, cfg, engine, plan2, boot_s = _boot(torch, serve, ap, args)
        if "plan cache hit" not in out:
            raise AssertionError(f"{arch} walk-less: the boot did not hit the plan cache")
        bare_out, launches, dt = _serve_and_check(serve, engine, cfg, args.max_new,
                                                  f"{arch} walk-less")
        n4 = BS.block_sparse_matmul_col.stacked_launches
        if launches["block_sparse_matmul"] or n4 <= 0:
            raise AssertionError(f"{arch} walk-less: B1 {launches['block_sparse_matmul']}, "
                                 f"stacked B4 {n4} launches (B4 only, stacks included)")
        _row(results, "block_sparse_matmul_col", arch)["launches"] = n4
        if bare_out != outputs:
            raise AssertionError(f"{arch} walk-less: greedy tokens differ from the walk plan's")
        log(f"{arch} walk-less: boot {boot_s:.2f}s from the plan cache, B4 launches "
            f"{launches['block_sparse_matmul_col']} ({n4} stacked), all "
            f"{sum(map(len, outputs))} greedy tokens equal the walk plan's "
            f"({engine.stats.decode_tokens / dt:.1f} tok/s on {card})")
        del engine, plan2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _moe_long(torch, results, serve, cfg, engine, plan, card: str) -> None:
    """qwen2-moe's served 2032-token prompt: B6 at hd 128 (16/16 heads) once
    a layer, and the MoE past full capacity (T 2032 > 256: groups of 508,
    ceil(508 * 4 / 60 * 1.25) = 43 slots an expert a group, assignments past
    them dropped) through stacked B2 and B1 at M 4 x 43 = 172 an expert,
    recorded at the dispatch."""
    import math

    from repro_torch.kernels import ops

    m = cfg.moe
    G = 508  # the largest divisor of 2032 up to 512
    want = (m.n_experts_padded, LONG_M // G * math.ceil(G * m.top_k / m.n_experts
                                                          * m.capacity_factor), cfg.d_model)
    shapes = set()
    inner = ops.fused_gate_up

    def spy(x2, g, u, activation):
        if x2.dim() == 3:
            shapes.add(tuple(x2.shape))
        return inner(x2, g, u, activation)

    ops.fused_gate_up = spy
    try:
        _family_long(torch, results, serve, cfg, engine, plan, card, key="qwen2-moe")
    finally:
        ops.fused_gate_up = inner
    log(f"{cfg.name} long: stacked B2 (E, M, K) {sorted(shapes)}; the {LONG_M}-token prefill "
        f"must route {want}")
    if want not in shapes:
        raise AssertionError(f"{cfg.name} long: the prefill did not reach stacked B2 at {want}")


def phase_moe(torch, results: dict, card: str) -> None:
    """granite-moe-1b-a400m and qwen2-moe-a2.7b at published widths, cut to
    DEPTH_CUTS' layers (random weights from seed 0, the quickstart flags):
    for each, the
    serve run and the plain path's (``_family_serve``: streams by the
    near-tie rule, the build's peak memory), the stacked launches
    (``_moe_checks``), ``_path_parity`` (prefills of 36, 40 and 2032 tokens
    -- the last past full capacity -- and teacher-forced decode); granite's
    walk-less plan through stacked B4 and its self-draft speculation (the
    verify step's T = 40 through the MoE); qwen2-moe's served 2032-token
    prompt and its self-draft speculation (B3 at T = 5, hd 128).  Every
    kernel row must carry launches from a served run (checked after the
    encdec_vlm phase).  Returns {arch: its kernel path's streams}."""
    streams = {}
    for arch in MOE_ARCHS:
        serve, cfg, engine, plan, outputs, run = _family_serve(torch, arch, card)
        streams[arch] = outputs
        _moe_checks(torch, results, arch, cfg, engine, run)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        _path_parity(torch, cfg, engine.params, f"{arch} quant_sparse", gen)
        if arch == "granite-moe-1b-a400m":
            _moe_walkless(torch, results, arch, plan, outputs, card)
            _family_spec(torch, results, serve, cfg, engine, plan, outputs, card, key=None)
        else:
            _row(results, "paged_decode_attention", "qwen2-moe serve")["launches"] = \
                run["by_t"].get(1, 0)
            _row(results, "quant_matmul", "qwen2-moe head")["launches"] = \
                run["launches"]["quant_matmul"]
            _moe_long(torch, results, serve, cfg, engine, plan, card)
            _family_spec(torch, results, serve, cfg, engine, plan, outputs, card,
                         key="qwen2-moe verify")
        del engine, plan
        torch.cuda.empty_cache()
    return streams


# ---------------------------------------------------------------------------
# the enc-dec and VLM families: frame pages read by a non-causal B3, and a
# non-causal B6 over 1500 frames
# ---------------------------------------------------------------------------

def _b3_cross_row(torch, timer, gen, results) -> None:
    """B3 non-causal at whisper-tiny's decode cross-attention: 8 sequences,
    T 1, 6/6 heads, hd 64, bf16 frame pages of 16 -- 1500 frames in 94 pages
    a sequence under a scrambled table, pos 1499 (the last page's 4 stale
    slots mask out); held to its plain version, twice for the same bits,
    timed beside SDPA on the gathered frames, unmasked."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L

    B, H, KVH, hd, ps, nf = 8, 6, 6, 64, 16, 1500
    P = -(-nf // ps)
    table = (1 + torch.randperm(B * P, generator=gen, device="cuda")).reshape(B, P)
    table = table.to(torch.int32).contiguous()
    shape = (1 + B * P, ps, KVH, hd)
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.full((B,), nf - 1, dtype=torch.int32, device="cuda")
    label = f"B3 non-causal hd {hd} B={B} T=1 H={H}/{KVH} bf16, {P} frame pages of {ps}"
    o = FA.paged_decode_attention(q, kp, vp, table, pos, causal=False)
    d, r = _held(torch, label, o, FA.paged_decode_attention(q, kp, vp, table, pos, causal=False,
                                                            use_kernel=False), KERNEL_RTOL)
    _deterministic(torch, label, o, FA.paged_decode_attention(q, kp, vp, table, pos,
                                                              causal=False))
    nbytes = 2 * B * nf * KVH * hd * 2 + 2 * q.numel() * 2 + table.numel() * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * B * nf * H * hd)
    ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, causal=False))
    plain_ms = timer(lambda: FA.paged_decode_attention(q, kp, vp, table, pos, causal=False,
                                                       use_kernel=False))
    kd = L.gather_pages(kp, table)[:, :nf].transpose(1, 2)
    vd = L.gather_pages(vp, table)[:, :nf].transpose(1, 2)
    qt = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(qt, kd, vd))
    log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA(gathered frames, no "
        f"mask) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    _add_row(results, "paged_decode_attention", {
        "key": "whisper cross", "shape": f"B={B} T=1 H={H} KVH={KVH} hd={hd} non-causal, bf16 "
                                         f"frame pages of {ps}, {nf} frames (pos {nf - 1})",
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by}, d, r)


def _b6_noncausal_row(torch, timer, gen, results, key: str, Sq: int, Sk: int = 1500) -> None:
    """B6 non-causal at whisper-tiny's 6/6 heads, hd 64, B 1 (a batch-1
    prefill): Sq = Sk = 1500 is the encoder, Sq 40 against Sk 1500 the
    decoder prefill's cross-attention (Sq != Sk, ragged against 128-key
    tiles); held to its plain version, twice for the same bits, timed beside
    SDPA without a mask."""
    from repro_torch.kernels import flash_attention as FA

    H = KVH = 6
    hd = 64
    q = torch.randn((1, Sq, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, Sk, KVH, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(k.shape, generator=gen, device="cuda").to(torch.bfloat16)
    label = f"B6 non-causal hd {hd} Sq={Sq} Sk={Sk} H={H}/{KVH} bf16"
    o = FA.flash_attention(q, k, v, causal=False)
    d, r = _held(torch, label, o, FA.flash_attention(q, k, v, causal=False, use_kernel=False),
                 KERNEL_RTOL)
    _deterministic(torch, label, o, FA.flash_attention(q, k, v, causal=False))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4.0 * hd * H * _visible_pairs(Sq, Sk, False, None)
    b_ms, b_by = bound(nbytes, flops)
    ms = timer(lambda: FA.flash_attention(q, k, v, causal=False))
    plain_ms = timer(lambda: FA.flash_attention(q, k, v, causal=False, use_kernel=False))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = timer(lambda: sdpa(qt, kt, vt))
    log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA(no mask) {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
    _add_row(results, "flash_attention", {
        "key": key, "shape": f"B=1 Sq={Sq} Sk={Sk} H={H} KVH={KVH} hd={hd} non-causal bf16",
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "bound_by": b_by}, d, r)


def phase_encdec_kernels(torch, results: dict) -> None:
    """The kernels at the enc-dec and VLM families' new modes and shapes,
    each against its plain version: B3 non-causal over whisper-tiny's frame
    pages, B6 non-causal at whisper's encoder (1500 x 1500) and its
    prefill's cross-attention (40 x 1500), B3 at internvl2-2b's 16/8 heads
    (hd 128, int8 pages, contexts after its 256 patches), B6 at internvl's
    16/8 heads at 2032 positions, B5 at internvl's 2048 x 92553 head (its
    regime logged: dense_tile)."""
    from repro_torch.configs import get_config

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    _b3_cross_row(torch, timer, gen, results)
    _b6_noncausal_row(torch, timer, gen, results, "whisper encoder", 1500)
    _b6_noncausal_row(torch, timer, gen, results, "whisper cross", 40)
    c = get_config(INTERNVL)
    _b3_row(torch, timer, gen, results, "internvl serve", c.n_heads, c.n_kv_heads, c.hd, 1,
            prefix=c.n_patches, P=INTERNVL_MAX_LEN // 16)
    _b6_row(torch, timer, gen, results, "internvl", c.n_heads, c.n_kv_heads, c.hd, S=LONG_M)
    _b5_head_row(torch, timer, gen, results, "internvl head", c.d_model, c.vocab)
    torch.cuda.empty_cache()


def _extras_requests(serve, cfg, max_new: int) -> list:
    """The serve phase's 8 requests, each with its frontend-stub inputs (an
    enc-dec's frames, a VLM's patches) drawn by ``serve.request_extras``
    from seed 2: the same for every run of a family."""
    import numpy as np

    reqs = _serve_requests(cfg, max_new)
    rng = np.random.default_rng(2)
    for r in reqs:
        r.extras = serve.request_extras(cfg, rng)
    return reqs


@contextlib.contextmanager
def _flash_shapes(shapes: list):
    """Records (Sq, Sk, causal) of every B6 launch the model path makes:
    ``layers.attention`` calls ``ops.flash_attention`` only to launch B6
    (on CUDA tensors, with the kernel on), which launches or raises."""
    from repro_torch.kernels import ops

    inner = ops.flash_attention

    def spy(q, k, v, **kw):
        out = inner(q, k, v, **kw)
        shapes.append((q.shape[1], k.shape[1], kw.get("causal", True)))
        return out

    ops.flash_attention = spy
    try:
        yield
    finally:
        ops.flash_attention = inner


def _encdec_serve(torch, results, arch: str, card: str):
    """One family at full width with the quickstart flags (whisper: a pool
    with its frame pages, --pool-pages; internvl: --max-len 320): the
    engine's warnings, the kernel path's streams, launches counted exactly,
    tok/s and the decode tick; then the plain path's streams (flash
    attention in prefill included), held to each other by the near-tie
    rule.  Returns (serve, cfg, engine, plan, outputs)."""
    import functools
    import warnings

    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.kernels import flash_attention as FA

    flags = (["--pool-pages", str(WHISPER_POOL)] if arch == WHISPER
             else ["--max-len", str(INTERNVL_MAX_LEN)])
    serve, ap, args = _serve_args(["--arch", arch, *flags])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg, engine, plan = serve.build_engine(args, ap)
    torch.cuda.synchronize()
    said = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    for m in said:
        log(f"{arch}: engine warning: {m}")
    want = ["share_prefix"] + (["kv_dtype=int8"] if arch == WHISPER else [])
    if any(not any(w in m for m in said) for w in want) or engine.registry is not None:
        raise AssertionError(f"{arch}: expected the warnings {want} and no prefix sharing")
    if (engine.kv_dtype is None) != (arch == WHISPER):
        raise AssertionError(f"{arch}: KV cache dtype {engine.kv_dtype}")
    log(f"{arch}: model + plan + engine built in {time.perf_counter() - t0:.1f}s "
        f"({cfg.n_layers} layers{f' + {cfg.enc_layers} encoder' if cfg.enc_layers else ''}, "
        f"d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, tied {cfg.tie_embeddings}; pool {engine.num_pages} "
        f"pages, {engine.xpages_per_seq} frame pages a request; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB during the build)")
    b5 = "wgmma" if arch == WHISPER else "dense_tile"
    reqs = _extras_requests(serve, cfg, args.max_new)
    ticks, shapes = [], []
    with _flash_shapes(shapes):
        outputs, launches, dt = _serve_and_check(serve, engine, cfg, args.max_new, arch,
                                                 reqs=reqs, ticks=ticks, b5_regime=b5)
    st = engine.stats
    b3, b6 = FA.paged_decode_attention, FA.flash_attention
    log(f"{arch}: {st.prefills} prefills, {st.decode_steps} decode steps; B3 by query "
        f"positions {b3.launches_by_t}, non-causal {b3.launches_noncausal}; B6 by window "
        f"{b6.launches_by_window}, non-causal {b6.launches_noncausal}; B6 (Sq, Sk, causal) "
        f"{sorted(set(shapes))}")
    n_dec = cfg.n_layers * st.decode_steps
    if launches["block_sparse_matmul_col"] or launches["block_sparse_matmul"] <= 0:
        raise AssertionError(f"{arch}: B1 must serve every packed leaf, B4 none: {launches}")
    if b3.launches_by_t != {1: n_dec}:
        raise AssertionError(f"{arch}: B3 causal launches {b3.launches_by_t}, expected "
                             f"{{1: {n_dec}}}")
    if arch == WHISPER:
        enc = [s for s in shapes if s == (cfg.n_frames, cfg.n_frames, False)]
        cross = [s for s in shapes if s[1] == cfg.n_frames and s[0] != cfg.n_frames
                 and not s[2]]
        want6 = (cfg.enc_layers + cfg.n_layers) * st.prefills
        if (b3.launches_noncausal != n_dec or b6.launches_noncausal != want6
                or b6.launches_by_window or len(enc) != cfg.enc_layers * st.prefills
                or len(cross) != cfg.n_layers * st.prefills):
            raise AssertionError(
                f"{arch}: B3 non-causal {b3.launches_noncausal} (expected {n_dec}), B6 "
                f"non-causal {b6.launches_noncausal} (expected {want6}: encoder {len(enc)}, "
                f"cross {len(cross)}), causal {b6.launches_by_window}")
        if launches["fused_gate_up"] or launches["quant_matmul"]:
            raise AssertionError(f"{arch}: the gelu MLP and the tied head take B1 only: "
                                 f"{launches}")
        _row(results, "paged_decode_attention", "whisper cross")["launches"] = n_dec
        _row(results, "flash_attention", "whisper encoder")["launches"] = len(enc)
        _row(results, "flash_attention", "whisper cross")["launches"] = len(cross)
    else:
        if launches["quant_matmul"] != st.prefills + st.decode_steps or b3.launches_noncausal \
                or launches["fused_gate_up"] <= 0 or b6.launches_noncausal \
                or b6.launches_by_window:
            raise AssertionError(f"{arch}: B5 {launches['quant_matmul']} (expected one a "
                                 f"prefill and a step: {st.prefills + st.decode_steps}), B2 "
                                 f"{launches['fused_gate_up']}, B3 non-causal "
                                 f"{b3.launches_noncausal}, B6 {b6.launches_by_window} / "
                                 f"{b6.launches_noncausal}")
        _row(results, "paged_decode_attention", "internvl serve")["launches"] = n_dec
        _row(results, "quant_matmul", "internvl head")["launches"] = launches["quant_matmul"]
    step_ms, n_steps = _decode_tick_ms(ticks)
    log(f"{arch}: {st.completed}/8 FINISHED, audit clean, {st.decode_tokens / dt:.1f} tok/s, "
        f"decode tick {step_ms:.2f} ms (median of {n_steps}, batch {st.mean_batch:.2f}) on "
        f"{card}")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the build's warnings again, logged above
        plain = _engine_like(engine, plan, params=with_use_kernel(engine.params, False),
                             num_pages=engine.num_pages)
    plain.attention_kernel = False
    plain.api = dataclasses.replace(plain.api, prefill=functools.partial(plain.api.prefill,
                                                                         use_kernel=False))
    p_reqs = _extras_requests(serve, cfg, args.max_new)
    p_out, p_launches, p_dt = _serve_and_check(serve, plain, cfg, args.max_new, f"{arch} plain",
                                               reqs=p_reqs, b5_regime=b5)
    if any(p_launches.values()) or b6.launches_noncausal or b6.launches_by_window:
        raise AssertionError(f"{arch} plain: a kernel launched on the plain path: {p_launches}, "
                             f"B6 {b6.launches_noncausal} / {b6.launches_by_window}")
    _streams_near_tie(torch, cfg, plain.params, f"{arch} kernels vs plain",
                      [r.prompt for r in p_reqs], p_out, outputs, [r.extras for r in p_reqs])
    log(f"{arch} plain: {plain.stats.decode_tokens / p_dt:.1f} tok/s on {card}")
    del plain
    torch.cuda.empty_cache()
    return serve, cfg, engine, plan, outputs


def _encdec_parity(torch, cfg, params, gen) -> None:
    """whisper-tiny at full width, kernels vs plain versions on the same
    inputs: a batch of 2 prefills of 40 tokens over 1500 random frames (the
    encoder and the cross prefill through B6 non-causal), then 16
    teacher-forced decode steps on a paged cache filled from the prefill
    (self-attention B3 causal, cross-attention B3 non-causal over the frame
    pages); the logits must agree within PATH_RTOL at every step, and the
    kernel pass launches B6 (enc_layers + n_layers) times and B3
    non-causal n_layers a step."""
    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import encdec as E

    B, S, steps, ps, nf = 2, 40, 16, 16, cfg.n_frames
    P, Px = -(-(S + steps) // ps), -(-nf // ps)
    frames = torch.randn((B, nf, cfg.d_model), generator=gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (steps, B), generator=gen, device="cuda")
    logits, counts = {}, {}
    for name, (p, uk) in {"kernels": (params, True),
                          "plain": (with_use_kernel(params, False), False)}.items():
        FA.flash_attention.launches_noncausal = FA.paged_decode_attention.launches_noncausal = 0
        c1 = E.init_cache(cfg, B, S, torch.bfloat16, device="cuda")
        lg, c1 = E.prefill(cfg, p, prompt, frames, c1, use_kernel=uk)
        out = [lg[:, 0].float()]
        cache = E.init_cache(cfg, B, P * ps, torch.bfloat16, page_size=ps,
                             num_pages=1 + B * (P + Px), device="cuda")
        cache["page_table"].copy_(1 + torch.arange(B * P, device="cuda").reshape(B, P))
        cache["xpage_table"].copy_(1 + B * P + torch.arange(B * Px, device="cuda")
                                   .reshape(B, Px))
        for c, cx, one in zip(cache["layers"], cache["x"], c1["layers"]):
            for pk, ck in (("k_pages", "k"), ("v_pages", "v")):
                c[pk][1:1 + B * P].view(B, P * ps, cfg.n_kv_heads, cfg.hd)[:, :S] = one[ck]
            for pk, ck in (("k_pages", "xk"), ("v_pages", "xv")):
                cx[pk][1 + B * P:].view(B, Px * ps, cfg.n_kv_heads, cfg.hd)[:, :nf] = one[ck]
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int32, device="cuda")
            lg, cache = E.decode_step(cfg, p, cache, tokens[t][:, None], pos, use_kernel=uk)
            out.append(lg[:, 0].float())
        logits[name] = torch.stack(out)
        counts[name] = (FA.flash_attention.launches_noncausal,
                        FA.paged_decode_attention.launches_noncausal)
    torch.cuda.synchronize()
    a, b = logits["kernels"], logits["plain"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("whisper parity: non-finite logits")
    worst = float(((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2))).max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    want = ((cfg.enc_layers + cfg.n_layers, cfg.n_layers * steps), (0, 0))
    log(f"parity whisper-tiny: prefill of {S} tokens over {nf} frames + {steps} paged decode "
        f"steps x {B}, max |dlogit| / max |logit| = {worst:.3e} (tolerance {PATH_RTOL}), "
        f"greedy agreement {agree:.4f}; (B6, B3) non-causal launches kernels / plain "
        f"{counts['kernels']} / {counts['plain']}")
    if (counts["kernels"], counts["plain"]) != want:
        raise AssertionError(f"whisper parity: non-causal launches {counts}, expected {want}")
    if not worst <= PATH_RTOL:
        raise AssertionError(f"whisper parity: kernel path logits differ from the plain path: "
                             f"{worst:.3e}")


def _internvl_long(torch, results, serve, cfg, engine, plan, card: str) -> None:
    """internvl2-2b's served long prompt: 256 patches + 1776 tokens = 2032
    positions (max_len 2048), so the prefill runs B6 causal at hd 128, 16/8
    heads, once a layer, counted into B6's "internvl" row; the first tick
    (the prefill and one decode step) timed."""
    import warnings

    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.engine import Request

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # prefix sharing off, logged by the serve run
        eng = _engine_like(engine, plan, max_len=2048, max_batch=1)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, size=INTERNVL_LONG).astype(np.int32)
    reqs = [Request(uid=0, prompt=prompt, max_new_tokens=16,
                    extras=serve.request_extras(cfg, rng))]
    ticks = []
    FA.flash_attention.launches = 0
    _, launches, dt = _serve_and_check(serve, eng, cfg, 16, f"{cfg.name} long", reqs,
                                       ticks=ticks, b5_regime="dense_tile")
    by_w = dict(FA.flash_attention.launches_by_window)
    log(f"{cfg.name} long: B6 launches {FA.flash_attention.launches}, by window {by_w}, first "
        f"tick (prefill of {cfg.n_patches} patches + {INTERNVL_LONG} tokens + one decode step) "
        f"{1e3 * ticks[0][0]:.3f} ms, {eng.stats.decode_tokens / dt:.1f} tok/s on {card}")
    if by_w != {0: cfg.n_layers} or FA.flash_attention.launches != cfg.n_layers:
        raise AssertionError(f"{cfg.name} long: B6 launches by window {by_w}, expected "
                             f"{{0: {cfg.n_layers}}}")
    _row(results, "flash_attention", "internvl")["launches"] = by_w[0]
    del eng
    torch.cuda.empty_cache()


def phase_encdec_vlm(torch, results: dict, card: str) -> None:
    """whisper-tiny (4 + 4 layers, d 384, 6/6 heads, hd 64, 1500 frames,
    tied 51865 head) and internvl2-2b (24 layers, d 2048, 16/8 heads, hd
    128, 256 patches, untied 92553 head) at full width and depth, random
    weights from seed 0, the quickstart flags, the serve phase's prompts
    with random frames or patches: each through the kernels and the plain
    versions (``_encdec_serve``); whisper's model path held to its plain
    versions (``_encdec_parity``); internvl's ``_path_parity`` at prompts
    of 36, 40 and 1776 tokens after its patches (B6 at 2032 positions, once
    a layer) and its served long prompt (``_internvl_long``).  Returns each
    family's kernel path's streams (the mesh phase holds its cases to
    them)."""
    from repro_torch.kernels import flash_attention as FA

    streams = {}
    for arch in (WHISPER, INTERNVL):
        serve, cfg, engine, plan, outputs = _encdec_serve(torch, results, arch, card)
        streams[arch] = outputs
        gen = torch.Generator(device="cuda")
        gen.manual_seed(13)
        if arch == WHISPER:
            _encdec_parity(torch, cfg, engine.params, gen)
        else:
            _zero_launches((FA.flash_attention,))
            _path_parity(torch, cfg, engine.params, f"{arch} quant_sparse", gen,
                         lengths=(36, 40, INTERNVL_LONG))
            log(f"parity {arch}: B6 by window {FA.flash_attention.launches_by_window} (the "
                f"kernel pass's {cfg.n_patches} + {INTERNVL_LONG} positions)")
            if FA.flash_attention.launches_by_window != {0: cfg.n_layers}:
                raise AssertionError(f"{arch} parity: B6 did not run once a layer at "
                                     f"{LONG_M} positions")
            _internvl_long(torch, results, serve, cfg, engine, plan, card)
        del engine, plan
        torch.cuda.empty_cache()
    return streams


# ---------------------------------------------------------------------------
# the recurrent families (recurrentgemma-2b, xlstm-350m), then mixed serving
# ---------------------------------------------------------------------------

RG, XLSTM = "recurrentgemma-2b", "xlstm-350m"
# recurrentgemma's second long prompt: past its 2048-token window, so a
# late query sees only the last 2048 keys (the window bites)
RG_BITES = 4080
# xlstm-350m's long prompt: its sLSTM prefill is a loop over the tokens
XLSTM_LONG = 512
# the mixed phase's workload (closed-loop, --compress none, pages of 16)
MIX = "tinyllama-1.1b:2,recurrentgemma-2b:1,whisper-tiny:1"


def _mix_args(*extra):
    """The serve CLI's parser and the mixed phase's flags (and ``extra``)."""
    from repro_torch.launch import serve

    ap = serve.build_parser()
    return ap, ap.parse_args(["--workload-mix", MIX, "--compress", "none", "--page-size", "16",
                              "--requests", "8", "--max-new", "16", "--prompt-len", "40",
                              "--max-batch", "8", "--max-len", "128", *extra])


@contextlib.contextmanager
def _shape_launches(counts: dict):
    """Counts the launches of B1, B4, B2 and B5 by (kernel, K, N) that the
    model path makes: ``weight_plan`` calls them through ``ops``, whose
    wrappers launch (the inputs are on the card) unless the plan node says
    ``use_kernel=False``."""
    from repro_torch.kernels import ops

    names = ("block_sparse_matmul", "fused_gate_up", "quant_matmul")
    inner = {n: getattr(ops, n) for n in names}

    def count(key):
        counts[key] = counts.get(key, 0) + 1

    def bsm(x2, w):
        y = inner["block_sparse_matmul"](x2, w)
        if w.use_kernel:
            count(("B1" if w.walk is not None else "B4",) + tuple(w.shape))
        return y

    def fgu(x2, g, u, activation):
        y = inner["fused_gate_up"](x2, g, u, activation)
        if g.use_kernel and u.use_kernel:
            count(("B2",) + tuple(g.shape))
        return y

    def qmm(x2, w, activation="linear"):
        y = inner["quant_matmul"](x2, w, activation)
        if w.use_kernel:
            count(("B5",) + tuple(w.q.shape))
        return y

    ops.block_sparse_matmul, ops.fused_gate_up, ops.quant_matmul = bsm, fgu, qmm
    try:
        yield
    finally:
        for n, f in inner.items():
            setattr(ops, n, f)


@contextlib.contextmanager
def _paged_shapes(shapes: list):
    """Records (H, KVH, hd, page dtype, causal) of every B3 launch the model
    path makes (``layers.paged_decode_attention`` calls
    ``ops.paged_decode_attention``, which launches unless
    ``use_kernel=False``)."""
    from repro_torch.kernels import ops

    inner = ops.paged_decode_attention

    def spy(q, k_pages, v_pages, page_table, pos, **kw):
        out = inner(q, k_pages, v_pages, page_table, pos, **kw)
        if kw.get("use_kernel", True):
            shapes.append((q.shape[2], k_pages.shape[2], q.shape[3], str(k_pages.dtype),
                           kw.get("causal", True)))
        return out

    ops.paged_decode_attention = spy
    try:
        yield
    finally:
        ops.paged_decode_attention = inner


def _pass_launches(cfg) -> dict:
    """{(kernel, K, N): launches} of one model pass (a prefill or a decode
    step) of a recurrent family under the quickstart plan (blocks of 128):
    a ``rec`` layer's w_gate / w_x / w_out and a ``local`` layer's q/k/v/o
    through B1, their gelu_glu pair through B2 and w_down through B1; an
    mLSTM's w_u / w_z / w_down through B1 and its w_if (N 8) through B5; an
    sLSTM's w_gates through B1 and its w_up (N 2730) and w_down (K 1365)
    through B5; an untied head through B5."""
    from repro_torch.models import ssm as SSM

    d, out = cfg.d_model, {}

    def add(key, n=1):
        out[key] = out.get(key, 0) + n

    for kind in cfg.layer_kinds:
        if kind == "rec":
            w = cfg.lru_dim or d
            add(("B1", d, w), 2)
            add(("B1", w, d))
        elif kind == "local":
            qd, kvd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
            add(("B1", d, qd))
            add(("B1", d, kvd), 2)
            add(("B1", qd, d))
        elif kind == "mlstm":
            add(("B1", d, 2 * d), 2)
            add(("B5", d, 2 * cfg.n_heads))
            add(("B1", 2 * d, d))
        elif kind == "slstm":
            f = SSM.slstm_up(cfg)
            add(("B1", d, 4 * d))
            add(("B5", d, 2 * f))
            add(("B5", f, d))
        if kind in ("rec", "local"):
            add(("B2", d, cfg.d_ff))
            add(("B1", cfg.d_ff, d))
    if not cfg.tie_embeddings:
        add(("B5", d, cfg.vocab))
    return out


def _b1_row(torch, timer, gen, results, key: str, shapes, M: int = 8) -> None:
    """B1 over a family's packed projection shapes (K x N each, int8, at q
    0.5 or the q of a (K, N, q) shape) at M rows (8), summed as the
    tinyllama row sums one layer's five: each held to its plain version
    and launched twice for the same bits; timed beside torch.matmul on the
    dequantized bf16 weights."""
    from repro_torch.kernels import block_sparse as BS

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    err = rel = 0.0
    for K, N, *q in shapes:
        p = _packed(torch, K, N, gen, *q)
        args = (p.blocks, p.block_rows, p.counts, p.scales)
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        y = BS.block_sparse_matmul(x, *args)
        d, r = _held(torch, f"B1 {K}x{N} M={M}", y,
                     BS.block_sparse_matmul(x, *args, use_kernel=False), KERNEL_RTOL)
        err, rel = max(err, d), max(rel, r)
        _deterministic(torch, f"B1 {K}x{N} M={M}", y, BS.block_sparse_matmul(x, *args))
        surv = int(p.counts.sum())
        tot["bytes"] += (M * K * 2 + surv * 128 * 128 + surv * 4 + p.counts.numel() * 4
                         + N * 4 + M * N * 2)
        tot["flops"] += 2.0 * M * surv * 128 * 128
        wd = _dense_bf16(torch, p)
        tot["ms"] += timer(lambda: BS.block_sparse_matmul(x, *args))
        tot["plain_ms"] += timer(lambda: BS.block_sparse_matmul(x, *args, use_kernel=False))
        tot["library_ms"] += timer(lambda: torch.matmul(x, wd))
    b_ms, b_by = bound(tot["bytes"], tot["flops"])
    label = " + ".join(f"{K}x{N}" + "".join(f" q {v}" for v in q) for K, N, *q in shapes)
    log(f"B1 {key} ({label}) M={M}: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
        f"torch.matmul(dense bf16) {tot['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    _add_row(results, "block_sparse_matmul", {
        "key": key, "shape": f"sum of {label} at M={M}", "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"], "bound_ms": b_ms,
        "bound_by": b_by}, err, rel)


# the recurrent families' B1 shapes, one of each (the rows sum them)
RG_B1 = ((2560, 2560), (2560, 256), (7680, 2560))
XLSTM_B1 = ((1024, 2048), (2048, 1024), (1024, 4096))


def phase_recurrent_kernels(torch, results: dict) -> None:
    """The kernels at the recurrent families' and the mixed run's new
    shapes, each against its plain version, twice for the same bits, timed
    beside its plain version and its library call: B6 at recurrentgemma's
    10/1 heads (G 10), hd 256, window 2048, at 2048 tokens and at 4096
    (where the window bites); B2 gelu_glu at its 2560 x 7680 pair; B1 at
    its projections (2560x2560, 2560x256, 7680x2560) and at xlstm-350m's
    (1024x2048, 2048x1024, 1024x4096); B5 at xLSTM's ragged leaves in the
    dense_tile regime (w_if 1024x8, sLSTM w_up 1024x2730, w_down 1365x1024)
    and at its 1024x50304 head (wgmma); B3 over bf16 pages at tinyllama's
    32/4 heads (the mixed run serves --compress none with an fp cache)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    rg, xl = get_config(RG), get_config(XLSTM)
    for key, S in (("rg window", 2048), ("rg window bites", 4096)):
        _b6_row(torch, timer, gen, results, key, rg.n_heads, rg.n_kv_heads, rg.hd,
                window=rg.local_window, S=S)
    _b2_row(torch, timer, gen, results, "rg gelu", rg.d_model, rg.d_ff)
    _b1_row(torch, timer, gen, results, "rg", RG_B1)
    _b1_row(torch, timer, gen, results, "xlstm", XLSTM_B1)
    d, f = xl.d_model, SSM.slstm_up(xl)
    for key, K, N in (("xlstm w_if", d, 2 * xl.n_heads), ("xlstm w_up", d, 2 * f),
                      ("xlstm w_down", f, d)):
        _b5_head_row(torch, timer, gen, results, key, K, N, regime="dense_tile")
    _b5_head_row(torch, timer, gen, results, "xlstm head", d, xl.vocab, regime="wgmma")
    tl = get_config("tinyllama-1.1b")
    _b3_row(torch, timer, gen, results, "mixed bf16", tl.n_heads, tl.n_kv_heads, tl.hd, 1,
            int8=False)
    torch.cuda.empty_cache()


def _recurrent_serve(torch, results, arch: str, card: str):
    """One recurrent family at full width with the quickstart flags: the
    engine's warnings (no global layer to page; xlstm-350m has no KV for
    int8), the kernel path's streams with its launches by shape exactly
    ``_pass_launches`` a pass (B3, B4 and B6 none: the local rings are read
    by plain decode attention and the prompts are short), tok/s and the
    decode tick; then the plain path's streams, held to the kernels' by the
    near-tie rule.  Returns (serve, cfg, engine, plan, the kernel path's
    streams)."""
    import warnings

    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_matmul as QM
    from repro_torch.models import ssm as SSM

    serve, ap, args = _serve_args(["--arch", arch])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg, engine, plan = serve.build_engine(args, ap)
    torch.cuda.synchronize()
    said = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    for m in said:
        log(f"{arch}: engine warning: {m}")
    want = ["does not thread a page table"] + (["kv_dtype=int8"] if arch == XLSTM else [])
    if any(not any(w in m for m in said) for w in want) or engine.paged:
        raise AssertionError(f"{arch}: expected the warnings {want} and a contiguous cache")
    if (engine.kv_dtype is None) != (arch == XLSTM):
        raise AssertionError(f"{arch}: KV cache dtype {engine.kv_dtype}")
    log(f"{arch}: model + plan + engine built in {time.perf_counter() - t0:.1f}s "
        f"({cfg.n_layers} layers {dict((k, cfg.layer_kinds.count(k)) for k in set(cfg.layer_kinds))}, "
        f"d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, tied {cfg.tie_embeddings}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB during the build)")
    ticks, counts = [], {}
    FA.flash_attention.launches = 0
    with _shape_launches(counts):
        outputs, launches, dt = _serve_and_check(serve, engine, cfg, args.max_new, arch,
                                                 ticks=ticks, b5_regime=None)
    st = engine.stats
    passes = st.prefills + st.decode_steps
    want = {k: n * passes for k, n in _pass_launches(cfg).items()}
    log(f"{arch}: {st.prefills} prefills + {st.decode_steps} decode steps; launches by "
        f"(kernel, K, N) {dict(sorted(counts.items()))}")
    if counts != want:
        raise AssertionError(f"{arch}: launches by shape {counts}, expected {want}")
    head = want.get(("B5", cfg.d_model, cfg.vocab), 0)
    tile = sum(n for k, n in want.items() if k[0] == "B5") - head
    f5 = QM.quant_matmul
    if (f5.wgmma_launches, f5.dense_tile_launches) != (head, tile):
        raise AssertionError(f"{arch}: B5 wgmma / dense_tile {f5.wgmma_launches} / "
                             f"{f5.dense_tile_launches}, expected {head} / {tile}")
    if launches["paged_decode_attention"] or launches["block_sparse_matmul_col"] \
            or FA.flash_attention.launches:
        raise AssertionError(f"{arch}: B3 / B4 / B6 launched: {launches}, B6 "
                             f"{FA.flash_attention.launches}")
    d, f = cfg.d_model, SSM.slstm_up(cfg)
    rows = ({"rg gelu": ("fused_gate_up", [("B2", d, cfg.d_ff)]),
             "rg": ("block_sparse_matmul", [("B1",) + s for s in RG_B1])} if arch == RG else
            {"xlstm": ("block_sparse_matmul", [("B1",) + s for s in XLSTM_B1]),
             "xlstm w_if": ("quant_matmul", [("B5", d, 2 * cfg.n_heads)]),
             "xlstm w_up": ("quant_matmul", [("B5", d, 2 * f)]),
             "xlstm w_down": ("quant_matmul", [("B5", f, d)]),
             "xlstm head": ("quant_matmul", [("B5", d, cfg.vocab)])})
    for key, (name, keys) in rows.items():
        _row(results, name, key)["launches"] = sum(counts.get(k, 0) for k in keys)
    step_ms, n_steps = _decode_tick_ms(ticks)
    log(f"{arch}: {st.completed}/8 FINISHED, {st.decode_tokens / dt:.1f} tok/s, decode tick "
        f"{step_ms:.2f} ms (median of {n_steps}, batch {st.mean_batch:.2f}) on {card}")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the build's warnings again, logged above
        plain = _engine_like(engine, plan, params=with_use_kernel(engine.params, False))
    plain.attention_kernel = False
    p_out, p_launches, p_dt = _serve_and_check(serve, plain, cfg, args.max_new, f"{arch} plain",
                                               b5_regime=None)
    if any(p_launches.values()):
        raise AssertionError(f"{arch} plain: a kernel launched on the plain path: {p_launches}")
    prompts = [r.prompt for r in _serve_requests(cfg, args.max_new)]
    _streams_near_tie(torch, cfg, plain.params, f"{arch} kernels vs plain", prompts, p_out,
                      outputs)
    log(f"{arch} plain: {plain.stats.decode_tokens / p_dt:.1f} tok/s on {card}")
    del plain
    torch.cuda.empty_cache()
    return serve, cfg, engine, plan, outputs


def _timed_prefill(torch, cfg, params, S: int, gen, card: str) -> None:
    """A batch-1 prefill of S random tokens through the kernels: its device
    time (CUDA events, after a first untimed call), then, in a second call
    with the card synchronized around each, the recurrent cells' own time
    by kind and the RG-LRU's log-depth scan apart (host clock)."""
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T

    tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device="cuda")

    def run():
        cache = T.init_cache(cfg, 1, S, torch.bfloat16, kv_dtype=torch.int8, device="cuda")
        return T.prefill(cfg, params, tokens, cache)[0]

    first = run()
    if not bool(torch.isfinite(first).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits from a {S}-token prefill")
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    total, wall = e0.elapsed_time(e1), 1e3 * (time.perf_counter() - t0)
    parts: dict = {}

    def timed(fn, key):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts[key] = parts.get(key, 0.0) + 1e3 * (time.perf_counter() - t)
            return out
        return inner

    cells, scan = dict(T._CELLS), R.linear_scan
    T._CELLS.update({k: timed(f, f"{k} cells") for k, f in cells.items()})
    R.linear_scan = timed(scan, "RG-LRU scan")
    try:
        run()
    finally:
        T._CELLS.update(cells)
        R.linear_scan = scan
    log(f"{cfg.name} prefill of {S} tokens: {total:.3f} ms (events; {wall:.3f} ms wall) on "
        f"{card}; with a sync around each cell: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(parts.items())))


def _rg_long(torch, results, serve, cfg, engine, plan, card: str) -> None:
    """recurrentgemma-2b's long prompts served one at a time (max_len
    4096): LONG_M and RG_BITES tokens, each prefill's local layers through
    B6 windowed at G 10 (once a layer, counted by window and by (Sq, Sk) at
    the launch site into the two B6 rows); each prefill tick timed."""
    import warnings

    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serving.engine import Request

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the paging fallback, logged by the serve run
        eng = _engine_like(engine, plan, max_len=RG_BITES + 16, max_batch=1)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate((LONG_M, RG_BITES))]
    ticks, shapes = [], []
    FA.flash_attention.launches = 0
    with _flash_shapes(shapes):
        _, launches, dt = _serve_and_check(serve, eng, cfg, 16, f"{cfg.name} long", reqs,
                                           ticks=ticks)
    n_local = cfg.layer_kinds.count("local")
    by_w = dict(FA.flash_attention.launches_by_window)
    first = [1e3 * t for t, p, _ in ticks if p]
    log(f"{cfg.name} long: B6 launches {FA.flash_attention.launches}, by window {by_w}, (Sq, Sk, "
        f"causal) {sorted(set(shapes))}; prefill ticks (prefill + one decode step) "
        + ", ".join(f"{n} tokens {ms:.3f} ms" for n, ms in zip((LONG_M, RG_BITES), first))
        + f" on {card}")
    want = {(LONG_M, LONG_M, True): n_local, (RG_BITES, RG_BITES, True): n_local}
    got = {k: shapes.count(k) for k in set(shapes)}
    if by_w != {cfg.local_window: 2 * n_local} or got != want:
        raise AssertionError(f"{cfg.name} long: B6 by window {by_w}, by shape {got}; expected "
                             f"{n_local} windowed launches at each length")
    _row(results, "flash_attention", "rg window")["launches"] = got[(LONG_M, LONG_M, True)]
    _row(results, "flash_attention", "rg window bites")["launches"] = \
        got[(RG_BITES, RG_BITES, True)]
    del eng
    torch.cuda.empty_cache()


def phase_recurrent(torch, results: dict, card: str) -> None:
    """recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local attention of window
    2048; d 2560, 10/1 heads, hd 256, d_ff 7680, tied 256000 head) and
    xlstm-350m (24 layers: 12 mLSTM, 12 sLSTM; d 1024, 4 heads, untied
    50304 head) at full width and depth, random weights from seed 0, the
    quickstart flags and the serve phase's requests: each through the
    kernels and the plain versions (``_recurrent_serve``), then
    ``_path_parity`` (prefills of 36, 40 and 2032 tokens -- xlstm: 512 --
    and teacher-forced decode), then the long prefill: recurrentgemma's
    served long prompts (``_rg_long``) and a timed prefill for each
    (``_timed_prefill``: 2032 tokens, and xlstm's 512).  Returns each
    family's kernel path's streams."""
    streams = {}
    for arch in (RG, XLSTM):
        serve, cfg, engine, plan, streams[arch] = _recurrent_serve(torch, results, arch, card)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(17)
        long_n = LONG_M if arch == RG else XLSTM_LONG
        _path_parity(torch, cfg, engine.params, f"{arch} quant_sparse", gen,
                     lengths=(36, 40, long_n))
        if arch == RG:
            _rg_long(torch, results, serve, cfg, engine, plan, card)
        _timed_prefill(torch, cfg, engine.params, long_n, gen, card)
        del engine, plan
        torch.cuda.empty_cache()
    return streams


def phase_mixed(torch, results: dict, card: str) -> None:
    """``--workload-mix tinyllama-1.1b:2,recurrentgemma-2b:1,whisper-tiny:1
    --compress none --page-size 16`` at full width (random weights from
    seed 0; 8 requests of 40 tokens split 4/2/2, 16 new each, batch 8),
    every member auditing every tick and the mixed engine auditing the
    shared pool's union every tick: every request finishes, the pool ends
    empty; B3 launches causal once a global layer a decode step of
    tinyllama and whisper (bf16 pages) and non-causal once a whisper
    decoder layer a step, B6 non-causal once a whisper encoder or decoder
    layer a prefill, and B1, B2, B4, B5 never (no plan); each member's
    streams equal the member served alone over the same weights and
    requests.  The tick time, tok/s and the pool's peak use are logged.
    Returns each member's streams."""
    import dataclasses as dc
    import warnings

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    from repro_torch.serving import mixed as PM
    from repro_torch.serving.engine import Request, RequestState, ServingEngine

    ap, args = _mix_args()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mix, apis, engine = serve.build_mixed(args, ap)
    torch.cuda.synchronize()
    for w in caught:
        log(f"mixed: engine warning: {w.message}")
    paged = sorted(n for n, e in engine.engines.items() if e.paged)
    log(f"mixed: {len(engine.engines)} members built in {time.perf_counter() - t0:.1f}s; shared "
        f"pool {engine.num_pages} pages of 16 for {paged}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if paged != ["tinyllama-1.1b", "whisper-tiny"] or engine.engine(RG).paged:
        raise AssertionError(f"mixed: paged members {paged}")
    for e in engine.engines.values():
        e.audit_every_step = True
    engine._audit_every_step = True
    reqs = serve.mixed_requests(args, mix, apis, engine)
    counters = _served_kernels()
    _zero_launches(counters)
    FA.flash_attention.launches = 0
    b3 = []
    for arch, r in reqs:
        engine.submit(arch, r)
    torch.cuda.synchronize()
    ticks, peak, t_all = [], 0, time.perf_counter()
    with _paged_shapes(b3):
        while engine._busy():
            s0 = engine.aggregate_stats()
            t = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            s1 = engine.aggregate_stats()
            ticks.append((time.perf_counter() - t, s1.prefills - s0.prefills,
                          s1.decode_steps - s0.decode_steps))
            peak = max(peak, engine.allocator.used_pages)
    dt = time.perf_counter() - t_all
    engine.audit_pages()
    launches = {c.__name__: c.launches for c in counters}
    st = engine.stats
    bad = [r.uid for _, r in reqs if r.state is not RequestState.FINISHED
           or len(r.output) != args.max_new]
    if bad or engine.allocator.used_pages:
        raise AssertionError(f"mixed: unfinished {bad}, {engine.allocator.used_pages} pages live")
    tl, wh = st["tinyllama-1.1b"], st["whisper-tiny"]
    wcfg = engine.engine("whisper-tiny").cfg
    tcfg = engine.engine("tinyllama-1.1b").cfg
    b3_by = {k: b3.count(k) for k in set(b3)}
    fa, pa = FA.flash_attention, FA.paged_decode_attention
    log(f"mixed: launches {launches}; B3 by (H, KVH, hd, pages, causal) {b3_by}; B6 non-causal "
        f"{fa.launches_noncausal}, by window {fa.launches_by_window}; members' prefills / decode "
        f"steps " + ", ".join(f"{n} {s.prefills}/{s.decode_steps}" for n, s in st.items()))
    pages = str(getattr(torch, tcfg.compute_dtype))  # --compress none: an fp cache
    text_key = (tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd, pages, True)
    want_b3 = {}
    for key, n in ((text_key, tcfg.n_layers * tl.decode_steps),
                   ((wcfg.n_heads, wcfg.n_kv_heads, wcfg.hd, pages, True),
                    wcfg.n_layers * wh.decode_steps),
                   ((wcfg.n_heads, wcfg.n_kv_heads, wcfg.hd, pages, False),
                    wcfg.n_layers * wh.decode_steps)):
        want_b3[key] = want_b3.get(key, 0) + n
    # past the 1024-token dense threshold, whisper's encoder and cross
    # prefill run B6 (its 1500 frames at full width)
    want_b6 = (wcfg.enc_layers + wcfg.n_layers) * wh.prefills if wcfg.n_frames > 1024 else 0
    if b3_by != want_b3 or fa.launches_noncausal != want_b6 \
            or fa.launches_by_window or pa.launches_noncausal != wcfg.n_layers * wh.decode_steps \
            or any(launches[n] for n in ("block_sparse_matmul", "block_sparse_matmul_col",
                                         "fused_gate_up", "quant_matmul")):
        raise AssertionError(f"mixed: launches {launches}, B3 {b3_by} (expected {want_b3}), B6 "
                             f"non-causal {fa.launches_noncausal} (expected {want_b6})")
    _row(results, "paged_decode_attention", "mixed bf16")["launches"] = b3_by[text_key]
    agg = engine.aggregate_stats()
    dec = [t for t, p, d in ticks if p == 0 and d > 0]  # a tick steps every live member
    step_ms, n_steps = 1e3 * statistics.median(dec), len(dec)
    log(f"mixed: {agg.completed}/{len(reqs)} FINISHED, audit clean every tick, pool peak "
        f"{peak} of {engine.num_pages - 1} pages, {engine.tick} ticks, {agg.decode_tokens / dt:.1f} "
        f"tok/s, decode tick {step_ms:.2f} ms (median of {n_steps} ticks with no prefill) on "
        f"{card}")
    outputs = {}
    for arch, r in reqs:
        outputs.setdefault(arch, []).append([int(t) for t in r.output])
    for arch, eng in engine.engines.items():
        cache = eng.config.cache
        spec = PM.WorkloadSpec(name=arch, cfg=eng.cfg, params=None, config=eng.config)
        pool = 1 + eng.max_batch * PM._pages_per_request(spec) if eng.paged else None
        conf = dc.replace(eng.config, cache=dc.replace(cache, allocator=None, num_pages=pool))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            solo = ServingEngine(eng.cfg, eng.params, config=conf, device=eng.device)
        mine = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        extras=r.extras) for a, r in reqs if a == arch]
        for r in mine:
            solo.submit(r)
        solo.run_until_done()
        solo.audit_pages()
        got = [[int(t) for t in r.output] for r in mine]
        log(f"mixed: {arch} alone: greedy tokens {token_digest(got)}, in the mix "
            f"{token_digest(outputs[arch])}")
        if got != outputs[arch]:
            raise AssertionError(f"mixed: {arch}'s streams in the mix differ from it served alone")
        del solo
    del engine
    torch.cuda.empty_cache()
    return outputs


# the autotune phase's tuned run: the CLI's defaults (the search space, the
# calibration task, its budget and workload), anneal, 64 trials, seed 0
TUNE_FLAGS = ("--arch", "tinyllama-1.1b", "--strategy", "anneal", "--trials", "64",
              "--seed", "0")
# (d)'s workload: each artifact's max_batch requests of 32 tokens, 10 new
TUNED_PROMPT, TUNED_NEW = 32, 10


def _tuned_args(path: str, *flags):
    """The serve CLI's parser and args for full-width tinyllama-1.1b served
    from the TunedPlan at ``path`` (its serving knobs override the flags)."""
    from repro_torch.launch import serve

    ap = serve.build_parser()
    return serve, ap, ap.parse_args(["--arch", "tinyllama-1.1b", "--autotune-plan", path,
                                     *flags])


def _hand_doc(cfg, cand, label: str) -> dict:
    """A TunedPlan artifact for a hand-made ``Candidate`` (no search): its
    prediction at the default space and constraints, the uniform
    candidate's beside it."""
    from repro_torch.core import autotune as AT

    space, cons = AT.SearchSpace(), AT.Constraints()
    pred = AT.predict(cfg, cand, space, cons)
    uni = AT.predict(cfg, AT.uniform_candidate(cfg, space), space, cons)
    if not pred.feasible:
        raise AssertionError(f"autotune: the {label} candidate is infeasible ({pred.reason})")
    res = AT.TuneResult(strategy=label, trials=0, seed=0, best=cand, prediction=pred,
                        uniform=uni, trace=(), acc_evals=(), budget=cons.max_acc_drop)
    return AT.tuned_plan_doc(cfg, res, space=space, constraints=cons)


def _doc_candidate(doc: dict):
    """The winning Candidate a TunedPlan artifact records."""
    from repro_torch.core import autotune as AT

    s = doc["serving"]
    return AT.Candidate(assign=tuple(tuple(a) for a in doc["assignments"]),
                        block=doc["plan"]["bk"], kv_dtype=s["kv_dtype"],
                        page_size=s["page_size"], spec_k=s["spec_k"], mesh=tuple(s["mesh"]))


def _implied_launches(plan, paged: bool) -> dict:
    """Which kernels (B1 and B2 by body) the plan's kinds make a served run
    launch (``_plan_kernel_shapes``); B3 reads a paged cache."""
    sh = _plan_kernel_shapes(plan)
    return {"block_sparse_matmul wgmma": bool(sh["b1 int8"]),
            "block_sparse_matmul fma": bool(sh["b1 fp32"]),
            "fused_gate_up wgmma": bool(sh["b2 int8"]), "fused_gate_up fma": bool(sh["b2 fp32"]),
            "quant_matmul": bool(sh["b5"]), "paged_decode_attention": paged}


def _plan_kernel_shapes(plan) -> dict:
    """The shapes each kernel takes in the plan, with their launches a
    forward (a stacked leaf's layers, else 1): a packed w_gate/w_up pair of
    one kind runs B2 -- (K, N, q, launches) under "b2 int8" or "b2 fp32" --
    any other packed leaf B1, on the wgmma body for an int8 payload ("b1
    int8") and the CUDA-core FMA body for block_sparse's fp32 one ("b1
    fp32"); an int8 leaf runs B5, (leaf, K, N, launches) under "b5" (an
    int8 ``tok`` is gathered: no kernel)."""
    out = {"b1 int8": [], "b1 fp32": [], "b2 int8": [], "b2 fp32": [], "b5": []}
    for path in sorted(plan.leaves):
        leaf = plan.leaves[path]
        name = path.rsplit("/", 1)[-1]
        K, N = leaf.shape[-2:] if len(leaf.shape) >= 2 else (0, 0)
        n = leaf.shape[0] if len(leaf.shape) == 3 else 1
        payload = "int8" if leaf.kind == "quant_sparse" else "fp32"
        pair = {"w_gate": "w_up", "w_up": "w_gate"}.get(name)
        other = plan.leaves.get(path[: -len(name)] + pair) if pair else None
        fused = other is not None and other.kind == leaf.kind and other.shape == leaf.shape
        if leaf.kind in ("quant_sparse", "block_sparse") and fused:
            if name == "w_gate":
                out[f"b2 {payload}"].append((K, N, leaf.q_prune, n))
        elif leaf.kind in ("quant_sparse", "block_sparse"):
            out[f"b1 {payload}"].append((K, N, leaf.q_prune, n))
        elif leaf.kind == "quant" and name != "tok":
            out["b5"].append((name, K, N, n))
    return out


def _check_implied(label: str, plan, paged: bool, launches: dict) -> dict:
    """Every kernel the plan implies launched, and no other (B4 never:
    every leaf carries its walk).  Returns the served kernels' launches
    with B1's and B2's split by body."""
    from repro_torch.kernels import block_sparse as BS
    from repro_torch.kernels import fused_gate_up as FG

    by_body = {k: launches[k] for k in ("quant_matmul", "paged_decode_attention",
                                        "block_sparse_matmul_col")}
    for fn in (BS.block_sparse_matmul, FG.fused_gate_up):
        by_body[f"{fn.__name__} fma"] = fn.fma_launches
        by_body[f"{fn.__name__} wgmma"] = fn.launches - fn.fma_launches
    want = _implied_launches(plan, paged)
    log(f"{label}: launches by kernel and body {by_body}; implied by the plan "
        f"{sorted(k for k, v in want.items() if v)}")
    bad = [k for k, v in want.items() if bool(by_body[k]) != v]
    if bad or by_body["block_sparse_matmul_col"]:
        raise AssertionError(f"{label}: launches {by_body} disagree with the plan at {bad}")
    return by_body


def _tuned_serve(torch, path: str, label: str, card: str):
    """Serve the serve phase's 8 requests from the TunedPlan at ``path``
    (build_engine with --autotune-plan and --share-prefix, under a tee):
    the launches the plan's kinds imply, and the greedy streams held to
    the same plan's plain versions (with_use_kernel(params, False), B3
    off) by the near-tie rule.  Returns (cfg, engine, plan, outputs,
    launches by body)."""
    from repro_torch.core.weight_plan import with_use_kernel

    serve, ap, args = _tuned_args(path, "--requests", "8", "--max-new", "16", "--prompt-len",
                                  "40", "--share-prefix")
    text, cfg, engine, plan, boot = _boot(torch, serve, ap, args)
    per_leaf = [ln for ln in text.splitlines() if ln.startswith("  ") and ": " in ln]
    if len(per_leaf) != len(plan.leaves):
        raise AssertionError(f"{label}: {len(per_leaf)} per-leaf summary lines for "
                             f"{len(plan.leaves)} leaves")
    log(f"{label}: booted in {boot:.1f}s: max_batch {engine.max_batch}, max_len "
        f"{engine.max_len}, kv {engine.kv_dtype}, paged {engine.paged} ({engine.page_size}, "
        f"{engine.num_pages if engine.paged else 0} pages); the plan's leaves:\n"
        + "\n".join(per_leaf))
    outputs, launches, dt = _serve_and_check(serve, engine, cfg, args.max_new, label)
    by_body = _check_implied(label, plan, engine.paged, launches)
    log(f"{label}: {engine.stats.decode_tokens / dt:.1f} tok/s at 8 requests on {card}")
    p_eng = _engine_like(engine, plan, params=with_use_kernel(engine.params, False),
                         num_pages=engine.config.cache.num_pages)
    p_eng.attention_kernel = False
    p_out, p_launches, _ = _serve_and_check(serve, p_eng, cfg, args.max_new, f"{label} plain")
    if any(p_launches.values()):
        raise AssertionError(f"{label} plain: a kernel launched: {p_launches}")
    prompts = [r.prompt for r in _serve_requests(cfg, args.max_new)]
    _streams_near_tie(torch, cfg, p_eng.params, f"{label} kernels vs plain", prompts, p_out,
                      outputs)
    del p_eng
    return cfg, engine, plan, outputs, by_body


def _tuned_ticks(torch, path: str, label: str, card: str) -> dict:
    """Serve the artifact's max_batch requests of TUNED_PROMPT random tokens
    (seed 3), TUNED_NEW new each, tick by tick: the median decode tick at
    full occupancy (ticks with one decode step at max_batch and no prefill)
    and its tok/s, against the artifact's predicted tok/s.  Then the same
    requests on the same plan's plain versions (B3 off), their greedy
    streams held to the kernels' by the near-tie rule: the kernels at the
    tuned batch's shapes, end to end."""
    import json as _json

    import numpy as np

    from repro_torch.core.weight_plan import with_use_kernel
    from repro_torch.serving.engine import Request

    with open(path) as f:
        doc = _json.load(f)
    B = int(doc["serving"]["max_batch"])
    serve, ap, args = _tuned_args(path, "--requests", str(B), "--max-new", str(TUNED_NEW),
                                  "--prompt-len", str(TUNED_PROMPT))
    _, cfg, engine, plan, boot = _boot(torch, serve, ap, args)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, TUNED_PROMPT).astype(np.int32) for _ in range(B)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=TUNED_NEW) for i, p in enumerate(prompts)]
    counters = _served_kernels()
    _zero_launches(counters)
    ticks, full = [], []
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    s = engine.stats
    while not all(r.terminal for r in reqs):
        p0, d0, n0 = s.prefills, s.decode_steps, s.decode_tokens
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ticks.append((dt, s.prefills - p0, s.decode_steps - d0))
        if s.prefills == p0 and s.decode_steps - d0 == 1 and s.decode_tokens - n0 == B:
            full.append(dt)
    wall = time.perf_counter() - t_all
    engine.audit_pages()
    if any(len(r.output) != TUNED_NEW for r in reqs) or not full:
        raise AssertionError(f"{label}: unfinished requests or no tick at full occupancy")
    by_body = _check_implied(label, plan, engine.paged, {c.__name__: c.launches
                                                          for c in counters})
    tick_ms = 1e3 * statistics.median(full)
    tok_s = B / (tick_ms / 1e3)
    pred = doc["predicted"]["tokens_per_s"]
    shapes, forwards = _plan_kernel_shapes(plan), s.prefills + s.decode_steps
    log(f"{label}: {B} requests of {TUNED_PROMPT} tokens, {TUNED_NEW} new, in {wall:.2f}s "
        f"(boot {boot:.1f}s, {s.prefills} prefills); decode tick at full occupancy "
        f"{tick_ms:.3f} ms (median of {len(full)}), {tok_s:.1f} tok/s measured vs "
        f"{pred:.1f} predicted ({tok_s / pred:.4f} of it) on {card}")
    p_eng = _engine_like(engine, plan, params=with_use_kernel(engine.params, False),
                         num_pages=engine.config.cache.num_pages)
    p_eng.attention_kernel = False
    outputs = [[int(t) for t in r.output] for r in reqs]
    del engine, plan
    p_reqs = [Request(uid=i, prompt=p, max_new_tokens=TUNED_NEW) for i, p in enumerate(prompts)]
    p_out, p_launches, _ = _serve_and_check(serve, p_eng, cfg, TUNED_NEW, f"{label} plain",
                                            reqs=p_reqs)
    if any(p_launches.values()):
        raise AssertionError(f"{label} plain: a kernel launched: {p_launches}")
    _streams_near_tie(torch, cfg, p_eng.params, f"{label} kernels vs plain at batch {B}",
                      prompts, p_out, outputs)
    del p_eng
    torch.cuda.empty_cache()
    return {"batch": B, "tick_ms": tick_ms, "tok_s": tok_s, "predicted": pred,
            "by_body": by_body, "shapes": shapes, "forwards": forwards,
            "kv_int8": doc["serving"]["kv_dtype"] == "int8"}


def _b1_fp32_row(torch, timer, gen, results, key: str, shapes, M: int) -> None:
    """B1 on an fp32 payload (a block_sparse leaf: the CUDA-core FMA body) at
    (K, N, q) ``shapes`` and M rows of bf16 x, summed: each held to its plain
    version (1e-2 of the max) and launched twice for the same bits; timed
    beside its plain version and torch.matmul of the fp32 x on the dense
    fp32 weight (TF32 off: the CUDA cores, as the kernel).  Bound: bytes
    over 3.35 TB/s vs fp32 operations over 67 TFLOP/s."""
    from repro_torch.core.sparse_format import block_sparse_to_dense
    from repro_torch.core.weight_plan import PlanConfig, pack_block_sparse
    from repro_torch.kernels import block_sparse as BS

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    err = rel = 0.0
    for K, N, q in shapes:
        w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
        p = pack_block_sparse(w, PlanConfig(q_prune=q), quant=False)
        args = (p.blocks, p.block_rows, p.counts, None)
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        n0 = BS.block_sparse_matmul.fma_launches
        y = BS.block_sparse_matmul(x, *args)
        if BS.block_sparse_matmul.fma_launches != n0 + 1:
            raise AssertionError(f"B1 {K}x{N} fp32 payload did not run the FMA body")
        d, r = _held(torch, f"B1 fp32 payload {K}x{N} q {q} M={M}", y,
                     BS.block_sparse_matmul(x, *args, use_kernel=False), KERNEL_RTOL)
        err, rel = max(err, d), max(rel, r)
        _deterministic(torch, f"B1 fp32 payload {K}x{N} M={M}", y,
                       BS.block_sparse_matmul(x, *args))
        surv = int(p.counts.sum())
        tot["bytes"] += (M * K * 2 + surv * 128 * 128 * 4 + surv * 4 + p.counts.numel() * 4
                         + M * N * 2)
        tot["flops"] += 2.0 * M * surv * 128 * 128
        wd, xf = block_sparse_to_dense(p.to_block_sparse()), x.float()
        tot["ms"] += timer(lambda: BS.block_sparse_matmul(x, *args))
        tot["plain_ms"] += timer(lambda: BS.block_sparse_matmul(x, *args, use_kernel=False))
        tot["library_ms"] += timer(lambda: torch.matmul(xf, wd))
    b_ms, b_by = bound(tot["bytes"], tot["flops"], FP32_FLOPS)
    label = " + ".join(f"{K}x{N} q {q}" for K, N, q in shapes)
    log(f"B1 {key} ({label}) M={M}: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
        f"torch.matmul(fp32) {tot['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    _add_row(results, "block_sparse_matmul", {
        "key": key, "shape": f"sum of {label} at M={M}, fp32 payload", "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"], "bound_ms": b_ms,
        "bound_by": b_by}, err, rel)


def _tuned_rows(torch, timer, gen, results, cfg, name: str, run: dict) -> None:
    """The kernels of a timed TunedPlan at its batch and its shapes (B1 on
    int8 payloads, B2, B5, B3 over its pages), each held to its plain
    version and timed; each row's launches are the timed run's, which must
    equal its leaves' launches a forward times the run's forwards."""
    sh, M, bb, fw = run["shapes"], run["batch"], run["by_body"], run["forwards"]

    def launched(kernel: str, key: str, want: int) -> None:
        if bb[kernel] != want:
            raise AssertionError(f"autotune {name}: {kernel} launched {bb[kernel]} times, its "
                                 f"leaves imply {want}")
        _row(results, kernel.split()[0], key)["launches"] = bb[kernel]

    if sh["b1 int8"]:
        _b1_row(torch, timer, gen, results, f"tuned {name}",
                [(K, N, q) for K, N, q, _ in sh["b1 int8"]], M=M)
        launched("block_sparse_matmul wgmma", f"tuned {name}",
                 fw * sum(n for *_, n in sh["b1 int8"]))
    if len(sh["b2 int8"]) == 1:  # the gate/up pair
        (K, N, q, n), = sh["b2 int8"]
        _b2_row(torch, timer, gen, results, f"tuned {name}", K, N, act="silu", Ms=(M,), q=q)
        launched("fused_gate_up wgmma", f"tuned {name}", fw * n)
    for leaf, K, N, _ in sh["b5"]:
        _b5_head_row(torch, timer, gen, results, f"tuned {name} {leaf}", K, N, M=M)
    if sh["b5"]:
        want = fw * sum(n for *_, n in sh["b5"])
        if bb["quant_matmul"] != want:
            raise AssertionError(f"autotune {name}: B5 launched {bb['quant_matmul']} times, "
                                 f"its leaves imply {want}")
        for leaf, _, _, n in sh["b5"]:
            _row(results, "quant_matmul", f"tuned {name} {leaf}")["launches"] = fw * n
    if bb["paged_decode_attention"]:
        _b3_row(torch, timer, gen, results, f"tuned {name}", cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                1, int8=run["kv_int8"], B=M)
        _row(results, "paged_decode_attention", f"tuned {name}")["launches"] = \
            bb["paged_decode_attention"]


def phase_autotune(torch, results: dict, card: str) -> None:
    """The offline autotuner at full width (see the module doc): (a) the CLI
    tunes tinyllama-1.1b and packs the winner into a plan cache, (b) the
    winner served against its plain versions, (c) a hand-made artifact that
    gives every representation a group, (d) the winner and the uniform
    candidate timed at their tuned batches, (e) a boot from the cache."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="autotune_")
    try:
        _autotune_steps(torch, results, card, tmp)
    finally:  # the plan cache holds 2 GB
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"autotune: phase {time.perf_counter() - t_phase:.1f}s")


def _autotune_steps(torch, results: dict, card: str, tmp: str) -> None:
    """phase_autotune's steps (a)-(e), its files under ``tmp``."""
    from repro_torch.core import autotune as AT
    from repro_torch.core.perf_model import HARDWARE_LABEL
    from repro_torch.launch import autotune as tune_cli

    out, cache = os.path.join(tmp, "tuned.json"), os.path.join(tmp, "plan")
    # (a) tune
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = tune_cli.main([*TUNE_FLAGS, "--out", out, "--plan-cache", cache])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"autotune: the CLI returned {rc}")
    doc = AT.load_tuned(out)
    text = "".join(tee.text)
    search_s = float(re.search(r"in ([0-9.]+)s; ", text).group(1))
    log(f"autotune: CLI {time.perf_counter() - t0:.1f}s (search {search_s:.1f}s, with the "
        f"calibration oracle on {card}; the rest packs and saves the plan cache)")
    for e in doc["accuracy"]["evals"]:
        log(f"autotune: oracle q {e['q']:.2f}: achieved q {e['achieved_q']:.2f}, base acc "
            f"{e['base_acc']:.4f}, acc {e['acc']:.4f}, drop {e['drop']:.4f}, ok {e['ok']}")
    s, p = doc["serving"], doc["predicted"]
    log(f"autotune: winner {doc['assignments']}; block {doc['plan']['bk']}, kv "
        f"{s['kv_dtype']}, page {s['page_size']} ({s['num_pages']} pages), batch "
        f"{s['max_batch']}; predicted {p['tokens_per_s']:.1f} tok/s vs uniform "
        f"{p['uniform_tokens_per_s']:.1f} ({p['speedup']:.4f}x; {HARDWARE_LABEL})")
    # (b) the winner through build_engine --autotune-plan, against plain
    cfg, engine, plan, win_out, win_body = _tuned_serve(torch, out, "autotune winner", card)
    want = AT.predict_plan_stats(AT.model_leaves(cfg), _doc_candidate(doc), AT.SearchSpace())
    got = (plan.n_weights, plan.surviving_weights, plan.weight_bytes,
           plan.b_weight_effective, plan.q_overhead_effective)
    if got != (want.n_weights, want.surviving, want.weight_bytes, want.b_weight_effective,
               want.q_overhead_effective):
        raise AssertionError(f"autotune: predicted stats {want} != compress() {got}")
    log(f"autotune: predict_plan_stats equals compress() at full width: {want.n_weights:,} "
        f"weights, {want.surviving:,} streamed, {want.weight_bytes:,.0f} bytes a step")
    fp32_shapes = [(K, N, q) for K, N, q, _ in _plan_kernel_shapes(plan)["b1 fp32"]]
    del engine, plan
    torch.cuda.empty_cache()
    # (c) every representation at least once: B1 on both bodies, B2, B5, B3
    # over int8 pages
    uni = AT.uniform_candidate(cfg, AT.SearchSpace())
    kinds = {"w_gate": ("quant_sparse", 0.5), "w_up": ("quant_sparse", 0.5),
             "wq": ("block_sparse", 0.5), "wo": ("quant_sparse", 0.5), "w_down": ("dense", 0.0)}
    cand = dataclasses.replace(uni, kv_dtype="int8", page_size=16, assign=tuple(
        (g,) + kinds.get(g, ("quant", 0.0)) for g, _, _ in uni.assign))
    all_path = AT.save_tuned(os.path.join(tmp, "all_kinds.json"),
                             _hand_doc(cfg, cand, "all-kinds"))
    _, engine, plan, _, by_body = _tuned_serve(torch, all_path, "autotune all-kinds", card)
    if not all(by_body[k] for k in ("block_sparse_matmul wgmma", "block_sparse_matmul fma",
                                    "fused_gate_up wgmma", "quant_matmul",
                                    "paged_decode_attention")):
        raise AssertionError(f"autotune all-kinds: a kernel did not launch: {by_body}")
    if not fp32_shapes:  # the winner packs no fp32 payload: time the all-kinds wq
        fp32_shapes = [(cfg.d_model, cfg.d_model, 0.5)]
    del engine, plan
    torch.cuda.empty_cache()
    # (d) the winner and the uniform candidate at their tuned batches
    uni_path = AT.save_tuned(os.path.join(tmp, "uniform.json"), _hand_doc(cfg, uni, "uniform"))
    runs = {name: _tuned_ticks(torch, path, f"autotune {name} timed", card)
            for name, path in (("winner", out), ("uniform", uni_path))}
    w, u = runs["winner"], runs["uniform"]
    log(f"autotune: measured speedup {w['tok_s'] / u['tok_s']:.4f}x vs predicted "
        f"{w['predicted'] / u['predicted']:.4f}x (winner {w['tok_s']:.1f} / uniform "
        f"{u['tok_s']:.1f} tok/s at batches {w['batch']} / {u['batch']}) on {card}")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    M = w["batch"] if w["by_body"]["block_sparse_matmul fma"] else 8
    _b1_fp32_row(torch, timer, gen, results, "fp32 payload", fp32_shapes, M)
    n_fma = w["by_body"]["block_sparse_matmul fma"] or by_body["block_sparse_matmul fma"]
    _row(results, "block_sparse_matmul", "fp32 payload")["launches"] = n_fma
    for name, run in runs.items():
        _tuned_rows(torch, timer, gen, results, cfg, name, run)
    # (e) the CLI's plan cache: a hit, and (b)'s streams
    serve, ap, args = _tuned_args(out, "--requests", "8", "--max-new", "16", "--prompt-len",
                                  "40", "--share-prefix", "--plan-cache", cache)
    text, cfg, engine, plan, boot = _boot(torch, serve, ap, args)
    if f"plan cache hit: {cache}" not in text:
        raise AssertionError("autotune: serving did not boot from the CLI's plan cache")
    c_out, launches, _ = _serve_and_check(serve, engine, cfg, args.max_new, "autotune cache")
    _check_implied("autotune cache", plan, engine.paged, launches)
    log(f"autotune: booted from the CLI's plan cache in {boot:.1f}s ({_dir_bytes(cache) / 1e9:.3f}"
        f" GB); greedy tokens {token_digest(c_out)} vs the winner's {token_digest(win_out)}")
    if c_out != win_out:
        raise AssertionError("autotune: the plan cache's streams differ from the winner's")
    del engine, plan
    torch.cuda.empty_cache()
    # (f) meshes: the search's screen over them, and (b)'s artifact on 1x2
    _tuned_meshes(torch, cfg, doc, out, win_out, win_body, card)


# the meshes the autotune phase screens (data, model)
TUNE_MESHES = ((1, 1), (1, 2), (1, 4), (2, 1))


def _tuned_meshes(torch, cfg, doc: dict, path: str, win_out: list, win_body: dict,
                  card: str) -> None:
    """(f) The tuner's mesh terms at full width: the CLI's search (anneal,
    64 trials, seed 0) over each of TUNE_MESHES alone and over all of them,
    its sparsity ceiling the one (a)'s oracle ruled (perf model only, H100
    data-sheet constants), each predicted winner logged; then (b)'s
    one-card artifact served by ``serve --autotune-plan PATH --mesh 1x2
    --share-card`` ranks, its streams held to (b)'s by the near-tie rule and
    the kernels (b) launched (``win_body``) launched on every rank."""
    from repro_torch.core import autotune as AT
    from repro_torch.core.perf_model import HARDWARE_LABEL

    ceiling = float(doc["accuracy"]["max_q"])

    def oracle(q):
        return q <= ceiling + 1e-12

    t0 = time.perf_counter()
    for meshes in [(m,) for m in TUNE_MESHES] + [TUNE_MESHES]:
        res = AT.search(cfg, space=AT.SearchSpace(meshes=meshes), strategy="anneal",
                        trials=64, seed=0, accuracy=oracle)
        p, b = res.prediction, res.best
        log(f"autotune meshes {list(meshes)}: predicted winner on mesh {b.mesh}: "
            f"{p.tokens_per_s:.1f} tok/s at batch {p.batch} (n_opt {p.n_opt:.1f}, balance "
            f"{p.balance:.4f}), kv {b.kv_dtype}, page {b.page_size}, max q "
            f"{p.stats.max_q:.2f}; uniform {res.uniform.tokens_per_s:.1f} ({HARDWARE_LABEL})")
        if len(meshes) > 1 and tuple(b.mesh) not in TUNE_MESHES:
            raise AssertionError(f"autotune meshes: a winner off the space: {b.mesh}")
    log(f"autotune meshes: screened in {time.perf_counter() - t0:.1f}s (sparsity ceiling "
        f"{ceiling:.2f} from (a)'s oracle)")
    kernels = sorted({k.split()[0] for k, n in win_body.items() if n})
    attention = ("paged_decode_attention",) if doc["serving"]["page_size"] else ()
    job = {"want": {"tuned": win_out}, "tuned": path, "long_prompts": [], "cuts": TAIL_CUTS}
    rows = _mesh_run(torch, "1x2", ("tuned",), job)[0]
    _check_mesh_case("1x2", "tuned", rows, card, kernels=kernels, attention=attention)


def _train_args(*flags, arch: str = "tinyllama-1.1b"):
    """The train CLI's args for full-width ``arch`` with ``flags``, at lr
    3e-4: the CLI's default 3e-3 (the reference's, sized for the smoke
    configs) makes the 1.1B model's loss rise, 10.87 to 11.34 over 8 steps
    at B 8 x 128 on the card."""
    from repro_torch.launch import train

    return train.build_parser().parse_args(["--arch", arch, "--log-every", "1",
                                            "--lr", "3e-4", *flags])


def _train_run(torch, label: str, card: str, *flags, arch: str = "tinyllama-1.1b",
               cfg=None) -> dict:
    """``launch.train.run`` on the card (``cfg`` in place of the arch's
    config where given) from reset peak-memory stats: logs
    every loss, the median step after step 1 (host clock; each step ends in
    the loss's read), tok/s and the peak memory; fails on a loss that is not
    finite, a missing step or a restart.  Returns the run's losses, its
    median step ms and its peak memory above what was held before it."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    args = _train_args(*flags, arch=arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = train.run(args, cfg=cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(out["step_s"][1:]) * 1e3
    log(f"train {label}: losses {out['losses']}; grad norms {out['grad_norms']}; "
        f"median step {med:.3f} ms after step 1 "
        f"(step 1 {out['step_s'][0] * 1e3:.1f} ms), {args.batch * args.seq / med * 1e3:.1f} tok/s; "
        f"max_memory_allocated {peak / 1e9:.3f} GB ({(peak - held) / 1e9:.3f} GB above the "
        f"{held / 1e9:.3f} GB held before); restarts {out['restarts']} ({card})")
    if len(out["losses"]) != args.steps or not all(map(math.isfinite, out["losses"])):
        raise AssertionError(f"train {label}: losses {out['losses']}")
    if out["restarts"]:
        raise AssertionError(f"train {label}: {out['restarts']} restarts where none was injected")
    return {"losses": out["losses"], "grad_norms": out["grad_norms"], "med_ms": med,
            "peak": peak - held, "layers": get_config(args.arch, smoke=args.smoke).n_layers}


def _train_profile(torch, card: str, batch: int, seq: int) -> None:
    """Where a full-width train step's time goes, after two warm-up steps:
    the forward + backward and ``apply_updates`` on the host's clock (each
    ended by a synchronize), then one whole step under torch.profiler --
    the device's busy time against the step's wall time, and its largest
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.weight_plan import flatten_leaves, unflatten_leaves
    from repro_torch.data import LMDataConfig, synthetic_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.trainer import make_train_step

    cfg = get_config("tinyllama-1.1b")
    params = T.init_params(cfg, 0)
    oc = O.OptimizerConfig(lr=3e-4, warmup_steps=2, decay_steps=100)
    opt = O.init_opt_state(oc, params)
    step = make_train_step(cfg, T.loss_fn, oc)
    dc = LMDataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    data = lambda s: {k: torch.from_numpy(v).cuda() for k, v in synthetic_lm_batch(dc, s).items()}
    for s in range(2):
        params, opt, m = step(params, opt, data(s))
        float(m["loss"])
    b = data(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = T.loss_fn(cfg, params, b)
    grads = torch.autograd.grad(loss, flatten_leaves(params))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    O.apply_updates(oc, params, unflatten_leaves(params, list(grads)), opt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del loss, grads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        params, opt, m = step(params, opt, data(3))
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t3) * 1e3
    rows = _device_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    log(f"train profile B {batch} x {seq}: forward + backward {(t1 - t0) * 1e3:.3f} ms, "
        f"apply_updates {(t2 - t1) * 1e3:.3f} ms (host clock); a profiled step: wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.3f}) in "
        f"{sum(r[1] for r in rows)} kernels ({card})")
    for t, c, name in rows[:8]:
        log(f"train profile:   {t:9.3f} ms  {c:5d} calls  {name[:90]}")


def _train_parity(torch) -> None:
    """A 2-layer tinyllama at full width in fp32 compute: the loss and every
    gradient leaf of one synthetic batch (B 2 x 64) on the card against the
    port's CPU run of the same step (loss to 1e-4 relative, each leaf to
    1e-3 of its max |g|); then ``apply_updates`` on the CPU's gradients on
    both devices, the params equal to 1e-6."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.core.weight_plan import flatten_leaves, unflatten_leaves
    from repro_torch.data import LMDataConfig, synthetic_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O

    cfg = dc.replace(get_config("tinyllama-1.1b"), n_layers=2, compute_dtype="float32")
    cpu = T.init_params(cfg, 0, device="cpu")
    gpu = unflatten_leaves(cpu, [t.cuda() for t in flatten_leaves(cpu)])
    batch = synthetic_lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2), 0)

    def grads(params, dev):
        leaves = flatten_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = T.loss_fn(cfg, params, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    l_cpu, g_cpu = grads(cpu, "cpu")
    l_gpu, g_gpu = grads(gpu, "cuda")
    worst = max(float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(g_gpu, g_cpu))
    log(f"train parity (2 layers, full width, fp32): loss card {l_gpu:.6f} cpu {l_cpu:.6f} "
        f"(rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}); worst gradient leaf "
        f"{worst:.2e} of its max |g| over {len(g_cpu)} leaves")
    if abs(l_gpu - l_cpu) > 1e-4 * abs(l_cpu) or worst > 1e-3:
        raise AssertionError("train parity: the card's step differs from the CPU's")
    oc = O.OptimizerConfig(lr=1e-3)
    O.apply_updates(oc, cpu, unflatten_leaves(cpu, list(g_cpu)), O.init_opt_state(oc, cpu))
    O.apply_updates(oc, gpu, unflatten_leaves(gpu, [g.cuda() for g in g_cpu]),
                    O.init_opt_state(oc, gpu))
    diff = max(float((a.detach().cpu() - b.detach()).abs().max())
               for a, b in zip(flatten_leaves(gpu), flatten_leaves(cpu)))
    log(f"train parity: apply_updates on identical gradients, max |params card - cpu| {diff:.2e}")
    if diff > 1e-6:
        raise AssertionError(f"train parity: apply_updates differs by {diff:.2e}")


def _flash_grad_parity(torch) -> None:
    """dq, dk, dv of the flash ``Function`` (``layers.train_attention`` past
    the dense threshold) against ``dense_attention`` under autograd at B 1,
    S 2048, 32/4 heads, hd 64, fp32, causal and under a 256-token window;
    to 1e-4 of each gradient's max."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = ((1, 2048, 32, 64), (1, 2048, 4, 64), (1, 2048, 4, 64), (1, 2048, 32, 64))
    for window in (None, 256):
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda") for s in shapes)
        f0 = L.FlashAttention.forward_calls
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(L.train_attention(*xs, causal=True, window=window), xs, do)
        if L.FlashAttention.forward_calls != f0 + 1:
            raise AssertionError("train_attention at 2048 tokens did not take FlashAttention")
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(L.dense_attention(*xs, causal=True, window=window), xs, do)
        rels = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        log(f"train flash backward vs dense autograd (S 2048, 32/4, hd 64, window {window}): "
            f"dq/dk/dv rel {rels[0]:.2e} / {rels[1]:.2e} / {rels[2]:.2e}")
        if max(rels) > 1e-4:
            raise AssertionError(f"flash backward differs from dense autograd: {rels}")


def _train_resume(torch) -> None:
    """A smoke config on the card: 6 steps, then the same 6 steps with
    checkpoints every 3 steps and a RuntimeError injected before step 4's
    batch: one restart, resumed at step 4, and the uninterrupted run's
    losses to 1e-5 relative (the embedding's backward accumulates with
    atomics on the card, so the runs are not held bit for bit)."""
    import tempfile

    from repro_torch.launch import train

    flags = ["--smoke", "--steps", "6", "--batch", "4", "--seq", "32"]
    full = train.run(_train_args(*flags))
    real, failed = train.synthetic_lm_batch, []

    def flaky(cfg, step):
        if step == 4 and not failed:
            failed.append(step)
            raise RuntimeError("injected fault before step 4")
        return real(cfg, step)

    with tempfile.TemporaryDirectory() as d:
        train.synthetic_lm_batch = flaky
        try:
            out = train.run(_train_args(*flags, "--ckpt-dir", d, "--ckpt-every", "3"))
        finally:
            train.synthetic_lm_batch = real
    worst = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], full["losses"]))
    log(f"train resume: {out['restarts']} restart, losses {out['losses']} vs uninterrupted "
        f"{full['losses']} (worst rel {worst:.2e})")
    if failed != [4] or out["restarts"] != 1 or len(out["losses"]) != 6 or worst > 1e-5:
        raise AssertionError("train resume: the restarted run differs from the uninterrupted one")


# the other families' full-width runs: (arch, batch, text tokens a row)
TRAIN_FAMILIES = (("granite-moe-1b-a400m", 8, 128), ("recurrentgemma-2b", 4, 128),
                  ("xlstm-350m", 8, 128), ("whisper-tiny", 8, 128), ("internvl2-2b", 4, 128))
# 2 (3 before the train_mesh_families phase, cut for the script's time):
# that phase holds its 2-step meshed runs to these
TRAIN_FAMILY_STEPS = 2
# card-vs-CPU parity: the fewest layers that hold every kind of the arch
TRAIN_PARITY = (("granite-moe-1b-a400m", dict(n_layers=2)),
                ("recurrentgemma-2b", dict(n_layers=3, pattern=("rec", "rec", "local"))),
                ("xlstm-350m", dict(n_layers=2, pattern=("mlstm", "slstm"))),
                ("whisper-tiny", dict(n_layers=1, enc_layers=1)),
                ("internvl2-2b", dict(n_layers=2)))


@contextlib.contextmanager
def _routes():
    """Records every ``moe.route`` call's Routing while in use."""
    from repro_torch.models import moe as MOE

    calls, real = [], MOE.route

    def spy(cfg, xg, router, **kw):
        r = real(cfg, xg, router, **kw)
        calls.append(dataclasses.replace(r, probs=r.probs.detach(), gates=r.gates.detach()))
        return r

    MOE.route = spy
    try:
        yield calls
    finally:
        MOE.route = real


def _routing_flips(torch, label: str, cpu: list, gpu: list) -> int:
    """Compares the card's routing with the CPU's call by call: logs every
    token whose experts differ, with the CPU's gap between its k-th and
    (k+1)-th router probability (a near-tie if tiny).  Returns the count."""
    flips = 0
    for layer, (rc, rg) in enumerate(zip(cpu, gpu)):
        differ = (rc.idx != rg.idx.cpu()).any(-1)  # (nG, G)
        K = rc.idx.shape[-1]
        for g, t in differ.nonzero().tolist():
            p = torch.sort(rc.probs[g, t], descending=True).values
            log(f"train parity {label}: routing flip at call {layer} token {g * rc.idx.shape[1] + t}: "
                f"cpu {rc.idx[g, t].tolist()} card {rg.idx[g, t].tolist()}, top-{K} gap "
                f"{float(p[K - 1] - p[K]):.3e}")
            flips += 1
    dropped = [int((~r.keep).sum()) for r in gpu]
    log(f"train parity {label}: {len(gpu)} routing calls, {flips} tokens routed differently; "
        f"dropped assignments on the card {dropped}")
    return flips


def _family_parity(torch, arch: str, changes: dict) -> None:
    """``arch`` at full width in fp32 compute with ``changes`` (the fewest
    layers that hold its kinds): the loss and every gradient leaf of one
    synthetic batch (B 2 x 64, with the launcher's ``extras``) on the card
    against the port's CPU run (loss to 1e-4 relative, each leaf to 1e-3 of
    its max |g|); for a MoE config the routing of both runs compared
    (``_routing_flips``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.weight_plan import flatten_leaves, unflatten_leaves
    from repro_torch.data import LMDataConfig, synthetic_lm_batch
    from repro_torch.launch.train import extras
    from repro_torch.models.api import get_api

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32", **changes)
    api = get_api(cfg)
    cpu = api.init_params(cfg, 0, device="cpu")
    gpu = unflatten_leaves(cpu, [t.cuda() for t in flatten_leaves(cpu)])
    batch = synthetic_lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2), 0)
    batch.update(extras(cfg, api, 2, 0))

    def grads(params, dev):
        leaves = flatten_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        with _routes() as routes:
            loss, _ = api.loss_fn(cfg, params,
                                  {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            g = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), g, routes

    l_cpu, g_cpu, r_cpu = grads(cpu, "cpu")
    l_gpu, g_gpu, r_gpu = grads(gpu, "cuda")
    flips = _routing_flips(torch, arch, r_cpu, r_gpu) if cfg.moe is not None else 0
    worst = max(float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(g_gpu, g_cpu))
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"train parity {arch} ({changes}, full width, fp32, B 2 x 64, extras "
        f"{ {k: v.shape for k, v in batch.items() if k not in ('tokens', 'labels')} }): loss card "
        f"{l_gpu:.6f} cpu {l_cpu:.6f} (rel {rel:.2e}); worst gradient leaf {worst:.2e} of its "
        f"max |g| over {len(g_cpu)} leaves; {time.perf_counter() - t0:.1f}s")
    if rel > 1e-4 or worst > 1e-3:
        raise AssertionError(f"train parity {arch}: the card's step differs from the CPU's "
                             f"({flips} routing flips)")


def _slstm_share(torch, card: str) -> None:
    """xlstm-350m at full width, B 8 x 128: after two warm-up steps, one
    train step whose 12 sLSTM cells are timed on the host's clock, each
    forward between two synchronizes and each backward from the gradient
    of its output to that of its input (tensor hooks that synchronize);
    logs their share of that step's wall time."""
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, synthetic_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.trainer import make_train_step

    cfg = get_config("xlstm-350m")
    params = T.init_params(cfg, 0)
    oc = O.OptimizerConfig(lr=3e-4, warmup_steps=2, decay_steps=100)
    opt = O.init_opt_state(oc, params)
    step = make_train_step(cfg, T.loss_fn, oc)
    dc = LMDataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8)
    data = lambda s: {k: torch.from_numpy(v).cuda() for k, v in synthetic_lm_batch(dc, s).items()}
    for s in range(2):
        params, opt, m = step(params, opt, data(s))
        float(m["loss"])
    real, spent, n = T._CELLS["slstm"], {"fwd": 0.0, "bwd": 0.0}, [0]

    def timed(cfg, p, x, state=None, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, new = real(cfg, p, x, state, **kw)
        torch.cuda.synchronize()
        spent["fwd"] += time.perf_counter() - t0
        n[0] += 1
        mark = {}

        def start(g):
            torch.cuda.synchronize()
            mark["t"] = time.perf_counter()

        def end(g):
            torch.cuda.synchronize()
            spent["bwd"] += time.perf_counter() - mark["t"]

        y.register_hook(start)
        x.register_hook(end)
        return y, new

    T._CELLS["slstm"] = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, data(2))
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        T._CELLS["slstm"] = real
    share = (spent["fwd"] + spent["bwd"]) / wall
    log(f"train xlstm-350m B 8 x 128: {n[0]} sLSTM cells took {spent['fwd'] * 1e3:.3f} ms forward"
        f" + {spent['bwd'] * 1e3:.3f} ms backward of a {wall * 1e3:.3f} ms step ({share:.3f}; "
        f"host clock, synchronized around each cell) ({card})")
    if n[0] != cfg.layer_kinds.count("slstm"):
        raise AssertionError(f"train xlstm: {n[0]} sLSTM cells timed")


def _train_families(torch, card: str) -> tuple:
    """Every card-vs-CPU parity of ``TRAIN_PARITY``, then the other
    families at full width through ``launch.train.run``
    (``TRAIN_FAMILIES``, lr 3e-4, ``TRAIN_FAMILY_STEPS`` steps each):
    granite-moe's dropped share of its routed assignments (1024 tokens:
    two dispatch groups of 512, capacity on), xlstm's sLSTM share
    (``_slstm_share``), and the ``FlashAttention`` calls: whisper's encoder
    self-attention and cross-attention over 1500 frames, one forward and
    one backward a layer a step; none for the others.  Returns each run's
    summary for the log's table and, by arch, its losses, grad norms and
    gradient leaf norms every step (a MoE's routing calls too, on the
    host): the train_mesh_families phase's one-card runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    for arch, changes in TRAIN_PARITY:
        _family_parity(torch, arch, changes)
    rows, runs = [], {}
    for arch, batch, seq in TRAIN_FAMILIES:
        cfg = get_config(arch)
        L.FlashAttention.forward_calls = L.FlashAttention.backward_calls = 0
        with _routes() as routes, _spy_updates(torch, {}) as seen:
            run = _train_run(torch, f"{arch} B {batch} x {seq}", card, "--steps",
                             str(TRAIN_FAMILY_STEPS), "--batch", str(batch), "--seq", str(seq),
                             arch=arch)
        runs[arch] = dict(run, leaf_norms=seen["leaf_norms"],
                          routes=[(r.idx.cpu(), r.keep.cpu()) for r in routes])
        calls = (L.FlashAttention.forward_calls, L.FlashAttention.backward_calls)
        want = (TRAIN_FAMILY_STEPS * (cfg.enc_layers + cfg.n_layers),) * 2 \
            if cfg.family == "audio" else (0, 0)
        log(f"train {arch}: FlashAttention forward/backward calls {calls} ({want} expected)")
        if calls != want:
            raise AssertionError(f"train {arch}: flash Function calls {calls} != {want}")
        if cfg.moe is not None:
            per_step = len(routes) // TRAIN_FAMILY_STEPS
            drop = [int((~r.keep).sum()) for r in routes]
            total = sum(r.keep.numel() for r in routes)
            log(f"train {arch}: {len(routes)} routing calls ({per_step} a step), capacity "
                f"{routes[0].capacity} slots an expert a group of {routes[0].idx.shape[1]} tokens; "
                f"dropped {sum(drop)} of {total} assignments ({sum(drop) / total:.4f}); per "
                f"step {[sum(drop[i * per_step:(i + 1) * per_step]) for i in range(TRAIN_FAMILY_STEPS)]}")
            if per_step != cfg.n_layers or routes[0].idx.shape[:2] != (2, 512):
                raise AssertionError(f"train {arch}: routing calls {len(routes)}, groups "
                                     f"{tuple(routes[0].idx.shape)}")
        if arch == "xlstm-350m":
            _slstm_share(torch, card)
        pos = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
        rows.append(f"{arch} B {batch} x {seq} ({pos} positions a row): {run['med_ms']:.3f} ms, "
                    f"{batch * seq / run['med_ms'] * 1e3:.1f} tok/s, peak {run['peak'] / 1e9:.3f} GB")
        torch.cuda.empty_cache()
    return rows, runs


def _fcnet_train(torch, card: str) -> None:
    """Table 4's flow (``benchmarks/table4_accuracy.py``'s default cases) on
    the card: mnist-4 and har-4 at published widths on their synthetic
    tasks, 400 base steps, ``iterative_prune`` toward the paper's q in 4
    stages of 200 refine steps, batch 128, evaluated through B7; then the
    pruned net's test accuracy through B7 (``forward_fp32`` on the masked
    params) against ``forward_pruned``'s plain version (every argmax that
    differs must be a near-tie of the plain outputs), and through B8
    (``forward_q78``)."""
    from repro_torch.core import pruning as PR
    from repro_torch.data import ClassifyDataConfig, minibatches, synthetic_classification
    from repro_torch.models import fcnet as F
    from repro_torch.training import optimizer as O
    from repro_torch.training.trainer import make_train_step

    base_steps, refine = 400, 200
    for cfg, dims, q_target in ((F.MNIST_4, (784, 10), 0.72), (F.HAR_4, (561, 6), 0.88)):
        t0 = time.perf_counter()
        data = synthetic_classification(ClassifyDataConfig(
            n_features=dims[0], n_classes=dims[1], n_train=4096, n_test=1024, seed=0))
        xte, yte = (torch.from_numpy(data[k]).cuda() for k in ("x_test", "y_test"))
        params = F.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        opt_cfg = O.OptimizerConfig(lr=2e-3, warmup_steps=20,
                                    decay_steps=base_steps + 4 * refine, weight_decay=0.0)

        def train_some(params, masks, steps):
            opt = O.init_opt_state(opt_cfg, params)
            batches = minibatches(data["x_train"], data["y_train"], 128, seed=1)
            step = make_train_step(cfg, lambda c, p, b: F.loss_fn(c, p, b, masks), opt_cfg)
            for _ in range(steps):
                b = {k: torch.from_numpy(v).cuda() for k, v in next(batches).items()}
                params, opt, _ = step(params, opt, b)
                if masks is not None:
                    params = PR.apply_masks(params, masks)
            return params

        evaluate = lambda p: F.accuracy(cfg, p, xte, yte)
        params = train_some(params, None, base_steps)
        base = evaluate(params)
        params, masks, q, hist = PR.iterative_prune(params, train_some, evaluate, q_target,
                                                    stages=4, refine_steps=refine)
        masked = PR.apply_masks(params, masks)
        with torch.no_grad():
            kern = F.forward_fp32(cfg, masked, xte)
            plain = F.forward_pruned(cfg, params, masks, xte, use_kernel=False)
            q78 = F.forward_q78(cfg, masked, xte)
        acc = {k: float((o.argmax(-1) == yte).float().mean())
               for k, o in (("b7", kern), ("plain", plain), ("q78", q78))}
        rows = (kern.argmax(-1) != plain.argmax(-1)).nonzero().flatten().tolist()
        top2 = plain.topk(2, dim=-1).values
        gaps = [float(top2[r, 0] - top2[r, 1]) for r in rows]
        tie = FP32_RTOL * float(plain.abs().max())
        log(f"train fcnet {cfg.name}: base acc {base:.4f}, pruned acc {acc['b7']:.4f} at q "
            f"{q:.2f} (target {q_target}; history {[(round(h['q'], 2), h['acc']) for h in hist]}); "
            f"1.5% objective met: {base - acc['b7'] <= 0.015}; plain forward_pruned acc "
            f"{acc['plain']:.4f} ({len(rows)} argmax differ, top-2 gaps {gaps}, tie bound "
            f"{tie:.2e}); Q7.8 (B8) acc {acc['q78']:.4f}; {time.perf_counter() - t0:.1f}s ({card})")
        if any(g > tie for g in gaps):
            raise AssertionError(f"fcnet {cfg.name}: B7's pruned accuracy differs from plain")


def phase_train(torch, card: str) -> dict:
    """Training on the card (see the module doc): the parity checks, the
    full-width runs through ``launch.train.run``, the resume, the FC nets.
    Returns the B 8 x 128 run (``_train_run``'s, with each step's gradient
    leaf norms), the train_mesh phase's one-card run, and the other
    families' runs by arch (``_train_families``), the train_mesh_families
    phase's."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    _train_parity(torch)
    _flash_grad_parity(torch)
    b6 = FA.flash_attention.launches
    L.FlashAttention.forward_calls = L.FlashAttention.backward_calls = 0
    # also the train_mesh phase's one-card run: every gradient leaf's norm
    with _spy_updates(torch, {}) as seen:
        dense = _train_run(torch, "B 8 x 128", card, "--steps", str(TRAIN_MESH_STEPS + 1),
                           *TRAIN_MESH_FLAGS)
    dense["leaf_norms"] = seen["leaf_norms"]
    calls = (L.FlashAttention.forward_calls, L.FlashAttention.backward_calls)
    if calls != (0, 0):
        raise AssertionError(f"train B 8 x 128 ran the flash Function: {calls}")
    long = _train_run(torch, "B 1 x 2048", card, "--steps", "3", "--batch", "1", "--seq", "2048")
    calls = (L.FlashAttention.forward_calls, L.FlashAttention.backward_calls)
    want = (3 * long["layers"],) * 2  # one forward and one backward a layer a step
    log(f"train B 1 x 2048: FlashAttention forward/backward calls {calls} over 3 steps "
        f"({want} expected)")
    if calls != want:
        raise AssertionError(f"train B 1 x 2048: flash Function calls {calls} != {want}")
    accum = _train_run(torch, "B 8 x 128 --accum 2", card, "--steps", "3", "--batch", "8",
                       "--seq", "128", "--accum", "2")
    int8 = _train_run(torch, "B 8 x 128 --compression int8", card, "--steps", "3", "--batch",
                      "8", "--seq", "128", "--compression", "int8")
    # step 0's loss is the same forward on the same params and batch in
    # every run (1e-6 for int8, which changes only the update; two
    # microbatches of 4 rows for --accum 2: other matmul shapes, bf16
    # roundings, held to 5e-3)
    d_acc = abs(accum["losses"][0] - dense["losses"][0]) / dense["losses"][0]
    log(f"train step 0 loss: dense {dense['losses'][0]:.6f}, accum 2 {accum['losses'][0]:.6f} "
        f"(rel {d_acc:.2e}), int8 {int8['losses'][0]:.6f}")
    d_int8 = abs(int8["losses"][0] - dense["losses"][0]) / dense["losses"][0]
    if d_acc > 5e-3 or d_int8 > 1e-6:
        raise AssertionError("train: step 0's loss differs between runs of the same forward")
    # remat where activations outweigh the optimizer's temporaries: B 8 x
    # 512 (dense attention); losses to 1e-4 relative (atomics in the
    # embedding's backward), the peak lower
    flags = ("--steps", "3", "--batch", "8", "--seq", "512")
    plain = _train_run(torch, "B 8 x 512", card, *flags)
    remat = _train_run(torch, "B 8 x 512 --remat", card, *flags, "--remat")
    worst = max(abs(a - b) / abs(b) for a, b in zip(remat["losses"], plain["losses"]))
    log(f"train remat: losses worst rel {worst:.2e}; peak {remat['peak'] / 1e9:.3f} GB vs "
        f"{plain['peak'] / 1e9:.3f} GB without")
    if worst > 1e-4 or remat["peak"] >= plain["peak"]:
        raise AssertionError("train remat: losses differ or the peak is not lower")
    _train_profile(torch, card, 8, 128)
    _train_profile(torch, card, 1, 2048)
    rows, families = _train_families(torch, card)
    for row in rows:
        log(f"train families: {row} ({card})")
    if FA.flash_attention.launches != b6:
        raise AssertionError(f"B6 launched in training: {FA.flash_attention.launches - b6}")
    _train_resume(torch)
    _fcnet_train(torch, card)
    log(f"train: phase {time.perf_counter() - t0:.1f}s")
    return dense, families


def phase_analysis(torch, card: str) -> None:
    """The dry run (``launch/dryrun.py``) against the card: rank 0 of a 1 x 1
    mesh of full-width tinyllama-1.1b's training step at the train phase's
    B 8 x 128 (no remat), traced on the CPU over meta tensors (a fake
    process group), then the same step once on the card (fp32 params and
    AdamW state, bf16 compute) under ``FlopCounterMode``.  The trace's
    matmul FLOPs must equal the card's count exactly (the training path
    launches no custom kernel: the same aten products run); its arguments +
    temporaries peak is held to the card's ``max_memory_allocated`` of the
    step within ANALYSIS_PEAK_BAND.  Then ``python -m
    repro_torch.launch.dryrun --arch whisper-tiny --shape decode_32k`` as a
    subprocess (the 16 x 16 mesh, full width) must exit 0 and write its
    record, which is read back."""
    import subprocess as sp
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.api import get_api
    from repro_torch.training import optimizer as O
    from repro_torch.training.trainer import make_train_step

    arch, B, S = "tinyllama-1.1b", 8, 128
    cfg, shape = get_config(arch), ShapeSpec("train_8x128", S, B, "train")
    t0 = time.perf_counter()
    rec = D.analyze_cell(D.lower_cell(arch, shape, mesh=(1, 1), remat=False), cfg, shape)
    trace_s = time.perf_counter() - t0
    mem = rec["memory"]
    traced_peak = mem["argument_bytes"] + mem["temp_bytes"]

    api = get_api(cfg)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = api.init_params(cfg, 0)
    opt_cfg = O.OptimizerConfig()
    opt = O.init_opt_state(opt_cfg, params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tok = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda", dtype=torch.int32)
    step = make_train_step(cfg, api.loss_fn, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        params, opt, metrics = step(params, opt, {"tokens": tok, "labels": tok})
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    card_peak = torch.cuda.max_memory_allocated() - base
    card_flops = counter.get_total_flops()
    ratio = traced_peak / card_peak
    log(f"analysis: {arch} train B {B} x {S} on a 1x1 mesh traced in {trace_s:.1f}s: matmul "
        f"FLOPs {rec['dot_flops_per_device']:.6e} (all ops {rec['hlo_flops_per_device']:.6e}), "
        f"bytes {rec['hlo_bytes_per_device']:.4e}, arguments {mem['argument_bytes'] / 1e9:.3f} "
        f"GB + temporaries {mem['temp_bytes'] / 1e9:.3f} GB = {traced_peak / 1e9:.3f} GB")
    log(f"analysis: the same step on the card ({step_s:.2f}s, loss "
        f"{float(metrics['loss']):.4f}): FlopCounterMode {card_flops:.6e} FLOPs, "
        f"max_memory_allocated {card_peak / 1e9:.3f} GB; traced / card peak {ratio:.4f} "
        f"(band {ANALYSIS_PEAK_BAND}) on {card}")
    if rec["dot_flops_per_device"] != card_flops:
        raise AssertionError(f"analysis: traced matmul FLOPs {rec['dot_flops_per_device']} != the "
                             f"card's {card_flops}")
    if not ANALYSIS_PEAK_BAND[0] <= ratio <= ANALYSIS_PEAK_BAND[1]:
        raise AssertionError(f"analysis: traced peak {traced_peak} is {ratio:.4f} of the card's "
                             f"{card_peak}, outside {ANALYSIS_PEAK_BAND}")
    del params, opt, metrics, step
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        t2 = time.perf_counter()
        r = sp.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
                    "--shape", "decode_32k", "--out", out], env=env, capture_output=True,
                   text=True, timeout=300)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[dryrun]")]
        log(f"analysis: dryrun subprocess exit {r.returncode} in {time.perf_counter() - t2:.1f}s: "
            + " | ".join(lines))
        if r.returncode != 0:
            raise AssertionError(f"analysis: the dry run failed:\n{r.stdout}\n{r.stderr[-4000:]}")
        with open(os.path.join(out, "whisper-tiny_decode_32k_16-16.json")) as f:
            w = json.load(f)
    log(f"analysis: whisper-tiny decode_32k on 16x16: flops/dev {w['hlo_flops_per_device']:.4e}, "
        f"bytes/dev {w['hlo_bytes_per_device']:.4e}, collectives "
        f"{w['collectives']['total_bytes']:.4e} B, {w['dominant']}-bound, roofline "
        f"{w['t_roofline_s'] * 1e3:.3f} ms, peak {w['peak_bytes_per_device'] / 1e9:.3f} GB, "
        f"fits {w['fits']}")
    if not (w["fits"] and w["hlo_flops_per_device"] > 0 and w["collectives"]["total_bytes"] > 0):
        raise AssertionError(f"analysis: implausible dry-run record {w}")


TRAIN_MESHES = ((1, 2), (2, 2))
TRAIN_MESH_FLAGS = ("--batch", "8", "--seq", "128")
TRAIN_MESH_STEPS = 3
# the 1x2 spawn's production layouts: the train_mesh flags' steps under
# sequence parallelism (seq_sp), and teacher-forced decode steps over a
# contiguous cache of LAYOUT_LEN positions cut along its sequence over
# "model" (cache_seq, decode_32k's rule), after a LAYOUT_PROMPT-token prefill
TRAIN_MESH_SP_STEPS = 2
LAYOUT_BATCH, LAYOUT_LEN, LAYOUT_PROMPT, LAYOUT_STEPS = 8, 4096, 3000, 8
# the sequence-cut decode against tensor parallelism on the same mesh, which
# differ only by the cut: within this of the largest logit (a bf16 logit's
# rounding step near the largest is 0.4-0.8% of it; the card read 1.333e-2
# in bf16, 1.25e-2 in int8, 0 in e4m3), while a planted fault (the ranks'
# partial outputs not summed) must read above it (the card read 0.95-1.07)
LAYOUT_SEQ_RTOL = 3e-2
# the meshed steps against the one-card run (bf16 compute)
TRAIN_MESH_LOSS_RTOL = 5e-4
TRAIN_MESH_NORM_RTOL = 5e-3
TRAIN_MESH_LEAF_RTOL = 2e-2  # each gradient leaf's norm, every step
# a rank's params + grads + moments over the whole state's (4 x the
# params): 1x2 halves all of them; 2x2 halves params and grads and
# quarters the moments (d_model also over data)
TRAIN_MESH_SHARE = {(1, 2): 0.5, (2, 2): 0.375}


def _tree_bytes(tree) -> int:
    from repro_torch.core.weight_plan import flatten_leaves

    return sum(t.numel() * t.element_size() for t in flatten_leaves(tree))


def _grad_leaf_norms(torch, grads, place=None) -> list:
    """Each gradient leaf's whole norm (fp32): on a mesh its pieces'
    squares summed over the axes that split the leaf."""
    from repro_torch.core.weight_plan import flatten_leaves
    from repro_torch.distributed import shardlib as sl

    out = []
    for i, g in enumerate(flatten_leaves(grads)):
        sq = torch.sum(torch.square(g.float()))
        if place is not None:
            sq = sl.reduce_over(sq, place.split_axes(i), place.mesh)
        out.append(float(torch.sqrt(sq)))
    return out


@contextlib.contextmanager
def _spy_updates(torch, record: dict):
    """While in use, every ``apply_updates`` call records its gradients'
    bytes and leaf norms (``_grad_leaf_norms``) into ``record``."""
    from repro_torch.training import optimizer as O

    real = O.apply_updates

    def spy(cfg_, params, grads, state, place=None):
        record.setdefault("grad_bytes", []).append(_tree_bytes(grads))
        record.setdefault("leaf_norms", []).append(_grad_leaf_norms(torch, grads, place))
        return real(cfg_, params, grads, state, place)

    O.apply_updates = spy
    try:
        yield record
    finally:
        O.apply_updates = real


def _host_rss_gb() -> float:
    """This process's peak resident memory on the host, GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _train_mesh_rank(rank: int, job: dict) -> None:
    """A rank of the train_mesh phases: for each of ``job["runs"]`` (an
    arch and the train CLI's flags), ``launch.train.run(args, mesh=)`` on
    the shared card, each update's gradient bytes and leaf norms recorded
    (a MoE's routing calls too, saved to ``job["out"]``); times each
    checkpoint gather (with the host's peak resident memory after it) and
    each restore (with the card's peak over it); writes, run by run, its
    losses, grad norms, step times, peak memory and the bytes of its
    params, gradients and moments beside those its placement's specs give
    (and the whole tree's) to ``job["out"]``."""
    import io

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.launch import mesh as M

    _cut_depths(TAIL_CUTS)  # the configs the train phase ran
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = M.make_serving_mesh(tuple(job["shape"]), "gloo")
    ckpt = {"gather_s": [], "rss_gb": [], "restore_s": [], "restore_peak": []}
    gather, restore = store.gather_state, store.restore

    def timed_gather(*a, **k):
        t0 = time.perf_counter()
        out = gather(*a, **k)
        ckpt["gather_s"].append(time.perf_counter() - t0)
        ckpt["rss_gb"].append(_host_rss_gb())
        return out

    def timed_restore(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = restore(*a, **k)
        torch.cuda.synchronize()
        ckpt["restore_s"].append(time.perf_counter() - t0)
        ckpt["restore_peak"].append(torch.cuda.max_memory_allocated())
        return out

    store.gather_state, store.restore = timed_gather, timed_restore
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext()
    results = []
    for i, run in enumerate(job["runs"]):
        with quiet:
            results.append(_train_mesh_one(torch, rank, mesh, run, ckpt,
                                           os.path.join(job["out"], f"routes{i}_rank{rank}.pt")))
        torch.cuda.empty_cache()
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    if job.get("layouts"):
        t0 = time.perf_counter()
        rows = _layout_decode(torch, mesh)
        with open(os.path.join(job["out"], f"layouts_rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "rows": rows, "seconds": time.perf_counter() - t0}, f)
        torch.cuda.empty_cache()


def _layout_decode(torch, mesh, device: str = "cuda") -> list:
    """A rank's decode over a contiguous cache cut along its sequence
    (``rules_for`` of decode_32k: ``cache_seq`` over "model"): tinyllama-1.1b
    (TAIL_CUTS' 8 layers, bf16 weights from seed 0) prefills LAYOUT_PROMPT
    tokens of LAYOUT_BATCH sequences into LAYOUT_LEN slots and decodes
    LAYOUT_STEPS tokens teacher-forced through ``api.prefill`` /
    ``api.decode_step``, with a bf16, an int8 and an e4m3 cache.  It runs
    three times: unsharded on the rank (no mesh: the one card's), on the
    mesh with the cache cut along its sequence, and on the mesh with
    ``cache_seq`` off (tensor parallelism only, the cache cut on its KV
    heads), so that the last two differ only by the sequence cut.  Then
    one more step on each mesh run, the sequence-cut one with its planted
    fault (``_drop_output_combine``).  Returns, by KV dtype, each call's
    logits error relative to the reference run's largest (``err``: against
    the unsharded run; ``seq_err``: against tensor parallelism), the
    faulted step's ``fault_err``, the rank's slots and cache bytes against
    the whole cache's, and the sequence-cut run's seconds."""
    import numpy as np

    from repro_torch.configs import DECODE_32K, get_config
    from repro_torch.core.weight_plan import local_params, map_tree
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.models import ssm as SSM
    from repro_torch.models.api import get_api

    cfg = get_config("tinyllama-1.1b")
    api = get_api(cfg)
    whole = map_tree(lambda _, t: t.to(torch.bfloat16), api.init_params(cfg, 0, device=device))
    rules = M.rules_for(cfg, DECODE_32K, mesh=mesh)
    tp_rules = dict(rules, cache_seq=None)
    params = {"one card": api.unstack(cfg, whole),
              "mesh": api.unstack(cfg, local_params(
                  whole, SSM.placement_axes(api.param_axes(cfg)), mesh, rules))}
    B, P, n = LAYOUT_BATCH, LAYOUT_PROMPT, LAYOUT_STEPS
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, P + n + 1))
    toks = torch.from_numpy(toks.astype(np.int32)).to(device)

    def step(p, cache, i):
        pos = torch.full((B,), P + i, dtype=torch.int32, device=device)
        return api.decode_step(cfg, p, cache, toks[:, P + i:P + i + 1], pos)[0]

    def decode(p, cache):
        out = [api.prefill(cfg, p, {"tokens": toks[:, :P]}, cache)[0]]
        out += [step(p, cache, i) for i in range(n)]
        if device == "cuda":
            torch.cuda.synchronize()
        return torch.cat(out, dim=1).float()

    def rel(got, want):
        return [((got[:, i] - want[:, i]).abs().max() / want[:, i].abs().max()).item()
                for i in range(got.shape[1])]

    rows = []
    for label, kv in (("bf16", None), ("int8", torch.int8), ("e4m3", torch.float8_e4m3fn)):
        want = decode(params["one card"], api.init_cache(cfg, B, LAYOUT_LEN, torch.bfloat16,
                                                         kv_dtype=kv, device=device))
        meta = api.init_cache(cfg, B, LAYOUT_LEN, torch.bfloat16, kv_dtype=kv, device="meta")
        axes = api.cache_axes(cfg, quantized_kv=kv is torch.int8)
        cache = sl.local_zeros(meta, axes, mesh, rules, device)
        tp_cache = sl.local_zeros(meta, axes, mesh, tp_rules, device)
        t0 = time.perf_counter()
        with sl.use_mesh(mesh, rules):
            got = decode(params["mesh"], cache)
        seconds = time.perf_counter() - t0
        with sl.use_mesh(mesh, tp_rules):
            tp = decode(params["mesh"], tp_cache)
        prompt_equal = _prompt_slots_equal(torch, cache, tp_cache, sl.mesh_coords(mesh)["model"],
                                           P)
        with sl.use_mesh(mesh, tp_rules):
            tp_next = step(params["mesh"], tp_cache, n).float()
        with sl.use_mesh(mesh, rules), _drop_output_combine(sl):
            faulted = step(params["mesh"], cache, n).float()
        rows.append({"kv": label, "seconds": seconds, "err": rel(got, want),
                     "seq_err": rel(got, tp), "fault_err": rel(faulted, tp_next)[0],
                     "prompt_slots_equal": prompt_equal,
                     "finite": bool(torch.isfinite(got).all()),
                     "slots": cache["layers"][0]["k"].shape[1],
                     "bytes": _tree_bytes(cache), "whole_bytes": _tree_bytes(meta)})
        del want, got, tp, cache, tp_cache
    return rows


def _prompt_slots_equal(torch, cache: dict, tp_cache: dict, r: int, prompt: int) -> bool:
    """Whether rank ``r``'s slots of the prompt's positions hold the same
    bits in its piece of the sequence-cut cache as in tensor parallelism's
    cache, on the KV heads the rank holds in both, after every step: the
    prefill filled the rank's slots, and no decode write landed on them."""
    def bits(t):
        return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])

    for c, t in zip(cache["layers"], tp_cache["layers"]):
        for name, piece in c.items():
            n, kvh = piece.shape[1], t[name].shape[2]
            end = max(0, min(n, prompt - r * n))
            if not torch.equal(bits(piece[:, :end, r * kvh:(r + 1) * kvh]),
                               bits(t[name][:, r * n:r * n + end])):
                return False
    return True


@contextlib.contextmanager
def _drop_output_combine(sl):
    """The planted fault that ``_check_layouts`` must see: the flash-
    decoding combine's SUM of the ranks' partial outputs skipped, so each
    rank keeps its own slots' share.  That SUM is ``decode_attention``'s
    only 5-dimensional ``all_reduce_axes``."""
    real = sl.all_reduce_axes

    def faulty(x, axes, *op):
        return x if x.dim() == 5 and not op else real(x, axes, *op)

    sl.all_reduce_axes = faulty
    try:
        yield
    finally:
        sl.all_reduce_axes = real


def _train_mesh_one(torch, rank: int, mesh, run: dict, ckpt: dict, routes_path: str) -> dict:
    """One run of ``_train_mesh_rank``: its result (a MoE's routing calls,
    expert choices and kept assignments on the host, to ``routes_path``)."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.distributed import shardlib as sl
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train

    args = _train_args(*run["flags"], arch=run.get("arch", "tinyllama-1.1b"))
    cfg = get_config(args.arch)
    if run.get("fp32"):
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    sp = run.get("sp", False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _spy_updates(torch, {}) as seen, _routes() as routes:
        out = train.run(args, cfg=cfg, mesh=mesh, sequence_parallel=sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if cfg.moe is not None:
        torch.save([(r.idx.cpu(), r.keep.cpu()) for r in routes], routes_path)
    place = M.train_placement(cfg, mesh, sequence_parallel=sp)
    pieces = [math.prod(sl.local_shape(s, p, mesh)) * 4
              for s, p in zip(place.shapes, place.param_specs)]
    moments = [math.prod(sl.local_shape(s, m, mesh)) * 4
               for s, m in zip(place.shapes, place.moment_specs)]
    return {
        "rank": rank, "coords": sl.mesh_coords(mesh), "losses": out["losses"],
        "grad_norms": out["grad_norms"], "step_s": out["step_s"], "wall_s": wall,
        "restarts": out["restarts"], "peak": torch.cuda.max_memory_allocated(),
        "leaf_norms": seen["leaf_norms"], "ckpt": dict(ckpt),
        "bytes": {"params": _tree_bytes(out["params"]), "grads": max(seen["grad_bytes"]),
                  "moments": _tree_bytes(out["opt_state"]["mu"])
                  + _tree_bytes(out["opt_state"]["nu"])},
        "want": {"params": sum(pieces), "grads": sum(pieces), "moments": 2 * sum(moments)},
        "whole_params": sum(math.prod(s) * 4 for s in place.shapes),
        "paths": list(place.paths),
    }


def _train_mesh_spawn(torch, shape: tuple, job: dict, layouts: list | None = None) -> list:
    """``_train_mesh_rank`` on the ranks of ``shape`` sharing the card over
    gloo: for each of ``job["runs"]``, its ranks' results in rank order
    (a MoE run's routing calls by rank under "routes"); with
    ``job["layouts"]`` each rank's ``_layout_decode`` appended to
    ``layouts``."""
    import tempfile

    from repro_torch.launch import mesh as M

    world = shape[0] * shape[1]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        M.spawn_ranks(_train_mesh_rank, (dict(job, shape=list(shape), out=out),), world,
                      M.choose_backend(world, "cuda", share_card=True))
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        runs = [[ranks[r][i] for r in range(world)] for i in range(len(job["runs"]))]
        if job.get("layouts"):
            for r in range(world):
                with open(os.path.join(out, f"layouts_rank{r}.json")) as f:
                    layouts.append(json.load(f))
        for i, rows in enumerate(runs):
            for r, row in enumerate(rows):
                path = os.path.join(out, f"routes{i}_rank{r}.pt")
                if os.path.exists(path):
                    row["routes"] = torch.load(path)
    return runs


def _rel(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _held_to(label: str, rows: list, want: dict, first: int = 0) -> None:
    """Every rank's losses, grad norms and gradient leaf norms the same;
    rank 0's held to ``want``'s steps from ``first`` (the one-card run of
    the same flags)."""
    for row in rows[1:]:
        if any(row[k] != rows[0][k] for k in ("losses", "grad_norms", "leaf_norms")):
            raise AssertionError(f"train_mesh {label}: ranks report different metrics")
    got, norms, leaves = rows[0]["losses"], rows[0]["grad_norms"], rows[0]["leaf_norms"]
    n = len(got)
    ref = want["losses"][first:first + n]
    ref_n = want["grad_norms"][first:first + n]
    ref_l = want["leaf_norms"][first:first + n]
    d_loss, d_norm = _rel(got, ref), _rel(norms, ref_n)
    d_leaf, s, i = max((abs(a - b) / abs(b), s, i) for s, (step, want_step) in
                       enumerate(zip(leaves, ref_l)) for i, (a, b) in enumerate(zip(step, want_step)))
    log(f"train_mesh {label}: losses {got} vs one card {ref} (worst rel {d_loss:.3e}); "
        f"grad norms {norms} vs {ref_n} (worst rel {d_norm:.3e}); the {len(leaves[0])} "
        f"gradient leaves' norms worst rel {d_leaf:.3e} ({rows[0]['paths'][i]} at step {s}: "
        f"{leaves[s][i]:.6e} vs {ref_l[s][i]:.6e})")
    if len(got) != len(ref) or len(leaves) != n or len(leaves[0]) != len(ref_l[0]) \
            or d_loss > TRAIN_MESH_LOSS_RTOL or d_norm > TRAIN_MESH_NORM_RTOL \
            or d_leaf > TRAIN_MESH_LEAF_RTOL:
        raise AssertionError(f"train_mesh {label}: the meshed steps differ from the one-card "
                             f"run's")
    if any(row["restarts"] for row in rows):
        raise AssertionError(f"train_mesh {label}: a rank restarted")


def _check_shares(label: str, rows: list, card: str, fraction=None) -> None:
    """Each rank's param, gradient and moment bytes: its placement's share,
    and (``fraction``) that share the expected fraction of the whole
    state."""
    for row in rows:
        b, w = row["bytes"], row["want"]
        whole = 4 * row["whole_params"]  # params, grads and two moments, whole
        share = sum(b.values()) / whole
        log(f"train_mesh {label} rank {row['rank']} {row['coords']}: params "
            f"{b['params'] / 1e9:.3f} GB, grads {b['grads'] / 1e9:.3f}, moments "
            f"{b['moments'] / 1e9:.3f}: {sum(b.values()) / 1e9:.3f} GB of the whole "
            f"state's {whole / 1e9:.3f} ({share:.5f}); max_memory_allocated "
            f"{row['peak'] / 1e9:.3f} GB ({card})")
        if b != w:
            raise AssertionError(f"train_mesh {label} rank {row['rank']}: bytes {b} are not "
                                 f"its share {w}")
        # the norm vectors stay whole on every rank: a few 1e-5 above
        if fraction is not None and abs(share - fraction) > 1e-3:
            raise AssertionError(f"train_mesh {label} rank {row['rank']}: holds {share:.5f} "
                                 f"of the state, not {fraction}")


def _log_ckpt(label: str, rows: list, card: str) -> None:
    c = rows[0]["ckpt"]
    log(f"train_mesh {label}: rank 0's checkpoint gathers {[round(t, 3) for t in c['gather_s']]}"
        f" s, host peak RSS after them {[round(x, 3) for x in c['rss_gb']]} GB; restores "
        f"{[round(t, 3) for t in c['restore_s']]} s, card peak over them "
        f"{[round(x / 1e9, 3) for x in c['restore_peak']]} GB; the run {rows[0]['wall_s']:.1f} s "
        f"({card})")


def _torchrun_check(torch, card: str) -> None:
    """The train CLI under torchrun on the card at the smoke size: ``python
    -m torch.distributed.run --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --mesh host --share-card``, two ranks sharing
    the card over gloo at 1 x 2; its logged losses (4 decimals) held to a
    one-card run of the same flags."""
    from repro_torch.launch import train

    flags = ("--smoke", "--steps", "2", *TRAIN_MESH_FLAGS)
    ref = train.run(_train_args(*flags))["losses"]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", "--arch", "tinyllama-1.1b", "--mesh", "host",
         "--share-card", "--lr", "3e-4", "--log-every", "1", *flags], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:  # torchrun and its ranks, whatever happened
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, 9)
    if proc.returncode != 0:
        raise AssertionError(f"train_mesh torchrun: exit {proc.returncode}: {stderr[-2000:]}")
    mesh = re.findall(r"\[train\] mesh (.*)", stdout)
    got = [float(x) for x in re.findall(r"\[train\] step \d+ loss ([0-9.]+)", stdout)]
    worst = max(abs(a - b) for a, b in zip(got, ref)) if len(got) == 2 else float("inf")
    log(f"train_mesh torchrun --nproc-per-node 2 --mesh host --share-card (smoke): mesh {mesh}; "
        f"losses {got} vs one card {ref} (worst abs {worst:.2e}), "
        f"{time.perf_counter() - t0:.1f}s with start-up ({card})")
    if mesh[:1] != ["{'data': 1, 'model': 2} over gloo: tensor parallel over model, data "
                    "parallel over data, ZeRO-1 moments"] \
            or worst > 5e-5 + TRAIN_MESH_LOSS_RTOL * max(ref):
        raise AssertionError("train_mesh torchrun: not a 1x2 gloo mesh, or its losses differ")


def _check_sp(label: str, rows: list, want: dict, card: str) -> None:
    """The 1x2 steps under sequence parallelism (``seq_sp``: the residual
    stream cut on its sequence over "model") held to the one-card run with
    the train_mesh limits, each rank's bytes its placement's share."""
    label = f"{label} seq_sp"
    _held_to(label, rows, want)
    _check_shares(label, rows, card, TRAIN_MESH_SHARE[(1, 2)])
    log(f"train_mesh {label}: rank 0's steps {[round(t * 1e3, 3) for t in rows[0]['step_s']]} "
        f"ms (host clock); the run {rows[0]['wall_s']:.1f} s ({card})")


def _check_layouts(label: str, ranks: list, card: str) -> None:
    """Each rank's decode over a cache cut along its sequence
    (``_layout_decode``): every call's logits within PATH_RTOL of the
    unsharded run's and within LAYOUT_SEQ_RTOL of tensor parallelism's on
    the same mesh, finite, the planted fault's step past LAYOUT_SEQ_RTOL,
    the prompt's slots bit-equal to tensor parallelism's, and the rank
    holding half the slots and half the cache's bytes."""
    for rank in ranks:
        for row in rank["rows"]:
            worst, seq = max(row["err"]), max(row["seq_err"])
            log(f"train_mesh {label} cache_seq {row['kv']} rank {rank['rank']}: prefill of "
                f"{LAYOUT_PROMPT} and {LAYOUT_STEPS} teacher-forced steps over {row['slots']} "
                f"of {LAYOUT_LEN} slots, {row['bytes'] / 1e9:.4f} of {row['whole_bytes'] / 1e9:.4f}"
                f" GB of cache; logits within {worst:.3e} of the unsharded run's largest (each "
                f"call {[f'{e:.2e}' for e in row['err']]}), within {seq:.3e} of tensor "
                f"parallelism's (each call {[f'{e:.2e}' for e in row['seq_err']]}; limit "
                f"{LAYOUT_SEQ_RTOL}), the output combine dropped {row['fault_err']:.3e}, the "
                f"prompt's slots the same bits: {row['prompt_slots_equal']}; "
                f"{row['seconds']:.1f} s ({card})")
            if not row["finite"] or worst > PATH_RTOL or not seq <= LAYOUT_SEQ_RTOL \
                    or not row["fault_err"] > LAYOUT_SEQ_RTOL or not row["prompt_slots_equal"] \
                    or row["slots"] * 2 != LAYOUT_LEN or row["bytes"] * 2 != row["whole_bytes"]:
                raise AssertionError(f"train_mesh {label} cache_seq {row['kv']} rank "
                                     f"{rank['rank']}: {row}")
    log(f"train_mesh {label} cache_seq: {max(r['seconds'] for r in ranks):.1f} s a rank")


def phase_train_mesh(torch, card: str, want: dict) -> None:
    """Meshed training (see the module doc).  ``want``: the train phase's
    one-card run of the same flags, ``TRAIN_MESH_STEPS`` + 1 steps."""
    import tempfile

    from repro_torch.distributed.elastic import replan_mesh

    t_phase = time.perf_counter()
    n = TRAIN_MESH_STEPS
    planned = replan_mesh(2, model_parallel=2).shape
    small = (planned["data"], planned["model"])
    with tempfile.TemporaryDirectory() as ckpt:
        for shape in TRAIN_MESHES:
            label = f"{shape[0]}x{shape[1]}"
            flags = ("--steps", str(n), *TRAIN_MESH_FLAGS)
            job = {"runs": [{"flags": flags}]}
            if shape == (2, 2):  # one whole-leaf checkpoint, after the last step
                job["runs"][0]["flags"] += ("--ckpt-dir", ckpt, "--ckpt-every", str(n - 1))
            layouts: list = []
            if shape == (1, 2):  # the production layouts: seq_sp steps, cache_seq decode
                job["runs"].append({"flags": ("--steps", str(TRAIN_MESH_SP_STEPS),
                                              *TRAIN_MESH_FLAGS), "sp": True})
                job["layouts"] = True
            t0 = time.perf_counter()
            rows, *sp = _train_mesh_spawn(torch, shape, job, layouts)
            log(f"train_mesh {label}: {len(rows)} ranks over gloo sharing the card, "
                f"{time.perf_counter() - t0:.1f}s with start-up")
            _held_to(label, rows, want)
            _check_shares(label, rows, card, TRAIN_MESH_SHARE[shape])
            med = statistics.median(rows[0]["step_s"][1:]) * 1e3
            log(f"train_mesh {label}: rank 0's median step {med:.3f} ms after step 1 (step 1 "
                f"{rows[0]['step_s'][0] * 1e3:.1f} ms; host clock, each step ending in the "
                f"loss's read) ({card})")
            if shape == (2, 2):
                _log_ckpt(label, rows, card)
            if sp:
                _check_sp(label, sp[0], want, card)
            if layouts:
                _check_layouts(label, layouts, card)
        # the 2x2 checkpoint resumes on the mesh two ranks re-plan to
        t0 = time.perf_counter()
        [rows] = _train_mesh_spawn(torch, small, {"runs": [{"flags": (
            "--steps", str(n + 1), *TRAIN_MESH_FLAGS, "--ckpt-dir", ckpt)}]})
        label = f"{small[0]}x{small[1]} resumed from the 2x2 step-{n} checkpoint, step {n + 1}"
        log(f"train_mesh {label}: {time.perf_counter() - t0:.1f}s with start-up")
        _held_to(label, rows, want, first=n)
        _log_ckpt(label, rows, card)
    _torchrun_check(torch, card)
    log(f"train_mesh: phase {time.perf_counter() - t_phase:.1f}s")


# the other families on a training mesh: each of TRAIN_FAMILIES at 1x2 (one
# spawn for all five), granite-moe also at 2x2 (data replicas beside expert
# parallelism), each with its TRAIN_FAMILIES batch and sequence
TRAIN_MESH_FAMILY_STEPS = 2
TRAIN_MESH_FAMILY_2X2 = ("granite-moe-1b-a400m",)
# held in fp32 compute, against a one-card fp32 run of its own: the mLSTM's
# b_if gradient is a cancellation (the normalised read-out), whose bf16
# roundoff is ~20% of itself on one card (4 layers; 23% apart between the
# bf16 one-card and 1x2 runs at full depth), where fp32 runs agree to 1e-6
TRAIN_MESH_FP32 = ("xlstm-350m",)


def _replica_routes(rows: list) -> list:
    """The global batch's routing calls of a meshed MoE run: each call's
    (idx, keep) of the data replicas (the ranks of model index 0, in data
    order) concatenated over their dispatch groups."""
    import torch

    parts = sorted((r["coords"]["data"], r["routes"]) for r in rows if r["coords"]["model"] == 0)
    return [(torch.cat([p[1][i][0] for p in parts]), torch.cat([p[1][i][1] for p in parts]))
            for i in range(len(parts[0][1]))]


def _check_drops(torch, label: str, rows: list, want: dict, steps: int, E: int) -> None:
    """A meshed MoE run's dropped assignments step by step against the
    one-card run's: equal where every token chose the same experts; where
    the bf16 router's near-ties flipped a token's choice, each flipped
    assignment may move one drop on each of its two experts, so the counts
    may differ by at most 2 a flip."""
    got, ref = _replica_routes(rows), want["routes"]
    per = len(ref) // TRAIN_FAMILY_STEPS
    if len(got) != per * steps:
        raise AssertionError(f"train_mesh {label}: {len(got)} routing calls, not {per * steps}")
    def chosen(idx):  # (tokens, E): each token's experts
        return torch.nn.functional.one_hot(idx.reshape(-1, idx.shape[-1]), E).sum(-2)

    for s in range(steps):
        calls = range(s * per, (s + 1) * per)
        flips = sum(int((chosen(got[i][0]) - chosen(ref[i][0])).clamp_min(0).sum())
                    for i in calls)
        mesh_drops = sum(int((~got[i][1]).sum()) for i in calls)
        card_drops = sum(int((~ref[i][1]).sum()) for i in calls)
        total = sum(ref[i][1].numel() for i in calls)
        log(f"train_mesh {label}: step {s} dropped {mesh_drops} of {total} assignments "
            f"({mesh_drops / total:.5f}) vs one card {card_drops} ({card_drops / total:.5f}); "
            f"{flips} assignments routed to other experts than on one card")
        if abs(mesh_drops - card_drops) > 2 * flips:
            raise AssertionError(f"train_mesh {label}: step {s} drops {mesh_drops} vs "
                                 f"{card_drops} with {flips} flips")


def phase_train_mesh_families(torch, card: str, want: dict) -> None:
    """The other families on a training mesh (see the module doc): each of
    ``TRAIN_FAMILIES`` at full width through ``launch.train.run(mesh=)`` at
    1x2 and granite-moe also at 2x2, ranks sharing the card over gloo,
    held to the train phase's one-card runs of the same flags (``want``,
    by arch): losses, grad norms and every gradient leaf's norm
    (``_held_to``), granite's dropped assignments (``_check_drops``), each
    rank's bytes its placement's share (``_check_shares``).  Reckons each
    family's whole state (16 bytes a param) against the card first.  The
    ``TRAIN_MESH_FP32`` archs run in fp32 compute on both sides, their
    one-card run made here."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api

    t_phase = time.perf_counter()
    n = TRAIN_MESH_FAMILY_STEPS
    free, total = torch.cuda.mem_get_info()
    for arch, batch, seq in TRAIN_FAMILIES:
        cfg = get_config(arch)
        whole = 16 * T.count_params(get_api(cfg).param_shapes(cfg))
        log(f"train_mesh_families {arch}: whole state {whole / 1e9:.3f} GB (params, grads and "
            f"two moments in fp32) against the card's {total / 1e9:.3f} GB ({free / 1e9:.3f} "
            f"free now); B {batch} x {seq}, {n} steps ({card})")
    runs = {(1, 2): [a for a, _, _ in TRAIN_FAMILIES], (2, 2): list(TRAIN_MESH_FAMILY_2X2)}
    shapes = {arch: (batch, seq) for arch, batch, seq in TRAIN_FAMILIES}
    want = dict(want)
    for arch in TRAIN_MESH_FP32:
        b, s = shapes[arch]
        with _spy_updates(torch, {}) as seen:
            run = _train_run(torch, f"{arch} B {b} x {s} fp32", card, "--steps", str(n), "--batch",
                             str(b), "--seq", str(s), arch=arch,
                             cfg=dataclasses.replace(get_config(arch), compute_dtype="float32"))
        want[arch] = dict(run, leaf_norms=seen["leaf_norms"])
    for shape, archs in runs.items():
        label = f"{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        jobs = [{"arch": a, "fp32": a in TRAIN_MESH_FP32,
                 "flags": ("--steps", str(n), "--batch", str(shapes[a][0]),
                           "--seq", str(shapes[a][1]))} for a in archs]
        results = _train_mesh_spawn(torch, shape, {"runs": jobs})
        log(f"train_mesh_families {label}: {shape[0] * shape[1]} ranks over gloo sharing the "
            f"card, {len(archs)} runs, {time.perf_counter() - t0:.1f}s with start-up")
        for arch, rows in zip(archs, results):
            name = f"{arch} {label}"
            _held_to(name, rows, want[arch])
            _check_shares(name, rows, card)
            if get_config(arch).moe is not None:
                _check_drops(torch, name, rows, want[arch], n, get_config(arch).moe.n_experts)
            log(f"train_mesh {name}: rank 0's steps {[round(t * 1e3, 3) for t in rows[0]['step_s']]}"
                f" ms (host clock, each step ending in the loss's read); the run "
                f"{rows[0]['wall_s']:.1f} s ({card})")
    log(f"train_mesh_families: phase {time.perf_counter() - t_phase:.1f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="on-card smoke test of the CUDA port",
        epilog="phases (see the module docstring): device, build, kernels (with B6 and B3 at "
               f"logit softcap {SOFTCAP:g}), ..., parity, softcap (the serve cell's model "
               "capped), ..., train, analysis (the dry run's FLOPs and peak against one "
               "train step on the card; the whisper-tiny decode_32k dry run), train_mesh, "
               "train_mesh_families, summary")
    ap.add_argument("--profile", action="store_true",
                    help="time B1/B2 at decode under every cluster split and B3 under every "
                         "(split, groups) after the kernels phase; after every phase, profile "
                         "decode steps and a long prefill with torch.profiler")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"[chip_smoke] FAIL: no src/repro_torch next to {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    _cut_depths()

    t_start = time.perf_counter()
    results: dict = {}
    took: dict = {}

    def run(name, fn, *a):
        """One phase, its wall seconds kept for the summary."""
        t0 = time.perf_counter()
        out = fn(*a)
        took[name] = round(time.perf_counter() - t0, 1)
        return out

    card = run("device", phase_device, torch)
    run("build", phase_build)
    run("kernels", phase_kernels, torch, results)
    if args.profile:
        phase_sweep(torch)
        phase_b3_sweep(torch)
    for name, phase in (("flash", phase_flash), ("dense_kernels", phase_dense_kernels),
                        ("family_kernels", phase_family_kernels),
                        ("moe_kernels", phase_moe_kernels),
                        ("encdec_kernels", phase_encdec_kernels),
                        ("recurrent_kernels", phase_recurrent_kernels),
                        ("fcnet", phase_fcnet)):
        run(name, phase, torch, results)
    cfg, engine, serve_outputs, serve_launches = run("serve", phase_serve, torch, results)
    run("plancache", phase_plancache, torch, results, serve_outputs, serve_launches, card)
    long_prompts, long_outputs = run("long", phase_long, torch, results)
    run("parity", phase_parity, torch, cfg, engine)
    run("softcap", phase_softcap, torch, results, cfg, engine, card)
    want = {"serve": serve_outputs, "long": [long_outputs[-1]]}
    want["spec"] = run("spec", phase_spec, torch, results, serve_outputs, card)
    want["chunked"] = run("chunked", phase_chunked, torch, long_prompts, long_outputs, card)
    run("faults", phase_faults, torch, card)
    run("families", phase_families, torch, results, card)
    moe_outputs = run("moe", phase_moe, torch, results, card)
    want.update(granite=moe_outputs["granite-moe-1b-a400m"],
                **{"qwen2-moe": moe_outputs["qwen2-moe-a2.7b"]})
    ev = run("encdec_vlm", phase_encdec_vlm, torch, results, card)
    want.update(whisper=ev[WHISPER], internvl=ev[INTERNVL])
    rec = run("recurrent", phase_recurrent, torch, results, card)
    want.update(rg=rec[RG], xlstm=rec[XLSTM])
    want["mix"] = run("mixed", phase_mixed, torch, results, card)
    run("mesh", phase_mesh, torch, want, long_prompts, card)
    with _tail_cuts():
        run("autotune", phase_autotune, torch, results, card)
        one_card, families = run("train", phase_train, torch, card)
    run("analysis", phase_analysis, torch, card)
    with _tail_cuts():
        run("train_mesh", phase_train_mesh, torch, card, one_card)
        run("train_mesh_families", phase_train_mesh_families, torch, card, families)
    log(f"phase wall seconds: {json.dumps(took)}")
    _check_family_rows(results)
    if args.profile:
        phase_profile(torch, cfg, engine)
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = results[name]
        tol = KERNEL_TOL[name]
        ok = (r["max_abs_err"] == 0 if tol is None else r["max_rel_err"] <= tol) \
            and r["launches"] > 0
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "max_rel_err": r["max_rel_err"], "ms": r["ms"],
                        "kernel_ms": r.get("kernel_ms"), "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], "rows": r.get("rows", []), "pass": ok})
    if not all(k["pass"] for k in kernels):
        raise AssertionError(f"a kernel failed: {kernels}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
