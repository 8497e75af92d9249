#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi).
  2. build: every kernel under paddle_tpu_torch/csrc, one nvcc each, all
     started together, for sm_90a; each kernel's registers, shared
     memory and spills (ptxas), and each flash kernel's tensor-core
     instructions (SASS): the bf16 K1, K2 and K3 (namespace flash_tc)
     and the fp32 K1, K2 and K3 in split TF32 (namespace flash_tf32), at
     head-dim capacities 64 and 128, causal and not, are all built, spill
     nothing and hold HMMA, no SIMT flash kernel remains, K7's split
     instantiations of the int8 decode lane
     (d 64) spill nothing, and no K4 or K6 instantiation spills; the
     SASS instructions an element of each K4 instantiation's main loop
     (cuobjdump), the bf16 one (the train path's) printed alone.
  3. kernels: each kernel's wrapper (K1-K8) on tensors on the card at
     the shapes its path gives it, held against its plain PyTorch
     version; timed against the plain version, its bound and, where one
     PyTorch call computes the same function, that call (library_ms).
     K1-K3 also at a dp replica's shard, at GPT-2 small's causal
     [96, 1024, 64] and one GPT-3 6.7B layer's causal [32, 2048, 128]
     bf16, and in fp32 at [96, 128, 128], at the fp32 train step's
     [1536, 128, 64] and at GPT-2 small's causal [96, 1024, 64] (all
     timed; SDPA with is_causal beside the causal ones), at the edges: a
     ragged tile, causal (S 200 and 256), D 32 and 12, S 1, fully masked
     rows, and in both dtypes at D 80, 96 and 128 (ragged, causal, fully
     masked rows); last, at the NMT path's shapes (phase 25, timed; their
     inputs from a generator of their own, NMT_FLASH_SEED).  bf16 K3's
     dK and dV are held to the exact answer within the rounding bound of
     its arithmetic (FLASH_TOL's comment), every other output to the
     plain version within FLASH_TOL.  K5 and K7 at the decode step and three prefill
     chunks, each with its split plan and partials workspace, both forms
     held against the plain version and timed in turns, one split
     against split.  K4 also at a dp shard's FFN shape, the MLM
     head's and GPT-2 small's FFN [8192, 3072].  K6 at the Engine path's S 128 and the bucketed arm's S 32
     and 64 (timed, with SDPA beside it), then at D 96 and 128, bf16 at
     D 32 and 64, S 1 and S 1024.  The fp32 K1 (split TF32) at the
     predictor path's b8 s128, 12 heads, D 64, timed against its bound
     (and the SIMT-rate figure), SDPA in fp32 and the composed matmul /
     softmax / matmul.
     K8's group
     form over the dp lane's real segment list (BERT-base's 206
     parameters x 4 replicas), held against the plain version member by
     member and timed against the same segments as single launches, its
     bound and torch._fused_adam_ (a yardstick); the word embedding as
     a one-segment group against its single launch, in turns.  The
     launch floor of the timing: a one-cycle device sleep.
  4. train path: BERT-base pretraining (vocab 30528, flash attention,
     hidden dropout 0.1) at b128 s128 under the bf16 dtype policy with
     Adam(1e-4), through the port's fluid.Executor on CUDAPlace(0), in
     its two modes in turns from the same state and feed: captured (the
     default: the step's first run warms up and captures a CUDA graph,
     every later one replays it) and eager (FLAGS_cuda_graph_capture
     off), 2 warm-up and 10 timed steps each.  Losses finite and
     falling; in each mode the card launches exactly 24 (K1: 12 layers,
     forward and the grad op's recompute), 12 (K2, K3) and 13 (K4) per
     step, counted by the kernels themselves (see below); the two modes'
     losses and final state bit-equal; per mode the step p50 / p95,
     MFU against the port's peak table (profiling.device_peaks), peak
     memory and the capture's seconds.  Then a torch.profiler step of
     each mode (device busy, idle share, cudaLaunchKernel and
     cudaGraphLaunch calls) with the step's elementwise device time
     split between the bf16 policy's casts and Adam's kernels, and
     run_steps(10) from the same start: its last loss and state equal
     to the 10th captured run()'s, its kernels launched 10 x a step's
     on the card.
  5. train parity: the same network at full width, 2 layers, b4 s128,
     fp32, dropout 0: 3 Adam steps on the card and on a CPUPlace
     executor from the same parameters.
  6. decode path: GPTConfig() at full width (random weights from the
     port's own startup program, fixed seed) served by DecodeEngine: 16
     seeded requests of 8-512 prompt tokens, 32 new tokens each, on an
     engine whose warmup captures both programs, then on an eager one
     from the same weights: the same ids.  K4 and K5 launch exactly 12
     (layers) x program runs on the card in each, the warmup's
     included.  Decode steps of each mode under
     the profiler, their logprobs bit-equal.
  7. decode parity: the same weights on a CPUPlace executor (plain
     versions): logprobs of prefill chunks and a decode step, and the
     greedy ids of two requests, against the card's.
  8. int8 decode path: phase 6 over the dual-int8 KV pool
     (pool_dtype="int8"): K4 and K7 launch exactly 12 x program runs on
     the card, K5 never; K7's device time summed over runs of the
     lane's first 4 requests (LANE_REQUESTS), one split and split in
     turns, each run's ids equal to the main path's.
  9. int8 decode parity: phase 7 over the int8 pool.
 10. ragged Engine path: the repo's ragged scorer (vocab 8192, hidden
     256, 8 heads, 4 layers, a causal ragged_attention a layer), saved
     with save_inference_model and served by serving.Engine (batch
     bucket 8, sequence buckets 32/64/128) in its ragged and its
     bucketed arm: waves of two requests each of 20, 50, 90 and 126
     tokens, one priming and 10 timed.  Each arm captured (one graph
     the ragged arm, three the bucketed) and then eager: the same
     scores.  K6 launches exactly 4 x the batches each arm ran on the
     card, warmup included; the ragged arm warms one shape and serves with no
     padding rows and no cold run.  Each arm's device busy time over
     one profiled wave, in each mode.
 11. ragged Engine parity: each arm's scores against a CPUPlace engine
     on the same saved model and requests.
 12. data-parallel train path: phase 4's configuration through
     CompiledProgram(...).with_data_parallel(places=[CUDAPlace(0)] * 4)
     with the quantized gradient all-reduce: the global batch b128 s128
     split into four replica shards of b32, 2 warm-up and 5 timed
     steps, captured (the whole lockstep step of the four replicas one
     graph) and eager in turns.  Losses finite and falling; in each
     mode, on the card, K8's group form launches exactly once a
     table-full of the
     plan's group step (the program's fused_adam_quant_grad ops on all
     4 replicas) a step, its per-parameter form never, and K1-K4 4x
     their phase-4 counts; every replica's parameters bit-identical and
     replica 0's the scope's; the two modes' losses and state
     bit-equal; the bucket plan, modeled wire bytes, fused-update bytes
     saved, peak memory and tokens/s (four replicas share one card: not
     a scaling figure); a torch.profiler step of each mode with K8's
     device time against its bound, the beta powers' multi-tensor
     launches and the launch API calls.
 13. data-parallel parity: full width, 2 layers, b8 s128, fp32,
     dropout 0, 3 steps over four replicas on the card and over four
     CPUPlace replicas from the same parameters: the losses, and each
     parameter above the rounding floor by the relative norms of its
     Moment1, Moment2 and change (DP_GRAD_FLOOR); the worst leaf of
     each reading, and the leaves at the floor, are printed.
 14. passes A/B: BERT-base built unfused (use_flash_attention=False, no
     dropout; the reference's passes rung, bench.py:1298-1316) at b128
     s128 under the bf16 policy with Adam(1e-4), one program with
     FLAGS_graph_passes="default" and one with "none", each run by the
     captured and the eager executor, all four in turns from one
     state, 2 warm-up and 6 timed steps.  On arm: the pass report reads
     12 fuse_attention sites (12 with a key bias) and 13
     fuse_bias_act_dropout sites, and K1-K4 launch phase 4's counts a
     step; off arm: none of them.  Each arm's captured and eager losses
     and state bit-equal; per arm and mode the step p50 / p95, peak
     memory, the step's transient memory (eager) and the graph's pool
     (captured), and a profiled step's device busy and idle.  Then full
     width, 2 layers, fp32, b8 s128, 3 steps, passes on against off:
     losses within 1e-4 relative, K1 4, K2 2, K3 2, K4 3 a step on arm.
 15. predictor: BERT-base's encoder built unfused (is_test), saved with
     save_inference_model and served by AnalysisPredictor on the card at
     b8 s128 fp32, passes on and off, each captured and eager, in turns:
     on arm 12 flash_attention ops in the loaded program and K1 and K4
     12 a run on the card (off arm none); captured equal to eager, on
     within 1e-4 of off; run p50 / p95, peak memory, device busy and
     K1's device time a run (profiler).
 16. int8-weight decode path: phase 6's lane with
     DecodeEngine(int8_weights=True): the weights claimed, the modeled
     bytes saved, ``torch.cuda.memory_allocated()`` an engine adds at
     rest with fp32 and with int8 weights; K4 and K5 12 a program run
     on the card; captured and eager ids equal; the ids equal to phase
     6's counted (not gated); decode steps profiled; logprobs (1e-3) and
     greedy ids against the port's CPU run of the same int8 weights.
 17. GPT train path: GPT-2 small (vocab 50304, hidden 768, 12 layers,
     12 heads, FFN 3072, 1024 positions, hidden dropout 0.1, causal
     flash attention) through build_gpt_lm at b8 s1024 under the bf16
     policy with fp32 masters, AdamW(6e-4, beta2 0.95, weight decay 0.1)
     and GradientClipByGlobalNorm(1.0), the default passes, captured
     and eager in turns from one state and feed, 2 warm-up and 10 timed
     steps each: losses finite and falling, the clip's global norm
     (its sqrt output) finite every step and printed, K1 24, K2 12, K3
     12 and K4 12 launches a step on the card in each mode, the two
     modes' losses, norms and state bit-equal; step p50 / p95,
     tokens/s, MFU (gpt_train_flops_per_step), peak memory, capture
     seconds, one profiled step's busy and idle.  Then the same
     configuration built unfused (use_flash_attention=False), 2 + 3
     steps captured: the pass report reads 12 fuse_attention sites, all
     causal, and K1-K4 launch the counts above.
 18. GPT parity: 2 layers at full width, fp32, dropout 0: the recipe's
     AdamW with the global-norm clip at b2 s1024, then each optimizer
     of the training front end (LarsMomentum, Adagrad, Adamax,
     DecayedAdagrad, Adadelta, RMSProp, Ftrl, Lamb, and Adam with
     L2Decay and GradientClipByValue) at b2 s256, 2 steps on the card
     and on a CPUPlace executor from the same parameters (the CPU's
     runs made in the CPU reference child, below): losses within
     1e-4; Adam's family phase 5's parameter rule, the others each
     parameter's change within 1e-3 of its norm (leaves at the
     gradient's rounding floor printed only); the worst leaf of each.
 19. the serving fleet: two DecodeEngine replicas of phase 6's GPTConfig()
     (pool_slots 8, page 16, max_len 1024; replica 1's scope filled from
     replica 0's arrays; both warmed up, both programs captured, before
     either starts) and a ragged Engine over phase 10's scorer, behind
     one serving.Router and a serving.Frontend on 127.0.0.1 (the OS's
     port).  (1) Phase 6's 16 requests as POST /v1/generate from 4
     client threads: every stream equal to a one-replica generate; a
     model the Engine has not run, loaded then, answers one /v1/infer
     while the decode traffic replays (its graph captured beside the
     live replicas) with the warm model's scores; the HTTP p50 / p99 a
     request (reqtrace), tokens/s through the frontend against the
     one-replica direct generate, and one lone request direct and over
     HTTP.  (2) Canary weight promotion (serving/promote.py,
     drill.promotion_drill) over the two replicas: clean under
     background traffic (promoted, the group converged, every request
     answered, no executor-cache miss) and a planted probe error
     (serve_error:replica0) rolled back (the canary's values restored
     bit for bit, no miss); its seconds and K4/K5 launches (exact: a
     layer a program run); then the checkpoint's weights applied back to
     both.  (3) The failover drill (serving/drill.py) through the
     frontend: replica_kill:replica0 a few decode steps into a loaded
     run; every stream token-exact, failovers and recovery seconds
     booked, no executor-cache miss, the availability SLO's page alert
     fired and cleared, and a failed-over request's trace holds its
     root, serve:replica0 in error and serve:replica1 ok.  (4) The
     hedge drill: two Engines of a small MLP, one slow; the hedge wins
     and every loser is cancelled.  (5) Phase 10's waves as POST
     /v1/infer: scores bit-equal to a direct Engine submit of the same
     feeds.  (6) /healthz, /routerz (the frontend), /servez, /metricsz
     and /tracez (an exposition server) answer 200 with the JAX
     package's top-level keys.  (7) SIGTERM lands in a child process
     (one replica behind a Frontend with install_drain) mid-request:
     the client gets its complete tokens, equal to the child's
     one-replica generate, /healthz answers 503 while draining, and the
     child exits 0 or by SIGTERM.  (8) On the card, K4 and K5 launch
     exactly 12 x the program runs of both replicas (warmups
     included), K6 4 x the Engine's batches, K7 never.
 20. fp32 train path: phase 4 without the bf16 policy (Fluid's default
     dtype; the reference bench's fp32 rung, PT_BENCH_FP32=1): BERT-base
     b128 s128 fp32 with Adam(1e-4), captured and eager in turns, 2
     warm-up and 10 timed steps each, phase 4's gates (losses finite
     and falling, K1 24, K2 12, K3 12, K4 13 launches a step on the card
     and in the wrappers, the modes bit-equal) and readings (MFU against
     the fp32 SIMT peak: the step's matmuls run in full fp32), run
     before phases 14-19; then one profiled step a mode: device busy,
     idle share, and the split-TF32 K2 and K3's device time a step.
 21. resnet train path: ResNet-50 ImageNet training as bench.py:412-452
     runs it (models.resnet.build_resnet(depth=50), b128, 3x224x224,
     1000 classes, Momentum(0.1, 0.9), the bf16 policy with fp32 masters
     and fp32 BN statistics, startup weights from a fixed seed, one
     synthetic batch from RandomState(0)), captured and eager in turns
     from one state, 2 warm-up and 8 timed steps each: losses finite and
     falling, the modes' losses and whole state (parameters, velocities,
     moving statistics) bit-equal, every moving statistic changed by
     every captured step, K1-K8 launched 0 times (no TPU kernel on this
     path); images/s, step p50 / p95, MFU from the program's conv2d and
     mul shapes (2 x multiply-adds x 3 a step: 8.18 GFLOP a forward
     image, 3.14 TFLOP a step, over 989 TFLOP/s), peak memory, graph
     pools and capture seconds; one profiled step a mode: busy, idle,
     launch API calls and device time by kernel family (cuDNN conv
     forward, dgrad, wgrad and layout transposes, BN, ReLU, Momentum,
     the policy's casts).  Then ResNet-50 in fp32 at b4, 64x64: 3 steps
     on the card and on a CPUPlace executor from the same state, losses
     within 1e-4 and state within 1e-3 of its norm, with cuDNN's flags
     first set to the library's defaults (TF32 on): the executor turns
     TF32 off and picks deterministic algorithms itself.
 22. resnet predictor: phase 21's trained weights saved by
     save_inference_model (BN in the is_test form) from an fp32 program,
     served by AnalysisPredictor at b8 fp32 with the default passes,
     captured and eager: within 1e-4 of a CPU predictor over the same
     files; run p50, busy and idle.
 23. cnn path: VGG-16, MobileNet v1, SE-ResNeXt-50 (32x4d), DenseNet-121
     and GoogLeNet (with its auxiliary heads) at 224x224, 1000 classes,
     and the MNIST conv net at 28x28, each at b8 under the bf16 policy
     with Momentum(0.1, 0.9): 3 steps captured and eager in turns,
     bit-equal, finite losses, K1-K8 never launched; each step's
     seconds.
 24. nmt train path: Transformer NMT as bench.py:454-560 measure_nmt
     runs it: TransformerConfig.big() (vocabularies 30000, hidden 1024,
     16 heads, FFN 4096, 6 + 6 layers) with dropout 0.1, the bf16 policy
     with fp32 masters, Adam(1e-4), the default passes; ragged batches
     bucketed to source lengths 32, 64, 128 and 256 (targets a token
     shorter) under an 8192-token budget, made as the bench's
     ragged_batch makes them (RandomState(0), lengths uniform in (the
     previous bucket, bucket], source pads 0, label_weight zero past
     each length) by the port's make_fake_batch.  Captured and eager in
     turns from one state: one warm-up round (an eager warm-up and a
     capture a bucket: 4 graphs), then 2 timed rounds.  Losses finite,
     the modes' losses and whole state bit-equal, 4 graphs held, the
     pass report's fuse_attention sites 0 (the attention dropout vetoes
     the rewrite), K1-K8 launched 0 times (wrappers and card); per mode
     the effective tokens/s (non-pad source and target tokens, as the
     bench counts them), padding overhead, step p50 / p95 a bucket, MFU
     (forward_flops x 3 at each bucket's shapes over 989 TFLOP/s), peak
     memory, graph pools and capture seconds; one profiled step a mode
     at bucket 128.  Then the executors and graphs are freed.
 25. nmt flash train path: phase 24 with dropout 0.0: the pass report
     reads 12 fuse_attention sites (6 encoder self-attentions with the
     -1e9 pad bias, 6 causal decoder ones; no cross-attention), and the
     card runs K1 24, K2 12 and K3 12 a step, K4-K8 none, gated exactly
     in each mode; the same gates and readings.  Phase 3 holds K1-K3
     against their plain versions at this path's shapes (the encoder's
     [8192/S, 16, S, 64] with the pad bias and the decoder's causal
     [8192/S, 16, S-1, 64], S 32 and 256, bf16; and phase 26's fp32
     [512, 64, 64] with the unrounded -1e9 pad bias and causal
     [512, 17, 64]), timed against their bounds and SDPA.
 26. nmt decode path: build_greedy_decode(TransformerConfig.big(),
     max_out_len=16), fp32, the default passes, over its startup's
     seeded weights: 32 seeded sources padded to 64, one warm-up (the
     capture) and 5 timed runs a mode in turns: the ids equal across
     runs and modes, at least 8 distinct outputs, K1 102 a run on the
     card (6 encoder + 16 x 6 decoder self-attentions), K2-K8 none; run
     p50; the ids and every pass's logits held against a CPU run of the
     same program on the same feed (logits within 1e-3; a row's ids may
     part only at a near-tie).  Then the card-vs-CPU parity: 2 + 2
     layers at full width, fp32, dropout 0, the passes on, a padded
     bucket-32 batch of 16: 2 Adam steps on the card and on a CPUPlace
     executor from one state, losses within 1e-4; on every parameter
     above the gradient floor the first step's gradient within 4e-3 of
     its norm and the updates within 1e-6 mean abs and 5e-2 of their
     norm (the max abs printed beside the CPU's own reading from a
     start moved by 1e-6: see NMT_PARITY_GRAD_RTOL), and control runs
     on the card with a planted error in K2's dQ failing them (1%: the
     gradient and mean abs limits; 10%: all three); the greedy decode
     of the card's final weights held against the CPU's as above.
 27. book path: the ten book programs of tests/book/ through the port
     (tests/torch_port_books.py: fit_a_line, recognize_digits mlp and
     conv, image_classification vgg and resnet, word2vec, ctr,
     understand_sentiment conv and stacked LSTM, rnn_encoder_decoder,
     recommender_system, label_semantic_roles, the attention-fusion
     Transformer book and machine_translation), each at its own batch, widths, epochs, optimizer
     and learning rate on CUDAPlace(0), the captured and the eager
     executor in turns from one state for the first 8 steps
     (BOOK_EAGER_STEPS; one executor pair a book, freed after it): the
     modes' losses and whole state bit-equal there; the captured one
     then trains on alone; every
     state tensor on the card, the book's own loss threshold met; the
     inference model saved and reloaded on the card, its prediction
     within rtol 2e-4, atol 2e-5 of clone(for_test=True); the first 2
     losses within 1e-4 of a CPUPlace run of the port from the card's
     startup state; label_semantic_roles' Viterbi paths from the card's
     trained state equal to the CPU's on the same batch (a differing
     step prints the margin between its top two path scores);
     machine_translation's two beam decodes from the card's trained
     state, the unrolled one (captured) and the While over tensor arrays
     (eager by rule), ids equal and scores within 1e-5.  K1 8, K2
     4 and K3 4 a step on the fused Transformer book (4 self-attention
     sites, fp32: split TF32 at D 16), none elsewhere, gated exactly in
     each mode; per book the step p50 / p95 a mode, examples/s, launch
     API calls a step (one profiled step a mode), capture seconds and
     the final loss beside its threshold.  Phase 3 holds K1-K3 at the
     Transformer book's fp32 shapes ([32, 12, 16] with the key bias,
     causal [32, 10, 16]) against their plain versions, timed against
     their bounds and SDPA.
 28. health path: phase 4's BERT-base b128 s128 bf16 Adam step with
     FLAGS_health_sentinel on (health/: the finite check before the
     optimizer ops, the in-step gate, the host's response), the captured
     and the eager executor in turns from one state, a new pair an arm.
     (1) skip, nan:grad:step:3 over 6 steps: found_inf 1 on step 3 only,
     every persistable but the @HEALTH@ ones bit-unchanged across step
     3, the later losses finite, bad_steps_total 1, captured = eager bit
     for bit, and the flight recorder's postmortem (reason health) holds
     a health record with detect grad and the step records.  (2)
     rollback: the injected run (7 program runs: the replay at the same
     step) bit-equal to the same program with its countdown disarmed,
     losses and state, in both modes.  (3) raise: RuntimeError naming
     step 3.  (4) dynamic loss scaling (its own program): the scale
     65536 until step 3, halved on it and held after.  (5) card against
     CPU: 2 layers at full width, fp32, dropout 0, the fault on step 2
     of 3: losses within 1e-4, found_inf [0, 1, 0] on both, the skipped
     step's state bit-unchanged on both.  (6) captured step p50 / p95
     with the sentinel off and on (skip, nothing planted), 10 steps each
     in turns, and each one's launch API calls, busy and idle (one
     profiled step).  (7) /profilez over a real scrape: 200 with the JAX
     package's keys.  Every program run, replays included, launches K1
     24, K2 12, K3 12, K4 13 on the card (gated run by run); the
     wrappers see each eager run and each capture's warm-up and capture.
 29. generate path: GPT beam generation at GPTConfig() width (seeded
     random weights), fp32, batch 8, beam 4, a 64-token prompt and 32
     new tokens, in its three builds — the prefix recomputed each step
     and the KV-cached one (both captured), and the while-loop scan
     (eager in both modes by rule) — each with a new executor pair, 2
     runs a mode in turns: every run of a build bit-equal, ids equal
     across the builds and scores within 1e-4; K1 and K4 launches a run
     exactly what the pruned plan after the graph passes holds
     (recompute 384 / 384, cached 12 / 12 + 12 x 31, scan 12 / 12), on
     the card and in the wrappers; a run's ms, tokens/s (8 x 32 over its
     p50) and launch API calls (one profiled run a mode; the scan
     build's one, the same eager loop under either executor).  Card against
     CPU at 2 layers and full width (the cached and scan builds): ids
     equal, scores within 1e-4, beside the smallest gap between the
     K-th and (K+1)-th candidate over every step.  The scheduled step:
     phase 4's BERT-base b128 s128 bf16 step with linear_lr_warmup over
     polynomial_decay(power 1) (the Switch crossed at step 4), 8 steps
     captured and eager in turns: bit-equal, the LR within 1e-7 of the
     closed form, one graph (launch API calls equal to the constant-LR
     step's, one cudaGraphLaunch), K1 24, K2 12, K3 12, K4 13 a run;
     its p50 beside the constant-LR step's (its own executor).  Phase 3
     holds K1-K3 at the generation prefills' fp32 causal shapes.
 30. persist: a job that outlives its process.  (1) Phase 28's
     BERT-base b128 s128 bf16 step (hidden dropout 0.1, Adam, captured,
     the sentinel on with skip, nan:grad:step:9 planted) under
     AutoCheckpoint(save_interval=4, keep_max=2, sentinel=): a child
     runs steps 0-6 and is sent SIGTERM, which snapshots and ends it by
     the default action; a second child resume()s (7) and runs steps
     7-11; here, the uninterrupted 12 steps from the same seeded start.
     The resumed losses, found_inf and whole final state (every
     persistable, @HEALTH@ included) bit-equal to the uninterrupted
     run's; the sentinel's state after the restore bit-equal to the
     killed child's last save (the two children are warm children,
     started with the builds: their seconds count from their job, not
     from a fresh process); K1 24, K2 12, K3 12, K4 13 a step on the
     card in every run; at most 2 complete checkpoints and no temp
     left.  save() seconds and bytes, SIGTERM-to-exit seconds, resume()
     seconds and the first captured step after it.  (2) Phase 13's
     BERT-base encoder predictor (b8 s128 fp32, passes on) saved as
     JSON and in Fluid's protobuf format (one combined LoDTensor
     stream): the __model__ a ProgramDesc, each format's predictor in
     each mode within 1e-6 of the JSON captured one (the float attrs
     proto2 rounds to float32 named), K1 and K4 12 a run; load seconds
     and run p50.  (3) Two fresh children serve the decode lane's first
     4 requests (32 tokens) on a DecodeEngine over GPTConfig(), the
     first with an empty FLAGS_aot_cache_dir, the second with what the
     first left: the second books aot_hit for both programs, no miss,
     no passes and no trace seconds; their ids equal to each other's
     and to the lane's; K4 and K5 12 a program run; the seconds from
     the process's start to its first token, split.
 31. resnet dp path: phase 21's ResNet-50 (224², the bf16 policy,
     Momentum(0.1, 0.9)) through CompiledProgram(...).with_data_parallel
     over [CUDAPlace(0)] x 4, b32 a replica, BuildStrategy with the
     quantized all-reduce, sync_batch_norm and the fused update; the
     captured and the eager executor in turns from one state, 2 warm-up
     and 4 timed steps each.  After every step of each mode: finite
     losses (falling over the run), every replica's parameters,
     velocities and moving statistics bit-identical and replica 0's the
     scope's, every moving statistic changed and within 8 ulps of its
     dtype of the mean of the replicas' batch statistics (SavedMean,
     and the batch variance from SavedVariance) folded into the
     previous value (the bf16 policy casts the c_allreduce_avg's
     inputs, so the statistics are bf16 from the first step on, as in
     the JAX package); K8's momentum group form launched exactly as the
     plan's group steps take it, K1-K7 and K8's per-parameter form
     never; the modes' losses and whole state bit-equal.  Images/s,
     step p50 / p95, MFU, peak memory, the graph pool, capture seconds,
     the bucket plan, modeled wire bytes and the fused-update bytes
     saved (one card runs the four replicas: not a scaling figure); a
     profiled step a mode (busy, idle, launch API calls, K8's device
     time).  Then ResNet-50 fp32 at 64x64 over 2 replicas of b4, 2
     steps, CPU replicas taking each step from the card's state:
     phase 21's parity gates.  Phase 3 holds K8's momentum group form
     at this program's members (161 parameters x 4 replicas) against
     its plain version, timed against its bound.
 32. amp path: the train cell's BERT-base b128 s128 (attention dropout
     0, hidden dropout 0.1, Adam(1e-4), the default passes) with no
     bf16 policy, under fluid.contrib.mixed_precision.decorate twice:
     (a) the default, bf16 with a static scale of 1.0; (b) fp16 with a
     dynamic scale from 2^15 (up x2 after 4 good steps, x0.8 on each
     bad one).  Each arm captured and eager
     in turns, 2 warm-up and 4
     timed steps: finite losses, the scale after each step equal to the
     rule over the card's own found-inf flags, the modes bit-equal, the
     pass report the JAX package's (no fuse_attention site, 13
     fuse_bias_act_dropout sites, no fused loss; amp_pass_sites), K1
     24, K2 12, K3 12 (their fp32 forms: the rewrite's fp32 bias adds
     promote Q, K and V) and K4 13 (bf16 in (a), its fp16 form in (b),
     an fp32 bias) a step, the kernels' input dtypes recorded on one
     more eager step.  Tokens/s, step p50 / p95, MFU, memory and graph
     pool an arm, and a profiled step an arm and mode, beside phase
     4's bf16-policy step.  Then each arm at 2 layers, full width, b2
     s64, 2 steps card against CPU (the CPU's fp16 matrix products are
     slow) on two seeded batches: losses, first gradients and updates
     within limits (AMP_PARITY_LIMITS) that planted faults in K4's
     rounding must each break (toward zero in both arms; through 8 bits
     in the fp16 arm); and in the fp16 arm one more step on a batch
     with an inf in input_mask: found-inf on both, the scale cut to 0.8
     of itself on both, on each device the grads zeroed by a multiply
     (0, or NaN where they were not finite) and each parameter NaN
     exactly where its grad is (the JAX package's rule).  Phase 3
     holds K4's fp16 form at the step's [16384,
     3072] and [2048, 768], with and without a mask and at fp16's edge,
     within one fp16 ulp of its plain version (infs equal), timed
     against the bytes bound and a device copy of the same bytes.
 33. moe path: BERT-base with the MoE FFN (moe_experts 4, top 2; dense
     dispatch), b128 s128, the bf16 policy, Adam(1e-4), attention
     dropout 0: captured and eager in turns for 2 steps (losses and
     state bit-equal), then 4 more captured (timed): finite falling
     losses, K1 24, K2 12, K3 12 and K4 1 (the MLM head) a step; step
     p50, MFU from the FLOPs the dense dispatch computes
     (moe_train_flops_per_step), memory and the graph pool, a profiled
     step a mode.  Then 2 layers at full width, fp32, dropout 0, b4
     s128, 3 Adam steps card against CPU: losses within 1e-4 and phase
     5's update gates.
 34. gm path: BERT-base b32 s128 micro-batches under the bf16 policy with
     GradientMergeOptimizer(Adam(1e-4), k_steps=4) (b128 a boundary) and
     a ModelAverage updated in the program, 8 micro-steps over four
     fixed batches, captured and eager in turns: off the boundary every
     parameter, Adam moment and beta power bit-equal to the last
     boundary's, at steps 4 and 8 every parameter changed and each beta
     power advanced once; K1-K4 24/12/12/13 a micro-step; the modes
     bit-equal.  The fp32 is_test program with the auc and accuracy ops
     on the NSP head, captured before ModelAverage.apply() and replayed
     inside it on 4 batches: the averages in the scope's own tensors,
     the replays equal to an eager run, the auc op's histograms equal to
     fluid.metrics.Auc's fed the fetched probabilities (value within
     1e-6), fluid.metrics.Accuracy against the host's count, the trained
     parameters back after it.  GM's first boundary over four b32 slices
     against one plain b128 Adam step (hidden dropout 0): within 4x the
     plain step's distance from itself on the permuted batch in fp32;
     the bf16 distances printed.  fluid.gradients: the saliency of the
     loss to the summed embeddings at full width (K2, K3 12 each), at 2
     layers fp32 against the CPU (4e-3), and the WGAN-GP penalty of
     tests/test_double_grad.py, 3 steps card against CPU, and its conv2d
     double grad (conv2d_grad_grad) card against CPU.
 35. ssd path: MobileNet-v1 SSD 300² as PaddleCV/ssd builds and trains it
     (tests/torch_port_detection_models.py: the backbone of
     models/mobilenet.py, four extra blocks, multi_box_head over six
     maps with the published priors, 1917 of them, 21 VOC classes,
     ssd_loss summed; RMSProp on piecewise_decay from 1e-3 with
     L2Decay(5e-5)) at b64, fp32, one seeded synthetic batch of 1-8
     boxes an image, captured and eager in turns from one state, 2
     warm-up and 6 timed steps each: losses finite and falling, every
     moving statistic changed by every captured step, the modes
     bit-equal, K1-K8 never launched; images/s, step p50 / p95, MFU
     (cnn_flops_per_image over the fp32 peak), memory and the graph
     pool, a profiled step a mode.  The test program
     (clone(for_test=True) + detection_output: NMS 0.45, top 400, keep
     200) on the trained scope, captured and eager in turns: every run's
     rows bit-equal, the kernels of a replay and of one multiclass_nms
     call, the 11-point and integral mAP (fluid.metrics.DetectionMAP,
     not gated).  Width 0.25, b4, fp32, 3 steps card against CPU, each
     from the card's state: losses 1e-4, updates within 0.1 of the CPU's
     (the CPU's reading from a nudged input beside it); the head outputs
     from one state 1e-5 and the CPU's decode and NMS of the card's head
     outputs equal to the card's rows.  Then every detection op off the
     path at a realistic shape against the CPU child's run (YOLOv3-608's
     head at b8: yolov3_loss and its grad, yolo_box and resize_nearest
     at each grid and the NMS over the three heads; Faster and Mask
     R-CNN, FPN, RetinaNet, the deformable ops, R-FCN, an OCR warp, EAST,
     CVM and SSD's matching ops), each within its tolerance.

The CPU runs of phases 18's, 26's and 32's parities, from their
programs' startups on the CPU, and of phase 35's detection op checks
(each case's lowering on the CPU), are made in child processes at a lower
priority that see no card (CpuChild: a process a part, two for phase
18's, the cores shared among them).  It starts with the
kernels' builds and runs beside them and phase 3, whose readings are
device times; the script waits for it to end before phase 4, so that
no host reading of a later phase is taken beside it.  The builds start
together (``_build.start_builds``), and phase 3 holds K4-K8 while the
flash kernels still build.

Phases 1-13 also check that this slice's passes (fuse_attention,
fuse_softmax_cross_entropy) match nothing on their programs.  Each
phase's line carries the seconds since the previous one (``phase_s``).

``python3 chip_smoke.py --only k4,k6,k6_contract`` runs phases 1-3 for
the named kernels alone (a quick check of a kernel change; see ONLY;
``--only flash``: K1-K3 with phase 2's flash report);
``--only engine`` adds phases 10-11, ``--only passes,predictor,int8w``
phases 14, 15 and 16 (``predictor`` with phase 3's fp32 K1 at its
shape), ``--only gpt`` phase 3's K1-K4 checks and phases 17-18,
``--only fleet`` phase 19, ``--only fp32train`` phase 20, ``--only
resnet`` phases 21-22, ``--only cnn`` phase 23, ``--only nmt`` phase
3's K1-K3 at the NMT shapes and phases 24-26, ``--only book`` phase
3's K1-K3 at the Transformer book's shapes and phase 27, ``--only
health`` phase 28, ``--only generate`` phase 3's K1-K3 at the
generation shapes and phase 29, ``--only persist`` phase 30, ``--only
resnetdp`` phase 3's K8 momentum group check and phase 31, ``--only
amp`` phase 3's fp16 K4 check and phase 32, ``--only moe`` phase
33, ``--only gm`` phase 34, and ``--only ssd`` phase 35.

Each path runs with every launch count set to 0 just before it and read
just after; a kernel of the path launched no time fails the run.  Two
counts, both gated exactly: each wrapper's (``.launches``, Python: the
calls that launched its kernel, or recorded it into a graph being
captured; a replay runs no Python, so in the captured mode the wrappers
see each signature's eager warm-up run and its capture only) and each
kernel's own on the card (``kernels.device_launch_counts``: the first
thread of a launch's first block adds one, so it counts every run the
device made, replays included).  The kernels JSON gives both, summed
over each path's two modes (``launches``, ``device_launches``).  The
last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Exits non-zero (and prints no result)
without CUDA or without the package beside it.
"""

import atexit
import contextlib
import difflib
import json
import os
import shutil
import signal
import subprocess
import tempfile
import sys
import time

import numpy as np
import torch

SEED = 1234

# K5 kernel vs plain: the kernel sums keys page by page with an online
# softmax merged across eight warps and then across splits; the plain
# version takes one softmax over the whole row and one matmul.  Same fp32
# terms, other order.
K5_TOL = dict(atol=2e-5, rtol=1e-4)
# K4 kernel vs plain: the same elementwise formula; erfcf/tanhf in the
# kernel and PyTorch's CUDA erfc/tanh may differ by an ulp.
K4_TOL = dict(atol=1e-6, rtol=1e-6)
# K4 in bf16: kernel and plain version both round the same fp32 value to
# bf16, so they may differ by one bf16 ulp (2^-8 relative)
K4_BF16_TOL = dict(atol=8e-3, rtol=8e-3)
# K1-K3 vs plain: fp32 sums over 64-key (or 64-query) tiles vs one
# matmul; in bf16 both round one fp32 result, so one bf16 ulp apart.
# bf16 K3's dK and dV are not held to the plain version but to the exact
# answer (the plain version's fp32 arithmetic on the same bf16 inputs,
# unrounded: flash.flash_bwd_dkv_truth), within the rounding bound of the
# kernel's own arithmetic, element by element
# (flash.flash_bwd_dkv_bf16_bound).  Why: dV_j = sum over the S query
# rows of P_ij dO_i, and the kernel takes P rounded to bf16 (relative
# error u = 2^-8) into the tensor cores, so its dV errs by up to
# u * sum_i P_ij |dO_i| before its own output rounding u |dV_j|.  Summed
# over S = 256 rows of a short sentence (n real keys, P ~ 1/n, |dO| ~
# 0.8) that is u * 256 * 0.8 / n, 0.27 at n = 3, while dV_j itself may
# cancel to near 0: many of its bf16 ulps, outside 2e-2 + 2e-2 |dV_j|.
# The pad bias adds nothing: -1e9 (-999817216 in bf16) swamps the fp32
# logit (whose digits vanish at that magnitude), exp gives 0 exactly in
# the kernel and the exact answer, so a pad key's dK, dV are 0 without
# error.  dS goes to the tensor cores as two bf16 parts (u^2), so dK
# errs by little beyond its output rounding.  The plain bf16 version
# rounds the exact answer once (u |dV_j|), and is the closer of the two.
# Measured (tools/torch_k3_seeds.py, 64 seeds of nmt_enc_s256 on an
# H100): 15 seeds outside 2e-2 against the plain version (max 0.125,
# dV of a real key of a 3-5-key sentence), every seed's kernel within
# 0.96 of the bound.  2e-2 against the plain version stays for K1, K2
# and the fp32 kernels.
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# dBias sums dL over every query: fp32 in both, other order
FLASH_DBIAS_TOL = dict(atol=1e-4, rtol=1e-4)
# full model on the card vs on the CPU: 12 layers of fp32 matmuls summed
# in other orders (cuBLAS vs the CPU BLAS) before a 32000-way log_softmax
PATH_LOGP_ATOL = 1e-3
# BERT training on the card vs the CPU, fp32: per-step losses; and the
# parameters of one layer after 3 Adam steps, where one element's update
# is at most lr in size and its sign can follow a grad that is zero up
# to the two BLAS libraries' rounding: max abs diff within 3 x lr, mean
# abs diff within 1e-6
TRAIN_LOSS_RTOL = 1e-4
TRAIN_LR = 1e-4
TRAIN_PARAM_MAX_ATOL = 3 * TRAIN_LR
TRAIN_PARAM_MEAN_ATOL = 1e-6

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32
# (non-tensor-core) flop/s, TF32 and bf16 dense tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_TC_FLOPS = 494.7e12
BF16_TC_FLOPS = 989e12
GELU_FLOPS_PER_ELEMENT = 10  # add, scale, erfc, mul... as counted in PERF.md
# device sleep ahead of a timed run, ~0.08 s: many times the few ms the
# host takes to enqueue a timed run (_time_ms raises if it does not)
SLEEP_CYCLES = 150_000_000


def _gpu_place():
    from paddle_tpu_torch import fluid

    return fluid.CUDAPlace(0)


def _model_config():
    """The served model: GPTConfig() at its defaults (vocab 32000, hidden
    768, 12 layers, 12 heads, FFN 3072, 1024 positions)."""
    from paddle_tpu_torch.models import gpt

    return gpt.GPTConfig()


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def launch_floor_ms():
    """What the timing below reads for a kernel that does nothing: a
    one-cycle device sleep, the floor under every small kernel's time."""
    return _time_ms(lambda: torch.cuda._sleep(1), 100)


def _time_ms(fn, iters, flush=None):
    """Mean device time of one fn() call, CUDA events around each call;
    `flush` (run between calls, untimed) evicts L2.  A device sleep is
    queued first, so the host has enqueued every call before the card
    reaches the first: the events then time the card's work, not the
    host's launch overhead (checked: the sleep must outlast the
    enqueueing, so `iters` x the launches of one call must stay within
    the stream's queue of pending work, a few hundred entries)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for a, b in evs:
        if flush is not None:
            flush()
        a.record()
        fn()
        b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if start.elapsed_time(evs[0][0]) <= host_ms:
        raise RuntimeError(f"timing: the device sleep ended before the host "
                           f"finished enqueueing ({host_ms:.2f} ms); raise "
                           f"SLEEP_CYCLES")
    return sum(a.elapsed_time(b) for a, b in evs) / iters


# ---------------------------------------------------------------------------
# the executor's two modes: every path runs captured (the default) and,
# in turns from the same state and feeds, eager
# ---------------------------------------------------------------------------

# (mode, capture): the captured executor replays a CUDA graph per
# signature; the eager one (FLAGS_cuda_graph_capture off) runs the op loop
MODES = (("captured", True), ("eager", False))


@contextlib.contextmanager
def capture_mode(on):
    """Executors made inside (an engine's too) capture their programs
    (FLAGS_cuda_graph_capture on, the default) or run the eager loop."""
    from paddle_tpu_torch import fluid

    old = fluid.get_flags("FLAGS_cuda_graph_capture")
    fluid.set_flags({"FLAGS_cuda_graph_capture": on})
    try:
        yield
    finally:
        fluid.set_flags(old)


def _clone_scope(scope, device=None):
    """A scope of copies of ``scope``'s tensors (on ``device`` where
    given)."""
    from paddle_tpu_torch import fluid

    out = fluid.Scope()
    for n in scope.keys():
        out.set(n, scope.get(n).detach().to(device).clone())
    return out


def _scope_diff(a, b):
    """Names whose tensors differ (bit for bit) between two scopes."""
    return sorted(n for n in a.keys()
                  if b.get(n) is None or not torch.equal(a.get(n), b.get(n)))


def _snap():
    """Both launch counts so far: the wrappers' ({name: calls that
    launched the kernel or recorded it into a graph being captured})
    and the kernels' own on the card ({name: launches the device ran,
    graph replays included}, ``kernels.device_launch_counts``; it
    synchronizes the device)."""
    from paddle_tpu_torch import kernels

    return kernels.launch_counts(), kernels.device_launch_counts()


def _since(snap, names):
    """(wrapper launches, device launches) of ``names`` since ``snap``."""
    return tuple({k: now[k] - was[k] for k in names}
                 for now, was in zip(_snap(), snap))


def _times(counts, n):
    return {k: n * v for k, v in counts.items()}


def _add(total, delta):
    for k, v in delta.items():
        total[k] = total.get(k, 0) + v


def _summed(per_mode):
    """{kernel: count} summed over the modes of {mode: {kernel: count}}."""
    out = {}
    for counts in per_mode.values():
        _add(out, counts)
    return out


def _capture_seconds(exe, *programs):
    """Summed capture seconds of the graphs ``exe`` holds for
    ``programs``."""
    return sum(e.graph.capture_seconds for p in programs
               for e in exe.compiled_for(p) if e.graph is not None)


def graph_pools_gb():
    """GB the CUDA graphs' private memory pools hold (segments outside
    the allocator's default pool): a replay's activations live there,
    which ``max_memory_allocated`` does not count once captured."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


def _ms_quantiles(secs):
    a = np.asarray(secs)
    return dict(p50_ms=1e3 * float(np.percentile(a, 50)),
                p95_ms=1e3 * float(np.percentile(a, 95)))


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of the flash kernels
# ---------------------------------------------------------------------------


def _demangle(names):
    """C++ names of mangled symbols, where a demangler is installed."""
    import shutil

    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


# the tensor-core flash kernels: bf16 K1, K2, K3 (namespace flash_tc)
# and fp32 K1, K2, K3 in split TF32 (namespace flash_tf32), each at both
# head-dim capacities and causal or not
FLASH_TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc",
                    "flash_fwd_tf32", "flash_bwd_dq_tf32",
                    "flash_bwd_dkv_tf32")
FLASH_HEAD_DIMS = (64, 128)
FLASH_TC_NAMESPACES = ("_ZN8flash_tc", "_ZN10flash_tf32")


def _ptxas_parse(log):
    """{mangled name: {registers, static_smem_bytes, spill_bytes, ...}}
    of each entry function in an nvcc -Xptxas -v log."""
    import re

    found, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) \
            or re.search(r"Function properties for (\S+)", line)
        if m:
            cur = found.setdefault(m.group(1), {"static_smem_bytes": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack_frame_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    return found


def _ptxas_entries(name):
    """[(mangled name, C++ label, {registers, static_smem_bytes,
    spill_bytes})] of each entry function of kernel library ``name``,
    from its build's -Xptxas -v."""
    from paddle_tpu_torch.kernels import _build

    found = _ptxas_parse(_build.build_log(name))
    out = []
    for mangled, label in zip(found, _demangle(list(found))):
        for a, b in (("(anonymous namespace)::", ""), ("<unnamed>::", ""),
                     ("(bool)0", "false"), ("(bool)1", "true"),
                     ("void ", "")):
            label = label.replace(a, b)  # c++filt's and cu++filt's forms
        out.append((mangled, label.split("(")[0], found[mangled]))
    return out


def flash_build_report():
    """Each flash entry function's registers, static shared memory and
    spill bytes (the build's -Xptxas -v), and the tensor-core (HMMA,
    HGMMA) instructions in its SASS (cuobjdump, where the toolkit has
    it; the split-TF32 products show as HMMA too).  Every instantiation
    of the bf16 K1, K2 and K3 (namespace flash_tc) and of the fp32 K1,
    K2 and K3 (namespace flash_tf32), at head-dim capacities 64 and 128,
    causal and not, must be there, spill nothing and, where SASS can be
    read, hold tensor-core instructions; no SIMT flash kernel may
    remain."""
    import re
    import shutil

    from paddle_tpu_torch.kernels import _build

    entries = _ptxas_entries("flash_attention")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    hmma = {}
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path("flash_attention"))],
            capture_output=True, text=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = block.split("\n", 1)[0].strip()
            hmma[name] = len(re.findall(r"\bH(?:G)?MMA\b", block))
    report = {}
    for mangled, label, props in entries:
        r = dict(props)
        if mangled in hmma:
            r["tensor_core_instructions"] = hmma[mangled]
        # a function of namespace flash_tc or flash_tf32 (not one merely
        # taking their Strides)
        r["tensor_cores"] = mangled.startswith(FLASH_TC_NAMESPACES)
        report[label] = r
    bad = [k for k, r in report.items() if r["tensor_cores"] and (
        r.get("spill_bytes") != 0
        or r.get("tensor_core_instructions", 1) == 0)]
    # each kernel at each capacity, causal and not (template arguments
    # <bool, int> mangle as Lb0/Lb1 then Li64E/Li128E)
    tc_mangled = [m for m, _, _ in entries
                  if m.startswith(FLASH_TC_NAMESPACES)]
    missing = [f"{k}<{bool(c)}, {d}>" for k in FLASH_TC_KERNELS
               for d in FLASH_HEAD_DIMS for c in (0, 1)
               if not any(k in m and f"Lb{c}ELi{d}E" in m
                          for m in tc_mangled)]
    simt = [k for k, r in report.items()
            if not r["tensor_cores"] and "flash" in k]
    if bad or missing or simt:
        raise AssertionError(f"flash build: tensor-core kernels spilling or "
                             f"without HMMA {bad}, missing {missing}, SIMT "
                             f"flash kernels {simt}: {report}")
    return report


def paged_build_report():
    """Registers, static shared memory and spill bytes of every K5 and
    K7 instantiation (template arguments <query tile, columns a lane,
    int8 pool>).  The split form is held to two CTAs an SM (128
    registers); K7's split instantiations of the int8 decode lane (d 64:
    two columns a lane) must spill nothing."""
    report = {label: props
              for _, label, props in _ptxas_entries("paged_attention")}
    lane = [k for k in report
            if "split_kernel" in k and k.endswith(", 2, true>")]
    bad = [k for k in lane if report[k].get("spill_bytes") != 0]
    if len(lane) != 2 or bad:
        raise AssertionError(f"paged build: K7's lane split instantiations "
                             f"{lane} (2 expected), spilling {bad}: "
                             f"{report}")
    return report


def _sass(name):
    """{mangled entry: ([(address, instruction)], {label: address})} of
    kernel library ``name`` (cuobjdump -sass); {} where the toolkit has
    no cuobjdump."""
    import re
    import shutil

    from paddle_tpu_torch.kernels import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        return {}
    text = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        fname, body = block.split("\n", 1)
        instrs, labels, pending = [], {}, []
        for line in body.splitlines():
            s = line.strip()
            m = re.match(r"(\.L_x_\d+):", s)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"/\*([0-9a-f]+)\*/\s+(.*?)\s*;", s)
            if m:
                addr = int(m.group(1), 16)
                labels.update((lb, addr) for lb in pending)
                pending = []
                instrs.append((addr, m.group(2)))
        out[fname.strip()] = (instrs, labels)
    return out


def _store_bytes(ins):
    """Bytes one SASS global store writes (0 for any other
    instruction)."""
    op = next(t for t in ins.split() if not t.startswith("@"))
    if not op.startswith("STG"):
        return 0
    parts = op.split(".")
    for width, n in (("128", 16), ("64", 8), ("U16", 2), ("S16", 2),
                     ("U8", 1), ("S8", 1)):
        if width in parts:
            return n
    return 4


def _main_loop(instrs, labels, elem_bytes):
    """The loop (a backward branch and the instructions from its target
    to it) that stores the most bytes an iteration: its static
    instruction count, the elements it stores (``elem_bytes`` each) and
    the instructions an element.  None if the function has no loop."""
    import re

    best = None
    for addr, ins in instrs:
        m = re.search(r"\bBRA\s+`?\(?([.\w]+)\)?", ins)
        if not m:
            continue
        tgt = m.group(1)
        start = labels.get(tgt) if tgt.startswith(".L") else int(tgt, 16)
        if start is None or start > addr:
            continue
        body = [i for a, i in instrs
                if start <= a <= addr and not i.startswith("NOP")]
        stored = sum(_store_bytes(i) for i in body)
        key = (stored, -len(body))
        if stored and (best is None or key > best[0]):
            best = (key, dict(instructions=len(body),
                              elements=stored // elem_bytes,
                              per_element=len(body) / (stored // elem_bytes)
                              if stored >= elem_bytes else None))
    return best[1] if best else None


def k4_k6_build_report():
    """Registers, static shared memory and spill bytes of every K4 and
    K6 instantiation (ptxas), and for each K4 one its main loop's SASS
    instructions an element stored.  Fails if one spills.  Returns the
    report and the bf16 K4 loop's count (x and bias bf16, no mask,
    exact GeLU: the training path's)."""
    report, spilling, bf16_loop = {}, [], None
    for name in ("fused_bias_act", "ragged_attention"):
        sass = _sass(name) if name == "fused_bias_act" else {}
        for mangled, label, props in _ptxas_entries(name):
            r = dict(props)
            if mangled in sass:
                # out's element size: bf16 and fp16 2 bytes, fp32 4
                elem = 2 if ("<__nv_bfloat16" in label
                             or "<__half" in label) else 4
                r["main_loop"] = _main_loop(*sass[mangled], elem)
                if ("__nv_bfloat16, __nv_bfloat16" in label
                        and label.endswith("false, false>")
                        and r["main_loop"]
                        and (bf16_loop is None
                             or r["main_loop"]["elements"]
                             > bf16_loop["elements"])):
                    bf16_loop = dict(r["main_loop"], kernel=label)
            if r.get("spill_bytes", 0) != 0:
                spilling.append(label)
            report[f"{name}: {label}"] = r
    if spilling:
        raise AssertionError(f"K4/K6 build: spilling {spilling}: {report}")
    return report, bf16_loop


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _paged_inputs(dev, b, n, t, d, page_size, max_pages, num_pages,
                  q_start, rng):
    q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                         .astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                         .astype(np.float32)).to(dev)
    # page 0 is the trash page: poison it, so attending it would show
    k[0] = 1e4
    v[0] = 1e4
    return (q, k, v) + _page_table(dev, b, t, page_size, max_pages,
                                   num_pages, q_start, rng)


def _page_table(dev, b, t, page_size, max_pages, num_pages, q_start, rng):
    """(page_table, q_start) on the card: each row's live pages drawn
    without repeats from pages 1.. (never the trash page)."""
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((b, max_pages), np.int32)
    for r in range(b):
        live = min(max_pages, (q_start[r] + t - 1) // page_size + 1)
        table[r, :live] = perm[r * max_pages:r * max_pages + live]
    return (torch.from_numpy(table).to(dev),
            torch.tensor(q_start, dtype=torch.int32, device=dev))


def _bound(byts, flops, peak=FP32_FLOPS):
    """(least ms on the card, what bounds it): bytes over the HBM rate vs
    flops over the ``peak`` rate (fp32 SIMT unless given)."""
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _paged_bound(b, n, t, d, page_size, q_start):
    """Least time for one call with these q_start values: each visible
    K/V row, q, out and the live page-table entries moved once; 4·d
    flops per visible (query, key) pair."""
    keys = sum(qs + t for qs in q_start)          # K/V rows per head
    pairs = sum((qs + 1 + qs + t) * t // 2 for qs in q_start)
    live_pages = sum(-(-(qs + t) // page_size) for qs in q_start)
    byts = (keys * n * d * 4 * 2 + 2 * b * n * t * d * 4 + b * 4
            + live_pages * 4)
    return _bound(byts, pairs * n * 4 * d) + (byts,)


def _paged_one_split(quant, args, scale):
    """K5's kernel (K7's with ``quant``) in its one-split form (one CTA a
    query tile, head and row, as before the split), through the same C
    entry: the yardstick of the split form at each case.  ``args`` are
    the wrapper's positional arguments."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.primitives import paged

    lib = _build.load("paged_attention", paged._SIGNATURES)
    q, pool, table = args[0], args[1], args[-2]
    b, n, t, d = q.shape
    out = torch.empty_like(q)
    max_pages = table.shape[1]
    fn = (lib.pt_paged_attention_quant_f32 if quant
          else lib.pt_paged_attention_f32)
    err = fn(*map(_build.ptr, tuple(args) + (out,)), None, None, b, n, t, d,
             pool.shape[1], max_pages, pool.shape[0], max_pages, 1, scale,
             _build.stream_of(q.device))
    _build.check("paged attention (one split)", err)
    return out


def check_paged(dev, rng, quant=False):
    """K5 (K7 with ``quant``, over a dual-int8 pool with a poisoned trash
    page) at the decode lanes' shapes (page 16, 64 logical pages: eight
    splits of eight pages), with each case's split plan and partials
    workspace, both forms held against the plain version and timed in
    turns, one split against split."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.primitives import paged

    warps = _build.load("paged_attention", paged._SIGNATURES).pt_paged_warps()
    n, d, page_size, max_pages, num_pages = 12, 64, 16, 64, 513
    cases = [("decode", 8, 1, [0, 15, 16, 17, 500, 777, 1000, 1023])]
    cases += [(f"prefill@{qs}", 1, 32, [qs]) for qs in (0, 32, 992)]
    if quant:
        pool = _quant_pool(dev, num_pages, page_size, n, d, rng)
        fn, ref = paged.paged_attention_quant, \
            paged.paged_attention_quant_reference
        bound, plain_iters, label = _paged_quant_bound, 10, \
            "paged_attention_quant"
    else:
        fn, ref = paged.paged_attention, paged.paged_attention_reference
        bound, plain_iters, label = _paged_bound, 20, "paged_attention"
    worst, timings = 0.0, {}
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)  # 256 MB > 50 MB L2
    scale = d ** -0.5
    for name, b, t, q_start in cases:
        if quant:
            q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32)
                                 ).to(dev)
            args = (q, *pool, *_page_table(dev, b, t, page_size, max_pages,
                                           num_pages, q_start, rng))
        else:
            args = _paged_inputs(dev, b, n, t, d, page_size, max_pages,
                                 num_pages, q_start, rng)
        got = fn(*args, sm_scale=scale)
        one = _paged_one_split(quant, args, scale)
        want = ref(*args, sm_scale=scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        one_err = (one - want).abs().max().item()
        for form, out in (("", got), (" (one split)", one)):
            if not torch.allclose(out, want, **K5_TOL) \
                    or not torch.isfinite(out).all():
                raise AssertionError(
                    f"{label}{form} {name}: max abs err "
                    f"{(out - want).abs().max().item()} outside {K5_TOL}")
        worst = max(worst, err, one_err)
        flush = flush_buf.zero_

        def one_split():
            return _paged_one_split(quant, args, scale)

        def split():
            return fn(*args, sm_scale=scale)

        # in turns: one split, split, split, one split
        in_turns = [_time_ms(f, 50, flush)
                    for f in (one_split, split, split, one_split)]
        plain_ms = _time_ms(lambda: ref(*args, sm_scale=scale), plain_iters,
                            flush)
        bound_ms, bound_by, byts = bound(b, n, t, d, page_size, q_start)
        plan = paged.split_plan(b, n, t, d, max_pages, page_size, warps)
        timings[name] = dict(ms=(in_turns[1] + in_turns[2]) / 2,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=byts,
                             max_abs_err=err, one_split_max_abs_err=one_err,
                             q_start=q_start,
                             one_split_ms=(in_turns[0] + in_turns[3]) / 2,
                             in_turns_ms=in_turns,
                             pages_per_split=plan.pages_per_split,
                             splits=plan.splits,
                             workspace=plan.workspace,
                             workspace_bytes=4 * int(np.prod(
                                 plan.workspace or (0,))),
                             library_ms=None)
    del flush_buf
    return worst, timings


def _quant_pool(dev, num_pages, page_size, n, d, rng):
    """A dual-int8 pool (hi, lo, scale for K and V) quantized from random
    fp32 by the port's codec; the trash page's scales poisoned, so
    attending it would show."""
    from paddle_tpu_torch.kernels.primitives import int8

    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.randn(num_pages, page_size, n, d)
                             .astype(np.float32)).to(dev)
        hi, lo, sc = int8.quantize_lastdim(x)
        sc[0] = 1e4
        out += [hi, lo, sc]
    return out


def _paged_quant_bound(b, n, t, d, page_size, q_start):
    """Least time for one K7 call: as K5's, with each visible K/V row
    read as 2 bytes a code (hi + lo) and a 4-byte scale."""
    keys = sum(qs + t for qs in q_start)
    pairs = sum((qs + 1 + qs + t) * t // 2 for qs in q_start)
    live_pages = sum(-(-(qs + t) // page_size) for qs in q_start)
    byts = (keys * n * (2 * d + 4) * 2 + 2 * b * n * t * d * 4 + b * 4
            + live_pages * 4)
    return _bound(byts, pairs * n * 4 * d) + (byts,)


def _ragged_bound(h, s, d, lengths, causal):
    """Least time for one K6 call: q and o of every row, and K/V rows
    below each row's length, moved once; 4·d flops per live (query, key)
    pair — j < length (and j <= i when causal) — at the fp32 rate
    without tensor cores (exact fp32 products)."""
    pairs, kv_rows = 0, 0
    for ln in lengths:
        n_keys = min(max(ln, 0), s)
        kv_rows += n_keys
        pairs += (sum(min(i + 1, n_keys) for i in range(s)) if causal
                  else s * n_keys)
    byts = (2 * len(lengths) * h * s * d + 2 * h * kv_rows * d) * 4 \
        + 4 * len(lengths)
    return _bound(byts, h * pairs * 4 * d) + (byts,)


def _sdpa_ragged_ms(q, k, v, lengths, causal, scale):
    """The library yardstick: scaled_dot_product_attention with the same
    boolean key mask (a length-0 row gives NaN there; timing only)."""
    import torch.nn.functional as F

    s = q.shape[2]
    j = torch.arange(s, device=q.device)
    mask = j.view(1, 1, 1, s) < lengths.view(-1, 1, 1, 1)
    if causal:
        mask = mask & (j.view(1, 1, 1, s) <= j.view(1, 1, s, 1))
    return _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), 50)


def check_ragged(dev, rng):
    """K6 at the ragged Engine path's shapes: q/k/v [8, 8, S, 32] fp32
    transposed views of [8, S, 8, 32], S = 128 with the wave's lengths
    (timed) and with a row of length 0, the bucketed arm's S = 32 and 64
    whose padding rows carry length 0; and S = 200, D = 64, causal on
    and off."""
    from paddle_tpu_torch.kernels.primitives import ragged

    wave = [20, 20, 50, 50, 90, 90, 126, 126]
    cases = [("path", 8, 8, 128, 32, True, wave),
             ("len0", 8, 8, 128, 32, True, [20, 50, 90, 126, 0, 126, 3, 128]),
             ("bucket32", 8, 8, 32, 32, True, [20, 20, 0, 0, 0, 0, 0, 0]),
             ("bucket64", 8, 8, 64, 32, True, [50, 50, 0, 0, 0, 0, 0, 0]),
             ("s200_causal", 4, 4, 200, 64, True, [200, 150, 7, 0]),
             ("s200", 4, 4, 200, 64, False, [200, 150, 7, 0])]
    worst, timings = 0.0, {}
    for name, b, h, s, d, causal, lens in cases:
        q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   .to(dev).transpose(1, 2) for _ in range(3))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        got = ragged.ragged_attention(q, k, v, lengths, causal, scale)
        want = ragged.ragged_attention(q, k, v, lengths, causal, scale,
                                       force="reference")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, **FLASH_TOL[torch.float32]) \
                or not torch.isfinite(got).all() \
                or got.stride() != q.stride():
            raise AssertionError(f"ragged_attention {name}: max abs err "
                                 f"{err} outside {FLASH_TOL[torch.float32]}")
        worst = max(worst, err)
        if name not in ("path", "bucket32", "bucket64"):
            continue
        bound_ms, bound_by, byts = _ragged_bound(h, s, d, lens, causal)
        timings[name] = dict(
            ms=_time_ms(lambda: ragged.ragged_attention(
                q, k, v, lengths, causal, scale), 50),
            plain_ms=_time_ms(lambda: ragged.ragged_attention(
                q, k, v, lengths, causal, scale, force="reference"), 20),
            bound_ms=bound_ms, bound_by=bound_by, bytes=byts,
            library_ms=_sdpa_ragged_ms(q, k, v, lengths, causal, scale),
            max_abs_err=err, shape=[b, h, s, d], lengths=lens)
    return worst, timings


# (name, b, h, s, d, dtype, causal, strided, lengths): the contract the
# redesigned K6 takes beyond the serving path's shape: D 96 and 128,
# bf16 at D 32 and 64, causal and not, transposed views, a length 0 and
# one past S, S 1, and a row of length 1000 at S 1024 (32 key tiles)
RAGGED_CONTRACT_CASES = (
    ("d96", 2, 3, 150, 96, torch.float32, True, True, [150, 0]),
    ("d128", 2, 3, 150, 128, torch.float32, False, True, [97, 300]),
    ("d128_causal", 2, 2, 64, 128, torch.float32, True, False, [64, 31]),
    ("bf16_d32", 8, 8, 128, 32, torch.bfloat16, True, True,
     [20, 20, 50, 50, 90, 90, 126, 0]),
    ("bf16_d64", 2, 3, 200, 64, torch.bfloat16, False, True, [200, 77]),
    ("bf16_d64_causal", 2, 3, 200, 64, torch.bfloat16, True, False,
     [0, 500]),
    ("s1", 3, 2, 1, 32, torch.float32, True, True, [1, 0, 5]),
    ("s1024", 1, 2, 1024, 64, torch.float32, True, True, [1000]),
)


def check_ragged_contract(dev, rng):
    """K6 at RAGGED_CONTRACT_CASES against its plain version (FLASH_TOL
    of the dtype; the plain version computes in fp32 and rounds once to
    q's dtype); the output keeps q's dtype and layout."""
    from paddle_tpu_torch.kernels.primitives import ragged

    worst = {}
    for name, b, h, s, d, dtype, causal, strided, lens in \
            RAGGED_CONTRACT_CASES:
        q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                   .to(dev, dtype).transpose(1, 2) for _ in range(3))
        if not strided:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = ragged.ragged_attention(q, k, v, lengths, causal)
        want = ragged.ragged_attention(q, k, v, lengths, causal,
                                       force="reference")
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = FLASH_TOL[dtype]
        if got.dtype != dtype or got.stride() != q.stride() \
                or not torch.isfinite(got).all() \
                or not torch.allclose(got.float(), want.float(), **tol):
            raise AssertionError(f"ragged_attention {name}: max abs err "
                                 f"{err} outside {tol} (dtype {got.dtype}, "
                                 f"strides {got.stride()})")
        worst[name] = err
    return max(worst.values()), worst


def _bias_gelu_bound(r, h, with_mask):
    byts = r * h * 4 * 2 + h * 4 + (r * h if with_mask else 0)
    return _bound(byts, r * h * GELU_FLOPS_PER_ELEMENT) + (byts,)


def check_bias_gelu(dev, rng):
    """K4 in fp32 at the decode path's rows [8, 32, 37] x 3072, and at the
    fp32 train step's two shapes, the 12 FFN fc_0 outputs [b*s, 3072]
    and the MLM head [b*s/8, 768] (their inputs from a generator of
    their own, so the later checks' data stays as it was)."""
    from paddle_tpu_torch.kernels import fused_bias_act as fba

    worst, timings = 0.0, {}
    path_rng = np.random.RandomState(SEED + 1)
    for r, h in ((8, 3072), (32, 3072), (37, 3072), (16384, 3072),
                 (2048, 768)):
        src = rng if r < 64 else path_rng
        x = torch.from_numpy(src.randn(r, h).astype(np.float32) * 3).to(dev)
        bias = torch.from_numpy(src.randn(h).astype(np.float32)).to(dev)
        mask = torch.from_numpy((src.rand(r, h) > 0.1).astype(np.uint8)).to(dev)
        for with_mask in (False, True):
            for approx in (False, True):
                kw = dict(mask=mask if with_mask else None,
                          scale=1 / 0.9 if with_mask else 1.0,
                          approximate=approx)
                got = fba.fused_bias_gelu(x, bias, **kw)
                want = fba.fused_bias_gelu_reference(x, bias, **kw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not torch.allclose(got, want, **K4_TOL):
                    raise AssertionError(
                        f"fused_bias_gelu [{r},{h}] mask={with_mask} "
                        f"approximate={approx}: max abs err {err} outside "
                        f"{K4_TOL}")
                worst = max(worst, err)
                if not approx:
                    ms = _time_ms(lambda: fba.fused_bias_gelu(x, bias, **kw),
                                  100)
                    plain_ms = _time_ms(
                        lambda: fba.fused_bias_gelu_reference(x, bias, **kw),
                        30)
                    bound_ms, bound_by, byts = _bias_gelu_bound(
                        r, h, with_mask)
                    timings[f"[{r},{h}] mask={with_mask}"] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, bytes=byts, max_abs_err=err,
                        shape=[r, h], dtype="float32")
    return worst, timings


def check_bias_gelu_bf16(dev, rng):
    """K4 on bf16 input at the training path's two shapes, the 12 FFN
    fc_0 outputs [b*s, 3072] and the MLM head [b*s/8, 768], the FFN's
    at a dp replica's shard [b*s/4, 3072], and GPT-2 small's FFN at b8
    s1024 [8192, 3072]."""
    from paddle_tpu_torch.kernels import fused_bias_act as fba

    worst, timings = 0.0, {}
    for r, h in ((16384, 3072), (2048, 768), (4096, 3072), (8192, 3072)):
        x = torch.from_numpy(rng.randn(r, h).astype(np.float32) * 3).to(
            dev, torch.bfloat16)
        bias = torch.from_numpy(rng.randn(h).astype(np.float32)).to(
            dev, torch.bfloat16)
        got = fba.fused_bias_gelu(x, bias)
        want = fba.fused_bias_gelu_reference(x, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != torch.bfloat16 \
                or not torch.allclose(got.float(), want.float(),
                                      **K4_BF16_TOL):
            raise AssertionError(f"fused_bias_gelu bf16 [{r},{h}]: max abs "
                                 f"err {err} outside {K4_BF16_TOL}")
        worst = max(worst, err)
        ms = _time_ms(lambda: fba.fused_bias_gelu(x, bias), 50)
        plain_ms = _time_ms(lambda: fba.fused_bias_gelu_reference(x, bias),
                            20)
        # what the card reaches moving the same bytes: PyTorch's device
        # copy of x into a tensor of its shape (a yardstick, not the
        # function)
        dst = torch.empty_like(x)
        copy_ms = _time_ms(lambda: dst.copy_(x), 50)
        byts = r * h * 2 * 2 + h * 2
        bound_ms, bound_by = _bound(byts, r * h * GELU_FLOPS_PER_ELEMENT)
        timings[f"[{r},{h}] bf16"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=byts, max_abs_err=err, copy_ms=copy_ms)
    return worst, timings


# the AMP step's fp16 K4 shapes (phase 32's arm (b)): the 12 FFN fc_0
# outputs [b*s, 3072] and the MLM head [b*s/8, 768], fp16 x and the
# fp32 bias the AMP rewrite leaves it
K4_FP16_CASES = ((16384, 3072), (2048, 768))


def _fp16_ulp(t):
    """One fp16 ulp at each value of ``t`` (fp32): 2^(e - 11) for a
    value in [2^(e-1), 2^e), 2^-24 below the smallest normal."""
    _, e = torch.frexp(t.abs())
    return torch.where(t.abs() < 2.0 ** -14, 2.0 ** -24,
                       torch.pow(2.0, (e - 11).float()))


def _fp16_k4_close(got, want):
    """Max |got - want| in ulps of ``want`` (fp16 results), every inf of
    either in the same place and of the same sign in both."""
    g, w = got.float(), want.float()
    inf = torch.isinf(w)
    if not torch.equal(torch.isinf(g), inf) or not torch.equal(g[inf],
                                                               w[inf]):
        raise AssertionError("fused_bias_gelu fp16: the infs differ from "
                             "the plain version's")
    if torch.isnan(g).any():
        raise AssertionError("fused_bias_gelu fp16: NaN in the result")
    return float(((g - w).abs()[~inf] / _fp16_ulp(w[~inf])).max())


def check_bias_gelu_fp16(dev, rng):
    """K4's fp16 form (phase 32's arm (b)) at K4_FP16_CASES, with and
    without a dropout mask: fp16 x, fp32 bias, a result within one fp16
    ulp of the plain version (both round an fp32 GeLU to nearest-even),
    its infs where the plain version's are.  The first rows sit at fp16's
    edge: x 65504 or 65472 with a bias that puts x + bias just under,
    at and past 65519.99 (the last value that rounds to 65504), so the
    result is 65504 or +inf, and the mask's 1.25 scale pushes more past
    it.  The bias also in bf16 and fp16 at the MLM head's shape
    (untimed).  Timed: the kernel, the plain version, a device copy of
    x (the same bytes moved), against the bytes bound.  Inputs from a
    device generator of their own, so the later checks' data stays as
    it was."""
    from paddle_tpu_torch.kernels import fused_bias_act as fba

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    worst, timings = 0.0, {}
    for r, h in K4_FP16_CASES:
        x = (torch.randn(r, h, generator=gen, device=dev) * 3).half()
        bias = torch.randn(h, generator=gen, device=dev)
        x[:4, :8] = torch.tensor([65504, 65504, 65504, 65504, 65472, 60000,
                                  -65504, -60000], device=dev).half()
        bias[:8] = torch.tensor([15.0, 15.99, 16.0, 200.0, 47.0, 5519.0,
                                 -16.0, 1.0], device=dev)
        mask = (torch.rand(r, h, generator=gen, device=dev) > 0.1).to(
            torch.uint8)
        for with_mask in (False, True):
            kw = dict(mask=mask if with_mask else None,
                      scale=1.25 if with_mask else 1.0)
            got = fba.fused_bias_gelu(x, bias, **kw)
            want = fba.fused_bias_gelu_reference(x, bias, **kw)
            torch.cuda.synchronize()
            if got.dtype != torch.float16:
                raise AssertionError(f"fused_bias_gelu fp16: {got.dtype}")
            ulps = _fp16_k4_close(got, want)
            n_inf = int(torch.isinf(got).sum())
            if ulps > 1.0 or n_inf < 3:
                raise AssertionError(f"fused_bias_gelu fp16 [{r},{h}] "
                                     f"mask={with_mask}: {ulps} ulp from "
                                     f"the plain version, {n_inf} infs")
            err = float((got.float() - want.float())[
                torch.isfinite(want)].abs().max())
            worst = max(worst, err)
            ms = _time_ms(lambda: fba.fused_bias_gelu(x, bias, **kw), 50)
            plain_ms = _time_ms(
                lambda: fba.fused_bias_gelu_reference(x, bias, **kw), 20)
            dst = torch.empty_like(x)
            copy_ms = _time_ms(lambda: dst.copy_(x), 50)
            byts = r * h * 2 * 2 + h * 4 + (r * h if with_mask else 0)
            bound_ms, bound_by = _bound(byts, r * h * GELU_FLOPS_PER_ELEMENT)
            timings[f"[{r},{h}] fp16 mask={with_mask}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=byts, max_abs_err=err,
                max_ulps=ulps, infs=n_inf, copy_ms=copy_ms, shape=[r, h],
                dtype="float16", bias_dtype="float32", library_ms=None)
        for bdt in (torch.bfloat16, torch.float16):
            if r != 2048:
                continue
            b2 = bias.to(bdt)
            got = fba.fused_bias_gelu(x, b2)
            ulps = _fp16_k4_close(got, fba.fused_bias_gelu_reference(x, b2))
            if ulps > 1.0:
                raise AssertionError(f"fused_bias_gelu fp16, {bdt} bias: "
                                     f"{ulps} ulp")
            timings[f"[{r},{h}] fp16 bias {bdt}"] = dict(max_ulps=ulps)
    return worst, timings


def _flash_inputs(dev, b, h, s, d, dtype, rng, bias_mode="pads"):
    """q, k, v, dO as the BERT and GPT programs hand them to the op:
    [B, H, S, D] transposed views of [B, S, H, D] activations; a key
    bias [B*H, S] with -1e4 pads on a quarter of the rows' tails
    ("pads"), or with every key of batch 1's heads at -1e30 on top
    ("masked": fully masked rows), or zero (GPT's op has no bias, and
    the op hands the kernels zero rows), or the NMT encoder's ("nmt"):
    each sentence's keys past a length uniform in [1, S] at -1e9 as
    ``dtype`` holds it (bf16, under the bf16 policy: -999817216), the
    value the op widens to fp32."""
    def t():
        a = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
        return a.to(dev, dtype).transpose(1, 2)

    q, k, v, do = t(), t(), t(), t()
    bias = np.zeros((b, s), np.float32)
    if bias_mode == "nmt":
        pad = torch.tensor(-1e9).to(dtype).item()
        for i, ln in enumerate(rng.randint(1, s + 1, b)):
            bias[i, ln:] = pad
    elif bias_mode != "zero":
        bias[::4, s - s // 4:] = -1e4
    if bias_mode == "masked":
        bias[1] = -1e30
    rows = torch.from_numpy(np.repeat(bias, h, axis=0)).to(dev)
    return q, k, v, do, rows


def _flash_bounds(bh, s, d, dtype, causal, simt=False):
    """(ms, bound_by) of K1, K2, K3: each operand read once and each
    output written once at HBM rate vs the products' flops (2 per
    multiply-add over the live (query, key) pairs).  bf16 at the bf16
    tensor-core rate.  fp32 at the card's rate for fp32-accurate
    products, whatever implements them: three TF32 products each (split
    TF32, as K1-K3 take them) at the TF32 tensor-core rate.  ``simt``:
    the fp32 products once each at the fp32 SIMT rate instead, the best
    the SIMT kernels the split-TF32 ones replaced could reach."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    elem = 2 if dtype == torch.bfloat16 else 4
    mat = elem * bh * s * d      # one [BH, S, D] operand
    row = 4 * bh * s             # one fp32 [BH, S] row vector
    if dtype == torch.bfloat16:
        per_product, peak = 1, BF16_TC_FLOPS
    elif simt:
        per_product, peak = 1, FP32_FLOPS
    else:
        per_product, peak = 3, TF32_TC_FLOPS
    ops = 2 * pairs * d * per_product   # one [S, S] x [S, D] product
    k1 = _bound(3 * mat + row + mat + row, 2 * ops, peak)
    k2 = _bound(4 * mat + 3 * row + mat, 3 * ops, peak)
    k3 = _bound(4 * mat + 3 * row + 2 * mat + row, 4 * ops, peak)
    return k1, k2, k3


def bf16_dkv_over_bound(name, bargs, dk, dv):
    """bf16 K3's dK and dV against the exact answer, within the rounding
    bound of its arithmetic (FLASH_TOL's comment): the largest error
    over its bound; raises above 1 or on a non-finite value."""
    from paddle_tpu_torch.kernels.primitives import flash

    truth = flash.flash_bwd_dkv_truth(*bargs)
    bound = flash.flash_bwd_dkv_bf16_bound(*bargs)
    worst = 0.0
    for what, got, t_, b_ in zip(("dK", "dV"), (dk, dv), truth, bound):
        ratio = over_bound((got.float() - t_).abs(), b_).max().item()
        if not ratio <= 1.0 or not torch.isfinite(got).all():
            raise AssertionError(
                f"flash_bwd_dkv {name}: {what} off the exact answer by "
                f"{ratio} x its bf16 rounding bound")
        worst = max(worst, ratio)
    return worst


def over_bound(err, bound):
    """err / bound elementwise, 0 where err is 0 (a pad key: 0 / 0), inf
    where only the bound is 0."""
    return torch.where(err == 0, torch.zeros_like(err), err / bound)


def _sdpa_ms(q, k, v, do, rows, scale, causal=False):
    """The library yardstick: scaled_dot_product_attention with the same
    float key mask (causal: ``is_causal=True`` and no mask, the same
    function over zero bias rows), forward, and its backward (dQ, dK, dV
    together)."""
    import torch.nn.functional as F

    b, h, s, _ = q.shape
    kw = dict(scale=scale)
    if causal:
        kw["is_causal"] = True
    else:
        kw["attn_mask"] = rows.reshape(b, h, 1, s).to(q.dtype)
    fwd = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw),
                   20)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    bwd = _time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                               retain_graph=True), 20)
    return fwd, bwd


# (name, b, h, s, d, dtype, causal, bias mode (_flash_inputs), timed):
# the BERT path's shape, a dp replica's shard, GPT-2 small's causal
# b8 s1024, the attention of one GPT-3 6.7B layer (b1 s2048, 32 heads,
# d_head 128; Brown et al. 2020, Table 2.1), the fp32 kernels at the
# predictor's b8 s128 12 heads with D 128, at the fp32 train step's
# shape (the BERT path's, without the bf16 policy) and at GPT-2 small's
# causal b8 s1024 (all timed), then the edges of the tensor-core K1-K3
# in both dtypes (a ragged last tile, causal, four key tiles a causal
# row, D < 64, rows that are not 16-byte multiples, one token, rows
# whose keys are all masked) and both dtypes at D 80, 96 and 128 (a
# head-dim capacity of 128 columns)
FLASH_CASES = (
    ("path", 128, 12, 128, 64, torch.bfloat16, False, "pads", True),
    ("dp_shard", 32, 12, 128, 64, torch.bfloat16, False, "pads", True),
    ("gpt", 8, 12, 1024, 64, torch.bfloat16, True, "zero", True),
    ("gpt3_6p7b", 1, 32, 2048, 128, torch.bfloat16, True, "zero", True),
    ("fp32_d128", 8, 12, 128, 128, torch.float32, False, "pads", True),
    ("fp32_path", 128, 12, 128, 64, torch.float32, False, "pads", True),
    ("fp32_gpt", 8, 12, 1024, 64, torch.float32, True, "zero", True),
    ("bf16_ragged", 4, 12, 200, 64, torch.bfloat16, False, "pads", False),
    ("bf16_ragged_causal", 4, 12, 200, 64, torch.bfloat16, True, "pads",
     False),
    ("bf16_s256_causal", 4, 12, 256, 64, torch.bfloat16, True, "pads",
     False),
    ("bf16_d32", 4, 12, 96, 32, torch.bfloat16, False, "pads", False),
    ("bf16_d12_causal", 4, 12, 77, 12, torch.bfloat16, True, "pads",
     False),
    ("bf16_s1", 4, 12, 1, 64, torch.bfloat16, False, "pads", False),
    ("bf16_masked_rows", 4, 12, 128, 64, torch.bfloat16, False, "masked",
     False),
    ("ragged", 4, 12, 200, 64, torch.float32, False, "pads", False),
    ("ragged_causal", 4, 12, 200, 64, torch.float32, True, "pads", False),
    ("masked_rows", 4, 12, 128, 64, torch.float32, False, "masked", False),
    ("d12_causal", 4, 12, 77, 12, torch.float32, True, "pads", False),
    ("s1", 4, 12, 1, 64, torch.float32, False, "pads", False),
    ("bf16_d80_ragged_causal", 4, 12, 200, 80, torch.bfloat16, True,
     "pads", False),
    ("bf16_d96_ragged", 4, 12, 200, 96, torch.bfloat16, False, "pads",
     False),
    ("bf16_d128_ragged_causal", 4, 12, 200, 128, torch.bfloat16, True,
     "pads", False),
    ("bf16_d128_masked_rows", 4, 12, 128, 128, torch.bfloat16, False,
     "masked", False),
    ("d80_ragged_causal", 4, 12, 200, 80, torch.float32, True, "pads",
     False),
    ("d96_ragged", 4, 12, 200, 96, torch.float32, False, "pads", False),
    ("d128_ragged_causal", 4, 12, 200, 128, torch.float32, True, "pads",
     False),
    ("d128_masked_rows", 4, 12, 128, 128, torch.float32, False, "masked",
     False),
)


def check_flash(dev, rng, cases=FLASH_CASES):
    """K1, K2, K3 against their plain versions at ``cases``; bf16 ones
    run on the tensor cores, fp32 ones on the tensor cores in split
    TF32.  Timed at the BERT path's shape (BH = 1536, S = 128, D = 64,
    bf16), at a dp replica's shard (BH = 384), at GPT-2 small's (BH = 96,
    S = 1024, causal) and GPT-3 6.7B's (BH = 32, S = 2048, D = 128,
    causal; SDPA with ``is_causal`` beside both), and in fp32 at
    [96, 128, 128], at the fp32 train step's [1536, 128, 64] and at
    GPT-2 small's causal [96, 1024, 64]."""
    from paddle_tpu_torch.kernels.primitives import flash

    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    by_dtype, by_case = {}, {}
    timings = {}
    for name, b, h, s, d, dtype, causal, bias_mode, timed in cases:
        q, k, v, do, rows = _flash_inputs(dev, b, h, s, d, dtype, rng,
                                          bias_mode)
        scale = d ** -0.5
        o, lse = flash.flash_fwd(q, k, v, rows, causal, scale)
        o_ref, lse_ref = flash.flash_fwd(q, k, v, rows, causal, scale,
                                         force="reference")
        lse_rows = lse_ref.reshape(b * h, s)
        delta = (do.float() * o_ref.float()).sum(-1).reshape(b * h, s)
        bargs = (q, k, v, rows, do, lse_rows, delta, causal, scale)
        dq = flash.flash_bwd_dq(*bargs)
        dk, dv, db = flash.flash_bwd_dkv(*bargs)
        dq_ref = flash.flash_bwd_dq(*bargs, force="reference")
        dk_ref, dv_ref, db_ref = flash.flash_bwd_dkv(*bargs,
                                                     force="reference")
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        errs = by_dtype.setdefault(str(dtype).split(".")[-1], {})
        case_errs = by_case.setdefault(name, {})
        for kern, got, want, t in (
                ("flash_fwd", o, o_ref, tol),
                ("flash_fwd", lse, lse_ref, FLASH_TOL[torch.float32]),
                ("flash_bwd_dq", dq, dq_ref, tol),
                ("flash_bwd_dkv", dk, dk_ref,
                 None if dtype == torch.bfloat16 else tol),
                ("flash_bwd_dkv", dv, dv_ref,
                 None if dtype == torch.bfloat16 else tol),
                ("flash_bwd_dkv", db, db_ref, FLASH_DBIAS_TOL)):
            err = (got.float() - want.float()).abs().max().item()
            if t is not None and (
                    not torch.allclose(got.float(), want.float(), **t)
                    or not torch.isfinite(got).all()):
                raise AssertionError(f"{kern} {name}: max abs err {err} "
                                     f"outside {t}")
            worst[kern] = max(worst[kern], err)
            errs[kern] = max(errs.get(kern, 0.0), err)
            case_errs[kern] = max(case_errs.get(kern, 0.0), err)
        if dtype == torch.bfloat16:  # K3's dK, dV against the exact answer
            ratio = bf16_dkv_over_bound(name, bargs, dk, dv)
            case_errs["flash_bwd_dkv_over_bound"] = ratio
            errs["flash_bwd_dkv_over_bound"] = max(
                errs.get("flash_bwd_dkv_over_bound", 0.0), ratio)
        if bias_mode == "masked":  # uniform weights: O of batch 1 is the
            # mean of V
            mean_v = v[1].float().mean(dim=1, keepdim=True).expand_as(v[1])
            if not torch.allclose(o[1].float(), mean_v, **tol):
                raise AssertionError(f"flash_fwd {name}: fully masked rows "
                                     f"are not the mean of V")
        if not timed:
            continue
        k1, k2, k3 = _flash_bounds(b * h, s, d, dtype, causal)
        simt = (_flash_bounds(b * h, s, d, dtype, causal, simt=True)
                if dtype == torch.float32 else (None,) * 3)
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, do, rows, scale,
                                    causal=bias_mode == "zero")
        shape = {}
        for kern, fn, plain, (bound_ms, bound_by), simt_bound, lib in (
                ("flash_fwd",
                 lambda: flash.flash_fwd(q, k, v, rows, causal, scale),
                 lambda: flash.flash_fwd(q, k, v, rows, causal, scale,
                                         force="reference"), k1, simt[0],
                 lib_fwd),
                ("flash_bwd_dq", lambda: flash.flash_bwd_dq(*bargs),
                 lambda: flash.flash_bwd_dq(*bargs, force="reference"), k2,
                 simt[1], lib_bwd),
                ("flash_bwd_dkv", lambda: flash.flash_bwd_dkv(*bargs),
                 lambda: flash.flash_bwd_dkv(*bargs, force="reference"), k3,
                 simt[2], lib_bwd)):
            shape[kern] = dict(
                ms=_time_ms(fn, 30), plain_ms=_time_ms(plain, 10),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                shape=[b * h, s, d], dtype=str(dtype).split(".")[-1],
                causal=causal)
            if simt_bound is not None:
                shape[kern].update(bound_simt_ms=simt_bound[0],
                                   bound_simt_by=simt_bound[1])
        if name == "path":
            timings.update(shape)
        else:
            timings[name] = shape
    timings["max_abs_err_by_dtype"] = by_dtype
    timings["max_abs_err_by_case"] = by_case
    timings["sdpa_note"] = ("library_ms: flash_fwd against SDPA forward; "
                            "flash_bwd_dq and flash_bwd_dkv each against "
                            "SDPA's whole backward")
    return worst, timings


def check_flash_fp32_predictor(dev, rng):
    """K1 in fp32 (the split-TF32 kernel of csrc/flash_tf32.cuh) at the
    predictor path's shape, b8 s128, 12 heads, D 64 ([96, 128, 64] fp32,
    a key bias with pads): held against its plain version and the
    composed path, and timed against its bound (the bytes, or the
    products as split TF32 does them, three TF32 products each, at the
    TF32 tensor-core rate; beside it the products at the fp32 SIMT rate,
    the bound of the SIMT form it replaced), SDPA in fp32 with the same
    float mask, and the composed matmul / softmax / matmul that the
    passes-off predictor runs."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.primitives import flash

    b, h, s, d = 8, 12, 128, 64
    q, k, v, _, rows = _flash_inputs(dev, b, h, s, d, torch.float32, rng)
    scale = d ** -0.5
    mask = rows.reshape(b, h, 1, s)

    def composed():
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale
                          + mask, dim=-1)
        return torch.matmul(p, v)

    o, lse = flash.flash_fwd(q, k, v, rows, False, scale)
    o_ref, lse_ref = flash.flash_fwd(q, k, v, rows, False, scale,
                                     force="reference")
    tol = FLASH_TOL[torch.float32]
    err = 0.0
    for got, want in ((o, o_ref), (lse, lse_ref), (o, composed())):
        e = (got - want).abs().max().item()
        if not torch.allclose(got, want, **tol):
            raise AssertionError(f"flash_fwd fp32 predictor shape: max abs "
                                 f"err {e} outside {tol}")
        err = max(err, e)
    bh = b * h
    (bound_ms, bound_by), _, _ = _flash_bounds(bh, s, d, torch.float32,
                                               False)
    (simt_ms, simt_by), _, _ = _flash_bounds(bh, s, d, torch.float32, False,
                                             simt=True)
    return err, dict(
        shape=[bh, s, d], dtype="float32", bound_simt_ms=simt_ms,
        bound_simt_by=simt_by,
        ms=_time_ms(lambda: flash.flash_fwd(q, k, v, rows, False, scale),
                    30),
        plain_ms=_time_ms(lambda: flash.flash_fwd(
            q, k, v, rows, False, scale, force="reference"), 10),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), 20),
        composed_ms=_time_ms(composed, 20),
        max_abs_err=err)


K8_BLOCK = 256
# K8 kernel vs plain: the kernel spells every operation in the plain
# version's order with round-to-nearest intrinsics (no fused
# multiply-add), so the two should agree bit for bit; 1e-6 relative is
# the gate in case the card's sqrt or division rounds otherwise, and
# the requant codes must be equal
K8_RTOL = 1e-6
# (name, numel): BERT-base's word embedding (30528 x 768), an FFN weight
# (768 x 3072), a 768 bias (launch-bound), and a numel that is not a
# multiple of the block
K8_SHAPES = (("word_embedding", 30528 * 768), ("ffn_weight", 768 * 3072),
             ("bias", 768), ("ragged", 1000003))
# (kind, use_nesterov) of every K8 kind
K8_KINDS = (("adam", False), ("adamw", False), ("momentum", False),
            ("momentum", True), ("sgd", False))
# the shapes held against the plain version in every kind; the word
# embedding (23.4 M elements, whose inputs take most of the check's host
# time to draw) only in the dp lane's kind, adam, and timed
K8_EVERY_KIND = ("ffn_weight", "bias", "ragged")


def _k8_case(dev, numel, rng, offset_blocks=3):
    """Parameter state and a gradient bucket slice for one K8 call: the
    member's blocks start ``offset_blocks`` into a wire image quantized
    by the port's codec from random fp32 (zero in the member's padding),
    with two blocks after it.  The random values are drawn on the card
    (a generator seeded from ``rng``): the host's draws of the 23.4 M
    element embedding took most of the check's seconds."""
    from paddle_tpu_torch.kernels import quantized_collectives as qc

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.randint(2 ** 31)))

    def randn(n, scale):
        return torch.randn(n, generator=gen, device=dev) * scale

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    nb = -(-numel // K8_BLOCK)
    bucket = randn((offset_blocks + nb + 2) * K8_BLOCK, 1.0)
    # the member's alignment padding is zero, as coalesce_tensor pads it
    bucket[offset_blocks * K8_BLOCK + numel:(offset_blocks + nb) * K8_BLOCK] = 0
    hi, lo, sc = qc.quantize_block_scaled(bucket, K8_BLOCK)
    state = dict(p=randn(numel, 0.1), m1=randn(numel, 0.01),
                 m2=randn(numel, 0.01).abs(),
                 lr=f32([1e-3]), b1p=f32([0.9 ** 3]), b2p=f32([0.999 ** 3]))
    return state, (hi, lo, sc, offset_blocks, numel)


def _k8_call(kind, nesterov, s, grad, requant, force=None):
    """One fused update through the public entry; returns every tensor
    it wrote (the state is updated in place)."""
    from paddle_tpu_torch.kernels import fused_update as fu

    pad = K8_BLOCK if requant else None
    kw = dict(block_size=K8_BLOCK, requant_pad=pad, force=force)
    if kind in ("adam", "adamw"):
        fn = fu.fused_adam_update if kind == "adam" else fu.fused_adamw_update
        out = fn(s["p"], grad, s["m1"], s["m2"], s["lr"], s["b1p"],
                 s["b2p"], **kw)
    elif kind == "momentum":
        out = fu.fused_momentum_update(s["p"], grad, s["m1"], s["lr"],
                                       use_nesterov=nesterov, **kw)
    else:
        out = fu.fused_sgd_update(s["p"], grad, s["lr"], **kw)
    return out if isinstance(out, tuple) else (out,)


def _k8_bytes(kind, numel):
    """Bytes one K8 call must move: p (and each moment) read and
    written, hi and lo read, one scale a block, lr and the powers."""
    state = {"adam": 3, "adamw": 3, "momentum": 2, "sgd": 1}[kind]
    return numel * (8 * state + 2) + 4 * -(-numel // K8_BLOCK) + 12


def check_fused_update(dev, rng):
    """K8 against its plain version in the fp32 and the requant form, in
    every kind at K8_EVERY_KIND's shapes and in adam at the others; the
    adam form timed at each of K8_SHAPES."""
    from paddle_tpu_torch.kernels import fused_update as fu

    worst, timings = 0.0, {}
    for name, numel in K8_SHAPES:
        kinds = K8_KINDS if name in K8_EVERY_KIND else K8_KINDS[:1]
        for kind, nesterov in kinds:
            for requant in (False, True):
                state, grad = _k8_case(dev, numel, rng)
                ref = {k: v.clone() for k, v in state.items()}
                got = _k8_call(kind, nesterov, state, grad, requant)
                want = _k8_call(kind, nesterov, ref, grad, requant,
                                force="reference")
                torch.cuda.synchronize()
                label = (f"{kind}{'-nesterov' if nesterov else ''} {name} "
                         f"requant={requant}")
                # the requant form writes p as the payload's dequantized
                # image on the kernel's path: its codes and scales are
                # what to compare
                for g, w in list(zip(got, want))[1 if requant else 0:]:
                    if g.dtype == torch.int8:
                        bad = int((g != w).sum())
                        if bad:
                            raise AssertionError(f"fused_update {label}: "
                                                 f"{bad} codes differ")
                        continue
                    err = (g - w).abs().max().item()
                    if not torch.allclose(g, w, rtol=K8_RTOL,
                                          atol=K8_RTOL * w.abs().max()) \
                            or not torch.isfinite(g).all():
                        raise AssertionError(f"fused_update {label}: max abs "
                                             f"err {err}")
                    worst = max(worst, err)
        state, grad = _k8_case(dev, numel, rng)
        s = state
        ms = _time_ms(lambda: fu.fused_update_kernel(
            "adam", s["p"], grad, s["m1"], s["m2"], s["lr"], s["b1p"],
            s["b2p"], fu._consts("adam"), K8_BLOCK),
            50 if numel > 1e6 else 200)
        # the plain version launches some 30 kernels a call: few calls at
        # the large shapes, so the host finishes enqueueing within the
        # device sleep
        plain_ms = _time_ms(lambda: _k8_call("adam", False, s, grad, False,
                                             force="reference"),
                            3 if numel > 1e6 else 20)
        byts = _k8_bytes("adam", numel)
        bound_ms, bound_by = _bound(byts, 0)
        timings[name] = dict(numel=numel, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bytes=byts, library_ms=None)
    return worst, timings


def _dp_group_members(dev):
    """The data-parallel lane's K8 segments: phase 12's BERT-base program
    transpiled for DP_REPLICAS replicas, its plan's one group step (every
    fused_adam_quant_grad op, in order), and for each member on each
    replica (replica-major, as the executor hands them over) seeded fp32
    state and its bucket's wire image, quantized by the port's codec
    from seeded data of the bucket's padded size.  Returns (members,
    hyper, block size, ops a replica)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.data_parallel import DataParallelRunner

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    main, _, loss = _bert_program(cfg, bf16=True)
    strategy = fluid.BuildStrategy()
    strategy.quant_allreduce = True
    prog = DataParallelRunner(main, loss.name, build_strategy=strategy,
                              places=[_gpu_place()] * DP_REPLICAS).program
    members, hyper, bs, groups = _plan_group_members(
        dev, prog, list(bert.make_fake_batch(cfg, 1, 8)), loss.name)
    (n_ops,) = groups
    return members, hyper, bs, n_ops


def _plan_group_members(dev, prog, feed_names, loss_name):
    """The K8 group members of a transpiled data-parallel program: each
    group step of its plan (one kind), and for each member on each of
    DP_REPLICAS replicas (replica-major within a group step, as the
    executor hands them over) seeded fp32 state and its bucket's wire
    image.  Returns (members, hyper, block size, ops of each group step
    a replica)."""
    from paddle_tpu_torch.fluid import executor as ex
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.kernels import quantized_collectives as qc

    plan = ex._Plan(prog, feed_names, [loss_name])
    group_steps = [g for g in plan.steps if isinstance(g, ex._Group)]
    attrs = group_steps[0].ops[0].attrs
    bs = int(attrs["block_size"])
    momentum = group_steps[0].ops[0].type == "fused_momentum_quant_grad"
    hyper = (dict(mu=attrs["mu"], use_nesterov=attrs["use_nesterov"])
             if momentum else dict(beta1=attrs["beta1"],
                                   beta2=attrs["beta2"],
                                   epsilon=attrs["epsilon"]))
    block = prog.global_block()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def randn(n, scale):
        return torch.randn(n, generator=gen, device=dev) * scale

    members = []
    for group in group_steps:
        for _ in range(DP_REPLICAS):
            images = {}
            lr = torch.tensor([1e-4], device=dev)
            for op in group.ops:
                name = op.inputs["QHi"][0]
                if name not in images:
                    images[name] = qc.quantize_block_scaled(
                        randn(block.var(name).shape[0], 1e-3), bs)
                hi, lo, sc = images[name]
                numel = int(op.attrs["numel"])
                grad = (hi, lo, sc, int(op.attrs["offset_blocks"]), numel)
                if momentum:
                    members.append(fu.GroupMember(
                        randn(numel, 0.02), grad, lr, randn(numel, 1e-4)))
                else:
                    members.append(fu.GroupMember(
                        randn(numel, 0.02), grad, lr, randn(numel, 1e-4),
                        randn(numel, 1e-4).abs(),
                        torch.tensor([0.9 ** 3], device=dev),
                        torch.tensor([0.999 ** 3], device=dev)))
    return members, hyper, bs, [len(g.ops) for g in group_steps]


def _group_launches(kind, members, hyper, bs):
    """A call making launch_group's launches over ``members`` from launch
    tables built once: launch_group builds and checks them on the host
    at each call (~13 ms over 824 members), which outlasts _time_ms's
    device sleep over 20 calls; the card's work is the same.  These
    launches are not counted."""
    import ctypes

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_update as fu

    rows, dual = fu._group_rows(kind, members, bs)
    lib = _build.load("fused_update", fu._SIGNATURES)
    cap = lib.pt_fused_update_group_capacity()
    consts = fu._consts(kind, **hyper)
    stream = _build.stream_of(members[0].p.device)
    tables = [np.ascontiguousarray(rows[i:i + cap])
              for i in range(0, len(rows), cap)]

    def launch():
        for table in tables:
            _build.check("fused_update_group", lib.pt_fused_update_group(
                fu._KIND[kind], int(dual), bs, len(table),
                table.ctypes.data_as(ctypes.c_void_p), *consts, stream))

    return launch


def check_fused_update_group(dev):
    """K8's group form over the dp lane's real segment list (206
    parameters x 4 replicas): held against the plain version member by
    member under the per-parameter gate, with the launches it takes;
    its launches' device time (CUDA events, as every kernel row is
    timed; torch.profiler's summed kernel time and event count beside
    it) against the same segments as 824 single launches and against
    its bound, both entries' whole device time (the beta powers
    included), and torch._fused_adam_ over the same tensors with an
    fp32 gradient (a yardstick only: another function); and the word
    embedding alone as a one-segment group against its single launch,
    in turns."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_update as fu

    members, hyper, bs, n_ops = _dp_group_members(dev)
    cap = _build.load("fused_update",
                      fu._SIGNATURES).pt_fused_update_group_capacity()
    ref = [fu.GroupMember(*(t.clone() if isinstance(t, torch.Tensor) else t
                            for t in m)) for m in members]
    before = (fu.fused_update_group.launches, fu.fused_update_kernel.launches)
    fu.fused_update_group("adam", members, hyper, bs)
    launches = (fu.fused_update_group.launches - before[0],
                fu.fused_update_kernel.launches - before[1])
    fu.fused_update_group("adam", ref, hyper, bs, force="reference")
    torch.cuda.synchronize()
    if launches != (-(-len(members) // cap), 0):
        raise AssertionError(f"fused_update_group: {launches} (group, "
                             f"single) launches over {len(members)} "
                             f"members, table of {cap}")
    worst, differing = 0.0, 0
    for i, (m, r) in enumerate(zip(members, ref)):
        for g, w in zip(m, r):
            if not isinstance(g, torch.Tensor) or g.dtype != torch.float32 \
                    or g is m.lr:
                continue
            err = (g - w).abs().max().item()
            differing += int((g != w).sum())
            if not torch.allclose(g, w, rtol=K8_RTOL,
                                  atol=K8_RTOL * w.abs().max()) \
                    or not torch.isfinite(g).all():
                raise AssertionError(f"fused_update_group member {i}: max "
                                     f"abs err {err}")
            worst = max(worst, err)
    del ref
    consts = fu._consts("adam", **hyper)

    def singles():
        for m in members:
            fu.fused_update_kernel("adam", m.p, m.grad, m.m1, m.m2, m.lr,
                                   m.b1p, m.b2p, consts, bs)

    def per_op_entries():
        for m in members:
            fu.fused_adam_update(m.p, m.grad, m.m1, m.m2, m.lr, m.b1p,
                                 m.b2p, **hyper, block_size=bs)

    group_ms = _time_ms(_group_launches("adam", members, hyper, bs), 20)
    group = _profile(lambda: fu.launch_group("adam", members, hyper, bs), 3,
                     match="fused_update_group_kernel")
    single = _profile(singles, 1, match="fused_update_kernel")
    group_entry = _profile(lambda: fu.fused_update_group(
        "adam", members, hyper, bs), 3)
    single_entry = _profile(per_op_entries, 1)
    grads = [torch.randn_like(m.p) for m in members]
    steps = [torch.ones((), device=dev) for _ in members]
    fused_adam = _profile(lambda: torch._fused_adam_(
        [m.p for m in members], grads, [m.m1 for m in members],
        [m.m2 for m in members], [], steps, lr=1e-4, beta1=hyper["beta1"],
        beta2=hyper["beta2"], weight_decay=0.0, eps=hyper["epsilon"],
        amsgrad=False, maximize=False), 3)
    del grads, steps
    plain = _profile(lambda: fu.fused_update_group(
        "adam", members, hyper, bs, force="reference"), 1)
    we = max(members[:n_ops], key=lambda m: m.grad[4])

    def we_single():
        fu.fused_update_kernel("adam", we.p, we.grad, we.m1, we.m2, we.lr,
                               we.b1p, we.b2p, consts, bs)

    def we_group():
        fu.launch_group("adam", [we], hyper, bs)

    we_turns = [_time_ms(f, 50) for f in (we_single, we_group, we_group,
                                          we_single)]
    byts = sum(_k8_bytes("adam", m.grad[4]) for m in members)
    bound_ms, bound_by = _bound(byts, 0)
    return worst, dict(
        members=len(members), ops_a_replica=n_ops, table=cap,
        launches=launches[0], differing_elements=differing, ms=group_ms,
        profiler_ms=group["fused_update_group_kernel_device_ms"],
        group_kernel_events=group["fused_update_group_kernel_events"],
        profiler_kept_every_launch=(
            group["fused_update_group_kernel_events"] == launches[0]),
        single_launches_ms=single["fused_update_kernel_device_ms"],
        single_launch_events=single["fused_update_kernel_events"],
        group_entry_device_ms=group_entry["device_busy_ms"],
        group_entry_device_events=group_entry["device_events"],
        per_op_entries_device_ms=single_entry["device_busy_ms"],
        per_op_entries_device_events=single_entry["device_events"],
        fused_adam_fp32_grad_ms=fused_adam["device_busy_ms"],
        fused_adam_note=("torch._fused_adam_ over the same tensors with an "
                         "fp32 gradient: another function, a yardstick "
                         "only"),
        plain_ms=plain["device_busy_ms"], bound_ms=bound_ms,
        bound_by=bound_by, bytes=byts, library_ms=None,
        word_embedding=dict(numel=we.grad[4], in_turns_ms=we_turns,
                            single_ms=(we_turns[0] + we_turns[3]) / 2,
                            group_ms=(we_turns[1] + we_turns[2]) / 2))


def check_fused_update_group_momentum(dev, rng=None):
    """K8's group form in its momentum kind over phase 31's members:
    ResNet-50's training program (the bf16 policy, Momentum(0.1, 0.9))
    transpiled for DP_REPLICAS replicas with the quantized all-reduce,
    every fused_momentum_quant_grad op of its plan on every replica,
    seeded fp32 parameters and velocities and their buckets' wire
    images: held against the plain version member by member under
    K8_RTOL, with the launches it takes; its launches' device time
    (CUDA events; torch.profiler's reading and event count beside it:
    the profiler has been seen to keep 2 of a call's 3 kernels) against
    the plain version's (torch.profiler) and the bound."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.parallel.data_parallel import DataParallelRunner

    main, _, loss, _ = _image_program()
    prog = DataParallelRunner(main, loss.name,
                              build_strategy=_resnet_dp_strategy(),
                              places=[_gpu_place()] * DP_REPLICAS).program
    members, hyper, bs, n_ops = _plan_group_members(
        dev, prog, ["img", "label"], loss.name)
    cap = _build.load("fused_update",
                      fu._SIGNATURES).pt_fused_update_group_capacity()
    ref = [fu.GroupMember(*(t.clone() if isinstance(t, torch.Tensor) else t
                            for t in m)) for m in members]
    before = (fu.fused_update_group.launches, fu.fused_update_kernel.launches)
    fu.fused_update_group("momentum", members, hyper, bs)
    launches = (fu.fused_update_group.launches - before[0],
                fu.fused_update_kernel.launches - before[1])
    fu.fused_update_group("momentum", ref, hyper, bs, force="reference")
    torch.cuda.synchronize()
    if launches != (-(-len(members) // cap), 0):
        raise AssertionError(f"fused_update_group momentum: {launches} "
                             f"(group, single) launches over "
                             f"{len(members)} members, table of {cap}")
    worst = 0.0
    for i, (m, r) in enumerate(zip(members, ref)):
        for g, w in ((m.p, r.p), (m.m1, r.m1)):
            err = (g - w).abs().max().item()
            if not torch.allclose(g, w, rtol=K8_RTOL,
                                  atol=K8_RTOL * w.abs().max()) \
                    or not torch.isfinite(g).all():
                raise AssertionError(f"fused_update_group momentum member "
                                     f"{i}: max abs err {err}")
            worst = max(worst, err)
    del ref
    group_ms = _time_ms(_group_launches("momentum", members, hyper, bs),
                        20)
    group = _profile(lambda: fu.launch_group("momentum", members, hyper,
                                             bs), 3,
                     match="fused_update_group_kernel")
    plain = _profile(lambda: fu.fused_update_group(
        "momentum", members, hyper, bs, force="reference"), 1)
    byts = sum(_k8_bytes("momentum", m.grad[4]) for m in members)
    bound_ms, bound_by = _bound(byts, 0)
    return worst, dict(
        kind="momentum", members=len(members), ops_a_replica=n_ops,
        table=cap, launches=launches[0], ms=group_ms,
        profiler_ms=group["fused_update_group_kernel_device_ms"],
        group_kernel_events=group["fused_update_group_kernel_events"],
        profiler_kept_every_launch=(
            group["fused_update_group_kernel_events"] == launches[0]),
        plain_ms=plain["device_busy_ms"], bound_ms=bound_ms,
        bound_by=bound_by, bytes=byts, library_ms=None)


# ---------------------------------------------------------------------------
# phases 4-5: BERT-base training at full width, and its CPU parity
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 128, 128
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
CHAIN_STEPS = 10  # run_steps on the train step


def _bert_program(cfg, bf16):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    return main, startup, loss


def _executors():
    """{mode: an executor on the card} of MODES: the captured one and
    the eager one (FLAGS_cuda_graph_capture as each is made)."""
    from paddle_tpu_torch import fluid

    out = {}
    for m, c in MODES:
        with capture_mode(c):
            out[m] = fluid.Executor(_gpu_place())
    return out


def _train_step_launches(cfg, replicas=1):
    """{kernel: launches} of one BERT train step over ``replicas``."""
    return {"flash_fwd": 2 * cfg.num_layers * replicas,
            "flash_bwd_dq": cfg.num_layers * replicas,
            "flash_bwd_dkv": cfg.num_layers * replicas,
            "fused_bias_act": (cfg.num_layers + 1) * replicas}


def _gate_launches(what, launches, on_card, per_run, runs, first_runs):
    """The exact launch gates of a path run in both modes: on the card
    (the kernels' own counters) every program run of either mode
    launches ``per_run``, ``runs`` runs a mode (or {mode: runs}); the
    wrappers see every eager run, and of the captured mode only its
    ``first_runs`` (each a signature's eager warm-up and its capture: a
    replay runs no Python)."""
    runs = runs if isinstance(runs, dict) else dict.fromkeys(on_card, runs)
    want_card = {m: _times(per_run, runs[m]) for m in on_card}
    want = {"captured": _times(per_run, 2 * first_runs),
            "eager": want_card["eager"]}
    if on_card != want_card or launches != want:
        raise AssertionError(
            f"{what}: launches {launches} (wrappers) and {on_card} (on the "
            f"card), expected {want} and {want_card}")


def run_train_path(counters, bf16=True):
    """BERT-base, b128 s128, bf16 policy (``bf16``; else fp32, Fluid's
    default dtype), Adam, flash, hidden dropout 0.1, on the card: the
    captured executor and the eager one in turns (a step each), from the
    same state and feed, TRAIN_WARMUP + TRAIN_STEPS steps each.  Each
    mode's launches exact, on the card and in the wrappers; the two
    modes' losses and final state bit-equal.  The captured state after
    CHAIN_STEPS steps is kept for run_train_chain.  MFU against the
    port's peak table under the bf16 policy, and against the fp32 SIMT
    peak in fp32 (the step's matmuls run in full fp32)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.observability import profiling

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    main, startup, loss = _bert_program(cfg, bf16=bf16)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    start = _clone_scope(scope)  # run_train_chain starts from here
    exes = _executors()
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    snap = None
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for i in range(steps):
        for m, exe in exes.items():  # in turns
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)  # the fetch syncs
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            if i >= TRAIN_WARMUP:
                peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append(float(lv))
        if i == CHAIN_STEPS - 1:
            snap = _clone_scope(scopes["captured"])
    total = {k: w.launches for k, w in counters.items()}
    _gate_launches("train path", launches, on_card,
                   _train_step_launches(cfg), steps, 1)
    sites = check_no_new_sites("train path", main)
    if total != {k: launches["captured"][k] + launches["eager"][k]
                 for k in total}:
        raise AssertionError(f"train path: the wrappers read {total}, the "
                             f"runs {launches}")
    loss_c = losses["captured"]
    if not all(np.isfinite(loss_c)) or not loss_c[-1] < loss_c[0]:
        raise AssertionError(f"train path losses not finite and falling: "
                             f"{loss_c}")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"train path: captured and eager differ: "
                             f"losses {losses}, state {diff[:5]}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = bert.train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    if bf16:
        _, peak_flops, _, _ = profiling.device_peaks()
        peak_name = "profiling.device_peaks() (bf16 dense tensor cores)"
    else:
        peak_flops = FP32_FLOPS
        peak_name = ("FP32_FLOPS (fp32 SIMT: the step's matmuls run in full "
                     "fp32)")
    modes = {}
    for m in exes:
        timed = np.asarray(secs[m][TRAIN_WARMUP:])
        modes[m] = dict(
            tokens_per_s=tokens * TRAIN_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * float(np.percentile(timed, 50)),
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=secs[m][0],
            mfu=flops / float(np.median(timed)) / peak_flops,
            peak_memory_gb=peak[m] / 1e9, launches=launches[m],
            device_launches=on_card[m])
        if not bf16:
            # against the rate the flash bounds hold fp32 products to:
            # fp32-accurate products as three TF32 tensor-core products
            modes[m]["mfu_fp32_tc"] = (flops / float(np.median(timed))
                                       / (TF32_TC_FLOPS / 3))
    held = [h.graph for h in exes["captured"].compiled_for(main)]
    if exes["captured"].capture and held == [None]:
        raise AssertionError("train path: the captured executor holds no "
                             "graph")
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"], main)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    path = dict(model="BertConfig.base(vocab_size=30528)", batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, dtype_policy="bf16" if bf16 else "fp32",
                steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, losses=loss_c,
                captured_eager_bit_equal=True, model_flops_per_step=flops,
                mfu_peak_flops=peak_flops, mfu_peak=peak_name, modes=modes,
                **({} if bf16 else dict(
                    mfu_fp32_tc_peak_flops=TF32_TC_FLOPS / 3,
                    mfu_fp32_tc_peak="TF32_TC_FLOPS / 3 (fp32-accurate "
                                     "products as three TF32 products, as "
                                     "_flash_bounds takes them)")),
                launches=total,
                device_launches=_summed(on_card), new_pass_sites=sites)
    state = dict(exes=exes, main=main, scopes=scopes, feed=feed, loss=loss,
                 cfg=cfg, start=start, snap=snap, losses=loss_c)
    return state, path


def time_lookup_grads(dev):
    """The train step's three lookup_table reads and derived grads (the
    word [30528, 768], position [512, 768] and token-type [2, 768]
    tables, b128 s128 ids, bf16 as the policy casts them): the port's
    lowering (an exact integer index-add, ops/tensor_ops.py
    ``index_add_exact``) against the library's forms it replaces, each
    forward and backward timed and each grad checked for equality over
    eight repeats: ``index_select`` (the lowering before the captured
    executor), ``F.embedding``, indexing, and a one-hot product for the
    tables of at most 1,024 rows (the port uses none of them).  The
    lowering's grad must be equal run to run: captured and eager steps
    agree on it."""
    from paddle_tpu_torch.fluid import registry

    lower = registry.get_op("lookup_table").lower
    ctx = registry.LowerContext(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    ids = {"word": torch.randint(0, 30528, shape, generator=g, device=dev),
           "position": torch.arange(TRAIN_SEQ, device=dev).repeat(
               TRAIN_BATCH, 1),
           "token_type": torch.randint(0, 2, shape, generator=g,
                                       device=dev)}
    rows = {"word": 30528, "position": 512, "token_type": 2}
    forms = {"lowering": lambda w, i: lower(ctx, w, i, attrs={}),
             "index_select": lambda w, i: torch.index_select(
                 w, 0, i.reshape(-1)),
             "embedding": lambda w, i: torch.nn.functional.embedding(
                 i.reshape(-1), w),
             "indexing": lambda w, i: w[i.reshape(-1)],
             "one_hot": lambda w, i: torch.nn.functional.one_hot(
                 i.reshape(-1), w.shape[0]).to(w.dtype) @ w}
    out = {}
    for name, i in ids.items():
        w = (0.02 * torch.randn(rows[name], 768, generator=g, device=dev)
             ).to(torch.bfloat16).requires_grad_()
        dout = torch.randn(TRAIN_BATCH * TRAIN_SEQ, 768, generator=g,
                           device=dev).to(torch.bfloat16)
        out[name] = {}
        for form in forms:
            if form == "one_hot" and rows[name] > 1024:
                continue

            def grad():
                o = forms[form](w, i).reshape(-1, 768)
                return torch.autograd.grad(o, w, dout)[0]

            ref = grad()
            same = all(torch.equal(ref, grad()) for _ in range(8))
            if form == "lowering" and not same:
                raise AssertionError(f"lookup_table grad ({name} table) "
                                     f"differs from run to run")
            out[name][form] = dict(ms=_time_ms(grad, 10),
                                   equal_run_to_run=same)
    return out


def run_train_chain(state):
    """run_steps(CHAIN_STEPS) on the train step from the path's start:
    its last loss and final state equal to the path's captured run()
    calls at that step (bit for bit); one graph replayed a step, so the
    card launches CHAIN_STEPS x a step's kernels and the wrappers see
    the first step's warm-up and capture only."""
    from paddle_tpu_torch import fluid

    # the path's executors and the eager state go first: one more
    # graph's pool of activations comes next
    state["exes"].clear()
    state["scopes"].clear()
    torch.cuda.empty_cache()
    exe = fluid.Executor(_gpu_place())
    per = _train_step_launches(state["cfg"])
    before = _snap()
    t0 = time.perf_counter()
    (last,) = exe.run_steps(state["main"], feed=state["feed"],
                            n_steps=CHAIN_STEPS, fetch_list=[state["loss"]],
                            scope=state["start"])
    wall = time.perf_counter() - t0
    got, on_card = _since(before, per)
    want = (_times(per, 2), _times(per, CHAIN_STEPS))
    diff = _scope_diff(state["start"], state["snap"])
    ref = state["losses"][CHAIN_STEPS - 1]
    if float(last) != ref or diff or (got, on_card) != want:
        raise AssertionError(f"run_steps({CHAIN_STEPS}): last loss "
                             f"{float(last)} vs run() {ref}, state diff "
                             f"{diff[:5]}, launches {got} (wrappers) and "
                             f"{on_card} (on the card) vs {want}")
    (handle,) = [h for h in exe.compiled_for(state["main"])
                 if "chain" in h.label]
    return dict(n_steps=CHAIN_STEPS, last_loss=float(last),
                equal_to_run_calls=True, wall_s=wall,
                step_mean_ms=1e3 * wall / CHAIN_STEPS,
                capture_s=_capture_seconds(exe, state["main"]),
                graph_of_one_step=handle.graph is not None, launches=got,
                device_launches=on_card)


def _profile(step, n, match=None, device_only=False, kernels=False):
    """Host wall time vs summed device time of ``n`` calls of ``step``
    (torch.profiler), with the top device and host ops and the launch
    API calls (cudaLaunchKernel and its kin, cudaGraphLaunch) a call;
    with ``match`` (a name or a tuple of names), also the summed device
    time and count a call of the device events whose name contains each;
    with ``kernels``, the profiler itself (``"prof"``) for
    :func:`_kernel_sequence`.  ``device_only`` traces the card alone,
    for a step whose kernels another thread launches (the serving
    Engine's scheduler): a trace with host activity keeps only some of
    them.  Traced alone, the step keeps all of them when it is the
    first trace of its process (``--only engine``), not always after
    earlier ones."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] if device_only else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    dev, host = [], []
    for e in prof.key_averages():
        if e.key.startswith("pt_"):
            continue  # a record_function range, mirrored on the device
        # device-side events (kernels, copies) only: a CPU op such as
        # aten::mm also carries the device time of the kernels under it
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            d_us = (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) or 0)
            dev.append((d_us, e.key, e.count))
        else:
            host.append((getattr(e, "self_cpu_time_total", 0) or 0, e.key,
                         e.count))
    dev_us = sum(t for t, _, _ in dev)

    def top(rows, k=8):
        return [[key[:60], round(t / n, 1), c // n]
                for t, key, c in sorted(rows, reverse=True)[:k]]

    out = dict(wall_profiled_ms=1e3 * wall,
               device_busy_ms=dev_us / n / 1e3 if dev_us else None,
               device_events=sum(c for _, _, c in dev) // n,
               launch_api_calls={key: c // n for _, key, c in host
                                 if "LaunchKernel" in key
                                 or "GraphLaunch" in key},
               top_device_us=top(dev), top_host_self_us=top(host))
    if out["device_busy_ms"]:
        out["device_idle_share"] = 1 - out["device_busy_ms"] / out[
            "wall_profiled_ms"]
    for name in (match,) if isinstance(match, str) else (match or ()):
        hits = [(t, c) for t, key, c in dev if name in key]
        out[f"{name}_device_ms"] = sum(t for t, _ in hits) / n / 1e3
        out[f"{name}_events"] = sum(c for _, c in hits) // n
    if kernels:
        out["prof"] = prof
    return out


def profile_modes(state, match=None):
    """One step of each mode of a path's ``state`` (its executors,
    scopes, feed, ``fetch`` list (the path's own, so the captured step
    replays its graph), and ``compiled`` programs or ``main``) under
    torch.profiler, and one unprofiled (``step_wall_ms``): device busy
    and idle, the launch API calls and the device time of ``match``."""
    out = {}
    for m, exe in state["exes"].items():
        target = (state["compiled"][m] if "compiled" in state
                  else state["main"])

        def step():
            exe.run(target, feed=state["feed"], fetch_list=state["fetch"],
                    scope=state["scopes"][m])

        r = _profile(step, 1, match=match)
        t0 = time.perf_counter()
        step()
        r["step_wall_ms"] = 1e3 * (time.perf_counter() - t0)
        out[m] = r
    return out


def _kernel_sequence(prof, labels=()):
    """The device kernels of a trace in start order (copies and sets
    left out): (name, microseconds, label), the label the innermost
    ``record_function`` range of ``labels`` that holds the CPU op that
    launched the kernel (linked by correlation id), else None."""
    from torch.autograd import DeviceType

    def start(e):
        return e.start_ns() if hasattr(e, "start_ns") else 1e3 * e.start_us()

    def dur(e):
        return (e.duration_ns() if hasattr(e, "duration_ns")
                else 1e3 * e.duration_us())

    evs = list(prof.profiler.kineto_results.events())
    ranges = [(start(e), start(e) + dur(e), e.name())
              for e in evs if e.name() in labels]
    ops = {e.correlation_id(): start(e) for e in evs
           if e.device_type() == DeviceType.CPU
           and not e.name().startswith("cuda")}
    out = []
    for e in sorted((e for e in evs if e.device_type() == DeviceType.CUDA
                     and e.name() not in labels
                     and not e.name().startswith(("Memcpy", "Memset"))),
                    key=start):
        t = ops.get(e.linked_correlation_id())
        held = [(b - a, n) for a, b, n in ranges
                if t is not None and a <= t <= b]
        out.append((e.name(), dur(e) / 1e3, min(held)[1] if held else None))
    return out


# record_function ranges of the train step's elementwise split
SPLIT_LABELS = ("pt_bf16_policy_cast", "pt_adam")


def _split_annotations():
    """The bf16 policy's casts (``executor._apply_bf16_policy``) and the
    adam op's lowering each inside a record_function range, for one
    eager profiled step."""
    return _op_annotations({SPLIT_LABELS[1]: ("adam",)}, SPLIT_LABELS[0])


def _split(seq):
    """Device ms of each label of a labelled kernel sequence."""
    out = {}
    for _, us, label in seq:
        key = label or "other"
        out[key] = out.get(key, 0.0) + us / 1e3
    return out


def _profile_labelled(state, labels, annotate):
    """One step of each mode of ``state`` under torch.profiler, and one
    unprofiled (``step_wall_ms``): device busy and idle and the launch
    API calls a mode.  The eager step runs inside ``annotate()``, which
    puts the ranges of ``labels`` around its ops; the captured step's
    kernels (one graph launch: no op launches them) take the labels of
    the eager step's kernels they align with, name by name in order
    (difflib).  Returns (readings by mode, the eager labelled kernel
    sequence, the captured one's aligned kernels, and the captured
    kernels left unaligned (ms) with the kernel counts)."""
    exes, scopes = state["exes"], state["scopes"]
    main, feed, loss = state["main"], state["feed"], state["loss"]
    out, seqs = {}, {}
    for m, exe in exes.items():
        def step():
            exe.run(main, feed=feed, fetch_list=[loss], scope=scopes[m])

        with annotate() if m == "eager" else contextlib.nullcontext():
            r = _profile(step, 1, kernels=True)
        seqs[m] = _kernel_sequence(r.pop("prof"), labels)
        t0 = time.perf_counter()
        step()
        r["step_wall_ms"] = 1e3 * (time.perf_counter() - t0)
        out[m] = r
    eager, cap = seqs["eager"], seqs["captured"]
    sm = difflib.SequenceMatcher(a=[k[0] for k in eager],
                                 b=[k[0] for k in cap], autojunk=False)
    labelled = []
    for a, b, size in sm.get_matching_blocks():
        labelled += [(cap[b + i][0], cap[b + i][1], eager[a + i][2])
                     for i in range(size)]
    unaligned = {"captured_unaligned_ms": (
                     sum(us for _, us, _ in cap)
                     - sum(us for _, us, _ in labelled)) / 1e3,
                 "kernels": {"eager": len(eager), "captured": len(cap),
                             "aligned": len(labelled)}}
    return out, eager, labelled, unaligned


def profile_train_step(state):
    """One train step of each mode profiled (:func:`_profile_labelled`),
    with the elementwise split of the step's device time between the
    bf16 policy's casts and Adam's kernels."""
    out, eager, labelled, unaligned = _profile_labelled(
        state, SPLIT_LABELS, _split_annotations)
    out["elementwise_split_ms"] = {"eager": _split(eager),
                                   "captured": _split(labelled), **unaligned}
    return out


# the fp32 K2 and K3 as the profiler names them (flash_tf32.cuh)
FP32_BWD_KERNELS = ("flash_bwd_dq_tf32", "flash_bwd_dkv_tf32")


def profile_fp32_train_step(state):
    """One fp32 train step of each mode under torch.profiler: device
    busy and idle, and the device time of the split-TF32 K2 and K3 a
    step (each, and summed)."""
    exes, scopes = state["exes"], state["scopes"]
    main, feed, loss = state["main"], state["feed"], state["loss"]
    out = {}
    for m, exe in exes.items():
        def step():
            exe.run(main, feed=feed, fetch_list=[loss], scope=scopes[m])

        r = _profile(step, 1, match=FP32_BWD_KERNELS)
        r["k2_k3_device_ms"] = sum(r[f"{k}_device_ms"]
                                   for k in FP32_BWD_KERNELS)
        out[m] = r
    return out


def run_train_parity():
    """Full width, 2 layers, b4 s128, fp32, dropout 0: 3 Adam steps on
    the card and on the CPU from the same parameters."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, num_layers=2,
                               use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    main, startup, loss = _bert_program(cfg, bf16=False)
    feed = bert.make_fake_batch(cfg, 4, 128, seed=1)
    gpu = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=gpu)
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    convert.load_params(cpu, {p.name: gpu.get(p.name).cpu().numpy()
                              for p in main.all_parameters()},
                        fluid.CPUPlace(), program=main)
    losses = {}
    for key, scope, place in (("gpu", gpu, _gpu_place()),
                              ("cpu", cpu, fluid.CPUPlace())):
        exe = fluid.Executor(place)
        losses[key] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]) for _ in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["gpu"],
                                                  losses["cpu"]))
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"train parity: losses {losses}, max rel diff "
                             f"{rel} >= {TRAIN_LOSS_RTOL}")
    layer = [p.name for p in main.all_parameters()
             if p.name.startswith("encoder_layer_1_")]
    worst, mean = 0.0, 0.0
    for n in layer:
        d = np.abs(gpu.get(n).cpu().numpy() - cpu.get(n).numpy())
        worst, mean = max(worst, float(d.max())), max(mean, float(d.mean()))
    if not (worst <= TRAIN_PARAM_MAX_ATOL and mean <= TRAIN_PARAM_MEAN_ATOL):
        raise AssertionError(f"train parity: encoder_layer_1 params differ "
                             f"by max {worst} / mean {mean}")
    return dict(losses=losses, loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, layer="encoder_layer_1",
                layer_params=len(layer), param_max_abs_diff=worst,
                param_mean_abs_diff=mean,
                param_tol=[TRAIN_PARAM_MAX_ATOL, TRAIN_PARAM_MEAN_ATOL])


# ---------------------------------------------------------------------------
# phases 12-13: the data-parallel training lane (four replicas on one
# card, quantized gradient all-reduce, K8), and its CPU parity
# ---------------------------------------------------------------------------

DP_REPLICAS = 4
DP_WARMUP, DP_STEPS = 2, 5
# card vs CPU replicas, fp32, 3 Adam steps.  The losses within 1e-4
# relative.  A leaf (a parameter) whose reference gradient sits at the
# rounding floor — its bias-corrected RMS, read from the CPU run's
# Moment2, under DP_GRAD_FLOOR x the median leaf's, about fp32's
# relative rounding, as for the attention key biases whose true
# gradient is 0 — has no direction to hold.  Every other leaf is held by
# relative norms: Moment1 and Moment2 (which carry the gradient's scale,
# which Adam's step hides) within DP_MOMENT_RTOL, the parameter's change
# within DP_PARAM_RTOL.  The dual-int8 wire resolves 1/(127 x 254) of a
# block's max, so card-vs-CPU rounding that flips a code moves a reduced
# gradient by ~3e-5 of its block; a wrong average or scale index moves
# a leaf's moments by 0.5 or more
DP_GRAD_FLOOR = 1e-6
DP_MOMENT_RTOL = 1e-3
DP_PARAM_RTOL = 1e-2
DP_PARITY_STEPS = 3


def _dp_feed(cfg, batch, seq, seed):
    """The global batch as DP_REPLICAS per-replica batches of
    make_fake_batch, concatenated: each replica's mask_pos (flat
    positions into its own rows) indexes its shard, as a user of the
    data-parallel lane feeds it."""
    from paddle_tpu_torch.models import bert

    shards = [bert.make_fake_batch(cfg, batch // DP_REPLICAS, seq,
                                   seed=seed + r)
              for r in range(DP_REPLICAS)]
    return {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}


def _dp_compiled(main, loss, places):
    """The lane as a user writes it: quantized all-reduce on, the fused
    update and the rest at their flag defaults."""
    from paddle_tpu_torch import fluid

    bs = fluid.BuildStrategy()
    bs.quant_allreduce = True
    return fluid.CompiledProgram(main, build_strategy=bs).with_data_parallel(
        loss_name=loss.name, places=places)


def _counter_value(name):
    from paddle_tpu_torch.observability import metrics

    fam = metrics.snapshot().get(name)
    return sum(fam["samples"].values()) if fam else 0.0


def run_dp_path(counters):
    """BERT-base (phase 4's configuration) over DP_REPLICAS replicas on
    CUDAPlace(0): global batch b128 s128, b32 a replica, the captured
    executor and the eager one in turns (a step each) from the same
    state and feed.  In each mode the card must launch K8's group form
    once a table-full of the plan's group step (every
    fused_adam_quant_grad op on every replica) a step and its
    per-parameter form never, K1-K4 replicas x their phase-4 counts
    (the wrappers: every eager step, and the captured mode's warm-up
    and capture); the replicas' parameters
    bit-identical and the scope's; the two modes' losses and replica
    state bit-equal."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_update as fu
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    # a program a mode: the data-parallel transpile rewrites its program
    # in place (the same names: one state serves both)
    progs = {m: _bert_program(cfg, bf16=True) for m, _ in MODES}
    main, startup, loss = progs["captured"]
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    compiled = {m: _dp_compiled(progs[m][0], progs[m][2],
                                [_gpu_place()] * DP_REPLICAS)
                for m in exes}
    feed = _dp_feed(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    saved0 = _counter_value("pt_fused_update_bytes_saved_total")
    names = list(counters) + ["fused_update_kernel"]
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    fu.fused_update_kernel.launches = 0
    steps, n = DP_WARMUP + DP_STEPS, DP_REPLICAS
    for i in range(steps):
        for m, exe in exes.items():  # in turns
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            (lv,) = exe.run(compiled[m], feed=feed, fetch_list=[loss],
                            scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)  # the fetch syncs
            py, dev = _since(before, names)
            _add(launches[m], py)
            _add(on_card[m], dev)
            if i >= DP_WARMUP:
                peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append([float(v) for v in lv])
    total = {k: w.launches for k, w in counters.items()}
    runner = compiled["captured"]._dp_runner
    prog = runner.program
    n_fused = sum(op.type == "fused_adam_quant_grad"
                  for op in prog.global_block().ops)
    (exec_plan,) = runner._plans.values()
    cap = _build.load("fused_update",
                      fu._SIGNATURES).pt_fused_update_group_capacity()
    # the group launches the plan makes: one a table-full of each group
    # step's members on every replica
    group_launches = sum(-(-m * n // cap)
                         for _, m in exec_plan.group_sizes)
    per = dict(_train_step_launches(cfg, n), fused_update=group_launches,
               fused_update_kernel=0)
    per = {k: v for k, v in per.items() if k in names}
    groups = exec_plan.group_sizes
    if groups != [("fused_adam_quant_grad", n_fused)]:
        raise AssertionError(f"dp path: plan groups {groups} ({n_fused} "
                             f"fused_adam_quant_grad ops)")
    _gate_launches("dp path", launches, on_card, per, steps, 1)
    sites = check_no_new_sites("dp path", *(progs[m][0] for m in exes))
    if total != {k: launches["captured"][k] + launches["eager"][k]
                 for k in total}:
        raise AssertionError(f"dp path: the wrappers read {total}, the "
                             f"runs {launches}")
    means = [float(np.mean(x)) for x in losses["captured"]]
    if not np.isfinite(losses["captured"]).all() or not means[-1] < means[0]:
        raise AssertionError(f"dp path losses not finite and falling: "
                             f"{losses['captured']}")
    params = main.all_parameters()
    for m in exes:
        r = compiled[m]._dp_runner
        for p in params:
            vals = r.replica_values(p.name)
            if not all(torch.equal(v, vals[0]) for v in vals[1:]) \
                    or scopes[m].get(p.name) is not vals[0]:
                raise AssertionError(f"dp path ({m}): replicas differ on "
                                     f"{p.name}, or replica 0 is not the "
                                     f"scope's")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"dp path: captured and eager differ: losses "
                             f"{losses}, state {diff[:5]}")
    plan = prog._quant_allreduce_plan
    tokens = TRAIN_BATCH * TRAIN_SEQ
    modes = {}
    for m in exes:
        timed = np.asarray(secs[m][DP_WARMUP:])
        modes[m] = dict(
            tokens_per_s=tokens * DP_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * float(np.percentile(timed, 50)),
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=secs[m][0], peak_memory_gb=peak[m] / 1e9,
            launches=launches[m], device_launches=on_card[m])
    (graph,) = [e.graph for e in runner._entries.values()]
    if exes["captured"].capture and graph is None:
        raise AssertionError("dp path: the captured executor holds no graph")
    modes["captured"]["capture_s"] = getattr(graph, "capture_seconds", None)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    path = dict(
        model="BertConfig.base(vocab_size=30528)", replicas=n,
        places="[CUDAPlace(0)] x 4", global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, dtype_policy="bf16", steps=DP_STEPS,
        warmup_steps=DP_WARMUP, losses=losses["captured"],
        fused_adam_quant_grad_ops=n_fused, plan_groups=groups,
        group_table=cap, group_launches_per_step=group_launches,
        plain_adam_ops=sum(op.type == "adam"
                           for op in prog.global_block().ops),
        parameters=len(params),
        parameter_elements=int(sum(int(np.prod(p.shape)) for p in params)),
        buckets=[[b["elements"], b["algo"], b["fused_update"]]
                 for b in plan["buckets"]],
        modeled_wire_bytes_per_step=prog._collective_bytes_per_step,
        fused_update_bytes_saved_per_step=prog._fused_update_bytes_saved,
        pt_fused_update_bytes_saved_total=_counter_value(
            "pt_fused_update_bytes_saved_total") - saved0,
        tokens_per_s_note=("global tokens a step over the host-clock step; "
                           "four replicas share one card, so this is not a "
                           "scaling figure"),
        replicas_bit_identical=True, captured_eager_bit_equal=True,
        modes=modes, launches=total, device_launches=_summed(on_card),
        new_pass_sites=sites)
    state = dict(exes=exes, compiled=compiled, scopes=scopes, feed=feed,
                 loss=loss, fetch=[loss], n_fused=n_fused)
    return state, path


def profile_dp_step(state):
    """One data-parallel step of each mode under torch.profiler
    (profile_modes): device busy and idle, the top kernels, the launch
    API calls, K8's summed device time (its group kernel, and its
    per-parameter kernel, which must not run) against its bound (every
    fused op's bytes, every replica, at the HBM rate), and the
    multi-tensor kernels that advance the beta powers."""
    out = profile_modes(state, match=("fused_update_group_kernel",
                                      "fused_update_kernel",
                                      "multi_tensor_apply"))
    prog = state["compiled"]["captured"]._dp_runner.program
    byts = sum(_k8_bytes("adam", int(op.attrs["numel"]))
               for op in prog.global_block().ops
               if op.type == "fused_adam_quant_grad") * DP_REPLICAS
    out["k8_bound_ms_per_step"] = _bound(byts, 0)[0]
    out["k8_bytes_per_step"] = byts
    return out


def _dp_parity_run(cfg, place, feed, init):
    """DP_PARITY_STEPS steps over DP_REPLICAS replicas on ``place`` from
    the parameters ``init`` (None: the startup's, returned).  Returns the
    losses, ``init`` and {param: (param, Moment1, Moment2)} after the
    run, read from the fused adam ops, with the ops' beta2."""
    from paddle_tpu_torch import convert, fluid

    main, startup, loss = _bert_program(cfg, bf16=False)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    if init is None:
        init = {p.name: scope.get(p.name).cpu().numpy().copy()
                for p in main.all_parameters()}
    else:
        convert.load_params(scope, init, place, program=main)
    compiled = _dp_compiled(main, loss, [place] * DP_REPLICAS)
    losses = [exe.run(compiled, feed=feed, fetch_list=[loss],
                      scope=scope)[0].tolist()
              for _ in range(DP_PARITY_STEPS)]
    ops = [op for op in compiled._dp_runner.program.global_block().ops
           if op.type == "fused_adam_quant_grad"]
    state = {op.inputs["Param"][0]: tuple(
        scope.get(op.inputs[slot][0]).cpu().numpy().astype(np.float64)
        for slot in ("Param", "Moment1", "Moment2")) for op in ops}
    return losses, init, state, float(ops[0].attrs["beta2"])


def _dp_leaf_readings(init, gpu, cpu, beta2):
    """Per leaf: the reference gradient's bias-corrected RMS (from the
    CPU Moment2) against the median leaf's, and, card against CPU, the
    relative norms of the Moment1, Moment2 and parameter-change
    differences and the parameter's max abs difference."""
    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    g_rms = {n: float(np.sqrt(cpu[n][2].mean()
                              / (1 - beta2 ** DP_PARITY_STEPS)))
             for n in cpu}
    median = float(np.median(list(g_rms.values())))
    out = {}
    for n, (p, m1, m2) in gpu.items():
        p0 = init[n].astype(np.float64)
        out[n] = dict(grad_rms_to_median=g_rms[n] / median,
                      held=g_rms[n] >= DP_GRAD_FLOOR * median,
                      moment1_rel=rel(m1, cpu[n][1]),
                      moment2_rel=rel(m2, cpu[n][2]),
                      change_rel=rel(p - p0, cpu[n][0] - p0),
                      param_max_abs=float(np.abs(p - cpu[n][0]).max()))
    return out


def run_dp_parity():
    """Full width, 2 layers, b8 s128, fp32, dropout 0: 3 steps over four
    replicas on the card and over four CPUPlace replicas (the plain
    versions) from the same parameters; the losses, and each leaf's
    moments and parameter change above the rounding floor (see
    DP_GRAD_FLOOR)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, num_layers=2,
                               use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    feed = _dp_feed(cfg, 8, 128, seed=1)
    gl, init, gpu, beta2 = _dp_parity_run(cfg, _gpu_place(), feed, None)
    cl, _, cpu, _ = _dp_parity_run(cfg, fluid.CPUPlace(), feed, init)
    gl, cl = np.asarray(gl), np.asarray(cl)
    rel = float(np.abs(gl - cl).max() / np.abs(cl).min())
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"dp parity: losses {gl.tolist()} (card) vs "
                             f"{cl.tolist()} (CPU), max rel diff {rel}")
    leaves = _dp_leaf_readings(init, gpu, cpu, beta2)
    held = {n: r for n, r in leaves.items() if r["held"]}
    worst = {}
    for key, tol in (("moment1_rel", DP_MOMENT_RTOL),
                     ("moment2_rel", DP_MOMENT_RTOL),
                     ("change_rel", DP_PARAM_RTOL)):
        name = max(held, key=lambda n: held[n][key])
        worst[key] = dict(leaf=name, **held[name])
        if not held[name][key] <= tol:
            raise AssertionError(f"dp parity: {key} {held[name][key]} > "
                                 f"{tol} on leaf {name}: {held[name]}")
    floor = {n: r for n, r in leaves.items() if not r["held"]}
    return dict(replicas=DP_REPLICAS, losses_gpu=gl.tolist(),
                losses_cpu=cl.tolist(), loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, leaves=len(leaves),
                leaves_held=len(held), worst_held=worst,
                rtol=dict(moments=DP_MOMENT_RTOL, change=DP_PARAM_RTOL),
                floor_leaves=floor, grad_floor_to_median=DP_GRAD_FLOOR,
                least_held_grad_to_median=min(
                    r["grad_rms_to_median"] for r in held.values()),
                param_max_abs_diff=max(r["param_max_abs"]
                                       for r in leaves.values()))


# ---------------------------------------------------------------------------
# phases 6-7: the decode lane at full width, and its CPU parity
# ---------------------------------------------------------------------------


class Lane:
    """The decode lane's two programs run directly on one executor, for
    the parity checks: prefill a token list through pages 1.., then
    decode steps, returning logprobs.  ``int8_weights``: both programs
    through the int8_weight_storage pass and ``scope``'s weights
    quantized, as DecodeEngine(int8_weights=True) does."""

    def __init__(self, cfg, place, scope, pool_slots, page_size, max_len,
                 chunk, pool_dtype="float32", capture=None,
                 int8_weights=False):
        from paddle_tpu_torch import fluid
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.passes import PassManager
        from paddle_tpu_torch.passes.int8_weights import (
            quantize_scope_weights)
        from paddle_tpu_torch.serving.kv_pool import KVPool

        self.cfg, self.scope, self.chunk = cfg, scope, chunk
        self.page_size = page_size
        self.max_pages = max_len // page_size
        num_pages = pool_slots * self.max_pages + 1
        self.pool_slots = pool_slots
        with capture_mode(True if capture is None else capture):
            self.exe = fluid.Executor(place)
        KVPool(cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
               num_pages, page_size, self.max_pages,
               dtype=pool_dtype).install(scope, self.exe.device)
        self.pf, self.dec = fluid.Program(), fluid.Program()
        with fluid.program_guard(self.pf, fluid.Program()), \
                fluid.unique_name.guard():
            _, _, lp = gpt.build_gpt_prefill_chunk(
                cfg, chunk, num_pages, page_size, self.max_pages,
                pool_dtype=pool_dtype)
        self.pf_logp = lp.name
        with fluid.program_guard(self.dec, fluid.Program()), \
                fluid.unique_name.guard():
            _, _, lp = gpt.build_gpt_decode_step(
                cfg, pool_slots, num_pages, page_size, self.max_pages,
                pool_dtype=pool_dtype)
        self.dec_logp = lp.name
        if int8_weights:  # as DecodeEngine(int8_weights=True) does
            for p in (self.pf, self.dec):
                PassManager(["int8_weight_storage"]).run(p)
            quantize_scope_weights(scope, self.dec, book=False)

    def table(self, n_tokens):
        row = np.zeros(self.max_pages, np.int32)
        used = -(-n_tokens // self.page_size)
        row[:used] = np.arange(1, used + 1)
        return row

    def prefill(self, tokens):
        """Logprobs after each chunk of `tokens` (pages 1, 2, ...)."""
        out, c, pgs = [], self.chunk, self.page_size
        table = self.table(len(tokens))
        for s in range(0, len(tokens), c):
            valid = min(c, len(tokens) - s)
            tok = np.zeros((1, c), np.int64)
            tok[0, :valid] = tokens[s:s + valid]
            wp = np.zeros(c // pgs, np.int32)
            for j in range(c // pgs):
                if s + j * pgs < s + valid:
                    wp[j] = table[(s + j * pgs) // pgs]
            feed = {"pf_tok": tok,
                    "pf_pos": np.minimum(s + np.arange(c), 1023)[None, :]
                    .astype(np.int64),
                    "pf_page_table": table[None, :],
                    "pf_write_pages": wp,
                    "pf_qstart": np.asarray([s], np.int32),
                    "pf_last_idx": np.asarray([valid - 1], np.int64)}
            (lp,) = self.exe.run(self.pf, feed=feed,
                                 fetch_list=[self.pf_logp], scope=self.scope)
            out.append(lp[0])
        return out

    def decode(self, token, pos):
        """Logprobs of one decode step with slot 0 active at `pos`."""
        ps = self.pool_slots
        table = np.zeros((ps, self.max_pages), np.int32)
        table[0] = self.table(pos + 1)
        feed = {"dec_tok": np.zeros((ps, 1), np.int64),
                "dec_pos": np.zeros((ps, 1), np.int64),
                "dec_page_table": table,
                "dec_write_page": np.zeros(ps, np.int32),
                "dec_write_off": np.zeros(ps, np.int32)}
        feed["dec_tok"][0, 0] = token
        feed["dec_pos"][0, 0] = pos
        feed["dec_write_page"][0] = table[0, pos // self.page_size]
        feed["dec_write_off"][0] = pos % self.page_size
        (lp,) = self.exe.run(self.dec, feed=feed, fetch_list=[self.dec_logp],
                             scope=self.scope)
        return lp[0]


def _param_names(cfg):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 1, 2, 16, 1)
    return main, [p.name for p in main.all_parameters()]


def _lane_workload(cfg):
    """The decode cell's requests: 16 seeded prompts of 8-512 tokens."""
    rng = np.random.RandomState(SEED)
    lens = [8, 512] + list(rng.randint(8, 513, 14))
    return lens, [rng.randint(1, cfg.vocab_size, n).tolist() for n in lens]


def _serve_lane(cfg, scope, prompts, counters, pool_dtype, capture,
                int8_weights=False):
    """One run of the decode workload on a fresh DecodeEngine (warmed
    up: on the captured executor, each program captured there) over
    ``scope``'s weights, with every launch count set to 0 before the
    engine is made and read after the run.  Returns the ids and the
    run's figures; gates each kernel at its count a layer per program
    run on the card (the warmup's runs included), and in the wrappers,
    which see every eager run and of the captured engine only the
    warmup's warm-up runs and captures."""
    from paddle_tpu_torch.serving import DecodeEngine

    for w, _ in counters.values():
        w.launches = 0
    before = _snap()
    start = torch.cuda.memory_allocated()
    with capture_mode(capture):
        eng = DecodeEngine(cfg, scope=scope, place=_gpu_place(),
                           pool_slots=8, page_size=16, max_len=1024,
                           pool_dtype=pool_dtype, int8_weights=int8_weights,
                           name=f"smoke-{pool_dtype}-{int8_weights}-"
                                f"{capture}",
                           auto_start=False, max_queue=len(prompts))
    warmed = eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.start()
    outs = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, (w, _) in counters.items()}
    _, on_card = _since(before, counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = eng.stats()
    eng.close()
    sites = check_no_new_sites("decode lane", eng._dec_prog, eng._pf_prog)
    if any(len(o) != 32 for o in outs):
        raise AssertionError(f"wrong token counts {[len(o) for o in outs]}")
    runs = stats["prefill_chunks"] + stats["steps"] + warmed
    seen = 2 * warmed if capture else runs
    for k, got in launches.items():
        each = counters[k][1] * cfg.num_layers
        if (got, on_card[k]) != (each * seen, each * runs):
            raise AssertionError(
                f"{k}: {got} launches (wrappers), {on_card[k]} on the card, "
                f"expected {counters[k][1]} x {cfg.num_layers} x {seen} and "
                f"x {runs} program runs ({warmed} at the warmup)")
    gen = sum(len(o) for o in outs)
    prompt_tokens = sum(len(p) for p in prompts)
    figures = dict(
        wall_s=wall, generated_tokens_per_s=gen / wall,
        total_tokens_per_s=(gen + prompt_tokens) / wall,
        prefill_chunks=stats["prefill_chunks"], decode_steps=stats["steps"],
        decode_step_ms=_ms_quantiles(eng.step_seconds),
        prefill_chunk_ms=_ms_quantiles(eng.prefill_seconds),
        evictions=stats["evictions"], peak_memory_gb=peak_gb,
        peak_over_start_gb=peak_gb - start / 1e9, launches=launches,
        device_launches=on_card, new_pass_sites=sites)
    if int8_weights:
        figures["int8_weights"] = stats["int8_weights"]
    if capture:
        figures["capture_s"] = _capture_seconds(eng._exe, eng._dec_prog,
                                                eng._pf_prog)
        figures["graph_pools_gb"] = graph_pools_gb()
    return outs, figures, eng.pool.modeled_bytes()


def run_path(dev, counters, pool_dtype="float32"):
    """The decode lane at full width over a ``pool_dtype`` KV pool,
    captured (the main path) and then eager on a copy of the weights:
    the same ids.  ``counters`` maps each kernel the run reads to the
    launches it must make per layer per program run (1 on the path, 0
    off it)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    cfg = _model_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    lens, prompts = _lane_workload(cfg)
    modes, ids = {}, {}
    for m, capture in MODES:
        ids[m], modes[m], pool_bytes = _serve_lane(
            cfg, _copy_scope(scope), prompts, counters, pool_dtype, capture)
        torch.cuda.empty_cache()
    if ids["captured"] != ids["eager"]:
        raise AssertionError(f"{pool_dtype} decode lane: captured and eager "
                             f"ids differ")
    path = dict(pool_dtype=pool_dtype, pool_bytes=pool_bytes,
                requests=len(prompts), prompt_tokens=int(sum(lens)),
                generated_tokens=sum(len(o) for o in ids["captured"]),
                captured_eager_ids_equal=True, modes=modes,
                launches=_summed({m: r["launches"]
                                  for m, r in modes.items()}),
                device_launches=_summed({m: r["device_launches"]
                                         for m, r in modes.items()}))
    return cfg, scope, prompts, ids["captured"], path


def profile_decode_step(cfg, scope, steps=5, pool_dtype="float32",
                        int8_weights=False):
    """Host wall time vs summed device kernel time of decode steps of
    each mode (torch.profiler), launch API calls and the paged attention
    kernels' device time a step: slot 0 active at positions 65-69, the
    other seven slots on the trash page.  The two modes' logprobs of
    every step bit-equal."""
    out, logp = {}, {}
    for m, capture in MODES:
        torch.cuda.reset_peak_memory_stats()
        lane = Lane(cfg, _gpu_place(), _copy_scope(scope), 8, 16, 1024, 32,
                    pool_dtype, capture=capture, int8_weights=int8_weights)
        got = lane.prefill(list(range(1, 65)))
        got.append(lane.decode(5, 64))
        pos = iter(range(65, 65 + 2 * steps))
        r = _profile(lambda: got.append(lane.decode(5, next(pos))), steps,
                     match="paged")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            got.append(lane.decode(5, next(pos)))
        torch.cuda.synchronize()
        r["step_wall_ms"] = 1e3 * (time.perf_counter() - t0) / steps
        r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if capture:
            r["capture_s"] = _capture_seconds(lane.exe, lane.pf, lane.dec)
        out[m], logp[m] = r, got
        del lane
        torch.cuda.empty_cache()
    if not all(np.array_equal(a, b) for a, b in zip(logp["captured"],
                                                    logp["eager"])):
        raise AssertionError(f"{pool_dtype} decode step: captured and eager "
                             f"logprobs differ")
    out["logprobs_bit_equal"] = len(logp["captured"])
    return out


def _lane_engine(cfg, scope, prompts, pool_dtype, name):
    """A fresh DecodeEngine of the decode lane on a copy of ``scope``,
    warmed up (its programs captured), that queues all of ``prompts``."""
    from paddle_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(cfg, scope=_copy_scope(scope), place=_gpu_place(),
                       pool_slots=8, page_size=16, max_len=1024,
                       pool_dtype=pool_dtype, auto_start=False,
                       max_queue=len(prompts), name=name)
    eng.warmup()
    return eng


def _drive_lane(eng, prompts):
    """Every request queued before the scheduler starts; the ids."""
    futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.start()
    return [f.result(timeout=900) for f in futs]


def profile_lane_paged(cfg, scope, prompts, pool_dtype="float32",
                       one_split=False):
    """The paged kernels' summed device time over one whole run of the
    decode lane's workload (``run_path``'s requests on a fresh engine,
    warmed up first; torch.profiler), and the ids it generated.  With
    ``one_split`` the wrapper (K5's, or K7's over the int8 pool) plans a
    single split: the kernel's form before the split, through the same
    C entry; the plan is set before the engine's warmup, where its
    programs are captured."""
    from paddle_tpu_torch.kernels.primitives import paged

    form = "one" if one_split else "split"
    plan = paged.split_plan
    if one_split:
        paged.split_plan = lambda b, n, t, d, max_pages, *a: \
            paged.SplitPlan(max_pages, 1, None, 0)
    outs = []
    try:
        eng = _lane_engine(cfg, scope, prompts, pool_dtype,
                           f"lane-{pool_dtype}-{form}")
        try:
            prof = _profile(lambda: outs.extend(_drive_lane(eng, prompts)),
                            1, match="paged")
        finally:
            eng.close()
    finally:
        paged.split_plan = plan
    return dict(one_split=one_split,
                paged_device_ms=prof["paged_device_ms"],
                paged_events=prof["paged_events"],
                device_busy_ms=prof["device_busy_ms"],
                wall_profiled_ms=prof["wall_profiled_ms"]), outs


def lane_paged_bound(cfg, scope, prompts, pool_dtype):
    """The paged kernel's least device time over one whole lane run: a
    run of its own (unprofiled, eager: the recorder reads each call's
    q_start on the host, which a capture cannot) records each call's
    shapes and q_start values, and each call's bytes (``_paged_bound``,
    or ``_paged_quant_bound`` over the int8 pool: the live K/V rows, q
    and out moved once) are summed at the HBM rate.  The decode ops
    reach the wrappers through their module reference, which the run
    points at a recorder (the wrappers themselves, and their launch
    counts, stay as they are)."""
    import types

    from paddle_tpu_torch.ops import decode_ops

    name = ("paged_attention_quant" if pool_dtype == "int8"
            else "paged_attention")
    bound = _paged_quant_bound if pool_dtype == "int8" else _paged_bound
    kernels, calls = decode_ops._paged, []

    def recording(q, pool, *args, **kw):
        calls.append((q.shape, pool.shape[1], args[-1].tolist()))
        return getattr(kernels, name)(q, pool, *args, **kw)

    with capture_mode(False):
        eng = _lane_engine(cfg, scope, prompts, pool_dtype,
                           f"bound-{pool_dtype}")
    decode_ops._paged = types.SimpleNamespace(
        paged_attention=kernels.paged_attention,
        paged_attention_quant=kernels.paged_attention_quant)
    setattr(decode_ops._paged, name, recording)
    try:
        _drive_lane(eng, prompts)
    finally:
        decode_ops._paged = kernels
        eng.close()
    byts = sum(bound(*shape, page, q_start)[2]
               for shape, page, q_start in calls)
    return dict(calls=len(calls), bytes=byts,
                bound_ms=_bound(byts, 0)[0])


# the paged kernel's lane runs, one split (True) and split (False) in
# turns: two runs, over the lane's first LANE_REQUESTS requests (of 8
# to 512 prompt tokens, within one wave of its 8 pool slots), which
# keeps the whole script inside its time
LANE_ORDER = (True, False)
LANE_REQUESTS = 4


def lane_in_turns(cfg, scope, prompts, outs, pool_dtype="float32"):
    """The paged kernel (K5, or K7 over the int8 pool) over the decode
    lane's first LANE_REQUESTS requests, captured, one split and split
    in turns (LANE_ORDER): summed device ms of the paged kernels a run,
    whether each run's ids equal the main path's, and the run's
    bound."""
    prompts, outs = prompts[:LANE_REQUESTS], outs[:LANE_REQUESTS]
    runs = []
    for one in LANE_ORDER:
        r, got = profile_lane_paged(cfg, scope, prompts, pool_dtype,
                                    one_split=one)
        r["ids_equal_main_path"] = got == outs
        runs.append(r)
    if not all(r["ids_equal_main_path"] for r in runs):
        raise AssertionError(f"{pool_dtype} lane in turns: ids differ from "
                             f"the main path's: {runs}")

    def mean(one):
        rs = [r for r in runs if r["one_split"] == one]
        return sum(r["paged_device_ms"] for r in rs) / len(rs)

    return dict(split_ms=mean(False), one_split_ms=mean(True),
                runs=runs, bound=lane_paged_bound(cfg, scope, prompts,
                                                  pool_dtype))


def _copy_scope(scope):
    from paddle_tpu_torch import fluid

    out = fluid.Scope()
    for n in scope.keys():
        if not n.startswith("@KVPOOL@"):
            out.set(n, scope.get(n))
    return out


def run_parity(cfg, scope, prompts, outs, pool_dtype="float32",
               int8_weights=False):
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.serving import DecodeEngine

    main, names = _param_names(cfg)
    cpu_scope = fluid.Scope()
    convert.load_params(cpu_scope,
                        {n: scope.get(n).cpu().numpy() for n in names},
                        fluid.CPUPlace(), program=main)
    rng = np.random.RandomState(SEED + 1)
    tokens = rng.randint(1, cfg.vocab_size, 40).tolist()
    lanes = {"gpu": Lane(cfg, _gpu_place(), _copy_scope(scope), 2, 16,
                         1024, 32, pool_dtype, int8_weights=int8_weights),
             "cpu": Lane(cfg, fluid.CPUPlace(), cpu_scope, 2, 16, 1024, 32,
                         pool_dtype, int8_weights=int8_weights)}
    res = {}
    for k, lane in lanes.items():
        chunks = lane.prefill(tokens)
        nxt = int(np.argmax(chunks[-1]))
        res[k] = chunks + [lane.decode(nxt, len(tokens))]
    logp_err = max(float(np.abs(a - b).max())
                   for a, b in zip(res["gpu"], res["cpu"]))
    if not logp_err < PATH_LOGP_ATOL:
        raise AssertionError(f"card vs CPU logprobs: max abs err {logp_err} "
                             f">= {PATH_LOGP_ATOL}")

    # greedy ids of the two shortest requests, card vs CPU
    order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:2]
    eng = DecodeEngine(cfg, scope=cpu_scope, place=fluid.CPUPlace(),
                       pool_slots=2, page_size=16, max_len=1024,
                       pool_dtype=pool_dtype, int8_weights=int8_weights,
                       name="cpu-parity")
    try:
        cpu_outs = eng.generate([prompts[i] for i in order],
                                max_new_tokens=32, timeout=900)
    finally:
        eng.close()
    cpu_lane = lanes["cpu"]
    ids = []
    for i, cpu_ids in zip(order, cpu_outs):
        gpu_ids = outs[i]
        k = next((j for j, (a, b) in enumerate(zip(gpu_ids, cpu_ids))
                  if a != b), None)
        entry = dict(request=i, prompt_tokens=len(prompts[i]),
                     first_mismatch=k)
        if k is not None:
            # allowed only at a near-tie: the CPU's top-two gap there must
            # be below the logprob tolerance
            lp = cpu_lane.prefill(prompts[i] + gpu_ids[:k])[-1]
            top2 = np.sort(lp)[-2:]
            gap = float(top2[1] - top2[0])
            entry["top2_gap"] = gap
            if not gap < PATH_LOGP_ATOL:
                raise AssertionError(
                    f"request {i}: greedy ids differ at step {k} with a "
                    f"top-two gap {gap} >= {PATH_LOGP_ATOL}")
        ids.append(entry)
    return dict(pool_dtype=pool_dtype, int8_weights=int8_weights,
                logprob_max_abs_err=logp_err, logprob_atol=PATH_LOGP_ATOL,
                greedy=ids)


# ---------------------------------------------------------------------------
# phases 10-11: the ragged serving.Engine lane over a saved inference
# model, both arms, and its CPU parity (phases 8-9 are phases 6-7 over
# the int8 pool)
# ---------------------------------------------------------------------------

# the repo's ragged-serving model at its "base" size (bench.py :985-1017)
RAGGED_VOCAB, RAGGED_HIDDEN, RAGGED_HEADS, RAGGED_LAYERS = 8192, 256, 8, 4
RAGGED_SEQ_BUCKETS = [32, 64, 128]
RAGGED_WAVE = (20, 50, 90, 126)  # two requests of each length a wave
RAGGED_BATCH = 2 * len(RAGGED_WAVE)
RAGGED_WAVES = 10
# card vs CPU scores: 4 layers of fp32 products summed in other orders
RAGGED_SCORE_ATOL = 1e-4


def save_ragged_model(dirname):
    """Build the ragged scorer with the port's front end (ids [-1, -1]
    int64, lens [-1] int32; a causal ragged_attention per layer), give it
    seeded random weights and save it with save_inference_model."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import layers as L

    head_dim = RAGGED_HIDDEN // RAGGED_HEADS
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.data("ids", [-1, -1], False, dtype="int64")
        lens = fluid.data("lens", [-1], False, dtype="int32")
        x = L.embedding(ids, size=[RAGGED_VOCAB, RAGGED_HIDDEN])
        for _ in range(RAGGED_LAYERS):
            qkv = [L.reshape(L.fc(x, size=RAGGED_HIDDEN, num_flatten_dims=2),
                             shape=[0, 0, RAGGED_HEADS, head_dim])
                   for _ in range(3)]
            q, k, v = [L.transpose(t, perm=[0, 2, 1, 3]) for t in qkv]
            ctx = L.ragged_attention(q, k, v, lens, causal=True)
            ctx = L.reshape(L.transpose(ctx, perm=[0, 2, 1, 3]),
                            shape=[0, 0, RAGGED_HIDDEN])
            x = L.elementwise_add(x, L.fc(ctx, size=RAGGED_HIDDEN,
                                          num_flatten_dims=2))
        score = L.reshape(L.reduce_mean(x, dim=[1, 2]), shape=[-1, 1])
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ["ids", "lens"], [score], exe,
                                  main_program=main, scope=scope)
    return score.name


def ragged_waves(n_waves):
    """The traffic: waves of two requests of each RAGGED_WAVE length,
    seeded; the first wave primes."""
    rng = np.random.RandomState(SEED + 2)
    return [[{"ids": rng.randint(1, RAGGED_VOCAB, (1, ln)).astype(np.int64),
              "lens": np.full((1,), ln, np.int32)}
             for ln in RAGGED_WAVE for _ in range(2)]
            for _ in range(n_waves)]


def _serve_rows(model, kind):
    from paddle_tpu_torch.observability import metrics

    fam = metrics.snapshot().get("pt_serve_rows_total")
    return fam["samples"].get((model, kind), 0.0) if fam else 0.0


def run_ragged_arm(model_dir, fetch, ragged, place, waves, counter=None,
                   capture=True):
    """One Engine arm serving ``waves`` (the first primes), its programs
    captured (on the card, at the warmup) or, without ``capture``, run
    by the eager loop.  Returns the served scores of every request and
    the arm's figures; with a ``counter`` (K6's wrapper) its launches
    are zeroed before the arm, and on the card K6 must launch 4 x the
    batches the arm executed, warmup included, and the wrapper 4 x the
    eager ones (the warmup's warm-up runs and captures on the captured
    engine, every batch on the eager one)."""
    from paddle_tpu_torch import serving

    name = "ragged" if ragged else "bucketed"
    if counter is not None:
        counter.launches = 0
        before = _snap()
    eng = serving.Engine(batch_buckets=[RAGGED_BATCH],
                         seq_buckets=RAGGED_SEQ_BUCKETS, max_wait_ms=5,
                         auto_start=False, name=f"smoke_{name}_{capture}",
                         place=place)
    try:
        with capture_mode(capture):  # the model's predictor's executor
            eng.load_model(name, model_dir, ragged=ragged)
        warmed = eng.warmup()[name]
        eng.start()

        def wave(feeds):
            # the wave's requests reach the scheduler together (its
            # lock is re-entrant): a host stall between two submits
            # would otherwise let max_wait split a full wave and pad it
            with eng._lanes[name]._cv:
                futs = [eng.submit(name, f) for f in feeds]
            return [float(f.result(timeout=300)[fetch].reshape(-1)[0])
                    for f in futs]

        def cold():
            return eng.stats()["models"][name]["executable_cache"]["cold"]

        scores = [wave(waves[0])]
        pad0, real0 = _serve_rows(name, "padding"), _serve_rows(name, "real")
        cold0 = cold()
        on_card = place.torch_device().type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wave_s = []
        for feeds in waves[1:]:
            t1 = time.perf_counter()
            scores.append(wave(feeds))
            wave_s.append(time.perf_counter() - t1)
        dt = time.perf_counter() - t0
        timed = len(waves) - 1
        arm = dict(arm=name, capture=capture, warmed_shapes=warmed,
                   real_tokens_per_s=timed * 2 * sum(RAGGED_WAVE) / dt,
                   timed_waves=timed, wall_s=dt,
                   wave_ms=_ms_quantiles(wave_s) if wave_s else None,
                   real_rows=int(_serve_rows(name, "real") - real0),
                   padding_rows=int(_serve_rows(name, "padding") - pad0),
                   steady_state_cold=int(cold() - cold0))
        if on_card:
            pred = eng._lanes[name].predictor
            arm["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            arm["capture_s"] = _capture_seconds(pred._exe, pred._program)
            arm["graph_pools_gb"] = graph_pools_gb()
            arm["graphs"] = sum(h.graph is not None for h in
                                pred._exe.compiled_for(pred._program))
        prof = None
        if counter is not None:  # one more wave, under the profiler
            prof = _profile(lambda: wave(waves[1]), 1,
                            match="ragged_fwd_kernel", device_only=True)
            if prof["device_busy_ms"]:
                prof["device_idle_share"] = (1 - prof["device_busy_ms"]
                                             / prof["wall_profiled_ms"])
        stats = eng.stats()["models"][name]
    finally:
        eng.close()
    arm.update(batches=stats["batches"],
               warmup_batches=stats["warmup_batches"],
               executable_cache=stats["executable_cache"])
    if counter is not None:
        _, on_card = _since(before, ("ragged_attention",))
        arm["launches"] = counter.launches
        arm["device_launches"] = on_card["ragged_attention"]
        executed = stats["batches"] + stats["warmup_batches"]
        seen = 2 * stats["warmup_batches"] if capture else executed
        if (counter.launches, arm["device_launches"]) != (
                RAGGED_LAYERS * seen, RAGGED_LAYERS * executed):
            raise AssertionError(
                f"{name} arm: ragged_attention launched {counter.launches} "
                f"times (wrapper) and {arm['device_launches']} on the card, "
                f"expected {RAGGED_LAYERS} x {seen} and x {executed} "
                f"batches")
        arm["profile_one_wave"] = prof
    return scores, arm


def run_ragged_path(counter):
    """Both arms on the card, then each against a CPUPlace engine on the
    same saved model and requests."""
    import tempfile

    from paddle_tpu_torch import fluid

    waves = ragged_waves(1 + RAGGED_WAVES)
    arms, parity = {}, {}
    with tempfile.TemporaryDirectory(prefix="pt_ragged_model_") as d:
        fetch = save_ragged_model(d)
        for ragged in (True, False):
            scores, arm = run_ragged_arm(d, fetch, ragged, _gpu_place(),
                                         waves, counter)
            name = arm["arm"]
            if not np.isfinite(scores).all():
                raise AssertionError(f"{name} arm: non-finite scores")
            if ragged and (arm["warmed_shapes"] != 1
                           or arm["steady_state_cold"] != 0
                           or arm["padding_rows"] != 0):
                raise AssertionError(f"ragged arm: {arm}")
            eager_scores, eager = run_ragged_arm(
                d, fetch, ragged, _gpu_place(), waves, counter,
                capture=False)
            graphs = (arm.get("graphs"), eager.get("graphs"))
            if graphs != (1 if ragged else len(RAGGED_SEQ_BUCKETS), 0):
                raise AssertionError(f"{name} arm: the captured and the "
                                     f"eager engine hold {graphs} graphs")
            if eager_scores != scores:
                raise AssertionError(f"{name} arm: captured and eager "
                                     f"scores differ")
            arm["eager"] = eager
            arm["captured_eager_scores_equal"] = True
            arms[name] = arm
            cpu_scores, _ = run_ragged_arm(d, fetch, ragged,
                                           fluid.CPUPlace(), waves[:1])
            err = float(np.abs(np.asarray(scores[0])
                               - np.asarray(cpu_scores[0])).max())
            if not err < RAGGED_SCORE_ATOL:
                raise AssertionError(f"{name} arm: card vs CPU scores differ "
                                     f"by {err} >= {RAGGED_SCORE_ATOL}")
            parity[name] = dict(score_max_abs_err=err,
                                atol=RAGGED_SCORE_ATOL,
                                requests=len(scores[0]))
    return arms, parity


def wave_readings(arms):
    """Each Engine arm's profiled wave, captured and eager: device busy
    time and events, the launch API calls, and K6's share of them."""
    keys = ("device_busy_ms", "device_events", "wall_profiled_ms",
            "device_idle_share", "launch_api_calls",
            "ragged_fwd_kernel_device_ms", "ragged_fwd_kernel_events")
    out = {}
    for name, a in arms.items():
        for mode, arm in (("captured", a), ("eager", a.get("eager"))):
            if arm is not None:
                prof = arm["profile_one_wave"]
                out[f"{name}_{mode}"] = {k: prof[k] for k in keys
                                         if k in prof}
    return out


# ---------------------------------------------------------------------------
# phases 14-16: the default graph passes on the unfused BERT-base step
# (fuse_attention sends the composed attention to K1-K3), the predictor
# over a saved unfused BERT-base encoder, and the decode lane with int8
# weights
# ---------------------------------------------------------------------------

# (arm, FLAGS_graph_passes): the reference's passes A/B rung
PASS_ARMS = (("on", "default"), ("off", "none"))
AB_WARMUP, AB_STEPS = 2, 6
# the passes the train, decode, Engine and dp paths must not match (they
# are built fused, or run paged and ragged attention)
NEW_PASSES = ("fuse_attention", "fuse_softmax_cross_entropy")
PRED_BATCH, PRED_SEQ, PRED_RUNS = 8, 128, 10
# the predictor with the passes on vs off, fp32: K1's tiles against
# cuBLAS's products, 12 layers deep
PRED_ATOL = 1e-4


@contextlib.contextmanager
def graph_passes(spec):
    """FLAGS_graph_passes = ``spec`` inside: a program's passes are
    chosen at its first run, and every run reads the flag again (a
    changed selection warns and rewrites nothing)."""
    from paddle_tpu_torch import fluid

    old = fluid.get_flags("FLAGS_graph_passes")
    fluid.set_flags({"FLAGS_graph_passes": spec})
    try:
        yield
    finally:
        fluid.set_flags(old)


def check_no_new_sites(what, *programs):
    """The paths of phases 1-13 match none of this slice's passes."""
    for p in programs:
        sites = {e["pass"]: e["sites"]
                 for e in getattr(p, "_pass_report", None) or ()}
        hit = {k: sites[k] for k in NEW_PASSES if sites.get(k)}
        if hit:
            raise AssertionError(f"{what}: the passes matched {hit}")
    return {k: 0 for k in NEW_PASSES}


def _unfused_base(**kw):
    """BertConfig.base as the reference's passes A/B rung builds it
    (bench.py:1298-1316): no flash attention, no dropout."""
    from paddle_tpu_torch.models import bert

    return bert.BertConfig.base(vocab_size=30528, attn_dropout=0.0,
                                hidden_dropout=0.0, use_flash_attention=False,
                                **kw)


def _no_launches(names):
    return dict.fromkeys(names, 0)


def run_passes_ab(counters):
    """Unfused BERT-base, b128 s128, bf16 policy, Adam: a program an arm
    (passes on and off), each run by the captured and the eager
    executor, all four in turns from one starting state.  On arm: the
    pass report reads 12 attention sites (12 with a key bias) and 13
    bias-GeLU sites, and every run launches K1-K4 as phase 4's step;
    off arm: none.  Each arm's captured and eager losses and state
    bit-equal."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = _unfused_base()
    progs = {a: _bert_program(cfg, bf16=True) for a, _ in PASS_ARMS}
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(progs["on"][1], scope=scope)
    scopes = {(a, m): _clone_scope(scope) for a, _ in PASS_ARMS
              for m, _ in MODES}
    del scope
    exes = {a: _executors() for a, _ in PASS_ARMS}
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    per_run = {"on": _train_step_launches(cfg),
               "off": _no_launches(counters)}
    cells = [(a, spec, m) for a, spec in PASS_ARMS for m, _ in MODES]
    losses = {c[::2]: [] for c in cells}
    secs = {c[::2]: [] for c in cells}
    peak = {c[::2]: 0 for c in cells}
    transient = {c[::2]: 0 for c in cells}
    pools = {}
    launches = {a: {m: {} for m, _ in MODES} for a, _ in PASS_ARMS}
    on_card = {a: {m: {} for m, _ in MODES} for a, _ in PASS_ARMS}
    steps = AB_WARMUP + AB_STEPS
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for i in range(steps):
        for a, spec, m in cells:  # in turns
            main, _, loss = progs[a]
            pool0 = graph_pools_gb() if i == 0 else None
            torch.cuda.reset_peak_memory_stats()
            rest = torch.cuda.memory_allocated()
            before = _snap()
            t0 = time.perf_counter()
            with graph_passes(spec):
                (lv,) = exes[a][m].run(main, feed=feed, fetch_list=[loss],
                                       scope=scopes[a, m])
            secs[a, m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[a][m], py)
            _add(on_card[a][m], dev)
            if i == 0 and m == "captured":
                pools[a] = graph_pools_gb() - pool0
            if i >= AB_WARMUP:
                hi = torch.cuda.max_memory_allocated()
                peak[a, m] = max(peak[a, m], hi)
                transient[a, m] = max(transient[a, m], hi - rest)
            losses[a, m].append(float(lv))
    out = {}
    for a, spec in PASS_ARMS:
        main = progs[a][0]
        _gate_launches(f"passes {a}", launches[a], on_card[a], per_run[a],
                       steps, 1)
        types = [op.type for op in main.global_block().ops]
        report = getattr(main, "_pass_report", None)
        if a == "on":
            sites = {e["pass"]: (e["sites"], e.get("bias_sites"))
                     for e in report}
            want = {"fuse_attention": (12, 12),
                    "fuse_bias_act_dropout": (13, None),
                    "fuse_softmax_cross_entropy": (0, None)}
            if sites != want or types.count("flash_attention") != 12 \
                    or types.count("flash_attention_grad") != 12:
                raise AssertionError(f"passes on: report {sites}, "
                                     f"{types.count('flash_attention')} "
                                     f"flash_attention ops")
        elif report is not None or "flash_attention" in types:
            raise AssertionError("passes off: the program was rewritten")
        for m, _ in MODES:
            if not all(np.isfinite(losses[a, m])) \
                    or not losses[a, m][-1] < losses[a, m][0]:
                raise AssertionError(f"passes {a} {m}: losses not finite "
                                     f"and falling: {losses[a, m]}")
        diff = _scope_diff(scopes[a, "captured"], scopes[a, "eager"])
        if losses[a, "captured"] != losses[a, "eager"] or diff:
            raise AssertionError(f"passes {a}: captured and eager differ: "
                                 f"state {diff[:5]}")
        modes = {}
        for m, _ in MODES:
            timed = np.asarray(secs[a, m][AB_WARMUP:])
            modes[m] = dict(
                step_p50_ms=1e3 * float(np.percentile(timed, 50)),
                step_p95_ms=1e3 * float(np.percentile(timed, 95)),
                tokens_per_s=(TRAIN_BATCH * TRAIN_SEQ * AB_STEPS
                              / float(timed.sum())),
                first_step_s=secs[a, m][0],
                peak_memory_gb=peak[a, m] / 1e9,
                step_transient_gb=transient[a, m] / 1e9,
                launches=launches[a][m], device_launches=on_card[a][m])
        modes["captured"]["graph_pool_gb"] = pools[a]
        out[a] = dict(flags=spec, pass_report=report, ops=len(types),
                      losses=losses[a, "captured"],
                      captured_eager_bit_equal=True, modes=modes,
                      launches=_summed(launches[a]),
                      device_launches=_summed(on_card[a]))
    rel = max(abs(x - y) / abs(y) for x, y in zip(
        losses["on", "captured"], losses["off", "captured"]))
    path = dict(model="BertConfig.base(vocab_size=30528, "
                "use_flash_attention=False, dropout 0)",
                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, dtype_policy="bf16",
                steps=AB_STEPS, warmup_steps=AB_WARMUP, arms=out,
                on_off_loss_max_rel_diff_bf16=rel)
    state = dict(progs=progs, exes=exes, scopes=scopes, feed=feed)
    return state, path


def profile_passes_ab(state):
    """One profiled step of each arm in each mode: device busy, idle,
    events, launch API calls and the top device kernels."""
    out = {}
    for a, spec in PASS_ARMS:
        main, _, loss = state["progs"][a]
        for m, _ in MODES:
            exe, scope = state["exes"][a][m], state["scopes"][a, m]

            def step():
                exe.run(main, feed=state["feed"], fetch_list=[loss],
                        scope=scope)

            with graph_passes(spec):
                r = _profile(step, 1)
            out[f"{a}_{m}"] = {k: r[k] for k in (
                "device_busy_ms", "device_idle_share", "wall_profiled_ms",
                "device_events", "launch_api_calls", "top_device_us")
                if k in r}
    return out


def run_passes_parity(counters):
    """Full width, 2 layers, b8 s128, fp32, 3 Adam steps on the card,
    passes on against off from one state: losses within 1e-4 relative;
    on the card K1 4, K2 2, K3 2, K4 3 a step on arm, none off arm."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = _unfused_base(num_layers=2)
    progs = {a: _bert_program(cfg, bf16=False) for a, _ in PASS_ARMS}
    start = fluid.Scope()
    fluid.Executor(_gpu_place()).run(progs["on"][1], scope=start)
    feed = bert.make_fake_batch(cfg, 8, 128, seed=1)
    want = {"on": _train_step_launches(cfg), "off": _no_launches(counters)}
    losses, on_card = {}, {}
    for a, spec in PASS_ARMS:
        main, _, loss = progs[a]
        scope = _clone_scope(start)
        exe = fluid.Executor(_gpu_place())
        before = _snap()
        with graph_passes(spec):
            losses[a] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]) for _ in range(3)]
        on_card[a] = _since(before, counters)[1]
        if on_card[a] != _times(want[a], 3):
            raise AssertionError(f"passes parity {a}: {on_card[a]} on the "
                                 f"card, expected 3 x {want[a]}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses["on"],
                                                  losses["off"]))
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"passes parity: losses {losses}, max rel diff "
                             f"{rel} >= {TRAIN_LOSS_RTOL}")
    return dict(losses=losses, loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, device_launches=on_card)


def save_unfused_encoder(dirname, model_format="json"):
    """BERT-base's encoder built unfused (is_test: no dropout), seeded
    random weights made on the card, saved with save_inference_model
    (``model_format="protobuf"``: Fluid's binary ``__model__`` and one
    combined LoDTensor stream, ``__params__``)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = _unfused_base()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds = [fluid.data(n, [-1, -1], False, dtype=dt)
                 for n, dt in (("src_ids", "int64"), ("pos_ids", "int64"),
                               ("sent_ids", "int64"),
                               ("input_mask", "float32"))]
        enc = bert.bert_encoder(*feeds, cfg, is_test=True)
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(
        dirname, [f.name for f in feeds], [enc], exe, main_program=main,
        scope=scope, model_format=model_format,
        params_filename="__params__" if model_format == "protobuf" else None)
    feed = bert.make_fake_batch(cfg, PRED_BATCH, PRED_SEQ, seed=2)
    return cfg, {f.name: feed[f.name] for f in feeds}


def run_predictor_path(counters):
    """The saved unfused BERT-base encoder through the port's
    AnalysisPredictor on the card, b8 s128 fp32: a predictor an arm
    (passes on and off) and mode (captured and eager), all four run in
    turns.  On arm: 12 flash_attention ops in the loaded program, K1 and
    K4 12 a run on the card, K2/K3 none; off arm: none.  Captured equal
    to eager, on within 1e-4 of off.  A profiled run of each gives the
    device busy time and K1's device time and kernels a run."""
    import tempfile

    from paddle_tpu_torch import inference as inf

    cells = [(a, spec, m, c) for a, spec in PASS_ARMS for m, c in MODES]
    layers = 12
    per_run = {"on": {**_no_launches(counters), "flash_fwd": layers,
                      "fused_bias_act": layers},
               "off": _no_launches(counters)}
    with tempfile.TemporaryDirectory(prefix="pt_unfused_bert_") as d:
        cfg, feed = save_unfused_encoder(d)
        tensors = [inf.PaddleTensor(v, name=k) for k, v in feed.items()]
        preds = {}
        for a, spec, m, capture in cells:
            with graph_passes(spec), capture_mode(capture):
                preds[a, m] = inf.create_paddle_predictor(
                    inf.AnalysisConfig(d), place=_gpu_place())
    outs = {c[::2]: [] for c in cells}
    secs = {c[::2]: [] for c in cells}
    peak = {c[::2]: 0 for c in cells}
    launches = {a: {m: {} for m, _ in MODES} for a, _ in PASS_ARMS}
    on_card = {a: {m: {} for m, _ in MODES} for a, _ in PASS_ARMS}
    for w in counters.values():
        w.launches = 0
    runs = 1 + PRED_RUNS
    for i in range(runs):
        for a, spec, m, _ in cells:
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            with graph_passes(spec):
                (out,) = preds[a, m].run(tensors)
            secs[a, m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[a][m], py)
            _add(on_card[a][m], dev)
            peak[a, m] = max(peak[a, m], torch.cuda.max_memory_allocated())
            outs[a, m].append(out.as_ndarray())
    result = {}
    for a, spec in PASS_ARMS:
        _gate_launches(f"predictor {a}", launches[a], on_card[a],
                       per_run[a], runs, 1)
        types = [op.type for op in preds[a, "captured"]._program
                 .global_block().ops]
        if types.count("flash_attention") != (layers if a == "on" else 0):
            raise AssertionError(f"predictor {a}: "
                                 f"{types.count('flash_attention')} "
                                 f"flash_attention ops")
        ref = outs[a, "captured"][0]
        if ref.shape != (PRED_BATCH, PRED_SEQ, cfg.hidden_size) \
                or not np.isfinite(ref).all():
            raise AssertionError(f"predictor {a}: output {ref.shape}")
        if not all(np.array_equal(ref, o) for m, _ in MODES
                   for o in outs[a, m]):
            raise AssertionError(f"predictor {a}: runs or modes differ")
        modes = {}
        for m, _ in MODES:
            timed = np.asarray(secs[a, m][1:])
            with graph_passes(spec):
                prof = _profile(lambda: preds[a, m].run(tensors), 1,
                                match="flash_fwd")
            modes[m] = dict(
                run_p50_ms=1e3 * float(np.percentile(timed, 50)),
                run_p95_ms=1e3 * float(np.percentile(timed, 95)),
                first_run_s=secs[a, m][0], peak_memory_gb=peak[a, m] / 1e9,
                launches=launches[a][m], device_launches=on_card[a][m],
                k1_device_ms=prof["flash_fwd_device_ms"],
                k1_kernels=prof["flash_fwd_events"],
                **{k: prof[k] for k in ("device_busy_ms",
                                        "device_idle_share",
                                        "launch_api_calls") if k in prof})
        result[a] = dict(flags=spec, flash_attention_ops=types.count(
            "flash_attention"), ops=len(types), modes=modes,
            launches=_summed(launches[a]),
            device_launches=_summed(on_card[a]))
    err = float(np.abs(outs["on", "captured"][0]
                       - outs["off", "captured"][0]).max())
    if not err < PRED_ATOL:
        raise AssertionError(f"predictor: passes on vs off differ by {err} "
                             f">= {PRED_ATOL}")
    preds.clear()
    return dict(model="BertConfig.base(vocab_size=30528) encoder, unfused",
                batch=PRED_BATCH, seq_len=PRED_SEQ, dtype="float32",
                runs=PRED_RUNS, on_off_max_abs_err=err, atol=PRED_ATOL,
                captured_eager_equal=True, arms=result)


def int8w_at_rest(cfg, scope):
    """``torch.cuda.memory_allocated()`` an engine adds at rest (its
    pool and its own copy of the weights), with fp32 weights and with
    int8 weights, built on a private copy of ``scope``'s tensors so the
    fp32 originals do not count; and what the pass and the conversion
    report."""
    from paddle_tpu_torch.serving import DecodeEngine

    out = {}
    for key, int8 in (("fp32_weights", False), ("int8_weights", True)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        eng = DecodeEngine(cfg, scope=_clone_scope(scope), place=_gpu_place(),
                           pool_slots=8, page_size=16, max_len=1024,
                           int8_weights=int8, auto_start=False,
                           name=f"rest-{key}")
        torch.cuda.synchronize()
        out[f"{key}_at_rest_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
        out["pool_gb"] = eng.pool.modeled_bytes() / 1e9
        if int8:
            out.update(eng.int8_weights)
        eng.close()
        del eng
    out["measured_saving_gb"] = (out["fp32_weights_at_rest_gb"]
                                 - out["int8_weights_at_rest_gb"])
    return out


def run_int8w_path(counters, fp32_outs):
    """Phase 6's decode lane with int8 weights (DecodeEngine(...,
    int8_weights=True)), captured then eager on copies of the same
    weights: the same ids; K4 and K5 12 a program run on the card.  The
    ids that agree with the fp32-weight lane's (``fp32_outs``) are
    counted, not gated: random full-width weights can flip a near-tie."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    cfg = _model_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    lens, prompts = _lane_workload(cfg)
    rest = int8w_at_rest(cfg, scope)
    modes, ids = {}, {}
    for m, capture in MODES:
        ids[m], modes[m], _ = _serve_lane(
            cfg, _copy_scope(scope), prompts, counters, "float32", capture,
            int8_weights=True)
        torch.cuda.empty_cache()
    if ids["captured"] != ids["eager"]:
        raise AssertionError("int8-weight decode lane: captured and eager "
                             "ids differ")
    agree = [sum(a == b for a, b in zip(x, y))
             for x, y in zip(ids["captured"], fp32_outs)]
    path = dict(int8_weights=True, requests=len(prompts),
                prompt_tokens=int(sum(lens)), at_rest=rest,
                generated_tokens=sum(len(o) for o in ids["captured"]),
                captured_eager_ids_equal=True,
                ids_equal_to_fp32_weight_lane=dict(
                    requests=sum(a == 32 for a in agree),
                    tokens=int(sum(agree)), of=32 * len(prompts)),
                modes=modes,
                launches=_summed({m: r["launches"]
                                  for m, r in modes.items()}),
                device_launches=_summed({m: r["device_launches"]
                                         for m, r in modes.items()}))
    return cfg, scope, prompts, ids["captured"], path


# ---------------------------------------------------------------------------
# phases 17-18: GPT-2 small causal-LM training (causal K1-K3 at S 1024,
# global-norm clipping, AdamW's decoupled weight decay), and its CPU parity
# with every optimizer of the training front end
# ---------------------------------------------------------------------------

GPT_BATCH, GPT_SEQ = 8, 1024
GPT_WARMUP, GPT_STEPS = 2, 10
GPT_UNFUSED_WARMUP, GPT_UNFUSED_STEPS = 2, 3
# the usual GPT-2 pretraining recipe (Radford et al. 2019; the
# Megatron and nanoGPT settings): AdamW, beta2 0.95, decoupled weight
# decay 0.1, the gradients' global norm clipped at 1.0
GPT_LR, GPT_BETA2, GPT_WEIGHT_DECAY, GPT_CLIP_NORM = 6e-4, 0.95, 0.1, 1.0
# card vs CPU, fp32, 2 steps (phase 5's rules): losses within 1e-4
# relative; for Adam's family the parameters within 3 x lr max and 1e-6
# mean abs difference (an element's update is at most about lr in size,
# and its sign can follow a gradient that is zero up to the two BLAS
# libraries' rounding); for the other optimizers, whose steps scale with
# the gradient, each parameter's change within 1e-3 of its norm.  A leaf
# whose gradient sits at the rounding floor (DP_GRAD_FLOOR of the median
# leaf's RMS: the attention key biases, whose true gradient is 0) has no
# direction to hold and is printed only
GPT_PARITY_STEPS = 2
GPT_CHANGE_RTOL = 1e-3
# the parity runs' batch and sequence: the recipe's, then each optimizer's
GPT_PARITY_SHAPE, GPT_PARITY_OPT_SHAPE = (2, 1024), (2, 256)


def gpt_config(**kw):
    """GPT-2 small (Radford et al. 2019, the 124M model; ``bench.py``'s
    gpt-base): vocab 50304 (50257 padded to a multiple of 64), hidden
    768, 12 layers, 12 heads, FFN 3072, 1024 positions, hidden dropout
    0.1, causal flash attention."""
    from paddle_tpu_torch.models import gpt

    d = dict(vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
             intermediate_size=3072, max_position=1024, hidden_dropout=0.1,
             use_flash_attention=True)
    d.update(kw)
    return gpt.GPTConfig(**d)


def gpt_train_flops_per_step(cfg, batch, seq):
    """Model FLOPs of one training step (forward and backward, 6 a
    multiply-add of the weights), T = batch x seq tokens: 6·T·(12·L·H² +
    V·H) for the layers' and the tied head's matmuls, plus 6·L·T·S·H for
    the causal attention's two products (half of the S x S pairs)."""
    t, L, h = batch * seq, cfg.num_layers, cfg.hidden_size
    return 6 * t * (12 * L * h * h + cfg.vocab_size * h) \
        + 6 * L * t * seq * h


def _gpt_program(cfg, bf16, make_opt=None):
    """build_gpt_lm with ``make_opt(fluid)`` minimizing it (default: the
    recipe's AdamW with the global-norm clip); returns (main, startup,
    loss, the clip's global-norm var name or None)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import gpt

    if make_opt is None:
        def make_opt(fl):
            return fl.optimizer.AdamW(
                learning_rate=GPT_LR, beta2=GPT_BETA2,
                weight_decay=GPT_WEIGHT_DECAY,
                grad_clip=fl.clip.GradientClipByGlobalNorm(GPT_CLIP_NORM))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss = gpt.build_gpt_lm(cfg)
        make_opt(fluid).minimize(loss)
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    norms = [op.outputs["Out"][0] for op in main.global_block().ops
             if op.type == "sqrt" and op.attrs.get("op_role") == "backward"]
    return main, startup, loss, (norms[0] if norms else None)


def _gpt_step_launches(cfg):
    """{kernel: launches} of one GPT train step: K1 twice a layer (the
    forward and the derived grad's recompute), K2 and K3 once, K4 once a
    layer (the FFN's bias + GeLU; no MLM head)."""
    L = cfg.num_layers
    return {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "fused_bias_act": L}


def _gpt_feed(cfg, batch, seq, seed=0):
    from paddle_tpu_torch.models import gpt

    return gpt.make_fake_lm_batch(cfg, batch, seq, seed=seed)


def run_gpt_train_path(counters):
    """GPT-2 small, b8 s1024, bf16 policy with fp32 masters, AdamW with
    the global-norm clip, hidden dropout 0.1, on the card: the captured
    and the eager executor in turns from the same state and feed,
    GPT_WARMUP + GPT_STEPS steps each.  Each mode's launches exact (on
    the card and in the wrappers); the two modes' losses, global norms
    and final state bit-equal; the losses finite and falling, the global
    norm finite at every step."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.observability import profiling

    cfg = gpt_config()
    main, startup, loss, gnorm = _gpt_program(cfg, bf16=True)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    feed = _gpt_feed(cfg, GPT_BATCH, GPT_SEQ)
    steps = GPT_WARMUP + GPT_STEPS
    losses = {m: [] for m in exes}
    norms = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for _ in range(steps):
        for m, exe in exes.items():  # in turns
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            lv, nv = exe.run(main, feed=feed, fetch_list=[loss, gnorm],
                             scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)  # the fetch syncs
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append(float(lv))
            norms[m].append(float(np.asarray(nv).reshape(())))
    total = {k: w.launches for k, w in counters.items()}
    _gate_launches("gpt train path", launches, on_card,
                   _gpt_step_launches(cfg), steps, 1)
    sites = check_no_new_sites("gpt train path", main)
    report = {e["pass"]: e["sites"] for e in main._pass_report}
    loss_c, norm_c = losses["captured"], norms["captured"]
    if not all(np.isfinite(loss_c)) or not loss_c[-1] < loss_c[0]:
        raise AssertionError(f"gpt train path losses not finite and "
                             f"falling: {loss_c}")
    if not all(np.isfinite(norm_c)):
        raise AssertionError(f"gpt train path: global norms {norm_c}")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or norms["captured"] \
            != norms["eager"] or diff:
        raise AssertionError(f"gpt train path: captured and eager differ: "
                             f"losses {losses}, norms {norms}, state "
                             f"{diff[:5]}")
    tokens = GPT_BATCH * GPT_SEQ
    flops = gpt_train_flops_per_step(cfg, GPT_BATCH, GPT_SEQ)
    _, peak_flops, _, _ = profiling.device_peaks()
    modes = {}
    for m in exes:
        timed = np.asarray(secs[m][GPT_WARMUP:])
        modes[m] = dict(
            tokens_per_s=tokens * GPT_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * float(np.percentile(timed, 50)),
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=secs[m][0],
            mfu=flops / float(np.median(timed)) / peak_flops,
            peak_memory_gb=peak[m] / 1e9, launches=launches[m],
            device_launches=on_card[m])
    held = [h.graph for h in exes["captured"].compiled_for(main)]
    if held == [None]:
        raise AssertionError("gpt train path: the captured executor holds "
                             "no graph")
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"], main)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    types = [op.type for op in main.global_block().ops]
    path = dict(model="GPTConfig(vocab 50304, hidden 768, 12 layers, 12 "
                "heads, FFN 3072, 1024 positions, hidden dropout 0.1, "
                "flash)", batch=GPT_BATCH, seq_len=GPT_SEQ,
                dtype_policy="bf16",
                optimizer=f"AdamW(lr {GPT_LR}, beta2 {GPT_BETA2}, weight "
                f"decay {GPT_WEIGHT_DECAY}), GradientClipByGlobalNorm("
                f"{GPT_CLIP_NORM})", steps=GPT_STEPS,
                warmup_steps=GPT_WARMUP, losses=loss_c, global_norms=norm_c,
                clip_engaged_steps=sum(n > GPT_CLIP_NORM for n in norm_c),
                captured_eager_bit_equal=True, model_flops_per_step=flops,
                mfu_peak_flops=peak_flops, ops=len(types),
                clip_ops={t: types.count(t) for t in (
                    "squared_l2_norm", "sqrt", "clip", "elementwise_div",
                    "elementwise_mul", "fill_constant")},
                pass_report=report, modes=modes, launches=total,
                device_launches=_summed(on_card), new_pass_sites=sites)
    state = dict(exes=exes, main=main, scopes=scopes, feed=feed,
                 fetch=[loss, gnorm])
    return state, path


def run_gpt_unfused(counters):
    """The same configuration built unfused (use_flash_attention=False:
    matmul, softmax_mask_fuse_upper_triangle, matmul a layer), the
    default passes on, GPT_UNFUSED_WARMUP + GPT_UNFUSED_STEPS steps
    captured: the pass report reads 12 fuse_attention sites, all causal,
    and K1-K4 launch the flash build's counts a step."""
    from paddle_tpu_torch import fluid

    cfg = gpt_config(use_flash_attention=False)
    main, startup, loss, gnorm = _gpt_program(cfg, bf16=True)
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    feed = _gpt_feed(cfg, GPT_BATCH, GPT_SEQ)
    per = _gpt_step_launches(cfg)
    steps = GPT_UNFUSED_WARMUP + GPT_UNFUSED_STEPS
    losses, norms, secs = [], [], []
    torch.cuda.synchronize()
    before = _snap()
    for _ in range(steps):
        t0 = time.perf_counter()
        lv, nv = exe.run(main, feed=feed, fetch_list=[loss, gnorm],
                         scope=scope)
        secs.append(time.perf_counter() - t0)
        losses.append(float(lv))
        norms.append(float(np.asarray(nv).reshape(())))
    got, on_card = _since(before, counters)
    report = {e["pass"]: e for e in main._pass_report}
    att = report["fuse_attention"]
    types = [op.type for op in main.global_block().ops]
    want = (_times(per, 2), _times(per, steps))
    if (att["sites"], att.get("causal_sites"), att.get("bias_sites")) \
            != (cfg.num_layers, cfg.num_layers, 0) \
            or types.count("flash_attention") != cfg.num_layers \
            or "softmax_mask_fuse_upper_triangle" in types \
            or (got, on_card) != want:
        raise AssertionError(f"gpt unfused: report {att}, launches {got} "
                             f"(wrappers) and {on_card} (on the card) vs "
                             f"{want}")
    if not all(np.isfinite(losses + norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt unfused: losses {losses}, global norms "
                             f"{norms}")
    timed = np.asarray(secs[GPT_UNFUSED_WARMUP:])
    return dict(model="GPTConfig as phase 17, use_flash_attention=False",
                pass_report=main._pass_report, losses=losses,
                global_norms=norms,
                step_p50_ms=1e3 * float(np.percentile(timed, 50)),
                launches=got, device_launches=on_card)


def profile_gpt_step(state):
    """One train step of each mode under torch.profiler (the path's own
    fetches, so the captured step replays its graph): device busy and
    idle, the launch API calls and the top device kernels."""
    out = {}
    for m, exe in state["exes"].items():
        out[m] = _profile(lambda: exe.run(
            state["main"], feed=state["feed"], fetch_list=state["fetch"],
            scope=state["scopes"][m]), 1)
    return out


def _run_startup(exe, startup, scope, loaded=None):
    """Run ``startup`` on ``scope``; with ``loaded`` (the names the
    caller loads right after), less the ops that write only those (their
    random initializers: a 2-layer GPT's 50 M draws a parity case on the
    CPU).  The other ops draw nothing, so what is left is the same."""
    if loaded:
        prog = startup.clone()
        block = prog.global_block()
        block.ops = [op for op in block.ops
                     if not set(op.output_arg_names) <= set(loaded)]
        prog._bump_version()
        startup = prog
    exe.run(startup, scope=scope)


def _gpt_parity_run(cfg, place, feed, init, make_opt, steps):
    """``steps`` fp32 steps of the GPT program minimized by
    ``make_opt(fluid)`` on ``place`` from ``init`` (None: the startup's,
    returned).  Returns the losses, ``init``, the parameters after the
    run and, with ``grads``, each parameter's first-step gradient."""
    from paddle_tpu_torch import convert, fluid

    main, startup, loss, _ = _gpt_program(cfg, bf16=False,
                                          make_opt=make_opt)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    _run_startup(exe, startup, scope, init)
    if init is None:
        init = {p.name: scope.get(p.name).cpu().numpy().copy()
                for p in main.all_parameters()}
    else:
        convert.load_params(scope, init, place, program=main)
    grads = dict(main._params_grads)
    losses, first = [], None
    for i in range(steps):
        fetch = [loss] + (list(grads.values()) if i == 0 else [])
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        if i == 0:
            first = {p: np.asarray(g, np.float64)
                     for p, g in zip(grads, out[1:])}
    final = {n: scope.get(n).cpu().numpy().astype(np.float64)
             for n in init}
    return losses, init, final, first


def _gpt_parity_cases():
    """Phase 18's parities: (name, (batch, seq), make_opt, Adam's family,
    lr) of the recipe and of every optimizer of GPT_PARITY_OPTIMIZERS."""
    return [("adamw_global_norm_clip", GPT_PARITY_SHAPE, None, True,
             GPT_LR)] + [(name, GPT_PARITY_OPT_SHAPE, make, family, lr)
                         for name, (make, family, lr)
                         in GPT_PARITY_OPTIMIZERS.items()]


def gpt_cpu_child(dirname, half=None):
    """The CPU reference child's part for phase 18: the parities' one
    starting state, the 2-layer GPT's parameters after its startup on
    the CPU, into ``gpt.init`` (the optimizers add no parameter, so it
    is every case's); then every case's run on a CPUPlace executor from
    it, its losses, each leaf's first-gradient RMS and its parameters
    after the run into ``gpt.<case>``.  ``half`` 0 or 1: every other
    case (from the first or the second), half 1 reading ``gpt.init``
    once half 0 has written it (two processes of the child)."""
    from paddle_tpu_torch import fluid

    cfg = gpt_config(num_layers=2, hidden_dropout=0.0)
    if half == 1:
        init = _wait_child_result(dirname, "gpt.init")
    else:
        main, startup, _, _ = _gpt_program(cfg, bf16=False)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        init = {p.name: scope.get(p.name).numpy().copy()
                for p in main.all_parameters()}
        _child_result(dirname, "gpt.init", **init)
    cases = _gpt_parity_cases()
    for name, shape, make, _, _ in (cases if half is None
                                    else cases[half::2]):
        feed = _gpt_feed(cfg, *shape, seed=1)
        try:
            losses, _, final, grads = _gpt_parity_run(
                cfg, fluid.CPUPlace(), feed, init, make, GPT_PARITY_STEPS)
        finally:
            fluid.clip.set_gradient_clip(None)
        meta = dict(losses=losses, g_rms={n: _rms(g)
                                          for n, g in grads.items()})
        _child_result(dirname, f"gpt.{name}", __meta__=np.array(
            json.dumps(meta)), **{n: v.astype(np.float32)
                                  for n, v in final.items()})


def _gpt_parity(cfg, init, child, name, batch, seq, make_opt, adam_family,
                lr):
    """One card-vs-CPU parity reading (see GPT_PARITY_STEPS), the CPU's
    run from the CPU reference child."""
    feed = _gpt_feed(cfg, batch, seq, seed=1)
    gl, _, gpu, _ = _gpt_parity_run(cfg, _gpu_place(), feed, init,
                                    make_opt, GPT_PARITY_STEPS)
    z = child.take(f"gpt.{name}")
    meta = json.loads(str(z["__meta__"]))
    cl, cpu = meta["losses"], {n: z[n].astype(np.float64) for n in init}
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"gpt parity: losses {gl} (card) vs {cl} "
                             f"(CPU), max rel diff {rel}")
    # Adam's family: each element's update at most lr in size, its sign
    # following a gradient that may be zero up to rounding; the others:
    # each leaf's change against its norm
    checks = ((("max_abs", 3 * lr), ("mean_abs", TRAIN_PARAM_MEAN_ATOL))
              if adam_family else (("change_rel", GPT_CHANGE_RTOL),))
    return dict(losses_gpu=gl, losses_cpu=cl, loss_max_rel_diff=rel,
                **_update_gates("gpt parity", _update_readings(
                    init, gpu, cpu, None, g_rms=meta["g_rms"]), checks))


def _f64(a):
    """``a`` (numpy) as a float64 tensor where the readings compute: on
    the card (the embeddings hold up to 54 M elements a leaf), or on
    the CPU where no card is seen (the CPU reference child)."""
    return torch.as_tensor(np.asarray(a)).to(
        "cuda" if torch.cuda.is_available() else "cpu").double()


def _rms(g):
    return float(_f64(g).square().mean().sqrt())


def _norm(t):
    return float(torch.linalg.vector_norm(t))


def _update_readings(init, gpu, cpu, grads, init_gpu=None, g_rms=None):
    """Each parameter's update in a card run (``gpu``, from ``init_gpu``,
    default ``init``) against the CPU's (``cpu``, from ``init``), on
    every leaf whose first gradient's RMS (from ``grads``, or ``g_rms``
    given) is at least DP_GRAD_FLOOR of the median leaf's.  Returns the
    counts and each reading's worst leaf (max_abs, mean_abs, and
    change_rel: the difference of the updates over the norm of the
    CPU's)."""
    if g_rms is None:
        g_rms = {n: _rms(g) for n, g in grads.items()}
    median = float(np.median(list(g_rms.values())))
    init_gpu = init if init_gpu is None else init_gpu
    leaves = {}
    for n, p in gpu.items():
        up = _f64(p) - _f64(init_gpu[n])
        uc = _f64(cpu[n]) - _f64(init[n])
        d = (up - uc).abs()
        leaves[n] = dict(
            grad_rms_to_median=g_rms[n] / median,
            held=g_rms[n] >= DP_GRAD_FLOOR * median,
            max_abs=float(d.max()), mean_abs=float(d.mean()),
            change_rel=_norm(up - uc) / max(_norm(uc), 1e-30))
    held = {n: r for n, r in leaves.items() if r["held"]}
    worst = {}
    for key in ("max_abs", "mean_abs", "change_rel"):
        name = max(held, key=lambda n: held[n][key])
        worst[key] = dict(leaf=name, **held[name])
    return dict(leaves=len(leaves), leaves_held=len(held), worst_held=worst,
                floor_leaves=sorted(set(leaves) - set(held)))


def _update_gates(what, readings, checks):
    """``readings`` (_update_readings) with each (reading, bound) of
    ``checks`` held on its worst leaf; raises on the first one over."""
    worst = readings["worst_held"]
    for key, tol in checks:
        worst[key]["tol"] = tol
        if not worst[key][key] <= tol:
            raise AssertionError(f"{what}: {key} {worst[key][key]} > {tol} "
                                 f"on leaf {worst[key]['leaf']}: {worst}")
    return readings


def _adam_l2_value_clip(fl):
    """Adam with L2Decay and GradientClipByValue set as every
    parameter's clip (``set_gradient_clip``: the caller clears it)."""
    fl.clip.set_gradient_clip(fl.clip.GradientClipByValue(1e-3))
    return fl.optimizer.Adam(TRAIN_LR,
                             regularization=fl.regularizer.L2Decay(1e-2))


# {name: (make_opt(fluid), Adam's family, lr)}: every optimizer the
# training front end adds, and Adam with L2Decay and GradientClipByValue;
# Adam's family at phase 5's lr
GPT_PARITY_OPTIMIZERS = {
    "LarsMomentum": (lambda fl: fl.optimizer.LarsMomentum(0.1, 0.9), False,
                     0.1),
    "Adagrad": (lambda fl: fl.optimizer.Adagrad(0.01), False, 0.01),
    "Adamax": (lambda fl: fl.optimizer.Adamax(TRAIN_LR), True, TRAIN_LR),
    "DecayedAdagrad": (lambda fl: fl.optimizer.DecayedAdagrad(0.01), False,
                       0.01),
    "Adadelta": (lambda fl: fl.optimizer.Adadelta(1.0), False, 1.0),
    "RMSProp": (lambda fl: fl.optimizer.RMSProp(1e-3, momentum=0.9), False,
                1e-3),
    "Ftrl": (lambda fl: fl.optimizer.Ftrl(0.1, l1=1e-4, l2=1e-4), False,
             0.1),
    "Lamb": (lambda fl: fl.optimizer.Lamb(TRAIN_LR), True, TRAIN_LR),
    "Adam+L2Decay+ClipByValue": (_adam_l2_value_clip, True, TRAIN_LR),
}


def run_gpt_parity(child):
    """2 layers at full width (hidden 768, vocab 50304), fp32, dropout
    0: the recipe's AdamW with the global-norm clip at b2 s1024, then
    each optimizer of the training front end at b2 s256, 2 steps on the
    card and on a CPUPlace executor (in the CPU reference ``child``)
    from the same parameters (the child's CPU startup)."""
    from paddle_tpu_torch import fluid

    cfg = gpt_config(num_layers=2, hidden_dropout=0.0)
    init = child.take("gpt.init")
    out = {}
    for name, shape, make, adam_family, lr in _gpt_parity_cases():
        try:
            out[name] = dict(batch_seq=shape, lr=lr, **_gpt_parity(
                cfg, init, child, name, *shape, make, adam_family, lr))
        finally:
            fluid.clip.set_gradient_clip(None)
    return out


# ---------------------------------------------------------------------------
# phase 19: the serving fleet
# ---------------------------------------------------------------------------

FLEET_CLIENTS = 4          # client threads posting /v1/generate
FLEET_NEW_TOKENS = 32      # phase 6's budget a request
FLEET_KILL_AFTER = 4       # decode steps of the loaded failover run
FLEET_HEDGE_REQUESTS = 12
FLEET_CHILD_PROMPT = 512   # the SIGTERM child's one request
FLEET_CHILD_NEW = 200
FLEET_CHILD_KILL_AT = 16   # decode steps of it before the SIGTERM
# the reference's top-level keys of each page
FLEET_PAGE_KEYS = {
    "/healthz": ["draining", "frontend", "ok"],
    "/routerz": ["failovers", "hedge_ms", "hedges", "replicas", "retries",
                 "retry_times", "router"],
    "/servez": ["decode", "engines", "reqtrace"],
}

# The SIGTERM drill in a child process (the counterpart of the JAX
# package's test_frontend_sigterm_drain_completes_inflight_subprocess):
# one replica of phase 6's weights behind a Frontend with install_drain;
# SIGTERM lands once FLEET_CHILD_KILL_AT decode steps of the one request
# ran.  The child prints its one-replica baseline, the HTTP response,
# and /healthz as polled after the signal.
_FLEET_CHILD = r"""
import json, os, signal, threading, time, urllib.error, urllib.request
import numpy as np
import chip_smoke as cs
from paddle_tpu_torch import fluid, serving
from paddle_tpu_torch.models import gpt

place = cs._gpu_place()
cfg = cs._model_config()
plen, new = cs.FLEET_CHILD_PROMPT, cs.FLEET_CHILD_NEW
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
startup.random_seed = cs.SEED
scope = fluid.Scope()
fluid.Executor(place).run(startup, scope=scope)
eng = serving.DecodeEngine(cfg, scope=scope, place=place, pool_slots=8,
                           page_size=16, max_len=1024, auto_start=False,
                           name="child")
eng.warmup()
eng.start()
prompt = np.random.RandomState(cs.SEED + 7).randint(
    1, cfg.vocab_size, plen).tolist()
base = eng.generate([prompt], new, timeout=600)[0]
fe = serving.Frontend(eng)
fe.install_drain(timeout=300, poll_s=0.02)
url = f"http://{fe.host}:{fe.port}"
out = {"baseline": base}


def client():
    req = urllib.request.Request(
        url + "/v1/generate",
        data=json.dumps({"prompt": prompt, "max_new_tokens": new}).encode())
    with urllib.request.urlopen(req, timeout=600) as resp:
        out["status"] = resp.status
        out["tokens"] = json.loads(resp.read())["tokens"]


t = threading.Thread(target=client)
steps0 = eng.stats()["steps"]
t.start()
at = steps0 + cs.FLEET_CHILD_KILL_AT
while eng.stats()["steps"] < at and t.is_alive():
    time.sleep(0.0005)
out["steps_at_signal"] = eng.stats()["steps"] - steps0
os.kill(os.getpid(), signal.SIGTERM)
health = []
deadline = time.monotonic() + 60
while time.monotonic() < deadline:
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
            health.append(r.status)
    except urllib.error.HTTPError as e:
        health.append(e.code)
        if e.code == 503:
            break
    except OSError:
        health.append("closed")
        break
    time.sleep(0.002)
t.join(timeout=600)
out["healthz"] = health
out["steps_total"] = eng.stats()["steps"] - steps0
out["engine_draining"] = eng.stats()["draining"]
out["device"] = str(place.torch_device())
eng.close()
print("FLEET_CHILD " + json.dumps(out), flush=True)
"""


def _http(url, payload=None, timeout=600):
    """(status, body) of a GET (``payload`` None) or a JSON POST; the
    body parsed as JSON where it is JSON, else text."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def _generate_quantiles(reqtrace, n):
    """``reqtrace.request_quantiles``' latency / TTFT / TPOT p50 and p99
    over the completed traces whose root is ``generate`` (the ring also
    holds the /v1/infer request sent beside them), by its nearest-rank
    rule; there must be ``n``."""
    traces = [t for t in reqtrace.completed()
              if t["name"] == "generate" and t["status"] == "ok"]
    if len(traces) != n:
        raise AssertionError(f"fleet: {len(traces)} completed generate "
                             f"traces, expected {n}")
    out = {"count": len(traces)}
    for key in ("latency_s", "ttft_s", "tpot_s"):
        vs = sorted(t[key] for t in traces if t[key] is not None)
        out[key] = {f"p{int(q * 100)}": vs[min(int(q * (len(vs) - 1)
                                                   + 0.5), len(vs) - 1)]
                    for q in (0.5, 0.99)} if vs else None
    return out


def run_fleet_child():
    """Step 7 of phase 19: the SIGTERM drill in a child process."""
    t0 = time.perf_counter()
    p = take_warm_child("fleet").start(_FLEET_CHILD, [])
    out, err = p.communicate(timeout=600)
    proc = subprocess.CompletedProcess(p.args, p.returncode, out, err)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("FLEET_CHILD ")]
    if not lines:
        raise AssertionError(f"fleet SIGTERM child rc={proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    got = json.loads(lines[-1][len("FLEET_CHILD "):])
    tokens, base = got.pop("tokens", None), got.pop("baseline")
    got.update(returncode=proc.returncode, seconds=time.perf_counter() - t0,
               tokens_equal_baseline=tokens == base,
               tokens=len(tokens or ()))
    if not (got.get("status") == 200 and tokens == base
            and 503 in got["healthz"] and got["engine_draining"]
            and 0 < got["steps_at_signal"] < got["steps_total"]
            and got["device"].startswith("cuda")
            and proc.returncode in (0, -signal.SIGTERM)):
        raise AssertionError(f"fleet SIGTERM child: {got}")
    return got


def run_fleet_path(counters):
    """Phase 19 (see the module docstring): two DecodeEngine replicas of
    GPTConfig() and the ragged Engine behind a Router and a Frontend on
    127.0.0.1, driven over HTTP.  ``counters``: the wrappers of K4, K5,
    K6 and K7, set to 0 before the fleet is built and read after it is
    closed.  Returns the phase's readings; every step is gated."""
    import concurrent.futures as cf
    import tempfile

    from paddle_tpu_torch import fluid, serving
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.observability import exposition, reqtrace
    from paddle_tpu_torch.serving import drill, promote

    t_phase = time.perf_counter()
    place = _gpu_place()
    cfg = _model_config()
    out = {}
    for w in counters.values():
        w.launches = 0
    before = _snap()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope0 = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope0)
    scope1 = fluid.Scope()  # replica 1's: replica 0's arrays, copied
    for p in main.all_parameters():
        scope1.set(p.name, scope0.get(p.name).clone())
    reps = [serving.DecodeEngine(
        cfg, scope=s, place=place, pool_slots=8, page_size=16,
        max_len=min(1024, cfg.max_position), auto_start=False,
        name=f"replica{i}", max_queue=64, drain_on_sigterm=False)
        for i, s in enumerate((scope0, scope1))]
    for r in reps:  # both programs of both captured before either starts
        r.warmup()
    for r in reps:
        r.start()
    r0, r1 = reps
    tmp = tempfile.TemporaryDirectory(prefix="pt_fleet_model_")
    fetch = save_ragged_model(tmp.name)
    eng = serving.Engine(batch_buckets=[RAGGED_BATCH],
                         seq_buckets=RAGGED_SEQ_BUCKETS, max_wait_ms=5,
                         auto_start=False, name="fleet_engine", place=place)
    eng.load_model("scorer", tmp.name, ragged=True)
    eng.warmup()
    eng.start()
    router = serving.Router([r0, r1, eng], name="fleet", hedge_ms=0,
                            probe_interval_ms=20)
    fe = serving.Frontend(router)
    pages = exposition.MetricsServer(port=0)
    base = f"http://{fe.host}:{fe.port}"
    pool = cf.ThreadPoolExecutor(FLEET_CLIENTS)
    wave_pool = cf.ThreadPoolExecutor(RAGGED_BATCH)

    def http_generate(prompt, n):
        """A Future of one /v1/generate's tokens (raises on non-200)."""
        def call():
            code, body = _http(f"{base}/v1/generate",
                               {"prompt": prompt, "max_new_tokens": n})
            if code != 200:
                raise AssertionError(f"/v1/generate {code}: {body}")
            return body["tokens"]
        return pool.submit(call)

    def http_infer(model, feed):
        def call():
            code, body = _http(f"{base}/v1/infer", {
                "model": model,
                "feed": {k: v.tolist() for k, v in feed.items()}})
            if code != 200:
                raise AssertionError(f"/v1/infer {code}: {body}")
            return np.asarray(body["outputs"][fetch], np.float32)
        return wave_pool.submit(call)

    try:
        # step 1: phase 6's 16 requests over HTTP from 4 client threads,
        # against a one-replica generate of the same prompts
        lens, prompts = _lane_workload(cfg)
        t0 = time.perf_counter()
        baseline = r0.generate(prompts, FLEET_NEW_TOKENS, timeout=900)
        direct_s = time.perf_counter() - t0
        reqtrace.reset()
        waves = ragged_waves(1 + RAGGED_WAVES)
        # a model the Engine has not run yet, loaded now: its first
        # request captures its graph while decode traffic replays
        eng.load_model("scorer_cold", tmp.name, ragged=True)
        steps0 = r0.stats()["steps"] + r1.stats()["steps"]
        t0 = time.perf_counter()
        futs = [http_generate(p, FLEET_NEW_TOKENS) for p in prompts]
        while (r0.stats()["steps"] + r1.stats()["steps"] < steps0 + 8
               and not all(f.done() for f in futs)):
            time.sleep(0.001)
        live = r0.load() + r1.load()
        if live == 0:
            raise AssertionError("fleet: no decode sequence was live when "
                                 "the cold model's request was sent")
        cold = http_infer("scorer_cold", waves[0][0])
        outs = [f.result(timeout=900) for f in futs]
        http_s = time.perf_counter() - t0
        cold_scores = cold.result(timeout=300)
        warm_scores = eng.infer("scorer", waves[0][0], timeout=300)[fetch]
        quant = _generate_quantiles(reqtrace, len(prompts))
        if outs != baseline:
            raise AssertionError("fleet: HTTP streams differ from the "
                                 "one-replica baseline at requests "
                                 f"{[i for i, (a, b) in enumerate(zip(outs, baseline)) if a != b]}")
        if not np.array_equal(cold_scores, warm_scores):
            raise AssertionError("fleet: the lazily captured model's scores "
                                 "differ from the warm model's")
        gen = sum(len(o) for o in outs)
        # the HTTP path's own cost: one request alone, direct and over
        # HTTP, on the same replica (the router's least-loaded pick)
        t0 = time.perf_counter()
        alone = r1.submit(prompts[0], FLEET_NEW_TOKENS).result(timeout=300)
        alone_direct = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone_http = http_generate(prompts[0], FLEET_NEW_TOKENS).result(300)
        alone_http_s = time.perf_counter() - t0
        if alone != baseline[0] or alone_http != baseline[0]:
            raise AssertionError("fleet: a lone request differs from the "
                                 "baseline")
        out["generate"] = dict(
            requests=len(prompts), prompt_tokens=int(sum(lens)),
            generated_tokens=gen, wall_s=http_s,
            tokens_per_s_http=gen / http_s,
            tokens_per_s_one_replica_direct=gen / direct_s,
            request_quantiles=quant, token_equal_baseline=True,
            lone_request_s={"direct": alone_direct, "http": alone_http_s},
            http_added_ms_per_token=1e3 * (alone_http_s - alone_direct)
            / FLEET_NEW_TOKENS,
            cold_capture_beside_live_decode=dict(
                live_sequences=live, scores_equal_warm_model=True))

        # step 2: canary weight promotion over the two replicas
        # (serving/promote.py): clean under background traffic, then a
        # planted regression rolled back; then the checkpoint's own
        # weights back on both, so the failover drill's baseline holds
        names = [p.name for p in main.all_parameters()]
        saved = promote.capture_weights(scope0, names)

        def program_runs():
            return sum(r.stats()["prefill_chunks"] + r.stats()["steps"]
                       for r in reps)

        runs0, p_before = program_runs(), _snap()
        promo = {}
        for mode in ("clean", "regress"):
            promo[mode] = drill.promotion_drill(
                regress=mode == "regress", engines=[r0, r1],
                timeout_s=900)
            if not promo[mode]["ok"]:
                raise AssertionError(f"fleet promotion drill ({mode}): "
                                     f"{promo[mode]}")
        for r in reps:
            with r._exec_lock:
                saved.apply(r.scope)
        if not all(torch.equal(r.scope.get(n), saved.arrays[n])
                   for r in reps for n in names):
            raise AssertionError("fleet: the checkpoint's weights did not "
                                 "come back")
        _, p_dev = _since(p_before, counters)
        p_runs = program_runs() - runs0
        want_p = {"fused_bias_act": cfg.num_layers * p_runs,
                  "paged_attention": cfg.num_layers * p_runs,
                  "ragged_attention": 0, "paged_attention_quant": 0}
        if p_dev != want_p:
            raise AssertionError(f"fleet promotion: {p_dev} on the card, "
                                 f"expected {want_p}")
        out["promotion"] = dict(
            clean=promo["clean"], regress=promo["regress"],
            promote_s={m: promo[m]["promote_s"] for m in promo},
            weights=len(names), program_runs=p_runs,
            device_launches=p_dev)

        # step 3: the failover drill through the frontend
        fail = drill.failover_drill(
            engines=[r0, r1], prompts=prompts,
            max_new_tokens=FLEET_NEW_TOKENS, kill_after=FLEET_KILL_AFTER,
            baseline=baseline, router=router, submit=http_generate,
            timeout_s=900)
        trace = fail["failed_over_trace"]
        if not fail["ok"] or trace["root"] != "generate":
            raise AssertionError(f"fleet failover drill: {fail}")
        # the printed trace: its spans but the decode-step batch spans,
        # which are counted
        trace["batch_spans"] = sum(k == "batch" for k, _, _ in
                                   trace["spans"])
        trace["spans"] = [sp for sp in trace["spans"] if sp[0] != "batch"]
        out["failover"] = fail

        # step 4: the hedge drill (two Engines of a small MLP, one slow)
        hedge = drill.hedge_drill(n_requests=FLEET_HEDGE_REQUESTS,
                                  place=place)
        if not hedge["ok"]:
            raise AssertionError(f"fleet hedge drill: {hedge}")
        out["hedge"] = hedge

        # step 5: phase 10's waves over /v1/infer against a direct infer
        def direct_wave(feeds):
            fs = [eng.submit("scorer", f) for f in feeds]
            return [f.result(timeout=300)[fetch] for f in fs]

        t0 = time.perf_counter()
        http_scores = [[f.result(timeout=300) for f in
                        [http_infer("scorer", fd) for fd in feeds]]
                       for feeds in waves]
        infer_s = time.perf_counter() - t0
        direct_scores = [direct_wave(feeds) for feeds in waves]
        same = all(a.dtype == b.dtype and np.array_equal(a, b)
                   for hw, dw in zip(http_scores, direct_scores)
                   for a, b in zip(hw, dw))
        if not same or not np.isfinite(np.concatenate(
                [np.ravel(a) for w in http_scores for a in w])).all():
            raise AssertionError("fleet: /v1/infer scores differ from a "
                                 "direct Engine.infer")
        out["infer"] = dict(waves=len(waves),
                            requests=sum(len(w) for w in waves),
                            wall_s=infer_s, scores_bit_equal=True)

        # step 6: the pages
        got = {}
        for path, url in (("/healthz", base), ("/routerz", base),
                          ("/servez", f"http://127.0.0.1:{pages.port}"),
                          ("/metricsz", f"http://127.0.0.1:{pages.port}"),
                          ("/tracez", f"http://127.0.0.1:{pages.port}")):
            code, body = _http(url + path)
            if code != 200:
                raise AssertionError(f"fleet: {path} answered {code}")
            got[path] = body
        for path, keys in FLEET_PAGE_KEYS.items():
            if sorted(got[path]) != keys:
                raise AssertionError(f"fleet: {path} keys {sorted(got[path])}")
        fams = exposition.parse_text(got["/metricsz"])
        need = ("pt_serve_failovers_total", "pt_serve_recovery_seconds",
                "pt_decode_tokens_total", "pt_serve_request_latency_seconds")
        if not all(n in fams for n in need) \
                or not got["/tracez"].startswith("reqtrace"):
            raise AssertionError("fleet: /metricsz or /tracez incomplete")
        out["pages"] = dict(
            answered=sorted(got), routerz_replicas=[
                (r["name"], r["healthy"], r["breaker"])
                for r in got["/routerz"]["replicas"]],
            servez_decode=[d["engine"] for d in got["/servez"]["decode"]],
            metric_families=len(fams))
        stats_engine = eng.stats()["models"]
    finally:
        pool.shutdown(wait=True)
        wave_pool.shutdown(wait=True)
        fe.close()
        router.close()
        pages.stop()
        for r in reps:
            r.close()
        eng.close()
        tmp.cleanup()
    runs = {r.name: r.stats()["prefill_chunks"] + r.stats()["steps"] + 2
            for r in reps}

    # step 7: SIGTERM in a child process
    out["sigterm_child"] = run_fleet_child()

    # step 8: launches, by the wrappers and by the card
    k6_batches = sum(stats_engine[m]["batches"]
                     + stats_engine[m]["warmup_batches"]
                     for m in ("scorer", "scorer_cold"))
    launches = {k: w.launches for k, w in counters.items()}
    per_layer = cfg.num_layers
    want_dev = {"fused_bias_act": per_layer * sum(runs.values()),
                "paged_attention": per_layer * sum(runs.values()),
                "ragged_attention": RAGGED_LAYERS * k6_batches,
                "paged_attention_quant": 0}
    # the wrappers see each captured signature's warm-up and capture:
    # two programs a replica; the scorer's one warmed shape and the cold
    # model's one
    want_py = {"fused_bias_act": per_layer * 2 * 2 * len(reps),
               "paged_attention": per_layer * 2 * 2 * len(reps),
               "ragged_attention": RAGGED_LAYERS * 2 * 2,
               "paged_attention_quant": 0}
    out["launches"] = launches
    out["program_runs"] = runs
    out["engine_batches"] = k6_batches
    _, dev = _since(before, counters)
    out["device_launches"] = dev
    if dev != want_dev or launches != want_py:
        raise AssertionError(
            f"fleet launches: wrappers {launches} (expected {want_py}), "
            f"on the card {dev} (expected {want_dev})")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phases 21-23: the image models (no TPU kernel on their path; K1-K8 must
# launch 0 times)
# ---------------------------------------------------------------------------

RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 128, (3, 224, 224), 1000
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9  # bench.py:431
RESNET_WARMUP, RESNET_STEPS = 2, 8
# card against CPU, fp32: ResNet-50 at b4, 64x64, each step from one
# state (run_resnet_parity says why), at a learning rate whose updates
# stand well above the weights' fp32 rounding (``update_rel_of_norm``
# in the output) and under which the losses still fall over 3 steps
RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE = 4, (3, 64, 64)
RESNET_PARITY_STEPS, RESNET_PARITY_LR = 3, 1e-3
# each step's loss, and each leaf's update (card against CPU, relative
# to the CPU's update).  The update's limit is set from its reading on
# an H100 (4.0e-2 at worst, a BN offset): the step is ill-conditioned
# at this size (``cpu_update_vs_input_1e-6`` in the output: how far a
# relative change of 1e-6 in the input moves the CPU's updates).  A
# zero or wrong grad reads about 1.
RESNET_PARITY_LOSS_RTOL, RESNET_PARITY_CHANGE_RTOL = 1e-4, 0.1
RESNET_PRED_BATCH, RESNET_PRED_RUNS, RESNET_PRED_ATOL = 8, 10, 1e-4
# fp32 training steps at learning rate 0 that bring the moving
# statistics to the batch statistics before the predictor is saved
# (0.9^40: 1.5% of the old statistics left)
RESNET_PRED_CALIB_STEPS = 40
CNN_BATCH, CNN_STEPS = 8, 3
# the ops each label of a profiled ResNet step covers
RESNET_LABELS = {"pt_conv": ("conv2d", "conv2d_grad"),
                 "pt_bn": ("batch_norm", "batch_norm_grad"),
                 "pt_relu": ("relu", "relu_grad"),
                 "pt_momentum": ("momentum",)}


def _image_program(image=None, lr=None, bf16=True, build=None):
    """A training program of ``build`` (default: models.resnet
    ``build_resnet(depth=50)`` at ``image``, RESNET_IMAGE unless given)
    with Momentum(lr, 0.9) (RESNET_LR unless given), under the bf16
    policy where asked; returns (main, startup, loss, prediction)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if build is None:
            _, pred, loss, _ = resnet.build_resnet(
                depth=50, class_dim=RESNET_CLASSES,
                image_shape=image or RESNET_IMAGE)
        else:
            _, pred, loss, _ = build()
        fluid.optimizer.Momentum(learning_rate=lr or RESNET_LR,
                                 momentum=RESNET_MOMENTUM).minimize(loss)
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    return main, startup, loss, pred


def _image_feed(batch, image, classes, seed=0):
    """One synthetic batch as bench.py makes it (RandomState(0))."""
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, *image).astype("float32"),
            "label": rng.randint(0, classes, (batch, 1)).astype("int64")}


def cnn_flops_per_image(program):
    """Forward FLOPs an image of the program's conv2d, depthwise_conv2d
    and mul ops: two per multiply-add, from the ops' shapes (output
    elements x input channels a group x filter taps; rows x columns of
    a product)."""
    block = program.global_block()
    macs = 0
    for op in block.ops:
        if op.attrs.get("op_role", "forward") != "forward":
            continue
        if op.type in ("conv2d", "depthwise_conv2d"):
            w = block.var(op.inputs["Filter"][0]).shape
            out = block.var(op.outputs["Output"][0]).shape
            macs += int(np.prod(out[1:])) * int(np.prod(w[1:]))
        elif op.type == "mul":
            y = block.var(op.inputs["Y"][0]).shape
            macs += int(np.prod(y))
    return 2 * macs


def _state_of(program, kind):
    """Names of the program's BN moving statistics (``stats``) or
    Momentum velocities (``velocity``)."""
    block = program.global_block()
    if kind == "stats":
        return sorted({n for op in block.ops if op.type == "batch_norm"
                       for n in op.inputs["Mean"] + op.inputs["Variance"]})
    return sorted({n for op in block.ops if op.type == "momentum"
                   for n in op.inputs["Velocity"]})


def _cnn_in_turns(main, startup, loss, feed, counters, steps, what,
                  stats_move=False):
    """``steps`` runs of ``main`` in each executor mode in turns from
    one state made on the card by ``startup``: losses, host seconds,
    peak memory a mode; K1-K8 launch 0 times (wrappers and card); the
    modes' losses and whole state (parameters, velocities, moving
    statistics) bit-equal; with ``stats_move``, every moving statistic
    changes at every captured step."""
    from paddle_tpu_torch import fluid

    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    stats = _state_of(main, "stats")
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    unmoved = []
    torch.cuda.synchronize()
    for i in range(steps):
        for m, exe in exes.items():
            prev = ({n: scopes[m].get(n).clone() for n in stats}
                    if stats_move and m == "captured" else None)
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append(float(lv))
            if prev is not None:
                unmoved += [(i, n) for n, t in prev.items()
                            if torch.equal(scopes[m].get(n), t)]
    if any(launches[m] != _no_launches(counters) for m in exes) or any(
            on_card[m] != _no_launches(counters) for m in exes):
        raise AssertionError(f"{what}: K1-K8 launched: {launches} "
                             f"(wrappers), {on_card} (on the card)")
    if not all(np.isfinite(losses["captured"])):
        raise AssertionError(f"{what}: losses not finite: {losses}")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"{what}: captured and eager differ: losses "
                             f"{losses}, state {diff[:5]}")
    if unmoved:
        raise AssertionError(f"{what}: moving statistics unchanged by a "
                             f"captured step: {unmoved[:5]}")
    held = [h.graph for h in exes["captured"].compiled_for(main)]
    if exes["captured"].capture and held == [None]:
        raise AssertionError(f"{what}: the captured executor holds no "
                             f"graph")
    return dict(exes=exes, scopes=scopes, losses=losses, secs=secs,
                peak=peak, launches=launches, on_card=on_card, stats=stats)


def run_resnet_path(counters):
    """Phase 21: ResNet-50 ImageNet training as bench.py:412-452 runs it
    (b128, 3x224x224, 1000 classes, Momentum(0.1, 0.9), the bf16 policy
    with fp32 masters and fp32 BN statistics, one synthetic batch), the
    captured and the eager executor in turns from one state made by the
    startup program, RESNET_WARMUP + RESNET_STEPS steps each."""
    main, startup, loss, pred = _image_program()
    feed = _image_feed(RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES)
    steps = RESNET_WARMUP + RESNET_STEPS
    r = _cnn_in_turns(main, startup, loss, feed, counters, steps,
                      "resnet path", stats_move=True)
    loss_c = r["losses"]["captured"]
    if not loss_c[-1] < loss_c[0]:
        raise AssertionError(f"resnet path: losses not falling: {loss_c}")
    fwd = cnn_flops_per_image(main)
    flops = 3 * fwd * RESNET_BATCH
    types = [op.type for op in main.global_block().ops]
    modes = {}
    for m in r["exes"]:
        timed = np.asarray(r["secs"][m][RESNET_WARMUP:])
        p50 = float(np.median(timed))
        modes[m] = dict(
            images_per_s=RESNET_BATCH * RESNET_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * p50,
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=r["secs"][m][0], mfu=flops / p50 / BF16_TC_FLOPS,
            peak_memory_gb=r["peak"][m] / 1e9, launches=r["launches"][m],
            device_launches=r["on_card"][m])
    modes["captured"]["capture_s"] = _capture_seconds(r["exes"]["captured"],
                                                      main)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    path = dict(
        model="models.resnet.build_resnet(depth=50), bench.py:412-452",
        batch=RESNET_BATCH, image=list(RESNET_IMAGE),
        classes=RESNET_CLASSES, optimizer=f"Momentum({RESNET_LR}, "
        f"{RESNET_MOMENTUM})", dtype_policy="bf16", steps=RESNET_STEPS,
        warmup_steps=RESNET_WARMUP, losses=loss_c,
        captured_eager_bit_equal=True, moving_stats_change_each_step=True,
        ops=len(types), conv2d_ops=types.count("conv2d"),
        batch_norm_ops=types.count("batch_norm"),
        model_flops_per_image_fwd=fwd, model_flops_per_step=flops,
        mfu_formula="2 x multiply-adds of the program's conv2d and mul "
                    "ops a forward image x 3 (forward + two backward "
                    "products) x batch / step p50 / 989 TFLOP/s (bf16 "
                    "dense); bench.py's 4.1e9 a forward image is the "
                    "multiply-add count",
        modes=modes, launches=_summed(r["launches"]),
        device_launches=_summed(r["on_card"]))
    state = dict(exes=r["exes"], scopes=r["scopes"], main=main, feed=feed,
                 loss=loss, pred=pred)
    return state, path


@contextlib.contextmanager
def _op_annotations(labels, cast_label=None):
    """Each op lowering of ``labels`` ({label: op types}) inside a
    record_function range of its label, and the bf16 policy's casts in
    ``cast_label``'s, for one eager profiled step (chip_smoke only: the
    port carries no annotation)."""
    from paddle_tpu_torch.fluid import executor as ex
    from paddle_tpu_torch.fluid import registry

    saved = {}
    for label, types in labels.items():
        for t in types:
            info = registry.get_op(t)
            saved[t] = info.lower

            def annotated(*a, _lower=info.lower, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _lower(*a, **kw)

            info.lower = annotated
    cast = ex._apply_bf16_policy
    if cast_label:
        def cast_annotated(op, vals):
            with torch.profiler.record_function(cast_label):
                return cast(op, vals)

        ex._apply_bf16_policy = cast_annotated
    try:
        yield
    finally:
        ex._apply_bf16_policy = cast
        for t, lower in saved.items():
            registry.get_op(t).lower = lower


def _conv_family(name):
    """The kernel family of a kernel a conv op launched, by its name."""
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "conv_layout_transpose"
    for key in ("dgrad", "wgrad", "fprop"):
        if key in low:
            return f"conv_{key}"
    return "conv_other"


def _families(seq):
    """Device ms and kernel count by family of a labelled kernel
    sequence, with the top kernel names of each."""
    fam = {}
    for name, us, label in seq:
        if label == "pt_conv":
            key = _conv_family(name)
        elif label:
            key = label[3:]
        else:
            key = "other"
        f = fam.setdefault(key, dict(ms=0.0, kernels=0, names={}))
        f["ms"] += us / 1e3
        f["kernels"] += 1
        f["names"][name[:70]] = f["names"].get(name[:70], 0.0) + us / 1e3
    for f in fam.values():
        f["names"] = dict(sorted(f["names"].items(), key=lambda kv: -kv[1])
                          [:3])
    return fam


def profile_resnet_step(state):
    """One ResNet-50 step of each mode profiled
    (:func:`_profile_labelled`), with the device time by kernel family:
    cuDNN's conv forward, dgrad and wgrad, the layout transposes cuDNN
    adds around NCHW, BN, ReLU, Momentum and the bf16 policy's
    casts."""
    out, eager, labelled, unaligned = _profile_labelled(
        state, tuple(RESNET_LABELS) + ("pt_bf16_policy_cast",),
        lambda: _op_annotations(RESNET_LABELS, "pt_bf16_policy_cast"))
    out["families_ms"] = {"eager": _families(eager),
                          "captured": _families(labelled), **unaligned}
    return out


def run_resnet_parity():
    """ResNet-50 in fp32 at b4, 64x64: RESNET_PARITY_STEPS Momentum steps
    at RESNET_PARITY_LR on the card, the port on the CPU taking each
    step from the card's state (parameters, velocities, moving
    statistics): each step's loss within 1e-4, and each parameter's
    and moving statistic's update (after − before: the backward and
    the update ops) within RESNET_PARITY_CHANGE_RTOL of the CPU's
    update.  As both devices start each step from one state, a leaf's
    difference after the step is its update's difference: held to the
    update, not to the leaf's norm, which a BN offset (zero at the
    start) does not have.  Each step starts from one state because the
    step is ill-conditioned at this size (its last batch norms see 16
    values a channel): run freely, the two devices' roundings grow
    about tenfold a step.  The conditioning is read with each step: the
    CPU's step again from the same state with the input scaled by
    1 + 1e-6, its updates against the CPU's.  cuDNN's flags start
    at the library's defaults (TF32 on, benchmark on): the executor
    must turn TF32 off and pick deterministic algorithms itself."""
    from paddle_tpu_torch import convert, fluid

    main, startup, loss, _ = _image_program(
        image=RESNET_PARITY_IMAGE, lr=RESNET_PARITY_LR, bf16=False)
    feed = _image_feed(RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE,
                       RESNET_CLASSES, seed=1)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = True, False, True
    gpu = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=gpu)
    cpu = fluid.Scope()
    cexe = fluid.Executor(fluid.CPUPlace())
    cexe.run(startup, scope=cpu)
    gexe = fluid.Executor(_gpu_place())
    names = sorted({p.name for p in main.all_parameters()}
                   | set(_state_of(main, "stats")))
    persist = sorted(n for n, v in main.global_block().vars.items()
                     if v.persistable and gpu.get(n) is not None)

    def rel(x, y, floor):
        return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), floor,
                                                 1e-30))

    def update_rel(x, y, start):
        # the update floored at 1e-6 of the tensor (fp32 rounds the sum
        # at 6e-8 of it)
        return rel(x - start, y - start, 1e-6 * np.linalg.norm(start))

    nudged = dict(feed, img=feed["img"] * np.float32(1 + 1e-6))
    cpu2 = fluid.Scope()
    cexe.run(startup, scope=cpu2)
    losses = {"card": [], "cpu": []}
    worst, worst_change, updates, nudge = ("", 0.0), ("", 0.0), [], []
    for _ in range(RESNET_PARITY_STEPS):
        start = {n: np.array(gpu.get(n).cpu()) for n in persist}
        convert.load_params(cpu, start, fluid.CPUPlace(), program=main)
        convert.load_params(cpu2, start, fluid.CPUPlace(), program=main)
        losses["card"].append(float(gexe.run(main, feed=feed,
                                              fetch_list=[loss],
                                              scope=gpu)[0]))
        losses["cpu"].append(float(cexe.run(main, feed=feed,
                                             fetch_list=[loss],
                                             scope=cpu)[0]))
        cexe.run(main, feed=nudged, fetch_list=[loss], scope=cpu2)
        for n in names:
            g, c = gpu.get(n).cpu().numpy(), cpu.get(n).numpy()
            worst = max(worst, (n, rel(g, c, 1e-3 * np.sqrt(c.size))),
                        key=lambda t: t[1])
            worst_change = max(worst_change,
                               (n, update_rel(g, c, start[n])),
                               key=lambda t: t[1])
            nudge.append(update_rel(cpu2.get(n).numpy(), c, start[n]))
            if np.linalg.norm(start[n]):
                updates.append(float(np.linalg.norm(c - start[n])
                                     / np.linalg.norm(start[n])))
    flags = dict(allow_tf32=cudnn.allow_tf32,
                 deterministic=cudnn.deterministic,
                 benchmark=cudnn.benchmark,
                 matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    if flags != dict(allow_tf32=False, deterministic=True, benchmark=False,
                     matmul_allow_tf32=False):
        raise AssertionError(f"resnet parity: the executor left cuDNN's "
                             f"flags at {flags}")
    a, b = np.asarray(losses["card"]), np.asarray(losses["cpu"])
    loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
    if not (np.all(np.isfinite(a)) and a[-1] < a[0]
            and loss_rel <= RESNET_PARITY_LOSS_RTOL
            and worst_change[1] <= RESNET_PARITY_CHANGE_RTOL):
        raise AssertionError(f"resnet parity: losses {losses} (max rel "
                             f"{loss_rel}), worst state {worst}, worst "
                             f"update {worst_change}")
    return dict(model="resnet50 fp32", batch=RESNET_PARITY_BATCH,
                image=list(RESNET_PARITY_IMAGE), lr=RESNET_PARITY_LR,
                steps=RESNET_PARITY_STEPS,
                each_step_from_the_cards_state=True, losses=losses,
                loss_max_rel=loss_rel, loss_rtol=RESNET_PARITY_LOSS_RTOL,
                state_worst=list(worst),
                change_worst=list(worst_change),
                change_rtol=RESNET_PARITY_CHANGE_RTOL,
                **{"cpu_update_vs_input_1e-6": dict(
                    median=float(np.median(nudge)),
                    max=float(np.max(nudge)))},
                update_rel_of_norm=dict(
                    median=float(np.median(updates)),
                    min=float(np.min(updates)), max=float(np.max(updates))),
                cudnn_flags_after_run=flags)


def run_resnet_predictor(counters):
    """Phase 22: ResNet-50 saved with save_inference_model (BN in the
    is_test form) from an fp32 program of phase 21's names, with the
    logits and the probabilities as targets, served by AnalysisPredictor
    at b8 fp32 with the default passes, captured and eager in turns on
    the card, then by a predictor on the CPU over the same files: the
    logits within 1e-4 of their largest magnitude, the probabilities
    within 1e-4.  The weights are phase 21's seeded start, its
    moving statistics brought to the batch statistics by
    RESNET_PRED_CALIB_STEPS fp32 steps at learning rate 0, so that the
    logits are of moderate size and the probabilities not saturated:
    at the startup statistics (mean 0, variance 1) the is_test form
    normalizes nothing, and phase 21's ten steps at 0.1 leave its
    statistics far from its weights (logits of 1e7)."""
    import tempfile

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch import inference as inf

    main, startup, loss, pred = _image_program(bf16=False)
    block = main.global_block()
    (logits,) = [block.var(op.inputs["X"][0]) for op in block.ops
                 if op.type == "softmax" and op.outputs["Out"] == [pred.name]]
    scope = fluid.Scope()
    exe = fluid.Executor(_gpu_place())
    exe.run(startup, scope=scope)
    start = {p.name: scope.get(p.name).clone()
             for p in main.all_parameters()}
    for op in block.ops:
        if op.type == "momentum":
            lr = scope.get(op.inputs["LearningRate"][0])
            scope.set(op.inputs["LearningRate"][0], torch.zeros_like(lr))
    calib = _image_feed(RESNET_PRED_BATCH, RESNET_IMAGE, RESNET_CLASSES,
                        seed=3)
    for _ in range(RESNET_PRED_CALIB_STEPS):
        exe.run(main, feed=calib, fetch_list=[loss], scope=scope)
    moved = [n for n, t in start.items() if not torch.equal(scope.get(n), t)]
    if moved:
        raise AssertionError(f"resnet predictor: steps at learning rate 0 "
                             f"changed weights: {moved[:5]}")
    feed = _image_feed(RESNET_PRED_BATCH, RESNET_IMAGE, RESNET_CLASSES,
                       seed=2)["img"]
    tensors = [inf.PaddleTensor(feed, name="img")]
    with tempfile.TemporaryDirectory(prefix="pt_resnet50_") as d:
        fluid.io.save_inference_model(d, ["img"], [logits, pred],
                                      fluid.Executor(_gpu_place()),
                                      main_program=main, scope=scope)
        preds = {}
        for m, c in MODES:
            with capture_mode(c):
                preds[m] = inf.create_paddle_predictor(
                    inf.AnalysisConfig(d), place=_gpu_place())
        cpu = inf.create_paddle_predictor(inf.AnalysisConfig(d),
                                          place=fluid.CPUPlace())
        want = [t.as_ndarray() for t in cpu.run(tensors)]
    bn = [op for op in preds["captured"]._program.global_block().ops
          if op.type == "batch_norm"]
    if len(bn) != 53 or not all(op.attrs["is_test"] for op in bn):
        raise AssertionError("resnet predictor: the saved program's batch "
                             "norms are not in the is_test form")
    outs = {m: [] for m in preds}
    secs = {m: [] for m in preds}
    before = _snap()
    for _ in range(1 + RESNET_PRED_RUNS):
        for m, p in preds.items():
            t0 = time.perf_counter()
            got = p.run(tensors)
            secs[m].append(time.perf_counter() - t0)
            outs[m].append([t.as_ndarray() for t in got])
    py, dev = _since(before, counters)
    if py != _no_launches(counters) or dev != _no_launches(counters):
        raise AssertionError(f"resnet predictor: K1-K8 launched: {py}, "
                             f"{dev}")
    ref = outs["captured"][0]
    if any(r.shape != (RESNET_PRED_BATCH, RESNET_CLASSES)
           or not np.isfinite(r).all() for r in ref):
        raise AssertionError(f"resnet predictor: outputs "
                             f"{[r.shape for r in ref]}")
    if not all(np.array_equal(r, x) for v in outs.values() for o in v
               for r, x in zip(ref, o)):
        raise AssertionError("resnet predictor: runs or modes differ")
    # the logits within 1e-4 of their largest magnitude (at least 1),
    # the probabilities within 1e-4
    top_logit = float(np.abs(want[0]).max())
    errs = [float(np.abs(ref[0] - want[0]).max()) / max(1.0, top_logit),
            float(np.abs(ref[1] - want[1]).max())]
    if not max(errs) <= RESNET_PRED_ATOL:
        raise AssertionError(f"resnet predictor: card vs CPU {errs} > "
                             f"{RESNET_PRED_ATOL} (largest logit "
                             f"{top_logit})")
    top = float(want[1].max(axis=1).mean())
    if not top < 0.99:
        raise AssertionError(f"resnet predictor: the probabilities are "
                             f"saturated (mean top {top})")
    modes = {}
    for m, p in preds.items():
        timed = np.asarray(secs[m][1:])
        prof = _profile(lambda: p.run(tensors), 1)
        modes[m] = dict(run_p50_ms=1e3 * float(np.percentile(timed, 50)),
                        run_p95_ms=1e3 * float(np.percentile(timed, 95)),
                        first_run_s=secs[m][0],
                        **{k: prof[k] for k in ("device_busy_ms",
                                                "device_idle_share",
                                                "launch_api_calls")
                           if k in prof})
    return dict(model="resnet50 inference, save_inference_model",
                batch=RESNET_PRED_BATCH, dtype="float32",
                runs=RESNET_PRED_RUNS, card_cpu_err_logits=errs[0],
                card_cpu_err_probs=errs[1],
                card_cpu_abs_err_logits=float(np.abs(ref[0] - want[0]).max()),
                card_cpu_rel_err_probs=float(np.max(np.abs(ref[1] - want[1])
                                                    / want[1])),
                logits_max_abs=top_logit,
                logits_std=float(want[0].std()), top_prob_mean=top,
                calib_steps=RESNET_PRED_CALIB_STEPS,
                atol=RESNET_PRED_ATOL, captured_eager_equal=True,
                ops=len(preds["captured"]._program.global_block().ops),
                modes=modes, launches=py, device_launches=dev)


def _cnn_models():
    """{name: (builder, image, classes)} of phase 23: the JAX package's
    other image models at their published widths."""
    from paddle_tpu_torch.models import (densenet, googlenet, mlp,
                                         mobilenet, se_resnext, vgg)

    return {
        "vgg16": (lambda: vgg.build_vgg(depth=16), (3, 224, 224), 1000),
        "mobilenet_v1": (lambda: mobilenet.build_mobilenet(),
                         (3, 224, 224), 1000),
        "se_resnext50_32x4d": (lambda: se_resnext.build_se_resnext(
            depth=50), (3, 224, 224), 1000),
        "densenet121": (lambda: densenet.build_densenet(depth=121),
                        (3, 224, 224), 1000),
        "googlenet": (lambda: googlenet.build_googlenet(), (3, 224, 224),
                      1000),
        "mnist_conv_net": (mlp.build_conv_net, (1, 28, 28), 10),
    }


def run_cnn_path(counters):
    """Phase 23: each other image model at b8 under the bf16 policy with
    Momentum(0.1, 0.9), CNN_STEPS steps captured and eager in turns
    from one state: bit-equal, finite losses, K1-K8 never launched; each
    step's host seconds a mode."""
    out = {}
    for name, (build, image, classes) in _cnn_models().items():
        t0 = time.perf_counter()
        main, startup, loss, _ = _image_program(build=build)
        feed = _image_feed(CNN_BATCH, image, classes)
        r = _cnn_in_turns(main, startup, loss, feed, counters, CNN_STEPS,
                          f"cnn path {name}")
        types = [op.type for op in main.global_block().ops]
        out[name] = dict(
            image=list(image), classes=classes, ops=len(types),
            losses=r["losses"]["captured"],
            step_ms={m: [1e3 * s for s in v] for m, v in r["secs"].items()},
            peak_memory_gb={m: v / 1e9 for m, v in r["peak"].items()},
            capture_s=_capture_seconds(r["exes"]["captured"], main),
            model_flops_per_image_fwd=cnn_flops_per_image(main),
            launches=_summed(r["launches"]),
            device_launches=_summed(r["on_card"]),
            seconds=time.perf_counter() - t0)
        del r
        torch.cuda.empty_cache()
    return dict(batch=CNN_BATCH, steps=CNN_STEPS, dtype_policy="bf16",
                optimizer=f"Momentum({RESNET_LR}, {RESNET_MOMENTUM})",
                captured_eager_bit_equal=True, models=out,
                launches=_summed({n: m["launches"] for n, m in out.items()}),
                device_launches=_summed({n: m["device_launches"]
                                         for n, m in out.items()}))


# ---------------------------------------------------------------------------
# phases 24-26: Transformer NMT (bench.py:454-560 measure_nmt)
# ---------------------------------------------------------------------------

# measure_nmt's setup: transformer-big, ragged lengths bucketed to these
# source lengths (the target's is a bucket less one), a batch of
# NMT_TOKENS // bucket sentences, Adam(1e-4), the bf16 policy
NMT_BUCKETS = (32, 64, 128, 256)
NMT_TOKENS = 8192
NMT_ROUNDS = 2   # timed rounds over the buckets, after one warm-up round
NMT_LR = 1e-4
# phases 24-25: the eager peak and a program's four bucket graphs, each
# in a private pool, held together (82 GB of an H100's 85 at dropout
# 0.1) must stay within this share of the card's memory, so that growth
# fails by name here and not as an allocation failure in a later run
NMT_MEMORY_SHARE = 0.98
# phase 26: build_greedy_decode over 32 sources padded to 64, 16 new ids
NMT_DECODE_BATCH, NMT_DECODE_SRC, NMT_DECODE_OUT = 32, 64, 16
NMT_DECODE_RUNS = 5  # timed runs a mode, after one warm-up (capture)
# the decode's outputs must depend on the source: at least this many
# distinct id rows among the batch's (a quarter)
NMT_DECODE_MIN_DISTINCT = NMT_DECODE_BATCH // 4
# the card-vs-CPU parity: 2 layers a stack at full width, fp32, a padded
# bucket-32 batch of 16 sentences, 2 Adam steps; then greedy ids
NMT_PARITY_LAYERS, NMT_PARITY_STEPS, NMT_PARITY_OUT = 2, 2, 8
# Its updates and gradients are ill-conditioned element by element: a
# ReLU unit at its threshold switches one token's term of its FFN
# weights' gradient, and a gradient element at its rounding floor flips
# its Adam update by up to 2 lr a step.  On an H100 machine's CPU alone,
# a start moved by NMT_PARITY_NUDGE of each element moved the first
# gradient by 1.19e-3 of its norm and the updates after 3 steps by up to
# 4.33e-4 (over phase 5's 3 x lr max gate), 1.03e-6 mean abs and 2.61e-2
# of a leaf's update norm (printed as cpu_conditioning at every run).
# So the parity holds, on every leaf above the gradient floor, the first
# step's gradient within NMT_PARITY_GRAD_RTOL of its norm (the backward
# itself, which Adam's near-sign updates would hide) and the updates
# within phase 5's mean abs and NMT_PARITY_CHANGE_RTOL of their norm,
# and prints the max abs.  Each limit lies between those readings and
# the controls', card runs with a planted fault that every run repeats
# and that must fail the gates named: K2's dQ plus a share of itself
# rolled by one head-dim column (_planted_dq_fault), an error of that
# share of its norm, uncorrelated with it.  At 1% the update norms
# cannot see it (the query weights' updates moved by 3.76e-2 of their
# norm on the card, beside the CPU's own 2.61e-2); at 10% every gate
# does
NMT_PARITY_GRAD_RTOL = 4e-3
NMT_PARITY_CHANGE_RTOL = 5e-2
NMT_PARITY_CHECKS = (("mean_abs", TRAIN_PARAM_MEAN_ATOL),
                     ("change_rel", NMT_PARITY_CHANGE_RTOL))
NMT_PARITY_NUDGE = 1e-6
NMT_PARITY_CONTROLS = {1e-2: ("first_grad", "mean_abs"),
                       1e-1: ("first_grad", "mean_abs", "change_rel")}


# the NMT paths' K1-K3 shapes: in training (bf16), an encoder
# self-attention at a bucket of S with the -1e9 key-padding bias,
# [8192 / S, 16, S, 64], and a decoder one, causal over S - 1 target
# positions, at the smallest and the largest bucket; in phase 26's
# greedy decode (fp32, K1 alone on its path), the encoder's
# [32 x 16, 64, 64] with the unrounded fp32 -1e9 and the decoder's
# causal pass over its NMT_DECODE_OUT + 1 slot buffer, [32 x 16, 17, 64].
# All timed (SDPA with is_causal beside the causal ones); checked and
# timed apart from FLASH_CASES, after every other kernel check, so the
# seeded inputs of those stay as they were
NMT_FLASH_CASES = tuple(
    case for s in (32, 256) for case in (
        (f"nmt_enc_s{s}", NMT_TOKENS // s, 16, s, 64, torch.bfloat16,
         False, "nmt", True),
        (f"nmt_dec_s{s - 1}", NMT_TOKENS // s, 16, s - 1, 64,
         torch.bfloat16, True, "zero", True))) + (
    (f"nmt_decode_enc_s{NMT_DECODE_SRC}_fp32", NMT_DECODE_BATCH, 16,
     NMT_DECODE_SRC, 64, torch.float32, False, "nmt", True),
    (f"nmt_decode_dec_s{NMT_DECODE_OUT + 1}_fp32", NMT_DECODE_BATCH, 16,
     NMT_DECODE_OUT + 1, 64, torch.float32, True, "zero", True))


# the NMT cases draw from a generator of their own: no earlier check
# shifts their inputs
NMT_FLASH_SEED = SEED + 20


def check_flash_nmt(dev, rng=None):
    """K1, K2, K3 against their plain versions and timed at
    NMT_FLASH_CASES, on inputs from NMT_FLASH_SEED's generator (``rng``
    is not drawn from)."""
    return check_flash(dev, np.random.RandomState(NMT_FLASH_SEED),
                       NMT_FLASH_CASES)


# the bf16 K3 seeds replay: nmt_enc_s256's shape, a generator a seed
K3_SEED_CASE = NMT_FLASH_CASES[2]


def k3_seed_inputs(dev, seed, case=K3_SEED_CASE):
    """q, k, v, dO and the bias rows of ``case`` (an NMT_FLASH_CASES
    entry with bias mode "nmt") drawn from ``torch.Generator`` seeded
    with ``seed``: [B, S, H, D] activations seen as [B, H, S, D], each
    sentence's keys past a length uniform in [1, S] at -1e9 as the dtype
    holds it."""
    _, b, h, s, d, dtype = case[:6]
    g = torch.Generator().manual_seed(int(seed))

    def t():
        return torch.randn(b, s, h, d, generator=g).to(dev, dtype) \
            .transpose(1, 2)

    q, k, v, do = t(), t(), t(), t()
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    pad = torch.tensor(-1e9).to(dtype).item()
    bias = torch.zeros(b, s)
    for i, ln in enumerate(lengths.tolist()):
        bias[i, ln:] = pad
    rows = bias.repeat_interleave(h, dim=0).to(dev)
    return q, k, v, do, rows, lengths


def k3_seed_reading(dev, seed, case=K3_SEED_CASE):
    """One seed of the bf16 K3 replay (tools/torch_k3_seeds.py): dK and
    dV of the kernel and of the plain bf16 version against each other
    and against the exact answer (``flash.flash_bwd_dkv_truth``), each
    error over the rounding bound (``flash.flash_bwd_dkv_bf16_bound``),
    and where the kernel and the plain version differ most."""
    from paddle_tpu_torch.kernels.primitives import flash

    _, b, h, s, d, dtype, causal = case[:7]
    q, k, v, do, rows, lengths = k3_seed_inputs(dev, seed, case)
    scale = d ** -0.5
    o_ref, lse_ref = flash.flash_fwd(q, k, v, rows, causal, scale,
                                     force="reference")
    lse = lse_ref.reshape(b * h, s)
    delta = (do.float() * o_ref.float()).sum(-1).reshape(b * h, s)
    bargs = (q, k, v, rows, do, lse, delta, causal, scale)
    got = flash.flash_bwd_dkv(*bargs)[:2]
    plain = flash.flash_bwd_dkv(*bargs, force="reference")[:2]
    truth = flash.flash_bwd_dkv_truth(*bargs)
    bound = flash.flash_bwd_dkv_bf16_bound(*bargs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = {"seed": seed, "case": case[0], "within_flash_tol": True,
           "kernel_over_bound": 0.0, "plain_over_bound": 0.0}
    worst = None
    for name, g_, p_, t_, bd in zip(("dk", "dv"), got, plain, truth, bound):
        g_, p_ = g_.float(), p_.float()
        kp = (g_ - p_).abs()
        r = {"kernel_vs_plain": kp.max().item(),
             "kernel_vs_truth": (g_ - t_).abs().max().item(),
             "plain_vs_truth": (p_ - t_).abs().max().item(),
             "kernel_over_bound": over_bound((g_ - t_).abs(), bd)
             .max().item(),
             "plain_over_bound": over_bound((p_ - t_).abs(), bd)
             .max().item()}
        ok = torch.allclose(g_, p_, **FLASH_TOL[torch.bfloat16])
        out["within_flash_tol"] &= ok
        out["kernel_over_bound"] = max(out["kernel_over_bound"],
                                       r["kernel_over_bound"])
        out["plain_over_bound"] = max(out["plain_over_bound"],
                                      r["plain_over_bound"])
        # the element furthest outside FLASH_TOL's allclose
        tol = FLASH_TOL[torch.bfloat16]
        excess = kp - tol["atol"] - tol["rtol"] * p_.abs()
        i = int(excess.argmax())
        bi, hi, key, col = np.unravel_index(i, tuple(g_.shape))
        ln = int(lengths[bi])
        r["worst"] = {
            "batch": int(bi), "head": int(hi), "key": int(key),
            "col": int(col), "length": ln,
            "where": ("pad key" if key > ln else "first pad key"
                      if key == ln else "last real key" if key == ln - 1
                      else "real key"),
            "kernel": g_.flatten()[i].item(),
            "plain": p_.flatten()[i].item(),
            "truth": t_.flatten()[i].item(),
            "bound": bd.flatten()[i].item(),
            "excess_over_flash_tol": excess.flatten()[i].item()}
        if worst is None or r["worst"]["excess_over_flash_tol"] > \
                worst[1]["worst"]["excess_over_flash_tol"]:
            worst = (name, r)
        out[name] = r
    out["worst_of"] = worst[0]
    out["shortest_length"] = int(lengths.min())
    return out


def nmt_config(**kw):
    """Transformer-big (Vaswani et al. 2017; BASELINE.md north-star #4):
    vocabularies 30000, hidden 1024, 16 heads, FFN 4096, 6 + 6 layers,
    dropout 0.1 unless given."""
    from paddle_tpu_torch.models import transformer

    return transformer.TransformerConfig.big(**kw)


def nmt_batches(cfg, buckets=NMT_BUCKETS, tokens=NMT_TOKENS, seed=0):
    """measure_nmt's batches (bench.py:491 ``ragged_batch``), from the
    port's ``make_fake_batch``: one RandomState(seed) over the buckets
    in order; a bucket's batch of tokens // bucket sentences has lengths
    uniform in (the previous bucket, bucket], the source's tail past a
    length set to pad id 0 and ``label_weight`` 1 on a sentence's first
    length - 1 targets only.  Returns [(bucket, feed, effective tokens:
    non-pad source plus weighted target tokens, as the bench counts)]."""
    from paddle_tpu_torch.models import transformer

    rng = np.random.RandomState(seed)
    out = []
    for bucket, lo in zip(buckets, (0,) + tuple(buckets[:-1])):
        batch = max(tokens // bucket, 1)
        lens = rng.randint(lo + 1, bucket + 1, batch)
        data = transformer.make_fake_batch(cfg, batch=batch, src_len=bucket,
                                           trg_len=bucket - 1,
                                           seed=int(lens[0]))
        w = np.zeros_like(data["label_weight"])
        for i, ln in enumerate(lens):
            data["src_ids"][i, ln:] = 0
            w[i, :ln - 1] = 1.0
        data["label_weight"] = w
        out.append((bucket, data, int(lens.sum()) + int(w.sum())))
    return out


def _nmt_program(cfg, bf16=True):
    """build_transformer_nmt with Adam(NMT_LR); returns (main, startup,
    cost)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, cost, _ = transformer.build_transformer_nmt(cfg)
        fluid.optimizer.Adam(learning_rate=NMT_LR).minimize(cost)
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    return main, startup, cost


def _nmt_decode_program(cfg, max_out_len):
    """build_greedy_decode(cfg, max_out_len) (fp32); returns (main,
    startup, out ids)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, out = transformer.build_greedy_decode(cfg, max_out_len)
    startup.random_seed = SEED
    return main, startup, out


def nmt_step_launches(cfg):
    """{kernel: launches} of one NMT train step with the self-attentions
    on flash (dropout 0): K1 twice a self-attention (the forward and the
    derived grad's recompute), K2 and K3 once; the cross-attentions stay
    composed."""
    n = cfg.num_encoder_layers + cfg.num_decoder_layers
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def forward_flops(program, feed):
    """Forward FLOPs of ``program`` on ``feed``: 2 a multiply-add of its
    ``mul``, ``matmul`` and ``flash_attention`` ops (a causal one over
    the (query, key) pairs at or below the diagonal), at the shapes the
    ops see on this feed: every forward op's lowering run on meta
    tensors, in program order."""
    from paddle_tpu_torch.fluid import registry

    block = program.global_block()
    ctx = registry.LowerContext(device="meta")
    env = {n: torch.empty(np.shape(v), device="meta",
                          dtype=registry.torch_dtype(np.asarray(v).dtype.name))
           for n, v in feed.items()}

    def value(name):
        if name not in env:  # a parameter
            v = block.var(name)
            env[name] = torch.empty(v.shape, device="meta",
                                    dtype=registry.torch_dtype(v.dtype))
        return env[name]

    macs = 0
    with torch.no_grad():
        for op in block.ops:
            if op.attrs.get("op_role", "forward") not in ("forward", "loss"):
                continue
            info = registry.get_op(op.type)
            args = []
            for slot in info.input_slots:
                names = op.inputs.get(slot.rstrip("*"), [])
                args.append([value(n) for n in names]
                            if info.is_variadic(slot)
                            else value(names[0]) if names else None)
            ctx.cur_op = op
            out = info.lower(ctx, *args, attrs=op.attrs)
            out = out if isinstance(out, tuple) else (out,)
            for slot, o in zip(info.output_slots, out):
                names = op.outputs.get(slot.rstrip("*"), [])
                if info.is_variadic(slot):
                    env.update(zip(names, o or []))
                elif names and o is not None:
                    env[names[0]] = o
            a = op.attrs
            if op.type == "mul":
                x, y = args[0].shape, args[1].shape
                xd, yd = a.get("x_num_col_dims", 1), a.get("y_num_col_dims", 1)
                macs += (int(np.prod(x[:xd])) * int(np.prod(x[xd:]))
                         * int(np.prod(y[yd:])))
            elif op.type == "matmul":
                x = args[0].shape
                k = x[-2] if a.get("transpose_X", False) else x[-1]
                macs += int(np.prod(out[0].shape)) * int(k)
            elif op.type == "flash_attention":
                b, h, s, d = args[0].shape
                pairs = s * (s + 1) // 2 if a.get("causal") else s * s
                macs += 2 * b * h * pairs * d
    return 2 * macs


def _close(exes):
    """Free every plan and graph of ``exes`` (their pools with them)."""
    for exe in exes.values():
        exe.close()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def run_nmt_train_path(counters, dropout):
    """Phase 24 (``dropout`` 0.1, measure_nmt's) or 25 (0.0): Transformer-
    big NMT training as measure_nmt runs it, the captured and the eager
    executor in turns from one state made on the card by the startup
    program: one warm-up round over the buckets (one eager warm-up and
    one capture a bucket: 4 graphs), then NMT_ROUNDS timed rounds.
    Gates: losses finite; the modes' losses and whole state bit-equal; 4
    graphs held; the eager peak and the graph pools within
    NMT_MEMORY_SHARE of the card's memory; the pass report's fuse_attention sites (0 at dropout
    0.1, whose attention dropout vetoes the rewrite; 12 at 0.0: 6
    encoder self-attentions with the pad bias, 6 causal decoder ones);
    the launches exact, on the card and in the wrappers (none at dropout
    0.1; nmt_step_launches a step at 0.0, K4-K8 none).  Returns (state,
    readings): effective tokens/s, padding overhead, step p50 / p95 a
    bucket, MFU (forward_flops x 3 at each bucket's shapes, over
    profiling.device_peaks()), peak memory, graph pools and capture
    seconds, per mode."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.observability import profiling

    what = f"nmt train path (dropout {dropout})"
    cfg = nmt_config(dropout=dropout)
    main, startup, cost = _nmt_program(cfg)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    batches = nmt_batches(cfg)
    per_step = _no_launches(counters)
    if not dropout:
        per_step.update(nmt_step_launches(cfg))
    losses = {m: [] for m in exes}
    secs = {m: {b: [] for b, _, _ in batches} for m in exes}
    first_s = {m: {} for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for rnd in range(1 + NMT_ROUNDS):
        for bucket, feed, _ in batches:
            for m, exe in exes.items():  # in turns
                torch.cuda.reset_peak_memory_stats()
                before = _snap()
                t0 = time.perf_counter()
                (lv,) = exe.run(main, feed=feed, fetch_list=[cost],
                                scope=scopes[m])
                dt = time.perf_counter() - t0  # the fetch syncs
                py, dev = _since(before, counters)
                _add(launches[m], py)
                _add(on_card[m], dev)
                peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
                losses[m].append(float(lv))
                if rnd:
                    secs[m][bucket].append(dt)
                else:
                    first_s[m][bucket] = dt
    runs = len(batches) * (1 + NMT_ROUNDS)
    _gate_launches(what, launches, on_card, per_step, runs, len(batches))
    att = {e["pass"]: e for e in main._pass_report}["fuse_attention"]
    n = cfg.num_encoder_layers + cfg.num_decoder_layers
    want_sites = ((0, 0, 0) if dropout else
                  (n, cfg.num_encoder_layers, cfg.num_decoder_layers))
    if (att["sites"], att.get("bias_sites", 0),
            att.get("causal_sites", 0)) != want_sites:
        raise AssertionError(f"{what}: fuse_attention report {att}, "
                             f"expected (sites, bias, causal) {want_sites}")
    if not all(np.isfinite(losses["captured"])):
        raise AssertionError(f"{what}: losses not finite: {losses}")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"{what}: captured and eager differ: losses "
                             f"{losses}, state {diff[:5]}")
    held = [e.graph for e in exes["captured"].compiled_for(main)]
    if len(held) != len(batches) or None in held:
        raise AssertionError(f"{what}: the captured executor holds {held}, "
                             f"expected one graph a bucket")
    pools = graph_pools_gb()
    held_gb = max(peak.values()) / 1e9 + pools
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    if not held_gb <= NMT_MEMORY_SHARE * card_gb:
        raise AssertionError(
            f"{what}: eager peak {max(peak.values()) / 1e9} GB + graph "
            f"pools {pools} GB = {held_gb} GB, over {NMT_MEMORY_SHARE} of "
            f"the card's {card_gb} GB")
    flops = {b: 3 * forward_flops(main, feed) for b, feed, _ in batches}
    eff = sum(e for _, _, e in batches)
    padded = sum(f["src_ids"].size + f["labels"].size
                 for _, f, _ in batches)
    _, peak_flops, _, _ = profiling.device_peaks()
    modes = {}
    for m in exes:
        total_s = sum(sum(v) for v in secs[m].values())
        modes[m] = dict(
            effective_tokens_per_s=NMT_ROUNDS * eff / total_s,
            mfu=NMT_ROUNDS * sum(flops.values()) / total_s / peak_flops,
            round_s=total_s / NMT_ROUNDS,
            buckets={b: dict(**_ms_quantiles(v), first_run_s=first_s[m][b],
                             mfu_p50=flops[b] / float(np.median(v))
                             / peak_flops)
                     for b, v in secs[m].items()},
            peak_memory_gb=peak[m] / 1e9, launches=launches[m],
            device_launches=on_card[m])
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"], main)
    modes["captured"]["graph_pools_gb"] = pools
    modes["captured"]["graphs"] = len(held)
    types = [op.type for op in main.global_block().ops]
    path = dict(
        model=f"TransformerConfig.big(dropout={dropout}) (vocabularies "
        "30000, hidden 1024, 16 heads, FFN 4096, 6 + 6 layers)",
        buckets=list(NMT_BUCKETS), tokens_budget=NMT_TOKENS,
        batches={b: list(f["src_ids"].shape) for b, f, _ in batches},
        effective_tokens_a_round=eff, padded_tokens_a_round=padded,
        padding_overhead=padded / eff - 1, dtype_policy="bf16",
        optimizer=f"Adam({NMT_LR})", rounds=NMT_ROUNDS, warmup_rounds=1,
        losses=losses["captured"], captured_eager_bit_equal=True,
        ops=len(types), flash_attention_ops=types.count("flash_attention"),
        pass_report=main._pass_report, memory_held_gb=held_gb,
        memory_limit_gb=NMT_MEMORY_SHARE * card_gb,
        model_flops_a_step={b: f for b, f in flops.items()},
        mfu_peak_flops=peak_flops, modes=modes,
        launches=_summed(launches), device_launches=_summed(on_card))
    state = dict(exes=exes, main=main, scopes=scopes, cost=cost,
                 batches=batches, cfg=cfg)
    return state, path


def profile_nmt_step(state, bucket=128):
    """One train step of each mode at ``bucket`` under torch.profiler
    (the captured one replays its graph): device busy and idle, launch
    API calls, the top device kernels."""
    feed = {b: f for b, f, _ in state["batches"]}[bucket]
    out = {"bucket": bucket}
    for m, exe in state["exes"].items():
        out[m] = _profile(lambda: exe.run(
            state["main"], feed=feed, fetch_list=[state["cost"]],
            scope=state["scopes"][m]), 1)
    return out


def nmt_decode_feed(cfg, batch, src_len, seed):
    """``batch`` source sentences of ids in [2, vocab), padded to
    ``src_len`` with pad id 0 past lengths uniform in [1, src_len]."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, src_len + 1, batch)
    src = rng.randint(2, cfg.src_vocab, (batch, src_len)).astype("int64")
    for i, ln in enumerate(lens):
        src[i, ln:] = 0
    return {"src_ids": src}


def _nmt_decode_logits(main):
    """The names of build_greedy_decode's pass logits ([B, 1, V]: the
    ``slice`` ops' outputs, in pass order)."""
    return [op.output("Out")[0] for op in main.global_block().ops
            if op.type == "slice"]


def _nmt_decode_on_cpu(what, main, out, feed, exe, scope):
    """A greedy decode program on ``feed`` once more on the card
    (``exe``) and once on a CPUPlace executor over the same parameters,
    fetching the ids and every pass's logits.  Pass i reads buffer slots
    0..i (the self-attention is causal) and writes slot i + 1, so where
    a row's ids first differ at slot k, its passes before k ran on equal
    inputs: their logits must agree within PATH_LOGP_ATOL, and pass
    k - 1 may pick another id only at a near-tie (the CPU's top-two gap
    there below PATH_LOGP_ATOL).  Returns the readings and the card's
    ids."""
    from paddle_tpu_torch import convert, fluid

    fetch = [out] + _nmt_decode_logits(main)
    card = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    cpu_scope = fluid.Scope()
    convert.load_params(cpu_scope, {
        p.name: scope.get(p.name).cpu().numpy()
        for p in main.all_parameters()}, fluid.CPUPlace(), program=main)
    t0 = time.perf_counter()
    cpu = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                               fetch_list=fetch,
                                               scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    ids = {"card": np.asarray(card[0]), "cpu": np.asarray(cpu[0])}
    logits = {k: np.stack([np.asarray(a).reshape(len(ids[k]), -1)
                           for a in v[1:]], axis=1)
              for k, v in (("card", card), ("cpu", cpu))}
    err, rows = 0.0, []
    for r in range(len(ids["cpu"])):
        differ = np.flatnonzero(ids["card"][r] != ids["cpu"][r])
        k = int(differ[0]) if differ.size else None
        passes = len(fetch) - 1 if k is None else k
        err = max(err, float(np.abs(logits["card"][r, :passes]
                                    - logits["cpu"][r, :passes]).max()))
        if k is not None:
            top2 = np.sort(logits["cpu"][r, k - 1])[-2:]
            gap = float(top2[1] - top2[0])
            rows.append(dict(row=r, first_mismatch=k, top2_gap=gap))
            if not k >= 1 or not gap < PATH_LOGP_ATOL:
                raise AssertionError(
                    f"{what}: row {r}'s ids on the card {ids['card'][r]} "
                    f"and the CPU {ids['cpu'][r]} differ at slot {k}, CPU "
                    f"top-two gap {gap} >= {PATH_LOGP_ATOL}")
    if not err < PATH_LOGP_ATOL:
        raise AssertionError(f"{what}: card vs CPU logits max abs err {err} "
                             f">= {PATH_LOGP_ATOL}")
    return dict(ids_equal=not rows, mismatched_rows=rows,
                logits_max_abs_err=err, logits_atol=PATH_LOGP_ATOL,
                logits_max_abs=float(np.abs(logits["cpu"]).max()),
                cpu_run_s=cpu_s), ids["card"]


def run_nmt_decode_path(counters):
    """Phase 26: build_greedy_decode(TransformerConfig.big(),
    max_out_len=NMT_DECODE_OUT), fp32, the default passes on, over its
    own startup program's seeded parameters (a trained model of a few
    steps decodes every source to one token, which could not show a
    wrong kernel): 32 seeded sources padded to 64, one warm-up run (the
    capture) and NMT_DECODE_RUNS timed runs a mode, in turns.  Gates:
    the pass report reads a flash site a self-attention of the encoder
    and of each of the NMT_DECODE_OUT decoder passes; K1 launches that
    many times a run on the card, K2-K8 never; captured ids equal eager
    ids at every run, start with bos and lie in the vocabulary; at least
    NMT_DECODE_MIN_DISTINCT distinct outputs; ids and logits held
    against a CPU run of the same program (_nmt_decode_on_cpu)."""
    from paddle_tpu_torch import fluid

    cfg = nmt_config(dropout=0.0)
    main, startup, out = _nmt_decode_program(cfg, NMT_DECODE_OUT)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    feed = nmt_decode_feed(cfg, NMT_DECODE_BATCH, NMT_DECODE_SRC, SEED)
    exes = _executors()
    sites = cfg.num_encoder_layers + NMT_DECODE_OUT * cfg.num_decoder_layers
    per_run = dict(_no_launches(counters), flash_fwd=sites)
    ids = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    for _ in range(1 + NMT_DECODE_RUNS):
        for m, exe in exes.items():
            before = _snap()
            t0 = time.perf_counter()
            (got,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
            secs[m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            ids[m].append(np.asarray(got))
    _gate_launches("nmt decode path", launches, on_card, per_run,
                   1 + NMT_DECODE_RUNS, 1)
    att = {e["pass"]: e for e in main._pass_report}["fuse_attention"]
    if att["sites"] != sites:
        raise AssertionError(f"nmt decode path: fuse_attention report {att}, "
                             f"expected {sites} sites")
    first = ids["captured"][0]
    if any(not np.array_equal(a, first) for m in ids for a in ids[m]):
        raise AssertionError(f"nmt decode path: ids differ between runs or "
                             f"modes: {ids}")
    distinct = len({tuple(r) for r in first.tolist()})
    if first.shape != (NMT_DECODE_BATCH, NMT_DECODE_OUT + 1) \
            or (first[:, 0] != cfg.bos_id).any() or first.min() < 0 \
            or first.max() >= cfg.trg_vocab \
            or distinct < NMT_DECODE_MIN_DISTINCT:
        raise AssertionError(f"nmt decode path: ids {first}, {distinct} "
                             f"distinct outputs")
    cpu, card_ids = _nmt_decode_on_cpu("nmt decode path", main, out, feed,
                                       exes["eager"], scope)
    if not np.array_equal(card_ids, first):
        raise AssertionError("nmt decode path: the eager run fetching the "
                             "logits gave other ids")
    modes = {m: dict(**_ms_quantiles(secs[m][1:]), first_run_s=secs[m][0],
                     launches=launches[m], device_launches=on_card[m])
             for m in exes}
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"], main)
    _close(exes)
    return dict(model="build_greedy_decode(TransformerConfig.big(), "
                f"max_out_len={NMT_DECODE_OUT}), fp32, its startup's "
                f"seeded parameters (seed {SEED})",
                batch=NMT_DECODE_BATCH, src_len=NMT_DECODE_SRC,
                ops=len(main.global_block().ops), flash_sites=sites,
                distinct_outputs=distinct,
                min_distinct=NMT_DECODE_MIN_DISTINCT,
                ids_head=first[:4].tolist(), captured_eager_equal=True,
                cpu=cpu, modes=modes, launches=_summed(launches),
                device_launches=_summed(on_card))


def _nmt_parity_run(cfg, place, feed, init, steps):
    """``steps`` fp32 steps of the NMT program with Adam(NMT_LR) on
    ``place`` from ``init`` (None: the startup's, returned).  Returns
    the losses, ``init``, the parameters after the run and each
    parameter's first-step gradient."""
    from paddle_tpu_torch import convert, fluid

    main, startup, cost = _nmt_program(cfg, bf16=False)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    _run_startup(exe, startup, scope, init)
    if init is None:
        init = {p.name: scope.get(p.name).cpu().numpy().copy()
                for p in main.all_parameters()}
    else:
        convert.load_params(scope, init, place, program=main)
    grads = dict(main._params_grads)
    losses, first = [], None
    for i in range(steps):
        fetch = [cost] + (list(grads.values()) if i == 0 else [])
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        if i == 0:
            first = {p: np.asarray(g, np.float64)
                     for p, g in zip(grads, out[1:])}
    final = {n: scope.get(n).cpu().numpy() for n in init}
    return losses, init, final, first


def _grad_rel(grads, ref, held):
    """Worst ||g - ref|| / ||ref|| over the ``held`` leaves, and its leaf."""
    rel = {n: _norm(_f64(grads[n]) - _f64(ref[n]))
           / max(_norm(_f64(ref[n])), 1e-30) for n in held}
    leaf = max(rel, key=rel.get)
    return dict(leaf=leaf, rel=rel[leaf])


@contextlib.contextmanager
def _planted_dq_fault(eps):
    """The NMT parity's control: K2's dQ off by ``eps`` of itself rolled
    by one head-dim column.  The op's backward looks ``flash_bwd_dq`` up
    in its module at each call, so the planted function takes its
    place until the block ends (and takes K2's launches meanwhile: the
    wrapper counts on the function its module names)."""
    from paddle_tpu_torch.kernels.primitives import flash

    kernel = flash.flash_bwd_dq

    def planted(*args, **kw):
        dq = kernel(*args, **kw)
        return dq + eps * dq.roll(1, dims=-1)

    planted.launches = 0
    flash.flash_bwd_dq = planted
    try:
        yield
    finally:
        flash.flash_bwd_dq = kernel


def _nmt_parity_setup():
    """The parity's 2 + 2-layer configuration and its padded batch."""
    cfg = nmt_config(num_encoder_layers=NMT_PARITY_LAYERS,
                     num_decoder_layers=NMT_PARITY_LAYERS, dropout=0.0)
    (_, feed, _), = nmt_batches(cfg, buckets=(32,), tokens=16 * 32, seed=1)
    return cfg, feed


def _nmt_held(g_rms):
    """The leaves above the gradient floor (_update_readings' rule)."""
    median = float(np.median(list(g_rms.values())))
    return [n for n, r in g_rms.items() if r >= DP_GRAD_FLOOR * median]


def nmt_cpu_child(dirname):
    """The CPU reference child's part for phase 26's parity: the
    starting state, the program's parameters after its startup on the
    CPU, into ``nmt.init``; the run on a CPUPlace executor from it (its
    losses, first gradients and final parameters into ``nmt.cpu``), and
    the CPU's conditioning, a run from the start moved by
    NMT_PARITY_NUDGE of each element, read against it."""
    from paddle_tpu_torch import fluid

    cfg, feed = _nmt_parity_setup()
    main, startup, _ = _nmt_program(cfg, bf16=False)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    init = {p.name: scope.get(p.name).numpy().copy()
            for p in main.all_parameters()}
    _child_result(dirname, "nmt.init", **init)
    cl, _, cpu, grads = _nmt_parity_run(cfg, fluid.CPUPlace(), feed, init,
                                        NMT_PARITY_STEPS)
    signs = np.random.RandomState(SEED)
    nudged = {n: (a * (1 + NMT_PARITY_NUDGE * signs.choice(
        [-1.0, 1.0], a.shape))).astype(a.dtype) for n, a in init.items()}
    nl, _, ncpu, ngrads = _nmt_parity_run(cfg, fluid.CPUPlace(), feed,
                                          nudged, NMT_PARITY_STEPS)
    g_rms = {n: _rms(g) for n, g in grads.items()}
    held = _nmt_held(g_rms)
    conditioning = dict(
        nudge=NMT_PARITY_NUDGE, losses=nl,
        loss_max_rel_diff=max(abs(a - b) / abs(b) for a, b in zip(nl, cl)),
        first_grad=_grad_rel(ngrads, grads, held),
        worst_held=_update_readings(init, ncpu, cpu, grads,
                                    init_gpu=nudged)["worst_held"])
    _child_result(dirname, "nmt.cpu", __meta__=np.array(json.dumps(dict(
        losses=cl, g_rms=g_rms, conditioning=conditioning))),
        **{f"final:{n}": v for n, v in cpu.items()},
        **{f"grad:{n}": g.astype(np.float32) for n, g in grads.items()})


def run_nmt_parity(child):
    """2 + 2 layers at full width (hidden 1024, 16 heads, FFN 4096,
    vocabularies 30000), dropout 0, fp32, the default passes (the
    self-attentions on flash: fp32 K1-K3 on the card, their plain
    versions on the CPU): a padded bucket-32 batch of 16 sentences
    (nmt_batches' recipe, seed 1), 2 Adam steps on the card and on a
    CPUPlace executor (in the CPU reference ``child``) from the same
    parameters.  Gates (see NMT_PARITY_GRAD_RTOL): losses within
    TRAIN_LOSS_RTOL; on every leaf above the gradient floor, the first
    step's gradient within NMT_PARITY_GRAD_RTOL of its norm, and
    NMT_PARITY_CHECKS on the updates; each control (_planted_dq_fault on
    the card, see NMT_PARITY_CONTROLS) failing the gates it names; the
    CPU's conditioning (a run from a start moved by NMT_PARITY_NUDGE of
    each element) printed beside.  Then the greedy decode
    (NMT_PARITY_OUT new ids) of the card run's final parameters over the
    batch's sources, held against the CPU's (_nmt_decode_on_cpu)."""
    from paddle_tpu_torch import convert, fluid

    cfg, feed = _nmt_parity_setup()
    init = child.take("nmt.init")
    gl, _, gpu, ggrads = _nmt_parity_run(cfg, _gpu_place(), feed, init,
                                         NMT_PARITY_STEPS)
    controls = {}
    for eps in NMT_PARITY_CONTROLS:
        with _planted_dq_fault(eps):
            controls[eps] = _nmt_parity_run(cfg, _gpu_place(), feed, init,
                                            NMT_PARITY_STEPS)
    z = child.take("nmt.cpu")
    meta = json.loads(str(z["__meta__"]))
    cl = meta["losses"]
    cpu = {n: z[f"final:{n}"] for n in init}
    grads = {n: z[f"grad:{n}"].astype(np.float64) for n in meta["g_rms"]}

    def loss_rel(losses):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, cl))

    readings = _update_readings(init, gpu, cpu, grads)
    held = [n for n in grads if n not in readings["floor_leaves"]]
    grad = _grad_rel(ggrads, grads, held)
    rel = loss_rel(gl)
    control = {
        f"dq + {eps} x dq rolled by one column": dict(
            must_fail=gates, losses=kl, loss_max_rel_diff=loss_rel(kl),
            first_grad=_grad_rel(kgrads, grads, held),
            worst_held=_update_readings(init, ctl, cpu, grads)[
                "worst_held"])
        for eps, gates in NMT_PARITY_CONTROLS.items()
        for kl, _, ctl, kgrads in (controls[eps],)}
    reading = dict(batch=list(feed["src_ids"].shape), losses_gpu=gl,
                   losses_cpu=cl, loss_max_rel_diff=rel, first_grad=grad,
                   grad_rtol=NMT_PARITY_GRAD_RTOL, controls=control,
                   cpu_conditioning=meta["conditioning"])
    bounds = dict(NMT_PARITY_CHECKS)
    for c in control.values():
        seen = {k: w[k] > bounds[k] for k, w in c["worst_held"].items()
                if k in bounds}
        seen["first_grad"] = c["first_grad"]["rel"] > NMT_PARITY_GRAD_RTOL
        if not all(seen[g] for g in c["must_fail"]):
            raise AssertionError(f"nmt parity: a control passes a gate it "
                                 f"must fail: {reading}")
    if not rel < TRAIN_LOSS_RTOL or not grad["rel"] <= NMT_PARITY_GRAD_RTOL:
        raise AssertionError(f"nmt parity: {reading}")
    reading.update(_update_gates("nmt parity", readings, NMT_PARITY_CHECKS))
    main, _, out = _nmt_decode_program(cfg, NMT_PARITY_OUT)
    scope = fluid.Scope()
    convert.load_params(scope, {p.name: gpu[p.name]
                                for p in main.all_parameters()},
                        _gpu_place(), program=main)
    greedy, ids = _nmt_decode_on_cpu(
        "nmt parity greedy", main, out, {"src_ids": feed["src_ids"]},
        fluid.Executor(_gpu_place()), scope)
    return dict(reading, greedy=greedy, greedy_max_out_len=NMT_PARITY_OUT,
                greedy_distinct_outputs=len({tuple(r) for r in
                                             ids.tolist()}))


def run_nmt_phases(wrappers, say, smi, child):
    """Phases 24-26 and the card-vs-CPU parity; returns {path: readings}
    for the kernels line."""
    out = {}
    torch.cuda.empty_cache()
    state, out["nmt_train"] = run_nmt_train_path(wrappers, dropout=0.1)
    say("nmt train path", {"card": smi, **out["nmt_train"]})
    say("nmt train step", {"card": smi, **profile_nmt_step(state)})
    _close(state.pop("exes"))
    del state
    torch.cuda.empty_cache()
    state, out["nmt_train_flash"] = run_nmt_train_path(wrappers, dropout=0.0)
    say("nmt flash train path", {"card": smi, **out["nmt_train_flash"]})
    say("nmt flash train step", {"card": smi, **profile_nmt_step(state)})
    _close(state.pop("exes"))
    del state
    torch.cuda.empty_cache()
    out["nmt_decode"] = run_nmt_decode_path(wrappers)
    say("nmt decode path", {"card": smi, **out["nmt_decode"]})
    torch.cuda.empty_cache()
    say("nmt parity", run_nmt_parity(child))
    return out


# ---------------------------------------------------------------------------
# phase 27: the book lane (tests/book/, tests/torch_port_books.py)
# ---------------------------------------------------------------------------

# the attention-fusion Transformer book (TransformerConfig.tiny: hidden
# 64, 4 heads of D 16, fp32, one fixed batch of 8 with 12 source and 10
# target positions): its encoder self-attentions with the key bias and
# its causal decoder ones, K1-K3 in split TF32, checked and timed after
# every other kernel check
BOOK_FLASH_CASES = (
    ("book_enc_s12_fp32", 8, 4, 12, 16, torch.float32, False, "nmt", True),
    ("book_dec_s10_fp32", 8, 4, 10, 16, torch.float32, True, "zero", True))
# the card against a CPUPlace run of the port from the card's startup
# state: the first BOOK_PARITY_STEPS losses within BOOK_CPU_RTOL
BOOK_PARITY_STEPS, BOOK_CPU_RTOL = 2, 1e-4
# the eager executor's steps a book, in turns with the captured one from
# one state: the two modes' losses and whole state bit-equal there; the
# captured one then trains on alone to the book's threshold
BOOK_EAGER_STEPS = 8
# the reloaded inference model against clone(for_test=True): the book
# harness's tolerance (tests/book/book_util.py)
BOOK_INFER_TOL = dict(rtol=2e-4, atol=2e-5)


def check_flash_book(dev, rng):
    """K1, K2, K3 against their plain versions and timed at
    BOOK_FLASH_CASES."""
    return check_flash(dev, rng, BOOK_FLASH_CASES)


def _book_programs():
    """tests/torch_port_books.py: the book programs, written once for
    either package (it imports neither)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_port_books

    return torch_port_books


def book_step_launches(name):
    """{kernel: launches} of one step of book ``name``: the fused
    Transformer book's 4 self-attention sites launch K1 twice (the
    forward and the derived grad's recompute) and K2, K3 once; no other
    book runs a kernel."""
    if name != "transformer_fusion":
        return {}
    return {"flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}


def _viterbi_margins(em, trans, length, where):
    """At each (row, step) of ``where``, the gap between the top two
    Viterbi scores over the tags there (numpy, fp64, over the card's
    emissions and transitions)."""
    em, trans = np.asarray(em, np.float64), np.asarray(trans, np.float64)
    out = []
    for b, t in where:
        v = trans[0] + em[b, 0]
        for s in range(1, min(t, int(length[b]) - 1) + 1):
            v = em[b, s] + (v[:, None] + trans[2:]).max(axis=0)
        top = np.sort(v)[-2:]
        out.append(dict(row=int(b), step=int(t),
                        margin=float(top[1] - top[0])))
    return out


def _book_viterbi_on_cpu(paddle, books, main, scope, feed, exe):
    """label_semantic_roles' Viterbi paths from the card's trained state
    (``scope``) on ``feed``, on the card and on a CPUPlace executor over
    a copy of the state: equal, or the run fails printing the margins of
    the differing steps."""
    fluid = paddle.fluid
    test = main.clone(for_test=True)
    (op,) = [o for o in test.global_block().ops if o.type == "crf_decoding"]
    fetch = [books.decode_var(test), op.input("Emission")[0]]
    card = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=feed, fetch_list=fetch[:1],
        scope=_clone_scope(scope, "cpu"))
    where = np.argwhere(np.asarray(card[0]) != np.asarray(cpu[0]))
    if len(where):
        trans = scope.get(op.input("Transition")[0]).cpu().numpy()
        margins = _viterbi_margins(card[1], trans, feed["length"],
                                   where[:10])
        raise AssertionError(f"book label_semantic_roles: Viterbi paths on "
                             f"the card and the CPU differ at {len(where)} "
                             f"steps; margins {margins}")
    return dict(viterbi_steps=int(np.asarray(feed["length"]).sum()),
                viterbi_paths_equal_cpu=True)


def _mt_decodes(paddle, books, scope):
    """machine_translation's two beam decodes from the card's trained
    state (``scope``) on the reader's first batch: the unrolled one
    (captured) and the While over tensor arrays (eager by rule), ids
    equal and scores within 1e-5, as the CPU test holds them."""
    fluid = paddle.fluid
    feed = {"src": books.first_feed(books.BOOKS["machine_translation"],
                                     paddle)["src"]}
    exe = fluid.Executor(_gpu_place())
    outs, eager = {}, {}
    for tag, builder in (("unrolled", books.mt_build_decode),
                         ("while", books.mt_build_decode_while)):
        prog, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, start), fluid.unique_name.guard():
            _, sent, scores = builder(paddle)
        t0 = time.perf_counter()
        outs[tag] = exe.run(prog, feed=feed, fetch_list=[sent, scores],
                            scope=scope)
        (entry,) = exe.compiled_for(prog)
        eager[tag] = dict(eager_only=entry.plan.eager_only,
                          first_run_s=time.perf_counter() - t0)
    exe.close()
    (ids, sc), (wids, wsc) = outs["unrolled"], outs["while"]
    if not np.array_equal(ids, wids) or not np.allclose(
            wsc, sc, rtol=1e-5, atol=1e-6) or eager["unrolled"][
                "eager_only"] or not eager["while"]["eager_only"]:
        raise AssertionError(f"book machine_translation: the while decode "
                             f"differs from the unrolled one ({eager})")
    return dict(decodes_equal=True, decode_runs=eager,
                decode_score_max_abs=float(np.abs(wsc - sc).max()))


def run_book(book, counters, books):
    """One book of phase 27 (see the module docstring); returns its
    readings."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import fluid

    what = f"book {book.name}"
    t_book = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds_vars, loss, predict = book.build(paddle)
        book.optimizer(paddle).minimize(loss)
    feeds = books.train_feeds(book, paddle)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    init = _clone_scope(scope, "cpu")
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    per_step = {**_no_launches(counters), **book_step_launches(book.name)}
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    n_eager = min(BOOK_EAGER_STEPS, len(feeds))
    torch.cuda.synchronize()
    for i, feed in enumerate(feeds):
        if i == n_eager:  # the modes compared; the captured one goes on
            diff = _scope_diff(scopes["captured"], scopes["eager"])
            if losses["captured"] != losses["eager"] or diff:
                raise AssertionError(f"{what}: captured and eager differ "
                                     f"after {i} steps: losses {losses}, "
                                     f"state {diff[:5]}")
        for m, exe in exes.items():  # in turns
            if m == "eager" and i >= n_eager:
                continue
            before = _snap()
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scopes[m])
            dt = time.perf_counter() - t0  # the fetch syncs
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            losses[m].append(float(lv))
            if i:
                secs[m].append(dt)
    _gate_launches(what, launches, on_card, per_step,
                   {"captured": len(feeds), "eager": n_eager}, 1)
    if not all(np.isfinite(losses["captured"])):
        raise AssertionError(f"{what}: losses not finite: {losses}")
    if n_eager == len(feeds):
        diff = _scope_diff(scopes["captured"], scopes["eager"])
        if losses["captured"] != losses["eager"] or diff:
            raise AssertionError(f"{what}: captured and eager differ: "
                                 f"losses {losses}, state {diff[:5]}")
    off_card = sorted({n for sc in scopes.values() for n in sc.keys()
                       if sc.get(n).device.type != "cuda"})
    if off_card:
        raise AssertionError(f"{what}: state off the card: {off_card[:5]}")
    held = [e.graph for e in exes["captured"].compiled_for(main)]
    if len(held) != 1 or None in held:
        raise AssertionError(f"{what}: the captured executor holds {held}, "
                             f"expected one graph")
    book.check(losses["captured"])  # the book's own threshold

    # the first steps against the CPU, from the card's startup state
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_losses = [float(cpu_exe.run(main, feed=f, fetch_list=[loss],
                                    scope=init)[0])
                  for f in feeds[:BOOK_PARITY_STEPS]]
    card_losses = losses["captured"][:BOOK_PARITY_STEPS]
    cpu_rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    if not max(cpu_rel) <= BOOK_CPU_RTOL:
        raise AssertionError(f"{what}: card losses {card_losses} vs the "
                             f"CPU's {cpu_losses}: relative {cpu_rel}, "
                             f"over {BOOK_CPU_RTOL}")

    # save -> load -> infer on the card
    feed_names = book.feed_names or [v.name for v in feeds_vars]
    infer_feed = {n: v for n, v in books.first_feed(book, paddle).items()
                  if n in feed_names}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        fluid.io.save_inference_model(d, feed_names, [predict],
                                      exes["captured"], main_program=main,
                                      scope=scope)
        (expected,) = exes["captured"].run(
            main.clone(for_test=True), feed=infer_feed,
            fetch_list=[predict.name], scope=scope)
        s2 = fluid.Scope()
        exe2 = fluid.Executor(_gpu_place())
        prog, fns, fetches = fluid.io.load_inference_model(d, exe2,
                                                           scope=s2)
        (got,) = exe2.run(prog, feed={n: infer_feed[n] for n in fns},
                          fetch_list=[fetches[0].name], scope=s2)
        exe2.close()
    if set(fns) != set(feed_names) or not np.allclose(
            np.asarray(got), np.asarray(expected), **BOOK_INFER_TOL):
        raise AssertionError(
            f"{what}: the reloaded inference model's prediction differs "
            f"from clone(for_test=True) by "
            f"{np.abs(np.asarray(got) - np.asarray(expected)).max()}")
    if book.name == "label_semantic_roles":
        out.update(_book_viterbi_on_cpu(
            paddle, books, main, scope,
            books.first_feed(book, paddle), exes["captured"]))
    if book.name == "machine_translation":
        out.update(_mt_decodes(paddle, books, scope))
    # one profiled step a mode, on the last batch (after the gates)
    prof = {m: _profile(lambda: exe.run(main, feed=feeds[-1],
                                        fetch_list=[loss],
                                        scope=scopes[m]), 1)
            for m, exe in exes.items()}
    modes = {m: dict(**_ms_quantiles(v),
                     examples_per_s=book.batch / float(np.median(v)),
                     launch_api_calls=prof[m]["launch_api_calls"],
                     device_busy_ms=prof[m]["device_busy_ms"],
                     device_idle_share=prof[m].get("device_idle_share"),
                     launches=launches[m], device_launches=on_card[m])
             for m, v in secs.items()}
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"],
                                                      main)
    _close(exes)
    types = [op.type for op in main.global_block().ops]
    out.update(
        batch=book.batch, epochs=book.epochs, steps=len(feeds),
        ops=len(types), flash_attention_ops=types.count("flash_attention"),
        first_loss=losses["captured"][0], final_loss=losses["captured"][-1],
        tail_loss_mean_5=float(np.mean(losses["captured"][-5:])),
        threshold_met=True, captured_eager_bit_equal=True,
        eager_steps=n_eager,
        card_vs_cpu_losses=dict(card=card_losses, cpu=cpu_losses,
                                max_rel=max(cpu_rel)),
        infer_max_abs=float(np.abs(np.asarray(got)
                                   - np.asarray(expected)).max()),
        modes=modes, launches=_summed(launches),
        device_launches=_summed(on_card),
        seconds=time.perf_counter() - t_book)
    return out


def run_book_path(counters):
    """Phase 27: every book of tests/torch_port_books.py in turn."""
    books = _book_programs()
    out = {}
    for name, book in books.BOOKS.items():
        with (graph_passes(book.graph_passes) if book.graph_passes
              else contextlib.nullcontext()):
            out[name] = run_book(book, counters, books)
        torch.cuda.empty_cache()
    return dict(books=out, captured_eager_bit_equal=True,
                launches=_summed({n: b["launches"] for n, b in out.items()}),
                device_launches=_summed({n: b["device_launches"]
                                         for n, b in out.items()}))


def book_summary(path):
    """The phase's readings a book, one short row each."""
    return {n: dict(captured_p50_ms=b["modes"]["captured"]["p50_ms"],
                    captured_p95_ms=b["modes"]["captured"]["p95_ms"],
                    eager_p50_ms=b["modes"]["eager"]["p50_ms"],
                    eager_p95_ms=b["modes"]["eager"]["p95_ms"],
                    examples_per_s_captured=b["modes"]["captured"][
                        "examples_per_s"],
                    launch_api_calls=[b["modes"][m]["launch_api_calls"]
                                      for m in ("captured", "eager")],
                    capture_s=b["modes"]["captured"]["capture_s"],
                    final_loss=b["final_loss"],
                    tail_loss_mean_5=b["tail_loss_mean_5"],
                    seconds=b["seconds"])
            for n, b in path["books"].items()}


# ---------------------------------------------------------------------------
# phase 28: the health sentinel on the BERT-base train step
# ---------------------------------------------------------------------------

HEALTH_STEPS = 6
HEALTH_BAD_STEP = 3
HEALTH_FAULT = f"nan:grad:step:{HEALTH_BAD_STEP}"
HEALTH_TIMED_STEPS = 10  # a program, sentinel off and on in turns
HEALTH_PARITY_STEPS = 3  # card vs CPU, the fault on step 2
# /profilez's top-level keys in the JAX package
# (paddle_tpu/observability/profiling.py profilez_payload)
PROFILEZ_KEYS = ["device", "feed", "flight_recorder", "phase_seconds",
                 "signatures"]


@contextlib.contextmanager
def health_flags(action="skip", fault=HEALTH_FAULT, **flags):
    """FLAGS_health_sentinel on with ``action`` (and ``flags``) and the
    FaultPlan ``fault`` installed: a program's first run under them
    inserts the sentinel and plants the fault.  Restored after."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import fault_injection

    names = ["FLAGS_health_sentinel", "FLAGS_health_action",
             *flags]
    old = fluid.get_flags(names)
    fluid.set_flags({"FLAGS_health_sentinel": True,
                     "FLAGS_health_action": action, **flags})
    if fault:
        fault_injection.install(fault)
    else:
        fault_injection.uninstall()
    try:
        yield
    finally:
        fluid.set_flags(old)
        fault_injection.uninstall()


def _state_names(main, scope):
    """The persistables the sentinel guards: every one but its own."""
    return [n for n, v in main.global_block().vars.items()
            if v.persistable and not n.startswith("@HEALTH@")
            and scope.get(n) is not None]


def _health_scalar(scope, name):
    return float(scope.get(name).reshape(-1)[0])


def _health_modes(what, main, loss, feed, start, counters, per_run, steps,
                  action, disarm=False, bad_step=None):
    """``steps`` steps of ``main`` under the sentinel's ``action``, each
    mode of ``modes`` in turns from a copy of ``start``, with a new
    executor a mode (its sentinel attached at its first run); with
    ``disarm`` the planted fault's countdown reads 0, so it never fires.
    Every program run (a rollback's replay too) launches ``per_run`` on
    the card, as the step without the sentinel; the wrappers see the
    eager mode's runs and the captured mode's warm-up and capture.  On
    ``bad_step`` found_inf fires and every guarded persistable is
    bit-unchanged; found_inf fires on no other step (under rollback the
    replay's 0 is left).  Returns {mode: losses, found, scales (with
    loss scaling), runs, launches, device_launches} and {mode: scope},
    the executors closed."""
    scopes = {m: _clone_scope(start) for m, _ in MODES}
    exes = _executors()
    out = {m: dict(losses=[], found=[], scales=[], runs=0, launches={},
                   device_launches={}) for m in exes}
    for step in range(1, steps + 1):
        for m, exe in exes.items():
            sent = exe.health_sentinel(main)
            sent.ensure_state(scopes[m])
            if disarm:
                scopes[m].get("@HEALTH@fault_0").zero_()
            pre = ({n: scopes[m].get(n).clone()
                    for n in _state_names(main, scopes[m])}
                   if step == bad_step else None)
            replays = _counter_value("pt_health_rollbacks_total")
            before = _snap()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scopes[m])
            py, dev = _since(before, counters)
            runs = 1 + int(_counter_value("pt_health_rollbacks_total")
                           - replays)
            if dev != _times(per_run, runs):
                raise AssertionError(f"{what} ({m}, step {step}): {dev} on "
                                     f"the card over {runs} run(s)")
            r = out[m]
            r["runs"] += runs
            _add(r["launches"], py)
            _add(r["device_launches"], dev)
            r["losses"].append(float(lv))
            r["found"].append(_health_scalar(scopes[m], "@HEALTH@found_inf"))
            if scopes[m].get("@HEALTH@loss_scale") is not None:
                r["scales"].append(_health_scalar(scopes[m],
                                                  "@HEALTH@loss_scale"))
            if pre is not None:
                moved = [n for n, t in pre.items()
                         if not torch.equal(t, scopes[m].get(n))]
                if moved:
                    raise AssertionError(f"{what} ({m}): the skipped step "
                                         f"moved {moved[:5]}")
    for m, exe in exes.items():
        want = [1.0 if s == bad_step and not disarm else 0.0
                for s in range(1, steps + 1)]
        if action == "rollback":
            want = [0.0] * steps  # the replay's found_inf is left
        if out[m]["found"] != want:
            raise AssertionError(f"{what} ({m}): found_inf "
                                 f"{out[m]['found']}, expected {want}")
        want_py = _times(per_run, out[m]["runs"] if m == "eager" else 2)
        if out[m]["launches"] != want_py:
            raise AssertionError(f"{what} ({m}): the wrappers read "
                                 f"{out[m]['launches']}, expected {want_py}")
        exe.close()
    return out, scopes


def _modes_bit_equal(what, main, out, scopes):
    """The captured and the eager run's losses and guarded state equal
    bit for bit."""
    diff = [n for n in _state_names(main, scopes["captured"])
            if not torch.equal(scopes["captured"].get(n),
                               scopes["eager"].get(n))]
    if out["captured"]["losses"] != out["eager"]["losses"] or diff:
        raise AssertionError(f"{what}: captured and eager differ: "
                             f"{out['captured']['losses']} against "
                             f"{out['eager']['losses']}, state {diff[:5]}")


def _health_parity():
    """Full width, 2 layers, b4 s128, fp32, dropout 0, the sentinel on
    with the fault on step 2: HEALTH_PARITY_STEPS Adam steps on the card
    and on the CPU from one state, losses within TRAIN_LOSS_RTOL and
    the skipped step's guarded state bit-unchanged on both."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, num_layers=2,
                               use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    main, startup, loss = _bert_program(cfg, bf16=False)
    feed = bert.make_fake_batch(cfg, 4, 128, seed=1)
    gpu = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=gpu)
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    convert.load_params(cpu, {p.name: gpu.get(p.name).cpu().numpy()
                              for p in main.all_parameters()},
                        fluid.CPUPlace(), program=main)
    losses, found = {}, {}
    with health_flags(fault="nan:grad:step:2"):
        for key, scope, place in (("gpu", gpu, _gpu_place()),
                                  ("cpu", cpu, fluid.CPUPlace())):
            exe = fluid.Executor(place)
            losses[key], found[key] = [], []
            for step in range(1, HEALTH_PARITY_STEPS + 1):
                pre = ({n: scope.get(n).clone()
                        for n in _state_names(main, scope)}
                       if step == 2 else None)
                (lv,) = exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)
                losses[key].append(float(lv))
                found[key].append(_health_scalar(scope,
                                                 "@HEALTH@found_inf"))
                if pre is not None and any(
                        not torch.equal(t, scope.get(n))
                        for n, t in pre.items()):
                    raise AssertionError(f"health parity ({key}): the "
                                         f"skipped step moved the state")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["gpu"],
                                                  losses["cpu"]))
    if not rel < TRAIN_LOSS_RTOL or found["gpu"] != found["cpu"] \
            or found["gpu"] != [0.0, 1.0, 0.0]:
        raise AssertionError(f"health parity: losses {losses}, found "
                             f"{found}, max rel diff {rel}")
    return dict(losses=losses, found=found["gpu"], loss_max_rel_diff=rel,
                loss_rtol=TRAIN_LOSS_RTOL, skipped_step_bit_unchanged=True)


def _health_timing(cfg, start, feed):
    """Captured step p50 / p95 of phase 4's program with the sentinel off
    and on (``skip``, no fault planted), one executor each,
    HEALTH_TIMED_STEPS steps each in turns after a warm-up step, and
    each one's launch API calls, device busy and idle share (one
    profiled step).  The "on" step adds the check, the in-step gate and
    the host's read of found_inf."""
    from paddle_tpu_torch import fluid

    main_off, _, loss_off = _bert_program(cfg, bf16=True)
    main_on, _, loss_on = _bert_program(cfg, bf16=True)
    arms = {"off": (main_off, loss_off), "on": (main_on, loss_on)}
    scopes = {a: _clone_scope(start) for a in arms}
    exes = {a: fluid.Executor(_gpu_place()) for a in arms}
    old = fluid.get_flags("FLAGS_health_sentinel")
    fluid.set_flags({"FLAGS_health_sentinel": False})
    try:  # the off arm's first run attaches nothing, for good
        exes["off"].run(main_off, feed=feed, fetch_list=[loss_off],
                        scope=scopes["off"])
    finally:
        fluid.set_flags(old)
    with health_flags(fault=None):
        exes["on"].run(main_on, feed=feed, fetch_list=[loss_on],
                       scope=scopes["on"])
        secs = {a: [] for a in arms}
        for _ in range(HEALTH_TIMED_STEPS):
            for a, (main, loss) in arms.items():
                t0 = time.perf_counter()
                exes[a].run(main, feed=feed, fetch_list=[loss],
                            scope=scopes[a])
                secs[a].append(time.perf_counter() - t0)
        out = {a: _ms_quantiles(s) for a, s in secs.items()}
        for a, (main, loss) in arms.items():
            def step(a=a, main=main, loss=loss):
                exes[a].run(main, feed=feed, fetch_list=[loss],
                            scope=scopes[a])
            prof = _profile(step, 1)
            out[a].update(launch_api_calls=prof["launch_api_calls"],
                          device_busy_ms=prof["device_busy_ms"],
                          device_idle_share=prof.get("device_idle_share"))
    if exes["on"].health_sentinel(main_on) is None or any(
            op.type == "health_fault_inject"
            for op in main_on.global_block().ops):
        raise AssertionError("health timing: the on arm's program")
    out["on_over_off_p50"] = out["on"]["p50_ms"] / out["off"]["p50_ms"]
    for exe in exes.values():
        exe.close()
    return out


def run_health_path(counters):
    """Phase 28 (see the module docstring): the health sentinel on phase
    4's BERT-base b128 s128 bf16 train step.  ``counters``: the wrappers
    of K1-K4, set to 0 before the phase and read after it.  Returns the
    phase's readings; every step is gated."""
    import urllib.request

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.observability import profiling

    t_phase = time.perf_counter()
    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    for w in counters.values():
        w.launches = 0
    t_before = _snap()
    flight_dir = tempfile.TemporaryDirectory(prefix="pt_flight_")
    old_dir = fluid.get_flags("FLAGS_flight_recorder_dir")
    fluid.set_flags({"FLAGS_flight_recorder_dir": flight_dir.name})
    profiling.reset()
    out = {}
    try:
        per_run = _train_step_launches(cfg)
        main, startup, loss = _bert_program(cfg, bf16=True)
        start = fluid.Scope()
        fluid.Executor(_gpu_place()).run(startup, scope=start)
        # (1) skip: the planted NaN gradient's step is masked
        with health_flags("skip"):
            skip, skip_scopes = _health_modes(
                "health skip", main, loss, feed, start, counters, per_run,
                HEALTH_STEPS, "skip", bad_step=HEALTH_BAD_STEP)
        _modes_bit_equal("health skip", main, skip, skip_scopes)
        n_ops = [op.type for op in main.global_block().ops]
        for m, r in skip.items():
            bad_total = _health_scalar(skip_scopes[m],
                                       "@HEALTH@bad_steps_total")
            if bad_total != 1.0 or not np.isfinite(
                    r["losses"][HEALTH_BAD_STEP:]).all():
                raise AssertionError(f"health skip ({m}): bad_steps_total "
                                     f"{bad_total}, losses {r['losses']}")
        fr = profiling.flight_recorder()
        meta, records = profiling.read_flight_record(fr.last_dump_path)
        health = [r for r in records if r.get("kind") == "health"]
        steps = [r for r in records if r.get("kind") == "step"]
        if (meta.get("reason") != "health" or not steps or not health
                or health[0]["detect"] != "grad"):
            raise AssertionError(f"health skip: flight record {meta}, "
                                 f"{len(health)} health and {len(steps)} "
                                 f"step records")
        out["skip"] = dict(
            modes=skip, captured_eager_bit_equal=True,
            bad_steps_total=1.0, skipped_step_bit_unchanged=True,
            sentinel_ops=[t for t in n_ops if t.startswith(("health_",
                                                            "check_"))],
            flight_record=dict(reason=meta["reason"],
                               records=meta["records"],
                               health_records=health,
                               step_records=len(steps), dumps=fr.dumps))
        del skip_scopes
        torch.cuda.empty_cache()

        # (2) rollback: the run equals the one that never met the fault
        with health_flags("rollback"):
            rb, rb_scopes = _health_modes(
                "health rollback", main, loss, feed, start, counters,
                per_run, HEALTH_STEPS, "rollback")
            base, base_scopes = _health_modes(
                "health rollback base", main, loss, feed, start, counters,
                per_run, HEALTH_STEPS, "rollback", disarm=True)
        for m in rb:
            diff = [n for n in _state_names(main, rb_scopes[m])
                    if not torch.equal(rb_scopes[m].get(n),
                                       base_scopes[m].get(n))]
            if rb[m]["losses"] != base[m]["losses"] or diff \
                    or rb[m]["runs"] != HEALTH_STEPS + 1:
                raise AssertionError(
                    f"health rollback ({m}): {rb[m]['losses']} against the "
                    f"uninjected {base[m]['losses']}, state {diff[:5]}, "
                    f"{rb[m]['runs']} runs")
        _modes_bit_equal("health rollback", main, rb, rb_scopes)
        out["rollback"] = dict(modes=rb, uninjected=base,
                               bit_equal_uninjected=True)
        del rb_scopes, base_scopes
        torch.cuda.empty_cache()

        # (3) raise: RuntimeError naming the step
        with health_flags("raise"):
            exe = fluid.Executor(_gpu_place())
            sc = _clone_scope(start)
            raised = None
            for step in range(1, HEALTH_BAD_STEP + 1):
                try:
                    exe.run(main, feed=feed, fetch_list=[loss], scope=sc)
                except RuntimeError as e:
                    raised = (step, str(e))
                    break
            exe.close()
        if raised is None or raised[0] != HEALTH_BAD_STEP or \
                f"step {HEALTH_BAD_STEP} " not in raised[1]:
            raise AssertionError(f"health raise: {raised}")
        out["raise"] = dict(step=raised[0], message=raised[1][:160])
        del sc

        # (4) dynamic loss scaling: the scale halves on the bad step
        with health_flags("skip", FLAGS_health_loss_scaling=True):
            main_ls, _, loss_ls = _bert_program(cfg, bf16=True)
            ls, ls_scopes = _health_modes(
                "health loss scaling", main_ls, loss_ls, feed, start,
                counters, per_run, HEALTH_BAD_STEP + 1, "skip",
                bad_step=HEALTH_BAD_STEP)
        _modes_bit_equal("health loss scaling", main_ls, ls, ls_scopes)
        init = fluid.get_flags("FLAGS_health_loss_scale_init")[
            "FLAGS_health_loss_scale_init"]
        # halved on the bad step, then held (the next growth is 1000
        # good steps away)
        want = [init] * (HEALTH_BAD_STEP - 1) + [init / 2] * 2
        for m, r in ls.items():
            if r["scales"] != want or not np.isfinite(
                    r["losses"][HEALTH_BAD_STEP:]).all():
                raise AssertionError(f"health loss scaling ({m}): scales "
                                     f"{r['scales']}, expected {want}; "
                                     f"losses {r['losses']}")
        out["loss_scaling"] = dict(modes=ls, scale_init=init)
        del ls_scopes, main_ls
        torch.cuda.empty_cache()

        # (5) the card against the CPU
        out["parity"] = _health_parity()
        torch.cuda.empty_cache()

        # (6) the sentinel's cost a step, and the launch API calls
        out["timing"] = _health_timing(cfg, start, feed)
        torch.cuda.empty_cache()

        # (7) /profilez over a real scrape
        srv = obs.MetricsServer(port=0)
        try:
            resp = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/profilez", timeout=30)
            page = json.loads(resp.read())
            code = resp.status
        finally:
            srv.stop()
        single = [v for v in page["signatures"].values()
                  if v.get("lane") == "single"]
        if code != 200 or sorted(page) != PROFILEZ_KEYS or not single \
                or page["flight_recorder"]["dumps"] < 1:
            raise AssertionError(f"health /profilez: {code}, keys "
                                 f"{sorted(page)}")
        out["profilez"] = dict(status=code, keys=sorted(page),
                               signatures=len(page["signatures"]),
                               flight_recorder=page["flight_recorder"])
    finally:
        fluid.set_flags(old_dir)
        flight_dir.cleanup()
    py, dev = _since(t_before, counters)
    out["launches"] = py
    out["device_launches"] = dev
    out["program_runs_on_card"] = sum(
        r["runs"] for part in ("skip", "rollback", "loss_scaling")
        for r in out[part]["modes"].values()) + sum(
        r["runs"] for r in out["rollback"]["uninjected"].values())
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 29: GPT beam generation (three builds) and BERT's LR schedule on
# the BERT-base train step
# ---------------------------------------------------------------------------

GEN_BATCH, GEN_BEAM, GEN_PROMPT, GEN_NEW = 8, 4, 64, 32
GEN_BUILDS = ("build_gpt_generate", "build_gpt_generate_cached",
              "build_gpt_generate_scan")
GEN_RUNS = 2  # runs a mode and build; the first warms up (and captures)
# scores across the builds and card against CPU: fp32 log-probs summed
# over 32 steps, through flash (split TF32) or composed attention and
# two BLAS libraries
GEN_SCORE_RTOL = 1e-4
GEN_PARITY_LAYERS = 2
# the builds the card-vs-CPU check runs: the recompute build's CPU run
# (the whole prefix again each step: 2.3 TFLOP at 2 layers) is held
# through the cross-build gate on the card instead
GEN_PARITY_BUILDS = GEN_BUILDS[1:]
GEN_FLASH_CASES = (
    ("gen_recompute_s64_fp32", 32, 12, 64, 64, torch.float32, True, "zero",
     True),
    ("gen_recompute_s95_fp32", 32, 12, 95, 64, torch.float32, True, "zero",
     True),
    ("gen_prefill_s64_fp32", 8, 12, 64, 64, torch.float32, True, "zero",
     True))
# BERT's schedule on phase 4's step: a linear warm-up to SCHED_PEAK over
# SCHED_WARMUP steps, then polynomial_decay(power=1) to 0 at SCHED_DECAY
# (the Switch is crossed at step SCHED_WARMUP)
SCHED_STEPS, SCHED_WARMUP, SCHED_DECAY, SCHED_PEAK = 8, 4, 16, TRAIN_LR
SCHED_LR_RTOL = 1e-7


def check_flash_generate(dev, rng):
    """K1 (and K2, K3) against their plain versions and timed at the
    generation programs' causal fp32 prefills: the recompute build's
    [B·K·12, 64..95, 64] and the cached and scan builds' [B·12, 64,
    64]."""
    return check_flash(dev, rng, GEN_FLASH_CASES)


def gen_expected_launches(cfg, build):
    """{kernel: launches} a run of ``build``: one K1 a layer a causal
    prefix pass and one K4 a layer an FFN that the run needs.  The cached
    build's last step computes a decoder pass that no fetch reads (the
    plan prunes it), so its steps run 31 of their 32; the scan build's
    while body is a sub-block, which no graph pass rewrites, so its FFN
    stays unfused."""
    n, g = cfg.num_layers, GEN_NEW
    return {"build_gpt_generate": {"flash_fwd": n * g,
                                   "fused_bias_act": n * g},
            "build_gpt_generate_cached": {"flash_fwd": n,
                                          "fused_bias_act": n + n * (g - 1)},
            "build_gpt_generate_scan": {"flash_fwd": n,
                                        "fused_bias_act": n}}[build]


def _gen_pass_report(plan):
    """{kernel: launches} a run, read off the plan of the program after
    the graph passes (its pruned global block): one K1 a flash_attention
    op, one K4 a fused_bias_act_dropout op."""
    types = [step[0].type for step in plan.steps]
    return {"flash_fwd": types.count("flash_attention"),
            "fused_bias_act": types.count("fused_bias_act_dropout")}


def _gen_program(cfg, build):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, sent, scores = getattr(gpt, build)(
            cfg, GEN_PROMPT, GEN_NEW, beam_size=GEN_BEAM, end_id=0)
    startup.random_seed = SEED
    return main, startup, sent, scores


def gen_feed(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {"gpt_prompt": rng.randint(0, cfg.vocab_size, (
        GEN_BATCH, GEN_PROMPT)).astype("int64")}


def _gen_compare(what, got, ref, rtol=GEN_SCORE_RTOL):
    """ids equal and scores within ``rtol``; the largest relative score
    difference."""
    (ids, sc), (rids, rsc) = got, ref
    if not np.array_equal(ids, rids):
        where = np.argwhere(ids != rids)[:5].tolist()
        raise AssertionError(f"{what}: ids differ at {where}")
    rel = float((np.abs(sc - rsc) / np.abs(rsc)).max())
    if not rel <= rtol:
        raise AssertionError(f"{what}: scores {sc.ravel()[:4]} vs "
                             f"{rsc.ravel()[:4]}: relative {rel} > {rtol}")
    return rel


def run_generate_path(counters):
    """Phase 29 (1): the three GPT generation programs at GPTConfig()
    width (see the module docstring)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    t_path = time.perf_counter()
    cfg = gpt.GPTConfig()
    feed = gen_feed(cfg)
    scope = fluid.Scope()
    builds, results = {}, {}
    totals = {"launches": {}, "device_launches": {}}
    for bi, build in enumerate(GEN_BUILDS):
        what = f"generate {build}"
        t0 = time.perf_counter()
        main, startup, sent, scores = _gen_program(cfg, build)
        build_s = time.perf_counter() - t0
        if bi == 0:  # the three builds name the same parameters
            fluid.Executor(_gpu_place()).run(startup, scope=scope)
        exes = _executors()
        launches = {m: {} for m in exes}
        on_card = {m: {} for m in exes}
        secs = {m: [] for m in exes}
        got = {m: [] for m in exes}
        torch.cuda.synchronize()
        t_runs = time.perf_counter()
        for r in range(GEN_RUNS):
            for m, exe in exes.items():  # in turns
                before = _snap()
                t1 = time.perf_counter()
                ids, sc = exe.run(main, feed=feed, fetch_list=[sent, scores],
                                  scope=scope)
                dt = time.perf_counter() - t1  # the fetch syncs
                py, dev = _since(before, counters)
                _add(launches[m], py)
                _add(on_card[m], dev)
                got[m].append((ids, sc))
                if r:
                    secs[m].append(dt)
        (entry,) = exes["captured"].compiled_for(main)
        per_run = _gen_pass_report(entry.plan)
        if per_run != gen_expected_launches(cfg, build):
            raise AssertionError(f"{what}: the passes left {per_run} "
                                 f"kernel sites, expected "
                                 f"{gen_expected_launches(cfg, build)}")
        eager_only = entry.plan.eager_only
        if eager_only != (build == "build_gpt_generate_scan"):
            raise AssertionError(f"{what}: eager_only {eager_only} (host "
                                 f"ops {entry.plan.host_ops})")
        if eager_only:  # a while plan runs eagerly in both modes
            want = _times(per_run, GEN_RUNS)
            if any(launches[m] != want or on_card[m] != want
                   for m in exes):
                raise AssertionError(f"{what}: launches {launches} "
                                     f"(wrappers) and {on_card} (on the "
                                     f"card), expected {want} a mode")
            if entry.graph is not None:
                raise AssertionError(f"{what}: a while plan was captured")
        else:
            _gate_launches(what, launches, on_card, per_run, GEN_RUNS, 1)
            if entry.graph is None:
                raise AssertionError(f"{what}: no graph captured")
        ref = got["captured"][0]
        for m in exes:
            for i, (ids, sc) in enumerate(got[m]):
                if not (np.array_equal(ids, ref[0])
                        and np.array_equal(sc, ref[1])):
                    raise AssertionError(f"{what}: {m} run {i} differs "
                                         f"from the captured first run")
        ids, sc = ref
        if ids.shape != (GEN_BATCH, GEN_BEAM, GEN_NEW) \
                or not np.isfinite(sc).all() \
                or not np.all(np.diff(sc, axis=1) <= 0):
            raise AssertionError(f"{what}: ids {ids.shape}, scores {sc}")
        results[build] = ref
        t_prof = time.perf_counter()
        # the card's events alone (a run's launch API calls among them:
        # the host's op events of a 20,000-launch eager run make a trace
        # many times slower); a while plan runs the same eager loop under
        # either executor: it is profiled once (the captured executor's
        # run), for both
        prof = {m: _profile(lambda: exe.run(main, feed=feed,
                                            fetch_list=[sent, scores],
                                            scope=scope), 1,
                            device_only=True)
                for m, exe in exes.items()
                if not (eager_only and m == "eager")}
        if eager_only:
            prof["eager"] = prof["captured"]
        modes = {m: dict(**_ms_quantiles(v),
                         tokens_per_s=GEN_BATCH * GEN_NEW
                         / float(np.median(v)),
                         launch_api_calls=prof[m]["launch_api_calls"],
                         device_busy_ms=prof[m]["device_busy_ms"],
                         device_idle_share=prof[m].get("device_idle_share"),
                         launches=launches[m], device_launches=on_card[m])
                 for m, v in secs.items()}
        modes["captured"]["capture_s"] = _capture_seconds(exes["captured"],
                                                          main)
        seconds = dict(build=build_s, runs=t_prof - t_runs,
                       profiles=time.perf_counter() - t_prof)
        _close(exes)
        for key, per_mode in (("launches", launches),
                              ("device_launches", on_card)):
            _add(totals[key], _summed(per_mode))
        builds[build] = dict(
            ops=len(main.global_block().ops), seconds=seconds,
            kernels_a_run=per_run, eager_only=eager_only,
            captured_eager_bit_equal=True, modes=modes,
            scores_beam0=sc[:, 0].tolist())
        torch.cuda.empty_cache()
    rel = {b: _gen_compare(f"generate {b} vs {GEN_BUILDS[0]}", results[b],
                           results[GEN_BUILDS[0]])
           for b in GEN_BUILDS[1:]}
    return dict(model="GPTConfig()", batch=GEN_BATCH, beam=GEN_BEAM,
                prompt=GEN_PROMPT, new_tokens=GEN_NEW, dtype="float32",
                builds=builds, ids_equal_across_builds=True,
                score_max_rel_vs_recompute=rel,
                tokens_per_s_note="batch x new tokens over a run's p50",
                seconds=time.perf_counter() - t_path, **totals)


def _beam_gaps(fetched, k):
    """The smallest gap, over every row and step, between the K-th and
    the (K+1)-th best candidate beam_search chose among (its inputs as
    the card computed them: pre_ids, pre_scores, scores)."""
    gaps = []
    for pre_ids, pre, scores in fetched:
        total = pre[:, :, None].astype(np.float64) + scores
        total[pre_ids == 0] = -1e30  # a finished beam (end id 0): only
        fin = np.argwhere(pre_ids == 0)  # end id, at its own score
        for b, j in fin:
            total[b, j, 0] = pre[b, j]
        flat = np.sort(total.reshape(total.shape[0], -1), axis=1)[:, ::-1]
        gaps.append(flat[:, k - 1] - flat[:, k])
    return float(np.min(gaps))


def run_generate_parity():
    """Phase 29 (2): 2 layers at GPTConfig() width, fp32: the cached and
    scan builds on the card against a CPUPlace run from the same
    weights; ids equal, scores within GEN_SCORE_RTOL; beside the largest
    difference, the smallest gap between the K-th and (K+1)-th candidate
    over all steps of the cached build."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    t0 = time.perf_counter()
    cfg = gpt.GPTConfig(num_layers=GEN_PARITY_LAYERS)
    feed = gen_feed(cfg, seed=1)
    out = {}
    card_scope = cpu_scope = None
    for build in GEN_PARITY_BUILDS:
        main, startup, sent, scores = _gen_program(cfg, build)
        if card_scope is None:
            card_scope = fluid.Scope()
            fluid.Executor(_gpu_place()).run(startup, scope=card_scope)
            cpu_scope = _clone_scope(card_scope, "cpu")
        fetch = [sent, scores]
        steps = [op for op in main.global_block().ops
                 if op.type == "beam_search"]
        for op in steps:
            fetch += [op.input(s)[0] for s in ("PreIds", "PreScores",
                                               "Scores")]
        exe = fluid.Executor(_gpu_place())
        card = exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
        exe.close()
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch[:2], scope=cpu_scope)
        rel = _gen_compare(f"generate parity {build}", card[:2], cpu)
        row = dict(score_max_rel=rel, ids_equal=True)
        if steps:
            rest = card[2:]
            row["min_topk_gap"] = _beam_gaps(
                [tuple(rest[i:i + 3]) for i in range(0, len(rest), 3)],
                GEN_BEAM)
        out[build] = row
    return dict(layers=GEN_PARITY_LAYERS, builds=out,
                seconds=time.perf_counter() - t0)


def _sched_bert_program(cfg):
    """Phase 4's program with BERT's schedule for its learning rate;
    returns (main, startup, loss, lr)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        L = fluid.layers
        lr = L.linear_lr_warmup(
            L.polynomial_decay(SCHED_PEAK, SCHED_DECAY,
                               end_learning_rate=0.0, power=1.0),
            SCHED_WARMUP, 0.0, SCHED_PEAK)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    enable_bf16_policy(main)
    startup.random_seed = SEED
    return main, startup, loss, lr


def sched_lr(step):
    """The schedule's closed form at ``step`` (1-based, the step
    counter's value in that run)."""
    if step < SCHED_WARMUP:
        return SCHED_PEAK * step / SCHED_WARMUP
    return SCHED_PEAK * (1.0 - min(step, SCHED_DECAY) / SCHED_DECAY)


def run_sched_train_path(counters):
    """Phase 29 (3): phase 4's BERT-base b128 s128 bf16 step with BERT's
    schedule (see the module docstring)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    main, startup, loss, lr = _sched_bert_program(cfg)
    cmain, cstartup, closs = _bert_program(cfg, bf16=True)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    cscope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(cstartup, scope=cscope)
    exes = _executors()
    # the constant-LR step on an executor of its own: an executor's step
    # keys the random streams (dropout), so each runs one program
    cexe = _executors()["captured"]
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    losses = {m: [] for m in exes}
    lrs = {m: [] for m in exes}
    secs = {m: [] for m in list(exes) + ["constant_lr"]}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for _ in range(SCHED_STEPS):
        for m, exe in exes.items():  # in turns
            before = _snap()
            t1 = time.perf_counter()
            lv, lrv = exe.run(main, feed=feed, fetch_list=[loss, lr],
                              scope=scopes[m])
            secs[m].append(time.perf_counter() - t1)
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            losses[m].append(float(lv))
            lrs[m].append(float(np.asarray(lrv).reshape(-1)[0]))
        t1 = time.perf_counter()
        cexe.run(cmain, feed=feed, fetch_list=[closs], scope=cscope)
        secs["constant_lr"].append(time.perf_counter() - t1)
    what = "scheduled train path"
    _gate_launches(what, launches, on_card, _train_step_launches(cfg),
                   SCHED_STEPS, 1)
    want = [sched_lr(s) for s in range(1, SCHED_STEPS + 1)]
    rel = max(abs(a - b) / b for m in exes for a, b in zip(lrs[m], want))
    if not rel <= SCHED_LR_RTOL:
        raise AssertionError(f"{what}: learning rates {lrs} vs the closed "
                             f"form {want}: relative {rel}")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"{what}: captured and eager differ: losses "
                             f"{losses}, state {diff[:5]}")
    if not all(np.isfinite(losses["captured"])):
        raise AssertionError(f"{what}: losses {losses}")
    (entry,) = exes["captured"].compiled_for(main)
    if entry.plan.eager_only or entry.graph is None:
        raise AssertionError(f"{what}: the step is not one captured graph")
    ops = [op.type for op in main.global_block().ops]
    prof = _profile(lambda: exes["captured"].run(
        main, feed=feed, fetch_list=[loss, lr], scope=scopes["captured"]), 1)
    cprof = _profile(lambda: cexe.run(cmain, feed=feed, fetch_list=[closs],
                                      scope=cscope), 1)
    calls, ccalls = prof["launch_api_calls"], cprof["launch_api_calls"]
    if calls.get("cudaGraphLaunch") != 1 or calls != ccalls:
        raise AssertionError(f"{what}: launch API calls a step {calls}, the "
                             f"constant-LR step's {ccalls}")
    _close({**exes, "constant_lr": cexe})
    return dict(
        model="BertConfig.base(vocab_size=30528)", batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, dtype_policy="bf16", steps=SCHED_STEPS,
        schedule=dict(warmup=SCHED_WARMUP, decay_steps=SCHED_DECAY,
                      peak=SCHED_PEAK, end=0.0, power=1.0),
        conditional_blocks=ops.count("conditional_block"),
        lr=lrs["captured"], lr_closed_form=want, lr_max_rel=rel,
        losses=losses["captured"], captured_eager_bit_equal=True,
        one_graph=True, launch_api_calls=calls,
        launch_api_calls_constant_lr=ccalls,
        p50_ms={m: _ms_quantiles(v[1:])["p50_ms"] for m, v in secs.items()},
        p95_ms={m: _ms_quantiles(v[1:])["p95_ms"] for m, v in secs.items()},
        device_busy_ms=prof["device_busy_ms"],
        device_busy_ms_constant_lr=cprof["device_busy_ms"],
        launches=_summed(launches), device_launches=_summed(on_card),
        seconds=time.perf_counter() - t0)


def run_generate_phase(wrappers, say, smi):
    """Phase 29: generation, its card-vs-CPU parity and the scheduled
    BERT step, each with its counts zeroed just before and read just
    after; returns {path: readings}."""
    torch.cuda.empty_cache()
    gen = run_generate_path({k: wrappers[k] for k in ("flash_fwd",
                                                      "fused_bias_act")})
    say("generate path", {"card": smi, **gen})
    torch.cuda.empty_cache()
    say("generate parity", run_generate_parity())
    torch.cuda.empty_cache()
    sched = run_sched_train_path({k: wrappers[k] for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_bias_act")})
    say("scheduled train path", {"card": smi, **sched})
    torch.cuda.empty_cache()
    say("generate summary", {
        "card": smi,
        **{b: {m: dict(p50_ms=r["modes"][m]["p50_ms"],
                       tokens_per_s=r["modes"][m]["tokens_per_s"],
                       launch_api_calls=r["modes"][m]["launch_api_calls"])
               for m in r["modes"]}
           for b, r in gen["builds"].items()},
        "sched_p50_ms": sched["p50_ms"], "sched_lr_max_rel":
            sched["lr_max_rel"], "generate_seconds": gen["seconds"],
        "sched_seconds": sched["seconds"]})
    return {"generate": gen, "sched_train": sched}


# ---------------------------------------------------------------------------
# phase 30: persist — a job that outlives its process: preemption and
# resume of the BERT-base train step (AutoCheckpoint with the health
# sentinel's durable window), the predictor over Fluid's protobuf
# __model__, and a restarted DecodeEngine with the warm-start cache
# ---------------------------------------------------------------------------

PERSIST_STEPS = 12          # the uninterrupted run: steps 0-11
PERSIST_KILL_AFTER = 6      # the killed child's SIGTERM lands after it
PERSIST_SAVE_INTERVAL, PERSIST_KEEP = 4, 2
# planted in all three runs, so the checkpoint carries its countdown
# (the killed child never reaches it): the 9th run, step 8
PERSIST_FAULT = "nan:grad:step:9"
PERSIST_REQUESTS, PERSIST_NEW = 4, 32    # the decode lane's first 4
PERSIST_PRED_RUNS = 10
PERSIST_PRED_ATOL = 1e-6
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "fused_bias_act")

_PERSIST_CHILD = r"""
import json, sys
import chip_smoke as cs
out = getattr(cs, "persist_child_" + sys.argv[1])(*sys.argv[2:])
print("PERSIST_RESULT " + json.dumps(out), flush=True)
"""


def _persist_cfg():
    from paddle_tpu_torch.models import bert

    return bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                                attn_dropout=0.0)


def _persist_feed(cfg, step):
    from paddle_tpu_torch.models import bert

    return bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=100 + step)


@contextlib.contextmanager
def _persist_trainer():
    """Phase 30's train step: phase 28's BERT-base b128 s128 bf16,
    hidden dropout 0.1, Adam, captured, the sentinel on (skip) with
    PERSIST_FAULT planted; yields (cfg, main, loss, exe, scope,
    sentinel) from the seeded start."""
    from paddle_tpu_torch import fluid

    cfg = _persist_cfg()
    with health_flags("skip", fault=PERSIST_FAULT):
        main, startup, loss = _bert_program(cfg, bf16=True)
        exe = fluid.Executor(_gpu_place())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        sent = exe.health_sentinel(main)
        yield cfg, main, loss, exe, scope, sent
    exe.close()


def _persist_step(cfg, main, loss, exe, scope, step):
    """One step: its loss, found_inf, seconds and launches on the card
    (and the wrappers' counts so far)."""
    from paddle_tpu_torch import kernels

    before = _snap()
    t0 = time.perf_counter()
    (lv,) = exe.run(main, feed=_persist_feed(cfg, step), fetch_list=[loss],
                    scope=scope)
    found = bool(scope.get("@HEALTH@found_inf").reshape(-1)[0])
    secs = time.perf_counter() - t0
    _, dev = _since(before, TRAIN_KERNELS)
    return dict(step=step, loss=float(lv), found_inf=found, seconds=secs,
                device_launches=dev,
                wrapper_launches={k: kernels.launch_counts()[k]
                                  for k in TRAIN_KERNELS})


def _state_digest(main, scope):
    """{persistable: sha256 of its bytes, dtype and shape}, every one
    (the @HEALTH@ state included)."""
    import hashlib

    out = {}
    for n, v in main.global_block().vars.items():
        t = scope.get(n)
        if not v.persistable or not isinstance(t, torch.Tensor):
            continue
        a = t.detach().contiguous()
        raw = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a)
        out[n] = hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest() \
            + f"|{a.dtype}|{tuple(a.shape)}"
    return out


def persist_child_killed(dirname):
    """Step 1's killed child: steps 0.. with AutoCheckpoint, each step's
    reading printed as it ends; after PERSIST_KILL_AFTER it waits for
    the parent's SIGTERM, which snapshots and ends the process by the
    default action (it never returns)."""
    from paddle_tpu_torch.fluid.incubate.checkpoint import AutoCheckpoint

    with _persist_trainer() as (cfg, main, loss, exe, scope, sent):
        ck = AutoCheckpoint(dirname, exe, main, scope=scope,
                            save_interval=PERSIST_SAVE_INTERVAL,
                            keep_max=PERSIST_KEEP, sentinel=sent)
        for step in range(PERSIST_STEPS):
            r = _persist_step(cfg, main, loss, exe, scope, step)
            t0 = time.perf_counter()
            ck.step(step)
            r["ckpt_step_s"] = time.perf_counter() - t0
            print("PERSIST_STEP " + json.dumps(r), flush=True)
            if step == PERSIST_KILL_AFTER:
                time.sleep(600)  # the preemption arrives here
    raise AssertionError("persist killed child: no SIGTERM came")


def persist_child_resumed(dirname, export_dir):
    """Step 1's resumed child: resume(), then the steps left; writes the
    sentinel's state right after the restore to ``export_dir`` (a
    window ring) and returns the steps and the final state's digest."""
    from paddle_tpu_torch.fluid.incubate.checkpoint import AutoCheckpoint
    from paddle_tpu_torch.health import persist

    with _persist_trainer() as (cfg, main, loss, exe, scope, sent):
        ck = AutoCheckpoint(dirname, exe, main, scope=scope,
                            save_interval=10 ** 9, keep_max=PERSIST_KEEP,
                            sentinel=sent, install_signal_handler=False)
        t0 = time.perf_counter()
        start = ck.resume()
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        persist.save_window(export_dir, sent.export_state(scope), start)
        exe_step = exe._step
        steps = [_persist_step(cfg, main, loss, exe, scope, s)
                 for s in range(start, PERSIST_STEPS)]
        ck.close()
        return dict(start=start, resume_s=resume_s, executor_step=exe_step,
                    steps=steps, state=_state_digest(main, scope))


def _persist_spawn(args, env):
    """A new process running _PERSIST_CHILD on ``args`` with ``env``
    added to its environment: the decode children, whose readings start
    at their spawn (the train children are warm: take_warm_child)."""
    here = os.path.dirname(os.path.abspath(__file__))
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(PYTHONPATH=here, **env)
    return subprocess.Popen([sys.executable, "-c", _PERSIST_CHILD, *args],
                            cwd=here, env=full, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# warm children: phases 19's and 30's child processes, started at the top
# of the script beside the builds, which import the port and build their
# program's kind once (warming the meta kernels and the shape cache) at a
# lower priority and touch no card until their job arrives
# ---------------------------------------------------------------------------

_WARM_CHILD = r"""
import json, os, sys
os.nice(10)  # the parent's phase-3 host work first
import chip_smoke as cs
cs.warm_child_prepare(sys.argv[1])
print("WARM_READY", flush=True)
job = json.loads(sys.stdin.readline())
sys.argv = ["-c"] + job["argv"]
exec(job["code"], {"__name__": "__main__"})
"""
WARM_ROLES = {"persist": 2, "fleet": 1}  # role: children of it
_WARM = {}      # role: the started children no job has taken yet
_STARTED = []   # every warm child, closed when the script ends


def warm_child_prepare(role):
    """A warm child's work before its job: the port's imports and one
    build of its job's program kind (host only: no CUDA call)."""
    from paddle_tpu_torch import fluid, kernels, serving  # noqa: F401
    from paddle_tpu_torch.models import gpt

    if role == "persist":
        _bert_program(_persist_cfg(), bf16=True)
    else:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            gpt.build_gpt_decode_step(_model_config(), 8, 513, 16, 64)


class WarmChild:
    """A child process started now, which prepares (warm_child_prepare)
    and waits; ``start(code, argv)`` hands it its job, the code a new
    process would run with ``argv``, and returns its Popen (its stdout
    then carries the job's output, as a new process's would)."""

    def __init__(self, role):
        here = os.path.dirname(os.path.abspath(__file__))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = here
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WARM_CHILD, role], cwd=here, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        if not _STARTED:
            atexit.register(close_warm_children)
        _STARTED.append(self)

    def start(self, code, argv):
        line = self.proc.stdout.readline()
        if line.strip() != "WARM_READY":
            self.proc.kill()
            raise AssertionError(f"warm child: {line!r} "
                                 f"{self.proc.stderr.read()[-3000:]}")
        self.proc.stdin.write(json.dumps({"code": code, "argv": list(argv)})
                              + "\n")
        self.proc.stdin.close()
        self.proc.stdin = None  # communicate() writes nothing more
        return self.proc

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def start_warm_children(roles=tuple(WARM_ROLES)):
    """Start the children of ``roles`` (WARM_ROLES' counts) now, so that
    their preparation runs beside the builds; they end with the
    script."""
    for role in roles:
        if role not in _WARM:
            _WARM[role] = [WarmChild(role) for _ in range(WARM_ROLES[role])]


def take_warm_child(role):
    """A started warm child of ``role``, or a new one when none waits
    (its start() then waits for its preparation)."""
    left = _WARM.get(role)
    return left.pop(0) if left else WarmChild(role)


def close_warm_children():
    """Kill every warm child still running (one whose job failed or
    never came)."""
    _WARM.clear()
    while _STARTED:
        _STARTED.pop().close()


def _persist_result(proc, what, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    lines = [ln for ln in out.splitlines()
             if ln.startswith("PERSIST_RESULT ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"persist {what} child rc={proc.returncode}: "
                             f"{err[-3000:]}")
    return json.loads(lines[-1][len("PERSIST_RESULT "):])


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def run_persist_train(counters):
    """Step 1: the killed child, the resumed child and the uninterrupted
    run (here); every gate of the module docstring's phase 30."""
    from paddle_tpu_torch.health import persist

    per_step = _train_step_launches(_persist_cfg())
    tmp = tempfile.mkdtemp(prefix="pt_persist_")
    ck_dir = os.path.join(tmp, "ck")
    killed = take_warm_child("persist").start(_PERSIST_CHILD,
                                              ["killed", ck_dir])
    t0 = time.perf_counter()  # the job handed over: no import, no build
    steps_killed = []
    for line in killed.stdout:
        if line.startswith("PERSIST_STEP "):
            steps_killed.append(json.loads(line[len("PERSIST_STEP "):]))
            if steps_killed[-1]["step"] == PERSIST_KILL_AFTER:
                break
    if len(steps_killed) != PERSIST_KILL_AFTER + 1:
        killed.kill()
        raise AssertionError(f"persist killed child: {len(steps_killed)} "
                             f"steps, {killed.stderr.read()[-3000:]}")
    t_sig = time.perf_counter()
    killed.send_signal(signal.SIGTERM)
    rc = killed.wait(timeout=300)
    sigterm_to_exit = time.perf_counter() - t_sig
    killed.stdout.close()
    killed.stderr.close()
    if rc != -signal.SIGTERM:
        raise AssertionError(f"persist killed child ended with {rc}, not "
                             f"by SIGTERM's default action")
    killed_s = time.perf_counter() - t0
    ring_killed, m_killed = persist.load_window(os.path.join(
        ck_dir, "health_window"))
    export_dir = os.path.join(tmp, "export")
    proc = take_warm_child("persist").start(
        _PERSIST_CHILD, ["resumed", ck_dir, export_dir])
    t1 = time.perf_counter()
    resumed = _persist_result(proc, "resumed")
    resumed_s = time.perf_counter() - t1
    ring_resumed, m_resumed = persist.load_window(export_dir)
    # the uninterrupted run, here
    for w in counters.values():
        w.launches = 0
    with _persist_trainer() as (cfg, main, loss, exe, scope, sent):
        steps_ref = [_persist_step(cfg, main, loss, exe, scope, s)
                     for s in range(PERSIST_STEPS)]
        state_ref = _state_digest(main, scope)
    launches = {k: w.launches for k, w in counters.items()}
    # -- gates
    got = resumed["steps"]
    first_runs = _times(per_step, 2)  # a warm-up and a capture a run
    for what, seen in (("uninterrupted", launches),
                       ("killed", steps_killed[-1]["wrapper_launches"]),
                       ("resumed", got[-1]["wrapper_launches"])):
        if seen != first_runs:
            raise AssertionError(f"persist {what}: wrapper launches {seen}"
                                 f", expected {first_runs}")
    if resumed["start"] != PERSIST_KILL_AFTER + 1:
        raise AssertionError(f"persist: resume() returned "
                             f"{resumed['start']}")
    ref_tail = steps_ref[resumed["start"]:]
    for what, a, b in (("killed", steps_killed,
                        steps_ref[:PERSIST_KILL_AFTER + 1]),
                       ("resumed", got, ref_tail)):
        la = [(r["step"], r["loss"], r["found_inf"]) for r in a]
        lb = [(r["step"], r["loss"], r["found_inf"]) for r in b]
        if la != lb:
            raise AssertionError(f"persist: the {what} child's (step, loss, "
                                 f"found_inf) {la} against the "
                                 f"uninterrupted {lb}")
    found = [r["found_inf"] for r in steps_ref]
    if found.count(True) != 1 or not found[8]:
        raise AssertionError(f"persist: found_inf {found}")
    diff = sorted(n for n in state_ref
                  if resumed["state"].get(n) != state_ref[n])
    if diff or set(resumed["state"]) != set(state_ref):
        raise AssertionError(f"persist: final state differs from the "
                             f"uninterrupted run's in {diff[:8]}")
    if ring_killed is None or ring_resumed is None:
        raise AssertionError("persist: a sentinel ring is missing")
    for k in ("ema", "emvar", "good_samples", "bad_total_seen",
              "steps_seen", "keep"):
        if ring_killed[k] != ring_resumed[k]:
            raise AssertionError(f"persist: sentinel {k} "
                                 f"{ring_resumed[k]} after the restore, "
                                 f"{ring_killed[k]} at the last save")
    sh_k, sh_r = ring_killed["scope_health"], ring_resumed["scope_health"]
    if sorted(sh_k) != sorted(sh_r) or not all(
            torch.equal(sh_k[n], sh_r[n]) for n in sh_k):
        raise AssertionError("persist: the sentinel's @HEALTH@ state after "
                             "the restore differs from the last save's")
    for what, rows in (("killed", steps_killed), ("resumed", got),
                       ("uninterrupted", steps_ref)):
        bad = [r["step"] for r in rows if r["device_launches"] != per_step]
        if bad:
            raise AssertionError(f"persist {what}: launches on the card "
                                 f"{rows[0]['device_launches']}, not "
                                 f"{per_step} a step, at steps {bad}")
    complete, leftovers = [], []
    for r, ds, fs in os.walk(ck_dir):
        leftovers += [os.path.join(r, x) for x in ds + fs
                      if ".tmp" in x or x.startswith(".ckpt_tmp_")]
    for d in os.listdir(ck_dir):
        if os.path.exists(os.path.join(ck_dir, d, "checkpoint_meta.json")):
            complete.append(d)
    if len(complete) > PERSIST_KEEP or leftovers:
        raise AssertionError(f"persist: checkpoints {complete}, leftovers "
                             f"{leftovers}")
    save_row = steps_killed[PERSIST_SAVE_INTERVAL]
    ckpt_bytes = _dir_bytes(os.path.join(ck_dir, sorted(complete)[-1]))
    steady = [r["seconds"] for r in steps_ref[2:]]
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return dict(
        steps=PERSIST_STEPS, kill_after=PERSIST_KILL_AFTER,
        fault=PERSIST_FAULT, resume_start=resumed["start"],
        resumed_bit_equal=True, state_tensors=len(state_ref),
        losses=[r["loss"] for r in steps_ref], found_inf=found,
        sentinel_state_bit_equal=True, checkpoints=sorted(complete),
        executor_step_after_resume=resumed["executor_step"],
        save_s=save_row["ckpt_step_s"], checkpoint_bytes=ckpt_bytes,
        sigterm_to_exit_s=sigterm_to_exit, resume_s=resumed["resume_s"],
        first_step_after_resume_s=got[0]["seconds"],
        steady_step_p50_ms=1e3 * float(np.percentile(steady, 50)),
        killed_child_job_s=killed_s, resumed_child_job_s=resumed_s,
        children="warm: the port imported and a BERT-base program built "
                 "before the job, outside the *_job_s clocks, the job run at "
                 "nice 10; a fresh process's restart is the decode "
                 "children's to_first_token_s",
        per_step_device_launches=per_step,
        launches=_times(per_step, 6),  # 2 a run, three runs
        device_launches=_times(per_step, len(steps_killed) + len(got)
                               + len(steps_ref)))


def run_persist_predictor(counters):
    """Step 2: the BERT-base encoder predictor of phases 10 and 13 (b8
    s128 fp32, passes on) saved as JSON and in Fluid's protobuf format
    (one combined LoDTensor stream); a predictor of each format in each
    mode, run in turns."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.fluid import proto_compat

    layers = 12
    per_run = {**_no_launches(counters), "flash_fwd": layers,
               "fused_bias_act": layers}
    d = tempfile.mkdtemp(prefix="pt_persist_pred_")
    dirs = {"json": os.path.join(d, "json"),
            "protobuf": os.path.join(d, "protobuf")}
    cfg, feed = save_unfused_encoder(dirs["json"])
    cfg, feed = save_unfused_encoder(dirs["protobuf"],
                                     model_format="protobuf")
    with open(os.path.join(dirs["protobuf"], "__model__"), "rb") as f:
        is_proto = proto_compat.is_program_proto(f.read())
    if not is_proto:
        raise AssertionError("persist: the protobuf __model__ is not a "
                             "ProgramDesc")
    tensors = [inf.PaddleTensor(v, name=k) for k, v in feed.items()]

    def config(fmt):
        if fmt == "json":
            return inf.AnalysisConfig(dirs[fmt])
        return inf.AnalysisConfig(
            prog_file=os.path.join(dirs[fmt], "__model__"),
            params_file=os.path.join(dirs[fmt], "__params__"))

    preds, load_s = {}, {}
    for fmt in dirs:
        for m, capture in MODES:
            t0 = time.perf_counter()
            with capture_mode(capture):
                preds[fmt, m] = inf.create_paddle_predictor(
                    config(fmt), place=_gpu_place())
            load_s[fmt, m] = time.perf_counter() - t0
    # the float attrs the protobuf format rounds to float32
    ops = {fmt: [op for op in preds[fmt, "captured"]._program
                 .global_block().ops if op.type not in ("feed", "fetch")]
           for fmt in dirs}
    if [op.type for op in ops["json"]] != [op.type
                                           for op in ops["protobuf"]]:
        raise AssertionError("persist predictor: the two formats' loaded "
                             "programs differ in their ops")
    rounded = sorted({
        (op.type, k, v, pop.attrs[k])
        for op, pop in zip(ops["json"], ops["protobuf"])
        for k, v in op.attrs.items()
        if isinstance(v, float) and pop.attrs.get(k) != v})
    for w in counters.values():
        w.launches = 0
    outs = {k: [] for k in preds}
    secs = {k: [] for k in preds}
    launches = {fmt: {m: {} for m, _ in MODES} for fmt in dirs}
    on_card = {fmt: {m: {} for m, _ in MODES} for fmt in dirs}
    runs = 1 + PERSIST_PRED_RUNS
    for _ in range(runs):
        for (fmt, m), p in preds.items():
            before = _snap()
            t0 = time.perf_counter()
            (out,) = p.run(tensors)
            secs[fmt, m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[fmt][m], py)
            _add(on_card[fmt][m], dev)
            outs[fmt, m].append(out.as_ndarray())
    for fmt in dirs:
        _gate_launches(f"persist predictor {fmt}", launches[fmt],
                       on_card[fmt], per_run, runs, 1)
    ref = outs["json", "captured"][0]
    if ref.shape != (PRED_BATCH, PRED_SEQ, cfg.hidden_size) \
            or not np.isfinite(ref).all():
        raise AssertionError(f"persist predictor: output {ref.shape}")
    err = max(float(np.abs(o - ref).max()) for k in outs for o in outs[k])
    if not err <= PERSIST_PRED_ATOL:
        raise AssertionError(f"persist predictor: the formats differ by "
                             f"{err} > {PERSIST_PRED_ATOL} (float32-rounded "
                             f"attrs: {rounded})")
    import shutil

    shutil.rmtree(d, ignore_errors=True)
    preds.clear()
    return dict(
        model="BertConfig.base(vocab_size=30528) encoder, unfused",
        batch=PRED_BATCH, seq_len=PRED_SEQ, runs=PERSIST_PRED_RUNS,
        is_program_proto=True, formats_max_abs_err=err,
        bit_equal=err == 0.0, atol=PERSIST_PRED_ATOL,
        float32_rounded_attrs=[list(r) for r in rounded],
        load_s={f"{fmt}_{m}": v for (fmt, m), v in load_s.items()},
        run_p50_ms={f"{fmt}_{m}": 1e3 * float(np.percentile(v[1:], 50))
                    for (fmt, m), v in secs.items()},
        launches=_summed({f"{fmt}_{m}": launches[fmt][m]
                          for fmt in dirs for m, _ in MODES}),
        device_launches=_summed({f"{fmt}_{m}": on_card[fmt][m]
                                 for fmt in dirs for m, _ in MODES}))


def persist_child_decode(t_spawn):
    """Step 3's child: a DecodeEngine over GPTConfig() with the decode
    lane's seeded weights (FLAGS_aot_cache_dir from the environment):
    warmup() and the lane's first PERSIST_REQUESTS requests.  Returns
    the ids, the cache and compile readings and where the seconds from
    the process's start to its first token went."""
    t_import0 = time.monotonic()
    from paddle_tpu_torch import fluid, kernels
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.fluid import aot_cache
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine

    t0 = float(t_spawn)
    t_import = time.monotonic()
    torch.zeros(1, device="cuda")  # the CUDA context
    torch.cuda.synchronize()
    t_cuda = time.monotonic()
    cfg = _model_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    torch.cuda.synchronize()
    t_weights = time.monotonic()
    eng = DecodeEngine(cfg, scope=scope, place=_gpu_place(), pool_slots=8,
                       page_size=16, max_len=1024, name="persist",
                       auto_start=False, max_queue=PERSIST_REQUESTS)
    t_built = time.monotonic()
    before = _snap()
    eng.warmup()
    torch.cuda.synchronize()
    t_warm = time.monotonic()
    _, prompts = _lane_workload(cfg)
    reqs = [eng.submit_request(p, PERSIST_NEW)
            for p in prompts[:PERSIST_REQUESTS]]
    eng.start()
    ids = [r.future.result(timeout=600) for r in reqs]
    _, dev = _since(before, ("fused_bias_act", "paged_attention"))
    stats = eng.stats()
    snap = obs.snapshot()
    cache = {k[1]: v for k, v in snap["pt_compile_cache_total"]["samples"]
             .items() if k[0] == "single"}
    secs = {k[1]: v for k, v in snap["pt_compile_seconds_total"]["samples"]
            .items() if k[0] == "single"}
    hits = {name: [e.aot_hit for e in eng._exe.compiled_for(prog)]
            for name, prog in (("decode", eng._dec_prog),
                               ("prefill", eng._pf_prog))}
    t_first = min(r.t_first for r in reqs)
    kernel_load = sum(_build.LOAD_SECONDS.values())
    capture = secs.get("capture", 0.0)
    eng.close()
    return dict(
        ids=ids, cache=cache, compile_s=secs, aot_hit=hits,
        cache_bytes=aot_cache.cache_bytes(), device_launches=dev,
        program_runs=stats["prefill_chunks"] + stats["steps"] + 2,
        wrapper_launches={k: kernels.launch_counts()[k]
                          for k in ("fused_bias_act", "paged_attention")},
        to_first_token_s=dict(
            total=t_first - t0, python_and_torch=t_import0 - t0,
            port_imports=t_import - t_import0, cuda_init=t_cuda - t_import,
            weights=t_weights - t_cuda,
            program_build=t_built - t_weights,
            passes_and_plan=secs.get("passes", 0.0) + secs.get("trace",
                                                               0.0),
            cache=secs.get("aot_load", 0.0) + secs.get("aot_save", 0.0),
            kernel_load=kernel_load,
            eager_warmup=secs.get("first_run", 0.0) - capture - kernel_load,
            capture=capture, warmup=t_warm - t_built,
            serve_to_first_token=t_first - t_warm))


def run_persist_decode(lane_ids=None):
    """Step 3: two fresh children, the cold one with an empty
    FLAGS_aot_cache_dir, the warm one with what the cold one left; their
    ids equal to each other's and to the decode lane's (``lane_ids``,
    the lane's first PERSIST_REQUESTS requests, when the lane ran; else
    an engine here serves them)."""
    cache = tempfile.mkdtemp(prefix="pt_persist_aot_")
    runs = {}
    for name in ("cold", "warm"):
        proc = _persist_spawn(["decode", repr(time.monotonic())],
                              env={"FLAGS_aot_cache_dir": cache})
        runs[name] = _persist_result(proc, f"decode {name}")
    if lane_ids is None:
        lane_ids = _persist_lane_ids()
    cold, warm = runs["cold"], runs["warm"]
    cfg = _model_config()
    for name, r in runs.items():
        want = r["program_runs"] * cfg.num_layers
        if r["device_launches"] != {"fused_bias_act": want,
                                    "paged_attention": want}:
            raise AssertionError(f"persist decode {name}: launches "
                                 f"{r['device_launches']}, {want} each")
    if cold["ids"] != warm["ids"] or cold["ids"] != lane_ids:
        raise AssertionError("persist decode: ids differ between the cold "
                             "child, the warm child and the decode lane")
    if not (cold["cache"].get("aot_hit", 0) == 0
            and all(h == [True] for h in warm["aot_hit"].values())
            and warm["cache"].get("miss", 0) == 0
            and warm["compile_s"].get("trace", 0.0) == 0.0
            and warm["compile_s"].get("passes", 0.0) == 0.0):
        raise AssertionError(f"persist decode: cold {cold['cache']} "
                             f"{cold['compile_s']}, warm {warm['cache']} "
                             f"{warm['compile_s']} {warm['aot_hit']}")
    import shutil

    shutil.rmtree(cache, ignore_errors=True)
    return dict(requests=PERSIST_REQUESTS, new_tokens=PERSIST_NEW,
                ids_equal=True, cache_bytes=cold["cache_bytes"],
                cold=dict((k, cold[k]) for k in (
                    "cache", "compile_s", "to_first_token_s")),
                warm=dict((k, warm[k]) for k in (
                    "cache", "compile_s", "aot_hit", "to_first_token_s")),
                device_launches={k: cold["device_launches"][k]
                                 + warm["device_launches"][k]
                                 for k in cold["device_launches"]},
                launches={k: cold["wrapper_launches"][k]
                          + warm["wrapper_launches"][k]
                          for k in cold["wrapper_launches"]})


def _persist_lane_ids():
    """The decode lane's ids of its first PERSIST_REQUESTS requests,
    served here by a captured engine over its seeded weights."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine

    cfg = _model_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 8, 513, 16, 64)
    startup.random_seed = SEED
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    eng = DecodeEngine(cfg, scope=scope, place=_gpu_place(), pool_slots=8,
                       page_size=16, max_len=1024, name="persist-lane",
                       auto_start=False, max_queue=PERSIST_REQUESTS)
    eng.warmup()
    _, prompts = _lane_workload(cfg)
    futs = [eng.submit(p, PERSIST_NEW) for p in prompts[:PERSIST_REQUESTS]]
    eng.start()
    ids = [f.result(timeout=600) for f in futs]
    eng.close()
    return ids


def run_persist_phase(wrappers, say, smi, lane_ids=None):
    """Phase 30: its three steps, each with its counts zeroed just
    before and read just after; returns the phase's readings (launches
    summed over the steps, the children's included)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    train = run_persist_train({k: wrappers[k] for k in TRAIN_KERNELS})
    say("persist train", {"card": smi, **train})
    torch.cuda.empty_cache()
    pred = run_persist_predictor({k: wrappers[k] for k in TRAIN_KERNELS})
    say("persist predictor", {"card": smi, **pred})
    torch.cuda.empty_cache()
    dec = run_persist_decode(lane_ids)
    say("persist decode", {"card": smi, **dec})
    torch.cuda.empty_cache()
    out = {"train": train, "predictor": pred, "decode": dec,
           "seconds": time.perf_counter() - t0}
    for key in ("launches", "device_launches"):
        total = {}
        for part in (train, pred, dec):
            _add(total, part[key])
        out[key] = total
    say("persist summary", {
        "card": smi, "save_s": train["save_s"],
        "checkpoint_bytes": train["checkpoint_bytes"],
        "sigterm_to_exit_s": train["sigterm_to_exit_s"],
        "resume_s": train["resume_s"],
        "first_step_after_resume_s": train["first_step_after_resume_s"],
        "steady_step_p50_ms": train["steady_step_p50_ms"],
        "predictor_load_s": pred["load_s"],
        "predictor_run_p50_ms": pred["run_p50_ms"],
        "predictor_formats_max_abs_err": pred["formats_max_abs_err"],
        "decode_to_first_token_s": {
            k: dec[k]["to_first_token_s"] for k in ("cold", "warm")},
        "aot_cache_bytes": dec["cache_bytes"],
        "persist_seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# phase 31: ResNet-50 over the data-parallel lane (synced batch-norm
# statistics, K8's momentum form)
# ---------------------------------------------------------------------------

RESNET_DP_BATCH = DP_REPLICAS * 32  # b32 a replica
RESNET_DP_WARMUP, RESNET_DP_STEPS = 2, 4
# a moving statistic after a step against its rule: each replica folds
# its batch statistic into the old value (momentum 0.9) and
# c_allreduce_avg averages the four results, in another order than the
# rule computed here in float64.  Under the bf16 policy the collective's
# inputs are cast to bf16 like any compute op's, so from the first step
# on the statistics are bf16 (the JAX package does the same).  The
# batch variance comes back from SavedVariance, the inverse standard
# deviation (fp32).  Held within RESNET_DP_STAT_ULPS ulps of the
# statistic's own dtype at the terms' size (0.9·|old| + 0.1·max over
# replicas of |batch|): the fold and the average round a few times; a
# statistic left unsynced, or synced as a sum, is off by a share of
# itself
RESNET_DP_STAT_ULPS = 8
# card against CPU replicas: ResNet-50 fp32 at 64x64, b4 a replica over
# 2 replicas, 2 steps each from the card's state, phase 21's gates (the
# same conditioning: RESNET_PARITY_CHANGE_RTOL on each update); the
# card's runs of every parity eager (the modes are held bit-equal on
# the paths themselves)
RESNET_DP_PARITY_REPLICAS, RESNET_DP_PARITY_STEPS = 2, 2


def _resnet_dp_strategy():
    """Phase 31's build strategy: the quantized all-reduce, the moving
    statistics synced, the fused update."""
    from paddle_tpu_torch import fluid

    bs = fluid.BuildStrategy()
    bs.quant_allreduce = True
    bs.sync_batch_norm = True
    bs.fused_update = True
    return bs


def _resnet_dp_compiled(main, loss, places):
    from paddle_tpu_torch import fluid

    return fluid.CompiledProgram(
        main, build_strategy=_resnet_dp_strategy()).with_data_parallel(
            loss_name=loss.name, places=places)


def _bn_ops(main):
    """The program's training batch norms: (Mean, Variance, SavedMean,
    SavedVariance, momentum, epsilon) each."""
    return [(op.inputs["Mean"][0], op.inputs["Variance"][0],
             op.outputs["SavedMean"][0], op.outputs["SavedVariance"][0],
             float(op.attrs.get("momentum", 0.9)),
             float(op.attrs.get("epsilon", 1e-5)))
            for op in main.global_block().ops if op.type == "batch_norm"]


def _replicas_differ(runner, scope, names):
    """The names whose replicas are not bit-identical (compared on the
    card, one read back for all), or whose scope tensor is not replica
    0's."""
    flags, owner = [], []
    for name in names:
        vals = runner.replica_values(name)
        if scope.get(name) is not vals[0]:
            return [name]
        for v in vals[1:]:
            flags.append((v != vals[0]).any())
            owner.append(name)
    bad = torch.stack(flags).cpu().numpy()
    return sorted({n for n, b in zip(owner, bad) if b})


def _folded_stats_ulps(bns, prev, scope, saved, n):
    """Worst distance, in ulps of the statistic's dtype at the terms'
    size, of each moving statistic in ``scope`` from the mean over ``n``
    replicas of momentum·old + (1 − momentum)·batch (``saved``: each
    SavedMean and SavedVariance fetched, the replicas' values
    concatenated)."""
    worst = {"mean": 0.0, "variance": 0.0, "dtypes": set()}
    for mean, var, smean, sinv, mom, eps in bns:
        bm = np.asarray(saved[smean], np.float64).reshape(n, -1)
        bv = 1.0 / np.asarray(saved[sinv], np.float64).reshape(n, -1) ** 2 \
            - eps
        for kind, name, batch in (("mean", mean, bm), ("variance", var, bv)):
            old = prev[name].double().cpu().numpy()
            t = scope.get(name)
            now = t.double().cpu().numpy()
            want = (mom * old + (1 - mom) * batch).mean(axis=0)
            size = mom * np.abs(old) + (1 - mom) * np.abs(batch).max(axis=0)
            ulp = float(torch.finfo(t.dtype).eps)
            ulps = float((np.abs(now - want) / (ulp * np.maximum(
                size, 1e-30))).max())
            worst[kind] = max(worst[kind], ulps)
            worst["dtypes"].add(str(t.dtype))
    worst["dtypes"] = sorted(worst["dtypes"])
    return worst


def run_resnet_dp_path(counters):
    """Phase 31: phase 21's ResNet-50 (224², the bf16 policy,
    Momentum(0.1, 0.9)) over [CUDAPlace(0)] x DP_REPLICAS, b32 a replica,
    quantized all-reduce, sync_batch_norm, the fused update; the captured
    and the eager executor in turns from one state, RESNET_DP_WARMUP +
    RESNET_DP_STEPS steps each.  Gated after every step of each mode:
    finite losses (falling over the run), every replica's parameters,
    velocities and moving statistics bit-identical and replica 0's the
    scope's, every moving statistic changed and within
    RESNET_DP_STAT_ULPS of its rule (_folded_stats_ulps); K8's group
    form launched as the plan's group steps take it a step, K1-K7 and
    K8's per-parameter form never (on the card and in the wrappers);
    the modes' losses and state bit-equal.  One card runs the four
    replicas: not a scaling figure."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_update as fu

    progs = {m: _image_program() for m, _ in MODES}
    main, startup, loss, _ = progs["captured"]
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    n = DP_REPLICAS
    compiled = {m: _resnet_dp_compiled(progs[m][0], progs[m][2],
                                       [_gpu_place()] * n) for m in exes}
    feed = _image_feed(RESNET_DP_BATCH, RESNET_IMAGE, RESNET_CLASSES)
    bns = _bn_ops(main)
    saved_names = [b[2] for b in bns] + [b[3] for b in bns]
    stats = _state_of(main, "stats")
    velocities = _state_of(main, "velocity")
    params = [p.name for p in main.all_parameters()]
    saved0 = _counter_value("pt_fused_update_bytes_saved_total")
    names = list(counters) + ["fused_update_kernel"]
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    stat_ulps = {m: [] for m in exes}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    fu.fused_update_kernel.launches = 0
    steps = RESNET_DP_WARMUP + RESNET_DP_STEPS
    for i in range(steps):
        for m, exe in exes.items():  # in turns
            prev = {s: scopes[m].get(s).clone() for s in stats}
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            out = exe.run(compiled[m], feed=feed,
                          fetch_list=[loss] + saved_names, scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)  # the fetch syncs
            py, dev = _since(before, names)
            _add(launches[m], py)
            _add(on_card[m], dev)
            if i >= RESNET_DP_WARMUP:
                peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append([float(v) for v in out[0]])
            differ = _replicas_differ(compiled[m]._dp_runner, scopes[m],
                                      params + velocities + stats)
            if differ:
                raise AssertionError(
                    f"resnet dp ({m}, step {i}): replicas differ on, or "
                    f"replica 0 is not the scope's: {differ[:5]}")
            unmoved = [s for s in stats
                       if torch.equal(scopes[m].get(s), prev[s])]
            ulps = _folded_stats_ulps(bns, prev, scopes[m],
                                      dict(zip(saved_names, out[1:])), n)
            stat_ulps[m].append(ulps)
            if unmoved or max(ulps["mean"],
                              ulps["variance"]) > RESNET_DP_STAT_ULPS:
                raise AssertionError(
                    f"resnet dp ({m}, step {i}): moving statistics "
                    f"unchanged {unmoved[:5]}, or off their rule by "
                    f"{ulps} ulps (limit {RESNET_DP_STAT_ULPS})")
    runner = compiled["captured"]._dp_runner
    prog = runner.program
    (exec_plan,) = runner._plans.values()
    cap = _build.load("fused_update",
                      fu._SIGNATURES).pt_fused_update_group_capacity()
    groups = exec_plan.group_sizes
    n_fused = sum(op.type == "fused_momentum_quant_grad"
                  for op in prog.global_block().ops)
    if not groups or {t for t, _ in groups} != {"fused_momentum_quant_grad"} \
            or sum(c for _, c in groups) != n_fused \
            or n_fused != len(params):
        raise AssertionError(f"resnet dp: plan groups {groups}, "
                             f"{n_fused} fused momentum ops for "
                             f"{len(params)} parameters")
    group_launches = sum(-(-c * n // cap) for _, c in groups)
    per = {k: 0 for k in names}
    per["fused_update"] = group_launches
    _gate_launches("resnet dp path", launches, on_card, per, steps, 1)
    means = [float(np.mean(x)) for x in losses["captured"]]
    if not np.isfinite(losses["captured"]).all() or not means[-1] < means[0]:
        raise AssertionError(f"resnet dp losses not finite and falling: "
                             f"{losses['captured']}")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"resnet dp: captured and eager differ: losses "
                             f"{losses}, state {diff[:5]}")
    n_avg = sum(op.type == "c_allreduce_avg" for op in prog.global_block().ops)
    if n_avg != 2 * len(bns):
        raise AssertionError(f"resnet dp: {n_avg} c_allreduce_avg ops for "
                             f"{len(bns)} batch norms")
    fwd = cnn_flops_per_image(main)
    modes = {}
    for m in exes:
        timed = np.asarray(secs[m][RESNET_DP_WARMUP:])
        p50 = float(np.median(timed))
        modes[m] = dict(
            images_per_s=RESNET_DP_BATCH * RESNET_DP_STEPS
            / float(timed.sum()),
            step_p50_ms=1e3 * p50,
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=secs[m][0],
            mfu=3 * fwd * RESNET_DP_BATCH / p50 / BF16_TC_FLOPS,
            peak_memory_gb=peak[m] / 1e9, launches=launches[m],
            device_launches=on_card[m],
            stat_ulps_worst={k: max(u[k] for u in stat_ulps[m])
                             for k in ("mean", "variance")},
            stat_dtypes=sorted({d for u in stat_ulps[m]
                                for d in u["dtypes"]}))
    (graph,) = [e.graph for e in runner._entries.values()]
    if exes["captured"].capture and graph is None:
        raise AssertionError("resnet dp: the captured executor holds no "
                             "graph")
    modes["captured"]["capture_s"] = getattr(graph, "capture_seconds", None)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    plan = prog._quant_allreduce_plan
    path = dict(
        model="models.resnet.build_resnet(depth=50), bench.py:412-452",
        replicas=n, places=f"[CUDAPlace(0)] x {n}",
        global_batch=RESNET_DP_BATCH, image=list(RESNET_IMAGE),
        optimizer=f"Momentum({RESNET_LR}, {RESNET_MOMENTUM})",
        dtype_policy="bf16", build_strategy=dict(
            quant_allreduce=True, sync_batch_norm=True, fused_update=True),
        steps=RESNET_DP_STEPS, warmup_steps=RESNET_DP_WARMUP,
        losses=losses["captured"], plan_groups=groups, group_table=cap,
        group_launches_per_step=group_launches,
        fused_momentum_quant_grad_ops=n_fused, batch_norms=len(bns),
        c_allreduce_avg_ops=n_avg,
        stat_ulps_limit=RESNET_DP_STAT_ULPS,
        buckets=[[b["elements"], b["algo"], b["fused_update"]]
                 for b in plan["buckets"]],
        modeled_wire_bytes_per_step=prog._collective_bytes_per_step,
        fused_update_bytes_saved_per_step=prog._fused_update_bytes_saved,
        pt_fused_update_bytes_saved_total=_counter_value(
            "pt_fused_update_bytes_saved_total") - saved0,
        images_per_s_note=("global images a step over the host-clock step; "
                           "one card runs the four replicas, so this is "
                           "not a scaling figure"),
        replicas_bit_identical=True, captured_eager_bit_equal=True,
        moving_stats_change_each_step=True, modes=modes,
        launches=_summed(launches), device_launches=_summed(on_card))
    state = dict(exes=exes, compiled=compiled, scopes=scopes, feed=feed,
                 loss=loss, fetch=[loss] + saved_names)
    return state, path


def run_resnet_dp_parity():
    """ResNet-50 fp32 at RESNET_PARITY_IMAGE over
    RESNET_DP_PARITY_REPLICAS replicas of RESNET_PARITY_BATCH images
    each, phase 31's build strategy, RESNET_DP_PARITY_STEPS Momentum steps
    at RESNET_PARITY_LR on the card, CPU replicas taking each step from
    the card's state (parameters, velocities, moving statistics):
    run_resnet_parity's gates, each replica's loss within
    RESNET_PARITY_LOSS_RTOL and each update within
    RESNET_PARITY_CHANGE_RTOL of the CPU's, the CPU's own conditioning
    (the same step with the input scaled by 1 + 1e-6) beside it."""
    from paddle_tpu_torch import convert, fluid

    n = RESNET_DP_PARITY_REPLICAS
    feed = _image_feed(n * RESNET_PARITY_BATCH, RESNET_PARITY_IMAGE,
                       RESNET_CLASSES, seed=1)
    nudged = dict(feed, img=feed["img"] * np.float32(1 + 1e-6))
    runs = {}
    for key, place in (("card", _gpu_place()), ("cpu", fluid.CPUPlace()),
                       ("nudged", fluid.CPUPlace())):
        main, startup, loss, _ = _image_program(
            image=RESNET_PARITY_IMAGE, lr=RESNET_PARITY_LR, bf16=False)
        scope = fluid.Scope()
        with capture_mode(False):
            exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        runs[key] = (main, loss, scope, exe,
                     _resnet_dp_compiled(main, loss, [place] * n))
    main, _, gpu = runs["card"][:3]
    names = sorted({p.name for p in main.all_parameters()}
                   | set(_state_of(main, "stats")))
    persist = sorted(nm for nm, v in main.global_block().vars.items()
                     if v.persistable and gpu.get(nm) is not None)

    def rel(x, y, floor):
        return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), floor,
                                                 1e-30))

    losses = {"card": [], "cpu": []}
    worst, nudge = ("", 0.0), []
    for _ in range(RESNET_DP_PARITY_STEPS):
        start = {nm: np.array(gpu.get(nm).cpu()) for nm in persist}
        for key in ("cpu", "nudged"):
            convert.load_params(runs[key][2], start, fluid.CPUPlace(),
                                program=runs[key][0])
        for key in ("card", "cpu", "nudged"):
            m_, loss, scope, exe, cp = runs[key]
            out = exe.run(cp, feed=nudged if key == "nudged" else feed,
                          fetch_list=[loss], scope=scope)[0]
            if key in losses:
                losses[key].append([float(v) for v in out])
        cpu, ncpu = runs["cpu"][2], runs["nudged"][2]
        for nm in names:
            g, c = gpu.get(nm).cpu().numpy(), cpu.get(nm).numpy()
            floor = 1e-6 * np.linalg.norm(start[nm])
            worst = max(worst, (nm, rel(g - start[nm], c - start[nm],
                                        floor)), key=lambda t: t[1])
            nudge.append(rel(ncpu.get(nm).numpy() - start[nm],
                             c - start[nm], floor))
    a, b = np.asarray(losses["card"]), np.asarray(losses["cpu"])
    loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
    if not (np.all(np.isfinite(a)) and a[-1].mean() < a[0].mean()
            and loss_rel <= RESNET_PARITY_LOSS_RTOL
            and worst[1] <= RESNET_PARITY_CHANGE_RTOL):
        raise AssertionError(f"resnet dp parity: losses {losses} (max rel "
                             f"{loss_rel}), worst update {worst}")
    return dict(model="resnet50 fp32", replicas=n,
                batch_per_replica=RESNET_PARITY_BATCH,
                image=list(RESNET_PARITY_IMAGE), lr=RESNET_PARITY_LR,
                steps=RESNET_DP_PARITY_STEPS,
                each_step_from_the_cards_state=True, losses=losses,
                loss_max_rel=loss_rel, loss_rtol=RESNET_PARITY_LOSS_RTOL,
                change_worst=list(worst),
                change_rtol=RESNET_PARITY_CHANGE_RTOL,
                **{"cpu_update_vs_input_1e-6": dict(
                    median=float(np.median(nudge)),
                    max=float(np.max(nudge)))})


# ---------------------------------------------------------------------------
# phase 32: AMP decorate on the BERT-base step, bf16 and fp16
# ---------------------------------------------------------------------------

AMP_ARMS = {"bf16": {},
            "fp16": dict(dest_dtype="float16", init_loss_scaling=2.0 ** 15,
                         use_dynamic_loss_scaling=True, incr_every_n_steps=4,
                         decr_every_n_nan_or_inf=1)}
AMP_WARMUP, AMP_STEPS = 2, 4


def amp_pass_sites(cfg):
    """The JAX package's graph-pass sites on the decorated BERT train
    step: BERT builds flash_attention itself, the AMP rewrite leaves each
    FFN's and the MLM head's bias + GeLU to fuse, no fused loss
    (tests/test_torch_port_amp.py holds these to the JAX package's
    report on BERT-base)."""
    return {"fuse_attention": 0, "fuse_bias_act_dropout": cfg.num_layers + 1,
            "fuse_softmax_cross_entropy": 0}

# card against CPU, 2 layers at full width, dropout 0, b2 s64, 2 steps
# from one state, at each batch of AMP_PARITY_SEEDS: each arm's losses
# (largest relative difference), the first gradient on every leaf above
# the gradient floor (its worst leaf's difference over its norm) and
# the updates (the worst held leaf's largest and mean absolute
# difference, _update_readings) within AMP_PARITY_LIMITS; each limit
# lies between the card's readings and those of AMP_CONTROLS, card runs
# with K4's result rounded wrong, each of which must be over one of
# them.  On an H100 (700 W), seeds 1 and 2: bf16 read losses 1.55e-4 and
# 1.51e-4, first gradients 5.76e-3 and 6.06e-3, its control (toward
# zero) 3.68e-4 / 7.71e-3 and 1.75e-4 / 8.08e-3, so the gradient's limit
# catches it (the losses do not on seed 2); fp16 read losses 1.20e-5
# and 1.42e-5, first gradients 7.31e-4 and 7.75e-4, toward zero
# 3.65e-5 / 9.43e-4 and 3.03e-5 / 9.45e-4 (the loss limit catches it),
# through 8 bits 2.00e-5 / 2.14e-3 and 9.06e-6 / 2.03e-3 (the
# gradient's); the updates read at most 3.94e-4 (max, two Adam steps:
# a sign flip moves 2 lr a step) and 1.25e-6 (mean, bf16) and 4.16e-7
# (fp16) and separate no control.  Each run repeats its readings
# (seeded inputs, deterministic kernels on both devices)
AMP_PARITY_BATCH, AMP_PARITY_SEQ, AMP_PARITY_STEPS = 2, 64, 2
AMP_PARITY_SEEDS = {"bf16": (1, 2), "fp16": (1, 2)}
AMP_PARITY_LIMITS = {
    "bf16": dict(loss=2e-4, first_grad=6.8e-3, update_max_abs=4.5e-4,
                 update_mean_abs=2e-6),
    "fp16": dict(loss=2.1e-5, first_grad=1.25e-3, update_max_abs=4.5e-4,
                 update_mean_abs=6e-7)}
# the planted faults: K4's fp32 result rounded toward zero in the
# output dtype (one unit in the last place where nearest-even went
# away from zero), or to bf16's 8 bits and then to fp16
AMP_CONTROLS = {"bf16": ("toward_zero",),
                "fp16": ("toward_zero", "to_8_bits")}


def _amp_program(cfg, arm):
    """The BERT train step under decorate(Adam(TRAIN_LR), **AMP_ARMS[arm])
    (no bf16 policy); returns (main, startup, loss, the decorated
    optimizer, the found-inf var's name)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib import mixed_precision as mp
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        dec = mp.decorate(fluid.optimizer.Adam(learning_rate=TRAIN_LR),
                          **AMP_ARMS[arm])
        dec.minimize(loss, startup_program=startup)
    startup.random_seed = SEED
    (found,) = [op.outputs["FoundInfinite"][0]
                for op in main.global_block().ops
                if op.type == "check_finite_and_unscale"]
    return main, startup, loss, dec, found


def amp_scale_rule(found, arm):
    """The loss scale after each step by update_loss_scaling's rule over
    the steps' found-inf flags (fp32 arithmetic, as the op's)."""
    kw = AMP_ARMS[arm]
    s = np.float32(kw.get("init_loss_scaling", 1.0))
    if not kw.get("use_dynamic_loss_scaling"):
        return [float(s)] * len(found)
    good = bad = 0
    out = []
    for f in found:
        good, bad = (0, bad + 1) if f else (good + 1, 0)
        if bad >= kw["decr_every_n_nan_or_inf"]:
            s = max(np.float32(s * np.float32(0.8)), np.float32(1.0))
            good = bad = 0
        elif good >= kw["incr_every_n_steps"]:
            s = np.float32(s * np.float32(2.0))
            good = 0
        out.append(float(s))
    return out


@contextlib.contextmanager
def _k4_dtype_recorder(seen):
    """Records (x dtype, bias dtype) of each K4 call and the q dtype of
    each K1 call into ``seen`` while the block runs (the ops look both
    up in their modules at each call)."""
    from paddle_tpu_torch.kernels import fused_bias_act as fba
    from paddle_tpu_torch.kernels.primitives import flash

    k4, k1 = fba.fused_bias_gelu, flash.flash_fwd

    def rec4(x, bias, *a, **kw):
        seen.setdefault("fused_bias_act", set()).add((str(x.dtype),
                                                      str(bias.dtype)))
        return k4(x, bias, *a, **kw)

    def rec1(q, *a, **kw):
        seen.setdefault("flash_fwd", set()).add(str(q.dtype))
        return k1(q, *a, **kw)

    rec4.launches = rec1.launches = 0
    fba.fused_bias_gelu, flash.flash_fwd = rec4, rec1
    try:
        yield seen
    finally:
        fba.fused_bias_gelu, flash.flash_fwd = k4, k1


def run_amp_arm(counters, arm):
    """Phase 32, one arm: BERT-base b128 s128 (attention dropout 0,
    hidden dropout 0.1, the default passes) under decorate, the captured
    and the eager executor in turns from one state, AMP_WARMUP +
    AMP_STEPS steps each.  Gated: finite losses; the loss scale after
    every step equal to amp_scale_rule over the card's own found-inf
    flags; the modes' losses, flags and state bit-equal; the pass report
    amp_pass_sites; K1 24, K2 12, K3 12, K4 13 a step on the card and in
    the wrappers; K1 fed fp32 and K4 the arm's dtype with an fp32 bias
    (one more eager step, recorded)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                               attn_dropout=0.0)
    main, startup, loss, dec, found = _amp_program(cfg, arm)
    scale_name = dec.get_loss_scaling().name
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    steps = AMP_WARMUP + AMP_STEPS
    losses = {m: [] for m in exes}
    founds = {m: [] for m in exes}
    scales = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for i in range(steps):
        for m, exe in exes.items():
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            lv, fv = exe.run(main, feed=feed, fetch_list=[loss, found],
                             scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            if i >= AMP_WARMUP:
                peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
            losses[m].append(float(lv))
            founds[m].append(bool(np.asarray(fv).reshape(-1)[0]))
            scales[m].append(float(scopes[m].get(scale_name).reshape(-1)[0]))
    what = f"amp {arm}"
    _gate_launches(what, launches, on_card, _train_step_launches(cfg),
                   steps, 1)
    want_scales = amp_scale_rule(founds["captured"], arm)
    if not all(np.isfinite(losses["captured"])) \
            or scales["captured"] != want_scales:
        raise AssertionError(f"{what}: losses {losses['captured']}, found "
                             f"inf {founds['captured']}, scales "
                             f"{scales['captured']} (the rule: "
                             f"{want_scales})")
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if (losses["captured"], founds["captured"], scales["captured"]) != (
            losses["eager"], founds["eager"], scales["eager"]) or diff:
        raise AssertionError(f"{what}: captured and eager differ: losses "
                             f"{losses}, state {diff[:5]}")
    sites = {e["pass"]: e["sites"] for e in main._pass_report}
    if sites != amp_pass_sites(cfg):
        raise AssertionError(f"{what}: pass report {sites}, expected "
                             f"{amp_pass_sites(cfg)}")
    seen = {}
    with _k4_dtype_recorder(seen):
        exes["eager"].run(main, feed=feed, fetch_list=[loss],
                          scope=_clone_scope(scopes["eager"]))
    dest = "torch.bfloat16" if arm == "bf16" else "torch.float16"
    if seen != {"fused_bias_act": {(dest, "torch.float32")},
                "flash_fwd": {"torch.float32"}}:
        raise AssertionError(f"{what}: kernel input dtypes {seen}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = bert.train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    modes = {}
    for m in exes:
        timed = np.asarray(secs[m][AMP_WARMUP:])
        modes[m] = dict(
            tokens_per_s=tokens * AMP_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * float(np.percentile(timed, 50)),
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=secs[m][0],
            mfu=flops / float(np.median(timed)) / BF16_TC_FLOPS,
            peak_memory_gb=peak[m] / 1e9, launches=launches[m],
            device_launches=on_card[m])
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"], main)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    path = dict(model="BertConfig.base(vocab_size=30528)",
                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                amp=dict(AMP_ARMS[arm], dest_dtype=dest.split(".")[1]),
                steps=AMP_STEPS, warmup_steps=AMP_WARMUP,
                losses=losses["captured"], found_inf=founds["captured"],
                loss_scales=scales["captured"], pass_sites=sites,
                kernel_input_dtypes={k: sorted(v) for k, v in seen.items()},
                captured_eager_bit_equal=True, model_flops_per_step=flops,
                mfu_peak_flops=BF16_TC_FLOPS, modes=modes,
                launches=_summed(launches), device_launches=_summed(on_card))
    state = dict(exes=exes, main=main, scopes=scopes, feed=feed, loss=loss,
                 fetch=[loss, found])
    return state, path


@contextlib.contextmanager
def _planted_k4_rounding(how):
    """A control of phase 32's parity: K4's result computed in fp32 (its
    plain version) and rounded wrong into its dtype: ``toward_zero``
    (every inexact value one step toward zero where nearest-even went
    away from it) or ``to_8_bits`` (through bf16 first).  The op looks
    ``fused_bias_gelu`` up in its module at each call."""
    from paddle_tpu_torch.kernels import fused_bias_act as fba

    kernel = fba.fused_bias_gelu

    def planted(x, bias, mask=None, scale=1.0, approximate=False,
                force=None):
        y = fba.fused_bias_gelu_reference(x.float(), bias, mask, scale,
                                          approximate)
        if how == "to_8_bits":
            return y.to(torch.bfloat16).to(x.dtype)
        r = y.to(x.dtype)
        # one step toward zero: the magnitude's bits less one
        down = (r.view(torch.int16) - 1).view(x.dtype)
        return torch.where(r.float().abs() > y.abs(), down, r)

    planted.launches = 0
    fba.fused_bias_gelu = planted
    try:
        yield
    finally:
        fba.fused_bias_gelu = kernel


def _amp_parity_run(cfg, arm, place, feed, init, plant_inf=False):
    """AMP_PARITY_STEPS steps (and with ``plant_inf`` one more on a batch
    whose input_mask holds an inf) of the 2-layer AMP program on
    ``place`` from ``init`` (None: the startup's every persistable,
    returned).  Returns the losses, ``init``, the parameters after
    AMP_PARITY_STEPS steps (``final``) and after the run (``last``),
    each parameter's first-step gradient (unscaled), the found-inf flags
    and the loss scales."""
    from paddle_tpu_torch import convert, fluid

    main, startup, loss, dec, found = _amp_program(cfg, arm)
    scope = fluid.Scope()
    with capture_mode(False):
        exe = fluid.Executor(place)
    _run_startup(exe, startup, scope, init)
    persist = [n for n, v in main.global_block().vars.items()
               if v.persistable and scope.get(n) is not None]
    if init is None:
        init = {n: scope.get(n).cpu().numpy().copy() for n in persist}
    else:
        convert.load_params(scope, init, place, program=main)
    grads = dict(main._params_grads)
    feeds = [feed] * AMP_PARITY_STEPS
    if plant_inf:
        bad = {k: v.copy() for k, v in feed.items()}
        bad["input_mask"][0, 0] = np.inf
        feeds.append(bad)
    losses, first, scales, flags, final = [], None, [], [], None
    planted = None
    for i, f in enumerate(feeds):
        if i == AMP_PARITY_STEPS:
            final = {p: scope.get(p).float().cpu().numpy().astype(np.float64)
                     for p in grads}
        fetch = [loss, found] + (list(grads.values())
                                 if i in (0, AMP_PARITY_STEPS) else [])
        out = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        if i == AMP_PARITY_STEPS:  # the gated grads of the planted step
            planted = {p: np.asarray(g, np.float64)
                       for p, g in zip(grads, out[2:])}
        losses.append(float(out[0]))
        flags.append(bool(np.asarray(out[1]).reshape(-1)[0]))
        scales.append(float(scope.get(dec.get_loss_scaling().name)
                            .reshape(-1)[0]))
        if i == 0:
            first = {p: np.asarray(g, np.float64)
                     for p, g in zip(grads, out[2:])}
    last = {p: scope.get(p).float().cpu().numpy().astype(np.float64)
            for p in grads}
    return dict(losses=losses, init=init, final=final or last, last=last,
                first=first, scales=scales, found_inf=flags,
                planted_grads=planted)


def _amp_parity_setup(seed=1):
    """The parity's 2-layer configuration and its batch of ``seed``."""
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(vocab_size=30528, num_layers=2,
                               use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    return cfg, bert.make_fake_batch(cfg, AMP_PARITY_BATCH, AMP_PARITY_SEQ,
                                     seed=seed)


def _save_run(path, run):
    """One _amp_parity_run result as an npz file."""
    arrays = {f"{k}:{n}": v for k in ("init", "final", "last", "first",
                                      "planted_grads")
              for n, v in (run.get(k) or {}).items()}
    lists = {k: run[k] for k in ("losses", "scales", "found_inf")}
    np.savez(path, __lists__=np.array(json.dumps(lists)), **arrays)


def _load_run(z):
    """An _amp_parity_run result from its arrays (_save_run)."""
    run = json.loads(str(z["__lists__"]))
    for k in ("init", "final", "last", "first", "planted_grads"):
        run[k] = {n.split(":", 1)[1]: v for n, v in z.items()
                  if n.startswith(k + ":")} or None
    return run


def amp_cpu_child(dirname):
    """The CPU reference child's part for phase 32: for each arm, the
    starting state (every persistable of the 2-layer AMP program after
    its startup on the CPU) into ``amp.<arm>.init``, and its parity run
    on the CPU at each of AMP_PARITY_SEEDS[arm] (the fp16 arm's first
    with the planted inf) into ``amp.<arm>.<seed>.cpu``."""
    from paddle_tpu_torch import fluid

    for arm in AMP_ARMS:
        run = None
        for seed in AMP_PARITY_SEEDS[arm]:
            cfg, feed = _amp_parity_setup(seed)
            run = _amp_parity_run(cfg, arm, fluid.CPUPlace(), feed,
                                  run and run["init"],
                                  arm == "fp16" and run is None)
            if seed == AMP_PARITY_SEEDS[arm][0]:
                _child_result(dirname, f"amp.{arm}.init", **run["init"])
            _save_run(os.path.join(dirname, f"amp.{arm}.{seed}.cpu.npz"),
                      run)


# ---------------------------------------------------------------------------
# the CPU reference child: the CPU runs of phases 18's, 26's and 32's
# parities, made in child processes (a process a part, two for phase
# 18's) at a lower priority that see no card, beside the builds and
# phase 3; the script waits for them to end before phase 4's host
# readings
# ---------------------------------------------------------------------------

_CPU_CHILD = r"""
import os, sys, time
import torch
import chip_smoke as cs
os.nice(10)  # the parent's work first: the child takes idle cores
torch.set_num_threads(int(sys.argv[2]))
for arg in sys.argv[3:]:
    part, _, half = arg.partition(":")
    t0 = time.perf_counter()
    if half:
        cs.CPU_CHILD_PARTS[part](sys.argv[1], int(half))
    else:
        cs.CPU_CHILD_PARTS[part](sys.argv[1])
    print(f"CPU_CHILD_PART {arg} {time.perf_counter() - t0:.3f}", flush=True)
print("CPU_CHILD_OK", flush=True)
"""
CPU_CHILD_PARTS = {"gpt": gpt_cpu_child, "nmt": nmt_cpu_child,
                   "amp": amp_cpu_child}
# parts that run as two processes (gpt_cpu_child's ``half``); each part,
# or half, is a process of its own, the cores shared among them
CPU_CHILD_HALVES = ("gpt",)


def _child_result(dirname, name, **arrays):
    """One result of the child: ``<dir>/<name>.npz``, whole once it has
    its name (written under another, then renamed)."""
    part = os.path.join(dirname, name + ".part.npz")
    np.savez(part, **arrays)
    os.replace(part, os.path.join(dirname, name + ".npz"))


def _wait_child_result(dirname, name, timeout=600):
    """The arrays of another process's result ``name`` once written."""
    path = os.path.join(dirname, name + ".npz")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise AssertionError(f"CPU child: {name} never written")
        time.sleep(0.2)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class CpuChild:
    """The CPU reference child of ``parts`` (keys of CPU_CHILD_PARTS),
    started on a temporary directory with CUDA_VISIBLE_DEVICES empty
    (its readings compute on the CPU: _f64): a process a part (two for a
    part of CPU_CHILD_HALVES), the cores but one shared among them as
    torch threads (its many mid-sized ops run faster side by side than
    as one process's threads).  ``join()`` waits for them to end and
    returns their readings; ``take(name)`` then returns the arrays of
    its result ``name``; ``close()`` ends them and removes the
    directory."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
        here = os.path.dirname(os.path.abspath(__file__))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=here, CUDA_VISIBLE_DEVICES="")
        args = [a for p in self.parts for a in (
            [f"{p}:0", f"{p}:1"] if p in CPU_CHILD_HALVES else [p])]
        cores = (os.cpu_count() or 2) - 1
        threads = max(1, -(-cores // max(1, len(args))))
        self.t0 = time.perf_counter()
        self.procs = []
        for a in args:
            log = open(os.path.join(self.dir, f"child.{a}.log"), "w")
            self.procs.append((log, subprocess.Popen(
                [sys.executable, "-c", _CPU_CHILD, self.dir, str(threads),
                 a], cwd=here, env=env, stdout=log,
                stderr=subprocess.STDOUT, text=True)))
        self.threads = threads
        self.readings = None

    def join(self, timeout=900):
        """Wait for the child's end (raises if it failed); returns its
        seconds, each part's, and the seconds waited here."""
        if self.readings is None:
            t0 = time.perf_counter()
            parts = {}
            for log, proc in self.procs:
                try:
                    rc = proc.wait(timeout=max(1.0, timeout - (
                        time.perf_counter() - t0)))
                except subprocess.TimeoutExpired:
                    rc = None
                log.flush()
                with open(log.name) as f:
                    text = f.read()
                if rc != 0 or "CPU_CHILD_OK" not in text:
                    raise AssertionError(f"the CPU reference child failed "
                                         f"(rc {rc}): {text[-3000:]}")
                parts.update({ln.split()[1]: float(ln.split()[2])
                              for ln in text.splitlines()
                              if ln.startswith("CPU_CHILD_PART ")})
            self.readings = dict(parts=parts, processes=len(self.procs),
                                 threads=self.threads,
                                 waited_s=time.perf_counter() - t0,
                                 seconds=time.perf_counter() - self.t0)
        return self.readings

    def take(self, name):
        """The arrays of the child's result ``name``; its file removed."""
        self.join()
        path = os.path.join(self.dir, name + ".npz")
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}
        os.remove(path)
        return out

    def close(self):
        for log, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def _amp_parity_reading(arm, init, cpu, card, controls):
    """One seed's readings of phase 32's parity: the card run (``card``)
    and each control's against the CPU's (``cpu``), all from ``init``:
    the losses' largest relative difference, the first gradient's worst
    held leaf (_grad_rel) and the updates' worst held leaves
    (_update_readings)."""
    n = AMP_PARITY_STEPS

    def loss_rel(r):
        return max(abs(a - b) / abs(b)
                   for a, b in zip(r["losses"][:n], cpu["losses"][:n]))

    start = {p: init[p].astype(np.float64) for p in cpu["final"]}
    readings = _update_readings(start, card["final"], cpu["final"],
                                cpu["first"])
    held = [p for p in cpu["first"] if p not in readings["floor_leaves"]]

    def of(r, worst):
        return dict(loss_max_rel_diff=loss_rel(r),
                    first_grad=_grad_rel(r["first"], cpu["first"], held),
                    update_max_abs=worst["max_abs"]["max_abs"],
                    update_mean_abs=worst["mean_abs"]["mean_abs"])

    return dict(
        losses_gpu=card["losses"], losses_cpu=cpu["losses"],
        **of(card, readings["worst_held"]), updates=readings["worst_held"],
        controls={how: of(r, _update_readings(start, r["final"],
                                              cpu["final"], cpu["first"])
                          ["worst_held"])
                  for how, r in controls.items()})


def _amp_parity_over(arm, r):
    """The limits of AMP_PARITY_LIMITS[arm] that reading ``r``
    (_amp_parity_reading's card or control) is over."""
    lim = AMP_PARITY_LIMITS[arm]
    got = dict(loss=r["loss_max_rel_diff"], first_grad=r["first_grad"]["rel"],
               update_max_abs=r["update_max_abs"],
               update_mean_abs=r["update_mean_abs"])
    return sorted(k for k, v in got.items() if not v <= lim[k])


def _amp_parity_gate(arm, reading):
    """Phase 32's parity gates on one arm's ``reading``: at every seed
    the card run within every limit and each control over one."""
    for seed, r in reading["seeds"].items():
        over = _amp_parity_over(arm, r)
        if over:
            raise AssertionError(f"amp parity {arm}, seed {seed}: over "
                                 f"{over}: {reading}")
        for how, c in r["controls"].items():
            if not _amp_parity_over(arm, c):
                raise AssertionError(f"amp parity {arm}, seed {seed}: the "
                                     f"control {how} is within every "
                                     f"limit: {reading}")


def run_amp_parity(arm, child):
    """Phase 32's card against CPU for one arm: 2 layers at full width,
    dropout 0, AMP_PARITY_BATCH x AMP_PARITY_SEQ, AMP_PARITY_STEPS steps
    from one state (the CPU's startup) at each of AMP_PARITY_SEEDS[arm]'s
    batches (the CPU's runs, its K4 the plain version, made by the CPU
    reference ``child``).  Gates (_amp_parity_gate): the losses, every
    held leaf's first gradient and the updates' worst held leaves within
    AMP_PARITY_LIMITS[arm], and each AMP_CONTROLS[arm] fault (on the
    card) over one of them.  fp16 arm: one more step on its first
    batch with an inf in input_mask, on both: found-inf on both, the
    scale cut to 0.8 of itself on both, and the parameters as the rule
    leaves them on each device (_found_inf_rule: the gated grads 0 or
    NaN, as the JAX package's check_finite_and_unscale multiplies an inf
    or NaN element to NaN, and each parameter NaN exactly where its grad
    is).  The two devices' NaN elements may differ: where an inf bias
    makes a NaN is each kernel's own."""
    init = child.take(f"amp.{arm}.init")
    n = AMP_PARITY_STEPS
    seeds, planted = {}, None
    for seed in AMP_PARITY_SEEDS[arm]:
        cfg, feed = _amp_parity_setup(seed)
        plant = arm == "fp16" and seed == AMP_PARITY_SEEDS[arm][0]
        card = _amp_parity_run(cfg, arm, _gpu_place(), feed, init, plant)
        cpu = _load_run(child.take(f"amp.{arm}.{seed}.cpu"))
        controls = {}
        for how in AMP_CONTROLS[arm]:
            with _planted_k4_rounding(how):
                controls[how] = _amp_parity_run(cfg, arm, _gpu_place(),
                                                feed, init)
        seeds[seed] = _amp_parity_reading(arm, init, cpu, card, controls)
        seeds[seed].update(scales_gpu=card["scales"],
                           scales_cpu=cpu["scales"],
                           found_inf_gpu=card["found_inf"],
                           found_inf_cpu=cpu["found_inf"])
        if plant:
            want = float(np.float32(card["scales"][n - 1])
                         * np.float32(0.8))
            rule = {k: _found_inf_rule(r) for k, r in (("card", card),
                                                        ("cpu", cpu))}
            planted = dict(scale_after=want, **rule)
            if not (card["found_inf"][n] and cpu["found_inf"][n]
                    and card["scales"][n] == cpu["scales"][n] == want
                    and all(r["holds"] for r in rule.values())):
                raise AssertionError(f"amp parity {arm}, the planted inf: "
                                     f"{planted}, {seeds[seed]}")
    reading = dict(arm=arm, batch=AMP_PARITY_BATCH, seq_len=AMP_PARITY_SEQ,
                   steps=n, limits=AMP_PARITY_LIMITS[arm], seeds=seeds)
    if planted is not None:
        reading["planted_inf"] = planted
    _amp_parity_gate(arm, reading)
    return reading


def _found_inf_rule(run):
    """What check_finite_and_unscale and Adam leave on a found-inf step,
    as the JAX package's rule has it: every grad element multiplied by
    zero (0, or NaN where it was inf or NaN), and each parameter NaN
    exactly where its grad is (the others moved by Adam's decayed
    moments).  Returns the counts and whether the rule holds."""
    grads, params = run["planted_grads"], run["last"]
    bad_grad = sum(int(((g != 0) & ~np.isnan(g)).sum())
                   for g in grads.values())
    mismatch = sum(int((np.isnan(params[p]) != np.isnan(g)).sum())
                   for p, g in grads.items())
    nan = sum(int(np.isnan(g).sum()) for g in grads.values())
    return dict(holds=bad_grad == 0 and mismatch == 0,
                nonzero_finite_grad_elements=bad_grad,
                nan_mask_mismatches=mismatch, nan_grad_elements=nan,
                elements=sum(g.size for g in grads.values()))


def run_amp_path(counters, say, smi, child, train=None):
    """Phase 32: both arms (run_amp_arm) with a profiled step of each arm
    and mode, then each arm's parity (run_amp_parity, its CPU runs the
    CPU reference ``child``'s); beside phase 4's bf16-policy step where
    it ran in the same call (``train``)."""
    out = {}
    for arm in AMP_ARMS:
        torch.cuda.empty_cache()
        state, path = run_amp_arm(counters, arm)
        say(f"amp {arm} path", {"card": smi, **path})
        say(f"amp {arm} step", {"card": smi, **profile_modes(state)})
        del state
        out[arm] = path
    torch.cuda.empty_cache()
    for arm in AMP_ARMS:
        out[arm]["parity"] = run_amp_parity(arm, child)
        say(f"amp {arm} parity", out[arm]["parity"])
    out["launches"] = _summed({a: out[a]["launches"] for a in AMP_ARMS})
    out["device_launches"] = _summed({a: out[a]["device_launches"]
                                      for a in AMP_ARMS})
    say("amp summary", {
        "card": smi,
        **{f"{a}_{m}_p50_ms": out[a]["modes"][m]["step_p50_ms"]
           for a in AMP_ARMS for m in ("captured", "eager")},
        **{f"{a}_captured_mfu": out[a]["modes"]["captured"]["mfu"]
           for a in AMP_ARMS},
        "bf16_policy_step_p50_ms": None if train is None else {
            m: train["modes"][m]["step_p50_ms"] for m in train["modes"]},
        "fp16_loss_scales": out["fp16"]["loss_scales"]})
    return out


# ---------------------------------------------------------------------------
# phase 33: the MoE FFN on the BERT-base step
# ---------------------------------------------------------------------------

MOE_EXPERTS, MOE_TOP_K = 4, 2  # tests/test_moe.py:61
MOE_TURN_STEPS, MOE_CAPTURED_STEPS = 2, 4
MOE_PARITY_BATCH, MOE_PARITY_STEPS = 4, 3


def moe_train_flops_per_step(cfg, batch, seq):
    """The FLOPs the MoE step really computes: models/bert.py
    train_flops_per_step (a dense FFN, 4·b·s·h·i a layer forward) plus,
    a layer, the dense dispatch's other E − 1 experts' FFNs, the gate
    (2·b·s·h·E) and the combine (2·b·s·h·E), x 3 for the backward."""
    from paddle_tpu_torch.models import bert

    b, s, h, i = batch, seq, cfg.hidden_size, cfg.intermediate_size
    e = cfg.moe_experts
    extra = (e - 1) * 4 * b * s * h * i + 4 * b * s * h * e
    return bert.train_flops_per_step(cfg, b, s) + 3.0 * cfg.num_layers * extra


def _moe_config(**kw):
    from paddle_tpu_torch.models import bert

    return bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                                attn_dropout=0.0, moe_experts=MOE_EXPERTS,
                                moe_top_k=MOE_TOP_K, **kw)


def run_moe_path(counters):
    """Phase 33: BERT-base with the MoE FFN (MOE_EXPERTS experts, top
    MOE_TOP_K), b128 s128, the bf16 policy, Adam(1e-4), attention
    dropout 0: the captured and the eager executor in turns for
    MOE_TURN_STEPS steps from one state (losses and state bit-equal),
    then the captured one alone for MOE_CAPTURED_STEPS more (timed).
    Losses finite and falling; K1 24, K2 12, K3 12 and K4 1 (the MLM
    head: the MoE FFN has no bias-GeLU site) a step on the card, exactly,
    and in the wrappers; step p50, MFU from moe_train_flops_per_step,
    peak memory and the graph pool."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = _moe_config()
    main, startup, loss = _bert_program(cfg, bf16=True)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    feed = bert.make_fake_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = {m: 0 for m in exes}
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    order = [(m, i) for i in range(MOE_TURN_STEPS) for m in exes] + [
        ("captured", MOE_TURN_STEPS + i) for i in range(MOE_CAPTURED_STEPS)]
    diff = None
    for m, i in order:
        if i == MOE_TURN_STEPS and diff is None:
            diff = _scope_diff(scopes["captured"], scopes["eager"])
        torch.cuda.reset_peak_memory_stats()
        before = _snap()
        t0 = time.perf_counter()
        (lv,) = exes[m].run(main, feed=feed, fetch_list=[loss],
                            scope=scopes[m])
        secs[m].append(time.perf_counter() - t0)
        py, dev = _since(before, counters)
        _add(launches[m], py)
        _add(on_card[m], dev)
        peak[m] = max(peak[m], torch.cuda.max_memory_allocated())
        losses[m].append(float(lv))
    per = {"flash_fwd": 2 * cfg.num_layers, "flash_bwd_dq": cfg.num_layers,
           "flash_bwd_dkv": cfg.num_layers, "fused_bias_act": 1}
    per = {k: v for k, v in per.items() if k in counters}
    _gate_launches("moe path", launches, on_card, per,
                   {m: len(secs[m]) for m in exes}, 1)
    loss_c = losses["captured"]
    if not all(np.isfinite(loss_c)) or not loss_c[-1] < loss_c[0]:
        raise AssertionError(f"moe path: losses not finite and falling: "
                             f"{loss_c}")
    if losses["captured"][:MOE_TURN_STEPS] != losses["eager"] or diff:
        raise AssertionError(f"moe path: captured and eager differ: "
                             f"{losses}, state {diff[:5]}")
    n_moe = sum(op.type == "moe_ffn" for op in main.global_block().ops)
    flops = moe_train_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    timed = np.asarray(secs["captured"][MOE_TURN_STEPS:])
    p50 = float(np.median(timed))
    path = dict(
        model=f"BertConfig.base(vocab_size=30528, moe_experts="
              f"{MOE_EXPERTS}, moe_top_k={MOE_TOP_K})",
        batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, dtype_policy="bf16",
        moe_ffn_ops=n_moe, losses=loss_c, losses_eager=losses["eager"],
        captured_eager_bit_equal_steps=MOE_TURN_STEPS,
        step_p50_ms=1e3 * p50,
        step_p95_ms=1e3 * float(np.percentile(timed, 95)),
        eager_step_ms=[1e3 * t for t in secs["eager"]],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * len(timed)
        / float(timed.sum()),
        model_flops_per_step_dense_dispatch=flops,
        model_flops_per_step_train_flops=bert.train_flops_per_step(
            cfg, TRAIN_BATCH, TRAIN_SEQ),
        mfu_dense_dispatch=flops / p50 / BF16_TC_FLOPS,
        peak_memory_gb={m: peak[m] / 1e9 for m in exes},
        capture_s=_capture_seconds(exes["captured"], main),
        graph_pools_gb=graph_pools_gb(),
        launches=_summed(launches), device_launches=_summed(on_card))
    state = dict(exes=exes, main=main, scopes=scopes, feed=feed, loss=loss,
                 fetch=[loss])
    return state, path


def run_moe_parity():
    """2 layers of phase 33's model at full width, fp32, dropout 0,
    b4 s128: MOE_PARITY_STEPS Adam steps on the card and on a CPUPlace
    executor from the same parameters; losses within TRAIN_LOSS_RTOL and
    phase 5's Adam update gates on every leaf above the gradient floor
    (_update_readings)."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import bert

    cfg = _moe_config(num_layers=2, hidden_dropout=0.0)
    feed = bert.make_fake_batch(cfg, MOE_PARITY_BATCH, TRAIN_SEQ, seed=1)
    runs = {}
    init = None
    for key, place in (("card", _gpu_place()), ("cpu", fluid.CPUPlace())):
        main, startup, loss = _bert_program(cfg, bf16=False)
        scope = fluid.Scope()
        with capture_mode(False):
            exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        if init is None:
            init = {p.name: scope.get(p.name).cpu().numpy().copy()
                    for p in main.all_parameters()}
        else:
            convert.load_params(scope, init, place, program=main)
        grads = dict(main._params_grads)
        losses, first = [], None
        for i in range(MOE_PARITY_STEPS):
            fetch = [loss] + (list(grads.values()) if i == 0 else [])
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            losses.append(float(out[0]))
            if i == 0:
                first = {p: np.asarray(g, np.float64)
                         for p, g in zip(grads, out[1:])}
        runs[key] = (losses, {n: scope.get(n).cpu().numpy().astype(
            np.float64) for n in init}, first)
    (gl, gpu, _), (cl, cpu, grads) = runs["card"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    if not rel < TRAIN_LOSS_RTOL:
        raise AssertionError(f"moe parity: losses {gl} (card) vs {cl} "
                             f"(CPU), max rel diff {rel}")
    checks = (("max_abs", TRAIN_PARAM_MAX_ATOL),
              ("mean_abs", TRAIN_PARAM_MEAN_ATOL))
    return dict(batch=MOE_PARITY_BATCH, seq_len=TRAIN_SEQ, losses_gpu=gl,
                losses_cpu=cl, loss_max_rel_diff=rel,
                **_update_gates("moe parity", _update_readings(
                    init, gpu, cpu, grads), checks))


# ---------------------------------------------------------------------------
# phase 34: gradient merge, ModelAverage, the metric ops and
# fluid.gradients on the BERT-base step
# ---------------------------------------------------------------------------

GM_K, GM_BATCH = 4, 32     # k_steps, the micro-batch: b128 a boundary
GM_MICRO_STEPS = 2 * GM_K  # two boundaries
GM_EVAL_BATCHES = 4
# the equivalence gate: GM's first boundary update against one plain
# b128 Adam step may differ from it at most this many times as much as
# the plain step differs from itself with the batch's rows permuted (the
# control: the same sums in another order; GM adds four partial grads),
# both over every held leaf at once (_gm_update_rel's global_rel): a
# worst leaf would set one leaf's rounding against another's, and the
# control cannot move some leaves at all (an embedding's exact
# index-add sums in one order whatever the rows' order).  The gate must
# fail a wrong merge: the same GM run with its step counter started one
# ahead (the boundary after three micro-batches, the fourth dropped from
# the merge) is read against the same limit and must exceed it
GM_EQUIV_FACTOR = 4.0
GM_AUC_ATOL = 1e-6         # the op's fp32 AUC against the host's fp64
GM_ACC_ATOL = 1e-6         # the op's fp32 accuracy against the count
GM_WGAN_LR, GM_WGAN_STEPS = 1e-3, 3


def _gm_cfg(**kw):
    from paddle_tpu_torch.models import bert

    return bert.BertConfig.base(vocab_size=30528, use_flash_attention=True,
                                attn_dropout=0.0, **kw)


def _gm_program(cfg, bf16, k=GM_K, average=True):
    """BERT-base pretraining with GradientMergeOptimizer(Adam(TRAIN_LR),
    k) (``k`` None: plain Adam) and, with ``average``, a ModelAverage
    updated in the program; returns (main, startup, loss, average)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    avg = None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        opt = fluid.optimizer.Adam(learning_rate=TRAIN_LR)
        if k is not None:
            opt = fluid.optimizer.GradientMergeOptimizer(opt, k_steps=k)
        opt.minimize(loss)
        if average:
            avg = fluid.optimizer.ModelAverage(0.15)
            avg.update()
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    return main, startup, loss, avg


def _gm_batches(cfg, seed, n=GM_K):
    from paddle_tpu_torch.models import bert

    return [bert.make_fake_batch(cfg, GM_BATCH, TRAIN_SEQ, seed=seed + i)
            for i in range(n)]


def _gm_metrics(feeds, outs, stats):
    """The auc op's last value and histograms (``stats``, pos and neg)
    against fluid.metrics.Auc fed the fetched probabilities, and
    fluid.metrics.Accuracy over the fetched accuracy outputs against the
    host's count; raises past GM_AUC_ATOL / GM_ACC_ATOL."""
    from paddle_tpu_torch import fluid

    m_auc = fluid.metrics.Auc(num_thresholds=4095)
    m_acc = fluid.metrics.Accuracy()
    right = rows = 0
    for f, (_, prob, acc, _, total) in zip(feeds, outs):
        m_auc.update(prob, f["labels"])
        m_acc.update(value=float(acc), weight=int(total))
        right += int((prob.argmax(1) == f["labels"].reshape(-1)).sum())
        rows += len(prob)
    pos, neg = (t.cpu().numpy() for t in stats)
    if not (np.array_equal(pos, m_auc._stat_pos)
            and np.array_equal(neg, m_auc._stat_neg)):
        raise AssertionError("gm eval: the auc op's stat buffers differ from "
                             "fluid.metrics.Auc's")
    auc_op, auc_host = float(outs[-1][0]), m_auc.eval()
    acc_metric, acc_host = m_acc.eval(), right / rows
    if not (abs(auc_op - auc_host) <= GM_AUC_ATOL
            and abs(acc_metric - acc_host) <= GM_ACC_ATOL):
        raise AssertionError(f"gm eval: auc {auc_op} against {auc_host}, "
                             f"accuracy {acc_metric} against {acc_host}")
    return dict(auc_op=auc_op, auc_metrics=auc_host,
                accuracy_metrics=acc_metric, accuracy_host=acc_host,
                buckets_used=int(((pos + neg) > 0).sum()),
                positives=int(pos.sum()), negatives=int(neg.sum()))


def _gm_join(parts, perm=None):
    """The micro-batches ``parts`` as one batch, its samples in order or
    in the order ``perm``: ``mask_pos`` indexes the flattened [b·s] rows,
    so each masked position moves with its sample (the masked list keeps
    its order)."""
    b, seq = parts[0]["src_ids"].shape
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    out["mask_pos"] = np.concatenate(
        [p["mask_pos"] + i * b * seq for i, p in enumerate(parts)])
    if perm is not None:
        for k in ("src_ids", "pos_ids", "sent_ids", "input_mask", "labels"):
            out[k] = out[k][perm]
        sample, off = np.divmod(out["mask_pos"], seq)
        out["mask_pos"] = np.argsort(perm)[sample] * seq + off
    return out


def _gm_state_names(main):
    """The parameters and the inner Adam's moments and beta powers (not
    the merge's own ``_gm_`` state nor the averages)."""
    block = main.global_block()
    params = [p.name for p in main.all_parameters()]
    adam = sorted(n for n, v in block.vars.items() if v.persistable
                  and "_gm_" not in n and any(
                      s in n for s in ("_moment1_", "_moment2_",
                                       "_beta1_pow_acc_", "_beta2_pow_acc_")))
    return params, adam


def run_gm_path(counters):
    """Phase 34 (1): BERT-base b32 s128 micro-batches, the bf16 policy,
    GradientMergeOptimizer(Adam(1e-4), k_steps=4) and a ModelAverage,
    GM_MICRO_STEPS micro-steps over four fixed batches, captured and
    eager in turns from one state.

    Gates: off the boundary (micro-steps 1-3, 5-7) every parameter, Adam
    moment and beta power equals its value at the last boundary bit for
    bit: the merge's blend selects the snapshot exactly (0·x + 1·s), so
    any difference is a fault, whatever its size; at 4 and 8 every
    parameter changes and each beta power is the last boundary's times
    its beta, computed as the adam op computes it (one advance a
    boundary); the two modes' losses and final state bit-equal, as on
    phases 4 and 32 (the same ops on the same inputs); K1-K4 launch
    _train_step_launches(cfg) a micro-step on the card and in the
    wrappers, exactly, since the merge adds no kernel."""
    from paddle_tpu_torch import fluid

    cfg = _gm_cfg()
    main, startup, loss, avg = _gm_program(cfg, bf16=True)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    scopes = {"captured": scope, "eager": _clone_scope(scope)}
    exes = _executors()
    feeds = _gm_batches(cfg, seed=200)
    params, adam = _gm_state_names(main)
    watched = params + adam
    pows = {n: 0.9 if "_beta1_pow_acc_" in n else 0.999
            for n in adam if "_pow_acc_" in n}
    last = {n: scope.get(n).clone() for n in watched}
    losses = {m: [] for m in exes}
    secs = {m: [] for m in exes}
    peak = 0
    launches = {m: {} for m in exes}
    on_card = {m: {} for m in exes}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for i in range(GM_MICRO_STEPS):
        for m, exe in exes.items():  # in turns
            torch.cuda.reset_peak_memory_stats()
            before = _snap()
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feeds[i % GM_K], fetch_list=[loss],
                            scope=scopes[m])
            secs[m].append(time.perf_counter() - t0)
            py, dev = _since(before, counters)
            _add(launches[m], py)
            _add(on_card[m], dev)
            peak = max(peak, torch.cuda.max_memory_allocated())
            losses[m].append(float(lv))
        now = scopes["captured"]
        if (i + 1) % GM_K:
            moved = [n for n in watched if not torch.equal(now.get(n),
                                                           last[n])]
            if moved:
                raise AssertionError(f"gm path: micro-step {i + 1} moved "
                                     f"{len(moved)} vars off the boundary, "
                                     f"{moved[:5]}")
        else:
            still = [n for n in params if torch.equal(now.get(n), last[n])]
            bad = [n for n, b in pows.items() if not torch.equal(
                now.get(n), last[n].clone().mul_(b))]
            if still or bad:
                raise AssertionError(f"gm path: boundary {i + 1}: "
                                     f"unchanged {still[:5]}, beta powers "
                                     f"not advanced once {bad[:5]}")
            last = {n: now.get(n).clone() for n in watched}
    _gate_launches("gm path", launches, on_card, _train_step_launches(cfg),
                   GM_MICRO_STEPS, 1)
    diff = _scope_diff(scopes["captured"], scopes["eager"])
    if losses["captured"] != losses["eager"] or diff:
        raise AssertionError(f"gm path: captured and eager differ: losses "
                             f"{losses}, state {diff[:5]}")
    if not all(np.isfinite(losses["captured"])):
        raise AssertionError(f"gm path: losses {losses['captured']}")
    modes = {}
    for m in exes:
        t = np.asarray(secs[m][1:])  # the first run warms up (captures)
        boundary = [secs[m][i] for i in range(1, GM_MICRO_STEPS)
                    if (i + 1) % GM_K == 0]
        off = [secs[m][i] for i in range(1, GM_MICRO_STEPS)
               if (i + 1) % GM_K]
        modes[m] = dict(micro_step_p50_ms=1e3 * float(np.median(t)),
                        boundary_extra_ms=1e3 * (float(np.median(boundary))
                                                 - float(np.median(off))),
                        first_step_s=secs[m][0],
                        launches=launches[m], device_launches=on_card[m])
    modes["captured"]["capture_s"] = _capture_seconds(exes["captured"], main)
    n_acc = sum("_gm_acc" in n for n in main.global_block().vars)
    n_snap = sum("_gm_snap" in n for n in main.global_block().vars)
    path = dict(
        model="BertConfig.base(vocab_size=30528)", micro_batch=GM_BATCH,
        seq_len=TRAIN_SEQ, k_steps=GM_K, effective_batch=GM_K * GM_BATCH,
        dtype_policy="bf16", micro_steps=GM_MICRO_STEPS,
        losses=losses["captured"], watched_vars=len(watched),
        gm_accumulators=n_acc, gm_snapshots=n_snap,
        off_boundary_bit_equal=True, beta_pow_advanced_once=True,
        captured_eager_bit_equal=True, modes=modes,
        peak_memory_gb=peak / 1e9, graph_pools_gb=graph_pools_gb(),
        per_micro_step_launches=_train_step_launches(cfg),
        launches=_summed(launches), device_launches=_summed(on_card))
    state = dict(cfg=cfg, main=main, scope=scope, avg=avg, exes=exes)
    return state, path


def _gm_eval_program(cfg):
    """The is_test pretraining graph (fp32) with the auc op on the NSP
    head's probabilities; returns (main, startup, fetch names)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        bert.build_bert_pretrain(cfg, is_test=True)
        block = main.global_block()
        topk = [op for op in block.ops if op.type == "top_k"][-1]
        acc_op = [op for op in block.ops if op.type == "accuracy"][-1]
        prob = block.var(topk.input("X")[0])
        auc_out, stats = fluid.layers.auc(prob, block.var("labels"))
    fetch = [auc_out.name, prob.name, acc_op.output("Accuracy")[0],
             acc_op.output("Correct")[0], acc_op.output("Total")[0]]
    return main, startup, fetch, [s.name for s in stats]


def run_gm_eval(state, counters):
    """Phase 34 (2): the evaluation under ModelAverage.apply().

    The fp32 is_test program with the auc and accuracy ops on the NSP
    head is captured on the training scope before the context; inside,
    the scope's own parameter tensors hold the averages bit for bit (a
    copy, so no rounding: equal or a fault), and GM_EVAL_BATCHES batches
    replay the graph, which reads them; an eager run of the same batches
    on a copy of the scope gives the same bits (both modes run the same
    ops).  The auc op's stat buffers equal fluid.metrics.Auc's fed the
    fetched probabilities (integers: equal), its value within
    GM_AUC_ATOL (fp32 against fp64 of the same sums); fluid.metrics.
    Accuracy over the fetched accuracy outputs within GM_ACC_ATOL of the
    host's count (argmax of the fetched probabilities).  After the
    context the parameters are the trained ones bit for bit, in the same
    tensor objects, and the metric gates hold again for the same
    batches on them (the averages of 8 micro-steps, not bias-corrected,
    are about 1% of the weights: their probabilities fill few
    buckets)."""
    from paddle_tpu_torch import fluid

    cfg, scope, avg = state["cfg"], state["scope"], state["avg"]
    main, _, fetch, stat_names = _gm_eval_program(cfg)
    for n in stat_names:  # the startup's zeros (it would also reseed
        # every parameter over the trained ones)
        scope.set(n, torch.zeros(main.global_block().var(n).shape,
                                 dtype=torch.int64,
                                 device=_gpu_place().torch_device()))
    feeds = _gm_batches(cfg, seed=300, n=GM_EVAL_BATCHES)
    exes = _executors()
    exes["captured"].run(main, feed=feeds[0], fetch_list=fetch,
                         scope=scope)  # warm-up and capture, outside
    for n in stat_names:
        scope.get(n).zero_()
    params = list(avg._ema_vars)
    objs = {p: scope.get(p) for p in params}
    trained = {p: objs[p].clone() for p in params}
    for w in counters.values():
        w.launches = 0
    before = _snap()
    outs = []
    with fluid.scope_guard(scope), avg.apply(exes["captured"]):
        swapped = [p for p in params if scope.get(p) is not objs[p]
                   or not torch.equal(objs[p], scope.get(
                       avg._ema_vars[p].name))]
        if swapped:
            raise AssertionError(f"gm eval: inside apply() {swapped[:5]} "
                                 f"are not the averages in place")
        for f in feeds:
            outs.append(exes["captured"].run(main, feed=f, fetch_list=fetch,
                                             scope=scope))
        stats = {n: scope.get(n).clone() for n in stat_names}
        copy = _clone_scope(scope)
    launches, dev = _since(before, counters)
    restored = [p for p in params if scope.get(p) is not objs[p]
                or not torch.equal(objs[p], trained[p])]
    if restored:
        raise AssertionError(f"gm eval: after apply() {restored[:5]} are not "
                             f"the trained tensors")
    for n in stat_names:
        copy.get(n).zero_()
    eager = [exes["eager"].run(main, feed=f, fetch_list=fetch, scope=copy)
             for f in feeds]
    if not all(np.array_equal(a, b) for x, y in zip(outs, eager)
               for a, b in zip(x, y)):
        raise AssertionError("gm eval: the captured replays inside apply() "
                             "and an eager run on the averages differ")
    averaged = _gm_metrics(feeds, outs, [stats[n] for n in stat_names])
    # the same batches on the trained parameters, the graph replayed
    for n in stat_names:
        scope.get(n).zero_()
    outs = [exes["captured"].run(main, feed=f, fetch_list=fetch,
                                 scope=scope) for f in feeds]
    trained_m = _gm_metrics(feeds, outs, [scope.get(n) for n in stat_names])
    return dict(batches=GM_EVAL_BATCHES, dtype="float32",
                averaged=averaged, trained=trained_m,
                auc_op=averaged["auc_op"], stats_equal=True,
                averages_in_place=True, restored_bit_equal=True,
                captured_eager_bit_equal=True, launches=launches,
                device_launches=dev)


def _gm_update_rel(init, a, b, g_rms):
    """Run ``a``'s update against run ``b``'s (both from ``init``) over
    the leaves whose first gradient's RMS (``g_rms``, run ``b``'s) is at
    least DP_GRAD_FLOOR of the median leaf's, as phase 5's
    _update_readings holds them (below it, such as an attention key
    bias, whose exact gradient is 0, a gradient of rounding only, which
    Adam's first step turns into ±lr at random): ``global_rel``, the
    norm of the difference of the two updates over the norm of ``b``'s,
    both over every held leaf at once (gated); and, printed, the worst
    leaf's ||Δa − Δb|| / ||Δb|| (``change_rel``) and mean |Δa − Δb|
    (``mean_abs``)."""
    median = float(np.median(list(g_rms.values())))
    held = [n for n, r in g_rms.items() if r >= DP_GRAD_FLOOR * median]
    rel, mean = {}, {}
    diff2 = base2 = 0.0
    for n in held:
        da = a[n].double() - init[n].double()
        db = b[n].double() - init[n].double()
        d2 = float(torch.linalg.vector_norm(da - db)) ** 2
        b2 = float(torch.linalg.vector_norm(db)) ** 2
        diff2, base2 = diff2 + d2, base2 + b2
        rel[n] = (d2 / max(b2, 1e-60)) ** 0.5
        mean[n] = float((da - db).abs().mean())
    worst_rel, worst_mean = max(rel, key=rel.get), max(mean, key=mean.get)
    return dict(leaves=len(g_rms), leaves_held=len(held),
                global_rel=(diff2 / max(base2, 1e-60)) ** 0.5,
                change_rel=rel[worst_rel], change_rel_leaf=worst_rel,
                mean_abs=mean[worst_mean], mean_abs_leaf=worst_mean)


def run_gm_equivalence():
    """Phase 34 (3): hidden dropout 0, GM's first boundary over the four
    b32 slices of one b128 batch against one plain Adam step at b128 on
    that batch, from the same parameters; and, as the control, the plain
    step against itself on the batch with its samples permuted (only the
    order of the sums moves).  Under the fp32 policy (phase 20's) GM's
    distance is gated at GM_EQUIV_FACTOR x the control's, and a planted
    fault (GM's counter started at 1: the boundary after three slices,
    the fourth dropped from the merge) must read past that limit, or
    the gate could not see a wrong merge; under the bf16
    policy it is printed beside its control, not gated: the merge adds
    its micro-batch grads in bf16 (its accumulation ops are backward
    ops, which the policy runs in bf16, as the JAX package does).  The
    distance is _gm_update_rel's global_rel over the held leaves."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)

    cfg = _gm_cfg(hidden_dropout=0.0)
    parts = _gm_batches(cfg, seed=400)
    full = _gm_join(parts)
    perm = np.random.RandomState(SEED).permutation(GM_K * GM_BATCH)
    fullp = _gm_join(parts, perm)
    gm_main, gm_start, gm_loss, _ = _gm_program(cfg, False, average=False)
    pl_main, pl_start, pl_loss, _ = _gm_program(cfg, False, k=None,
                                                average=False)
    names = [p.name for p in pl_main.all_parameters()]
    with capture_mode(False):
        exe = fluid.Executor(_gpu_place())
    out = {}
    for policy in ("fp32", "bf16"):
        if policy == "bf16":
            enable_bf16_policy(gm_main)
            enable_bf16_policy(pl_main)
        base = fluid.Scope()
        exe.run(pl_start, scope=base)
        init = {n: base.get(n).clone() for n in names}
        runs, losses, g_rms = {}, {}, None
        grads = [g for _, g in pl_main._params_grads]
        for key, feed in (("plain", full), ("permuted", fullp)):
            s = _clone_scope(base)
            got = exe.run(pl_main, feed=feed, fetch_list=[pl_loss] + grads,
                          scope=s, return_numpy=False)
            losses[key] = float(got[0])
            if g_rms is None:
                g_rms = {p: float(g.double().square().mean().sqrt())
                         for (p, _), g in zip(pl_main._params_grads,
                                              got[1:])}
            runs[key] = {n: s.get(n) for n in names}
        s = fluid.Scope()
        exe.run(gm_start, scope=s)
        for n in names:
            s.get(n).copy_(init[n])
        micro = [float(exe.run(gm_main, feed=f, fetch_list=[gm_loss],
                               scope=s)[0]) for f in parts]
        runs["gm"] = {n: s.get(n) for n in names}
        gm = _gm_update_rel(init, runs["gm"], runs["plain"], g_rms)
        ctl = _gm_update_rel(init, runs["permuted"], runs["plain"], g_rms)
        out[policy] = dict(gm=gm, control=ctl, losses=losses,
                           micro_losses=micro,
                           micro_loss_mean=float(np.mean(micro)))
        if policy == "fp32":
            s = fluid.Scope()
            exe.run(gm_start, scope=s)
            for n in names:
                s.get(n).copy_(init[n])
            (counter,) = [v.name for v in gm_main.list_vars()
                          if v.name.startswith("gm_step")]
            s.get(counter).fill_(1)
            for f in parts[:GM_K - 1]:
                exe.run(gm_main, feed=f, fetch_list=[gm_loss], scope=s)
            out[policy]["planted_dropped_slice"] = _gm_update_rel(
                init, {n: s.get(n) for n in names}, runs["plain"], g_rms)
        del base, s, runs
        torch.cuda.empty_cache()
    r = out["fp32"]
    limit = GM_EQUIV_FACTOR * r["control"]["global_rel"]
    if not (0 < r["control"]["global_rel"]
            and r["gm"]["global_rel"] <= limit):
        raise AssertionError(f"gm equivalence (fp32): GM {r['gm']} against "
                             f"the plain b128 step, control {r['control']}, "
                             f"limit {limit}")
    if not r["planted_dropped_slice"]["global_rel"] > limit:
        raise AssertionError(f"gm equivalence (fp32): a slice dropped from "
                             f"the merge reads {r['planted_dropped_slice']}"
                             f", within the limit {limit}: the gate cannot "
                             f"see a wrong merge")
    return dict(batch=GM_K * GM_BATCH, slices=GM_K, factor=GM_EQUIV_FACTOR,
                fp32_limit=limit, **out)


def _gm_saliency_program(cfg, bf16):
    """The is_test pretraining loss and fluid.gradients of it with
    respect to the summed embeddings (the first layer_norm's input)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg, is_test=True)
        block = main.global_block()
        ln = [op for op in block.ops if op.type == "layer_norm"][0]
        emb = block.var(ln.input("X")[0])
        (sal,) = fluid.gradients(loss, [emb])
    if bf16:
        enable_bf16_policy(main)
    startup.random_seed = SEED
    return main, startup, loss, sal


def _gm_wgan_program():
    """tests/test_double_grad.py's WGAN-GP critic step (b8, d6): the
    gradient penalty through fluid.gradients, Adam(GM_WGAN_LR)."""
    from paddle_tpu_torch import fluid

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        real = L.data(name="real", shape=[6], dtype="float32")
        fake = L.data(name="fake", shape=[6], dtype="float32")
        alpha = L.data(name="alpha", shape=[1], dtype="float32")

        def critic(v):
            h = L.fc(v, size=16, act="relu", param_attr="c_w1",
                     bias_attr="c_b1")
            return L.fc(h, size=1, param_attr="c_w2", bias_attr="c_b2")

        inter = L.elementwise_add(
            L.elementwise_mul(real, alpha),
            L.elementwise_mul(fake, L.elementwise_sub(L.ones_like(alpha),
                                                      alpha)))
        inter.stop_gradient = False
        (g,) = fluid.gradients(critic(inter), inter)
        norm = L.sqrt(L.reduce_sum(L.square(g), dim=1, keep_dim=False))
        gp = L.mean(L.square(norm - 1.0))
        loss = L.mean(critic(fake)) - L.mean(critic(real)) + 10.0 * gp
        fluid.optimizer.Adam(learning_rate=GM_WGAN_LR).minimize(loss)
    startup.random_seed = SEED
    return main, startup, loss, gp


def _gm_conv_double_program():
    """tests/test_double_grad.py's conv2d case (x [2, 1, 5, 5], W [2, 1,
    3, 3]): z = mean((d mean(sigmoid(conv2d(x, W))) / dx)²) and dz/dW,
    through conv2d_grad_grad (derived)."""
    from paddle_tpu_torch import fluid

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name="x", shape=[1, 5, 5], dtype="float32")
        x.stop_gradient = False
        w = L.create_parameter([2, 1, 3, 3], "float32", name="Wc")
        blk = main.current_block()
        conv = blk.create_var(name="convy", shape=None, dtype="float32")
        blk.append_op("conv2d", inputs={"Input": [x], "Filter": [w]},
                      outputs={"Output": [conv]},
                      attrs={"strides": [1, 1], "paddings": [1, 1],
                             "dilations": [1, 1], "groups": 1})
        (dx,) = fluid.gradients(L.mean(L.sigmoid(conv)), x)
        z = L.mean(L.square(dx))
        (dw,) = fluid.gradients(z, w)
    startup.random_seed = SEED
    return main, startup, z, dw


def run_gm_gradients(counters):
    """Phase 34 (4): fluid.gradients on the card.  The saliency of the
    loss with respect to the summed embeddings at full width (b32 s128,
    the bf16 policy): finite, not all zero, and its backward launches
    K2 and K3 once a layer on the card.  At 2 layers, fp32, b4 s128,
    the card's saliency and loss against a CPUPlace run from the same
    parameters: the grad within NMT_PARITY_GRAD_RTOL (relative L2, the
    earlier fp32 parities' gradient limit), the loss within
    TRAIN_LOSS_RTOL.  The WGAN-GP penalty of tests/test_double_grad.py
    at its size (mul and relu double grads, derived): GM_WGAN_STEPS Adam
    steps on the card and on the CPU from the same parameters, losses
    within TRAIN_LOSS_RTOL and every parameter within 3 x its learning
    rate (phase 5's rule for an Adam step's sign flips).  And the same
    file's conv2d case (conv2d_grad_grad, derived from the conv grad's
    convolution_backward): dW of the gradient norm on the card against
    the CPU within NMT_PARITY_GRAD_RTOL, z within TRAIN_LOSS_RTOL."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.models import bert

    out = {}
    cfg = _gm_cfg()
    main, startup, loss, sal = _gm_saliency_program(cfg, bf16=True)
    scope = fluid.Scope()
    fluid.Executor(_gpu_place()).run(startup, scope=scope)
    feed = bert.make_fake_batch(cfg, GM_BATCH, TRAIN_SEQ, seed=500)
    with capture_mode(False):
        exe = fluid.Executor(_gpu_place())
    for w in counters.values():
        w.launches = 0
    before = _snap()
    _, g = exe.run(main, feed=feed, fetch_list=[loss, sal], scope=scope)
    launches, dev = _since(before, counters)
    want = {"flash_fwd": 2 * cfg.num_layers, "flash_bwd_dq": cfg.num_layers,
            "flash_bwd_dkv": cfg.num_layers}
    if not (np.isfinite(g).all() and np.abs(g).max() > 0
            and {k: dev[k] for k in want} == want):
        raise AssertionError(f"gm saliency: finite {np.isfinite(g).all()}, "
                             f"max {np.abs(g).max()}, launches {dev}")
    out["saliency"] = dict(shape=list(g.shape), max_abs=float(np.abs(g).max()),
                           launches=launches, device_launches=dev)
    del scope
    cfg2 = _gm_cfg(num_layers=2, hidden_dropout=0.0)
    main, startup, loss, sal = _gm_saliency_program(cfg2, bf16=False)
    feed = bert.make_fake_batch(cfg2, 4, TRAIN_SEQ, seed=501)
    got = {}
    init = None
    for key, place in (("card", _gpu_place()), ("cpu", fluid.CPUPlace())):
        s = fluid.Scope()
        with capture_mode(False):
            e = fluid.Executor(place)
        e.run(startup, scope=s)
        if init is None:
            init = {p.name: s.get(p.name).cpu().numpy().copy()
                    for p in main.all_parameters()}
        else:
            convert.load_params(s, init, place, program=main)
        got[key] = e.run(main, feed=feed, fetch_list=[loss, sal], scope=s)
    (lc, gc), (lh, gh) = got["card"], got["cpu"]
    grel = float(np.linalg.norm(gc.astype(np.float64) - gh)
                 / np.linalg.norm(gh.astype(np.float64)))
    lrel = abs(float(lc) - float(lh)) / abs(float(lh))
    if not (grel <= NMT_PARITY_GRAD_RTOL and lrel < TRAIN_LOSS_RTOL):
        raise AssertionError(f"gm saliency parity: grad rel {grel}, loss rel "
                             f"{lrel}")
    out["saliency_parity"] = dict(layers=2, batch=4, grad_rel=grel,
                                  grad_rtol=NMT_PARITY_GRAD_RTOL,
                                  loss_rel=lrel, loss_rtol=TRAIN_LOSS_RTOL)
    main, startup, loss, gp = _gm_wgan_program()
    rng = np.random.RandomState(2)
    feeds = [{"real": rng.randn(8, 6).astype("float32") + 2.0,
              "fake": rng.randn(8, 6).astype("float32"),
              "alpha": rng.uniform(size=(8, 1)).astype("float32")}
             for _ in range(GM_WGAN_STEPS)]
    runs, init = {}, None
    for key, place in (("card", _gpu_place()), ("cpu", fluid.CPUPlace())):
        s = fluid.Scope()
        e = fluid.Executor(place)
        e.run(startup, scope=s)
        if init is None:
            init = {p.name: s.get(p.name).cpu().numpy().copy()
                    for p in main.all_parameters()}
        else:
            convert.load_params(s, init, place, program=main)
        ls = [[float(v) for v in e.run(main, feed=f, fetch_list=[loss, gp],
                                       scope=s)] for f in feeds]
        runs[key] = (ls, {n: s.get(n).cpu().numpy() for n in init})
    (lc, pc), (lh, ph) = runs["card"], runs["cpu"]
    lrel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(lc, lh))
    pdiff = max(float(np.abs(pc[n] - ph[n]).max()) for n in init)
    second = sorted({op.type for op in main.global_block().ops
                     if op.type.endswith("_grad_grad")})
    if not (lrel < TRAIN_LOSS_RTOL and pdiff <= 3 * GM_WGAN_LR
            and all(np.isfinite(v) for r in lc for v in r) and second):
        raise AssertionError(f"gm wgan-gp: losses {lc} vs {lh} (rel {lrel}), "
                             f"params {pdiff}, second-order ops {second}")
    out["wgan_gp"] = dict(steps=GM_WGAN_STEPS, losses_card=lc, losses_cpu=lh,
                          loss_max_rel_diff=lrel, param_max_abs_diff=pdiff,
                          param_atol=3 * GM_WGAN_LR, double_grad_ops=second)
    main, startup, z, dw = _gm_conv_double_program()
    feed = {"x": np.random.RandomState(1).randn(2, 1, 5, 5)
            .astype("float32")}
    got, init = {}, None
    for key, place in (("card", _gpu_place()), ("cpu", fluid.CPUPlace())):
        s = fluid.Scope()
        e = fluid.Executor(place)
        e.run(startup, scope=s)
        if init is None:
            init = {"Wc": s.get("Wc").cpu().numpy().copy()}
        else:
            convert.load_params(s, init, place, program=main)
        got[key] = e.run(main, feed=feed, fetch_list=[z, dw], scope=s)
    (zc, gc), (zh, gh) = got["card"], got["cpu"]
    grel = float(np.linalg.norm(gc.astype(np.float64) - gh)
                 / np.linalg.norm(gh.astype(np.float64)))
    zrel = abs(float(zc) - float(zh)) / abs(float(zh))
    second = sorted({op.type for op in main.global_block().ops
                     if op.type.endswith("_grad_grad")})
    if not (grel <= NMT_PARITY_GRAD_RTOL and zrel < TRAIN_LOSS_RTOL
            and "conv2d_grad_grad" in second):
        raise AssertionError(f"gm conv2d double grad: dW rel {grel}, z rel "
                             f"{zrel}, second-order ops {second}")
    out["conv2d_double_grad"] = dict(
        dw_rel=grel, z_rel=zrel, grad_rtol=NMT_PARITY_GRAD_RTOL,
        loss_rtol=TRAIN_LOSS_RTOL, double_grad_ops=second)
    return out


def run_gm_phase(wrappers, say, smi):
    """Phase 34: its four parts, each with its counts zeroed just before
    and read just after; returns the phase's readings (launches summed
    over the parts)."""
    t0 = time.perf_counter()
    counters = {k: wrappers[k] for k in TRAIN_KERNELS}
    torch.cuda.empty_cache()
    state, path = run_gm_path(counters)
    say("gm path", {"card": smi, **path})
    ev = run_gm_eval(state, counters)
    say("gm eval", {"card": smi, **ev})
    del state
    torch.cuda.empty_cache()
    eq = run_gm_equivalence()
    say("gm equivalence", {"card": smi, **eq})
    torch.cuda.empty_cache()
    gr = run_gm_gradients(counters)
    say("gm gradients", {"card": smi, **gr})
    torch.cuda.empty_cache()
    out = {"path": path, "eval": ev, "equivalence": eq, "gradients": gr,
           "seconds": time.perf_counter() - t0}
    for key in ("launches", "device_launches"):
        total = {}
        for part in (path, ev, gr["saliency"]):
            _add(total, part[key])
        out[key] = total
    m = path["modes"]
    say("gm summary", {
        "card": smi,
        "micro_step_ms": {k: m[k]["micro_step_p50_ms"] for k in m},
        "boundary_extra_ms": {k: m[k]["boundary_extra_ms"] for k in m},
        "peak_memory_gb": path["peak_memory_gb"],
        "equivalence_fp32": eq["fp32"]["gm"]["global_rel"],
        "equivalence_fp32_control": eq["fp32"]["control"]["global_rel"],
        "equivalence_fp32_planted_dropped_slice":
            eq["fp32"]["planted_dropped_slice"]["global_rel"],
        "equivalence_bf16": eq["bf16"]["gm"]["global_rel"],
        "equivalence_bf16_control": eq["bf16"]["control"]["global_rel"],
        "auc": ev["auc_op"], "gm_seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# phase 35: MobileNet-SSD 300² training and detection; the detection ops
# off its path, card against CPU (the CPU side in the CPU reference child)
# ---------------------------------------------------------------------------

SSD_BATCH, SSD_IMAGE = 64, 300
SSD_WARMUP, SSD_STEPS = 2, 6
SSD_EVAL_RUNS = 4      # runs of the test program a mode; the first warms up
SSD_MAP_OVERLAP = 0.5  # VOC's IoU for a true positive
# card against CPU: width 0.25, b4, fp32, each step from the card's state
SSD_PARITY_SCALE, SSD_PARITY_BATCH, SSD_PARITY_STEPS = 0.25, 4, 3
SSD_PARITY_LOSS_RTOL, SSD_PARITY_CHANGE_RTOL = 1e-4, 0.1
# RMSProp's first steps move an element by ~4.5 x lr x sign(g) wherever
# |g| > 4.5e-3 (decay 0.95, eps 1e-6), so a gradient that is zero up to
# the two devices' roundings flips its element's whole update; and the
# step is ill-conditioned (batch norm over 4 values a channel on the 1x1
# map, the hard-negative ranks: on the CPU an input nudged by 1e-6 moves
# one batch norm scale's gradient by 13%, one bias's update by 35%).
# So the 0.1 is held on the gradient and on the update of every leaf at
# once, and on each leaf's gradient (its norm floored at 1e-3 of its
# largest element times its size's root) where its own control (the
# CPU's reading from the nudged input) stays under 0.1 / SSD_PARITY_CTL;
# above it, within SSD_PARITY_CTL x the control.  Each leaf's update is
# read beside its control.
SSD_PARITY_CTL = 4.0
# the network's head outputs (locs, softmax scores) card against CPU from
# one state: fp32 convs in other orders; the detection rows decoded from
# the same head outputs: labels equal, scores and boxes within 1e-5
SSD_HEAD_TOL, SSD_ROW_TOL = 1e-5, 1e-5


def _detection_models():
    """tests/torch_port_detection_models.py: the detection programs and
    op cases, written once for either package (it imports neither)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import torch_port_detection_models

    return torch_port_detection_models


def _lower_on(op_type, inputs, attrs, device):
    """The port's lowering of ``op_type`` on numpy ``inputs`` on
    ``device``: its outputs, flat, as numpy arrays."""
    from paddle_tpu_torch.fluid import registry

    return _detection_models().run_lowering(registry, op_type, inputs,
                                            attrs, device)


def _detection_op_cases():
    dm = _detection_models()
    return {**dm.yolo_head_cases(), **dm.other_op_cases()}


def ssd_cpu_child(dirname):
    """The CPU reference child's part for phase 35: each detection op
    case (tests/torch_port_detection_models.py) on the CPU, its outputs
    and its derived grad's (seeded cotangents) into ``ssd.<case>``; the
    YOLOv3 NMS over the three heads' CPU yolo_box outputs into
    ``ssd.yolo_nms``."""
    dm = _detection_models()
    boxes = []
    for name, (op_type, inputs, attrs, _, grad_tol) in \
            _detection_op_cases().items():
        out = _lower_on(op_type, inputs, attrs, "cpu")
        arrays = {f"out{i}": o for i, o in enumerate(out) if o is not None}
        if grad_tol is not None:
            grads = _lower_on(op_type + "_grad",
                              list(inputs) + dm.cotangents(out), attrs,
                              "cpu")
            arrays.update({f"grad{i}": g for i, g in enumerate(grads)
                           if g is not None})
        if op_type == "yolo_box":
            boxes.append(out)
        _child_result(dirname, f"ssd.{name}", **arrays)
    nms_in = dm.yolo_nms_inputs(boxes)
    rows = _lower_on("multiclass_nms", nms_in, dm.YOLO_NMS_ATTRS, "cpu")[0]
    _child_result(dirname, "ssd.yolo_nms", boxes=nms_in[0],
                  scores=nms_in[1], rows=rows)


CPU_CHILD_PARTS["ssd"] = ssd_cpu_child


def _eager_call_ms(fn, n=3):
    """Median device ms of ``n`` eager calls of ``fn``, CUDA events around
    each: for a call of thousands of small launches (an NMS loop), whose
    enqueueing outlasts _time_ms's device sleep, so the reading includes
    the launch gaps."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def _stored(arrays, key, n):
    return [arrays.get(f"{key}{i}") for i in range(n)]


def run_detection_op_checks(child, dev=None):
    """Each detection op case on the card against the CPU child's run of
    the same lowering on the same seeded inputs (and each derived grad
    on the same cotangents), within its tolerance; then YOLOv3-608's
    NMS over the three heads' CPU yolo_box outputs: the rows equal, its
    device ms (CUDA events) and its kernels a call (profiler)."""
    dm = _detection_models()
    dev = dev or torch.device("cuda", 0)
    checks, worst = {}, 0.0
    t0 = time.perf_counter()
    for name, (op_type, inputs, attrs, tol, grad_tol) in \
            _detection_op_cases().items():
        cpu = child.take(f"ssd.{name}")
        got = _lower_on(op_type, inputs, attrs, dev)
        want = _stored(cpu, "out", len(got))
        fwd, fwd_abs = dm.outputs_close(got, want, tol)
        rec = dict(op=op_type, ratio=fwd, max_abs_err=fwd_abs, tol=tol)
        if grad_tol is not None:
            gg = _lower_on(op_type + "_grad",
                           list(inputs) + dm.cotangents(want), attrs, dev)
            g, g_abs = dm.outputs_close(gg, _stored(cpu, "grad", len(gg)),
                                        grad_tol)
            rec.update(grad_ratio=g, grad_max_abs_err=g_abs,
                       grad_tol=grad_tol)
            fwd = max(fwd, g)
        checks[name] = rec
        worst = max(worst, fwd)
    nms = child.take("ssd.yolo_nms")
    inputs = [nms["boxes"], nms["scores"]]
    args = [torch.from_numpy(a).to(dev) for a in inputs]
    from paddle_tpu_torch.fluid import registry

    lower = registry.get_op("multiclass_nms").lower
    ctx = registry.LowerContext(dev)
    rows = lower(ctx, *args, attrs=dict(dm.YOLO_NMS_ATTRS)).cpu().numpy()
    ratio, err = dm.outputs_close([rows], [nms["rows"]], 0)
    ms = _eager_call_ms(lambda: lower(ctx, *args,
                                      attrs=dict(dm.YOLO_NMS_ATTRS)))
    prof = _profile(lambda: lower(ctx, *args, attrs=dict(dm.YOLO_NMS_ATTRS)),
                    1)
    checks["yolo_nms"] = dict(
        op="multiclass_nms", ratio=ratio, max_abs_err=err, tol=0,
        shape=[list(a.shape) for a in inputs], eager_call_ms=ms,
        kernels_a_call=prof["device_events"],
        loop_kernels_a_call=4 * dm.YOLO_NMS_ATTRS["nms_top_k"],
        detections_an_image=[int(v) for v in (rows[..., 0] >= 0).sum(1)])
    worst = max(worst, ratio)
    bad = {k: v for k, v in checks.items()
           if v["ratio"] > 1 or v.get("grad_ratio", 0) > 1}
    if bad:
        raise AssertionError(f"detection op checks: card against CPU out "
                             f"of tolerance: {bad}")
    return dict(checks=checks, worst_ratio=worst, cases=len(checks),
                seconds=time.perf_counter() - t0)


def _ssd_program(scale=1.0, batch=SSD_BATCH):
    """The MobileNet-SSD training and test programs
    (tests/torch_port_detection_models.py) with a seeded startup."""
    import paddle_tpu_torch

    built = _detection_models().build_mobilenet_ssd(
        paddle_tpu_torch, scale=scale, image=SSD_IMAGE, batch=batch)
    built["startup"].random_seed = SEED
    return built


def run_ssd_path(counters):
    """Phase 35's training: MobileNet-SSD 300² at b64, fp32, RMSProp on
    piecewise_decay with L2Decay, one seeded synthetic batch, the
    captured and the eager executor in turns from one state
    (``_cnn_in_turns``: K1-K8 never launched, the modes bit-equal, every
    moving statistic changed by every captured step), SSD_WARMUP +
    SSD_STEPS steps each."""
    dm = _detection_models()
    built = _ssd_program()
    main, loss = built["main"], built["loss"]
    feed = dm.ssd_batch(SSD_BATCH, SSD_IMAGE, seed=0)
    steps = SSD_WARMUP + SSD_STEPS
    r = _cnn_in_turns(main, built["startup"], loss, feed, counters, steps,
                      "ssd path", stats_move=True)
    loss_c = r["losses"]["captured"]
    if not loss_c[-1] < loss_c[0]:
        raise AssertionError(f"ssd path: losses not falling: {loss_c}")
    fwd = cnn_flops_per_image(main)
    flops = 3 * fwd * SSD_BATCH
    types = [op.type for op in main.global_block().ops]
    modes = {}
    for m in r["exes"]:
        timed = np.asarray(r["secs"][m][SSD_WARMUP:])
        p50 = float(np.median(timed))
        modes[m] = dict(
            images_per_s=SSD_BATCH * SSD_STEPS / float(timed.sum()),
            step_p50_ms=1e3 * p50,
            step_p95_ms=1e3 * float(np.percentile(timed, 95)),
            first_step_s=r["secs"][m][0], mfu_fp32=flops / p50 / FP32_FLOPS,
            peak_memory_gb=r["peak"][m] / 1e9, launches=r["launches"][m],
            device_launches=r["on_card"][m])
    modes["captured"]["capture_s"] = _capture_seconds(r["exes"]["captured"],
                                                      main)
    modes["captured"]["graph_pools_gb"] = graph_pools_gb()
    path = dict(
        model="MobileNet-v1 SSD 300², PaddleCV/ssd mobilenet_ssd.py + "
              "train.py (tests/torch_port_detection_models.py)",
        batch=SSD_BATCH, image=SSD_IMAGE, classes=dm.VOC_CLASSES,
        priors=int(built["locs"].shape[1]),
        optimizer="RMSProp(piecewise_decay from 1e-3), L2Decay(5e-5)",
        dtype="fp32", steps=SSD_STEPS, warmup_steps=SSD_WARMUP,
        losses=loss_c, captured_eager_bit_equal=True,
        moving_stats_change_each_step=True, ops=len(types),
        conv_ops=types.count("conv2d") + types.count("depthwise_conv2d"),
        batch_norm_ops=types.count("batch_norm"),
        model_flops_per_image_fwd=fwd, model_flops_per_step=flops,
        mfu_formula="2 x multiply-adds of the program's conv2d, "
                    "depthwise_conv2d and mul ops a forward image x 3 x "
                    "batch / step p50 / 67 TFLOP/s (fp32, no TF32)",
        modes=modes, launches=_summed(r["launches"]),
        device_launches=_summed(r["on_card"]))
    state = dict(exes=r["exes"], scopes=r["scopes"], main=main, feed=feed,
                 loss=loss, fetch=[loss], built=built)
    return state, path


def _image_map(rows, feed, ap_version):
    """fluid.metrics.DetectionMAP over a batch's rows against its
    ground truth."""
    from paddle_tpu_torch import fluid

    m = fluid.metrics.DetectionMAP(overlap_threshold=SSD_MAP_OVERLAP)
    for i in range(rows.shape[0]):
        r = rows[i]
        k = feed["gt_box"][i, :, 2] > feed["gt_box"][i, :, 0]
        m.update(r[r[:, 0] >= 0], feed["gt_box"][i][k],
                 feed["gt_label"][i, k, 0])
    return float(m.eval(ap_version))


def run_ssd_eval(state, counters):
    """The test program (``clone(for_test=True)`` + detection_output:
    NMS 0.45, top 400, keep 200) on the trained scope, captured and
    eager in turns: every run's rows bit-equal to the eager run's, K1-K8
    never launched; its run p50 a mode, the kernels of one replay and
    those one multiclass_nms call adds (profiler), and the 11-point
    and integral mAP of the rows against the batch's ground truth (not
    gated: random-start weights after a few steps on one batch)."""
    built = state["built"]
    test, det = built["test"], built["det"]
    scope = state["scopes"]["captured"]
    feed = {"image": state["feed"]["image"]}
    exes = _executors()
    rows, secs = {m: [] for m in exes}, {m: [] for m in exes}
    before = _snap()
    for _ in range(SSD_EVAL_RUNS):
        for m, exe in exes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (out,) = exe.run(test, feed=feed, fetch_list=[det], scope=scope)
            secs[m].append(time.perf_counter() - t0)
            rows[m].append(np.asarray(out))
    py, dev = _since(before, counters)
    if py != _no_launches(counters) or dev != _no_launches(counters):
        raise AssertionError(f"ssd eval: K1-K8 launched: {py}, {dev}")
    ref = rows["eager"][0]
    diff = [(m, i) for m in rows for i, r in enumerate(rows[m])
            if not np.array_equal(r, ref)]
    if diff:
        raise AssertionError(f"ssd eval: rows differ from the eager "
                             f"run's: {diff}")
    held = [h.graph for h in exes["captured"].compiled_for(test)]
    if held == [None]:
        raise AssertionError("ssd eval: the captured executor holds no "
                             "graph")
    replay = _profile(lambda: exes["captured"].run(
        test, feed=feed, fetch_list=[det], scope=scope), 1)
    # the kernels one multiclass_nms call adds, at this program's shapes
    from paddle_tpu_torch.fluid import registry

    nms_op = next(op for op in test.global_block().ops
                  if op.type == "multiclass_nms")
    box_op = next(op for op in test.global_block().ops
                  if op.type == "box_coder")
    sm_name = nms_op.inputs["Scores"][0]
    dec, scores = exes["eager"].run(
        test, feed=feed, fetch_list=[box_op.outputs["OutputBox"][0],
                                     sm_name], scope=scope)
    ctx = registry.LowerContext(torch.device("cuda", 0))
    args = [torch.from_numpy(np.asarray(a)).cuda() for a in (dec, scores)]
    nms_lower = registry.get_op("multiclass_nms").lower
    nms = _profile(lambda: nms_lower(ctx, *args, attrs=dict(nms_op.attrs)),
                   1)
    nms_ms = _eager_call_ms(lambda: nms_lower(ctx, *args,
                                              attrs=dict(nms_op.attrs)))
    return dict(
        runs_a_mode=SSD_EVAL_RUNS, rows_bit_equal=True,
        run_p50_ms={m: 1e3 * float(np.median(secs[m][1:])) for m in secs},
        first_run_s={m: secs[m][0] for m in secs},
        capture_s=_capture_seconds(exes["captured"], test),
        replay_kernels=replay["device_events"],
        replay_busy_ms=replay["device_busy_ms"],
        replay_launch_api_calls=replay["launch_api_calls"],
        nms_kernels_a_call=nms["device_events"],
        nms_loop_kernels=4 * int(nms_op.attrs.get("nms_top_k", 400)),
        nms_eager_call_ms=nms_ms, nms_input_shapes=[list(a.shape) for a in args],
        detections_an_image=[int(v) for v in (ref[..., 0] >= 0).sum(1)],
        map_11point=_image_map(ref, state["feed"], "11point"),
        map_integral=_image_map(ref, state["feed"], "integral"))


def _ssd_rows_close(got, want):
    """Labels equal; scores and boxes within SSD_ROW_TOL where ``want``
    is a detection.  Returns the worst error (inf on a label)."""
    if got.shape != want.shape or not np.array_equal(got[..., 0],
                                                     want[..., 0]):
        return float("inf")
    valid = want[..., 0] >= 0
    return float(np.abs(got[valid][:, 1:] - want[valid][:, 1:]).max()) \
        if valid.any() else 0.0


def run_ssd_parity():
    """MobileNet-SSD at width 0.25, 300², b4, fp32: SSD_PARITY_STEPS
    RMSProp steps on the card, the port on the CPU taking each step from
    the card's state (phase 21's rule): each loss within 1e-4; the
    gradients and the update of every parameter (and moving statistic)
    at once within 0.1 of the CPU's; each leaf's gradient within 0.1 of
    the CPU's, or within SSD_PARITY_CTL x its own control where that is
    larger (SSD_PARITY_CHANGE_RTOL's comment says why); each reading
    beside the CPU's own from an input nudged by 1e-6.  Then the test
    program from the card's final state on both: the head outputs
    (locs, softmax scores) within SSD_HEAD_TOL of their largest
    magnitude, and the CPU's detection_output (box_coder, NMS) of the
    card's head outputs equal to the card's rows (labels equal, scores
    and boxes within SSD_ROW_TOL); the CPU's own rows against the card's
    printed beside (their labels can part where two candidates' scores
    are closer than the two devices' convs)."""
    from paddle_tpu_torch import convert, fluid
    from paddle_tpu_torch.fluid import registry

    dm = _detection_models()
    built = _ssd_program(scale=SSD_PARITY_SCALE, batch=SSD_PARITY_BATCH)
    main, loss = built["main"], built["loss"]
    feed = dm.ssd_batch(SSD_PARITY_BATCH, SSD_IMAGE, seed=1)
    gpu = fluid.Scope()
    gexe = fluid.Executor(_gpu_place())
    gexe.run(built["startup"], scope=gpu)
    cexe = fluid.Executor(fluid.CPUPlace())
    cpu, cpu2 = fluid.Scope(), fluid.Scope()
    _run_startup(cexe, built["startup"], cpu)
    _run_startup(cexe, built["startup"], cpu2)
    params = sorted(p.name for p in main.all_parameters())
    names = sorted(set(params) | set(_state_of(main, "stats")))
    persist = sorted(n for n, v in main.global_block().vars.items()
                     if v.persistable and gpu.get(n) is not None)
    nudged = dict(feed, image=feed["image"] * np.float32(1 + 1e-6))
    fetch = [loss.name] + [p + "@GRAD" for p in params]

    def rel(x, y, floor):
        return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), floor,
                                                 1e-30))

    def global_rel(xs, ys):
        num = sum(float(np.sum((x.astype(np.float64) - y) ** 2))
                  for x, y in zip(xs, ys))
        den = sum(float(np.sum(y.astype(np.float64) ** 2)) for y in ys)
        return float(np.sqrt(num / max(den, 1e-60)))

    losses = {"card": [], "cpu": []}
    grad_worst, grad_ctl, grad_over = ("", 0.0), ("", 0.0), ("", 0.0, 0.0)
    upd_worst, upd_ctl = ("", 0.0), ("", 0.0)
    grad_global, grad_global_ctl = [], []
    upd_global, upd_global_ctl = [], []
    for _ in range(SSD_PARITY_STEPS):
        start = {n: gpu.get(n).cpu().numpy().copy() for n in persist}
        convert.load_params(cpu, start, fluid.CPUPlace(), program=main)
        convert.load_params(cpu2, start, fluid.CPUPlace(), program=main)
        g_out = [np.asarray(v) for v in gexe.run(main, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=gpu)]
        c_out = [np.asarray(v) for v in cexe.run(main, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=cpu)]
        n_out = [np.asarray(v) for v in cexe.run(main, feed=nudged,
                                                 fetch_list=fetch,
                                                 scope=cpu2)]
        losses["card"].append(float(g_out[0]))
        losses["cpu"].append(float(c_out[0]))
        for p, g, c, u in zip(params, g_out[1:], c_out[1:], n_out[1:]):
            floor = 1e-3 * np.sqrt(c.size) * float(np.abs(c).max() or 1.0)
            got, ctl = rel(g, c, floor), rel(u, c, floor)
            grad_worst = max(grad_worst, (p, got), key=lambda t: t[1])
            grad_ctl = max(grad_ctl, (p, ctl), key=lambda t: t[1])
            limit = max(SSD_PARITY_CHANGE_RTOL, SSD_PARITY_CTL * ctl)
            grad_over = max(grad_over, (p, got / limit, ctl),
                            key=lambda t: t[1])
        grad_global.append(global_rel(g_out[1:], c_out[1:]))
        grad_global_ctl.append(global_rel(n_out[1:], c_out[1:]))
        ups = {}
        for n in names:
            ups[n] = (gpu.get(n).cpu().numpy() - start[n],
                      cpu.get(n).numpy() - start[n],
                      cpu2.get(n).numpy() - start[n])
            floor = 1e-6 * np.linalg.norm(start[n])
            upd_worst = max(upd_worst, (n, rel(ups[n][0], ups[n][1], floor)),
                            key=lambda t: t[1])
            upd_ctl = max(upd_ctl, (n, rel(ups[n][2], ups[n][1], floor)),
                          key=lambda t: t[1])
        upd_global.append(global_rel([u[0] for u in ups.values()],
                                     [u[1] for u in ups.values()]))
        upd_global_ctl.append(global_rel([u[2] for u in ups.values()],
                                         [u[1] for u in ups.values()]))
    a, b = np.asarray(losses["card"]), np.asarray(losses["cpu"])
    loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
    if not (np.all(np.isfinite(a)) and loss_rel <= SSD_PARITY_LOSS_RTOL
            and grad_over[1] <= 1
            and max(grad_global) <= SSD_PARITY_CHANGE_RTOL
            and max(upd_global) <= SSD_PARITY_CHANGE_RTOL):
        raise AssertionError(
            f"ssd parity: losses {losses} (max rel {loss_rel}), the "
            f"gradient of every leaf {grad_global} (control "
            f"{grad_global_ctl}), worst leaf gradient over its limit "
            f"{grad_over} (worst {grad_worst}, control {grad_ctl}), the "
            f"update of every leaf {upd_global} (control "
            f"{upd_global_ctl}), worst leaf update {upd_worst} (control "
            f"{upd_ctl})")
    # the test program from the card's final state on both devices
    test = built["test"]
    nms_op = next(op for op in test.global_block().ops
                  if op.type == "multiclass_nms")
    box_op = next(op for op in test.global_block().ops
                  if op.type == "box_coder")
    tr_op = next(op for op in test.global_block().ops
                 if op.type == "transpose2"
                 and op.outputs["Out"][0] == nms_op.inputs["Scores"][0])
    heads = [box_op.inputs["TargetBox"][0], tr_op.inputs["X"][0],
             box_op.inputs["PriorBox"][0], box_op.inputs["PriorBoxVar"][0]]
    tfeed = {"image": feed["image"]}
    convert.load_params(cpu, {n: gpu.get(n).cpu().numpy()
                              for n in persist}, fluid.CPUPlace(),
                        program=main)
    card = [np.asarray(v) for v in gexe.run(
        test, feed=tfeed, fetch_list=[built["det"]] + heads, scope=gpu)]
    host = [np.asarray(v) for v in cexe.run(
        test, feed=tfeed, fetch_list=[built["det"]] + heads, scope=cpu)]
    head_err = max(float(np.abs(c - h).max() / max(np.abs(h).max(), 1.0))
                   for c, h in zip(card[1:3], host[1:3]))
    # the CPU's detection_output of the card's head outputs
    ctx = registry.LowerContext("cpu")
    loc, sm, prior, pvar = (torch.from_numpy(x) for x in card[1:])
    dec = registry.get_op("box_coder").lower(ctx, prior, pvar, loc,
                                             attrs=dict(box_op.attrs))
    rows = registry.get_op("multiclass_nms").lower(
        ctx, dec, sm.permute(0, 2, 1).contiguous(),
        attrs=dict(nms_op.attrs)).numpy()
    row_err = _ssd_rows_close(card[0], rows)
    own = host[0]
    if head_err > SSD_HEAD_TOL or row_err > SSD_ROW_TOL:
        raise AssertionError(f"ssd parity: head outputs {head_err} (limit "
                             f"{SSD_HEAD_TOL}), rows of the card's heads "
                             f"decoded on the CPU {row_err} (limit "
                             f"{SSD_ROW_TOL})")
    return dict(
        model="MobileNet-SSD 300² width 0.25 fp32", batch=SSD_PARITY_BATCH,
        steps=SSD_PARITY_STEPS, each_step_from_the_cards_state=True,
        losses=losses, loss_max_rel=loss_rel,
        loss_rtol=SSD_PARITY_LOSS_RTOL, grad_all_leaves=grad_global,
        grad_all_leaves_control=grad_global_ctl,
        grad_worst_leaf=list(grad_worst),
        grad_worst_leaf_control=list(grad_ctl),
        grad_worst_leaf_over_limit=list(grad_over),
        grad_control_factor=SSD_PARITY_CTL,
        update_all_leaves=upd_global,
        update_all_leaves_control=upd_global_ctl,
        update_worst_leaf=list(upd_worst),
        update_worst_leaf_control=list(upd_ctl),
        change_rtol=SSD_PARITY_CHANGE_RTOL,
        head_max_rel=head_err, head_tol=SSD_HEAD_TOL,
        rows_of_card_heads_decoded_on_cpu_max_err=row_err,
        row_tol=SSD_ROW_TOL,
        cpu_own_rows=dict(
            labels_equal=bool(np.array_equal(own[..., 0], card[0][..., 0])),
            label_match_share=float(np.mean(own[..., 0] == card[0][..., 0])),
            max_err=_ssd_rows_close(card[0], own)),
        detections_an_image=[int(v) for v in (card[0][..., 0] >= 0).sum(1)])


def run_ssd_phase(wrappers, say, smi, child):
    """Phase 35: MobileNet-SSD's training and its captured evaluation
    (counts zeroed just before each and read just after), a profiled
    training step a mode, the card-against-CPU parity and the detection
    op checks; returns the phase's readings (launches summed over the
    training and the evaluation)."""
    t0 = time.perf_counter()
    counters = {k: wrappers[k] for k in wrappers}
    torch.cuda.empty_cache()
    state, path = run_ssd_path(counters)
    say("ssd train path", {"card": smi, **path})
    say("ssd train step", {"card": smi, **profile_modes(state)})
    ev = run_ssd_eval(state, counters)
    say("ssd eval", {"card": smi, **ev})
    del state
    torch.cuda.empty_cache()
    parity = run_ssd_parity()
    say("ssd parity", {"card": smi, **parity})
    torch.cuda.empty_cache()
    ops = run_detection_op_checks(child)
    say("detection op checks", {"card": smi, **ops})
    torch.cuda.empty_cache()
    out = {"path": path, "eval": ev, "parity": parity, "ops": ops,
           "seconds": time.perf_counter() - t0,
           "launches": path["launches"],
           "device_launches": path["device_launches"]}
    m = path["modes"]
    say("ssd summary", {
        "card": smi,
        "images_per_s": {k: m[k]["images_per_s"] for k in m},
        "step_p50_ms": {k: m[k]["step_p50_ms"] for k in m},
        "mfu_fp32": {k: m[k]["mfu_fp32"] for k in m},
        "eval_p50_ms": ev["run_p50_ms"], "map_11point": ev["map_11point"],
        "nms_kernels_a_call": ev["nms_kernels_a_call"],
        "parity_loss_max_rel": parity["loss_max_rel"],
        "op_checks_worst_ratio": ops["worst_ratio"],
        "ssd_seconds": out["seconds"]})
    return out


ALL_LIBRARIES = ("flash_attention", "fused_bias_act", "fused_update",
                 "paged_attention", "ragged_attention")
# what ``--only`` selects: {key: (kernel libraries, phase-3 checks)};
# "flash" phase 2's flash report and phase 3's K1-K3 checks (every
# FLASH_CASES case and the fp32 K1 at the predictor's shape);
# "engine" runs phases 10-11 (the ragged Engine, both arms) instead,
# "passes", "predictor" and "int8w" phases 14, 15 and 16 ("predictor"
# with phase 3's fp32 K1 at its shape), "gpt" phase 3's K1-K4 checks
# (GPT-2 small's shapes among them) and phases 17-18, "fleet" phase 19,
# "fp32train" phase 20, "resnet" phases 21-22, "cnn" phase 23, "nmt"
# phase 3's K1-K3 at the NMT shapes and phases 24-26, and "book" phase
# 3's K1-K3 at the Transformer book's shapes and phase 27, "health"
# phase 28, and "generate" phase 3's K1-K3 at the generation programs'
# prefill shapes and phase 29, "persist" phase 30, "resnetdp" K8's
# momentum group form at phase 31's members and phase 31, "amp" K4's
# fp16 form and phase 32, "moe" phase 33, "gm" phase 34 and "ssd"
# phase 35
ONLY = {"k4": (("fused_bias_act",), ("check_bias_gelu",
                                     "check_bias_gelu_bf16")),
        "k6": (("ragged_attention",), ("check_ragged",)),
        "k6_contract": (("ragged_attention",), ("check_ragged_contract",)),
        "flash": (("flash_attention",), ("check_flash",
                                         "check_flash_fp32_predictor")),
        "engine": (("ragged_attention",), ()),
        "passes": (("flash_attention", "fused_bias_act"), ()),
        "predictor": (("flash_attention", "fused_bias_act"),
                      ("check_flash_fp32_predictor",)),
        "int8w": (("fused_bias_act", "paged_attention"), ()),
        "gpt": (("flash_attention", "fused_bias_act"),
                ("check_flash", "check_bias_gelu_bf16")),
        "fleet": (("fused_bias_act", "paged_attention", "ragged_attention"),
                  ()),
        "fp32train": (("flash_attention", "fused_bias_act"), ()),
        # no kernel on their path: every library is built so that the
        # kernels' own counters can show 0 launches
        "resnet": (ALL_LIBRARIES, ()),
        "cnn": (ALL_LIBRARIES, ()),
        # K1-K3 on phase 25's path, none on phase 24's: every library
        "nmt": (ALL_LIBRARIES, ("check_flash_nmt",)),
        # K1-K3 on the fused Transformer book, none on the others
        "book": (ALL_LIBRARIES, ("check_flash_book",)),
        "health": (("flash_attention", "fused_bias_act"), ()),
        "generate": (("flash_attention", "fused_bias_act"),
                     ("check_flash_generate",)),
        "persist": (("flash_attention", "fused_bias_act",
                     "paged_attention"), ()),
        # K8's momentum group form on its path, none of K1-K7: every
        # library
        "resnetdp": (ALL_LIBRARIES, ("check_fused_update_group_momentum",)),
        "amp": (("flash_attention", "fused_bias_act"),
                ("check_bias_gelu_fp16",)),
        "moe": (("flash_attention", "fused_bias_act"), ()),
        "gm": (("flash_attention", "fused_bias_act"), ()),
        # no TPU kernel on phase 35's path: every library
        "ssd": (ALL_LIBRARIES, ())}
NEW_PHASES = ("fp32train", "passes", "predictor", "int8w", "gpt", "fleet",
              "resnet", "cnn", "nmt", "book", "health", "generate",
              "persist", "resnetdp", "amp", "moe", "gm", "ssd")
# the kernels phase 19 counts: K4, K5 and K6 on its path, K7 off it
FLEET_KERNELS = ("fused_bias_act", "paged_attention", "ragged_attention",
                 "paged_attention_quant")


def run_new_phases(wrappers, train_kernels, fp32_outs, smi, say,
                   cpu_child, keys=NEW_PHASES, train=None):
    """Phases 20, 14-19 and 21-35 (those of ``keys``, in that order);
    returns their path readings (None for a phase not run).  Phase 16's
    ids are compared with ``fp32_outs``, the fp32-weight lane's, where
    given (printed, not gated); phase 30's decode ids with its first
    requests' (gated); phase 32's steps are printed beside phase 4's
    (``train``) where it ran.  ``cpu_child``: the CPU reference child
    (CpuChild) of phases 18, 26, 32 and 35 among ``keys``."""
    ab = pred = path_w = gpt = fleet = fp32 = resnet = cnn = nmt = None
    book = health = gen = persist = resnetdp = amp = moe = gm = ssd = None
    if "fp32train" in keys:
        torch.cuda.empty_cache()
        pools = graph_pools_gb()
        state, fp32 = run_train_path(
            {k: wrappers[k] for k in train_kernels}, bf16=False)
        fp32["graph_pools_gb_before"] = pools
        say("fp32 train path", {"card": smi, **fp32})
        say("fp32 train step", {"card": smi,
                                **profile_fp32_train_step(state)})
        del state
        torch.cuda.empty_cache()
    if "passes" in keys:
        counters = {k: wrappers[k] for k in train_kernels}
        state, ab = run_passes_ab(counters)
        say("passes ab path", {"card": smi, **ab})
        say("passes ab step", {"card": smi, **profile_passes_ab(state)})
        del state
        torch.cuda.empty_cache()
        say("passes ab parity", run_passes_parity(counters))
    if "predictor" in keys:
        pred = run_predictor_path({k: wrappers[k] for k in train_kernels})
        say("predictor path", {"card": smi, **pred})
        torch.cuda.empty_cache()
    if "int8w" in keys:
        counters = {k: (wrappers[k], 1)
                    for k in ("fused_bias_act", "paged_attention")}
        cfg, scope, prompts, outs, path_w = run_int8w_path(
            counters, fp32_outs or [[]] * 16)
        say("int8 weights decode path", {"card": smi, **path_w})
        say("int8 weights decode step", {"card": smi, **profile_decode_step(
            cfg, scope, int8_weights=True)})
        say("int8 weights decode parity",
            run_parity(cfg, scope, prompts, outs, int8_weights=True))
        del scope
        torch.cuda.empty_cache()
    if "gpt" in keys:
        counters = {k: wrappers[k] for k in train_kernels}
        state, gpt = run_gpt_train_path(counters)
        say("gpt train path", {"card": smi, **gpt})
        say("gpt train step", {"card": smi, **profile_gpt_step(state)})
        del state
        torch.cuda.empty_cache()
        gpt["unfused"] = run_gpt_unfused(counters)
        say("gpt unfused path", {"card": smi, **gpt["unfused"]})
        torch.cuda.empty_cache()
        say("gpt parity", run_gpt_parity(cpu_child))
    if "fleet" in keys:
        torch.cuda.empty_cache()
        fleet = run_fleet_path({k: wrappers[k] for k in FLEET_KERNELS})
        g = fleet["generate"]
        say("fleet path", {"card": smi, **fleet})
        say("fleet summary", {
            "card": smi,
            "http_latency_s": g["request_quantiles"]["latency_s"],
            "http_ttft_s": g["request_quantiles"]["ttft_s"],
            "tokens_per_s_http": g["tokens_per_s_http"],
            "tokens_per_s_one_replica_direct":
                g["tokens_per_s_one_replica_direct"],
            "http_added_ms_per_token": g["http_added_ms_per_token"],
            "recovery_s": fleet["failover"]["recovery"],
            "mttr_s": fleet["failover"]["mttr_s"],
            "hedge_win_rate": fleet["hedge"]["hedge_win_rate"],
            "fleet_seconds": fleet["seconds"]})
    if "resnet" in keys:
        torch.cuda.empty_cache()
        state, resnet = run_resnet_path(wrappers)
        say("resnet train path", {"card": smi, **resnet})
        say("resnet train step", {"card": smi,
                                  **profile_resnet_step(state)})
        del state
        torch.cuda.empty_cache()
        resnet["predictor"] = run_resnet_predictor(wrappers)
        say("resnet predictor path", {"card": smi, **resnet["predictor"]})
        say("resnet parity", run_resnet_parity())
    if "cnn" in keys:
        torch.cuda.empty_cache()
        cnn = run_cnn_path(wrappers)
        say("cnn path", {"card": smi, **cnn})
        torch.cuda.empty_cache()
    if "nmt" in keys:
        nmt = run_nmt_phases(wrappers, say, smi, cpu_child)
    if "book" in keys:
        torch.cuda.empty_cache()
        book = run_book_path(wrappers)
        say("book path", {"card": smi, **book})
        say("book summary", {"card": smi, **book_summary(book)})
        torch.cuda.empty_cache()
    if "health" in keys:
        torch.cuda.empty_cache()
        health = run_health_path({k: wrappers[k] for k in train_kernels})
        say("health path", {"card": smi, **health})
        t = health["timing"]
        say("health summary", {
            "card": smi,
            "step_ms_off": t["off"], "step_ms_on": t["on"],
            "on_over_off_p50": t["on_over_off_p50"],
            "rollback_bit_equal_uninjected": True,
            "parity_loss_max_rel_diff":
                health["parity"]["loss_max_rel_diff"],
            "device_launches": health["device_launches"],
            "health_seconds": health["seconds"]})
        torch.cuda.empty_cache()
    if "generate" in keys:
        gen = run_generate_phase(wrappers, say, smi)
    if "persist" in keys:
        persist = run_persist_phase(
            wrappers, say, smi,
            lane_ids=fp32_outs[:PERSIST_REQUESTS] if fp32_outs else None)
    if "resnetdp" in keys:
        torch.cuda.empty_cache()
        state, resnetdp = run_resnet_dp_path(dict(wrappers))
        say("resnet dp path", {"card": smi, **resnetdp})
        say("resnet dp step", {"card": smi, **profile_modes(
            state, match=("fused_update_group_kernel",
                          "fused_update_kernel"))})
        del state
        torch.cuda.empty_cache()
        resnetdp["parity"] = run_resnet_dp_parity()
        say("resnet dp parity", resnetdp["parity"])
    if "amp" in keys:
        amp = run_amp_path({k: wrappers[k] for k in train_kernels}, say,
                           smi, cpu_child, train)
        torch.cuda.empty_cache()
    if "moe" in keys:
        torch.cuda.empty_cache()
        state, moe = run_moe_path({k: wrappers[k] for k in train_kernels})
        say("moe path", {"card": smi, **moe})
        say("moe step", {"card": smi, **profile_modes(state)})
        del state
        torch.cuda.empty_cache()
        moe["parity"] = run_moe_parity()
        say("moe parity", moe["parity"])
    if "gm" in keys:
        gm = run_gm_phase(wrappers, say, smi)
    if "ssd" in keys:
        ssd = run_ssd_phase(wrappers, say, smi, cpu_child)
    return (ab, pred, path_w, gpt, fleet, fp32, resnet, cnn, nmt, book,
            health, gen, persist, resnetdp, amp, moe, gm, ssd)


def run_only(keys, dev, smi, say):
    """Phases 2-3 for the kernels of ``keys`` alone: their build, the
    K4/K6 build report and their checks against the plain versions."""
    from paddle_tpu_torch.kernels import _build

    from paddle_tpu_torch.kernels import kernel_wrappers

    libs = sorted({lib for k in keys for lib in ONLY[k][0]})
    _build.start_builds(libs)
    start_warm_children([r for r in WARM_ROLES if r in keys])
    new = [k for k in keys if k in NEW_PHASES]
    parts = [p for p in CPU_CHILD_PARTS if p in new]
    child = CpuChild(parts) if parts else None
    try:
        say("build", {k: round(v, 2)
                      for k, v in _build.build_all(libs).items()})
        if "flash_attention" in libs:
            for label, r in flash_build_report().items():  # fails on a spill
                print(f"ptxas flash_attention: {label}: " + json.dumps(r))
        rng = np.random.RandomState(SEED)
        timings = {}
        for k in keys:
            for check in ONLY[k][1]:
                err, timed = globals()[check](dev, rng)
                timings[check] = dict(max_abs_err=err, timings=timed)
        if child is not None:  # ended before the host readings
            timings["cpu_reference_child"] = child.join()
        say("kernel timings", {"card": smi,
                               "launch_floor_ms": launch_floor_ms(),
                               **timings})
        if "engine" in keys:
            arms, parity = run_ragged_path(
                kernel_wrappers()["ragged_attention"])
            say("ragged engine waves", {"card": smi, **wave_readings(arms)})
            say("ragged engine parity", parity)
        if new:
            run_new_phases(kernel_wrappers(), ("flash_fwd", "flash_bwd_dq",
                                               "flash_bwd_dkv",
                                               "fused_bias_act"),
                           None, smi, say, child, keys=new)
    finally:
        if child is not None:
            child.close()
    report, bf16_loop = k4_k6_build_report()  # fails on a spill
    for label, r in report.items():
        print(f"ptxas {label}: " + json.dumps(r))
    say("K4 bf16 loop", {"sass": bf16_loop})


def run_phases_1_to_3(dev, smi, say):
    """Phases 1-3 of a whole run: every kernel's build (all started
    together), the build reports, and every kernel's checks against its
    plain version with their timings; K4's, K6's and K8's while the
    paged and flash kernels still build, K5's and K7's next, K1-K3's
    after.  The CPU reference child (CpuChild)
    starts with the builds and is waited for before the timings line,
    whose launch floor is a host reading.  Returns the checks' worst
    errors (``errs``) and timings (``timings``, as printed) and the
    child (``cpu_child``, ended)."""
    from paddle_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    _build.start_builds()
    # phases 18's, 26's and 32's CPU runs, in a child beside the builds
    # and phase 3
    cpu_child = CpuChild(list(CPU_CHILD_PARTS))
    atexit.register(cpu_child.close)
    rng = np.random.RandomState(SEED)
    check_s, ended_s, errs, t = {}, {}, {}, {}

    def check(key, fn, *args, **kw):
        """One phase-3 check, its seconds (and when it ended, from the
        builds' start) kept for the timings line."""
        t0 = time.perf_counter()
        errs[key], t[key] = fn(*args, **kw)
        label = fn.__name__ + ("_quant" if kw.get("quant") else "")
        check_s[label] = time.perf_counter() - t0
        ended_s[label] = time.perf_counter() - t_start

    # the kernels whose builds end first are checked first: K4, K6 and
    # K8 while the paged and flash kernels still build, then K5 and K7
    check("k4", check_bias_gelu, dev, rng)
    check("k4b", check_bias_gelu_bf16, dev, rng)
    check("k4h", check_bias_gelu_fp16, dev, rng)
    # the flash checks draw from the state K4's checks leave, so their
    # inputs do not depend on K5-K8's, which run while the flash
    # kernels build
    flash_rng = np.random.RandomState()
    flash_rng.set_state(rng.get_state())
    check("k6", check_ragged, dev, rng)
    check("k6c", check_ragged_contract, dev, rng)
    check("k8", check_fused_update, dev, rng)
    check("k8g", check_fused_update_group, dev)
    check("k8m", check_fused_update_group_momentum, dev)
    check("k5", check_paged, dev, rng)
    check("k7", check_paged, dev, rng, quant=True)
    for name in _build.sources():
        if name in ("flash_attention", "paged_attention", "fused_bias_act",
                    "ragged_attention"):
            continue  # reported kernel by kernel below
        for _, label, props in _ptxas_entries(name):
            print(f"ptxas {name}: {label}: " + json.dumps(props))
    for label, r in paged_build_report().items():
        print(f"ptxas paged_attention: {label}: " + json.dumps(r))
    k4k6_report, k4_loop = k4_k6_build_report()
    for label, r in k4k6_report.items():
        print(f"ptxas {label}: " + json.dumps(r))
    _build.build_all()  # the flash kernels' build, if it still runs
    took = dict(_build.BUILD_SECONDS)
    print(f"build: {max(took.values()):.2f} s (one nvcc a source, all "
          f"started together; K4-K8 checked meanwhile) "
          f"{json.dumps({k: round(v, 2) for k, v in took.items()})}",
          flush=True)
    for label, r in flash_build_report().items():
        print(f"ptxas flash_attention: {label}: " + json.dumps(r))
    say("K4 bf16 loop", {"sass": k4_loop})
    check("fl", check_flash, dev, flash_rng)
    check("k1p", check_flash_fp32_predictor, dev, flash_rng)
    check("nmt", check_flash_nmt, dev, flash_rng)
    check("book", check_flash_book, dev, flash_rng)
    check("gen", check_flash_generate, dev, flash_rng)
    torch.cuda.empty_cache()
    for k, timed in (("K5", t["k5"]), ("K7", t["k7"])):
        for name, r in timed.items():
            print(f"{k} {name}: split plan {r['splits']} x "
                  f"{r['pages_per_split']} pages, partials {r['workspace']} "
                  f"= {r['workspace_bytes']} bytes; {r['ms']:.4f} ms (one "
                  f"split {r['one_split_ms']:.4f})", flush=True)
    child = cpu_child.join()
    timings = {
        "paged_attention": t["k5"], "fused_bias_act": {
            **t["k4"], **t["k4b"], **t["k4h"]},
        "flash": t["fl"], "ragged_attention": t["k6"],
        "ragged_attention_contract": t["k6c"], "k4_bf16_loop_sass": k4_loop,
        "paged_attention_quant": t["k7"], "fused_update": t["k8"],
        "fused_update_group": t["k8g"],
        "fused_update_group_momentum": t["k8m"],
        "flash_fp32_predictor": t["k1p"], "flash_nmt": t["nmt"],
        "flash_book": t["book"], "flash_generate": t["gen"],
        "check_seconds": check_s, "check_ended_s": ended_s,
        "build_seconds": took,
        "cpu_reference_child": child, "launch_floor_ms": launch_floor_ms(),
        "card": smi}
    say("kernel timings", timings)
    return dict(errs=errs, timings=t, cpu_child=cpu_child)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (see the module docstring).")
    ap.add_argument("--only", help="comma-separated keys of ONLY (k4, k6, "
                    "k6_contract, flash, engine, passes, predictor, int8w, "
                    "gpt, fleet, fp32train, resnet, cnn, nmt, book, "
                    "health, generate, persist, resnetdp, amp, moe, gm, "
                    "ssd): "
                    "phases 1-3 "
                    "for those kernels alone (flash: with phase 2's flash "
                    "report; engine: phases 10-11; passes, predictor, "
                    "int8w: phases 14, 15, 16; gpt: K1-K4 and phases "
                    "17-18; fleet: phase 19; fp32train: phase 20; resnet: "
                    "phases 21-22; cnn: phase 23; nmt: K1-K3 at the NMT "
                    "shapes and phases 24-26; book: K1-K3 at the "
                    "Transformer book's shapes and phase 27; health: phase "
                    "28; generate: K1-K3 at the generation programs' "
                    "shapes and phase 29; persist: phase 30; resnetdp: "
                    "K8's momentum group form at phase 31's members and "
                    "phase 31; amp: K4's fp16 form and phase 32; moe: "
                    "phase 33; gm: phase 34; ssd: phase 35); the "
                    "default "
                    "runs every phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    from paddle_tpu_torch.kernels import kernel_wrappers

    t_main = time.perf_counter()
    t_last = [t_main]

    def say(label, reading):
        """One phase's reading as a JSON line, with the script's
        elapsed seconds (the run must end within its time limit) and
        the seconds since the previous line."""
        now = time.perf_counter()
        print(f"{label} " + json.dumps(
            {**reading, "elapsed_s": now - t_main,
             "phase_s": now - t_last[0]}), flush=True)
        t_last[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = _smi()
    from paddle_tpu_torch.observability import profiling

    platform, peak_flops, peak_bw, peak_link = profiling.device_peaks()
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks ({platform}, the port's table): "
          f"{peak_flops:.4g} flop/s, {peak_bw:.4g} B/s HBM, "
          f"{peak_link:.4g} B/s link", flush=True)

    if args.only:
        run_only(args.only.split(","), dev, smi, say)
        print(smi)
        print(json.dumps({"ok": True, "only": args.only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    start_warm_children()  # phases 19's and 30's, beside the builds
    p3 = run_phases_1_to_3(dev, smi, say)
    cpu_child, err, tm = p3["cpu_child"], p3["errs"], p3["timings"]

    wrappers = kernel_wrappers()
    train_kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "fused_bias_act")
    state, train = run_train_path({k: wrappers[k] for k in train_kernels})
    say("train path", {"card": smi, **train})
    say("train lookup grads", {"card": smi, **time_lookup_grads(dev)})
    say("train step", {"card": smi, **profile_train_step(state)})
    say("train run_steps", run_train_chain(state))
    del state
    torch.cuda.empty_cache()
    say("train parity", run_train_parity())

    decode_kernels = ("fused_bias_act", "paged_attention")
    cfg, scope, prompts, outs, path = run_path(
        dev, {k: (wrappers[k], 1) for k in decode_kernels})
    say("decode path", {"card": smi, **path})
    say("decode step", {"card": smi, **profile_decode_step(cfg, scope)})
    parity = run_parity(cfg, scope, prompts, outs)
    say("decode parity", parity)
    say("decode lane K5", lane_in_turns(cfg, scope, prompts, outs))
    fp32_outs = outs
    del scope
    torch.cuda.empty_cache()

    # the int8 KV pool: K4 and K7 once a layer per program run, K5 never
    int8_counts = {"fused_bias_act": 1, "paged_attention_quant": 1,
                   "paged_attention": 0}
    cfg, scope, prompts, outs, path8 = run_path(
        dev, {k: (wrappers[k], n) for k, n in int8_counts.items()},
        pool_dtype="int8")
    say("int8 decode path", {"card": smi, **path8})
    say("int8 decode step", {"card": smi, **profile_decode_step(
        cfg, scope, pool_dtype="int8")})
    say("int8 decode parity",
        run_parity(cfg, scope, prompts, outs, pool_dtype="int8"))
    say("int8 decode lane K7",
        lane_in_turns(cfg, scope, prompts, outs, pool_dtype="int8"))
    del scope
    torch.cuda.empty_cache()

    arms, ragged_parity = run_ragged_path(wrappers["ragged_attention"])
    say("ragged engine path", {"card": smi, **arms})
    say("ragged engine waves", {"card": smi, **wave_readings(arms)})
    say("ragged engine parity", ragged_parity)
    torch.cuda.empty_cache()

    dp_kernels = train_kernels + ("fused_update",)
    state, dp = run_dp_path({k: wrappers[k] for k in dp_kernels})
    say("dp train path", {"card": smi, **dp})
    say("dp train step", {"card": smi, **profile_dp_step(state)})
    del state
    torch.cuda.empty_cache()
    say("dp train parity", run_dp_parity())

    (ab, pred, path_w, gpt, fleet, fp32, resnet, cnn, nmt, book,
     health, gen, persist, resnetdp, amp, moe, gm, ssd) = run_new_phases(
        wrappers, train_kernels, fp32_outs, smi, say, cpu_child,
        train=train)
    cpu_child.close()

    dec = tm["k5"]["decode"]
    k4 = tm["k4b"]["[16384,3072] bf16"]
    # each path's counts over its run in both modes: the wrappers'
    # (eager runs, warm-ups and captures) and the card's (every run)
    by_path = {key: {"train": train[key], "dp_train": dp[key],
                     "decode": path[key], "decode_int8": path8[key],
                     "passes_on": ab["arms"]["on"][key],
                     "passes_off": ab["arms"]["off"][key],
                     "predictor_on": pred["arms"]["on"][key],
                     "predictor_off": pred["arms"]["off"][key],
                     "decode_int8_weights": path_w[key],
                     "gpt_train": gpt[key], "fp32_train": fp32[key],
                     "gpt_unfused": gpt["unfused"][key],
                     "fleet": fleet[key],
                     # the image models: no TPU kernel on their path
                     "resnet_train": resnet[key],
                     "resnet_predictor": resnet["predictor"][key],
                     "cnn": cnn[key],
                     # phase 24 none; 25 K1-K3; 26 K1
                     **{p: nmt[p][key] for p in (
                         "nmt_train", "nmt_train_flash", "nmt_decode")},
                     # phase 27: K1-K3 on the fused Transformer book
                     "book": book[key],
                     # phase 28: the train step under the health sentinel
                     "health": health[key],
                     # phase 29: GPT generation (K1, K4), and the train
                     # step under BERT's LR schedule (K1-K4)
                     "generate": gen["generate"][key],
                     "sched_train": gen["sched_train"][key],
                     # phase 30: the train step's three runs (two in
                     # children), the predictor's two formats, the two
                     # decode children
                     "persist": persist[key],
                     # phase 31: K8's momentum group form; 32: K1-K4
                     # (fp32 K1-K3, bf16 and fp16 K4); 33: K1-K3, K4 once
                     "resnet_dp": resnetdp[key], "amp": amp[key],
                     "moe": moe[key],
                     # phase 34: the merged micro-steps (K1-K4), the
                     # evaluation (K1, K4), the saliency pass (K1-K3)
                     "gm": gm[key],
                     # phase 35: MobileNet-SSD, no TPU kernel on its path
                     "ssd": ssd[key],
                     **{f"engine_{k}": {"ragged_attention": a[key]
                                        + a["eager"][key]}
                        for k, a in arms.items()}}
               for key in ("launches", "device_launches")}

    def launches(name, key="launches"):
        return {p: n[name] for p, n in by_path[key].items() if name in n}

    def row(name, source, replaces, err, t, gpt_t=None, pred_t=None,
            shapes=None):
        runs = launches(name)
        on_card = launches(name, "device_launches")
        out = dict(name=name, route="cuda", source=source,
                   replaces=replaces, launches=sum(runs.values()),
                   launches_by_path=runs,
                   device_launches=sum(on_card.values()),
                   device_launches_by_path=on_card, max_abs_err=err,
                   ms=t["ms"], plain_ms=t["plain_ms"],
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                   library_ms=t.get("library_ms"))
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        if gpt_t is not None:  # the same readings at GPT-2 small's shape
            out["at_gpt_shape"] = {k: gpt_t.get(k) for k in keys}
        if pred_t is not None:  # fp32 at the predictor's shape
            out["at_predictor_shape_fp32"] = {
                k: pred_t.get(k) for k in keys + (
                    "composed_ms", "bound_simt_ms", "bound_simt_by")}
        for label, st in (shapes or {}).items():  # other timed shapes
            out[f"at_{label}"] = {
                k: st[k] for k in keys + ("shape", "dtype", "causal",
                                          "bound_simt_ms", "bound_simt_by",
                                          "copy_ms", "kind")
                if k in st}
        return out

    flash_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    flash_py = "paddle_tpu/kernels/primitives/flash.py"

    def flash_shapes(kern):
        return {**{n: tm["fl"][n][kern] for n in ("gpt3_6p7b", "fp32_d128",
                                              "fp32_path", "fp32_gpt")},
                **{case[0]: tm["nmt"][case[0]][kern]
                   for case in NMT_FLASH_CASES},
                **{case[0]: tm["book"][case[0]][kern]
                   for case in BOOK_FLASH_CASES},
                **{case[0]: tm["gen"][case[0]][kern]
                   for case in GEN_FLASH_CASES}}

    kernels = [
        row("flash_fwd", flash_src, f"{flash_py}:78",
            max(err["fl"]["flash_fwd"], err["k1p"], err["nmt"]["flash_fwd"],
                err["book"]["flash_fwd"], err["gen"]["flash_fwd"]),
            tm["fl"]["flash_fwd"],
            tm["fl"]["gpt"]["flash_fwd"], tm["k1p"],
            flash_shapes("flash_fwd")),
        row("flash_bwd_dq", flash_src, f"{flash_py}:130",
            max(err["fl"]["flash_bwd_dq"], err["nmt"]["flash_bwd_dq"],
                err["book"]["flash_bwd_dq"], err["gen"]["flash_bwd_dq"]),
            tm["fl"]["flash_bwd_dq"],
            tm["fl"]["gpt"]["flash_bwd_dq"],
            shapes=flash_shapes("flash_bwd_dq")),
        row("flash_bwd_dkv", flash_src, f"{flash_py}:167",
            max(err["fl"]["flash_bwd_dkv"], err["nmt"]["flash_bwd_dkv"],
                err["book"]["flash_bwd_dkv"], err["gen"]["flash_bwd_dkv"]),
            tm["fl"]["flash_bwd_dkv"],
            tm["fl"]["gpt"]["flash_bwd_dkv"],
            shapes=flash_shapes("flash_bwd_dkv")),
        row("fused_bias_act", "paddle_tpu_torch/csrc/fused_bias_act.cu",
            "paddle_tpu/kernels/fused_bias_act.py:106",
            max(err["k4"], err["k4b"], err["k4h"]),
            k4, tm["k4b"]["[8192,3072] bf16"], shapes={
                f"{d}_{n}_mask_{m}".lower(): t[f"[{r},{h}] {x}mask={m}"]
                for d, t, x in (("fp32", tm["k4"], ""),
                                ("fp16", tm["k4h"], "fp16 "))
                for n, r, h in (("ffn", 16384, 3072), ("mlm", 2048, 768))
                for m in (False, True)}),
        row("paged_attention", "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/kernels/primitives/paged.py:121", err["k5"], dec),
        row("ragged_attention", "paddle_tpu_torch/csrc/ragged_attention.cu",
            "paddle_tpu/kernels/primitives/ragged.py:74", err["k6"],
            tm["k6"]["path"]),
        row("paged_attention_quant",
            "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/kernels/primitives/paged.py:241", err["k7"],
            tm["k7"]["decode"]),
        row("fused_update", "paddle_tpu_torch/csrc/fused_update.cu",
            "paddle_tpu/kernels/fused_update.py:322",
            max(err["k8"], err["k8g"], err["k8m"]), tm["k8g"],
            shapes={"resnet_dp_momentum_group": tm["k8m"]}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
