"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (a failing phase fails the script; none is caught):

1. device: the card's name and count, its power limit from nvidia-smi,
   and the TF32 switches (off: the port computes in fp32 like the JAX
   package) and cuBLAS's bf16 reduced-precision reductions (off: a bf16
   product accumulates in fp32);
2. build: every CUDA kernel of the serving and training paths, from the
   sources in this checkout (paddle_tpu_torch/ops/kernels/csrc), one
   nvcc each, all started together;
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's shapes (the xent pair also at edge cases: label smoothing
   on and off, ignored rows, an out-of-range label, odd N and V, bf16
   logits, rows off a 16-byte boundary (V 1001 fp32, 1003 bf16), the
   MNIST head (V 10, at 64 rows with ignored and out-of-range labels and
   at phase 10's [4096, 10]), layer_norm also on bf16 rows at [8192,
   512] and at the predictor's [4096, 512] (one bf16 ulp of the largest
   |plain| in at most 5% of the elements, the same bits twice; the
   planted fault, the variance taken without the mean subtracted, must
   fail), the forward's plans on each side of its
   crossovers (V 1, 31, 32, 33, fp32 4096 and 4097, bf16 8192 and 8193:
   a group of lanes, a warp, a block a row), eight CTAs a row (V 300000) and a row too wide to
   stage (V 524288, the backward's streamed body); their dx is held
   element by element and both the loss and lse and dx must repeat bit
   for bit on a second launch, and planted faults must fail: the loss
   with the label read from its neighbour's column or the eps term
   dropped, dx with a dropped eps/V term, a shifted lse or an lse
   from the first half of the row only; both are
   timed, beside their plain versions, the library's F.cross_entropy and
   their bound, at the training shape in fp32 and bf16 (AMP's logits;
   the `bf16` field of their entries) and at the MNIST head's [4096, 10]
   fp32 (the `mnist` field), the forward also on a block a row at 1, 2,
   4 and 8 16-byte loads in flight a thread and, at [4096, 10], beside
   an empty launch of one 256-thread CTA a row and of its own grid, and
   its plans against each other at V 10 to 32000 (`plans_ms`), the
   backward also at each cluster size (1,
   2, 4, 8 CTAs a row) and in its streamed body, beside a copy of the
   same bytes; the
   attention forwards also with the residuals their backward kernels
   read, saved P and lse, flash's forward also at the chunked prefill's
   shape, 1024 queries over 2048 keys (timed in its entry's
   `non_square` field, with whether its rows are the same bits as at
   tq = tk = 2048), and the three attention backward kernels at
   the training shapes, causal and not, sdpa_short also at d 128,
   ragged tiles and T 13 (odd rows of P), flash also at d 128 and 256,
   tq < tk, rows that see no key and ragged tiles, each grad held
   against the largest |plain| of it, which planted faults, an lse off
   by 1e-3, a dropped delta and a P off by 1e-3, must fail, and so must
   the plain backwards run on TF32-rounded operands (a kernel that
   dropped the small half of its split-TF32 products); a second launch
   of each attention backward kernel on the same inputs must give
   identical bits, and they, the forwards with their residuals and the
   library's calls are also timed causal; the library backward's own
   error against the plain version is recorded; both attention
   forwards, split TF32 too, must repeat bit for bit with their
   residual and without (sdpa_short's output without P must equal its
   output with P), and the plain forwards on TF32-rounded q, k and v
   must fail their output and residual limits; the fused-block kernels,
   attention_block with its saved P and its backward, ffn_block and its
   backward, at the training shape, causal and not, at a small one, at
   T 512 causal and at Dh 128 with T 200, each output and grad held
   against the largest |plain| of it, which planted faults, the
   attention_block forward with the causal flag dropped, a P off by
   1e-3, dWo computed from g transposed, b1 left out of the FFN
   backward's recompute and the ReLU mask inverted on one column, must
   fail, and so must the ffn_block forward with b2 left out; the
   fused-block kernels, split TF32 on the tensor cores, must repeat bit
   for bit (the attention_block forward's output the same bits with P
   and without) and their TF32 controls, the plain versions on
   TF32-rounded operands, must fail; at the training shape no FFN unit
   may take one ReLU mask in the ffn_block forward's hidden and the
   other in its backward's recompute; the paged decode-attention kernel
   at the paged serving shape with steps spread over the buffer, one
   lane at step -1 and unallocated pages at block 0, and with every
   lane's step on a page boundary, with every step inside the first
   chunk of positions, at a small shape, at Dh 128 and 256 and for one
   lane alone at T 1024, and for two lanes at T 1024, one at step -1,
   each case
   repeating bit for bit, which planted faults, the step off by one and
   page p+1 read for page p, must fail, timed with the L2 warm and
   cold), with its time, the plain version's time, one
   PyTorch library call's time as a yardstick (for the fused blocks, the
   composition of library calls that computes the same function), and
   the least time the card could take (the larger of bytes / 3.35 TB/s
   and fp32 operations / 67 TFLOP/s, the H100 SXM data-sheet peaks;
   for the split-TF32 kernels, every attention kernel and the four
   fused-block kernels, also three times their function's products over
   495 TFLOP/s, with their TFLOP/s);
   the attention kernels #2-#6 also in bf16 (AMP) at the training
   shapes, causal and not, flash also at d 128 (#2-#4 at d 64 and 128,
   #5 and #6 on wgmma fed by TMA, csrc/attn_wgmma.cuh, whose three
   operand forms, SS K-major, SS MN-major and RS on hi/lo planes, are
   first held against float64 at n 64 and 128, and whose ptxas
   registers and spills are logged): outputs, the saved bf16 P, the
   fp32 lse and the grads within one bf16 ulp of the largest |plain|
   in at most 5% of the
   elements, no further from a float64 oracle than twice the plain
   version, the same bits on a second launch; planted faults (the flash
   backward fed lse + 1e-2, the causal flag dropped, #6's dS, #4's P^T
   and #3's dS as one bf16 term, #5's P from the running max) must
   fail; each timed beside its bf16 bound (bytes / 3.35 TB/s
   against products / 989 TFLOP/s) and the library's flash SDPA in bf16,
   in each kernel's `bf16` field of the kernels line; the fused-block
   kernels #10-#13 also in bf16 (AMP) at the training shape (x
   [64,256,512], H 8, F 2048), the attention block causal and not:
   outputs and grads within one bf16 ulp at the largest |plain| (2^-8 to
   2^-7 of it) in at most 5% of the elements and no further from a
   float64 oracle than twice the plain version (the FFN backward's ReLU
   masks pinned to the forward kernel's hidden, the flips bounded, no
   unit with two masks between #12 and #13), P fp32, the same bits on a
   second launch; planted faults (the
   attention_block forward with the causal flag dropped, the FFN
   backward with dh as one bf16 term, the FFN with h as one bf16 term:
   #12 and #13 keep h and dh as hi + lo bf16 planes on wgmma; the
   attention block with q and k as planes in the scores, or dqkv as one
   bf16 term: #10 and #11 keep q k^T in fp32, their other intermediates
   as planes) must fail, and that design's plain version must pass;
   each timed beside its
   bound (bytes / 3.35 TB/s against the function's products, each counted
   once, / 989 TFLOP/s), its TFLOP/s, its TFLOP/s as run (a planed
   operand counting twice, two planed or split-TF32 ones three times) and
   the library's composition in bf16 (cuBLAS products around
   F.scaled_dot_product_attention; addmm, relu, addmm), forward and
   under autograd, #12 and #13 also at the bench's batch (x
   [128,256,512]); the FFN kernels' ptxas registers and spills; their
   engine's six operand layouts against float64 at a ragged shape and
   at depth 32768, where one accumulator for all of k must fail;
   lookup_table: the op and its grad op on the card with ids out of
   range and negative, against the CPU (NaN rows in the same places, the
   same W@GRAD), then a kernel launch that must still run and agree: the
   CUDA context survived; step key: a program of one uniform_random op
   draws anew on each run of one scope on the card, run_steps on it
   names why it runs eagerly (a CPU generator's draw, which a graph's
   replay would repeat) and returns on the card what three runs draw,
   and a kernel launched after it agrees with its plain version, and a
   dropout op's masks on the card equal the CPU's over two steps (the
   device step key's draw is int64 SplitMix64 on both);
4. slice: Transformer-base (d_model 512, 8 heads, 6+6 layers, d_inner
   2048, vocab 30000), random weights from a seed, built with the port's
   layers as the KV-cached incremental decode program at prompt lengths
   512 (sdpa_short) and 1024 (flash attention), each served through
   GenerationServer(max_batch_size=8) to 8 threaded generate() calls.
   The kernels' launch counters must show the path went through them;
   the tokens must equal the same program on the same weights run on
   the CPU with the plain versions (a mismatch is a tie only where the
   CPU run's top-2 logit margin at the first diverging step is below
   the logits tolerance), and the first step's logits must agree. As a
   control, the first step also runs once with TF32 switched on, and its
   logits error must exceed the tolerance: the check would catch a
   precision loss of that size. At prompt length 1024 the phase then
   shows where a batch's time goes: the wall time of the whole decode
   and of the encoder plus one step (so one decode step's time), and
   one batch under torch.profiler (the card's busy time, its idle share
   and the kernels that took most of it).
5-7. train: Transformer-base's training program (transformer.build_program
   with PADDLE_TPU_FUSE_ATTN_BLOCK cleared: vocab 32000, dropout 0, Adam
   under noam decay), random weights from a
   seed and random token ids, in fp32 at 16384 target tokens a step:
   seq 256 at batch 64 (plain attention), seq 512 at batch 32 (every
   attention op on sdpa_short and its backward kernel) and seq 1024 at
   batch 16 (flash and its dq and dk/dv kernels). Each phase: parity on
   the first 2 rows against the same program and weights on the CPU:
   the step-1 loss, named grads (fetched by their @GRAD names) and
   Adam's first moment, first against the CPU run as it is, then
   against the CPU run with its FFN ReLU masks pinned to the card's
   (an FFN unit within rounding of zero flips its mask between any two
   fp32 runs); the phase prints the flips per layer. A TF32 control
   must exceed every grad limit. Then 5 Adam steps on the full batch
   through the kernels (launch counters: xent forward and backward once
   a step, layer_norm 30 times, its grad taking the plain version's vjp
   and launching nothing; at seq 512 and 1024 each of the 18 attention
   ops launches its forward kernel twice a step, in the forward op and
   in its grad op's recompute, and its backward kernel(s) once), the
   loss finite at each: the step time (best of 2 after a warm-up; the
   last 2 steps run under the profiler),
   tokens/s, peak memory allocated and reserved, and one step under
   torch.profiler. Then the run_steps leg: the same 5 steps from a fresh
   scope with the same weights and feed through Executor.run_steps, whose
   first call runs step 1 eagerly, captures one step in a CUDA graph and
   replays it; its losses must match the eager leg's within 1e-6
   relative; a second call from the seeded weights loaded into the same
   scope must capture nothing (compile_count) and match too, and is
   timed (its wall time / 5 is the step time); a third, from the seeded
   weights again, runs under torch.profiler (busy ms a step, idle share)
   and must match too. The launch counters must read two steps' launches
   after the first call (step 1 eager, the capture recording each launch
   once) and not move at a replay; the profiled call's trace must hold
   every kernel of the eager profiled step's, none more than 5 times as
   often (the profiler loses some records of a replay: what it missed is
   logged). The `kernels` line's launches are the eager legs' counters.
   After phase 7, phase 5's configuration at the
   bench's batch, 128 (bench.py:218), eager and run_steps legs without
   the parity step. Then the bf16 legs under amp.amp_guard(True): the
   bench's own settings (seq 256, batch 128, vocab 32000, Adam under
   noam_decay(512, 8000), dropout 0), seq 512 / batch 32 and 1024 /
   batch 16 (#5/#6 and #2-#4 in bf16): each a 2-row step-1 parity
   against the port's CPU run under AMP (the loss, and the first encoder
   and decoder attention outputs within the bf16 kernels' gate, which
   the card's step with AMP off must fail), then the eager and run_steps
   legs as above (one capture each, the launch counters as predicted,
   peak memory). Then the dropout leg: phase 5's configuration at
   dropout 0.1. Step 1 on 2 rows against the port's CPU run from the
   same weights, program seed and step key: the loss, the first dropout
   op's Out and the first attention op's Out (dropout on P) within 1e-5,
   which the CPU run from another step key must fail for both Outs.
   Then captured through run_steps (no eager reason), K replayed steps
   equal to K Executor.run steps within 1e-6, the first dropout op's
   mask other at every step, the losses other than phase 5's by more
   than 1e-6; one eager step's mask draws timed alone, for their share
   of the step. After phase 8: the bench's fused Transformer
   (bench_transformer_fused: seq 256, batch 128, PADDLE_TPU_FUSE_ATTN_BLOCK=1)
   under AMP, #10-#13 in bf16, as the bf16 legs above, its parity
   gate also failing with the decoder's causal flag dropped on the card,
   set beside the unfused bf16 leg and phase 8. Last, phase 5's
   configuration with recompute, clipping and weight decay
   (transformer(checkpoints=ck) under
   RecomputeOptimizer(Adam(noam_decay, regularization=L2Decay(1e-4))) and
   set_gradient_clip(GradientClipByGlobalNorm(c)), c half the smaller
   step-1 global gradient norm the card reads on 2 rows and on the full
   batch): step-1 parity on 2 rows against the CPU by phase 5's gates
   (the recomputed ReLUs pinned with their forwards), the clip's scale
   below 1 on both, then the eager and run_steps legs (replays within
   1e-6), the same program without recompute for its eager peak memory
   (must be higher) and losses (within 1e-5), and its dropout-0.1
   variant on 2 rows, whose recomputed dropout mask and attention output
   (dropout on P) must equal their forwards' bit for bit.
8. train fused: phase 5's configuration built with
   PADDLE_TPU_FUSE_ATTN_BLOCK=1 set around transformer.build_program:
   each of the 12 self-attention sub-layers is one attention_block op and
   each of the 12 FFNs one ffn_block op (the 6 cross-attention ops stay
   attention ops, on the plain composition at seq 256). Parity on 2 rows
   against the CPU: the loss, logits.w and the grads above every FFN ReLU
   within 1e-5, the grads below them within 1e-3 (the ReLU masks live
   inside the kernels: the phase reports the units whose pre-activation
   has another sign on the card, and asserts that no unit's mask differs
   between the ffn_block forward kernel and its backward's recompute on
   the card's inputs), and a planted fault, the decoder's
   causal flag dropped in the card's run, must fail every grad limit.
   Then 5 Adam steps through the fused kernels (each op launches its
   forward kernel twice a step, in the forward op and, attention_block
   saving P, in its grad op's recompute, and its backward kernel once),
   timed and profiled as phases 5-7 with its run_steps leg, beside phase
   5's unfused step.
9. paged serve: Transformer-base through build_decode_step_program with
   the paged cache (16 lanes, 256 blocks of 16 positions, 16 prompt
   entries, prompts and buffers of 256 tokens) under
   PagedContinuousGenerationServer(steps_per_tick=8): 32 threaded
   submits, 8 shared prompts 3 times each and 8 unique ones (with
   radix_reuse=False: the prefix cache's hit and miss tiers), then the
   same requests through the dense ContinuousGenerationServer on the
   same 16 lanes. The paged decode-attention kernel must launch n_layers
   times a tick (the device's tick counter); the copies of a shared
   prompt give one row; the tokens must equal the CPU whole-loop decode
   (build_incremental_decode_program, plain versions) on 4 distinct
   prompts (8 earlier, cut for time) and the dense leg on every
   request, under phase 4's tie
   rule; the block pool and the prompt entries drain. Requests/s,
   tokens/s and latency of both legs, and one burst of the paged server
   under torch.profiler.
10. train mnist (before phase 9 in the run): the MNIST fc net
   (models/mnist.py build_program(use_conv=False), 784-128-64-10,
   BASELINE.md config 1) at bench.py bench_mnist's batch, 4096, on its
   synthetic separable batch as [784] images, seeded weights, SGD. Step
   1 against the CPU run of the same program (TF32 off): the loss within
   1e-5 relative, the last fc's grads (above every ReLU) within 1e-5
   norm-wise, the grads below a ReLU within 1e-3. Then 20 eager steps
   (the xent kernels launch once each a step; the loss falls) and 20
   steps through run_steps (one capture, losses within 1e-6 of the eager
   ones; five more calls from the seeded weights capture nothing and are
   timed on the host's clock: the median ms a step, its spread and
   examples/s beside the card's name and power limit; another under
   torch.profiler). Then a 5-step leg of each other
   optimizer (Momentum with Nesterov, LarsMomentum, Adagrad, Adamax,
   DecayedAdagrad, Adadelta, RMSProp centered with momentum, Ftrl, Adam)
   under one of the seven schedules each, every schedule at least once:
   the losses within 1e-5 relative of the CPU run, the rate fetched each
   step within 1e-6 relative and moving. Phase 3 holds #7 and #8
   against their plain versions at this phase's [4096, 10] and times
   them there.
11. predict (after phase 9): the deployment path. Transformer-base
   (MODEL, vocab 30000) built by build_program(seq_len, with_optimizer=
   False, dropout_rate=0.1), cloned for test, seeded weights, saved by
   save_inference_model(dir, [src_ids, tgt_ids], [the logits.w mul's
   output]) and loaded by create_paddle_predictor(AnalysisConfig(dir))
   on the card: the op count before and after the IR passes (no dropout
   left, each FFN's mul + add (+ relu) an fc). At seq 512 / batch 8
   (#1, #5) and seq 1024 / batch 4 (#1, #2), fp32 with TF32 off: the
   launches as predicted; 2 rows against the CPU predictor
   (disable_gpu()) on the same directory within PREDICT_TOL of the
   largest |CPU logit|, the argmax equal except at ties under that top-2
   margin, the same with TF32 on failing; switch_ir_optim(False) within
   the same bound; zero_copy_run and clone() the same bits as run (the
   clone's params the same tensors); Executor.close() drops the prepared
   programs and the next run prepares again. bf16 (enable_tpu_bf16) at
   both lengths: every float tensor of the predictor's scope bf16, #1,
   #5 and #2 launched in bf16 (their bf16 counters), the logits fp32
   within PREDICT_BF16 of the largest |fp32 card logit|, the argmax
   equal wherever the fp32 top-2 margin exceeds it. Then
   InferenceServer(predictor, max_batch_size=8, max_wait_ms=2.0) at seq
   512, 32 threaded batch-1 submits: each reply within PREDICT_TOL of
   the largest |logit| of predictor.run on the same rows, fewer batches
   than requests, a clean close; requests/s and p50 latency beside the
   naive per-request predictor.run loop's requests/s.

12. radix and beam (after phase 9): phase 9's bundle (it builds the
   ("radix", A) serves, the COW and the probe programs) and seeded
   weights, the word embeddings scaled by RADIX_EMB_SCALE and the
   decoder's branch outputs by RADIX_BRANCH_SCALE (as seeded, the
   decode emits one token over and over), and end_id's logit column
   given a constant bias so that turns end (the last decoder layer's
   output LayerNorm holds its first feature at 1: scale 0, shift 1;
   logits.w row 0 takes RADIX_EOS_BIAS in end_id's column). Prompts
   and extension tokens from RADIX_PROMPT_SEED, the rows fixed up front
   (radix_scan.py's scan on the card chose them); the phase asserts
   that each session's turn-1 decode stops on end_id after at least 16
   tokens (one full block shared) and that each turn leaves room for
   the next extension. (a) 8 chat sessions x 3 turns (turns 2 and 3
   each add 4 extend_tokens) on PagedContinuousGenerationServer with
   radix_reuse and again on a fresh one without: every turn's tokens
   and histories equal, 16 radix admissions on each, every reuse
   admission sharing >= 1 block and none on the other; after
   close_session and an evict of the whole tree the pool and the prompt
   entries drain; turn-2 and turn-3 p50 latency and requests/s of
   both. (b) the 8 prompts sent plain twice: the second submit admits
   through the radix tier (8 plain radix admissions), both equal to
   turn 1. (c) n_best=4 on 2 prompts: identical replies on one prompt
   entry. (d) PagedBeamDecoder, beam 4 on 2 prompts on the card, the
   first of them then on the CPU (plain versions; the second's CPU
   decode was cut for time): scores within 1e-4, hypotheses
   equal except candidates whose score lies within that bound of the
   other side's last (printed); >= 1 COW block; the pool free after
   each decode; beam 1 equals the server's greedy tokens with 0 COW;
   ms a decode. Kernel #9 launches n_layers times a device tick on
   every leg (the device's tick counter).
13. chunked and sampled (after phase 12): Transformer-base with phase
   9's seeded weights. Chunked leg (CHUNK: prompts of 2048 tokens in
   chunks of 1024, 8 lanes, 4 prompt entries, 64 tokens out): one
   prompt walked through every ("chunked", p) phase at every chunk
   cursor into one entry and admitted monolithically into another, the
   cross-KV rows held within ATTN_TOL (how many values differ is
   logged); then 8 requests over 4 distinct prompts in CHUNK_ORDER
   through a chunked PagedContinuousGenerationServer, the same bundle's
   monolithic server (chunked_prefill=False), a server fed by a
   DisaggregatedPrefillWorker (its own scope and executor on the same
   card, its own thread): the tokens equal on every leg, the chunk dispatches
   exactly jobs x n_chunks x phases on the host and on the device's
   tel_chunks, #2 launched 6 a chunk cursor of the attention phases,
   #9 n_layers a decode tick, the pool drained; 2 prompts against the
   CPU whole-loop decode under phase 4's tie rule. Sampled leg: phase
   9's bundle with SAMPLED (base_seed SEED) on 4 of phase 9's shared
   prompts with SAMPLED_SEEDS, the same wave reversed at
   SAMPLED_STEPS_B a burst, under the tie rule on the card's top-2
   margin of g + log p at the diverging draw (the CPU server's wave and
   the chunked leg's profiled rerun were cut for time);
   the least such margin over the wave's draws; a temperature-0 bundle
   equal to phase 9's greedy rows. Walls, idle shares and launches of
   every leg.
14. speculative (after phase 13): Transformer-base with phase 12's
   weights and a draft of SPEC_DRAFT (d 256, 4 heads, 2 layers, d_inner
   1024, params seeded under draft_) over phase 9's paged geometry at
   128 tokens out; 16 requests (phase 12's session rows and
   SPEC_EXTRA_ROWS). Bundles: plain, the model draft's ladder (k 3 of
   (0, 3, 4)), the n-gram proposer (k 2 of (0, 2)) and the model draft
   at k 3 with SAMPLED. Legs: the plain wave; the ladder pinned at k 0
   (the plain rows bit for bit, #9 n_layers a tick, the draft keepalive
   writes its cache); pinned at 3 and at 4 with the raw draft;
   distill_draft (4 rounds of batch 8, 4 inner steps, the plain server
   the teacher: the loss falls, the target's params keep their bytes,
   #7 and #8 once a replayed step in the last round's trace); pinned at
   3 and the automatic controller after it; the n-gram bundle under its
   controller (no draft step); sampled speculation on 2 prompts against
   the CPU server of the same bundle, and reversed at SAMPLED_STEPS_B a
   burst; 2 rows of the distilled k 3 wave against the CPU whole loop.
   Rows equal the plain wave's or the CPU's under phase 4's tie rule
   (sampled: the card's least margin at the diverging draw or
   acceptance test); every divergence printed. Walls, tokens/s, idle
   shares (each wave under torch.profiler), acceptance, emitted a
   verify and the rungs' dispatch shares of every leg.
15. front door (after phase 11): Transformer-base on phase 9's
   geometry. Streamed: 16 streamed submits on the paged server (7 of
   phase 12's session rows twice, a chat session's two turns; phase 12's
   weights) and 12 on the dense one (8 streams, 4 stream_cb), each
   stream equal to its whole-response row's generated region, each row
   to a whole-response wave's on a fresh server, no PreparedProgram
   built; the streamed TTFT p50 beside the whole response's latency p50;
   a stream cancelled after its first burst and one past its deadline
   (phase 9's weights: typed errors, the pool back where it started,
   both flight-recorder incidents); 4 streams of the n-gram speculative
   bundle. admit_select: 8 prompts of different lengths admitted longest
   first, the FIFO server's rows. Buckets: InferenceServer over a
   Transformer-base encoder forward fed [-1, -1] ids and positions,
   seq_buckets (512, 1024), batch buckets (1, 2, 4): aot_warmup builds
   6, 32 requests of 300-1024 tokens build none, two replies within 1e-5
   of the largest |CPU value| at their bucket, a select_group hook's
   longer bucket first (#5 and #2). Observability: the same dense wave
   (8 prompts, 32 tokens out) at off, metrics and trace, interleaved, 5
   each, under torch.profiler: median walls and idle shares;
   expected_service_ms set after the first metrics wave; the calibrated
   bursts' expected and actual tick times; dump_trace's chrome JSON, one
   span tree a request; expose() lists every live server's families,
   the speculative ones too.
16. whole loop and conv (after phase 15): the greedy whole-loop decode
   program (build_greedy_decode_program) at phase 4's configuration,
   weights and prompts, 512 (#5) and 1024 (#2): tokens equal phase 4's
   incremental card rows under phase 4's tie rule, #1 2L + 3L a loop
   step; its wall and idle share. The beam whole loop
   (build_beam_decode_program, beam RADIX_BEAM) at phase 12's weights
   and geometry (prompts of 256, 256 out) on RADIX_BEAM_ROWS in one
   batch: each row's hypotheses phase 12's PagedBeamDecoder's, scores
   within RADIX_BEAM_TOL (near ties at the cut printed); one row at
   phase 4's geometry (#5) against the CPU. The MNIST conv net at batch
   4096 under SGD (conv2d and pool2d through cuDNN, deterministic, TF32
   off): step 1 on 2 rows against the CPU (loss and grads within 1e-5
   norm-wise), two fresh runs of 2 steps the same bits, 20 eager steps
   (#7 and #8 once a step; the loss falls) and run_steps (one capture),
   the eager and captured step times and the convolutions' share of a
   profiled step; GradientMergeOptimizer(k 4) over micro-batches of
   1024 against one SGD step on the 4096 batch within 1e-5, eager and
   through run_steps (one capture); EMA and ModelAverage against numpy.

The script prints its whole wall time; the second-to-last line lists
the kernels as JSON, each with its launches on the serving (`served`),
training (`trained`, phases 5-8 together), MNIST training
(`trained_mnist`, phase 10's eager SGD leg), paged serving
(`served_paged`, phase 9), radix serving (`served_radix`, phase 12's
session, plain-reuse and n_best legs), beam decoding (`served_beam`,
phase 12's card decodes), chunked prefill (`served_chunked`, phase 13's
chunked, monolithic and worker-fed legs), sampled emission
(`served_sampled`, phase 13's sampled waves), speculative serving
(`served_spec`, phase 14's card waves), draft distillation
(`trained_distill`, phase 14's distillation leg, its teacher's decodes
included) and predictor
(`served_predictor`, phase 11's
timed runs and served requests; `served_predictor_bf16`: the bf16
launches among them), front-door (`served_frontdoor`, phase 15),
whole-loop greedy and beam (`served_whole_greedy`, `served_whole_beam`,
phase 16's first run of each program) and conv MNIST (`trained_conv`,
phase 16's eager steps) paths; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits 2 and prints no result.
"""
import contextlib
import ctypes
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch as pf  # noqa: E402
from paddle_tpu_torch import amp, inference, unique_name  # noqa: E402
from paddle_tpu_torch.core import registry  # noqa: E402
from paddle_tpu_torch.core.executor import RNG_VAR  # noqa: E402
from paddle_tpu_torch.inference import serving  # noqa: E402
from paddle_tpu_torch.models import decode_engine  # noqa: E402
from paddle_tpu_torch.models import mnist  # noqa: E402
from paddle_tpu_torch.models import transformer  # noqa: E402
from paddle_tpu_torch.ops.kernels import attention as KA  # noqa: E402
from paddle_tpu_torch.ops.kernels import attention_block as KAB  # noqa: E402
from paddle_tpu_torch.ops.kernels import bf16_planes as KBP  # noqa: E402
from paddle_tpu_torch.ops.kernels import build  # noqa: E402
from paddle_tpu_torch.ops.kernels import ffn_block as KFF  # noqa: E402
from paddle_tpu_torch.ops.kernels import layer_norm as KL  # noqa: E402
from paddle_tpu_torch.ops.kernels import paged_attention as KPA  # noqa: E402
from paddle_tpu_torch.ops.kernels import xent as KX  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12      # TF32 on the tensor cores, dense
BF16_FLOP_PER_S = 989e12      # bf16 on the tensor cores, dense
LN_TOL = 1e-5                 # fp32, summation order
ATTN_TOL = 2e-5               # fp32, summation order over T keys
P_TOL = 1e-6                  # saved P (values <= 1): fp32 rounding
LSE_TOL = 1e-5                # lse (~|s| + log T): fp32, summation order
# the attention backward kernels against their plain versions on the same
# inputs, max |got - plain| over the largest |plain| of each grad: fp32
# sums over up to 1024 keys or queries in another order, about sqrt(n)
# roundings of the largest term (~2e-6 of it); planted faults (lse off by
# 1e-3, P off by 1e-3 relative, delta dropped) read 1e-3 of it or more
ATTN_BWD_RTOL = 1e-5
# fp32 through 12 layers, CPU vs card summation order: the sound runs
# read at most 7.9e-7; the same step with TF32 on must read above this
LOGITS_TOL = 1e-5
SEED = 2026
# the bf16 attention kernels against their plain versions on the same
# bf16 inputs: both compute in fp32 and round once, so at most one bf16
# ulp of the largest |plain| apart (`_bf16_ulps`: 2^-8 to 2^-7 of it), in
# the few elements whose fp32 values straddle a rounding boundary; an
# fp32 intermediate fed to a product as one bf16 term (dS in #6, P in
# #4's dv) moves a large share of them
BF16_SHARE = 0.05
# the bf16 training legs' step-1 parity, card against the CPU under AMP
# on 2 rows: the first encoder and decoder attention outputs (bf16) in at
# most 5% of the elements, as the kernels' gate, and within 2^-6 of the
# largest |CPU| (their q, k and v already carry the few 1-ulp flips of
# the products before them, which move an output by more than one
# rounding: 4.76e-3 read at seq 256); the same step with AMP off (fp32
# outputs, every element other) fails it
AMP_ACT_REL = 2 ** -6
AMP_ACT_SHARE = 0.05
# (seq_len, batch) of the bf16 legs: the bench's own (bench.py:211-233,
# seq 256 at batch 128), then #5/#6 and #2-#4 in bf16
BF16_RUNS = ((256, 128), (512, 32), (1024, 16))
DROPOUT_RATE = 0.1            # Transformer-base's
# the recompute leg: Adam's weight decay (L2Decay's coefficient), and its
# global-norm clip, set at run time to this share of the smaller step-1
# global gradient norm that the card reads (2 rows and the full batch),
# so that the clip scales in the parity step and in the main path
RECOMPUTE_L2 = 1e-4
CLIP_BELOW = 0.5

MODEL = dict(d_model=512, n_heads=8, n_layers=6, d_inner=2048,
             vocab=30000, max_out_len=32, start_id=0, end_id=1)
BATCH = 8
# phase 11, the predictor: (seq_len, batch) of its legs (#5 at 512, #2
# at 1024), the rows its CPU reference runs, the threaded batch-1
# requests of its served leg. fp32 logits against the CPU predictor:
# phase 4's serving gate, relative to the largest |CPU logit|; bf16
# logits (bf16 weights and activations through 12 layers: each product
# rounds its inputs to 2^-9 relative) against the fp32 card logits
PREDICT_RUNS = ((512, 8), (1024, 4))
PREDICT_CPU_ROWS = 2
PREDICT_REQUESTS = 32
PREDICT_TOL = 1e-5
PREDICT_BF16 = 2.0 ** -4
PREDICT_ROWS = 4096           # tokens of a predictor batch: #1's rows
# the repo's training configuration (bench.py bench_transformer) in
# fp32 at half its batch: fp32 activations take twice bf16's bytes
TRAIN = dict(vocab=32000, d_model=512, n_heads=8, n_layers=6,
             d_inner=2048, dropout_rate=0.0, learning_rate=2.0,
             warmup_steps=8000)
# (seq_len, batch): 16384 target tokens a step at each length. 256 takes
# the plain attention composition, 512 sdpa_short (all 18 attention ops:
# tq == tk), 1024 flash
TRAIN_RUNS = ((256, 64), (512, 32), (1024, 16))
# bench.py:218's batch at seq 256, in fp32: it fits once the Executor
# frees each intermediate after its last reader (30.57 GiB eager)
BENCH_BATCH = 128
TRAIN_TOKENS = 16384
TRAIN_STEPS = 5
LABEL_SMOOTH = 0.1            # transformer()'s default
XENT_TOL = 1e-5               # fp32 sums over V in another order
# xent dx element by element, |dx - plain| <= atol + rtol |plain|
# (rtol, atol), since most |dx| at V = 32000 are ~1e-6 or below. fp32:
# the two lse differ by ~1e-6 relative, and atol covers p - eps/V
# cancelling; bf16: two roundings of a value may fall an ulp (at most
# 2^-7 relative) apart
DX_TOL = {torch.float32: (1e-4, 1e-9), torch.bfloat16: (2 ** -7, 1e-9)}
# planted faults the dx check must reject: the lse shifted by this
DX_LSE_SHIFT = {torch.float32: 1e-3, torch.bfloat16: 0.05}
# the xent backward's cluster sizes (CTAs a row), each timed at the
# training shape in fp32 and bf16
XENT_CLUSTERS = (1, 2, 4, 8)
# the xent forward's plans timed against each other at these widths (its
# crossovers, csrc/xent.cu `fwd_lanes`), and its block a row at these
# 16-byte loads in flight a thread, at the training shape
XENT_PLAN_WIDTHS = (10, 32, 100, 1000, 4096, 8192, 32000)
XENT_UNROLLS = (1, 2, 4, 8)
# card vs CPU, fp32 through 12 layers: the loss relative, the grads
# and Adam's first moment norm-wise (|a-b|/|b|). logits.w's grad lies
# above every ReLU and agrees to ~1e-6. The others lie below the FFN
# ReLUs, where a pre-activation within rounding of zero flips its mask
# between any two fp32 runs: one flip among the 1M units of a layer
# moves these grads by ~1e-4. So they are held to TRAIN_GRADS against
# the CPU run as it is, and to PINNED_GRADS against the CPU run with
# its ReLU masks pinned to the card's: there sound runs read at most
# 1.4e-6 and the TF32 control 8e-4 or more.
LOSS_RTOL = 1e-5
# the run_steps legs (K steps through a captured CUDA graph) against the
# eager legs' losses: the JAX package's own run_steps pin
# (tests/test_run_steps.py); the embedding grads sum by atomics, so the
# bits may differ
STEPS_RTOL = 1e-6
TRAIN_GRADS = {"logits.w": 1e-5, "src_word_emb": 1e-3,
               "tgt_word_emb": 1e-3, "enc0_a_ln.w": 1e-3,
               "dec0_a_ln.w": 1e-3}
PINNED_GRADS = dict.fromkeys(TRAIN_GRADS, 1e-5)
# phase 8, the fused-block path (PADDLE_TPU_FUSE_ATTN_BLOCK=1, read when
# the program is built): card vs CPU norm-wise. logits.w and the grads of
# the last decoder layer's FFN output and add-norm lie above every FFN
# ReLU (1e-5); the others below them, where a unit within rounding of
# zero flips between two fp32 runs and moves them by ~1e-4 (phase 5's
# unpinned limit, 1e-3). The ReLU
# masks live inside the ffn_block kernels, so nothing is pinned here: the
# phase reports the units whose pre-activation, recomputed in float64
# from each run's fetched ffn_block input, has another sign on the card
# than on the CPU.
FUSE_KNOB = "PADDLE_TPU_FUSE_ATTN_BLOCK"
FUSED_GRADS = {"logits.w": 1e-5, "dec5_c_ln.w": 1e-5, "dec5_fc2.w": 1e-5,
               "dec5_fc2.b": 1e-5, "dec5_fc1.w": 1e-3,
               "dec5_self_qkv.w": 1e-3, "dec0_self_out.w": 1e-3,
               "enc0_self_qkv.w": 1e-3, "enc0_fc1.b": 1e-3,
               "src_word_emb": 1e-3, "tgt_word_emb": 1e-3}
# the fused-block kernels against their plain versions: each output and
# grad, max |got - plain| over its largest |plain| (the products sum over
# up to B*T = 16384 rows in another order); planted faults must exceed it
FUSED_RTOL = 1e-5
# phase 9, the paged serving path: Transformer-base (MODEL) through
# build_decode_step_program with the paged cache, 16 lanes; 32 requests
# of 256-token prompts, 8 shared prompts sent 3 times each and 8 unique
# ones (bench.py bench_paged's shared-prefix shape at full width)
PAGED = dict(seq_len=256, max_out_len=256, n_slots=16, block_size=16,
             n_blocks=256, n_prompt_entries=16, steps_per_tick=8)
PAGED_SHARED, PAGED_REPEATS, PAGED_UNIQUE = 8, 3, 8
PAGED_CPU_ROWS = 4   # distinct prompts held against the CPU whole loop
# phase 12, the radix tier and the beam decoder on phase 9's bundle and
# seeded weights, changed in three places. As seeded, the decode barely
# depends on its input: the decoder's attention and FFN branches,
# averaged over 256 prompt and history positions, swamp a token's
# embedding, and the card emits one token over and over (end_id's logit
# margin moved by ~3e-3 across prompts and steps). So the word
# embeddings are scaled by RADIX_EMB_SCALE and the decoder's branch
# outputs (self_out, cross_out, fc2) by RADIX_BRANCH_SCALE: each step's
# token then follows from the last token, the position, the history and
# the prompt. And end_id's output column gets a constant bias so that
# turns end: the last decoder layer's output LayerNorm holds its first
# feature at 1 (scale 0, shift 1) and logits.w row 0 takes
# RADIX_EOS_BIAS in end_id's column (its seeded values elsewhere).
# Prompts of 256 tokens from RADIX_PROMPT_SEED; the rows below were
# fixed once, from radix_scan.py's scan of the candidates on the card,
# and the phase asserts what it needs of them before relying on it
RADIX_EMB_SCALE = 6.0
RADIX_BRANCH_SCALE = 0.2
RADIX_EOS_BIAS = 0.55
RADIX_PROMPT_SEED = SEED + 12
RADIX_CANDIDATES = 48
RADIX_SESSION_ROWS = (7, 9, 11, 14, 16, 22, 23, 32)
RADIX_TURNS = 3                # turn 1 the prompt, then two extensions
RADIX_EXTEND = 4               # extend_tokens of turns 2 and 3
RADIX_MIN_TURN1 = 16           # tokens before end_id: one full block
RADIX_NBEST = 4
RADIX_NBEST_ROWS = (1, 4)
RADIX_BEAM = 4
RADIX_BEAM_ROWS = (19, 24)
RADIX_BEAM_CPU_ROWS = 1   # of them decoded again on the CPU
# beam scores (sums of up to 255 fp32 log-probs) card against CPU: the
# JAX package's own beam pin (tests/test_radix_reuse.py:223)
RADIX_BEAM_TOL = 1e-4
# phase 13, chunked prefill and sampled emission on Transformer-base
# (MODEL) and phase 9's paged geometry. The chunked leg: prompts of 2048
# tokens streamed in chunks of 1024 (2 chunks a phase, 2L + 2 = 14
# phases; 2048 is suggest_chunk_tokens's worked example), 4 prompt
# entries, 64 tokens out so the decode stays short; four distinct
# prompts in tests/test_chunked_prefill.py's mixed miss/hit order
CHUNK = dict(seq_len=2048, max_out_len=64, n_slots=8, block_size=16,
             n_blocks=64, n_prompt_entries=4, chunk_tokens=1024,
             steps_per_tick=8)
CHUNK_ORDER = (0, 1, 0, 2, 1, 3, 2, 0)
CHUNK_CPU_ROWS = 2   # prompts held against the CPU whole-loop decode
# the sampled leg: phase 9's bundle with this sampling policy (base_seed
# SEED), four of phase 9's shared prompts with these seeds (none 0: a
# lane that was never admitted holds seed 0), served again in reverse
# order at SAMPLED_STEPS_B a burst
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)
SAMPLED_SEEDS = (7, 2 ** 31 + 5, 2 ** 32 - 1, 123456789)
SAMPLED_STEPS_B = 3
# phase 14, speculative decoding on Transformer-base (MODEL) with phase
# 12's weights and phase 9's paged geometry, 128 tokens out. The draft: a
# quarter of the target's width and a third of its depth (head dim 64),
# params seeded under draft_; the ladder and its default k; the n-gram
# proposer of bench.py; 16 prompts (phase 12's 8 session rows and 8 more
# candidates); distillation rounds at batch 8 with 4 inner steps
SPEC_MAX_OUT = 128
SPEC_DRAFT = dict(d_model=256, n_heads=4, n_layers=2, d_inner=1024)
SPEC_K = 3
SPEC_LADDER = (0, 3, 4)
SPEC_NGRAM = dict(k=2, kind="ngram", ngram=2, k_options=(0, 2))
SPEC_EXTRA_ROWS = (0, 1, 2, 3, 4, 5, 6, 8)
SPEC_DISTILL = dict(rounds=4, batch=8, inner_steps=4, learning_rate=0.005)
SPEC_SAMPLED_ROWS = 2  # prompts of the sampled leg, against the CPU
SPEC_BURST = 2         # ticks of a leg's profiled burst (its idle share)
SPEC_CPU_ROWS = 2      # prompts of the k = 3 leg against the CPU
# #1 (layer_norm) in phase 3: the shapes the main path runs it at (a
# census of a whole run's launches by phase and shape, recorded in
# PERF.md), each held against the plain version on every plan and timed,
# and bf16 at 32768 rows, whose 67 MB do not fit the 50 MB L2 (its share
# of the HBM bound). Bulk rows (rows, D, dtype):
# a turn's or a draft's prompt and the 2-row parity steps (256-2048), the
# encoder at prompt 512 and 1024 (4096, 8192; phase 4), a training step's
# 16384 target tokens and the batch-128 legs' 32768 (phases 5-8), the
# predictor's rows in bf16 (4096; phase 11) and bf16 at 8192, the draft's
# prompts at its d 256 (phase 14), the ragged D 300. Decoder-step rows
# (rows, D; fp32): GenerationServer's batch (8), a tick's lanes and the
# dustbin lane (9 in phase 13, 17 in phases 9 and 12-14), the verify's
# k + 1 positions a lane at k = 2, 3, 4 (51, 68, 85), the draft's steps
LN_BULK = tuple((n, 512, torch.float32)
                for n in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)) \
    + ((PREDICT_ROWS, 512, torch.bfloat16),
       (BATCH * 1024, 512, torch.bfloat16), (32768, 512, torch.bfloat16)) \
    + tuple((n, SPEC_DRAFT["d_model"], torch.float32)
            for n in (1024, 2048, 4096)) \
    + ((4096, 300, torch.float32), (4096, 300, torch.bfloat16))
_LANES = PAGED["n_slots"] + 1
LN_STEP = ((BATCH, 512), (CHUNK["n_slots"] + 1, 512), (_LANES, 512),
           (3 * _LANES, 512), ((SPEC_K + 1) * _LANES, 512),
           (5 * _LANES, 512), (_LANES, SPEC_DRAFT["d_model"]))
# the planted fault that leaves the ragged tail out of the statistics: at
# D 300 the last load a lane makes (columns 256-299) dropped
LN_TAIL_COLS = 256
# the grids, in CTAs an SM, at which the chosen warp plan is also timed
# at [8192, 512] (its own: KL.CTAS_PER_SM, its launch bound)
LN_GRIDS = (1, 4)
# the MNIST fc net (BASELINE.md config 1; models/mnist.py build_program
# with use_conv=False: 784-128-64-10) at bench.py bench_mnist's batch,
# 4096, on its synthetic separable batch (bench.py:375-377) as [784]
# images; SGD, MNIST_STEPS steps eager and through run_steps
MNIST_BATCH = 4096
MNIST_STEPS = 20
MNIST_LR = 0.1
# run_steps calls that replay only, each timed on the host's clock: the
# step time is their median
MNIST_TIMED_CALLS = 5
# the last fc's weight grad lies above every ReLU (1e-5 norm-wise); the
# others lie below them, where a unit within rounding of zero flips its
# mask between two fp32 runs (phase 5's unpinned 1e-3)
MNIST_GRADS = {"fc_2.w_0": 1e-5, "fc_2.b_0": 1e-5, "fc_1.w_0": 1e-3,
               "fc_0.w_0": 1e-3}
# a 5-step leg of each optimizer other than SGD, each under a schedule,
# so that every schedule runs once (Adadelta's op reads no rate: its leg
# repeats a schedule, whose rate is fetched all the same): losses against
# the CPU run within LOSS_RTOL, the rate within 1e-6 relative, and the
# rate other at some step than at step 1
MNIST_LEG_STEPS = 5
LR_RTOL = 1e-6
MNIST_LEGS = (
    ("Momentum", dict(momentum=0.9, use_nesterov=True),
     "exponential_decay", (0.1, 2, 0.5, True)),
    ("LarsMomentum", dict(momentum=0.9, lars_coeff=0.01),
     "natural_exp_decay", (1.0, 2, 0.5)),
    ("Adagrad", {}, "inverse_time_decay", (0.01, 2, 0.5)),
    ("Adamax", {}, "polynomial_decay", (0.01, 2, 1e-4, 1.5, True)),
    ("DecayedAdagrad", {}, "piecewise_decay", ([2, 4],
                                               [0.004, 0.002, 0.001])),
    ("Adadelta", dict(rho=0.9), "piecewise_decay", ([3], [1.0, 0.5])),
    ("RMSProp", dict(momentum=0.5, centered=True), "cosine_decay",
     (0.001, 1, 8)),
    ("Ftrl", dict(l1=1e-4, l2=1e-3), "linear_lr_warmup",
     (0.01, 3, 0.001, 0.01)),
    ("Adam", {}, "exponential_decay", (0.002, 3, 0.5)),
)
# the training program's kernels, whose launches every training phase
# counts
TRAIN_KERNELS = (KX.xent_forward, KX.xent_backward, KL.layer_norm,
                 KA.sdpa_short, KA.sdpa_short_bwd, KA.flash_attention,
                 KA.flash_bwd_dq, KA.flash_bwd_dkv, KAB.attention_block,
                 KAB.attention_block_bwd, KFF.ffn_block, KFF.ffn_block_bwd)

_CSRC = "paddle_tpu_torch/ops/kernels/csrc/"
_PALLAS = "paddle_tpu/ops/pallas/"
# each kernel of the line before the last: its source and the TPU kernel
# it replaces
KERNEL_META = {
    "layer_norm": (_CSRC + "layer_norm.cu", _PALLAS + "layer_norm.py:64"),
    "sdpa_short": (_CSRC + "sdpa_short.cu", _PALLAS + "attention.py:429"),
    "flash_attention": (_CSRC + "flash_attention.cu",
                        _PALLAS + "attention.py:104"),
    "xent_forward": (_CSRC + "xent.cu", _PALLAS + "xent.py:75"),
    "xent_backward": (_CSRC + "xent.cu", _PALLAS + "xent.py:123"),
    "sdpa_short_bwd": (_CSRC + "sdpa_short_bwd.cu",
                       _PALLAS + "attention.py:471"),
    "flash_bwd_dq": (_CSRC + "flash_attention_bwd.cu",
                     _PALLAS + "attention.py:197"),
    "flash_bwd_dkv": (_CSRC + "flash_attention_bwd.cu",
                      _PALLAS + "attention.py:216"),
    "attention_block": (_CSRC + "attention_block.cu",
                        _PALLAS + "attention_block.py:163"),
    "attention_block_bwd": (_CSRC + "attention_block.cu",
                            _PALLAS + "attention_block.py:228"),
    "ffn_block": (_CSRC + "ffn_block.cu", _PALLAS + "ffn_block.py:108"),
    "ffn_block_bwd": (_CSRC + "ffn_block.cu", _PALLAS + "ffn_block.py:157"),
    "paged_decode_attention": (_CSRC + "paged_attention.cu",
                               _PALLAS + "paged_attention.py:81"),
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device ms per call over `iters` back-to-back calls, CUDA
    events. A sleep kernel queued first keeps the card busy while the
    host enqueues every call, so a short kernel is timed on the device
    and not at the rate the Python wrapper can issue it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of GPU clock cycles
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def time_cold_ms(fn, iters=50, clean=False):
    """Mean device ms of one call with a cold L2: before each call a
    128 MB write evicts the 50 MB L2 (`clean`: then a read of the same
    128 MB, so that no dirty line's write-back competes with the call's
    reads) and a sleep kernel covers the host's enqueue; CUDA events
    bracket the call alone, so each time includes one launch's latency
    on the device."""
    flush = torch.empty(32 * 2 ** 20, device="cuda")
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        flush.fill_(1.0)
        if clean:
            flush.amax()
        torch.cuda._sleep(200_000)  # ~0.1 ms of GPU clock cycles
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


def bound_ms(nbytes, flops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    pf.Executor(pf.CUDAPlace(0))  # the port's device context
    log(f"device: {name} x{count}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)
    mm = torch.backends.cuda.matmul
    bf16_red = mm.allow_bf16_reduced_precision_reduction
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}; bf16 reduced-precision "
        f"reductions {bf16_red}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not bf16_red
    return name, count, card


def phase_build():
    t0 = time.monotonic()
    for name in build.SOURCES:
        build.library(name)
    log(f"build: {time.monotonic() - t0:.2f} s wall; per source "
        + ", ".join(f"{n} {build.BUILD_SECONDS[n]:.2f} s"
                    for n in build.SOURCES))
    for name in build.SOURCES:
        for line in build.PTXAS_LOG.get(name, "").splitlines():
            if "Compiling entry function" in line:
                log(f"  ptxas {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
def _ln_inputs(n, d, dtype, seed, offset=0):
    """x [n, d] of `dtype` starting `offset` elements into its storage,
    scale and bias [d], seeded."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    flat = torch.randn(offset + n * d, device="cuda", generator=g) * 3 + 0.5
    x = flat.to(dtype)[offset:].view(n, d)
    s = torch.randn(d, device="cuda", generator=g).to(dtype)
    b = torch.randn(d, device="cuda", generator=g).to(dtype)
    return x, s, b


def _ln_case(n, d, seed):
    """#1 once through the wrapper on fp32 [n, d]: (x, scale, bias, the
    largest |kernel - plain| over y, mean and var)."""
    x, s, b = _ln_inputs(n, d, torch.float32, seed)
    got = KL.layer_norm(x, s, b, 1e-5)
    torch.cuda.synchronize()
    want = KL.layer_norm_plain(x, s, b, 1e-5)
    return x, s, b, max(max_err(g_, w_) for g_, w_ in zip(got, want))


def _ln_fault(x, scale, bias, eps, fault):
    """The plain version with a planted fault: "var" the variance as
    mean(x^2), the mean not subtracted; "tail" the statistics from the
    first LN_TAIL_COLS columns only."""
    x32 = x.float()
    part = x32[:, :LN_TAIL_COLS] if fault == "tail" else x32
    mean = part.mean(dim=1, keepdim=True)
    sq = part.square() if fault == "var" else (part - mean).square()
    var = sq.mean(dim=1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()[None] + bias.float()[None]
    return y.to(x.dtype), mean.reshape(-1), var.reshape(-1)


def _ln_gate(got, want):
    """#1's gate: (passes, measures). fp32: y, mean and var within LN_TOL
    of the plain version; bf16: y within one bf16 ulp of the largest
    |plain| in at most BF16_SHARE of the elements, mean and var (fp32)
    within LN_TOL."""
    (y, mean, var), (wy, wmean, wvar) = got, want
    stat = max(max_err(mean, wmean), max_err(var, wvar))
    finite = bool(torch.isfinite(y.float()).all())
    if y.dtype == torch.bfloat16:
        ulps, share = _bf16_ulps(y, wy)
        return (finite and _bf16_ulp_ok(y, wy) and stat <= LN_TOL,
                dict(ulps=ulps, share=share, stat_err=stat,
                     max_abs_err=max_err(y, wy)))
    err = max(max_err(y, wy), stat)
    return finite and err <= LN_TOL, dict(max_abs_err=err)


def _ln_plan_name(p):
    if p.body == "block":
        return "block"
    return f"warp {p.vec_bytes}B x{p.loads} grid {p.grid}"


def _ln_plans(x, s, b):
    """The wrapper's plan for x (y on a fresh, aligned allocation) and
    the plans to hold and time beside it: the warp body and the block
    body (a block a row, the design the warp body replaced)."""
    n, d = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = KL.ln_plan(n, d, x.dtype, (x.data_ptr(), 0, s.data_ptr(),
                                        b.data_ptr()), sms)
    return chosen, {"warp": chosen,
                    "block": KL.LnPlan("block", x.element_size(), 0, n)}


def _ln_empty_ms(blocks):
    """An empty kernel's launch of `blocks` CTAs of 256 threads, timed as
    the kernels are (back to back behind a sleep kernel)."""
    fn = build.library("layer_norm").layer_norm_empty
    fn.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        err = fn(blocks, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"layer_norm_empty: CUDA error {err}"
    return time_ms(run, iters=50)


def _ln_shape(n, d, dtype, step):
    """#1 at [n, d] of `dtype`: every plan held against the plain version
    (the gate, a second launch the same bits), the wrapper's launch
    counted once; each plan, F.layer_norm and the plain version timed
    warm, the plans and the library also cold (`time_cold_ms`); at a
    decoder step (`step`) an empty launch of the plan's grid beside
    them. The bound: bytes (x and y, scale and bias, mean and var) /
    3.35 TB/s against 8 fp32 operations an element / 67 TFLOP/s."""
    x, s, b = _ln_inputs(n, d, dtype, seed=n + d + (dtype == torch.bfloat16))
    want = KL.layer_norm_plain(x, s, b, 1e-5)
    chosen, plans = _ln_plans(x, s, b)
    before = KL.layer_norm.launches
    got = KL.layer_norm(x, s, b, 1e-5)
    torch.cuda.synchronize()
    assert KL.layer_norm.launches == before + 1
    ok, gate = _ln_gate(got, want)
    tag = f"layer_norm {str(dtype)[6:]} [{n},{d}]"
    log(f"  {tag}: the wrapper's plan {_ln_plan_name(chosen)}; "
        + ", ".join(f"{k} {v:.3e}" for k, v in gate.items()))
    assert ok, (tag, gate)
    times = {}
    for name, plan in plans.items():
        one = KL.layer_norm_with(x, s, b, 1e-5, plan)
        two = KL.layer_norm_with(x, s, b, 1e-5, plan)
        torch.cuda.synchronize()
        p_ok, p_gate = _ln_gate(one, want)
        assert p_ok, (tag, name, p_gate)
        assert all(torch.equal(u, v) for u, v in zip(one, two)), \
            f"{tag} {name}: a second launch gave other bits"
        run = functools.partial(KL.layer_norm_with, x, s, b, 1e-5, plan)
        times[name] = dict(ms=time_ms(run, iters=50),
                           cold_ms=time_cold_ms(run))
    lib = functools.partial(torch.nn.functional.layer_norm, x, (d,), s, b,
                            1e-5)
    res = dict(shape=[n, d], dtype=str(dtype)[6:], plan=_ln_plan_name(chosen),
               plans=times, library_ms=time_ms(lib, iters=50),
               library_cold_ms=time_cold_ms(lib),
               plain_ms=time_ms(lambda: KL.layer_norm_plain(x, s, b, 1e-5),
                                iters=20), **gate)
    res["ms"] = times["warp"]["ms"]
    res["cold_ms"] = times["warp"]["cold_ms"]
    item = x.element_size()
    res["bound_ms"], res["bound_by"] = bound_ms(
        item * (2 * n * d + 2 * d) + 4 * 2 * n, 8 * n * d)
    if step:
        res["empty_ms"] = _ln_empty_ms(chosen.grid)
    log(f"  {tag}: " + ", ".join(
        f"{k} {v['ms']:.4f} ms (cold {v['cold_ms']:.4f})"
        for k, v in times.items())
        + f"; F.layer_norm {res['library_ms']:.4f} ms (cold "
        f"{res['library_cold_ms']:.4f}), plain {res['plain_ms']:.4f} ms, "
        f"bound {res['bound_ms']:.5f} ms ({res['bound_by']})"
        + (f", an empty launch of {chosen.grid} CTAs {res['empty_ms']:.4f}"
           " ms" if step else ""))
    return res, (x, s, b, chosen, want)


def _ln_faults(x, s, b, want, faults):
    """The planted faults must fail #1's gate; returns each one's
    measures."""
    out = {}
    for fault in faults:
        ok, gate = _ln_gate(_ln_fault(x, s, b, 1e-5, fault), want)
        log(f"  layer_norm {str(x.dtype)[6:]} {list(x.shape)} planted "
            f"fault '{fault}': " + ", ".join(
                f"{k} {v:.3e}" for k, v in gate.items()) + " (must fail)")
        assert not ok, f"the layer_norm gate passed the fault {fault}"
        out[fault] = gate
    return out


def _ln_views():
    """Row views off a 16-byte boundary take narrower loads and pass the
    gate: x[1:] of [4097, 300] bf16 (8-byte loads), [4096, 512] at element
    offsets 1 (bf16 2-byte, fp32 4-byte) and 2 (fp32 8-byte); on each a
    forced 16-byte plan is refused."""
    cases = (("x[1:] of [4097,300] bf16", 4097, 300, torch.bfloat16, 0, 8),
             ("[4096,512] bf16 at element 1", 4096, 512, torch.bfloat16, 1,
              2),
             ("[4096,512] fp32 at element 1", 4096, 512, torch.float32, 1,
              4),
             ("[4096,512] fp32 at element 2", 4096, 512, torch.float32, 2,
              8))
    out = {}
    for tag, n, d, dtype, offset, width in cases:
        x, s, b = _ln_inputs(n, d, dtype, seed=7 + offset, offset=offset)
        if offset == 0:
            x = x[1:]
        want = KL.layer_norm_plain(x, s, b, 1e-5)
        chosen, _ = _ln_plans(x, s, b)
        got = KL.layer_norm(x, s, b, 1e-5)
        torch.cuda.synchronize()
        ok, gate = _ln_gate(got, want)
        refused = False
        try:
            KL.layer_norm_with(x, s, b, 1e-5,
                               chosen._replace(vec_bytes=16))
        except RuntimeError:
            refused = True
        log(f"  layer_norm {tag}: plan {_ln_plan_name(chosen)}; "
            + ", ".join(f"{k} {v:.3e}" for k, v in gate.items())
            + f"; a 16-byte plan refused {refused}")
        assert ok and chosen.vec_bytes == width and refused, (tag, gate)
        out[tag] = dict(plan=_ln_plan_name(chosen), **gate)
    return out


def _ln_entry():
    """#1 at every shape of LN_BULK and LN_STEP, its planted faults, the
    row views and the grids; the kernels line's entry (fp32 [8192, 512],
    the decoder step [8, 512], bf16 [8192, 512] with the predictor's
    rows) and the whole table for the log."""
    table, fp32_errs, bf16_errs, fault_ulps = {}, [], [], []
    faults = {}
    for n, d, dtype in LN_BULK + tuple((n, d, torch.float32)
                                       for n, d in LN_STEP):
        step = (n, d) in LN_STEP
        res, (x, s, b, chosen, want) = _ln_shape(n, d, dtype, step)
        key = f"{str(dtype)[6:]} [{n},{d}]"
        table[key] = res
        (bf16_errs if dtype == torch.bfloat16 else fp32_errs).append(
            res["max_abs_err"])
        kinds = (("var",) if n == BATCH * 1024 else ()) + (
            ("tail",) if d == 300 else ())
        if kinds:
            faults[key] = _ln_faults(x, s, b, want, kinds)
            fault_ulps += [f["ulps"] for f in faults[key].values()
                           if "ulps" in f]
        if n == BATCH * 1024 and d == 512:
            for k in LN_GRIDS:
                plan = chosen._replace(grid=k * torch.cuda.get_device_properties(
                    0).multi_processor_count)
                one = KL.layer_norm_with(x, s, b, 1e-5, plan)
                torch.cuda.synchronize()
                assert _ln_gate(one, want)[0], (key, plan)
                run = functools.partial(KL.layer_norm_with, x, s, b, 1e-5,
                                        plan)
                res["plans"][f"{k} CTAs an SM"] = dict(
                    ms=time_ms(run, iters=50), cold_ms=time_cold_ms(run))
            log(f"  layer_norm {key}: the chosen plan at 1 / "
                f"{KL.CTAS_PER_SM} / 4 CTAs an SM: " + " / ".join(
                    f"{res['plans'][f'{k} CTAs an SM']['ms']:.4f}"
                    if k != KL.CTAS_PER_SM else f"{res['ms']:.4f}"
                    for k in sorted(LN_GRIDS + (KL.CTAS_PER_SM,))) + " ms")
        del x, s, b, want
    views = _ln_views()
    log(json.dumps({"layer_norm_plans": table, "faults": faults,
                    "views": views}))
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    main = table[f"float32 [{BATCH * 1024},512]"]
    bf16 = table[f"bfloat16 [{BATCH * 1024},512]"]
    pred = table[f"bfloat16 [{PREDICT_ROWS},512]"]
    return dict(max_abs_err=max(fp32_errs),
                **{k: main[k] for k in keep},
                decoder_step={k: table[f"float32 [{BATCH},512]"][k]
                              for k in keep},
                bf16=dict(max_abs_err=max(bf16_errs),
                          fault_ulps=min(fault_ulps),
                          ulps=bf16["ulps"], share=bf16["share"],
                          **{k: bf16[k] for k in keep},
                          predictor_rows=dict(
                              ulps=pred["ulps"], share=pred["share"],
                              **{k: pred[k] for k in keep})))


def _qkv(b, h, tq, tk, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, tq, d, device="cuda", generator=g)
    k = torch.randn(b, h, tk, d, device="cuda", generator=g)
    v = torch.randn(b, h, tk, d, device="cuda", generator=g)
    return q, k, v


def _lib_sdpa(q, k, v, scale, causal=False):
    """torch's fused SDPA with the math backend forbidden: the
    yardstick. The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.FLASH_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale, is_causal=causal)


def _tf32x3_ms(product_flops):
    """The split-TF32 bound: three TF32 products for each fp32 product,
    at 495 TFLOP/s."""
    return 3 * product_flops / TF32_FLOP_PER_S * 1e3


def _attn_entry(name, kern, plain, cases, main_shape, tf32=False):
    """`tf32`: the kernel computes on the tensor cores in split TF32; its
    timing line also gives the split-TF32 bound and TFLOP/s."""
    errs = []
    for (b, h, tq, tk, d, causal) in cases:
        q, k, v = _qkv(b, h, tq, tk, d, seed=tq + d + causal)
        got = kern(q, k, v, d ** -0.5, causal)
        want = plain(q, k, v, d ** -0.5, causal)
        torch.cuda.synchronize()
        err = max_err(got, want)
        finite = bool(torch.isfinite(got).all())
        log(f"  {name} [{b},{h},{tq},{tk},{d}] causal={causal}: "
            f"max_abs_err {err:.3e} (tol {ATTN_TOL:g}) finite {finite}")
        assert finite and err <= ATTN_TOL, (name, err)
        errs.append(err)
    b, h, t, d = main_shape
    q, k, v = _qkv(b, h, t, t, d, seed=1)
    scale = d ** -0.5
    ms = time_ms(lambda: kern(q, k, v, scale, False))
    plain_ms = time_ms(lambda: plain(q, k, v, scale, False))
    lib = _lib_sdpa(q, k, v, scale)
    torch.cuda.synchronize()
    log(f"  {name} library sdpa vs plain: max_abs_err "
        f"{max_err(lib, plain(q, k, v, scale, False)):.3e}")
    lib_ms = time_ms(lambda: _lib_sdpa(q, k, v, scale))
    nbytes = 4 * q.numel() * 4
    flops = b * h * t * t * (4 * d + 5)  # QK^T, PV, softmax
    bms, by = bound_ms(nbytes, flops)
    extra, note = {}, ""
    if tf32:
        products = 4 * b * h * t * t * d
        extra = dict(tf32x3_bound_ms=_tf32x3_ms(products),
                     tflops=products / ms / 1e9)
        note = (f"; split-TF32 bound {extra['tf32x3_bound_ms']:.4f} ms, "
                f"{extra['tflops']:.2f} TFLOP/s of fp32 products")
    log(f"  {name} {list(main_shape)} non-causal: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library sdpa {lib_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by}){note}")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                shape=list(main_shape), **extra)


def _flash_non_square_entry():
    """#2 at the chunked prefill's attention shape (phase 13): a chunk of
    1024 queries over the layer's 2048 keys, non-causal. Held against
    the plain version at ATTN_TOL; whether each query row's output has
    the same bits at tq 1024 as in the monolithic encoder's launch at
    tq = tk = 2048; timed behind the sleep kernel beside the plain
    version, the library's SDPA and the bound."""
    b, h = 1, MODEL["n_heads"]
    tq, tk = CHUNK["chunk_tokens"], CHUNK["seq_len"]
    d = MODEL["d_model"] // MODEL["n_heads"]
    scale = d ** -0.5
    q, k, v = _qkv(b, h, tk, tk, d, seed=tq + tk)
    qc = q[:, :, :tq].contiguous()
    qt = q[:, :, tq:].contiguous()
    got = KA.flash_attention(qc, k, v, scale, False)
    want = KA.flash_attention_plain(qc, k, v, scale, False)
    full = KA.flash_attention(q, k, v, scale, False)
    tail = KA.flash_attention(qt, k, v, scale, False)
    torch.cuda.synchronize()
    err = max_err(got, want)
    finite = bool(torch.isfinite(got).all())
    assert finite and err <= ATTN_TOL, err
    same = bool(torch.equal(got, full[:, :, :tq])
                and torch.equal(tail, full[:, :, tq:]))
    rows_diff = max(max_err(got, full[:, :, :tq]),
                    max_err(tail, full[:, :, tq:]))
    ms = time_ms(lambda: KA.flash_attention(qc, k, v, scale, False))
    plain_ms = time_ms(lambda: KA.flash_attention_plain(qc, k, v, scale,
                                                        False))
    lib = _lib_sdpa(qc, k, v, scale)
    torch.cuda.synchronize()
    lib_err = max_err(lib, want)
    lib_ms = time_ms(lambda: _lib_sdpa(qc, k, v, scale))
    nbytes = 4 * (2 * qc.numel() + k.numel() + v.numel())
    bms, by = bound_ms(nbytes, b * h * tq * tk * (4 * d + 5))
    products = 4 * b * h * tq * tk * d
    log(f"  flash_attention [{b},{h},{tq},{tk},{d}] non-causal (the "
        f"chunked prefill's shape): max_abs_err {err:.3e} (tol "
        f"{ATTN_TOL:g}); rows the same bits as at tq = tk = {tk}: {same} "
        f"(largest difference {rows_diff:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library sdpa {lib_ms:.4f} ms (its error "
        f"{lib_err:.3e}), bound {bms:.4f} ms ({by}), split-TF32 bound "
        f"{_tf32x3_ms(products):.4f} ms, {products / ms / 1e9:.2f} TFLOP/s "
        f"of fp32 products")
    return dict(shape=[b, h, tq, tk, d], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, tf32x3_bound_ms=_tf32x3_ms(products),
                tflops=products / ms / 1e9, rows_bit_identical=same,
                rows_max_diff=rows_diff)


def _randn_like(x, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(x.shape, device="cuda", generator=g)


def _bwd_ratio(got, want):
    """max |got - want| over the largest |want|, the worst of the three
    grads: at most ATTN_BWD_RTOL passes."""
    return max(float((a - w).abs().max()) / float(w.abs().max())
               for a, w in zip(got, want))


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as cvt.rna.tf32.f32 rounds): the operand a kernel would see if
    it dropped the small half of its split-TF32 products."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _lib_grad_ms(q, k, v, g, scale, causal=False):
    """The library's backward: torch's fused SDPA forward (math backend
    forbidden) under autograd, then only its backward is timed. It
    computes dq, dk and dv together. Its causal mask is top-left
    aligned, the port's bottom-right: the same where tq == tk."""
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    out = _lib_sdpa(qr, kr, vr, scale, causal)
    lib = torch.autograd.grad(out, (qr, kr, vr), g, retain_graph=True)
    torch.cuda.synchronize()
    ms = time_ms(lambda: torch.autograd.grad(out, (qr, kr, vr), g,
                                             retain_graph=True), iters=10)
    return ms, lib


def _lib_residual_ms(q, k, v, scale, causal=False):
    """torch's fused SDPA forward as it runs under autograd (it then also
    keeps its per-row logsumexp for the backward)."""
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    return time_ms(lambda: _lib_sdpa(qr, kr, vr, scale, causal), iters=10)


def _attn_bwd_entries():
    """The residual forwards and the three backward kernels against their
    plain versions on the same inputs: the training path's shapes
    ([32,8,512,64] sdpa_short, [16,8,1024,64] flash), causal and not;
    sdpa_short also at d 128, ragged tiles and T 13; flash also at d 128
    and 256, tq < tk, tq > tk (rows that see no key) and ragged tiles.
    Planted faults must fail the check: the backward fed an lse off by
    1e-3, a dropped delta, or a P off by 1e-3 relative; so must the TF32
    controls, the plain backwards and forwards on TF32-rounded operands.
    Every kernel, forward (with and without its residual) and backward,
    must repeat bit for bit, and sdpa_short's output must not change
    with P. Then times at the main shapes, causal and not, with the
    library backward's error against the plain version."""
    out = {}
    b512, b1024 = TRAIN_TOKENS // 512, TRAIN_TOKENS // 1024
    errs = {"sdpa_short_bwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    ratios = {n: [] for n in errs}
    res_errs = {"sdpa_short": [], "flash_attention": []}
    sdpa_tf32, sdpa_fwd_tf32 = [], []
    for i, (b, h, t, d, causal) in enumerate((
            (b512, 8, 512, 64, False), (b512, 8, 512, 64, True),
            (2, 4, 384, 128, True),
            # ragged tiles; T 13: odd rows of P, which the forward stores
            # and the backward reads a float at a time (the wrapper passes
            # any T <= 512 to the C entries)
            (1, 4, 264, 64, True), (1, 2, 300, 128, False),
            (1, 2, 13, 64, True))):
        q, k, v = _qkv(b, h, t, t, d, seed=40 + i)
        g = _randn_like(q, 50 + i)
        scale = d ** -0.5
        o, p = KA._sdpa_short_launch(q, k, v, scale, causal, True)
        wo, wp = KA.sdpa_short_plain(q, k, v, scale, causal, save_p=True)
        # the forward (#5), split TF32: a second launch with P and two
        # without give the same bits, and the out without P is the out
        # with P; the control is the plain forward on TF32-rounded q, k, v
        o2, p2 = KA._sdpa_short_launch(q, k, v, scale, causal, True)
        primal = [KA._sdpa_short_launch(q, k, v, scale, causal, False)
                  for _ in range(2)]
        fwd_repeat = (torch.equal(o, o2) and torch.equal(p, p2)
                      and torch.equal(primal[0], primal[1])
                      and torch.equal(primal[0], o))
        to, tp = KA.sdpa_short_plain(_tf32(q), _tf32(k), _tf32(v), scale,
                                     causal, save_p=True)
        fwd_tf32 = (max_err(to, wo), max_err(tp, wp))
        del o2, p2, primal, to, tp
        got = KA.sdpa_short_bwd(q, k, v, p, g, scale, causal)
        again = KA.sdpa_short_bwd(q, k, v, p, g, scale, causal)
        want = KA.sdpa_short_bwd_plain(q, k, v, p, g, scale)
        torch.cuda.synchronize()
        eo, ep = max_err(o, wo), max_err(p, wp)
        r = _bwd_ratio(got, want)
        repeat = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        bad = KA.sdpa_short_bwd(q, k, v, p * (1 - 1e-3), g, scale, causal)
        rf = _bwd_ratio(bad, want)
        tf32_ratio = _bwd_ratio(KA.sdpa_short_bwd_plain(
            *(_tf32(x) for x in (q, k, v, p, g)), scale), want)
        log(f"  sdpa_short+P [{b},{h},{t},{d}] causal={causal}: out "
            f"max_abs_err {eo:.3e} (tol {ATTN_TOL:g}), P {ep:.3e} (tol "
            f"{P_TOL:g}), a second launch (with P and without, and the out "
            f"without P against the out with it) bit-identical "
            f"{fwd_repeat}, TF32 control out {fwd_tf32[0]:.3e} P "
            f"{fwd_tf32[1]:.3e} (must exceed the tols); sdpa_short_bwd "
            f"worst |d - plain| / max|plain| {r:.3e} (tol "
            f"{ATTN_BWD_RTOL:g}), a second launch bit-identical {repeat}; "
            f"planted fault, P off by 1e-3: {rf:.3e}; TF32 control "
            f"{tf32_ratio:.3e} (these must exceed the tol)")
        assert eo <= ATTN_TOL and ep <= P_TOL, (eo, ep)
        assert fwd_repeat, "the sdpa_short forward is not deterministic"
        assert fwd_tf32[0] > ATTN_TOL and fwd_tf32[1] > P_TOL, \
            "the sdpa_short forward check cannot see TF32 rounding"
        assert all(torch.isfinite(x).all() for x in got)
        assert r <= ATTN_BWD_RTOL, r
        assert repeat, "the sdpa_short backward is not deterministic"
        assert rf > ATTN_BWD_RTOL, "the sdpa_short_bwd check cannot see P"
        assert tf32_ratio > ATTN_BWD_RTOL, \
            "the sdpa_short_bwd check cannot see TF32 rounding"
        sdpa_fwd_tf32.append(fwd_tf32)
        sdpa_tf32.append(tf32_ratio)
        res_errs["sdpa_short"].append(max(eo, ep))
        errs["sdpa_short_bwd"].append(max(max_err(a, w)
                                          for a, w in zip(got, want)))
        ratios["sdpa_short_bwd"].append(r)
        del q, k, v, g, o, p, wo, wp, got, again, want, bad
    tf32_controls, fwd_tf32_controls = [], []
    for i, (b, h, tq, tk, d, causal) in enumerate((
            (b1024, 8, 1024, 1024, 64, False),
            (b1024, 8, 1024, 1024, 64, True),
            (2, 4, 1024, 1024, 128, True), (1, 2, 600, 600, 256, True),
            (1, 8, 256, 1024, 64, True),     # tq < tk, bottom-right
            (1, 8, 1024, 256, 64, True),     # rows 0..767 see no key
            # ragged tiles: the last key and query tiles cut short, tq <
            # tk by a part tile, tq > tk at D 128
            (1, 4, 600, 600, 64, False), (1, 4, 600, 600, 64, True),
            (1, 4, 1000, 1024, 64, True), (1, 2, 1024, 600, 128, True))):
        q, k, v = _qkv(b, h, tq, tk, d, seed=60 + i)
        g = _randn_like(q, 70 + i)
        scale = d ** -0.5
        o, lse = KA._flash_attention_launch(q, k, v, scale, causal, True)
        wo, wlse = KA.flash_attention_plain(q, k, v, scale, causal,
                                            with_lse=True)
        delta = KA.flash_delta(o, g)
        # the forward (#2), split TF32: a second launch, with and without
        # lse, gives the same bits; the control is the plain forward on
        # TF32-rounded q, k, v
        o2, lse2 = KA._flash_attention_launch(q, k, v, scale, causal, True)
        fwd_repeat = (torch.equal(o, o2) and torch.equal(lse, lse2)
                      and torch.equal(KA._flash_attention_launch(
                          q, k, v, scale, causal, False), o))
        to, tlse = KA.flash_attention_plain(_tf32(q), _tf32(k), _tf32(v),
                                            scale, causal, with_lse=True)
        fwd_tf32 = (max_err(to, wo), max_err(tlse, wlse))
        del o2, lse2, to, tlse

        def kernels(lse_, delta_):
            return (KA.flash_bwd_dq(q, k, v, g, lse_, delta_, scale, causal),
                    *KA.flash_bwd_dkv(q, k, v, g, lse_, delta_, scale,
                                      causal))

        got = kernels(lse, delta)
        again = kernels(lse, delta)
        wdq = KA.flash_bwd_dq_plain(q, k, v, g, lse, delta, scale, causal)
        want = (wdq, *KA.flash_bwd_dkv_plain(q, k, v, g, lse, delta, scale,
                                             causal))
        torch.cuda.synchronize()
        eo, el = max_err(o, wo), max_err(lse, wlse)
        r_dq, r_dkv = _bwd_ratio(got[:1], want[:1]), _bwd_ratio(got[1:],
                                                              want[1:])
        repeat = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        faults = {"lse off by 1e-3": _bwd_ratio(kernels(lse + 1e-3, delta),
                                                want),
                  "delta dropped": _bwd_ratio(
                      kernels(lse, torch.zeros_like(delta)), want)}
        # the control: the plain backward on TF32-rounded operands
        tq_, tk_, tv_, tg_ = (_tf32(x) for x in (q, k, v, g))
        tf32_ratio = _bwd_ratio(
            (KA.flash_bwd_dq_plain(tq_, tk_, tv_, tg_, lse, delta, scale,
                                   causal),
             *KA.flash_bwd_dkv_plain(tq_, tk_, tv_, tg_, lse, delta, scale,
                                     causal)), want)
        del tq_, tk_, tv_, tg_
        log(f"  flash+lse [{b},{h},{tq},{tk},{d}] causal={causal}: out "
            f"max_abs_err {eo:.3e} (tol {ATTN_TOL:g}), lse {el:.3e} (tol "
            f"{LSE_TOL:g}), a second launch (with lse and without) "
            f"bit-identical {fwd_repeat}, TF32 control out {fwd_tf32[0]:.3e}"
            f" lse {fwd_tf32[1]:.3e} (must exceed the tols); worst "
            f"|d - plain| / max|plain|: flash_bwd_dq "
            f"{r_dq:.3e}, flash_bwd_dkv {r_dkv:.3e} (tol {ATTN_BWD_RTOL:g});"
            f" a second launch bit-identical {repeat}; planted faults "
            + ", ".join(f"{n}: {x:.3e}" for n, x in faults.items())
            + f"; TF32 control {tf32_ratio:.3e} (these must exceed the tol)")
        assert eo <= ATTN_TOL and el <= LSE_TOL, (eo, el)
        assert fwd_repeat, "the flash forward kernel is not deterministic"
        assert fwd_tf32[0] > ATTN_TOL and fwd_tf32[1] > LSE_TOL, \
            "the flash forward check cannot see TF32 rounding"
        fwd_tf32_controls.append(fwd_tf32)
        assert all(torch.isfinite(x).all() for x in got)
        assert repeat, "the flash backward kernels are not deterministic"
        assert tf32_ratio > ATTN_BWD_RTOL, \
            "the flash backward check cannot see TF32 rounding"
        tf32_controls.append(tf32_ratio)
        assert r_dq <= ATTN_BWD_RTOL and r_dkv <= ATTN_BWD_RTOL, (r_dq,
                                                                 r_dkv)
        for n, x in faults.items():
            assert x > ATTN_BWD_RTOL, f"the flash backward check cannot " \
                f"see {n}"
        if causal and tq > tk:  # rows that see no key: no dq
            assert (got[0][:, :, :tq - tk] == 0).all()
        res_errs["flash_attention"].append(max(eo, el))
        errs["flash_bwd_dq"].append(max_err(got[0], want[0]))
        errs["flash_bwd_dkv"].append(max(max_err(a, w) for a, w in
                                         zip(got[1:], want[1:])))
        ratios["flash_bwd_dq"].append(r_dq)
        ratios["flash_bwd_dkv"].append(r_dkv)
        del q, k, v, g, o, lse, wo, wlse, delta, got, again, want, wdq

    # times at the training shapes, non-causal and causal. Bounds: each
    # input read once, each output written once; operations: the products
    # (2 flops a multiply-add) the function needs, plus ~5 a score for the
    # softmax or its derivative; in split TF32, three TF32 products for
    # each of the function's fp32 products. Causal: the kernels skip the
    # tiles above the diagonal, and the function needs the t (t + 1) / 2
    # seen entries of each head
    controls = {"sdpa_short": sdpa_fwd_tf32, "flash_attention":
                fwd_tf32_controls, "sdpa_short_bwd": sdpa_tf32,
                "flash_bwd_dq": tf32_controls, "flash_bwd_dkv": tf32_controls}
    for name, (b, t) in (("sdpa_short", (b512, 512)),
                         ("flash_attention", (b1024, 1024))):
        h, d = 8, 64
        q, k, v = _qkv(b, h, t, t, d, seed=1)
        g = _randn_like(q, 2)
        scale = d ** -0.5
        n_td, n_tt = b * h * t * d, b * h * t * t
        seen = b * h * t * (t + 1) // 2
        lib_ms, lib = _lib_grad_ms(q, k, v, g, scale)
        lib_causal_ms, _ = _lib_grad_ms(q, k, v, g, scale, True)
        # per kernel: (kernel, plain, bytes, flops, the function's
        # products, the products the kernel runs, what they are); a call
        # takes causal
        if name == "sdpa_short":
            res = {c: KA._sdpa_short_launch(q, k, v, scale, c, True)[1]
                   for c in (False, True)}
            want = KA.sdpa_short_bwd_plain(q, k, v, res[False], g, scale)
            fwd = (lambda c=False: KA._sdpa_short_launch(q, k, v, scale, c,
                                                         True),
                   lambda c=False: KA.sdpa_short_plain(q, k, v, scale, c,
                                                       save_p=True),
                   4 * (4 * n_td + n_tt), 2, 3)
            kerns = {"sdpa_short_bwd": (
                lambda c=False: KA.sdpa_short_bwd(q, k, v, res[c], g, scale,
                                                  c),
                lambda c=False: KA.sdpa_short_bwd_plain(q, k, v, res[c], g,
                                                        scale),
                4 * (7 * n_td + n_tt), 8 * n_tt * d + 4 * n_tt, 4, 6,
                "dv = P^T dO, dP = dO v^T, dq = ds k, dk = ds^T q; the "
                "kernel also forms dP a second time (delta's sweep) and "
                "dP^T")}
        else:
            o, lse = KA._flash_attention_launch(q, k, v, scale, False, True)
            want = KA.flash_attention_bwd_plain(q, k, v, o, lse, g, scale,
                                                False)
            fwd = (lambda c=False: KA._flash_attention_launch(
                       q, k, v, scale, c, True),
                   lambda c=False: KA.flash_attention_plain(
                       q, k, v, scale, c, with_lse=True),
                   4 * (4 * n_td + b * h * t), 2, 2)
            # the causal lse and delta: a third of the training step's
            # backward launches are the decoder's causal ones
            o_c, lse_c = KA._flash_attention_launch(q, k, v, scale, True,
                                                    True)
            res = {False: (lse, KA.flash_delta(o, g)),
                   True: (lse_c, KA.flash_delta(o_c, g))}
            del o, o_c
            kerns = {
                "flash_bwd_dq": (
                    lambda c=False: KA.flash_bwd_dq(q, k, v, g, *res[c],
                                                    scale, c),
                    lambda c=False: KA.flash_bwd_dq_plain(q, k, v, g,
                                                          *res[c], scale, c),
                    4 * (5 * n_td + 2 * b * h * t),
                    6 * n_tt * d + 5 * n_tt, 3, 3,
                    "S, dP = dO v^T, dq = ds k"),
                "flash_bwd_dkv": (
                    lambda c=False: KA.flash_bwd_dkv(q, k, v, g, *res[c],
                                                     scale, c),
                    lambda c=False: KA.flash_bwd_dkv_plain(q, k, v, g,
                                                           *res[c], scale,
                                                           c),
                    4 * (6 * n_td + 2 * b * h * t),
                    8 * n_tt * d + 5 * n_tt, 4, 4,
                    "S, dP = dO v^T, dv = P^T dO, dk = ds^T q")}
        lib_err = _bwd_ratio(lib, want)
        log(f"  {name} backward: library sdpa backward vs plain: worst "
            f"|d - plain| / max|plain| {lib_err:.3e}")
        del want

        def timed(kern, plain, nbytes, flops, n_fn, n_run, c):
            """Kernel and plain ms, the fp32 bound and its kind, the
            split-TF32 bound, and the TFLOP/s of the function's and of the
            run products."""
            ms = time_ms(lambda: kern(c))
            plain_ms = time_ms(lambda: plain(c), iters=5)
            frac = seen / n_tt if c else 1.0
            bms, by = bound_ms(nbytes, flops * frac)
            fn, run = (2 * n * n_tt * d * frac for n in (n_fn, n_run))
            return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        tf32x3_bound_ms=_tf32x3_ms(fn),
                        tflops=fn / ms / 1e9, run_tflops=run / ms / 1e9)

        def note(x):
            return (f"kernel {x['ms']:.4f} ms, plain {x['plain_ms']:.4f} "
                    f"ms, bound {x['bound_ms']:.4f} ms ({x['bound_by']}), "
                    f"split-TF32 bound {x['tf32x3_bound_ms']:.4f} ms, "
                    f"{x['tflops']:.2f} TFLOP/s of the function's fp32 "
                    f"products ({x['run_tflops']:.2f} of those run)")

        # the forward with its residual, as the grad op's recompute runs it
        kern, plain, nbytes, n_fn, n_run = fwd
        e, ec = (timed(kern, plain, nbytes, n_tt * (4 * d + 5), n_fn, n_run,
                       c) for c in (False, True))
        ec["library_ms"] = _lib_residual_ms(q, k, v, scale, True)
        e["library_ms"] = _lib_residual_ms(q, k, v, scale)
        log(f"  {name} with its residual [{b},{h},{t},{d}] non-causal: "
            f"{note(e)}, library sdpa under autograd {e['library_ms']:.4f} "
            f"ms; causal: {note(ec)}, library {ec['library_ms']:.4f} ms")
        ctl = controls[name]
        out[name] = dict(max_abs_err=max(res_errs[name]),
                         shape=[b, h, t, d], causal=ec,
                         tf32_control=[min(c[0] for c in ctl),
                                       min(c[1] for c in ctl)], **e)
        for kname, (kern, plain, nbytes, flops, n_fn, n_run,
                    products) in kerns.items():
            e, ec = (timed(kern, plain, nbytes, flops, n_fn, n_run, c)
                     for c in (False, True))
            e["library_ms"], ec["library_ms"] = lib_ms, lib_causal_ms
            # the kernels of one launch (a backward may run several)
            _, prof = _device_profile(f"  {kname} one call, non-causal",
                                      kern)
            e["kernels_ms"] = prof["port_kernels_ms"]
            log(f"  {kname} [{b},{h},{t},{d}] ({products}) non-causal: "
                f"{note(e)}, library sdpa backward (dq, dk and dv) "
                f"{lib_ms:.4f} ms; causal: {note(ec)}, library "
                f"{lib_causal_ms:.4f} ms")
            out[kname] = dict(max_abs_err=max(errs[kname]),
                              max_rel_err=max(ratios[kname]),
                              library_rel_err=lib_err, shape=[b, h, t, d],
                              tf32_control=min(controls[kname]), causal=ec,
                              **e)
        del q, k, v, g, lib, res
    return out


def _fused_inputs(b, t, d, f, seed):
    """x and the cotangent g [b, t, d], the attention block's Wqkv and Wo
    and the FFN's W1, b1, W2, b2, scaled as Xavier-like initial weights."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    return dict(x=r(b, t, d), g=r(b, t, d), wqkv=r(d, 3 * d, scale=d ** -0.5),
                wo=r(d, d, scale=d ** -0.5), w1=r(d, f, scale=d ** -0.5),
                b1=r(f, scale=0.1), w2=r(f, d, scale=f ** -0.5),
                b2=r(d, scale=0.1))


def _attention_block_p_f64(x, wqkv, h, scale, causal):
    """The saved P [B, H, T, T] of the attention block's plain composition
    (`attention_block_fwd_plain`) evaluated in float64: what the kernel's
    split-TF32 P is held to. Its fp32 plain version rounds x Wqkv over D
    terms in another order and lies as far from this as the kernel does
    (about 1e-6 at the training shape), so the two fp32 results differ by
    the sum of their roundings."""
    b, t, d = x.shape
    q, k = (z.reshape(b, t, h, -1).transpose(1, 2)
            for z in (x.double() @ wqkv.double()).split(d, dim=2)[:2])
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    return torch.softmax(s, dim=-1)


def _lib_attention_block(x, wqkv, wo, h, scale):
    """The attention block as library calls: cuBLAS products around
    torch's fused SDPA (math backend forbidden). Timed only."""
    b, t, d = x.shape
    q, k, v = (z.reshape(b, t, h, -1).transpose(1, 2)
               for z in (x @ wqkv).split(d, dim=2))
    return _lib_sdpa(q, k, v, scale).transpose(1, 2).reshape(b, t, d) @ wo


def _lib_ffn(x, w1, b1, w2, b2):
    """The FFN block as library calls: addmm, relu, addmm. Timed only."""
    x2 = x.reshape(-1, x.shape[-1])
    return torch.addmm(b2, torch.relu(torch.addmm(b1, x2, w1)),
                       w2).reshape(x.shape)


def _ffn_bwd_with_mask(x, w1, b1, w2, g, mask, dh_bf16=False):
    """The plain FFN backward (fp32 arithmetic, the grads in the inputs'
    dtype) with the ReLU's mask given ([rows, F] bool) in place of its
    own (pre > 0); with `dh_bf16`, dh rounded to one bf16 term before
    its products: what a bf16 kernel that dropped the low part of that
    fp32 intermediate would compute (a planted fault)."""
    d = w1.shape[0]
    x2, g2 = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    w1f, w2f = w1.float(), w2.float()
    dh = torch.where(mask, g2 @ w2f.T, 0.0)
    if dh_bf16:
        dh = dh.to(torch.bfloat16).float()
    return ((dh @ w1f.T).reshape(x.shape).to(x.dtype),
            (x2.T @ dh).to(w1.dtype), dh.sum(0).to(b1.dtype),
            (torch.relu(x2 @ w1f + b1.float()).T @ g2).to(w2.dtype),
            g2.sum(0).to(w2.dtype))


def _ffn_bwd_mask_flipped(x, w1, b1, w2, g, col):
    """The plain FFN backward with the ReLU's mask inverted on hidden
    column `col`: a planted fault for the grad check."""
    d = w1.shape[0]
    mask = x.reshape(-1, d).float() @ w1.float() + b1.float() > 0
    mask[:, col] = ~mask[:, col]
    return _ffn_bwd_with_mask(x, w1, b1, w2, g, mask)


def _ffn_bwd_kernel(x, w1, b1, w2, g):
    """The FFN backward kernel (x's dtype's instance) through its C
    entry, with the fp32 scratch hidden kept: (the five grads, the ReLU
    mask its recompute took). The scratch ends as dh = (g W2^T)[mask]
    (bf16: its hi and lo planes, read as hi + lo), so the mask is dh != 0
    wherever g W2^T is not 0, and where it is 0 dh is 0 under either
    mask."""
    d, f = w1.shape
    n = x.numel() // d
    grads = (torch.empty_like(x), torch.empty_like(w1), torch.empty_like(b1),
             torch.empty_like(w2), x.new_empty(d))
    h = torch.empty(n, f, device=x.device)
    ws = torch.empty(max(KFF.WORKSPACE_FLOATS, f), device=x.device)
    assert KFF._kernel("ffn_block_bwd", 12, True, x.dtype)(
        *(z.data_ptr() for z in (x, w1, b1, w2, g, *grads, h, ws)),
        ws.numel(), n, d, f, torch.cuda.current_stream().cuda_stream) == 0
    return grads, _scratch_values(h, x.dtype) != 0


def _scratch_values(h, dtype):
    """The fp32 values the FFN kernels keep in their scratch h [n, f]:
    fp32 itself, or (the bf16 instances) hi + lo of its two bf16
    planes."""
    if dtype != torch.bfloat16:
        return h
    hi, lo = KBP.scratch_planes(h, *h.shape)
    return hi.float() + lo.float()


def _relu_flips(x, w1, b1, mask):
    """Hidden units where `mask` differs from the plain recompute's
    (pre > 0), and the largest |pre-activation| among them, recomputed in
    float64: a unit within rounding of zero takes either mask in two fp32
    computations that round differently."""
    d = w1.shape[0]
    x2 = x.reshape(-1, d)
    flips = mask != (x2.float() @ w1.float() + b1.float() > 0)
    pre = x2.double() @ w1.double() + b1.double()
    top = float(pre.abs().max())
    return int(flips.sum()), (float(pre[flips].abs().max())
                              if bool(flips.any()) else 0.0), top


def _ffn_fwd_hidden(x, w1, b1, w2):
    """The FFN forward kernel's (#12, x's dtype's instance) fp32 hidden
    relu(x W1 + b1) for x [n, d], through its C entry, whose scratch
    hidden is the caller's (bf16: hi + lo of its two planes)."""
    n, d = x.shape
    f = w1.shape[1]
    h = torch.empty(n, f, device=x.device)
    assert KFF._kernel("ffn_block_fwd", 7, False, x.dtype)(
        *(z.data_ptr() for z in (x, w1, b1, w2, x.new_zeros(d),
                                 torch.empty_like(x), h)),
        n, d, f, torch.cuda.current_stream().cuda_stream) == 0
    return _scratch_values(h, x.dtype)


def _fwd_bwd_mask_flips(x, w1, b1, w2):
    """Hidden units of x [n, d] whose ReLU mask differs between the FFN
    forward kernel (#12) and the backward kernel's recompute (#13), which
    compute the hidden with one code path and must agree on every unit:
    #12's hidden h > 0 against #13's mask under a cotangent of ones (dh =
    the sum of W2's row where the mask is on). Through the C entries,
    whose scratch hidden is the caller's."""
    assert float(w2.double().sum(1).abs().min()) > 1e-5, \
        "a row of W2 sums to 0: dh cannot show the mask there"
    h = _ffn_fwd_hidden(x, w1, b1, w2)
    _, mask = _ffn_bwd_kernel(x, w1, b1, w2, torch.ones_like(x))
    return int(((h > 0) != mask).sum())


def _fused_entries():
    """The fused-block kernels against their plain versions: the training
    path's shape (B 64, T 256, D 512, H 8, F 2048), causal and not, a
    small one (B 3, T 16, D 64, H 2: Dh 32, F 96), T at its limit (B 1,
    T 512, causal) and Dh 128 with a ragged T (B 2, T 200, D 256, H 2, F
    1024). Each output and grad within FUSED_RTOL of its largest |plain|
    (the FFN backward's with the plain ReLU masks pinned to the kernel's
    recompute, the units that flip within rounding of zero), saved P
    within P_TOL of the plain composition in float64. All four run in
    split TF32 and repeat bit for bit (the attention_block forward's
    output the same bits with P and without); at the training shape the
    ffn_block forward's hidden and its backward's recompute take the same
    ReLU mask on every unit. Planted faults must fail the checks: the
    attention_block forward with the causal flag dropped in the causal
    cases; P off by 1e-3, dWo computed from g transposed (dWo^T), b2 left
    out of the FFN forward, b1 left out of the FFN backward's recompute,
    the ReLU mask inverted on one hidden column; so must the TF32
    controls, the plain versions of all four on TF32-rounded operands.
    Then times at the training shape, non-causal, beside each kernel's
    bound (its products, 2 flops a multiply-add, over 67 TFLOP/s,
    against its bytes over 3.35 TB/s), three times the products' flops
    over 495 TFLOP/s (the split-TF32 bound), its plain version and its
    composition of library calls (no single PyTorch call computes these
    functions)."""
    errs = {n: [] for n in ("attention_block", "attention_block_bwd",
                            "ffn_block", "ffn_block_bwd")}
    p_errs = []
    bt, t_, d_, h_, f_ = TRAIN_TOKENS // 256, 256, 512, 8, 2048
    tf32_controls = {n: [] for n in ("attention_block", "attention_block_bwd",
                                     "ffn_block", "ffn_block_bwd")}
    ffn_flips = []  # (units, largest |pre-activation|, unpinned ratio)
    fwd_bwd_flips = None  # #12's hidden against #13's recompute
    for i, (b, t, d, h, f, causal) in enumerate((
            (bt, t_, d_, h_, f_, False), (bt, t_, d_, h_, f_, True),
            (3, 16, 64, 2, 96, True),
            (1, 512, d_, h_, f_, True),    # T at its limit
            (2, 200, 256, 2, 1024, False))):  # Dh 128, ragged T
        a = _fused_inputs(b, t, d, f, seed=80 + i)
        x, g, wqkv, wo = a["x"], a["g"], a["wqkv"], a["wo"]
        scale = (d // h) ** -0.5
        out, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                             True)
        wout, wp = KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale,
                                                 causal, save_p=True)
        # the forward (#10), split TF32: a second launch with P and one
        # without give the same bits as the first; the control is the plain
        # forward on TF32-rounded x, Wqkv and Wo
        out2, p2 = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                               True)
        primal = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                             False)
        fwd_repeat = (torch.equal(out, out2) and torch.equal(p, p2)
                      and torch.equal(primal, out))
        tout, tp = KAB.attention_block_fwd_plain(
            *(_tf32(z) for z in (x, wqkv, wo)), h, scale, causal,
            save_p=True)
        fwd_tf32 = (_bwd_ratio((tout,), (wout,)), max_err(tp, wp))
        fwd_faults = {} if not causal else {
            "causal flag dropped": _bwd_ratio((KAB._attention_block_launch(
                x, wqkv, wo, h, scale, False, False),), (wout,))}
        del out2, p2, primal, tout, tp
        p64 = _attention_block_p_f64(x, wqkv, h, scale, causal)
        ep, ep_plain = (float((z.double() - p64).abs().max()) for z in (p, wp))
        del p64
        got = KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale, causal)
        again = KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale, causal)
        want = KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h, scale)
        torch.cuda.synchronize()
        r_out = _bwd_ratio((out,), (wout,))
        r = _bwd_ratio(got, want)
        repeat = all(torch.equal(z, y) for z, y in zip(got, again))
        faults = {
            "P off by 1e-3": _bwd_ratio(KAB.attention_block_bwd(
                x, wqkv, wo, p * (1 - 1e-3), g, h, scale, causal), want),
            "dWo from g transposed": _bwd_ratio(
                (*got[:2], got[2].T.contiguous()), want),
            # the control: the plain backward on TF32-rounded operands
            # (what a kernel that dropped its products' small halves
            # would compute)
            "TF32 control": _bwd_ratio(KAB.attention_block_bwd_plain(
                *(_tf32(z) for z in (x, wqkv, wo, p, g)), h, scale), want)}
        log(f"  attention_block+P [{b},{t},{d}] H {h} causal={causal}: out "
            f"|d - plain| / max|plain| {r_out:.3e} (tol {FUSED_RTOL:g}), P "
            f"max_abs_err against the plain version in float64 {ep:.3e} "
            f"(tol {P_TOL:g}; the fp32 plain version's own {ep_plain:.3e}, "
            f"the kernel's against it {max_err(p, wp):.3e}), a second "
            f"launch (with P and without) bit-identical {fwd_repeat}, TF32 "
            f"control out "
            f"{fwd_tf32[0]:.3e} P {fwd_tf32[1]:.3e}"
            + "".join(f", planted fault {n}: out {e:.3e}"
                      for n, e in fwd_faults.items())
            + f" (these must exceed the tols); attention_block_bwd "
            f"worst {r:.3e} (tol {FUSED_RTOL:g}), a second launch "
            f"bit-identical {repeat}; planted faults "
            + ", ".join(f"{n}: {e:.3e}" for n, e in faults.items())
            + " (must exceed the tol)")
        assert all(torch.isfinite(z).all() for z in (out, *got))
        assert r_out <= FUSED_RTOL and ep <= P_TOL and r <= FUSED_RTOL, (
            r_out, ep, r)
        assert fwd_repeat, "the attention_block forward is not deterministic"
        assert fwd_tf32[0] > FUSED_RTOL and fwd_tf32[1] > P_TOL, \
            "the attention_block forward check cannot see TF32 rounding"
        for n, e in fwd_faults.items():
            assert e > FUSED_RTOL, f"the attention_block check cannot see {n}"
        assert repeat, "the attention_block backward is not deterministic"
        for n, e in faults.items():
            assert e > FUSED_RTOL, f"the attention_block_bwd check cannot " \
                f"see {n}"
        tf32_controls["attention_block"].append(fwd_tf32)
        tf32_controls["attention_block_bwd"].append(faults["TF32 control"])
        errs["attention_block"].append((max_err(out, wout), r_out))
        errs["attention_block_bwd"].append(
            (max(max_err(z, w) for z, w in zip(got, want)), r))
        p_errs.append(ep)
        del out, p, got, again, wout, wp, want
        if causal and d == d_:
            continue  # the FFN has no causal form
        w1, b1, w2, b2 = a["w1"], a["b1"], a["w2"], a["b2"]
        out = KFF.ffn_block(x, w1, b1, w2, b2)
        # the forward (#12), split TF32: a second launch gives the same
        # bits; the control is the plain forward on TF32-rounded operands;
        # the planted fault leaves b2 out
        fwd_repeat = torch.equal(KFF.ffn_block(x, w1, b1, w2, b2), out)
        got = KFF.ffn_block_bwd(x, w1, b1, w2, g)
        again, kmask = _ffn_bwd_kernel(x, w1, b1, w2, g)
        wout = KFF.ffn_block_plain(x, w1, b1, w2, b2)
        # the grads are held against the plain backward with its ReLU
        # masks pinned to the kernel's recompute: the two round the
        # pre-activation differently, and a unit within rounding of zero
        # that takes the other mask moves the grads below it by ~1e-2 of
        # their largest (PERF.md section 2). Such units must lie within
        # FUSED_RTOL of the largest |pre-activation| of zero.
        n_flips, flip_max, pre_max = _relu_flips(x, w1, b1, kmask)
        want = _ffn_bwd_with_mask(x, w1, b1, w2, g, kmask)
        unpinned = _bwd_ratio(got, KFF.ffn_block_bwd_plain(x, w1, b1, w2, g))
        torch.cuda.synchronize()
        r_out, r = _bwd_ratio((out,), (wout,)), _bwd_ratio(got, want)
        fwd_faults = {
            "b2 left out": _bwd_ratio((KFF.ffn_block(
                x, w1, b1, w2, torch.zeros_like(b2)),), (wout,)),
            "TF32 control": _bwd_ratio((KFF.ffn_block_plain(
                *(_tf32(z) for z in (x, w1, b1, w2, b2))),), (wout,))}
        # at the training shape: no unit takes one ReLU mask in #12's
        # hidden and the other in #13's recompute
        kflips = (_fwd_bwd_mask_flips(x.reshape(-1, d), w1, b1, w2)
                  if (b, t, d, f) == (bt, t_, d_, f_) else None)
        repeat = all(torch.equal(z, y) for z, y in zip(got, again))
        faults = {
            "b1 left out of the recompute": _bwd_ratio(KFF.ffn_block_bwd(
                x, w1, torch.zeros_like(b1), w2, g), want),
            "ReLU mask inverted on one column": _bwd_ratio(
                _ffn_bwd_mask_flipped(x, w1, b1, w2, g, f // 3), want),
            # the backward (#13) runs in split TF32: the control is the
            # plain backward on TF32-rounded operands
            "TF32 control": _bwd_ratio(KFF.ffn_block_bwd_plain(
                *(_tf32(z) for z in (x, w1, b1, w2, g))), want)}
        log(f"  ffn_block [{b},{t},{d}] F {f}: out |d - plain| / "
            f"max|plain| {r_out:.3e} (tol {FUSED_RTOL:g}), a second launch "
            f"bit-identical {fwd_repeat}; planted faults "
            + ", ".join(f"{n}: {e:.3e}" for n, e in fwd_faults.items())
            + " (must exceed the tol)"
            + ("" if kflips is None else
               f"; {kflips} units take one ReLU mask in the forward's "
               f"hidden and the other in the backward's recompute")
            + f"; ffn_block_bwd "
            f"{n_flips} of {kmask.numel()} ReLU units take the other mask "
            f"than the plain recompute's, |pre-activation| at most "
            f"{flip_max:.3e} (limit {FUSED_RTOL * pre_max:.3e}); worst "
            f"{r:.3e} with the plain masks pinned to the kernel's (tol "
            f"{FUSED_RTOL:g}), {unpinned:.3e} unpinned; a second launch "
            f"bit-identical {repeat}; planted faults "
            + ", ".join(f"{n}: {e:.3e}" for n, e in faults.items())
            + " (must exceed the tol)")
        assert all(torch.isfinite(z).all() for z in (out, *got))
        assert r_out <= FUSED_RTOL and r <= FUSED_RTOL, (r_out, r)
        assert fwd_repeat, "the ffn_block forward is not deterministic"
        for n, e in fwd_faults.items():
            assert e > FUSED_RTOL, f"the ffn_block check cannot see {n}"
        assert kflips in (None, 0), f"{kflips} units flip between the " \
            f"ffn_block forward's hidden and the backward's recompute"
        assert flip_max <= FUSED_RTOL * pre_max, (n_flips, flip_max)
        assert repeat, "the ffn_block backward is not deterministic"
        for n, e in faults.items():
            assert e > FUSED_RTOL, f"the ffn_block_bwd check cannot see {n}"
        tf32_controls["ffn_block"].append(fwd_faults["TF32 control"])
        tf32_controls["ffn_block_bwd"].append(faults["TF32 control"])
        errs["ffn_block"].append((max_err(out, wout), r_out))
        errs["ffn_block_bwd"].append(
            (max(max_err(z, w) for z, w in zip(got, want)), r))
        ffn_flips.append((n_flips, flip_max, unpinned))
        if kflips is not None:
            fwd_bwd_flips = kflips
        del a, out, got, again, kmask, wout, want

    # times at the training shape, non-causal
    a = _fused_inputs(bt, t_, d_, f_, seed=90)
    x, g, wqkv, wo = a["x"], a["g"], a["wqkv"], a["wo"]
    w1, b1, w2, b2 = a["w1"], a["b1"], a["w2"], a["b2"]
    b, t, d, h, f = bt, t_, d_, h_, f_
    scale = (d // h) ** -0.5
    n_x, n_p, n_h = b * t * d, b * h * t * t, b * t * f
    gemm = 2 * b * t * d  # flops of one product of the rows by a [d, 1]
    _, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, False, True)
    tracked = {k: v.detach().requires_grad_() for k, v in a.items()
               if k != "g"}
    lib_attn = _lib_attention_block(tracked["x"], tracked["wqkv"],
                                    tracked["wo"], h, scale)
    lib_ffn = _lib_ffn(*(tracked[k] for k in ("x", "w1", "b1", "w2", "b2")))
    attn_in = (tracked["x"], tracked["wqkv"], tracked["wo"])
    ffn_in = tuple(tracked[k] for k in ("x", "w1", "b1", "w2", "b2"))
    plain_attn = KAB.attention_block_plain(x, wqkv, wo, h, scale, False)
    plain_ffn = KFF.ffn_block_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    log(f"  fused library compositions vs plain: attention block "
        f"{_bwd_ratio((lib_attn.detach(),), (plain_attn,)):.3e}, ffn block "
        f"{_bwd_ratio((lib_ffn.detach(),), (plain_ffn,)):.3e} "
        f"(|d - plain| / max|plain|)")
    del plain_attn, plain_ffn
    attn_fwd_flops = gemm * 4 * d + 4 * n_p * (d // h)
    cases = {
        "attention_block": (
            lambda: KAB._attention_block_launch(x, wqkv, wo, h, scale, False,
                                                False),
            lambda: KAB.attention_block_plain(x, wqkv, wo, h, scale, False),
            lambda: _lib_attention_block(x, wqkv, wo, h, scale),
            4 * (2 * n_x + 4 * d * d), attn_fwd_flops,
            "x Wqkv, cuBLAS; SDPA (efficient attention); ctx Wo, cuBLAS"),
        "attention_block_residual": (
            lambda: KAB._attention_block_launch(x, wqkv, wo, h, scale, False,
                                                True),
            lambda: KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale,
                                                  False, save_p=True),
            lambda: _lib_attention_block(*attn_in, h, scale),
            4 * (2 * n_x + 4 * d * d + n_p), attn_fwd_flops,
            "the same under autograd"),
        "attention_block_bwd": (
            lambda: KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale),
            lambda: KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h,
                                                  scale),
            lambda: torch.autograd.grad(lib_attn, attn_in, g,
                                        retain_graph=True),
            4 * (3 * n_x + 8 * d * d + n_p),
            gemm * (3 * 3 * d + 2 * d) + 5 * 2 * n_p * (d // h),
            "the autograd backward of that composition"),
        "ffn_block": (
            lambda: KFF._ffn_block_launch(x, w1, b1, w2, b2),
            lambda: KFF.ffn_block_plain(x, w1, b1, w2, b2),
            lambda: _lib_ffn(x, w1, b1, w2, b2),
            4 * (2 * n_x + 2 * d * f + f + d), 2 * gemm * f,
            "addmm, relu, addmm (cuBLAS)"),
        "ffn_block_bwd": (
            lambda: KFF.ffn_block_bwd(x, w1, b1, w2, g),
            lambda: KFF.ffn_block_bwd_plain(x, w1, b1, w2, g),
            lambda: torch.autograd.grad(lib_ffn, ffn_in, g,
                                        retain_graph=True),
            4 * (3 * n_x + 4 * d * f + 2 * f + d), 5 * gemm * f,
            "the autograd backward of that composition"),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, flops, label) in cases.items():
        ms = time_ms(kern, iters=10)
        plain_ms = time_ms(plain, iters=5)
        lib_ms = time_ms(lib, iters=10)
        bms, by = bound_ms(nbytes, flops)
        # all five run in split TF32 on the tensor cores; the
        # attention_block forward's control is a pair (out, P)
        base = name.replace("_residual", "")
        ctl = tf32_controls[base]
        tf32_bound = _tf32x3_ms(flops)
        log(f"  {name} [{b},{t},{d}] H {h} F {f} non-causal: kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, library composition ({label}) "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, "
            f"{flops / 1e9:.2f} GFLOP), split-TF32 bound {tf32_bound:.4f} "
            f"ms")
        out[name] = dict(max_abs_err=max(e[0] for e in errs[base]),
                         max_rel_err=max(e[1] for e in errs[base]), ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib_ms,
                         library=f"composition: {label}",
                         shape=[b, t, d, h, f], tflops=flops / ms / 1e9,
                         tf32x3_bound_ms=tf32_bound,
                         tf32_control=([min(c[0] for c in ctl),
                                        min(c[1] for c in ctl)]
                                       if isinstance(ctl[0], tuple)
                                       else min(ctl)))
    out["ffn_block"]["fwd_bwd_mask_flips"] = fwd_bwd_flips
    out["ffn_block_bwd"]["relu_flips"] = [x[0] for x in ffn_flips]
    out["ffn_block_bwd"]["unpinned_rel_err"] = max(x[2] for x in ffn_flips)
    out["attention_block"]["p_max_abs_err"] = max(p_errs)
    out["attention_block"]["residual"] = out.pop("attention_block_residual")
    return out


def _paged_inputs(r, h, d, bs, np_pages, nb, steps, seed, distinct=True):
    """q, pools, a block table and steps on the card. Lane i's pages up
    to its step own blocks no other lane owns (blocks 1, 2, ... in
    order; with distinct=False they wrap around the pool), its pages
    past the step point at block 0, unallocated; a lane at step -1 owns
    all its pages."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(r, h, d, device="cuda", generator=g)
    pk = torch.randn(nb, bs, h, d, device="cuda", generator=g)
    pv = torch.randn(nb, bs, h, d, device="cuda", generator=g)
    tab = np.zeros((r, np_pages), np.int32)
    nxt = 1
    for i, st in enumerate(steps):
        for p in range(np_pages if st < 0 else min(np_pages,
                                                   st // bs + 1)):
            tab[i, p] = nxt % nb
            nxt += 1
    assert nxt <= nb or not distinct, "the pool cannot hold the tables"
    return (q, pk, pv, torch.from_numpy(tab).cuda(),
            torch.tensor(steps, dtype=torch.int64, device="cuda"))


def _lib_paged(q, pk, pv, tab, step, scale):
    """The yardstick: the pages gathered to a dense [R,H,T,Dh] view,
    then torch's fused SDPA (math backend forbidden) with the additive
    step mask. The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    r, h, d = q.shape
    t = tab.shape[1] * pk.shape[1]
    k = pk[tab.long()].reshape(r, t, h, d).transpose(1, 2)
    v = pv[tab.long()].reshape(r, t, h, d).transpose(1, 2)
    pos = torch.arange(t, device=q.device)
    mask = torch.zeros(r, 1, 1, t, device=q.device).masked_fill(
        (pos[None, :] > step[:, None]).reshape(r, 1, 1, t), float("-inf"))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, scale=scale)[:, :, 0]


def _paged_work(q, tab, step, bs):
    """Bytes and operations one call needs on these inputs: K and V of
    each lane's visible positions (all NP*BS at a negative step), q, the
    output, the table and the steps; per visible position and head 2 Dh
    flops each for q.k and p v, plus ~5 for the softmax."""
    r, h, d = q.shape
    t = tab.shape[1] * bs
    st = step.cpu().numpy()
    vis = int(np.where(st < 0, t, np.minimum(st + 1, t)).sum())
    nbytes = 2 * vis * h * d * 4 + 2 * r * h * d * 4 + tab.numel() * 4 \
        + r * 8
    return nbytes, vis * h * (4 * d + 5)


def _paged_entries():
    """Kernel #9 against its plain version: the paged serving shape (R 17
    lanes, H 8, Dh 64, BS 16, NP 16, NB 256) with steps spread over
    0..255, tables that share no block, unallocated pages at block 0 and
    one lane at step -1, with every lane's step on a page boundary, and
    with the steps -1 and 0, 4, ..., 60, inside the kernel's first chunk
    of 64 positions; a small shape (R 3, H 2, Dh 16, BS 8, NP 4); Dh 128;
    Dh 256; one lane alone at T 1024 (R*H 8) at step 1023; two lanes at T
    1024, one at step -1 (the average over 1024 cells, 16 chunks) and one
    at step 517. Output within ATTN_TOL, and the same bits on a second
    launch. Planted faults must fail the check: the step off by one
    (positions < step, not <= step) and page p+1 read in place of page
    p. Then times at the
    serving shape with every lane at step 255 (the most one tick reads)
    and at steps 15, 63 and 127, warm (the pools, 16.8 MB, stay in the
    50 MB L2 between back-to-back launches) and cold (the L2 flushed
    before each launch by a 128 MB write, or by the write and a read of
    it, and the launch timed alone; a one-element fill timed so shows
    what timing a launch alone adds), beside the bound (this run's bytes
    over 3.35 TB/s), the plain version and the yardstick (gather + SDPA)."""
    errs = []
    serve = (17, 8, 64, 16, 16, 256)
    spread = [-1] + [int(x) for x in np.linspace(0, 255, 16)]
    boundary = [min(255, 16 * i - i % 2) for i in range(17)]
    first_chunk = [-1] + list(range(0, 64, 4))
    long_lane = (1, 8, 64, 16, 64, 80)
    for (r, h, d, bs, np_pages, nb), steps in (
            (serve, spread), (serve, boundary), (serve, first_chunk),
            ((3, 2, 16, 8, 4, 16), [0, 8, 31]),
            ((5, 4, 128, 16, 8, 48), [-1, 15, 16, 77, 127]),
            ((3, 2, 256, 16, 8, 32), [-1, 40, 127]),
            (long_lane, [1023]), ((2, 8, 64, 16, 64, 160), [-1, 517])):
        q, pk, pv, tab, st = _paged_inputs(r, h, d, bs, np_pages, nb,
                                           steps, seed=r + d)
        scale = d ** -0.5
        got = KPA.paged_decode_attention(q, pk, pv, tab, st, scale)
        again = KPA.paged_decode_attention(q, pk, pv, tab, st, scale)
        want = KPA.paged_decode_attention_plain(q, pk, pv, tab, st, scale)
        shifted = tab.clone()
        shifted[:, :-1] = tab[:, 1:]
        faults = {
            "step off by one": max_err(KPA.paged_decode_attention(
                q, pk, pv, tab, st - 1, scale), want),
            "page p+1 read for p": max_err(KPA.paged_decode_attention(
                q, pk, pv, shifted, st, scale), want)}
        torch.cuda.synchronize()
        err = max_err(got, want)
        repeat = torch.equal(got, again)
        log(f"  paged_decode_attention R {r} H {h} Dh {d} BS {bs} NP "
            f"{np_pages} NB {nb}, steps "
            f"{steps if len(steps) < 8 else 'from ' + str(steps[:4])}: "
            f"max_abs_err {err:.3e} (tol {ATTN_TOL:g}), a second launch "
            f"bit-identical {repeat}; planted faults "
            + ", ".join(f"{n}: {e:.3e}" for n, e in faults.items())
            + " (must exceed the tol)")
        assert bool(torch.isfinite(got).all()) and err <= ATTN_TOL, err
        assert repeat, "the paged kernel is not deterministic"
        for n, e in faults.items():
            assert e > ATTN_TOL, f"the paged check cannot see {n}"
        errs.append(err)

    def timed(shape, steps, tag):
        r, h, d, bs, np_pages, nb = shape
        q, pk, pv, tab, st = _paged_inputs(r, h, d, bs, np_pages, nb,
                                           steps, seed=5, distinct=False)
        scale = d ** -0.5
        run = lambda: KPA.paged_decode_attention(q, pk, pv, tab, st, scale)
        res = dict(ms=time_ms(run, iters=50), cold_ms=time_cold_ms(run),
                   cold_clean_ms=time_cold_ms(run, clean=True),
                   shape=list(shape))
        nbytes, flops = _paged_work(q, tab, st, bs)
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops)
        log(f"  paged_decode_attention R {r} H {h} Dh {d} BS {bs} NP "
            f"{np_pages}, {tag}: kernel warm L2 {res['ms']:.4f} ms "
            f"({nbytes / res['ms'] / 1e6:.1f} GB/s), cold L2 (one launch "
            f"alone) {res['cold_ms']:.4f} ms "
            f"({nbytes / res['cold_ms'] / 1e6:.1f} GB/s), with no dirty "
            f"line in the L2 {res['cold_clean_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB)")
        return res, (q, pk, pv, tab, st, scale)

    # what timing one launch alone adds: a one-element fill timed so
    tiny = torch.zeros(1, device="cuda")
    launch_alone_ms = time_cold_ms(tiny.zero_)
    log(f"  a one-element fill timed as a launch alone with a cold L2: "
        f"{launch_alone_ms:.4f} ms")

    # a decode tick's lanes sit anywhere from step 0 to 255: the time
    # of a call with every lane at a few steps below the longest
    by_step = {}
    for step in (15, 63, 127):
        res, _ = timed(serve, [step] * serve[0],
                       f"every lane at step {step}")
        by_step[step] = dict(ms=res["ms"], bound_ms=res["bound_ms"])
    main, (q, pk, pv, tab, st, scale) = timed(
        serve, [255] * serve[0], "every lane at step 255")
    lib = _lib_paged(q, pk, pv, tab, st, scale)
    torch.cuda.synchronize()
    log(f"  paged_decode_attention library gather + SDPA vs plain: "
        f"max_abs_err "
        f"{max_err(lib, KPA.paged_decode_attention_plain(q, pk, pv, tab, st, scale)):.3e}")
    plain_ms = time_ms(lambda: KPA.paged_decode_attention_plain(
        q, pk, pv, tab, st, scale), iters=20)
    lib_ms = time_ms(lambda: _lib_paged(q, pk, pv, tab, st, scale),
                     iters=20)
    log(f"  paged_decode_attention at the serving shape: plain "
        f"{plain_ms:.4f} ms, library gather + SDPA {lib_ms:.4f} ms")
    return {"paged_decode_attention": dict(
        max_abs_err=max(errs), plain_ms=plain_ms, library_ms=lib_ms,
        library="gather to [R,H,T,Dh] + SDPA with the step mask",
        launch_alone_ms=launch_alone_ms, by_step=by_step, **main)}


def phase_kernels():
    entries = {"layer_norm": _ln_entry()}
    entries["sdpa_short"] = _attn_entry(
        "sdpa_short", KA.sdpa_short, KA.sdpa_short_plain,
        [(BATCH, 8, 512, 512, 64, False), (BATCH, 8, 512, 512, 64, True)],
        (BATCH, 8, 512, 64), tf32=True)
    entries["flash_attention"] = _attn_entry(
        "flash_attention", KA.flash_attention, KA.flash_attention_plain,
        [(BATCH, 8, 1024, 1024, 64, False),
         (BATCH, 8, 1024, 1024, 64, True),
         (1, 8, 256, 1024, 64, True),      # tq < tk, bottom-right
         (1, 8, 1024, 256, 64, True)],     # tq > tk: fully masked rows
        (BATCH, 8, 1024, 64), tf32=True)
    entries["flash_attention"]["non_square"] = _flash_non_square_entry()
    entries.update(_xent_entries())
    residual = _attn_bwd_entries()
    for name in ("sdpa_short", "flash_attention"):
        entries[name]["residual"] = residual.pop(name)
    entries.update(residual)
    for name, e in _bf16_line(_attn_bf16_entries()).items():
        entries[name]["bf16"] = e
    entries.update(_fused_entries())
    for name, e in _fused_bf16_entries().items():
        entries[name]["bf16"] = e
    entries.update(_paged_entries())
    return entries


def _xent_case(n, v, dtype, seed, ignored=True, out_of_range=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n, v, device="cuda", generator=g) * 2).to(dtype)
    lab = torch.randint(0, v, (n,), device="cuda", generator=g)
    if ignored:
        lab[::7] = -100
    if out_of_range:
        lab[1] = v + 3
    dloss = torch.rand(n, device="cuda", generator=g)
    return x, lab, dloss


def _dx_ratio(got, want):
    """The largest |got - want| / (atol + rtol |want|) of DX_TOL for
    want's dtype: at most 1 passes."""
    rtol, atol = DX_TOL[want.dtype]
    w = want.float()
    return float(((got.float() - w).abs() / (atol + rtol * w.abs())).max())


def _xent_faults(x, lab, dloss, eps, wdx):
    """The plain backward `wdx` with a planted fault: each (what, dx)."""
    g = torch.where(lab == -100, torch.zeros_like(dloss), dloss)[:, None]
    shift = DX_LSE_SHIFT[wdx.dtype]
    xf = x.float()
    sm = torch.softmax(xf, dim=1)
    yield (f"lse off by {shift:g}", (wdx.float() + math.expm1(-shift)
                                      * sm * g).to(wdx.dtype))
    # what a cluster that merged only its first CTAs' (max, sum) pairs
    # would write (a row of one column has no half)
    if x.shape[1] > 1:
        half = torch.logsumexp(xf[:, :x.shape[1] // 2], dim=1, keepdim=True)
        yield ("lse from the first half of the row only",
               (wdx.float() + (torch.exp(xf - half) - sm) * g).to(wdx.dtype))
        del half
    del sm, xf
    if eps:
        yield ("eps/V term dropped",
               (wdx.float() + eps / x.shape[1] * g).to(wdx.dtype))


def _xent_fwd_faults(x, lab, eps, wloss):
    """The plain forward's loss with a planted fault: each (what, loss).
    At V 1 every loss is 0 and no fault shows."""
    v = x.shape[1]
    if v == 1:
        return
    inside = (lab >= 0) & (lab < v)
    yield ("label read from its neighbour's column", KX.xent_forward_plain(
        x, torch.where(inside, (lab + 1) % v, lab), eps)[0])
    if eps:
        yield ("eps term dropped", KX.xent_forward_plain(x, lab, 0.0)[0])


def _xent_fwd_plan(v, dtype):
    """The threads a row that `xent_fwd` takes for rows of v columns: 1-32
    lanes of a warp, or 256 (a block)."""
    fn = build.library("xent").xent_fwd_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(v, int(dtype == torch.bfloat16))


def _xent_fwd_with(x, lab, eps, lanes, unroll=8):
    """The xent forward kernel on a given plan (`lanes` threads a row; a
    block a row, 256, with `unroll` 16-byte loads in flight a thread),
    called past the wrapper (its launch counter does not move): for
    timing the plans."""
    fn = build.library("xent").xent_fwd_with
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    loss = torch.empty(x.shape[0], device=x.device)
    lse = torch.empty_like(loss)
    err = fn(x.data_ptr(), lab.data_ptr(), loss.data_ptr(), lse.data_ptr(),
             x.shape[0], x.shape[1], eps, -100,
             int(x.dtype == torch.bfloat16), lanes, unroll,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"xent_fwd_with lanes {lanes}: CUDA error {err}"
    return loss, lse


def _xent_empty_ms(blocks):
    """An empty kernel's launch of `blocks` blocks of 256 threads in
    clusters of one, as the xent backward launches its CTAs at small V,
    timed as the kernels are."""
    fn = build.library("xent").xent_empty
    fn.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        err = fn(blocks, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"xent_empty: CUDA error {err}"
    return time_ms(run, iters=50)


def _xent_fwd_plans():
    """The forward's plans timed against each other at the widths that set
    its crossovers (XENT_PLAN_WIDTHS), 16384 rows, fp32 and
    bf16, eps 0.1: the group of lanes its rule gives (V <= 32), a warp a
    row and a block a row, each checked against the plain version first.
    Returns {dtype: {V: {plan: ms, "chosen": lanes}}}."""
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        res[str(dtype)[6:]] = by_v = {}
        for v in XENT_PLAN_WIDTHS:
            x, lab, _ = _xent_case(TRAIN_TOKENS, v, dtype, 40 + v)
            chosen = _xent_fwd_plan(v, dtype)
            plans = {"warp": 32, "block": 256}
            if v <= 32:
                plans = {f"{chosen} lanes": chosen} | plans
            wloss, wlse = KX.xent_forward_plain(x, lab, LABEL_SMOOTH)
            row = {}
            for name, lanes in plans.items():
                loss, lse = _xent_fwd_with(x, lab, LABEL_SMOOTH, lanes)
                torch.cuda.synchronize()
                err = max(max_err(loss, wloss), max_err(lse, wlse))
                assert err <= XENT_TOL, (v, name, err)
                row[name] = time_ms(lambda: _xent_fwd_with(
                    x, lab, LABEL_SMOOTH, lanes), iters=50)
            by_v[v] = row | {"chosen": chosen}
            log(f"  xent_forward plans [{TRAIN_TOKENS},{v}] "
                f"{str(dtype)[6:]}: " + ", ".join(
                    f"{n} {t:.4f} ms" for n, t in row.items())
                + f"; xent_fwd takes {chosen} threads a row")
            del x, lab, wloss, wlse
    return res


def _xent_plan(v):
    """The cluster size and body that `xent_bwd` takes for rows of v
    columns: (CTAs a row, "staged" or "streamed")."""
    fn = build.library("xent").xent_bwd_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    cluster, staged = ctypes.c_int(), ctypes.c_int()
    fn(v, ctypes.byref(cluster), ctypes.byref(staged))
    return cluster.value, "staged" if staged.value else "streamed"


def _xent_bwd_with(x, lab, dloss, eps, cluster, staged):
    """The xent backward kernel at a given cluster size and body, called
    past the wrapper (its launch counter does not move): for timing the
    cluster sizes."""
    fn = build.library("xent").xent_bwd_with
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dx = torch.empty_like(x)
    err = fn(x.data_ptr(), lab.data_ptr(), dloss.data_ptr(), dx.data_ptr(),
             x.shape[0], x.shape[1], eps, -100,
             int(x.dtype == torch.bfloat16), cluster, int(staged),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"xent_bwd_with cluster {cluster}: CUDA error {err}"
    return dx


def _xent_timing(n, v, dtype, eps, plain_iters):
    """Both kernels at [n, v] in `dtype`: each one's ms, its plain
    version's (over `plain_iters` calls), the library's (F.cross_entropy,
    and its backward under autograd) and the bound (each input read once,
    each output written once), all in ms; for the backward also every
    cluster size's time (staged), the streamed body's at the chosen size
    and a copy of x's. Returns (forward, backward)."""
    x, lab, dloss = _xent_case(n, v, dtype, 30, ignored=False)
    esize = x.element_size()

    def lib_fwd():
        return torch.nn.functional.cross_entropy(
            x, lab, reduction="none", label_smoothing=eps,
            ignore_index=-100)

    lanes = _xent_fwd_plan(v, dtype)
    fwd = dict(ms=time_ms(lambda: KX.xent_forward(x, lab, eps)),
               plain_ms=time_ms(lambda: KX.xent_forward_plain(x, lab, eps),
                                iters=plain_iters),
               library_ms=time_ms(lib_fwd), shape=[n, v],
               plan=f"{lanes} threads a row")
    # operations per element: max/exp/sum/add
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        esize * n * v + 8 * n + 8 * n, 5 * n * v)
    if lanes == 256:
        # the block a row at 1, 2, 4 and 8 16-byte loads in flight a thread
        fwd["unroll_ms"] = {str(u): time_ms(lambda: _xent_fwd_with(
            x, lab, eps, 256, u)) for u in XENT_UNROLLS}
    else:
        # an empty launch of one 256-thread CTA a row (the backward's
        # grid here) and of the forward's own grid
        fwd["empty_ms"] = {
            "one CTA a row": _xent_empty_ms(n),
            "the forward's grid": _xent_empty_ms(-(-n // (256 // lanes)))}
    cluster, body = _xent_plan(v)
    ms = time_ms(lambda: KX.xent_backward(x, lab, dloss, eps))
    plain_ms = time_ms(lambda: KX.xent_backward_plain(x, lab, dloss, eps),
                       iters=plain_iters)
    by_cluster = {c: time_ms(lambda: _xent_bwd_with(x, lab, dloss, eps, c,
                                                    True))
                  for c in XENT_CLUSTERS}
    streamed = time_ms(lambda: _xent_bwd_with(x, lab, dloss, eps, cluster,
                                              False))
    # what the card's memory gives a read and a write of the same bytes
    copy = torch.empty_like(x)
    copy_ms = time_ms(lambda: copy.copy_(x))
    del copy
    xr = x.detach().requires_grad_()
    lib_loss = torch.nn.functional.cross_entropy(
        xr, lab, reduction="none", label_smoothing=eps, ignore_index=-100)
    lib_dx = torch.autograd.grad(lib_loss, xr, dloss, retain_graph=True)[0]
    lib_errs = (max_err(lib_fwd(), KX.xent_forward_plain(x, lab, eps)[0]),
                max_err(lib_dx, KX.xent_backward_plain(x, lab, dloss, eps)))
    del lib_dx
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_loss, xr, dloss,
                                                 retain_graph=True))
    del lib_loss, xr
    bms, by = bound_ms(2 * esize * n * v + 8 * n + 4 * n, 9 * n * v)
    tag = f"[{n},{v}] {str(dtype)[6:]} eps={eps}"
    probe = ("; a block a row at 1/2/4/8 16-byte loads in flight "
             + " / ".join(f"{t:.4f}" for t in fwd["unroll_ms"].values())
             + " ms") if "unroll_ms" in fwd else (
        "; an empty launch: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in fwd["empty_ms"].items()))
    log(f"  xent_forward {tag}: kernel {fwd['ms']:.4f} ms ({fwd['plan']}), "
        f"plain {fwd['plain_ms']:.4f} ms, library F.cross_entropy "
        f"{fwd['library_ms']:.4f} ms, bound {fwd['bound_ms']:.6f} ms "
        f"({fwd['bound_by']})" + probe)
    log(f"  xent_backward {tag}: kernel {ms:.4f} ms ({cluster} CTAs a row, "
        f"{body}), plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by}), "
        f"library F.cross_entropy backward {lib_ms:.4f} ms, a copy of x "
        f"(torch copy_) {copy_ms:.4f} ms; staged at 1/2/4/8 CTAs a row "
        + " / ".join(f"{by_cluster[c]:.4f}" for c in XENT_CLUSTERS)
        + f" ms; streamed at {cluster} {streamed:.4f} ms")
    log(f"  xent library F.cross_entropy vs plain {tag}: forward "
        f"max_abs_err {lib_errs[0]:.3e}, backward {lib_errs[1]:.3e}")
    return fwd, dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=lib_ms, copy_ms=copy_ms, cluster=cluster,
                     body=body, shape=[n, v],
                     cluster_ms={str(c): t for c, t in by_cluster.items()},
                     streamed_ms=streamed)


def _xent_entries():
    """Both xent kernels against their plain versions: the training
    path's [B*256, 32000] fp32 logits, the MNIST head's [4096, 10], then
    edge cases; the backward's dx must repeat bit for bit on a second
    launch. Then both timed (_xent_timing) at the training shape in fp32
    and in bf16 (AMP's logits) and at the MNIST head's."""
    n_main = TRAIN_TOKENS
    cases = [(n_main, TRAIN["vocab"], torch.float32, LABEL_SMOOTH, False,
              False),
             (n_main, TRAIN["vocab"], torch.float32, 0.0, True, True),
             # the MNIST head as phase 10 trains it: rows of 40 bytes,
             # each but the first off a 16-byte boundary, one CTA a row
             (MNIST_BATCH, 10, torch.float32, 0.0, False, False),
             (33, 1000, torch.float32, LABEL_SMOOTH, True, True),
             (64, TRAIN["vocab"], torch.bfloat16, LABEL_SMOOTH, True, True),
             # rows that start off a 16-byte boundary: fp32 V % 4, bf16
             # V % 8
             (64, 1001, torch.float32, LABEL_SMOOTH, True, True),
             (64, 1003, torch.bfloat16, LABEL_SMOOTH, True, True),
             (64, 10, torch.float32, 0.0, True, True),   # the MNIST head
             # the forward's plans on each side of its crossovers: a lane
             # a row, the widest group of lanes, a warp a row from its
             # narrowest to its widest, a block a row
             (64, 1, torch.float32, 0.0, True, True),
             (64, 31, torch.bfloat16, LABEL_SMOOTH, True, True),
             (64, 32, torch.float32, LABEL_SMOOTH, True, True),
             (64, 33, torch.float32, LABEL_SMOOTH, True, True),
             (64, 4096, torch.float32, LABEL_SMOOTH, True, True),
             (64, 4097, torch.float32, LABEL_SMOOTH, True, True),
             (64, 8192, torch.bfloat16, LABEL_SMOOTH, True, True),
             (64, 8193, torch.bfloat16, LABEL_SMOOTH, True, True),
             # eight CTAs a row with the widest staged slices, then a row
             # too wide for them: the streamed body
             (64, 300000, torch.float32, LABEL_SMOOTH, True, True),
             (64, 524288, torch.float32, LABEL_SMOOTH, True, True)]
    errs = {"fwd": [], "bwd": []}
    bodies, fwd_plans = set(), set()
    for i, (n, v, dtype, eps, ignored, oor) in enumerate(cases):
        x, lab, dloss = _xent_case(n, v, dtype, 30 + i, ignored, oor)
        loss, lse = KX.xent_forward(x, lab, eps)
        fwd_again = KX.xent_forward(x, lab, eps)
        dx = KX.xent_backward(x, lab, dloss, eps)
        again = KX.xent_backward(x, lab, dloss, eps)
        wloss, wlse = KX.xent_forward_plain(x, lab, eps)
        wdx = KX.xent_backward_plain(x, lab, dloss, eps)
        torch.cuda.synchronize()
        ef = max(max_err(loss, wloss), max_err(lse, wlse))
        eb = max_err(dx, wdx)
        rb = _dx_ratio(dx, wdx)
        same = bool(torch.equal(dx, again))
        fwd_same = bool(torch.equal(loss, fwd_again[0])
                        and torch.equal(lse, fwd_again[1]))
        finite = bool(torch.isfinite(loss).all() and torch.isfinite(dx).all())
        rtol, atol = DX_TOL[dtype]
        plan = _xent_plan(v)
        bodies.add(plan[1])
        lanes = _xent_fwd_plan(v, dtype)
        fwd_plans.add("lanes" if lanes < 32 else "warp" if lanes == 32
                      else "block")
        log(f"  xent [{n},{v}] {str(dtype)[6:]} eps={eps} ignored={ignored} "
            f"out_of_range={oor}: forward ({lanes} threads a row) "
            f"max_abs_err {ef:.3e} (tol {XENT_TOL:g}), second launch bit "
            f"for bit {fwd_same}; backward ({plan[0]} CTAs a row, {plan[1]}) "
            f"max_abs_err {eb:.3e}, worst |dx - plain| / ({atol:g} + "
            f"{rtol:g}|plain|) {rb:.3e} (<= 1 passes) finite {finite}, "
            f"second launch bit for bit {same}")
        assert finite and ef <= XENT_TOL and rb <= 1 and same, (ef, rb, same)
        assert fwd_same, f"xent_forward [{n},{v}]: other bits on a repeat"
        for fault, bad in _xent_fwd_faults(x, lab, eps, wloss):
            fe = max_err(bad, wloss)
            log(f"    planted forward fault, {fault}: max_abs_err {fe:.3e} "
                f"(must exceed {XENT_TOL:g})")
            assert fe > XENT_TOL, f"the loss check cannot see a {fault}"
        del again, fwd_again
        for fault, bad in _xent_faults(x, lab, dloss, eps, wdx):
            rf = _dx_ratio(bad, wdx)
            log(f"    planted fault, {fault}: worst ratio {rf:.3e} "
                f"(must exceed 1)")
            assert rf > 1, f"the dx check cannot see a {fault}"
            del bad
        errs["fwd"].append(ef)
        if dtype == torch.float32:
            errs["bwd"].append(eb)
    assert bodies == {"staged", "streamed"}, bodies
    assert fwd_plans == {"lanes", "warp", "block"}, fwd_plans
    del x, lab, dloss, loss, lse, dx, wloss, wlse, wdx
    plans = _xent_fwd_plans()
    # (n, v, dtype, eps, the plain versions' iterations)
    vocab = TRAIN["vocab"]
    (fwd, bwd), (fwd_bf16, bwd_bf16), (fwd_mnist, bwd_mnist) = (
        _xent_timing(*point) for point in (
            (n_main, vocab, torch.float32, LABEL_SMOOTH, 5),
            (n_main, vocab, torch.bfloat16, LABEL_SMOOTH, 5),
            (MNIST_BATCH, 10, torch.float32, 0.0, 20)))
    return dict(
        xent_forward=dict(max_abs_err=max(errs["fwd"]), **fwd,
                          bf16=fwd_bf16, mnist=fwd_mnist, plans_ms=plans),
        xent_backward=dict(max_abs_err=max(errs["bwd"]), **bwd,
                           bf16=bwd_bf16, mnist=bwd_mnist))


def phase_lookup_table():
    """lookup_table and its grad op on the card with ids out of range
    (11 and -11 over 10 rows) and a negative id (-1, the last row),
    against the same ops on the CPU: NaN rows in the same places, the
    other rows and W@GRAD equal. Then a kernel launch and a check on its
    result: an out-of-range index asserting on the device would have left
    the CUDA context unusable."""
    rs = np.random.RandomState(SEED)
    w = rs.randn(10, 3).astype("float32")
    ids = np.array([[11], [-1], [3], [-11], [0], [3]], "int64")
    cot = rs.randn(len(ids), 3).astype("float32")
    prog = pf.Program()
    blk = prog.global_block
    blk.create_var(name="w", shape=w.shape, dtype="float32")
    blk.create_var(name="ids", shape=ids.shape, dtype="int64")
    op = blk.append_op("lookup_table", {"W": ["w"], "Ids": ["ids"]},
                       {"Out": ["out"]}, {"padding_idx": -1})
    got = {}
    for dev in ("cuda", "cpu"):
        env = {"w": torch.from_numpy(w).to(dev),
               "ids": torch.from_numpy(ids).to(dev),
               "out@GRAD": torch.from_numpy(cot).to(dev)}
        registry.run_op(op, env, torch.device(dev))
        for gop in registry.make_grad_ops(op):
            registry.run_op(gop, env, torch.device(dev))
        got[dev] = (env["out"].cpu().numpy(), env["w@GRAD"].cpu().numpy())
    torch.cuda.synchronize()
    (out, dw), (wout, wdw) = got["cuda"], got["cpu"]
    nan_rows = np.isnan(out).all(axis=1)
    log(f"  lookup_table on the card: NaN rows {np.flatnonzero(nan_rows)} "
        f"(CPU {np.flatnonzero(np.isnan(wout).all(axis=1))}), W@GRAD rows "
        f"touched {np.flatnonzero(np.abs(dw).sum(axis=1))}")
    assert out.shape == wout.shape == (len(ids), 3)
    assert np.array_equal(np.isnan(out), np.isnan(wout))
    assert list(np.flatnonzero(nan_rows)) == [0, 3]
    np.testing.assert_array_equal(out[~nan_rows], wout[~nan_rows])
    np.testing.assert_array_equal(out[1], w[9])
    np.testing.assert_allclose(dw, wdw, rtol=0, atol=1e-6)
    assert set(np.flatnonzero(np.abs(dw).sum(axis=1))) == {0, 3, 9}
    x, s, b, err = _ln_case(64, 512, seed=5)
    log(f"  after it, layer_norm [64,512] on the card: max_abs_err "
        f"{err:.3e} (tol {LN_TOL:g})")
    assert err <= LN_TOL, err


def phase_step_key():
    """The step key on the card: a program of one uniform_random op draws
    anew on each run of one scope; run_steps on it names why it runs
    eagerly (a draw on a CPU generator would repeat on every replay of a
    graph) and returns on the card what three run calls draw; a kernel
    launched afterwards agrees with its plain version."""
    gpu = pf.Executor(pf.CUDAPlace(0))
    prog = pf.Program()
    prog.random_seed = SEED
    prog.global_block.append_op(
        "uniform_random", {}, {"Out": ["u"]},
        {"shape": [4096], "dtype": "float32", "min": -1.0, "max": 1.0,
         "seed": 0})

    def draws(scope, n):
        return [gpu.run(prog, fetch_list=["u"], scope=scope,
                        return_numpy=False)[0] for _ in range(n)]

    a, b = draws(pf.Scope(), 2)
    want = torch.stack(draws(pf.Scope(), 3))
    got = gpu.run_steps(prog, feed={}, fetch_list=["u"], steps=3,
                        scope=pf.Scope(), return_numpy=False)[0]
    reason = gpu.last_run_steps_fallback
    torch.cuda.synchronize()
    log(f"  step key: two runs differ in {int((a != b).sum())} of "
        f"{a.numel()} values; run_steps: {reason!r}; on {got.device}, "
        f"equal to three runs: {bool(torch.equal(got, want))}")
    assert a.is_cuda and not torch.equal(a, b)
    assert reason is not None and "uniform_random" in reason, reason
    assert got.is_cuda and torch.equal(got, want)
    _dropout_mask_parity()
    x, s, b, err = _ln_case(64, 512, seed=6)
    log(f"  after it, layer_norm [64,512] on the card: max_abs_err "
        f"{err:.3e} (tol {LN_TOL:g})")
    assert err <= LN_TOL, err


# ---------------------------------------------------------------------------
def _unrolled(prog, steps):
    """`prog` with its while op replaced by `steps` passes of its body,
    so step temporaries (the logits) can be fetched."""
    p = prog.clone()
    g = p.global_block
    i = next(k for k, op in enumerate(g.ops) if op.type == "while")
    sub = g.ops[i].attrs["sub_block"]
    for name, var in sub.vars.items():
        g.vars.setdefault(name, var)
    g.ops[i:i + 1] = list(sub.ops) * steps
    return p


def _logits_name(prog):
    for op in prog.blocks[1].ops:
        if op.type == "mul" and op.inputs["Y"] == ["logits.w"]:
            return op.outputs["Out"][0]
    raise KeyError("logits.w")


def _serve(prog, out, exe, scope, src):
    srv = serving.GenerationServer(prog, out, executor=exe, scope=scope,
                                   end_id=MODEL["end_id"],
                                   max_batch_size=BATCH, max_wait_ms=5.0,
                                   start=False)
    results = [None] * len(src)

    def call(i):
        results[i] = srv.generate(src[i], timeout=600)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(src))]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while srv.stats()["requests"] < len(src):
            assert time.monotonic() < deadline, "requests never queued"
            time.sleep(0.005)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        srv.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive(), "generate() did not return"
        wall = time.monotonic() - t0
        st = srv.stats()
    finally:
        srv.close()
    return np.stack(results), st, wall


def _wall_s(exe, prog, fetch, scope, src, reps=3):
    """Best-of-`reps` seconds of one batch, ending in a synchronize."""
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        exe.run(prog, feed={"src_ids": src}, fetch_list=[fetch], scope=scope)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        best = dt if best is None else min(best, dt)
    return best


@functools.cache
def _port_kernel_names():
    """The __global__ functions the port's CUDA sources (csrc/) define,
    and the namespaces they define: the rest of a profile is PyTorch's
    and its libraries'."""
    names, spaces = set(), {""}
    for f in build.CSRC.glob("*.cu*"):
        text = f.read_text()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", text))
        spaces.update(re.findall(r"^namespace (\w+) \{", text, re.M))
    return names, spaces


def _port_kernel(name):
    """The short name of one of the port's kernels, or None."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "").split("(")[0]
    space, _, ident = n.split("<")[0].rpartition("::")
    names, spaces = _port_kernel_names()
    return n if ident in names and space in spaces else None


PROFILE_WARMUP = 32  # sleep kernels run under the profiler before `run`


def _device_profile(tag, run, match=None, host=True):
    """`run()` once under torch.profiler: its wall time, the card's busy
    time (device-side activities: kernels, copies, memsets), the idle
    share, the kernels that took most of it, every kernel of the port's
    with its launches, and (`match`) the device time of the activities
    whose name holds that string. Returns (run's result, the numbers).

    The profiler can miss the first activities after it starts (an eager
    fused step's first 25, in one call), so PROFILE_WARMUP short sleep
    kernels and 20 ms of host time come first; they are left out of
    every number, and how many of them were recorded is kept. `host`
    False records the device's activities only: a run of many thousand
    host ops (a whole serving wave) then takes seconds, not minutes, to
    read back; every number above comes from the device's side. `match`
    may also be a tuple of strings, any of which selects an activity."""
    from torch.profiler import ProfilerActivity, profile

    kinds = [ProfilerActivity.CUDA]
    if host:
        kinds.append(ProfilerActivity.CPU)
    with profile(activities=kinds) as prof:
        for _ in range(PROFILE_WARMUP):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        t0 = time.monotonic()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    acts = [e for e in prof.events() if e.device_type.name == "CUDA"]
    warm = sum("spin_kernel" in e.name for e in acts)
    acts = [e for e in acts if "spin_kernel" not in e.name]
    busy_ms = sum(e.time_range.elapsed_us() for e in acts) / 1e3
    by_name = {}
    for e in acts:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    port = {}  # short name: [ms, launches]
    for e in acts:
        n = _port_kernel(e.name)
        if n is not None:
            x = port.setdefault(n, [0.0, 0])
            x[0] += e.time_range.elapsed_us() / 1e3
            x[1] += 1
    res = dict(profiled_wall_ms=wall_ms,
               device_busy_ms=busy_ms if acts else None,
               idle_share=1 - busy_ms / wall_ms if acts else None,
               device_activities=len(acts), warmup_recorded=warm,
               top_kernels_ms={n[:60]: ms for n, ms in top},
               port_kernels_ms={n: ms for n, (ms, _) in port.items()},
               port_kernel_launches={n: c for n, (_, c) in port.items()})
    if match is not None:
        marks = (match,) if isinstance(match, str) else tuple(match)
        res["matched_ms"] = sum(ms for n, ms in by_name.items()
                                if any(m in n for m in marks))
    if acts:
        log(f"{tag}: profiled wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms, idle share {res['idle_share']:.3f}, "
            f"{len(acts)} device activities (and {warm} of the "
            f"{PROFILE_WARMUP} warm-up kernels)")
        for n, ms in top:
            log(f"  {ms:8.2f} ms  {n[:90]}")
        if port:
            log(f"  the port's kernels: " + ", ".join(
                f"{n} {ms:.2f} ms ({c})" for n, (ms, c) in port.items()))
    else:
        log(f"{tag}: the profiler recorded no device time; device busy "
            f"time not measured")
    return out, res


def _profile(exe, prog, out, one, lname, scope, src, steps):
    """Where one batch's time goes: the decode step's time from the
    whole program against its one-step unrolled copy, then one batch
    under torch.profiler."""
    full = _wall_s(exe, prog, out, scope, src)
    first = _wall_s(exe, one, lname, scope, src)
    step_ms = (full - first) / max(steps - 1, 1) * 1e3
    log(f"profile: batch {full * 1e3:.1f} ms, one decode step "
        f"{step_ms:.2f} ms, encoder + set-up {first * 1e3 - step_ms:.1f} ms")
    _, res = _device_profile("profile", lambda: exe.run(
        prog, feed={"src_ids": src}, fetch_list=[out], scope=scope))
    return dict(batch_ms=full * 1e3, step_ms=step_ms,
                encoder_ms=first * 1e3 - step_ms, **res)


def phase_slice(card_name, card):
    main_progs = {}
    with unique_name.guard():
        for seq_len in (512, 1024):
            t0 = time.monotonic()
            main_progs[seq_len] = decode_engine.\
                build_incremental_decode_program(seq_len=seq_len, **MODEL)
            log(f"slice: built decode program seq_len={seq_len} in "
                f"{time.monotonic() - t0:.2f} s "
                f"({sum(len(b.ops) for b in main_progs[seq_len][0].blocks)}"
                f" ops)")
    startup = main_progs[512][1]
    params = [v.name for v in startup.global_block.vars.values()
              if v.persistable]
    startup.random_seed = SEED
    gpu = pf.Executor(pf.CUDAPlace(0))
    cpu = pf.Executor(pf.CPUPlace())
    gscope = pf.Scope()
    gpu.run(startup, scope=gscope)
    cscope = pf.Scope()
    pf.load_numpy_params(cscope, pf.scope_to_numpy(gscope, params),
                         pf.CPUPlace())
    n_params = sum(int(np.prod(gscope._get(n).shape)) for n in params)
    log(f"slice: {len(params)} parameters, {n_params} values, seed {SEED}")

    kernels = (KL.layer_norm, KA.sdpa_short, KA.flash_attention)
    launches = {k.__name__: 0 for k in kernels}
    served = {}
    whole = dict(rows={}, gscope=gscope, cscope=cscope)
    served["_whole_loop"] = whole
    for seq_len, (prog, _, _, out) in main_progs.items():
        src = np.random.RandomState(SEED + seq_len).randint(
            2, MODEL["vocab"], (BATCH, seq_len)).astype("int64")
        # one direct batch first: the card's first use of cuBLAS and the
        # allocator is set-up, not serving
        t0 = time.monotonic()
        gpu.run(prog, feed={"src_ids": src}, fetch_list=[out], scope=gscope)
        torch.cuda.synchronize()
        log(f"slice seq_len={seq_len}: warm-up batch (Executor.run) "
            f"{time.monotonic() - t0:.3f} s")
        for k in kernels:
            k.launches = 0
        toks, st, wall = _serve(prog, out, gpu, gscope, src)
        counts = {k.__name__: k.launches for k in kernels}
        for n, c in counts.items():
            launches[n] += c
        log(f"slice seq_len={seq_len}: stats batches {st['batches']} rows "
            f"{st['rows']} padded_rows {st['padded_rows']}; launches "
            f"{counts}")
        assert st["batches"] == 1 and st["rows"] == BATCH \
            and st["padded_rows"] == BATCH, st
        steps = int(serving.count_generated_tokens(
            toks, MODEL["end_id"]).max())
        attn = "sdpa_short" if seq_len <= 512 else "flash_attention"
        want = {"layer_norm": 2 * MODEL["n_layers"]
                + 3 * MODEL["n_layers"] * steps,
                "sdpa_short": 0, "flash_attention": 0}
        want[attn] = MODEL["n_layers"]
        assert counts == want, (counts, want, steps)

        # the same program and weights on the CPU, plain versions
        t0 = time.monotonic()
        ref = cpu.run(prog, feed={"src_ids": src}, fetch_list=[out],
                      scope=cscope)[0]
        cpu_s = time.monotonic() - t0
        ref = serving.apply_eos_sentinel(ref, MODEL["end_id"])
        lname = _logits_name(prog)
        one = _unrolled(prog, 1)
        lg = gpu.run(one, feed={"src_ids": src}, fetch_list=[lname],
                     scope=gscope)[0]
        lc = cpu.run(one, feed={"src_ids": src}, fetch_list=[lname],
                     scope=cscope)[0]
        lerr = float(np.abs(lg - lc).max())
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            lt = gpu.run(one, feed={"src_ids": src}, fetch_list=[lname],
                         scope=gscope)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        terr = float(np.abs(lt - lc).max())
        log(f"slice seq_len={seq_len}: first-step logits max_abs_err "
            f"{lerr:.3e} (tol {LOGITS_TOL:g}); control with TF32 on "
            f"{terr:.3e}; CPU reference run {cpu_s:.1f} s")
        assert np.isfinite(lg).all() and lerr <= LOGITS_TOL, lerr
        assert terr > LOGITS_TOL, "the logits check cannot see TF32"
        assert toks.shape == (BATCH, MODEL["max_out_len"])
        ties = 0
        for r in range(BATCH):
            diff = np.nonzero(toks[r] != ref[r])[0]
            if not len(diff):
                continue
            pos = int(diff[0])
            lgt = cpu.run(_unrolled(prog, pos), feed={"src_ids": src},
                          fetch_list=[lname], scope=cscope)[0][r]
            top2 = np.sort(lgt)[-2:]
            margin = float(top2[1] - top2[0])
            log(f"slice seq_len={seq_len}: row {r} diverges at position "
                f"{pos}: top-2 logit margin {margin:.3e}")
            assert margin < LOGITS_TOL, "token mismatch is not a tie"
            ties += 1
        rps = BATCH / wall
        log(f"slice seq_len={seq_len}: {BATCH} requests in one batch, "
            f"{steps} decode steps, tokens equal CPU reference in "
            f"{BATCH - ties}/{BATCH} rows ({ties} ties); "
            f"{rps:.2f} requests/s, p50 latency "
            f"{st['latency_ms']['p50']:.1f} ms on {card_name} ({card})")
        served[seq_len] = dict(requests_per_s=rps,
                               p50_ms=st["latency_ms"]["p50"],
                               steps=steps, ties=ties, logits_err=lerr,
                               logits_err_tf32=terr)
        # phase 16's greedy whole loop reads these rows and weights
        whole["rows"][seq_len] = (src, toks, (prog, lname))
        if seq_len == 1024:
            served[seq_len]["profile"] = _profile(
                gpu, prog, out, one, lname, gscope, src, steps)
    for k in kernels:
        assert launches[k.__name__] > 0, f"{k.__name__} never launched"
    return launches, served


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@contextlib.contextmanager
def _relu_masks(masks):
    """While open, the relu op takes its mask from `masks` (input var
    name -> bool array) in place of its input's sign; relu_grad
    recomputes relu under its vjp, so its mask is pinned too. None:
    relu as it is."""
    if masks is None:
        yield
        return
    info = registry.get_op_info("relu")
    kernel = info.kernel

    def pinned(ctx):
        # a recomputed relu (input `<name>@RECOMP<i>`) takes its forward's
        x = ctx.input("X")
        m = torch.from_numpy(masks[ctx.op.inputs["X"][0].split("@")[0]])
        return x * m.to(x.device, x.dtype)

    info.kernel = pinned
    try:
        yield
    finally:
        info.kernel = kernel


def _train_setup(tag, seq_len, batch, fused=False, dropout_rate=0.0,
                 build=None):
    """Transformer-base's training program at `seq_len` (at
    `dropout_rate`), built (by `build()`, or build_program) with the
    fused-block switch (FUSE_KNOB) set or cleared around the build, its
    startup run on the card once, and the feeds: `batch` rows of random
    token ids and their first 2 rows for the parity step."""
    prev = os.environ.pop(FUSE_KNOB, None)
    if fused:
        os.environ[FUSE_KNOB] = "1"
    t0 = time.monotonic()
    try:
        with unique_name.guard():
            main, startup, cost = build() if build else \
                transformer.build_program(
                    seq_len=seq_len, **dict(TRAIN, dropout_rate=dropout_rate))
    finally:
        os.environ.pop(FUSE_KNOB, None)
        if prev is not None:
            os.environ[FUSE_KNOB] = prev
    ops = [op.type for op in main.global_block.ops]
    log(f"{tag}: built the training program in "
        f"{time.monotonic() - t0:.2f} s ({len(ops)} ops, "
        f"{ops.count('adam')} adam, startup "
        f"{len(startup.global_block.ops)} ops)")
    names = [n for n, v in startup.global_block.vars.items()
             if v.persistable]
    startup.random_seed = SEED
    gpu = pf.Executor(pf.CUDAPlace(0))
    scope0 = pf.Scope()
    t0 = time.monotonic()
    gpu.run(startup, scope=scope0)
    torch.cuda.synchronize()
    state0 = pf.scope_to_numpy(scope0, names)
    del scope0
    n_params = sum(int(np.prod(v.shape)) for v in main.all_parameters())
    log(f"{tag}: startup on the card {time.monotonic() - t0:.2f} s; "
        f"{len(main.all_parameters())} parameters, {n_params} values, "
        f"{len(names)} persistables with the optimizer state, seed {SEED}")

    def fresh(place):
        sc = pf.Scope()
        pf.load_numpy_params(sc, state0, place)
        return sc

    rs = np.random.RandomState(SEED)
    feed = {k: rs.randint(0, TRAIN["vocab"], (batch, seq_len)).astype(
        "int64") for k in ("src_ids", "tgt_ids", "label")}
    return dict(main=main, cost=cost, ops=ops, names=names, state0=state0,
                gpu=gpu, cpu=pf.Executor(pf.CPUPlace()), fresh=fresh,
                feed=feed, small={k: v[:2] for k, v in feed.items()},
                m1={n.split("_moment1")[0]: n for n in names
                    if "_moment1" in n})


def _parity_errs(run, ref, grads):
    """Loss relative error, then {grad: (grad err, Moment1 err)}
    norm-wise, for fetches [loss, grads..., their Moment1s..., ...]."""
    k = len(grads)
    loss = abs(float(run[0][0]) - float(ref[0][0])) / abs(float(ref[0][0]))
    return loss, {g: (_rel(run[1 + i], ref[1 + i]),
                      _rel(run[1 + k + i], ref[1 + k + i]))
                  for i, g in enumerate(grads)}


def _train_steps(tag, s, seq_len, batch, want, card_name, card):
    """The main path: TRAIN_STEPS full-batch Adam steps on the card from
    the seeded weights, every launch counter set to 0 just before and
    read just after (they must equal `want`), the loss finite at each:
    the step time (best of the steps after the first but the last two),
    target tokens/s and peak memory; the last two steps run under the
    profiler, each kernel's launches a step taken as the larger count of
    the two (the profiler may lose a record of either). Then the same
    steps through Executor.run_steps (`_run_steps_leg`). Returns (the
    eager leg's launches by kernel, results)."""
    gpu, main, cost, feed = s["gpu"], s["main"], s["cost"], s["feed"]
    scope = s["fresh"](pf.CUDAPlace(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for kern in TRAIN_KERNELS:
        kern.launches = 0
    losses, times, profs = [], [], []
    for step in range(TRAIN_STEPS):
        if step >= TRAIN_STEPS - 2:
            loss, prof = _device_profile(f"{tag} profile", lambda: gpu.run(
                main, feed=feed, fetch_list=[cost], scope=scope)[0])
            profs.append(prof["port_kernel_launches"])
        else:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            loss = gpu.run(main, feed=feed, fetch_list=[cost],
                           scope=scope)[0]
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        losses.append(float(loss[0]))
        assert np.isfinite(loss).all(), (step, loss)
    step_trace = {n: max(p.get(n, 0) for p in profs)
                  for n in set().union(*profs)}
    counts = {kern.__name__: kern.launches for kern in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    del scope
    log(f"{tag}: {TRAIN_STEPS} Adam steps at batch {batch}, losses "
        + ", ".join(f"{x:.6f}" for x in losses) + f"; launches {counts} "
        f"(layer_norm: {s['ops'].count('layer_norm')} forward ops a step; "
        f"their grads launch nothing)")
    assert counts == want, (counts, want)
    best = min(times[1:])
    tokens = batch * seq_len
    log(f"{tag}: step {best * 1e3:.1f} ms (best of {len(times) - 1} after "
        f"a {times[0]:.2f} s warm-up step), {tokens / best:.0f} target "
        f"tokens/s, peak memory {peak / 2 ** 30:.2f} GiB allocated, "
        f"{peak_reserved / 2 ** 30:.2f} GiB reserved on {card_name} "
        f"({card})")
    steps = _run_steps_leg(tag, s, tokens, want, losses, step_trace)
    log(f"{tag}: run_steps against eager: step {steps['step_ms']:.1f} "
        f"against {best * 1e3:.1f} ms, {steps['target_tokens_per_s']:.0f} "
        f"against {tokens / best:.0f} target tokens/s; busy "
        f"{steps['busy_ms_per_step']} against {prof['device_busy_ms']} ms "
        f"a step, idle share {steps['profile']['idle_share']} against "
        f"{prof['idle_share']}; peak allocated "
        f"{steps['peak_memory_bytes'] / 2 ** 30:.2f} against "
        f"{peak / 2 ** 30:.2f} GiB, reserved "
        f"{steps['peak_reserved_bytes'] / 2 ** 30:.2f} against "
        f"{peak_reserved / 2 ** 30:.2f} GiB (the capturing call: "
        f"{steps['capture_peak_memory_bytes'] / 2 ** 30:.2f} allocated, "
        f"{steps['capture_peak_reserved_bytes'] / 2 ** 30:.2f} reserved; "
        f"a replay's memory lies in the graph's pool, counted reserved, "
        f"not allocated) on {card_name} ({card})")
    return counts, dict(
        seq_len=seq_len, batch=batch, losses=losses,
        warmup_step_s=times[0], step_ms=best * 1e3,
        step_ms_all=[t * 1e3 for t in times],
        target_tokens_per_s=tokens / best, peak_memory_bytes=peak,
        peak_reserved_bytes=peak_reserved, profile=prof, run_steps=steps)


def _run_steps_leg(tag, s, tokens, want, eager_losses, eager_step_trace):
    """The main path through Executor.run_steps: TRAIN_STEPS steps a call
    from a fresh scope with the same seeded weights and feed as the eager
    leg. The first call runs step 1 eagerly, captures one step in a CUDA
    graph and replays it; the second, timed, and the third, under
    torch.profiler, start again from the seeded weights loaded into the
    same scope (the graph's buffers take them) and must capture nothing.
    Each call's losses must match the eager leg's within STEPS_RTOL.

    Launches, measured two ways. The wrappers' counters, set to 0 before
    the first call, must read two steps' worth of `want` after it (the
    eager step 1 launches each kernel, the capture records each launch
    into the graph once) and must not move over the other calls (a replay
    runs no wrapper). The third call's trace must hold every kernel of
    the port's that the eager leg's profiled step did
    (`eager_step_trace`), and none more than TRAIN_STEPS times as often:
    the profiler loses some records of a graph replay, so the trace is a
    lower bound (what it missed is logged).

    Returns the results: the step time (the timed call's wall time /
    TRAIN_STEPS), target tokens/s, busy ms a step and idle share, the
    launches, peak memory allocated and reserved over the capturing call
    and over the timed one."""
    gpu, main, cost, feed = s["gpu"], s["main"], s["cost"], s["feed"]
    scope = s["fresh"](pf.CUDAPlace(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    compiles = gpu.compile_count
    for kern in TRAIN_KERNELS:
        kern.launches = 0
    assert all(n % TRAIN_STEPS == 0 for n in want.values()), want
    two_steps = {k: 2 * n // TRAIN_STEPS for k, n in want.items()}

    def counters():
        return {kern.__name__: kern.launches for kern in TRAIN_KERNELS}

    def call():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = gpu.run_steps(main, feed=feed, fetch_list=[cost],
                            steps=TRAIN_STEPS, scope=scope)[0]
        torch.cuda.synchronize()
        assert gpu.last_run_steps_fallback is None, \
            gpu.last_run_steps_fallback
        assert gpu.compile_count == compiles + 1, gpu.compile_count
        assert np.isfinite(out).all(), out
        assert counters() == two_steps, (counters(), two_steps)
        return out.reshape(-1), time.monotonic() - t0

    def reload():
        pf.load_numpy_params(scope, s["state0"], pf.CUDAPlace(0))
        torch.cuda.synchronize()

    first, capture_s = call()
    peak_capture = (torch.cuda.max_memory_allocated(),
                    torch.cuda.max_memory_reserved())
    reload()
    torch.cuda.reset_peak_memory_stats()
    second, wall_s = call()
    peak_replay = (torch.cuda.max_memory_allocated(),
                   torch.cuda.max_memory_reserved())
    reload()
    (third, _), prof = _device_profile(f"{tag} run_steps profile", call)
    runs = (first, second, third)
    errs = [max(abs(float(a) - b) / abs(b)
                for a, b in zip(run, eager_losses)) for run in runs]
    bitwise = [bool(np.array_equal(run.astype("float64"), eager_losses))
               for run in runs]
    trace = prof["port_kernel_launches"]
    ran = {n: TRAIN_STEPS * c for n, c in eager_step_trace.items()}
    missed = {n: ran[n] - trace.get(n, 0) for n in ran
              if trace.get(n, 0) != ran[n]}
    step_ms = wall_s / TRAIN_STEPS * 1e3
    busy = prof["device_busy_ms"]
    log(f"{tag} run_steps: capturing call {capture_s:.2f} s (step 1 eager, "
        f"one step captured, {TRAIN_STEPS - 1} replays); losses "
        + ", ".join(f"{x:.6f}" for x in first) + f"; rel err against the "
        f"eager leg {', '.join(f'{e:.3e}' for e in errs)} (tol "
        f"{STEPS_RTOL:g}; capturing, timed and profiled calls, the last "
        f"two from the seeded weights in the same scope, capturing "
        f"nothing), the same bits: {bitwise}; the timed call "
        f"{wall_s * 1e3:.1f} ms; the wrappers' counters over the three "
        f"calls {counters()} (step 1 and the capture); the profiled "
        f"call's trace by kernel {trace}, short of {TRAIN_STEPS} x the "
        f"eager step's by {missed or 0}")
    assert max(errs) <= STEPS_RTOL, errs
    assert eager_step_trace, "the eager step's trace holds no kernel"
    assert set(trace) == set(ran) and all(
        0 < trace[n] <= ran[n] for n in ran), (trace, ran)
    return dict(
        losses=[float(x) for x in first], loss_rel_errs=errs,
        bit_identical=bitwise, capture_call_s=capture_s,
        call_ms=wall_s * 1e3, step_ms=step_ms,
        target_tokens_per_s=tokens / (step_ms / 1e3),
        busy_ms_per_step=None if busy is None else busy / TRAIN_STEPS,
        capture_call_launches=counters(), trace_launches=trace,
        trace_missed=missed,
        peak_memory_bytes=peak_replay[0], peak_reserved_bytes=peak_replay[1],
        capture_peak_memory_bytes=peak_capture[0],
        capture_peak_reserved_bytes=peak_capture[1], profile=prof)


def _train_per_step(ops, seq_len):
    """Each unfused training kernel's launches a step: a routed attention
    op launches its forward kernel in the forward op and again, with its
    residual, in its grad op's recompute, then its backward kernel(s)."""
    n_attn = ops.count("attention")
    per_step = dict(xent_forward=1, xent_backward=1,
                    layer_norm=ops.count("layer_norm"))
    if 256 < seq_len <= 512:
        per_step.update(sdpa_short=2 * n_attn, sdpa_short_bwd=n_attn)
    elif seq_len > 512:
        per_step.update(flash_attention=2 * n_attn, flash_bwd_dq=n_attn,
                        flash_bwd_dkv=n_attn)
    return per_step


def _want_counts(**per_step):
    """Every training kernel's launches over TRAIN_STEPS steps: 0 unless
    given per step."""
    want = {kern.__name__: 0 for kern in TRAIN_KERNELS}
    for name, n in per_step.items():
        want[name] = n * TRAIN_STEPS
    return want


def phase_train(card_name, card, seq_len, batch):
    """Transformer-base's training program at `seq_len` and `batch`:
    2-row parity against the CPU, then TRAIN_STEPS Adam steps on the card
    through the kernels. Returns (launches by kernel, results)."""
    tag = f"train T={seq_len}"
    s = _train_setup(tag, seq_len, batch)
    main, names, gpu, cpu, fresh = (s[k] for k in ("main", "names", "gpu",
                                                   "cpu", "fresh"))
    ops, small, m1 = s["ops"], s["small"], s["m1"]

    # parity: step 1 on the first 2 rows, card against CPU, same weights
    ops_ = main.global_block.ops
    relu_in = [op.inputs["X"][0] for op in ops_ if op.type == "relu"]
    # each FFN ReLU's layer, from its bias (enc0_fc1.b -> enc0)
    bias_of = {op.outputs["Out"][0]: op.inputs["Y"][0] for op in ops_
               if op.type == "elementwise_add"}
    layer = [bias_of[x].split("_fc")[0] for x in relu_in]
    fetch = [s["cost"].name] + [g + "@GRAD" for g in TRAIN_GRADS] + \
        [m1[g] for g in TRAIN_GRADS] + relu_in
    k = len(TRAIN_GRADS)

    def cpu_step(pin=None):
        """The step on the CPU; `pin`: a card run whose ReLU masks the
        CPU run takes."""
        masks = None if pin is None else {
            x: pre > 0 for x, pre in zip(relu_in, pin[1 + 2 * k:])}
        with _relu_masks(masks):
            return cpu.run(main, feed=small, fetch_list=fetch,
                           scope=fresh(pf.CPUPlace()))

    def errs(run, ref):
        return _parity_errs(run, ref, TRAIN_GRADS)

    t0 = time.monotonic()
    ref = cpu_step()
    cpu_s = time.monotonic() - t0
    got = gpu.run(main, feed=small, fetch_list=fetch,
                  scope=fresh(pf.CUDAPlace(0)))
    pinned = cpu_step(pin=got)
    loss_err, grad_errs = errs(got, ref)
    pin_loss, pin_errs = errs(got, pinned)
    # FFN units whose ReLU mask differs between the two runs, per layer,
    # and the largest |pre-activation| among them
    flips = [(g > 0) != (c > 0) for g, c in zip(got[1 + 2 * k:],
                                                ref[1 + 2 * k:])]
    n_flips = int(sum(f.sum() for f in flips))
    flips_by_layer = {}
    for name, f in zip(layer, flips):
        flips_by_layer[name] = int(f.sum())
    flip_max = max([float(np.abs(c[f]).max()) for f, c in
                    zip(flips, ref[1 + 2 * k:]) if f.any()], default=0.0)
    m1_vs_g = max(_rel(got[1 + k + i], 0.1 * got[1 + i]) for i in range(k))
    log(f"{tag} parity (2 rows, step 1; CPU run {cpu_s:.1f} s): loss card "
        f"{float(got[0][0]):.7f} CPU {float(ref[0][0]):.7f}, rel err "
        f"{loss_err:.3e}, against the CPU with the card's ReLU masks "
        f"{pin_loss:.3e} (tol {LOSS_RTOL:g})")
    log(f"{tag} parity: {n_flips} of {sum(f.size for f in flips)} FFN "
        f"ReLU units flip between card and CPU, |pre-activation| at most "
        f"{flip_max:.3e}; per layer {flips_by_layer}")
    for g in TRAIN_GRADS:
        log(f"{tag} parity: {g}@GRAD norm-wise {grad_errs[g][0]:.3e}, "
            f"Moment1 {grad_errs[g][1]:.3e} (tol {TRAIN_GRADS[g]:g}); "
            f"ReLU masks pinned: {pin_errs[g][0]:.3e}, Moment1 "
            f"{pin_errs[g][1]:.3e} (tol {PINNED_GRADS[g]:g})")
    log(f"{tag} parity: Moment1 vs (1-beta1)g on the card {m1_vs_g:.3e}")
    assert np.isfinite(got[0]).all() and loss_err <= LOSS_RTOL, loss_err
    assert pin_loss <= LOSS_RTOL, pin_loss
    for g, tol in TRAIN_GRADS.items():
        assert max(grad_errs[g]) <= tol, (g, grad_errs[g], tol)
    for g, tol in PINNED_GRADS.items():
        assert max(pin_errs[g]) <= tol, (g, pin_errs[g], tol)
    assert m1_vs_g <= 1e-6, m1_vs_g
    # the control: TF32 on, against the CPU run as it is and against the
    # CPU run with the TF32 run's masks
    tf_scope = fresh(pf.CUDAPlace(0))  # CUDAPlace.device() sets TF32 off
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf = gpu.run(main, feed=small, fetch_list=fetch, scope=tf_scope)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf_loss, tf_errs = errs(tf, ref)
    _, tf_pin_errs = errs(tf, cpu_step(pin=tf))
    log(f"{tag} parity: control with TF32 on: loss rel err {tf_loss:.3e}; "
        f"grads norm-wise " + ", ".join(
            f"{g} {e[0]:.3e}" for g, e in tf_errs.items())
        + "; ReLU masks pinned " + ", ".join(
            f"{g} {e[0]:.3e}" for g, e in tf_pin_errs.items()))
    for g, tol in TRAIN_GRADS.items():
        assert tf_errs[g][0] > tol, f"the {g} check cannot see TF32"
    for g, tol in PINNED_GRADS.items():
        assert tf_pin_errs[g][0] > tol, \
            f"the pinned {g} check cannot see TF32"

    # the main path: full-batch Adam steps through the kernels
    counts, res = _train_steps(
        tag, s, seq_len, batch, _want_counts(**_train_per_step(ops, seq_len)),
        card_name, card)
    res.update(loss_rel_err=loss_err,
               grad_errs={g: e[0] for g, e in grad_errs.items()},
               moment1_errs={g: e[1] for g, e in grad_errs.items()},
               relu_flips=n_flips, relu_flips_by_layer=flips_by_layer,
               pinned_loss_rel_err=pin_loss, pinned_errs=pin_errs,
               tf32_grad_errs={g: e[0] for g, e in tf_errs.items()},
               tf32_pinned_grad_errs={g: e[0]
                                      for g, e in tf_pin_errs.items()},
               tf32_loss_err=tf_loss)
    return counts, res


def phase_train_bench_batch(card_name, card):
    """Phase 5's configuration at the bench's batch (BENCH_BATCH): the
    eager steps and the run_steps leg, without the CPU parity step
    (phase 5 holds this program and seq against the CPU). Returns
    (launches by kernel, results)."""
    seq_len = TRAIN_RUNS[0][0]
    tag = f"train T={seq_len} B={BENCH_BATCH}"
    s = _train_setup(tag, seq_len, BENCH_BATCH)
    return _train_steps(
        tag, s, seq_len, BENCH_BATCH,
        _want_counts(**_train_per_step(s["ops"], seq_len)), card_name,
        card)


def phase_train_fused(card_name, card, unfused):
    """Transformer-base's training program at seq 256, batch 64 (phase 5's
    configuration), built with PADDLE_TPU_FUSE_ATTN_BLOCK=1: every
    self-attention sub-layer is one attention_block op and every FFN one
    ffn_block op. 2-row parity against the CPU, a planted fault that must
    fail it (the decoder's causal flag dropped in the card's run), then
    TRAIN_STEPS Adam steps on the card through the fused kernels, set
    beside phase 5's unfused step (`unfused`). Returns (launches by
    kernel, results)."""
    seq_len, batch = TRAIN_RUNS[0]
    tag = f"train fused T={seq_len}"
    s = _train_setup(tag, seq_len, batch, fused=True)
    main, gpu, cpu, fresh = s["main"], s["gpu"], s["cpu"], s["fresh"]
    ops, small, state0 = s["ops"], s["small"], s["state0"]
    n_layers = TRAIN["n_layers"]
    n_ab, n_ffn = ops.count("attention_block"), ops.count("ffn_block")
    log(f"{tag}: {n_ab} attention_block, {n_ffn} ffn_block, "
        f"{ops.count('attention')} attention (cross) ops, "
        f"{ops.count('relu')} relu")
    assert (n_ab, n_ffn, ops.count("attention")) == (
        2 * n_layers, 2 * n_layers, n_layers) and "relu" not in ops

    # parity: step 1 on the first 2 rows, card against CPU, same weights
    ffn_ops = [op for op in main.global_block.ops if op.type == "ffn_block"]
    ffn_x = [op.inputs["X"][0] for op in ffn_ops]
    fetch = [s["cost"].name] + [g + "@GRAD" for g in FUSED_GRADS] + \
        [s["m1"][g] for g in FUSED_GRADS] + ffn_x
    k = len(FUSED_GRADS)
    t0 = time.monotonic()
    ref = cpu.run(main, feed=small, fetch_list=fetch,
                  scope=fresh(pf.CPUPlace()))
    cpu_s = time.monotonic() - t0
    got = gpu.run(main, feed=small, fetch_list=fetch,
                  scope=fresh(pf.CUDAPlace(0)))
    loss_err, grad_errs = _parity_errs(got, ref, FUSED_GRADS)
    # FFN units whose pre-activation, recomputed in float64 from each
    # run's ffn_block input, has another sign on the card than on the CPU
    flips_by_layer, n_flips, flip_max = {}, 0, 0.0
    for op, xg, xc in zip(ffn_ops, got[1 + 2 * k:], ref[1 + 2 * k:]):
        w1 = state0[op.inputs["W1"][0]].astype("float64")
        b1 = state0[op.inputs["B1"][0]].astype("float64")
        pg = xg.reshape(-1, w1.shape[0]).astype("float64") @ w1 + b1
        pc = xc.reshape(-1, w1.shape[0]).astype("float64") @ w1 + b1
        f = (pg > 0) != (pc > 0)
        flips_by_layer[op.inputs["W1"][0].split("_fc1")[0]] = int(f.sum())
        n_flips += int(f.sum())
        if f.any():
            flip_max = max(flip_max, float(np.abs(pc[f]).max()))
    # the same units' masks on the card: #12's forward against #13's
    # recompute, from the card run's ffn_block inputs and the step's
    # weights. The two compute the hidden with one code path: no unit
    # may differ
    kflips_by_layer = {}
    for op, xg in zip(ffn_ops, got[1 + 2 * k:]):
        w1, b1, w2 = (torch.from_numpy(state0[op.inputs[n][0]]).cuda()
                      for n in ("W1", "B1", "W2"))
        kflips_by_layer[op.inputs["W1"][0].split("_fc1")[0]] = \
            _fwd_bwd_mask_flips(
                torch.from_numpy(xg).cuda().reshape(-1, w1.shape[0]), w1,
                b1, w2)
    n_kflips = sum(kflips_by_layer.values())
    log(f"{tag} parity (2 rows, step 1; CPU run {cpu_s:.1f} s): loss card "
        f"{float(got[0][0]):.7f} CPU {float(ref[0][0]):.7f}, rel err "
        f"{loss_err:.3e} (tol {LOSS_RTOL:g})")
    log(f"{tag} parity: {n_flips} FFN units' float64 pre-activations from "
        f"the fetched ffn_block inputs differ in sign between card and CPU, "
        f"|pre-activation| at most {flip_max:.3e}; per layer "
        f"{flips_by_layer}")
    log(f"{tag} parity: {n_kflips} FFN units take one ReLU mask in the "
        f"forward kernel (#12) and the other in the backward kernel's "
        f"recompute (#13) on the card's inputs (must be 0); per layer "
        f"{kflips_by_layer}")
    for g, tol in FUSED_GRADS.items():
        log(f"{tag} parity: {g}@GRAD norm-wise {grad_errs[g][0]:.3e}, "
            f"Moment1 {grad_errs[g][1]:.3e} (tol {tol:g})")
    assert np.isfinite(got[0]).all() and loss_err <= LOSS_RTOL, loss_err
    assert n_kflips == 0, kflips_by_layer
    for g, tol in FUSED_GRADS.items():
        assert max(grad_errs[g]) <= tol, (g, grad_errs[g], tol)
    # the control: the decoder's causal flag dropped in the card's run
    dec = [op for op in main.global_block.ops
           if op.type == "attention_block" and op.attrs["causal"]]
    assert len(dec) == n_layers
    for op in dec:
        op.attrs["causal"] = False
    try:
        bad = gpu.run(main, feed=small, fetch_list=fetch,
                      scope=fresh(pf.CUDAPlace(0)))
    finally:
        for op in dec:
            op.attrs["causal"] = True
    bad_loss, bad_errs = _parity_errs(bad, ref, FUSED_GRADS)
    log(f"{tag} parity: control with the decoder's causal flag dropped on "
        f"the card: loss rel err {bad_loss:.3e}; grads norm-wise "
        + ", ".join(f"{g} {e[0]:.3e}" for g, e in bad_errs.items()))
    for g, tol in FUSED_GRADS.items():
        assert bad_errs[g][0] > tol, f"the {g} check cannot see the fault"

    # the main path. Each attention_block op launches the forward kernel
    # in the forward op and again, saving P, in its grad op's recompute,
    # then the backward kernel; each ffn_block op likewise
    counts, res = _train_steps(tag, s, seq_len, batch, _want_counts(
        xent_forward=1, xent_backward=1, layer_norm=ops.count("layer_norm"),
        attention_block=2 * n_ab, attention_block_bwd=n_ab,
        ffn_block=2 * n_ffn, ffn_block_bwd=n_ffn), card_name, card)
    fp, up = res["profile"], unfused["profile"]
    log(f"{tag}: fused step {res['step_ms']:.1f} ms against phase 5's "
        f"unfused {unfused['step_ms']:.1f} ms "
        f"({res['target_tokens_per_s']:.0f} against "
        f"{unfused['target_tokens_per_s']:.0f} target tokens/s); "
        f"device busy {fp['device_busy_ms']} against {up['device_busy_ms']} "
        f"ms, idle share {fp['idle_share']} against {up['idle_share']}; "
        f"peak {res['peak_memory_bytes'] / 2 ** 30:.2f} against "
        f"{unfused['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    res.update(loss_rel_err=loss_err,
               grad_errs={g: e[0] for g, e in grad_errs.items()},
               moment1_errs={g: e[1] for g, e in grad_errs.items()},
               relu_flips=n_flips, relu_flips_by_layer=flips_by_layer,
               fwd_bwd_mask_flips=n_kflips,
               fwd_bwd_mask_flips_by_layer=kflips_by_layer,
               causal_dropped_loss_err=bad_loss,
               causal_dropped_grad_errs={g: e[0]
                                         for g, e in bad_errs.items()})
    return counts, res


def _serve_continuous(srv, prompts, seeds=None):
    """All `prompts` submitted from their own threads to a server built
    with start=False (with `seeds`, request i draws with seeds[i]); the
    server starts once every request is queued. Returns (rows in request
    order, stats, wall seconds)."""
    results = [None] * len(prompts)

    def call(i):
        seed = None if seeds is None else seeds[i]
        results[i] = srv.submit(prompts[i], seed=seed).result(timeout=900)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while srv.stats()["requests"] < len(prompts):
            assert time.monotonic() < deadline, "requests never queued"
            time.sleep(0.005)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        srv.start()
        for t in threads:
            t.join(900)
            assert not t.is_alive(), "a request did not return"
        wall = time.monotonic() - t0
        st = srv.stats()
    finally:
        srv.close()
    return np.stack(results), st, wall


def _profile_paged_burst(srv, prompts, tag="paged serve", seeds=None,
                         host=True):
    """One decode burst of the paged server under torch.profiler, driven
    from this thread: a first cycle admits a full pool of requests and
    runs steps_per_tick ticks, the second cycle (admitting nothing, a
    burst of steps_per_tick ticks over every lane) is profiled (`host`
    False: the device's activities only). The server is then closed."""
    for i, p in enumerate(prompts):
        srv.submit(p, seed=None if seeds is None else seeds[i])
    try:
        for profiled in (False, True):
            failures = []
            with srv._cv:
                admits = srv._plan_admissions_locked(failures)
                n, m, run = srv._plan_burst_locked(admits, False, failures)
            assert run and not failures and bool(admits) != profiled
            if not profiled:
                srv._cycle(admits, n, m)
                continue
            t0 = srv._devtel.totals["tel_ticks"]
            n0 = KPA.paged_decode_attention.launches
            _, res = _device_profile(f"{tag}: one burst",
                                     lambda: srv._cycle(admits, n, m),
                                     match="paged_decode", host=host)
    finally:
        srv.close()
    paged_ms = res.pop("matched_ms")
    res.update(ticks=srv._devtel.totals["tel_ticks"] - t0,
               paged_launches=KPA.paged_decode_attention.launches - n0,
               paged_kernel_ms=paged_ms,
               paged_share=(paged_ms / res["device_busy_ms"]
                            if res["device_busy_ms"] else None))
    log(f"{tag}: the profiled burst ran {res['ticks']} ticks of "
        f"{len(prompts)} lanes; paged_decode_attention {paged_ms:.3f} ms "
        f"in {res['paged_launches']} launches, share of the busy time "
        f"{res['paged_share']}")
    return res


def _tie_margin(cpu, prog, lname, scope, src, pos):
    """The CPU run's top-2 logit margin at the step that emits position
    `pos` of the prompt `src`."""
    lgt = cpu.run(_unrolled(prog, pos), feed={"src_ids": src[None]},
                  fetch_list=[lname], scope=scope)[0][0]
    top2 = np.sort(lgt)[-2:]
    return float(top2[1] - top2[0])


def _rows_agree(tag, got, want, tie):
    """Rows equal, or first diverging where tie(row, pos) reports a CPU
    top-2 logit margin below LOGITS_TOL. Returns the number of ties."""
    ties = 0
    for r in range(len(got)):
        diff = np.nonzero(got[r] != want[r])[0]
        if not len(diff):
            continue
        pos = int(diff[0])
        margin = tie(r, pos)
        log(f"{tag}: row {r} diverges at position {pos}: CPU top-2 "
            f"logit margin {margin:.3e}")
        assert margin < LOGITS_TOL, f"{tag}: token mismatch is not a tie"
        ties += 1
    return ties


def _paged_programs():
    """Phase 9's programs: the paged and dense decode-step bundles (16
    lanes, 256 blocks of 16, 16 prompt entries, prompts and buffers of
    256) and the whole-loop decode program with its startup and output."""
    cfg = dict(MODEL, seq_len=PAGED["seq_len"],
               max_out_len=PAGED["max_out_len"])
    cache = decode_engine.CacheConfig(
        layout="paged", block_size=PAGED["block_size"],
        n_blocks=PAGED["n_blocks"],
        n_prompt_entries=PAGED["n_prompt_entries"])
    with unique_name.guard():
        paged = decode_engine.build_decode_step_program(
            n_slots=PAGED["n_slots"], state_prefix="@pg/", cache=cache,
            **cfg)
    with unique_name.guard():
        dense = decode_engine.build_decode_step_program(
            n_slots=PAGED["n_slots"], state_prefix="@cb/", **cfg)
    with unique_name.guard():
        whole, startup, _, out = \
            decode_engine.build_incremental_decode_program(**cfg)
    return paged, dense, whole, startup, out


def _paged_weights(exe, startup):
    """Phase 9's random weights (seed SEED) in a fresh scope of `exe`'s."""
    startup.random_seed = SEED
    scope = pf.Scope()
    exe.run(startup, scope=scope)
    return scope


def _paged_requests():
    """Phase 9's requests: the distinct prompts [16, 256] (8 shared, 8
    unique) and the prompt of each of the 32 requests, shuffled."""
    rng = np.random.RandomState(SEED + 9)
    S = PAGED["seq_len"]
    shared = rng.randint(2, MODEL["vocab"], (PAGED_SHARED, S))
    unique = rng.randint(2, MODEL["vocab"], (PAGED_UNIQUE, S))
    distinct = np.concatenate([shared, unique]).astype(np.int64)
    ids = np.concatenate([np.repeat(np.arange(PAGED_SHARED),
                                    PAGED_REPEATS),
                          PAGED_SHARED + np.arange(PAGED_UNIQUE)])
    return distinct, ids[rng.permutation(len(ids))]


def phase_paged(card_name, card):
    """Transformer-base served through the paged continuous-batching
    server: build_decode_step_program with the paged cache (16 lanes,
    256 blocks of 16, 16 prompt entries, prompts and buffers of 256),
    PagedContinuousGenerationServer(steps_per_tick=8), 32 threaded
    submits (8 shared prompts 3 times each, 8 unique ones). Kernel #9
    must launch n_layers times a tick; the tokens must equal the CPU
    whole-loop decode on PAGED_CPU_ROWS of the distinct prompts and the
    dense ContinuousGenerationServer leg on the card (same 16 lanes, same
    requests), under the tie rule; the pool must drain. Returns
    (launches by kernel over both legs, results)."""
    L = MODEL["n_layers"]
    t0 = time.monotonic()
    paged, dense, whole, startup, out = _paged_programs()
    n_ops = sum(len(b.ops) for b in paged.serves[0].blocks)
    log(f"paged serve: built the paged and dense bundles and the whole-"
        f"loop program in {time.monotonic() - t0:.1f} s (paged key-0 "
        f"serve: {n_ops} ops); KV state paged "
        f"{paged.kv_state_bytes() / 2 ** 20:.1f} MiB, dense "
        f"{dense.kv_state_bytes() / 2 ** 20:.1f} MiB")
    params = [v.name for v in startup.global_block.vars.values()
              if v.persistable]
    gpu = pf.Executor(pf.CUDAPlace(0))
    cpu = pf.Executor(pf.CPUPlace())
    gscope = _paged_weights(gpu, startup)
    cscope = pf.Scope()
    pf.load_numpy_params(cscope, pf.scope_to_numpy(gscope, params),
                         pf.CPUPlace())
    distinct, ids = _paged_requests()
    prompts = distinct[ids]

    legs = {}
    launches = {}
    for leg in ("paged", "dense"):
        for k in (KL.layer_norm, KPA.paged_decode_attention, KA.sdpa_short,
                  KA.flash_attention):
            k.launches = 0
        if leg == "paged":
            # radix_reuse=False: this phase is the prefix cache's hit and
            # miss tiers, and its pool must drain (phase 12 serves the
            # radix tier)
            srv = serving.PagedContinuousGenerationServer(
                paged, executor=gpu, scope=gscope,
                steps_per_tick=PAGED["steps_per_tick"], start=False,
                radix_reuse=False)
        else:
            srv = serving.ContinuousGenerationServer(
                dense, executor=gpu, scope=gscope,
                steps_per_tick=PAGED["steps_per_tick"], start=False)
        pool = srv.pool_stats if leg == "paged" else None
        toks, st, wall = _serve_continuous(srv, prompts)
        counts = {k.__name__: k.launches
                  for k in (KL.layer_norm, KPA.paged_decode_attention,
                            KA.sdpa_short, KA.flash_attention)}
        tel = st["device_telemetry"]
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        rps, tps = len(prompts) / wall, st["tokens"] / wall
        log(f"paged serve, {leg} leg: {len(prompts)} requests in "
            f"{wall:.2f} s, {rps:.2f} requests/s, {tps:.1f} tokens/s, p50 "
            f"latency {st['latency_ms']['p50']} ms, ttft p50 "
            f"{st['ttft_ms']['p50']} ms; {st['ticks']} dispatches, "
            f"{tel['ticks']} ticks, mean live lanes "
            f"{tel['mean_live_lanes']}; launches {counts} on {card_name} "
            f"({card})")
        assert st["completed"] == len(prompts)
        assert counts["layer_norm"] > 0, "layer_norm never launched"
        assert counts["sdpa_short"] == counts["flash_attention"] == 0
        if leg == "paged":
            assert counts["paged_decode_attention"] == L * tel["ticks"], \
                (counts, tel["ticks"])
            ps = pool()
            log(f"paged serve: pool {ps}")
            assert ps["blocks_in_use"] == 0 \
                and ps["prompt_entries_in_use"] == 0, ps
            assert ps["prefix_misses"] + ps["prefix_hits"] \
                + ps["cow_copies"] == len(prompts)
            assert ps["prefix_hits"] > 0 and tel["admitted_hit"] > 0
        else:
            assert counts["paged_decode_attention"] == 0
            ps = None
        legs[leg] = dict(requests_per_s=rps, tokens_per_s=tps,
                         wall_s=wall, p50_ms=st["latency_ms"]["p50"],
                         ttft_p50_ms=st["ttft_ms"]["p50"],
                         dispatches=st["ticks"], ticks=tel["ticks"],
                         tokens=st["tokens"], launches=counts, pool=ps,
                         toks=toks)
    # where a tick's time goes: one burst of the paged server, profiled
    # (after the launch counts above were read)
    legs["paged"]["profile"] = _profile_paged_burst(
        serving.PagedContinuousGenerationServer(
            paged, executor=gpu, scope=gscope,
            steps_per_tick=PAGED["steps_per_tick"], start=False,
            radix_reuse=False),
        distinct[:PAGED["n_slots"]])

    # every served copy of a shared prompt is the same row (miss and
    # hit admissions), on both legs
    for leg in legs.values():
        for i in range(PAGED_SHARED):
            rows = leg["toks"][ids == i]
            assert (rows == rows[0]).all(), "a prompt-cache hit moved tokens"
    # against the CPU whole-loop decode on 8 distinct prompts
    pick = list(range(PAGED_CPU_ROWS // 2)) + list(
        PAGED_SHARED + np.arange(PAGED_CPU_ROWS // 2))
    t0 = time.monotonic()
    ref = cpu.run(whole, feed={"src_ids": distinct[pick]},
                  fetch_list=[out], scope=cscope)[0]
    ref = serving.apply_eos_sentinel(ref, MODEL["end_id"])
    cpu_s = time.monotonic() - t0
    lname = _logits_name(whole)

    def first_of(i):
        return int(np.nonzero(ids == i)[0][0])

    first = {i: first_of(i) for i in pick}

    def tie(prompt_of_row):
        return lambda r, pos: _tie_margin(cpu, whole, lname, cscope,
                                          distinct[prompt_of_row(r)], pos)

    paged_rows = legs["paged"]["toks"][[first[i] for i in pick]]
    ties_cpu = _rows_agree("paged serve vs CPU", paged_rows, ref,
                           tie(lambda r: pick[r]))
    ties_dense = _rows_agree("paged serve vs dense leg",
                             legs["paged"]["toks"], legs["dense"]["toks"],
                             tie(lambda r: ids[r]))
    steps = int(serving.count_generated_tokens(
        legs["paged"]["toks"], MODEL["end_id"]).max())
    log(f"paged serve: tokens equal the CPU whole loop in "
        f"{PAGED_CPU_ROWS - ties_cpu}/{PAGED_CPU_ROWS} rows ({ties_cpu} "
        f"ties; CPU run {cpu_s:.1f} s) and the dense leg in "
        f"{len(prompts) - ties_dense}/{len(prompts)} ({ties_dense} ties); "
        f"longest generation {steps} tokens")
    # phase 13's temperature-0 check reads the paged leg's rows of the
    # first shared prompts (main drops them before the JSON)
    greedy = (distinct[:len(SAMPLED_SEEDS)],
              legs["paged"]["toks"][[first_of(i) for i in
                                     range(len(SAMPLED_SEEDS))]])
    for leg in legs.values():
        del leg["toks"]
    return launches, dict(legs=legs, ties_cpu=ties_cpu,
                          ties_dense=ties_dense, cpu_s=cpu_s,
                          longest=steps, _greedy=greedy)


# ---------------------------------------------------------------------------
# phase 12: the radix tier (chat sessions, plain-prompt reuse, n_best) and
# the paged beam decoder
# ---------------------------------------------------------------------------
RADIX_KERNELS = (KL.layer_norm, KPA.paged_decode_attention, KA.sdpa_short,
                 KA.flash_attention)


def _radix_setup(gpu):
    """Phase 12's bundle (phase 9's paged bundle), its weights (phase 9's
    seeded ones, changed as the constants RADIX_* say) on the card and on
    the CPU, the candidate prompts [RADIX_CANDIDATES, 256] and each
    candidate's extension tokens [RADIX_CANDIDATES, turns - 1, 4]."""
    paged, _, _, startup, _ = _paged_programs()
    gscope, host = _radix_weights(gpu, startup)
    cscope = pf.Scope()
    pf.load_numpy_params(cscope, host, pf.CPUPlace())
    cands, exts = _radix_candidates()
    return paged, gscope, cscope, cands, exts


def _radix_weights(gpu, startup):
    """Phase 9's seeded weights in a scope on the card, changed as the
    constants RADIX_* say (word embeddings scaled, the decoder's branch
    outputs scaled down, end_id's column biased): (scope, the host
    arrays)."""
    gscope = _paged_weights(gpu, startup)
    params = [v.name for v in startup.global_block.vars.values()
              if v.persistable]
    host = pf.scope_to_numpy(gscope, params)
    for emb in ("src_word_emb", "tgt_word_emb"):
        host[emb] *= RADIX_EMB_SCALE
    for li in range(MODEL["n_layers"]):
        for w in ("self_out.w", "cross_out.w", "fc2.w", "fc2.b"):
            host[f"dec{li}_{w}"] *= RADIX_BRANCH_SCALE
    ln = f"dec{MODEL['n_layers'] - 1}_c_ln"
    host[f"{ln}.w"][0] = 0.0
    host[f"{ln}.b"][0] = 1.0
    host["logits.w"][0, MODEL["end_id"]] = RADIX_EOS_BIAS
    pf.load_numpy_params(gscope, host, gpu.device)
    return gscope, host


def _radix_candidates():
    """The candidate prompts [RADIX_CANDIDATES, 256] and each one's
    extension tokens [RADIX_CANDIDATES, turns - 1, 4]."""
    rng = np.random.RandomState(RADIX_PROMPT_SEED)
    cands = rng.randint(2, MODEL["vocab"], (
        RADIX_CANDIDATES, PAGED["seq_len"])).astype(np.int64)
    exts = rng.randint(2, MODEL["vocab"], (
        RADIX_CANDIDATES, RADIX_TURNS - 1, RADIX_EXTEND)).astype(np.int64)
    return cands, exts


def _radix_server(paged, gpu, gscope, reuse):
    return serving.PagedContinuousGenerationServer(
        paged, executor=gpu, scope=gscope,
        steps_per_tick=PAGED["steps_per_tick"], radix_reuse=reuse)


def _radix_turns(srv, rows, cands, exts, check):
    """RADIX_TURNS turns of one session per row, each turn a wave of
    every session's submit; a session's next turn extends its history by
    its extension tokens. `check`: assert what the fixed data must give
    before relying on it: every turn-1 decode ends on end_id after at
    least RADIX_MIN_TURN1 tokens, and every turn but the last leaves room
    for the next extension under max_out_len - 1. Returns per turn the
    rows, the histories and the wave's wall time, requests/s and p50
    latency."""
    turns = []
    for t in range(RADIX_TURNS):
        srv.stats(reset=True)
        t0 = time.monotonic()
        replies = [srv.submit(cands[r], session_id=f"s{r}",
                              extend_tokens=None if t == 0
                              else exts[r, t - 1]) for r in rows]
        toks = np.stack([rep.result(timeout=600) for rep in replies])
        wall = time.monotonic() - t0
        st = srv.stats()
        hists = [srv.session_history(f"s{r}") for r in rows]
        turns.append(dict(toks=toks, hists=hists, wall_s=wall,
                          requests_per_s=len(rows) / wall,
                          p50_ms=st["latency_ms"]["p50"]))
        for i, (row, hist) in enumerate(zip(toks, hists)):
            if not check:
                break
            assert t or (len(hist) >= RADIX_MIN_TURN1 + 1
                         and row[len(hist)] == MODEL["end_id"]), \
                f"row {rows[i]}: turn 1 gave {len(hist) - 1} tokens " \
                f"before end_id (the fixed data needs >= " \
                f"{RADIX_MIN_TURN1} and end_id)"
            assert t == RADIX_TURNS - 1 or len(hist) + RADIX_EXTEND \
                <= PAGED["max_out_len"] - 1, \
                f"row {rows[i]}: turn {t + 1} leaves no room to extend"
    return turns


def _launch_counts():
    return {k.__name__: k.launches for k in RADIX_KERNELS}


def _zero_launches():
    for k in RADIX_KERNELS:
        k.launches = 0


def _drain_radix(srv, sessions):
    """Close the sessions, evict the whole tree: the pool and the prompt
    entries must drain."""
    for sid in sessions:
        srv.close_session(sid)
    with srv._cv:
        srv._radix.evict(PAGED["n_blocks"])
    ps = srv.pool_stats()
    assert ps["blocks_in_use"] == 0 and ps["prompt_entries_in_use"] == 0 \
        and ps["radix_nodes"] == 0, ps
    return ps


def _beam_agree(tag, got, want):
    """Card hypotheses against the CPU's: a hypothesis in both sets
    within RADIX_BEAM_TOL of its CPU score; one in a single set only
    where its score lies within that bound of the other set's last (a
    near tie at the cut), printed. Returns those candidates."""
    g = {tuple(int(x) for x in t): s for t, s in got}
    w = {tuple(int(x) for x in t): s for t, s in want}
    for t in g.keys() & w.keys():
        assert abs(g[t] - w[t]) <= RADIX_BEAM_TOL, (tag, g[t], w[t])
    ties = []
    for mine, other, side in ((g, w, "card"), (w, g, "CPU")):
        cut = min(other.values())
        for t in mine.keys() - other.keys():
            log(f"{tag}: a {side} hypothesis the other side lacks, score "
                f"{mine[t]:.6f} against the other's last {cut:.6f}")
            assert abs(mine[t] - cut) <= RADIX_BEAM_TOL, (tag, side)
            ties.append((side, mine[t], cut))
    return ties


def phase_radix(card_name, card):
    """The radix tier and the paged beam decoder on Transformer-base
    (phase 9's bundle and seeded weights, end_id's column biased so that
    turns end). (a) 8 chat sessions of 3 turns (turns 2 and 3 extend 4
    tokens) on a server with radix_reuse and on one without: the same
    tokens and histories, 16 radix admissions each, every reuse admission
    sharing >= 1 block and none on the other; then the sessions close,
    the tree is evicted and the pool and prompt entries drain. (b) the 8
    prompts sent plain, then again: the second submit admits through the
    radix tier with the same tokens. (c) n_best=4 on 2 prompts: identical
    replies on one prompt entry. (d) PagedBeamDecoder, beam 4 on 2
    prompts, against the same decoder on the CPU (plain versions): scores
    within RADIX_BEAM_TOL, hypotheses equal but for near ties; >= 1 COW
    block; the pool free after each decode; beam 1 is the server's greedy
    decode with no COW. Kernel #9 launches n_layers times a device tick
    on every leg. Returns (launches by kernel on the radix legs, on the
    beam leg, results)."""
    L = MODEL["n_layers"]
    gpu = pf.Executor(pf.CUDAPlace(0))
    cpu = pf.Executor(pf.CPUPlace())
    t0 = time.monotonic()
    paged, gscope, cscope, cands, exts = _radix_setup(gpu)
    log(f"radix: built the bundle ({len(paged.serves)} serves, cow and "
        f"probe programs) and the weights in {time.monotonic() - t0:.1f} s")
    rows = list(RADIX_SESSION_ROWS)
    sessions = [f"s{r}" for r in rows]
    res = {}
    radix_launches = dict.fromkeys(_launch_counts(), 0)
    legs = {}
    for reuse in (True, False):
        tag = "reuse" if reuse else "replay"
        _zero_launches()
        srv = _radix_server(paged, gpu, gscope, reuse)
        try:
            turns = _radix_turns(srv, rows, cands, exts, check=reuse)
            ps = srv.pool_stats()
            n_radix = len(rows) * (RADIX_TURNS - 1)
            assert ps["radix_admissions"] == n_radix, ps
            assert srv._devtel.totals["tel_admit_radix"] == n_radix
            depth = ps["prefix_hit_depth"]
            if reuse:
                # every radix admission shared at least one block
                assert depth["0"] == 0 and depth["+Inf"] == n_radix, ps
            else:
                assert depth["0"] == n_radix and \
                    ps["radix_hit_blocks"] == 0, ps
            _drain_radix(srv, sessions)
            extra = {}
            if reuse:
                # (b) the prompts sent plain twice: the second admits
                # through the radix tier over the harvested chain
                plain = []
                for _ in range(2):
                    replies = [srv.submit(cands[r]) for r in rows]
                    plain.append(np.stack([x.result(timeout=600)
                                           for x in replies]))
                ps2 = srv.pool_stats()
                assert ps2["plain_radix_admissions"] == len(rows), ps2
                for p in plain:
                    np.testing.assert_array_equal(p, turns[0]["toks"])
                # (c) n_best: identical greedy replies on one entry
                nbest = []
                for r in RADIX_NBEST_ROWS:
                    srv.stats(reset=True)
                    outs = [x.result(timeout=600) for x in
                            srv.submit(cands[r], n_best=RADIX_NBEST)]
                    st = srv.stats()
                    for o in outs[1:]:
                        np.testing.assert_array_equal(o, outs[0])
                    assert st["device_telemetry"][
                        "prompt_entries_hwm"] == 1, st
                    nbest.append(int(serving.count_generated_tokens(
                        outs[0][None], MODEL["end_id"])[0]))
                with srv._cv:
                    srv._radix.evict(PAGED["n_blocks"])
                ps3 = srv.pool_stats()
                assert ps3["blocks_in_use"] == 0 \
                    and ps3["prompt_entries_in_use"] == 0, ps3
                extra = dict(plain_radix_admissions=ps2[
                    "plain_radix_admissions"], nbest_tokens=nbest)
            ticks = srv._devtel.totals["tel_ticks"]
        finally:
            srv.close()
        counts = _launch_counts()
        assert counts["paged_decode_attention"] == L * ticks, (counts, ticks)
        assert counts["layer_norm"] > 0
        assert counts["sdpa_short"] == counts["flash_attention"] == 0
        for n, c in counts.items():
            radix_launches[n] += c
        legs[tag] = dict(turns=turns, pool=ps, ticks=ticks,
                         launches=counts, **extra)
        for t, tr in enumerate(turns):
            log(f"radix {tag}: turn {t + 1}: {len(rows)} sessions in "
                f"{tr['wall_s']:.3f} s, {tr['requests_per_s']:.2f} "
                f"requests/s, p50 latency {tr['p50_ms']} ms, history "
                f"lengths {[len(h) for h in tr['hists']]} on {card_name} "
                f"({card})")
        log(f"radix {tag}: {ticks} ticks, launches {counts}; pool {ps}")
    for t in range(RADIX_TURNS):
        np.testing.assert_array_equal(legs["reuse"]["turns"][t]["toks"],
                                      legs["replay"]["turns"][t]["toks"])
        assert legs["reuse"]["turns"][t]["hists"] == \
            legs["replay"]["turns"][t]["hists"]
    log(f"radix: every turn's tokens equal with and without reuse; "
        f"reuse hit blocks {legs['reuse']['pool']['radix_hit_blocks']}, "
        f"plain radix admissions {legs['reuse']['plain_radix_admissions']}"
        f", n_best generations {legs['reuse']['nbest_tokens']} tokens")

    # (d) the beam decoder on the card, then the same decodes on the CPU
    _zero_launches()
    tel = paged.state["tel_ticks"]
    gdec = serving.PagedBeamDecoder(paged, RADIX_BEAM, executor=gpu,
                                    scope=gscope)
    ticks, got, ms = 0, [], []
    for r in RADIX_BEAM_ROWS:
        tick0 = int(gscope._get(tel).item())
        torch.cuda.synchronize()
        t1 = time.monotonic()
        got.append(gdec.decode(cands[r], return_all=True))
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t1) * 1e3)
        ticks += int(gscope._get(tel).item()) - tick0
        assert gdec._pool.free_count == PAGED["n_blocks"]
    assert gdec.cow_blocks >= 1, "no beam diverged inside a block"
    one = serving.PagedBeamDecoder(paged, 1, executor=gpu, scope=gscope)
    toks, _ = one.decode(cands[rows[0]])
    ticks += int(gscope._get(tel).item())
    np.testing.assert_array_equal(toks, legs["reuse"]["turns"][0]["toks"][0])
    assert one.cow_blocks == 0 and one._pool.free_count == PAGED["n_blocks"]
    beam_launches = _launch_counts()
    assert beam_launches["paged_decode_attention"] == L * ticks, \
        (beam_launches, ticks)
    log(f"radix beam: {gdec.cow_blocks} COW blocks, shared block peak "
        f"{gdec.shared_block_peak}; beam 1 equals the greedy server with 0 "
        f"COW; {ticks} probe ticks, launches {beam_launches}")
    cdec = serving.PagedBeamDecoder(paged, RADIX_BEAM, executor=cpu,
                                    scope=cscope)
    beams = []
    for r, hyps, t_ms in zip(RADIX_BEAM_ROWS[:RADIX_BEAM_CPU_ROWS], got,
                             ms):
        t1 = time.monotonic()
        want = cdec.decode(cands[r], return_all=True)
        cpu_s = time.monotonic() - t1
        assert cdec._pool.free_count == PAGED["n_blocks"]
        ties = _beam_agree(f"beam row {r}", hyps, want)
        beams.append(dict(ms=t_ms, cpu_s=cpu_s, ties=ties,
                          scores=[s for _, s in hyps],
                          cpu_scores=[s for _, s in want],
                          lengths=[int(serving.count_generated_tokens(
                              t[None], MODEL["end_id"])[0])
                              for t, _ in hyps]))
        log(f"radix beam {RADIX_BEAM}, row {r}: {t_ms:.1f} ms a decode on "
            f"{card_name} ({card}); CPU {cpu_s:.1f} s; scores "
            f"{beams[-1]['scores']} (CPU {beams[-1]['cpu_scores']}), "
            f"lengths {beams[-1]['lengths']}, near ties {ties}")
    for leg in legs.values():
        for tr in leg["turns"]:
            del tr["toks"], tr["hists"]
    res = dict(legs=legs, beam=beams, cow_blocks=gdec.cow_blocks,
               shared_block_peak=gdec.shared_block_peak, beam_ticks=ticks,
               _whole_loop=dict(gscope=gscope, cands=cands, got=got))
    return radix_launches, beam_launches, res


# ---------------------------------------------------------------------------
# phase 13: chunked prefill (on the server and on a disaggregated prefill
# worker) and sampled emission
# ---------------------------------------------------------------------------
CHUNK_PREFIX = "@ck/"


def _chunk_programs():
    """Phase 13's chunked bundle (8 lanes, 64 blocks of 16, 4 prompt
    entries, prompts of 2048 in chunks of 1024, 64 tokens out) and the
    whole-loop decode program of the same lengths, with its startup and
    output."""
    cfg = dict(MODEL, seq_len=CHUNK["seq_len"],
               max_out_len=CHUNK["max_out_len"])
    cache = decode_engine.CacheConfig(
        layout="paged", block_size=CHUNK["block_size"],
        n_blocks=CHUNK["n_blocks"],
        n_prompt_entries=CHUNK["n_prompt_entries"],
        chunk_tokens=CHUNK["chunk_tokens"])
    with unique_name.guard():
        bundle = decode_engine.build_decode_step_program(
            n_slots=CHUNK["n_slots"], state_prefix=CHUNK_PREFIX,
            cache=cache, **cfg)
    with unique_name.guard():
        whole, startup, _, out = \
            decode_engine.build_incremental_decode_program(**cfg)
    return bundle, whole, startup, out


def _chunk_walk_rows(bundle, exe, scope, src):
    """Entry 0 filled by the monolithic miss admission (its encoder runs
    #2 at tq = tk = 2048), entry 1 by the walk of every phase at every
    chunk cursor (#2 at tq 1024 over tk 2048). Returns (how many values
    of the cross-KV rows differ, of how many, their largest difference,
    the largest |value|)."""
    bundle.init_slot_state(scope, "cuda")
    zero = np.array([0], np.int64)
    fetch = [bundle.state["active"]]
    exe.run(bundle.serves[("miss", 1)],
            feed={"src_ids": src[None], "slots": zero,
                  "prompt_slots": zero, "n_steps": zero,
                  "min_active": zero}, fetch_list=fetch, scope=scope)
    C = CHUNK["chunk_tokens"]
    for key in bundle.chunk_phase_keys:
        for ci in range(bundle.cache.n_chunks(CHUNK["seq_len"])):
            feed = {"chunk_entry": np.array([1], np.int64),
                    "chunk_pos": np.array([ci * C], np.int64),
                    "n_steps": zero, "min_active": zero}
            if key[1] == 0:
                feed["chunk_toks"] = src[None, ci * C:(ci + 1) * C]
            exe.run(bundle.serves[key], feed=feed, fetch_list=fetch,
                    scope=scope)
    torch.cuda.synchronize()
    differ = total = 0
    diff = top = 0.0
    for name in bundle._state_specs:
        if re.fullmatch(re.escape(CHUNK_PREFIX) + r"cross_[kv]\d+"
                        + re.escape(decode_engine.POOL_MARK), name):
            pool = scope._get(name)
            a, b = pool[0], pool[1]
            differ += int((a != b).sum())
            total += a.numel()
            diff = max(diff, max_err(a, b))
            top = max(top, float(a.abs().max()))
    return differ, total, diff, top


def _idle_share(prof):
    return None if prof is None else prof["idle_share"]


def _chunk_leg(tag, bundle, gpu, gscope, prompts, worker=None,
               chunked_prefill=None):
    """One wave of `prompts` through a PagedContinuousGenerationServer
    over the chunked bundle: its rows, wall, pool and host chunk counts,
    the device's tel_chunks (the worker's scope's, with a worker) and
    the launches by kernel."""
    _zero_launches()
    srv = serving.PagedContinuousGenerationServer(
        bundle, executor=gpu, scope=gscope,
        steps_per_tick=CHUNK["steps_per_tick"], start=False,
        radix_reuse=False, chunked_prefill=chunked_prefill,
        prefill_worker=worker)
    toks, st, wall = _serve_continuous(srv, prompts)
    counts = _launch_counts()
    ps = srv.pool_stats()
    tel = st["device_telemetry"]
    tel_scope = worker.scope if worker is not None else gscope
    dev_chunks = int(tel_scope._get(
        bundle.state["tel_ticks"].replace("tel_ticks",
                                          "tel_chunks")).item())
    L = MODEL["n_layers"]
    assert st["completed"] == len(prompts), st
    assert counts["paged_decode_attention"] == L * tel["ticks"], \
        (counts, tel["ticks"])
    assert counts["layer_norm"] > 0 and counts["flash_attention"] > 0, \
        counts
    assert counts["sdpa_short"] == 0, counts
    assert ps["blocks_in_use"] == 0 and ps["prompt_entries_in_use"] == 0, ps
    log(f"chunked prefill, {tag}: {len(prompts)} requests in {wall:.2f} s, "
        f"p50 latency {st['latency_ms']['p50']} ms, "
        f"ttft p50 {st['ttft_ms']['p50']} ms; {st['ticks']} dispatches, "
        f"{tel['ticks']} decode ticks; chunk jobs {ps['chunk_jobs']}, "
        f"chunk dispatches {ps['chunk_ticks']} (device {dev_chunks}), "
        f"handoffs {ps['disagg_handoffs']}; launches {counts}")
    return toks, dict(wall_s=wall, p50_ms=st["latency_ms"]["p50"],
                      ttft_p50_ms=st["ttft_ms"]["p50"],
                      dispatches=st["ticks"], ticks=tel["ticks"],
                      chunk_jobs=ps["chunk_jobs"],
                      chunk_ticks=ps["chunk_ticks"],
                      device_chunks=dev_chunks,
                      handoffs=ps["disagg_handoffs"], launches=counts)


def _record_margins(records):
    """Wrap the sample_categorical op's kernel: each call also records,
    for every row, (seed, pos, the top-2 margin of g + log p), without
    a sync. Returns the function that restores the kernel."""
    from paddle_tpu_torch.ops import spec_ops as SO

    info = registry.get_op_info("sample_categorical")
    real = info.kernel

    def kernel(ctx):
        probs = ctx.input("Probs")
        keys = SO.lane_keys(
            SO.base_key(ctx.attr("base_seed", 0), ctx.attr("noise_tag", 0),
                        probs.device), ctx.input("Seed"), ctx.input("Pos"))
        z = -torch.log(-torch.log(SO.uniform(keys, probs.shape[-1]))) \
            + torch.log(probs.float() + 1e-20)
        top2 = torch.topk(z, 2, dim=-1).values
        records.append(torch.stack([
            ctx.input("Seed").reshape(-1).double(),
            ctx.input("Pos").reshape(-1).double(),
            (top2[:, 0] - top2[:, 1]).double()], dim=1))
        return real(ctx)

    info.kernel = kernel

    def restore():
        info.kernel = real
    return restore


def _least_margin(records, seeds, rows):
    """The least top-2 margin over the draws of the real lanes: each
    (seed, position) that a request's row holds, first draw only."""
    rec = torch.cat(records).cpu().numpy()
    seen, least, n = set(), math.inf, 0
    lengths = serving.count_generated_tokens(rows, MODEL["end_id"])
    for seed, pos, margin in rec:
        key = (int(seed), int(pos))
        if key in seen or int(seed) not in seeds:
            continue
        i = seeds.index(int(seed))
        if not 1 <= int(pos) <= int(lengths[i]):
            continue
        seen.add(key)
        least = min(least, float(margin))
        n += 1
    return least, n


def _sampled_server(bundle, exe, scope, steps):
    return serving.PagedContinuousGenerationServer(
        bundle, executor=exe, scope=scope, steps_per_tick=steps,
        start=False, radix_reuse=False)


def _sampled_rows_agree(tag, got, want, margins):
    """Rows equal, or first diverging at a draw whose card top-2 margin
    lies below LOGITS_TOL (`margins`: (seed index, pos) -> margin).
    Returns the ties."""
    ties = 0
    for r in range(len(got)):
        diff = np.nonzero(got[r] != want[r])[0]
        if not len(diff):
            continue
        pos = int(diff[0])
        m = margins.get((r, pos))
        log(f"{tag}: row {r} diverges at position {pos}: card top-2 "
            f"margin {m}")
        assert m is not None and m < LOGITS_TOL, f"{tag}: not a tie"
        ties += 1
    return ties


def phase_chunked_sampled(card_name, card, greedy):
    """Chunked prefill and sampled emission on Transformer-base.
    Chunked leg (CHUNK): the cross-KV rows of one prompt's phase walk
    against the monolithic miss admission's; then 8 requests over 4
    distinct 2048-token prompts in CHUNK_ORDER through a chunked server,
    the same bundle's monolithic server (chunked_prefill=False) and a
    server fed by a DisaggregatedPrefillWorker on a second scope and
    executor: tokens equal, chunk dispatches exactly jobs x n_chunks x
    phases on the host and the device, #1, #2 and #9 launched; two
    prompts against the CPU whole loop. Sampled leg: phase 9's bundle
    with SAMPLED (base_seed SEED) on 4 of phase 9's shared prompts with
    SAMPLED_SEEDS, the same wave reversed at SAMPLED_STEPS_B a burst,
    the least top-2 margin of the draws; a temperature-0 bundle against
    phase 9's greedy rows.
    Returns (launches on the chunked leg, on the sampled leg, results)."""
    L = MODEL["n_layers"]
    gpu = pf.Executor(pf.CUDAPlace(0))
    cpu = pf.Executor(pf.CPUPlace())
    t0 = time.monotonic()

    def at():
        return f"[{time.monotonic() - t0:.1f} s into the phase]"

    bundle, whole, startup, out = _chunk_programs()
    gscope = _paged_weights(gpu, startup)
    params = [v.name for v in startup.global_block.vars.values()
              if v.persistable]
    cscope = pf.Scope()
    pf.load_numpy_params(cscope, pf.scope_to_numpy(gscope, params),
                         pf.CPUPlace())
    log(f"chunked prefill: built the bundle ({len(bundle.serves)} serves, "
        f"{len(bundle.chunk_phase_keys)} chunk phases) and the weights in "
        f"{time.monotonic() - t0:.1f} s")
    rng = np.random.RandomState(SEED + 13)
    distinct = rng.randint(2, MODEL["vocab"], (
        4, CHUNK["seq_len"])).astype(np.int64)
    prompts = distinct[list(CHUNK_ORDER)]
    t1 = time.monotonic()
    differ, total, diff, top = _chunk_walk_rows(bundle, gpu, gscope,
                                                distinct[0])
    log(f"chunked prefill: the rows check in {time.monotonic() - t1:.1f} s")
    log(f"chunked prefill: the phase walk's cross-KV rows against the "
        f"monolithic admission's: {differ} of {total} values differ, "
        f"largest difference {diff:.3e} (tol {ATTN_TOL:g}), largest "
        f"|value| {top:.3f}")
    assert diff <= ATTN_TOL, diff
    n_chunks = bundle.cache.n_chunks(CHUNK["seq_len"])
    phases = len(bundle.chunk_phase_keys)
    legs, toks = {}, {}
    chunked_launches = {}
    for tag, kw in (("chunked", {}), ("monolithic",
                                       dict(chunked_prefill=False))):
        toks[tag], legs[tag] = _chunk_leg(tag, bundle, gpu, gscope,
                                          prompts, **kw)
        log(f"chunked prefill: the {tag} leg done {at()}")
    t1 = time.monotonic()
    worker = serving.DisaggregatedPrefillWorker(
        bundle, executor=pf.Executor(pf.CUDAPlace(0)), scope=pf.Scope(),
        params_from=gscope)
    log(f"chunked prefill: the worker's scope and programs in "
        f"{time.monotonic() - t1:.1f} s")
    try:
        toks["worker"], legs["worker"] = _chunk_leg(
            "worker-fed", bundle, gpu, gscope, prompts, worker=worker)
        ws = worker.stats()
    finally:
        worker.close()
    log(f"chunked prefill: the worker-fed leg done {at()}")
    jobs = len(distinct)
    leg = legs["chunked"]
    assert leg["chunk_jobs"] == jobs, leg
    assert leg["chunk_ticks"] == jobs * n_chunks * phases \
        == leg["device_chunks"], leg
    # the chunk's attention phases launch #2: L a chunk cursor
    assert leg["launches"]["flash_attention"] == jobs * L * n_chunks, leg
    assert legs["monolithic"]["chunk_jobs"] == 0
    assert legs["worker"]["handoffs"] == jobs and ws["jobs_done"] == jobs \
        and ws["chunk_ticks"] == jobs * n_chunks * phases \
        == legs["worker"]["device_chunks"], (legs["worker"], ws)
    assert legs["worker"]["launches"]["flash_attention"] \
        == jobs * L * n_chunks, legs["worker"]
    for tag in ("monolithic", "worker"):
        np.testing.assert_array_equal(toks[tag], toks["chunked"],
                                      err_msg=tag)
    for leg in legs.values():
        for n, c in leg["launches"].items():
            chunked_launches[n] = chunked_launches.get(n, 0) + c
    t1 = time.monotonic()
    ref = cpu.run(whole, feed={"src_ids": distinct[:CHUNK_CPU_ROWS]},
                  fetch_list=[out], scope=cscope)[0]
    ref = serving.apply_eos_sentinel(ref, MODEL["end_id"])
    cpu_s = time.monotonic() - t1
    lname = _logits_name(whole)
    rows = toks["chunked"][[CHUNK_ORDER.index(i)
                            for i in range(CHUNK_CPU_ROWS)]]
    ties = _rows_agree("chunked prefill vs CPU", rows, ref,
                       lambda r, pos: _tie_margin(cpu, whole, lname, cscope,
                                                  distinct[r], pos))
    log(f"chunked prefill: the chunked, monolithic and worker-fed tokens "
        f"equal; {CHUNK_CPU_ROWS - ties}/{CHUNK_CPU_ROWS} prompts equal "
        f"the CPU whole loop ({ties} ties; CPU run {cpu_s:.1f} s); worker "
        f"{ws}; on {card_name} ({card})")
    chunked = dict(legs=legs, walk_rows=dict(
        differ=differ, of=total, max_diff=diff, max_abs=top),
        worker=ws, ties_cpu=ties, cpu_s=cpu_s)
    del bundle, gscope, worker  # the chunked slot state and pools
    torch.cuda.empty_cache()

    # the sampled leg
    cfg = dict(MODEL, seq_len=PAGED["seq_len"],
               max_out_len=PAGED["max_out_len"])
    cache = decode_engine.CacheConfig(
        layout="paged", block_size=PAGED["block_size"],
        n_blocks=PAGED["n_blocks"],
        n_prompt_entries=PAGED["n_prompt_entries"])
    built = {}
    t1 = time.monotonic()
    # (the CPU server's wave of these bundles was cut for time:
    # phase 14 holds sampled speculation, whose draws include these, on
    # the card against the CPU)
    for tag, samp in (("sampled", dict(SAMPLED, base_seed=SEED)),
                      ("greedy", dict(temperature=0.0))):
        with unique_name.guard():
            built[tag] = decode_engine.build_decode_step_program(
                n_slots=PAGED["n_slots"], state_prefix=f"@s{tag[0]}/",
                cache=cache,
                sampling=decode_engine.SamplingConfig(**samp), **cfg)
    log(f"sampled: built the sampled and temperature-0 bundles in "
        f"{time.monotonic() - t1:.1f} s")
    sb = built["sampled"]
    gscope = _paged_weights(gpu, startup)
    srcs, greedy_rows = greedy
    seeds = list(SAMPLED_SEEDS)
    sampled_launches = {}
    res = {}
    records = []
    restore = _record_margins(records)
    try:
        _zero_launches()
        a_rows, st, wall = _serve_continuous(
            _sampled_server(sb, gpu, gscope, PAGED["steps_per_tick"]),
            srcs, seeds)
        torch.cuda.synchronize()
    finally:
        restore()
    counts = _launch_counts()
    least, n_draws = _least_margin(records, seeds, a_rows)
    margins = {}
    rec = torch.cat(records).cpu().numpy()
    for seed, pos, m in rec:
        if int(seed) in seeds:
            margins.setdefault((seeds.index(int(seed)), int(pos)), float(m))
    res["a"] = dict(wall_s=wall, ticks=st["device_telemetry"]["ticks"],
                    tokens=st["tokens"], launches=counts,
                    least_margin=least, draws=n_draws)
    log(f"sampled, wave A: {len(srcs)} requests in {wall:.2f} s, "
        f"{st['tokens'] / wall:.1f} tokens/s, {res['a']['ticks']} ticks; "
        f"least top-2 margin of g + log p over its {n_draws} draws "
        f"{least:.3e}; launches {counts}")
    for tag, steps, order in (
            ("b", SAMPLED_STEPS_B, list(reversed(range(len(srcs))))),
            ("greedy", PAGED["steps_per_tick"], list(range(len(srcs))))):
        _zero_launches()
        srv = _sampled_server(built["sampled" if tag == "b" else "greedy"],
                              gpu, gscope, steps)
        rows, st, wall = _serve_continuous(srv, srcs[order],
                                           [seeds[i] for i in order])
        back = np.empty_like(rows)
        back[order] = rows
        counts = _launch_counts()
        res[tag] = dict(wall_s=wall, ticks=st["device_telemetry"]["ticks"],
                        tokens=st["tokens"], launches=counts,
                        steps_per_tick=steps)
        log(f"sampled, wave {tag} done {at()}")
        log(f"sampled, wave {tag}: {len(srcs)} requests in {wall:.2f} s, "
            f"{res[tag]['ticks']} ticks at {steps} a burst; launches "
            f"{counts}")
        if tag == "b":
            res["b"]["ties"] = _sampled_rows_agree(
                "sampled, reversed wave vs wave A", back, a_rows, margins)
        else:
            np.testing.assert_array_equal(back, greedy_rows)
    for r in ("a", "b", "greedy"):
        counts = res[r]["launches"]
        assert counts["paged_decode_attention"] == L * res[r]["ticks"], \
            (r, counts)
        assert counts["layer_norm"] > 0 and counts["sdpa_short"] == 0 \
            and counts["flash_attention"] == 0, (r, counts)
        for n, c in counts.items():
            sampled_launches[n] = sampled_launches.get(n, 0) + c
    assert (a_rows != greedy_rows).any(), "the draws moved nothing"
    # where a sampled tick's time goes: one burst over the 4 lanes
    res["burst_profile"] = _profile_paged_burst(
        _sampled_server(sb, gpu, gscope, PAGED["steps_per_tick"]), srcs,
        tag="sampled", seeds=seeds)
    log(f"sampled: the profiled burst done {at()}")
    log(f"sampled: the reversed wave at {SAMPLED_STEPS_B} a burst equals "
        f"wave A on {len(srcs) - res['b']['ties']}/{len(srcs)} requests; "
        f"the temperature-0 bundle equals phase 9's greedy rows; on "
        f"{card_name} ({card})")
    return chunked_launches, sampled_launches, dict(chunked=chunked,
                                                    sampled=res)


# ---------------------------------------------------------------------------
# phase 14: speculative decoding (the model draft's ladder, the n-gram
# proposer, sampled speculation) and draft distillation
# ---------------------------------------------------------------------------
SPEC_KERNELS = (KL.layer_norm, KPA.paged_decode_attention, KA.sdpa_short,
                KA.flash_attention, KX.xent_forward, KX.xent_backward)


def _spec_launches():
    return {k.__name__: k.launches for k in SPEC_KERNELS}


def _zero_spec_launches():
    for k in SPEC_KERNELS:
        k.launches = 0


class _PinnedK:
    """A controller that runs every dispatch at one rung."""

    def __init__(self, k):
        self.k = int(k)

    def choose(self):
        return self.k

    def observe(self, accepted_delta, ticks_delta, k):
        pass

    def reset_lane(self, lane):
        pass

    def stats(self):
        return {"pinned": self.k}


def _spec_programs():
    """Phase 14's bundles over phase 9's paged geometry at SPEC_MAX_OUT
    tokens out (16 lanes, admissions of 16): plain, the model draft's
    ladder, the n-gram proposer, the model draft at fixed k with SAMPLED
    (base_seed SEED), and that sampled bundle at SPEC_SAMPLED_ROWS lanes
    for the CPU; the whole-loop program with its startup and output."""
    cfg = dict(MODEL, seq_len=PAGED["seq_len"], max_out_len=SPEC_MAX_OUT)
    cache = decode_engine.CacheConfig(
        layout="paged", block_size=PAGED["block_size"],
        n_blocks=PAGED["n_blocks"],
        n_prompt_entries=PAGED["n_prompt_entries"])
    model_draft = decode_engine.DraftConfig(k=SPEC_K, **SPEC_DRAFT)
    sampled = dict(draft=model_draft, sampling=decode_engine.SamplingConfig(
        **SAMPLED, base_seed=SEED))
    built = {}
    for tag, lanes, kw in (
            ("plain", PAGED["n_slots"], {}),
            ("ladder", PAGED["n_slots"], dict(
                draft=decode_engine.DraftConfig(
                    k=SPEC_K, k_options=SPEC_LADDER, **SPEC_DRAFT))),
            ("ngram", PAGED["n_slots"], dict(
                draft=decode_engine.DraftConfig(**SPEC_NGRAM))),
            ("sampled", PAGED["n_slots"], sampled),
            ("cpu", SPEC_SAMPLED_ROWS, sampled)):
        with unique_name.guard():
            built[tag] = decode_engine.build_decode_step_program(
                n_slots=lanes, admit_buckets=[lanes],
                state_prefix=f"@x{tag[0]}/", cache=cache, **kw, **cfg)
    with unique_name.guard():
        whole, startup, _, out = \
            decode_engine.build_incremental_decode_program(**cfg)
    return built, whole, startup, out


def _spec_weights(gpu, startup):
    """Phase 12's weights with the draft's params seeded under draft_
    (the port's initializers, startup seed SEED + 14): the card's scope,
    the CPU's, and the draft's param names."""
    gscope, host = _radix_weights(gpu, startup)
    with unique_name.guard():
        _, dst, _ = transformer.build_program(
            seq_len=PAGED["seq_len"], vocab=MODEL["vocab"],
            with_optimizer=False, dropout_rate=0.0, name_prefix="draft_",
            **SPEC_DRAFT)
    dst.random_seed = SEED + 14
    tmp = pf.Scope()
    gpu.run(dst, scope=tmp)
    names = [v.name for v in dst.global_block.vars.values()
             if v.persistable and v.name.startswith("draft_")]
    draft = pf.scope_to_numpy(tmp, names)
    pf.load_numpy_params(gscope, draft, gpu.device)
    host.update(draft)
    cscope = pf.Scope()
    pf.load_numpy_params(cscope, host, pf.CPUPlace())
    return gscope, cscope, names


def _record_spec_margins(records):
    """Wrap the spec_accept op's kernel: each call also records, without
    a sync, (seed, position, margin) for every lane's acceptance tests
    (|log p(x) - log(u q(x))| at pos+1+j) and its correction or bonus
    draw (the top-2 margin of g + log p at pos+1+a). Returns the
    function that restores the kernel."""
    from paddle_tpu_torch.ops import spec_ops as SO

    info = registry.get_op_info("spec_accept")
    real = info.kernel

    def kernel(ctx):
        out = real(ctx)
        k = int(ctx.attr("k"))
        tag, base = int(ctx.attr("noise_tag", 0)), ctx.attr("base_seed", 0)
        tp = ctx.input("TargetProbs").float()
        dp = ctx.input("DraftProbs").float()
        seed = ctx.input("Seed").reshape(-1)
        pos = ctx.input("Pos").reshape(-1).long()
        props = ctx.input("Proposals").long()
        dev = tp.device
        lanes = torch.arange(tp.shape[0], device=dev)
        posj = pos[:, None] + 1 + torch.arange(k, device=dev)[None]
        u = SO.uniform_scalar(SO.lane_keys(
            SO.base_key(base, tag + SO._TAG_ACCEPT, dev), seed, posj))
        px = torch.gather(tp[:, :k], 2, props[..., None])[..., 0]
        qx = torch.gather(dp, 2, props[..., None])[..., 0]
        acc_m = (torch.log(px + 1e-30) - torch.log(u * qx + 1e-30)).abs()
        a = torch.cumprod((u * qx < px).long(), dim=1).sum(dim=1)
        ai = a.clamp(0, k - 1)
        resid = (tp[lanes, ai] - dp[lanes, ai]).clamp_min(0.0)
        rs = resid.sum(-1, keepdim=True)
        resid = torch.where(rs > 0, resid / rs.clamp_min(1e-30),
                            tp[lanes, ai])
        dist = torch.where((a < k)[:, None], resid, tp[:, k])
        keys = SO.lane_keys(SO.base_key(base, tag + SO._TAG_RESID, dev),
                            seed, pos + 1 + a)
        z = -torch.log(-torch.log(SO.uniform(keys, dist.shape[-1]))) \
            + torch.log(dist + 1e-20)
        top2 = torch.topk(z, 2, dim=-1).values
        sd = seed.double()
        records.append(torch.cat([
            torch.stack([sd[:, None].expand_as(posj).reshape(-1),
                         posj.reshape(-1).double(),
                         acc_m.reshape(-1).double()], dim=1),
            torch.stack([sd, (pos + 1 + a).double(),
                         (top2[:, 0] - top2[:, 1]).double()], dim=1)]))
        return out

    info.kernel = kernel

    def restore():
        info.kernel = real
    return restore


def _margins_by_row(records, seeds):
    """(row, position) -> the least recorded margin there, for the rows'
    seeds."""
    out = {}
    if not records:
        return out
    for seed, pos, m in torch.cat(records).cpu().numpy():
        if int(seed) in seeds:
            key = (seeds.index(int(seed)), int(pos))
            out[key] = min(out.get(key, math.inf), float(m))
    return out


def phase_speculative(card_name, card):
    """Speculative decoding on Transformer-base (phase 12's weights, the
    draft SPEC_DRAFT seeded under draft_) over phase 9's paged geometry
    at SPEC_MAX_OUT tokens out, 16 requests (phase 12's session rows and
    SPEC_EXTRA_ROWS). Legs: (1) the plain bundle: the reference rows;
    (2) the ladder pinned at k = 0: the plain rows bit for bit, #9
    n_layers a tick, the draft's keepalive writes its cache; (3) pinned
    at k = 3 and at k = 4 with the raw draft; (4) distill_draft on the
    plain server's rows (SPEC_DISTILL): the loss falls, the target's
    params keep their bytes, #7 and #8 once a replayed step (profiled);
    (5) pinned k = 3 and the automatic controller after distillation;
    (6) the n-gram bundle under its automatic controller, no draft step;
    (7) sampled speculation (the draft at k = 3, SAMPLED) on
    SPEC_SAMPLED_ROWS prompts against the CPU server of the same bundle,
    and again in reverse at SAMPLED_STEPS_B a burst; (8) two prompts of
    leg 5's k = 3 wave against the CPU whole loop. Rows equal the plain
    rows (legs 3, 5, 6) or the CPU's (7, 8) under phase 4's tie rule
    (sampled: the least card margin at the diverging draw or test).
    Every card wave runs under torch.profiler (device activities only)
    for its idle share. Returns (launches on the serving legs 1-3 and
    5-7, on the distillation leg, results)."""
    from paddle_tpu_torch.models.distill import distill_draft

    L = MODEL["n_layers"]
    gpu = pf.Executor(pf.CUDAPlace(0))
    cpu = pf.Executor(pf.CPUPlace())
    t0 = time.monotonic()

    def at():
        return f"[{time.monotonic() - t0:.1f} s into the phase]"

    built, whole, startup, out = _spec_programs()
    log(f"speculative: built the bundles ({', '.join(f'{t} {len(b.serves)}' for t, b in built.items())} serves) in "
        f"{time.monotonic() - t0:.1f} s")
    gscope, cscope, draft_names = _spec_weights(gpu, startup)
    cands, _ = _radix_candidates()
    wave_rows = list(RADIX_SESSION_ROWS) + list(SPEC_EXTRA_ROWS)
    srcs = cands[wave_rows]
    held_out = [r for r in range(RADIX_CANDIDATES) if r not in wave_rows]
    lname = _logits_name(whole)
    served, res = {}, {}

    def tie(r, pos, rows_src=srcs):
        return _tie_margin(cpu, whole, lname, cscope, rows_src[r], pos)

    def server(bundle, ctl, steps, drain=None):
        return serving.PagedContinuousGenerationServer(
            bundle, executor=gpu, scope=gscope, steps_per_tick=steps,
            drain_steps=drain, start=False, radix_reuse=False,
            spec_controller=ctl)

    def wave(tag, bundle, ctl=None, prompts=srcs, seeds=None,
             steps=PAGED["steps_per_tick"], drain=None, burst=True,
             host=False):
        """The wave's rows and numbers; then, `burst`, a profiled burst
        of SPEC_BURST ticks over the same prompts on a fresh server (the
        device's activities only unless `host`) for the leg's idle share:
        a whole wave's profile takes ~0.2 ms a device activity to read
        back, and a speculative tick has ~2000 of them."""
        _zero_spec_launches()
        rows, st, wall = _serve_continuous(
            server(bundle, ctl, steps, drain), prompts, seeds)
        counts = _spec_launches()
        prof = None
        if burst:
            fresh = _PinnedK(ctl.k) if isinstance(ctl, _PinnedK) else None
            prof = _profile_paged_burst(
                server(bundle, fresh, SPEC_BURST), prompts,
                tag=f"speculative, {tag}", seeds=seeds, host=host)
        tel = st["device_telemetry"]
        sp = st.get("speculative")
        assert st["completed"] == len(prompts), st
        assert counts["sdpa_short"] == counts["flash_attention"] == 0, \
            counts
        for n, c in counts.items():
            served[n] = served.get(n, 0) + c
        r = dict(wall_s=wall, tokens=st["tokens"],
                 tokens_per_s=st["tokens"] / wall, ticks=tel["ticks"],
                 dispatches=st["ticks"], idle_share=_idle_share(prof),
                 burst=prof,
                 launches=counts, speculative=sp,
                 spec_ticks={k: v for k, v in tel.items()
                             if k.startswith("spec_ticks_k")})
        if sp is not None:
            r["acceptance"] = sp["acceptance_rate"]
            # a lane's tokens a verify; under a ladder over the rungs that
            # verify (stats' mean_accepted_len reads the default k)
            verifies, emitted = sp["proposed"] / bundle.spec_k, \
                sp["emitted"]
            if "per_k" in sp:
                pos = {kv: w for kv, w in sp["per_k"].items() if kv > 0}
                verifies = sum(w["proposed"] / kv for kv, w in pos.items())
                emitted = sum(w["emitted"] for w in pos.values())
            r["emitted_per_verify"] = emitted / verifies if verifies \
                else None
        log(f"speculative, {tag}: {len(prompts)} requests in {wall:.2f} s, "
            f"{r['tokens_per_s']:.1f} tokens/s, idle share of a "
            f"{SPEC_BURST}-tick burst {r['idle_share']}, {tel['ticks']} "
            f"ticks in "
            f"{st['ticks']} dispatches; accepted/proposed "
            f"{r.get('acceptance')}, emitted a verify "
            f"{r.get('emitted_per_verify')}; launches {counts} {at()}")
        return rows, r

    # (1) plain
    plain_rows, res["plain"] = wave("plain", built["plain"])
    assert res["plain"]["launches"]["paged_decode_attention"] \
        == L * res["plain"]["ticks"]
    # (2) the ladder pinned at k = 0: the plain body, bit for bit
    lb = built["ladder"]
    kv0 = f"{lb.state['tok_buf'][:-len('tok_buf')]}draft_self_k0"
    rows, res["k0"] = wave("ladder pinned at k=0", lb, _PinnedK(0))
    np.testing.assert_array_equal(rows, plain_rows)
    assert res["k0"]["launches"]["paged_decode_attention"] \
        == L * res["k0"]["ticks"] == L * res["k0"]["spec_ticks"][
            "spec_ticks_k0"], res["k0"]
    assert float(gscope._get(kv0).abs().sum()) > 0, "no keepalive write"
    assert res["k0"]["speculative"]["proposed"] == 0
    # (3) the raw draft at k = 3 and k = 4
    ties = {}
    for kv in (3, 4):
        tag = f"raw k={kv}"
        rows, res[tag] = wave(f"ladder pinned at k={kv}, raw draft", lb,
                              _PinnedK(kv))
        ties[tag] = _rows_agree(f"speculative {tag} vs plain", rows,
                                plain_rows, tie)
        assert res[tag]["launches"]["paged_decode_attention"] == 0
        assert res[tag]["speculative"]["draft_steps"] \
            == kv * res[tag]["speculative"]["target_steps"]

    # (4) distillation, the plain server on the card the teacher
    dcfg = lb.draft
    target = {v.name: gscope._get(v.name).clone()
              for v in startup.global_block.vars.values() if v.persistable}
    teacher = serving.PagedContinuousGenerationServer(
        built["plain"], executor=gpu, scope=gscope,
        steps_per_tick=PAGED["steps_per_tick"], radix_reuse=False)

    def decode_fn(b):
        replies = [teacher.submit(row) for row in b]
        return np.stack([x.result(timeout=600) for x in replies])

    def prompts_fn(rng, n):
        return cands[rng.choice(held_out, n, replace=False)]

    # the last round's inner steps run under the profiler: they replay
    # the captured step, whose launches the counters never see
    profs, calls = [], []
    real_run_steps = gpu.run_steps

    def run_steps(*a, **kw):
        calls.append(1)
        if len(calls) < SPEC_DISTILL["rounds"]:
            return real_run_steps(*a, **kw)
        got, prof = _device_profile(
            "distillation, the last round's inner steps",
            lambda: real_run_steps(*a, **kw), host=False)
        profs.append(prof)
        return got

    _zero_spec_launches()
    gpu.run_steps = run_steps
    t1 = time.monotonic()
    try:
        dres = distill_draft(
            gpu, gscope, dcfg, decode_fn, prompts_fn, seed=SEED,
            seq_len=PAGED["seq_len"],
            **dict(MODEL, max_out_len=SPEC_MAX_OUT), **SPEC_DISTILL)
        distill_s = time.monotonic() - t1
    finally:
        del gpu.run_steps
        teacher.close()
    distill_counts = _spec_launches()
    dprof = profs[0]
    for n, t in target.items():
        assert torch.equal(gscope._get(n), t), f"distillation moved {n}"
    del target
    assert dres["loss_last"] < dres["loss_first"], dres
    traced = dprof["port_kernel_launches"]
    xf = sum(c for n, c in traced.items() if "xent" in n and "fwd" in n)
    xb = sum(c for n, c in traced.items() if "xent" in n and "bwd" in n)
    assert xf >= SPEC_DISTILL["inner_steps"] \
        and xb >= SPEC_DISTILL["inner_steps"], traced
    assert distill_counts["layer_norm"] > 0 \
        and distill_counts["xent_forward"] > 0 \
        and distill_counts["xent_backward"] > 0, distill_counts
    res["distill"] = dict(wall_s=distill_s, loss=dres["loss"],
                          loss_first_step=dres["loss_first"],
                          agree=dres["agree"], launches=distill_counts,
                          traced_xent=[xf, xb],
                          fallback=gpu.last_run_steps_fallback,
                          idle_share_round=_idle_share(dprof))
    log(f"speculative, distillation: {SPEC_DISTILL['rounds']} rounds in "
        f"{distill_s:.1f} s, loss {dres['loss_first']:.4f} at the first "
        f"step, {dres['loss']} at each round's last, agreement "
        f"{dres['agree']}; the target's params kept their bytes; the "
        f"profiled round's xent launches {xf} forward, {xb} backward "
        f"({SPEC_DISTILL['inner_steps']} steps); capture fallback "
        f"{gpu.last_run_steps_fallback}; launches {distill_counts} {at()}")
    # the CPU's draft follows the card's
    pf.load_numpy_params(cscope, pf.scope_to_numpy(gscope, draft_names),
                         pf.CPUPlace())

    # (5) after distillation: pinned k = 3, then the automatic controller
    # this leg's burst is the phase's host-and-device profile of a
    # speculative tick
    k3_rows, res["distilled k=3"] = wave(
        "ladder pinned at k=3, distilled draft", lb, _PinnedK(3),
        host=True)
    ties["distilled k=3"] = _rows_agree(
        "speculative distilled k=3 vs plain", k3_rows, plain_rows, tie)
    # the controller picks a rung a dispatch: bursts of steps_per_tick
    # ticks while the pool drains give it choices to make
    rows, res["auto"] = wave("ladder, automatic controller", lb,
                             drain=PAGED["steps_per_tick"])
    ties["auto"] = _rows_agree("speculative auto vs plain", rows,
                               plain_rows, tie)
    # (6) the n-gram proposer
    rows, res["ngram"] = wave("n-gram, automatic controller",
                              built["ngram"],
                              drain=PAGED["steps_per_tick"])
    ties["ngram"] = _rows_agree("speculative n-gram vs plain", rows,
                                plain_rows, tie)
    assert res["ngram"]["speculative"]["draft_steps"] == 0
    assert res["ngram"]["speculative"]["proposed"] > 0

    # (7) sampled speculation against the CPU
    sp_src = srcs[:SPEC_SAMPLED_ROWS]
    seeds = list(SAMPLED_SEEDS[:SPEC_SAMPLED_ROWS])
    records = []
    restores = [_record_margins(records), _record_spec_margins(records)]
    try:
        a_rows, res["sampled"] = wave("sampled k=3", built["sampled"],
                                      prompts=sp_src, seeds=seeds,
                                      burst=False)
        torch.cuda.synchronize()
    finally:
        for restore in restores:
            restore()
    order = list(reversed(range(SPEC_SAMPLED_ROWS)))
    b_rows, res["sampled reversed"] = wave(
        f"sampled k=3, reversed at {SAMPLED_STEPS_B} a burst",
        built["sampled"], prompts=sp_src[order],
        seeds=[seeds[i] for i in order], steps=SAMPLED_STEPS_B)
    back = np.empty_like(b_rows)
    back[order] = b_rows
    margins = _margins_by_row(records, seeds)
    least = min(margins.values())
    res["sampled"]["least_margin"] = least
    res["sampled reversed"]["ties"] = _sampled_rows_agree(
        "speculative sampled, reversed vs first", back, a_rows, margins)
    t1 = time.monotonic()
    cpu_rows, _, _ = _serve_continuous(
        serving.PagedContinuousGenerationServer(
            built["cpu"], executor=cpu, scope=cscope,
            steps_per_tick=PAGED["steps_per_tick"], start=False,
            radix_reuse=False), sp_src, seeds)
    res["sampled"]["cpu_s"] = time.monotonic() - t1
    res["sampled"]["ties_cpu"] = _sampled_rows_agree(
        "speculative sampled, card vs CPU", a_rows, cpu_rows, margins)
    log(f"speculative sampled: least card margin {least:.3e} over "
        f"{len(margins)} (row, position) draws and tests; the CPU server "
        f"in {res['sampled']['cpu_s']:.1f} s {at()}")
    # (8) the distilled k = 3 rows against the CPU whole loop
    t1 = time.monotonic()
    ref = cpu.run(whole, feed={"src_ids": srcs[:SPEC_CPU_ROWS]},
                  fetch_list=[out], scope=cscope)[0]
    ref = serving.apply_eos_sentinel(ref, MODEL["end_id"])
    res["cpu_whole_s"] = time.monotonic() - t1
    ties["k=3 vs CPU"] = _rows_agree("speculative k=3 vs CPU",
                                     k3_rows[:SPEC_CPU_ROWS], ref, tie)
    res["ties"] = ties
    shares = {}
    for tag in ("auto", "ngram"):
        sp = res[tag]["speculative"]
        n = sum(w["dispatches"] for w in sp["per_k"].values())
        shares[tag] = {kv: w["dispatches"] / n
                       for kv, w in sp["per_k"].items()} if n else None
    res["per_k_shares"] = shares
    for leg in res.values():
        if isinstance(leg, dict) and leg.get("speculative"):
            leg["speculative"] = {
                k: v for k, v in leg["speculative"].items()
                if k in ("proposed", "accepted", "emitted", "draft_steps",
                         "target_steps", "acceptance_rate",
                         "mean_accepted_len", "per_k", "controller")}
    assert served["layer_norm"] > 0 and \
        served["paged_decode_attention"] > 0, served
    log(f"speculative: acceptance raw k=3 {res['raw k=3']['acceptance']}, "
        f"distilled k=3 {res['distilled k=3']['acceptance']}, auto "
        f"{res['auto']['acceptance']} (rung shares {shares['auto']}), "
        f"n-gram {res['ngram']['acceptance']} ({shares['ngram']}); ties "
        f"{ties}; the whole-loop CPU rows in {res['cpu_whole_s']:.1f} s; "
        f"on {card_name} ({card}) {at()}")
    return served, distill_counts, res


# ---------------------------------------------------------------------------
# bf16 (AMP): the attention kernels #2-#6 and the training legs
# ---------------------------------------------------------------------------
def _bf16_gate(got, want):
    """(max |got - want| over the largest |want|, the share of elements
    whose values differ), for the logs: the gate is `_bf16_ulp_ok`."""
    g, w = got.float(), want.float()
    return (float((g - w).abs().max()) / float(w.abs().max()),
            float((g != w).float().mean()))


def _bf16_ulps(got, want):
    """(max |got - want| in bf16 ulps of the largest |want|, the share of
    elements that differ). Both sides round fp32 values once, so an
    element whose two fp32 values straddle a rounding boundary moves by
    one ulp of itself, at most one ulp of the largest |want|: 2^-8 to
    2^-7 of it, by where it lies in its binade (2^-8 of the largest alone
    is less than that ulp when the largest lies below the next power of
    two)."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    ulp = 2.0 ** (math.frexp(top)[1] - 8) if top > 0 else 2.0 ** -133
    return (float((g - w).abs().max()) / ulp,
            float((g != w).float().mean()))


def _bf16_ulp_ok(got, want):
    ulps, share = _bf16_ulps(got, want)
    return (bool(torch.isfinite(got.float()).all()) and ulps <= 1.0
            and share <= BF16_SHARE)


def _f64_attention(q, k, v, scale, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril(s.shape[-1] - s.shape[-2])
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())


def _f64_flash_grads(q, k, v, g, scale, causal):
    """The attention's grads in float64, by autograd."""
    qkv = [x.double().requires_grad_() for x in (q, k, v)]
    out = _f64_attention(*qkv, scale, causal)
    return torch.autograd.grad(out, qkv, g.double())


def _f64_sdpa_bwd(q, k, v, p, g, scale, single_bf16_ds=False):
    """sdpa_short's backward from the saved P in float64; with
    `single_bf16_ds` dS rounded to one bf16 term before its products (a
    kernel that did not split it)."""
    q, k, v, p, g = (x.double() for x in (q, k, v, p, g))
    p = p.reshape(*q.shape[:2], *p.shape[-2:])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if single_bf16_ds:
        ds = ds.to(torch.bfloat16).double()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale, dv)


def _f64_ratio(got, want, oracle):
    """How much further `got` lies from the float64 oracle than the plain
    version does: at most 2 passes."""
    g = float((got.double() - oracle).abs().max())
    w = float((want.double() - oracle).abs().max())
    return g / max(w, 1e-30)


def _bf16_bound_ms(nbytes, products):
    """The bf16 bound: bytes over 3.35 TB/s against the products over
    989 TFLOP/s (bf16 dense, the data sheet's)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = products / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _lib_sdpa_bf16(q, k, v, scale, causal=False):
    """torch's fused SDPA in bf16, its flash backend alone: the
    yardstick. The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale, is_causal=causal)


def _attn_forms():
    """Each operand form of bf16 #2's and #6's wgmma kernels
    (`KA.WGMMA_FORMS`: SS with both operands K-major, SS with both
    MN-major, RS with A's hi/lo planes from the accumulator layout and B
    MN-major) at n 64 and 128, a [64, n] x depth-128 product, against
    float64 on the operands' exact values (form 2's error counted beyond
    the planes' own 2^-17 of each value), before anything else runs on
    them. Returns {form n: error over the largest sum |a b|}."""
    res = {}
    for form, (fname, ta, tb, planes) in enumerate(KA.WGMMA_FORMS):
        for n in (64, 128):
            gen = torch.Generator(device="cuda").manual_seed(form * 1000 + n)
            a = torch.randn(64, 128, device="cuda", generator=gen)
            b = torch.randn(128, n, device="cuda", generator=gen)
            am = a if planes else (a.T if ta else a).contiguous().to(
                torch.bfloat16)
            bm = (b if tb else b.T).contiguous().to(torch.bfloat16)
            got = KA.wgmma_form_bf16(form, am, bm)
            a64, b64 = am.double(), bm.double()
            a64, b64 = a64.T if ta else a64, b64 if tb else b64.T
            want, mag = a64 @ b64, a64.abs() @ b64.abs()
            err = (got.double() - want).abs()
            if planes:
                err = (err - PLANES_REL * mag).clamp(min=0)
            res[f"{fname} n {n}"] = float(err.max()) / float(mag.max())
            assert torch.equal(got, KA.wgmma_form_bf16(form, am, bm))
    log("  bf16 #2/#6 wgmma operand forms [64, n] x 128 against float64: "
        + ", ".join(f"{k} {v:.2e}" for k, v in res.items())
        + f" of the largest sum |a b| (tol {PRODUCT_REL:.2e})")
    assert max(res.values()) <= PRODUCT_REL, res
    return res


def _attn_bf16_entries():
    """#2-#6 on bf16 q, k, v and dO at the training path's shapes
    ([32,8,512,64] sdpa_short, [16,8,1024,64] flash), causal and not:
    outputs, the saved bf16 P and the grads within one bf16 ulp of the
    largest |plain| (`_bf16_ulp_ok`) in at most BF16_SHARE of the
    elements, lse within LSE_TOL; each no further from a float64 oracle
    than twice the plain version is; a second launch the same bits; #5's
    output the same with P and without. Planted faults must fail the
    gate: the flash backward fed an lse off by 1e-2, the forwards and the
    flash backward launched with the causal flag dropped, #6's dS as one
    bf16 term, #4's design with P^T fed to dv as one bf16 term, and #5's
    with P normalized by the running max. Then each kernel's time beside
    its bf16 bound, its plain version and the library's flash SDPA
    (forward; its backward, which computes dq, dk and dv together, beside
    the backward kernels)."""
    forms = _attn_forms()
    out = {n: dict(errs=[], ratios=[]) for n in (
        "sdpa_short", "sdpa_short_bwd", "flash_attention", "flash_bwd_dq",
        "flash_bwd_dkv")}
    bf = torch.bfloat16
    # flash also at d 128 (a quarter of the batch): #2-#4's other wgmma
    # instance, two warpgroups on the same rows or keys
    for kind, (b, h, t, d) in (("sdpa_short", (TRAIN_TOKENS // 512, 8, 512,
                                               64)),
                               ("flash", (TRAIN_TOKENS // 1024, 8, 1024,
                                          64)),
                               ("flash", (TRAIN_TOKENS // 4096, 8, 1024,
                                          128))):
        for causal in (False, True):
            q, k, v = (x.to(bf) for x in _qkv(b, h, t, t, d, seed=70 + t))
            g = _randn_like(q, 71 + t).to(bf)
            scale = d ** -0.5
            oracle = _f64_attention(q, k, v, scale, causal)
            if kind == "sdpa_short":
                runs = [KA._sdpa_short_launch(q, k, v, scale, causal, True)
                        for _ in range(2)]
                primal = KA._sdpa_short_launch(q, k, v, scale, causal,
                                               False)
                o, p = runs[0]
                wo, wp = KA.sdpa_short_plain(q, k, v, scale, causal,
                                             save_p=True)
                grads = [KA.sdpa_short_bwd(q, k, v, p, g, scale, causal)
                         for _ in range(2)]
                wgrads = KA.sdpa_short_bwd_plain(q, k, v, p, g, scale)
                f64 = _f64_sdpa_bwd(q, k, v, p, g, scale)
                single = [x.to(bf) for x in _f64_sdpa_bwd(
                    q, k, v, p, g, scale, single_bf16_ds=True)]
                _, p_run = KA.sdpa_short_tiles_plain(q, k, v, scale, causal,
                                                     p_max="running")
                faults = {"dS as one bf16 term": not all(
                    _bf16_ulp_ok(a, w)
                    for a, w in zip(single[:2], wgrads[:2])),
                    "#5 P from the running max": not _bf16_ulp_ok(p_run, wp)}
                res_ok = _bf16_ulp_ok(p, wp)
                res_gate = _bf16_ulps(p, wp)
                bwd_names = ("sdpa_short_bwd",) * 3
            else:
                runs = [KA._flash_attention_launch(q, k, v, scale, causal,
                                                   True) for _ in range(2)]
                primal = KA._flash_attention_launch(q, k, v, scale, causal,
                                                    False)
                o, p = runs[0]
                wo, wp = KA.flash_attention_plain(q, k, v, scale, causal,
                                                  with_lse=True)
                grads = [KA.flash_attention_bwd(q, k, v, o, p, g, scale,
                                                causal) for _ in range(2)]
                wgrads = KA.flash_attention_bwd_plain(q, k, v, o, p, g,
                                                      scale, causal)
                f64 = _f64_flash_grads(q, k, v, g, scale, causal)
                bad = KA.flash_attention_bwd(q, k, v, o, p + 1e-2, g, scale,
                                             causal)
                delta = KA.flash_delta(o, g)
                _, dv1 = KA.flash_bwd_dkv_tiles_plain(
                    q, k, v, g, p, delta, scale, causal, p_terms=1)
                dq1 = KA.flash_bwd_dq_tiles_plain(
                    q, k, v, g, p, delta, scale, causal, ds_terms=1)
                faults = {"lse + 1e-2": not all(
                    _bf16_ulp_ok(a, w) for a, w in zip(bad, wgrads)),
                    "#4 P^T as one bf16 term": not _bf16_ulp_ok(dv1,
                                                                wgrads[2]),
                    "#3 dS as one bf16 term": not _bf16_ulp_ok(dq1,
                                                               wgrads[0])}
                del dv1, dq1, delta
                if causal:
                    bad = KA.flash_attention_bwd(q, k, v, o, p, g, scale,
                                                 False)
                    faults["bwd causal dropped"] = not all(
                        _bf16_ulp_ok(a, w) for a, w in zip(bad, wgrads))
                res_gate = (max_err(p, wp), 0.0)
                res_ok = res_gate[0] <= LSE_TOL
                bwd_names = ("flash_bwd_dq", "flash_bwd_dkv",
                             "flash_bwd_dkv")
            if causal:
                launch = KA._sdpa_short_launch if kind == "sdpa_short" \
                    else KA._flash_attention_launch
                faults["fwd causal dropped"] = not _bf16_ulp_ok(
                    launch(q, k, v, scale, False, False), wo)
            torch.cuda.synchronize()
            fname = "sdpa_short" if kind == "sdpa_short" \
                else "flash_attention"
            repeat = (torch.equal(runs[0][0], runs[1][0])
                      and torch.equal(runs[0][1], runs[1][1])
                      and torch.equal(primal, o)
                      and all(torch.equal(a, b_)
                              for a, b_ in zip(*grads)))
            fwd_gate = _bf16_ulps(o, wo)
            fwd_ratio = _f64_ratio(o, wo, oracle)
            bwd = [(n, _bf16_ulps(a, w), _f64_ratio(a, w, f))
                   for n, a, w, f in zip(("dq", "dk", "dv"), grads[0],
                                         wgrads, f64)]
            log(f"  {fname} bf16 [{b},{h},{t},{d}] causal={causal}: out "
                f"{fwd_gate[0]:.2f} ulp of the largest, share "
                f"{fwd_gate[1]:.4f} (tol 1 ulp, {BF16_SHARE}), "
                f"{fwd_ratio:.2f}x the plain version's distance to float64; "
                f"residual {res_gate[0]:.3e} share {res_gate[1]:.4f}; grads "
                + ", ".join(f"{n} {gt[0]:.2f} ulp share {gt[1]:.4f} "
                            f"{r:.2f}x" for n, gt, r in bwd)
                + f"; the same bits twice {repeat}; planted faults fail "
                f"{faults}")
            assert _bf16_ulp_ok(o, wo) and res_ok, (fwd_gate, res_gate)
            assert fwd_ratio <= 2.0, fwd_ratio
            for (n, gt, r), a, w in zip(bwd, grads[0], wgrads):
                assert _bf16_ulp_ok(a, w) and r <= 2.0, (n, gt, r)
            assert repeat and all(faults.values()), (repeat, faults)
            out[fname]["errs"].append(max_err(o, wo))
            out[fname]["ratios"].append(fwd_ratio)
            for name, (_, gt, r), a, w in zip(bwd_names, bwd, grads[0],
                                              wgrads):
                out[name]["errs"].append(max_err(a, w))
                out[name]["ratios"].append(r)
            del runs, grads, wgrads, f64, oracle
            if kind == "sdpa_short":
                del single, p_run
    ptxas = _wgmma_ptxas()
    for kname, line in ptxas.items():
        if "attn_wgmma" in kname:
            log(f"  ptxas {kname}: {line}")
    design = {
        "flash_attention": (
            "d 64 and 128: wgmma.mma_async fed by TMA, a persistent block "
            "an SM walking (bh, 128 query rows) items in two consumer "
            "warpgroups, 128-key tiles (64 at d 128), "
            "S = q k^T SS, P as bf16 hi/lo planes in registers for P v (RS), "
            "V MN-major (csrc/attn_wgmma.cuh); d 256 flash_fwd.cuh's "
            "mma.sync body"),
        "sdpa_short": (
            "d 64 and 128: #2's wgmma.mma_async kernel fed by TMA "
            "(csrc/attn_wgmma.cuh fwd_kernel) at tq == tk, no lse; with P "
            "two grids: fwd_kernel writing its lse into a scratch, then "
            "p_kernel on the same items and ring, S = q k^T again (SS), "
            "P = ex2(S c - lse log2e) staged as bf16 by each warp and "
            "written by TMA stores (2-byte stores where T % 8 != 0)"),
        "flash_bwd_dq": (
            "d 64 and 128: wgmma.mma_async fed by TMA (csrc/attn_wgmma.cuh "
            "flash_dq_kernel): #2's persistent grid of (bh, 128 query rows; "
            "64 at d 128) items, q and dO resident (two buffers), the rows' "
            "lse and delta in registers, 64-key tiles of k and v by TMA, S "
            "and dP SS, P = ex2(S c - lse log2e) and dS on the fragments, "
            "dq += dS k as hi/lo planes (RS, k MN-major) into a fresh chain "
            "a tile retired into an fp32 sum in registers; d 256 "
            "split_bf16.cuh's mma.sync body"),
        "flash_bwd_dkv": (
            "d 64 and 128: wgmma.mma_async fed by TMA (csrc/attn_wgmma.cuh "
            "flash_dkv_kernel): a block per (bh, 128 keys; 64 at d 128), k "
            "and v resident, 64-row query tiles of q and dO by TMA with "
            "their lse and delta (bulk copy where tq % 4 == 0, else "
            "gathered), S^T and dP^T SS, P^T = ex2(S^T c - lse log2e) and "
            "dS^T on the fragments, dv += P^T dO and dk += dS^T q as hi/lo "
            "planes (RS) in chains of two tiles retired into fp32 sums in "
            "shared memory; d 256 split_bf16.cuh's mma.sync body"),
        "sdpa_short_bwd": (
            "wgmma.mma_async fed by TMA (csrc/attn_wgmma.cuh): grid 1 dq and "
            "delta = rowsum(dP P) over 128-key tiles, dS as hi/lo planes "
            "(RS); grid 2 dk, dv over 64-row query tiles, P^T dO SS with P "
            "MN-major, dS^T planes (RS); P gathered by the producer warp "
            "where T % 8 != 0")}
    source = {"flash_bwd_dkv": "flash_attention_bwd",
              "flash_bwd_dq": "flash_attention_bwd"}
    extra = {n: dict(design=d, ptxas={
        k: v for k, v in ptxas.items()
        if k.startswith(source.get(n, n) + ":")}, forms_rel_err=forms)
        for n, d in design.items()}
    return out | _bf16_timing() | {"extra": extra}


def _bf16_timing():
    """Times at the main shapes, non-causal, in bf16: each kernel, its
    plain version, its bf16 bound and the library's flash SDPA."""
    bf = torch.bfloat16
    res = {}
    for kind, (b, h, t, d) in (("sdpa_short", (TRAIN_TOKENS // 512, 8, 512,
                                               64)),
                               ("flash", (TRAIN_TOKENS // 1024, 8, 1024,
                                          64))):
        q, k, v = (x.to(bf) for x in _qkv(b, h, t, t, d, seed=80 + t))
        g = _randn_like(q, 81 + t).to(bf)
        scale = d ** -0.5
        n = q.numel()
        products = 2 * b * h * t * t * d  # one [t, t] x [t, d] product
        lib_ms = time_ms(lambda: _lib_sdpa_bf16(q, k, v, scale))
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        lo = _lib_sdpa_bf16(qr, kr, vr, scale)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lo, (qr, kr, vr), g, retain_graph=True), iters=10)
        if kind == "sdpa_short":
            names = ("sdpa_short", "sdpa_short_bwd")
            fwd = (lambda: KA._sdpa_short_launch(q, k, v, scale, False,
                                                 False))
            fwd_res = (lambda: KA._sdpa_short_launch(q, k, v, scale, False,
                                                     True))
            _, p = fwd_res()
            calls = {"sdpa_short_bwd": (
                lambda: KA.sdpa_short_bwd(q, k, v, p, g, scale),
                lambda: KA.sdpa_short_bwd_plain(q, k, v, p, g, scale),
                2 * (7 * n + b * h * t * t), 4 * products)}
            plain = (lambda: KA.sdpa_short_plain(q, k, v, scale, False))
            res_bytes = 2 * b * h * t * t
        else:
            names = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv")
            fwd = (lambda: KA._flash_attention_launch(q, k, v, scale,
                                                      False, False))
            fwd_res = (lambda: KA._flash_attention_launch(q, k, v, scale,
                                                          False, True))
            o, lse = fwd_res()
            delta = KA.flash_delta(o, g)
            lse_b = 2 * 4 * b * h * t  # lse and delta, fp32
            calls = {
                "flash_bwd_dq": (
                    lambda: KA.flash_bwd_dq(q, k, v, g, lse, delta, scale),
                    lambda: KA.flash_bwd_dq_plain(q, k, v, g, lse, delta,
                                                  scale, False),
                    2 * 5 * n + lse_b, 3 * products),
                "flash_bwd_dkv": (
                    lambda: KA.flash_bwd_dkv(q, k, v, g, lse, delta, scale),
                    lambda: KA.flash_bwd_dkv_plain(q, k, v, g, lse, delta,
                                                   scale, False),
                    2 * 6 * n + lse_b, 4 * products)}
            plain = (lambda: KA.flash_attention_plain(q, k, v, scale,
                                                      False))
            res_bytes = 4 * b * h * t
        ms, plain_ms = time_ms(fwd), time_ms(plain)
        res_ms = time_ms(fwd_res)
        bms, by = _bf16_bound_ms(2 * 4 * n, 2 * products)
        rbms, _ = _bf16_bound_ms(2 * 4 * n + res_bytes, 2 * products)
        res[names[0]] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library_ms=lib_ms,
                             residual_ms=res_ms, residual_bound_ms=rbms,
                             shape=[b, h, t, d])
        log(f"  {names[0]} bf16 [{b},{h},{t},{d}] non-causal: kernel "
            f"{ms:.4f} ms (with its residual {res_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, library flash sdpa {lib_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; with the residual {rbms:.4f})")
        for name, (kern, pl, nbytes, prods) in calls.items():
            kms, kpl = time_ms(kern, iters=10), time_ms(pl, iters=5)
            bms, by = _bf16_bound_ms(nbytes, prods)
            res[name] = dict(ms=kms, plain_ms=kpl, bound_ms=bms,
                             bound_by=by, library_ms=lib_bwd_ms,
                             library="flash sdpa backward (dq, dk, dv)",
                             shape=[b, h, t, d])
            log(f"  {name} bf16 [{b},{h},{t},{d}] non-causal: kernel "
                f"{kms:.4f} ms, plain {kpl:.4f} ms, library flash sdpa "
                f"backward (dq, dk and dv) {lib_bwd_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by})")
        del q, k, v, g, qr, kr, vr, lo
    return {"timing": res}


def _bf16_line(raw):
    """Each kernel's `bf16` field of the kernels line (its launches are
    added by the bf16 training legs)."""
    timing, extra = raw.pop("timing"), raw.pop("extra")
    return {n: dict(max_abs_err=max(e["errs"]),
                    f64_ratio=max(e["ratios"]), **timing[n],
                    **extra.get(n, {}))
            for n, e in raw.items()}


def _attention_block_f64(x, wqkv, wo, p, g, h, scale, causal):
    """The attention block in float64 from the same inputs: (its P, its
    output, and its grads from the saved P `p`), the oracle of the bf16
    gate's distance check."""
    b, t, d = x.shape
    xd, wq, wod, gd = (z.double() for z in (x, wqkv, wo, g))
    q, k, v = (z.reshape(b, t, h, -1).transpose(1, 2)
               for z in (xd @ wq).split(d, dim=2))
    merge = lambda z: z.transpose(1, 2).reshape(b, t, -1)  # noqa: E731
    p64 = _attention_block_p_f64(x, wqkv, h, scale, causal)
    out = merge(p64 @ v) @ wod
    p = p.double()
    dwo = merge(p @ v).reshape(-1, d).T @ gd.reshape(-1, d)
    dctx = (gd @ wod.T).reshape(b, t, h, -1).transpose(1, 2)
    dv = p.transpose(-1, -2) @ dctx
    dp = dctx @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dqkv = torch.cat([merge(ds @ k * scale),
                      merge(ds.transpose(-1, -2) @ q * scale), merge(dv)],
                     dim=2)
    return p64, out, (dqkv @ wq.T,
                      xd.reshape(-1, d).T @ dqkv.reshape(-1, 3 * d), dwo)


def _ffn_block_f64(x, w1, b1, w2, b2, g, mask):
    """The FFN block's output and grads in float64, the backward's ReLU
    mask pinned to `mask`."""
    d = w1.shape[0]
    x2, g2 = x.reshape(-1, d).double(), g.reshape(-1, d).double()
    w1d, w2d = w1.double(), w2.double()
    pre = x2 @ w1d + b1.double()
    out = (torch.relu(pre) @ w2d + b2.double()).reshape(x.shape)
    dh = torch.where(mask, g2 @ w2d.T, 0.0)
    return out, ((dh @ w1d.T).reshape(x.shape), x2.T @ dh, dh.sum(0),
                 (torch.relu(pre) * mask).T @ g2, g2.sum(0))


def _ffn_gate_ok(got, wfo, wfg, fo64, fg64):
    """The bf16 FFN gate on (out, (dx, dw1, db1, dw2, db2)): each within
    one ulp at its largest |plain| in at most BF16_SHARE of the elements
    and no further from float64 than twice the plain version."""
    out, grads = got
    return all(_bf16_ulp_ok(u, w) and _f64_ratio(u, w, r) <= 2.0
               for u, w, r in zip((out, *grads), (wfo, *wfg),
                                  (fo64, *fg64)))


# one product of the bf16 FFN kernels' engine against float64, over the
# largest row-by-column sum of |products| (tests/test_torch_fused_bf16.py):
# the engine's fresh accumulator every 256 terms keeps well inside it at
# depth 32768; one wgmma accumulator over all of them must not (a control)
PRODUCT_REL = 2 ** -21
PLANES_REL = 2 ** -17  # hi + lo planes against the fp32 value


def _ffn_layouts():
    """Each of the six operand layouts of the bf16 fused blocks' products
    (`KBP.PRODUCT_LAYOUTS`), unsplit into fp32, and the planes-only
    epilogue (`KBP.SPLIT_LAYOUT`, x W1's layout into hi + lo planes, as
    the attention block writes qkv and dctx; its error counted beyond
    the planes' own rounding, 2^-17 of each value), against float64 on
    the operands' exact values, at a ragged shape (m 200, n 72, k 40) and
    at the depth of a weight gradient at batch 128 before its split (k
    32768); at that depth also with one accumulator for all of k, which
    must fail. Returns {case: largest error}."""
    res = {}
    for m, n, k, group in ((200, 72, 40, 4), (128, 256, 32768, 4),
                           (128, 256, 32768, 0)):
        errs = []
        for layout, (_, ta, tb, _, _) in enumerate(KBP.PRODUCT_LAYOUTS):
            gen = torch.Generator(device="cuda").manual_seed(layout)
            a = torch.randn(m, k, device="cuda", generator=gen)
            b = torch.randn(k, n, device="cuda", generator=gen)
            am, bm = KBP.layout_operands(layout, a, b)
            got = KBP.product_bf16(layout, am, bm, m, n, k, group)
            a64, b64 = am.double().sum(0), bm.double().sum(0)
            a64, b64 = a64.T if ta else a64, b64 if tb else b64.T
            want = a64 @ b64
            err = (got.double() - want).abs()
            if layout == KBP.SPLIT_LAYOUT:
                err = (err - PLANES_REL * want.abs()).clamp(min=0)
            errs.append(float(err.max())
                        / float((a64.abs() @ b64.abs()).max()))
            if layout == 0:  # torch.matmul's fp32 product, for scale
                fp32 = float(((a64.float() @ b64.float()).double()
                              - a64 @ b64).abs().max()) / float(
                    (a64.abs() @ b64.abs()).max())
        what = (f"a fresh accumulator every {64 * group} terms" if group
                else "one accumulator (the control)")
        log(f"  bf16 engine's six operand layouts and x W1 into planes "
            f"[m {m}, n {n}, k "
            f"{k}], {what}, against float64: "
            + ", ".join(f"{KBP.PRODUCT_LAYOUTS[i][0]} {e:.2e}"
                        for i, e in enumerate(errs))
            + f" of the largest sum |a b| (tol {PRODUCT_REL:.2e}; "
            f"torch.matmul in fp32 on x W1's operands {fp32:.2e})")
        if group:
            assert max(errs) <= PRODUCT_REL, errs
        else:
            assert min(errs) > PRODUCT_REL, errs
        res[f"k {k}" + ("" if group else ", one accumulator")] = (
            max(errs) if group else min(errs))
    return res


def _wgmma_ptxas():
    """ptxas's registers, spills and static shared memory for each
    instance of the bf16 engine's product (ffn_block.cu's and
    attention_block.cu's builds), of the attention stages on bf16 planes
    (attention_block.cu's) and of the bf16 attention kernels on wgmma
    (flash_attention.cu's, sdpa_short.cu's, flash_attention_bwd.cu's and
    sdpa_short_bwd.cu's), keyed "source: mangled name"."""
    out = {}
    for src in ("ffn_block", "attention_block", "flash_attention",
                "sdpa_short", "flash_attention_bwd", "sdpa_short_bwd"):
        name = None
        for line in build.PTXAS_LOG.get(src, "").splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                keep = "wgmma_bf16" in name or "attn_wgmma" in name or (
                    "attn_bwd_from_p" in name and "planes" in name)
                name = f"{src}: {name}" if keep else None
            elif name and ("registers" in line or "spill" in line):
                out.setdefault(name, []).append(
                    line.split(" : ")[-1].strip())
    return {n: "; ".join(v) for n, v in out.items()}


def _fused_bf16_flops(b, t, d, h, f):
    """{kernel: (bytes, flops, flops as run)} of bf16 #10-#13 at x [b, t,
    d], H h, F f, non-causal. Bytes: each input read once, each output
    written once (#11 also reads the saved fp32 P). Flops: the products
    the function computes, each counted once, as the TPU kernel computes
    them; #11 and #13 recompute the forward's qkv and ctx or h, which
    they need and are not given. As run: the terms the bf16 kernels run
    for each product, an operand kept as two bf16 planes counting twice
    and two planed (or split-TF32) operands three times."""
    n_x, n_p, gemm = b * t * d, b * h * t * t, 2 * b * t * d
    att = 2 * n_p * (d // h)  # one [T, T] x [T, Dh] product, all heads
    return {
        # x Wqkv, q k^T, P v, ctx Wo; as run x Wqkv 1 term, q k^T and
        # P v split TF32 (3), ctx Wo 2 (ctx as two bf16 planes)
        "attention_block": (
            2 * (2 * n_x + 4 * d * d),
            gemm * 3 * d + 2 * att + gemm * d,
            gemm * 3 * d + 3 * 2 * att + 2 * gemm * d),
        # qkv, ctx = P v, dWo, dctx, the five attention-stage products (dP
        # and dq; dP^T, dv and dk), dWqkv, dx; as run qkv 1, P v 3, dWo 2,
        # dctx 1, the stages 3 each, dWqkv 2, dx 2
        "attention_block_bwd": (
            2 * (3 * n_x + 8 * d * d) + 4 * n_p,
            3 * gemm * 3 * d + 2 * gemm * d + 5 * att,
            gemm * 3 * d + 3 * att + 2 * gemm * d + gemm * d
            + 5 * 3 * att + 2 * 2 * gemm * 3 * d),
        # x W1, h W2; as run x W1 1, h W2 2
        "ffn_block": (2 * (2 * n_x + 2 * d * f + f + d), 2 * gemm * f,
                      3 * gemm * f),
        # hidden, dW2, dh, dW1, dx; as run 1, 2, 1, 2, 2
        "ffn_block_bwd": (2 * (3 * n_x + 4 * d * f + 2 * f + d),
                          5 * gemm * f, 8 * gemm * f),
    }


def _fused_bf16_entries():
    """#10-#13 on bf16 x, weights and g at the training shape (x
    [64,256,512], H 8, F 2048), causal and not for the attention block:
    each output and grad within one bf16 rounding of its plain version
    (one ulp at its largest |plain|, `_bf16_ulps`) in at most BF16_SHARE
    of the elements, and no further from the float64 oracle than twice the
    plain version is (the FFN backward's ReLU masks pinned to the
    forward kernel's hidden, which #13 recomputes with one code path, the
    units whose mask differs from the plain recompute's within FUSED_RTOL
    of the largest |pre-activation| of zero); saved P fp32 within P_TOL of the
    plain composition in float64; a second launch the same bits (the
    attention_block forward's output the same with P and without).
    Planted faults must fail the gate: the attention_block forward with
    the causal flag dropped, and the FFN backward with dh entered as one
    bf16 term (a plain control: what a kernel that dropped the low part
    of that fp32 intermediate computes); and two designs the bf16
    attention block must not take (plain controls,
    `attention_block_planes_plain`): q and k as two bf16 planes in the
    scores (its P misses P_TOL) and dqkv as one bf16 term (its gradients
    miss the gate); that design itself must pass it. Then times,
    non-causal: each kernel beside its bf16 bound (`_fused_bf16_flops`:
    bytes over 3.35 TB/s against the function's products over 989
    TFLOP/s), its TFLOP/s of those products and as the kernels run them,
    its plain version and the library's
    composition in bf16 (`_lib_attention_block`: cuBLAS products around
    F.scaled_dot_product_attention; `_lib_ffn`: addmm, relu, addmm),
    forward and under autograd."""
    bf = torch.bfloat16
    b, t, d, h, f = TRAIN_TOKENS // 256, 256, 512, 8, 2048
    scale = (d // h) ** -0.5
    out = {n: dict(errs=[], ratios=[]) for n in (
        "attention_block", "attention_block_bwd", "ffn_block",
        "ffn_block_bwd")}
    for causal in (False, True):
        a = {k: v.to(bf) for k, v in _fused_inputs(b, t, d, f,
                                                   seed=100 + causal).items()}
        x, g, wqkv, wo = a["x"], a["g"], a["wqkv"], a["wo"]
        runs = [KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                            True) for _ in range(2)]
        primal = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                             False)
        o, p = runs[0]
        wout, wp = KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale,
                                                 causal, save_p=True)
        grads = [KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale, causal)
                 for _ in range(2)]
        wgrads = KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h, scale)
        p64, o64, g64 = _attention_block_f64(x, wqkv, wo, p, g, h, scale,
                                             causal)
        p_err = float((p.double() - p64).abs().max())
        faults = {}
        if causal:
            faults["fwd causal dropped"] = not _bf16_ulp_ok(
                KAB._attention_block_launch(x, wqkv, wo, h, scale, False,
                                            False), wout)
        # the bf16 kernels' design on the plain side, and two designs it
        # must not take
        _, pq, _ = KAB.attention_block_planes_plain(
            x, wqkv, wo, g, h, scale, causal, qk_planes=True)
        pq_err = float((pq.double() - p64).abs().max())
        faults["q and k as planes: P"] = pq_err > P_TOL
        del pq
        abgate = lambda got: all(  # noqa: E731
            _bf16_ulp_ok(u, w) and _f64_ratio(u, w, r) <= 2.0
            for u, w, r in zip(got, wgrads, g64))
        _, _, one = KAB.attention_block_planes_plain(
            x, wqkv, wo, g, h, scale, causal, p=p, dqkv_terms=1)
        faults["dqkv as one bf16 term"] = not abgate(one)
        _, _, two = KAB.attention_block_planes_plain(
            x, wqkv, wo, g, h, scale, causal, p=p)
        planes_ok = abgate(two)
        del one, two
        torch.cuda.synchronize()
        repeat = (torch.equal(runs[0][0], runs[1][0])
                  and torch.equal(runs[0][1], runs[1][1])
                  and torch.equal(primal, o)
                  and all(torch.equal(u, v) for u, v in zip(*grads)))
        fwd_gate, fwd_ratio = _bf16_ulps(o, wout), _f64_ratio(o, wout, o64)
        bwd = [(n, _bf16_ulps(u, w), _f64_ratio(u, w, r))
               for n, u, w, r in zip(("dx", "dwqkv", "dwo"), grads[0],
                                     wgrads, g64)]
        log(f"  attention_block bf16 [{b},{t},{d}] H {h} causal={causal}: "
            f"out {fwd_gate[0]:.2f} ulps share {fwd_gate[1]:.4f} (tol 1 ulp, "
            f"{BF16_SHARE}; {_bf16_gate(o, wout)[0]:.3e} of the largest "
            f"|plain|), {fwd_ratio:.2f}x the plain "
            f"version's distance to float64; P ({p.dtype}) against the "
            f"plain composition in float64 {p_err:.3e} (tol {P_TOL:g}), "
            f"the kernel's against the fp32 plain version's "
            f"{max_err(p, wp):.3e}; attention_block_bwd "
            + ", ".join(f"{n} {gt[0]:.2f} ulps share {gt[1]:.4f} {r:.2f}x"
                        for n, gt, r in bwd)
            + f"; the same bits twice {repeat}; planted faults fail "
            f"{faults} (q and k as planes: P {pq_err:.3e}); the plain "
            f"version with ctx, qkv, dctx and dqkv as hi + lo planes "
            f"passes the gate {planes_ok}")
        assert o.dtype == bf and p.dtype == torch.float32
        assert _bf16_ulp_ok(o, wout) and fwd_ratio <= 2.0, (fwd_gate, fwd_ratio)
        assert p_err <= P_TOL, p_err
        for (n, gt, r), u, w in zip(bwd, grads[0], wgrads):
            assert u.dtype == bf and _bf16_ulp_ok(u, w) and r <= 2.0, (n, gt, r)
        assert repeat and all(faults.values()) and planes_ok, (
            repeat, faults, planes_ok)
        out["attention_block"]["errs"].append(max_err(o, wout))
        out["attention_block"]["ratios"].append(fwd_ratio)
        out["attention_block_bwd"]["errs"].append(
            max(max_err(u, w) for u, w in zip(grads[0], wgrads)))
        out["attention_block_bwd"]["ratios"].append(max(r for *_, r in bwd))
        del runs, primal, o, p, grads, wgrads, p64, o64, g64
        if causal:
            continue  # the FFN has no causal form
        w1, b1, w2, b2 = a["w1"], a["b1"], a["w2"], a["b2"]
        fo = [KFF._ffn_block_launch(x, w1, b1, w2, b2) for _ in range(2)]
        wfo = KFF.ffn_block_plain(x, w1, b1, w2, b2)
        fg, _ = _ffn_bwd_kernel(x, w1, b1, w2, g)
        fg2 = KFF.ffn_block_bwd(x, w1, b1, w2, g)
        # the kernels' ReLU mask: #12's hidden, which #13's recompute
        # repeats bit for bit (kflips below). #13's scratch (dh) shows it
        # only where g W2^T is not 0, and with bf16 operands that sum can
        # cancel to an exact 0
        kmask = _ffn_fwd_hidden(x.reshape(-1, d), w1, b1, w2) > 0
        n_flips, flip_max, pre_max = _relu_flips(x, w1, b1, kmask)
        wfg = _ffn_bwd_with_mask(x, w1, b1, w2, g, kmask)
        single = _ffn_bwd_with_mask(x, w1, b1, w2, g, kmask, dh_bf16=True)
        # the kernels' design on the plain side (h and dh as hi + lo bf16
        # planes), and with h as one bf16 term: a planted fault
        planes2 = KFF.ffn_block_planes_plain(x, w1, b1, w2, b2, g)
        h_single = KFF.ffn_block_planes_plain(x, w1, b1, w2, b2, g,
                                              h_terms=1)
        fo64, fg64 = _ffn_block_f64(x, w1, b1, w2, b2, g, kmask)
        kflips = _fwd_bwd_mask_flips(x.reshape(-1, d), w1, b1, w2)
        torch.cuda.synchronize()
        repeat = torch.equal(fo[0], fo[1]) and all(
            torch.equal(u, v) for u, v in zip(fg, fg2))
        ffaults = {"dh as one bf16 term": not all(
            _bf16_ulp_ok(u, w) for u, w in zip(single[:2], wfg[:2])),
            "h as one bf16 term": not _ffn_gate_ok(h_single, wfo, wfg,
                                                   fo64, fg64)}
        planes_ok = _ffn_gate_ok(planes2, wfo, wfg, fo64, fg64)
        fgate, fratio = _bf16_ulps(fo[0], wfo), _f64_ratio(fo[0], wfo, fo64)
        fbwd = [(n, _bf16_ulps(u, w), _f64_ratio(u, w, r))
                for n, u, w, r in zip(("dx", "dw1", "db1", "dw2", "db2"),
                                      fg, wfg, fg64)]
        log(f"  ffn_block bf16 [{b},{t},{d}] F {f}: out {fgate[0]:.2f} ulps "
            f"share {fgate[1]:.4f} ({_bf16_gate(fo[0], wfo)[0]:.3e} of the "
            f"largest |plain|), {fratio:.2f}x the plain version's "
            f"distance to float64; {kflips} units take one ReLU mask in "
            f"the forward's hidden and the other in the backward's "
            f"recompute; ffn_block_bwd {n_flips} of {kmask.numel()} ReLU "
            f"units take the other mask than the plain recompute's, "
            f"|pre-activation| at most {flip_max:.3e} (limit "
            f"{FUSED_RTOL * pre_max:.3e}); with the plain masks pinned to "
            f"the kernel's "
            + ", ".join(f"{n} {gt[0]:.2f} ulps share {gt[1]:.4f} {r:.2f}x"
                        for n, gt, r in fbwd)
            + f"; the same bits twice {repeat}; planted faults fail "
            f"{ffaults}; the plain version with h and dh as hi + lo "
            f"planes (unpinned) passes the gate {planes_ok}")
        assert fo[0].dtype == bf and _bf16_ulp_ok(fo[0], wfo) and fratio <= 2.0
        for (n, gt, r), u, w in zip(fbwd, fg, wfg):
            assert u.dtype == bf and _bf16_ulp_ok(u, w) and r <= 2.0, (n, gt, r)
        assert kflips == 0, kflips
        assert flip_max <= FUSED_RTOL * pre_max, (n_flips, flip_max)
        assert repeat and all(ffaults.values()), (repeat, ffaults)
        out["ffn_block"]["errs"].append(max_err(fo[0], wfo))
        out["ffn_block"]["ratios"].append(fratio)
        out["ffn_block_bwd"]["errs"].append(
            max(max_err(u, w) for u, w in zip(fg, wfg)))
        out["ffn_block_bwd"]["ratios"].append(max(r for *_, r in fbwd))
        out["ffn_block_bwd"]["relu_flips"] = n_flips
        del fo, wfo, fg, fg2, wfg, single, fo64, fg64, kmask, planes2, h_single

    # times at the training shape, non-causal
    a = {k: v.to(bf) for k, v in _fused_inputs(b, t, d, f, seed=110).items()}
    x, g, wqkv, wo = a["x"], a["g"], a["wqkv"], a["wo"]
    w1, b1, w2, b2 = a["w1"], a["b1"], a["w2"], a["b2"]
    _, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, False, True)
    tracked = {k: v.detach().requires_grad_() for k, v in a.items()
               if k != "g"}
    attn_in = (tracked["x"], tracked["wqkv"], tracked["wo"])
    ffn_in = tuple(tracked[k] for k in ("x", "w1", "b1", "w2", "b2"))
    lib_attn = _lib_attention_block(*attn_in, h, scale)
    lib_ffn = _lib_ffn(*ffn_in)
    flops = _fused_bf16_flops(b, t, d, h, f)
    cases = {
        "attention_block": (
            lambda: KAB._attention_block_launch(x, wqkv, wo, h, scale,
                                                False, False),
            lambda: KAB.attention_block_plain(x, wqkv, wo, h, scale, False),
            lambda: _lib_attention_block(x, wqkv, wo, h, scale),
            "x Wqkv, cuBLAS; SDPA (flash); ctx Wo, cuBLAS"),
        "attention_block_bwd": (
            lambda: KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale),
            lambda: KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h,
                                                  scale),
            lambda: torch.autograd.grad(lib_attn, attn_in, g,
                                        retain_graph=True),
            "the autograd backward of that composition"),
        "ffn_block": (
            lambda: KFF._ffn_block_launch(x, w1, b1, w2, b2),
            lambda: KFF.ffn_block_plain(x, w1, b1, w2, b2),
            lambda: _lib_ffn(x, w1, b1, w2, b2),
            "addmm, relu, addmm (cuBLAS)"),
        "ffn_block_bwd": (
            lambda: KFF.ffn_block_bwd(x, w1, b1, w2, g),
            lambda: KFF.ffn_block_bwd_plain(x, w1, b1, w2, g),
            lambda: torch.autograd.grad(lib_ffn, ffn_in, g,
                                        retain_graph=True),
            "the autograd backward of that composition"),
    }
    for name, (kern, plain, lib, label) in cases.items():
        nbytes, fl, as_run = flops[name]
        ms = time_ms(kern, iters=10)
        plain_ms = time_ms(plain, iters=5)
        lib_ms = time_ms(lib, iters=10)
        bms, by = _bf16_bound_ms(nbytes, fl)
        log(f"  {name} bf16 [{b},{t},{d}] H {h} F {f} non-causal: kernel "
            f"{ms:.4f} ms, {fl / ms / 1e9:.1f} TFLOP/s "
            f"({as_run / ms / 1e9:.1f} as run), plain {plain_ms:.4f} ms, library ({label}) "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}; {fl / 1e9:.2f} G "
            f"flops, {as_run / 1e9:.2f} G as run)")
        out[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms,
                         library=f"composition: {label}",
                         tflops=fl / ms / 1e9,
                         tflops_as_run=as_run / ms / 1e9,
                         shape=[b, t, d, h, f])
    del cases, tracked, attn_in, ffn_in, lib_attn, lib_ffn, p
    # #10-#13 at the bench's batch (bench.py bench_transformer_fused:
    # x [128, 256, 512]), with the same byte and product counts
    bb = 2 * b
    a = {k: v.to(bf) for k, v in _fused_inputs(bb, t, d, f, seed=111).items()}
    x, g, w1, b1, w2, b2 = (a[k] for k in ("x", "g", "w1", "b1", "w2", "b2"))
    wqkv, wo = a["wqkv"], a["wo"]
    _, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, False, True)
    ffn_in = tuple(a[k].detach().requires_grad_()
                   for k in ("x", "w1", "b1", "w2", "b2"))
    attn_in = tuple(a[k].detach().requires_grad_()
                    for k in ("x", "wqkv", "wo"))
    lib_ffn = _lib_ffn(*ffn_in)
    lib_attn = _lib_attention_block(*attn_in, h, scale)
    flops = _fused_bf16_flops(bb, t, d, h, f)
    for name, kern, lib in (
            ("attention_block",
             lambda: KAB._attention_block_launch(x, wqkv, wo, h, scale,
                                                 False, False),
             lambda: _lib_attention_block(x, wqkv, wo, h, scale)),
            ("attention_block_bwd",
             lambda: KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale),
             lambda: torch.autograd.grad(lib_attn, attn_in, g,
                                         retain_graph=True)),
            ("ffn_block", lambda: KFF._ffn_block_launch(x, w1, b1, w2, b2),
             lambda: _lib_ffn(x, w1, b1, w2, b2)),
            ("ffn_block_bwd", lambda: KFF.ffn_block_bwd(x, w1, b1, w2, g),
             lambda: torch.autograd.grad(lib_ffn, ffn_in, g,
                                         retain_graph=True))):
        nbytes, fl, as_run = flops[name]
        ms = time_ms(kern, iters=10)
        lib_ms = time_ms(lib, iters=10)
        bms, by = _bf16_bound_ms(nbytes, fl)
        log(f"  {name} bf16 [{bb},{t},{d}] H {h} F {f} (the bench's batch): "
            f"kernel {ms:.4f} ms, {fl / ms / 1e9:.1f} TFLOP/s "
            f"({as_run / ms / 1e9:.1f} as run), library {lib_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}; {fl / 1e9:.2f} G flops, "
            f"{as_run / 1e9:.2f} G as run)")
        out[name]["bench_batch"] = dict(shape=[bb, t, d, f], ms=ms,
                                        library_ms=lib_ms, bound_ms=bms,
                                        bound_by=by, tflops=fl / ms / 1e9,
                                        tflops_as_run=as_run / ms / 1e9)
    del a, ffn_in, lib_ffn, attn_in, lib_attn, p
    ptxas = _wgmma_ptxas()
    for kname, line in ptxas.items():
        if "attn_wgmma" not in kname:  # logged with #2 and #6
            log(f"  ptxas {kname}: {line}")
    for name in ("ffn_block", "ffn_block_bwd"):
        out[name]["design"] = ("wgmma.mma_async m64n128k16 fed by TMA, h "
                               "and dh as bf16 hi/lo planes "
                               "(csrc/wgmma_bf16.cuh)")
    out["attention_block"]["design"] = (
        "products on wgmma.mma_async fed by TMA (csrc/wgmma_bf16.cuh), qkv "
        "fp32, the attention stage split TF32 (flash_fwd.cuh) writing ctx "
        "as bf16 hi/lo planes")
    out["attention_block_bwd"]["design"] = (
        "products on wgmma.mma_async fed by TMA (csrc/wgmma_bf16.cuh), "
        "qkv, ctx, dctx, dqkv as bf16 hi/lo planes, the attention stages "
        "on mma.sync.m16n8k16 over planes (attn_bwd_from_p.cuh)")
    out["ffn_block"].update(
        ptxas={n: v for n, v in ptxas.items() if n.startswith("ffn")},
        layouts_rel_err=_ffn_layouts())
    out["attention_block_bwd"]["ptxas"] = {
        n: v for n, v in ptxas.items() if n.startswith("attention")}
    res = {}
    for name, e in out.items():
        errs, ratios = e.pop("errs"), e.pop("ratios")
        res[name] = dict(max_abs_err=max(errs), f64_ratio=max(ratios), **e)
    return res


def _amp_first_acts(main, op_type="attention"):
    """The outputs of the first `op_type` op (encoder self-attention) and
    of the first causal one (decoder self-attention)."""
    ops = [op for op in main.global_block.ops if op.type == op_type]
    causal = next(op for op in ops if op.attrs.get("causal"))
    return [ops[0].outputs["Out"][0], causal.outputs["Out"][0]]


def phase_train_bf16(card_name, card, seq_len, batch, fused=False):
    """Transformer-base's training program under amp.amp_guard(True)
    (bf16 AMP) at `seq_len` and `batch`: the bench's own settings at seq
    256 and batch 128 (vocab 32000, Adam under noam_decay(512, 8000),
    dropout 0), and seq 512 / batch 32 and 1024 / batch 16, where #5/#6
    and #2-#4 run in bf16; with `fused`, built with FUSE_KNOB set (the
    bench's bench_transformer_fused: #10-#13 in bf16). Step-1 parity on
    the first 2 rows against the port's CPU run under AMP: the two first
    self-attention ops' outputs (the encoder's and the decoder's causal
    one; attention ops, on the kernels at 512 and 1024, or attention_block
    ops) within AMP_ACT_REL of the largest |CPU| in at most AMP_ACT_SHARE
    of the elements, and the loss within LOSS_RTOL; the control, the
    card's step with AMP off, must fail the activation gate, and so must,
    fused, the card's step with the decoder's causal flag dropped. Then
    the eager leg and the run_steps leg (`_train_steps`) under AMP, the
    launches counted as predicted. Returns (launches by kernel,
    results)."""
    tag = f"train bf16{' fused' if fused else ''} T={seq_len} B={batch}"
    s = _train_setup(tag, seq_len, batch, fused=fused)
    main, gpu, cpu, fresh, small = (s[k] for k in ("main", "gpu", "cpu",
                                                   "fresh", "small"))
    block = "attention_block" if fused else "attention"
    fetch = [s["cost"].name] + _amp_first_acts(main, block)
    t0 = time.monotonic()
    with amp.amp_guard(True):
        ref = cpu.run(main, feed=small, fetch_list=fetch,
                      scope=fresh(pf.CPUPlace()), return_numpy=False)
        cpu_s = time.monotonic() - t0
        got = gpu.run(main, feed=small, fetch_list=fetch,
                      scope=fresh(pf.CUDAPlace(0)), return_numpy=False)
    off = gpu.run(main, feed=small, fetch_list=fetch,
                  scope=fresh(pf.CUDAPlace(0)), return_numpy=False)

    def gates(run):
        loss = abs(float(run[0]) - float(ref[0])) / abs(float(ref[0]))
        acts = [_bf16_gate(a.cpu(), w) for a, w in zip(run[1:], ref[1:])]
        ok = loss <= LOSS_RTOL and all(
            rel <= AMP_ACT_REL and share <= AMP_ACT_SHARE
            for rel, share in acts)
        return ok, loss, acts

    ok, loss, acts = gates(got)
    ctl_ok, ctl_loss, ctl_acts = gates(off)
    log(f"{tag} parity (2 rows, step 1, CPU under AMP {cpu_s:.1f} s): loss "
        f"card {float(got[0]):.7f} CPU {float(ref[0]):.7f} rel "
        f"{loss:.3e} (tol {LOSS_RTOL:g}); first {block} outputs "
        f"(encoder, decoder causal) {got[1].dtype}: "
        + ", ".join(f"rel {r:.3e} share {sh:.4f}" for r, sh in acts)
        + f" (tol {AMP_ACT_REL:.3e}, {AMP_ACT_SHARE}); control, AMP off "
        f"({off[1].dtype}): loss rel {ctl_loss:.3e}, "
        + ", ".join(f"rel {r:.3e} share {sh:.4f}" for r, sh in ctl_acts)
        + f", passes: {ctl_ok}")
    assert got[1].dtype == torch.bfloat16 and off[1].dtype == torch.float32
    assert ok, (loss, acts)
    assert not ctl_ok, "the bf16 parity gate cannot see AMP switched off"
    res = dict(parity_loss_rel_err=loss, parity_acts=acts,
               control_loss_rel_err=ctl_loss, control_acts=ctl_acts)
    ops = s["ops"]
    if fused:
        # the planted fault: the decoder's causal flag dropped on the card
        dec = [op for op in main.global_block.ops
               if op.type == block and op.attrs["causal"]]
        for op in dec:
            op.attrs["causal"] = False
        try:
            with amp.amp_guard(True):
                bad = gpu.run(main, feed=small, fetch_list=fetch,
                              scope=fresh(pf.CUDAPlace(0)),
                              return_numpy=False)
        finally:
            for op in dec:
                op.attrs["causal"] = True
        bad_ok, bad_loss, bad_acts = gates(bad)
        log(f"{tag} parity: planted fault, the decoder's causal flag "
            f"dropped on the card ({len(dec)} ops): loss rel "
            f"{bad_loss:.3e}, "
            + ", ".join(f"rel {r:.3e} share {sh:.4f}" for r, sh in bad_acts)
            + f", passes: {bad_ok}")
        assert not bad_ok, "the bf16 parity gate cannot see the fault"
        res.update(causal_dropped_loss_rel_err=bad_loss,
                   causal_dropped_acts=bad_acts)
        n_ab, n_ffn = ops.count("attention_block"), ops.count("ffn_block")
        want = _want_counts(
            xent_forward=1, xent_backward=1,
            layer_norm=ops.count("layer_norm"), attention_block=2 * n_ab,
            attention_block_bwd=n_ab, ffn_block=2 * n_ffn,
            ffn_block_bwd=n_ffn)
    else:
        want = _want_counts(**_train_per_step(ops, seq_len))
    with amp.amp_guard(True):
        counts, steps = _train_steps(tag, s, seq_len, batch, want,
                                     card_name, card)
    steps.update(res)
    return counts, steps


def _dropout_mask_parity():
    """A dropout op's keep mask on the card equals the CPU's for the same
    program seed, op and step key (int64 SplitMix64 on both)."""
    prog = pf.Program()
    prog.random_seed = SEED
    blk = prog.global_block
    blk.create_var(name="x", shape=(64, 4096), dtype="float32")
    blk.append_op("dropout", {"X": ["x"]}, {"Out": ["y"], "Mask": ["m"]},
                  {"dropout_prob": 0.1, "is_test": False, "seed": 0,
                   "dropout_implementation": "upscale_in_train"})
    x = np.ones((64, 4096), np.float32)
    masks = []
    for place in (pf.CUDAPlace(0), pf.CPUPlace()):
        exe, scope = pf.Executor(place), pf.Scope()
        masks.append([exe.run(prog, feed={"x": x}, fetch_list=["m"],
                              scope=scope)[0] for _ in range(2)])
    same = all(np.array_equal(a, b) for a, b in zip(*masks))
    log(f"  dropout: the card's masks equal the CPU's over two steps "
        f"{same}; kept {masks[0][0].mean():.4f} (0.9); steps differ "
        f"{not np.array_equal(masks[0][0], masks[0][1])}")
    assert same and not np.array_equal(masks[0][0], masks[0][1])


def _dropout_parity(tag, s):
    """Step 1 of the dropout program on the first 2 rows, card against
    the port's CPU run from the same weights, program seed and step key,
    so from the same masks: the loss within LOSS_RTOL, and the first
    dropout op's Out and the first attention op's Out (its dropout on P)
    within LOSS_RTOL of their largest |CPU|. The control, the CPU step
    from another step key (the same weights, other masks), must fail
    both activation gates. Returns the errors."""
    ops = s["main"].global_block.ops
    drop = next(op.outputs["Out"][0] for op in ops if op.type == "dropout")
    attn = next(op.outputs["Out"][0] for op in ops if op.type == "attention"
                and op.attrs.get("dropout_rate"))
    fetch = [s["cost"].name, drop, attn]

    def cpu_step(key=None):
        scope = s["fresh"](pf.CPUPlace())
        if key is not None:
            scope._set(RNG_VAR, torch.tensor(key))
        return s["cpu"].run(s["main"], feed=s["small"], fetch_list=fetch,
                            scope=scope)

    def errs(run, ref):
        loss = abs(float(run[0][0]) - float(ref[0][0])) / abs(
            float(ref[0][0]))
        return [loss] + [float(np.abs(a - b).max() / np.abs(b).max())
                         for a, b in zip(run[1:], ref[1:])]

    ref = cpu_step()
    got = s["gpu"].run(s["main"], feed=s["small"], fetch_list=fetch,
                       scope=s["fresh"](pf.CUDAPlace(0)))
    ctl = cpu_step(key=SEED + 1)
    err, ctl_err = errs(got, ref), errs(got, ctl)
    log(f"{tag} parity (2 rows, step 1, against the CPU from the same "
        f"step key): loss card {float(got[0][0]):.7f} CPU "
        f"{float(ref[0][0]):.7f} rel {err[0]:.3e}; the first dropout op's "
        f"Out {err[1]:.3e}, the first attention op's Out {err[2]:.3e} of "
        f"the largest |CPU| (tol {LOSS_RTOL:g}); control, the CPU from "
        f"another key: loss {ctl_err[0]:.3e}, Outs {ctl_err[1]:.3e}, "
        f"{ctl_err[2]:.3e}")
    assert all(e <= LOSS_RTOL for e in err), err
    assert all(e > LOSS_RTOL for e in ctl_err[1:]), \
        f"the dropout parity cannot see other masks: {ctl_err}"
    return dict(parity_errs=err, control_errs=ctl_err)


def _draw_ms(calls):
    """Device ms of one step's mask draws (`registry.keep_bits`, as
    recorded in one eager step), replayed alone at the step's shapes."""
    draw = registry.keep_bits
    return time_ms(lambda: [draw(*c) for c in calls], iters=3, warmup=1)


def phase_train_dropout(card_name, card, no_dropout):
    """Transformer-base at dropout 0.1 (every dropout site of the JAX
    package's model: embeddings, attention P, FFN hidden, before each
    add-norm), seq 256, batch 64, fp32, through run_steps: step-1 parity
    on 2 rows against the CPU (`_dropout_parity`), the step captured (no
    eager reason), K replayed steps equal K Executor.run steps within
    STEPS_RTOL, two successive calls draw other masks (the first dropout
    op's Mask fetched at every step differs from step to step), and the
    losses differ from the dropout-0 leg's (`no_dropout`, phase 5: the
    same weights and feed). The mask draws of one eager step are
    recorded and timed alone, for their share of the step."""
    seq_len, batch = TRAIN_RUNS[0]
    tag = f"train dropout T={seq_len} B={batch}"
    s = _train_setup(tag, seq_len, batch, dropout_rate=DROPOUT_RATE)
    main, gpu, cost, feed = s["main"], s["gpu"], s["cost"], s["feed"]
    parity = _dropout_parity(tag, s)
    mask = next(op.outputs["Mask"][0] for op in main.global_block.ops
                if op.type == "dropout")
    n_drop = sum(op.type == "dropout" for op in main.global_block.ops)
    n_attn = sum(op.type == "attention"
                 and bool(op.attrs.get("dropout_rate"))
                 for op in main.global_block.ops)
    scope = s["fresh"](pf.CUDAPlace(0))
    draws, real = [], registry.keep_bits

    def recording(*a):
        draws.append(a)
        return real(*a)

    torch.cuda.synchronize()
    t0 = time.monotonic()
    eager = []
    for i in range(2 * TRAIN_STEPS):
        registry.keep_bits = recording if i == 0 else real
        try:
            eager.append(gpu.run(main, feed=feed, fetch_list=[cost],
                                 scope=scope)[0])
        finally:
            registry.keep_bits = real
    torch.cuda.synchronize()
    eager_s = (time.monotonic() - t0) / (2 * TRAIN_STEPS)
    eager = np.concatenate(eager)
    draw_ms = _draw_ms(draws)
    n_drawn = sum(math.prod(a[2]) for a in draws)
    scope = s["fresh"](pf.CUDAPlace(0))
    compiles = gpu.compile_count
    calls, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        calls.append(gpu.run_steps(main, feed=feed, fetch_list=[cost, mask],
                                   steps=TRAIN_STEPS, scope=scope,
                                   return_numpy=False))
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        assert gpu.last_run_steps_fallback is None
    assert gpu.compile_count == compiles + 1, gpu.compile_count
    got = torch.cat([c[0].reshape(-1) for c in calls]).cpu().numpy()
    masks = torch.cat([c[1] for c in calls])
    err = float(np.max(np.abs(got - eager) / np.abs(eager)))
    differ = [not torch.equal(masks[i], masks[i + 1])
              for i in range(len(masks) - 1)]
    base = np.array(no_dropout["losses"])
    log(f"{tag}: {n_drop} dropout ops and {n_attn} attention ops with "
        f"dropout {DROPOUT_RATE}; captured (fallback None, one capture); "
        f"{2 * TRAIN_STEPS} replayed-call losses "
        + ", ".join(f"{x:.6f}" for x in got) + f" against as many "
        f"Executor.run steps, rel err {err:.3e} (tol {STEPS_RTOL:g}), the "
        f"same bits {bool(np.array_equal(got, eager))}; the first mask "
        f"differs between successive steps {differ}, kept share "
        f"{float(masks.float().mean()):.4f}; the dropout-0 leg's losses "
        + ", ".join(f"{x:.6f}" for x in base) + f"; eager step "
        f"{eager_s * 1e3:.1f} ms, run_steps step "
        f"{walls[1] / TRAIN_STEPS * 1e3:.1f} ms (the second call) on "
        f"{card_name} ({card})")
    log(f"{tag}: one step's {len(draws)} mask draws ({n_drawn} elements) "
        f"take {draw_ms:.2f} ms alone, {draw_ms / (eager_s * 1e3):.3f} of "
        f"the eager step and {draw_ms / (walls[1] / TRAIN_STEPS * 1e3):.3f}"
        f" of the run_steps step on {card_name} ({card})")
    assert err <= STEPS_RTOL, err
    assert all(differ), differ
    # at random weights the loss sits near log(V) at both rates: other
    # by more than the run-to-run gate at every step
    moved = np.abs(got[:TRAIN_STEPS] - base) / np.abs(base)
    assert (moved > STEPS_RTOL).all(), moved
    return dict(losses=got.tolist(), eager_losses=eager.tolist(),
                rel_err=err, masks_differ=differ,
                eager_step_ms=eager_s * 1e3,
                run_steps_step_ms=walls[1] / TRAIN_STEPS * 1e3,
                dropout_ops=n_drop, attention_dropout_ops=n_attn,
                draws=len(draws), drawn_elements=n_drawn, draw_ms=draw_ms,
                **parity)


def _recompute_program(dropout_rate=0.0, recompute=True, clip_norm=1e30):
    """Transformer-base's training program at seq 256 built as
    build_program builds it, with gradient clipping and weight decay:
    transformer(checkpoints=ck) under
    RecomputeOptimizer(Adam(noam_decay, regularization=L2Decay)) with
    set_gradient_clip(GradientClipByGlobalNorm(clip_norm)); without
    `recompute`, the same under Adam alone. Returns (main, startup,
    cost)."""
    seq_len, cfg = TRAIN_RUNS[0][0], TRAIN
    main, startup = pf.Program(), pf.Program()
    with pf.program_guard(main, startup):
        src, tgt, label = (pf.layers.data(n, shape=[seq_len], dtype="int64")
                           for n in ("src_ids", "tgt_ids", "label"))
        ck = [] if recompute else None
        cost, _ = transformer.transformer(
            src, tgt, label, src_vocab=cfg["vocab"], tgt_vocab=cfg["vocab"],
            max_len=max(seq_len, 256), d_model=cfg["d_model"],
            n_heads=cfg["n_heads"], n_layers=cfg["n_layers"],
            d_inner=cfg["d_inner"], dropout_rate=dropout_rate,
            checkpoints=ck)
        lr = pf.layers.learning_rate_scheduler.noam_decay(
            cfg["d_model"], cfg["warmup_steps"])
        opt = pf.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                                epsilon=1e-9,
                                regularization=pf.L2Decay(RECOMPUTE_L2))
        pf.set_gradient_clip(pf.GradientClipByGlobalNorm(clip_norm))
        if recompute:
            opt = pf.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ck)
        opt.minimize(cost)
    return main, startup, cost


def _clip_vars(main):
    """(the global norm's var, the clip scale's var, the fill_constant op
    that writes clip_norm) of the program's global-norm group."""
    blk = main.global_block
    gnorm = next(n for n in blk.vars if n.endswith("@GNORM"))
    cn = next(op for op in blk.ops if op.type == "fill_constant"
              and op.outputs["Out"][0] == gnorm + "@CN")
    return gnorm, gnorm + "@SCALE", cn


def _recomputed_dropout_masks(card_name):
    """The recompute program at dropout 0.1, step 1 on 2 rows on the
    card: the first dropout op's Mask against its recomputed clone's, and
    the first attention op with dropout (P's dropout, drawn in the op)'s
    Out against its clone's, which reads recomputed q, k and v: both
    equal bit for bit when the clone draws its forward's mask."""
    with unique_name.guard():
        main, startup, cost = _recompute_program(DROPOUT_RATE)
    ops = main.global_block.ops
    fwd = [op for op in ops if op.attrs.get("op_role") != "backward"]
    drop = next(op for op in fwd if op.type == "dropout")
    attn = next(op for op in fwd if op.type == "attention"
                and op.attrs.get("dropout_rate"))
    pairs = []
    for op, slot in ((drop, "Mask"), (attn, "Out")):
        name = op.outputs[slot][0]
        clone = next(c for c in ops if c is not op and c._uid == op._uid
                     and c.type == op.type
                     and c.outputs[slot][0].startswith(name + "@RECOMP"))
        pairs += [name, clone.outputs[slot][0]]
    startup.random_seed = SEED
    exe, scope = pf.Executor(pf.CUDAPlace(0)), pf.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(SEED)
    feed = {k: rs.randint(0, TRAIN["vocab"], (2, TRAIN_RUNS[0][0])).astype(
        "int64") for k in ("src_ids", "tgt_ids", "label")}
    got = exe.run(main, feed=feed, fetch_list=[cost] + pairs, scope=scope)
    same = [bool(np.array_equal(got[1 + 2 * i], got[2 + 2 * i]))
            for i in range(2)]
    kept = float(got[1].mean())
    log(f"train recompute dropout {DROPOUT_RATE}: {pairs[0]} and its "
        f"recompute {pairs[1]} equal {same[0]} (kept {kept:.4f}); "
        f"{pairs[2]} and its recompute {pairs[3]} equal {same[1]}; loss "
        f"{float(got[0][0]):.6f} on {card_name}")
    assert all(same) and 0.85 < kept < 0.95, (same, kept)
    return dict(mask_equal=same[0], attention_out_equal=same[1], kept=kept)


def phase_train_recompute(card_name, card):
    """Phase 5's configuration (seq 256, batch 64, fp32) with activation
    checkpointing, gradient clipping and weight decay
    (`_recompute_program`): every layer's output a checkpoint, the rest
    recomputed in the backward. The global-norm clip is set to CLIP_BELOW
    of the smaller step-1 global gradient norm the card reads on 2 rows
    and on the full batch. Step-1 parity on 2 rows against the port's CPU
    run by phase 5's gates (the loss, the grads and Adam's first moment,
    unpinned and with the CPU's FFN ReLU masks, forward and recomputed,
    pinned to the card's); the clip scales on both (scale < 1). Then the
    eager and run_steps legs (`_train_steps`: the captured replays within
    STEPS_RTOL of the eager steps), and the same program without
    recompute, eager, for its peak memory and losses; last, the dropout
    variant's recomputed masks (`_recomputed_dropout_masks`). Returns
    (launches by kernel, results)."""
    seq_len, batch = TRAIN_RUNS[0]
    tag = f"train recompute+clip+L2 T={seq_len} B={batch}"
    s = _train_setup(tag, seq_len, batch, build=_recompute_program)
    main, gpu, cpu, fresh = s["main"], s["gpu"], s["cpu"], s["fresh"]
    ops, small, m1 = s["ops"], s["small"], s["m1"]
    gnorm, scale_var, cn = _clip_vars(main)
    n_ck = 2 * TRAIN["n_layers"]
    log(f"{tag}: {ops.count('optimization_barrier')} optimization_barrier "
        f"ops, {sum('@RECOMP' in n for op in main.global_block.ops for n in op.output_arg_names)} "
        f"recomputed values, {n_ck} checkpoints; clip {gnorm}, weight decay "
        f"L2 {RECOMPUTE_L2}")
    # the step-1 global gradient norms, on 2 rows and on the full batch
    norms = [float(gpu.run(main, feed=f, fetch_list=[gnorm],
                           scope=fresh(pf.CUDAPlace(0)))[0][0])
             for f in (small, s["feed"])]
    clip_norm = CLIP_BELOW * min(norms)
    cn.attrs["value"] = clip_norm

    blk_ops = main.global_block.ops
    relu_in = [op.inputs["X"][0] for op in blk_ops
               if op.type == "relu" and op.attrs.get("op_role") != "backward"]
    fetch = [s["cost"].name] + [g + "@GRAD" for g in TRAIN_GRADS] + \
        [m1[g] for g in TRAIN_GRADS] + [gnorm, scale_var] + relu_in
    k = len(TRAIN_GRADS)

    def cpu_step(pin=None):
        masks = None if pin is None else {
            x: pre > 0 for x, pre in zip(relu_in, pin[3 + 2 * k:])}
        with _relu_masks(masks):
            return cpu.run(main, feed=small, fetch_list=fetch,
                           scope=fresh(pf.CPUPlace()))

    t0 = time.monotonic()
    ref = cpu_step()
    cpu_s = time.monotonic() - t0
    got = gpu.run(main, feed=small, fetch_list=fetch,
                  scope=fresh(pf.CUDAPlace(0)))
    pinned = cpu_step(pin=got)
    loss_err, grad_errs = _parity_errs(got, ref, TRAIN_GRADS)
    pin_loss, pin_errs = _parity_errs(got, pinned, TRAIN_GRADS)
    scales = [float(r[2 + 2 * k][0]) for r in (ref, got)]
    log(f"{tag} parity (2 rows, step 1; CPU run {cpu_s:.1f} s): loss card "
        f"{float(got[0][0]):.7f} CPU {float(ref[0][0]):.7f}, rel err "
        f"{loss_err:.3e}, against the CPU with the card's ReLU masks "
        f"{pin_loss:.3e} (tol {LOSS_RTOL:g}); global gradient norm card "
        f"{norms[0]:.6f} (full batch {norms[1]:.6f}), CPU "
        f"{float(ref[1 + 2 * k][0]):.6f}; clip_norm {clip_norm:.6f}, the "
        f"clip's scale CPU {scales[0]:.6f} card {scales[1]:.6f}")
    for g in TRAIN_GRADS:
        log(f"{tag} parity: {g}@GRAD norm-wise {grad_errs[g][0]:.3e}, "
            f"Moment1 {grad_errs[g][1]:.3e} (tol {TRAIN_GRADS[g]:g}); "
            f"ReLU masks pinned: {pin_errs[g][0]:.3e}, Moment1 "
            f"{pin_errs[g][1]:.3e} (tol {PINNED_GRADS[g]:g})")
    assert np.isfinite(got[0]).all() and loss_err <= LOSS_RTOL, loss_err
    assert pin_loss <= LOSS_RTOL, pin_loss
    for g, tol in TRAIN_GRADS.items():
        assert max(grad_errs[g]) <= tol, (g, grad_errs[g], tol)
    for g, tol in PINNED_GRADS.items():
        assert max(pin_errs[g]) <= tol, (g, pin_errs[g], tol)
    assert all(x < 1 for x in scales), f"the clip did not scale: {scales}"

    # the main path; the loss head (the tail after the last checkpoint)
    # is recomputed too, so xent_forward launches twice a step
    counts, res = _train_steps(tag, s, seq_len, batch, _want_counts(
        xent_forward=ops.count("softmax_with_cross_entropy"),
        xent_backward=1, layer_norm=ops.count("layer_norm")), card_name,
        card)
    # the same program without recompute, eager, from the same weights
    with unique_name.guard():
        plain, _, plain_cost = _recompute_program(recompute=False,
                                                  clip_norm=clip_norm)
    scope = fresh(pf.CUDAPlace(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain_losses, plain_times = [], []
    for _ in range(3):
        t0 = time.monotonic()
        plain_losses.append(float(gpu.run(plain, feed=s["feed"],
                                          fetch_list=[plain_cost],
                                          scope=scope)[0][0]))
        torch.cuda.synchronize()
        plain_times.append(time.monotonic() - t0)
    plain_peak = torch.cuda.max_memory_allocated()
    del scope
    same = max(abs(a - b) / abs(b)
               for a, b in zip(res["losses"], plain_losses))
    log(f"{tag}: eager peak allocated {res['peak_memory_bytes'] / 2 ** 30:.2f}"
        f" GiB with recompute against {plain_peak / 2 ** 30:.2f} GiB "
        f"without (the same program and weights; "
        f"{1 - res['peak_memory_bytes'] / plain_peak:.3f} less); eager step "
        f"{res['step_ms']:.1f} ms against {min(plain_times[1:]) * 1e3:.1f} "
        f"ms without; run_steps step {res['run_steps']['step_ms']:.1f} ms; "
        f"losses without recompute "
        + ", ".join(f"{x:.6f}" for x in plain_losses)
        + f", rel err against the recompute leg's {same:.3e} on {card_name} "
        f"({card})")
    assert res["peak_memory_bytes"] < plain_peak
    assert same <= LOSS_RTOL, same
    res.update(loss_rel_err=loss_err,
               grad_errs={g: e[0] for g, e in grad_errs.items()},
               moment1_errs={g: e[1] for g, e in grad_errs.items()},
               pinned_loss_rel_err=pin_loss,
               pinned_errs={g: e[0] for g, e in pin_errs.items()},
               global_norms=norms, clip_norm=clip_norm, clip_scales=scales,
               no_recompute_peak_memory_bytes=plain_peak,
               no_recompute_step_ms=min(plain_times[1:]) * 1e3,
               no_recompute_losses=plain_losses,
               dropout=_recomputed_dropout_masks(card_name))
    return counts, res


# ---------------------------------------------------------------------------
def _mnist_feed():
    """bench.py bench_mnist's synthetic separable batch (bench.py:375-377)
    on [784] images: noise of 0.1, and 2.0 added at the pixel the label
    names."""
    r = np.random.RandomState(0)
    lab = r.randint(0, 10, (MNIST_BATCH, 1)).astype(np.int64)
    img = r.randn(MNIST_BATCH, 784).astype(np.float32) * 0.1
    img[np.arange(MNIST_BATCH), lab[:, 0]] += 2.0
    return {"img": img, "label": lab}


def _mnist_program(opt=("SGD", {}), schedule=None):
    """The MNIST fc net (models/mnist.py build_program(use_conv=False))
    with `opt` (class name, kwargs) under the learning rate `schedule`
    (name, args) or MNIST_LR: (main, loss, accuracy, rate or None,
    seeded initial state)."""
    with unique_name.guard():
        main, startup, loss, acc = mnist.build_program(use_conv=False)
        with pf.program_guard(main, startup):
            lr = MNIST_LR
            if schedule is not None:
                lr = getattr(pf.layers, schedule[0])(*schedule[1])
            getattr(pf.optimizer, opt[0])(learning_rate=lr,
                                          **opt[1]).minimize(loss)
    startup.random_seed = SEED
    names = [n for n, v in startup.global_block.vars.items()
             if v.persistable]
    scope = pf.Scope()
    pf.Executor(pf.CPUPlace()).run(startup, scope=scope)
    return (main, loss, acc, None if schedule is None else lr,
            pf.scope_to_numpy(scope, names))


def _fresh(state, place):
    sc = pf.Scope()
    pf.load_numpy_params(sc, state, place)
    return sc


def _mnist_leg(opt, kw, sched, args):
    """`opt` under the schedule `sched`(*args), MNIST_LEG_STEPS eager
    steps on the card and on the CPU from the same seeded state: the
    losses within LOSS_RTOL, the rate fetched each step within LR_RTOL;
    the xent kernels launch once each a step."""
    main, loss, _, lr, state = _mnist_program((opt, kw), (sched, args))
    feed = _mnist_feed()
    runs = {}
    for where, place in (("cpu", pf.CPUPlace()), ("card", pf.CUDAPlace(0))):
        exe, scope = pf.Executor(place), _fresh(state, place)
        KX.xent_forward.launches = KX.xent_backward.launches = 0
        out = [exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
               for _ in range(MNIST_LEG_STEPS)]
        runs[where] = (
            np.array([float(o[0].reshape(-1)[0]) for o in out]),
            np.array([float(o[1].reshape(-1)[0]) for o in out]),
            (KX.xent_forward.launches, KX.xent_backward.launches))
    (gl, gr, launches), (wl, wr, _) = runs["card"], runs["cpu"]
    lerr = float(np.max(np.abs(gl - wl) / np.abs(wl)))
    rerr = float(np.max(np.abs(gr - wr) / np.abs(wr)))
    log(f"  {opt} under {sched}{tuple(args)}: losses "
        + ", ".join(f"{x:.6f}" for x in gl) + f"; rate "
        + ", ".join(f"{x:.6g}" for x in gr) + f"; rel err against the CPU "
        f"loss {lerr:.3e} (tol {LOSS_RTOL:g}), rate {rerr:.3e} (tol "
        f"{LR_RTOL:g}); xent launches {launches}")
    assert np.isfinite(gl).all() and lerr <= LOSS_RTOL, (opt, lerr)
    assert rerr <= LR_RTOL, (opt, rerr)
    assert len(set(gr.tolist())) > 1, (opt, "the rate never moved")
    assert launches == (MNIST_LEG_STEPS, MNIST_LEG_STEPS), launches
    return dict(optimizer=opt, schedule=sched, losses=gl.tolist(),
                rates=gr.tolist(), loss_rel_err=lerr, rate_rel_err=rerr)


def phase_train_mnist(card_name, card):
    """The MNIST fc net (784-128-64-10, BASELINE.md config 1) at batch
    MNIST_BATCH under SGD: step 1 on the card against the CPU (the loss
    within LOSS_RTOL, the grads by MNIST_GRADS), then MNIST_STEPS eager
    steps (the xent kernels launch once each a step; the loss falls) and
    one run_steps call of MNIST_STEPS steps (one capture) whose losses
    match the eager ones within STEPS_RTOL, then MNIST_TIMED_CALLS calls
    from the seeded weights that capture nothing and are timed; then one
    5-step
    leg of each other optimizer under a schedule (MNIST_LEGS). Returns
    (launches by kernel on the eager leg, results)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    main, loss, acc, _, state = _mnist_program()
    feed = _mnist_feed()
    grads = [g + "@GRAD" for g in MNIST_GRADS]
    ref = pf.Executor(pf.CPUPlace()).run(
        main, feed=feed, fetch_list=[loss] + grads,
        scope=_fresh(state, pf.CPUPlace()))
    gpu = pf.Executor(pf.CUDAPlace(0))
    got = gpu.run(main, feed=feed, fetch_list=[loss] + grads,
                  scope=_fresh(state, pf.CUDAPlace(0)))
    lerr = abs(float(got[0][0]) - float(ref[0][0])) / abs(float(ref[0][0]))
    gerrs = {g: _rel(got[1 + i], ref[1 + i]) for i, g in
             enumerate(MNIST_GRADS)}
    log(f"train mnist: step 1 at batch {MNIST_BATCH}, card against the "
        f"CPU: loss {float(got[0][0]):.7f} rel err {lerr:.3e} (tol "
        f"{LOSS_RTOL:g}); grads norm-wise "
        + ", ".join(f"{g} {e:.3e} (tol {MNIST_GRADS[g]:g})"
                    for g, e in gerrs.items()))
    assert lerr <= LOSS_RTOL, lerr
    assert all(e <= MNIST_GRADS[g] for g, e in gerrs.items()), gerrs
    # the main path: eager steps, the counters set to 0 just before
    scope = _fresh(state, pf.CUDAPlace(0))
    torch.cuda.synchronize()
    KX.xent_forward.launches = KX.xent_backward.launches = 0
    eager = [gpu.run(main, feed=feed, fetch_list=[loss, acc], scope=scope)
             for _ in range(MNIST_STEPS)]
    torch.cuda.synchronize()
    launches = {"xent_forward": KX.xent_forward.launches,
                "xent_backward": KX.xent_backward.launches}
    losses = np.array([float(o[0][0]) for o in eager])
    accs = [float(o[1][0]) for o in eager]
    log(f"train mnist eager: losses " + ", ".join(f"{x:.6f}" for x in losses)
        + f"; accuracy {accs[0]:.4f} -> {accs[-1]:.4f}; launches "
        f"{launches} over {MNIST_STEPS} steps")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert launches == dict.fromkeys(launches, MNIST_STEPS), launches
    # run_steps: one capture, then a call that replays only, timed
    scope = _fresh(state, pf.CUDAPlace(0))
    compiles = gpu.compile_count

    def call():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = gpu.run_steps(main, feed=feed, fetch_list=[loss],
                            steps=MNIST_STEPS, scope=scope)[0].reshape(-1)
        torch.cuda.synchronize()
        assert gpu.last_run_steps_fallback is None, \
            gpu.last_run_steps_fallback
        assert gpu.compile_count == compiles + 1, gpu.compile_count
        return out, time.monotonic() - t0

    first, capture_s = call()
    runs, walls = [first], []
    for _ in range(MNIST_TIMED_CALLS):
        pf.load_numpy_params(scope, state, pf.CUDAPlace(0))
        out, wall_s = call()
        runs.append(out)
        walls.append(wall_s * 1e3)
    errs = [float(np.max(np.abs(r - losses) / np.abs(losses)))
            for r in runs]
    call_ms = float(np.median(walls))
    step_ms = call_ms / MNIST_STEPS
    log(f"train mnist run_steps: capturing call {capture_s:.3f} s; rel err "
        f"against the eager losses, worst of the capturing call and "
        f"{MNIST_TIMED_CALLS} replaying calls from the seeded weights "
        f"(capturing nothing) {max(errs):.3e} (tol {STEPS_RTOL:g}); the "
        f"replaying calls took "
        + ", ".join(f"{w:.3f}" for w in walls)
        + f" ms (host clock), median {call_ms:.3f} ms: {step_ms:.4f} ms a "
        f"step, {MNIST_BATCH / (step_ms / 1e3):.0f} examples/s, spread "
        f"{min(walls) / MNIST_STEPS:.4f}-{max(walls) / MNIST_STEPS:.4f} ms "
        f"a step on {card_name} ({card})")
    assert max(errs) <= STEPS_RTOL, errs
    assert all(r[-1] < r[0] for r in runs), runs
    (_, _), prof = _device_profile(
        "train mnist run_steps profile",
        lambda: (pf.load_numpy_params(scope, state, pf.CUDAPlace(0)),
                 call()))
    legs = [_mnist_leg(*leg) for leg in MNIST_LEGS]
    assert {leg[2] for leg in MNIST_LEGS} == {
        "exponential_decay", "natural_exp_decay", "inverse_time_decay",
        "polynomial_decay", "piecewise_decay", "cosine_decay",
        "linear_lr_warmup"}
    return launches, dict(
        batch=MNIST_BATCH, steps=MNIST_STEPS, loss_rel_err=lerr,
        grad_rel_errs=gerrs, losses=losses.tolist(), accuracy=accs,
        run_steps_rel_errs=errs, capture_call_s=capture_s,
        call_ms=call_ms, calls_ms=walls, step_ms=step_ms,
        examples_per_s=MNIST_BATCH / (step_ms / 1e3), profile=prof,
        legs=legs, card=card)

# ---------------------------------------------------------------------------
PREDICT_KERNELS = (KL.layer_norm, KA.sdpa_short, KA.flash_attention)
PREDICT_FEEDS = ("src_ids", "tgt_ids")


def _zero_predict_launches():
    for k in PREDICT_KERNELS:
        k.launches = k.launches_bf16 = 0


def _predict_launches():
    return {k.__name__: (k.launches, k.launches_bf16)
            for k in PREDICT_KERNELS}


def _predictor(d, gpu=True, ir=True, bf16=False):
    cfg = inference.AnalysisConfig(d)
    if not gpu:
        cfg.disable_gpu()
    cfg.switch_ir_optim(ir)
    if bf16:
        cfg.enable_tpu_bf16()
    return inference.create_paddle_predictor(cfg)


def _pred_run(pred, feed):
    return pred.run([inference.PaddleTensor(v, name=n)
                     for n, v in feed.items()])[0].data


def _predict_split(pred, feed, reps=3):
    """Where a predictor.run's wall time goes, best of `reps` each: the
    run up to its outputs on the card (synchronized), and their one
    copy to the host (`predictor._to_host`), in ms."""
    from paddle_tpu_torch.inference import predictor as pred_mod

    run_ms, copy_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = pred._prepared.lookup(dict(feed)).run(dict(feed),
                                                     return_numpy=False)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        pred_mod._to_host(outs)
        t2 = time.monotonic()
        run_ms.append((t1 - t0) * 1e3)
        copy_ms.append((t2 - t1) * 1e3)
    return min(run_ms), min(copy_ms)


def _readback_ms(nbytes, reps=3):
    """What the predictor's logits copy is made of, best of `reps` each:
    `nbytes` on the card copied to a fresh pageable host buffer (as
    `_to_host` does), into a reused pinned buffer, and the host alone
    touching a fresh numpy array of that size (its page faults)."""
    src = torch.ones(nbytes // 4, device="cuda").view(torch.uint8)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def best(fn):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
        return min(ms)

    return dict(fresh_pageable_ms=best(lambda: src.cpu()),
                reused_pinned_ms=best(lambda: pinned.copy_(src)),
                host_touch_ms=best(
                    lambda: np.empty(nbytes, np.uint8).fill(1)))


def _top2_margin(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _argmax_off(got, want, margin):
    """(positions whose argmax differs, those where `want`'s top-2
    margin exceeds `margin`: not ties)."""
    off = got.argmax(-1) != want.argmax(-1)
    return int(off.sum()), int((off & (_top2_margin(want) > margin)).sum())


def _export(tmp, seq_len):
    """Transformer-base at `seq_len`, cloned for test, its seeded startup
    run on the card, saved by save_inference_model into tmp/t<seq_len>:
    (dir, the logits' name, the saved program's op count)."""
    t0 = time.monotonic()
    with unique_name.guard():
        main, startup, _ = transformer.build_program(
            seq_len=seq_len, with_optimizer=False,
            dropout_rate=DROPOUT_RATE,
            **{k: MODEL[k] for k in ("d_model", "n_heads", "n_layers",
                                     "d_inner", "vocab")})
    test = main.clone(for_test=True)
    lname = next(op.outputs["Out"][0] for op in test.global_block.ops
                 if op.type == "mul" and op.inputs["Y"] == ["logits.w"])
    startup.random_seed = SEED
    exe = pf.Executor(pf.CUDAPlace(0))
    scope = pf.Scope()
    exe.run(startup, scope=scope)
    d = os.path.join(tmp, f"t{seq_len}")
    with pf.scope_guard(scope):
        pf.save_inference_model(d, list(PREDICT_FEEDS),
                                [test.global_block.var(lname)], exe,
                                main_program=test)
    n_ops = len(test._prune([lname]).global_block.ops)
    mb = sum(os.path.getsize(os.path.join(d, f))
             for f in os.listdir(d)) / 2 ** 20
    log(f"predict T={seq_len}: built, ran the startup and saved in "
        f"{time.monotonic() - t0:.1f} s ({n_ops} ops, {mb:.0f} MiB)")
    return d, lname, n_ops


def _predict_fp32(tag, d, pred, raw, feed, attn):
    """One fp32 leg: the launches, the CPU parity (and its TF32 control),
    ir_optim off, zero copy, clone and Executor.close."""
    layers = MODEL["n_layers"]
    _pred_run(pred, feed)  # set-up: the first use of cuBLAS and the pool
    _zero_predict_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = _pred_run(pred, feed)
    wall = time.monotonic() - t0
    counts = _predict_launches()
    want = {k.__name__: (0, 0) for k in PREDICT_KERNELS}
    want["layer_norm"] = (5 * layers, 0)
    want[attn] = (3 * layers, 0)
    assert counts == want, (counts, want)
    run_ms, copy_ms = _predict_split(pred, feed)
    _, prof = _device_profile(tag, lambda: _pred_run(pred, feed))
    log(f"{tag}: the run on the card {run_ms:.1f} ms, the logits' copy to "
        f"the host {copy_ms:.1f} ms (best of 3 each)")
    small = {k: v[:PREDICT_CPU_ROWS] for k, v in feed.items()}
    t0 = time.monotonic()
    ref = _pred_run(_predictor(d, gpu=False), small)
    cpu_s = time.monotonic() - t0
    bound = PREDICT_TOL * float(np.abs(ref).max())
    err = float(np.abs(out[:PREDICT_CPU_ROWS] - ref).max())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _pred_run(pred, small)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    terr = float(np.abs(tf32 - ref).max())
    off, not_ties = _argmax_off(out[:PREDICT_CPU_ROWS], ref, bound)
    log(f"{tag}: logits {tuple(out.shape)} {out.dtype} in {wall * 1e3:.1f} "
        f"ms; launches {counts}; {PREDICT_CPU_ROWS} rows against the CPU "
        f"predictor ({cpu_s:.1f} s): max_abs_err {err:.3e}, bound "
        f"{bound:.3e} ({PREDICT_TOL:g} of the largest |CPU logit|), TF32 on "
        f"{terr:.3e}; argmax other at {off} positions, {not_ties} of them "
        f"above a top-2 margin of the bound")
    assert np.isfinite(out).all() and err <= bound, (err, bound)
    assert terr > bound, "the logits check cannot see TF32"
    assert not_ties == 0, "an argmax differs where it is no tie"
    noir = _pred_run(raw, feed)
    nerr = float(np.abs(noir - out).max())
    nbound = PREDICT_TOL * float(np.abs(out).max())
    log(f"{tag}: switch_ir_optim(False) max_abs_err {nerr:.3e} (bound "
        f"{nbound:.3e})")
    assert nerr <= nbound, (nerr, nbound)
    del noir
    for n, v in feed.items():
        pred.get_input_tensor(n).copy_from_cpu(v)
    pred.zero_copy_run()
    zc = pred.get_output_tensor(pred.get_output_names()[0]).copy_to_cpu()
    assert np.array_equal(zc, out), "zero_copy_run: bits differ"
    del zc
    twin = pred.clone()
    params = [v.name for v in pred.program().list_vars() if v.persistable]
    assert all(twin._scope._get(n) is pred._scope._get(n)
               and pred._scope._get(n).is_cuda for n in params), \
        "the clone's params are not the predictor's tensors on the card"
    assert np.array_equal(_pred_run(twin, feed), out), "clone: bits differ"
    before = pred._prepared.prepare_count
    pred._exe.close()
    again = _pred_run(pred, feed)
    assert pred._prepared.prepare_count == before + 1, \
        "Executor.close() left the prepared program in place"
    assert np.array_equal(again, out), "after close: bits differ"
    log(f"{tag}: zero_copy_run, clone() and the run after "
        f"Executor.close() (prepared again) give the same bits")
    return out, counts, dict(ms=wall * 1e3, run_ms=run_ms, copy_ms=copy_ms,
                             max_abs_err=err, bound=bound, tf32_err=terr,
                             argmax_off=off, noir_err=nerr, cpu_s=cpu_s,
                             profile=prof)


def _predict_bf16(tag, d, feed, fp32_out, attn):
    """One bf16 leg against the fp32 card logits of the same feed."""
    layers = MODEL["n_layers"]
    pred = _predictor(d, bf16=True)
    floats = [t for t in (pred._scope._get(n)
                          for n in pred._scope.local_var_names())
              if t is not None and t.is_floating_point()]
    assert floats and all(t.dtype == torch.bfloat16 for t in floats), \
        "a float tensor of the bf16 predictor's scope is not bf16"
    _pred_run(pred, feed)
    _zero_predict_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = _pred_run(pred, feed)
    wall = time.monotonic() - t0
    counts = _predict_launches()
    want = {k.__name__: (0, 0) for k in PREDICT_KERNELS}
    want["layer_norm"] = (5 * layers, 5 * layers)
    want[attn] = (3 * layers, 3 * layers)
    assert counts == want, (counts, want)
    run_ms, copy_ms = _predict_split(pred, feed)
    _, prof = _device_profile(tag, lambda: _pred_run(pred, feed))
    log(f"{tag}: the run on the card {run_ms:.1f} ms, the logits' copy to "
        f"the host {copy_ms:.1f} ms (best of 3 each)")
    bound = PREDICT_BF16 * float(np.abs(fp32_out).max())
    err = float(np.abs(out - fp32_out).max())
    off, not_ties = _argmax_off(out, fp32_out, bound)
    log(f"{tag}: {len(floats)} scope tensors, all bf16; logits {out.dtype} "
        f"in {wall * 1e3:.1f} ms; launches {counts}; against the fp32 card "
        f"logits max_abs_err {err:.3e}, bound {bound:.3e} ({PREDICT_BF16:g} "
        f"of the largest |fp32 logit|); argmax other at {off} of "
        f"{out[..., 0].size} positions, {not_ties} where the fp32 top-2 "
        f"margin exceeds the bound")
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert err <= bound, (err, bound)
    assert not_ties == 0, "a bf16 argmax differs beyond the bound"
    return counts, dict(ms=wall * 1e3, run_ms=run_ms, copy_ms=copy_ms,
                        max_abs_err=err, bound=bound, argmax_off=off,
                        profile=prof)


def _predict_served(pred, card_name, card, seq_len):
    """InferenceServer over the predictor: PREDICT_REQUESTS threaded
    batch-1 submits, against predictor.run on the same rows."""
    rs = np.random.RandomState(SEED + 11)
    rows = {n: rs.randint(2, MODEL["vocab"], (PREDICT_REQUESTS, seq_len))
            .astype("int64") for n in PREDICT_FEEDS}
    want = np.concatenate([
        _pred_run(pred, {k: v[i:i + BATCH] for k, v in rows.items()})
        for i in range(0, PREDICT_REQUESTS, BATCH)])
    got = [None] * PREDICT_REQUESTS
    _zero_predict_launches()
    srv = inference.InferenceServer(pred, max_batch_size=BATCH,
                                    max_wait_ms=2.0)

    def one(i):
        got[i] = srv.infer({k: v[i:i + 1] for k, v in rows.items()},
                           timeout=600)[0]

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(PREDICT_REQUESTS)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive(), "infer() did not return"
        wall = time.monotonic() - t0
        st = srv.stats()
    finally:
        srv.close()
    assert srv._thread is None and not srv._running, "unclean close"
    counts = _predict_launches()
    bound = PREDICT_TOL * float(np.abs(want).max())
    err = max(float(np.abs(g[0] - w).max()) for g, w in zip(got, want))
    assert st["requests"] == st["completed"] == PREDICT_REQUESTS, st
    assert st["batches"] < st["requests"], st
    assert err <= bound, (err, bound)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i in range(PREDICT_REQUESTS):
        _pred_run(pred, {k: v[i:i + 1] for k, v in rows.items()})
    naive = time.monotonic() - t0
    one_run_ms, one_copy_ms = _predict_split(
        pred, {k: v[:1] for k, v in rows.items()})
    log(f"predict served T={seq_len}: a batch-1 run on the card "
        f"{one_run_ms:.1f} ms, its logits' copy {one_copy_ms:.1f} ms")
    rps, naive_rps = PREDICT_REQUESTS / wall, PREDICT_REQUESTS / naive
    log(f"predict served T={seq_len}: {PREDICT_REQUESTS} requests in "
        f"{st['batches']} batches (rows {st['rows']}, padded "
        f"{st['padded_rows']}), replies within {err:.3e} of predictor.run "
        f"(bound {bound:.3e}); {rps:.2f} requests/s, p50 latency "
        f"{st['latency_ms']['p50']:.1f} ms; the naive per-request "
        f"predictor.run loop {naive_rps:.2f} requests/s; launches {counts} "
        f"on {card_name} ({card})")
    return counts, dict(requests_per_s=rps, p50_ms=st["latency_ms"]["p50"],
                        naive_requests_per_s=naive_rps,
                        batches=st["batches"], max_abs_err=err,
                        batch1_run_ms=one_run_ms,
                        batch1_copy_ms=one_copy_ms)


def phase_predict(card_name, card):
    """Phase 11: export, load and serve Transformer-base through the
    predictor (module docstring)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    launches = {k.__name__: [0, 0] for k in PREDICT_KERNELS}
    res = {}

    def add(counts):
        for n, (c, c16) in counts.items():
            launches[n][0] += c
            launches[n][1] += c16

    try:
        for seq_len, batch in PREDICT_RUNS:
            attn = "sdpa_short" if seq_len <= 512 else "flash_attention"
            d, lname, n_saved = _export(tmp, seq_len)
            raw = _predictor(d, ir=False)
            pred = _predictor(d)
            ops_raw = [o.type for o in raw.program().global_block.ops]
            ops = [o.type for o in pred.program().global_block.ops]
            n_ffn = 2 * MODEL["n_layers"]  # encoder and decoder FFNs
            log(f"predict T={seq_len}: {len(ops_raw)} ops loaded "
                f"({ops_raw.count('dropout')} dropout, "
                f"{ops_raw.count('mul')} mul), {len(ops)} after the passes "
                f"({ops.count('fc')} fc, {ops.count('mul')} mul); fingerprint "
                f"{pred.fingerprint()[:16]}")
            assert len(ops_raw) == n_saved and "dropout" not in ops
            assert ops.count("fc") == 2 * n_ffn and \
                ops.count("mul") == ops_raw.count("mul") - 2 * n_ffn
            rs = np.random.RandomState(SEED + seq_len)
            feed = {n: rs.randint(2, MODEL["vocab"], (batch, seq_len))
                    .astype("int64") for n in PREDICT_FEEDS}
            tag = f"predict fp32 T={seq_len} B={batch}"
            out, counts, r32 = _predict_fp32(tag, d, pred, raw, feed, attn)
            add(counts)
            del raw
            tag = f"predict bf16 T={seq_len} B={batch}"
            counts, r16 = _predict_bf16(tag, d, feed, out, attn)
            add(counts)
            res[seq_len] = dict(ops_loaded=len(ops_raw),
                                ops_after_passes=len(ops), fp32=r32,
                                bf16=r16)
            nbytes = out.nbytes
            del out
            if seq_len == PREDICT_RUNS[0][0]:
                res["readback"] = _readback_ms(nbytes)
                log(f"predict readback of {nbytes / 2 ** 20:.0f} MiB: "
                    + ", ".join(f"{k} {v:.1f}" for k, v in
                                res["readback"].items()))
                counts, res["served"] = _predict_served(pred, card_name,
                                                        card, seq_len)
                add(counts)
            del pred
            shutil.rmtree(d)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for n, (c, c16) in launches.items():
        assert c > 0 and c16 > 0, f"{n} never launched in phase 11"
    return launches, res


# ---------------------------------------------------------------------------
# phase 15: the front door (streamed replies, admit_select, sequence
# buckets with AOT warm-up) and its observability
# ---------------------------------------------------------------------------
FRONT_KERNELS = RADIX_KERNELS
# the streamed legs run on phase 12's weights (its session rows end on
# end_id, so a wave is short), their servers' bursts steps_per_tick long
# also when the queue is empty (drain_steps): the paged wave streams 7 rows twice (the
# repeats admit through the prefix cache or the radix tier) and a chat
# session's two turns on the 8th; the dense wave streams the 8 rows and
# sends the first FRONT_CB of them again with a stream_cb
FRONT_SESSION_ROW = RADIX_SESSION_ROWS[-1]
FRONT_PLAIN_ROWS = RADIX_SESSION_ROWS[:-1] * 2
FRONT_CB = 4
# the teardowns run on phase 9's weights (no end_id: 255 tokens, ~32
# bursts); the deadline expires a few bursts in
FRONT_DEADLINE_MS = 1000.0
# the admit_select and observability legs: a dense bundle of 8 lanes at
# MODEL's 32 tokens out, prompts of 256 on phase 9's weights
FRONT_LANES = 8
FRONT_OBS_ROUNDS = 5
FRONT_LEVELS = ("off", "metrics", "trace")
# the buckets leg: a Transformer-base encoder forward fed [-1, -1]
# source ids and positions
FRONT_SEQ_BUCKETS = (512, 1024)
FRONT_BATCH_BUCKETS = (1, 2, 4)
FRONT_REQUESTS = 32
FRONT_LENGTHS = (300, 1024)
FRONT_TOL = 1e-5     # phase 11's gate, relative to the largest |CPU value|
# the speculative leg: the n-gram proposer (bench.py's) over 4 lanes
FRONT_SPEC_LANES = 4


def _front_programs():
    """Phase 15's own programs: the dense bundle of the admit_select and
    observability legs (FRONT_LANES lanes, prompts of 256, MODEL's 32
    tokens out), the n-gram speculative bundle (paged, FRONT_SPEC_LANES
    lanes, 32 tokens out) and the buckets leg's encoder forward (main,
    startup, output)."""
    cfg = dict(MODEL, seq_len=PAGED["seq_len"])
    with unique_name.guard():
        dense = decode_engine.build_decode_step_program(
            n_slots=FRONT_LANES, state_prefix="@fd/", **cfg)
    pages = cfg["max_out_len"] // PAGED["block_size"]
    cache = decode_engine.CacheConfig(
        layout="paged", block_size=PAGED["block_size"],
        n_blocks=2 * FRONT_SPEC_LANES * pages,
        n_prompt_entries=FRONT_SPEC_LANES)
    with unique_name.guard():
        ngram = decode_engine.build_decode_step_program(
            n_slots=FRONT_SPEC_LANES, state_prefix="@fn/", cache=cache,
            draft=decode_engine.DraftConfig(**SPEC_NGRAM), **cfg)
    main, startup = pf.Program(), pf.Program()
    d = MODEL["d_model"]
    with unique_name.guard(), pf.program_guard(main, startup):
        src = pf.layers.data("src_ids", shape=[-1], dtype="int64")
        pos = pf.layers.data("src_pos", shape=[-1], dtype="int64")
        x = pf.layers.elementwise_add(
            pf.layers.scale(pf.layers.embedding(
                src, size=[MODEL["vocab"], d],
                param_attr=pf.ParamAttr(name="src_word_emb")),
                scale=d ** 0.5),
            pf.layers.embedding(
                pos, size=[FRONT_SEQ_BUCKETS[-1], d],
                param_attr=pf.ParamAttr(name="src_pos_enc")))
        for li in range(MODEL["n_layers"]):
            x = transformer.encoder_layer(
                x, d, MODEL["n_heads"], MODEL["d_inner"], 0.0, True,
                name=f"enc{li}")
    return dense, ngram, (main, startup, x)


def _gen_len(row):
    return int(serving.count_generated_tokens(np.asarray(row)[None],
                                              MODEL["end_id"])[0])


def _stream_ok(tag, reply, seqs, toks, row):
    """One streamed reply's byte parity: its tokens are the generated
    region row[1:1+n] of its whole-response row, its sequence numbers run
    from 0 and its finish reason agrees with the row."""
    row = np.asarray(row)
    n = _gen_len(row)
    assert seqs == list(range(len(seqs))), (tag, seqs[:8])
    assert toks == [int(t) for t in row[1:1 + n]], (tag, toks[:8], row[:9])
    fin = "eos" if n < row.shape[0] and row[n] == MODEL["end_id"] \
        else "length"
    assert reply.finish_reason == fin, (tag, reply.finish_reason, fin)


def _ms_list(xs, digits=1):
    return " / ".join(f"{x:.{digits}f}" for x in xs)


def _drain_stream(reply):
    seqs, toks = [], []
    for seq, tok in reply:
        seqs.append(seq)
        toks.append(tok)
    return seqs, toks


class _CbStream:
    """A stream_cb: keeps every call (chunk, first_seq, finish reason)
    and the instant of the first."""

    def __init__(self):
        self.calls = []
        self.t_first = None

    def __call__(self, chunk, first_seq, fin):
        if self.t_first is None and len(chunk):
            self.t_first = time.monotonic()
        self.calls.append((np.asarray(chunk).copy(), int(first_seq), fin))

    def check(self, tag, row):
        """The callback form's contract: data chunks tile the sequence
        numbers from 0, the last call is empty and carries the finish
        reason, and together they are the row's generated region."""
        *chunks, (tail, tail_seq, fin) = self.calls
        toks, seq = [], 0
        for chunk, first_seq, cfin in chunks:
            assert cfin is None and first_seq == seq, (tag, first_seq, seq)
            seq += len(chunk)
            toks += [int(t) for t in chunk]
        row = np.asarray(row)
        n = _gen_len(row)
        assert tail.size == 0 and tail_seq == n, (tag, tail_seq, n)
        assert toks == [int(t) for t in row[1:1 + n]], tag
        assert fin == ("eos" if n < row.shape[0]
                       and row[n] == MODEL["end_id"] else "length"), fin


def _front_submit(srv, prompt, mode, kw):
    """A submit as `mode` says: "stream" (a StreamingReply), "cb" (a
    stream_cb) or "plain". Returns (the future, the stream or None)."""
    if mode == "stream":
        rep = srv.submit(prompt, stream=True, **kw)
        return rep._future, rep
    if mode == "cb":
        cb = _CbStream()
        return srv.submit(prompt, stream_cb=cb, **kw), cb
    return srv.submit(prompt, **kw), None


def _front_streamed(tag, make, subs, turn2=None):
    """One streamed leg: `subs` ((prompt, mode, submit keywords)) queued
    on a fresh server built with start=False, which then starts; then
    `turn2` ((prompt, keywords), a session's next turn, streamed when the
    wave is). Four waves, each on a fresh server: whole-response,
    streamed, streamed, whole-response (a wave's first run pays for the
    process's first use of its shapes, so the order is balanced). Each
    stream is held to its own row, each row to the first wave's, and no
    wave may build a PreparedProgram. Returns the leg's numbers: each
    streamed wave's first tokens and each whole-response wave's replies,
    in ms from the wave's start."""
    rows, res = [], dict(stream_ttft_ms=[], whole_latency_ms=[],
                         stream_wall_s=[], plain_wall_s=[])
    for streamed in (False, True, True, False):
        srv = make()
        # the cost model counts a serve program at its first lookup: count
        # them all now, not inside the wave's dispatches
        for prog in srv.bundle.serves.values():
            pf.observability.costmodel.lookup(prog)
        n_prep = srv.executor.prepare_count
        done = [None] * len(subs)
        futs, streams = [], []
        for i, (p, mode, kw) in enumerate(subs):
            fut, st = _front_submit(srv, p, mode if streamed else "plain",
                                    kw)
            fut.add_done_callback(
                lambda f, i=i: done.__setitem__(i, time.monotonic()))
            futs.append(fut)
            streams.append(st)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        srv.start()
        got = [np.asarray(f.result(timeout=600)) for f in futs]
        wall = time.monotonic() - t0
        if turn2 is not None:
            fut, st = _front_submit(srv, turn2[0],
                                    "stream" if streamed else "plain",
                                    turn2[1])
            got.append(np.asarray(fut.result(timeout=600)))
            streams.append(st)
        assert srv.executor.prepare_count == n_prep, \
            f"{tag}: a wave built a PreparedProgram"
        tokens = srv.stats()["tokens"]
        srv.close()
        rows.append(got)
        if streamed:
            for i, (s, row) in enumerate(zip(streams, got)):
                if isinstance(s, _CbStream):
                    s.check(f"{tag} cb {i}", row)
                else:
                    _stream_ok(f"{tag} {i}", s, *_drain_stream(s), row)
            res["stream_ttft_ms"].append(float(np.median(
                [(s.t_first - t0) * 1e3 for s in streams[:len(subs)]])))
            res["stream_wall_s"].append(wall)
        else:
            res["whole_latency_ms"].append(float(np.median(
                [(t - t0) * 1e3 for t in done])))
            res["plain_wall_s"].append(wall)
        res["tokens"] = tokens
    for w, got in enumerate(rows[1:], 1):
        for i, (a, b) in enumerate(zip(got, rows[0])):
            assert (a == b).all(), f"{tag}: wave {w} moved row {i}"
    res["submits"] = len(rows[0])
    res["generated"] = [_gen_len(r) for r in rows[0]]
    return res


def _front_teardown(paged, gpu, gscope, prompts):
    """A live stream cancelled after its first burst and a live one past
    its deadline, on a paged server over phase 9's weights: each ends
    with its typed error and its finish reason, the pool comes back to
    where it started, and both are flight-recorder incidents."""
    srv = serving.PagedContinuousGenerationServer(
        paged, executor=gpu, scope=gscope,
        steps_per_tick=PAGED["steps_per_tick"],
        drain_steps=PAGED["steps_per_tick"], radix_reuse=False)
    try:
        ps0 = srv.pool_stats()
        a = srv.submit(prompts[0], stream=True)
        first = next(a)  # the first burst landed: the lane is live
        assert first[0] == 0 and a.cancel()
        seqs, toks = _drain_stream(a)
        try:
            a.result(timeout=60)
            raise AssertionError("a cancelled stream returned a row")
        except serving.RequestCancelled:
            pass
        assert a.finish_reason == "cancelled", a.finish_reason
        n_a = 1 + len(toks)
        b = srv.submit(prompts[1], stream=True,
                       deadline_ms=FRONT_DEADLINE_MS)
        seqs, toks = _drain_stream(b)
        try:
            b.result(timeout=60)
            raise AssertionError("an expired stream returned a row")
        except serving.DeadlineExceeded:
            pass
        assert b.finish_reason == "deadline", b.finish_reason
        assert 0 < len(toks) < PAGED["max_out_len"] - 1, len(toks)
        assert srv.drain(timeout=60)
        ps = srv.pool_stats()
        for k in ("blocks_in_use", "prompt_entries_in_use"):
            assert ps[k] == ps0[k], (k, ps[k], ps0[k])
        st = srv.stats()
        assert st["cancelled"] == 1 and st["deadline_expired"] == 1, st
        inc = [e for e in pf.observability.incident_report()["incidents"]
               if e.get("server") == srv._obs_id]
        reasons = sorted(e.get("reason") for e in inc)
        assert reasons == ["cancelled", "deadline"], reasons
    finally:
        srv.close()
    log(f"front door, teardown: a stream cancelled after {n_a} tokens and "
        f"one expired after {len(toks)} ({FRONT_DEADLINE_MS:.0f} ms), both "
        f"typed, both incidents; blocks in use {ps['blocks_in_use']} and "
        f"prompt entries {ps['prompt_entries_in_use']} as at the start")
    return dict(cancelled_after=n_a, expired_after=len(toks),
                incidents=len(inc))


def _front_admit_select(dense, gpu, gscope, cands):
    """admit_select: 8 prompts of different lengths (end_id past the
    length) queued on a dense server with a longest-first hook. The slots
    they took (their traces' queue spans) must follow the hook's order,
    and their rows equal a FIFO server's."""
    lengths = [PAGED["seq_len"] * (8 - i) // 8
               for i in (3, 0, 6, 1, 5, 2, 7, 4)]
    prompts = cands[:FRONT_LANES].copy()
    for p, n in zip(prompts, lengths):
        p[n:] = MODEL["end_id"]

    def longest(queue):
        return max(range(len(queue)), key=lambda i: int(
            (queue[i].src != MODEL["end_id"]).sum()))

    rows = {}
    for hook in (longest, None):
        srv = serving.ContinuousGenerationServer(
            dense, executor=gpu, scope=gscope, admit_select=hook,
            steps_per_tick=PAGED["steps_per_tick"], start=False)
        reps = [srv.submit(p) for p in prompts]
        srv.start()
        rows[hook is None] = np.stack([r.result(timeout=600) for r in reps])
        if hook is not None:
            slot = [next(s.attrs["slot"] for s in r._gen_req.trace.spans
                         if s.name == "slotpool.queue") for r in reps]
            order = [lengths[i] for i in np.argsort(slot)]
            assert order == sorted(lengths, reverse=True), order
        srv.close()
    assert (rows[True] == rows[False]).all(), \
        "admit_select moved a token"
    log(f"front door, admit_select: 8 prompts of {sorted(lengths)} tokens "
        f"admitted longest first (slots 0-7 in the hook's order); rows "
        f"equal the FIFO server's")
    return dict(lengths=lengths)


def _front_observability(dense, gpu, gscope, cands, card_name, card):
    """The same dense wave (8 prompts, 32 tokens out, bursts of
    steps_per_tick ticks) at each observability level, interleaved,
    FRONT_OBS_ROUNDS times each, every wave under torch.profiler (device
    activities only): the median wall and idle share a level; the rows
    may not move. The cost model
    calibrates on the metrics and trace waves: expected_service_ms is
    set after the first, and the trace waves' bursts carry expected
    against actual tick times."""
    srv = serving.ContinuousGenerationServer(
        dense, executor=gpu, scope=gscope,
        steps_per_tick=PAGED["steps_per_tick"],
        drain_steps=PAGED["steps_per_tick"])
    pf.set_flags({"FLAGS_observability": "metrics"})
    for prog in dense.serves.values():
        pf.observability.costmodel.lookup(prog)
    prompts = cands[FRONT_LANES:2 * FRONT_LANES]
    walls = {lv: [] for lv in FRONT_LEVELS}
    idle = {lv: [] for lv in FRONT_LEVELS}
    ref = None
    expected = None
    for rnd in range(FRONT_OBS_ROUNDS):
        for lv in FRONT_LEVELS:
            pf.set_flags({"FLAGS_observability": lv})

            def wave():
                reps = [srv.submit(p) for p in prompts]
                return np.stack([r.result(timeout=600) for r in reps])

            rows, prof = _device_profile(
                f"front door, {lv} wave {rnd + 1}", wave, host=False)
            walls[lv].append(prof["profiled_wall_ms"])
            idle[lv].append(prof["idle_share"])
            if ref is None:
                ref = rows
            assert (rows == ref).all(), f"{lv}: the wave's rows moved"
            if lv == "metrics" and expected is None:
                expected = srv.expected_service_ms()
                assert expected is not None, \
                    "expected_service_ms() is None after a metrics wave"
    pf.set_flags({"FLAGS_observability": "off"})
    res = {lv: dict(wall_ms=float(np.median(walls[lv])),
                    walls_ms=walls[lv],
                    idle_share=float(np.median(idle[lv]))
                    if None not in idle[lv] else None)
           for lv in FRONT_LEVELS}
    bursts = []
    for tr in pf.observability.TRACER.completed:
        if tr.attrs.get("server") != srv._obs_id:
            continue
        for s in tr.spans:
            if s.name == "slotpool.dispatch" \
                    and "tick_time_ratio" in s.attrs:
                bursts.append((s.attrs["expected_tick_ms"],
                               s.attrs["actual_tick_ms"],
                               s.attrs["tick_time_ratio"]))
    bursts = sorted(set(bursts))
    assert bursts, "no calibrated burst in the trace waves"
    ratios = [b[2] for b in bursts]
    res.update(expected_service_ms=srv.expected_service_ms(),
               expected_service_ms_first=expected,
               calibrated_bursts=len(bursts),
               expected_tick_ms=[b[0] for b in bursts],
               actual_tick_ms=[b[1] for b in bursts],
               tick_time_ratio=dict(min=min(ratios),
                                    p50=float(np.median(ratios)),
                                    max=max(ratios)))
    for lv in FRONT_LEVELS:
        log(f"front door, observability {lv}: wave wall median "
            f"{res[lv]['wall_ms']:.1f} ms ({', '.join(f'{w:.1f}' for w in walls[lv])}), "
            f"idle share median {res[lv]['idle_share']} on {card_name} "
            f"({card})")
    log(f"front door, cost model: {len(bursts)} calibrated bursts, "
        f"expected tick {min(res['expected_tick_ms']):.3f}-"
        f"{max(res['expected_tick_ms']):.3f} ms against actual "
        f"{min(res['actual_tick_ms']):.3f}-{max(res['actual_tick_ms']):.3f}, "
        f"tick_time_ratio {res['tick_time_ratio']}; expected_service_ms "
        f"{expected:.1f} after the first metrics wave, "
        f"{res['expected_service_ms']:.1f} at the end")
    return srv, res


def _front_trace_tree(path):
    """dump_trace's chrome JSON: every request's spans form one tree
    (one root, every parent a span of the same request). Returns the
    number of requests."""
    pf.observability.dump_trace(path)
    with open(path) as f:
        trace = json.load(f)
    by_req = {}
    for e in trace["traceEvents"]:
        if e.get("pid") == 1 and e.get("ph") == "X":
            by_req.setdefault(e["args"]["request_id"], []).append(e)
    assert by_req, "dump_trace holds no request"
    for rid, evs in by_req.items():
        ids = {e["args"]["span"] for e in evs}
        roots = [e for e in evs if e["args"]["parent"] is None]
        assert len(roots) == 1 and roots[0]["name"] == "request", \
            (rid, [e["name"] for e in roots])
        assert all(e["args"]["parent"] in ids for e in evs
                   if e["args"]["parent"] is not None), rid
        assert len(evs) > 1, (rid, "a root alone")
    return len(by_req)


def _front_buckets(enc, gpu, card_name, card):
    """InferenceServer over a ProgramRunner of the Transformer-base
    encoder forward (source ids and positions fed [-1, -1]) with
    seq_buckets FRONT_SEQ_BUCKETS and batch buckets FRONT_BATCH_BUCKETS:
    aot_warmup builds the 6 PreparedPrograms, FRONT_REQUESTS requests of
    FRONT_LENGTHS tokens build none, two replies (one a bucket) agree
    with the CPU port at the same bucket, and a select_group hook that
    prefers the longer bucket is dispatched first. Launches #5 (bucket
    512) and #2 (1024)."""
    main, startup, out = enc
    startup.random_seed = SEED + 15
    scope = pf.Scope()
    gpu.run(startup, scope=scope)
    table = transformer._position_encoding(FRONT_SEQ_BUCKETS[-1],
                                           MODEL["d_model"])
    pf.load_numpy_params(scope, {"src_pos_enc": table}, gpu.device)
    params = [v.name for v in startup.global_block.vars.values()
              if v.persistable]
    cscope = pf.Scope()
    pf.load_numpy_params(cscope, pf.scope_to_numpy(scope, params),
                         pf.CPUPlace())
    feeds = ["src_ids", "src_pos"]
    runner = serving.ProgramRunner(main, feeds, [out.name], executor=gpu,
                                   scope=scope)
    srv = serving.InferenceServer(
        runner, max_batch_size=FRONT_BATCH_BUCKETS[-1], max_wait_ms=5.0,
        batch_buckets=FRONT_BATCH_BUCKETS, seq_buckets=FRONT_SEQ_BUCKETS)
    _zero_launches()
    t0 = time.monotonic()
    warmed = srv.aot_warmup()
    warm_s = time.monotonic() - t0
    assert warmed == len(FRONT_SEQ_BUCKETS) * len(FRONT_BATCH_BUCKETS), \
        warmed
    rng = np.random.RandomState(SEED + 15)
    lengths = rng.randint(FRONT_LENGTHS[0], FRONT_LENGTHS[1] + 1,
                          FRONT_REQUESTS)
    lengths[:2] = (FRONT_LENGTHS[0], FRONT_LENGTHS[1])  # one a bucket
    reqs = [{"src_ids": rng.randint(2, MODEL["vocab"], (1, n)).astype(
        np.int64), "src_pos": np.arange(n, dtype=np.int64)[None]}
        for n in lengths]
    n_prep = gpu.prepare_count
    t0 = time.monotonic()
    replies = [srv.submit(r) for r in reqs]
    outs = [r.result(timeout=600)[0] for r in replies]
    wall = time.monotonic() - t0
    counts = _launch_counts()
    st = srv.stats()
    srv.close()
    assert gpu.prepare_count == n_prep, "a bucketed request built a program"
    assert counts["sdpa_short"] > 0 and counts["flash_attention"] > 0, \
        counts
    cpu = pf.Executor(pf.CPUPlace())
    errs = []
    for i in range(2):
        bucket = next(b for b in FRONT_SEQ_BUCKETS if lengths[i] <= b)
        feed = {k: np.pad(v, ((0, 0), (0, bucket - lengths[i])))
                for k, v in reqs[i].items()}
        want = cpu.run(main, feed=feed, fetch_list=[out], scope=cscope)[0]
        assert outs[i].shape == want.shape, (outs[i].shape, want.shape)
        err = float(np.abs(outs[i] - want).max() / np.abs(want).max())
        assert err <= FRONT_TOL, (bucket, err)
        errs.append(err)
    # select_group: two groups queued, the shorter bucket first; the hook
    # picks the longer, whose reply completes first
    order = []
    hooked = serving.InferenceServer(
        runner, max_batch_size=FRONT_BATCH_BUCKETS[-1], max_wait_ms=5.0,
        batch_buckets=FRONT_BATCH_BUCKETS, seq_buckets=FRONT_SEQ_BUCKETS,
        select_group=lambda groups: max(groups, key=lambda k: k[0][1][0]),
        start=False)
    for i in range(2):
        hooked.submit(reqs[i]).add_done_callback(
            lambda f, i=i: order.append(lengths[i]))
    hooked.start()
    assert hooked.drain(timeout=120)
    hooked.close()
    assert order == [lengths[1], lengths[0]], order
    assert gpu.prepare_count == n_prep
    log(f"front door, buckets: aot_warmup built {warmed} PreparedPrograms "
        f"in {warm_s:.1f} s; {FRONT_REQUESTS} requests of "
        f"{lengths.min()}-{lengths.max()} tokens built none, in "
        f"{wall:.2f} s ({st['batches']} batches, occupancy "
        f"{st['batch_occupancy']}, p50 {st['latency_ms']['p50']} ms); "
        f"against the CPU at buckets {FRONT_SEQ_BUCKETS}: {errs} of the "
        f"largest |value|; select_group dispatched {order[0]} tokens "
        f"first; launches {counts} on {card_name} ({card})")
    return srv, counts, dict(warmed=warmed, warm_s=warm_s, wall_s=wall,
                        batches=st["batches"],
                        occupancy=st["batch_occupancy"],
                        p50_ms=st["latency_ms"]["p50"], rel_err=errs,
                        launches=counts)


def phase_frontdoor(card_name, card):
    """Phase 15, the front door and its observability on Transformer-base
    (phase 9's bundles and geometry, phase 12's weights for the streamed
    legs, phase 9's for the rest). (1) Streamed: 16 streamed submits on
    the paged server (14 plain, a chat session's two turns) and 12 on the
    dense one (8 streams, FRONT_CB stream_cb), each stream equal to its
    row's generated region and each row to the plain wave's, no
    PreparedProgram built; then a stream cancelled mid-decode and one past
    its deadline: typed errors, the pool back where it was, two
    incidents; the n-gram speculative bundle streams 4. (2) admit_select:
    the hook's admission order, the FIFO rows. (3) Buckets: aot_warmup
    6, 32 requests build nothing, the CPU at each bucket, select_group.
    (4) Observability: the dense wave at off, metrics and trace,
    interleaved, FRONT_OBS_ROUNDS each: median walls and idle shares;
    dump_trace's request trees; expose() lists every server's families,
    the speculative ones too. Returns (launches by kernel over the
    phase, results)."""
    t_phase = time.monotonic()
    gpu = pf.Executor(pf.CUDAPlace(0))
    paged, dense, _, startup, _ = _paged_programs()
    fdense, ngram, enc = _front_programs()
    log(f"front door: built the programs in "
        f"{time.monotonic() - t_phase:.1f} s")
    gscope = _paged_weights(gpu, startup)
    rscope, _ = _radix_weights(gpu, startup)
    cands, exts = _radix_candidates()
    plain_prompts, _ = _paged_requests()
    launches = dict.fromkeys((k.__name__ for k in FRONT_KERNELS), 0)

    def add(counts):
        for n, c in counts.items():
            launches[n] += c

    res = {}
    pf.observability.reset()
    try:
        # (1) streamed legs, at trace (every request a span tree)
        pf.set_flags({"FLAGS_observability": "trace"})
        _zero_launches()
        sess = cands[FRONT_SESSION_ROW]
        subs = [(cands[r], "stream", {}) for r in FRONT_PLAIN_ROWS] \
            + [(sess, "stream", {"session_id": "fd"})]
        res["paged"] = _front_streamed(
            "front door, paged stream",
            lambda: serving.PagedContinuousGenerationServer(
                paged, executor=gpu, scope=rscope, start=False,
                steps_per_tick=PAGED["steps_per_tick"],
                drain_steps=PAGED["steps_per_tick"]),
            subs, turn2=(sess, {"session_id": "fd",
                                "extend_tokens": exts[FRONT_SESSION_ROW, 0]}))
        c = _launch_counts()
        assert c["paged_decode_attention"] > 0 and c["layer_norm"] > 0, c
        res["paged"]["launches"] = c
        add(c)
        _zero_launches()
        rows8 = list(RADIX_SESSION_ROWS)
        subs = [(cands[r], "stream", {}) for r in rows8] \
            + [(cands[r], "cb", {}) for r in rows8[:FRONT_CB]]
        res["dense"] = _front_streamed(
            "front door, dense stream",
            lambda: serving.ContinuousGenerationServer(
                dense, executor=gpu, scope=rscope, start=False,
                steps_per_tick=PAGED["steps_per_tick"],
                drain_steps=PAGED["steps_per_tick"]), subs)
        res["dense"]["launches"] = c = _launch_counts()
        add(c)
        for leg in ("paged", "dense"):
            r = res[leg]
            log(f"front door, {leg}: {r['submits']} streamed submits "
                f"({r['generated']} tokens), every stream its row's "
                f"tokens, every row the first wave's; streamed TTFT p50 "
                f"{_ms_list(r['stream_ttft_ms'])} ms against the whole "
                f"response's latency p50 {_ms_list(r['whole_latency_ms'])} "
                f"ms (waves 2 and 3 against 1 and 4, from each wave's "
                f"start); walls {_ms_list(r['stream_wall_s'], 2)} s "
                f"streamed, {_ms_list(r['plain_wall_s'], 2)} s whole; "
                f"launches {r['launches']} on {card_name} ({card})")
        _zero_launches()
        res["teardown"] = _front_teardown(paged, gpu, gscope,
                                          plain_prompts)
        add(_launch_counts())
        # the n-gram speculative bundle streams: a verify emits 1..k+1
        # tokens a tick, the sequence stays monotone
        _zero_launches()
        spec = serving.PagedContinuousGenerationServer(
            ngram, executor=gpu, scope=rscope,
            steps_per_tick=PAGED["steps_per_tick"],
            drain_steps=PAGED["steps_per_tick"])
        reps = [spec.submit(cands[r], stream=True)
                for r in rows8[:FRONT_SPEC_LANES]]
        for i, rep in enumerate(reps):
            _stream_ok(f"front door, n-gram {i}", rep,
                       *_drain_stream(rep), rep.result(timeout=600))
        sp = spec.stats()["speculative"]
        assert sp["proposed"] > 0, sp
        add(_launch_counts())
        res["spec"] = dict(streams=len(reps), proposed=sp["proposed"],
                           accepted=sp["accepted"], emitted=sp["emitted"])
        log(f"front door, n-gram: {len(reps)} streams equal their rows; "
            f"proposed {sp['proposed']}, accepted {sp['accepted']}")
        # (2) admit_select (its slots read from the traces)
        _zero_launches()
        res["admit_select"] = _front_admit_select(fdense, gpu, gscope,
                                                  cands)
        add(_launch_counts())
        # (3) buckets
        pf.set_flags({"FLAGS_observability": "off"})
        bucket_srv, counts, res["buckets"] = _front_buckets(
            enc, gpu, card_name, card)
        add(counts)
        # (4) observability's cost
        _zero_launches()
        obs_srv, res["observability"] = _front_observability(
            fdense, gpu, gscope, cands, card_name, card)
        add(_launch_counts())
        pf.set_flags({"FLAGS_observability": "trace"})
        path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_trace_"),
                            "frontdoor.json")
        res["trace_requests"] = _front_trace_tree(path)
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        text = pf.observability.metrics.expose()
        families = {ln.split("{")[0].split(" ")[0]
                    for ln in text.splitlines() if ln and ln[0] != "#"}
        need = ("paddle_tpu_server_requests_total",
                "paddle_tpu_server_ticks_total",
                "paddle_tpu_server_batches_total",
                "paddle_tpu_request_latency_ms_count",
                "paddle_tpu_blockpool_blocks_in_use",
                "paddle_tpu_devtel_ticks_total",
                "paddle_tpu_executor_prepares_total",
                "paddle_tpu_flight_incidents_total",
                "paddle_tpu_costmodel_flops_per_s",
                "paddle_tpu_spec_proposed_total",
                "paddle_tpu_spec_k_dispatches_total",
                "paddle_tpu_spec_acceptance_rate_count")
        missing = [f for f in need if f not in families]
        assert not missing, missing
        for alive in (obs_srv, spec, bucket_srv):
            assert f'server="{alive._obs_id}"' in text, alive._obs_id
        spec.close()
        obs_srv.close()
        res["families"] = len(families)
    finally:
        pf.set_flags({"FLAGS_observability": "off"})
        pf.observability.reset()
    wall = time.monotonic() - t_phase
    res["wall_s"] = wall
    log(f"front door: dump_trace held {res['trace_requests']} request "
        f"trees, expose() {res['families']} families; the phase took "
        f"{wall:.1f} s; launches {launches}")
    for k in ("layer_norm", "paged_decode_attention", "sdpa_short",
              "flash_attention"):
        assert launches[k] > 0, f"{k} never launched in phase 15"
    return launches, res


# ---------------------------------------------------------------------------
# phase 16: the whole-loop decode programs and the conv MNIST net
# ---------------------------------------------------------------------------
# the conv net (BASELINE.md config 1's other form, models/mnist.py
# build_program(use_conv=True): two 5x5 conv + ReLU + 2x2 max-pool stages
# of 20 and 50 filters, fc to 10) at MNIST_BATCH under SGD; CONV_CPU_ROWS
# rows of step 1 against the CPU, the loss and each grad norm-wise within
# CONV_TOL (fp32, cuDNN's sums in its own order); GradientMerge of
# CONV_MERGE_K micro-batches of MNIST_BATCH / CONV_MERGE_K against one
# SGD step on the whole batch within CONV_TOL relative; the EMA and
# ModelAverage of CONV_AVG_STEPS steps against numpy within 1e-6 relative
CONV_LR = 0.05
CONV_STEPS = 20
CONV_CPU_ROWS = 2
CONV_TOL = 1e-5
CONV_MERGE_K = 4
CONV_AVG_STEPS = 5
CONV_EMA_DECAY = 0.9
AVG_TOL = 1e-6
CONV_TIMED_CALLS = 3
# cuDNN's convolution kernels (forward, data and weight gradients) by
# name, for the conv's share of a profiled step
CONV_KERNEL_MARKS = ("conv", "xmma", "cudnn", "fprop", "dgrad", "wgrad",
                     "implicit_gemm")
WHOLE_KERNELS = (KL.layer_norm, KA.sdpa_short, KA.flash_attention)
CONV_KERNELS = (KX.xent_forward, KX.xent_backward)


def _launch_snapshot(kernels):
    return {k.__name__: k.launches for k in kernels}


def _zero(kernels):
    for k in kernels:
        k.launches = 0


def _timed_run(exe, prog, feed, fetch, scope):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _whole_greedy(card_name, card, slice_state):
    """The greedy whole loop at phase 4's configuration, weights and
    prompts (512: #5 in the encoder; 1024: #2): tokens equal phase 4's
    incremental card rows under phase 4's tie rule (the CPU incremental
    program's top-2 margin at a diverging position); #1 12 + 18 a step,
    #5 or #2 6; the decode's wall and idle share."""
    gpu = pf.Executor(pf.CUDAPlace(0))
    cpu = pf.Executor(pf.CPUPlace())
    gscope, cscope = slice_state["gscope"], slice_state["cscope"]
    L = MODEL["n_layers"]
    launches = dict.fromkeys(_launch_snapshot(WHOLE_KERNELS), 0)
    res = {}
    for seq_len, (src, want, inc) in slice_state["rows"].items():
        with unique_name.guard():
            prog, _, _, out = decode_engine.build_greedy_decode_program(
                seq_len=seq_len, **MODEL)
        _zero(WHOLE_KERNELS)
        toks, steps = gpu.run(
            prog, feed={"src_ids": src},
            fetch_list=[out, decode_engine.DECODE_STEPS_VAR], scope=gscope)
        counts = _launch_snapshot(WHOLE_KERNELS)
        _, wall = _timed_run(gpu, prog, {"src_ids": src}, [out], gscope)
        for n, c in counts.items():
            launches[n] += c
        steps = int(steps[0])
        attn = "sdpa_short" if seq_len <= 512 else "flash_attention"
        expect = {"layer_norm": 2 * L + 3 * L * steps, "sdpa_short": 0,
                  "flash_attention": 0}
        expect[attn] = L
        assert counts == expect, (seq_len, counts, expect)
        got = serving.apply_eos_sentinel(toks, MODEL["end_id"])
        inc_prog, lname = inc
        ties = _rows_agree(
            f"whole greedy seq_len={seq_len}", got, want,
            lambda r, pos: _tie_margin(cpu, inc_prog, lname, cscope,
                                       src[r], pos))
        _, prof = _device_profile(
            f"whole greedy seq_len={seq_len} profile",
            lambda: gpu.run(prog, feed={"src_ids": src}, fetch_list=[out],
                            scope=gscope), host=False)
        log(f"whole greedy seq_len={seq_len}: batch {len(src)}, {steps} "
            f"loop steps, wall {wall * 1e3:.1f} ms ({wall * 1e3 / steps:.2f}"
            f" ms a step), idle share {prof['idle_share']}; tokens equal "
            f"phase 4's incremental rows in {len(src) - ties}/{len(src)} "
            f"rows ({ties} ties); launches {counts} on {card_name} "
            f"({card})")
        res[seq_len] = dict(wall_ms=wall * 1e3, steps=steps, ties=ties,
                            launches=counts, profile=prof)
    return launches, res


def _beam_rows(ids, scores, beam):
    """[(tokens, score)] per source of a whole-loop beam decode, the
    tokens sentinel-normalized as the paged decoder gives them."""
    rows = serving.apply_eos_sentinel(np.asarray(ids).T, MODEL["end_id"])
    scores = np.asarray(scores).reshape(-1)
    return [[(rows[s * beam + j], float(scores[s * beam + j]))
             for j in range(beam)] for s in range(len(rows) // beam)]


def _whole_beam(card_name, card, radix_state, slice_state):
    """The beam whole loop (a) at phase 12's weights and geometry, beam
    RADIX_BEAM, on RADIX_BEAM_ROWS in one batch: each row's hypotheses
    the set PagedBeamDecoder gave in phase 12, scores within
    RADIX_BEAM_TOL (near ties at the cut printed, as phase 12 allows
    them); #1 12 + 18 a step; (b) one row at phase 4's geometry (prompt
    512: #5 in the encoder) against the same program on the CPU."""
    gpu = pf.Executor(pf.CUDAPlace(0))
    cpu = pf.Executor(pf.CPUPlace())
    L = MODEL["n_layers"]
    geo = {k: v for k, v in MODEL.items() if k not in ("max_out_len",)}
    rows = list(RADIX_BEAM_ROWS)
    with unique_name.guard():
        prog, _, _, (ids_v, sc_v) = decode_engine.build_beam_decode_program(
            seq_len=PAGED["seq_len"], max_out_len=PAGED["max_out_len"],
            beam_size=RADIX_BEAM, batch_size=len(rows), **geo)
    src = radix_state["cands"][rows]
    _zero(WHOLE_KERNELS)
    ids, scores = gpu.run(prog, feed={"src_ids": src},
                          fetch_list=[ids_v, sc_v],
                          scope=radix_state["gscope"])
    counts = _launch_snapshot(WHOLE_KERNELS)
    _, wall = _timed_run(gpu, prog, {"src_ids": src}, [ids_v, sc_v],
                         radix_state["gscope"])
    steps = PAGED["max_out_len"] - 1
    assert counts == {"layer_norm": 2 * L + 3 * L * steps,
                      "sdpa_short": 0, "flash_attention": 0}, counts
    ties = []
    for r, hyps, want in zip(rows, _beam_rows(ids, scores, RADIX_BEAM),
                             radix_state["got"]):
        ties += _beam_agree(f"whole beam row {r}", hyps, want)
    _, prof = _device_profile(
        "whole beam profile", lambda: gpu.run(
            prog, feed={"src_ids": src}, fetch_list=[ids_v, sc_v],
            scope=radix_state["gscope"]), host=False)
    log(f"whole beam {RADIX_BEAM} at seq {PAGED['seq_len']}, "
        f"{PAGED['max_out_len']} out, rows {rows} in one batch: wall "
        f"{wall * 1e3:.1f} ms ({wall * 1e3 / steps:.2f} ms a step), idle "
        f"share {prof['idle_share']}; hypotheses equal phase 12's paged "
        f"beam decoder's but for {len(ties)} near ties; launches {counts} "
        f"on {card_name} ({card})")
    res = dict(wall_ms=wall * 1e3, steps=steps, ties=ties, launches=counts,
               profile=prof)
    launches = dict(counts)
    # (b) phase 4's geometry, one prompt of 512
    src4, _, _ = slice_state["rows"][512]
    with unique_name.guard():
        prog4, _, _, (i4, s4) = decode_engine.build_beam_decode_program(
            seq_len=512, beam_size=RADIX_BEAM, batch_size=1, **MODEL)
    _zero(WHOLE_KERNELS)
    ids, scores = gpu.run(prog4, feed={"src_ids": src4[:1]},
                          fetch_list=[i4, s4], scope=slice_state["gscope"])
    counts4 = _launch_snapshot(WHOLE_KERNELS)
    _, wall4 = _timed_run(gpu, prog4, {"src_ids": src4[:1]}, [i4, s4],
                          slice_state["gscope"])
    steps4 = MODEL["max_out_len"] - 1
    assert counts4 == {"layer_norm": 2 * L + 3 * L * steps4,
                       "sdpa_short": L, "flash_attention": 0}, counts4
    t0 = time.monotonic()
    want = cpu.run(prog4, feed={"src_ids": src4[:1]}, fetch_list=[i4, s4],
                   scope=slice_state["cscope"])
    cpu_s = time.monotonic() - t0
    ties4 = _beam_agree("whole beam seq_len=512", _beam_rows(
        ids, scores, RADIX_BEAM)[0], _beam_rows(*want, RADIX_BEAM)[0])
    log(f"whole beam {RADIX_BEAM} at seq 512, {MODEL['max_out_len']} out, "
        f"one row: wall {wall4 * 1e3:.1f} ms, CPU {cpu_s:.1f} s; "
        f"hypotheses equal the CPU's but for {len(ties4)} near ties; "
        f"launches {counts4} on {card_name} ({card})")
    for n, c in counts4.items():
        launches[n] += c
    res["seq512"] = dict(wall_ms=wall4 * 1e3, cpu_s=cpu_s, ties=ties4,
                         launches=counts4)
    return launches, res


def _conv_feed(seed=0):
    """A synthetic separable batch of MNIST_BATCH [1, 28, 28] images:
    noise of 0.1, and 1.0 added on a 4x4 patch at a place the label
    names."""
    r = np.random.RandomState(seed)
    lab = r.randint(0, 10, (MNIST_BATCH, 1)).astype(np.int64)
    img = r.randn(MNIST_BATCH, 1, 28, 28).astype(np.float32) * 0.1
    for c in range(10):
        img[lab[:, 0] == c, 0, 2 + 2 * c:6 + 2 * c, 4:8] += 1.0
    return {"img": img, "label": lab}


def _conv_program(merge_k=None, averages=False):
    """The conv net under SGD (inside a GradientMergeOptimizer of
    `merge_k` steps; with `averages`, an EMA and a ModelAverage of every
    parameter after it): (main, loss, params, averagers, seeded initial
    state)."""
    with unique_name.guard():
        main, startup, loss, _ = mnist.build_program(use_conv=True)
        with pf.program_guard(main, startup):
            opt = pf.optimizer.SGD(learning_rate=CONV_LR)
            if merge_k is not None:
                opt = pf.optimizer.GradientMergeOptimizer(opt, merge_k)
            opt.minimize(loss)
            avgs = None
            if averages:
                for p in main.all_parameters():
                    p.do_model_average = True
                avgs = (pf.optimizer.ExponentialMovingAverage(
                    CONV_EMA_DECAY), pf.optimizer.ModelAverage(0.15))
    startup.random_seed = SEED
    names = [n for n, v in startup.global_block.vars.items()
             if v.persistable]
    scope = pf.Scope()
    pf.Executor(pf.CPUPlace()).run(startup, scope=scope)
    params = sorted(p.name for p in main.all_parameters())
    return main, loss, params, avgs, pf.scope_to_numpy(scope, names)


def _params_of(scope, params):
    return {n: scope._get(n).detach().cpu().numpy().copy() for n in params}


def _conv_parity(main, loss, params, state):
    """Step 1 on CONV_CPU_ROWS rows, card against CPU: loss and grads."""
    feed = {k: v[:CONV_CPU_ROWS] for k, v in _conv_feed().items()}
    fetch = [loss] + [p + "@GRAD" for p in params]
    ref = pf.Executor(pf.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=_fresh(state,
                                                        pf.CPUPlace()))
    got = pf.Executor(pf.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch,
        scope=_fresh(state, pf.CUDAPlace(0)))
    lerr = abs(float(got[0][0]) - float(ref[0][0])) / abs(float(ref[0][0]))
    gerrs = {p: _rel(g, w) for p, g, w in zip(params, got[1:], ref[1:])}
    log(f"conv mnist: step 1 on {CONV_CPU_ROWS} rows, card against the "
        f"CPU: loss rel err {lerr:.3e}, grads norm-wise "
        + ", ".join(f"{p} {e:.3e}" for p, e in gerrs.items())
        + f" (tol {CONV_TOL:g})")
    assert lerr <= CONV_TOL, lerr
    assert all(e <= CONV_TOL for e in gerrs.values()), gerrs
    return lerr, gerrs


def _conv_merge(gpu, init, full_params):
    """GradientMerge of CONV_MERGE_K micro-batches from the parameters
    `init` against one SGD step on the whole batch (`full_params`),
    eager and through run_steps (one capture)."""
    main, loss, params, _, state = _conv_program(merge_k=CONV_MERGE_K)
    state.update({p: init[p] for p in params})
    feed = _conv_feed()
    m = MNIST_BATCH // CONV_MERGE_K
    micro = [{k: v[i * m:(i + 1) * m] for k, v in feed.items()}
             for i in range(CONV_MERGE_K)]
    out = {}
    for leg in ("eager", "run_steps"):
        scope = _fresh(state, pf.CUDAPlace(0))
        compiles = gpu.compile_count
        if leg == "eager":
            for f in micro:
                gpu.run(main, feed=f, fetch_list=[loss], scope=scope)
        else:
            gpu.run_steps(main, feed=micro, fetch_list=[loss], scope=scope)
            assert gpu.last_run_steps_fallback is None, \
                gpu.last_run_steps_fallback
            assert gpu.compile_count == compiles + 1, gpu.compile_count
        got = _params_of(scope, params)
        errs = {p: _rel(got[p], full_params[p]) for p in params}
        log(f"conv mnist GradientMerge k={CONV_MERGE_K} ({leg}): params "
            f"against one SGD step on the {MNIST_BATCH} batch, norm-wise "
            + ", ".join(f"{p} {e:.3e}" for p, e in errs.items())
            + f" (tol {CONV_TOL:g})")
        assert all(e <= CONV_TOL for e in errs.values()), (leg, errs)
        out[leg] = errs
    return out


def _conv_averages(gpu):
    """EMA and ModelAverage over CONV_AVG_STEPS steps: the values inside
    apply() against numpy from the parameters fetched each step, and the
    parameters back after it."""
    main, loss, params, (ema, mavg), state = _conv_program(averages=True)
    feed = _conv_feed()
    scope = _fresh(state, pf.CUDAPlace(0))
    hist = []
    for _ in range(CONV_AVG_STEPS):
        vals = gpu.run(main, feed=feed, fetch_list=[loss] + params,
                       scope=scope)
        hist.append(dict(zip(params, vals[1:])))
    errs = {}
    for tag, avg in (("ema", ema), ("model_average", mavg)):
        with avg.apply(scope=scope):
            inside = _params_of(scope, params)
        after = _params_of(scope, params)
        worst = 0.0
        for p in params:
            if tag == "ema":
                want = np.zeros_like(hist[0][p])
                for h in hist:
                    want = np.float32(CONV_EMA_DECAY) * want + \
                        np.float32(1 - CONV_EMA_DECAY) * h[p]
            else:
                want = np.sum([h[p] for h in hist], axis=0) / CONV_AVG_STEPS
            worst = max(worst, _rel(inside[p], want))
            np.testing.assert_array_equal(after[p], hist[-1][p])
        log(f"conv mnist {tag} after {CONV_AVG_STEPS} steps: norm-wise "
            f"against numpy {worst:.3e} (tol {AVG_TOL:g}); restored")
        assert worst <= AVG_TOL, (tag, worst)
        errs[tag] = worst
    return errs


def _conv_mnist(card_name, card):
    """The conv net at MNIST_BATCH under SGD: step-1 parity on
    CONV_CPU_ROWS rows; two fresh runs of 2 steps the same bits; then the
    main path, CONV_STEPS eager steps (the counters set to 0 just
    before: #7 and #8 once each a step; the loss falls), one run_steps
    call of CONV_STEPS (one capture) within STEPS_RTOL of the eager
    losses and CONV_TIMED_CALLS replaying calls timed; the conv's share
    of a profiled eager step; GradientMerge, EMA and ModelAverage."""
    assert not torch.backends.cudnn.allow_tf32
    main, loss, params, _, state = _conv_program()
    lerr, gerrs = _conv_parity(main, loss, params, state)
    gpu = pf.Executor(pf.CUDAPlace(0))
    feed = _conv_feed()
    twice = []
    for _ in range(2):
        scope = _fresh(state, pf.CUDAPlace(0))
        ls = [gpu.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
              for _ in range(2)]
        twice.append((ls, _params_of(scope, params)))
    assert torch.backends.cudnn.deterministic \
        and not torch.backends.cudnn.benchmark
    for a, b in zip(twice[0][0], twice[1][0]):
        np.testing.assert_array_equal(a, b)
    for p in params:
        np.testing.assert_array_equal(twice[0][1][p], twice[1][1][p])
    # one SGD step on the whole batch, GradientMerge's target
    scope = _fresh(state, pf.CUDAPlace(0))
    gpu.run(main, feed=feed, fetch_list=[loss], scope=scope)
    one_step = _params_of(scope, params)
    # the main path: eager steps, the counters set to 0 just before
    scope = _fresh(state, pf.CUDAPlace(0))
    torch.cuda.synchronize()
    _zero(CONV_KERNELS)
    t0 = time.monotonic()
    eager = [gpu.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
             for _ in range(CONV_STEPS)]
    torch.cuda.synchronize()
    eager_ms = (time.monotonic() - t0) * 1e3 / CONV_STEPS
    launches = _launch_snapshot(CONV_KERNELS)
    losses = np.array([float(x[0]) for x in eager])
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert launches == dict.fromkeys(launches, CONV_STEPS), launches
    scope = _fresh(state, pf.CUDAPlace(0))
    compiles = gpu.compile_count
    walls = []
    for i in range(1 + CONV_TIMED_CALLS):
        pf.load_numpy_params(scope, state, pf.CUDAPlace(0))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = gpu.run_steps(main, feed=feed, fetch_list=[loss],
                            steps=CONV_STEPS, scope=scope)[0].reshape(-1)
        torch.cuda.synchronize()
        if i:
            walls.append((time.monotonic() - t0) * 1e3 / CONV_STEPS)
        assert gpu.last_run_steps_fallback is None
        assert gpu.compile_count == compiles + 1, gpu.compile_count
        err = float(np.max(np.abs(out - losses) / np.abs(losses)))
        assert err <= STEPS_RTOL, err
    captured_ms = float(np.median(walls))
    _, prof = _device_profile(
        "conv mnist eager step profile",
        lambda: gpu.run(main, feed=feed, fetch_list=[loss], scope=scope),
        match=CONV_KERNEL_MARKS)
    share = prof["matched_ms"] / prof["device_busy_ms"] \
        if prof["device_busy_ms"] else None
    log(f"conv mnist: losses " + ", ".join(f"{x:.6f}" for x in losses)
        + f"; eager step {eager_ms:.3f} ms, captured step {captured_ms:.3f}"
        f" ms (median of {CONV_TIMED_CALLS} replaying calls, host clock); "
        f"cuDNN conv share of the profiled eager step's device time "
        f"{share}; launches {launches} on {card_name} ({card})")
    merge = _conv_merge(gpu, state, one_step)
    avgs = _conv_averages(gpu)
    return launches, dict(
        batch=MNIST_BATCH, loss_rel_err=lerr, grad_rel_errs=gerrs,
        losses=losses.tolist(), eager_step_ms=eager_ms,
        captured_step_ms=captured_ms, captured_steps_ms=walls,
        conv_share=share, profile=prof, merge=merge, averages=avgs)


def phase_whole_loop_conv(card_name, card, slice_state, radix_state):
    """Phase 16: the greedy and beam whole-loop decode programs at
    Transformer-base (phase 4's and phase 12's weights), then the conv
    MNIST net. Returns (launches of the greedy legs, of the beam legs,
    of the conv leg's eager steps, results)."""
    greedy_launches, greedy = _whole_greedy(card_name, card, slice_state)
    beam_launches, beam = _whole_beam(card_name, card, radix_state,
                                      slice_state)
    conv_launches, conv = _conv_mnist(card_name, card)
    return greedy_launches, beam_launches, conv_launches, dict(
        greedy=greedy, beam=beam, conv=conv, card=card)


def main():
    t_start = time.monotonic()

    def phase(name):
        log(f"phase {name} at {time.monotonic() - t_start:.1f} s")

    name, count, card = phase_device()
    phase("build")
    phase_build()
    phase("kernels")
    entries = phase_kernels()
    phase("lookup_table")
    phase_lookup_table()
    phase("step key")
    phase_step_key()
    phase("slice")
    served_launches, served = phase_slice(name, card)
    slice_state = served.pop("_whole_loop")
    trained_launches = dict.fromkeys(KERNEL_META, 0)
    trained = {}
    for seq_len, batch in TRAIN_RUNS:
        phase(f"train T={seq_len}")
        counts, trained[seq_len] = phase_train(name, card, seq_len, batch)
        trained[seq_len]["launches"] = counts
        for kname, n in counts.items():
            trained_launches[kname] += n
    phase(f"train T={TRAIN_RUNS[0][0]} B={BENCH_BATCH}")
    counts, trained["bench_batch"] = phase_train_bench_batch(name, card)
    trained["bench_batch"]["launches"] = counts
    for kname, n in counts.items():
        trained_launches[kname] += n
    bf16_launches = dict.fromkeys(KERNEL_META, 0)
    for seq_len, batch in BF16_RUNS:
        phase(f"train bf16 T={seq_len} B={batch}")
        counts, res = phase_train_bf16(name, card, seq_len, batch)
        res["launches"] = counts
        trained[f"bf16_{seq_len}"] = res
        for kname, n in counts.items():
            trained_launches[kname] += n
            bf16_launches[kname] += n
    phase("train dropout")
    trained["dropout"] = phase_train_dropout(name, card,
                                             trained[TRAIN_RUNS[0][0]])
    phase("train fused")
    counts, trained["fused"] = phase_train_fused(name, card,
                                                 trained[TRAIN_RUNS[0][0]])
    trained["fused"]["launches"] = counts
    for kname, n in counts.items():
        trained_launches[kname] += n
    seq_len, batch = BF16_RUNS[0]
    phase(f"train bf16 fused T={seq_len} B={batch}")
    counts, res = phase_train_bf16(name, card, seq_len, batch, fused=True)
    res["launches"] = counts
    trained["bf16_fused"] = res
    for kname, n in counts.items():
        trained_launches[kname] += n
        bf16_launches[kname] += n
    unfused, fp32 = trained[f"bf16_{seq_len}"], trained["fused"]
    log(f"train bf16 fused T={seq_len} B={batch}: run_steps step "
        f"{res['run_steps']['step_ms']:.1f} ms, eager "
        f"{res['step_ms']:.1f} ms, idle share "
        f"{res['run_steps']['profile']['idle_share']} (eager "
        f"{res['profile']['idle_share']}), peak allocated "
        f"{res['peak_memory_bytes'] / 2 ** 30:.2f} GiB eager, "
        f"{res['run_steps']['capture_peak_memory_bytes'] / 2 ** 30:.2f} GiB "
        f"the capturing call; beside the unfused bf16 leg at the same "
        f"settings: {unfused['run_steps']['step_ms']:.1f} ms, eager "
        f"{unfused['step_ms']:.1f} ms, "
        f"{unfused['peak_memory_bytes'] / 2 ** 30:.2f} GiB, and the fp32 "
        f"fused leg (T={TRAIN_RUNS[0][0]} B={TRAIN_RUNS[0][1]}): "
        f"{fp32['run_steps']['step_ms']:.1f} ms, eager "
        f"{fp32['step_ms']:.1f} ms, "
        f"{fp32['peak_memory_bytes'] / 2 ** 30:.2f} GiB on {name} ({card})")
    for kname, e in entries.items():
        if "bf16" in e and kname in bf16_launches:
            e["bf16"]["launches"] = bf16_launches[kname]
    phase("train recompute")
    counts, trained["recompute"] = phase_train_recompute(name, card)
    trained["recompute"]["launches"] = counts
    for kname, n in counts.items():
        trained_launches[kname] += n
    phase("train mnist")
    mnist_launches, trained["mnist"] = phase_train_mnist(name, card)
    phase("paged serve")
    paged_launches, paged = phase_paged(name, card)
    phase("radix and beam")
    radix_launches, beam_launches, radix = phase_radix(name, card)
    radix_state = radix.pop("_whole_loop")
    phase("chunked and sampled")
    chunked_launches, sampled_launches, chunked_sampled = \
        phase_chunked_sampled(name, card, paged.pop("_greedy"))
    phase("speculative")
    spec_launches, distill_launches, speculative = \
        phase_speculative(name, card)
    phase("predict")
    predict_launches, predicted = phase_predict(name, card)
    phase("front door")
    front_launches, front = phase_frontdoor(name, card)
    phase("whole loop and conv")
    whole_greedy_launches, whole_beam_launches, conv_launches, whole = \
        phase_whole_loop_conv(name, card, slice_state, radix_state)
    del slice_state, radix_state
    entries["layer_norm"]["bf16"]["launches"] = \
        predict_launches["layer_norm"][1]
    line = []
    for kname, (src, replaces) in KERNEL_META.items():
        e = entries[kname]
        on_paths = dict(served=served_launches.get(kname, 0),
                        trained=trained_launches[kname],
                        trained_mnist=mnist_launches.get(kname, 0),
                        served_paged=paged_launches.get(kname, 0),
                        served_radix=radix_launches.get(kname, 0),
                        served_beam=beam_launches.get(kname, 0),
                        served_chunked=chunked_launches.get(kname, 0),
                        served_sampled=sampled_launches.get(kname, 0),
                        served_spec=spec_launches.get(kname, 0),
                        trained_distill=distill_launches.get(kname, 0),
                        served_predictor=predict_launches.get(
                            kname, [0, 0])[0],
                        served_frontdoor=front_launches.get(kname, 0),
                        served_whole_greedy=whole_greedy_launches.get(
                            kname, 0),
                        served_whole_beam=whole_beam_launches.get(kname, 0),
                        trained_conv=conv_launches.get(kname, 0))
        assert sum(on_paths.values()) > 0, f"{kname} never launched"
        extra = {x: e[x] for x in ("max_rel_err", "residual", "library",
                                   "p_max_abs_err", "library_rel_err",
                                   "tf32x3_bound_ms", "tflops",
                                   "tf32_control", "causal", "kernels_ms",
                                   "relu_flips", "unpinned_rel_err",
                                   "fwd_bwd_mask_flips", "cold_ms",
                                   "cold_clean_ms", "launch_alone_ms",
                                   "by_step", "cluster", "body",
                                   "copy_ms",
                                   "cluster_ms", "streamed_ms", "bf16",
                                   "mnist", "non_square")
                 if x in e}
        line.append(dict(name=kname, route="cuda", source=src,
                         replaces=replaces, launches=sum(on_paths.values()),
                         **on_paths, max_abs_err=e["max_abs_err"],
                         ms=e["ms"], plain_ms=e["plain_ms"],
                         bound_ms=e["bound_ms"], bound_by=e["bound_by"],
                         library_ms=e["library_ms"], shape=e["shape"],
                         served_predictor_bf16=predict_launches.get(
                             kname, [0, 0])[1],
                         **extra, ok=True))
    log(json.dumps({"served": served}))
    log(json.dumps({"trained": trained}))
    log(json.dumps({"paged": paged}))
    log(json.dumps({"radix": radix}))
    log(json.dumps({"chunked_sampled": chunked_sampled}))
    log(json.dumps({"speculative": speculative}, default=str))
    log(json.dumps({"predicted": predicted}))
    log(json.dumps({"front_door": front}, default=str))
    log(json.dumps({"whole_loop_conv": whole}, default=str))
    log(f"chip_smoke: {time.monotonic() - t_start:.1f} s wall in all on "
        f"{name} ({card})")
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
